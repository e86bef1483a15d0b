"""The ``(data, model)`` mesh over ``torch.distributed``.

Twin of ``instantir_tpu/parallel/mesh.py``. The JAX package puts one
``jax.sharding.Mesh`` with ``data`` and ``model`` axes over the devices and
lets GSPMD insert the collectives; the port runs one process per GPU
(``torchrun --nproc_per_node N``), builds a ``(data, model)`` ``DeviceMesh``
over the process group, and makes each collective explicit where the JAX
program gets it from a sharding: the batch rows a rank keeps
(``shard_batch``), the parameters every rank holds alike
(``replicate_params``), and the ZeRO-1 layout of the optimiser state
(``zero1_spec`` / ``zero1_shard``). The ``model`` axis carries tensor
parallelism (``parallel/tp.py``): its group (``axis_group(mesh, "model")``)
carries the TP all-reduces.

The backend follows the device: NCCL for CUDA tensors, gloo for CPU tensors,
chosen from the device and never as a fallback.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

# torchrun's contract: the rendezvous address and this process's place in the world
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def backend_for(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device!r}")


def launched() -> bool:
    """Whether a launcher (``torchrun``) put this process in a group."""
    return all(k in os.environ for k in LAUNCH_ENV)


def initialize_distributed(force: bool = False, init_method: Optional[str] = None, device="cuda") -> bool:
    """Join this process to the process group of a multi-process run (the
    twin of ``jax.distributed.initialize`` behind the same name), reading
    torchrun's contract: ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK`` and ``LOCAL_RANK``. ``init_method`` (a ``file://`` or ``tcp://``
    URL) replaces the address; ``WORLD_SIZE`` and ``RANK`` still come from the
    environment (1 and 0 when absent).

    Without ``force``, with no launcher environment and no ``init_method``,
    it does nothing and returns False, so every entry point can call it at
    startup. Once the group exists it returns True without a second
    handshake. On a CUDA ``device`` the process takes GPU ``LOCAL_RANK`` and
    the group NCCL; on the CPU gloo."""
    if dist.is_initialized():
        return True
    if not force and init_method is None and not launched():
        return False
    backend = backend_for(device)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: device 'cuda' requested but no CUDA device is available "
                               "(pass device='cpu' for a gloo group)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if init_method is None and not launched():  # force without a launcher: a group of one on a free local port
        os.environ.setdefault("MASTER_ADDR", "localhost")
        os.environ.setdefault("MASTER_PORT", str(_free_port()))
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world, rank=rank)
    return True


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(num_devices: Optional[int] = None, model_parallel: int = 1, device="cuda"):
    """The ``(data, model)`` ``DeviceMesh`` over the process group, one GPU
    (or, on the CPU, one process) a rank, ``mesh_dim_names=("data",
    "model")``, of shape ``(world / model_parallel, model_parallel)``: rank r
    sits at ``(r // model_parallel, r % model_parallel)``, so the ranks of one
    ``model`` group are neighbours. A world that ``model_parallel`` does not
    divide raises, as in the JAX package. With no group yet it joins the
    launcher's (``initialize_distributed``); with neither it raises: it never
    builds a mesh over the CPU by itself. ``num_devices`` must be the group's
    size when given."""
    if not dist.is_initialized() and not initialize_distributed(device=device):
        raise RuntimeError("make_mesh: no process group. Launch one process per GPU with "
                           "'torchrun --nproc_per_node N <script>' (or call initialize_distributed(force=True) "
                           "for a group of one)")
    n = dist.get_world_size()
    if num_devices is not None and num_devices != n:
        raise ValueError(f"make_mesh(num_devices={num_devices}): the process group has {n} ranks; the port's mesh "
                         "spans the whole group (launch that many processes)")
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def axis_size(mesh, axis: str = "data") -> int:
    """The number of ranks along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str = "data") -> int:
    """This rank's index along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str = "data"):
    """The process group of ``axis``."""
    return mesh.get_group(axis)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def shard_batch(batch: Any, mesh) -> Any:
    """This rank's rows of every array of a (nested) batch: the rank ``r`` of
    ``n`` keeps rows ``[r·B/n, (r+1)·B/n)`` of the global batch of ``B``
    (which ``n`` must divide). ``cli.train``'s datasets load each rank's rows
    themselves (``process_index`` / ``process_count``) and skip this."""
    n, r = axis_size(mesh), axis_rank(mesh)

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by mesh data axis {n}")
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b]

    return _tree_map(rows, batch)


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch from each rank's rows (``shard_batch``'s inverse):
    an all-gather over the data axis, in rank order."""
    n = axis_size(mesh)
    if n == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=axis_group(mesh))
    return out


@torch.no_grad()
def replicate_params(params, mesh, axis: str = "data", broadcast: bool = True) -> None:
    """Make every rank hold rank 0's values of ``params`` (an ``nn.Module``,
    or a dict or list of tensors), in place: a broadcast over ``axis``, then
    a check that the ranks agree (a per-tensor fingerprint, max and min over
    the ranks). ``broadcast=False`` only checks: it raises where the ranks
    hold different values."""
    tensors = list(params.parameters()) + list(params.buffers()) if isinstance(params, torch.nn.Module) else \
        list(params.values()) if isinstance(params, dict) else list(params)
    if axis_size(mesh, axis) == 1 or not tensors:
        return
    group = axis_group(mesh, axis)
    src = dist.get_global_rank(group, 0)
    for t in tensors if broadcast else ():
        dist.broadcast(t.data, src=src, group=group)
    fp = torch.stack([t.detach().double().sum() for t in tensors])
    hi, lo = fp.clone(), fp.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    if not torch.equal(hi, lo):
        raise RuntimeError("replicate_params: the ranks hold different values" + (" after the broadcast" if broadcast
                                                                                  else ": give each the same weights"))


def zero1_spec(shape, mesh) -> Optional[int]:
    """ZeRO-1 layout of one optimiser-state leaf of ``shape``: the axis
    sharded over ``data`` (the largest axis the data size divides, the
    first of equal ones), or None to replicate (scalars, indivisible
    leaves). The JAX package's axis choice leaf by leaf at more than one
    rank. At one rank the JAX package replicates; the port keeps the axis
    (one shard, the whole leaf: the same values), so that a mesh of one rank,
    which only an explicit ``make_mesh()`` gives (``resolve_mesh("auto")``
    takes none), runs the gather of a sharded update on a single card."""
    shape = tuple(shape)
    n = axis_size(mesh)
    for axis in sorted(range(len(shape)), key=lambda a: -shape[a]):
        if shape[axis] and shape[axis] % n == 0:
            return axis
    return None


def zero1_shard(tree: Any, mesh) -> Any:
    """This rank's ZeRO-1 shard of every leaf of ``tree`` (a view: the leaf
    narrowed to the rank's slice of its ``zero1_spec`` axis; a replicated
    leaf whole)."""
    n, r = axis_size(mesh), axis_rank(mesh)

    def shard(x):
        axis = zero1_spec(x.shape, mesh)
        if axis is None:
            return x
        size = x.shape[axis] // n
        return x.narrow(axis, r * size, size)

    return _tree_map(shard, tree)
