"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into a shared library that ``ctypes`` loads -- no PyTorch headers, so
a build takes seconds. Libraries land in ``_build/`` inside the package (listed
in ``.gitignore``) under a name keyed by a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses the earlier build. Nothing is built
at import: the first call that needs a kernel builds it.

The target is ``sm_90a``, not plain ``sm_90``: the flash sources use ``wgmma``
(through the PTX wrappers of ``csrc/hopper.cuh``, whose bytes are part of every
build's key), which exists only there; ``flash_f32.cu`` holds their fp32
counterparts (in 3xTF32: the forward on ``wgmma`` tf32, the backward on ``mma.sync``); ``group_norm.cu`` uses
thread-block clusters and 1-D bulk copies. They need nothing beyond the CUDA toolkit's own
headers and runtime (no ``-lcuda``, no extra include path): their copies are
``cp.async`` and ``cp.async.bulk`` without a tensor map, and the cluster
launch is ``cudaLaunchKernelEx``. ``-Xptxas -v`` keeps each kernel's
registers, spills and warnings in ``build_logs``.

``bind`` gives an ``extern "C"`` entry point as a ctypes function and
``launch`` calls one on PyTorch's current stream, raising on a nonzero
``cudaError_t``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("flash_fwd", "flash_bwd", "flash_f32", "group_norm")

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[Tuple[str, str], object] = {}
# nvcc's stderr (ptxas register / shared-memory report) of builds made by this process
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, default /usr/local/cuda)")
    return path


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every listed source that has no current build, one ``nvcc``
    per source, all started together. Raises with nvcc's output on failure."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, out in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp, out)
        failures = []
        for name, (proc, tmp, out) in procs.items():
            stdout, stderr = proc.communicate()
            build_logs[name] = stdout + stderr
            if proc.returncode != 0:
                failures.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{stdout}{stderr}")
            else:
                os.replace(tmp, out)
        if failures:
            raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        path = build([name])[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]


def bind(source: str, symbol: str, argtypes: Sequence):
    """The ``extern "C"`` entry point ``symbol`` of ``csrc/<source>.cu`` as a
    ctypes function returning its ``cudaError_t``; the library is built at
    first use."""
    fn = _bound.get((source, symbol))
    if fn is None:
        fn = getattr(load(source), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _bound[(source, symbol)] = fn
    return fn


def current_raw_stream(device: torch.device) -> int:
    """The current stream's handle on ``device``. The raw getter, where this
    PyTorch has it, costs a tenth of building a ``torch.cuda.Stream``, and the
    wrappers sit on paths that the host bounds."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def launch(what: str, fn, device: torch.device, args: Sequence) -> None:
    """Call the entry point ``fn`` with ``args`` (plain ints, floats and
    pointers: ``argtypes`` converts them, which costs less than building
    ctypes objects here) and the current stream of ``device``, on that
    device; raise if the launch was refused."""
    stream = current_raw_stream(device)
    if torch.cuda.current_device() == device.index:  # the usual case: no device switch to pay for
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError_t {err}")
