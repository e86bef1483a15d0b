from instantir_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
    replicate_params,
    shard_batch,
    zero1_shard,
    zero1_spec,
)

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "replicate_params",
    "shard_batch",
    "zero1_shard",
    "zero1_spec",
]
