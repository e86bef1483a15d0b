from instantir_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
    replicate_params,
    shard_batch,
    zero1_shard,
    zero1_spec,
)
from instantir_tpu_torch.parallel.tp import tp_shard_, tp_sharded_bytes, tp_spec

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "replicate_params",
    "shard_batch",
    "tp_shard_",
    "tp_sharded_bytes",
    "tp_spec",
    "zero1_shard",
    "zero1_spec",
]
