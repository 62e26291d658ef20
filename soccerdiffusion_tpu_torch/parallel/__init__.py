"""Data, tensor and sequence parallelism on ``torch.distributed`` (counterpart
of ``soccerdiffusion_tpu/parallel/``): one process per rank, the ranks laid
out on a named mesh (``mesh.py``), the collectives in one helper
(``comm.py``), the process group's start-up (``distributed.py``), ring and
head-sharded attention (``ring_attention.py``) and the Megatron splits
(``tensor_parallel.py``). Where the JAX mesh gives the single-device
result, the port's ranks give the single-process one."""

from soccerdiffusion_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize_distributed,
    rank_device,
    shutdown_distributed,
)
from soccerdiffusion_tpu_torch.parallel.mesh import (
    DCN_AXIS,
    Mesh,
    MeshRules,
    ambient_mesh,
    make_hybrid_mesh,
    make_mesh,
    param_placements,
    rules_for_mesh,
    shard_batch,
    use_mesh,
)
from soccerdiffusion_tpu_torch.parallel.ring_attention import (
    auto_ring_attention,
    head_sharded_attention,
    ring_attention_sharded,
    ring_self_attention,
)

__all__ = ["DCN_AXIS", "Mesh", "MeshRules", "ambient_mesh", "auto_ring_attention",
           "global_mesh", "head_sharded_attention", "initialize_distributed", "make_hybrid_mesh",
           "make_mesh", "param_placements", "rank_device", "ring_attention_sharded",
           "ring_self_attention", "rules_for_mesh", "shard_batch", "shutdown_distributed",
           "use_mesh"]
