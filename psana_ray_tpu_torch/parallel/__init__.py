"""Distribution: device meshes, sharding rules, differentiable collectives,
long-context attention, pipeline and expert parallelism, and the steps
over a mesh; the single-device flash attention (K5 forward, K6/K7
backward) underneath. Counterpart of ``psana_ray_tpu/parallel``: a
``DeviceMesh`` with named dims over the process group (NCCL on the card,
gloo on the CPU), DTensor placements from logical-axis rules, and the
SPMD bodies (ring, Ulysses, the GPipe schedule) written on each rank's
local shard with collectives that autograd differentiates.
"""

from psana_ray_tpu_torch.parallel.flash import (
    FlashAttention,
    attention_bwd_plain,
    attention_with_stats,
    attention_with_stats_plain,
    check_kernel_inputs,
    flash_attention,
    ring_flash_attention,
)
from psana_ray_tpu_torch.parallel.mesh import (
    MeshSpec,
    create_mesh,
    init_process_group,
    local_batch_slice,
    local_rows,
    run_ranks,
)
from psana_ray_tpu_torch.parallel.moe import SwitchMoEMlp, pick_group_size, total_aux_loss
from psana_ray_tpu_torch.parallel.pp import pipeline_apply, stack_stages
from psana_ray_tpu_torch.parallel.ring_attention import (
    reference_attention,
    ring_attention,
    ulysses_attention,
)
from psana_ray_tpu_torch.parallel.sharding import ShardingRules, infer_sharding
from psana_ray_tpu_torch.parallel.steps import (
    TrainState,
    create_train_state,
    init_sharded,
    make_infer_step,
    make_train_step,
)

__all__ = [
    "FlashAttention",
    "MeshSpec",
    "ShardingRules",
    "SwitchMoEMlp",
    "TrainState",
    "attention_bwd_plain",
    "attention_with_stats",
    "attention_with_stats_plain",
    "check_kernel_inputs",
    "create_mesh",
    "create_train_state",
    "flash_attention",
    "infer_sharding",
    "init_process_group",
    "init_sharded",
    "local_batch_slice",
    "local_rows",
    "make_infer_step",
    "make_train_step",
    "pick_group_size",
    "pipeline_apply",
    "reference_attention",
    "ring_attention",
    "ring_flash_attention",
    "run_ranks",
    "stack_stages",
    "total_aux_loss",
    "ulysses_attention",
]
