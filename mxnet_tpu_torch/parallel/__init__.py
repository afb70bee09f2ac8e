"""Training and expert parallelism (counterpart of `mxnet_tpu/parallel`):
the `ShardedTrainer` step on one device over the fused flat-master LAMB
or per-parameter Adam/AdamW (with checkpoints, preemption and the OOM
ladder), `AutoCheckpoint`, the mesh of named axes over the processes of
a `torch.distributed` group, and the Switch mixture-of-experts over its
`ep` axis, and this process' rank and the number of workers
(`distributed`). Sharded parameter modes, pipelines, ring attention and
Ulysses are not in the port yet."""
from .elastic import AutoCheckpoint
from .functional_opt import FunctionalOptimizer
from .fused_lamb import FusedLamb
from .distributed import num_workers, rank
from .mesh import (MeshPlan, current_mesh, local_mesh_devices, make_mesh,
                   mesh_axes, set_mesh)
from .moe import moe_apply, moe_ffn
from .trainer import ShardedTrainer, call_loss

__all__ = ["AutoCheckpoint", "FusedLamb", "FunctionalOptimizer",
           "ShardedTrainer", "call_loss", "MeshPlan", "make_mesh",
           "set_mesh", "current_mesh", "mesh_axes", "local_mesh_devices",
           "moe_apply", "moe_ffn", "rank", "num_workers"]
