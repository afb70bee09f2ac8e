"""Training on one device (counterpart of `mxnet_tpu/parallel`): the
`ShardedTrainer` step over the fused flat-master LAMB. Meshes, sharded
parameter modes, pipelines and collectives are not in the port yet."""
from .fused_lamb import FusedLamb
from .functional_opt import FunctionalOptimizer
from .trainer import ShardedTrainer, call_loss

__all__ = ["FusedLamb", "FunctionalOptimizer", "ShardedTrainer", "call_loss"]
