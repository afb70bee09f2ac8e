"""Op library of the port (counterpart of `mxnet_tpu/ops/__init__.py`).

One registry, `OPS`, holds every op by its MXNet name, as the JAX
package's does: a function on torch tensors that takes MXNet's op
parameters (`FullyConnected(data, weight, bias, num_hidden, no_bias,
flatten)`) and returns a tensor or a tuple. `nd.<op>` and `NDArray.<op>`
(`ndarray.registry_op`) and `sym.<op>` (the symbolic graph and its
executor) all read it.

The registrations of `math_ops.py` and `nn_ops.py` are those of the JAX
modules of the same names. The port's own functions (`nn_ops.
fully_connected`, `nn_ops.batch_norm`, ...) stay where their callers use
them; a registry entry is a thin adapter over them. The shape ops, the
detection ops, `RNN` and `ctc_loss` (modules ported before the registry)
are registered below under the JAX registry's names.

An op that reads the training flag (`Dropout`, `BatchNorm`,
`flash_attention`, `fused_self_attention`) takes `_training`, as the JAX
op does; None reads `autograd.is_training()`, which the executor sets
around a graph's evaluation. `RNG_OPS` names the ops that draw from the
random streams while they run.
"""
from __future__ import annotations

OPS = {}

# ops that draw from the random streams at execution time (the executor
# snapshots the streams before a forward, so a backward that replays it
# draws the same masks)
RNG_OPS = set()


def register(name):
    """Register an op under its MXNet name (reference: NNVM_REGISTER_OP)."""

    def deco(fn):
        if name in OPS:
            raise ValueError(f"op '{name}' already registered")
        OPS[name] = fn
        return fn

    return deco


def alias(new, existing):
    OPS[new] = OPS[existing]


def get(name):
    return OPS[name]


from . import math_ops       # noqa: E402,F401  (elemwise, reduce, linalg)
from . import nn_ops         # noqa: E402,F401
from . import shape_ops      # noqa: E402
from . import detection_ops  # noqa: E402
from . import rnn_ops        # noqa: E402
from . import misc_ops       # noqa: E402

for _name, _fn in shape_ops.NAMES.items():
    register(_name)(getattr(shape_ops, _fn))
for _name, _fn in {"_contrib_box_iou": detection_ops.box_iou,
                   "_contrib_box_nms": detection_ops.box_nms,
                   "_contrib_MultiBoxPrior": detection_ops.multibox_prior,
                   "_contrib_MultiBoxTarget": detection_ops.multibox_target,
                   "_contrib_MultiBoxDetection":
                       detection_ops.multibox_detection,
                   "_contrib_ROIAlign": detection_ops.roi_align,
                   "ROIPooling": detection_ops.roi_pooling,
                   "_contrib_AdaptiveAvgPooling2D":
                       detection_ops.adaptive_avg_pooling,
                   "_contrib_Proposal": detection_ops.proposal,
                   "RNN": rnn_ops.rnn, "ctc_loss": misc_ops.ctc_loss}.items():
    register(_name)(_fn)
for _name in ("CTCLoss", "_contrib_ctc_loss", "_contrib_CTCLoss"):
    alias(_name, "ctc_loss")

RNG_OPS.update({"Dropout", "RNN", "flash_attention", "fused_self_attention"})
