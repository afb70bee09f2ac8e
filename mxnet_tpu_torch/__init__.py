"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

A second package beside the JAX one (which stays the reference): the
same module layout and public names, PyTorch idiom inside, and every
TPU kernel on a ported path replaced by a hand-written CUDA kernel for
Hopper (`cuda_ops/`, sources in `csrc/`). The package imports torch and
never jax or mxnet_tpu. Entry points run on the card unless the caller
passes `device="cpu"`.

It serves GPT-2 through the paged continuous-batching server
(`serve.Server(model, pages="on")`) and `GPTForCausalLM.generate`, also
int8-quantized (`contrib.quantization.quantize_block`); it pretrains
BERT through `parallel.ShardedTrainer` with fused flat-master LAMB
(float32 or bf16 moments; checkpoints, preemption and resume through
`resilience` and `parallel.AutoCheckpoint`, the OOM ladder through
`memsafe`), and
GPT-2 with per-parameter Adam or AdamW; it trains a Switch
mixture-of-experts (`parallel.moe_apply` over the mesh's `ep` axis); and
it trains the Transformer NMT (`models.transformer`) through MXNet's
eager loop (`nd`, `autograd.record()` / `backward()`, `gluon.Trainer`),
then decodes it greedily or by beam search; and it trains the detection
models YOLOv3-tiny and SSD through the same loop, decodes them through
greedy NMS (`ops.detection_ops`) and scores them by VOC07 mAP
(`metric`); it trains the vision model zoo (`gluon.model_zoo`) on
`gluon.data` pipelines, and tokenizes text (`contrib.text`). MXNet's
contexts (`with mx.cpu():`) choose the device of code that names none,
so the repo's examples run unchanged through `run_example`. MXNet's
symbolic half is here too: the op registry by MXNet name (`ops`, behind
`nd.<op>`, `NDArray.<op>` and `sym.<op>`), `sym` with its executor,
`io`, `mod.Module` / `BucketingModule`, `callback`, `monitor` and
`gluon.SymbolBlock`.
"""
from . import (attribute, autograd, base, config, context, contrib,
               dataflow, gluon, initializer, lr_scheduler, memsafe, metric,
               models, name, ndarray, optimizer, pages, parallel, random,
               resilience, serve, weights)
from . import initializer as init
from . import ndarray as nd
from .attribute import AttrScope
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus
from .parallel import current_mesh, make_mesh, moe_apply, moe_ffn

__all__ = ["attribute", "autograd", "base", "config", "context", "contrib",
           "dataflow", "gluon", "init", "initializer", "lr_scheduler",
           "memsafe", "metric", "models", "name", "nd", "ndarray",
           "optimizer", "pages", "parallel", "random", "resilience", "serve",
           "weights", "AttrScope", "MXNetError", "Context", "cpu", "gpu",
           "current_context", "num_gpus", "make_mesh", "current_mesh",
           "moe_apply", "moe_ffn"]

# the symbolic half and its helpers, imported at first use under the JAX
# package's names (`mxnet_tpu/__init__.py` `_LAZY`)
_LAZY = {
    "callback": ".callback",
    "io": ".io",
    "mod": ".module",
    "module": ".module",
    "model": ".module",
    "sym": ".symbol",
    "symbol": ".symbol",
    "mon": ".monitor",
    "monitor": ".monitor",
    "executor": ".symbol.executor",
    "registry": ".registry",
}


def __getattr__(name):
    import importlib
    if name in _LAZY:
        mod = importlib.import_module(_LAZY[name], __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'mxnet_tpu_torch' has no attribute "
                         f"'{name}'")
