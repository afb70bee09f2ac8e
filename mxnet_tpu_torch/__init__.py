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
(`metric`).
"""
from . import (autograd, base, config, context, contrib, dataflow, gluon,
               initializer, lr_scheduler, memsafe, metric, models, ndarray,
               optimizer, pages, parallel, random, resilience, serve,
               weights)
from . import ndarray as nd
from .context import cpu, gpu
from .parallel import current_mesh, make_mesh, moe_apply, moe_ffn

__all__ = ["autograd", "base", "config", "context", "contrib", "dataflow",
           "gluon", "initializer", "lr_scheduler", "memsafe", "metric",
           "models", "nd", "ndarray", "optimizer", "pages", "parallel",
           "random", "resilience", "serve", "weights", "cpu", "gpu",
           "make_mesh", "current_mesh", "moe_apply", "moe_ffn"]
