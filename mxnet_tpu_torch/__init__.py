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
BERT through `parallel.ShardedTrainer` with fused flat-master LAMB, and
GPT-2 with per-parameter Adam or AdamW; and it trains a Switch
mixture-of-experts (`parallel.moe_apply` over the mesh's `ep` axis).
"""
from . import (config, context, contrib, dataflow, gluon, initializer,
               models, optimizer, pages, parallel, random, serve, weights)
from .context import cpu, gpu
from .parallel import current_mesh, make_mesh, moe_apply, moe_ffn

__all__ = ["config", "context", "contrib", "dataflow", "gluon", "initializer",
           "models", "optimizer", "pages", "parallel", "random", "serve",
           "weights", "cpu", "gpu", "make_mesh", "current_mesh", "moe_apply",
           "moe_ffn"]
