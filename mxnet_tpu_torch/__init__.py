"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

A second package beside the JAX one (which stays the reference): the
same module layout and public names, PyTorch idiom inside, and every
TPU kernel on a ported path replaced by a hand-written CUDA kernel for
Hopper (`cuda_ops/`, sources in `csrc/`). The package imports torch and
never jax or mxnet_tpu. Entry points run on the card unless the caller
passes `device="cpu"`.

This slice serves GPT-2 through the paged continuous-batching server
(`serve.Server(model, pages="on")`) and `GPTForCausalLM.generate`.
"""
from . import (config, context, dataflow, gluon, initializer, models, pages,
               random, serve, weights)
from .context import cpu, gpu

__all__ = ["config", "context", "dataflow", "gluon", "initializer", "models",
           "pages", "random", "serve", "weights", "cpu", "gpu"]
