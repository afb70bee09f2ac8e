"""This process' place in a multi-process job (counterpart of `rank` and
`num_workers` in `mxnet_tpu/parallel/distributed.py`), read from the
`torch.distributed` process group: rank 0 of 1 worker when there is
none. The JAX package's `init_distributed` has no counterpart yet: a
port process joins a job through `torch.distributed.
init_process_group`, given its address, world size and rank."""
from __future__ import annotations

import torch.distributed as dist

__all__ = ["rank", "num_workers", "is_distributed"]


def is_distributed():
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if is_distributed() else 0


def num_workers():
    return dist.get_world_size() if is_distributed() else 1
