"""Expert parallelism: a Switch-style mixture-of-experts over the `ep`
mesh axis (counterpart of `mxnet_tpu/parallel/moe.py`).

Top-1 routing, capacity-bounded expert buffers, the batched expert FFN
in float32, and the gated combine back to token order; tokens beyond an
expert's capacity are dropped and pass through the residual upstream,
as in the Switch Transformer. `moe_ffn` always takes the JAX package's
kernel path: compact routing (`moe_route`), then the dispatch kernel,
the expert FFN, then the combine kernel (`cuda_ops.moe_kernels`; for
CPU tensors their plain versions). `moe_dispatch` is the dense one-hot
form of the routing, kept for its callers and tests.

Layout (per process; n = extent of the ep axis):
  x       (N_local, D)            this process' tokens
  router  (D, E)                  replicated
  w1      (E_local, D, F)         this process' experts
  w2      (E_local, F, D)
  E = n * E_local experts in all.
The expert buffers travel to their owners and back with a
differentiable all_to_all over the axis' process group
(`torch.distributed.nn.functional.all_to_all_single`); with n = 1 the
exchange is the identity and no process group is needed.
"""
from __future__ import annotations

import torch

from ..cuda_ops.moe_kernels import combine_from_experts, dispatch_to_experts
from ..ops.nn_ops import gelu
from .mesh import current_mesh

__all__ = ["moe_dispatch", "moe_route", "moe_ffn", "moe_apply"]


def _probs(x, router_w):
    logits = x.float() @ router_w.float()                      # (N, E)
    return torch.softmax(logits, dim=-1)


def _one_hot(idx, n):
    """float32 one-hot rows of `idx` over n classes (an index outside
    [0, n) gives a row of zeros, as `jax.nn.one_hot` does)."""
    return (idx.long()[:, None]
            == torch.arange(n, device=idx.device)).float()


def _aux_loss(one_hot, probs, num_experts):
    """The Switch load-balancing loss: E * sum(fraction of tokens per
    expert * mean router probability per expert)."""
    return num_experts * torch.sum(one_hot.mean(0) * probs.mean(0))


def moe_dispatch(x, router_w, num_experts, capacity, axis_name=None):
    """Top-1 routing in dense form: (dispatch (N, E, C) one-hot send
    tensor, combine = dispatch * gate, aux_loss)."""
    probs = _probs(x, router_w)
    expert = torch.argmax(probs, dim=-1)             # the first maximum
    gate = probs.gather(-1, expert[:, None])[:, 0]
    one_hot = _one_hot(expert, num_experts)
    # position of each token within its expert's capacity buffer
    pos = torch.cumsum(one_hot, dim=0) * one_hot - 1.0         # (N, E)
    in_cap = (pos < capacity) & (one_hot > 0)
    pos_oh = _one_hot(pos.to(torch.int32).reshape(-1), capacity) \
        .reshape(*pos.shape, capacity)                         # (N, E, C)
    dispatch = pos_oh * in_cap[..., None]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine, _aux_loss(one_hot, probs, num_experts)


def moe_route(x, router_w, num_experts):
    """Compact top-1 routing: (expert (N,) int32, pos (N,) int32, gate (N,)
    float32, aux_loss). `pos` is the token's slot in its expert's
    capacity buffer, the running count of the tokens routed to that
    expert minus 1; a token past capacity carries pos >= C and the
    dispatch and combine kernels drop it."""
    probs = _probs(x, router_w)
    expert = torch.argmax(probs, dim=-1)             # the first maximum
    gate = probs.gather(-1, expert[:, None])[:, 0]
    one_hot = _one_hot(expert, num_experts)
    # an integer running count per expert: equal to the JAX package's
    # float32 cumsum below 2**24 tokens. Taken along the last dim of the
    # (E, N) transpose: a scan over dim 0 of (N, E) runs E long serial
    # columns on the card (2.8 ms at N = 16,384, E = 8, on an H100)
    counts = torch.cumsum(one_hot.t().to(torch.int32).contiguous(), dim=1,
                          dtype=torch.int32)
    pos = counts.gather(0, expert[None, :])[0] - 1
    return (expert.to(torch.int32), pos.to(torch.int32), gate,
            _aux_loss(one_hot, probs, num_experts))


def _all_to_all(t, group):
    """all_to_all over dim 0 (one equal chunk per member of `group`, in
    group-rank order), differentiable; the identity without a group."""
    if group is None:
        return t
    from torch.distributed.nn.functional import all_to_all_single
    t = t.contiguous()
    return all_to_all_single(torch.empty_like(t), t, group=group)


def _expert_ffn(buf, w1, w2, n, e_local, capacity, d_model, axis_name,
                activation, mesh=None):
    """The middle of the Switch FFN: ship each expert's buffer to its
    owner, run the batched FFN einsums in float32, ship the results
    back. `axis_name` names the mesh axis (of `mesh`, else the current
    mesh) whose process group carries the exchange."""
    group = (mesh or current_mesh()).group(axis_name) if n > 1 else None
    # send each expert-shard to its owner: (E, C, D) -> (n, E_local, C, D)
    buf = _all_to_all(buf.reshape(n, e_local, capacity, d_model), group)
    # dim 0 now indexes the SOURCE process; fold the sources into the
    # capacity dim for the FFN
    buf = buf.transpose(0, 1).reshape(e_local, n * capacity, d_model)

    h = torch.einsum("ecd,edf->ecf", buf, w1.float())
    h = activation(h)
    out = torch.einsum("ecf,efd->ecd", h, w2.float())

    # route back: the inverse reshape and all_to_all
    out = out.reshape(e_local, n, capacity, d_model).transpose(0, 1)
    out = _all_to_all(out, group)
    return out.reshape(n * e_local, capacity, d_model)


def moe_ffn(x, router_w, w1, w2, axis_name, capacity_factor=1.25,
            activation=gelu, mesh=None):
    """The expert-parallel Switch FFN on this process' tokens and experts
    (shapes in the module docstring). Returns (y (N, D) in x's dtype,
    aux_loss, the mean over the axis)."""
    mesh = mesh or current_mesh()
    n = mesh.shape[axis_name]
    e_local = w1.shape[0]
    num_experts = n * e_local
    n_tokens, d_model = x.shape
    capacity = max(int(n_tokens * capacity_factor / num_experts), 1)

    expert, pos, gate, aux = moe_route(x, router_w, num_experts)
    buf = dispatch_to_experts(x.float().contiguous(), expert, pos,
                              num_experts, capacity)
    out = _expert_ffn(buf, w1, w2, n, e_local, capacity, d_model, axis_name,
                      activation, mesh)
    y = combine_from_experts(out, expert, pos, gate)
    if n > 1:
        from torch.distributed.nn.functional import all_reduce
        aux = all_reduce(aux, group=mesh.group(axis_name)) / n
    return y.to(x.dtype), aux


def moe_apply(x, router_w, w1, w2, mesh=None, axis_name="ep",
              capacity_factor=1.25, activation=gelu):
    """The Switch FFN over the mesh: x (N, D) the global tokens, w1 and
    w2 all E experts, router replicated. Each process along `axis_name`
    takes its slice of the tokens and of the experts; returns (this
    process' rows of y, aux_loss). In one process that is all of y.
    NDArray arguments (a user block's forward computes on NDArrays) are
    unwrapped, and y and aux_loss come back as NDArrays then."""
    from ..ndarray.ndarray import NDArray
    if any(isinstance(a, NDArray) for a in (x, router_w, w1, w2)):
        y, aux = moe_apply(*(a._t if isinstance(a, NDArray) else a
                             for a in (x, router_w, w1, w2)),
                           mesh=mesh, axis_name=axis_name,
                           capacity_factor=capacity_factor,
                           activation=activation)
        return NDArray(y), NDArray(aux)
    mesh = mesh or current_mesh()
    n = mesh.shape[axis_name]
    if n > 1:
        r = mesh.coordinate(axis_name)
        if x.shape[0] % n or w1.shape[0] % n:
            raise ValueError(f"moe_apply: {x.shape[0]} tokens and "
                             f"{w1.shape[0]} experts must divide over the "
                             f"{n} processes of axis {axis_name!r}")
        nl, el = x.shape[0] // n, w1.shape[0] // n
        x = x[r * nl:(r + 1) * nl]
        w1, w2 = w1[r * el:(r + 1) * el], w2[r * el:(r + 1) * el]
    return moe_ffn(x, router_w, w1, w2, axis_name, capacity_factor,
                   activation, mesh)
