"""The mixture-of-experts MLP of ``models/moe.py``, in PyTorch.

A drop-in for a transformer FFN block, [B, S, H] -> [B, S, H], as the
reference's ``MoeMlp`` (GShard/Switch style, dense one-hot dispatch):

- router: a bias-free f32 Dense (``router/kernel`` [H, E], Normal(0,
  0.02)) on the f32 tokens, then a softmax over the experts;
- top-k (default 2) gates, ties to the lower expert index as
  ``jax.lax.top_k`` breaks them, renormalised by ``max(sum, 1e-9)``;
- capacity ``max(int(ceil(k * N / E * capacity_factor)), 1)`` tokens an
  expert, the reference's float expression; slots are filled slot by slot
  (every token's first choice, then every token's second), each in
  flattened (B, S) token order, and a token past its expert's capacity is
  dropped from it (its residual connection still carries it);
- ``combine`` [N, E, C] holds each kept (token, expert, slot)'s gate,
  ``dispatch = combine > 0`` in the compute dtype; the expert FFNs are one
  pair of stacked weights ``w_in`` [E, H, M], ``b_in`` [E, M], ``w_out``
  [E, M, H], ``b_out`` [E, H] (Normal(0, 0.02) kernels, zero biases), run
  as einsums in the compute dtype with exact GELU;
- in training, the Switch load-balance term ``E * sum_e f_e p_e`` (f: the
  top-1 assignment fractions, p: the mean router probabilities), in f32.

Where flax sows that term into its ``moe_losses`` collection, the port
returns it to the caller (:func:`moe_mlp` gives ``(y, aux)``, ``aux`` None
in eval), and a model hands it to :func:`sow`, which appends it to the
list of the innermost :func:`collect_losses` context (the train step opens
one around each forward and adds ``moe_aux_weight`` times the sum to its
loss).  Outside such a context :func:`sow` does nothing, so an eval pass,
or a layer that ``torch.utils.checkpoint`` recomputes in the backward,
adds nothing.

``jax.nn.one_hot`` gives a zero row for a slot position at or past the
capacity where ``F.one_hot`` raises: the port clamps the position and
masks the row with ``keep``, which gives the same zeros.  A 0-d f32
tensor does not promote a bf16 tensor in torch where ``jnp`` promotes to
f32; every op here runs at the dtype the reference gives it.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

_LOCAL = threading.local()


@contextlib.contextmanager
def collect_losses():
    """A list that every :func:`sow` inside the context appends to (the
    reference's mutable ``moe_losses`` collection); contexts nest, the
    innermost collects."""
    outer = getattr(_LOCAL, "losses", None)
    _LOCAL.losses = losses = []
    try:
        yield losses
    finally:
        _LOCAL.losses = outer


def sow(value: torch.Tensor) -> None:
    """Hands ``value`` to the open :func:`collect_losses` list, if any."""
    losses: Optional[List[torch.Tensor]] = getattr(_LOCAL, "losses", None)
    if losses is not None:
        losses.append(value)


def capacity(num_tokens: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots an expert: the reference's ``max(int(math.ceil(k * n / e *
    capacity_factor)), 1)`` with ``k = min(top_k, e)``."""
    k = min(top_k, num_experts)
    return max(int(math.ceil(k * num_tokens / num_experts * capacity_factor)), 1)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: values in descending order, ties
    to the lower index (a stable descending sort)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """One routing decision: ``combine`` [N, E, C] f32 gates, ``gate_idx``
    [N, k] the chosen experts, ``probs`` [N, E] the router's f32
    probabilities, ``kept`` [E] the tokens each expert took."""

    combine: torch.Tensor
    gate_idx: torch.Tensor
    probs: torch.Tensor
    kept: torch.Tensor


def route(router_kernel: torch.Tensor, xf: torch.Tensor, num_experts: int,
          k: int, cap: int) -> Routing:
    """The router and the slot assignment of ``xf`` [N, H] (ref
    ``models/moe.py:60-92``)."""
    n = xf.shape[0]
    logits = torch.matmul(xf.float(), router_kernel.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    combine = torch.zeros((n, num_experts, cap), dtype=torch.float32,
                          device=xf.device)
    counts = torch.zeros((num_experts,), dtype=torch.int32, device=xf.device)
    for j in range(k):
        onehot = F.one_hot(gate_idx[:, j], num_experts).to(torch.int32)
        # tokens of this slot queued before each token, per expert
        before = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
        pos = (before * onehot).sum(-1) + (counts[None, :] * onehot).sum(-1)
        keep = pos < cap
        slot = F.one_hot(torch.clamp_max(pos, cap - 1).long(), cap).float()
        combine = combine + (gate_vals[:, j, None, None] * onehot[:, :, None]
                             * slot[:, None, :] * keep[:, None, None])
        counts = counts + (onehot * keep[:, None]).sum(0, dtype=torch.int32)
    return Routing(combine, gate_idx, probs, counts)


def moe_mlp(p: Params, x: torch.Tensor, *, num_experts: int,
            capacity_factor: float = 1.25, router_top_k: int = 2,
            dtype: torch.dtype = torch.bfloat16, train: bool = True):
    """``(y [B, S, H] in dtype, aux)``: the reference's ``MoeMlp.__call__``
    on the params ``p`` (``router/kernel``, ``w_in``, ``b_in``, ``w_out``,
    ``b_out``); ``aux`` is the f32 load-balance term in training, None
    otherwise."""
    b, s, hidden = x.shape
    n = b * s
    e = num_experts
    k = min(router_top_k, e)
    cap = capacity(n, e, router_top_k, capacity_factor)
    xf = x.reshape(n, hidden)
    r = route(p["router"]["kernel"], xf, e, k, cap)
    dispatch = (r.combine > 0).to(dtype)
    expert_in = torch.einsum("nec,nh->ech", dispatch, xf.to(dtype))
    h = (torch.einsum("ech,ehm->ecm", expert_in, p["w_in"].to(dtype))
         + p["b_in"][:, None, :].to(dtype))
    h = F.gelu(h, approximate="none")
    out = (torch.einsum("ecm,emh->ech", h, p["w_out"].to(dtype))
           + p["b_out"][:, None, :].to(dtype))
    y = torch.einsum("nec,ech->nh", r.combine.to(dtype), out)
    aux = None
    if train:
        f = F.one_hot(r.gate_idx[:, 0], e).float().mean(0)
        aux = e * torch.sum(f * r.probs.mean(0))
    return y.reshape(b, s, hidden), aux


def init_params(hidden: int, intermediate: int, num_experts: int,
                nrm) -> Params:
    """The reference's tree and initialisers: ``nrm(*shape)`` draws the
    Normal(0, 0.02) kernels (in the reference's creation order), the
    biases are zeros on the kernels' device."""
    router = nrm(hidden, num_experts)
    w_in = nrm(num_experts, hidden, intermediate)
    dev = w_in.device
    b_in = torch.zeros((num_experts, intermediate), device=dev)
    w_out = nrm(num_experts, intermediate, hidden)
    b_out = torch.zeros((num_experts, hidden), device=dev)
    return {"router": {"kernel": router}, "w_in": w_in, "b_in": b_in,
            "w_out": w_out, "b_out": b_out}
