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

Routing over the global batch (the reference's implicit data-parallel
step is one program over the global batch).  Inside :func:`routing_over`
(``group``: the data-parallel group, the ranks that hold different rows
of one global batch, in the order of their rows) every layer routes as
the reference routes the global batch, from this rank's rows only: one
all-gather (``collectives.all_gather`` over ``group``) brings every rank's
``[k, E]`` choice counts, its token count and its ``[E]`` sum of router
probabilities; the capacity comes from the global token count, a token's
slot position counts the tokens of earlier ranks queued for its expert in
the same slot, and the kept counts and the load-balance term's f and p
are the global batch's.  The term's value is the global one; its
gradient is that of ``E * sum_e f_e p_e`` with this rank's p, so the
data-parallel mean of the ranks' gradients is the global term's.  The
train and eval steps of ``train.step`` open the context on their
implicit path; the ``comm_overlap`` step routes each shard on its own
(the reference's explicit path, whose step scales the term by the shard
count).

Expert and tensor parallelism (``expert=`` and ``tensor=`` of
:func:`moe_mlp`, each an axis with ``group``, ``index`` and ``size``): the
ranks along ``expert`` (and ``tensor``) hold the same tokens.  Every rank
routes whole (its router kernel gathered whole by the caller); it holds
the ``E / size`` experts ``[index * E / size, ...)`` of ``w_in``, ``b_in``,
``w_out`` and ``b_out`` and runs only their slice of ``dispatch`` and
``combine``.  Under ``tensor`` each expert's FFN is Megatron's: ``w_in``
column-parallel (*f* on its input), ``w_out`` row-parallel (*g*, partial
sums in f32), ``b_out`` added after the sum.  The combined output is
summed over the expert group (*g*), and the layer's input passes *f* over
it, so each rank's partial gradient of the input and of the router (its
own experts' share of ``combine``) is summed over the expert ranks.  The
load-balance term, which every expert rank computes whole, enters that
sum once: its gradient is divided by the expert count.  No all-to-all
runs: the expert ranks already hold every token.

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

from distributeddeeplearning_tpu_torch.parallel import collectives

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
    probabilities, ``kept`` [E] the tokens each expert took, ``top1`` [E]
    the tokens whose first choice each expert is, ``n`` the tokens routed
    and ``probs_sum`` [E] their summed probabilities (no gradient): the
    last four over the global batch when routed over a group (None
    ``probs_sum`` for this rank's rows alone)."""

    combine: torch.Tensor
    gate_idx: torch.Tensor
    probs: torch.Tensor
    kept: torch.Tensor
    top1: torch.Tensor
    n: int
    probs_sum: Optional[torch.Tensor]


@contextlib.contextmanager
def routing_over(group):
    """Route every layer inside the context over the global batch of the
    data-parallel ``group`` (module docstring); None routes this rank's
    rows alone.  Contexts nest, the innermost holds."""
    outer = getattr(_LOCAL, "group", None)
    _LOCAL.group = group
    try:
        yield
    finally:
        _LOCAL.group = outer


def routing_group():
    """The group of the innermost :func:`routing_over`, when it runs
    collectives over more than one rank; else None."""
    group = getattr(_LOCAL, "group", None)
    if group is None or not collectives.active(group) or collectives.group_size(group) < 2:
        return None
    return group


def _choices(gate_idx, num_experts: int) -> torch.Tensor:
    """[k, E]: the tokens choosing each expert in each slot."""
    return torch.stack([F.one_hot(gate_idx[:, j], num_experts).sum(0)
                        for j in range(gate_idx.shape[1])])


def route(router_kernel: torch.Tensor, xf: torch.Tensor, num_experts: int,
          k: int, cap: Optional[int] = None, *, capacity_factor: float = 1.25,
          group=None) -> Routing:
    """The router and the slot assignment of ``xf`` [N, H] (ref
    ``models/moe.py:60-92``): slot by slot, each in token order, an expert
    keeping the first ``cap`` tokens of its queue (``cap`` None: the
    reference's capacity of the routed tokens at ``capacity_factor``).
    Over ``group`` (:func:`routing_over`) the tokens routed are the global
    batch's: one all-gather brings every rank's ``[k, E]`` choice counts,
    token count and probability sums (float64: the counts stay exact),
    this rank's tokens queue after those of earlier ranks, and the
    capacity and the counts are the global batch's."""
    probs = torch.softmax(torch.matmul(xf.float(), router_kernel.float()), dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    mine = _choices(gate_idx, num_experts)
    n, earlier, total, probs_sum = xf.shape[0], torch.zeros_like(mine), mine, None
    if group is not None:
        payload = torch.cat([mine.reshape(-1).double(),
                             torch.full((1,), float(n), dtype=torch.float64,
                                        device=xf.device),
                             probs.detach().sum(0).double()])
        every = collectives.all_gather(payload, group, tiled=False)  # [R, kE + 1 + E]
        ke = k * num_experts
        counts = every[:, :ke].round().long().view(-1, k, num_experts)
        earlier = counts[:collectives.group_rank(group)].sum(0)
        total, n = counts.sum(0), int(every[:, ke].sum().item())
        probs_sum = every[:, ke + 1:].sum(0).float()
    if cap is None:
        cap = capacity(n, num_experts, k, capacity_factor)
    combine = torch.zeros((xf.shape[0], num_experts, cap), dtype=torch.float32,
                          device=xf.device)
    counts = torch.zeros((num_experts,), dtype=torch.long, device=xf.device)
    for j in range(k):
        onehot = F.one_hot(gate_idx[:, j], num_experts).long()
        # tokens of this slot queued before each token, per expert
        before = torch.cumsum(onehot, dim=0) - onehot + earlier[j][None, :]
        pos = (before * onehot).sum(-1) + (counts[None, :] * onehot).sum(-1)
        keep = pos < cap
        slot = F.one_hot(torch.clamp_max(pos, cap - 1), cap).float()
        combine = combine + (gate_vals[:, j, None, None] * onehot[:, :, None]
                             * slot[:, None, :] * keep[:, None, None])
        # every rank's tokens of this slot take positions counts .. counts
        # + total - 1 of their expert's queue: the first cap of it stay
        counts = counts + torch.clamp(cap - counts, min=0).minimum(total[j])
    return Routing(combine, gate_idx, probs, counts, total[0], n, probs_sum)


def _load_balance(r: Routing, num_experts: int, expert_size: int):
    """The Switch term ``E * sum_e f_e p_e`` (module docstring): over this
    rank's rows alone, or the global batch's value whose gradient is that
    of this rank's p; divided by ``expert_size`` (the expert ranks that
    each compute it whole) in the gradient."""
    e = num_experts
    local = e * torch.sum(r.top1.float() / r.n * r.probs.mean(0))
    if r.probs_sum is None and expert_size == 1:
        return local
    value = local if r.probs_sum is None else e * torch.sum(
        r.top1.float() / r.n * r.probs_sum / r.n)
    return value.detach() + (local - local.detach()) / expert_size


def moe_mlp(p: Params, x: torch.Tensor, *, num_experts: int,
            capacity_factor: float = 1.25, router_top_k: int = 2,
            dtype: torch.dtype = torch.bfloat16, train: bool = True,
            expert=None, tensor=None):
    """``(y [B, S, H] in dtype, aux)``: the reference's ``MoeMlp.__call__``
    on the params ``p`` (``router/kernel``, ``w_in``, ``b_in``, ``w_out``,
    ``b_out``); ``aux`` is the f32 load-balance term in training, None
    otherwise.  ``expert`` and ``tensor``: the axes this rank's slices of
    the expert weights are split over (module docstring); ``router/
    kernel`` is whole."""
    b, s, hidden = x.shape
    e = num_experts
    k = min(router_top_k, e)
    xf = x.reshape(b * s, hidden)
    if expert is not None:
        xf = collectives.copy_to_group(xf, expert.group)
    r = route(p["router"]["kernel"], xf, e, k, capacity_factor=capacity_factor,
              group=routing_group())
    mine = p["w_in"].shape[0]
    first = 0 if expert is None else expert.index * mine
    combine = r.combine[:, first:first + mine]
    dispatch = (combine > 0).to(dtype)
    expert_in = torch.einsum("nec,nh->ech", dispatch, xf.to(dtype))
    if tensor is not None:
        expert_in = collectives.copy_to_group(expert_in, tensor.group)
    h = (torch.einsum("ech,ehm->ecm", expert_in, p["w_in"].to(dtype))
         + p["b_in"][:, None, :].to(dtype))
    h = F.gelu(h, approximate="none")
    if tensor is None:
        out = torch.einsum("ecm,emh->ech", h, p["w_out"].to(dtype))
    else:
        out = collectives.reduce_from_group(
            torch.einsum("ecm,emh->ech", h.float(), p["w_out"].float()),
            tensor.group).to(dtype)
    out = out + p["b_out"][:, None, :].to(dtype)
    if expert is None:
        y = torch.einsum("nec,ech->nh", combine.to(dtype), out)
    else:
        y = collectives.reduce_from_group(
            torch.einsum("nec,ech->nh", combine, out.float()), expert.group).to(dtype)
    aux = None
    if train:
        aux = _load_balance(r, e, 1 if expert is None else expert.size)
    return y.reshape(b, s, hidden), aux


#: the logical axes of the expert FFN's parameters (ref ``models/moe.py:65``,
#: ``:102-127``)
LOGICAL_AXES = {
    "router": {"kernel": ("embed", "expert")},
    "w_in": ("expert", "embed", "mlp"),
    "b_in": ("expert", "mlp"),
    "w_out": ("expert", "mlp", "embed"),
    "b_out": ("expert", "embed"),
}


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
