"""BERT and MoE BERT over the fsdp, tensor and expert axes, and MoE routing
under data parallelism, against the JAX package on the CPU.

Four gloo ranks (``tests/_torch_dp.run_ranks``, one module-scoped spawn)
train the reference's TINY BERT (``tests/test_bert_workload.py``: 2
layers, hidden 32, 4 heads, ff 64, vocabulary 101, 3 classes, seq 16, f32,
dropout 0) on ``tensor=2 x fsdp=2``, ``fsdp=4`` and ``data=2 x tensor=2``,
and TINY MoE BERT (the same with 4 experts in layer 1, ref
``tests/test_moe.py``) on ``data=2 x expert=2``, ``expert=2 x fsdp=2``
and ``expert=2 x tensor=2``, each for 3 steps over the same global
batches of 8 synthetic-text rows (a numpy seed: ids, padding masks and
labels), through ``build_train_step(mesh=..., rules=..., logical_axes=
...)`` with the reference workload's rule choice and BERT's logical axes,
AdamW's clip at half the first step's unclipped norm.  The weights come
from a numpy seed (``params_from_numpy``, laid out by ``ParamLayout``);
the ranks import no jax.  The same spawn runs ``workloads.bert.main`` at
``fsdp=2, tensor=2`` and at ``num_experts=4, expert=2``.

Held against:

- the JAX package's ``build_train_step`` with the reference's rules and
  ``model_logical_axes`` on its 8 virtual CPU devices (BERT: ``fsdp=2 x
  tensor=2``, ``RULES_TP``; MoE BERT: ``expert=2 x fsdp=2``,
  ``RULES_FSDP + RULES_EP``; data 2): losses within ``REF_LOSS_RTOL``, the
  first step's global gradient (``jax.grad`` of the same loss, the
  load-balance term weighted 0.01 in) within ``GRAD_TOL`` of each leaf's
  scale, the clip norm within ``NORM_RTOL``, the first update within
  ``REF_PARAM_ATOL``;
- the port's one-process step in this process (``ONE_*``);
- within the port: the moments take the shard's shape, the leaves a data
  shard's ranks hold whole are bitwise equal across them after every
  step, each expert rank holds its 2 of the 4 experts, every rank routes
  the global batch (its rows' choices and the kept counts are one
  process's), and a sharded generation holds the one-process arrays and
  resumes bitwise.

Tolerances (f32).  The sharded step sums the same products in other
orders (partial sums over the tensor and expert groups, gradients
reduce-scattered over fsdp, the loss a mean of shard means); measured on
these meshes the losses agree to 1.1e-7 relative and each leaf's first
gradient to 4.3e-7 of its largest |g|, so ``ONE_LOSS_RTOL`` and
``GRAD_TOL`` are 1e-5.  A leaf's scale is its largest |g|, floored at
1e-6 of the tree's largest: the key biases' gradient is 0 (softmax does
not see a constant a row) and reads ~1e-13 of summation noise on both
sides.  Parameters after three AdamW steps of lr 1e-2: within
``ONE_PARAM_ATOL`` = 5e-5 (measured 1.1e-5, on ``token_embed``: AdamW
turns an element's gradient near 0, which another summation order leaves
at 1e-12 or at 0, into an update of up to lr x g / (g + eps)).  The clip
norm within 1e-6 relative.

C8 (MoE routing under the implicit data-parallel step): two ranks of pure
data parallelism at a capacity factor that drops tokens (1.0) must give
the reference implicit step's expert choices, kept counts (the
reference's slot-by-slot assignment of its global batch, in numpy),
load-balance term and losses; routing each rank's rows alone, with a
capacity of its own, does not.

Host-only tests hold ``logical_axes`` and ``param_shardings`` to the
reference's leaf by leaf under every rule set its BERT workload picks, the
model's refusal of layouts it cannot run, and the workload's refusals.
"""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dp
from distributeddeeplearning_tpu.data import synthetic as jsynth
from distributeddeeplearning_tpu.models import bert as jbert
from distributeddeeplearning_tpu.models import moe as jmoe
from distributeddeeplearning_tpu.parallel import MeshSpec as JMeshSpec
from distributeddeeplearning_tpu.parallel import create_mesh as jcreate_mesh
from distributeddeeplearning_tpu.parallel import shard_batch as jshard_batch
from distributeddeeplearning_tpu.parallel import sharding as jsharding
from distributeddeeplearning_tpu.train import state as jstate
from distributeddeeplearning_tpu.train import step as jstep
from distributeddeeplearning_tpu.train.step import cross_entropy_loss as jce
from distributeddeeplearning_tpu_torch.models import bert as tbert
from distributeddeeplearning_tpu_torch.parallel import mesh as tmesh
from distributeddeeplearning_tpu_torch.parallel import sharding as tsharding
from distributeddeeplearning_tpu_torch.train import checkpoint as tckpt
from distributeddeeplearning_tpu_torch.workloads import bert as tw

jwork = importlib.import_module("distributeddeeplearning_tpu.workloads.bert")

torch.set_num_threads(2)  # the suite runs six workers on eight cores
for _fn in (torch.exp, torch.log, torch.tanh, torch.erf, torch.rsqrt):
    _fn(torch.ones(1 << 16))  # first MKL calls in a worker (ROADMAP C, traps)

TINY = _torch_dp.MP_BERT
EXPERTS = 4
SEQ, ROWS, STEPS = 16, 8, 3
CASES = [("tensor2-fsdp2", {"tensor": 2, "fsdp": 2}, 0), ("fsdp4", {"fsdp": 4}, 0),
         ("data2-tensor2", {"data": 2, "tensor": 2}, 0),
         ("data2-expert2", {"data": 2, "expert": 2}, EXPERTS),
         ("expert2-fsdp2", {"expert": 2, "fsdp": 2}, EXPERTS),
         ("expert2-tensor2", {"expert": 2, "tensor": 2}, EXPERTS)]
NAMES = [c[0] for c in CASES]
MOE_NAMES = [c[0] for c in CASES if c[2]]
GEOMETRIES = [("tensor2-fsdp2", {"tensor": 2, "fsdp": 2}),
              ("experts", {"num_experts": EXPERTS, "expert": 2})]
ONE_LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5  # of a leaf's scale (module docstring)
GRAD_FLOOR = 1e-6  # of the tree's largest |g|
NORM_RTOL = 1e-6
ONE_PARAM_ATOL = 5e-5
REF_LOSS_RTOL = 1e-5
REF_PARAM_ATOL = 1e-5
C8_CAPACITY = 1.0


def _cfg(experts, module=tbert, **kw):
    return dataclasses.replace(module.BERT_BASE, **TINY, num_experts=experts, **kw)


def _params_np(experts):
    """Seeded numpy weights in the reference's tree (Normal(0, 0.02),
    LayerNorm scales about 1, a router of std 1 so tokens spread)."""
    rng = np.random.default_rng(0)

    def draw(t, name):
        if isinstance(t, dict):
            return {k: draw(v, f"{name}/{k}") for k, v in t.items()}
        x = rng.standard_normal(tuple(t.shape)) * (1.0 if "router" in name else 0.02)
        return (1.0 + x if name.endswith("scale") else x).astype(np.float32)

    return draw(tbert.init_params(_cfg(experts), device="cpu"), "")


def _batches():
    return list(jsynth.SyntheticTextDataset(
        length=ROWS * STEPS, seq_len=SEQ, vocab_size=TINY["vocab_size"],
        num_classes=TINY["num_classes"], seed=1).batches(ROWS))


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _jnet(experts, **kw):
    return jbert.BertEncoder(config=_cfg(experts, jbert, **kw), dtype=jnp.float32)


def _jloss(net):
    def loss(params, batch):
        logits, st = net.apply({"params": params}, jnp.asarray(batch["input"]),
                               train=True, mutable=[jmoe.MOE_LOSS_COLLECTION],
                               attention_mask=jnp.asarray(batch["attention_mask"]))
        aux = sum((jnp.sum(v) for v in jax.tree.leaves(st)), jnp.zeros(()))
        return jce(logits, jnp.asarray(batch["label"])) + 0.01 * aux
    return loss


def _ref_rules(sizes, experts):
    rules = (jsharding.RULES_TP if sizes.get("tensor", 1) > 1
             else jsharding.RULES_FSDP if sizes.get("fsdp", 1) > 1 else jsharding.RULES_DP)
    return list(rules) + (list(jsharding.RULES_EP) if experts else [])


def _ref_axes(net):
    return jsharding.model_logical_axes(net, jax.random.key(0),
                                        np.zeros((2, SEQ), np.int32), train=False)


def _jstate(net, params, tx):
    return jstate.TrainState(step=jnp.zeros((), jnp.int32),
                             params=jax.tree.map(jnp.asarray, params),
                             opt_state=tx.init(jax.tree.map(jnp.asarray, params)),
                             batch_stats={}, apply_fn=net.apply, tx=tx)


def _reference(experts, sizes):
    """The JAX package's first-step gradient and norm, then its sharded
    step on ``sizes`` (8 virtual devices) with the clip at half that norm."""
    net, params, batches = _jnet(experts), _params_np(experts), _batches()
    grads = jax.grad(_jloss(net))(jax.tree.map(jnp.asarray, params), batches[0])
    norm = float(optax.global_norm(grads))
    mesh = jcreate_mesh(JMeshSpec(**sizes))
    tx = jstate.adamw(optax.constant_schedule(_torch_dp.MP_LR), weight_decay=0.01,
                      grad_clip_norm=norm / 2)
    step = jstep.build_train_step(mesh, _jstate(net, params, tx),
                                  compute_dtype=jnp.float32,
                                  rules=_ref_rules(sizes, experts),
                                  logical_axes=_ref_axes(net))
    state, losses, params1 = _jstate(net, params, tx), [], None
    for batch in batches:
        state, m = step(state, jshard_batch(mesh, batch))
        losses.append(float(m["loss"]))
        if params1 is None:
            params1 = _named(jax.device_get(state.params))
    return {"grads": _named(jax.device_get(grads)), "norm": norm, "clip": norm / 2,
            "losses": losses, "params1": params1}


@pytest.fixture(scope="module")
def reference():
    return {0: _reference(0, {"fsdp": 2, "tensor": 2}),
            EXPERTS: _reference(EXPERTS, {"expert": 2, "fsdp": 2})}


@pytest.fixture(scope="module")
def one_process(reference, tmp_path_factory):
    directory = tmp_path_factory.mktemp("bert-one")
    return {e: _torch_dp.bert_mp_fit(None, _params_np(e), _batches(),
                                     reference[e]["clip"], e,
                                     str(directory / "ckpt") if e == 0 else None)
            for e in (0, EXPERTS)}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    directory = tmp_path_factory.mktemp("bert-ranks")
    clips = {False: reference[0]["clip"], True: reference[EXPERTS]["clip"]}
    out = _torch_dp.run_ranks(_torch_dp.bert_model_parallel, 4, _params_np(0),
                              _params_np(EXPERTS), _batches(), clips, CASES,
                              str(directory), GEOMETRIES, C8_CAPACITY, timeout=240)
    return {"ranks": out, "dir": directory}


def _experts(name):
    return dict((c[0], c[2]) for c in CASES)[name]


def _rel(a, b):
    return abs(a - b) / abs(b)


def _grad_gaps(got, want):
    """Each leaf's largest |got - want| over its scale (module docstring)."""
    top = max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(got[k] - w).max() / max(np.abs(w).max(), GRAD_FLOOR * top))
            for k, w in want.items()}


# -- host-only: the logical axes, the shardings, the refusals ----------------------

@pytest.mark.parametrize("experts", [0, EXPERTS], ids=["bert", "moe-bert"])
def test_logical_axes_equal_the_references(experts):
    """Leaf by leaf, ``logical_axes`` is the reference's ``model_logical_axes``
    of the flax module (an unannotated leaf ``()``)."""
    want = {k: tuple(v) for k, v in _named(_ref_axes(_jnet(experts))).items()}
    got = {k: tuple(v) for k, v in _spec_items(tbert.logical_axes(_cfg(experts))).items()}
    assert got == want


def _spec_items(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_items(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _tmesh(sizes, world=8):
    shape = dict(zip(tmesh.AXIS_ORDER, tmesh.MeshSpec(**sizes).sizes(world)))
    return tmesh.Mesh(shape=shape, size=world)


SHARDING_CASES = [
    (rules, sizes, experts)
    for experts in (0, EXPERTS)
    for rules, sizes in (("RULES_DP", {"data": None}), ("RULES_FSDP", {"fsdp": 4}),
                         ("RULES_FSDP", {"fsdp": 8}),
                         ("RULES_TP", {"fsdp": 2, "tensor": 2}),
                         ("RULES_TP", {"tensor": 8}),
                         ("RULES_FSDP", {"expert": 2, "fsdp": 2}),
                         ("RULES_TP", {"expert": 2, "tensor": 2}),
                         ("RULES_DP", {"data": 2, "expert": 4}))
]


@pytest.mark.parametrize("rules,sizes,experts", SHARDING_CASES, ids=[
    f"{r}{'+EP' if e else ''}-" + "-".join(f"{k}{v}" for k, v in s.items())
    for r, s, e in SHARDING_CASES])
def test_param_shardings_equal_the_references(rules, sizes, experts):
    """Every rule set the reference's BERT workload picks (plus
    ``RULES_EP`` for MoE BERT), on meshes of 8 devices: the port's
    ``param_shardings`` of BERT's logical axes are the reference's leaf by
    leaf (the divisibility drop at fsdp 8 and tensor 8 included), and a
    ``ParamLayout`` of them cuts each leaf to its local shape."""
    net = _jnet(experts)
    params = _params_np(experts)
    rule_set = list(getattr(jsharding, rules)) + (list(jsharding.RULES_EP) if experts
                                                  else [])
    port_rules = list(getattr(tsharding, rules)) + (list(tsharding.RULES_EP) if experts
                                                    else [])
    assert port_rules == rule_set
    want = jsharding.param_shardings(jcreate_mesh(JMeshSpec(**sizes)), params, rule_set,
                                     _ref_axes(net))
    mesh = _tmesh(sizes)
    got = tsharding.param_shardings(mesh, params, port_rules,
                                    tbert.logical_axes(_cfg(experts)))
    want = {k: tuple(v.spec) for k, v in _spec_items(want).items()}
    got = {k: tuple(v) for k, v in _spec_items(got).items()}
    assert got == want
    layout = tsharding.ParamLayout(mesh, got)
    local = layout.shard(tbert.params_from_numpy(params, device="cpu"))
    for k, t in _spec_items(local).items():
        assert tuple(t.shape) == tsharding.local_shape(params_shape(params, k), got[k],
                                                       mesh), k


def params_shape(params, name):
    node = params
    for key in name.split("/"):
        node = node[key]
    return tuple(node.shape)


@pytest.mark.parametrize("sizes,rules,experts,match", [
    # the hidden width over tensor (embeddings, LayerNorm-fed kernels'
    # rows): not Megatron's
    ({"tensor": 2}, [("embed", "tensor")], 0, "Megatron"),
    # heads over fsdp, kv over tensor: a split of the head dim
    ({"fsdp": 2, "tensor": 2}, [("heads", "fsdp"), ("kv", "tensor")], 0, "Megatron"),
    # only the MLP column-parallel: not every Megatron split
    ({"tensor": 2}, [("mlp", "tensor")], 0, "every layer"),
    # the expert weights and the router's columns over expert
    ({"expert": 2}, [("expert", "expert")], EXPERTS, None),
    ({"fsdp": 2, "tensor": 2}, "RULES_TP", 0, None),
    ({"expert": 2, "tensor": 2}, "RULES_TP+EP", EXPERTS, None),
], ids=["embed-over-tensor", "kv-over-tensor", "mlp-alone", "ep",
        "tp", "tp-ep"])
def test_the_forward_reads_its_splits_from_the_layout(sizes, rules, experts, match):
    """The forward runs the layouts of the reference's rules and refuses
    one whose splits it cannot run, instead of gathering what the step
    keeps whole."""
    if isinstance(rules, str):
        rules = list(tsharding.RULES_TP) + (list(tsharding.RULES_EP) if experts else [])
    mesh = _tmesh(sizes, world=4)
    layout = tsharding.ParamLayout.from_rules(
        mesh, tbert.params_from_numpy(_params_np(experts), device="cpu"), rules,
        tbert.logical_axes(_cfg(experts)))
    if match is None:
        assert layout.sharded
        with pytest.raises(ValueError, match="process group"):
            tbert._shards(layout)  # builds as far as the axes' groups
        return
    with pytest.raises(ValueError, match=match):
        tbert._shards(layout)


@pytest.mark.parametrize("kw,exc,match", [
    ({"expert": 2}, ValueError, "num_experts"),
    ({"num_experts": 3, "expert": 2}, ValueError, "not divisible by expert axis"),
    ({"seq": 2}, NotImplementedError, "A7d"),
    ({"attention": "ring"}, NotImplementedError, "A7d"),
    ({"sp_block_k": 4}, NotImplementedError, "A7d"),
    ({"num_slices": 2}, ValueError, "data axis 1 not divisible by num_slices 2"),
])
def test_the_workload_checks_its_axes_as_the_reference(kw, exc, match):
    """Before any process group: the reference's expert checks in its
    words (the JAX workload raises them too), and what the port still
    refuses names its ROADMAP item."""
    base = dict(epochs=1, steps_per_epoch=1, batch_size=1, seq_len=16, device="cpu")
    with pytest.raises(exc, match=match):
        tw.main(**{**base, **kw})
    if "num_slices" in kw:  # the reference's words on one device
        with pytest.raises(ValueError, match=match):
            jcreate_mesh(JMeshSpec(), devices=jax.devices()[:1], num_slices=2)
    elif exc is ValueError:
        with pytest.raises(ValueError, match=match):
            jwork.main(**{k: v for k, v in {**base, **kw}.items() if k != "device"})


# -- C8: MoE routing under the implicit data-parallel step -----------------------------

def _kept(gate_idx, experts, cap):
    """The reference's slot-by-slot assignment (ref ``models/moe.py:76-93``)
    of a global batch's choices: the tokens each expert keeps."""
    counts = np.zeros(experts, np.int64)
    for j in range(gate_idx.shape[1]):
        onehot = np.eye(experts, dtype=np.int64)[gate_idx[:, j]]
        before = np.cumsum(onehot, 0) - onehot
        pos = (before * onehot).sum(-1) + (counts[None] * onehot).sum(-1)
        counts = counts + (onehot * (pos < cap)[:, None]).sum(0)
    return counts


@pytest.fixture(scope="module")
def c8_reference():
    """The reference's implicit step (``MeshSpec()``: data over the 8
    virtual devices) of TINY MoE BERT at ``C8_CAPACITY``: per-step losses;
    for the first step the load-balance term, the expert choices of the
    global batch (top-2 of its router's probabilities) and the kept counts
    at the global capacity."""
    net = _jnet(EXPERTS, moe_capacity_factor=C8_CAPACITY)
    params, batches = _params_np(EXPERTS), _batches()
    first = batches[0]
    _, st = net.apply({"params": jax.tree.map(jnp.asarray, params)},
                      jnp.asarray(first["input"]), train=True,
                      mutable=[jmoe.MOE_LOSS_COLLECTION, "intermediates"],
                      capture_intermediates=True,
                      attention_mask=jnp.asarray(first["attention_mask"]))
    logits = st["intermediates"]["layer1"]["moe_mlp"]["router"]["__call__"][0]
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 2)
    gate_idx = np.asarray(gate_idx)
    cap = max(int(np.ceil(2 * gate_idx.shape[0] / EXPERTS * C8_CAPACITY)), 1)
    aux = float(jax.tree.leaves(st[jmoe.MOE_LOSS_COLLECTION])[0])
    mesh = jcreate_mesh(JMeshSpec())
    tx = jstate.adamw(optax.constant_schedule(_torch_dp.MP_LR), weight_decay=0.01)
    state = _jstate(net, params, tx)
    step = jstep.build_train_step(mesh, state, compute_dtype=jnp.float32)
    losses = []
    for batch in batches:
        state, m = step(state, jshard_batch(mesh, batch))
        losses.append(float(m["loss"]))
    return {"losses": losses, "aux": aux, "gate_idx": gate_idx,
            "kept": _kept(gate_idx, EXPERTS, cap), "cap": cap}


def test_moe_routing_under_data_parallelism_is_the_global_batchs(c8_reference):
    """C8: two data-parallel ranks route TINY MoE BERT's global batch as the
    reference's implicit step does: at a capacity that drops tokens (the
    reference keeps fewer than all 2 x 128 token-slots), each rank's
    choices are its rows of the global choices, its kept counts the global
    ones, its load-balance term and its losses the reference's."""
    ref = c8_reference
    assert ref["kept"].sum() < 2 * ROWS * SEQ  # the capacity binds
    out = _torch_dp.run_ranks(_torch_dp.moe_dp_routing, 2, _params_np(EXPERTS),
                              _batches(), C8_CAPACITY, timeout=120)
    rows = ROWS * SEQ // 2
    for rank, got in enumerate(out):
        (gate_idx, kept), = got["routes"]
        np.testing.assert_array_equal(gate_idx, ref["gate_idx"][rank * rows:(rank + 1) * rows])
        np.testing.assert_array_equal(kept, ref["kept"])
        assert _rel(got["aux"][0], ref["aux"]) <= REF_LOSS_RTOL
        for g, w in zip(got["losses"], ref["losses"]):
            assert _rel(g, w) <= REF_LOSS_RTOL, (got["losses"], ref["losses"])


def test_moe_routing_on_a_permuted_multi_slice_mesh_is_the_global_batchs(
        ranks, c8_reference):
    """C8 on ``data=4`` over two slices, the nodes reported 0, 1, 0, 1: the
    mesh puts ranks 0..3 on data shards 0, 2, 1, 3 (not their ranks'
    order), and each rank's tokens still queue after those of the shards
    before it: its choices are its shard's rows of the reference's global
    choices, its kept counts, load-balance term and losses the
    reference's (its implicit step on its own multi-slice mesh gives the
    same losses)."""
    ref = c8_reference
    mesh = jcreate_mesh(JMeshSpec(), num_slices=2)
    state = _jstate(_jnet(EXPERTS, moe_capacity_factor=C8_CAPACITY), _params_np(EXPERTS),
                    jstate.adamw(optax.constant_schedule(_torch_dp.MP_LR),
                                 weight_decay=0.01))
    step = jstep.build_train_step(mesh, state, compute_dtype=jnp.float32)
    losses = []
    for batch in _batches():
        state, m = step(state, jshard_batch(mesh, batch))
        losses.append(float(m["loss"]))
    rows = ROWS * SEQ // 4
    for rank, got in enumerate(ranks["ranks"]):
        case = got["slices"]
        shard = (0, 2, 1, 3)[rank]
        assert case["shard"] == shard
        (gate_idx, kept), = case["routes"]
        np.testing.assert_array_equal(gate_idx, ref["gate_idx"][shard * rows:(shard + 1) * rows])
        np.testing.assert_array_equal(kept, ref["kept"])
        assert _rel(case["aux"][0], ref["aux"]) <= REF_LOSS_RTOL
        for g, w, v in zip(case["losses"], ref["losses"], losses):
            assert _rel(g, w) <= REF_LOSS_RTOL and _rel(g, v) <= REF_LOSS_RTOL


def test_the_workload_takes_num_slices(ranks):
    """``workloads.bert.main(tensor=2, num_slices=2)`` on the four ranks:
    two slices split contiguously (no node reported) are the one-slice
    mesh, so the first step's loss is bitwise the same."""
    for got in ranks["ranks"]:
        sl = got["main"]["slices"]
        assert np.isfinite(sl[2]) and sl[2] == sl[1]


# -- four ranks --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_the_reference(ranks, reference, name):
    ref = reference[_experts(name)]
    for got in ranks["ranks"]:
        case = got[name]
        for g, w in zip(case["losses"], ref["losses"]):
            assert _rel(g, w) <= REF_LOSS_RTOL, (case["losses"], ref["losses"])
        gaps = _grad_gaps(case["grads"], ref["grads"])
        assert max(gaps.values()) <= GRAD_TOL, gaps
        assert _rel(case["norms"][0], ref["norm"]) <= NORM_RTOL
        for k, w in ref["params1"].items():
            np.testing.assert_allclose(case["params1"][k], w, rtol=0,
                                       atol=REF_PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_one_process(ranks, one_process, name):
    one = one_process[_experts(name)]
    for got in ranks["ranks"]:
        case = got[name]
        for g, w in zip(case["losses"], one["losses"]):
            assert _rel(g, w) <= ONE_LOSS_RTOL
        gaps = _grad_gaps(case["grads"], one["grads"])
        assert max(gaps.values()) <= GRAD_TOL, gaps
        for g, w in zip(case["norms"], one["norms"]):
            assert _rel(g, w) <= NORM_RTOL, (case["norms"], one["norms"])
        for k, w in one["params"].items():
            np.testing.assert_allclose(case["params"][k], w, rtol=0,
                                       atol=ONE_PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_the_moments_take_the_shard_shape(ranks, one_process, name):
    """Each rank's AdamW moments have its parameter shard's shape, the
    global shape cut by the leaf's spec; an expert rank holds 2 of the 4
    experts' weights."""
    spec, experts = dict((c[0], c[1]) for c in CASES)[name], _experts(name)
    mesh = _tmesh(spec, world=4)
    specs = tsharding.param_shardings(mesh, _params_np(experts),
                                      _torch_dp.bert_rules(mesh.shape, experts),
                                      tbert.logical_axes(_cfg(experts)))
    specs = _spec_items(specs)
    for got in ranks["ranks"]:
        shapes = got[name]["shapes"]
        assert shapes["mu"] == shapes["params"]
        for k, shape in shapes["params"].items():
            assert shape == tsharding.local_shape(
                one_process[experts]["shapes"]["params"][k], specs[k], mesh), k
        if "expert" in spec:
            assert shapes["params"]["layer1/moe_mlp/w_in"][0] == EXPERTS // 2
            assert shapes["params"]["layer1/moe_mlp/w_out"][0] == EXPERTS // 2


@pytest.mark.parametrize("name", NAMES)
def test_replicated_leaves_are_bitwise_equal_across_a_shards_ranks(ranks, name):
    by_shard = {}
    for got in ranks["ranks"]:
        by_shard.setdefault(got[name]["shard"], []).append(got[name]["replicated"])
    assert any(len(v) > 1 for v in by_shard.values()) or name == "fsdp4"
    for steps in by_shard.values():
        for other in steps[1:]:
            assert other == steps[0]


@pytest.mark.parametrize("name", MOE_NAMES)
def test_every_rank_routes_the_global_batch(ranks, one_process, name):
    """Each rank's choices are one process's on its data shard's rows, its
    kept counts and load-balance term the global batch's."""
    one = one_process[EXPERTS]
    (want_idx, want_kept), = one["routes"]
    shards = 2 if "data2" in name or "fsdp2" in name else 1
    rows = want_idx.shape[0] // shards
    for got in ranks["ranks"]:
        case = got[name]
        (gate_idx, kept), = case["routes"]
        i = case["shard"]
        np.testing.assert_array_equal(gate_idx, want_idx[i * rows:(i + 1) * rows])
        np.testing.assert_array_equal(kept, want_kept)
        assert _rel(case["aux"][0], one["aux"][0]) <= ONE_LOSS_RTOL


def test_a_sharded_generation_holds_the_one_process_layout(ranks, one_process,
                                                             tmp_path_factory):
    """The ``tensor=2 x fsdp=2`` fit's generation holds the one-process
    fit's arrays key for key, plus the mesh record; it restores bitwise and
    resumes bitwise on every rank."""
    sharded = ranks["dir"] / "steps" / NAMES[0] / str(STEPS)
    ones = [p for p in tmp_path_factory.getbasetemp().glob("bert-one*/ckpt")][0] / str(STEPS)
    for item in ("params", "state"):
        got, want = tckpt.read_item(sharded / item), tckpt.read_item(ones / item)
        assert set(got) - set(want) == ({"['mesh']"} if item == "state" else set())
        for k, w in want.items():
            assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
            if w.is_floating_point():
                np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                           atol=ONE_PARAM_ATOL, err_msg=k)
            else:
                assert torch.equal(got[k], w), k
    assert tckpt.read_item(sharded / "state")["['mesh']"].tolist() == [1, 1, 2, 1, 1, 2]
    for got in ranks["ranks"]:
        assert got[NAMES[0]]["restored_step"] == STEPS
        assert got[NAMES[0]]["restored_bitwise"] and got[NAMES[0]]["resumed_bitwise"]


def _main_first_loss(experts, shards):
    """The JAX package's loss (load-balance term in) of the workload's
    initial weights (the port's draws) on its first global batch: the
    shards' streams seeded ``seed + 1000 d``."""
    cfg = _torch_dp.BERT_MAIN
    net = _jnet(experts)
    params = tbert.init_params(_cfg(experts), torch.Generator().manual_seed(cfg["seed"]),
                               device="cpu")
    params = jax.tree.map(jnp.asarray, _torch_numpy(params))
    parts = [next(tw._batches(cfg["batch_size"], cfg["seq_len"], cfg["vocab_size"],
                              cfg["num_classes"], cfg["seed"] + 1000 * d,
                              cfg["train_examples"], is_training=True))
             for d in range(shards)]
    batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return float(_jloss(net)(params, batch))


def _torch_numpy(tree):
    if isinstance(tree, dict):
        return {k: _torch_numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("name,experts", [("tensor2-fsdp2", 0), ("experts", EXPERTS)])
def test_the_workload_trains_over_model_axes(ranks, name, experts):
    """``workloads.bert.main`` at ``fsdp=2, tensor=2`` and at ``num_experts=4,
    expert=2`` on the four ranks (2 data shards each): the first step's loss
    is the JAX package's on the same weights and global batch, the layout
    splits the reference's way, and a checkpointed epoch resumes into the
    next."""
    want = _main_first_loss(experts, 2)
    runs = [got["main"][name] for got in ranks["ranks"]]
    for run in runs:
        assert _rel(run["first_loss"], want) <= REF_LOSS_RTOL
        assert run["step"] == 2 and run["resumed_step"] == 4
        assert np.isfinite(run["loss"]) and np.isfinite(run["eval"])
        assert run["loss"] == runs[0]["loss"] and run["eval"] == runs[0]["eval"]
    layout = runs[0]["layout"]
    if experts:
        assert layout["layer1/moe_mlp/w_in"][0] == "expert"
        assert layout["layer1/moe_mlp/router/kernel"] == (None, "expert")
    else:
        assert layout["layer0/attention/query/kernel"] == ("fsdp", "tensor", None)
        assert layout["layer0/mlp_out/kernel"] == ("tensor", "fsdp")
