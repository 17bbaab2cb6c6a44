"""Tensor-parallel and FSDP training of the port's LM against the JAX
package's, on the CPU.

Four gloo ranks (``tests/_torch_dp.run_ranks``, one module-scoped spawn)
train the reference's TINY LM (``tests/test_transformer_workload.py``: 4
layers, d 32, 2 heads, ff 64, vocabulary 64, seq 16) through
``build_train_step(mesh=..., rules=..., logical_axes=...)`` on three
meshes, ``tensor=2 x fsdp=2``, ``fsdp=4`` and ``data=2 x tensor=2``, for 3
steps over the same global batches of 8 rows, with AdamW's clip set to
half the first step's unclipped norm.  The weights come from a numpy seed
(``params_from_numpy``); the ranks import no jax.  The same spawn runs
``workloads.transformer.main`` at the three geometries.

Held against:

- the JAX package's ``build_train_step`` with the reference workload's
  rules and logical axes on its 8 virtual CPU devices (``fsdp=2 x
  tensor=2``, data 2): losses within ``REF_LOSS_RTOL``, the first step's
  global gradient (``jax.grad`` of the same loss) within ``REF_GRAD_TOL``
  of each leaf's largest |g|, the clip norm within ``NORM_RTOL`` and the
  clip-engaged first update within ``REF_PARAM_ATOL``;
- the port's one-process step in this process (``ONE_*`` tolerances);
- within the port: each rank's AdamW moments take its shard's shape
  (ZeRO), the replicated leaves (``pos``, ``ln1``, ``ln2``) are bitwise
  equal across the tensor ranks of a data shard after every step, a clip
  norm that all-reduced every leaf over the world would miss by far more
  than ``NORM_RTOL``, a sharded generation holds the one-process
  generation's arrays and resumes bitwise, and a restore on another mesh
  raises naming A5.4.

Tolerances (f32): the sharded step sums the same products in another
order (partial sums over the tensor group, gradients reduce-scattered
over fsdp, the loss over data shards); measured on this geometry the
losses agree to 2.3e-7 relative and the gradients to 4.9e-7 of a leaf's
largest |g|, so ``ONE_LOSS_RTOL`` = 1e-5 and ``ONE_GRAD_TOL`` = 1e-5 keep
a decade and a half of margin; the clip norm to 1e-6 relative.  Against
JAX (XLA's CPU kernels, its dense attention against the port's plain flash
version) the one-process port measures 1.1e-7 on the losses, 5.5e-7 of a
leaf's largest |g|, 1.8e-7 on the norm and 5.0e-7 absolute on the first
update, so the same bounds hold.

Host-only tests hold ``logical_to_spec`` and ``param_shardings`` to the
reference's on its own cases (ref ``tests/test_sharding.py``) and on the
LM's logical axes, and the builders' refusals of ``pipe`` and ``seq``
(an ``expert`` axis builds).
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dp
from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.parallel import MeshSpec as JMeshSpec
from distributeddeeplearning_tpu.parallel import create_mesh as jcreate_mesh
from distributeddeeplearning_tpu.parallel import shard_batch as jshard_batch
from distributeddeeplearning_tpu.parallel import sharding as jsharding
from distributeddeeplearning_tpu.train import state as jstate
from distributeddeeplearning_tpu.train import step as jstep
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.parallel import mesh as tmesh
from distributeddeeplearning_tpu_torch.parallel import sharding as tsharding
from distributeddeeplearning_tpu_torch.train import checkpoint as tckpt
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep
from distributeddeeplearning_tpu_torch.workloads import transformer as tw

jwork = importlib.import_module("distributeddeeplearning_tpu.workloads.transformer")

torch.set_num_threads(2)  # the suite runs six workers on eight cores

LM = _torch_dp.MP_LM
SEQ, ROWS, STEPS = 16, 8, 3
CASES = [("tensor2-fsdp2", {"tensor": 2, "fsdp": 2}), ("fsdp4", {"fsdp": 4}),
         ("data2-tensor2", {"data": 2, "tensor": 2})]
NAMES = [c[0] for c in CASES]
GEOMETRIES = [("tensor2-fsdp2", {"tensor": 2, "fsdp": 2}), ("fsdp4", {"fsdp": 4}),
              ("data2-tensor2", {"tensor": 2})]
ONE_LOSS_RTOL = 1e-5
ONE_GRAD_TOL = 1e-5  # of a leaf's largest |g|
NORM_RTOL = 1e-6
ONE_PARAM_ATOL = 1e-5  # three AdamW steps of lr 1e-2 over 1e-6 gradient noise
REF_LOSS_RTOL = 1e-5
REF_GRAD_TOL = 1e-5
REF_PARAM_ATOL = 1e-5

# the reference workload's rules and logical axes (ref
# workloads/transformer.py:334-348), written out: its main() builds them
# inline
REF_LOGICAL_AXES = {
    "embed": ("vocab", None), "pos": None, "head": (None, "vocab"),
    "blocks": {"qkv": ("layers", None, "width"), "proj": ("layers", "width", None),
               "w_in": ("layers", None, "width"), "w_out": ("layers", "width", None),
               "ln1": ("layers", None), "ln2": ("layers", None)},
}


def _ref_rules(tensor):
    return [("layers", "pipe"), ("vocab", "fsdp"),
            ("width", "tensor" if tensor > 1 else "fsdp")]


def _params_np():
    rng = np.random.default_rng(0)
    n, d, f, v = LM["num_layers"], LM["d_model"], LM["d_ff"], LM["vocab_size"]

    def nrm(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    return {"embed": nrm(v, d), "pos": nrm(SEQ, d), "head": nrm(d, v),
            "blocks": {"qkv": nrm(n, d, 3 * d), "proj": nrm(n, d, d),
                       "w_in": nrm(n, d, f), "w_out": nrm(n, f, d),
                       "ln1": 1.0 + nrm(n, d), "ln2": 1.0 + nrm(n, d)}}


def _batches():
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, LM["vocab_size"], (ROWS, SEQ)).astype(np.int32)
        out.append({"input": t, "label": t})
    return out


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _jax_loss(params, tokens):
    logits = jpt.forward(params, tokens, num_heads=LM["num_heads"])
    return jpt.next_token_loss(logits.astype(jnp.float32), tokens)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's first-step gradient and norm (``jax.grad`` of the
    global batch's loss), then its sharded step (``fsdp=2 x tensor=2`` on
    the 8 virtual devices) with the clip at half that norm."""
    params_np, batches = _params_np(), _batches()
    params = jax.tree.map(jnp.asarray, params_np)
    grads = jax.grad(_jax_loss)(params, jnp.asarray(batches[0]["input"]))
    norm = float(optax.global_norm(grads))
    clip = norm / 2
    mesh = jcreate_mesh(JMeshSpec(fsdp=2, tensor=2))
    tx = jstate.adamw(optax.constant_schedule(_torch_dp.MP_LR), weight_decay=0.01,
                      grad_clip_norm=clip)

    def apply_fn(variables, tokens, train=True, mutable=None, rngs=None):
        out = jpt.forward(variables["params"], tokens,
                          num_heads=LM["num_heads"]).astype(jnp.float32)
        return (out, {}) if mutable is not None else out

    def loss_fn(logits, labels, *, label_smoothing=0.0):
        return jpt.next_token_loss(logits, labels)

    def metrics_fn(logits, tokens, loss):
        return {"loss": loss}

    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), batch_stats={},
                              apply_fn=apply_fn, tx=tx)
    step = jstep.build_train_step(mesh, state, compute_dtype=jnp.float32,
                                  rules=_ref_rules(2), logical_axes=REF_LOGICAL_AXES,
                                  loss_fn=loss_fn, metrics_fn=metrics_fn)
    losses, params1 = [], None
    for batch in batches:
        state, m = step(state, jshard_batch(mesh, batch))
        losses.append(float(m["loss"]))
        if params1 is None:
            params1 = _named(jax.device_get(state.params))
    return {"grads": _named(jax.device_get(grads)), "norm": norm, "clip": clip,
            "losses": losses, "params1": params1}


@pytest.fixture(scope="module")
def one_process(reference, tmp_path_factory):
    directory = tmp_path_factory.mktemp("one")
    return _torch_dp.mp_fit(None, _params_np(), _batches(), reference["clip"],
                            "flash", str(directory / "ckpt"))


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    directory = tmp_path_factory.mktemp("ranks")
    out = _torch_dp.run_ranks(_torch_dp.model_parallel_all, 4, _params_np(), _batches(),
                              reference["clip"], "flash", CASES, str(directory),
                              GEOMETRIES, timeout=240)
    return {"ranks": out, "dir": directory}


def _rel(a, b):
    return abs(a - b) / abs(b)


def _leaf_gap(got, want):
    """Each leaf's largest |got - want| over its largest |want|."""
    return {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
            for k in want}


# -- host-only: the rules -------------------------------------------------------

RULE_CASES = [
    (("embed", "mlp"), "RULES_FSDP"),
    (("embed", "heads", "kv"), "RULES_TP"),
    ((None, "nonexistent"), "RULES_TP"),
    (("expert", "embed", "mlp"), "RULES_EP"),
    (("mlp", "heads"), "RULES_DP"),
    (("heads", "mlp", "kv", "conv_out"), "RULES_FSDP"),
]


@pytest.mark.parametrize("axes,rules", RULE_CASES,
                         ids=lambda x: x if isinstance(x, str) else "-".join(map(str, x)))
def test_logical_to_spec_equals_the_reference(axes, rules):
    assert getattr(tsharding, rules) == getattr(jsharding, rules)
    want = tuple(jsharding.logical_to_spec(axes, getattr(jsharding, rules)))
    assert tsharding.logical_to_spec(axes, getattr(tsharding, rules)) == want


def _jmesh(sizes):
    return jcreate_mesh(JMeshSpec(**sizes))


def _tmesh(sizes, world=8):
    shape = dict(zip(tmesh.AXIS_ORDER, tmesh.MeshSpec(**sizes).sizes(world)))
    return tmesh.Mesh(shape=shape, size=world)


def _lm_shapes(vocab, ff):
    return {"embed": np.zeros((vocab, 32)), "pos": np.zeros((SEQ, 32)),
            "head": np.zeros((32, vocab)),
            "blocks": {"qkv": np.zeros((4, 32, 96)), "proj": np.zeros((4, 32, 32)),
                       "w_in": np.zeros((4, 32, ff)), "w_out": np.zeros((4, ff, 32)),
                       "ln1": np.zeros((4, 32)), "ln2": np.zeros((4, 32))}}


MESHES = [{"fsdp": 2, "tensor": 2}, {"fsdp": 4}, {"data": 4, "tensor": 2},
          {"fsdp": 8}, {"tensor": 8}, {"data": None}]


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "-".join(
    f"{k}{v}" for k, v in s.items()))
def test_param_shardings_of_the_lm_equal_the_reference(sizes):
    """The LM's logical axes under the workload's rules, and the divisibility
    drop on a vocabulary (63) and ff (60) that 8 ranks do not divide."""
    assert tpt.LOGICAL_AXES == REF_LOGICAL_AXES
    tensor = sizes.get("tensor", 1)
    assert tpt.train_rules(tensor) == _ref_rules(tensor)
    for vocab, ff in ((64, 64), (63, 60)):
        params = _lm_shapes(vocab, ff)
        want = jsharding.param_shardings(_jmesh(sizes), params, _ref_rules(tensor),
                                         REF_LOGICAL_AXES)
        got = tsharding.param_shardings(_tmesh(sizes), params, tpt.train_rules(tensor),
                                        tpt.LOGICAL_AXES)
        want = {k: tuple(v.spec) for k, v in _spec_items(want).items()}
        assert dict(_spec_leaves(got)) == want


def _spec_items(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_items(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _spec_leaves(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tuple(tree))]


ALL_FSDP = {"embed": 0, "head": 1, "qkv": 1, "proj": 0, "w_in": 1, "w_out": 0}


@pytest.mark.parametrize("sizes,rules,vocab_ff,want", [
    ({"fsdp": 8}, None, (64, 64), ALL_FSDP),
    # the divisibility drop: what the layout keeps whole is not gathered
    ({"fsdp": 8}, None, (63, 60), {"qkv": 1, "proj": 0}),
    # a tensor axis the rules leave alone: no Megatron, fsdp gathers only
    ({"fsdp": 2, "tensor": 2}, [("vocab", "fsdp"), ("width", "fsdp")], (64, 64),
     ALL_FSDP),
    # serving's vocab-parallel embed and head, and layers over fsdp
    ({"tensor": 2}, [("vocab", "tensor"), ("width", "tensor")], (64, 64), None),
    ({"fsdp": 2}, [("layers", "fsdp")], (64, 64), None),
], ids=["fsdp", "fsdp-dropped", "tensor-unused", "vocab-over-tensor",
        "layers-over-fsdp"])
def test_the_training_forward_reads_its_splits_from_the_layout(sizes, rules,
                                                               vocab_ff, want):
    """The model gathers exactly the fsdp splits of the state's layout
    (the divisibility drop included) and refuses a layout whose splits it
    cannot run (``want`` None), instead of gathering replicated weights."""
    mesh = _tmesh(sizes)
    rules = tpt.train_rules(sizes.get("tensor", 1)) if rules is None else rules
    layout = tsharding.ParamLayout.from_rules(
        mesh, tpt.params_from_numpy(_lm_shapes(*vocab_ff), device="cpu"), rules,
        tpt.LOGICAL_AXES)
    if want is None:
        with pytest.raises(ValueError, match="Megatron"):
            tpt._train_shards(layout)
        return
    shards = tpt._train_shards(layout)
    assert shards.dims == want and shards.tp is None


def test_param_shardings_without_logical_axes_replicate():
    params = {"a": np.zeros((4, 4)), "b": {"c": np.zeros((3,))}}
    got = tsharding.param_shardings(_tmesh({"fsdp": 8}), params)
    assert got == {"a": (), "b": {"c": ()}}


def _tiny_state():
    params = tpt.params_from_numpy(_params_np(), device="cpu")
    return tstate.TrainState.create(
        params=params, apply_fn=lambda p, t, **_: tpt.forward(p, t, num_heads=2),
        tx=tstate.adamw(tsched.constant_schedule(1e-2)))


@pytest.mark.parametrize("axis,item", [("pipe", "A7"), ("seq", "A7"),
                                       ("expert", None)])
@pytest.mark.parametrize("what", ["build_train_step", "build_eval_step", "Trainer"])
def test_the_unported_axes_are_refused(axis, item, what):
    """A mesh with a pipe or seq axis (``create_mesh`` refuses to build
    one: ``tests/test_torch_parallel.py``) is refused by each builder,
    naming the ROADMAP item; one with an expert axis (``item`` None,
    taken since MoE BERT trains over it) is built by each."""
    mesh = _tmesh({"data": 1, axis: 2}, world=2)

    def build():
        if what == "build_train_step":
            return tstep.build_train_step(_tiny_state(), mesh=mesh)
        if what == "build_eval_step":
            return tstep.build_eval_step(_tiny_state(), mesh=mesh)
        return tloop.Trainer(lambda s, b: (s, {}),
                             config=tloop.TrainerConfig(epochs=1, steps_per_epoch=1),
                             mesh=mesh)

    if item is None:
        assert build() is not None
        return
    with pytest.raises(NotImplementedError, match=item) as err:
        build()
    assert axis in str(err.value)


@pytest.mark.parametrize("kw,match", [
    ({"fsdp": 2, "vocab_size": 65}, "fsdp=2 must divide vocab_size"),
    ({"tensor": 4, "d_model": 30}, "tensor=4 must divide d_model"),
    ({"tensor": 2, "num_heads": 3, "d_model": 36}, "num_heads"),
    ({"fsdp": 2, "comm_overlap": True}, "does not compose"),
    ({"pipe": 2}, "A7"), ({"seq": 2}, "A7"), ({"num_slices": 2}, "A5.3"),
])
def test_the_workload_checks_its_geometry_as_the_reference(kw, match):
    """The reference's divisibility messages, before any process group."""
    base = dict(epochs=1, steps_per_epoch=1, batch_size=2, seq_len=16, vocab_size=64,
                num_layers=1, d_model=32, num_heads=2, d_ff=64, device="cpu",
                compute_dtype="float32")
    exc = ValueError if "must" in match or "num_heads" in match or "compose" in match \
        else NotImplementedError
    with pytest.raises(exc, match=match):
        tw.main(**{**base, **kw})
    if exc is ValueError and "comm_overlap" not in kw:
        with pytest.raises(ValueError, match=match):  # the reference's words
            jwork.main(**{k: v for k, v in {**base, **kw}.items() if k != "device"})


# -- four ranks ---------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_the_reference(ranks, reference, name):
    for got in ranks["ranks"]:
        case = got[name]
        for g, w in zip(case["losses"], reference["losses"]):
            assert _rel(g, w) <= REF_LOSS_RTOL, (case["losses"], reference["losses"])
        gaps = _leaf_gap(case["grads"], reference["grads"])
        assert max(gaps.values()) <= REF_GRAD_TOL, gaps
        assert _rel(case["norms"][0], reference["norm"]) <= NORM_RTOL
        for k, w in reference["params1"].items():
            np.testing.assert_allclose(case["params1"][k], w, rtol=0,
                                       atol=REF_PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_one_process(ranks, one_process, name):
    for got in ranks["ranks"]:
        case = got[name]
        for g, w in zip(case["losses"], one_process["losses"]):
            assert _rel(g, w) <= ONE_LOSS_RTOL
        gaps = _leaf_gap(case["grads"], one_process["grads"])
        assert max(gaps.values()) <= ONE_GRAD_TOL, gaps
        for g, w in zip(case["norms"], one_process["norms"]):
            assert _rel(g, w) <= NORM_RTOL, (case["norms"], one_process["norms"])
        for k, w in one_process["params"].items():
            np.testing.assert_allclose(case["params"][k], w, rtol=0,
                                       atol=ONE_PARAM_ATOL, err_msg=k)
        for m in ("mu", "nu"):
            for k, w in one_process["moments"][m].items():
                np.testing.assert_allclose(case["moments"][m][k], w, rtol=1e-4,
                                           atol=1e-9, err_msg=f"{m} {k}")


@pytest.mark.parametrize("name", NAMES)
def test_the_moments_take_the_shard_shape(ranks, one_process, name):
    """ZeRO's contract (ref ``tests/test_train_step.py``
    ``test_fsdp_opt_state_mirrors_param_sharding``): each rank's ``mu`` and
    ``nu`` have its parameter shard's shape, which is the global shape cut
    by the leaf's spec; at least one leaf is cut."""
    spec = dict(CASES)[name]
    mesh = _tmesh(spec, world=4)
    specs = dict(_spec_leaves(tsharding.param_shardings(
        mesh, _params_np(), tpt.train_rules(mesh.shape["tensor"]), tpt.LOGICAL_AXES)))
    for got in ranks["ranks"]:
        shapes = got[name]["shapes"]
        assert shapes["mu"] == shapes["params"] == shapes["nu"]
        cut = 0
        for k, shape in shapes["params"].items():
            full = one_process["shapes"]["params"][k]
            assert shape == tsharding.local_shape(full, specs[k], mesh)
            cut += shape != full
        assert cut >= 2


@pytest.mark.parametrize("name", NAMES)
def test_replicated_leaves_are_bitwise_equal_across_tensor_ranks(ranks, name):
    by_shard = {}
    for got in ranks["ranks"]:
        by_shard.setdefault(got[name]["shard"], []).append(got[name]["replicated"])
    assert any(len(v) > 1 for v in by_shard.values()) or name == "fsdp4"
    for steps in by_shard.values():
        for other in steps[1:]:
            assert other == steps[0]


@pytest.mark.parametrize("name", NAMES)
def test_a_double_counted_clip_norm_would_be_caught(ranks, one_process, name):
    """The norm of an all-reduce of every leaf's squares over the world
    misses one process's by far more than ``NORM_RTOL``; the port's
    sharded norm does not."""
    for got in ranks["ranks"]:
        case = got[name]
        assert _rel(case["naive_norm"], one_process["norms"][0]) > 100 * NORM_RTOL
        assert _rel(case["norms"][0], one_process["norms"][0]) <= NORM_RTOL


def test_a_sharded_generation_holds_the_one_process_layout(ranks, one_process,
                                                             tmp_path_factory):
    """The ``tensor=2 x fsdp=2`` fit's generation holds the arrays of the
    one-process fit's, key for key, in the reference's layout, plus the
    mesh record; it restores bitwise and resumes bitwise on every rank."""
    step = STEPS
    sharded = ranks["dir"] / "steps" / NAMES[0] / str(step)
    ones = [p for p in (tmp_path_factory.getbasetemp()).glob("one*/ckpt")][0] / str(step)
    for item in ("params", "state"):
        got, want = tckpt.read_item(sharded / item), tckpt.read_item(ones / item)
        extra = set(got) - set(want)
        assert extra == ({"['mesh']"} if item == "state" else set())
        for k, w in want.items():
            assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
            if w.is_floating_point():
                np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                           atol=ONE_PARAM_ATOL, err_msg=k)
            else:
                assert torch.equal(got[k], w), k
    assert tckpt.read_item(sharded / "state")["['mesh']"].tolist() == [1, 1, 2, 1, 1, 2]
    for got in ranks["ranks"]:
        assert got[NAMES[0]]["restored_step"] == step
        assert got[NAMES[0]]["restored_bitwise"] and got[NAMES[0]]["resumed_bitwise"]


def test_a_restore_on_another_mesh_raises(ranks):
    for got in ranks["ranks"]:
        assert got["other_mesh"] is not None and "A5.4" in got["other_mesh"]


def _main_first_loss(shards):
    """The JAX package's loss of the workload's initial weights (the
    port's draws) on its first global batch: ``shards`` streams seeded
    ``seed + shard``."""
    cfg = _torch_dp.MP_MAIN
    params = tpt.init_params(torch.Generator().manual_seed(cfg["seed"]),
                             num_layers=cfg["num_layers"], d_model=cfg["d_model"],
                             num_heads=cfg["num_heads"], d_ff=cfg["d_ff"],
                             vocab_size=cfg["vocab_size"], max_len=cfg["seq_len"],
                             device="cpu")
    params = jax.tree.map(jnp.asarray, tstate.tree_map(lambda t: t.numpy(), params))
    toks = np.concatenate([next(tw._token_batches(cfg["batch_size"], cfg["seq_len"],
                                                  cfg["vocab_size"], cfg["seed"] + s,
                                                  cfg["train_examples"], True))["input"]
                           for s in range(shards)])
    return float(_jax_loss(params, jnp.asarray(toks)))


@pytest.mark.parametrize("name,shards", [("tensor2-fsdp2", 2), ("fsdp4", 4),
                                         ("data2-tensor2", 2)])
def test_the_workload_trains_over_model_axes(ranks, name, shards):
    """``workloads.transformer.main`` at each geometry on the four ranks:
    the first step's loss is the JAX package's on the same weights and
    global batch (the ranks of a data shard read the shard's stream), a
    checkpointed epoch resumes into the next, and the two geometries with
    two data shards train alike."""
    want = _main_first_loss(shards)
    runs = [got["main"][name] for got in ranks["ranks"]]
    for run in runs:
        assert _rel(run["first_loss"], want) <= REF_LOSS_RTOL
        assert run["step"] == 2 and run["resumed_step"] == 4
        assert np.isfinite(run["loss"]) and np.isfinite(run["eval"])
        assert run["loss"] == runs[0]["loss"] and run["eval"] == runs[0]["eval"]
        assert run["layout"] is not None
    if name == "data2-tensor2":
        other = ranks["ranks"][0]["main"]["tensor2-fsdp2"]
        assert _rel(runs[0]["loss"], other["loss"]) <= ONE_LOSS_RTOL
    rows = (ranks["dir"] / f"{name}.jsonl").read_text().splitlines()
    assert len(rows) == 1  # world rank 0 alone writes the epoch's row
