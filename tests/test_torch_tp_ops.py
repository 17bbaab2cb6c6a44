"""The tensor-parallel pieces of the port, module by module, against the
JAX package's on the CPU.

- the partition-rule layout table: the port's rule resolution gives the
  reference's ``spec_for`` for every leaf of the f32 and int8-weight serve
  trees and of both caches, and ``shard_params`` gives each rank the
  contiguous blocks those specs name, except ``qkv``, whose columns a rank
  takes from each of the q, k and v thirds (its heads; the module
  docstring of port ``parallel/sharding.py`` says why);
- K4(d): the plain path of ``decode_attention_dense`` / ``_paged`` and
  ``chunk_attention`` on each rank's heads, concatenated over the ranks,
  against the reference with ``kernel="pallas"`` on a ``tensor=2`` mesh
  (its ``_pallas_tp``: ``shard_map`` of the Pallas kernel, interpreted);
- ``make_flash_attention(mesh)`` over local heads, forward and gradients,
  against the reference's on a ``tensor=2`` mesh;
- int8 ``qdot`` split over K: the row-parallel product over two gloo
  ranks equals the unsplit one bit for bit;
- the refusals, by message: the engines', the spec decoder's and the
  trainer's.

No process group is needed for the layout, attention and refusal tests:
a rank's ``Mesh`` is built by hand.  Tolerances are those of
``tests/test_torch_flash_decode.py`` (2e-6 + 1e-5 relative, for outputs of
order 1) and ``tests/test_torch_dp_train.py``'s flash check; over int8
pools, whose dequantized values reach 12.7 and outputs ~10, the absolute
part scales with the largest |output| (:func:`_close`).  Each rank's
local-head output is also held to the all-heads call's rows for its heads
(heads never mix; on the CPU the plain version's einsum may block fewer
heads otherwise, so within ``_close``; ``chip_smoke.py`` holds the
kernel to them bitwise).
"""

from __future__ import annotations

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp
from distributeddeeplearning_tpu.models.pipelined_transformer import (
    init_params as jinit,
)
from distributeddeeplearning_tpu.parallel import MeshSpec as JMeshSpec
from distributeddeeplearning_tpu.parallel import create_mesh as jcreate_mesh
from distributeddeeplearning_tpu.parallel import sharding as jsharding
from distributeddeeplearning_tpu.quant.calibrate import quantize_params as jquantize
from distributeddeeplearning_tpu.serve import kv_cache as jkv
from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
    params_from_numpy,
)
from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa
from distributeddeeplearning_tpu_torch.ops import flash_decode as tfd
from distributeddeeplearning_tpu_torch.parallel import sharding as tsharding
from distributeddeeplearning_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh
from distributeddeeplearning_tpu_torch.quant.calibrate import quantize_params
from distributeddeeplearning_tpu_torch.serve import kv_cache as tkv
from distributeddeeplearning_tpu_torch.serve.engine import (
    InferenceEngine,
    PagedInferenceEngine,
    tensor_parallel_engine,
)

jfd = importlib.import_module("distributeddeeplearning_tpu.ops.flash_decode")
jfa = importlib.import_module("distributeddeeplearning_tpu.ops.flash_attention")

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

TP = 2
CFG = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, vocab_size=64, max_len=48)
ATOL, RTOL = 2e-6, 1e-5


def _mesh(rank, tp=TP, data=1):
    shape = dict.fromkeys(AXIS_ORDER, 1)
    shape.update(tensor=tp, data=data)
    return Mesh(shape=shape, size=tp * data, rank=rank)


def _jmesh():
    return jcreate_mesh(JMeshSpec(data=1, tensor=TP), devices=jax.devices()[:TP])


@pytest.fixture(scope="module")
def jparams():
    return jinit(jax.random.key(0), **CFG)


def _jax_specs(tree, prefix):
    """``{name: spec tuple}`` of the reference's resolution over ``tree``."""
    specs = jsharding.match_partition_rules(tree, prefix=prefix, mesh=_jmesh())
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {jsharding.leaf_path_name(path, prefix): tuple(spec) for path, spec in flat}


@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_rule_resolution_matches_the_reference(jparams, weights):
    jtree = jparams if weights == "f32" else jquantize(jparams)
    ttree = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    if weights == "int8":
        ttree = quantize_params(ttree)
    want = _jax_specs(jtree, "params")
    got = tsharding.match_partition_rules(ttree, prefix="params", mesh=_mesh(0))
    assert got == want
    assert tsharding.layout_rules_provenance() == jsharding.layout_rules_provenance()
    assert tsharding.LAYOUT_RULES == jsharding.LAYOUT_RULES
    # the row-parallel int8 scales replicate by the divisibility drop
    if weights == "int8":
        assert got["params/blocks/proj/scales"] == ()
        assert got["params/blocks/w_out/scales"] == ()


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_cache_sharding_matches_the_reference(layout, quantized):
    want = jkv.cache_sharding(_jmesh(), quantized=quantized, layout=layout)
    got = tkv.cache_sharding(_mesh(0), quantized=quantized, layout=layout)
    assert got == {k: tuple(v.spec) for k, v in want.items()}
    shape = (3, 2, 8, 4, 8) if layout == "dense" else (9, 2, 4, 4, 8)
    for rank in range(TP):
        cache = (tkv.init_cache(batch_slots=3, num_layers=2, max_seq=8, num_heads=4,
                                head_dim=8, dtype=torch.int8 if quantized else torch.float32,
                                device="cpu", mesh=_mesh(rank))
                 if layout == "dense" else
                 tkv.init_paged_cache(num_pages=8, num_layers=2, page_size=4,
                                      num_heads=4, head_dim=8,
                                      dtype=torch.int8 if quantized else torch.float32,
                                      device="cpu", mesh=_mesh(rank)))
        assert tuple(cache["k"].shape) == shape[:3] + (2, 8)  # the page axis whole
        if quantized:
            assert tuple(cache["k_scale"].shape) == shape[:3] + (2,)


def _block(x, spec, rank):
    """The contiguous block of ``x`` a literal reading of ``spec`` gives
    rank ``rank`` of a ``tensor=TP`` mesh."""
    for dim, entry in enumerate(spec):
        if entry == "tensor":
            per = x.shape[dim] // TP
            x = np.take(x, range(rank * per, (rank + 1) * per), axis=dim)
    return x


@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_shard_params_gives_each_rank_its_blocks(jparams, weights):
    ttree = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    if weights == "int8":
        ttree = quantize_params(ttree)
    full = dict(tsharding.named_leaves(ttree, "params"))
    specs = tsharding.match_partition_rules(ttree, prefix="params", mesh=_mesh(0))
    d, per = CFG["d_model"], CFG["d_model"] // TP
    for rank in range(TP):
        local = dict(tsharding.named_leaves(tsharding.shard_params(ttree, _mesh(rank)),
                                            "params"))
        assert local.keys() == full.keys()
        for name, leaf in full.items():
            x = leaf.numpy()
            if re.search(r"/qkv/|/qkv$", name) and x.shape[-1] == 3 * d:
                # the qkv exception: this rank's heads' columns of each third
                cols = np.concatenate([np.arange(j * d + rank * per, j * d + (rank + 1) * per)
                                       for j in range(3)])
                want = x[..., cols]
                assert not np.array_equal(want, _block(x, specs[name], rank))
            else:
                want = _block(x, specs[name], rank)
            np.testing.assert_array_equal(local[name].numpy(), want, err_msg=name)
            assert local[name].is_contiguous()


# -- K4(d) ----------------------------------------------------------------------

B, S, H, HD = 3, 160, 4, 8
POS = np.array([0, 77, S - 1], np.int32)
PS, NB = 8, 4
POOL = B * NB + 2


def _heads(x, rank, axis):
    per = x.shape[axis] // TP
    return np.take(x, range(rank * per, (rank + 1) * per), axis=axis)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))


def _int8_pool(rng, shape):
    vals = [rng.integers(-127, 128, size=shape, dtype=np.int8) for _ in range(2)]
    scales = [rng.uniform(0.01, 0.1, size=shape[:-1]).astype(np.float32) for _ in range(2)]
    return (*vals, *scales)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_k4d_dense_local_heads_match_the_reference(int8):
    rng = np.random.default_rng(21)
    if int8:
        k, v, ks, vs = _int8_pool(rng, (B, S, H, HD))
    else:
        k, v = (rng.normal(size=(B, S, H, HD)).astype(np.float32) for _ in range(2))
        ks = vs = None
    q3, k_t, v_t = (rng.normal(size=(B, H, HD)).astype(np.float32) for _ in range(3))
    want = np.asarray(jfd.decode_attention_dense(
        *map(_j, (q3, k, v, ks, vs, k_t, v_t, POS)), kernel="pallas", mesh=_jmesh()))
    got = np.concatenate([tfd.decode_attention_dense(
        _t(_heads(q3, r, 1)), *map(_t, _local_pools(k, v, ks, vs, r)),
        _t(_heads(k_t, r, 1)), _t(_heads(v_t, r, 1)), _t(POS), mesh=_mesh(r)).numpy()
        for r in range(TP)], axis=1)
    _close(got, want)
    _close(got, tfd.decode_attention_dense(
        *map(_t, (q3, k, v, ks, vs, k_t, v_t, POS))).numpy())


def _pools(rng, int8):
    if int8:
        k, v, ks, vs = _int8_pool(rng, (POOL, PS, H, HD))
    else:
        k, v = (rng.normal(size=(POOL, PS, H, HD)).astype(np.float32) for _ in range(2))
        ks = vs = None
    tables = (rng.permutation(POOL - 1)[: B * NB] + 1).reshape(B, NB).astype(np.int32)
    return k, v, ks, vs, tables


def _local_pools(k, v, ks, vs, rank):
    return (_heads(k, rank, 2), _heads(v, rank, 2),
            None if ks is None else _heads(ks, rank, 2),
            None if vs is None else _heads(vs, rank, 2))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_k4d_paged_local_heads_match_the_reference(int8):
    rng = np.random.default_rng(22)
    k, v, ks, vs, tables = _pools(rng, int8)
    q3, k_t, v_t = (rng.normal(size=(B, H, HD)).astype(np.float32) for _ in range(3))
    pos = np.array([0, 13, NB * PS - 1], np.int32)
    want = np.asarray(jfd.decode_attention_paged(
        *map(_j, (q3, k, v, ks, vs, k_t, v_t, pos, tables)), page_size=PS,
        kernel="pallas", mesh=_jmesh()))
    got = np.concatenate([tfd.decode_attention_paged(
        _t(_heads(q3, r, 1)), *map(_t, _local_pools(k, v, ks, vs, r)),
        _t(_heads(k_t, r, 1)), _t(_heads(v_t, r, 1)), _t(pos), _t(tables),
        mesh=_mesh(r)).numpy() for r in range(TP)], axis=1)
    _close(got, want)
    _close(got, tfd.decode_attention_paged(
        *map(_t, (q3, k, v, ks, vs, k_t, v_t, pos, tables))).numpy())


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_k4d_chunk_local_heads_match_the_reference(int8):
    rng = np.random.default_rng(23)
    k, v, ks, vs, tables = _pools(rng, int8)
    C = 16
    q_c = rng.normal(size=(C, H, HD)).astype(np.float32)
    posns = (12 + np.arange(C)).astype(np.int32)
    want = np.asarray(jfd.chunk_attention(
        *map(_j, (q_c, k, v, ks, vs, tables[1], posns)), page_size=PS,
        kernel="pallas", mesh=_jmesh()))
    got = np.concatenate([tfd.chunk_attention(
        _t(_heads(q_c, r, 1)), *map(_t, _local_pools(k, v, ks, vs, r)),
        _t(tables[1]), _t(posns), mesh=_mesh(r)).numpy() for r in range(TP)], axis=1)
    _close(got, want)
    _close(got, tfd.chunk_attention(
        *map(_t, (q_c, k, v, ks, vs, tables[1], posns))).numpy())


def test_k4d_refuses_operands_of_other_head_counts():
    rng = np.random.default_rng(24)
    k, v, _, _, tables = _pools(rng, False)
    q3 = rng.normal(size=(B, H // TP, HD)).astype(np.float32)
    with pytest.raises(ValueError, match="local head counts differ"):
        tfd.decode_attention_paged(_t(q3), _t(k), _t(v), None, None, None, None,
                                   _t(np.zeros(B, np.int32)), _t(tables), mesh=_mesh(0))
    # without a tensor axis the same call has nothing to check
    names, specs, out = tfd.attention_partition_specs(
        {"q": _t(q3[:, None]), "k_pages": _t(k), "tables": _t(tables), "k_own": None},
        mesh=_mesh(0))
    assert names == ["q", "k_pages", "tables"]
    assert specs == ((None, None, "tensor"), (None, None, "tensor"), ())
    assert out == (None, None, "tensor")


# -- K1-K3 over local heads -----------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_over_local_heads_matches_the_sharded_reference(causal):
    rng = np.random.default_rng(25)
    q, k, v, w = (rng.normal(size=(2, 32, 4, 16)).astype(np.float32) for _ in range(4))
    fn = jfa.make_flash_attention(mesh=_jmesh(), causal=causal)

    def loss(q, k, v):
        return (fn(q, k, v, None, dtype=jnp.float32) * w).sum()

    jx = [jnp.asarray(x) for x in (q, k, v)]
    want_o = np.asarray(fn(*jx, None, dtype=jnp.float32))
    want_g = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*jx)]
    outs, grads = [], []
    for r in range(TP):
        tfn = tfa.make_flash_attention(mesh=_mesh(r), causal=causal)
        t = [torch.from_numpy(_heads(x, r, 2)).requires_grad_(True) for x in (q, k, v)]
        o = tfn(*t, None, dtype=torch.float32)
        (o * torch.from_numpy(_heads(w, r, 2))).sum().backward()
        outs.append(o.detach().numpy())
        grads.append([x.grad.numpy() for x in t])
    np.testing.assert_allclose(np.concatenate(outs, 2), want_o, atol=ATOL, rtol=RTOL)
    for i in range(3):
        np.testing.assert_allclose(np.concatenate([g[i] for g in grads], 2), want_g[i],
                                   atol=ATOL, rtol=RTOL)


# -- int8 row-parallel product ----------------------------------------------------

def test_row_parallel_qdot_equals_the_unsplit_product():
    rng = np.random.default_rng(26)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    x[:, 40] = 9.0  # the row absmax sits in rank 1's half of K
    w = rng.normal(size=(64, 24)).astype(np.float32)
    ranks = _torch_dp.run_ranks(_torch_dp.row_parallel_qdot, TP, x, w, timeout=120)
    from distributeddeeplearning_tpu_torch.quant.qtensor import qdot, quantize

    want = qdot(torch.from_numpy(x), quantize(torch.from_numpy(w))).numpy()
    for got in ranks:
        np.testing.assert_array_equal(got["split"], want)
        assert got["counts"] == {"all_reduce_max": 1, "all_reduce": 1}
    # a rank's own absmax would quantize on another grid
    assert not np.array_equal(ranks[0]["local_absmax"], want)


# -- refusals -------------------------------------------------------------------

def _tparams(jparams, **over):
    tree = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tree.update(over)
    return tree


ENGINE = dict(num_heads=4, batch_slots=2, max_seq=16, device="cpu")


def test_engines_refuse_what_the_reference_refuses(jparams):
    params = _tparams(jparams)
    with pytest.raises(ValueError, match=r"num_heads 4 not divisible by the mesh's "
                                         r"tensor axis \(3\)"):
        InferenceEngine(params, mesh=_mesh(0, tp=3), **ENGINE)
    with pytest.raises(ValueError, match=r"paged engine meshes must be tensor-only"):
        PagedInferenceEngine(params, mesh=_mesh(0, tp=2, data=2), **ENGINE)
    with pytest.raises(NotImplementedError, match="data_parallel_engine.*A6"):
        InferenceEngine(params, mesh=_mesh(0, tp=1, data=2), **ENGINE)
    with pytest.raises(ValueError, match=r"tp=2 exceeds the 1 processes"):
        tensor_parallel_engine(params, tp=2, **ENGINE)
    with pytest.raises(ValueError, match="tp must be >= 1"):
        tensor_parallel_engine(params, tp=0, **ENGINE)
    engine, mesh = tensor_parallel_engine(params, tp=1, **ENGINE)
    assert mesh is None and engine.tp == 1 and type(engine) is InferenceEngine


def test_engines_refuse_a_megatron_leaf_that_would_replicate(jparams):
    odd = jinit(jax.random.key(0), **dict(CFG, vocab_size=63))
    with pytest.raises(ValueError, match=r"params/embed.*do not split over tensor=2"):
        InferenceEngine(_tparams(odd), mesh=_mesh(0), **ENGINE)


def test_a_tp_engine_keeps_its_slice_and_the_spec_decoder_refuses_it(jparams):
    from distributeddeeplearning_tpu_torch.spec import SpeculativeDecoder

    mesh = _mesh(1)
    engine = InferenceEngine(_tparams(jparams), mesh=mesh, **ENGINE)
    assert engine.tp == 2 and engine.vocab_size == CFG["vocab_size"]
    assert tuple(engine.params["blocks"]["qkv"].shape) == (2, 32, 48)
    assert tuple(engine.params["head"].shape) == (32, 32)
    assert tuple(engine.cache["k"].shape) == (2, 2, 16, 2, 8)
    with pytest.raises(ValueError, match="single-mesh for now"):
        SpeculativeDecoder(engine)


def test_the_trainer_refuses_a_tensor_axis_naming_a5():
    from distributeddeeplearning_tpu_torch.train import loop, step
    from distributeddeeplearning_tpu_torch.train.state import TrainState, sgd_momentum

    state = TrainState.create(params={"w": torch.zeros(2)}, apply_fn=None,
                              tx=sgd_momentum(lambda s: 0.1))
    for build in (step.build_train_step, step.build_eval_step):
        with pytest.raises(NotImplementedError, match="A5.*param_shardings"):
            build(state, mesh=_mesh(0))
    with pytest.raises(NotImplementedError, match="Trainer.*A5"):
        loop.Trainer(lambda s, b: (s, {}), config=loop.TrainerConfig(steps_per_epoch=1),
                     mesh=_mesh(0))
