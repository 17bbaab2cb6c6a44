"""The port's ``parallel`` package against the JAX package's, on the CPU.

- ``MeshSpec.sizes``: the same axis sizes, and the same errors, over a
  grid of specs and device counts (``tests/test_mesh.py``'s rule);
- ``create_mesh`` refuses every axis but ``data``, ``fsdp`` and ``tensor`` above 1,
  naming its ROADMAP item, and ``shard_batch`` gives each rank the rows the
  reference's batch sharding puts on its device;
- ``BucketLayout``: bucket bounds, ``to_buckets`` values (bitwise) and the
  round trip on the trees of ``tests/test_comms.py``, and on a tree whose
  keys were inserted out of order (the layout takes leaves by key);
- ``ring_wire_bytes``: the reference's numbers;
- multi-slice meshes (ref ``tests/test_mesh.py:60-126``): ``_slice_groups``
  groups the ranks by their reported node as the reference groups devices
  by ``slice_index`` (contiguous splits where none reports one), the
  slice boundary is outermost on ``data`` (the reference's device layout
  of the same spec), an indivisible data axis and a contradicting node
  report raise the reference's errors, and a 0, 1, 0, 1 report permutes
  the mesh: coordinates and groups come from positions;
- the collectives over 2 gloo ranks (spawned processes):
  psum / pmean / all_gather / global_norm / reduce-scatter / all-to-all
  against numpy, and the compressed bucket reduce-scatter's error
  feedback.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp
from distributeddeeplearning_tpu.parallel import comms as jcomms
from distributeddeeplearning_tpu.parallel import create_mesh as jcreate_mesh
from distributeddeeplearning_tpu.parallel import mesh as jmesh
from distributeddeeplearning_tpu.parallel import shard_batch as jshard_batch
from distributeddeeplearning_tpu_torch.parallel import comms as tcomms
from distributeddeeplearning_tpu_torch.parallel import mesh as tmesh
from distributeddeeplearning_tpu_torch.parallel import sharding as tsharding

torch.set_num_threads(2)  # the suite runs six workers on eight cores

SPECS = [
    {}, {"data": 4}, {"data": None, "fsdp": 2}, {"data": 2, "tensor": 2},
    {"data": None, "tensor": 3}, {"data": None, "pipe": None},
    {"data": 8}, {"data": 2, "fsdp": 2, "seq": 2}, {"data": 1, "expert": 4},
    {"data": 3},
]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("devices", [1, 2, 4, 8, 6])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(
    f"{k}{v}" for k, v in s.items()) or "default")
def test_mesh_spec_sizes_and_errors_equal_the_reference(spec, devices):
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.DATA_AXES == jmesh.DATA_AXES
    want = _outcome(lambda: jmesh.MeshSpec(**spec).sizes(devices))
    assert _outcome(lambda: tmesh.MeshSpec(**spec).sizes(devices)) == want


def _fake_devices(nodes):
    return [SimpleNamespace(id=i) if n is None else SimpleNamespace(id=i, slice_index=n)
            for i, n in enumerate(nodes)]


@pytest.mark.parametrize("nodes,slices", [
    ((0, 1, 0, 1), 2), ((1, 1, 0, 0), 2), ((None,) * 4, 2), ((None,) * 8, 4),
    ((3, 0, 3, 0, 1, 1, 2, 2), 4), ((0, 1, 0, 1), 3), ((0, 0, 0, 0), 2),
    ((None,) * 6, 4)])
def test_slice_groups_equal_the_references(nodes, slices):
    """The ranks grouped by node as the reference groups devices by
    ``slice_index``; a node count that contradicts ``num_slices``, and
    ranks that do not split evenly, raise the reference's errors."""
    want = _outcome(lambda: [[d.id for d in g] for g in
                             jmesh._slice_groups(_fake_devices(nodes), slices)])
    got = _outcome(lambda: tmesh._slice_groups(list(nodes), slices))
    if want[0] == "ok":
        assert got == want
    else:
        assert got[0] == want[0] == "ValueError"
        assert got[1].replace("ranks report", "devices report").replace(
            " (GROUP_RANK)", "").replace("node(s)", "physical slice(s)") == want[1]


def test_a_partial_node_report_raises():
    """Where some ranks report a node and others do not, the port raises
    (the reference would split contiguously: a departure, never a silent
    fall-back)."""
    with pytest.raises(ValueError, match="2 of 4 ranks report a node"):
        tmesh._slice_groups([0, None, 1, None], 2)


@pytest.mark.parametrize("spec", [{"tensor": 2}, {"fsdp": 2}, {"data": None},
                                  {"tensor": 2, "fsdp": 2}, {"expert": 2}])
@pytest.mark.parametrize("slices", [2, 4])
def test_the_slice_boundary_is_outermost_on_data(spec, slices):
    """Without a node report, the port's multi-slice mesh is the
    reference's device layout of the same spec over 8 devices, rank for
    device: each slice holds a contiguous block of the data axis, and the
    other axes stay inside it."""
    jm = _outcome(lambda: jcreate_mesh(jmesh.MeshSpec(**spec), num_slices=slices))
    got = _outcome(lambda: tmesh.slice_order(tmesh.MeshSpec(**spec), [None] * 8, slices))
    if jm[0] != "ok":
        assert got == jm
        return
    want = [d.id for d in jm[1].devices.flatten()]
    assert (list(range(8)) if got[1] is None else list(got[1])) == want
    sizes = dict(zip(tmesh.AXIS_ORDER, tmesh.MeshSpec(**spec).sizes(8)))
    for rank in range(8):
        m = tmesh.Mesh(shape=sizes, size=8, rank=rank, order=got[1])
        per = sizes["data"] // slices
        assert m.axis_index("data") // per == rank // (8 // slices)  # its slice
        for axis in ("fsdp", "expert", "tensor"):
            assert {r // (8 // slices) for r in m.axis_ranks(axis)} == {rank // (8 // slices)}


def test_an_indivisible_data_axis_raises_the_references_error():
    want = _outcome(lambda: jcreate_mesh(jmesh.MeshSpec(tensor=2), num_slices=3))
    assert want[0] == "ValueError"
    assert _outcome(lambda: tmesh.slice_order(tmesh.MeshSpec(tensor=2), [None] * 8, 3)) == want
    with pytest.raises(ValueError, match="data axis 1 not divisible by num_slices 2"):
        tmesh.create_mesh(num_slices=2)  # one process


def test_interleaved_nodes_permute_the_mesh():
    """Nodes 0, 1, 0, 1 on ``data=2 x tensor=2``: the reference's
    ``_slice_groups`` puts devices 0 and 2 in slice 0, so ranks 0 and 2
    hold data shard 0 and form a tensor group; every coordinate and group
    comes from the position, not the rank."""
    nodes = (0, 1, 0, 1)
    groups = [[d.id for d in g] for g in jmesh._slice_groups(_fake_devices(nodes), 2)]
    order = tmesh.slice_order(tmesh.MeshSpec(tensor=2), list(nodes), 2)
    assert list(order) == [r for g in groups for r in g] == [0, 2, 1, 3]
    sizes = dict(zip(tmesh.AXIS_ORDER, tmesh.MeshSpec(tensor=2).sizes(4)))
    want = {0: (0, 0, [0, 2], [0, 1]), 1: (1, 0, [1, 3], [0, 1]),
            2: (0, 1, [0, 2], [2, 3]), 3: (1, 1, [1, 3], [2, 3])}
    for rank, (shard, t, tensor_ranks, data_ranks) in want.items():
        m = tmesh.Mesh(shape=sizes, size=4, rank=rank, order=order)
        assert (m.data_index(), m.axis_index("tensor")) == (shard, t)
        assert m.axis_ranks("tensor") == tensor_ranks
        assert m.axis_ranks("data_group") == m.axis_ranks("data") == data_ranks
        assert len({nodes[r] for r in tensor_ranks}) == 1
        assert {nodes[r] for r in data_ranks} == {0, 1}
        rows = tsharding.local_rows(m, 8)
        assert (rows.start, rows.stop) == (4 * shard, 4 * shard + 4)


def test_a_mesh_without_a_process_group_is_one_rank():
    m = tmesh.create_mesh()
    assert (m.size, m.rank, m.group) == (1, 0, None)
    assert m.shape == dict(zip(jmesh.AXIS_ORDER, (1, 1, 1, 1, 1, 1)))
    assert tmesh.data_parallel_size(m) == 1 and tmesh.world_size(m) == 1
    assert tmesh.world_size() == 1 and tmesh.local_device_count() >= 1


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_rows_are_the_reference_device_rows(world):
    rng = np.random.default_rng(0)
    batch = {"input": rng.integers(0, 9, (8, 3)).astype(np.int32),
             "label": np.arange(8, dtype=np.int32)}
    jm = jcreate_mesh(devices=jax.devices()[:world])
    placed = jshard_batch(jm, batch)
    for rank in range(world):
        mine = tsharding.shard_batch(tmesh.Mesh(shape={"data": world, "fsdp": 1},
                                                size=world, rank=rank), batch)
        for key, arr in placed.items():
            shard = [s for s in arr.addressable_shards
                     if s.device == jm.devices.flat[rank]][0]
            np.testing.assert_array_equal(mine[key], np.asarray(shard.data))
    assert tsharding.batch_spec(3) == (("data", "fsdp"), None, None)
    assert tsharding.data_spec() == (("data", "fsdp"),)
    assert tsharding.replicated_spec() == ()
    with pytest.raises(ValueError, match="not divisible"):
        tsharding.shard_batch(tmesh.Mesh(shape={}, size=3, rank=0), batch)


def _trees():
    """The trees of ``tests/test_comms.py``'s layout tests, as numpy."""
    return {
        "three-leaves": ({"w": np.arange(1000, dtype=np.float32).reshape(50, 20),
                          "b": np.ones((7,), np.float32),
                          "s": np.asarray(3.0, np.float32)}, 600, 8),
        "one-leaf": ({"w": np.ones((13,), np.float32)}, 1 << 30, 8),
        "nested": ({"z": {"b": np.linspace(-1, 1, 37, dtype=np.float32),
                          "a": np.full((3, 5), 2.5, np.float32)},
                    "a": np.arange(11, dtype=np.float32)}, 64, 4),
    }


def _to_torch(tree, bf16=()):
    return {k: _to_torch(v, bf16) if isinstance(v, dict) else
            (torch.from_numpy(np.array(v)).bfloat16() if k in bf16 else
             torch.from_numpy(np.array(v)))
            for k, v in tree.items()}


def _to_jax(tree, bf16=()):
    return {k: _to_jax(v, bf16) if isinstance(v, dict) else
            jnp.asarray(v, jnp.bfloat16 if k in bf16 else None)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["three-leaves", "one-leaf", "nested"])
def test_bucket_layout_equals_the_reference(name):
    tree, nbytes, shards = _trees()[name]
    bf16 = ("b",) if name == "three-leaves" else ()
    want = jcomms.BucketLayout.for_tree(_to_jax(tree, bf16), bucket_bytes=nbytes,
                                        shards=shards)
    # insertion order reversed: the layout takes the leaves by key
    scrambled = dict(reversed(list(_to_torch(tree, bf16).items())))
    got = tcomms.BucketLayout.for_tree(scrambled, bucket_bytes=nbytes, shards=shards)
    assert got.bucket_bounds == want.bucket_bounds
    assert (got.total, got.padded_total, got.num_buckets) == (
        want.total, want.padded_total, want.num_buckets)
    assert got.bucket_sizes == want.bucket_sizes
    assert got.shard_sizes() == want.shard_sizes()
    assert got.shapes == want.shapes and got.sizes == want.sizes
    for g, w in zip(got.to_buckets(scrambled), want.to_buckets(_to_jax(tree, bf16))):
        assert g.dtype == torch.float32
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    back = got.from_buckets(got.to_buckets(scrambled))
    for path, leaf in tcomms.sorted_leaves(scrambled):
        node = back
        for k in path:
            node = node[k]
        assert node.dtype == leaf.dtype and torch.equal(node, leaf)
    index = 1 % shards
    b0 = got.to_buckets(scrambled)[0]
    np.testing.assert_array_equal(
        got.shard_slice(b0, index).numpy(),
        np.asarray(want.shard_slice(want.to_buckets(_to_jax(tree, bf16))[0], index)))


def test_write_flat_copies_into_the_tree_in_place():
    tree = _to_torch(_trees()["nested"][0])
    layout = tcomms.BucketLayout.for_tree(tree, bucket_bytes=64, shards=4)
    target = {"a": torch.zeros(11), "z": {"a": torch.zeros(3, 5), "b": torch.zeros(37)}}
    ids = [id(t) for _, t in tcomms.sorted_leaves(target)]
    layout.write_flat(target, layout.to_flat(tree))
    assert [id(t) for _, t in tcomms.sorted_leaves(target)] == ids
    for (_, a), (_, b) in zip(tcomms.sorted_leaves(target), tcomms.sorted_leaves(tree)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wus", [False, True])
@pytest.mark.parametrize("accum", [1, 4])
@pytest.mark.parametrize("shards", [2, 8])
def test_ring_wire_bytes_equal_the_reference(shards, accum, wus):
    tree = {"w": np.ones((4096,), np.float32), "b": np.ones((33,), np.float32)}
    jl = jcomms.BucketLayout.for_tree(_to_jax(tree), bucket_bytes=4096, shards=shards)
    tl = tcomms.BucketLayout.for_tree(_to_torch(tree), bucket_bytes=4096, shards=shards)
    for dtypes in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        assert tcomms.ring_wire_bytes(
            tl, comm_dtype=dtypes[1], weight_update_sharding=wus, accum_steps=accum
        ) == jcomms.ring_wire_bytes(
            jl, comm_dtype=dtypes[0], weight_update_sharding=wus, accum_steps=accum)


def test_map_params_subtrees_finds_the_params_shaped_buffers():
    params = {"w": torch.ones(4), "z": {"b": torch.ones(2)}}
    opt = {"count": torch.zeros(()), "mu": {"w": torch.ones(4), "z": {"b": torch.ones(2)}},
           "nu": {"w": torch.ones(4), "z": {"b": torch.ones(2)}}}
    got = tcomms.map_params_subtrees(opt, tcomms.tree_structure(params),
                                     lambda sub: "P", lambda leaf: "L")
    assert got == {"count": "L", "mu": "P", "nu": "P"}
    layout = tcomms.BucketLayout.for_tree(params, bucket_bytes=12, shards=2)
    flat = tcomms.comm_opt_tree(opt, tcomms.tree_structure(params), layout)
    assert isinstance(flat["mu"], tuple) and len(flat["mu"]) == layout.num_buckets


AXIS_ITEMS = {"fsdp": "A5", "tensor": "A6", "seq": "A7", "pipe": "A7", "expert": "A5"}


@pytest.fixture(scope="module")
def refusals():
    return _torch_dp.run_ranks(_torch_dp.mesh_refusals, 2, list(AXIS_ITEMS),
                               timeout=120)


@pytest.mark.parametrize("axis", list(AXIS_ITEMS))
def test_create_mesh_refuses_the_other_axes(refusals, axis):
    """Over 2 ranks the sizes are legal and the axis is refused by name;
    a tensor axis (tensor-parallel serving and training), an fsdp axis
    (ZeRO-3 training) and an expert axis (MoE BERT's experts) build, with
    their process groups and ``tensor_parallel_size``."""
    for rank, out in enumerate(refusals):
        kind, message = out[axis]
        if axis in ("tensor", "fsdp", "expert"):
            assert kind == "ok", message
            assert message["shape"][axis] == 2 and message["shape"]["data"] == 1
            assert message["group"] and message["group_size"] == 2
            assert message["tensor_parallel_size"] == (2 if axis == "tensor" else 1)
            assert message["index"] == rank
            continue
        assert kind == "NotImplementedError"
        assert AXIS_ITEMS[axis] in message and axis in message


def test_collectives_over_two_gloo_ranks():
    out = _torch_dp.run_ranks(_torch_dp.collectives_probe, 2, timeout=120)
    x = [np.arange(8, dtype=np.float32) * (r + 1) for r in range(2)]
    total = x[0] + x[1]
    for r, got in enumerate(out):
        np.testing.assert_array_equal(got["psum"]["a"], total)
        np.testing.assert_array_equal(got["pmean"]["a"], total / 2)
        assert got["psum"]["n"] == 3.0 and got["pmean"]["t"] == [1.5, 1.5]
        np.testing.assert_array_equal(got["gather"], np.concatenate(x))
        np.testing.assert_array_equal(got["gather_stacked"], np.stack(x))
        np.testing.assert_array_equal(got["reduce_scatter"], total[r * 4:(r + 1) * 4])
        np.testing.assert_array_equal(
            got["all_to_all"], np.concatenate([x[0][r * 4:(r + 1) * 4],
                                               x[1][r * 4:(r + 1) * 4]]))
        np.testing.assert_allclose(got["norm"], np.sqrt((x[0] ** 2).sum()
                                                        + (x[1] ** 2).sum()), rtol=1e-6)
        assert got["broadcast"] == [0.0] * 3
        # the compressed wire: f32 sum of the bf16 payloads, residual = the
        # cast error, and the two add up to the f32 reduce-scatter
        adj = [np.float32(0.1) * (np.arange(8, dtype=np.float32) + r) for r in range(2)]
        wire = [torch.from_numpy(a).bfloat16().float().numpy() for a in adj]
        np.testing.assert_array_equal(got["bf16_shard"],
                                      (wire[0] + wire[1])[r * 4:(r + 1) * 4])
        np.testing.assert_array_equal(got["bf16_residual"], adj[r] - wire[r])
        assert got["staged"] == {}
        # utils.metrics.pmean_metrics: the metrics dict's mean over the ranks
        assert got["pmean_metrics"] == {"loss": 1.5, "top1": 0.375}
