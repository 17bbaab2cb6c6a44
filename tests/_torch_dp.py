"""Multi-process harness of the port's data-parallel tests.

:func:`run_ranks` starts ``world`` processes with ``torch.multiprocessing``
spawn, joins them in a gloo group on localhost and runs a function of this
module in each; each rank's return value (numpy arrays, floats, lists,
dicts) comes back to the caller in rank order.  A rank that raises fails
the call with its traceback; a call that outlives its timeout kills the
ranks.  The children import torch, numpy and the port only: the functions
they run live here, in a module without jax, and take numpy inputs.

The rank functions build the tiny models of the tests: the BERT of
``tests/test_comms.py`` (1 layer, hidden 32, 2 heads, vocabulary 50, 3
classes, SGD momentum at lr 0.05), a tiny causal LM (AdamW, no clip),
ResNet-18 in float64 for the global-batch BatchNorm check, and the
tensor-parallel serving cases of ``tests/test_torch_tp_serve.py``
(:func:`tp_serve`, which runs in-process at ``tp=1`` too).
"""

from __future__ import annotations

import queue as queue_mod
import socket
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

BERT = dict(num_layers=1, hidden_size=32, num_heads=2, intermediate_size=64,
            vocab_size=50, num_classes=3, max_position_embeddings=16,
            dropout_rate=0.0)
BERT_LR = 0.05
LM = dict(num_layers=1, d_model=16, num_heads=2, d_ff=32, vocab_size=37)
LM_LR = 1e-2


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, rank: int, world: int, port: int, args, results) -> None:
    try:
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:  # the parent raises it with the rank's traceback
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_ranks(fn, world: int, *args, timeout: float = 240.0):
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its
    own spawned process of a gloo group.  Results must hold no tensors:
    torch's queue shares them through memory the exiting child frees."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, args=(fn, r, world, port, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, status, out = results.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue_mod.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} "
                                   f"did not finish in {timeout} s") from None
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(world)]


# -- models --------------------------------------------------------------------

def _mesh():
    from distributeddeeplearning_tpu_torch.parallel import create_mesh

    return create_mesh()


def np_tree(tree):
    """``{keystr: numpy}`` of a port tree (the checkpoint's key paths)."""
    from distributeddeeplearning_tpu_torch.train.checkpoint import flatten

    return {k: t.detach().numpy().copy() for k, t in flatten(tree)}


def bert_state(params_np, dtype=torch.float32):
    from distributeddeeplearning_tpu_torch.models import bert as tbert
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train import schedule as tsched
    from distributeddeeplearning_tpu_torch.train import state as tstate

    net = get_model("bert-base", dtype=dtype, **BERT)

    def apply_fn(p, ids, *, train, generator=None, attention_mask=None,
                 token_type_ids=None):
        return net(p, ids, train=train, attention_mask=attention_mask,
                   token_type_ids=token_type_ids, generator=generator)

    return tstate.TrainState.create(
        params=tbert.params_from_numpy(params_np, device="cpu"), apply_fn=apply_fn,
        tx=tstate.sgd_momentum(tsched.constant_schedule(BERT_LR)))


def lm_state(params_np):
    from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
    from distributeddeeplearning_tpu_torch.train import schedule as tsched
    from distributeddeeplearning_tpu_torch.train import state as tstate

    def apply_fn(p, toks, **_):
        return tpt.forward(p, toks, num_heads=LM["num_heads"])

    return tstate.TrainState.create(
        params=tpt.params_from_numpy(params_np, device="cpu"), apply_fn=apply_fn,
        tx=tstate.adamw(tsched.constant_schedule(LM_LR), weight_decay=0.01,
                        grad_clip_norm=0.0))


def lm_hooks():
    from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt

    def loss(logits, labels, *, label_smoothing=0.0):
        return tpt.next_token_loss(logits, labels)

    def metrics(logits, toks, loss):
        return {"loss": loss.float()}

    return loss, metrics


def _poisoned(loss_fn):
    def poisoned(logits, labels, *, label_smoothing=0.0):
        return loss_fn(logits, labels) * float("nan")

    return poisoned


# -- rank functions ----------------------------------------------------------

def comm_overlap_cases(rank, world, model, params_np, batch, cases, steps):
    """Each case: a fresh state of ``model`` ("bert" | "lm"), the
    ``comm_overlap`` step (the implicit one for a case with ``implicit``)
    with the case's keywords, ``steps`` steps on this
    rank's rows of ``batch``.  Returns per case the metrics of every step,
    the params and the optimizer state after the last (the prepared
    layout's blocks per rank), and the residual blocks."""
    from distributeddeeplearning_tpu_torch.parallel import shard_batch
    from distributeddeeplearning_tpu_torch.train import step as tstep

    mesh = _mesh()
    local = shard_batch(mesh, batch)
    out = {}
    for name, kw in cases.items():
        kw = dict(kw)
        poison = kw.pop("poison", False)
        comm = not kw.pop("implicit", False)
        if model == "bert":
            state = bert_state(params_np)
            loss_fn, metrics_fn = tstep.cross_entropy_loss, tstep.classification_metrics
        else:
            state = lm_state(params_np)
            loss_fn, metrics_fn = lm_hooks()
        if poison:
            loss_fn = _poisoned(loss_fn)
        step = tstep.build_train_step(state, mesh=mesh, compute_dtype=torch.float32,
                                      comm_overlap=comm, loss_fn=loss_fn,
                                      metrics_fn=metrics_fn, **kw)
        if comm:
            state = step.prepare_state(state)
        before = np_tree(state.params)
        metrics = []
        for _ in range(steps):
            state, m = step(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {
            "metrics": metrics,
            "params": np_tree(state.params),
            "before": before,
            "step": state.step,
            "residual": ([t.numpy().copy() for t in state.opt_state["residual"]]
                         if comm else []),
            "wire": step.wire_bytes() if comm else None,
            "num_buckets": step.layout.num_buckets if comm else None,
        }
    return out


def implicit_resnet(rank, world, variables_np, batches, classes, lr, dtype_name,
                    accum=1):
    """The implicit data-parallel step of ResNet-18 (global-batch
    BatchNorm moments) on this rank's rows of each global batch."""
    from distributeddeeplearning_tpu_torch import models as tmodels
    from distributeddeeplearning_tpu_torch.models import _convnet
    from distributeddeeplearning_tpu_torch.parallel import shard_batch
    from distributeddeeplearning_tpu_torch.train import schedule as tsched
    from distributeddeeplearning_tpu_torch.train import state as tstate
    from distributeddeeplearning_tpu_torch.train import step as tstep

    dtype = getattr(torch, dtype_name)
    mesh = _mesh()
    tv = _convnet.variables_from_numpy(variables_np, device="cpu")
    state = tstate.TrainState.create(
        params=tv["params"], batch_stats=tv["batch_stats"],
        tx=tstate.sgd_momentum(tsched.constant_schedule(lr)),
        apply_fn=tmodels.get_model("resnet18", num_classes=classes, dtype=dtype))
    step = tstep.build_train_step(state, mesh=mesh, compute_dtype=dtype,
                                  accum_steps=accum)
    metrics = []
    for batch in batches:
        state, m = step(state, shard_batch(mesh, batch))
        metrics.append({k: float(v) for k, v in m.items()})
    got = _convnet.variables_to_numpy({"params": state.params,
                                       "batch_stats": state.batch_stats})
    return {"metrics": metrics, "variables": got,
            "trace": _convnet.variables_to_numpy({"params": state.opt_state["trace"]})}


def uneven_evaluate(rank, world, params_np, batches, counts, cap_probe):
    """``Trainer.evaluate`` of the tiny BERT with this rank's rows of the
    first ``counts[rank]`` global batches; with ``cap_probe`` also an
    evaluate whose ``eval_buffer_batches`` every rank overflows (its
    error message comes back)."""
    from distributeddeeplearning_tpu_torch.parallel import shard_batch
    from distributeddeeplearning_tpu_torch.train import loop as tloop
    from distributeddeeplearning_tpu_torch.train import step as tstep

    mesh = _mesh()
    state = bert_state(params_np)
    eval_step = tstep.build_eval_step(state, mesh=mesh, compute_dtype=torch.float32)
    mine = [shard_batch(mesh, b) for b in batches[:counts[rank]]]
    trainer = tloop.Trainer(lambda s, b: (s, {}), eval_step=eval_step, mesh=mesh,
                            config=tloop.TrainerConfig(epochs=1, steps_per_epoch=1))
    out = {"metrics": trainer.evaluate(state, iter(mine))}
    if cap_probe:
        capped = tloop.Trainer(lambda s, b: (s, {}), eval_step=eval_step, mesh=mesh,
                               config=tloop.TrainerConfig(epochs=1, steps_per_epoch=1,
                                                          eval_buffer_batches=1))
        try:
            capped.evaluate(state, iter(mine))
        except RuntimeError as exc:
            out["cap_error"] = str(exc)
    return out


def flash_rows(rank, world, q, k, v, w, causal):
    """``make_flash_attention(mesh)`` on this rank's rows (plain path on
    the CPU): the output and the gradients of ``sum(o * w)``."""
    from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa
    from distributeddeeplearning_tpu_torch.parallel.sharding import local_rows

    mesh = _mesh()
    rows = local_rows(mesh, q.shape[0])
    fn = tfa.make_flash_attention(mesh=mesh, causal=causal)
    t = [torch.from_numpy(x[rows]).requires_grad_(True) for x in (q, k, v)]
    o = fn(*t, None, dtype=torch.float32)
    (o * torch.from_numpy(w[rows])).sum().backward()
    return {"o": o.detach().numpy(), "grads": [x.grad.numpy() for x in t]}


def resume_is_bitwise(rank, world, params_np, batches, directory, split):
    """The tiny LM under ``comm_overlap`` with the bf16 wire and
    weight-update sharding through ``Trainer.fit`` with checkpoints: a fit
    of ``len(batches)`` steps, and one stopped after ``split`` steps and
    resumed from its checkpoint in a fresh state.  Returns both ends
    (params, optimizer blocks, residual blocks) as raw bytes."""
    from distributeddeeplearning_tpu_torch.parallel import shard_batch
    from distributeddeeplearning_tpu_torch.train import loop as tloop
    from distributeddeeplearning_tpu_torch.train import step as tstep

    mesh = _mesh()
    loss_fn, metrics_fn = lm_hooks()
    local = [shard_batch(mesh, b) for b in batches]

    def fit(steps, ckpt_dir):
        state = lm_state(params_np)
        step = tstep.build_train_step(
            state, mesh=mesh, compute_dtype=torch.float32, comm_overlap=True,
            comm_dtype="bf16", weight_update_sharding=True, accum_steps=2,
            bucket_mb=0.002, loss_fn=loss_fn, metrics_fn=metrics_fn)
        state = step.prepare_state(state)
        trainer = tloop.Trainer(step, mesh=mesh, config=tloop.TrainerConfig(
            epochs=1, steps_per_epoch=steps, checkpoint_dir=ckpt_dir,
            checkpoint_every_steps=1 if ckpt_dir else None, prefetch=0))
        state, _ = trainer.fit(state, lambda start: iter(local[start:]))
        return state

    def blocks(state):
        return {"params": np_tree(state.params),
                "opt": np_tree(state.opt_state["base"]),
                "residual": [t.numpy().copy() for t in state.opt_state["residual"]],
                "step": state.step}

    whole = blocks(fit(len(batches), None))
    fit(split, directory)  # stops after `split` steps, checkpointed
    resumed = blocks(fit(len(batches), directory))
    return {"whole": whole, "resumed": resumed}


def mesh_refusals(rank, world, axes):
    """``{axis: (exception name, message)}`` of ``create_mesh`` with the
    axis at 2; for a mesh that builds, ``("ok", what it holds)``: its
    shape, whether the axis has a process group, the ranks in it,
    ``tensor_parallel_size`` and this rank's coordinate on the axis."""
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch.parallel import (
        MeshSpec,
        create_mesh,
        tensor_parallel_size,
    )

    out = {}
    for axis in axes:
        try:
            mesh = create_mesh(MeshSpec(**{"data": 1, axis: 2}))
        except Exception as exc:  # noqa: BLE001 — the outcome is the result
            out[axis] = (type(exc).__name__, str(exc))
            continue
        group = mesh.axis_group(axis)
        out[axis] = ("ok", {"shape": dict(mesh.shape), "group": group is not None,
                            "group_size": dist.get_world_size(group),
                            "tensor_parallel_size": tensor_parallel_size(mesh),
                            "index": mesh.axis_index(axis)})
    return out


def collectives_probe(rank, world):
    """Every collective of ``parallel.collectives`` on small CPU tensors."""
    from distributeddeeplearning_tpu_torch.parallel import collectives as col
    from distributeddeeplearning_tpu_torch.parallel import comms

    group = _mesh().group
    x = torch.arange(8, dtype=torch.float32) * (rank + 1)
    tree = {"a": x, "n": torch.tensor(1.0 + rank), "t": (torch.tensor(1.0 + rank),
                                                         torch.tensor(2.0 - rank))}
    summed, mean = col.psum(tree, group), col.pmean(tree, group)
    b = torch.full((3,), float(rank))
    col.broadcast_(b, 0, group)
    adj = torch.tensor(np.float32(0.1) * (np.arange(8, dtype=np.float32) + rank))
    shards, residuals = comms.reduce_scatter_buckets(
        [adj], group, comm_dtype=torch.bfloat16, residuals=[torch.zeros(8)],
        shards=world)
    pending = col.reduce_scatter(x, group, async_op=True)
    return {
        "psum": {"a": summed["a"].numpy(), "n": float(summed["n"])},
        "pmean": {"a": mean["a"].numpy(), "t": [float(v) for v in mean["t"]]},
        "gather": col.all_gather(x, group).numpy(),
        "gather_stacked": col.all_gather(x, group, tiled=False).numpy(),
        "reduce_scatter": pending.wait().numpy(),
        "all_to_all": col.all_to_all(x, group).numpy(),
        "norm": float(col.global_norm({"x": x}, group)),
        "broadcast": b.tolist(),
        "bf16_shard": shards[0].numpy(),
        "bf16_residual": residuals[0].numpy(),
        "staged": col.staged_ops(),
    }


def workloads_dp(rank, world, directory):
    """The three workloads with ``distributed=True`` inside this rank's
    group, tiny, on the CPU: the LM (implicit, then ``comm_overlap`` with
    the bf16 wire and weight-update sharding, checkpointed and resumed),
    BERT (implicit) and the synthetic benchmark (ResNet-18)."""
    import json
    import os

    from distributeddeeplearning_tpu_torch.workloads import benchmark as twb
    from distributeddeeplearning_tpu_torch.workloads import bert as twbert
    from distributeddeeplearning_tpu_torch.workloads import transformer as tw

    lm = dict(batch_size=2, seq_len=8, vocab_size=37, num_layers=1, d_model=16,
              num_heads=2, d_ff=32, steps_per_epoch=2, train_examples=64,
              compute_dtype="float32", seed=0, device="cpu", distributed=True)
    out = {}
    state, fit = tw.main(epochs=1, attention="flash",
                         metrics_path=os.path.join(directory, f"lm{rank}.jsonl"), **lm)
    out["lm_implicit"] = {"step": state.step, "loss": fit.final_train_metrics["loss"],
                          "eval": fit.final_eval_metrics["loss"],
                          "images": fit.total_images,
                          "rows": os.path.exists(os.path.join(directory,
                                                              f"lm{rank}.jsonl"))}
    comm = dict(comm_overlap=True, bucket_mb=0.002, comm_dtype="bf16",
                weight_update_sharding=True, grad_clip_norm=0.0,
                save_filepath=os.path.join(directory, "ckpt"), **lm)
    state, fit = tw.main(epochs=1, **comm)
    state2, _ = tw.main(epochs=2, **comm)
    out["lm_comm"] = {"step": state.step, "resumed_step": state2.step,
                      "loss": fit.final_train_metrics["loss"],
                      "params": np_tree(state2.params)}
    state, fit = twbert.main(model="bert-base", epochs=1, batch_size=2, seq_len=16,
                             num_classes=3, vocab_size=101, num_layers=1,
                             hidden_size=32, num_heads=2, intermediate_size=64,
                             max_position_embeddings=16, steps_per_epoch=2,
                             train_examples=32, compute_dtype="float32",
                             attention="flash", device="cpu", distributed=True)
    out["bert"] = {"step": state.step, "loss": fit.final_train_metrics["loss"],
                   "params": np_tree(state.params)}
    result = twb.main(model="resnet18", batch_size=2, image_size=32, num_classes=7,
                      num_iters=1, num_batches_per_iter=1, num_warmup_batches=1,
                      compute_dtype="float32", device="cpu", distributed=True,
                      metrics_path=os.path.join(directory, f"bench{rank}.jsonl"))
    rows = os.path.join(directory, f"bench{rank}.jsonl")
    out["benchmark"] = {"num_devices": result.num_devices,
                        "total": result.img_sec_total,
                        "per_chip": result.img_sec_per_chip_mean,
                        "rows": ([json.loads(x) for x in open(rows)]
                                 if os.path.exists(rows) else None)}
    return out


def card_lm_fit(rank, world, params_np, batches, kw):
    """The tiny LM in bf16 with flash attention on the card's device 0
    (every rank shares it) through ``build_train_step(mesh=..., **kw)``;
    with ``world`` 0 (a call in the parent, no group) the one-process
    implicit fit.  Returns per-step losses, the params and the K1-K3
    launch counts."""
    from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
    from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa
    from distributeddeeplearning_tpu_torch.parallel import shard_batch
    from distributeddeeplearning_tpu_torch.train import schedule as tsched
    from distributeddeeplearning_tpu_torch.train import state as tstate
    from distributeddeeplearning_tpu_torch.train import step as tstep

    mesh = _mesh() if world else None
    attention_fn = tfa.make_flash_attention(mesh=mesh, causal=True)

    def apply_fn(p, toks, **_):
        p = tstate.tree_map(lambda a: a.to(torch.bfloat16), p)
        return tpt.forward(p, toks, num_heads=LM["num_heads"],
                           attention_fn=attention_fn).float()

    state = tstate.TrainState.create(
        params=tpt.params_from_numpy(params_np, device="cuda:0"), apply_fn=apply_fn,
        tx=tstate.adamw(tsched.constant_schedule(LM_LR), grad_clip_norm=0.0))
    loss_fn, metrics_fn = lm_hooks()
    step = tstep.build_train_step(state, mesh=mesh, compute_dtype=torch.bfloat16,
                                  loss_fn=loss_fn, metrics_fn=metrics_fn, **kw)
    if kw.get("comm_overlap"):
        state = step.prepare_state(state)
    for c in ("launches_bf16", "launches_dq_bf16", "launches_dkv_bf16"):
        setattr(tfa, c, 0)
    losses = []
    for batch in batches:
        state, m = step(state, shard_batch(mesh, batch) if mesh else batch)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": np_tree(
        tstate.tree_map(lambda t: t.detach().cpu(), state.params)),
            "launches": [tfa.launches_bf16, tfa.launches_dq_bf16, tfa.launches_dkv_bf16]}


# -- tensor-parallel serving ----------------------------------------------------

def tp_params(params_np, weights: str):
    """The port's parameter tree from the JAX package's numpy one, in
    ``weights``: ``"f32"``, ``"bf16"`` (every leaf cast, as ``astype``
    casts the reference's) or ``"int8"`` (the port's ``quantize_params``,
    bitwise the reference's codes and scales)."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        params_from_numpy,
    )
    from distributeddeeplearning_tpu_torch.quant.calibrate import quantize_params
    from distributeddeeplearning_tpu_torch.train.state import tree_map

    params = params_from_numpy(params_np, device="cpu")
    if weights == "bf16":
        return tree_map(lambda t: t.to(torch.bfloat16), params)
    if weights == "int8":
        return quantize_params(params)
    return params


def tp_serve_case(params_np, case, tp: int):
    """One serving case on ``tensor_parallel_engine(tp=tp)``: the streams,
    the report's provenance, the prefix hit rate, the collectives the run
    issued and the forward passes it ran."""
    from distributeddeeplearning_tpu_torch.parallel import collectives
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        Request,
        tensor_parallel_engine,
    )

    kw = dict(tp=tp, num_heads=case["num_heads"], batch_slots=2, max_seq=32,
              device="cpu", temperature=case.get("temperature", 0.0))
    if case.get("cache_dtype"):
        kw["cache_dtype"] = case["cache_dtype"]
    if case["layout"] == "paged":
        kw.update(kv_layout="paged", page_size=4, prefill_chunk=8)
    engine, mesh = tensor_parallel_engine(tp_params(params_np, case["weights"]), **kw)
    collectives.reset_counts()
    requests = [Request(uid=uid, prompt=list(prompt)) for uid, prompt in case["requests"]]
    results, report = ContinuousBatchingScheduler(
        engine, max_new_tokens=case["max_new"]).run(requests)
    out = {"tokens": {r.uid: r.tokens for r in results}, "tp": report.tp,
           "layout_rules": report.layout_rules, "hit_rate": report.prefix_hit_rate,
           "counts": collectives.counts(), "decode_steps": report.decode_steps,
           "prefills": (engine.chunks_run if case["layout"] == "paged"
                        else len(requests)),
           "mesh": None if mesh is None else dict(mesh.shape),
           "kv_heads": engine.cache["k"].shape[3]}
    if case["layout"] == "paged":
        engine.allocator.check()
    return out


def tp_logits(params_np, tokens, num_heads: int, tp: int):
    """``forward_prefill`` logits (flash attention: its plain version) of
    ``tokens`` under f32 and bf16 weights, on a ``tensor=tp`` mesh of the
    group (no mesh at ``tp=1``)."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward_prefill,
    )
    from distributeddeeplearning_tpu_torch.parallel import (
        MeshSpec,
        create_mesh,
        shard_params,
    )

    mesh = create_mesh(MeshSpec(data=1, tensor=tp)) if tp > 1 else None
    out = {}
    for weights in ("f32", "bf16"):
        params = tp_params(params_np, weights)
        if mesh is not None:
            params = shard_params(params, mesh)
        with torch.inference_mode():
            logits, k, _ = forward_prefill(params, torch.from_numpy(tokens),
                                           num_heads=num_heads, attention="flash",
                                           mesh=mesh)
        out[weights] = (logits.float().numpy(), k.float().numpy())
    return out


def tp_serve(rank, world, params_np, cases, tokens):
    """Every case of ``cases`` on this rank of a ``tensor=world`` engine
    (in-process at ``world=1``), the logits of :func:`tp_logits`, and
    whether anything loaded jax."""
    import sys

    out = {case["name"]: tp_serve_case(params_np, case, world) for case in cases}
    out["logits"] = tp_logits(params_np, tokens, cases[0]["num_heads"], world)
    out["jax_loaded"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    return out


def row_parallel_qdot(rank, world, x, w):
    """``qdot`` of this rank's half of K (``x`` columns, ``w`` rows, whole
    scales) over the group, and the same product quantized on the rank's
    own absmax."""
    from distributeddeeplearning_tpu_torch.parallel import collectives
    from distributeddeeplearning_tpu_torch.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu_torch.quant.qtensor import QTensor, qdot, quantize

    group = create_mesh().group
    qt = quantize(torch.from_numpy(w))
    per = w.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    mine = QTensor(qt.values[rows].contiguous(), qt.scales, qt.axis, qt.block)
    xs = torch.from_numpy(x[:, rows].copy())
    collectives.reset_counts()
    split = qdot(xs, mine, group=group).numpy()
    counts = collectives.counts()
    local = qdot(xs, mine)
    return {"split": split, "counts": counts,
            "local_absmax": collectives.all_reduce(local, group).numpy()}
