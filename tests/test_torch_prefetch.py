"""The port's input prefetch (``utils/prefetch.py``) and the trainer's use
of it.

On the CPU: batches come out in order with their values, wrapped as
tensors without a copy; an exception of the source surfaces at the
consumer's ``next()`` in order, after every batch staged before it;
``close()`` reaps the worker even when it is blocked on a full queue; a
fit with ``prefetch=2`` is bitwise equal to one with ``prefetch=0``.  The
card test (marker ``cuda``, skipped without a GPU; jax-free, so it runs
on the card with ``python -m pytest --noconftest``) checks the side-stream
copies: tensors on the card, bitwise the host arrays, safe to read on the
consumer's stream.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.data import synthetic as tsynth
from distributeddeeplearning_tpu_torch.models import bert as tbert
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep
from distributeddeeplearning_tpu_torch.utils.prefetch import (
    PrefetchIterator,
    prefetch_to_device,
)

torch.set_num_threads(2)  # the suite runs six workers on eight cores
for _fn in (torch.exp, torch.log, torch.tanh, torch.erf, torch.rsqrt):
    _fn(torch.ones(1 << 16))  # first MKL calls in a worker (ROADMAP C, traps)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        yield {"image": rng.normal(size=(2, 3)).astype(np.float32),
               "label": np.full((2,), i, np.int32), "tag": f"b{i}"}


class Stopped(Exception):
    pass


def test_batches_come_out_in_order_as_tensors_without_a_copy():
    src = list(_batches(6))
    it = prefetch_to_device(iter(src), "cpu", size=2)
    out = list(it)
    assert len(out) == 6 and not it.thread.is_alive()
    for got, want in zip(out, src):
        assert isinstance(got["image"], torch.Tensor) and got["tag"] == want["tag"]
        np.testing.assert_array_equal(got["image"].numpy(), want["image"])
        assert got["label"].dtype == torch.int32
        # CPU staging wraps the array: same memory
        assert got["image"].data_ptr() == want["image"].__array_interface__["data"][0]
    with pytest.raises(StopIteration):
        next(it)


def test_an_error_of_the_source_surfaces_in_order():
    def source():
        yield from _batches(3)
        raise Stopped(4)

    it = PrefetchIterator(source(), "cpu", size=2)
    deadline = time.monotonic() + 5.0
    while it._q.qsize() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)  # the worker runs ahead up to the queue's size
    assert [int(next(it)["label"][0]) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(Stopped):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    it.close()
    assert not it.thread.is_alive()


def test_close_reaps_a_worker_blocked_on_a_full_queue():
    def endless():
        i = 0
        while True:
            yield {"x": np.full((1,), i, np.float32)}
            i += 1

    it = prefetch_to_device(endless(), "cpu", size=1)
    assert float(next(it)["x"][0]) == 0.0
    time.sleep(0.05)  # the worker fills the queue and blocks in put
    it.close(timeout=5.0)
    assert not it.thread.is_alive()
    with pytest.raises(RuntimeError, match="after close"):
        next(it)


def test_close_gives_up_on_a_source_stuck_inside_next():
    release = threading.Event()

    def stuck():
        release.wait(10.0)
        yield {"x": np.zeros(1)}

    it = prefetch_to_device(stuck(), "cpu", size=1)
    t0 = time.monotonic()
    it.close(timeout=0.2)
    assert time.monotonic() - t0 < 5.0 and it.thread.is_alive()
    release.set()
    it.thread.join(timeout=5.0)
    assert not it.thread.is_alive()


def test_size_must_be_positive():
    with pytest.raises(ValueError, match="prefetch size"):
        PrefetchIterator(iter([]), "cpu", size=0)


# ---- through the trainer ------------------------------------------------------

SEQ, BATCH, SPE = 16, 4, 3
CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, max_position_embeddings=SEQ, num_classes=3,
           dropout_rate=0.1)


def _fit(prefetch, stop_before=None):
    import dataclasses

    cfg = dataclasses.replace(tbert.BERT_BASE, **CFG)
    params = tbert.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def apply_fn(p, ids, *, train, generator=None, attention_mask=None,
                 token_type_ids=None):
        return tbert.forward(p, ids, config=cfg, dtype=torch.float32, train=train,
                             attention_mask=attention_mask,
                             token_type_ids=token_type_ids, generator=generator)

    st = tstate.TrainState.create(
        params=params, apply_fn=apply_fn,
        tx=tstate.adamw(tsched.warmup_linear_decay_schedule(1e-3, 2 * SPE)))
    step = tstep.build_train_step(st, compute_dtype=torch.float32, rng=3)
    data = list(tsynth.SyntheticTextDataset(
        length=BATCH * 2 * SPE, seq_len=SEQ, vocab_size=CFG["vocab_size"],
        num_classes=CFG["num_classes"], seed=1).batches(BATCH))
    losses = []

    def recording(state, batch):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        return state, m

    def factory(start):
        for i in range(start, len(data)):
            if stop_before is not None and i + 1 == stop_before:
                raise Stopped(i + 1)
            yield data[i]

    trainer = tloop.Trainer(recording, config=tloop.TrainerConfig(
        epochs=2, steps_per_epoch=SPE, global_batch_size=BATCH, prefetch=prefetch))
    try:
        st, _ = trainer.fit(st, factory)
    except Stopped:
        return None, losses
    return st, losses


def test_a_prefetched_fit_is_bitwise_a_synchronous_one():
    a, la = _fit(prefetch=0)
    b, lb = _fit(prefetch=2)
    assert la == lb and len(la) == 2 * SPE
    for x, y in zip(tstate.tree_leaves(a.params), tstate.tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_a_stream_that_stops_raises_in_the_fit_after_the_steps_before_it():
    """The worker reads past the stop; the fit sees it only at step 5."""
    state, losses = _fit(prefetch=2, stop_before=5)
    assert state is None and len(losses) == 4


# ---- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the side-stream copies run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_side_stream_copies_land_before_the_consumer_reads(cuda):
    src = [{"x": np.random.default_rng(i).normal(size=(256, 1024)).astype(np.float32),
            "y": np.arange(i, i + 8, dtype=np.int32)} for i in range(8)]
    it = prefetch_to_device(iter(src), cuda, size=2)
    for want in src:
        got = next(it)
        assert got["x"].device.type == "cuda" and got["y"].dtype == torch.int32
        # a kernel on the consumer's stream, then the host read: bitwise
        assert torch.equal((got["x"] * 1.0).cpu(), torch.from_numpy(want["x"]))
        assert torch.equal(got["y"].cpu(), torch.from_numpy(want["y"]))
    it.close()
    assert not it.thread.is_alive()
