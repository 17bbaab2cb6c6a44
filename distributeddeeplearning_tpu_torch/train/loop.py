"""The training loop — the port of ``train/loop.py`` on one process.

:class:`Trainer` runs epochs x ``steps_per_epoch`` train steps, an eval
pass after each epoch, one JSONL metrics row per epoch, and returns a
:class:`FitResult`.  Step metrics accumulate ON THE DEVICE (one small add
per step); the host synchronises only every ``log_every`` steps, at the
end of each epoch and, with the anomaly detector on, once a step, because
a per-step readback makes the host wait for the card every step and stops
it from queueing the next one.

With ``checkpoint_dir`` the trainer owns a :class:`..train.checkpoint.
Checkpointer` (``max_to_keep`` generations): it saves at every epoch end
and, with ``checkpoint_every_steps``, after every such true step, and
drains the background writes when the fit ends or raises.  With
``resume`` (the default) a fit first restores the newest verified
generation and continues from its step, mid-epoch included.  ``fit``
takes a batch iterator or a step-indexed factory ``f(start_step) ->
Iterator`` whose first batch is the one of true step ``start_step``: the
factory form makes a resumed run see exactly the batches an uninterrupted
one would, and with the per-step dropout generators of ``train.step``
(seeded from the step) a resumed run is bit-identical to one that never
stopped.

The resilience and observability layer (``TrainerConfig``'s fields say
what each does): a background input prefetch onto the parameters'
device (``prefetch``, on by default), the preemption guard with its
synchronous emergency checkpoint (``PreemptionError``, exit 75 under
``workloads._runner``), the anomaly detector with rollback to the newest
verified generation, the step watchdog (stacks, then exit 70), the
``DDLT_FAULTS`` hooks of :mod:`..utils.faults`, the tracer spans
``train/data_wait``, ``train/step``, ``train/checkpoint``, ``train/eval``
and ``train/emergency_checkpoint``, a per-epoch registry rollup
(``obs_metrics_path``), the goodput ledger (``goodput_path``), a
``torch.profiler`` window (``profile_dir``) and TensorBoard's scalars.
Data parallelism (``mesh=`` a process mesh, one process per device, as
the reference's multi-host trainer): every rank runs the loop over its
own batches; only the primary rank (world rank 0) writes the metrics rows,
TensorBoard's scalars, the registry snapshot and the profile, and logs
the epoch lines; ``global_batch_size`` is the world's, so images/s are
totals over the world; checkpoints are the checkpointer's collective
saves; :meth:`Trainer.evaluate` drains at most ``eval_buffer_batches``
batches, agrees on the smallest count over the ranks with one
all-gather and weights each batch by its rows.  A mesh with model axes
(fsdp, tensor) trains the same way: the ranks of one data shard see the
same batches, and a checkpoint holds the global arrays
(:mod:`.checkpoint`).

The scalars go to ``<tensorboard_dir>/scalars.jsonl`` as ``{"tag",
"value", "step"}`` rows (tensorboard is not installed where the port
runs: a departure from the reference).  With the goodput ledger on and a
card of known peak, the first step's model FLOPs are counted once
(``utils.hardware.step_flops``, as the reference's ``.lower()`` probe)
for the ledger's MFU column.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from distributeddeeplearning_tpu_torch.obs import goodput as goodput_mod
from distributeddeeplearning_tpu_torch.obs.goodput import GoodputLedger
from distributeddeeplearning_tpu_torch.obs.registry import get_registry
from distributeddeeplearning_tpu_torch.obs.trace import get_tracer
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.parallel.distributed import is_primary
from distributeddeeplearning_tpu_torch.parallel.mesh import (
    data_parallel_size,
    require_ported,
)
from distributeddeeplearning_tpu_torch.train.checkpoint import Checkpointer
from distributeddeeplearning_tpu_torch.train.resilience import (
    AnomalyDetector,
    AnomalyError,
    PreemptionError,
    PreemptionGuard,
    StepWatchdog,
)
from distributeddeeplearning_tpu_torch.train.state import tree_leaves
from distributeddeeplearning_tpu_torch.utils import faults as faults_mod
from distributeddeeplearning_tpu_torch.utils.retry import RateLimitedLogger, retry_call
from distributeddeeplearning_tpu_torch.utils.throughput import ExamplesPerSecondTracker

logger = logging.getLogger("ddlt.train")

#: the file under ``tensorboard_dir`` that takes TensorBoard's scalars
SCALARS_NAME = "scalars.jsonl"


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 90
    steps_per_epoch: int = 0
    eval_steps: Optional[int] = None  # None = drain the eval iterator
    global_batch_size: int = 0
    log_every: int = 100  # examples/sec cadence
    checkpoint_dir: Optional[str] = None
    # save after every N true steps too (besides each epoch end)
    checkpoint_every_steps: Optional[int] = None
    # TensorBoard's per-epoch scalars, as JSONL rows (module docstring)
    tensorboard_dir: Optional[str] = None
    # resume only matters with a checkpoint_dir, as in the reference
    resume: bool = True
    max_to_keep: int = 5
    # torch.profiler over steps [profile_start, profile_start +
    # profile_steps) of the fit, a chrome trace written into profile_dir
    profile_dir: Optional[str] = None
    profile_start: int = 10  # skip the build and warm-up steps
    profile_steps: int = 10
    metrics_path: Optional[str] = None  # per-epoch JSONL rows
    # input staging depth: a background thread copies the next N batches
    # to the parameters' device while the card runs this one
    # (utils/prefetch.py); 0 fetches synchronously
    prefetch: int = 2
    # caps the eval batches a multi-process eval buffers to agree on a
    # common count; read only by multi-process eval
    eval_buffer_batches: int = 4096
    # ---- resilience (train/resilience.py) ----
    # SIGTERM/SIGINT set a flag the loop checks each step; at the next
    # step boundary a synchronous emergency checkpoint is written and
    # PreemptionError raised.  None = on exactly when checkpoint_dir is set
    preemption_guard: Optional[bool] = None
    # seconds from SIGTERM to the platform's SIGKILL: the emergency
    # checkpoint's retries are bounded by what is left of it (None =
    # unknown window, unbounded retries)
    preemption_grace_s: Optional[float] = None
    # raise AnomalyError after this many CONSECUTIVE non-finite steps;
    # None = off.  One host sync a step; pair it with
    # build_train_step(skip_nonfinite=True) so the anomalous update is
    # also discarded on the device
    anomaly_max_consecutive: Optional[int] = None
    # on AnomalyError restore the newest verified generation and go on
    # (at most anomaly_max_rollbacks times a fit) instead of raising;
    # exact with the step-indexed factory form of the data
    anomaly_rollback: bool = False
    anomaly_max_rollbacks: int = 1
    # dump all-thread stacks and exit 70 when the gap between completed
    # steps exceeds this many seconds; armed from each epoch's first step,
    # disarmed across eval and checkpoints.  None = off
    step_deadline_s: Optional[float] = None
    # ---- observability (obs/) ----
    # a metrics-registry snapshot row appended here each epoch end
    obs_metrics_path: Optional[str] = None
    # goodput ledger: one restart-durable JSONL segment per fit attempt
    goodput_path: Optional[str] = None


class MetricsLog:
    """Append-only JSONL of per-epoch metric rows (local paths).  Writes go
    through the retry layer and the ``DDLT_FAULTS`` ``io_error`` hook (site
    ``metrics``); a row dropped after its retries is counted in
    ``dropped_rows`` and logged at most once a minute, and never stops
    training."""

    def __init__(self, path: Optional[str]):
        # rank 0 only, as the reference's
        self.path = path if (path and is_primary()) else None
        self.dropped_rows = 0
        self._drop_warn = RateLimitedLogger(logger.warning, min_interval_s=60.0)
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)

    def _write(self, line: str) -> None:
        faults_mod.get_plan().maybe_io_error("metrics")
        with open(self.path, "a") as f:
            f.write(line)

    def append(self, row: Dict[str, Any]) -> None:
        if not self.path:
            return
        try:
            retry_call(self._write, json.dumps(row) + "\n", retries=3,
                       base_delay=0.05, max_delay=2.0,
                       description=f"metrics append ({self.path})")
        except Exception as exc:  # noqa: BLE001 — storage must not stop training
            self.dropped_rows += 1
            self._drop_warn("metrics row dropped after retries (%s rows dropped "
                            "so far, path %s): %s", self.dropped_rows, self.path,
                            exc)


class TensorBoardLogger:
    """TensorBoard's per-epoch scalars as JSONL rows ``{"tag": "train/loss",
    "value": ..., "step": epoch}`` in ``<logdir>/scalars.jsonl`` (the
    reference's tags, values and steps; module docstring)."""

    def __init__(self, logdir: Optional[str]):
        logdir = logdir if is_primary() else None  # rank 0 only
        self.path = os.path.join(logdir, SCALARS_NAME) if logdir else None
        if logdir:
            os.makedirs(logdir, exist_ok=True)

    def scalars(self, tag_prefix: str, values: Dict[str, float], step: int) -> None:
        if self.path is None or not values:
            return
        with open(self.path, "a") as f:
            for name, value in values.items():
                f.write(json.dumps({"tag": f"{tag_prefix}/{name}",
                                    "value": float(value), "step": int(step)}) + "\n")


@dataclasses.dataclass
class FitResult:
    epochs_run: int
    final_train_metrics: Dict[str, float]
    final_eval_metrics: Optional[Dict[str, float]]
    total_images: int
    train_wall_seconds: float
    # non-finite steps whose update was skipped (those of attempts a
    # rollback abandoned included: the reference counts the last
    # attempt's only), and rollbacks taken
    anomalous_steps: int = 0
    rollbacks: int = 0

    @property
    def images_per_second(self) -> float:
        return self.total_images / max(self.train_wall_seconds, 1e-9)


def _sync(device: torch.device) -> None:
    """Wait for ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _ProfileWindow:
    """``torch.profiler`` over a window of steps; the chrome trace goes to
    ``<dir>/trace_steps_<first>_<last>.json`` (true steps)."""

    def __init__(self, directory: str, device: torch.device):
        self.directory = directory
        self.device = device
        self.first_step = None
        self._prof = None

    def start(self, true_step: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.first_step = true_step
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self, last_step: int) -> None:
        # the launches of the window's last step must land inside it
        _sync(self.device)
        self._prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory,
                            f"trace_steps_{self.first_step}_{last_step}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        logger.info("profiler trace written to %s", path)


def _drain_bounded(batches: Iterator, limit: Optional[int], cap: int) -> list:
    """Buffer up to ``limit`` batches, refusing to exceed ``cap`` — the
    multi-process eval drain's RAM guard (an eval split larger than
    expected must fail loudly, not swap the host)."""
    local: list = []
    for batch in batches:
        local.append(batch)
        if limit is not None and len(local) >= limit:
            break
        if len(local) > cap:
            raise RuntimeError(
                f"multi-host eval buffered more than eval_buffer_batches="
                f"{cap} batches on this host; set TrainerConfig.eval_steps "
                "to bound the eval pass, or raise eval_buffer_batches if "
                "the host has RAM for a larger eval split"
            )
    return local


class Trainer:
    def __init__(self, train_step: Callable, *,
                 eval_step: Optional[Callable] = None, config: TrainerConfig,
                 mesh=None):
        if config.steps_per_epoch <= 0:
            raise ValueError("steps_per_epoch must be positive")
        require_ported(mesh, "Trainer")
        self.train_step = train_step
        self.eval_step = eval_step
        self.config = config
        self.mesh = mesh
        self.primary = is_primary()
        self.tb = TensorBoardLogger(config.tensorboard_dir)
        self.metrics_log = MetricsLog(config.metrics_path)
        self.checkpointer = (
            Checkpointer(config.checkpoint_dir, max_to_keep=config.max_to_keep,
                         mesh=mesh)
            if config.checkpoint_dir else None)
        # no-op marks unless goodput_path is set; one segment per fit attempt
        self.goodput = GoodputLedger(config.goodput_path)
        self._flops_probed = False

    def _maybe_measure_flops(self, state, batch) -> None:
        """The MFU numerator, once (ref ``_maybe_measure_flops``): the
        model FLOPs of one step of the global batch (this rank's count
        times the data shards), fed into the goodput ledger.  Only tried
        with the ledger on and a card of known peak; any failure (a
        forward with collectives over model axes cannot be counted on
        ``meta``) leaves MFU omitted, never a crash."""
        if self._flops_probed or not self.goodput.enabled:
            return
        self._flops_probed = True
        try:
            from distributeddeeplearning_tpu_torch.utils.hardware import (
                peak_bf16_flops,
                step_flops,
            )

            if peak_bf16_flops() is None:
                return
            flops = step_flops(state, batch)
            if flops is not None and self.mesh is not None:
                flops *= data_parallel_size(self.mesh)
            self.goodput.set_flops_per_step(flops)
        except Exception:  # noqa: BLE001 — MFU is an optional column
            pass

    def fit(self, state, train_batches,
            eval_batches_factory: Optional[Callable[[], Iterator]] = None):
        """Run the epoch loop; returns ``(state, FitResult)``.
        ``train_batches`` is an iterator, or a factory ``f(start_step)`` of
        the stream from true step ``start_step`` on (module docstring)."""
        cfg = self.config
        plan = faults_mod.get_plan()
        factory = (train_batches if callable(train_batches)
                   and not hasattr(train_batches, "__next__") else None)
        stream = None if factory is not None else train_batches
        device = tree_leaves(state.params)[0].device

        use_guard = cfg.preemption_guard
        if use_guard is None:
            use_guard = self.checkpointer is not None
        guard = (PreemptionGuard(grace_s=cfg.preemption_grace_s).install()
                 if use_guard else None)
        if plan and guard is None and any(s.kind == "preempt" for s in plan.specs):
            logger.warning("DDLT_FAULTS contains a preempt fault but the "
                           "preemption guard is off (no checkpoint_dir?) — it "
                           "will not fire")
        detector = (AnomalyDetector(cfg.anomaly_max_consecutive)
                    if cfg.anomaly_max_consecutive else None)
        watchdog = (StepWatchdog(cfg.step_deadline_s).start()
                    if cfg.step_deadline_s else None)
        rollbacks = 0
        anomalous_before = 0  # in attempts a rollback abandoned
        # the train state on the process ledger by owner (params, optimizer
        # state, batch stats), read through ``self._obs_state``, which the
        # loop re-points at the live state every step; the ledger holds
        # the Trainer weakly
        self._obs_state = state
        self._register_hbm_owners()
        # the process ledger for the fit, so the checkpointer's notes land
        # in this fit's segments; restored in the outer finally
        prev_ledger = None
        if self.goodput.enabled:
            prev_ledger = goodput_mod.get_ledger()
            goodput_mod.set_ledger(self.goodput)
        try:
            while True:
                # one ledger segment per attempt (rollbacks included)
                self.goodput.begin()
                restored = None
                if self.checkpointer is not None and cfg.resume:
                    state, restored = self.checkpointer.restore(state)
                if restored is None:
                    # resumed nothing: a new run lineage in the ledger
                    self.goodput.fresh_start()
                else:
                    self.goodput.set_resumed_step(int(restored))
                    self._log("resuming from step %d (epoch %d, step %d "
                              "within it)", restored,
                              restored // cfg.steps_per_epoch,
                              restored % cfg.steps_per_epoch)
                start = int(restored or 0)
                batches = factory(start) if factory is not None else stream
                if plan:
                    batches = plan.wrap_data(batches, start_step=start)
                owned_prefetch = None
                if cfg.prefetch > 0:
                    from distributeddeeplearning_tpu_torch.utils.prefetch import (
                        prefetch_to_device,
                    )

                    batches = owned_prefetch = prefetch_to_device(
                        batches, device, size=cfg.prefetch)
                attempt_reason = "completed"
                try:
                    state, result = self._fit_inner(
                        state, batches, eval_batches_factory, start, device,
                        guard=guard, detector=detector, watchdog=watchdog,
                        plan=plan)
                    result.rollbacks = rollbacks
                    result.anomalous_steps += anomalous_before
                    return state, result
                except AnomalyError as exc:
                    # a handled exception is gone from sys.exc_info() in the
                    # finally below: stamp the segment's reason here
                    attempt_reason = type(exc).__name__
                    if watchdog is not None:
                        watchdog.pause()  # the restore is storage-bound
                    state = getattr(exc, "state", state)
                    # the VERIFIED step: rolling back into a corrupt
                    # generation would trade a diverging run for a dead one.
                    # A generation is certified when its write has landed:
                    # drain the one in flight first
                    rollback_to = None
                    if self.checkpointer is not None:
                        self.checkpointer.wait()
                        self.goodput.mark("checkpoint_blocking")
                        rollback_to = self.checkpointer.latest_verified_step()
                    if not (cfg.anomaly_rollback and cfg.resume
                            and rollback_to is not None
                            and rollbacks < cfg.anomaly_max_rollbacks):
                        raise
                    rollbacks += 1
                    anomalous_before += getattr(exc, "anomalous_steps", 0)
                    detector = AnomalyDetector(cfg.anomaly_max_consecutive)
                    get_tracer().event("resilience/rollback", cat="resilience",
                                       step=exc.step, to_step=rollback_to)
                    logger.warning("anomaly abort at step %s — rolling back to "
                                   "checkpoint step %s (%d/%d rollbacks)",
                                   exc.step, rollback_to, rollbacks,
                                   cfg.anomaly_max_rollbacks)
                finally:
                    if owned_prefetch is not None:
                        owned_prefetch.close()
                    if self.checkpointer is not None:
                        # the snapshots are on the host already: land them,
                        # and certify them, whatever happened in the loop
                        self.checkpointer.wait()
                        self.goodput.mark("checkpoint_blocking")
                    exc_type = sys.exc_info()[0]
                    self.goodput.end(reason=attempt_reason if exc_type is None
                                     else exc_type.__name__)
        finally:
            if watchdog is not None:
                watchdog.stop()
            if guard is not None:
                guard.uninstall()
            if prev_ledger is not None:
                goodput_mod.set_ledger(prev_ledger)

    def _log(self, *args) -> None:
        """``logger.info`` on the primary rank only."""
        if self.primary:
            logger.info(*args)

    def _register_hbm_owners(self) -> None:
        """Register the train state's leaves on the process ledger
        (``obs/ledger.py``) under ``params`` / ``opt_state`` /
        ``batch_stats``; once per Trainer."""
        if getattr(self, "_hbm_registered", False):
            return
        self._hbm_registered = True
        from distributeddeeplearning_tpu_torch.obs.ledger import get_ledger

        ledger = get_ledger()
        for owner in ("params", "opt_state", "batch_stats"):
            ledger.register(owner, self, lambda trainer, attr=owner: getattr(
                getattr(trainer, "_obs_state", None), attr, None))

    def _emergency_stop(self, step: int, state, watchdog, guard) -> None:
        """Preemption noticed at a step boundary: synchronous emergency
        checkpoint, then PreemptionError (exit 75 under the runner)."""
        if watchdog is not None:
            watchdog.pause()
        get_tracer().event("resilience/preempted", cat="resilience", step=step)
        if self.checkpointer is not None:
            logger.warning("preemption at step %d — writing emergency "
                           "checkpoint", step)
            # save() snapshots to the host, wait() lands the write: both
            # before the resumable exit, each bounded by what is left of
            # the grace window (re-read: save may have used most of it)
            self.goodput.mark("other")
            with get_tracer().span("train/emergency_checkpoint",
                                   cat="resilience", step=step):
                self.checkpointer.save(step, state,
                                       deadline_s=guard.remaining_grace())
                self.checkpointer.wait(deadline_s=guard.remaining_grace())
            self.goodput.mark("checkpoint_blocking")
            logger.warning("emergency checkpoint at step %d complete", step)
        raise PreemptionError(
            f"preempted at step {step} (emergency checkpoint "
            f"{'written' if self.checkpointer is not None else 'UNAVAILABLE'})",
            step=step)

    def _fit_inner(self, state, train_batches: Iterator, eval_batches_factory,
                   start: int, device: torch.device, *, guard=None,
                   detector=None, watchdog=None, plan=None):
        cfg = self.config
        trace = get_tracer()
        start_epoch, start_step_in_epoch = divmod(start, cfg.steps_per_epoch)
        # everything since the segment's begin() (restore, stream and
        # prefetch set-up) is recovery work, not training
        self.goodput.mark("recovery")
        tracker = ExamplesPerSecondTracker(global_batch_size=cfg.global_batch_size,
                                           every_n_steps=cfg.log_every,
                                           report=self._log)
        tracker.begin()
        train_t0 = time.monotonic()
        total_images = 0
        train_metrics: Dict[str, float] = {}
        eval_metrics: Optional[Dict[str, float]] = None
        window = None
        profile_pending = cfg.profile_dir is not None and self.primary
        total_steps = (cfg.epochs - start_epoch) * cfg.steps_per_epoch - start_step_in_epoch
        profile_start = cfg.profile_start
        if profile_pending and total_steps <= cfg.profile_start:
            logger.warning("profile_dir set but the run has only %d steps (< "
                           "profile_start %d) — starting the trace at step 0",
                           total_steps, cfg.profile_start)
            profile_start = 0
        global_step = 0
        anomalous_total = 0

        for epoch in range(start_epoch, cfg.epochs):
            acc = None
            epoch_t0 = time.monotonic()
            first_step = start_step_in_epoch if epoch == start_epoch else 0
            steps_this_epoch = cfg.steps_per_epoch - first_step
            anomalous_this_epoch = 0
            for step_i in range(first_step, cfg.steps_per_epoch):
                true_step = epoch * cfg.steps_per_epoch + step_i + 1
                if profile_pending and global_step >= profile_start:
                    window = _ProfileWindow(cfg.profile_dir, device)
                    window.start(true_step)
                    profile_pending = False
                with trace.span("train/data_wait", step=true_step):
                    batch = next(train_batches)
                self.goodput.mark("data_wait")
                if plan:
                    batch = plan.poison_batch(true_step, batch)
                with trace.span("train/step", step=true_step):
                    if global_step == 0:
                        self._maybe_measure_flops(state, batch)
                    state, metrics = self.train_step(state, batch)
                self._obs_state = state  # one attribute store, no walk
                anomalous = False
                if detector is not None:
                    # one host sync a step: the price of reacting to a
                    # diverging run before it wastes the rest of the epoch
                    gn = metrics.get("grad_norm")
                    flagged = metrics.get("anomalous")
                    try:
                        anomalous = detector.observe(
                            true_step, float(metrics["loss"]),
                            float(gn) if gn is not None else None,
                            flagged=bool(float(flagged)) if flagged is not None else None)
                    except AnomalyError as exc:
                        exc.state = state  # the restore template of a rollback
                        exc.anomalous_steps = anomalous_total + 1
                        # the aborted step ran: its wall is a step's, and a
                        # rollback's replay of it is redone work
                        self.goodput.mark_step(true_step)
                        raise
                if anomalous:
                    # NaN metrics must not poison the epoch accumulator (the
                    # update itself was skipped with skip_nonfinite=True)
                    anomalous_this_epoch += 1
                    anomalous_total += 1
                else:
                    acc = metrics if acc is None else {
                        k: acc[k] + v for k, v in metrics.items()}
                if (step_i + 1) % cfg.log_every == 0:
                    _sync(device)
                # the step's wall (launches, the detector's and the log
                # boundary's syncs) to compile / step_redone / step_productive
                self.goodput.mark_step(true_step)
                tracker.after_step()
                if watchdog is not None:
                    watchdog.tick(true_step)
                total_images += cfg.global_batch_size
                global_step += 1
                if window is not None and global_step >= profile_start + cfg.profile_steps:
                    window.stop(true_step)
                    window = None
                if (self.checkpointer is not None and cfg.checkpoint_every_steps
                        and true_step % cfg.checkpoint_every_steps == 0):
                    if watchdog is not None:
                        # storage-bound: save() can wait on the previous
                        # write; the next step's tick re-arms
                        watchdog.pause()
                    with trace.span("train/checkpoint", step=true_step):
                        self.checkpointer.save(true_step, state)
                    self.goodput.mark("checkpoint_blocking")
                if guard is not None:
                    if plan:
                        plan.maybe_preempt(true_step, guard)
                    if guard.preempted():
                        self._emergency_stop(true_step, state, watchdog, guard)
            if window is not None:
                # a run shorter than the window: close it on step work only
                window.stop(true_step)
                window = None
            if watchdog is not None:
                # eval and checkpoints below take storage-dependent time; the
                # next epoch's first step re-arms
                watchdog.pause()
            counted_steps = steps_this_epoch - anomalous_this_epoch
            train_metrics = ({k: float(v) / counted_steps for k, v in acc.items()}
                             if acc is not None and counted_steps > 0 else {})
            if anomalous_this_epoch:
                train_metrics["anomalous_steps"] = float(anomalous_this_epoch)
            # this epoch's train wall (the reads above synced): eval and the
            # checkpoint below are left out
            epoch_train_wall = time.monotonic() - epoch_t0
            self._log("epoch %d/%d: %s", epoch + 1, cfg.epochs,
                      {k: round(v, 4) for k, v in train_metrics.items()})
            self.tb.scalars("train", train_metrics, epoch)
            self.goodput.mark("other")
            if self.eval_step is not None and eval_batches_factory is not None:
                with trace.span("train/eval", epoch=epoch + 1):
                    eval_metrics = self.evaluate(state, eval_batches_factory())
                self.goodput.mark("eval")
                self._log("epoch %d validation: %s", epoch + 1,
                          {k: round(v, 4) for k, v in eval_metrics.items()})
                self.tb.scalars("val", eval_metrics, epoch)
            row: Dict[str, Any] = {"epoch": epoch + 1}
            row.update({f"train_{k}": v for k, v in train_metrics.items()})
            if eval_metrics:
                row.update({f"val_{k}": v for k, v in eval_metrics.items()})
            row["images_per_second"] = (
                steps_this_epoch * cfg.global_batch_size) / max(epoch_train_wall, 1e-9)
            if epoch == start_epoch:
                # the first epoch's wall includes the kernels' build or load
                # and the CUDA libraries' first-call warm-up
                row["includes_compile"] = True
            self.metrics_log.append(row)
            # the per-epoch rollup into the process registry (never per step)
            reg = get_registry()
            reg.counter("train.steps").inc(steps_this_epoch)
            reg.counter("train.epochs").inc()
            if anomalous_this_epoch:
                reg.counter("train.anomalous_steps").inc(anomalous_this_epoch)
            reg.gauge("train.images_per_second").set(row["images_per_second"])
            if "loss" in train_metrics:
                reg.gauge("train.loss").set(train_metrics["loss"])
            reg.histogram("train.epoch_train_wall_s").record(epoch_train_wall)
            if cfg.obs_metrics_path and self.primary:
                reg.write_snapshot(cfg.obs_metrics_path, epoch=epoch + 1)
            if self.checkpointer is not None:
                self.goodput.mark("other")
                end_step = (epoch + 1) * cfg.steps_per_epoch
                with trace.span("train/checkpoint", step=end_step):
                    self.checkpointer.save(end_step, state)
                self.goodput.mark("checkpoint_blocking")

        wall = time.monotonic() - train_t0
        if self.checkpointer is not None:
            self.checkpointer.wait()
        result = FitResult(
            epochs_run=max(cfg.epochs - start_epoch, 0),
            final_train_metrics=train_metrics,
            final_eval_metrics=eval_metrics,
            total_images=total_images,
            train_wall_seconds=wall,
            anomalous_steps=anomalous_total,
        )
        if total_images:
            self._log("total images/sec: %.2f", result.images_per_second)
            self._log("batch size: %d (global)", cfg.global_batch_size)
        return state, result

    def evaluate(self, state, eval_batches: Iterator) -> Dict[str, float]:
        """Size-weighted mean of the eval metrics over the batches (at most
        ``eval_steps``); sums stay on the device until the final read.

        Over several ranks each rank's eval stream may yield another
        number of batches, and a rank with extra batches would enter the
        eval step's collectives alone and hang: the ranks agree ONCE a pass
        on a common count (each drains at most ``eval_buffer_batches``
        batches, one all-gather takes the minimum) and each runs exactly
        that many.  A batch weighs its rows over the data shards (the
        eval step's metrics are the global batch's means; the ranks of one
        shard hold the same rows and are counted once)."""
        limit = self.config.eval_steps
        group = None if self.mesh is None else self.mesh.group
        rows = None
        if group is not None:
            local = _drain_bounded(eval_batches, limit,
                                   self.config.eval_buffer_batches)
            counts = collectives.all_gather_object(
                [len(next(iter(b.values()))) for b in local], group)
            limit = min(len(c) for c in counts)
            copies = self.mesh.size // data_parallel_size(self.mesh)
            rows = [sum(c[i] for c in counts) // copies for i in range(limit)]
            eval_batches = iter(local[:limit])
        sums: Dict[str, torch.Tensor] = {}
        total_weight = steps = 0
        for batch in eval_batches:
            if limit is not None and steps >= limit:
                break
            size = (len(next(iter(batch.values()))) if rows is None
                    else rows[steps])
            for k, v in self.eval_step(state, batch).items():
                sums[k] = v * size if k not in sums else sums[k] + v * size
            total_weight += size
            steps += 1
        if not sums or total_weight == 0:
            return {}
        return {k: float(v) / total_weight for k, v in sums.items()}
