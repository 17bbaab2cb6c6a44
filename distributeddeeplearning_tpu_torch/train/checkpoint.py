"""Durable, verified checkpoints of a ``TrainState`` — the port of
``train/checkpoint.py``, in the port's own format (the reference writes
with orbax, which is JAX's).

A generation is a directory ``<dir>/<step>/`` holding two items, as the
reference's: ``params`` (what serving reads) and ``state`` (``step``,
``opt_state``, ``batch_stats``).  Each item is one ``data.bin`` of the
leaves' raw bytes, C order, one after the other (bf16 as its 2-byte
words), and an ``index.json`` naming each leaf (its key path in
``jax.tree_util.keystr``'s ``['a']['b']`` form, dict keys sorted), dtype,
shape, offset and size.  Leaves keep the port's layout (a conv kernel is
OIHW), so a tree without 4-D conv kernels -- BERT, the LM, ViT but for its
patch embedding -- hashes as the reference's does.

Storage is not trusted:

- **async, private snapshot**: :meth:`Checkpointer.save` copies every leaf
  to host memory before it returns (the port's optimizers update params
  in place, so a view would write a later step), then a background
  thread checksums the copy and writes it into a ``<step>.tmp-*``
  directory, fsyncs it and renames it to ``<step>``; saves are serialised
  (a save first drains the previous one);
- **manifest**: per leaf shape, dtype and CRC32 of its bytes (what the
  reference hashes, ``np.ascontiguousarray(leaf)``), over both items,
  written atomically (tmp + rename) into the generation only once its
  data has landed: at :meth:`Checkpointer.wait` or the next save.  A
  generation without a valid manifest is never restore-eligible;
- **corruption-tolerant restore**: :meth:`Checkpointer.restore` walks the
  generations newest-first, reads and verifies each against its manifest
  and falls back past any that fails, evicting it (a dead generation
  left in place would keep its step from being saved again), and copies
  the first that verifies into the template's tensors;
  :meth:`Checkpointer.restore_params` reads the ``params`` item alone and
  never evicts; :class:`CheckpointCorruptionError` when no generation
  verifies;
- ``max_to_keep`` evicts the oldest committed generations;
- :func:`corrupt_generation` (flip, truncate, unlink, manifest) and
  :func:`latest_verified_step_in_dir` for tests and chaos runs.

Transient failures are retried with :func:`..utils.retry.retry_call`'s
bounded backoff: the background write, and the synchronous halves of
:meth:`Checkpointer.save` and :meth:`Checkpointer.wait`, which take
``deadline_s`` (the emergency checkpoint passes what is left of the
preemption grace window, so no backoff sleeps past the kill).  The
``DDLT_FAULTS`` sites (:mod:`..utils.faults`) are the reference's:
``io_error`` at ``checkpoint.save`` and ``checkpoint.wait``; ``ckpt_torn``
at a generation's commit (its largest ``data.bin`` truncated, no manifest
written); ``ckpt_corrupt:mode=flip|truncate|unlink|manifest`` right after
a generation's manifest lands (:func:`corrupt_generation`).  The walls ``save_wall_s`` (what ``save`` blocks, the
drain of the previous write included), ``snapshot_wall_s`` (the host copy,
inside it), ``verify_wall_s`` (waits for a generation's checksums at
commit, and the checks at restore), ``write_wait_s`` (waits for its data
to land, after its checksums) and ``verify_cpu_s`` (the background
checksum work) accumulate per checkpointer, and the process goodput
ledger gets ``ckpt_save_block_s`` / ``ckpt_wait_block_s`` notes.  There
is no pre-manifest legacy layout.

Data parallelism (``mesh=`` a process mesh of more than one rank): every
rank calls ``save``, ``wait`` and ``restore`` together.  Rank 0 decides
whether a step is saved and writes the generation; the other ranks write
nothing.  A state in the comm layout (``parallel/comms.py``) holds
per-rank blocks (:class:`..parallel.comms.RankShards`: weight-update
shards and error-feedback residuals) that differ from rank to rank: a
save all-gathers them to their global vectors (the reference's global
arrays) and records their world as ``state/['comm_world']``; a restore
on the same world size hands each rank its own block; a restore on
another world size raises (the reference re-lays-out through orbax;
ROADMAP A5.4).  A state laid out over model axes (``TrainState.layout``,
fsdp and tensor slices of the params and of the optimizer moments that
mirror them) is saved the same way: a save gathers each split leaf to
its global array, in the reference's layout (``qkv``'s columns in its
q, k, v order), and records the mesh's axis sizes as
``state/['mesh']``, so the generation holds the arrays a one-process fit
would; a restore on the same mesh hands each rank its slice, and one on
another mesh raises (A5.4).  ``wait`` ends with a barrier, so a restore
reads landed generations, and only rank 0 evicts, after every rank has
read.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
import uuid
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.obs import goodput as _goodput
from distributeddeeplearning_tpu_torch.obs.trace import get_tracer
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.parallel.comms import (
    RankShards,
    map_params_subtrees,
    tree_structure,
)
from distributeddeeplearning_tpu_torch.parallel.mesh import AXIS_ORDER
from distributeddeeplearning_tpu_torch.parallel.sharding import local_slice
from distributeddeeplearning_tpu_torch.train.state import is_sequence_node
from distributeddeeplearning_tpu_torch.utils import faults as faults_mod
from distributeddeeplearning_tpu_torch.utils.retry import retry_call

logger = logging.getLogger("ddlt.checkpoint")

#: per-generation content manifest, written into the finalized step dir
MANIFEST_NAME = "ddlt_manifest.json"
#: directory-level marker, written with the first manifest
DURABLE_MARKER = "ddlt_durable.json"
MANIFEST_FORMAT = 1
ITEMS = ("params", "state")
DATA_NAME = "data.bin"
INDEX_NAME = "index.json"
CORRUPT_MODES = ("flip", "truncate", "unlink", "manifest")

Leaves = List[Tuple[str, torch.Tensor]]


class CheckpointCorruptionError(RuntimeError):
    """Generations exist but none verifies: nothing left to fall back to."""


class _Block:
    """A restore template's rank block: ``tensor`` is block ``rank`` of a
    global vector of ``world`` blocks."""

    def __init__(self, tensor: torch.Tensor, rank: int, world: int):
        self.tensor, self.rank, self.world = tensor, rank, world
        self.shape = torch.Size([tensor.shape[0] * world])
        self.dtype = tensor.dtype

    def part(self, whole: torch.Tensor) -> torch.Tensor:
        n = self.tensor.shape[0]
        return whole[self.rank * n:(self.rank + 1) * n]


class _Slice(_Block):
    """A restore template's slice of a leaf laid out by a ``ParamLayout``:
    ``tensor`` is this rank's slice of a global array of ``shape``."""

    def __init__(self, tensor: torch.Tensor, name: str, layout):
        self.tensor, self.name, self.layout = tensor, name, layout
        self.spec = layout.specs[name]
        self.head_aligned = layout.head_aligned(name)
        shape = list(tensor.shape)
        for i, entry in enumerate(self.spec):
            for ax in (() if entry is None else (entry,) if isinstance(entry, str)
                       else entry):
                shape[i] *= layout.mesh.shape.get(ax, 1)
        self.shape = torch.Size(shape)
        self.dtype = tensor.dtype

    def part(self, whole: torch.Tensor) -> torch.Tensor:
        return local_slice(whole, self.spec, self.layout.mesh,
                           head_aligned=self.head_aligned)


def _layout(state):
    """The state's ``ParamLayout`` when it splits a leaf, else None."""
    layout = getattr(state, "layout", None)
    return layout if layout is not None and layout.sharded else None


def _mesh_record(layout) -> torch.Tensor:
    """The mesh's axis sizes in ``AXIS_ORDER``, as a checkpoint leaf."""
    return torch.tensor([layout.mesh.shape.get(a, 1) for a in AXIS_ORDER],
                        dtype=torch.int32)


def _rank_blocks(tree, fn):
    """``tree`` with every :class:`..parallel.comms.RankShards` mapped by
    ``fn`` (dicts, tuples and lists rebuilt around them)."""
    if isinstance(tree, RankShards):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _rank_blocks(v, fn) for k, v in tree.items()}
    if is_sequence_node(tree):
        return tuple(_rank_blocks(v, fn) for v in tree)
    return tree


def _comm_world(tree) -> Optional[int]:
    """The world of the tree's rank blocks (None when it has none)."""
    worlds = []
    _rank_blocks(tree, lambda shards: worlds.append(shards.world) or shards)
    return worlds[0] if worlds else None


# -- leaves -------------------------------------------------------------------

def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


def _path(key: str) -> List[str]:
    return _KEY.findall(key)


def flatten(tree, path=()) -> Leaves:
    """``(keystr, tensor)`` of every leaf, dict keys sorted as jax flattens
    them, tuple and list entries in order (``[0]``); a Python int or float
    leaf becomes a 0-d tensor (int32 for an int, as the reference's step).
    A :class:`_Block` (restore's view of a rank's block) stays as it is."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k], path + (k,))]
    if is_sequence_node(tree):
        return [kv for i, v in enumerate(tree) for kv in flatten(v, path + (i,))]
    if not isinstance(tree, (torch.Tensor, _Block)):
        tree = torch.tensor(tree, dtype=torch.int32 if isinstance(tree, int)
                            else torch.float32)
    return [(keystr(path), tree)]


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The nested dict of ``{keystr: leaf}``."""
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        *head, last = _path(key)
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _raw(t: torch.Tensor) -> np.ndarray:
    """The C-order bytes of a contiguous host tensor, as a uint8 array."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _snapshot(tree) -> Leaves:
    """PRIVATE host copies of every leaf, row-major: written and hashed in
    the background while training goes on updating the originals."""
    return [(k, t.detach().to("cpu", copy=True).contiguous())
            for k, t in flatten(tree)]


def _entries(prefix: str, leaves: Leaves) -> Dict[str, Dict[str, Any]]:
    """``"<item>/<keystr>" -> {shape, dtype, crc32}`` of every leaf."""
    out = {}
    for key, t in leaves:
        if t.device.type != "cpu" or not t.is_contiguous():
            t = t.detach().to("cpu").contiguous()
        out[f"{prefix}{key}"] = {"shape": list(t.shape), "dtype": _dtype_name(t),
                                 "crc32": zlib.crc32(_raw(t))}
    return out


def _flat_items(items: Dict[str, Any]) -> Dict[str, Leaves]:
    return {name: tree if isinstance(tree, list) else flatten(tree)
            for name, tree in items.items()}


def build_manifest(step: int, items: Dict[str, Any]) -> Dict[str, Any]:
    """Content manifest over a generation's items (trees of tensors, or
    their :func:`flatten` lists)."""
    flat = _flat_items(items)
    leaves: Dict[str, Dict[str, Any]] = {}
    for name in sorted(flat):
        leaves.update(_entries(f"{name}/", flat[name]))
    return {"format": MANIFEST_FORMAT, "step": int(step),
            "created_unix_s": time.time(), "items": sorted(flat),
            "leaves": leaves}


def verify_manifest(manifest: Dict[str, Any], items: Dict[str, Any]) -> List[str]:
    """Problems of ``items`` against their manifest entries (empty:
    verified).  Only the items given are checked, but each must cover its
    entries exactly: a missing or extra leaf is corruption."""
    expected = manifest.get("leaves")
    if not isinstance(expected, dict) or not expected:
        return ["manifest carries no leaf entries"]
    flat = _flat_items(items)
    got: Dict[str, Dict[str, Any]] = {}
    for name in sorted(flat):
        got.update(_entries(f"{name}/", flat[name]))
    prefixes = tuple(f"{name}/" for name in flat)
    problems = []
    for name, entry in sorted(expected.items()):
        if not name.startswith(prefixes):
            continue  # an item this read did not take
        actual = got.pop(name, None)
        if actual is None:
            problems.append(f"leaf {name} missing from the restored tree")
        elif actual != entry:
            problems.append(f"leaf {name} mismatch (manifest {entry}, "
                            f"restored {actual})")
    problems.extend(f"restored leaf {name} not named by the manifest"
                    for name in sorted(got))
    return problems


def _atomic_write_json(path: Path, payload: Dict[str, Any]) -> None:
    """Write-then-rename, so a reader never sees a torn file."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_manifest(step_dir) -> Optional[Dict[str, Any]]:
    """The generation's manifest, or None when it is missing, unreadable or
    malformed (each means: not restore-eligible)."""
    try:
        with open(Path(step_dir) / MANIFEST_NAME) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if (not isinstance(manifest, dict)
            or manifest.get("format") != MANIFEST_FORMAT
            or not isinstance(manifest.get("leaves"), dict)
            or not manifest["leaves"]):
        return None
    return manifest


# -- the data files -------------------------------------------------------------

def _write_item(item_dir: Path, leaves: Leaves) -> None:
    item_dir.mkdir(parents=True, exist_ok=True)
    index, offset = [], 0
    with open(item_dir / DATA_NAME, "wb") as f:
        for key, t in leaves:
            raw = _raw(t)
            f.write(raw.tobytes() if raw.size else b"")
            index.append({"key": key, "dtype": _dtype_name(t),
                          "shape": list(t.shape), "offset": offset,
                          "nbytes": int(raw.size)})
            offset += int(raw.size)
        f.flush()
        os.fsync(f.fileno())
    _atomic_write_json(item_dir / INDEX_NAME, {"leaves": index})


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def read_item(item_dir) -> Dict[str, torch.Tensor]:
    """``{keystr: CPU tensor}`` of one item; raises on a missing or short
    file."""
    item_dir = Path(item_dir)
    with open(item_dir / INDEX_NAME) as f:
        index = json.load(f)["leaves"]
    data = np.fromfile(item_dir / DATA_NAME, dtype=np.uint8)
    out = {}
    for e in index:
        end = e["offset"] + e["nbytes"]
        if end > data.size:
            raise OSError(f"{item_dir / DATA_NAME}: {data.size} bytes, leaf "
                          f"{e['key']} ends at {end}")
        dtype = getattr(torch, e["dtype"])
        chunk = torch.from_numpy(data[e["offset"]:end].copy())
        out[e["key"]] = chunk.view(dtype).reshape(e["shape"])
    return out


def _data_files(step_dir: Path) -> List[Path]:
    """The generation's data files, largest first (path tiebreak): the
    corruption targets."""
    files = [p for p in sorted(Path(step_dir).rglob(DATA_NAME)) if p.is_file()]
    return sorted(files, key=lambda p: (-p.stat().st_size, str(p)))


def corrupt_generation(step_dir, mode: str = "flip") -> str:
    """Corrupt one finalized generation on purpose (tests and chaos runs):
    ``flip`` one byte in the middle of the largest data file, ``truncate``
    it to half, ``unlink`` it, or delete the ``manifest``.  Returns what
    was done."""
    step_dir = Path(step_dir)
    if mode not in CORRUPT_MODES:
        raise ValueError(f"unknown corruption mode {mode!r}; known: {CORRUPT_MODES}")
    if mode == "manifest":
        (step_dir / MANIFEST_NAME).unlink(missing_ok=True)
        return f"unlinked {MANIFEST_NAME}"
    targets = _data_files(step_dir)
    if not targets:
        raise FileNotFoundError(f"no data files under {step_dir}")
    target = targets[0]
    size = target.stat().st_size
    if mode == "unlink":
        target.unlink()
        return f"unlinked {target}"
    if mode == "truncate":
        with open(target, "r+b") as f:
            f.truncate(size // 2)
        return f"truncated {target} {size} -> {size // 2} bytes"
    with open(target, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(size // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    return f"flipped byte {size // 2} of {target}"


def _step_dirs(directory: Path) -> List[int]:
    if not directory.exists():
        return []
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.name.isdigit() and p.is_dir())


def latest_verified_step_in_dir(directory) -> Optional[int]:
    """Newest step whose generation carries a valid manifest, without a
    :class:`Checkpointer`; None when there is none."""
    directory = Path(directory)
    for step in reversed(_step_dirs(directory)):
        if load_manifest(directory / str(step)) is not None:
            return step
    return None


# -- the checkpointer --------------------------------------------------------------

class _PendingGeneration:
    """One generation being checksummed and written in the background from
    its host snapshot."""

    def __init__(self, directory: Path, step: int, snapshot: Dict[str, Leaves],
                 deadline_s: Optional[float] = None):
        self.step = step
        self.manifest: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None
        self.cpu_s = 0.0
        self.joined = False
        self.checksummed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(directory, step, snapshot, deadline_s),
            name=f"ddlt-ckpt-{step}", daemon=True)
        self._thread.start()

    def _run(self, directory: Path, step: int, snapshot: Dict[str, Leaves],
             deadline_s: Optional[float]) -> None:
        try:
            t0 = time.perf_counter()
            try:
                manifest = build_manifest(step, snapshot)
            finally:
                self.cpu_s = time.perf_counter() - t0
                self.checksummed.set()

            def write() -> None:
                tmp = directory / f"{step}.tmp-{uuid.uuid4().hex[:8]}"
                try:
                    for name, leaves in snapshot.items():
                        _write_item(tmp / name, leaves)
                    final = directory / str(step)
                    if final.exists():
                        shutil.rmtree(final)
                    os.replace(tmp, final)
                    _fsync_dir(directory)
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)

            retry_call(write, retries=2, base_delay=0.2, max_delay=2.0,
                       description=f"checkpoint write (step {step})",
                       deadline_s=deadline_s)
            self.manifest = manifest
        except Exception as exc:  # noqa: BLE001 — raised again at commit
            self.error = exc

    def join(self) -> None:
        self._thread.join()


class Checkpointer:
    """Step-granular checkpointing of a ``train.state.TrainState`` (module
    docstring).  ``restore`` copies into the template's tensors: the
    optimizer, the model function and the devices come from the template."""

    def __init__(self, directory: str, *, max_to_keep: int = 5, mesh=None):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        # the group every rank saves and restores with (module docstring)
        self.group = None if mesh is None else mesh.group
        self.primary = mesh is None or mesh.rank == 0
        self._pending: Dict[int, _PendingGeneration] = {}
        self.save_wall_s = 0.0
        self.snapshot_wall_s = 0.0
        self.verify_wall_s = 0.0
        self.verify_cpu_s = 0.0
        self.write_wait_s = 0.0

    @staticmethod
    def _state_items(state, blocks=None, leaves=None) -> Dict[str, Any]:
        """The two items of ``state``; ``blocks`` maps its rank blocks
        (all-gathered to global vectors for a save, :class:`_Block`
        views for a restore) and ``leaves(tree)`` its param-shaped trees
        under a sharded layout (gathered to global arrays for a save,
        :class:`_Slice` views for a restore)."""
        opt = state.opt_state
        world = _comm_world(opt)
        params = state.params
        out = {"step": int(state.step), "opt_state": opt,
               "batch_stats": state.batch_stats}
        if world is not None:
            out["opt_state"] = _rank_blocks(opt, blocks) if blocks else opt
            out["comm_world"] = world
        layout = _layout(state)
        if layout is not None:
            if leaves is not None:
                params = leaves(params)
                out["opt_state"] = map_params_subtrees(
                    opt, tree_structure(state.params), leaves, lambda leaf: leaf)
            out["mesh"] = _mesh_record(layout)
        return {"params": params, "state": out}

    def _gathered_items(self, state) -> Dict[str, Any]:
        layout = _layout(state)
        return self._state_items(
            state, lambda shards: tuple(
                collectives.all_gather(t.detach(), shards.group) for t in shards),
            None if layout is None else layout.gather)

    def _agree(self, value):
        """Rank 0's ``value`` on every rank."""
        if self.group is None:
            return value
        return collectives.broadcast_object(value, 0, self.group)

    def _barrier(self) -> None:
        if self.group is not None:
            collectives.barrier(self.group)

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(step)

    # -- saving ----------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        """Newest step saved or being saved (storage-trusting; a resume
        decision takes :meth:`latest_verified_step`)."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(set(_step_dirs(self.directory)) | set(self._pending))

    def save(self, step: int, state, *, deadline_s: Optional[float] = None) -> bool:
        """Snapshot ``state`` to host memory and write it in the background
        as generation ``step``; returns False (and saves nothing) for a
        step at or below the newest one saved (an epoch end that a
        ``checkpoint_every_steps`` save already took).  The previous
        generation is drained and its manifest committed first.  Transient
        failures of the snapshot-and-start retry, bounded by
        ``deadline_s`` on the wall clock (the background write takes the
        same bound)."""
        latest = self.latest_step()
        if not self._agree(latest is None or step > latest):
            return False
        t0 = time.perf_counter()
        with get_tracer().span("ckpt/save", step=step):
            # every rank joins the gather of the rank blocks; rank 0 writes
            items = (self._gathered_items(state)
                     if _comm_world(state.opt_state) or _layout(state)
                     else self._state_items(state))
            if not self.primary:
                return True
            self._commit()  # one write in flight at a time

            def start() -> None:
                faults_mod.get_plan().maybe_io_error("checkpoint.save")
                v0 = time.perf_counter()
                snapshot = {name: _snapshot(tree) for name, tree in items.items()}
                self.snapshot_wall_s += time.perf_counter() - v0
                self._pending[step] = _PendingGeneration(
                    self.directory, step, snapshot, deadline_s)

            retry_call(start, retries=2, base_delay=0.2, max_delay=2.0,
                       description=f"checkpoint save (step {step})",
                       deadline_s=deadline_s)
        blocked = time.perf_counter() - t0
        self.save_wall_s += blocked
        # detail under the trainer's checkpoint_blocking marks, never part
        # of the ledger's wall sum
        _goodput.get_ledger().note("ckpt_save_block_s", blocked)
        logger.info("checkpoint step %d -> %s (writing in the background)",
                    step, self.directory)
        return True

    def _join(self) -> None:
        """Wait for every pending write (idempotent: a retried wait does
        not count a generation's walls twice)."""
        for step in sorted(self._pending):
            pending = self._pending[step]
            if pending.joined:
                continue
            v0 = time.perf_counter()
            pending.checksummed.wait()
            w0 = time.perf_counter()
            pending.join()
            pending.joined = True
            self.verify_wall_s += w0 - v0
            self.write_wait_s += time.perf_counter() - w0
            self.verify_cpu_s += pending.cpu_s

    def _finalize(self) -> None:
        """Commit the manifests of the joined writes that landed, firing the
        ``ckpt_torn`` / ``ckpt_corrupt`` faults there; then evict past
        ``max_to_keep``.  A write that failed after its retries raises
        here."""
        plan = faults_mod.get_plan()
        failed = None
        for step in sorted(self._pending):
            pending = self._pending.pop(step)
            if pending.error is not None:
                logger.error("checkpoint step %d was not written: %s", step,
                             pending.error)
                failed = failed or pending.error
                continue
            step_dir = self._step_dir(step)
            if plan and plan.take_ckpt_torn():
                # the writer "died" mid-generation: data torn, no manifest
                logger.warning("ckpt_torn: generation %d — %s", step,
                               corrupt_generation(step_dir, "truncate"))
                continue
            _atomic_write_json(step_dir / MANIFEST_NAME, pending.manifest)
            marker = self.directory / DURABLE_MARKER
            if not marker.exists():
                _atomic_write_json(marker, {"manifest_format": MANIFEST_FORMAT})
            options = plan.take_ckpt_corrupt() if plan else None
            if options is not None:
                logger.warning("ckpt_corrupt: generation %d — %s", step,
                               corrupt_generation(step_dir,
                                                  str(options.get("mode", "flip"))))
        self._evict_old()
        if failed is not None:
            raise failed

    def _commit(self) -> None:
        self._join()
        self._finalize()

    def _evict_old(self) -> None:
        committed = [s for s in _step_dirs(self.directory) if s not in self._pending]
        for step in committed[:max(len(committed) - self.max_to_keep, 0)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def wait(self, *, deadline_s: Optional[float] = None) -> None:
        """Drain the pending writes and commit their manifests; transient
        failures of the drain retry, bounded by ``deadline_s``."""

        def drain() -> None:
            faults_mod.get_plan().maybe_io_error("checkpoint.wait")
            self._join()

        t0 = time.perf_counter()
        try:
            if self.primary:
                retry_call(drain, retries=2, base_delay=0.2, max_delay=2.0,
                           description="checkpoint wait", deadline_s=deadline_s)
                self._finalize()
        finally:
            self._barrier()  # the other ranks read what rank 0 landed
        _goodput.get_ledger().note("ckpt_wait_block_s", time.perf_counter() - t0)

    def close(self) -> None:
        self.wait()

    # -- restore-eligibility ---------------------------------------------------

    def latest_verified_step(self) -> Optional[int]:
        """Newest step whose generation carries a valid manifest (a
        manifest-level probe; the data is checked when restore reads it)."""
        return latest_verified_step_in_dir(self.directory)

    # -- restore ---------------------------------------------------------------

    def _note_failure(self, step: int, why: str) -> None:
        logger.error("checkpoint generation %d FAILED verification (%s); falling "
                     "back to the newest older verified generation", step, why)

    def _candidates(self) -> Tuple[List[int], List[int]]:
        """Newest-first steps with a manifest, and the committed steps
        without one (torn); generations still being written are neither."""
        candidates, rejected = [], []
        for step in reversed(_step_dirs(self.directory)):
            if step in self._pending:
                continue
            if load_manifest(self._step_dir(step)) is not None:
                candidates.append(step)
            else:
                self._note_failure(step, "missing or invalid manifest")
                rejected.append(step)
        return candidates, rejected

    def _read_verified(self, step: int, names):
        """``{item: {keystr: CPU tensor}}`` of the generation, or None when
        it fails to read or to verify."""
        try:
            items = {name: read_item(self._step_dir(step) / name) for name in names}
        except Exception as exc:  # noqa: BLE001 — torn data reads raise
            self._note_failure(step, f"read failed: {type(exc).__name__}: {exc}")
            return None
        v0 = time.perf_counter()
        problems = verify_manifest(load_manifest(self._step_dir(step)) or {},
                                   {n: list(items[n].items()) for n in names})
        self.verify_wall_s += time.perf_counter() - v0
        if problems:
            self._note_failure(step, "; ".join(problems[:3]))
            return None
        return items

    def _evict(self, step: int) -> None:
        shutil.rmtree(self._step_dir(step), ignore_errors=True)
        logger.warning("evicted unverifiable generation %d", step)

    def _corruption_error(self, steps) -> CheckpointCorruptionError:
        return CheckpointCorruptionError(
            f"no generation under {self.directory} verifies (steps seen: "
            f"{steps}); restore from a replica or start fresh")

    def restore(self, state_template, *, evict_failed: bool = True):
        """Copy the newest verified generation into ``state_template`` (its
        params, optimizer state and statistics tensors, in place, and its
        ``step``); returns ``(state, step)``, or ``(template, None)`` when
        there is nothing to restore.  A generation that fails to read, to
        verify or to fit the template is skipped (and, with
        ``evict_failed``, deleted); :class:`CheckpointCorruptionError`
        when none is left."""
        candidates, rejected = self._candidates()
        if not candidates and not rejected:
            return state_template, None
        doomed = list(rejected)
        layout = _layout(state_template)

        def slices(tree, name=""):
            """The :class:`_Slice` of every leaf of a params-shaped tree."""
            if isinstance(tree, dict):
                return {k: slices(v, f"{name}/{k}" if name else k)
                        for k, v in tree.items()}
            return _Slice(tree, name, layout)

        want = self._state_items(
            state_template, lambda shards: tuple(
                _Block(t, shards.rank, shards.world) for t in shards),
            None if layout is None else slices)
        try:
            for step in candidates:
                items = self._read_verified(step, ITEMS)
                if items is not None:
                    self._check_world(step, want, items)
                pairs = None if items is None else self._match(step, want, items)
                if pairs is None:
                    doomed.append(step)
                    continue
                with torch.no_grad():
                    for dst, src in pairs:
                        if isinstance(dst, _Block):
                            dst.tensor.copy_(dst.part(src))
                        else:
                            dst.copy_(src)
                state_template.step = int(items["state"]["['step']"])
                if self._agree(step) != step:
                    raise RuntimeError(f"this rank restored generation {step} "
                                       "and rank 0 another: the checkpoint "
                                       "directory differs between ranks")
                logger.info("restored checkpoint step %d from %s", step,
                            self.directory)
                return state_template, step
            raise self._corruption_error(sorted(candidates + rejected))
        finally:
            if evict_failed:
                self._barrier()  # every rank has read before rank 0 evicts
                if self.primary:
                    for step in doomed:
                        self._evict(step)

    @staticmethod
    def _check_world(step: int, want, items) -> None:
        """Raise when the generation's rank blocks come from another world,
        or its slices from another mesh, than the template's (never a
        fall-back: the data is good)."""
        have = items["state"].get("['comm_world']")
        have = None if have is None else int(have)
        mine = want["state"].get("comm_world")
        if have != mine:
            raise ValueError(
                f"checkpoint generation {step} holds the comm layout of a world "
                f"of {have} ranks and this state that of {mine}: restoring on "
                "another world size is not supported in the port (the "
                "reference re-lays-out through orbax; ROADMAP A5.4)")
        have = items["state"].get("['mesh']")
        have = None if have is None else dict(zip(AXIS_ORDER, have.tolist()))
        mine = want["state"].get("mesh")
        mine = None if mine is None else dict(zip(AXIS_ORDER, mine.tolist()))
        if have != mine:
            raise ValueError(
                f"checkpoint generation {step} was saved sharded over the mesh "
                f"{have} and this state is laid out over {mine}: restoring on "
                "another mesh is not supported in the port (the reference "
                "re-lays-out through orbax; ROADMAP A5.4)")

    def _match(self, step: int, want, items):
        """(template tensor, read tensor) pairs, or None when a leaf is
        missing or differs in shape or dtype."""
        pairs = []
        for name, tree in want.items():
            for key, dst in flatten(tree):
                src = items[name].get(key)
                if key in ("['step']", "['comm_world']", "['mesh']"):
                    continue
                if src is None or src.shape != dst.shape or src.dtype != dst.dtype:
                    self._note_failure(step, f"leaf {name}/{key} does not fit the "
                                             f"template")
                    return None
                pairs.append((dst, src))
        return pairs

    def restore_params(self, *, quantize_weights: Optional[str] = None):
        """``(params, step)`` of the newest verified generation's ``params``
        item alone, as CPU tensors; ``(None, None)`` when there is none.
        Falls back as :meth:`restore` does, but never evicts: serving reads
        a store some trainer owns.

        ``quantize_weights="int8"`` returns the int8-weight serving tree
        (``quant.calibrate.quantize_params``), quantized after the f32
        leaves verified: quantizing corrupt weights would only launder the
        corruption into plausible scales."""
        if quantize_weights not in (None, "int8"):
            raise ValueError(f"unsupported quantize_weights {quantize_weights!r} "
                             "(only 'int8')")
        candidates, rejected = self._candidates()
        if not candidates and not rejected:
            return None, None
        for step in candidates:
            items = self._read_verified(step, ("params",))
            if items is None:
                continue
            params = unflatten(items["params"])
            if quantize_weights is not None:
                from distributeddeeplearning_tpu_torch.quant.calibrate import (
                    quantize_params,
                )

                params = quantize_params(params)
            return params, step
        raise self._corruption_error(sorted(candidates + rejected))
