"""Process-group start-up and rank discipline — the port of
``parallel/distributed.py``, the counterpart of Horovod's ``hvd.init()``.

The geometry is one process per device.  :func:`initialize` performs the
rendezvous when the ``DISTRIBUTED`` switch (or ``force=True``) asks for
it, from the explicit arguments or from ``torchrun``'s environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); without the switch and at a world of 1 no rendezvous is
attempted, as in the reference's single-device local path.  A process
group the caller already started is taken as it is.

The backend is an explicit choice, never a fallback: ``"nccl"`` on
``cuda``, ``"gloo"`` on the CPU or when the caller names it.  On ``cuda``
the process is pinned to ``cuda:<LOCAL_RANK>`` unless the caller passes
an explicit device (two processes that share one card pass
``device="cuda:0"``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from distributeddeeplearning_tpu_torch._device import DeviceLike, resolve_device

logger = logging.getLogger("ddlt.distributed")

_TRUE = {"1", "true", "yes", "on"}


def _env_flag(name: str, default: bool = False) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() in _TRUE


def _env_int(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return None if val is None or val == "" else int(val)


@dataclasses.dataclass(frozen=True)
class DistributedContext:
    """Resolved process geometry — the reference's (hvd.rank, hvd.size,
    hvd.local_rank) triple, plus the device this process drives and the
    backend of its process group (None without one)."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int
    distributed: bool
    local_rank: int = 0
    device: Optional[torch.device] = None
    backend: Optional[str] = None

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


_context: Optional[DistributedContext] = None


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address:
        return (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not addr or not port:
        raise ValueError(
            "distributed initialize: no coordinator_address and no "
            "MASTER_ADDR/MASTER_PORT in the environment (start under "
            "torchrun, or pass coordinator_address='host:port')"
        )
    return f"tcp://{addr}:{port}"


def initialize(
    *,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    force: Optional[bool] = None,
    backend: Optional[str] = None,
    device: DeviceLike = None,
) -> DistributedContext:
    """Join the process group if asked; always return the context.

    ``force=None`` reads the ``DISTRIBUTED`` env switch.  A distributed
    context is kept for the process's life (:func:`shutdown` ends it); a
    single-process one is worked out again on every call.  ``device`` is
    the entry point's (``cuda`` by default, ``cpu`` on request); a bare
    ``cuda`` becomes ``cuda:<local_rank>``.  ``backend`` defaults to
    ``nccl`` on ``cuda`` and ``gloo`` on the CPU."""
    global _context
    if _context is not None and _context.distributed:
        return _context

    want = bool(force if force is not None else _env_flag("DISTRIBUTED"))
    dev = resolve_device(device)
    rank = process_id if process_id is not None else _env_int("RANK")
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = rank or 0
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    chosen = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if want and not dist.is_initialized():
        world = world or 1
        if rank is None and world > 1:
            raise ValueError("distributed initialize: no process_id and no "
                             "RANK in the environment")
        rank = rank or 0
        init_method = _init_method(coordinator_address)
        logger.info("init_process_group(%s, %s, world_size=%d, rank=%d)",
                    chosen, init_method, world, rank)
        dist.init_process_group(chosen, init_method=init_method,
                                world_size=world, rank=rank)
    joined = dist.is_available() and dist.is_initialized()
    count = dist.get_world_size() if joined else 1
    _context = DistributedContext(
        process_index=dist.get_rank() if joined else 0,
        process_count=count,
        local_device_count=1,
        global_device_count=count,
        distributed=want or count > 1,
        local_rank=local_rank,
        device=dev,
        backend=dist.get_backend() if joined else None,
    )
    if _context.is_primary:
        logger.info("distributed context: %d processes x 1 device on %s "
                    "(backend %s)", count, dev, _context.backend)
    return _context


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def is_primary() -> bool:
    """Rank-0 logging and checkpoint discipline — the reference's
    ``hvd.rank() == 0`` checks."""
    return process_index() == 0


def shutdown() -> None:
    """Leave the process group (if any) and forget the context."""
    global _context
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _context = None


def reset_context_for_testing() -> None:
    global _context
    _context = None
