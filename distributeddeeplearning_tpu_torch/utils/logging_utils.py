"""Logging setup — the port of ``utils/logging_utils.py``.

``LOG_CONFIG`` names an INI ``fileConfig`` that every entry point honours
(the reference's contract); otherwise records are prefixed with the
process's ``torch.distributed`` rank, resolved per record, so logging
set up before the process group exists still attributes records once it
does.
"""

from __future__ import annotations

import logging
import logging.config
import os
from typing import Optional


def _process_index() -> int:
    try:
        import torch.distributed as dist

        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    except Exception:  # noqa: BLE001 — a log record never fails
        return 0


class _ProcessIndexFilter(logging.Filter):
    """Stamps each record with the rank at the time it is logged."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.process_index = _process_index()
        return True


def setup_logging(name: str = "ddlt", level: int = logging.INFO) -> logging.Logger:
    """Configure logging once (``LOG_CONFIG`` when it names a file, else a
    rank-stamped stream handler on the root logger unless it has one);
    returns the framework logger."""
    log_config = os.environ.get("LOG_CONFIG", "")
    if log_config and os.path.exists(log_config):
        logging.config.fileConfig(log_config, disable_existing_loggers=False)
    else:
        root = logging.getLogger()
        if not root.handlers:
            handler = logging.StreamHandler()
            handler.addFilter(_ProcessIndexFilter())
            handler.setFormatter(logging.Formatter(
                fmt="%(asctime)s [p%(process_index)s] %(levelname)s %(name)s: %(message)s",
                datefmt="%H:%M:%S"))
            root.addHandler(handler)
            root.setLevel(level)
    return logging.getLogger(name)


def get_logger(name: Optional[str] = None) -> logging.Logger:
    return logging.getLogger(name or "ddlt")


def is_primary() -> bool:
    """True on the process that owns side effects (checkpoints, logs):
    rank 0, the reference's ``hvd.rank() == 0``."""
    return _process_index() == 0
