"""Keyword-flag entry-point runner for workload modules — the port of
``workloads/_runner.py``.

``run_from_argv(main)`` turns ``--key value`` / ``--key=value`` argv into
``main(**kwargs)``, coercing each value by the parameter's default (and
by literal parsing for ``None``-defaulted params), so

    python -m distributeddeeplearning_tpu_torch.workloads.benchmark --model resnet50

is a workload's launch contract.  Data-parallel runs start one process
per device under ``torchrun``, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` for
:func:`..parallel.distributed.initialize`:

    # on the CPU, two processes over gloo
    torchrun --nproc_per_node=2 -m \
        distributeddeeplearning_tpu_torch.workloads.transformer \
        --distributed --device cpu --num_layers 1 --d_model 16 ...
    # on a host with N cards, one process a card over NCCL
    torchrun --nproc_per_node=N -m \
        distributeddeeplearning_tpu_torch.workloads.benchmark --distributed  A run that was preempted and landed
its emergency checkpoint exits ``RESUMABLE_EXIT_CODE`` (75, EX_TEMPFAIL,
``train/resilience.py``): the code a supervisor restarts on, as opposed to
a real failure's 1.
"""

from __future__ import annotations

import ast
import inspect
import sys
from typing import Any, Callable, Dict, List, Optional


def _coerce(raw: str, default: Any) -> Any:
    if isinstance(default, bool):
        lowered = raw.lower()
        if lowered in ("true", "t", "yes", "y", "1"):
            return True
        if lowered in ("false", "f", "no", "n", "0"):
            return False
        raise ValueError(f"cannot interpret {raw!r} as a boolean")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    if isinstance(default, str):
        return raw
    # None / missing default: try a literal (int/float/bool/None), else a string.
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def parse_flags(argv: List[str]) -> Dict[str, str]:
    """``--key value`` / ``--key=value`` argv -> raw-string kwargs; a bare
    ``--key`` (last, or followed by another flag) maps to None, which
    :func:`coerce_flags` takes as True for a boolean parameter, so
    ``--distributed`` switches it on."""
    kwargs: Dict[str, str] = {}
    i = 0
    while i < len(argv):
        token = argv[i]
        if not token.startswith("--"):
            raise SystemExit(f"unexpected positional argument {token!r}")
        token = token[2:]
        if "=" in token:
            key, raw = token.split("=", 1)
        elif i + 1 >= len(argv) or argv[i + 1].startswith("--"):
            key, raw = token, None
        else:
            key, raw = token, argv[i + 1]
            i += 1
        kwargs[key.replace("-", "_")] = raw
        i += 1
    return kwargs


def coerce_flags(main_fn: Callable, raw_kwargs: Dict[str, str]) -> Dict[str, Any]:
    """Coerce raw-string kwargs against ``main_fn``'s signature."""
    sig = inspect.signature(main_fn)
    kwargs: Dict[str, Any] = {}
    for key, raw in raw_kwargs.items():
        if key not in sig.parameters:
            raise SystemExit(
                f"unknown flag --{key}; valid: "
                + ", ".join(f"--{p}" for p in sig.parameters)
            )
        param = sig.parameters[key]
        default = param.default
        if default is inspect.Parameter.empty:
            default = None
        if raw is None:
            if not (isinstance(default, bool) or "bool" in str(param.annotation)):
                raise SystemExit(f"flag --{key} expects a value")
            kwargs[key] = True
            continue
        try:
            kwargs[key] = _coerce(raw, default)
        except ValueError as exc:
            raise SystemExit(f"bad value for --{key}: {exc}")
    return kwargs


def run_from_argv(main_fn: Callable, argv: Optional[List[str]] = None) -> Any:
    """Parse flags against ``main_fn``'s signature and call it; a
    ``PreemptionError`` leaves as ``SystemExit(75)``."""
    from distributeddeeplearning_tpu_torch.train.resilience import (
        RESUMABLE_EXIT_CODE,
        PreemptionError,
    )

    argv = sys.argv[1:] if argv is None else argv
    kwargs = coerce_flags(main_fn, parse_flags(argv))
    try:
        return main_fn(**kwargs)
    except PreemptionError as exc:
        print(f"preempted: {exc} — exiting {RESUMABLE_EXIT_CODE} (resumable)",
              file=sys.stderr)
        raise SystemExit(RESUMABLE_EXIT_CODE)
