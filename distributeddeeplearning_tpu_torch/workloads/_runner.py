"""Keyword-flag entry-point runner for workload modules — the port of
``workloads/_runner.py``.

``run_from_argv(main)`` turns ``--key value`` / ``--key=value`` argv into
``main(**kwargs)``, coercing each value by the parameter's default (and
by literal parsing for ``None``-defaulted params), so

    python -m distributeddeeplearning_tpu_torch.workloads.benchmark --model resnet50

is a workload's launch contract.  The reference's resumable exit code 75
for a preempted run belongs with the port of ``train/resilience.py``
(ROADMAP A4); until then an exception leaves as it is.
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
    """``--key value`` / ``--key=value`` argv -> raw-string kwargs."""
    kwargs: Dict[str, str] = {}
    i = 0
    while i < len(argv):
        token = argv[i]
        if not token.startswith("--"):
            raise SystemExit(f"unexpected positional argument {token!r}")
        token = token[2:]
        if "=" in token:
            key, raw = token.split("=", 1)
        else:
            if i + 1 >= len(argv):
                raise SystemExit(f"flag --{token} expects a value")
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
        default = sig.parameters[key].default
        if default is inspect.Parameter.empty:
            default = None
        try:
            kwargs[key] = _coerce(raw, default)
        except ValueError as exc:
            raise SystemExit(f"bad value for --{key}: {exc}")
    return kwargs


def run_from_argv(main_fn: Callable, argv: Optional[List[str]] = None) -> Any:
    """Parse flags against ``main_fn``'s signature and call it."""
    argv = sys.argv[1:] if argv is None else argv
    return main_fn(**coerce_flags(main_fn, parse_flags(argv)))
