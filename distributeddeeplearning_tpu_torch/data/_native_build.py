"""Build the data plane's C sources with the host compiler — the port of
``data/_native_build.py``.

One scheme serves the TFRecord reader (``_native.py``) and the JPEG
decoder (``_native_image.py``): ``csrc/<name>.c`` compiles at first use
with ``cc`` (then ``gcc``, ``clang``) into the port's ``_build/`` (listed
in ``.gitignore``, beside the CUDA kernels' libraries) as
``<name>-<digest>.so``, the digest covering the source and the flags, so
an edited source never loads a stale library.  Each process writes to a
name of its own and ``os.replace``s it into place, so processes that
build at once (test workers) do not collide.  Only the repository's
sources are used.  Every failure (no compiler, a missing link library,
an unwritable directory) returns None, so callers keep their pure-Python
and PIL paths; nothing here raises into a pipeline.  ``build_log`` keeps
what each build did, for the smoke script to print.
"""

from __future__ import annotations

import hashlib
import logging
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

logger = logging.getLogger("ddlt.data.native")

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CFLAGS = ("-O2", "-shared", "-fPIC")

#: libname -> {"path", "compiler", "seconds"} or {"error"} of the last build
build_log: Dict[str, dict] = {}


def library_path(src_path: Path, libname: str,
                 extra_args: Sequence[str] = ()) -> Path:
    flags = " ".join((*CFLAGS, *extra_args)).encode()
    digest = hashlib.sha256(src_path.read_bytes() + flags).hexdigest()[:16]
    return BUILD_DIR / f"{libname}-{digest}.so"


def compile_cached(src_path: Path, libname: str,
                   extra_args: Sequence[str] = ()) -> Optional[Path]:
    """Compile ``src_path`` into ``_build/<libname>-<digest>.so`` unless it
    is there already; returns its path, or None when anything prevents
    it."""
    if not src_path.exists():
        return None
    out = library_path(src_path, libname, extra_args)
    if out.exists():
        build_log[libname] = {"path": str(out), "compiler": None, "seconds": 0.0}
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError as exc:
        build_log[libname] = {"error": f"build dir {BUILD_DIR}: {exc}"}
        return None
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    errors = []
    for cc in ("cc", "gcc", "clang"):
        t0 = time.perf_counter()
        try:
            subprocess.run(
                [cc, *CFLAGS, str(src_path), "-o", str(tmp), *extra_args],
                check=True, capture_output=True, text=True,
            )
            os.replace(tmp, out)
            build_log[libname] = {"path": str(out), "compiler": cc,
                                  "seconds": time.perf_counter() - t0}
            return out
        except subprocess.CalledProcessError as exc:
            errors.append(f"{cc}: {exc.stderr.strip()[-300:]}")
        except (FileNotFoundError, OSError) as exc:
            errors.append(f"{cc}: {exc}")
        finally:
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass
    logger.debug("building %s failed: %s", libname, errors)
    build_log[libname] = {"error": "; ".join(errors)}
    return None
