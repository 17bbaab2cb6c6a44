"""Build the port's CUDA sources and load them through ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``_build/<name>-<digest>.so`` (``_build/`` is listed in ``.gitignore``).
The digest covers the source and the flags, so an edited kernel never
loads a stale library.  Nothing is fetched: only the repository's sources
and the CUDA toolkit are used.

Libraries build at first use, so any wrapper call builds what it needs;
:func:`build_all` starts one ``nvcc`` per source at once and waits for all
of them (the smoke script calls it to build and time everything up front).
No PyTorch header is included, which keeps a build to seconds.

The C entry points launch on the stream they are given (the wrapper passes
``torch.cuda.current_stream().cuda_stream``), allocate nothing, and return
``cudaGetLastError()``; :func:`check` turns a nonzero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "flash_decode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> nvcc's output for the last build (ptxas register/spill report)
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build with the CUDA toolkit "
            "(set CUDA_HOME)"
        )
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes running together.  Returns the wall seconds until
    each finished (0.0 for one already built); raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    times = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode:
            failed.append(f"--- {name} (nvcc rc {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if code:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
