"""Count the SASS instructions of the port's compiled kernels by opcode.

    python3 scripts/sass_ops.py [--root DIR] [--match flash_bwd_dq_f32] [--top 12]
    python3 scripts/sass_ops.py --library PATH --match NAME [--suffixes]

Builds (or finds) the libraries of the checkout at DIR, disassembles them
with the CUDA toolkit's ``cuobjdump -sass`` and prints, for every kernel
instance whose mangled name contains each ``--match`` string, its
instruction count and its most frequent opcodes: the static instruction
mix of its code, e.g. HMMA (tensor-core products) against the integer
and float work around them.  ``--library`` reads another shared library
instead (e.g. PyTorch's ``libtorch_cuda.so``, to see which units a library
kernel runs on): it extracts the library's sm_90 cubins (the H100's code)
and disassembles only those whose bytes hold every ``--match`` string.  Needs
the CUDA toolkit (the machine with the card); no card is needed."""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
import tempfile

# The H100's code in a library built for several architectures.
SM_ARCH = "sm_90"


def opcode_counts(lines, match, suffixes=False):
    """{kernel name: Counter of opcodes} for the functions of a
    ``cuobjdump -sass`` listing (an iterable of its lines) whose names
    contain every string of ``match``; with ``suffixes`` the opcodes keep
    their modifiers (``HMMA.1688.F32.TF32`` rather than ``HMMA``)."""
    out, ops = {}, None
    for line in lines:
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            ops = out.setdefault(name, collections.Counter()) if all(
                m in name for m in match) else None
        elif ops is not None:
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                ops[m.group(1) if suffixes else m.group(1).split(".")[0]] += 1
    return out


def library_counts(cuobjdump: str, path: str, match, suffixes=False):
    """:func:`opcode_counts` over the :data:`SM_ARCH` cubins of the library at
    ``path`` that hold every string of ``match`` (a large library's whole
    listing runs to gigabytes: the cubins are extracted and searched
    first)."""
    found = {}
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([cuobjdump, "-xelf", "all", os.path.abspath(path)], cwd=tmp,
                       capture_output=True, check=True)
        cubins = [n for n in sorted(os.listdir(tmp)) if SM_ARCH in n]
        print(f"{len(cubins)} {SM_ARCH} cubins in {path}", file=sys.stderr)
        for name in cubins:
            cubin = os.path.join(tmp, name)
            with open(cubin, "rb") as f:
                data = f.read()
            if all(m.encode() in data for m in match):
                sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                                      text=True, check=True).stdout
                found.update(opcode_counts(sass.splitlines(), match, suffixes))
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--match", action="append", default=None,
                    help="a string every reported kernel name contains")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--library", default=None,
                    help="disassemble this shared library instead of the checkout's")
    ap.add_argument("--suffixes", action="store_true",
                    help="count opcodes with their modifiers")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from distributeddeeplearning_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    match = args.match or [""]
    if args.library:
        found = library_counts(cuobjdump, args.library, match, args.suffixes)
    else:
        _build.build_all()
        found = {}
        for name in _build.SOURCES:
            sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                                  capture_output=True, text=True, check=True).stdout
            found.update(opcode_counts(sass.splitlines(), match, args.suffixes))
    for kernel, ops in found.items():
        top = ", ".join(f"{op} {n}" for op, n in ops.most_common(args.top))
        print(f"{kernel[:110]}: {sum(ops.values())} instructions; {top}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
