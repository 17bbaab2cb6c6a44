"""Count the SASS instructions of the port's compiled kernels by opcode.

    python3 scripts/sass_ops.py [--root DIR] [--match flash_bwd_dq_f32] [--top 12]

Builds (or finds) the libraries of the checkout at DIR, disassembles them
with the CUDA toolkit's ``cuobjdump -sass`` and prints, for every kernel
instance whose mangled name contains each ``--match`` string, its
instruction count and its most frequent opcodes: the static instruction
mix of its code, e.g. HMMA (tensor-core products) against the integer
and float work around them.  Needs the CUDA toolkit (the machine with the
card); no card is needed."""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys


def opcode_counts(sass: str, match):
    """{kernel name: Counter of opcodes} for the functions of a
    ``cuobjdump -sass`` listing whose names contain every string of
    ``match``."""
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if not all(m in name for m in match):
            continue
        ops = collections.Counter()
        for line in block.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                ops[m.group(1).split(".")[0]] += 1
        out[name] = ops
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--match", action="append", default=None,
                    help="a string every reported kernel name contains")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from distributeddeeplearning_tpu_torch.ops import _build

    _build.build_all()
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name in _build.SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        for kernel, ops in opcode_counts(sass, args.match or [""]).items():
            top = ", ".join(f"{op} {n}" for op, n in ops.most_common(args.top))
            print(f"{kernel[:110]}: {sum(ops.values())} instructions; {top}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
