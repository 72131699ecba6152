#!/usr/bin/env python3
"""Dump the SASS of chosen kernels of forge3d_tpu_torch's CUDA library and
print each one's instruction mix.

Run from the root of a checkout on a machine with the CUDA toolkit:

    python3 scripts/sass_dump.py --out DIR rans_kernel adj_raster_kernel

builds the checkout's kernel library (forge3d_tpu_torch._kernels.build(),
the package imported from the current directory), runs `cuobjdump -sass`
on it, writes the SASS of every function whose mangled name contains one
of the names to DIR/<name>.sass, and prints, for each, the number of
instructions of each opcode (the first word after the predicate, without
its modifiers) and of the calls, which the IEEE division and square root
slow paths are.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?")


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "cuobjdump"), shutil.which("cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found (set CUDA_HOME)")


def functions(sass: str):
    """{mangled name: SASS text} of every function in cuobjdump's output."""
    out, name, lines = {}, None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                out[name] = "\n".join(lines)
            name, lines = m.group(1), []
        elif name:
            lines.append(line)
    if name:
        out[name] = "\n".join(lines)
    return out


def mix(text: str) -> collections.Counter:
    c = collections.Counter()
    for line in text.splitlines():
        m = _INSN.search(line)
        if m:
            c[m.group(2)] += 1
    return c


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="+")
    ap.add_argument("--out", default="build/sass")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    from forge3d_tpu_torch import _kernels

    lib = _kernels.build()
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    fns = functions(sass)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for want in args.names:
        hits = [n for n in fns if want in n]
        if not hits:
            print(f"{want}: no such function in {lib.name}")
            continue
        for n in hits:
            path = out / f"{want}{'' if len(hits) == 1 else '.' + str(hits.index(n))}.sass"
            path.write_text(fns[n] + "\n")
            c = mix(fns[n])
            print(f"{want} ({n}): {sum(c.values())} instructions, written to {path}")
            print("  " + ", ".join(f"{op} {k}" for op, k in c.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
