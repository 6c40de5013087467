"""Opcode histograms of the built kernels' SASS: what a kernel issues per
unit of its work.

    python -m msgs_torch.tools.sass [PATTERN ...] [--against LIB]

Builds (or loads) the kernel library (msgs_torch/kernels/_build.py),
disassembles it with the CUDA toolkit's cuobjdump and prints one line per
kernel whose mangled name contains every PATTERN: its instruction count and
its most frequent opcodes, predicates and operands dropped. A kernel's
instructions over the pairs one pass of its loop body covers (32 entries ×
one pixel a thread for the compositor family) give its issue slots per pair.
With --against, the library of another checkout (its
build/msgs_torch/libmsgs_torch_*.so), each kernel's instruction sequence,
operands included, is also compared with the same kernel's there: a change
that must leave a kernel's machine code as it was shows "identical".
Needs the CUDA toolkit, as on the card's machine.
"""
from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

_FUNCTION = re.compile(r"\s*Function : (\S+)")
_INSTRUCTION = re.compile(
    r"\s*/\*[0-9a-f]{4,}\*/\s+((?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
    r"[^;]*;)")
# The parts of a mangled name that differ between two checkouts of the same
# source: the anonymous namespace's hash and the file's.
_CHECKOUT = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_|_cu_[0-9a-f]{8}")


def kernels(sass: str) -> dict:
    """{kernel: [instruction text, operands included]} of cuobjdump -sass
    output."""
    out, kernel = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            kernel = m.group(1)
            out[kernel] = []
            continue
        m = _INSTRUCTION.match(line)
        if m and kernel is not None:
            out[kernel].append(" ".join(m.group(1).split()))
    return out


def histograms(sass: str) -> dict:
    """{kernel: Counter of opcodes} of cuobjdump -sass output."""
    return {k: collections.Counter(_INSTRUCTION.match("/*0000*/ " + i)
                                   .group(2) for i in ins)
            for k, ins in kernels(sass).items()}


def disassemble(lib: str) -> str:
    return subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/cuobjdump")
    if cand.exists():
        return str(cand)
    raise RuntimeError("msgs_torch.tools.sass: cuobjdump not found; it comes "
                       "with the CUDA toolkit")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("patterns", nargs="*",
                   help="substrings every kernel name printed contains")
    p.add_argument("--top", type=int, default=24,
                   help="opcodes printed per kernel")
    p.add_argument("--against", default=None,
                   help="another build's library to compare kernels with")
    args = p.parse_args(argv)
    from msgs_torch.kernels import _build
    _build.load()
    sass = disassemble(_build.build_info["path"])
    found = {k: h for k, h in histograms(sass).items()
             if all(s in k for s in args.patterns)}
    other = None
    if args.against:
        mine = kernels(sass)
        other = {_CHECKOUT.sub("", k): v
                 for k, v in kernels(disassemble(args.against)).items()}
    for k, h in found.items():
        same = ""
        if other is not None:
            same = ("; identical to --against's" if other.get(
                _CHECKOUT.sub("", k)) == mine[k] else "; DIFFERS from "
                "--against's")
        print(f"[sass] {k}: {sum(h.values())} instructions{same}; "
              + ", ".join(f"{o} {n}" for o, n in h.most_common(args.top)),
              flush=True)
    return found


if __name__ == "__main__":
    main(sys.argv[1:])
