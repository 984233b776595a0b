"""Count the SASS instructions of the port's CUDA kernels, for instruction bounds.

``cuobjdump -sass`` disassembles the built kernel library (the one
``ops/kernels/_build.LIBRARY`` loads, built first where needed); each
function's name is demangled with ``cu++filt`` (``c++filt`` where the
toolkit lacks it).  For every kernel whose demangled name matches a
pattern it counts:

  * ``static``: every instruction of the function, its subroutines (the
    slow paths of IEEE division and the like, reached by ``CALL``) and
    cold stubs included, NOPs left out;
  * ``path``: the instructions a thread issues on the common path, walked
    from the entry to the first unpredicated ``EXIT``: a predicated branch
    is taken as not taken (special cases branch away from the common
    path), except over a stub of at most ``CALL_STUB`` instructions that
    calls a slow path (the IEEE division's), which it skips; an
    unpredicated forward branch is followed, so the blocks reached only by
    branches (special cases, subroutines) are left out; selects and
    predicated instructions count whichever way they go; a loop counts
    once;
  * ``mufu``: the ``MUFU`` instructions (the special-function unit: ex2,
    lg2, rcp, rsqrt, sin, cos) among ``path``;
  * ``ops``: the instructions among ``path`` whose opcode starts with each
    prefix of ``OPS`` (``IMAD`` counts IMAD.WIDE, IMAD.MOV and the other
    forms of the multiply-add too, ``FFMA`` FFMA.FTZ and the like; ``LDS``
    the shared loads).

An instruction bound is then ``path`` times the threads over the card's
issue rate (4 warp instructions per SM per clock, 32 lanes each) and
``mufu`` times the threads over the special-function rate (16 lanes per SM
per clock).  On the card's machine:

    python -m turbo_metrics_tpu_torch.tools.sass_count 'yuv_to_rgb_kernel<unsigned short, 1, 2, 0>'
    python -m turbo_metrics_tpu_torch.tools.sass_count integer_vif_kernel
    python -m turbo_metrics_tpu_torch.tools.sass_count blur_probe_kernel

prints a line per matching kernel and, last, one JSON object
``{"sass": [{"kernel", "static", "path", "mufu", "ops"}, ...]}``.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

# Issue rates of an H100 SM per clock (Hopper architecture white paper): four
# schedulers, each one warp instruction of 32 lanes; 16 special-function lanes.
ISSUE_LANES_PER_SM = 4 * 32
MUFU_LANES_PER_SM = 16
# The opcode prefixes tallied on the common path: the integer multiply-adds
# and adds, the shared loads and the f32 multiply-adds.
OPS = ("IMAD", "IADD3", "LDS", "FFMA")

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"0x([0-9a-f]+)")
# The most instructions of a stub that a predicated branch jumps over to
# skip the call of a slow path (argument moves and the CALL).
CALL_STUB = 6


def _tool(name: str) -> str:
    from turbo_metrics_tpu_torch.ops.kernels._build import _nvcc

    for cand in (Path(_nvcc()).parent / name, shutil.which(name)):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(f"{name} not found beside nvcc or on PATH")


def _demangle(names: list) -> list:
    try:
        tool = _tool("cu++filt")
    except RuntimeError:
        tool = _tool("c++filt")
    out = subprocess.run([tool], input="\n".join(names) + "\n", capture_output=True, text=True,
                         check=True).stdout.splitlines()
    if len(out) != len(names):
        raise RuntimeError(f"{tool} returned {len(out)} names for {len(names)}")
    return out


def disassemble(library: str | None = None) -> dict:
    """{demangled kernel name: [(offset, instruction text), ...]} of every
    function in the library (the built kernel library where None)."""
    if library is None:
        from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY

        library = LIBRARY.path()
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTRUCTION.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    names = list(funcs)
    return dict(zip(_demangle(names), (funcs[n] for n in names)))


def _opcode(ins: str) -> tuple:
    """(predicated, opcode) of an instruction's text."""
    parts = ins.split()
    pred = parts[0].startswith("@")
    return pred, parts[1 if pred else 0]


def count(instructions: list) -> dict:
    """{"static", "path", "mufu", "ops"} of one function (see the module's
    notes)."""
    ops = [(off, *_opcode(ins), ins) for off, ins in instructions]
    at = {off: i for i, (off, *_) in enumerate(ops)}

    def target(i):
        tgt = _TARGET.search(ops[i][3].split(ops[i][2], 1)[1])
        return at.get(int(tgt.group(1), 16)) if tgt else None

    path = mufu = 0
    tally = dict.fromkeys(OPS, 0)
    i = 0
    while i < len(ops):
        _, pred, op, _ = ops[i]
        if op.startswith(("EXIT", "RET")) and not pred:
            path += op.startswith("EXIT")
            break
        j = target(i) if op.startswith("BRA") else None
        if j is not None and not pred and j > i:  # the ops after it is reached by branches only
            path += 1
            i = j
            continue
        if j is not None and pred and i < j <= i + 1 + CALL_STUB and any(
                o[2].startswith("CALL") for o in ops[i + 1 : j]):  # over the call of a slow path
            path += 1
            i = j
            continue
        if j is not None and not pred:  # a loop's closing branch: counted once
            path += 1
            break
        if not op.startswith("NOP"):
            path += 1
            mufu += op.startswith("MUFU")
            for prefix in tally:
                tally[prefix] += op.startswith(prefix)
        i += 1
    return {"static": sum(not o[2].startswith("NOP") for o in ops), "path": path, "mufu": mufu, "ops": tally}


def short_name(demangled: str) -> str:
    """A demangled kernel name without its return type, namespace, argument
    list and the casts of its template arguments:
    'yuv_to_rgb_kernel<unsigned short, 1, 2, 0>'."""
    name = demangled
    for junk in ("void ", "(anonymous namespace)::", "<unnamed>::", "(int)", "(bool)"):
        name = name.replace(junk, "")
    depth = 0
    for k, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:k]
    return name


def kernel_counts(patterns, library: str | None = None) -> list:
    """[{"kernel", "static", "path", "mufu", "ops"}] of each kernel whose
    demangled name (without its argument list) contains one of
    ``patterns``."""
    rows = []
    for name, instructions in disassemble(library).items():
        short = short_name(name)
        if any(p in short for p in patterns):
            rows.append({"kernel": short, **count(instructions)})
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m turbo_metrics_tpu_torch.tools.sass_count",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("patterns", nargs="+", help="substrings of demangled kernel names, e.g. "
                    "'yuv_to_rgb_kernel<unsigned short, 1, 2, 0>'")
    ap.add_argument("--library", help="a built kernel library (default: the port's, built if needed)")
    args = ap.parse_args(argv)
    rows = kernel_counts(args.patterns, args.library)
    for r in rows:
        tally = "".join(f", {n} {k}" for k, n in r["ops"].items())
        print(f"{r['kernel']}: {r['path']} instructions on the common path ({r['mufu']} MUFU{tally}), "
              f"{r['static']} in all", flush=True)
    result = {"sass": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["sass"] else 1)
