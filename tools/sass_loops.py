#!/usr/bin/env python3
"""Instruction counts of the port's CUDA kernels from their SASS.

    python3 tools/sass_loops.py [--lib PATH] [--match REGEX ...] [--dump DIR]

Builds the kernel library of this checkout (``lcgp_tpu_torch/ops/_build``)
unless ``--lib`` names one, disassembles it with ``cuobjdump -sass`` and,
for every kernel whose mangled name matches one of the ``--match``
expressions (default: every instantiation at MAXD 8), prints the static
counts of the whole function and of each loop, a loop being the span from
a backward branch's target to the branch.  The counts are per class:

- ``f64``: instructions of the f64 pipe (DFMA, DMUL, DADD, DSETP, DMNMX,
  DSET and the 64-bit MUFU forms);
- ``f2f``: conversions between f32 and f64 (F2F);
- ``fp32``: FFMA, FMUL, FADD, FSETP, FMNMX, FSEL and the 32-bit MUFU forms;
- ``lds``, ``sts``, ``ldg``, ``stg``: shared and global loads and stores;
- ``async``: copies that the threads only issue (LDGSTS, the bulk and
  tensor copies UBLKCP/UTMALDG/UTMASTG/UBLKRED, SYNCS, the arrive and wait
  forms of the mbarriers);
- ``bar``: block barriers (BAR);
- ``other``: everything else (integer, predicate, move, branch).

A loop's static count is what one trip issues when every branch in it
falls through; a branch around a block (an exp's rare slow path) makes
the dynamic count smaller.  The JSON line at the end holds every count,
so a later run can be compared.  It also prints the card's SM clock, for
the issue bound (warp instructions over 132 SMs x 4 schedulers x clock).
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

F64_OPS = {"DFMA", "DMUL", "DADD", "DSETP", "DMNMX", "DSET"}
FP32_OPS = {"FFMA", "FMUL", "FADD", "FSETP", "FMNMX", "FSEL", "FSET",
            "FCHK", "FSWZADD"}
ASYNC_OPS = {"LDGSTS", "LDGDEPBAR", "DEPBAR", "UBLKCP", "UTMALDG", "UTMASTG",
             "UBLKRED", "UTMACCTL", "UTMACMDFLUSH", "SYNCS", "UBLKPF",
             "UTMAPF", "FENCE"}

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)([^;]*);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
TARGET = re.compile(r"`?\((\.L_x_\d+)\)|(0x[0-9a-f]+)")


def classify(op: str, mods: str) -> str:
    if op in F64_OPS or (op == "MUFU" and "64" in mods):
        return "f64"
    if op == "F2F":
        return "f2f"
    if op in FP32_OPS or op == "MUFU":
        return "fp32"
    if op in ("LDS", "LDSM"):
        return "lds"
    if op == "STS":
        return "sts"
    if op in ("LDG", "LD"):
        return "ldg"
    if op in ("STG", "ST"):
        return "stg"
    if op in ASYNC_OPS:
        return "async"
    if op == "BAR":
        return "bar"
    return "other"


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/cuobjdump")
    if default.exists():
        return str(default)
    raise RuntimeError("cuobjdump not found (CUDA toolkit)")


def functions(sass: str):
    """{mangled name: [(address, opcode, modifiers, operands)]}, plus
    {name: {label: address}}."""
    funcs, labels = {}, {}
    cur = None
    pending = []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur], labels[cur] = [], {}
            pending = []
            continue
        if cur is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            funcs[cur].append((addr, m.group(2), m.group(3), m.group(4)))
    return funcs, labels


def loops(instrs, labels):
    """(start, end) address spans of the backward branches."""
    spans = []
    for addr, op, _, operands in instrs:
        if op not in ("BRA", "JMP"):
            continue
        m = TARGET.search(operands)
        if not m:
            continue
        tgt = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if tgt is not None and tgt <= addr:
            spans.append((tgt, addr))
    return sorted(set(spans))


def counts(instrs, lo=None, hi=None):
    c = Counter()
    for addr, op, mods, _ in instrs:
        if (lo is None or addr >= lo) and (hi is None or addr <= hi):
            c[classify(op, mods)] += 1
            c["all"] += 1
    return dict(c)


def short_name(mangled: str) -> str:
    """``gram_kernel<double, 8, Matern52>`` from a mangled kernel name: the
    template, its dtype, MAXD and policy (a length-prefixed name in
    namespace lcgp), as chip_smoke.py's ptxas report names them."""
    m = re.search(r"\d+([a-z_]*kernel)I([df])(?:Li(\d+)E)?", mangled)
    if not m:
        return mangled
    p = re.search(r"N4lcgp(\d+)", mangled)
    policy = mangled[p.end():p.end() + int(p.group(1))] if p else "any"
    dtype = "double" if m.group(2) == "d" else "float"
    maxd = f", {m.group(3)}" if m.group(3) else ""
    return f"{m.group(1)}<{dtype}{maxd}, {policy}>"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", help="a built liblcgp_kernels.so (default: "
                    "build this checkout's)")
    ap.add_argument("--match", action="append",
                    help="regex on the mangled kernel name (repeatable)")
    ap.add_argument("--dump", help="directory to write each matched "
                    "kernel's SASS into")
    args = ap.parse_args()
    if args.lib:
        lib = Path(args.lib)
    else:
        sys.path.insert(0, str(ROOT))
        from lcgp_tpu_torch.ops._build import build
        lib = build().path
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, labels = functions(sass)
    pats = [re.compile(p) for p in (args.match or [r"Li8E"])]
    names = [n for n in funcs if any(p.search(n) for p in pats)]
    report = {}
    for name in names:
        instrs = funcs[name]
        rec = {"function": counts(instrs), "loops": []}
        for lo, hi in loops(instrs, labels[name]):
            rec["loops"].append({"span": [hex(lo), hex(hi)],
                                 **counts(instrs, lo, hi)})
        short = short_name(name)
        report[short] = rec
        print(f"{short}\n  function: {rec['function']}")
        for lp in rec["loops"]:
            print(f"  loop {lp['span'][0]}..{lp['span'][1]}: "
                  + ", ".join(f"{k} {v}" for k, v in lp.items()
                              if k != "span"))
        if args.dump:
            out = Path(args.dump)
            out.mkdir(parents=True, exist_ok=True)
            safe = re.sub(r"[^A-Za-z0-9_]+", "_", short)[:120]
            (out / f"{safe}.sass").write_text("\n".join(
                f"{a:06x} {op}{mods}{ops}" for a, op, mods, ops in instrs))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card (name, power.limit, clocks.sm, clocks.max.sm): "
          f"{smi.stdout.strip() or 'not available'}")
    print(json.dumps({"lib": str(lib), "kernels": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
