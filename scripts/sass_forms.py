#!/usr/bin/env python3
"""Instruction counts of fastexp2's cubic, read from the SASS of the built
kernel library (``cuobjdump -sass``), for the bound of the fastexp2 form.

    python3 scripts/sass_forms.py [--same-as LIB]   # on a machine with nvcc

The fastexp2 and noexp forms of the wgmma + TMA pipeline
(``vdx_torch/csrc/flash_attention_sm90_forms.cu``) are one instance of
the same code but for the exponential: vdx's cubic (``fast_exp2``)
against x + 1. So the opcode histogram of the fastexp2 kernel less that
of the noexp kernel, at the head-dim instance DP = 48, is the cubic's
code less one FADD for each place the code evaluates it, and the number
of those places is the count of round-down adds (FADD.RM), of which the
cubic has exactly one. -> per score: the cubic's instructions by class and the SM
clocks they need at the CUDA C++ Programming Guide's rates for compute
capability 9.0 (arithmetic instruction throughput, results a clock per
SM): 128 for fp32 add, multiply and multiply-add; 64 for integer,
logic, shift, compare, min and max; 16 for conversions and the
special-function unit. Every instruction also takes an issue slot, four
schedulers of one a clock (128 thread-instructions a clock per SM), so
the clocks are the largest of the per-class times and the issue time.

Prints the two histograms at DP, their difference and the per-score
counts, then the per-score counts at every other instance (80, 128, 160,
256)
and whether they are within 5% of DP's in SM clocks a score, with no
other conversion or MUFU, so that the one count holds the bound at every
head dim (exit 1 if not); ``chip_smoke.py`` calls :func:`cubic_per_score`
for its fastexp2 bound.
``--same-as LIB`` also says, for each instance of the pipeline
(``flash_sm90_static_kernel``, ``flash_sm90_runmax_kernel`` and the
forms' ``flash_sm90f_*_kernel``) that both builds have, whether its SASS
in this build is instruction for instruction that of another build of
the library (another commit's ``vdx_torch/_build``), and lists the
instances that only this build has (exit 1 if one of the other build's
is missing or differs).
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FP32 = ("FADD", "FMUL", "FFMA")
CONV = ("F2I", "I2F", "FRND", "F2F", "F2FP", "I2FP", "F2IP")
MUFU = ("MUFU",)
# results a clock per SM by class; "alu": integer, logic, shift,
# compare, min and max
RATE = {"fp32": 128, "alu": 64, "conv": 16, "mufu": 16}
ISSUE = 128
_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
_TEXT = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)")
# the head-dim instance whose SASS the bound counts, and every instance
DP = 48
INSTANCES = (48, 80, 128, 160, 256)
# how far another instance's SM clocks a score may lie from DP's for the
# one count to hold its bound
SAME_CLOCKS = 0.05
_PIPELINE = re.compile(r"(flash_sm90f?_\w+?_kernelI\w*?EEE)")


def cuobjdump() -> str:
    from vdx_torch.kernels import _lib

    return str(Path(_lib._nvcc()).parent / "cuobjdump")


def sass(lib_path: str) -> str:
    return subprocess.run([cuobjdump(), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout


def pipeline_code(lib_path: str) -> dict:
    """{instance of the wgmma + TMA pipeline: its SASS instructions, text
    without addresses}"""
    out, current = {}, None
    for line in sass(lib_path).splitlines():
        m = _FUNC.search(line)
        if m:
            k = _PIPELINE.search(m.group(1))
            current = out.setdefault(k.group(1), []) if k else None
            continue
        m = _TEXT.search(line) if current is not None else None
        if m:
            current.append(" ".join(m.group(1).split()))
    return out


def histograms(lib_path: str) -> dict:
    """{DP instance: {form: Counter of SASS opcodes (with modifiers)}} of
    the fastexp2 and noexp kernels at every instance."""
    out, current = {}, None
    names = {f"flash_sm90f_{form}_kernelILi{dp}E": (dp, form)
             for dp in INSTANCES for form in ("fastexp2", "noexp")}
    for line in sass(lib_path).splitlines():
        m = _FUNC.search(line)
        if m:
            current = None
            for name, (dp, form) in names.items():
                if name in m.group(1):
                    current = out.setdefault(dp, {}).setdefault(
                        form, collections.Counter())
            continue
        m = _INSN.search(line) if current is not None else None
        if m:
            current[m.group(1)] += 1
    for dp in INSTANCES:
        if set(out.get(dp, {})) != {"fastexp2", "noexp"}:
            raise RuntimeError(f"fastexp2/noexp kernels at DP = {dp} not found "
                               f"in the SASS of {lib_path}: {sorted(out)}")
    return out


def klass(op: str) -> str:
    base = op.split(".")[0]
    if base in FP32:
        return "fp32"
    if base in CONV:
        return "conv"
    if base in MUFU:
        return "mufu"
    return "alu"


def cubic(h: dict):
    """The fastexp2 and noexp histograms of one instance -> (instructions
    of one cubic by class, SM clocks a score, the evaluations found, the
    fastexp2 - noexp difference by opcode)."""
    evals = sum(n for op, n in h["fastexp2"].items()
                if op.startswith("FADD") and ".RM" in op)
    if evals == 0:
        raise RuntimeError("no round-down FADD in the fastexp2 kernel: the "
                           "cubic's floor is not the magic-number add")
    diff = collections.Counter(h["fastexp2"])
    diff.subtract(h["noexp"])
    diff = {op: n for op, n in diff.items() if n}
    per = collections.Counter()
    for op, n in diff.items():
        per[klass(op)] += n / evals
    per["fp32"] += 1.0  # noexp's x + 1, taken out by the difference
    # the two kernels' other code differs only in register moves and in
    # noexp's integer division for its padded key count, a few
    # instructions in all: a class that comes out below 0 has none
    per = {k: max(0.0, per.get(k, 0.0)) for k in RATE}
    clocks = max(max(per[k] / RATE[k] for k in RATE),
                 sum(per.values()) / ISSUE)
    return per, clocks, evals, diff


def cubic_per_score(lib_path: str):
    """:func:`cubic` at the instance DP, for the fastexp2 bound."""
    return cubic(histograms(lib_path)[DP])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--same-as", metavar="LIB",
                    help="another build of the library: compare the "
                         "pipeline instances' SASS with it")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from vdx_torch.kernels import _lib

    path = _lib.build()
    hs = histograms(str(path))
    for form, c in hs[DP].items():
        print(f"[sass] {form} DP={DP}: {sum(c.values())} instructions "
              f"{dict(sorted(c.items()))}")
    per, clocks, evals, diff = cubic(hs[DP])
    print(f"[sass] fastexp2 - noexp: {dict(sorted(diff.items()))}")
    print(f"[sass] cubic evaluations in the code: {evals}; per score "
          f"{per}; SM clocks a score {clocks:.5f}")
    rc = 0
    for dp in INSTANCES:
        if dp == DP:
            continue
        per_dp, clocks_dp, evals_dp, _ = cubic(hs[dp])
        # the other code's few differing instructions weigh more where
        # there are fewer evaluations (64-key tiles at DP = 128 and 160)
        same = (abs(clocks_dp / clocks - 1) <= SAME_CLOCKS
                and all(per_dp[k] == per[k] for k in ("conv", "mufu")))
        rc |= not same
        print(f"[sass] DP={dp}: {evals_dp} evaluations; per score {per_dp}; "
              f"SM clocks a score {clocks_dp:.5f} ({clocks_dp / clocks:.3f} "
              f"of DP={DP}'s: {'within' if same else 'NOT within'} "
              f"{SAME_CLOCKS:.0%}, no other conversion or MUFU)")
    if args.same_as:
        ours, theirs = pipeline_code(str(path)), pipeline_code(args.same_as)
        missing = sorted(set(theirs) - set(ours))
        if not ours or missing:
            print(f"[sass] instances of {args.same_as} missing here: {missing}")
            return 1
        for name in sorted(theirs):
            print(f"[sass] {name}: {len(ours[name])} instructions, "
                  f"{'the same as' if ours[name] == theirs[name] else 'NOT the same as'} "
                  f"{args.same_as}")
        print(f"[sass] only in this build: {sorted(set(ours) - set(theirs))}")
        if any(ours[n] != theirs[n] for n in theirs):
            return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
