"""Count a kernel's SASS instructions by class, loop by loop.

    python -m satellite_pose_estimation_tpu_torch.utils.sass_census \\
        [--source FILE.cu] [--kernel SUBSTRING]

Builds ``--source`` (default: the package's ``csrc/int8_attention.cu``, K6)
with the package's nvcc flags (sm_90a), disassembles it with ``cuobjdump
-sass`` and, for each function whose mangled name holds ``--kernel``
(default: K6's bf16 instances at head dim 32), prints a JSON line of the
whole function's counts and one per loop (a backward branch and the
instructions from its target to it, less the instructions of the loops
nested in it): the loop's address range and its instructions counted by
class (type conversions, MUFU, float arithmetic, integer-max, byte
permutes, tensor-core products, shared-memory traffic), with the rest
opcode by opcode.
K6's tile loops each compute one 64-key tile of one pass, so their counts
are the per-tile instruction mix. Needs nvcc and cuobjdump (the CUDA
toolkit), not a card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

from .cuda_build import CSRC_DIR, NVCC_FLAGS, find_nvcc

CLASSES = {
    "I2F": "I2F", "F2I": "F2I", "F2F": "F2F", "F2FP": "F2FP", "FRND": "FRND", "MUFU": "MUFU",
    "FFMA": "FFMA", "FADD": "FADD", "FMUL": "FMUL", "FMNMX": "FMNMX", "FSEL": "FSEL",
    "HFMA2": "HFMA2", "HADD2": "HADD2", "HMUL2": "HMUL2", "IMNMX": "IMNMX", "VIMNMX": "IMNMX",
    "PRMT": "PRMT", "IMMA": "IMMA", "LDS": "LDS", "STS": "STS", "LDSM": "LDS",
    "LDGSTS": "LDGSTS", "BAR": "BAR", "SHFL": "SHFL",
}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRA = re.compile(r"\bBRA\b[^;]*?(?:`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b)")


def functions(sass: str) -> dict[str, list[str]]:
    """cuobjdump -sass output split by function: mangled name -> lines."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def loops(lines: list[str]) -> list[dict]:
    """The loops of one function's SASS, in address order: each a dict with
    ``start`` / ``end`` (hex addresses), ``instructions`` (own, nested loops
    left out) and ``classes`` (their counts by class; "other" the rest)."""
    insns, labels, branches = [], {}, []
    for line in lines:
        lab = _LABEL.match(line)
        if lab:
            labels[lab.group(1)] = len(insns)
            continue
        m = _INSN.search(line)
        if not m:
            continue
        bra = _BRA.search(line)
        if bra:  # a label (nvdisasm) or an address (cuobjdump)
            branches.append((len(insns), bra.group(1) or int(bra.group(2), 16)))
        insns.append((int(m.group(1), 16), m.group(3).split(".")[0]))
    labels.update({addr: j for j, (addr, _) in enumerate(insns)})
    spans = sorted({(labels[t], i) for i, t in branches if t in labels and labels[t] <= i})
    found = []
    for lo, hi in spans:
        nested = [(a, b) for a, b in spans if lo <= a and b <= hi and (a, b) != (lo, hi)]
        own = [op for j, (_, op) in enumerate(insns[lo:hi + 1], lo)
               if not any(a <= j <= b for a, b in nested)]
        found.append({"start": hex(insns[lo][0]), "end": hex(insns[hi][0]),
                      "instructions": len(own), **_counts(own)})
    return found


def _counts(ops: list[str]) -> dict:
    """Opcodes counted by class, and the opcodes of the class "other" one by one."""
    return {"classes": dict(sorted(Counter(CLASSES.get(op, "other") for op in ops).items())),
            "other": dict(Counter(op for op in ops if op not in CLASSES).most_common())}


def census(source: Path, kernel: str) -> dict[str, tuple[dict, list[dict]]]:
    """Build ``source`` and return {function: (its counts, its loops)} for the
    functions whose mangled name holds ``kernel``."""
    with tempfile.TemporaryDirectory() as tmp:
        lib = Path(tmp) / "census.so"
        subprocess.run([find_nvcc(), *NVCC_FLAGS, str(source), "-o", str(lib)], check=True,
                       capture_output=True, text=True)
        cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                              capture_output=True, text=True).stdout
    return {name: (whole(lines), loops(lines)) for name, lines in functions(sass).items()
            if kernel in name}


def whole(lines: list[str]) -> dict:
    """One function's instructions counted by class."""
    ops = [m.group(3).split(".")[0] for m in map(_INSN.search, lines) if m]
    return {"instructions": len(ops), **_counts(ops)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, default=CSRC_DIR / "int8_attention.cu")
    parser.add_argument("--kernel", default="int8_attn_kernelILi32E13__nv_bfloat16")
    args = parser.parse_args(argv)
    found = census(args.source, args.kernel)
    if not found:
        raise SystemExit(f"no function of {args.source} holds {args.kernel!r}")
    for name, (whole, its_loops) in found.items():
        print(json.dumps({"source": args.source.name, "function": name, "loop": "whole function",
                          **whole}))
        for loop in its_loops:
            print(json.dumps({"source": args.source.name, "function": name, **loop}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
