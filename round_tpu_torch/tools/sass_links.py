"""SASS instructions per drawn link of the tensor-core count (K1, K2).

    python -m round_tpu_torch.tools.sass_links [LIBRARY ...]

Disassembles the built kernels (``cuobjdump -sass``; by default the
hist_loop and hist_exchange libraries of the current build, which it
builds first) and, in each kernel that counts on the tensor cores, finds
the draw loop: the smallest loop (a backward branch) that issues the
mma products (IMMA) and the draws' multiplies, that is the loop over the
64-sender blocks of a round in its aligned, unsided form.  One trip of it
draws 64 links a lane (16 senders for each of four receivers), so its
instructions over 64 are the instructions a drawn link costs.  Prints one
JSON line per kernel: the SASS function, the loop's instructions, those
on the ALU pipe (LOP3, IADD3, shifts, compares, selects, PRMT) and on the
FMA pipe (IMAD and its forms), the IMMA products, the local-memory loads
(spills) and the instructions per link.  It needs the CUDA toolkit.
"""

from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

LINKS_PER_TRIP = 64  # 2 tiles x 2 receivers a lane x 16 senders
# the multiplies that mark a draw: Philox's IMAD.WIDE in hw mode, fmix32's
# two constants (0x85EBCA6B, 0xC2B2AE35 as cuobjdump prints them) in hash
_DRAW = re.compile(r"IMAD\.WIDE\.U32|-0x7a143595|-0x3d4d51cb")
_ALU = ("LOP3", "IADD3", "VIADD", "SHF", "SHL", "SHR", "ISETP", "SEL",
        "PRMT", "LEA", "PLOP3", "VIMNMX", "IABS", "FLO", "POPC")
# SASS kernel name fragment -> the LAUNCHES name of the kernel
KERNELS = {
    "hist_loop_kernelINS_9OtrPolicyELb1E": "otr_loop_hw",
    "hist_loop_kernelINS_9OtrPolicyELb0E": "otr_loop",
    "hist_loop_kernelINS_11BenOrPolicyELb1E": "benor_loop_hw",
    "hist_loop_kernelINS_11BenOrPolicyELb0E": "benor_loop",
    "hist_exchange_kernelILb1E": "hist_exchange_hw",
    "hist_exchange_kernelILb0E": "hist_exchange",
}


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/cuobjdump")
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit")


def _opcode(text: str) -> str:
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def draw_loop(sass: str) -> Optional[Dict]:
    """The draw loop of one kernel's SASS, or None where it has none."""
    ins = [(int(a, 16), b.strip()) for a, b in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    best = None
    for addr, text in ins:
        m = re.search(r"BRA\s+.*?0x([0-9a-f]+)", text)
        if "BRA" not in text or not m or int(m.group(1), 16) >= addr:
            continue
        body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
        ops = collections.Counter(_opcode(t) for t in body)
        draws = sum(bool(_DRAW.search(t)) for t in body)
        imma = sum(v for k, v in ops.items() if k.startswith("IMMA"))
        if imma and draws >= LINKS_PER_TRIP and (
                best is None or len(body) < best["instructions"]):
            best = {
                "instructions": len(body),
                "alu": sum(v for k, v in ops.items()
                           if k.split(".")[0] in _ALU),
                "fma": sum(v for k, v in ops.items() if k.startswith("IMAD")),
                "imma": imma,
                "spill_loads": sum(v for k, v in ops.items()
                                   if k.startswith("LDL")),
            }
    if best is not None:
        best["per_link"] = best["instructions"] / LINKS_PER_TRIP
        best["alu_per_link"] = best["alu"] / LINKS_PER_TRIP
        best["fma_per_link"] = best["fma"] / LINKS_PER_TRIP
    return best


def functions(library: Path) -> Dict[str, str]:
    """The SASS of every kernel of a built library, by its (mangled)
    function name."""
    sass = subprocess.run([cuobjdump(), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = (func.split("\n", 1) + [""])[:2]
        out[name.strip()] = body
    return out


def report(library: Path) -> List[Dict]:
    """One entry per tensor-core kernel of a built library."""
    rows = []
    for name, func in functions(library).items():
        kernel = next((v for k, v in KERNELS.items() if k in name), None)
        loop = draw_loop(func) if kernel else None
        if loop is not None:
            rows.append({"kernel": kernel, "function": name, **loop})
    return rows


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args:
        libs = [Path(a) for a in args]
    else:
        from round_tpu_torch.ops import _native

        out_dir, _ = _native.build()
        libs = [out_dir / f"lib{k}.so" for k in ("hist_loop", "hist_exchange")]
    for lib in libs:
        for row in report(lib):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
