#!/usr/bin/env python3
"""What bounds the Philox kernel (csrc/philox_rbg.cu, rbg's draws and
samplers) on the card: compiler resources, the SASS instruction mix of
each epilogue, and the issue floor that mix sets beside the bytes bound.

    python3 tools/philox_report.py [--out DIR]

Needs nvcc and cuobjdump (CUDA toolkit) and one CUDA GPU. Prints:
  1. `nvcc -Xptxas -v` on the source: registers and spills of each
     philox_kernel<epilogue, index type>;
  2. from `cuobjdump -sass`, each 32-bit-index instantiation's
     instructions by class: integer (IMAD, IADD3, LOP3, SHF, ISETP, ...),
     global (LDG, STG) and the rest. The kernel is one grid-stride loop
     whose body is one Philox block (two for the two-key epilogues) and
     its epilogue, so the function's static count is an upper bound on
     the instructions a thread issues per block of 4 outputs (the loop's
     set-up counts once, not per block);
  3. the issue floor at chip_smoke's PHILOX_RECORDS shapes: warp-blocks x
     max(instructions, 2 x integer instructions) cycles (one warp
     instruction a cycle on each of an SM's 4 schedulers; integer ones
     occupy the 16 INT32 lanes of a sub-partition for 2 cycles), over
     4 x the SM count x the SM clock, beside the bytes bound (outputs over
     3.35 TB/s), with the card's name, power limit and clock.
"""

from __future__ import annotations

import argparse
import collections
import math
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from fhe_fed_tpu_torch import cuda_lib  # noqa: E402

SOURCE = cuda_lib.CSRC / "philox_rbg.cu"
EPILOGUES = {0: "words", 1: "uniform", 2: "ternary", 3: "cbd"}
INTEGER = ("IMAD", "IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "IABS",
           "PRMT", "VIADDMNMX", "VIMNMX", "IMNMX", "POPC", "FLO", "BMSK",
           "SGXT", "IADD", "IMUL", "LOP", "SHL", "SHR", "ULDC", "UIADD3",
           "UIMAD", "UMOV", "ISCADD", "LEA.HI", "VIADD")
GLOBAL = ("LDG", "STG", "LDC")
OUT_BYTES = {"words": 8, "uniform": 4, "ternary": 4, "cbd": 4}
TWO_KEYS = ("uniform", "cbd")


def run(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{out.stdout}\n"
                           f"{out.stderr}")
    return out.stdout + out.stderr


def instance(mangled: str) -> tuple[str, str] | None:
    """(epilogue, index type) of a mangled philox_kernel<EPI, Idx>."""
    m = re.search(r"philox_kernelILi(\d)E(\w)", mangled)
    if not m:
        return None
    return EPILOGUES[int(m.group(1))], "u32" if m.group(2) == "j" else "u64"


def compiler_report(out: pathlib.Path, nvcc: str) -> dict:
    obj = out / "philox_rbg.o"
    log = run([nvcc, *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
               str(obj), str(SOURCE)])
    (out / "ptxas.txt").write_text(log)
    print("== nvcc -Xptxas -v (philox_kernel<epilogue, index>) ==")
    inst = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst = instance(m.group(1))
        elif inst is not None and ("Used" in line or "spill" in line):
            print(f"{inst[0]} {inst[1]}: {line.split(':', 1)[-1].strip()}")
    sass = run([str(pathlib.Path(nvcc).parent / "cuobjdump"), "-sass",
                str(obj)])
    (out / "sass.txt").write_text(sass)
    counts = {}
    parts = re.split(r"\n\s+Function : (\S+)", sass)
    for i in range(1, len(parts) - 1, 2):
        inst = instance(parts[i])
        if inst is None or inst[1] != "u32":
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)",
                parts[i + 1], re.M))
        ops.pop("NOP", None)
        counts[inst[0]] = ops
    print("== SASS instructions per thread and Philox block (u32 index) ==")
    print("epilogue total integer global other  (top opcodes)")
    for epi in EPILOGUES.values():
        c = counts[epi]
        total = sum(c.values())
        integer = sum(c[o] for o in INTEGER)
        glob = sum(c[o] for o in GLOBAL)
        print(epi, total, integer, glob, total - integer - glob,
              dict(c.most_common(6)))
    return counts


def floors(counts: dict) -> None:
    props = torch.cuda.get_device_properties(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
               "--format=csv,noheader"]).strip()
    mhz = float(smi.split(",")[-1].split()[0])
    issue = 4 * props.multi_processor_count * mhz * 1e6   # warp-instr / s
    print(f"== issue floor ({smi}; {props.multi_processor_count} SMs) ==")
    for entry, shape, batch, vmap in chip_smoke.PHILOX_RECORDS:
        elems = math.prod(batch) * math.prod(shape)
        c = counts[entry]
        total = sum(c.values())
        integer = sum(c[o] for o in INTEGER)
        warps = elems / 4 / 32
        floor = warps * max(total, 2 * integer) / issue * 1e3
        nbytes = elems * OUT_BYTES[entry]
        print(f"{entry} {list(batch)} x {list(shape)}"
              f"{' (vmap)' if vmap else ''}: {elems} outputs, "
              f"{elems // 4 * (2 if entry in TWO_KEYS else 1)} Philox "
              f"blocks; issue floor {floor:.4f} ms; bytes bound "
              f"{nbytes / chip_smoke.PEAK_BYTES * 1e3:.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "philox_report",
                    help="where the object, SASS and ptxas log go")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("philox_report: no CUDA device", file=sys.stderr)
        return 1
    args.out.mkdir(parents=True, exist_ok=True)
    counts = compiler_report(args.out, cuda_lib._nvcc())
    floors(counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
