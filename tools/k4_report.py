#!/usr/bin/env python3
"""What bounds kernel K4 (the exact-CRT decode) on the card: compiler
resources, the SASS instruction mix per live-limb count, and the issue
floor that mix sets.

    python3 tools/k4_report.py [--out DIR]

Needs nvcc and cuobjdump (CUDA toolkit) and one CUDA GPU. Prints:
  1. `nvcc -Xptxas -v` on fhe_fed_tpu_torch/csrc/decode_crt.cu: registers,
     shared memory and spills of each decode_kernel<live>;
  2. from `cuobjdump -sass`, for each live count, the instructions of the
     kernel by class: integer (IMAD, IADD3, LOP3, SHF, ISETP, SEL, LEA,
     ...), float (FADD, FMUL, ...), tensor (IMMA), shared-memory (LDS,
     STS), global (LDG, STG) and the rest. The kernel's loop body is one
     warp-tile of 32 coefficients, one coefficient a lane, so the static
     count is the instructions a lane issues per coefficient, with every
     digit's block of the tail taken (the tail stops after the highest
     nonzero digit, skipping at least the 11 float instructions of each
     block above it);
  3. the issue floor at the paths' shapes: warp-tiles x max(instructions,
     2 x integer instructions) cycles (one warp instruction a cycle on each
     of an SM's 4 schedulers; integer ones occupy the 16 INT32 lanes of a
     sub-partition for 2 cycles), over 4 x the SM count x the SM clock,
     beside the bytes bound, with the card's name, power limit and clock;
     and the same floor with the tail blocks above the highest nonzero
     digit left out, that digit's mean position measured on a decode of
     encoded values (normal x 0.1 at the context's scale).
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fhe_fed_tpu_torch import cuda_lib  # noqa: E402
from fhe_fed_tpu_torch.ckks import params as P, encoding  # noqa: E402
from fhe_fed_tpu_torch.ckks import pallas_decode  # noqa: E402

SOURCE = cuda_lib.CSRC / "decode_crt.cu"
INTEGER = ("IMAD", "IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "IABS",
           "PRMT", "VIADDMNMX", "VIMNMX", "IMNMX", "I2F", "F2I", "POPC",
           "FLO", "BMSK", "SGXT", "IADD", "IMUL", "LOP", "SHL", "SHR")
FLOAT = ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FRND", "FMNMX", "FCHK")
TENSOR = ("IMMA", "HMMA")
SHARED = ("LDS", "STS")
GLOBAL = ("LDG", "STG")
TAIL_FLOATS = 11           # FMUL of the term, two_sum 6, add 1, fast 3
# (chunks, live, N) of the records: the FedAvg decrypt, K4 at 11 live
# limbs, the deep path at 17 and 27.
SHAPES = ((204, 4, 8192), (204, 11, 16384), (51, 17, 32768),
          (51, 27, 32768))


def run(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{out.stdout}\n"
                           f"{out.stderr}")
    return out.stdout + out.stderr


def live_of(mangled: str) -> int | None:
    m = re.search(r"decode_kernelILi(\d+)E", mangled)
    return int(m.group(1)) if m else None


def compiler_report(out: pathlib.Path, nvcc: str) -> dict:
    obj = out / "decode_crt.o"
    log = run([nvcc, *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
               str(obj), str(SOURCE)])
    (out / "ptxas.txt").write_text(log)
    print("== nvcc -Xptxas -v (decode_kernel<live>) ==")
    live = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            live = live_of(m.group(1))
        elif live is not None and ("Used" in line or "spill" in line):
            print(f"live {live}: {line.split(':', 1)[-1].strip()}")
    sass = run([str(pathlib.Path(nvcc).parent / "cuobjdump"), "-sass",
                str(obj)])
    (out / "sass.txt").write_text(sass)
    counts = {}
    parts = re.split(r"\n\s+Function : (\S+)", sass)
    for i in range(1, len(parts) - 1, 2):
        live = live_of(parts[i])
        if live is None:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)",
                parts[i + 1], re.M))
        ops.pop("NOP", None)
        counts[live] = ops
    print("== SASS instructions per lane and coefficient ==")
    print("live total integer float tensor shared global other")
    for live in sorted(counts):
        c = counts[live]
        cls = [sum(c[o] for o in group)
               for group in (INTEGER, FLOAT, TENSOR, SHARED, GLOBAL)]
        total = sum(c.values())
        print(live, total, *cls, total - sum(cls))
    return counts


def digits_to_top(ctx, chunks, n, gen) -> float:
    """Mean count of 16-bit magnitude digits up to the highest nonzero one
    in a decode of encoded values (normal x 0.1 at the context's scale),
    from the decoded value times the scale."""
    vals = torch.randn((chunks, n), generator=gen, device=gen.device) * 0.1
    res = encoding.encode_coeff(ctx, vals, ctx.params.scale)
    mag = encoding.decode_coeff(ctx, res, ctx.params.scale).double().abs() \
        * ctx.params.scale
    return float(torch.ceil(torch.log2(mag + 1) / 16).mean())


def floors(counts: dict) -> None:
    props = torch.cuda.get_device_properties(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
               "--format=csv,noheader"]).strip()
    mhz = float(smi.split(",")[-1].split()[0])
    issue = 4 * props.multi_processor_count * mhz * 1e6   # warp-instr / s
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print(f"== issue floor ({smi}; {props.multi_processor_count} SMs) ==")
    for chunks, live, n in SHAPES:
        # 3 base primes at 2^52: a fresh chain of `live` limbs.
        ctx = P.make_context(P.make_params(
            batch=4096, scale_bits=52, mult_depth=live - 3, ring_dim=n),
            "cuda")
        c = counts[live]
        total = sum(c.values())
        integer = sum(c[o] for o in INTEGER)
        _, _, npl = pallas_decode.dims(live)
        nz = digits_to_top(ctx, 4, n, gen)
        tiles = chunks * n / 32
        full = tiles * max(total, 2 * integer) / issue * 1e3
        taken = total - (npl - nz) * TAIL_FLOATS
        part = tiles * max(taken, 2 * integer) / issue * 1e3
        nbytes = chunks * n * 4 * (live + 1)
        print(f"({chunks}, {live}, {n}): {total} instr ({integer} integer)"
              f" per lane; floor {full:.4f} ms with all {npl} digit blocks, "
              f"{part:.4f} ms with the {nz:.2f} up to the top; bytes bound "
              f"{nbytes / 3.35e12 * 1e3:.4f} ms")
        del ctx


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "k4_report",
                    help="where the object, SASS and ptxas log go")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_report: no CUDA device", file=sys.stderr)
        return 1
    args.out.mkdir(parents=True, exist_ok=True)
    counts = compiler_report(args.out, cuda_lib._nvcc())
    floors(counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
