#!/usr/bin/env python3
"""What bounds kernel K1's wgmma body on the card: compiler resources, the
SASS instruction mix, and a per-phase cycle trace.

    python3 tools/k1_report.py [--out DIR]

Needs nvcc and cuobjdump (CUDA toolkit) and one CUDA GPU. Prints:
  1. `nvcc -Xptxas -v` on fhe_fed_tpu_torch/csrc/ntt_mxu.cu: registers,
     spills and compiler diagnostics of each kernel;
  2. from `cuobjdump -sass`, for each instantiation of the wgmma body
     (n1, n2, forward), the count of wgmma (IGMMA), TMA tile loads
     (UTMALDG) and integer instructions, by opcode;
  3. a build with -DK1_PHASE_TRACE run at the FedAvg shapes ((612, 4, 8192)
     forward, (204, 4, 8192) inverse), checked against the plain version:
     the median clock cycles per CTA in each phase (input landed, stage-1
     digit split, stage 1, the barrier between stages, stage 2) beside the
     card's name, power limit and SM clock.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fhe_fed_tpu_torch import cuda_lib  # noqa: E402
from fhe_fed_tpu_torch.ckks.keys import uniform_mod_q  # noqa: E402
from fhe_fed_tpu_torch.ntt import mxu, mxu_pallas  # noqa: E402
from fhe_fed_tpu_torch.rns import primes  # noqa: E402

SOURCE = cuda_lib.CSRC / "ntt_mxu.cu"
OPCODES = ("IGMMA", "UTMALDG", "IMAD", "IADD3", "LOP3", "ISETP", "SEL",
           "SHF", "LEA", "VIADDMNMX", "STS", "LDS", "STG", "LDG")
PHASES = ("input landed", "stage-1 digits", "stage 1", "barrier", "stage 2")


def run(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{out.stdout}\n"
                           f"{out.stderr}")
    return out.stdout + out.stderr


def compiler_report(out: pathlib.Path, nvcc: str) -> None:
    obj = out / "ntt_mxu.o"
    log = run([nvcc, *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
               str(obj), str(SOURCE)])
    (out / "ptxas.txt").write_text(log)
    print("== nvcc -Xptxas -v ==")
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_label(m.group(1))
        elif "Used" in line or "spill" in line:
            print(f"{name}: {line.split(':', 1)[-1].strip()}")
        elif re.search(r"\(C7\d+\)|warning", line):
            m = re.search(r"function '(\S+)'", line)
            print(f"{kernel_label(m.group(1)) if m else name}: "
                  f"{line.strip()[:150]}")
    sass = run([str(pathlib.Path(nvcc).parent / "cuobjdump"), "-sass",
                str(obj)])
    (out / "sass.txt").write_text(sass)
    print("== SASS instruction counts (wgmma body) ==")
    print("kernel " + " ".join(OPCODES))
    for label, body in sass_functions(sass):
        if not label.startswith("wgmma"):
            continue
        ops = collections.Counter(
            m.group(1) for m in re.finditer(
                r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                body, re.M))
        print(label + " " + " ".join(str(ops[o]) for o in OPCODES))


def kernel_label(mangled: str) -> str:
    m = re.search(r"ntt_wg_kernelILi(\d+)ELi(\d+)ELb([01])", mangled)
    if m:
        return (f"wgmma[{m.group(1)}x{m.group(2)},"
                f"{'fwd' if m.group(3) == '1' else 'inv'}]")
    return "mma_sync" if "ntt_mxu_kernel" in mangled else mangled[:40]


def sass_functions(sass: str):
    parts = re.split(r"\n\s+Function : (\S+)", sass)
    for i in range(1, len(parts) - 1, 2):
        yield kernel_label(parts[i]), parts[i + 1]


def phase_trace(out: pathlib.Path, nvcc: str) -> None:
    lib_path = out / "libk1_trace.so"
    run([nvcc, *cuda_lib.NVCC_FLAGS, "-DK1_PHASE_TRACE", "-shared", "-o",
         str(lib_path), str(SOURCE)])
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fhe_ntt_mxu_wg.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
    lib.fhe_ntt_mxu_wg.restype = I
    lib.fhe_k1_phase_trace.argtypes = [P, I]
    lib.fhe_k1_phase_trace.restype = I
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    moduli = primes.ntt_primes(8192, 4)
    mt = mxu.make_mxu_tables(8192, moduli, device=dev)
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
               "--format=csv,noheader"]).strip()
    print(f"== phase trace, median cycles per CTA ({gpu}) ==")
    for B, fwd in ((612, True), (204, False)):
        x = uniform_mod_q(gen, (B, 4, 8192), moduli)
        y = torch.empty_like(x)
        tabs, _, consts = mxu_pallas.operands(mt, fwd)
        for _ in range(3):
            err = lib.fhe_ntt_mxu_wg(
                y.data_ptr(), x.data_ptr(), *(t.data_ptr() for t in tabs),
                consts.ctypes.data_as(ctypes.c_void_p), B, 4, mt.n1, mt.n2,
                int(fwd), torch.cuda.current_stream().cuda_stream)
            cuda_lib.check(err, "k1 trace build")
        torch.cuda.synchronize()
        want = (mxu.ntt_mxu if fwd else mxu.intt_mxu)(x, mt)
        if not torch.equal(y, want):
            raise AssertionError("the traced build differs from the plain "
                                 "version")
        ctas = 4 * ((B + 1) // 2)
        buf = np.zeros(ctas * 2 * 8, dtype=np.int64)
        cuda_lib.check(lib.fhe_k1_phase_trace(
            buf.ctypes.data_as(ctypes.c_void_p), buf.size), "trace read")
        marks = buf.reshape(ctas, 2, 8)[..., :6]
        spans = np.median(np.diff(marks, axis=-1).reshape(-1, 5), axis=0)
        total = float(np.median(marks[..., 5] - marks[..., 0]))
        name = "forward" if fwd else "inverse"
        print(f"{name} ({B}, 4, 8192): " + ", ".join(
            f"{p} {s:.0f}" for p, s in zip(PHASES, spans))
            + f"; total {total:.0f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "k1_report",
                    help="where the object, SASS, ptxas log and traced "
                         "library go")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_report: no CUDA device", file=sys.stderr)
        return 1
    args.out.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_lib._nvcc()
    compiler_report(args.out, nvcc)
    phase_trace(args.out, nvcc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
