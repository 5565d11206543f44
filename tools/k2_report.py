#!/usr/bin/env python3
"""What bounds kernel K2 (the butterfly NTT, csrc/ntt_butterfly.cu) on the
card, and its time at the recorded shapes for one or more checkouts.

    python3 tools/k2_report.py [--out DIR] [--source CU ...]
    python3 tools/k2_report.py --time ROOT [ROOT ...]

Needs one CUDA GPU; the first form also nvcc and cuobjdump (CUDA toolkit).

The first form prints, for each source (default: this checkout's; give a
second, e.g. an unpacked parent commit's, to compare):
  1. `nvcc -Xptxas -v`: registers, shared memory and spills of every
     ntt_butterfly_kernel instantiation;
  2. from `cuobjdump -sass`, for the N = 32768 (one block) and N = 65536
     (two blocks) kernels of each direction, the instructions a thread
     issues per butterfly, by class: integer (IMAD, IADD3, LOP3, SHF,
     VIADDMNMX, ...), shared-memory (LDS, STS), global (LDG, STG), barrier
     (BAR, and the cluster's), other. Straight-line code counts once; a
     loop's body counts its source iterations per thread over the source
     iterations one pass of the body holds (the grouped body's loops: the
     copy-out and the two-block load and cluster loops, 16 a thread, one
     16-byte store each); for the first K2 (loops over runtime stage counts), the
     innermost loop with twiddle loads (LDG.E.64, one a butterfly) over
     its twiddle loads;
  3. for this checkout's source, the issue floor at each recorded shape:
     warps a block x max(instructions, 2 x integer instructions) / 4 (one
     warp instruction a cycle on each of an SM's 4 schedulers; integer
     ones occupy the 16 INT32 lanes of a sub-partition for 2 cycles), one
     128 KB block an SM, in waves of the SM count, over the SM clock;
     beside the bytes bound; with the card's name, power limit and clock.

The second form runs each ROOT (this checkout, or an unpacked `git
archive` of another commit) in its own process, in the order given
(parent, change, change, parent for an A/B): it imports that checkout's
chip_smoke.py and package, builds its kernels, and prints one JSON line of
K2's `ms` (chip_smoke.cuda_ms: CUDA events around back-to-back calls) and
`device_ms` (chip_smoke.graph_ms: the calls replayed from a CUDA graph) at
the recorded shapes, three timings each, with the card's name and limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
INTEGER = ("IMAD", "IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "IABS",
           "PRMT", "VIADDMNMX", "VIMNMX", "IMNMX", "I2F", "F2I", "POPC",
           "FLO", "BMSK", "SGXT", "IADD", "IMUL", "LOP", "SHL", "SHR",
           "UIMAD", "UIADD3", "ULOP3", "USHF", "ULEA", "USEL")
SHARED = ("LDS", "STS", "LDSM")
GLOBAL = ("LDG", "STG", "LD", "ST")
BARRIER = ("BAR", "UCGABAR_ARV", "UCGABAR_WAIT", "CCTL", "MEMBAR")
SHAPES = (   # (name, shape (..., L, N), forward): chip_smoke's K2 records
    ("rotation key switch, extended basis", (1, 8, 9, 32768), True),
    ("rotation key switch, inverse", (1, 8, 32768), False),
    ("64-chunk batch", (64, 8, 32768), True),
    ("64-chunk batch", (64, 8, 32768), False),
    ("deep cohort encrypt", (3, 51, 27, 32768), True),
    ("deep decrypt", (51, 27, 32768), False),
    ("ring65536", (26, 4, 65536), True),
    ("ring65536", (26, 4, 65536), False),
)
REPS = 3


def run(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{out.stdout}\n"
                           f"{out.stderr}")
    return out.stdout + out.stderr


def kernel_of(mangled: str) -> tuple[bool, int, int] | None:
    """(forward, H, log2 of the block's residues) of a kernel symbol; the
    single-block kernels of the first K2 have no S and report S = 0."""
    m = re.search(r"ntt_butterfly_kernelILb([01])ELi(\d+)E(?:Li(\d+)E)?",
                  mangled)
    if not m:
        return None
    return m.group(1) == "1", int(m.group(2)), int(m.group(3) or 0)


def instructions(body: str) -> list[tuple[int, str, str]]:
    """(address, opcode with modifiers, operands) of each SASS line."""
    return [(int(m.group(1), 16), m.group(2), m.group(3)) for m in
            re.finditer(r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);", body, re.M)
            if m.group(2) != "NOP"]


def loops(ins) -> list[tuple[int, int]]:
    """(first, last) instruction index of each loop (a backward BRA; not
    the branch to itself that ends a kernel)."""
    out = []
    for k, (addr, op, rest) in enumerate(ins):
        m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            target = int(m.group(1), 16)
            out.append((next(i for i, x in enumerate(ins) if x[0] >= target),
                        k))
    return out


def per_butterfly(body: str, H: int, S: int) -> tuple[dict, dict | None]:
    """Instructions a thread issues per butterfly, by class, and the
    thread's total (see the module doc)."""
    ins = instructions(body)
    if S == 0:
        # The first K2: the innermost loop with twiddle loads (LDG.E.64,
        # one a butterfly) is the butterfly; its count over the loads.
        body_of = [(lo, hi) for lo, hi in loops(ins) if any(
            x[1].startswith("LDG.E.64") for x in ins[lo:hi + 1])]
        lo, hi = min(body_of, key=lambda r: r[1] - r[0])
        c = collections.Counter(x[1].split(".")[0] for x in ins[lo:hi + 1])
        tw = sum(1 for x in ins[lo:hi + 1] if x[1].startswith("LDG.E.64"))
        return {k: v / tw for k, v in classes(c).items()}, None
    weight = [1.0] * len(ins)
    for lo, hi in loops(ins):
        st = sum(1 for x in ins[lo:hi + 1]
                 if x[1].startswith(("STS.128", "STG.E.128")))
        if not st:
            raise RuntimeError(f"unclassified loop at {ins[lo][0]:#x}")
        for i in range(lo, hi + 1):
            weight[i] = 16 / st      # 16 source iterations a thread
    c: collections.Counter = collections.Counter()
    for (_, op, _), w in zip(ins, weight):
        c[op.split(".")[0]] += w
    # Butterflies a thread runs: S stages of 2^(S-1) over 512 threads, and
    # at H = 2 the cross-half stage.
    per = (S * 2 ** (S - 1) + (2 ** (S - 1) if H == 2 else 0)) / 512
    grp = classes(c)
    return {k: v / per for k, v in grp.items()}, grp


def classes(c: collections.Counter) -> dict:
    grp = {name: sum(c[o] for o in ops) for name, ops in (
        ("integer", INTEGER), ("shared", SHARED), ("global", GLOBAL),
        ("barrier", BARRIER))}
    total = sum(c.values())
    grp["other"] = total - sum(grp.values())
    grp["total"] = total
    return grp


def compiler_report(src: pathlib.Path, out: pathlib.Path, nvcc: str,
                    flags) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    obj = out / "ntt_butterfly.o"
    log = run([nvcc, *flags, "-Xptxas", "-v", "-c", "-o", str(obj),
               str(src)])
    (out / "ptxas.txt").write_text(log)
    print(f"== {src}: nvcc -Xptxas -v ==")
    key = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = kernel_of(m.group(1))
        elif key is not None and ("Used" in line or "spill" in line):
            print(f"fwd={int(key[0])} H={key[1]} S={key[2]}: "
                  f"{line.split(':', 1)[-1].strip()}")
    sass = run([str(pathlib.Path(nvcc).parent / "cuobjdump"), "-sass",
                str(obj)])
    (out / "sass.txt").write_text(sass)
    parts = re.split(r"\n\s+Function : (\S+)", sass)
    res = {}
    print("== instructions a thread issues per butterfly ==")
    print("fwd H S: total integer shared global barrier other")
    for i in range(1, len(parts) - 1, 2):
        key = kernel_of(parts[i])
        if key is None or key[2] not in (0, 15):
            continue
        fwd, H, S = key
        per, thread = per_butterfly(parts[i + 1], H, S)
        res[key] = thread
        print(f"{int(fwd)} {H} {S}: " + " ".join(
            f"{per[k]:.2f}" for k in ("total", "integer", "shared", "global",
                                      "barrier", "other"))
            + ("" if S == 0 else f" (a thread: {thread['total']:.0f} "
               f"instructions, {thread['integer']:.0f} integer)"))
    return res


def floors(counts: dict) -> None:
    import torch
    props = torch.cuda.get_device_properties(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
               "--format=csv,noheader"]).strip()
    mhz = float(smi.split(",")[-1].split()[0])
    sms = props.multi_processor_count
    print(f"== issue floor ({smi}; {sms} SMs, one block an SM) ==")
    for name, shape, fwd in SHAPES:
        n = shape[-1]
        H = 2 if n == 65536 else 1
        grp = counts[(fwd, H, 15)]
        blocks = math.prod(shape[:-1]) * H
        warps = 512 // 32
        cyc = warps * max(grp["total"], 2 * grp["integer"]) / 4
        waves = math.ceil(blocks / sms)
        nbytes = 4 * 2 * math.prod(shape) + 8 * shape[-2] * n
        print(f"{name} {shape} {'fwd' if fwd else 'inv'}: {blocks} blocks, "
              f"{waves} waves x {cyc:.0f} cycles: floor "
              f"{waves * cyc / (mhz * 1e3):.4f} ms (evenly spread "
              f"{blocks * cyc / sms / (mhz * 1e3):.4f}); bytes bound "
              f"{nbytes / 3.35e12 * 1e3:.4f} ms")


def time_root(root: pathlib.Path) -> dict:
    """K2 at SHAPES in checkout `root` (run in a process of its own)."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as C
    from fhe_fed_tpu_torch import cuda_lib
    from fhe_fed_tpu_torch.ckks import params as P
    from fhe_fed_tpu_torch.ckks.keys import uniform_mod_q
    from fhe_fed_tpu_torch.ntt import pallas_ntt

    dev = torch.device("cuda:0")
    cuda_lib.lib()
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    ctxs = {32768: P.make_context(P.make_params(
        batch=4096, scale_bits=52, mult_depth=24), dev),
        65536: P.make_context(P.make_params(**C.RING_65536), dev)}
    out = []
    for name, shape, fwd in SHAPES:
        ctx = ctxs[shape[-1]]
        L = shape[-2]
        # The rotation's extended basis: L - 1 chain limbs and the special
        # prime (K2's time does not depend on which moduli).
        idx = (list(range(L - 1)) + [ctx.num_limbs - 1]
               if name.startswith("rotation key switch, ext") else
               list(range(L)))
        tb = ctx.tables.take(idx)
        x = uniform_mod_q(gen, shape, tuple(int(q) for q in tb.q))
        kern = pallas_ntt.ntt_fused if fwd else pallas_ntt.intt_fused
        ms = [C.cuda_ms(lambda: kern(x, tb), 10) for _ in range(REPS)]
        dms = [C.graph_ms(lambda: kern(x, tb), 10) for _ in range(REPS)]
        out.append(dict(name=name, shape=list(shape), forward=fwd, ms=ms,
                        device_ms=dms))
        del x
    return dict(root=str(root), card=C.card(), records=out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "k2_report",
                    help="where the objects, SASS and ptxas logs go")
    ap.add_argument("--source", type=pathlib.Path, nargs="*", default=[],
                    help="further ntt_butterfly.cu sources to report")
    ap.add_argument("--time", type=pathlib.Path, nargs="+", default=None,
                    metavar="ROOT", help="time K2 in each checkout, in turn")
    ap.add_argument("--run", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k2_report: no CUDA device", file=sys.stderr)
        return 1
    if args.run is not None:
        print(json.dumps(time_root(args.run.resolve())), flush=True)
        return 0
    if args.time is not None:
        rc = 0
        for root in args.time:
            res = subprocess.run([sys.executable, __file__, "--run",
                                  str(root)], capture_output=True, text=True)
            print(res.stdout.strip() or res.stderr[-3000:], flush=True)
            rc = rc or res.returncode
        return rc
    sys.path.insert(0, str(ROOT))
    from fhe_fed_tpu_torch import cuda_lib
    nvcc = cuda_lib._nvcc()
    counts = compiler_report(cuda_lib.CSRC / "ntt_butterfly.cu",
                             args.out / "this", nvcc, cuda_lib.NVCC_FLAGS)
    for i, src in enumerate(args.source):
        compiler_report(src, args.out / f"source{i}", nvcc,
                        cuda_lib.NVCC_FLAGS)
    floors(counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
