"""Readings for the limits of reference/check.py, on the card:

    python3 -m fedbench.control --workload <name> --sut <sut>
        --seeds <n> [<n> ...] [--seconds S] [--out FILE]

runs the cell once per seed in one process (set-up once per seed, the
kernel library once) with `--sut` in the program's place: `program` (the
lower readings: sound runs), `reference-bfloat16` (the control: the
reference one precision below the stated float32; it has to come out as
not correct) or `reference-float32` (the reference as stated). One JSON
line per seed: the numbers compared and the verdict; then one line with
each number's least and largest reading. The benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from fedbench import run, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m fedbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--sut", choices=run.SUTS, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    torch = run.require_card(cell.chips)
    run.set_caches()
    lines, seen = [], {}
    for seed in args.seeds:
        r = run.run_cell(cell, seed, args.seconds, False,
                         torch.device("cuda", 0), sut=args.sut,
                         t0=time.perf_counter())
        line = dict(workload=cell.name, sut=args.sut, seed=seed,
                    correct=r["correct"], failed=r["failed"],
                    attempted=r["attempted"],
                    checks={k: v["value"] for k, v in r["checks"].items()},
                    metrics={k: v["value"] for k, v in r["metrics"].items()})
        for k, v in line["checks"].items():
            seen.setdefault(k, []).append(v)
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = dict(workload=cell.name, sut=args.sut, seeds=len(args.seeds),
                   correct=[ln["correct"] for ln in lines],
                   least={k: min(v) for k, v in seen.items()},
                   largest={k: max(v) for k, v in seen.items()})
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for ln in lines + [summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
