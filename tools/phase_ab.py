#!/usr/bin/env python3
"""Time the rotation path's phases (BASELINE config 4: N 32768, chain 8;
one rotation by 1 and EvalSum over 256 slots) for one or more checkouts,
so that two commits are compared on one card in turns.

    python3 tools/phase_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or an unpacked
`git archive` of another commit). Each runs in its own process, in the
order given (parent, change, change, parent for an A/B), imports that
checkout's chip_smoke.py and package, builds its kernels, and prints one
JSON line: the root, the card's name and power limit, and the CUDA-event
milliseconds of each phase, five timings each (chip_smoke.cuda_ms).
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

REPS = 5


def run(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as C
    from fhe_fed_tpu_torch import cuda_lib
    from fhe_fed_tpu_torch.ckks import params as P, keyswitch as KS

    dev = torch.device("cuda:0")
    cuda_lib.lib()
    ctx = P.make_context(P.make_params(batch=16384, scale_bits=52,
                                       mult_depth=5, ring_dim=32768), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    _, _, ct, gks = C.rotation_setup(ctx, gen, C.ROT_WIDTH)
    rot = [C.cuda_ms(lambda: KS.rotate(ctx, ct, 1, gks[1]), C.TIMED_ROUNDS)
           for _ in range(REPS)]
    esum = [C.cuda_ms(lambda: KS.eval_sum(ctx, ct, gks, C.ROT_WIDTH), 3)
            for _ in range(REPS)]
    return dict(root=str(root), card=C.card(), rotate_ms=rot,
                eval_sum_ms=esum)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        print(json.dumps(run(pathlib.Path(sys.argv[2]).resolve())),
              flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, __file__, "--run", root],
                             capture_output=True, text=True)
        print(out.stdout.strip() or out.stderr[-2000:], flush=True)
        rc = rc or out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
