"""The five driver-set benchmark configs of BASELINE.json on the port, one
JSON line each: the counterpart of benchmarks/baseline_configs.py.

  1. ckks_example   - CKKS encrypt + 2-client weighted average + decrypt
                      of a 4096-slot vector (reference
                      pythonApi/ckks_example.py:91-111).
  2. ct_mult        - ciphertext mult + relinearize + rescale at N = 8192,
                      L = 4 live limbs: ciphertext mults/s on the card.
  3. fedavg_cnn100k - encrypted FedAvg of a ~100K-parameter model across 8
                      clients (reference benchmark.py:418-461).
  4. largering      - N = 32768, L = 8 with Galois rotations: one rotation's
                      latency and the EvalSum slot reduction (reference
                      mkhe.cpp:122-124).
  5. pod_fedavg     - 1M parameters x 64 clients, clients and chunks over
                      the process group's ('clients', 'chunks') mesh
                      (parallel/mesh.full_fed_step). One process makes a
                      group of world size 1 (NCCL on the card, gloo on the
                      CPU) and its record says so; under torchrun the
                      world's ranks share the mesh and the record adds the
                      time on a one-rank mesh and the scaling efficiency.

Run: python -m fhe_fed_tpu_torch.benchmarks.baseline_configs
         [--cpu] [--configs 1,2,5] [--device cuda] [--out DIR]
--cpu (or --device cpu) runs on the host with the shapes thinned as the
JAX driver thins them on its CPU backend (fewer reps, smaller widths,
config 5 at 200K x 16). Every record names
what it ran on (`backend`: the card's name and power limit, or "cpu") and
is appended to baseline_configs_<device type>.jsonl in build/results_torch/
or --out. Times are host seconds around calls that end in a device
synchronise, the best of the reps after one warm-up call.

The rotation keys and the ct x ct product are shared with chip_smoke.py's
rotation and multiply paths (galois_keys, eval_sum_want,
mult_relin_rescale).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import cuda_lib
from ..ckks import keys as K, keyswitch as KS, ops as O, params as P
from ..ckks import slots as SL
from ..parallel import mesh as M, multihost as MH
from ..utils import threefry
from .common import append_jsonl, backend

POD_SHAPE = (1_000_000, 64)        # parameters, clients
POD_SHAPE_CPU = (200_000, 16)      # --cpu: the JAX driver's thinned shape


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn, device, reps=5) -> float:
    """Best of `reps` host-clock seconds around fn() and a synchronise,
    after one warm-up call."""
    fn()
    _sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _emit(name, value, unit, device, out, **extra) -> dict:
    line = {"metric": name, "value": round(float(value), 6), "unit": unit,
            "backend": backend(device)}
    line.update(extra)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(line), flush=True)
        append_jsonl(f"baseline_configs_{device.type}.jsonl", line, out)
    return line


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def galois_keys(ctx, sk, width: int, gen) -> dict:
    """Galois keys for the rotations by r = 1, 2, 4 .. width/2 (EvalSum)."""
    gks = {}
    r = 1
    while r < width:
        gks[r] = KS.make_galois_key(ctx, sk, KS.galois_element(r,
                                                               ctx.ring_dim),
                                    gen)
        r <<= 1
    return gks


def eval_sum_want(z: np.ndarray, width: int) -> np.ndarray:
    """EvalSum composes global cyclic rotations: slot j holds the sliding
    cyclic sum of z[j .. j + width - 1] (mod the slot count)."""
    return sum(np.roll(z, -r) for r in range(width))


def mult_relin_rescale(ctx, a, b, rlk):
    """The public wrappers, so the scale and level bookkeeping is what a
    user's product pays for."""
    return O.rescale(ctx, KS.mul_ct(ctx, a, b, rlk))


def _fedavg_round(ctx, sk, weights):
    def round_fn(v, key):
        ct = O.encrypt_symmetric_stacked(ctx, sk, v, key)
        return O.decrypt(ctx, sk, O.weighted_sum(ctx, ct, weights))
    return round_fn


def cfg1_ckks_example(device, out=None) -> dict:
    """Encrypt + 2-client weighted average + decrypt, 4096 values."""
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params, device)
    sk, _ = K.keygen(ctx, 0)
    n = params.ring_dim
    vals = np.random.default_rng(0).standard_normal((2, 1, n)).astype(
        np.float32)
    vals[:, :, params.batch:] = 0.0          # 4096 payload slots
    stacked = torch.as_tensor(vals, device=device)
    round_fn = _fedavg_round(ctx, sk, [0.5, 0.5])
    key = threefry.key(1, device)
    got = round_fn(stacked, key).cpu().numpy()
    want = (0.5 * vals[0] + 0.5 * vals[1])[0, :params.batch]
    err = float(np.max(np.abs(got[0, :params.batch] - want)))
    t = _timeit(lambda: round_fn(stacked, key), device, reps=8)
    return _emit("ckks_example_2client_4096slots", t, "s", device, out,
                 max_err=err, config={"ring_dim": n, "scale_bits": 52})


def cfg2_ct_mult(cpu: bool, device, out=None) -> dict:
    """Ciphertext mult + relin + rescale at N = 8192, L = 4: ct mults/s."""
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params, device)
    sk, _ = K.keygen(ctx, 0)
    rlk = KS.make_relin_key(ctx, sk, _gen(device, 17))
    n = params.ring_dim
    live = params.chain_len
    # 2048 ciphertexts a call on the card: enough that the kernels, not
    # the host's dispatch, set the time.
    B = 8 if cpu else 2048
    vals = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (B, n)).astype(np.float32) * 0.1, device=device)
    ct_a = O.encrypt_symmetric(ctx, sk, vals, threefry.key(2, device))
    ct_b = O.encrypt_symmetric(ctx, sk, vals, threefry.key(3, device))
    t = _timeit(lambda: mult_relin_rescale(ctx, ct_a, ct_b, rlk), device)
    return _emit("ct_mults_per_s_chip_N8192_L4", B / t, "ct mults/s",
                 device, out, batch_cts=B, latency_s=round(t, 6),
                 config={"ring_dim": n, "live_limbs": live,
                         "includes": "mult+relin+rescale"})


def cfg3_fedavg_cnn100k(device, out=None) -> dict:
    """Encrypted FedAvg of a ~100K-parameter model across 8 clients."""
    n_params, n_clients = 100_000, 8
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params, device)
    sk, _ = K.keygen(ctx, 0)
    n = params.ring_dim
    chunks = -(-n_params // n)
    rng = np.random.default_rng(2)
    buf = np.zeros((n_clients, chunks, n), dtype=np.float32)
    flat = rng.standard_normal((n_clients, n_params)).astype(np.float32) * 0.1
    buf.reshape(n_clients, -1)[:, :n_params] = flat
    stacked = torch.as_tensor(buf, device=device)
    round_fn = _fedavg_round(ctx, sk, [1.0 / n_clients] * n_clients)
    key = threefry.key(4, device)
    got = round_fn(stacked, key).cpu().numpy()
    err = float(np.max(np.abs(got.reshape(-1)[:n_params]
                              - flat.mean(axis=0))))
    t = _timeit(lambda: round_fn(stacked, key), device)
    return _emit("fedavg_100k_8clients", t, "s", device, out, max_err=err,
                 params_per_s=round(n_params / t, 1),
                 config={"chunks": chunks, "ring_dim": n})


def cfg4_largering(cpu: bool, device, out=None) -> dict:
    """N = 32768, L = 8: rotation latency + EvalSum slot reduction."""
    params = P.make_params(batch=16384, scale_bits=52, mult_depth=5,
                           ring_dim=32768)
    ctx = P.make_context(params, device)
    if (ctx.ring_dim, params.chain_len) != (32768, 8):
        raise AssertionError("config 4 is N = 32768 with a chain of 8")
    sk, pk = K.keygen(ctx, 0)
    width = 16 if cpu else 256               # slots reduced by EvalSum
    z = np.random.default_rng(3).standard_normal(SL.num_slots(ctx)) * 0.1
    ct = O.encrypt_encoded(ctx, pk, SL.encode_slots(ctx, z[None, :]),
                           threefry.key(5, device), params.scale)
    gks = galois_keys(ctx, sk, width, _gen(device, 100))
    t_rot = _timeit(lambda: KS.rotate(ctx, ct, 1, gks[1]), device,
                    reps=3 if cpu else 8)
    KS.eval_sum(ctx, ct, gks, width)         # warm every rotation
    _sync(device)
    t0 = time.perf_counter()
    summed = KS.eval_sum(ctx, ct, gks, width)
    _sync(device)
    t_sum = time.perf_counter() - t0
    got = SL.decode_slots(ctx, O.decrypt_residues(ctx, sk, summed),
                          summed.scale)[0]
    err = float(np.max(np.abs(got.real - eval_sum_want(z, width))))
    return _emit("rotation_latency_N32768_L8", t_rot, "s", device, out,
                 evalsum_width=width, evalsum_s=round(t_sum, 4), max_err=err,
                 config={"ring_dim": 32768, "chain_len": 8})


def _world_max(t: float, device) -> float:
    """The largest of the ranks' `t` (every rank gets it)."""
    x = torch.tensor([t], dtype=torch.float64, device=device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return float(x)


def _mesh_axes(world: int) -> tuple[int, int]:
    """The JAX driver's split of the devices: clients 4 or 2 where they
    divide the world, the rest on chunks."""
    ca = 1
    for f in (2, 4):
        if world % f == 0:
            ca = f
    return ca, world // ca


def cfg5_pod_fedavg(cpu: bool, device, out=None) -> dict:
    """1M parameters x 64 clients over the ('clients', 'chunks') mesh of
    the process group (world size 1 unless one is already up)."""
    own = not dist.is_initialized()
    store = tempfile.TemporaryDirectory() if own else None
    if own and not MH.init_distributed(f"file://{store.name}/store", 1, 0,
                                       device):
        raise RuntimeError("the process group did not form")
    try:
        return _pod_fedavg(cpu, device, out)
    finally:
        if own:
            dist.destroy_process_group()
            store.cleanup()


def _pod_fedavg(cpu: bool, device, out) -> dict:
    n_params, n_clients = POD_SHAPE_CPU if cpu else POD_SHAPE
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params, device)
    sk, pk = K.keygen(ctx, 0)
    n = params.ring_dim
    world = dist.get_world_size()
    ca, cha = _mesh_axes(world)
    chunks = -(-n_params // n)
    chunks += (-chunks) % cha                # pad to the chunk-axis shards
    rng = np.random.default_rng(4)
    buf = np.zeros((n_clients, chunks, n), dtype=np.float32)
    flat = rng.standard_normal((n_clients, n_params)).astype(np.float32) * 0.1
    buf.reshape(n_clients, -1)[:, :n_params] = flat
    weights = [1.0 / n_clients] * n_clients
    w_res, w_shoup, _ = O._encode_weights(ctx, weights, params.chain_len, 0)
    rng_keys = threefry.split(threefry.key(7, device), n_clients)
    reps = 1 if cpu else 3

    def run_on(ca_, cha_):
        mesh = M.make_fed_mesh(ca_, cha_, device.type)
        if mesh.get_coordinate() is None:    # a rank outside a 1-rank mesh
            return None, None
        ci, cc = MH.local_slices(mesh, ("clients", "chunks"),
                                 (n_clients, chunks))
        vals = torch.as_tensor(buf[ci, cc], device=device)
        step = M.full_fed_step(ctx, mesh)

        def call():
            return step(pk, vals, rng_keys[ci], w_res[ci], w_shoup[ci], sk)
        whole = M.gather_chunks(mesh, call()).cpu().numpy()
        return _timeit(call, device, reps=reps), whole

    t_n, whole = run_on(ca, cha)
    t_n = _world_max(t_n, device)             # the slowest rank's wall
    err = float(np.max(np.abs(whole.reshape(-1)[:n_params]
                              - flat.mean(axis=0))))
    if world > 1:
        t_1 = _world_max(run_on(1, 1)[0] or 0.0, device)   # rank 0's
        extra = {"t_1dev_s": round(t_1, 4), "n_devices": world,
                 "scaling_efficiency": round(t_1 / (t_n * world), 3)}
    else:
        extra = {"note": "world size 1 (one process, one device): a "
                         "single-device datum, not a multi-device "
                         "measurement; see scaling_virtual for the "
                         "partition overhead"}
    return _emit("pod_fedavg_1M_64clients", t_n, "s", device, out,
                 max_err=err, params_per_s=round(n_params / t_n, 1),
                 config={"n_params": n_params, "n_clients": n_clients},
                 mesh={"clients": ca, "chunks": cha}, **extra)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (as --device cpu); the shapes are "
                         "thinned on the CPU")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="results directory (default build/results_torch)")
    args = ap.parse_args(argv)
    device = cuda_lib.device("cpu" if args.cpu else args.device)
    thin = device.type == "cpu"
    todo = {int(x) for x in args.configs.split(",")}
    rows = []
    if 1 in todo:
        rows.append(cfg1_ckks_example(device, args.out))
    if 2 in todo:
        rows.append(cfg2_ct_mult(thin, device, args.out))
    if 3 in todo:
        rows.append(cfg3_fedavg_cnn100k(device, args.out))
    if 4 in todo:
        rows.append(cfg4_largering(thin, device, args.out))
    if 5 in todo:
        rows.append(cfg5_pod_fedavg(thin, device, args.out))
    return rows


if __name__ == "__main__":
    main()
