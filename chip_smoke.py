#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases (each raises on failure, so the script exits non-zero):
  1. require a CUDA device; print the card's name and power limit;
  2. build the kernel library from csrc/ (one nvcc per source, in parallel,
     into build/fhe_fed_tpu_torch/);
  3. hold every kernel against its plain PyTorch version, bit-exactly, at
     the shapes the paths give it, and time both with CUDA events: K1, K3
     and K4 at the FedAvg shapes, K3 also at 64 clients, K4 also at 11 live
     limbs, K2 at the rotation path's shapes and a 64-chunk batch, and K2
     against K1 at N = 8192;
  4. the FedAvg path at the bench configuration (CNN_OriginalFedAvg,
     1,663,370 parameters x 3 clients, batch 4096 / scale 2^52 / N 8192,
     204 dense chunks) with the committed keys: secret-key encrypt ->
     weighted sum -> decrypt, the public-key encrypt path, and the fused
     round; max_err <= 1e-6 against the plaintext weighted average;
  5. the rotation path (BASELINE config 4: N 32768, chain 8 + 1 special
     prime, Galois keys for r = 1, 2, .., 128): one slot-encoded encrypted
     vector, one rotation by 1 and EvalSum over 256 slots, slot-decoded
     within 1e-6 of the plaintext sums;
  6. the multiply path (BASELINE config 2: N 8192, 4 live limbs, 2048
     ciphertexts): mult + relinearise + rescale, the first products
     slot-decoded within 1e-6 of z_a * z_b;
  7. the API path, through the drop-in surface (fed/api.py, fed/fedavg.py)
     at the bench configuration (batch 4096, 2^52, N 8192, dense): first
     the known answers on the card (threefry keygen(ctx, 0) equals the
     committed key files byte for byte, the KAT ciphertext digest), then
     CKKS helpers loaded from a cryptodir of the committed keys run
     3 x 1,663,370 values through encrypt -> computeWeightedAverage ->
     decrypt in the symmetric, public-key and seeded_fresh modes and one
     mixed FFTS + FFTC cohort (FFTS <= 0.51 x FFTC), fedavg_round fused
     and staged, a streamed round at BERT-base size (109,482,240 values x
     3, 14 slices of 1024 chunks), slot mode at 100,000 values, and
     fhe_fedavg over three CNNOriginalFedAvg state_dicts (FULL, rate 0.1,
     the two conv layers) loaded back into a module and run forward; every
     result within 1e-6 of its plaintext reference;
  8. time each phase after a warm-up.
Each path runs with the launch counts set to 0 just before it and read just
after; it fails if a kernel of that path was not launched. With --profile,
one rotation, one batch multiply, one API encrypt and its threefry
sampling step are traced with torch.profiler and the tables written to
DIR. The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from fhe_fed_tpu_torch import cuda_lib
from fhe_fed_tpu_torch import CKKS, SelectivePolicy, fhe_fedavg, plain_fedavg
from fhe_fed_tpu_torch.ntt import mxu, mxu_pallas, ntt as ntt_mod, pallas_ntt
from fhe_fed_tpu_torch.ckks import params as P, serial as S, ops, encoding
from fhe_fed_tpu_torch.ckks import pallas_agg, pallas_decode
from fhe_fed_tpu_torch.ckks import keys, keyswitch as KS, slots as SL
from fhe_fed_tpu_torch.ckks.keys import uniform_mod_q
from fhe_fed_tpu_torch.models.basic import CNNOriginalFedAvg
from fhe_fed_tpu_torch.utils import threefry

ROOT = pathlib.Path(__file__).resolve().parent
KEY_DIR = ROOT / "results" / "bench_keys_headline"
CNN_PARAMS = 1_663_370
N_CLIENTS = 3
MAX_ERR = 1e-6
TIMED_ROUNDS = 10
ROT_WIDTH = 256           # EvalSum width of the rotation path
MULT_BATCH = 2048         # ciphertexts per multiply (baseline_configs.py:117)
MULT_CHECKED = 4          # products slot-decoded and checked
BERT_PARAMS = 109_482_240  # BERT-base (models/zoo.py), the streamed round
SLOT_VALUES = 100_000
API_WEIGHTS = [0.5, 0.2, 0.3]
FFTS_RATIO = 0.51         # an FFTS blob is at most this share of an FFTC one
KAT_CT = "e2cfa667b8fc7a5c93eddae47ee6fccf44e1db2db0e24344d88d00412d4f92b6"
POLICIES = {   # fhe_fedavg policies over a CNNOriginalFedAvg state_dict
    "full": SelectivePolicy(),
    "rate_0.1": SelectivePolicy(rate=0.1),
    "conv_layers": SelectivePolicy(layer_mask={0, 1, 2, 3}),
}

KERNELS = {   # wrapper name -> (source, TPU kernel it replaces)
    "ntt_mxu_fused": ("fhe_fed_tpu_torch/csrc/ntt_mxu.cu",
                      "fhe_fed_tpu/ntt/mxu_pallas.py:95"),
    "intt_mxu_fused": ("fhe_fed_tpu_torch/csrc/ntt_mxu.cu",
                       "fhe_fed_tpu/ntt/mxu_pallas.py:95"),
    "weighted_sum_fused": ("fhe_fed_tpu_torch/csrc/weighted_sum.cu",
                           "fhe_fed_tpu/ckks/pallas_agg.py:30"),
    "decode_fused": ("fhe_fed_tpu_torch/csrc/decode_crt.cu",
                     "fhe_fed_tpu/ckks/pallas_decode.py:39"),
    "ntt_fused": ("fhe_fed_tpu_torch/csrc/ntt_butterfly.cu",
                  "fhe_fed_tpu/ntt/pallas_ntt.py:157"),
    "intt_fused": ("fhe_fed_tpu_torch/csrc/ntt_butterfly.cu",
                   "fhe_fed_tpu/ntt/pallas_ntt.py:195"),
}
PATH_KERNELS = {   # the kernels each driven path must launch
    "fedavg": ("ntt_mxu_fused", "intt_mxu_fused", "weighted_sum_fused",
               "decode_fused"),
    "rotation": ("ntt_fused", "intt_fused"),
    "multiply": ("ntt_mxu_fused", "intt_mxu_fused"),
    "api": ("ntt_mxu_fused", "intt_mxu_fused", "weighted_sum_fused",
            "decode_fused"),
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over `reps` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def _record(recs, name, got, want, fn, plain_fn, reps, plain_reps=3,
            shape=None):
    """Raise unless `got` equals `want` bit for bit; else append the
    kernel's record (`shape`: its input's, by default the output's) with
    both times."""
    torch.cuda.synchronize()
    if got.dtype == torch.float32:
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        same = torch.equal(got, want)
    err = _max_abs_err(got, want)
    if not same:
        raise AssertionError(f"{name} {tuple(got.shape)}: kernel differs from "
                             f"its plain version (max_abs_err {err})")
    src, rep = KERNELS[name]
    recs.append(dict(name=name, route="cuda", source=src, replaces=rep,
                     shape=list(got.shape if shape is None else shape),
                     max_abs_err=err,
                     ms=cuda_ms(fn, reps), plain_ms=cuda_ms(plain_fn,
                                                            plain_reps)))


def check_kernels(ctx, sk, values, weights, gen, reps=10) -> list[dict]:
    """Each FedAvg kernel against its plain version at the shapes `values`
    (K, chunks, N) gives the FedAvg path; raises on any bit difference."""
    K, chunks, n = values.shape
    L = ctx.params.chain_len
    moduli = ctx.params.moduli
    mt = ctx.tables.mxu.slice_limbs(0, L)
    recs = []

    def record(name, got, want, fn, plain_fn, shape=None):
        _record(recs, name, got, want, fn, plain_fn, reps, shape=shape)

    x = uniform_mod_q(gen, (K * chunks, L, n), moduli)
    record("ntt_mxu_fused", mxu_pallas.ntt_mxu_fused(x, mt),
           mxu.ntt_mxu(x, mt), lambda: mxu_pallas.ntt_mxu_fused(x, mt),
           lambda: mxu.ntt_mxu(x, mt))
    xe = uniform_mod_q(gen, (chunks, L, n), moduli)
    record("intt_mxu_fused", mxu_pallas.intt_mxu_fused(xe, mt),
           mxu.intt_mxu(xe, mt), lambda: mxu_pallas.intt_mxu_fused(xe, mt),
           lambda: mxu.intt_mxu(xe, mt))

    stacked = uniform_mod_q(gen, (K, chunks, 2, L, n), moduli)
    w_res, w_shoup, _ = ops._encode_weights(ctx, weights, L, 0)
    wr = torch.as_tensor(w_res, device=stacked.device)
    ws = torch.as_tensor(w_shoup, device=stacked.device)
    record("weighted_sum_fused",
           pallas_agg.weighted_sum_fused(stacked, w_res, w_shoup, moduli[:L]),
           ops._weighted_sum_impl(ctx, stacked, wr, ws),
           lambda: pallas_agg.weighted_sum_fused(stacked, w_res, w_shoup,
                                                 moduli[:L]),
           lambda: ops._weighted_sum_impl(ctx, stacked, wr, ws),
           stacked.shape)

    # Real decrypt residues of an aggregated round.
    agg = ops.weighted_sum(
        ctx, ops.encrypt_symmetric_stacked(ctx, sk, values, gen), weights)
    res = ops.decrypt_residues(ctx, sk, agg)
    dc = ctx.dec_consts[L - 1]
    qs = ctx.q[:L]
    record("decode_fused", pallas_decode.decode_fused(ctx, dc, res, agg.scale),
           encoding.decode_core(dc, qs, res, agg.scale),
           lambda: pallas_decode.decode_fused(ctx, dc, res, agg.scale),
           lambda: encoding.decode_core(dc, qs, res, agg.scale), res.shape)
    return recs


def check_repairs(ctx, gen, chunks, n_clients=64, live_ctx=None,
                  reps=10) -> list[dict]:
    """K3 with n_clients (> 16) on the FedAvg shape, and K4 at the chain
    length of `live_ctx` (> 8 live limbs) on encoded values."""
    recs = []
    L = ctx.params.chain_len
    n = ctx.ring_dim
    moduli = ctx.params.moduli
    stacked = uniform_mod_q(gen, (n_clients, chunks, 2, L, n), moduli)
    weights = [1.0 / n_clients] * n_clients
    w_res, w_shoup, _ = ops._encode_weights(ctx, weights, L, 0)
    wr = torch.as_tensor(w_res, device=stacked.device)
    ws = torch.as_tensor(w_shoup, device=stacked.device)
    _record(recs, "weighted_sum_fused",
            pallas_agg.weighted_sum_fused(stacked, w_res, w_shoup, moduli[:L]),
            ops._weighted_sum_impl(ctx, stacked, wr, ws),
            lambda: pallas_agg.weighted_sum_fused(stacked, w_res, w_shoup,
                                                  moduli[:L]),
            lambda: ops._weighted_sum_impl(ctx, stacked, wr, ws), reps,
            shape=stacked.shape)
    del stacked

    live = live_ctx.params.chain_len
    vals = torch.randn((chunks, live_ctx.ring_dim), generator=gen,
                       device=gen.device) * 100
    res = encoding.encode_coeff(live_ctx, vals, live_ctx.params.scale)
    dc = live_ctx.dec_consts[live - 1]
    qs = live_ctx.q[:live]
    scale = live_ctx.params.scale
    got = pallas_decode.decode_fused(live_ctx, dc, res, scale)
    _record(recs, "decode_fused", got,
            encoding.decode_core(dc, qs, res, scale),
            lambda: pallas_decode.decode_fused(live_ctx, dc, res, scale),
            lambda: encoding.decode_core(dc, qs, res, scale), reps,
            shape=res.shape)
    err = _max_abs_err(got, vals)
    if not err <= MAX_ERR:
        raise AssertionError(f"decode at live={live}: max_err {err}")
    return recs


def check_butterfly(rot_ctx, mult_ctx, gen, chunks, reps=10) -> list[dict]:
    """K2 against its plain version at the rotation path's shapes (the key
    switch's forward batch over the extended basis and the inverse over the
    chain) and at a 64-chunk batch; K2 against K1 at N = 8192."""
    recs = []
    chain = rot_ctx.params.chain_len
    n = rot_ctx.ring_dim
    ext = np.array(list(range(chain)) + [rot_ctx.num_limbs - 1])
    tb_ext = rot_ctx.tables.take(ext)
    tb_live = rot_ctx.tables.slice_limbs(0, chain)
    cases = (
        ("ntt_fused", (1, chain, chain + 1, n), tb_ext, True),
        ("intt_fused", (1, chain, n), tb_live, False),
        ("ntt_fused", (chunks, chain, n), tb_live, True),
        ("intt_fused", (chunks, chain, n), tb_live, False))
    for name, shape, tb, fwd in cases:
        x = uniform_mod_q(gen, shape, tuple(int(q) for q in tb.q))
        kern = pallas_ntt.ntt_fused if fwd else pallas_ntt.intt_fused
        plain = ntt_mod.ntt_butterfly if fwd else ntt_mod.intt_butterfly
        _record(recs, name, kern(x, tb), plain(x, tb),
                lambda: kern(x, tb), lambda: plain(x, tb), reps)

    # Two independent kernels for one transform: K2 equals K1 bit for bit.
    L = mult_ctx.params.chain_len
    tb = mult_ctx.tables.slice_limbs(0, L)
    x = uniform_mod_q(gen, (chunks, L, mult_ctx.ring_dim),
                      mult_ctx.params.moduli)
    for fwd in (True, False):
        k2 = (pallas_ntt.ntt_fused if fwd else pallas_ntt.intt_fused)(x, tb)
        k1 = (mxu_pallas.ntt_mxu_fused if fwd
              else mxu_pallas.intt_mxu_fused)(x, tb.mxu)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"K2 differs from K1 at N=8192 (fwd={fwd})")
    return recs


def run_main_path(ctx, sk, pk, values, weights, gen) -> dict:
    """One pass of every entry point of the round; returns the outputs."""
    ct = ops.encrypt_symmetric_stacked(ctx, sk, values, gen)
    out = ops.decrypt(ctx, sk, ops.weighted_sum(ctx, ct, weights))
    ct_pk = ops.encrypt_stacked(ctx, pk, values, gen)
    out_pk = ops.decrypt(ctx, sk, ops.weighted_sum(ctx, ct_pk, weights))
    fused = ops.fedavg_round_fused(ctx, sk, values, gen, weights)
    torch.cuda.synchronize()
    return {"secret_key": out, "public_key": out_pk, "fused": fused}


def check_outputs(outs: dict, want: np.ndarray, n_values: int) -> float:
    """Finite, right shape, and within MAX_ERR of the plaintext average."""
    errs = []
    for name, o in outs.items():
        if tuple(o.shape) != want.shape or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{name}: bad output {tuple(o.shape)}")
        flat = o.cpu().numpy().reshape(-1)[:n_values].astype(np.float64)
        errs.append(float(np.max(np.abs(flat - want.reshape(-1)[:n_values]))))
    err = max(errs)
    if not err <= MAX_ERR:
        raise AssertionError(f"max_err {err} > {MAX_ERR} ({errs})")
    return err


def make_values(n_clients, n_values, chunks, n, seed=0):
    """Seeded client payloads, dense-packed into (K, chunks, N) f32, and the
    f64 plaintext weighted average (equal weights)."""
    rng = np.random.default_rng(seed)
    buf = np.zeros((n_clients, chunks * n), dtype=np.float32)
    for k in range(n_clients):
        buf[k, :n_values] = rng.standard_normal(n_values).astype(
            np.float32) * 0.1
    weights = [1.0 / n_clients] * n_clients
    want = np.tensordot(np.array(weights), buf.astype(np.float64), axes=1)
    return buf.reshape(n_clients, chunks, n), weights, want.reshape(chunks, n)


def rotation_setup(ctx, gen, width, seed=3):
    """Keys, Galois keys for r = 1, 2, .., width/2, and one encrypted
    slot-packed vector z (seeded normal x 0.1)."""
    sk, pk = keys.keygen(ctx, gen)
    z = np.random.default_rng(seed).standard_normal(
        SL.num_slots(ctx)) * 0.1
    ct = ops.encrypt_encoded(ctx, pk, SL.encode_slots(ctx, z[None]), gen,
                             ctx.params.scale)
    gks = {}
    r = 1
    while r < width:
        gks[r] = KS.make_galois_key(
            ctx, sk, KS.galois_element(r, ctx.ring_dim), gen)
        r <<= 1
    return sk, z, ct, gks


def run_rotation_path(ctx, ct, gks, width):
    rot = KS.rotate(ctx, ct, 1, gks[1])
    summed = KS.eval_sum(ctx, ct, gks, width)
    torch.cuda.synchronize()
    return rot, summed


def check_rotation(ctx, sk, z, rot, summed, width) -> tuple[float, float]:
    """Slot-decode both results: rot slot j = z[slot_rotation_map[j]];
    EvalSum slot j = sum_{r < width} z[j + r] (cyclic)."""
    errs = []
    for ct, want in (
            (rot, z[SL.slot_rotation_map(ctx.ring_dim, 1)]),
            (summed, sum(np.roll(z, -r) for r in range(width)))):
        got = SL.decode_slots(ctx, ops.decrypt_residues(ctx, sk, ct),
                              ct.scale)[0]
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"rotation path: bad output {got.shape}")
        errs.append(float(np.max(np.abs(got.real - want))))
    if not max(errs) <= MAX_ERR:
        raise AssertionError(f"rotation path: max_err {errs} > {MAX_ERR}")
    return errs[0], errs[1]


def multiply_setup(ctx, pk, gen, batch, seed=4):
    """`batch` slot-packed ciphertext pairs of seeded normal x 0.1."""
    rng = np.random.default_rng(seed)
    za = rng.standard_normal((batch, SL.num_slots(ctx))) * 0.1
    zb = rng.standard_normal((batch, SL.num_slots(ctx))) * 0.1
    scale = ctx.params.scale
    ct_a = ops.encrypt_encoded(ctx, pk, SL.encode_slots(ctx, za), gen, scale)
    ct_b = ops.encrypt_encoded(ctx, pk, SL.encode_slots(ctx, zb), gen, scale)
    return za, zb, ct_a, ct_b


def run_multiply_path(ctx, ct_a, ct_b, rlk):
    out = ops.rescale(ctx, KS.mul_ct(ctx, ct_a, ct_b, rlk))
    torch.cuda.synchronize()
    return out


def check_products(ctx, sk, za, zb, prod, count) -> float:
    first = ops.Ciphertext(prod.data[:count], prod.scale, prod.level)
    got = SL.decode_slots(ctx, ops.decrypt_residues(ctx, sk, first),
                          prod.scale)
    want = za[:count] * zb[:count]
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"multiply path: bad output {got.shape}")
    err = float(np.max(np.abs(got.real - want)))
    if not err <= MAX_ERR:
        raise AssertionError(f"multiply path: max_err {err} > {MAX_ERR}")
    return err


def write_cryptodir(params, d: pathlib.Path) -> pathlib.Path:
    """The cryptodir genCryptoContextAndKeyGen would write for `params`,
    with the committed key pair."""
    d.mkdir(parents=True, exist_ok=True)
    meta = dict(scheme="ckks", batchSize=params.batch,
                scaleFactorBits=params.scale_bits,
                mult_depth=params.mult_depth, ring_dim=params.ring_dim,
                moduli=list(params.moduli), num_base=params.num_base)
    (d / "cryptocontext.txt").write_text(json.dumps(meta))
    for name in ("key-private.txt", "key-public.txt"):
        (d / name).write_bytes((KEY_DIR / name).read_bytes())
    return d


def check_known_answers(ctx) -> None:
    """On ctx.device: threefry keygen(ctx, 0) is the committed key pair
    byte for byte, and encrypt_symmetric of linspace(-1, 1, N) under
    key(2024) has the pinned KAT digest."""
    sk, pk = keys.keygen(ctx, 0)
    for blob, name in ((S.serialize_secret_key(ctx, sk), "key-private.txt"),
                       (S.serialize_public_key(ctx, pk), "key-public.txt")):
        if blob != (KEY_DIR / name).read_bytes():
            raise AssertionError(f"keygen(ctx, 0) on {ctx.device} differs "
                                 f"from {name}")
    v = torch.as_tensor(np.linspace(-1.0, 1.0, ctx.ring_dim,
                                    dtype=np.float32)[None], device=ctx.device)
    ct = ops.encrypt_symmetric(ctx, sk, v, threefry.key(2024, ctx.device))
    digest = hashlib.sha256(S.serialize_ct(ctx, ct)).hexdigest()
    if digest != KAT_CT:
        raise AssertionError(f"KAT ciphertext digest {digest} on "
                             f"{ctx.device}")


def api_helpers(cryptodir: pathlib.Path, dev) -> dict:
    """One CKKS helper per mode, loaded from `cryptodir`; the coefficient
    modes dense-packed as the bench is."""
    kw = dict(batchSize=4096, scaleFactorBits=52, cryptodir=str(cryptodir),
              device=dev)
    hs = {"symmetric": CKKS(dense_pack=True, symmetric=True, seed=1, **kw),
          "public_key": CKKS(dense_pack=True, seed=2, **kw),
          "seeded_fresh": CKKS(dense_pack=True, seeded_fresh=True, seed=3,
                               **kw),
          "slots": CKKS(packing="slots", seed=4, **kw)}
    for h in hs.values():
        h.loadCryptoParams()
    return hs


def api_vectors(n_values: int, seed: int):
    """N_CLIENTS seeded flat f32 vectors (normal x 0.1) and their f64
    weighted average under API_WEIGHTS."""
    rng = np.random.default_rng(seed)
    vecs = [rng.standard_normal(n_values, dtype=np.float32) * np.float32(0.1)
            for _ in range(N_CLIENTS)]
    want = np.zeros(n_values)
    for w, v in zip(API_WEIGHTS, vecs):
        want += w * v.astype(np.float64)
    return vecs, want


def cnn_state_dicts() -> list:
    out = []
    for s in range(N_CLIENTS):
        torch.manual_seed(s)
        out.append(CNNOriginalFedAvg().state_dict())
    return out


def run_api_path(hs: dict, cnn_vecs, bert_vecs, slot_vecs,
                 state_dicts) -> tuple[dict, dict]:
    """Every API entry once; returns ({result: decrypted output},
    {mode: one client's blob})."""
    n = cnn_vecs[0].size
    w = API_WEIGHTS
    outs, blobs = {}, {}
    for mode in ("symmetric", "public_key", "seeded_fresh"):
        h = hs[mode]
        b = [h.encrypt(v) for v in cnn_vecs]
        blobs[mode] = b
        outs[f"bytes_{mode}"] = h.decrypt(h.computeWeightedAverage(b, w), n)
    h = hs["seeded_fresh"]
    mixed = blobs["seeded_fresh"][:2] + blobs["symmetric"][2:]
    outs["bytes_mixed"] = h.decrypt(h.computeWeightedAverage(mixed, w), n)
    h = hs["symmetric"]
    outs["round_fused"] = h.fedavg_round(cnn_vecs, w)
    outs["round_staged"] = h.fedavg_round(cnn_vecs, w, fused=False)
    outs["round_streamed"] = h.fedavg_round(bert_vecs, w)
    s = hs["slots"]
    outs["bytes_slots"] = s.decrypt(s.computeWeightedAverage(
        [s.encrypt(v) for v in slot_vecs], w), slot_vecs[0].size)
    for name, policy in POLICIES.items():
        outs[f"fhe_fedavg_{name}"] = fhe_fedavg(h, state_dicts, w, policy)
    torch.cuda.synchronize()
    return outs, {m: b[0] for m, b in blobs.items()}


def check_api(outs: dict, wants: dict, blobs: dict, state_dicts,
              dev) -> dict:
    """Each result finite, of the right shape and within MAX_ERR of its
    plaintext reference: wants["bert"] for the streamed round,
    wants["slots"] for slot mode, wants["cnn"] for the other vectors,
    plain_fedavg for the state_dicts. The seeded blob is at most FFTS_RATIO
    of the full one; each fhe_fedavg result loads into a module whose
    forward on a seeded batch is finite."""
    plain = plain_fedavg(state_dicts, API_WEIGHTS)
    ref = {"round_streamed": "bert", "bytes_slots": "slots"}
    errs = {}
    for name, got in outs.items():
        if name.startswith("fhe_fedavg_"):
            if list(got) != list(plain):
                raise AssertionError(f"{name}: keys {list(got)}")
            got_f = np.concatenate([got[k].numpy().ravel() for k in got])
            want = np.concatenate([plain[k].numpy().ravel() for k in plain])
            model = CNNOriginalFedAvg().to(dev)
            model.load_state_dict(got)
            x = torch.randn((8, 28, 28), generator=torch.Generator(
                device=dev).manual_seed(8), device=dev)
            with torch.no_grad():
                logits = model(x)
            if tuple(logits.shape) != (8, 10) or not bool(
                    torch.isfinite(logits).all()):
                raise AssertionError(f"{name}: forward gave "
                                     f"{tuple(logits.shape)} non-finite")
        else:
            got_f, want = got, wants[ref.get(name, "cnn")]
        if got_f.shape != want.shape or not np.isfinite(got_f).all():
            raise AssertionError(f"{name}: bad output {got_f.shape}")
        errs[name] = float(np.max(np.abs(got_f.astype(np.float64) - want)))
    bad = {k: e for k, e in errs.items() if not e <= MAX_ERR}
    if bad:
        raise AssertionError(f"API path: max_err above {MAX_ERR}: {bad}")
    ratio = len(blobs["seeded_fresh"]) / len(blobs["symmetric"])
    if not ratio <= FFTS_RATIO:
        raise AssertionError(f"FFTS / FFTC bytes {ratio} > {FFTS_RATIO}")
    return dict(errs, ffts_over_fftc=ratio)


def drive(name, fn):
    """Run one path with the launch counts at 0 before, read after; raise
    if a kernel of the path was not launched."""
    cuda_lib.launches.clear()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(cuda_lib.launches)
    missing = [k for k in PATH_KERNELS[name] if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{name} path never launched {missing}: "
                             f"{counts}")
    return out, counts


def profile(out_dir: pathlib.Path, runs: dict) -> dict:
    """torch.profiler over each run once (after a warm-up); the sorted
    key_averages tables go to out_dir. Returns each run's device time, the
    sum of its kernels' self device time, in microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import profile as prof, ProfilerActivity
    out_dir.mkdir(parents=True, exist_ok=True)
    device_us = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        events = p.key_averages()
        device_us[name] = sum(e.self_device_time_total for e in events
                              if e.device_type == DeviceType.CUDA)
        table = events.table(sort_by="cuda_time_total", row_limit=25)
        (out_dir / f"profile_{name}.txt").write_text(table)
        print(f"profile {name}: device_us {device_us[name]:.1f}\n{table}",
              flush=True)
    return device_us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=pathlib.Path, default=None,
                    help="write torch.profiler tables of one rotation, one "
                         "batch multiply, one API encrypt and its threefry "
                         "sampling to this directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # The plain NTT's f32 digit-plane matmul is exact only in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    gpu = card()
    print(f"card: {gpu}", flush=True)

    t0 = time.perf_counter()
    cuda_lib.lib()
    print(f"build_s: {time.perf_counter() - t0:.3f} ({gpu})", flush=True)

    t0 = time.perf_counter()
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params, dev)
    sk = S.deserialize_secret_key((KEY_DIR / "key-private.txt").read_bytes(),
                                  dev)
    pk = S.deserialize_public_key((KEY_DIR / "key-public.txt").read_bytes(),
                                  dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = params.ring_dim
    chunks = -(-CNN_PARAMS // n)
    vals_np, weights, want = make_values(N_CLIENTS, CNN_PARAMS, chunks, n)
    values = torch.as_tensor(vals_np, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    print(f"config: N={n} limbs={params.num_limbs} chain={params.chain_len} "
          f"chunks={chunks} clients={N_CLIENTS} init_s={init_s:.3f}",
          flush=True)
    rot_params = P.make_params(batch=16384, scale_bits=52, mult_depth=5,
                               ring_dim=32768)
    rot_ctx = P.make_context(rot_params, dev)
    deep_ctx = P.make_context(P.make_params(batch=4096, scale_bits=52,
                                            mult_depth=8), dev)

    recs = check_kernels(ctx, sk, values, weights, gen)
    recs += check_repairs(ctx, gen, chunks, 64, deep_ctx)
    recs += check_butterfly(rot_ctx, ctx, gen, 64)
    for r in recs:
        print(f"kernel {r['name']} {r['shape']}: bit-exact, "
              f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms ({gpu})",
              flush=True)
    print(f"kernel ntt_fused == ntt_mxu_fused at N={n} (fwd and inv): "
          f"bit-exact", flush=True)
    del deep_ctx

    # FedAvg path (bench.py's round).
    outs, fed_counts = drive("fedavg", lambda: run_main_path(
        ctx, sk, pk, values, weights, gen))
    max_err = check_outputs(outs, want, CNN_PARAMS)
    print(f"main path: max_err {max_err!r} launches {fed_counts}", flush=True)
    del outs

    # Rotation path (config 4).
    t0 = time.perf_counter()
    rsk, z, rct, gks = rotation_setup(rot_ctx, gen, ROT_WIDTH)
    torch.cuda.synchronize()
    print(f"rotation setup: N={rot_ctx.ring_dim} chain="
          f"{rot_params.chain_len} limbs={rot_params.num_limbs} galois_keys="
          f"{sorted(gks)} setup_s={time.perf_counter() - t0:.3f}", flush=True)
    (rot, summed), rot_counts = drive("rotation", lambda: run_rotation_path(
        rot_ctx, rct, gks, ROT_WIDTH))
    rot_err, sum_err = check_rotation(rot_ctx, rsk, z, rot, summed,
                                      ROT_WIDTH)
    print(f"rotation path: rotate(1) max_err {rot_err!r}, eval_sum("
          f"{ROT_WIDTH}) max_err {sum_err!r} launches {rot_counts}",
          flush=True)
    del rot, summed

    # Multiply path (config 2).
    t0 = time.perf_counter()
    rlk = KS.make_relin_key(ctx, sk, gen)
    za, zb, ct_a, ct_b = multiply_setup(ctx, pk, gen, MULT_BATCH)
    torch.cuda.synchronize()
    print(f"multiply setup: N={n} live={params.chain_len} batch={MULT_BATCH} "
          f"setup_s={time.perf_counter() - t0:.3f}", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    prod, mult_counts = drive("multiply", lambda: run_multiply_path(
        ctx, ct_a, ct_b, rlk))
    mult_peak = torch.cuda.max_memory_allocated(dev)
    mult_err = check_products(ctx, sk, za, zb, prod, MULT_CHECKED)
    print(f"multiply path: {MULT_CHECKED} products max_err {mult_err!r} "
          f"launches {mult_counts}", flush=True)
    del prod

    mult_ms = cuda_ms(lambda: run_multiply_path(ctx, ct_a, ct_b, rlk), 3)
    print(f"phase mult_relin_rescale_{MULT_BATCH}_ms: {mult_ms:.4f} "
          f"ct_mults_per_s: {MULT_BATCH / (mult_ms / 1e3):.1f} "
          f"peak_mem_bytes: {mult_peak} ({gpu})", flush=True)
    rot_ms = cuda_ms(lambda: KS.rotate(rot_ctx, rct, 1, gks[1]),
                     TIMED_ROUNDS)
    sum_ms = cuda_ms(lambda: KS.eval_sum(rot_ctx, rct, gks, ROT_WIDTH), 3)
    print(f"phase rotate_ms: {rot_ms:.4f} eval_sum_{ROT_WIDTH}_ms: "
          f"{sum_ms:.4f} ({gpu})", flush=True)
    if args.profile is not None:
        profile(args.profile, {
            "rotate": lambda: KS.rotate(rot_ctx, rct, 1, gks[1]),
            "mult_relin_rescale": lambda: run_multiply_path(ctx, ct_a, ct_b,
                                                            rlk)})
    del ct_a, ct_b, rlk, gks, rct

    ct = ops.encrypt_symmetric_stacked(ctx, sk, values, gen)
    agg = ops.weighted_sum(ctx, ct, weights)
    torch.cuda.reset_peak_memory_stats(dev)
    phases = {
        "encrypt_cohort": lambda: ops.encrypt_symmetric_stacked(
            ctx, sk, values, gen),
        "aggregate": lambda: ops.weighted_sum(ctx, ct, weights),
        "decrypt": lambda: ops.decrypt(ctx, sk, agg),
        "encrypt_publickey_cohort": lambda: ops.encrypt_stacked(
            ctx, pk, values, gen),
        "round_fused": lambda: ops.fedavg_round_fused(
            ctx, sk, values, gen, weights),
    }
    times = {k: cuda_ms(fn, TIMED_ROUNDS) for k, fn in phases.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    for k, ms in times.items():
        print(f"phase {k}_ms: {ms:.4f} ({gpu})", flush=True)
    round_ms = sum(times[k] for k in ("encrypt_cohort", "aggregate",
                                      "decrypt"))
    print(f"phase enc+agg+dec_ms: {round_ms:.4f} peak_mem_bytes: {peak} "
          f"({gpu})", flush=True)
    del ct, agg

    # API path (fed/api.py, fed/fedavg.py) at the bench configuration.
    t0 = time.perf_counter()
    check_known_answers(ctx)
    print(f"known answers on {dev}: keygen(ctx, 0) == committed key files, "
          f"KAT ciphertext sha256 {KAT_CT}: ok", flush=True)
    hs = api_helpers(write_cryptodir(params, ROOT / "build" / "api_cryptodir"),
                     dev)
    cnn_vecs, cnn_want = api_vectors(CNN_PARAMS, 10)
    bert_vecs, bert_want = api_vectors(BERT_PARAMS, 11)
    slot_vecs, slot_want = api_vectors(SLOT_VALUES, 12)
    sds = cnn_state_dicts()
    bert_chunks = -(-BERT_PARAMS // n)
    print(f"api setup: clients={N_CLIENTS} cnn={CNN_PARAMS} bert={BERT_PARAMS}"
          f" ({bert_chunks} chunks, {-(-bert_chunks // 1024)} slices of 1024)"
          f" slots={SLOT_VALUES} setup_s={time.perf_counter() - t0:.3f}",
          flush=True)
    (api_outs, blobs), api_counts = drive("api", lambda: run_api_path(
        hs, cnn_vecs, bert_vecs, slot_vecs, sds))
    api_errs = check_api(api_outs, dict(cnn=cnn_want, bert=bert_want,
                                        slots=slot_want), blobs, sds, dev)
    print(f"api path: max_err {json.dumps(api_errs)} launches {api_counts}",
          flush=True)
    del api_outs, bert_want

    h, hseed = hs["symmetric"], hs["seeded_fresh"]
    cohort = [h.encrypt(v) for v in cnn_vecs]
    agg_blob = h.computeWeightedAverage(cohort, API_WEIGHTS)
    sct = S.deserialize_seeded_ct(ctx, hseed.encrypt(cnn_vecs[0]))
    one = h.pack_cohort(cnn_vecs[:1])[0]
    key = threefry.key(5, dev)
    one_ct = ops.encrypt_symmetric(ctx, sk, one, key)
    api_phases = {
        "api_serialize_ct": lambda: S.serialize_ct(ctx, one_ct),
        "api_deserialize_ct": lambda: S.deserialize_ct(ctx, cohort[0]),
        "api_encrypt_per_client": lambda: h.encrypt(cnn_vecs[0]),
        "api_encrypt_seeded_per_client": lambda: hseed.encrypt(cnn_vecs[0]),
        "api_encrypt_publickey_per_client": lambda: hs["public_key"].encrypt(
            cnn_vecs[0]),
        "api_computeWeightedAverage": lambda: h.computeWeightedAverage(
            cohort, API_WEIGHTS),
        "api_decrypt": lambda: h.decrypt(agg_blob, CNN_PARAMS),
        "api_round_fused": lambda: h.fedavg_round(cnn_vecs, API_WEIGHTS),
        "api_round_staged": lambda: h.fedavg_round(cnn_vecs, API_WEIGHTS,
                                                   fused=False),
        "ffts_expand": lambda: ops.expand_seeded(ctx, sct),
    }
    for k, fn in api_phases.items():
        print(f"phase {k}_ms: {cuda_ms(fn, 3):.4f} ({gpu})", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    stream_ms = cuda_ms(lambda: h.fedavg_round(bert_vecs, API_WEIGHTS), 1)
    print(f"phase api_round_streamed_bert_ms: {stream_ms:.4f} peak_mem_bytes: "
          f"{torch.cuda.max_memory_allocated(dev)} ({gpu})", flush=True)
    del bert_vecs

    # Threefry sampling against the encrypt it feeds (device side).
    enc_ms = cuda_ms(lambda: ops.encrypt_symmetric(ctx, sk, one, key),
                     TIMED_ROUNDS)
    samp_ms = cuda_ms(lambda: ops._sym_samples(ctx, key, one.shape),
                      TIMED_ROUNDS)
    cohort_tf_ms = cuda_ms(lambda: ops.encrypt_symmetric_stacked(
        ctx, sk, values, key), TIMED_ROUNDS)
    print(f"phase encrypt_threefry_ms: {enc_ms:.4f} threefry_sampling_ms: "
          f"{samp_ms:.4f} share: {samp_ms / enc_ms:.4f}; encrypt_cohort "
          f"threefry_ms: {cohort_tf_ms:.4f} generator_ms: "
          f"{times['encrypt_cohort']:.4f} ({gpu})", flush=True)
    if args.profile is not None:
        us = profile(args.profile, {
            "api_encrypt": lambda: ops.encrypt_symmetric(ctx, sk, one, key),
            "threefry_sampling": lambda: ops._sym_samples(ctx, key,
                                                          one.shape)})
        print(f"profile threefry share of the API encrypt's device time: "
              f"{us['threefry_sampling'] / us['api_encrypt']:.4f} ({gpu})",
              flush=True)

    launches = collections.Counter()
    for c in (fed_counts, rot_counts, mult_counts, api_counts):
        launches.update(c)
    for r in recs:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
