#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases (each raises on failure, so the script exits non-zero):
  1. require a CUDA device; print the card's name and power limit;
  2. build the kernel library from csrc/ (one nvcc per source, in parallel,
     into build/fhe_fed_tpu_torch/);
  3. hold every kernel against its plain PyTorch version, bit-exactly, at
     the shapes the paths give it, and time both with CUDA events: K1, K3
     and K4 at the FedAvg shapes, K1 at each of the multiply path's six
     calls for its 2048 ciphertexts (the key switch's inverse and its
     forward over the extended basis, ModDown's inverse on the special
     prime and its forward, the rescale's inverse and forward), K1 at
     N = 2048 (the mma_sync body by the shape rule), K3 also at 64 clients,
     K4 also at 11 live limbs, K2 at the rotation path's shapes and a
     64-chunk batch, and K2 against K1 at N = 8192 (the threshold path's
     shapes are held in phase 9). Each record carries the call's time
     (`ms`, CUDA events around back-to-back calls, the wrapper's host work
     included where it exceeds the kernel's) and the kernel's own
     (`device_ms`, the same calls replayed from a CUDA graph), its bound
     (bytes over 3.35 TB/s, int8 operations over 1,979 TOP/s) and, for K1,
     the torch._int_mm yardstick of its digit products (gemm_library_ms),
     for K3 torch.sum over the client axis (stream_library_ms: the same
     bytes, not K3's function), for K4 its device time over rotating copies
     of its input, more than the 50 MB L2 (cold_device_ms);
  4. the FedAvg path at the bench configuration (CNN_OriginalFedAvg,
     1,663,370 parameters x 3 clients, batch 4096 / scale 2^52 / N 8192,
     204 dense chunks) with the committed keys, its context and keys made
     with no device given (the default: the card): secret-key encrypt ->
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
  8. time each phase after a warm-up;
  9. the threshold path (ckks/threshold.py, fed/threshold_api.py): known
     answers on the card at mkhe_bench's point (batched ceremonies equal
     the per-party ones bit for bit for keygen, the relinearisation key and
     a Galois key; keygen equals the CPU's), then ThresholdCKKS (3 parties,
     batch 4096, 2^52, N 8192, not dense: 407 chunks of the CNN) runs the
     keygen ceremony, 3 x 1,663,370 values through encrypt ->
     computeWeightedAverage -> threshold decrypt, fedavg_round fused
     (threshold_round_fused, K3 on (3, 407, 2, 4, 8192)) and staged, and
     three partial_decrypt + fuse_partials; then mkhe_bench's circuit
     (batch 4096, 2^51, depth 2: N 8192, chain 5 + 1 special prime) on the
     CNN's values in 407 chunks: batched keygen and relinearisation key,
     mul_scalar(0.5) + add, mul_ct + rescale under the joint key, and the
     threshold decrypt of both (K4 at 5 and 4 live limbs). Every result
     within 1e-6 of the plaintext, the ct x ct product within 2^-20 of its
     largest value of the f64 negacyclic square (the first 4 chunks), and
     one party's share decodes to noise. Then each kernel against its plain
     version, bit-exactly, at this path's shapes: for the helper (4 live
     limbs) K1 on the smudging batch (3, 407, 4, 8192), K3 on the fused
     round's stack (3, 407, 2, 4, 8192), the fusion's K1 inverse and K4 at
     (407, 4, 8192); for the mkhe circuit the same K1 and K4 steps at 5
     live limbs and at 4 after the rescale; each phase timed;
 10. the masking path (fed/masking.py, native/paillier.py; 4 learners,
     2048-bit Paillier, 17-bit ring, 13-bit precision): the offline
     protocol (keygen, each learner's encrypted pad, the homomorphic sum,
     its decryption, a dropout recovery over learners 0, 2, 3) and a round
     on it at 8,500 values (100 Paillier plaintexts per learner: cut from
     the CNN's 1,663,370 because the offline phase is host bignum work of
     minutes per learner at model size); the online round (encrypt ->
     computeWeightedAverage -> decrypt) at the full 1,663,370 values x 4,
     on pads written by genPaillierRandOffline's draw (os.urandom & mask)
     with their ring sum, without the Paillier step. It launches none of
     our kernels: the path checks that its fixed-point codes, masked values
     and sum are tensors on the card, that each result is within 4 x 2^-13
     of the plaintext mean, and that a CPU helper gives the same bytes;
     each phase timed (offline ones on the host clock);
 11. the deep path: CKKS at mult_depth 24, the deepest chain make_params
     accepts (batch 4096, 2^52, dense, secret-key: N 32768, 27 live limbs,
     51 chunks of the CNN), keygen, then fedavg_round fused and staged
     and fhe_fedavg over the CNN state_dicts, within 1e-6 of the plaintext
     (K2, K3, K4); then K3 and K4 bit-exact at 27 live limbs on the path's
     shapes, K2 at its two batches there (the cohort encrypt's forward on
     (3, 51, 27, 32768), the decrypt's inverse on (51, 27, 32768)), K3 and
     K4 at 17 (mult_depth 14, N 32768), K1 at 18 and 28 limbs
     (ring_dim 16384, mult_depth 14 / 24) on 102 polynomials; rounds timed;
 12. the ring65536 path: make_params(batch 4096, 2^40, mult_depth 1,
     ring_dim 65536), the reference's one-device N = 65536 point, for the
     CNN's 3 x 1,663,370 values in 26 chunks: keygen -> public-key encrypt
     -> weighted sum -> decrypt within 1e-6 (K2's two-block body, K3, K4);
     K2 forward and inverse bit-exact at (26, 4, 65536); the round timed.
 13. the zoo path: fhe_fed_tpu_torch.benchmarks.model_bench.main over all 15
     zoo models at their published widths (linear .. bert, 316.6 M
     parameters; built on the card from seed 0), model_bench's default
     point (3 clients, batch 4096, 2^52, N 8192, secret key, 4,096 values
     a chunk), models above 512 chunks streamed in slices of 512, each
     phase after a warm-up; then --fused and --scheme ckks-threshold over
     cnn_fedavg and resnet50, and selective_bench at rates 0.1 and 1.0 on
     resnet50 and bert. Every round within 1e-6 of the plaintext mean, and
     every model's forward on the card (at zoo.example_inputs) with the
     decrypted average within 1e-3 of max(1, |y|) of the forward with the
     plaintext average; then K1, K3 and K4 bit-exact at the slice's shapes
     ((1536, 4, 8192), (3, 512, 2, 4, 8192), (512, 4, 8192)). Results go to
     build/zoo/.
Each path runs with the launch counts set to 0 just before it and read just
after; it fails if a kernel of that path was not launched. With --profile,
one rotation, one batch multiply, one API encrypt and its threefry
sampling step, one fused threshold round and its smudging step are traced
with torch.profiler and the tables written to DIR. The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
import itertools
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from fhe_fed_tpu_torch import cuda_lib
from fhe_fed_tpu_torch import CKKS, SelectivePolicy, fhe_fedavg, plain_fedavg
from fhe_fed_tpu_torch import Masking, ThresholdCKKS
from fhe_fed_tpu_torch.ntt import mxu, mxu_pallas, ntt as ntt_mod, pallas_ntt
from fhe_fed_tpu_torch.ckks import params as P, serial as S, ops, encoding
from fhe_fed_tpu_torch.ckks import pallas_agg, pallas_decode
from fhe_fed_tpu_torch.ckks import keys, keyswitch as KS, slots as SL
from fhe_fed_tpu_torch.ckks import threshold as thr
from fhe_fed_tpu_torch.ckks.keys import uniform_mod_q
from fhe_fed_tpu_torch.benchmarks import model_bench, selective_bench
from fhe_fed_tpu_torch.fed import masking as M
from fhe_fed_tpu_torch.fed.fedavg import tree_leaves, tree_map
from fhe_fed_tpu_torch.models.basic import CNNOriginalFedAvg
from fhe_fed_tpu_torch.models import zoo
from fhe_fed_tpu_torch.native import paillier
from fhe_fed_tpu_torch.rns import primes
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
    "threshold": ("ntt_mxu_fused", "intt_mxu_fused", "weighted_sum_fused",
                  "decode_fused"),
    # Host Paillier and int64 ring sums: no kernel of ours; the path checks
    # that its tensors live on the card instead.
    "masking": (),
    # N = 32768 and 65536 have no four-step split: K2 serves both.
    "deep": ("ntt_fused", "intt_fused", "weighted_sum_fused", "decode_fused"),
    "ring65536": ("ntt_fused", "intt_fused", "weighted_sum_fused",
                  "decode_fused"),
    "zoo": ("ntt_mxu_fused", "intt_mxu_fused", "weighted_sum_fused",
            "decode_fused"),
}
THR_PARTIES = 3
THR_BATCH = 4096          # ThresholdCKKS(batch 4096): 407 chunks for the CNN
MKHE_CHECKED = 4          # product chunks held against the f64 convolution
# The coefficient-packed ct x ct product decodes to values of a few hundred;
# its error is the f32 decode's rounding (2**-24 relative) plus noise far
# below it, so it is bounded relative to the largest expected value.
MKHE_REL_BOUND = 2.0 ** -20
MASK_LEARNERS = 4
MASK_OFFLINE_VALUES = 8_500   # 100 Paillier plaintexts of 85 values each
MASK_GEOMETRY = dict(modulus_bits=2048, num_bits=17, precision_bits=13)
# The deep path: make_params' mult_depth 14 and 24 give 17 and 27 live
# limbs at N = 32768 (18 and 28 moduli at ring_dim 16384 for K1).
DEEP_DEPTHS = (14, 24)
RING_65536 = dict(batch=4096, scale_bits=40, mult_depth=1, ring_dim=65536)
# The zoo path: model_bench's default point (batch 4096 values a chunk, not
# dense), streamed in slices of 512 chunks; the fused and threshold runs and
# selective_bench on these models.
ZOO_BATCH = 4096          # model_bench's --batch: values a chunk
ZOO_MAX_CHUNKS = 512
ZOO_SIDE_MODELS = ("cnn_fedavg", "resnet50")
ZOO_SELECTIVE_MODELS = ("resnet50", "bert")
ZOO_SELECTIVE_RATES = ("0.1", "1.0")
# The forward on the decrypted average against the forward on the plaintext
# average, max |dy| / max(1, max |y|) over the outputs: with every weight
# moved by up to the 1e-6 gate at random, the zoo's worst is 1.8e-4 (ViT,
# CPU, seed 0), and the rounds' errors are ~30x below the gate.
ZOO_FWD_REL = 1e-3


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


def graph_ms(fn, reps: int) -> float:
    """The device's milliseconds per call, without the host's: `reps` calls
    captured in one CUDA graph (after one warm-up call), the graph replayed
    once to warm up and once timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


# The least time the card could take (bound_ms): the larger of the bytes a
# call must move (each input read once, each output written once) over the
# HBM rate and its tensor-core operations over the int8 rate (NVIDIA H100
# SXM data sheet, dense, 700 W). K2, K3 and K4 run on the CUDA cores, whose
# integer rate the data sheet does not give: their bound is bytes alone.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2 ** 20


def io_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_work(x: torch.Tensor, mt, forward: bool) -> tuple[int, int]:
    """K1's int8 tensor-core operations (2 per multiply-add of both digit
    products) and bytes (the residues in and out, the tables it reads)."""
    L, n = x.shape[-2], x.shape[-1]
    polys = x.numel() // n
    n1, n2 = mt.n1, mt.n2
    macs = polys * (n2 * (4 * n1) ** 2 + n1 * (4 * n2) ** 2)
    tabs, _, _ = mxu_pallas.operands(mt, forward)
    return 2 * macs, 2 * io_bytes(x) + io_bytes(*tabs)


def bound(work: tuple[int, int]) -> tuple[float, str]:
    ops, nbytes = work
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes")


def k1_gemm_library_ms(shape, mt, forward: bool, gen, reps=10) -> float:
    """Yardstick for K1's tensor-core part only, never called by the port:
    torch._int_mm (cuBLAS int8) over the same digit products as K1 on
    `shape` (B, L, N), both stages, summed over the limbs. Not K1's
    function: no reassembly, twiddle, digit split or transpose."""
    B, L = shape[0], shape[1]
    n1, n2 = mt.n1, mt.n2
    dev = gen.device
    mats = []
    for rows, S in (((n2, n1), (n1, n2)) if forward else ((n1, n2), (n2, n1))):
        a = torch.randint(-128, 128, (B * rows, 4 * S), generator=gen,
                          device=dev, dtype=torch.int8)
        w = torch.randint(-128, 128, (4 * S, 4 * S), generator=gen,
                          device=dev, dtype=torch.int8)
        mats.append((a, w.t().contiguous().t()))      # column-major B

    def run():
        for _ in range(L):
            for a, w in mats:
                torch._int_mm(a, w)
    return cuda_ms(run, reps)


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def _record(recs, name, got, want, fn, plain_fn, reps, work, plain_reps=3,
            shape=None, **extra):
    """Raise unless `got` equals `want` bit for bit; else append the
    kernel's record (`shape`: its input's, by default the output's) with
    the call's time (`ms`, host work included where it exceeds the
    kernel's), the kernel's own (`device_ms`, graph_ms), the plain
    version's and the bound of `work` (ops, bytes); `extra` keys too (K1:
    its body)."""
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
    bound_ms, bound_by = bound(work)
    recs.append(dict(name=name, route="cuda", source=src, replaces=rep,
                     shape=list(got.shape if shape is None else shape),
                     max_abs_err=err,
                     ms=cuda_ms(fn, reps), device_ms=graph_ms(fn, reps),
                     plain_ms=cuda_ms(plain_fn, plain_reps),
                     bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                     **extra))


def record_k3(recs, ctx, stacked, weights, reps) -> None:
    """K3 on `stacked` (K, chunks, 2, live, N) with `weights`, against
    its plain version; the record also times stream_library_ms,
    torch.sum(stacked, 0, dtype=int32): the same bytes read and written
    without the modular products, a ceiling on the bandwidth K3 can reach
    and not its function."""
    live = stacked.shape[3]
    w_res, w_shoup, _ = ops._encode_weights(ctx, weights, live, 0)
    block = pallas_agg.weight_block(w_res, w_shoup, ctx.params.moduli[:live])
    wr = torch.as_tensor(w_res, device=stacked.device)
    ws = torch.as_tensor(w_shoup, device=stacked.device)
    got = pallas_agg.weighted_sum_fused(stacked, block)
    _record(recs, "weighted_sum_fused", got,
            ops._weighted_sum_impl(ctx, stacked, wr, ws),
            lambda: pallas_agg.weighted_sum_fused(stacked, block),
            lambda: ops._weighted_sum_impl(ctx, stacked, wr, ws), reps,
            (0, io_bytes(stacked, got)), shape=stacked.shape,
            stream_library_ms=cuda_ms(
                lambda: torch.sum(stacked, 0, dtype=torch.int32), reps))


def record_k4(recs, ctx, res, scale, reps) -> torch.Tensor:
    """K4 on `res` (chunks, live, N) at `scale` against its plain version;
    the record also gives cold_device_ms, the kernel's device time over
    copies of `res` taken in turn, more than three times the 50 MB L2 in
    all, so that no call finds its input in L2. Returns the decode."""
    live = res.shape[1]
    dc, qs = ctx.dec_consts[live - 1], ctx.q[:live]
    got = pallas_decode.decode_fused(ctx, dc, res, scale)
    copies = [res.clone()
              for _ in range(min(64, 3 * L2_BYTES // io_bytes(res) + 2))]
    turn = itertools.count()
    cold = graph_ms(lambda: pallas_decode.decode_fused(
        ctx, dc, copies[next(turn) % len(copies)], scale), 2 * len(copies))
    del copies
    _record(recs, "decode_fused", got,
            encoding.decode_core(dc, qs, res, scale),
            lambda: pallas_decode.decode_fused(ctx, dc, res, scale),
            lambda: encoding.decode_core(dc, qs, res, scale), reps,
            (0, io_bytes(res, got)), shape=res.shape, cold_device_ms=cold)
    return got


def print_records(recs: list[dict], gpu: str) -> None:
    for r in recs:
        body = f" [{r['body']}]" if "body" in r else ""
        print(f"kernel {r['name']}{body} {r['shape']}: bit-exact, "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}) vs plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) ({gpu})", flush=True)


def check_kernels(ctx, sk, values, weights, gen, reps=10) -> list[dict]:
    """Each FedAvg kernel against its plain version at the shapes `values`
    (K, chunks, N) gives the FedAvg path; raises on any bit difference."""
    K, chunks, n = values.shape
    L = ctx.params.chain_len
    moduli = ctx.params.moduli
    mt = ctx.tables.mxu.slice_limbs(0, L)
    recs = []
    x = uniform_mod_q(gen, (K * chunks, L, n), moduli)
    xe = uniform_mod_q(gen, (chunks, L, n), moduli)
    for fwd, xi in ((True, x), (False, xe)):
        kern, plain = k1_pair(fwd)
        _record(recs, kern.__name__, kern(xi, mt), plain(xi, mt),
                lambda: kern(xi, mt), lambda: plain(xi, mt), reps,
                k1_work(xi, mt, fwd), **k1_extra(mt),
                gemm_library_ms=k1_gemm_library_ms(xi.shape, mt, fwd, gen))

    record_k3(recs, ctx, uniform_mod_q(gen, (K, chunks, 2, L, n), moduli),
              weights, reps)
    # Real decrypt residues of an aggregated round.
    agg = ops.weighted_sum(
        ctx, ops.encrypt_symmetric_stacked(ctx, sk, values, gen), weights)
    record_k4(recs, ctx, ops.decrypt_residues(ctx, sk, agg), agg.scale, reps)
    return recs


def k1_pair(forward: bool):
    """K1's wrapper and its plain version for one direction."""
    return ((mxu_pallas.ntt_mxu_fused, mxu.ntt_mxu) if forward
            else (mxu_pallas.intt_mxu_fused, mxu.intt_mxu))


def k1_extra(mt) -> dict:
    """K1 records name the body the shape rule runs."""
    return dict(body=mt.body)


def chunked(fn, rows: int = 512):
    """fn(x, mt) over slices of `rows` along x's first axis, concatenated:
    the plain NTT keeps ~40 bytes per coefficient alive, too much for the
    multiply path's batches in one call."""
    return lambda x, mt: torch.cat([fn(x[i:i + rows], mt)
                                    for i in range(0, x.shape[0], rows)])


def check_multiply_kernels(ctx, gen, batch, reps=10) -> list[dict]:
    """K1 at every call the multiply path (mul_ct + relinearise + rescale
    of `batch` pairs) makes, on the tables it passes: key_switch's inverse
    and its forward over the extended basis (MxuNttTables.take: the chain
    and the special prime), ModDown's inverse on the special prime alone
    and its forward, the rescale's inverse on the top limb and its forward.
    Uniform residues; bit-exact against the plain version, timed."""
    L, top, n = ctx.params.chain_len, ctx.num_limbs - 1, ctx.ring_dim
    ext = list(range(L)) + [top]
    tab = ctx.tables
    calls = (   # forward, tables, input shape, limbs of the input
        (False, tab.slice_limbs(0, L), (batch, L, n), range(L)),
        (True, tab.take(np.array(ext)), (batch, L, len(ext), n), ext),
        (False, tab.slice_limbs(top, top + 1), (batch, 1, n), [top]),
        (True, tab.slice_limbs(0, L), (batch, L, n), range(L)),
        (False, tab.slice_limbs(L - 1, L), (batch, 2, 1, n), [L - 1]),
        (True, tab.slice_limbs(0, L - 1), (batch, 2, L - 1, n),
         range(L - 1)),
    )
    recs = []
    for fwd, tables, shape, limbs in calls:
        mt = tables.mxu
        x = uniform_mod_q(gen, shape, tuple(ctx.params.moduli[i]
                                            for i in limbs))
        kern, plain = k1_pair(fwd)
        plain = chunked(plain)
        _record(recs, kern.__name__, kern(x, mt), plain(x, mt),
                lambda: kern(x, mt), lambda: plain(x, mt), reps,
                k1_work(x, mt, fwd), **k1_extra(mt))
        del x
    return recs


def check_k1_small_ring(gen, reps=10) -> list[dict]:
    """K1 at a ring the wgmma body does not take (N = 2048: 32 x 64), where
    the shape rule runs the mma_sync body, against its plain version."""
    moduli = primes.ntt_primes(2048, 4)
    mt = mxu.make_mxu_tables(2048, moduli, device=gen.device)
    x = uniform_mod_q(gen, (204, 4, 2048), moduli)
    recs = []
    for fwd in (True, False):
        kern, plain = k1_pair(fwd)
        _record(recs, kern.__name__, kern(x, mt), plain(x, mt),
                lambda: kern(x, mt), lambda: plain(x, mt), reps,
                k1_work(x, mt, fwd), **k1_extra(mt))
    return recs


def check_repairs(ctx, gen, chunks, n_clients=64, live_ctx=None,
                  reps=10) -> list[dict]:
    """K3 with n_clients (> 16) on the FedAvg shape, and K4 at the chain
    length of `live_ctx` (> 8 live limbs) on encoded values."""
    recs = []
    L = ctx.params.chain_len
    record_k3(recs, ctx, uniform_mod_q(
        gen, (n_clients, chunks, 2, L, ctx.ring_dim), ctx.params.moduli),
        [1.0 / n_clients] * n_clients, reps)
    record_k4_encoded(recs, live_ctx, gen, chunks, reps)
    return recs


def record_k4_encoded(recs, ctx, gen, chunks, reps) -> None:
    """K4 at ctx's chain length on `chunks` encoded polynomials of seeded
    values (normal x 100), the decode also within MAX_ERR of the values."""
    live = ctx.params.chain_len
    vals = torch.randn((chunks, ctx.ring_dim), generator=gen,
                       device=gen.device) * 100
    res = encoding.encode_coeff(ctx, vals, ctx.params.scale)
    got = record_k4(recs, ctx, res, ctx.params.scale, reps)
    err = _max_abs_err(got, vals)
    if not err <= MAX_ERR:
        raise AssertionError(f"decode at live={live}: max_err {err}")


def record_k2(recs, tb, shape, forward: bool, gen, reps) -> None:
    """K2 on uniform residues of `shape` (..., L, N) under tables `tb`,
    against its plain version; bytes: the residues in and out and the
    (twiddle, Shoup) pairs of the direction."""
    x = uniform_mod_q(gen, shape, tuple(int(q) for q in tb.q))
    kern = pallas_ntt.ntt_fused if forward else pallas_ntt.intt_fused
    plain = ntt_mod.ntt_butterfly if forward else ntt_mod.intt_butterfly
    got = kern(x, tb)
    _record(recs, kern.__name__, got, plain(x, tb), lambda: kern(x, tb),
            lambda: plain(x, tb), reps,
            (0, io_bytes(x, got, tb.tw_fwd if forward else tb.tw_inv)))


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
        ((1, chain, chain + 1, n), tb_ext, True),
        ((1, chain, n), tb_live, False),
        ((chunks, chain, n), tb_live, True),
        ((chunks, chain, n), tb_live, False))
    for shape, tb, fwd in cases:
        record_k2(recs, tb, shape, fwd, gen, reps)

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


def check_k1_deep(gen, batch, reps=10) -> list[dict]:
    """K1 at 18 and 28 limbs (make_params(ring_dim=16384, mult_depth=14 /
    24): the moduli of a fresh ciphertext and the special prime), forward
    and inverse on `batch` polynomials, against its plain version."""
    recs = []
    for depth in DEEP_DEPTHS:
        moduli = P.make_params(batch=4096, scale_bits=52, mult_depth=depth,
                               ring_dim=16384).moduli
        mt = mxu.make_mxu_tables(16384, moduli, device=gen.device)
        x = uniform_mod_q(gen, (batch, len(moduli), 16384), moduli)
        for fwd in (True, False):
            kern, plain = k1_pair(fwd)
            _record(recs, kern.__name__, kern(x, mt), plain(x, mt),
                    lambda: kern(x, mt), lambda: plain(x, mt), reps,
                    k1_work(x, mt, fwd), **k1_extra(mt))
        del x, mt
    return recs


def deep_helper(cryptodir: pathlib.Path, dev, seed=13) -> CKKS:
    """The bench configuration's drop-in helper (batch 4096, 2^52, dense,
    secret-key) at the deepest chain make_params accepts, mult_depth 24:
    N = 32768, 27 live limbs; keys generated into cryptodir."""
    h = CKKS("ckks", 4096, 52, cryptodir=str(cryptodir),
             mult_depth=DEEP_DEPTHS[-1], dense_pack=True, symmetric=True,
             seed=seed, device=dev)
    h.genCryptoContextAndKeyGen()
    return h


def run_deep_path(h: CKKS, cnn_vecs, state_dicts) -> dict:
    """The bench round through the drop-in surface: fedavg_round fused
    and staged (cohort encrypt -> weighted sum -> decrypt) and fhe_fedavg
    over CNN state_dicts."""
    outs = {"round_fused": h.fedavg_round(cnn_vecs, API_WEIGHTS),
            "round_staged": h.fedavg_round(cnn_vecs, API_WEIGHTS,
                                           fused=False),
            "fhe_fedavg_full": fhe_fedavg(h, state_dicts, API_WEIGHTS)}
    torch.cuda.synchronize()
    return outs


def check_deep_kernels(h: CKKS, cnn_vecs, gen, reps=10) -> list[dict]:
    """K3 and K4 at 27 live limbs on the deep path's shapes (the cohort
    stack, the decrypt residues of an aggregated round), K2 at its two
    (the cohort encrypt's forward batch, the decrypt's inverse), and K3
    and K4 at 17 live limbs (make_params(mult_depth=14), N = 32768:
    uniform stack, encoded values), each against its plain version."""
    recs = []
    ctx, sk = h.ctx, h._sk
    values = h.pack_cohort(cnn_vecs)
    chunks = values.shape[1]
    for depth in DEEP_DEPTHS:
        c = ctx if depth == DEEP_DEPTHS[-1] else P.make_context(
            P.make_params(batch=4096, scale_bits=52, mult_depth=depth),
            gen.device)
        L = c.params.chain_len
        record_k3(recs, c, uniform_mod_q(
            gen, (N_CLIENTS, chunks, 2, L, c.ring_dim), c.params.moduli),
            API_WEIGHTS, reps)
        if c is ctx:
            agg = ops.weighted_sum(ctx, ops.encrypt_symmetric_stacked(
                ctx, sk, values, gen), API_WEIGHTS)
            record_k4(recs, ctx, ops.decrypt_residues(ctx, sk, agg),
                      agg.scale, reps)
            del agg
            # K2 at the path's two batches: the cohort encrypt's forward
            # (ops._sym_c0 on (clients, chunks, live, N)) and the
            # decrypt's inverse (ops.decrypt_residues on (chunks, live, N)).
            tb = ctx.tables.slice_limbs(0, L)
            record_k2(recs, tb, (*values.shape[:2], L, ctx.ring_dim), True,
                      gen, reps)
            record_k2(recs, tb, (chunks, L, ctx.ring_dim), False, gen, reps)
        else:
            record_k4_encoded(recs, c, gen, chunks, reps)
        del c
    return recs


def ring65536_setup(dev, n_values: int, seed=14):
    """make_params(batch 4096, 2^40, mult_depth 1, ring_dim 65536), the
    reference's one-device N = 65536 point (tests/test_dist_ckks.py), and
    N_CLIENTS seeded payloads of n_values dense-packed into its ring."""
    ctx = P.make_context(P.make_params(**RING_65536), dev)
    n = ctx.ring_dim
    vals, weights, want = make_values(N_CLIENTS, n_values,
                                      -(-n_values // n), n, seed)
    return ctx, torch.as_tensor(vals, device=dev), weights, want


def run_ring65536_path(ctx, values, weights, seed=14) -> dict:
    """keygen -> public-key encrypt -> weighted sum -> decrypt."""
    sk, pk = keys.keygen(ctx, seed)
    ct = ops.encrypt_stacked(ctx, pk, values, threefry.key(seed, ctx.device))
    out = ops.decrypt(ctx, sk, ops.weighted_sum(ctx, ct, weights))
    torch.cuda.synchronize()
    return {"public_key": out}


def check_butterfly_65536(ctx, gen, chunks, reps=10) -> list[dict]:
    """K2 forward and inverse at (chunks, chain, 65536), the two-block body,
    against its plain version."""
    recs = []
    L = ctx.params.chain_len
    for fwd in (True, False):
        record_k2(recs, ctx.tables.slice_limbs(0, L),
                  (chunks, L, ctx.ring_dim), fwd, gen, reps)
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
    """result_errors with wants["bert"] for the streamed round,
    wants["slots"] for slot mode, wants["cnn"] for the other vectors; the
    seeded blob is at most FFTS_RATIO of the full one."""
    errs = result_errors(outs, wants, state_dicts, dev,
                         {"round_streamed": "bert", "bytes_slots": "slots"})
    ratio = len(blobs["seeded_fresh"]) / len(blobs["symmetric"])
    if not ratio <= FFTS_RATIO:
        raise AssertionError(f"FFTS / FFTC bytes {ratio} > {FFTS_RATIO}")
    return dict(errs, ffts_over_fftc=ratio)


def result_errors(outs: dict, wants: dict, state_dicts, dev,
                  ref: dict) -> dict:
    """Each result finite, of the right shape and within MAX_ERR of its
    plaintext reference: wants[ref.get(name, "cnn")] for vectors,
    plain_fedavg for the fhe_fedavg_* state_dicts, each of which loads into
    a module whose forward on a seeded batch is finite. Returns the max
    errors."""
    plain = plain_fedavg(state_dicts, API_WEIGHTS)
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
        raise AssertionError(f"max_err above {MAX_ERR}: {bad}")
    return errs


def _same_key(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def check_threshold_known_answers(mctx) -> None:
    """On mctx.device: the batched ceremonies give the per-party residues
    bit for bit (keygen, the two-round relinearisation key, the joint
    Galois key of a rotation by 1), and the keygen equals the CPU's."""
    dev = mctx.device
    sks, pk = thr.multiparty_keygen(mctx, THR_PARTIES, seed=1)
    sec, pk_b = thr.multiparty_keygen_batched(mctx, THR_PARTIES, seed=1)
    per_party = thr.PartySecrets(s=torch.stack([k.s for k in sks]),
                                 s_shoup=torch.stack([k.s_shoup for k in sks]))
    if not (_same_key(per_party, sec) and _same_key(pk, pk_b)):
        raise AssertionError(f"batched keygen differs on {dev}")
    cpu_sec, cpu_pk = thr.multiparty_keygen_batched(
        P.make_context(mctx.params, device="cpu"), THR_PARTIES, seed=1)
    if not (torch.equal(sec.s.cpu(), cpu_sec.s)
            and torch.equal(pk.p0.cpu(), cpu_pk.p0)):
        raise AssertionError(f"threshold keygen on {dev} differs from the "
                             f"CPU's")
    rlk = thr.multiparty_relin_key(mctx, sks, common_seed=2, seed=1)
    if not _same_key(rlk, thr.multiparty_relin_key_batched(
            mctx, sec, common_seed=2, seed=1)):
        raise AssertionError(f"batched relinearisation key differs on {dev}")
    g = KS.galois_element(1, mctx.ring_dim)
    gkeys = threefry.split(threefry.key(40, dev), THR_PARTIES)
    shares = [thr.partial_galois_key(mctx, sk, g, 77, k)
              for sk, k in zip(sks, gkeys)]
    if not _same_key(thr.combine_switch_key_shares(mctx, shares),
                     thr.multiparty_galois_key_batched(mctx, sec, g, 77,
                                                       gkeys)):
        raise AssertionError(f"batched Galois key differs on {dev}")


def threshold_helper(cryptodir: pathlib.Path, dev, seed=6) -> ThresholdCKKS:
    """The threshold helper of model_bench's --scheme ckks-threshold (batch
    4096, 2^52, N 8192, not dense) with 3 parties."""
    return ThresholdCKKS("ckks-threshold", THR_BATCH, 52,
                         cryptodir=str(cryptodir), parties=THR_PARTIES,
                         seed=seed, device=dev)


def mkhe_setup(dev, n_values: int, seed=1):
    """mkhe_bench's point (batch 4096, 2^51, depth 2: N 8192, chain 5 + 1
    special prime) and seeded standard-normal values packed 4096 per chunk:
    (ctx, values (n,) f32, packed (chunks, N) f32 on dev)."""
    ctx = P.make_context(P.make_params(batch=4096, scale_bits=51,
                                       mult_depth=2), dev)
    v = np.random.default_rng(seed).standard_normal(n_values).astype(
        np.float32)
    chunks = -(-n_values // 4096)
    pay = np.zeros(chunks * 4096, dtype=np.float32)
    pay[:n_values] = v
    buf = np.zeros((chunks, ctx.ring_dim), dtype=np.float32)
    buf[:, :4096] = pay.reshape(chunks, 4096)
    return ctx, v, torch.as_tensor(buf, device=dev)


def run_threshold_path(h: ThresholdCKKS, cnn_vecs, mctx, mvals) -> dict:
    """The keygen ceremony and every threshold entry once, then the mkhe
    circuit under joint keys; returns {result: decrypted output}."""
    w = API_WEIGHTS
    n = cnn_vecs[0].size
    dev = mvals.device
    outs = {}
    h.genCryptoContextAndKeyGen()
    agg = h.computeWeightedAverage([h.encrypt(v) for v in cnn_vecs], w)
    outs["bytes"] = h.decrypt(agg, n)
    outs["round_fused"] = h.fedavg_round(cnn_vecs, w)
    outs["round_staged"] = h.fedavg_round(cnn_vecs, w, fused=False)
    parts = [h.partial_decrypt(i, agg) for i in range(h.parties)]
    outs["partials_fused"] = h.fuse_partials(parts, agg, n)
    outs["single_partial"] = h.fuse_partials(parts[:1], agg, n)

    sec, pk = thr.multiparty_keygen_batched(mctx, THR_PARTIES, seed=1)
    rlk = thr.multiparty_relin_key_batched(mctx, sec, common_seed=2, seed=1)
    ct = ops.encrypt(mctx, pk, mvals, threefry.key(2, dev))
    half = ops.mul_scalar(mctx, ct, 0.5)
    ev = ops.add(mctx, half, half)
    sq = ops.rescale(mctx, KS.mul_ct(mctx, ct, ct, rlk))
    outs["mkhe_eval"] = thr.threshold_decrypt(
        mctx, sec, ev, threefry.split(threefry.key(10, dev), THR_PARTIES))
    outs["mkhe_square"] = thr.threshold_decrypt(
        mctx, sec, sq, threefry.split(threefry.key(20, dev), THR_PARTIES))
    torch.cuda.synchronize()
    return outs


def negacyclic_square(x: np.ndarray) -> np.ndarray:
    """x * x mod X^N + 1 for rows of coefficients (..., N), in f64 by FFT:
    the cyclic square of x twisted by exp(i pi k / N), untwisted."""
    n = x.shape[-1]
    tw = np.exp(1j * np.pi * np.arange(n) / n)
    f = np.fft.fft(x * tw)
    return (np.fft.ifft(f * f) / tw).real


def check_threshold(outs: dict, want: np.ndarray, mvals: torch.Tensor,
                    v: np.ndarray) -> dict:
    """Every CNN result and the mkhe scalar circuit within MAX_ERR of the
    plaintext; the first MKHE_CHECKED chunks of the ct x ct product within
    MKHE_REL_BOUND x its largest value of the f64 negacyclic square; fewer
    than 1% of the values a single share decodes to within 1e-3 of the
    plaintext (NaN counts as far)."""
    errs = {}
    for name in ("bytes", "round_fused", "round_staged", "partials_fused"):
        got = outs[name]
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"threshold {name}: bad output {got.shape}")
        errs[name] = float(np.max(np.abs(got - want)))
    ev = outs["mkhe_eval"]
    if tuple(ev.shape) != tuple(mvals.shape) or not bool(
            torch.isfinite(ev).all()):
        raise AssertionError(f"mkhe eval: bad output {tuple(ev.shape)}")
    got = ev[:, :4096].cpu().numpy().reshape(-1)[:v.size]
    errs["mkhe_eval"] = float(np.max(np.abs(got.astype(np.float64) - v)))
    bad = {k: e for k, e in errs.items() if not e <= MAX_ERR}
    if bad:
        raise AssertionError(f"threshold path: max_err above {MAX_ERR}: {bad}")
    sq = outs["mkhe_square"][:MKHE_CHECKED].cpu().numpy().astype(np.float64)
    ref = negacyclic_square(mvals[:MKHE_CHECKED].cpu().numpy().astype(
        np.float64))
    bound = MKHE_REL_BOUND * float(np.max(np.abs(ref)))
    errs["mkhe_square"] = float(np.max(np.abs(sq - ref)))
    errs["mkhe_square_bound"] = bound
    if not errs["mkhe_square"] <= bound:
        raise AssertionError(f"mkhe ct x ct: max_err {errs['mkhe_square']} "
                             f"> {bound}")
    close = float(np.mean(np.abs(outs["single_partial"] - want) <= 1e-3))
    errs["single_partial_close_share"] = close
    if not close < 0.01:
        raise AssertionError(f"one party's share decodes to the plaintext "
                             f"({close:.3f} of the values within 1e-3)")
    return errs


def check_threshold_kernels(ctx, secrets, cts, gen, weights=None,
                            reps=10) -> list[dict]:
    """K1, K3 and K4 against their plain versions at the shapes the
    threshold decrypt of each ciphertext in `cts` gives them: K1 on the
    smudging batch (P, chunks, live, N) (uniform residues), K1 inverse on
    the summed shares and K4 on their INTT (the real fusion inputs); with
    `weights`, K3 on a (K, chunks, 2, L, N) stack as threshold_round_fused
    forms it. Raises on any bit difference."""
    recs = []
    P_, dev = secrets.n_parties, gen.device
    for ct in cts:
        live, chunks, n = ct.live_limbs, ct.num_chunks, ctx.ring_dim
        mt = ctx.tables.slice_limbs(0, live).mxu
        x = uniform_mod_q(gen, (P_, chunks, live, n), ctx.params.moduli)
        _record(recs, "ntt_mxu_fused", mxu_pallas.ntt_mxu_fused(x, mt),
                mxu.ntt_mxu(x, mt), lambda: mxu_pallas.ntt_mxu_fused(x, mt),
                lambda: mxu.ntt_mxu(x, mt), reps, k1_work(x, mt, True),
                **k1_extra(mt))
        del x
        parts = thr._partials(ctx, secrets, ct.data,
                              threefry.split(threefry.key(50, dev), P_))
        acc = thr._sum_parties(parts, ctx.q[:live, None]).to(torch.int32)
        del parts
        coeffs = mxu_pallas.intt_mxu_fused(acc, mt)
        _record(recs, "intt_mxu_fused", coeffs, mxu.intt_mxu(acc, mt),
                lambda: mxu_pallas.intt_mxu_fused(acc, mt),
                lambda: mxu.intt_mxu(acc, mt), reps, k1_work(acc, mt, False),
                **k1_extra(mt))
        record_k4(recs, ctx, coeffs, ct.scale, reps)
    if weights is not None:
        L = ctx.params.chain_len
        record_k3(recs, ctx, uniform_mod_q(
            gen, (len(weights), cts[0].num_chunks, 2, L, ctx.ring_dim),
            ctx.params.moduli), weights, reps)
    return recs


def masking_helpers(root: pathlib.Path, dev) -> list:
    """MASK_LEARNERS Masking helpers on dev: one cryptodir, learner i's
    randomness in root/rand<i>; learner 0 holds the Paillier secret key."""
    hs = [Masking("paillier", MASK_LEARNERS, cryptodir=str(root / "crypto"),
                  randomnessdir=str(root / f"rand{i}"), device=dev,
                  **MASK_GEOMETRY) for i in range(MASK_LEARNERS)]
    hs[0].genCryptoContextAndKeyGen()
    for h in hs[1:]:
        h.loadCryptoParams()
    return hs


def write_online_randomness(hs: list, n_values: int, iteration: int) -> None:
    """Each learner's pad as genPaillierRandOffline draws it (os.urandom &
    mask) and the ring sum mod 2**num_bits in every learner's directory:
    what the offline protocol leaves behind, without the Paillier step."""
    mask = (1 << MASK_GEOMETRY["num_bits"]) - 1
    pads = []
    for h in hs:
        raw = np.frombuffer(os.urandom(4 * n_values), dtype="<u4")
        pads.append((raw & mask).astype(np.uint32))
        np.save(h._rand_path(iteration, "learner_rand.npy"), pads[-1])
    r_sum = np.sum(pads, axis=0, dtype=np.uint32) & np.uint32(mask)
    for h in hs:
        np.save(h._rand_path(iteration, "learner_rand_sum.npy"), r_sum)


def mask_vectors(n_values: int, seed: int):
    """MASK_LEARNERS seeded flat f32 vectors (normal x 0.1), their f64 mean."""
    rng = np.random.default_rng(seed)
    vecs = [rng.standard_normal(n_values, dtype=np.float32) * np.float32(0.1)
            for _ in range(MASK_LEARNERS)]
    return vecs, np.mean(np.stack(vecs).astype(np.float64), axis=0)


def run_masking_path(hs: list, off_vecs, on_vecs) -> dict:
    """The offline protocol at len(off_vecs[0]) values (iteration 0: every
    learner's encrypted pad, their homomorphic sum, its decryption, and a
    dropout recovery over learners 0, 2, 3) with one online round on it,
    then the online round at len(on_vecs[0]) values (iteration 1, pads from
    write_online_randomness). On the card, the fixed-point codes, masked
    values and their sum are CUDA tensors."""
    n_off, n_on = off_vecs[0].size, on_vecs[0].size
    outs = {}
    blobs = [h.genPaillierRandOffline(n_off, iteration=0) for h in hs]
    hs[0].decryptRandomnessSum(hs[0].addPaillierRandOffline(blobs), n_off,
                               iteration=0)
    masked = [h.encrypt(v, iteration=0) for h, v in zip(hs, off_vecs)]
    outs["offline_round"] = hs[0].decrypt(
        hs[0].computeWeightedAverage(masked), n_off, iteration=0)
    survivors = [0, 2, 3]
    hs[0].recoverRandomnessSubset(blobs, n_off, iteration=0,
                                  subset=survivors)
    outs["dropout_round"] = hs[0].decrypt(
        hs[0].computeWeightedAverage([masked[i] for i in survivors]), n_off,
        iteration=0, subset=survivors)

    w = [1.0 / MASK_LEARNERS] * MASK_LEARNERS
    masked = [h.encrypt(v, iteration=1) for h, v in zip(hs, on_vecs)]
    agg = hs[0].computeWeightedAverage(masked, w)
    outs["online_round"] = hs[0].decrypt(agg, n_on, iteration=1)

    h = hs[0]
    geo = MASK_GEOMETRY
    fixed = M.fixed_point_encode(h._tensor(on_vecs[0]), geo["num_bits"],
                                 geo["precision_bits"])
    r = np.load(h._rand_path(1, "learner_rand.npy")).astype(np.int64)
    masked0 = M.mask_values(fixed, h._tensor(r), h._ring_mask)
    summed = M.sum_masked(h._tensor(np.stack([M._from_wire(b)
                                              for b in masked])),
                          h._ring_mask)
    torch.cuda.synchronize()
    for name, t in (("encoded", fixed), ("masked", masked0),
                    ("summed", summed)):
        if t.device != h.device:
            raise AssertionError(f"masking: {name} values on {t.device}, "
                                 f"helper on {h.device}")
    if M._to_wire(masked0) != masked[0] or M._to_wire(summed) != agg:
        raise AssertionError("masking: device tensors differ from the blobs")
    return outs


def check_masking(outs: dict, off_vecs, on_vecs, hs: list) -> dict:
    """Each round within MASK_LEARNERS x 2**-precision of the plaintext
    mean (tests/test_masking.py's bound); the online output equals a CPU
    helper's bit for bit on the same randomness files."""
    bound = MASK_LEARNERS * 2.0 ** -MASK_GEOMETRY["precision_bits"]
    off_mean = np.mean(np.stack(off_vecs).astype(np.float64), axis=0)
    drop_mean = np.mean(np.stack([off_vecs[i] for i in (0, 2, 3)]).astype(
        np.float64), axis=0)
    on_mean = np.mean(np.stack(on_vecs).astype(np.float64), axis=0)
    errs = {}
    for name, want in (("offline_round", off_mean),
                       ("dropout_round", drop_mean),
                       ("online_round", on_mean)):
        got = outs[name]
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"masking {name}: bad output {got.shape}")
        errs[name] = float(np.max(np.abs(got - want)))
    bad = {k: e for k, e in errs.items() if not e <= bound}
    if bad:
        raise AssertionError(f"masking path: max_err above {bound}: {bad}")
    cpu = Masking("paillier", MASK_LEARNERS, cryptodir=hs[0].cryptodir,
                  randomnessdir=hs[0].randomnessdir, device="cpu",
                  **MASK_GEOMETRY)
    blob = cpu.encrypt(on_vecs[0], iteration=1)
    agg = cpu.computeWeightedAverage(
        [blob] + [h.encrypt(v, iteration=1) for h, v in zip(hs[1:],
                                                            on_vecs[1:])])
    if not np.array_equal(cpu.decrypt(agg, on_vecs[0].size, iteration=1),
                          hs[0].decrypt(agg, on_vecs[0].size, iteration=1)):
        raise AssertionError("masking: the card's decrypt differs from the "
                             "CPU's")
    if blob != hs[0].encrypt(on_vecs[0], iteration=1):
        raise AssertionError("masking: the card's masked blob differs from "
                             "the CPU's")
    errs["bound"] = bound
    return errs


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


def threshold_path(dev, gpu: str, cnn_vecs, cnn_want: np.ndarray,
                   profile_dir: pathlib.Path | None = None
                   ) -> tuple[collections.Counter, list[dict]]:
    """Known answers, the threshold path under drive() and its checks, the
    kernels held at the path's shapes, then each threshold and mkhe phase
    timed after a warm-up (and, with profile_dir, the fused threshold round
    and its smudging step traced). Returns the path's launch counts and the
    kernel records."""
    n = cnn_vecs[0].size
    t0 = time.perf_counter()
    mctx, mkhe_v, mkhe_vals = mkhe_setup(dev, n)
    check_threshold_known_answers(mctx)
    th = threshold_helper(ROOT / "build" / "threshold_cryptodir", dev)
    print(f"threshold setup: parties={THR_PARTIES} batch={THR_BATCH} "
          f"chunks={-(-n // THR_BATCH)}; mkhe N={mctx.ring_dim} "
          f"chain={mctx.params.chain_len} limbs={mctx.num_limbs} chunks="
          f"{mkhe_vals.shape[0]}; known answers on {dev} (batched == "
          f"per-party keygen, relin key, Galois key; keygen == CPU): ok "
          f"setup_s={time.perf_counter() - t0:.3f}", flush=True)
    thr_outs, thr_counts = drive("threshold", lambda: run_threshold_path(
        th, cnn_vecs, mctx, mkhe_vals))
    thr_errs = check_threshold(thr_outs, cnn_want, mkhe_vals, mkhe_v)
    print(f"threshold path: max_err {json.dumps(thr_errs)} launches "
          f"{thr_counts}", flush=True)
    del thr_outs
    keygen_ms = cuda_ms(th.genCryptoContextAndKeyGen, 2)
    thr_blobs = [th.encrypt(v) for v in cnn_vecs]
    thr_agg = th.computeWeightedAverage(thr_blobs, API_WEIGHTS)
    parts = [th.partial_decrypt(i, thr_agg) for i in range(THR_PARTIES)]
    msks, _ = thr.multiparty_keygen(mctx, THR_PARTIES, seed=1)
    msec, mpk = thr.multiparty_keygen_batched(mctx, THR_PARTIES, seed=1)
    mrlk = thr.multiparty_relin_key_batched(mctx, msec, common_seed=2, seed=1)
    mct = ops.encrypt(mctx, mpk, mkhe_vals, threefry.key(2, dev))
    mkeys = threefry.split(threefry.key(30, dev), THR_PARTIES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    recs = check_threshold_kernels(th.ctx, th._secrets,
                                   [th._deserialize(thr_agg)], gen,
                                   API_WEIGHTS)
    recs += check_threshold_kernels(
        mctx, msec, [mct, ops.rescale(mctx, KS.mul_ct(mctx, mct, mct, mrlk))],
        gen)
    print_records(recs, gpu)

    def mkhe_eval():
        half = ops.mul_scalar(mctx, mct, 0.5)
        return ops.add(mctx, half, half)

    thr_phases = {
        "thr_encrypt_per_client": lambda: th.encrypt(cnn_vecs[0]),
        "thr_computeWeightedAverage": lambda: th.computeWeightedAverage(
            thr_blobs, API_WEIGHTS),
        "thr_decrypt": lambda: th.decrypt(thr_agg, n),
        "thr_partial_decrypt": lambda: th.partial_decrypt(1, thr_agg),
        "thr_fuse_partials": lambda: th.fuse_partials(parts, thr_agg, n),
        "thr_round_fused": lambda: th.fedavg_round(cnn_vecs, API_WEIGHTS),
        "thr_round_staged": lambda: th.fedavg_round(cnn_vecs, API_WEIGHTS,
                                                    fused=False),
        "mkhe_keygen_batched": lambda: thr.multiparty_keygen_batched(
            mctx, THR_PARTIES, seed=1),
        "mkhe_keygen_per_party": lambda: thr.multiparty_keygen(
            mctx, THR_PARTIES, seed=1),
        "mkhe_relin_key_batched": lambda: thr.multiparty_relin_key_batched(
            mctx, msec, common_seed=2, seed=1),
        "mkhe_relin_key_per_party": lambda: thr.multiparty_relin_key(
            mctx, msks, common_seed=2, seed=1),
        "mkhe_encrypt": lambda: ops.encrypt(mctx, mpk, mkhe_vals,
                                            threefry.key(2, dev)),
        "mkhe_eval": mkhe_eval,
        "mkhe_mul_relin_rescale": lambda: ops.rescale(
            mctx, KS.mul_ct(mctx, mct, mct, mrlk)),
        "mkhe_threshold_decrypt": lambda: thr.threshold_decrypt(
            mctx, msec, mct, mkeys),
    }
    print(f"phase thr_keygen_ceremony_ms: {keygen_ms:.4f} ({gpu})",
          flush=True)
    for k, fn in thr_phases.items():
        print(f"phase {k}_ms: {cuda_ms(fn, 2):.4f} ({gpu})", flush=True)
    if profile_dir is not None:
        chunks = -(-n // THR_BATCH)
        dec_keys = threefry.split(threefry.key(31, dev), THR_PARTIES)
        us = profile(profile_dir, {
            "thr_round_fused": lambda: th.fedavg_round(cnn_vecs, API_WEIGHTS),
            "thr_smudging": lambda: thr._smudge(th.ctx, dec_keys, chunks,
                                                th.ctx.params.chain_len)})
        print(f"profile smudging share of the fused threshold round's device "
              f"time: {us['thr_smudging'] / us['thr_round_fused']:.4f} "
              f"({gpu})", flush=True)
    del thr_blobs, parts, msks, msec, mpk, mrlk, mct, mctx, mkhe_vals
    return thr_counts, recs


def masking_path(dev, gpu: str, n_values: int = CNN_PARAMS
                 ) -> collections.Counter:
    """The masking path under drive() with the online round at n_values
    and its checks, then its offline (host) and online phases timed after a
    warm-up. Returns the path's launch counts (none: it runs no kernel of
    ours)."""
    t0 = time.perf_counter()
    mhs = masking_helpers(ROOT / "build" / "masking", dev)
    mask_keygen_s = time.perf_counter() - t0
    if any(h.device.type != "cuda" for h in mhs):
        raise AssertionError("masking helpers are not on the card")
    off_vecs, _ = mask_vectors(MASK_OFFLINE_VALUES, 20)
    on_vecs, _ = mask_vectors(n_values, 21)
    write_online_randomness(mhs, n_values, 1)
    print(f"masking setup: learners={MASK_LEARNERS} {MASK_GEOMETRY} "
          f"threads={paillier.num_threads()} offline={MASK_OFFLINE_VALUES} "
          f"values online={n_values} values paillier_keygen_s="
          f"{mask_keygen_s:.3f}", flush=True)
    mask_outs, mask_counts = drive("masking", lambda: run_masking_path(
        mhs, off_vecs, on_vecs))
    mask_errs = check_masking(mask_outs, off_vecs, on_vecs, mhs)
    print(f"masking path on {mhs[0].device}: max_err {json.dumps(mask_errs)}"
          f" launches {mask_counts}", flush=True)

    def host_s(fn):
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out

    gen = [host_s(lambda h=h: h.genPaillierRandOffline(MASK_OFFLINE_VALUES,
                                                       2)) for h in mhs]
    add_s, enc_sum = host_s(lambda: mhs[0].addPaillierRandOffline(
        [b for _, b in gen]))
    dec_s, _ = host_s(lambda: mhs[0].decryptRandomnessSum(
        enc_sum, MASK_OFFLINE_VALUES, 2))
    print(f"phase mask_offline_gen_per_learner_s: "
          f"{sum(s for s, _ in gen) / len(gen):.4f} mask_offline_add_s: "
          f"{add_s:.4f} mask_offline_decrypt_sum_s: {dec_s:.4f} "
          f"({MASK_OFFLINE_VALUES} values, host) ({gpu})", flush=True)
    masked = [h.encrypt(v, iteration=1) for h, v in zip(mhs, on_vecs)]
    mask_agg = mhs[0].computeWeightedAverage(masked)
    mask_phases = {
        "mask_encrypt_per_learner": lambda: mhs[1].encrypt(on_vecs[1],
                                                           iteration=1),
        "mask_computeWeightedAverage": lambda: mhs[0].computeWeightedAverage(
            masked),
        "mask_decrypt": lambda: mhs[0].decrypt(mask_agg, n_values,
                                               iteration=1),
    }
    for k, fn in mask_phases.items():
        print(f"phase {k}_ms: {cuda_ms(fn, 3):.4f} ({gpu})", flush=True)
    return mask_counts


def deep_path(dev, gpu: str, cnn_vecs, cnn_want: np.ndarray, state_dicts,
              gen) -> tuple[collections.Counter, list[dict]]:
    """The deep path (mult_depth 24: N 32768, 27 live limbs) under drive()
    and its checks, the kernels at 17 and 27 live limbs (K3, K4) and at 18
    and 28 limbs (K1), then its rounds timed. Returns the path's launch
    counts and the kernel records."""
    t0 = time.perf_counter()
    h = deep_helper(ROOT / "build" / "deep_cryptodir", dev)
    ctx = h.ctx
    chunks = -(-cnn_vecs[0].size // ctx.ring_dim)
    print(f"deep setup: N={ctx.ring_dim} chain={ctx.params.chain_len} "
          f"limbs={ctx.num_limbs} chunks={chunks} clients={N_CLIENTS} "
          f"setup_s={time.perf_counter() - t0:.3f}", flush=True)
    outs, counts = drive("deep", lambda: run_deep_path(h, cnn_vecs,
                                                       state_dicts))
    errs = result_errors(outs, {"cnn": cnn_want}, state_dicts, dev, {})
    print(f"deep path: max_err {json.dumps(errs)} launches {counts}",
          flush=True)
    del outs
    recs = check_deep_kernels(h, cnn_vecs, gen)
    recs += check_k1_deep(gen, -(-cnn_vecs[0].size // 16384))
    print_records(recs, gpu)
    for k, fn in {
            "deep_round_fused": lambda: h.fedavg_round(cnn_vecs, API_WEIGHTS),
            "deep_round_staged": lambda: h.fedavg_round(
                cnn_vecs, API_WEIGHTS, fused=False)}.items():
        print(f"phase {k}_ms: {cuda_ms(fn, 2):.4f} ({gpu})", flush=True)
    return counts, recs


def ring65536_path(dev, gpu: str, gen) -> tuple[collections.Counter,
                                                 list[dict]]:
    """The N = 65536 path under drive() and its check, K2 at its shapes,
    then the round timed. Returns the path's launch counts and records."""
    t0 = time.perf_counter()
    ctx, values, weights, want = ring65536_setup(dev, CNN_PARAMS)
    print(f"ring65536 setup: N={ctx.ring_dim} chain={ctx.params.chain_len} "
          f"limbs={ctx.num_limbs} chunks={values.shape[1]} clients="
          f"{N_CLIENTS} setup_s={time.perf_counter() - t0:.3f}", flush=True)
    outs, counts = drive("ring65536", lambda: run_ring65536_path(
        ctx, values, weights))
    err = check_outputs(outs, want, CNN_PARAMS)
    print(f"ring65536 path: max_err {err!r} launches {counts}", flush=True)
    del outs
    recs = check_butterfly_65536(ctx, gen, values.shape[1])
    print_records(recs, gpu)
    ms = cuda_ms(lambda: run_ring65536_path(ctx, values, weights), 2)
    print(f"phase ring65536_round_ms: {ms:.4f} ({gpu})", flush=True)
    return counts, recs


def load_flat(spec, flat: np.ndarray, dev):
    """The tree of spec.params with its leaves taken in order from the flat
    vector `flat`, on `dev`."""
    off = 0

    def leaf(x):
        nonlocal off
        t = torch.from_numpy(flat[off:off + x.numel()]).reshape(x.shape)
        off += x.numel()
        return t.to(dev)
    return tree_map(leaf, spec.params)


def forward_rel(spec, avg: np.ndarray, want: np.ndarray, dev) -> float:
    """The model on the decrypted average against the model on the
    plaintext average, on `dev` at zoo.example_inputs: the largest output
    difference over max(1, the largest output). Raises on a non-finite or
    misshapen output."""
    inputs = [torch.as_tensor(x, device=dev)
              for x in zoo.example_inputs(spec.name)]
    got = tree_leaves(spec.forward(*inputs, params=load_flat(spec, avg, dev)))
    ref = tree_leaves(spec.forward(*inputs,
                                   params=load_flat(spec, want, dev)))
    rel = 0.0
    for g, r in zip(got, ref):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{spec.name}: bad forward output "
                                 f"{tuple(g.shape)}")
        rel = max(rel, float((g - r).abs().max())
                  / max(1.0, float(r.abs().max())))
    return rel


def zoo_checker(dev, gpu: str, rows: list):
    """model_bench.main's on_model: the max_err gate and the forward check
    on the card, one line per model; the rows collect what was checked."""
    def check(r, spec, avg, want):
        if not r["max_err"] <= MAX_ERR:
            raise AssertionError(f"zoo {r['model']} ({r['path']}, "
                                 f"{r['scheme']}): max_err {r['max_err']}")
        fwd = forward_rel(spec, avg, want, dev)
        if not fwd <= ZOO_FWD_REL:
            raise AssertionError(f"zoo {r['model']}: forward differs by "
                                 f"{fwd} > {ZOO_FWD_REL}")
        chunks = -(-r["params"] // ZOO_BATCH)
        ms = {k: round(v * 1e3, 4) for k, v in r["phases"].items()}
        print(f"zoo {r['model']} [{r['scheme']} {r['path']}]: params "
              f"{r['params']} chunks {chunks} phases_ms {json.dumps(ms)} "
              f"max_err {r['max_err']!r} forward_rel {fwd:.3e} (bound "
              f"{ZOO_FWD_REL}) ({gpu})", flush=True)
        rows.append(dict(model=r["model"], path=r["path"],
                         scheme=r["scheme"], max_err=r["max_err"],
                         forward_rel=fwd))
    return check


def run_zoo_path(dev, gpu: str, out: pathlib.Path) -> dict:
    """model_bench over every zoo model at full width (3 clients, secret
    key, slices of 512 chunks), the fused and the threshold runs over
    cnn_fedavg and resnet50, and selective_bench at rates 0.1 and 1.0 on
    resnet50 and bert; every model's forward checked on the card."""
    rows: list = []
    check = zoo_checker(dev, gpu, rows)
    point = ["--batch", str(ZOO_BATCH), "--max-chunks", str(ZOO_MAX_CHUNKS),
             "--device", str(dev), "--out", str(out)]
    model_bench.main(["--models", *zoo.MODEL_NAMES, "--warmup", *point],
                     on_model=check)
    model_bench.main(["--models", *ZOO_SIDE_MODELS, "--fused", *point],
                     on_model=check)
    model_bench.main(["--models", *ZOO_SIDE_MODELS, "--scheme",
                      "ckks-threshold", *point], on_model=check)
    sel = selective_bench.main(["--models", *ZOO_SELECTIVE_MODELS,
                                "--rates", *ZOO_SELECTIVE_RATES,
                                "--reps", "1", *point])
    return {"rows": rows, "selective": sel}


def check_zoo(outs: dict) -> None:
    """Every zoo model ran once on the cohort path, the side models fused
    and under the threshold scheme, the selective rows within MAX_ERR."""
    runs = collections.Counter((r["path"], r["scheme"])
                               for r in outs["rows"])
    want = {("cohort", "ckks"): len(zoo.MODEL_NAMES),
            ("fused", "ckks"): len(ZOO_SIDE_MODELS),
            ("cohort", "ckks-threshold"): len(ZOO_SIDE_MODELS)}
    if dict(runs) != want:
        raise AssertionError(f"zoo runs {dict(runs)}, want {want}")
    sel = outs["selective"]
    if len(sel) != len(ZOO_SELECTIVE_MODELS) * len(ZOO_SELECTIVE_RATES):
        raise AssertionError(f"selective rows {len(sel)}")
    for r in sel:
        if not r["max_err"] <= MAX_ERR:
            raise AssertionError(f"selective {r['model']} rate {r['rate']}: "
                                 f"max_err {r['max_err']}")


def zoo_path(dev, gpu: str, ctx, sk, gen) -> tuple[collections.Counter,
                                                    list[dict]]:
    """The zoo path under drive() and its checks, then K1, K3 and K4 held
    at the streamed slice's shapes (512 chunks). Returns the path's launch
    counts and the kernel records."""
    t0 = time.perf_counter()
    outs, counts = drive("zoo", lambda: run_zoo_path(
        dev, gpu, ROOT / "build" / "zoo"))
    check_zoo(outs)
    for r in outs["selective"]:
        print(f"zoo selective {r['model']} rate {r['rate']}: enc_params "
              f"{r['enc_params']} chunks {r['chunks']} round_ms "
              f"{r['round_s'] * 1e3:.4f} max_err {r['max_err']!r} ({gpu})",
              flush=True)
    print(f"zoo path: {len(outs['rows'])} model runs, "
          f"{sum(zoo.build(m, device='meta').count for m in zoo.MODEL_NAMES)}"
          f" parameters in the ladder, wall_s "
          f"{time.perf_counter() - t0:.3f} launches {counts}", flush=True)
    n = ctx.params.ring_dim
    vals, weights, _ = make_values(N_CLIENTS, ZOO_MAX_CHUNKS * ZOO_BATCH,
                                   ZOO_MAX_CHUNKS, n, seed=15)
    recs = check_kernels(ctx, sk, torch.as_tensor(vals, device=dev), weights,
                         gen)
    print_records(recs, gpu)
    return counts, recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=pathlib.Path, default=None,
                    help="write torch.profiler tables of one rotation, one "
                         "batch multiply, one API encrypt and its threefry "
                         "sampling, one fused threshold round and its "
                         "smudging step to this directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # The plain NTT's f32 digit-plane matmul is exact only in full f32; the
    # zoo's forwards run their convolutions in full f32 too.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    gpu = card()
    print(f"card: {gpu}", flush=True)

    t0 = time.perf_counter()
    cuda_lib.lib()
    print(f"build_s: {time.perf_counter() - t0:.3f} ({gpu})", flush=True)

    t0 = time.perf_counter()
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    # The entry points' default device (the card), as a user calls them.
    ctx = P.make_context(params)
    sk = S.deserialize_secret_key((KEY_DIR / "key-private.txt").read_bytes())
    pk = S.deserialize_public_key((KEY_DIR / "key-public.txt").read_bytes())
    if not all(t.is_cuda for t in (ctx.q, sk.s, pk.p0)):
        raise AssertionError("make_context / the key decoders did not default "
                             "to the card")
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
    recs += check_multiply_kernels(ctx, gen, MULT_BATCH)
    recs += check_k1_small_ring(gen)
    recs += check_repairs(ctx, gen, chunks, 64, deep_ctx)
    recs += check_butterfly(rot_ctx, ctx, gen, 64)
    print_records(recs, gpu)
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

    thr_counts, thr_recs = threshold_path(dev, gpu, cnn_vecs, cnn_want,
                                          args.profile)
    recs += thr_recs
    mask_counts = masking_path(dev, gpu)
    deep_counts, deep_recs = deep_path(dev, gpu, cnn_vecs, cnn_want, sds,
                                       gen)
    recs += deep_recs
    ring_counts, ring_recs = ring65536_path(dev, gpu, gen)
    recs += ring_recs
    zoo_counts, zoo_recs = zoo_path(dev, gpu, ctx, sk, gen)
    recs += zoo_recs

    launches = collections.Counter()
    for c in (fed_counts, rot_counts, mult_counts, api_counts, thr_counts,
              mask_counts, deep_counts, ring_counts, zoo_counts):
        launches.update(c)
    for r in recs:   # K1: the launches of the record's body
        r["launches"] = launches[r["name"] + (f".{r['body']}" if "body" in r
                                              else "")]
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
