"""The hand-written CUDA kernels against their plain PyTorch versions, on
the GPU. Marked `cuda`: skipped where torch sees no CUDA device. On a GPU
host run them with

    python -m pytest tests/test_torch_cuda.py -q

They repeat chip_smoke.py's phases at smaller sizes, plus the shapes and
options the paths do not reach (small rings, K > 8, every live-limb count
of the decode up to 27, K1 up to 28 limbs, K2 at N = 65536, both NTT
kernels on one ring), and hold the threefry
sampling, the CKKS bytes surface under threefry, the FFTS expansion, the
threshold ceremonies and the masking scheme's online phase on the card
equal to the CPU; the Philox kernel (csrc/philox_rbg.cu) bit for bit
against its plain version and the CPU at the bench's shapes; the key
split kernel (csrc/threefry_split.cu) against the CPU's split of either
PRNG, one launch a split and no synchronise; the rbg
draws, bytes and rounds on the card equal to the CPU's (which the CPU
tests hold against JAX's rbg); and fhe_fedavg on the card (the tree
kernel, csrc/tree_average.cu) equal bit for bit to the same flow on CPU
copies of the same trees (which the CPU tests hold to the JAX package),
with its launches counted; and the encode, encrypt and decrypt passes
(csrc/rlwe_passes.cu) bit for bit against their plain versions at the
paths' shapes, against the CPU rehearsal at the edges and outside the
plain version's range, and through whole encrypts and rounds against the
CPU, one launch a pass.
"""

import collections
import dataclasses
import math

import numpy as np
import pytest
import torch

import chip_smoke
from fhe_fed_tpu_torch import bench, cuda_lib, CKKS
from fhe_fed_tpu_torch import SelectivePolicy, fhe_fedavg
from fhe_fed_tpu_torch.fed import api as fed_api, tree_average as TA
from fhe_fed_tpu_torch.models import granite_hybrid, zoo
from fhe_fed_tpu_torch.rns import primes
from fhe_fed_tpu_torch.ntt import mxu, mxu_pallas, tables, pallas_ntt
from fhe_fed_tpu_torch.ntt import ntt as ntt_mod
from fhe_fed_tpu_torch.ckks import params as P, serial as S, ops, encoding
from fhe_fed_tpu_torch.ckks import pallas_agg, pallas_decode, keys
from fhe_fed_tpu_torch.ckks import rlwe_passes
from fhe_fed_tpu_torch.ckks import keyswitch as KS
from fhe_fed_tpu_torch.ckks.keys import uniform_mod_q
from fhe_fed_tpu_torch.utils import threefry as TF

import rlwe_rehearsal as RR

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda:0")


def _gen(dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("n,L,batch,bits", [
    (256, 3, 3, 31), (512, 2, 19, 31), (8192, 5, 7, 31), (16384, 3, 3, 31),
    (8192, 16, 2, 31), (8192, 4, 5, 31), (4096, 5, 1, 31), (8192, 1, 3, 31),
    (2048, 1, 2, 31), (8192, 3, 5, 22), (8192, 3, 5, 26), (8192, 3, 5, 30),
    (2048, 3, 5, 22), (16384, 18, 2, 31), (16384, 28, 2, 31),
    (8192, 28, 3, 31), (2048, 28, 3, 31)])
def test_ntt_kernel_matches_plain(dev, n, L, batch, bits):
    """K1 by the shape rule (mma_sync below N = 4096, wgmma from it), odd
    batches included (B polynomials of a limb go two to a CTA), one limb
    alone (ModDown's and the rescale's inverse), up to 28 limbs (the most
    make_params gives), and `bits`-bit primes: both bodies are exact for
    every q < 2^31 (the paths use 31-bit ones)."""
    mod = primes.ntt_primes(n, L, target_bits=bits)
    mt = mxu.make_mxu_tables(n, mod, device=dev)
    x = uniform_mod_q(_gen(dev, n), (batch, L, n), mod)
    y = mxu_pallas.ntt_mxu_fused(x, mt)
    assert torch.equal(y, mxu.ntt_mxu(x, mt))
    z = mxu_pallas.intt_mxu_fused(y, mt)
    assert torch.equal(z, mxu.intt_mxu(y, mt))
    assert torch.equal(z, x)


@pytest.mark.parametrize("n", [8192, 2048])
def test_ntt_kernel_on_taken_limbs(dev, n):
    """K1 on tables taken in a non-contiguous limb order
    (MxuNttTables.take, as the key switch's extended basis does): the
    wgmma body at N = 8192, the mma_sync body at 2048."""
    mod = primes.ntt_primes(n, 6)
    idx = [4, 0, 5, 2]
    mt = mxu.make_mxu_tables(n, mod, device=dev).take(idx)
    assert mt.body == ("wgmma" if n == 8192 else "mma_sync")
    x = uniform_mod_q(_gen(dev, 6), (3, 2, 4, n), tuple(mod[i] for i in idx))
    y = mxu_pallas.ntt_mxu_fused(x, mt)
    assert torch.equal(y, mxu.ntt_mxu(x, mt))
    z = mxu_pallas.intt_mxu_fused(y, mt)
    assert torch.equal(z, mxu.intt_mxu(y, mt))
    assert torch.equal(z, x)


@pytest.mark.parametrize("mult_depth", [14, 24])
def test_ntt_on_deep_chain_tables(dev, mult_depth):
    """The NTT dispatch on make_params(ring_dim=16384, mult_depth=14 / 24)
    context tables (18 / 28 limbs) runs K1 on the card, equal to its plain
    version."""
    ctx = P.make_context(P.make_params(batch=4096, scale_bits=52,
                                       mult_depth=mult_depth,
                                       ring_dim=16384), dev)
    assert ctx.num_limbs == mult_depth + 4
    x = uniform_mod_q(_gen(dev, mult_depth), (3, ctx.num_limbs, 16384),
                      ctx.params.moduli)
    cuda_lib.launches.clear()
    y = ntt_mod.ntt(x, ctx.tables)
    assert torch.equal(y, mxu.ntt_mxu(x, ctx.tables.mxu))
    assert torch.equal(ntt_mod.intt(y, ctx.tables), x)
    assert cuda_lib.launches["ntt_mxu_fused"] == 1
    assert cuda_lib.launches["intt_mxu_fused"] == 1


@pytest.mark.parametrize("n,L,batch", [(256, 3, 5), (4096, 2, 3),
                                       (32768, 2, 2), (65536, 2, 3),
                                       (65536, 5, 2), (512, 3, 3),
                                       (256, 1, 1), (32768, 27, 2),
                                       (8192, 3, 7), (2048, 5, 7)])
def test_butterfly_kernel_matches_plain(dev, n, L, batch):
    """Every group split of the stage-grouped body: N = 256 and 512 (the
    shortest, 3 + 5 and 4 + 5 stages, blocks of 8 and 16 threads), 2048
    (3 + 3 + 5), 32768 at 27 limbs (the deep chain), 65536 (two blocks),
    and grids of B * L blocks that are no multiple of anything (7 x 3,
    7 x 5)."""
    tb = tables.make_tables(n, primes.ntt_primes(n, L), device=dev)
    x = uniform_mod_q(_gen(dev, n), (batch, L, n), tuple(tb.q))
    y = pallas_ntt.ntt_fused(x, tb)
    assert torch.equal(y, ntt_mod.ntt_butterfly(x, tb))
    z = pallas_ntt.intt_fused(y, tb)
    assert torch.equal(z, ntt_mod.intt_butterfly(y, tb))
    assert torch.equal(z, x)


@pytest.mark.parametrize("n", [256, 4096, 32768, 65536])
def test_butterfly_kernel_at_the_largest_modulus(dev, n):
    """The largest NTT prime below 2^31 for the ring (2^31 - q < 2^-13 of
    2^31 at every N here), inputs including 0, 1 and q - 1 in every
    position class: the unsigned-min reductions at their edges."""
    q = primes.ntt_primes(n, 1)[0]
    tb = tables.make_tables(n, (q,), device=dev)
    x = uniform_mod_q(_gen(dev, 3), (4, 1, n), (q,))
    x[1] = q - 1
    x[2, 0, ::2] = 0
    x[2, 0, 1::2] = q - 1
    x[3, 0, : n // 2] = 1
    for kern, plain in ((pallas_ntt.ntt_fused, ntt_mod.ntt_butterfly),
                        (pallas_ntt.intt_fused, ntt_mod.intt_butterfly)):
        assert torch.equal(kern(x, tb), plain(x, tb))


def test_butterfly_wrapper_builds_constants_once(dev):
    """The (3, 64) launch constants are built on a table's first call and
    reused by every later call, either direction; the paths' repeated
    slices are the same table, so they reuse them too."""
    tb = tables.make_tables(4096, primes.ntt_primes(4096, 2), device=dev)
    x = uniform_mod_q(_gen(dev, 4), (2, 2, 4096), tuple(tb.q))
    assert "k2_consts" not in vars(tb)
    pallas_ntt.ntt_fused(x, tb)
    block = vars(tb)["k2_consts"]
    pallas_ntt.ntt_fused(x, tb)
    pallas_ntt.intt_fused(x, tb)
    assert vars(tb)["k2_consts"] is block
    part = tb.slice_limbs(0, 1)
    pallas_ntt.ntt_fused(x[:, :1].contiguous(), part)
    assert tb.slice_limbs(0, 1) is part and "k2_consts" in vars(part)


def test_butterfly_kernel_matches_k1(dev):
    """Two independent kernels for one transform, N = 8192."""
    tb = tables.make_tables(8192, primes.ntt_primes(8192, 5), device=dev)
    x = uniform_mod_q(_gen(dev, 1), (7, 5, 8192), tuple(tb.q))
    assert torch.equal(pallas_ntt.ntt_fused(x, tb),
                       mxu_pallas.ntt_mxu_fused(x, tb.mxu))
    assert torch.equal(pallas_ntt.intt_fused(x, tb),
                       mxu_pallas.intt_mxu_fused(x, tb.mxu))


def test_butterfly_kernel_refuses_larger_rings(dev):
    tb = tables.make_tables(131072, primes.ntt_primes(131072, 1))
    x = torch.zeros((1, 1, 131072), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="65536"):
        pallas_ntt.ntt_fused(x, tb)


@pytest.mark.parametrize("mult_depth", [1, 14, 24])
@pytest.mark.parametrize("K", [1, 3, 8, 9, 16, 17, 64])
def test_weighted_sum_kernel_matches_plain(dev, K, mult_depth):
    """K <= 8 (one template per K), larger K (the loop by fours), at 4, 17
    and 27 live limbs; K * live > 384 takes the pairs from a device
    buffer."""
    ctx = P.make_context(P.make_params(batch=128, scale_bits=40,
                                       mult_depth=mult_depth, ring_dim=256),
                         dev)
    L = ctx.params.chain_len
    stacked = uniform_mod_q(_gen(dev, K), (K, 5, 2, L, 256),
                            ctx.params.moduli)
    w = list(np.random.default_rng(K).uniform(0, 1, K))
    wr, ws, _ = ops._encode_weights(ctx, w, L, 0)
    got = pallas_agg.weighted_sum_fused(
        stacked, pallas_agg.weight_block(wr, ws, ctx.params.moduli[:L]))
    want = ops._weighted_sum_impl(ctx, stacked,
                                  torch.as_tensor(wr, device=dev),
                                  torch.as_tensor(ws, device=dev))
    assert torch.equal(got, want)


def test_weighted_sum_kernel_refuses_more_than_65536_clients(dev):
    x = torch.zeros((65537, 1, 2, 1, 4), dtype=torch.int32, device=dev)
    w = np.ones((65537, 1), dtype=np.int64)
    with pytest.raises(ValueError, match="1..65536"):
        pallas_agg.weighted_sum_fused(x, pallas_agg.weight_block(w, w, (3,)))


def test_decode_kernel_matches_plain_every_live(dev):
    """Every live count from 1 to 27 (chain 27 at mult_depth 24), on
    uniform residues, the residues of -1 and y_l = q_l - 1 for every limb
    (the largest k)."""
    ctx = P.make_context(P.make_params(batch=128, scale_bits=40,
                                       mult_depth=24, ring_dim=256), dev)
    assert ctx.params.chain_len == 27
    for live in range(1, ctx.params.chain_len + 1):
        dc = ctx.dec_consts[live - 1]
        moduli = ctx.params.moduli[:live]
        Q = math.prod(moduli)
        r = uniform_mod_q(_gen(dev, live), (3, live, 256), ctx.params.moduli)
        r[1] = torch.tensor([q - 1 for q in moduli], dtype=torch.int32,
                            device=dev)[:, None]
        r[2] = torch.tensor([(q - 1) * (Q // q) % q for q in moduli],
                            dtype=torch.int32, device=dev)[:, None]
        for scale in (2.0 ** 40, 2.0 ** 71, 2.0 ** -30):
            got = pallas_decode.decode_fused(ctx, dc, r, scale)
            want = encoding.decode_core(dc, ctx.q[:live], r, scale)
            nan = torch.isnan(want)
            assert torch.equal(torch.isnan(got), nan)
            assert torch.equal(got.view(torch.int32)[~nan],
                               want.view(torch.int32)[~nan])


def _to(obj, dev):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev)
        for f in dataclasses.fields(obj)})


@pytest.mark.parametrize("branch", ["mxu", "butterfly"])
def test_key_switch_and_rotate_match_cpu(dev, branch):
    """key_switch and rotate on the card (K1 or K2) equal the CPU result."""
    params = P.make_params(batch=128, scale_bits=40, mult_depth=2,
                           ring_dim=256)
    cpu = P.make_context(params, device="cpu")
    gpu = P.make_context(params, dev)
    if branch == "butterfly":
        cpu = dataclasses.replace(cpu, tables=dataclasses.replace(
            cpu.tables, mxu=None))
        gpu = dataclasses.replace(gpu, tables=dataclasses.replace(
            gpu.tables, mxu=None))
    gen = torch.Generator().manual_seed(5)
    sk, pk = keys.keygen(cpu, gen)
    rlk = KS.make_relin_key(cpu, sk, gen)
    gk = KS.make_galois_key(cpu, sk, KS.galois_element(3, 256), gen)
    ct = ops.encrypt(cpu, pk, torch.randn((2, 256), generator=gen), gen)
    d = ct.data[:, 1]
    cuda_lib.launches.clear()
    for want, got in zip(KS.key_switch(cpu, d, rlk),
                         KS.key_switch(gpu, d.to(dev), _to(rlk, dev))):
        assert torch.equal(got.cpu(), want)
    rot = KS.rotate(gpu, dataclasses.replace(ct, data=ct.data.to(dev)), 3,
                    _to(gk, dev))
    assert torch.equal(rot.data.cpu(), KS.rotate(cpu, ct, 3, gk).data)
    names = (("ntt_mxu_fused", "intt_mxu_fused") if branch == "mxu"
             else ("ntt_fused", "intt_fused"))
    assert all(cuda_lib.launches[k] > 0 for k in names)


def test_rotation_and_multiply_paths_small(dev):
    """chip_smoke's rotation path at N = 32768 with EvalSum width 16, and
    its multiply path with 8 ciphertexts."""
    rot_ctx = P.make_context(P.make_params(batch=16384, scale_bits=52,
                                           mult_depth=5, ring_dim=32768), dev)
    gen = _gen(dev, 2)
    sk, z, ct, gks = chip_smoke.rotation_setup(rot_ctx, gen, 16)
    (rot, summed), _ = chip_smoke.drive("rotation", lambda: (
        chip_smoke.run_rotation_path(rot_ctx, ct, gks, 16)))
    errs = chip_smoke.check_rotation(rot_ctx, sk, z, rot, summed, 16)
    assert max(errs) <= chip_smoke.MAX_ERR

    ctx = P.make_context(P.make_params(batch=4096, scale_bits=52,
                                       mult_depth=1), dev)
    sk, pk = keys.keygen(ctx, gen)
    rlk = KS.make_relin_key(ctx, sk, gen)
    za, zb, a, b = chip_smoke.multiply_setup(ctx, pk, gen, 8)
    prod, _ = chip_smoke.drive("multiply", lambda: (
        chip_smoke.run_multiply_path(ctx, a, b, rlk)))
    assert chip_smoke.check_products(ctx, sk, za, zb, prod, 8) <= \
        chip_smoke.MAX_ERR
    recs = chip_smoke.check_multiply_kernels(ctx, gen, 8, reps=1)
    assert [r["shape"] for r in recs] == [
        [8, 4, 8192], [8, 4, 5, 8192], [8, 1, 8192], [8, 4, 8192],
        [8, 2, 1, 8192], [8, 2, 3, 8192]]
    assert [r["max_abs_err"] for r in recs] == [0.0] * 6


def test_entry_points_default_to_the_card_on_card(dev, tmp_path):
    """With no device given, the entry points put their state on the card
    (the index made explicit) and run there."""
    from fhe_fed_tpu_torch import ThresholdCKKS, Masking, interop
    card = torch.device("cuda", torch.cuda.current_device())
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params)
    assert ctx.device == card and ctx.q.is_cuda
    sk = S.deserialize_secret_key(
        (chip_smoke.KEY_DIR / "key-private.txt").read_bytes())
    pk = S.deserialize_public_key(
        (chip_smoke.KEY_DIR / "key-public.txt").read_bytes())
    assert sk.s.device == card and pk.p0.device == card
    for cls in (CKKS, ThresholdCKKS, Masking):
        assert cls(cryptodir=str(tmp_path / cls.__name__)).device == card
    ct = interop.ciphertext_from_numpy(np.zeros((1, 2, 4, 8192), np.uint32),
                                       1.0, 0)
    assert ct.data.device == card
    h = CKKS("ckks", 128, 40, cryptodir=str(tmp_path / "run"), seed=7)
    assert h.prng == "rbg" and h._rng.device == card
    h.genCryptoContextAndKeyGen()
    x = np.random.default_rng(0).standard_normal(300)
    out = h.decrypt(h.computeWeightedAverage([h.encrypt(x)], [1.0]), 300)
    assert np.abs(out - x).max() <= chip_smoke.MAX_ERR


def test_main_path_small(dev):
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params, dev)
    sk = S.deserialize_secret_key(
        (chip_smoke.KEY_DIR / "key-private.txt").read_bytes(), dev)
    pk = S.deserialize_public_key(
        (chip_smoke.KEY_DIR / "key-public.txt").read_bytes(), dev)
    vals, weights, want = chip_smoke.make_values(3, 20000, 3, 8192)
    values = torch.as_tensor(vals, device=dev)
    recs = chip_smoke.check_kernels(ctx, sk, values, weights, _gen(dev),
                                    reps=1)
    assert [r["name"] for r in recs] == [
        "ntt_mxu_fused", "intt_mxu_fused", "weighted_sum_fused",
        "decode_fused", *rlwe_passes.NAMES]
    assert all(r["max_abs_err"] == 0.0 for r in recs)
    outs, _ = chip_smoke.drive("fedavg", lambda: chip_smoke.run_main_path(
        ctx, sk, pk, values, weights, _gen(dev)))
    assert chip_smoke.check_outputs(outs, want, 20000) <= chip_smoke.MAX_ERR


def test_deep_path_small(dev, tmp_path):
    """chip_smoke's deep path (mult_depth 24: N 32768, 27 live limbs; K2,
    K3, K4) with 20,000-value vectors (one chunk), its kernel records at
    17 and 27 live limbs and K1's at 18 and 28 limbs."""
    h = chip_smoke.deep_helper(tmp_path / "deep", dev)
    assert h.ctx.params.chain_len == 27 and h.ctx.ring_dim == 32768
    cnn, want = chip_smoke.api_vectors(20000, 10)
    sds = chip_smoke.cnn_state_dicts()
    outs, _ = chip_smoke.drive("deep", lambda: chip_smoke.run_deep_path(
        h, cnn, sds))
    errs = chip_smoke.result_errors(outs, {"cnn": want}, sds, dev, {})
    assert max(errs.values()) <= chip_smoke.MAX_ERR
    recs = chip_smoke.check_deep_kernels(h, cnn, _gen(dev), reps=1)
    recs += chip_smoke.check_k1_deep(_gen(dev), 2, reps=1)
    assert [(r["name"], r["shape"][-2]) for r in recs] == [
        ("weighted_sum_fused", 17), ("decode_fused", 17),
        ("weighted_sum_fused", 27), ("decode_fused", 27),
        ("ntt_fused", 27), ("intt_fused", 27),
        ("ntt_mxu_fused", 18), ("intt_mxu_fused", 18),
        ("ntt_mxu_fused", 28), ("intt_mxu_fused", 28)]
    assert recs[4]["shape"] == [3, 1, 27, 32768]
    assert recs[5]["shape"] == [1, 27, 32768]
    assert [r["max_abs_err"] for r in recs] == [0.0] * 10


@pytest.mark.parametrize("mult_depth", [14, 24])
def test_deep_chain_round_on_card(dev, mult_depth):
    """keygen, encrypt, weighted sum and decrypt at make_params(mult_depth
    = 14 / 24): 17 / 27 live limbs at N = 32768, K2, K3 and K4 on the card,
    sampling under an rbg key (the Philox kernel at 17 / 27 limbs, as the
    deep path's helpers); the keys equal the CPU's."""
    from fhe_fed_tpu_torch.utils import prng
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=mult_depth)
    assert params.chain_len == mult_depth + 3 and params.ring_dim == 32768
    ctx = P.make_context(params, dev)
    sk, pk = keys.keygen(ctx, 5)
    csk, _ = keys.keygen(P.make_context(params, device="cpu"), 5)
    assert torch.equal(sk.s.cpu(), csk.s)
    vals, weights, want = chip_smoke.make_values(3, 20000, 1, 32768)
    values = torch.as_tensor(vals, device=dev)
    outs, _ = chip_smoke.drive("deep", lambda: chip_smoke.run_main_path(
        ctx, sk, pk, values, weights, prng.key(6, "rbg", dev)))
    assert chip_smoke.check_outputs(outs, want, 20000) <= chip_smoke.MAX_ERR


def test_ring65536_path_small(dev):
    """chip_smoke's N = 65536 path with 20,000-value vectors: keygen (equal
    to the CPU's), encrypt, weighted sum and decrypt on the card, and its
    K2 records (the two-block body) at 2 chunks."""
    ctx, values, weights, want = chip_smoke.ring65536_setup(dev, 20000)
    outs, counts = chip_smoke.drive("ring65536", lambda: (
        chip_smoke.run_ring65536_path(ctx, values, weights)))
    assert chip_smoke.check_outputs(outs, want, 20000) <= chip_smoke.MAX_ERR
    cpu = P.make_context(ctx.params, device="cpu")
    sk, pk = keys.keygen(ctx, 14)
    csk, cpk = keys.keygen(cpu, 14)
    assert torch.equal(sk.s.cpu(), csk.s) and torch.equal(pk.p0.cpu(),
                                                          cpk.p0)
    recs = chip_smoke.check_butterfly_65536(ctx, _gen(dev), 2, reps=1)
    assert [r["shape"] for r in recs] == [[2, 4, 65536]] * 2
    assert [r["max_abs_err"] for r in recs] == [0.0] * 2


@pytest.mark.parametrize("seed", [0, 2024])
def test_threefry_and_samplers_on_card_equal_cpu(dev, seed):
    kc, kg = TF.key(seed), TF.key(seed, dev)
    assert torch.equal(TF.split(kg, 5).cpu(), TF.split(kc, 5))
    assert torch.equal(TF.fold_in(kg, 0x5eed).cpu(), TF.fold_in(kc, 0x5eed))
    kc, kg = TF.split(kc, 3), TF.split(kg, 3)
    assert torch.equal(TF.bits(kg, (4, 8192)).cpu(), TF.bits(kc, (4, 8192)))
    moduli = P.make_params(batch=4096, scale_bits=52, mult_depth=1).moduli
    shape = (2, 5, 8192)
    assert torch.equal(keys.uniform_mod_q_tf(kg, shape, moduli).cpu(),
                       keys.uniform_mod_q_tf(kc, shape, moduli))
    assert torch.equal(
        keys.uniform_mod_q_xor2(kg[0], kg[1], shape, moduli).cpu(),
        keys.uniform_mod_q_xor2(kc[0], kc[1], shape, moduli))
    for fn in (keys.ternary_coeffs_tf, keys.cbd_coeffs_tf):
        assert torch.equal(fn(kg, (3, 8192)).cpu(), fn(kc, (3, 8192)))


SPLIT_SEEDS = (0, 2 ** 32 - 1, 2 ** 62 + 12345)


def _split_launches(fn):
    """fn()'s result and the split kernel's launches while it ran."""
    before = cuda_lib.launches["threefry_split"]
    out = fn()
    return out, cuda_lib.launches["threefry_split"] - before


@pytest.mark.parametrize("impl", ["threefry", "rbg"])
@pytest.mark.parametrize("batch", [(), (3,), (3, 2), (64,)])
def test_threefry_split_kernel_matches_cpu(dev, impl, batch):
    """prng.split of either PRNG on the card is one launch of
    csrc/threefry_split.cu and the CPU's split bit for bit (which the CPU
    tests hold against jax.random.split)."""
    from fhe_fed_tpu_torch.utils import prng
    for seed in SPLIT_SEEDS:
        kc = prng.key(seed, impl, "cpu")
        if batch:
            kc = prng.split(kc, math.prod(batch)).reshape(*batch, -1)
        kg = kc.to(dev)
        for num in (1, 2, 3, 5, 64):
            got, n = _split_launches(lambda: prng.split(kg, num))
            assert n == 1
            assert got.is_cuda and got.shape == (*batch, num, kc.shape[-1])
            assert torch.equal(got.cpu(), prng.split(kc, num))


def test_threefry_split_kernel_on_strided_keys(dev):
    """A key batch that is a slice of unbind(-2), not contiguous, splits
    to the CPU's words."""
    from fhe_fed_tpu_torch.utils import prng
    for impl in prng.IMPLS:
        kc = prng.split(prng.split(prng.key(9, impl, "cpu"), 3), 2)
        for g, c in zip(kc.to(dev).unbind(-2), kc.unbind(-2)):
            assert not g.is_contiguous()
            got, n = _split_launches(lambda: prng.split(g, 5))
            assert n == 1 and torch.equal(got.cpu(), prng.split(c, 5))


def test_threefry_split_chain_as_the_cohort_encrypt(dev):
    """The chain of five splits a secret-key cohort encrypt makes
    (`_next_key`, `_split_clients`, `_sym_samples`, two `_rbg_pair`), each
    feeding the next, on the card under torch's sync check set to raise:
    five launches, no synchronise, the CPU's keys."""
    from fhe_fed_tpu_torch.utils import prng

    def chain(key):
        rng, k = prng.split(key).unbind(0)
        clients = prng.split(k, 3)
        k_a, k_e = prng.split(clients).unbind(-2)
        return [rng, clients, k_a, k_e] + [
            prng.split(prng.batch_rule(x, (4,), True)[0]) for x in (k_a, k_e)]
    for impl in prng.IMPLS:
        for seed in SPLIT_SEEDS:
            kg = prng.key(seed, impl, dev)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got, n = _split_launches(lambda: chain(kg))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert n == 5
            for g, w in zip(got, chain(prng.key(seed, impl, "cpu"))):
                assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("impl", ["threefry", "rbg"])
def test_encrypt_cohort_splits_in_five_launches(dev, tmp_path, impl):
    """A secret-key helper's encrypt_cohort on the card makes its five key
    splits in five launches of the split kernel and gives the CPU
    helper's ciphertext, and its key files, byte for byte."""
    helpers = [CKKS("ckks", 128, 40, cryptodir=str(tmp_path / d.type),
                    seed=7, device=d, prng=impl, symmetric=True)
               for d in (torch.device("cpu"), dev)]
    for h in helpers:
        h.genCryptoContextAndKeyGen()
    assert (tmp_path / "cpu" / "key-private.txt").read_bytes() == \
        (tmp_path / "cuda" / "key-private.txt").read_bytes()
    data = [np.random.default_rng(i).standard_normal(300) for i in range(3)]
    want = helpers[0].encrypt_cohort(data)
    got, n = _split_launches(lambda: helpers[1].encrypt_cohort(data))
    assert n == 5
    assert got.data.is_cuda and torch.equal(got.data.cpu(), want.data)


def test_threefry_split_kernel_refuses_what_it_does_not_take(dev):
    with pytest.raises(TypeError):
        TF.split(TF.key(1, dev).to(torch.int32))
    with pytest.raises(TypeError):
        TF.split(torch.zeros(4, dtype=torch.int64, device=dev))


def test_rbg_draws_on_card(dev):
    """The rbg key tree and draws on the card are the CPU's (XLA's Philox
    words, which the CPU tests hold against JAX), reproducible per key,
    and its samplers' statistics over 2**20 draws each within
    chip_smoke.Z_BOUND standard errors."""
    from fhe_fed_tpu_torch.utils import prng
    chip_smoke.check_rbg_key_tree(dev)
    keys_ = prng.split(prng.key(3, "rbg", dev), 2)
    moduli = P.make_params(batch=4096, scale_bits=52, mult_depth=1).moduli
    for vmap in (False, True):
        got = keys.uniform_mod_q_key(keys_, (2, 4, 8192), moduli, vmap=vmap)
        assert got.is_cuda and torch.equal(got.cpu(), keys.uniform_mod_q_key(
            keys_.cpu(), (2, 4, 8192), moduli, vmap=vmap))
    z = chip_smoke.rbg_sample_z(dev, moduli[:4], 8192, 128)
    assert all(abs(v) <= chip_smoke.Z_BOUND for v in z.values()), z


# (entry, per-key shape, key batch, vmap): the bench's shapes (the raw
# words of a 1224-row draw, the cohort's uniform `a` at 204 and 407 chunks
# and its ternary / CBD draws, under the vmap rule), sizes that are not a
# multiple of 4 drawn key by key, 28 limbs with rows of 10 (limb changes
# inside a Philox block).
PHILOX_CASES = [
    ("words", (1224, 8192), (), False),
    ("words", (13,), (3,), False),
    ("words", (5,), (), False),
    ("uniform", (204, 4, 8192), (3,), True),
    ("uniform", (407, 4, 8192), (3,), True),
    ("uniform", (3, 28, 10), (2,), False),
    ("uniform", (28, 8192), (), False),
    ("ternary", (3, 204, 8192), (4,), True),
    ("ternary", (7,), (3,), False),
    ("cbd", (3, 204, 8192), (4,), True),
    ("cbd", (3, 407, 8192), (), False),
    ("cbd", (13,), (2, 3), False),
]


@pytest.mark.parametrize("entry,shape,batch,vmap", PHILOX_CASES)
def test_philox_kernel_matches_plain(dev, entry, shape, batch, vmap):
    """Each entry of csrc/philox_rbg.cu bit for bit against its plain
    version (prng.philox_bits and the epilogues of ckks/keys.py) on the
    same keys on the card, reached through the dispatch a path uses, and
    equal to the CPU's draw; one launch a call."""
    from fhe_fed_tpu_torch.utils import philox_rbg, prng
    moduli = P.make_params(batch=4096, scale_bits=52,
                           mult_depth=24 if 28 in shape else 1).moduli
    root = prng.key(17, "rbg", dev)
    ks = (prng.split(root, math.prod(batch)).reshape(*batch, 4) if batch
          else root)
    k, per = prng.batch_rule(ks, shape, vmap)
    k1, k2 = (x.contiguous() for x in prng.split(k).unbind(-2))
    bits = prng.philox_bits
    before = cuda_lib.launches["philox_rbg"]
    if entry == "words":
        got = prng.bits(k, per)
        want = bits(k, per)
        cpu = prng.bits(k.cpu(), per)
    elif entry == "uniform":
        got = keys.uniform_mod_q_key(ks, shape, moduli, vmap=vmap)
        want = keys.uniform_from_words(bits(k1, per), bits(k2, per), moduli)
        cpu = keys.uniform_mod_q_key(ks.cpu(), shape, moduli, vmap=vmap)
        assert torch.equal(philox_rbg.uniform_mod_q(k1, k2, per, moduli),
                           got)
    elif entry == "ternary":
        got = keys.ternary_coeffs_key(ks, shape, vmap=vmap)
        want = keys.ternary_from_words(bits(k.contiguous(), per))
        cpu = keys.ternary_coeffs_key(ks.cpu(), shape, vmap=vmap)
    else:
        got = keys.cbd_coeffs_key(ks, shape, vmap=vmap)
        want = keys.cbd_from_words(bits(k1, per), bits(k2, per))
        cpu = keys.cbd_coeffs_key(ks.cpu(), shape, vmap=vmap)
    torch.cuda.synchronize()
    assert cuda_lib.launches["philox_rbg"] >= before + 1
    assert got.is_cuda and got.shape == (*batch, *shape)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(got.cpu(), cpu)


def test_philox_kernel_refuses_what_it_does_not_take(dev):
    from fhe_fed_tpu_torch.utils import philox_rbg, prng
    k = prng.key(1, "rbg", dev)
    with pytest.raises(ValueError):
        philox_rbg.words(k.cpu(), (4,))
    with pytest.raises(TypeError):
        philox_rbg.words(k.to(torch.int32), (4,))
    with pytest.raises(ValueError):
        philox_rbg.uniform_mod_q(k, k, (4, 8), [3] * 4)
    with pytest.raises(ValueError):
        philox_rbg.cbd(k, torch.stack([k, k]), (4,))


@pytest.mark.parametrize("mode", [dict(), dict(symmetric=True),
                                  dict(seeded_fresh=True),
                                  dict(packing="slots")])
def test_rbg_bytes_on_card_equal_cpu(dev, tmp_path, mode):
    """Under prng="rbg" a helper on the card writes the CPU helper's key
    files and blobs (the JAX class's bytes under rbg, held by the CPU
    tests), and its cohort ciphertext."""
    helpers = [CKKS("ckks", 128, 40, cryptodir=str(tmp_path / d.type),
                    seed=7, device=d, prng="rbg", **mode)
               for d in (torch.device("cpu"), dev)]
    for h in helpers:
        h.genCryptoContextAndKeyGen()
    for name in ("key-public.txt", "key-private.txt"):
        assert (tmp_path / "cpu" / name).read_bytes() == \
            (tmp_path / "cuda" / name).read_bytes()
    data = [np.random.default_rng(i).standard_normal(300) for i in range(3)]
    blobs = [[h.encrypt(x) for x in data] for h in helpers]
    assert blobs[0] == blobs[1]
    if "packing" not in mode:
        cts = [h.encrypt_cohort(data) for h in helpers]
        assert torch.equal(cts[0].data, cts[1].data.cpu())


def test_rbg_path_small(dev, tmp_path):
    """chip_smoke's rbg helpers and round with 20,000-value vectors: rbg
    by default on the card, every mode and the threshold round within
    1e-6, the same seed the same bytes."""
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    d = chip_smoke.write_cryptodir(params, tmp_path / "crypto")
    hs, twins = (chip_smoke.rbg_helpers(d, dev) for _ in range(2))
    others = chip_smoke.rbg_helpers(d, dev, seed=31)
    th = chip_smoke.threshold_helper(tmp_path / "thr", dev, seed=23)
    vecs, want = chip_smoke.api_vectors(20000, 10)
    (outs, blobs), _ = chip_smoke.drive("rbg", lambda: (
        chip_smoke.run_rbg_path(hs, twins, others, th, vecs)))
    errs = chip_smoke.check_rbg(outs, blobs, want)
    assert set(errs) == {"bytes_symmetric", "bytes_public_key",
                         "bytes_seeded_fresh", "threshold_round_fused"}


@pytest.mark.parametrize("mode", [dict(), dict(symmetric=True),
                                  dict(seeded_fresh=True),
                                  dict(packing="slots")])
def test_ckks_bytes_on_card_equal_cpu(dev, tmp_path, mode):
    helpers = [CKKS("ckks", 128, 40, cryptodir=str(tmp_path / d.type),
                    seed=7, device=d, prng="threefry", **mode)
               for d in (torch.device("cpu"), dev)]
    for h in helpers:
        h.genCryptoContextAndKeyGen()
    for name in ("key-public.txt", "key-private.txt"):
        assert (tmp_path / "cpu" / name).read_bytes() == \
            (tmp_path / "cuda" / name).read_bytes()
    data = [np.random.default_rng(i).standard_normal(300) for i in range(3)]
    blobs = [[h.encrypt(x) for x in data] for h in helpers]
    assert blobs[0] == blobs[1]
    aggs = [h.computeWeightedAverage(b, [0.5, 0.2, 0.3])
            for h, b in zip(helpers, blobs)]
    assert aggs[0] == aggs[1]
    outs = [h.decrypt(a, 300) for h, a in zip(helpers, aggs)]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_ffts_expansion_on_card(dev):
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    cpu = P.make_context(params, device="cpu")
    gpu = P.make_context(params, dev)
    sk_blob = (chip_smoke.KEY_DIR / "key-private.txt").read_bytes()
    sk = S.deserialize_secret_key(sk_blob, device="cpu")
    vals = torch.randn((3, 8192), generator=torch.Generator().manual_seed(1))
    sct = ops.encrypt_symmetric_seeded(cpu, sk, vals * 0.1, TF.key(4))
    blob = S.serialize_seeded_ct(cpu, sct)
    want = ops.expand_seeded(cpu, sct)
    got = S.deserialize_any_ct(gpu, blob)
    assert got.data.is_cuda and torch.equal(got.data.cpu(), want.data)
    gsk = S.deserialize_secret_key(sk_blob, dev)
    gsct = ops.encrypt_symmetric_seeded(gpu, gsk, (vals * 0.1).to(dev),
                                        TF.key(4, dev))
    assert S.serialize_seeded_ct(gpu, gsct) == blob
    assert torch.equal(ops.decrypt(gpu, gsk, got).cpu(),
                       ops.decrypt(cpu, sk, want))


def test_api_path_small(dev, tmp_path):
    """chip_smoke's known answers and API path with 20,000-value vectors
    (the streamed round in one slice)."""
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    chip_smoke.check_known_answers(P.make_context(params, dev))
    hs = chip_smoke.api_helpers(
        chip_smoke.write_cryptodir(params, tmp_path / "crypto"), dev)
    cnn, bert, slot = (chip_smoke.api_vectors(20000, s) for s in (1, 2, 3))
    sds = chip_smoke.cnn_state_dicts()
    (outs, blobs), counts = chip_smoke.drive("api", lambda: (
        chip_smoke.run_api_path(hs, cnn[0], bert[0], slot[0], sds)))
    errs = chip_smoke.check_api(outs, dict(cnn=cnn[1], bert=bert[1],
                                           slots=slot[1]), blobs, sds, dev)
    assert errs["ffts_over_fftc"] <= chip_smoke.FFTS_RATIO


def test_threshold_ceremonies_on_card_equal_cpu(dev):
    """Batched keygen, the stacked threshold decrypt and the fused
    threshold round on the card (K1, K3, K4; the round under rbg keys, as
    the threshold path's helper, so the Philox kernel too) equal the CPU
    bit for bit."""
    from fhe_fed_tpu_torch.ckks import threshold as thr
    from fhe_fed_tpu_torch.utils import prng
    params = P.make_params(batch=128, scale_bits=40, mult_depth=1,
                           ring_dim=256)
    cpu = P.make_context(params, device="cpu")
    gpu = P.make_context(params, dev)
    (csec, cpk), (gsec, gpk) = (thr.multiparty_keygen_batched(c, 3, seed=3)
                                for c in (cpu, gpu))
    assert torch.equal(gsec.s.cpu(), csec.s)
    assert torch.equal(gpk.p0_shoup.cpu(), cpk.p0_shoup)
    vals = torch.randn((3, 2, 256), generator=torch.Generator().manual_seed(1))
    cuda_lib.launches.clear()
    got, want = (thr.threshold_round_fused(
        c, sec, pk, vals.to(c.device), prng.key(7, "rbg", c.device),
        prng.split(prng.key(8, "rbg", c.device), 3), [0.5, 0.2, 0.3])
        for c, sec, pk in ((gpu, gsec, gpk), (cpu, csec, cpk)))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert all(cuda_lib.launches[k] > 0
               for k in chip_smoke.PATH_KERNELS["threshold"])
    ct = ops.encrypt(cpu, cpk, vals[0], TF.key(9))
    gct = dataclasses.replace(ct, data=ct.data.to(dev))
    keys_c, keys_g = TF.split(TF.key(10), 3), TF.split(TF.key(10, dev), 3)
    assert torch.equal(
        thr.partial_decrypt_stacked(gpu, gsec, gct, keys_g).cpu(),
        thr.partial_decrypt_stacked(cpu, csec, ct, keys_c))
    assert torch.equal(
        thr.threshold_decrypt(gpu, gsec, gct, keys_g).cpu().view(torch.int32),
        thr.threshold_decrypt(cpu, csec, ct, keys_c).view(torch.int32))


def test_threshold_path_small(dev, tmp_path):
    """chip_smoke's threshold path with 20,000-value vectors (5 chunks)."""
    n = 20000
    mctx, v, mvals = chip_smoke.mkhe_setup(dev, n)
    chip_smoke.check_threshold_known_answers(mctx)
    h = chip_smoke.threshold_helper(tmp_path / "thr", dev)
    cnn, want = chip_smoke.api_vectors(n, 10)
    outs, _ = chip_smoke.drive("threshold", lambda: (
        chip_smoke.run_threshold_path(h, cnn, mctx, mvals)))
    errs = chip_smoke.check_threshold(outs, want, mvals, v)
    assert errs["mkhe_square"] <= errs["mkhe_square_bound"]
    agg = h.computeWeightedAverage([h.encrypt(x) for x in cnn],
                                   chip_smoke.API_WEIGHTS)
    recs = chip_smoke.check_threshold_kernels(
        h.ctx, h._secrets, [h._deserialize(agg)], _gen(dev),
        chip_smoke.API_WEIGHTS, reps=1)
    assert [r["name"] for r in recs] == [
        "ntt_mxu_fused", "intt_mxu_fused", "decode_fused",
        "weighted_sum_fused"]
    assert [r["max_abs_err"] for r in recs] == [0.0] * 4


def test_masking_online_on_card_equal_cpu(dev, tmp_path):
    """The fixed-point codec (edge values included), the masked blobs, their
    sum and the decrypt on the card equal the CPU's on the same files."""
    from fhe_fed_tpu_torch import Masking
    from fhe_fed_tpu_torch.fed import masking as M
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e9, -3e9,
                      0.5 * 2 ** -13, -0.5 * 2 ** -13, 1.5 * 2 ** -13, 0.123,
                      -7.9, 100.0])
    enc = M.fixed_point_encode(x.to(dev), 17, 13)
    assert enc.is_cuda and torch.equal(enc.cpu(), M.fixed_point_encode(x, 17,
                                                                        13))
    ring = torch.randint(0, 1 << 17, (1000,), generator=torch.Generator()
                         .manual_seed(3))
    for d in (1, 3, 4):
        assert torch.equal(
            M.fixed_point_decode(ring.to(dev), 17, 13, d).cpu().view(
                torch.int32),
            M.fixed_point_decode(ring, 17, 13, d).view(torch.int32))
    hs = {d.type: [Masking("paillier", 2, modulus_bits=512,
                           cryptodir=str(tmp_path / "crypto"),
                           randomnessdir=str(tmp_path / f"rand{i}"), device=d)
                   for i in range(2)] for d in (torch.device("cpu"), dev)}
    chip_smoke.write_online_randomness(hs["cpu"], 5000, 1)
    data = [np.random.default_rng(i).standard_normal(5000).astype(np.float32)
            for i in range(2)]
    blobs = {k: [h.encrypt(v, iteration=1) for h, v in zip(hl, data)]
             for k, hl in hs.items()}
    assert blobs["cpu"] == blobs["cuda"]
    aggs = {k: hs[k][0].computeWeightedAverage(b) for k, b in blobs.items()}
    assert aggs["cpu"] == aggs["cuda"]
    np.testing.assert_array_equal(
        hs["cpu"][0].decrypt(aggs["cpu"], 5000, iteration=1),
        hs["cuda"][0].decrypt(aggs["cuda"], 5000, iteration=1))


def test_masking_path_small(dev, tmp_path):
    """chip_smoke's masking path with a 20,000-value online round."""
    hs = chip_smoke.masking_helpers(tmp_path, dev)
    off, _ = chip_smoke.mask_vectors(chip_smoke.MASK_OFFLINE_VALUES, 20)
    on, _ = chip_smoke.mask_vectors(20000, 21)
    chip_smoke.write_online_randomness(hs, 20000, 1)
    outs, counts = chip_smoke.drive("masking", lambda: (
        chip_smoke.run_masking_path(hs, off, on)))
    errs = chip_smoke.check_masking(outs, off, on, hs)
    assert max(errs[k] for k in outs) <= errs["bound"]


def _leaf_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.cpu().view(torch.int32).long()
                - b.cpu().view(torch.int32).long()).abs().max())


@pytest.mark.parametrize("name", ["cnn_fedavg", "mobilenet", "rnn_lstm",
                                  "tst", "tabnet", "gcn"])
def test_zoo_build_on_card_equals_cpu(dev, name):
    """build(name, seed) on the card draws the CPU's parameters: uniform
    leaves bit for bit (the affine step in float64 is exact on both), the
    normal leaves within 4 ulp (log1p may round otherwise on the card);
    the BatchNorm state equal."""
    from fhe_fed_tpu_torch.fed.fedavg import tree_leaves
    from fhe_fed_tpu_torch.models import zoo
    card = zoo.build(name, seed=5, device=dev)
    cpu = zoo.build(name, seed=5, device="cpu")
    normal = {"rnn_lstm": 1, "tst": 3, "tabnet": 10}.get(name, 0)
    differ = 0
    for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        assert a.device == dev and a.shape == b.shape
        u = _leaf_ulps(a, b)
        assert u <= 4
        differ += u > 0
    assert differ <= normal
    if cpu.state is not None:
        for a, b in zip(tree_leaves(card.state), tree_leaves(cpu.state)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("name", ["lenet", "resnet18", "bert", "groupvit",
                                  "tabnet"])
def test_zoo_forward_on_card_matches_cpu(dev, name):
    """The same weights and inputs forward on the card as on the CPU
    (TF32 off), within the CPU test's 2e-5 of max(1, |y|)."""
    from fhe_fed_tpu_torch.fed.fedavg import tree_leaves, tree_map
    from fhe_fed_tpu_torch.models import zoo
    torch.backends.cudnn.allow_tf32 = False
    cpu = zoo.build(name, seed=1, device="cpu")
    card = zoo.spec_from_tree(
        name, tree_map(lambda t: t.to(dev), cpu.params),
        None if cpu.state is None else tree_map(lambda t: t.to(dev),
                                                cpu.state))
    inputs = zoo.example_inputs(name)
    want = tree_leaves(cpu.forward(*[torch.as_tensor(x) for x in inputs]))
    got = tree_leaves(card.forward(*[torch.as_tensor(x, device=dev)
                                     for x in inputs]))
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        scale = max(1.0, float(w.abs().max()))
        assert float((g.cpu() - w).abs().max()) <= 2e-5 * scale


@pytest.mark.parametrize("name,kw", [("mlp", dict(max_chunks=8)),
                                     ("cnn_fedavg", dict()),
                                     ("cnn_fedavg", dict(use_fused=True)),
                                     ("cnn_fedavg", dict(use_bytes=True))])
def test_model_bench_on_card(dev, tmp_path, name, kw):
    """bench_model on the card: mlp streamed over slices of 8 chunks (K1,
    K3, K4 on each) and cnn_fedavg (407 chunks) on each path, within 1e-6
    of the plaintext mean, sized as on the CPU."""
    from fhe_fed_tpu_torch.benchmarks import model_bench as MB
    h = CKKS("ckks", 4096, 52, cryptodir=str(tmp_path), symmetric=True,
             seed=3, device=dev)
    h.genCryptoContextAndKeyGen()
    cuda_lib.launches.clear()
    r = MB.bench_model(name, 3, h, **kw)
    assert r["max_err"] <= 1e-6
    assert r["backend"] != "cuda" and "W" in r["backend"]
    chunks = -(-r["params"] // 4096)
    header = 64 if kw.get("use_fused") else S.CT_HEADER_BYTES
    if "max_chunks" not in kw:
        assert r["ct_bytes"] == 3 * (chunks * 2 * 4 * 8192 * 4 + header)
    for k in ("ntt_mxu_fused", "weighted_sum_fused", "decode_fused"):
        assert cuda_lib.launches[k] > 0, k


def _lenet_target(dev):
    from fhe_fed_tpu_torch.benchmarks import attack_eval as AE
    return AE.target(False, dev)


@pytest.fixture
def tf32_on():
    """The card's cuDNN default (TF32 on) and TF32 on for cuBLAS, as a
    caller may leave them; the fixture's own settings restored after."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = True
    yield
    mm.allow_tf32, cudnn.allow_tf32 = saved


def test_attack_gradients_on_card_match_cpu(dev, tf32_on):
    """model_gradients and gradient_sensitivity of LeNet on the card, with
    the caller's TF32 on, within 1e-5 of each leaf's largest element of the
    CPU's (the attack runs in full float32 whatever the caller set), and
    the caller's settings back after each call."""
    from fhe_fed_tpu_torch import attack
    from fhe_fed_tpu_torch.fed.fedavg import tree_map
    params, apply, x, onehot, _ = _lenet_target(dev)
    got = attack.model_gradients(apply, params, x, onehot)
    sens = attack.gradient_sensitivity(apply, params, x, onehot)
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    cpu = (apply, tree_map(lambda t: t.cpu(), params), x.cpu(), onehot.cpu())
    want = attack.model_gradients(*cpu) + [attack.gradient_sensitivity(*cpu)]
    for g, w in zip(got + [sens], want):
        assert g.is_cuda and g.shape == w.shape
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(
            w.abs().max())


@pytest.mark.parametrize("optimizer,steps", [("adam", 600), ("lbfgs", 150)])
def test_dlg_on_card_recovers_its_input(dev, optimizer, steps):
    """tests/test_attack.py's tiny MLP on the card: DLG recovers the input
    and the label."""
    from fhe_fed_tpu_torch import attack
    from fhe_fed_tpu_torch.models import layers as ML
    k1, k2 = TF.split(TF.key(0, dev))
    params = {"fc1": ML.dense_init(k1, 24, 12), "fc2": ML.dense_init(k2, 12,
                                                                     5)}

    def apply(p, x):
        return ML.dense(p["fc2"], torch.relu(ML.dense(p["fc1"], x)))
    x = np.random.default_rng(0).random((1, 24), dtype=np.float32)
    onehot = torch.nn.functional.one_hot(torch.tensor([2], device=dev),
                                         5).float()
    grads = attack.model_gradients(apply, params, torch.as_tensor(
        x, device=dev), onehot)
    res = attack.dlg_attack(apply, params, grads, x.shape, 5, steps=steps,
                            lr=0.05, seed=1, optimizer=optimizer)
    assert int(np.argmax(res.label)) == 2
    assert np.corrcoef(res.data.reshape(-1), x.reshape(-1))[0, 1] > 0.9


def test_param_sweep_point_on_card(dev, tmp_path):
    """param_sweep.run_config("mlp", 4096, 20) on the card, on a model
    trained there: K1 both ways, K3 and K4 launched, a finite error, the
    card's peak memory recorded."""
    from fhe_fed_tpu_torch.benchmarks import param_sweep as PSW
    cuda_lib.launches.clear()
    r = PSW.run_config(4096, 20, "mlp", tmp_path / "keys", out=tmp_path,
                       device=dev)
    for k in ("ntt_mxu_fused", "intt_mxu_fused", "weighted_sum_fused",
              "decode_fused"):
        assert cuda_lib.launches[k] > 0, k
    assert r["chunks"] == 20 and np.isfinite(r["max_err"])
    assert r["max_err"] < 1e-3 and r["acc_plain"] > 0.8
    assert r["peak_mem_bytes"] > 0 and "W" in r["backend"]


@pytest.fixture
def nccl_world1(dev, tmp_path):
    """A process group of one rank on the card (NCCL), destroyed after."""
    import torch.distributed as dist
    from fhe_fed_tpu_torch.parallel import multihost as MH
    assert MH.init_distributed(f"file://{tmp_path}/store", 1, 0, dev)
    yield
    dist.destroy_process_group()


def test_full_fed_step_world1_nccl_equals_single_device_round(
        dev, nccl_world1):
    """parallel/mesh.full_fed_step on an NCCL ('clients', 'chunks') mesh of
    world size 1: K1, K3 and K4 launched, the result equal to the port's
    single-device round (ops.encrypt over the same key batch, weighted
    sum, rescale, decrypt) bit for bit."""
    from fhe_fed_tpu_torch.parallel import mesh as PM
    pod = chip_smoke.pod_setup(dev, n_params=20_000, n_clients=12)
    mesh = PM.make_fed_mesh(1, 1)
    cuda_lib.launches.clear()
    got = PM.full_fed_step(pod["ctx"], mesh)(
        pod["pk"], pod["values"], pod["keys"], pod["w_res"], pod["w_shoup"],
        pod["sk"])
    torch.cuda.synchronize()
    for k in ("ntt_mxu_fused", "intt_mxu_fused", "weighted_sum_fused",
              "decode_fused"):
        assert cuda_lib.launches[k] > 0, k
    want = chip_smoke.single_device_round(pod, group=5)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    err = (got.double().cpu().numpy().reshape(-1)[:20_000]
           - pod["want"].reshape(-1)[:20_000])
    assert np.max(np.abs(err)) <= 1e-6


@pytest.mark.parametrize("n,L", [(8192, 4), (65536, 4), (1024, 3)])
def test_dist_ntt_on_card_equals_cpu(dev, n, L):
    """ntt/dist.py's transforms (plain torch) on the card against the
    same on the CPU, and the product against the on-chip one."""
    from fhe_fed_tpu_torch.ntt import dist as D
    mod = primes.ntt_primes(n, L)
    x = uniform_mod_q(_gen(dev, n), (2, L, n), mod)
    dt = D.make_dist_tables(n, mod, device=dev)
    dt_cpu = D.make_dist_tables(n, mod, device="cpu")
    ds = D.DistSpec()
    xd = D.to_dist_coeff(x, dt.n1)
    got = D.dist_ntt(xd, dt, ds)
    assert torch.equal(got.cpu(), D.dist_ntt(xd.cpu(), dt_cpu, ds))
    assert torch.equal(D.dist_intt(got, dt, ds), xd)
    tb = tables.make_tables(n, mod, device=dev)
    assert torch.equal(D.dist_to_eval(got), ntt_mod.ntt(x, tb))


def test_dist_round_on_card_equals_cpu(dev):
    """ckks/dist_ckks.make_dist_fed_step at N = 65536 on the card (K3 on
    the flattened ring, K4 on the decode rows) equals the CPU's."""
    from fhe_fed_tpu_torch.ckks import dist_ckks as DC
    from fhe_fed_tpu_torch.ntt import dist as D
    outs = []
    for d in (dev, torch.device("cpu")):
        ctx = P.make_context(P.make_params(**chip_smoke.RING_65536), d)
        sk, _ = keys.keygen(ctx, 3)
        dt = D.make_dist_tables(ctx.ring_dim,
                                ctx.params.moduli[:ctx.params.chain_len],
                                device=d)
        vals = np.random.default_rng(1).standard_normal(
            (2, 1, ctx.ring_dim)).astype(np.float32) * 0.1
        step = DC.make_dist_fed_step(ctx, dt, D.DistSpec(), [0.75, 0.25])
        cuda_lib.launches.clear()
        outs.append(step(DC.sk_to_dist(sk, dt.n1), D.to_dist_coeff(
            torch.as_tensor(vals, device=d), dt.n1), TF.key(3, d)))
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert cuda_lib.launches["weighted_sum_fused"] > 0
            assert cuda_lib.launches["decode_fused"] > 0
    assert torch.equal(outs[0].cpu().view(torch.int32),
                       outs[1].view(torch.int32))
    want = vals[0] * 0.75 + vals[1] * 0.25
    assert np.max(np.abs(D.from_dist_coeff(outs[1]).numpy() - want)) < 1e-3


@pytest.mark.parametrize("cap,chunks", [(8192, 204), (4096, 407)])
def test_bench_headline_on_card(dev, cap, chunks):
    """fhe_fed_tpu_torch.bench's headline on the card at the CNN's size
    with blocks of 2 rounds and one rep: its chunk count, max_err <= 1e-6,
    K1, K3 and K4 launched, and a block's output on the card."""
    cuda_lib.launches.clear()
    r = bench.headline(cap, "rbg", dev, n_times=2, reps=1)
    assert (r["config"]["chunks"], r["config"]["backend"]) == (chunks, "cuda")
    assert r["max_err"] <= 1e-6
    for k in ("ntt_mxu_fused", "intt_mxu_fused", "weighted_sum_fused",
              "decode_fused"):
        assert cuda_lib.launches[k] > 0, k
    out = bench.run_block(chip_smoke.bench_setup(dev, cap), 9, 1)[3]
    assert out.is_cuda and tuple(out.shape) == (chunks, 8192)


@pytest.mark.parametrize("symmetric", [True, False])
def test_bench_threefry_round_on_card_equals_cpu(dev, symmetric):
    """A threefry bench round at 2 chunks: the ciphertexts, the aggregate
    and the decrypt on the card equal the port's on the CPU bit for bit."""
    got = {}
    for d in (dev, torch.device("cpu")):
        _, params, ctx, sk, pk = bench.run_init(d)
        values, _ = bench.make_clients(12_000, 3, params.ring_dim,
                                       params.ring_dim, device=d)
        c = bench.Cohort(ctx, sk, pk, values, [1.0 / 3] * 3, "threefry")
        cts = bench.encrypt_rounds(c, bench.round_rngs(2, 1, "threefry", d),
                                   symmetric)
        aggs = bench.aggregate_rounds(c, cts)
        got[d.type] = (cts[0].data, aggs[0].data,
                       bench.decrypt_rounds(c, aggs)[0])
    assert got["cuda"][2].is_cuda
    for a, b in zip(got["cuda"], got["cpu"]):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


TREE_POLICIES = dict(chip_smoke.POLICIES, **{
    "rate_1.0": SelectivePolicy(rate=1.0),
    "layer_mask_list": SelectivePolicy(layer_mask=[0, 2, 5]),
    "callable_on_paths": SelectivePolicy(
        layer_mask=lambda i, path: path.endswith(".weight"), rate=0.3),
    "nothing_encrypted": SelectivePolicy(layer_mask=[]),
})


def _card_trees(dev, seed=3):
    """Three state dicts on the card: leaves of 1, 4,095, 4,097 and 0
    values, a bfloat16 leaf, a non-contiguous one (a transpose) and a 3-d
    one."""
    gen = _gen(dev, seed)

    def leaf(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return [collections.OrderedDict([
        ("a.bias", leaf(1)), ("a.weight", leaf(4095)),
        ("b.weight", leaf(4097)), ("b.bias", leaf(0)),
        ("c.weight", leaf(33, 17).bfloat16()), ("d.weight", leaf(40, 9).t()),
        ("d.bias", leaf(3, 5, 7))]) for _ in range(3)]


@pytest.fixture(scope="module")
def tree_dir(dev, tmp_path_factory):
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    return chip_smoke.write_cryptodir(params,
                                      tmp_path_factory.mktemp("tree"))


@pytest.mark.parametrize("use_bytes", [False, True])
@pytest.mark.parametrize("policy", list(TREE_POLICIES))
def test_tree_card_path_equals_host_path(dev, tree_dir, policy, use_bytes):
    """fhe_fedavg over trees on the card equals it over their .cpu()
    copies bit for bit, two helpers of one seed: the flow on the CPU
    launches no tree kernel, on the card one gather and one scatter where
    something is encrypted and one average where something is not."""
    trees = _card_trees(dev)
    cpu = [collections.OrderedDict((k, v.cpu()) for k, v in t.items())
           for t in trees]
    hs = chip_smoke.tree_helpers(tree_dir, dev)
    pol = TREE_POLICIES[policy]
    cuda_lib.launches.clear()
    want = fhe_fedavg(hs[0], cpu, chip_smoke.API_WEIGHTS, pol, use_bytes)
    assert not any(cuda_lib.launches[n] for n in TA.NAMES)
    got = fhe_fedavg(hs[1], trees, chip_smoke.API_WEIGHTS, pol, use_bytes)
    plan = TA.leaf_plan([v.numel() for v in trees[0].values()],
                        list(trees[0]), pol)
    enc, plain = int(plan.enc[-1] > 0), int(plan.plain[-1] > 0)
    assert {n: cuda_lib.launches[n] for n in TA.NAMES} == {
        "tree_gather": enc, "tree_average": plain, "tree_scatter": enc}
    assert list(got) == list(want)
    for k in got:
        assert got[k].device.type == "cpu"
        assert chip_smoke.same_bits(got[k], want[k]), k


def test_tree_card_path_keeps_an_int64_leaf_on_the_card(dev, tree_dir):
    """A Linear + BatchNorm1d model's state dicts on the card, an int64
    `num_batches_tracked` among float32 leaves: one launch of each entry
    (the tree stays on the card), and the tree equals the same flow's over
    the .cpu() copies bit for bit."""
    trees = []
    for c in range(3):
        torch.manual_seed(c)
        m = torch.nn.Sequential(torch.nn.Linear(5, 4),
                                torch.nn.BatchNorm1d(4)).to(dev)
        m(torch.randn(8, 5, device=dev))
        m[1].num_batches_tracked += 1000 * c
        trees.append(m.state_dict())
    assert trees[0]["1.num_batches_tracked"].dtype == torch.int64
    cpu = [collections.OrderedDict((k, v.cpu()) for k, v in t.items())
           for t in trees]
    hs = chip_smoke.tree_helpers(tree_dir, dev)
    pol = SelectivePolicy(layer_mask=[0, 2, 5], rate=0.5)
    want = fhe_fedavg(hs[0], cpu, chip_smoke.API_WEIGHTS, pol)
    cuda_lib.launches.clear()
    got = fhe_fedavg(hs[1], trees, chip_smoke.API_WEIGHTS, pol)
    assert {n: cuda_lib.launches[n] for n in TA.NAMES} == dict.fromkeys(
        TA.NAMES, 1)
    assert list(got) == list(want)
    for k in got:
        assert got[k].device.type == "cpu"
        assert chip_smoke.same_bits(got[k], want[k]), k


def test_tree_mixed_devices_run_on_the_cpu(dev, tree_dir):
    """A tree with leaves on the card and on the CPU takes the flow on the
    CPU: no tree launch, and the tree equals the flow's over .cpu()
    copies bit for bit."""
    trees = _card_trees(dev)
    trees[1]["a.weight"] = trees[1]["a.weight"].cpu()
    cpu = [collections.OrderedDict((k, v.cpu()) for k, v in t.items())
           for t in trees]
    hs = chip_smoke.tree_helpers(tree_dir, dev)
    pol = TREE_POLICIES["rate_0.1"]
    want = fhe_fedavg(hs[0], cpu, chip_smoke.API_WEIGHTS, pol)
    cuda_lib.launches.clear()
    got = fhe_fedavg(hs[1], trees, chip_smoke.API_WEIGHTS, pol)
    assert not any(cuda_lib.launches[n] for n in TA.NAMES)
    assert list(got) == list(want)
    for k in got:
        assert chip_smoke.same_bits(got[k], want[k]), k


def test_tree_chip_smoke_path_small(dev, tree_dir):
    """chip_smoke's tree path over the CNN's state_dicts."""
    outs, counts = chip_smoke.drive("tree", lambda: chip_smoke.run_tree_path(
        chip_smoke.tree_helpers(tree_dir, dev), chip_smoke.cnn_state_dicts(),
        dev))
    assert len(outs) == len(chip_smoke.POLICIES)
    # Each policy twice on the card: float32, then bfloat16 read in place.
    assert counts["tree_average"] == 4 and counts["tree_gather"] == 6
    assert not TA.casts


class _Counting:
    """A helper whose fedavg_round counts the values it is given: a tensor
    by its numel, as fedbench/surfaces/selective.py counts it, host
    vectors by their sizes."""

    def __init__(self, helper):
        self.helper, self.values = helper, 0

    def __getattr__(self, name):
        return getattr(self.helper, name)

    def fedavg_round(self, vectors, *args, **kwargs):
        self.values += (vectors.numel() if torch.is_tensor(vectors) else
                        sum(int(np.asarray(v).size) for v in vectors))
        return self.helper.fedavg_round(vectors, *args, **kwargs)


class _HostRows:
    """A scheme whose fedavg_round takes K host vectors only (it declares
    no `fedavg_round_takes_tensor`), as the benchmark's plain reference
    helper."""

    def __init__(self, helper):
        self.helper = helper

    def fedavg_round(self, vectors, *args, **kwargs):
        assert all(isinstance(v, np.ndarray) for v in vectors)
        return self.helper.fedavg_round(vectors, *args, **kwargs)


def test_tree_card_path_at_the_deepseek_shard(dev, tree_dir):
    """One round at the DeepSeek-V2-Lite shard's 153-leaf layout on the
    card, rate 0.1: the encrypting call gets 3 x 53,506,181 values as the
    gathered buffer, packed on the card, one launch of each entry; the plain positions equal the plain version's
    f64 average bit for bit and the encrypted ones lie within 1e-6 of
    it."""
    c = chip_smoke.shard_cohort(dev, _gen(dev, 7))
    built = zoo.build("deepseek_v2_lite_shard", device="meta")
    trees = [collections.OrderedDict(
        (k, x.view(v.shape)) for (k, v), x in zip(built.params.items(), lv))
        for lv in c.leaves]
    helper = _Counting(chip_smoke.tree_helpers(tree_dir, dev)[0])
    cuda_lib.launches.clear()
    fed_api.staging.clear()
    got = fhe_fedavg(helper, trees, chip_smoke.API_WEIGHTS,
                     SelectivePolicy(rate=0.1))
    assert helper.values == 3 * 53_506_181
    assert fed_api.staging == {"device": 1}
    assert {n: cuda_lib.launches[n] for n in TA.NAMES} == dict.fromkeys(
        TA.NAMES, 1)
    assert list(got) == list(built.params)
    want = c.empty_output()
    full = SelectivePolicy(layer_mask=[])
    TA.average_plain(TA.Cohort(TA.leaf_plan(c.plan.sizes, list(got), full),
                               c.leaves, chip_smoke.API_WEIGHTS), want)
    want = want.cpu()
    for (k, leaf), kk, o, n in zip(got.items(), c.plan.k.tolist(),
                                   c.plan.out.tolist(), c.plan.sizes.tolist()):
        assert tuple(leaf.shape) == tuple(built.params[k].shape)
        flat = leaf.reshape(-1)
        assert chip_smoke.same_bits(flat[kk:], want[o + kk:o + n]), k
        assert float((flat[:kk] - want[o:o + kk]).abs().max()) <= 1e-6, k


def test_tree_card_path_device_staging_equals_host_rows(dev, tree_dir):
    """A bfloat16 card tree through the port's helper, whose fedavg_round
    packs the gathered buffer on the card, and through a scheme that takes
    host vectors only: the same tree bit for bit, two helpers of one
    seed; `staging` counts one round on each side."""
    trees = _contiguous_trees(dev, (torch.bfloat16,))
    hs = chip_smoke.tree_helpers(tree_dir, dev)
    pol = SelectivePolicy(rate=0.3)
    fed_api.staging.clear()
    want = fhe_fedavg(_HostRows(hs[0]), trees, chip_smoke.API_WEIGHTS, pol)
    assert fed_api.staging == {"host": 1}
    got = fhe_fedavg(hs[1], trees, chip_smoke.API_WEIGHTS, pol)
    assert fed_api.staging == {"host": 1, "device": 1}
    assert list(got) == list(want)
    for k in got:
        assert chip_smoke.same_bits(got[k], want[k]), k


def _contiguous_trees(dev, dtypes):
    """_card_trees made contiguous, leaf i in dtypes[i % len(dtypes)]."""
    return [collections.OrderedDict(
        (k, v.contiguous().to(dtypes[i % len(dtypes)]))
        for i, (k, v) in enumerate(t.items())) for t in _card_trees(dev)]


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "mixed"])
def test_tree_kernel_reads_each_dtype_as_its_plain_version(dev, kind):
    """The three entries over a card cohort of float32, bfloat16, or
    bfloat16 and float32 leaves in turn (modes 0, 1, 2; a leaf of 70,000
    values spans tiles) equal their plain versions bit for bit, and the
    bfloat16 cohort's results equal those of its leaves cast to float32."""
    dtypes = {"float32": (torch.float32,), "bfloat16": (torch.bfloat16,),
              "mixed": (torch.bfloat16, torch.float32)}[kind]
    trees = _contiguous_trees(dev, dtypes)
    big = torch.randn(3, 70000, generator=_gen(dev, 9), device=dev)
    for t, row in zip(trees, big):
        t["e.weight"] = row.to(dtypes[0])
    plan = TA.leaf_plan([v.numel() for v in trees[0].values()],
                        list(trees[0]), SelectivePolicy(rate=0.3))
    c = TA.Cohort(plan, [list(t.values()) for t in trees],
                  chip_smoke.API_WEIGHTS)
    cast = TA.Cohort(plan, [[x.float() for x in t.values()] for t in trees],
                     chip_smoke.API_WEIGHTS)
    assert (c.mode, cast.mode) == ({"float32": 0, "bfloat16": 1,
                                    "mixed": 2}[kind], 0)
    dec = torch.randn(int(plan.enc[-1]), generator=_gen(dev, 10),
                      device=dev)
    enc = TA.gather(c)
    outs = [c.empty_output() for _ in range(3)]
    TA.average(c, outs[0])
    TA.scatter(c, dec, outs[0])
    TA.average_plain(c, outs[1])
    TA.scatter_plain(c, dec, outs[1])
    TA.average(cast, outs[2])
    TA.scatter(cast, dec, outs[2])
    for a, b in ((enc, TA.gather_plain(c)), (enc, TA.gather(cast)),
                 (outs[0], outs[1]), (outs[0], outs[2])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("kind", ["bfloat16", "mixed"])
def test_tree_card_path_reads_bfloat16_in_place(dev, tree_dir, kind):
    """fhe_fedavg over card trees of bfloat16 leaves, or of bfloat16 and
    float32 leaves in turn: no leaf cast (`tree_average.casts` stays
    empty), one launch of each entry, and the tree bit for bit the same
    flow's over the leaves cast to float32 on the card, two helpers of one
    seed."""
    dtypes = ((torch.bfloat16,) if kind == "bfloat16"
              else (torch.bfloat16, torch.float32))
    trees = _contiguous_trees(dev, dtypes)
    cast = [collections.OrderedDict((k, v.float()) for k, v in t.items())
            for t in trees]
    hs = chip_smoke.tree_helpers(tree_dir, dev)
    pol = SelectivePolicy(rate=0.3)
    want = fhe_fedavg(hs[0], cast, chip_smoke.API_WEIGHTS, pol)
    TA.casts.clear()
    cuda_lib.launches.clear()
    got = fhe_fedavg(hs[1], trees, chip_smoke.API_WEIGHTS, pol)
    assert not TA.casts
    assert {n: cuda_lib.launches[n] for n in TA.NAMES} == dict.fromkeys(
        TA.NAMES, 1)
    assert list(got) == list(want)
    for k in got:
        assert chip_smoke.same_bits(got[k], want[k]), k


def test_tree_card_path_casts_only_what_it_cannot_read(dev, tree_dir):
    """A float32 card tree casts nothing; a float16 leaf, a transposed one
    and a leaf bfloat16 in one client alone are copied to float32, one
    count a leaf and client, and the tree equals the same flow's over
    those leaves cast by hand."""
    hs = chip_smoke.tree_helpers(tree_dir, dev)
    pol = SelectivePolicy(rate=0.3)
    trees = _contiguous_trees(dev, (torch.float32,))
    TA.casts.clear()
    for h in hs:        # both helpers, so that their draws stay in step
        fhe_fedavg(h, trees, chip_smoke.API_WEIGHTS, pol)
    assert not TA.casts
    for t in trees:
        t["a.weight"] = t["a.weight"].half()
        t["d.weight"] = t["d.weight"].t()
    trees[0]["d.bias"] = trees[0]["d.bias"].bfloat16()
    cast = [collections.OrderedDict((k, v.float().contiguous())
                                    for k, v in t.items()) for t in trees]
    want = fhe_fedavg(hs[0], cast, chip_smoke.API_WEIGHTS, pol)
    TA.casts.clear()
    got = fhe_fedavg(hs[1], trees, chip_smoke.API_WEIGHTS, pol)
    assert dict(TA.casts) == {"float16": 3, "float32": 3, "bfloat16": 1}
    for k in got:
        assert chip_smoke.same_bits(got[k], want[k]), k


# Granite-4.0-H-Small's layout at a tiny width: Mamba-2, attention and
# Mamba-2 layers, 6 experts held of 12 in stacked 3-d leaves, the tied
# embedding under two keys.
GRANITE_TINY = dict(
    granite_hybrid.GRANITE_H_SMALL, hidden_size=64, num_attention_heads=4,
    num_key_value_heads=2, mamba_n_heads=2, mamba_d_head=64,
    mamba_d_state=16, intermediate_size=32, shared_intermediate_size=48,
    num_local_experts=6, router_experts=12, num_experts_per_tok=3,
    vocab_size=256, num_hidden_layers=3,
    layer_types=["mamba", "attention", "mamba"])


def test_tree_card_path_tied_bfloat16_stacked_experts(dev, tree_dir):
    """Three tied bfloat16 state dicts with stacked expert leaves on the
    card through fhe_fedavg at rate 0.1: bit for bit the flow over their
    CPU copies (tied too) under a second helper of one seed; the gathered
    buffer packed on the card, no leaf cast, the tied pair counted once a
    client in `tree_average.aliases`, and its two outputs separate
    buffers, each holding its own decrypted prefix."""
    trees = [granite_hybrid.init(TF.key(seed, dev), GRANITE_TINY,
                                 torch.bfloat16) for seed in (1, 2, 3)]
    assert trees[0]["lm_head.weight"] is trees[0]["model.embed_tokens.weight"]
    cpu = []
    for t in trees:
        c = collections.OrderedDict((k, v.cpu()) for k, v in t.items())
        c["lm_head.weight"] = c["model.embed_tokens.weight"]
        cpu.append(c)
    hs = chip_smoke.tree_helpers(tree_dir, dev)
    pol = SelectivePolicy(rate=0.1)
    want = fhe_fedavg(hs[0], cpu, chip_smoke.API_WEIGHTS, pol)
    TA.casts.clear()
    TA.aliases.clear()
    fed_api.staging.clear()
    cuda_lib.launches.clear()
    got = fhe_fedavg(hs[1], trees, chip_smoke.API_WEIGHTS, pol)
    assert fed_api.staging == {"device": 1}
    assert not TA.casts
    assert dict(TA.aliases) == {"lm_head.weight": 3}
    assert {n: cuda_lib.launches[n] for n in TA.NAMES} == dict.fromkeys(
        TA.NAMES, 1)
    assert list(got) == list(want) == list(trees[0])
    for k in got:
        assert got[k].shape == trees[0][k].shape
        assert chip_smoke.same_bits(got[k], want[k]), k
    head, emb = got["lm_head.weight"], got["model.embed_tokens.weight"]
    assert head.data_ptr() != emb.data_ptr()
    k = math.ceil(0.1 * head.numel())
    assert torch.equal(head.reshape(-1)[k:], emb.reshape(-1)[k:])


def test_tree_kernel_past_two_to_the_31_positions(dev):
    """A bfloat16 cohort of 2,281,701,395 positions a client (leaves of
    2^30 + 3, 2^30 + 5 and 2^27 + 11 values, the last wholly past 2^31 in
    the output) at rate 0.1 on the card: the gathered prefixes, the
    averaged remainders and the scattered prefixes at the start, the
    prefix's end and the end of each leaf equal their plain values bit
    for bit (~27 GB of card memory)."""
    sizes = [2 ** 30 + 3, 2 ** 30 + 5, 2 ** 27 + 11]
    gen = _gen(dev, 11)
    leaves = [[torch.randn(n, generator=gen, device=dev,
                           dtype=torch.bfloat16) for n in sizes]
              for _ in range(3)]
    plan = TA.leaf_plan(sizes, ["a", "b", "c"], SelectivePolicy(rate=0.1))
    c = TA.Cohort(plan, leaves, chip_smoke.API_WEIGHTS)
    assert int(plan.out[-1]) > int(plan.out[2]) > 2 ** 31 and c.mode == 1
    enc = TA.gather(c)
    out = c.empty_output()
    TA.average(c, out)
    dec = torch.randn(int(plan.enc[-1]), generator=gen, device=dev)
    TA.scatter(c, dec, out)
    for i, n in enumerate(sizes):
        k, e, o = (int(a[i]) for a in (plan.k, plan.enc, plan.out))
        for j in (torch.arange(8), torch.arange(k - 4, k + 4),
                  torch.arange(n - 8, n)):
            j = j.to(dev)
            pre, rest = j[j < k], j[j >= k]
            for lv, row in zip(leaves, enc):
                assert torch.equal(row[e + pre], lv[i][pre].float())
            assert torch.equal(out[o + pre], dec[e + pre])
            acc = torch.zeros(rest.numel(), dtype=torch.float64, device=dev)
            for w, lv in zip(chip_smoke.API_WEIGHTS, leaves):
                acc = acc + w * lv[i][rest].double()
            assert chip_smoke.same_bits(out[o + rest], acc.float()), (i, j)


def test_host_blocks_are_pinned_exact_and_reused(dev):
    """fed/fedavg.py's exact-size page-locked blocks: a card tensor copies
    into one, which CUDA reports as pinned; the block is handed out
    again once every tensor on it is freed, and not before."""
    import gc
    from fhe_fed_tpu_torch.fed import fedavg as fedavg_mod
    blocks = fedavg_mod.HostBlocks()
    x = torch.randn(3, 1000, generator=_gen(dev, 4), device=dev)
    a = blocks.empty(x.shape, x.dtype).copy_(x)
    assert a.is_pinned() and torch.equal(a, x.cpu())
    b = blocks.empty(x.shape, x.dtype)
    assert b.data_ptr() != a.data_ptr()
    free = blocks.free[x.numel() * 4]
    row, ptr = a[1], a.data_ptr()
    del a
    gc.collect()
    assert not free                      # the row still holds a's block
    del row
    gc.collect()
    assert [block.ctypes.data for block in free] == [ptr]
    c = blocks.empty(x.shape, x.dtype)
    assert c.data_ptr() == ptr and not free and b.is_pinned()


# The passes of csrc/rlwe_passes.cu at the paths' shapes: (case, leading
# shape, mult_depth, c1): the cohort (3 clients x 204 chunks), a streamed
# slice (3 x 1,024), a bytes client (204 chunks), the seeded encrypt (c0
# alone) and the deep chain (3 x 51 chunks, 27 limbs, N 32768).
PASS_CASES = [
    ("cohort", (3, 204), 1, True),
    ("streamed", (3, 1024), 1, True),
    ("bytes", (204,), 1, True),
    ("seeded", (204,), 1, False),
    ("deep", (3, 51), 24, True),
]


def _pass_setup(dev, lead, mult_depth, seed):
    ctx = P.make_context(P.make_params(batch=4096, scale_bits=52,
                                       mult_depth=mult_depth), dev)
    g = _gen(dev, seed)
    sk, _ = keys.keygen(ctx, g)
    return ctx, sk, g


def _pass_launches(fn):
    """fn()'s result and the passes' launches while it ran."""
    before = {k: cuda_lib.launches[k] for k in rlwe_passes.NAMES}
    out = fn()
    return out, {k: cuda_lib.launches[k] - before[k]
                 for k in rlwe_passes.NAMES}


@pytest.mark.parametrize("case,lead,mult_depth,c1", PASS_CASES)
def test_rlwe_passes_match_plain(dev, case, lead, mult_depth, c1):
    """Each pass bit for bit against its plain version on the same CUDA
    tensors: the encode with the error (the secret-key encrypt) and
    without (encode_coeff: the public-key and distributed encodes), the
    encrypt pass with c1 or c0 alone, the decrypt pass; one launch a
    call."""
    ctx, sk, g = _pass_setup(dev, lead, mult_depth, len(case))
    L, n = ctx.params.chain_len, ctx.ring_dim
    scale = ctx.params.scale
    values = torch.randn((*lead, n), generator=g, device=dev)
    values.view(-1)[:8] *= 1e6
    e = keys.cbd_coeffs(g, (*lead, n))
    got, k = _pass_launches(
        lambda: encoding.encode_coeff(ctx, values, scale, error=e))
    assert k == {"encode_pass": 1, "encrypt_pass": 0, "decrypt_pass": 0}
    assert got.shape == (*lead, L, n) and got.dtype == torch.int32
    assert torch.equal(got, encoding.encode_plain(ctx, values, scale, L, e))
    pt, k = _pass_launches(lambda: encoding.encode_coeff(ctx, values, scale))
    assert k["encode_pass"] == 1
    assert torch.equal(pt, encoding.encode_plain(ctx, values, scale, L))
    del pt

    a = uniform_mod_q(g, (*lead, L, n), ctx.params.moduli)
    w = ntt_mod.ntt(got, ctx.tables.slice_limbs(0, L))
    del got
    ct, k = _pass_launches(lambda: rlwe_passes.encrypt(ctx, sk, a, w, c1))
    assert k == {"encode_pass": 0, "encrypt_pass": 1, "decrypt_pass": 0}
    assert ct.shape == (*lead, *((2,) if c1 else ()), L, n)
    assert torch.equal(ct, ops._encrypt_plain(ctx, sk, a, w, c1))
    del a, w
    data = ct if c1 else uniform_mod_q(g, (*lead, 2, L, n),
                                       ctx.params.moduli)
    ph, k = _pass_launches(lambda: rlwe_passes.decrypt(ctx, sk, data))
    assert k == {"encode_pass": 0, "encrypt_pass": 0, "decrypt_pass": 1}
    assert torch.equal(ph, ops._phase_plain(ctx, sk, data))


@pytest.mark.parametrize("scale_bits", [52, 40])
def test_encode_pass_at_the_edges(dev, scale_bits):
    """The encode pass on the edges of the plain version's exact range
    (+-0, rounding ties, negative values, |t| about 2**24 and just under
    2**96, subnormals) equals the plain version on the card, the CPU's and
    the rehearsal; outside it (pinned: csrc/rlwe_passes.cu states it),
    t mod q_l exactly for finite |t| >= 2**96 and 0 for a non-finite t,
    the error's lift added."""
    ctx = P.make_context(P.make_params(batch=4096, scale_bits=scale_bits,
                                       mult_depth=1), dev)
    cpu = P.make_context(ctx.params, "cpu")
    L, n = ctx.params.chain_len, ctx.ring_dim
    scale = 2.0 ** scale_bits
    vals = np.zeros((2, n), dtype=np.float32)
    edges = RR.edge_values(scale_bits)
    vals[0, :edges.size] = edges
    vals[1] = np.random.default_rng(scale_bits).standard_normal(n)
    e = torch.as_tensor(np.random.default_rng(1).integers(-10, 11, (2, n)),
                        dtype=torch.int32)
    v = torch.as_tensor(vals)
    got = encoding.encode_coeff(ctx, v.to(dev), scale, error=e.to(dev))
    assert torch.equal(got, encoding.encode_plain(ctx, v.to(dev), scale, L,
                                                  e.to(dev)))
    assert torch.equal(got.cpu(), encoding.encode_coeff(cpu, v, scale,
                                                        error=e))
    assert torch.equal(got.cpu(), RR.rehearse_encode(cpu, v, scale, L, e))

    big = np.array([2.0 ** 96, -(2.0 ** 96), 1.5 * 2.0 ** 100,
                    np.finfo(np.float32).max, -np.finfo(np.float32).max,
                    2.0 ** 127, -(2.0 ** 104) * 3, 2.0 ** 96 * 5],
                   dtype=np.float32)
    got = encoding.encode_coeff(ctx, torch.as_tensor(big, device=dev), 1.0)
    want = RR.exact_residues([int(x) for x in big.astype(np.float64)],
                             ctx.params.moduli[:L])
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    bad = torch.tensor([math.nan, math.inf, -math.inf, 3e38, -3e38, 0.0,
                        -math.nan, 1e30], dtype=torch.float32)
    eb = torch.tensor([0, -3, 5, 7, -1, 2, -10, 9], dtype=torch.int32)
    got = encoding.encode_coeff(ctx, bad.to(dev), scale, error=eb.to(dev))
    assert torch.equal(got.cpu(), RR.rehearse_encode(cpu, bad, scale, L, eb))
    q = cpu.q[:L, None]
    lift = torch.where(eb < 0, eb + q, eb).to(torch.int32)
    assert torch.equal(got.cpu(), lift)


@pytest.mark.parametrize("chunks", [204, 3])
def test_stacked_encrypt_and_round_on_card_equal_cpu(dev, chunks):
    """A whole encrypt_symmetric_stacked under an rbg key on the card (the
    encode and encrypt passes around K1) gives the CPU's ciphertext bytes
    (the plain versions); fedavg_round_fused gives the CPU's average bit
    for bit; one launch of each pass a call."""
    from fhe_fed_tpu_torch.utils import prng
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    sk_bytes = (chip_smoke.KEY_DIR / "key-private.txt").read_bytes()
    vals = np.random.default_rng(chunks).standard_normal(
        (3, chunks, params.ring_dim)).astype(np.float32)
    got = {}
    for d in (dev, torch.device("cpu")):
        ctx = P.make_context(params, d)
        sk = S.deserialize_secret_key(sk_bytes, device=d)
        v = torch.as_tensor(vals, device=d)
        key = prng.key(11, "rbg", d)
        (ct, rnd), k = _pass_launches(lambda: (
            ops.encrypt_symmetric_stacked(ctx, sk, v, key),
            ops.fedavg_round_fused(ctx, sk, v, key, [0.5, 0.2, 0.3])))
        got[d.type] = (ct.data.cpu(), rnd.cpu())
        if d.type == "cuda":
            assert k == {"encode_pass": 2, "encrypt_pass": 2,
                         "decrypt_pass": 1}
        else:
            assert not any(k.values())
    assert got["cuda"][0].numpy().tobytes() == got["cpu"][0].numpy().tobytes()
    assert torch.equal(got["cuda"][1].view(torch.int32),
                       got["cpu"][1].view(torch.int32))
