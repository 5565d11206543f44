"""The hand-written CUDA kernels against their plain PyTorch versions, on
the GPU. Marked `cuda`: skipped where torch sees no CUDA device. On a GPU
host run them with

    python -m pytest tests/test_torch_cuda.py -q

They repeat chip_smoke.py's phases at smaller sizes, plus the shapes and
options the paths do not reach (small rings, K > 8, every live-limb count
of the decode up to 27, K1 up to 28 limbs, K2 at N = 65536, both NTT
kernels on one ring), and hold the threefry
sampling, the CKKS bytes surface, the FFTS expansion, the threshold
ceremonies and the masking scheme's online phase on the card equal to the
CPU.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import chip_smoke
from fhe_fed_tpu_torch import cuda_lib, CKKS
from fhe_fed_tpu_torch.rns import primes
from fhe_fed_tpu_torch.ntt import mxu, mxu_pallas, tables, pallas_ntt
from fhe_fed_tpu_torch.ntt import ntt as ntt_mod
from fhe_fed_tpu_torch.ckks import params as P, serial as S, ops, encoding
from fhe_fed_tpu_torch.ckks import pallas_agg, pallas_decode, keys
from fhe_fed_tpu_torch.ckks import keyswitch as KS
from fhe_fed_tpu_torch.ckks.keys import uniform_mod_q
from fhe_fed_tpu_torch.utils import threefry as TF

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
    assert [r["max_abs_err"] for r in recs] == [0.0] * 4
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
    = 14 / 24): 17 / 27 live limbs at N = 32768, K2, K3 and K4 on the card;
    the keys equal the CPU's."""
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=mult_depth)
    assert params.chain_len == mult_depth + 3 and params.ring_dim == 32768
    ctx = P.make_context(params, dev)
    sk, pk = keys.keygen(ctx, 5)
    csk, _ = keys.keygen(P.make_context(params, device="cpu"), 5)
    assert torch.equal(sk.s.cpu(), csk.s)
    vals, weights, want = chip_smoke.make_values(3, 20000, 1, 32768)
    values = torch.as_tensor(vals, device=dev)
    outs, _ = chip_smoke.drive("deep", lambda: chip_smoke.run_main_path(
        ctx, sk, pk, values, weights, _gen(dev)))
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


@pytest.mark.parametrize("mode", [dict(), dict(symmetric=True),
                                  dict(seeded_fresh=True),
                                  dict(packing="slots")])
def test_ckks_bytes_on_card_equal_cpu(dev, tmp_path, mode):
    helpers = [CKKS("ckks", 128, 40, cryptodir=str(tmp_path / d.type),
                    seed=7, device=d, **mode)
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
    threshold round on the card (K1, K3, K4) equal the CPU bit for bit."""
    from fhe_fed_tpu_torch.ckks import threshold as thr
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
    got = thr.threshold_round_fused(gpu, gsec, gpk, vals.to(dev),
                                    TF.key(7, dev), TF.split(TF.key(8, dev), 3),
                                    [0.5, 0.2, 0.3])
    want = thr.threshold_round_fused(cpu, csec, cpk, vals, TF.key(7),
                                     TF.split(TF.key(8), 3), [0.5, 0.2, 0.3])
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
