"""The hand-written CUDA kernels against their plain PyTorch versions, on
the GPU. Marked `cuda`: skipped where torch sees no CUDA device. On a GPU
host run them with

    python -m pytest tests/test_torch_cuda.py -q

They repeat chip_smoke.py's phases at smaller sizes, plus the shapes and
options the main path does not reach (small rings, K > 8, every live-limb
count of the decode).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fhe_fed_tpu_torch import cuda_lib
from fhe_fed_tpu_torch.ntt import mxu, mxu_pallas
from fhe_fed_tpu_torch.ckks import params as P, serial as S, ops, encoding
from fhe_fed_tpu_torch.ckks import pallas_agg, pallas_decode
from fhe_fed_tpu_torch.ckks.keys import uniform_mod_q

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


@pytest.mark.parametrize("n,L,batch", [(256, 3, 3), (512, 2, 19),
                                       (8192, 5, 7)])
def test_ntt_kernel_matches_plain(dev, n, L, batch):
    from fhe_fed_tpu_torch.rns import primes
    mod = primes.ntt_primes(n, L)
    mt = mxu.make_mxu_tables(n, mod, device=dev)
    x = uniform_mod_q(_gen(dev, n), (batch, L, n), mod)
    y = mxu_pallas.ntt_mxu_fused(x, mt)
    assert torch.equal(y, mxu.ntt_mxu(x, mt))
    z = mxu_pallas.intt_mxu_fused(y, mt)
    assert torch.equal(z, mxu.intt_mxu(y, mt))
    assert torch.equal(z, x)


@pytest.mark.parametrize("K", [1, 9, 16])
def test_weighted_sum_kernel_matches_plain(dev, K):
    ctx = P.make_context(P.make_params(batch=128, scale_bits=40,
                                       mult_depth=1, ring_dim=256), dev)
    L = ctx.params.chain_len
    stacked = uniform_mod_q(_gen(dev, K), (K, 5, 2, L, 256),
                            ctx.params.moduli)
    w = list(np.random.default_rng(K).uniform(0, 1, K))
    wr, ws, _ = ops._encode_weights(ctx, w, L, 0)
    got = pallas_agg.weighted_sum_fused(stacked, wr, ws, ctx.params.moduli[:L])
    want = ops._weighted_sum_impl(ctx, stacked,
                                  torch.as_tensor(wr, device=dev),
                                  torch.as_tensor(ws, device=dev))
    assert torch.equal(got, want)


def test_weighted_sum_kernel_refuses_17_clients(dev):
    x = torch.zeros((17, 1, 2, 4, 256), dtype=torch.int32, device=dev)
    w = np.ones((17, 4), dtype=np.int64)
    with pytest.raises(ValueError, match="1..16"):
        pallas_agg.weighted_sum_fused(x, w, w, (3, 5, 7, 11))


def test_decode_kernel_matches_plain_every_live(dev):
    ctx = P.make_context(P.make_params(batch=128, scale_bits=40,
                                       mult_depth=2, ring_dim=256), dev)
    for live in range(1, ctx.params.chain_len + 1):
        dc = ctx.dec_consts[live - 1]
        r = uniform_mod_q(_gen(dev, live), (3, live, 256), ctx.params.moduli)
        for scale in (2.0 ** 40, 2.0 ** 71, 2.0 ** -30):
            got = pallas_decode.decode_fused(ctx, dc, r, scale)
            want = encoding.decode_core(dc, ctx.q[:live], r, scale)
            nan = torch.isnan(want)
            assert torch.equal(torch.isnan(got), nan)
            assert torch.equal(got.view(torch.int32)[~nan],
                               want.view(torch.int32)[~nan])


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
    cuda_lib.launches.clear()
    outs = chip_smoke.run_main_path(ctx, sk, pk, values, weights, _gen(dev))
    assert all(cuda_lib.launches[k] > 0 for k in chip_smoke.KERNELS)
    assert chip_smoke.check_outputs(outs, want, 20000) <= chip_smoke.MAX_ERR
