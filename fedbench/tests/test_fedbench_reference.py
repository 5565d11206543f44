"""The reference against the scheme (a naive transform), against the
program at a tiny ring, and its frozen formats against the program's
ckks/serial.py byte for byte."""

import json

import numpy as np
import pytest
import torch

from fedbench.reference import check, ckks as ref, wire
from fhe_fed_tpu_torch.ckks import keys as pkeys
from fhe_fed_tpu_torch.ckks import ops as pops
from fhe_fed_tpu_torch.ckks import params as pparams
from fhe_fed_tpu_torch.ckks import serial as pserial
from fhe_fed_tpu_torch.ntt import ntt as pntt

N = 64
PARAMS = pparams.make_params(batch=32, scale_bits=30, mult_depth=1,
                             ring_dim=N)
CRYPTO = dict(scheme="ckks", batch=32, scale_bits=30, mult_depth=1,
              ring_dim=N, moduli=list(PARAMS.moduli),
              num_base=PARAMS.num_base, chain_len=PARAMS.chain_len,
              error_eta=20, dense_pack=True)


def test_ntt_is_the_negacyclic_evaluation():
    """Entry j of the forward transform is a(psi**(2 brv(j) + 1))."""
    n, q = 16, PARAMS.moduli[0]
    ring = ref.make_ring(n, [q], "cpu")
    a = torch.randint(0, q, (1, n), generator=torch.Generator().manual_seed(3))
    psi, brv = ref.root_2n(q, n), ref.bitrev(n)
    naive = [sum(int(a[0, i]) * pow(psi, (2 * int(brv[j]) + 1) * i, q)
                 for i in range(n)) % q for j in range(n)]
    assert ring.ntt(a)[0].tolist() == naive
    assert torch.equal(ring.intt(ring.ntt(a)), a)


@pytest.mark.parametrize("n", [N, 8192])
def test_ntt_matches_the_program(n):
    params = pparams.make_params(4096, 52, 1) if n == 8192 else PARAMS
    ctx = pparams.make_context(params, "cpu")
    ring = ref.make_ring(n, params.moduli, "cpu")
    x = ref.uniform(torch.Generator().manual_seed(5), (2, n), ring)
    got = pntt.ntt(x.to(torch.int32), ctx.tables).to(torch.int64)
    assert torch.equal(ring.ntt(x), got)
    assert torch.equal(ring.intt(got), x)


def test_lift_exact_small_and_close_large():
    ring = ref.make_ring(N, PARAMS.moduli, "cpu").limbs(4)
    vals = [0, 1, -1, 12345, -(2 ** 29), 2 ** 60 + 7, -(2 ** 100)]
    res = torch.tensor([[v % q for v in vals] for q in ring.moduli])
    got = ref.lift(res[None], ring.moduli)[0]
    assert got[:5].tolist() == vals[:5]
    assert got[5].item() == pytest.approx(float(vals[5]), rel=1e-15)
    assert got[6].item() == pytest.approx(float(vals[6]), rel=1e-15)


def _port_keys():
    ctx = pparams.make_context(PARAMS, "cpu")
    sk, pk = pkeys.keygen(ctx, torch.Generator().manual_seed(11))
    return ctx, sk, pk


def test_reference_decrypts_program_ciphertexts():
    ctx, sk, _ = _port_keys()
    vals = torch.randn((3, N), generator=torch.Generator().manual_seed(2)) \
        * 0.1
    ct = pops.encrypt_symmetric(ctx, sk, vals,
                                torch.Generator().manual_seed(4))
    keys = ref.KeyPair(sk.s.to(torch.int64), None, None)
    c = check.Checker(CRYPTO, keys, "cpu")
    c.clients(ct.data[None], vals[None], ct.scale, 2.0 ** 30)
    agg = pops.weighted_sum(ctx, [ct, ct], [0.25, 0.5])
    c.aggregate(agg.data, agg.scale, 0.75 * vals.double())
    got = c.numbers()
    assert got["format_faults"] == 0 and got["enc_noise"] <= 20
    assert got["agg_rel_err"] < 1e-7


def test_program_decrypts_reference_ciphertexts(tmp_path):
    """The reference's key files load into the program, and the program
    decrypts what the reference encrypts under them."""
    gen = torch.Generator().manual_seed(9)
    keys = ref.keygen(ref.make_ring(N, PARAMS.moduli, "cpu"), gen, 20)
    files = ref.cryptodir_files(CRYPTO, ref.make_ring(N, PARAMS.moduli,
                                                      "cpu"), keys)
    sk = pserial.deserialize_secret_key(files[wire.SK_FILE], "cpu")
    pk = pserial.deserialize_public_key(files[wire.PK_FILE], "cpu")
    assert torch.equal(sk.s.to(torch.int64), keys.s_hat)
    ctx = pparams.make_context(PARAMS, "cpu")
    vals = torch.randn((2, N), generator=gen) * 0.1
    h = ref.RefCKKS(CRYPTO, keys, "cpu", 1)
    ct = h.encrypt_cohort(vals[None])
    out = pops.decrypt(ctx, sk, pops.Ciphertext(ct.data[0], ct.scale, 0))
    assert torch.allclose(out.double(), vals.double(), atol=1e-7)
    # The public key is a valid RLWE sample: p0 + p1 s = e, small.
    e = ref.lift(ref.make_ring(N, PARAMS.moduli, "cpu").intt(
        (pk.p0.to(torch.int64) + pk.p1.to(torch.int64) * keys.s_hat)
        % torch.tensor(PARAMS.moduli)[:, None]), PARAMS.moduli)
    assert float(e.abs().max()) <= 20
    meta = json.loads(files[wire.CTX_FILE])
    assert meta["moduli"] == list(PARAMS.moduli)


def test_frozen_key_and_ciphertext_formats_match_the_program():
    ctx, sk, pk = _port_keys()
    assert wire.pack_key(0, N, [sk.s, sk.s_shoup]) == \
        pserial.serialize_secret_key(ctx, sk)
    assert wire.pack_key(1, N, [pk.p0, pk.p0_shoup, pk.p1, pk.p1_shoup]) == \
        pserial.serialize_public_key(ctx, pk)
    q = torch.tensor(PARAMS.moduli)[:, None]
    assert torch.equal(ref.shoup(sk.s, q), sk.s_shoup)
    vals = torch.randn((3, N), generator=torch.Generator().manual_seed(6))
    ct = pops.encrypt_symmetric(ctx, sk, vals,
                                torch.Generator().manual_seed(7))
    blob = pserial.serialize_ct(ctx, ct)
    assert wire.pack_ct(CRYPTO, 3, 4, ct.level, ct.scale, ct.data) == blob
    hdr, data = wire.parse_ct(blob)
    assert torch.equal(data, ct.data.to(torch.int64))
    assert (hdr["chunks"], hdr["live"], hdr["scale"]) == (3, 4, ct.scale)
    assert wire.parse_ct(blob[:-4])[1] is None


@pytest.mark.parametrize("precision,ok", [("float32", True),
                                          ("bfloat16", False)])
def test_reference_round_at_each_precision(precision, ok):
    gen = torch.Generator().manual_seed(21)
    keys = ref.keygen(ref.make_ring(N, PARAMS.moduli, "cpu"), gen, 20)
    h = ref.RefCKKS(CRYPTO, keys, "cpu", 3, precision=precision)
    vals = torch.randn((3, 2, N), generator=gen) * 0.1
    w = [0.5, 0.2, 0.3]
    ct = h.encrypt_cohort(vals)
    agg = h.aggregate_cohort(ct, w)
    out = h.decrypt_cohort(agg, raw=True)
    want = sum(wk * vals[k].double() for k, wk in enumerate(w))
    c = check.Checker(CRYPTO, keys, "cpu")
    c.clients(ct.data, vals, ct.scale, 2.0 ** 30)
    c.aggregate(agg.data, agg.scale, want)
    c.average(out, want)
    limits = dict(format_faults=0, enc_noise=1e8, enc_var_z=6,
                  a_uniform_z=6, a_repeats=0, agg_rel_err=1e-5,
                  avg_rel_err=1e-4)
    assert check.verdict(c.numbers(), limits) is ok
    flat = h.fedavg_round([v.reshape(-1).numpy() for v in vals], w,
                          block=1)
    assert np.abs(flat - want.reshape(-1).numpy()).max() < (
        1e-6 if ok else 1.0)


def test_a_chunk_seen_again_is_a_repeat():
    """Fresh encryptions of one cohort share no c1 chunk; the same
    ciphertext checked again repeats every chunk, and one client's `a`
    given to another repeats that client's."""
    gen = torch.Generator().manual_seed(4)
    keys = ref.keygen(ref.make_ring(N, PARAMS.moduli, "cpu"), gen, 20)
    h = ref.RefCKKS(CRYPTO, keys, "cpu", 5)
    vals = torch.randn((3, 2, N), generator=gen) * 0.1
    c = check.Checker(CRYPTO, keys, "cpu")
    first, second = h.encrypt_cohort(vals), h.encrypt_cohort(vals)
    for ct in (first, second):
        c.clients(ct.data, vals, ct.scale, 2.0 ** 30)
    assert c.numbers()["a_repeats"] == 0
    c.clients(first.data, vals, first.scale, 2.0 ** 30)
    assert c.numbers()["a_repeats"] == 3 * 2
    c = check.Checker(CRYPTO, keys, "cpu")
    data = h.encrypt_cohort(vals).data.clone()
    data[2, :, 1] = data[0, :, 1]
    c.clients(data, vals, 2.0 ** 30, 2.0 ** 30)
    assert c.numbers()["a_repeats"] == 2
