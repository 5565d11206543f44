"""The port's sharded four-step NTT (fhe_fed_tpu_torch/ntt/dist.py) and the
round in its layout (ckks/dist_ckks.py) in 8 gloo ranks on the CPU,
against the JAX package's ntt/dist.py and ckks/dist_ckks.py on the 8
virtual devices of tests/conftest.py, and against the port's on-chip path,
on the same seeded inputs (tests/_torch_dist_child.py), at N = 1024:

- the tables, the eval permutation and the automorphism maps equal JAX's;
- dist_ntt / dist_intt equal JAX's bit for bit on ('coeff',) 8 and
  ('limb', 'coeff') (2, 4) (a wrong block order in the exchange still
  round-trips: only the forward against JAX catches it), round-trip
  exactly, and dist_poly_mul equals the on-chip negacyclic product;
- the dist_ckks contract on (2, 4): the encrypt equals JAX's, and the
  weighted sum, rescale and decrypt commute with ct_dist_to_onchip against
  the port's on-chip path; make_dist_fed_step equals JAX's;
- dist_automorphism equals the on-chip automorphism (rotations by 1 and 5
  and the conjugation), as tests/test_dist_ckks.py.

The ranks run once, in a module fixture; the tests read their blocks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from fhe_fed_tpu.ckks import params as JP, keys as JK
from fhe_fed_tpu.ckks import dist_ckks as JDC
from fhe_fed_tpu.ntt import dist as JD
from fhe_fed_tpu_torch.ckks import params as P, keys as K, ops as O
from fhe_fed_tpu_torch.ckks import dist_ckks as DC, keyswitch as KS
from fhe_fed_tpu_torch.ntt import dist as D, tables as T, ntt as NTT
from fhe_fed_tpu_torch.parallel import launch
from fhe_fed_tpu_torch.rns import modops, primes

import _torch_dist_child as C

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = C.NTT_RING
# mesh name -> (JAX mesh shape, axis names, JAX limb axis,
#               {mesh dim: array dim} of the row and column layouts)
MESHES = {
    "coeff8": ((8,), ("coeff",), None, {0: -2}, {0: -1}),
    "limb_coeff": ((2, 4), ("limb", "coeff"), "limb", {0: -3, 1: -2},
                   {0: -3, 1: -1}),
}


@pytest.fixture(scope="module")
def ranks():
    return launch.spawn(C.dist_suite, 8, device="cpu")


def _jax_spec(name):
    shape, names, limb, _, _ = MESHES[name]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), names)
    return JD.DistSpec(mesh=mesh, limb_axis=limb)


def _whole(ranks, name, key, layout):
    """Put the ranks' blocks of `key` together; layout "row" or "col"."""
    dims = MESHES[name][3 if layout == "row" else 4]
    parts = [(r[name]["coord"], r[name][key]) for r in ranks]
    nd = parts[0][1].ndim
    return C.assemble(parts, {md: ad % nd for md, ad in dims.items()})


@pytest.fixture(scope="module")
def port_tables():
    return (T.make_tables(N, C.ntt_moduli(), device=CPU),
            D.make_dist_tables(N, C.ntt_moduli(), device=CPU))


@pytest.mark.parametrize("n,n1", [(1024, None), (256, 4), (512, None),
                                  (2048, 64)])
def test_dist_tables_equal_jax(n, n1):
    moduli = tuple(primes.ntt_primes(n, 3))
    got = D.make_dist_tables(n, moduli, n1=n1, device=CPU)
    want = JD.make_dist_tables(n, moduli, n1=n1)
    assert (got.n1, got.n2) == (want.n1, want.n2)
    for f in ("q", "twist", "twist_shoup", "untwist", "untwist_shoup", "mid",
              "mid_shoup", "imid", "imid_shoup"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.int64),
            np.asarray(getattr(want, f)).astype(np.int64), err_msg=f)
    for f in ("f1", "f1_shoup", "i1", "i1_shoup", "f2", "f2_shoup", "i2",
              "i2_shoup"):
        a, b = getattr(got, f), getattr(want, f)
        assert len(a) == len(b), f
        for s, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(
                x.numpy().astype(np.int64), np.asarray(y).astype(np.int64),
                err_msg=f"{f}[{s}]")


@pytest.mark.parametrize("size", [2, 8, 32, 128])
def test_cyclic_stage_tables_equal_jax(size):
    q = C.ntt_moduli()[0]
    omega = pow(3, (q - 1) // size, q)
    for a, b in zip(D._cyclic_stage_tables(size, omega, q),
                    JD._cyclic_stage_tables(size, omega, q)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y.astype(np.int64))


@pytest.mark.parametrize("n,n1", [(1024, 32), (256, 4), (2048, 32)])
def test_eval_perm_equals_jax(n, n1):
    np.testing.assert_array_equal(D.eval_perm(n, n1), JD.eval_perm(n, n1))


@pytest.mark.parametrize("g_index", [0, 1, 2])
def test_auto_perms_equal_jax(g_index):
    g = C.galois_elements(N)[g_index]
    for a, b in zip(DC._dist_auto_perms(N, 32, g),
                    JDC._dist_auto_perms(N, 32, g)):
        np.testing.assert_array_equal(a, b.astype(np.int64))


def test_layout_conversions_invert():
    x = torch.as_tensor(C.ntt_input())
    d = D.eval_to_dist(x, 32)
    assert d.shape == (2, C.NTT_LIMBS, 32, 32)
    assert torch.equal(D.dist_to_eval(d), x)
    np.testing.assert_array_equal(D.eval_to_dist(x.numpy(), 32), d.numpy())
    assert torch.equal(D.from_dist_coeff(D.to_dist_coeff(x, 32)), x)


@pytest.fixture(scope="module")
def jax_transforms():
    jdt = JD.make_dist_tables(N, C.ntt_moduli())
    out = {}
    for name in MESHES:
        ds = _jax_spec(name)
        x = jnp.asarray(JD.to_dist_coeff(C.ntt_input().astype(np.uint32),
                                         jdt.n1))
        y = jnp.asarray(JD.to_dist_coeff(C.ntt_input(9).astype(np.uint32),
                                         jdt.n1))
        out[name] = (np.asarray(jax.jit(lambda v: JD.dist_ntt(v, jdt, ds))(x)),
                     np.asarray(jax.jit(lambda v: JD.dist_intt(v, jdt, ds))(
                         y)))
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_dist_ntt_matches_jax(ranks, jax_transforms, name):
    got = _whole(ranks, name, "fwd", "row")
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  jax_transforms[name][0])


@pytest.mark.parametrize("name", list(MESHES))
def test_dist_intt_matches_jax(ranks, jax_transforms, name):
    got = _whole(ranks, name, "inv", "col")
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  jax_transforms[name][1])


@pytest.mark.parametrize("name", list(MESHES))
def test_dist_ntt_matches_onchip(ranks, port_tables, name):
    tb, dt = port_tables
    got = _whole(ranks, name, "fwd", "row")
    want = NTT.ntt(torch.as_tensor(C.ntt_input()), tb)
    assert torch.equal(D.dist_to_eval(torch.as_tensor(got)), want)


@pytest.mark.parametrize("name", list(MESHES))
def test_roundtrip_exact(ranks, name):
    got = _whole(ranks, name, "rt", "col")
    np.testing.assert_array_equal(D.from_dist_coeff(got), C.ntt_input())


@pytest.mark.parametrize("name", list(MESHES))
def test_gather_axis_puts_the_columns_back(ranks, name):
    x = D.to_dist_coeff(C.ntt_input(), 32)
    for r in ranks:
        limbs = (slice(None) if name == "coeff8" else
                 slice(2 * int(r[name]["coord"][0]),
                       2 * int(r[name]["coord"][0]) + 2))
        np.testing.assert_array_equal(r[name]["cols_gathered"],
                                      x[:, limbs])


@pytest.mark.parametrize("name", list(MESHES))
def test_poly_mul_matches_onchip(ranks, port_tables, name):
    tb, _ = port_tables
    a, b = (torch.as_tensor(C.ntt_input(s)) for s in (42, 7))
    q = torch.as_tensor(np.asarray(C.ntt_moduli(), dtype=np.int64))[:, None]
    want = NTT.intt(modops.mul_mod(NTT.ntt(a, tb), NTT.ntt(b, tb), q).to(
        torch.int32), tb)
    got = _whole(ranks, name, "prod", "col")
    np.testing.assert_array_equal(D.from_dist_coeff(got), want.numpy())


# --- the round in the dist layout, ('limb', 'coeff') (2, 4) ----------------

def _round(ranks, key, layout, limbs_sharded=True):
    parts = [(r["round"]["coord"], r["round"][key]) for r in ranks]
    nd = parts[0][1].ndim
    dims = {1: nd - 2 if layout == "row" else nd - 1}
    if limbs_sharded:
        dims[0] = nd - 3
    return C.assemble(parts, dims)


@pytest.fixture(scope="module")
def onchip_round():
    """The port's on-chip path on the dist ciphertexts, layout-converted."""
    params = C.round_params()
    ctx = P.make_context(params, CPU)
    sk, _ = K.keygen(ctx, 0)
    return params, ctx, sk


def _onchip(x):
    return DC.ct_dist_to_onchip(torch.as_tensor(x))


def test_dist_encrypt_matches_jax(ranks):
    params = JP.make_params(batch=128, scale_bits=40, mult_depth=1,
                            ring_dim=N)
    ctx = JP.make_context(params)
    sk, _ = JK.keygen(ctx, seed=0)
    jdt = JD.make_dist_tables(N, params.moduli[:params.chain_len])
    ds = _jax_spec("limb_coeff")
    vals = jnp.asarray(C.round_values(len(C.ROUND_WEIGHTS), 0).reshape(
        -1, N))
    sk_d = JDC.sk_to_dist(sk, jdt.n1)
    with ds.mesh:
        want = np.asarray(jax.jit(lambda v: JDC.encrypt_symmetric_dist(
            ctx, jdt, ds, sk_d, v, jax.random.key(7),
            float(params.scale)))(vals))
    got = _round(ranks, "cts", "row")
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_weighted_sum_commutes_with_the_layout(ranks, onchip_round):
    params, ctx, _ = onchip_round
    stacked = _round(ranks, "cts", "row").reshape(
        len(C.ROUND_WEIGHTS), C.ROUND_CHUNKS, 2, params.chain_len, 32, 32)
    ct = O.Ciphertext(_onchip(stacked), params.scale, 0)
    want = O.weighted_sum(ctx, ct, C.ROUND_WEIGHTS).data
    assert torch.equal(_onchip(_round(ranks, "agg", "row")), want)


def test_rescale_commutes_with_the_layout(ranks, onchip_round):
    params, ctx, _ = onchip_round
    agg = _onchip(_round(ranks, "agg", "row"))
    want = O.rescale(ctx, O.Ciphertext(agg, params.scale ** 2, 0)).data
    got = _round(ranks, "res", "row", limbs_sharded=False)
    assert torch.equal(_onchip(got), want)


def test_decrypt_commutes_with_the_layout(ranks, onchip_round):
    params, ctx, sk = onchip_round
    res = _onchip(_round(ranks, "res", "row", limbs_sharded=False))
    want = O.decrypt(ctx, sk, O.Ciphertext(res, params.scale, 1)).numpy()
    got = D.from_dist_coeff(_round(ranks, "dec", "col", False))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plain = np.tensordot(np.asarray(C.ROUND_WEIGHTS),
                         C.round_values(len(C.ROUND_WEIGHTS), 0)
                         .astype(np.float64), axes=1)
    assert np.max(np.abs(got - plain)) < 1e-3


def test_dist_fed_step_matches_jax(ranks):
    params = JP.make_params(batch=128, scale_bits=40, mult_depth=1,
                            ring_dim=N)
    ctx = JP.make_context(params)
    sk, _ = JK.keygen(ctx, seed=0)
    jdt = JD.make_dist_tables(N, params.moduli[:params.chain_len])
    ds = _jax_spec("limb_coeff")
    step = JDC.make_dist_fed_step(ctx, jdt, ds, list(C.STEP_WEIGHTS))
    vals = C.round_values(len(C.STEP_WEIGHTS), 1)
    with ds.mesh:
        want = np.asarray(step(JDC.sk_to_dist(sk, jdt.n1), jnp.asarray(vals),
                               jax.random.key(3)))
    got = D.from_dist_coeff(_round(ranks, "step", "col", False))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.max(np.abs(got - vals.astype(np.float64).mean(axis=0))) < 1e-3


@pytest.mark.parametrize("g_index", [0, 1, 2])
def test_dist_automorphism_matches_onchip(ranks, g_index):
    params = C.round_params()
    g = C.galois_elements(N)[g_index]
    rng = np.random.default_rng(2)
    x = rng.integers(0, min(params.moduli[:params.chain_len]),
                     size=(2, params.chain_len, N)).astype(np.int32)
    want = KS.automorphism(torch.as_tensor(x), N, g)
    got = _round(ranks, f"auto_{g}", "row")
    assert torch.equal(D.dist_to_eval(torch.as_tensor(got)), want)
