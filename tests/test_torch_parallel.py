"""The port's clients x chunks layer (fhe_fed_tpu_torch.parallel: mesh.py,
multihost.py) in 8 gloo ranks on the CPU, against the JAX package's
parallel/mesh.py and parallel/multihost.py on the 8 virtual devices of
tests/conftest.py, on the same seeded inputs (tests/_torch_dist_child.py):

- sharded_weighted_sum's int32 aggregate and full_fed_step's decoded f32
  are bit-equal to JAX's on meshes (2, 4), (2, 2) and (1, 2), and the
  step equals the port's single-device round on the same keys;
- 64 clients through the 16-bit split sum (as tests/test_parallel.py);
- the host feed (host_client_array) into the sharded sum, pod_mesh's axis
  inference, and init_distributed's single-process no-op.

The ranks run once, in a module fixture; the tests read their blocks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fhe_fed_tpu.ckks import params as JP, keys as JK, ops as JO
from fhe_fed_tpu.ckks import encoding as JE
from fhe_fed_tpu.parallel import mesh as JM, multihost as JMH
from fhe_fed_tpu_torch.ckks import params as P, keys as K, ops as O
from fhe_fed_tpu_torch.parallel import launch, multihost as MH
from fhe_fed_tpu_torch.utils import threefry

import _torch_dist_child as C

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ranks():
    return launch.spawn(C.parallel_suite, 8, device="cpu")


@pytest.fixture(scope="module")
def jax_side():
    p = JP.make_params(batch=128, scale_bits=40, mult_depth=1, ring_dim=256)
    ctx = JP.make_context(p)
    sk, pk = JK.keygen(ctx, seed=11)
    return p, ctx, sk, pk


@pytest.fixture(scope="module")
def port_side():
    ctx = P.make_context(C.fed_params(), CPU)
    sk, pk = K.keygen(ctx, 11)
    return ctx, sk, pk


def _jax_weights(p, k):
    chain = p.chain_len
    ds = float(p.moduli[chain - 1])
    res, sh = zip(*(JE.encode_scalar(p.moduli[:chain], w, ds)
                    for w in C.fed_weights(k)))
    return jnp.asarray(np.stack(res)), jnp.asarray(np.stack(sh))


def _over_chunks(ranks, mesh, name):
    """The whole (chunks, ...) result of a ('clients', 'chunks') job."""
    return C.assemble(((r[mesh]["coord"], r[mesh][name]) for r in ranks
                       if r[mesh]), {1: 0})


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("mesh", C.FED_MESHES)
def test_sharded_weighted_sum_matches_jax(ranks, jax_side, mesh):
    p, ctx, _, _ = jax_side
    stacked = jnp.asarray(C.fed_residues(p).astype(np.uint32))
    w_res, w_shoup = _jax_weights(p, C.FED_CLIENTS)
    jm = JM.make_fed_mesh(*mesh)
    want = np.asarray(JM.sharded_weighted_sum(ctx, jm)(
        jax.device_put(stacked, JM.ct_sharding(jm)), w_res, w_shoup))
    got = _over_chunks(ranks, mesh, "wsum")
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    local = np.asarray(JO._weighted_sum_impl(ctx, stacked, w_res, w_shoup))
    np.testing.assert_array_equal(got.astype(np.uint32), local)


@pytest.fixture(scope="module")
def jax_steps(jax_side):
    p, ctx, sk, pk = jax_side
    vals = jnp.asarray(C.fed_values(p))
    keys = jax.random.split(jax.random.key(7), C.FED_CLIENTS)
    w_res, w_shoup = _jax_weights(p, C.FED_CLIENTS)
    return {mesh: np.asarray(JM.full_fed_step(ctx, JM.make_fed_mesh(*mesh))(
        pk, vals, keys, w_res, w_shoup, sk)) for mesh in C.FED_MESHES}


@pytest.mark.parametrize("mesh", C.FED_MESHES)
def test_full_fed_step_matches_jax(ranks, jax_steps, mesh):
    got = _over_chunks(ranks, mesh, "step")
    np.testing.assert_array_equal(_bits(got), _bits(jax_steps[mesh]))


@pytest.mark.parametrize("mesh", C.FED_MESHES)
def test_full_fed_step_decrypts_the_average(ranks, jax_side, mesh):
    got = _over_chunks(ranks, mesh, "step").astype(np.float64)
    want = C.fed_values(jax_side[0]).astype(np.float64).mean(axis=0)
    assert np.max(np.abs(got - want)) < 1e-3


@pytest.mark.parametrize("mesh", C.FED_MESHES)
def test_full_fed_step_equals_the_single_device_round(ranks, port_side,
                                                      mesh):
    """Client k's key encrypts its whole (chunks, N) block in one call
    (ops.encrypt over the key batch), then weighted sum, rescale and
    decrypt on one device: the same bits as the sharded step."""
    ctx, sk, pk = port_side
    keys = threefry.split(threefry.key(7), C.FED_CLIENTS)
    ct = O.encrypt(ctx, pk, torch.as_tensor(C.fed_values(ctx.params)),
                   keys)
    agg = O.rescale(ctx, O.weighted_sum(ctx, ct,
                                        C.fed_weights(C.FED_CLIENTS)))
    want = O.decrypt(ctx, sk, O.Ciphertext(agg.data, ctx.params.scale,
                                           agg.level)).numpy()
    np.testing.assert_array_equal(_bits(_over_chunks(ranks, mesh, "step")),
                                  _bits(want))


@pytest.mark.parametrize("mesh", C.FED_MESHES)
def test_gather_chunks_gives_every_rank_the_whole_result(ranks, mesh):
    whole = _over_chunks(ranks, mesh, "step")
    for r in ranks:
        if r[mesh]:
            np.testing.assert_array_equal(r[mesh]["step_gathered"], whole)


def test_modsum_many_clients(ranks, jax_side):
    """64 clients, 32 a rank through the 16-bit split sum, then the
    all_reduce: JAX's weighted sum of the same ciphertexts, bit for bit,
    and the average within 2e-4."""
    p, ctx, sk, pk = jax_side
    data = C.fed_values(p, C.MANY_CLIENTS, 1, seed=3)
    cts = [JO.encrypt(ctx, pk, jnp.asarray(d), jax.random.key(i))
           for i, d in enumerate(data)]
    agg = JO.weighted_sum(ctx, cts, C.fed_weights(C.MANY_CLIENTS))
    for r in ranks:
        np.testing.assert_array_equal(r["many"].astype(np.uint32),
                                      np.asarray(agg.data))
    got = np.asarray(JO.decrypt(ctx, sk, agg))
    np.testing.assert_allclose(got, data.mean(axis=0), atol=2e-4)


def test_host_feed_and_sharded_round(ranks, jax_side):
    """Each rank's block of a stacked cohort through host_client_array
    into the sharded sum: JAX's single-device weighted sum, bit for bit."""
    p, ctx, _, _ = jax_side
    sk0, _ = JK.keygen(ctx, seed=0)
    vals = np.random.default_rng(0).standard_normal(
        (4, 2, ctx.ring_dim)).astype(np.float32)
    ct = JO.encrypt_symmetric_stacked(ctx, sk0, jnp.asarray(vals),
                                      jax.random.key(1))
    want = np.asarray(JO.weighted_sum(ctx, ct, C.fed_weights(4)).data)
    got = C.assemble(((r["feed_coord"], r["feed"]) for r in ranks), {1: 0})
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    for r in ranks:
        c = r["feed_coord"]
        assert tuple(r["feed_offsets"]) == (int(c[0]), int(c[1]), 0, 0, 0)


def test_pod_mesh_axis_inference(ranks):
    jm = JMH.pod_mesh({"clients": 2, "chunks": -1})
    for r in ranks:
        assert r["pod2"].shape == (2, 4) == jm.devices.shape
        assert r["pod2_names"] == ["clients", "chunks"] == list(
            jm.axis_names)
        # clients is the MAJOR axis: consecutive ranks differ along chunks
        np.testing.assert_array_equal(r["pod2"], np.arange(8).reshape(2, 4))
        assert r["pod3"].shape == (2, 2, 2)


@pytest.mark.parametrize("sizes,n,want", [
    ({"clients": 2, "chunks": -1}, 8, [2, 4]),
    ({"clients": -1, "limb": 2, "coeff": 2}, 8, [2, 2, 2]),
    ({"clients": 1, "chunks": 2}, 8, [1, 2]),
    ({"party": -1}, 1, [1])])
def test_mesh_shape(sizes, n, want):
    assert MH.mesh_shape(sizes, n) == want


@pytest.mark.parametrize("sizes,n", [
    ({"a": -1, "b": -1}, 8), ({"a": 3, "b": -1}, 8), ({"a": 4, "b": 4}, 8)])
def test_mesh_shape_refuses(sizes, n):
    with pytest.raises(ValueError):
        MH.mesh_shape(sizes, n)


def test_init_distributed_single_process_noop(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert MH.init_distributed(device="cpu") is False
    assert MH.init_distributed(world_size=1, device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_host_client_array_checks_the_block_shape():
    """Without a mesh the rank's block is the whole array; a block of
    another shape is refused."""
    spec = ("clients", "chunks", None)
    data = np.zeros((4, 2, 8), dtype=np.float32)
    shard = MH.host_client_array(None, (4, 2, 8), spec, data, "cpu")
    assert shard.offsets == (0, 0, 0) and shard.data.device == CPU
    with pytest.raises(ValueError):
        MH.host_client_array(None, (4, 4, 8), spec, data, "cpu")


def test_rank_bodies_import_no_jax():
    """Spawned ranks import tests/_torch_dist_child.py by name: it imports
    the port and nothing of the JAX package."""
    import ast
    import pathlib
    src = pathlib.Path(C.__file__).read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [] if node.level else [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "optax",
                                              "fhe_fed_tpu", "benchmarks")
