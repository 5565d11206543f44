"""Each metric reader against a synthetic span list and profiler trace."""

import pytest

from fedbench import run, spec, trace as tr


def _reading(surface="cohort", spans=None, trace=None):
    config = spec.cell("cnn1.66m.cohort").config
    return run.Reading(config, {"surface": surface}, 12.5, 40.0, 2000,
                       [float(v) for v in range(100, 0, -1)], spans or {},
                       trace)


def _trace():
    """A window of 1000 us, 2 rounds: K1 100 us, Philox 40 us, a torch
    kernel 200 us (overlapping K1 by 50 us), copies 30 + 20 us, and a
    memset of 10 us outside the window."""
    ev = tr.Event
    device = [
        ev("ntt_wg_kernel(CUtensorMap_st, CUtensorMap_st, int*)", "kernel",
           100, 60),
        ev("void ntt_mxu_kernel<4>(int*, int const*)", "kernel", 400, 40),
        ev("philox_kernel(void*, long const*, long const*, Params)",
           "kernel", 500, 40),
        ev("void at::native::vectorized_elementwise_kernel<4, "
           "at::native::BinaryFunctor<long, long, long>>(int, long)",
           "kernel", 110, 200),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 600, 30),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 700, 20),
        ev("Memset (Device)", "gpu_memset", 2000, 10),
    ]
    host = [ev(tr.WINDOW, "user_annotation", 0, 1000),
            ev("fedbench.encrypt_cohort", "user_annotation", 0, 550),
            ev("aten::remainder", "cpu_op", 320, 60),
            ev("cudaLaunchKernel", "cuda_runtime", 330, 10)]
    t = tr.Trace(device, sorted(host, key=lambda e: (e.ts, -e.dur)),
                 (0.0, 1000.0), 2,
                 frozenset({"ntt_wg_kernel", "ntt_mxu_kernel",
                            "philox_kernel"}))
    return t


def read(name, reading):
    return spec.load_reader(name)(reading)


def test_end_to_end_readers():
    r = _reading()
    assert read("setup_s", r) == 12.5
    assert read("round_ms", r) == pytest.approx(20.0)
    assert read("round_p95_ms", r) == pytest.approx(95.05)
    assert read("round_p95_ms", run.Reading(r.config, r.traffic, 1, 1, 2,
                                            [1.0, 2.0], {})) is None


@pytest.mark.parametrize("name,span", [
    ("encrypt_ms.cohort", "encrypt_cohort"),
    ("aggregate_ms.cohort", "aggregate_cohort"),
    ("decrypt_ms.cohort", "decrypt_cohort"),
    ("client_encrypt_ms.bytes", "encrypt"),
    ("server_aggregate_ms.bytes", "computeWeightedAverage"),
])
def test_span_readers(name, span):
    assert read(name, _reading(spans={span: [1.0, 2.0, 6.0]})) == 3.0
    assert read(name, _reading(spans={"other": [1.0]})) is None


def test_trace_readers():
    r = _reading(trace=_trace())
    assert read("glue_ms.cohort", r) == pytest.approx(0.2 / 2)
    assert read("copy_ms.streamed", r) == pytest.approx(0.05 / 2)
    # Busy: [100, 310), [400, 440), [500, 540), [600, 630), [700, 720).
    assert tr.busy_s(r.trace) == pytest.approx(340e-6)
    assert read("idle_share", r) == pytest.approx(66.0)
    k1 = spec.load_reader("ntt_roofline")
    round_bytes = k1.__globals__["round_bytes"]
    want = 100 * round_bytes(r.config) / 3.35e12 / (100e-6 / 2)
    assert k1(r) == pytest.approx(want)
    ph = spec.load_reader("philox_roofline")
    philox_bytes = ph.__globals__["round_bytes"]
    assert philox_bytes(r.config) == 4 * 3 * 204 * 8192 * 5
    assert round_bytes(r.config) == 2 * 4 * 4 * 8192 * (3 + 1) * 204
    assert ph(r) == pytest.approx(
        100 * philox_bytes(r.config) / 3.35e12 / (40e-6 / 2))


def test_rooflines_count_the_work_from_the_configuration():
    """Chunks follow the packing, polynomials the encryption mode: a
    public-key round at 4096 values a chunk (407 chunks) needs three
    forward transforms a client and chunk, and draws u, e0 and e1."""
    import copy
    config = copy.deepcopy(spec.cell("cnn1.66m.cohort").config)
    config["crypto"].update(symmetric=False, dense_pack=False)
    ntt = spec.load_reader("ntt_roofline").__globals__["round_bytes"]
    philox = spec.load_reader("philox_roofline").__globals__["round_bytes"]
    assert ntt(config) == 2 * 4 * 4 * 8192 * (3 * 3 + 1) * 407
    assert philox(config) == 4 * 3 * 407 * 8192 * 3


def test_readers_return_nothing_without_their_source():
    t = _trace()
    t.device = [e for e in t.device if "philox" not in e.name
                and "ntt" not in e.name]
    r = _reading(surface="bytes", trace=t)
    assert read("ntt_roofline", r) is None
    assert read("philox_roofline", r) is None
    for name in ("glue_ms.cohort", "copy_ms.streamed", "idle_share",
                 "ntt_roofline", "philox_roofline"):
        assert read(name, _reading()) is None


def test_breakdown_and_kernel_names():
    t = _trace()
    b = tr.breakdown(t)
    assert b["device_ops"][0][0].startswith("void at::native::vectorized")
    assert b["device_ops"][0][1] == pytest.approx(200e-6)
    gaps = dict(b["idle_gaps"])
    assert gaps["encrypt_cohort / aten::remainder"] == pytest.approx(90e-6)
    assert gaps["encrypt_cohort / python"] == pytest.approx(160e-6)
    assert gaps["between calls / python"] == pytest.approx(410e-6)
    assert len(b["idle_gaps"]) <= tr.TOP
    assert tr.kernel_id(t.device[0].name) == "ntt_wg_kernel"
    assert tr.kernel_id(t.device[3].name) == "vectorized_elementwise_kernel"


def test_library_kernels_of_the_program():
    import fhe_fed_tpu_torch
    csrc = spec.ROOT / "fhe_fed_tpu_torch" / "csrc"
    assert fhe_fed_tpu_torch.__file__
    names = tr.library_kernels(csrc)
    assert {"ntt_wg_kernel", "ntt_mxu_kernel", "philox_kernel",
            "weighted_sum_kernel", "decode_kernel",
            "ntt_butterfly_kernel"} <= names


def test_parse_a_chrome_trace():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": tr.WINDOW, "ts": 5,
         "dur": 100, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 6, "dur": 3,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 4,
         "pid": 0, "tid": 7},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1},
    ]}
    t = tr.parse(doc, 3)
    assert t.window == (5.0, 100.0) and t.rounds == 3
    assert [e.name for e in t.device] == ["k"]
    assert [e.name for e in t.host] == [tr.WINDOW, "aten::add"]
    with pytest.raises(ValueError):
        tr.parse({"traceEvents": []}, 1)
