"""The device trace's reduction and the metric readers, on a synthetic
record of a window."""
import pytest

from portbench import devtrace, spec

MS = 1_000_000  # ns


def _events():
    # a 10 ms window: a GEMM 0-3 ms, softmax 2-4 ms (overlapping), a copy
    # 6-7 ms, and a kernel that straddles the window's end (9-12 ms)
    return [("ampere_bf16_s16816gemm_relu", 0, 3 * MS),
            ("softmax_warp_forward", 2 * MS, 4 * MS),
            ("Memcpy DtoH (Device -> Pageable)", 6 * MS, 7 * MS),
            ("elementwise_kernel", 9 * MS, 12 * MS)]


def test_summarize_by_hand():
    spans = [("inside prefill_request", 0, 5 * MS),
             ("waiting for an arrival", 5 * MS, 8 * MS)]
    s = devtrace.summarize(_events(), 0, 10 * MS, spans)
    assert s["window_s"] == pytest.approx(0.010)
    # busy: 0-4, 6-7, 9-10
    assert s["busy_s"] == pytest.approx(0.006)
    assert s["gemm_s"] == pytest.approx(0.003)
    assert s["other_s"] == pytest.approx(0.002 + 0.001 + 0.001)
    gaps = dict(s["idle_gaps"])
    # 4-6 ms starts in prefill_request, 7-9 ms in the wait
    assert gaps["inside prefill_request, gaps over 1 ms"] == \
        pytest.approx(0.002)
    assert gaps["waiting for an arrival, gaps over 1 ms"] == \
        pytest.approx(0.002)
    assert s["device_ops"][0][0].startswith("ampere_bf16")


def test_gap_outside_spans_is_bookkeeping():
    s = devtrace.summarize([("k", 0, MS)], 0, 2 * MS, [])
    assert dict(s["idle_gaps"]) == {
        "harness bookkeeping, gaps over 1 ms": pytest.approx(0.001)}


def test_empty_window_reads_nothing():
    assert devtrace.summarize(_events(), 20 * MS, 30 * MS, []) is None


@pytest.mark.parametrize("name,gemm", [
    ("sm90_xmma_gemm_bf16bf16_bf16f32", True), ("nvjet_hsh_128x256", True),
    ("cutlass_80_tensorop_s1688gemm", True),
    ("void at::native::vectorized_elementwise_kernel", False),
    ("Memset (Device)", False)])
def test_gemm_words(name, gemm):
    assert devtrace.is_gemm(name) is gemm


def _rec(trace=True):
    reqs = [{"due": 0.0, "start": 0.0, "end": 0.1, "tokens": 1000,
             "flops": 1e12},
            {"due": 0.0, "start": 0.1, "end": 0.3, "tokens": 3000,
             "flops": 5e12}]
    tr = {"window_s": 0.4, "busy_s": 0.3, "gemm_s": 0.2, "other_s": 0.08}
    return {"setup_s": 12.5, "window_s": 0.4, "requests": reqs,
            "trace": tr if trace else None, "peak_flops": 1e15}


def _read(name, rec):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py").read(rec)


def test_readers_by_hand():
    rec = _rec()
    assert _read("prefill_tokens_per_s", rec) == pytest.approx(4000 / 0.4)
    assert _read("setup_s", rec) == 12.5
    assert _read("service_ms_per_ktok.backlog", rec) == pytest.approx(
        300.0 / 4.0)
    assert _read("gemm_device_ms_per_ktok", rec) == pytest.approx(50.0)
    assert _read("other_device_ms_per_ktok", rec) == pytest.approx(20.0)
    assert _read("idle_share", rec) == pytest.approx(25.0)
    assert _read("prefill_mfu", rec) == pytest.approx(100 * 6e12 / 4e14)


def test_readers_count_only_answered_requests():
    rec = _rec()
    rec["requests"].append({"due": 0.0, "start": None, "end": None,
                            "tokens": 500, "flops": 1e11})
    assert _read("prefill_tokens_per_s", rec) == pytest.approx(4000 / 0.4)
    assert _read("gemm_device_ms_per_ktok", rec) == pytest.approx(50.0)


def test_device_readers_need_a_trace():
    rec = _rec(trace=False)
    for name in ("gemm_device_ms_per_ktok", "other_device_ms_per_ktok",
                 "idle_share", "prefill_mfu"):
        assert _read(name, rec) is None


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    files = {p.name[:-3] for p in (spec.HERE / "metrics").glob("*.py")}
    assert names == files
