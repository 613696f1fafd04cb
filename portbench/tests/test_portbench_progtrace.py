"""The device trace put down to the program's spans (``progtrace.py``):
the reduction, its split and the records it reads, on synthetic records
of a 20 ms window; and ``TracedExecutor``, in place of the executor and
around the port's, on the CPU (no device trace there)."""
import numpy as np
import pytest

from portbench import devtrace, progtrace
from portbench.run import run_cell
from portbench.tests.smoke import smoke_cell
from repro_torch import spans
from repro_torch.serving.request import Request

US = 1_000  # ns
PROMPT_TOKENS = 500

# (name, start, end, parent), in us: one request
SPANS = [("prefill_request", 1000, 15000, -1),   # 0
         ("init_cache", 1050, 1100, 0),          # 1
         ("model", 1100, 12000, 0),              # 2
         ("attention", 1100, 6000, 2),           # 3
         ("adapter", 3000, 4000, 3),             # 4
         ("attention_core", 4000, 5000, 3),      # 5
         ("mlp", 6000, 9000, 2),                 # 6
         ("splice", 12000, 13000, 0),            # 7
         ("answer_sync", 13000, 15000, 0)]       # 8
HARNESS = [("inside prefill_request", 1000, 15000),
           ("waiting for an arrival", 15000, 18000)]
# correlation: (API call, its start; device record) in us
LAUNCHES = {1: ("cudaLaunchKernel", 1060, (1070, 1090)),      # init_cache
            2: ("cudaLaunchKernel", 3010, (3020, 3500)),      # adapter
            3: ("cudaLaunchKernel", 4010, (4020, 5800)),      # core
            10: ("cudaLaunchKernel", 4015, (5805, 5850)),     # core
            4: ("cudaLaunchKernel", 6010, (6100, 8000)),      # mlp
            11: ("cudaLaunchKernel", 6020, (8050, 8100)),     # mlp
            12: ("cudaLaunchKernel", 9500, (9600, 9700)),     # model
            5: ("cudaMemcpyAsync", 12010, (12020, 12030)),    # splice
            6: ("cudaMemcpyAsync", 13010, (13020, 13030)),    # answer
            8: ("cudaLaunchKernel", 500, (600, 605)),         # no span
            9: ("cudaLaunchKernel", 16000, (16005, 16010))}   # waiting


def _records():
    program = {"spans": [(n, s * US, e * US, p, 7)
                         for n, s, e, p in SPANS],
               "counters": {"prompt_tokens": PROMPT_TOKENS}}
    device = [(a * US, b * US, c) for c, (_, _, (a, b)) in LAUNCHES.items()]
    runtime = [(n, s * US, s * US + 5 * US, c)
               for c, (n, s, _) in LAUNCHES.items()]
    # a sync launches nothing; a second API call of one launch counts once
    runtime += [("cudaStreamSynchronize", 13015 * US, 13030 * US, 7),
                ("cuLaunchKernel", 4012 * US, 4013 * US, 3)]
    return program, device, runtime


def _table():
    program, device, runtime = _records()
    return progtrace.reduce(device, runtime, program, 0, 20000 * US,
                            [(n, s * US, e * US) for n, s, e in HARNESS])


def _idle(row):
    return {k: pytest.approx(v) for k, v in row["idle_ms"].items() if v}


def test_reduce_by_hand():
    t = _table()
    assert t["window_ms"] == pytest.approx(20.0)
    assert t["device_ms"] == pytest.approx(4.405)
    assert t["idle_ms"] == pytest.approx(15.595)
    assert t["launches"] == 11
    sp, out = t["spans"], t["outside"]
    # launches and device ms through the correlation ids
    assert {n: r["launches"] for n, r in sp.items()} == {
        "prefill_request": 0, "init_cache": 1, "model": 1, "attention": 0,
        "adapter": 1, "attention_core": 2, "mlp": 2, "splice": 1,
        "answer_sync": 1}
    assert sp["attention_core"]["device_ms"] == pytest.approx(1.825)
    assert sp["mlp"]["device_ms"] == pytest.approx(1.95)
    assert sp["adapter"]["device_ms"] == pytest.approx(0.48)
    assert sp["attention"]["device_ms"] == 0
    # idle to the innermost span open at the gap's start, by length
    assert _idle(sp["init_cache"]) == {"over 1 ms": 1.93}
    assert _idle(sp["adapter"]) == {"0.1-1 ms": 0.52}
    assert _idle(sp["attention"]) == {"under 10 us": 0.005,
                                      "0.1-1 ms": 0.25}
    assert _idle(sp["attention_core"]) == {}
    assert _idle(sp["mlp"]) == {"10-100 us": 0.05, "over 1 ms": 1.5}
    assert _idle(sp["model"]) == {"over 1 ms": 2.32}
    assert _idle(sp["splice"]) == {"0.1-1 ms": 0.99}
    assert _idle(sp["answer_sync"]) == {"over 1 ms": 2.975}
    assert _idle(sp["prefill_request"]) == {}
    # outside every program span: the harness's names, as summarize's
    assert set(out) == {"harness bookkeeping", "waiting for an arrival"}
    assert _idle(out["harness bookkeeping"]) == {"0.1-1 ms": 1.065}
    assert _idle(out["waiting for an arrival"]) == {"over 1 ms": 3.99}
    assert out["harness bookkeeping"]["launches"] == 1
    assert out["waiting for an arrival"]["device_ms"] == pytest.approx(
        0.005)
    # calls and host self time
    assert all(r["calls"] == 1 for r in sp.values())
    assert sp["prefill_request"]["host_self_ms"] == pytest.approx(0.05)
    assert sp["model"]["host_self_ms"] == pytest.approx(3.0)
    assert sp["attention"]["host_self_ms"] == pytest.approx(2.9)
    assert sum(r["host_self_ms"] for r in sp.values()) == pytest.approx(14)
    assert t["counters"] == {"prompt_tokens": PROMPT_TOKENS}


def test_idle_and_device_add_up_to_the_device_trace():
    t = _table()
    program, device, _ = _records()
    events = [("k", s, e) for s, e, _ in device]
    s = devtrace.summarize(events, 0, 20000 * US,
                           [(n, a * US, b * US) for n, a, b in HARNESS])
    rows = list(t["spans"].values()) + list(t["outside"].values())
    idle = sum(sum(r["idle_ms"].values()) for r in rows)
    assert idle == pytest.approx(t["idle_ms"])
    assert idle == pytest.approx(1e3 * (s["window_s"] - s["busy_s"]))
    assert sum(r["device_ms"] for r in rows) == pytest.approx(
        1e3 * (s["gemm_s"] + s["other_s"]))
    # outside program spans, the gaps fall where summarize puts them
    gaps = dict(s["idle_gaps"])
    assert gaps["harness bookkeeping, gaps 0.1-1 ms"] == pytest.approx(
        1e-3 * t["outside"]["harness bookkeeping"]["idle_ms"]["0.1-1 ms"])


def test_device_record_without_its_launch():
    program, device, runtime = _records()
    runtime = [r for r in runtime if r[3] != 4]
    t = progtrace.reduce(device, runtime, program, 0, 20000 * US, [])
    assert t["launches"] == 10
    assert t["outside"][progtrace.NO_LAUNCH]["device_ms"] == \
        pytest.approx(1.9)
    assert t["spans"]["mlp"]["device_ms"] == pytest.approx(0.05)


@pytest.mark.parametrize("points,want", [
    ([0, 10, 15, 25, 30, 45, 50, 99], [0, 1, 2, 1, 0, 3, -1, -1])])
def test_innermost_by_hand(points, want):
    # 0: [0, 50) holds 1: [10, 30) which holds 2: [15, 25); 3: [40, 50)
    iv = [(0, 50), (10, 30), (15, 25), (40, 50)]
    assert progtrace._innermost(iv, points) == want
    assert progtrace._innermost(iv, points[::-1]) == want[::-1]


SPLIT = {"launches_per_ktok": 22.0,
         "idle_ms_per_ktok": 31.19,
         "device_ms_per_ktok": 8.81,
         "idle_ms_per_ktok.attention": 0.51,
         "idle_ms_per_ktok.adapter": 1.04,
         "idle_ms_per_ktok.mlp": 3.1,
         "idle_ms_per_ktok.model": 4.64,
         "idle_ms_per_ktok.executor": 11.79,
         "idle_ms_per_ktok.outside": 10.11,
         "device_ms_per_ktok.attention_core": 3.65,
         "device_ms_per_ktok.adapter": 0.96}


def test_split_by_hand():
    got = progtrace.split(_table())
    assert got == {k: pytest.approx(v) for k, v in SPLIT.items()}
    idle = sum(v for k, v in got.items()
               if k.startswith("idle_ms_per_ktok."))
    assert idle == pytest.approx(got["idle_ms_per_ktok"])


def test_split_leaves_out_a_group_the_program_never_opened():
    """A MoE model opens no ``mlp`` span: its group is left out, and its
    idle goes to the span open around it (here ``model``)."""
    program, device, runtime = _records()
    program["spans"] = [s for s in program["spans"] if s[0] != "mlp"]
    t = progtrace.reduce(device, runtime, program, 0, 20000 * US, [])
    got = progtrace.split(t)
    assert "idle_ms_per_ktok.mlp" not in got
    assert got["idle_ms_per_ktok.model"] == pytest.approx(4.64 + 3.1)


class _Event:
    def __init__(self, name, device, start, dur, corr):
        self._v = (name, device, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_correlated_records_keep_api_calls_and_device_records():
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    raw = [_Event("Activity Buffer Request", cpu, 0, 5, 0),
           _Event("cudaLaunchKernel", cpu, 10, 4, 1320),
           _Event("Runtime Triggered Module Loading", cpu, 11, 2, 1320),
           _Event("Lazy Function Loading", cpu, 12, 1, 1320),
           _Event("void at::native::reduce_kernel", cuda, 20, 6, 1320),
           _Event("cuLaunchKernel", cpu, 30, 3, 1330),
           _Event("cudaStreamSynchronize", cpu, 40, 9, 1334)]
    device, runtime = progtrace.correlated_records(raw)
    assert device == [(20, 26, 1320)]
    assert runtime == [("cudaLaunchKernel", 10, 14, 1320),
                       ("cuLaunchKernel", 30, 33, 1330),
                       ("cudaStreamSynchronize", 40, 49, 1334)]
    assert devtrace.device_events(raw) == [
        ("void at::native::reduce_kernel", 20, 26)]


class _Executor:
    """An executor's surface, whose prefill opens the program's root span
    and counts its tokens as the port's does (``count`` as given)."""

    def __init__(self, count=None):
        self.count = count
        self.slot_req, self.slot_tokens = [None] * 4, [0] * 4

    def prefill_request(self, req, prompt):
        with spans.span("prefill_request", rid=req.rid):
            spans.count("prompt_tokens", self.count or len(prompt))
            with spans.span("model"):
                slot = self.slot_req.index(None)
                self.slot_req[slot] = req.rid
                self.slot_tokens[slot] = 7

    def release(self, rid):
        self.slot_req[self.slot_req.index(rid)] = None

    def export_slot(self, rid):
        return {"rid": rid}


def _drive(ex, lengths):
    """Two warm-up requests, then one a length, then two slots read."""
    for k in (1, 2):
        ex.prefill_request(Request(rid=-k, adapter_id=0, prompt_len=3,
                                   max_new_tokens=1), np.zeros(3))
        ex.release(-k)
    for i, n in enumerate(lengths):
        ex.prefill_request(Request(rid=i, adapter_id=0, prompt_len=n,
                                   max_new_tokens=1), np.zeros(n))
        assert ex.slot_tokens[ex.slot_req.index(i)] == 7
        if i:
            ex.release(i)
    return [ex.export_slot(0), ex.export_slot(0)]


def test_traced_executor_records_the_window_alone():
    sink = []
    ex = progtrace.TracedExecutor(_Executor(), sink, device_trace=False)
    assert _drive(ex, [5, 6, 7]) == [{"rid": 0}] * 2
    (t,) = sink
    assert t["counters"] == {"prompt_tokens": 18}
    assert t["spans"]["prefill_request"]["calls"] == 3
    assert t["spans"]["model"]["calls"] == 3
    assert [h[0] for h in ex.harness] == [progtrace.HARNESS_SPAN] * 3
    assert t["window_ms"] == pytest.approx(
        1e-6 * (ex.harness[-1][2] - ex.harness[0][1]))
    # the recorder is off again, and nothing after the window is recorded
    assert spans.take() is None
    ex.prefill_request(Request(rid=9, adapter_id=0, prompt_len=2,
                               max_new_tokens=1), np.zeros(2))
    assert len(sink) == 1 and spans.take() is None


def test_traced_executor_checks_the_token_count():
    ex = progtrace.TracedExecutor(_Executor(count=4), [], False)
    with pytest.raises(RuntimeError, match="prompt tokens"):
        _drive(ex, [5, 6])


def test_traced_run_at_smoke_size():
    """A whole run of the dense smoke cell on the CPU, the port's executor
    under ``TracedExecutor``: the comparison still passes, and the table
    holds every span of the prefill path, one root a request."""
    sink = []
    res = run_cell(smoke_cell("dense"), 2**31 + 5, 0.4, False, "cpu",
                   t_start=0.0,
                   executor=progtrace.traced_executor(sink))
    assert res["correct"], res["checks"]
    (t,) = sink
    assert set(t["spans"]) == {"prefill_request", "init_cache", "model",
                               "attention", "attention_core", "adapter",
                               "mlp", "splice", "answer_sync"}
    assert t["spans"]["prefill_request"]["calls"] == res["attempted"]
    layers = smoke_cell("dense").config["num_hidden_layers"]
    calls = t["spans"]["prefill_request"]["calls"]
    assert t["spans"]["attention"]["calls"] == layers * calls
    assert t["spans"]["adapter"]["calls"] == 4 * layers * calls
    got = progtrace.split(t)
    assert got["launches_per_ktok"] == 0
    assert got["idle_ms_per_ktok"] == pytest.approx(sum(
        v for k, v in got.items() if k.startswith("idle_ms_per_ktok.")))
