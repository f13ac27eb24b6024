"""The readers of the port's spans and counters (``benchmark/spans.py``) on
a hand-written Chrome trace: one 64-date chunk of a backtest with nested
``psmc.*`` annotations, the runtime calls that launch each device
operation, and the operations with their CUPTI correlation ids. Every
number below is worked out by hand from the event list, in its units
(:data:`SCALE` microseconds)."""
import pytest

from benchmark import spans, trace
from benchmark.harness import _load

#: microseconds per unit of the lists below
SCALE = 10.0
#: (name, start_us, end_us) of each span
SPANS = [
    ("psmc.backtest", 0, 1000), ("psmc.predict", 10, 990),
    ("psmc.chunk", 20, 900), ("psmc.plan", 20, 100), ("psmc.budget", 30, 80),
    ("psmc.prep", 100, 120), ("psmc.pass1", 120, 140),
    ("psmc.pass2.select", 140, 200), ("psmc.pass2.rescore", 200, 260),
    ("psmc.pass2.final", 260, 300), ("psmc.redo", 300, 400),
    ("psmc.finalize", 400, 500), ("psmc.aggregate", 500, 560),
    ("psmc.ar_linear", 992, 999),
]
#: (runtime call, host start_us, device op, category, start_us, dur_us)
LAUNCHED = [
    ("cudaLaunchKernel", 105, "embed_kernel", "kernel", 106, 10),
    ("cuLaunchKernel", 125, "void blockmin_factored_kernel<64>", "kernel",
     130, 200),
    ("cudaLaunchKernel", 150, "topk_kernel", "kernel", 330, 20),
    ("cudaMemcpyAsync", 160, "Memcpy DtoD", "gpu_memcpy", 350, 5),
    ("cudaLaunchKernel", 210, "addcmul_kernel", "kernel", 355, 100),
    ("cudaLaunchKernel", 270, "topk_final_kernel", "kernel", 455, 20),
    ("cudaLaunchKernel", 310, "nonzero_kernel", "kernel", 475, 5),
    ("cudaMemcpyAsync", 312, "Memcpy DtoH", "gpu_memcpy", 480, 2),
    ("cudaLaunchKernel", 410, "gather_kernel", "kernel", 490, 40),
    ("cudaMemsetAsync", 420, "Memset (Device)", "gpu_memset", 530, 1),
    ("cudaLaunchKernel", 510, "reduce_kernel", "kernel", 531, 10),
    ("cudaMemcpyAsync", 570, "Memcpy DtoH", "gpu_memcpy", 571, 2),
]
#: runtime calls that launch nothing, and host operations
OTHER = [("cuda_runtime", "cudaMemGetInfo", 40, 30),
         ("cuda_runtime", "cudaStreamSynchronize", 315, 167),
         ("cpu_op", "aten::mul", 205, 10)]


def _event(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": SCALE * ts,
            "dur": SCALE * dur, "args": args}


def chrome_trace(with_spans=True) -> dict:
    ev = [_event(n, "user_annotation", s, e - s) for n, s, e in SPANS
          if with_spans]
    for i, (call, t, name, cat, s, d) in enumerate(LAUNCHED):
        # a cuLaunchKernel call lands in a category trace.parse drops
        if call != "cuLaunchKernel":
            ev.append(_event(call, "cuda_runtime", t, 2, correlation=100 + i))
        ev.append(_event(name, cat, s, d, correlation=100 + i))
        if with_spans:       # the device-side copy of the annotation
            ev.append(_event("psmc.chunk", "gpu_user_annotation", s, d))
    ev += [_event(n, cat, t, d) for cat, n, t, d in OTHER]
    ev.append({"ph": "i", "name": "marker", "ts": 1})
    return {"traceEvents": ev[::-1]}


def reading(with_spans=True, unit="chunk") -> trace.Reading:
    ops, host = trace.parse(chrome_trace(with_spans))
    return trace.Reading(ops=ops, host=host, window_s=1e-2, units=1,
                         unit=unit, untraced_s_per_unit=2e-2,
                         pass1_bytes=3.35e12 * 1e-3, pass1_flops=0.0,
                         latencies_s=[1e-3, 2e-3, 3e-3])


NEW = ("rescore_device_ms", "select_device_ms", "finalize_device_ms",
       "budget_idle_ms", "certified_pct")


def test_order_pairing_matches_the_correlation_ids():
    """Every operation launched through the runtime pairs with the launch
    its correlation id names. The kernel launched with ``cuLaunchKernel``
    (whose category ``trace.parse`` drops) starts before the next launch
    left to pair: it takes its own start as the bound on its launch, in
    ``psmc.pass1``, and leaves that launch to the next kernel."""
    by_id = {}
    for e in chrome_trace()["traceEvents"]:
        if e.get("cat") == "cuda_runtime" and "correlation" in e["args"]:
            by_id[e["args"]["correlation"]] = e["ts"]
    want = {(e["name"], e["ts"]):
            by_id.get(e["args"]["correlation"], e["ts"])
            for e in chrome_trace()["traceEvents"]
            if e.get("cat") in trace.DEVICE_CATS}
    got = {(op[0], op[2]): t for op, t in spans.launch_times(reading())}
    k2 = ("void blockmin_factored_kernel<64>", 130 * SCALE)
    assert got == want and got[k2] == k2[1]
    charged = dict(((op[0], op[2]), n) for op, n in spans.attribute(reading()))
    assert charged[k2] == "psmc.pass1"


def test_device_time_by_innermost_span():
    by = spans.device_s_by_span(reading())
    want = {"psmc.prep": 10, "psmc.pass1": 200, "psmc.pass2.select": 25,
            "psmc.pass2.rescore": 100, "psmc.pass2.final": 20,
            "psmc.redo": 7, "psmc.finalize": 41, "psmc.aggregate": 10,
            "psmc.chunk": 2}
    assert by == pytest.approx({k: v * SCALE * 1e-6
                                for k, v in want.items()})
    r = reading()
    # everything but pass 1 is what after_pass1_device_ms reads
    rest = sum(v for k, v in by.items() if k != "psmc.pass1")
    assert rest == pytest.approx(r.busy_s - r.kernel_seconds(trace.PASS1))


def test_idle_time_by_innermost_span():
    by = spans.idle_s_by_span(reading())
    want = {"psmc.backtest": 13, "psmc.predict": 100, "psmc.chunk": 338,
            "psmc.plan": 30, "psmc.budget": 50, "psmc.prep": 10,
            "psmc.pass1": 10, "psmc.finalize": 8, "psmc.aggregate": 19,
            "psmc.ar_linear": 7}
    assert by == pytest.approx({k: v * SCALE * 1e-6
                                for k, v in want.items()})
    assert sum(by.values()) == pytest.approx(SCALE * 1e-3 - reading().busy_s)


@pytest.mark.parametrize("name, value", [
    ("rescore_device_ms", 0.100), ("select_device_ms", 0.045),
    ("finalize_device_ms", 0.051), ("budget_idle_ms", 0.050)])
def test_span_readers(name, value):
    value *= SCALE
    r = reading()
    read = _load("metrics", f"{name}.backtest").read
    assert read(r) == pytest.approx(value)
    assert _load("metrics", f"{name}.query").read(r) is None
    r.units = 4
    assert read(r) == pytest.approx(value / 4)
    q = reading(unit="query")
    assert _load("metrics", f"{name}.query").read(q) == pytest.approx(value)


def test_certified_share_reads_the_port_counters(monkeypatch):
    monkeypatch.setattr(spans, "program_counters",
                        lambda: {"contexts": 64, "certified": 60,
                                 "redo_tier1": 4})
    assert _load("metrics", "certified_pct.backtest").read(reading()) == \
        pytest.approx(93.75)
    assert _load("metrics", "certified_pct.query").read(reading()) is None


def test_certified_share_from_the_store_itself():
    from shadowing_tpu_torch.utils import profiling

    saved = profiling.counters()
    try:
        profiling.reset_counters()
        profiling.count("contexts", 8)
        profiling.count("certified", 8)
        assert spans.certified_pct(reading(), "chunk") == 100.0
    finally:
        profiling.reset_counters()
        for k, v in saved.items():
            profiling.count(k, v)


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("suffix", ["backtest", "query"])
def test_new_readers_read_nothing_without_the_ports_instrumentation(
        monkeypatch, name, suffix):
    monkeypatch.setattr(spans, "program_counters", lambda: None)
    r = reading(with_spans=False,
                unit="chunk" if suffix == "backtest" else "query")
    assert _load("metrics", f"{name}.{suffix}").read(r) is None


def test_existing_readers_and_breakdown_on_the_fixture():
    """The readers that were there before the spans read the trace as they
    did: the annotations add host events and no device operation."""
    for with_spans in (True, False):
        r = reading(with_spans)
        assert r.busy_s == pytest.approx(SCALE * 415e-6)
        assert _load("metrics", "pass1_roofline.backtest").read(r) == \
            pytest.approx(50.0)
        assert _load("metrics", "after_pass1_device_ms.backtest").read(r) == \
            pytest.approx(SCALE * 0.215)
        assert _load("metrics", "launches.backtest").read(r) == 8
        assert _load("metrics", "device_idle_pct.backtest").read(r) == \
            pytest.approx(79.25)
        for name in ("pass1_roofline.query", "after_pass1_device_ms.query",
                     "launches.query", "device_idle_pct.query",
                     "tail_p95_ms.query"):
            assert _load("metrics", name).read(r) is None
        q = reading(with_spans, unit="query")
        assert _load("metrics", "tail_p95_ms.query").read(q) == \
            pytest.approx(2.9)
    b = trace.breakdown(reading())
    assert b["device_ops"][0] == ["void blockmin_factored_kernel<64>",
                                  pytest.approx(SCALE * 200e-6)]
    # each gap is named after the innermost host event over its midpoint:
    # with the spans, the span the host was in
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"psmc.aggregate": SCALE * 30e-6, "psmc.pass1": SCALE * 14e-6,
         "psmc.finalize": SCALE * 8e-6})
    b0 = trace.breakdown(reading(with_spans=False))
    assert dict(b0["idle_gaps"]) == pytest.approx(
        {"(python)": SCALE * 52e-6})


def test_device_clock_drift_is_taken_out():
    """A trace whose device clock falls behind the host's by 0.5 % (seen
    on the card): 200 chunks, each a copy launched while the card waits
    (it starts 5 us after its launch) and one launched while it is busy.
    The copies' envelope moves the device's starts back onto the host's
    clock, and the budget span's idle time reads as without the drift."""
    ev = []
    for i in range(200):
        t0 = 1000.0 * i
        ev.append({"ph": "X", "cat": "user_annotation", "name": "psmc.chunk",
                   "ts": t0, "dur": 900.0})
        ev.append({"ph": "X", "cat": "user_annotation", "name": "psmc.budget",
                   "ts": t0 + 10, "dur": 40.0})
        for launch, start, dur in ((t0 + 100, t0 + 105, 300.0),
                                   (t0 + 200, t0 + 405, 100.0)):
            drift = -0.005 * start
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaMemcpyAsync", "ts": launch, "dur": 2.0})
            ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
                       "ts": start + drift, "dur": dur})
    ops, host = trace.parse({"traceEvents": ev})
    r = trace.Reading(ops=ops, host=host, window_s=0.2, units=200,
                      unit="chunk", untraced_s_per_unit=1e-3)
    starts = [op[2] for op in spans.host_ops(r)]
    want = sorted(1000.0 * i + d for i in range(200) for d in (105, 405))
    # the 5 us from launch to start while the card waits is what the
    # envelope cannot see: the starts land on their launches
    assert max(abs(a - b) for a, b in zip(starts, want)) < 5.0 + 1e-6
    assert spans.idle_ms(r, "chunk", "psmc.budget") == pytest.approx(0.040)
    assert all(t <= s + 1e-6 for (_, _, s, _), t in spans.launch_times(r))
