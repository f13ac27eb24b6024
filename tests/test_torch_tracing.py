"""The port's own instrumentation (``utils/profiling.py``): the ``psmc.*``
spans a public call opens under ``torch.profiler``, their nesting, their
cost with no profiler (none: no ``record_function`` is entered), and the
counter store — contexts certified at once or redone, memory-budget
queries, builds and evictions of the factored ``E``, kernel launches
(CPU; the kernels' plain versions)."""
import json

import numpy as np
import pytest
import torch

import shadowing_tpu_torch as P
from shadowing_tpu_torch.ops import search as search_ops
from shadowing_tpu_torch.ops._build import Kernel
from shadowing_tpu_torch.utils import profiling

W, H = 24, 16
TS = [4, 8]
#: the spans each search of the kernel route opens
SEARCH = ("psmc.plan", "psmc.budget", "psmc.prep", "psmc.pass1",
          "psmc.pass2.select", "psmc.pass2.rescore", "psmc.pass2.final",
          "psmc.redo", "psmc.finalize")


@pytest.fixture(scope="module")
def data():
    """48 trajectories, 16 contexts cut from them, and a series to
    backtest."""
    rng = np.random.default_rng(7)
    ds = rng.normal(0, 0.02, size=(48, 1, 300)).astype(np.float32)
    starts = rng.integers(0, 200, size=16)
    ctx = np.stack([ds[(3 * i) % 48, :, s : s + W]
                    for i, s in enumerate(starts)])
    series = rng.normal(0, 0.01, size=80).astype(np.float32)
    return ds, ctx, series


def engine(ds):
    return P.PathShadowing(P.Identity(W), P.RelativeMSE(), ds,
                           P.PredictionContext(H), device="cpu")


def to_predict(x):
    return P.realized_variance(x[:, :, 0, :], Ts=TS)


def delta(before: dict) -> dict:
    after = profiling.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def psmc_spans(path) -> list:
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation"
            and e["name"].startswith("psmc.")]


def inside(child, parent, slack=1e-3) -> bool:
    return parent[1] - slack <= child[1] and child[2] <= parent[2] + slack


def test_predict_under_the_profiler_emits_nested_spans(data, tmp_path):
    """Two chunks of 8 contexts (the factored route): each search's spans
    sit inside its ``psmc.chunk``, both chunks inside ``psmc.predict``; the
    window norms and ``E`` are computed once, inside the first chunk."""
    ds, ctx, _ = data
    want = engine(ds).predict(ctx, k=8, to_predict=to_predict, eta=0.1,
                              n_context_splits=2, method="kernel")
    eng = engine(ds)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = eng.predict(ctx, k=8, to_predict=to_predict, eta=0.1,
                          n_context_splits=2, method="kernel")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = psmc_spans(tmp_path / "trace.json")
    names = [s[0] for s in spans]
    roots = [s for s in spans if s[0] == "psmc.predict"]
    chunks = sorted(s for s in spans if s[0] == "psmc.chunk")
    assert len(roots) == 1 and len(chunks) == 2
    assert all(inside(c, roots[0]) for c in chunks)
    for name in SEARCH + ("psmc.aggregate",):
        found = [s for s in spans if s[0] == name]
        assert len(found) >= 2, name
        assert all(any(inside(s, c) for c in chunks) for s in found), name
    for name in ("psmc.norms", "psmc.build_e"):
        (once,) = [s for s in spans if s[0] == name]
        assert inside(once, chunks[0]), name
    # pass 2's parts follow pass 1 in order inside each chunk
    for c in chunks:
        mine = [s[0] for s in sorted(spans, key=lambda s: s[1])
                if inside(s, c) and s[0] in SEARCH[3:7]]
        assert mine == list(SEARCH[3:7])
    assert names.count("psmc.budget") >= 2


def test_predict_and_smile_opens_the_smile_phases_and_counts(data, tmp_path):
    """Inside ``psmc.smile``, after the engine's weights and price paths:
    ``psmc.smile.knots`` (sigma_T, strikes and knots of every maturity),
    ``psmc.smile.regress`` and ``psmc.smile.vols``, in that order, each
    around a whole phase. ``smile_contexts`` counts the contexts priced,
    ``smile_solves`` the normal-equation systems: T per maturity and
    context (T - 1 steps back, then the last on ``(1, dS_0)``)."""
    ds, ctx, _ = data
    eng = engine(ds)
    before = profiling.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.predict_and_smile(ctx[:3], k=16, to_predict=to_predict, Ts=TS,
                              Ms=[-1.0, 0.0, 1.0], eta=0.1, eta_smile=0.5)
    got = delta(before)
    assert got["smile_contexts"] == 3
    assert got["smile_solves"] == 3 * sum(TS)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = psmc_spans(tmp_path / "trace.json")
    (smile,) = [sp for sp in spans if sp[0] == "psmc.smile"]
    phases = sorted((sp for sp in spans if sp[0].startswith("psmc.smile.")),
                    key=lambda sp: sp[1])
    assert [sp[0] for sp in phases] == [
        "psmc.smile.knots", "psmc.smile.regress", "psmc.smile.vols"]
    assert all(inside(sp, smile) for sp in phases)


def test_rolling_backtest_opens_its_root_and_ar_linear(data, tmp_path):
    ds, _, series = data
    eng = engine(ds)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        P.rolling_backtest(eng, series, w=W, Ts=TS, k=8,
                           benchmark="ar-linear")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = psmc_spans(tmp_path / "trace.json")
    (root,) = [s for s in spans if s[0] == "psmc.backtest"]
    (pred,) = [s for s in spans if s[0] == "psmc.predict"]
    (ar,) = [s for s in spans if s[0] == "psmc.ar_linear"]
    assert inside(pred, root) and inside(ar, root) and ar[1] >= pred[2]


def test_no_profiler_enters_no_record_function(data, monkeypatch):
    """With no profiler the spans do nothing but check for one: a
    ``record_function`` that raises is never reached, the arrays are the
    same, and the counters still count."""
    ds, ctx, series = data
    want = engine(ds).predict(ctx[:4], k=8, to_predict=to_predict, eta=0.1)
    want_bt = P.rolling_backtest(engine(ds), series, w=W, Ts=TS, k=8)

    def entered(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", entered)
    before = profiling.counters()
    got = engine(ds).predict(ctx[:4], k=8, to_predict=to_predict, eta=0.1)
    got_bt = P.rolling_backtest(engine(ds), series, w=W, Ts=TS, k=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_bt.predicted, want_bt.predicted)
    np.testing.assert_array_equal(got_bt.predicted_std, want_bt.predicted_std)
    d = delta(before)
    assert d["searches"] == 2 and d["contexts"] == 4 + len(got_bt.predicted)
    assert d["certified"] == d["contexts"] and d["budget_queries"] >= 2


def test_the_gate_follows_the_profiler():
    assert profiling.profiler_enabled() is False
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.profiler_enabled() is True
        assert isinstance(profiling.span("psmc.test"),
                          torch.profiler.record_function)
    assert profiling.profiler_enabled() is False
    assert profiling.span("psmc.test") is profiling.span("psmc.other")


@pytest.mark.parametrize("method, cripple, tier", [
    ("kernel", False, "redo_tier1"),   # the escalated cap certifies
    ("kernel", True, "redo_tier2"),    # the retry fails too: the oracle
    ("fused", False, "redo_tier2"),    # the fused route's redo is the oracle
])
def test_counters_add_up_on_a_forced_redo(data, monkeypatch, method, cripple,
                                          tier):
    ds, ctx, _ = data
    eng = engine(ds)
    if cripple:
        orig = search_ops.two_pass_search
        monkeypatch.setattr(search_ops, "two_pass_search",
                            lambda y, n, g, k, cap=None: orig(y, n, g, k, 1))
    before = profiling.counters()
    eng.shadow_device(ctx[:3], k=32, method=method, tournament_cap=1)
    d = delta(before)
    assert d["searches"] == 1 and d["contexts"] == 3
    assert d["contexts"] == (d.get("certified", 0) + d.get("redo_tier1", 0)
                             + d.get("redo_tier2", 0))
    assert d[tier] == 3 == eng.last_metrics["redo_contexts"]
    assert d["budget_queries"] >= 1


def test_budget_queries_and_e_builds_per_search(data):
    """Every search asks for the memory budget at least once; ``E`` is
    built once, for the first chunk of 8, and kept."""
    ds, ctx, _ = data
    eng = engine(ds)
    before = profiling.counters()
    eng.predict(ctx, k=8, to_predict=to_predict, eta=0.1,
                n_context_splits=2)
    d = delta(before)
    assert d["searches"] == 2 and d["budget_queries"] >= 2
    assert d["e_builds"] == 1 and "e_evictions" not in d


def test_oracle_tier_evicts_e(data, monkeypatch):
    ds, ctx, _ = data
    eng = engine(ds)
    eng.factored_responses()
    orig = search_ops.two_pass_search
    monkeypatch.setattr(search_ops, "two_pass_search",
                        lambda y, n, g, k, cap=None: orig(y, n, g, k, 1))
    before = profiling.counters()
    eng.shadow_device(ctx[:9], k=32, tournament_cap=1)
    d = delta(before)
    assert d["redo_tier2"] == 9 and d["e_evictions"] == 1
    assert eng._E is None


def test_last_metrics_keep_every_key_but_wall_s(data):
    ds, ctx, _ = data
    eng = engine(ds)
    eng.predict(ctx[:4], k=8, to_predict=to_predict, eta=0.1,
                n_context_splits=2)
    m = eng.last_metrics
    assert "wall_s" not in m
    assert {"entry", "B", "k", "method", "n_splits", "n_out", "R",
            "factored", "mesh", "redo_contexts", "n_context_chunks"} <= set(m)
    assert m["entry"] == "predict" and m["n_context_chunks"] == 2
    eng.shadow(ctx[:2], k=4, exact_dtype="float64")
    assert "wall_s" not in eng.last_metrics
    assert eng.last_metrics["exact_dtype"] == "float64"


def test_kernel_launches_read_the_counter_store():
    k = Kernel("tracing_test_kernel", [])
    assert k.launches == 0
    profiling.count("launch.tracing_test_kernel", 3)
    assert k.launches == 3
    k.launches = 0
    assert profiling.counters()["launch.tracing_test_kernel"] == 0
    assert search_ops.TOEPLITZ.launches == profiling.counters().get(
        "launch.blockmin_toeplitz", 0)
