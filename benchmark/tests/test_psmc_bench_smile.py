"""The smile cell (``entries/predict_and_smile.py``): a whole run at a size
a test can hold, on the CPU (the port's kernels run their plain versions),
with the cell's own limits. The sound port reads correct; the control (the
plain reference computed in TF32 in the program's place) and three faults
planted under the timed path read not correct: the normal equations solved
in float32, one price moved by a thousandth of the spot, one vol turned
NaN. Then the cell's per-layer readers on a hand-written trace, and the
work of the smile's kernel."""
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, trace
from benchmark.harness import _load
from shadowing_tpu_torch.pricing import hedged_mc

CELL = "mrw32k-query-smile"
SEED = 2**31 + 13


def run(control: bool = False) -> dict:
    """The cell shrunk: 512 rows of 513 log-prices, k = 256, 4 queries
    checked."""
    c = harness.load_cell(CELL)
    c.config["dataset"].update(R=512, T=513)
    c.traffic.update(k=256, check_queries=4)
    return harness.run(c, SEED, 0.05, False, "cpu", time.perf_counter(),
                       control=control, min_calls=4)


def test_the_sound_port_reads_correct():
    res = run()
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"pred_rel_err", "smile_price_err",
                                  "smile_vol_err"}


def test_the_control_reads_not_correct():
    res = run(control=True)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] == 0
    assert res["checks"]["smile_price_err"]["value"] > \
        res["checks"]["smile_price_err"]["limit"]


def prices_solved_in_float32(monkeypatch):
    solve = torch.linalg.solve_ex

    def fault(A, B, **kw):
        out = solve(A.float(), B.float(), **kw)
        return SimpleNamespace(result=out.result.to(A.dtype), info=out.info)

    monkeypatch.setattr(torch.linalg, "solve_ex", fault)


def _smiles_altered(monkeypatch, alter):
    smiles = hedged_mc._smiles

    def fault(*args, **kw):
        out = smiles(*args, **kw)
        alter(out[0])
        return out

    monkeypatch.setattr(hedged_mc, "_smiles", fault)


def one_price_moved(monkeypatch):
    def alter(sm):
        sm.prices[1, 4] += 1e-3 * sm.spot

    _smiles_altered(monkeypatch, alter)


def one_vol_nan(monkeypatch):
    def alter(sm):
        sm.vols[1, 4] = float("nan")

    _smiles_altered(monkeypatch, alter)


FAULTS = [(prices_solved_in_float32, "smile_price_err"),
          (one_price_moved, "smile_price_err"),
          (one_vol_nan, "smile_vol_err")]


@pytest.mark.parametrize("fault, number", FAULTS,
                         ids=[f.__name__ for f, _ in FAULTS])
def test_a_fault_reads_not_correct(fault, number, monkeypatch):
    fault(monkeypatch)
    res = run()
    assert res["correct"] is False, res["checks"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


#: (name, start_us, end_us) of the spans of one query
SPANS = [("psmc.predict_and_smile", 0, 1000), ("psmc.pass1", 50, 200),
         ("psmc.smile", 500, 1000), ("psmc.smile.knots", 500, 600),
         ("psmc.smile.regress", 600, 900), ("psmc.smile.vols", 900, 1000)]
#: (host start_us of the launch, kernel start_us, dur_us)
KERNELS = [(100, 110, 50), (550, 560, 20), (650, 700, 100), (950, 960, 30)]
SMILE = ("smile_device_ms.query", "smile_idle_ms.query",
         "smile_launches.query")


def reading(unit: str = "query", with_spans: bool = True) -> trace.Reading:
    ev = [{"ph": "X", "name": n, "cat": "user_annotation", "ts": s,
           "dur": e - s} for n, s, e in SPANS if with_spans]
    for i, (t, s, d) in enumerate(KERNELS):
        ev.append({"ph": "X", "name": "cudaLaunchKernel",
                   "cat": "cuda_runtime", "ts": t, "dur": 2})
        ev.append({"ph": "X", "name": f"kernel_{i}", "cat": "kernel",
                   "ts": s, "dur": d})
    ops, host = trace.parse({"traceEvents": ev})
    return trace.Reading(ops=ops, host=host, window_s=1e-3, units=1,
                         unit=unit, untraced_s_per_unit=1e-3)


def test_the_smile_readers():
    """Three kernels launched inside the smile's spans, 150 us of work, and
    350 us of its 500 with the card idle; the pass-1 kernel is not
    counted."""
    r = reading()
    read = {name: _load("metrics", name).read for name in SMILE}
    assert read["smile_device_ms.query"](r) == pytest.approx(0.150)
    assert read["smile_idle_ms.query"](r) == pytest.approx(0.350)
    assert read["smile_launches.query"](r) == 3


@pytest.mark.parametrize("name", SMILE)
def test_the_smile_readers_return_none_elsewhere(name):
    read = _load("metrics", name).read
    assert read(reading(unit="chunk")) is None
    assert read(reading(with_spans=False)) is None


def test_the_kernel_roofline():
    """The kernel's share of its roofline: the work of the cell's shapes
    (one context of 1,024 paths, 20 steps, Ts = [5, 10, 20], 9 strikes, 12
    hats) over the kernel's time a query; nothing without the kernel or for
    another unit."""
    from benchmark import work_smile

    read = _load("metrics", "hedged_mc_smile_roofline.query").read
    assert read(reading()) is None
    r = reading()
    r.ops.append(("(anonymous namespace)::hedged_mc_smile_kernel(double "
                  "const*)", "kernel", 2000.0, 3000.0))
    bound, kind = work_smile.bound_seconds(
        *work_smile.smile(1, 1024, 20, [5, 10, 20], 9))
    assert kind == "operations"
    assert read(r) == pytest.approx(100.0 * bound / 3e-3)
    r.unit = "chunk"
    assert read(r) is None


def test_the_kernel_work_by_hand():
    """One context, 4 paths of 2 steps, T = 2, one strike, 2 hats: 12
    float64 inputs of paths, 4 weights, 1 strike, 2 knots; one regression
    step and the last."""
    from benchmark import work_smile

    nbytes, flops = work_smile.smile(1, 4, 2, [2], 1, m=2)
    assert nbytes == 8 * (12 + 4 + 1 + 2) + 12
    step = 4 * (12 + 2 * (16 + 4) + 4) + 2 * 4 ** 3 // 3 + 2 * 4 ** 2
    last = 4 * 2 * (4 + 2) + 2 * 4
    assert flops == step + last + 82 * 25


def test_the_kernel_roofline_refuses_a_second_cell(monkeypatch):
    """A reading does not name its cell, so the reader counts the work at
    the shapes of the one cell it lists, and raises where it lists two."""
    from benchmark import harness

    bench = harness.manifest()
    metric = next(m for m in bench["per_layer"]
                  if m["name"] == "hedged_mc_smile_roofline.query")
    metric["workloads"] = metric["workloads"] + ["ref131k-predict-foveal126"]
    monkeypatch.setattr(harness, "manifest", lambda: bench)
    read = _load("metrics", "hedged_mc_smile_roofline.query").read
    r = reading()
    r.ops.append(("hedged_mc_smile_kernel", "kernel", 2000.0, 3000.0))
    with pytest.raises(ValueError, match="one cell"):
        read(r)
