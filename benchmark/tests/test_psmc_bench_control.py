"""The check refuses the control and the faults the cells can have.

A whole run of each entry at a size a test can hold, on the CPU (the port's
kernels run their plain versions), with the cell's own limits: the sound
port reads correct; the control (the plain reference computed in TF32 in
the program's place) and each fault planted under the timed path read not
correct. The faults: half of the k winners left out and the mean taken over
the rest; the best winner replaced by the worst where the search produces
it; for the backtest, the AR-linear answer altered by a thousandth. The
cells hold no state from call to call and run on one card, so a state left
unchanged and a skipped exchange between cards are not faults they can have.
"""
import time

import pytest

from benchmark import harness
from shadowing_tpu_torch.parallel import sharding
from shadowing_tpu_torch.shadow import engine

SEED = 2**31 + 11


def tiny(name: str) -> harness.Cell:
    """The cell shrunk: 512 rows of 513 log-prices (or 1,024 samples),
    small k, two chunks of 64 dates per backtest call."""
    c = harness.load_cell(name)
    cfg, tr = c.config, c.traffic
    if cfg["dataset"]["kind"] == "mrw":
        cfg["dataset"].update(R=512, T=513)
    else:
        cfg["dataset"].update(R=128, T=1024)
    if tr["entry"] == "rolling_backtest":
        tr.update(k=128, dates_per_call=128, check_dates=24)
    else:
        tr.update(k=256, check_queries=4)
    return c


def run(name: str, control: bool = False) -> dict:
    return harness.run(tiny(name), SEED, 0.05, False, "cpu",
                       time.perf_counter(), control=control, min_calls=4)


CELLS = ["mrw32k-backtest-k1024", "ref131k-predict-foveal126"]


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_port_reads_correct(name):
    res = run(name)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_not_correct(name):
    res = run(name, control=True)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] == 0


def half_of_the_winners(monkeypatch):
    orig = engine._aggregate_predictions

    def fault(distances, paths, *args):
        k = distances.shape[1] // 2
        return orig(distances[:, :k], paths[:, :k], *args)

    monkeypatch.setattr(engine, "_aggregate_predictions", fault)


def best_winner_altered(monkeypatch):
    orig = sharding.sharded_finalize_shadow

    def fault(*args):
        dists, paths, idces = orig(*args)
        dists, paths = dists.clone(), paths.clone()
        dists[:, 0], paths[:, 0] = dists[:, -1], paths[:, -1]
        return dists, paths, idces

    monkeypatch.setattr(sharding, "sharded_finalize_shadow", fault)


def ar_answer_altered(monkeypatch):
    from shadowing_tpu_torch import backtest

    orig = backtest._ar_benchmark_predictions
    monkeypatch.setattr(backtest, "_ar_benchmark_predictions",
                        lambda *a: orig(*a) * 1.001)


FAULTS = [(name, fault) for name in CELLS
          for fault in (half_of_the_winners, best_winner_altered)]
FAULTS.append(("mrw32k-backtest-k1024", ar_answer_altered))


@pytest.mark.parametrize("name, fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_a_fault_reads_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = run(name)
    assert res["correct"] is False, res["checks"]
