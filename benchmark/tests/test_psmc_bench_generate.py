"""The generation cell's check, and the harness's default systems.

The plain reference's statistics against the port's; whole runs of the
generation entry shrunk to a size a test can hold, on the CPU, with the
cell's own limits: the sound port reads correct, and the control (the
reference's synthesis with its statistics in TF32) and each fault planted
under the timed path read not correct. The faults: every seed stopped after
the first 100-step segment; white noise returned in place of the paths;
one wavelet scale dropped from the statistics the port matches; half of
the task left out, as its second shard made with the first shard's seed,
as its first half copied into its second, as every task made with the
first task's seeds, or as half of the paths returned. The cell runs on one card and holds no state between
calls, so a skipped exchange between cards and a state left unchanged are
not faults it can have.
"""
import importlib
import time

import numpy as np
import pytest
import torch

from benchmark import datagen, harness, work
from benchmark.reference import scattering
from benchmark.reference.precision import FLOAT64, TF32
from benchmark.system import Oracle, Program
from shadowing_tpu_torch.models.scattering import moments, synthesis
from shadowing_tpu_torch.models.scattering.moments import scattering_stats
from shadowing_tpu_torch.models.scattering.wavelets import build_filter_bank

CELL = "snp-scattering-generate"
SEARCH_CELLS = ["mrw32k-backtest-k1024", "ref131k-predict-foveal126",
                "mrw32k-backtest-k16384", "mrw32k-query-smile"]
SEED = 2**31 + 11
#: the module (the package exports its function under the same name)
port_generate = importlib.import_module("shadowing_tpu_torch.models.scattering.generate")


@pytest.mark.parametrize("J, T", [(4, 256), (9, 4096)])
def test_reference_statistics_match_the_port(J, T):
    rng = np.random.default_rng(J * T)
    x = rng.standard_normal((3, T)) * np.exp(0.3 * rng.standard_normal((3, T)))
    port = scattering_stats(torch.tensor(x, dtype=torch.float32),
                            build_filter_bank(T, J), average=False).double().numpy()
    ref = scattering.stats(torch.tensor(x), torch.tensor(scattering.filter_bank(T, J)),
                           FLOAT64).numpy()
    assert ref.shape == port.shape == (3, moments.n_stats(J))
    assert np.abs(port - ref).max() <= 1e-5


def test_the_reference_filter_bank_is_the_ports_in_float64():
    T, J = 4096, 9
    assert np.abs(scattering.filter_bank(T, J)
                  - build_filter_bank(T, J).psi_hat).max() <= 1e-7


def test_tf32_moves_the_statistics():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, 512)))
    psi = torch.tensor(scattering.filter_bank(512, 5))
    gap = (scattering.stats(x, psi, TF32).double() - scattering.stats(x, psi, FLOAT64)).abs()
    assert 1e-6 < gap.max() < 1e-2


def test_the_calibration_series_is_the_upstream_span():
    s = harness.load_cell(CELL).entry.series(harness.load_cell(CELL).config)
    assert s.shape == (3913,) and s.dtype == np.float64


def test_the_tasks_follow_the_job_array_seeds():
    c = harness.load_cell(CELL)
    mix = c.entry.mix(c.config, c.traffic, 5, "cpu")
    seeds = [mix.inputs(i)["seed"] for i in range(40)]
    assert seeds[:3] == [80, 81, 82] and seeds[16] == 96 and len(set(seeds)) == 40
    x = mix.inputs(3)
    assert x["R"] == 2048 and x["max_iterations"] == 1000 and len(x["keep"]) == 64
    # the same rows in every call, each row of the first half with its twin
    first = x["keep"][x["keep"] < 1024]
    assert np.array_equal(x["keep"], np.concatenate([first, first + 1024]))
    assert np.array_equal(mix.inputs(17)["keep"], x["keep"])
    t = c.entry.trace_input(mix, 3)
    assert t["seed"] == x["seed"] and t["R"] == 2048 and t["max_iterations"] == 100
    assert np.array_equal(t["keep"], x["keep"])
    assert mix.warm["R"] == 2048 and mix.warm["seed"] not in seeds
    assert harness.layer_work(c, None) is None      # no pass 1 and no work count


@pytest.mark.parametrize("name", SEARCH_CELLS)
def test_the_default_hooks_build_the_search_systems(name):
    c = harness.load_cell(name)
    for hook in ("program_system", "oracle_system", "work", "layer_units",
                 "trace_input"):
        assert not hasattr(c.entry, hook)
    c.config["dataset"].update(R=16, T=600)
    data = datagen.dataset(c.config["dataset"], SEED, "cpu")
    prog = harness.program_system(c, SEED, "cpu")
    assert isinstance(prog, Program) and prog.shape == tuple(data.shape)
    for arith in (FLOAT64, TF32):
        ref = harness.oracle_system(c, SEED, "cpu", arith)
        assert isinstance(ref, Oracle) and ref.arith is arith
        assert torch.equal(ref.data, data)
    shape = (32768, 1, 4096) if c.config["dataset"]["kind"] == "mrw" else (131072, 1, 4096)
    emb = c.config["embedding"]
    w = int(emb["dim"] if emb["kind"] == "identity" else emb["width"])
    d = w if emb["kind"] == "identity" else 34
    B = int(c.traffic.get("chunk_dates", 1))
    n_out = 4096 - w - int(c.config["horizon"]) + 1
    assert harness.layer_work(c, shape) == work.pass1(shape[0], 1, 4096, n_out, B, w, d)


def tiny() -> harness.Cell:
    """The cell shrunk: 16-path tasks of two 8-seed shards, T = 256,
    J = 3; every checked path's seeds take 125-175 steps there."""
    c = harness.load_cell(CELL)
    c.config.update(T=256, J=3, R=64, ntot=4, batch=8)
    c.traffic.update(check_paths=8)
    return c


def run(control: bool = False) -> dict:
    """A run of two calls, so that a fault between calls shows."""
    return harness.run(tiny(), SEED, 0.05, False, "cpu", time.perf_counter(),
                       control=control, min_calls=2)


def test_the_sound_port_reads_correct():
    res = run()
    assert res["correct"] is True, res["checks"]
    assert list(res["checks"]) == ["rms_gap", "unconverged_pct", "paths_missing",
                                   "max_path_corr"]
    assert res["checks"]["paths_missing"]["value"] == 0


def test_the_control_reads_not_correct():
    res = run(control=True)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] == 0


def stopped_after_100_steps(monkeypatch):
    orig = port_generate.synthesize_batch
    monkeypatch.setattr(port_generate, "synthesize_batch",
                        lambda *a, **kw: orig(*a, **{**kw, "max_iterations": 100}))


def white_noise(monkeypatch):
    orig = port_generate.synthesize_batch

    def fault(generator, *a, **kw):
        z, rms = orig(generator, *a, **kw)
        noise = torch.randn(z.shape, generator=generator, device=z.device)
        return (noise - noise.mean(-1, keepdim=True)) / noise.std(-1, keepdim=True), rms

    monkeypatch.setattr(port_generate, "synthesize_batch", fault)


def one_scale_dropped(monkeypatch):
    orig = moments._scattering_stats_flat

    def fault(x, psi_hat, J, bands=None):
        psi_hat = psi_hat.clone()
        psi_hat[1] = 0.0
        return orig(x, psi_hat, J, bands)

    monkeypatch.setattr(moments, "_scattering_stats_flat", fault)
    monkeypatch.setattr(synthesis, "_scattering_stats_flat", fault)


def shard_seed_ignored(monkeypatch):
    orig = port_generate._shard_seed
    monkeypatch.setattr(port_generate, "_shard_seed", lambda seed, shard: orig(seed, 0))


def task_seed_ignored(monkeypatch):
    orig = port_generate._shard_seed
    monkeypatch.setattr(port_generate, "_shard_seed", lambda seed, shard: orig(0, shard))


def first_half_copied(monkeypatch):
    import shadowing_tpu_torch as st

    orig = st.generate

    def fault(*a, R, **kw):
        out = orig(*a, R=R, **kw)
        out[R // 2 :] = out[: R - R // 2]
        return out

    monkeypatch.setattr(st, "generate", fault)


def half_the_paths(monkeypatch):
    import shadowing_tpu_torch as st

    orig = st.generate
    monkeypatch.setattr(st, "generate", lambda *a, R, **kw: orig(*a, R=R // 2, **kw))


@pytest.mark.parametrize("fault", [stopped_after_100_steps, white_noise,
                                   one_scale_dropped, shard_seed_ignored,
                                   first_half_copied, task_seed_ignored,
                                   half_the_paths],
                         ids=lambda f: f.__name__)
def test_a_fault_reads_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run()
    assert res["correct"] is False, res["checks"]
