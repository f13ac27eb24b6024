"""The plain reference against ``shadowing_tpu_torch`` at tiny sizes on the
CPU, its TF32 rounding, and its imports (it may import neither JAX, the JAX
package nor the port)."""
import ast
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

import shadowing_tpu_torch as st
from benchmark.reference import ar_linear, predict, search
from benchmark.reference.precision import FLOAT64, TF32, round_tf32

REF = Path(__file__).resolve().parents[1] / "reference"
ALLOWED = {"__future__", "contextlib", "dataclasses", "math", "statistics",
           "numpy", "torch", "benchmark"}


def test_reference_imports_nothing_of_the_program():
    for path in REF.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in ALLOWED, (path.name, name)
                if name.startswith("benchmark"):
                    assert name.startswith("benchmark.reference"), (path.name, name)


def test_round_tf32():
    x = np.float32([1.0, 1 + 2**-11, 1 + 3 * 2**-12, -(1 + 3 * 2**-12), 0.1, 3e-5])
    want = np.float32([1.0, 1.0, 1 + 2**-10, -(1 + 2**-10)])
    got = round_tf32(x)
    np.testing.assert_array_equal(got[:4], want)
    assert (np.abs(got / x - 1) <= 2**-11).all()
    np.testing.assert_array_equal(round_tf32(torch.from_numpy(x)).numpy(), got)
    mant = got.view(np.int32) & 0x1FFF
    assert (mant == 0).all()


@pytest.mark.parametrize("emb", [st.Identity(20), st.Foveal(1.15, 0.9, 126)])
def test_embedding_kernel(emb):
    spec = ({"kind": "identity", "dim": 20} if isinstance(emb, st.Identity)
            else {"kind": "foveal", "alpha": 1.15, "beta": 0.9, "width": 126})
    k = search.embedding_kernel(spec)
    assert k.shape == emb.kernel.shape
    np.testing.assert_allclose(k, emb.kernel, rtol=1e-7)


def _engine(R=24, T=200, w=12, h=16, foveal=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((R, 1, T), generator=g) * 0.01
    emb = st.Foveal(1.15, 0.9, w) if foveal else st.Identity(w)
    eng = st.PathShadowing(emb, st.RelativeMSE(), y, st.PredictionContext(h),
                           device="cpu")
    spec = ({"kind": "foveal", "alpha": 1.15, "beta": 0.9, "width": w} if foveal
            else {"kind": "identity", "dim": w})
    ctx = torch.randn((3, 1, w), generator=g) * 0.01
    return eng, y, search.embedding_kernel(spec), ctx


@pytest.mark.parametrize("foveal", [False, True])
def test_search_equals_the_ports_direct_oracle(foveal):
    eng, y, kernel, ctx = _engine(foveal=foveal, w=30 if foveal else 12)
    d_p, p_p, i_p = eng.shadow(ctx, k=50, method="direct")
    dist, flat, paths = search.search(y, ctx.numpy(), kernel, 16, 50, FLOAT64)
    n_out = y.shape[-1] - kernel.shape[-1] - 16 + 1
    np.testing.assert_array_equal(flat // n_out, i_p[..., 0])
    np.testing.assert_array_equal(flat % n_out, i_p[..., 1])
    np.testing.assert_allclose(dist, d_p, rtol=1e-5)
    np.testing.assert_array_equal(paths.float().numpy(), p_p)


def test_search_in_small_blocks_equals_one_block(monkeypatch):
    _, y, kernel, ctx = _engine()
    whole = search.search(y, ctx.numpy(), kernel, 16, 40, FLOAT64)
    monkeypatch.setattr(search, "BLOCK_WINDOWS", 500)
    parts = search.search(y, ctx.numpy(), kernel, 16, 40, FLOAT64)
    np.testing.assert_array_equal(whole[1], parts[1])
    np.testing.assert_allclose(whole[0], parts[0], rtol=1e-12)


def test_predict_equals_the_ports():
    eng, y, kernel, ctx = _engine()
    Ts = [2, 5, 16]
    to_predict = lambda x: st.realized_variance(x[:, :, 0, :], Ts=Ts)
    avg_p, std_p = eng.predict(ctx, k=60, to_predict=to_predict, eta=0.1)
    dist, _, paths = search.search(y, ctx.numpy(), kernel, 16, 60, FLOAT64)
    avg, std = predict.predict(dist, paths[:, :, 0, 12:].numpy(), Ts, 0.1, FLOAT64)
    np.testing.assert_allclose(avg, avg_p, rtol=2e-5)
    np.testing.assert_allclose(std, std_p, rtol=2e-4)
    avg32, _ = predict.predict(dist, paths[:, :, 0, 12:].numpy(), Ts, 0.1, TF32)
    assert np.abs(avg32 / avg - 1).max() > 1e-5


def _near_ties(seed, k=200, K=240, h=16, n_tied=7):
    """Distances ``(1, K)`` ascending with ``n_tied`` of them around rank
    k within 2e-6 of each other, and futures ``(1, K, h)``."""
    rng = np.random.default_rng(seed)
    dist = np.sort(rng.uniform(0.30, 0.34, K))
    lo = k - 1 - n_tied // 2
    dist[lo : lo + n_tied] = dist[k - 1] * (1 + np.sort(rng.uniform(-1e-6, 1e-6, n_tied)))
    dist = np.sort(dist)
    fut = rng.standard_normal((1, K, h)) * rng.uniform(0.005, 0.03, (1, K, 1))
    return dist[None], fut


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tie_interval_holds_every_swap_and_little_else(seed):
    k, Ts, eta, tie = 200, [2, 5, 16], 0.1, 1e-5
    dist, fut = _near_ties(seed, k)
    avg_lo, avg_hi, std_lo, std_hi, tied = predict.predict_interval(
        dist, fut, k, Ts, eta, tie)
    m, n = tied[0]
    assert (m, n) == (4, 7)
    first = np.flatnonzero(np.abs(dist[0] / dist[0, k - 1] - 1) <= tie)[0]
    got = []
    for pick in itertools.combinations(range(first, first + n), m):
        sel = list(range(first)) + list(pick)
        got.append(predict.predict(dist[:, sel], fut[:, sel], Ts, eta, FLOAT64))
    avgs = np.array([a for a, _ in got])
    stds = np.array([s for _, s in got])
    for lo, hi, vals in ((avg_lo, avg_hi, avgs), (std_lo, std_hi, stds)):
        assert (lo * (1 - 1e-12) <= vals.min(0)).all()
        assert (vals.max(0) <= hi * (1 + 1e-12)).all()
        # nearly exact: the tied windows weigh nearly alike, and the mean's
        # shift is second order in the share of windows swapped
        spread = vals.max(0) - vals.min(0)
        assert ((hi - lo) <= 1.05 * spread).all(), (hi - lo) / spread


def test_tie_interval_is_the_prediction_without_ties():
    k, Ts, eta = 200, [2, 5, 16], 0.1
    dist, fut = _near_ties(3, k, n_tied=1)
    avg, std = predict.predict(dist[:, :k], fut[:, :k], Ts, eta, FLOAT64)
    avg_lo, avg_hi, std_lo, std_hi, tied = predict.predict_interval(
        dist, fut, k, Ts, eta, 1e-9)
    assert tuple(tied[0]) == (1, 1)
    for bound in (avg_lo, avg_hi):
        np.testing.assert_allclose(bound, avg, rtol=1e-12)
    for bound in (std_lo, std_hi):
        np.testing.assert_allclose(bound, std, rtol=1e-9)


def test_ar_linear_equals_the_ports():
    from shadowing_tpu_torch.backtest import _ar_benchmark_predictions

    rng = np.random.default_rng(2)
    series = rng.standard_normal(600) * 0.011
    w, Ts = 20, np.array([5, 10, 20])
    ctx = np.lib.stride_tricks.sliding_window_view(series, w + 20)[:, :w]
    want = _ar_benchmark_predictions("ar-linear", None, series, ctx[:, None, :], Ts, w)
    got = ar_linear.ar_linear(series, ctx, Ts, w, FLOAT64)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.abs(ar_linear.ar_linear(series, ctx, Ts, w, TF32) / got - 1).max() > 1e-5
