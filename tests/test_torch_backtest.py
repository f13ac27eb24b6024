"""The port's rolling backtest against the JAX backtest on the same numpy
inputs (CPU), mirroring ``tests/test_backtest.py``.

Tolerances: the PSMC columns at 1e-5 relative (the same winners, weights
summed in another order); realized variance at 1e-5; the AR-linear columns
at 1e-3, since the JAX benchmark takes logs of prices and solves its least
squares in float32 (x64 is off) where the port's realized-vol targets are
float64."""
import numpy as np
import pytest

import shadowing_tpu as J
import shadowing_tpu_torch as P
from shadowing_tpu.backtest import rolling_backtest as jax_backtest


def vol_clustered_series(rng, n, base=0.01):
    """Two-state vol regime series: contexts carry information about the
    near future."""
    state = np.zeros(n, dtype=int)
    for t in range(1, n):
        state[t] = state[t - 1] if rng.uniform() > 0.02 else 1 - state[t - 1]
    vol = np.where(state == 0, base, 3 * base)
    return vol * rng.normal(size=n)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    data = vol_clustered_series(rng, 64 * 400)
    dataset = data.reshape(64, 1, 400).astype(np.float32)
    obs = vol_clustered_series(rng, 600)
    engines = (J.PathShadowing(J.Identity(20), J.RelativeMSE(), dataset,
                               J.PredictionContext(20)),
               P.PathShadowing(P.Identity(20), P.RelativeMSE(), dataset,
                               P.PredictionContext(20), device="cpu"))
    return data, obs, engines


@pytest.mark.parametrize("bench", [None, "ar-linear", "exp-out-of-sample"])
def test_backtest_matches_jax(problem, bench):
    data, obs, (jax_eng, eng) = problem
    kw = dict(w=20, Ts=[10, 20], k=64, stride=5, eta=0.5)
    if bench == "ar-linear":
        kw["benchmark"] = "ar-linear"
    elif bench:
        kw.update(benchmark={"ktype": "exp"}, benchmark_train=data[:2000])
    res = P.rolling_backtest(eng, obs, **kw)
    ref = jax_backtest(jax_eng, obs, **kw)
    n_dates = (600 - 20 - 20) // 5 + 1
    assert res.predicted.shape == res.realized.shape == (n_dates, 2)
    np.testing.assert_array_equal(res.Ts, ref.Ts)
    np.testing.assert_allclose(res.predicted, ref.predicted, rtol=1e-5)
    np.testing.assert_allclose(res.predicted_std, ref.predicted_std,
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(res.realized, ref.realized, rtol=1e-5)
    assert (res.correlation() > 0.2).all(), res.correlation()
    if bench is None:
        assert res.benchmark_predicted is ref.benchmark_predicted is None
        assert res.summary().splitlines()[0] == "maturity  rmse(vol)  corr"
        return
    np.testing.assert_allclose(res.benchmark_predicted, ref.benchmark_predicted,
                               rtol=1e-3)
    assert (res.benchmark_predicted >= 0).all()
    assert (res.correlation("benchmark") > 0.1).all()
    np.testing.assert_allclose(res.rmse("benchmark"), ref.rmse("benchmark"),
                               rtol=1e-3)
    assert "AR linear" in res.summary()


def test_alignment_dates_and_chunks(problem):
    """Dates and realized values align with the series; 130 dates make the
    default two chunks of 65 (130 // 64 splits), both on the factored
    route."""
    _, obs, (jax_eng, eng) = problem
    series = obs[:169]
    dates = np.arange(len(series))
    res = P.rolling_backtest(eng, series, w=20, Ts=[5, 10, 20], k=16,
                             dates=dates)
    ref = jax_backtest(jax_eng, series, w=20, Ts=[5, 10, 20], k=16,
                       dates=dates)
    assert res.predicted.shape == (130, 3)
    assert eng.last_metrics["n_context_chunks"] == 2 and eng._E is not None
    np.testing.assert_array_equal(res.dates, ref.dates)
    np.testing.assert_array_equal(res.dates, np.arange(19, 149))
    np.testing.assert_allclose(res.realized[0, 2],
                               (series[20:40] ** 2).mean() * 252, rtol=1e-12)
    np.testing.assert_allclose(res.predicted, ref.predicted, rtol=1e-5)
    np.testing.assert_allclose(res.rmse(), ref.rmse(), rtol=1e-5)
    np.testing.assert_allclose(res.correlation(), ref.correlation(), rtol=1e-5)
    pd_res = P.rolling_backtest(eng, P.PriceData(dlnx=series), w=20,
                                Ts=[5, 10, 20], k=16)
    np.testing.assert_allclose(pd_res.predicted, res.predicted, rtol=1e-6)


def test_guards(problem):
    _, obs, (_, eng) = problem
    res = P.rolling_backtest(eng, obs[:200], w=20, Ts=[10], k=4, stride=10)
    with pytest.raises(ValueError, match="ar-linear"):
        res.rmse("benchmark")
    with pytest.raises(ValueError, match="psmc"):
        res.rmse("other")
    with pytest.raises(ValueError, match="horizon"):
        P.rolling_backtest(eng, obs, w=20, Ts=[30], k=4)
    with pytest.raises(ValueError, match="unknown benchmark"):
        P.rolling_backtest(eng, obs[:200], w=20, Ts=[10], k=4, stride=10,
                           benchmark="garch")
