"""The port's generators (MRW, PDV) and the autoregressive linear benchmark
against the JAX package on the same numpy inputs (CPU), plus the statistics
that ``tests/test_models.py`` holds the JAX generators to, on the port's own
draws.

Random draws differ between the packages (a ``torch.Generator`` is not a JAX
key), so parity is checked with the same noise injected on both sides:
JAX's own normals fed to the port's circulant sampler, and one standardised
noise array returned by ``gen_dw`` of both PDV models. Tolerances are stated
per test; every one is a float32 tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import shadowing_tpu as J
import shadowing_tpu_torch as P
from shadowing_tpu.models import mrw as jax_mrw
from shadowing_tpu.models import pdv as jax_pdv
from shadowing_tpu_torch.models import mrw as port_mrw
from shadowing_tpu_torch.models import pdv as port_pdv

PARAMS = dict(lams1=[55.0, 10.0], lams2=[20.0, 3.0], thetas=[0.25, 0.5],
              betas=[0.04, -0.12, 0.75])


def mrw(**kw):
    return P.MRWGenerator(**kw, device="cpu")


# -- MRW ----------------------------------------------------------------------

@pytest.mark.parametrize("H,lam,sigma,L", [(0.5, 0.2, 0.0126, None),
                                           (0.3, 0.35, 0.01, 100)])
def test_mrw_spectra_equal_jax(H, lam, sigma, L):
    n = 512
    for name, args in (("_fgn_cov", (n, H, sigma)), ("_omega_cov", (n, lam, L or n))):
        cov = getattr(port_mrw, name)(*args)
        np.testing.assert_array_equal(cov, getattr(jax_mrw, name)(*args))
        np.testing.assert_array_equal(port_mrw._circulant_sqrt_spectrum(cov),
                                      jax_mrw._circulant_sqrt_spectrum(cov))
    gj = J.MRWGenerator(T=n + 1, H=H, lam=lam, sigma=sigma, L=L)
    gp = mrw(T=n + 1, H=H, lam=lam, sigma=sigma, L=L)
    np.testing.assert_array_equal(gp._sq_eps.numpy(), np.asarray(gj._sq_eps))
    np.testing.assert_array_equal(gp._sq_om.numpy(), np.asarray(gj._sq_om))
    assert gp._mean_om == float(gj._mean_om)
    assert gp.cache_dir == gj.cache_dir is None


def test_mrw_generate_equals_jax_on_jax_normals(monkeypatch):
    """Feed the port's sampler the exact normals JAX's ``generate`` draws
    (same key splits): the log-prices agree to float32 FFT round-off
    (rtol 1e-5, atol 1e-6 of paths whose scale is ~0.1)."""
    T, R, batch, seed = 257, 12, 8, 3
    gj = J.MRWGenerator(T=T, H=0.5, lam=0.2, seed=seed)
    gp = mrw(T=T, H=0.5, lam=0.2, seed=seed)
    m = gj._sq_eps.shape[0]     # the circulant embedding size 2(T-1) - 2
    normals = []
    key = jax.random.PRNGKey(seed)
    for _ in range(-(-R // batch)):
        key, sub = jax.random.split(key)
        for kk in jax.random.split(sub):
            kr, ki = jax.random.split(kk)
            normals.append([torch.from_numpy(np.array(
                jax.random.normal(k, (batch, m)))) for k in (kr, ki)])
    monkeypatch.setattr(
        port_mrw, "_sample_stationary",
        lambda gen, sq, n, b: port_mrw._stationary_from_normals(
            *normals.pop(0), sq, n))
    got = gp.generate(R, batch=batch).numpy()
    assert normals == []
    want = gj.generate(R, batch=batch)
    assert got.shape == want.shape == (R, 1, T)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_mrw_shapes_cache_and_determinism(tmp_path):
    gen = mrw(T=257, H=0.5, lam=0.2, cache_path=tmp_path, seed=3)
    lnx = gen.load(R=16)
    assert lnx.shape == (16, 1, 257) and lnx.dtype == torch.float32
    assert (lnx[:, :, 0] == 0).all()
    assert (gen.cache_dir / "trajectories.npy").exists()
    assert gen.cache_dir.name == J.MRWGenerator(
        T=257, H=0.5, lam=0.2, cache_path=tmp_path, seed=3).cache_dir.name
    again = mrw(T=257, H=0.5, lam=0.2, cache_path=tmp_path, seed=3).load(R=8)
    np.testing.assert_array_equal(lnx[:8].numpy(), again.numpy())
    fresh = mrw(T=257, H=0.5, lam=0.2, seed=3)
    np.testing.assert_array_equal(fresh.generate(16).numpy(), lnx.numpy())
    np.testing.assert_array_equal(fresh.generate(5).numpy(), lnx[:5].numpy())
    other = mrw(T=257, H=0.5, lam=0.2, seed=4).generate(16)
    assert not torch.equal(other, lnx)


def mrw_increments(R, **kw):
    lnx = mrw(**kw).generate(R, batch=R).numpy()[:, 0, :]
    return np.diff(lnx, axis=-1)


@pytest.mark.parametrize("stat", ["variance", "multifractality",
                                  "clustering", "hurst"])
def test_mrw_statistics(stat):
    """The statistics ``tests/test_models.py`` checks on the JAX generator,
    on the port's draws at T = 513."""
    if stat == "variance":
        sigma = 0.01
        dlnx = mrw_increments(512, T=513, H=0.5, lam=0.2, sigma=sigma, seed=0)
        assert abs(dlnx.std() / sigma - 1) < 0.1
        assert abs(dlnx.mean()) < 3 * sigma / np.sqrt(dlnx.size)
    elif stat == "multifractality":
        k = [stats.kurtosis(mrw_increments(128, T=513, H=0.5, lam=lam,
                                           seed=1).ravel())
             for lam in (0.01, 0.35)]
        assert k[0] < 1.0 and k[1] > 3.0
    elif stat == "clustering":
        a = np.abs(mrw_increments(64, T=513, H=0.5, lam=0.3, seed=2))
        a = a - a.mean(-1, keepdims=True)
        assert (a[:, :-50] * a[:, 50:]).mean() / (a**2).mean() > 0.05
    else:
        for H in (0.3, 0.7):
            lnx = np.cumsum(mrw_increments(64, T=513, H=H, lam=0.01, seed=4),
                            axis=-1)
            v1 = np.var(lnx[:, 1:] - lnx[:, :-1])
            v16 = np.var(lnx[:, 16:] - lnx[:, :-16])
            assert abs(0.5 * np.log(v16 / v1) / np.log(16) - H) < 0.08


# -- PDV ------------------------------------------------------------------------

@pytest.mark.parametrize("betas", [[0.04, -0.12, 0.75], [0.04, -0.12, 0.75, 0.3]])
def test_sigma_matches_jax(rng, betas):
    params = {**PARAMS, "betas": betas}
    R1 = rng.normal(0, 0.3, size=(50, 2)).astype(np.float32)
    R2 = rng.uniform(-0.01, 0.2, size=(50, 2)).astype(np.float32)
    want = J.PDVModel(**params).sigma(R1, R2)
    got = P.PDVModel(**params, device="cpu").sigma(R1, R2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
    assert ((got >= 0) & (got <= 1.5)).all()


def inject(jax_model, port_model, noise):
    """Both models' ``gen_dw`` return ``noise`` (instance attributes only)."""
    jax_model.gen_dw = lambda s, size, key: jnp.asarray(noise)
    port_model.gen_dw = lambda s, size, generator: torch.from_numpy(noise)


@pytest.mark.parametrize("model,S", [("PDVModel", 1), ("PDVModel", 8),
                                     ("PDVModelDiscrete", 16)])
def test_pdv_gen_matches_jax_on_the_same_noise(rng, model, S):
    """One year of daily steps, float32 on both sides: sigma and prices
    agree to rtol 2e-5."""
    dt, n = 1 / 252, 252
    steps = n - 1 if model == "PDVModel" else n
    noise = rng.standard_normal((S, steps)).astype(np.float32)
    noise = ((noise - noise.mean(-1, keepdims=True))
             / noise.std(-1, keepdims=True) * np.sqrt(dt)).astype(np.float32)
    mj, mp = getattr(J, model)(**PARAMS), getattr(P, model)(**PARAMS,
                                                            device="cpu")
    inject(mj, mp, noise)
    kw = dict(T=1.0, dt=dt, S0=100.0, R10=np.array([0.05, -0.02]),
              R20=np.full(2, 0.04))
    sj, xj = mj.gen(S=S, **kw)
    sp, xp = mp.gen(S=S, **kw)
    assert sp.shape == sj.shape and xp.shape == xj.shape
    assert xp.shape == ((n,) if S == 1 else (S, n))
    np.testing.assert_allclose(sp, sj, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(xp, xj, rtol=2e-5)


def test_pdv_own_draws_and_guards():
    m = P.PDVModelDiscrete(**PARAMS, device="cpu")
    kw = dict(T=0.5, dt=1 / 252, S0=100.0, S=64, R10=np.zeros(2),
              R20=np.full(2, 0.04))
    sigma, S = m.gen(**kw)
    assert sigma.shape == S.shape == (64, 126)
    assert (S[:, 0] == 100.0).all() and (S > 0).all()
    assert ((sigma >= 0) & (sigma <= 1.5)).all()
    s2, S2 = m.gen(**kw)                          # default generator: seed 0
    np.testing.assert_array_equal(S2, S)
    _, S3 = m.gen(**kw, generator=torch.Generator().manual_seed(1))
    assert not np.array_equal(S3, S)
    with pytest.raises(ValueError):
        m.gen(T=1.0, dt=0.5, S0=1.0, S=2, R10=np.zeros(2), R20=np.zeros(2))
    # leverage: a -10% day raises vol (beta1 < 0)
    R1, R2 = np.zeros((1, 2)), np.full((1, 2), 0.02)
    rt = np.array([-0.10])
    R1c = np.exp(-m.lams1 / 252) * R1 + m.lams1 * rt[:, None]
    R2c = np.exp(-m.lams2 / 252) * R2 + m.lams2 * rt[:, None] ** 2
    assert m.sigma(R1c, R2c)[0] > m.sigma(R1, R2)[0] * 1.5
    c_sig, c_S = P.PDVModel(**PARAMS, device="cpu").gen(
        T=1.0, dt=1 / 252, S0=100.0, R10=np.zeros(2), R20=np.full(2, 0.04))
    assert c_sig.shape == c_S.shape == (252,) and c_S[0] == 100.0


@pytest.mark.parametrize("df", [1.0, 4.0, 30.0])
def test_student_t_sampler(df):
    """Generator-driven Student-t draws (Marsaglia–Tsang chi-square, with
    the a < 1 boost at df = 1) follow scipy's t: Kolmogorov–Smirnov p > 0.01
    on 100,000 draws; ``gen_dw`` standardises each path."""
    gen = torch.Generator().manual_seed(int(df))
    x = port_pdv._sample_t(gen, df, 0.0, 1.0, (100_000,), torch.device("cpu"))
    assert stats.kstest(x.numpy(), stats.t(df).cdf).pvalue > 0.01
    m = P.PDVModel(**PARAMS, nu=df, device="cpu")
    dw = m.gen_dw(0.5, (8, 1000), torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_allclose(dw.mean(-1), 0.0, atol=1e-6)
    np.testing.assert_allclose(dw.std(-1), 0.5, rtol=1e-5)


def test_fit_t_mle_matches_jax():
    """400 Adam steps in float32 on both sides; the fitted parameters agree
    to 1e-3 relative and stay close to scipy's fit."""
    sample = stats.t(4.0, 0.0003, 0.009).rvs(size=20000, random_state=7)
    want = [float(v) for v in jax_pdv._fit_t_mle(jnp.asarray(sample, jnp.float32))]
    got = [float(v) for v in port_pdv._fit_t_mle(
        torch.as_tensor(sample, dtype=torch.float32))]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-7)
    m = P.PDVModel(**PARAMS, snp=P.PriceData(dlnx=sample[None, None, :],
                                              x_init=100.0), device="cpu")
    np.testing.assert_allclose(m.fit_params, got, rtol=1e-6)
    df_sp, _, scale_sp = stats.t.fit(sample)
    assert abs(got[0] - df_sp) / df_sp < 0.25
    assert abs(got[2] - scale_sp) / scale_sp < 0.1


# -- autoregressive linear benchmark ------------------------------------------------

@pytest.mark.parametrize("ktype,extra", [("exp", False), ("power-law", False),
                                         ("power-law", True)])
def test_ar_predictor_matches_jax(rng, ktype, extra):
    """float32 least squares on both sides: coefficients and in-sample
    predictions agree to 1e-4 relative."""
    x = 100 * np.exp(np.cumsum(rng.normal(0, 0.01, 3000)))
    kw = dict(T=10, w=64, s=5, dt=1 / 252, ktype=ktype, extra_term=extra)
    aj = J.AutoregressiveLinearPredictor(**kw)
    ap = P.AutoregressiveLinearPredictor(**kw)
    np.testing.assert_allclose(ap.k1, aj.k1, rtol=1e-6)
    np.testing.assert_allclose(ap.k2, aj.k2, rtol=1e-6)
    parts_j, parts_p = aj.separate(x), ap.separate(x)
    for a, b in zip(parts_p[:3], parts_j[:3]):
        np.testing.assert_array_equal(a, b)
    # JAX takes the log of ~100-valued prices in float32 (x64 is off): its
    # realized vols carry ~3e-5 relative error, the port's are float64
    np.testing.assert_allclose(parts_p[3], parts_j[3], rtol=1e-4)
    aj.train(x)
    ap.train(x)
    assert ap.coef_.shape == ((4,) if extra else (3,))
    np.testing.assert_allclose(ap.coef_, aj.coef_, rtol=1e-4, atol=1e-6)
    dl = parts_p[2]
    np.testing.assert_allclose(ap.predict(dl), aj.predict(dl), rtol=1e-4)
    assert (ap.predict(dl) > 0).mean() > 0.95
    with pytest.raises(RuntimeError, match="train"):
        P.AutoregressiveLinearPredictor(**kw).predict(dl)


def test_kernels_and_defaults():
    k = P.AutoregressiveLinearPredictor.init_exp_kernel_2_factors(
        w=128, dt=1 / 252, lam0=64.5, lam1=3.83, theta=0.67)
    np.testing.assert_allclose(k.sum() / 252, 1.0, rtol=1e-9)
    kp = P.AutoregressiveLinearPredictor.init_pl_kernel(
        w=128, dt=1 / 252, delta=0.044, alpha=2.82)
    np.testing.assert_allclose(kp.sum(), 252.0, rtol=1e-9)
    assert P.DEFAULT1 == J.DEFAULT1 and P.DEFAULT2 == J.DEFAULT2
    taus = np.arange(5) / 252
    np.testing.assert_allclose(P.kernel_exp(taus, lam=10.0).numpy(),
                               J.kernel_exp(taus, lam=10.0), rtol=1e-6)
    np.testing.assert_allclose(P.kernel_pl(taus, 0.044, 2.82).numpy(),
                               J.kernel_pl(taus, 0.044, 2.82), rtol=1e-6)


def test_compute_factor_and_conditional_futures():
    rng = np.random.default_rng(1)
    x_past = 100 * np.exp(np.cumsum(rng.normal(0, 0.01, 300)))
    mj = J.PDVModelDiscrete(**PARAMS)
    mp = P.PDVModelDiscrete(**PARAMS, device="cpu")
    R10, R20 = P.compute_factor(x_past, mp, w=252, dt=1 / 252)
    R10j, R20j = J.compute_factor(x_past, mj, w=252, dt=1 / 252)
    assert R10.shape == R20.shape == (2,) and (R20 >= 0).all()
    np.testing.assert_allclose(R10, R10j, rtol=1e-5)
    np.testing.assert_allclose(R20, R20j, rtol=1e-5)
    futures = P.future_pdv_model(x_past, mp, w=252, S0=100.0, S=32, T=0.25,
                                 dt=1 / 252)
    assert futures.shape == (32, 63) and np.allclose(futures[:, 0], 100.0)
