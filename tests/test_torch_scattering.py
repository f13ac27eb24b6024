"""The port's scattering-spectra model and generation CLI against the JAX
package on the same numpy inputs (CPU), plus the properties that
``tests/test_scattering.py`` holds the JAX model to, on the port.

Random draws differ between the packages (a ``torch.Generator`` is not a JAX
key), so the seed initialisations are compared on JAX's own normals, and the
synthesis on one Adam segment from the same state. The port's retirement
schedule is synchronous where JAX's is pipelined (see
``shadowing_tpu_torch/models/scattering/synthesis.py``), so whole runs are
held to properties, not to JAX's trajectories. Tolerances are stated per
test; every one is a float32 tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import kurtosis

import shadowing_tpu as J
import shadowing_tpu_torch as P
from shadowing_tpu.cli import ingest_prices as jax_ingest
from shadowing_tpu.cli import make_bundled_snp as jax_bundle
from shadowing_tpu.models.scattering import moments as jax_mom
from shadowing_tpu.models.scattering import synthesis as jax_syn
from shadowing_tpu.models.scattering import wavelets as jax_wav
from shadowing_tpu_torch.cli import batch_generations, ingest_prices
from shadowing_tpu_torch.cli import make_bundled_snp, snp_generation
from shadowing_tpu_torch.models import mrw as port_mrw
from shadowing_tpu_torch.models.scattering import moments as mom
from shadowing_tpu_torch.models.scattering import synthesis as syn

#: statistics: float32 FFTs in another order
STATS_ATOL, STATS_RTOL = 1e-5, 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def standardized(x):
    x = np.asarray(x, np.float32)
    return (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)


def stats(x, J_, bank=None):
    """Batch-averaged statistics of ``x`` through the port, as numpy."""
    bank = bank or P.build_filter_bank(np.shape(x)[-1], J_)
    return P.scattering_stats(np.asarray(x, np.float32), bank).numpy()


def white_target(rng, T, J_, n=64):
    bank = P.build_filter_bank(T, J_)
    return stats(standardized(rng.normal(size=(n, T))), J_, bank), bank


# -- parity with the JAX package ----------------------------------------------

@pytest.mark.parametrize("T,J_", [(512, 5), (1024, 6), (1500, 5)])
def test_filter_bank_equals_jax(T, J_):
    a, b = P.build_filter_bank(T, J_), jax_wav.build_filter_bank(T, J_)
    np.testing.assert_array_equal(a.psi_hat, b.psi_hat)
    np.testing.assert_array_equal(a.phi_hat, b.phi_hat)
    assert a.band_hi == b.band_hi and (a.J, a.T) == (b.J, b.T)
    with pytest.raises(ValueError):
        P.build_filter_bank(128, 9)


@pytest.mark.parametrize("J_", [1, 2, 5, 9])
def test_index_helpers_equal_jax(J_):
    for name in ("_index_pairs", "_index_triples"):
        for a, b in zip(getattr(mom, name)(J_), getattr(jax_mom, name)(J_)):
            np.testing.assert_array_equal(a, b)
    assert mom.n_stats(J_) == jax_mom.n_stats(J_)
    np.testing.assert_array_equal(mom._pair_perm(J_), jax_mom._pair_perm(J_))
    np.testing.assert_array_equal(mom._trip_perm(J_), jax_mom._trip_perm(J_))


@pytest.mark.parametrize("B,T,J_", [(4, 512, 5), (4, 1500, 5)])
def test_stats_flat_equal_jax(rng, B, T, J_):
    """Both the band-limited contractions (``bands``) and the full-width
    ones, on heavy-tailed input: atol 1e-5, rtol 1e-4."""
    bank = P.build_filter_bank(T, J_)
    x = rng.standard_t(4, size=(B, T)).astype(np.float32)
    for bands in (bank.band_hi, None):
        want = np.asarray(jax_mom._scattering_stats_flat(
            jnp.asarray(x), jnp.asarray(bank.psi_hat), J=J_, use_mm=False,
            bands=bands))
        got = mom._scattering_stats_flat(t(x), t(bank.psi_hat), J_, bands)
        assert got.shape == (B, mom.n_stats(J_)) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=STATS_ATOL,
                                   rtol=STATS_RTOL)


def heavy_target(rng, T, J_, n=32):
    bank = P.build_filter_bank(T, J_)
    g = rng.normal(size=(n, T))
    return stats(standardized(g * np.exp(rng.normal(size=(n, T)) * 0.5)), J_,
                 bank), bank


@pytest.mark.parametrize("standardize", [False, True])
def test_loss_gradient_equals_jax_grad(rng, standardize):
    """``torch.autograd.grad`` through fft, ifft and complex abs against
    ``jax.grad``: within 1e-5 + 1e-3 max|g|."""
    T, J_ = 512, 5
    target, bank = heavy_target(rng, T, J_)
    z = rng.normal(size=(4, T)).astype(np.float32)
    psi = jnp.asarray(bank.psi_hat)

    def loss(z):
        zs = jax_syn._standardize(z) if standardize else z
        s = jax_mom._scattering_stats_flat(zs, psi, J=J_, use_mm=False,
                                           bands=bank.band_hi)
        return ((s - target[None]) ** 2).mean(-1).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(z)))
    got = syn._loss_grad(t(z), t(target), t(bank.psi_hat), J_, bank.band_hi,
                         standardize).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 + 1e-3 * np.abs(want).max())


def test_adam_segment_equals_jax(rng):
    """Five Adam steps from the same (z, m, v, i0) under the cosine lr:
    per-seed losses within rtol 1e-3, z within 1e-4 on >= 99.9 % of the
    entries (a coordinate whose gradient is float noise may step another
    way; the max difference is printed, 1.9e-6 on this input)."""
    T, J_, B = 512, 5, 4
    target, bank = heavy_target(rng, T, J_)
    z = rng.normal(size=(B, T)).astype(np.float32)
    m = (rng.normal(size=(B, T)) * 1e-3).astype(np.float32)
    v = (np.abs(rng.normal(size=(B, T))) * 1e-6).astype(np.float32)
    lr = syn.default_lr_schedule(300)
    assert lr == jax_syn.default_lr_schedule(300)
    zj, mj, vj, lj = jax_syn._optimize_segment(
        jnp.asarray(z), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(10.0, jnp.float32), jnp.asarray(target),
        jnp.asarray(bank.psi_hat), J=J_, n_steps=5, lr=lr,
        bands=bank.band_hi, standardize=True, use_mm=False)
    zp, mp, vp, lp = syn._optimize_segment(
        t(z), t(m), t(v), 10, t(target), t(bank.psi_hat), J_, 5, lr,
        bank.band_hi, True)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=1e-3)
    diff = np.abs(zp.numpy() - np.asarray(zj))
    print(f"max |z_port - z_jax| after 5 steps: {diff.max():.3e}")
    assert (diff <= 1e-4).mean() >= 0.999
    np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(mj)).max())
    for step in (1, 150, 400):
        assert syn._lr_at(lr, step) == pytest.approx(
            float(jax_syn._lr_at(lr, jnp.float32(step))), rel=1e-6)


def test_colour_filter_equals_jax(rng):
    T, J_ = 1024, 6
    bank = P.build_filter_bank(T, J_)
    x = rng.normal(size=(32, T)).astype(np.float32)
    for i in range(1, T):                     # a red, AR(1)-like spectrum
        x[:, i] += 0.8 * x[:, i - 1]
    target = stats(standardized(x), J_, bank)
    want = np.asarray(jax_syn._colour_filter(jnp.asarray(target),
                                             jnp.asarray(bank.psi_hat), J_))
    got = syn._colour_filter(t(target), t(bank.psi_hat), J_).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("init", ["coloured", "auto"])
def test_seeds_from_jax_normals(rng, init):
    """The port's seed builders fed the normals JAX draws from the same key
    (coloured base from the first split; the envelope's real and imaginary
    parts from the second): each seed picks the same candidate, and the
    values agree within 1e-4."""
    T, J_, B = 1024, 5, 8
    target, bank = heavy_target(rng, T, J_)
    psi_j, psi_p = jnp.asarray(bank.psi_hat), t(bank.psi_hat)
    key = jax.random.PRNGKey(5)
    if init == "coloured":
        want = np.asarray(jax_syn._coloured_noise(key, B, T,
                                                  jnp.asarray(target), psi_j, J_))
        z = t(jax.random.normal(key, (B, T), jnp.float32))
        got = syn._coloured_from_normals(z, t(target), psi_p, J_).numpy()
        np.testing.assert_allclose(got.std(-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(got, want, atol=1e-4)
        return
    want = np.asarray(jax_syn._auto_seeds(key, B, T, jnp.asarray(target), psi_j,
                                          J=J_, bands=bank.band_hi))
    k1, k2 = jax.random.split(key)
    kr, ki = jax.random.split(k2)
    sq = np.stack([port_mrw._circulant_sqrt_spectrum(port_mrw._omega_cov(T, lam, T))
                   for lam in syn._INIT_LAMBDAS if lam > 0])
    z = t(jax.random.normal(k1, (B, T), jnp.float32))
    zr, zi = (t(jax.random.normal(k, (B, sq.shape[-1]))) for k in (kr, ki))
    sq_oms = torch.as_tensor(sq, dtype=torch.float32)
    got = syn._calibrated_from_normals(z, zr, zi, t(target), psi_p, J_, sq_oms,
                                       bank.band_hi).numpy()
    zc = syn._coloured_from_normals(z, t(target), psi_p, J_)
    cands = np.stack([zc.numpy()] + [syn._standardize(zc * torch.exp(
        port_mrw._stationary_from_normals(zr, zi, s, T))).numpy() for s in sq_oms])

    def picks(out):
        return np.abs(cands - out[None]).max(-1).argmin(0)

    np.testing.assert_array_equal(picks(got), picks(want))
    assert (picks(got) > 0).any()             # the envelope candidates win
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_analyze_equals_jax(rng):
    """Within the statistics' tolerance, raw mean and variance restored."""
    dlnx = rng.standard_t(5, size=3000) * 0.01 + 4e-4
    a, b = P.analyze(dlnx, J=6), J.analyze(dlnx, J=6)
    np.testing.assert_allclose(a.flat, b.flat, atol=STATS_ATOL, rtol=STATS_RTOL)
    assert a.T == b.T == 3000
    assert a.variance == pytest.approx(dlnx.var(), rel=1e-3)
    assert a.mean == pytest.approx(dlnx.mean(), rel=1e-2)
    np.testing.assert_allclose(a.flatness(), b.flatness(), rtol=1e-4)
    np.testing.assert_allclose(a.phase_envelope(), b.phase_envelope(),
                               atol=STATS_ATOL)
    np.testing.assert_allclose(a.envelope_correlation(),
                               b.envelope_correlation(), atol=STATS_ATOL)
    snp = P.SPDaily(start="03-01-2000", end="31-12-2014")
    np.testing.assert_array_equal(P.analyze(snp, J=4).flat,
                                  P.analyze(snp.dlnx, J=4).flat)


# -- properties of the statistics (tests/test_scattering.py, on the port) -----

@pytest.mark.parametrize("case", ["white", "flatness", "heavy", "oracle",
                                  "leverage"])
def test_stats_properties(rng, case):
    if case in ("white", "flatness"):
        x = standardized(rng.normal(size=(64, 1024)))
        st = P.ScatteringStats(J=5, flat=stats(x, 5))
        if case == "white":
            # white noise: phi3 ~ 0, phi4 ~ 0, sparsity ~ pi/4, mean t-stat
            # ~ 0, logvar ~ 0
            assert abs(st.mean) < 0.2 and abs(np.log(st.variance)) < 0.05
            np.testing.assert_allclose(st.sparsity(), np.pi / 4, atol=0.05)
            assert np.abs(st.phase_envelope()).max() < 0.1
            assert np.abs(st.envelope_correlation()).max() < 0.1
        else:
            np.testing.assert_allclose(st.flatness(), 2.0, atol=0.25)
    elif case == "heavy":
        s_g = P.ScatteringStats(4, stats(rng.normal(size=(32, 1024)), 4))
        s_h = P.ScatteringStats(4, stats(rng.standard_t(3, size=(32, 1024)), 4))
        # intermittent signals are sparser: lower <|W|>^2/<|W|^2>
        assert (s_h.sparsity() < s_g.sparsity() - 0.03).all()
    elif case == "oracle":
        # the Parseval forms equal the defining time-domain correlations,
        # computed brute force in float64
        T, J_ = 256, 4
        bank = P.build_filter_bank(T, J_)
        x = rng.standard_t(5, size=(2, T)).astype(np.float32)
        flat = P.scattering_stats(x, bank, average=False).numpy()
        psi = bank.psi_hat
        xc = (x - x.mean(-1, keepdims=True)).astype(np.float64)
        w = np.fft.ifft(np.fft.fft(xc, axis=-1)[:, None] * psi[None], axis=-1)
        env = np.abs(w)
        sig = np.sqrt((env**2).mean(-1))
        ef = np.fft.fft(env - env.mean(-1, keepdims=True), axis=-1)
        we = np.fft.ifft(ef[:, :, None, :] * psi[None, None], axis=-1)
        sl = P.ScatteringStats(J_, flat[0])._slices()
        ia, ib = mom._index_pairs(J_)
        phi3 = (we[:, ia, ib] * np.conj(w[:, ib])).mean(-1)
        phi3 /= sig[:, ia] * sig[:, ib]
        ta, tb, tc = mom._index_triples(J_)
        phi4 = (we[:, ta, tc] * np.conj(we[:, tb, tc])).mean(-1)
        phi4 /= sig[:, ta] * sig[:, tb]
        for name, want in (("phi3", phi3), ("phi4", phi4)):
            np.testing.assert_allclose(flat[:, sl[name + "_re"]], want.real,
                                       rtol=2e-4, atol=1e-6)
            np.testing.assert_allclose(flat[:, sl[name + "_im"]], want.imag,
                                       rtol=2e-4, atol=1e-6)
    else:
        # sign-vol correlation (leverage) gives a clearly larger |phi3| than
        # its sign-symmetric surrogate
        n, T = 32, 1024
        eps = rng.normal(size=(n, T))
        vol = np.ones((n, T))
        for i in range(1, T):
            vol[:, i] = 0.9 * vol[:, i - 1] + 0.4 * np.maximum(-eps[:, i - 1], 0) + 0.1
        lev = eps * vol
        sym = rng.choice([-1, 1], size=(n, T)) * np.abs(lev)
        p3 = [np.abs(P.ScatteringStats(5, stats((a - a.mean()) / a.std(), 5))
                     .phase_envelope()).max() for a in (lev, sym)]
        assert p3[0] > 2 * p3[1]


# -- synthesis ------------------------------------------------------------------

def test_converges_to_gaussian_target_with_standardized_output(rng):
    """Towards white-noise statistics the mismatch falls fast; with the
    z-scored target the in-loss projection is on, so the output is exactly
    per-seed standardized and the rms describes it."""
    T, J_ = 512, 4
    target, bank = white_target(rng, T, J_)
    assert syn.should_standardize(target)
    assert not syn.should_standardize(np.r_[0.5, target[1:]])
    wl = {}
    z, rms = syn.synthesize_batch(gen(0), target, bank, batch=8,
                                  max_iterations=300, tol=0.03, segment=100,
                                  work_log=wl)
    assert z.shape == (8, T) and z.dtype == torch.float32
    assert np.median(rms) < 0.05 and (rms < 0.03).all()
    assert wl["steps"] == 100 and wl["seed_steps"] == 800
    assert wl["t_loop_s"] >= wl["t_init_s"] >= 0
    z = z.numpy()
    np.testing.assert_allclose(z.mean(-1), 0.0, atol=1e-6)
    np.testing.assert_allclose(z.std(-1), 1.0, atol=1e-5)
    s = mom._scattering_stats_flat(t(z), t(bank.psi_hat), J_).numpy()
    rms_check = np.sqrt(((s - target[None]) ** 2).mean(-1))
    np.testing.assert_allclose(rms_check, rms, rtol=2e-2, atol=2e-4)


def test_active_rows_step_equals_direct_step(rng):
    """Stepping the active rows of the full state equals stepping those rows
    as a batch of their own, bit for bit on the CPU, and leaves the retired
    rows untouched bit for bit."""
    T, J_ = 256, 4
    target, bank = white_target(rng, T, J_, n=16)
    kw = dict(target=t(target), psi_hat=t(bank.psi_hat), J=J_, lr=0.03,
              bands=bank.band_hi, standardize=True)
    z0 = torch.from_numpy(rng.normal(size=(8, T)).astype(np.float32))
    m0, v0 = torch.zeros_like(z0), torch.zeros_like(z0)
    active = np.array([1, 4, 6])
    zd, md, vd, ld = syn._optimize_segment(z0[active], m0[active], v0[active],
                                           10, n_steps=5, **kw)
    z, m, v, losses = syn._step_active(z0.clone(), m0.clone(), v0.clone(),
                                       active, 10, 5, **kw)
    for a, b in ((z[active], zd), (m[active], md), (v[active], vd),
                 (losses, ld)):
        assert torch.equal(a, b)
    retired = np.setdiff1d(np.arange(8), active)
    for a, b in ((z, z0), (m, m0), (v, v0)):
        assert torch.equal(a[retired], b[retired])
    assert not torch.equal(z[active], z0[active])


def test_resume_reproduces_uninterrupted_run(rng, tmp_path, monkeypatch):
    """A run interrupted after its first checkpoint and resumed returns
    bit-identical series and rms, retirement schedule included; the
    checkpoint holds the JAX package's keys and is deleted at the end."""
    T, J_ = 256, 4
    target, bank = white_target(rng, T, J_, n=32)
    kw = dict(target=target, bank=bank, batch=8, tol=0.002, segment=40,
              max_iterations=200)
    wl_ref = {}
    z_ref, rms_ref = syn.synthesize_batch(gen(5), work_log=wl_ref, **kw)
    assert wl_ref["seed_steps"] < 8 * wl_ref["steps"]   # seeds retired
    ck = tmp_path / "state.ckpt.npz"

    class Stop(Exception):
        pass

    orig = syn._optimize_segment

    def wrapped(*a, **k):
        if ck.exists():
            assert set(np.load(ck).files) == {"z", "m", "v", "done", "active",
                                              "rms_full"}
            raise Stop()
        return orig(*a, **k)

    monkeypatch.setattr(syn, "_optimize_segment", wrapped)
    with pytest.raises(Stop):
        syn.synthesize_batch(gen(5), **kw, checkpoint_path=ck,
                             checkpoint_min_interval_s=0.0)
    monkeypatch.undo()
    assert ck.exists()
    z_res, rms_res = syn.synthesize_batch(gen(5), **kw, checkpoint_path=ck,
                                          checkpoint_min_interval_s=0.0)
    assert torch.equal(z_res, z_ref)
    np.testing.assert_array_equal(rms_res, rms_ref)
    assert not ck.exists()
    # a zero budget evaluates the losses only
    z0, rms0 = syn.synthesize_batch(gen(5), **{**kw, "max_iterations": 0})
    assert np.isfinite(rms0).all() and (rms0 > rms_ref).all()


def test_bad_init_raises(rng):
    target, bank = white_target(rng, 256, 4, n=4)
    with pytest.raises(ValueError, match="init"):
        syn.synthesize_batch(gen(0), target, bank, batch=4, max_iterations=10,
                             init="pink")


# -- generate ---------------------------------------------------------------------

def test_generate_partial_last_shard_and_cache(rng, tmp_path):
    """R not a multiple of batch: the kept rows equal the untruncated
    run's (row content cannot depend on R); a second call is served from
    the cache, whose tag includes the device type."""
    dlnx = rng.normal(0, 0.01, size=1024)
    kw = dict(J=4, T=256, max_iterations=40, seed=5, batch=4, device="cpu")
    logs = []
    a = P.generate(dlnx, R=6, cache_path=tmp_path, shard_logs=logs, **kw)
    b = P.generate(dlnx, R=8, **kw)
    assert a.shape == (6, 1, 256) and b.shape == (8, 1, 256)
    assert a.device.type == "cpu" and a.dtype == torch.float32
    assert torch.equal(a, b[:6])
    assert [sorted(x) for x in logs] == [
        ["rms", "seed_steps", "steps", "t_init_s", "t_loop_s", "wall_s"]] * 2
    shards = sorted(tmp_path.glob("scatgen_*/shard*.npy"))
    assert len(shards) == 2 and not list(tmp_path.glob("scatgen_*/*.npz"))
    logs = []
    again = P.generate(dlnx, R=6, cache_path=tmp_path, shard_logs=logs, **kw)
    assert torch.equal(again, a) and all(x["from_cache"] for x in logs)
    assert not torch.equal(P.generate(dlnx, R=4, **{**kw, "seed": 6}), b[:4])


def test_generate_matches_target_flatness_and_tails(rng):
    """Heavy-tailed target: the generated series inherit its scale, its
    per-scale envelope flatness (within 35 %) and fat tails."""
    x = rng.standard_t(4, size=4000) * 0.01
    out = P.generate(x, R=8, J=5, T=1024, tol_optim=0.04, max_iterations=300,
                     seed=3, batch=8, device="cpu").numpy()
    assert out.shape == (8, 1, 1024) and np.isfinite(out).all()
    assert out.std() == pytest.approx(x.std(), rel=0.25)
    f_obs = P.analyze(x, J=5).flatness()
    f_gen = P.analyze(out.ravel(), J=5).flatness()
    np.testing.assert_allclose(f_gen, f_obs, rtol=0.35)
    assert (f_gen > 2.3).any()
    assert kurtosis(out.ravel()) > 1.0


# -- the CLI ------------------------------------------------------------------------

def test_snp_generation_job_array_and_batching(tmp_path, capsys):
    """Two tasks of a job array at a tiny size, the restart skip, the
    regrouping, and the load through ``TimeSeriesDataset``."""
    cache, batched = tmp_path / "gen", tmp_path / "batched"
    args = ["-ntot", "2", "-R", "8", "-J", "4", "-T", "256", "--batch", "4",
            "--max-iterations", "30", "--cache", str(cache), "--device",
            "cpu", "-q"]
    for tid in ("0", "1"):
        snp_generation.main(args + ["-tid", tid])
        assert capsys.readouterr().out.rstrip().endswith("FINISHED")
    assert sorted(p.name for p in cache.glob("*.npy")) == [
        "task00000_R4.npy", "task00001_R4.npy"]
    snp_generation.main(args + ["-tid", "0"])
    out = capsys.readouterr().out
    assert "already exists — skipping" in out and out.rstrip().endswith(
        "FINISHED")
    with pytest.raises(SystemExit):
        snp_generation.main(args + ["-tid", "2"])
    batch_generations.main(["--input", str(cache), "--output", str(batched)])
    assert "wrote 1 shards" in capsys.readouterr().out
    data = P.TimeSeriesDataset(batched).load()
    assert data.shape == (8, 1, 256) and np.isfinite(data).all()
    assert not np.array_equal(data[:4], data[4:])
    assert data.std() == pytest.approx(
        P.SPDaily(start="03-01-2000", end="31-12-2014").dlnx.std(), rel=0.1)


@pytest.mark.parametrize("case", ["iso", "dayfirst", "duplicate", "negative",
                                  "missing"])
def test_ingest_csv_equals_jax(tmp_path, case):
    rows = [("2014-01-03", "101.5"), ("2014-01-02", "100.0"),
            ("2014-01-06", "99.25"), ("2014-01-07", "102.0")]
    dayfirst = case == "dayfirst"
    if dayfirst:
        rows = [(f"{d[8:]}/{d[5:7]}/{d[:4]}", c) for d, c in rows]
    if case == "duplicate":
        rows.append(rows[0])
    elif case == "negative":
        rows[2] = (rows[2][0], "-1")
    elif case == "missing":
        rows[2] = (rows[2][0], "")
    csv = tmp_path / "prices.csv"
    csv.write_text("Date, Close\n" + "".join(f"{d},{c}\n" for d, c in rows))
    outs = {}
    for name, mod in (("port", ingest_prices), ("jax", jax_ingest)):
        out = tmp_path / f"{name}.npz"
        if case in ("iso", "dayfirst"):
            outs[name] = np.load(mod.ingest_csv(csv, out, dayfirst=dayfirst,
                                                close_col="close"))
        else:
            with pytest.raises(ValueError):
                mod.ingest_csv(csv, out, dayfirst=dayfirst)
    if outs:
        for key in ("dlnx", "days", "x_init"):
            np.testing.assert_array_equal(outs["port"][key], outs["jax"][key])
        assert outs["port"]["days"].dtype == np.int64
        with pytest.raises(ValueError, match="column"):
            ingest_prices.ingest_csv(csv, tmp_path / "x.npz", close_col="adj")


def test_make_bundled_snp_equals_jax(tmp_path):
    """The simulation equals the JAX package's for a fixed seed, and the
    one-off script rebuilds the bundled arrays exactly."""
    np.testing.assert_array_equal(
        make_bundled_snp.simulate(300, np.random.default_rng(3)),
        jax_bundle.simulate(300, np.random.default_rng(3)))
    out = make_bundled_snp.main(out=tmp_path / "snp_daily.npz")
    got, want = np.load(out), np.load(make_bundled_snp.OUT)
    for key in ("dlnx", "days", "x_init"):
        np.testing.assert_array_equal(got[key], want[key])
