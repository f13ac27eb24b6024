"""The port's search routes beyond the kernel route — fused, float64 rescore,
row-sliced engines, padded predict — plus ``windows`` and the profiling
helpers, against the JAX package on the same numpy inputs (CPU).

Tolerances: winner ids and paths are compared exactly; float32 distances at
1e-6 relative (the exact rescore of both packages sums the same products in
another order); float64 rescored distances at 1e-12 relative."""
import numpy as np
import pytest
import torch

import shadowing_tpu as J
import shadowing_tpu_torch as P
from shadowing_tpu.utils import profiling as jax_profiling
from shadowing_tpu_torch.data.windows import n_windows
from shadowing_tpu_torch.ops import search as search_ops
from shadowing_tpu_torch.shadow import engine as port_engine
from shadowing_tpu_torch.utils import profiling

H = 16


def pair(emb_name, emb_args, dist, ds, ctx_j, ctx_p):
    """The same engine in both packages."""
    return (J.PathShadowing(getattr(J, emb_name)(*emb_args), getattr(J, dist)(),
                            ds, ctx_j),
            P.PathShadowing(getattr(P, emb_name)(*emb_args), getattr(P, dist)(),
                            ds, ctx_p, device="cpu"))


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(5)
    return rng.normal(0, 0.02, size=(64, 1, 512)).astype(np.float32)


# -- windows ------------------------------------------------------------------

@pytest.mark.parametrize("w,s,offset", [(5, 1, 0), (7, 3, 2), (40, 40, 0)])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_windows_match_jax(rng, w, s, offset, kind):
    x = rng.normal(size=(2, 3, 100))
    want = J.windows(x, w=w, s=s, offset=offset)
    assert want.shape == (2, 3, n_windows(100, w, s, offset), w)
    got = P.windows(torch.from_numpy(x) if kind == "torch" else x, w=w, s=s,
                    offset=offset)
    assert isinstance(got, torch.Tensor if kind == "torch" else np.ndarray)
    np.testing.assert_array_equal(P.as_numpy(got), want)
    with pytest.raises(ValueError, match="no complete window"):
        P.windows(x, w=101, s=1)


# -- fused route ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["cosine-B1", "cosine-B3", "foveal-400",
                                  "gapped-identity"])
def test_fused_matches_jax_and_direct(ds, case):
    """Cosine (no kernel score form), a Foveal filter wider than MAX_WIDTH
    and the imputation gap's zero taps: the port's fused route returns the
    JAX fused route's winners and the port's direct oracle's."""
    rng = np.random.default_rng(len(case))
    if case.startswith("cosine"):
        B = int(case[-1])
        jax_eng, eng = pair("Identity", (20,), "CosineDistance", ds,
                            J.PredictionContext(H), P.PredictionContext(H))
        ctx = rng.normal(0, 0.02, size=(B, 1, 20)).astype(np.float32)
    elif case == "foveal-400":
        jax_eng, eng = pair("Foveal", (1.15, 0.9, 400), "RelativeMSE", ds,
                            J.PredictionContext(H), P.PredictionContext(H))
        ctx = rng.normal(0, 0.02, size=(2, 1, 400)).astype(np.float32)
        assert eng.embedding.dim == 42
    else:
        jax_eng, eng = pair("Identity", (16,), "RelativeMSE", ds,
                            J.ImputationContext((8, 6, 8)),
                            P.ImputationContext((8, 6, 8)))
        ctx = rng.normal(0, 0.02, size=(3, 1, 16)).astype(np.float32)
    d_f, p_f, i_f = eng.shadow(ctx, k=24, method="fused")
    assert eng.last_metrics["method"] == "fused"
    d_j, p_j, i_j = jax_eng.shadow(ctx, k=24, method="fused")
    d_d, p_d, i_d = eng.shadow(ctx, k=24, method="direct")
    for d_ref, p_ref, i_ref in ((d_j, p_j, i_j), (d_d, p_d, i_d)):
        np.testing.assert_array_equal(i_f, i_ref)
        np.testing.assert_array_equal(p_f, p_ref)
        # 1 - cos rounds to quanta of ~6e-8 near cos = 1
        np.testing.assert_allclose(d_f, d_ref, rtol=1e-6, atol=1e-7)
    assert (np.diff(d_f, axis=1) >= 0).all()


def test_fused_tie_order_is_canonical(monkeypatch):
    """Duplicated trajectories tie bit-exactly: fused, kernel and direct
    return the same (distance, flat id) order as the JAX fused route."""
    monkeypatch.setenv("SHADOWING_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(0)
    ds = rng.normal(0, 0.02, size=(32, 1, 256)).astype(np.float32)
    ds[17] = ds[3]
    ds[29] = ds[3]
    ctx = ds[[3], :, 40:64]
    jax_eng, eng = pair("Identity", (24,), "RelativeMSE", ds,
                        J.PredictionContext(H), P.PredictionContext(H))
    d_j, _, i_j = jax_eng.shadow(ctx, k=60, method="fused")
    d_f, _, i_f = eng.shadow(ctx, k=60, method="fused")
    np.testing.assert_array_equal(i_f, i_j)
    np.testing.assert_allclose(d_f, d_j, rtol=1e-6)
    for method in ("kernel", "direct"):
        d, _, i = eng.shadow(ctx, k=60, method=method)
        np.testing.assert_array_equal(d, d_f)
        np.testing.assert_array_equal(i, i_f)
    n_out = 256 - 24 - H + 1
    flat = i_j[0, :, 0].astype(np.int64) * n_out + i_j[0, :, 1]
    dup = d_j[0][1:] == d_j[0][:-1]
    assert dup.any() and (np.diff(flat)[dup] > 0).all()


def test_auto_routing_and_fused_split_invariance(ds, monkeypatch):
    rng = np.random.default_rng(1)
    ctx = rng.normal(0, 0.02, size=(2, 1, 400)).astype(np.float32)
    eng = P.PathShadowing(P.Foveal(1.15, 0.9, 400), P.RelativeMSE(), ds,
                          P.PredictionContext(H), device="cpu")
    ref = eng.shadow(ctx, k=30)
    assert eng.last_metrics["method"] == "fused"
    assert any(s.startswith("kernel declined: filter width 400")
               for s in eng.routing_log), eng.routing_log
    for n_splits in (1, 7, 64):
        for a, b in zip(ref, eng.shadow(ctx, k=30, n_splits=n_splits,
                                        method="fused")):
            np.testing.assert_array_equal(a, b)
    # the fused per-window byte count: no embedding, 1 + 8 B floats
    monkeypatch.setattr(port_engine, "_memory_budget", lambda device: 1 << 20)
    n_out = 512 - 400 - H + 1
    assert eng._auto_splits(4, n_out, 42, "fused") == -(
        -64 * 4 * n_out * 33 // (1 << 20))
    assert eng._auto_splits(4, n_out, 42) > eng._auto_splits(4, n_out, 42,
                                                             "fused")
    monkeypatch.undo()

    class Plain(P.PathDistance):
        def forward(self, x, y):
            return P.MSE().forward(x, y)

    plain = P.PathShadowing(P.Identity(20), Plain(), ds,
                            P.PredictionContext(H), device="cpu")
    _, _, i = plain.shadow(ctx[:, :, :20], k=5)
    assert plain.last_metrics["method"] == "direct"
    _, _, i_mse = P.PathShadowing(P.Identity(20), P.MSE(), ds,
                                  P.PredictionContext(H),
                                  device="cpu").shadow(ctx[:, :, :20], k=5)
    np.testing.assert_array_equal(i, i_mse)
    with pytest.raises(ValueError, match="expansion distance"):
        plain.shadow(ctx[:, :, :20], k=5, method="fused")


# -- float64 rescore ------------------------------------------------------------

def f64_oracle(ds, ctx, kernel, n_out, dist):
    """Float64 distances of every window ``(B, R * n_out)``."""
    w = kernel.shape[-1]
    win = np.lib.stride_tricks.sliding_window_view(
        ds.astype(np.float64), w, axis=-1)[:, :, :n_out]      # (R, C, n, w)
    e = np.einsum("rcnw,dcw->rnd", win, kernel.astype(np.float64))
    x = np.einsum("bcw,dcw->bd", ctx.astype(np.float64),
                  kernel.astype(np.float64))
    return dist.forward_host(x[:, None, None, :], e[None]).reshape(len(ctx), -1)


@pytest.mark.parametrize("emb", ["Identity", "Foveal"])
def test_float64_matches_jax_and_a_float64_oracle(ds, emb):
    rng = np.random.default_rng(2)
    args = (24,) if emb == "Identity" else (1.15, 0.9, 24)
    jax_eng, eng = pair(emb, args, "RelativeMSE", ds, J.PredictionContext(H),
                        P.PredictionContext(H))
    ctx = rng.normal(0, 0.02, size=(4, 1, 24)).astype(np.float32)
    d, p, i = eng.shadow(ctx, k=50, exact_dtype="float64")
    assert d.dtype == np.float64 and p.dtype == np.float32
    assert (np.diff(d, axis=1) >= 0).all()
    assert eng.last_metrics["exact_dtype"] == "float64"
    d_j, p_j, i_j = jax_eng.shadow(ctx, k=50, exact_dtype="float64")
    np.testing.assert_array_equal(i, i_j)
    np.testing.assert_array_equal(p, p_j)
    np.testing.assert_allclose(d, d_j, rtol=1e-12)
    n_out = 512 - 24 - H + 1
    full = f64_oracle(ds, ctx, eng.embedding.kernel, n_out, eng.distance)
    flat = i[..., 0].astype(np.int64) * n_out + i[..., 1]
    np.testing.assert_allclose(np.take_along_axis(full, flat, axis=1), d,
                               rtol=1e-12)
    np.testing.assert_allclose(d, np.sort(full, axis=1)[:, :50], rtol=1e-6)
    for b in (0, 3):
        r, t0 = i[b, 0]
        np.testing.assert_array_equal(p[b, 0], ds[r, :, t0 : t0 + 24 + H])
    # the float32 route returns the same winners up to reordering
    _, _, i32 = eng.shadow(ctx, k=50)
    for b in range(4):
        assert set(map(tuple, i32[b])) == set(map(tuple, i[b]))


def test_bad_exact_dtype(ds):
    eng = P.PathShadowing(P.Identity(24), P.RelativeMSE(), ds,
                          P.PredictionContext(H), device="cpu")
    with pytest.raises(ValueError, match="exact_dtype"):
        eng.shadow(ds[:1, :, :24], k=4, exact_dtype="bf16")


# -- row-sliced engines -----------------------------------------------------------

@pytest.mark.parametrize("cuts,k", [((25, 40), 20), ((30,), 20), ((3,), 400)])
def test_shadow_sharded_rows(rng, cuts, k):
    """Exact merge and trajectory-id offsets, against one engine and the JAX
    helper; k=400 exceeds the 3-row slice's 315 candidates."""
    from shadowing_tpu.shadow.engine import shadow_sharded_rows as jax_rows

    ds = rng.normal(0, 0.02, size=(60, 1, 128)).astype(np.float32)
    ctx = rng.normal(0, 0.02, size=(2, 1, 16)).astype(np.float32)
    bounds = [0, *cuts, 60]
    mk_p = lambda a: P.PathShadowing(P.Identity(16), P.RelativeMSE(), a,
                                     P.PredictionContext(8), device="cpu")
    mk_j = lambda a: J.PathShadowing(J.Identity(16), J.RelativeMSE(), a,
                                     J.PredictionContext(8))
    slices = [ds[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    got = P.shadow_sharded_rows([mk_p(s) for s in slices], ctx, k=k)
    want = mk_p(ds).shadow(ctx, k=k)
    jax_got = jax_rows([mk_j(s) for s in slices], ctx, k=k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], jax_got[0], rtol=1e-6)
    np.testing.assert_array_equal(got[1], jax_got[1])
    np.testing.assert_array_equal(got[2], jax_got[2])
    with pytest.raises(ValueError, match="at least one engine"):
        P.shadow_sharded_rows([], ctx, k=k)
    with pytest.raises(ValueError, match="total candidates"):
        P.shadow_sharded_rows([mk_p(slices[0])], ctx, k=60 * 105 + 1)


# -- predict padding --------------------------------------------------------------

def test_predict_pads_the_remainder_chunk(ds, monkeypatch):
    """25 contexts in 3 chunks: chunks of 9, 9 and 7 padded to 9, so every
    chunk takes the factored route (B >= 8) and never the Toeplitz one."""
    rng = np.random.default_rng(3)
    ctx = rng.normal(0, 0.02, size=(25, 1, 20)).astype(np.float32)
    jax_eng, eng = pair("Identity", (20,), "RelativeMSE", ds,
                        J.PredictionContext(H), P.PredictionContext(H))
    calls = []
    orig = search_ops.two_pass_search
    monkeypatch.setattr(search_ops, "two_pass_search",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    f_p = lambda x: P.realized_variance(x[:, :, 0, :], [4, 16])
    a, s = eng.predict(ctx, k=32, to_predict=f_p, eta=0.3, n_context_splits=3)
    assert a.shape == s.shape == (25, 2)
    assert calls == [] and eng._E is not None
    assert eng.last_metrics["n_context_chunks"] == 3
    a_j, s_j = jax_eng.predict(
        ctx, k=32, to_predict=lambda x: J.realized_variance(x[:, :, 0, :],
                                                            [4, 16]),
        eta=0.3, n_context_splits=3)
    np.testing.assert_allclose(a, a_j, rtol=1e-5)
    np.testing.assert_allclose(s, s_j, rtol=1e-5)
    a1, _ = eng.predict(torch.from_numpy(ctx), k=32, to_predict=f_p, eta=0.3)
    np.testing.assert_allclose(a, a1, rtol=1e-6)


# -- profiling ----------------------------------------------------------------------

def test_phase_timer_accumulates():
    profiling.reset_timings()
    jax_profiling.reset_timings()
    for mod, sync in ((profiling, torch.ones(3)), (jax_profiling, None)):
        for _ in range(2):
            with mod.phase_timer("unit", sync=sync, verbose=False):
                _ = np.arange(10).sum()
    t, t_j = profiling.timings(), jax_profiling.timings()
    assert t.keys() == t_j.keys() == {"unit"}
    assert t["unit"].keys() == t_j["unit"].keys()
    assert t["unit"]["count"] == 2
    assert t["unit"]["total_s"] >= t["unit"]["mean_s"]
    with profiling.phase_timer("cpu-device", sync="cpu", verbose=False):
        pass
    assert profiling.timings()["cpu-device"]["count"] == 1
    profiling.reset_timings()
    assert profiling.timings() == {}


@pytest.mark.parametrize("enabled", [False, True])
def test_device_trace(tmp_path, enabled):
    with profiling.device_trace(str(tmp_path / "trace"), enabled=enabled):
        torch.arange(16.0).sum()
    if enabled:
        assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    else:
        assert list(tmp_path.iterdir()) == []
