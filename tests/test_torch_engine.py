"""The port's engine as a whole, built from a JAX engine's state, against the
JAX engine on the same inputs (CPU; the port on its kernels' plain
versions, the JAX package's Pallas kernels in interpret mode)."""
import numpy as np
import pytest
import torch

import shadowing_tpu as J
import shadowing_tpu_torch as P
from shadowing_tpu_torch.convert import from_numpy_state
from shadowing_tpu_torch.ops import search as search_ops
from shadowing_tpu_torch.shadow import engine as port_engine

W, H = 24, 16


def numpy_state(eng) -> dict:
    """A JAX engine's state as plain Python and numpy values."""
    emb, ctx = eng.embedding, eng.context
    state = {
        "embedding": {"class": type(emb).__name__, "kernel": emb.kernel},
        "context": {"class": type(ctx).__name__},
        "distance": type(eng.distance).__name__,
        "dataset": np.asarray(eng.dataset),
    }
    for name in ("alpha", "beta", "max_context"):
        if hasattr(emb, name):
            state["embedding"][name] = getattr(emb, name)
    for name in ("horizon", "portion", "out_context_channels"):
        if hasattr(ctx, name):
            state["context"][name] = getattr(ctx, name)
    return state


def port_of(jax_eng):
    return from_numpy_state(numpy_state(jax_eng), "cpu")


@pytest.fixture(scope="module")
def data():
    """48 trajectories with a duplicated one (exact distance ties) and nine
    contexts cut from the dataset."""
    rng = np.random.default_rng(0)
    ds = rng.normal(0, 0.02, size=(48, 1, 300)).astype(np.float32)
    ds[11] = ds[2]
    starts = rng.integers(0, 200, size=9)
    ctx = np.stack([ds[(5 * i) % 48, :, s : s + W] for i, s in enumerate(starts)])
    ctx[1] += rng.normal(0, 0.005, size=ctx[1].shape).astype(np.float32)
    return ds, ctx


def embedding(name):
    return J.Identity(W) if name == "Identity" else J.Foveal(1.15, 0.9, W)


@pytest.mark.parametrize("emb", ["Identity", "Foveal"])
@pytest.mark.parametrize("B", [1, 9])
def test_slice_matches_jax(data, monkeypatch, emb, B):
    """B=1 takes the Toeplitz kernel, B=9 the factored one, on both sides."""
    monkeypatch.setenv("SHADOWING_TPU_PALLAS_INTERPRET", "1")
    ds, ctx = data
    jax_eng = J.PathShadowing(embedding(emb), J.RelativeMSE(), ds,
                              J.PredictionContext(H))
    eng = port_of(jax_eng)
    d_p, p_p, i_p = eng.shadow(ctx[:B], k=40, method="kernel")
    assert (eng._E is not None) == (B >= eng.FACTORED_MIN_B)
    d_j, p_j, i_j = jax_eng.shadow(ctx[:B], k=40, method="pallas")
    assert (jax_eng._factored is not None) == (B >= 8)
    d_d, p_d, i_d = jax_eng.shadow(ctx[:B], k=40, method="direct")
    for d_ref, p_ref, i_ref in ((d_j, p_j, i_j), (d_d, p_d, i_d)):
        np.testing.assert_array_equal(i_p, i_ref)
        np.testing.assert_array_equal(p_p, p_ref)
        np.testing.assert_allclose(d_p, d_ref, rtol=1e-6)
    d_o, p_o, i_o = eng.shadow(ctx[:B], k=40, method="direct")
    np.testing.assert_array_equal(i_o, i_p)
    np.testing.assert_array_equal(d_o, d_p)
    assert i_p.shape == (B, 40, 2) and p_p.shape == (B, 40, 1, W + H)


@pytest.mark.parametrize("B", [1, 9])
def test_predict_and_smile_matches_jax(data, B):
    ds, ctx = data
    Ts, Ms = [4, 8], np.linspace(-1, 1, 5)
    jax_eng = J.PathShadowing(J.Identity(W), J.RelativeMSE(), ds,
                              J.PredictionContext(H))
    eng = port_of(jax_eng)
    kw = dict(k=160, Ts=Ts, Ms=Ms, eta=0.3, eta_smile=0.5)
    a_j, s_j, sm_j = jax_eng.predict_and_smile(
        ctx[:B], to_predict=lambda x: J.realized_variance(x[:, :, 0, :], Ts),
        **kw)
    a_p, s_p, sm_p = eng.predict_and_smile(
        ctx[:B], to_predict=lambda x: P.realized_variance(x[:, :, 0, :], Ts),
        **kw)
    np.testing.assert_allclose(a_p, a_j, rtol=1e-5)
    np.testing.assert_allclose(s_p, s_j, rtol=1e-5)
    assert len(sm_p) == B
    for a, b in zip(sm_p, sm_j):
        np.testing.assert_allclose(a.prices, b.prices, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(np.isnan(a.vols), np.isnan(b.vols))
        np.testing.assert_allclose(a.vols, b.vols, rtol=1e-4)
        assert np.isfinite(a.vols[:, 2]).all()


def test_predict_remainder_chunk_and_conditional_smile(data):
    ds, ctx = data
    jax_eng = J.PathShadowing(J.Identity(W), J.RelativeMSE(), ds,
                              J.PredictionContext(H))
    eng = port_of(jax_eng)
    f_j = lambda x: J.realized_variance(x[:, :, 0, :], [4, 16], vol=True)
    f_p = lambda x: P.realized_variance(x[:, :, 0, :], [4, 16], vol=True)
    a_j, s_j = jax_eng.predict(ctx, k=32, to_predict=f_j, eta=0.3,
                               n_context_splits=2)
    a1, s1 = eng.predict(ctx, k=32, to_predict=f_p, eta=0.3)
    a2, s2 = eng.predict(ctx, k=32, to_predict=f_p, eta=0.3,
                         n_context_splits=2)   # chunks of 5, the last padded
    assert eng.last_metrics["n_context_chunks"] == 2
    np.testing.assert_allclose(a2, a_j, rtol=1e-5)
    np.testing.assert_allclose(s2, s_j, rtol=1e-5)
    np.testing.assert_allclose(a1, a2, rtol=1e-6)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)
    u_j = jax_eng.predict(ctx[:2], k=32, to_predict=f_j, proba_name="uniform")
    u_p = eng.predict(ctx[:2], k=32, to_predict=f_p, proba_name="uniform")
    np.testing.assert_allclose(u_p, u_j, rtol=1e-5)
    d, p, _ = eng.shadow(ctx[:2], k=32)
    np.testing.assert_allclose(
        eng.predict_from_paths(d, p, f_p, eta=0.3),
        jax_eng.predict_from_paths(d, p, f_j, eta=0.3), rtol=1e-5)
    sm = eng.conditional_smile(ctx[:2], k=160, Ts=[4, 8], Ms=[-1.0, 0.0, 1.0],
                               eta=0.5)
    sm_j = jax_eng.conditional_smile(ctx[:2], k=160, Ts=[4, 8],
                                     Ms=[-1.0, 0.0, 1.0], eta=0.5)
    for a, b in zip(sm, sm_j):
        np.testing.assert_allclose(a.prices, b.prices, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name,arg,C", [
    ("ImputationContext", (10, 6, 14), 1),
    ("CrossChannelContext", 1, 2),
])
def test_other_contexts_match_jax_direct(name, arg, C):
    rng = np.random.default_rng(3)
    ds = rng.normal(0, 0.02, size=(30, C, 200)).astype(np.float32)
    kernel = np.eye(W, dtype=np.float32)[:, None, :]   # matches channel 0
    ctx = np.stack([ds[i, :1, 30 : 30 + W] for i in range(3)])
    jax_eng = J.PathShadowing(J.PathEmbedding(kernel), J.RelativeMSE(), ds,
                              getattr(J, name)(arg))
    eng = port_of(jax_eng)
    d_j, p_j, i_j = jax_eng.shadow(ctx, k=20, method="direct")
    d_p, p_p, i_p = eng.shadow(ctx, k=20)
    assert eng.last_metrics["method"] == "kernel"
    np.testing.assert_array_equal(i_p, i_j)
    np.testing.assert_array_equal(p_p, p_j)
    np.testing.assert_allclose(d_p, d_j, rtol=1e-6)


def test_split_invariance(data):
    ds, ctx = data
    eng = P.PathShadowing(P.Foveal(1.15, 0.9, W), P.RelativeMSE(), ds,
                          P.PredictionContext(H), device="cpu")
    for method in ("direct", "kernel"):
        ref = eng.shadow(ctx[:3], k=30, n_splits=1, method=method)
        got = eng.shadow(ctx[:3], k=30, n_splits=7, method=method)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)


def test_self_match_is_exactly_zero(data):
    ds, _ = data
    eng = P.PathShadowing(P.Identity(W), P.RelativeMSE(), ds,
                          P.PredictionContext(H), device="cpu")
    d, _, i = eng.shadow(ds[5, 0, 7 : 7 + W], k=3)
    assert d[0, 0] == 0.0 and tuple(i[0, 0]) == (5, 7)


def test_eager_errors(data):
    ds, ctx = data
    eng = P.PathShadowing(P.Identity(W), P.RelativeMSE(), ds,
                          P.PredictionContext(H), device="cpu")
    with pytest.raises(ValueError, match="context length"):
        eng.shadow(ctx[..., :10], k=3)
    with pytest.raises(ValueError, match="k="):
        eng.shadow(ctx, k=48 * 300)
    with pytest.raises(ValueError, match="unknown method 'pallas'"):
        eng.shadow(ctx, k=3, method="pallas")
    with pytest.raises(ValueError, match="exact_dtype"):
        eng.shadow(ctx, k=3, exact_dtype="float16")
    with pytest.raises(ValueError, match="too short"):
        P.PathShadowing(P.Identity(W), P.RelativeMSE(), ds,
                        P.PredictionContext(290), device="cpu").shadow(ctx, k=3)
    with pytest.raises(ValueError, match="channels"):
        P.PathShadowing(P.Identity(W), P.RelativeMSE(),
                        np.repeat(ds, 2, axis=1), P.PredictionContext(H),
                        device="cpu").shadow(ctx, k=3)
    with pytest.raises(ValueError, match="score form"):
        P.PathShadowing(P.Identity(W), P.CosineDistance(), ds,
                        P.PredictionContext(H),
                        device="cpu").shadow(ctx, k=3, method="kernel")


def test_cosine_auto_routes_to_the_oracle(data):
    """Cosine lacks the kernels' score form: "auto" declines the kernel and
    takes the fused route, which must return the JAX oracle's winners."""
    ds, ctx = data
    jax_eng = J.PathShadowing(J.Identity(W), J.CosineDistance(), ds,
                              J.PredictionContext(H))
    eng = port_of(jax_eng)
    d_p, _, i_p = eng.shadow(ctx[:2], k=10)
    assert eng.last_metrics["method"] == "fused"
    assert any("kernel declined" in s for s in eng.routing_log)
    d_j, _, i_j = jax_eng.shadow(ctx[:2], k=10, method="direct")
    np.testing.assert_array_equal(i_p, i_j)
    # 1 - cos rounds to quanta of ~6e-8 near cos = 1 (the self-matches)
    np.testing.assert_allclose(d_p, d_j, rtol=1e-6, atol=2.5e-7)


def test_tiny_cap_escalates(data):
    """A forced pass-2 certification failure is redone at the escalated
    cap and returns the certified winners."""
    ds, ctx = data
    eng = P.PathShadowing(P.Identity(W), P.RelativeMSE(), ds,
                          P.PredictionContext(H), device="cpu")
    _, _, i_ref = eng.shadow(ctx[:3], k=32, method="direct")
    d, _, i = eng.shadow_device(ctx[:3], k=32, tournament_cap=1)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    assert eng.last_metrics["redo_contexts"] == 3
    assert any(s.startswith("redo: escalated cap=1568 certified 3/3")
               for s in eng.routing_log), eng.routing_log
    assert eng._cap_memo == {}         # a forced cap is not memoized


def test_redo_memoizes_the_escalated_cap(data, monkeypatch):
    ds, ctx = data
    eng = P.PathShadowing(P.Identity(W), P.RelativeMSE(), ds,
                          P.PredictionContext(H), device="cpu")
    _, _, i_ref = eng.shadow(ctx[:3], k=32, method="direct")
    orig = search_ops.two_pass_search
    calls = []

    def crippled(y, norms, g, k, cap=None):
        calls.append(cap)
        return orig(y, norms, g, k, 1 if len(calls) == 1 else cap)

    monkeypatch.setattr(search_ops, "two_pass_search", crippled)
    _, _, i = eng.shadow(ctx[:3], k=32)
    np.testing.assert_array_equal(i, i_ref)
    assert calls == [None, 32 + 4 * 384]
    assert eng._cap_memo == {(3, 32): 32 + 4 * 384}
    _, _, i = eng.shadow(ctx[:3], k=32)
    assert calls[-1] == 32 + 4 * 384 and len(calls) == 3
    assert any("cap memo" in s for s in eng.routing_log)


def test_oracle_resolves_what_the_retry_cannot(data, monkeypatch):
    """Tier 2: contexts still uncertified after the escalated retry go to
    the direct oracle, and the factored E cache is evicted first."""
    ds, ctx = data
    eng = P.PathShadowing(P.Identity(W), P.RelativeMSE(), ds,
                          P.PredictionContext(H), device="cpu")
    _, _, i_ref = eng.shadow(ctx, k=32, method="direct")
    orig = search_ops.two_pass_search
    monkeypatch.setattr(search_ops, "two_pass_search",
                        lambda y, n, g, k, cap=None: orig(y, n, g, k, 1))
    _, _, i = eng.shadow_device(ctx, k=32, tournament_cap=1)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    assert eng._E is None
    assert "redo: evicted factored E cache for the oracle" in eng.routing_log
    assert any("certified 0/9" in s for s in eng.routing_log)


def test_factored_memory_gate(data, monkeypatch):
    ds, ctx = data
    monkeypatch.setattr(port_engine, "_free_bytes", lambda device: 1 << 20)
    eng = P.PathShadowing(P.Identity(W), P.RelativeMSE(), ds,
                          P.PredictionContext(H), device="cpu")
    _, _, i = eng.shadow(ctx, k=16)
    assert eng._E is None
    assert any(s.startswith("factored declined: E needs")
               for s in eng.routing_log), eng.routing_log
    monkeypatch.undo()
    _, _, i2 = eng.shadow(ctx, k=16)
    assert eng._E is not None
    np.testing.assert_array_equal(i, i2)
    assert eng.last_metrics["factored"] and eng.last_metrics["entry"] == "shadow"
    assert eng.last_metrics["B"] == 9 and eng.last_metrics["k"] == 16


def test_from_numpy_state_checks_its_input(data):
    ds, _ = data
    state = numpy_state(J.PathShadowing(J.Foveal(1.15, 0.9, W),
                                        J.RelativeMSE(), ds,
                                        J.PredictionContext(H)))
    eng = from_numpy_state(state, "cpu")
    assert isinstance(eng.embedding, P.Foveal) and eng.context.horizon == H
    assert eng.device == torch.device("cpu")
    bad = {**state, "embedding": {**state["embedding"], "alpha": 1.3}}
    with pytest.raises(ValueError, match="do not rebuild"):
        from_numpy_state(bad, "cpu")
    with pytest.raises(ValueError, match="unknown distance"):
        from_numpy_state({**state, "distance": "L1"}, "cpu")
    with pytest.raises(ValueError, match="unknown context"):
        from_numpy_state({**state, "context": {"class": "Nope"}}, "cpu")
