"""The port's certified tournament selection (``ops/topk.py``) against the
JAX package's on the same numpy inputs, and the routes that select through
it — pass 2 and the fused route — against the JAX package as a whole (Pallas
in interpret mode), after a forced redo and on a 2-rank gloo mesh where only
one rank fails to certify.

Tolerances: selected values, ids and ``ok`` flags are compared exactly (the
selection only moves values, it computes none); pass-2 scores at 1e-5
relative and engine distances at 1e-6 relative, as in
``tests/test_torch_kernels.py`` and ``tests/test_torch_engine.py``.

The 2-rank world runs this file as a script (``__main__`` below), which is
why nothing of JAX is imported at module level.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import shadowing_tpu_torch as P
from shadowing_tpu_torch.ops import search as search_ops
from shadowing_tpu_torch.ops import topk
from shadowing_tpu_torch.parallel import data_mesh
from shadowing_tpu_torch.parallel import sharding as psh
from shadowing_tpu_torch.shadow import engine as port_engine

STYLES = ["normal", "ties", "quantized", "infs", "sorted"]
W, H, K = 16, 8, 24


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_topk():
    import jax.numpy as jnp

    from shadowing_tpu.ops import topk as jtopk

    return jnp, jtopk


def adversarial(rng, style, B, n):
    """The score styles of ``tests/test_fuzz.py``'s tournament fuzz."""
    s = rng.normal(size=(B, n)).astype(np.float32)
    if style == "ties":
        s = np.zeros((B, n), np.float32)
        s[:, rng.integers(0, n, size=n // 7)] = -1.0
    elif style == "quantized":
        # + 0.0 turns -0.0 into 0.0: XLA's top_k ranks -0.0 before 0.0,
        # where a stable sort (numpy's and the port's) holds them equal
        s = np.round(s * 3).astype(np.float32) + 0.0
    elif style == "infs":
        s[:, rng.integers(0, n, size=max(1, n // 5))] = np.inf
    elif style == "sorted":
        s = np.sort(s, axis=1)[:, ::-1].copy()
    return s


def stable_oracle(s, k):
    idx = np.argsort(s, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(s, idx, axis=-1), idx


# -- the selection functions ---------------------------------------------------

@pytest.mark.parametrize("regime", ["any-k", "small-k", "tiny-cap"])
@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("trial", range(2))
def test_topk_min_batched_equals_jax(style, regime, trial):
    """Values, ids and ``ok`` equal JAX's row by row — certified or not —
    and certified rows equal the stable-sort oracle."""
    jnp, jtopk = jax_topk()
    rng = np.random.default_rng(1000 * trial + 7 * STYLES.index(style)
                                + len(regime))
    B = int(rng.integers(1, 5))
    n = int(rng.integers(300, 120_000))
    k = int(rng.integers(1, n + 1 if regime == "any-k" else max(2, n // 40)))
    cap = int(rng.integers(1, 64)) if regime == "tiny-cap" else None
    s = adversarial(rng, style, B, n)
    vj, ij, okj = map(np.asarray,
                      jtopk.topk_min_batched(jnp.asarray(s), k, 128, cap))
    vp, ip, okp = topk.topk_min_batched(t(s), k, 128, cap)
    assert ip.dtype == torch.int64 and okp.dtype == torch.bool
    np.testing.assert_array_equal(okp.numpy(), okj)
    np.testing.assert_array_equal(vp.numpy(), vj)
    np.testing.assert_array_equal(ip.numpy(), ij)
    ev, ei = stable_oracle(s, k)
    np.testing.assert_array_equal(vp.numpy()[okj], ev[okj])
    np.testing.assert_array_equal(ip.numpy()[okj], ei[okj])
    assert (np.diff(vp.numpy(), axis=1) >= 0).all()


def test_tournament_recursion_and_narrow_fold_certify(rng):
    """Shapes that take the 128-wide fold, the narrow fold and the recursive
    block selection, all certified and equal to the oracle."""
    for n, k, cap in [(262_144, 64, None),      # 128-wide, flat selection
                      (262_144, 64, 100),       # ... recursive selection
                      (200_000, 5_000, None),   # narrow, flat selection
                      (300_000, 2_000, 2_100)]:  # narrow, recursive
        s = rng.normal(size=(2, n)).astype(np.float32)
        v, i, ok = topk.topk_min_batched(t(s), k, 128, cap)
        assert ok.all(), (n, k, cap)
        ev, ei = stable_oracle(s, k)
        np.testing.assert_array_equal(v.numpy(), ev)
        np.testing.assert_array_equal(i.numpy(), ei)


def test_tiny_cap_is_uncertified_and_checked_falls_back(rng):
    """Every block holds one tiny value, far more than a cap of 8 blocks:
    the tournament must say so, as JAX's does, and the checked variant must
    still be exact."""
    jnp, jtopk = jax_topk()
    n, k, block = 1 << 16, 64, 128
    x = rng.uniform(1.0, 2.0, size=n).astype(np.float32)
    tiny = np.arange(0, n, block)
    x[tiny] = rng.uniform(0.0, 0.01, size=len(tiny)).astype(np.float32)
    fast = topk.topk_min(t(x), k, block, 8)
    ref = jtopk.topk_min(jnp.asarray(x), k, block, 8)
    assert not bool(fast.ok) and not bool(ref.ok)
    np.testing.assert_array_equal(fast.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(fast.indices.numpy(),
                                  np.asarray(ref.indices))
    ev, ei = stable_oracle(x, k)
    v, i, ok = topk.topk_min_checked(t(x), k, block, 8)
    assert bool(ok)
    np.testing.assert_array_equal(v.numpy(), ev)
    np.testing.assert_array_equal(i.numpy(), ei)
    vj = jtopk.topk_min_checked(jnp.asarray(x), k, block, 8).values
    np.testing.assert_array_equal(v.numpy(), np.asarray(vj))


def test_fewer_than_k_finite_scores_is_uncertified():
    """``inf < inf`` is false: a row that cannot fill k places with finite
    scores is not certified, while its neighbour is."""
    s = np.full((2, 40_000), np.inf, np.float32)
    s[0, ::1000] = np.arange(40, dtype=np.float32)          # 40 finite
    s[1, :5000] = np.arange(5000, dtype=np.float32)[::-1]
    v, i, ok = topk.topk_min_batched(t(s), 64)
    assert ok.tolist() == [False, True]
    np.testing.assert_array_equal(i[1].numpy(), np.arange(4999, 4935, -1))
    np.testing.assert_array_equal(v[0, :40].numpy(), np.arange(40))


@pytest.mark.parametrize("cap,want", [(None, 512), (10_000, 79), (1, 1)])
def test_tournament_cap_equals_jax(cap, want):
    _, jtopk = jax_topk()
    for n, k, block in [(10_000, 64, 128), (10_000, 3_000, 8), (500, 400, 128)]:
        assert (topk._tournament_cap(n, k, block, cap)
                == jtopk._tournament_cap(n, k, block, cap))
    assert topk._tournament_cap(10_000, 64, 128, cap) == min(want, 79)


def test_sort_paths_one_dimension_and_errors(rng):
    x = rng.integers(0, 5, size=200).astype(np.float64)      # ties, float64
    v, i, ok = topk.topk_min(t(x), 7)
    ev, ei = stable_oracle(x, 7)
    assert bool(ok) and v.dtype == torch.float64
    np.testing.assert_array_equal(i.numpy(), ei)
    res = topk.topk_min_sort(t(x).reshape(2, 100), 3)
    assert isinstance(res, topk.TopKResult) and res.ok.shape == (2,)
    assert isinstance(topk.topk_min_batched(t(x)[None], 3),
                      topk.TopKBatchResult)
    for fn in (topk.topk_min, topk.topk_min_sort, topk.topk_min_checked):
        with pytest.raises(ValueError, match="exceeds number of scores"):
            fn(t(x), 201)


@pytest.mark.parametrize("k", [1, 150, 500])
def test_lowest_set_breaks_ties_by_id(rng, k):
    """The k smallest by threshold, ties at it filled in id order: the ids
    of the stable sort of the whole row, ``+inf`` included."""
    x = rng.integers(0, 4, size=(3, 500)).astype(np.float32)
    x[2, 100:] = np.inf
    ids, thr = topk._lowest_set(t(x), k)
    ev, ei = stable_oracle(x, k)
    np.testing.assert_array_equal(ids.numpy(), np.sort(ei, axis=1))
    np.testing.assert_array_equal(thr.numpy(), ev[:, -1])


# -- pass 2 through the tournament -------------------------------------------

def widths_selected(monkeypatch):
    """Record the width of every row the selection sorts: the whole row at
    the exits that need no certificate, the gathered candidates in the
    tournament."""
    seen = []
    real = topk.topk_min_sort

    def spy(scores, k):
        seen.append(scores.shape[-1])
        return real(scores, k)

    monkeypatch.setattr(topk, "topk_min_sort", spy)
    return seen


@pytest.mark.parametrize("k,cap", [(40, 64), (40, None), (300, None)])
def test_pass2_through_the_tournament_matches_pallas(monkeypatch, k, cap):
    """3,200 blocks: the final selection takes the tournament (no sort sees
    all the candidates), and so does the block selection at the small cap
    (none sees all the block minima); scores, ids and flags equal the JAX
    two-pass search's."""
    import jax.numpy as jnp
    from test_torch_kernels import make_problem

    from shadowing_tpu.ops import pallas_search

    R, T_, w = 400, 1040, 24
    y, norms, g, n_out = make_problem(k, R, T_, w, 2)
    vj, ij, okj = pallas_search.two_pass_search(
        jnp.asarray(y), jnp.asarray(norms), jnp.asarray(g), k=k, n_out=n_out,
        cap=cap, interpret=True, mxu="highest")
    seen = widths_selected(monkeypatch)
    vp, ip, okp = search_ops.two_pass_search(t(y), t(norms), t(g), k, cap)
    n_blocks = R * search_ops.n_blocks(n_out)
    cap_eff = min(max(cap or max(k + 384, 512), -(-k // 128)), n_blocks)
    assert seen and cap_eff * 128 not in seen
    assert (n_blocks in seen) == (cap is None)
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    assert okp.all()
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-6)


def test_pass2_joins_the_tournaments_flags(monkeypatch):
    """A final selection that cannot certify fails pass 2, whatever pass
    2's own guard says."""
    from test_torch_kernels import make_problem

    y, norms, g, n_out = make_problem(3, 272, 1040, 24, 2)
    real = search_ops.topk_min_batched

    def uncertified_final(scores, k, block, cap):
        v, i, ok = real(scores, k, block=block, cap=cap)
        return v, i, ok & (k != 40)          # the final selection has k = 40

    monkeypatch.setattr(search_ops, "topk_min_batched", uncertified_final)
    assert not search_ops.two_pass_search(t(y), t(norms), t(g), 40)[2].any()
    assert search_ops.two_pass_search(t(y), t(norms), t(g), 41)[2].all()


def test_factored_route_selects_through_the_same_pass2(monkeypatch):
    from test_torch_kernels import make_problem

    from shadowing_tpu_torch.ops import factored

    assert factored.pass2_from_bmin is search_ops.pass2_from_bmin
    y, norms, kernel, x_emb, n_out = make_problem(5, 272, 1040, 24, 9, d=24)
    g = np.einsum("bd,dcw->bcw", x_emb, kernel).astype(np.float32)
    E = factored.build_factored(t(y), t(kernel), n_out)
    seen = widths_selected(monkeypatch)
    vf, i_f, okf = factored.two_pass_search_factored(
        E, t(norms), t(y), t(g), t(x_emb), 64)
    assert seen and 512 * 128 not in seen
    vt, i_t, okt = search_ops.two_pass_search(t(y), t(norms), t(g), 64)
    assert okf.all() and okt.all()
    np.testing.assert_array_equal(i_f.numpy(), i_t.numpy())
    np.testing.assert_array_equal(vf.numpy(), vt.numpy())


# -- the fused route through the tournament ------------------------------------

@pytest.fixture(scope="module")
def fused_problem():
    rng = np.random.default_rng(5)
    ds = rng.normal(0, 0.02, size=(64, 1, 512)).astype(np.float32)
    ds[40] = ds[3]                                           # exact ties
    ctx = np.stack([ds[3, :, 100:120], ds[9, :, 7:27] * 1.01,
                    rng.normal(0, 0.02, size=(1, 20)).astype(np.float32)])
    return ds, ctx


@pytest.mark.parametrize("dist", ["RelativeMSE", "CosineDistance"])
@pytest.mark.parametrize("cap", [None, 2])
def test_fused_search_equals_jax_chunk_by_chunk(fused_problem, dist, cap):
    """The scanned JAX fused search and the port's loop, on the same norms
    and filters: ids and the AND-ed flags equal, certified or not."""
    import jax.numpy as jnp

    import shadowing_tpu as J
    from shadowing_tpu.shadow import engine as jax_engine

    ds, ctx = fused_problem
    n_out = 512 - 20 - H + 1
    kernel = np.eye(20, dtype=np.float32)[:, None, :]
    norms = port_engine._window_norms(t(ds), t(kernel), n_out, 1, True)
    x_emb, x_norm2, g = port_engine._prep_context(t(ctx), t(kernel), t(kernel))
    # 4 equal chunks of 16 rows: JAX pads no row, so the chunks are the same
    vj, ij, okj = jax_engine._fused_search(
        jnp.asarray(ds), jnp.asarray(norms.numpy()), jnp.asarray(g.numpy()),
        jnp.asarray(x_norm2.numpy()), k=K, n_out=n_out, n_splits=4,
        distance=getattr(J, dist)(), cap=cap)
    vp, ip, okp = port_engine._fused_search(
        t(ds), norms, g, x_norm2, K, n_out, 4, getattr(P, dist)(), cap)
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    assert bool(okp.all()) == (cap is None)
    np.testing.assert_array_equal(ip.numpy()[np.asarray(okj)],
                                  np.asarray(ij)[np.asarray(okj)])
    np.testing.assert_allclose(vp.numpy()[np.asarray(okj)],
                               np.asarray(vj)[np.asarray(okj)], rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("dist", ["RelativeMSE", "CosineDistance"])
def test_fused_route_redo_and_split_invariance(fused_problem, dist):
    """The engine's fused route equals JAX's and the direct oracle for any
    ``n_splits``; a forced uncertified selection is redone by the oracle and
    returns the same winners, in the canonical (distance, flat id) order."""
    import shadowing_tpu as J

    ds, ctx = fused_problem
    eng = P.PathShadowing(P.Identity(20), getattr(P, dist)(), ds,
                          P.PredictionContext(H), device="cpu")
    jeng = J.PathShadowing(J.Identity(20), getattr(J, dist)(), ds,
                           J.PredictionContext(H))
    d_j, p_j, i_j = jeng.shadow(ctx, k=K, method="fused")
    d_d, p_d, i_d = eng.shadow(ctx, k=K, method="direct")
    for n_splits in (1, 3, 7):
        d, p, i = eng.shadow(ctx, k=K, method="fused", n_splits=n_splits)
        assert eng.last_metrics["redo_contexts"] == 0
        np.testing.assert_array_equal(i, i_d)
        np.testing.assert_array_equal(i, np.asarray(i_j))
        np.testing.assert_array_equal(p, np.asarray(p_j))
        # a cosine self-match is 1 - cos = a few 1e-7 either side of 0
        np.testing.assert_allclose(d, np.asarray(d_j), rtol=1e-6, atol=5e-7)
    d, p, i = eng.shadow_device(ctx, k=K, method="fused", tournament_cap=2)
    assert eng.last_metrics["redo_contexts"] == len(ctx)
    np.testing.assert_array_equal(i.numpy(), i_d)
    np.testing.assert_array_equal(d.numpy(), d_d)
    # the duplicated row ties exactly: the lower flat id comes first
    assert (i_d[0, 0] == [3, 100]).all() and (i_d[0, 1] == [40, 100]).all()


def test_search_reads_ok_on_the_host_once(fused_problem, monkeypatch):
    """One host read of the flags per search, however many chunks."""
    ds, ctx = fused_problem
    eng = P.PathShadowing(P.Identity(20), P.RelativeMSE(), ds,
                          P.PredictionContext(H), device="cpu")
    eng.shadow(ctx, k=K, method="fused", n_splits=2)           # warm the norms
    reads = []
    real = torch.nonzero
    monkeypatch.setattr(torch, "nonzero",
                        lambda x, *a, **kw: reads.append(1) or real(x, *a, **kw))
    monkeypatch.setattr(torch.Tensor, "__bool__", lambda self: reads.append(1))
    monkeypatch.setattr(torch.Tensor, "item", lambda self: reads.append(1))
    eng.shadow(ctx, k=K, method="fused", n_splits=8)
    assert len(reads) == 1


# -- a 2-rank mesh where only one rank fails to certify ------------------------

T1 = 320          # 4 rows hold 1,188 windows: the fold stays 128 wide


def one_sided_problem():
    """Eight trajectories for two ranks and a constant context. Rank 0's
    four rows are noise: at a cap of two blocks its tournament cannot
    certify. Rank 1's first row is constant over its first 128 windows, so
    its k winners tie at distance 0 inside one block, below the minimum of
    the second, and certify."""
    rng = np.random.default_rng(21)
    ds = rng.normal(0, 0.02, size=(8, 1, T1)).astype(np.float32)
    ds[4, 0, : 128 + W - 1] = 0.01
    ctx = np.full((1, 1, W), 0.01, np.float32)
    return ds, ctx


def one_sided_results(mesh) -> dict:
    ds, ctx = one_sided_problem()
    eng = P.PathShadowing(P.Identity(W), P.RelativeMSE(), ds,
                          P.PredictionContext(H), mesh=mesh,
                          device=None if mesh else "cpu")
    n_out = T1 - W - H + 1
    kernel = torch.eye(W)[:, None, :]
    _, x_norm2, g = port_engine._prep_context(t(ctx), kernel, kernel)
    local_ok = port_engine._fused_search(
        eng.y, eng.window_norms(), g, x_norm2, K, n_out, 1, eng.distance, 2)[2]
    merged_ok = psh.sharded_fused_search(
        eng.y, eng.window_norms(), g, x_norm2, K, n_out, eng.distance,
        eng._mesh, 1, 2)[2]
    d, p, i = eng.shadow_device(ctx, k=K, method="fused", tournament_cap=2)
    return {"local_ok": local_ok.numpy(), "merged_ok": merged_ok.numpy(),
            "d": d.numpy(), "i": i.numpy(),
            "redo": np.array(eng.last_metrics["redo_contexts"])}


def test_one_uncertified_rank_redoes_the_whole_mesh(tmp_path):
    """The flags are AND-reduced before anything branches on them: both
    ranks enter the redo, neither waits alone, and both return the winners
    of ``mesh=None``."""
    from test_torch_parallel import launch

    run = launch(2, Path(__file__).resolve(), tmp_path)
    assert run.returncode == 0, run.stdout[-6000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    assert ranks[0]["local_ok"].tolist() == [False]
    assert ranks[1]["local_ok"].tolist() == [True]
    ds, ctx = one_sided_problem()
    ref = P.PathShadowing(P.Identity(W), P.RelativeMSE(), ds,
                          P.PredictionContext(H), device="cpu")
    d_d, _, i_d = ref.shadow(ctx, k=K, method="direct")
    assert (i_d[0, :, 0] == 4).all() and (d_d == 0).all()
    for got in ranks:
        assert got["merged_ok"].tolist() == [False]
        assert int(got["redo"]) == 1
        np.testing.assert_array_equal(got["i"], i_d)
        np.testing.assert_array_equal(got["d"], d_d)
    # alone, the whole dataset is one shard whose best block is rank 1's
    alone = one_sided_results(None)
    np.testing.assert_array_equal(alone["i"], i_d)


if __name__ == "__main__":
    mesh = data_mesh(device="cpu")
    np.savez(Path(sys.argv[1]) / f"rank{mesh.data_pos}.npz",
             **one_sided_results(mesh))
    torch.distributed.destroy_process_group()
