"""The hand-written CUDA kernels (pass 1's two, pass 2's rescore and
select, the smile's) against their plain PyTorch versions, on the card,
and the paths that run them there (the search routes, the synthesis, a
mesh of ``torchrun`` ranks).

These tests need an NVIDIA GPU with ``nvcc``; without one they skip. The
module imports neither JAX nor the JAX package, so it also runs where JAX is
not installed (without this directory's conftest)::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from shadowing_tpu_torch.ops import factored, search

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def problem(device, R, C, T, w, n_out, B, seed=0):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.normal(0, 0.011, size=(R, C, T)).astype(np.float32))
    ones = torch.ones((1, C, w))
    norms = torch.nn.functional.conv1d(y[:, :, : n_out + w - 1] ** 2, ones)[:, 0]
    g = torch.from_numpy(rng.normal(size=(B, C, w)).astype(np.float32))
    return y.to(device), norms.contiguous().to(device), g.to(device)


def check(got, want, tol=1e-5):
    """Equal +inf pattern, no NaN, finite values within ``tol`` of the
    largest finite |score|."""
    torch.cuda.synchronize()
    assert not torch.isnan(got).any()
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert torch.equal(got[~fin], want[~fin])
    scale = want[fin].abs().max()
    assert ((got - want)[fin].abs().max() <= tol * scale).item()


@pytest.mark.parametrize("R,C,T,w,n_out,B", [
    (301, 1, 700, 20, 600, 1),
    (77, 2, 900, 130, 700, 4),      # filter over 3 blocks, 2 channels
    (64, 1, 1200, 385, 800, 2),     # the widest filter
    (20, 3, 900, 385, 400, 50),     # more filters than one launch stages
])
def test_blockmin_toeplitz(cuda, R, C, T, w, n_out, B):
    y, norms, g = problem(cuda, R, C, T, w, n_out, B)
    norms[[0, R - 1]] = float("inf")
    before = search.TOEPLITZ.launches
    got = search.score_blockmin(y, norms, g)
    assert search.TOEPLITZ.launches > before
    check(got, search.score_blockmin_plain(y, norms, g))


@pytest.mark.parametrize("w", [1, 20, 126, 385])
@pytest.mark.parametrize("C", [1, 3])
def test_blockmin_toeplitz_widths(cuda, w, C):
    """Every tap count against the 8-tap register chunks, one and three
    channels, a pair of contexts and a single one, rows of T = 4,100
    (16-byte copies) and a ragged n_out."""
    R, T = 45, 4100
    y, norms, g = problem(cuda, R, C, T, w, T - w - 7, 3, seed=w + C)
    norms[[1, R - 2]] = float("inf")
    check(search.score_blockmin(y, norms, g),
          search.score_blockmin_plain(y, norms, g))


@pytest.mark.parametrize("T,B", [(2201, 1), (3001, 7), (777, 50)])
def test_blockmin_toeplitz_ragged_rows_and_chunks(cuda, T, B):
    """T not a multiple of 4 (4-byte copies), a start count just past one
    2,048-start tile, and B = 50 filters of 385 taps over three channels:
    more than one context chunk."""
    C, w = (3, 385) if B == 50 else (2, 33)
    y, norms, g = problem(cuda, 33, C, T, w, T - w + 1, B, seed=T)
    plan = search.toeplitz_plan(33, C, w, T - w + 1, B)
    assert (len(plan.chunks) > 1) == (B == 50)
    before = search.TOEPLITZ.launches
    got = search.score_blockmin(y, norms, g)
    assert search.TOEPLITZ.launches == before + len(plan.chunks)
    check(got, search.score_blockmin_plain(y, norms, g))


@pytest.mark.parametrize("C,w,B,T", [
    (7, 20, 3, 4100),
    (9, 20, 5, 4100),
    (16, 20, 1, 2201),              # 4-byte copies
    (8, 385, 3, 3001),
    (57, 385, 2, 900),              # the most channels the first kernel took at w = 385
])
def test_blockmin_toeplitz_wide_channels(cuda, C, w, B, T):
    """Past a whole tile's shared memory the channels go through the ring in
    groups, a context pair a launch; the sums run on from group to group."""
    R = 37
    y, norms, g = problem(cuda, R, C, T, w, T - w - 5, B, seed=C + w)
    norms[[2, R - 1]] = float("inf")
    plan = search.toeplitz_plan(R, C, w, T - w - 5, B)
    assert (plan.cg < C) == (C > 7)
    before = search.TOEPLITZ.launches
    got = search.score_blockmin(y, norms, g)
    assert search.TOEPLITZ.launches == before + len(plan.chunks)
    check(got, search.score_blockmin_plain(y, norms, g))


def factored_problem(cuda, R, d, n_out, B, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    y, norms, _ = problem(cuda, R, 1, n_out + 40, 20, n_out, 1, seed=seed)
    y, norms = y * scale, norms * scale ** 2
    kernel = torch.from_numpy(rng.normal(size=(d, 1, 20)).astype(np.float32))
    x_emb = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32) * scale)
    E = factored.build_factored(y, kernel.to(cuda), n_out)
    norms[3] = float("inf")
    return E, norms, x_emb.to(cuda)


@pytest.mark.parametrize("R,d,n_out,B", [
    (300, 7, 600, 9),
    (129, 20, 1000, 64),
    (50, 48, 257, 200),             # two launches of contexts
])
def test_blockmin_factored(cuda, R, d, n_out, B):
    E, norms, x_emb = factored_problem(cuda, R, d, n_out, B, seed=d)
    before = factored.FACTORED.launches
    got = factored.score_blockmin_factored(E, norms, x_emb)
    assert factored.FACTORED.launches == before + -(-B // 128)
    check(got, factored.score_blockmin_factored_plain(E, norms, x_emb))


@pytest.mark.parametrize("B", [1, 8, 9, 63, 64, 65, 128, 200])
@pytest.mark.parametrize("d", [1, 7, 20, 33, 48])
def test_blockmin_factored_tiling_edges(cuda, d, B):
    """Every last-pass width (8 to 64 contexts, one and two launches), one
    to six 8-deep K-steps with zero-padded dims (odd step counts reuse the
    first A buffer across m-tiles), R and n_out off every tile, a barred
    row."""
    E, norms, x_emb = factored_problem(cuda, 37, d, 333, B, seed=B + d)
    check(factored.score_blockmin_factored(E, norms, x_emb),
          factored.score_blockmin_factored_plain(E, norms, x_emb))


@pytest.mark.parametrize("scale", [1e-3, 1e3])
@pytest.mark.parametrize("d", [20, 48])
def test_blockmin_factored_error_is_relative(cuda, d, scale):
    """The 3xTF32 split's error scales with the data, so the 1e-5 gate
    holds at 1e-3 and at 1e3 times the smoke's statistics."""
    E, norms, x_emb = factored_problem(cuda, 64, d, 700, 64, scale, seed=d)
    check(factored.score_blockmin_factored(E, norms, x_emb),
          factored.score_blockmin_factored_plain(E, norms, x_emb))


@pytest.mark.parametrize("k", [1024, 16384])
def test_tournament_equals_the_stable_sort_at_the_pass2_shapes(cuda, k):
    """Pass 2's final selection, ``k`` of ``(k + 384) * 128`` candidates at
    ``cap = k + 128``, on rows of every adversarial style: array-equal to
    the stable sort wherever certified, and certified on the normal rows."""
    from shadowing_tpu_torch.ops.topk import topk_min_batched, topk_min_sort

    gen = torch.Generator(device=cuda).manual_seed(k)
    B, n = 10, (k + 384) * 128
    s = torch.randn((B, n), generator=gen, device=cuda)
    s[1::5] = torch.round(s[1::5] * 3) + 0.0                 # quantized
    s[2::5] = torch.where(s[2::5] < -1.0, -1.0, 0.0)         # two values
    s[3::5][torch.rand((2, n), generator=gen, device=cuda) < 0.2] = \
        float("inf")
    s[4::5, k // 2:] = float("inf")                          # short of k
    v, i, ok = topk_min_batched(s, k, cap=k + 128)
    v_s, i_s, _ = topk_min_sort(s, k)
    assert i.dtype == torch.int64 and i.device.type == "cuda"
    assert ok[0::5].all() and not ok[4::5].any()
    assert torch.equal(v[ok], v_s[ok]) and torch.equal(i[ok], i_s[ok])
    assert (v[:, 1:] >= v[:, :-1]).all()
    # the block selection's shape: cap = k + 384 of R * nblk block minima
    bmin = torch.randn((4, 32768 * 32), generator=gen, device=cuda)
    v, i, ok = topk_min_batched(bmin, k + 384, cap=k + 512)
    v_s, i_s, _ = topk_min_sort(bmin, k + 384)
    assert ok.all() and torch.equal(v, v_s) and torch.equal(i, i_s)


# ---- pass 2's select ---------------------------------------------------------

def styled_rows(cuda, B, n, k, seed):
    """Rows of the tournament test's styles by row: normal, quantized, two
    values, a fifth ``+inf``, short of k finite scores."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    s = torch.randn((B, n), generator=gen, device=cuda)
    s[1::5] = torch.round(s[1::5] * 3) + 0.0
    s[2::5] = torch.where(s[2::5] < -1.0, -1.0, 0.0)
    inf = torch.rand(s[3::5].shape, generator=gen, device=cuda) < 0.2
    s[3::5] = torch.where(inf, float("inf"), s[3::5])
    s[4::5, k // 2:] = float("inf")
    return s


def check_select(x, k):
    """``select_lowest`` = the stable sort's ids in flat order and its k-th
    value, row by row."""
    from shadowing_tpu_torch.ops import topk

    before = topk.SELECT.launches
    ids, thr = topk.select_lowest(x, k)
    assert topk.SELECT.launches == before + 1
    v_s, i_s, _ = topk.topk_min_sort(x, k)
    torch.cuda.synchronize()
    assert ids.dtype == torch.int64 and ids.shape == (x.shape[0], k)
    assert torch.equal(ids, i_s.sort(dim=1).values)
    assert torch.equal(thr, v_s[:, -1])


@pytest.mark.parametrize("B,n,k", [
    (64, 1048576, 16768),   # the backtest's block selection at k = 16,384
    (64, 1048576, 1408),    # ... and at k = 1,024
    (64, 2146304, 16384),   # its final selection at k = 16,384
    (5, 3932160, 10384),    # the Foveal query's block selection, a row a style
])
def test_select_lowest_equals_the_stable_sort_at_the_cells_shapes(cuda, B, n,
                                                                  k):
    check_select(styled_rows(cuda, B, n, k, seed=k), k)


@pytest.mark.parametrize("n", [5000, 300001])   # 300,001: unaligned rows
@pytest.mark.parametrize("k", [1, 777, "n"])
def test_select_lowest_signed_zeros_equal_rows_and_extreme_k(cuda, n, k):
    """-0.0 equals 0.0 (ties among them fill in id order), all-equal rows,
    k = 1 and k = n, on rows whose length is not a multiple of 4."""
    k = n if k == "n" else k
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((6, n), generator=gen, device=cuda)
    x[0] = torch.where(torch.rand(n, generator=gen, device=cuda) < 0.5,
                       -0.0, 0.0)
    x[1] = torch.round(x[1]) * torch.where(x[2] < 0, -1.0, 1.0)  # +-0, +-1
    x[2] = 3.0
    x[3] = float("inf")
    x[4, ::3] = 1e30
    assert torch.signbit(x[0]).any() and not torch.signbit(x[0]).all()
    check_select(x, k)


def tournament_pass2(bmin, y, norms, g, k, cap):
    """Pass 2 through the two tournaments, as it ran on the card before the
    select kernel: ``(vals, ids, ok)``."""
    from shadowing_tpu_torch.ops.topk import topk_min_batched

    L = search.L
    B, R, nblk = bmin.shape
    nb = R * nblk
    cap = min(max(cap, -(-k // L)), nb)
    mu_sel, bidx, sel_ok = topk_min_batched(bmin.reshape(B, nb), cap, block=L,
                                            cap=cap + 128)
    mu_cap = mu_sel[:, -1] if cap < nb else torch.full((B,), float("inf"),
                                                       device=bmin.device)
    bidx, perm = torch.sort(bidx, dim=1)
    mu_sorted = torch.gather(mu_sel, 1, perm)
    r, j = bidx // nblk, bidx % nblk
    s, exact_bmin = search.rescore_candidates(y, norms, g, r, j)
    vals, loc, fin_ok = topk_min_batched(s.reshape(B, cap * L), k, block=L,
                                         cap=k + 128)
    idx = search.winner_ids(r, j, loc, norms.shape[1])
    err_obs = torch.where(torch.isfinite(mu_sorted) & (exact_bmin < 1e29),
                          (mu_sorted - exact_bmin).abs(),
                          torch.zeros_like(exact_bmin)).amax(dim=1)
    guard = 2.0 * err_obs + 1e-5 * mu_cap.abs() + 1e-12
    ok = torch.isinf(mu_cap) | (vals[:, -1] + guard < mu_cap)
    return vals, idx, ok & sel_ok & fin_ok


@pytest.mark.parametrize("k,cap", [(10, None), (300, None), (2000, None),
                                   (300, 4000), (40, 4), (1000, 12)])
def test_pass2_on_the_card_equals_the_tournaments(cuda, k, cap):
    """Bit-equal scores and ids wherever the tournaments certified, and
    certified wherever they were, at caps large and tiny; the select kernel
    runs twice a call and the tournament never."""
    from shadowing_tpu_torch.ops import topk
    from shadowing_tpu_torch.utils import profiling

    y, norms, g = problem(cuda, 300, 1, 700, 20, 600, 6, seed=k)
    norms[7] = float("inf")
    y[11] = y[10]                  # equal windows: ties across rows
    norms[11] = norms[10]
    bmin = search.score_blockmin(y, norms, g)
    cap_t = cap or min(max(k + 384, 512), bmin.shape[1] * bmin.shape[2])
    v_t, i_t, ok_t = tournament_pass2(bmin, y, norms, g, k, cap_t)
    before, rows = topk.SELECT.launches, profiling.counters().get(
        "select_kernel_rows", 0)
    v, i, ok = search.pass2_from_bmin(bmin, y, norms, g, k, cap)
    assert topk.SELECT.launches == before + 2
    assert profiling.counters()["select_kernel_rows"] == rows + 2 * 6
    assert (ok | ~ok_t).all()
    assert torch.equal(v[ok_t], v_t[ok_t]) and torch.equal(i[ok_t], i_t[ok_t])
    assert (v[:, 1:] >= v[:, :-1]).all()


def test_shard_reader_rows_land_on_the_card(cuda, tmp_path):
    """Shards read by the parallel reader, put on the card by the engine,
    equal ``numpy.load``'s."""
    from shadowing_tpu_torch import (
        Identity,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        TimeSeriesDataset,
    )

    rng = np.random.default_rng(0)
    for j in range(6):
        np.save(tmp_path / f"batch{j:04d}.npy",
                rng.normal(0, 0.011, size=(50, 1, 600)).astype(np.float32))
    want = np.concatenate([np.load(f) for f in sorted(tmp_path.glob("*.npy"))]
                          )[:270]
    got = TimeSeriesDataset(tmp_path, R=270).load()
    np.testing.assert_array_equal(got, want)
    eng = PathShadowing(Identity(20), RelativeMSE(), tmp_path,
                        PredictionContext(20), device=cuda)
    assert eng.y.is_cuda and torch.equal(eng.y[:270].cpu(),
                                         torch.from_numpy(want))
    d, _, i = eng.shadow(want[7, :, 100:120], k=3)
    assert d[0, 0] == 0.0 and tuple(i[0, 0]) == (7, 100)


def agree_up_to_ties(d_a, i_a, d_b, i_b, atol=1e-6, rtol=1e-5):
    """Winner ids agree rank for rank, except at ranks whose distance lies
    within the float32 tie window (``tests/test_fuzz.py``'s 1e-6 + 1e-5
    relative) of a neighbour's or of the k-th distance."""
    for da, db, ia, ib in zip(d_a, d_b, i_a, i_b):
        taint = np.zeros(len(da), bool)
        for d in (da, db):
            win = atol + rtol * np.abs(d)
            tight = np.abs(np.diff(d)) <= win[1:]
            taint[:-1] |= tight
            taint[1:] |= tight
            taint |= np.abs(d - d[-1]) <= win[-1]
        if not ((ia == ib).all(-1) | taint).all():
            return False
    return True


@pytest.mark.parametrize("route", ["cosine", "foveal-400"])
def test_fused_route_equals_direct(cuda, route):
    import shadowing_tpu_torch as P

    rng = np.random.default_rng(4)
    ds = rng.normal(0, 0.011, size=(300, 1, 700)).astype(np.float32)
    if route == "cosine":
        emb, dist, w = P.Identity(20), P.CosineDistance(), 20
    else:
        emb, dist, w = P.Foveal(1.15, 0.9, 400), P.RelativeMSE(), 400
    eng = P.PathShadowing(emb, dist, ds, P.PredictionContext(20), device=cuda)
    ctx = np.concatenate([ds[:2, :, 100 : 100 + w],
                          rng.normal(0, 0.011, size=(3, 1, w))]).astype(np.float32)
    d_f, p_f, i_f = eng.shadow(ctx, k=100)
    assert eng.last_metrics["method"] == "fused"
    d_d, _, i_d = eng.shadow(ctx, k=100, method="direct")
    assert agree_up_to_ties(d_f, i_f, d_d, i_d)
    np.testing.assert_allclose(d_f, d_d, rtol=1e-5, atol=1e-6)
    assert (np.diff(d_f, axis=1) >= 0).all()
    r, t = i_f[2, 0]
    np.testing.assert_array_equal(p_f[2, 0], ds[r, :, t : t + w + 20])


def test_generators_are_deterministic_per_seed(cuda):
    import shadowing_tpu_torch as P

    mk = lambda seed: P.MRWGenerator(T=1025, seed=seed, device=cuda)
    a, b, c = mk(1).generate(512), mk(1).generate(512), mk(2).generate(512)
    assert a.is_cuda and a.shape == (512, 1, 1025)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert (a[:, :, 0] == 0).all()
    assert abs(torch.diff(a[:, 0], dim=-1).std().item() / 0.0126 - 1) < 0.1

    m = P.PDVModelDiscrete(lams1=[55.0, 10.0], lams2=[20.0, 3.0],
                           thetas=[0.25, 0.5], betas=[0.04, -0.12, 0.75],
                           nu=4.0, device=cuda)
    kw = dict(T=0.5, dt=1 / 252, S0=100.0, S=256, R10=np.zeros(2),
              R20=np.full(2, 0.04))
    gen = lambda seed: torch.Generator(device=cuda).manual_seed(seed)
    s1, x1 = m.gen(**kw, generator=gen(7))
    s2, x2 = m.gen(**kw, generator=gen(7))
    _, x3 = m.gen(**kw, generator=gen(8))
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(s1, s2)
    assert not np.array_equal(x1, x3)
    np.testing.assert_array_equal(m.gen(**kw)[1], m.gen(**kw)[1])
    assert x1.shape == (256, 126) and (x1[:, 0] == 100.0).all() and (x1 > 0).all()


# ---- pass 2's rescore ------------------------------------------------------

def rescore_problem(cuda, R, C, T, w, n_out, B, cap, seed=0):
    """A problem and ``cap`` sorted random blocks per context, as ``(r, j)``;
    rows 0 and R - 1 barred."""
    y, norms, g = problem(cuda, R, C, T, w, n_out, B, seed=seed)
    norms[[0, R - 1]] = float("inf")
    nblk = -(-n_out // 128)
    rng = np.random.default_rng(seed)
    bidx = np.sort(np.stack([rng.choice(R * nblk, cap, replace=False)
                             for _ in range(B)]), axis=1)
    bidx = torch.from_numpy(bidx).to(cuda)
    return y, norms, g, bidx // nblk, bidx % nblk


def check_rescore(got, want):
    """The same 1e30 sentinels (padded starts, barred rows), no NaN, the
    other scores within 1e-5 of their largest |score|, and ``exact_bmin``
    the exact minimum of the kernel's own scores."""
    (s, bmin), (s_want, _) = got, want
    torch.cuda.synchronize()
    assert not torch.isnan(s).any()
    assert torch.equal(bmin, s.amin(2))
    big = s_want >= 1e29
    assert torch.equal(big, s >= 1e29) and torch.equal(s[big], s_want[big])
    scale = s_want[~big].abs().max()
    assert ((s - s_want)[~big].abs().max() <= 1e-5 * scale).item()


@pytest.mark.parametrize("R,w,B,cap", [
    (64, 20, 64, 1408),             # the k = 1,024 backtest's pass 2
    (600, 20, 64, 16768),           # k = 16,384, rows cut to 600
    (400, 126, 1, 10384),           # the Foveal-126 query at k = 10,000
])
def test_rescore_kernel_at_the_cells_shapes(cuda, R, w, B, cap):
    T = 4096
    args = rescore_problem(cuda, R, 1, T, w, T - w + 1, B, cap, seed=w)
    before = search.RESCORE.launches
    got = search.rescore_candidates(*args)
    assert search.RESCORE.launches == before + 1
    check_rescore(got, search.rescore_candidates_plain(*args))


@pytest.mark.parametrize("R,C,T,w,n_out,B,cap", [
    (40, 3, 1000, 20, 981, 5, 320),     # C > 1; every block, the last ones
                                        # clamp at T - 1
    (30, 1, 1200, 385, 816, 2, 210),    # w = MAX_WIDTH, every block
    (50, 2, 1001, 33, 969, 3, 400),     # T % 4 != 0: 4-byte copies
    (64, 1, 4096, 126, 3901, 1, 1984),  # n_out short of T - w + 1
    (12, 16, 900, 385, 500, 2, 48),     # 16 channels of the widest filter
    (6, 200, 700, 385, 300, 3, 18),     # 200 such channels: the taps are
                                        # read from g, not staged
    (20, 1, 600, 20, 581, 1500, 5),     # more blocks than one wave
])
def test_rescore_kernel_edges(cuda, R, C, T, w, n_out, B, cap):
    args = rescore_problem(cuda, R, C, T, w, n_out, B, cap, seed=C + w)
    check_rescore(search.rescore_candidates(*args),
                  search.rescore_candidates_plain(*args))


def test_rescore_kernel_duplicate_windows_score_bit_equal(cuda):
    """Row 5 is row 2 shifted by 3 blocks and 37 starts: every window of row
    2 recurs there in another lane and register, and scores bit-equal."""
    R, T, w, d = 8, 2000, 20, 3 * 128 + 37
    n_out = T - w + 1
    y, norms, g = problem(cuda, R, 1, T, w, n_out, 3)
    y[5, :, d:] = y[2, :, : T - d]
    norms[5, d:] = norms[2, : n_out - d]
    nblk = -(-n_out // 128)
    blocks = torch.arange(nblk, device=cuda)
    r = torch.cat([torch.full((nblk,), 2), torch.full((nblk,), 5)]
                  ).to(cuda).expand(3, -1).contiguous()
    j = torch.cat([blocks, blocks]).expand(3, -1).contiguous()
    s, _ = search.rescore_candidates(y, norms, g, r, j)
    rows = s.reshape(3, 2, nblk * 128)
    assert torch.equal(rows[:, 0, : n_out - d], rows[:, 1, d:n_out])


def test_pass2_launches_the_rescore_once_a_call(cuda):
    y, norms, g = problem(cuda, 300, 1, 700, 20, 600, 4)
    bmin = search.score_blockmin(y, norms, g)
    for k, cap in ((10, None), (300, None), (2000, None), (300, 4000)):
        before = search.RESCORE.launches
        search.pass2_from_bmin(bmin, y, norms, g, k, cap)
        assert search.RESCORE.launches == before + 1


def test_two_pass_on_the_card_equals_the_cpu(cuda):
    """No near-ties among the k + 1 best (gaps above 1e-5 relative on the
    CPU), so the ids and flags are equal."""
    k = 64
    y, norms, g = problem("cpu", 64, 1, 700, 20, 681, 3, seed=3)
    v, i, ok = search.two_pass_search(y, norms, g, k + 1)
    gap = (v[:, 1:] - v[:, :-1]) / v[:, 1:].abs().clamp(min=1e-3)
    assert ok.all() and gap.min() > 1e-5
    v_c, i_c, ok_c = search.two_pass_search(y.to(cuda), norms.to(cuda),
                                            g.to(cuda), k)
    assert torch.equal(ok_c.cpu(), ok) and torch.equal(i_c.cpu(), i[:, :k])
    torch.testing.assert_close(v_c.cpu(), v[:, :k], rtol=1e-5, atol=1e-6)


def test_wrappers_raise_instead_of_falling_back(cuda):
    y, norms, g = problem(cuda, 8, 1, 300, 20, 200, 1)
    with pytest.raises(ValueError, match="is on cpu"):
        search.score_blockmin(y, norms.cpu(), g)
    # any channel count is grouped into the ring; a single channel of a
    # filter far past MAX_WIDTH still does not fit
    with pytest.raises(ValueError, match="shared memory"):
        search.score_blockmin(torch.zeros((2, 1, 12100), device=cuda),
                              torch.zeros((2, 10), device=cuda),
                              torch.zeros((1, 1, 12000), device=cuda))
    r = torch.zeros((1, 4), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        search.rescore_candidates(y, norms, g, r, r.cpu())
    E = torch.zeros((8, 49, 256), device=cuda)
    with pytest.raises(ValueError, match="MAX_DIM"):
        factored.score_blockmin_factored(E, norms[:, :256].contiguous(),
                                         torch.zeros((1, 49), device=cuda))
    from shadowing_tpu_torch.ops import finalize, smile

    ids = torch.zeros((2, 3), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        finalize.gather_embed(y, ids.cpu(), 200, torch.arange(20, device=cuda),
                              torch.zeros((20, 1, 20), device=cuda))
    with pytest.raises(ValueError, match="is on cpu"):
        finalize.extract_windows(y, ids.cpu(), 200, 40)
    paths, w, K, knots = smile_problem(cuda, 1, 64, [5], 3, 12, False)
    with pytest.raises(ValueError, match="no hedged_mc_smile kernel"):
        smile.hedged_mc_smile(paths.cpu(), w.cpu(), K.cpu(), knots.cpu(), [5],
                              1.0, 0.0)
    with pytest.raises(ValueError, match="shape mismatch"):
        smile.hedged_mc_smile(paths, w, K, knots, [6], 1.0, 0.0)
    # 4 m^2 + 3 m doubles of shared memory at m = 85 pass the H100's 227 KB
    with pytest.raises(RuntimeError, match="hedged_mc_smile"):
        smile.hedged_mc_smile(paths, w, K, knots[..., :1].expand(1, 4, 85),
                              [5], 1.0, 0.0)


def scattering_target(T, J, seed=0):
    from shadowing_tpu_torch.models.scattering import (
        build_filter_bank,
        scattering_stats,
    )

    rng = np.random.default_rng(seed)
    x = rng.standard_t(4, size=(16, T)).astype(np.float32)
    x = (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
    bank = build_filter_bank(T, J)
    return x, bank, scattering_stats(x, bank, average=False)


def test_scattering_stats_on_the_card_equal_the_cpu(cuda):
    """cuFFT and cuBLAS under ``fp32_exact`` against the CPU: atol 1e-5,
    rtol 1e-4 (float32 FFTs in another order)."""
    from shadowing_tpu_torch.models.scattering import scattering_stats

    for T, J in ((1024, 6), (1500, 5), (4096, 9)):
        x, bank, want = scattering_target(T, J)
        got = scattering_stats(torch.from_numpy(x).to(cuda), bank,
                               average=False)
        assert got.is_cuda
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-4)


def test_scattering_synthesis_is_deterministic_on_the_card(cuda):
    from shadowing_tpu_torch.models.scattering.synthesis import synthesize_batch

    _, bank, target = scattering_target(1024, 6)
    target = target.mean(dim=0)
    run = lambda seed: synthesize_batch(
        torch.Generator(device=cuda).manual_seed(seed), target, bank,
        batch=64, max_iterations=150, tol=0.02, segment=50)
    (za, ra), (zb, rb), (zc, _) = run(1), run(1), run(2)
    assert za.is_cuda and za.shape == (64, 1024)
    assert torch.equal(za, zb) and np.array_equal(ra, rb)
    assert not torch.equal(za, zc)
    assert np.isfinite(ra).all() and np.median(ra) < 0.05


def test_generate_returns_a_cuda_tensor(cuda, tmp_path):
    import shadowing_tpu_torch as P

    dlnx = np.random.default_rng(0).standard_t(4, size=2000) * 0.01
    out = P.generate(dlnx, R=6, J=5, T=512, max_iterations=60, batch=4,
                     cache_path=tmp_path)
    assert out.is_cuda and out.shape == (6, 1, 512)
    assert torch.isfinite(out).all()
    assert len(list(tmp_path.glob("scatgen_*/shard*.npy"))) == 2
    again = P.generate(dlnx, R=6, J=5, T=512, max_iterations=60, batch=4,
                       cache_path=tmp_path)
    assert torch.equal(again, out)


def test_kernel_launches_are_the_counter_store(cuda):
    """``Kernel.launches`` reads the store of ``utils/profiling.py``: after
    a K1 search (one context) and a K2 search (nine) both read what the
    store counts, and each kernel counted its launches there."""
    from shadowing_tpu_torch.utils import profiling

    ds, ctx = mesh_problem()
    eng = mesh_engine(ds, device=cuda)
    before = profiling.counters()
    eng.shadow(ctx[:1], k=300)
    eng.shadow(ctx, k=300)
    after = profiling.counters()
    for kernel in (search.TOEPLITZ, factored.FACTORED):
        key = f"launch.{kernel.name}"
        assert kernel.launches == after[key]
        assert after[key] > before.get(key, 0)
    assert after["searches"] - before.get("searches", 0) == 2


# ---- finalize's gathers (csrc/finalize_gather.cu) -------------------------

def finalize_problem(cuda, R, C, T, w_extract, B, k, seed=0):
    """Trajectories and ``(B, k)`` sorted flat ids on the card, the last
    valid start of the last row and the first start of row 0 among them."""
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.normal(0, 0.011, size=(R, C, T)).astype(np.float32))
    n_out = T - w_extract + 1
    ids = np.sort(rng.integers(0, R * n_out, size=(B, k)), axis=1)
    ids[0, 0], ids[-1, -1] = 0, R * n_out - 1
    return y.to(cuda), torch.from_numpy(ids).to(cuda), n_out


def bank(spec, C, seed=0):
    from shadowing_tpu_torch import Foveal, Identity

    if spec == "identity20":
        return torch.from_numpy(Identity(20).kernel)
    if spec == "foveal126":
        return torch.from_numpy(Foveal(1.15, 0.9, 126).kernel)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=spec).astype(np.float32))


def bank_staged(d, C, w):
    """Whether ``csrc/finalize_gather.cu``'s ``make_plan`` stages a ``(d, C,
    w)`` bank in shared memory: 8 warps' ids, starts and tiles of 32 rows
    of max(32, dt) + 1 floats, and the bank with d padded to dt sums, within
    227 KiB."""
    dt = 8 if d <= 8 else 24 if d <= 24 else 40
    fixed = 8 * 32 * (8 + 4 + 4 * (max(32, dt) + 1))
    return fixed + 4 * C * w * (-(-d // dt) * dt) <= 227 * 1024


@pytest.mark.parametrize("R,C,T,w_extract,ctx,spec,B,k", [
    # the cells: k = 16,384 backtest chunk, rows cut to 4,096; the Foveal
    # query at k = 10,000
    (4096, 1, 4096, 40, ("horizon", 20), "identity20", 64, 16384),
    (4096, 1, 4096, 378, ("horizon", 252), "foveal126", 1, 10000),
    # three channels; a portion context's two pieces; a context of channels
    (50, 3, 700, 30, ("horizon", 10), (17, 3, 20), 3, 301),
    (50, 1, 700, 30, ("portion", (10, 6, 14)), (9, 1, 24), 2, 77),
    (50, 2, 700, 20, ("channels", 1), (5, 1, 20), 2, 33),
    # a bank too large for shared memory, in two passes over d; one tap
    (40, 3, 900, 300, ("horizon", None), (48, 3, 300), 2, 100),
    (20, 1, 100, 1, ("horizon", None), (1, 1, 1), 1, 5),
    # 33 taps (two staging chunks), d = 41 (two passes of 40 sums)
    (30, 1, 300, 53, ("horizon", 20), (41, 1, 33), 3, 1000),
], ids=["k16384", "foveal126", "three-channels", "portion", "channels",
        "bank-past-shared-memory", "one-tap", "two-chunks-two-passes"])
def test_finalize_gathers_equal_the_plain_versions(cuda, R, C, T, w_extract,
                                                   ctx, spec, B, k):
    """``gather_embed`` equals its plain version within 1e-5 of the largest
    |e| (the sums run in another order), ``extract_windows`` equals
    ``_extract_paths`` bit for bit."""
    import shadowing_tpu_torch as P
    from shadowing_tpu_torch.ops import finalize
    from shadowing_tpu_torch.shadow.routes import _extract_paths, _in_positions

    kind, arg = ctx
    context = {"horizon": P.PredictionContext, "portion": P.ImputationContext,
               "channels": P.CrossChannelContext}[kind](arg)
    y, ids, n_out = finalize_problem(cuda, R, C, T, w_extract, B, k, seed=k)
    kernel = bank(spec, C, seed=C).to(cuda)
    pos = _in_positions(context.select_in_context, C, w_extract, cuda)
    e = finalize.gather_embed(y, ids, n_out, pos, kernel)
    want = finalize.gather_embed(y.cpu(), ids.cpu(), n_out, pos.cpu(),
                                 kernel.cpu())
    torch.cuda.synchronize()
    assert not torch.isnan(e).any()
    scale = want.abs().max()
    assert ((e.cpu() - want).abs().max() <= 1e-5 * scale).item()
    assert bank_staged(*kernel.shape) == (spec != (48, 3, 300))
    paths = finalize.extract_windows(y, ids, n_out, w_extract)
    assert torch.equal(paths, _extract_paths(y, ids, n_out, w_extract)[0])


@pytest.mark.parametrize("spec,C,ctx_w,h", [
    ("identity20", 1, 20, 20), ("foveal126", 1, 126, 252),
    ((6, 2, 31), 2, 31, 5),
])
def test_a_window_embeds_bit_equal_alone_and_at_its_id(cuda, spec, C, ctx_w,
                                                        h):
    """``embed_windows`` of a window (the context's path through
    ``_prep_context``) and ``gather_embed`` at that window's id give
    bit-equal vectors, so a context equal to a winner rescores to exactly
    0.0; a window repeated in another row and start embeds bit-equal."""
    from shadowing_tpu_torch.ops import finalize

    y, ids, n_out = finalize_problem(cuda, 40, C, 900, ctx_w + h, 2, 500)
    y[7, :, 300:] = y[3, :, 111 : 900 - 189]
    ids[1, :2] = torch.tensor([3 * n_out + 150, 7 * n_out + 339])
    kernel = bank(spec, C).to(cuda)
    pos = torch.arange(ctx_w, device=cuda)
    e = finalize.gather_embed(y, ids, n_out, pos, kernel)
    r, t0 = ids // n_out, ids % n_out
    windows = torch.stack([y[i, :, j : j + ctx_w] for i, j in
                           zip(r.flatten().tolist(), t0.flatten().tolist())])
    alone = finalize.embed_windows(windows, kernel).reshape(e.shape)
    assert torch.equal(alone, e)
    assert torch.equal(e[1, 0], e[1, 1])


def test_finalize_launches_each_gather_once(cuda):
    """A single-rank finalize launches ``gather_embed`` and
    ``extract_windows`` once each; its answer agrees with the CPU's up to
    float32 ties."""
    import shadowing_tpu_torch as P
    from shadowing_tpu_torch.ops import finalize
    from shadowing_tpu_torch.parallel.sharding import (
        local_mesh,
        sharded_finalize_shadow,
    )

    y, ids, n_out = finalize_problem(cuda, 300, 1, 700, 40, 4, 1024)
    kernel = bank("identity20", 1).to(cuda)
    x = y[[5, 9, 11, 17], :, 30:50]
    x_emb = finalize.embed_windows(x, kernel)
    args = (ids, x_emb, kernel, n_out, 40, P.RelativeMSE(),
            P.PredictionContext(20).select_in_context)
    before = (finalize.GATHER_EMBED.launches, finalize.EXTRACT.launches)
    d, p, i = sharded_finalize_shadow(y, *args, local_mesh(cuda))
    assert (finalize.GATHER_EMBED.launches, finalize.EXTRACT.launches) == (
        before[0] + 1, before[1] + 1)
    d_c, p_c, i_c = sharded_finalize_shadow(
        y.cpu(), *(a.cpu() if torch.is_tensor(a) else a for a in args),
        local_mesh("cpu"))
    assert agree_up_to_ties(d.cpu().numpy(), i.cpu().numpy(), d_c.numpy(),
                            i_c.numpy())
    torch.testing.assert_close(d.cpu(), d_c, rtol=1e-5, atol=1e-6)
    r, t0 = i[..., 0].flatten().tolist(), i[..., 1].flatten().tolist()
    assert torch.equal(p.reshape(-1, 1, 40), torch.stack(
        [y[a, :, b : b + 40] for a, b in zip(r, t0)]))


@pytest.mark.parametrize("emb", ["identity20", "foveal126"])
def test_card_engine_agrees_with_the_cpu_engine(cuda, emb):
    """The card's ``(dists, paths, idces)`` are the CPU engine's up to
    float32 ties; the paths are the dataset's slices at the returned ids."""
    import shadowing_tpu_torch as P

    rng = np.random.default_rng(6)
    ds = rng.normal(0, 0.011, size=(200, 1, 1200)).astype(np.float32)
    emb, h = ((P.Identity(20), 20) if emb == "identity20"
              else (P.Foveal(1.15, 0.9, 126), 252))
    w = emb.width
    ctx = np.concatenate([ds[[3, 8], :, 100 : 100 + w],
                          rng.normal(0, 0.011, size=(2, 1, w))]
                         ).astype(np.float32)
    out = [P.PathShadowing(emb, P.RelativeMSE(), ds, P.PredictionContext(h),
                           device=dev).shadow(ctx, k=500)
           for dev in (cuda, "cpu")]
    (d, p, i), (d_c, _, i_c) = out
    assert agree_up_to_ties(d, i, d_c, i_c)
    np.testing.assert_allclose(d, d_c, rtol=1e-5, atol=1e-6)
    assert (d[:2, 0] == 0.0).all()
    np.testing.assert_array_equal(p, np.stack(
        [[ds[r, :, t : t + w + h] for r, t in row] for row in i]))


def mesh_problem():
    rng = np.random.default_rng(5)
    ds = rng.normal(0, 0.011, size=(301, 1, 900)).astype(np.float32)
    ctx = np.stack([ds[r, :, s : s + 20] for r, s in
                    zip(rng.integers(0, 301, 9), rng.integers(0, 800, 9))])
    return ds, ctx


def mesh_engine(ds, **kw):
    import shadowing_tpu_torch as P

    return P.PathShadowing(P.Identity(20), P.RelativeMSE(), ds,
                           P.PredictionContext(20), **kw)


def test_ranks_launch_both_kernels_on_the_card(cuda, tmp_path):
    """A ``torchrun`` of one rank per card, at least two (R = 301 divides
    neither 2 nor 4): every rank launches K1 (one context) and K2 (nine) on
    its rows, and the winners equal one engine's. Two ranks on one card
    talk gloo, ranks with a card each NCCL."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    from pathlib import Path

    n = max(2, torch.cuda.device_count())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [str(repo), env.get("PYTHONPATH")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(n), "--master-addr", "127.0.0.1", "--master-port", str(port),
         __file__, str(tmp_path)], cwd=repo, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, out[-4000:]
    ds, ctx = mesh_problem()
    eng = mesh_engine(ds, device=cuda)
    want = [eng.shadow(ctx[:B], k=300)[2] for B in (1, 9)]
    for r in range(n):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert got["backend"] == ("gloo" if n > torch.cuda.device_count()
                                  else "nccl")
        (k1, _), (_, k2) = got["launches"]      # (K1, K2) of B = 1 and 9
        assert k1 > 0 and k2 > 0
        for B, w in zip((1, 9), want):
            np.testing.assert_array_equal(got[f"ids{B}"], w)


def _mesh_rank(out):
    """One rank of the test above."""
    from shadowing_tpu_torch.parallel import data_mesh

    mesh = data_mesh()
    ds, ctx = mesh_problem()
    eng = mesh_engine(ds, mesh=mesh)
    res, launches = {}, []
    for B in (1, 9):
        search.TOEPLITZ.launches = factored.FACTORED.launches = 0
        res[f"ids{B}"] = eng.shadow(ctx[:B], k=300)[2]
        launches.append([search.TOEPLITZ.launches, factored.FACTORED.launches])
    np.savez(f"{out}/rank{mesh.data_pos}.npz", launches=np.array(launches),
             backend=torch.distributed.get_backend(), **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    import sys

    _mesh_rank(sys.argv[1])


def smile_problem(cuda, B, N, Ts, nK, m, concentrated, seed=0):
    """Price paths ``(B, N, max(Ts) + 1)`` float64 near 100, Softmax-like
    weights on one or two paths or spread over all, strikes ``(B, nT, nK)``
    around the spot and the regression knots of every step."""
    from shadowing_tpu_torch.pricing import hedged_mc

    rng = np.random.default_rng(seed)
    H = max(Ts)
    r = rng.standard_t(4, size=(B, N, H)) * 0.0126 / np.sqrt(2)
    paths = 100.0 * np.exp(np.concatenate(
        [np.zeros((B, N, 1)), np.cumsum(r, axis=-1)], axis=-1))
    z = -rng.uniform(0.0, 30.0 if concentrated else 0.5, size=(B, N))
    z[:, :2] = 0.0 if concentrated else z[:, :2]
    w = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
    M = np.linspace(-2, 2, nK)
    K = 100.0 * np.exp(M[None, None] * 0.2 * np.sqrt(np.asarray(Ts) / 252)[None, :, None])
    K = np.broadcast_to(K, (B, len(Ts), nK)).copy()
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=cuda)
    paths, w32, K = t(paths), t(w, torch.float32), t(K)
    return paths, w32, K, hedged_mc._regression_knots(paths, m)


@pytest.mark.parametrize("B,N,Ts,nK,m,concentrated,r", [
    (1, 1024, [5, 10, 20], 9, 12, True, 0.0),     # the cell's shapes
    (1, 1024, [5, 10, 20], 9, 12, False, 0.0),
    (3, 256, [1, 2, 7], 1, 16, True, 0.05),       # T = 1 and 2, one strike
    (2, 2048, [20], 64, 12, False, 0.02),         # the moment knots
    (2, 100, [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18], 5, 2,
     True, 0.0),                                  # 16 maturities, m = 2
    (2, 300, list(range(2, 22)), 70, 20, True, 0.0),   # 2 launches of Ts
    (1, 500, [4, 9], 200, 40, False, 0.01),       # 80 rows, 2 of strikes
])
def test_smile_kernel_equals_the_plain_version(cuda, B, N, Ts, nK, m,
                                               concentrated, r):
    """``ops/smile.py::hedged_mc_smile`` against the plain version on the
    same CUDA tensors: prices to 1e-9 of the spot (the kernel sums the
    normal equations in another order), vols bit-equal where the prices
    round to the same float32."""
    import math

    from shadowing_tpu_torch.ops import smile
    from shadowing_tpu_torch.pricing import black_scholes, hedged_mc

    paths, w, K, knots = smile_problem(cuda, B, N, Ts, nK, m, concentrated)
    disc = math.exp(-r / 252)
    before = smile.SMILE.launches
    prices, vols = smile.hedged_mc_smile(paths, w, K, knots, Ts, disc, r)
    assert smile.SMILE.launches == before + 1      # calls, not CUDA launches
    want = torch.stack([hedged_mc._backward(paths[..., : T + 1], w, K[:, i],
                                            disc, knots, m)
                        for i, T in enumerate(Ts)], 1)
    torch.cuda.synchronize()
    assert prices.dtype == torch.float64 and vols.dtype == torch.float32
    assert (prices - want).abs().max().item() <= 1e-9 * 100.0
    same = prices.float() == want.float()
    plain = torch.stack([black_scholes.bs_implied_vol(
        want[:, i], paths[:, 0, 0, None], K[:, i], T * (1.0 / 252), r)
        for i, T in enumerate(Ts)], 1)
    assert torch.equal(vols.isnan(), plain.isnan())
    fin = same & ~plain.isnan()
    assert torch.equal(vols[fin], plain[fin])


def test_smile_at_k1024_on_the_card_meets_the_float64_reference(cuda):
    """``predict_and_smile`` at k = 1,024 under eta_smile = 0.075, where
    the weights sit on one or two winners: the card's prices and vols equal
    the plain float64 reference's (``benchmark/reference/hedged_mc.py``)
    on the port's own winners, prices to 2e-7 of the spot, vols to 1e-4
    where the price lies 1e-4 of the spot inside the prices that have
    one (``tests/test_torch_smile_reference.py`` says why)."""
    import sys
    from pathlib import Path

    import shadowing_tpu_torch as P

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark.reference import hedged_mc as ref

    Ts, Ms, spot = [5, 10, 20], np.linspace(-2, 2, 9), 100.0
    rng = np.random.default_rng(5)
    ds = rng.normal(0, 0.0126, size=(2048, 1, 600)).astype(np.float32)
    # one context near a window of the data (one effective path), one
    # drawn afresh (a few)
    ctx = np.concatenate([
        ds[7:8, :, 200:220] + rng.normal(0, 0.004, size=(1, 1, 20)),
        rng.normal(0, 0.0126, size=(1, 1, 20))]).astype(np.float32)
    eng = P.PathShadowing(P.Identity(20), P.RelativeMSE(), ds,
                          P.PredictionContext(20), device="cuda")
    d, paths, _ = eng.shadow(ctx, k=1024)
    _, _, smiles = eng.predict_and_smile(
        ctx, k=1024, to_predict=lambda x: P.realized_variance(x[:, :, 0, :], Ts),
        Ts=Ts, Ms=Ms, eta=0.1, eta_smile=0.075)
    n_compared = 0
    for b, sm in enumerate(smiles):
        assert ref.effective_paths(np.float64(d[b]), 0.075) < 24
        want = ref.smile(np.float64(d[b]), np.float64(paths[b, :, 0, 20:]),
                         Ts, Ms, 0.075, spot)
        assert np.abs(np.float64(sm.prices) - want["prices"]).max() <= 2e-7 * spot
        compared = np.isfinite(want["vols"]) & (want["room"] >= 1e-4 * spot)
        gap = np.abs(np.float64(sm.vols)[compared] - want["vols"][compared])
        assert np.isfinite(gap).all() and (gap <= 1e-4).all()
        n_compared += int(compared.sum())
    assert n_compared >= 9


def test_public_smile_on_the_card_keeps_the_cpu_range(cuda):
    """``compute_smile_batch`` on CUDA tensors past one launch's maturities
    (16), with 70 moneynesses and 20 hats, gives the CPU's smile: prices
    within 1e-6 of the spot (both regress in float64, to ~1e-9 of the
    spot; the :class:`Smile` rounds them to float32, whose step at 100 is
    7.6e-6), and vols within 1e-4 where both lie 1e-4 of the spot inside
    the solvable bracket (the two devices' ``erf`` may differ by an ulp)."""
    import math

    from shadowing_tpu_torch.pricing import black_scholes, hedged_mc

    Ts, Ms = list(range(2, 22)), np.linspace(-2, 2, 70)
    paths, w, _, _ = smile_problem(cuda, 2, 300, Ts, 1, 2, False)
    x, wts = paths.float(), w
    card = hedged_mc.compute_smile_batch(x, Ts, Ms, weights=wts, n_basis=20)
    cpu = hedged_mc.compute_smile_batch(x.cpu(), Ts, Ms, weights=wts.cpu(),
                                        n_basis=20)
    for a, b in zip(card, cpu):
        assert a.prices.shape == (20, 70)
        assert np.abs(a.prices - b.prices).max() <= 1e-6 * b.spot
        tau = np.asarray(Ts)[:, None] / 252
        lo = np.asarray(black_scholes.bs_call_price(
            b.spot, b.strikes, tau, black_scholes.SIGMA_LO))
        hi = np.asarray(black_scholes.bs_call_price(
            b.spot, b.strikes, tau, black_scholes.SIGMA_HI))
        room = np.minimum(b.prices - lo, hi - b.prices)
        inside = room >= 1e-4 * b.spot
        assert inside.sum() >= 100
        assert np.abs(a.vols[inside] - b.vols[inside]).max() <= 1e-4
        assert math.isclose(a.spot, b.spot)
