"""The port's pass-1 kernels (plain PyTorch versions on the CPU) and pass 2
against the JAX package's Pallas kernels run in interpret mode.

On a CPU tensor each wrapper runs its kernel's plain version; the CUDA
kernels themselves are compared with those plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadowing_tpu.ops import pallas_factored, pallas_search
from shadowing_tpu.ops.sliding import sliding_dot as jax_sliding_dot
from shadowing_tpu_torch.ops import factored, finalize, search

L = 128


def make_problem(seed, R, T, w, B, C=1, d=None):
    """Trajectories, window norms and combined filters; with ``d`` also an
    embedding bank and context embeddings that make the filters."""
    rng = np.random.default_rng(seed)
    y = rng.normal(0, 0.02, size=(R, C, T)).astype(np.float32)
    n_out = T - w + 1
    ones = np.ones((1, C, w), np.float32)
    norms = np.array(jax_sliding_dot(jnp.asarray(y ** 2), jnp.asarray(ones),
                                     n_out=n_out))[:, 0]
    if d is None:
        return y, norms, rng.normal(size=(B, C, w)).astype(np.float32), n_out
    kernel = rng.normal(size=(d, C, w)).astype(np.float32)
    x_emb = rng.normal(size=(B, d)).astype(np.float32)
    return y, norms, kernel, x_emb, n_out


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("R,T,C,w,B", [
    (64, 400, 1, 20, 2),
    (64, 400, 2, 20, 1),
    (40, 640, 1, 130, 3),      # the filter spans 3 blocks
    (37, 300, 2, 130, 2),      # ragged R and n_out, 2 channels, wide filter
])
def test_k1_plain_matches_pallas(R, T, C, w, B):
    y, norms, g, n_out = make_problem(R + w, R, T, w, B, C)
    y3, n2 = pallas_search._pad_views(jnp.asarray(y), jnp.asarray(norms),
                                      n_out, w)
    Rp, _, cols = y3.shape
    want = np.asarray(pallas_search.score_blockmin(
        y3.reshape(Rp, C * cols), n2, jnp.asarray(g), interpret=True,
        mxu="highest"))                                   # (B, Rp, nblk)
    got = search.score_blockmin(t(y), t(norms), t(g)).numpy()
    assert got.shape == (B, R, -(-n_out // L))
    np.testing.assert_allclose(got, want[:, :R], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("R,T,C,w,d,B", [
    (64, 400, 1, 24, 12, 9),
    (45, 333, 2, 20, 20, 8),   # ragged rows and starts, 2 channels
])
def test_k2_plain_matches_pallas(R, T, C, w, d, B):
    y, norms, kernel, x_emb, n_out = make_problem(R + d, R, T, w, B, C, d)
    y3, n2 = pallas_search._pad_views(jnp.asarray(y), jnp.asarray(norms),
                                      n_out, w)
    E9, n4 = pallas_factored.build_factored(y3, n2, jnp.asarray(kernel))
    want = np.asarray(pallas_factored.score_blockmin_factored(
        E9, n4, jnp.asarray(x_emb), interpret=True)).transpose(0, 2, 1)
    E = factored.build_factored(t(y), t(kernel), n_out)
    got = factored.score_blockmin_factored(E, t(norms), t(x_emb)).numpy()
    nblk = -(-n_out // L)
    assert E.shape == (R, d, nblk * L)
    assert got.shape == (B, R, nblk)
    # the JAX side stores E as a bf16 hi/lo pair (~2^-18 relative)
    np.testing.assert_allclose(got, want[:, :R, :nblk], rtol=1e-4, atol=2e-5)
    pad = want[:, R:]
    assert (np.isinf(pad) | (pad > 1e20)).all()


def test_plain_versions_agree_and_fold_inf():
    """K1 and K2 compute the same block minima for g = x_emb @ kernel, and
    +inf norms (barred rows, starts past n_out) fold to +inf, never NaN."""
    y, norms, kernel, x_emb, n_out = make_problem(3, 24, 300, 20, 5, d=20)
    norms[[3, 17]] = np.inf
    g = np.einsum("bd,dcw->bcw", x_emb, kernel).astype(np.float32)
    k1 = search.score_blockmin(t(y), t(norms), t(g))
    E = factored.build_factored(t(y), t(kernel), n_out)
    k2 = factored.score_blockmin_factored(E, t(norms), t(x_emb))
    np.testing.assert_allclose(k1.numpy(), k2.numpy(), rtol=1e-5, atol=1e-6)
    for out in (k1, k2):
        assert not torch.isnan(out).any()
        assert torch.isinf(out[:, [3, 17]]).all()
        assert torch.isfinite(out[:, [0, 5]]).all()


@pytest.mark.parametrize("k", [40, 300])
def test_two_pass_matches_pallas(k):
    y, norms, g, n_out = make_problem(k, 48, 400, 24, 2)
    vj, ij, okj = pallas_search.two_pass_search(
        jnp.asarray(y), jnp.asarray(norms), jnp.asarray(g), k=k, n_out=n_out,
        interpret=True, mxu="highest")
    vp, ip, okp = search.two_pass_search(t(y), t(norms), t(g), k)
    assert np.asarray(okj).all() and okp.all()
    assert ip.dtype == torch.int64
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-6)


def test_factored_two_pass_matches_toeplitz():
    y, norms, kernel, x_emb, n_out = make_problem(5, 40, 350, 24, 9, d=24)
    g = np.einsum("bd,dcw->bcw", x_emb, kernel).astype(np.float32)
    E = factored.build_factored(t(y), t(kernel), n_out)
    vf, i_f, okf = factored.two_pass_search_factored(
        E, t(norms), t(y), t(g), t(x_emb), 64)
    vt, i_t, okt = search.two_pass_search(t(y), t(norms), t(g), 64)
    assert okf.all() and okt.all()
    np.testing.assert_array_equal(i_f.numpy(), i_t.numpy())
    np.testing.assert_array_equal(vf.numpy(), vt.numpy())


def test_tiny_cap_fails_certification():
    """Pass 2 over too few blocks cannot certify — the engine's redo then
    takes over (tests/test_torch_engine.py)."""
    y, norms, g, n_out = make_problem(7, 48, 400, 24, 2)
    _, _, ok = search.two_pass_search(t(y), t(norms), t(g), 32, cap=1)
    assert not ok.any()


def test_wrappers_check_inputs():
    y, norms, g, n_out = make_problem(9, 8, 200, 20, 1)
    with pytest.raises(ValueError, match="contiguous float32"):
        search.score_blockmin(t(y).transpose(0, 2).contiguous().transpose(0, 2),
                              t(norms), t(g))
    with pytest.raises(ValueError, match="contiguous float32"):
        search.score_blockmin(t(y).double(), t(norms), t(g))
    with pytest.raises(ValueError, match="shape mismatch"):
        search.score_blockmin(t(y), t(norms[:4]), t(g))
    with pytest.raises(ValueError, match="filter width"):
        search.two_pass_search(t(y), t(norms)[:, :10],
                               torch.zeros((1, 1, search.MAX_WIDTH + 1)), 4)
    E = torch.zeros((8, 3, 2 * L))
    with pytest.raises(ValueError, match="shape mismatch"):
        factored.score_blockmin_factored(E, t(norms), torch.zeros((2, 4)))
    ids, pos, bank = torch.zeros((2, 5), dtype=torch.int64), torch.arange(20), \
        torch.zeros((20, 1, 20))
    with pytest.raises(ValueError, match="contiguous int64"):
        finalize.gather_embed(t(y), ids.int(), n_out, pos, bank)
    with pytest.raises(ValueError, match="contiguous int64"):
        finalize.extract_windows(t(y), ids.T, n_out, 20)
    with pytest.raises(ValueError, match="shape mismatch"):   # w != len(pos)
        finalize.gather_embed(t(y), ids, n_out, pos[:19], bank)
    with pytest.raises(ValueError, match="shape mismatch"):   # C > src's
        finalize.gather_embed(t(y), ids, n_out, pos, torch.zeros((20, 2, 20)))
    with pytest.raises(ValueError, match="shape mismatch"):   # past T
        finalize.extract_windows(t(y), ids, n_out, 21)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card gets no plain
    version: the wrapper raises instead."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no blockmin_toeplitz kernel"):
        search.score_blockmin(torch.empty((4, 1, 300), **meta),
                              torch.empty((4, 281), **meta),
                              torch.empty((1, 1, 20), **meta))
    with pytest.raises(ValueError, match="no blockmin_factored kernel"):
        factored.score_blockmin_factored(torch.empty((4, 3, 384), **meta),
                                         torch.empty((4, 300), **meta),
                                         torch.empty((2, 3), **meta))
    y, ids = torch.empty((4, 1, 300), **meta), torch.empty(
        (1, 8), dtype=torch.int64, **meta)
    with pytest.raises(ValueError, match="no gather_embed kernel"):
        finalize.gather_embed(y, ids, 261, torch.empty(20, dtype=torch.int64,
                                                       **meta),
                              torch.empty((20, 1, 20), **meta))
    with pytest.raises(ValueError, match="no extract_windows kernel"):
        finalize.extract_windows(y, ids, 261, 40)


def test_e_bytes():
    # 32768 rows, 4057 starts (32 blocks), d = 20, fp32
    assert factored.e_bytes(32768, 4057, 20) == 32768 * 20 * 32 * 128 * 4


# ---- pass 2's rescore (plain version) and the winners' ids ----------------

def selection(rng, B, cap, R, nblk):
    """Sorted block ids ``(B, cap)`` of each context, split into (r, j)."""
    bidx = np.sort(np.stack([rng.choice(R * nblk, cap, replace=False)
                             for _ in range(B)]), axis=1)
    return t(bidx // nblk), t(bidx % nblk)


@pytest.mark.parametrize("R,C,T,w,B,cap", [
    (12, 1, 400, 20, 3, 20),       # n_out = 381: the last block is ragged
    (9, 2, 333, 33, 2, 17),        # two channels, segments clamp at T - 1
    (6, 1, 700, 130, 1, 30),       # a filter over 2 blocks
    (5, 1, 600, 126, 1, 12),       # the Foveal-126 width
    (4, 1, 900, 385, 1, 10),       # w = MAX_WIDTH
    (4, 16, 800, 385, 2, 5),       # 16 channels of the widest filter
    (7, 1, 257, 20, 4, 8),         # T % 4 != 0
    (6, 3, 500, 7, 2, 14),         # w % 4 != 0, three channels
    (5, 1, 148, 20, 3, 5),         # one block a row, 1 valid start in 128
    (8, 5, 421, 64, 2, 16),        # w a multiple of 4, five channels
    (3, 1, 1000, 1, 2, 9),         # a single tap
])
def test_rescore_plain_sentinels_and_block_minima(R, C, T, w, B, cap):
    """Padded starts and barred rows score exactly 1e30, valid starts
    ``norm - 2 * cross`` (float64 reference), and ``exact_bmin`` is
    ``s.amin(2)``."""
    y, norms, g, n_out = make_problem(R + C + w, R, T, w, B, C=C)
    norms[[1, R - 2]] = np.inf
    nblk = -(-n_out // L)
    rng = np.random.default_rng(w)
    r, j = selection(rng, B, cap, R, nblk)
    s, exact_bmin = search.rescore_candidates(t(y), t(norms), t(g), r, j)
    assert s.shape == (B, cap, L) and exact_bmin.shape == (B, cap)
    assert torch.equal(exact_bmin, s.amin(2))
    start = j[..., None] * L + torch.arange(L)
    barred = (start >= n_out) | torch.isin(r, torch.tensor([1, R - 2]))[..., None]
    assert barred.any() and (~barred).any()
    assert (s[barred] == torch.tensor(1e30)).all()
    y64, g64 = y.astype(np.float64), g.astype(np.float64)
    for b, i, l in zip(*np.nonzero(~barred.numpy())):
        rr, tt = int(r[b, i]), int(start[b, i, l])
        want = norms[rr, tt] - 2 * (y64[rr, :, tt : tt + w] * g64[b]).sum()
        assert abs(float(s[b, i, l]) - want) <= 1e-5 * max(abs(want), 1.0)


@pytest.mark.parametrize("R,n_out,cap,k", [
    (5, 381, 12, 40),              # ragged n_out, 3 blocks a row
    (3, 200, 6, 300),              # every block selected
    (40, 4077, 200, 1000),         # the backtest's n_out
])
def test_winner_ids_equal_the_flat_gather(R, n_out, cap, k):
    """The ids made from ``loc``, ``r`` and ``j`` equal a gather from the
    ``(B, cap, L)`` tensor of every candidate's flat id, on selections that
    repeat rows."""
    rng = np.random.default_rng(n_out)
    B, nblk = 4, -(-n_out // L)
    r, j = selection(rng, B, cap, R, nblk)
    assert (r[:, 1:] == r[:, :-1]).any()
    loc = t(np.sort(rng.choice(cap * L, (B, k)), axis=1))
    flat = r[..., None] * n_out + j[..., None] * L + torch.arange(L)
    want = torch.gather(flat.reshape(B, cap * L), 1, loc)
    got = search.winner_ids(r, j, loc, n_out)
    assert got.dtype == torch.int64 and torch.equal(got, want)


@pytest.mark.parametrize("bad", ["y float64", "r int32", "y strided",
                                 "j strided", "meta device"])
def test_rescore_wrapper_checks_inputs(bad):
    """Wrong dtypes and non-contiguous inputs raise; a tensor neither on the
    CPU nor on a CUDA card gets no plain version."""
    y, norms, g, n_out = make_problem(2, 6, 300, 20, 2)
    args = dict(y=t(y), norms=t(norms), g=t(g),
                r=torch.zeros((2, 4), dtype=torch.int64),
                j=torch.ones((2, 4), dtype=torch.int64))
    if bad == "y float64":
        args["y"] = args["y"].double()
    elif bad == "r int32":
        args["r"] = args["r"].int()
    elif bad == "y strided":
        args["y"] = args["y"].transpose(0, 2).contiguous().transpose(0, 2)
    elif bad == "j strided":
        args["j"] = torch.ones((4, 2), dtype=torch.int64).T
    else:
        args = {n: torch.empty(a.shape, dtype=a.dtype, device="meta")
                for n, a in args.items()}
    match = ("no rescore_candidates kernel" if bad == "meta device"
             else "must be a contiguous")
    with pytest.raises(ValueError, match=match):
        search.rescore_candidates(**args)


# ---- launch plans of the CUDA kernels (pure Python, mirrored in csrc/) ----

SMEM_BLOCK = 227 * 1024    # shared memory one block may use on an H100
SMEM_SM = 228 * 1024       # shared memory of one SM (1 KB of it per block is reserved)


@pytest.mark.parametrize("C", [1, 2, 3, 4, 7, 9, 16, 64, 300])
def test_toeplitz_plan_fits_and_covers(C):
    """Every tap count up to MAX_WIDTH and context counts from 1 to 300:
    the plan fits one block's shared memory, pads the taps to whole 8-tap
    register chunks, and its chunks, channel groups and tiles cover every
    context, channel and start. Channels are grouped (at most two contexts
    a launch, two blocks per SM) exactly where a whole tile does not fit
    beside one filter."""
    R = 3
    for w in range(1, search.MAX_WIDTH + 1):
        for n_out in (1, 127, 2048, 4057):
            for B in (1, 7, 50, 300):
                plan = search.toeplitz_plan(R, C, w, n_out, B)
                assert plan.wp % 8 == 0 and 0 <= plan.wp - w < 8
                assert plan.seg == 2048 + plan.wp
                starts = [b0 for b0, _ in plan.chunks]
                assert starts == list(np.cumsum([0] + [n for _, n in plan.chunks])[:-1])
                assert sum(n for _, n in plan.chunks) == B
                assert max(plan.smem_bytes) <= SMEM_BLOCK
                whole = 4 * (3 * (C * plan.seg + 2048) + C * plan.wp)
                assert (plan.cg < C) == (whole > SMEM_BLOCK)
                if plan.cg == C:
                    assert plan.smem_bytes[0] == 4 * (
                        plan.chunks[0][1] * C * plan.wp + 3 * (C * plan.seg + 2048))
                else:
                    groups = -(-C // plan.cg)
                    assert (groups - 1) * plan.cg < C <= groups * plan.cg
                    assert max(n for _, n in plan.chunks) <= 2
                    assert set(plan.smem_bytes) == {4 * 3 * (
                        plan.cg * (plan.seg + 2 * plan.wp) + 2048)}
                    assert 2 * (plan.smem_bytes[0] + 1024) <= SMEM_SM
                assert plan.tiles % R == 0 and plan.tiles // R * 2048 >= n_out
                assert (plan.tiles // R - 1) * 2048 < n_out


@pytest.mark.parametrize("C,w,cg", [(8, 20, 8), (9, 20, 3), (16, 20, 3),
                                    (6, 385, 6), (7, 385, 2), (57, 385, 2),
                                    (200, 385, 2), (306, 20, 3)])
def test_toeplitz_plan_groups_wide_channels(C, w, cg):
    """Up to 8 channels at w = 20 and 6 at w = 385 a whole tile fits; past
    that the channels are grouped, so every C that the first kernel took
    (up to 306 at w = 20 and 57 at w = 385 in 200 KB) is still planned."""
    plan = search.toeplitz_plan(4, C, w, 1000, 5)
    assert plan.cg == cg
    if cg < C:
        assert [n for _, n in plan.chunks] == [2, 2, 1]


@pytest.mark.parametrize("d", range(1, factored.MAX_DIM + 1))
def test_factored_plan_fits_and_covers(d):
    """Every embedding width and 1 to 300 contexts: K is padded to whole
    8-deep TF32 steps, launches of at most 128 contexts cover B, each
    launch's passes (64 contexts, a last of 8, 16, 32 or 64) cover its
    contexts, and the shared memory fits one block."""
    for B in range(1, 301):
        plan = factored.factored_plan(5, d, 333, B)
        assert 8 * plan.k8 >= d > 8 * (plan.k8 - 1)
        assert [b0 for b0, _ in plan.chunks] == list(range(0, B, 128))
        assert sum(n for _, n in plan.chunks) == B
        for (_, nb), (full, tail_nt), smem in zip(plan.chunks, plan.passes,
                                                   plan.smem_bytes):
            assert tail_nt in (0, 1, 2, 4, 8)
            bp = 64 * full + 8 * tail_nt
            assert nb <= bp < nb + 8 * max(tail_nt // 2, 1)
            assert smem == 4 * (2 * bp * 8 * plan.k8 + 3 * 8 * plan.k8 * 136
                                + 3 * 128 + 8 * bp)
            assert smem <= SMEM_BLOCK
        assert plan.tiles == 5 * 3


def test_factored_plan_main_shape_leaves_room_for_four_blocks():
    """At the main path's shape (64 contexts, d = 20) four blocks fit on one
    SM: the kernel is latency-bound per block and needs them in flight."""
    smem = factored.factored_plan(32768, 20, 4057, 64).smem_bytes[0]
    assert 4 * (smem + 1024) <= SMEM_SM


def test_factored_plan_refuses_wide_embeddings():
    with pytest.raises(ValueError, match="MAX_DIM"):
        factored.factored_plan(5, factored.MAX_DIM + 1, 333, 8)


# ---- the 3xTF32 split of kernel 2, emulated in numpy -----------------------

def tf32(a, rna):
    """float32 -> TF32 (10 mantissa bits): the nearest value, ties away from
    zero (``rna``), or the value truncated toward zero."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    if rna:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def emulate_factored(E, norms, x, terms=3):
    """Kernel 2's arithmetic: E and x split into TF32 hi (nearest) + lo
    (truncated), per 8-deep K-step the products lo.hi, hi.lo and hi.hi (each
    MMA exact, rounded once into the float32 accumulator), then ``norm - 2
    acc`` and the minimum over each 128-start block. ``terms=1`` is a
    single TF32 pass."""
    R, d, Tp = E.shape
    n_out = norms.shape[1]
    Eh = tf32(E, rna=True)
    Eo = tf32(E - Eh, rna=False)
    xh = tf32(x, rna=True)
    xo = tf32(x - xh, rna=False)
    pairs = [(Eh, xh)] if terms == 1 else [(Eo, xh), (Eh, xo), (Eh, xh)]
    acc = np.zeros((R, x.shape[0], Tp), np.float32)
    for k0 in range(0, d, 8):
        for e, xx in pairs:
            step = np.einsum("bk,rkt->rbt", xx[:, k0 : k0 + 8].astype(np.float64),
                             e[:, k0 : k0 + 8].astype(np.float64))
            acc = (acc + step).astype(np.float32)
    s = np.full((R, x.shape[0], Tp), np.inf, np.float32)
    s[..., :n_out] = (norms[:, None, :] - np.float32(2) * acc[..., :n_out])
    return s.reshape(R, x.shape[0], -1, L).min(-1).transpose(1, 0, 2)


def smoke_factored_problem(scale, R=48, T=700, B=8, seed=11):
    """The smoke's statistics: returns * 0.011, Identity(20), contexts that
    are windows of the data, all times ``scale``."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((R, 1, T)) * 0.011 * scale).astype(np.float32)
    w = 20
    n_out = T - w - 20 + 1
    kernel = np.eye(w, dtype=np.float32)[:, None, :]
    E = factored.build_factored(t(y), t(kernel), n_out).numpy()
    norms = np.lib.stride_tricks.sliding_window_view(
        y[:, 0].astype(np.float64) ** 2, w, axis=-1)[:, :n_out].sum(-1)
    rows, starts = rng.integers(0, R, B), rng.integers(0, n_out, B)
    x = np.stack([y[r, 0, s : s + w] for r, s in zip(rows, starts)])
    return y, kernel, E, norms.astype(np.float32), x, n_out


@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_3xtf32_split_keeps_fp32_class_error(scale):
    """The split's block minima are within 1e-6 of max|score| of the plain
    fp32 version, a tenth of the card gate's 1e-5, at the smoke's
    statistics and at 1e3 times them (the error is relative); a single
    TF32 pass would fail the gate."""
    _, _, E, norms, x, _ = smoke_factored_problem(scale)
    want = factored.score_blockmin_factored(t(E), t(norms), t(x)).numpy()
    scale_s = np.abs(want).max()
    err3 = np.abs(emulate_factored(E, norms, x) - want).max() / scale_s
    err1 = np.abs(emulate_factored(E, norms, x, terms=1) - want).max() / scale_s
    assert err3 <= 1e-6
    assert err1 > 1e-5


def test_3xtf32_split_matches_pallas_bf16x3():
    """At the smoke's statistics the emulated kernel holds
    test_k2_plain_matches_pallas's tolerance against JAX's bf16x3 kernel,
    as the plain version does."""
    y, kernel, E, norms, x, n_out = smoke_factored_problem(1.0)
    R = y.shape[0]
    y3, n2 = pallas_search._pad_views(jnp.asarray(y), jnp.asarray(norms),
                                      n_out, 20)
    E9, n4 = pallas_factored.build_factored(y3, n2, jnp.asarray(kernel))
    want = np.asarray(pallas_factored.score_blockmin_factored(
        E9, n4, jnp.asarray(x), interpret=True)).transpose(0, 2, 1)
    nblk = -(-n_out // L)
    got = emulate_factored(E, norms, x)
    np.testing.assert_allclose(got, want[:, :R, :nblk], rtol=1e-4, atol=2e-5)
    plain = factored.score_blockmin_factored(t(E), t(norms), t(x)).numpy()
    np.testing.assert_allclose(plain, want[:, :R, :nblk], rtol=1e-4, atol=2e-5)
