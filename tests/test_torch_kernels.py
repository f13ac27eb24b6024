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
from shadowing_tpu_torch.ops import factored, search

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


def test_e_bytes():
    # 32768 rows, 4057 starts (32 blocks), d = 20, fp32
    assert factored.e_bytes(32768, 4057, 20) == 32768 * 20 * 32 * 128 * 4
