"""The two hand-written CUDA kernels against their plain PyTorch versions,
on the card.

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


@pytest.mark.parametrize("R,d,n_out,B", [
    (300, 7, 600, 9),
    (129, 20, 1000, 64),
    (50, 48, 257, 200),             # two launches of contexts
])
def test_blockmin_factored(cuda, R, d, n_out, B):
    rng = np.random.default_rng(d)
    y, norms, _ = problem(cuda, R, 1, n_out + 40, 20, n_out, 1, seed=d)
    kernel = torch.from_numpy(rng.normal(size=(d, 1, 20)).astype(np.float32))
    x_emb = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
    E = factored.build_factored(y, kernel.to(cuda), n_out)
    norms[3] = float("inf")
    before = factored.FACTORED.launches
    got = factored.score_blockmin_factored(E, norms, x_emb.to(cuda))
    assert factored.FACTORED.launches == before + -(-B // 128)
    check(got, factored.score_blockmin_factored_plain(E, norms, x_emb.to(cuda)))


def test_wrappers_raise_instead_of_falling_back(cuda):
    y, norms, g = problem(cuda, 8, 1, 300, 20, 200, 1)
    with pytest.raises(ValueError, match="is on cpu"):
        search.score_blockmin(y, norms.cpu(), g)
    with pytest.raises(ValueError, match="shared memory"):
        search.score_blockmin(torch.zeros((2, 200, 3000), device=cuda),
                              torch.zeros((2, 10), device=cuda),
                              torch.zeros((1, 200, 385), device=cuda))
    E = torch.zeros((8, 49, 256), device=cuda)
    with pytest.raises(ValueError, match="MAX_DIM"):
        factored.score_blockmin_factored(E, norms[:, :256].contiguous(),
                                         torch.zeros((1, 49), device=cuda))
