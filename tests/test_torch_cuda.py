"""The two hand-written CUDA kernels against their plain PyTorch versions,
on the card, and the paths that run them there (the search routes, the
synthesis, a mesh of ``torchrun`` ranks).

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
    E = torch.zeros((8, 49, 256), device=cuda)
    with pytest.raises(ValueError, match="MAX_DIM"):
        factored.score_blockmin_factored(E, norms[:, :256].contiguous(),
                                         torch.zeros((1, 49), device=cuda))


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
