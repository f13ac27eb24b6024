"""The port's mesh on ``torch.distributed`` (CPU, gloo) against ``mesh=None``
and against the JAX package.

Worlds of 2 and 4 ranks are real: one ``torchrun`` launch per world runs
this file as a script (``__main__`` below, which imports no JAX), every rank
writes its results, and the tests compare the ranks with each other, with
the port's ``mesh=None`` engine and with JAX's ``PathShadowing(mesh=None)``
(JAX's own tests hold its mesh results array-identical to that) on the same
numpy inputs. The world of 1 runs the same code in this process, without a
process group. Tolerances are those of ``tests/test_torch_engine.py``: ids
and paths exact, distances within 1e-6 relative, predictions within 1e-5.
"""
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import shadowing_tpu_torch as P
from shadowing_tpu_torch.parallel import (
    DATA_AXIS,
    Mesh,
    data_ctx_mesh,
    data_mesh,
    host_row_range,
    initialize,
    shard_dataset_from_local,
    task_split,
)
from shadowing_tpu_torch.parallel import sharding as psh

REPO = Path(__file__).resolve().parents[1]
W, H, T, K = 16, 8, 256, 24
N_OUT = T - W - H + 1         # window starts per trajectory
RS = (100, 43)                # neither divides a world of 2 or 4
BS = (3, 9)                   # K1 below FACTORED_MIN_B, K2 at or above it
TS = [2, 4]
SYN = dict(T=256, J=4, batch=8, tol=0.02, segment=40, max_iterations=120)
STEP = dict(T=128, J=3, R=16, steps=3)
LAUNCH_TIMEOUT = 240          # seconds; the launch is killed past it


def problem(R):
    """``R`` trajectories with a duplicated one (exact ties) and nine
    contexts cut from them."""
    rng = np.random.default_rng(R)
    ds = rng.normal(0, 0.02, size=(R, 1, T)).astype(np.float32)
    ds[11] = ds[2]
    starts = rng.integers(0, T - W - H, size=9)
    ctx = np.stack([ds[(5 * i) % R, :, s : s + W] for i, s in enumerate(starts)])
    ctx[1] += rng.normal(0, 0.005, size=ctx[1].shape).astype(np.float32)
    series = rng.normal(0, 0.02, size=300).astype(np.float32)
    return ds, ctx, series


def engine(data, **kw):
    return P.PathShadowing(P.Identity(W), P.RelativeMSE(), data,
                           P.PredictionContext(H), **kw)


def to_predict(x):
    return P.realized_variance(x[:, :, 0, :], Ts=TS, vol=False)


def synthesis_inputs():
    """Target statistics and the step test's ``(z, m, v)``, from numpy."""
    from shadowing_tpu_torch.models.scattering import (
        build_filter_bank,
        scattering_stats,
    )

    rng = np.random.default_rng(7)
    zt = rng.normal(size=(32, SYN["T"])).astype(np.float32)
    zt = (zt - zt.mean(-1, keepdims=True)) / zt.std(-1, keepdims=True)
    syn_target = scattering_stats(torch.from_numpy(zt),
                                  build_filter_bank(SYN["T"], SYN["J"]))
    T_, J_, R_ = STEP["T"], STEP["J"], STEP["R"]
    step_target = scattering_stats(
        torch.from_numpy(rng.normal(size=(8, T_)).astype(np.float32)),
        build_filter_bank(T_, J_))
    z = rng.normal(size=(R_, T_)).astype(np.float32)
    m = (rng.normal(size=(R_, T_)) * 1e-3).astype(np.float32)
    v = (np.abs(rng.normal(size=(R_, T_))) * 1e-6).astype(np.float32)
    return syn_target, step_target.numpy(), z, m, v


def mesh_results(mesh) -> dict:
    """Everything one rank computes on ``mesh`` (CPU), as numpy arrays."""
    from shadowing_tpu_torch.models.scattering import build_filter_bank
    from shadowing_tpu_torch.models.scattering.synthesis import synthesize_batch

    out = {"task_split": np.array(task_split())}
    for R in RS:
        ds, ctx, series = problem(R)
        psh.LAST_MERGE_PAYLOAD.clear()
        eng = engine(ds, mesh=mesh)
        for B in BS:
            out[f"{R}/B{B}"] = eng.shadow(ctx[:B], k=K)
            out[f"{R}/B{B}/route"] = np.array(
                [eng.last_metrics["method"] == "kernel",
                 eng.last_metrics["factored"]])
        out[f"{R}/direct"] = eng.shadow(ctx[:3], k=K, method="direct")
        out[f"{R}/fused"] = eng.shadow(ctx[:3], k=K, method="fused")
        _, _, i = eng.shadow_device(ctx[:3], k=K, tournament_cap=1)
        out[f"{R}/redo"] = i.numpy()
        out[f"{R}/redo_contexts"] = np.array(eng.last_metrics["redo_contexts"])
        out[f"{R}/predict"] = eng.predict(ctx, k=K, to_predict=to_predict,
                                          eta=0.1)
        out[f"{R}/payload"] = np.array(sorted(
            (*shape, nbytes) for shape, nbytes in
            psh.LAST_MERGE_PAYLOAD.items()))
        for method in ("kernel", "fused", "direct"):   # padding never enters
            out[f"{R}/all_{method}"] = eng.shadow(ctx[:1], k=R * N_OUT,
                                                  method=method)
        if R == RS[0]:
            res = P.rolling_backtest(eng, series, w=W, Ts=TS, k=16, stride=16)
            out["backtest"] = (res.predicted, res.realized)
            out["mesh_metrics"] = np.array(list(eng.last_metrics["mesh"]
                                                .values()))
        # this rank's rows only, as a multi-host rank loads them from disk
        lo, hi = host_row_range(R, mesh)
        local = shard_dataset_from_local(ds[lo : min(hi, R)], mesh, R)
        out[f"{R}/local"] = engine(local, mesh=mesh,
                                   n_trajectories=R).shadow(ctx, k=K)
    if mesh.n_data == 4:
        out.update(mesh_2d(mesh))

    syn_target, step_target, z, m, v = synthesis_inputs()
    bank = build_filter_bank(SYN["T"], SYN["J"])
    kw = dict(target=syn_target, bank=bank, batch=SYN["batch"],
              tol=SYN["tol"], segment=SYN["segment"])
    gen = lambda: torch.Generator().manual_seed(3)
    out["syn/init"] = (synthesize_batch(gen(), max_iterations=0, **kw)[0],
                       synthesize_batch(gen(), max_iterations=0, mesh=mesh,
                                        **kw)[0])
    logs = ({}, {})
    z0, rms0 = synthesize_batch(gen(), max_iterations=SYN["max_iterations"],
                                work_log=logs[0], **kw)
    zm, rmsm = synthesize_batch(gen(), max_iterations=SYN["max_iterations"],
                                work_log=logs[1], mesh=mesh, **kw)
    out["syn/z"], out["syn/rms"] = (z0, zm), (rms0, rmsm)
    out["syn/steps"] = np.array([[lg["seed_steps"], lg["steps"]]
                                 for lg in logs])

    rows = STEP["R"] // mesh.n_data
    sl = slice(mesh.data_pos * rows, (mesh.data_pos + 1) * rows)
    zs, ms, vs = (torch.from_numpy(a[sl].copy()) for a in (z, m, v))
    psi = torch.from_numpy(build_filter_bank(STEP["T"], STEP["J"]).psi_hat)
    losses = []
    for i in range(STEP["steps"]):
        zs, ms, vs, loss = psh.sharded_synthesis_step(
            zs, ms, vs, i, torch.from_numpy(step_target), psi, STEP["J"], mesh)
        losses.append(float(loss))
    out["step/z"] = mesh.all_gather(zs).reshape(STEP["R"], STEP["T"])
    out["step/loss"] = np.array(losses)
    return out


def mesh_2d(mesh) -> dict:
    """A (2, 2) mesh beside the 1-d mesh of the same 4 ranks: the context
    batch split over ``ctx``, and the engine on it."""
    from shadowing_tpu_torch.shadow.routes import _prep_context

    m2 = data_ctx_mesh(2, 2, device="cpu")
    ds, ctx, _ = problem(RS[0])
    kernel = torch.eye(W)[:, None, :]
    x_emb, x_norm2, g = _prep_context(torch.from_numpy(ctx[:8]), kernel, kernel)
    runs = []
    for m, search in ((mesh, psh.sharded_fused_search),
                      (m2, psh.sharded_fused_search_2d)):
        y = psh.shard_dataset(ds, m)
        norms = psh.sharded_window_norms(y, kernel, N_OUT, 1, True, RS[0], m)
        runs.append(search(y, norms, g, x_norm2, K, N_OUT, P.RelativeMSE(), m))
    return {"2d/search": [r[1] for r in runs],
            "2d/values": [r[0] for r in runs],
            "2d/engine": (engine(ds, mesh=mesh).shadow(ctx[:8], k=K),
                          engine(ds, mesh=m2).shadow(ctx[:8], k=K))}


def flatten(results: dict) -> dict:
    """Nested tuples of arrays -> one flat ``name/j`` dict for ``np.savez``."""
    flat = {}
    for name, val in results.items():
        if isinstance(val, (tuple, list)):
            for j, a in enumerate(val):
                for key, b in flatten({f"{name}/{j}": a}).items():
                    flat[key] = b
        else:
            flat[name] = np.asarray(val.numpy() if isinstance(val, torch.Tensor)
                                    else val)
    return flat


# -- launching worlds -------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n: int, *args) -> subprocess.CompletedProcess:
    """``torchrun`` of ``n`` CPU ranks on this host, killed (with every
    rank) after ``LAUNCH_TIMEOUT`` seconds."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(n), "--master-addr", "127.0.0.1", "--master-port",
           str(free_port()), *map(str, args)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [str(REPO), env.get("PYTHONPATH")]))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{n}-rank launch timed out:\n{out[-4000:]}")
    return subprocess.CompletedProcess(cmd, proc.returncode, out)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Rank results of the worlds of 1 (in process), 2 and 4."""
    got = {1: [flatten(mesh_results(data_mesh(device="cpu")))]}
    for n in (2, 4):
        out = tmp_path_factory.mktemp(f"world{n}")
        run = launch(n, Path(__file__).resolve(), "worker", out)
        assert run.returncode == 0, run.stdout[-6000:]
        got[n] = [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]
    return got


@pytest.fixture(scope="module")
def refs():
    """The port's ``mesh=None`` engine and JAX's ``PathShadowing`` on the
    same inputs."""
    import shadowing_tpu as J
    from shadowing_tpu.backtest import rolling_backtest as jax_backtest

    out = {}
    for R in RS:
        ds, ctx, series = problem(R)
        eng = engine(ds, device="cpu")
        jeng = J.PathShadowing(J.Identity(W), J.RelativeMSE(), ds,
                               J.PredictionContext(H))
        for B in BS:
            out[f"{R}/B{B}"] = eng.shadow(ctx[:B], k=K)
            out[f"jax/{R}/B{B}"] = jeng.shadow(ctx[:B], k=K)
        out[f"{R}/direct"] = eng.shadow(ctx[:3], k=K, method="direct")
        out[f"jax/{R}/direct"] = jeng.shadow(ctx[:3], k=K, method="direct")
        out[f"{R}/fused"] = eng.shadow(ctx[:3], k=K, method="fused")
        for method in ("kernel", "fused", "direct"):
            out[f"{R}/all_{method}"] = eng.shadow(ctx[:1], k=R * N_OUT,
                                                  method=method)
        out[f"{R}/local"] = eng.shadow(ctx, k=K)
        out[f"{R}/predict"] = eng.predict(ctx, k=K, to_predict=to_predict,
                                          eta=0.1)
        out[f"jax/{R}/predict"] = jeng.predict(
            ctx, k=K, to_predict=lambda x: J.realized_variance(
                x[:, :, 0, :], Ts=TS, vol=False), eta=0.1)
        if R == RS[0]:
            res = P.rolling_backtest(eng, series, w=W, Ts=TS, k=16, stride=16)
            ref = jax_backtest(jeng, series, w=W, Ts=TS, k=16, stride=16)
            out["backtest"] = (res.predicted, res.realized)
            out["jax/backtest"] = (ref.predicted, ref.realized)
    return flatten(out)


WORLDS = [1, 2, 4]


@pytest.mark.parametrize("n", [2, 4])
def test_every_rank_returns_the_same(worlds, n):
    first, *rest = worlds[n]
    for r, other in enumerate(rest, 1):
        for key, val in first.items():
            if key == "task_split":
                assert tuple(other[key]) == (n, r)
            else:
                np.testing.assert_array_equal(other[key], val, err_msg=key)
    assert tuple(first["task_split"]) == (n, 0)
    assert tuple(first["mesh_metrics"]) == (n,)


@pytest.mark.parametrize("n", WORLDS)
def test_search_equals_mesh_none_and_jax(worlds, refs, n):
    """K1 (B = 3) and K2 (B = 9) through ``"auto"``, the direct oracle and
    the fused route, at R = 100 and 43, over a dataset given whole and over
    each rank's own rows (``shard_dataset_from_local`` +
    ``n_trajectories``); and k = every window on each route, where a
    padding row that was not barred would take a place."""
    got = worlds[n][0]
    alls = [f"all_{m}" for m in ("kernel", "fused", "direct")]
    for R in RS:
        for B in BS:
            assert tuple(got[f"{R}/B{B}/route"]) == (True, B >= 8)
        for name in alls:
            assert (got[f"{R}/{name}/2"][..., 0] < R).all()
        for name in [f"B{B}" for B in BS] + ["direct", "fused", "local"] + alls:
            for j in range(3):
                key = f"{R}/{name}/{j}"
                np.testing.assert_array_equal(got[key], refs[key], err_msg=key)
        for name in [f"B{B}" for B in BS] + ["direct"]:
            d, p, i = (refs[f"jax/{R}/{name}/{j}"] for j in range(3))
            np.testing.assert_array_equal(got[f"{R}/{name}/2"], i)
            np.testing.assert_array_equal(got[f"{R}/{name}/1"], p)
            np.testing.assert_allclose(got[f"{R}/{name}/0"], d, rtol=1e-6)
        assert (got[f"{R}/local/2"][..., 0] < R).all()


@pytest.mark.parametrize("n", WORLDS)
def test_forced_redo_on_the_mesh(worlds, refs, n):
    """``tournament_cap=1`` fails certification on some rank of every
    context; the escalated cap, entered by every rank, certifies it."""
    got = worlds[n][0]
    for R in RS:
        assert int(got[f"{R}/redo_contexts"]) == 3
        np.testing.assert_array_equal(got[f"{R}/redo"], refs[f"{R}/direct/2"])


@pytest.mark.parametrize("n", WORLDS)
def test_predict_and_backtest_on_the_mesh(worlds, refs, n):
    got = worlds[n][0]
    for R in RS:
        for j in range(2):
            np.testing.assert_array_equal(got[f"{R}/predict/{j}"],
                                          refs[f"{R}/predict/{j}"])
            np.testing.assert_allclose(got[f"{R}/predict/{j}"],
                                       refs[f"jax/{R}/predict/{j}"],
                                       rtol=1e-5, atol=1e-9)
    for j in range(2):
        np.testing.assert_array_equal(got[f"backtest/{j}"],
                                      refs[f"backtest/{j}"])
        np.testing.assert_allclose(got[f"backtest/{j}"],
                                   refs[f"jax/backtest/{j}"], rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_merge_payload_is_independent_of_R(worlds, n):
    """Each k-merge gathers ``B * k * n`` values (float32) and ids (int64)
    whatever the dataset's size."""
    got = worlds[n][0]
    a, b = (got[f"{R}/payload"] for R in RS)
    np.testing.assert_array_equal(a, b)
    assert {tuple(row[:3]) for row in a} == {(n, B, K) for B in BS}
    for n_, B, k, nbytes in a:
        assert nbytes == B * k * n_ * 12


def test_2d_mesh_equals_the_1d_mesh(worlds):
    """(2, 2): contexts split over ``ctx``, rows over ``data``; the same
    winners as the 1-d mesh of the same ranks, through the function and
    through the engine."""
    got = worlds[4][0]
    np.testing.assert_array_equal(got["2d/search/1"], got["2d/search/0"])
    np.testing.assert_allclose(got["2d/values/1"], got["2d/values/0"],
                               rtol=1e-6)
    for j in range(3):
        np.testing.assert_array_equal(got[f"2d/engine/1/{j}"],
                                      got[f"2d/engine/0/{j}"])


@pytest.mark.parametrize("n", [2, 4])
def test_synthesize_batch_on_the_mesh(worlds, n):
    """The start is array-identical to ``mesh=None``; after 120 steps the
    rows agree within 1e-3, on the same step schedule."""
    got = worlds[n][0]
    np.testing.assert_array_equal(got["syn/init/1"], got["syn/init/0"])
    assert got["syn/z/1"].shape == (SYN["batch"], SYN["T"])
    np.testing.assert_allclose(got["syn/z/1"], got["syn/z/0"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["syn/rms/1"], got["syn/rms/0"], rtol=5e-3,
                               atol=1e-5)
    np.testing.assert_array_equal(got["syn/steps"][1], got["syn/steps"][0])
    np.testing.assert_array_equal(got["syn/rms/1"] < SYN["tol"],
                                  got["syn/rms/0"] < SYN["tol"])


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_synthesis_step_equals_jax(worlds, n):
    """Three steps from the same (z, m, v) as JAX's step on a 2-device
    mesh: losses within 1e-3 relative, z within 1e-4 on >= 99.9 % of the
    entries (as ``test_adam_segment_equals_jax``: a coordinate whose
    gradient is float noise may step another way)."""
    import jax
    import jax.numpy as jnp

    from shadowing_tpu.models.scattering.wavelets import build_filter_bank
    from shadowing_tpu.parallel.sharding import data_mesh as jax_mesh
    from shadowing_tpu.parallel.sharding import sharded_synthesis_step

    got = worlds[n][0]
    _, target, z, m, v = synthesis_inputs()
    mesh = jax_mesh(2)
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    z, m, v = (jax.device_put(jnp.asarray(a), sh) for a in (z, m, v))
    psi = jnp.asarray(build_filter_bank(STEP["T"], STEP["J"]).psi_hat)
    losses = []
    for i in range(STEP["steps"]):
        z, m, v, loss = sharded_synthesis_step(
            z, m, v, jnp.asarray(i), jnp.asarray(target), psi, J=STEP["J"],
            mesh=mesh)
        losses.append(float(loss))
    np.testing.assert_allclose(got["step/loss"], losses, rtol=1e-3)
    diff = np.abs(got["step/z"] - np.asarray(z))
    assert (diff <= 1e-4).mean() >= 0.999, diff.max()


# -- single-process pieces --------------------------------------------------

def fake_mesh(n, pos, n_ctx=None, ctx_pos=0):
    """A mesh position without a process group: for what runs no
    collective."""
    shape = {DATA_AXIS: n} if n_ctx is None else {DATA_AXIS: n, "ctx": n_ctx}
    return Mesh(shape, pos, ctx_pos, torch.device("cpu"))


def test_task_split_and_initialize():
    assert task_split(4, 3) == (4, 3)
    assert task_split() == (1, 0)            # no process group
    assert task_split(8, None) == (8, 0)
    with pytest.raises(ValueError, match="out of range"):
        task_split(4, 7)
    initialize("cpu")                        # no torchrun environment: no-op
    initialize("cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="world has 1"):
        data_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="world has 1"):
        P.PathShadowing(P.Identity(4), P.RelativeMSE(), np.zeros((2, 1, 9)),
                        mesh=2, device="cpu")


@pytest.mark.parametrize("n,R", [(4, 30), (3, 7), (2, 1)])
def test_host_row_range_partitions_the_padded_rows(n, R):
    ranges = [host_row_range(R, fake_mesh(n, p)) for p in range(n)]
    rows = -(-R // n)
    assert ranges == [(p * rows, (p + 1) * rows) for p in range(n)]
    # a 2-d mesh: positions along ctx own the same rows
    assert host_row_range(R, fake_mesh(n, n - 1, 2, 1)) == ranges[-1]


def test_shard_dataset_from_local_pads_and_checks(rng):
    R, C, T_ = 19, 2, 32                     # pads to 20 over 4: 5 rows each
    y = rng.normal(size=(R, C, T_)).astype(np.float32)
    mesh = fake_mesh(4, 3)                   # rows [15, 20): 4 data, 1 pad
    for part in (y[15:], np.concatenate([y[15:], np.zeros((1, C, T_))])):
        got = shard_dataset_from_local(part, mesh, R)
        assert got.shape == (5, C, T_) and got.dtype == torch.float32
        np.testing.assert_array_equal(got[:4].numpy(), y[15:])
        np.testing.assert_array_equal(got[4:].numpy(), 0.0)
        np.testing.assert_array_equal(psh.shard_dataset(y, mesh).numpy(),
                                      got.numpy())
    with pytest.raises(ValueError, match="owns rows"):
        shard_dataset_from_local(y[:3], mesh, R)
    with pytest.raises(ValueError, match="shard_dataset_from_local"):
        P.PathShadowing(P.Identity(4), P.RelativeMSE(), y[:3, :1],
                        n_trajectories=R, device="cpu").y
    np.testing.assert_array_equal(psh.pad_rows_to_mesh(y, mesh)[R:], 0.0)
    assert psh.replicate(y, mesh).device == mesh.device
    assert psh.pad_rows_to_mesh(torch.from_numpy(y), mesh).shape[0] == 20


def test_n_trajectories_bars_the_excess_rows(rng):
    """Rows at or past ``n_trajectories`` never win, on every route: the
    result is that of the dataset cut to its first rows."""
    ds, ctx, _ = problem(43)
    full = engine(ds, n_trajectories=30, device="cpu")
    cut = engine(ds[:30], device="cpu")
    for method in ("kernel", "fused", "direct"):
        for a, b in zip(full.shadow(ctx[:3], k=K, method=method),
                        cut.shadow(ctx[:3], k=K, method=method)):
            np.testing.assert_array_equal(a, b)
    # every window of a positive dataset scores above 0 against a negative
    # context under cosine, so a barred row scoring 0 would win
    cos = P.PathShadowing(P.Identity(W), P.CosineDistance(), np.abs(ds),
                          P.PredictionContext(H), n_trajectories=30,
                          device="cpu")
    _, _, i = cos.shadow(-np.abs(ctx[:2]), k=K, method="fused")
    assert (i[..., 0] < 30).all()


def test_uneven_batches_and_contexts_raise(rng):
    from shadowing_tpu_torch.models.scattering import build_filter_bank
    from shadowing_tpu_torch.models.scattering.synthesis import synthesize_batch

    with pytest.raises(ValueError, match="multiple of the mesh"):
        synthesize_batch(torch.Generator().manual_seed(0), np.zeros(30),
                         build_filter_bank(64, 3), batch=6, max_iterations=1,
                         mesh=fake_mesh(4, 0))
    g = torch.zeros((3, 1, W))
    with pytest.raises(ValueError, match="ctx"):
        psh.shard_contexts(g, torch.zeros(3), fake_mesh(2, 0, 2, 1))
    g_loc, _ = psh.shard_contexts(torch.arange(4.0), torch.arange(4.0),
                                  fake_mesh(1, 0, 2, 1))
    np.testing.assert_array_equal(g_loc.numpy(), [2.0, 3.0])


def test_a_failing_rank_fails_the_launch(tmp_path):
    """Two ranks that ask for a mesh of three: both raise, the launch fails."""
    run = launch(2, Path(__file__).resolve(), "mismatch", tmp_path)
    assert run.returncode != 0
    assert "requested a 3-position mesh" in run.stdout


def test_snp_generation_takes_its_task_from_the_launch(tmp_path):
    """Two ranks of ``snp_generation`` without ``-ntot``/``-tid``: each
    writes its own task file, as a two-task job array does."""
    run = launch(2, "-m", "shadowing_tpu_torch.cli.snp_generation", "-R", 8,
                 "-J", 4, "-T", 256, "--batch", 4, "--max-iterations", 30,
                 "--cache", tmp_path, "--device", "cpu", "-q")
    assert run.returncode == 0, run.stdout[-4000:]
    assert sorted(p.name for p in tmp_path.glob("*.npy")) == [
        "task00000_R4.npy", "task00001_R4.npy"]
    a, b = (np.load(p) for p in sorted(tmp_path.glob("task*.npy")))
    assert a.shape == b.shape == (4, 1, 256) and not np.array_equal(a, b)


def _worker(mode: str, out: Path) -> None:
    if mode == "mismatch":
        data_mesh(3, device="cpu")
    mesh = data_mesh(device="cpu")
    initialize("cpu")                        # a second call keeps the group
    results = flatten(mesh_results(mesh))
    np.savez(out / f"rank{mesh.data_pos}.npz", **results)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], Path(sys.argv[2]))
