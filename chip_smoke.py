#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``shadowing_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

It builds both pass-1 kernels from ``shadowing_tpu_torch/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card, then
drives the main path at the README workflow scale (32,768 trajectories x
4,096 days, ``Identity(20)``, ``RelativeMSE``, horizon 20, k = 1,024):

1. device: the card's name and power limit;
2. build: both kernels, with the compiler's register report;
3. kernel vs plain: K1 at (B=1, w=20), (B=4, w=126), a ragged C=2
   shape and a C=16 shape (channel groups); K2 at (B=64, d=20), (65, 20), (128, 20) and (8, 48); each with
   its time, its bound (bytes or operations at the card's published
   peaks), the achieved GB/s and TFLOP/s and the share of the bound; then
   both kernels over B = 1 .. 64 at w = d = 20;
4. one context: ``predict_and_smile`` on the last 20 daily returns of the
   bundled S&P-like series, checked against the on-card direct oracle;
5. 64 contexts: ``predict`` through the factored kernel, checked against
   the Toeplitz kernel's route and the direct oracle;
6. the redo path: a forced pass-2 certification failure must still
   return the certified winners of phase 4;
7. the fused route: cosine (Identity(20)) and RelativeMSE over a
   ``Foveal(1.15, 0.9, 400)`` filter wider than ``MAX_WIDTH``, B = 1 and 64,
   against the on-card direct oracle; then the certified tournament
   selection (``topk_min_batched``) against the stable sort at k = 10,000
   and 16,384 of 1.3 million and at pass 2's own shapes, equal wherever
   certified, with both times and ``torch.topk``'s;
8. ``exact_dtype="float64"``: distances equal a numpy float64 rescore;
9. ``shadow_sharded_rows`` over the two row halves equals one engine;
10. an MRW dataset (32,768 x 4,097 log-prices) generated on the card;
11. ``rolling_backtest`` on its returns with the AR-linear benchmark:
    2,048 dates at k = 1,024 and 256 dates at k = 16,384, in 64-date
    chunks through K2, two dates held against the direct oracle;
12. 4,096 ``PDVModelDiscrete`` paths of 4,096 daily steps on the card;
13. scattering-spectra generation on the card, calibrated to the bundled
    S&P-like series over the CLI's 2000-2014 range (J = 9, T = 4,096, tol
    1e-2, 1,000 steps): one 1,024-seed shard twice from one seed (equal bit
    for bit), then ``generate`` of ``R_SCAT`` paths (converged share,
    scale, flatness and tails checked), the cost of one Adam step by part
    and a profiler trace of it, and the generated dataset searched by
    ``predict_and_smile`` (K1) and a 64-context ``predict`` (K2) against the
    on-card direct oracle;
14. the generation CLI as users run it: two job-array tasks as
    subprocesses, the restart skip, ``batch_generations`` and a load
    through ``TimeSeriesDataset``;
15. the mesh: two ranks of ``torchrun`` (gloo, both on the card) each read
    their half of phase 4's dataset from disk and search it as one through
    ``PathShadowing(mesh=data_mesh(), n_trajectories=R)``: phase 4's
    ``predict_and_smile`` (K1 on every rank) and phase 5's ``predict`` (K2)
    equal phases 4-5, the forced redo, then ``sharded_synthesis_step`` and
    ``synthesize_batch(mesh=)`` against the same steps in one process;
16. the figures: ``cli.make_figures`` (MRW 2,048 x 4,097, ``Identity(126)``,
    k = 8,192) computes the shadow band and the conditional smile through
    K1, and draws ``shadow.png`` and ``smile.png`` where matplotlib is
    installed;
17. the reference's performance cell: ``predict`` at k = 10,000 over a
    131,072 x 4,096 normal dataset made on the card, ``Foveal(1.15, 0.9,
    126)``, horizon 252 (K1 at B = 1, w = 126), winners held to the direct
    oracle's, its warm wall beside the reference's published 2.65 s;
18. the parallel shard reader against ``numpy.load``: phase 14's dataset
    directory, phase 15's dataset file, and that file cut into 8 shards.

Every check raises on failure. The line before the last is a JSON object
of the kernels: launch counts summed over every path, and per shape the
error, the times and the bound;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

R, T = 32768, 4096            # README workflow scale
W, H, K = 20, 20, 1024        # context width, horizon, winners per context
TS = [5, 10, 20]
MS = np.linspace(-2, 2, 9)
TOL = 1e-5                    # kernel vs plain: max abs error / max |score|
#: published peaks of one H100 SXM (dense): HBM bytes/s, fp32 on the CUDA
#: cores, bf16 on the tensor cores
HBM_BPS, FP32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
SWEEP_B = (1, 2, 4, 8, 16, 32, 64)  # phase 3: contexts per call, w = d = 20
LIBRARY = ("none: no one PyTorch call folds the minimum over each 128-start "
           "block into norms - 2 * cross")
#: tests/test_fuzz.py's float32 tie window: ids may differ only between
#: ranks closer than this (absolute + relative) or this close to the k-th
TIE_ATOL, TIE_RTOL = 1e-6, 1e-5
W_WIDE = 400                  # Foveal(1.15, 0.9, 400): wider than MAX_WIDTH
SEL_N, SEL_KS = 1_300_000, (10_000, 16_384)   # selection timing
N_DATES, N_DATES_BIG, K_BIG = 2048, 256, 16384  # bench.py's backtest shapes
PDV_S, PDV_STEPS = 4096, 4096
#: phase 13: the CLI's calibration range; a quarter of the reference's
#: 32,768 paths (the full size took 214 s on the card: PERF.md §4)
R_SCAT, SCAT_BATCH = 8192, 1024
SCAT_J, SCAT_T, SCAT_TOL, SCAT_ITERS = 9, 4096, 1e-2, 1000
SCAT_START, SCAT_END = "03-01-2000", "31-12-2014"
CLI_R, CLI_BATCH = 2048, 256  # phase 14: two tasks of 1,024 paths
#: phase 15: ranks of torchrun on the card, and the synthesis they run
#: (a few dozen seeds and steps of phase 13's J and T)
MESH_RANKS, MESH_TIMEOUT = 2, 400
MESH_SEEDS, MESH_ITERS, MESH_STEPS, MESH_SEED = 32, 40, 3, 5
MESH_DIR = Path(__file__).resolve().parent / "build" / "mesh"
#: phase 17: testing.ipynb's performance cell (BASELINE.md row 1)
R_REF, W_REF, H_REF, K_REF, TS_REF = 131072, 126, 252, 10000, [2, 7, 252]
REF_WALL = "2.65 s, unspecified CUDA GPU (BASELINE.md:8)"
N_SHARDS = 8                  # phase 18: the phase-15 dataset cut into shards
PDV_PARAMS = dict(lams1=[55.0, 10.0], lams2=[20.0, 3.0], thetas=[0.25, 0.5],
                  betas=[0.04, -0.12, 0.75])


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, n: int = 5) -> float:
    """Median device time of ``fn`` over ``n`` runs after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def median_wall(fn, n: int = 5) -> float:
    import torch

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bound(nbytes: int, flop: int, peak: float) -> tuple:
    """The least time (ms) the card could take for a call that must move
    ``nbytes`` (each input read once, each output written once) and do
    ``flop`` operations at ``peak`` per second, and which of the two binds."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flop / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(y, norms, g) -> tuple:
    """Bytes, flop and peak rate of one K1 call: fp32 FMAs on the CUDA
    cores."""
    R, C, _ = y.shape
    B, _, w = g.shape
    n_out = norms.shape[1]
    out = B * R * -(-n_out // 128)
    nbytes = 4 * (y.numel() + norms.numel() + g.numel() + out)
    return nbytes, 2 * B * R * n_out * C * w, FP32_FLOPS


def k2_work(E, norms, x) -> tuple:
    """Bytes, flop and peak rate of one K2 call: each fp32-class FMA is at
    least three tensor-core products, at best bf16 ones (bf16x3, the
    fastest split in the reference's error class; the kernel runs 3xTF32)."""
    R, d, Tp = E.shape
    B = x.shape[0]
    n_out = norms.shape[1]
    nbytes = 4 * (E.numel() + norms.numel() + x.numel() + B * R * (Tp // 128))
    return nbytes, 2 * B * R * n_out * d, BF16_FLOPS / 3


def timing(label: str, fn, work) -> dict:
    """Median device time of one kernel call beside its bound."""
    nbytes, flop, peak = work
    ms = median_ms(fn)
    bound_ms, by = bound(nbytes, flop, peak)
    return {"shape": label, "ms": ms, "bound_ms": bound_ms, "bound_by": by,
            "gb_s": nbytes / ms / 1e6, "tflop_s": flop / ms / 1e9,
            "share": bound_ms / ms}


def blocks_per_sm(kernel: str, *args: int) -> int:
    """Blocks of a persistent kernel that one SM holds for this launch (the
    CUDA occupancy calculator, registers and shared memory included): K1
    takes its C, w and the first chunk's B, K2 its d and B."""
    import ctypes

    from shadowing_tpu_torch.ops import _build

    fn = getattr(_build._library(), f"{kernel}_blocks_per_sm")
    fn.argtypes, fn.restype = [ctypes.c_int] * len(args), ctypes.c_int
    return fn(*args)


def compare(label: str, kernel_fn, plain_fn, work, occupancy: int) -> dict:
    """Kernel vs plain on the same inputs: error relative to the largest
    finite score, count of blocks that differ, both times and the bound;
    ``occupancy`` is the kernel's blocks per SM at this shape."""
    import torch

    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    both = fin_g & fin_w
    scale = float(want[fin_w].abs().max())
    err = float((got - want)[both].abs().max())
    n_diff = int(((fin_g != fin_w)
                  | (both & ((got - want).abs() > TOL * scale))
                  | (~fin_w & (got != want))).sum())
    r = timing(label, kernel_fn, work)
    r.update(max_abs_err=err, plain_ms=median_ms(plain_fn),
             blocks_per_sm=occupancy)
    rel = err / scale
    by = {"bytes": "memory", "operations": "fp32 flop" if work[2] == FP32_FLOPS
          else "bf16x3 flop"}[r["bound_by"]]
    log(f"  {label}: max_abs_err {err:.3e} = {rel:.3e} of max|score| "
        f"{scale:.4g}, differing blocks {n_diff}, +inf blocks "
        f"{int((~fin_w).sum())}; kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({by}), "
        f"{r['gb_s']:.0f} GB/s, {r['tflop_s']:.2f} TFLOP/s, "
        f"{100 * r['share']:.1f} % of the bound, {occupancy} blocks/SM")
    if torch.isnan(got).any() or rel > TOL or n_diff:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return r


def windows(y, rows, starts, w: int):
    import torch

    return torch.stack([y[r, :, s : s + w] for r, s in zip(rows, starts)])


def kernels_vs_plain(y, device) -> dict:
    """Phase 3: both kernels against their plain versions at the main
    path's shapes and more, each beside its bound, then a sweep of the
    context count B at w = d = 20 (the K1/K2 crossover)."""
    import torch

    from shadowing_tpu_torch.ops import factored, search
    from shadowing_tpu_torch.shadow.embedding import embed_windows
    from shadowing_tpu_torch.shadow.engine import _window_norms

    def identity_norms(y, w, n_out):        # the Identity(w) engine's norms
        C = y.shape[1]
        bank = torch.eye(C * w, device=y.device).reshape(C * w, C, w)
        return _window_norms(y, bank, n_out, n_splits=16, identity_fast=True)

    def k1_occupancy(y, norms, g):
        R, C, _ = y.shape
        B, _, w = g.shape
        plan = search.toeplitz_plan(R, C, w, norms.shape[1], B)
        return blocks_per_sm("blockmin_toeplitz", C, w, plan.chunks[0][1])

    rng = np.random.default_rng(2)
    res = {"K1": [], "K2": []}
    sweep = {"K1": [], "K2": []}
    Rn, _, Tn = y.shape
    ctx = lambda y, n_out, w, B: windows(y, rng.integers(0, y.shape[0], B),
                                         rng.integers(0, n_out, B), w)
    for B, w in ((1, W), (4, 126)):
        n_out = Tn - w - H + 1
        norms = identity_norms(y, w, n_out)
        g = ctx(y, n_out, w, B)
        res["K1"].append(compare(
            f"K1 blockmin_toeplitz B={B} w={w} ({Rn}x{Tn})",
            lambda: search.score_blockmin(y, norms, g),
            lambda: search.score_blockmin_plain(y, norms, g),
            k1_work(y, norms, g), k1_occupancy(y, norms, g)))
        if w == W:
            for Bs in SWEEP_B:
                gs = ctx(y, n_out, w, Bs)
                sweep["K1"].append(timing(
                    f"B={Bs}", lambda: search.score_blockmin(y, norms, gs),
                    k1_work(y, norms, gs)))
        del norms
    # ragged: R, n_out off every tile, two channels, barred (+inf) rows
    yr = torch.from_numpy(rng.standard_normal((1001, 2, 700)).astype(np.float32)
                          * 0.011).to(device)
    norms = identity_norms(yr, 33, 601)
    norms[[5, 600]] = float("inf")
    g = windows(yr, [3, 70, 999], [0, 17, 600], 33)
    res["K1"].append(compare(
        "K1 blockmin_toeplitz ragged R=1001 C=2 n_out=601 w=33 B=3",
        lambda: search.score_blockmin(yr, norms, g),
        lambda: search.score_blockmin_plain(yr, norms, g),
        k1_work(yr, norms, g), k1_occupancy(yr, norms, g)))
    # wide: 16 channels go through the ring in groups, a context pair a launch
    yw = torch.from_numpy(rng.standard_normal((2048, 16, Tn)).astype(np.float32)
                          * 0.011).to(device)
    norms = identity_norms(yw, W, Tn - W - H + 1)
    g = windows(yw, [1, 900, 2047], [5, 70, Tn - W - H], W)
    res["K1"].append(compare(
        f"K1 blockmin_toeplitz wide R=2048 C=16 w={W} B=3 (channel groups)",
        lambda: search.score_blockmin(yw, norms, g),
        lambda: search.score_blockmin_plain(yw, norms, g),
        k1_work(yw, norms, g), k1_occupancy(yw, norms, g)))
    del yw, norms

    for batch_sizes, d, kw in (((64, 65, 128), 20, None), ((8,), 48, 64)):
        n_out = Tn - (kw or W) - H + 1
        if kw is None:      # the main path's Identity(20) bank
            kernel = torch.eye(d, device=device)[:, None, :]
        else:               # a dense 48-wide bank over 64-sample windows
            kernel = torch.from_numpy(
                rng.standard_normal((d, 1, kw)).astype(np.float32) / 8).to(device)
        w = kernel.shape[-1]
        E = factored.build_factored(y, kernel, n_out)
        norms = _window_norms(y, kernel, n_out, n_splits=16,
                              identity_fast=kw is None)
        for B in batch_sizes:
            x_emb = embed_windows(ctx(y, n_out, w, B), kernel).contiguous()
            res["K2"].append(compare(
                f"K2 blockmin_factored B={B} d={d} ({Rn}x{Tn}, E "
                f"{E.numel() * 4 / 1e9:.2f} GB)",
                lambda: factored.score_blockmin_factored(E, norms, x_emb),
                lambda: factored.score_blockmin_factored_plain(E, norms, x_emb),
                k2_work(E, norms, x_emb),
                blocks_per_sm("blockmin_factored", d, B)))
        if kw is None:
            for Bs in SWEEP_B:
                xs = embed_windows(ctx(y, n_out, w, Bs), kernel).contiguous()
                sweep["K2"].append(timing(
                    f"B={Bs}",
                    lambda: factored.score_blockmin_factored(E, norms, xs),
                    k2_work(E, norms, xs)))
        del E, norms
        torch.cuda.empty_cache()
    log("  sweep at w = d = 20, kernel ms (K1 | K2): " + "; ".join(
        f"{a['shape']} {a['ms']:.3f} | {b['ms']:.3f}"
        for a, b in zip(sweep["K1"], sweep["K2"])))
    return {"shapes": res, "sweep": sweep}


def main_path(dataset, device) -> dict:
    """Phases 4-6 through the public API."""
    import torch

    from shadowing_tpu_torch import (
        Identity,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        SPDaily,
        realized_variance,
    )
    from shadowing_tpu_torch.ops.factored import FACTORED
    from shadowing_tpu_torch.ops.search import TOEPLITZ
    from shadowing_tpu_torch.pricing.black_scholes import (
        SIGMA_HI,
        SIGMA_LO,
        bs_call_price,
    )

    Rn, _, Tn = dataset.shape
    n_out = Tn - W - H + 1
    ctx = SPDaily().dlnx[0, 0, -W:].astype(np.float32)
    eng = PathShadowing(Identity(W), RelativeMSE(), dataset,
                        PredictionContext(horizon=H), device=device)
    to_predict = lambda x: realized_variance(x[:, :, 0, :], Ts=TS, vol=False)

    def e2e():
        return eng.predict_and_smile(ctx, k=K, to_predict=to_predict, Ts=TS,
                                     Ms=MS, eta=0.1, eta_smile=0.075)

    # ---- phase 4: one context -------------------------------------------
    TOEPLITZ.launches = FACTORED.launches = 0
    t0 = time.perf_counter()
    vars_, _, smiles = e2e()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    warm = median_wall(e2e)
    k1_launches = TOEPLITZ.launches
    log(f"phase 4 predict_and_smile (B=1, k={K}): first call {first:.3f} s, "
        f"warm median of 5 {warm:.4f} s; K1 launches {k1_launches}, "
        f"route {eng.last_metrics['method']}, contexts redone "
        f"{eng.last_metrics['redo_contexts']}")
    if k1_launches == 0:
        raise AssertionError("the one-context main path never launched K1")

    d, p, i = (a.cpu().numpy() for a in eng.shadow_device(ctx, k=K))
    if not (np.diff(d[0]) >= 0).all():
        raise AssertionError("distances do not ascend")
    want = np.stack([dataset[r, :, t : t + W + H] for r, t in i[0]])
    if not np.array_equal(p[0], want):
        raise AssertionError("paths are not dataset[r, :, t:t+40]")
    _, _, i_dir = eng.shadow(ctx, k=K, method="direct")
    if not np.array_equal(i, i_dir):
        raise AssertionError("kernel route winners differ from the direct "
                             "oracle")
    d0, _, i0 = eng.shadow(dataset[0, 0, :W], k=4)
    if d0[0, 0] != 0.0 or tuple(i0[0, 0]) != (0, 0):
        raise AssertionError(f"self-match probe: {d0[0, 0]} at {i0[0, 0]}")
    sm = smiles[0]
    lo = np.asarray(bs_call_price(sm.spot, sm.strikes, sm.Ts[:, None] / 252,
                                  SIGMA_LO))
    hi = np.asarray(bs_call_price(sm.spot, sm.strikes, sm.Ts[:, None] / 252,
                                  SIGMA_HI))
    inside = (sm.prices > lo * (1 + 1e-4)) & (sm.prices < hi * (1 - 1e-4))
    if not (np.isfinite(sm.vols[inside]).all() and inside[:, 4].all()
            and np.isfinite(vars_).all()):
        raise AssertionError(f"smile vols {sm.vols} prices {sm.prices}")
    log(f"  checks: distances ascend, paths are dataset slices, {K} ids equal "
        f"the direct oracle, self-match 0.0 at (0, 0), vols finite at "
        f"{int(inside.sum())}/{inside.size} in-band strikes (ATM vols "
        f"{np.round(sm.vols[:, 4], 4).tolist()}), predicted var "
        f"{np.round(vars_[0], 5).tolist()}")

    # ---- phase 5: 64 contexts -------------------------------------------
    rng = np.random.default_rng(1)
    rows, starts = rng.integers(0, Rn, 63), rng.integers(0, n_out, 63)
    ctx64 = np.concatenate([
        np.stack([dataset[r, :, s : s + W] for r, s in zip(rows, starts)]),
        ctx[None, None]])
    t0 = time.perf_counter()
    eng.factored_responses()
    torch.cuda.synchronize()
    e_build = time.perf_counter() - t0

    def batched():
        return eng.predict(ctx64, k=K, to_predict=to_predict, eta=0.1)

    TOEPLITZ.launches = FACTORED.launches = 0
    t0 = time.perf_counter()
    pred, _ = batched()
    torch.cuda.synchronize()
    first64 = time.perf_counter() - t0
    warm64 = median_wall(batched)
    k2_launches = FACTORED.launches
    log(f"phase 5 predict (B=64, k={K}): E build {e_build:.3f} s, first call "
        f"{first64:.3f} s, warm median of 5 {warm64:.4f} s; K2 launches "
        f"{k2_launches}, K1 launches {TOEPLITZ.launches}, contexts redone "
        f"{eng.last_metrics['redo_contexts']}")
    if k2_launches == 0:
        raise AssertionError("the batched main path never launched K2")
    if not any(s.startswith("factored pass-1 routed") for s in eng.routing_log):
        raise AssertionError(f"no factored grant in {eng.routing_log}")
    redone = [s for s in eng.routing_log if s.startswith("redo")]
    if eng.last_metrics["redo_contexts"] or redone:
        raise AssertionError(f"phases 4-5 redid a certification: {redone}")
    if pred.shape != (64, len(TS)) or not np.isfinite(pred).all():
        raise AssertionError(f"batched predictions {pred.shape} not finite")

    _, _, i_fac = eng.shadow(ctx64, k=K)
    eng.FACTORED_MIN_B = 65                  # the Toeplitz route at B=64
    _, _, i_toe = eng.shadow(ctx64, k=K)
    del eng.FACTORED_MIN_B
    if not np.array_equal(i_fac, i_toe):
        raise AssertionError("K2 route winners differ from the K1 route's")
    _, _, i_dir2 = eng.shadow(ctx64[:2], k=K, method="direct")
    if not np.array_equal(i_fac[:2], i_dir2):
        raise AssertionError("K2 route winners differ from the direct oracle")
    log(f"  checks: routing_log grants the factored route, no context redone, "
        f"64x{K} ids equal the K1 route's, 2x{K} ids equal the direct oracle")

    # ---- phase 6: the redo path -----------------------------------------
    cap = K // 128 // 2
    _, _, i_redo = eng.shadow_device(ctx, k=K, tournament_cap=cap)
    redo = eng.last_metrics["redo_contexts"]
    if redo < 1 or not np.array_equal(i_redo.cpu().numpy(), i):
        raise AssertionError(f"redo path: redo_contexts={redo}, ids differ")
    log(f"phase 6 redo (tournament_cap={cap}): {redo} context redone, ids "
        f"equal phase 4's; "
        f"{[s for s in eng.routing_log if s.startswith('redo')]}")
    return {"K1": k1_launches, "K2": k2_launches, "e2e_warm_s": warm,
            "predict64_warm_s": warm64, "e_build_s": e_build,
            # what phase 15 is held to
            "ctx": ctx, "ctx64": ctx64, "ids": i, "pred64": pred,
            "ids64": i_fac}


# --------------------------------------------------------------------------
# phases 7-12: the routes, generators and workflow of the second slice
# --------------------------------------------------------------------------

def agree_up_to_ties(d_a, i_a, d_b, i_b) -> bool:
    """Winner ids agree rank for rank, except at ranks whose distance lies
    within the float32 tie window of a neighbour's or of the k-th one."""
    for da, db, ia, ib in zip(d_a, d_b, i_a, i_b):
        taint = np.zeros(len(da), bool)
        for d in (da, db):
            win = TIE_ATOL + TIE_RTOL * np.abs(d)
            tight = np.abs(np.diff(d)) <= win[1:]
            taint[:-1] |= tight
            taint[1:] |= tight
            taint |= np.abs(d - d[-1]) <= win[-1]
        if not ((ia == ib).all(-1) | taint).all():
            return False
    return True


def first_and_warm(fn, n: int = 3):
    """First-call wall time and the median of ``n`` warm ones (each ends
    in a synchronize), plus the first call's result."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    return out, first, median_wall(fn, n)


def dataset_contexts(dataset, w: int, n: int, seed: int) -> np.ndarray:
    """``n`` windows of width ``w`` cut from the dataset, ``(n, 1, w)``."""
    rng = np.random.default_rng(seed)
    Rn, _, Tn = dataset.shape
    rows, starts = rng.integers(0, Rn, n), rng.integers(0, Tn - w - H, n)
    return np.stack([dataset[r, :, s : s + w] for r, s in zip(rows, starts)])


class Launches:
    """K1/K2 launch counts of one driven path: zeroed on entry, read on
    exit, summed over every path into ``totals``."""

    totals = {"K1": 0, "K2": 0}

    def __enter__(self):
        from shadowing_tpu_torch.ops.factored import FACTORED
        from shadowing_tpu_torch.ops.search import TOEPLITZ

        self.kernels = {"K1": TOEPLITZ, "K2": FACTORED}
        for k in self.kernels.values():
            k.launches = 0
        return self

    def __exit__(self, *exc):
        self.counts = {n: k.launches for n, k in self.kernels.items()}
        for n, c in self.counts.items():
            Launches.totals[n] += c
        return False

    def require(self, name: str, what: str) -> None:
        if self.counts[name] == 0:
            raise AssertionError(f"{what} never launched {name}")


def fused_route(dataset, device) -> None:
    """Phase 7: the fused route at full width — cosine (no kernel score
    form) and a Foveal filter wider than ``MAX_WIDTH`` — against the
    on-card direct oracle; its chunks select through the tournament."""
    import torch

    from shadowing_tpu_torch import (
        CosineDistance,
        Foveal,
        Identity,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        SPDaily,
    )

    snp = SPDaily().dlnx[0, 0].astype(np.float32)
    for label, emb, dist, w in (
            ("cosine Identity(20)", Identity(W), CosineDistance(), W),
            (f"RelativeMSE Foveal(1.15, 0.9, {W_WIDE})",
             Foveal(1.15, 0.9, W_WIDE), RelativeMSE(), W_WIDE)):
        eng = PathShadowing(emb, dist, dataset, PredictionContext(H),
                            device=device)
        ctx64 = np.concatenate([dataset_contexts(dataset, w, 63, seed=1),
                                snp[None, None, -w:]])
        for B in (1, 64):
            with Launches() as ran:
                (d, _, i), first, warm = first_and_warm(
                    lambda: eng.shadow(ctx64[-B:], k=K))
            if eng.last_metrics["method"] != "fused" or any(ran.counts.values()):
                raise AssertionError(f"{label} B={B}: {eng.last_metrics}, "
                                     f"launches {ran.counts}")
            log(f"phase 7 fused {label} (d={emb.dim}) B={B}, k={K}: first "
                f"call {first:.3f} s, warm {warm:.4f} s (median of 3), "
                f"n_splits {eng.last_metrics['n_splits']}, contexts redone "
                f"{eng.last_metrics['redo_contexts']}")
        d_o, _, i_o = eng.shadow(ctx64[-2:], k=K, method="direct")
        if not agree_up_to_ties(d[-2:], i[-2:], d_o, i_o):
            raise AssertionError(f"{label}: fused ids differ from the direct "
                                 "oracle's outside the f32 tie window")
        same = int((i[-2:] == i_o).all(-1).sum())
        log(f"  checks: routing_log {[s for s in eng.routing_log if 'declined' in s]}; "
            f"2x{K} ids equal the direct oracle's ({same} rank for rank, the "
            f"rest inside the f32 tie window)")
        del eng
        torch.cuda.empty_cache()



def selection(device) -> None:
    """Phase 7, selection: the certified tournament against the stable sort
    on the card, at the fused route's shapes and at pass 2's own (the final
    selection of k among ``(k + 384) * 128`` candidates with ``cap = k +
    128``). Each shape is checked on rows of every adversarial style
    (normal, quantized, ties, a fifth ``+inf``, fewer than k finite) and
    timed on uniform rows."""
    import torch

    from shadowing_tpu_torch.ops.topk import topk_min_batched, topk_min_sort

    gen = torch.Generator(device=device).manual_seed(0)

    def adversarial(B, n, k):
        s = torch.randn((B, n), generator=gen, device=device)
        for b in range(B):
            style = b % 5
            if style == 1:                      # quantized: many exact ties
                s[b] = torch.round(s[b] * 3) + 0.0
            elif style == 2:                    # two values only
                s[b] = torch.where(s[b] < -1.0, -1.0, 0.0)
            elif style == 3:                    # a fifth of the row +inf
                s[b, torch.rand(n, generator=gen, device=device) < 0.2] = \
                    float("inf")
            elif style == 4:                    # fewer than k finite scores
                s[b, k // 2:] = float("inf")
        return s

    shapes = [(B, SEL_N, k, None, "fused") for B in (1, 64) for k in SEL_KS]
    shapes += [(64, (k + 384) * 128, k, k + 128, "pass 2")
               for k in (K, K_BIG)]
    for B, n, k, cap, where in shapes:
        s = adversarial(B, n, k)
        v, i, ok = topk_min_batched(s, k, cap=cap)
        v_s, i_s, _ = topk_min_sort(s, k)
        if not (torch.equal(v[ok], v_s[ok]) and torch.equal(i[ok], i_s[ok])
                and bool((v[:, 1:] >= v[:, :-1]).all())):
            raise AssertionError(f"selection B={B}, k={k} of {n}: the "
                                 "tournament differs from the stable sort "
                                 "on a certified row")
        # a row short of k finite scores cannot certify (inf < inf is false)
        short = torch.arange(B, device=device) % 5 == 4
        bad = 1.0 - float(ok.float().mean())
        del s, v, i, v_s, i_s
        s = torch.rand((B, n), generator=gen, device=device)
        ok_u = topk_min_batched(s, k, cap=cap).ok
        ms = median_ms(lambda: topk_min_batched(s, k, cap=cap))
        ms_sort = median_ms(lambda: topk_min_sort(s, k))
        ms_topk = median_ms(lambda: torch.topk(s, k, largest=False))
        log(f"  selection ({where}) B={B}, k={k} of {n}, cap {cap}: "
            f"tournament {ms:.3f} ms, stable sort {ms_sort:.3f} ms, "
            f"torch.topk {ms_topk:.3f} ms; uniform rows not certified "
            f"{1.0 - float(ok_u.float().mean()):.4f}; adversarial rows equal "
            f"the stable sort wherever certified, not certified {bad:.4f} "
            f"({int(short.sum())} of {B} rows short of k finite scores, "
            f"{int(ok[short].sum())} of them certified)")
        del s
        torch.cuda.empty_cache()


def float64_route(dataset, device) -> None:
    """Phase 8: the float64 host rescore of the K1 route's winners."""
    from shadowing_tpu_torch import (
        Identity,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        SPDaily,
    )

    ctx = SPDaily().dlnx[0, 0, -W:].astype(np.float32)
    eng = PathShadowing(Identity(W), RelativeMSE(), dataset,
                        PredictionContext(H), device=device)
    eng.shadow(ctx, k=K)
    with Launches() as ran:
        d, p, i = eng.shadow(ctx, k=K, exact_dtype="float64")
    ran.require("K1", "the float64 route")
    t32 = median_wall(lambda: eng.shadow(ctx, k=K), 3)
    t64 = median_wall(lambda: eng.shadow(ctx, k=K, exact_dtype="float64"), 3)
    d32, _, i32 = eng.shadow(ctx, k=K)
    x = ctx.astype(np.float64)
    e = p[..., :W].astype(np.float64)[:, :, 0]
    d_ref = np.linalg.norm(e - x, axis=-1) / np.linalg.norm(x)
    rel = float(np.abs(d - d_ref).max() / np.abs(d_ref).max())
    if d.dtype != np.float64 or rel > 1e-12 or not (np.diff(d) >= 0).all():
        raise AssertionError(f"float64 distances: rel err {rel}")
    if set(map(tuple, i[0])) != set(map(tuple, i32[0])) or not \
            agree_up_to_ties(d, i, d32, i32):
        raise AssertionError("float64 ids differ from the float32 route's "
                             "beyond reordering among f32 ties")
    log(f"phase 8 float64 (B=1, k={K}): shadow warm {t32:.4f} s float32, "
        f"{t64:.4f} s float64 (median of 3); K1 launches {ran.counts['K1']}; "
        f"max rel err vs numpy float64 {rel:.2e}; ids = the float32 route's "
        f"({int((i == i32).all(-1).sum())}/{K} rank for rank)")


def sharded_rows(dataset, device) -> None:
    """Phase 9: two engines on the row halves searched as one dataset."""
    import torch

    from shadowing_tpu_torch import (
        Identity,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        shadow_sharded_rows,
    )

    ctx64 = dataset_contexts(dataset, W, 64, seed=3)
    mk = lambda a: PathShadowing(Identity(W), RelativeMSE(), a,
                                 PredictionContext(H), device=device)
    half = dataset.shape[0] // 2
    with Launches() as ran:
        engines = [mk(dataset[:half]), mk(dataset[half:])]
        d, p, i = shadow_sharded_rows(engines, ctx64, k=K)
    ran.require("K2", "shadow_sharded_rows at B=64")
    del engines
    torch.cuda.empty_cache()
    with Launches():
        d1, p1, i1 = mk(dataset).shadow(ctx64, k=K)
    if not (np.array_equal(i, i1) and np.array_equal(d, d1)
            and np.array_equal(p, p1)):
        raise AssertionError("shadow_sharded_rows differs from one engine")
    log(f"phase 9 shadow_sharded_rows (2 engines of {half} rows, B=64, "
        f"k={K}): ids, distances and paths equal one engine's; launches "
        f"{ran.counts}, trajectory ids span {int(i[..., 0].min())}.."
        f"{int(i[..., 0].max())}")
    torch.cuda.empty_cache()


def mrw_dataset(device):
    """Phase 10: an MRW dataset generated on the card; returns its
    log-returns ``(R, 1, T)``."""
    import torch

    from shadowing_tpu_torch import MRWGenerator

    gen = MRWGenerator(T=T + 1, H=0.5, lam=0.2, seed=0, device=device)
    t0 = time.perf_counter()
    lnx = gen.generate(R)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    t_warm = median_wall(lambda: gen.generate(R), 1)
    returns = torch.diff(lnx, dim=-1)
    std = float(returns.std())
    if (lnx.shape != (R, 1, T + 1) or lnx.device.type != gen.device.type
            or not (lnx[:, :, 0] == 0).all() or abs(std / gen.sigma - 1) >= 0.1
            or not torch.isfinite(returns).all()):
        raise AssertionError(f"MRW: shape {tuple(lnx.shape)}, increment std "
                             f"{std} vs sigma {gen.sigma}")
    log(f"phase 10 MRW generate(R={R}, T={T + 1}) on the card: first {dt:.3f} s "
        f"({R / dt:.0f} paths/s), warm {t_warm:.3f} s ({R / t_warm:.0f} "
        f"paths/s); increment std {std:.5f} = {std / gen.sigma:.4f} sigma")
    return returns


def device_busy(trace: Path) -> tuple:
    """Device busy seconds (the union of the kernels' intervals) of a
    Chrome trace, and the top kernels by summed time."""
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "kernel"]
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in sorted(events, key=lambda e: e["ts"]):
        stop = e["ts"] + e["dur"]
        if stop > end:
            busy += stop - max(e["ts"], end)
            end = stop
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return busy / 1e6, len(events), [(n, round(t / 1e3, 3)) for n, t in top]


def backtest(returns, device) -> None:
    """Phase 11: the rolling backtest over the MRW dataset, against the
    AR-linear benchmark, at k = 1,024 and 16,384."""
    import torch

    from shadowing_tpu_torch import (
        Identity,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        SPDaily,
        realized_variance,
        rolling_backtest,
        windows,
    )
    from shadowing_tpu_torch.ops import factored, search
    from shadowing_tpu_torch.shadow.engine import _prep_context
    from shadowing_tpu_torch.utils.profiling import device_trace

    eng = PathShadowing(Identity(W), RelativeMSE(), returns,
                        PredictionContext(H), device=device)
    snp = SPDaily().dlnx[0, 0]
    for k, n_dates in ((K, N_DATES), (K_BIG, N_DATES_BIG)):
        series = snp[-(n_dates + W + H - 1):]
        run = lambda: rolling_backtest(eng, series, w=W, Ts=TS, k=k,
                                       n_context_splits=n_dates // 64,
                                       benchmark="ar-linear")
        torch.cuda.reset_peak_memory_stats()
        with Launches() as ran:
            res, first, warm = first_and_warm(run)
        ran.require("K2", f"the backtest at k={k}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not (res.predicted.shape == (n_dates, len(TS))
                and np.isfinite(res.predicted).all()
                and np.isfinite(res.benchmark_predicted).all()):
            raise AssertionError(f"backtest k={k}: non-finite predictions")
        ctx = windows(series, w=W + max(TS), s=1)[:, :W]
        pick = [0, n_dates - 1]
        to_predict = lambda x: realized_variance(x[:, :, 0, :], Ts=TS)
        want, _ = eng.predict(ctx[pick], k=k, to_predict=to_predict, eta=0.1,
                              method="direct")
        rel = float(np.abs(res.predicted[pick] / want - 1).max())
        if rel > 1e-6:
            raise AssertionError(f"backtest k={k}: dates {pick} differ from "
                                 f"the direct oracle by {rel:.2e}")
        log(f"phase 11 rolling_backtest ({n_dates} dates, k={k}, 64-date "
            f"chunks, ar-linear): first call {first:.3f} s "
            f"({n_dates / first:.0f} dates/s), warm {warm:.4f} s "
            f"({n_dates / warm:.0f} dates/s, median of 3); launches "
            f"{ran.counts}; contexts redone "
            f"{eng.last_metrics['redo_contexts']}; peak allocated {peak:.2f} "
            f"GiB; dates {pick} = direct oracle to {rel:.1e}")
        log("  " + res.summary().replace("\n", "\n  "))
        # one 64-date chunk by part: K2, pass 2 (both selections inside it),
        # and the whole chunk through predict
        x = torch.as_tensor(ctx[:64], dtype=torch.float32,
                            device=device)[:, None, :]
        bank = torch.eye(W, device=device)[:, None, :]
        x_emb, _, g = _prep_context(x, bank, bank)
        E, norms = eng.factored_responses(), eng.window_norms()
        bmin = factored.score_blockmin_factored(E, norms, x_emb)
        t_p1 = median_ms(lambda: factored.score_blockmin_factored(E, norms,
                                                                  x_emb))
        t_p2 = median_ms(lambda: search.pass2_from_bmin(bmin, eng.y, norms, g,
                                                        k))
        t_chunk = 1e3 * median_wall(lambda: eng.predict(
            ctx[:64], k=k, to_predict=to_predict, eta=0.1), 3)
        log(f"  one 64-date chunk at k={k}: predict {t_chunk:.2f} ms wall "
            f"(median of 3); K2 pass 1 {t_p1:.3f} ms, pass 2 {t_p2:.3f} ms = "
            f"{100 * t_p2 / t_chunk:.1f} % of the chunk (device, medians of "
            f"5)")
        del bmin, x_emb, g
        if k == K:
            # the profiler's own host overhead inflates the traced wall:
            # the busy share is taken of the unprofiled warm wall
            trace_dir = Path(__file__).resolve().parent / "build" / "traces"
            with device_trace(str(trace_dir)):
                run()
                torch.cuda.synchronize()
            busy, n_kernels, top = device_busy(trace_dir / "trace.json")
            log(f"  profiled warm run (torch.profiler): device busy "
                f"{busy:.3f} s = {100 * busy / warm:.1f} % of the unprofiled "
                f"warm wall, {n_kernels} kernels; top by device ms: {top}")

    redone = [s for s in eng.routing_log if s.startswith("redo")]
    if redone:
        raise AssertionError(f"the backtest redid a certification: {redone}")
    log("  checks: no context redone in any chunk (routing_log)")
    # a 65-context chunk (the default n_dates // 64 splits of 130 dates)
    x = torch.randn((65, W), generator=torch.Generator(device=device)
                    .manual_seed(0), device=device) * 0.011
    t64 = median_ms(lambda: factored.score_blockmin_factored(E, norms, x[:64]))
    t65 = median_ms(lambda: factored.score_blockmin_factored(E, norms, x))
    log(f"  K2 pass 1 at B=64 {t64:.3f} ms vs B=65 {t65:.3f} ms")


def pdv_paths(device) -> None:
    """Phase 12: 4,096 PDV paths of 4,096 daily steps on the card."""
    import torch

    from shadowing_tpu_torch import PDVModelDiscrete
    from shadowing_tpu_torch.models.pdv import SIGMA_CLIP

    m = PDVModelDiscrete(**PDV_PARAMS, device=device)
    kw = dict(T=PDV_STEPS / 252, dt=1 / 252, S0=100.0, S=PDV_S,
              R10=np.zeros(2), R20=np.full(2, 0.04))
    (sigma, S), first, warm = first_and_warm(lambda: m.gen(**kw), n=1)
    if not (S.shape == sigma.shape == (PDV_S, PDV_STEPS)
            and (S[:, 0] == 100.0).all() and (S > 0).all()
            and (sigma >= SIGMA_CLIP[0]).all() and (sigma <= SIGMA_CLIP[1]).all()):
        raise AssertionError(f"PDV: shape {S.shape}, min price {S.min()}")
    calm1 = torch.zeros((1, 2), device=device)
    calm2 = torch.full((1, 2), 0.02, device=device)
    lam1 = torch.tensor(m.lams1, dtype=torch.float32, device=device)
    lam2 = torch.tensor(m.lams2, dtype=torch.float32, device=device)
    crash1 = torch.exp(-lam1 / 252) * calm1 + lam1 * -0.10
    crash2 = torch.exp(-lam2 / 252) * calm2 + lam2 * 0.01
    s_calm, s_crash = float(m.sigma_of(calm1, calm2)), float(m.sigma_of(crash1, crash2))
    if not s_crash > 1.5 * s_calm:
        raise AssertionError(f"leverage: sigma {s_calm} -> {s_crash}")
    log(f"phase 12 PDVModelDiscrete.gen(S={PDV_S}, {PDV_STEPS} steps) on the "
        f"card: first call {first:.3f} s, warm {warm:.3f} s; prices in "
        f"[{S.min():.2f}, {S.max():.2f}], sigma in [{sigma.min():.4f}, "
        f"{sigma.max():.4f}]; leverage: a -10% day moves sigma "
        f"{s_calm:.4f} -> {s_crash:.4f}")


# --------------------------------------------------------------------------
# phases 13-14: scattering-spectra generation and its CLI (third slice)
# --------------------------------------------------------------------------

def scattering_generation(device):
    """Phase 13, generation: returns the generated ``(R_SCAT, 1, T)``
    log-returns on the card and the calibration series."""
    import torch

    from shadowing_tpu_torch import SPDaily, analyze, generate
    from shadowing_tpu_torch.array_types import fp32_exact
    from shadowing_tpu_torch.models.scattering import build_filter_bank
    from shadowing_tpu_torch.models.scattering import synthesis as syn
    from shadowing_tpu_torch.models.scattering.generate import (
        _shard_seed,
        target_stats,
    )
    from shadowing_tpu_torch.models.scattering.moments import (
        _scattering_stats_flat,
    )
    from shadowing_tpu_torch.utils.profiling import device_trace

    snp = SPDaily(start=SCAT_START, end=SCAT_END)
    dlnx = snp.dlnx[0, 0]
    t0 = time.perf_counter()
    target = target_stats(dlnx, SCAT_J)
    t_target = time.perf_counter() - t0
    bank = build_filter_bank(SCAT_T, SCAT_J)

    def shard():
        """Generate's first shard: ``(z, rms, work_log, wall)``."""
        wl = {}
        gen = torch.Generator(device=device).manual_seed(_shard_seed(0, 0))
        t0 = time.perf_counter()
        z, rms = syn.synthesize_batch(gen, target, bank, batch=SCAT_BATCH,
                                      max_iterations=SCAT_ITERS, tol=SCAT_TOL,
                                      work_log=wl)
        torch.cuda.synchronize()
        return z, rms, wl, time.perf_counter() - t0

    # one shard twice from one seed: bit for bit (the first pays cuFFT
    # plans), then once under the profiler (kernels only: a shard launches
    # ~10^5-10^6 of them)
    (z0, rms0, wl0, w0), (z1, rms1, wl1, w1) = shard(), shard()
    trace = Path(__file__).resolve().parent / "build" / "traces" / "shard.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        z2 = shard()[0]
    prof.export_chrome_trace(str(trace))
    busy, n_kernels, top = device_busy(trace)
    trace.unlink()
    if not (torch.equal(z0, z1) and torch.equal(z0, z2)
            and np.array_equal(rms0, rms1)
            and wl0["seed_steps"] == wl1["seed_steps"]):
        raise AssertionError("syntheses of one shard from one seed differ")
    log(f"phase 13 synthesize_batch ({SCAT_BATCH} seeds, J={SCAT_J}, "
        f"T={SCAT_T}, tol {SCAT_TOL}, <= {SCAT_ITERS} steps) twice from one "
        f"seed: equal bit for bit; wall {w0:.3f} s (first) and {w1:.3f} s; "
        f"{wl1['seed_steps']} seed-steps over {wl1['steps']} steps "
        f"({1e6 * wl1['t_loop_s'] / wl1['seed_steps']:.2f} us/seed-step); "
        f"converged {(rms1 < SCAT_TOL).mean():.4f}, rms median "
        f"{np.median(rms1):.5f} max {rms1.max():.5f}; target on the CPU "
        f"{t_target:.3f} s ({len(dlnx)} days)")
    log(f"  profiled third run (equal too): device busy {busy:.3f} s = "
        f"{100 * busy / w1:.1f} % of the unprofiled wall, {n_kernels} kernels "
        f"= {n_kernels / wl1['steps']:.0f} per step; top by device ms: {top}")

    # the full generation
    torch.cuda.reset_peak_memory_stats()
    logs = []
    t0 = time.perf_counter()
    out = generate(snp, R=R_SCAT, J=SCAT_J, T=SCAT_T, tol_optim=SCAT_TOL,
                   max_iterations=SCAT_ITERS, seed=0, batch=SCAT_BATCH,
                   shard_logs=logs, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    rms = np.concatenate([lg["rms"] for lg in logs])
    seed_steps = sum(lg["seed_steps"] for lg in logs)
    loop_s = sum(lg["t_loop_s"] for lg in logs)
    conv = float((rms < SCAT_TOL).mean())
    std_ratio = float(out.std()) / dlnx.std()
    f_obs = analyze(dlnx, J=SCAT_J).flatness()
    f_gen = analyze(out[:SCAT_BATCH].cpu().numpy().ravel(), J=SCAT_J).flatness()
    f_err = float(np.abs(f_gen / f_obs - 1).max())
    x = out.double()
    exkurt = float(((x - x.mean()) ** 4).mean() / x.var(correction=0) ** 2 - 3)
    same0 = torch.equal(out[:SCAT_BATCH, 0],
                        z0 * float(dlnx.std()) + float(dlnx.mean()))
    del x
    log(f"phase 13 generate(R={R_SCAT}, batch={SCAT_BATCH}) on the card: "
        f"{wall:.3f} s = {R_SCAT / wall:.1f} paths/s; {seed_steps} "
        f"seed-steps, {1e6 * loop_s / seed_steps:.2f} us/seed-step; "
        f"converged {conv:.4f}, rms median {np.median(rms):.5f} max "
        f"{rms.max():.5f}; shard walls {min(lg['wall_s'] for lg in logs):.3f}"
        f"-{max(lg['wall_s'] for lg in logs):.3f} s, steps "
        f"{min(lg['steps'] for lg in logs)}-{max(lg['steps'] for lg in logs)}"
        f"; peak allocated {peak:.2f} GiB")
    log(f"  checks: shape {tuple(out.shape)}, finite; std {std_ratio:.4f} of "
        f"the observed; flatness of the first {SCAT_BATCH} paths "
        f"{np.round(f_gen, 3).tolist()} vs target {np.round(f_obs, 3).tolist()}"
        f" (max rel err {f_err:.3f}); excess kurtosis {exkurt:.3f}; shard 0 = "
        f"the determinism run rescaled: {same0}")
    if not (out.shape == (R_SCAT, 1, SCAT_T) and out.device.type == device.type
            and bool(torch.isfinite(out).all()) and conv >= 0.95
            and abs(std_ratio - 1) <= 0.1 and f_err <= 0.35 and exkurt > 1
            and same0):
        raise AssertionError("phase 13: the generated dataset fails its checks")

    # one Adam step by part, at the full batch and at a straggler tail
    psi = torch.as_tensor(bank.psi_hat, device=device)
    tgt = target.to(device)
    lr = syn.default_lr_schedule(SCAT_ITERS)
    kw = dict(target=tgt, psi_hat=psi, J=SCAT_J, lr=lr, bands=bank.band_hi,
              standardize=True)
    trace_dir = Path(__file__).resolve().parent / "build" / "traces"
    for rows in (SCAT_BATCH, 16):
        z = syn._standardize(out[:rows, 0].clone())
        m, v = torch.zeros_like(z), torch.zeros_like(z)
        with fp32_exact():
            def fwd():
                with torch.no_grad():
                    _scattering_stats_flat(syn._standardize(z), psi, SCAT_J,
                                           bank.band_hi)
            g = syn._loss_grad(z, tgt, psi, SCAT_J, bank.band_hi, True)
            t_fwd = median_ms(fwd)
            t_fb = median_ms(lambda: syn._loss_grad(z, tgt, psi, SCAT_J,
                                                    bank.band_hi, True))
            t_adam = median_ms(lambda: syn._adam_step(z, m, v, 200, g, lr))
        seg = lambda n: syn._optimize_segment(z, m, v, 200, n_steps=n, **kw)
        seg(10)
        t_seg = median_wall(lambda: seg(10), 3)
        counts = {}
        for n in (10, 0):
            with device_trace(str(trace_dir)):
                seg(n)
                torch.cuda.synchronize()
            counts[n] = device_busy(trace_dir / "trace.json")
        busy, n_k, top = counts[10]
        log(f"  Adam step at {rows} rows (CUDA events, median of 5): "
            f"forward statistics {t_fwd:.3f} ms, forward + backward "
            f"{t_fb:.3f} ms (backward {t_fb - t_fwd:.3f}), Adam update "
            f"{t_adam:.3f} ms; a 10-step segment {t_seg * 1e3:.2f} ms wall "
            f"({t_seg * 1e2:.3f} ms/step); profiled: device busy "
            f"{busy * 1e3:.2f} ms = {100 * busy / t_seg:.1f} % of the "
            f"unprofiled wall, {(n_k - counts[0][1]) / 10:.0f} kernels per "
            f"step (+{counts[0][1]} for the closing loss); top by device ms: "
            f"{top}")
    return out, dlnx


def scattering_search(data, device) -> None:
    """Phase 13, search: the generated dataset through K1 and K2."""
    import torch

    from shadowing_tpu_torch import (
        Identity,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        realized_variance,
    )

    out, dlnx = data
    ctx = dlnx[-W:].astype(np.float32)
    eng = PathShadowing(Identity(W), RelativeMSE(), out, PredictionContext(H),
                        device=device)
    to_predict = lambda x: realized_variance(x[:, :, 0, :], Ts=TS, vol=False)
    with Launches() as ran:
        (vars_, _, smiles), first, warm = first_and_warm(
            lambda: eng.predict_and_smile(ctx, k=K, to_predict=to_predict,
                                          Ts=TS, Ms=MS, eta=0.1,
                                          eta_smile=0.075))
    ran.require("K1", "predict_and_smile on the generated dataset")
    _, _, i = eng.shadow(ctx, k=K)
    _, _, i_dir = eng.shadow(ctx, k=K, method="direct")
    d0, _, i0 = eng.shadow(out[0, 0, :W].cpu().numpy(), k=4)
    if not (np.array_equal(i, i_dir) and d0[0, 0] == 0.0
            and tuple(i0[0, 0]) == (0, 0) and np.isfinite(vars_).all()):
        raise AssertionError("phase 13: K1 winners differ from the direct "
                             f"oracle, or self-match {d0[0, 0]} at {i0[0, 0]}")
    log(f"phase 13 predict_and_smile on the generated dataset (B=1, k={K}): "
        f"first {first:.3f} s, warm {warm:.4f} s (median of 3); launches "
        f"{ran.counts}; ids = the direct oracle's, self-match 0.0 at (0, 0); "
        f"ATM vols {np.round(smiles[0].vols[:, 4], 4).tolist()}")

    rng = np.random.default_rng(4)
    rows = rng.integers(0, out.shape[0], 64)
    starts = rng.integers(0, out.shape[-1] - W - H, 64)
    ctx64 = torch.stack([out[r, :, s : s + W] for r, s in zip(rows, starts)]
                        ).cpu().numpy()
    with Launches() as ran:
        (pred, _), first, warm = first_and_warm(
            lambda: eng.predict(ctx64, k=K, to_predict=to_predict, eta=0.1))
    ran.require("K2", "the 64-context predict on the generated dataset")
    _, _, i64 = eng.shadow(ctx64, k=K)
    _, _, i_dir = eng.shadow(ctx64[:2], k=K, method="direct")
    if not (np.array_equal(i64[:2], i_dir) and pred.shape == (64, len(TS))
            and np.isfinite(pred).all()):
        raise AssertionError("phase 13: K2 winners differ from the direct "
                             "oracle, or non-finite predictions")
    log(f"phase 13 predict on the generated dataset (B=64, k={K}): first "
        f"{first:.3f} s, warm {warm:.4f} s (median of 3); launches "
        f"{ran.counts}; 2x{K} ids = the direct oracle's")
    del eng
    torch.cuda.empty_cache()


def generation_cli(device) -> None:
    """Phase 14: the generation CLI, two job-array tasks as subprocesses
    (the flags after ``-q`` restate the defaults, with phase 13's sizes)."""
    import shutil

    from shadowing_tpu_torch import TimeSeriesDataset

    root = Path(__file__).resolve().parent
    cache, batched = root / "build" / "scat_cli", root / "build" / "scat_cli_b"
    for d in (cache, batched):
        shutil.rmtree(d, ignore_errors=True)
    gen_cmd = [sys.executable, "-m", "shadowing_tpu_torch.cli.snp_generation",
               "-ntot", "2", "-R", str(CLI_R), "--cache", str(cache), "-q",
               "-J", str(SCAT_J), "-T", str(SCAT_T), "--max-iterations",
               str(SCAT_ITERS), "--batch", str(CLI_BATCH), "--device",
               device.type]

    def run_all(cmds, timeout=600):
        procs = [subprocess.Popen(c, cwd=root, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for c, p, o in zip(cmds, procs, outs):
            if p.returncode != 0 or not o.rstrip().endswith("FINISHED"):
                raise AssertionError(f"{' '.join(c[2:])} -> rc "
                                     f"{p.returncode}:\n{o[-3000:]}")
        return outs

    t0 = time.perf_counter()
    run_all([gen_cmd + ["-tid", str(tid)] for tid in (0, 1)])
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    (again,) = run_all([gen_cmd + ["-tid", "0"]])
    t_skip = time.perf_counter() - t0
    if "already exists — skipping" not in again:
        raise AssertionError(f"re-run of task 0 did not skip:\n{again}")
    run_all([[sys.executable, "-m", "shadowing_tpu_torch.cli.batch_generations",
              "--input", str(cache), "--output", str(batched)]])
    data = TimeSeriesDataset(batched).load()
    half = CLI_R // 2
    if not (data.shape == (CLI_R, 1, SCAT_T) and np.isfinite(data).all()
            and not np.array_equal(data[:half], data[half:])):
        raise AssertionError(f"phase 14: loaded {data.shape}")
    log(f"phase 14 CLI: snp_generation -ntot 2 -tid 0|1 -R {CLI_R} (two "
        f"concurrent processes on the card) {t_gen:.1f} s; re-run of task 0 "
        f"skipped in {t_skip:.1f} s; batch_generations + TimeSeriesDataset "
        f"-> {data.shape} finite, the two tasks' rows differ; std "
        f"{data.std():.5f}")


# --------------------------------------------------------------------------
# phase 15: the mesh on torch.distributed (fifth slice)
# --------------------------------------------------------------------------

def mesh_references(path: dict, device) -> dict:
    """Phase 15, before the launch: the ranks' inputs on disk, and the
    single-process synthesis the ranks are held to."""
    import torch

    from shadowing_tpu_torch import SPDaily
    from shadowing_tpu_torch.models.scattering import build_filter_bank
    from shadowing_tpu_torch.models.scattering.generate import target_stats
    from shadowing_tpu_torch.models.scattering.synthesis import synthesize_batch
    from shadowing_tpu_torch.parallel import sharding as psh

    target = target_stats(SPDaily(start=SCAT_START, end=SCAT_END).dlnx[0, 0],
                          SCAT_J)
    rng = np.random.default_rng(6)
    shape = (MESH_SEEDS, SCAT_T)
    z, m, v = (rng.standard_normal(shape).astype(np.float32),
               (rng.standard_normal(shape) * 1e-3).astype(np.float32),
               (np.abs(rng.standard_normal(shape)) * 1e-6).astype(np.float32))
    np.savez(MESH_DIR / "inputs.npz", ctx=path["ctx"], ctx64=path["ctx64"],
             target=target.numpy(), z=z, m=m, v=v)
    bank = build_filter_bank(SCAT_T, SCAT_J)
    gen = lambda: torch.Generator(device=device).manual_seed(MESH_SEED)
    kw = dict(target=target, bank=bank, batch=MESH_SEEDS, tol=SCAT_TOL)
    wl = {}
    ref = {"syn_init": synthesize_batch(gen(), max_iterations=0, **kw)[0],
           "syn": synthesize_batch(gen(), max_iterations=MESH_ITERS,
                                   work_log=wl, **kw)}
    ref["syn_steps"] = (wl["seed_steps"], wl["steps"])
    zs, ms, vs = (torch.from_numpy(a).to(device) for a in (z, m, v))
    psi = torch.as_tensor(bank.psi_hat, device=device)
    losses = []
    for i in range(MESH_STEPS):
        zs, ms, vs, loss = psh.sharded_synthesis_step(
            zs, ms, vs, i, target.to(device), psi, SCAT_J,
            psh.local_mesh(device))
        losses.append(float(loss))
    ref["step"] = (zs.cpu().numpy(), np.array(losses))
    return ref


def mesh_worker(out: Path, device: str) -> None:
    """Phase 15, one rank (``torchrun`` runs this script with
    ``--mesh-worker``): its own rows of the phase-4 dataset, read from disk,
    the main path on the mesh, the synthesis on its seeds; its results and
    counts go to ``out``."""
    import torch

    from shadowing_tpu_torch import (
        Identity,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        realized_variance,
    )
    from shadowing_tpu_torch.models.scattering import build_filter_bank
    from shadowing_tpu_torch.models.scattering.synthesis import synthesize_batch
    from shadowing_tpu_torch.ops.factored import FACTORED
    from shadowing_tpu_torch.ops.search import TOEPLITZ
    from shadowing_tpu_torch.parallel import (
        LAST_MERGE_PAYLOAD,
        data_mesh,
        host_row_range,
        shard_dataset_from_local,
        sharded_synthesis_step,
        task_split,
    )

    mesh = data_mesh(device=device)
    dev, rank = mesh.device, mesh.data_pos
    inp = np.load(out / "inputs.npz")
    data = np.load(out / "dataset.npy", mmap_mode="r")
    Rn = data.shape[0]
    start, stop = host_row_range(Rn, mesh)
    t0 = time.perf_counter()
    y = shard_dataset_from_local(data[start : min(stop, Rn)], mesh, Rn)
    info = {"rank": rank, "task_split": task_split(), "device": str(dev),
            "backend": torch.distributed.get_backend(), "rows": [start, stop],
            "load_s": time.perf_counter() - t0}
    eng = PathShadowing(Identity(W), RelativeMSE(), y, PredictionContext(H),
                        mesh=mesh, n_trajectories=Rn)
    to_predict = lambda x: realized_variance(x[:, :, 0, :], Ts=TS, vol=False)

    def driven(name, fn):
        """The counts zeroed before one driven path and read after it."""
        TOEPLITZ.launches = FACTORED.launches = 0
        res, first, warm = first_and_warm(fn, 5)
        info[name] = {"first_s": first, "warm_s": warm,
                      "K1": TOEPLITZ.launches, "K2": FACTORED.launches}
        return res

    ctx, ctx64 = inp["ctx"], inp["ctx64"]
    res = {}
    vars_, _, smiles = driven("k1", lambda: eng.predict_and_smile(
        ctx, k=K, to_predict=to_predict, Ts=TS, Ms=MS, eta=0.1,
        eta_smile=0.075))
    res["vars"] = vars_
    res["ids"] = eng.shadow(ctx, k=K)[2]
    res["ids_direct"] = eng.shadow(ctx, k=K, method="direct")[2]
    d0, _, i0 = eng.shadow(np.array(data[0, 0, :W]), k=4)
    res["self"] = np.array([d0[0, 0], *i0[0, 0]])
    res["pred64"], _ = driven("k2", lambda: eng.predict(
        ctx64, k=K, to_predict=to_predict, eta=0.1))
    res["ids64"] = eng.shadow(ctx64, k=K)[2]
    info["factored_grant"] = [s for s in eng.routing_log
                              if s.startswith("factored pass-1 routed")]
    info["redo_before"] = [s for s in eng.routing_log if s.startswith("redo")]
    res["ids_redo"] = eng.shadow_device(ctx, k=K,
                                        tournament_cap=K // 128 // 2)[2].cpu()
    info["redo_contexts"] = eng.last_metrics["redo_contexts"]
    info["mesh"] = eng.last_metrics["mesh"]
    info["payload"] = {str(k): v for k, v in LAST_MERGE_PAYLOAD.items()}
    del eng, y
    torch.cuda.empty_cache()
    # the collectives of one 64-context search, alone (wall ms, median of 5)
    vals, ids = (torch.zeros((64, K), dtype=t, device=dev)
                 for t in (torch.float32, torch.int64))
    paths = torch.zeros((64, K, 1, W + H), device=dev)
    info["collectives_ms"] = {
        "merge": 1e3 * median_wall(lambda: (mesh.all_gather(vals),
                                            mesh.all_gather(ids))),
        "extraction": 1e3 * median_wall(lambda: mesh.all_reduce(paths))}
    del vals, ids, paths

    target = torch.from_numpy(inp["target"])
    bank = build_filter_bank(SCAT_T, SCAT_J)
    gen = lambda: torch.Generator(device=dev).manual_seed(MESH_SEED)
    kw = dict(target=target, bank=bank, batch=MESH_SEEDS, tol=SCAT_TOL,
              mesh=mesh)
    res["syn_init"] = synthesize_batch(gen(), max_iterations=0, **kw)[0]
    wl = {}
    t0 = time.perf_counter()
    res["syn"], res["syn_rms"] = synthesize_batch(
        gen(), max_iterations=MESH_ITERS, work_log=wl, **kw)
    info["syn"] = {"wall_s": time.perf_counter() - t0,
                   "steps": [wl["seed_steps"], wl["steps"]]}
    rows = MESH_SEEDS // mesh.n_data
    zs, ms, vs = (torch.from_numpy(inp[n][rank * rows : (rank + 1) * rows]
                                   ).to(dev) for n in ("z", "m", "v"))
    psi = torch.as_tensor(bank.psi_hat, device=dev)
    losses = []
    for i in range(MESH_STEPS):
        zs, ms, vs, loss = sharded_synthesis_step(
            zs, ms, vs, i, target.to(dev), psi, SCAT_J, mesh)
        losses.append(float(loss))
    res["step"] = mesh.all_gather(zs).reshape(MESH_SEEDS, SCAT_T)
    res["step_loss"] = np.array(losses)
    info["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    np.savez(out / f"rank{rank}.npz",
             **{k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in res.items()})
    (out / f"rank{rank}.json").write_text(json.dumps(info))
    torch.distributed.destroy_process_group()


def mesh_phase(path: dict, device) -> dict:
    """Phase 15: two ranks of ``torchrun`` on the card search their halves
    of the phase-4 dataset as one; returns the launches summed over the
    ranks."""
    import torch

    t0 = time.perf_counter()
    ref = mesh_references(path, device)
    t_ref = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for stale in MESH_DIR.glob("rank*"):
        stale.unlink()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(MESH_RANKS), "--master-addr", "127.0.0.1", "--master-port",
           str(port), str(Path(__file__).resolve()), "--mesh-worker",
           str(MESH_DIR), device.type]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=MESH_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 15: the {MESH_RANKS}-rank launch failed "
                             f"(rc {proc.returncode}):\n{out[-6000:]}")
    ranks = [(json.loads((MESH_DIR / f"rank{r}.json").read_text()),
              dict(np.load(MESH_DIR / f"rank{r}.npz")))
             for r in range(MESH_RANKS)]
    (info0, res0) = ranks[0]
    for r, (info, res) in enumerate(ranks):
        for name in res:
            if not np.array_equal(res[name], res0[name]):
                raise AssertionError(f"phase 15: rank {r} differs from rank "
                                     f"0 in {name}")
        if info["task_split"] != [MESH_RANKS, r]:
            raise AssertionError(f"rank {r}: task_split {info['task_split']}")
        for tag, kernel in (("k1", "K1"), ("k2", "K2")):
            if info[tag][kernel] == 0:
                raise AssertionError(f"rank {r}: the mesh path never "
                                     f"launched {kernel}")
        if not info["factored_grant"] or info["redo_before"] or \
                info["redo_contexts"] < 1:
            raise AssertionError(f"rank {r}: routing {info['factored_grant']}"
                                 f", redo {info['redo_before']}, forced redo "
                                 f"{info['redo_contexts']}")
    pred_rel = float(np.abs(res0["pred64"] / path["pred64"] - 1).max())
    z_init0 = ref["syn_init"].cpu().numpy()
    z_syn0, rms0 = ref["syn"][0].cpu().numpy(), ref["syn"][1]
    syn_err = float(np.abs(res0["syn"] - z_syn0).max())
    step_frac = float((np.abs(res0["step"] - ref["step"][0]) <= 1e-4).mean())
    loss_rel = float(np.abs(res0["step_loss"] / ref["step"][1] - 1).max())
    checks = {
        "K1 ids = phase 4's": np.array_equal(res0["ids"], path["ids"]),
        "= the direct oracle's": np.array_equal(res0["ids_direct"],
                                                path["ids"]),
        "self-match 0.0 at (0, 0)": tuple(res0["self"]) == (0.0, 0.0, 0.0),
        "K2 ids = phase 5's": np.array_equal(res0["ids64"], path["ids64"]),
        f"predictions = phase 5's to {pred_rel:.1e}": pred_rel <= 1e-6,
        "forced redo ids = phase 4's": np.array_equal(res0["ids_redo"],
                                                      path["ids"]),
        "synthesis start = mesh=None's": np.array_equal(res0["syn_init"],
                                                        z_init0),
        f"synthesis rows within {syn_err:.1e}": syn_err <= 1e-3,
        "same schedule": info0["syn"]["steps"] == list(ref["syn_steps"]),
        f"step losses within {loss_rel:.1e}": loss_rel <= 1e-3,
        f"step z within 1e-4 at {100 * step_frac:.3f} %": step_frac >= 0.999,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 15 checks failed: {failed}")
    log(f"phase 15 mesh: {MESH_RANKS} ranks of torchrun on "
        f"{info0['device']} ({info0['backend']}), rows {[i['rows'] for i, _ in ranks]}"
        f" of {R} read from disk; launch {wall:.1f} s (references "
        f"{t_ref:.1f} s before it); launches by rank "
        f"{[{t: i[n][t] for n, t in (('k1', 'K1'), ('k2', 'K2'))} for i, _ in ranks]}")
    for name, label, single in (("k1", f"predict_and_smile B=1, k={K}",
                                 path["e2e_warm_s"]),
                                ("k2", f"predict B=64, k={K}",
                                 path["predict64_warm_s"])):
        log(f"  {label}: first {info0[name]['first_s']:.3f} s, warm "
            f"{[round(i[name]['warm_s'], 4) for i, _ in ranks]} s by rank "
            f"(median of 5) vs one process {single:.4f} s (phases 4-5); two "
            "ranks share the one card and cross through host copies (gloo), "
            "so no speed-up is expected")
    coll = info0["collectives_ms"]
    log(f"  the collectives of one B=64 search alone (rank 0, wall, median "
        f"of 5): merge all_gather of values and ids {coll['merge']:.2f} ms, "
        f"extraction all_reduce of {64 * K * (W + H) * 4 / 1e6:.1f} MB "
        f"{coll['extraction']:.2f} ms")
    log(f"  merge payload per rank (bytes, by gathered shape): "
        f"{info0['payload']}; peak allocated by rank "
        f"{[round(i['peak_gib'], 2) for i, _ in ranks]} GiB; synthesis "
        f"({MESH_SEEDS} seeds, {MESH_ITERS} steps) {info0['syn']['wall_s']:.2f}"
        f" s, {info0['syn']['steps'][0]} seed-steps")
    log(f"  checks: ranks agree; {'; '.join(checks)}; task_split = "
        f"({MESH_RANKS}, rank)")
    return {t: sum(i[n][t] for i, _ in ranks)
            for n, t in (("k1", "K1"), ("k2", "K2"))}


# --------------------------------------------------------------------------
# phases 16-18: the figures, the reference's cell, the shard reader
# --------------------------------------------------------------------------

def figures(device) -> None:
    """Phase 16: ``make_figures`` at its own size: the figures' data are
    computed on the card through K1 and checked; the two PNGs are drawn
    where matplotlib is installed (a machine without it says so)."""
    import importlib.util
    import shutil

    from shadowing_tpu_torch import Softmax
    from shadowing_tpu_torch.cli import make_figures

    t0 = time.perf_counter()
    with Launches() as ran:
        data = make_figures.compute(device.type)
    ran.require("K1", "make_figures")
    t_compute = time.perf_counter() - t0
    d, paths, smile = data["distances"], data["close_paths"], data["smile"]
    proba = Softmax(d, eta=0.09)
    band = np.stack([proba.avg(paths, axis=0)[0].numpy(),
                     proba.std(paths, axis=0)[0].numpy()])
    shape = (make_figures.K, 1, make_figures.W + make_figures.HORIZON)
    if not (paths.shape == shape and d.shape == shape[:1]
            and (np.diff(d) >= 0).all() and np.isfinite(band).all()
            and (band[1] > 0).all() and smile.vols.shape == (3, 9)
            and np.isfinite(smile.vols[:, 4]).all()):
        raise AssertionError(f"phase 16: paths {paths.shape}, distances "
                             f"{d.shape}, ATM vols {smile.vols[:, 4]}")
    log(f"phase 16 make_figures (MRW {make_figures.R} x {make_figures.T}, "
        f"Identity({make_figures.W}), k={make_figures.K}, horizon "
        f"{make_figures.HORIZON}) computed on the card in {t_compute:.2f} s; "
        f"launches {ran.counts}; distances {d[0]:.4f}..{d[-1]:.4f} ascend, "
        f"shadow band finite (mean std {band[1].mean():.5f}), ATM vols "
        f"{np.round(smile.vols[:, 4].astype(float), 4).tolist()}")
    if importlib.util.find_spec("matplotlib") is None:
        log("  matplotlib is not installed on this machine: shadow.png and "
            "smile.png are not drawn here (tests/test_torch_viz.py draws "
            "them on the CPU)")
        return
    outdir = Path(__file__).resolve().parent / "build" / "figures_smoke"
    shutil.rmtree(outdir, ignore_errors=True)
    pngs = make_figures.draw(data, outdir)
    sizes = [p.stat().st_size for p in pngs]
    if [p.name for p in pngs] != ["shadow.png", "smile.png"] or min(sizes) < 1000:
        raise AssertionError(f"phase 16: {pngs} of {sizes} bytes")
    log(f"  drawn: shadow.png {sizes[0]} bytes, smile.png {sizes[1]} bytes")


def reference_cell(device, card: str) -> None:
    """Phase 17: the reference's performance cell on the card."""
    import torch

    from shadowing_tpu_torch import (
        Foveal,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        realized_variance,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    data = torch.randn((R_REF, 1, T), generator=gen, device=device)
    ctx = torch.randn((1, 1, W_REF), generator=gen, device=device)
    eng = PathShadowing(Foveal(1.15, 0.9, W_REF), RelativeMSE(), data,
                        PredictionContext(horizon=H_REF), device=device)
    eng.window_norms()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    to_predict = lambda x: realized_variance(x, Ts=TS_REF, vol=False)
    torch.cuda.reset_peak_memory_stats()
    with Launches() as ran:
        (pred, std), first, warm = first_and_warm(
            lambda: eng.predict(ctx, k=K_REF, to_predict=to_predict, eta=0.1))
    ran.require("K1", "the reference's predict")
    metrics = dict(eng.last_metrics)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if (metrics["method"] != "kernel" or ran.counts["K2"]
            or pred.shape != (1, 1, len(TS_REF)) or not np.isfinite(pred).all()
            or not np.isfinite(std).all()):
        raise AssertionError(f"phase 17: route {metrics}, launches "
                             f"{ran.counts}, predictions {pred}")
    t_search = median_wall(lambda: eng.shadow_device(ctx, k=K_REF), 3)
    d, _, i = eng.shadow(ctx, k=K_REF)
    t0 = time.perf_counter()
    d_o, _, i_o = eng.shadow(ctx, k=K_REF, method="direct")
    t_direct = time.perf_counter() - t0
    if not agree_up_to_ties(d, i, d_o, i_o):
        raise AssertionError("phase 17: K1 route winners differ from the "
                             "direct oracle's outside the f32 tie window")
    same = int((i == i_o).all(-1).sum())
    log(f"phase 17 predict over {R_REF} x 1 x {T} normal f32 (made on the "
        f"card), Foveal(1.15, 0.9, {W_REF}) d={eng.embedding.dim}, "
        f"RelativeMSE, horizon {H_REF}, k={K_REF}, eta 0.1, Ts {TS_REF}: "
        f"dataset + window norms {t_setup:.3f} s; first call {first:.3f} s, "
        f"warm {warm:.4f} s (median of 3) beside the reference's {REF_WALL}; "
        f"{card}")
    log(f"  route {metrics['method']}, launches {ran.counts}, contexts redone "
        f"{metrics['redo_contexts']}, peak allocated {peak:.2f} GiB; the "
        f"search alone (shadow_device) {t_search:.4f} s; direct oracle "
        f"{t_direct:.3f} s; {K_REF} ids equal the direct oracle's ({same} "
        f"rank for rank, the rest inside the f32 tie window); predicted "
        f"variances {np.round(pred[0, 0].astype(float), 4).tolist()}")
    del eng, data
    torch.cuda.empty_cache()


def _wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def shard_reader(device) -> None:
    """Phase 18: the parallel shard reader against ``numpy.load`` on the
    same files, the page cache warm for both (each file is read once before
    anything is timed)."""
    import shutil

    import torch

    from shadowing_tpu_torch import TimeSeriesDataset, native

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    native.build()
    t_build = time.perf_counter() - t0

    def numpy_load(files, rows=None):
        out = np.concatenate([np.load(f) for f in files])
        return np.ascontiguousarray(out[:rows], dtype=np.float32)

    def both(label, files, reader, rows=None):
        want = numpy_load(files, rows)                 # warms the page cache
        got = reader()
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"phase 18 {label}: the reader's array "
                                 "differs from numpy.load's")
        t_new = float(np.median([_wall(reader) for _ in range(3)]))
        t_np = float(np.median([_wall(lambda: numpy_load(files, rows))
                                for _ in range(3)]))
        log(f"  {label}: {len(files)} file(s), {want.nbytes / 1e6:.1f} MB -> "
            f"{want.shape}: parallel reader {t_new:.4f} s, numpy.load "
            f"{t_np:.4f} s (medians of 3, page cache warm), arrays equal")
        return got

    log(f"phase 18 shard reader (npyloader.c built by the host compiler in "
        f"{t_build:.2f} s):")
    batched = root / "build" / "scat_cli_b"
    files = sorted(batched.glob("*.npy"))
    both("phase 14's TimeSeriesDataset directory", files,
         lambda: TimeSeriesDataset(batched).load())
    whole = MESH_DIR / "dataset.npy"
    data = both("phase 15's dataset file", [whole],
                lambda: native.load_npy_batch([str(whole)])[0])
    shards = MESH_DIR / "shards"
    shutil.rmtree(shards, ignore_errors=True)
    shards.mkdir()
    rows = data.shape[0] // N_SHARDS
    for j in range(N_SHARDS):
        np.save(shards / f"shard{j:02d}.npy", data[j * rows : (j + 1) * rows])
    files = sorted(shards.glob("*.npy"))
    # R rows short of the last shard: the reader stops once R are covered
    R_cut = data.shape[0] - rows - 1
    got = both(f"the same rows in {N_SHARDS} shards, R={R_cut}", files[:-1],
               lambda: TimeSeriesDataset(shards, R=R_cut).load(), R_cut)
    y = torch.from_numpy(got).to(device)
    if not torch.equal(y.cpu(), torch.from_numpy(data[:R_cut])):
        raise AssertionError("phase 18: rows on the card differ")
    shutil.rmtree(shards)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from shadowing_tpu_torch.ops import _build

    device = torch.device("cuda")
    card = card_line()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    _build.build(verbose=True)
    log(f"phase 2 build: both kernels in {time.perf_counter() - t0:.1f} s "
        f"({_build.library_path().parent.name})")

    t0 = time.perf_counter()
    dataset = (np.random.default_rng(0).standard_normal((R, 1, T))
               * 0.011).astype(np.float32)
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    np.save(MESH_DIR / "dataset.npy", dataset)    # phase 15 reads it back
    log(f"dataset {dataset.shape} float32 made and saved in "
        f"{time.perf_counter() - t0:.1f} s")
    y = torch.from_numpy(dataset).to(device)
    log("phase 3 kernel vs plain (median of 5 device times):")
    res = kernels_vs_plain(y, device)
    del y
    torch.cuda.empty_cache()

    path = main_path(dataset, device)
    torch.cuda.empty_cache()
    fused_route(dataset, device)
    selection(device)
    float64_route(dataset, device)
    sharded_rows(dataset, device)
    del dataset
    torch.cuda.empty_cache()
    backtest(mrw_dataset(device), device)
    torch.cuda.empty_cache()
    pdv_paths(device)
    torch.cuda.empty_cache()
    scattering_search(scattering_generation(device), device)
    torch.cuda.empty_cache()
    generation_cli(device)
    torch.cuda.empty_cache()
    mesh = mesh_phase(path, device)
    torch.cuda.empty_cache()
    figures(device)
    reference_cell(device, card)
    shard_reader(device)
    launches = {n: path[n] + Launches.totals[n] + mesh[n] for n in ("K1", "K2")}
    log(f"launches over every path: {launches} (phases 4-6 {path['K1']} K1, "
        f"{path['K2']} K2; phases 7-14 and 16-17 {Launches.totals}; phase 15 {mesh})")
    kernels = []
    for name, tag, source, replaces in (
            ("blockmin_toeplitz", "K1",
             "shadowing_tpu_torch/csrc/blockmin_toeplitz.cu",
             "shadowing_tpu/ops/pallas_search.py:209"),
            ("blockmin_factored", "K2",
             "shadowing_tpu_torch/csrc/blockmin_factored.cu",
             "shadowing_tpu/ops/pallas_factored.py:174")):
        main = res["shapes"][tag][0]     # the main path's shape
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[tag],
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None, "library": LIBRARY,
            "shapes": res["shapes"][tag], "sweep": res["sweep"][tag]})
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        mesh_worker(Path(sys.argv[2]), sys.argv[3])
    else:
        sys.exit(main())
