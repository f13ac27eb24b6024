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
3. kernel vs plain: K1 at (B=1, w=20), (B=4, w=126) and a ragged C=2
   shape; K2 at (B=64, d=20) and (B=8, d=48);
4. one context: ``predict_and_smile`` on the last 20 daily returns of the
   bundled S&P-like series, checked against the on-card direct oracle;
5. 64 contexts: ``predict`` through the factored kernel, checked against
   the Toeplitz kernel's route and the direct oracle;
6. the redo path: a forced pass-2 certification failure must still
   return the certified winners of phase 4.

Every check raises on failure. The line before the last is a JSON object
of the kernels' launch counts on the main path, errors and times; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
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


def compare(label: str, kernel_fn, plain_fn) -> dict:
    """Kernel vs plain on the same inputs: error relative to the largest
    finite score, count of blocks that differ, and both times."""
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
    ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn)
    rel = err / scale
    log(f"  {label}: max_abs_err {err:.3e} = {rel:.3e} of max|score| "
        f"{scale:.4g}, differing blocks {n_diff}, +inf blocks "
        f"{int((~fin_w).sum())}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if torch.isnan(got).any() or rel > TOL or n_diff:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def windows(y, rows, starts, w: int):
    import torch

    return torch.stack([y[r, :, s : s + w] for r, s in zip(rows, starts)])


def kernels_vs_plain(y, device) -> dict:
    """Phase 3: both kernels against their plain versions at the main
    path's shapes, plus a ragged shape."""
    import torch

    from shadowing_tpu_torch.ops import factored, search
    from shadowing_tpu_torch.shadow.embedding import embed_windows
    from shadowing_tpu_torch.shadow.engine import _window_norms

    def identity_norms(y, w, n_out):        # the Identity(w) engine's norms
        C = y.shape[1]
        bank = torch.eye(C * w, device=y.device).reshape(C * w, C, w)
        return _window_norms(y, bank, n_out, n_splits=16, identity_fast=True)

    rng = np.random.default_rng(2)
    res = {}
    Rn, _, Tn = y.shape
    for B, w in ((1, W), (4, 126)):
        n_out = Tn - w - H + 1
        norms = identity_norms(y, w, n_out)
        g = windows(y, rng.integers(0, Rn, B), rng.integers(0, n_out, B), w)
        r = compare(f"K1 blockmin_toeplitz B={B} w={w} ({Rn}x{Tn})",
                    lambda: search.score_blockmin(y, norms, g),
                    lambda: search.score_blockmin_plain(y, norms, g))
        res.setdefault("K1", r)
        del norms
    # ragged: R, n_out off every tile, two channels, barred (+inf) rows
    yr = torch.from_numpy(rng.standard_normal((1001, 2, 700)).astype(np.float32)
                          * 0.011).to(device)
    norms = identity_norms(yr, 33, 601)
    norms[[5, 600]] = float("inf")
    g = windows(yr, [3, 70, 999], [0, 17, 600], 33)
    compare("K1 blockmin_toeplitz ragged R=1001 C=2 n_out=601 w=33 B=3",
            lambda: search.score_blockmin(yr, norms, g),
            lambda: search.score_blockmin_plain(yr, norms, g))

    for B, d, kw in ((64, 20, None), (8, 48, 64)):
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
        x_emb = embed_windows(
            windows(y, rng.integers(0, Rn, B), rng.integers(0, n_out, B), w),
            kernel).contiguous()
        r = compare(f"K2 blockmin_factored B={B} d={d} ({Rn}x{Tn}, E "
                    f"{E.numel() * 4 / 1e9:.2f} GB)",
                    lambda: factored.score_blockmin_factored(E, norms, x_emb),
                    lambda: factored.score_blockmin_factored_plain(E, norms,
                                                                   x_emb))
        res.setdefault("K2", r)
        del E, norms
        torch.cuda.empty_cache()
    return res


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
        f"route {eng.last_metrics['method']}")
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
        f"{k2_launches}, K1 launches {TOEPLITZ.launches}")
    if k2_launches == 0:
        raise AssertionError("the batched main path never launched K2")
    if not any(s.startswith("factored pass-1 routed") for s in eng.routing_log):
        raise AssertionError(f"no factored grant in {eng.routing_log}")
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
    log(f"  checks: routing_log grants the factored route, 64x{K} ids equal "
        f"the K1 route's, 2x{K} ids equal the direct oracle")

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
            "predict64_warm_s": warm64, "e_build_s": e_build}


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
    log(f"dataset {dataset.shape} float32 made in "
        f"{time.perf_counter() - t0:.1f} s")
    y = torch.from_numpy(dataset).to(device)
    log("phase 3 kernel vs plain (median of 5 device times):")
    res = kernels_vs_plain(y, device)
    del y
    torch.cuda.empty_cache()

    path = main_path(dataset, device)
    kernels = [
        {"name": "blockmin_toeplitz", "route": "cuda",
         "source": "shadowing_tpu_torch/csrc/blockmin_toeplitz.cu",
         "replaces": "shadowing_tpu/ops/pallas_search.py:209",
         "launches": path["K1"], **res["K1"]},
        {"name": "blockmin_factored", "route": "cuda",
         "source": "shadowing_tpu_torch/csrc/blockmin_factored.cu",
         "replaces": "shadowing_tpu/ops/pallas_factored.py:174",
         "launches": path["K2"], **res["K2"]},
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
