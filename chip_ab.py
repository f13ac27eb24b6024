#!/usr/bin/env python3
"""Time the port's search workloads from several checkouts on one card.

    python3 chip_ab.py TREE [TREE ...]

Each ``TREE`` is the root of a checkout that holds ``shadowing_tpu_torch``
(``.`` for this one; an older commit unpacked with ``git archive`` into a
directory for another). Every tree is measured in a process of its own, one
after the other in the order given, so ``parent change change parent`` on
one card in one call compares two versions under the same power limit. Only
entry points that every slice of the port since the second has are used:

* ``rolling_backtest`` with the AR-linear benchmark over an MRW dataset of
  32,768 x 4,096 returns made on the card: 2,048 dates at k = 1,024 and 256
  dates at k = 16,384, 64-date chunks (K2 and pass 2 on every chunk);
* the fused route, ``shadow`` at k = 1,024 over 32,768 x 4,096 normal
  returns: cosine over ``Identity(20)`` at B = 1 and 64, RelativeMSE over
  ``Foveal(1.15, 0.9, 400)`` at B = 64;
* ``predict`` at k = 10,000 over 131,072 x 4,096 normal returns with
  ``Foveal(1.15, 0.9, 126)``, horizon 252 (K1 at B = 1, w = 126).

Per workload: the first call's wall, the median of three warm walls (each
ends in a synchronize) and the contexts redone. One JSON object per tree is
printed and the list is written to ``build/chip_ab.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

R, T, W, H, K = 32768, 4096, 20, 20, 1024
TS = [5, 10, 20]
BACKTESTS = ((1024, 2048), (16384, 256))       # (k, dates)
R_REF, W_REF, H_REF, K_REF = 131072, 126, 252, 10000


def first_and_warm(fn, n: int = 3) -> tuple:
    import torch

    walls = []
    for _ in range(n + 1):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls[0], float(np.median(walls[1:]))


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import shadowing_tpu_torch as P

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    out = {"tree": str(tree), "card": card,
           "package": str(Path(P.__file__).resolve().parent)}
    snp = P.SPDaily().dlnx[0, 0]

    def record(name, eng, fn, work):
        first, warm = first_and_warm(fn)
        out[name] = {"first_s": first, "warm_s": warm, "per_s": work / warm,
                     "redo_contexts": eng.last_metrics["redo_contexts"],
                     "redo_log": [s for s in eng.routing_log
                                  if s.startswith("redo")]}

    lnx = P.MRWGenerator(T=T + 1, H=0.5, lam=0.2, seed=0,
                         device=device).generate(R)
    eng = P.PathShadowing(P.Identity(W), P.RelativeMSE(),
                          torch.diff(lnx, dim=-1), P.PredictionContext(H),
                          device=device)
    del lnx
    for k, n_dates in BACKTESTS:
        series = snp[-(n_dates + W + H - 1):]
        record(f"backtest k={k}, {n_dates} dates (dates/s)", eng,
               lambda: P.rolling_backtest(eng, series, w=W, Ts=TS, k=k,
                                          n_context_splits=n_dates // 64,
                                          benchmark="ar-linear"), n_dates)
    del eng
    torch.cuda.empty_cache()

    gen = torch.Generator(device=device).manual_seed(0)
    data = torch.randn((R, 1, T), generator=gen, device=device) * 0.011
    rng = np.random.default_rng(1)
    for label, emb, dist, w, batches in (
            ("cosine Identity(20)", P.Identity(W), P.CosineDistance(), W,
             (1, 64)),
            ("RelativeMSE Foveal(1.15, 0.9, 400)", P.Foveal(1.15, 0.9, 400),
             P.RelativeMSE(), 400, (64,))):
        eng = P.PathShadowing(emb, dist, data, P.PredictionContext(H),
                              device=device)
        rows, starts = rng.integers(0, R, 64), rng.integers(0, T - w - H, 64)
        ctx = torch.stack([data[r, :, s : s + w] for r, s in zip(rows, starts)])
        for B in batches:
            record(f"fused {label} B={B} (contexts/s)", eng,
                   lambda: eng.shadow_device(ctx[:B], k=K), B)
        del eng
        torch.cuda.empty_cache()
    del data
    torch.cuda.empty_cache()

    data = torch.randn((R_REF, 1, T), generator=gen, device=device)
    ctx = torch.randn((1, 1, W_REF), generator=gen, device=device)
    eng = P.PathShadowing(P.Foveal(1.15, 0.9, W_REF), P.RelativeMSE(), data,
                          P.PredictionContext(H_REF), device=device)
    to_predict = lambda x: P.realized_variance(x, Ts=[2, 7, 252], vol=False)
    record(f"predict Foveal-126 k={K_REF}, {R_REF} rows (calls/s)", eng,
           lambda: eng.predict(ctx, k=K_REF, to_predict=to_predict, eta=0.1), 1)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def main(trees: list) -> int:
    results = []
    for tree in trees:
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--one", str(Path(tree).resolve())],
                             capture_output=True, text=True, timeout=1500)
        if run.returncode != 0:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        results.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_ab.json").write_text(json.dumps(results, indent=1))
    names = [n for n in results[0] if isinstance(results[0][n], dict)]
    for name in names:
        print(f"{name}: warm s " + " | ".join(
            f"{r[name]['warm_s']:.4f} ({r[name]['per_s']:.1f}/s, redo "
            f"{r[name]['redo_contexts']})" for r in results), flush=True)
    print(results[0]["card"])
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(Path(sys.argv[2]))))
    elif len(sys.argv) > 1:
        sys.exit(main(sys.argv[1:]))
    else:
        sys.exit(__doc__)
