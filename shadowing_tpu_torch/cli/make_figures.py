"""Draw the README's illustration figures from the tutorial flow.

Port of :mod:`shadowing_tpu.cli.make_figures`: a shadow band around an
observed history and the conditional implied-volatility smiles of the
matched futures. Deterministic (seeded MRW dataset made on the device,
bundled SPDaily context):

    python -m shadowing_tpu_torch.cli.make_figures [outdir] [--device cpu]

The figures go to ``build/figures`` unless ``outdir`` is given; the
committed ``illustration/`` files are the JAX package's and are never
overwritten by default.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

W, HORIZON, K, R, T = 126, 252, 8192, 2048, 4097


def compute(device: str = "cuda") -> dict:
    """The figures' data, computed on ``device``: the context, its ``K``
    closest paths and their distances (numpy), and the conditional smile."""
    import torch

    from shadowing_tpu_torch import (
        Identity,
        MRWGenerator,
        PathShadowing,
        PredictionContext,
        PriceData,
        RelativeMSE,
        SPDaily,
        Softmax,
        compute_smile,
    )

    # tutorial flow: MRW dataset, observed S&P context
    lnx = MRWGenerator(T=T, H=0.5, lam=0.2, seed=3, device=device).load(R)
    dataset = torch.diff(lnx, dim=-1)                            # (R, 1, T-1)
    ctx = SPDaily().dlnx[0, 0, -W:].astype(np.float32)
    # match the context's scale to the dataset's (the tutorial normalises)
    ctx = ctx * float(dataset.std()) / ctx.std()

    obj = PathShadowing(Identity(W), RelativeMSE(), dataset,
                        PredictionContext(horizon=HORIZON), device=device)
    distances, close_paths, _ = obj.shadow(ctx, k=K)

    # conditional smile of the matched futures
    ave = Softmax(distances[0], eta=0.075)
    x = PriceData(dlnx=close_paths[0, :, 0, W:], x_init=100.0).x
    smile = compute_smile(torch.as_tensor(x, device=obj.device),
                          Ts=[7, 25, 75], Ms=np.linspace(-2, 2, 9), ave=ave)
    return {"ctx": ctx, "distances": distances[0],
            "close_paths": close_paths[0], "smile": smile}


def draw(data: dict, outdir: Path | str = None) -> list:
    """``shadow.png`` and ``smile.png`` of :func:`compute`'s data."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from shadowing_tpu_torch import plot_shadow

    outdir = (Path(outdir) if outdir
              else Path(__file__).parents[2] / "build" / "figures")
    outdir.mkdir(parents=True, exist_ok=True)

    fig, ax = plt.subplots(figsize=(5, 2.5), dpi=150)
    plot_shadow(data["ctx"], data["distances"], data["close_paths"], eta=0.09,
                ax=ax)
    fig.tight_layout()
    shadow_png = outdir / "shadow.png"
    fig.savefig(shadow_png)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(4, 3), dpi=150)
    data["smile"].plot(ax=ax, color="black", rescale=True, legend=True)
    ax.set_title("conditional smile (Hedged MC on shadow paths)", fontsize=9)
    fig.tight_layout()
    smile_png = outdir / "smile.png"
    fig.savefig(smile_png)
    plt.close(fig)

    print(f"wrote {shadow_png} and {smile_png}")
    return [shadow_png, smile_png]


def main(outdir: Path | str = None, device: str = "cuda") -> list:
    return draw(compute(device), outdir)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("outdir", nargs="?", default=None)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    main(**vars(parser.parse_args()))
