"""Finalize's gathers (``ops/finalize.py``) on the CPU, where each wrapper
runs its plain version: the winners' embeddings and windows equal the
extraction they replace, bit for bit, for every kind of context, and the
single-rank finalize returns what the extract-then-rescore route returned.

The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from shadowing_tpu_torch import (
    CosineDistance,
    CrossChannelContext,
    Foveal,
    ImputationContext,
    PredictionContext,
    RelativeMSE,
)
from shadowing_tpu_torch.ops import finalize
from shadowing_tpu_torch.parallel.sharding import (
    local_mesh,
    sharded_finalize_shadow,
)
from shadowing_tpu_torch.shadow.embedding import embed_windows
from shadowing_tpu_torch.shadow.routes import (
    _exact_rescore,
    _extract_paths,
    _in_positions,
)

# (context, dataset channels C, bank (d, C_bank, w), extracted window width)
CONTEXTS = {
    "horizon": (PredictionContext(20), 1, (20, 1, 20), 40),
    "foveal": (PredictionContext(252), 1, "foveal", 378),
    "no horizon, three channels": (PredictionContext(None), 3, (7, 3, 9), 9),
    "portion": (ImputationContext((10, 6, 14)), 1, (9, 1, 24), 30),
    "channels": (CrossChannelContext(1), 2, (5, 1, 20), 20),
}


def problem(name, R=23, T=500, B=3, k=41, seed=0):
    """Trajectories, a bank, sorted flat ids with the last valid one among
    them, and the context's input positions."""
    ctx, C, bank, w_extract = CONTEXTS[name]
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.normal(0, 0.02, size=(R, C, T)).astype(np.float32))
    if bank == "foveal":
        kernel = torch.from_numpy(Foveal(1.15, 0.9, 126).kernel)
    else:
        kernel = torch.from_numpy(rng.normal(size=bank).astype(np.float32))
    n_out = T - w_extract + 1
    ids = np.sort(rng.integers(0, R * n_out, size=(B, k)), axis=1)
    ids[-1, -1] = R * n_out - 1
    pos = _in_positions(ctx.select_in_context, C, w_extract, "cpu")
    return ctx, y, kernel, torch.from_numpy(ids), n_out, w_extract, pos


@pytest.mark.parametrize("name", list(CONTEXTS))
def test_plain_gathers_equal_the_extraction(name):
    """``gather_embed`` equals ``embed_windows`` of the context's input part
    of ``_extract_paths``' windows, and ``extract_windows`` those windows,
    bit for bit."""
    ctx, y, kernel, ids, n_out, w_extract, pos = problem(name)
    paths, _ = _extract_paths(y, ids, n_out, w_extract)
    want = embed_windows(ctx.select_in_context(paths), kernel)
    assert torch.equal(finalize.gather_embed(y, ids, n_out, pos, kernel), want)
    assert torch.equal(finalize.extract_windows(y, ids, n_out, w_extract),
                       paths)


@pytest.mark.parametrize("name,want", [
    ("horizon", list(range(20))),
    ("no horizon, three channels", list(range(9))),
    ("portion", list(range(10)) + list(range(16, 30))),
    ("channels", list(range(20))),
])
def test_in_positions_of_each_context(name, want):
    *_, pos = problem(name)
    assert pos.dtype == torch.int64 and pos.is_contiguous()
    assert pos.tolist() == want


def test_embed_windows_is_the_plain_product_sum_on_the_cpu():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 5, 2, 11)).astype(np.float32))
    kernel = torch.from_numpy(rng.normal(size=(6, 2, 11)).astype(np.float32))
    assert torch.equal(embed_windows(x, kernel),
                       (x.unsqueeze(-3) * kernel).sum(dim=(-2, -1)))


def extract_then_rescore(y, flat_idx, x_emb, kernel, n_out, w_extract,
                         distance, select_in):
    """What finalize ran on one rank before the gathers: extraction, the
    rescore of the input part, the stable sort and two permuting gathers."""
    flat_idx = torch.sort(flat_idx, dim=-1).values
    paths, idces = _extract_paths(y, flat_idx, n_out, w_extract)
    dists = _exact_rescore(x_emb, select_in(paths), kernel, distance)
    dists, order = torch.sort(dists, dim=-1, stable=True)
    paths = torch.gather(paths, 1, order[..., None, None].expand_as(paths))
    idces = torch.gather(idces, 1, order[..., None].expand_as(idces))
    return dists, paths, idces


@pytest.mark.parametrize("name", list(CONTEXTS))
@pytest.mark.parametrize("distance", [RelativeMSE(), CosineDistance()],
                         ids=["relative-mse", "cosine"])
def test_one_rank_finalize_equals_extract_then_rescore(name, distance):
    """The same distances, paths and ids, bit for bit, in the canonical
    (distance, flat id) order, with duplicated windows among the winners
    (exact ties) and a context equal to a winner (RelativeMSE 0.0)."""
    ctx, y, kernel, ids, n_out, w_extract, _ = problem(name, seed=2)
    y[5] = y[3]                          # rows 3 and 5 tie window for window
    ids[:, :6] = torch.tensor([3 * n_out + 2, 5 * n_out + 2, 3 * n_out + 7,
                               5 * n_out + 7, 5 * n_out + 11, 3 * n_out + 11])
    ids = ids[:, torch.randperm(ids.shape[1],
                                generator=torch.Generator().manual_seed(0))]
    paths, _ = _extract_paths(y, ids[:, :1].contiguous(), n_out, w_extract)
    x_emb = embed_windows(ctx.select_in_context(paths[:, 0]), kernel)
    args = (y, ids, x_emb, kernel, n_out, w_extract, distance,
            ctx.select_in_context)
    got = sharded_finalize_shadow(*args, local_mesh("cpu"))
    want = extract_then_rescore(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if isinstance(distance, RelativeMSE):
        assert (got[0][:, 0] == 0.0).all()
    assert (got[0][:, 1:] >= got[0][:, :-1]).all()
