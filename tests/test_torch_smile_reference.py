"""The port's Hedged-MC smiles against the plain float64 reference
(``benchmark/reference/hedged_mc.py``, the one the benchmark's check
reads), on the CPU at small sizes: under Softmax weights at eta = 0.075
that leave one or two effective paths (where a float32 solve of the normal
equations fails), under spread weights, on both knot branches, and through
``PathShadowing.predict_and_smile``.

Every gap is a share of the spot (100). Vols are compared where the
reference has one and its price lies at least ``VOL_FLOOR`` of the spot
inside the prices that have one, as in the benchmark's check."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import shadowing_tpu_torch as P  # noqa: E402
from shadowing_tpu_torch.pricing import hedged_mc  # noqa: E402
from shadowing_tpu_torch.shadow import engine  # noqa: E402

from benchmark.reference import hedged_mc as ref  # noqa: E402
from benchmark.reference import search as ref_search  # noqa: E402
from benchmark.reference.precision import Arith  # noqa: E402

SPOT = 100.0
TS, MS = [5, 10, 20], np.linspace(-2, 2, 9)
ETA = 0.075
#: the engine hands the pricing float64 paths and float32 weights (the
#: softmax of float32 distances, rounded by ~1e-6 relative where the
#: exponent is ~20): the prices move by up to 1.8e-8 of the spot over 20
#: seeds of each kind of weights below
PRICE_TOL = 2e-7
#: the public calls take float32 paths: each log-return of a price near
#: 100 is rounded by ~5e-7, which moves sigma_T by up to ~1e-5 and, under
#: weights on a few paths, the prices by up to 7e-7 of the spot here and
#: 6.5e-6 on MRW paths of the benchmark's dataset
PRICE_TOL_F32_PATHS = 2e-5
#: the port inverts Black-Scholes in float32 (its prices rounded by ~1e-6
#: of the spot): at VOL_FLOOR of room a vol moves by up to 1.2e-5 here
VOL_TOL = 1e-4
VOL_FLOOR = 1e-4
#: the reference computed in float32 (products not rounded to TF32)
FLOAT32 = Arith("float32", np.float32, torch.float32)


def winners(seed: int, concentrated: bool, N: int = 1024):
    """Distances ``(N,)`` ascending (float32 values) and futures ``(N,
    20)`` of an S&P-like path set: two near winners and the rest far at
    eta = 0.075 (one or two effective paths), or every winner alike."""
    rng = np.random.default_rng(seed)
    fut = (rng.standard_t(4, size=(N, 20)) * 0.0126 / np.sqrt(2)).astype(np.float32)
    if concentrated:
        d = np.sort(0.42 + np.abs(rng.normal(0.0, 0.1, N)))
        d[0], d[1] = 0.25, 0.25 + rng.uniform(0.0, 0.12)
    else:
        d = np.sort(0.3 + rng.uniform(0.0, 0.02, N))
    return d.astype(np.float32), fut


def engine_smile(d, fut):
    """The smile as ``PathShadowing.predict_and_smile`` prices it."""
    prices, w = engine._smile_inputs(torch.as_tensor(d)[None],
                                     torch.as_tensor(fut)[None, :, None, :],
                                     ETA, SPOT)
    return hedged_mc._smiles(prices, w, TS, MS, 0.0, 12)[0], prices, w


def reference(d, fut, arith=ref.FLOAT64) -> dict:
    return ref.smile(np.float64(d), np.float64(fut), TS, MS, ETA, SPOT, 0.0,
                     arith)


def gaps(sm, want: dict) -> tuple:
    """Largest price gap (share of the spot) and vol gap where compared."""
    price = np.abs(np.float64(sm.prices) - want["prices"]).max() / SPOT
    compared = np.isfinite(want["vols"]) & (want["room"] >= VOL_FLOOR * SPOT)
    got = np.float64(sm.vols)[compared]
    assert np.isfinite(got).all()
    vol = np.abs(got - want["vols"][compared]).max() if compared.any() else 0.0
    return price, vol


@pytest.mark.parametrize("concentrated", [True, False],
                         ids=["one-or-two-paths", "spread"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_smile_meets_the_float64_answer(seed, concentrated):
    d, fut = winners(seed, concentrated)
    n_eff = ref.effective_paths(np.float64(d), ETA)
    assert (n_eff < 2.5) if concentrated else (n_eff > 500)
    sm, _, _ = engine_smile(d, fut)
    price, vol = gaps(sm, reference(d, fut))
    assert price <= PRICE_TOL and vol <= VOL_TOL
    assert sm.prices.dtype == np.float32 and sm.vols.dtype == np.float32
    assert sm.strikes.dtype == np.float64 and sm.prices.shape == (3, 9)


@pytest.mark.parametrize("concentrated", [True, False],
                         ids=["one-or-two-paths", "spread"])
def test_compute_smile_batch_on_float32_paths(concentrated):
    d, fut = winners(3, concentrated)
    _, prices, w = engine_smile(d, fut)
    sm = P.compute_smile_batch(prices.float(), TS, MS, weights=w)[0]
    price, vol = gaps(sm, reference(d, fut))
    assert price <= PRICE_TOL_F32_PATHS and vol <= VOL_TOL


def test_the_tolerance_has_teeth():
    """The reference computed in float32 leaves the float64 answer by
    more than either price tolerance where the weights sit on one or two
    paths (by 6.1e-5 of the spot here, 1.0e-5 to 2.0e-4 over 20 seeds)."""
    d, fut = winners(0, True)
    want, f32 = reference(d, fut), reference(d, fut, FLOAT32)
    gap = np.nanmax(np.abs(f32["prices"] - want["prices"])) / SPOT
    assert gap > PRICE_TOL_F32_PATHS and gap > 100 * PRICE_TOL


@pytest.mark.parametrize("concentrated", [True, False],
                         ids=["one-or-two-paths", "spread"])
@pytest.mark.parametrize("N", [256, 2048], ids=["empirical", "moment"])
def test_hmc_prices_both_knot_branches_meet_the_reference(N, concentrated):
    d, fut = winners(4, concentrated, N)
    paths = ref.price_paths(np.float64(fut), SPOT)
    w = torch.as_tensor(np.float32(P.Softmax(torch.as_tensor(d), ETA)
                                   .weights_like(torch.as_tensor(d), 0)))
    strikes = SPOT * torch.exp(torch.as_tensor(MS) * 0.2 * np.sqrt(20 / 252))
    got = hedged_mc._hmc_prices(paths, w, strikes, 1.0, 12)
    want = ref.hmc_prices(paths, w.double() / w.double().sum(), strikes)
    assert got.dtype == torch.float64
    assert (got - want).abs().max().item() / SPOT <= PRICE_TOL


def test_predict_and_smile_end_to_end():
    """A small dataset searched by the port on the CPU: its smiles equal
    the reference's, priced on the reference's own float64 search."""
    rng = np.random.default_rng(11)
    W, H, k = 20, 20, 64
    ds = rng.normal(0.0, 0.0126, size=(40, 1, 400)).astype(np.float32)
    ctx = (ds[[3, 17], :, 100:120]
           + rng.normal(0.0, 0.004, size=(2, 1, W))).astype(np.float32)
    eng = P.PathShadowing(P.Identity(W), P.RelativeMSE(), ds,
                          P.PredictionContext(H), device="cpu")
    _, _, smiles = eng.predict_and_smile(
        ctx, k=k, to_predict=lambda x: P.realized_variance(x[:, :, 0, :], TS),
        Ts=TS, Ms=MS, eta=0.1, eta_smile=ETA)
    dist, _, paths = ref_search.search(
        torch.as_tensor(ds), np.float64(ctx),
        ref_search.embedding_kernel({"kind": "identity", "dim": W}), H, k,
        ref.FLOAT64)
    fut = paths[:, :, 0, W:].numpy()
    for b, sm in enumerate(smiles):
        assert ref.effective_paths(dist[b], ETA) < 24
        price, vol = gaps(sm, reference(dist[b], fut[b]))
        assert price <= PRICE_TOL and vol <= VOL_TOL


def test_the_card_kernel_takes_cuda_tensors_only():
    """On a CPU tensor the pricing runs its plain version; the kernel's
    wrapper refuses one rather than fall back."""
    from shadowing_tpu_torch.ops import smile

    d, fut = winners(0, True, N=64)
    _, prices, w = engine_smile(d, fut)
    strikes = torch.full((1, 1, 3), SPOT, dtype=torch.float64)
    with pytest.raises(ValueError, match="no hedged_mc_smile kernel"):
        smile.hedged_mc_smile(prices, w, strikes,
                              hedged_mc._regression_knots(prices, 12), [5],
                              1.0, 0.0)

