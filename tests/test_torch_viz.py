"""The port's plots and ``make_figures`` against the JAX package's.

Each plot is drawn by both packages on the same numpy inputs (Agg backend)
and the drawn data is compared: ``plot_closest``'s lines exactly (they are
the inputs), the Softmax mean +- std bands of ``plot_shadow`` and
``plot_volatility`` at 1e-6 relative (float32 weighted sums in another
order), the dashboard's curves and images at the tolerance
``tests/test_torch_scattering.py`` holds ``ScatteringStats`` to (1e-4
relative, 1e-6 absolute of the statistic's scale). ``make_figures`` runs at
a shrunk size on ``device="cpu"`` and never touches ``illustration/``.
"""
import datetime
import hashlib
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import shadowing_tpu as J  # noqa: E402
import shadowing_tpu_torch as P  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
W_PAST, HORIZON, K = 12, 20, 30


@pytest.fixture()
def inputs(rng):
    dlnx = rng.normal(0, 0.01, size=W_PAST).astype(np.float32)
    paths = rng.normal(0, 0.01, size=(K, 1, W_PAST + HORIZON)).astype(np.float32)
    dists = np.sort(rng.uniform(0.1, 1.0, size=K)).astype(np.float32)
    return dlnx, paths, dists


def lines(ax):
    return [np.asarray(ln.get_xydata(), dtype=np.float64) for ln in ax.lines]


def bands(ax):
    """Vertices of every ``fill_between`` polygon of the axis."""
    return [np.asarray(c.get_paths()[0].vertices, dtype=np.float64)
            for c in ax.collections]


def same_axes(ax_p, ax_j, rtol, atol=0.0):
    assert len(ax_p.lines) == len(ax_j.lines)
    for a, b in zip(lines(ax_p), lines(ax_j)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    assert len(ax_p.collections) == len(ax_j.collections)
    for a, b in zip(bands(ax_p), bands(ax_j)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    assert ax_p.get_xlim() == ax_j.get_xlim()
    np.testing.assert_allclose(ax_p.get_ylim(), ax_j.get_ylim(), rtol=1e-6)
    assert ax_p.get_title() == ax_j.get_title()
    leg = lambda ax: [t.get_text() for t in ax.get_legend().get_texts()]
    assert leg(ax_p) == leg(ax_j)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plot_closest_draws_the_same_lines(inputs, as_tensor):
    dlnx, paths, _ = inputs
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    date = datetime.date(2014, 12, 31)
    ax_j = J.plot_closest(dlnx, paths, num_trajectories=7, date=date)
    ax_p = P.plot_closest(conv(dlnx), conv(paths), num_trajectories=7,
                          date=date)
    assert len(ax_p.lines) == 1 + 7 + 2          # present, paths, the two axes
    same_axes(ax_p, ax_j, rtol=0.0)
    assert [ln.get_alpha() for ln in ax_p.lines] == \
        [ln.get_alpha() for ln in ax_j.lines]
    plt.close("all")


def test_plot_shadow_band(inputs):
    dlnx, paths, dists = inputs
    ax_j = J.plot_shadow(dlnx, dists, paths, eta=0.3)
    ax_p = P.plot_shadow(dlnx, torch.from_numpy(dists),
                         torch.from_numpy(paths), eta=0.3,
                         date=np.datetime64("2014-12-31"))
    assert ax_p.get_title() == "2014/12/31"      # an entry of SPDaily().dts
    ax_p.set_title("")
    same_axes(ax_p, ax_j, rtol=1e-6, atol=1e-9)
    # the band is the Softmax mean +- std of the paths
    proba = P.Softmax(dists, eta=0.3)
    mean = proba.avg(paths, axis=0)[0].numpy()
    std = proba.std(paths, axis=0)[0].numpy()
    verts = bands(ax_p)[0]
    assert np.isclose(verts[:, 1].max(), (mean + std).max(), rtol=1e-6)
    assert np.isclose(verts[:, 1].min(), (mean - std).min(), rtol=1e-6)
    plt.close("all")


@pytest.mark.parametrize("with_band", [False, True])
def test_plot_volatility_cones(inputs, with_band):
    dlnx, paths, dists = inputs
    Ts = [5, 10, 20]
    vols = np.array([0.15, 0.2, 0.25], np.float32)
    kw_j = dict(distances=dists, close_paths=paths, eta=0.3) if with_band \
        else {}
    kw_p = dict(distances=torch.from_numpy(dists),
                close_paths=torch.from_numpy(paths), eta=0.3) if with_band \
        else {}
    ax_j = J.plot_volatility(dlnx, vols, Ts, **kw_j)
    ax_p = P.plot_volatility(torch.from_numpy(dlnx), torch.from_numpy(vols),
                             Ts, **kw_p)
    assert len(ax_p.collections) == len(Ts) + with_band
    same_axes(ax_p, ax_j, rtol=1e-6, atol=1e-9)
    plt.close("all")


def test_plot_dashboard(rng):
    x = rng.standard_t(4, size=1024) * 0.01
    sj, sp = J.analyze(x, J=5), P.analyze(x, J=5)
    axes_j, axes_p = J.plot_dashboard(sj), P.plot_dashboard(sp)
    for a, b in zip(axes_p[:2], axes_j[:2]):
        (la,), (lb,) = lines(a), lines(b)
        np.testing.assert_allclose(la, lb, rtol=1e-4,
                                   atol=1e-6 * np.abs(lb).max())
    for a, b in zip(axes_p[2:], axes_j[2:]):
        ia, ib = (np.asarray(ax.images[0].get_array()) for ax in (a, b))
        assert ia.shape == ib.shape == (5, 5)
        np.testing.assert_allclose(ia, ib, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(ib).max(), 1.0))
    assert [a.get_title() for a in axes_p] == [a.get_title() for a in axes_j]
    plt.close("all")


def test_make_figures_shrunk_on_the_cpu(tmp_path, monkeypatch):
    from shadowing_tpu_torch.cli import make_figures

    illustration = sorted((REPO / "illustration").iterdir())
    before = [hashlib.sha256(p.read_bytes()).hexdigest() for p in illustration]
    for name, val in dict(W=30, HORIZON=80, K=64, R=64, T=513).items():
        monkeypatch.setattr(make_figures, name, val)
    pngs = make_figures.main(tmp_path, device="cpu")
    assert [p.name for p in pngs] == ["shadow.png", "smile.png"]
    assert all(p.parent == tmp_path and p.stat().st_size > 1000 for p in pngs)
    assert all(p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" for p in pngs)
    assert sorted((REPO / "illustration").iterdir()) == illustration
    assert [hashlib.sha256(p.read_bytes()).hexdigest()
            for p in illustration] == before


def test_make_figures_default_directory_is_not_illustration(monkeypatch):
    """Without ``outdir`` the figures go under ``build/``: the committed
    ``illustration/`` files are the JAX package's."""
    from shadowing_tpu_torch.cli import make_figures

    made = []
    monkeypatch.setattr(Path, "mkdir", lambda self, **kw: made.append(self))

    class Stop(Exception):
        pass

    def stop(*a, **kw):
        raise Stop

    monkeypatch.setattr(plt, "subplots", stop)
    with pytest.raises(Stop):
        make_figures.draw({})
    assert made == [REPO / "build" / "figures"]
