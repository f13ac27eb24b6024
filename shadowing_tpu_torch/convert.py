"""Build the port's objects from an engine state handed over as numpy.

The system has no trained weights: an engine's state is its embedding
kernel bank, its context and distance settings, and its dataset.
:func:`from_numpy_state` takes that state as plain Python and numpy values,
so an engine of the JAX package and one of the port compute from identical
inputs:

.. code-block:: python

    state = {
        "embedding": {"class": "Foveal", "kernel": (d, C, w) float32,
                      "alpha": 1.15, "beta": 0.9, "max_context": 126},
        "context": {"class": "PredictionContext", "horizon": 20},
        "distance": "RelativeMSE",
        "dataset": (R, C, T) float32,
    }
"""
from __future__ import annotations

import numpy as np

from shadowing_tpu_torch.shadow import context as context_mod
from shadowing_tpu_torch.shadow import distance as distance_mod
from shadowing_tpu_torch.shadow.embedding import Foveal, Identity, PathEmbedding
from shadowing_tpu_torch.shadow.engine import PathShadowing

_CONTEXT_PARAMS = {
    "PredictionContext": "horizon",
    "ImputationContext": "portion",
    "CrossChannelContext": "out_context_channels",
}
_DISTANCES = ("RelativeMSE", "MSE", "CosineDistance")


def _embedding_from_state(state: dict) -> PathEmbedding:
    """An embedding of the named class whose kernel equals ``state["kernel"]``
    (Identity and Foveal are rebuilt from their parameters and checked)."""
    kernel = np.asarray(state["kernel"], dtype=np.float32)
    name = state["class"]
    if name == "Identity":
        emb = Identity(kernel.shape[0])
    elif name == "Foveal":
        emb = Foveal(state["alpha"], state["beta"], state["max_context"])
    elif name == "PathEmbedding":
        emb = PathEmbedding(kernel)
    else:
        raise ValueError(f"unknown embedding class {name!r}")
    if not np.array_equal(emb.kernel, kernel):
        raise ValueError(f"{name} parameters do not rebuild the given kernel "
                         f"{kernel.shape}")
    return emb


def _context_from_state(state: dict) -> context_mod.ContextManager:
    name = state["class"]
    if name not in _CONTEXT_PARAMS:
        raise ValueError(f"unknown context class {name!r}")
    param = state.get(_CONTEXT_PARAMS[name])
    if name == "ImputationContext" and param is not None:
        param = tuple(int(p) for p in param)
    return getattr(context_mod, name)(param)


def _distance_from_state(name: str) -> distance_mod.PathDistance:
    if name not in _DISTANCES:
        raise ValueError(f"unknown distance class {name!r}")
    return getattr(distance_mod, name)()


def from_numpy_state(state: dict, device) -> PathShadowing:
    """A :class:`PathShadowing` on ``device`` from an engine state (see the
    module docstring for its keys)."""
    return PathShadowing(
        _embedding_from_state(state["embedding"]),
        _distance_from_state(state["distance"]),
        np.asarray(state["dataset"], dtype=np.float32),
        _context_from_state(state["context"]),
        device=device,
    )
