"""The systems a search cell drives through the same loop and check (an
entry that is not a search brings its own, ``harness.program_system``).

:class:`Program` is the system under test: ``shadowing_tpu_torch``'s
``PathShadowing`` built on the harness's dataset, driven by the entries
through its public calls. :class:`Oracle` computes the same outputs with
the plain reference in a given arithmetic: in float64 it is what the check
compares with; in TF32 it is the control, which the check must refuse and
which a benchmark run never runs.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import predict, search
from benchmark.reference.precision import Arith


class Program:
    """``shadowing_tpu_torch`` on the run's dataset."""

    def __init__(self, config: dict, tr: dict, data: torch.Tensor, device):
        import shadowing_tpu_torch as st

        self.st, self.config, self.tr = st, config, tr
        self.shape = tuple(data.shape)
        emb = config["embedding"]
        if emb["kind"] == "identity":
            embedding = st.Identity(int(emb["dim"]))
        else:
            embedding = st.Foveal(emb["alpha"], emb["beta"], int(emb["width"]))
        if config["distance"] != "relative_mse":
            raise ValueError(f"unknown distance {config['distance']!r}")
        self.engine = st.PathShadowing(
            embedding, st.RelativeMSE(), data,
            st.PredictionContext(horizon=int(config["horizon"])), device=device)
        Ts = [int(T) for T in config["Ts"]]
        #: the user's functional of the winners' futures (channel 0)
        self.to_predict = lambda x: st.realized_variance(x[:, :, 0, :], Ts=Ts)
        self.redo = 0

    def _metrics(self) -> dict:
        return getattr(self.engine, "last_metrics", None) or {}

    def after_call(self) -> None:
        self.redo += int(self._metrics().get("redo_contexts", 0))

    def launches(self) -> dict:
        """The port's launch counters of its two pass-1 kernels (evidence
        only: a counter the port no longer has reads 0)."""
        from shadowing_tpu_torch.ops import factored, search as search_ops

        return {"blockmin_toeplitz": getattr(getattr(search_ops, "TOEPLITZ", None),
                                             "launches", 0),
                "blockmin_factored": getattr(getattr(factored, "FACTORED", None),
                                             "launches", 0)}

    def evidence(self) -> dict:
        m = self._metrics()
        return {"route": m.get("method"), "factored": m.get("factored"),
                "redo_contexts": self.redo,
                "routing_log": list(getattr(self.engine, "routing_log", []))}

    def close(self) -> None:
        self.engine = None


class Oracle:
    """The plain reference in arithmetic ``arith`` on the run's dataset."""

    def __init__(self, config: dict, tr: dict, data: torch.Tensor,
                 arith: Arith):
        self.config, self.tr, self.data, self.arith = config, tr, data, arith
        self.shape = tuple(data.shape)
        self.kernel = search.embedding_kernel(config["embedding"])

    def candidates(self, contexts: np.ndarray, extra: int = 0):
        """Distances ``(B, k + extra)`` ascending and future returns
        ``(B, k + extra, horizon)`` of the ``k + extra`` windows nearest
        to each context ``(B, C, w)``."""
        dist, _, paths = search.search(
            self.data, contexts, self.kernel, int(self.config["horizon"]),
            int(self.tr["k"]) + extra, self.arith)
        return dist, paths[:, :, 0, self.kernel.shape[-1]:].cpu().numpy()

    def predictions(self, contexts: np.ndarray):
        """Distances ``(B, k)`` and future returns ``(B, k, horizon)`` of
        the k winners of each context ``(B, C, w)``, and the predicted
        variance and its standard deviation ``(B, len(Ts))``."""
        dist, fut = self.candidates(contexts)
        avg, std = predict.predict(dist, fut, self.config["Ts"],
                                   self.config["eta"], self.arith)
        return dist, fut, avg, std

    def after_call(self) -> None:
        pass

    def launches(self) -> dict:
        return {}

    def evidence(self) -> dict:
        return {"route": f"reference in {self.arith.name}"}

    def close(self) -> None:
        pass
