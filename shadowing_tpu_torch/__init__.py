"""shadowing-tpu-torch: Path Shadowing Monte Carlo in PyTorch and CUDA.

The port of :mod:`shadowing_tpu` (JAX) to PyTorch on an NVIDIA Hopper card:
the same public names and method signatures, plain PyTorch around two
hand-written CUDA kernels for pass 1 of the search (``csrc/``). It imports
neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from shadowing_tpu_torch.array_types import Array, as_numpy, dim_bct
from shadowing_tpu_torch.convert import from_numpy_state
from shadowing_tpu_torch.data import (
    PriceData,
    SPDaily,
    TimeSeriesDataset,
    batch_npy_files,
    windows,
)
from shadowing_tpu_torch.pricing.hedged_mc import (
    Smile,
    compute_smile,
    compute_smile_batch,
)
from shadowing_tpu_torch.shadow.context import (
    ContextManager,
    CrossChannelContext,
    ImputationContext,
    PredictionContext,
)
from shadowing_tpu_torch.shadow.distance import (
    CosineDistance,
    MSE,
    PathDistance,
    RelativeMSE,
)
from shadowing_tpu_torch.shadow.embedding import Foveal, Identity, PathEmbedding
from shadowing_tpu_torch.shadow.engine import PathShadowing
from shadowing_tpu_torch.stats.proba import DiscreteProba, Softmax, Uniform
from shadowing_tpu_torch.stats.realized import get_RV, realized_variance

_LAZY = {
    # workflows
    "rolling_backtest": "shadowing_tpu_torch.backtest",
    "BacktestResult": "shadowing_tpu_torch.backtest",
    "shadow_sharded_rows": "shadowing_tpu_torch.shadow.engine",
    # generators
    "MRWGenerator": "shadowing_tpu_torch.models.mrw",
    "PDVModel": "shadowing_tpu_torch.models.pdv",
    "PDVModelDiscrete": "shadowing_tpu_torch.models.pdv",
    "AutoregressiveLinearPredictor": "shadowing_tpu_torch.models.pdv",
    "compute_factor": "shadowing_tpu_torch.models.pdv",
    "future_pdv_model": "shadowing_tpu_torch.models.pdv",
    "kernel_exp": "shadowing_tpu_torch.models.pdv",
    "kernel_pl": "shadowing_tpu_torch.models.pdv",
    "DEFAULT1": "shadowing_tpu_torch.models.pdv",
    "DEFAULT2": "shadowing_tpu_torch.models.pdv",
    "analyze": "shadowing_tpu_torch.models.scattering",
    "generate": "shadowing_tpu_torch.models.scattering",
    "scattering_stats": "shadowing_tpu_torch.models.scattering",
    "ScatteringStats": "shadowing_tpu_torch.models.scattering",
    "FilterBank": "shadowing_tpu_torch.models.scattering",
    "build_filter_bank": "shadowing_tpu_torch.models.scattering",
    # the mesh
    "data_mesh": "shadowing_tpu_torch.parallel",
    "shard_dataset": "shadowing_tpu_torch.parallel",
    "sharded_fused_search": "shadowing_tpu_torch.parallel",
    "sharded_synthesis_step": "shadowing_tpu_torch.parallel",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Array",
    "ContextManager",
    "CosineDistance",
    "CrossChannelContext",
    "DiscreteProba",
    "Foveal",
    "Identity",
    "ImputationContext",
    "MSE",
    "PathDistance",
    "PathEmbedding",
    "PathShadowing",
    "PredictionContext",
    "PriceData",
    "RelativeMSE",
    "SPDaily",
    "Smile",
    "Softmax",
    "TimeSeriesDataset",
    "Uniform",
    "as_numpy",
    "batch_npy_files",
    "compute_smile",
    "compute_smile_batch",
    "dim_bct",
    "from_numpy_state",
    "get_RV",
    "realized_variance",
    "windows",
    *_LAZY,
]
