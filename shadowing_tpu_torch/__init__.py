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
]
