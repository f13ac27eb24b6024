"""Scattering-spectra model: wavelets, statistics, max-entropy synthesis."""
from shadowing_tpu_torch.models.scattering.generate import analyze, generate
from shadowing_tpu_torch.models.scattering.moments import (
    ScatteringStats,
    scattering_stats,
)
from shadowing_tpu_torch.models.scattering.wavelets import (
    FilterBank,
    build_filter_bank,
)
