"""Plotting helpers (matplotlib imported lazily by the functions)."""
from shadowing_tpu_torch.viz.plots import (
    plot_closest,
    plot_dashboard,
    plot_shadow,
    plot_volatility,
)
