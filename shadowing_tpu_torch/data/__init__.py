"""Data layer: price containers, shard datasets, bundled series (numpy)."""
from shadowing_tpu_torch.data.dataset import TimeSeriesDataset, batch_npy_files
from shadowing_tpu_torch.data.price_data import PriceData
from shadowing_tpu_torch.data.snp import SPDaily
from shadowing_tpu_torch.data.windows import windows
