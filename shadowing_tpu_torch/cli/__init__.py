"""Command-line entry points (``python -m shadowing_tpu_torch.cli.<name>``)."""
