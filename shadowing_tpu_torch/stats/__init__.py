"""Averaging measures and realized-volatility statistics."""
