"""Execution plans, backends and serving sessions of the PyTorch port."""
