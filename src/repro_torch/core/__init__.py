"""Numerics core of the PyTorch port: precision policy, quantization,
bit packing and weight-group metadata."""
