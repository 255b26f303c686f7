"""Plain PyTorch references of the configurations. They import nothing of
the program: neither ``repro_torch`` nor JAX nor the JAX package."""
