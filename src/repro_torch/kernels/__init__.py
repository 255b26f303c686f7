"""Integer kernels of the PyTorch port: the plain PyTorch oracles
(``ref``), the hand-written Hopper kernels with their wrappers, and the
serving-path orchestration around them (``ops``)."""
