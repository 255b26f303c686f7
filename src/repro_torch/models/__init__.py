"""Model code of the PyTorch port: layers and the paper CNN."""
