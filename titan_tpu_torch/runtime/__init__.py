"""Control plane of the PyTorch port."""
