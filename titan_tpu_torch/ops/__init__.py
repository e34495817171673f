"""Device ops of the PyTorch port: forces, integrators, step, fused kernel."""
