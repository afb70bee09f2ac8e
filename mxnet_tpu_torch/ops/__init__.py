"""Op library of the port: plain PyTorch around the kernels."""
