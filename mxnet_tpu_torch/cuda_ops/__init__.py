"""Hand-written Hopper kernels of the port, one module per TPU kernel
file, each with its plain PyTorch version beside it (used for CPU
tensors only) and a `launches` counter. Sources are under `csrc/`;
`_build` compiles them with nvcc at first use."""
