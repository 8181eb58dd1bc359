"""Hand-written CUDA kernels: build, wrappers, plain versions."""
