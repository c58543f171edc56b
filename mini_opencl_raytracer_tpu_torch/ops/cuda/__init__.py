"""Hand-written CUDA kernels: build, bindings, wrappers and plain versions."""
