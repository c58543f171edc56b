"""Integrator and autograd: per call, device ms of every kernel that is
not one of the program's own CUDA kernels, in the train cells."""

from portbench.harness.readers import torch_ops_ms as read  # noqa: F401
