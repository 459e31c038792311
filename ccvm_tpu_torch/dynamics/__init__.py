"""SDE dynamics on PyTorch tensors (the plain versions of the kernels)."""
