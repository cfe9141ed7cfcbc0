"""sfmx_torch.kernels — see the package docstring."""
