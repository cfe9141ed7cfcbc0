"""sfmx_torch.localize — see the package docstring."""
