"""sfmx_torch.cli — see the package docstring."""
