"""sfmx_torch.utils — see the package docstring."""
