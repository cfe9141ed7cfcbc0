"""sfmx_torch.mapstore — see the package docstring."""
