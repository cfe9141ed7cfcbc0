"""sfmx_torch.recon — see the package docstring."""
