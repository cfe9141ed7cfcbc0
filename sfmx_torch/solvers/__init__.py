"""sfmx_torch.solvers — see the package docstring."""
