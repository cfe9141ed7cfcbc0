"""sfmx_torch.serve — see the package docstring."""
from .server import LocalizationService, make_app  # noqa: F401
