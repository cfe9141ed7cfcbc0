"""sfmx_torch.serve — see the package docstring."""
from .router import MapShardRouter, split_localization_map  # noqa: F401
from .server import LocalizationService, make_app  # noqa: F401
