"""sfmx_torch.localize — see the package docstring."""
from .localize import (LocalizationMap, build_localization_map,  # noqa: F401
                       localize_batch, localize_query,
                       localize_batch_streaming, localize_query_streaming)
from . import fusion  # noqa: F401
