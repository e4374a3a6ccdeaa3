"""A copy of ``repro.core.plugins``."""
from repro_torch.core.plugins.base import PluginChain, REQUEST_ORDER, RESPONSE_ORDER  # noqa: F401
