"""Architecture configs the port serves + registry."""

from repro_torch.configs.registry import ARCHS, get_config, get_reduced, list_archs  # noqa: F401
