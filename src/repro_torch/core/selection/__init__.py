"""A copy of ``repro.core.selection``."""
from repro_torch.core.selection.algorithms import (  # noqa: F401
    ALGORITHMS, SelectionContext, get_algorithm, select_many)
from repro_torch.core.selection.remom import ReMoM  # noqa: F401
