from repro_torch.core.signals.base import SignalEngine  # noqa: F401
from repro_torch.core.signals.plan import SignalPlan  # noqa: F401
