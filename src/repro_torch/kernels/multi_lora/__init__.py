from repro_torch.kernels.multi_lora.ops import (multi_lora,  # noqa: F401
                                                multi_lora_plain)
from repro_torch.kernels.multi_lora.ref import multi_lora_reference  # noqa: F401
