from repro_torch.kernels.flash_attention.ops import (flash_attention,  # noqa: F401
                                                    flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: F401
