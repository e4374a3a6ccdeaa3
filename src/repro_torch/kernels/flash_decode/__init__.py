from repro_torch.kernels.flash_decode.ops import (flash_decode,  # noqa: F401
                                                 flash_decode_plain,
                                                 gather_kv,
                                                 paged_flash_decode,
                                                 paged_flash_decode_mla,
                                                 paged_flash_decode_mla_plain,
                                                 paged_flash_decode_plain,
                                                 paged_flash_verify,
                                                 paged_flash_verify_mla,
                                                 paged_flash_verify_mla_plain,
                                                 paged_flash_verify_plain)
from repro_torch.kernels.flash_decode.ref import (decode_reference,  # noqa: F401
                                                  paged_decode_reference,
                                                  paged_mla_decode_reference,
                                                  paged_mla_verify_reference,
                                                  paged_verify_reference)
