from repro_torch.sharding.ctx import (constrain, current_rules,  # noqa: F401
                                      sharding_rules)
