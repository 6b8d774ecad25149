from repro_torch.core.device import dtype_of, resolve_device
from repro_torch.core.troop import (BASELINE, DEFAULT, TROOP, LaunchConfig,
                                    sublane)

__all__ = ["BASELINE", "DEFAULT", "LaunchConfig", "TROOP", "dtype_of",
           "resolve_device", "sublane"]
