from repro_torch.core.device import dtype_of, resolve_device
from repro_torch.core.troop import DEFAULT, LaunchConfig, sublane

__all__ = ["DEFAULT", "LaunchConfig", "dtype_of", "resolve_device", "sublane"]
