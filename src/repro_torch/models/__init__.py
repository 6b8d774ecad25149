from repro_torch.models.registry import Model, build_model
from repro_torch.models.transformer import RuntimeConfig

__all__ = ["Model", "RuntimeConfig", "build_model"]
