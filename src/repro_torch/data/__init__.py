from repro_torch.data.pipeline import (DataConfig, PrefetchIterator,
                                       SyntheticLM, to_device)

__all__ = ["DataConfig", "SyntheticLM", "PrefetchIterator", "to_device"]
