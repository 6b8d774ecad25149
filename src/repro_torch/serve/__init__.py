from repro_torch.serve.config import (EngineConfig, build_engine,
                                     resolve_page_size)
from repro_torch.serve.kvcache import (NULL_PAGE, BlockAllocator,
                                      ChunkStage, PagedBackend, PagedKVCache,
                                      PageSpec, PrefixIndex, copy_page)
from repro_torch.serve.scheduler import Request, ServingEngine
from repro_torch.serve.step import (launch_config, make_chunk_step,
                                    make_serve_step, tuned_kernel_configs)

__all__ = ["EngineConfig", "build_engine", "resolve_page_size", "NULL_PAGE",
           "BlockAllocator", "ChunkStage", "PagedBackend", "PagedKVCache",
           "PageSpec", "PrefixIndex", "copy_page", "Request", "ServingEngine",
           "make_chunk_step", "make_serve_step", "launch_config",
           "tuned_kernel_configs"]
