from repro_torch.serve.config import (EngineConfig, build_engine,
                                     resolve_page_size)
from repro_torch.serve.kvcache import (NULL_PAGE, BlockAllocator,
                                      ChunkStage, PagedBackend, PagedKVCache,
                                      PageSpec, PrefixIndex, copy_page)
from repro_torch.serve.scheduler import Request, ServingEngine
from repro_torch.serve.step import make_chunk_step, make_serve_step

__all__ = ["EngineConfig", "build_engine", "resolve_page_size", "NULL_PAGE",
           "BlockAllocator", "ChunkStage", "PagedBackend", "PagedKVCache",
           "PageSpec", "PrefixIndex", "copy_page", "Request", "ServingEngine",
           "make_chunk_step", "make_serve_step"]
