from repro_torch.serve.config import (EngineConfig, build_engine,
                                     resolve_page_size)
from repro_torch.serve.kvcache import (NULL_PAGE, BlockAllocator,
                                      ChunkStage, DenseBackend, PagedBackend,
                                      PagedKVCache, PageSpec, PrefixIndex,
                                      bucket_length, copy_page, make_backend)
from repro_torch.serve.scheduler import Request, ServingEngine
from repro_torch.serve.step import (launch_config, make_chunk_step,
                                    make_prefill_step, make_serve_step,
                                    sample, tuned_kernel_configs)

__all__ = ["EngineConfig", "build_engine", "resolve_page_size", "NULL_PAGE",
           "BlockAllocator", "ChunkStage", "DenseBackend", "PagedBackend",
           "PagedKVCache", "PageSpec", "PrefixIndex", "bucket_length",
           "copy_page", "make_backend", "Request", "ServingEngine",
           "make_prefill_step", "make_chunk_step", "make_serve_step",
           "sample", "launch_config", "tuned_kernel_configs"]
