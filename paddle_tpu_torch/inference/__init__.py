"""Serving: paged KV cache, continuous-batching scheduler, ragged paged
attention and the ServingEngine."""
from .engine import ServingEngine  # noqa: F401
from .kv_cache import (BlockAllocator, PagedKVCache,  # noqa: F401
                       PagedLayerCache)
from .paged_attention import (  # noqa: F401
    paged_attention, paged_attention_cuda, paged_attention_reference)

__all__ = ["ServingEngine", "BlockAllocator", "PagedKVCache",
           "PagedLayerCache", "paged_attention", "paged_attention_cuda",
           "paged_attention_reference"]
