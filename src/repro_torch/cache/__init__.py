"""Paged block pool + two-tier (HBM/host) KV cache under ECI management."""
from repro_torch.cache.block_pool import BlockPool, PageMeta
from repro_torch.cache.tiered import TieredKVCache, TierStats

__all__ = ["BlockPool", "PageMeta", "TieredKVCache", "TierStats"]
