"""Batched serving: prefill + decode with KV and SSM caches."""
from repro_torch.serving.engine import Engine, GenResult, grow_cache, init_cache

__all__ = ["Engine", "GenResult", "grow_cache", "init_cache"]
