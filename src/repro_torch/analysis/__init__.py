"""Static-analysis support of the port: the ``@warm_cache`` registry
(``registry.py``) that every bounded warm cache declares its key and
reads in."""
from repro_torch.analysis.registry import REGISTRY, WarmCacheSpec, warm_cache

__all__ = ["warm_cache", "WarmCacheSpec", "REGISTRY"]
