"""Static-analysis support of the port: the ``@warm_cache`` registry
(``registry.py``) that every bounded warm cache declares its key and
reads in, and the async drain protocol as a checked table
(``protocol.py``, with ``astutil.py`` and ``report.py``), whose runtime
half is ``serverless/sanitize.py``."""
from repro_torch.analysis.registry import REGISTRY, WarmCacheSpec, warm_cache

__all__ = ["warm_cache", "WarmCacheSpec", "REGISTRY"]
