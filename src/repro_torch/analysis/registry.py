"""The ``@warm_cache`` registry: declared key/read contracts for every
bounded warm cache on the hot path.

A cache whose key fingerprints less than the cached computation reads
serves stale results.  Every warm cache therefore decorates its accessor
with the fields its key is built from (``key``), the additional fields
the cached computation reads (``reads``), and the justification map tying
each read to the key component that pins it (``covers``).  A static
checker can then read the decorated body: an attribute read on a
cache-relevant argument that is neither a key component, a declared read,
nor ambient state scoped to the cache's own lifetime is a finding.  The
port carries the declarations; the checker itself is not ported yet.

This module is imported by hot-path runtime code (compile/, serverless/)
and therefore has **no package-internal imports** (no cycle risk) and no
runtime cost beyond attaching metadata.  It is a copy of the JAX
package's ``analysis/registry.py``: the same specs, field for field.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Sequence, Tuple, TypeVar

F = TypeVar("F", bound=Callable)


@dataclass(frozen=True)
class WarmCacheSpec:
    """Declared caching contract of one warm cache accessor.

    ``key``     dotted parameter paths the cache key is computed from
                (e.g. ``"req.work_key"``, ``"n_pad"``).
    ``reads``   parameter paths the cached computation reads that are
                NOT key components — each must be covered below.
    ``covers``  key path -> read paths it pins, with the justification
                recorded where the declaration lives (code comment).
    ``ambient`` paths (or whole roots like ``"self"``) exempt from the
                coverage check because the cache dict itself is scoped
                to that object's lifetime — e.g. a per-instance program
                cache may read instance configuration freely.
    """
    name: str
    key: Tuple[str, ...]
    reads: Tuple[str, ...] = ()
    covers: Mapping[str, Tuple[str, ...]] = field(default_factory=dict)
    ambient: Tuple[str, ...] = ()
    module: str = ""
    qualname: str = ""


#: runtime registry (introspection / docs); the static pass re-derives
#: the same specs from source so mutation tests can audit unimported
#: file trees.
REGISTRY: Dict[str, WarmCacheSpec] = {}


def warm_cache(*, name: str, key: Sequence[str],
               reads: Sequence[str] = (),
               covers: Mapping[str, Sequence[str]] | None = None,
               ambient: Sequence[str] = ()) -> Callable[[F], F]:
    """Register a warm-cache accessor's caching contract (metadata only —
    the wrapped function is returned unchanged)."""
    def deco(fn: F) -> F:
        spec = WarmCacheSpec(
            name=name, key=tuple(key), reads=tuple(reads),
            covers={k: tuple(v) for k, v in (covers or {}).items()},
            ambient=tuple(ambient),
            module=getattr(fn, "__module__", ""),
            qualname=getattr(fn, "__qualname__", ""))
        REGISTRY[name] = spec
        fn.__warm_cache__ = spec  # type: ignore[attr-defined]
        return fn
    return deco
