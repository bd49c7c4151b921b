"""Result cache for the continuous mining service — repeated queries on
unchanged data are free.  Pure Python: the port keeps its own copy of the
JAX package's ``repro.runtime.cache``, with the same keys and accounting.

The serving layer's cache contract is VERSIONED: every completed mining
result is keyed by ``(dataset_version, app, params)``, where
``dataset_version`` is bumped by every append to the dataset.  A repeat
query against unchanged data hits; ANY data change produces a new
version and therefore a guaranteed miss — the cache can never serve a
stale result across an append, by key construction rather than by
invalidation bookkeeping (there is nothing to forget to invalidate).

``params`` is canonicalized (``params_key``) so dict ordering and
list/tuple spelling differences cannot split logically-identical
requests across cache entries — the same canonical key is what the
service uses to COALESCE concurrent identical requests into one
execution before the cache is even consulted.

Hit/miss/eviction accounting is first-class (``CacheStats``): the
service ledgers it per run and the CLI's ``--check`` gates on it.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any


def params_key(params: dict | None) -> tuple:
    """Canonical, hashable form of a request's params dict: keys sorted,
    unhashable containers (lists/dicts/sets) converted to deterministic
    tuples.  Logically identical params map to the same key regardless
    of spelling — the coalescing and cache-keying contract.

    Total over JSON-ish values, including non-finite floats: ``inf`` and
    ``-inf`` pass through (they compare equal to themselves), and every
    ``nan`` canonicalizes to the one ``math.nan`` object (``nan != nan``
    would otherwise split logically-identical params into distinct
    keys).  The service rejects non-finite params at submit; totality
    here is the backstop that keeps a malformed key from ever crashing
    the dispatch loop."""
    return _canon(params or {})


def _canon(v: Any) -> Any:
    if isinstance(v, dict):
        return tuple((str(k), _canon(v[k])) for k in sorted(v, key=str))
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return tuple(sorted((_canon(x) for x in v), key=repr))
    if isinstance(v, float):
        # int(v) raises on inf/nan (OverflowError / ValueError), so the
        # integral-float normalization must only see finite values
        if math.isnan(v):
            return math.nan  # the ONE nan object — identity makes keys equal
        if math.isinf(v):
            return v
        if v == int(v):
            # 0.1*3 style floats stay floats; clean integral floats
            # normalize so params={"k": 3.0} and {"k": 3} share an entry
            return int(v)
    return v


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    puts: int = 0

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class ResultCache:
    """LRU cache of completed mining results keyed by
    ``(dataset_name, dataset_version, app, params_key)``.

    ``capacity`` bounds the entry count (None = unbounded); eviction is
    least-recently-USED (a hit refreshes recency), so the hot repeated
    queries the serving layer exists for stay resident while one-off
    historical-version results age out first.
    """

    def __init__(self, capacity: int | None = 256):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None, got {capacity}")
        self.capacity = capacity
        self.stats = CacheStats()
        self._entries: OrderedDict[tuple, Any] = OrderedDict()

    @staticmethod
    def key(dataset: str, version: int, app: str, params: dict | None) -> tuple:
        return (str(dataset), int(version), str(app), params_key(params))

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        return key in self._entries  # no stats side effect

    def get(self, key: tuple) -> Any | None:
        """The cached result, refreshed to most-recent, or None (ledgered
        as a miss — only call when actually attempting to serve)."""
        if key in self._entries:
            self.stats.hits += 1
            self._entries.move_to_end(key)
            return self._entries[key]
        self.stats.misses += 1
        return None

    def put(self, key: tuple, value: Any) -> None:
        self._entries[key] = value
        self._entries.move_to_end(key)
        self.stats.puts += 1
        if self.capacity is not None:
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
