"""Fixed-capacity caches for the serving engine.

Two structures back ``serve.CommunityServer``:

  * ``LRUCache`` — a fixed-capacity ordered map with optional
    frequency-based ("Zipf-aware") admission: under a heavy-tailed request
    stream plain LRU lets a burst of cold keys evict the hot head, so the
    cache tracks an aged frequency sketch (``FrequencySketch``, the
    TinyLFU idea) and refuses to evict a victim that is strictly hotter
    than the candidate.
  * ``CacheStats`` — the counters the benchmark and the CI guards report
    (hit rate, evictions, admission rejections, invalidations).

Host-side and value-agnostic: the engine stores device tensors, the tests
store ints.  The port's copy of ``repro.serve.cache``, line for line, so
both engines make the same cache decisions on the same request stream.
Invariants (pinned by tests/test_torch_serve.py): size never exceeds
capacity, ``get`` refreshes recency, eviction takes the least-recently-used
key, and admission never swaps a strictly hotter victim for a colder
candidate.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    rejections: int = 0       # inserts refused by admission
    invalidations: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "rejections": self.rejections,
                "invalidations": self.invalidations,
                "hit_rate": round(self.hit_rate, 4)}

    def reset(self) -> None:
        self.hits = self.misses = self.evictions = 0
        self.rejections = self.invalidations = 0


class FrequencySketch:
    """Aged access-frequency estimator (TinyLFU-style).

    Exact counts with periodic halving: after every ``sample`` touches all
    counts are halved (zeros dropped), so estimates track the *recent*
    popularity distribution rather than all of history — a key that was
    hot an hour ago decays instead of squatting on its admission
    privilege.
    """

    def __init__(self, sample: int = 1024):
        if sample <= 0:
            raise ValueError(f"sample must be positive, got {sample}")
        self.sample = int(sample)
        self._counts: dict[Hashable, int] = {}
        self._touches = 0

    def touch(self, key: Hashable) -> None:
        self._counts[key] = self._counts.get(key, 0) + 1
        self._touches += 1
        if self._touches >= self.sample:
            self._age()

    def _age(self) -> None:
        self._counts = {k: c // 2 for k, c in self._counts.items()
                        if c // 2 > 0}
        self._touches = 0

    def estimate(self, key: Hashable) -> int:
        return self._counts.get(key, 0)


class LRUCache:
    """Fixed-capacity LRU map with optional frequency admission.

    ``admission="lru"`` is plain LRU (every insert admitted, LRU key
    evicted).  ``admission="zipf"`` consults the frequency sketch on a
    full cache: the candidate is admitted only if its estimated frequency
    is at least the LRU victim's — under a Zipf stream this keeps the hot
    head resident through bursts of one-off cold keys.  ``capacity=0``
    disables the cache (every get misses, every put is refused) — the
    engine's cache-disabled baseline.
    """

    def __init__(self, capacity: int, admission: str = "lru",
                 sample: int = 1024):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        if admission not in ("lru", "zipf"):
            raise ValueError(f"unknown admission {admission!r}; "
                             f"expected 'lru' or 'zipf'")
        self.capacity = int(capacity)
        self.admission = admission
        self.stats = CacheStats()
        self._data: OrderedDict[Hashable, Any] = OrderedDict()
        self._sketch = FrequencySketch(sample) if admission == "zipf" \
            else None

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        """Presence probe — touches neither recency nor stats."""
        return key in self._data

    def keys(self) -> list:
        """Keys in eviction order (least recently used first)."""
        return list(self._data)

    def get(self, key: Hashable) -> Optional[Any]:
        """Lookup; refreshes recency and feeds the admission sketch."""
        if self._sketch is not None:
            self._sketch.touch(key)
        if key in self._data:
            self._data.move_to_end(key)
            self.stats.hits += 1
            return self._data[key]
        self.stats.misses += 1
        return None

    def put(self, key: Hashable, value: Any) -> bool:
        """Insert/overwrite; returns True when the entry was admitted."""
        if key in self._data:
            self._data[key] = value
            self._data.move_to_end(key)
            return True
        if self.capacity == 0:
            self.stats.rejections += 1
            return False
        if len(self._data) >= self.capacity:
            victim = next(iter(self._data))
            if self._sketch is not None and \
                    self._sketch.estimate(key) < self._sketch.estimate(victim):
                self.stats.rejections += 1
                return False
            self._data.popitem(last=False)
            self.stats.evictions += 1
        self._data[key] = value
        return True

    def invalidate(self, key: Hashable) -> bool:
        """Drop one entry; True when it was present."""
        if key in self._data:
            del self._data[key]
            self.stats.invalidations += 1
            return True
        return False

    def invalidate_where(self, pred: Callable[[Hashable], bool]) -> list:
        """Drop every entry whose key satisfies ``pred``; returns them."""
        doomed = [k for k in self._data if pred(k)]
        for k in doomed:
            self.invalidate(k)
        return doomed

    def clear(self) -> None:
        self.stats.invalidations += len(self._data)
        self._data.clear()
