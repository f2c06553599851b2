"""Thread-safe, size-bounded, hit/miss-counted result store.

One cache class for every memoized *result* in the repo: the DSE service's
per-row mapper results and the flexion estimators' workload-agnostic C_X
reference fractions both live in :class:`ResultCache` instances.  It
generalizes the process-wide ``_REF_CACHE`` dict that ``flexion_batched``
used to carry:

  * **thread-safe** — every operation holds one re-entrant lock, so
    concurrent service clients (or concurrent flexion campaigns) can never
    observe a half-written entry.  Writers use *merge* (setdefault)
    semantics: the first stored value wins and every caller gets the stored
    value back, so two racing computations of the same deterministic result
    agree on which object is canonical.
  * **size-bounded** — least-recently-used eviction at ``maxsize`` entries;
    the cache can sit in a long-lived server without growing monotonically.
  * **hit/miss-counted** — ``stats()`` reports hits, misses, evictions and
    occupancy; the DSE service's cache-stats report is built from these.
  * **paired entries** — ``get_pair``/``merge_pair`` read and write two keys
    atomically (both-or-none), for results that are only meaningful
    together (the flexion soft/hard reference fractions: observing one half
    of the pair was exactly the PR 7 race).
  * **persistent** — ``save``/``load`` pickle the entries, so a service
    restart can come back warm (keys and values must be picklable; the
    mapper row keys — frozen dataclass specs, tuples — and ``RowResult``
    values are).

Values are treated as immutable once stored: callers share the cached
object, never copy it (the bit-parity contract means a cached result is
indistinguishable from a recomputed one).
"""
from __future__ import annotations

import os
import pickle
import threading
from collections import OrderedDict
from typing import Any, Dict, Hashable, Iterable, Optional, Tuple

_MISS = object()


class ResultCache:
    """LRU-bounded ``key -> result`` store with merge-on-write semantics."""

    def __init__(self, maxsize: int = 65536):
        if maxsize < 2:
            # pairs must be able to coexist, and a 1-entry "cache" would
            # silently thrash every pair write
            raise ValueError(f"maxsize must be >= 2, got {maxsize}")
        self.maxsize = int(maxsize)
        self._lock = threading.RLock()
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    # -- core ops -----------------------------------------------------------

    def get(self, key: Hashable, default: Any = None) -> Any:
        """Counted lookup: a hit refreshes the entry's LRU position."""
        with self._lock:
            value = self._data.get(key, _MISS)
            if value is _MISS:
                self._misses += 1
                return default
            self._data.move_to_end(key)
            self._hits += 1
            return value

    def contains(self, key: Hashable) -> bool:
        """Uncounted membership probe (no LRU touch) — for bookkeeping
        around a later counted ``get``/``merge`` of the same key."""
        with self._lock:
            return key in self._data

    def merge(self, key: Hashable, value: Any) -> Any:
        """Insert unless present (setdefault); returns the stored value.

        The first writer wins — under the bit-parity contract both writers
        hold equal results, so which object survives is unobservable, but a
        single canonical object keeps downstream identity checks sane."""
        with self._lock:
            held = self._data.get(key, _MISS)
            if held is not _MISS:
                self._data.move_to_end(key)
                return held
            self._data[key] = value
            self._shrink()
            return value

    def put(self, key: Hashable, value: Any) -> None:
        """Unconditional insert/overwrite."""
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            self._shrink()

    # -- paired entries -----------------------------------------------------

    def get_pair(self, key_a: Hashable, key_b: Hashable
                 ) -> Optional[Tuple[Any, Any]]:
        """Both values or ``None`` — never one half of a pair.  Counted as
        ONE hit or miss (a pair is one logical result)."""
        with self._lock:
            a = self._data.get(key_a, _MISS)
            b = self._data.get(key_b, _MISS)
            if a is _MISS or b is _MISS:
                self._misses += 1
                return None
            self._data.move_to_end(key_a)
            self._data.move_to_end(key_b)
            self._hits += 1
            return a, b

    def merge_pair(self, key_a: Hashable, value_a: Any,
                   key_b: Hashable, value_b: Any) -> Tuple[Any, Any]:
        """Atomically merge both halves; returns the stored pair.  If a
        previous pair write half-survived eviction, the stale half is
        overwritten so the pair is consistent again."""
        with self._lock:
            have_a = key_a in self._data
            have_b = key_b in self._data
            if not (have_a and have_b):
                self._data[key_a] = value_a
                self._data[key_b] = value_b
            self._data.move_to_end(key_a)
            self._data.move_to_end(key_b)
            self._shrink()
            return self._data[key_a], self._data[key_b]

    # -- maintenance --------------------------------------------------------

    def _shrink(self) -> None:
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)
            self._evictions += 1

    def clear(self) -> None:
        """Drop every entry AND reset the counters (a cleared cache reports
        cold stats, matching ``clear_flexion_reference_cache`` semantics)."""
        with self._lock:
            self._data.clear()
            self._hits = 0
            self._misses = 0
            self._evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions, "size": len(self._data),
                    "maxsize": self.maxsize}

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> int:
        """Pickle the entries (not the counters) to ``path``; returns the
        entry count — a warm restart for a long-lived service.

        The write is atomic (temp file in the same directory, then
        ``os.replace``): a crash mid-save — a killed service, a full disk —
        leaves the previous complete snapshot in place instead of a
        truncated pickle that poisons the next service start."""
        with self._lock:
            items = list(self._data.items())
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(items, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return len(items)

    def load(self, path: str) -> int:
        """Merge entries pickled by :meth:`save`; existing (newer) entries
        win.  Returns the number of entries read."""
        with open(path, "rb") as f:
            items: Iterable[Tuple[Hashable, Any]] = pickle.load(f)
        n = 0
        with self._lock:
            for key, value in items:
                self._data.setdefault(key, value)
                n += 1
            self._shrink()
        return n
