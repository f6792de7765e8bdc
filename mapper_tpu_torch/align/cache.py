"""Alignment result cache (reference: AlignmentCache.java + the adaptive
enabling policy of AlignerWorker.updateNumHashCodesToCache,
AlignerWorker.java:129-155).

Identical reads are common in high-depth sequencing; caching by content hash
dedups their alignment work.  The cache self-tunes: if it rarely hits, only a
fraction of queries (selected by content hash) are stored."""

from __future__ import annotations


class AlignmentCache:
    def __init__(self):
        self.entries: dict[int, object] = {}
        self.num_hits = 0
        self.num_skips = 0

    def get(self, key: int):
        return self.entries.get(key)

    def add(self, key: int, value) -> None:
        self.entries[key] = value

    def get_usage(self) -> int:
        return len(self.entries)

    def add_hits_and_skips(self, hits: int, skips: int) -> None:
        self.num_hits += hits
        self.num_skips += skips

    def choose_enable_fraction(self, batch_size: int) -> float:
        """The adaptive cache-enable fraction (AlignerWorker.java:129-155)."""
        hits = float(self.num_hits)
        skips = float(self.num_skips)
        saved = float(self.get_usage())
        estimated_new_saved = saved + batch_size ** (1.0 / 3.0)
        target = (hits * hits + 1.0) / (estimated_new_saved * estimated_new_saved + 1.0)
        historic = max(saved, 1.0) / max(saved + hits + skips, 1.0)
        fraction = target * (target / historic)
        return min(fraction, 1.0)
