"""Ancestor inference: lower the penalty of alignments that match the inferred
common ancestor of duplicated reference regions.

Port of the reference's AncestryDetector (+ QuickVariants SimilarityAnalysis /
OverriddenSequence; AncestryDetector.java): for every duplication with >= 3
copies, walk outward from each copy's center in both directions
simultaneously; at each offset take the majority allele across the copies
whose similarity score is still positive; for copies that are "interested"
(the duplication is the interesting one at their position), write
union(majorityAllele, currentBase) back into an overridden copy of the
reference, up to the best-scoring index of the walk.  The final product is a
new HashBlockDatabase over the overridden forward sequences; alignments are
computed against it and reported against the originals
(AlignerWorker.updateSequenceB).

Scoring (java:426-434): each position scores +dissimilarityThreshold, each
mismatch an additional -1; a walk stops when its cumulative score drops below
zero; walks that reach the midpoint boundary toward a neighboring duplication
get a 3-mismatch bonus (java:247-266).
"""

from __future__ import annotations

import bisect

import numpy as np

from mapper_tpu_torch import basepairs, trace
from mapper_tpu_torch.index.database import HashBlockDatabase
from mapper_tpu_torch.index.duplication import Duplication, DuplicationDetector
from mapper_tpu_torch.sequence import Sequence, SequenceDatabase

NO_ANCESTOR = 0  # Basepairs.encode('-')


class SimilarityAnalysis:
    """QuickVariants SimilarityAnalysis (fields per AncestryDetector usage)."""

    __slots__ = (
        "sequence",
        "start_index",
        "current_index",
        "bound_index",
        "best_index",
        "best_score",
        "cumulative_score",
        "reached_end_of_sequence",
        "has_improved",
    )

    def __init__(self, sequence: Sequence, start_index: int, bound_index: int, initial_score: float):
        self.sequence = sequence
        self.start_index = start_index
        self.current_index = start_index
        self.bound_index = bound_index
        self.cumulative_score = initial_score
        self.best_score = initial_score
        self.best_index = start_index
        self.has_improved = False
        self.reached_end_of_sequence = False

    def add_score(self, delta: float) -> None:
        self.cumulative_score += delta
        if self.cumulative_score > self.best_score:
            self.best_score = self.cumulative_score
            self.best_index = self.current_index
            self.has_improved = True

    def get_reached_end_of_sequence(self) -> bool:
        return self.reached_end_of_sequence


class _Overrides:
    """Sparse overrides for one sequence; double-override is an error
    (OverriddenSequence.java:17-24)."""

    def __init__(self, sequence: Sequence):
        self.sequence = sequence
        self.values: dict[int, int] = {}

    def put(self, index: int, code: int) -> None:
        if index in self.values:
            raise ValueError(
                f"position {index} of {self.sequence.name} overridden twice"
            )
        self.values[index] = code

    def build(self) -> Sequence:
        codes = self.sequence.codes.copy()
        for index, code in self.values.items():
            codes[index] = code
        return Sequence(
            self.sequence.name + "-anc", codes, path=self.sequence.path
        )


class AncestryDetector:
    def __init__(
        self,
        duplication_detector: DuplicationDetector,
        reference: list[Sequence],
        dissimilarity_threshold: float,
        output_path: str | None = None,
        enable_gapmers: bool = True,
        tracer=trace.OFF,
    ):
        self.duplication_detector = duplication_detector
        self.reference = reference
        self.dissimilarity_threshold = dissimilarity_threshold
        self.output_path = output_path
        self.enable_gapmers = enable_gapmers
        # spans of the inference's stages (`ancestry.detect`, `.walk`,
        # `.emit`, `.index`) and counters of its duplications and bases
        self.tracer = tracer
        self.overrides: dict[int, _Overrides] = {
            id(seq): _Overrides(seq) for seq in reference
        }
        self._original_by_override: dict[int, Sequence] = {}
        self._result: HashBlockDatabase | None = None
        # (entries, starts) per sequence: the duplication list is fixed once
        # detection ran, and rebuilding the starts list per neighbor query
        # made the bounds computation O(duplications) per walk
        self._entries_cache: dict[int, tuple] = {}

    # --- ReferenceProvider interface -------------------------------------

    def get_hashblock_database(self) -> HashBlockDatabase:
        if self._result is None:
            self._result = self._union_recent_ancestors()
        return self._result

    def get_enable_gapmers(self) -> bool:
        return self.enable_gapmers

    def get_original_sequence(self, modified: Sequence) -> Sequence:
        original = self._original_by_override.get(id(modified))
        return original if original is not None else modified

    # --- the inference ----------------------------------------------------

    def _union_recent_ancestors(self) -> HashBlockDatabase:
        tracer = self.tracer
        detector = self.duplication_detector
        with tracer.span("ancestry.detect"):
            detector.ensure_detected()
        duplications = detector.get_all()
        # deterministic processing order
        duplications.sort(key=lambda d: (d.length, d.positions))
        with tracer.span("ancestry.walk"):
            for duplication in duplications:
                self._analyze(duplication, -1)
                self._analyze(duplication, 1)
        tracer.count("ancestry.duplications", len(duplications))

        with tracer.span("ancestry.emit"):
            forward_overrides = []
            for seq in self.reference:
                if seq.complemented_from is None:
                    tracer.count("ancestry.bases_widened", len(self.overrides[id(seq)].values))
                    built = self.overrides[id(seq)].build()
                    forward_overrides.append(built)
                    self._original_by_override[id(built)] = seq
            seq_db = SequenceDatabase(forward_overrides, add_reverse_complements=True)
            for built in forward_overrides:
                rc = seq_db.get_reverse_complement(built)
                original = self._original_by_override[id(built)]
                self._original_by_override[id(rc)] = original.reverse_complement()
            if self.output_path is not None:
                from mapper_tpu_torch.io.fastx import FastaWriter

                writer = FastaWriter(self.output_path)
                for built in forward_overrides:
                    writer.write(built)
                writer.close()
        with tracer.span("ancestry.index"):
            return HashBlockDatabase(seq_db, enable_gapmers=self.enable_gapmers)

    def _entries_for(self, sequence: Sequence):
        cached = self._entries_cache.get(id(sequence))
        if cached is None:
            entries = self.duplication_detector.get_interesting_duplications_on_sequence(
                sequence
            )
            cached = (entries, [start for start, _ in entries])
            self._entries_cache[id(sequence)] = cached
        return cached[0]

    def _starts_for(self, sequence: Sequence):
        self._entries_for(sequence)
        return self._entries_cache[id(sequence)][1]

    def _interesting_neighbor(self, entries, starts, index: int, direction: int):
        """getInterestingDuplicationStartingBefore/After (java:353-380):
        nearest entry in the given direction with >= 3 instances."""
        while True:
            if direction < 0:
                i = bisect.bisect_left(starts, index) - 1
            else:
                i = bisect.bisect_right(starts, index)
            if i < 0 or i >= len(entries):
                return None
            start, dup = entries[i]
            if dup.num_instances >= 3:
                return start, dup
            index = start

    def _compute_analysis_bounds(
        self, duplication: Duplication, sequence: Sequence, start_index: int, polarity: int
    ) -> SimilarityAnalysis | None:
        """computeAnalysisBounds (java:382-424)."""
        entries = self._entries_for(sequence)
        starts_list = self._starts_for(sequence)
        middle = start_index + duplication.length // 2
        if polarity > 0:
            initial = middle + 1
            bound = len(sequence)
            neighbor = self._interesting_neighbor(entries, starts_list, start_index, +1)
            if neighbor is not None:
                next_middle = neighbor[0] + neighbor[1].length // 2
                bound = (middle + next_middle) // 2 + 1
        else:
            initial = middle
            bound = -1
            neighbor = self._interesting_neighbor(entries, starts_list, start_index, -1)
            if neighbor is not None:
                prev_middle = neighbor[0] + neighbor[1].length // 2
                bound = (prev_middle + middle) // 2
        analysis = SimilarityAnalysis(
            sequence, initial, bound, self._match_score(duplication.length)
        )
        if (analysis.bound_index - analysis.start_index) * polarity < 0:
            return None
        return analysis

    def _match_score(self, length: int) -> float:
        return self.dissimilarity_threshold * length

    def _mismatch_score(self, length: int) -> float:
        return -length + self._match_score(length)

    def _analyze(self, duplication: Duplication, polarity: int) -> None:
        """The simultaneous outward walk (java:149-337)."""
        if duplication.num_instances < 3:
            return
        seq_db = self.duplication_detector.sequence_database

        available: list[SimilarityAnalysis] = []
        interested: set[int] = set()
        for encoded in duplication.positions:
            sequence, start_index = seq_db.decode_position(encoded)
            analysis = self._compute_analysis_bounds(
                duplication, sequence, start_index, polarity
            )
            if analysis is None:
                continue
            available.append(analysis)
            entries = self._entries_for(sequence)
            starts = self._starts_for(sequence)
            i = bisect.bisect_left(starts, start_index)
            if i < len(entries) and entries[i][0] == start_index and entries[i][1] is duplication:
                interested.add(id(analysis))

        most_popular: list[int] = []
        while interested and len(available) >= 3:
            if self._advance_chunk(available, interested, most_popular, polarity):
                continue
            no_longer_interested: list[SimilarityAnalysis] = []
            no_longer_available: list[SimilarityAnalysis] = []

            for a in available:
                if id(a) in interested and a.current_index == a.bound_index:
                    no_longer_interested.append(a)

            counts: dict[int, int] = {}
            for a in available:
                pos = a.current_index
                if pos < 0 or pos >= len(a.sequence):
                    a.reached_end_of_sequence = True
                    no_longer_available.append(a)
                    if id(a) in interested and a not in no_longer_interested:
                        no_longer_interested.append(a)
                else:
                    code = int(a.sequence.codes[pos])
                    counts[code] = counts.get(code, 0) + 1

            best_count = 0
            most_popular_code = 0
            tie = False
            for code in sorted(counts):
                count = counts[code]
                if count > best_count:
                    best_count = count
                    most_popular_code = code
                    tie = False
                elif count == best_count:
                    tie = True
            if tie:
                most_popular_code = NO_ANCESTOR
            most_popular.append(most_popular_code)

            for a in no_longer_interested:
                reached_neighbor = (not a.get_reached_end_of_sequence()) and a.cumulative_score >= 0
                if reached_neighbor:
                    a.add_score(-self._mismatch_score(3))  # java:262
                if id(a) in interested:
                    interested.discard(id(a))

            for a in no_longer_available:
                if a in available:
                    available.remove(a)

            for a in list(available):
                code = int(a.sequence.codes[a.current_index])
                if code == most_popular_code:
                    a.add_score(self._match_score(1))
                else:
                    a.add_score(self._mismatch_score(1))
                if a.cumulative_score < 0:
                    available.remove(a)
                    if id(a) in interested:
                        interested.discard(id(a))
                        no_longer_interested.append(a)

            for a in available:
                a.current_index += polarity

            # write inferred ancestors for walks that just ended
            for a in no_longer_interested:
                self._write_differences(duplication, a, most_popular, polarity)

    _CHUNK_CAP = 1 << 14

    def _advance_chunk(
        self,
        available: list[SimilarityAnalysis],
        interested: set[int],
        most_popular: list[int],
        polarity: int,
    ) -> bool:
        """Vectorized fast path for the outward walk: while no walker finishes
        (reaches its bound / leaves its sequence) or dies (score < 0), the
        walker set is fixed, so majority votes and score updates for a whole
        stretch of offsets compute as array math with the same float-add order
        as the sequential loop.  Processes the longest event-free stretch and
        returns True, or returns False when the next iteration is an event the
        scalar step must handle."""
        thr = self.dissimilarity_threshold
        # steps until a deterministic event (bound reach for interested
        # walkers at iteration start; sequence exit for any walker)
        t = self._CHUNK_CAP
        for a in available:
            if id(a) in interested:
                t = min(t, (a.bound_index - a.current_index) * polarity)
            if polarity > 0:
                t = min(t, len(a.sequence) - a.current_index)
            else:
                t = min(t, a.current_index + 1)
        if t <= 0:
            return False

        rows = []
        for a in available:
            p = a.current_index
            if polarity > 0:
                rows.append(a.sequence.codes[p : p + t])
            else:
                rows.append(a.sequence.codes[p - t + 1 : p + 1][::-1])
        codes = np.stack(rows).astype(np.int64)  # [W, T]

        # counts[code, t] without np.add.at: bincount over code + 16*column
        flat = codes + 16 * np.arange(t, dtype=np.int64)[None, :]
        counts = np.bincount(flat.ravel(), minlength=16 * t).reshape(t, 16).T
        best_count = counts.max(axis=0)
        pop = counts.argmax(axis=0)  # first max = lowest code, as in the loop
        tie = (counts == best_count[None, :]).sum(axis=0) > 1
        pop = np.where(tie, NO_ANCESTOR, pop)

        delta = np.where(codes == pop[None, :], thr, thr - 1.0)
        # same float-add order as the sequential add_score calls:
        # c_t = (((s0 + d1) + d2) + ...) — cumsum over [s0, d1, d2, ...]
        seeded = np.concatenate(
            (np.array([a.cumulative_score for a in available])[:, None], delta), axis=1
        )
        cum = np.cumsum(seeded, axis=1)[:, 1:]
        # truncate to the event-free prefix: columns at or past the first
        # death must be recomputed by the scalar step with the walker removed
        dead_cols = (cum < 0).any(axis=0)
        if dead_cols.any():
            t = int(np.argmax(dead_cols))
            if t <= 0:
                return False
            cum = cum[:, :t]
            pop = pop[:t]

        for i, a in enumerate(available):
            c = cum[i]
            run_prev = np.maximum.accumulate(np.concatenate(([a.best_score], c)))[:-1]
            improved = c > run_prev
            if improved.any():
                t_last = int(np.nonzero(improved)[0].max())
                a.best_score = float(c[t_last])
                a.best_index = a.current_index + t_last * polarity
                a.has_improved = True
            a.cumulative_score = float(c[-1])
            a.current_index += t * polarity
        most_popular.extend(int(v) for v in pop[:t])
        return True

    def _write_differences(
        self,
        duplication: Duplication,
        analysis: SimilarityAnalysis,
        most_popular: list[int],
        polarity: int,
    ) -> None:
        """java:313-335."""
        if not analysis.has_improved and analysis.best_index == analysis.start_index:
            # the walk never accumulated evidence past its starting point; the
            # write loop below still covers the start position itself
            pass
        for offset in range(len(most_popular)):
            index = analysis.start_index + offset * polarity
            if index == analysis.bound_index:
                break
            ancestor = most_popular[offset]
            here = int(analysis.sequence.codes[index])
            if ancestor != here and ancestor != NO_ANCESTOR:
                union = int(basepairs.union(ancestor, here))
                self.overrides[id(analysis.sequence)].put(index, union)
            if index == analysis.best_index:
                break
