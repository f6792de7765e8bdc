"""The per-query alignment driver.

Faithful port of the reference's AlignerWorker search strategy
(AlignerWorker.java:256-644):

1. optimistic phase: take the best-voted candidate, align it, and accept
   immediately when the duplication-window proof shows no similar region could
   align better (quicklyConfidentInBestAlignment, java:494-587);
2. proof loop: raise the candidate-mismatch bound until the optimistic
   alignment is proven best (java:357-391);
3. priority loop: align candidates in order of distinct mismatched hashblocks
   until the penalty lower bound exceeds the best found + Max_PenaltySpan
   (java:399-450);
4. paired fallback: pair a well-supported mate with all positions of the
   unsupported mate (java:452-467), then contig-edge rescue with a spacing
   penalty (getUnpairedAlignments, java:602-644);
5. MaxNumMatches rejection (java:476-481).
"""

from __future__ import annotations

import math
import time

from mapper_tpu_torch.align.blocks import QueryAlignment, QueryAlignments
from mapper_tpu_torch.align.cache import AlignmentCache
from mapper_tpu_torch.align.candidates import (
    CountingHashBlockPath,
    NativeCountingPath,
    PathsCounter,
    QueryMatch,
)
from mapper_tpu_torch.align.query import Query
from mapper_tpu_torch.align.query_aligner import QueryMatchAligner

_INT_MAX = 2**31 - 1


class WorkerStatistics:
    def __init__(self):
        self.num_queries = 0
        self.num_immediately_accepted = 0
        self.num_cache_hits = 0
        self.num_cache_skips = 0
        self.num_indels = 0
        # slowest single query seen so far (reference: AlignerWorker.java:58-71
        # per-worker timers reported at end of run)
        self.slowest_query_name = None
        self.slowest_query_seconds = 0.0
        self.slowest_query_num_alignments = 0
        # "Query at random moment" sampling (RandomMomentSelector.java:13-27,
        # AlignerWorker.java:207, reported at Mapper.java:835-837)
        from mapper_tpu_torch.stats import RandomMomentSelector

        self.random_moment = RandomMomentSelector()
        self.query_at_random_moment = None

    def record_query_time(self, name: str, seconds: float, num_alignments: int) -> None:
        if seconds > self.slowest_query_seconds:
            self.slowest_query_seconds = seconds
            self.slowest_query_name = name
            self.slowest_query_num_alignments = num_alignments


class AlignerWorker:
    def __init__(
        self,
        reference_index,
        parameters,
        listeners: list | None = None,
        cache: AlignmentCache | None = None,
        logger=None,
    ):
        self.set_logger(logger)
        self.reference_index = reference_index
        self.database = reference_index.hashblock_database
        self.duplication_detector = reference_index.duplication_detector
        self.sequence_database = self.database.get_sequence_database()
        self.parameters = parameters
        self.listeners = listeners if listeners is not None else []
        self.cache = cache
        self.shortest_hashblock_length = self.database.get_min_interesting_size()
        self.stats = WorkerStatistics()
        self.cache_enable_fraction = 1.0

    def set_logger(self, logger) -> None:
        """Scoped verbose tracing (AlignerWorker.setLogger, java:36-40): the
        detail logger is one scope deeper, so it only speaks at
        --verbose-alignment verbosity."""
        from mapper_tpu_torch.logging import NO_OP_LOGGER

        self.logger = logger if logger is not None else NO_OP_LOGGER
        self.detailed_logger = self.logger.increment_scope()

    # --- batch processing ---------------------------------------------------

    def before_batch(self, batch_size: int) -> None:
        if self.cache is not None:
            self.cache_enable_fraction = self.cache.choose_enable_fraction(batch_size)
            if self.logger.get_enabled():
                self.logger.log(
                    f"Num cache entries = {self.cache.get_usage()}, num queries = "
                    f"{batch_size}; cache enabled fraction = {self.cache_enable_fraction}"
                )

    def process_batch(
        self, queries: list[Query], notify: bool = True
    ) -> list[QueryAlignments]:
        self.before_batch(len(queries))
        hits0 = self.stats.num_cache_hits
        skips0 = self.stats.num_cache_skips
        results = []
        for query in queries:
            results.append(self.align(query))
        if self.cache is not None:
            # feed the adaptive formula (AlignerWorker.afterBatch semantics:
            # the cache's own hit/skip counters drive chooseEnableFraction)
            self.cache.add_hits_and_skips(
                self.stats.num_cache_hits - hits0,
                self.stats.num_cache_skips - skips0,
            )
        if notify:
            self.send_results(results)
        return results

    def send_results(self, results: list[QueryAlignments]) -> None:
        for listener in self.listeners:
            listener.add_alignments(results)

    # --- single-query path --------------------------------------------------

    def align(self, query: Query) -> QueryAlignments:
        self.stats.num_queries += 1
        if self.stats.random_moment.select(time.time()):
            self.stats.query_at_random_moment = query
        t0 = time.monotonic()
        result = self._check_cache_and_align(query)
        num_alignments = sum(len(c) for c in result.get_alignments())
        self.stats.record_query_time(
            query.get_sequence(0).name, time.monotonic() - t0, num_alignments
        )
        for component in result.get_alignments():
            num_indels = 0
            for option in component:
                for seq_alignment in option.get_components():
                    num_indels = max(num_indels, seq_alignment.count_num_indels())
            self.stats.num_indels += num_indels
        return result

    def _check_cache_and_align(self, query: Query) -> QueryAlignments:
        if self.cache is None:
            return self.align_without_cache(query)
        key = query.content_hash()
        cached = self.cache.get(key)
        if cached is not None and cached.get_num_components() == 1:
            self.stats.num_cache_hits += 1
            if self.logger.get_enabled():
                self.logger.log("reusing cached result")
            new_component = [
                option.with_query(query.get_sequences())
                for option in cached.get_first_alignments()
            ]
            return QueryAlignments.single_component(query.get_sequences(), new_component)
        result = self.align_without_cache(query)
        # adaptive store: only a hash-selected fraction is cached (java:282-289)
        normalized = (key % (1 << 32)) / float(1 << 32)
        if normalized <= self.cache_enable_fraction:
            self.cache.add(key, result)
        else:
            self.stats.num_cache_skips += 1
        return result

    def align_without_cache(self, query: Query) -> QueryAlignments:
        results = self._align_to_ancestral_reference(query)
        for sub in results.get_alignments():
            for alignment in sub:
                self._update_sequence_b(alignment)
        return results

    def _update_sequence_b(self, alignment: QueryAlignment) -> None:
        computed = alignment.get_sequence_b()
        original = self.reference_index.get_original_sequence(computed)
        if original is not computed:
            alignment.put_sequence_b(original)

    def _align_to_ancestral_reference(self, query: Query) -> QueryAlignments:
        logger = self.logger
        if logger.get_enabled():
            logger.log(
                f"Aligning query {query.format()} ({query.get_length()}bp, "
                f"{query.get_num_sequences()} component(s))"
            )
        params = self.parameters
        max_interesting = query.get_length() * params.max_error_rate
        max_inner_distance = int(
            max_interesting * query.get_spacing_deviation_per_unit_penalty()
            + query.get_expected_inner_distance()
        )

        components = []
        for i in range(query.get_num_sequences()):
            seq = query.get_sequence(i)
            if i > 0:
                seq = seq.reverse_complement()
            name = f"seq{i + 1}" if query.get_num_sequences() > 1 else "seq"
            # native counter state machine when available (counting.cpp);
            # degrades to the Python machinery inside the class
            components.append(NativeCountingPath(self.database, seq, params, name))
        path = PathsCounter(
            components, int(query.get_expected_inner_distance()), max_inner_distance
        )

        aligner = QueryMatchAligner(query, params, self.reference_index)
        optimistic_best_alignment = None
        optimistic_best_match = None

        best_matches = path.optimistic_get_best_matches()
        if len(best_matches) == 1:
            optimistic_best_match = best_matches[0]
            optimistic_best_alignment = aligner.align(optimistic_best_match)
            if logger.get_enabled():
                if optimistic_best_alignment is not None:
                    logger.log(
                        "Optimistic best alignment at "
                        f"{optimistic_best_match.summarize_position_b()} with penalty "
                        f"{optimistic_best_alignment.get_penalty()}"
                    )
                else:
                    logger.log(
                        "Optimistic best match at "
                        f"{optimistic_best_match.summarize_position_b()} but couldn't align"
                    )
            if self._quickly_confident(optimistic_best_alignment, optimistic_best_match):
                self.stats.num_immediately_accepted += 1
                if logger.get_enabled():
                    logger.log(
                        "Accepting optimistic alignment immediately (no duplication in range)"
                    )
                return QueryAlignments.single_choice(optimistic_best_alignment)

        num_mismatches = 0
        if optimistic_best_alignment is not None:
            # proof loop (java:357-391)
            while True:
                possible = self._penalty_lower_bound(num_mismatches)
                if (
                    possible
                    > optimistic_best_alignment.get_penalty() + params.max_penalty_span
                ):
                    self.stats.num_immediately_accepted += 1
                    if logger.get_enabled():
                        logger.log(
                            f"Accepting optimistic alignment: {num_mismatches} distinct "
                            f"mismatched blocks implies penalty >= {possible}"
                        )
                    return QueryAlignments.single_choice(optimistic_best_alignment)
                if self.detailed_logger.get_enabled():
                    self.detailed_logger.log(
                        "cannot prove optimistic alignment is best yet: penalty could be "
                        f"{possible} for {num_mismatches} distinct mismatched blocks"
                    )
                matches = path.find_good_positions_having_priority(num_mismatches)
                num_mismatches += 1
                done = False
                for match in matches:
                    if not optimistic_best_match.same_position(match):
                        done = True
                        break
                if done:
                    break

        # priority loop (java:396-450)
        best_penalty = float(_INT_MAX)
        candidate_num_mismatches = 0
        while True:
            estimated = self._penalty_lower_bound(candidate_num_mismatches)
            if estimated > best_penalty + params.max_penalty_span:
                if logger.get_enabled():
                    logger.log(
                        f"Done checking alignment positions: {candidate_num_mismatches} "
                        f"mismatches implies penalty {estimated} which is more than "
                        f"bestPenalty {best_penalty}"
                    )
                break
            if candidate_num_mismatches > path.get_num_blocks():
                if logger.get_enabled():
                    logger.log(
                        "Done checking alignment positions: candidateNumMismatches = "
                        f"{candidate_num_mismatches}, path.getNumBlocks() = "
                        f"{path.get_num_blocks()}"
                    )
                break
            candidates = path.find_good_positions_having_priority(candidate_num_mismatches)
            if self.detailed_logger.get_enabled() and candidates:
                self.detailed_logger.log(
                    f"priority {candidate_num_mismatches}: checking "
                    f"{len(candidates)} candidate position(s)"
                )
            for match in candidates:
                if optimistic_best_match is not None and match.same_position(
                    optimistic_best_match
                ):
                    alignment = optimistic_best_alignment
                else:
                    alignment = aligner.align(match)
                if alignment is not None:
                    best_penalty = min(best_penalty, alignment.get_penalty())
            if estimated >= max_interesting:
                break
            candidate_num_mismatches += 1

        # paired fallback (java:452-467)
        if len(aligner.get_best_alignments()) < 1 and query.get_num_sequences() > 1:
            for match in path.find_partially_good_positions():
                alignment = aligner.align(match)
                if alignment is not None:
                    best_penalty = min(best_penalty, alignment.get_penalty())

        best_alignments = aligner.get_best_alignments()
        if logger.get_enabled():
            if best_alignments:
                logger.log(
                    f"Found {len(best_alignments)} alignment(s); best penalty "
                    f"{min(a.get_penalty() for a in best_alignments)}"
                )
            else:
                logger.log("No alignments found")
        result = QueryAlignments.single_component(query.get_sequences(), best_alignments)
        if len(best_alignments) < 1 and query.get_num_sequences() > 1:
            result = self._get_unpaired_alignments(query, path)

        if len(best_alignments) > params.max_num_matches:
            if logger.get_enabled():
                logger.log(
                    f"{len(best_alignments)} alignments exceeds --max-num-matches "
                    f"{params.max_num_matches}; treating query as unaligned"
                )
            return QueryAlignments.unaligned(query.get_sequences())
        return result

    def _penalty_lower_bound(self, num_mismatched_hashblocks: int) -> float:
        """java:487-491."""
        mutation = num_mismatched_hashblocks * self.parameters.mutation_penalty
        indel = (
            self.shortest_hashblock_length
            * num_mismatched_hashblocks
            * self.parameters.deletion_extension_penalty
        )
        return min(mutation, indel)

    def _quickly_confident(
        self, alignment: QueryAlignment | None, match: QueryMatch
    ) -> bool:
        """The duplication-window early-accept proof (java:494-587)."""
        if alignment is None:
            return False
        if alignment.has_indel():
            return False
        if self.duplication_detector is None:
            return False
        params = self.parameters

        aligned_reference = match.get_component(0).sequence_b
        original_reference = self.reference_index.get_original_sequence(aligned_reference)

        match_start = match.get_start_index_b()
        match_end = match.get_end_index_b()

        granularity = self.duplication_detector.get_detection_granularity()
        penalty = alignment.get_penalty()
        number_of_mutations = (penalty + params.max_penalty_span) / params.mutation_penalty
        existing_mutation_rate = number_of_mutations / match.get_query_total_length()
        if penalty <= 0 and params.max_penalty_span < params.get_min_possible_nonzero_penalty():
            return True

        probability_mutation_in_section = 1 - (1 - existing_mutation_rate) ** granularity
        acceptable = 1.0 / self.sequence_database.get_total_forward_and_reverse_size()
        if probability_mutation_in_section <= 0:
            return False
        num_unmatched_blocks = math.log(acceptable) / math.log(
            probability_mutation_in_section
        )
        total_length_for_confidence = num_unmatched_blocks * granularity

        match_middle = (match_start + match_end) / 2
        interesting_window = max(
            total_length_for_confidence, (match_end - match_start + 1) / 2
        )
        window_start = int(match_middle - interesting_window)
        window_end = int(match_middle + interesting_window)

        duplication_index = self.duplication_detector.may_contain_duplication_in_range(
            original_reference, window_start, window_end
        )
        if duplication_index is not None:
            return False
        if match_start <= interesting_window:
            return False
        if match_end >= len(original_reference) - interesting_window:
            return False
        if alignment.has_ambiguous_basepairs():
            return False
        return True

    def _get_unpaired_alignments(self, query: Query, path: PathsCounter) -> QueryAlignments:
        """Contig-edge rescue for half-mapped pairs (java:602-644)."""
        partial: list[list[QueryAlignment]] = [[], []]
        expected_inner = query.get_expected_inner_distance()
        for sequence_index in range(query.get_num_sequences()):
            sequence = query.get_sequence(sequence_index)
            max_sub_penalty = len(sequence) * self.parameters.max_error_rate
            max_num_mismatches = int(max_sub_penalty / self.parameters.mutation_penalty)
            candidate_locations = path.find_good_component_matches(
                sequence_index, max_num_mismatches
            )
            sub_query = query.subquery(sequence_index)
            sub_aligner = QueryMatchAligner(sub_query, self.parameters, self.reference_index)
            for sequence_match in candidate_locations:
                if sequence_index % 2 == 1:
                    min_inner = sequence_match.start_index_b
                else:
                    min_inner = len(sequence_match.sequence_b) - sequence_match.end_index_b
                inner_distance = max(float(min_inner), expected_inner)
                spacing_penalty = inner_distance / query.get_spacing_deviation_per_unit_penalty()
                if spacing_penalty > max_sub_penalty:
                    continue
                sub_match = QueryMatch([sequence_match], -1)
                sub_aligner.align(sub_match, inner_distance)
            partial[sequence_index] = sub_aligner.get_best_alignments()
        return QueryAlignments(query.get_sequences(), partial)
