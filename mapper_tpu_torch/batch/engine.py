"""The batch alignment engine on PyTorch: `mapper_tpu.batch.engine` with its
device sites on a `torch.device`.

Pipeline (single-end fast path):
1. batched candidate generation (batch/candidates.py): one vectorized pass for
   the whole batch's pyramids + one gather into the packed index + one lexsort
   for offset voting;
2. host certificate: candidate rows whose exact ungapped penalty settles them
   never reach the scorer;
3. device scoring: the remaining rows go to
   `mapper_tpu_torch.align.banded.banded_scores_gathered` in one call per
   chunk (the read gather, reverse complement, window gather, banded DP and
   ungapped diagonal sums fused in one CUDA kernel; its plain version on a
   CPU device), the result copied back into pinned memory behind a CUDA
   event;
4. vectorized decision: per-read best / Max_PenaltySpan window / MaxNumMatches,
   ties broken toward ungapped (StraightAligner semantics);
5. finalization: candidates whose banded score equals their ungapped score
   become full-length ungapped alignments directly; isolated gapped winners
   are finalized by the exact native DP; everything else falls back to the
   exact sequential worker (align/worker.py), the output-parity reference.

The host stages and the modules they call are the port's own copies of the
JAX package's code; only the device sites differ.
`MAPPER_TPU_HOST_SCORING=1` scores short reads with the native exact DP on
the host instead of the kernel.  `device_candidates=True` (or
`MAPPER_TPU_DEVICE_CANDIDATES=1`) replaces steps 1-3 of single-end chunks
with one device program (batch/device_candidates.py) that also scores every
kept candidate row.

With a `mesh` (parallel/mesh.py) step 3 shards the candidate rows over the
mesh's devices, each holding its own copy of the reference and the chunk's
read matrix, and never scores on the host; the fused device-candidates
program runs whole on the mesh's first device, as the JAX engine runs it on
the replicated reference without sharding it.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from mapper_tpu_torch import basepairs
from mapper_tpu_torch.align.blocks import (
    AlignedBlock,
    QueryAlignment,
    QueryAlignments,
    new_sequence_alignment,
)
from mapper_tpu_torch.align.query import Query
from mapper_tpu_torch.align.worker import AlignerWorker
from mapper_tpu_torch.batch.candidates import (
    CandidateTable,
    ReadBatch,
    _ranges,
    generate_candidates,
)
from mapper_tpu_torch.sequence import Sequence
from mapper_tpu_torch.align.banded import banded_scores_gathered
from mapper_tpu_torch.trace import OFF
from mapper_tpu_torch.parallel.mesh import make_mesh, replicate

EPS = 1e-3


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def upload_reference(concat_np: np.ndarray, device: torch.device) -> torch.Tensor:
    """The concatenated reference codes as a uint8 tensor on `device`: the
    state every scoring call reads, uploaded once per engine.  Window
    gathers clamp to its last index and are masked by the window length, so
    it needs no padding."""
    return torch.from_numpy(np.ascontiguousarray(concat_np, dtype=np.uint8)).to(device)


def single_end_band(lengths: np.ndarray, p, band: int | None = None) -> tuple[int, np.ndarray]:
    """A single-end chunk's band and per-read half-windows: each read's
    indel budget from its length and the penalties; band 64 when every
    budget fits in 31, else 128, unless `band` is given; the half-windows
    are the budgets clipped at half the band."""
    max_indel = np.maximum(
        0,
        (
            (lengths * p.max_error_rate - p.deletion_start_penalty)
            / p.deletion_extension_penalty
        ).astype(np.int64),
    )
    if band is None:
        band = 64 if int(max_indel.max(initial=0)) <= 31 else 128
    return band, np.minimum(max_indel, band // 2)


class BatchAligner:
    def __init__(
        self,
        reference_index,
        parameters,
        device: torch.device | None = None,
        band: int | None = None,
        # reads longer than this take the sequential exact path; 2048 covers
        # --split-queries-past-size chunks (the reference warns past 1600bp,
        # Mapper.java:946-981) while bounding the kernel's LQ bucket
        max_query_length: int = 2048,
        max_candidates_per_read: int = 8,
        listeners: list | None = None,
        pipeline_chunk_reads: int | None = 4096,
        paired_vectorized: bool = True,
        mesh=None,
        device_candidates: bool | None = None,
    ):
        # scoring shards over the mesh's devices (parallel/mesh.py); the
        # engine's own device is the mesh's first, by default
        self.mesh = None if mesh is None else make_mesh(mesh)
        if device is None:
            device = self.mesh[0] if self.mesh is not None else "cuda"
        self.device = torch.device(device)
        if self.mesh is not None and make_mesh([self.device])[0] != self.mesh[0]:
            raise ValueError(f"BatchAligner: device {self.device} is not the mesh's first entry")
        # the fused device-candidates path (batch/device_candidates.py) is
        # opt-in: device_candidates=True or MAPPER_TPU_DEVICE_CANDIDATES=1
        self.device_candidates = device_candidates
        self.reference_index = reference_index
        self.database = reference_index.hashblock_database
        self.seq_db = self.database.get_sequence_database()
        self.parameters = parameters
        self.band = band  # None = choose 64/128 per batch from the indel budget
        self.max_query_length = max_query_length
        self.max_candidates_per_read = max_candidates_per_read
        # chunked dispatch lets chunk k+1's host stages overlap chunk k's
        # device scoring (None disables the pipeline)
        self.pipeline_chunk_reads = pipeline_chunk_reads
        self.paired_vectorized = paired_vectorized
        # optional DevicePileup (batch/device_pileup.py): clean weight-1.0
        # emissions are added into accumulators on the device per chunk
        # instead of the host post-pass (Mapper.java:760-784)
        self.device_pileup = None
        self.listeners = listeners if listeners is not None else []
        self.fallback_worker = AlignerWorker(reference_index, parameters)
        self.concat = self.seq_db.concatenated_codes()
        self.stats_fallback_reads = 0
        self.stats_batch_reads = 0
        # single-end chunks dispatched, and those the fused device-candidates
        # path took
        self.stats_single_end_chunks = 0
        self.stats_fused_chunks = 0
        # queries fully resolved by the batch fast path (no exact-worker
        # involvement) — the analog of the reference's "Immediately accepted"
        # optimistic fast-path counter (Mapper.java:843-845)
        self.stats_batch_resolved = 0
        # why single-end reads left the batch path for the exact worker
        # (reason -> count); cheap enough to keep always-on
        self.stats_fallback_reasons: dict[str, int] = {}
        # process_batch runs on a pool of threads sharing this engine
        self._stats_lock = threading.Lock()
        self._upload_lock = threading.Lock()
        self._concat_devs: dict[torch.device, torch.Tensor] = {}
        self._ref_cache: dict[int, tuple] = {}
        # the CLI's span and counter recorder (trace.py) when tracing; with
        # print_decide_seconds each single-end chunk's decision seconds also
        # go to stdout as `[engine] decisions+emit: <s>s`
        self.tracer = OFF
        self.print_decide_seconds = False
        # optional AlignmentCache probed/stored at process_batch intake (the
        # reference's per-worker cache, AlignerWorker.java:264-291); hit and
        # skip counts land on fallback_worker.stats for the CLI report
        self.cache = None

    # ------------------------------------------------------------------

    def process_batch(
        self, queries: list[Query], notify: bool = True, batch_id: int | None = None
    ) -> list[QueryAlignments]:
        """`batch_id` tags the batch's spans when tracing (trace.py)."""
        with self.tracer.span("engine.batch", batch=batch_id):
            return self._process_batch_cached(queries, notify)

    def _process_batch_cached(self, queries: list[Query], notify: bool) -> list[QueryAlignments]:
        if self.cache is None or not queries:
            return self._process_batch_uncached(queries, notify)
        # alignment result cache at chunk intake (AlignerWorker.java:264-291
        # semantics, adaptive store fraction of AlignerWorker.java:129-155):
        # content-hash hits skip candidate generation + scoring entirely and
        # replay the stored alignment onto the new Query
        with self.tracer.span("engine.cache"):
            stats = self.fallback_worker.stats
            enable_fraction = self.cache.choose_enable_fraction(len(queries))
            keys = [q.content_hash() for q in queries]
            results: list[QueryAlignments | None] = [None] * len(queries)
            remaining = []
            for i, q in enumerate(queries):
                cached = self.cache.get(keys[i])
                if cached is not None and cached.get_num_components() == 1:
                    stats.num_cache_hits += 1
                    new_component = [
                        option.with_query(q.get_sequences())
                        for option in cached.get_first_alignments()
                    ]
                    results[i] = QueryAlignments.single_component(
                        q.get_sequences(), new_component
                    )
                    self.stats_batch_resolved += 1
                else:
                    remaining.append(i)
        batch_hits = len(queries) - len(remaining)
        if batch_hits and self.tracer.on:  # the hits' queries never reach the triage's count
            self._count_queries(np.fromiter(
                (q.get_num_sequences() for q, r in zip(queries, results) if r is not None), np.int64, batch_hits))
        batch_skips = 0
        if remaining:
            sub_results = self._process_batch_uncached(
                [queries[i] for i in remaining], notify=False
            )
            with self.tracer.span("engine.cache"):
                for local, i in enumerate(remaining):
                    results[i] = sub_results[local]
                    normalized = (keys[i] % (1 << 32)) / float(1 << 32)
                    if normalized <= enable_fraction:
                        self.cache.add(keys[i], results[i])
                    else:
                        stats.num_cache_skips += 1
                        batch_skips += 1
        # feed the adaptive formula (the cache's own counters drive
        # chooseEnableFraction, AlignerWorker.java:129-155)
        self.cache.add_hits_and_skips(batch_hits, batch_skips)
        self.tracer.count("cache.hits", batch_hits)
        self.tracer.count("cache.skips", batch_skips)
        if notify:
            for listener in self.listeners:
                listener.add_alignments(results)
        return results

    def _count_queries(self, sequences: np.ndarray) -> None:
        """Counts queries of one sequence and of two (pairs), given each
        query's number of sequences."""
        self.tracer.count("reads.single", int(np.count_nonzero(sequences == 1)))
        self.tracer.count("reads.paired", int(np.count_nonzero(sequences == 2)))

    def _process_batch_uncached(
        self, queries: list[Query], notify: bool = True
    ) -> list[QueryAlignments]:
        results: list[QueryAlignments | None] = [None] * len(queries)

        with self.tracer.span("engine.triage"):
            # vectorized triage: one ambiguity pass over all component sequences
            # (per-query numpy calls cost more than the checks themselves)
            all_seqs = [s for q in queries for s in q.get_sequences()]
            counts = np.fromiter(
                (q.get_num_sequences() for q in queries), np.int64, count=len(queries)
            )
            if all_seqs:
                lengths = np.fromiter((len(s) for s in all_seqs), np.int64, count=len(all_seqs))
                codes = np.concatenate([s.codes for s in all_seqs])
                amb = basepairs.POPCOUNT_TABLE[codes] != 1
                starts = np.zeros(len(all_seqs) + 1, dtype=np.int64)
                np.cumsum(lengths, out=starts[1:])
                if len(amb):
                    amb_counts = np.add.reduceat(amb, np.minimum(starts[:-1], len(amb) - 1))
                    amb_counts[lengths == 0] = 0
                else:
                    amb_counts = np.zeros(len(all_seqs), dtype=np.int64)
                seq_clean = (lengths <= self.max_query_length) & (amb_counts == 0)
                qstarts = np.zeros(len(queries) + 1, dtype=np.int64)
                np.cumsum(counts, out=qstarts[1:])
                clean_all = np.logical_and.reduceat(
                    np.append(seq_clean, True), np.minimum(qstarts[:-1], len(seq_clean))
                )
                clean_all[counts == 0] = True
            else:
                clean_all = np.ones(len(queries), dtype=bool)

            batch_indices = np.nonzero((counts == 1) & clean_all)[0].tolist()
            paired_indices = np.nonzero((counts == 2) & clean_all)[0].tolist()
            fallback_indices = np.nonzero(~((counts <= 2) & (counts >= 1) & clean_all))[
                0
            ].tolist()
        self._count_queries(counts)

        if batch_indices:
            batch_queries = [queries[i] for i in batch_indices]
            batch_results = self._align_single_end_pipelined(batch_queries)
            for local, i in enumerate(batch_indices):
                if batch_results[local] is None:
                    fallback_indices.append(i)
                else:
                    results[i] = batch_results[local]
                    self.stats_batch_resolved += 1

        if paired_indices:
            paired_queries = [queries[i] for i in paired_indices]
            paired_results = self._align_paired_batch(paired_queries)
            for local, i in enumerate(paired_indices):
                if paired_results[local] is None:
                    fallback_indices.append(i)
                else:
                    results[i] = paired_results[local]
                    if not getattr(paired_results[local], "via_exact", False):
                        self.stats_batch_resolved += 1

        # NOTE: a two-thread exact-fallback variant (own worker per thread,
        # longest read first to absorb lazy index growth) measured slower in
        # the JAX engine on its 2-vCPU host: the OpenMP stages already
        # saturate the cores and the Python halves of worker.align contend
        # on the GIL.  Serial it stays (not yet measured on the GPU host).
        with self.tracer.span("engine.fallback"):
            for i in fallback_indices:
                self.stats_fallback_reads += 1
                results[i] = self.fallback_worker.align(queries[i])
        self.tracer.count("reads.fallback", len(fallback_indices))

        # "query at random moment" sampling at chunk granularity: when this
        # moment is selected, record a uniformly random query from the chunk
        # (the batch path has no per-query loop to instrument)
        stats = self.fallback_worker.stats
        if queries and stats.random_moment.select(time.time()):
            stats.query_at_random_moment = queries[
                stats.random_moment.random.randrange(len(queries))
            ]

        logger = getattr(self, "logger", None)
        if logger is not None and logger.get_enabled():
            aligned = sum(
                1 for r in results if r is not None and any(r.get_alignments())
            )
            logger.log(
                f"Batch of {len(queries)} queries: {len(batch_indices)} single-end "
                f"batched, {len(paired_indices)} paired batched, "
                f"{len(fallback_indices)} via exact fallback; {aligned} aligned"
            )

        if notify:
            for listener in self.listeners:
                listener.add_alignments(results)
        return results

    # ------------------------------------------------------------------
    # paired-end batch path
    # ------------------------------------------------------------------

    def _align_paired_batch(self, queries: list[Query]) -> list[QueryAlignments | None]:
        """Paired-end batch path, mirroring the single-end design: one batched
        candidate pass over both mates' component sequences, device scoring of
        every candidate window, vectorized pairing windows + spacing-penalty +
        accept/cutoff algebra (QueryMatch_Aligner.java:35-54,71-92,530-546 recast
        as array math), and direct ungapped emission for clean pairs.  Pairs
        needing the overlap algebra (negative inner distance), contig-edge
        economics, or indel placement defer to the exact per-pair path
        (_align_paired_pair_exact); pairs with no viable combination return
        None for the sequential fallback worker (mate rescue)."""
        if not queries:
            return []
        chunk = self.pipeline_chunk_reads
        n = len(queries)
        chunk_pairs = None if chunk is None else max(1, chunk // 2)
        if chunk_pairs is None or n <= chunk_pairs:
            return self._finish_paired(self._dispatch_paired(queries))
        return self._run_pipelined(
            queries, chunk_pairs, self._dispatch_paired, self._finish_paired
        )

    # chunks dispatched ahead of the finish stage: deeper queues keep the
    # device busy across host stalls, bounded to cap device/host memory
    # (the depth the JAX engine chose; not yet tuned on a GPU)
    PIPELINE_DEPTH = 8

    def _run_pipelined(self, items, chunk_size, dispatch, finish):
        """Software pipeline over even chunks: up to PIPELINE_DEPTH chunks'
        dispatch stages (host candidate generation + async device submit) run
        ahead of the finish stage (device fetch + host decisions + emission),
        so the device computes and copies back (into pinned memory behind a
        CUDA event) while the host decides earlier chunks.  Single-threaded
        on the host: the OpenMP candidate pass already uses every core, so a
        background dispatch thread would only oversubscribe them."""
        from collections import deque

        n = len(items)
        k = -(-n // chunk_size)
        base, extra = divmod(n, k)
        results = []
        pending = deque()
        lo = 0
        for i in range(k):
            hi = lo + base + (1 if i < extra else 0)
            pending.append(dispatch(items[lo:hi]))
            lo = hi
            if len(pending) > self.PIPELINE_DEPTH:
                results.extend(finish(pending.popleft()))
        while pending:
            results.extend(finish(pending.popleft()))
        return results

    def _dispatch_paired(self, queries: list[Query]):
        """Host stages + asynchronous device dispatch for one chunk of pairs."""
        p = self.parameters
        num_pairs = len(queries)
        with self.tracer.span("engine.candidates"):
            components: list[Sequence] = []
            for query in queries:
                components.append(query.get_sequence(0))
                components.append(query.get_sequence(1).reverse_complement())
            batch = ReadBatch.from_sequences(components)
            self.stats_batch_reads += num_pairs
            table = generate_candidates(
                batch, self.database, max_candidates_per_read=self.max_candidates_per_read
            )
        self.tracer.count("rows.candidates", len(table))
        with self.tracer.span("engine.pairing"):
            order = np.argsort(table.read_id, kind="stable")
            bounds = np.searchsorted(table.read_id[order], np.arange(2 * num_pairs + 1))
            combos = self._paired_combos(queries, batch, table, order, bounds)

            if not self.paired_vectorized or len(table) == 0 or combos["pair"].shape[0] == 0:
                return {
                    "exact": True,
                    "queries": queries,
                    "components": components,
                    "table": table,
                    "combos": combos,
                }

            # per-pair banded window sized for the whole pair budget: the exact
            # path can grant one mate nearly the entire pair budget
            # (QueryMatch_Aligner.java:207-239), so certification needs the band
            # to cover the pair-level max indel, not the per-mate one
            total_len = batch.lengths[0::2] + batch.lengths[1::2]
            max_indel_pair = np.maximum(
                0,
                (
                    (total_len * p.max_error_rate - p.deletion_start_penalty)
                    / p.deletion_extension_penalty
                ).astype(np.int64),
            )
            if self.band is not None:
                band = self.band
            else:
                band = 64 if int(max_indel_pair.max(initial=0)) <= 31 else 128
            certified_pair = max_indel_pair <= band // 2

            # pairs that will defer regardless of scores (overlap algebra or an
            # uncertifiable band) never need device scoring; neither do combos
            # whose spacing penalty alone exceeds the pair budget (the exact
            # path's min-possible early reject, QueryMatch_Aligner.java:95-101)
            pair_of = combos["pair"]
            max_allowed = np.nextafter(
                total_len.astype(np.float64) * p.max_error_rate, np.inf
            )
            pre_defer = ~certified_pair
            if pair_of.shape[0]:
                overlap_pairs = pair_of[combos["inner"] < 0]
                pre_defer = pre_defer.copy()
                pre_defer[overlap_pairs] = True
            alive = (
                (combos["inner"] >= 0)
                & (combos["spacing"] <= max_allowed[pair_of])
                & ~pre_defer[pair_of]
            )
            combos = dict(combos)
            combos["alive"] = alive

            # only rows that participate in a live combo need device scores
            used = np.unique(
                np.concatenate([combos["row0"][alive], combos["row1"][alive]])
            )
            if used.shape[0] == 0:
                return {
                    "exact": True,
                    "queries": queries,
                    "components": components,
                    "table": table,
                    "combos": combos,
                }
            inv = np.full(len(table), 0, dtype=np.int64)  # dead combos index row 0
            inv[used] = np.arange(used.shape[0])
            subtable = table.take(used)
            combos["srow0"] = inv[combos["row0"]]
            combos["srow1"] = inv[combos["row1"]]

        # host certificate, as in the single-end path: rows whose exact
        # float64 ungapped penalty is within the straight short-circuit bound
        # resolve on the host; only the rest ship to the device
        with self.tracer.span("engine.certificate"):
            shift_per_component = np.minimum(np.repeat(max_indel_pair, 2), band // 2)
            geom = self._window_geometry(batch, subtable, shift_per_component)
            u_used = np.full(len(subtable), np.inf)
            ic_rows = np.nonzero(geom["in_contig"])[0]
            if ic_rows.shape[0]:
                u_used[ic_rows] = self._ungapped_penalties(components, subtable, ic_rows)
            min_indel = min(
                p.get_starting_insertion_start_penalty() + p.insertion_extension_penalty,
                p.deletion_start_penalty + p.deletion_extension_penalty,
            )
            skip = geom["in_contig"] & ~geom["at_edge"] & (u_used <= min_indel)
            dev_rows = np.nonzero(~skip)[0]
        self.tracer.count("rows.device", dev_rows.shape[0])
        with self.tracer.span("engine.dispatch"):
            if dev_rows.shape[0]:
                dev_sub = subtable.take(dev_rows)
                sctx = self._dispatch_scores(
                    components, batch, dev_sub, shift_per_component, band,
                    # each mate may spend up to the pair budget (exact algebra
                    # re-allocation) — the scoring DP must not cap at mate level
                    budget_len=total_len[dev_sub.read_id // 2],
                )
            else:
                sctx = None
        return {
            "exact": False,
            "queries": queries,
            "components": components,
            "batch": batch,
            "table": table,
            "combos": combos,
            "geom": geom,
            "u_used": u_used,
            "skip": skip,
            "dev_rows": dev_rows,
            "sctx": sctx,
            "total_len": total_len,
            "certified_pair": certified_pair,
            "pre_defer": pre_defer,
        }

    def _finish_paired(self, ctx) -> list[QueryAlignments | None]:
        queries = ctx["queries"]
        if ctx["exact"]:
            with self.tracer.span("engine.pair_exact"):
                return [
                    self._align_paired_pair_exact(
                        queries[i], ctx["components"], ctx["table"], ctx["combos"], i
                    )
                    for i in range(len(queries))
                ]
        # certificate rows resolve to their exact host penalty; device rows
        # fill from the compacted call
        ungapped = np.where(ctx["skip"], ctx["u_used"], np.inf)
        banded = ungapped.copy()
        if ctx["sctx"] is not None:
            with self.tracer.span("engine.fetch"):
                d_ung, d_banded = self._finish_scores(ctx["sctx"])
            ungapped[ctx["dev_rows"]] = d_ung
            banded[ctx["dev_rows"]] = d_banded
        return self._paired_decisions(
            queries, ctx["components"], ctx["batch"], ctx["table"], ctx["combos"],
            ctx["geom"], ctx["u_used"], ungapped, banded, ctx["total_len"],
            ctx["pre_defer"],
        )

    def _paired_combos(self, queries, batch, table, order, bounds):
        """Vectorized pairing: every (mate1-candidate, mate2RC-candidate)
        combination on the same strand sense and contig within the spacing
        window, in the exact discovery order of the reference's pairing scan
        (HashBlockPaths_Counter.java:136-247: iterate the larger component's
        candidates, search the smaller component's sorted offsets, descending
        when the pair sense is reversed)."""
        p = self.parameters
        num_pairs = len(queries)
        total_len = batch.lengths[0::2] + batch.lengths[1::2]
        max_interesting = total_len * p.max_error_rate
        dev = np.array(
            [q.get_spacing_deviation_per_unit_penalty() for q in queries], dtype=np.float64
        )
        expected = np.array(
            [q.get_expected_inner_distance() for q in queries], dtype=np.int64
        )
        max_inner = np.trunc(max_interesting * dev + expected).astype(np.int64)
        max_off = max_inner + batch.lengths[0::2]

        counts0 = bounds[1::2] - bounds[0:-1:2]
        counts1 = bounds[2::2] - bounds[1::2]
        combo_count = counts0 * counts1
        pair_of = np.repeat(np.arange(num_pairs), combo_count)
        k_local = _ranges(combo_count)
        c1 = counts1[pair_of]
        i = k_local // np.maximum(c1, 1)
        j = k_local - i * c1
        row0 = order[bounds[2 * pair_of] + i]
        row1 = order[bounds[2 * pair_of + 1] + j]

        same = (table.reversed_[row0] == table.reversed_[row1]) & (
            table.ref_seq_index[row0] == table.ref_seq_index[row1]
        )
        qmr = table.reversed_[row0]
        case_a = (counts0 <= counts1)[pair_of]
        len0 = batch.lengths[2 * pair_of]
        len1 = batch.lengths[2 * pair_of + 1]
        maxrev = np.where(case_a, len1 // 2, len0 // 2)
        o0 = table.offset[row0]
        o1 = table.offset[row1]
        delta = o1 - o0
        mo = max_off[pair_of]
        in_window = np.where(
            qmr,
            (delta >= -mo) & (delta <= maxrev),
            (delta >= -maxrev) & (delta <= mo),
        )
        keep = same & in_window
        pair_of, row0, row1, qmr, i, j, o0, o1, case_a, len0, len1 = (
            a[keep] for a in (pair_of, row0, row1, qmr, i, j, o0, o1, case_a, len0, len1)
        )
        # discovery order: (iterated-row rank, other offset asc, desc if reversed)
        key1 = np.where(case_a, j, i)
        key2 = np.where(case_a, np.where(qmr, -o0, o0), np.where(qmr, -o1, o1))
        sort = np.lexsort((key2, key1, pair_of))
        pair_of, row0, row1, qmr, o0, o1, len0, len1 = (
            a[sort] for a in (pair_of, row0, row1, qmr, o0, o1, len0, len1)
        )

        _, _, seq_lengths = _tables(self.database)
        contig = seq_lengths[table.ref_seq_index[row0]]
        s0 = np.maximum(0, o0)
        e0 = np.minimum(o0 + len0, contig)
        s1 = np.maximum(0, o1)
        e1 = np.minimum(o1 + len1, contig)
        inner = np.where(qmr, s0 - e1, s1 - e0)
        tl = total_len[pair_of]
        overlapish = (inner < 0) & (inner > -tl)
        spacing = np.where(
            overlapish,
            0.0,
            np.trunc(np.abs(inner - expected[pair_of]).astype(np.float64) / dev[pair_of]),
        )
        return {
            "pair": pair_of,
            "row0": row0,
            "row1": row1,
            "qmr": qmr,
            "inner": inner,
            "spacing": spacing,
        }

    def _paired_decisions(
        self, queries, components, batch, table, combos, geom, u_used, ungapped,
        banded, total_len, pre_defer,
    ) -> list[QueryAlignments | None]:
        with self.tracer.span("engine.decide"):
            p = self.parameters
            num_pairs = len(queries)
            pair_of = combos["pair"]
            row0, row1 = combos["row0"], combos["row1"]
            srow0, srow1 = combos["srow0"], combos["srow1"]
            spacing = combos["spacing"]
            alive = combos["alive"]

            score = np.where(geom["valid"], np.minimum(banded, ungapped), np.inf)
            total = np.where(alive, score[srow0] + score[srow1] + spacing, np.inf)
            tl = total_len[pair_of].astype(np.float64)
            max_allowed = np.nextafter(tl * p.max_error_rate, np.inf)
            viable = total <= max_allowed

            pbounds = np.searchsorted(pair_of, np.arange(num_pairs + 1))
            starts, ends = pbounds[:-1], pbounds[1:]
            nonempty = starts < ends
            best = np.full(num_pairs, np.inf)
            if pair_of.shape[0]:
                safe_starts = np.minimum(starts, pair_of.shape[0] - 1)
                best = np.where(nonempty, np.minimum.reduceat(total, safe_starts), np.inf)

            # the tightening-MaxErrorRate + Max_PenaltySpan cutoff algebra
            # (QueryMatch_Aligner.java:35-54,71-92) in float64
            ptl = total_len.astype(np.float64)
            target = best + p.max_penalty_span
            ratio = target / ptl
            tightened = np.where(ratio * ptl < target, np.nextafter(ratio, np.inf), ratio)
            rate_final = np.minimum(p.max_error_rate, tightened)
            cutoff = np.minimum(target, ptl * rate_final)
            emit = viable & (total <= cutoff[pair_of])

            # deferral to the exact per-pair path
            unclean_row = (
                geom["at_edge"] | ~geom["in_contig"] | (banded < ungapped - EPS)
            )
            combo_defer = viable & (unclean_row[srow0] | unclean_row[srow1])
            defer = pre_defer.copy()
            defer[pair_of[combo_defer]] = True
            emit &= ~defer[pair_of]
            emit_counts = np.bincount(pair_of[emit], minlength=num_pairs)

            # exact float64 penalties for every emitted component: emitted combos'
            # rows are in-contig (off-contig rows are unclean, deferring the pair),
            # and the dispatch stage already computed their penalties
            pen0, pen1 = u_used[srow0[emit]], u_used[srow1[emit]]
            exact_total = pen0 + pen1 + spacing[emit]
            emit_pair = pair_of[emit]
            # float64 recheck of the device-float32 accept (disagreement defers)
            bad64 = exact_total > max_allowed[emit]
            defer[emit_pair[bad64]] = True

            results: list[QueryAlignments | None] = [None] * num_pairs
            deferred: list[int] = []
            e_row0, e_row1 = row0[emit], row1[emit]
            e_spacing = spacing[emit]
            e_inner = combos["inner"][emit]
            ebounds = np.searchsorted(emit_pair, np.arange(num_pairs + 1))
            dp_rows: list[int] = []  # candidate-table rows to count on the device
            take_device_pileup = self.device_pileup is not None
            for pi in range(num_pairs):
                if not nonempty[pi]:
                    continue  # no pairing at all: sequential fallback (mate rescue)
                if defer[pi]:
                    deferred.append(pi)
                    continue
                if not np.isfinite(best[pi]):
                    continue  # nothing viable: sequential fallback
                query = queries[pi]
                if emit_counts[pi] > p.max_num_matches:
                    results[pi] = QueryAlignments.unaligned(query.get_sequences())
                    continue
                choices = []
                for c in range(int(ebounds[pi]), int(ebounds[pi + 1])):
                    choices.append(
                        self._make_ungapped_pair(
                            query, components, table, int(e_row0[c]), int(e_row1[c]),
                            float(e_spacing[c]), float(pen0[c]), float(pen1[c]),
                        )
                    )
                result = QueryAlignments.single_component(query.get_sequences(), choices)
                if (
                    take_device_pileup
                    and len(choices) == 1
                    and choices[0] is not None
                    and int(ebounds[pi + 1]) - int(ebounds[pi]) == 1
                    and e_inner[int(ebounds[pi])] >= 0  # no mate overlap on the ref
                ):
                    c0 = int(ebounds[pi])
                    dp_rows.append(int(e_row0[c0]))
                    dp_rows.append(int(e_row1[c0]))
                    result.device_counted = True
                results[pi] = result

            if dp_rows:
                rows_arr = np.array(dp_rows, dtype=np.int64)
                rid = table.read_id[rows_arr]
                gstart = self.seq_db.starts[table.ref_seq_index[rows_arr]] + table.offset[rows_arr]
                self.device_pileup.add_rows(
                    batch, rid, table.reversed_[rows_arr], gstart, batch.lengths[rid],
                    np.ones(rows_arr.shape[0], dtype=np.float32),
                )

        with self.tracer.span("engine.pair_exact"):
            if deferred:
                deferred = self._align_paired_deferred_native(
                    queries, components, table, combos, deferred, results
                )
            if len(deferred) >= 8 and os.environ.get("MAPPER_TPU_EXACT_THREADS", "1") != "0":
                # the per-pair exact drivers are independent (own aligner, own
                # memo; shared caches are GIL-atomic idempotent dict fills) and
                # ~half their time is inside native local_align calls that
                # release the GIL — two threads overlap that half
                from concurrent.futures import ThreadPoolExecutor

                def run_pair(pi):
                    return self._align_paired_pair_exact(
                        queries[pi], components, table, combos, pi
                    )

                with ThreadPoolExecutor(max_workers=2) as ex:
                    for pi, res in zip(deferred, ex.map(run_pair, deferred)):
                        results[pi] = res
            else:
                for pi in deferred:
                    results[pi] = self._align_paired_pair_exact(
                        queries[pi], components, table, combos, pi
                    )
        return results

    def _ungapped_penalties(self, seqs, table, rows):
        """Exact float64 full-length ungapped penalties at the voted offsets
        for the given candidate table rows, computed in batched passes grouped
        by read length (the per-length grouping keeps numpy's pairwise
        summation order identical to the per-block np.sum in
        blocks.block_penalty).  Rows must be in-contig."""
        k = rows.shape[0]
        pens = np.zeros(k, dtype=np.float64)
        if k == 0:
            return pens
        read_id = table.read_id[rows]
        read_lengths = np.array([len(c) for c in seqs], dtype=np.int64)
        read_starts = np.zeros(read_lengths.shape[0] + 1, dtype=np.int64)
        np.cumsum(read_lengths, out=read_starts[1:])
        codes_concat = (
            np.concatenate([s.codes for s in seqs])
            if seqs
            else np.zeros(0, dtype=np.uint8)
        )
        lengths = read_lengths[read_id]
        seq_starts = self.seq_db.starts
        diag_start = seq_starts[table.ref_seq_index[rows]] + table.offset[rows]
        reversed_rows = table.reversed_[rows]

        # native fast path: for pure-ACGT rows the penalty is an exact
        # integer multiple of mutation_penalty, bit-equal to numpy's pairwise
        # sum whenever mutation_penalty is integer-valued
        todo = None
        snp = self.parameters.mutation_penalty
        if float(snp).is_integer() and os.environ.get("MAPPER_TPU_NATIVE", "1") != "0":
            from mapper_tpu_torch import native

            out = native.native_ungapped_counts(
                codes_concat, read_starts, read_id, reversed_rows, diag_start,
                self.concat,
            )
            if out is not None:
                counts, clean = out
                pens[clean] = counts[clean].astype(np.float64) * snp
                todo = np.nonzero(~clean)[0]
                if todo.shape[0] == 0:
                    return pens

        for n in np.unique(lengths if todo is None else lengths[todo]).tolist():
            if todo is None:
                sel = np.nonzero(lengths == n)[0]
            else:
                sel = todo[lengths[todo] == n]
            q_idx = read_starts[read_id[sel]][:, None] + np.arange(n, dtype=np.int64)[None, :]
            q = codes_concat[q_idx]
            rev = reversed_rows[sel]
            if np.any(rev):
                q[rev] = basepairs.COMPLEMENT_TABLE[q[rev]][:, ::-1]
            d_idx = diag_start[sel][:, None] + np.arange(n, dtype=np.int64)[None, :]
            ref_diag = self.concat[d_idx]
            pens[sel] = np.sum(
                self.parameters.base_penalty(q, ref_diag).astype(np.float64), axis=1
            )
        return pens

    def _make_ungapped_pair(
        self,
        query,
        components,
        table,
        r0: int,
        r1: int,
        spacing_penalty: float,
        pen0: float | None = None,
        pen1: float | None = None,
    ) -> QueryAlignment | None:
        parts = []
        pair_index = int(table.read_id[r0]) // 2
        for ci, r, pen in ((0, r0, pen0), (1, r1, pen1)):
            base = components[2 * pair_index + ci]
            seq_a = base.reverse_complement() if table.reversed_[r] else base
            alignment = self._make_ungapped_component(
                seq_a, int(table.ref_seq_index[r]), int(table.offset[r]), pen
            )
            if alignment is None:
                return None
            parts.append(alignment)
        total = parts[0].get_penalty() + parts[1].get_penalty() + spacing_penalty
        # the reference computes actualInnerDistance in each component's own
        # sequenceB space (QueryMatch_Aligner.java:261-265), where a
        # reverse-strand pair's components live on the RC contig and read
        # left-to-right again; in our forward-folded coordinates that is the
        # mirrored difference when component 0 aligned the reverse strand
        if parts[0].is_reference_reversed():
            actual_inner = parts[0].get_start_index_b() - parts[1].get_end_index_b()
        else:
            actual_inner = parts[1].get_start_index_b() - parts[0].get_end_index_b()
        return QueryAlignment(parts, spacing_penalty, 1.0, 0.0, total, actual_inner)

    def _ref_objects(self):
        """List indexed by contig index of (ref sequence, is_ancestral) for
        the emission loop's per-row lookups."""
        cached = self.__dict__.get("_ref_objects_list")
        n = self.seq_db.get_num_sequences()
        if cached is None or len(cached) != n:
            cached = []
            for i in range(n):
                ref = self.seq_db.get_sequence(i)
                original = self.reference_index.get_original_sequence(ref)
                cached.append((ref, original is not ref))
            self._ref_objects_list = cached
        return cached

    def _ref_and_original(self, ref_index: int):
        cached = self._ref_cache.get(ref_index)
        if cached is None:
            ref = self.seq_db.get_sequence(ref_index)
            cached = (ref, self.reference_index.get_original_sequence(ref))
            self._ref_cache[ref_index] = cached
        return cached

    def _make_ungapped_component(
        self, seq_a, ref_index: int, offset: int, penalty: float | None = None
    ):
        """Full-length ungapped SequenceAlignment of seq_a at the given contig
        offset (with the ancestral->original rewrite), or None off-contig.
        `penalty` short-circuits the per-base sum when precomputed (it must
        equal blocks.block_penalty's value bit-for-bit)."""
        ref, original = self._ref_and_original(ref_index)
        if offset < 0 or offset + len(seq_a) > len(ref):
            return None
        if original is not ref:
            block = AlignedBlock(
                seq_a, original, 0, offset, len(seq_a), len(seq_a),
                sequence_b_history=ref,
            )
        else:
            block = AlignedBlock(seq_a, ref, 0, offset, len(seq_a), len(seq_a))
        reversed_flag = seq_a.complemented_from is not None
        if penalty is None:
            return new_sequence_alignment([block], reversed_flag, self.parameters)
        from mapper_tpu_torch.align.blocks import SequenceAlignment

        return SequenceAlignment([block], reversed_flag, penalty, penalty)

    def _align_paired_deferred_native(
        self, queries, components, table, combos, deferred, results
    ):
        """Run the deferred pairs' exact combo drivers natively in one batched
        OpenMP call (dp.cpp::mapper_pair_driver_batch — the round-5 wavefront
        fix; VERDICT r4 #1).  Fills `results` for pairs the native driver
        decides (ok -> choices, worker -> None) and returns the pairs that
        still need the Python driver (overlap-regime combos, native DP bail,
        or output caps; the Python driver is the oracle and handles them
        identically — differential test tests/test_native_pair_driver.py)."""
        if (
            os.environ.get("MAPPER_TPU_NATIVE", "1") == "0"
            or os.environ.get("MAPPER_TPU_NATIVE_PAIR", "1") == "0"
        ):
            return deferred
        from mapper_tpu_torch.native import native_pair_driver_batch

        p = self.parameters
        pair_of = combos["pair"]
        # pair_of is np.repeat(arange, counts): each pair's combos are one
        # contiguous ascending range
        darr = np.asarray(deferred, dtype=np.int64)
        starts = np.searchsorted(pair_of, darr, side="left")
        ends = np.searchsorted(pair_of, darr, side="right")
        todo = [
            (pi, int(s), int(e))
            for pi, s, e in zip(deferred, starts, ends)
            if e > s
        ]
        # empty-combo pairs: the Python driver returns None (sequential
        # worker); results[pi] is already None
        if not todo:
            return []
        npairs = len(todo)
        mate_len = np.empty(2 * npairs, dtype=np.int32)
        mate_off = np.empty(2 * npairs, dtype=np.int64)
        mate_parts = []
        expected_inner = np.empty(npairs, dtype=np.float64)
        spacing_dev = np.empty(npairs, dtype=np.float64)
        combo_bounds = np.zeros(npairs + 1, dtype=np.int64)
        row0_parts = []
        row1_parts = []
        off = 0
        for i, (pi, s, e) in enumerate(todo):
            q = queries[pi]
            for ci in range(2):
                codes = q.get_sequence(ci).codes
                mate_parts.append(codes)
                mate_off[2 * i + ci] = off
                mate_len[2 * i + ci] = codes.shape[0]
                off += codes.shape[0]
            expected_inner[i] = q.get_expected_inner_distance()
            spacing_dev[i] = q.get_spacing_deviation_per_unit_penalty()
            combo_bounds[i + 1] = combo_bounds[i] + (e - s)
            row0_parts.append(combos["row0"][s:e])
            row1_parts.append(combos["row1"][s:e])

        ref_lens = getattr(self, "_ref_lens_arr", None)
        if ref_lens is None:
            ref_lens = np.diff(self.seq_db.starts).astype(np.int64)
            self._ref_lens_arr = ref_lens

        out = native_pair_driver_batch(
            self.concat,
            self.seq_db.starts,
            ref_lens,
            np.concatenate(mate_parts),
            mate_off,
            mate_len,
            expected_inner,
            spacing_dev,
            combo_bounds,
            np.concatenate(row0_parts),
            np.concatenate(row1_parts),
            table.offset,
            table.ref_seq_index,
            table.reversed_,
            basepairs.COMPLEMENT_TABLE,
            p,
        )
        if out is None:
            return deferred

        from mapper_tpu_torch.align.blocks import SequenceAlignment

        leftover = []
        maxc = out["max_choices"]
        maxb = out["max_blocks_out"]
        for i, (pi, s, e) in enumerate(todo):
            st = int(out["status"][i])
            if st == 2:
                leftover.append(pi)
                continue
            if st == 1:
                results[pi] = None  # sequential worker owns the pair
                continue
            query = queries[pi]
            choices = []
            for j in range(int(out["nchoices"][i])):
                gi = i * maxc + j
                comps = []
                for ci in range(2):
                    gc = gi * 2 + ci
                    s_flag = bool(out["comp_s"][gc])
                    base = components[2 * pi + ci]
                    # seq_a identity: base is the forward mate for ci=0 and
                    # the RC'd mate for ci=1 (engine pairing convention)
                    seq_a = base if s_flag == (ci == 1) else base.reverse_complement()
                    ref = self.seq_db.get_sequence(int(out["comp_ref"][gc]))
                    nb = int(out["comp_nb"][gc])
                    rows = out["blocks"][gc * maxb * 4 : (gc * maxb + nb) * 4]
                    sections = [
                        AlignedBlock(
                            seq_a,
                            ref,
                            int(rows[4 * b]),
                            int(rows[4 * b + 1]),
                            int(rows[4 * b + 2]),
                            int(rows[4 * b + 3]),
                        )
                        for b in range(nb)
                    ]
                    comps.append(
                        SequenceAlignment(
                            sections,
                            s_flag,
                            float(out["comp_total"][gc]),
                            float(out["comp_aligned"][gc]),
                        )
                    )
                choice = QueryAlignment(
                    comps,
                    float(out["spacing"][gi]),
                    1.0,
                    0.0,
                    float(out["total"][gi]),
                    int(out["inner"][gi]),
                )
                # ancestral -> original coordinate rewrite
                computed = choice.get_sequence_b()
                original = self.reference_index.get_original_sequence(computed)
                if original is not computed:
                    choice.put_sequence_b(original)
                choices.append(choice)
            if len(choices) > p.max_num_matches:
                result = QueryAlignments.unaligned(query.get_sequences())
            else:
                result = QueryAlignments.single_component(
                    query.get_sequences(), choices
                )
            result.via_exact = True
            results[pi] = result
        return leftover

    def _align_paired_pair_exact(self, query, components, table, combos, pair_index: int):
        result = self._align_paired_pair_exact_inner(
            query, components, table, combos, pair_index
        )
        if result is not None:
            result.via_exact = True
        return result

    def _align_paired_pair_exact_inner(
        self, query, components, table, combos, pair_index: int
    ) -> QueryAlignments | None:
        """Exact per-pair path over this pair's combos (discovery order):
        the full QueryMatch_Aligner algebra — overlap join/split, duplication
        bonus, budget re-allocation — on the batch-voted candidate set."""
        from mapper_tpu_torch.align.candidates import QueryMatch, SequenceMatch
        from mapper_tpu_torch.align.query_aligner import QueryMatchAligner

        p = self.parameters
        pair_of = combos["pair"]
        sel = np.nonzero(pair_of == pair_index)[0]
        if sel.shape[0] == 0:
            return None

        match_memo: dict = {}

        def run(overrides):
            aligner = QueryMatchAligner(query, p, self.reference_index)
            aligner.match_memo = match_memo
            for c in sel.tolist():
                matches = []
                for ci, r in ((0, int(combos["row0"][c])), (1, int(combos["row1"][c]))):
                    base = components[2 * pair_index + ci]
                    seq_a = base.reverse_complement() if table.reversed_[r] else base
                    ref = self.seq_db.get_sequence(int(table.ref_seq_index[r]))
                    offset = overrides.get((ci, r), int(table.offset[r]))
                    matches.append(SequenceMatch(seq_a, ref, offset))
                aligner.align(QueryMatch(matches, 0, hint_forward_order=False))
            return aligner.get_best_alignments()

        best = run({})
        if not best:
            return None  # mate-rescue paths: sequential fallback

        # offset-invariance gate (the paired analog of the single-end gapped
        # finalization gate): equal-penalty tracebacks are sensitive to the
        # predicted diagonal, and the sequential engine may vote a NEIGHBORING
        # diagonal of the same locus for an indel mate.  Any choice containing
        # an indel must reproduce identically when each indel component's own
        # gapless-run diagonals replace the voted offsets of that locus;
        # otherwise the full worker decides.
        def summarize(choices):
            return sorted(
                (
                    a.get_penalty(),
                    a.spacing_penalty,
                    tuple(c.content_key() for c in a.get_components()),
                )
                for a in choices
            )

        alt_probes = set()
        budget = int(
            max(
                0.0,
                (
                    query.get_length() * p.max_error_rate
                    - p.deletion_start_penalty
                )
                / p.deletion_extension_penalty,
            )
        )
        for choice in best:
            for ci, comp in enumerate(choice.get_components()):
                if comp.count_num_indels() == 0:
                    continue
                for s in comp.sections:
                    if s.length_a == s.length_b and s.length_a > 0:
                        alt_probes.add((ci, int(s.start_b - s.start_a)))
        if alt_probes:
            base_summary = summarize(best)
            # keys the base run recorded per (sequence ids, voted offset):
            # when the pair-level inputs replay (pair_inputs_replay below),
            # run(overrides) is a pure function of its _align_match results,
            # so a probe whose overridden rows reproduce the voted-offset
            # result under every max_error_rate the base run used replays in
            # lockstep (by induction over the call sequence) and needs no
            # full re-enumeration
            base_keys: dict[tuple, list] = {}
            for k in list(match_memo.keys()):
                base_keys.setdefault((k[0], k[1], k[2]), []).append(k)
            probe_aligner = QueryMatchAligner(query, p, self.reference_index)
            probe_aligner.match_memo = match_memo

            def same_result(a, b) -> bool:
                if (a is None) != (b is None):
                    return False
                return a is None or (
                    a.content_key() == b.content_key()
                    and a.get_penalty() == b.get_penalty()
                    and a.get_aligned_penalty() == b.get_aligned_penalty()
                )

            def spacing_pen(inner: float) -> float:
                if inner < 0 and inner > -query.get_length():
                    return 0.0
                return float(
                    int(
                        abs(inner - query.get_expected_inner_distance())
                        / query.get_spacing_deviation_per_unit_penalty()
                    )
                )

            def combo_inner(c: int, overrides) -> int:
                # QueryMatch.get_total_distance_between_components for combo c
                # with the probe's offset overrides applied
                from mapper_tpu_torch.align.candidates import _INT_MAX

                ends = []
                refs = []
                rev0 = False
                for ci_c, r in (
                    (0, int(combos["row0"][c])),
                    (1, int(combos["row1"][c])),
                ):
                    base_c = components[2 * pair_index + ci_c]
                    n = len(base_c)
                    ref = self.seq_db.get_sequence(int(table.ref_seq_index[r]))
                    off = overrides.get((ci_c, r), int(table.offset[r]))
                    ends.append((max(0, off), min(off + n, len(ref))))
                    refs.append(ref)
                    if ci_c == 0:
                        rev0 = bool(table.reversed_[r])
                if refs[0] is not refs[1]:
                    return _INT_MAX
                (s0, e0), (s1, e1) = ends
                return (s0 - e1) if rev0 else (s1 - e0)

            def pair_inputs_replay(overrides) -> bool:
                # run(overrides) is a pure function of its _align_match results
                # ONLY when the pair-level quantities derived from the raw
                # offsets also replay: _do_align consumes the offsets directly
                # through the spacing penalty, the inner-distance sign branches
                # (>0 early reject; <0 overlap join + estimated-overlap
                # budget), and max_total_component_penalty (hence every
                # sub_params error rate).  Require each affected combo to keep
                # the same spacing penalty and the same non-negative
                # inner-distance regime under the overrides; overlap-regime
                # combos (inner < 0 on either side) never qualify because the
                # join offset and the overlap budget read the raw offsets.
                for c in sel.tolist():
                    affected = (0, int(combos["row0"][c])) in overrides or (
                        1,
                        int(combos["row1"][c]),
                    ) in overrides
                    if not affected:
                        continue
                    inner_base = combo_inner(c, {})
                    inner_alt = combo_inner(c, overrides)
                    if inner_base < 0 or inner_alt < 0:
                        return False
                    if (inner_base > 0) != (inner_alt > 0):
                        return False
                    if spacing_pen(inner_base) != spacing_pen(inner_alt):
                        return False
                return True

            def rows_reproduce(overrides) -> bool:
                for (ci_r, r), off_alt in overrides.items():
                    base_c = components[2 * pair_index + ci_r]
                    seq_a = (
                        base_c.reverse_complement() if table.reversed_[r] else base_c
                    )
                    ref = self.seq_db.get_sequence(int(table.ref_seq_index[r]))
                    seen = base_keys.get((id(seq_a), id(ref), int(table.offset[r])))
                    if not seen:
                        return False
                    for k in seen:
                        alt_res = probe_aligner._align_match(
                            SequenceMatch(seq_a, ref, off_alt),
                            p if k[4] == p.max_error_rate
                            else p.clone(max_error_rate=k[4]),
                        )
                        if not same_result(match_memo[k][2], alt_res):
                            return False
                return True

            for ci, alt in alt_probes:
                overrides = {}
                for c in sel.tolist():
                    r = int(combos["row0"][c]) if ci == 0 else int(combos["row1"][c])
                    off = int(table.offset[r])
                    if off != alt and abs(off - alt) <= budget:
                        overrides[(ci, r)] = alt
                if not overrides:
                    continue  # every same-locus row already voted this diagonal
                if pair_inputs_replay(overrides) and rows_reproduce(overrides):
                    continue  # lockstep replay: full enumeration unchanged
                if summarize(run(overrides)) != base_summary:
                    return None  # sequential worker owns the tie
        for choice in best:  # ancestral -> original coordinate rewrite
            computed = choice.get_sequence_b()
            original = self.reference_index.get_original_sequence(computed)
            if original is not computed:
                choice.put_sequence_b(original)
        if len(best) > p.max_num_matches:
            return QueryAlignments.unaligned(query.get_sequences())
        return QueryAlignments.single_component(query.get_sequences(), best)

    # ------------------------------------------------------------------

    def _align_single_end_pipelined(
        self, queries: list[Query]
    ) -> list[QueryAlignments | None]:
        """Software-pipelined single-end path: the batch is split into chunks
        and chunk k+1's host work (candidate generation + window gathers) runs
        while chunk k's scores compute on the device — kernel launches and the
        copy back are asynchronous, so the device stays busy during the host
        stages."""
        chunk = self.pipeline_chunk_reads
        n = len(queries)
        if chunk is None or n <= chunk:
            ctx = self._dispatch_single_end(queries)
            return self._finish_single_end(ctx)
        # even chunk sizes (no ragged tail) keep the padded candidate count in
        # the same compile-size bucket across chunks and across batches
        return self._run_pipelined(
            queries, chunk, self._dispatch_single_end, self._finish_single_end
        )

    def _align_single_end_batch(
        self, queries: list[Query]
    ) -> list[QueryAlignments | None]:
        """Returns one QueryAlignments per query, or None where the exact
        sequential path must decide."""
        return self._finish_single_end(self._dispatch_single_end(queries))

    def _dispatch_single_end(self, queries: list[Query]):
        """Host stages + asynchronous device dispatch for one chunk; returns an
        opaque context consumed by _finish_single_end."""
        p = self.parameters
        with self.tracer.span("engine.candidates"):
            reads = [q.get_sequence(0) for q in queries]
            batch = ReadBatch.from_sequences(reads)
        num_reads = batch.num_reads
        self.stats_batch_reads += num_reads

        band, shift = single_end_band(batch.lengths, p, self.band)

        with self._stats_lock:
            self.stats_single_end_chunks += 1

        # fused device path: pyramid + index lookup + voting + banded scoring
        # in one device program with one copy back; the host's only per-read
        # work left is decisions + emission
        if self._use_device_candidates():
            from mapper_tpu_torch.batch import device_candidates as _dc

            with self.tracer.span("engine.dispatch"):
                fused = _dc.fused_candidates_scores(
                    batch,
                    self.database,
                    self._concat_device(),
                    p,
                    shift,
                    band,
                    max_candidates_per_read=self.max_candidates_per_read,
                    lock=self._upload_lock,
                )
            if fused is not None:
                with self._stats_lock:
                    self.stats_fused_chunks += 1
                return {
                    "queries": queries,
                    "batch": batch,
                    "num_reads": num_reads,
                    "fused": fused[1],
                    "shift": shift,
                    "band": band,
                }

        # candidate voting runs on the host (native C++/numpy)
        with self.tracer.span("engine.candidates"):
            table = generate_candidates(
                batch, self.database, max_candidates_per_read=self.max_candidates_per_read
            )
        self.tracer.count("rows.candidates", len(table))
        if len(table) == 0:
            return [None] * num_reads

        # host certificate: the exact path's own short-circuit (dp.local_align
        # / StraightAligner.java:26-56) returns the straight alignment for a
        # confident voted offset whose exact float64 ungapped penalty is at
        # most the cheapest possible indel penalty — no gapped search happens.
        # Such candidate rows never need the banded kernel: their score IS the
        # ungapped penalty, exactly as the sequential engine would decide.
        # Only the remaining rows (possible indels, contig edges) go to the
        # device, as a compacted subtable.
        with self.tracer.span("engine.certificate"):
            geom = self._window_geometry(batch, table, shift)
            u_all = np.full(len(table), np.inf)
            ic_rows = np.nonzero(geom["in_contig"])[0]
            if ic_rows.shape[0]:
                u_all[ic_rows] = self._ungapped_penalties(reads, table, ic_rows)
            min_indel = min(
                p.get_starting_insertion_start_penalty() + p.insertion_extension_penalty,
                p.deletion_start_penalty + p.deletion_extension_penalty,
            )
            skip = geom["in_contig"] & ~geom["at_edge"] & (u_all <= min_indel)
            dev_rows = np.nonzero(~skip)[0]
        self.tracer.count("rows.device", dev_rows.shape[0])
        with self.tracer.span("engine.dispatch"):
            if dev_rows.shape[0]:
                sctx = self._dispatch_scores(reads, batch, table.take(dev_rows), shift, band)
            else:
                sctx = None
        return {
            "queries": queries,
            "batch": batch,
            "num_reads": num_reads,
            "table": table,
            "geom": geom,
            "u_all": u_all,
            "skip": skip,
            "dev_rows": dev_rows,
            "sctx": sctx,
            "band": band,
        }

    def _window_geometry(self, batch, table, shift):
        """Integer window geometry per candidate row (shared by the dispatch
        certificate and the decision stage)."""
        _, _, seq_lengths = _tables(self.database)
        n_per_cand = batch.lengths[table.read_id]
        shift_per_cand = shift[table.read_id]
        contig_len = seq_lengths[table.ref_seq_index]
        win_start_local = np.maximum(0, table.offset - shift_per_cand)
        win_end_local = np.minimum(
            contig_len, table.offset + n_per_cand + shift_per_cand
        )
        return {
            "n_per_cand": n_per_cand,
            "valid": win_end_local > win_start_local,
            "at_edge": (table.offset - shift_per_cand < 0)
            | (table.offset + n_per_cand + shift_per_cand > contig_len),
            "in_contig": (table.offset >= 0)
            & (table.offset + n_per_cand <= contig_len),
        }

    def _dispatch_scores(self, seqs, batch, table, shift, band, budget_len=None):
        """Candidate-window construction + asynchronous device scoring for one
        candidate table.  `seqs` holds one Sequence per batch read id; `shift`
        is the per-read half-window (int64[num_reads]); `budget_len` optionally
        carries a per-table-row effective budget length (pair total length for
        paired rows) consumed by the native scoring branch.  Returns a context
        to be materialized by _finish_scores."""
        p = self.parameters
        num_reads = batch.num_reads
        seq_starts = self.seq_db.starts
        _, _, seq_lengths = _tables(self.database)
        n_per_cand = batch.lengths[table.read_id]
        shift_per_cand = shift[table.read_id]
        contig_len = seq_lengths[table.ref_seq_index]

        win_start_local = np.maximum(0, table.offset - shift_per_cand)
        win_end_local = np.minimum(contig_len, table.offset + n_per_cand + shift_per_cand)
        valid = win_end_local > win_start_local
        # edge candidates (clamped windows touching contig bounds) use the
        # sequential path for exact contig-edge economics
        at_edge = (table.offset - shift_per_cand < 0) | (
            table.offset + n_per_cand + shift_per_cand > contig_len
        )

        # the read width is bucketed to 64s; it picks the int16/f32 kernel
        lq = -(-int(batch.lengths.max()) // 64) * 64
        num_cands = len(table)
        in_contig = (table.offset >= 0) & (table.offset + n_per_cand <= contig_len)
        win_start_global = seq_starts[table.ref_seq_index] + win_start_local
        w_len = (win_end_local - win_start_local).astype(np.int64)
        lane = (table.offset - win_start_local).astype(np.int64)

        # MAPPER_TPU_HOST_SCORING=1 scores short reads with the OpenMP native
        # exact DP on the host (f64, full local_align semantics) instead of
        # the kernel; long reads keep the kernel, where the banded O(n*band)
        # DP beats the host's full O(n*w) one.  A mesh always scores on its
        # devices, as in the JAX engine
        if (
            self.mesh is None
            and os.environ.get("MAPPER_TPU_HOST_SCORING") == "1"
            and int(batch.lengths.max(initial=0)) <= HOST_SCORING_MAX_LEN
        ):
            sctx = self._dispatch_scores_native(
                seqs, batch, table, n_per_cand, win_start_local, win_end_local,
                valid, at_edge, in_contig, win_start_global, w_len, lane, lq,
                budget_len=budget_len,
            )
            if sctx is not None:
                return sctx

        # fused gathered scoring: the reference lives on the device; the
        # forward read matrix and O(candidates) index vectors go up, one
        # [2, B] result comes back
        q_mat = np.zeros((num_reads, lq), dtype=np.uint8)
        for r, seq in enumerate(seqs):
            q_mat[r, : len(seq)] = seq.codes
        vectors = (
            table.read_id.astype(np.int64),
            table.reversed_.astype(bool),
            win_start_global.astype(np.int64),
            lane,
            n_per_cand.astype(np.int32),
            w_len.astype(np.int32),
        )
        if self.mesh is None:
            dev = self.device
            out = banded_scores_gathered(
                _upload(q_mat, dev), self._concat_device(), *(_upload(v, dev) for v in vectors),
                p, band,
            )
        else:
            # each mesh device gets the chunk's read matrix once and its own
            # copy of the reference; the candidate vectors shard over the mesh
            (reads,) = replicate(self.mesh, q_mat)
            refs = [self._concat_device(d) for d in self.mesh]
            out = banded_scores_gathered(reads, refs, *vectors, p, band, mesh=self.mesh)
        if out.is_cuda:
            # copy back into pinned memory without blocking the host; the
            # finish stage waits on the event (with a mesh, the current
            # stream has already joined every shard's)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(out.device))
        else:
            host, done = out, None
        return {
            "scores_host": host,
            "scores_done": done,
            "lane": lane,
            "in_contig": in_contig,
            "num_cands": num_cands,
            "band": band,
        }

    def _dispatch_scores_native(
        self, seqs, batch, table, n_per_cand, win_start_local, win_end_local,
        valid, at_edge, in_contig, win_start_global, w_len, lane, lq,
        budget_len=None,
    ):
        """Score the candidate windows with the OpenMP native exact DP
        (dp.cpp::mapper_local_align_batch) instead of a device program:
        returns a finished sctx {"host_scored": (ungapped, banded)} or None
        when the native library is unavailable / bails.  `banded` is the
        exact local_align penalty of each window (f64; inf when over budget
        or invalid), which is the quantity the f32 kernel approximates —
        straight rows reproduce the exact ungapped penalty bit-for-bit
        (same -ffp-contract=off sums as numpy), so the banded==ungapped
        clean-emission test behaves identically."""
        from mapper_tpu_torch.native import get_library, native_local_align_batch

        if get_library() is None:
            return None
        p = self.parameters
        k = len(table)
        _, _, seq_lengths = _tables(self.database)
        contig_len = seq_lengths[table.ref_seq_index]

        banded = np.full(k, np.inf)
        run = np.nonzero(valid & (w_len > 0) & (n_per_cand > 0))[0]
        if run.shape[0]:
            # per-row query codes (forward / reverse-complement)
            rev_rows = table.reversed_[run]
            rid = table.read_id[run]
            n_run = n_per_cand[run].astype(np.int32)
            q_off = np.zeros(run.shape[0], dtype=np.int64)
            np.cumsum(n_run[:-1], out=q_off[1:])
            qbuf = np.empty(int(n_run.sum()), dtype=np.uint8)
            rc_cache: dict[int, np.ndarray] = {}
            for j in range(run.shape[0]):
                r = int(rid[j])
                if rev_rows[j]:
                    codes = rc_cache.get(r)
                    if codes is None:
                        codes = basepairs.reverse_complement(seqs[r].codes)
                        rc_cache[r] = codes
                else:
                    codes = seqs[r].codes
                qbuf[q_off[j] : q_off[j] + n_run[j]] = codes

            # window codes gathered from the host concat
            w_run = w_len[run].astype(np.int32)
            w_off = np.zeros(run.shape[0], dtype=np.int64)
            np.cumsum(w_run[:-1], out=w_off[1:])
            lw_max = int(w_run.max(initial=1))
            w_idx = win_start_global[run][:, None] + np.arange(lw_max, dtype=np.int64)
            w_idx = np.minimum(w_idx, self.concat.shape[0] - 1)
            w_mat = self.concat[w_idx]
            wbuf = np.empty(int(w_run.sum()), dtype=np.uint8)
            for j in range(run.shape[0]):
                wbuf[w_off[j] : w_off[j] + w_run[j]] = w_mat[j, : w_run[j]]

            nf = n_run.astype(np.float64)
            max_allowed = np.nextafter(nf * p.max_error_rate, np.inf)
            rates = max_allowed / nf
            bump = rates * nf < max_allowed
            rates[bump] = np.nextafter(rates[bump], np.inf)

            rs_loc = win_start_local[run].astype(np.int64)
            pred = np.clip(lane[run], 0, np.maximum(w_run - 1, 0)).astype(np.int32)
            at_s = (win_start_local[run] == 0).astype(np.uint8)
            at_e = (win_end_local[run] == contig_len[run]).astype(np.uint8)
            out = native_local_align_batch(
                qbuf,
                q_off,
                n_run,
                wbuf,
                w_off,
                w_run,
                rs_loc,
                pred,
                at_s,
                at_e,
                np.ones(run.shape[0], dtype=np.uint8),
                rates,
                p,
            )
            if out is None:
                return None
            status, nblocks, blocks, total, aligned = out
            if np.any(status == -2):
                return None  # native bailed on a problem: use the device path
            banded[run] = np.where(status >= 0, total, np.inf)

            # second pass for paired rows: the exact pair algebra can grant
            # one mate nearly the whole PAIR budget
            # (QueryMatch_Aligner.java:207-239), and the mate-level cap above
            # would inf-out combos the worker accepts (measured: 7/4096 hard
            # pairs emitted affirmatively empty).  Only rows the first pass
            # rejected (-1) rerun with the pair-level budget — any alignment
            # the first pass FOUND is the global optimum for larger budgets
            # too (an alignment with total <= small budget lies inside the
            # small search space by the extension-cap algebra), so the cheap
            # pass answers for the overwhelming clean majority.
            if budget_len is not None:
                bf = budget_len[run].astype(np.float64)
                redo = np.nonzero((status == -1) & (bf > nf))[0]
                if redo.shape[0]:
                    max2 = np.nextafter(bf[redo] * p.max_error_rate, np.inf)
                    rates2 = max2 / nf[redo]
                    bump2 = rates2 * nf[redo] < max2
                    rates2[bump2] = np.nextafter(rates2[bump2], np.inf)
                    out2 = native_local_align_batch(
                        qbuf,
                        q_off[redo],
                        n_run[redo],
                        wbuf,
                        w_off[redo],
                        w_run[redo],
                        rs_loc[redo],
                        pred[redo],
                        at_s[redo],
                        at_e[redo],
                        np.ones(redo.shape[0], dtype=np.uint8),
                        rates2,
                        p,
                    )
                    if out2 is None:
                        return None
                    s2, _, _, t2, _ = out2
                    if np.any(s2 == -2):
                        return None
                    banded[run[redo]] = np.where(s2 >= 0, t2, np.inf)
            native_raw = {
                # per-slot raw results, reusable as gap-finalization wave-1
                # answers when the window geometry matches (subtable row ->
                # slot); see _finish_single_end's job construction
                "slot_of_row": {int(r): j for j, r in enumerate(run.tolist())},
                "status": status,
                "nblocks": nblocks,
                "blocks": blocks,
                "total": total,
                "aligned": aligned,
                "rs": win_start_local[run],
                "we": win_end_local[run],
            }
        else:
            native_raw = None

        ungapped = np.full(k, np.inf)
        ic = np.nonzero(in_contig)[0]
        if ic.shape[0]:
            ungapped[ic] = self._ungapped_penalties(seqs, table, ic)
        return {"host_scored": (ungapped, banded), "native_raw": native_raw}

    def _use_device_candidates(self) -> bool:
        """The fused device-candidates path is opt-in
        (MAPPER_TPU_DEVICE_CANDIDATES=1 or device_candidates=True), as in the
        JAX engine: it gives the host path's results and moves the host
        candidate pass onto the device."""
        if self.device_candidates is not None:
            return self.device_candidates
        return os.environ.get("MAPPER_TPU_DEVICE_CANDIDATES") == "1"

    def _concat_device(self, device: torch.device | None = None) -> torch.Tensor:
        """The concatenated reference codes on `device` (default
        `self.device`), uploaded once per device (under a lock: pool threads
        share the engine)."""
        device = self.device if device is None else device
        with self._upload_lock:
            if device not in self._concat_devs:
                self._concat_devs[device] = upload_reference(self.concat, device)
            return self._concat_devs[device]

    def _finish_scores(self, sctx):
        """Materialize the scores of a _dispatch_scores context: (ungapped,
        banded) float64 arrays per candidate row."""
        if "host_scored" in sctx:
            return sctx["host_scored"]
        if sctx["scores_done"] is not None:
            sctx["scores_done"].synchronize()
        out = sctx["scores_host"].numpy().astype(np.float64)
        k = sctx["num_cands"]
        banded = out[0, :k]
        ung = out[1, :k]
        lane = sctx["lane"]
        band = sctx["band"]
        # the voted offset's diagonal is band lane (offset - window start)
        lane_valid = (lane >= 0) & (lane < band)
        ungapped = np.where(sctx["in_contig"] & lane_valid, ung, np.inf)
        return ungapped, banded

    # ---- exact-DP finalization for isolated gapped winners ----------
    # A read whose single emitted candidate wins with an indel only needs
    # a traceback the banded kernel does not produce; running the
    # sequential engine's own per-candidate driver (QueryMatchAligner
    # .align on the voted position — identical window geometry, budgets,
    # tie rules) yields the alignment the exact path would emit at
    # ~1/100th of the full worker's per-read cost (the worker re-walks
    # the pyramid in Python; BENCH.md "Hard data").  Gated to reads whose
    # decision is robust against kernel f32 error: a unique emitted row
    # with margin, comfortably under the accept threshold, interior to
    # the contig, inside the certified band.  The native batch route runs
    # the identical algebra with the local_align core batched across
    # reads (two OpenMP waves: base alignments, then offset-invariance
    # probes); _finalize_one_gap_job_python is the oracle fallback.

    def _finalize_gap_jobs(self, jobs, results, best_per_read, gap_margin):
        import os as _os

        if _os.environ.get("MAPPER_TPU_NATIVE", "1") != "0":
            from mapper_tpu_torch.native import get_library

            if get_library() is not None:
                self._finalize_gap_jobs_native(jobs, results, best_per_read, gap_margin)
                return
        for job in jobs:
            self._finalize_one_gap_job_python(job, results, best_per_read, gap_margin)

    def _finalize_one_gap_job_python(self, job, results, best_per_read, gap_margin):
        """The per-read sequential-driver finalization (semantic oracle for
        the batched native route below)."""
        from mapper_tpu_torch.align.candidates import QueryMatch, SequenceMatch
        from mapper_tpu_torch.align.query_aligner import QueryMatchAligner

        p = self.parameters
        r = job["r"]
        query, seq_a, ref, o = job["query"], job["seq_a"], job["ref"], job["o"]
        qma = QueryMatchAligner(query, p, self.reference_index)
        qa = qma.align(QueryMatch([SequenceMatch(seq_a, ref, o, True)], 1))
        if qa is None:
            return
        choices = qma.get_best_alignments()
        # the exact result must corroborate the kernel's decision
        if len(choices) != 1 or abs(choices[0].get_penalty() - best_per_read[r]) > gap_margin:
            return
        # equal-penalty tracebacks are offset-sensitive (the predicted
        # diagonal steers PathAligner's tie-breaking).  Emit only if every
        # plausible predicted offset — the other vote rows of this locus and
        # the alignment's own gapless-run diagonals — reproduces the
        # identical alignment.
        offsets = set(job["locus"])
        comp = choices[0].get_component(0)
        for s in comp.sections:
            if s.length_a == s.length_b and s.length_a > 0:
                offsets.add(int(s.start_b - s.start_a))
        offsets.discard(o)
        key0 = choices[0].content_key()
        pen0 = choices[0].get_penalty()
        for o2 in offsets:
            alt = QueryMatchAligner(query, p, self.reference_index).align(
                QueryMatch([SequenceMatch(seq_a, ref, o2, True)], 1)
            )
            if alt is None or alt.content_key() != key0 or alt.get_penalty() != pen0:
                return
        results[r] = QueryAlignments.single_component(query.get_sequences(), choices)

    def _run_local_align_wave(self, wave):
        """One batched native local_align call.  wave: list of
        (seq_a, ref, o, rate) tuples.  Returns (status, nblocks, blocks,
        total, aligned, r_starts) or None when the library bails."""
        from mapper_tpu_torch.native import native_local_align_batch

        p = self.parameters
        k = len(wave)
        qparts = []
        wparts = []
        q_off = np.empty(k, dtype=np.int64)
        q_len = np.empty(k, dtype=np.int32)
        w_off = np.empty(k, dtype=np.int64)
        w_len = np.empty(k, dtype=np.int32)
        r_starts = np.empty(k, dtype=np.int64)
        preds = np.empty(k, dtype=np.int32)
        at_s = np.empty(k, dtype=np.uint8)
        at_e = np.empty(k, dtype=np.uint8)
        rates = np.empty(k, dtype=np.float64)
        qo = wo = 0
        for i, (seq_a, ref, o, rate) in enumerate(wave):
            n = len(seq_a)
            mi = n * rate
            max_indel = int(
                max(
                    0.0,
                    (mi - p.deletion_start_penalty) / p.deletion_extension_penalty,
                )
            )
            rs = max(0, o - max_indel)
            re_ = min(o + n + max_indel, len(ref))
            qparts.append(seq_a.codes)
            wparts.append(ref.codes[rs:re_])
            q_off[i] = qo
            q_len[i] = n
            w_off[i] = wo
            w_len[i] = re_ - rs
            r_starts[i] = rs
            preds[i] = o - rs
            at_s[i] = rs == 0
            at_e[i] = re_ == len(ref)
            rates[i] = rate
            qo += n
            wo += re_ - rs
        out = native_local_align_batch(
            np.concatenate(qparts),
            q_off,
            q_len,
            np.concatenate(wparts),
            w_off,
            w_len,
            r_starts,
            preds,
            at_s,
            at_e,
            np.ones(k, dtype=np.uint8),
            rates,
            p,
        )
        if out is None:
            return None
        return (*out, r_starts)

    def _finalize_gap_jobs_native(self, jobs, results, best_per_read, gap_margin):
        """Batched finalization: wave 1 aligns every job's voted position,
        Python-scalar replication of the driver's accept algebra filters,
        wave 2 runs all offset-invariance probes, winners are materialized
        from the native block arrays.  Bit-identical to
        _finalize_one_gap_job_python (pinned by tests)."""
        import math

        p = self.parameters
        R = p.max_error_rate
        span = p.max_penalty_span

        def dru(a, b):
            res = a / b
            if res * b < a:
                res = math.nextafter(res, math.inf)
            return res

        # the driver's per-call rate: _do_align's single-component budget
        # (max_allowed = nextUp(n*R); average_rate = divideRoundUp(max_allowed, n))
        for job in jobs:
            n = len(job["seq_a"])
            job["n"] = n
            job["max_allowed"] = math.nextafter(n * R, math.inf)
            job["rate"] = dru(job["max_allowed"], n)

        # wave 1: jobs whose exact-DP answer was already computed by the
        # host-scoring pass carry it in job["pre"]; only the rest align here
        need = [j for j in jobs if "pre" not in j]
        if need:
            wave1 = [(j["seq_a"], j["ref"], j["o"], j["rate"]) for j in need]
            out = self._run_local_align_wave(wave1)
            if out is None:
                for job in jobs:
                    self._finalize_one_gap_job_python(
                        job, results, best_per_read, gap_margin
                    )
                return
            status_n, nblocks_n, blocks_n, total_n, aligned_n, r_starts_n = out
            for i, job in enumerate(need):
                job["pre"] = (
                    int(status_n[i]),
                    int(nblocks_n[i]),
                    blocks_n[i],
                    float(total_n[i]),
                    float(aligned_n[i]),
                    int(r_starts_n[i]),
                )

        survivors = []
        probes = []  # (job, o2)
        for i, job in enumerate(jobs):
            st, nb_pre, blocks_pre, total_pre, aligned_pre, rs_pre = job["pre"]
            if st == -2:  # native bailed: per-read oracle decides
                self._finalize_one_gap_job_python(job, results, best_per_read, gap_margin)
                continue
            if st == -1:
                continue  # align() returned None
            pen = total_pre
            if pen > job["max_allowed"]:
                continue  # _do_align's final accept check failed
            # get_best_alignments: cutoff = min(best+span, n*rate_now) with
            # rate_now tightened by align() after this (single) alignment
            new_rate = dru(pen + span, job["n"])
            rate_now = new_rate if new_rate < R else R
            cutoff = min(pen + span, job["n"] * rate_now)
            if pen > cutoff:
                continue  # choices empty
            if abs(pen - best_per_read[job["r"]]) > gap_margin:
                continue
            nb = nb_pre
            rs = int(rs_pre)
            abs_blocks = tuple(
                (sa, rs + sb, la, lb) for sa, sb, la, lb in blocks_pre[:nb].tolist()
            )
            offsets = set(job["locus"])
            for sa, sb_abs, la, lb in abs_blocks:
                if la == lb and la > 0:
                    offsets.add(sb_abs - sa)
            offsets.discard(job["o"])
            job["pen0"] = pen
            job["aligned0"] = aligned_pre
            job["blocks0"] = abs_blocks
            job["status0"] = st
            job["pending"] = len(offsets)
            job["ok"] = True
            survivors.append(job)
            for o2 in sorted(offsets):
                probes.append((job, o2))

        if probes:
            wave2 = [(j["seq_a"], j["ref"], o2, j["rate"]) for j, o2 in probes]
            out2 = self._run_local_align_wave(wave2)
            if out2 is None:
                for job in {id(j): j for j, _ in probes}.values():
                    job["ok"] = False
                    self._finalize_one_gap_job_python(
                        job, results, best_per_read, gap_margin
                    )
                survivors = [j for j in survivors if j.get("ok", False)]
            else:
                s2, nb2, bl2, tot2, al2, rs2 = out2
                for i, (job, o2) in enumerate(probes):
                    if not job["ok"]:
                        continue
                    st2 = int(s2[i])
                    if st2 == -2:
                        # could not verify natively: oracle decides the read
                        job["ok"] = False
                        self._finalize_one_gap_job_python(
                            job, results, best_per_read, gap_margin
                        )
                        continue
                    if st2 == -1 or float(tot2[i]) > job["max_allowed"]:
                        job["ok"] = False  # alt is None
                        continue
                    if float(tot2[i]) != job["pen0"]:
                        job["ok"] = False
                        continue
                    rsp = int(rs2[i])
                    alt_blocks = tuple(
                        (sa, rsp + sb, la, lb)
                        for sa, sb, la, lb in bl2[i, : int(nb2[i])].tolist()
                    )
                    if alt_blocks != job["blocks0"]:
                        job["ok"] = False

        from mapper_tpu_torch.align.blocks import SequenceAlignment

        for job in survivors:
            if not job["ok"]:
                continue
            seq_a, ref = job["seq_a"], job["ref"]
            sections = [
                AlignedBlock(seq_a, ref, sa, sb_abs, la, lb)
                for sa, sb_abs, la, lb in job["blocks0"]
            ]
            component = SequenceAlignment(
                sections, job["rev"], job["pen0"], job["aligned0"]
            )
            qa = QueryAlignment([component], 0.0, 1.0, 0.0, job["pen0"], 0)
            results[job["r"]] = QueryAlignments.single_component(
                job["query"].get_sequences(), [qa]
            )

    def _materialize_rows(self, seq, rows):
        """Build the QueryAlignment choices for columnar emission rows
        ((reversed, ref_sequence, offset, penalty) per choice) — exactly what
        the eager emission loop built; rows were pre-checked in-contig and
        gated non-ancestral (the ancestral path materializes eagerly via
        _make_ungapped_component)."""
        from mapper_tpu_torch.align.blocks import SequenceAlignment

        n = len(seq)
        choices = []
        for rev, ref, off, pen in rows:
            seq_a = seq.reverse_complement() if rev else seq
            block = AlignedBlock(seq_a, ref, 0, off, n, n)
            reversed_flag = seq_a.complemented_from is not None
            alignment = SequenceAlignment([block], reversed_flag, pen, pen)
            choices.append(QueryAlignment(alignment))
        return choices

    def _materialize_lazy_rows(self, lazy):
        """LazyUngappedAlignments materializer (bound per engine)."""
        return self._materialize_rows(lazy.query_sequences[0], lazy.rows)

    def _finish_single_end(self, ctx) -> list[QueryAlignments | None]:
        """Materialize one chunk's device scores and make the per-read
        decisions (second pipeline stage)."""
        if isinstance(ctx, list):  # empty-candidate chunk resolved at dispatch
            return ctx
        p = self.parameters
        queries = ctx["queries"]
        batch = ctx["batch"]
        num_reads = ctx["num_reads"]

        if "fused" in ctx:
            with self.tracer.span("engine.fetch"):
                table, fallback_ids, banded, ung_raw = ctx["fused"]()
            # the fused program keeps and scores every candidate row
            self.tracer.count("rows.candidates", len(table))
            self.tracer.count("rows.device", len(table))
            # replay the device's integer window geometry in numpy
            geom = self._window_geometry(batch, table, ctx["shift"])
            valid = geom["valid"]
            at_edge = geom["at_edge"]
            n_per_cand = geom["n_per_cand"]
            win_start_local = np.maximum(0, table.offset - ctx["shift"][table.read_id])
            lane = (table.offset - win_start_local).astype(np.int64)
            lane_valid = (lane >= 0) & (lane < ctx["band"])
            ungapped = np.where(geom["in_contig"] & lane_valid, ung_raw, np.inf)
            if len(fallback_ids):
                fallback_reads = np.zeros(num_reads, dtype=bool)
                fallback_reads[fallback_ids] = True
            else:
                fallback_reads = None
            fused_mask = fallback_reads
            pens_lookup = None
        else:
            table = ctx["table"]
            geom = ctx["geom"]
            valid = geom["valid"]
            at_edge = geom["at_edge"]
            n_per_cand = geom["n_per_cand"]
            fallback_reads = None
            fused_mask = None
            pens_lookup = ctx["u_all"]
            # certificate rows scored on host (score == exact ungapped, clean
            # by construction); device rows filled from the compacted call
            ungapped = np.where(ctx["skip"], pens_lookup, np.inf)
            banded = ungapped.copy()
            if ctx["sctx"] is not None:
                with self.tracer.span("engine.fetch"):
                    d_ung, d_banded = self._finish_scores(ctx["sctx"])
                ungapped[ctx["dev_rows"]] = d_ung
                banded[ctx["dev_rows"]] = d_banded
        with self.tracer.span("engine.decide") as decide:
            # wide-band gate (the single-end analog of the paired path's
            # certified_pair): a read whose indel budget exceeds the banded
            # window's reach could have an out-of-band indel alignment the kernel
            # cannot see.  Any alignment the band cannot represent carries a
            # cumulative indel length > band//2, so its penalty is at least
            # indel_start + extension*(band//2 + 1); a read whose best in-contig
            # ungapped penalty keeps the whole emission window strictly below
            # that bound is sound regardless (in practice the kernel's cheap
            # in-band insertions already defer shifted reads — this makes the
            # argument airtight instead of probabilistic).  Others go to the
            # exact worker.
            band = ctx["band"]
            max_indel_read = np.maximum(
                0,
                (
                    (batch.lengths * p.max_error_rate - p.deletion_start_penalty)
                    / p.deletion_extension_penalty
                ).astype(np.int64),
            )
            wide = max_indel_read > band // 2
            if np.any(wide):
                out_band_min = min(
                    p.get_starting_insertion_start_penalty()
                    + p.insertion_extension_penalty * (band // 2 + 1),
                    p.deletion_start_penalty
                    + p.deletion_extension_penalty * (band // 2 + 1),
                )
                best_u = np.full(num_reads, np.inf)
                np.minimum.at(best_u, table.read_id, ungapped)
                sound = best_u + p.max_penalty_span + EPS < out_band_min
                wide_fallback = wide & ~sound
                if fallback_reads is None:
                    fallback_reads = wide_fallback
                else:
                    fallback_reads = fallback_reads | wide_fallback
            else:
                wide_fallback = None
            # --- per-read decisions (vectorized over the candidate table) ----
            max_allowed = np.nextafter(n_per_cand * p.max_error_rate, np.inf)
            score = np.where(valid, np.minimum(banded, ungapped), np.inf)
            viable = score <= max_allowed + EPS

            order = np.argsort(table.read_id, kind="stable")
            read_sorted = table.read_id[order]
            score_sorted = np.where(viable, score, np.inf)[order]
            boundaries = np.searchsorted(read_sorted, np.arange(num_reads + 1))
            starts, ends = boundaries[:-1], boundaries[1:]
            nonempty = starts < ends

            best_per_read = np.full(num_reads, np.inf)
            if order.shape[0]:
                safe_starts = np.minimum(starts, order.shape[0] - 1)
                reduced = np.minimum.reduceat(score_sorted, safe_starts)
                best_per_read = np.where(nonempty, reduced, np.inf)

            read_max_allowed = np.nextafter(batch.lengths * p.max_error_rate, np.inf)
            cutoff_per_read = np.minimum(
                best_per_read + p.max_penalty_span, read_max_allowed
            )
            emit = viable & (score <= cutoff_per_read[table.read_id] + EPS)
            # reads whose emit set needs anything but clean ungapped emission go to
            # the exact path
            bad = emit & (at_edge | (banded < ungapped - EPS))
            bad_reads = np.zeros(num_reads, dtype=bool)
            bad_reads[table.read_id[bad]] = True
            emit_counts = np.bincount(table.read_id[emit], minlength=num_reads)

            results: list[QueryAlignments | None] = [None] * num_reads

            # ---- exact-DP finalization for isolated gapped winners ----------
            # A read whose single emitted candidate wins with an indel only needs
            # a traceback the banded kernel does not produce; running the
            # sequential engine's own per-candidate driver (QueryMatchAligner
            # .align on the voted position — identical window geometry, budgets,
            # tie rules) yields the alignment the exact path would emit at
            # ~1/100th of the full worker's per-read cost (the worker re-walks
            # the pyramid in Python; BENCH.md "Hard data").  Gated to reads whose
            # decision is robust against kernel f32 error: a unique emitted row
            # with margin, comfortably under the accept threshold, interior to
            # the contig, inside the certified band.
            GAP_MARGIN = 0.05
            reason_map: dict[int, str] = {}
            gap_reads = bad_reads & (best_per_read <= read_max_allowed - GAP_MARGIN)
            if fallback_reads is not None:
                gap_reads &= ~fallback_reads
            if np.any(gap_reads):
                # host-scored chunks already ran the exact DP on every dev row
                # with wave-1-identical inputs (same window, rate, prediction);
                # map full-table row -> raw-result slot so jobs can skip wave 1
                native_raw = None
                full_slot = None
                sctx0 = ctx.get("sctx")
                if sctx0 is not None and sctx0.get("native_raw") is not None:
                    native_raw = sctx0["native_raw"]
                    dev_rows_arr = ctx["dev_rows"]
                    full_slot = {
                        int(dev_rows_arr[sub]): slot
                        for sub, slot in native_raw["slot_of_row"].items()
                    }
                margin_row = viable & (
                    score <= best_per_read[table.read_id] + p.max_penalty_span + GAP_MARGIN
                )
                jobs = []
                for r in np.nonzero(gap_reads)[0].tolist():
                    # all competitive rows must form ONE locus (same strand and
                    # contig, offsets within the indel budget of each other —
                    # an indel read's seeds legitimately vote 2+ neighboring
                    # diagonals of the same placement) with no contig-edge row
                    all_rows = order[starts[r] : ends[r]].tolist()
                    # edge candidates' kernel scores are clamped-window
                    # approximations — a within-span soft-clip alternative could
                    # hide behind an overestimate, so any edge row at all keeps
                    # the full worker path (it owns contig-edge economics)
                    if any(at_edge[rr] for rr in all_rows):
                        reason_map[r] = "gap_edge"
                        continue
                    rows_r = [int(rr) for rr in all_rows if margin_row[rr]]
                    if not rows_r:
                        reason_map[r] = "gap_nomargin"
                        continue
                    mi = int(max_indel_read[r])
                    offs = [int(table.offset[rr]) for rr in rows_r]
                    if (
                        len({(bool(table.reversed_[rr]), int(table.ref_seq_index[rr])) for rr in rows_r}) > 1
                        or max(offs) - min(offs) > mi
                    ):
                        reason_map[r] = "gap_multilocus"
                        continue
                    c = min(rows_r, key=lambda rr: (score[rr], rr))
                    seqidx = int(table.ref_seq_index[c])
                    ref, original = self._ref_and_original(seqidx)
                    if original is not ref:
                        reason_map[r] = "gap_ancestral"
                        continue  # ancestral rewrite: keep the full worker path
                    query = queries[r]
                    seq = query.get_sequence(0)
                    rev = bool(table.reversed_[c])
                    seq_a = seq.reverse_complement() if rev else seq
                    o = int(table.offset[c])
                    # plausible alternative predicted offsets from the OTHER vote
                    # rows of this locus (the sequential engine can vote a
                    # neighboring diagonal of the same placement); the winning
                    # alignment's own gapless-run diagonals join the set after
                    # the base alignment is known
                    locus_offsets = set()
                    for rr in all_rows:
                        if (
                            bool(table.reversed_[rr]) == rev
                            and int(table.ref_seq_index[rr]) == seqidx
                            and abs(int(table.offset[rr]) - o) <= mi
                        ):
                            locus_offsets.add(int(table.offset[rr]))
                    job = {
                        "r": r,
                        "query": query,
                        "seq_a": seq_a,
                        "ref": ref,
                        "o": o,
                        "rev": rev,
                        "locus": locus_offsets,
                    }
                    if full_slot is not None and c in full_slot:
                        # reuse the scoring pass's exact-DP result as wave 1 when
                        # the wave's window geometry reproduces the scoring one
                        # (nextUp rounding can shift max_indel by 1 in edge cases;
                        # compare the actual window bounds)
                        import math as _math

                        slot = full_slot[c]
                        n_j = len(seq_a)
                        ma = _math.nextafter(n_j * p.max_error_rate, _math.inf)
                        rate_j = ma / n_j
                        if rate_j * n_j < ma:
                            rate_j = _math.nextafter(rate_j, _math.inf)
                        mi_w = int(
                            max(
                                0.0,
                                (n_j * rate_j - p.deletion_start_penalty)
                                / p.deletion_extension_penalty,
                            )
                        )
                        rs_w = max(0, o - mi_w)
                        re_w = min(o + n_j + mi_w, len(ref))
                        if (
                            rs_w == int(native_raw["rs"][slot])
                            and re_w == int(native_raw["we"][slot])
                        ):
                            job["pre"] = (
                                int(native_raw["status"][slot]),
                                int(native_raw["nblocks"][slot]),
                                native_raw["blocks"][slot],
                                float(native_raw["total"][slot]),
                                float(native_raw["aligned"][slot]),
                                rs_w,
                            )
                    jobs.append(job)
                if jobs:
                    self._finalize_gap_jobs(jobs, results, best_per_read, GAP_MARGIN)
            emit_sorted = emit[order]
            eligible = nonempty & ~bad_reads & (emit_counts > 0)
            if fallback_reads is not None:
                eligible &= ~fallback_reads
            # batched exact float64 penalties for every emitted row of eligible
            # reads (one vectorized pass instead of per-read block sums)
            rows_flat = order[emit_sorted & eligible[read_sorted]]
            reads = [q.get_sequence(0) for q in queries]
            if pens_lookup is not None:
                # eligible emitted rows are in-contig (off-contig rows have
                # infinite ungapped, so emitting them flags the read bad), and the
                # dispatch stage already computed their exact float64 penalties
                pens_flat = pens_lookup[rows_flat]
            else:
                pens_flat = self._ungapped_penalties(reads, table, rows_flat)
            rid_flat = table.read_id[rows_flat]
            ebounds = np.searchsorted(rid_flat, np.arange(num_reads + 1)).tolist()

            # plain-Python views of the per-row columns (numpy scalar extraction
            # in the loop costs more than the loop body)
            pens_list = pens_flat.tolist()
            rev_list = table.reversed_[rows_flat].tolist()
            seqidx_list = table.ref_seq_index[rows_flat].tolist()
            off_list = table.offset[rows_flat].tolist()
            allowed_list = read_max_allowed.tolist()
            counts_list = emit_counts.tolist()
            max_num_matches = p.max_num_matches

            dp_rid: list[int] = []
            dp_rev: list[bool] = []
            dp_seqidx: list[int] = []
            dp_off: list[int] = []
            # the CLI only attaches a DevicePileup when the run has no
            # ancestral->original rewrite, so presence alone gates the path
            take_device_pileup = self.device_pileup is not None
            from mapper_tpu_torch.align.blocks import LazyUngappedAlignments

            # vectorized in-contig recheck for all emitted rows (the per-row
            # branch cost more than the loop body), plus cached per-contig
            # (ref object, ancestral flag) lookups
            _, _, seq_lengths_all = _tables(self.database)
            n_flat = batch.lengths[rid_flat]
            off_flat_arr = table.offset[rows_flat]
            incontig_list = (
                (off_flat_arr >= 0)
                & (off_flat_arr + n_flat <= seq_lengths_all[table.ref_seq_index[rows_flat]])
            ).tolist()
            refs_cache = self._ref_objects()

            materialize = self._materialize_lazy_rows
            for r in np.nonzero(eligible)[0].tolist():
                query = queries[r]
                if counts_list[r] > max_num_matches:
                    results[r] = QueryAlignments.unaligned(query.get_sequences())
                    continue
                seq = reads[r]
                max_allowed_r = allowed_list[r]
                rows = []
                row_idx = []
                ok = True
                ancestral = False
                for c in range(ebounds[r], ebounds[r + 1]):
                    pen = pens_list[c]
                    # float64 recheck of the device-float32 accept
                    if pen > max_allowed_r:
                        ok = False
                        break
                    if not incontig_list[c]:
                        ok = False
                        break
                    seqidx = seqidx_list[c]
                    off = off_list[c]
                    ref, is_anc = refs_cache[seqidx]
                    if is_anc:
                        ancestral = True
                    rev = rev_list[c]
                    # dedup identical placements (different vote buckets): for
                    # full-length single-block rows the content key reduces to
                    # (reversed, contig, offset); first wins, as the eager
                    # content_key dedup did
                    if rows:
                        dup = False
                        for q in rows:
                            if q[0] == rev and q[1] is ref and q[2] == off:
                                dup = True
                                break
                        if dup:
                            continue
                    rows.append((rev, ref, off, pen))
                    row_idx.append(seqidx)
                if not ok:
                    continue
                if ancestral:
                    # ancestral->original rewrite needs sequence_b_history: keep
                    # the eager object path (rare)
                    choices = [
                        QueryAlignment(
                            self._make_ungapped_component(
                                seq.reverse_complement() if rev else seq,
                                row_idx[k],
                                off,
                                pen,
                            )
                        )
                        for k, (rev, _ref, off, pen) in enumerate(rows)
                    ]
                    result = QueryAlignments.single_component(
                        query.get_sequences(), choices
                    )
                else:
                    result = LazyUngappedAlignments(
                        query.get_sequences(), rows, materialize
                    )
                if take_device_pileup and len(rows) == 1:
                    # weight-1.0 clean ungapped emission: count it on the device
                    # (exact in f32; see batch/device_pileup.py) and flag the
                    # result so MatchDatabase skips its host accumulation
                    c0 = ebounds[r]
                    dp_rid.append(r)
                    dp_rev.append(rev_list[c0])
                    dp_seqidx.append(seqidx_list[c0])
                    dp_off.append(off_list[c0])
                    result.device_counted = True
                results[r] = result
            if dp_rid:
                rid_arr = np.array(dp_rid, dtype=np.int64)
                gstart = self.seq_db.starts[np.array(dp_seqidx, dtype=np.int64)] + np.array(
                    dp_off, dtype=np.int64
                )
                self.device_pileup.add_rows(
                    batch, rid_arr, np.array(dp_rev, dtype=bool), gstart, batch.lengths[rid_arr],
                    np.ones(len(dp_rid), dtype=np.float32),
                )
            # classify every read the batch path could not resolve (results[r] is
            # None -> the exact sequential worker owns it); counts feed
            # stats_fallback_reasons for perf diagnosis
            counts: dict[str, int] = {}
            for r in range(num_reads):
                if results[r] is not None:
                    continue
                if r in reason_map:
                    reason = reason_map[r]
                elif fused_mask is not None and fused_mask[r]:
                    reason = "kernel_bail"
                elif wide_fallback is not None and wide_fallback[r]:
                    reason = "wide_band"
                elif bad_reads[r]:
                    reason = "gap_dp_fail" if gap_reads[r] else "gap_margin"
                elif not nonempty[r]:
                    reason = "no_rows"
                elif emit_counts[r] == 0:
                    reason = "no_viable"
                else:
                    reason = "recheck_fail"
                counts[reason] = counts.get(reason, 0) + 1
            with self._stats_lock:  # pool threads share the engine
                reasons = self.stats_fallback_reasons
                for reason, c in counts.items():
                    reasons[reason] = reasons.get(reason, 0) + c
            if self.tracer.on:
                for reason, c in counts.items():
                    self.tracer.count(f"fallback.{reason}", c)
        if self.print_decide_seconds:
            print(f"[engine] decisions+emit: {decide.seconds:.3f}s", flush=True)
        return results


def _tables(database):
    from mapper_tpu_torch.batch.candidates import _strand_tables

    return _strand_tables(database)


# single-chip host-scoring read-length ceiling (see _dispatch_scores)
HOST_SCORING_MAX_LEN = int(os.environ.get("MAPPER_TPU_HOST_SCORING_MAX_LEN", "600"))
