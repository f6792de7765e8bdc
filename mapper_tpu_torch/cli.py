"""Command-line interface of the PyTorch port: `mapper_tpu.cli` with the
batch engine on a torch device.

Usage matches `python -m mapper_tpu` (and the reference jar):

    python -m mapper_tpu_torch --reference ref.fasta --queries reads.fastq \
        --out-sam out.sam --out-vcf out.vcf [options]

The batch engine runs on `MAPPER_TPU_TORCH_DEVICE` (default `cuda`; a run
asking for CUDA without a card exits with an error).  With
`MAPPER_TPU_DEVICE_PILEUP=1` and `--out-vcf` or `--out-mutations` (and no
`--infer-ancestors`), the clean ungapped alignments' pileup is accumulated
on that device (`batch/device_pileup.py`).  Argument helpers, writers and
detectors are the JAX package's own host code.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from mapper_tpu.align.cache import AlignmentCache
from mapper_tpu.align.params import AlignmentParameters
from mapper_tpu.align.worker import AlignerWorker
from mapper_tpu.api import ReferenceIndex
from mapper_tpu.cli import (
    DEFAULT_EXPECTED_PAIR_DISTANCE,
    DEFAULT_SPACING_DEVIATION,
    _INT_MAX,
    _parse_threshold_subflags,
    usage_error,
)
from mapper_tpu.index.database import (
    HashBlockDatabase,
    choose_max_duplication_length,
    choose_min_duplication_length,
)
from mapper_tpu.index.dircache import DirCache
from mapper_tpu.index.duplication import DuplicationDetector
from mapper_tpu.io import fastx
from mapper_tpu.io.mutations import MutationDetectionParameters, MutationsWriter
from mapper_tpu.io.refcounts import ReferenceAlignmentCounter, UnalignedQueryWriter
from mapper_tpu.io.sam import SamWriter
from mapper_tpu.io.vcf import VcfWriter
from mapper_tpu.pileup import MatchDatabase
from mapper_tpu.providers import (
    PairedEndQueryProvider,
    QueriesIterator,
    SimpleQueryProvider,
    SequenceSplitter,
)
from mapper_tpu.sequence import SequenceDatabase, sort_and_complement
from mapper_tpu.stats import (
    AlignmentCounter,
    DisplayTable,
    IndelSummarizer,
    PenaltySummarizer,
    format_histogram_column,
)


def main(argv: list[str] | None = None) -> int:
    start_time = time.time()
    args = list(sys.argv[1:] if argv is None else argv)

    reference_paths: list[str] = []
    query_providers = []
    cache_dir = None
    out_vcf_path = None
    out_sam_path = None
    out_unaligned_path = None
    out_ancestor_path = None
    enable_gapmers = True
    vcf_include_non_mutations = True
    vcf_show_support_read = True
    out_refs_map_count_path = None
    out_mutations_path = None
    mutation_filter = MutationDetectionParameters.default_filter()
    vcf_filter = MutationDetectionParameters.empty_filter()
    allow_no_output = False
    allow_duplicate_contig_names = False
    guess_reference_ancestors = False
    verify_consistent_database = False

    mutation_penalty = -1.0
    indel_start_penalty = 1.5
    indel_extension_penalty = 0.5
    additional_insertion_extension_penalty = -1.0
    max_error_rate = -1.0
    ambiguity_penalty = -1.0
    max_num_matches = None
    max_penalty_span = -1.0
    num_threads = 1
    query_end_fraction = 0.1
    split_queries_past_size = -1
    has_paired_without_spacing = False
    engine = "batch"  # "batch" = device pipeline with exact fallback; "exact" = sequential
    alignment_verbosity = 0
    reference_verbosity = 0
    auto_verbose = False

    i = 0
    while i < len(args):
        arg = args[i]
        if arg == "--reference":
            reference_paths.append(args[i + 1])
            i += 2
        elif arg == "--queries":
            provider = fastx.load_from(args[i + 1], keep_quality=True)
            if split_queries_past_size > 0:
                provider = SequenceSplitter(split_queries_past_size, provider)
            query_providers.append(SimpleQueryProvider(provider))
            i += 2
        elif arg == "--paired-queries":
            if split_queries_past_size > 0:
                usage_error("--paired-queries is not supported with --split-queries-past-size")
            lefts = fastx.load_from(args[i + 1], keep_quality=True)
            rights = fastx.load_from(args[i + 2], keep_quality=True)
            i += 3
            expected = DEFAULT_EXPECTED_PAIR_DISTANCE
            deviation = DEFAULT_SPACING_DEVIATION
            if i < len(args) and args[i] == "--spacing":
                expected = float(args[i + 1])
                deviation = float(args[i + 2])
                i += 3
            else:
                has_paired_without_spacing = True
            query_providers.append(PairedEndQueryProvider(lefts, rights, expected, deviation))
        elif arg == "--cache-dir":
            cache_dir = args[i + 1]
            i += 2
        elif arg == "--split-queries-past-size":
            if query_providers:
                usage_error("--split-queries-past-size is only supported before --queries")
            split_queries_past_size = int(args[i + 1])
            i += 2
        elif arg == "--out-vcf":
            out_vcf_path = args[i + 1]
            i = _parse_threshold_subflags(args, i + 2, vcf_filter)
        elif arg == "--out-mutations":
            out_mutations_path = args[i + 1]
            i = _parse_threshold_subflags(args, i + 2, mutation_filter)
        elif arg == "--out-sam":
            out_sam_path = args[i + 1]
            i += 2
        elif arg == "--out-unaligned":
            out_unaligned_path = args[i + 1]
            i += 2
        elif arg == "--out-refs-map-count":
            out_refs_map_count_path = args[i + 1]
            i += 2
        elif arg == "--out-ancestor":
            out_ancestor_path = args[i + 1]
            i += 2
        elif arg == "--no-gapmers":
            enable_gapmers = False
            i += 1
        elif arg == "--verify-consistent-db":
            verify_consistent_database = True
            i += 1
        elif arg == "--no-output":
            allow_no_output = True
            i += 1
        elif arg == "--allow-duplicate-contig-names":
            allow_duplicate_contig_names = True
            i += 1
        elif arg in ("--verbose", "-v"):
            # verbosity semantics per Mapper.java:261-281
            alignment_verbosity = max(alignment_verbosity, 1)
            i += 1
        elif arg == "--verbose-alignment":
            alignment_verbosity = max(alignment_verbosity, _INT_MAX)
            i += 1
        elif arg == "--verbose-reference":
            reference_verbosity = max(reference_verbosity, 1)
            i += 1
        elif arg == "-vv":
            alignment_verbosity = max(alignment_verbosity, _INT_MAX)
            reference_verbosity = max(reference_verbosity, 1)
            i += 1
        elif arg == "--verbosity-auto":
            auto_verbose = True
            i += 1
        elif arg == "--new-indel-penalty":
            indel_start_penalty = float(args[i + 1])
            i += 2
        elif arg == "--extend-indel-penalty":
            indel_extension_penalty = float(args[i + 1])
            i += 2
        elif arg == "--additional-extend-insertion-penalty":
            additional_insertion_extension_penalty = float(args[i + 1])
            i += 2
        elif arg == "--snp-penalty":
            mutation_penalty = float(args[i + 1])
            if mutation_penalty <= 0:
                usage_error("--snp-penalty must be > 0")
            i += 2
        elif arg == "--max-penalty":
            max_error_rate = float(args[i + 1])
            if max_error_rate < 0:
                usage_error("--max-penalty must be >= 0")
            i += 2
        elif arg == "--max-penalty-span":
            max_penalty_span = float(args[i + 1])
            if max_penalty_span < 0:
                usage_error("--max-penalty-span must be >= 0")
            i += 2
        elif arg == "--ambiguity-penalty":
            ambiguity_penalty = float(args[i + 1])
            if ambiguity_penalty < 0:
                usage_error("--ambiguity-penalty must be >= 0")
            i += 2
        elif arg == "--max-num-matches":
            max_num_matches = int(args[i + 1])
            if max_num_matches < 1:
                usage_error("--max-num-matches must be >= 1")
            i += 2
        elif arg == "--num-threads":
            num_threads = int(args[i + 1])
            i += 2
        elif arg in ("--num-processes", "--process-id", "--coordinator"):
            # multi-process runs come with the torch.distributed port
            single = {"--num-processes": "1", "--process-id": "0"}.get(arg)
            if args[i + 1] != single:
                usage_error(
                    f"{arg} {args[i + 1]}: multi-process runs are not supported "
                    "by mapper_tpu_torch yet"
                )
            i += 2
        elif arg == "--devices":
            # one device per run until multi-GPU scoring is ported
            if args[i + 1] not in ("auto", "1"):
                usage_error("--devices: only 'auto' and 1 are supported by mapper_tpu_torch yet")
            i += 2
        elif arg == "--engine":
            engine = args[i + 1]
            if engine not in ("batch", "exact"):
                usage_error("--engine must be 'batch' or 'exact'")
            i += 2
        elif arg == "--distinguish-query-ends":
            query_end_fraction = float(args[i + 1])
            i += 2
        elif arg == "--vcf-exclude-non-mutations":
            vcf_include_non_mutations = False
            i += 1
        elif arg == "--vcf-omit-support-reads":
            vcf_show_support_read = False
            i += 1
        elif arg == "--infer-ancestors":
            guess_reference_ancestors = True
            i += 1
        elif arg == "--no-infer-ancestors":
            guess_reference_ancestors = False
            i += 1
        elif arg == "--help":
            print(__doc__)
            return 0
        elif arg == "--version":
            from mapper_tpu_torch import __version__

            print("mapper_tpu_torch version " + __version__)
            if len(args) == 1:
                return 0
            i += 1
        else:
            usage_error(f"Unrecognized argument: {arg}")

    if not reference_paths:
        usage_error("--reference is required")
    if not query_providers:
        usage_error("--queries or --paired-queries is required")
    if (
        out_vcf_path is None
        and out_sam_path is None
        and out_refs_map_count_path is None
        and out_unaligned_path is None
        and out_mutations_path is None
        and not allow_no_output
    ):
        usage_error("No output specified. Try --out-vcf <path>, or --no-output")
    if max_error_rate >= 0 and mutation_penalty >= 0 and has_paired_without_spacing:
        usage_error(
            "Customized penalties with paired queries require explicit --spacing"
        )

    if max_error_rate < 0:
        max_error_rate = 0.1
    if mutation_penalty <= 0:
        mutation_penalty = 1.0
    if query_end_fraction < 0 or query_end_fraction >= 1:
        usage_error("--distinguish-query-ends must be >= 0 and < 1")

    parameters = AlignmentParameters.defaults(
        mutation_penalty=mutation_penalty,
        indel_start_penalty=indel_start_penalty,
        indel_extension_penalty=indel_extension_penalty,
        additional_insertion_extension_penalty=(
            None
            if additional_insertion_extension_penalty < 0
            else additional_insertion_extension_penalty
        ),
        max_error_rate=max_error_rate,
        ambiguity_penalty=None if ambiguity_penalty < 0 else ambiguity_penalty,
        max_num_matches=max_num_matches,
        max_penalty_span=None if max_penalty_span < 0 else max_penalty_span,
    )

    return run(
        engine=engine,
        alignment_verbosity=alignment_verbosity,
        reference_verbosity=reference_verbosity,
        auto_verbose=auto_verbose,
        reference_paths=reference_paths,
        query_providers=query_providers,
        cache_dir=cache_dir,
        allow_duplicate_contig_names=allow_duplicate_contig_names,
        out_vcf_path=out_vcf_path,
        vcf_include_non_mutations=vcf_include_non_mutations,
        vcf_show_support_read=vcf_show_support_read,
        out_sam_path=out_sam_path,
        out_refs_map_count_path=out_refs_map_count_path,
        out_mutations_path=out_mutations_path,
        mutation_filter=mutation_filter,
        vcf_filter=vcf_filter,
        out_unaligned_path=out_unaligned_path,
        parameters=parameters,
        num_threads=num_threads,
        query_end_fraction=query_end_fraction,
        guess_reference_ancestors=guess_reference_ancestors,
        out_ancestor_path=out_ancestor_path,
        enable_gapmers=enable_gapmers,
        verify_consistent_database=verify_consistent_database,
        start_time=start_time,
    )


def run(
    reference_paths,
    query_providers,
    engine,
    cache_dir,
    allow_duplicate_contig_names,
    out_vcf_path,
    vcf_include_non_mutations,
    vcf_show_support_read,
    out_sam_path,
    out_refs_map_count_path,
    out_mutations_path,
    mutation_filter,
    vcf_filter,
    out_unaligned_path,
    parameters,
    num_threads,
    query_end_fraction,
    guess_reference_ancestors,
    out_ancestor_path,
    enable_gapmers,
    verify_consistent_database,
    start_time,
    alignment_verbosity=0,
    reference_verbosity=0,
    auto_verbose=False,
) -> int:
    from mapper_tpu.logging import BufferedWriter, Logger, StderrWriter

    log = lambda message: print(message, file=sys.stderr)
    stderr_writer = StderrWriter()
    reference_logger = Logger(stderr_writer, 0, reference_verbosity)

    device = None
    if engine == "batch":
        import torch

        device = torch.device(os.environ.get("MAPPER_TPU_TORCH_DEVICE", "cuda"))
        if device.type == "cuda" and not torch.cuda.is_available():
            usage_error(
                f"MAPPER_TPU_TORCH_DEVICE={device}: no CUDA device is available "
                "(set MAPPER_TPU_TORCH_DEVICE=cpu to run the plain scorer on the host)"
            )

    log("Loading reference")
    reference_provider = fastx.load_from(reference_paths, keep_quality=False)
    sorted_reference = sort_and_complement(b.build() for b in reference_provider)
    sequence_database = SequenceDatabase(sorted_reference)
    if not allow_duplicate_contig_names:
        duplicates = sequence_database.get_duplicate_names()
        if duplicates:
            log(
                f" Warning: {len(duplicates)} contig names appear multiple times, "
                f"including {duplicates[0]}. Add --allow-duplicate-contig-names to continue"
            )
            return 1

    queries = QueriesIterator(query_providers)
    dir_cache = DirCache(cache_dir) if cache_dir else None
    min_dup = choose_min_duplication_length(sequence_database)
    max_dup = choose_max_duplication_length(sequence_database)

    if guess_reference_ancestors:
        from mapper_tpu.index.ancestry import AncestryDetector

        original_db = HashBlockDatabase(
            sequence_database,
            min_interesting_size=min_dup,
            hint_max_interesting_size=max_dup,
            max_num_short_matches=8,
            enable_gapmers=enable_gapmers,
            cache_dir=dir_cache,
            logger=reference_logger,
        )
        if verify_consistent_database:
            original_db.verify_matches(
                HashBlockDatabase(
                    sequence_database,
                    min_interesting_size=min_dup,
                    hint_max_interesting_size=max_dup,
                    max_num_short_matches=8,
                    enable_gapmers=enable_gapmers,
                )
            )
        ancestry_dups = DuplicationDetector(
            original_db, min_dup, max_dup, min_num_interesting_copies=3, window_size=1
        )
        dissimilarity = parameters.max_error_rate / parameters.mutation_penalty
        provider = AncestryDetector(
            ancestry_dups, sorted_reference, dissimilarity, out_ancestor_path
        )
        hashblock_database = provider.get_hashblock_database()
        reference_index = ReferenceIndex(sequence_database, hashblock_database, None)
        reference_index.get_original_sequence = provider.get_original_sequence
    else:
        hashblock_database = HashBlockDatabase(
            sequence_database,
            hint_max_interesting_size=max_dup,
            enable_gapmers=enable_gapmers,
            cache_dir=dir_cache,
            logger=reference_logger,
        )
        if verify_consistent_database:
            log("Verifying database consistency (double build)")
            hashblock_database.verify_matches(
                HashBlockDatabase(
                    sequence_database,
                    hint_max_interesting_size=max_dup,
                    enable_gapmers=enable_gapmers,
                )
            )
        reference_index = ReferenceIndex(sequence_database, hashblock_database, None)

    if os.environ.get("MAPPER_TPU_TRACE") == "1":
        log(f"[cli] reference index ready: {time.time() - start_time:.1f}s")
    approximate_dups = DuplicationDetector(
        hashblock_database,
        min_dup,
        max_dup,
        min_num_interesting_copies=2,
        window_size=1000,
    )
    reference_index.duplication_detector = approximate_dups
    # run the hash-bin duplication scan (seconds on a 4.6 Mb reference) on a
    # background thread: it overlaps query-provider setup and the engine's
    # creation; the batch loop joins it before the first alignment, and a
    # failure in it is raised there
    dup_errors: list[Exception] = []

    def detect_duplications():
        try:
            approximate_dups.ensure_detected()
        except Exception as e:  # raised on the main thread after join()
            dup_errors.append(e)

    dup_thread = threading.Thread(target=detect_duplications, daemon=True)
    dup_thread.start()

    listeners = []
    match_database = MatchDatabase(query_end_fraction)
    match_database.set_contig_order(sequence_database.get_all())
    refs_counter = ReferenceAlignmentCounter()
    if out_refs_map_count_path is not None:
        listeners.append(refs_counter)
    match_counter = AlignmentCounter()
    if out_vcf_path is not None or out_mutations_path is not None:
        listeners.append(match_database)
    penalty_summarizer = PenaltySummarizer(parameters)
    listeners.append(penalty_summarizer)
    indel_summarizer = IndelSummarizer()
    listeners.append(indel_summarizer)
    sam_writer = None
    sam_stream = None
    if out_sam_path is not None:
        contains_paired = queries.get_contains_paired_end_reads()
        sam_stream = sys.stdout if out_sam_path == "-" else open(out_sam_path, "wt")
        sam_writer = SamWriter(sequence_database, sam_stream, contains_paired)
        listeners.append(sam_writer)
    unaligned_writer = None
    if out_unaligned_path is not None:
        unaligned_writer = UnalignedQueryWriter(
            out_unaligned_path, queries.all_reads_contain_quality_information()
        )
        listeners.append(unaligned_writer)
    listeners.append(match_counter)

    cache = AlignmentCache()
    worker = AlignerWorker(reference_index, parameters, listeners, cache)
    if engine == "batch":
        from mapper_tpu_torch.batch.engine import BatchAligner

        engine_obj = BatchAligner(reference_index, parameters, device, listeners=listeners)
        engine_obj.fallback_worker = AlignerWorker(reference_index, parameters)
        # the engine probes/stores the cache at chunk intake (covering the
        # batch fast path, not just worker fallbacks); the inner worker runs
        # cache-less so hits/stores are not double-counted
        engine_obj.cache = cache
        worker_stats = engine_obj.fallback_worker.stats
        # device-side pileup (opt-in): clean emissions are added into
        # accumulators on the engine's device per chunk (Mapper.java:760-784)
        if (
            os.environ.get("MAPPER_TPU_DEVICE_PILEUP") == "1"
            and (out_vcf_path is not None or out_mutations_path is not None)
            and not guess_reference_ancestors
        ):
            from mapper_tpu_torch.batch.device_pileup import DevicePileup

            try:
                engine_obj.device_pileup = DevicePileup(sequence_database, query_end_fraction, device)
            except ValueError as e:
                log(f"Device pileup not taken, the pileup stays on the host: {e}")
    else:
        engine_obj = worker
        worker_stats = worker.stats

    num_loaded = 0
    batch: list = []
    batch_bases = 0
    # the reference batches 50 kb per worker thread (Mapper.java:926); the
    # batch engine amortizes per-launch cost over much larger batches and
    # pipelines two batches so host candidate generation overlaps device
    # scoring (numpy and device waits release the GIL)
    max_bases_per_batch = 2_000_000 if engine == "batch" else 50_000
    last_report = 0.0

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    if reference_index.duplication_detector is not None:
        dup_thread.join()  # detection complete before any worker consults it
        if dup_errors:
            raise dup_errors[0]

    # --num-threads scales the number of batches in flight (the reference's
    # worker-count knob, Mapper.java:154); two is the floor so host candidate
    # generation always overlaps device scoring
    pool_workers = max(2, min(int(num_threads), 16))
    pool = ThreadPoolExecutor(max_workers=pool_workers)
    pending: deque = deque()

    # verbose alignment tracing: each chunk logs into a BufferedWriter
    # replayed under a header after the chunk completes (the reference's
    # per-worker buffered log replay, Mapper.java:1014-1019); verbose runs
    # process chunks serially so the shared engine logger cannot race
    verbose_alignment = alignment_verbosity > 0 or auto_verbose
    chunk_counter = 0

    def submit_batch(chunk_batch) -> None:
        nonlocal chunk_counter
        writer = None
        if verbose_alignment:
            writer = BufferedWriter(
                stderr_writer, f"\nOutput from chunk {chunk_counter}:", 100000
            )
            verbosity = alignment_verbosity
            if auto_verbose and chunk_counter == 0:
                verbosity = max(verbosity, _INT_MAX)
            chunk_logger = Logger(writer, 0, verbosity)
            if engine == "batch":
                engine_obj.logger = chunk_logger
                engine_obj.fallback_worker.set_logger(chunk_logger)
            else:
                engine_obj.set_logger(chunk_logger)
        chunk_counter += 1
        pending.append(
            (pool.submit(engine_obj.process_batch, chunk_batch, notify=False), writer)
        )

    def drain(limit: int) -> None:
        nonlocal last_report
        while len(pending) > limit:
            future, writer = pending.popleft()
            results = future.result()
            if writer is not None:
                writer.flush()
            for listener in listeners:
                listener.add_alignments(results)
            now = time.time()
            if now - last_report >= 1.0:
                elapsed = now - start_time
                rate = num_loaded / elapsed if elapsed > 0 else 0
                log(f"Processing query {num_loaded} at {elapsed:.0f}s ({rate:.0f} q/s)")
                last_report = now

    # the align phase: from the first query read to the last result
    # delivered (query parsing included; index build and set-up excluded)
    align_start = time.time()
    for query_builder in queries:
        num_loaded += 1
        query_builder.set_id(num_loaded)
        batch.append(query_builder.build())
        batch_bases += batch[-1].get_length()
        if batch_bases >= max_bases_per_batch:
            submit_batch(batch)
            batch, batch_bases = [], 0
            # verbose runs serialize chunks (shared chunk logger); otherwise
            # keep at most two batches in flight
            drain(0 if verbose_alignment else pool_workers - 1)
    if batch:
        submit_batch(batch)
    drain(0)
    pool.shutdown()
    log(f"Aligned {num_loaded} queries at {time.time() - start_time:.0f}s")
    align_seconds = time.time() - align_start
    log(
        f"Align phase: {num_loaded} queries in {align_seconds:.3f}s "
        f"({num_loaded / max(align_seconds, 1e-9):.1f} queries/s)"
    )

    # --- outputs ---------------------------------------------------------

    device_pileup = getattr(engine_obj, "device_pileup", None)
    if device_pileup is not None:
        device_pileup.merge_into(match_database)
        log(f"Device pileup: {device_pileup.num_rows_accumulated} rows counted on the device")

    if out_refs_map_count_path is not None:
        refs_counter.sum_alignments(out_refs_map_count_path)
        log(f"Saved {out_refs_map_count_path}")
    display_coverage = None
    if out_vcf_path is not None:
        t_pileup = time.time()
        pileups = match_database.group_by_position()
        writer = VcfWriter(out_vcf_path, vcf_include_non_mutations, vcf_filter, vcf_show_support_read)
        writer.write(pileups, num_threads)
        log(
            f"Saved {out_vcf_path}"
            f" (pileup+write {time.time() - t_pileup:.0f}s)"
        )
        matched = writer.get_num_reference_positions_matched()
        total = sequence_database.get_total_forward_size()
        coverage = matched / total if total else 0.0
        text = f"{int(coverage * 100)}%"
        if text == "0%" and coverage > 0:
            text = "<1%"
        display_coverage = (
            f" Coverage                      : {text} of the reference ({matched}/{total}) was matched"
        )
    if out_mutations_path is not None:
        pileups = match_database.group_by_position()
        writer = MutationsWriter(out_mutations_path, mutation_filter)
        writer.write(pileups, num_threads)
        log(f"Saved {out_mutations_path}")

    # --- statistics block (Mapper.java:786-869) ---------------------------

    log("")
    log("Statistics: ")
    if match_counter.get_distance_weight() > 0:
        log(
            f" Query pair separation distance: avg: {match_counter.get_distance_mean():.1f}"
            f" stddev: {match_counter.get_distance_stddev():.1f} (adjust via --spacing)"
        )
    num_queries = match_counter.num_queries
    num_aligned = match_counter.num_aligned_queries
    percent = num_aligned * 100 // num_queries if num_queries else 0
    log(f" Alignment rate                : {percent}% of queries ({num_aligned}/{num_queries})")
    if display_coverage:
        log(display_coverage)
    total_len = match_counter.total_aligned_query_length
    total_pen = match_counter.total_aligned_penalty
    avg = total_pen / total_len if total_len else 0.0
    log(
        f" Average penalty               : {avg:.4g} per base ({int(total_pen)}/{int(total_len)}) in aligned queries"
    )
    num_indels = sum(indel_summarizer.extension_counts)
    indels_per_base = num_indels / total_len if total_len else 0.0
    log(
        f" Num indels                    : {indels_per_base:.4g} per base ({num_indels}/{int(total_len)}) in aligned queries"
    )
    table = DisplayTable()
    table.add_short_column(" ")
    table.add_column(
        format_histogram_column(
            "Alignment Penalties Graph:",
            "Count",
            "Penalty/Basepair",
            0,
            parameters.max_error_rate,
            20,
            penalty_summarizer.get_counts(),
        )
    )
    table.add_short_column(" ")
    indel_counts = indel_summarizer.get_interesting_indel_length_counts()
    table.add_column(
        format_histogram_column(
            "Indel Lengths Graph:",
            "Count",
            "Length",
            0,
            len(indel_counts) + 1,
            20,
            indel_counts,
        )
    )
    log(table.format())
    # fast-path fraction (Mapper.java:843-845): batch-resolved queries plus
    # the exact worker's optimistic immediate accepts
    num_immediate = worker_stats.num_immediately_accepted + getattr(
        engine_obj, "stats_batch_resolved", 0
    )
    log(
        f" Immediately accepted          : "
        f"{num_immediate * 100 // max(1, num_queries)}% alignments "
        f"({num_immediate}/{num_queries})"
    )
    log(
        f" Alignment cache usage         : {worker_stats.num_cache_hits} loaded, "
        f"{cache.get_usage()} stored, {worker_stats.num_cache_skips} skipped"
    )
    if worker_stats.query_at_random_moment is not None:
        # Mapper.java:835-837
        q = worker_stats.query_at_random_moment
        log(f" Query at random moment: #{q.get_id()} : {q.format()}")
    if worker_stats.slowest_query_name is not None:
        # reference: per-worker slowest-query timers (AlignerWorker.java:58-71)
        log(
            f" Slowest query                 : {worker_stats.slowest_query_name} took "
            f"{worker_stats.slowest_query_seconds * 1000:.0f}ms "
            f"({worker_stats.slowest_query_num_alignments} alignments)"
        )
    try:
        import resource

        # ru_maxrss is KiB on Linux; the reference prints post-GC heap usage
        # (Mapper.java:812-820) — peak RSS is the closest process-level analog
        peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
        log(f" Ending memory usage           : {peak_mb:.0f}mb peak RSS")
    except Exception:
        pass

    if sam_stream is not None and sam_stream is not sys.stdout:
        sam_stream.close()
    if unaligned_writer is not None:
        unaligned_writer.close()
    log("")
    log(f"Done in {time.time() - start_time:.1f}s.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
