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
detectors are the port's own copies of the JAX package's host code.

`--devices N` shards candidate scoring (and the device pileup) over the
first N devices of that device's type (`parallel/mesh.py`: the cards, or
`MAPPER_TPU_TORCH_CPU_DEVICES` entries of the CPU); `auto` takes them all
when there are several.  `--num-processes N --process-id K` aligns the K-th
round-robin share of the queries; process 0 waits for the others' shards
(`.done` files, and a gloo barrier with `--coordinator host:port`) and
merges them into outputs byte-identical to a one-process run
(`parallel/multihost.py`).
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
import time

from mapper_tpu_torch import trace
from mapper_tpu_torch.align.cache import AlignmentCache
from mapper_tpu_torch.align.params import AlignmentParameters
from mapper_tpu_torch.align.worker import AlignerWorker
from mapper_tpu_torch.api import ReferenceIndex
from mapper_tpu_torch.index.database import (
    HashBlockDatabase,
    choose_max_duplication_length,
    choose_min_duplication_length,
)
from mapper_tpu_torch.index.dircache import DirCache
from mapper_tpu_torch.index.duplication import DuplicationDetector
from mapper_tpu_torch.io import fastx
from mapper_tpu_torch.io.mutations import MutationDetectionParameters, MutationsWriter
from mapper_tpu_torch.io.refcounts import ReferenceAlignmentCounter, UnalignedQueryWriter
from mapper_tpu_torch.io.sam import SamWriter
from mapper_tpu_torch.io.vcf import VcfWriter
from mapper_tpu_torch.pileup import MatchDatabase
from mapper_tpu_torch.providers import (
    PairedEndQueryProvider,
    QueriesIterator,
    SimpleQueryProvider,
    SequenceSplitter,
)
from mapper_tpu_torch.sequence import SequenceDatabase, sort_and_complement
from mapper_tpu_torch.stats import (
    AlignmentCounter,
    DisplayTable,
    IndelSummarizer,
    PenaltySummarizer,
    format_histogram_column,
)


DEFAULT_EXPECTED_PAIR_DISTANCE = 100
DEFAULT_SPACING_DEVIATION = 50
_INT_MAX = 2**31 - 1


def usage_error(message: str) -> None:
    print(message, file=sys.stderr)
    sys.exit(1)


def _parse_threshold_subflags(args: list[str], i: int, params: MutationDetectionParameters) -> int:
    """The context-sensitive --snp-threshold family binding to the preceding
    --out-vcf / --out-mutations (Mapper.java:149-239)."""
    while i < len(args):
        arg = args[i]
        if arg == "--snp-threshold":
            params.min_snp_total_depth = float(args[i + 1])
            params.min_snp_depth_fraction = float(args[i + 2])
            i += 3
        elif arg == "--indel-start-threshold":
            params.min_indel_total_start_depth = float(args[i + 1])
            params.min_indel_start_depth_fraction = float(args[i + 2])
            i += 3
        elif arg == "--indel-continue-threshold":
            params.min_indel_continuation_total_depth = float(args[i + 1])
            params.min_indel_continuation_depth_fraction = float(args[i + 2])
            i += 3
        elif arg == "--indel-threshold":
            params.min_indel_total_start_depth = float(args[i + 1])
            params.min_indel_continuation_total_depth = float(args[i + 1])
            params.min_indel_start_depth_fraction = float(args[i + 2])
            params.min_indel_continuation_depth_fraction = float(args[i + 2])
            i += 3
        else:
            break
    return i


def main(argv: list[str] | None = None) -> int:
    """Runs the CLI.  With `MAPPER_TPU_TRACE=1` the run's spans and counters
    (`trace.py`) go to standard error as one `[trace]` line when it ends,
    however it ends."""
    tracer = trace.recorder()
    launches = _launch_counts() if tracer.on else None
    try:
        with tracer.span("cli.main"):
            return _main(argv, tracer)
    finally:
        if tracer.on:
            for name, n in _launch_counts().items():
                if n != launches.get(name, 0):
                    tracer.count(f"launches.{name}", n - launches.get(name, 0))
        tracer.export(sys.stderr)


def _launch_counts() -> dict[str, int]:
    from mapper_tpu_torch.align import kernels

    return dict(kernels.LAUNCHES)


def _main(argv: list[str] | None, tracer) -> int:
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
    num_devices = "auto"  # "auto" = every visible device when several; N = the first N
    num_processes = 1
    process_id = 0
    coordinator = None
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
        elif arg == "--num-processes":
            # multi-process data parallelism: each process aligns a
            # round-robin share of the query stream and process 0 merges
            # outputs in exact 1-process order (parallel/multihost.py)
            num_processes = int(args[i + 1])
            if num_processes < 1:
                usage_error("--num-processes must be >= 1")
            i += 2
        elif arg == "--process-id":
            process_id = int(args[i + 1])
            i += 2
        elif arg == "--coordinator":
            coordinator = args[i + 1]
            i += 2
        elif arg == "--devices":
            # shard candidate scoring over N devices (the reference's scale
            # knob is N worker threads, Mapper.java:154,640)
            if args[i + 1] != "auto":
                num_devices = int(args[i + 1])
                if num_devices < 1:
                    usage_error("--devices must be >= 1 or 'auto'")
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

    if not (0 <= process_id < num_processes):
        usage_error("--process-id must be in [0, --num-processes)")

    return run(
        engine=engine,
        num_devices=num_devices,
        num_processes=num_processes,
        process_id=process_id,
        coordinator=coordinator,
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
        tracer=tracer,
    )


def _save_refs_counts(refs_counter: ReferenceAlignmentCounter, path: str) -> None:
    """One process's reads-per-reference-combination counts, for process 0."""
    with open(path, "wb") as f:
        pickle.dump(refs_counter.counts, f)


def _merge_refs_counts(refs_counter: ReferenceAlignmentCounter, path: str) -> None:
    """Add another process's counts (a file this run's processes wrote):
    the counts are sums, so the merged file equals a one-process run's."""
    with open(path, "rb") as f:
        for key, count in pickle.load(f).items():
            refs_counter.counts[key] = refs_counter.counts.get(key, 0) + count


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
    num_devices="auto",
    num_processes=1,
    process_id=0,
    coordinator=None,
    alignment_verbosity=0,
    reference_verbosity=0,
    auto_verbose=False,
    tracer=trace.OFF,
) -> int:
    from mapper_tpu_torch.logging import BufferedWriter, Logger, StderrWriter

    log = lambda message: print(message, file=sys.stderr)
    stderr_writer = StderrWriter()
    reference_logger = Logger(stderr_writer, 0, reference_verbosity)

    device = None
    mesh = None
    if engine == "batch":
        import torch

        from mapper_tpu_torch.parallel.mesh import make_mesh, visible_devices

        device = torch.device(os.environ.get("MAPPER_TPU_TORCH_DEVICE", "cuda"))
        if device.type == "cuda" and not torch.cuda.is_available():
            usage_error(
                f"MAPPER_TPU_TORCH_DEVICE={device}: no CUDA device is available "
                "(set MAPPER_TPU_TORCH_DEVICE=cpu to run the plain scorer on the host)"
            )
        available = visible_devices(device.type)
        if num_devices == "auto":
            use_devices = available if len(available) > 1 else []
        else:
            if num_devices > len(available):
                usage_error(
                    f"--devices {num_devices} requested but only "
                    f"{len(available)} visible ({device.type})"
                )
            use_devices = available[:num_devices] if num_devices > 1 else []
        if use_devices:
            mesh = make_mesh(use_devices)
            device = mesh[0]

    distributed = num_processes > 1
    if distributed:
        from mapper_tpu_torch.parallel import multihost

        log(f"Process {process_id}/{num_processes} (round-robin query sharding)")
        if coordinator:
            multihost.initialize(coordinator, num_processes, process_id)

    def shard_path(base: str, k: int) -> str:
        return f"{base}.shard{k}"

    with tracer.span("cli.reference"):
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

    with tracer.span("cli.index"):
        queries = QueriesIterator(query_providers)
        dir_cache = DirCache(cache_dir) if cache_dir else None
        min_dup = choose_min_duplication_length(sequence_database)
        max_dup = choose_max_duplication_length(sequence_database)

        if guess_reference_ancestors:
            from mapper_tpu_torch.index.ancestry import AncestryDetector

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

    with tracer.span("cli.engine"):
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
                with tracer.span("cli.dup_scan"):
                    approximate_dups.ensure_detected()
            except Exception as e:  # raised on the main thread after join()
                dup_errors.append(e)

        dup_thread = threading.Thread(target=detect_duplications, name="duplication-scan", daemon=True)
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
        sam_shard = None
        if out_sam_path is not None:
            contains_paired = queries.get_contains_paired_end_reads()
            if distributed:
                sam_shard = multihost.ShardedResultWriter(
                    lambda stream: SamWriter(sequence_database, stream, contains_paired)
                )
                listeners.append(sam_shard)
            else:
                sam_stream = sys.stdout if out_sam_path == "-" else open(out_sam_path, "wt")
                sam_writer = SamWriter(sequence_database, sam_stream, contains_paired)
                listeners.append(sam_writer)
        unaligned_writer = None
        unaligned_shard = None
        if out_unaligned_path is not None:
            if distributed:
                # the JAX CLI leaves one unaligned file per process; the port
                # merges them in global query order like the SAM shards
                unaligned_shard = multihost.ShardedResultWriter(
                    lambda stream: UnalignedQueryWriter(
                        out_unaligned_path, queries.all_reads_contain_quality_information(), stream
                    )
                )
                listeners.append(unaligned_shard)
            else:
                unaligned_writer = UnalignedQueryWriter(
                    out_unaligned_path, queries.all_reads_contain_quality_information()
                )
                listeners.append(unaligned_writer)
        listeners.append(match_counter)

        if distributed:
            queries = multihost.RoundRobinQueries(queries, process_id, num_processes)

        cache = AlignmentCache()
        worker = AlignerWorker(reference_index, parameters, listeners, cache)
        if engine == "batch":
            from mapper_tpu_torch.batch.engine import BatchAligner

            if mesh is not None:
                log(f"Sharding candidate scoring over {len(mesh)} devices")
            engine_obj = BatchAligner(
                reference_index, parameters, device, listeners=listeners, mesh=mesh
            )
            engine_obj.fallback_worker = AlignerWorker(reference_index, parameters)
            # the engine probes/stores the cache at chunk intake (covering the
            # batch fast path, not just worker fallbacks); the inner worker runs
            # cache-less so hits/stores are not double-counted
            engine_obj.cache = cache
            worker_stats = engine_obj.fallback_worker.stats
            engine_obj.tracer = tracer
            # the engine's old stdout line, which the benchmark's
            # engine.decisions_ms_per_kread reads; never into a SAM on stdout
            engine_obj.print_decide_seconds = tracer.on and out_sam_path != "-"
            # device-side pileup (opt-in): clean emissions are added into
            # accumulators on the engine's device per chunk (Mapper.java:760-784)
            if (
                os.environ.get("MAPPER_TPU_DEVICE_PILEUP") == "1"
                and (out_vcf_path is not None or out_mutations_path is not None)
                and not guess_reference_ancestors
            ):
                from mapper_tpu_torch.batch.device_pileup import DevicePileup

                try:
                    engine_obj.device_pileup = DevicePileup(
                        sequence_database, query_end_fraction, device, mesh=mesh
                    )
                except ValueError as e:
                    log(f"Device pileup not taken, the pileup stays on the host: {e}")
        else:
            engine_obj = worker
            worker_stats = worker.stats

    num_loaded = 0
    # the reference batches 50 kb per worker thread (Mapper.java:926); the
    # batch engine amortizes per-launch cost over much larger batches and
    # pipelines two batches so host candidate generation overlaps device
    # scoring (numpy and device waits release the GIL)
    max_bases_per_batch = 2_000_000 if engine == "batch" else 50_000
    last_report = 0.0

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    if reference_index.duplication_detector is not None:
        with tracer.span("cli.dup_wait"):
            dup_thread.join()  # detection complete before any worker consults it
        if dup_errors:
            raise dup_errors[0]

    # --num-threads scales the number of batches in flight (the reference's
    # worker-count knob, Mapper.java:154); two is the floor so host candidate
    # generation always overlaps device scoring
    pool_workers = max(2, min(int(num_threads), 16))
    pool = ThreadPoolExecutor(max_workers=pool_workers, thread_name_prefix="batch")
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
        # the batch's id, shared by its spans on the main and pool threads
        batch_id = chunk_counter
        chunk_counter += 1
        ids = {"batch_id": batch_id} if engine == "batch" else {}
        pending.append(
            (pool.submit(engine_obj.process_batch, chunk_batch, notify=False, **ids), writer, batch_id)
        )

    def drain(limit: int) -> None:
        nonlocal last_report
        while len(pending) > limit:
            future, writer, batch_id = pending.popleft()
            with tracer.span("cli.wait", batch=batch_id):
                results = future.result()
            if writer is not None:
                writer.flush()
            with tracer.span("cli.listeners", batch=batch_id):
                for listener in listeners:
                    listener.add_alignments(results)
            now = time.time()
            if now - last_report >= 1.0:
                elapsed = now - start_time
                rate = num_loaded / elapsed if elapsed > 0 else 0
                log(f"Processing query {num_loaded} at {elapsed:.0f}s ({rate:.0f} q/s)")
                last_report = now

    def read_batches():
        """The queries, parsed, in batches of `max_bases_per_batch` bases."""
        nonlocal num_loaded
        batch, batch_bases = [], 0
        for query_builder in queries:
            num_loaded += 1
            if not distributed:  # RoundRobinQueries already set the global id
                query_builder.set_id(num_loaded)
            batch.append(query_builder.build())
            batch_bases += batch[-1].get_length()
            if batch_bases >= max_bases_per_batch:
                yield batch
                batch, batch_bases = [], 0
        if batch:
            yield batch

    # the align phase: from the first query read to the last result
    # delivered (query parsing included; index build and set-up excluded)
    align_start = time.time()
    with tracer.span("cli.align"):
        batches = read_batches()
        while True:
            with tracer.span("cli.parse", batch=chunk_counter):
                chunk_batch = next(batches, None)
            if chunk_batch is None:
                break
            submit_batch(chunk_batch)
            # verbose runs serialize chunks (shared chunk logger); otherwise
            # keep at most two batches in flight
            drain(0 if verbose_alignment else pool_workers - 1)
        drain(0)
        pool.shutdown()
    log(f"Aligned {num_loaded} queries at {time.time() - start_time:.0f}s")
    align_seconds = time.time() - align_start
    log(
        f"Align phase: {num_loaded} queries in {align_seconds:.3f}s "
        f"({num_loaded / max(align_seconds, 1e-9):.1f} queries/s)"
    )

    if engine == "batch" and engine_obj._use_device_candidates():
        log(
            f"Device candidates: {engine_obj.stats_fused_chunks} of "
            f"{engine_obj.stats_single_end_chunks} single-end chunks took the fused path"
        )

    # --- outputs ---------------------------------------------------------

    device_pileup = getattr(engine_obj, "device_pileup", None)
    if device_pileup is not None:
        with tracer.span("cli.pileup"):
            device_pileup.merge_into(match_database)
            log(f"Device pileup: {device_pileup.num_rows_accumulated} rows counted on the device")

    needs_pileup = out_vcf_path is not None or out_mutations_path is not None
    if distributed:
        with tracer.span("cli.write"):
            # cross-process merge (parallel/multihost.py): every process saves its
            # shards and a done marker; process 0 waits and merges in global order
            if sam_shard is not None:
                sam_shard.save_shard(shard_path(out_sam_path, process_id) + ".pkl")
            if unaligned_shard is not None:
                unaligned_shard.save_shard(shard_path(out_unaligned_path, process_id) + ".pkl")
            if process_id != 0:
                if needs_pileup:
                    base = out_vcf_path or out_mutations_path
                    multihost.save_pileup_shard(
                        match_database, shard_path(base, process_id) + ".pkl"
                    )
                if out_refs_map_count_path is not None:
                    _save_refs_counts(
                        refs_counter, shard_path(out_refs_map_count_path, process_id) + ".pkl"
                    )
            marker_base = (
                out_sam_path or out_vcf_path or out_mutations_path or out_unaligned_path
                or out_refs_map_count_path
            )
            if marker_base is not None:
                with open(shard_path(marker_base, process_id) + ".done", "w") as f:
                    f.write("done\n")
            if coordinator:
                multihost.barrier("mapper_tpu_outputs")
            if process_id != 0:
                log(f"Process {process_id} done (shards saved; process 0 merges)")
                return 0
            # process 0: wait for every shard, then merge
            markers = []
            if marker_base is not None:
                markers = [shard_path(marker_base, k) + ".done" for k in range(num_processes)]
                multihost.wait_for_files(markers[1:])
            merged = []
            if sam_shard is not None:
                sam_stream = sys.stdout if out_sam_path == "-" else open(out_sam_path, "wt")
                shards = [shard_path(out_sam_path, k) + ".pkl" for k in range(num_processes)]
                multihost.merge_sam_shards(shards, sam_stream)
                merged += shards
            if unaligned_shard is not None:
                shards = [shard_path(out_unaligned_path, k) + ".pkl" for k in range(num_processes)]
                with open(out_unaligned_path, "wt", encoding="ascii") as stream:
                    multihost.merge_sam_shards(shards, stream)
                merged += shards
            if needs_pileup:
                base = out_vcf_path or out_mutations_path
                shards = [shard_path(base, k) + ".pkl" for k in range(1, num_processes)]
                multihost.merge_pileup_shards(match_database, shards)
                merged += shards
            if out_refs_map_count_path is not None:
                shards = [shard_path(out_refs_map_count_path, k) + ".pkl" for k in range(1, num_processes)]
                for path in shards:
                    _merge_refs_counts(refs_counter, path)
                merged += shards
            # the shards and markers belong to this run: a later run into the
            # same paths must wait for its own, not merge these
            for path in merged + markers:
                os.remove(path)

    if out_refs_map_count_path is not None:
        with tracer.span("cli.write"):
            refs_counter.sum_alignments(out_refs_map_count_path)
            log(f"Saved {out_refs_map_count_path}")
    display_coverage = None
    if out_vcf_path is not None:
        t_pileup = time.time()
        with tracer.span("cli.pileup"):
            pileups = match_database.group_by_position()
        with tracer.span("cli.write"):
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
        with tracer.span("cli.pileup"):
            pileups = match_database.group_by_position()
        with tracer.span("cli.write"):
            writer = MutationsWriter(out_mutations_path, mutation_filter)
            writer.write(pileups, num_threads)
            log(f"Saved {out_mutations_path}")

    # --- statistics block (Mapper.java:786-869) ---------------------------

    with tracer.span("cli.report"):
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
