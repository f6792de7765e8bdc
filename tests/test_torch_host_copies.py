"""The port's own copies of the JAX package's host code stay faithful.

Each copied module equals its `mapper_tpu` original after the package rename
(`mapper_tpu.` to `mapper_tpu_torch.`, `from mapper_tpu import` to `from
mapper_tpu_torch import`; two docstrings name reference files without the
reference tree's absolute location), except for the intended differences
named in `INTENDED`; so do the helpers the port's `cli.py` took from
`mapper_tpu/cli.py`; the native C++ sources are copied byte for byte.  The two
packages' native libraries build into separate cache directories, the
port's index built from a seeded reference holds the same arrays as the JAX
package's, and `convert.parameters_from_reference` carries the parameters
across.
"""

import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

import mapper_tpu
import mapper_tpu.native
import mapper_tpu_torch
import mapper_tpu_torch.native
from benchmarks.simlib import random_reference
from mapper_tpu_torch import convert

REPO = Path(__file__).resolve().parent.parent
JAX_PACKAGE, PORT = REPO / "mapper_tpu", REPO / "mapper_tpu_torch"

MODULES = (
    "basepairs.py", "sequence.py", "api.py", "logging.py", "pileup.py", "providers.py", "stats.py",
    "align/params.py", "align/blocks.py", "align/query.py", "align/cache.py",
    "align/candidates.py", "align/dp.py", "align/query_aligner.py", "align/worker.py",
    "batch/candidates.py",
    "index/__init__.py", "index/hashblock.py", "index/scalar.py", "index/packedmap.py",
    "index/database.py", "index/dircache.py", "index/duplication.py", "index/ancestry.py",
    "io/__init__.py", "io/fastx.py", "io/sam.py", "io/vcf.py", "io/mutations.py",
    "io/refcounts.py",
    "native/__init__.py", "parallel/multihost.py",
)
NATIVE_SOURCES = ("native/dp.cpp", "native/candidates.cpp", "native/counting.cpp", "native/textrows.cpp")

JAX_INITIALIZE_AND_BARRIER = '''def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
    """jax.distributed.initialize wrapper (idempotent)."""
    import jax

    try:
        jax.distributed.initialize(
            coordinator, num_processes=num_processes, process_id=process_id
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def barrier(name: str) -> None:
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
'''
PORT_INITIALIZE_AND_BARRIER = '''def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
    """torch.distributed.init_process_group over gloo at `coordinator`
    (host:port), idempotent.  gloo on the card too: no tensor crosses
    processes (outputs merge through shard files), and NCCL refuses two
    ranks on one GPU."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
    )


def barrier(name: str) -> None:
    """Every process of the group reaches this point (`name` labels the
    barrier as in the JAX package; torch.distributed's barrier is unnamed)."""
    import torch.distributed as dist

    dist.barrier()
'''

def renamed(text: str) -> str:
    """The package rename; the copies also name reference files without the
    absolute location of the reference's source tree."""
    text = re.sub(r"/[\w/]*/src/main/java/mapper/", "", text)
    text = re.sub(r"\bmapper_tpu\.", "mapper_tpu_torch.", text)
    return re.sub(r"\bfrom mapper_tpu import\b", "from mapper_tpu_torch import", text)


def _method(package: Path, module: str, cls: str, name: str) -> str:
    """The source text of a method of a package's module, indented as in
    the file."""
    text = (package / module).read_text()
    for node in ast.parse(text).body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and item.name == name:
                    return "    " + ast.get_source_segment(text, item)
    raise LookupError(f"{module}: {cls}.{name} not found")


def _from(package: Path, module: str, marker: str) -> str:
    """The text of a package's module from its one line that starts with
    `marker` to the end of the file."""
    text = (package / module).read_text()
    assert text.count(marker) == 1, f"{module}: {marker!r}"
    return text[text.index(marker):]


def untraced(text: str) -> str:
    """`text` with the tracer (`trace.py`) taken out: the `tracer =
    self.tracer` and `tracer.count(...)` lines dropped, and the body of each
    `with tracer.span(...):` put back at the indentation of its `with`."""
    out, opened = [], []  # opened: the indentation of each open `with`
    for line in text.splitlines(keepends=True):
        stripped = line.strip()
        indent = len(line) - len(line.lstrip())
        while opened and stripped and indent <= opened[-1]:
            opened.pop()
        if re.fullmatch(r"tracer = self\.tracer|tracer\.count\(.*\)", stripped):
            continue
        if re.fullmatch(r"with tracer\.span\(.*\):", stripped):
            opened.append(indent)
            continue
        out.append(line[4 * len(opened):] if stripped else line)
    return "".join(out)


def _traced_method(module: str, cls: str, name: str) -> str:
    """The port's method where it is the renamed original once its tracer is
    taken out (`untraced`); else the original, so that the copy's
    comparison fails."""
    original = renamed(_method(JAX_PACKAGE, module, cls, name))
    port = _method(PORT, module, cls, name)
    return port if untraced(port) == original else original


# module -> (text of the renamed original, text of the port's copy)
INTENDED = {
    # a cache hit keeps each component's strand (the JAX package gives a
    # reverse-strand component the forward read); results set
    # device_counted when they are made
    "align/blocks.py": [(
        """        new_components = [
            c.with_sequence_a(sequences[i]) for i, c in enumerate(self.components)
        ]""",
        """        # each component keeps its strand: one aligned as the read's reverse
        # complement gets the new read's reverse complement
        new_components = [
            c.with_sequence_a(
                sequences[i].reverse_complement()
                if c.get_sequence_a().complemented_from is not None
                else sequences[i]
            )
            for i, c in enumerate(self.components)
        ]""",
    ), (
        # results carry device_counted from the start: the pileup reads it
        # for every result, and reading an unset slot raises
        """        self.query_sequences = query_sequences
        self.alignments_per_component = alignments_per_component
""",
        """        self.query_sequences = query_sequences
        self.alignments_per_component = alignments_per_component
        # set, so that reading it costs no AttributeError
        self.device_counted = False
""",
    ), (
        """        self.query_sequences = query_sequences
        self.alignments_per_component = None
""",
        """        self.query_sequences = query_sequences
        self.alignments_per_component = None
        self.device_counted = False
""",
    )],
    # the native libraries build into a cache directory of the port's own
    "native/__init__.py": [(
        """    base = os.environ.get("MAPPER_TPU_NATIVE_CACHE")
    if not base:
        xdg = os.environ.get("XDG_CACHE_HOME") or os.path.join(
            os.path.expanduser("~"), ".cache"
        )
        base = os.path.join(xdg, "mapper_tpu", "native")""",
        """    # a subdirectory of its own, so that neither package loads a library
    # built from the other's sources
    base = os.environ.get("MAPPER_TPU_NATIVE_CACHE")
    if base:
        base = os.path.join(base, "mapper_tpu_torch")
    else:
        xdg = os.environ.get("XDG_CACHE_HOME") or os.path.join(
            os.path.expanduser("~"), ".cache"
        )
        base = os.path.join(xdg, "mapper_tpu_torch", "native")""",
    ), (
        # a temporary build output per process: concurrent builds of one
        # library on a cold cache (the test workers') lost it for a worker
        """def _build(source: str, library: str, extra=()) -> bool:
    try:""",
        """def _build(source: str, library: str, extra=()) -> bool:
    # a temporary file of this process's own: processes that build the same
    # library at once (test workers on a cold cache) must not write, unlink
    # or rename each other's output
    tmp = f"{library}.{os.getpid()}.tmp"
    try:""",
    ), (
        """                "-o",
                library + ".tmp",""",
        """                "-o",
                tmp,""",
    ), (
        """        os.replace(library + ".tmp", library)""",
        """        os.replace(tmp, library)""",
    )],
    # the unaligned writer also writes to a stream: a multi-process run's
    # shard, which process 0 merges in global query order
    "io/refcounts.py": [(
        """    def __init__(self, path: str, all_reads_have_quality: bool):
        from mapper_tpu_torch.io import fastx

        self.path = path
        base = path[:-3] if path.endswith(".gz") else path
        if base.endswith((".fastq", ".fq")):
            self.writer = fastx.FastqWriter(path)
        elif base.endswith((".fasta", ".fa", ".fna")):
            self.writer = fastx.FastaWriter(path)
""",
        """    def __init__(self, path: str, all_reads_have_quality: bool, stream=None):
        from mapper_tpu_torch.io import fastx

        self.path = path
        # the records go to `stream` when one is given (one process's share
        # of a multi-process run), in the format `path` names
        target = path if stream is None else stream
        base = path[:-3] if path.endswith(".gz") else path
        if base.endswith((".fastq", ".fq")):
            self.writer = fastx.FastqWriter(target)
        elif base.endswith((".fasta", ".fa", ".fna")):
            self.writer = fastx.FastaWriter(target)
""",
    )],
    # one native pass (native/pileup.cpp) accumulates the pending
    # alignments, with counters for the tracer; the Python passes remain as
    # its fallback.  Both record insertions through one helper,
    # `_add_insertion`, the original's insertion branch moved into a method
    "pileup.py": [(
        """from mapper_tpu_torch import basepairs
from mapper_tpu_torch.align.blocks import QueryAlignment, QueryAlignments
""",
        """from mapper_tpu_torch import basepairs, trace
from mapper_tpu_torch.align.blocks import QueryAlignment, QueryAlignments
from mapper_tpu_torch.native import pileup as native_pileup
""",
    ), (
        """    def group_by_position(self) -> dict[Sequence, ContigPileup]:
        self._buffers: dict[int, list] = {}
        self._fast: list = []
        for query_alignments in self._pending:
            self._accumulate(query_alignments)
        self._pending = []
        self._flush_fast()
        self._flush_buffers()
""",
        """    def group_by_position(self, tracer=trace.OFF) -> dict[Sequence, ContigPileup]:
        # one native pass adds every pending alignment; the Python passes
        # below are the fallback where the library cannot be built
        if not self._accumulate_native(tracer):
            self._buffers: dict[int, list] = {}
            self._fast: list = []
            for query_alignments in self._pending:
                self._accumulate(query_alignments)
            self._flush_fast()
            self._flush_buffers()
        self._pending = []
""",
    ), (
        # the native pass's intake, the port's own code (its results are
        # held against the JAX package by tests/test_torch_pileup_native.py)
        """        return {p.sequence: p for p in pileups}

""",
        """        return {p.sequence: p for p in pileups}

""" + _method(PORT, "pileup.py", "MatchDatabase", "_accumulate_native") + """

""",
    ), (
        """        pileup = self._pileup_for(ref)
        buf = self._buffer_for(""",
        """        self._pileup_for(ref)  # made here, in visit order
        buf = self._buffer_for(""",
    ), (
        """            return codes

        read_name = query.name
""",
        """            return codes
""",
    ), (
        """            elif block.length_a > 0:
                # insertion: record at the forward position it precedes
                inserted = fold_codes(query.codes[block.start_a : block.end_a])
                if folded:
                    inserted = inserted[::-1]
                    position = ref_len - block.start_b
                else:
                    position = block.start_b
                text = basepairs.decode(inserted)
                mid_q = block.start_a
                dist_from_end = min(mid_q, query_len - mid_q)
                is_end = dist_from_end < end_margin
                w = weight
""",
        """            elif block.length_a > 0:
                self._add_insertion(alignment, block, weight, overlap_range)

    def _add_insertion(self, alignment, block, weight: float, overlap_range) -> None:
        \"\"\"An insertion block: its weight recorded at the forward position it
        precedes, keyed by the inserted text (the Python passes and the
        native pass both).\"\"\"
        query = alignment.get_sequence_a()
        ref = alignment.get_sequence_b()
        pileup = self._pileup_for(ref)
        folded = ref.complemented_from is not None
        inserted = query.codes[block.start_a : block.end_a]
        if folded:
            inserted = basepairs.COMPLEMENT_TABLE[inserted][::-1]
            position = len(ref) - block.start_b
        else:
            position = block.start_b
        text = basepairs.decode(inserted)
        query_len = len(query)
        mid_q = block.start_a
        dist_from_end = min(mid_q, query_len - mid_q)
        is_end = dist_from_end < self.query_end_fraction * query_len
        w = weight
""",
    ), (
        # the rest of the branch, dedented into the helper
        """                if overlap_range is not None and (
                    overlap_range[0] <= block.start_b < overlap_range[1]
                ):
                    w = weight * 0.5
                # 4th element: global query id of the first contributor, so
                # multi-process merges can keep the 1-process example read
                entry = pileup.insertions.setdefault(
                    (position, text), [0.0, 0.0, read_name, query.identifier]
                )
                if is_end:
                    entry[1] += w
                else:
                    entry[0] += w
""",
        """        if overlap_range is not None and (
            overlap_range[0] <= block.start_b < overlap_range[1]
        ):
            w = weight * 0.5
        # 4th element: global query id of the first contributor, so
        # multi-process merges can keep the 1-process example read
        entry = pileup.insertions.setdefault(
            (position, text), [0.0, 0.0, query.name, query.identifier]
        )
        if is_end:
            entry[1] += w
        else:
            entry[0] += w
""",
    )],
    # the splitter counts the reads it splits and their pieces for the
    # tracer (`trace.py`); `OFF` by default, as for every other caller
    "providers.py": [(
        """from mapper_tpu_torch.align.query import QueryBuilder
""",
        """from mapper_tpu_torch import trace
from mapper_tpu_torch.align.query import QueryBuilder
""",
    ), (
        """    (SequenceSplitter.java:9-46; --split-queries-past-size).\"\"\"

    def __init__(self, max_size: int, provider: SequenceProvider):
        self.max_size = max_size
        self.provider = provider
""",
        """    (SequenceSplitter.java:9-46; --split-queries-past-size).  `tracer`
    counts the reads it splits (`split.reads`) and the pieces it makes of
    them (`split.pieces`).\"\"\"

    def __init__(self, max_size: int, provider: SequenceProvider, tracer=trace.OFF):
        self.max_size = max_size
        self.provider = provider
        self.tracer = tracer
""",
    ), (
        """        num_chunks = (length + self.max_size - 1) // self.max_size
""",
        """        num_chunks = (length + self.max_size - 1) // self.max_size
        self.tracer.count("split.reads", 1)
        self.tracer.count("split.pieces", num_chunks)
""",
    )],
    # the ancestry inference's stages run under the tracer's spans, and
    # count the duplications walked and the bases widened; without them the
    # inference is the original's, line for line (`_traced_method`)
    "index/ancestry.py": [(
        """from mapper_tpu_torch import basepairs
""",
        """from mapper_tpu_torch import basepairs, trace
""",
    ), (
        """        enable_gapmers: bool = True,
    ):
""",
        """        enable_gapmers: bool = True,
        tracer=trace.OFF,
    ):
""",
    ), (
        """        self.enable_gapmers = enable_gapmers
        self.overrides""",
        """        self.enable_gapmers = enable_gapmers
        # spans of the inference's stages (`ancestry.detect`, `.walk`,
        # `.emit`, `.index`) and counters of its duplications and bases
        self.tracer = tracer
        self.overrides""",
    ), (
        renamed(_method(JAX_PACKAGE, "index/ancestry.py", "AncestryDetector", "_union_recent_ancestors")),
        _traced_method("index/ancestry.py", "AncestryDetector", "_union_recent_ancestors"),
    )],
    # torch.distributed (gloo) links the processes in place of
    # jax.distributed; the rest of the module is the host copy
    "parallel/multihost.py": [(
        """exact 1-process order.  `jax.distributed.initialize` links the processes
(gloo on CPU, ICI/DCN on TPU pods) for barriers; result merging is:""",
        """exact 1-process order.  `torch.distributed` links the processes over gloo
for barriers; result merging is:""",
    ), (
        JAX_INITIALIZE_AND_BARRIER,
        PORT_INITIALIZE_AND_BARRIER,
    ), (
        # the merged insertion events in the 1-process run's order (the
        # JAX package appends the other processes' new events at the end,
        # and its VCF then lists a position's insertions in another order)
        """                        if len(mine) > 3:
                            mine[3] = their_gid
""",
        """                        if len(mine) > 3:
                            mine[3] = their_gid
    # a 1-process run meets the insertion events in global query order, and
    # the VCF and mutations writers list a position's insertions in the
    # dict's order: order each contig's events by their first contributor
    # (a stable sort keeps one read's events in the order it added them)
    for _, pileup in by_name.values():
        pileup.insertions = dict(
            sorted(pileup.insertions.items(), key=lambda item: item[1][3] if len(item[1]) > 3 else -1)
        )
""",
    ), (
        # the SAM writer gives each result's rows from one native pass a
        # batch, so the shard writer calls it once a batch
        """    def add_alignments(self, results) -> None:
        for result in results:
""",
        """    def add_alignments(self, results) -> None:
        # a writer that gives each result's rows from one pass over the
        # batch (SamWriter's texts_by_result) is called once a batch
        texts_by_result = getattr(self.writer, "texts_by_result", None)
        if texts_by_result is not None:
            for result, text in zip(results, texts_by_result(results)):
                self.entries.append((result.query_sequences[0].identifier, text))
            return
        for result in results:
""",
    )],
    # one native pass a block length (native/dupscan.cpp) groups the
    # interesting bins by edge text, with counters for the tracer; the
    # vectorized pass remains as its fallback, `_insert` and the cache as
    # they were
    "index/duplication.py": [(
        """from mapper_tpu_torch import basepairs
""",
        """from mapper_tpu_torch import basepairs, trace
from mapper_tpu_torch.native import dupscan as native_dupscan
""",
    ), (
        """        cache_dir=None,
    ):
""",
        """        cache_dir=None,
        tracer=trace.OFF,
    ):
""",
    ), (
        """        self.enable_gapmers = hashblock_database.get_enable_gapmers()
""",
        """        self.enable_gapmers = hashblock_database.get_enable_gapmers()
        self.tracer = tracer
""",
    ), (
        """            return
        # bins with >= minCopies stored forward positions and not overflowed
""",
        """            return
        # one native pass groups the bins; the vectorized pass below is its
        # fallback where the library cannot be built or refuses the input
        if self._process_length_native(block_length, m, concat):
            return
        # bins with >= minCopies stored forward positions and not overflowed
""",
    ), (
        """        if total == 0:
            return
""",
        """        if total == 0:
            return
        self.tracer.count("dupscan.rows", 2 * total)
""",
    ), (
        # the native pass's intake, the port's own code (its results are
        # held against the JAX package by tests/test_torch_dupscan_native.py)
        """        self._insert(pending)

    def _insert(""",
        """        self._insert(pending)

""" + _method(PORT, "index/duplication.py", "DuplicationDetector", "_process_length_native") + """

    def _insert(""",
    )],
    # one native pass a batch (native/samrows.cpp) writes the rows: the
    # port's own methods from `add_alignments` to the end of the file (held
    # against the JAX package's writer by tests/test_torch_sam_native.py)
    # take the place of the Python rows
    "io/sam.py": [(
        """from mapper_tpu_torch.align.blocks import QueryAlignment, QueryAlignments
from mapper_tpu_torch.sequence import Sequence
""",
        """from mapper_tpu_torch.align.blocks import QueryAlignments
from mapper_tpu_torch.native import samrows as native_samrows
from mapper_tpu_torch.sequence import Sequence
""",
    ), (
        '''    """AlignmentListener emitting SAM rows."""

    def __init__(self, sequence_database, stream, contains_paired_end: bool):
        self.stream = stream
        self.contains_paired_end = contains_paired_end
        self._write_header(sequence_database)
''',
        '''    """AlignmentListener emitting SAM rows, a batch's rows in one native
    pass (native/samrows.cpp)."""

    def __init__(self, sequence_database, stream, contains_paired_end: bool):
        self.stream = stream
        self.contains_paired_end = contains_paired_end
        self._formatter = native_samrows.RowFormatter()
        self._write_header(sequence_database)
''',
    ), (
        renamed(_from(JAX_PACKAGE, "io/sam.py", "    def add_alignments(")),
        _from(PORT, "io/sam.py", "    def add_alignments("),
    )],
}


@pytest.mark.parametrize("module", MODULES)
def test_copy_equals_the_renamed_original(module):
    want = renamed((JAX_PACKAGE / module).read_text())
    for original, port in INTENDED.get(module, []):
        assert want.count(original) == 1, f"{module}: the intended difference no longer applies"
        want = want.replace(original, port)
    assert (PORT / module).read_text() == want


def test_the_ancestry_inference_is_the_original_without_its_tracer():
    port = _method(PORT, "index/ancestry.py", "AncestryDetector", "_union_recent_ancestors")
    assert "tracer.span(" in port
    assert untraced(port) == renamed(_method(JAX_PACKAGE, "index/ancestry.py", "AncestryDetector",
                                             "_union_recent_ancestors"))


@pytest.mark.parametrize("source", NATIVE_SOURCES)
def test_native_source_is_copied_byte_for_byte(source):
    assert (PORT / source).read_bytes() == (JAX_PACKAGE / source).read_bytes()


CLI_HELPERS = (
    "DEFAULT_EXPECTED_PAIR_DISTANCE", "DEFAULT_SPACING_DEVIATION", "_INT_MAX",
    "usage_error", "_parse_threshold_subflags",
)


def _top_level_sources(path: Path) -> dict[str, str]:
    """Name -> source text of each top-level function and single-name
    assignment of a module."""
    text = path.read_text()
    found = {}
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef):
            found[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            found[node.targets[0].id] = ast.get_source_segment(text, node)
    return found


@pytest.mark.parametrize("name", CLI_HELPERS)
def test_cli_helper_equals_the_renamed_original(name):
    """The helpers the port's `cli.py` took from `mapper_tpu/cli.py`."""
    want = _top_level_sources(JAX_PACKAGE / "cli.py")[name]
    assert _top_level_sources(PORT / "cli.py")[name] == renamed(want)


def test_intended_differences_name_copied_modules():
    assert set(INTENDED) <= set(MODULES)


@pytest.mark.parametrize("override", [None, "shared"])
def test_native_libraries_build_apart(monkeypatch, tmp_path, override):
    """Each package loads only libraries built from its own sources: the
    cache directories differ, with and without MAPPER_TPU_NATIVE_CACHE."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    if override:
        monkeypatch.setenv("MAPPER_TPU_NATIVE_CACHE", str(tmp_path / override))
    else:
        monkeypatch.delenv("MAPPER_TPU_NATIVE_CACHE", raising=False)
    port, jax = Path(mapper_tpu_torch.native._cache_dir()), Path(mapper_tpu.native._cache_dir())
    assert port != jax and port.is_dir() and jax.is_dir()
    assert "mapper_tpu_torch" in port.parts and "mapper_tpu_torch" not in jax.parts


def _reference(seed: int) -> dict:
    """Two contigs from a seeded random reference, with a 400 bp block
    copied three times so the duplication detector has work."""
    rng = np.random.default_rng(seed)
    text = random_reference(rng, 12_000)
    block = text[1000:1400]
    text = text[:5000] + block + text[5000:8000] + block + text[8000:] + block
    return {"chrA": text[:7000], "chrB": text[7000:]}


@pytest.fixture(scope="module")
def indexes():
    contigs = _reference(17)
    return mapper_tpu_torch.Api.new_database(contigs), mapper_tpu.Api.new_database(contigs)


def test_index_arrays_equal(indexes):
    """Sequences, hash tables (every size's packed map and the merged
    cross-size view) and duplications are equal."""
    port, jax = indexes
    port_db, jax_db = port.hashblock_database, jax.hashblock_database
    np.testing.assert_array_equal(
        port_db.get_sequence_database().concatenated_codes(),
        jax_db.get_sequence_database().concatenated_codes(),
    )
    top = max(jax_db.get_min_interesting_size() + 16, jax_db.max_fully_set_up_size)
    for db in (port_db, jax_db):
        db.require_set_up_through_size(top)
    assert sorted(port_db.maps) == sorted(jax_db.maps) and jax_db.maps
    for size, want in jax_db.maps.items():
        got = port_db.maps[size]
        assert (got.capacity, got.max_interesting_count) == (want.capacity, want.max_interesting_count)
        for name in ("counts", "offsets", "values"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=f"{size} {name}")
    merged_port, merged_jax = port_db.merged_index(), jax_db.merged_index()
    assert merged_port.keys() == merged_jax.keys()
    for key, want in merged_jax.items():
        np.testing.assert_array_equal(merged_port[key], want, err_msg=key)

    def duplications(index):
        index.duplication_detector.ensure_detected()
        return [(d.length, list(d.positions)) for d in index.duplication_detector.get_all()]

    assert duplications(port) == duplications(jax) and duplications(jax)


def test_parameters_from_reference():
    jax_params = mapper_tpu.AlignmentParameters.defaults(mutation_penalty=2.0, max_error_rate=0.2)
    jax_params.base_penalty(1, 2)  # caches a table the port's object rebuilds
    fields = dict(vars(jax_params), max_num_matches=np.int64(7))
    port = convert.parameters_from_reference(fields)
    assert isinstance(port, mapper_tpu_torch.AlignmentParameters)
    assert dataclasses.asdict(port) == dict(dataclasses.asdict(jax_params), max_num_matches=7)
    assert type(port.max_num_matches) is int
    np.testing.assert_array_equal(port.substitution_table(), jax_params.substitution_table())
    with pytest.raises(ValueError, match="unknown"):
        convert.parameters_from_reference(dict(fields, band=64))
    with pytest.raises(ValueError, match="missing"):
        convert.parameters_from_reference({"mutation_penalty": 1.0})
