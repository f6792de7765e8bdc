"""Streaming FASTA/FASTQ(.gz) parsers and writers.

Mirrors the reference's QuickVariants `DataLoader`, `FastaParser`, `FastqParser`,
`FastaWriter` (SURVEY.md §2.3; name-truncation-at-first-space behavior pinned by
FastaParser_Test.java:12-24). Supported extensions match DataLoader.LoadFrom
(README.md:23): .fasta/.fa/.fna/.fastq/.fq plus .gz of each.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, TextIO

from mapper_tpu_torch.sequence import Sequence, SequenceBuilder


def _open_text(path: str) -> TextIO:
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    return open(path, "rt", encoding="ascii")


def _strip_extension(path: str) -> str:
    base = path
    if base.endswith(".gz"):
        base = base[:-3]
    return base


def is_fasta(path: str) -> bool:
    return _strip_extension(path).endswith((".fasta", ".fa", ".fna"))


def is_fastq(path: str) -> bool:
    return _strip_extension(path).endswith((".fastq", ".fq"))


def parse_fasta(handle: TextIO, path: str | None = None) -> Iterator[SequenceBuilder]:
    """Yields one SequenceBuilder per FASTA record.

    The contig name is truncated at the first whitespace (reference behavior:
    FastaParser_Test.java:12-24).
    """
    builder: SequenceBuilder | None = None
    for line in handle:
        line = line.rstrip("\n").rstrip("\r")
        if not line:
            continue
        if line.startswith(">"):
            if builder is not None:
                yield builder
            name = line[1:].split()[0] if len(line) > 1 else ""
            builder = SequenceBuilder().set_name(name).set_path(path)
        else:
            if builder is None:
                raise ValueError(f"FASTA content before first header in {path}")
            builder.add(line)
    if builder is not None:
        yield builder


def parse_fastq(handle: TextIO, path: str | None = None, keep_quality: bool = True) -> Iterator[SequenceBuilder]:
    """Yields one SequenceBuilder per FASTQ record."""
    while True:
        header = handle.readline()
        if not header:
            return
        header = header.rstrip("\n").rstrip("\r")
        if not header:
            continue
        if not header.startswith("@"):
            raise ValueError(f"Malformed FASTQ header {header!r} in {path}")
        seq_line = handle.readline().rstrip("\n").rstrip("\r")
        plus_line = handle.readline()
        if not plus_line.startswith("+"):
            raise ValueError(f"Malformed FASTQ separator for {header!r} in {path}")
        quality_line = handle.readline().rstrip("\n").rstrip("\r")
        name = header[1:].split()[0] if len(header) > 1 else ""
        builder = SequenceBuilder().set_name(name).set_path(path)
        builder.add(seq_line)
        if keep_quality:
            builder.add_quality(quality_line)
        yield builder


class SequenceProvider:
    """Streaming provider of SequenceBuilders (reference: QuickVariants
    SequenceProvider; usage SequenceSplitter.java:3-46)."""

    def get_next_sequence(self) -> SequenceBuilder | None:
        raise NotImplementedError

    def all_reads_contain_quality_information(self) -> bool:
        raise NotImplementedError

    def __iter__(self) -> Iterator[SequenceBuilder]:
        while True:
            builder = self.get_next_sequence()
            if builder is None:
                return
            yield builder


class FileSequenceProvider(SequenceProvider):
    def __init__(self, paths: list[str], keep_quality: bool):
        self._paths = list(paths)
        self._keep_quality = keep_quality
        self._iter: Iterator[SequenceBuilder] | None = None
        self._path_index = 0
        self._all_have_quality = all(is_fastq(p) for p in paths)

    def _next_file_iter(self) -> Iterator[SequenceBuilder] | None:
        while self._path_index < len(self._paths):
            path = self._paths[self._path_index]
            self._path_index += 1
            handle = _open_text(path)
            if is_fasta(path):
                return parse_fasta(handle, path)
            if is_fastq(path):
                return parse_fastq(handle, path, keep_quality=self._keep_quality)
            raise ValueError(
                f"Unrecognized sequence file extension for {path!r}; expected "
                ".fasta/.fa/.fna/.fastq/.fq optionally with .gz"
            )
        return None

    def get_next_sequence(self) -> SequenceBuilder | None:
        while True:
            if self._iter is None:
                self._iter = self._next_file_iter()
                if self._iter is None:
                    return None
            try:
                return next(self._iter)
            except StopIteration:
                self._iter = None

    def all_reads_contain_quality_information(self) -> bool:
        return self._all_have_quality

    def __str__(self) -> str:
        return "sequences from " + ", ".join(self._paths)


def load_from(paths: str | list[str], keep_quality: bool) -> FileSequenceProvider:
    """DataLoader.LoadFrom equivalent (Mapper.java:101,115,657)."""
    if isinstance(paths, str):
        paths = [paths]
    return FileSequenceProvider(paths, keep_quality)


class FastaWriter:
    """Writes sequences in FASTA format (reference: FastaWriter via
    AncestryDetector.java:40-43,71-79)."""

    def __init__(self, path_or_handle):
        if isinstance(path_or_handle, str):
            self._handle = open(path_or_handle, "wt", encoding="ascii")
            self._owns = True
        else:
            self._handle = path_or_handle
            self._owns = False

    def write(self, sequence: Sequence) -> None:
        self._handle.write(">" + sequence.name + "\n")
        self._handle.write(sequence.get_text() + "\n")

    def close(self) -> None:
        if self._owns:
            self._handle.close()


class FastqWriter:
    def __init__(self, path_or_handle):
        if isinstance(path_or_handle, str):
            self._handle = open(path_or_handle, "wt", encoding="ascii")
            self._owns = True
        else:
            self._handle = path_or_handle
            self._owns = False

    def write(self, sequence: Sequence) -> None:
        self._handle.write("@" + sequence.name + "\n")
        text = sequence.get_text()
        self._handle.write(text + "\n+\n")
        quality = sequence.quality
        if quality is None:
            quality = b"I" * len(text)
        self._handle.write(quality.decode("ascii") + "\n")

    def close(self) -> None:
        if self._owns:
            self._handle.close()
