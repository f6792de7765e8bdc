"""Query providers: streaming builders of queries from read files.

Ports of SimpleQueryProvider.java, PairedEndQueryProvider.java,
QueriesIterator.java and SequenceSplitter.java."""

from __future__ import annotations

from mapper_tpu_torch import trace
from mapper_tpu_torch.align.query import QueryBuilder
from mapper_tpu_torch.io.fastx import SequenceProvider
from mapper_tpu_torch.sequence import SequenceBuilder


class SequenceSplitter(SequenceProvider):
    """Chops reads longer than `max_size` into <= max_size even chunks
    (SequenceSplitter.java:9-46; --split-queries-past-size).  `tracer`
    counts the reads it splits (`split.reads`) and the pieces it makes of
    them (`split.pieces`)."""

    def __init__(self, max_size: int, provider: SequenceProvider, tracer=trace.OFF):
        self.max_size = max_size
        self.provider = provider
        self.tracer = tracer
        self._pending: list[SequenceBuilder] = []

    def get_next_sequence(self) -> SequenceBuilder | None:
        if self._pending:
            return self._pending.pop(0)
        builder = self.provider.get_next_sequence()
        if builder is None:
            return None
        length = builder.get_length()
        if length <= self.max_size:
            return builder
        sequence = builder.build()
        num_chunks = (length + self.max_size - 1) // self.max_size
        self.tracer.count("split.reads", 1)
        self.tracer.count("split.pieces", num_chunks)
        prev = 0
        for i in range(1, num_chunks + 1):
            end = length * i // num_chunks
            sub = SequenceBuilder().set_name(f"{sequence.name}_{prev}").set_path(sequence.path)
            sub.add(sequence.get_range(prev, end - prev))
            if sequence.quality is not None:
                sub.add_quality(sequence.quality[prev:end])
            self._pending.append(sub)
            prev = end
        return self._pending.pop(0)

    def all_reads_contain_quality_information(self) -> bool:
        return self.provider.all_reads_contain_quality_information()


class QueryProvider:
    def get_next_query_builder(self) -> QueryBuilder | None:
        raise NotImplementedError

    def get_contains_paired_end_reads(self) -> bool:
        return False

    def all_reads_contain_quality_information(self) -> bool:
        raise NotImplementedError

    def __iter__(self):
        while True:
            builder = self.get_next_query_builder()
            if builder is None:
                return
            yield builder


class SimpleQueryProvider(QueryProvider):
    def __init__(self, provider: SequenceProvider):
        self.provider = provider

    def get_next_query_builder(self) -> QueryBuilder | None:
        builder = self.provider.get_next_sequence()
        if builder is None:
            return None
        return QueryBuilder([builder])

    def all_reads_contain_quality_information(self) -> bool:
        return self.provider.all_reads_contain_quality_information()

    def __str__(self) -> str:
        return str(self.provider)


class PairedEndQueryProvider(QueryProvider):
    """Zips two read files; errors on length mismatch
    (PairedEndQueryProvider.java:24-46)."""

    def __init__(
        self,
        lefts: SequenceProvider,
        rights: SequenceProvider,
        expected_inner_distance: float,
        spacing_deviation_per_unit_penalty: float,
    ):
        self.lefts = lefts
        self.rights = rights
        self.expected_inner_distance = expected_inner_distance
        self.spacing_deviation = spacing_deviation_per_unit_penalty

    def get_next_query_builder(self) -> QueryBuilder | None:
        left = self.lefts.get_next_sequence()
        right = self.rights.get_next_sequence()
        if left is None and right is None:
            return None
        if left is None or right is None:
            raise ValueError("paired-end query files contain different numbers of reads")
        return QueryBuilder(
            [left, right],
            expected_inner_distance=self.expected_inner_distance,
            spacing_deviation_per_unit_penalty=self.spacing_deviation,
        )

    def get_contains_paired_end_reads(self) -> bool:
        return True

    def all_reads_contain_quality_information(self) -> bool:
        return (
            self.lefts.all_reads_contain_quality_information()
            and self.rights.all_reads_contain_quality_information()
        )


class QueriesIterator(QueryProvider):
    """Concatenates several providers (QueriesIterator.java)."""

    def __init__(self, providers: list[QueryProvider]):
        self.providers = providers
        self._index = 0

    def get_next_query_builder(self) -> QueryBuilder | None:
        while self._index < len(self.providers):
            builder = self.providers[self._index].get_next_query_builder()
            if builder is not None:
                return builder
            self._index += 1
        return None

    def get_contains_paired_end_reads(self) -> bool:
        return any(p.get_contains_paired_end_reads() for p in self.providers)

    def all_reads_contain_quality_information(self) -> bool:
        return all(p.all_reads_contain_quality_information() for p in self.providers)
