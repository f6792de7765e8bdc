"""Run statistics: counters, penalty/indel histograms, ASCII charts.

Ports of PenaltySummarizer.java, IndelSummarizer.java, Histogram.java,
DisplayTable.java and the QuickVariants AlignmentCounter (API from
Mapper.java:736-793)."""

from __future__ import annotations

import math
import random
import time

from mapper_tpu_torch.align.blocks import QueryAlignments


class RandomMomentSelector:
    """Selects one moment uniformly at random among all call times
    (RandomMomentSelector.java:13-27): each selection extends the target
    duration by a random divisor, so the final selected moment is uniform
    over the run.  Used for the "Query at random moment" report line
    (Mapper.java:1092-1096,835-837)."""

    def __init__(self, start_time: float | None = None):
        self.start_time = start_time if start_time is not None else time.time()
        self.target_duration = 0.0
        self.random = random.Random()

    def select(self, current_time: float) -> bool:
        elapsed = current_time - self.start_time
        if elapsed >= self.target_duration:
            divisor = self.random.random()
            if divisor <= 0 or divisor >= 1:
                divisor = 0.5
            self.target_duration = elapsed / divisor
            return True
        return False


class AlignmentCounter:
    """Counts queries/aligned queries/penalty totals and the paired-end
    distance distribution."""

    def __init__(self):
        self.num_queries = 0
        self.num_aligned_queries = 0
        self.total_aligned_query_length = 0
        self.total_aligned_penalty = 0.0
        self._distance_sum = 0.0
        self._distance_sq_sum = 0.0
        self._distance_weight = 0.0

    def add_alignments(self, results: list[QueryAlignments]) -> None:
        for query_alignments in results:
            self.num_queries += 1
            # columnar fast path: lazy clean-ungapped single-component rows
            rows = getattr(query_alignments, "rows", None)
            if rows is not None and query_alignments.alignments_per_component is None:
                if rows:
                    self.num_aligned_queries += 1
                    self.total_aligned_query_length += (
                        query_alignments.get_query_length(0)
                    )
                    self.total_aligned_penalty += rows[0][3]
                continue
            aligned = False
            for i, options in enumerate(query_alignments.get_alignments()):
                if not options:
                    continue
                aligned = True
                first = options[0]
                self.total_aligned_query_length += query_alignments.get_query_length(i)
                self.total_aligned_penalty += first.get_penalty()
                if first.get_num_sequences() > 1:
                    distance = first.inner_distance
                    self._distance_sum += distance
                    self._distance_sq_sum += distance * distance
                    self._distance_weight += 1
            if aligned:
                self.num_aligned_queries += 1

    def get_distance_mean(self) -> float:
        if self._distance_weight == 0:
            return 0.0
        return self._distance_sum / self._distance_weight

    def get_distance_stddev(self) -> float:
        if self._distance_weight == 0:
            return 0.0
        mean = self.get_distance_mean()
        variance = max(0.0, self._distance_sq_sum / self._distance_weight - mean * mean)
        return math.sqrt(variance)

    def get_distance_weight(self) -> float:
        return self._distance_weight


class PenaltySummarizer:
    """20-bin histogram of penalty / maxAllowed (PenaltySummarizer.java)."""

    def __init__(self, parameters):
        self.counts = [0] * 20
        self.parameters = parameters

    def add_alignments(self, results: list[QueryAlignments]) -> None:
        for query_alignments in results:
            # columnar fast path: lazy clean-ungapped emissions carry the
            # penalty in their rows — no need to build the object tree
            rows = getattr(query_alignments, "rows", None)
            if rows is not None and query_alignments.alignments_per_component is None:
                if rows:
                    penalty = rows[0][3]
                    query_length = query_alignments.get_query_length(0)
                    max_allowed = query_length * self.parameters.max_error_rate
                    if max_allowed == 0:
                        max_allowed = 1
                    bin_index = int(penalty / max_allowed * len(self.counts))
                    if bin_index < len(self.counts):
                        self.counts[bin_index] += 1
                continue
            for i, options in enumerate(query_alignments.get_alignments()):
                if not options:
                    continue
                penalty = options[0].get_penalty()
                query_length = query_alignments.get_query_length(i)
                max_allowed = query_length * self.parameters.max_error_rate
                if max_allowed == 0:
                    max_allowed = 1
                bin_index = int(penalty / max_allowed * len(self.counts))
                if bin_index < len(self.counts):
                    self.counts[bin_index] += 1

    def get_counts(self) -> list[float]:
        return [float(c) for c in self.counts]


class IndelSummarizer:
    """Indel-length histogram with a >=1% display cutoff (IndelSummarizer.java)."""

    def __init__(self):
        self.extension_counts: list[int] = []

    def add_alignments(self, results: list[QueryAlignments]) -> None:
        for query_alignments in results:
            # columnar fast path: lazy emissions are single-block ungapped
            # rows by construction — zero indels, nothing to count
            if (
                getattr(query_alignments, "rows", None) is not None
                and query_alignments.alignments_per_component is None
            ):
                continue
            for options in query_alignments.get_alignments():
                if not options:
                    continue
                for component in options[0].get_components():
                    for block in component.sections:
                        indel_length = block.indel_length
                        if indel_length > 0:
                            while len(self.extension_counts) <= indel_length:
                                self.extension_counts.append(0)
                            self.extension_counts[indel_length] += 1

    def get_interesting_indel_length_counts(self) -> list[float]:
        total = sum(self.extension_counts)
        max_interesting = 0
        for i, count in enumerate(self.extension_counts):
            if count * 100 >= total and total > 0:
                max_interesting = i + 1
        if max_interesting + 1 < len(self.extension_counts):
            max_interesting += 1
        return [float(c) for c in self.extension_counts[:max_interesting]]


def _squash(counts: list[float], desired: int) -> list[float]:
    """Histogram.squash resampling (Histogram.java:105-124)."""
    result = [0.0] * desired
    n = len(counts)
    for i, value in enumerate(counts):
        lo = i * desired / n
        hi = (i + 1) * desired / n
        for j in range(int(lo), min(desired, int(math.ceil(hi)))):
            overlap = min(hi, j + 1) - max(lo, j)
            if overlap > 0:
                result[j] += value * overlap / (hi - lo) if hi > lo else 0
    return result


def format_histogram_column(
    title: str,
    y_name: str,
    x_name: str,
    x_min: float,
    x_max: float,
    desired_num_bins: int,
    counts: list[float],
) -> list[str]:
    """ASCII bar chart (Histogram.formatColumn, Histogram.java:7-77)."""
    if desired_num_bins < len(counts):
        bin_counts = _squash(counts, desired_num_bins)
    else:
        bin_counts = list(counts)
    rows = [title]
    left_space = " " * (len(y_name) + 1)
    max_count = max(bin_counts) if bin_counts else 0.0
    chart_height = 10
    num_columns = len(bin_counts)
    if max_count > 0:
        scaled = [c * chart_height / max_count for c in bin_counts]
    else:
        scaled = bin_counts
    middle_row = chart_height // 2 - 1
    for y in range(chart_height - 1, -1, -1):
        row = (" " + y_name) if y == middle_row else left_space
        row += "|"
        for x in range(num_columns):
            diff = scaled[x] - y
            if diff >= 0.8:
                row += "#"
            elif diff >= 0.6:
                row += "^"
            elif diff >= 0.4:
                marker = "-"
                if 0 < x < num_columns - 1:
                    if scaled[x - 1] < scaled[x] < scaled[x + 1]:
                        marker = "/"
                    if scaled[x - 1] > scaled[x] > scaled[x + 1]:
                        marker = "\\"
                row += marker
            elif diff >= 0.2:
                row += "_"
            else:
                row += " "
            row += " "
        rows.append(row)
    rows.append(left_space + "." + "--" * num_columns)
    lower = f"{x_min:.2f}"
    upper = f"{x_max:.2f}"
    gap = max(1, num_columns * 2 - len(lower) - len(upper))
    rows.append(left_space + " " + lower + " " * gap + upper)
    rows.append(left_space + " " + x_name)
    return rows


class DisplayTable:
    """Multi-column text layout (DisplayTable.java)."""

    def __init__(self):
        self.columns: list[list[str]] = []

    def add_column(self, rows: list[str]) -> None:
        self.columns.append(rows)

    def add_short_column(self, text: str) -> None:
        self.columns.append([text])

    def format(self) -> str:
        height = max((len(c) for c in self.columns), default=0)
        widths = [max((len(r) for r in c), default=0) for c in self.columns]
        lines = []
        for y in range(height):
            parts = []
            for c, width in zip(self.columns, widths):
                cell = c[y] if y < len(c) else ""
                parts.append(cell.ljust(width))
            lines.append("".join(parts).rstrip())
        return "\n".join(lines)
