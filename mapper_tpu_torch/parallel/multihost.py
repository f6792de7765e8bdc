"""Multi-process / multi-host execution (SURVEY §2.2's stated TPU mapping of
the reference's thread-pool scale story, Mapper.java:943-1101).

Model: N processes (one per host in a pod, or N local processes in CI) each
align a round-robin share of the query stream — query with global index i
belongs to process i % N, and keeps its global id so outputs are mergeable in
exact 1-process order.  `torch.distributed` links the processes over gloo
for barriers; result merging is:

- SAM: each process renders its results keyed by global query id into a
  shard file; after a cross-process barrier, process 0 interleaves the shards
  back into the serial emission order (byte-identical to 1-process).
- VCF/mutations: per-contig pileup arrays are pure sums — process 0 adds the
  other processes' arrays (exactly the psum fan-in, performed host-side at
  write time since the post-pass is host code); insertion events carry the
  global id of their first contributor so the example-read column matches the
  1-process run.
- refcounts / unaligned: same shard-merge by global id.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np


def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
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


class RoundRobinQueries:
    """Wraps the global query iterator: yields only this process's share,
    with ids set to the GLOBAL stream index (1-based, matching the serial
    CLI numbering)."""

    def __init__(self, queries_iter, process_id: int, num_processes: int):
        self.queries_iter = queries_iter
        self.process_id = process_id
        self.num_processes = num_processes
        self.num_global = 0

    def __iter__(self):
        for i, qb in enumerate(self.queries_iter):
            self.num_global = i + 1
            if i % self.num_processes == self.process_id:
                qb.set_id(i + 1)
                yield qb


class ShardedResultWriter:
    """Listener capturing each result's rendered output keyed by global query
    id, for order-exact cross-process merging.  Wraps any row-stream writer
    (SamWriter, UnalignedQueryWriter-style) whose output is a function of the
    results fed to add_alignments."""

    def __init__(self, make_writer):
        """make_writer(stream) -> listener writing rows to `stream`."""
        self._chunks: list[str] = []
        self._sink = _ListStream(self._chunks)
        self.writer = make_writer(self._sink)
        self.header = "".join(self._chunks)  # whatever the ctor emitted
        del self._chunks[:]
        self.entries: list[tuple[int, str]] = []

    def add_alignments(self, results) -> None:
        # a writer that gives each result's rows from one pass over the
        # batch (SamWriter's texts_by_result) is called once a batch
        texts_by_result = getattr(self.writer, "texts_by_result", None)
        if texts_by_result is not None:
            for result, text in zip(results, texts_by_result(results)):
                self.entries.append((result.query_sequences[0].identifier, text))
            return
        for result in results:
            before = len(self._chunks)
            self.writer.add_alignments([result])
            text = "".join(self._chunks[before:])
            del self._chunks[before:]
            gid = result.query_sequences[0].identifier
            self.entries.append((gid, text))

    def save_shard(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"header": self.header, "entries": self.entries}, f)


class _ListStream:
    def __init__(self, chunks: list):
        self.chunks = chunks

    def write(self, text: str) -> None:
        self.chunks.append(text)

    def flush(self) -> None:
        pass


def merge_sam_shards(shard_paths: list[str], out_stream) -> None:
    """Interleave per-process shards back into global-id order."""
    all_entries: list[tuple[int, str]] = []
    header = None
    for path in shard_paths:
        with open(path, "rb") as f:
            data = pickle.load(f)
        if header is None:
            header = data["header"]
        all_entries.extend(data["entries"])
    all_entries.sort(key=lambda e: e[0])
    if header:
        out_stream.write(header)
    for _, text in all_entries:
        out_stream.write(text)


# --- pileup merging -------------------------------------------------------


def save_pileup_shard(match_database, path: str) -> None:
    """Serialize this process's accumulated pileups (post group_by_position)."""
    pileups = match_database.group_by_position()
    payload = {}
    for seq, pileup in pileups.items():
        payload[seq.name] = {
            "middle": pileup.middle,
            "end": pileup.end,
            "deletion_start_middle": pileup.deletion_start_middle,
            "insertions": dict(pileup.insertions),
        }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def merge_pileup_shards(match_database, shard_paths: list[str]) -> None:
    """Add other processes' pileup shards into this process's MatchDatabase.
    Array counts are pure sums; insertion events merge by (position, text)
    with the example read taken from the smallest first-contributor global id
    (reproducing the 1-process stream order)."""
    pileups = match_database.group_by_position()
    by_name = {seq.name: (seq, pileup) for seq, pileup in pileups.items()}
    for path in shard_paths:
        with open(path, "rb") as f:
            payload = pickle.load(f)
        for name, data in payload.items():
            if name not in by_name:
                # contig only covered by the other process: create its pileup
                seq = next(
                    s
                    for s in match_database._contig_sequences
                    if s.name == name
                )
                pileup = match_database._pileup_for(seq)
                by_name[name] = (seq, pileup)
            _, pileup = by_name[name]
            pileup.middle += data["middle"]
            pileup.end += data["end"]
            pileup.deletion_start_middle += data["deletion_start_middle"]
            for key, entry in data["insertions"].items():
                mine = pileup.insertions.get(key)
                if mine is None:
                    pileup.insertions[key] = list(entry)
                else:
                    mine[0] += entry[0]
                    mine[1] += entry[1]
                    their_gid = entry[3] if len(entry) > 3 else -1
                    my_gid = mine[3] if len(mine) > 3 else -1
                    if their_gid != -1 and (my_gid == -1 or their_gid < my_gid):
                        mine[2] = entry[2]
                        if len(mine) > 3:
                            mine[3] = their_gid
    # a 1-process run meets the insertion events in global query order, and
    # the VCF and mutations writers list a position's insertions in the
    # dict's order: order each contig's events by their first contributor
    # (a stable sort keeps one read's events in the order it added them)
    for _, pileup in by_name.values():
        pileup.insertions = dict(
            sorted(pileup.insertions.items(), key=lambda item: item[1][3] if len(item[1]) > 3 else -1)
        )


def wait_for_files(paths: list[str], timeout_s: float = 600.0) -> None:
    """File-presence barrier for runs without jax.distributed (each process
    touches `<path>.done` when finished)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if all(os.path.exists(p) for p in paths):
            return
        time.sleep(0.1)
    missing = [p for p in paths if not os.path.exists(p)]
    raise TimeoutError(f"timed out waiting for shards: {missing}")
