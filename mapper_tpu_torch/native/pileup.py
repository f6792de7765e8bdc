"""Native pileup accumulation (pileup.cpp), bound via ctypes.

`accumulate` hands one call the flat tables `MatchDatabase` builds from its
pending alignments; the call adds them into the contigs' pileup arrays in
place and holds no interpreter lock.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from mapper_tpu_torch import native

_SOURCE = os.path.join(native._HERE, "pileup.cpp")
_lib = None
_load_failed = False

# an alignment's record: code offset, query length, flags, entry, choices,
# and a lazy row's start or the number of blocks
FIELDS = 6
# flags: a lazy row's reverse flag is 1; a two-component choice's first
# component is FIRST_MATE, its second 2 * FIRST_MATE
FIRST_MATE, LAZY = 2, 8


def get_library():
    """The loaded native pileup library, or None when unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with native._lock:
        if _lib is not None or _load_failed:
            return _lib
        library = native._library_path(_SOURCE, "libmapperpileup")
        # -ffp-contract=off: the end margin and the weights must round as
        # Python's float arithmetic does
        if not os.path.exists(library) and not native._build(_SOURCE, library, extra=("-ffp-contract=off",)):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(library)
            i64, f64, ptr = ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
            lib.mapper_pileup_accumulate.restype = i64
            lib.mapper_pileup_accumulate.argtypes = [
                i64, ptr, ptr, ptr, ptr, ptr,  # contigs: length, middle, end, deletion starts, rows
                i64, ptr, ptr,  # entries: contig, folded
                ptr, i64, ptr, ptr, f64,  # codes, their length, code -> row, complement, query_end_fraction
                i64, ptr, i64, ptr,  # alignments' records, blocks
                ptr, ptr, ptr,  # out: overlap lo, overlap hi, contig order
            ]
            _lib = lib
        except OSError:
            _load_failed = True
    return _lib


def _usable(pileup) -> bool:
    """The arrays are what the call writes into: float64, C order,
    writable, of the contig's length."""
    n = len(pileup.sequence)
    return all(
        a.dtype == np.float64 and a.flags.c_contiguous and a.flags.writeable and a.shape == shape
        for a, shape in (
            (pileup.middle, (6, n)),
            (pileup.end, (6, n)),
            (pileup.deletion_start_middle, (n,)),
        )
    )


def accumulate(pileups, ref_rows, entry_contig, entry_folded, codes: bytes, code_to_row, complement,
               query_end_fraction: float, records: list[int], blocks: list[int]):
    """Adds the alignments (`records`, FIELDS each, and their `blocks`)
    into `pileups`' arrays, one ContigPileup a contig with its reference
    rows.  Returns each alignment's mate-overlap range (lo, hi; -1 where
    there is none) and the contigs in the order the Python passes would
    have created their pileups; None, with nothing written, where the
    library is unavailable or an array or index does not fit."""
    lib = get_library()
    if lib is None or not all(_usable(p) for p in pileups):
        return None

    def addresses(arrays):
        return np.array([a.ctypes.data for a in arrays], dtype=np.uint64)

    ref_rows = [np.ascontiguousarray(r, dtype=np.int8) for r in ref_rows]  # alive through the call
    contig_arrays = [
        np.array([len(p.sequence) for p in pileups], dtype=np.int64),
        addresses([p.middle for p in pileups]),
        addresses([p.end for p in pileups]),
        addresses([p.deletion_start_middle for p in pileups]),
        addresses(ref_rows),
    ]
    entry_contig = np.array(entry_contig, dtype=np.int64)
    entry_folded = np.array(entry_folded, dtype=np.uint8)
    codes = np.frombuffer(codes, dtype=np.uint8)
    code_to_row = np.ascontiguousarray(code_to_row, dtype=np.int8)
    complement = np.ascontiguousarray(complement, dtype=np.uint8)
    records = np.array(records, dtype=np.int64)
    blocks = np.array(blocks, dtype=np.int64)
    num = records.shape[0] // FIELDS
    overlap_lo = np.empty(num, dtype=np.int64)
    overlap_hi = np.empty(num, dtype=np.int64)
    order = np.empty(len(pileups), dtype=np.int64)
    status = lib.mapper_pileup_accumulate(
        len(pileups), *(a.ctypes.data for a in contig_arrays),
        entry_contig.shape[0], entry_contig.ctypes.data, entry_folded.ctypes.data,
        codes.ctypes.data, codes.shape[0], code_to_row.ctypes.data, complement.ctypes.data,
        float(query_end_fraction), num, records.ctypes.data, blocks.shape[0] // 4, blocks.ctypes.data,
        overlap_lo.ctypes.data, overlap_hi.ctypes.data, order.ctypes.data,
    )
    if status != 0:
        return None
    return overlap_lo, overlap_hi, order[order >= 0].tolist()
