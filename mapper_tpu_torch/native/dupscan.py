"""Native duplication scan (dupscan.cpp), bound via ctypes.

`group` hands one call a block length's packed map, the concatenated codes
and the sequences' layout; the call groups every interesting bin by its edge
text and holds no interpreter lock.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from mapper_tpu_torch import basepairs, native

_SOURCE = os.path.join(native._HERE, "dupscan.cpp")
_lib = None
_load_failed = False


def get_library():
    """The loaded native duplication-scan library, or None when unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with native._lock:
        if _lib is not None or _load_failed:
            return _lib
        library = native._library_path(_SOURCE, "libmapperdupscan")
        if not os.path.exists(library) and not native._build(_SOURCE, library):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(library)
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            lib.mapper_dupscan_group.restype = i64
            lib.mapper_dupscan_group.argtypes = [
                i64, ptr, ptr, ptr,  # the packed map: capacity, counts, offsets, values
                i64, i64, i64,  # max_interesting_count, min copies, block length
                ptr, i64, ptr,  # codes, their length, ambiguous code
                i64, ptr, ptr, ptr,  # sequences: number, starts, lengths, reverse complement's index
                ptr, ptr, ptr,  # out: group sizes, positions, totals
            ]
            _lib = lib
        except OSError:
            _load_failed = True
    return _lib


_AMBIGUOUS = np.ascontiguousarray(basepairs.TWO_BIT_TABLE < 0, dtype=np.uint8)


def group(packed, min_copies: int, block_length: int, codes: np.ndarray, starts, lengths, rc_index):
    """Groups the bins of `packed` (a PackedIndex) that hold between
    `min_copies` and its `max_interesting_count` positions by edge text, as
    `DuplicationDetector._process_length`'s vectorized pass does.  Returns
    (rows gathered, forward and reverse; each group's size; the groups'
    positions, concatenated), in that pass's order; None where the library
    is unavailable or refuses the input."""
    lib = get_library()
    if lib is None:
        return None
    counts = np.ascontiguousarray(packed.counts, dtype=np.int32)
    offsets = np.ascontiguousarray(packed.offsets, dtype=np.int64)
    values = np.ascontiguousarray(packed.values, dtype=np.int64)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    rc_index = np.ascontiguousarray(rc_index, dtype=np.int64)
    num_sequences = lengths.shape[0]
    if (counts.shape[0] != packed.capacity or offsets.shape[0] != packed.capacity + 1
            or offsets[-1] > values.shape[0] or starts.shape[0] != num_sequences + 1
            or rc_index.shape[0] != num_sequences):
        return None
    bound = 2 * values.shape[0]  # every stored position and its reverse complement
    sizes = np.empty(bound, dtype=np.int64)
    positions = np.empty(bound, dtype=np.int64)
    totals = np.zeros(3, dtype=np.int64)
    status = lib.mapper_dupscan_group(
        packed.capacity, counts.ctypes.data, offsets.ctypes.data, values.ctypes.data,
        int(packed.max_interesting_count), int(min_copies), int(block_length),
        codes.ctypes.data, codes.shape[0], _AMBIGUOUS.ctypes.data,
        num_sequences, starts.ctypes.data, lengths.ctypes.data, rc_index.ctypes.data,
        sizes.ctypes.data, positions.ctypes.data, totals.ctypes.data,
    )
    if status != 0:
        return None
    rows, num_groups, num_positions = totals.tolist()
    return rows, sizes[:num_groups], positions[:num_positions]
