"""Native SAM rows (samrows.cpp), bound via ctypes.

`format_rows` hands one call the flat tables `SamWriter` builds from a
batch; the call writes the batch's rows as one text and holds no
interpreter lock.  The library is built with g++ at first use; the SAM
writer has no other way to write its rows.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from mapper_tpu_torch import basepairs, native

_SOURCE = os.path.join(native._HERE, "samrows.cpp")
_lib = None
_load_failed = False

# a row's record: entry, reverse, flag, reference name, start, mate name
# (-1: none), mate start, blocks (0: the whole query matched), spacing
# (-1: none)
FIELDS = 9

_DECODE = np.ascontiguousarray(basepairs.DECODE_TABLE, dtype=np.uint8)
_COMPLEMENT = np.ascontiguousarray(basepairs.COMPLEMENT_TABLE, dtype=np.uint8)


def get_library():
    """The loaded native SAM-row library, or None when unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with native._lock:
        if _lib is not None or _load_failed:
            return _lib
        library = native._library_path(_SOURCE, "libmappersamrows")
        if not os.path.exists(library) and not native._build(_SOURCE, library):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(library)
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            lib.mapper_sam_rows.restype = i64
            lib.mapper_sam_rows.argtypes = [
                i64, ptr, ptr,  # names: number, blob, offsets
                i64, ptr, ptr, ptr,  # codes: length, codes, decode table, complement table
                i64, ptr,  # entries: number, (code offset, length, name) each
                i64, ptr, i64, ptr,  # rows' records, blocks: number, table each
                ptr, i64, ptr,  # each row's penalty text, spacings: number, their texts
                i64, ptr, ptr,  # penalty texts: number, blob, offsets
                ptr, i64, ptr, ptr,  # out: text, capacity, size, each row's end (or null)
            ]
            _lib = lib
        except OSError:
            _load_failed = True
    return _lib


def _blob(texts: list[str]):
    """The texts as one utf-8 blob and its offsets (a name's lone
    surrogates pass through and come back by `surrogatepass`)."""
    encoded = [t.encode("utf-8", "surrogatepass") for t in texts]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


class RowFormatter:
    """Formats batches of rows, keeping its output buffer from one call to
    the next."""

    def __init__(self):
        self._out = np.empty(1 << 20, dtype=np.uint8)

    def format_rows(self, names: list[str], codes: bytes, entries: list[int], records: list[int],
                    blocks: list[int], penalty_ids: np.ndarray, spacing_ids: np.ndarray,
                    numbers: list[str], result_rows: list[int] | None = None) -> str | list[str]:
        """The rows of `records` (FIELDS each, with their `blocks`, three
        each) as one text, or, given `result_rows` (the rows up to each
        result's end), one text a result.  Raises where g++ cannot build the
        library, and where the call refuses an index or a code."""
        lib = get_library()
        if lib is None:
            raise RuntimeError(f"the native SAM rows could not be built from {_SOURCE} with g++")
        name_blob, name_offsets = _blob(names)
        number_blob, number_offsets = _blob(numbers)
        codes = np.frombuffer(codes, dtype=np.uint8)
        entries = np.array(entries, dtype=np.int64)
        records = np.array(records, dtype=np.int64)
        blocks = np.array(blocks, dtype=np.int64)
        penalty_ids = np.ascontiguousarray(penalty_ids, dtype=np.int64)
        spacing_ids = np.ascontiguousarray(spacing_ids, dtype=np.int64)
        size = np.zeros(1, dtype=np.int64)
        ends = None if result_rows is None else np.empty(records.shape[0] // FIELDS, dtype=np.int64)
        while True:
            status = lib.mapper_sam_rows(
                len(names), name_blob, name_offsets.ctypes.data,
                codes.shape[0], codes.ctypes.data, _DECODE.ctypes.data, _COMPLEMENT.ctypes.data,
                entries.shape[0] // 3, entries.ctypes.data,
                records.shape[0] // FIELDS, records.ctypes.data, blocks.shape[0] // 3, blocks.ctypes.data,
                penalty_ids.ctypes.data, spacing_ids.shape[0], spacing_ids.ctypes.data,
                len(numbers), number_blob, number_offsets.ctypes.data,
                self._out.ctypes.data, self._out.shape[0], size.ctypes.data,
                None if ends is None else ends.ctypes.data,
            )
            if status != 1:
                break
            self._out = np.empty(2 * int(size[0]), dtype=np.uint8)
        if status != 0:
            raise ValueError("the native SAM rows refused a table: an index out of range or a code past 15")
        out = memoryview(self._out)
        if ends is None:
            return str(out[: int(size[0])], "utf-8", "surrogatepass")
        bounds = np.concatenate(([0], ends))[np.concatenate(([0], result_rows))].tolist()
        return [str(out[a:b], "utf-8", "surrogatepass") for a, b in zip(bounds, bounds[1:])]

