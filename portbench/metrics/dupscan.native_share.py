"""dupscan.native_share: the share of the rows the two-copy duplication scan
gathered (each stored position of an interesting bin and its reverse
complement) that `DuplicationDetector._process_length` grouped by edge text
in its one native pass: the program's counters `dupscan.native_rows` over
`dupscan.rows`, summed over the window's jobs (`program_trace.py`).  None
where no job counts a row: a scan read from the index cache, or a program
without the counters."""

from portbench import program_trace


def read(ctx):
    rows = program_trace.count(ctx, "dupscan.rows")
    if not rows:
        return None
    return program_trace.count(ctx, "dupscan.native_rows") / rows
