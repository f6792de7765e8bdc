"""Builds a package's native C++ library in several processes at once, each
round on a fresh, empty cache directory, as test workers do on a cold cache,
and counts the processes whose `get_library()` came back None.

    python experiments/native_build_race.py PACKAGE ROUNDS PROCESSES [TREE]

PACKAGE is `mapper_tpu` or `mapper_tpu_torch`; TREE (default: this
repository) is the source tree the processes import it from, so a copy of
another commit can be compared.  The caches are made in a temporary
directory and removed.  Prints each round's results and the total.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path


def main(argv: list[str]) -> int:
    package, rounds, processes = argv[0], int(argv[1]), int(argv[2])
    tree = argv[3] if len(argv) > 3 else str(Path(__file__).resolve().parent.parent)
    code = f"import {package}.native as n; print(n.get_library() is not None)"
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(rounds):
            env = dict(os.environ, MAPPER_TPU_NATIVE_CACHE=os.path.join(tmp, str(r)), PYTHONPATH=tree)
            procs = [
                subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE, text=True)
                for _ in range(processes)
            ]
            loaded = [p.communicate(timeout=600)[0].strip() == "True" for p in procs]
            failed += loaded.count(False)
            print(f"round {r}: {loaded}", flush=True)
    print(f"{package}: {failed} of {rounds * processes} loads failed")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
