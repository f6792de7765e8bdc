"""Content-addressed on-disk cache of reference analyses.

Equivalent of the reference's DirCache (DirCache.java:19-45): a directory is
keyed by a canonicalized property map; repeated runs with the same keys reuse
the same directory.  We hash the canonical key string with sha256 instead of
the reference's XOR-pyramid walk — the observable contract (same keys -> same
dir; different keys -> different dirs; `content/` subdir; `usage` timestamp)
is preserved.
"""

from __future__ import annotations

import hashlib
import json
import os
import time


class DirCache:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def get_or_create_dir(self, keys: dict[str, str]) -> str:
        canonical = json.dumps({str(k): str(v) for k, v in sorted(keys.items())}, sort_keys=True)
        digest = hashlib.sha256(canonical.encode()).hexdigest()
        directory = os.path.join(self.root, digest[:2], digest)
        content_dir = os.path.join(directory, "content")
        os.makedirs(content_dir, exist_ok=True)
        metadata_path = os.path.join(directory, "metadata.json")
        if os.path.exists(metadata_path):
            with open(metadata_path) as handle:
                existing = handle.read()
            if existing != canonical:
                raise RuntimeError(f"DirCache hash collision at {directory}")
        else:
            with open(metadata_path, "w") as handle:
                handle.write(canonical)
        with open(os.path.join(directory, "usage"), "w") as handle:
            handle.write(str(time.time()))
        return content_dir
