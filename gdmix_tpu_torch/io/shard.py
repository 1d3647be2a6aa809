"""Deterministic file-level sharding across hosts/workers.

Reference semantics (linkedin/gdmix:gdmix-trainer/src/gdmix/util/distribution_utils.py:
11-47): sort the files, worker i takes files i, i+n, i+2n, ...; if there are fewer
files than workers every worker reads everything and flags sample-level sharding.
"""
from __future__ import annotations

import fnmatch
import os
from typing import List, Tuple
from gdmix_tpu_torch.io import fs


def _expand(input_path: str) -> List[str]:
    if isinstance(input_path, (list, tuple)):
        return sorted(input_path)
    directory, pattern = os.path.split(input_path)
    if fs.isdir(input_path):
        directory, pattern = input_path, "*"
    files = [os.path.join(directory, f) for f in fs.listdir(directory)
             if fnmatch.fnmatch(f, pattern) and not f.startswith(".")]
    return sorted(files)


def shard_input_files(input_path, num_shards: int, shard_index: int) -> Tuple[List[str], bool]:
    """Return (files for this shard, sample_level_shard flag)."""
    assert num_shards > 0 and 0 <= shard_index < num_shards
    input_files = _expand(input_path)
    if not input_files:
        raise ValueError(f"No input files found at {input_path!r}")
    if len(input_files) < num_shards:
        return input_files, True
    return input_files[shard_index::num_shards], False
