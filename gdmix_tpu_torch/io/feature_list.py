"""Feature-list files: one "name,term" CSV row per feature.

Reference: linkedin/gdmix:gdmix-trainer/src/gdmix/util/io_utils.py:215-239. The index
of a feature is its zero-based position in the file; the intercept is never listed.
"""
from __future__ import annotations

import csv

from gdmix_tpu_torch.io import fs
from typing import Dict, List, Tuple

Feature = Tuple[str, str]


def read_feature_list(feature_file: str) -> List[Feature]:
    result: List[Feature] = []
    with fs.open(feature_file, newline="") as f:
        for row in csv.reader(f):
            assert len(row) == 2, (
                f"Each feature name should have exactly name and term only, but got {row}.")
            result.append((row[0], row[1]))
    return result


def get_feature_map(feature_file: str) -> Dict[Feature, int]:
    return {feature: index for index, feature in enumerate(read_feature_list(feature_file))}


def write_feature_list(features: List, feature_file: str) -> None:
    """Write features as name,term rows. Accepts (name, term) tuples or bare names
    (bare names get an empty term, matching the reference movieLens prep which writes
    'name,' rows)."""
    with fs.open(feature_file, "w", newline="") as f:
        w = csv.writer(f)
        for feat in features:
            if isinstance(feat, (tuple, list)):
                w.writerow([feat[0], feat[1]])
            else:
                w.writerow([feat, ""])
