"""Length bucketing: fixed-shape batches for XLA.

The reference handles variable lengths with dynamic scheduling / histogram
sorts (bandedSWA.cpp:1186-1213 SORT_PAIRS); under XLA every shape
compiles a program, so work is grouped into a small set of padded shape buckets.
"""

from __future__ import annotations

import numpy as np

DEFAULT_EDGES = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def bucket_size(n: int, edges=DEFAULT_EDGES) -> int:
    for e in edges:
        if n <= e:
            return e
    raise ValueError(f"length {n} exceeds the largest bucket {edges[-1]}")


def group_by_buckets(items, size_fn, edges=DEFAULT_EDGES):
    """Group items by their bucketed size(s).

    size_fn(item) -> int or tuple of ints.  Returns dict bucket -> list of
    (original_index, item).
    """
    groups: dict = {}
    for i, item in enumerate(items):
        s = size_fn(item)
        if isinstance(s, tuple):
            key = tuple(bucket_size(v, edges) for v in s)
        else:
            key = bucket_size(s, edges)
        groups.setdefault(key, []).append((i, item))
    return groups
