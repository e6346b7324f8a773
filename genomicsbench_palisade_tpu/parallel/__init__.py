"""Distribution layer: device mesh setup, data-parallel batch sharding,
collective merges (psum/all_gather) — the replacement for the
reference's OpenMP/thread-pool runtime (SURVEY.md §2.4)."""

from .mesh import make_mesh, shard_batch, pad_to_multiple  # noqa: F401
