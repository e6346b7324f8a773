"""FM-index build/load and conversion to the device layout.

Reference index format `.bwt.2bit.64` (tools/bwa-mem2/src/FMI_search.cpp
:176-356 build_fm_index, :469-588 load_index):
    int64   ref_seq_len              (= 2*L + 1, fwd + revcomp + sentinel)
    int64   count[5]                 (cumulative, pre-sentinel-adjustment)
    CP_OCC  cp_occ[(ref_seq_len>>6)+1]   struct: int64 cp_count[4];
                                          uint64 one_hot_bwt_str[4]
    int8    sa_ms_byte[ref_seq_len]  (or compressed every 8th entry)
    uint32  sa_ls_word[ref_seq_len]
    int64   sentinel_index

Device layout: cp_count as int64 [blocks, 4] (or int32 for small indexes)
and the one-hot planes split into two uint32 words per (block, base):
hi = block positions 0..31 (bits 63..32), lo = positions 32..63 — the
device code avoids u64 (JAX disables 64-bit types by default), so
popcounts run on u32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.oracle import fmi as fmi_oracle

CP_SHIFT = 6
CP_MASK = 63


@dataclass
class DeviceFmIndex:
    ref_seq_len: int
    count: np.ndarray  # [5] (sentinel-adjusted, +1)
    sentinel_index: int
    cp_count: np.ndarray  # [blocks, 4] int
    one_hot_hi: np.ndarray  # [blocks, 4] uint32 (block positions 0..31)
    one_hot_lo: np.ndarray  # [blocks, 4] uint32 (block positions 32..63)
    sa_ms_byte: np.ndarray | None = None
    sa_ls_word: np.ndarray | None = None
    sa_compression: bool = False  # SA sampled every 8th row (SA_COMPX=3)
    idx_dtype: type = np.int64

    def as_device_arrays(self):
        dt = self.idx_dtype
        pack = make_cp_pack(self.cp_count, self.one_hot_hi, self.one_hot_lo)
        return {
            "count": self.count.astype(dt),
            "cp_count": self.cp_count.astype(dt),
            "cp_pack": pack,
            "one_hot_hi": self.one_hot_hi,
            "one_hot_lo": self.one_hot_lo,
            "sentinel_index": dt(self.sentinel_index),
        }


def make_cp_pack(cp_count: np.ndarray, one_hot_hi: np.ndarray,
                 one_hot_lo: np.ndarray) -> np.ndarray:
    """cp_pack: one 64-byte row per block, exactly the reference's
    cache-line CP_OCC (FMI_search.h:59-63) — counts split into u32
    lo/hi planes plus the two one-hot word planes, so one occ lookup
    is ONE row gather instead of three."""
    cnt = cp_count.astype(np.uint64)
    pack = np.empty((cnt.shape[0], 16), np.uint32)
    pack[:, 0:4] = (cnt & 0xFFFFFFFF).astype(np.uint32)
    pack[:, 4:8] = (cnt >> 32).astype(np.uint32)
    pack[:, 8:12] = one_hot_hi
    pack[:, 12:16] = one_hot_lo
    return pack


def from_oracle_index(idx: fmi_oracle.FmIndex, idx_dtype=np.int32) -> DeviceFmIndex:
    """Convert a (tiny, test-sized) oracle index to the device layout."""
    one_hot = idx.one_hot  # [blocks, 4] uint64, MSB-first
    hi = (one_hot >> np.uint64(32)).astype(np.uint32)
    lo = (one_hot & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return DeviceFmIndex(
        ref_seq_len=idx.ref_seq_len,
        count=idx.count.copy(),  # already sentinel-adjusted by the oracle
        sentinel_index=idx.sentinel_index,
        cp_count=idx.cp_count.copy(),
        one_hot_hi=hi,
        one_hot_lo=lo,
        sa_ms_byte=None,
        sa_ls_word=None,
        idx_dtype=idx_dtype,
    )


def build_from_sequence(forward_seq: str, idx_dtype=np.int32) -> DeviceFmIndex:
    return from_oracle_index(fmi_oracle.build_index(forward_seq), idx_dtype)


def load_bwt2bit64(path: str, sa_compression: bool = False, load_sa: bool = False) -> DeviceFmIndex:
    """Load the reference's binary `.bwt.2bit.64` index (64-byte CP_OCC
    records: 4x int64 cp_count + 4x uint64 one-hot planes)."""
    with open(path, "rb") as f:
        ref_seq_len = int(np.fromfile(f, dtype=np.int64, count=1)[0])
        count = np.fromfile(f, dtype=np.int64, count=5) + 1  # sentinel adj
        blocks = (ref_seq_len >> CP_SHIFT) + 1
        raw = np.fromfile(f, dtype=np.uint64, count=blocks * 8).reshape(blocks, 8)
        cp_count = raw[:, :4].view(np.int64)
        one_hot = raw[:, 4:]
        hi = (one_hot >> np.uint64(32)).astype(np.uint32)
        lo = (one_hot & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        sa_ms = sa_ls = None
        n_sa = ((ref_seq_len >> 3) + 1) if sa_compression else ref_seq_len
        if load_sa:
            sa_ms = np.fromfile(f, dtype=np.int8, count=n_sa)
            sa_ls = np.fromfile(f, dtype=np.uint32, count=n_sa)
        else:
            f.seek(n_sa * 1 + n_sa * 4, 1)
        sentinel = int(np.fromfile(f, dtype=np.int64, count=1)[0])
    return DeviceFmIndex(
        ref_seq_len=ref_seq_len,
        count=count,
        sentinel_index=sentinel,
        cp_count=cp_count,
        one_hot_hi=hi,
        one_hot_lo=lo,
        sa_ms_byte=sa_ms,
        sa_ls_word=sa_ls,
        sa_compression=sa_compression,
        idx_dtype=np.int64,
    )


def save_npz(idx: DeviceFmIndex, path: str):
    np.savez_compressed(
        path,
        ref_seq_len=idx.ref_seq_len,
        count=idx.count,
        sentinel_index=idx.sentinel_index,
        cp_count=idx.cp_count,
        one_hot_hi=idx.one_hot_hi,
        one_hot_lo=idx.one_hot_lo,
    )


def load_npz(path: str, idx_dtype=np.int64) -> DeviceFmIndex:
    z = np.load(path, allow_pickle=True)
    sa_ms = z["sa_ms_byte"] if "sa_ms_byte" in z.files and z["sa_ms_byte"].size else None
    sa_ls = z["sa_ls_word"] if "sa_ls_word" in z.files and z["sa_ls_word"].size else None
    idx = DeviceFmIndex(
        ref_seq_len=int(z["ref_seq_len"]),
        count=z["count"],
        sentinel_index=int(z["sentinel_index"]),
        cp_count=z["cp_count"],
        one_hot_hi=z["one_hot_hi"],
        one_hot_lo=z["one_hot_lo"],
        sa_ms_byte=sa_ms,
        sa_ls_word=sa_ls,
        sa_compression=bool(z["sa_compression"])
        if "sa_compression" in z.files
        # legacy archives lack the flag: infer from the SA sample count
        else (sa_ms is not None
              and len(sa_ms) < int(z["ref_seq_len"])),
        idx_dtype=idx_dtype,
    )
    # remembered so the host engine can find/persist its packed-occ-row
    # sidecar (<path>.hostpack.npy) — see io.native.fmi_search_native
    idx._npz_path = path
    return idx


# ---------------------------------------------------------------------------
# sharded on-disk index (per-host artifacts for multi-host meshes)
# ---------------------------------------------------------------------------
#
# The reference persists ONE monolithic index file that every process
# loads whole (FMI_search.cpp:469-588 load_index).  For a multi-host mesh
# running the block-range-sharded search (parallel/dp.py
# fmi_pipeline_index_sharded), each host only ever feeds its own cp_occ
# block range to its devices — so the index is also persisted SHARDED:
#   {prefix}.manifest.npz         replicated small arrays + shard geometry
#   {prefix}.shard{i}-of-{n}.npz  cp_occ planes rows [i*R, (i+1)*R) and the
#                                 matching SA sample range
# Every shard holds exactly R = rows_per_shard rows (the tail shard is
# zero-padded past the real block count) so host-local -> global array
# assembly needs no per-shard shape cases; R is rounded to a multiple of
# 8 so it always subdivides across a host's local devices.


def save_npz_sharded(idx: DeviceFmIndex, prefix: str, n_shards: int,
                     names=None, lengths=None) -> list[str]:
    """Write the index as a manifest + n_shards block-range shard files.
    Returns the list of written paths."""
    blocks = idx.cp_count.shape[0]
    rows = -(-blocks // n_shards)
    rows = (rows + 7) & ~7  # multiple of 8: divides across local devices
    n_sa = 0 if idx.sa_ms_byte is None else len(idx.sa_ms_byte)
    sa_rows = -(-n_sa // n_shards) if n_sa else 0
    extra = {}
    if names is not None:
        extra["contig_names"] = np.asarray(names, dtype=object)
        extra["contig_lengths"] = np.asarray(lengths, np.int64)
    paths = [f"{prefix}.manifest.npz"]
    np.savez_compressed(
        paths[0],
        ref_seq_len=idx.ref_seq_len,
        count=idx.count,
        sentinel_index=idx.sentinel_index,
        n_shards=n_shards,
        blocks=blocks,
        rows_per_shard=rows,
        n_sa=n_sa,
        sa_rows_per_shard=sa_rows,
        sa_compression=np.bool_(idx.sa_compression),
        **extra,
    )

    def _pad(a, want_rows):
        if a.shape[0] >= want_rows:
            return a[:want_rows]
        padded = np.zeros((want_rows,) + a.shape[1:], a.dtype)
        padded[: a.shape[0]] = a
        return padded

    for i in range(n_shards):
        b0 = i * rows
        s0 = i * sa_rows
        shard = {
            "cp_count": _pad(idx.cp_count[b0 : b0 + rows], rows),
            "one_hot_hi": _pad(idx.one_hot_hi[b0 : b0 + rows], rows),
            "one_hot_lo": _pad(idx.one_hot_lo[b0 : b0 + rows], rows),
        }
        if n_sa:
            shard["sa_ms_byte"] = _pad(idx.sa_ms_byte[s0 : s0 + sa_rows], sa_rows)
            shard["sa_ls_word"] = _pad(idx.sa_ls_word[s0 : s0 + sa_rows], sa_rows)
        path = f"{prefix}.shard{i}-of-{n_shards}.npz"
        np.savez_compressed(path, **shard)
        paths.append(path)
    return paths


def load_shard_manifest(prefix: str) -> dict:
    z = np.load(f"{prefix}.manifest.npz", allow_pickle=True)
    return {k: z[k] for k in z.files}


def load_npz_shard(prefix: str, shard: int) -> dict:
    """One host's slice: cp_occ plane rows (+ cp_pack) and SA sample rows.

    Returns {"cp_count", "one_hot_hi", "one_hot_lo", "cp_pack",
    "block_start", ["sa_ms_byte", "sa_ls_word", "sa_start"]}."""
    man = load_shard_manifest(prefix)
    n = int(man["n_shards"])
    z = np.load(f"{prefix}.shard{shard}-of-{n}.npz")
    out = {k: z[k] for k in z.files}
    out["cp_pack"] = make_cp_pack(
        out["cp_count"], out["one_hot_hi"], out["one_hot_lo"])
    out["block_start"] = shard * int(man["rows_per_shard"])
    if "sa_ms_byte" in out:
        out["sa_start"] = shard * int(man["sa_rows_per_shard"])
    return out


def load_npz_sharded(prefix: str, idx_dtype=np.int64) -> DeviceFmIndex:
    """Reassemble the full index from shard files (single-host use and
    the parity leg of multi-host tests)."""
    man = load_shard_manifest(prefix)
    n = int(man["n_shards"])
    blocks = int(man["blocks"])
    n_sa = int(man["n_sa"])
    shards = [np.load(f"{prefix}.shard{i}-of-{n}.npz") for i in range(n)]
    cat = lambda key: np.concatenate([z[key] for z in shards])
    sa_ms = sa_ls = None
    if n_sa:
        sa_ms = cat("sa_ms_byte")[:n_sa]
        sa_ls = cat("sa_ls_word")[:n_sa]
    return DeviceFmIndex(
        ref_seq_len=int(man["ref_seq_len"]),
        count=man["count"],
        sentinel_index=int(man["sentinel_index"]),
        cp_count=cat("cp_count")[:blocks],
        one_hot_hi=cat("one_hot_hi")[:blocks],
        one_hot_lo=cat("one_hot_lo")[:blocks],
        sa_ms_byte=sa_ms,
        sa_ls_word=sa_ls,
        sa_compression=bool(man["sa_compression"]),
        idx_dtype=idx_dtype,
    )


# ---------------------------------------------------------------------------
# suffix-array entry lookup (FMI_search.cpp:1568-1625 get_sa_entry*)
# ---------------------------------------------------------------------------

def host_occ(idx: DeviceFmIndex, pp: int, c: int) -> int:
    """# of char c in bwt[0:pp] from the split one-hot planes (GET_OCC)."""
    blk = pp >> CP_SHIFT
    y = pp & CP_MASK
    base = int(idx.cp_count[blk, c])
    if y == 0:
        return base
    hi = int(idx.one_hot_hi[blk, c])
    lo = int(idx.one_hot_lo[blk, c])
    if y <= 32:
        bits = hi >> (32 - y) if y < 32 else hi
        return base + bits.bit_count()
    return base + hi.bit_count() + (lo >> (64 - y)).bit_count()


def host_bwt_char(idx: DeviceFmIndex, pos: int) -> int:
    """BWT character at SA row pos (4 = sentinel)."""
    blk = pos >> CP_SHIFT
    bit = 1 << (31 - (pos & 31)) if (pos & CP_MASK) < 32 else 1 << (63 - (pos & CP_MASK))
    plane = "one_hot_hi" if (pos & CP_MASK) < 32 else "one_hot_lo"
    arr = getattr(idx, plane)
    for c in range(4):
        if int(arr[blk, c]) & bit:
            return c
    return 4


def get_sa_entry(idx: DeviceFmIndex, pos: int) -> int:
    """Reference coordinate of SA row pos (FMI_search.cpp:1568-1578;
    compressed variant walks LF to a sampled row, :1621-1625 semantics)."""
    if idx.sa_ms_byte is None:
        raise ValueError("index carries no SA arrays")
    if not idx.sa_compression:
        return (int(idx.sa_ms_byte[pos]) << 32) + int(idx.sa_ls_word[pos])
    offset = 0
    while pos & 7:
        if pos == idx.sentinel_index:
            return offset  # SA[sentinel row] = 0
        c = host_bwt_char(idx, pos)
        pos = int(idx.count[c]) + host_occ(idx, pos, c)  # LF step
        offset += 1
    return (int(idx.sa_ms_byte[pos >> 3]) << 32) + int(idx.sa_ls_word[pos >> 3]) + offset


def get_sa_entries(idx: DeviceFmIndex, positions) -> np.ndarray:
    """Bulk coordinate lookup (get_sa_entries, FMI_search.cpp:1581-1594)."""
    positions = np.asarray(positions, np.int64)
    if not idx.sa_compression:
        return (idx.sa_ms_byte[positions].astype(np.int64) << 32) + \
            idx.sa_ls_word[positions].astype(np.int64)
    return np.array([get_sa_entry(idx, int(p)) for p in positions], np.int64)


def get_sa_entries_smems(idx: DeviceFmIndex, smem_k, smem_s, max_occ: int):
    """Per-SMEM subsampled coordinates (FMI_search.cpp:1596-1619): for each
    interval [k, k+s) take at most max_occ entries with stride s//max_occ.
    Returns (coords int64[total], counts int32[num_smems])."""
    coords, counts = [], []
    for k, s in zip(np.asarray(smem_k, np.int64), np.asarray(smem_s, np.int64)):
        step = s // max_occ if s > max_occ else 1
        c = 0
        j = int(k)
        hi = int(k + s)
        while j < hi and c < max_occ:
            coords.append(get_sa_entry(idx, j))
            j += int(step)
            c += 1
        counts.append(c)
    return np.asarray(coords, np.int64), np.asarray(counts, np.int32)
