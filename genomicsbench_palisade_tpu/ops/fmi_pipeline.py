"""The fmi benchmark's 3-phase SMEM pipeline — fully on-device.

Mirrors benchmarks/fmi/fmi.cpp:229-345 per read batch:
  phase 1: all-position SMEMs, min_intv=1
  phase 2: reseed — SMEMs with length >= split_len AND s <= splitWidth
           restart a one-pos search at their midpoint with min_intv=s+1
  phase 3: LAST strategy, max_intv=maxMemIntv, minSeedLen+1

All three phases (including the phase-2 filter/compaction) run inside a
single jit, and results come back as ONE packed int array — exactly one
host round trip per batch (each fetch is a synchronization point, so
per-phase fetches would serialize the host and the device).  Host-side work is just
unpack + lexsort, like the reference driver's sortSMEMs (fmi.cpp:340).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import fmi as F

SPLIT_WIDTH = 10
MAX_MEM_INTV = 20
SPLIT_FACTOR = 1.5


@functools.partial(
    jax.jit,
    static_argnames=("min_seed_len", "split_width", "max_mem_intv",
                     "split_len", "m_cap", "reseed_cap"),
)
def fmi_pipeline_device(
    index,
    enc,
    readlen,
    min_seed_len: int,
    split_width: int,
    max_mem_intv: int,
    split_len: int,
    m_cap: int = 96,
    reseed_cap: int | None = None,
):
    """Returns (packed [2B+R, 3+5*cap] i32, global_overflow bool).

    Packed row layout: [rid, count, ovf, m[cap], n[cap], k[cap], l[cap],
    s[cap]].  Rows 0..B-1 = phase 1, B..B+R-1 = phase 2 reseeds (rid = -1
    for unused reseed lanes), B+R.. = phase 3.
    """
    b, l_max = enc.shape
    r = reseed_cap if reseed_cap is not None else 2 * b
    lane_rid = jnp.arange(b, dtype=jnp.int32)

    # ---- phase 1
    bufs1, counts1, ovf1 = F.smems_all_pos_batch(
        index, enc, readlen, jnp.ones(b, jnp.int32), min_seed_len, m_cap=m_cap
    )

    # ---- phase 2 filter on device (fmi.cpp:293-302)
    slot_iota = jnp.arange(m_cap, dtype=jnp.int32)[None, :]
    valid1 = slot_iota < counts1[:, None]
    length = bufs1["n"] + 1 - bufs1["m"]
    keep = valid1 & (length >= split_len) & (bufs1["s"] <= split_width)
    flat_keep = keep.ravel()
    pos = jnp.cumsum(flat_keep.astype(jnp.int32)) - 1
    # qualifying SMEMs past the reseed cap route to the dummy slot r (NOT
    # clamped to r-1): the kept prefix stays deterministic and ovf_reseed
    # tells the caller to re-dispatch with a larger cap
    dest = jnp.where(flat_keep & (pos < r), pos, r)
    n_reseed = jnp.sum(flat_keep.astype(jnp.int32))
    ovf_reseed = n_reseed > r

    lane_of = jnp.broadcast_to(lane_rid[:, None], (b, m_cap)).ravel()
    mid_of = ((bufs1["n"] + 1 + bufs1["m"]) >> 1).astype(jnp.int32).ravel()
    miv_of = (bufs1["s"] + 1).astype(jnp.int32).ravel()

    rid2 = jnp.full(r + 1, -1, jnp.int32).at[dest].set(lane_of)[:r]
    mid2 = jnp.full(r + 1, 0, jnp.int32).at[dest].set(mid_of)[:r]
    miv2 = jnp.full(r + 1, 1, jnp.int32).at[dest].set(miv_of)[:r]
    used2 = rid2 >= 0
    rid2c = jnp.maximum(rid2, 0)
    enc2 = enc[rid2c]
    rl2 = jnp.where(used2, readlen[rid2c], 0)  # unused lanes: empty reads

    bufs2, counts2, _nx, ovf2 = F.smems_one_pos_batch(
        index, enc2, rl2, mid2, miv2, min_seed_len, m_cap=m_cap
    )

    # ---- phase 3: LAST
    bufs3, counts3, ovf3 = F.bwt_seed_strategy_batch(
        index, enc, readlen, jnp.full(b, max_mem_intv, jnp.int32),
        min_seed_len + 1, m_cap=m_cap,
    )

    pdt = index["cp_count"].dtype  # i32 or i64: k/l/s must not truncate

    def pack(rid, counts, ovf, bufs):
        cols = [rid.astype(pdt)[:, None], counts.astype(pdt)[:, None],
                ovf.astype(pdt)[:, None]]
        for key in ("m", "n", "k", "l", "s"):
            cols.append(bufs[key].astype(pdt))
        return jnp.concatenate(cols, axis=1)

    packed = jnp.concatenate(
        [
            pack(lane_rid, counts1, ovf1, bufs1),
            pack(rid2, counts2, ovf2 & used2, bufs2),
            pack(lane_rid, counts3, ovf3, bufs3),
        ],
        axis=0,
    )
    return packed, ovf_reseed


def _extract_packed(packed: np.ndarray, cap: int, rid_offset: int = 0):
    rid = packed[:, 0]
    counts = np.minimum(packed[:, 1], cap)
    counts = np.where(rid < 0, 0, counts)
    cols = {}
    for ci, key in enumerate(("m", "n", "k", "l", "s")):
        cols[key] = packed[:, 3 + ci * cap : 3 + (ci + 1) * cap]
    lanes = np.repeat(np.arange(len(counts)), counts)
    slot = (np.arange(int(counts.sum()))
            - np.repeat(np.cumsum(counts) - counts, counts)
            if lanes.size else np.zeros(0, np.int64))
    out = {"rid": rid[lanes].astype(np.int64) + rid_offset}
    for key in ("m", "n", "k", "l", "s"):
        out[key] = cols[key][lanes, slot].astype(np.int64)
    return out, int(packed[:, 2].astype(bool).any())


def fmi_pipeline_dispatch(
    index,
    enc: np.ndarray,
    readlen: np.ndarray,
    min_seed_len: int = 19,
    split_width: int = SPLIT_WIDTH,
    max_mem_intv: int = MAX_MEM_INTV,
    split_factor: float = SPLIT_FACTOR,
    m_cap: int = 96,
    reseed_cap: int | None = None,
):
    """Launch one batch asynchronously; returns device handles.

    Lets the driver software-pipeline batches: dispatch batch k+1 before
    fetching batch k, hiding the fetch + host unpack.
    Pass a larger ``reseed_cap`` (default 2*B) to re-dispatch a batch
    whose collect reported reseed overflow."""
    split_len = int(min_seed_len * split_factor + 0.499)
    return fmi_pipeline_device(
        index, jnp.asarray(enc), jnp.asarray(readlen),
        min_seed_len, split_width, max_mem_intv, split_len, m_cap=m_cap,
        reseed_cap=reseed_cap,
    )


def fmi_pipeline_collect(handles, b: int, rid_base: int = 0, m_cap: int = 96):
    """Fetch + unpack a dispatched batch (the ONE host round trip)."""
    packed_d, ovf_reseed = handles
    packed = np.asarray(packed_d)
    r = packed.shape[0] - 2 * b

    s1, ovf1 = _extract_packed(packed[:b], m_cap, rid_base)
    s2, ovf2 = _extract_packed(packed[b : b + r], m_cap, rid_base)
    s3, ovf3 = _extract_packed(packed[b + r :], m_cap, rid_base)
    n1, n2, n3 = len(s1["m"]), len(s2["m"]), len(s3["m"])

    keys = ("rid", "m", "n", "k", "l", "s")
    allm = {k: np.concatenate([s1[k], s2[k], s3[k]]) for k in keys}
    order = np.lexsort((-allm["n"].astype(np.int64), allm["m"], allm["rid"]))
    allm = {k: v[order] for k, v in allm.items()}
    ovf = bool(ovf1 or ovf2 or ovf3 or bool(np.asarray(ovf_reseed)))
    return allm, n1, n2, n3, ovf


def fmi_pipeline_batch(
    index,
    enc: np.ndarray,
    readlen: np.ndarray,
    min_seed_len: int = 19,
    split_width: int = SPLIT_WIDTH,
    max_mem_intv: int = MAX_MEM_INTV,
    split_factor: float = SPLIT_FACTOR,
    rid_base: int = 0,
    m_cap: int = 96,
    reseed_cap: int | None = None,
):
    """One batch of reads through all three phases (one device round trip).

    enc: [B, L] int32 codes (0-3, >=4 ambiguous); readlen: [B].
    Returns (sorted smem dict of numpy arrays, n1, n2, n3, overflow_any).
    """
    handles = fmi_pipeline_dispatch(
        index, enc, readlen, min_seed_len, split_width, max_mem_intv,
        split_factor, m_cap=m_cap, reseed_cap=reseed_cap,
    )
    return fmi_pipeline_collect(handles, enc.shape[0], rid_base, m_cap)
