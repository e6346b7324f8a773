"""FM-index SMEM seeding on the device (bwa-mem2 semantics).

The reference walks each read's SMEM search with
pointer-chasing occ lookups (FMI_search.cpp:986-1326); here thousands of
reads advance in lock-step, each step doing batched gathers into the
checkpointed-occ arrays (cp_count int planes + one-hot BWT bit planes as
2x uint32 words — no u64 on device) followed by vector popcount math.

Key reformulations (all bit-parity-tested against the oracle):
  * backwardExt([B] intervals) = two [B,4] gather+popcount occ batches,
    reverse-cumsum for the l updates, sentinel offset (:1536-1565)
  * getSMEMsOnePos's prevArray inner loops: prev entries live in FIXED
    slots with validity masks.  Intervals along prev are nested, so the
    extended sizes are monotone in the slot index and the reference's
    "s != curr_s" dedup is exactly `new_s > (exclusive running max of
    kept s)` — one vector op instead of a sequential scan, and no
    compaction is ever needed (valid slots only get invalidated).
  * the first-loop/second-loop split (:1119-1165): the first (c1|c2) slot
    p0 emits a match iff c1[p0]; all other slots follow the second-loop
    keep rule.
  * getSMEMsAllPos's do-while read compaction becomes masked restarts in
    a while_loop (idle lanes park).

Match outputs go to fixed [B, M_cap] buffers with per-read counters;
overflow is flagged for host fallback (never observed at default caps).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(1 << 30)


@jax.tree_util.register_static
class ShardAxis:
    """Pytree-STATIC marker carried inside an index dict: names the mesh
    axis whose shard_map owns the cp_pack rows.  Being static, the jitted
    pipeline functions re-trace (with psum broadcasts) instead of reusing
    an unsharded cache entry."""

    def __init__(self, name: str):
        self.name = name

    def __hash__(self):
        return hash(("ShardAxis", self.name))

    def __eq__(self, other):
        return isinstance(other, ShardAxis) and self.name == other.name


def _masks_for_y(y):
    """Top-y-bit masks of a 64-bit block split into (hi, lo) u32 words."""
    y = y.astype(jnp.int32)
    ym = jnp.clip(y, 0, 32)
    hi_mask = jnp.where(
        ym == 0,
        jnp.uint32(0),
        (jnp.uint32(0xFFFFFFFF) << jnp.clip(32 - ym, 0, 31)).astype(jnp.uint32),
    )
    ym2 = jnp.clip(y - 32, 0, 32)
    lo_mask = jnp.where(
        ym2 == 0,
        jnp.uint32(0),
        (jnp.uint32(0xFFFFFFFF) << jnp.clip(32 - ym2, 0, 31)).astype(jnp.uint32),
    )
    return hi_mask, lo_mask


def occ_from_pack_row(row, pp, out_dt):
    """GET_OCC from an already-fetched packed 64-byte block row.

    row: [..., 16] u32 (cp_count lo/hi words + one-hot hi/lo planes);
    pp: the positions the rows were fetched for.  Shared by occ_all and
    the sharded-index path (parallel.dp.fmi_backward_search_sharded)."""
    y = (pp & 63).astype(jnp.int32)
    hi_mask, lo_mask = _masks_for_y(y)
    base = row[..., 0:4].astype(out_dt)
    if out_dt == jnp.int64:
        base = base + (row[..., 4:8].astype(out_dt) << 32)
    hi = row[..., 8:12]
    lo = row[..., 12:16]
    cnt = jax.lax.population_count(hi & hi_mask[..., None]) + jax.lax.population_count(
        lo & lo_mask[..., None]
    )
    return base + cnt.astype(base.dtype)


def occ_all(index, pp):
    """occ(pp, c) for all four bases: pp [...] -> [..., 4] (GET_OCC).

    Uses the packed 64-byte block row (one gather per position, the
    reference's cache-line CP_OCC layout) when the index provides it.
    When the index carries "shard_axis" (inside a shard_map whose
    cp_pack rows are sharded by block range — genome-scale indexes
    outgrow one device's memory), the owner shard gathers locally and
    broadcasts the row with one psum, so the FULL 3-phase SMEM pipeline
    runs unchanged over a sharded index."""
    blk = (pp >> 6).astype(jnp.int32)
    pack = index.get("cp_pack")
    axis = index.get("shard_axis")
    if pack is not None and axis is not None:
        rows_per = pack.shape[0]
        off = jax.lax.axis_index(axis.name).astype(jnp.int32) * rows_per
        loc = blk - off
        mine = (loc >= 0) & (loc < rows_per)
        row = pack[jnp.clip(loc, 0, rows_per - 1)]
        row = jnp.where(mine[..., None], row, 0)
        row = jax.lax.psum(row, axis.name)  # owner shard broadcasts the row
        return occ_from_pack_row(row, pp, index["cp_count"].dtype)
    if pack is not None:
        row = pack[blk]  # [..., 16] — ONE contiguous gather
        return occ_from_pack_row(row, pp, index["cp_count"].dtype)
    y = (pp & 63).astype(jnp.int32)
    hi_mask, lo_mask = _masks_for_y(y)
    base = index["cp_count"][blk]  # [..., 4]
    hi = index["one_hot_hi"][blk]
    lo = index["one_hot_lo"][blk]
    cnt = jax.lax.population_count(hi & hi_mask[..., None]) + jax.lax.population_count(
        lo & lo_mask[..., None]
    )
    return base + cnt.astype(base.dtype)


def backward_ext(index, k, l, s, a):
    """Batched backwardExt: (k,l,s,a) [...] -> new (k,l,s)."""
    occ_sp = occ_all(index, k)  # [..., 4]
    occ_ep = occ_all(index, k + s)
    return backward_ext_from_occ(
        index["count"], index["sentinel_index"], k, l, s, a, occ_sp, occ_ep)


def backward_ext_from_occ(count, sentinel, k, l, s, a, occ_sp, occ_ep):
    """backwardExt given already-computed occ(k)/occ(k+s) (shared with the
    sharded-index path, where the occ rows arrive via collectives)."""
    sp = k
    ep = k + s
    k4 = count[:4] + occ_sp
    s4 = occ_ep - occ_sp
    sent = sentinel
    off = ((sp <= sent) & (ep > sent)).astype(k4.dtype)
    # l[3]=l+off; l[2]=l[3]+s[3]; l[1]=l[2]+s[2]; l[0]=l[1]+s[1]
    l3 = l + off
    l2 = l3 + s4[..., 3]
    l1 = l2 + s4[..., 2]
    l0 = l1 + s4[..., 1]
    l4 = jnp.stack([l0, l1, l2, l3], axis=-1)
    a_idx = a[..., None].astype(jnp.int32)
    k_new = jnp.take_along_axis(k4, a_idx, axis=-1)[..., 0]
    l_new = jnp.take_along_axis(l4, a_idx, axis=-1)[..., 0]
    s_new = jnp.take_along_axis(s4, a_idx, axis=-1)[..., 0]
    return k_new, l_new, s_new


def forward_ext(index, k, l, s, a):
    """Forward extension = backward on the revcomp (swap k/l, base 3-a)."""
    k2, l2, s2 = backward_ext(index, l, k, s, 3 - a)
    return l2, k2, s2


def _root_interval(index, a, dt):
    count = index["count"]
    k = count[a]
    l = count[3 - a]
    s = count[a + 1] - count[a]
    return k.astype(dt), l.astype(dt), s.astype(dt)


def _emit(bufs, counts, mask, m, n, k, l, s, m_cap):
    """Append (m,n,k,l,s) at counts[lane] where mask; returns new bufs/counts."""
    b = counts.shape[0]
    lane = jnp.arange(b)
    slot = jnp.minimum(counts, m_cap - 1)
    def upd(buf, val):
        cur = buf[lane, slot]
        return buf.at[lane, slot].set(jnp.where(mask, val, cur))
    bufs = dict(
        m=upd(bufs["m"], m),
        n=upd(bufs["n"], n),
        k=upd(bufs["k"], k),
        l=upd(bufs["l"], l),
        s=upd(bufs["s"], s),
    )
    counts = counts + mask.astype(jnp.int32)
    return bufs, counts


def _row_write(trace, t, row):
    """Write row [B] at step index t of trace [T, B] (contiguous store,
    NOT a scatter — scatters inside device loops are slow)."""
    return jax.lax.dynamic_update_slice_in_dim(trace, row[None, :], t, 0)


def _compact_trace(flags, rows, cap):
    """flags [T, B] bool; rows: dict of [T, B]. Returns (dict of [B, cap]
    in step order, counts [B]).  Vectorized replacement for per-step
    append scatters: stable-argsort pushes to the front, take first cap.

    Truncation policy on overflow (count > cap): the FIRST cap pushes in
    step order are kept (the reference has no cap at all; a previous
    engine revision kept the newest push in the last slot instead) —
    engine-vs-engine diffs on overflowing reads are expected and the
    overflow flag marks them."""
    t = flags.shape[0]
    if t < cap:  # trace shorter than the slot buffer: pad with non-pushes
        pad = ((0, cap - t), (0, 0))
        flags_p = jnp.pad(flags, pad)
        rows = {k: jnp.pad(v, pad) for k, v in rows.items()}
    else:
        flags_p = flags
    order = jnp.argsort(~flags_p, axis=0, stable=True)[:cap]  # [cap, B]
    out = {key: jnp.take_along_axis(arr, order, axis=0).T for key, arr in rows.items()}
    counts = jnp.sum(flags, axis=0).astype(jnp.int32)
    return out, counts


def _new_match_bufs(b, m_cap, dt):
    z = jnp.zeros((b, m_cap), dt)
    zi = jnp.zeros((b, m_cap), jnp.int32)
    return dict(m=zi, n=zi, k=z, l=z, s=z)


@functools.partial(
    jax.jit, static_argnames=("min_seed_len", "m_cap", "p_cap", "max_l")
)
def smems_one_pos_batch(
    index, enc, readlen, x0, min_intv, min_seed_len, m_cap=64, p_cap=48, max_l=None
):
    """Batched getSMEMsOnePosOneThread (one starting position per lane).

    enc: [B, L] int32 base codes; readlen, x0, min_intv: [B].
    Returns (match bufs dict [B, m_cap], counts [B], next_x [B], overflow [B]).
    """
    b, l_max = enc.shape
    if max_l is None:
        max_l = l_max
    dt = index["cp_count"].dtype

    a0 = jnp.take_along_axis(enc, jnp.clip(x0, 0, l_max - 1)[:, None], 1)[:, 0]
    lane_ok = (a0 < 4) & (x0 < readlen)
    k0, l0, s0 = _root_interval(index, jnp.clip(a0, 0, 3), dt)

    # ---------------- forward sweep ----------------
    # state: cur smem (m=x0, n, k, l, s); push slots [B, p_cap] in push order
    def fwd_cond(st):
        return jnp.any(st["run"])

    def fwd_body(st):
        j = st["j"]
        t = st["t"]
        aj = jnp.take_along_axis(enc, jnp.clip(j, 0, l_max - 1)[:, None], 1)[:, 0]
        run = st["run"] & (j < readlen)
        valid_a = aj < 4
        do = run & valid_a
        nk, nl, ns = forward_ext(index, st["k"], st["l"], st["s"], jnp.clip(aj, 0, 3))
        s_neq = ns != st["s"]
        # push old smem when s differs (pre-break push, :1060-1066) —
        # recorded as a step-indexed trace ROW (contiguous store); the
        # per-slot append happens once after the loop in _compact_trace
        push = do & s_neq
        tpush = _row_write(st["tpush"], t, push)
        tm = _row_write(st["tm"], t, st["m"])
        tn = _row_write(st["tn"], t, st["n"])
        tk = _row_write(st["tk"], t, st["k"])
        tl = _row_write(st["tl"], t, st["l"])
        ts = _row_write(st["ts"], t, st["s"])
        below = ns < min_intv
        adopt = do & ~below
        k = jnp.where(adopt, nk, st["k"])
        l = jnp.where(adopt, nl, st["l"])
        s = jnp.where(adopt, ns, st["s"])
        n = jnp.where(adopt, j, st["n"])
        # next_x bookkeeping: j+1 normally; j when breaking on s<min_intv
        brk_s = do & below
        brk_a = run & ~valid_a  # N base: break, next_x stays j+1
        nx = jnp.where(st["run"], jnp.where(brk_s, j, j + 1), st["nx"])
        run = run & ~brk_s & ~brk_a & (j + 1 < readlen)
        return dict(
            st,
            j=j + 1,
            t=t + 1,
            run=run,
            k=k,
            l=l,
            s=s,
            n=n,
            tpush=tpush,
            tm=tm,
            tn=tn,
            tk=tk,
            tl=tl,
            ts=ts,
            nx=nx,
        )

    st = dict(
        j=x0 + 1,
        t=jnp.int32(0),
        run=lane_ok & (x0 + 1 < readlen),
        m=x0,
        n=x0,
        k=k0,
        l=l0,
        s=s0,
        tpush=jnp.zeros((max_l, b), bool),
        tm=jnp.zeros((max_l, b), jnp.int32),
        tn=jnp.zeros((max_l, b), jnp.int32),
        tk=jnp.zeros((max_l, b), dt),
        tl=jnp.zeros((max_l, b), dt),
        ts=jnp.zeros((max_l, b), dt),
        nx=jnp.where(lane_ok, x0 + 1, x0 + 1),
    )
    st = jax.lax.while_loop(fwd_cond, fwd_body, st)
    fwd_rows, cnt = _compact_trace(
        st["tpush"],
        dict(pm=st["tm"], pn=st["tn"], pk=st["tk"], pl=st["tl"], ps=st["ts"]),
        p_cap,
    )
    overflow0 = cnt > p_cap
    cnt = jnp.minimum(cnt, p_cap)

    # final push: if smem.s >= min_intv (:1085-1090) — may duplicate the
    # pre-break push, exactly like the reference (one write, not per-step)
    push = lane_ok & (st["s"] >= min_intv.astype(dt))
    lane = jnp.arange(b)
    slot = jnp.minimum(cnt, p_cap - 1)
    def pw2(buf, val):
        cur = buf[lane, slot]
        return buf.at[lane, slot].set(jnp.where(push, val, cur))
    pm = pw2(fwd_rows["pm"], x0)
    pn = pw2(fwd_rows["pn"], st["n"])
    pk = pw2(fwd_rows["pk"], st["k"])
    pl = pw2(fwd_rows["pl"], st["l"])
    ps = pw2(fwd_rows["ps"], st["s"])
    cnt = cnt + push.astype(jnp.int32)
    overflow = overflow0 | (cnt > p_cap)
    cnt = jnp.minimum(cnt, p_cap)
    next_x = jnp.where(lane_ok, st["nx"], x0 + 1)

    # reverse the prev array (prevArray in-place reversal, :1092-1100)
    p_iota = jnp.arange(p_cap, dtype=jnp.int32)[None, :]
    rev_idx = jnp.clip(cnt[:, None] - 1 - p_iota, 0, p_cap - 1)
    def rev(buf):
        return jnp.take_along_axis(buf, rev_idx, axis=1)
    pm, pn, pk, pl, ps = rev(pm), rev(pn), rev(pk), rev(pl), rev(ps)
    pvalid = p_iota < cnt[:, None]

    # ---------------- backward sweep ----------------
    def bwd_cond(st):
        return jnp.any(st["run"])

    def bwd_body(st):
        j = st["j"]
        t = st["t"]
        run = st["run"] & (j >= 0)
        aj = jnp.take_along_axis(enc, jnp.clip(j, 0, l_max - 1)[:, None], 1)[:, 0]
        do = run & (aj <= 3)
        nk, nl, ns = backward_ext(
            index, st["pk"], st["pl"], st["ps"], jnp.clip(aj, 0, 3)[:, None]
        )
        valid = st["pvalid"]
        plen = st["pn"] - st["pm"] + 1
        c1 = valid & (ns < min_intv[:, None].astype(dt)) & (plen >= min_seed_len)
        c2 = valid & (ns >= min_intv[:, None].astype(dt))
        first = c1 | c2
        p0 = jnp.min(jnp.where(first, p_iota, p_cap), axis=1)  # [B]
        has_p0 = p0 < p_cap
        is_p0 = p_iota == p0[:, None]
        emit = do & has_p0 & jnp.any(c1 & is_p0, axis=1)
        # emit prev[p0] (the un-extended smem) as a step-trace row
        def g(buf):
            return jnp.take_along_axis(buf, jnp.clip(p0, 0, p_cap - 1)[:, None], 1)[:, 0]
        temit = _row_write(st["temit"], t, emit)
        em = _row_write(st["em"], t, g(st["pm"]))
        en = _row_write(st["en"], t, g(st["pn"]))
        ek = _row_write(st["ek"], t, g(st["pk"]))
        el = _row_write(st["el"], t, g(st["pl"]))
        es = _row_write(st["es"], t, g(st["ps"]))
        # keep rule: c2 entries whose new s strictly exceeds the running
        # max of previously kept s (exclusive cummax over c2 entries)
        ns_c2 = jnp.where(c2, ns, jnp.asarray(NEG, ns.dtype))
        cm = jax.lax.cummax(ns_c2, axis=1)
        cm_excl = jnp.concatenate([jnp.full((b, 1), NEG, ns_c2.dtype), cm[:, :-1]], 1)
        kept = c2 & (ns > cm_excl)
        pk2 = jnp.where(do[:, None] & kept, nk, st["pk"])
        pl2 = jnp.where(do[:, None] & kept, nl, st["pl"])
        ps2 = jnp.where(do[:, None] & kept, ns, st["ps"])
        pm2 = jnp.where(do[:, None] & kept, j[:, None], st["pm"])
        pvalid2 = jnp.where(do[:, None], kept, st["pvalid"])
        any_valid = jnp.any(pvalid2, axis=1)
        run2 = run & (aj <= 3) & any_valid & (j - 1 >= 0)
        # lanes that stop here (a>3 or no valid) keep state for final append
        return dict(
            j=j - 1,
            t=t + 1,
            run=run2,
            pm=pm2,
            pn=st["pn"],
            pk=pk2,
            pl=pl2,
            ps=ps2,
            pvalid=pvalid2,
            temit=temit,
            em=em,
            en=en,
            ek=ek,
            el=el,
            es=es,
        )

    bst = dict(
        j=x0 - 1,
        t=jnp.int32(0),
        run=lane_ok & (x0 - 1 >= 0) & (cnt > 0),
        pm=pm,
        pn=pn,
        pk=pk,
        pl=pl,
        ps=ps,
        pvalid=pvalid,
        temit=jnp.zeros((max_l, b), bool),
        em=jnp.zeros((max_l, b), jnp.int32),
        en=jnp.zeros((max_l, b), jnp.int32),
        ek=jnp.zeros((max_l, b), dt),
        el=jnp.zeros((max_l, b), dt),
        es=jnp.zeros((max_l, b), dt),
    )
    bst = jax.lax.while_loop(bwd_cond, bwd_body, bst)
    brows, counts = _compact_trace(
        bst["temit"],
        dict(m=bst["em"], n=bst["en"], k=bst["ek"], l=bst["el"], s=bst["es"]),
        m_cap,
    )
    overflow = overflow | (counts > m_cap)
    counts = jnp.minimum(counts, m_cap)
    bufs = brows

    # final append: first valid slot, if long enough (:1167-1177)
    pvalid = bst["pvalid"]
    p0 = jnp.min(jnp.where(pvalid, p_iota, p_cap), axis=1)
    has = (p0 < p_cap) & lane_ok
    def g2(buf):
        return jnp.take_along_axis(buf, jnp.clip(p0, 0, p_cap - 1)[:, None], 1)[:, 0]
    fm, fn = g2(bst["pm"]), g2(bst["pn"])
    emit = has & ((fn - fm + 1) >= min_seed_len)
    bufs, counts = _emit(
        bufs, counts, emit, fm, fn, g2(bst["pk"]), g2(bst["pl"]),
        g2(bst["ps"]), m_cap
    )
    overflow = overflow | (emit & (counts > m_cap))
    counts = jnp.minimum(counts, m_cap)
    return bufs, counts, next_x, overflow


@functools.partial(
    jax.jit, static_argnames=("min_seed_len", "m_cap", "p_cap")
)
def smems_all_pos_batch(index, enc, readlen, min_intv, min_seed_len, m_cap=96, p_cap=48):
    """Batched getSMEMsAllPos: restart one-pos searches until reads exhaust."""
    b, l_max = enc.shape
    dt = index["cp_count"].dtype
    bufs = _new_match_bufs(b, m_cap, dt)

    def cond(st):
        return jnp.any(st["x"] < readlen)

    def body(st):
        sub_bufs, sub_counts, next_x, ovf = smems_one_pos_batch(
            index, enc, readlen, jnp.minimum(st["x"], readlen), min_intv,
            min_seed_len, m_cap=m_cap, p_cap=p_cap
        )
        act = st["x"] < readlen
        # merge sub matches into the global buffers: ONE masked scatter per
        # buffer (append at gcounts..gcounts+sub_counts; masked-out elements
        # route to a dummy column that is sliced away)
        def merge(gbufs, gcounts):
            p = jnp.arange(m_cap, dtype=jnp.int32)[None, :]
            take = act[:, None] & (p < sub_counts[:, None])
            # overflow pushes (dest >= m_cap) route to the dummy column so
            # duplicate destinations never target a live slot — the kept
            # prefix stays deterministic; overflow is flagged via gcounts
            raw = gcounts[:, None] + p
            dest = jnp.where(take & (raw < m_cap), raw, m_cap)
            lane2 = jnp.broadcast_to(
                jnp.arange(b, dtype=jnp.int32)[:, None], (b, m_cap)
            )

            def upd(gb, sb):
                pad = jnp.concatenate([gb, gb[:, :1]], axis=1)
                pad = pad.at[lane2, dest].set(sb)
                return pad[:, :m_cap]

            gb = {key: upd(gbufs[key], sub_bufs[key]) for key in gbufs}
            gc = gcounts + jnp.sum(take, axis=1, dtype=jnp.int32)
            return gb, gc

        gbufs, gcounts = merge(st["bufs"], st["counts"])
        ovf_all = st["ovf"] | (act & ovf) | (gcounts > m_cap)
        x = jnp.where(act, next_x, st["x"])
        # guard: next_x must advance (it always does: next_x >= x+1 or == j>x)
        x = jnp.maximum(x, st["x"] + act.astype(jnp.int32))
        return dict(x=x, bufs=gbufs, counts=jnp.minimum(gcounts, m_cap), ovf=ovf_all)

    st = dict(
        x=jnp.zeros(b, jnp.int32),
        bufs=bufs,
        counts=jnp.zeros(b, jnp.int32),
        ovf=jnp.zeros(b, bool),
    )
    st = jax.lax.while_loop(cond, body, st)
    return st["bufs"], st["counts"], st["ovf"]


@functools.partial(jax.jit, static_argnames=("min_seed_len", "m_cap"))
def bwt_seed_strategy_batch(index, enc, readlen, max_intv, min_seed_len, m_cap=64):
    """Batched bwtSeedStrategyAllPos (LAST strategy, forward-only)."""
    b, l_max = enc.shape
    dt = index["cp_count"].dtype
    bufs = _new_match_bufs(b, m_cap, dt)

    # flattened per-lane state machine: each iteration either roots a new
    # start position or performs one forward-extension step
    def cond(st):
        return jnp.any(st["x"] < readlen)

    def body(st):
        act = st["x"] < readlen
        rooted = st["rooted"]

        # --- rooting step (lanes not currently extending) ---
        want_root = act & ~rooted
        ax = jnp.take_along_axis(enc, jnp.clip(st["x"], 0, l_max - 1)[:, None], 1)[:, 0]
        root_ok = want_root & (ax < 4)
        k0, l0, s0 = _root_interval(index, jnp.clip(ax, 0, 3), dt)
        k = jnp.where(root_ok, k0, st["k"])
        l = jnp.where(root_ok, l0, st["l"])
        s = jnp.where(root_ok, s0, st["s"])
        m = jnp.where(root_ok, st["x"], st["m"])
        n = jnp.where(root_ok, st["x"], st["n"])
        j = jnp.where(root_ok, st["x"] + 1, st["j"])
        # N at the start position: consume it (next_x = x+1)
        x = jnp.where(want_root & (ax >= 4), st["x"] + 1, st["x"])
        rooted = rooted | root_ok

        # --- one extension step (lanes already rooted, incl. just-rooted) ---
        ext = act & rooted & ~want_root  # just-rooted lanes extend next iter
        scan_end = ext & (j >= readlen)  # inner loop exhausted: x := j
        run = ext & (j < readlen)
        aj = jnp.take_along_axis(enc, jnp.clip(j, 0, l_max - 1)[:, None], 1)[:, 0]
        good = run & (aj < 4)
        nk, nl, ns = forward_ext(index, k, l, s, jnp.clip(aj, 0, 3))
        k = jnp.where(good, nk, k)
        l = jnp.where(good, nl, l)
        s = jnp.where(good, ns, s)
        n = jnp.where(good, j, n)
        hit = good & (s < max_intv.astype(dt)) & ((n - m + 1) >= min_seed_len)
        emit = hit & (s > 0)
        bufs2, counts2 = _emit(st["bufs"], st["counts"], emit, m, n, k, l, s, m_cap)
        ovf = st["ovf"] | (emit & (st["counts"] >= m_cap))

        brk = (run & (aj >= 4)) | hit  # restart at j+1
        x = jnp.where(brk, j + 1, x)
        x = jnp.where(scan_end, j, x)
        rooted = rooted & ~brk & ~scan_end
        j = jnp.where(run & ~brk, j + 1, j)
        return dict(
            x=x, j=j, rooted=rooted, m=m, n=n, k=k, l=l, s=s,
            bufs=bufs2, counts=counts2, ovf=ovf,
        )

    st = dict(
        x=jnp.zeros(b, jnp.int32),
        j=jnp.zeros(b, jnp.int32),
        rooted=jnp.zeros(b, bool),
        m=jnp.zeros(b, jnp.int32),
        n=jnp.zeros(b, jnp.int32),
        k=jnp.zeros(b, dt),
        l=jnp.zeros(b, dt),
        s=jnp.zeros(b, dt),
        bufs=bufs,
        counts=jnp.zeros(b, jnp.int32),
        ovf=jnp.zeros(b, bool),
    )
    st = jax.lax.while_loop(cond, body, st)
    return st["bufs"], st["counts"], st["ovf"]
