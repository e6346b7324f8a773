"""minimap2 anchor-chaining DP on the device (mm_chain_dp semantics, n_segs==1).

The reference scans predecessors j=i-1..st sequentially
per anchor with data-dependent breaks (host_kernel.cpp:405-472).  Here each
anchor step is ONE vectorized pass over a fixed predecessor window [W]:

  * window start st is a pure function of the (sorted) anchor x positions,
    precomputed exactly on the host; inside the window dr = x[i]-x[j] is
    guaranteed <= max_dist_x, so the whole DP is int32 (no u64 on device)
  * gap_cost = (int)(dd*.01*avg_qspan) + (ilog2(dd)>>1) is a host-built
    exact float64 lookup table over dd in [0, bw] — bit-identical to the
    reference's double arithmetic
  * the max_skip break: n_skip is a 0-clamped +/-1 walk over the descending
    visit order, so n_skip_t = S_t - min(0, min_{u<=t} S_u) (prefix-sum
    reflection); the break is the first skip event whose walk value exceeds
    max_skip.  Skip events need the "targets[j]==i" marks, which are a
    scatter of parents[j'] over eligible window anchors j'.  Marks at any
    position j above the break can only originate from j' > j (parents
    point strictly backward), and every such j' is genuinely visited, so a
    single scatter pass reproduces the sequential semantics exactly.
  * strict-improvement tie-breaking: max_j = largest j with sc == max.

Outputs per anchor: scores, parents, peak_scores (exact integer parity
with the oracle / reference).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_ITER = 5000
MAX_SKIP = 25
NEG = -(1 << 30)


def prepare_call(x, y, avg_qspan, max_dist_x=5000, max_dist_y=5000, bw=500, n_segs=1):
    """Host-side exact precomputation for one call.

    x, y: uint64 anchor arrays (x must be non-decreasing — minimap2's
    chaining precondition).  Returns dict of numpy arrays + metadata.
    """
    assert n_segs == 1, "n_segs>1 falls back to the oracle"
    x = np.asarray(x, dtype=np.uint64)
    y = np.asarray(y, dtype=np.uint64)
    n = len(x)
    assert np.all(x[1:] >= x[:-1]), "anchors must be sorted by x"

    # exact sequential st: advance while ri > x[st]+max_dist_x (monotone x
    # makes the stopping condition monotone, so searchsorted is exact)
    xp = x + np.uint64(max_dist_x)
    s = np.searchsorted(xp, x, side="left").astype(np.int64)
    st = np.minimum(np.maximum.accumulate(s), np.arange(n))
    st_eff = np.maximum(st, np.arange(n) - MAX_ITER).astype(np.int32)

    qi = x_lo_to_i32(y)  # (int32)y
    qspan = ((y >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    x_lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    # exact float64 gap-cost table over dd in [0, bw]
    dd = np.arange(bw + 1, dtype=np.float64)
    c_lin = (dd * 0.01 * np.float64(np.float32(avg_qspan))).astype(np.int64)
    log_dd = np.zeros(bw + 1, dtype=np.int64)
    v = np.arange(bw + 1)
    log_dd[1:] = np.floor(np.log2(v[1:])).astype(np.int64)
    gap = c_lin + (log_dd >> 1)
    # sc -= (int)((double)gap_cost * gap_scale + .499) with gap_scale=1.0
    gap_table = (gap.astype(np.float64) * 1.0 + 0.499).astype(np.int64).astype(np.int32)

    w_need = int(np.max(np.arange(n) - st_eff)) if n else 0
    return {
        "n": n,
        "x_lo": x_lo,
        "qi": qi,
        "qspan": qspan,
        "st_eff": st_eff,
        "gap_table": gap_table.astype(np.int32),
        "max_dist_x": max_dist_x,
        "max_dist_y": max_dist_y,
        "bw": bw,
        "w_need": w_need,
    }


def x_lo_to_i32(y):
    return (y & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)


def _chain_dp_core(x_lo, qi, qspan, st_eff, gap_table, n, w, n_pad,
                   max_dist_x, max_dist_y, bw, halo=None, offset=0):
    """Windowed chain DP.  All int32.  Arrays padded to n_pad.

    Returns (scores, parents, peaks) of length n_pad (valid through n).

    halo (optional): dict with x_lo/qi/scores/parents/peaks [w] arrays —
    the trailing window of the PRECEDING shard when the anchor axis is
    sharded (parallel.dp.chain_dp_halo_sharded); offset is this shard's
    global anchor offset (anchor indices in st_eff/parents are global).
    """
    # pad W leading dummies so the window slice at anchor i starts at i
    def pad_front(a, fill=0, lead=None):
        if lead is None:
            lead = jnp.full((w,), fill, a.dtype)
        return jnp.concatenate([lead.astype(a.dtype), a])

    halo = halo or {}
    x_lo_p = pad_front(x_lo.view(jnp.int32) if hasattr(x_lo, "view") else x_lo,
                       lead=halo.get("x_lo"))
    qi_p = pad_front(qi, lead=halo.get("qi"))
    j_rel = jnp.arange(w, dtype=jnp.int32)  # ascending within the window

    state = dict(
        scores=pad_front(jnp.zeros(n_pad, jnp.int32), lead=halo.get("scores")),
        parents=pad_front(jnp.full(n_pad, -1, jnp.int32), -1,
                          lead=halo.get("parents")),
        peaks=pad_front(jnp.zeros(n_pad, jnp.int32), lead=halo.get("peaks")),
    )

    def step(st, i):
        base = i  # window = padded indices [i, i+w) = absolute [i-w, i)
        x_lo_i = x_lo_p[i + w]
        qi_i = qi_p[i + w]
        qspan_i = qspan[i]
        st_i = st_eff[i]

        x_lo_win = jax.lax.dynamic_slice(x_lo_p, (base,), (w,))
        qi_win = jax.lax.dynamic_slice(qi_p, (base,), (w,))
        sc_win = jax.lax.dynamic_slice(st["scores"], (base,), (w,))
        par_win = jax.lax.dynamic_slice(st["parents"], (base,), (w,))

        j_abs = offset + i - w + j_rel  # GLOBAL anchor index per window slot
        in_win = (j_abs >= st_i) & (j_abs >= 0)

        # dr is exact in int32 inside the window (<= max_dist_x)
        dr = (
            x_lo_i.astype(jnp.uint32) - x_lo_win.astype(jnp.uint32)
        ).astype(jnp.int32)
        dq = qi_i - qi_win
        dd = jnp.abs(dr - dq)
        eligible = (
            in_win
            & (dr != 0)
            & (dq > 0)
            & (dq <= max_dist_y)
            & (dq <= max_dist_x)
            & (dd <= bw)
        )
        min_d = jnp.minimum(jnp.minimum(dq, dr), qspan_i)
        gap = gap_table[jnp.clip(dd, 0, bw)]
        sc = jnp.where(eligible, min_d - gap + sc_win, NEG)

        # running max over later-visited (higher-index) anchors, exclusive
        sc_rev = sc[::-1]  # descending visit order
        rm_rev_inc = jax.lax.cummax(sc_rev)
        rm_rev_exc = jnp.concatenate([jnp.array([NEG], jnp.int32), rm_rev_inc[:-1]])
        rm_rev = jnp.maximum(rm_rev_exc, qspan_i)
        improve_rev = (sc_rev > rm_rev) & eligible[::-1]

        # marks: scatter parents of eligible anchors into window positions
        mark_pos = par_win - (offset + i - w)  # window-relative parent pos
        do_mark = eligible & (par_win >= 0) & (mark_pos >= 0)
        marked = (
            jnp.zeros((w + 1,), jnp.int32)
            .at[jnp.where(do_mark, mark_pos, w)]
            .max(do_mark.astype(jnp.int32))[:w]
        )
        skip_rev = eligible[::-1] & ~improve_rev & (marked[::-1] > 0)

        # n_skip walk (descending): +1 on skip, -1 on improve, 0-clamped
        e = skip_rev.astype(jnp.int32) - improve_rev.astype(jnp.int32)
        s_walk = jnp.cumsum(e)
        c_walk = s_walk - jnp.minimum(jnp.int32(0), jax.lax.cummin(s_walk))
        brk = skip_rev & (c_walk > MAX_SKIP)
        t_idx = jnp.arange(w, dtype=jnp.int32)
        brk_t = jnp.min(jnp.where(brk, t_idx, w))
        processed_rev = t_idx < brk_t

        sc_proc = jnp.where(processed_rev, sc_rev, NEG)
        m = jnp.max(sc_proc)
        has = m > qspan_i
        # max_j = largest absolute j with sc == m (first strict improvement
        # in descending visit order) — in reversed coords the SMALLEST t
        t_best = jnp.min(jnp.where(sc_proc == m, t_idx, w))
        j_best = offset + i - 1 - t_best  # GLOBAL: t=0 -> j = i-1
        max_f = jnp.where(has, m, qspan_i)
        max_j = jnp.where(has, j_best, -1)

        peak_parent = st["peaks"][jnp.maximum(max_j - offset, -w) + w]
        peak = jnp.where((max_j >= 0) & (peak_parent > max_f), peak_parent, max_f)

        scores = jax.lax.dynamic_update_slice(st["scores"], max_f[None], (i + w,))
        parents = jax.lax.dynamic_update_slice(st["parents"], max_j[None], (i + w,))
        peaks = jax.lax.dynamic_update_slice(st["peaks"], peak[None], (i + w,))
        return dict(scores=scores, parents=parents, peaks=peaks), None

    state, _ = jax.lax.scan(step, state, jnp.arange(n_pad, dtype=jnp.int32))
    return state["scores"][w:], state["parents"][w:], state["peaks"][w:]


@functools.partial(jax.jit, static_argnames=("w", "n_pad", "max_dist_x", "max_dist_y", "bw"))
def chain_dp_device(x_lo, qi, qspan, st_eff, gap_table, n, w, n_pad, max_dist_x, max_dist_y, bw):
    return _chain_dp_core(x_lo, qi, qspan, st_eff, gap_table, n, w, n_pad,
                          max_dist_x, max_dist_y, bw)


@functools.partial(jax.jit, static_argnames=("w", "n_pad", "max_dist_x", "max_dist_y", "bw"))
def chain_dp_device_batch(x_lo, qi, qspan, st_eff, gap_table, n,
                          w, n_pad, max_dist_x, max_dist_y, bw):
    """vmapped chain DP over a batch of same-bucket calls: [B, n_pad] inputs,
    per-call gap tables [B, bw+1].  Batching turns each scan step into
    [B, w]-wide vector work, amortizing the per-step loop overhead that
    dominates single-call throughput (the reference's equivalent is the
    OpenMP loop over calls, host_kernel.cpp:484-487)."""

    def one(xl, q, qs, st, gt, nn):
        return _chain_dp_core(xl, q, qs, st, gt, nn, w, n_pad,
                              max_dist_x, max_dist_y, bw)

    return jax.vmap(one)(x_lo, qi, qspan, st_eff, gap_table, n)


def pad_anchor_bucket(n: int) -> int:
    """Power-of-two anchor buckets (reference calls reach ~87k anchors ->
    131072): a dataset then needs only a handful of (n_pad, w) compiles,
    and near-size calls share one batch."""
    return max(64, int(2 ** np.ceil(np.log2(max(n, 1)))))


def window_for(call) -> int:
    """Predecessor window: the call's widest st_eff span, rounded up to a
    power of two (>= 16, <= max_iter + 16)."""
    w = max(int(2 ** np.ceil(np.log2(max(call["w_need"], 1)))), 16)
    return min(w, MAX_ITER + 16)


def chain_calls_batched(calls, w: int | None = None, n_pad: int | None = None):
    """Run a list of prepared calls (same max_dist/bw) as one device batch.

    Pads every call to a common n_pad/w bucket; returns a list of
    (scores, parents, peaks) numpy tuples in input order."""
    calls = list(calls)
    nonempty = [c for c in calls if c["n"] > 0]
    if not nonempty:
        z = np.zeros(0, np.int32)
        return [(z, z.astype(np.int64), z) for _ in calls]
    if w is None:
        w = max(window_for(c) for c in nonempty)
    if n_pad is None:
        n_pad = pad_anchor_bucket(max(c["n"] for c in nonempty))

    def p(a, fill=0):
        return np.pad(a, (0, n_pad - len(a)), constant_values=fill)

    stack = {
        "x_lo": np.stack([p(c["x_lo"].view(np.int32)) for c in nonempty]),
        "qi": np.stack([p(c["qi"]) for c in nonempty]),
        "qspan": np.stack([p(c["qspan"]) for c in nonempty]),
        "st_eff": np.stack([p(c["st_eff"]) for c in nonempty]),
        "gap_table": np.stack([c["gap_table"] for c in nonempty]),
        "n": np.array([c["n"] for c in nonempty], np.int32),
    }
    c0 = nonempty[0]
    sc, par, pk = chain_dp_device_batch(
        *(jnp.asarray(stack[k]) for k in
          ("x_lo", "qi", "qspan", "st_eff", "gap_table", "n")),
        w, n_pad, c0["max_dist_x"], c0["max_dist_y"], c0["bw"],
    )
    # one fetch for all three outputs
    scores, parents, peaks = np.asarray(jnp.stack([sc, par, pk]))
    out = []
    bi = 0
    for c in calls:
        if c["n"] == 0:
            z = np.zeros(0, np.int32)
            out.append((z, z.astype(np.int64), z))
        else:
            nn = c["n"]
            out.append((scores[bi, :nn], parents[bi, :nn].astype(np.int64),
                        peaks[bi, :nn]))
            bi += 1
    return out


def chain_call(call_dict, w: int | None = None, n_pad: int | None = None):
    """Run one prepared call on device; returns numpy (scores, parents,
    peaks)."""
    n = call_dict["n"]
    if n == 0:
        z = np.zeros(0, np.int32)
        return z, z.astype(np.int64), z
    if w is None:
        w = window_for(call_dict)
    if n_pad is None:
        n_pad = n
    x_lo = call_dict["x_lo"].view(np.int32)
    pad = n_pad - n
    def p(a, fill=0):
        return np.pad(a, (0, pad), constant_values=fill)

    scores, parents, peaks = chain_dp_device(
        jnp.asarray(p(x_lo)),
        jnp.asarray(p(call_dict["qi"])),
        jnp.asarray(p(call_dict["qspan"])),
        jnp.asarray(p(call_dict["st_eff"])),
        jnp.asarray(call_dict["gap_table"]),
        n,
        w,
        n_pad,
        call_dict["max_dist_x"],
        call_dict["max_dist_y"],
        call_dict["bw"],
    )
    return (
        np.asarray(scores)[:n],
        np.asarray(parents)[:n].astype(np.int64),
        np.asarray(peaks)[:n],
    )
