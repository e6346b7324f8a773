"""Adaptive banded event alignment on the device (f5c eventalign capability).

The band-fill loop (align.c:289-399 / the CUDA kernels
at f5c.cu:450-497) becomes a lax.scan over bands; each step is vector
work on [bandwidth]-wide rows — the adaptive move decision, three
shifted reads of the previous two bands (static-width dynamic slices of
padded rows), pore-model gathers, the log-normal emission, and the
3-state max with the reference's exact tie-break (U on equality beats D,
L beats both).  vmap batches reads.  Traceback + QC run on the host from
the returned trace planes (device backtrack is a later optimization).

Bit-behavior matches ops/oracle/abea.py (f32 bands, f64 transition
constants folded to f32 at store time exactly like the C).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .oracle import abea as oracle

ALN_BANDWIDTH = oracle.ALN_BANDWIDTH
FROM_D, FROM_U, FROM_L = 0, 1, 2
NEG = np.float32(-np.inf)


def lp_consts_f64(n_events: int, n_kmers: int):
    """Transition penalties in DOUBLE, like align.c:199-205."""
    events_per_kmer = n_events / n_kmers
    p_stay = 1 - (1 / (events_per_kmer + 1))
    lp_skip = np.log(1e-10)
    lp_stay = np.log(p_stay)
    lp_step = np.log(1.0 - np.exp(lp_skip) - np.exp(lp_stay))
    lp_trim = np.log(0.01)
    return lp_skip, lp_stay, lp_step, lp_trim


def _hi_lo(c: float):
    hi = np.float32(c)
    return hi, np.float32(np.float64(c) - np.float64(hi))


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _add_c_add(x, c_hi, c_lo, y):
    """fl32(f64(x) + c + f64(y)) via compensated f32 sums.

    The C adds a double constant to the f32 band value and rounds once on
    the float store (align.c:371-372); error-free transforms reproduce
    that rounding (double-rounding corner cases are below observation on
    the golden fixtures and fuzz sweeps)."""
    s1, e1 = _two_sum(x, c_hi)
    s2, e2 = _two_sum(s1, y)
    comp = s2 + ((e1 + c_lo) + e2)
    return jnp.where(jnp.isneginf(x), x, comp)


def _add_c(x, c_hi, c_lo):
    """fl32(f64(x) + c) (align.c:373)."""
    s1, e1 = _two_sum(x, c_hi)
    comp = s1 + (e1 + c_lo)
    return jnp.where(jnp.isneginf(x), x, comp)


@functools.partial(jax.jit, static_argnames=("bandwidth", "n_bands_pad"))
def abea_fill_bands(
    event_means_rev_pad,  # [E_pad + 2*bw] f32, ev_rev[j]=mean[n_events-1-j]
    kmer_ranks_pad,  # [K_pad + 2*bw] i32
    n_events,
    n_kmers,
    level_mean,  # [4096] f32 pore model
    level_stdv,
    level_log_stdv,
    scale,
    shift,
    lp_consts,  # [8] f32 hi/lo pairs: skip, stay, step, trim (f64 split)
    trim_vals,  # [n_bands_pad] f32: fl32(lp_trim_f64 * bi) per band index
    n_bands_pad: int = 0,
    bandwidth: int = ALN_BANDWIDTH,
):
    # hoist the pore-model lookup out of the band loop: ONE [K_pad] gather
    # instead of three [bw] gathers per band
    ranks_all = kmer_ranks_pad
    gm_pad = scale * level_mean[ranks_all] + shift
    stdv_pad = level_stdv[ranks_all]
    lstdv_pad = level_log_stdv[ranks_all]
    bw = bandwidth
    half = bw // 2
    (skip_hi, skip_lo, stay_hi, stay_lo, step_hi, step_lo, trim_hi,
     _trim_lo) = (lp_consts[i] for i in range(8))

    o_iota = jnp.arange(bw, dtype=jnp.int32)

    # bands 0 and 1 (init)
    band0 = jnp.full(bw, NEG).at[half].set(0.0)
    band1 = jnp.full(bw, NEG).at[half].set(trim_hi)
    bll_e0, bll_k0 = jnp.int32(half - 1), jnp.int32(-1 - half)
    bll_e1, bll_k1 = bll_e0 + 1, bll_k0

    n_bands = n_bands_pad
    e_off = event_means_rev_pad.shape[0] - 2 * bw  # = E_pad

    def step(carry, xs):
        bi, trim_here = xs
        b1, b2, e1, k1, e2, k2 = carry
        ll = b1[0]
        ur = b1[bw - 1]
        both_ob = jnp.isneginf(ll) & jnp.isneginf(ur)
        right = jnp.where(both_ob, (bi % 2) == 1, ll < ur).astype(jnp.int32)
        be = e1 + (1 - right)
        bk = k1 + right

        pad1 = jnp.concatenate([jnp.full(1, NEG), b1, jnp.full(1, NEG)])
        pad2 = jnp.concatenate([jnp.full(2, NEG), b2, jnp.full(2, NEG)])
        up = jax.lax.dynamic_slice(pad1, (right + 1,), (bw,))
        # off_left = off - 1 + right (align.c:345 via bll shift), so the
        # slice starts at `right` — NOT `1 - right` (a long-lived inversion
        # that only surfaced on reference-golden cases where the skip path
        # wins a cell; lp_skip=-23 makes that rare)
        left = jax.lax.dynamic_slice(pad1, (right,), (bw,))
        dk2 = bk - k2
        diag = jax.lax.dynamic_slice(pad2, (1 + dk2,), (bw,))

        gm = jax.lax.dynamic_slice(gm_pad, (bk + bw,), (bw,))
        stdv = jax.lax.dynamic_slice(stdv_pad, (bk + bw,), (bw,))
        lstdv = jax.lax.dynamic_slice(lstdv_pad, (bk + bw,), (bw,))
        levels = jax.lax.dynamic_slice(
            event_means_rev_pad, (jnp.int32(n_events) - 1 - be + bw,), (bw,)
        )
        a = (levels - gm) / stdv
        lp_emit = jnp.float32(-0.918938) - lstdv - 0.5 * a * a

        score_d = _add_c_add(diag, step_hi, step_lo, lp_emit)
        score_u = _add_c_add(up, stay_hi, stay_lo, lp_emit)
        score_l = _add_c(left, skip_hi, skip_lo)
        ms = score_d
        frm = jnp.zeros(bw, jnp.uint8)
        ms = jnp.maximum(ms, score_u)
        frm = jnp.where(ms == score_u, jnp.uint8(FROM_U), frm)
        ms = jnp.maximum(ms, score_l)
        frm = jnp.where(ms == score_l, jnp.uint8(FROM_L), frm)

        ei = be - o_iota
        ki = bk + o_iota
        valid = (ki >= 0) & (ki < n_kmers) & (ei >= 0) & (ei < n_events)
        new_band = jnp.where(valid, ms, NEG)
        new_trace = jnp.where(valid, frm, 0)

        # trim state at kmer -1
        to = -1 - bk
        t_ei = be - to
        t_ok = (to >= 0) & (to < bw)
        t_in = t_ok & (t_ei >= 0) & (t_ei < n_events)
        # t_ei = bi - 1 for every band, so fl32(lp_trim_f64 * (t_ei+1))
        # is host-precomputed per band index (trim_vals)
        t_val = jnp.where(t_in, trim_here, NEG)
        at = jnp.clip(to, 0, bw - 1)
        new_band = jnp.where(
            t_ok, new_band.at[at].set(t_val), new_band
        )
        new_trace = jnp.where(
            t_ok, new_trace.at[at].set(jnp.where(t_in, jnp.uint8(FROM_U), jnp.uint8(0))), new_trace
        )

        # value at the final kmer column (for the backtrack seed)
        lo = (jnp.int32(n_kmers) - 1) - bk
        l_ok = (lo >= 0) & (lo < bw)
        last_val = jnp.where(l_ok, new_band[jnp.clip(lo, 0, bw - 1)], NEG)

        ys = (new_trace, be, bk, last_val)
        return (new_band, b1, be, bk, e1, k1), ys

    carry0 = (band1, band0, bll_e1, bll_k1, bll_e0, bll_k0)
    _, (traces, bes, bks, last_vals) = jax.lax.scan(
        step, carry0,
        (jnp.arange(2, n_bands, dtype=jnp.int32), trim_vals[2:n_bands]),
    )
    del e_off
    return traces, bes, bks, last_vals


def _bucket(n, q=256):
    # bucket padded shapes to multiples of 256 so mixed-length read sets
    # reuse one compiled program (shape-exact padding recompiles per read
    # length)
    return -(-n // q) * q


_RANK_TABLE = np.zeros(256, np.int32)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _RANK_TABLE[ord(_ch)] = _v


def _kmer_ranks(sequence: str, k: int, n_kmers: int) -> np.ndarray:
    """Vectorized oracle.get_kmer_rank over all windows (the per-kmer
    Python call was ~40% of abea host prep; non-ACGT chars rank as A)."""
    codes = _RANK_TABLE[np.frombuffer(sequence.encode(), np.uint8)]
    ranks = np.zeros(n_kmers, np.int32)
    for j in range(k):
        ranks |= codes[j : j + n_kmers] << (2 * (k - 1 - j))
    return ranks


def _prep_read(sequence, event_means, bw, k, e_buck, k_buck):
    """Host-side padded inputs for one read at a given bucket."""
    n_events = len(event_means)
    n_kmers = len(sequence) - k + 1
    lp_skip, lp_stay, lp_step, lp_trim = lp_consts_f64(n_events, n_kmers)
    lp_consts = np.array(
        [*_hi_lo(lp_skip), *_hi_lo(lp_stay), *_hi_lo(lp_step),
         *_hi_lo(lp_trim)], dtype=np.float32)
    # the trim cell of band bi always sits at event index bi-1, so the C's
    # fl32(lp_trim_f64 * (event_idx+1)) store is exactly fl32(lp_trim * bi)
    n_bands_pad = e_buck + k_buck + 2
    trim_vals = (np.float64(lp_trim)
                 * np.arange(n_bands_pad, dtype=np.float64)
                 ).astype(np.float32)

    kmer_ranks = _kmer_ranks(sequence, k, n_kmers)
    ranks_pad = np.zeros(k_buck + 2 * bw, np.int32)
    ranks_pad[bw : bw + n_kmers] = kmer_ranks
    ev_rev = event_means[::-1].astype(np.float32)
    ev_pad = np.zeros(e_buck + 2 * bw, np.float32)
    ev_pad[bw : bw + n_events] = ev_rev
    return ev_pad, ranks_pad, lp_consts, trim_vals, kmer_ranks


def _traceback(sequence, event_means, model, scale, shift, traces, bes, bks,
               last_vals, kmer_ranks, bw, k):
    """Host backtrack + QC from the filled bands (postalign semantics)."""
    n_events = len(event_means)
    n_kmers = len(sequence) - k + 1
    half = bw // 2
    n_bands = n_events + 1 + n_kmers + 1
    lp_trim = np.log(0.01)

    # reassemble full per-band arrays (bands 0,1 are the fixed seeds)
    trace_full = np.zeros((n_bands, bw), np.uint8)
    trace_full[1, half] = FROM_U
    trace_full[2:] = traces
    bll_e = np.zeros(n_bands, np.int64)
    bll_k = np.zeros(n_bands, np.int64)
    bll_e[0], bll_k[0] = half - 1, -1 - half
    bll_e[1], bll_k[1] = half, -1 - half
    bll_e[2:] = bes
    bll_k[2:] = bks

    # backtrack seed: best event against the last kmer + remaining trim.
    # C: float s = BAND + (n_events-ei) * lp_trim with DOUBLE lp_trim,
    # rounded to float before the compare (align.c:427-432)
    max_score = np.float32(-np.inf)
    curr_event_idx = 0
    curr_kmer_idx = n_kmers - 1
    for ei in range(n_events):
        bi = ei + n_kmers + 1
        if bi >= n_bands:
            break
        if bi >= 2:
            s = np.float32(np.float64(last_vals[bi - 2])
                           + (n_events - ei) * lp_trim)
        else:
            continue
        if s > max_score:
            max_score = s
            curr_event_idx = ei

    lm, ls, lls = model["level_mean"], model["level_stdv"], model["level_log_stdv"]
    out = []
    sum_emission = 0.0
    n_aligned = 0
    curr_gap = max_gap = 0
    while curr_kmer_idx >= 0 and curr_event_idx >= 0:
        out.append((curr_kmer_idx, curr_event_idx))
        rank = kmer_ranks[curr_kmer_idx]
        sum_emission += float(
            oracle.log_prob_match(lm[rank], ls[rank], lls[rank],
                                  event_means[curr_event_idx], scale, shift)
        )
        n_aligned += 1
        bi = (curr_event_idx + 1) + (curr_kmer_idx + 1)
        off = int(bll_e[bi]) - curr_event_idx
        frm = trace_full[bi, off]
        if frm == FROM_D:
            curr_kmer_idx -= 1
            curr_event_idx -= 1
            curr_gap = 0
        elif frm == FROM_U:
            curr_event_idx -= 1
            curr_gap = 0
        else:
            curr_kmer_idx -= 1
            curr_gap += 1
            max_gap = max(max_gap, curr_gap)
    out.reverse()

    avg = sum_emission / max(n_aligned, 1)
    spanned = bool(out) and out[0][0] == 0 and out[-1][0] == n_kmers - 1
    if avg < -5.0 or not spanned or max_gap > 50:
        return []
    return out


def _traceback_batch(sequences_g, events_g, model, scales_g, shifts_g,
                     traces_g, bes_g, last_vals_g, kranks_g, bw, k,
                     use_native: bool | None = None):
    """Vectorized-across-reads host traceback (same results as per-read
    _traceback, bit-exactly: identical f32 emission op order and f64
    accumulation order — each read's walk steps happen in the same order,
    just in lockstep with the other reads under an `active` mask).

    When the native lib is built the walk runs in C++ (native/abea_tb.cpp,
    same bit-exact contract; ~80x on the Python lockstep walk)."""
    g_n = len(sequences_g)
    ne = np.array([len(e) for e in events_g], np.int64)
    nk = np.array([len(s) - k + 1 for s in sequences_g], np.int64)
    nb = ne + nk + 2
    nb_max = int(nb.max())
    half = bw // 2
    lp_trim = np.log(0.01)

    trace_full = np.zeros((g_n, nb_max, bw), np.uint8)
    bll_e = np.zeros((g_n, nb_max), np.int64)
    ranks = np.zeros((g_n, int(nk.max())), np.int64)
    evm = np.zeros((g_n, int(ne.max())), np.float32)
    lv_mat = np.full((g_n, nb_max - 2), -np.inf)
    for g in range(g_n):
        trace_full[g, 1, half] = FROM_U
        trace_full[g, 2 : nb[g]] = traces_g[g]
        bll_e[g, 0], bll_e[g, 1] = half - 1, half
        bll_e[g, 2 : nb[g]] = bes_g[g]
        ranks[g, : nk[g]] = kranks_g[g]
        evm[g, : ne[g]] = events_g[g]
        lv_mat[g, : nb[g] - 2] = np.asarray(last_vals_g[g], np.float64)

    if use_native is None or use_native:
        from ..io.native import abea_traceback_native

        native = abea_traceback_native(
            trace_full, bll_e, lv_mat, ranks.astype(np.int32), evm, model,
            np.array(scales_g, np.float32), np.array(shifts_g, np.float32),
            ne, nk, bw, lp_trim)
        if native is not None:
            return native
        if use_native:
            raise RuntimeError("native lib not built (make -C native)")

    ce = np.zeros(g_n, np.int64)  # backtrack seed event per read
    for g in range(g_n):
        # seed: first index attaining the max of last_val + remaining
        # trim, compared after the C's f32 round (align.c:427-432)
        s = np.float32(lv_mat[g, nk[g] - 1 : nk[g] - 1 + ne[g]]
                       + (ne[g] - np.arange(ne[g])) * lp_trim)
        ce[g] = int(np.argmax(s))

    lm32 = model["level_mean"].astype(np.float32)
    ls32 = model["level_stdv"].astype(np.float32)
    lls32 = model["level_log_stdv"].astype(np.float32)
    sc32 = np.array(scales_g, np.float32)
    sh32 = np.array(shifts_g, np.float32)

    ck = nk - 1
    active = (ck >= 0) & (ce >= 0)
    sum_em = np.zeros(g_n, np.float64)
    n_aligned = np.zeros(g_n, np.int64)
    curr_gap = np.zeros(g_n, np.int64)
    max_gap = np.zeros(g_n, np.int64)
    gidx = np.arange(g_n)
    hist_k, hist_e = [], []
    while active.any():
        hist_k.append(np.where(active, ck, -1))
        hist_e.append(ce.copy())
        r = ranks[gidx, np.maximum(ck, 0)]
        gp_mean = sc32 * lm32[r] + sh32
        a = (evm[gidx, np.maximum(ce, 0)] - gp_mean) / ls32[r]
        lp = np.float32(-0.918938) - lls32[r] + np.float32(-0.5) * a * a
        sum_em = np.where(active, sum_em + lp.astype(np.float64), sum_em)
        n_aligned += active

        bi = np.minimum(ce + ck + 2, nb_max - 1)
        off = np.clip(bll_e[gidx, bi] - ce, 0, bw - 1)
        frm = trace_full[gidx, bi, off]
        is_l = frm == FROM_L
        ck = np.where(active & (frm != FROM_U), ck - 1, ck)
        ce = np.where(active & ~is_l, ce - 1, ce)
        curr_gap = np.where(active, np.where(is_l, curr_gap + 1, 0), curr_gap)
        max_gap = np.maximum(max_gap, curr_gap)
        active = active & (ck >= 0) & (ce >= 0)

    hk = np.array(hist_k)  # [T, G]
    he = np.array(hist_e)
    results = []
    for g in range(g_n):
        sel = hk[:, g] >= 0
        pairs = list(zip(hk[sel, g][::-1].tolist(), he[sel, g][::-1].tolist()))
        avg = sum_em[g] / max(int(n_aligned[g]), 1)
        spanned = bool(pairs) and pairs[0][0] == 0 and pairs[-1][0] == nk[g] - 1
        if avg < -5.0 or not spanned or max_gap[g] > 50:
            results.append([])
        else:
            results.append(pairs)
    return results


def align_events(sequence: str, event_means: np.ndarray, model: dict,
                 scale: float, shift: float, bandwidth: int = ALN_BANDWIDTH,
                 k: int = oracle.KMER_SIZE):
    """Device band fill + host traceback/QC. Same contract as oracle.align."""
    return align_events_batch(
        [sequence], [event_means], model, [scale], [shift],
        bandwidth=bandwidth, k=k,
    )[0]


def align_events_batch_native(sequences, event_means_list, model, scales,
                              shifts, bandwidth: int = ALN_BANDWIDTH,
                              k: int = oracle.KMER_SIZE):
    """Host dual-engine fill (native/abeafill.cpp): the whole banded
    align + traceback + QC per read in C++, bit-identical to the oracle
    (tests assert it, incl. QC drops).  Returns None when the native
    lib isn't built.

    The band recurrence is sequential over ~n_events + n_kmers bands
    per read — latency-bound on a device, but vector-width-parallel
    WITHIN a band on the host, so this is the production default (the
    fmi/kmer/poa dual-engine precedent)."""
    import ctypes

    from ..io.native import _load

    lib = _load()
    if not lib:
        return None
    if not getattr(lib, "_abea_ready", False):
        lib.gt_abea_align.restype = ctypes.c_int64
        lib.gt_abea_align.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64] + [ctypes.c_void_p] * 3
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int32]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int64])
        lib._abea_ready = True
    lm = np.ascontiguousarray(model["level_mean"], np.float32)
    ls = np.ascontiguousarray(model["level_stdv"], np.float32)
    lls = np.ascontiguousarray(model["level_log_stdv"], np.float32)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    out = []
    for seq, ev, sc, sh in zip(sequences, event_means_list, scales, shifts):
        n_events = len(ev)
        n_kmers = len(seq) - k + 1
        if n_kmers < 1 or n_events < 1:
            out.append([])
            continue
        ranks = _kmer_ranks(seq, k, n_kmers).astype(np.int32)
        evf = np.ascontiguousarray(ev, np.float32)
        cap = n_events + n_kmers + 16
        ki = np.empty(cap, np.int32)
        ei = np.empty(cap, np.int32)
        n = lib.gt_abea_align(p(ranks), n_kmers, p(evf), n_events,
                              p(lm), p(ls), p(lls), float(sc), float(sh),
                              bandwidth, p(ki), p(ei), cap)
        assert n >= 0, "alignment exceeded cap bound"
        out.append(list(zip(ki[:n].tolist(), ei[:n].tolist())))
    return out


def align_events_batch(sequences, event_means_list, model, scales, shifts,
                       bandwidth: int = ALN_BANDWIDTH, k: int = oracle.KMER_SIZE,
                       use_native: bool = True):
    """Batched eventalign: reads grouped by padded-shape bucket, each group
    filled in ONE vmapped device dispatch; tracebacks run on the host.

    Returns a list of alignments ([(kmer_idx, event_idx)] or []) in input
    order.  Engine order: native host fill (production default — see
    align_events_batch_native; use_native=False skips it), else the
    device jnp scan.
    """
    if use_native:
        res = align_events_batch_native(
            sequences, event_means_list, model, scales, shifts,
            bandwidth=bandwidth, k=k)
        if res is not None:
            return res
    bw = bandwidth
    results = [None] * len(sequences)
    groups = {}
    for i, (seq, ev) in enumerate(zip(sequences, event_means_list)):
        n_events, n_kmers = len(ev), len(seq) - k + 1
        if n_kmers < 1 or n_events < 1:
            results[i] = []
            continue
        key = (_bucket(n_events), _bucket(n_kmers))
        groups.setdefault(key, []).append(i)

    for (e_buck, k_buck), idxs in groups.items():
        evs, rks, lps, kranks = [], [], [], []
        n_events_v, n_kmers_v = [], []
        trims = []
        for i in idxs:
            ev_pad, ranks_pad, lp_consts, trim_vals, kmer_ranks = _prep_read(
                sequences[i], event_means_list[i], bw, k, e_buck, k_buck)
            evs.append(ev_pad)
            rks.append(ranks_pad)
            lps.append(lp_consts)
            trims.append(trim_vals)
            kranks.append(kmer_ranks)
            n_events_v.append(len(event_means_list[i]))
            n_kmers_v.append(len(sequences[i]) - k + 1)

        fill = functools.partial(
            abea_fill_bands,
            n_bands_pad=e_buck + k_buck + 2, bandwidth=bw)
        lm = jnp.asarray(model["level_mean"].astype(np.float32))
        ls = jnp.asarray(model["level_stdv"].astype(np.float32))
        lls = jnp.asarray(model["level_log_stdv"].astype(np.float32))
        traces_b, bes_b, bks_b, lv_b = jax.vmap(
            lambda e, r, ne, nk, sc, sh, lp, tv: fill(
                e, r, ne, nk, lm, ls, lls, sc, sh, lp, tv)
        )(
            jnp.asarray(np.stack(evs)),
            jnp.asarray(np.stack(rks)),
            jnp.asarray(np.array(n_events_v, np.int32)),
            jnp.asarray(np.array(n_kmers_v, np.int32)),
            jnp.asarray(np.array(scales, np.float32)[np.array(idxs)]),
            jnp.asarray(np.array(shifts, np.float32)[np.array(idxs)]),
            jnp.asarray(np.stack(lps)),
            jnp.asarray(np.stack(trims)),
        )
        traces_b = np.asarray(traces_b)
        bes_b = np.asarray(bes_b)
        lv_b = np.asarray(lv_b)
        nbs = [n_events_v[r] + n_kmers_v[r] + 2 for r in range(len(idxs))]
        group_res = _traceback_batch(
            [sequences[i] for i in idxs],
            [event_means_list[i] for i in idxs], model,
            [float(np.float32(scales[i])) for i in idxs],
            [float(np.float32(shifts[i])) for i in idxs],
            [traces_b[r][: nbs[r] - 2] for r in range(len(idxs))],
            [bes_b[r][: nbs[r] - 2] for r in range(len(idxs))],
            [lv_b[r][: nbs[r] - 2] for r in range(len(idxs))],
            kranks, bw, k)
        for row, i in enumerate(idxs):
            results[i] = group_res[row]
    return results
