"""Batched float64 PairHMM forward on the host (the GKL double fallback).

The reference recomputes testcases whose float result underflows
MIN_ACCEPTED in double (IntelPairHmmCSource.cpp:75-78).  The fallback
runs on the host — but the scalar oracle is a per-cell Python loop
(~seconds per 250x300 case).  phmm_forward_sweep is the same recurrence
as a vectorized numpy anti-diagonal sweep: each cell's value is a fixed
5-op tree (avx-pairhmm-template.h:186 association) independent of cell
evaluation ORDER, so the diagonal-major sweep is bit-identical to the
oracle's row-major loop (asserted in tests).  numpy never contracts a
multiply-add into an FMA, so in float32 the sweep is also the plain
reference the CUDA forward kernel (native/cuda/phmm_forward.cu) must
equal bit for bit.
"""

from __future__ import annotations

import numpy as np

from .oracle import phmm as oracle

AMBIG = 4


def _row_probs(batch, dtype):
    ctx = oracle.get_ctx(dtype)
    q = np.asarray(batch["q"]) & 127
    iq = np.asarray(batch["i"]) & 127
    dq = np.asarray(batch["d"]) & 127
    cq = np.asarray(batch["c"]) & 127
    ph2pr = ctx.ph2pr
    # set_mm_prob(i, d): quals are masked & 127 <= MAX_QUAL=254, so the
    # approx-log10-sum branch is unreachable and the m2m table gather is
    # bit-exact (the old per-element Python loop cost ~minutes once the
    # PHMM_SCALE fallback set reached 1e5 pairs x 256 rows)
    b, rp = q.shape
    min_q = np.minimum(iq, dq)
    max_q = np.maximum(iq, dq).astype(np.int64)
    p_mm = ctx.m2m[((max_q * (max_q + 1)) >> 1) + min_q]
    p_mm[:, 0] = 0.0
    p_gapm = 1.0 - ph2pr[cq]
    p_mx = ph2pr[iq]
    p_xx = ph2pr[cq]
    p_my = ph2pr[dq]
    p_yy = ph2pr[cq]
    distm = ph2pr[q]
    for arr in (p_gapm, p_mx, p_xx, p_my, p_yy, distm):
        arr[:, 0] = 0.0
    return p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, distm, ctx


def phmm_forward_sweep(batch, dtype=np.float64):
    """batch: prepare_batch() dict (numpy). Returns raw results [B] in
    dtype, bit-identical to oracle.compute_full_prob(..., dtype) per
    case."""
    rs_row = np.asarray(batch["rs_row"], np.int32)
    hap = np.asarray(batch["hap"], np.int32)
    rslen = np.asarray(batch["rslen"], np.int64)
    haplen = np.asarray(batch["haplen"], np.int64)
    b, rp = rs_row.shape
    hp = hap.shape[1]

    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, distm, ctx = _row_probs(batch, dtype)
    one_m_distm = 1.0 - distm
    distm3 = distm / 3.0
    with np.errstate(divide="ignore"):
        init_y = np.where(haplen > 0,
                          ctx.initial_constant / haplen.astype(dtype), 0.0)

    r_iota = np.arange(rp)[None, :]
    valid_row = (r_iota >= 1) & (r_iota <= rslen[:, None])

    m1 = np.zeros((b, rp), dtype)
    x1 = np.zeros((b, rp), dtype)
    y1 = np.zeros((b, rp), dtype)
    y1[:, 0] = init_y
    m2 = np.zeros_like(m1)
    x2 = np.zeros_like(m1)
    y2 = np.zeros_like(m1)
    res_m = np.zeros(b, dtype)
    res_x = np.zeros(b, dtype)
    lane = np.arange(b)
    rs_amb = rs_row == AMBIG

    def shift_down(v):
        out = np.zeros_like(v)
        out[:, 1:] = v[:, :-1]
        return out

    hap_pad = np.concatenate([hap, np.full((b, rp), AMBIG + 2, np.int32)], axis=1)
    for d in range(1, rp + hp):
        # hap char per row: hapd[r] = hap[d - r - 1]
        cols = d - r_iota - 1  # [1, rp] broadcast per lane
        cols_c = np.clip(cols, 0, hp + rp - 1)
        hapd = np.take_along_axis(hap_pad, cols_c, axis=1)
        hapd = np.where(cols >= 0, hapd, AMBIG + 2)

        m1s, x1s, y1s = shift_down(m1), shift_down(x1), shift_down(y1)
        m2s, x2s, y2s = shift_down(m2), shift_down(x2), shift_down(y2)

        match = (rs_row == hapd) | rs_amb | (hapd == AMBIG)
        prior = np.where(match, one_m_distm, distm3)

        c_idx = d - r_iota
        valid = valid_row & (c_idx >= 1) & (c_idx <= haplen[:, None])

        m_new = prior * ((m2s * p_mm + x2s * p_gapm) + y2s * p_gapm)
        x_new = m1s * p_mx + x1s * p_xx
        y_new = m1 * p_my + y1 * p_yy
        m_new = np.where(valid, m_new, 0.0)
        x_new = np.where(valid, x_new, 0.0)
        y_new = np.where(valid, y_new, 0.0)
        y_new[:, 0] = init_y

        # accumulate last-row M/X at column d - rslen (sequential in c — the
        # reference sums columns in order, and one diagonal contributes one
        # column per lane, so this IS column order)
        c_at = d - rslen
        take = (c_at >= 1) & (c_at <= haplen)
        sel = np.clip(rslen, 0, rp - 1)
        res_m = res_m + np.where(take, m_new[lane, sel], 0.0)
        res_x = res_x + np.where(take, x_new[lane, sel], 0.0)

        m2, x2, y2 = m1, x1, y1
        m1, x1, y1 = m_new, x_new, y_new

    return res_m + res_x


def phmm_forward_f64_native(batch):
    """Native C double pass (native/phmmf64.cpp), bit-exact with
    phmm_forward_sweep / the scalar oracle (tests assert equality).
    Returns raw f64[B] or None when the lib isn't built."""
    import ctypes

    from ..io.native import _load

    lib = _load()
    if not lib:
        return None
    if not getattr(lib, "_phmm64_ready", False):
        lib.gt_phmm_f64.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_void_p] * 2
            + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 2
            + [ctypes.c_double, ctypes.c_void_p])
        lib._phmm64_ready = True
    ctx = oracle.get_ctx(np.float64)
    rs = np.ascontiguousarray(batch["rs_row"], np.int8)
    q = np.ascontiguousarray(batch["q"], np.int32)
    iq = np.ascontiguousarray(batch["i"], np.int32)
    dq = np.ascontiguousarray(batch["d"], np.int32)
    cq = np.ascontiguousarray(batch["c"], np.int32)
    hap = np.ascontiguousarray(batch["hap"], np.int8)
    rslen = np.ascontiguousarray(batch["rslen"], np.int64)
    haplen = np.ascontiguousarray(batch["haplen"], np.int64)
    b, rp = rs.shape
    hp = hap.shape[1]
    ph2pr = np.ascontiguousarray(ctx.ph2pr, np.float64)
    m2m = np.ascontiguousarray(ctx.m2m, np.float64)
    out = np.empty(b, np.float64)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.gt_phmm_f64(p(rs), p(q), p(iq), p(dq), p(cq), p(hap), p(rslen),
                    p(haplen), b, rp, hp, p(ph2pr), p(m2m),
                    float(ctx.initial_constant), p(out))
    return out


def phmm_fallback_log10(batch, mask):
    """log10 likelihoods for the masked (underflowed) lanes, double path."""
    idx = np.nonzero(mask)[0]
    if idx.size == 0:
        return np.zeros(0), idx
    ctx = oracle.get_ctx(np.float64)
    sub = {k: np.asarray(v)[idx] for k, v in batch.items()}
    raw = phmm_forward_f64_native(sub)  # C pass: bit-exact, ~25x numpy
    if raw is None:
        # numpy diagonal sweep, CHUNKED: it makes ~20 [B, Rp] f64
        # temporaries per step, and at 1e5 fallback lanes each is ~50 MB
        # — numpy mmap/munmaps blocks that big every step (a page-fault
        # storm).
        # 2048-lane chunks keep temps ~2 MB; per-lane independence
        # makes chunking value-exact.
        chunk = 2048
        raw = np.empty(idx.size, np.float64)
        for lo in range(0, idx.size, chunk):
            sub_c = {k: v[lo:lo + chunk] for k, v in sub.items()}
            raw[lo:lo + min(chunk, idx.size - lo)] = phmm_forward_sweep(sub_c)
    return np.log10(raw) - ctx.log10_initial_constant, idx
