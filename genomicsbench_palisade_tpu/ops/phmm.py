"""PairHMM forward likelihoods — batched anti-diagonal recurrence.

The reference (GKL AVX, see
tools/GKL/src/main/native/pairhmm/avx-pairhmm-template.h) vectorizes
anti-diagonals *within* one testcase on 8-wide AVX registers.  Here the
whole [B] batch of testcases advances one anti-diagonal per step of a
single `lax.scan` over [B, R+1] f32 vectors, with the wavefront state
(three diagonals of M/X/Y) in the scan carry.  This scan is the plain
reference and the CPU engine; on a GPU phmm_forward_auto routes to the
CUDA kernel (ops/phmm_cuda.py), whose raw sums equal the float32
reference sweep (ops/phmm_f64.py) bit for bit; XLA may contract the scan's
multiply-adds into FMAs, so the scan agrees with both only within the
1e-5 log10 contract.  This module also owns table and batch preparation.

Semantics match the oracle (ops/oracle/phmm.py) which is validated against
the reference GKL kernel within its own 1e-5 contract:
  * per-row transition probs from quality strings via ph2pr/matchToMatch
    tables (Context.h:106-175)
  * M/X/Y recurrence and float association (avx-pairhmm-template.h:181-197)
  * result = sum over last-row M + X, float32 first;
    testcases with raw result < MIN_ACCEPTED=1e-28 are flagged for the
    float64 fallback (IntelPairHmmCSource.cpp:61-85) which the driver
    runs via the vectorized float64 oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .oracle import phmm as oracle

MIN_ACCEPTED = 1e-28
AMBIG = 4


@functools.cache
def _tables_f32():
    """(ph2pr[128], m2m[flat], log10_initial_constant) as numpy f32."""
    ctx = oracle.get_ctx(np.float32)
    return ctx.ph2pr, ctx.m2m, float(ctx.log10_initial_constant), float(
        ctx.initial_constant
    )


def prepare_batch(reads, haps, pairs, r_pad: int | None = None,
                  h_pad: int | None = None):
    """Host-side packing of testcases into fixed-shape device arrays.

    reads: list of dicts with keys bases (int codes), q, i, d, c (normalized
           int quals)
    haps:  list of int-code arrays
    pairs: list of (read_idx, hap_idx) — the read x hap cross product
    Returns a dict of numpy arrays ready for phmm_forward.
    """
    if r_pad is None:
        r_pad = max(len(r["bases"]) for r in reads) + 1
    if h_pad is None:
        h_pad = max(len(h) for h in haps)
    b = len(pairs)
    rp = r_pad  # rows 0..r_pad-1; row r maps to read base r-1
    rs_row = np.zeros((b, rp), dtype=np.int8)
    q = np.zeros((b, rp), dtype=np.int32)
    iq = np.zeros((b, rp), dtype=np.int32)
    dq = np.zeros((b, rp), dtype=np.int32)
    cq = np.zeros((b, rp), dtype=np.int32)
    hap = np.full((b, h_pad), AMBIG + 1, dtype=np.int8)  # never matches codes
    rslen = np.zeros(b, dtype=np.int32)
    haplen = np.zeros(b, dtype=np.int32)
    for bi, (ri, hi) in enumerate(pairs):
        r = reads[ri]
        h = haps[hi]
        n = len(r["bases"])
        m = len(h)
        assert n < rp and m <= h_pad, (n, rp, m, h_pad)
        rs_row[bi, 1 : n + 1] = r["bases"]
        q[bi, 1 : n + 1] = r["q"]
        iq[bi, 1 : n + 1] = r["i"]
        dq[bi, 1 : n + 1] = r["d"]
        cq[bi, 1 : n + 1] = r["c"]
        hap[bi, :m] = h
        rslen[bi] = n
        haplen[bi] = m
    batch = {
        "rs_row": rs_row,
        "q": q,
        "i": iq,
        "d": dq,
        "c": cq,
        "hap": hap,
        "rslen": rslen,
        "haplen": haplen,
    }
    return batch


def _row_probs(batch, ph2pr, m2m):
    """Per-row transition probabilities [B, Rp] (initializeVectors).

    Widens to int32 first: compact_batch ships quals as int8 and the
    m2m index max_q*(max_q+1)/2 overflows int8."""
    iq = (batch["i"] & 127).astype(jnp.int32)
    dq = (batch["d"] & 127).astype(jnp.int32)
    cq = (batch["c"] & 127).astype(jnp.int32)
    qq = (batch["q"] & 127).astype(jnp.int32)
    min_q = jnp.minimum(iq, dq)
    max_q = jnp.maximum(iq, dq)
    p_mm = m2m[((max_q * (max_q + 1)) >> 1) + min_q]
    p_c = ph2pr[cq]
    p_gapm = 1.0 - p_c
    p_mx = ph2pr[iq]
    p_xx = p_c
    p_my = ph2pr[dq]
    p_yy = p_c
    distm = ph2pr[qq]
    return p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, distm


@functools.partial(jax.jit, static_argnames=("unroll",))
def phmm_forward(batch, unroll: int = 4):
    """Batched f32 forward pass.

    batch: dict of device arrays from prepare_batch.
    Returns (log10_likelihood [B] f32, raw_result [B] f32, fallback [B] bool).
    """
    ph2pr_np, m2m_np, _, ic = _tables_f32()
    ph2pr = jnp.asarray(ph2pr_np)
    m2m = jnp.asarray(m2m_np)

    rs_row = batch["rs_row"].astype(jnp.int32)  # [B, Rp]
    hap = batch["hap"].astype(jnp.int32)  # [B, Hp]
    rslen = batch["rslen"].astype(jnp.int32)  # [B]
    haplen = batch["haplen"].astype(jnp.int32)
    b, rp = rs_row.shape
    hp = hap.shape[1]

    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, distm = _row_probs(batch, ph2pr, m2m)
    one_m_distm = 1.0 - distm
    distm3 = distm / 3.0

    init_y = (jnp.float32(ic) / haplen.astype(jnp.float32))[:, None]  # [B,1]

    # hap codes along a diagonal: hap[d-r-1] = hap_ext[(Hp+Rp-d) + r]
    # where hap_ext[j] = reversed hap at j-Rp (zeros elsewhere, never ==
    # a base code because pad value is AMBIG+1 -> treated as mismatch,
    # and those cells never reach the accumulated region).
    hap_rev = hap[:, ::-1]
    hap_ext = jnp.concatenate(
        [
            jnp.full((b, rp), AMBIG + 2, jnp.int32),
            hap_rev,
            jnp.full((b, rp + 1), AMBIG + 2, jnp.int32),
        ],
        axis=1,
    )

    r_iota = jnp.arange(rp, dtype=jnp.int32)[None, :]  # [1, Rp]
    interior = r_iota >= 1  # row >= 1 (c>=1 enforced via c_idx mask)

    zeros = jnp.zeros((b, rp), jnp.float32)
    y0 = zeros.at[:, 0].set(init_y[:, 0])  # diagonal d=0: Y(0,0)=init_Y

    def shift_down(v):
        return jnp.pad(v, ((0, 0), (1, 0)))[:, :-1]

    def step(carry, d):
        m1, x1, y1, m2, x2, y2, res_m, res_x = carry
        m1s = shift_down(m1)
        x1s = shift_down(x1)
        m2s = shift_down(m2)
        x2s = shift_down(x2)
        y2s = shift_down(y2)

        hap_d = jax.lax.dynamic_slice_in_dim(hap_ext, hp + rp - d, rp, axis=1)
        match = (rs_row == hap_d) | (rs_row == AMBIG) | (hap_d == AMBIG)
        prior = jnp.where(match, one_m_distm, distm3)

        c_idx = d - r_iota  # column of each lane on this diagonal
        valid = interior & (c_idx >= 1)

        m_new = prior * ((m2s * p_mm + x2s * p_gapm) + y2s * p_gapm)
        x_new = m1s * p_mx + x1s * p_xx
        y_new = m1 * p_my + y1 * p_yy
        m_new = jnp.where(valid, m_new, 0.0)
        x_new = jnp.where(valid, x_new, 0.0)
        y_new = jnp.where(valid, y_new, 0.0)
        # row 0 boundary: Y(0, c) = INITIAL_CONSTANT / haplen
        y_new = jnp.where(r_iota == 0, init_y, y_new)

        # accumulate last-row M and X at (rslen, d - rslen)
        m_last = jnp.take_along_axis(m_new, rslen[:, None], axis=1)[:, 0]
        x_last = jnp.take_along_axis(x_new, rslen[:, None], axis=1)[:, 0]
        c_at = d - rslen
        cmask = (c_at >= 1) & (c_at <= haplen)
        res_m = res_m + jnp.where(cmask, m_last, 0.0)
        res_x = res_x + jnp.where(cmask, x_last, 0.0)
        return (m_new, x_new, y_new, m1, x1, y1, res_m, res_x), None

    res0 = jnp.zeros((b,), jnp.float32)
    carry0 = (zeros, zeros, y0, zeros, zeros, zeros, res0, res0)
    num_diags = rp + hp  # d = 1 .. (Rp-1) + Hp inclusive
    (m1, x1, y1, m2, x2, y2, res_m, res_x), _ = jax.lax.scan(
        step, carry0, jnp.arange(1, num_diags, dtype=jnp.int32), unroll=unroll
    )
    return _finish(res_m, res_x)


def _finish(res_m, res_x):
    """(log10, raw result, fallback flag) from the last-row M and X sums."""
    log10_ic = _tables_f32()[2]
    result = res_m + res_x
    fallback = (result < jnp.float32(MIN_ACCEPTED)) | ~jnp.isfinite(result)
    log10 = jnp.log10(result) - jnp.float32(log10_ic)
    return log10, result, fallback


COMPACT_KEYS = ("rs_row", "q", "i", "d", "c", "hap")


def compact_batch(batch):
    """The int8 wire: base codes (<= 5) and quals (<= 93) fit int8
    exactly, a quarter of the bytes of int32; lengths stay int32."""
    out = {k: np.asarray(batch[k]).astype(np.int8) for k in COMPACT_KEYS}
    out["rslen"] = np.asarray(batch["rslen"]).astype(np.int32)
    out["haplen"] = np.asarray(batch["haplen"]).astype(np.int32)
    return out


def phmm_forward_auto(batch):
    """phmm_forward, production dispatch: the CUDA kernel on a GPU
    (ops/phmm_cuda.py, fed the compact int8 batch), the scan on the CPU.
    Any other backend is an error, and so is a kernel failure: nothing
    falls back to the scan quietly.  The kernel handles any batch size,
    so each bucket's true B is used as is."""
    backend = jax.default_backend()
    if backend == "gpu":
        from .phmm_cuda import phmm_forward_cuda

        return phmm_forward_cuda(compact_batch(batch))
    if backend == "cpu":
        return phmm_forward(batch)
    raise NotImplementedError(f"no PairHMM engine for backend {backend!r}")


def phmm_likelihoods(batch, reads=None, haps=None, pairs=None):
    """Device f32 pass + host float64 fallback for underflowed testcases.

    Mirrors computelikelihoodsboth: results below MIN_ACCEPTED in float are
    recomputed in double (IntelPairHmmCSource.cpp:69-77).  The fallback
    requires the original (unpadded) testcases.
    """
    log10, _result, fallback = jax.device_get(phmm_forward(batch))
    out = log10.astype(np.float64)
    if fallback.any():
        if reads is None:
            raise ValueError("fallback cases present; need original testcases")
        ctxd = oracle.get_ctx(np.float64)
        for bi in np.nonzero(fallback)[0]:
            ri, hi = pairs[bi]
            r = reads[ri]
            res_d = oracle.compute_full_prob(
                r["bases"], haps[hi], r["q"], r["i"], r["d"], r["c"], np.float64
            )
            out[bi] = np.log10(res_d) - ctxd.log10_initial_constant
    return out
