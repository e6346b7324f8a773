"""Banded Smith-Waterman extension on the device (bwa-mem ksw_extend semantics).

The reference's AVX kernel (bandedSWA.cpp:1447
smithWaterman256_16) puts 16 pairs in SIMD lanes and walks rows x columns
sequentially.  Here the batch of pairs is the lane axis and each target row
is ONE vectorized step over the whole [B, Q] row: the only true sequential
dependence inside a row — the F (insertion-run) chain
    F(i,j+1) = max(F(i,j) - e_ins, max(M(i,j) - oe_ins, 0))
unrolls to a running maximum
    F(i,j)   = max(0, max_{j'<j}(c_{j'} + j'*e_ins) - (j-1)*e_ins),
      c_j = max(M(i,j) - oe_ins, 0)
which is a `lax.cummax` — so the scan is over target rows only (T steps),
not T*Q cells.

Exact-parity features carried per lane (see ops/oracle/bsw.py and
bandedSWA.cpp:130-251):
  * the H(i-1,j-1)==0 -> M=0 rule, seed-column decay h1_pre
  * per-pair band clamp from max_ins/max_del
  * adaptive band narrowing via the post-row zero scan on (eh.h, eh.e) —
    including its effect on the j==qlen gscore check
  * m==0 and z-drop early exits, last-argmax mj tie-breaking
  * outputs {score, qle, tle, gtle, gscore, max_off}
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .oracle.bsw import BswParams, DEFAULT_PARAMS

NEG = jnp.int32(-(1 << 20))


def prepare_pairs(pairs, params: BswParams = DEFAULT_PARAMS, q_pad=None, t_pad=None):
    """pairs: list of (query_codes, target_codes, h0). Pads to fixed shapes."""
    if q_pad is None:
        q_pad = max(len(q) for q, _, _ in pairs)
    if t_pad is None:
        t_pad = max(len(t) for _, t, _ in pairs)
    b = len(pairs)
    query = np.full((b, q_pad), 4, dtype=np.int8)
    target = np.full((b, t_pad), 4, dtype=np.int8)
    qlen = np.zeros(b, dtype=np.int32)
    tlen = np.zeros(b, dtype=np.int32)
    h0 = np.zeros(b, dtype=np.int32)
    for i, (q, t, h) in enumerate(pairs):
        query[i, : len(q)] = q
        target[i, : len(t)] = t
        qlen[i] = len(q)
        tlen[i] = len(t)
        h0[i] = h
    return {"query": query, "target": target, "qlen": qlen, "tlen": tlen, "h0": h0}


def _params_tuple(p: BswParams):
    return (
        p.o_del,
        p.e_del,
        p.o_ins,
        p.e_ins,
        p.zdrop,
        p.end_bonus,
        p.match,
        p.mismatch,
        p.ambig,
        p.w,
    )


@functools.partial(jax.jit, static_argnames=("params",))
def bsw_batch(batch, params=_params_tuple(DEFAULT_PARAMS)):
    """Batched banded SW extension.

    batch: dict from prepare_pairs (device or numpy arrays).
    Returns dict of [B] int32 arrays: score, qle, tle, gtle, gscore, max_off.
    """
    o_del, e_del, o_ins, e_ins, zdrop, end_bonus, match, mismatch, ambig, w0 = params
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins

    query = batch["query"].astype(jnp.int32)  # [B, Qp]
    target = batch["target"].astype(jnp.int32)  # [B, Tp]
    qlen = batch["qlen"].astype(jnp.int32)  # [B]
    tlen = batch["tlen"].astype(jnp.int32)
    h0 = batch["h0"].astype(jnp.int32)
    b, qp = query.shape
    tp = target.shape[1]
    qe = qp + 1  # eh-array length: entry j holds (H(i, j-1), E(i+1, j))

    j_iota = jnp.arange(qe, dtype=jnp.int32)[None, :]  # [1, Qe]

    # per-pair band clamp (bandedSWA.cpp:166-175); max score in mat is `match`
    max_sc = match
    # f32 is exact here (values << 2^24); truncation matches the C int cast
    max_ins = jnp.maximum(
        ((qlen * max_sc + end_bonus - o_ins).astype(jnp.float32) / e_ins + 1.0)
        .astype(jnp.int32),
        1,
    )
    max_del = jnp.maximum(
        ((qlen * max_sc + end_bonus - o_del).astype(jnp.float32) / e_del + 1.0)
        .astype(jnp.int32),
        1,
    )
    w = jnp.minimum(jnp.minimum(w0, max_ins), max_del)  # [B]

    # first row of eh.h (bandedSWA.cpp:158-162): eh[0]=h0, eh[1]=h0-oe_ins,
    # then -e_ins while the previous entry > e_ins
    decay = h0[:, None] - oe_ins - (j_iota - 1) * e_ins  # value at j>=1
    first_h = jnp.where(j_iota == 0, h0[:, None], jnp.maximum(decay, 0))
    # the chain stops at the first entry <= e_ins: entries after the first
    # non-positive... reference keeps filling while eh[j-1].h > e_ins
    keep = decay + e_ins > e_ins  # eh[j-1].h > e_ins  <=>  decay_{j-1} > e_ins
    # decay_{j} = eh[j].h; condition for writing eh[j] (j>=2) is eh[j-1].h > e_ins
    prev_h = h0[:, None] - oe_ins - (j_iota - 2) * e_ins
    write = (j_iota <= 1) | ((prev_h > e_ins) & (j_iota <= qlen[:, None]))
    # entries never written stay 0 (calloc)
    h_init = jnp.where(write, jnp.maximum(first_h, 0), 0)
    h_init = jnp.where(j_iota == 0, h0[:, None], h_init)
    h_init = jnp.where(
        (j_iota == 1) & (1 <= qlen[:, None]),
        jnp.maximum(h0[:, None] - oe_ins, 0),
        h_init,
    )
    del keep, first_h, decay, prev_h

    e_init = jnp.zeros((b, qe), jnp.int32)

    # score profile per row is computed on the fly from target char
    q_codes = jnp.concatenate(
        [query, jnp.full((b, 1), 4, jnp.int32)], axis=1
    )  # [B, Qe]

    state = dict(
        h=h_init,
        e=e_init,
        beg=jnp.zeros(b, jnp.int32),
        end=qlen,
        alive=jnp.ones(b, dtype=bool),
        max=h0,
        max_i=jnp.full(b, -1, jnp.int32),
        max_j=jnp.full(b, -1, jnp.int32),
        max_ie=jnp.full(b, -1, jnp.int32),
        gscore=jnp.full(b, -1, jnp.int32),
        max_off=jnp.zeros(b, jnp.int32),
    )

    def row_step(st, i):
        act = st["alive"] & (i < tlen)  # [B]
        beg0, end0 = st["beg"], st["end"]
        # band update at row start (bandedSWA.cpp:180-183)
        beg = jnp.maximum(beg0, i - w)
        end = jnp.minimum(jnp.minimum(end0, i + w + 1), qlen)
        h1_pre = jnp.where(
            beg == 0, jnp.maximum(h0 - (o_del + e_del * (i + 1)), 0), 0
        )  # [B]

        t_char = jax.lax.dynamic_slice_in_dim(target, jnp.minimum(i, tp - 1), 1, axis=1)  # [B,1]
        qsc = jnp.where(
            (t_char == 4) | (q_codes == 4) | (t_char > 4) | (q_codes > 4),
            jnp.int32(ambig),
            jnp.where(q_codes == t_char, jnp.int32(match), jnp.int32(-mismatch)),
        )  # [B, Qe]

        in_band = (j_iota >= beg[:, None]) & (j_iota < end[:, None])  # [B, Qe]

        hprev = st["h"]
        eprev = st["e"]
        m_val = jnp.where(hprev != 0, hprev + qsc, 0)  # M(i,j)
        h0_val = jnp.maximum(m_val, eprev)
        # F via running max (exact lazy-F identity)
        c = jnp.maximum(m_val - oe_ins, 0)
        g = jnp.where(in_band, c + j_iota * e_ins, NEG)
        gmax = jax.lax.cummax(g, axis=1)
        gsh = jnp.concatenate([jnp.full((b, 1), NEG), gmax[:, :-1]], axis=1)
        f = jnp.maximum(gsh - (j_iota - 1) * e_ins, 0)
        f = jnp.where(gsh <= NEG // 2, 0, f)  # no contribution yet -> f=0
        h_row = jnp.maximum(h0_val, f)  # H(i, j)
        e_next = jnp.maximum(eprev - e_del, jnp.maximum(m_val - oe_del, 0))

        # row max / last argmax within the band
        h_band = jnp.where(in_band, h_row, 0)
        m = jnp.maximum(jnp.max(h_band, axis=1), 0)  # [B]
        mj = jnp.max(
            jnp.where(in_band & (h_row == m[:, None]), j_iota, -1), axis=1
        )

        # h1 after the loop = H(i, end-1), or h1_pre if the band was empty
        h1_fin_idx = jnp.maximum(end - 1, 0)
        h1_fin = jnp.take_along_axis(h_row, h1_fin_idx[:, None], axis=1)[:, 0]
        h1_fin = jnp.where(end > beg, h1_fin, h1_pre)

        # eh writes: h[j] := H(i, j-1) for j in [beg, end]; h[beg] := h1_pre
        h_shift = jnp.concatenate([jnp.zeros((b, 1), jnp.int32), h_row[:, :-1]], axis=1)
        cand_h = jnp.where(j_iota == beg[:, None], h1_pre[:, None], h_shift)
        upd_h = (j_iota >= beg[:, None]) & (j_iota <= end[:, None])
        h_new = jnp.where(upd_h & act[:, None], cand_h, hprev)
        cand_e = jnp.where(j_iota == end[:, None], 0, e_next)
        upd_e = (j_iota >= beg[:, None]) & (j_iota <= end[:, None])
        e_new = jnp.where(upd_e & act[:, None], cand_e, eprev)

        # gscore (j == qlen i.e. end == qlen)
        g_upd = act & (end == qlen) & (st["gscore"] <= h1_fin)
        max_ie = jnp.where(g_upd, i, st["max_ie"])
        gscore = jnp.where(g_upd, h1_fin, st["gscore"])

        # m == 0 break (after gscore update)
        alive = st["alive"] & jnp.where(act, m != 0, True)
        act2 = act & (m != 0)

        # max / z-drop
        improve = act2 & (m > st["max"])
        mmax = jnp.where(improve, m, st["max"])
        max_i = jnp.where(improve, i, st["max_i"])
        max_j = jnp.where(improve, mj, st["max_j"])
        max_off = jnp.where(
            improve, jnp.maximum(st["max_off"], jnp.abs(mj - i)), st["max_off"]
        )
        di = i - st["max_i"]
        dj = mj - st["max_j"]
        zd = jnp.where(
            di > dj,
            st["max"] - m - (di - dj) * e_del > zdrop,
            st["max"] - m - (dj - di) * e_ins > zdrop,
        )
        zbreak = act2 & ~improve & (zdrop > 0) & zd
        alive = alive & ~zbreak

        # adaptive band narrowing on the UPDATED eh arrays
        nz = (h_new != 0) | (e_new != 0)
        in_scan = (j_iota >= beg[:, None]) & (j_iota < end[:, None])
        first_nz = jnp.min(
            jnp.where(in_scan & nz, j_iota, end[:, None]), axis=1
        )  # j of first nonzero, or end
        beg_n = first_nz
        in_scan2 = (j_iota >= beg_n[:, None]) & (j_iota <= end[:, None])
        last_nz = jnp.max(
            jnp.where(in_scan2 & nz, j_iota, beg_n[:, None] - 1), axis=1
        )
        end_n = jnp.minimum(last_nz + 2, qlen)

        upd_band = act2 & ~zbreak
        beg_out = jnp.where(upd_band, beg_n, beg)
        end_out = jnp.where(upd_band, end_n, end)
        # rows where the pair is inactive keep the original carried band
        beg_out = jnp.where(act, beg_out, beg0)
        end_out = jnp.where(act, end_out, end0)

        new_state = dict(
            h=h_new,
            e=e_new,
            beg=beg_out,
            end=end_out,
            alive=alive,
            max=mmax,
            max_i=max_i,
            max_j=max_j,
            max_ie=max_ie,
            gscore=gscore,
            max_off=max_off,
        )
        return new_state, None

    state, _ = jax.lax.scan(row_step, state, jnp.arange(tp, dtype=jnp.int32))
    return {
        "score": state["max"],
        "qle": state["max_j"] + 1,
        "tle": state["max_i"] + 1,
        "gtle": state["max_ie"] + 1,
        "gscore": state["gscore"],
        "max_off": state["max_off"],
    }


OUT_ORDER = ("score", "qle", "tle", "gtle", "gscore", "max_off")


def pack_codes_2bit(codes):
    """Host-side 2-bit pack: [n, L] uint8 base codes in 0..3 (pad slots 0),
    L % 4 == 0, -> [n, L//4] uint8 wire bytes (little-endian within the
    byte): a quarter of the int8 bytes to move to the device."""
    n, L = codes.shape
    assert L % 4 == 0, L
    b = (codes[:, 0::4] | (codes[:, 1::4] << 2)
         | (codes[:, 2::4] << 4) | (codes[:, 3::4] << 6))
    return np.ascontiguousarray(b, dtype=np.uint8)


def unpack_codes_2bit(packed, length, nlen, fill=4):
    """Device-side inverse of pack_codes_2bit: -> [n, length] i32 codes,
    positions >= nlen restored to the pad value (bit-exact reconstruction
    of the raw padded array)."""
    shifts = jnp.arange(4, dtype=jnp.uint8) * jnp.uint8(2)
    codes = ((packed[:, :, None] >> shifts[None, None, :])
             & jnp.uint8(3)).reshape(packed.shape[0], -1)
    codes = codes[:, :length].astype(jnp.int32)
    j = jnp.arange(length, dtype=jnp.int32)[None, :]
    return jnp.where(j < nlen[:, None], codes, jnp.int32(fill))


@functools.partial(jax.jit, static_argnames=("q_pad", "t_pad", "params",
                                             "narrow"))
def bsw_batch_stacked(batch, q_pad=None, t_pad=None,
                      params=_params_tuple(DEFAULT_PARAMS),
                      narrow: bool = False):
    """bsw_batch returning ONE stacked [6, B] array (OUT_ORDER rows), so
    a driver fetches one object per dispatch.  batch carries either raw
    "query"/"target" codes or the 2-bit "qpack"/"tpack" wire (with
    q_pad/t_pad), unpacked on device inside the same jit.  narrow=True
    casts to int16 before the fetch: callers prove the bound (max |h0| +
    q_pad*match plus index fields <= t_pad) fits."""
    if "qpack" in batch:
        qlen = batch["qlen"].astype(jnp.int32)
        tlen = batch["tlen"].astype(jnp.int32)
        batch = {"query": unpack_codes_2bit(batch["qpack"], q_pad, qlen),
                 "target": unpack_codes_2bit(batch["tpack"], t_pad, tlen),
                 "qlen": qlen, "tlen": tlen, "h0": batch["h0"]}
    out = bsw_batch(batch, params)
    arr = jnp.stack([out[k] for k in OUT_ORDER])
    return arr.astype(jnp.int16) if narrow else arr
