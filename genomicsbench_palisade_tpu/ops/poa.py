"""Partial-order alignment on the device (spoa convex-NW semantics).

Graph topology mutates per added sequence (pointer
work — stays on host, see oracle/poa.py PoaGraph); the O(nodes x width)
convex Needleman-Wunsch DP and its traceback run on device, vmapped over
many MSA windows in lock-step:

  round k: align sequence k of EVERY window on device (one launch),
           then apply the k-th graph updates on the host.

DP reformulation (exact, see sisd_alignment_engine.cpp:659-907):
  * F/O (vertical, graph-edge gaps) are max-reductions over <=P padded
    predecessor rows — pure gathers + vector max.
  * E/Q (horizontal gaps) couple through H within a row; each chain has
    the closed form  E[j] = g + (j-1)e + max_{j'<j}(H[j'] - j'e)
    (a cummax), and the E<->Q coupling converges by iterating the pair of
    cummax passes to fixpoint (gap-after-gap alternation depth is tiny;
    the loop runs until H stops changing, so the result is exact).
  * traceback is a device while_loop emitting (node_rank, seq_pos) pairs
    with the reference's exact priority order and extend-repair loops.

Rank-space graph arrays (padded): code_by_rank [N], preds [N, P] (rank+1,
row 0 = virtual start), npreds [N], out_empty [N].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = -(1 << 31) + 1024  # spoa kNegativeInfinity

@functools.lru_cache(maxsize=None)
def _batched_align(params, w_cap, a_cap, atype="nw", ring_d=0):
    """Cached jit of the vmapped aligner (re-creating the vmap closure per
    call would re-trace the whole DP every round)."""
    def run(sc, sl, ga):
        ai, aj, cnt = jax.vmap(
            lambda sc1, sl1, ga1: poa_align_device(
                sc1, sl1, ga1, params, w_cap, a_cap, atype, ring_d)
        )(sc, sl, ga)
        # one packed output -> ONE host fetch
        return jnp.concatenate([ai, aj, cnt[:, None]], axis=1)

    return jax.jit(run)


def graph_to_arrays(graph, n_cap: int, p_cap: int, code_map=None):
    """Host: PoaGraph -> padded rank-space arrays. Returns None on overflow.

    Vectorized over the edge list (no per-node Python loop).  `code_map` optionally
    translates per-graph codes to global ACGT codes in the same pass.
    Pred slots keep the node.in_edges order (edges are appended to
    in_edges at creation, so stable-sorting by end rank preserves it)."""
    n = len(graph.nodes)
    if n > n_cap:
        return None
    code = np.zeros(n_cap, np.int32)
    preds = np.zeros((n_cap, p_cap), np.int32)
    npreds = np.zeros(n_cap, np.int32)
    out_empty = np.zeros(n_cap, bool)
    if n:
        r2n = np.asarray(graph.rank_to_node_id, np.int64)
        node_rank = np.empty(n, np.int64)
        node_rank[r2n] = np.arange(n)
        node_codes = np.fromiter((nd.code for nd in graph.nodes), np.int64, n)
        if code_map is None:
            code[:n] = node_codes[r2n]
        else:
            glob = np.array([code_map.get(ch, 9) for ch in graph.decoder],
                            np.int64)
            code[:n] = glob[node_codes[r2n]]
        ne = len(graph.edges)
        out_empty[:n] = True
        if ne:
            eb = np.fromiter((ed.begin for ed in graph.edges), np.int64, ne)
            ee = np.fromiter((ed.end for ed in graph.edges), np.int64, ne)
            er = node_rank[ee]
            order = np.argsort(er, kind="stable")
            er_s = er[order]
            deg = np.bincount(er_s, minlength=n)
            if deg.max() > p_cap:
                return None
            starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
            slots = np.arange(ne) - starts[er_s]
            preds[er_s, slots] = node_rank[eb[order]] + 1
            npreds[:n] = deg
            out_empty[:n] = np.bincount(node_rank[eb], minlength=n) == 0
    return {
        "code": code,
        "preds": preds,
        "npreds": npreds,
        "out_empty": out_empty,
        "n_nodes": np.int32(n),
    }


def _lazy_chain(h, open_pen, ext_pen, j_iota, w):
    """E[j] = open + (j-1)*ext + max_{j'<j}(h[j'] - j'*ext); E[0] = NEG_INF."""
    src = h - j_iota * ext_pen
    cm = jax.lax.cummax(src)
    cm_excl = jnp.concatenate([jnp.array([NEG_INF], jnp.int32), cm[:-1]])
    e = cm_excl + open_pen + (j_iota - 1) * ext_pen
    return jnp.where(j_iota == 0, NEG_INF, e)


RING_D = 32  # ring depth for the bounded-pred-distance fast path


@functools.partial(jax.jit,
                   static_argnames=("params", "w_cap", "a_cap", "atype",
                                    "ring_d"))
def poa_align_device(seqcode, seqlen, garr, params, w_cap, a_cap,
                     atype: str = "nw", ring_d: int = 0):
    """One (sequence, graph) convex alignment on device, for all three
    spoa AlignmentTypes (alignment_engine.hpp:19-24; type-dependent
    pieces mirror oracle convex_align / sisd_alignment_engine.cpp:165-240):

      nw  H boundaries from the gap chains; max cell in the last column
          of sink rows; traceback to (0, 0).
      sw  zero H boundaries, every cell clamped at 0 (:747-749), max over
          all cells (first in rank-then-column order), traceback stops at
          H == 0 (carried as a 13th bit plane).
      ov  NW top row / zero first column (:214-240), max over all cells
          of sink rows, traceback stops at i == 0 or j == 0.

    seqcode: [w_cap-1] int32 base codes; seqlen: scalar; garr: graph arrays.
    Returns (aln_i [a_cap] rank-or-minus-one, aln_j [a_cap], aln_len).
    Designed to be vmapped over a batch of windows.
    """
    assert atype in ("nw", "sw", "ov"), atype
    m, nmis, g, e, q, c = params
    n_cap, p_cap = garr["preds"].shape
    w = w_cap  # matrix width = seq capacity + 1
    n_nodes = garr["n_nodes"]
    j_iota = jnp.arange(w, dtype=jnp.int32)
    valid_j = j_iota <= seqlen  # columns 0..seqlen are live

    # ---------------- matrix init ----------------
    # Only H/F/O matrices are carried (predecessor rows are random-access);
    # E/Q couple within a row only, so their rows are consumed in-place by
    # the traceback bit planes (below) and never stored.  The three
    # matrices live PACKED as one [N+1, 3, w] array: in-loop scatters and
    # gathers are costly, so one .at[i].set and one
    # [pred_idx] gather per row replace three of each.
    row0_O = jnp.where(j_iota == 0, 0, NEG_INF)
    row0_Q = jnp.where(j_iota == 0, 0, q + (j_iota - 1) * c)
    row0_F = jnp.where(j_iota == 0, 0, NEG_INF)
    row0_E = jnp.where(j_iota == 0, 0, g + (j_iota - 1) * e)
    # the H boundary is the only type-dependent part of initialize()
    if atype == "sw":
        row0_H = jnp.zeros(w, jnp.int32)
    else:  # nw, ov
        row0_H = jnp.where(j_iota == 0, 0, jnp.maximum(row0_Q, row0_E))
    HFO = jnp.zeros((n_cap + 1, 3, w), jnp.int32)
    HFO = HFO.at[0].set(jnp.stack([row0_H, row0_F, row0_O]))

    # column-0 boundary rows are produced inside the row scan (they depend
    # on predecessor rows, same recurrence restricted to j==0)

    def _row_planes(h_row, e_row, q_row, f_row, o_row,
                    pred_idx, pred_mask, pm_eu, H_p, F_p, O_p, H_p_sh, prof):
        """The reference traceback's decision predicates for one row, as
        [w]-wide planes (computed where the pred rows are already in hand,
        so the traceback need not re-gather)."""
        neg1 = jnp.full((1,), NEG_INF, jnp.int32)
        pred_col = pred_idx[:, None]  # [P, 1]

        def first_true(ok):  # [P, w] -> mask of the FIRST true slot per col
            return ok & (jnp.cumsum(ok.astype(jnp.int32), axis=0) == 1)

        def pick(first_mask):  # pred_idx at the first-true slot (0 if none)
            return jnp.max(jnp.where(first_mask, pred_col, -1), axis=0
                           ).clip(0)

        diag_ok = (pred_mask[:, None] & (h_row[None, :] == H_p_sh + prof[None, :])
                   & (j_iota[None, :] != 0))
        found_d = jnp.any(diag_ok, axis=0)
        prev_d = pick(first_true(diag_ok))

        c1 = pred_mask[:, None] & (h_row[None, :] == F_p + e)
        c2 = pred_mask[:, None] & (h_row[None, :] == H_p + g)
        c3 = pred_mask[:, None] & (h_row[None, :] == O_p + c)
        c4 = pred_mask[:, None] & (h_row[None, :] == H_p + q)
        vert_ok = c1 | c2 | c3 | c4
        found_v = jnp.any(vert_ok, axis=0)
        first_v = first_true(vert_ok)
        prev_v = pick(first_v)
        ext_up = jnp.any(first_v & (c1 | (~c2 & c3)), axis=0)

        def sh(v):
            return jnp.concatenate([neg1, v[:-1]])

        e1 = h_row == sh(e_row) + e
        e2 = h_row == sh(h_row) + g
        e3 = h_row == sh(q_row) + c
        e4 = h_row == sh(h_row) + q
        found_h = (j_iota != 0) & (e1 | e2 | e3 | e4)
        ext_left = e1 | (~e2 & e3)

        def nx(v):
            return jnp.concatenate([v[1:], jnp.zeros((1,), jnp.int32)])

        el_stop = (e_row + e != nx(e_row)) & (q_row + c != nx(q_row))

        cond_a = pm_eu[:, None] & ((f_row[None, :] == F_p + e)
                                   | (o_row[None, :] == O_p + c))
        hit_a = jnp.any(cond_a, axis=0)
        prev_a = pick(first_true(cond_a))
        cond_b = pm_eu[:, None] & ((f_row[None, :] == H_p + g)
                                   | (o_row[None, :] == H_p + q))
        hit_b = jnp.any(cond_b, axis=0)
        prev_b = pick(first_true(cond_b))

        return jnp.stack([
            found_d.astype(jnp.int32), prev_d,
            found_v.astype(jnp.int32), prev_v, ext_up.astype(jnp.int32),
            found_h.astype(jnp.int32), ext_left.astype(jnp.int32),
            el_stop.astype(jnp.int32),
            hit_a.astype(jnp.int32), prev_a,
            hit_b.astype(jnp.int32), prev_b,
            (h_row == 0).astype(jnp.int32),  # sw traceback stop bit
        ])  # [NPLANES, w]

    def row_core(HFO_p, pred_idx, pred_mask, np_r, r):
        code_i = garr["code"][r]
        H_p = HFO_p[:, 0]
        F_p = HFO_p[:, 1]
        O_p = HFO_p[:, 2]
        neg = jnp.full((p_cap, w), NEG_INF, jnp.int32)
        H_pm = jnp.where(pred_mask[:, None], H_p, neg)
        F_pm = jnp.where(pred_mask[:, None], F_p, neg)
        O_pm = jnp.where(pred_mask[:, None], O_p, neg)

        # col-0 boundary (initialize(): penalty from preds, or q-c / g-e)
        has_preds = np_r > 0
        f0 = jnp.where(
            has_preds, jnp.max(jnp.where(pred_mask, F_p[:, 0], NEG_INF)), g - e
        ) + e
        o0 = jnp.where(
            has_preds, jnp.max(jnp.where(pred_mask, O_p[:, 0], NEG_INF)), q - c
        ) + c
        # H column 0 is set from the gap chains for kNW only (oracle
        # convex_align init; sw/ov leave it 0)
        h0 = (jnp.maximum(f0, o0) if atype == "nw"
              else jnp.zeros((), jnp.int32))

        F_row = jnp.max(jnp.maximum(H_pm + g, F_pm + e), axis=0)
        O_row = jnp.max(jnp.maximum(H_pm + q, O_pm + c), axis=0)
        prof = jnp.concatenate(
            [jnp.array([0], jnp.int32), jnp.where(seqcode == code_i, m, nmis)]
        )
        H_p_sh = jnp.concatenate([neg[:, :1], H_pm[:, :-1]], axis=1)
        H_base = jnp.max(H_p_sh + prof[None, :], axis=0)

        base = jnp.maximum(H_base, jnp.maximum(F_row, O_row))
        base = jnp.where(j_iota == 0, h0, base)
        F_row = jnp.where(j_iota == 0, f0, F_row)
        O_row = jnp.where(j_iota == 0, o0, O_row)
        # E/Q fixpoint
        def fix_cond(st):
            return st[3]

        def fix_body(st):
            h_cur, e_row, q_row, _ = st
            e_new = _lazy_chain(h_cur, g, e, j_iota, w)
            q_new = _lazy_chain(h_cur, q, c, j_iota, w)
            e_new = jnp.where(j_iota == 0, NEG_INF, e_new)
            q_new = jnp.where(j_iota == 0, NEG_INF, q_new)
            h_new = jnp.maximum(base, jnp.maximum(e_new, q_new))
            if atype == "sw":  # local: every cell clamped at 0 (:747-749)
                h_new = jnp.maximum(h_new, 0)
            h_new = jnp.where(j_iota == 0, h0, h_new)
            changed = jnp.any(h_new != h_cur)
            return (h_new, e_new, q_new, changed)

        if atype == "sw":
            base = jnp.where(j_iota == 0, h0, jnp.maximum(base, 0))
        st = (base, jnp.full(w, NEG_INF, jnp.int32), jnp.full(w, NEG_INF, jnp.int32), jnp.bool_(True))
        h_row, e_row, q_row, _ = jax.lax.while_loop(fix_cond, fix_body, st)
        # one more pass so E/Q reflect the final H (matrix-value exactness)
        e_row = jnp.where(j_iota == 0, NEG_INF, _lazy_chain(h_row, g, e, j_iota, w))
        q_row = jnp.where(j_iota == 0, NEG_INF, _lazy_chain(h_row, q, c, j_iota, w))

        planes = _row_planes(
            h_row, e_row, q_row, F_row, O_row, pred_idx, pred_mask,
            jnp.arange(p_cap) < np_r, H_p, F_p, O_p, H_p_sh, prof)
        return h_row, F_row, O_row, planes

    def row_prep(r):
        np_r = garr["npreds"][r]
        pred_idx = jnp.where(
            jnp.arange(p_cap) < jnp.maximum(np_r, 1), garr["preds"][r], 0
        )
        pred_mask = jnp.arange(p_cap) < jnp.maximum(np_r, 1)  # [P]
        return pred_idx, pred_mask, np_r

    row0_stack = jnp.stack([row0_H, row0_F, row0_O])  # [3, w]

    if ring_d:
        # bounded-pred-distance fast path: MSA graphs keep predecessor
        # ranks within a few of the node on realistic windows, so the last ring_d rows ride the scan carry and the
        # HFO[pred_idx] gather of small random rows becomes a one-hot masked sum over ring slots.
        # Virtual rank 0 (the boundary row) is selected statically.
        # Callers guarantee rank - pred_rank <= ring_d for pred >= 1
        # (align_batch checks and falls back to the full-matrix path).
        D = ring_d
        slot_iota = jnp.arange(D, dtype=jnp.int32)

        def row_step_ring(ring, r):
            i = r + 1
            pred_idx, pred_mask, np_r = row_prep(r)
            is0 = pred_idx == 0
            slot = (pred_idx - 1) % D
            onehot = (slot[:, None] == slot_iota[None, :]) & ~is0[:, None]
            gathered = jnp.sum(
                jnp.where(onehot[:, :, None, None], ring[None], 0), axis=1)
            HFO_p = jnp.where(is0[:, None, None], row0_stack[None],
                              gathered)
            h_row, F_row, O_row, planes = row_core(
                HFO_p, pred_idx, pred_mask, np_r, r)
            ring = ring.at[(i - 1) % D].set(
                jnp.stack([h_row, F_row, O_row]))
            return ring, (planes, h_row)

        ring0 = jnp.zeros((D, 3, w), jnp.int32)
        _, (planes_r, h_rows) = jax.lax.scan(
            row_step_ring, ring0, jnp.arange(n_cap, dtype=jnp.int32))
        H = jnp.concatenate([row0_H[None, :], h_rows], axis=0)
    else:
        def row_step(HFO, r):
            i = r + 1
            pred_idx, pred_mask, np_r = row_prep(r)
            HFO_p = HFO[pred_idx]  # [P, 3, W] — ONE gather
            h_row, F_row, O_row, planes = row_core(
                HFO_p, pred_idx, pred_mask, np_r, r)
            # unconditional in-place row write: rows past n_nodes hold
            # junk that nothing reads (preds of live rows never point
            # there, the max-cell scan masks rows >= n_nodes, the walk
            # never visits them).  The old lax.cond(live, set, identity)
            # lowered to a SELECT over the whole [N+1, 3, W] carry — a
            # 12.6 MB copy per row at reference window shapes.
            HFO = HFO.at[i].set(jnp.stack([h_row, F_row, O_row]))
            return HFO, planes

        HFO, planes_r = jax.lax.scan(
            row_step, HFO, jnp.arange(n_cap, dtype=jnp.int32)
        )
        H = HFO[:, 0, :]

    # ---------------- find max (type-dependent cell set; the reference
    # keeps the FIRST maximum in rank-then-column order via strict <,
    # which jnp.argmax's first-max rule reproduces) ----------------
    rows = jnp.arange(n_cap, dtype=jnp.int32)
    live_rows = rows < n_nodes
    is_sink = garr["out_empty"] & live_rows
    h_last = H[1:, :]  # row i corresponds to rank i-1
    start_done = jnp.bool_(False)
    if atype == "nw":  # last column of sink rows
        end_scores = jnp.where(
            is_sink, jnp.take_along_axis(h_last, jnp.broadcast_to(seqlen, (n_cap,))[:, None], 1)[:, 0], NEG_INF
        )
        best_rank = jnp.argmax(end_scores)  # argmax returns first max
        max_i = best_rank + 1
        max_j = seqlen
    else:  # sw: all cells of all rows; ov: all cells of sink rows
        j_ok = (j_iota >= 1) & valid_j
        h_m = jnp.where(j_ok[None, :], h_last, NEG_INF)
        row_max = jnp.max(h_m, axis=1)
        row_arg = jnp.argmax(h_m, axis=1).astype(jnp.int32)
        rmask = is_sink if atype == "ov" else live_rows
        scores = jnp.where(rmask, row_max, NEG_INF)
        best_rank = jnp.argmax(scores)
        max_i = best_rank + 1
        max_j = row_arg[best_rank]
        if atype == "sw":
            # local max_score starts at 0 with strict improvement: no
            # positive cell means an empty alignment
            start_done = scores[best_rank] <= 0

    # ---------------- traceback ----------------
    # The per-step predecessor gathers + .at[cnt].set appends of a naive
    # device while-loop are costly inside a loop.  Instead every decision predicate of the
    # reference's walk (sisd_alignment_engine.cpp backtrack order: diag
    # over preds, vertical over preds with extend-up, horizontal with
    # extend-left, and both repair loops' conditions) was emitted by the
    # fill scan as per-row bit planes (planes_r), and the walk becomes a
    # fixed-length scan that reads one [NPLANES] column per step and emits
    # exactly one alignment entry — no scatters, no nested loops.
    neg1 = jnp.full((1,), NEG_INF, jnp.int32)
    zero_plane = jnp.zeros(w, jnp.int32)
    e1_0 = row0_H == jnp.concatenate([neg1, row0_E[:-1]]) + e
    e2_0 = row0_H == jnp.concatenate([neg1, row0_H[:-1]]) + g
    e3_0 = row0_H == jnp.concatenate([neg1, row0_Q[:-1]]) + c
    e4_0 = row0_H == jnp.concatenate([neg1, row0_H[:-1]]) + q
    found_h0 = (j_iota != 0) & (e1_0 | e2_0 | e3_0 | e4_0)
    ext_left0 = e1_0 | (~e2_0 & e3_0)
    zero1 = jnp.zeros((1,), jnp.int32)
    el_stop0 = ((row0_E + e != jnp.concatenate([row0_E[1:], zero1]))
                & (row0_Q + c != jnp.concatenate([row0_Q[1:], zero1])))
    planes_0 = jnp.stack([
        zero_plane, zero_plane, zero_plane, zero_plane, zero_plane,
        found_h0.astype(jnp.int32), ext_left0.astype(jnp.int32),
        el_stop0.astype(jnp.int32),
        zero_plane, zero_plane, zero_plane, zero_plane,
        (row0_H == 0).astype(jnp.int32),
    ])  # [NPLANES, w]
    nplanes = planes_0.shape[0]
    bits = jnp.concatenate(
        [planes_0[:, None, :], jnp.moveaxis(planes_r, 0, 1)], axis=1
    )  # [NPLANES, N+1, W]

    MODE_NORMAL, MODE_EL, MODE_EU = 0, 1, 2

    def tb_step(st, _):
        i, j, mode, done = st
        j_eff = jnp.where(mode == MODE_EL, j - 1, j)
        v = jax.lax.dynamic_slice(
            bits, (0, i, jnp.maximum(j_eff, 0)), (nplanes, 1, 1))[:, 0, 0]

        # --- normal step (type-dependent stop, oracle _more :770-778) ---
        if atype == "nw":
            at_end = (i == 0) & (j == 0)
        elif atype == "ov":
            at_end = (i == 0) | (j == 0)
        else:  # sw: stop when H[i][j] == 0 (plane 12)
            at_end = v[12] == 1
        fd = (v[0] == 1) & ~at_end
        fv = (v[2] == 1) & ~fd & ~at_end
        fh = (v[5] == 1) & ~fd & ~fv & ~at_end
        anyf = fd | fv | fh
        n_prev_i = jnp.where(fd, v[1], jnp.where(fv, v[3], i))
        n_prev_j = jnp.where(fd | fh, j - 1, j)
        n_prev_i = jnp.where(anyf, n_prev_i, 0)
        n_prev_j = jnp.where(anyf, n_prev_j, 0)
        n_oi = jnp.where(i == n_prev_i, -1, i - 1)
        n_oj = jnp.where(j == n_prev_j, -1, j - 1)
        n_mode = jnp.where(fv & (v[4] == 1), MODE_EU,
                           jnp.where(fh & (v[6] == 1), MODE_EL, MODE_NORMAL))

        # --- extend-left step (el_body) ---
        el_more = v[7] == 0  # stop bit at (i, j-1)
        # --- extend-up step (eu_body) ---
        eu_prev = jnp.where(v[8] == 1, v[9], jnp.where(v[10] == 1, v[11], 0))
        eu_more = (v[8] == 1) & (eu_prev != 0)

        is_n = mode == MODE_NORMAL
        is_el = mode == MODE_EL
        oi = jnp.where(is_n, n_oi, jnp.where(is_el, -1, i - 1))
        oj = jnp.where(is_n, n_oj, jnp.where(is_el, j - 1, -1))
        i2 = jnp.where(is_n, n_prev_i, jnp.where(is_el, i, eu_prev))
        j2 = jnp.where(is_n, n_prev_j, jnp.where(is_el, j - 1, j))
        mode2 = jnp.where(
            is_n, n_mode,
            jnp.where(is_el,
                      jnp.where(el_more, MODE_EL, MODE_NORMAL),
                      jnp.where(eu_more, MODE_EU, MODE_NORMAL)))

        emit = ~done & ~(is_n & at_end)
        done2 = done | (is_n & at_end)
        oi = jnp.where(emit, oi, -2)
        oj = jnp.where(emit, oj, -2)
        i3 = jnp.where(done2, i, i2)
        j3 = jnp.where(done2, j, j2)
        mode3 = jnp.where(done2, mode, mode2)
        return (i3, j3, mode3, done2), (oi, oj, emit)

    st0 = (max_i, jnp.int32(max_j), jnp.int32(MODE_NORMAL), start_done)
    _, (aln_i, aln_j, emits) = jax.lax.scan(
        tb_step, st0, None, length=a_cap)
    cnt = jnp.sum(emits.astype(jnp.int32))
    return aln_i, aln_j, cnt


def align_batch(graphs, seqs, params=(2, -4, -6, -2, -25, -1), n_cap=None, p_cap=16,
                w_cap=None, a_cap=None, align_type: str = "nw"):
    """Host entry: align seqs[k] against graphs[k] for every window k.

    graphs: list of PoaGraph; seqs: list of str (codes via ACGT->0..3).
    align_type selects the spoa AlignmentType ("nw" — the benchmark
    driver's hardcoded choice, msa_spoa_omp.cpp:264 — "sw" or "ov").
    Returns list of spoa Alignment lists [(node_id, seq_pos)].
    """
    from .oracle.poa import convex_align

    code_map = {ch: i for i, ch in enumerate("ACGT")}
    b = len(graphs)

    def _nn(g):
        return g.n_nodes() if isinstance(g, NativePoaGraph) else len(g.nodes)

    if n_cap is None:
        n_cap = max(8, int(2 ** np.ceil(np.log2(max(_nn(g) for g in graphs) + 1))))
    if w_cap is None:
        w_cap = max(8, int(2 ** np.ceil(np.log2(max(len(s) for s in seqs) + 2))))
    if a_cap is None:
        a_cap = n_cap + w_cap + 4

    garrs = []
    fallback = [False] * b
    ranks = [None] * b
    for gi, g in enumerate(graphs):
        # device codes are global ACGT codes, not the per-graph coder
        if isinstance(g, NativePoaGraph):
            arr, ranks[gi] = g.arrays(n_cap, p_cap, code_map)
            if arr is None or _nn(g) == 0:
                fallback[gi] = True
                arr = graph_to_arrays(_EMPTY_GARR_GRAPH, n_cap, p_cap)
        else:
            arr = graph_to_arrays(g, n_cap, p_cap, code_map=code_map)
            if arr is None or not g.nodes:
                fallback[gi] = True
                arr = graph_to_arrays(_EMPTY_GARR_GRAPH, n_cap, p_cap)
        garrs.append(arr)

    garr_stack = {
        k: jnp.asarray(np.stack([a[k] for a in garrs])) for k in garrs[0]
    }
    seq_arr = np.zeros((b, w_cap - 1), np.int32)
    seq_len = np.zeros(b, np.int32)
    for i, s in enumerate(seqs):
        codes = [code_map.get(ch, 9) for ch in s]
        seq_arr[i, : len(codes)] = codes
        seq_len[i] = len(codes)

    # ring eligibility: every non-virtual predecessor within RING_D ranks
    # (true for realistic MSA windows; pathological graphs take the
    # full-matrix path)
    ring_d = RING_D
    for a in garrs:
        n = int(a["n_nodes"])
        if n == 0:
            continue
        pr = a["preds"][:n]
        m_sl = (np.arange(pr.shape[1])[None, :]
                < np.maximum(a["npreds"][:n], 1)[:, None]) & (pr >= 1)
        if m_sl.any():
            d = int((np.arange(1, n + 1)[:, None] - pr)[m_sl].max())
            if d > RING_D:
                ring_d = 0
                break
    fn = _batched_align(tuple(params), w_cap, a_cap, align_type, ring_d)
    # HBM budget: the fill emits [NPLANES~13, n_cap+1, w_cap] i32
    # traceback planes per window (plus the 3-matrix HFO state), so
    # reference-shaped windows (~1 kb seqs, ~2k nodes) cost ~70 MB each
    # and a big batch must run in sub-batches (the whole-batch call
    # needs 34 GB at 64 windows)
    per_win = (n_cap + 1) * w_cap * 4 * 17
    max_b = max(1, int(2_000_000_000 // max(per_win, 1)))
    if b <= max_b:
        packed = np.asarray(
            fn(jnp.asarray(seq_arr), jnp.asarray(seq_len), garr_stack))
    else:
        chunks = []
        for lo in range(0, b, max_b):
            hi = min(lo + max_b, b)
            pad = max_b - (hi - lo)

            def cut(a):
                sl = a[lo:hi]
                if pad:  # replicate row 0: keeps ONE compiled shape
                    sl = np.concatenate(
                        [sl, np.repeat(np.asarray(sl[:1]), pad, axis=0)])
                return jnp.asarray(sl)

            out = np.asarray(fn(cut(seq_arr), cut(seq_len),
                                {k: cut(np.asarray(v))
                                 for k, v in garr_stack.items()}))
            chunks.append(out[: hi - lo])
        packed = np.concatenate(chunks, axis=0)
    ai, aj, cnt = packed[:, :a_cap], packed[:, a_cap:-1], packed[:, -1]

    out = []
    for gi, g in enumerate(graphs):
        if fallback[gi] or _nn(g) == 0:
            gpy = g.to_python() if isinstance(g, NativePoaGraph) else g
            out.append(convex_align(seqs[gi], gpy, align_type=align_type))
            continue
        n = int(cnt[gi])
        rk = ai[gi, :n][::-1]
        cols = aj[gi, :n][::-1]
        r2n = (ranks[gi] if ranks[gi] is not None else g.rank_to_node_id)
        node_ids = np.asarray(r2n, np.int64)
        ids = np.where(rk < 0, -1, node_ids[np.maximum(rk, 0)])
        out.append(list(zip(ids.tolist(), cols.tolist())))
    return out


def msa_consensus_host(batches, params=(2, -4, -6, -2, -25, -1),
                       timings: dict | None = None):
    """Host dual-engine consensus: the full per-window loop (convex-NW
    align + add_alignment + heaviest-bundle consensus) runs in C++
    (native/poaalign.cpp gt_poa_msa_window) — the fmi/kmer dual-engine
    precedent.  Identical consensus to msa_consensus_batch / the oracle
    (tests assert it); returns None when the native lib isn't built.

    The device path's fill is latency-bound at reference window shapes
    (~750 bp x ~1k nodes); graph DP at these sizes is cache-resident CPU
    work, so the host engine is the production default in cli/poa.py.
    """
    import ctypes

    from ..io.native import _load

    lib = _load()
    if not lib:
        return None
    NativePoaGraph._bind(lib)
    phases = np.zeros(3, np.float64)
    out = []
    for batch in batches:
        if not batch:
            out.append("")
            continue
        blob = "".join(batch).encode()
        lens = np.array([len(s) for s in batch], np.int32)
        offs = np.zeros(len(batch), np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        cap = int(lens.sum()) + 8
        cons = ctypes.create_string_buffer(cap)
        n = lib.gt_poa_msa_window(
            blob, offs.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p), len(batch), *params,
            cons, cap, phases.ctypes.data_as(ctypes.c_void_p))
        if n < 0:
            raise RuntimeError("consensus longer than total input bases")
        out.append(cons.raw[:n].decode())
    if timings is not None:
        timings.update(align=float(phases[0]), add=float(phases[1]),
                       consensus=float(phases[2]))
    return out


class _EmptyGraph:
    nodes = []
    rank_to_node_id = []
    edges = []


_EMPTY_GARR_GRAPH = _EmptyGraph()


def msa_consensus_batch(batches, params=(2, -4, -6, -2, -25, -1),
                        timings: dict | None = None,
                        use_native: bool | None = None):
    """Consensus for many windows, sequences aligned in device lock-step.

    timings (optional dict) receives the reference driver's phase times
    (msa_spoa_omp.cpp:328: align / addToGraph / generateConsensus).
    The graph mutation/consensus runs in C++ when the native lib is
    built (NativePoaGraph, identical results)."""
    import time as _time

    from .oracle.poa import PoaGraph

    if use_native is None:
        from ..io.native import available

        use_native = available()
    t_align = t_add = t_cons = 0.0
    graphs = [(NativePoaGraph() if use_native else PoaGraph())
              for _ in batches]
    max_rounds = max(len(b) for b in batches)
    for k in range(max_rounds):
        idxs = [i for i, b in enumerate(batches) if k < len(b)]
        sub_graphs = [graphs[i] for i in idxs]
        sub_seqs = [batches[i][k] for i in idxs]
        t0 = _time.perf_counter()
        alns = align_batch(sub_graphs, sub_seqs, params)
        t_align += _time.perf_counter() - t0
        t0 = _time.perf_counter()
        for i, aln in zip(idxs, alns):
            graphs[i].add_alignment(aln, batches[i][k])
        t_add += _time.perf_counter() - t0
    t0 = _time.perf_counter()
    out = [g.generate_consensus() for g in graphs]
    t_cons += _time.perf_counter() - t0
    if timings is not None:
        timings.update(align=t_align, add=t_add, consensus=t_cons)
    return out


class NativePoaGraph:
    """C++ spoa graph (native/poagraph.cpp; contract = oracle PoaGraph —
    tests assert identical alignments and consensus across full runs).

    Drop-in for the consensus loop: add_alignment / generate_consensus /
    rank-space array export for the device aligner.  `to_python()`
    rebuilds the spec graph for the rare p_cap-overflow fallback."""

    def __init__(self):
        from ..io.native import _load

        lib = _load()
        if not lib:
            raise RuntimeError("native lib not built")
        self._bind(lib)
        self.lib = lib
        self.h = lib.gt_poa_new()

    @staticmethod
    def _bind(lib):
        import ctypes

        if getattr(lib, "_poa_ready", False):
            return
        lib.gt_poa_new.restype = ctypes.c_void_p
        lib.gt_poa_free.argtypes = [ctypes.c_void_p]
        lib.gt_poa_add_alignment.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        lib.gt_poa_n_nodes.restype = ctypes.c_int64
        lib.gt_poa_n_nodes.argtypes = [ctypes.c_void_p]
        lib.gt_poa_n_edges.restype = ctypes.c_int64
        lib.gt_poa_n_edges.argtypes = [ctypes.c_void_p]
        lib.gt_poa_consensus.restype = ctypes.c_int64
        lib.gt_poa_consensus.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.gt_poa_arrays.restype = ctypes.c_int32
        lib.gt_poa_arrays.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
            + [ctypes.c_void_p] * 6)
        lib.gt_poa_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
        lib.gt_poa_align.restype = ctypes.c_int64
        lib.gt_poa_align.argtypes = (
            [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
            + [ctypes.c_int32] * 7 + [ctypes.c_void_p] * 2
            + [ctypes.c_int64])
        lib.gt_poa_msa_window.restype = ctypes.c_int64
        lib.gt_poa_msa_window.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64]
            + [ctypes.c_int32] * 6
            + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
        lib._poa_ready = True

    def align(self, sequence: str, params=(2, -4, -6, -2, -25, -1),
              align_type: str = "nw"):
        """Native convex alignment against this graph (poaalign.cpp;
        contract = oracle convex_align — identical alignments)."""
        import ctypes

        atype = {"nw": 0, "sw": 1, "ov": 2}[align_type]
        cap = self.n_nodes() + len(sequence) + 8
        nid = np.empty(cap, np.int32)
        pos = np.empty(cap, np.int32)
        while True:
            cnt = self.lib.gt_poa_align(
                self.h, sequence.encode(), len(sequence), *params, atype,
                nid.ctypes.data_as(ctypes.c_void_p),
                pos.ctypes.data_as(ctypes.c_void_p), cap)
            if cnt >= 0:
                break
            cap *= 2
            nid = np.empty(cap, np.int32)
            pos = np.empty(cap, np.int32)
        return list(zip(nid[:cnt].tolist(), pos[:cnt].tolist()))

    def __del__(self):
        if getattr(self, "h", None):
            self.lib.gt_poa_free(self.h)
            self.h = None

    def n_nodes(self) -> int:
        return int(self.lib.gt_poa_n_nodes(self.h))

    def add_alignment(self, alignment, sequence: str, weights=None):
        import ctypes

        assert weights is None, "native graph supports unit weights only"
        nid = np.array([a for a, _ in alignment], np.int32)
        pos = np.array([b for _, b in alignment], np.int32)
        self.lib.gt_poa_add_alignment(
            self.h, nid.ctypes.data_as(ctypes.c_void_p),
            pos.ctypes.data_as(ctypes.c_void_p), len(alignment),
            sequence.encode(), len(sequence))

    def generate_consensus(self) -> str:
        import ctypes

        cap = self.n_nodes() + 1
        buf = ctypes.create_string_buffer(cap)
        n = self.lib.gt_poa_consensus(self.h, buf, cap)
        if n < 0:
            raise RuntimeError("consensus overflow")
        return buf.raw[:n].decode()

    def arrays(self, n_cap: int, p_cap: int, code_map):
        """graph_to_arrays equivalent: (garr dict, rank_to_node_id) or
        (None, None) on cap overflow."""
        import ctypes

        code_char = np.zeros(n_cap, np.uint8)
        preds = np.zeros((n_cap, p_cap), np.int32)
        npreds = np.zeros(n_cap, np.int32)
        out_empty = np.zeros(n_cap, np.uint8)
        rank = np.zeros(n_cap, np.int32)
        n_out = np.zeros(1, np.int64)

        def p(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        rc = self.lib.gt_poa_arrays(self.h, n_cap, p_cap, p(code_char),
                                    p(preds), p(npreds), p(out_empty),
                                    p(rank), p(n_out))
        if rc != 0:
            return None, None
        n = int(n_out[0])
        glob = np.full(256, 9, np.int64)
        for ch, v in code_map.items():
            glob[ord(ch)] = v
        code = np.zeros(n_cap, np.int32)
        code[:n] = glob[code_char[:n]]
        garr = {"code": code, "preds": preds, "npreds": npreds,
                "out_empty": out_empty.astype(bool),
                "n_nodes": np.int32(n)}
        return garr, rank[:n].tolist()

    def to_python(self):
        """Rebuild the oracle PoaGraph (for the p_cap-overflow fallback
        aligner; aligned-node groups are not needed by the aligner)."""
        import ctypes

        from .oracle.poa import PoaGraph

        n = self.n_nodes()
        ne = int(self.lib.gt_poa_n_edges(self.h))
        node_char = np.zeros(max(n, 1), np.uint8)
        eb = np.zeros(max(ne, 1), np.int32)
        ee = np.zeros(max(ne, 1), np.int32)
        ew = np.zeros(max(ne, 1), np.int64)
        rank = np.zeros(max(n, 1), np.int32)

        def p(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        self.lib.gt_poa_export(self.h, p(node_char), p(eb), p(ee), p(ew),
                               p(rank))
        g = PoaGraph()
        for i in range(n):
            ch = chr(node_char[i])
            if ch not in g.coder:
                g.coder[ch] = len(g.decoder)
                g.decoder.append(ch)
            g.add_node(g.coder[ch])
        for e in range(ne):
            g.add_edge(int(eb[e]), int(ee[e]), int(ew[e]))
        g.rank_to_node_id = rank[:n].tolist()
        return g
