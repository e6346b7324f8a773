"""bsw driver: `python -m genomicsbench_palisade_tpu.cli.bsw -pairs <file>`.

Mirrors the reference driver (benchmarks/bsw/main_banded.cpp:673-960):
reads 3-line pair records, scores every pair with the banded SW extension
kernel, and prints the per-pair results plus total pairs and kernel time.
Work is bucketed by padded (tlen, qlen) shape and batch-parallel on device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..io.pairs import parse_pairs_soa
from ..ops import bsw as B
from ..ops.oracle.bsw import DEFAULT_PARAMS, BswParams


DEV_BATCH = 65536  # pairs per device dispatch: bounds the [B, Q] i32
#  scan state in device memory — a whole dataset-scale bucket at once
#  (10.6M pairs, scripts/bsw_large:8) would need tens of GB


OUT_FIELDS = B.OUT_ORDER


def _gather_flat(codes, off, ln):
    """codes[off[i] : off[i]+ln[i]] for all i, concatenated (vectorized)."""
    total = int(ln.sum())
    if total == 0:
        return np.empty(0, codes.dtype)
    ln64 = ln.astype(np.int64)
    row_start = np.concatenate(([0], np.cumsum(ln64[:-1])))
    within = np.arange(total, dtype=np.int64) - np.repeat(row_start, ln64)
    return codes[np.repeat(off, ln64) + within]


def score_pairs_soa(soa, params: BswParams = DEFAULT_PARAMS,
                    edges=(32, 64, 128, 256, 512),
                    dev_batch: int = DEV_BATCH):
    """Bucketed scoring over a parse_pairs_soa dict; returns a dict of
    [n_pairs] int32 arrays (OUT_FIELDS) in input order.

    Dataset-scale layout (the reference's bsw_large is 10.6M pairs,
    scripts/bsw_large:5-8): struct-of-arrays end to end — per-pair
    Python objects cost more than the kernel at this scale — with
    vectorized bucketing (searchsorted + stable argsort), native C++
    chunk prep (native/pairsio.cpp gt_bsw_pack_rows: flat-gather + pad +
    2-bit wire pack in one pass), all chunks DISPATCHED before any output
    fetch (transfers and device work overlap), and one stacked —
    int16-narrowed when the score bound allows — output fetch per chunk."""
    from ..io.native import bsw_pack_rows_native, bsw_pad_rows_native

    codes = soa["codes"]
    q_len, t_len = soa["q_len"], soa["t_len"]
    q_off, t_off = soa["q_off"], soa["t_off"]
    h0_all = soa["h0"]
    n_all = len(q_len)
    results = {k: np.zeros(n_all, np.int32) for k in OUT_FIELDS}
    ptuple = B._params_tuple(params)

    e = np.asarray(edges, np.int64)
    qb = np.searchsorted(e, q_len)
    tb = np.searchsorted(e, t_len)
    if n_all and (int(qb.max()) >= len(e) or int(tb.max()) >= len(e)):
        bad = max(int(q_len.max(initial=0)), int(t_len.max(initial=0)))
        raise ValueError(f"length {bad} exceeds the largest bucket {edges[-1]}")
    # int16 output narrowing: every output field is bounded by
    # max|h0| + qlen*match (score/gscore; ksw_extend scores only ever add
    # `match` per step from h0) or by the pad lengths (qle/tle/gtle/
    # max_off), so when the bound fits, fetch bytes halve
    narrow = bool(
        n_all == 0
        or (int(np.abs(h0_all).max()) + int(e[-1]) * params.match + 64
            < 32767) and int(e[-1]) < 32767)
    key = qb * len(e) + tb
    order = np.argsort(key, kind="stable")
    bounds = np.flatnonzero(np.diff(key[order])) + 1
    pending = []  # (idx array, n valid, device [6, chunk] stack)
    for grp in np.split(order, bounds):
        q_pad = int(e[qb[grp[0]]])
        t_pad = int(e[tb[grp[0]]])
        n = len(grp)
        ql, tl, h0 = q_len[grp], t_len[grp], h0_all[grp]
        # large buckets run as fixed-size chunks (every chunk padded to
        # the same shape -> one compile per bucket)
        chunk = min(dev_batch, -(-n // 128) * 128)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            m = hi - lo
            # pad the LENGTH arrays to the chunk (rows past m get len 0,
            # which both native row builders turn into all-padding rows)
            ql_p = np.pad(ql[lo:hi], (0, chunk - m))
            tl_p = np.pad(tl[lo:hi], (0, chunk - m))
            qo_p = np.pad(q_off[grp[lo:hi]], (0, chunk - m))
            to_p = np.pad(t_off[grp[lo:hi]], (0, chunk - m))
            lens = {"qlen": ql_p, "tlen": tl_p,
                    "h0": np.pad(h0[lo:hi], (0, chunk - m))}
            batch, packed = None, False
            if q_pad % 4 == 0 and t_pad % 4 == 0:
                nat_q = bsw_pack_rows_native(codes, qo_p, ql_p, q_pad)
                if nat_q is not None:
                    qpack, bad_q = nat_q
                    tpack, bad_t = bsw_pack_rows_native(codes, to_p, tl_p,
                                                        t_pad)
                    if bad_q == 0 and bad_t == 0:
                        batch = {"qpack": qpack, "tpack": tpack, **lens}
                        packed = True
                else:
                    # numpy fallback (native lib not built): mask-scatter
                    # rows then 2-bit pack, with a plain-base check
                    qm = np.arange(q_pad)[None, :] < ql_p[:, None]
                    tm = np.arange(t_pad)[None, :] < tl_p[:, None]
                    flat_q = _gather_flat(codes, qo_p, ql_p)
                    flat_t = _gather_flat(codes, to_p, tl_p)
                    ok = ((flat_q.size == 0 or
                           (flat_q.min() >= 0 and flat_q.max() <= 3))
                          and (flat_t.size == 0 or
                               (flat_t.min() >= 0 and flat_t.max() <= 3)))
                    if ok:
                        query = np.zeros((chunk, q_pad), np.uint8)
                        target = np.zeros((chunk, t_pad), np.uint8)
                        query[qm] = flat_q
                        target[tm] = flat_t
                        batch = {"qpack": B.pack_codes_2bit(query),
                                 "tpack": B.pack_codes_2bit(target), **lens}
                        packed = True
            if packed:
                out = B.bsw_batch_stacked(batch, q_pad, t_pad, ptuple,
                                          narrow=narrow)
            else:
                query = bsw_pad_rows_native(codes, qo_p, ql_p, q_pad)
                if query is not None:
                    target = bsw_pad_rows_native(codes, to_p, tl_p, t_pad)
                else:
                    qm = np.arange(q_pad)[None, :] < ql_p[:, None]
                    tm = np.arange(t_pad)[None, :] < tl_p[:, None]
                    query = np.full((chunk, q_pad), 4, np.int8)
                    target = np.full((chunk, t_pad), 4, np.int8)
                    query[qm] = _gather_flat(codes, qo_p, ql_p)
                    target[tm] = _gather_flat(codes, to_p, tl_p)
                batch = {"query": query, "target": target, **lens}
                out = B.bsw_batch_stacked(batch, params=ptuple,
                                          narrow=narrow)
            pending.append((grp[lo:hi], m, out))
    for idx, m, dev in pending:
        fetched = np.asarray(dev)
        for row, k in enumerate(OUT_FIELDS):
            results[k][idx] = fetched[row, :m]
    return results


def score_pairs(pairs, params: BswParams = DEFAULT_PARAMS,
                edges=(32, 64, 128, 256, 512), dev_batch: int = DEV_BATCH):
    """List-of-(q, t, h0) front end: converts to the SoA layout and
    delegates to score_pairs_soa (same outputs, input order)."""
    n = len(pairs)
    if n == 0:
        return {k: np.zeros(0, np.int32) for k in OUT_FIELDS}
    q_len = np.fromiter((len(q) for q, _, _ in pairs), np.int32, n)
    t_len = np.fromiter((len(t) for _, t, _ in pairs), np.int32, n)
    h0 = np.fromiter((h for _, _, h in pairs), np.int32, n)
    codes = np.concatenate(
        [np.asarray(a, np.int8) for q, t, _ in pairs for a in (q, t)])
    sizes = np.empty(2 * n, np.int64)
    sizes[0::2] = q_len
    sizes[1::2] = t_len
    offs = np.concatenate(([0], np.cumsum(sizes[:-1])))
    soa = {"codes": codes, "q_off": offs[0::2], "q_len": q_len,
           "t_off": offs[1::2], "t_len": t_len, "h0": h0}
    return score_pairs_soa(soa, params, edges, dev_batch)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bsw")
    ap.add_argument("-pairs", "--pairs", required=True, dest="pairs")
    ap.add_argument("-t", "--threads", type=int, default=1, help="ignored (device-parallel)")
    ap.add_argument("-b", "--batch", type=int, default=512, help="accepted for CLI parity")
    ap.add_argument("-m", "--match", type=int, default=1)
    ap.add_argument("-x", "--mismatch", type=int, default=4)
    ap.add_argument("-o", "--open", type=int, default=6, dest="gapo")
    ap.add_argument("-e", "--extend", type=int, default=1, dest="gape")
    ap.add_argument("--print-output", action="store_true")
    args = ap.parse_args(argv)

    from ..utils.compile_cache import enable as _enable_cache
    _enable_cache()

    params = BswParams(
        o_del=args.gapo,
        e_del=args.gape,
        o_ins=args.gapo,
        e_ins=args.gape,
        match=args.match,
        mismatch=args.mismatch,
    )
    t0 = time.perf_counter()
    soa = parse_pairs_soa(args.pairs)
    read_time = time.perf_counter() - t0
    n_pairs = len(soa["h0"])
    print(f"Read time = {read_time:.4f}")
    print(f"Total Pairs read: {n_pairs}")

    t0 = time.perf_counter()
    results = score_pairs_soa(soa, params)
    kernel_time = time.perf_counter() - t0
    if args.print_output:
        cols = np.stack([results[k] for k in OUT_FIELDS], axis=1)
        sys.stdout.write("\n".join(
            " ".join(map(str, row)) for row in cols.tolist()) + "\n")
    print(f"Overall SW cycles(kernel time) = {kernel_time:.4f} sec")
    print(f"Total Pairs processed: {n_pairs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
