"""chain driver: `python -m genomicsbench_palisade_tpu.cli.chain -i <in> -o <out>`.

Mirrors the reference testbed driver (benchmarks/chain/src/main.cpp:41-137):
reads anchor-dump records, runs the chaining DP, writes per-anchor
score/parent pairs, prints "Time in kernel".  Calls are bucketed by
(padded n, window) shape; anchors inside a call are inherently sequential
(scores[i] depends on scores[j<i]) so parallelism comes from running
whole calls concurrently on the batch axis.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..io.chain_dump import parse_chain_dump, print_return
from ..ops import chain as C
from ..ops.oracle import chain as CO


def run_calls(calls):
    """Returns list of (scores, parents, peaks) in input order.

    Device-eligible calls are bucketed by (padded n, window, distances)
    and each bucket runs as one vmapped scan: the batch axis plays the
    reference's OpenMP loop over calls (host_kernel.cpp:484-487)."""
    results = [None] * len(calls)
    buckets = {}  # (n_pad, w, max_dist_x, max_dist_y, bw) -> [(idx, prep)]
    for i, call in enumerate(calls):
        if call.n == 0:
            z = np.zeros(0, np.int32)
            results[i] = (z, z.astype(np.int64), z)
            continue
        if call.n_segs != 1 or not np.all(call.x[1:] >= call.x[:-1]):
            # general-case fallback: exact oracle on host
            cc = CO.ChainCall(
                n=call.n, avg_qspan=call.avg_qspan, max_dist_x=call.max_dist_x,
                max_dist_y=call.max_dist_y, bw=call.bw, n_segs=call.n_segs,
                x=call.x, y=call.y,
            )
            res = CO.chain_dp(cc)
            results[i] = (res["scores"], res["parents"], res["peak_scores"])
            continue
        prep = C.prepare_call(
            call.x, call.y, call.avg_qspan, call.max_dist_x, call.max_dist_y, call.bw
        )
        key = (C.pad_anchor_bucket(prep["n"]), C.window_for(prep),
               prep["max_dist_x"], prep["max_dist_y"], prep["bw"])
        buckets.setdefault(key, []).append((i, prep))
    for (n_pad, w, *_), members in buckets.items():
        outs = C.chain_calls_batched([p for _, p in members], w=w, n_pad=n_pad)
        for (i, _), out in zip(members, outs):
            results[i] = out
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(prog="chain")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-t", "--threads", type=int, default=1, help="ignored")
    args = ap.parse_args(argv)

    from ..utils.compile_cache import enable as _enable_cache
    _enable_cache()

    calls = parse_chain_dump(args.input)
    t0 = time.perf_counter()
    results = run_calls(calls)
    dt = time.perf_counter() - t0
    if args.output:
        with open(args.output, "w") as f:
            for scores, parents, _ in results:
                print_return(f, scores, parents)
    print(f"Time in kernel: {dt:.2f} sec", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
