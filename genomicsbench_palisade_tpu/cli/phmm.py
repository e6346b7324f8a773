"""phmm driver: `python -m genomicsbench_palisade_tpu.cli.phmm -f <testfile>`.

Reproduces the reference driver's contract (benchmarks/phmm/
PairHMMUnitTest.cpp:650-775 + IntelPairHmmCSource.cpp:61-85): reads the
batch test file, computes the read x hap likelihood matrix per batch in
testcase order, prints per-testcase results and the kernel runtime.
Computation is bucketed by padded shape and data-parallel over all local
devices.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..io.bucketing import group_by_buckets
from ..io.phmm_batch import parse_testfile
from ..ops import phmm as P
from ..parallel.mesh import make_mesh, shard_batch


def run_testcases(reads, haps, pairs, mesh=None, edges=(64, 128, 256, 512)):
    """Compute likelihoods for an arbitrary testcase list, bucketed.

    Returns float64 array in input order.
    """
    results = np.zeros(len(pairs), dtype=np.float64)

    def size_of(pair):
        ri, hi = pair
        return (len(reads[ri]["bases"]) + 1, len(haps[hi]))

    groups = group_by_buckets(pairs, size_of, edges)
    for (r_pad, h_pad), members in groups.items():
        idxs = [i for i, _ in members]
        sub_pairs = [p for _, p in members]
        batch = P.prepare_batch(reads, haps, sub_pairs, r_pad=r_pad,
                                h_pad=h_pad)
        batch_np = {k: np.asarray(v) for k, v in batch.items()}
        if mesh is not None and mesh.devices.size > 1:
            sharded, n_orig = shard_batch(batch, mesh)
            # pad rows have haplen=0 -> discarded below
            log10, _res, fallback = map(np.asarray, P.phmm_forward(sharded))
            log10, fallback = log10[:n_orig], fallback[:n_orig]
        else:
            # production dispatch: the CUDA kernel on a GPU
            log10, _res, fallback = map(np.asarray,
                                        P.phmm_forward_auto(batch_np))
        out = log10.astype(np.float64)
        if fallback.any():
            # vectorized double recompute (IntelPairHmmCSource.cpp:75-78)
            from ..ops.phmm_f64 import phmm_fallback_log10

            vals, fidx = phmm_fallback_log10(batch_np, fallback)
            out[fidx] = vals
        results[np.array(idxs)] = out
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(prog="phmm")
    ap.add_argument("-f", "--testfile", required=True)
    ap.add_argument("-t", "--threads", type=int, default=1, help="ignored (device-parallel)")
    ap.add_argument("-l", "--loop", type=int, default=1)
    ap.add_argument("--quiet", action="store_true", help="suppress per-testcase lines")
    ap.add_argument("--trace-dir", default=None,
                    help="write a jax.profiler trace of the kernel region "
                         "(the VTune ITT ROI equivalent)")
    args = ap.parse_args(argv)

    from ..utils.compile_cache import enable as _enable_cache
    _enable_cache()

    batches = parse_testfile(args.testfile)
    mesh = make_mesh()

    from ..utils.profiling import roi

    # warmup compile outside the timed region (the reference times only the
    # kernel region, PairHMMUnitTest.cpp:560-594)
    runtime = 0.0
    with roi(trace_dir=args.trace_dir, name="phmm_kernel"):
        for batch in batches:
            t0 = time.perf_counter()
            res = run_testcases(batch.reads, batch.haps, batch.pairs, mesh)
            runtime += time.perf_counter() - t0
            if not args.quiet:
                for i, v in enumerate(res):
                    print(f"i: {i}; result_final: {v:f}")
    print(f"\nPairHMM completed. Kernel runtime: {runtime:.2f} sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
