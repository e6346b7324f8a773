"""Multi-device kmer split at scale on the virtual CPU mesh.

count_kmers_sharded (parallel/dp.py) had only ever run on 64-base toy
reads via dryrun_multichip — never at a size that exercises bucket skew
or the per-shard sort-reduce.  This drives it at >=100 Mbp (the
KMER_SCALE coverage regime: 10 kb reads over one genome, k=17) on the
8-device virtual CPU mesh, asserts metrics parity against the native
host engine on the same reads, and records per-shard occupancy (the
key-range all_to_all's skew signal) in KMER_SHARDED.json.

Match: benchmarks/kmer-cnt/vertex_index.cpp:515-659 (atomic shared
counter -> per-shard disjoint key ranges + psum here).

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
    python tools/kmer_sharded_bench.py            # 100 Mbp, 8 devices
  python tools/kmer_sharded_bench.py --smoke
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=100.0)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--genome-mbp", type=float, default=2.5)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="KMER_SHARDED.json")
    args = ap.parse_args(argv)

    from chain_scale_bench import force_cpu_backend
    force_cpu_backend(args.devices)

    if args.smoke:
        args.mbp, args.genome_mbp = 0.4, 0.05

    import jax

    from genomicsbench_palisade_tpu.ops import kmer as K
    from genomicsbench_palisade_tpu.ops.kmer import count_kmers_host
    from genomicsbench_palisade_tpu.parallel.dp import count_kmers_sharded
    from genomicsbench_palisade_tpu.parallel.mesh import make_mesh
    from kmer_scale_bench import synth_reads

    rng = np.random.default_rng(20260826)
    total = int(args.mbp * 1e6)
    read_len = 10_000 if not args.smoke else 6_000
    genome = rng.integers(0, 4, int(args.genome_mbp * 1e6)).astype(np.uint8)
    n_reads = total // read_len
    starts = rng.integers(0, len(genome) - read_len, n_reads)
    reads = []
    for s in starts:
        r = genome[s:s + read_len].copy()
        mut = rng.random(read_len) < 0.01
        r[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append(r)
    print(f"[gen] {n_reads} reads x {read_len} bp = {total/1e6:.0f} Mbp",
          file=sys.stderr)

    mesh = make_mesh()
    ndev = mesh.devices.size
    # pad read count to a mesh multiple
    bases, lengths = K.pad_codes_np(reads)
    pad_rows = (-len(reads)) % ndev
    if pad_rows:
        bases = np.concatenate(
            [bases, np.zeros((pad_rows, bases.shape[1]), bases.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad_rows, np.int32)])

    t0 = time.perf_counter()
    metrics, shard = count_kmers_sharded(
        mesh, np.asarray(bases, np.int32), lengths,
        return_shard_stats=True)
    metrics = {k_: int(v) for k_, v in metrics.items()}
    shard_occ = np.asarray(shard["occ"]).tolist()
    shard_distinct = np.asarray(shard["distinct"]).tolist()
    sharded_s = time.perf_counter() - t0
    print(f"[sharded] {sharded_s:.1f} s on {ndev} devices: {metrics}",
          file=sys.stderr)
    print(f"[shards] occ={shard_occ}", file=sys.stderr)

    t0 = time.perf_counter()
    want = count_kmers_host(reads, min_read_length=min(5000, read_len - 1))
    host_s = time.perf_counter() - t0
    if want is None:  # native lib absent: one-shot device engine
        want = K.count_kmers(reads, min_read_length=min(5000, read_len - 1))
    equal = want == metrics
    print(f"[host] {host_s:.1f} s: {want}  equal={equal}", file=sys.stderr)
    assert equal, (metrics, want)

    occ_arr = np.asarray(shard_occ, np.float64)
    res = {
        "tool": "kmer_sharded_bench",
        "devices": int(ndev),
        "bases": int(total),
        "reads": int(n_reads),
        "k": 17,
        "metrics": metrics,
        "metrics_equal": bool(equal),
        "per_shard_occupancy": shard_occ,
        "per_shard_distinct": shard_distinct,
        "occupancy_imbalance": round(float(occ_arr.max()
                                           / max(occ_arr.mean(), 1)), 4),
        "sharded_s": round(sharded_s, 1),
        "host_engine_s": round(host_s, 1),
        "backend": jax.default_backend(),
        "smoke": bool(args.smoke),
    }
    print(json.dumps(res))
    if not args.smoke:
        p = pathlib.Path(args.out)
        hist = json.loads(p.read_text()) if p.exists() else []
        hist.append(res)
        p.write_text(json.dumps(hist, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
