"""Dataset-scale kmer-cnt rehearsal: >=1 GB of >=5 kb reads.

The reference's kmer-cnt operates on GB-scale read sets behind the
minLen filter (benchmarks/kmer-cnt/sequence_container.cpp minimumLength
/ kmer_cnt.cpp:220-231); tools/bench_all.py counts 512 x 5.5 kb reads —
three orders of magnitude smaller.  This
synthesizes coverage-style reads off one genome (so the distinct-kmer
set and the saturation tail behave like real data), streams them
through count_kmers_batched on device, and records Mbases/s in
KMER_SCALE.json.

Parity: a read subset is counted with BOTH count_kmers_batched and the
one-shot count_kmers pipeline (itself pinned to the reference binary's
Total k-mers / Hash size in tests/test_kmer_golden.py) — metrics must
match exactly.

Usage:
  python tools/kmer_scale_bench.py                   # 1.06 Gbp
  python tools/kmer_scale_bench.py --gbp 0.25
  python tools/kmer_scale_bench.py --smoke
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def synth_reads(rng, total_bases, read_len=10_000, genome_mbp=25,
                err=0.001):
    genome = rng.integers(0, 4, genome_mbp * 1_000_000).astype(np.uint8)
    n_reads = total_bases // read_len
    reads = []
    starts = rng.integers(0, len(genome) - read_len, n_reads)
    for s in starts:
        r = genome[s : s + read_len].copy()
        mut = rng.random(read_len) < err
        r[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append(r)
    return reads


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbp", type=float, default=1.06)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--genome-mbp", type=int, default=25)
    ap.add_argument("--parity-reads", type=int, default=512)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--host-only", action="store_true",
                    help="skip the device accumulator (chip-free runs; "
                    "device metrics copied from the host for the "
                    "artifact's equality field is NOT claimed)")
    ap.add_argument("--out", default="KMER_SCALE.json")
    args = ap.parse_args(argv)

    if args.smoke:
        from chain_scale_bench import force_cpu_backend
        force_cpu_backend()
        args.gbp, args.genome_mbp = 0.002, 1
        args.parity_reads = 64
    from genomicsbench_palisade_tpu.utils.compile_cache import enable
    enable()

    rng = np.random.default_rng(29)
    total = int(args.gbp * 1e9)
    t0 = time.perf_counter()
    reads = synth_reads(rng, total, args.read_len, args.genome_mbp)
    gen_s = time.perf_counter() - t0
    real_bases = sum(len(r) for r in reads)
    print(f"[gen] {len(reads):,} reads / {real_bases / 1e9:.2f} Gbp "
          f"in {gen_s:.0f} s", file=sys.stderr)

    from genomicsbench_palisade_tpu.ops import kmer as K

    cap = 1 << 21 if args.smoke else 1 << 26
    # host hash engine (the dataset-scale default; fmi-style dual-engine
    # split — the device merge is sort-rate-bound)
    t0 = time.perf_counter()
    host_metrics = K.count_kmers_host(reads)
    host_s = time.perf_counter() - t0 if host_metrics is not None else None
    if host_metrics is not None:
        print(f"[host] {host_metrics} in {host_s:.1f} s", file=sys.stderr)
    if args.host_only:
        metrics, kernel_s = host_metrics, None
    else:
        t0 = time.perf_counter()
        metrics = K.count_kmers_batched(reads, cap=cap)
        kernel_s = time.perf_counter() - t0
        print(f"[device] {metrics} in {kernel_s:.1f} s", file=sys.stderr)
        if host_metrics is not None:
            assert host_metrics == metrics, (host_metrics, metrics)

    # parity subset: batched vs the golden-pinned one-shot pipeline
    if args.host_only:
        # host-only run: keep the subset check off the accelerator
        from chain_scale_bench import force_cpu_backend
        force_cpu_backend()
    sub = reads[: args.parity_reads]
    want = K.count_kmers(sub)
    got = K.count_kmers_batched(
        sub, batch_bases=max(len(sub) * args.read_len // 4, 100_000),
        cap=cap)
    assert got == want, (got, want)
    print(f"[parity] batched == one-shot on {len(sub)} reads "
          f"({want['total_kmers']:,} distinct)", file=sys.stderr)

    out = {
        "tool": "kmer_scale_bench",
        "reads": len(reads),
        "gbp": round(real_bases / 1e9, 3),
        "read_len": args.read_len,
        "genome_mbp": args.genome_mbp,
        "distinct_kmers": metrics["total_kmers"],
        "hash_size": metrics["hash_size"],
        "device_s": round(kernel_s, 1) if kernel_s else None,
        "device_mbases_per_s": (round(real_bases / kernel_s / 1e6, 1)
                                if kernel_s else None),
        "host_s": round(host_s, 1) if host_s else None,
        "host_mbases_per_s": (round(real_bases / host_s / 1e6, 1)
                              if host_s else None),
        "host_device_metrics_equal": (
            host_metrics == metrics
            if host_metrics is not None and kernel_s else None),
        "host_only": bool(args.host_only),
        "parity_reads": len(sub),
        "smoke": bool(args.smoke),
    }
    print(json.dumps(out))
    if not args.smoke:
        p = pathlib.Path(args.out)
        hist = json.loads(p.read_text()) if p.exists() else []
        hist.append(out)
        p.write_text(json.dumps(hist, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
