"""A/B the host fmi occ layouts at genome scale.

Loads a cached genome-scale index ONCE, then times the native 3-phase
search per occ layout on the same reads:
  v1        64 B/block CP_OCC rows (the reference's own shape,
            tools/bwa-mem2/src/FMI_search.h:59-63)
  v2        32 B/block bit-plane rows + superblock counts
  v2+huge   v2 staged into an anonymous THP-backed mapping

All modes must produce identical SMEM dumps.  One JSON line per mode.

Usage: python tools/fmi_pack_ab.py --workdir /tmp/g3200 --reads 4096
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/g3200")
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--read-len", type=int, default=151)
    ap.add_argument("--min-seed-len", type=int, default=19)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--sweep", default="",
                    help="comma-separated interleave widths to sweep on "
                         "v2+huge after the three-mode A/B (GT_FMI_WIDTH)")
    args = ap.parse_args(argv)

    wd = pathlib.Path(args.workdir)
    from genomicsbench_palisade_tpu.index import fmi_index as FI
    from genomicsbench_palisade_tpu.io.native import fmi_search_native
    from tools.genome_scale_fmi import smem_key_set, synth_reads

    t0 = time.perf_counter()
    didx = FI.load_npz(str(wd / "big_index.npz"), idx_dtype=np.int64)
    print(f"[load] {time.perf_counter() - t0:.0f} s "
          f"(text {int(didx.ref_seq_len):,})", file=sys.stderr)

    enc = synth_reads(wd / "big_ref.fa", args.reads, args.read_len)
    rl = np.full(args.reads, args.read_len, np.int32)

    golden = None
    for mode, pack_mode, huge in (("v1", 64, "0"), ("v2", 32, "0"),
                                  ("v2+huge", 32, "1")):
        os.environ["GT_FMI_HUGE"] = huge
        # drop the previous mode's THP copy so modes don't stack RSS
        didx.__dict__.pop("_host_pack32_huge", None)
        t0 = time.perf_counter()
        fmi_search_native(didx, enc[:32], rl[:32],
                          min_seed_len=args.min_seed_len,
                          threads=args.threads, pack_mode=pack_mode)
        warm_s = time.perf_counter() - t0
        best = None
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            m, n1, n2, n3 = fmi_search_native(
                didx, enc, rl, min_seed_len=args.min_seed_len,
                threads=args.threads, pack_mode=pack_mode)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        key = smem_key_set(m)
        if golden is None:
            golden = key
        print(json.dumps({
            "mode": mode, "reads": args.reads, "threads": args.threads,
            "warm_s": round(warm_s, 1), "best_s": round(best, 3),
            "reads_per_s": round(args.reads / best, 1),
            "total_smems": int(n1 + n2 + n3),
            "dump_parity": key == golden,
        }), flush=True)

    for width in [int(v) for v in args.sweep.split(",") if v]:
        os.environ["GT_FMI_HUGE"] = "1"
        os.environ["GT_FMI_WIDTH"] = str(width)
        best = None
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            m, n1, n2, n3 = fmi_search_native(
                didx, enc, rl, min_seed_len=args.min_seed_len,
                threads=args.threads, pack_mode=32)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        print(json.dumps({
            "mode": f"v2+huge w={width}", "best_s": round(best, 3),
            "reads_per_s": round(args.reads / best, 1),
            "dump_parity": smem_key_set(m) == golden,
        }), flush=True)
    os.environ.pop("GT_FMI_WIDTH", None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
