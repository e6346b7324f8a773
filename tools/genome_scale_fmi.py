"""Genome-scale FM-index rehearsal.

Exercises the int64 / compressed-SA paths end-to-end at reference scale:

  1. synthesizes a 256 Mbp reference (or reuses --workdir artifacts),
  2. builds the production index (SA-IS, cp_occ checkpoints, compressed
     SA: every 8th entry, SA_COMPX=3) with index.builder pack_fasta +
     build_arrays — the same code path the fmi_build CLI uses,
  3. samples reads from the text (with errors) and runs BOTH engines —
     the native C++ host search and the device 3-phase pipeline — on the
     same reads,
  4. asserts the full SMEM dumps are identical (rid, m, n, k, s
     multisets) and prints one JSON line with reads/s per engine.

Usage:
  python tools/genome_scale_fmi.py --workdir /tmp/vfy --mbp 256 \
      --reads 2048 --read-len 151

The 256 Mbp build takes ~5 min and ~6 GB of disk; artifacts are cached
in --workdir (big_ref.fa / big_index.npz) and reused when present.

Reference scale notes: bwa-mem2 indexes hg38 (3.1 Gbp) with the same
int64 cp_occ layout (tools/bwa-mem2/src/FMI_search.cpp:358-588); --mbp
sets the build size to what the host's RAM allows.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def synth_reference(path: pathlib.Path, mbp: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    n = mbp * 1_000_000
    line = 80
    with open(path, "w") as f:
        f.write(">synth_chr1\n")
        chunk = 1 << 22
        for s in range(0, n, chunk):
            m = min(chunk, n - s)
            codes = rng.integers(0, 4, m, dtype=np.int8)
            arr = np.frombuffer(b"ACGT", np.uint8)[codes]
            rows = [arr[i : i + line].tobytes().decode()
                    for i in range(0, m, line)]
            f.write("\n".join(rows) + "\n")


def synth_reads(ref_fa: pathlib.Path, n_reads: int, read_len: int,
                seed: int = 11):
    """Sample reads from the reference with 1% substitutions."""
    from genomicsbench_palisade_tpu.index.builder import pack_fasta

    codes, _names, _lengths = pack_fasta(str(ref_fa))
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(codes) - read_len, n_reads)
    enc = np.stack([codes[s : s + read_len] for s in starts]).astype(np.int8)
    sub = rng.random(enc.shape) < 0.01
    enc[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.int8)
    return enc


def smem_key_set(allm):
    return sorted(zip(allm["rid"].tolist(), allm["m"].tolist(),
                      allm["n"].tolist(), allm["k"].tolist(),
                      allm["l"].tolist(), allm["s"].tolist()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/vfy")
    ap.add_argument("--mbp", type=int, default=256)
    ap.add_argument("--reads", type=int, default=2048)
    ap.add_argument("--read-len", type=int, default=151)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--min-seed-len", type=int, default=19)
    ap.add_argument("--host-only", action="store_true",
                    help="skip the device pipeline; "
                         "prints host reads/s + totals only")
    args = ap.parse_args(argv)

    from genomicsbench_palisade_tpu.utils.compile_cache import enable
    enable()

    wd = pathlib.Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)
    ref = wd / "big_ref.fa"
    idx_npz = wd / "big_index.npz"

    if not ref.exists():
        t0 = time.perf_counter()
        synth_reference(ref, args.mbp)
        print(f"[synth] {args.mbp} Mbp reference in "
              f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)

    from genomicsbench_palisade_tpu.index import fmi_index as FI

    if not idx_npz.exists():
        from genomicsbench_palisade_tpu.index.builder import (
            build_arrays, pack_fasta, save_npz_full)

        t0 = time.perf_counter()
        codes, names, lengths = pack_fasta(str(ref))
        # compressed SA (every 8th entry, SA_COMPX=3) — the reference's
        # genome-scale mode; lookups LF-walk to a sampled row
        idx = build_arrays(codes, sa_compression=True)
        save_npz_full(idx, str(idx_npz),
                      [str(n).split(None, 1)[0] for n in names], lengths)
        build_s = time.perf_counter() - t0
        print(f"[build] index in {build_s:.0f} s", file=sys.stderr)
    else:
        build_s = None

    t0 = time.perf_counter()
    # idx_dtype=int64 regardless of text size: the point of the rehearsal
    # is the hg38-class (>2^31) arithmetic path
    didx = FI.load_npz(str(idx_npz), idx_dtype=np.int64)
    print(f"[load] index in {time.perf_counter() - t0:.0f} s "
          f"(text {int(didx.ref_seq_len):,} bp)", file=sys.stderr)

    enc = synth_reads(ref, args.reads, args.read_len)
    rl = np.full(args.reads, args.read_len, np.int32)

    # --- host engine ---
    from genomicsbench_palisade_tpu.io.native import fmi_search_native

    # warm: the first call builds the 64-byte packed occ rows from the
    # int64 index (~5 s at 512 MB, cached on didx) — that conversion is
    # index-load cost, not search rate
    t0 = time.perf_counter()
    fmi_search_native(didx, enc[:32], rl[:32],
                      min_seed_len=args.min_seed_len)
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_m, h1, h2, h3 = fmi_search_native(
        didx, enc, rl, min_seed_len=args.min_seed_len)
    host_dt = time.perf_counter() - t0
    host_total = h1 + h2 + h3

    if args.host_only:
        out = {"tool": "genome_scale_fmi", "mbp": args.mbp,
               "reads": args.reads,
               "host_reads_per_s": round(args.reads / host_dt, 1),
               "pack_build_s": round(pack_s, 1),
               "total_smems": int(host_total)}
        print(json.dumps(out))
        return 0

    # --- device pipeline (int64 cp_occ, compressed SA) ---
    import jax.numpy as jnp

    from genomicsbench_palisade_tpu.ops.fmi_pipeline import fmi_pipeline_batch

    index = {k: jnp.asarray(v) for k, v in didx.as_device_arrays().items()}
    # warm/compile on the first batch shape
    fmi_pipeline_batch(index, enc[: args.batch].astype(np.int32),
                       rl[: args.batch], min_seed_len=args.min_seed_len)
    t0 = time.perf_counter()
    parts = []
    t1 = t2 = t3 = 0
    for s in range(0, args.reads, args.batch):
        allm, n1, n2, n3, _ovf = fmi_pipeline_batch(
            index, enc[s : s + args.batch].astype(np.int32),
            rl[s : s + args.batch], min_seed_len=args.min_seed_len,
            rid_base=s)
        parts.append(allm)
        t1 += n1
        t2 += n2
        t3 += n3
    dev_dt = time.perf_counter() - t0
    dev_m = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    dev_total = t1 + t2 + t3

    parity = smem_key_set(host_m) == smem_key_set(dev_m)
    out = {
        "tool": "genome_scale_fmi",
        "mbp": args.mbp,
        "reads": args.reads,
        "build_s": None if build_s is None else round(build_s, 1),
        "host_reads_per_s": round(args.reads / host_dt, 1),
        "device_reads_per_s": round(args.reads / dev_dt, 1),
        "total_smems": int(host_total),
        "totals_match": bool(host_total == dev_total),
        "dump_parity": bool(parity),
    }
    print(json.dumps(out))
    return 0 if parity and host_total == dev_total else 1


if __name__ == "__main__":
    raise SystemExit(main())
