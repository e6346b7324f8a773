"""Dataset-scale bsw rehearsal: the reference's large-input shape.

The reference's bsw_large run reads 31,819,380 lines -> 10,606,460 pairs
into 23.47 GB of buffers (scripts/bsw_large:5-8; BASELINE.md "bsw large
input scale").  This synthesizes the same pair count in the reference's
3-line record format (h0 line, ref line, query line — digit-coded bases,
benchmarks/bsw/main_banded.cpp:673-760), then drives the SAME path as
`cli/bsw.py` (parse_pairs -> score_pairs bucketed scan batches) and
reports read/prep/kernel split plus pairs/s.

Parity: a random sample of pairs is re-scored with the XLA scan engine
(ops/bsw.py, itself pinned to the 300 reference-binary goldens in
tests/fixtures/bsw_golden.json) and every output field must match the
driver's stacked, 2-bit-wire dispatch bit-exactly.

Usage:
  python tools/bsw_scale_bench.py --workdir /tmp/bsw_scale            # full 10.6M
  python tools/bsw_scale_bench.py --pairs 1000000                     # scaled
  python tools/bsw_scale_bench.py --smoke                             # tiny
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

REF_PAIRS = 10_606_460  # scripts/bsw_large:8


def write_pairs(path, n_pairs, rng, chunk=8192, smoke=False):
    """Chunked generator: pairs within a chunk share (ql, tl) so base
    synthesis is one [chunk, tl] numpy op; lengths vary across chunks
    (query 96..151, target 192..256 — the phmm/bsw small-dataset regime,
    main_banded.cpp caps 256/2048)."""
    with open(path, "wb") as f:
        done = 0
        while done < n_pairs:
            m = min(chunk, n_pairs - done)
            ql = int(rng.integers(8, 24) if smoke else rng.integers(96, 152))
            tl = int(rng.integers(16, 40) if smoke else rng.integers(192, 257))
            tgt = rng.integers(0, 4, (m, tl), dtype=np.uint8)
            qry = tgt[:, :ql].copy()
            mut = rng.random((m, ql)) < 0.08
            qry[mut] = rng.integers(0, 4, int(mut.sum()), dtype=np.uint8)
            h0 = rng.integers(1, 80, m)
            tb = (tgt + 48).astype(np.uint8)
            qb = (qry + 48).astype(np.uint8)
            rows = []
            for i in range(m):
                rows.append(b"%d %d %d\n%s\n%s\n" % (
                    h0[i], tl, ql, tb[i].tobytes(), qb[i].tobytes()))
            f.write(b"".join(rows))
            done += m


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/bsw_scale")
    ap.add_argument("--pairs", type=int, default=REF_PAIRS)
    ap.add_argument("--parity-sample", type=int, default=512)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="BSW_SCALE.json")
    args = ap.parse_args(argv)

    if args.smoke:
        from chain_scale_bench import force_cpu_backend
        force_cpu_backend()
    from genomicsbench_palisade_tpu.utils.compile_cache import enable
    enable()

    if args.smoke:
        args.pairs = min(args.pairs, 2048)

    wd = pathlib.Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)
    pf = wd / (f"pairs_{args.pairs}.txt")
    rng = np.random.default_rng(9)
    if not pf.exists():
        t0 = time.perf_counter()
        write_pairs(pf, args.pairs, rng, smoke=args.smoke)
        print(f"[gen] {args.pairs:,} pairs "
              f"({pf.stat().st_size / 1e9:.2f} GB) in "
              f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)

    from genomicsbench_palisade_tpu.cli.bsw import score_pairs_soa
    from genomicsbench_palisade_tpu.io.pairs import parse_pairs_soa
    from genomicsbench_palisade_tpu.ops import bsw as W

    t0 = time.perf_counter()
    soa = parse_pairs_soa(str(pf))
    read_s = time.perf_counter() - t0
    n_pairs = len(soa["h0"])
    print(f"[read] {n_pairs:,} pairs in {read_s:.1f} s", file=sys.stderr)

    t0 = time.perf_counter()
    results = score_pairs_soa(soa)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = score_pairs_soa(soa)
    kernel_s = time.perf_counter() - t0

    # parity sample: CLI results vs the golden-pinned scan engine
    sel = rng.choice(n_pairs, min(args.parity_sample, n_pairs),
                     replace=False)
    sample = [(soa["codes"][soa["q_off"][i]: soa["q_off"][i] + soa["q_len"][i]],
               soa["codes"][soa["t_off"][i]: soa["t_off"][i] + soa["t_len"][i]],
               int(soa["h0"][i])) for i in sel]
    batch = W.prepare_pairs(sample)
    want = {k: np.asarray(v) for k, v in W.bsw_batch(batch).items()}
    for row, i in enumerate(sel):
        for key in ("score", "qle", "tle", "gtle", "gscore", "max_off"):
            assert int(results[key][i]) == int(want[key][row]), (
                key, i, int(results[key][i]), int(want[key][row]))

    cells = float(soa["q_len"].astype(np.int64) @ soa["t_len"].astype(np.int64))
    out = {
        "tool": "bsw_scale_bench",
        "pairs": n_pairs,
        "input_gb": round(pf.stat().st_size / 1e9, 2),
        "read_s": round(read_s, 1),
        "warm_s": round(warm_s, 1),
        "kernel_s": round(kernel_s, 2),
        "pairs_per_s": round(n_pairs / kernel_s, 1),
        "gcups_upper": round(cells / kernel_s / 1e9, 2),
        "parity_sample": int(len(sel)),
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
