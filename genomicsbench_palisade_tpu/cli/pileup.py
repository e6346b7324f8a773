"""pileup driver: `python -m genomicsbench_palisade_tpu.cli.pileup <bam> <region> <threads>`.

Mirrors benchmarks/pileup/medaka_counts.c:498-560: splits the region into
100 kb chunks, computes the medaka counts matrix per chunk (num_homop=5),
prints each chunk's matrix in print_pileup_data format.
"""

from __future__ import annotations

import argparse
import re
import sys
import time

import os

from ..io.bam import read_bam, read_bam_region
from ..ops.pileup import calculate_pileup, print_pileup

CHUNK_LEN = 100000


def parse_region(region: str):
    m = re.match(r"^(.+?)(?::(\d+)-(\d+))?$", region)
    chrom = m.group(1)
    start = int(m.group(2)) - 1 if m.group(2) else 0
    end = int(m.group(3)) if m.group(3) else None
    return chrom, start, end


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pileup")
    ap.add_argument("bam")
    ap.add_argument("region")
    ap.add_argument("threads", type=int, nargs="?", default=1, help="ignored")
    ap.add_argument("dtypes", nargs="*", default=None,
                    help="read-name prefixes for multi-datatype counting "
                         "(medaka num_dtypes > 1)")
    ap.add_argument("--num-homop", type=int, default=5)
    ap.add_argument("--weibull", action="store_true",
                    help="homopolymer partial counts from WL/WK tags "
                         "(calculate_pileup's weibull_summation)")
    args = ap.parse_args(argv)

    from ..utils.compile_cache import enable as _enable_cache
    _enable_cache()

    chrom, start, end = parse_region(args.region)
    fetch_chunk = None
    if end is not None and os.path.exists(args.bam + ".bai"):
        # indexed access, RE-QUERIED PER 100 kb CHUNK exactly like the
        # reference driver's per-chunk htslib iterators
        # (medaka_counts.c:330-340 inside the :545-555 chunk loop) —
        # memory and event extraction stay chunk-sized even when the
        # region is the whole contig (chr20:1-64444167 on a prom BAM)
        from ..io.bam import read_bai

        bai = read_bai(args.bam + ".bai")
        refs, _ = read_bam_region(args.bam, chrom, 0, 0, index=bai)

        def fetch_chunk(cs, ce):
            return read_bam_region(args.bam, chrom, cs, ce,
                                   parse_tags=args.weibull, index=bai)[1]
    else:
        refs, records = read_bam(args.bam, parse_tags=args.weibull)
    names = [n for n, _l in refs]
    if chrom not in names:
        print(f"Reference {chrom} not in BAM", file=sys.stderr)
        return 1
    chrom_id = names.index(chrom)
    if end is None:
        end = refs[chrom_id][1]

    # fully-fused native region path (decode -> layout -> fill in C, no
    # Python record objects); eligible when indexed, non-weibull, single-dtype
    use_fused = (fetch_chunk is not None and not args.weibull
                 and not args.dtypes)
    if use_fused:
        from ..ops.pileup import calculate_pileup_region

    t0 = time.perf_counter()
    for cs in range(start, end, CHUNK_LEN):
        ce = min(cs + CHUNK_LEN, end)
        # the reference driver formats each chunk as "chr:<cs>-<ce>" with
        # 0-based cs and calculate_pileup RE-parses it as 1-based
        # (medaka_counts.c:545-555 vs :313-318), shifting every chunk's
        # start down one position — mirror that quirk exactly
        cs = max(cs - 1, 0)
        res = None
        if use_fused:
            res = calculate_pileup_region(
                args.bam, chrom, cs, ce, index=bai,
                num_homop=args.num_homop, refs=refs)
        if res is None:
            chunk_records = fetch_chunk(cs, ce) if fetch_chunk else records
            res = calculate_pileup(chunk_records, chrom_id, cs, ce,
                                   num_homop=args.num_homop,
                                   weibull_summation=args.weibull,
                                   dtypes=args.dtypes or None)
        print_pileup(res, num_homop=args.num_homop)
    print(f"Kernel time: {time.perf_counter() - t0:.3f} sec", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
