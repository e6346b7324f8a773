"""kmer-cnt driver: `python -m genomicsbench_palisade_tpu.cli.kmer_cnt
--reads <fasta> --config <cfg> [--threads N] [--debug]`.

Reproduces the reference driver's contract (benchmarks/kmer-cnt/
kmer_cnt.cpp:143-287): parse Flye-style flags, load the key=value config,
read FASTA with the max(minReadLength, minOverlap) filter
(kmer_cnt.cpp:220-231), count canonical k-mers, and print the same
metrics — `readsFasta:`/`minReadLength:`/`useMinimizers:` stdout lines,
DEBUG `Hash size:` / `Total k-mers` logger lines
(vertex_index.cpp:657-658), `Peak RAM usage`, and the stderr
`Kernel time: %.3f sec` (kmer_cnt.cpp:284).

Design: counting is the sort-reduce device pipeline in ops.kmer,
batched over padded length buckets; with >1 local device, reads are
sharded over the mesh and per-shard counts merged through the key-range
all_to_all path in parallel.dp.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..config import load_flye_cfg
from ..io.fastq import read_sequences
from ..ops import kmer as K
from ..utils.logger import Logger, get_memory_size, get_peak_rss


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kmer-cnt")
    ap.add_argument("--reads", required=True, help="comma-separated FASTA/FASTQ paths")
    ap.add_argument("--config", required=True, help="Flye key=value config file")
    ap.add_argument("--threads", type=int, default=1, help="ignored (device-parallel)")
    ap.add_argument("--kmer", type=int, default=-1, help="override config kmer_size")
    ap.add_argument("--min-ovlp", type=int, default=5000, dest="min_ovlp")
    ap.add_argument("--min-read", type=int, default=0, dest="min_read")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--log", default="", help="log file sink")
    ap.add_argument("--meta", action="store_true", help="uneven coverage mode flag")
    args = ap.parse_args(argv)

    from ..utils.compile_cache import enable as _enable_cache
    _enable_cache()

    log = Logger.get()
    log.set_debugging(args.debug)
    if args.log:
        log.set_output_file(args.log)
    log.debug(f"Total RAM: {get_memory_size() // 1024**3} Gb")

    cfg = load_flye_cfg(args.config)
    kmer_size = args.kmer if args.kmer != -1 else int(cfg.get("kmer_size", 17))
    log.debug(f"Running with k-mer size: {kmer_size}")
    log.debug(f"Running with minimum overlap {args.min_ovlp}")
    log.debug("Metagenome mode: " + ("Y" if args.meta else "N"))
    print(f"readsFasta: {args.reads}")

    log.info("Reading sequences")
    min_read_length = max(args.min_read, args.min_ovlp)
    print(f"minReadLength: {min_read_length}")
    from ..io.native import parse_reads_native

    reads = []
    for reads_file in args.reads.split(","):
        print(f"readsFile: {reads_file}")
        nat = parse_reads_native(reads_file)
        if nat is not None:  # native parse -> codes, skip string round-trip
            codes, _quals, offsets, lengths = nat
            import numpy as _np

            for i in range(len(lengths)):
                if lengths[i] > min_read_length:
                    c = codes[offsets[i] : offsets[i] + lengths[i]]
                    # both counter and minimizer paths treat non-ACGT as 3
                    reads.append(_np.where(c >= 4, 3, c).astype(_np.uint8))
        else:
            for _name, seq, _q in read_sequences(reads_file):
                if len(seq) > min_read_length:
                    reads.append(seq)

    use_minimizers = bool(cfg.get("use_minimizers", False))
    print(f"useMinimizers: {int(use_minimizers)}")

    t0 = time.perf_counter()
    if use_minimizers:
        # buildIndexMinimizers path (vertex_index.cpp:391-489); native
        # C++ deque walk when built, oracle fallback
        from ..ops.kmer import build_minimizer_index

        log.info("Building minimizer index")
        wnd = int(cfg.get("minimizer_window", 5))
        rate = float(cfg.get("repeat_kmer_rate", 1.0))
        r = build_minimizer_index(
            reads, k=kmer_size, window=wnd, min_coverage=1,
            repeat_rate=rate, min_read_length=min_read_length,
        )
        runtime = time.perf_counter() - t0
        log.debug(f"Mean k-mer frequency: {r['mean_frequency']}")
        log.debug(f"Repetitive k-mer frequency: {r['repetitive_frequency']}")
        log.debug(f"Filtered {r['filtered']} repetitive k-mers "
                  f"({r['filtered_rate']})")
        log.debug(f"Selected k-mers: {r['selected_kmers']}")
        log.debug(f"Index size: {r['index_size']}")
        log.debug(f"Mean k-mer index frequency: {r['mean_index_frequency']}")
        log.debug(f"Peak RAM usage: {get_peak_rss() // 1024**3} Gb")
        print(f"Kernel time: {runtime:.3f} sec", file=sys.stderr)
        return 0
    total_bases = sum(len(r) for r in reads)
    if total_bases > 192_000_000:
        # GB-scale read sets (sequence_container.cpp regime): host hash
        # engine when built (counting is random-access CPU-shaped work —
        # the fmi dual-engine split), else stream through the device accumulator
        metrics = K.count_kmers_host(
            reads, k=kmer_size, min_read_length=min_read_length)
        if metrics is None:
            metrics = K.count_kmers_batched(
                reads, k=kmer_size, min_read_length=min_read_length)
    else:
        metrics = K.count_kmers(reads, k=kmer_size,
                                min_read_length=min_read_length)
    runtime = time.perf_counter() - t0

    log.debug(f"Hash size: {metrics['hash_size']}")
    log.debug(f"Total k-mers {metrics['total_kmers']}")
    log.debug(f"Peak RAM usage: {get_peak_rss() // 1024**3} Gb")
    print(f"Kernel time: {runtime:.3f} sec", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
