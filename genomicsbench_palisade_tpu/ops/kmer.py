"""Canonical k-mer counting on the device (Flye KmerCounter capability).

The reference (benchmarks/kmer-cnt/vertex_index.cpp:515-659)
uses an 8 GB atomic 4-bit saturating counter array + a concurrent cuckoo
hash for overflow.  Dense 4^17/2 histograms are 8 GB per device and
XLA has no atomic increments, so counting is reformulated as a sort-reduce:

  1. pack every read window into a 34-bit k-mer code held as two uint32
     planes (hi: top 2k-32 bits, lo: low 32) — plain shifts, no u64
  2. canonicalize: lexicographic min(code, revcomp) (kmer.h:53-61)
  3. lexicographic sort of (hi, lo) with validity as the top key
     (jax.lax.sort, num_keys=3)
  4. run-length reduce: distinct k-mers, occurrences, count of k-mers
     whose frequency exceeds the 4-bit saturation (>15) — exactly the
     "Total k-mers" / "Hash size" metrics the reference reports.

Multi-device: each shard counts its reads locally; merging histograms is a
key-range all_to_all + local sort (parallel/), or for metric-only parity a
single-device gather.  Parity quirks preserved: the k-mer at the final
position len-k of each read is NOT counted (kmer.h:177-200), non-ACGT
behaves as code 3 (sequence.h:183-193), reads shorter than 5000 bp are
dropped at load time (kmer_cnt.cpp:220-231).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_K = 17


@functools.partial(jax.jit, static_argnames=("k",))
def pack_kmers(bases, lengths, k: int = DEFAULT_K):
    """bases: [B, L] int32 2-bit codes; lengths: [B].

    Returns (hi, lo, valid): [B, P] uint32 planes of the forward k-mer code
    at each position p (P = L - k positions; the reference's iterator stops
    one short of the last full window), and the validity mask p < len - k.
    """
    b, l = bases.shape
    p = l - k
    assert p > 0, "reads shorter than k+1 have no counted k-mers"
    bases = bases.astype(jnp.uint32) & 3

    lo = jnp.zeros((b, p), jnp.uint32)
    hi = jnp.zeros((b, p), jnp.uint32)
    n_hi = 2 * k - 32 if 2 * k > 32 else 0  # bits in the hi plane
    for j in range(k):
        shift = 2 * (k - 1 - j)  # bit position of base j within the code
        chunk = bases[:, j : j + p]
        if shift >= 32:
            hi = hi | (chunk << (shift - 32))
        elif shift + 2 <= 32:
            lo = lo | (chunk << shift)
        else:  # straddles the plane boundary (odd k only; k is odd-shifted by 2 so never)
            lo = lo | (chunk << shift)
            hi = hi | (chunk >> (32 - shift))
    del n_hi
    pos = jnp.arange(p, dtype=jnp.int32)[None, :]
    valid = pos < (lengths.astype(jnp.int32)[:, None] - k)
    return hi, lo, valid


@functools.partial(jax.jit, static_argnames=("k",))
def canonical(hi, lo, k: int = DEFAULT_K):
    """Lexicographic min(code, reverse complement) on (hi, lo) planes."""
    # reverse complement: base j of rc = complement of base k-1-j of fwd
    comp_lo = ~lo
    comp_hi = ~hi
    rc_hi = jnp.zeros_like(hi)
    rc_lo = jnp.zeros_like(lo)
    for j in range(k):
        src = 2 * (k - 1 - j)  # bit offset of fwd base j
        dst = 2 * j  # bit offset of that base within rc
        if src >= 32:
            base = (comp_hi >> (src - 32)) & 3
        else:
            base = (comp_lo >> src) & 3
        if dst >= 32:
            rc_hi = rc_hi | (base << (dst - 32))
        else:
            rc_lo = rc_lo | (base << dst)
    hi_mask = jnp.uint32((1 << max(2 * k - 32, 1)) - 1) if 2 * k > 32 else jnp.uint32(0)
    rc_hi = rc_hi & hi_mask
    take_rc = (rc_hi < hi) | ((rc_hi == hi) & (rc_lo < lo))
    return jnp.where(take_rc, rc_hi, hi), jnp.where(take_rc, rc_lo, lo)


@functools.partial(jax.jit, static_argnames=("k", "saturation"))
def count_kmers_device(bases, lengths, k: int = DEFAULT_K, saturation: int = 15):
    """Full device pipeline for one shard of reads.

    Returns dict with total_kmers (distinct), hash_size (freq > saturation),
    occurrences (total windows counted).
    """
    hi, lo, valid = pack_kmers(bases, lengths, k)
    chi, clo = canonical(hi, lo, k)
    # flatten; invalid windows sort to the end via the primary key
    inv = (~valid).astype(jnp.uint32).ravel()
    chi = chi.ravel()
    clo = clo.ravel()
    inv_s, hi_s, lo_s = jax.lax.sort((inv, chi, clo), num_keys=3)
    n = hi_s.shape[0]
    valid_s = inv_s == 0
    new_run = jnp.ones(n, dtype=bool)
    new_run = new_run.at[1:].set(
        (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1]) | (valid_s[1:] != valid_s[:-1])
    )
    idx = jnp.arange(n, dtype=jnp.int32)
    run_start = jax.lax.cummax(jnp.where(new_run, idx, 0))
    run_len_here = idx - run_start + 1
    is_run_end = jnp.ones(n, dtype=bool)
    is_run_end = is_run_end.at[:-1].set(new_run[1:])
    total = jnp.sum(jnp.where(new_run & valid_s, 1, 0))
    over = jnp.sum(jnp.where(is_run_end & valid_s & (run_len_here > saturation), 1, 0))
    occ = jnp.sum(valid_s.astype(jnp.int32))
    return {"total_kmers": total, "hash_size": over, "occurrences": occ}


def encode_reads_np(reads, l_pad: int | None = None):
    """Host-side 2-bit encoding + padding. Non-ACGT -> 3 (reference quirk)."""
    table = np.full(256, 3, dtype=np.int8)
    for ch, v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
        table[ord(ch)] = v
        table[ord(ch.lower())] = v
    if l_pad is None:
        l_pad = max(len(r) for r in reads)
    out = np.zeros((len(reads), l_pad), dtype=np.int8)
    lengths = np.zeros(len(reads), dtype=np.int32)
    for i, r in enumerate(reads):
        enc = table[np.frombuffer(r.encode(), dtype=np.uint8)]
        out[i, : len(enc)] = enc
        lengths[i] = len(enc)
    return out, lengths


def pad_codes_np(code_arrays, l_pad: int | None = None):
    """[B, L] padded matrix + lengths from per-read 2-bit code arrays.
    Enforces the reference's N->3 quirk (codes >= 4 map to 3) so all
    engines agree even on off-contract inputs."""
    if l_pad is None:
        l_pad = max(len(c) for c in code_arrays)
    out = np.zeros((len(code_arrays), l_pad), dtype=np.int8)
    lengths = np.zeros(len(code_arrays), dtype=np.int32)
    for i, c in enumerate(code_arrays):
        c = np.asarray(c, np.int8)
        out[i, : len(c)] = np.where(c >= 4, 3, c)
        lengths[i] = len(c)
    return out, lengths


def count_kmers(reads, k: int = DEFAULT_K, min_read_length: int = 5000):
    """Host entry point with the reference's load-time read filter.

    reads: strings, or pre-encoded 2-bit uint8 code arrays (non-ACGT
    already mapped to 3 — the native FASTA parser's output after the
    4->3 quirk mapping)."""
    kept = [r for r in reads if len(r) > min_read_length]
    if not kept:
        return {"total_kmers": 0, "hash_size": 0, "occurrences": 0}
    if isinstance(kept[0], str):
        bases, lengths = encode_reads_np(kept)
    else:
        bases, lengths = pad_codes_np(kept)
    out = count_kmers_device(jnp.asarray(bases.astype(np.int32)), jnp.asarray(lengths), k)
    return {key: int(v) for key, v in out.items()}


@functools.partial(jax.jit, static_argnames=("k", "l_pad"))
def _batch_kmers(packed, lengths, k: int, l_pad: int):
    """2-bit packed read batch -> flattened (inv, canonical hi, lo) kmer
    streams.  The wire ships 4 bases/byte (a 1 Gbp dataset is 250 MB
    packed vs 4 GB as int32 rows)."""
    from .bsw import unpack_codes_2bit

    bases = unpack_codes_2bit(packed, l_pad, lengths, fill=0)
    hi, lo, valid = pack_kmers(bases, lengths, k)
    chi, clo = canonical(hi, lo, k)
    inv = (~valid).astype(jnp.uint32).ravel()
    return inv, chi.ravel(), clo.ravel()


@functools.partial(jax.jit, static_argnames=("cap",))
def _merge_acc(acc_hi, acc_lo, acc_cnt, acc_n, inv_b, hi_b, lo_b, cap: int):
    """Merge one batch's raw kmer stream into the device-resident
    (key, count) accumulator: concat + 3-key sort with the counts as
    payload + segmented sum (cumsum deltas at run ends, gather-free) +
    scatter-compact back into the [cap] accumulator slots."""
    acc_inv = (jnp.arange(cap, dtype=jnp.uint32) >= acc_n).astype(jnp.uint32)
    inv = jnp.concatenate([acc_inv, inv_b])
    hi = jnp.concatenate([acc_hi, hi_b])
    lo = jnp.concatenate([acc_lo, lo_b])
    cnt = jnp.concatenate(
        [acc_cnt, jnp.where(inv_b == 0, 1, 0).astype(jnp.int32)])
    inv_s, hi_s, lo_s, cnt_s = jax.lax.sort((inv, hi, lo, cnt), num_keys=3)
    n = hi_s.shape[0]
    valid_s = inv_s == 0
    new_run = jnp.ones(n, dtype=bool).at[1:].set(
        (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
        | (valid_s[1:] != valid_s[:-1]))
    is_run_end = jnp.ones(n, dtype=bool).at[:-1].set(new_run[1:])
    cs = jnp.cumsum(cnt_s)
    cs_excl = cs - cnt_s  # non-decreasing (counts >= 0), so cummax works
    run_prefix = jax.lax.cummax(jnp.where(new_run, cs_excl, 0))
    seg = cs - run_prefix  # at a run end: the run's total count
    sel = is_run_end & valid_s
    out_idx = jnp.cumsum(sel.astype(jnp.int32)) - 1
    tgt = jnp.where(sel, out_idx, cap)  # cap = out of bounds -> dropped
    new_hi = jnp.zeros(cap, jnp.uint32).at[tgt].set(hi_s, mode="drop")
    new_lo = jnp.zeros(cap, jnp.uint32).at[tgt].set(lo_s, mode="drop")
    new_cnt = jnp.zeros(cap, jnp.int32).at[tgt].set(seg, mode="drop")
    new_n = jnp.sum(sel.astype(jnp.int32))
    return new_hi, new_lo, new_cnt, new_n


@functools.partial(jax.jit, static_argnames=("saturation",))
def _acc_metrics(acc_cnt, acc_n, saturation: int):
    valid = jnp.arange(acc_cnt.shape[0], dtype=jnp.int32) < acc_n
    over = jnp.sum(jnp.where(valid & (acc_cnt > saturation), 1, 0))
    occ = jnp.sum(jnp.where(valid, acc_cnt, 0))
    return over, occ


# int32 cumsum wrap bound for _merge_acc (module-level so tests can
# shrink it without GB inputs)
_OCC_CUMSUM_BOUND = (1 << 31) - 1


def count_kmers_batched(reads, k: int = DEFAULT_K,
                        min_read_length: int = 5000, saturation: int = 15,
                        batch_bases: int = 96_000_000, cap: int = 1 << 26):
    """Dataset-scale counter: same metrics contract as count_kmers, but
    reads stream through the device in ~batch_bases chunks against a
    device-resident (canonical kmer, count) accumulator — the one-shot
    path ships the whole padded read matrix, which at the reference's
    GB-scale read sets (kmer-cnt minLen>=5000 regime,
    sequence_container.cpp) is a 4 GB transfer and an HBM-breaking sort.

    cap bounds the DISTINCT kmers (genome size + error novelties); a
    RuntimeError names the overflow rather than silently truncating.
    """
    from .bsw import pack_codes_2bit

    kept = [r for r in reads if len(r) > min_read_length]
    if not kept:
        return {"total_kmers": 0, "hash_size": 0, "occurrences": 0}
    acc_hi = jnp.zeros(cap, jnp.uint32)
    acc_lo = jnp.zeros(cap, jnp.uint32)
    acc_cnt = jnp.zeros(cap, jnp.int32)
    acc_n = jnp.int32(0)
    # _merge_acc's run-prefix trick rides an int32 cumsum over ALL
    # accumulated occurrences; past 2^31 it wraps and counts go silently
    # wrong.  Track the exact occurrence total host-side (len-k+1 valid
    # windows per kept read) and refuse the merge that would cross it.
    occ_bound = _OCC_CUMSUM_BOUND
    occ_total = 0
    i = 0
    while i < len(kept):
        j = i
        total = 0
        while j < len(kept) and total < batch_bases:
            total += len(kept[j])
            j += 1
        chunk = kept[i:j]
        i = j
        if isinstance(chunk[0], str):
            bases, lengths = encode_reads_np(chunk)
        else:
            bases, lengths = pad_codes_np(chunk)
        # shape bucketing: one compile per (rows, l_pad) bucket
        l_pad = max(int(2 ** np.ceil(np.log2(max(bases.shape[1], 4)))), 4)
        rows = -(-bases.shape[0] // 64) * 64
        full = np.zeros((rows, l_pad), np.uint8)
        full[: bases.shape[0], : bases.shape[1]] = np.where(
            bases >= 4, 3, bases)
        lens_p = np.zeros(rows, np.int32)
        lens_p[: len(lengths)] = lengths
        packed = pack_codes_2bit(full)
        occ_total += int(np.maximum(np.asarray(lengths) - k + 1, 0).sum())
        if occ_total > occ_bound:
            raise RuntimeError(
                f"count_kmers_batched: accumulated occurrences would reach "
                f"{occ_total} > 2^31-1, wrapping the int32 run-prefix "
                f"cumsum in _merge_acc; shard by key range "
                f"(parallel.dp.count_kmers_sharded) or use the native host "
                f"engine (count_kmers_host)")
        inv_b, hi_b, lo_b = _batch_kmers(
            jnp.asarray(packed), jnp.asarray(lens_p), k, l_pad)
        acc_hi, acc_lo, acc_cnt, acc_n = _merge_acc(
            acc_hi, acc_lo, acc_cnt, acc_n, inv_b, hi_b, lo_b, cap)
        n_now = int(acc_n)
        if n_now >= cap:
            raise RuntimeError(
                f"distinct kmers reached the accumulator cap ({cap}); "
                f"raise cap= or shard by key range (parallel.dp)")
    over, occ = _acc_metrics(acc_cnt, acc_n, saturation)
    return {"total_kmers": int(acc_n), "hash_size": int(over),
            "occurrences": int(occ)}


def count_kmers_host(reads, k: int = DEFAULT_K,
                     min_read_length: int = 5000, saturation: int = 15,
                     cap_hint: int | None = None):
    """Host hash-counting engine (native/kmercnt.cpp), metrics-identical
    to count_kmers — the dataset-scale default when the native lib is
    built (counting is random-access-hash CPU-shaped work, the same
    dual-engine split as fmi).  Returns None when native is unavailable.
    """
    from ..io.native import kmer_count_native

    if k > 32:  # the rolling code is one u64 (same bound as pack_kmers)
        return None
    kept = [r for r in reads if len(r) > min_read_length]
    if not kept:
        return {"total_kmers": 0, "hash_size": 0, "occurrences": 0}
    if isinstance(kept[0], str):
        table = np.full(256, 3, np.int8)
        for ch, v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
            table[ord(ch)] = v
            table[ord(ch.lower())] = v
        arrs = [table[np.frombuffer(r.encode(), np.uint8)] for r in kept]
    else:
        # same N->3 quirk as encode_reads_np/pad_codes_np: all three
        # engines must agree even when codes weren't pre-mapped
        arrs = [np.where(np.asarray(r, np.int8) >= 4, 3,
                         np.asarray(r, np.int8)) for r in kept]
    lens = np.array([len(a) for a in arrs], np.int32)
    offs = np.concatenate(([0], np.cumsum(lens[:-1], dtype=np.int64)))
    codes = np.concatenate(arrs) if arrs else np.empty(0, np.int8)
    total_windows = int((lens - k).clip(min=0).sum())
    guess = cap_hint if cap_hint else min(max(total_windows // 8, 1 << 16),
                                          1 << 27)
    log2 = max(int(np.ceil(np.log2(guess * 2))), 16)
    res = kmer_count_native(codes, offs, lens, k, min_read_length,
                            saturation, log2)
    if res is None:
        return None
    total, over, occ = res
    return {"total_kmers": total, "hash_size": over, "occurrences": occ}


def build_minimizer_index(reads, k: int = DEFAULT_K, window: int = 5,
                          min_coverage: int = 1, repeat_rate: float = 1.0,
                          min_read_length: int = 5000):
    """Production buildIndexMinimizers (same contract/metrics as
    ops.oracle.kmer.build_minimizer_index, which stays the pure spec):
    the monotone-deque selection runs in C++ when the native lib is built
    (native/minimizers.cpp, fuzz-exact vs the oracle)."""
    from collections import Counter

    from ..io.native import minimizer_counts_native
    from .oracle import kmer as KO

    kept_reads = [r for r in reads if len(r) > min_read_length]
    codes = [KO.encode_seq(r).astype(np.uint8) if isinstance(r, str)
             else np.asarray(r, np.uint8) for r in kept_reads]
    native = minimizer_counts_native(codes, k, window, 0)
    if native is not None:
        counter = Counter(native)
    else:
        counter = Counter()
        for rc_codes in codes:
            if len(rc_codes) - k <= 0:
                continue
            for _pos, fwd in KO.yield_minimizers(rc_codes, k, window):
                rc = KO.revcomp_code(fwd, k)
                counter[min(fwd, rc)] += 1

    total = sum(c for c in counter.values() if c >= min_coverage)
    unique = sum(1 for c in counter.values() if c >= min_coverage)
    mean_freq = total / (unique + 1)
    rep_freq = repeat_rate * mean_freq
    filtered = sum(c for c in counter.values() if c > rep_freq)
    kept = {km: c for km, c in counter.items() if not c > rep_freq}
    index_size = sum(kept.values())
    selected = len(kept)
    return {
        "counter": counter,
        "mean_frequency": mean_freq,
        "repetitive_frequency": rep_freq,
        "filtered": filtered,
        "filtered_rate": (filtered / total) if total else 0.0,
        "selected_kmers": selected,
        "index_size": index_size,
        "mean_index_frequency": (index_size / selected) if selected else 0.0,
    }
