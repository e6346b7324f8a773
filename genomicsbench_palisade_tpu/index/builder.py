"""Genome-scale FM-index construction (bwa-mem2 build_index capability).

The reference builds its `.bwt.2bit.64` index offline with a SAIS suffix
array over fwd+revcomp and checkpointed occ blocks
(tools/bwa-mem2/src/FMI_search.cpp:176-356 build_fm_index / :358
build_index; bntseq.cpp packs the FASTA).  This builder produces the
same artifacts with everything vectorized:

  * suffix array: native SA-IS (native/sais.cpp; a 100 Mbp genome's
    fwd+revcomp 200 Mchar build measures ~5.5 min end-to-end) with the
    oracle's prefix-doubling numpy fallback
  * BWT / cumulative counts / per-64bp-block cp_occ checkpoints + MSB-
    first one-hot planes: pure numpy bit packing
  * ambiguous bases: bwa-mem2 replaces non-ACGT with a random base when
    packing (bntseq.cpp AddSeq lrand48 path); we use a seeded PCG so
    builds are reproducible
  * outputs: the framework's npz device layout and optionally the
    reference's exact `.bwt.2bit.64` binary format
"""

from __future__ import annotations

import numpy as np

from ..io import native
from ..ops.oracle import fmi as fmi_oracle
from .fmi_index import CP_MASK, CP_SHIFT, DeviceFmIndex

_CODE_TABLE = np.full(256, 255, dtype=np.uint8)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _CODE_TABLE[ord(_ch)] = _v
    _CODE_TABLE[ord(_ch.lower())] = _v


def pack_fasta(path: str, ambig_seed: int = 11, with_holes: bool = False):
    """FASTA -> (codes uint8[L], names, lengths[, holes]).  Non-ACGT become
    a seeded-random base (bntseq.cpp packing semantics); with_holes=True
    also returns the bntseq ambiguity runs [(offset, len, char)] in
    concatenated coordinates (consecutive equal ambiguous chars merge into
    one hole, bntseq.cpp:1640-1665 semantics) for the .amb/.ann writers."""
    from ..io.fastq import read_sequences

    rng = np.random.default_rng(ambig_seed)
    names, lengths, parts, holes = [], [], [], []
    off = 0
    for name, seq, _q in read_sequences(path, full_names=with_holes):
        raw = np.frombuffer(seq.encode(), dtype=np.uint8)
        codes = _CODE_TABLE[raw]
        amb = codes == 255
        if amb.any():
            codes = codes.copy()
            codes[amb] = rng.integers(0, 4, int(amb.sum()), dtype=np.uint8)
            if with_holes:
                # runs of the SAME ambiguous character = one hole each
                starts = np.nonzero(amb & ~(np.concatenate(
                    [[False], amb[:-1] & (raw[1:] == raw[:-1])])))[0]
                for s in starts:
                    e = int(s)
                    while e + 1 < len(raw) and amb[e + 1] and raw[e + 1] == raw[s]:
                        e += 1
                    holes.append((off + int(s), e - int(s) + 1, chr(raw[s])))
        names.append(name)
        lengths.append(len(codes))
        parts.append(codes)
        off += len(codes)
    if not parts:
        raise ValueError(f"no sequences in {path}")
    out = (np.concatenate(parts), names, np.asarray(lengths, np.int64))
    return out + (holes,) if with_holes else out


def suffix_array(codes: np.ndarray, out: np.ndarray | None = None
                 ) -> np.ndarray:
    sa = native.sais(codes, out=out)
    if sa is None:
        sa = fmi_oracle.suffix_array(codes.astype(np.int64))
        if out is not None:
            out[:] = sa
            sa = out
    return sa


def build_arrays(forward_codes: np.ndarray, sa_compression: bool = False
                 ) -> DeviceFmIndex:
    """Full fwd+revcomp FM index with SA sample arrays, vectorized.

    sa_compression=True keeps every 8th SA entry (SA_COMPX=3, the
    reference's compressed mode; lookup LF-walks to a sampled row)."""
    fwd = np.asarray(forward_codes, dtype=np.uint8)
    full = np.concatenate([fwd, (3 - fwd[::-1]).astype(np.uint8)])
    pac_len = len(full)
    ref_seq_len = pac_len + 1

    sa = np.empty(ref_seq_len, dtype=np.int64)
    sa[0] = pac_len  # virtual sentinel suffix ranks first
    suffix_array(full, out=sa[1:])  # SA-IS fills the tail in place

    # previous-character gather.  Two perf traps at genome scale:
    # numpy's `int64_array % python_int` takes a slow scalar path, and
    # every fresh multi-GB temporary pays first-touch page faults — so
    # shift sa
    # in place and restore instead of materializing (sa - 1) % pac_len.
    sentinel_index = int(np.nonzero(sa == 0)[0][0])
    sa -= 1
    sa[sentinel_index] = 0  # gather index is don't-care (row becomes 4)
    bwt = full[sa]
    bwt[sentinel_index] = 4
    sa += 1
    sa[sentinel_index] = 0

    counts = np.bincount(full, minlength=4)[:4]
    count_raw = np.zeros(5, dtype=np.int64)
    count_raw[1:] = np.cumsum(counts)

    blocks = (ref_seq_len >> CP_SHIFT) + 1
    pad = blocks * 64
    bwt_pad = np.full(pad, 5, dtype=np.uint8)
    bwt_pad[:ref_seq_len] = bwt
    tiles = bwt_pad.reshape(blocks, 64)

    cp_count = np.zeros((blocks, 4), dtype=np.int64)
    one_hot_hi = np.zeros((blocks, 4), dtype=np.uint32)
    one_hot_lo = np.zeros((blocks, 4), dtype=np.uint32)
    for b in range(4):
        mask = tiles == b
        # exclusive cumulative occ at each block start
        per_block = mask.sum(axis=1, dtype=np.int64)
        cp_count[1:, b] = np.cumsum(per_block)[:-1]
        pb = np.packbits(mask, axis=1)  # [blocks, 8] MSB-first bytes
        w = pb.astype(np.uint32)
        one_hot_hi[:, b] = (w[:, 0] << 24) | (w[:, 1] << 16) | (w[:, 2] << 8) | w[:, 3]
        one_hot_lo[:, b] = (w[:, 4] << 24) | (w[:, 5] << 16) | (w[:, 6] << 8) | w[:, 7]

    sa_kept = sa[::8] if sa_compression else sa
    return DeviceFmIndex(
        ref_seq_len=ref_seq_len,
        count=count_raw + 1,  # sentinel adjustment (FMI_search.cpp:763-768)
        sentinel_index=sentinel_index,
        cp_count=cp_count,
        one_hot_hi=one_hot_hi,
        one_hot_lo=one_hot_lo,
        sa_ms_byte=(sa_kept >> 32).astype(np.int8),
        sa_ls_word=(sa_kept & 0xFFFFFFFF).astype(np.uint32),
        sa_compression=sa_compression,
        idx_dtype=np.int64 if ref_seq_len > 2**31 - 1 else np.int32,
    )


def write_bwt2bit64(idx: DeviceFmIndex, path: str):
    """Write the reference's exact binary format (FMI_search.cpp:300-340
    layout; see fmi_index.load_bwt2bit64 for the field order)."""
    if idx.sa_ms_byte is None or idx.sa_ls_word is None:
        raise ValueError("index was built without SA arrays")
    blocks = idx.cp_count.shape[0]
    rec = np.empty((blocks, 8), dtype=np.uint64)
    rec[:, :4] = idx.cp_count.astype(np.int64).view(np.uint64)
    hi = idx.one_hot_hi.astype(np.uint64)
    lo = idx.one_hot_lo.astype(np.uint64)
    rec[:, 4:] = (hi << np.uint64(32)) | lo
    with open(path, "wb") as f:
        np.int64(idx.ref_seq_len).tofile(f)
        (np.asarray(idx.count, np.int64) - 1).tofile(f)  # stored pre-adjust
        rec.tofile(f)
        idx.sa_ms_byte.tofile(f)
        idx.sa_ls_word.tofile(f)
        np.int64(idx.sentinel_index).tofile(f)


def save_npz_full(idx: DeviceFmIndex, path: str, names=None, lengths=None):
    extra = {}
    if names is not None:
        extra["contig_names"] = np.asarray(names, dtype=object)
        extra["contig_lengths"] = np.asarray(lengths, np.int64)
    np.savez_compressed(
        path,
        ref_seq_len=idx.ref_seq_len,
        count=idx.count,
        sentinel_index=idx.sentinel_index,
        cp_count=idx.cp_count,
        one_hot_hi=idx.one_hot_hi,
        one_hot_lo=idx.one_hot_lo,
        sa_ms_byte=idx.sa_ms_byte if idx.sa_ms_byte is not None else np.zeros(0, np.int8),
        sa_ls_word=idx.sa_ls_word if idx.sa_ls_word is not None else np.zeros(0, np.uint32),
        sa_compression=np.bool_(idx.sa_compression),
        **extra,
    )


def write_bntseq(prefix: str, codes: np.ndarray, names, lengths, holes,
                 seed: int = 11):
    """Reference-format sequence metadata: <prefix>.ann / .amb / .pac.

    Text formats per bntseq.cpp:85-111 (`l_pac n_seqs seed`, then per
    contig `gi name [comment]` + `offset len n_ambs`; .amb header
    `l_pac n_seqs n_holes` + `offset len char` per ambiguity run); .pac is
    the 2-bit forward pack, base i in bits (~i&3)*2 of byte i>>2, with the
    reference's trailer (bntseq.cpp:1718-1728: a zero pad byte when
    l_pac%4==0, then one byte holding l_pac%4)."""
    l_pac = int(len(codes))
    offs = np.concatenate([[0], np.cumsum(np.asarray(lengths, np.int64))])
    with open(prefix + ".ann", "w") as f:
        f.write(f"{l_pac} {len(names)} {seed}\n")
        for i, name in enumerate(names):
            parts = str(name).split(None, 1)
            head = f"0 {parts[0]}"
            if len(parts) > 1:
                head += f" {parts[1]}"
            n_ambs = sum(1 for (o, _l, _c) in holes
                         if offs[i] <= o < offs[i + 1])
            f.write(f"{head}\n{int(offs[i])} {int(lengths[i])} {n_ambs}\n")
    with open(prefix + ".amb", "w") as f:
        f.write(f"{l_pac} {len(names)} {len(holes)}\n")
        for o, length, ch in holes:
            f.write(f"{o} {length} {ch}\n")
    # O(l_pac) bytes: pad to a multiple of 4 and combine columns (an
    # np.bitwise_or.at over int64 index/shift temporaries needs many
    # times the genome size in RAM at hg38 scale)
    pad4 = (-l_pac) % 4
    quad = np.concatenate([codes.astype(np.uint8),
                           np.zeros(pad4, np.uint8)]).reshape(-1, 4)
    pac = ((quad[:, 0] << 6) | (quad[:, 1] << 4)
           | (quad[:, 2] << 2) | quad[:, 3]).astype(np.uint8)
    with open(prefix + ".pac", "wb") as f:
        f.write(pac.tobytes())
        if l_pac % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([l_pac % 4]))


def build_from_fasta(fasta_path: str, prefix: str, bwt2bit: bool = False,
                     bntseq: bool = False):
    """Offline index build: <prefix>.npz (+ optional <prefix>.bwt.2bit.64
    and the reference's <prefix>.ann/.amb/.pac sequence metadata).

    Returns (DeviceFmIndex, names, lengths).
    """
    codes, names, lengths, holes = pack_fasta(fasta_path, with_holes=True)
    short = [str(n).split(None, 1)[0] for n in names]
    idx = build_arrays(codes)
    save_npz_full(idx, prefix + ".npz", short, lengths)
    if bwt2bit:
        write_bwt2bit64(idx, prefix + ".bwt.2bit.64")
    if bntseq:
        write_bntseq(prefix, codes, names, lengths, holes)
    return idx, short, lengths
