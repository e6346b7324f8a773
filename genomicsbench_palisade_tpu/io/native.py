"""ctypes bindings for the native host-I/O library (native/fastio.cpp).

Falls back transparently to the pure-Python readers when the .so hasn't
been built (`make -C native`).
"""

from __future__ import annotations

import ctypes
import os
import pathlib

import numpy as np

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = pathlib.Path(__file__).resolve().parents[2] / "native" / "libgenomics_native.so"
    if not so.exists():
        _LIB = False
        return _LIB
    lib = ctypes.CDLL(str(so))
    lib.gt_parse_reads.restype = ctypes.c_void_p
    lib.gt_parse_reads.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.gt_num_reads.restype = ctypes.c_int64
    lib.gt_num_reads.argtypes = [ctypes.c_void_p]
    lib.gt_total_bases.restype = ctypes.c_int64
    lib.gt_total_bases.argtypes = [ctypes.c_void_p]
    lib.gt_num_quals.restype = ctypes.c_int64
    lib.gt_num_quals.argtypes = [ctypes.c_void_p]
    lib.gt_copy_out.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.gt_free_reads.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return bool(_load())


def parse_reads_native(path: str, limit: int = -1):
    """Returns (codes int8[total], quals int8[total]|None, offsets i64[N],
    lengths i32[N]) or None if the native library isn't built."""
    lib = _load()
    if not lib:
        return None
    h = lib.gt_parse_reads(os.fsencode(path), limit)
    if not h:
        return None
    try:
        n = lib.gt_num_reads(h)
        total = lib.gt_total_bases(h)
        nq = lib.gt_num_quals(h)
        codes = np.empty(total, np.int8)
        quals = np.empty(nq, np.int8) if nq else None
        offsets = np.empty(n, np.int64)
        lengths = np.empty(n, np.int32)
        lib.gt_copy_out(
            h,
            codes.ctypes.data_as(ctypes.c_void_p),
            quals.ctypes.data_as(ctypes.c_void_p) if nq else None,
            offsets.ctypes.data_as(ctypes.c_void_p),
            lengths.ctypes.data_as(ctypes.c_void_p),
        )
    finally:
        lib.gt_free_reads(h)
    return codes, quals, offsets, lengths


def _pairs_lib():
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_pairs_ready"):
        lib.gt_pairs_count.restype = ctypes.c_int64
        lib.gt_pairs_count.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.gt_pairs_parse.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
            + [ctypes.c_void_p] * 5)
        lib.gt_bsw_pack_rows.restype = ctypes.c_int64
        lib.gt_bsw_pack_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
        lib.gt_bsw_pad_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int8,
            ctypes.c_void_p]
        lib.gt_sub48.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib._pairs_ready = True
    return lib


def sub48_native(arr: np.ndarray):
    """int8(arr) - 48 in one fused native pass, or None."""
    lib = _pairs_lib()
    if not lib:
        return None
    arr = np.ascontiguousarray(arr, np.uint8)
    out = np.empty(arr.size, np.int8)
    lib.gt_sub48(arr.ctypes.data, arr.size, out.ctypes.data)
    return out


def parse_pairs_struct_native(buf: np.ndarray):
    """Single-pass structural parse of the bsw 3-line pair format
    (native/pairsio.cpp): buf is the raw uint8 file image; returns
    (t_off i64, t_len i32, q_off i64, q_len i32, h0 i32) with offsets
    into buf, or None when the native library isn't built."""
    lib = _pairs_lib()
    if not lib:
        return None
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    n = lib.gt_pairs_count(buf.ctypes.data, buf.size)
    t_off = np.empty(n, np.int64)
    t_len = np.empty(n, np.int32)
    q_off = np.empty(n, np.int64)
    q_len = np.empty(n, np.int32)
    h0 = np.empty(n, np.int32)
    lib.gt_pairs_parse(buf.ctypes.data, buf.size, n,
                       t_off.ctypes.data, t_len.ctypes.data,
                       q_off.ctypes.data, q_len.ctypes.data, h0.ctypes.data)
    return t_off, t_len, q_off, q_len, h0


def bsw_pack_rows_native(codes: np.ndarray, off: np.ndarray, ln: np.ndarray,
                         pad: int, bias: int = 0):
    """2-bit-packed [n, pad//4] uint8 wire rows (pack_codes_2bit layout)
    built directly from the flat codes buffer, or None when unavailable.
    Returns (rows, n_bad); n_bad > 0 means out-of-range codes were seen
    and the caller must use the raw path instead."""
    lib = _pairs_lib()
    if not lib:
        return None
    n = len(ln)
    codes = np.ascontiguousarray(codes, np.int8)
    off = np.ascontiguousarray(off, np.int64)
    ln = np.ascontiguousarray(ln, np.int32)
    out = np.empty((n, pad // 4), np.uint8)
    bad = lib.gt_bsw_pack_rows(codes.ctypes.data, off.ctypes.data,
                               ln.ctypes.data, n, pad, bias,
                               out.ctypes.data)
    return out, int(bad)


def bsw_pad_rows_native(codes: np.ndarray, off: np.ndarray, ln: np.ndarray,
                        pad: int, bias: int = 0, fill: int = 4):
    """Raw int8 [n, pad] rows (pad columns = fill), or None."""
    lib = _pairs_lib()
    if not lib:
        return None
    n = len(ln)
    codes = np.ascontiguousarray(codes, np.int8)
    off = np.ascontiguousarray(off, np.int64)
    ln = np.ascontiguousarray(ln, np.int32)
    out = np.empty((n, pad), np.int8)
    lib.gt_bsw_pad_rows(codes.ctypes.data, off.ctypes.data, ln.ctypes.data,
                        n, pad, bias, fill, out.ctypes.data)
    return out


def kmer_count_native(codes: np.ndarray, offs: np.ndarray,
                      lens: np.ndarray, k: int, min_len: int,
                      saturation: int, log2_slots: int):
    """Host hash-counting engine (native/kmercnt.cpp): returns
    (total_kmers, hash_size, occurrences) or None.  Retries with a
    doubled table when the 90% load cap trips."""
    import ctypes

    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_kmer_ready"):
        lib.gt_kmer_count.restype = ctypes.c_int32
        lib.gt_kmer_count.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64]
            + [ctypes.c_int32] * 4 + [ctypes.c_void_p] * 3)
        lib._kmer_ready = True
    codes = np.ascontiguousarray(codes, np.int8)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    out = np.zeros(3, np.int64)
    while log2_slots < 34:
        rc = lib.gt_kmer_count(
            codes.ctypes.data, offs.ctypes.data, lens.ctypes.data,
            len(lens), k, min_len, saturation, log2_slots,
            out[0:].ctypes.data, out[1:].ctypes.data, out[2:].ctypes.data)
        if rc == 0:
            return int(out[0]), int(out[1]), int(out[2])
        if rc != 1:  # rc==2: table mmap failed — a LARGER retry can't help
            return None
        log2_slots += 1  # rc==1: 90% load cap tripped — grow and retry
    return None


def sais(codes: np.ndarray, out: np.ndarray | None = None
         ) -> np.ndarray | None:
    """Suffix array of int8/uint8 codes in [0, 255) via native SA-IS.

    Returns int64[n], or None when the native library isn't built.
    `out` (contiguous int64[n]) avoids allocating the result here — at
    genome scale a fresh multi-GB buffer pays heavy first-touch page
    faults, so callers embedding the SA in a larger array pass a view.
    """
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_sais_ready"):
        lib.gt_sais_u8.restype = ctypes.c_int
        lib.gt_sais_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib._sais_ready = True
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    shifted = codes + 1  # reserve 0 for the internal sentinel
    n = len(shifted)
    if out is not None:
        assert out.dtype == np.int64 and out.flags.c_contiguous and len(out) == n
        sa = out
    else:
        sa = np.empty(n, np.int64)
    k = int(shifted.max()) + 1 if n else 1
    rc = lib.gt_sais_u8(shifted.ctypes.data, n, k, sa.ctypes.data)
    if rc != 0:
        return None
    return sa


def read_bam_native(path: str):
    """Native BGZF+BAM parse into columnar arrays, or None if unavailable.

    Returns (refs [(name, len)], cols dict) where cols has ref_id, pos,
    mapq, flag (i32[N]); name_off/cigar_off/seq_off (i64[N+1] exclusive
    prefixes); names (bytes); cigar (u32 raw words); seq_nt16, qual (u8).
    """
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_bam_ready"):
        lib.gt_bam_open.restype = ctypes.c_void_p
        lib.gt_bam_open.argtypes = [ctypes.c_char_p]
        for fn in ("gt_bam_n_records", "gt_bam_n_refs", "gt_bam_names_bytes",
                   "gt_bam_cigar_words", "gt_bam_seq_bytes",
                   "gt_bam_refnames_bytes"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.gt_bam_copy_refs.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 2
        lib.gt_bam_copy_out.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 11
        lib.gt_bam_free.argtypes = [ctypes.c_void_p]
        lib._bam_ready = True
    h = lib.gt_bam_open(os.fsencode(path))
    if not h:
        return None
    try:
        n = lib.gt_bam_n_records(h)
        n_refs = lib.gt_bam_n_refs(h)
        rn_bytes = lib.gt_bam_refnames_bytes(h)
        rn = ctypes.create_string_buffer(int(rn_bytes))
        rlens = np.empty(n_refs, np.int64)
        lib.gt_bam_copy_refs(h, rn, rlens.ctypes.data_as(ctypes.c_void_p))
        names_list = rn.raw.decode().split("\n")[:n_refs]
        refs = list(zip(names_list, rlens.tolist()))

        cols = {
            "ref_id": np.empty(n, np.int32),
            "pos": np.empty(n, np.int32),
            "mapq": np.empty(n, np.int32),
            "flag": np.empty(n, np.int32),
            "name_off": np.empty(n + 1, np.int64),
            "cigar_off": np.empty(n + 1, np.int64),
            "seq_off": np.empty(n + 1, np.int64),
            "cigar": np.empty(lib.gt_bam_cigar_words(h), np.uint32),
            "seq_nt16": np.empty(lib.gt_bam_seq_bytes(h), np.uint8),
            "qual": np.empty(lib.gt_bam_seq_bytes(h), np.uint8),
        }
        names_buf = ctypes.create_string_buffer(int(lib.gt_bam_names_bytes(h)))
        lib.gt_bam_copy_out(
            h,
            *(cols[k].ctypes.data_as(ctypes.c_void_p)
              for k in ("ref_id", "pos", "mapq", "flag", "name_off")),
            names_buf,
            *(cols[k].ctypes.data_as(ctypes.c_void_p)
              for k in ("cigar_off", "cigar", "seq_off", "seq_nt16", "qual")),
        )
        cols["names"] = names_buf.raw
    finally:
        lib.gt_bam_free(h)
    return refs, cols


def read_bam_region_native(path: str, voff_lo: int, voff_hi: int,
                           ref_id: int, beg: int, end: int,
                           filter_flags: int = 0, min_mapq: int = 0):
    """Native .bai-bounded region decode into columnar arrays, or None.

    voff_lo/voff_hi: the virtual-offset window from the .bai (the same
    bounds io/bam.py read_bam_region computes); records overlapping
    [beg, end) on ref_id only, optionally flag/mapq pre-filtered.
    Returns cols like read_bam_native plus 'span' (i32[N] reference
    span per record).  The streaming BGZF inflate keeps memory
    region-sized."""
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_bam_region_ready"):
        lib.gt_bam_open_region.restype = ctypes.c_void_p
        lib.gt_bam_open_region.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32]
        lib.gt_bam_copy_span.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib._bam_region_ready = True
    if not hasattr(lib, "_bam_ready"):
        # bind the shared getters without opening the whole file
        lib.gt_bam_open.restype = ctypes.c_void_p
        lib.gt_bam_open.argtypes = [ctypes.c_char_p]
        for fn in ("gt_bam_n_records", "gt_bam_n_refs",
                   "gt_bam_names_bytes", "gt_bam_cigar_words",
                   "gt_bam_seq_bytes", "gt_bam_refnames_bytes"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.gt_bam_copy_refs.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 2
        lib.gt_bam_copy_out.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 11
        lib.gt_bam_free.argtypes = [ctypes.c_void_p]
        lib._bam_ready = True
    h = lib.gt_bam_open_region(os.fsencode(path), voff_lo, voff_hi,
                               ref_id, beg, end, filter_flags, min_mapq)
    if not h:
        return None
    try:
        n = lib.gt_bam_n_records(h)
        cols = {
            "ref_id": np.empty(n, np.int32),
            "pos": np.empty(n, np.int32),
            "mapq": np.empty(n, np.int32),
            "flag": np.empty(n, np.int32),
            "name_off": np.empty(n + 1, np.int64),
            "cigar_off": np.empty(n + 1, np.int64),
            "seq_off": np.empty(n + 1, np.int64),
            "cigar": np.empty(lib.gt_bam_cigar_words(h), np.uint32),
            "seq_nt16": np.empty(lib.gt_bam_seq_bytes(h), np.uint8),
            "qual": np.empty(lib.gt_bam_seq_bytes(h), np.uint8),
            "span": np.empty(n, np.int32),
        }
        names_buf = ctypes.create_string_buffer(
            int(lib.gt_bam_names_bytes(h)))
        lib.gt_bam_copy_out(
            h,
            *(cols[k].ctypes.data_as(ctypes.c_void_p)
              for k in ("ref_id", "pos", "mapq", "flag", "name_off")),
            names_buf,
            *(cols[k].ctypes.data_as(ctypes.c_void_p)
              for k in ("cigar_off", "cigar", "seq_off", "seq_nt16",
                        "qual")),
        )
        lib.gt_bam_copy_span(h, cols["span"].ctypes.data_as(ctypes.c_void_p))
        cols["names"] = names_buf.raw
    finally:
        lib.gt_bam_free(h)
    return cols


SB_BLOCKS = 1 << 16  # v2 superblock stride (blocks); see fmsearch.cpp


def _hostpack32(didx):
    """v2 compressed occ layout: [blocks, 8] u32 rows (4 per-base counts
    relative to the superblock + 2-bit-plane words for 64 positions,
    fmsearch.cpp occ4 v2) and the [n_sb, 4] int64 superblock table.
    Half of v1's 64 B/row: same lines per lookup, half the pages and
    twice the LLC coverage.  Persisted as a mmap-able sidecar like the
    v1 rows."""
    pack = getattr(didx, "_host_pack32", None)
    if pack is not None:
        return pack, didx._host_sb32
    import os as _os

    cc = np.ascontiguousarray(didx.cp_count)
    blocks = cc.shape[0]
    sb = np.ascontiguousarray(cc[::SB_BLOCKS].astype(np.int64))
    cache = getattr(didx, "_npz_path", None)
    cache = cache + ".hostpack32.npy" if cache else None
    if cache and _os.path.exists(cache) and (
            _os.path.getmtime(cache) >= _os.path.getmtime(didx._npz_path)):
        m = np.load(cache, mmap_mode="r")
        if m.shape == (blocks, 8) and m.dtype == np.uint32:
            pack = m
    if pack is None:
        pack = np.empty((blocks, 8), np.uint32)
        # relative counts, superblock-chunked (no [blocks, 4] i64 temp)
        for s0 in range(0, blocks, SB_BLOCKS):
            s1 = min(s0 + SB_BLOCKS, blocks)
            pack[s0:s1, 0:4] = (cc[s0:s1] - sb[s0 // SB_BLOCKS]).astype(
                np.uint32)
        oh_hi, oh_lo = didx.one_hot_hi, didx.one_hot_lo
        pack[:, 4] = oh_hi[:, 2] | oh_hi[:, 3]  # hi plane, positions 0..31
        pack[:, 5] = oh_lo[:, 2] | oh_lo[:, 3]  # hi plane, positions 32..63
        pack[:, 6] = oh_hi[:, 1] | oh_hi[:, 3]  # lo plane, positions 0..31
        pack[:, 7] = oh_lo[:, 1] | oh_lo[:, 3]  # lo plane, positions 32..63
        if cache:
            try:
                np.save(cache, pack)
            except OSError:
                pass
    didx._host_pack32, didx._host_sb32 = pack, sb
    return pack, sb


def _huge_copy(lib, didx, pack, attr):
    """Copy an occ table into an anonymous THP-backed mapping (one per
    process): file-backed .npy mmaps sit on 4 KiB page-cache pages, and
    at genome scale every occ row is a dTLB miss + page walk.  2 MiB
    pages cut the walk depth; the copy itself is outside the search
    timer (index-load work, like the reference's load_index)."""
    cached = getattr(didx, attr, None)
    if cached is not None and cached.shape == pack.shape:
        return cached
    if not hasattr(lib, "_pages_ready"):
        lib.gt_alloc_pages.restype = ctypes.c_void_p
        lib.gt_alloc_pages.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.gt_free_pages.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib._pages_ready = True
    ptr = lib.gt_alloc_pages(pack.nbytes, 1)
    if not ptr:
        return pack
    buf = np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint32)),
        shape=pack.shape)
    np.copyto(buf, pack)
    setattr(didx, attr, buf)
    return buf


def fmi_search_native(didx, enc_codes: np.ndarray, lengths: np.ndarray,
                      min_seed_len: int = 19, split_width: int = 10,
                      max_mem_intv: int = 20, split_factor: float = 1.5,
                      threads: int | None = None,
                      pack_mode: int | None = None):
    """Host 3-phase SMEM search over the packed index (native/fmsearch.cpp).

    didx: index.fmi_index.DeviceFmIndex; enc_codes: [B, L] int8/int32
    codes (>=4 ambiguous); lengths: [B].  Returns (smem dict int64 arrays
    in phase order, n1, n2, n3) or None when the library isn't built.

    pack_mode 32 (default; GT_FMI_PACK overrides) uses the compressed
    bit-plane rows; 64 the reference-shaped CP_OCC rows.  GT_FMI_HUGE=0
    disables the THP staging copy for genome-scale tables.
    """
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_fmi_ready"):
        lib.gt_fmi_run.restype = ctypes.c_void_p
        lib.gt_fmi_run.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int,
        ]
        lib.gt_fmi_run2.restype = ctypes.c_void_p
        lib.gt_fmi_run2.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int,
        ]
        for fn in ("gt_fmi_n1", "gt_fmi_n2", "gt_fmi_n3"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.gt_fmi_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
        lib.gt_fmi_free.argtypes = [ctypes.c_void_p]
        lib._fmi_ready = True

    import os as _os

    if threads is None:
        threads = max(_os.cpu_count() or 1, 1)
    if pack_mode is None:
        pack_mode = int(_os.environ.get("GT_FMI_PACK", "32"))
    huge_env = _os.environ.get("GT_FMI_HUGE")
    pack = getattr(didx, "_host_pack", None)
    if pack_mode == 32:
        pack32, sb = _hostpack32(didx)
        # THP staging pays off once the table dwarfs the dTLB reach;
        # default on past 1 GB, env-overridable either way
        huge = (pack32.nbytes > (1 << 30)) if huge_env is None \
            else huge_env not in ("0", "")
        if huge:
            pack32 = _huge_copy(lib, didx, pack32, "_host_pack32_huge")
    elif pack is None:
        # Packed 64-byte occ rows are part of index LOADING for the host
        # engine (the reference's load_index materializes cp_occ the same
        # way, FMI_search.cpp:469-588, outside its kernel timer).  At
        # genome scale the build is a multi-GB strided copy, so persist
        # it as a mmap-able sidecar next to the npz: warm CLI starts
        # skip the build and the OS pages rows in on demand.
        cache = getattr(didx, "_npz_path", None)
        cache = cache + ".hostpack.npy" if cache else None
        blocks = didx.cp_count.shape[0]
        if cache and _os.path.exists(cache) and (
                _os.path.getmtime(cache) >= _os.path.getmtime(didx._npz_path)):
            m = np.load(cache, mmap_mode="r")
            if m.shape == (blocks, 16) and m.dtype == np.uint32:
                pack = m
        if pack is None:  # build the 64-byte rows once per index
            cc = np.ascontiguousarray(didx.cp_count)
            pack = np.empty((cc.shape[0], 16), np.uint32)
            if cc.dtype == np.int64 and cc.dtype.byteorder in ("=", "<"):
                # genome-scale path: counts are non-negative int64 — the
                # little-endian u32 view gives lo/hi words without the 512 MB
                # uint64 temp (15.3 -> 2.2 s at 256 Mbp)
                v = cc.view(np.uint32).reshape(cc.shape[0], 8)
                pack[:, 0:4] = v[:, 0::2]
                pack[:, 4:8] = v[:, 1::2]
            else:
                cnt = cc.astype(np.uint64)
                pack[:, 0:4] = (cnt & 0xFFFFFFFF).astype(np.uint32)
                pack[:, 4:8] = (cnt >> 32).astype(np.uint32)
            pack[:, 8:12] = didx.one_hot_hi
            pack[:, 12:16] = didx.one_hot_lo
            if cache:
                try:
                    np.save(cache, pack)
                except OSError:
                    pass  # read-only index dir: keep the in-memory rows
        didx._host_pack = pack
    if pack_mode != 32 and huge_env not in (None, "0", ""):
        pack = _huge_copy(lib, didx, pack, "_host_pack_huge")
    count5 = np.ascontiguousarray(np.asarray(didx.count, np.int64))

    b = enc_codes.shape[0]
    flat = np.ascontiguousarray(enc_codes.astype(np.int8).ravel())
    offs = np.ascontiguousarray(
        (np.arange(b, dtype=np.int64) * enc_codes.shape[1]))
    lens = np.ascontiguousarray(lengths.astype(np.int32))

    if pack_mode == 32:
        h = lib.gt_fmi_run2(
            pack32.ctypes.data_as(ctypes.c_void_p),
            sb.ctypes.data_as(ctypes.c_void_p),
            count5.ctypes.data_as(ctypes.c_void_p),
            int(didx.sentinel_index),
            flat.ctypes.data_as(ctypes.c_void_p),
            offs.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            b, min_seed_len, split_width, max_mem_intv, split_factor,
            threads,
        )
    else:
        h = lib.gt_fmi_run(
            pack.ctypes.data_as(ctypes.c_void_p),
            count5.ctypes.data_as(ctypes.c_void_p),
            int(didx.sentinel_index),
            flat.ctypes.data_as(ctypes.c_void_p),
            offs.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            b, min_seed_len, split_width, max_mem_intv, split_factor,
            threads,
        )
    try:
        n1, n2, n3 = lib.gt_fmi_n1(h), lib.gt_fmi_n2(h), lib.gt_fmi_n3(h)
        total = n1 + n2 + n3
        out = {key: np.empty(total, np.int64)
               for key in ("rid", "m", "n", "k", "l", "s")}
        lib.gt_fmi_copy(h, *(out[key].ctypes.data_as(ctypes.c_void_p)
                             for key in ("rid", "m", "n", "k", "l", "s")))
    finally:
        lib.gt_fmi_free(h)
    return out, int(n1), int(n2), int(n3)


def detect_events_native(raw: np.ndarray):
    """Native scrappie event detection; returns the oracle's structured
    array or None when the library isn't built."""
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_ev_ready"):
        lib.gt_detect_events.restype = ctypes.c_int64
        lib.gt_detect_events.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib._ev_ready = True
    raw = np.ascontiguousarray(raw, np.float32)
    cap = max(len(raw), 16)
    start = np.empty(cap, np.uint64)
    length = np.empty(cap, np.float32)
    mean = np.empty(cap, np.float32)
    stdv = np.empty(cap, np.float32)
    n = lib.gt_detect_events(
        raw.ctypes.data_as(ctypes.c_void_p), len(raw),
        start.ctypes.data_as(ctypes.c_void_p),
        length.ctypes.data_as(ctypes.c_void_p),
        mean.ctypes.data_as(ctypes.c_void_p),
        stdv.ctypes.data_as(ctypes.c_void_p), cap,
    )
    ev = np.zeros(n, dtype=[("start", np.uint64), ("length", np.float32),
                            ("mean", np.float32), ("stdv", np.float32)])
    ev["start"] = start[:n]
    ev["length"] = length[:n]
    ev["mean"] = mean[:n]
    ev["stdv"] = stdv[:n]
    return ev


def abea_traceback_native(trace, bll_e, lv, ranks, events, model,
                          scales, shifts, ne, nk, bw, lp_trim):
    """Native abea traceback+QC for one bucket group (native/abea_tb.cpp,
    bit-exact transcription of ops/abea._traceback).  Returns a list of
    [(kmer_idx, event_idx)] per read, or None when the lib isn't built.

    trace: [G, nb_max, bw] u8 (full, rows 0/1 seeded); bll_e: [G, nb_max]
    i64; lv: [G, nb_max-2] f64; ranks: [G, nk_max] i32; events: [G, ne_max]
    f32; ne/nk: [G] i64.
    """
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_abea_tb_ready"):
        lib.gt_abea_traceback.restype = ctypes.c_int
        lib.gt_abea_traceback.argtypes = (
            [ctypes.c_int64] + [ctypes.c_void_p] * 12 + [ctypes.c_int64] * 4
            + [ctypes.c_double] + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
        )
        lib._abea_tb_ready = True
    g_n, nb_max, bw_a = trace.shape
    assert bw_a == bw
    trace = np.ascontiguousarray(trace, np.uint8)
    bll_e = np.ascontiguousarray(bll_e, np.int64)
    lv = np.ascontiguousarray(lv, np.float64)
    ranks = np.ascontiguousarray(ranks, np.int32)
    events = np.ascontiguousarray(events, np.float32)
    lm = np.ascontiguousarray(model["level_mean"], np.float32)
    ls = np.ascontiguousarray(model["level_stdv"], np.float32)
    lls = np.ascontiguousarray(model["level_log_stdv"], np.float32)
    sc = np.ascontiguousarray(scales, np.float32)
    sh = np.ascontiguousarray(shifts, np.float32)
    ne = np.ascontiguousarray(ne, np.int64)
    nk = np.ascontiguousarray(nk, np.int64)
    cap = int(ne.max() + nk.max())
    out_pairs = np.empty((g_n, 2 * cap), np.int32)
    out_n = np.empty(g_n, np.int64)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.gt_abea_traceback(
        g_n, p(trace), p(bll_e), p(lv), p(ranks), p(events),
        p(lm), p(ls), p(lls), p(sc), p(sh), p(ne), p(nk),
        nb_max, bw, ranks.shape[1], events.shape[1],
        float(lp_trim), p(out_pairs), p(out_n), cap)
    if rc != 0:
        raise RuntimeError(f"gt_abea_traceback failed rc={rc}")
    results = []
    for g in range(g_n):
        n = int(out_n[g])
        pr = out_pairs[g, : 2 * n].reshape(n, 2)
        results.append(list(zip(pr[:, 0].tolist(), pr[:, 1].tolist())))
    return results


def ctc_beam_native(log_probs, beam_size: int, threshold: float):
    """Native CTC prefix beam search (native/ctc_beam.cpp, same contract
    as models.bonito.beam_search_decode).  Returns the label list, or
    None when the lib isn't built."""
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_ctc_ready"):
        lib.gt_ctc_beam.restype = ctypes.c_int64
        lib.gt_ctc_beam.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib._ctc_ready = True
    lp = np.ascontiguousarray(log_probs, np.float32)
    t_len, n_class = lp.shape
    cap = t_len + 1
    out = np.empty(cap, np.int32)
    n = lib.gt_ctc_beam(
        lp.ctypes.data_as(ctypes.c_void_p), t_len, n_class,
        beam_size, float(threshold),
        out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        raise RuntimeError("gt_ctc_beam output overflow")
    return out[:n].tolist()


def minimizer_counts_native(reads_codes, k: int, window: int,
                            min_read_length: int):
    """Flye minimizer counting (native/minimizers.cpp; contract =
    ops.oracle.kmer.yield_minimizers + canonical Counter).  reads_codes:
    list of uint8 2-bit code arrays.  Returns {canonical_code: count} or
    None when the lib isn't built."""
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_mini_ready"):
        lib.gt_minimizers_count.restype = ctypes.c_void_p
        lib.gt_minimizers_count.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.gt_minimizers_size.restype = ctypes.c_int64
        lib.gt_minimizers_size.argtypes = [ctypes.c_void_p]
        lib.gt_minimizers_copy.argtypes = [ctypes.c_void_p] * 3
        lib.gt_minimizers_free.argtypes = [ctypes.c_void_p]
        lib._mini_ready = True
    lengths = np.array([len(c) for c in reads_codes], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    flat = (np.concatenate(reads_codes).astype(np.uint8)
            if len(reads_codes) else np.zeros(0, np.uint8))
    h = lib.gt_minimizers_count(
        flat.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        lengths.ctypes.data_as(ctypes.c_void_p),
        len(reads_codes), k, window, min_read_length)
    try:
        n = lib.gt_minimizers_size(h)
        keys = np.empty(n, np.uint64)
        counts = np.empty(n, np.int64)
        lib.gt_minimizers_copy(h, keys.ctypes.data_as(ctypes.c_void_p),
                               counts.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.gt_minimizers_free(h)
    return dict(zip(keys.tolist(), counts.tolist()))


def dbg_window_native(ref_seq: str, ref_start: int, reads,
                      kmer_size: int, min_qual: int, min_reads: int):
    """Native colored-DBG window assembly (native/dbg.cpp; contract =
    ops.dbg.assemble_window).  reads: list of (seq, quals, flag).
    Returns (n_nodes, [bubble path sequences]) or None when unbuilt."""
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_dbg_ready"):
        lib.gt_dbg_window.restype = ctypes.c_void_p
        lib.gt_dbg_window.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        for fn in ("gt_dbg_n_nodes", "gt_dbg_n_bubbles", "gt_dbg_seq_bytes"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.gt_dbg_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.gt_dbg_free.argtypes = [ctypes.c_void_p]
        lib._dbg_ready = True
    seqs = b"".join(s.encode() for s, _q, _f in reads)
    lens = np.array([len(s) for s, _q, _f in reads], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    quals = (np.concatenate([np.asarray(q, np.uint8) for _s, q, _f in reads])
             if reads else np.zeros(0, np.uint8))
    flags = np.array([f for _s, _q, f in reads], np.int32)
    h = lib.gt_dbg_window(
        ref_seq.encode(), len(ref_seq), ref_start,
        seqs, offs.ctypes.data_as(ctypes.c_void_p),
        quals.ctypes.data_as(ctypes.c_void_p),
        flags.ctypes.data_as(ctypes.c_void_p), len(reads),
        kmer_size, min_qual, min_reads)
    try:
        n_nodes = lib.gt_dbg_n_nodes(h)
        nb = lib.gt_dbg_seq_bytes(h)
        buf = ctypes.create_string_buffer(int(nb))
        lib.gt_dbg_copy(h, buf)
        bubbles = buf.raw.decode().split("\n")[:-1] if nb else []
    finally:
        lib.gt_dbg_free(h)
    return n_nodes, bubbles


def pileup_events_native(records, num2countbase, del_fwd, del_rev,
                         num_homop: int):
    """Batched medaka event extraction (native/pileup_events.cpp; contract
    = ops.pileup read_events fast path, applied to every record in one
    call).  records: list of BamRecord-likes already filtered for
    flags/mapq.  Returns (pos, minor, feat, qstrat, rec_id, ins_pos,
    ins_len) int arrays, or None when unbuilt."""
    lib = _load()
    if not lib:
        return None
    from .bam import CIGAR_OPS

    op_idx = {c: i for i, c in enumerate(CIGAR_OPS)}
    seq = (np.concatenate([np.asarray(r.seq_nt16, np.uint8) for r in records])
           if records else np.zeros(0, np.uint8))
    qual = (np.concatenate([np.asarray(r.qual, np.uint8) for r in records])
            if records else np.zeros(0, np.uint8))
    seq_off = np.concatenate(
        [[0], np.cumsum([len(r.seq_nt16) for r in records])]).astype(np.int64)
    cig = [np.array([(ln << 4) | op_idx[op] for op, ln in r.cigar], np.uint32)
           for r in records]
    cigar = np.concatenate(cig) if cig else np.zeros(0, np.uint32)
    cigar_off = np.concatenate(
        [[0], np.cumsum([len(c) for c in cig])]).astype(np.int64)
    rpos = np.array([r.pos for r in records], np.int64)
    rev = np.array([1 if r.is_reverse else 0 for r in records], np.uint8)
    return pileup_events_cols_native(seq, qual, seq_off, cigar, cigar_off,
                                     rpos, rev, num2countbase, del_fwd,
                                     del_rev, num_homop)


def pileup_events_cols_native(seq, qual, seq_off, cigar, cigar_off, rpos,
                              rev, num2countbase, del_fwd, del_rev,
                              num_homop: int):
    """pileup_events_native on pre-columnar buffers — the layout
    read_bam_region_native returns, so the fused BAM-region pileup path
    never builds Python record objects."""
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_pileup_ready"):
        lib.gt_pileup_events.restype = ctypes.c_void_p
        lib.gt_pileup_events.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int64]
            + [ctypes.c_void_p] + [ctypes.c_int64] * 3
        )
        for fn in ("gt_pileup_n_events", "gt_pileup_n_ins"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.gt_pileup_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
        lib.gt_pileup_free.argtypes = [ctypes.c_void_p]
        lib._pileup_ready = True
    seq = np.ascontiguousarray(seq, np.uint8)
    qual = np.ascontiguousarray(qual, np.uint8)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    cigar = np.ascontiguousarray(cigar, np.uint32)
    cigar_off = np.ascontiguousarray(cigar_off, np.int64)
    rpos = np.ascontiguousarray(rpos, np.int64)
    rev = np.ascontiguousarray(rev, np.uint8)
    tbl = np.asarray(num2countbase, np.int64)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    h = lib.gt_pileup_events(
        p(seq), p(qual), p(seq_off), p(cigar), p(cigar_off), p(rpos), p(rev),
        len(rpos), p(tbl), del_fwd, del_rev, num_homop)
    try:
        n = lib.gt_pileup_n_events(h)
        ni = lib.gt_pileup_n_ins(h)
        pos = np.empty(n, np.int64)
        minor = np.empty(n, np.int64)
        feat = np.empty(n, np.int64)
        qstrat = np.empty(n, np.int64)
        rec_id = np.empty(n, np.int32)
        ins_pos = np.empty(ni, np.int64)
        ins_len = np.empty(ni, np.int64)
        lib.gt_pileup_copy(h, p(pos), p(minor), p(feat), p(qstrat),
                           p(rec_id), p(ins_pos), p(ins_len))
    finally:
        lib.gt_pileup_free(h)
    return pos, minor, feat, qstrat, rec_id, ins_pos, ins_len


def pileup_matrix_native(cols, start: int, end: int, num2countbase,
                         del_fwd, del_rev, num_homop: int, featlen: int):
    """Fused native pileup: event extraction + coverage + insertion
    widths + the (col, feature) histogram all in C on the columnar
    region arrays (read_bam_region_native output) — events never cross
    into numpy.  Returns (major, minor, matrix[n_cols, featlen*homop])
    or None."""
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_pileup_mat_ready"):
        lib.gt_pileup_layout.restype = ctypes.c_void_p
        lib.gt_pileup_layout.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3)
        lib.gt_pileup_layout_cols.restype = ctypes.c_int64
        lib.gt_pileup_layout_cols.argtypes = [ctypes.c_void_p]
        lib.gt_pileup_fill.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int64]
            + [ctypes.c_void_p] + [ctypes.c_int64] * 4
            + [ctypes.c_void_p] * 3)
        lib.gt_pileup_layout_free.argtypes = [ctypes.c_void_p]
        lib._pileup_mat_ready = True
    seq = np.ascontiguousarray(cols["seq_nt16"], np.uint8)
    qual = np.ascontiguousarray(cols["qual"], np.uint8)
    seq_off = np.ascontiguousarray(cols["seq_off"], np.int64)
    cigar = np.ascontiguousarray(cols["cigar"], np.uint32)
    cigar_off = np.ascontiguousarray(cols["cigar_off"], np.int64)
    rpos = np.ascontiguousarray(cols["pos"], np.int64)
    rev = np.ascontiguousarray(((cols["flag"] & 16) != 0), np.uint8)
    span = np.ascontiguousarray(cols["span"], np.int32)
    tbl = np.asarray(num2countbase, np.int64)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    L = lib.gt_pileup_layout(p(cigar), p(cigar_off), p(rpos), p(span),
                             len(rpos), start, end)
    try:
        n_cols = lib.gt_pileup_layout_cols(L)
        major = np.empty(n_cols, np.int64)
        minor = np.empty(n_cols, np.int64)
        # int32 counts (bounded by coverage depth): half the fresh-page
        # fault churn of an int64 matrix per chunk
        matrix = np.zeros((n_cols, featlen * num_homop), np.int32)
        lib.gt_pileup_fill(L, p(seq), p(qual), p(seq_off), p(cigar),
                           p(cigar_off), p(rpos), p(rev), len(rpos),
                           p(tbl), del_fwd, del_rev, num_homop, featlen,
                           p(major), p(minor), p(matrix))
    finally:
        lib.gt_pileup_layout_free(L)
    return major, minor, matrix


def eventalign_realign_native(ref_codes, ref_offset, segments, rc,
                              read_length, ev_mean, sc, model, b2e,
                              events_per_base):
    """Native f5c eventalign realign (native/eventalign.cpp, bit-exact
    contract with ops/oracle/eventalign.align_read_to_ref).  ``segments``
    is the pre-trimmed [(ref_pos, read_pos)] list-of-lists from the cigar
    walk; returns (ref_pos[i32], event_idx[i32], state[bytes]) arrays or
    None when the lib isn't built."""
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_eventalign_ready"):
        lib.gt_eventalign_realign.restype = ctypes.c_int64
        lib.gt_eventalign_realign.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int64]
            + [ctypes.c_int32, ctypes.c_int64]
            + [ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 3
            + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_double]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int64]
        )
        lib._eventalign_ready = True
    ref_codes = np.ascontiguousarray(ref_codes, np.uint8)
    pair_ref = np.ascontiguousarray(
        [p[0] for seg in segments for p in seg], np.int32)
    pair_read = np.ascontiguousarray(
        [p[1] for seg in segments for p in seg], np.int32)
    seg_off = np.zeros(len(segments) + 1, np.int64)
    np.cumsum([len(s) for s in segments], out=seg_off[1:])
    ev_mean = np.ascontiguousarray(ev_mean, np.float32)
    lm = np.ascontiguousarray(model["level_mean"], np.float32)
    ls = np.ascontiguousarray(model["level_stdv"], np.float32)
    lls = np.ascontiguousarray(model["level_log_stdv"], np.float32)
    b2e = np.ascontiguousarray(b2e, np.int32)
    cap = int(2 * len(ev_mean) + 1024)
    out_rp = np.empty(cap, np.int32)
    out_ei = np.empty(cap, np.int32)
    out_st = np.empty(cap, np.uint8)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    n = lib.gt_eventalign_realign(
        p(ref_codes), len(ref_codes), int(ref_offset),
        p(pair_ref), p(pair_read), p(seg_off), len(segments),
        1 if rc else 0, int(read_length),
        p(ev_mean), len(ev_mean),
        float(sc["shift"]), float(sc["scale"]), float(sc["var"]),
        float(sc["log_var"]),
        p(lm), p(ls), p(lls), p(b2e), len(b2e), float(events_per_base),
        p(out_rp), p(out_ei), p(out_st), cap)
    if n < 0:
        raise RuntimeError("gt_eventalign_realign: output capacity exceeded")
    return out_rp[:n].copy(), out_ei[:n].copy(), out_st[:n].tobytes()


def eventalign_emit_native(rp, ei, kblob, mkblob, kmer_size, em, es, ed,
                           mm, ms, sl, ref_name, who):
    """Native TSV block emit (native/eventalign.cpp gt_eventalign_emit,
    byte-exact with the Python f-string path incl. the -nan guard).
    Returns the whole read's TSV text as one str, or None when the lib
    isn't built."""
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_ea_emit_ready"):
        lib.gt_eventalign_emit.restype = ctypes.c_int64
        lib.gt_eventalign_emit.argtypes = (
            [ctypes.c_int64] + [ctypes.c_void_p] * 2
            + [ctypes.c_char_p] * 2 + [ctypes.c_int64]
            + [ctypes.c_void_p] * 6 + [ctypes.c_char_p] * 2
            + [ctypes.c_void_p, ctypes.c_int64]
        )
        lib._ea_emit_ready = True
    n = int(rp.shape[0])
    rp = np.ascontiguousarray(rp, np.int32)
    ei = np.ascontiguousarray(ei, np.int32)
    cols = [np.ascontiguousarray(a, np.float64)
            for a in (em, es, ed, mm, ms, sl)]
    rn = ref_name.encode()
    wh = who.encode()
    cap = n * (320 + 2 * kmer_size + len(rn) + len(wh)) + 4096
    out = np.empty(cap, np.uint8)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    wrote = lib.gt_eventalign_emit(
        n, p(rp), p(ei), kblob, mkblob,
        int(kmer_size), *(p(a) for a in cols), rn, wh, p(out), cap)
    if wrote < 0:
        raise RuntimeError("gt_eventalign_emit: output capacity exceeded")
    return out[:wrote].tobytes().decode()
