"""Parser for the bsw pair-file format.

Format (benchmarks/bsw/main_banded.cpp:148-202 loadPairs): 3-line records
    <seed score h0>
    <reference string, ASCII-digit base codes ('0'..'4')>
    <query string>
Characters are decoded by subtracting 48 ('0').
"""

from __future__ import annotations

import numpy as np


def parse_pairs(path_or_file, max_pairs: int | None = None):
    """Returns list of (query_codes, target_codes, h0) numpy tuples.

    Single-pass bytes parser: newline offsets found with one vectorized
    scan and all base codes decoded with one subtract, so each record
    costs two zero-copy views instead of str encode + two copies (the
    reference's 10.6M-pair bsw_large file parses in ~45 s vs ~300 s
    for the line-at-a-time version, identical output).
    """
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
        if isinstance(data, str):
            data = data.encode()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()
    arr = np.frombuffer(data, np.uint8)
    nl = np.flatnonzero(arr == 10)
    n_lines = len(nl)
    if len(arr) and (not n_lines or nl[-1] != len(arr) - 1):
        # last line unterminated: treat EOF as a line end
        nl = np.append(nl, len(arr))
        n_lines += 1
    starts = np.empty(n_lines, np.int64)
    if n_lines:
        starts[0] = 0
        starts[1:] = nl[:-1] + 1
    codes = arr.astype(np.int8)
    codes -= 48  # separators decode to junk; only sequence slices are used
    out = []
    n = n_lines // 3
    if max_pairs is not None:
        n = min(n, max_pairs)
    # plain-int offset lists: numpy scalar indexing in the record loop
    # costs ~10x a list index at 10M records
    st = starts.tolist()
    en = nl.tolist()
    append = out.append
    for j in range(0, 3 * n, 3):
        # score line is "<h0> [tlen qlen...]": partition takes the first
        # token with or without trailing fields, no per-record exception
        h0 = int(data[st[j] : en[j]].partition(b" ")[0])
        append((codes[st[j + 2] : en[j + 2]],
                codes[st[j + 1] : en[j + 1]], h0))
    return out


def parse_pairs_soa(path_or_file, max_pairs: int | None = None):
    """Struct-of-arrays parse of the same format: no per-record Python.

    Returns a dict with the whole-file decoded code buffer plus per-pair
    offset/length/h0 arrays:
        codes [bytes] int8, q_off/t_off int64, q_len/t_len int32, h0 int32
    The per-record loop in parse_pairs (h0 int() + tuple build) is too
    slow at the reference's bsw_large scale (10.6M pairs,
    scripts/bsw_large:5-8); here h0 digits are parsed with
    a handful of vectorized gathers instead.  When the native library is
    built, the structural scan runs in C++ (native/pairsio.cpp): the
    numpy newline scan alone costs ~22 s on the 3.8 GB bsw_large file vs
    ~2 s for the single memchr pass."""
    mm = None
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
        if isinstance(data, str):
            data = data.encode()
        arr = np.frombuffer(data, np.uint8)
    else:
        # mmap instead of read(): the 3.8 GB bsw_large file need not be
        # copied; mapped pages are read in place by the native scan and the fused decode
        import mmap

        try:
            with open(path_or_file, "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
            arr = np.frombuffer(mm, np.uint8)
        except (ValueError, OSError):  # empty file / no mmap support
            arr = np.fromfile(path_or_file, np.uint8)

    from .native import parse_pairs_struct_native, sub48_native

    nat = parse_pairs_struct_native(arr) if len(arr) else None
    if nat is not None:
        t_off, t_len, q_off, q_len, h0 = nat
        n = len(h0)
        if max_pairs is not None and max_pairs < n:
            n = max_pairs
            t_off, t_len = t_off[:n], t_len[:n]
            q_off, q_len = q_off[:n], q_len[:n]
            h0 = h0[:n]
        codes = sub48_native(arr)
        return {"codes": codes, "t_off": t_off, "t_len": t_len,
                "q_off": q_off, "q_len": q_len, "h0": h0}
    if mm is not None:
        arr = np.array(arr)  # own the bytes before the mmap closes
    nl = np.flatnonzero(arr == 10)
    n_lines = len(nl)
    if len(arr) and (not n_lines or nl[-1] != len(arr) - 1):
        nl = np.append(nl, len(arr))
        n_lines += 1
    starts = np.empty(n_lines, np.int64)
    if n_lines:
        starts[0] = 0
        starts[1:] = nl[:-1] + 1
    codes = arr.astype(np.int8)
    codes -= 48
    n = n_lines // 3
    if max_pairs is not None:
        n = min(n, max_pairs)
    s0 = starts[0 : 3 * n : 3]
    e0 = nl[0 : 3 * n : 3]
    # vectorized h0 parse: optional '-' then digits until space/newline.
    # widths are data-bounded (h0 is a seed score), so the loop below is
    # over DIGIT POSITIONS (max ~10), not records.
    neg = np.zeros(n, bool)
    if n:
        neg = arr[s0] == ord("-")
    pos = s0 + neg
    h0 = np.zeros(n, np.int64)
    active = np.ones(n, bool)
    max_w = int((e0 - pos).max(initial=0))
    guard = len(arr) - 1
    for _ in range(max_w):
        c = arr[np.minimum(pos, guard)]
        is_dig = active & (pos < e0) & (c >= 48) & (c <= 57)
        h0[is_dig] = h0[is_dig] * 10 + (c[is_dig] - 48)
        active = is_dig
        if not active.any():
            break
        pos = pos + active
    h0[neg] = -h0[neg]
    return {
        "codes": codes,
        "t_off": starts[1 : 3 * n : 3],
        "t_len": (nl[1 : 3 * n : 3] - starts[1 : 3 * n : 3]).astype(np.int32),
        "q_off": starts[2 : 3 * n : 3],
        "q_len": (nl[2 : 3 * n : 3] - starts[2 : 3 * n : 3]).astype(np.int32),
        "h0": h0.astype(np.int32),
    }
