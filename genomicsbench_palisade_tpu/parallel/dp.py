"""Data-parallel kernel wrappers with explicit collectives (shard_map).

Patterns (SURVEY.md §2.4 equivalents):
  * phmm/bsw/chain: pure DP — batch dim sharded over the mesh, no
    cross-device traffic inside the step.
  * kmer counting: DP + key-range redistribution — each shard packs and
    canonicalizes its reads, k-mers are routed to their owner shard by the
    top bits of the code (ppermute-free all_to_all), counted locally by
    sort-reduce, and the scalar metrics merged with psum.  This replaces
    the reference's shared atomic counter array (vertex_index.cpp:575-595)
    with disjoint per-shard key ranges.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import kmer as kmer_ops
from ..ops import phmm as phmm_ops


def phmm_forward_sharded(mesh: Mesh, batch: dict, axis: str = "dp"):
    """Batch-sharded phmm forward; returns (log10, raw, fallback) sharded."""

    specs = {k: P(axis) for k in batch}

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(specs,),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    def step(b):
        return phmm_ops.phmm_forward(b)

    return step(batch)


def bsw_batch_sharded(mesh: Mesh, batch: dict, axis: str = "dp"):
    """Batch-sharded banded-SW extension (the reference's OpenMP loop over
    512-pair batches, main_banded.cpp:465+, as pure DP over the mesh)."""
    from ..ops import bsw as bsw_ops

    specs = {k: P(axis) for k in batch}
    out_keys = ("score", "qle", "tle", "gtle", "gscore", "max_off")

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(specs,),
        out_specs={k: P(axis) for k in out_keys},
        check_vma=False,
    )
    def step(b):
        return bsw_ops.bsw_batch(b)

    return step(batch)


def count_kmers_sharded(mesh: Mesh, bases, lengths, k: int = 17, axis: str = "dp",
                        return_shard_stats: bool = False):
    """Distributed canonical k-mer counting with key-range all_to_all.

    bases: [B, L] int32 (B divisible by mesh size), lengths: [B].
    Returns dict of replicated scalar metrics (total_kmers, hash_size,
    occurrences) identical to ops.kmer.count_kmers_device on the full set.
    With return_shard_stats, also returns per-shard (occurrences,
    distinct) AFTER the key-range all_to_all — the bucket-skew signal
    (vertex_index.cpp:515-659's per-thread load analog).
    """
    ndev = mesh.devices.size
    bits = max((ndev - 1).bit_length(), 0)
    code_bits = 2 * k

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(), P(), P(), P(axis), P(axis)),
        check_vma=False,
    )
    def step(b, ln):
        hi, lo, valid = kmer_ops.pack_kmers(b, ln, k)
        chi, clo = kmer_ops.canonical(hi, lo, k)
        inv = (~valid).astype(jnp.uint32).ravel()
        chi, clo = chi.ravel(), clo.ravel()
        n_loc = chi.shape[0]
        # owner shard = mixed hash of the canonical code mod ndev, a
        # disjoint key-class partition.  NO plain bit range is uniform
        # here: canonical = min(kmer, revcomp) biases the value low
        # (top-bit bucketing skews shard occupancy badly) AND biases the
        # last base away from T (low-bit bucketing skews too) — so avalanche the code first (murmur3 fmix32 halves).
        # Invalid windows keep their current shard (owner irrelevant,
        # they carry inv=1).
        if bits == 0:
            owner = jnp.zeros(n_loc, jnp.uint32)
        else:
            x = chi * jnp.uint32(0x85EBCA6B) ^ clo
            x ^= x >> 16
            x = x * jnp.uint32(0x85EBCA6B)
            x ^= x >> 13
            x = x * jnp.uint32(0xC2B2AE35)
            x ^= x >> 16
            owner = x % jnp.uint32(ndev)
        # sort locally by owner so each destination's k-mers are contiguous
        owner_s, inv_s, hi_s, lo_s = jax.lax.sort(
            (owner, inv, chi, clo), num_keys=1, is_stable=False
        )
        # per-destination slice starts/counts
        dest_ids = jnp.arange(ndev, dtype=jnp.uint32)
        starts = jnp.searchsorted(owner_s, dest_ids, side="left")
        ends = jnp.searchsorted(owner_s, dest_ids, side="right")
        counts = ends - starts
        # build padded [ndev, n_loc] send buffers
        pos = jax.lax.broadcasted_iota(jnp.int32, (ndev, n_loc), 1)
        gather_idx = jnp.minimum(starts[:, None] + pos, n_loc - 1)
        send_hi = hi_s[gather_idx]
        send_lo = lo_s[gather_idx]
        send_inv = jnp.where(pos < counts[:, None], inv_s[gather_idx], jnp.uint32(1))
        recv_hi = jax.lax.all_to_all(send_hi, axis, 0, 0, tiled=False)
        recv_lo = jax.lax.all_to_all(send_lo, axis, 0, 0, tiled=False)
        recv_inv = jax.lax.all_to_all(send_inv, axis, 0, 0, tiled=False)
        # local sort-reduce over this shard's key range
        inv2 = recv_inv.ravel()
        hi2 = recv_hi.ravel()
        lo2 = recv_lo.ravel()
        inv_r, hi_r, lo_r = jax.lax.sort((inv2, hi2, lo2), num_keys=3)
        n = hi_r.shape[0]
        valid_r = inv_r == 0
        new_run = jnp.ones(n, dtype=bool)
        new_run = new_run.at[1:].set(
            (hi_r[1:] != hi_r[:-1]) | (lo_r[1:] != lo_r[:-1]) | (valid_r[1:] != valid_r[:-1])
        )
        idx = jnp.arange(n, dtype=jnp.int32)
        run_start = jax.lax.cummax(jnp.where(new_run, idx, 0))
        run_len = idx - run_start + 1
        is_end = jnp.ones(n, dtype=bool)
        is_end = is_end.at[:-1].set(new_run[1:])
        total = jnp.sum(jnp.where(new_run & valid_r, 1, 0))
        over = jnp.sum(jnp.where(is_end & valid_r & (run_len > 15), 1, 0))
        occ = jnp.sum(valid_r.astype(jnp.int32))
        shard_occ = occ[None]
        shard_distinct = total[None]
        # scalar psum merges across disjoint key ranges
        total = jax.lax.psum(total, axis)
        over = jax.lax.psum(over, axis)
        occ = jax.lax.psum(occ, axis)
        return total, over, occ, shard_occ, shard_distinct

    total, over, occ, shard_occ, shard_distinct = step(bases, lengths)
    metrics = {"total_kmers": total, "hash_size": over, "occurrences": occ}
    if return_shard_stats:
        return metrics, {"occ": shard_occ, "distinct": shard_distinct}
    return metrics


def fmi_backward_search_sharded(mesh: Mesh, index: dict, enc, lengths,
                                axis: str = "dp"):
    """Exact-match backward search with the FM-index SHARDED across the
    mesh — the genome index is the suite's true "long context" (SURVEY
    §2.4/§5): hg38's cp_occ is ~6 GB, a large share of one device, so the
    packed 64-byte block rows are sharded by block range; each occ lookup
    gathers locally on the owner shard and is broadcast with one psum.
    Reads are replicated (tiny next to the index).

    enc: [B, L] i32 2-bit codes; lengths: [B].  Returns (k, l, s) [B]
    intervals of the full reads, identical to repeated ops.fmi
    backward_ext from the last base's root interval.
    """
    from ..ops.fmi import backward_ext_from_occ, occ_from_pack_row

    import numpy as _np

    cp_pack = index["cp_pack"]
    count = index["count"]
    sentinel = index["sentinel_index"]
    ndev = mesh.devices.size
    pad = (-cp_pack.shape[0]) % ndev
    # pad on the HOST and device_put with the row sharding directly: a
    # jnp.concatenate here would materialize the whole (hg38: ~6 GB)
    # index on the default device — the thing this function exists to
    # avoid — before shard_map resharded it
    cp_host = _np.asarray(cp_pack)
    if pad:
        cp_host = _np.concatenate(
            [cp_host, _np.zeros((pad, cp_host.shape[1]), cp_host.dtype)])
    cp_pack = jax.device_put(
        cp_host, NamedSharding(mesh, P(axis, None)))
    rows_per = cp_pack.shape[0] // ndev
    out_dt = count.dtype
    b, l_max = enc.shape

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(None, None), P(None), P(None)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def run(pack_local, enc_r, lengths_r, count_r):
        off = jax.lax.axis_index(axis).astype(jnp.int32) * rows_per

        def occ(pp):
            blk = (pp >> 6).astype(jnp.int32)
            loc = blk - off
            mine = (loc >= 0) & (loc < rows_per)
            row = pack_local[jnp.clip(loc, 0, rows_per - 1)]
            row = jnp.where(mine[..., None], row, 0)
            row = jax.lax.psum(row, axis)  # owner shard broadcasts the row
            return occ_from_pack_row(row, pp, out_dt)

        def base_at(pos):  # per-read base at a per-read position
            idx = jnp.clip(pos, 0, l_max - 1)[:, None]
            return jnp.take_along_axis(enc_r, idx, axis=1)[:, 0]

        a0 = base_at(lengths_r - 1)
        k = count_r[a0]
        l = count_r[3 - a0]
        s = count_r[a0 + 1] - count_r[a0]

        def step(t, kls):
            k, l, s = kls
            a = base_at(lengths_r - 2 - t)
            k2, l2, s2 = backward_ext_from_occ(
                count_r, sentinel, k, l, s, a, occ(k), occ(k + s))
            live = (t < lengths_r - 1) & (s > 0)
            return (jnp.where(live, k2, k), jnp.where(live, l2, l),
                    jnp.where(live, s2, s))

        return jax.lax.fori_loop(0, l_max - 1, step, (k, l, s))

    return run(cp_pack, jnp.asarray(enc), jnp.asarray(lengths), count)


def grm_sharded(mesh: Mesh, geno_i8, two_f, inv_stdev, ok, block: int = 512,
                axis: str = "dp"):
    """GRM with the VARIANT axis sharded across the mesh (model-parallel
    style index sharding, SURVEY.md §2.4): each shard normalizes and
    multiplies its variant block rows, partial Z^T Z / V^T V matrices are
    merged with a psum — the collective analog of plink2 accumulating
    dsyrk blocks (plink2_matrix_calc.cc:3668-3704).

    geno_i8: [M, N] with M divisible by mesh size. Returns (sums, counts)
    replicated [N, N] f32.
    """
    from ..ops.grm import _grm_device

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(g, tf, isd, okb):
        sums, counts = _grm_device(g, tf, isd, okb, block=block)
        return jax.lax.psum(sums, axis), jax.lax.psum(counts, axis)

    return step(geno_i8, two_f, inv_stdev, ok)


def chain_dp_halo_sharded(mesh: Mesh, call: dict, w: int, axis: str = "dp"):
    """ONE chain call with the ANCHOR axis sharded across the mesh — the
    workload's context-parallel analog (SURVEY.md §5): each shard runs the
    windowed DP over its contiguous anchor range after receiving the
    previous shard's trailing w-anchor window (x/q/score/parent/peak) via
    a ring ppermute.  Shards execute in pipeline order (anchor scores are
    sequentially dependent), so this trades no speedup for the ability to
    hold calls larger than one device's memory — exactly minimap2's
    sequential semantics, bit-exact vs the single-device kernel.

    call: prepare_call() dict. Returns numpy (scores, parents, peaks)[:n].
    """
    import numpy as np

    from ..ops.chain import _chain_dp_core, x_lo_to_i32

    ndev = mesh.devices.size
    n = call["n"]
    per = -(-n // ndev)
    assert per >= w, (per, w, "shards must cover the window")
    n_pad = per * ndev

    def pad(a, fill=0):
        return np.pad(np.asarray(a), (0, n_pad - n), constant_values=fill)

    x_lo = pad(call["x_lo"].view(np.int32))
    qi = pad(call["qi"])
    qspan = pad(call["qspan"])
    st_eff = pad(call["st_eff"])
    gap_table = np.asarray(call["gap_table"])
    mdx, mdy, bw = call["max_dist_x"], call["max_dist_y"], call["bw"]

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    def step(x_l, q_l, qs_l, st_l, gt):
        ax = jax.lax.axis_index(axis)
        halo = dict(
            x_lo=jnp.zeros(w, jnp.int32),
            qi=jnp.zeros(w, jnp.int32),
            scores=jnp.zeros(w, jnp.int32),
            parents=jnp.full(w, -1, jnp.int32),
            peaks=jnp.zeros(w, jnp.int32),
        )
        out = (jnp.zeros(per, jnp.int32), jnp.full(per, -1, jnp.int32),
               jnp.zeros(per, jnp.int32))
        fwd = [(i, i + 1) for i in range(ndev - 1)]
        for s in range(ndev):
            def run(h):
                return _chain_dp_core(
                    x_l, q_l, qs_l, st_l, gt, per, w, per, mdx, mdy, bw,
                    halo=h, offset=ax * per,
                )

            sc, par, pk = run(halo)
            keep = ax == s
            out = tuple(jnp.where(keep, new, old)
                        for new, old in zip((sc, par, pk), out))
            if s == ndev - 1:
                break
            boundary = dict(
                x_lo=x_l[-w:], qi=q_l[-w:],
                scores=sc[-w:], parents=par[-w:], peaks=pk[-w:],
            )
            # only shard s's boundary is meaningful; the ring moves it on
            halo = {key: jax.lax.ppermute(
                        jnp.where(keep, boundary[key], halo[key]), axis, fwd)
                    for key in halo}
        return out

    scores, parents, peaks = step(
        jnp.asarray(x_lo), jnp.asarray(qi), jnp.asarray(qspan),
        jnp.asarray(st_eff), jnp.asarray(gap_table))
    return (np.asarray(scores)[:n], np.asarray(parents)[:n].astype(np.int64),
            np.asarray(peaks)[:n])


def fmi_pipeline_index_sharded(mesh: Mesh, index: dict, enc, readlen,
                               min_seed_len: int = 19, m_cap: int = 96,
                               axis: str = "dp", cp_pack_global=None):
    """The FULL 3-phase SMEM pipeline (ops.fmi_pipeline) over an
    index SHARDED by cp_occ block range — the multi-device mode for
    genome-scale indexes (hg38 cp_occ ~6 GB).

    Reads and the small index arrays (count, SA meta) are replicated; the
    packed 64-byte occ rows are sharded P(axis); every occ lookup inside
    the unchanged pipeline resolves via owner-gather + psum broadcast
    (ops.fmi.occ_all's shard_axis mode).  Compaction/sort state is
    replicated across shards, so results are identical to the unsharded
    engine.  Returns the packed [2B+R, 3+5*cap] i32 rows of
    fmi_pipeline_device (unpack with ops.fmi_pipeline.fmi_pipeline_collect).
    """
    import numpy as _np

    from ..ops import fmi_pipeline as FP

    ndev = mesh.devices.size
    if cp_pack_global is not None:
        # pre-sharded global array (e.g. assembled from per-host shard
        # files, index.fmi_index.load_npz_shard); rows must divide ndev
        assert cp_pack_global.shape[0] % ndev == 0, cp_pack_global.shape
        cp_pack = cp_pack_global
    else:
        cp_host = _np.asarray(index["cp_pack"])
        pad = (-cp_host.shape[0]) % ndev
        if pad:
            cp_host = _np.concatenate(
                [cp_host, _np.zeros((pad, cp_host.shape[1]), cp_host.dtype)])
        cp_pack = jax.device_put(cp_host, NamedSharding(mesh, P(axis, None)))
    rest = {k: v for k, v in index.items() if k != "cp_pack"}
    split_len = int(min_seed_len * FP.SPLIT_FACTOR + 0.499)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(None, None), P(None)),
        out_specs=(P(None, None), P()),
        check_vma=False,
    )
    def run(pack_local, enc_r, readlen_r):
        from ..ops.fmi import ShardAxis

        local_index = dict(rest, cp_pack=pack_local,
                           shard_axis=ShardAxis(axis))
        return FP.fmi_pipeline_device(
            local_index, enc_r, readlen_r, min_seed_len,
            FP.SPLIT_WIDTH, FP.MAX_MEM_INTV, split_len, m_cap=m_cap)

    return run(cp_pack, jnp.asarray(enc), jnp.asarray(readlen))


def poa_align_sharded(mesh: Mesh, seq_arr, seq_len, garr_stack,
                      params, w_cap: int, a_cap: int, axis: str = "dp"):
    """Batch-sharded POA window alignment (the reference's OpenMP loop
    over MSA windows, msa_spoa_omp.cpp:352-356, as pure DP over the
    mesh): graph arrays and sequences sharded on the window batch dim,
    no cross-device traffic inside the DP.  Returns the packed
    [B, 2*a_cap+1] alignment rows (ops.poa._batched_align layout)."""
    from ..ops import poa as poa_ops

    gspecs = {k: P(axis) for k in garr_stack}

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), gspecs),
        out_specs=P(axis),
        check_vma=False,
    )
    def step(sc, sl, ga):
        ai, aj, cnt = jax.vmap(
            lambda s1, l1, g1: poa_ops.poa_align_device(
                s1, l1, g1, tuple(params), w_cap, a_cap))(sc, sl, ga)
        return jnp.concatenate([ai, aj, cnt[:, None]], axis=1)

    return step(seq_arr, seq_len, garr_stack)


def abea_fill_sharded(mesh: Mesh, ev_pad, ranks_pad, n_events, n_kmers,
                      model_arrays, scales, shifts, lp_consts, trim_vals,
                      n_bands_pad: int, bandwidth: int, axis: str = "dp"):
    """Batch-sharded adaptive-banded event-alignment band fill (the
    reference's CUDA grid over reads, f5c.cu:450-497, as DP over the
    mesh): per-read band inputs sharded on the read dim, the 4096-entry
    pore model replicated.  Returns (traces, bes, bks, last_vals) sharded
    like ops.abea.abea_fill_bands's vmapped outputs."""
    from ..ops import abea as abea_ops

    lm, ls, lls = model_arrays

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(None), P(None),
                  P(None), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    def step(e, r, ne, nk, lm_r, ls_r, lls_r, sc, sh, lp, tv):
        return jax.vmap(
            lambda e1, r1, ne1, nk1, sc1, sh1, lp1, tv1:
            abea_ops.abea_fill_bands(
                e1, r1, ne1, nk1, lm_r, ls_r, lls_r, sc1, sh1, lp1, tv1,
                n_bands_pad=n_bands_pad, bandwidth=bandwidth)
        )(e, r, ne, nk, sc, sh, lp, tv)

    return step(ev_pad, ranks_pad, n_events, n_kmers, lm, ls, lls,
                scales, shifts, lp_consts, trim_vals)
