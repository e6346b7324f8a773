#!/usr/bin/env python
"""Multi-process (jax.distributed) scaling evidence for the DP runtime.

The reference is single-node shared-memory (SURVEY.md §2.4: no MPI/NCCL);
multi-host scaling is a new capability of this framework.  Real N-host
hardware isn't available in CI, so this harness launches N OS processes
on localhost, each owning 2 virtual CPU devices, brings them up with
jax.distributed.initialize, and runs the production shard_map kernels
(parallel/dp.py) over the GLOBAL 2N-device mesh:

  * phmm_forward_sharded — batch-DP with per-device forward scans
  * count_kmers_sharded  — all_to_all key exchange + sort-reduce + psum
  * fmi_pipeline_index_sharded — 3-phase SMEM search over a block-range-
    sharded index where EACH PROCESS LOADS ONLY ITS OWN SHARD FILE
    (index.fmi_index.save_npz_sharded — the per-host on-disk artifact)

Process 0 asserts bit-parity of the multi-process result against its own
single-process computation, times the runs, and writes MULTIPROC.json.
(The processes share the host's cores, so the wall-clock curve is flat —
the value is that the multi-process initialization, global-array construction and
cross-process collectives execute the real code paths; the >=80% 1->N
HOST scaling target needs real hosts.)

Usage:
  python tools/multiprocess_bench.py            # coordinator: N=2 and N=4
  python tools/multiprocess_bench.py --procs 2  # one N-process run
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------

def worker_main() -> int:
    sys.path.insert(0, str(REPO))  # tools/ scripts self-insert the repo root
    import numpy as np

    import jax

    # every process stays on the CPU backend: the test compares
    # multi-process collectives, not device speed
    jax.config.update("jax_platforms", "cpu")

    coord = os.environ["MP_COORD"]
    nproc = int(os.environ["MP_NPROC"])
    pid = int(os.environ["MP_PID"])
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc

    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from genomicsbench_palisade_tpu.ops import kmer as K
    from genomicsbench_palisade_tpu.ops import phmm as PH
    from genomicsbench_palisade_tpu.parallel import dp, mesh as M

    mesh = M.make_mesh()  # ALL global devices
    ndev = mesh.devices.size
    report = {"processes": nproc, "global_devices": int(ndev)}

    def make_global(batch: dict) -> dict:
        """Identical host batch on every process -> global sharded arrays.

        Mirrors mesh.shard_batch: takes n from the first batch-axis key,
        not whatever key happens to iterate last."""
        out = {}
        n = None
        for key, arr in batch.items():
            arr = np.asarray(arr)
            padded, n0 = M.pad_to_multiple(arr, ndev, axis=0)
            n = n0 if n is None else n
            out[key] = multihost_utils.host_local_array_to_global_array(
                padded, mesh, P(M.DP_AXIS))
        return out, n

    # ---- phmm batch-DP
    rng = np.random.default_rng(0)
    reads, haps, pairs = [], [], []
    b = 4 * ndev
    for i in range(b):
        rl, hl = int(rng.integers(10, 40)), int(rng.integers(15, 60))
        reads.append({
            "bases": rng.integers(0, 4, rl), "q": rng.integers(33, 60, rl),
            "i": rng.integers(33, 60, rl), "d": rng.integers(33, 60, rl),
            "c": rng.integers(33, 60, rl)})
        haps.append(rng.integers(0, 4, hl))
        pairs.append((i, i))
    batch = PH.prepare_batch(reads, haps, pairs)
    gbatch, n = make_global(batch)
    log10, _res, _fb = dp.phmm_forward_sharded(mesh, gbatch)
    got = multihost_utils.process_allgather(log10, tiled=True)[:n]
    t0 = time.perf_counter()
    iters = 5
    for _ in range(iters):
        log10, _res, _fb = dp.phmm_forward_sharded(mesh, gbatch)
    _ = multihost_utils.process_allgather(log10, tiled=True)
    report["phmm_s_per_batch"] = (time.perf_counter() - t0) / iters
    report["phmm_batch"] = b

    if pid == 0:
        want, _, _ = PH.phmm_forward(batch)
        ok = np.array_equal(np.asarray(got), np.asarray(want))
        report["phmm_parity"] = bool(ok)
        assert ok, "multi-process phmm diverged from single-process"

    # ---- kmer all_to_all + psum
    reads_s = ["".join(rng.choice(list("ACGT"), 120))
               for _ in range(2 * ndev)]
    bases, lengths = K.encode_reads_np(reads_s)
    gb, _ = make_global({"b": np.asarray(bases, np.int32)})
    gl, _ = make_global({"l": np.asarray(lengths)})
    out = dp.count_kmers_sharded(mesh, gb["b"], gl["l"], k=17)
    # psum output is replicated: read this process's addressable shard
    total = int(np.asarray(out["total_kmers"].addressable_data(0)))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = dp.count_kmers_sharded(mesh, gb["b"], gl["l"], k=17)
    _ = np.asarray(out["total_kmers"].addressable_data(0))
    report["kmer_s_per_batch"] = (time.perf_counter() - t0) / iters

    if pid == 0:
        from genomicsbench_palisade_tpu.ops.oracle import kmer as KO

        want = KO.count_kmers(reads_s, k=17, min_read_length=0)
        ok = total == want["total_kmers"]
        report["kmer_parity"] = bool(ok)
        assert ok, (total, want["total_kmers"])

    # ---- fmi: sharded on-disk index, one shard file per process
    idx_prefix = os.environ["MP_IDX_PREFIX"]
    from genomicsbench_palisade_tpu.index import fmi_index as FI

    man = FI.load_shard_manifest(idx_prefix)
    shard = FI.load_npz_shard(idx_prefix, pid)  # ONLY this host's range
    # global [n_shards*rows, 16] cp_pack: each process contributes the
    # rows of its own shard file (host-local -> global concatenation)
    cp_global = multihost_utils.host_local_array_to_global_array(
        shard["cp_pack"], mesh, P(M.DP_AXIS, None))
    # replicated small arrays come from the manifest; cp_count is only a
    # dtype carrier when cp_pack is present (ops/fmi.py occ_all)
    rest = {
        "count": np.asarray(man["count"], np.int64),
        "sentinel_index": np.int64(man["sentinel_index"]),
        "cp_count": np.zeros((0, 4), np.int64),
    }
    fenc = np.asarray(np.load(idx_prefix + ".reads.npz")["enc"], np.int32)
    flen = np.asarray(np.load(idx_prefix + ".reads.npz")["len"], np.int32)
    from genomicsbench_palisade_tpu.ops import fmi_pipeline as FP

    handles = dp.fmi_pipeline_index_sharded(
        mesh, rest, fenc, flen, min_seed_len=15, cp_pack_global=cp_global)
    # outputs are replicated (out_specs P(None)) -> fully addressable,
    # np.asarray inside collect works in every process
    got, g1, g2, g3, govf = FP.fmi_pipeline_collect(handles, len(flen))
    report["fmi_total_smems"] = int(g1 + g2 + g3)

    if pid == 0:
        import jax.numpy as jnp

        full = FI.load_npz_sharded(idx_prefix).as_device_arrays()
        want_h = FP.fmi_pipeline_batch(
            {k: jnp.asarray(v) for k, v in full.items()}, fenc, flen,
            min_seed_len=15)
        ok = (int(want_h[1] + want_h[2] + want_h[3]) ==
              report["fmi_total_smems"])
        for key in want_h[0]:
            ok = ok and np.array_equal(got[key], want_h[0][key])
        report["fmi_parity"] = bool(ok)
        assert ok, "sharded-file fmi diverged from single-process"
        print("PARITY OK " + json.dumps(report), flush=True)
    jax.distributed.shutdown()
    return 0


# ---------------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------------

def _prepare_sharded_index(workdir: pathlib.Path, nproc: int) -> str:
    """Build a toy index and persist it as one shard file PER PROCESS
    (plus manifest) — workers each load only their own shard."""
    sys.path.insert(0, str(REPO))
    import numpy as np

    from genomicsbench_palisade_tpu.index import fmi_index as FI
    from genomicsbench_palisade_tpu.index.builder import build_arrays

    rng = np.random.default_rng(29)
    genome = rng.integers(0, 4, 4096).astype(np.uint8)
    idx = build_arrays(genome)
    prefix = str(workdir / f"mpidx{nproc}")
    FI.save_npz_sharded(idx, prefix, nproc)
    b, l_max = 8, 32
    enc = np.full((b, l_max), 4, np.int32)
    ln = np.zeros(b, np.int32)
    for i in range(b):
        n = int(rng.integers(20, l_max + 1))
        s = int(rng.integers(0, len(genome) - n))
        enc[i, :n] = genome[s : s + n]
        ln[i] = n
    np.savez(prefix + ".reads.npz", enc=enc, len=ln)
    return prefix


def run_group(nproc: int, timeout: float = 900.0) -> dict:
    port = _free_port()
    workdir = pathlib.Path("/tmp/multiproc_bench")
    workdir.mkdir(exist_ok=True)
    idx_prefix = _prepare_sharded_index(workdir, nproc)
    env_base = {
        **os.environ,
        "MP_ROLE": "worker",
        "MP_COORD": f"127.0.0.1:{port}",
        "MP_NPROC": str(nproc),
        "MP_IDX_PREFIX": idx_prefix,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
    }
    env_base.pop("PYTHONPATH", None)
    procs = []
    for pid in range(nproc):
        env = dict(env_base, MP_PID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, __file__], env=env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    ok = True
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            ok = False
        outs.append((p.returncode, out, err))
        ok = ok and p.returncode == 0
    head = outs[0]
    result = {"processes": nproc, "ok": ok}
    for line in head[1].splitlines():
        if line.startswith("PARITY OK "):
            result.update(json.loads(line[len("PARITY OK "):]))
    if not ok:
        # every worker's tail: the failing task is usually not process 0
        result["stderr_tail"] = {
            f"proc{i}": f"rc={rc} " + err[-2000:]
            for i, (rc, _out, err) in enumerate(outs)}
    return result


def main(argv=None) -> int:
    if os.environ.get("MP_ROLE") == "worker":
        return worker_main()
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=None,
                    help="single N-process run (default: sweep 2 and 4)")
    ap.add_argument("--out", default=str(REPO / "MULTIPROC.json"))
    args = ap.parse_args(argv)
    sweep = [args.procs] if args.procs else [2, 4]
    results = [run_group(n) for n in sweep]
    artifact = {"runs": results,
                "note": "localhost jax.distributed over virtual CPU "
                        "devices; parity asserted by process 0"}
    pathlib.Path(args.out).write_text(json.dumps(artifact, indent=1))
    print(json.dumps(artifact))
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
