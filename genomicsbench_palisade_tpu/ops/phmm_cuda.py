"""PairHMM forward pass on an NVIDIA GPU: the CUDA kernel and its loader.

The kernel (native/cuda/phmm_forward.cu) gives one warp to each testcase
and walks 32-row stripes with a lane-per-row wavefront; the per-row
probability tables are computed inside it from the compact int8 batch
(ops/phmm.py compact_batch), so the device reads 4 bytes per cell row
once.  It rounds every multiply and add apart, so its raw sums equal
the float32 reference sweep (ops/phmm_f64.py) bit for bit.

Build once with

    python -m genomicsbench_palisade_tpu.ops.phmm_cuda

which runs nvcc (sm_90a) into build/cuda/; the first call builds it too
when the library is missing or older than its source.  CUDA has no
interpret mode: on the CPU the routing, padding and wire format around
this call are tested, and the arithmetic through the plain scan it
mirrors.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from .phmm import _finish, _tables_f32

REPO = pathlib.Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "cuda" / "phmm_forward.cu"
LIBRARY = REPO / "build" / "cuda" / "libphmm_forward.so"
TARGET = "genomics_phmm_forward"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def nvcc_command(out: pathlib.Path) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", str(out), str(SOURCE),
    ]


def _fresh() -> bool:
    return (LIBRARY.exists()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime)


def build() -> pathlib.Path:
    """Compile the kernel library if it is missing or stale; the file
    lock lets concurrent processes share one build."""
    if _fresh():
        return LIBRARY
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    with open(LIBRARY.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh():
            return LIBRARY
        tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{r.stderr[-4000:]}")
        os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.cache
def register() -> None:
    lib = ctypes.cdll.LoadLibrary(str(build()))
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.PhmmForward),
                                platform="CUDA")


@jax.jit
def _forward(rs_row, q, i, d, c, hap, rslen, haplen):
    ph2pr, m2m, _, ic = _tables_f32()
    out = jax.ShapeDtypeStruct((rs_row.shape[0],), jnp.float32)
    res_m, res_x = jax.ffi.ffi_call(TARGET, (out, out))(
        rs_row, q, i, d, c, hap, rslen, haplen,
        jnp.asarray(ph2pr), jnp.asarray(m2m),
        initial_constant=np.float32(ic))
    return _finish(res_m, res_x)


def phmm_forward_cuda(compact):
    """compact: ops/phmm.py compact_batch dict.  Returns (log10, raw
    result, fallback) like phmm_forward."""
    register()
    return _forward(*(compact[k] for k in
                      ("rs_row", "q", "i", "d", "c", "hap", "rslen", "haplen")))


if __name__ == "__main__":
    print(build())
