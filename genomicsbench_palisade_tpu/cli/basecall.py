"""nn-base driver: `python -m genomicsbench_palisade_tpu.cli.basecall
<model_source> <reads>`.

Reproduces the bonito basecaller driver contract (benchmarks/nn-base/
bonito/basecall.py:580-646): loads model weights, iterates reads,
normalizes each raw signal by its noisiest section, chunks with overlap,
runs the QuartzNet-CTC forward (one batched conv stack per read),
stitches posteriors and viterbi-decodes, writing FASTA to stdout and the
`> completed reads / duration / samples per second` summary to stderr.

model_source: 'random' (untrained smoke model), a PyTorch checkpoint
(.tar/.pth, converted via models.bonito.load_torch_state_dict), or a
flax msgpack file saved from init_model params.
reads: .npz (name -> raw signal) or a fast5 file when h5py is present.
"""

from __future__ import annotations

import argparse
import sys
import time
from datetime import timedelta

import numpy as np

from ..io.signal import load_signals_fast5, load_signals_npz
from ..models import bonito as B

MAX_READ_SIZE = 4e6  # basecall.py:592


def load_model(source: str, dtype=None, weights: str = "0"):
    # bonito model DIRECTORY (config.toml + weights_<N>.tar) — the form
    # run-gpu.sh uses: `basecall.py models/bonito_dna_r941 <reads_dir>`
    # (reference basecall.py:635-638 + util.load_model)
    import os

    if os.path.isdir(source):
        cand = os.path.join(source, f"weights_{weights}.tar")
        if not os.path.exists(cand):
            tars = sorted(f for f in os.listdir(source) if f.endswith(".tar"))
            if not tars:
                raise FileNotFoundError(f"no weights_*.tar in {source}")
            cand = os.path.join(source, tars[0])
        source = cand
    # validate BEFORE the (expensive) model init so a typo fails instantly
    if source != "random" and not source.endswith(
        (".tar", ".pth", ".pt", ".msgpack")
    ):
        raise ValueError(f"unrecognized model source: {source}")
    import jax.numpy as jnp

    model, params = B.init_model(dtype=dtype or jnp.float32)
    if source == "random":
        return model, params
    if source.endswith((".tar", ".pth", ".pt")):
        import torch

        state = torch.load(source, map_location="cpu", weights_only=False)
        state = {k.replace("module.", ""): v for k, v in state.items()}
        return model, B.load_torch_state_dict(state)
    from flax import serialization

    with open(source, "rb") as f:
        params = serialization.from_bytes(params, f.read())
    return model, params


def main(argv=None):
    ap = argparse.ArgumentParser(prog="basecall")
    ap.add_argument("model_source",
                    help="'random', torch .tar/.pth, flax .msgpack, or a "
                         "bonito model directory (weights_<N>.tar)")
    ap.add_argument("reads",
                    help=".npz (name->raw signal), .fast5, or a directory "
                         "of either")
    ap.add_argument("--device", default=None,
                    help="accepted for reference CLI parity (JAX picks the device)")
    ap.add_argument("--weights", default="0",
                    help="weights_<N>.tar selector for model directories")
    ap.add_argument("--chunksize", default=4000, type=int)
    ap.add_argument("--overlap", default=0, type=int)
    ap.add_argument("--beamsize", default=5, type=int,
                    help="CTC prefix beam width (reference default 5; 1 = viterbi)")
    ap.add_argument("--fastq", action="store_true",
                    help="FASTQ output (constant Q20 quals — the decoder "
                         "emits sequences, not per-base posteriors)")
    # the reference driver defaults to half precision when the GPU supports
    # it (basecall.py:642); bf16 is the analog here (decoder stays f32)
    ap.add_argument("--precision", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--half", action="store_true",
                    help="reference alias for --precision bf16")
    args = ap.parse_args(argv)

    from ..utils.compile_cache import enable as _enable_cache
    _enable_cache()

    import jax.numpy as jnp

    sys.stderr.write("> loading model\n")
    dtype = jnp.bfloat16 if (args.precision == "bf16" or args.half) \
        else jnp.float32
    model, params = load_model(args.model_source, dtype=dtype,
                               weights=args.weights)

    import os

    def _load_one(path):
        if path.endswith(".fast5"):
            return load_signals_fast5(path)
        return load_signals_npz(path)

    if os.path.isdir(args.reads):
        signals = {}
        for f in sorted(os.listdir(args.reads)):
            if f.endswith((".fast5", ".npz")):
                signals.update(_load_one(os.path.join(args.reads, f)))
    else:
        signals = _load_one(args.reads)

    samples = 0
    num_reads = 0
    t0 = time.perf_counter()
    sys.stderr.write("> calling\n")
    for read_id, raw in signals.items():
        if len(raw) > MAX_READ_SIZE:
            sys.stderr.write(
                f"> skipping long read {read_id} ({len(raw)} samples)\n")
            continue
        num_reads += 1
        samples += len(raw)
        norm = B.norm_by_noisiest_section(raw)
        seq = B.basecall_read(model, params, norm,
                              chunksize=args.chunksize, overlap=args.overlap,
                              beamsize=args.beamsize)
        if args.fastq:
            sys.stdout.write(f"@{read_id}\n{seq}\n+\n{'5' * len(seq)}\n")
        else:
            sys.stdout.write(f">{read_id}\n{seq}\n")
    duration = time.perf_counter() - t0

    sys.stderr.write(f"> completed reads: {num_reads}\n")
    sys.stderr.write(f"> duration: {timedelta(seconds=np.round(duration))}\n")
    sys.stderr.write("> samples per second %.1E\n" % (samples / max(duration, 1e-9)))
    sys.stderr.write("> done\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
