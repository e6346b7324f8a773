"""Bonito QuartzNet-style CTC basecaller (nn-base capability) in flax.

Architecture source: benchmarks/nn-base/bonito/basecall.py:33-260 and
models/bonito_dna_r941/config.toml — 8 blocks of time-channel-separable
1-D convs with BatchNorm(eps=1e-3) + Swish, pointwise residuals, a 1x1
decoder conv, log_softmax over the 5-label alphabet "NACGT", greedy/
viterbi CTC decoding (fast_ctc_decode replacement).

Device notes: convs run as NWC lax convolutions (cuDNN through XLA);
inference-mode batch norm is folded affine math.  `load_torch_state_dict` converts the
reference's PyTorch weights when available.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn

DEFAULT_ALPHABET = "NACGT"

# (filters, repeat, kernel, stride, residual, separable) per config.toml
DNA_R941_BLOCKS = [
    (344, 1, 9, 3, False, False),
    (424, 2, 115, 1, True, True),
    (464, 7, 5, 1, True, True),
    (456, 4, 123, 1, True, True),
    (440, 9, 9, 1, True, True),
    (280, 6, 31, 1, True, True),
    (384, 1, 67, 1, False, True),
    (48, 1, 15, 1, False, False),
]


def swish(x):
    return x * jax.nn.sigmoid(x)


class TCSConv(nn.Module):
    out_channels: int
    kernel_size: int
    stride: int = 1
    separable: bool = False
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x):  # x: [B, T, C]
        pad = (self.kernel_size // 2, self.kernel_size // 2)
        if self.separable:
            c_in = x.shape[-1]
            x = nn.Conv(
                c_in, (self.kernel_size,), strides=(self.stride,),
                padding=(pad,), feature_group_count=c_in, use_bias=False,
                name="depthwise", dtype=self.dtype,
            )(x)
            # reference quirk: the pointwise conv also carries the stride
            x = nn.Conv(
                self.out_channels, (1,), strides=(self.stride,), use_bias=False,
                name="pointwise", dtype=self.dtype,
            )(x)
        else:
            x = nn.Conv(
                self.out_channels, (self.kernel_size,), strides=(self.stride,),
                padding=(pad,), use_bias=False, name="conv", dtype=self.dtype,
            )(x)
        return x


class Block(nn.Module):
    out_channels: int
    repeat: int
    kernel_size: int
    stride: int
    residual: bool
    separable: bool
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x):
        def bn(name):
            return nn.BatchNorm(
                use_running_average=True, epsilon=1e-3, momentum=0.9,
                name=name, dtype=self.dtype,
            )

        h = x
        for r in range(self.repeat):
            h = TCSConv(
                self.out_channels, self.kernel_size, self.stride,
                self.separable, name=f"tcs{r}", dtype=self.dtype,
            )(h)
            h = bn(f"bn{r}")(h)
            if r < self.repeat - 1:
                h = swish(h)
        if self.residual:
            res = TCSConv(self.out_channels, 1, 1, False, name="res_tcs",
                          dtype=self.dtype)(x)
            res = bn("res_bn")(res)
            h = h + res
        return swish(h)


class BonitoModel(nn.Module):
    """dtype=bfloat16 mirrors the reference driver's default half-precision
    inference (basecall.py:642 `--half` defaults to half_supported()); the
    decoder conv + log_softmax stay float32."""

    blocks: tuple = tuple(DNA_R941_BLOCKS)
    n_classes: int = 5
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x):  # x: [B, T, 1] normalized signal
        x = x.astype(self.dtype)
        for i, (f, rep, k, s, res, sep) in enumerate(self.blocks):
            x = Block(f, rep, k, s, res, sep, name=f"block{i}",
                      dtype=self.dtype)(x)
        x = x.astype(jnp.float32)
        x = nn.Conv(self.n_classes, (1,), use_bias=True, name="decoder")(x)
        return jax.nn.log_softmax(x, axis=-1)


def init_model(rng_seed=0, chunk=4000, blocks=None, dtype=jnp.float32):
    model = BonitoModel(blocks=tuple(blocks or DNA_R941_BLOCKS), dtype=dtype)
    params = model.init(jax.random.PRNGKey(rng_seed), jnp.zeros((1, chunk, 1)))
    return model, params


def viterbi_decode(log_probs, alphabet=DEFAULT_ALPHABET):
    """Greedy CTC collapse (viterbi path of the label-synchronous model)."""
    path = np.asarray(jnp.argmax(log_probs, axis=-1))
    out = []
    prev = -1
    for p in path:
        if p != prev and p != 0:  # 0 = 'N' blank
            out.append(alphabet[p])
        prev = p
    return "".join(out)


def beam_search_decode(log_probs, alphabet=DEFAULT_ALPHABET, beam_size=5,
                       threshold=1e-3):
    """CTC prefix beam search (the reference's fast_ctc_decode beam_search
    path, basecall.py:100-105, default beamsize=5 threshold=1e-3):
    label 0 is the blank, per-step classes below `threshold` posterior are
    pruned, beams keep (p_blank, p_nonblank) mass per collapsed prefix.

    Runs in C++ when the native lib is built (native/ctc_beam.cpp, same
    construction order/tie-breaks; the Python walk below is the fallback
    and the semantic spec — the per-timestep dict rebuild costs seconds
    per long read)."""
    from ..io.native import ctc_beam_native

    labels = ctc_beam_native(np.asarray(log_probs, np.float32),
                             beam_size, threshold)
    if labels is not None:
        return "".join(alphabet[c] for c in labels)
    probs = np.exp(np.asarray(log_probs, np.float64))
    beams = {(): (1.0, 0.0)}
    for t in range(probs.shape[0]):
        p_t = probs[t]
        live = np.nonzero(p_t >= threshold)[0]
        nxt = {}

        def add(prefix, pb, pnb):
            b0, n0 = nxt.get(prefix, (0.0, 0.0))
            nxt[prefix] = (b0 + pb, n0 + pnb)

        for prefix, (pb, pnb) in beams.items():
            last = prefix[-1] if prefix else -1
            for c in live:
                p = p_t[c]
                if c == 0:  # blank extends every prefix unchanged
                    add(prefix, (pb + pnb) * p, 0.0)
                elif c == last:
                    add(prefix, 0.0, pnb * p)  # repeat collapses
                    add(prefix + (c,), 0.0, pb * p)  # blank-separated
                else:
                    add(prefix + (c,), 0.0, (pb + pnb) * p)
        beams = dict(sorted(nxt.items(), key=lambda kv: -(kv[1][0] + kv[1][1]))
                     [:beam_size])
        if not beams:  # every class pruned this step: keep prior beams
            beams = {(): (1.0, 0.0)}
    best = max(beams.items(), key=lambda kv: kv[1][0] + kv[1][1])[0]
    return "".join(alphabet[c] for c in best)


def basecall(model, params, signal, chunksize=4000, overlap=0):
    """Chunked single-read basecall; returns the called sequence."""
    t = len(signal)
    pieces = []
    step = chunksize - overlap
    for s in range(0, t, step):
        chunk = signal[s : s + chunksize]
        if len(chunk) < chunksize:
            chunk = np.pad(chunk, (0, chunksize - len(chunk)))
        lp = model.apply(params, jnp.asarray(chunk[None, :, None], jnp.float32))
        pieces.append(viterbi_decode(lp[0]))
    return "".join(pieces)


def load_torch_state_dict(state_dict, blocks=None):
    """Convert a PyTorch bonito checkpoint into flax params.

    Layout mapping: torch Conv1d weight [out, in/groups, k] -> flax Conv
    kernel [k, in/groups, out]; BatchNorm running stats feed the
    use_running_average path.
    """
    blocks = blocks or DNA_R941_BLOCKS

    def conv_w(t):
        return jnp.asarray(np.transpose(np.asarray(t), (2, 1, 0)))

    params = {"params": {}, "batch_stats": {}}

    def put(path, leaf, tree):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    for i, (f, rep, k, s, res, sep) in enumerate(blocks):
        conv_seq = []  # torch module indices within encoder.encoder.{i}.conv
        # torch Block.conv is a flat ModuleList: per repeat: (TCS, BN[, act, drop])
        idx = 0
        for r in range(rep):
            tcs_key = f"encoder.encoder.{i}.conv.{idx}"
            bn_key = f"encoder.encoder.{i}.conv.{idx + 1}"
            base = ("params", f"block{i}", f"tcs{r}")
            if sep:
                put(base[1:] + ("depthwise", "kernel"),
                    conv_w(state_dict[tcs_key + ".depthwise.weight"]), params["params"])
                put(base[1:] + ("pointwise", "kernel"),
                    conv_w(state_dict[tcs_key + ".pointwise.weight"]), params["params"])
            else:
                put(base[1:] + ("conv", "kernel"),
                    conv_w(state_dict[tcs_key + ".conv.weight"]), params["params"])
            put((f"block{i}", f"bn{r}", "scale"),
                jnp.asarray(np.asarray(state_dict[bn_key + ".weight"])), params["params"])
            put((f"block{i}", f"bn{r}", "bias"),
                jnp.asarray(np.asarray(state_dict[bn_key + ".bias"])), params["params"])
            put((f"block{i}", f"bn{r}", "mean"),
                jnp.asarray(np.asarray(state_dict[bn_key + ".running_mean"])), params["batch_stats"])
            put((f"block{i}", f"bn{r}", "var"),
                jnp.asarray(np.asarray(state_dict[bn_key + ".running_var"])), params["batch_stats"])
            idx += 2 if r == rep - 1 else 4  # act+dropout between repeats
        if res:
            put((f"block{i}", "res_tcs", "conv", "kernel"),
                conv_w(state_dict[f"encoder.encoder.{i}.residual.0.conv.weight"]), params["params"])
            put((f"block{i}", "res_bn", "scale"),
                jnp.asarray(np.asarray(state_dict[f"encoder.encoder.{i}.residual.1.weight"])), params["params"])
            put((f"block{i}", "res_bn", "bias"),
                jnp.asarray(np.asarray(state_dict[f"encoder.encoder.{i}.residual.1.bias"])), params["params"])
            put((f"block{i}", "res_bn", "mean"),
                jnp.asarray(np.asarray(state_dict[f"encoder.encoder.{i}.residual.1.running_mean"])), params["batch_stats"])
            put((f"block{i}", "res_bn", "var"),
                jnp.asarray(np.asarray(state_dict[f"encoder.encoder.{i}.residual.1.running_var"])), params["batch_stats"])
        del conv_seq
    put(("decoder", "kernel"), conv_w(state_dict["decoder.layers.0.weight"]), params["params"])
    put(("decoder", "bias"), jnp.asarray(np.asarray(state_dict["decoder.layers.0.bias"])), params["params"])
    return params


def save_torch_state_dict(params, blocks=None):
    """Inverse of load_torch_state_dict: flax params -> a bonito-format
    torch state_dict (numpy tensors; torch.save-able), so checkpoints can
    round-trip back to the reference's weights_<N>.tar layout."""
    blocks = blocks or DNA_R941_BLOCKS
    p, bs = params["params"], params["batch_stats"]

    def conv_w(k):  # flax [k, in/groups, out] -> torch [out, in/groups, k]
        return np.ascontiguousarray(np.transpose(np.asarray(k), (2, 1, 0)))

    out = {}
    for i, (f, rep, k, s, res, sep) in enumerate(blocks):
        idx = 0
        for r in range(rep):
            tcs_key = f"encoder.encoder.{i}.conv.{idx}"
            bn_key = f"encoder.encoder.{i}.conv.{idx + 1}"
            blk, bn = p[f"block{i}"][f"tcs{r}"], p[f"block{i}"][f"bn{r}"]
            if sep:
                out[tcs_key + ".depthwise.weight"] = conv_w(blk["depthwise"]["kernel"])
                out[tcs_key + ".pointwise.weight"] = conv_w(blk["pointwise"]["kernel"])
            else:
                out[tcs_key + ".conv.weight"] = conv_w(blk["conv"]["kernel"])
            out[bn_key + ".weight"] = np.asarray(bn["scale"])
            out[bn_key + ".bias"] = np.asarray(bn["bias"])
            stats = bs[f"block{i}"][f"bn{r}"]
            out[bn_key + ".running_mean"] = np.asarray(stats["mean"])
            out[bn_key + ".running_var"] = np.asarray(stats["var"])
            idx += 2 if r == rep - 1 else 4
        if res:
            out[f"encoder.encoder.{i}.residual.0.conv.weight"] = conv_w(
                p[f"block{i}"]["res_tcs"]["conv"]["kernel"])
            rb = p[f"block{i}"]["res_bn"]
            rs = bs[f"block{i}"]["res_bn"]
            out[f"encoder.encoder.{i}.residual.1.weight"] = np.asarray(rb["scale"])
            out[f"encoder.encoder.{i}.residual.1.bias"] = np.asarray(rb["bias"])
            out[f"encoder.encoder.{i}.residual.1.running_mean"] = np.asarray(rs["mean"])
            out[f"encoder.encoder.{i}.residual.1.running_var"] = np.asarray(rs["var"])
    out["decoder.layers.0.weight"] = conv_w(p["decoder"]["kernel"])
    out["decoder.layers.0.bias"] = np.asarray(p["decoder"]["bias"])
    return out


# ---------------------------------------------------------------------------
# host-side signal preprocessing + chunking (basecall.py:296-398)
# ---------------------------------------------------------------------------

MODEL_STRIDE = DNA_R941_BLOCKS[0][3]  # block 0 stride (config stride=3)


def med_mad(x, factor=1.4826):
    """Median and scaled median absolute deviation (basecall.py:391-397)."""
    med = np.median(x)
    mad = np.median(np.absolute(x - med)) * factor
    return med, mad


def norm_by_noisiest_section(signal, samples=100, threshold=6.0):
    """medmad-normalize using the widest high-noise region
    (basecall.py:367-388)."""
    from scipy.signal import find_peaks

    signal = np.asarray(signal, dtype=np.float32)
    thr = signal.std() / threshold
    noise = np.ones(signal.shape)
    for idx in np.arange(signal.shape[0] // samples):
        window = slice(idx * samples, (idx + 1) * samples)
        noise[window] = np.where(signal[window].std() > thr, 1, 0)
    noise[0] = 0
    noise[-1] = 0
    peaks, info = find_peaks(noise, width=(None, None))
    if len(peaks):
        widest = np.argmax(info["widths"])
        med, mad = med_mad(
            signal[info["left_bases"][widest]: info["right_bases"][widest]]
        )
    else:
        med, mad = med_mad(signal)
    return (signal - med) / mad


def chunk_signal(raw, chunksize, overlap):
    """Overlapping chunks [N, chunksize] (basecall.py chunk(), :295-305)."""
    raw = np.asarray(raw, dtype=np.float32)
    if chunksize > 0 and raw.shape[0] > chunksize:
        step = chunksize - overlap
        num_chunks = raw.shape[0] // step + 1
        tmp = np.zeros(num_chunks * step, dtype=raw.dtype)
        tmp[: raw.shape[0]] = raw
        n_windows = (len(tmp) - chunksize) // step + 1
        idx = np.arange(n_windows)[:, None] * step + np.arange(chunksize)[None, :]
        return tmp[idx]
    return raw[None, :]


def stitch(predictions, overlap_out):
    """Stitch chunked posteriors (basecall.py stitch(), :308-316)."""
    predictions = np.asarray(predictions)
    if predictions.shape[0] == 1:
        return predictions[0]
    if overlap_out == 0:
        return np.concatenate(list(predictions))
    pieces = [predictions[0, :-overlap_out]]
    for i in range(1, predictions.shape[0] - 1):
        pieces.append(predictions[i][overlap_out:-overlap_out])
    pieces.append(predictions[-1][overlap_out:])
    return np.concatenate(pieces)


def basecall_read(model, params, signal, chunksize=4000, overlap=0,
                  stride=MODEL_STRIDE, beamsize=1):
    """Full single-read pipeline: chunk -> ONE batched forward ->
    stitch posteriors -> decode (basecall.py main(), :600-620; beamsize>1
    uses the reference's default prefix beam search, 1 = viterbi).

    The chunk batch is padded to a power-of-two bucket so mixed-length
    reads share one compiled forward (each distinct chunk count would
    otherwise recompile the conv stack)."""
    chunks = chunk_signal(signal, chunksize, overlap)
    n = chunks.shape[0]
    n_pad = max(1, int(2 ** np.ceil(np.log2(n))))
    if n_pad != n:
        chunks = np.concatenate(
            [chunks, np.zeros((n_pad - n, chunks.shape[1]), chunks.dtype)])
    lp = model.apply(params, jnp.asarray(chunks[:, :, None]))
    posteriors = stitch(np.asarray(lp)[:n], overlap // stride // 2)
    posteriors = posteriors[: len(signal)]
    if beamsize > 1:
        return beam_search_decode(posteriors, beam_size=beamsize)
    return viterbi_decode(posteriors)
