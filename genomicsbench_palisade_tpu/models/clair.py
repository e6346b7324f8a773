"""Clair variant-caller network (nn-variant capability) in flax.

Architecture source: benchmarks/nn-variant/clair/model.py:330-640
("2BiLSTM" structure) with shared/param.py shapes:
  input [B, 33, 8, 4] (2*16+1 positions x matrixRow x matrixNum)
  -> flatten positions x 32 features -> BiLSTM(128) -> BiLSTM(128)
  -> per-FEATURE slice-dense over the 256 channels (33 -> 30 units, selu)
  -> flatten (30*256) -> dense 192 selu
  -> four heads dense 96 selu -> softmax outputs:
     gt21 (21), genotype (3), indel length 1 (33), indel length 2 (33)

Device notes: the BiLSTM scans run under lax.scan; inference is dropout-free
(the reference's dropouts are training-only).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn

FLANKING = 16
POSITIONS = 2 * FLANKING + 1  # 33
MATRIX_ROW = 8
MATRIX_NUM = 4
GT21 = 21
GENOTYPE = 3
VARLEN = 33  # 2*16 + 1


def selu(x):
    return jax.nn.selu(x)


class BiLSTM(nn.Module):
    units: int

    @nn.compact
    def __call__(self, x):  # [B, T, F]
        lstm_fwd = nn.OptimizedLSTMCell(self.units, name="fwd")
        lstm_bwd = nn.OptimizedLSTMCell(self.units, name="bwd")
        b = x.shape[0]

        def run(cell, seq):
            carry = cell.initialize_carry(jax.random.PRNGKey(0), (b, seq.shape[-1]))
            scan = nn.scan(
                lambda c, carry, xt: c(carry, xt),
                variable_broadcast="params",
                split_rngs={"params": False},
                in_axes=1,
                out_axes=1,
                # T=33 is static and small: full unroll removes the
                # per-step loop overhead
                unroll=POSITIONS,
            )
            _, ys = scan(cell, carry, seq)
            return ys

        fwd = run(lstm_fwd, x)
        bwd = run(lstm_bwd, x[:, ::-1, :])[:, ::-1, :]
        return jnp.concatenate([fwd, bwd], axis=-1)


class ClairModel(nn.Module):
    lstm_units: int = 128
    slice_units: int = 30
    l4_units: int = 192
    l5_units: int = 96

    @nn.compact
    def __call__(self, x):  # [B, 33, 8, 4]
        b = x.shape[0]
        h = x.reshape(b, POSITIONS, MATRIX_ROW * MATRIX_NUM).astype(jnp.float32)
        h = BiLSTM(self.lstm_units, name="lstm1")(h)
        h = BiLSTM(self.lstm_units, name="lstm2")(h)  # [B, 33, 256]
        # slice-dense over the FEATURE axis: per channel, dense 33 -> 30
        # (model.py:226-244 with slice_dimension=2)
        ch = h.shape[-1]
        hT = jnp.swapaxes(h, 1, 2)  # [B, 256, 33]
        w = self.param(
            "l3_kernel", nn.initializers.variance_scaling(1.0, "fan_in", "normal"),
            (ch, POSITIONS, self.slice_units),
        )
        bias = self.param("l3_bias", nn.initializers.zeros, (ch, self.slice_units))
        l3 = selu(jnp.einsum("bcp,cpu->bcu", hT, w) + bias)  # [B, 256, 30]
        # reference flattens to (B, 30 * 256)
        l3f = jnp.swapaxes(l3, 1, 2).reshape(b, self.slice_units * ch)
        l4 = selu(nn.Dense(self.l4_units, name="l4")(l3f))
        heads = []
        for i, out in enumerate((GT21, GENOTYPE, VARLEN, VARLEN)):
            l5 = selu(nn.Dense(self.l5_units, name=f"l5_{i+1}")(l4))
            # the reference applies selu AS THE ACTIVATION of the logits
            # dense before the softmax (model.py:581-588 activation=selu)
            logits = selu(nn.Dense(out, name=f"y_{i+1}")(l5))
            heads.append(jax.nn.softmax(logits))
        return tuple(heads)


def init_model(rng_seed=0, batch=2):
    model = ClairModel()
    params = model.init(
        jax.random.PRNGKey(rng_seed),
        jnp.zeros((batch, POSITIONS, MATRIX_ROW, MATRIX_NUM)),
    )
    return model, params


# ---------------------------------------------------------------------------
# TF1 checkpoint conversion
# ---------------------------------------------------------------------------

_LSTM_SCOPE = ("{scope}/stack_bidirectional_rnn/cell_0/bidirectional_rnn/"
               "{direction}/cudnn_compatible_lstm_cell")


def load_tf_variables(variables: dict):
    """Convert a Clair TF1 variable map (name -> numpy array) into flax
    params.

    Names/layouts follow the reference graph (model.py:423-640 under
    tf.contrib.rnn.stack_bidirectional_dynamic_rnn with
    CudnnCompatibleLSTMCell): LSTM kernels are [(input+units), 4*units]
    with fused gate order (i, c, f, o) and one fused bias; slice-dense
    units live at L3/Unit_{c}; heads at L5_{k} and
    Prediction/Y_*_logits.  (The TF1+tf.contrib stack cannot execute
    under the installed TF2, so conversion is validated against a cited
    numpy transcription of the cell/graph semantics —
    tests/generate_fixtures.py gen_clair.)
    """
    units = 128
    params = {"params": {}}
    p = params["params"]

    def lstm_block(scope_name, our_name):
        block = {}
        for direction, ours in (("fw", "fwd"), ("bw", "bwd")):
            scope = _LSTM_SCOPE.format(scope=scope_name, direction=direction)
            kernel = np.asarray(variables[scope + "/kernel"])
            bias = np.asarray(variables[scope + "/bias"])
            n_in = kernel.shape[0] - units
            wx, wh = kernel[:n_in], kernel[n_in:]
            cell = {}
            # fused order (i, c, f, o) -> flax gates (i, g, f, o); flax's
            # input-side gate denses are bias-free, so the fused TF bias
            # rides on the hidden-side dense
            for gi, gate in enumerate(("i", "g", "f", "o")):
                sl = slice(gi * units, (gi + 1) * units)
                cell[f"i{gate}"] = {"kernel": jnp.asarray(wx[:, sl])}
                cell[f"h{gate}"] = {"kernel": jnp.asarray(wh[:, sl]),
                                    "bias": jnp.asarray(bias[sl])}
            block[ours] = cell
        p[our_name] = block

    lstm_block("LSTM1", "lstm1")
    lstm_block("LSTM2", "lstm2")

    ch = 2 * units
    l3_k = np.stack([np.asarray(variables[f"L3/Unit_{c}/kernel"])
                     for c in range(ch)])
    l3_b = np.stack([np.asarray(variables[f"L3/Unit_{c}/bias"])
                     for c in range(ch)])
    p["l3_kernel"] = jnp.asarray(l3_k)
    p["l3_bias"] = jnp.asarray(l3_b)
    p["l4"] = {"kernel": jnp.asarray(variables["L4/kernel"]),
               "bias": jnp.asarray(variables["L4/bias"])}
    head_names = ("Y_base_change_logits", "Y_genotype_logits",
                  "Y_indel_length_logits_1", "Y_indel_length_logits_2")
    for k in range(4):
        p[f"l5_{k + 1}"] = {
            "kernel": jnp.asarray(variables[f"L5_{k + 1}/kernel"]),
            "bias": jnp.asarray(variables[f"L5_{k + 1}/bias"])}
        p[f"y_{k + 1}"] = {
            "kernel": jnp.asarray(variables[f"Prediction/{head_names[k]}/kernel"]),
            "bias": jnp.asarray(variables[f"Prediction/{head_names[k]}/bias"])}
    return params
