"""nn-variant golden de-correlation.

The clair golden (tests/fixtures/clair_golden.npz) was generated from a
NUMPY TRANSCRIPTION of the reference TF1 graph (clair/model.py:423-640)
because tf.contrib cannot execute here — making it the one golden never
checked against independently-executed code.  This test re-executes the
same forward through torch's own LSTM (an independent implementation of
the cuDNN LSTM equations, which TF's CudnnCompatibleLSTMCell is defined
to match): the only hand conversion is the gate-order/bias mapping
(TF fused kernel order i,c,f,o with one bias and forget_bias=0; torch
order i,f,g,o with b_ih+b_hh).  Agreement across two independent
execution engines de-correlates transcription errors in the recurrence
(gate order, forget bias, state update), the part where a transcription
could plausibly be wrong in a self-consistent way.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.generate_fixtures import (  # noqa: E402
    CLAIR_UNITS, _clair_variables, _selu_np)

FIX = "clair_golden.npz"


def _torch_bilstm(seq, variables, scope):
    """seq [B, T, F] float64 -> [B, T, 2*units] via torch.nn.LSTM."""
    u = CLAIR_UNITS
    n_in = seq.shape[-1]
    lstm = torch.nn.LSTM(n_in, u, batch_first=True, bidirectional=True)
    base = (f"{scope}/stack_bidirectional_rnn/cell_0/"
            f"bidirectional_rnn/%s/cudnn_compatible_lstm_cell")
    with torch.no_grad():
        for d, suffix in (("fw", ""), ("bw", "_reverse")):
            k = variables[base % d + "/kernel"]  # [n_in+u, 4u] cols i,c,f,o
            bias = variables[base % d + "/bias"]  # [4u]
            w_x, w_h = k[:n_in], k[n_in:]
            # TF fused gate order (i, c, f, o) -> torch (i, f, g, o)
            perm = np.concatenate([np.arange(0, u),          # i
                                   np.arange(2 * u, 3 * u),  # f <- TF f
                                   np.arange(u, 2 * u),      # g <- TF c
                                   np.arange(3 * u, 4 * u)]) # o
            getattr(lstm, f"weight_ih_l0{suffix}").copy_(
                torch.from_numpy(w_x[:, perm].T.astype(np.float64)))
            getattr(lstm, f"weight_hh_l0{suffix}").copy_(
                torch.from_numpy(w_h[:, perm].T.astype(np.float64)))
            getattr(lstm, f"bias_ih_l0{suffix}").copy_(
                torch.from_numpy(bias[perm].astype(np.float64)))
            getattr(lstm, f"bias_hh_l0{suffix}").zero_()
    lstm.double()
    with torch.no_grad():
        out, _ = lstm(torch.from_numpy(seq))
    return out.numpy()


def test_clair_golden_torch_reexecution(fixtures_dir):
    data = np.load(fixtures_dir / FIX)
    variables = _clair_variables()
    x = data["input"]
    b = x.shape[0]
    h = x.reshape(b, 33, 32).astype(np.float64)

    h = _torch_bilstm(h, variables, "LSTM1")
    h = _torch_bilstm(h, variables, "LSTM2")  # [B, 33, 256]

    l3 = np.stack(
        [_selu_np(h[:, :, c] @ variables[f"L3/Unit_{c}/kernel"]
                  + variables[f"L3/Unit_{c}/bias"])
         for c in range(256)], axis=2)
    l4 = _selu_np(l3.reshape(b, 30 * 256) @ variables["L4/kernel"]
                  + variables["L4/bias"])
    heads = ("Y_base_change_logits", "Y_genotype_logits",
             "Y_indel_length_logits_1", "Y_indel_length_logits_2")
    keys = ("gt21", "genotype", "indel1", "indel2")
    for k in range(4):
        l5 = _selu_np(l4 @ variables[f"L5_{k + 1}/kernel"]
                      + variables[f"L5_{k + 1}/bias"])
        logits = _selu_np(l5 @ variables[f"Prediction/{heads[k]}/kernel"]
                          + variables[f"Prediction/{heads[k]}/bias"])
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
        np.testing.assert_allclose(
            probs.astype(np.float32), data[keys[k]], rtol=0, atol=1e-6,
            err_msg=f"head {heads[k]} disagrees with the transcription "
                    f"golden under torch LSTM re-execution")
