"""The port's recurrent cells and runners (`ghost_tpu_torch/nn/rnn.py`)
and RNN-T joint and loss (`nn/transducer.py`) against ghost_tpu's, on
the CPU.

RNN: the same torch-layout weights (drawn by the port's
`init_rnn_params`) through both packages' `rnn_forward`, every cell,
stacked and bidirectional, with the last hidden states, and the LSTM and
GRU also against torch.nn.LSTM/GRU on those weights: 2e-6 absolute (f32;
activations in [-1, 1]); the streaming continuation through h0 equal to
the one-shot run (1e-6).

Transducer: the loss against JAX's and the float64 reference DP
(1e-5 relative), ragged lengths included; its gradient with respect to
the log-probs against jax.grad (1e-5 of the largest), and finite where
the lattice is unreachable (the -1e30 floor, not -inf); the joint
exactly.
"""

import numpy as np
import pytest
import torch

from ghost_tpu_torch.nn import rnn as trnn
from ghost_tpu_torch.nn import transducer as ttr

T, B, IN, H = 7, 3, 5, 4

@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)



def _jax_params(layers, bidirectional):
    import jax.numpy as jnp

    from ghost_tpu.nn.rnn import RNNParams

    def one(p):
        return RNNParams(*[None if a is None else jnp.asarray(a.numpy())
                           for a in p])

    return [tuple(one(p) for p in layer) if bidirectional else one(layer)
            for layer in layers]


@pytest.mark.parametrize("kind,bidir,layers", [
    ("lstm", False, 1), ("lstm", True, 2), ("gru", False, 2),
    ("gru", True, 1), ("mlstm", False, 2), ("relu", False, 2),
    ("tanh", True, 1)])
def test_rnn_against_jax(kind, bidir, layers):
    import jax.numpy as jnp

    from ghost_tpu.nn.rnn import rnn_forward

    g = torch.Generator().manual_seed(0)
    params = trnn.init_rnn_params(g, kind, IN, H, num_layers=layers,
                                  bidirectional=bidir)
    x = torch.randn(T, B, IN, generator=g)
    got, lasts = trnn.rnn_forward(kind, params, x, bidirectional=bidir)
    want, jlasts = rnn_forward(kind, _jax_params(params, bidir),
                               jnp.asarray(x.numpy()), bidirectional=bidir)
    assert got.shape == (T, B, H * (2 if bidir else 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)
    flat = [np.asarray(h) for layer in jlasts
            for h in (sum(layer, ()) if bidir else layer)]
    ours = [h.numpy() for layer in lasts
            for h in (sum(layer, ()) if bidir else layer)]
    assert len(ours) == len(flat)
    for a, b in zip(ours, flat):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    if kind in ("lstm", "gru"):
        cls = torch.nn.LSTM if kind == "lstm" else torch.nn.GRU
        ref = cls(IN, H, num_layers=layers, bidirectional=bidir)
        with torch.no_grad():
            for li, layer in enumerate(params):
                for d, p in enumerate(layer if bidir else (layer,)):
                    sfx = f"l{li}" + ("_reverse" if d else "")
                    for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                        torch_name = name.replace("w_", "weight_").replace(
                            "b_", "bias_")
                        getattr(ref, f"{torch_name}_{sfx}").copy_(
                            getattr(p, name))
            y, _ = ref(x)
        np.testing.assert_allclose(got.numpy(), y.numpy(), rtol=0,
                                   atol=2e-6)


def test_rnn_h0_continuation():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 2, 4, generator=g)
    for kind, bidir in (("lstm", False), ("gru", True), ("mlstm", False)):
        params = trnn.init_rnn_params(g, kind, 4, 3, num_layers=2,
                                      bidirectional=bidir)
        y_full, last_full = trnn.rnn_forward(kind, params, x,
                                             bidirectional=bidir)
        y1, h1 = trnn.rnn_forward(kind, params, x[:4], bidirectional=bidir)
        y2, h2 = trnn.rnn_forward(kind, params, x[4:], h0=h1,
                                  bidirectional=bidir)
        if not bidir:  # the reverse direction has no streaming order
            torch.testing.assert_close(torch.cat([y1, y2]), y_full,
                                       rtol=0, atol=1e-6)
            for a, b in zip(h2, last_full):
                torch.testing.assert_close(torch.stack(a), torch.stack(b),
                                           rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        trnn.rnn_forward("lstm", trnn.init_rnn_params(g, "lstm", 4, 3, 2),
                         torch.zeros(4, 2, 4), h0=[None])
    y, _ = trnn.lstm(trnn.init_rnn_params(g, "lstm", 4, 3), x)
    assert y.shape == (8, 2, 3)


def _lattice(seed, b=4, t=9, u=5, v=7):
    rng = np.random.default_rng(seed)
    lp = rng.normal(0, 1, (b, t, u + 1, v)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    labels = rng.integers(1, v, (b, u))
    f_len = np.array([t, t - 2, 3, t])[:b]
    y_len = np.array([u, 2, u, 0])[:b]
    return lp, labels, f_len, y_len


def test_transducer_loss_and_grad_against_jax():
    import jax
    import jax.numpy as jnp

    from ghost_tpu.nn import transducer as jtr

    lp, labels, f_len, y_len = _lattice(2)
    tlp = torch.from_numpy(lp).requires_grad_(True)
    loss = ttr.transducer_loss(tlp, torch.from_numpy(labels),
                               torch.from_numpy(f_len),
                               torch.from_numpy(y_len))
    loss.sum().backward()
    args = tuple(jnp.asarray(a) for a in (labels, f_len, y_len))

    def total(x):
        per = jtr.transducer_loss(x, *args)
        return jnp.sum(per), per

    (_, want), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(lp))
    want, grad = np.asarray(want), np.asarray(grad)
    ref = ttr.transducer_loss_reference(lp, labels, f_len, y_len)
    np.testing.assert_allclose(ref, jtr.transducer_loss_reference(
        lp, labels, f_len, y_len), rtol=0, atol=0)
    np.testing.assert_allclose(loss.detach().numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(loss.detach().numpy(), ref, rtol=1e-5)
    assert np.isfinite(tlp.grad.numpy()).all()
    np.testing.assert_allclose(tlp.grad.numpy(), grad, rtol=0,
                               atol=1e-5 * np.abs(grad).max())


def test_transducer_joint():
    rng = np.random.default_rng(3)
    f = rng.normal(0, 1, (2, 5, 4)).astype(np.float32)
    g = rng.normal(0, 1, (2, 3, 4)).astype(np.float32)
    j = ttr.transducer_joint(torch.from_numpy(f), torch.from_numpy(g),
                             torch.tanh)
    np.testing.assert_array_equal(
        j.numpy(), torch.tanh(torch.from_numpy(f[:, :, None] + g[:, None]))
        .numpy())
    assert ttr.transducer_joint(torch.from_numpy(f), torch.from_numpy(
        g)).shape == (2, 5, 3, 4)
