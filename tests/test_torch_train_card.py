"""The GAN train step on the card, and its refusal without one.

The card tests hold the tier-1 narrow config (AEINet unet, 1 block,
width 1/16, train=True; MultiscaleDiscriminator(ndf=8, n_layers=3,
num_D=2); ArcFace (1,1,1,1); B=2 at 256 px; seeded weights) on the
card against the same state on the CPU, in f32 and in bf16, with the
bounds of `card_against_cpu` (tests/torch_train_parity.py), and the
resume bits on the card. No JAX is imported, so they run where jax is
not installed:
    python -m pytest --noconftest -m gpu tests/test_torch_train_card.py
"""

import copy

import numpy as np
import pytest
import torch

from ghost_tpu_torch.core.checkpoint import CheckpointManager
from ghost_tpu_torch.train import train_step as tts
from ghost_tpu_torch.train.loop import LoopConfig, train_loop
from torch_train_parity import (POLICIES, card_against_cpu, gan_batches,
                                gan_models, gan_state)


def _state(models, mode):
    return gan_state([copy.deepcopy(m) for m in models], mode)


def test_entry_point_needs_a_card_by_default():
    """init_train_state runs on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    g, d, _ = gan_models(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tts.init_train_state(g, d, tts.TrainStepConfig())


@pytest.mark.gpu
def test_avg_pool_gradient_on_card():
    """avg_pool_3x3s2 and its gradient on the card equal the CPU's on a
    (2,256,256,3) map (f32, 1e-6): the discriminator's pyramid carries
    the adversarial loss's gradient to Y through it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ghost_tpu_torch.nn.layers import avg_pool_3x3s2

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 256, 256, 3))
                         .astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (2, 128, 128, 3))
                         .astype(np.float32))
    res = []
    for dev in ("cpu", "cuda"):
        xx = x.to(dev).requires_grad_(True)
        y = avg_pool_3x3s2(xx)
        dx, = torch.autograd.grad(y, xx, g.to(dev))
        res.append((y.detach().cpu(), dx.cpu()))
    for a, b in zip(*res):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["canonical", "round_trip"])
def test_g_and_d_step_on_card_match_cpu(mode, policy):
    """One G and one D step on the card and on the CPU from the same
    seeded state, in f32 beside the CPU's own spread (the batch's samples
    in the other order), in bf16 against the CPU's f32 step beside the
    CPU's own bf16 step: `card_against_cpu`, whose docstring
    (tests/torch_train_parity.py) gives the bounds and their reasons;
    `chip_smoke.py` phase 20 (a1) runs the same check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ok, report = card_against_cpu(gan_batches(1, seed=2)[0], "cuda", mode,
                                  POLICIES[policy], seed=1)
    assert ok, report


@pytest.mark.gpu
def test_resume_on_card_is_bit_exact(tmp_path):
    """On the card with deterministic cuDNN: 5 iterations saving at step
    3; a state of other weights restored from it takes iteration 4 equal
    to the uninterrupted run's in every tensor, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        batches = gan_batches(5, seed=3)
        models = gan_models(seed=4)
        lcfg = LoopConfig(d_interval=2, print_interval=100, show_step=10**9,
                          save_interval=3, distill=True)
        mgr = CheckpointManager(tmp_path / "ck")
        st, g_step, d_step = _state(
            [m.cuda() for m in models], "distill")
        full, _ = train_loop(st, g_step, d_step, batches, lcfg,
                             checkpoint_manager=mgr, max_steps=5)
        other = gan_models(seed=5)
        st, _, _ = _state((other[0].cuda(), other[1].cuda(), models[2]),
                          "distill")
        st = mgr.restore(3, like=st)
        resumed, _ = train_loop(st, g_step, d_step, batches[4:], lcfg,
                                start_iteration=4, max_steps=5)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            prev
    a, b = full.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 5 and a["mults"] == b["mults"]
    for key in ("g", "d"):
        for k, v in a[key].items():
            assert torch.equal(v, b[key][k]), (key, k)
    for key in ("g_opt", "d_opt"):
        sa, sb = a[key]["state"], b[key]["state"]
        assert sa.keys() == sb.keys() and a[key]["count"] == b[key]["count"]
        for i in sa:
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), (key, i, k)
    assert torch.equal(full.loss_adv_accumulated,
                       resumed.loss_adv_accumulated)
