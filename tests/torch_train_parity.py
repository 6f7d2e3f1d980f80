"""The GAN train step on the card against the CPU, and the helpers the
training tests share. No jax here: `chip_smoke.py` phase 20, the card
tests (tests/test_torch_train_card.py) and the JAX parity tests
(tests/test_torch_train_step.py) use it.

`card_against_cpu` takes one G and one D step from the same state on
the card and on the CPU. In f32 it holds the card's step to the CPU's
beside the CPU's own spread: the same run with the batch's samples in
the other order, the same sums in another order. In bf16 that spread is
no yardstick: reordering the batch leaves each sample's bf16 rounding as
it was (on the card's host, narrow config: G's whole gradient 9e-3 and
D's 1.6e-5 apart), while the card's convolutions
round apart from the CPU's everywhere, and bf16's own error at this
config is large: the CPU's and the card's bf16 gradients of each loss
term both sit 0.1-0.8 (relative L2) from the f32 gradient, dominated by
the large conv weights, and 0.1-0.7 from each other
(scripts/torch_train_bf16_error.py prints these). So in bf16 the
card's step is held to the CPU's f32 step beside the CPU's own bf16 step
against that same f32 step. The bounds, with their reasons:

- every loss term: 1e-4 relative in f32; in bf16 within 5x the CPU's
  largest bf16 error over the terms + 1e-4;
- G's and D's whole gradients (Adam's first moments, b1 = 0: the
  decayed gradient), relative L2: in f32 within 5x the CPU's spread +
  1e-3. cuDNN's f32 algorithms round more than the CPU's (D's gradient
  measured 1.2e-4 from the CPU's where the CPU's own spread is 1e-6); a
  wrong term moves the whole by O(1) of its share (the adversarial
  term's wrong pooling gradient put G's at 1.2e-2). In bf16 within 1.5x
  the CPU's bf16 error + 1e-3: the card makes an error of the same kind
  and size;
- in f32, each tensor's gradient within d = the larger of `grad_bound`
  (1e-2 of its largest value + 1e-6 of the largest over all: JAX's own
  f32 error, see tests/test_torch_train_step.py) and 5x the CPU's
  spread on it (a cancelling scalar such as an AAD mask bias carries
  noise of a few % of itself); each parameter after Adam's step, which
  moves it by lr * g / (|g| + eps), within 1e-6 + lr * min(2, 2 d /
  |g|). In bf16 the card's and the CPU's errors on one tensor are two
  independent samples of bf16's noise, whose largest values over a few
  elements part by more than 5x (measured up to 7.7x), so bf16 holds
  each top-level module's gradient as a whole (G's encoder and
  generator, each scale of D: relative L2 within 1.5x the CPU's bf16
  error + 1e-3) and no single tensor or parameter;
- BN running statistics: 1e-5 relative (+ 1e-7); in bf16, or within 5x
  the CPU's bf16 error on the tensor.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
from ghost_tpu_torch.models.aei import AEINet
from ghost_tpu_torch.models.arcface import IResNet
from ghost_tpu_torch.models.discriminator import MultiscaleDiscriminator
from ghost_tpu_torch.nn.layers import init_weights
from ghost_tpu_torch.train import train_step as tts

LR = 4e-4
# the tier-1 tests' narrow config (tests/test_train_step.py:42-49)
NARROW = dict(batch=2, num_blocks=1, width=1 / 16, ndf=8, n_layers=3,
              num_D=2, arcface_layers=(1, 1, 1, 1))
POLICIES = {"f32": FULL_PRECISION, "bf16": DEFAULT_POLICY}


def gan_models(c=NARROW, policy=FULL_PRECISION, seed=0, device="cpu"):
    """G (AEINet unet, train mode), D (instance norm) and the frozen
    ArcFace of config `c`, seeded weights drawn on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g = init_weights(AEINet("unet", num_blocks=c["num_blocks"], policy=policy,
                            width=c["width"], train=True, device=device), gen)
    d = init_weights(MultiscaleDiscriminator(
        ndf=c["ndf"], n_layers=c["n_layers"], num_D=c["num_D"],
        norm="instance", policy=policy, device=device), gen)
    arc = init_weights(IResNet(c["arcface_layers"], policy=policy,
                               device=device), gen)
    return g, d, arc.requires_grad_(False)


def gan_batches(n, batch=2, seed=0):
    """Seeded host batches: Xs, Xt in [-1, 1], identity embeddings, even
    samples same-person, and a teacher output for the distill modes."""
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    same = (np.arange(batch) % 2 == 0).astype(np.float32)
    return [{"xs": u(batch, 256, 256, 3), "xt": u(batch, 256, 256, 3),
             "embed": rng.standard_normal((batch, 512)).astype(np.float32),
             "same_person": same, "teacher_y": u(batch, 256, 256, 3)}
            for _ in range(n)]


def gan_state(models, mode, d_interval=2):
    """A fresh TrainState on the models' device, and the two steps."""
    g, d, arc = models
    cfg = tts.TrainStepConfig(mode=mode, d_interval=d_interval)
    g_step, d_step = tts.make_train_steps(arc, cfg)
    device = next(arc.parameters()).device
    return tts.init_train_state(g, d, cfg, device=device), g_step, d_step


def state_tensors(st):
    """Every tensor of a TrainState, by name, on the host."""
    sd = st.state_dict()
    out = {f"g.{k}": v for k, v in sd["g"].items()}
    out.update({f"d.{k}": v for k, v in sd["d"].items()})
    for name in ("g_opt", "d_opt"):
        opt = getattr(st, name)
        params = [p for grp in opt.param_groups for p in grp["params"]]
        for i, p in enumerate(params):
            for k, v in opt.state[p].items():
                out[f"{name}.{i}.{k}"] = v
    out["ema"] = st.loss_adv_accumulated
    return {k: v.detach().cpu() for k, v in out.items()}


def moments(opt, module, key="exp_avg"):
    """Adam's moment `key` of every parameter, by name, on the host."""
    names = {id(p): n for n, p in module.named_parameters()}
    return {names[id(p)]: opt.state[p][key].detach().cpu()
            for grp in opt.param_groups for p in grp["params"]}


def grad_bound(want, scale=1.0):
    """A gradient's bound per tensor (numpy or torch): `scale` x (1e-2 of
    its largest value + 1e-6 of the largest over all)."""
    top = max(float(abs(w).max()) for w in want.values())
    return {k: scale * (1e-2 * float(abs(w).max()) + 1e-6 * top)
            for k, w in want.items()}


def swapped(batch):
    """The batch with its samples in the other order."""
    return {k: v[::-1].copy() for k, v in batch.items()}


def rel_l2(got, want, keys):
    num = sum(float((got[k].double() - want[k].double()).square().sum())
              for k in keys)
    den = sum(float(want[k].double().square().sum()) for k in keys)
    return (num / den) ** 0.5


def one_step(models, device, batch, mode):
    """One G and one D step from copies of the models on `device`:
    metrics as floats, first moments by 'g.'/'d.' name, state tensors."""
    st, g_step, d_step = gan_state([copy.deepcopy(m).to(device)
                                    for m in models], mode)
    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    st, met, y = g_step(st, b)
    st, loss_d = d_step(st, y, b["xs"])
    met = {k: float(v) for k, v in met.items()}
    met["lossD"] = float(loss_d)
    mom = {f"g.{k}": v for k, v in moments(st.g_opt, st.g).items()}
    mom.update({f"d.{k}": v for k, v in moments(st.d_opt, st.d).items()})
    return met, mom, state_tensors(st)


def card_against_cpu(batch, device, mode, policy, seed=1, lr=LR):
    """One G+D step of the narrow models (weights from `seed`) under
    `policy` on `device` against the CPU, with the module docstring's
    bounds. In f32 the reference is the CPU's f32 step and the yardstick
    its reordered run; in a 16-bit compute dtype the reference is the
    CPU's f32 step and the yardstick the CPU's own 16-bit step. Returns
    (ok, a one-line report)."""
    sixteen = policy.compute_dtype != torch.float32
    models = gan_models(policy=policy, seed=seed)
    k_met, k_mom, k_st = one_step(models, device, batch, mode)
    if sixteen:
        ref = one_step(gan_models(policy=FULL_PRECISION, seed=seed), "cpu",
                       batch, mode)
        yard = one_step(models, "cpu", batch, mode)
        f_loss, f_whole = 5.0, 1.5
        # reported only: the reordered batch's bf16 spread, no yardstick
        re_mom = one_step(models, "cpu", swapped(batch), mode)[1]
    else:
        ref = one_step(models, "cpu", batch, mode)
        yard = one_step(models, "cpu", swapped(batch), mode)
        f_loss, f_whole = 0.0, 5.0
    (c_met, c_mom, c_st), (s_met, s_mom, s_st) = ref, yard
    ok = k_met.keys() == c_met.keys()
    loss = max(abs(k_met[k] / v - 1) for k, v in c_met.items())
    loss_cpu = max(abs(s_met[k] / v - 1) for k, v in c_met.items())
    ok &= loss <= f_loss * loss_cpu + 1e-4
    worst = {"grad": 0.0, "param": 0.0, "stats": 0.0}
    whole = {}
    for who in ("g.", "d."):
        want = {k: v for k, v in c_mom.items() if k.startswith(who)}
        whole[who] = (rel_l2(k_mom, c_mom, want), rel_l2(s_mom, c_mom, want))
        ok &= whole[who][0] <= f_whole * whole[who][1] + 1e-3
        if sixteen:
            # each top-level module (G's encoder and generator, D's
            # scales) as a whole, not each tensor
            for part in {".".join(k.split(".")[:2]) for k in want}:
                keys = [k for k in want if k.startswith(part + ".")]
                e = rel_l2(k_mom, c_mom, keys)
                worst["grad"] = max(worst["grad"], e / (
                    f_whole * rel_l2(s_mom, c_mom, keys) + 1e-3))
            continue
        bound = grad_bound(want)
        for n, w in want.items():
            bound[n] = max(bound[n], 5 * float((s_mom[n] - w).abs().max()))
            worst["grad"] = max(worst["grad"], float(
                (k_mom[n] - w).abs().max()) / bound[n])
            allowed = 1e-6 + lr * torch.clamp(2 * bound[n] / w.abs(), max=2)
            worst["param"] = max(worst["param"], float(
                ((k_st[n] - c_st[n]).abs() / allowed).max()))
    for n, w in c_st.items():
        if "running" in n:
            allowed = w.abs() * 1e-5 + 1e-7
            if sixteen:
                allowed = torch.clamp(allowed, min=5 * float(
                    (s_st[n] - w).abs().max()))
            worst["stats"] = max(worst["stats"], float(
                ((k_st[n] - w).abs() / allowed).max()))
    ok &= max(worst.values()) <= 1.0
    what = "the CPU's bf16 error" if sixteen else "the CPU's spread"
    per = "module" if sixteen else "tensor"
    report = (
        f"{mode}: loss terms {loss:.2e} ({what} {loss_cpu:.2e}); whole "
        f"gradient G {whole['g.'][0]:.2e} ({whole['g.'][1]:.2e}), D "
        f"{whole['d.'][0]:.2e} ({whole['d.'][1]:.2e}); per {per} at most "
        f"{worst['grad']:.3f} of the gradient bound, parameters "
        f"{worst['param']:.3f}, BN stats {worst['stats']:.3f}")
    if sixteen:
        spread = [rel_l2(re_mom, s_mom, [k for k in s_mom if k.startswith(w)])
                  for w in ("g.", "d.")]
        report += (f"; the CPU's bf16 spread from a reordered batch G "
                   f"{spread[0]:.2e}, D {spread[1]:.2e}")
    return bool(ok), report
