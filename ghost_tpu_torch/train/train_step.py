"""GAN train steps: the generator step and the periodic discriminator
step, mirroring `ghost_tpu/train/train_step.py`.

  * G step: one forward of AEI-Net in train mode (its encoder's
    BatchNorms move their running statistics), the adversarial /
    identity / attribute / reconstruction losses (canonical) or the
    distillation set (teacher residual, multi-round, identity against the
    teacher, and for round_trip the round trip), one autograd pass and
    one GhostAdam update. D's parameters take no gradient there; the
    frozen ArcFace passes the gradient on to Y.
  * D step: hinge real/fake on the current batch with Y detached, run by
    the loop every `d_interval` G steps.
  * the loss multipliers of the distillation modes are host floats
    (`losses.ratchet_multiplier`) read at every step.

The state lives in the modules and optimizers a `TrainState` holds, and
the steps update it in place (JAX returns a new pytree). The attribute
recompute G.get_attr(Y), and the second and third generator passes of
the distillation modes, run under `nn.layers.frozen_batch_stats`: the
kept statistics are the first forward's, as JAX keeps `new_stats` and
throws the later updates away.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from ghost_tpu_torch.core.precision import disable_tf32
from ghost_tpu_torch.nn.layers import frozen_batch_stats, resize
from ghost_tpu_torch.parallel.collectives import average_gradients
from ghost_tpu_torch.train import losses as L
from ghost_tpu_torch.train.optimizers import GhostAdam, step_lr


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    lr_g: float = 4e-4
    lr_d: float = 4e-4
    b1: float = 0.0
    b2: float = 0.999
    weight_decay: float = 1e-4
    d_interval: int = 10
    mode: str = "canonical"  # canonical | distill | self_distill | round_trip
    eye_loss: bool = False
    # StepLR on both optimizers
    scheduler: bool = False
    scheduler_step: int = 5000
    scheduler_gamma: float = 0.2
    # distillation switches
    teacher_inner_crop: bool = False  # residual on the central 56/128 crop
    teacher_fine_tune: bool = False  # total = 1000 * mult * teacher only
    teacher_lower_signal: bool = False  # fixed low id_hq/teacher/multi mults
    without_teacher_loss: bool = False  # zero the teacher/id_hq/eyes terms


def default_distill_mults() -> dict:
    """Base multipliers of the distillation objective; id, id_hq and eyes
    are the ratchets' starting points."""
    return {
        "id": 3.5,
        "id_hq": 3.0,
        "attr": 3.0,
        "teacher": 30.0,
        "multi_round": 3000.0,
        "adv": 0.5,
        # ratcheted from 1.0 until universal * mult * L_eyes >= 100
        "eyes": 1.0,
    }


@dataclasses.dataclass
class TrainState:
    """G (an AEINet built with train=True) and D (a
    MultiscaleDiscriminator), their GhostAdam optimizers, the G step
    count, the adversarial loss's EMA (an f32 scalar on the card) and the
    ratchets' multipliers (`mults`: JAX's loop keeps them outside its
    state and starts them afresh on every call; here they ride in the
    checkpoint, so a resumed run goes on with the multipliers it had)."""

    g: nn.Module
    d: nn.Module
    g_opt: GhostAdam
    d_opt: GhostAdam
    step: int
    loss_adv_accumulated: torch.Tensor
    mults: dict

    @property
    def device(self) -> torch.device:
        return next(self.g.parameters()).device

    def state_dict(self) -> dict:
        return {"g": self.g.state_dict(), "d": self.d.state_dict(),
                "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict(), "step": self.step,
                "loss_adv_accumulated": self.loss_adv_accumulated,
                "mults": dict(self.mults)}

    def load_state_dict(self, sd: dict) -> None:
        self.g.load_state_dict(sd["g"])
        self.d.load_state_dict(sd["d"])
        self.g_opt.load_state_dict(sd["g_opt"])
        self.d_opt.load_state_dict(sd["d_opt"])
        self.step = int(sd["step"])
        self.loss_adv_accumulated = sd["loss_adv_accumulated"].to(
            self.device, torch.float32)
        self.mults = dict(sd["mults"])


def _make_txs(cfg: TrainStepConfig, g_params, d_params):
    """G's and D's optimizers. With the scheduler, G's lr decays on its
    update count; D updates once every `d_interval` iterations while the
    reference steps D's scheduler every iteration, so D's schedule reads
    its update count k as iteration k * d_interval. (A StepLR stepped
    once per D update would decay D's lr d_interval times slower.)"""
    lr_g, lr_d = cfg.lr_g, cfg.lr_d
    if cfg.scheduler:
        lr_g = step_lr(cfg.lr_g, cfg.scheduler_step, cfg.scheduler_gamma)
        lr_d_iter = step_lr(cfg.lr_d, cfg.scheduler_step, cfg.scheduler_gamma)
        lr_d = lambda count: lr_d_iter(count * cfg.d_interval)  # noqa: E731
    return (GhostAdam(g_params, lr_g, cfg.b1, cfg.b2, cfg.weight_decay),
            GhostAdam(d_params, lr_d, cfg.b1, cfg.b2, cfg.weight_decay))


def init_train_state(gen: nn.Module, disc: nn.Module, cfg: TrainStepConfig,
                     device="cuda") -> TrainState:
    """G and D moved to `device` (the card unless the caller asks for the
    CPU; raises without one) with fresh optimizers. The frozen ArcFace
    (and teacher, FAN) the steps call must sit on the same device."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_train_state: no CUDA card; pass "
                               "device='cpu' to train on the CPU")
        disable_tf32()
    gen, disc = gen.to(device), disc.to(device)
    g_opt, d_opt = _make_txs(cfg, list(gen.parameters()),
                             list(disc.parameters()))
    return TrainState(g=gen, d=disc, g_opt=g_opt, d_opt=d_opt, step=0,
                      loss_adv_accumulated=torch.tensor(
                          4.0, dtype=torch.float32, device=device),
                      mults=default_distill_mults())


def _embed112(arc_apply, x_pm1):
    """ArcFace embedding at 112 through an area downsample."""
    return arc_apply(resize(x_pm1, (112, 112), method="area"))


def _apply_grads(loss, params, opt):
    """One optimizer update from d loss / d params; a parameter the loss
    does not reach takes a zero gradient (decay and moments still move,
    as optax updates every leaf). Inside `parallel.collectives
    .data_parallel` the gradients are first averaged over the group."""
    grads = average_gradients(torch.autograd.grad(
        loss, params, allow_unused=True, materialize_grads=True))
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def make_train_steps(
    arc_apply: Callable,
    cfg: TrainStepConfig,
    weights: L.GeneratorLossWeights = L.GeneratorLossWeights(),
    teacher_apply: Optional[Callable] = None,
    fan_apply: Optional[Callable] = None,
):
    """Returns (g_step, d_step); the steps read G and D from the state
    they are given. `g_step.loss_fn(state, batch, mults)` is the G
    objective alone, (total, aux), as JAX's `g_loss_fn`.

    arc_apply: the frozen ArcFace, (B,112,112,3) in [-1, 1] -> (B,512);
    its parameters should not require grad.
    teacher_apply: the frozen teacher G of self_distill, (xt, z) -> y;
    round_trip takes it too where given (JAX's step reads teacher_y from
    the batch in that mode, which its CLI does not fill), else the
    batch's teacher_y.
    fan_apply: the frozen eye detector, [0, 1] NHWC 256 -> final-stack
    (B,64,64,98) heatmaps; with cfg.eye_loss it adds the pupil-channel
    (96, 97) heatmap loss.
    """
    distill = cfg.mode in ("distill", "self_distill", "round_trip")
    if cfg.mode != "canonical" and not distill:
        raise ValueError(cfg.mode)

    def g_loss_fn(state: TrainState, batch, mults):
        gen, disc = state.g, state.d
        xt, embed, same_person = (batch["xt"], batch["embed"],
                                  batch["same_person"])
        diff_person = batch.get("diff_person")
        if diff_person is None:
            diff_person = torch.ones_like(same_person)

        y, xt_attrs = gen(xt, embed)  # moves the encoder's running stats

        l_adv = L.hinge_g_loss(disc(y), diff_person)
        zy = _embed112(arc_apply, y)
        l_id = L.id_cosine_loss(embed, zy)
        with frozen_batch_stats(gen):
            y_attrs = gen.get_attr(y)
        l_attr = L.attr_loss(xt_attrs, y_attrs)
        l_rec = L.reconstruction_loss(y, xt, same_person)

        l_eyes = None
        if cfg.eye_loss and fan_apply is not None:
            # the eye target is the teacher's output in distill mode, Xt
            # otherwise; FAN reads [0, 1] images
            tgt_img = xt
            if cfg.mode == "distill" and "teacher_y" in batch:
                tgt_img = batch["teacher_y"]
            with torch.no_grad():
                hm_t = fan_apply(tgt_img * 0.5 + 0.5)
            hm_y = fan_apply(y * 0.5 + 0.5)
            l_eyes = L.eye_heatmap_loss(hm_t[..., 96], hm_t[..., 97],
                                        hm_y[..., 96], hm_y[..., 97])

        aux = {"L_adv": l_adv, "L_id": l_id, "L_attr": l_attr,
               "L_rec": l_rec, "Y": y}
        if l_eyes is not None:
            aux["L_eyes"] = l_eyes

        if not distill:
            total = (weights.adv * l_adv + weights.attr * l_attr
                     + weights.id * l_id + weights.rec * l_rec)
            if l_eyes is not None:
                total = total + weights.eyes * l_eyes
            return total, aux

        if cfg.mode in ("self_distill", "round_trip") \
                and teacher_apply is not None:
            with torch.no_grad():
                teacher_y = teacher_apply(xt, embed)
        else:
            teacher_y = batch["teacher_y"]
        with frozen_batch_stats(gen):
            y2, _ = gen(y, embed)
        if cfg.teacher_inner_crop:
            # the central 56/128 of the face
            lo, hi = xt.shape[1] * 28 // 128, xt.shape[1] * 84 // 128
            l_teacher = L.teacher_residual_loss(
                xt[:, lo:hi, lo:hi], teacher_y[:, lo:hi, lo:hi],
                y[:, lo:hi, lo:hi])
        else:
            l_teacher = L.teacher_residual_loss(xt, teacher_y, y)
        l_multi = L.multi_round_loss(y2, y)
        t_embed = batch.get("teacher_embed")
        if t_embed is None:
            with torch.no_grad():
                t_embed = _embed112(arc_apply, teacher_y)
        l_id_hq = L.id_cosine_loss(t_embed, zy)
        m_id_hq, m_teacher, m_multi = (mults["id_hq"], mults["teacher"],
                                       mults["multi_round"])
        if cfg.teacher_lower_signal:
            # fixed low-signal overrides, after the host ratchets
            m_id_hq, m_teacher, m_multi = 0.1, 0.5, 50.0
        zero = cfg.without_teacher_loss
        if cfg.teacher_fine_tune:
            total = (m_teacher * 1000.0) * l_teacher
        else:
            total = weights.universal * (
                mults["id"] * l_id
                + (0.0 if zero else m_id_hq * l_id_hq)
                + mults["attr"] * l_attr
                + (0.0 if zero else m_teacher * l_teacher)
                + m_multi * l_multi
                + mults["adv"] * l_adv)
            if l_eyes is not None and not zero:
                total = total + weights.universal * mults.get(
                    "eyes", 1.0) * l_eyes
        if cfg.mode == "round_trip":
            # G(Y, embedding of Xt) should give Xt back
            zt = _embed112(arc_apply, xt)
            with frozen_batch_stats(gen):
                y_rt, _ = gen(y, zt)
            total = total + weights.universal * mults.get(
                "round_trip", 1.0) * L.round_trip_loss(y_rt, xt)
        aux.update({"L_teacher": l_teacher, "L_multi_round": l_multi,
                    "L_id_hq": l_id_hq})
        return total, aux

    def g_step(state: TrainState, batch):
        """One G update under `state.mults`; returns (state, metrics,
        Y detached)."""
        state.d.requires_grad_(False)
        try:
            loss, aux = g_loss_fn(state, batch, state.mults)
        finally:
            state.d.requires_grad_(True)
        _apply_grads(loss, list(state.g.parameters()), state.g_opt)
        y = aux.pop("Y").detach()
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["lossG"] = loss.detach()
        state.step += 1
        state.loss_adv_accumulated = (state.loss_adv_accumulated * 0.98
                                      + metrics["L_adv"] * 0.02)
        return state, metrics, y

    def d_step(state: TrainState, y_detached, xs, diff_person=None):
        """One D update on (Y detached, Xs); returns (state, loss)."""
        if diff_person is None:
            diff_person = torch.ones(xs.shape[0], dtype=torch.float32,
                                     device=xs.device)
        d_fake = state.d(y_detached.detach())
        d_real = state.d(xs)
        loss = L.hinge_d_loss(d_fake, d_real, diff_person)
        _apply_grads(loss, list(state.d.parameters()), state.d_opt)
        return state, loss.detach()

    g_step.loss_fn = g_loss_fn
    return g_step, d_step
