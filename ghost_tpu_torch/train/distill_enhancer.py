"""Enhancer distillation: compress a heavy enhancer teacher (RRDBNet
x4plus, GFPGANClean) into the cheap SRVGG serving trunk, mirroring
`ghost_tpu/train/distill_enhancer.py`.

  * `degrade` — the on-device degradation sampler (blur -> down/up
    wobble -> noise -> downscale) that turns HQ crops into training LQ
    inputs. It is split in two: `degrade_draws` makes the random draws
    from an explicit `torch.Generator`, `degrade_with` is the
    deterministic body that takes them (the JAX function's `lax.switch`
    over the wobble scales and its final `lax.cond` pick one branch on
    the host, and only that branch runs);
  * `make_teacher_fn` — a frozen teacher as a target oracle;
  * `face_student_wrapper` — an up-2x student in the GFPGAN seat;
  * `make_enhancer_distill_step` — L1 (+ an optional perceptual term)
    and one Adam update of the student. The student's convs are
    `nn.layers.Conv3x3`: on the card each runs S2 forward, and its dx
    runs S2 on the turned kernel in the backward.

A torch module holds its own weights, so where the JAX functions take a
variables tree beside the module, these take the module.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from ghost_tpu_torch.nn.layers import resize
from ghost_tpu_torch.train.optimizers import GhostAdam
from ghost_tpu_torch.train.train_step import _apply_grads

# ---------------------------------------------------------------------------
# Degradation sampling
# ---------------------------------------------------------------------------


def _gaussian_blur(x, sigma, taps: int = 11):
    """Separable Gaussian blur with a per-image sigma, in x's dtype.

    The taps are computed from `sigma` (B,) with a floor of 1e-3 and
    normalised, then applied along H and then W to the edge-padded image
    as a sum of shifted copies. x: (B, H, W, C)."""
    half = taps // 2
    offs = torch.arange(-half, half + 1, dtype=x.dtype, device=x.device)
    s = torch.clamp(sigma, min=1e-3)[:, None]
    k = torch.exp(-0.5 * (offs[None, :] / s) ** 2)
    k = k / torch.sum(k, dim=1, keepdim=True)

    def blur_axis(img, axis):
        n = img.shape[axis]
        idx = torch.clamp(torch.arange(-half, n + half, device=img.device),
                          0, n - 1)
        padded = torch.index_select(img, axis, idx)  # edge padding
        out = torch.zeros_like(img)
        for i in range(taps):
            w = k[:, i].reshape((-1,) + (1,) * (img.ndim - 1))
            out = out + w * padded.narrow(axis, i, n)
        return out

    return blur_axis(blur_axis(x, 1), 2)


@dataclasses.dataclass
class DegradeDraws:
    """The random draws of one `degrade` call: the blur sigma (B,), the
    wobble branch, the noise std (B,1,1,1) and the unit normal noise
    (B,H,W,C), and whether the final downscale is area (else bilinear)."""

    sigma: torch.Tensor
    wobble: int
    std: torch.Tensor
    noise: torch.Tensor
    area: bool


def degrade_draws(generator: torch.Generator, shape, dtype=torch.float32,
                  sigma_range: tuple[float, float] = (0.1, 2.5),
                  noise_range: tuple[float, float] = (0.0, 0.06),
                  n_wobble: int = 3) -> DegradeDraws:
    """The draws of `degrade` for an HQ batch of `shape` (B, H, W, C),
    from `generator` on its device (the two branch choices are read on
    the host: one sync)."""
    b = shape[0]
    dev = generator.device
    u = lambda *s: torch.rand(s, generator=generator, device=dev,  # noqa: E731
                              dtype=dtype)
    sigma = sigma_range[0] + (sigma_range[1] - sigma_range[0]) * u(b)
    wobble = torch.randint(0, n_wobble, (), generator=generator, device=dev)
    std = noise_range[0] + (noise_range[1] - noise_range[0]) * u(b, 1, 1, 1)
    noise = torch.randn(tuple(shape), generator=generator, device=dev,
                        dtype=dtype)
    area = u() < 0.5
    wobble, area = torch.stack([wobble, area.long()]).tolist()
    return DegradeDraws(sigma, int(wobble), std, noise, bool(area))


def degrade_with(hq01, draws: DegradeDraws, lq_size: tuple[int, int],
                 wobble_scales: tuple[float, ...] = (1.0, 0.75, 0.5)):
    """The deterministic body of `degrade` on given draws: blur, the
    picked down/up wobble (`mid = max(int(h * s), 8)` area down, bilinear
    back up; none at scale 1), noise, clip, the picked final resize to
    `lq_size`, clip. All in [0, 1], NHWC."""
    _, h, w, _ = hq01.shape
    x = _gaussian_blur(hq01, draws.sigma)
    scale = wobble_scales[draws.wobble]
    if scale != 1.0:
        mid = (max(int(h * scale), 8), max(int(w * scale), 8))
        x = resize(resize(x, mid, method="area"), (h, w), method="bilinear")
    x = x + draws.std * draws.noise
    x = torch.clamp(x, 0.0, 1.0)
    down = resize(x, lq_size, method="area" if draws.area else "bilinear")
    return torch.clamp(down, 0.0, 1.0)


def degrade(generator: torch.Generator, hq01, lq_size: tuple[int, int],
            sigma_range: tuple[float, float] = (0.1, 2.5),
            noise_range: tuple[float, float] = (0.0, 0.06),
            wobble_scales: tuple[float, ...] = (1.0, 0.75, 0.5)):
    """Sample LQ inputs from HQ images [0, 1] NHWC: Gaussian blur with a
    random per-image sigma, a random intermediate down/up wobble,
    additive Gaussian noise, then the final downscale to `lq_size` (area
    or bilinear at random). A light stand-in for the Real-ESRGAN
    second-order degradation (JPEG artifacts excluded)."""
    draws = degrade_draws(generator, hq01.shape, hq01.dtype, sigma_range,
                          noise_range, len(wobble_scales))
    return degrade_with(hq01, draws, lq_size, wobble_scales)


# ---------------------------------------------------------------------------
# Teachers and students
# ---------------------------------------------------------------------------


def make_teacher_fn(teacher_mod: Callable,
                    out_range: tuple[float, float] = (0.0, 1.0)) -> Callable:
    """A frozen teacher as a target oracle: no autograd, a tuple output
    (GFPGANClean's (image, rgbs)) unwrapped to its first element, the
    result clipped to the teacher's own range (out_range=(-1, 1) for
    GFPGAN; the default (0, 1) fits RRDB and SRVGG)."""

    def teacher(lq):
        with torch.no_grad():
            out = teacher_mod(lq)
            if isinstance(out, (tuple, list)):
                out = out[0]
            return torch.clamp(out, out_range[0], out_range[1])

    return teacher


class _FaceStudent(nn.Module):
    """An up-2x student in the GFPGAN seat: a [-1, 1] crop in, the
    restored crop of the same size in [-1, 1] out. The student reads the
    crop area-downscaled 2x in [0, 1] (clipped). No output clip: clip's
    zero gradient on saturated pixels would freeze the regions the L1
    term has to pull back (serving clamps at the u8 write)."""

    def __init__(self, student_mod: nn.Module):
        super().__init__()
        self.student_mod = student_mod

    def forward(self, crop_pm1):
        _, h, w, _ = crop_pm1.shape
        lq01 = resize(crop_pm1 * 0.5 + 0.5, (h // 2, w // 2), method="area")
        return self.student_mod(torch.clamp(lq01, 0.0, 1.0)) * 2.0 - 1.0


def face_student_wrapper(student_mod: nn.Module) -> _FaceStudent:
    """Adapt an up-2x student to the GFPGAN seat (see `_FaceStudent`)."""
    return _FaceStudent(student_mod)


# ---------------------------------------------------------------------------
# Distillation step
# ---------------------------------------------------------------------------


def make_enhancer_distill_step(
    student_mod: nn.Module,
    lr: float = 2e-4,
    l1_mult: float = 1.0,
    perceptual_fn: Optional[Callable] = None,
    perceptual_mult: float = 0.0,
    opt: Optional[torch.optim.Optimizer] = None,
):
    """Returns (step, opt); step(lq, target) -> metrics ({"l1", "loss"}
    and "perceptual" with a perceptual term) and updates the student in
    place.

    The loss is L1 between the student's output on lq and the teacher's
    `target` for the same batch (which takes no gradient), plus
    `perceptual_mult * perceptual_fn(y, target)` where both are given.
    The default optimizer is Adam(lr, b1=0.9, b2=0.999) without weight
    decay (optax's `adam`, the Real-ESRGAN recipe), not the GAN's
    b1 = 0, L2-coupled `ghost_adam`."""
    params = [p for p in student_mod.parameters() if p.requires_grad]
    if opt is None:
        opt = GhostAdam(params, lr, b1=0.9, b2=0.999, weight_decay=0.0)

    def step(lq, target):
        y = student_mod(lq)
        target = target.detach()
        l1 = torch.mean(torch.abs(y - target))
        loss = l1_mult * l1
        metrics = {"l1": l1}
        if perceptual_fn is not None and perceptual_mult:
            lp = perceptual_fn(y, target)
            loss = loss + perceptual_mult * lp
            metrics["perceptual"] = lp
        metrics["loss"] = loss
        _apply_grads(loss, params, opt)
        return {k: v.detach() for k, v in metrics.items()}

    return step, opt


def make_self_distill_batch_fn(teacher_fn: Callable,
                               lq_size: tuple[int, int], **degrade_kwargs):
    """HQ -> (lq, target): degrade HQ on its device and run the teacher on
    the LQ batch. Returns fn(generator, hq01) -> (lq, target) for
    `make_enhancer_distill_step`'s step."""

    def sample(generator, hq01):
        lq = degrade(generator, hq01, lq_size, **degrade_kwargs)
        return lq, teacher_fn(lq)

    return sample
