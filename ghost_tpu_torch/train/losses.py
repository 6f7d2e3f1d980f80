"""GHOST training losses, mirroring `ghost_tpu/train/losses.py` term for
term: the canonical set (hinge adversarial for G and D, identity cosine,
attribute L2 over the 8 encoder maps, same-person reconstruction L2,
eye-heatmap L2), the distillation fork's (teacher residual, multi-round
stability, round trip) and the auxiliary consistency losses. Tensors
are NHWC; the f32 casts sit where the JAX functions cast, so a bf16
model's losses reduce as JAX reduces them.

Every reduction over the batch goes through `global_sum` / `global_mean`
(`parallel/collectives.py`): the local sum and mean, except inside
`data_parallel(group)`, where they are the group's, with autograd. The
data-parallel step's losses are then the global batch's on every rank:
the masked ratios of the hinge and reconstruction terms divide global
sums, and the teacher term's Frobenius norm is the whole batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from ghost_tpu_torch.parallel.collectives import global_mean, global_sum


# --------------------------------------------------------------- adversarial
def hinge_g_loss(d_outputs, diff_person):
    """Sum over scales of mean relu(1 - D(Y)), weighted by the
    diff-person mask."""
    total = 0.0
    for di in d_outputs:
        total = total + torch.mean(torch.clamp(1.0 - di[-1], min=0.0),
                                   dim=(1, 2, 3))
    return global_sum(torch.sum(total * diff_person)) / (
        global_sum(torch.sum(diff_person)) + 1e-4)


def hinge_d_loss(d_fake, d_real, diff_person):
    """0.5 * (real hinge + fake hinge), each a diff-person weighted mean
    summed over scales."""
    den = global_sum(torch.sum(diff_person)) + 1e-4
    loss_fake = 0.0
    for di in d_fake:
        per = torch.mean(torch.clamp(di[-1] + 1.0, min=0.0), dim=(1, 2, 3))
        loss_fake = loss_fake + global_sum(torch.sum(per * diff_person)) / den
    loss_real = 0.0
    for di in d_real:
        per = torch.mean(torch.clamp(1.0 - di[-1], min=0.0), dim=(1, 2, 3))
        loss_real = loss_real + global_sum(torch.sum(per * diff_person)) / den
    return 0.5 * (loss_real + loss_fake)


# ------------------------------------------------------------------ identity
def id_cosine_loss(embed_src, embed_out):
    """Mean of 1 - cos over the batch."""
    num = torch.sum(embed_src * embed_out, dim=-1)
    den = (torch.linalg.vector_norm(embed_src, dim=-1)
           * torch.linalg.vector_norm(embed_out, dim=-1))
    return global_mean(1.0 - num / torch.clamp(den, min=1e-8))


# ----------------------------------------------------------------- attribute
def attr_loss(xt_attrs: Sequence, y_attrs: Sequence):
    """0.5 * sum_k mean_b mean_i (xt_k - y_k)^2, in f32."""
    total = 0.0
    for xa, ya in zip(xt_attrs, y_attrs):
        per_sample = torch.mean(torch.square(xa.float() - ya.float()),
                                dim=(1, 2, 3))
        total = total + global_mean(per_sample)
    return total / 2.0


# ------------------------------------------------------------ reconstruction
def reconstruction_loss(y, xt, same_person):
    """0.5 * MSE per sample, averaged over the same-person pairs."""
    per = 0.5 * torch.mean(torch.square(y.float() - xt.float()),
                           dim=(1, 2, 3))
    return global_sum(torch.sum(per * same_person)) / (
        global_sum(torch.sum(same_person)) + 1e-6)


# ------------------------------------------------------------------- eyes
def eye_heatmap_loss(xt_left, xt_right, y_left, y_right):
    """L2 on the two pupil heatmaps."""
    return (global_mean(torch.square(xt_left - y_left))
            + global_mean(torch.square(xt_right - y_right)))


# ----------------------------------------------------- distillation (fork)
def teacher_residual_loss(xt, teacher_y, y):
    """||(Xt - tY) - (Xt - Y)||_2: the Frobenius norm, not a mean."""
    diff = (xt - teacher_y) - (xt - y)
    return torch.sqrt(global_sum(torch.sum(torch.square(diff.float())))
                      + 1e-12)


def multi_round_loss(y2, y):
    """MSE(G(G(x)), G(x)) stability."""
    return global_mean(torch.square(y2.float() - y.float()))


def round_trip_loss(x_round_trip, xs):
    """MSE(G(Y, Z_Xt), Xt)."""
    return global_mean(torch.square(x_round_trip.float() - xs.float()))


# ------------------------------------------------- aux consistency (helpers)
def to_grayscale(x):
    """Luminosity grayscale, NHWC, keeping the channel axis."""
    w = torch.tensor([0.2989, 0.5870, 0.1140], dtype=x.dtype, device=x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)


def structural_loss(a, b):
    """Grayscale MSE."""
    return torch.mean(torch.square(to_grayscale(a) - to_grayscale(b)))


def edge_loss(a, b, n: int = 5):
    """MSE over the n-px border bands (top, bottom, left, right)."""
    return (torch.mean(torch.square(a[:, :n] - b[:, :n]))
            + torch.mean(torch.square(a[:, -n:] - b[:, -n:]))
            + torch.mean(torch.square(a[:, :, :n] - b[:, :, :n]))
            + torch.mean(torch.square(a[:, :, -n:] - b[:, :, -n:])))


_EMBOSS = ((-2.0, -1.0, 0.0), (-1.0, 1.0, 1.0), (0.0, 1.0, 2.0))


def emboss_loss(a, b):
    """MSE of the emboss-filtered, min-max scaled channel means. The
    kernel is f32, as in JAX, which refuses other image dtypes."""
    k = torch.tensor(_EMBOSS, dtype=torch.float32,
                     device=a.device).view(1, 1, 3, 3)

    def emboss(x):
        g = torch.mean(x, dim=-1, keepdim=True)
        g = (g - g.min()) / (g.max() - g.min() + 1e-5)
        return F.conv2d(g.permute(0, 3, 1, 2), k, padding=1)

    return torch.mean(torch.square(emboss(a) - emboss(b)))


def masked_color_consistency_loss(images, masks):
    """Mean per-channel colour variance over the pixels where mask == 0."""
    valid = (masks == 0).float()
    num = torch.clamp(torch.sum(valid, dim=(1, 2)), min=1.0)
    mean = torch.sum(images * valid, dim=(1, 2)) / num
    sq = torch.sum(torch.square(images) * valid, dim=(1, 2)) / num
    var = sq - torch.square(mean)
    return torch.mean(torch.mean(var, dim=-1))


# ----------------------------------------------------------------- weights
@dataclasses.dataclass(frozen=True)
class GeneratorLossWeights:
    """Canonical GHOST weights (the train CLI's defaults) and the fork's
    multipliers."""

    adv: float = 1.0
    attr: float = 10.0
    id: float = 15.0
    rec: float = 10.0
    eyes: float = 0.0
    # fork-style distillation weights
    universal: float = 100.0
    teacher: float = 30.0
    multi_round: float = 3000.0
    round_trip: float = 0.0


def ratchet_multiplier(value: float, multiplier: float, floor: float,
                       universal: float = 100.0, factor: float = 1.1,
                       max_mult: float = 1e6) -> float:
    """Host-side loss-multiplier ratchet: grow `multiplier` by `factor`
    until universal * multiplier * value >= floor."""
    value = float(value)
    if value <= 0.0:
        return multiplier
    while universal * multiplier * value < floor and multiplier < max_mult:
        multiplier *= factor
    return multiplier
