"""pix2pixHD multiscale PatchGAN discriminator, mirroring
`ghost_tpu/models/discriminator.py`.

NLayerDiscriminator: a conv4x4 stride-2 pyramid (padding 2 on every
conv) with LeakyReLU 0.2 and a norm after every conv but the first;
MultiscaleDiscriminator: num_D copies on an `avg_pool_3x3s2` pyramid,
the finest input read by the one named `scale{num_D-1}` (the reference
indexes its sub-discriminators coarsest-first). Takes NHWC images and
returns a list over scales, each a list whose last element is that
scale's logits map (NHWC), with every stage's features before it when
`get_interm_feat`. Inside, maps are NCHW in channels_last memory.
`input_nc` is the input's channels, which flax infers (6 for the SR
trainer's (degraded, image) pairs). The JAX module's `use_sigmoid`,
which nothing sets, is left out.
"""

from __future__ import annotations

from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import (BatchNorm, Conv, avg_pool_3x3s2,
                                       instance_norm, leaky_relu, to_nchw,
                                       to_nhwc)


class NLayerDiscriminator(nn.Module):
    """PatchGAN pyramid; norm in {"instance", "batch", "none"}. The
    instance norm runs in f32 and casts back to the compute dtype; a batch
    norm is eval-mode unless `train`."""

    def __init__(self, ndf=64, n_layers=3, norm="instance",
                 get_interm_feat=False, policy: Policy = DEFAULT_POLICY,
                 train=False, device=None, input_nc=3):
        super().__init__()
        if norm not in ("instance", "batch", "none"):
            raise ValueError(f"unknown norm {norm!r}")
        cd = policy.compute_dtype
        self.policy = policy
        self.norm = norm
        self.n_layers = n_layers
        self.get_interm_feat = get_interm_feat
        nf = ndf
        self.stage0 = Conv(input_nc, nf, 4, 2, padding=2, dtype=cd,
                           device=device)
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 2 if n < n_layers else 1
            self.add_module(f"stage{n}", Conv(nf_prev, nf, 4, stride,
                                              padding=2, dtype=cd,
                                              device=device))
            if norm == "batch":
                self.add_module(f"norm{n}", BatchNorm(
                    nf, dtype=cd, device=device, train=train))
        self.head = Conv(nf, 1, 4, 1, padding=2, dtype=cd, device=device)

    def _norm(self, x, n):
        if self.norm == "instance":
            x = instance_norm(to_nhwc(x).float())
            return to_nchw(x.to(self.policy.compute_dtype))
        if self.norm == "batch":
            return getattr(self, f"norm{n}")(x)
        return x

    def forward(self, x):
        """x: NCHW (channels_last) -> NCHW logits, or every stage's maps."""
        x = leaky_relu(self.stage0(x.to(self.policy.compute_dtype)), 0.2)
        feats = [x]
        for n in range(1, self.n_layers + 1):
            x = getattr(self, f"stage{n}")(x)
            x = leaky_relu(self._norm(x, n), 0.2)
            feats.append(x)
        x = self.head(x)
        feats.append(x)
        return feats if self.get_interm_feat else x


class MultiscaleDiscriminator(nn.Module):
    """num_D PatchGANs over an avg-pool pyramid. forward(x NHWC) -> list
    over scales (finest first) of lists whose last element is the logits
    map (B, h, w, 1) NHWC; `result[i][-1]` is what the hinge losses read."""

    def __init__(self, ndf=64, n_layers=3, num_D=3, norm="instance",
                 get_interm_feat=False, policy: Policy = DEFAULT_POLICY,
                 train=False, device=None, input_nc=3):
        super().__init__()
        self.policy = policy
        self.num_D = num_D
        self.get_interm_feat = get_interm_feat
        for i in range(num_D):
            self.add_module(f"scale{num_D - 1 - i}", NLayerDiscriminator(
                ndf, n_layers, norm, get_interm_feat, policy, train, device,
                input_nc))

    def forward(self, x):
        current = x.to(self.policy.compute_dtype)
        results = []
        for i in range(self.num_D):
            d = getattr(self, f"scale{self.num_D - 1 - i}")
            out = d(to_nchw(current.contiguous()))
            if self.get_interm_feat:
                results.append([to_nhwc(f) for f in out])
            else:
                results.append([to_nhwc(out)])
            if i != self.num_D - 1:
                current = avg_pool_3x3s2(current)
        return results
