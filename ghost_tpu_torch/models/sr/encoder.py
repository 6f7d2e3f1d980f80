"""Conv VAE encoder (mu, logvar), mirroring `ghost_tpu/models/sr/encoder.py`
(reference models/networks/encoder.py:13-55): 6 stride-2 3x3 convs, each
followed by an f32 instance norm and LeakyReLU(0.2), then two f32 dense
heads for mu and logvar.

The heads read the last map flattened in NHWC order (y, x, c), as the
JAX module's `reshape(B, -1)` does, so the bridge's `fc_mu`/`fc_var`
kernels fit it as they are. flax infers the heads' input width from the
first call; here it comes from `image_size` (6 halvings of it).
"""

from __future__ import annotations

from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import Conv, Dense, instance_norm, leaky_relu

from .spade import conv_nhwc

PLAN = (1, 2, 4, 8, 8, 8)


class ConvEncoder(nn.Module):
    """forward(x NHWC (B, image_size, image_size, in_ch)) -> (mu, logvar),
    each (B, z_dim) f32."""

    def __init__(self, ndf: int = 64, z_dim: int = 256,
                 policy: Policy = DEFAULT_POLICY, image_size: int = 256,
                 in_ch: int = 3, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.policy = policy
        cin, s = in_ch, image_size
        for i, mult in enumerate(PLAN):
            setattr(self, f"layer{i}", Conv(cin, ndf * mult, 3, 2, padding=1,
                                            dtype=cd, device=device))
            cin, s = ndf * mult, (s - 1) // 2 + 1
        self.fc_mu = Dense(cin * s * s, z_dim, device=device)
        self.fc_var = Dense(cin * s * s, z_dim, device=device)

    def forward(self, x):
        cd = self.policy.compute_dtype
        h = x.to(cd)
        for i in range(len(PLAN)):
            h = conv_nhwc(getattr(self, f"layer{i}"), h)
            h = leaky_relu(instance_norm(h.float()).to(cd), 0.2)
        h = h.reshape(h.shape[0], -1).float()
        return self.fc_mu(h), self.fc_var(h)
