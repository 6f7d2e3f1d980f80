"""SPADE building blocks of the SR generator, mirroring
`ghost_tpu/models/sr/spade.py`.

  * SpectralConv: a conv whose weight is divided by sigma = u @ (W v),
    W the (cout, cin*kh*kw) flatten of the (cout, cin, kh, kw) weight
    (`spade.py:60-62`) and (u, v) the flax 'spectral' collection. With
    update_stats=False (inference) the stored pair is used as it is;
    with update_stats=True (training) each call first runs one power
    iteration from the stored u, v first and then u (`spade.py:77-82`),
    takes sigma from the fresh pair and stores it. As in JAX, only the
    stored copies are detached: the gradient of sigma flows through the
    iteration (`torch.nn.utils.spectral_norm` runs it without autograd,
    a different gradient);
  * SPADE: an affine-free batch norm ('syncbatch'; running stats, or in
    train mode the batch statistics with flax's numerics and a
    0.9/0.1 running update) or the mean-free `rms_instance_norm`
    ('instance'), modulated by gamma/beta convs over the nearest-resized
    segmentation map (the input image, or HiFaceGAN's guidance features);
  * SPADEResnetBlock: norm -> leaky_relu(0.2) -> spectral conv, twice,
    plus a learned spectral 1x1 shortcut when fin != fout; `train` runs
    its norms on batch statistics and its convs' power iteration.

`nn.layers.frozen_batch_stats` keeps both kinds of state (BatchNorm's
running statistics and the stored (u, v)) for a call whose updates JAX
throws away.

Tensors are NHWC at every function and module boundary; the convs are
`F.conv2d` on the NCHW (channels_last) view, as the JAX package computes
them with lax outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ghost_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from ghost_tpu_torch.nn.layers import (BatchNorm, Conv, leaky_relu, resize,
                                       rms_instance_norm, to_nchw, to_nhwc)


def conv_nhwc(conv, x):
    """Apply an NCHW conv module to an NHWC tensor; NHWC out."""
    return to_nhwc(conv(to_nchw(x))).contiguous()


class SpectralConv(nn.Module):
    """Spectral-norm conv. Weight (cout, cin, k, k): the flax HWIO kernel
    after transpose(3, 2, 0, 1), whose flatten is torch's (and the JAX
    module's) (cin, kh, kw) order; u (cout,) and v (cin*k*k,) buffers."""

    def __init__(self, cin, features, kernel_size=3, padding=1,
                 use_bias=True, eps: float = 1e-12, dtype=torch.float32,
                 update_stats: bool = False, device=None):
        super().__init__()
        k = kernel_size
        self.padding = padding
        self.eps = eps
        self.dtype = dtype
        # JAX's update_stats: one power iteration per call
        self.power_iteration = update_stats
        # store the fresh pair (off inside `frozen_batch_stats`)
        self.update_stats = True
        self.weight = nn.Parameter(torch.empty(features, cin, k, k,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)
        self.register_buffer("u", torch.empty(features, device=device))
        self.register_buffer("v", torch.empty(cin * k * k, device=device))

    def _nrm(self, t):
        return t / (torch.linalg.norm(t) + self.eps)

    def reset_parameters(self, generator):
        nn.init.xavier_normal_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        w_mat = self.weight.reshape(self.weight.shape[0], -1)
        u = torch.randn(self.u.shape, generator=generator)
        self.u.copy_(self._nrm(u))
        self.v.copy_(self._nrm(w_mat.T @ self.u))

    def forward(self, x):
        w_mat = self.weight.reshape(self.weight.shape[0], -1)
        u, v = self.u, self.v
        if self.power_iteration:
            # a copy: the stored u is overwritten below, and autograd
            # keeps the one this product read
            v = self._nrm(w_mat.T @ u.clone())
            u = self._nrm(w_mat @ v)
            if self.update_stats:
                with torch.no_grad():
                    self.u.copy_(u)
                    self.v.copy_(v)
        sigma = u @ (w_mat @ v)
        w_sn = (self.weight / sigma).to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(to_nchw(x.to(self.dtype)), w_sn, b, 1, self.padding)
        return to_nhwc(y).contiguous()


class SPADE(nn.Module):
    """norm_nc-channel SPADE modulation conditioned on the input image
    (label_nc channels)."""

    def __init__(self, norm_nc, param_free: str = "syncbatch", ks: int = 3,
                 label_nc: int = 3, policy: Policy = DEFAULT_POLICY,
                 train: bool = False, device=None):
        super().__init__()
        cd = policy.compute_dtype
        self.param_free = param_free
        self.policy = policy
        if param_free != "instance":
            self.pfn = BatchNorm(norm_nc, eps=1e-5, dtype=cd, device=device,
                                 affine=False, train=train)
        nhidden = 128 if norm_nc > 128 else norm_nc
        pw = ks // 2
        self.mlp_shared = Conv(label_nc, nhidden, ks, padding=pw, dtype=cd,
                               device=device)
        self.mlp_gamma = Conv(nhidden, norm_nc, ks, padding=pw,
                              use_bias=False, dtype=cd, device=device)
        self.mlp_beta = Conv(nhidden, norm_nc, ks, padding=pw, use_bias=False,
                             dtype=cd, device=device)

    def forward(self, x, segmap):
        cd = self.policy.compute_dtype
        if self.param_free == "instance":
            normalized = rms_instance_norm(x.float()).to(cd)
        else:
            normalized = to_nhwc(self.pfn(to_nchw(x)))
        seg = resize(segmap, tuple(x.shape[1:3]), method="nearest")
        actv = torch.relu(conv_nhwc(self.mlp_shared, seg.to(cd)))
        gamma = conv_nhwc(self.mlp_gamma, actv)
        beta = conv_nhwc(self.mlp_beta, actv)
        return normalized * gamma + beta


class SPADEResnetBlock(nn.Module):
    """label_nc: the channels of the segmentation map its norms read."""

    def __init__(self, fin, fout, param_free: str = "syncbatch",
                 policy: Policy = DEFAULT_POLICY, train: bool = False,
                 label_nc: int = 3, device=None):
        super().__init__()
        cd = policy.compute_dtype
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        kw = dict(param_free=param_free, label_nc=label_nc, policy=policy,
                  train=train, device=device)
        sn = dict(dtype=cd, update_stats=train, device=device)
        self.norm_0 = SPADE(fin, **kw)
        self.conv_0 = SpectralConv(fin, fmiddle, 3, 1, **sn)
        self.norm_1 = SPADE(fmiddle, **kw)
        self.conv_1 = SpectralConv(fmiddle, fout, 3, 1, **sn)
        if self.learned_shortcut:
            self.norm_s = SPADE(fin, **kw)
            self.conv_s = SpectralConv(fin, fout, 1, 0, use_bias=False, **sn)

    def forward(self, x, seg):
        dx = self.conv_0(leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(leaky_relu(self.norm_1(dx, seg), 0.2))
        xs = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        return xs + dx
