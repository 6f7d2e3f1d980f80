"""RNN-Transducer joint + loss (apex transducer parity), mirroring
`ghost_tpu/nn/transducer.py`.

The reference vendors transducer_joint_cuda / transducer_loss_cuda
(reference apex/apex/contrib/csrc/transducer/*.cu). SURVEY.md marks it
out of scope for face-swap but part of the apex capability surface:

  * `transducer_joint`: broadcast-add of encoder (B,T,H) and predictor
    (B,U,H) activations -> (B,T,U,H);
  * `transducer_loss`: the RNN-T negative log-likelihood via the alpha
    recursion over anti-diagonals, as the JAX package computes it: T+U-1
    sequential steps, each one vectorized (B, U+1) update, with
    NEG_INF = -1e30 (not -inf) for the cells off the lattice, so that
    autograd through logaddexp gives no NaN. Gradients come from
    autograd of the recursion;
  * `transducer_loss_reference`: the plain float64 DP for tests.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def transducer_joint(f_enc, g_pred, activation=None):
    """(B,T,H) + (B,U,H) -> (B,T,U,H) joint tensor."""
    joint = f_enc[:, :, None, :] + g_pred[:, None, :, :]
    if activation is not None:
        joint = activation(joint)
    return joint


def transducer_loss(log_probs, labels, f_len, y_len, blank_idx: int = 0):
    """RNN-T loss.

    log_probs: (B, T, U+1, V) log-softmax outputs;
    labels: (B, U) int targets;
    f_len: (B,) valid encoder lengths; y_len: (B,) valid label lengths.
    Returns (B,) negative log-likelihoods.
    """
    b, t_max, u_max1, _v = log_probs.shape
    dev = log_probs.device
    labels = torch.as_tensor(labels, device=dev).long()
    f_len = torch.as_tensor(f_len, device=dev).long()
    y_len = torch.as_tensor(y_len, device=dev).long()

    # per-cell transition log-probs
    lp_blank = log_probs[..., blank_idx]  # (B,T,U+1)
    label_idx = F.pad(labels, (0, 1), value=0)  # (B,U+1); last unused
    lp_emit = torch.gather(
        log_probs, 3,
        label_idx[:, None, :, None].expand(b, t_max, u_max1, 1))[..., 0]

    # alpha over anti-diagonals d = t + u:
    #   alpha[t,u] = logaddexp(alpha[t-1,u] + blank[t-1,u],
    #                          alpha[t,u-1] + emit[t,u-1])
    # Both parents of every cell on diagonal d live on diagonal d-1.
    # Diagonal state is indexed by u: diag_d[u] = alpha[d-u, u].
    blank_ut = lp_blank.transpose(1, 2)  # (B,U+1,T) u-major
    emit_ut = lp_emit.transpose(1, 2)
    u_ar = torch.arange(u_max1, device=dev)

    def gather_t(table_ut, t_idx):
        # table (B,U+1,T), t_idx (U+1,) -> out[:, u] = table[:, u, t_idx[u]]
        idx = torch.clamp(t_idx, 0, t_max - 1)[None, :, None].expand(
            b, u_max1, 1)
        return torch.gather(table_ut, 2, idx)[..., 0]

    neg = torch.full((), NEG_INF, dtype=log_probs.dtype, device=dev)
    neg_col = neg.expand(b, 1)
    diag = torch.where(u_ar[None, :] == 0, torch.zeros_like(neg),
                       neg).expand(b, u_max1)  # diagonal d=0
    diags = [diag]
    for d in range(1, t_max + u_max1 - 1):
        t_u = d - u_ar  # (U+1,) the t-coordinate of each lane
        cell_ok = (t_u >= 0) & (t_u < t_max)
        # from above: diag_{d-1}[u] = alpha[t-1,u]; + blank[t-1,u]
        above = diag + gather_t(blank_ut, t_u - 1)
        above = torch.where((t_u >= 1)[None, :], above, neg)
        # from left: diag_{d-1}[u-1] = alpha[t,u-1]; + emit[t,u-1].
        # gather_t(emit_ut, t_u - 1)[u-1] == emit[u-1, d-u] == emit[t,u-1]
        g = gather_t(emit_ut, t_u - 1)
        left = (torch.cat([neg_col, diag[:, :-1]], dim=1)
                + torch.cat([neg_col, g[:, :-1]], dim=1))
        diag = torch.where(cell_ok[None, :], torch.logaddexp(above, left),
                           neg)
        diags.append(diag)
    diags = torch.stack(diags, 0)  # (T+U, B, U+1)

    # ll = alpha[f_len-1, y_len] + blank[f_len-1, y_len]; the diagonal
    # holding alpha[t,u] is d = t + u
    t_idx = torch.clamp(f_len - 1, min=0)
    rows = torch.arange(b, device=dev)
    gather_alpha = diags[t_idx + y_len, rows, y_len]
    gather_blank = lp_blank[rows, t_idx, y_len]
    return -(gather_alpha + gather_blank)


def transducer_loss_reference(log_probs, labels, f_len, y_len,
                              blank_idx: int = 0):
    """Plain-python DP for tests (single batch loops), in float64."""
    if isinstance(log_probs, torch.Tensor):
        log_probs = log_probs.detach().cpu().numpy()
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    lp = np.asarray(log_probs, np.float64)
    b, t_max, u_max1, _ = lp.shape
    out = np.zeros(b)
    for i in range(b):
        T, U = int(f_len[i]), int(y_len[i])
        alpha = np.full((T, U + 1), -np.inf)
        alpha[0, 0] = 0.0
        for t in range(T):
            for u in range(U + 1):
                if t == 0 and u == 0:
                    continue
                cands = []
                if t > 0:
                    cands.append(alpha[t - 1, u] + lp[i, t - 1, u, blank_idx])
                if u > 0:
                    cands.append(alpha[t, u - 1]
                                 + lp[i, t, u - 1, labels[i, u - 1]])
                alpha[t, u] = np.logaddexp.reduce(cands)
        out[i] = -(alpha[T - 1, U] + lp[i, T - 1, U, blank_idx])
    return out
