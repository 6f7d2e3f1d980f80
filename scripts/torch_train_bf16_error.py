"""bf16's own error in the GAN train step, on the CPU and on the card.

At the tier-1 tests' narrow config (tests/torch_train_parity.py's
NARROW, weights from --seed) one canonical G objective is run in f32 on
the CPU (the reference), and in bf16 (DEFAULT_POLICY) on the CPU and on
the card. It prints each loss term, the relative L2 distance of each
term's gradient to G's parameters from the f32 one (bf16 on the CPU,
bf16 on the card, f32 on the card) and between the two bf16 runs, and
the largest gap between the card's and the CPU's distance to f32 over
the forward's module outputs. It shows how far a bf16 step may sit from
the CPU's bf16 step without a fault, which `card_against_cpu` uses.

    python3 scripts/torch_train_bf16_error.py [--seed 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch_train_parity as tp  # noqa: E402
from ghost_tpu_torch.core.precision import disable_tf32  # noqa: E402
from ghost_tpu_torch.nn.layers import frozen_batch_stats  # noqa: E402

TERMS = ("L_adv", "L_id", "L_attr", "L_rec")


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-30))


def run(policy, device, seed, batch):
    """Loss terms, each term's gradient to G (flat, host) and the
    module outputs of G, D and ArcFace in call order."""
    models = [copy.deepcopy(m).to(device) for m in
              tp.gan_models(policy=policy, seed=seed)]
    st, g_step, _ = tp.gan_state(models, "canonical")
    outs = []

    def hook(name):
        def record(mod, inp, out):
            o = out[0] if isinstance(out, (tuple, list)) else out
            if torch.is_tensor(o):
                outs.append((name, o.detach().float().cpu()))
        return record

    hooks = [m.register_forward_hook(hook(f"{who}.{n}"))
             for who, mod in (("G", st.g), ("D", st.d), ("A", models[2]))
             for n, m in mod.named_modules() if n]
    tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    with frozen_batch_stats(st.g):
        _, aux = g_step.loss_fn(st, tb, st.mults)
    for h in hooks:
        h.remove()
    params = list(st.g.parameters())
    grads = {}
    for k in TERMS:
        gs = torch.autograd.grad(aux[k], params, retain_graph=True,
                                 allow_unused=True, materialize_grads=True)
        grads[k] = torch.cat([g.detach().float().cpu().reshape(-1)
                              for g in gs])
    return {k: float(aux[k]) for k in TERMS}, grads, outs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        disable_tf32()
    batch = tp.gan_batches(1, seed=2)[0]
    f32, bf16 = tp.POLICIES["f32"], tp.POLICIES["bf16"]
    res = {"f32 cpu": run(f32, "cpu", args.seed, batch),
           "bf16 cpu": run(bf16, "cpu", args.seed, batch),
           "bf16 card": run(bf16, args.device, args.seed, batch),
           "f32 card": run(f32, args.device, args.seed, batch)}
    for name, (terms, _, _) in res.items():
        print(f"{name}: " + ", ".join(f"{k} {v:.7g}" for k, v in
                                      terms.items()))
    ref = res["f32 cpu"][1]
    for k in TERMS:
        print(f"gradient of {k}, relative L2 from f32 on the CPU: bf16 CPU "
              f"{rel(res['bf16 cpu'][1][k], ref[k]):.3e}, bf16 card "
              f"{rel(res['bf16 card'][1][k], ref[k]):.3e}, f32 card "
              f"{rel(res['f32 card'][1][k], ref[k]):.3e}; bf16 card from "
              f"bf16 CPU "
              f"{rel(res['bf16 card'][1][k], res['bf16 cpu'][1][k]):.3e}")
    gaps = []
    for (n, r), (_, c), (_, k) in zip(res["f32 cpu"][2], res["bf16 cpu"][2],
                                      res["bf16 card"][2]):
        gaps.append((abs(rel(k, r) - rel(c, r)), rel(c, r), n))
    gap, at, name = max(gaps)
    print(f"forward: {len(gaps)} module outputs; the card's and the CPU's "
          f"bf16 distances to f32 differ by at most {gap:.3e} ({name}, "
          f"the CPU's {at:.3e})")


if __name__ == "__main__":
    main()
