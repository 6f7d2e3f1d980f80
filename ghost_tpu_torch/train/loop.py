"""The training loop: epochs, D cadence, ratchets, snapshots, grids,
mirroring `ghost_tpu/train/loop.py`.

  * D steps every `d_interval` G steps (iterations 0, d, 2d, ...);
  * with `distill`, the host ratchets grow the id / id_hq / eyes
    multipliers until their weighted terms clear their floors;
  * a loss dashboard every `print_interval`, an image grid [Xs | Xt |
    (teacher) | Y] every `show_step` under `<output_dir>/images/`;
  * a full-state checkpoint every `save_interval` (optimizer moments
    included, as in JAX; the reference drops them), a forced one on
    preemption and, with `save_on_stop`, at `max_steps`.

`batches` is a re-iterable or a zero-arg factory of fresh iterators,
each yielding dicts of arrays (numpy or tensors: they are moved to the
state's device); a one-shot generator would end the run after one pass,
which the "no batches in epoch N; stopping" guard reports.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ghost_tpu_torch.train.losses import ratchet_multiplier
from ghost_tpu_torch.train.train_step import TrainState


@dataclasses.dataclass
class LoopConfig:
    max_epochs: int = 2000
    d_interval: int = 10
    print_interval: int = 10
    show_step: int = 250
    save_interval: int = 2500
    output_dir: str = "./output"
    run_name: str = "ghost"
    distill: bool = False
    ratchets: bool = True
    # a forced checkpoint when stopping at max_steps (the next slice of a
    # process-sliced run resumes from it)
    save_on_stop: bool = False


def _to_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _image_grid(arrays, path):
    """(B,H,W,3) arrays in [-1, 1], side by side -> one uint8 jpg (the
    first 4 samples as rows)."""
    try:
        import cv2
    except ImportError:
        return
    arrays = [_to_numpy(a) for a in arrays]
    rows = [np.concatenate([a[i] for a in arrays], axis=1)
            for i in range(min(arrays[0].shape[0], 4))]
    grid = np.concatenate(rows, axis=0)
    grid = np.clip((grid * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, grid[:, :, ::-1])


def train_loop(
    state: TrainState,
    g_step: Callable,
    d_step: Callable,
    batches: Iterable[dict],
    cfg: LoopConfig,
    checkpoint_manager=None,
    max_steps: Optional[int] = None,
    preemption=None,
    start_iteration: int = 0,
    on_step: Optional[Callable] = None,
):
    """Run the GAN loop; returns (state, the last printed metrics).

    The ratchets' multipliers are `state.mults`, so they are saved and
    restored with the state. `start_iteration` continues a restored
    run's iteration count (snapshots then keep their step numbers).
    `on_step(iteration, metrics as floats, multipliers)` observes every
    step (and syncs the host with the card each time)."""
    device = state.device
    iteration = start_iteration
    last_metrics: dict = {}
    t0 = time.time()

    for epoch in range(cfg.max_epochs):
        epoch_iter = batches() if callable(batches) else iter(batches)
        epoch_batches = 0
        for batch in epoch_iter:
            epoch_batches += 1
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in batch.items()}
            state, metrics, y = g_step(state, batch)
            if iteration % cfg.d_interval == 0:
                state, loss_d = d_step(state, y, batch["xs"])
                metrics["lossD"] = loss_d

            if on_step is not None:
                on_step(iteration, {k: float(v) for k, v in metrics.items()},
                        dict(state.mults))

            if cfg.distill and cfg.ratchets:
                # grow each multiplier until its weighted term clears the
                # floor (id >= 200, id against the teacher >= 250, eyes
                # >= 100)
                mults = state.mults
                mults["id"] = ratchet_multiplier(
                    float(metrics["L_id"]), mults["id"], 200.0)
                if "L_id_hq" in metrics:
                    mults["id_hq"] = ratchet_multiplier(
                        float(metrics["L_id_hq"]), mults["id_hq"], 250.0)
                if "L_eyes" in metrics:
                    mults["eyes"] = ratchet_multiplier(
                        float(metrics["L_eyes"]), mults["eyes"], 100.0)

            if iteration % cfg.print_interval == 0:
                batch_time = time.time() - t0
                t0 = time.time()
                parts = [f"epoch {epoch} it {iteration}"]
                parts += [f"{k}={float(v):.4f}" for k, v in metrics.items()]
                parts.append(f"batch_time={batch_time:.2f}s")
                print("  ".join(parts))
                last_metrics = {k: float(v) for k, v in metrics.items()}

            if iteration % cfg.show_step == 0:
                imgs = [batch["xs"], batch["xt"], y]
                if "teacher_y" in batch:
                    imgs.insert(2, batch["teacher_y"])
                _image_grid(imgs, os.path.join(
                    cfg.output_dir, "images",
                    f"generated_{cfg.run_name}_{epoch}_{iteration:06}.jpg"))

            if checkpoint_manager is not None and iteration > 0 \
                    and iteration % cfg.save_interval == 0:
                checkpoint_manager.save(iteration, state)

            if preemption is not None and preemption.triggered:
                # forced: a restarted, preempted-again run may sit at or
                # below the directory's latest step
                if checkpoint_manager is not None:
                    checkpoint_manager.save(iteration, state, force=True)
                    print(f"train_loop: preemption signal; saved step "
                          f"{iteration} and stopping")
                else:
                    print("train_loop: preemption signal; no checkpoint "
                          "dir configured, stopping without saving")
                return state, last_metrics

            iteration += 1
            if max_steps is not None and iteration >= max_steps:
                if cfg.save_on_stop and checkpoint_manager is not None:
                    checkpoint_manager.save(iteration - 1, state, force=True)
                return state, last_metrics
        if epoch_batches == 0:
            print(f"train_loop: no batches in epoch {epoch}; stopping")
            break
    return state, last_metrics
