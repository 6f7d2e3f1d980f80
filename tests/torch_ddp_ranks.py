"""The ranks of the data-parallel checks, and the single-process step they
are held against. No jax here: the ranks of tests/test_torch_ddp.py and
of `chip_smoke.py` phase 25 (b) import this module in processes started
with the `spawn` method, and those import torch and ghost_tpu_torch only.

`rank_main` joins a gloo (or NCCL) group through a FileStore and runs the
scenarios it is given, writing `rank<r>.pt` (results) into `out_dir`:

- "dp": one G and one D step of the GAN (`tests/torch_train_parity.py`'s
  models) on this rank's shard of a global batch whose same-person and
  diff-person masks differ between the ranks' halves, under
  `shard_train_step`: synchronised BatchNorm, global losses, averaged
  gradients, and ZeRO-sharded GhostAdam where asked;
- "resume": after the "dp" step, a rank checkpoint, one more step, then
  a state of other weights restored from the checkpoint and the same
  step again: both equal bit for bit;
- "syncbn": one train-mode BatchNorm on this rank's rows of a seeded
  input, the loss the group's sum: output, raw gradients, averaged
  weight gradient and running statistics;
- "unequal": ranks holding shards of 2 and 3 samples must refuse to step;
- "linear", "linear_plain": two GhostAdam steps, ZeRO-sharded or
  replicated, of a linear least-squares model on this rank's rows (the
  JAX comparison's model).

`compare` holds a data-parallel step to the single-process one beside
the single-process run's own spread (the batch's samples reordered), in
the manner of `torch_train_parity.card_against_cpu`'s f32 bounds.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

import torch_train_parity as tp

LINEAR = dict(n=32, d_in=16, d_out=8, lr=1e-2, steps=2)


def uneven_batch(n_global: int, seed: int = 0) -> dict:
    """A seeded global batch (numpy) whose mask halves differ: the first
    half all same-person and half diff-person, the second half the other
    way round, so the ranks' local ratios are not the global ones."""
    b = tp.gan_batches(1, n_global, seed=seed)[0]
    half = n_global // 2
    same = np.ones(n_global, np.float32)
    same[half + 1::2] = 0.0
    diff = np.ones(n_global, np.float32)
    diff[:half:2] = 0.0
    b["same_person"], b["diff_person"] = same, diff
    return b


def on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in batch.items()}


def gan_step(st, g_step, d_step, batch):
    """One G and one D step; metrics as floats (lossD among them)."""
    st, met, y = g_step(st, batch)
    st, loss_d = d_step(st, y, batch["xs"], batch["diff_person"])
    met = {k: float(v) for k, v in met.items()}
    met["lossD"] = float(loss_d)
    return met


def tensors(st) -> dict:
    """G's and D's parameters and buffers by 'g.'/'d.' name, on the host."""
    out = {f"g.{k}": v for k, v in st.g.state_dict().items()}
    out.update({f"d.{k}": v for k, v in st.d.state_dict().items()})
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def first_moments(st) -> dict:
    """Adam's first moments by name (b1 = 0: the decayed gradient); a
    ZeRO optimizer gives this rank's slices with their dims."""
    out = {}
    for who, mod, opt in (("g", st.g, st.g_opt), ("d", st.d, st.d_opt)):
        names = [n for n, _ in mod.named_parameters()]
        if hasattr(opt, "shards"):
            for n, s, dim in zip(names, opt.shards, opt.dims):
                out[f"{who}.{n}"] = (
                    opt.inner.state[s]["exp_avg"].cpu().clone(), dim)
        else:
            for n, p in zip(names, mod.parameters()):
                out[f"{who}.{n}"] = (opt.state[p]["exp_avg"].cpu().clone(),
                                     None)
    return out


def single_step(c, policy, mode, batch, device, seed=0):
    """The single-process G + D step on the whole batch: (metrics, first
    moments, tensors)."""
    st, g_step, d_step = tp.gan_state(tp.gan_models(c, policy, seed, device),
                                      mode)
    met = gan_step(st, g_step, d_step, on(batch, device))
    return met, {k: v for k, (v, _) in first_moments(st).items()}, tensors(st)


def assemble_moments(per_rank: list) -> dict:
    """The ranks' first moments joined along their ZeRO dims."""
    out = {}
    for name, (piece, dim) in per_rank[0].items():
        out[name] = piece if dim is None else torch.cat(
            [r[name][0] for r in per_rank], dim=dim)
    return out


def compare(k, c, s, lr=tp.LR):
    """Hold the data-parallel step k = (metrics, moments, tensors) to the
    single-process step c beside s, c's run on the reordered batch (one
    sample of f32 reorder noise, as the batch split is another): loss
    terms 1e-5 relative; G's and D's whole gradients and each top-level
    module's (G's encoder and generator, each scale of D), relative L2,
    within 5x the same part's spread + 1e-3; each parameter within 1e-6
    + lr * min(2, 2 d / |g|), d the larger of `grad_bound` and 5x the
    spread's largest difference on the tensor (Adam's first step moves
    an element by about lr * sign(g)); BN running statistics 1e-5
    relative + 1e-7. No single tensor's gradient is held: on an H100 at
    phase 20's full width this step's reordering alone moves G's whole
    gradient by 2.5%, and a cancelling scalar such as an AAD mask bias
    by 49% of itself where the batch split moved it by 334%: two samples
    of noise that part by more than any fixed factor (PERF.md);
    `card_against_cpu` holds bf16 the same way for the same reason.
    Returns (ok, report)."""
    (k_met, k_mom, k_st), (c_met, c_mom, c_st), (_, s_mom, _) = k, c, s
    loss = max(abs(k_met[n] / v - 1) if v else abs(k_met[n])
               for n, v in c_met.items())
    ok = k_met.keys() == c_met.keys() and loss <= 1e-5
    worst = {"part": (0.0, ""), "param": 0.0, "stats": 0.0}
    whole = {}
    for who in ("g.", "d."):
        want = {n: w for n, w in c_mom.items() if n.startswith(who)}
        whole[who] = (tp.rel_l2(k_mom, c_mom, want),
                      tp.rel_l2(s_mom, c_mom, want))
        ok &= whole[who][0] <= 5 * whole[who][1] + 1e-3
        for part in sorted({".".join(n.split(".")[:2]) for n in want}):
            keys = [n for n in want if n.startswith(part + ".")]
            e_k, e_s = tp.rel_l2(k_mom, c_mom, keys), tp.rel_l2(
                s_mom, c_mom, keys)
            ratio = e_k / (5 * e_s + 1e-3)
            if ratio >= worst["part"][0]:
                worst["part"] = (ratio, f"{part}: {e_k:.2e}, spread "
                                        f"{e_s:.2e}")
        bound = tp.grad_bound(want)
        for n, w in want.items():
            d = max(bound[n], 5 * float((s_mom[n] - w).abs().max()))
            allowed = 1e-6 + lr * torch.clamp(2 * d / w.abs(), max=2)
            worst["param"] = max(worst["param"], float(
                ((k_st[n] - c_st[n]).abs() / allowed).max()))
    for n, w in c_st.items():
        if "running" in n:
            worst["stats"] = max(worst["stats"], float(
                ((k_st[n] - w).abs() / (w.abs() * 1e-5 + 1e-7)).max()))
    ok &= max(worst["part"][0], worst["param"], worst["stats"]) <= 1.0
    return bool(ok), (
        f"loss terms {loss:.2e}; whole gradient G {whole['g.'][0]:.2e} "
        f"(spread {whole['g.'][1]:.2e}), D {whole['d.'][0]:.2e} (spread "
        f"{whole['d.'][1]:.2e}); per module at most {worst['part'][0]:.3f} "
        f"of its bound ({worst['part'][1]}), parameters "
        f"{worst['param']:.3f}, BN stats {worst['stats']:.3f}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dp_state(group, models, mode, zero):
    from ghost_tpu_torch.parallel.dp import replicate_state, shard_train_step
    from ghost_tpu_torch.parallel.zero import zero_shard_opt_state

    st, g_step, d_step = tp.gan_state(models, mode)
    replicate_state(group, st)
    if zero:
        st.g_opt = zero_shard_opt_state(group, st.g_opt)
        st.d_opt = zero_shard_opt_state(group, st.d_opt)
    return st, shard_train_step(group, g_step), shard_train_step(group, d_step)


def dp_run(group, device, c, policy, mode, zero, batch, steps=1, seed=0,
           ckpt_dir=None):
    """`steps` data-parallel G + D steps on this rank's shard of `batch`:
    the first step's metrics, moments and tensors, per-step ms (synced),
    the peak memory of this process on a card, and with `ckpt_dir` the
    resume check."""
    from ghost_tpu_torch.core.checkpoint import rank_checkpoint_manager
    from ghost_tpu_torch.parallel.dp import shard_batch_on_mesh

    models = tp.gan_models(c, policy, seed, device)
    st, g_dp, d_dp = _dp_state(group, models, mode, zero)
    local = on(shard_batch_on_mesh(group, batch), device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ms, out = [], {}
    for i in range(steps):
        _sync(device)
        t = time.perf_counter()
        met = gan_step(st, g_dp, d_dp, local)
        _sync(device)
        ms.append((time.perf_counter() - t) * 1e3)
        if i == 0:
            out.update(metrics=met, moments=first_moments(st),
                       tensors=tensors(st))
    out["ms"] = ms
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    if ckpt_dir is not None:
        mgr = rank_checkpoint_manager(ckpt_dir, group)
        mgr.save(st.step, st)
        gan_step(st, g_dp, d_dp, local)
        want = tensors(st)
        # G and D of other weights; the frozen ArcFace is not in the state
        other = tp.gan_models(c, policy, seed + 5, device)[:2]
        fresh, g2, d2 = _dp_state(group, (*other, models[2]), mode, zero)
        mgr.restore(like=fresh)
        gan_step(fresh, g2, d2, local)
        got = tensors(fresh)
        out["resume_max_diff"] = max(float((got[n] - w).abs().max())
                                     for n, w in want.items())
        out["resume_step"] = fresh.step
    return out


def syncbn_run(group, device):
    """A train-mode BatchNorm under `data_parallel` on this rank's rows
    of a seeded (8, 3, 5, 5) input with uneven values."""
    import torch.distributed as dist

    from ghost_tpu_torch.parallel.collectives import (average_gradients,
                                                      data_parallel,
                                                      global_sum)

    x_all, w_all = syncbn_inputs()
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    k = x_all.shape[0] // n
    x = x_all[rank * k:(rank + 1) * k].to(device).requires_grad_()
    w = w_all[rank * k:(rank + 1) * k].to(device)
    bn = syncbn_module(device)
    with data_parallel(group):
        y = bn(x)
        loss = global_sum(torch.sum(y * w))
        dx, dg, db = torch.autograd.grad(loss, (x, bn.weight, bn.bias))
        dg_avg, db_avg = average_gradients([dg, db])
    return {"y": y.detach().cpu(), "dx": dx.cpu(), "dg": dg_avg.cpu(),
            "db": db_avg.cpu(), "loss": float(loss.detach()),
            "running_mean": bn.running_mean.cpu(),
            "running_var": bn.running_var.cpu()}


def syncbn_inputs():
    g = torch.Generator().manual_seed(7)
    x = torch.randn(8, 3, 5, 5, generator=g)
    x[4:] = x[4:] * 3.0 + 2.0  # the second rank's rows sit elsewhere
    return x, torch.randn(8, 3, 5, 5, generator=g)


def syncbn_module(device):
    from ghost_tpu_torch.nn.layers import BatchNorm

    bn = BatchNorm(3, train=True, device=device)
    bn.reset_parameters(None)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 0.5, 2.0]))
        bn.bias.copy_(torch.tensor([0.0, 0.1, -0.2]))
    return bn


def unequal_run(group, device):
    """Ranks with shards of 2 and 3 samples: the step must refuse."""
    import torch.distributed as dist

    from ghost_tpu_torch.parallel.dp import shard_train_step

    b = 2 + dist.get_rank(group)
    step = shard_train_step(group, lambda st, batch: (st, batch))
    try:
        step(None, {"xt": torch.zeros(b, 3, device=device)})
    except ValueError as e:
        return str(e)
    return None


def linear_data():
    c = LINEAR
    rng = np.random.default_rng(0)
    return (rng.standard_normal((c["d_in"], c["d_out"])).astype(np.float32),
            rng.standard_normal((c["n"], c["d_in"])).astype(np.float32),
            rng.standard_normal((c["n"], c["d_out"])).astype(np.float32))


def linear_run(group, device, zero):
    """Two GhostAdam steps of mean((x w + b - y)^2) on this rank's rows,
    replicated, or ZeRO-sharded (w (16, 8) and b (8,) on dim 0 over 2
    ranks) after the first step, so the moments it holds are sliced."""
    from ghost_tpu_torch.parallel.collectives import (average_gradients,
                                                      data_parallel,
                                                      global_mean)
    from ghost_tpu_torch.parallel.dp import shard_batch_on_mesh
    from ghost_tpu_torch.parallel.zero import zero_shard_opt_state
    from ghost_tpu_torch.train.optimizers import GhostAdam

    w0, xs, ys = linear_data()
    w = torch.nn.Parameter(torch.as_tensor(w0, device=device))
    b = torch.nn.Parameter(torch.zeros(LINEAR["d_out"], device=device))
    opt = GhostAdam([w, b], LINEAR["lr"])
    local = on(shard_batch_on_mesh(group, {"x": xs, "y": ys}), device)
    with data_parallel(group):
        for i in range(LINEAR["steps"]):
            if zero and i == 1:
                opt = zero_shard_opt_state(group, opt)
            loss = global_mean(torch.square(local["x"] @ w + b - local["y"]))
            grads = average_gradients(torch.autograd.grad(loss, [w, b]))
            w.grad, b.grad = grads
            opt.step()
    return {"w": w.detach().cpu(), "b": b.detach().cpu(),
            "dims": list(opt.dims) if zero else None}


def cpu_test_threads():
    """2 threads and full f32 products, as the port's CPU tests take
    them; torch's first exp call in a 2-thread process can be ~1e-4 off
    the later ones (a library defect), so one call takes it."""
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    torch.exp(torch.zeros(1 << 16))


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    from ghost_tpu_torch.ops.cuda import attention, layer_norm
    from ghost_tpu_torch.ops.cuda.aad import aad_modulate
    from ghost_tpu_torch.ops.cuda.conv3x3 import conv3x3

    fns = {"aad_modulate": aad_modulate, "conv3x3": conv3x3,
           "flash_attention_fwd": attention.flash_attention_fwd,
           "flash_attention_bwd_dq": attention.flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": attention.flash_attention_bwd_dkv,
           "fused_layer_norm_fwd": layer_norm.fused_layer_norm_fwd,
           "fused_layer_norm_bwd": layer_norm.fused_layer_norm_bwd}
    return {k: getattr(f, "launches", 0) for k, f in fns.items()}


def rank_main(rank, world, store_path, out_dir, device, scenarios,
              backend="gloo", gan=None, policies=("f32",), global_batch=None,
              dp_steps=1):
    """One rank: join the group, run `scenarios`, write rank<r>.pt.
    `device` may name the rank ("cuda:{rank}"); the GAN config `gan`
    defaults to the narrow one, its global batch to world x its batch;
    "dp" runs once per policy (results "dp", "dp_bf16")."""
    import torch.distributed as dist

    device = torch.device(device.format(rank=rank))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the ranks share the host's cores: 2 threads, as the tests
        cpu_test_threads()
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    group = dist.group.WORLD
    c = tp.NARROW if gan is None else gan
    batch = uneven_batch(global_batch or world * c["batch"], seed=0)
    results = {}
    try:
        for name in scenarios:
            if name == "dp":
                for pol in policies:
                    key = "dp" if pol == "f32" else f"dp_{pol}"
                    ckpt = ("resume" in scenarios and pol == "f32")
                    results[key] = dp_run(
                        group, device, c, tp.POLICIES[pol], "round_trip",
                        True, batch, steps=dp_steps,
                        ckpt_dir=os.path.join(out_dir, "ckpt") if ckpt
                        else None)
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
            elif name == "syncbn":
                results["syncbn"] = syncbn_run(group, device)
            elif name == "unequal":
                results["unequal"] = unequal_run(group, device)
            elif name in ("linear", "linear_plain"):
                results[name] = linear_run(group, device, name == "linear")
        results["launches"] = launch_counts()
        dist.barrier(group)
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


class Ranks:
    """`world` ranks started with the spawn method (`rank_main`); `join`
    waits for them within `timeout` seconds of the start, kills any
    left, and returns their results (raising on a failed or hung rank)."""

    def __init__(self, world, out_dir, device, scenarios, timeout, **kw):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        store = os.path.join(out_dir, "store")
        self.out_dir, self.world = out_dir, world
        self.deadline = time.monotonic() + timeout
        self.procs = [ctx.Process(target=rank_main,
                                  args=(r, world, store, out_dir, device,
                                        scenarios), kwargs=kw)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def join(self):
        try:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
        finally:
            hung = [p for p in self.procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in self.procs]
        if hung or any(codes):
            raise RuntimeError(f"ranks: exit codes {codes}"
                               f"{' (killed at the timeout)' if hung else ''}")
        return [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]
