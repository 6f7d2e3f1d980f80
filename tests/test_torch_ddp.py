"""The port's data-parallel layer (`parallel/dp.py`, `parallel/zero.py`,
synchronised `nn.layers.BatchNorm`, the global losses, the per-rank
checkpoint) on 2 gloo ranks on the CPU, against the port's single-process
step on the global batch (which tests/test_torch_train_step.py holds to
JAX) and against JAX's ZeRO-sharded step.

The ranks start once for the whole file (`spawn`, a FileStore under the
test's temporary directory, a join timeout: a hung rank fails its test);
they import torch and ghost_tpu_torch only (`tests/torch_ddp_ranks.py`).
After them this process takes the single-process steps. JAX's
sharded step runs once, in a subprocess on 8 XLA:CPU devices, as JAX's
own sharded tests run. The DP step's bounds are `torch_ddp_ranks.compare`'s
(the f32 card-against-CPU bounds, beside the single-process run's own
spread on the reordered batch); the rest are stated per test.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _jax_zero_run(out_path):
    """JAX's data-parallel ZeRO step (ghost_adam, `shard_train_step`,
    `zero_shard_opt_state`) on a 2-device data mesh (subprocess)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    import torch_ddp_ranks as R
    from ghost_tpu.parallel.dp import (replicate_state, shard_batch_on_mesh,
                                       shard_train_step)
    from ghost_tpu.parallel.zero import zero_shard_opt_state
    from ghost_tpu.train.optimizers import ghost_adam

    w0, xs, ys = R.linear_data()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    opt = ghost_adam(R.LINEAR["lr"])
    params = {"w": jnp.asarray(w0), "b": jnp.zeros(R.LINEAR["d_out"])}
    state = (replicate_state(mesh, params),
             zero_shard_opt_state(mesh, opt.init(params)))

    def step_fn(state, batch):
        params, opt_state = state

        def loss(p):
            return jnp.mean(jnp.square(batch["x"] @ p["w"] + p["b"]
                                       - batch["y"]))
        updates, opt_state = opt.update(jax.grad(loss)(params), opt_state,
                                        params)
        return optax.apply_updates(params, updates), opt_state

    step = shard_train_step(mesh, step_fn, donate_state=False)
    batch = shard_batch_on_mesh(mesh, {"x": jnp.asarray(xs),
                                       "y": jnp.asarray(ys)})
    for _ in range(R.LINEAR["steps"]):
        state = step(state, batch)
    out = {}
    for k, v in state[0].items():  # the params come back ZeRO-sharded
        out[k] = np.empty(v.shape, v.dtype)
        for sh in v.addressable_shards:
            out[k][sh.index] = np.asarray(sh.data)
    np.savez(out_path, **out)
    print("TORCH-DDP-JAX-OK")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _jax_zero_run(sys.argv[1])
    sys.exit(0)


import jax  # noqa: E402
import torch  # noqa: E402

import torch_ddp_ranks as R  # noqa: E402
import torch_train_parity as tp  # noqa: E402
from ghost_tpu.parallel.zero import _leaf_spec as j_leaf_spec  # noqa: E402
from ghost_tpu_torch.parallel import dp, zero  # noqa: E402

WORLD = 2
SCENARIOS = ["dp", "resume", "syncbn", "unequal", "linear", "linear_plain"]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """This process and each rank as the port's other test files take
    torch (`torch_ddp_ranks.cpu_test_threads`)."""
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    R.cpu_test_threads()
    yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results, then the single-process steps on the global
    batch and on its reordering (not while the ranks run: the processes'
    threads would fight for the cores)."""
    out = str(tmp_path_factory.mktemp("ddp_ranks"))
    results = R.Ranks(WORLD, out, "cpu", SCENARIOS, timeout=300).join()
    batch = R.uneven_batch(2 * tp.NARROW["batch"], seed=0)
    single = [R.single_step(tp.NARROW, tp.POLICIES["f32"], "round_trip", b,
                            "cpu") for b in (batch, tp.swapped(batch))]
    return results, single


def _dp_result(results, key):
    k0 = results[0][key]
    moments = R.assemble_moments([r[key]["moments"] for r in results])
    return k0["metrics"], moments, k0["tensors"]


def test_dp_zero_step_equals_single_process_step(run):
    """2 ranks (batch 2 + 2, uneven same/diff-person masks) with
    synchronised BatchNorm, global losses and ZeRO GhostAdam, round_trip
    (every distillation term and the canonical ones), against the
    single-process step on the batch of 4; both ranks end with equal
    state bit for bit and read the same losses (the host ratchets)."""
    results, single = run
    k0 = results[0]["dp"]
    moments = R.assemble_moments([r["dp"]["moments"] for r in results])
    ok, report = R.compare((k0["metrics"], moments, k0["tensors"]), *single)
    assert ok, report
    for n, t in k0["tensors"].items():
        assert torch.equal(t, results[1]["dp"]["tensors"][n]), n
    assert k0["metrics"] == results[1]["dp"]["metrics"]


def test_zero_checkpoint_resumes_bit_for_bit(run):
    """Each rank saves its own ZeRO slices (`rank_checkpoint_manager`);
    a state of other weights restored from them takes the next step
    exactly as the uninterrupted run."""
    for r in run[0]:
        assert r["dp"]["resume_max_diff"] == 0.0
        assert r["dp"]["resume_step"] == 2


def test_sync_batch_norm_equals_global_batch(run):
    """BatchNorm's train statistics over both ranks' rows (their values
    far apart): output and running statistics equal the single-process
    layer's on all 8 rows within 1e-6; the loss is the group's sum, so
    each rank's raw input gradient is 2x its rows' (the all-reduce's
    backward sums two unit gradients) and the averaged weight and bias
    gradients are the global ones. f32, 1e-5."""
    results, _ = run
    x, w = R.syncbn_inputs()
    bn = R.syncbn_module("cpu")
    xg = x.clone().requires_grad_()
    y = bn(xg)
    loss = torch.sum(y * w)
    dx, dg, db = torch.autograd.grad(loss, (xg, bn.weight, bn.bias))
    got = [r["syncbn"] for r in results]
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), y.detach(),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got]), WORLD * dx,
                               rtol=1e-5, atol=1e-5)
    for g in got:
        torch.testing.assert_close(g["dg"], dg, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(g["db"], db, rtol=1e-5, atol=1e-5)
        assert g["loss"] == pytest.approx(float(loss.detach()), rel=1e-6)
        for stat in ("running_mean", "running_var"):
            torch.testing.assert_close(g[stat], getattr(bn, stat), rtol=0,
                                       atol=1e-6)
            assert torch.equal(g[stat], got[0][stat])


def test_unequal_shards_are_refused(run):
    for r in run[0]:
        assert "unequal batch shards" in r["unequal"]


@pytest.fixture(scope="module")
def jax_zero(tmp_path_factory):
    """JAX's ZeRO-sharded linear steps, from one subprocess on 8 XLA:CPU
    devices."""
    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    env["XLA_FLAGS"] = flags.strip()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = tmp_path_factory.mktemp("jax_zero") / "jax.npz"
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "TORCH-DDP-JAX-OK" in r.stdout
    return dict(np.load(out))


@pytest.mark.parametrize("key", ["linear", "linear_plain"])
def test_dp_linear_matches_single_process_and_jax_sharded(run, jax_zero,
                                                          key):
    """Two GhostAdam steps on 2 ranks, ZeRO-sharded (w (16, 8) and b (8,)
    on dim 0) or replicated, against one process's GhostAdam on all rows
    (1e-6) and JAX's ZeRO-sharded ghost_adam step on a 2-device mesh
    (1e-5: Adam's first steps move each weight by about lr, the
    gradients agree to f32)."""
    from ghost_tpu_torch.train.optimizers import GhostAdam

    got = [r[key] for r in run[0]]
    assert got[0]["dims"] == ([0, 0] if key == "linear" else None)
    assert torch.equal(got[0]["w"], got[1]["w"])
    w0, xs, ys = R.linear_data()
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    b = torch.nn.Parameter(torch.zeros(R.LINEAR["d_out"]))
    opt = GhostAdam([w, b], R.LINEAR["lr"])
    for _ in range(R.LINEAR["steps"]):
        opt.zero_grad()
        torch.mean(torch.square(torch.from_numpy(xs) @ w + b
                                - torch.from_numpy(ys))).backward()
        opt.step()
    torch.testing.assert_close(got[0]["w"], w.detach(), rtol=0, atol=1e-6)
    torch.testing.assert_close(got[0]["b"], b.detach(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0]["w"].numpy(), jax_zero["w"], atol=1e-5)
    np.testing.assert_allclose(got[0]["b"].numpy(), jax_zero["b"], atol=1e-5)


def test_leaf_spec_matches_jax():
    """The ZeRO dim choice of every leaf of a narrow TrainState's
    optimizer state (and of odd shapes) equals JAX's, over 2, 4 and 8."""
    shapes = [(), (1,), (3,), (8,), (6, 4), (3, 8), (3, 3, 16, 7),
              (64, 32, 3, 3), (5, 12)]
    g, d, arc = tp.gan_models()
    st, _, _ = tp.gan_state((g, d, arc), "canonical")
    shapes += [tuple(p.shape) for p in st.g.parameters()]
    for n in (2, 4, 8):
        for s in shapes:
            x = np.zeros(s, np.float32)
            assert zero._leaf_spec(x, n) == tuple(j_leaf_spec(x, n)), (s, n)
    specs = zero.state_shardings(4, st)
    assert specs["g"] and all(v == () for v in specs["g"].values())
    moments = [v["exp_avg"] for v in specs["g_opt"]["state"].values()]
    assert moments == [] or all(isinstance(m, tuple) for m in moments)
    assert zero.opt_state_shardings(2, {"w": torch.zeros(6, 3)}) == {
        "w": (zero.DATA_AXIS,)}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launch_multihost_world_size_1_and_batch_checks():
    """launch_multihost on the CPU at world size 1 (gloo), then the
    batch helpers on its group: JAX's divisibility message, a rank's
    slice, replicate_state; without a card and a device it refuses."""
    import torch.distributed as dist

    group = dp.launch_multihost(f"localhost:{_free_port()}", 1, 0,
                                device="cpu")
    try:
        assert dist.get_world_size(group) == 1
        assert dist.get_backend(group) == "gloo"
        batch = {"xt": np.zeros((3, 2), np.float32)}
        assert dp.shard_batch_on_mesh(group, batch)["xt"].shape == (3, 2)
        m = torch.nn.Linear(2, 2)
        assert dp.replicate_state(group, m) is m
        step = dp.shard_train_step(group, lambda st, b: (st, b))
        assert step(1, {"x": torch.zeros(3)})[0] == 1
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            dp.launch_multihost()


def test_check_batch_sharding_message(monkeypatch):
    """JAX's message for a leading dim that does not divide over "data"
    (a 2-rank group stood in by its size)."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match=r"batch leaf \['xt'\] has leading "
                       r"dim 5, not divisible by mesh 'data' size 2"):
        dp._check_batch_sharding(object(), {"xt": np.zeros((5, 3))})
    dp._check_batch_sharding(object(), {"xt": np.zeros((4, 3)), "n": 3})
