"""The port's single-controller parallel layer (`ghost_tpu_torch/core/
mesh.py`, `parallel/{collectives,sp,pp,ep}.py`, `nn/moe.py`,
`MultiheadAttention(seq_mesh=...)`, `rrdb_forward_pipelined`, the
enhancer's tile sharding) against ghost_tpu's.

Shards are 4 or 8 `cpu` entries of a mesh (logical shards: the hops are
copies on one device). Inputs come from seeded numpy; weights cross the
bridge. JAX's sharded functions run once, on an 8-device XLA:CPU mesh in
a subprocess, as JAX's own parallel tests run them (the XLA:CPU
collective watchdog fires in a loaded process); every other case holds
the port to JAX's dense references in-process. Bounds, f32: forward 2e-6
absolute for attention (unit-variance inputs, sums of 8-64 terms), 1e-5
for gradients; the pipeline, MoE and tiling are the same arithmetic in
the same order on the port's side, held to JAX at 1e-5 (1e-4 for RRDB's
16-feature convs, O(1) outputs through 4 blocks and two x2 stages).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

CPU8 = ["cpu"] * 8
RRDB = dict(num_feat=16, num_block=4, num_grow_ch=8)
SRVGG = dict(num_feat=8, num_conv=2, upscale=4)


def _inputs():
    """Every seeded input of the sharded comparison (numpy)."""
    rng = np.random.default_rng(0)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(  # noqa
        np.float32)
    return {
        "q": f(2, 64, 2, 8), "k": f(2, 64, 2, 8), "v": f(2, 64, 2, 8),
        "w_attn": f(2, 64, 2, 8),
        "pp_w": f(5, 16, 16, scale=0.3), "pp_x": f(6, 16), "pp_g": f(6, 16),
        "moe_x": f(4, 6, 16), "moe_g": f(4, 6, 16),
        "moe_router": f(16, 8, scale=0.25), "moe_w1": f(8, 16, 32,
                                                        scale=0.25),
        "moe_b1": f(8, 32, scale=0.1), "moe_w2": f(8, 32, 16, scale=0.18),
        "moe_b2": f(8, 16, scale=0.1),
        "rrdb_x": rng.uniform(0, 1, (3, 12, 12, 3)).astype(np.float32),
        "tile_x": rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32),
    }


def _moe_params(inp, as_array):
    return {"router": {"w": as_array(inp["moe_router"]),
                       "b": as_array(np.zeros(8, np.float32))},
            **{k: as_array(inp[f"moe_{k}"])
               for k in ("w1", "b1", "w2", "b2")}}


def _pp_block_jax(w, h):
    import jax.numpy as jnp

    return h + jnp.tanh(h @ w)


def _jax_run(out_path):
    """JAX's sharded functions on the 8-device CPU mesh (subprocess)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ghost_tpu.core.mesh import make_mesh
    from ghost_tpu.core.precision import FULL_PRECISION
    from ghost_tpu.models.sr.rrdb import RRDBNet, rrdb_forward_pipelined
    from ghost_tpu.models.sr.srvgg import SRVGGNetCompact
    from ghost_tpu.parallel.ep import (make_expert_mesh,
                                       moe_apply_expert_parallel)
    from ghost_tpu.parallel.pp import make_pipe_mesh, pipeline_apply
    from ghost_tpu.parallel.sp import make_seq_mesh, ring_attention
    from ghost_tpu.pipeline.enhance import upscale_tiled

    def host(x):  # one shard of a replicated or gathered result
        shards = getattr(x, "addressable_shards", None)
        if shards and len(shards) > 1 and x.sharding.is_fully_replicated:
            return np.asarray(shards[0].data)
        if shards and len(shards) > 1:
            buf = np.empty(x.shape, x.dtype)
            for sh in shards:
                buf[sh.index] = np.asarray(sh.data)
            return buf
        return np.asarray(x)

    inp = _inputs()
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    out = {}
    mesh = make_seq_mesh(8)
    for causal in (False, True):
        def loss(q, k, v, c=causal):
            return jnp.sum(ring_attention(q, k, v, mesh=mesh, causal=c)
                           * a["w_attn"])
        o = jax.jit(lambda q, k, v, c=causal: ring_attention(
            q, k, v, mesh=mesh, causal=c))(a["q"], a["k"], a["v"])
        out[f"ring_{causal}"] = host(o)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(a["q"], a["k"],
                                                           a["v"])
        for name, g in zip("qkv", grads):
            out[f"ring_{causal}_d{name}"] = host(g)

    pmesh = make_pipe_mesh(3)

    def pp_loss(w, x):
        y = pipeline_apply(_pp_block_jax, w, x, mesh=pmesh,
                           num_microbatches=3, remat=True)
        return jnp.sum(y * a["pp_g"]), y
    (_, y), (dw, dx) = jax.jit(jax.value_and_grad(
        pp_loss, argnums=(0, 1), has_aux=True))(a["pp_w"], a["pp_x"])
    out.update(pp_y=host(y), pp_dw=host(dw), pp_dx=host(dx))

    emesh = make_expert_mesh(4)
    params = _moe_params(inp, jnp.asarray)

    def moe_loss(params, x):
        y = moe_apply_expert_parallel(params, x, mesh=emesh)
        return jnp.sum(y * a["moe_g"]), y
    (_, y), (dp, dx) = jax.jit(jax.value_and_grad(
        moe_loss, argnums=(0, 1), has_aux=True))(params, a["moe_x"])
    out.update(moe_y=host(y), moe_dx=host(dx), moe_dw1=host(dp["w1"]),
               moe_drouter=host(dp["router"]["w"]))

    net = RRDBNet(**RRDB, policy=FULL_PRECISION)
    variables = _rrdb_variables(net, jax, jnp)
    out["rrdb_y"] = host(jax.jit(lambda v, x: rrdb_forward_pipelined(
        net, v, x, mesh=pmesh, num_microbatches=3))(variables, a["rrdb_x"]))

    sr = SRVGGNetCompact(**SRVGG, policy=FULL_PRECISION)
    sr_vars = _srvgg_variables(sr, jax, jnp)
    out["tile_y"] = host(jax.jit(lambda v, x: upscale_tiled(
        sr, v, x, tile=(16, 12), tile_pad=2,
        mesh=make_mesh(jax.devices()[:4])))(sr_vars, a["tile_x"]))
    np.savez(out_path, **out)
    print("TORCH-PARALLEL-JAX-OK")


def _seeded_params(module, x, seed, scale, jax, jnp):
    shapes = jax.eval_shape(module.init, jax.random.key(0), x)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: jnp.asarray(
        rng.normal(0, scale, s.shape), jnp.float32), shapes)


def _rrdb_variables(net, jax, jnp):
    return _seeded_params(net, jnp.zeros((1, 12, 12, 3)), 11, 0.05, jax, jnp)


def _srvgg_variables(net, jax, jnp):
    return _seeded_params(net, jnp.zeros((1, 12, 12, 3)), 12, 0.2, jax, jnp)


if __name__ == "__main__":
    _jax_run(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------- in-process tests
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ghost_tpu.nn import moe as jmoe  # noqa: E402
from ghost_tpu.nn import modules as jmod  # noqa: E402
from ghost_tpu.parallel import sp as jsp  # noqa: E402
from ghost_tpu.parallel.pp import (  # noqa: E402
    stack_block_params as j_stack, unstack_block_params as j_unstack)
from ghost_tpu_torch.convert.from_jax import load_flax_variables  # noqa: E402
from ghost_tpu_torch.core import mesh as tmesh  # noqa: E402
from ghost_tpu_torch.core.precision import FULL_PRECISION  # noqa: E402
from ghost_tpu_torch.nn import moe as tmoe  # noqa: E402
from ghost_tpu_torch.nn import modules as tmod  # noqa: E402
from ghost_tpu_torch.parallel import collectives as coll  # noqa: E402
from ghost_tpu_torch.parallel import ep as tep  # noqa: E402
from ghost_tpu_torch.parallel import pp as tpp  # noqa: E402
from ghost_tpu_torch.parallel import sp as tsp  # noqa: E402
from ghost_tpu.core.precision import FULL_PRECISION as JFULL  # noqa: E402


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.requires_grad_() if grad else t


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """2 threads and full f32 products on both sides, as the port's other
    test files take them; torch's first exp call in a 2-thread process
    can be ~1e-4 off the later ones (a library defect), so one call
    takes it before the ring's 2e-6 bounds."""
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    torch.exp(torch.zeros(1 << 16))
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """JAX's sharded results, from one subprocess on 8 XLA:CPU devices."""
    out = tmp_path_factory.mktemp("jax_sharded") / "out.npz"
    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    env["XLA_FLAGS"] = flags.strip()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "TORCH-PARALLEL-JAX-OK" in r.stdout
    return dict(np.load(out))


@pytest.fixture(scope="module")
def inp():
    return _inputs()


# ------------------------------------------------------------- mesh
def test_make_mesh_shapes_and_errors():
    m = tmesh.make_mesh(CPU8, data=4, model=2)
    assert m.shape == {"data": 4, "model": 2}
    assert m.axis_names == (tmesh.DATA_AXIS, tmesh.MODEL_AXIS)
    assert tmesh.make_mesh(CPU8).shape == {"data": 8, "model": 1}
    with pytest.raises(ValueError, match=r"mesh 3x2 != 8 devices"):
        tmesh.make_mesh(CPU8, data=3, model=2)
    with pytest.raises(ValueError, match=r"need 9 devices, have 8"):
        tmesh.make_mesh_1d("seq", 9, CPU8)
    assert tsp.make_seq_mesh(4, CPU8).shape == {"seq": 4}
    assert tpp.make_pipe_mesh(3, CPU8).shape == {"pipe": 3}
    assert tep.make_expert_mesh(2, CPU8).shape == {"expert": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmesh.make_mesh()


def test_shard_batch_replicate_and_host_assembly():
    m = tmesh.make_mesh(CPU8[:4])
    x = torch.arange(24.0).reshape(8, 3)
    pieces = tmesh.shard_batch(m, {"x": x})["x"]
    assert [p.shape[0] for p in pieces] == [2] * 4
    assert torch.equal(torch.cat(pieces), x)
    with pytest.raises(ValueError, match="not divisible by 4"):
        tmesh.shard_batch(m, x[:6])
    rep = tmesh.replicate({"w": x}, tmesh.replicated_sharding(m))
    assert list(rep) == [torch.device("cpu")] and rep[torch.device("cpu")][
        "w"] is x  # shards on one device share one copy, no copy
    from ghost_tpu_torch.pipeline.enhance import _to_host

    idx = [(slice(0, 4), slice(0, 3)), (slice(4, 8), slice(0, 3))]
    buf = _to_host([(i, x[i]) for i in idx])
    np.testing.assert_array_equal(buf, x.numpy())
    np.testing.assert_array_equal(_to_host(x), x.numpy())


def test_collectives_and_their_gradients():
    axis = CPU8[:4]
    pieces = [torch.full((2,), float(i), requires_grad=True)
              for i in range(4)]
    out = coll.ppermute(pieces, axis, [(0, 1), (1, 2), (2, 3)])
    assert [float(o[0].detach()) for o in out] == [0.0, 0.0, 1.0, 2.0]
    total = coll.psum(pieces, axis)
    assert all(float(t[0].detach()) == 6.0 for t in total)
    gathered = coll.all_gather(pieces, axis)
    assert gathered[3].shape == (8,)
    # the transpose of a copy is a copy back: d/dp_i of sum_j psum_j = 4
    torch.stack(total).sum().backward()
    assert all(float(p.grad[0]) == 4.0 for p in pieces)


# ------------------------------------------------------------- ring attention
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [8, 4, 1])
def test_ring_attention_matches_jax_reference(inp, causal, n):
    """Forward and dq/dk/dv against JAX's materialising reference."""
    q, k, v, w = (inp[x] for x in ("q", "k", "v", "w_attn"))

    def jloss(q, k, v):
        out = jsp.attention_reference(q, k, v, causal=causal)
        return jnp.sum(out * w), out
    (_, ref), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray,
                                                      (q, k, v)))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tsp.ring_attention(tq, tk, tv, mesh=tsp.make_seq_mesh(n, CPU8),
                             causal=causal)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=2e-6)
    torch.sum(out * _t(w)).backward()
    for got, want in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=1e-5)


def test_ring_attention_2d_mesh_bf16_and_errors(inp):
    """data x seq (batch_axis) equals the 1-D ring; bf16 inputs keep the
    f32 state (within bf16's rounding of the output, 1e-2); both
    divisibility errors carry JAX's messages."""
    q, k, v = (_t(inp[x]) for x in "qkv")
    m2 = tmesh.Mesh(np.array(CPU8, dtype=object).reshape(2, 4),
                    ("data", "seq"))
    want = tsp.ring_attention(q, k, v, mesh=tsp.make_seq_mesh(4, CPU8),
                              causal=True)
    got = tsp.ring_attention(q, k, v, mesh=m2, causal=True,
                             batch_axis="data")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    out = tsp.ring_attention(qb, kb, vb, mesh=tsp.make_seq_mesh(8, CPU8),
                             causal=True)
    assert out.dtype == torch.bfloat16
    ref = tsp.attention_reference(qb, kb, vb, causal=True)
    assert float((out.float() - ref.float()).abs().max()) <= 1e-2
    mesh = tsp.make_seq_mesh(8, CPU8)
    with pytest.raises(ValueError, match="seq 60 not divisible by 8"):
        tsp.ring_attention(q[:, :60], k, v, mesh=mesh)
    with pytest.raises(ValueError, match="kv seq 60 not divisible by 8"):
        tsp.ring_attention(q, k[:, :60], v[:, :60], mesh=mesh)


def test_ring_attention_all_masked_rows():
    """Cross-attention with 4x longer queries: causal rows of the first
    query chunks are all masked in most key chunks (the finite _NEG
    algebra); the ring still equals the reference, NaN-free."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 64, 2, 8)).astype(np.float32)
    kv = rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
    ref = jsp.attention_reference(jnp.asarray(q), jnp.asarray(kv),
                                  jnp.asarray(kv), causal=True)
    got = tsp.ring_attention(_t(q), _t(kv), _t(kv),
                             mesh=tsp.make_seq_mesh(4, CPU8), causal=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_seq_mesh_matches_jax_local_core(causal):
    """MultiheadAttention(seq_mesh) on the JAX module's weights (no
    seq_mesh: the local core) through the bridge, forward and input
    gradient; norm_add included, and cross-attention where JAX's local
    core takes it (not causal: its mask needs s == sk)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 24)).astype(np.float32)
    kv = rng.standard_normal((2, 16, 20)).astype(np.float32)
    for cross in (False,) if causal else (False, True):
        jm = jmod.MultiheadAttention(num_heads=2, head_dim=8, causal=causal,
                                     norm_add=True, policy=JFULL)
        args = (jnp.asarray(x),) + ((jnp.asarray(kv),) if cross else ())
        v = jax.jit(jm.init)(jax.random.key(1), *args)
        (_, ref), jdx = jax.jit(jax.value_and_grad(
            lambda x, *a: (jnp.sum(jm.apply(v, x, *a)), jm.apply(v, x, *a)),
            has_aux=True))(*args)
        tm = load_flax_variables(tmod.MultiheadAttention(
            24, 2, 8, causal=causal, norm_add=True,
            kv_features=20 if cross else None, policy=FULL_PRECISION,
            seq_mesh=tsp.make_seq_mesh(4, CPU8)), v)
        tx = _t(x, True)
        out = tm(tx, *((_t(kv),) if cross else ()))
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
        out.sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                                   atol=1e-5)


def test_ring_attention_matches_jax_sharded(jax_sharded, inp):
    q, k, v, w = (inp[x] for x in ("q", "k", "v", "w_attn"))
    for causal in (False, True):
        tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
        out = tsp.ring_attention(tq, tk, tv, mesh=tsp.make_seq_mesh(8, CPU8),
                                 causal=causal)
        np.testing.assert_allclose(_np(out), jax_sharded[f"ring_{causal}"],
                                   atol=2e-6)
        torch.sum(out * _t(w)).backward()
        for name, t in zip("qkv", (tq, tk, tv)):
            np.testing.assert_allclose(
                t.grad.numpy(), jax_sharded[f"ring_{causal}_d{name}"],
                atol=1e-5)


# ------------------------------------------------------------- pipeline
def _pp_block(w, h):
    return h + torch.tanh(h @ w)


@pytest.mark.parametrize("stages,micro,remat", [(3, 3, False), (3, 2, True),
                                                (2, None, False),
                                                (1, 2, False)])
def test_pipeline_apply_matches_sequential_jax_loop(inp, stages, micro,
                                                    remat):
    """5 blocks over 1, 2 and 3 stages (N % S != 0: identity slots)
    against the JAX blocks applied in turn; forward and gradients of the
    weights and the input."""
    w, x, g = inp["pp_w"], inp["pp_x"], inp["pp_g"]

    def jloss(w, x):
        for i in range(w.shape[0]):
            x = _pp_block_jax(w[i], x)
        return jnp.sum(x * g), x
    (_, ref), (jdw, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(w), jnp.asarray(x))
    tw, tx = _t(w, True), _t(x, True)
    out = tpp.pipeline_apply(_pp_block, tw, tx,
                             mesh=tpp.make_pipe_mesh(stages, CPU8),
                             num_microbatches=micro, remat=remat)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
    torch.sum(out * _t(g)).backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5)


def test_pipeline_batch_axis_stack_and_errors(inp):
    """data x pipe (batch_axis) equals the 1-D pipeline within 1e-6 (its
    matmuls see half the rows, which the CPU's BLAS rounds apart);
    stacking state dicts round-trips as JAX's stack/unstack do; the
    microbatch error is JAX's."""
    w, x = _t(inp["pp_w"]), _t(inp["pp_x"])
    want = tpp.pipeline_apply(_pp_block, w, x,
                              mesh=tpp.make_pipe_mesh(3, CPU8),
                              num_microbatches=3)
    m2 = tmesh.Mesh(np.array(CPU8[:6], dtype=object).reshape(2, 3),
                    ("data", "pipe"))
    got = tpp.pipeline_apply(_pp_block, list(w), x, mesh=m2,
                             num_microbatches=3, batch_axis="data")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    placed = tpp.place_blocks(list(w), tpp.make_pipe_mesh(3, CPU8))
    assert placed[4] is w[4] or torch.equal(placed[4], w[4])
    torch.testing.assert_close(tpp.pipeline_apply(
        _pp_block, placed, x, mesh=tpp.make_pipe_mesh(3, CPU8),
        num_microbatches=3), want, rtol=0, atol=0)
    blocks = [{"a": w[i], "b": {"c": x[i]}} for i in range(5)]
    stacked = tpp.stack_block_params(blocks)
    j_stacked = j_stack([{"a": jnp.asarray(_np(b["a"])),
                          "b": {"c": jnp.asarray(_np(b["b"]["c"]))}}
                         for b in blocks])
    np.testing.assert_array_equal(_np(stacked["b"]["c"]),
                                  np.asarray(j_stacked["b"]["c"]))
    back = tpp.unstack_block_params(stacked)
    assert len(back) == len(j_unstack(j_stacked)) == 5
    assert torch.equal(back[3]["a"], w[3])
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 "
                                         "microbatches"):
        tpp.pipeline_apply(_pp_block, w, x, mesh=tpp.make_pipe_mesh(3, CPU8),
                           num_microbatches=4)


def test_pipeline_matches_jax_sharded(jax_sharded, inp):
    tw, tx = _t(inp["pp_w"], True), _t(inp["pp_x"], True)
    out = tpp.pipeline_apply(_pp_block, tw, tx,
                             mesh=tpp.make_pipe_mesh(3, CPU8),
                             num_microbatches=3, remat=True)
    np.testing.assert_allclose(_np(out), jax_sharded["pp_y"], atol=1e-5)
    torch.sum(out * _t(inp["pp_g"])).backward()
    np.testing.assert_allclose(tw.grad.numpy(), jax_sharded["pp_dw"],
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), jax_sharded["pp_dx"],
                               atol=1e-5)


# ------------------------------------------------------------- MoE
def _tmoe_params(inp, grad=False):
    return _moe_params(inp, lambda a: _t(a, grad))


def test_gate_weights_ties_and_gelu_match_jax():
    """Ties with the k-th probability keep every tied expert (more than
    k), as JAX's `probs >= kth`; the experts' GELU is tanh's."""
    x = np.zeros((3, 4), np.float32)
    x[1] = [1.0, 0.0, 0.0, 0.0]
    router = np.zeros((4, 6), np.float32)
    router[0, :3] = 2.0  # token 1: three experts tied on top
    params = {"router": {"w": router, "b": np.zeros(6, np.float32)}}
    want = np.asarray(jmoe.gate_weights(
        {"router": {k: jnp.asarray(v) for k, v in params["router"].items()}},
        jnp.asarray(x), 2))
    got = tmoe.gate_weights({"router": {k: _t(v) for k, v in
                                        params["router"].items()}}, _t(x), 2)
    np.testing.assert_allclose(_np(got), want, atol=1e-7)
    assert (want[1] > 0).sum() == 3 and (want[0] > 0).sum() == 6
    h = np.linspace(-4, 4, 33).astype(np.float32)
    np.testing.assert_allclose(
        _np(torch.nn.functional.gelu(_t(h), approximate="tanh")),
        np.asarray(jax.nn.gelu(jnp.asarray(h))), atol=1e-6)


@pytest.mark.parametrize("n", [8, 4, 2])
def test_moe_expert_parallel_matches_jax_dense(inp, n):
    """The experts over n shards against JAX's dense moe_apply: forward,
    the input's and the weights' gradients."""
    g = inp["moe_g"]

    def jloss(p, x):
        y = jmoe.moe_apply(p, x)
        return jnp.sum(y * g), y
    (_, ref), (jdp, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        _moe_params(inp, jnp.asarray), jnp.asarray(inp["moe_x"]))
    p, tx = _tmoe_params(inp, True), _t(inp["moe_x"], True)
    out = tep.moe_apply_expert_parallel(p, tx,
                                        mesh=tep.make_expert_mesh(n, CPU8))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
    torch.sum(out * _t(g)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jdp[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(p["router"]["w"].grad.numpy(),
                               np.asarray(jdp["router"]["w"]), atol=1e-5)


def test_moe_batch_axis_placed_shards_init_and_errors(inp):
    p, x = _tmoe_params(inp), _t(inp["moe_x"])
    want = tmoe.moe_apply(p, x)
    m2 = tmesh.Mesh(np.array(CPU8, dtype=object).reshape(2, 4),
                    ("data", "expert"))
    got = tep.moe_apply_expert_parallel(p, x, mesh=m2, batch_axis="data")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    mesh = tep.make_expert_mesh(4, CPU8)
    placed = tep.shard_expert_params(p, mesh)
    torch.testing.assert_close(
        tep.moe_apply_expert_parallel(placed, x, mesh=mesh), want, rtol=0,
        atol=1e-6)
    with pytest.raises(ValueError, match="8 experts not divisible by 3 "
                                         "devices"):
        tep.moe_apply_expert_parallel(p, x, mesh=tep.make_expert_mesh(
            3, CPU8))
    init = tmoe.init_moe_params(torch.Generator().manual_seed(0), 16, 32, 4)
    shapes = jax.tree.map(lambda a: a.shape, jmoe.init_moe_params(
        jax.random.key(0), 16, 32, 4))
    assert jax.tree.map(lambda a: tuple(a.shape), init) == shapes
    assert float(init["w1"].std()) == pytest.approx(16 ** -0.5, rel=0.1)


def test_moe_matches_jax_sharded(jax_sharded, inp):
    p, tx = _tmoe_params(inp, True), _t(inp["moe_x"], True)
    out = tep.moe_apply_expert_parallel(p, tx,
                                        mesh=tep.make_expert_mesh(4, CPU8))
    np.testing.assert_allclose(_np(out), jax_sharded["moe_y"], atol=1e-5)
    torch.sum(out * _t(inp["moe_g"])).backward()
    np.testing.assert_allclose(tx.grad.numpy(), jax_sharded["moe_dx"],
                               atol=1e-5)
    np.testing.assert_allclose(p["w1"].grad.numpy(), jax_sharded["moe_dw1"],
                               atol=1e-5)
    np.testing.assert_allclose(p["router"]["w"].grad.numpy(),
                               jax_sharded["moe_drouter"], atol=1e-5)


# ------------------------------------------------------------- RRDB trunk
@pytest.fixture(scope="module")
def rrdb_pair():
    from ghost_tpu.models.sr.rrdb import RRDBNet as JRRDB
    from ghost_tpu_torch.models.sr.rrdb import RRDBNet

    jnet = JRRDB(**RRDB, policy=JFULL)
    variables = _rrdb_variables(jnet, jax, jnp)
    tnet = load_flax_variables(RRDBNet(**RRDB, policy=FULL_PRECISION),
                               variables)
    return jnet, variables, tnet


def test_rrdb_forward_pipelined_matches_jax_apply(rrdb_pair, inp):
    """4 blocks over 3 stages (an identity slot) in 3 microbatches,
    against JAX's net.apply; the input gradient against jax.grad."""
    from ghost_tpu_torch.models.sr.rrdb import rrdb_forward_pipelined

    jnet, variables, tnet = rrdb_pair
    x = inp["rrdb_x"]
    (_, ref), jdx = jax.jit(jax.value_and_grad(
        lambda x: (jnp.sum(jnet.apply(variables, x)),
                   jnet.apply(variables, x)), has_aux=True))(jnp.asarray(x))
    tx = _t(x, True)
    for remat in (False, True):
        tx.grad = None
        out = rrdb_forward_pipelined(tnet, tx,
                                     mesh=tpp.make_pipe_mesh(3, CPU8),
                                     num_microbatches=3, remat=remat)
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-4)
        out.sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                                   rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        torch.testing.assert_close(
            rrdb_forward_pipelined(tnet, tx, mesh=tpp.make_pipe_mesh(
                3, CPU8), num_microbatches=3), tnet(tx), rtol=0, atol=1e-5)


def test_rrdb_pipelined_matches_jax_sharded(jax_sharded, rrdb_pair, inp):
    from ghost_tpu_torch.models.sr.rrdb import rrdb_forward_pipelined

    with torch.no_grad():
        out = rrdb_forward_pipelined(rrdb_pair[2], _t(inp["rrdb_x"]),
                                     mesh=tpp.make_pipe_mesh(3, CPU8),
                                     num_microbatches=3)
    np.testing.assert_allclose(_np(out), jax_sharded["rrdb_y"], atol=1e-4)


# ------------------------------------------------------------- tiling
@pytest.fixture(scope="module")
def srvgg_pair():
    from ghost_tpu.models.sr.srvgg import SRVGGNetCompact as JSR
    from ghost_tpu_torch.models.sr.srvgg import SRVGGNetCompact

    jnet = JSR(**SRVGG, policy=JFULL)
    variables = _srvgg_variables(jnet, jax, jnp)
    return jnet, variables, load_flax_variables(
        SRVGGNetCompact(**SRVGG, policy=FULL_PRECISION), variables)


@torch.no_grad()
def test_upscale_tiled_mesh_matches_jax_and_unsharded(srvgg_pair, inp):
    """8 tiles over 4 and 8 shards equal the port's unsharded stitch bit
    for bit and JAX's unsharded upscale_tiled within 1e-5; the tile error
    is JAX's."""
    from ghost_tpu.pipeline.enhance import upscale_tiled as j_tiled
    from ghost_tpu_torch.pipeline.enhance import upscale_tiled

    jnet, variables, tnet = srvgg_pair
    x = inp["tile_x"]
    ref = np.asarray(j_tiled(jnet, variables, jnp.asarray(x), tile=(16, 12),
                             tile_pad=2))
    plain = upscale_tiled(tnet, _t(x), tile=(16, 12), tile_pad=2)
    np.testing.assert_allclose(_np(plain), ref, atol=1e-5)
    for n in (4, 8):
        got = upscale_tiled(tnet, _t(x), tile=(16, 12), tile_pad=2,
                            mesh=tmesh.make_mesh(CPU8[:n]))
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="8 tiles not divisible by mesh "
                                         "'data' size 3"):
        upscale_tiled(tnet, _t(x), tile=(16, 12), tile_pad=2,
                      mesh=tmesh.make_mesh(CPU8[:3]))


@torch.no_grad()
def test_upscale_tiled_matches_jax_sharded(jax_sharded, srvgg_pair, inp):
    from ghost_tpu_torch.pipeline.enhance import upscale_tiled

    got = upscale_tiled(srvgg_pair[2], _t(inp["tile_x"]), tile=(16, 12),
                        tile_pad=2, mesh=tmesh.make_mesh(CPU8[:4]))
    np.testing.assert_allclose(_np(got), jax_sharded["tile_y"], atol=1e-5)


@torch.no_grad()
def test_face_enhancer_bg_mesh_equals_unsharded(srvgg_pair):
    """FaceEnhancer(bg_mesh=...) on 4 logical shards: its background pass
    (tiles sharded, the model replicated once at construction) equals
    bg_mesh=None's bit for bit. The face lanes do not touch the mesh."""
    from ghost_tpu_torch.pipeline.enhance import FaceEnhancer

    frames = torch.from_numpy(np.random.default_rng(9).integers(
        0, 255, (2, 32, 48, 3), dtype=np.uint8))
    gfp = torch.nn.Linear(1, 1)  # stands in for GFPGAN: its device only
    outs = [FaceEnhancer(None, gfp, srvgg_pair[2], bg_tile=(16, 12),
                         bg_tile_pad=2, bg_mesh=mesh)._bg_base(frames)
            for mesh in (None, tmesh.make_mesh(CPU8[:4]))]
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
