"""The apex-parity modules and optimizers against ghost_tpu's, and the
slice as a whole: a causal norm-add attention block and an MLP trained
for 3 steps with `ghost_adam` in both packages.

Weights are seeded flax trees bridged into the port
(`convert/from_jax.py`). Bounds, f32 throughout (FULL_PRECISION):
module outputs 2e-5 absolute and relative (the same f32 math, matmul
sums in another order over widths <= 64); optimizer states after 3
steps 1e-6 (elementwise updates of O(1e-2) values); the training slice
1e-5 on the losses and 2e-5 on the parameters (3 Adam steps of lr 4e-4:
each update is a ratio g / sqrt(v) of O(1), so gradient differences of
a few ulps stay far below the bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from ghost_tpu.core.precision import FULL_PRECISION as JFULL
from ghost_tpu.nn import modules as jmod
from ghost_tpu.train import optimizers as jopt
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.precision import FULL_PRECISION
from ghost_tpu_torch.nn import modules as tmod
from ghost_tpu_torch.ops.cuda.attention import flash_attention_fwd
from ghost_tpu_torch.train import optimizers as topt

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    # full f32 products on both sides whatever the process defaults: on a
    # CPU with bf16 matrix units a library may otherwise take a
    # reduced-precision product, which the 2e-5 bounds would not hold
    torch.set_float32_matmul_precision("highest")
    # torch's first exp call in a process running 2 threads gives, in
    # about one process in ten, values up to ~1e-4 (relative) off the
    # later calls on the same input, a library defect the 2e-5 bounds
    # below would catch in whichever test calls exp first (the MHA core).
    # One call first takes it.
    torch.exp(torch.zeros(1 << 16))
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


def _perturbed(variables, seed):
    """Seeded values for every leaf, so ones/zeros inits are exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(0, 0.2, a.shape), a.dtype),
        variables)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_mlp_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 24)).astype(np.float32)
    jm = jmod.MLP(features=(48, 16, 8), policy=JFULL)
    v = _perturbed(jm.init(jax.random.key(0), jnp.asarray(x)), 1)
    ref = jm.apply(v, jnp.asarray(x))
    tm = load_flax_variables(tmod.MLP(24, (48, 16, 8), policy=FULL_PRECISION), v)
    np.testing.assert_allclose(tm(_t(x)).detach().numpy(), np.asarray(ref),
                               **TOL)


# (seq, causal, norm_add, cross, use_kernel): seq 128 takes the
# flash-attention core, seq 96 and cross-attention the plain one
MHA_CASES = [
    (128, False, False, False, True),
    (128, True, True, False, True),
    (128, False, True, False, False),
    (96, True, False, False, True),
    (128, False, False, True, True),
]


@pytest.mark.parametrize("seq,causal,norm_add,cross,use_kernel", MHA_CASES)
def test_multihead_attention_matches_jax(seq, causal, norm_add, cross,
                                         use_kernel):
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 64, 24)).astype(np.float32) if cross else None
    jm = jmod.MultiheadAttention(num_heads=2, head_dim=16, causal=causal,
                                 norm_add=norm_add, policy=JFULL)
    args = (jnp.asarray(x),) if kv is None else (jnp.asarray(x),
                                                 jnp.asarray(kv))
    v = _perturbed(jm.init(jax.random.key(0), *args), 2)
    ref = jm.apply(v, *args)
    tm = load_flax_variables(tmod.MultiheadAttention(
        32, 2, 16, causal=causal, norm_add=norm_add, use_kernel=use_kernel,
        kv_features=24 if cross else None, policy=FULL_PRECISION), v)
    t_args = (_t(x),) if kv is None else (_t(x), _t(kv))
    with torch.no_grad():
        out = tm(*t_args)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((16, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, 16)
    ref = jmod.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     smoothing)
    got = tmod.softmax_cross_entropy(_t(logits), torch.from_numpy(labels),
                                     smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape,axis", [((12, 7), -1), ((3, 3, 4, 6), -1),
                                        ((5, 6), 0)])
def test_weight_norm_matches_jax(shape, axis):
    rng = np.random.default_rng(4)
    kernel = rng.standard_normal(shape).astype(np.float32)
    g = rng.uniform(0.5, 2, shape[axis]).astype(np.float32)
    ref = jmod.weight_norm(jnp.asarray(kernel), jnp.asarray(g), axis)
    got = tmod.weight_norm(_t(kernel), _t(g), axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_weight_norm_dense_matches_jax():
    x = np.random.default_rng(5).standard_normal((4, 10)).astype(np.float32)
    jm = jmod.WeightNormDense(features=6)
    v = _perturbed(jm.init(jax.random.key(0), jnp.asarray(x)), 6)
    ref = jm.apply(v, jnp.asarray(x))
    tm = load_flax_variables(tmod.WeightNormDense(10, 6), v)
    np.testing.assert_allclose(tm(_t(x)).detach().numpy(), np.asarray(ref),
                               **TOL)


# ---------------------------------------------------------------------------
# Optimizers: 3 steps on the same params and gradients as the optax chains
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "ghost_adam": (lambda: jopt.ghost_adam(),
                   lambda p: topt.ghost_adam(p)),
    "ghost_adam_step_lr": (
        lambda: jopt.ghost_adam(lr=jopt.step_lr(1e-2, 2, 0.5)),
        lambda p: topt.ghost_adam(p, lr=topt.step_lr(1e-2, 2, 0.5))),
    "fused_lamb": (lambda: jopt.fused_lamb(), lambda p: topt.fused_lamb(p)),
    "larc_adam": (lambda: optax.chain(jopt.larc(), jopt.ghost_adam()),
                  lambda p: topt.larc(topt.ghost_adam(p))),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    make_j, make_t = OPTIMIZERS[name]
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((5, 4)).astype(np.float32),
              "b": (rng.standard_normal(4) * 0.1).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt = make_j()
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(_t(v).clone()) for k, v in params.items()}
    topt_ = make_t(list(tp.values()))
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = _t(g[k])
        topt_.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
        assert not np.allclose(p.detach().numpy(), params[k])  # it moved


# ---------------------------------------------------------------------------
# The slice: attention block + MLP, cross-entropy, 3 ghost_adam steps
# ---------------------------------------------------------------------------

# the chip's full-width block (8 heads x 64, MLP (2048, 512), B=8,
# S=4096) cut to 2 heads x 16, MLP (64, 32), B=2, S=128
SLICE = dict(batch=2, seq=128, heads=2, head_dim=16, hidden=64)


class _JBlock(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        d = SLICE["heads"] * SLICE["head_dim"]
        h = jmod.MultiheadAttention(SLICE["heads"], SLICE["head_dim"],
                                    causal=True, norm_add=True, policy=JFULL,
                                    name="attn")(x)
        return jmod.MLP((SLICE["hidden"], d), policy=JFULL, name="mlp")(h)


class _TBlock(torch.nn.Module):
    def __init__(self):
        super().__init__()
        d = SLICE["heads"] * SLICE["head_dim"]
        self.attn = tmod.MultiheadAttention(
            d, SLICE["heads"], SLICE["head_dim"], causal=True, norm_add=True,
            policy=FULL_PRECISION)
        self.mlp = tmod.MLP(d, (SLICE["hidden"], d), policy=FULL_PRECISION)

    def forward(self, x):
        return self.mlp(self.attn(x))


def test_training_slice_matches_jax():
    d = SLICE["heads"] * SLICE["head_dim"]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((SLICE["batch"], SLICE["seq"], d)).astype(np.float32)
    labels = rng.integers(0, d, (SLICE["batch"] * SLICE["seq"],))
    jb = _JBlock()
    variables = _perturbed(jb.init(jax.random.key(0), jnp.asarray(x)), 12)

    def loss_fn(params):
        logits = jb.apply({"params": params}, jnp.asarray(x))
        return jnp.mean(jmod.softmax_cross_entropy(
            logits.reshape(-1, d), jnp.asarray(labels)))

    params = variables["params"]
    opt = jopt.ghost_adam()
    state = opt.init(params)
    j_losses = []
    for _ in range(3):
        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        j_losses.append(float(loss))

    tb = load_flax_variables(_TBlock(), variables)
    t_opt = topt.ghost_adam(tb.parameters())
    t_losses = []
    before = flash_attention_fwd.launches
    for _ in range(3):
        t_opt.zero_grad()
        logits = tb(_t(x))
        loss = torch.mean(tmod.softmax_cross_entropy(
            logits.reshape(-1, d), torch.from_numpy(labels)))
        loss.backward()
        t_opt.step()
        t_losses.append(float(loss.detach()))
    assert flash_attention_fwd.launches == before  # the CPU takes plain
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=1e-5)
    assert t_losses[-1] < t_losses[0]
    want = load_flax_variables(_TBlock(), {"params": params})
    got = dict(tb.named_parameters())
    for name, p in want.named_parameters():
        # the key bias shifts each row of scores by a constant, so its
        # gradient is zero in exact arithmetic and Adam's g / sqrt(v)
        # steps it by +-lr on rounding noise: hold it to 3 steps of 2 lr
        tol = 6 * 4e-4 if name == "attn.k_proj.bias" else 2e-5
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   p.detach().numpy(), rtol=tol, atol=tol,
                                   err_msg=name)
