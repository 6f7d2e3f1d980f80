"""The port's AdaptiveWingLoss FAN (`ghost_tpu_torch/models/fan_awl.py`)
and its converter (`convert/torch_loader.py:convert_fan_awl_state_dict`)
against ghost_tpu's, on the CPU, at `tests/test_fan_awl.py:22`'s tiny
config (2 stacks, depth 2, 12 features, 8 mid, 6+1 heatmaps, 64 px):
the CoordConv stem, the boundary-masked coordinates of stack 2 and
every converter path.

add_coords: equal to JAX's, element for element, in f32 and bf16 (the
orientation quirk, xx along H, and the clamp(hm[..., -1], 0, 1) > 0.05
mask, whose heatmap is drawn to cross the gate). FANAWL on the same
converted tree through the bridge: f32 within 1e-4 of each stack's
scale; the port's bf16 run within 5e-2 of scale of its f32 run.
"""

import numpy as np
import pytest
import torch

import torch_weight_inputs as twi
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.convert.torch_loader import convert_fan_awl_state_dict
from ghost_tpu_torch.core.precision import DEFAULT_POLICY as TDEFAULT
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.models import fan_awl as tfan

FEAT, MID, DEPTH, MODULES, LMK = 12, 8, 2, 2, 6
CFG = dict(num_modules=MODULES, num_landmarks=LMK, features=FEAT,
           mid_features=MID, depth=DEPTH)

@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)



@pytest.fixture(scope="module")
def converted():
    rng = np.random.default_rng(0)
    sd = twi.fan_awl_state_dict(rng, MODULES, DEPTH, FEAT, MID, LMK)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    return sd, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_coords_against_jax(dtype):
    import jax.numpy as jnp

    from ghost_tpu.models.fan_awl import add_coords

    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 5, 6, 3)).astype(np.float32)
    hm = rng.uniform(-0.3, 0.6, (2, 5, 6, 4)).astype(np.float32)
    tdt = getattr(torch, dtype)
    for with_r in (False, True):
        for heat in (None, hm):
            want = add_coords(jnp.asarray(x, dtype), with_r,
                              None if heat is None else jnp.asarray(heat,
                                                                    dtype))
            got = tfan.add_coords(
                torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2), with_r,
                None if heat is None
                else torch.from_numpy(heat).to(tdt).permute(0, 3, 1, 2))
            got = got.permute(0, 2, 3, 1).float().numpy()
            np.testing.assert_array_equal(
                got, np.asarray(want.astype(jnp.float32)))
    # the gate is crossed both ways, and xx runs along H
    keep = np.clip(hm[..., -1], 0, 1) > 0.05
    assert keep.any() and (~keep).any()
    np.testing.assert_array_equal(got[0, :, 0, 3], np.linspace(-1, 1, 5))


def test_converter_against_jax(converted):
    from ghost_tpu.convert.torch_loader import \
        convert_fan_awl_state_dict as jconvert

    sd, _ = converted
    a = _flat(convert_fan_awl_state_dict(sd, MODULES, DEPTH))
    b = _flat(jconvert(sd, num_modules=MODULES, depth=DEPTH))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    # a DataParallel checkpoint's `module.` prefix is dropped
    c = _flat(convert_fan_awl_state_dict(
        {f"module.{k}": v for k, v in sd.items()}, MODULES, DEPTH))
    assert c.keys() == a.keys()


def _jax_heatmaps(policy, tree, x):
    import jax
    import jax.numpy as jnp

    from ghost_tpu.models.fan_awl import FANAWL

    model = FANAWL(**CFG, policy=policy)
    outs = jax.jit(model.apply)(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(x))
    return [np.asarray(o, np.float32) for o in outs]


def _port_heatmaps(policy, tree, x):
    model = load_flax_variables(tfan.FANAWL(**CFG, policy=policy), tree)
    with torch.no_grad():
        return [o.float().numpy() for o in model.eval()(torch.from_numpy(x))]


def test_fan_awl_against_jax(converted):
    from ghost_tpu.core.precision import FULL_PRECISION

    sd, x = converted
    tree = convert_fan_awl_state_dict(sd, MODULES, DEPTH)
    want = _jax_heatmaps(FULL_PRECISION, tree, x)
    got = _port_heatmaps(TFULL, tree, x)
    assert len(got) == len(want) == MODULES
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 16, 16, LMK + 1)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    # bf16 (add_coords in bf16 is exact above): the port's own error
    # against its f32 run stays at bf16's scale
    got16 = _port_heatmaps(TDEFAULT, tree, x)
    for g, g32 in zip(got16, got):
        assert np.abs(g - g32).max() <= 5e-2 * np.abs(g32).max()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out
