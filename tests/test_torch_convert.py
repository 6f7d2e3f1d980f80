"""The port's `.pth` converters (`ghost_tpu_torch/convert/torch_loader.py`)
against ghost_tpu's on the same seeded state dicts with the reference's
names (`tests/torch_cli_inputs.py`), and the models loaded through them
against the JAX models loaded through JAX's.

Trees must be equal path for path and leaf for leaf (the same numpy
transposes). Forwards in f32 are held to the bound of
`tests/test_torch_models.py` (1e-4 relative and absolute: deep conv
stacks, sums in another order): AEI-Net at width 1/16 (unet and resnet
encoders, 2 blocks, B=1, 256x256), IResNet (1,1,1,1) (B=2, 112x112) and
the resnet attribute encoder alone (B=2, 128x128).
"""

import numpy as np
import pytest
import torch

from ghost_tpu_torch.convert import torch_loader as tl
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.precision import FULL_PRECISION
from ghost_tpu_torch.models import aei as taei
from ghost_tpu_torch.models import aei_resnet as taei_resnet
from ghost_tpu_torch.models import arcface as tarc
from torch_cli_inputs import aei_state_dict, arcface_state_dict

F32 = dict(rtol=1e-4, atol=1e-4)
WIDTH = 1 / 16


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_trees_equal(got, ref):
    got, ref = dict(_flat(got)), dict(_flat(ref))
    assert sorted(got) == sorted(ref)
    for path, r in ref.items():
        g = got[path]
        assert g.dtype == r.dtype and np.array_equal(g, r), path


@pytest.mark.parametrize("backbone", ["unet", "linknet", "resnet"])
@pytest.mark.parametrize("num_blocks", [1, 2])
def test_aei_tree_matches_jax(backbone, num_blocks):
    from ghost_tpu.convert import torch_loader as jl

    sd = aei_state_dict(np.random.default_rng(num_blocks), backbone,
                        num_blocks, WIDTH)
    _assert_trees_equal(
        tl.convert_aei_state_dict(sd, backbone, num_blocks),
        jl.convert_aei_state_dict(sd, backbone, num_blocks))


@pytest.mark.parametrize("layers", [(1, 1, 1, 1), (3, 4, 6, 3)])
def test_arcface_tree_matches_jax(layers):
    from ghost_tpu.convert import torch_loader as jl

    sd = arcface_state_dict(np.random.default_rng(0), layers)
    _assert_trees_equal(tl.convert_arcface_state_dict(sd, layers),
                        jl.convert_arcface_state_dict(sd, layers))


def test_unknown_backbone_raises():
    with pytest.raises(ValueError, match="unknown backbone"):
        tl.convert_aei_state_dict({}, backbone="vgg")
    with pytest.raises(ValueError, match="unknown backbone"):
        taei.AEINet(backbone="vgg")


class _Holder(torch.nn.Module):
    """A module saved whole: load_torch_checkpoint takes its state_dict."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 2)


@pytest.mark.parametrize("wrapper", [None, "state_dict", "model",
                                     "params_ema", "params", "module"])
def test_load_torch_checkpoint_matches_jax(tmp_path, wrapper):
    """Bare dicts, each wrapper key the reference's families use, and a
    whole pickled module (the weights_only retry)."""
    from ghost_tpu.convert import torch_loader as jl

    g = torch.Generator().manual_seed(0)
    sd = {"a.weight": torch.randn(4, 3, generator=g),
          "a.bias": torch.randn(4, generator=g),
          "bn.num_batches_tracked": torch.tensor(7)}
    if wrapper == "module":
        obj = _Holder()
    elif wrapper is None:
        obj = sd
    else:
        obj = {wrapper: sd, "meta": {"epoch": 3}}
    path = tmp_path / "w.pth"
    torch.save(obj, path)
    got, ref = tl.load_torch_checkpoint(str(path)), \
        jl.load_torch_checkpoint(str(path))
    assert sorted(got) == sorted(ref) and got
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def _run(tmod, *args):
    with torch.no_grad():
        return tmod(*[torch.from_numpy(np.asarray(a)) for a in args])


@pytest.mark.parametrize("backbone", ["unet", "resnet"])
def test_aeinet_through_pth_matches_jax(backbone):
    import jax
    import jax.numpy as jnp

    from ghost_tpu.convert import torch_loader as jl
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import aei as jaei

    rng = np.random.default_rng(3)
    sd = aei_state_dict(rng, backbone, 2, WIDTH)
    jm = jaei.AEINet(backbone=backbone, num_blocks=2, policy=JFULL,
                     width=WIDTH)
    j_vars = jax.tree.map(jnp.asarray,
                          jl.convert_aei_state_dict(sd, backbone, 2))
    tm = load_flax_variables(
        taei.AEINet(backbone, num_blocks=2, policy=FULL_PRECISION,
                    width=WIDTH).eval(),
        tl.convert_aei_state_dict(sd, backbone, 2))
    xt = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    zid = rng.normal(0, 1, (1, 512)).astype(np.float32)
    y_ref, attrs_ref = jax.jit(jm.apply)(j_vars, jnp.asarray(xt),
                                         jnp.asarray(zid))
    y, attrs = _run(tm, xt, zid)
    assert tuple(y.shape) == (1, 256, 256, 3)
    assert float(np.std(np.asarray(y_ref))) > 0.1  # not a flat output
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **F32)
    assert len(attrs) == len(attrs_ref) == 8
    for a, b in zip(attrs_ref, attrs):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)


def test_iresnet_through_pth_matches_jax():
    import jax
    import jax.numpy as jnp

    from ghost_tpu.convert import torch_loader as jl
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import arcface as jarc

    layers = (1, 1, 1, 1)
    rng = np.random.default_rng(4)
    sd = arcface_state_dict(rng, layers)
    jm = jarc.IResNet(layers=layers, policy=JFULL)
    j_vars = jax.tree.map(jnp.asarray,
                          jl.convert_arcface_state_dict(sd, layers))
    tm = load_flax_variables(tarc.IResNet(layers, policy=FULL_PRECISION),
                             tl.convert_arcface_state_dict(sd, layers))
    x = rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    ref = jax.jit(jm.apply)(j_vars, jnp.asarray(x))
    np.testing.assert_allclose(_run(tm, x).numpy(), np.asarray(ref), **F32)


def test_resnet_encoder_matches_jax():
    """MLAttrEncoderResnet alone (the `encoder` subtree of a resnet G)."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.convert import torch_loader as jl
    from ghost_tpu.core.precision import FULL_PRECISION as JFULL
    from ghost_tpu.models import aei_resnet as jaei_resnet

    rng = np.random.default_rng(5)
    tree = jl.convert_aei_state_dict(aei_state_dict(rng, "resnet", 1, WIDTH),
                                     "resnet", 1)
    enc = {c: tree[c]["encoder"] for c in tree}
    jm = jaei_resnet.MLAttrEncoderResnet(policy=JFULL)
    tm = load_flax_variables(
        taei_resnet.MLAttrEncoderResnet(policy=FULL_PRECISION), enc)
    assert tm.attr_channels == (1024, 2048, 1024, 512, 256, 128, 64, 64)
    x = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    ref = jax.jit(jm.apply)(jax.tree.map(jnp.asarray, enc), jnp.asarray(x))
    got = _run(lambda v: tm(v.permute(0, 3, 1, 2)), x)
    assert len(got) == len(ref) == 8
    for a, b in zip(ref, got):
        assert tuple(b.permute(0, 2, 3, 1).shape) == a.shape
        np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(a), **F32)
