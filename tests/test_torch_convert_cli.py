"""The port's weight-conversion CLI (`ghost_tpu_torch/cli/convert.py`)
against ghost_tpu's `main`, on the CPU, for every `--kind`.

Each kind converts the same seeded checkpoint through both `main`s:
torch `.pth` state dicts with the reference's names
(`tests/torch_cli_inputs.py`, `torch_train_cli_inputs.py`,
`torch_route_inputs.py`, `torch_prep_inputs.py`,
`torch_weight_inputs.py`) at narrow widths where the CLI's flags allow
a narrow model (the converters read names, not widths; arcface at
iresnet34 and vgg19 are full size, since the CLI fixes their depth), a
raw MXNet `.params` file and an `.npz` for `landmark_mxnet`. The two
msgpack files are equal byte for byte, each package's `load_msgpack`
reads the other's file to the same tree (keys, dtypes, shapes, values),
and both print the same `wrote ... M params` line.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import torch_cli_inputs as cin
import torch_prep_inputs as pin
import torch_route_inputs as rin
import torch_train_cli_inputs as tin
import torch_weight_inputs as twi
from ghost_tpu_torch.cli import convert as tconvert
from ghost_tpu_torch.convert import mxnet_graph as tgraph
from ghost_tpu_torch.convert import mxnet_nd as tnd
from ghost_tpu_torch.core import checkpoint as tckpt
from ghost_tpu_torch.models.scrfd_v1e import SCRFD_2_5GF

@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)



def _pth(rng, d, kind):
    """(src path, extra flags) of a seeded checkpoint of `kind` in d."""
    path = str(d / f"{kind}.pth")
    if kind == "aei":
        sd, flags = cin.aei_state_dict(rng, "unet", 1, 1 / 16), [
            "--num_blocks", "1"]
    elif kind == "arcface":
        sd, flags = cin.arcface_state_dict(rng, (3, 4, 6, 3)), [
            "--arcface_depth", "iresnet34"]
    elif kind == "discriminator":
        sd, flags = tin.disc_state_dict(rng, num_D=2, n_layers=3, ndf=8), [
            "--num_D", "2", "--n_layers", "3"]
    elif kind == "spade":
        sd, flags = tin.spade_state_dict(rng, ngf=4), ["--ngf", "4"]
    elif kind == "scrfd":
        sd, flags = rin.scrfd_mmdet_state_dict(rng, SCRFD_2_5GF), []
    elif kind == "vgg19":
        sd, flags = twi.vgg19_state_dict(rng), []
    elif kind == "gfpgan":
        cin.save_pth(path, cin.gfpgan_state_dict(rng, narrow=1 / 32),
                     "params_ema")
        return path, []
    elif kind == "rrdb":
        cin.save_pth(path, cin.rrdb_state_dict(rng, 8, 2, 4), "params_ema")
        return path, ["--rrdb_blocks", "2"]
    elif kind == "srvgg":
        cin.save_pth(path, cin.srvgg_state_dict(rng, 8, 2), "params")
        return path, ["--num_conv", "2"]
    elif kind == "sam":
        sd = pin.sam_state_dict(rng, 8, 12, 2, (2, 5, 8, 11), 48, 16, 2,
                                16, 32)
        flags = ["--sam_preset", "vit_b"]
    elif kind == "fan":
        sd, flags = twi.fan_awl_state_dict(rng, 4, 4, 8, 8, 6), []
    cin.save_pth(path, sd)
    return path, flags


def _mxnet(rng, d, suffix):
    symbol = twi.write_symbol_2d106det(d / "2d106det-symbol.json")
    params = tgraph.MXNetGraphInterpreter(symbol, device="cpu").init_params(
        seed=int(rng.integers(1 << 30)))
    path = str(d / f"2d106det-0000{suffix}")
    if suffix == ".params":
        tnd.save_ndarray_dict(path, twi.prefixed(params))
    else:
        np.savez(path, **twi.prefixed(params))
    return path, []


def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv, **kw)
    return buf.getvalue().splitlines()


KINDS = ["aei", "arcface", "discriminator", "spade", "scrfd",
         "landmark_mxnet", "landmark_mxnet_npz", "vgg19", "gfpgan", "rrdb",
         "srvgg", "sam", "fan"]


@pytest.mark.parametrize("kind", KINDS)
def test_convert_kind_against_jax(kind, tmp_path):
    from ghost_tpu.cli.convert import main as jmain
    from ghost_tpu.core import checkpoint as jckpt

    rng = np.random.default_rng(KINDS.index(kind))
    if kind.startswith("landmark_mxnet"):
        src, flags = _mxnet(rng, tmp_path,
                            ".npz" if kind.endswith("npz") else ".params")
        kind = "landmark_mxnet"
    else:
        src, flags = _pth(rng, tmp_path, kind)
    outs = {}
    lines = {}
    for name, main, kw in (("port", tconvert.main, {"device": "cpu"}),
                           ("jax", jmain, {})):
        outs[name] = str(tmp_path / f"{name}.msgpack")
        argv = ["--kind", kind, "--src", src, "--out", outs[name]] + flags
        lines[name] = [ln.replace(outs[name], "OUT")
                       for ln in _run(main, argv, **kw)]
    assert lines["port"] == lines["jax"]
    assert lines["port"][-1].startswith("wrote OUT: ")
    with open(outs["port"], "rb") as f, open(outs["jax"], "rb") as g:
        assert f.read() == g.read()
    # the files are equal, so each package reading the other's file is
    # each reading its own
    a = _flat(jckpt.load_msgpack(outs["port"]))
    b = _flat(tckpt.load_msgpack(outs["jax"]))
    assert a.keys() == b.keys() and a
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def test_convert_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    src, flags = _pth(np.random.default_rng(0), tmp_path, "srvgg")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconvert.main(["--kind", "srvgg", "--src", src, "--out",
                       str(tmp_path / "o.msgpack")] + flags)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out
