"""The port's export CLI (`ghost_tpu_torch/cli/export.py`) against
ghost_tpu's, on the CPU.

  * `--format onnx`: for the same `--G_path` checkpoint both `main`s
    write the same bytes (the same graph, node for node, the same
    initializers) and the same `--weights_out` tree; without a
    checkpoint the port's iresnet34 graph equals, byte for byte, what
    JAX's emitter writes for the port's `--weights_out` tree.
  * `--format pt2`: `main` at width 0.125 (AEINet unet, 1 block, bf16
    compute as DEFAULT_POLICY) with a converted checkpoint: the reloaded
    program (`torch.export.load`) equals the eager module at batch 1 and
    3 (the export traced at 2; the same ops in the same order: 1e-6 of
    scale), and both stand against JAX's AEINet at the same width and
    policy on the same tree within 2x the eager module's own bf16 error
    against its f32 twin, plus 1e-3 of scale. This pins the stated
    departure: JAX's StableHLO route rebuilds the generator without
    `--width`. IResNet (1,1,1,1) through `export_program` the same way.
  * `nn.layers.resize_matrix`'s cache: eager -> export -> eager gives
    equal eager results, and the export neither reads nor fills the
    cache (so it leaves no fake tensor for the eager calls after it).
  * `--format stablehlo` is refused by argparse; no card, no default
    device.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import torch_cli_inputs as cin
from ghost_tpu_torch.cli import export as texport
from ghost_tpu_torch.core import checkpoint as tckpt
from ghost_tpu_torch.convert.from_jax import load_flax_variables
from ghost_tpu_torch.core.precision import DEFAULT_POLICY as TDEFAULT
from ghost_tpu_torch.core.precision import FULL_PRECISION as TFULL
from ghost_tpu_torch.models.aei import AEINet as TAEINet
from ghost_tpu_torch.models.arcface import IResNet
from ghost_tpu_torch.nn import layers as tlayers
from ghost_tpu_torch.nn.layers import init_weights

@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)



def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv, **kw)
    return buf.getvalue().splitlines()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def g_pth(tmp_path_factory):
    """A seeded G .pth at width 1/8, unet, 1 block."""
    path = str(tmp_path_factory.mktemp("g") / "G_unet_1blocks.pth")
    cin.save_pth(path, cin.aei_state_dict(np.random.default_rng(0), "unet",
                                          1, 1 / 8))
    return path


def test_onnx_aei_bytes_equal_jax(g_pth, tmp_path):
    from ghost_tpu.cli.export import main as jmain
    from ghost_tpu.core import checkpoint as jckpt

    files, lines = {}, {}
    for name, main, kw in (("port", texport.main, {"device": "cpu"}),
                           ("jax", jmain, {})):
        files[name] = (str(tmp_path / f"{name}.onnx"),
                       str(tmp_path / f"{name}.msgpack"))
        argv = ["--model", "aei", "--format", "onnx", "--out", files[name][0],
                "--G_path", g_pth, "--num_blocks", "1", "--width", "0.125",
                "--weights_out", files[name][1]]
        lines[name] = [ln.replace(files[name][0], "OUT").replace(
            files[name][1], "W") for ln in _run(main, argv, **kw)]
    assert lines["port"] == lines["jax"]
    with open(files["port"][0], "rb") as f, open(files["jax"][0], "rb") as g:
        assert f.read() == g.read()
    for load in (tckpt.load_msgpack, jckpt.load_msgpack):
        a, b = _flat(load(files["port"][1])), _flat(load(files["jax"][1]))
        assert a.keys() == b.keys() and a
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_onnx_arcface_node_equal_jax(tmp_path):
    """Without `--arcface_path` the port's main emits its own seeded init;
    JAX's emitter on that tree (read back from `--weights_out`) at
    iresnet34's depth writes the same bytes."""
    from ghost_tpu.convert.onnx_emit import emit_arcface

    out, wout = str(tmp_path / "arc.onnx"), str(tmp_path / "arc.msgpack")
    _run(texport.main, ["--model", "arcface", "--format", "onnx", "--out",
                        out, "--arcface_depth", "iresnet34", "--batch", "4",
                        "--weights_out", wout], device="cpu")
    want = emit_arcface(tckpt.load_msgpack(wout), layers=(3, 4, 6, 3),
                        batch=4)
    with open(out, "rb") as f:
        assert f.read() == want


def _jax_default(fn, variables, args):
    """JAX's output at DEFAULT_POLICY (bf16 compute), jitted."""
    import jax
    import jax.numpy as jnp

    from ghost_tpu.core.precision import DEFAULT_POLICY

    jv = jax.tree.map(jnp.asarray, variables)
    return np.asarray(jax.jit(fn(DEFAULT_POLICY))(jv, *map(jnp.asarray,
                                                         args)))


def _check_program(path, eager, eager_f32, args_of, jax_ref):
    """The reloaded program at batch 1 and 3 against the eager module
    (1e-6 of scale) and JAX's bf16 output (2x the eager module's own
    bf16 error against its f32 twin, plus 1e-3 of scale)."""
    prog = torch.export.load(path).module()
    for b in (1, 3):
        args = args_of(b)
        with torch.no_grad():
            got, want, want32 = prog(*args), eager(*args), eager_f32(*args)
        assert got.shape == want.shape and got.shape[0] == b
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 * want.abs().max().item())
        ref, own_err = jax_ref[:b], (want - want32).abs().max().item()
        assert np.abs(got.numpy() - ref).max() <= \
            2 * own_err + 1e-3 * np.abs(ref).max()


@pytest.fixture(scope="module")
def aei_pt2(g_pth, tmp_path_factory):
    """`main --format pt2` at width 0.125 on the converted G, between two
    eager calls of the same module on one input (the resize cache
    emptied first), with the cache's statistics around the export."""
    d = tmp_path_factory.mktemp("pt2")
    out, wout = str(d / "aei.pt2"), str(d / "aei.msgpack")
    args = type("A", (), dict(model="aei", backbone="unet", num_blocks=1,
                              width=0.125, G_path=g_pth,
                              arcface_depth="iresnet100"))
    eager, tree, _ = texport.build_module(args, "cpu")
    rng = np.random.default_rng(1)
    xt = rng.uniform(-1, 1, (3, 256, 256, 3)).astype(np.float32)
    zid = rng.normal(0, 1, (3, 512)).astype(np.float32)
    y = texport.GeneratorY(eager)
    tlayers.resize_matrix.cache_clear()
    with torch.no_grad():
        before = y(torch.from_numpy(xt), torch.from_numpy(zid))
    info = tlayers.resize_matrix.cache_info()
    lines = _run(texport.main, ["--model", "aei", "--out", out, "--G_path",
                                g_pth, "--num_blocks", "1", "--width",
                                "0.125", "--weights_out", wout],
                 device="cpu")
    info_after = tlayers.resize_matrix.cache_info()
    with torch.no_grad():
        after = y(torch.from_numpy(xt), torch.from_numpy(zid))
    return dict(out=out, wout=wout, lines=lines, eager=eager, tree=tree,
                xt=xt, zid=zid, before=before, after=after, info=info,
                info_after=info_after)


def test_pt2_aei_width_0125_against_eager_and_jax(aei_pt2):
    from ghost_tpu.models.aei import AEINet

    e = aei_pt2
    assert e["lines"][0].startswith(f"exported aei -> {e['out']} (")
    saved = _flat(tckpt.load_msgpack(e["wout"]))
    want = _flat(e["tree"])
    assert saved.keys() == want.keys()
    for k in saved:
        np.testing.assert_array_equal(saved[k], want[k])
    eager32 = load_flax_variables(TAEINet(num_blocks=1, width=0.125,
                                          policy=TFULL), e["tree"]).eval()

    def y_of(p):
        mod = AEINet(backbone="unet", num_blocks=1, width=0.125, policy=p)
        return lambda v, a, b: mod.apply(v, a, b)[0]

    xt, zid = e["xt"], e["zid"]
    _check_program(e["out"], texport.GeneratorY(e["eager"]),
                   texport.GeneratorY(eager32),
                   lambda b: (torch.from_numpy(xt[:b]),
                              torch.from_numpy(zid[:b])),
                   _jax_default(y_of, e["tree"], (xt, zid)))


def test_pt2_iresnet_against_eager_and_jax(tmp_path):
    from ghost_tpu.models.arcface import IResNet as JIResNet
    from ghost_tpu_torch.convert.from_jax import flax_variables

    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (3, 112, 112, 3)).astype(np.float32)
    eager = init_weights(IResNet((1, 1, 1, 1), policy=TDEFAULT),
                         torch.Generator().manual_seed(0)).eval()
    tree = flax_variables(eager)
    eager32 = load_flax_variables(IResNet((1, 1, 1, 1), policy=TFULL),
                                  tree).eval()
    out = str(tmp_path / "arc.pt2")
    torch.export.save(texport.export_program("arcface", eager, -1), out)
    jref = _jax_default(lambda p: JIResNet(layers=(1, 1, 1, 1),
                                           policy=p).apply, tree, (x,))
    _check_program(out, eager, eager32,
                   lambda b: (torch.from_numpy(x[:b]),), jref)


def test_resize_cache_survives_export(aei_pt2):
    """eager -> export -> eager: the two eager calls agree, and the
    export leaves the cache's hits, misses and entries as they were."""
    e = aei_pt2
    assert e["info_after"] == e["info"] and e["info"].currsize > 0
    torch.testing.assert_close(e["after"], e["before"], rtol=0, atol=0)


def test_stablehlo_refused_and_card_default(tmp_path):
    with pytest.raises(SystemExit):
        texport.build_parser().parse_args(
            ["--out", "x", "--format", "stablehlo"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        texport.main(["--model", "arcface", "--out",
                      str(tmp_path / "a.pt2")])
