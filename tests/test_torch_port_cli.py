"""The port's entry points (python -m eta_inversion_tpu_torch.edit_image /
.invert_image) against the repository's JAX CLIs, on the CPU.

One tiny JAX parameter tree (tests/torch_port_util.py's) is exported as a
diffusers-layout checkpoint directory with the JAX package's key maps; the
root CLI (its `main`, in this process) and the port's (`--device cpu --dtype
float32`) run on it with the same image and flags, for inverters that draw
nothing, and their PNGs must agree within PNG_LEVELS uint8 levels; so must
one tinyxl run (the SDXL geometry, its checkpoint with text_encoder_2/).  The
flag table is held against JAX's `_ARGS` and the root CLIs' own flags, and
what the port still lacks exits with its message.
"""

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SRC, TGT = "a cat sitting next to a mirror", "a tiger sitting next to a mirror"
STEPS = 4
# both sides end in the same fp32 image to about 1e-4 (the slice tests' 1e-3
# bar is on [-1, 1] values, 0.13 of a level): a value near a rounding edge
# may land on the next level, no further
PNG_LEVELS = 1


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(checkpoint directory, input png) of the tiny JAX tree."""
    from tests.torch_port_util import write_tiny_checkpoint

    return write_tiny_checkpoint(tmp_path_factory.mktemp("ckpt"))


def _close(a, b):
    x, y = (np.asarray(Image.open(p)).astype(np.int16) for p in (a, b))
    assert x.shape == y.shape == (16, 16, 3)
    assert np.abs(x - y).max() <= PNG_LEVELS, np.abs(x - y).max()


@pytest.mark.parametrize("inv_method", ["diffinv", "dirinv", "npi", "proxnpi"])
def test_edit_image_matches_the_jax_cli(checkpoint, tmp_path, inv_method):
    """ptp with the automatic config (blend words and equalizer from the
    one differing word, its indices as edit_word_idx), edit and
    reconstruction."""
    import edit_image as jcli
    from eta_inversion_tpu_torch import edit_image

    weights, png = checkpoint
    want, want_inv = tmp_path / "jax.png", tmp_path / "jax_inv.png"
    jcli.main(argparse.Namespace(
        input=png, output=str(want), output_inv=str(want_inv), source_prompt=SRC,
        target_prompt=TGT, inv_method=inv_method, edit_method="ptp", model="tiny", steps=STEPS,
        dtype="float32", seed=0, weights_dir=weights, method_cfg="{}", editor_cfg="{}",
        edit_cfg=None))
    got, got_inv = tmp_path / "port.png", tmp_path / "port_inv.png"
    edit_image.main(edit_image.build_parser().parse_args([
        "-i", png, "-o", str(got), "--output_inv", str(got_inv), "-s", SRC, "-t", TGT,
        "--inv_method", inv_method, "--edit_method", "ptp", "--model", "tiny",
        "--steps", str(STEPS), "--weights_dir", weights, "--device", "cpu",
        "--dtype", "float32"]))
    _close(got, want)
    _close(got_inv, want_inv)


def test_edit_image_tinyxl_matches_the_jax_cli(tmp_path):
    """The SDXL-geometry preset through both CLIs on one tinyxl checkpoint
    (text_encoder_2/ with its projection; the packed 78-row context):
    diffinv + ptp with the automatic config; and every port preset is named
    in the --model help."""
    import edit_image as jcli
    from eta_inversion_tpu_torch import edit_image
    from eta_inversion_tpu_torch.models import PRESETS
    from eta_inversion_tpu_torch.utils.cli_utils import _ARGS
    from tests.torch_port_util import write_tiny_checkpoint

    assert all(name in _ARGS["model"]["help"] for name in PRESETS)
    weights, png = write_tiny_checkpoint(tmp_path, preset="tinyxl")
    assert (tmp_path / "text_encoder_2" / "model.safetensors").exists()
    want, got = tmp_path / "jax.png", tmp_path / "port.png"
    jcli.main(argparse.Namespace(
        input=png, output=str(want), output_inv=None, source_prompt=SRC, target_prompt=TGT,
        inv_method="diffinv", edit_method="ptp", model="tinyxl", steps=STEPS, dtype="float32",
        seed=0, weights_dir=weights, method_cfg="{}", editor_cfg="{}", edit_cfg=None))
    edit_image.main(edit_image.build_parser().parse_args([
        "-i", png, "-o", str(got), "-s", SRC, "-t", TGT, "--inv_method", "diffinv",
        "--edit_method", "ptp", "--model", "tinyxl", "--steps", str(STEPS),
        "--weights_dir", weights, "--device", "cpu", "--dtype", "float32"]))
    _close(got, want)


def test_invert_image_matches_the_jax_cli(checkpoint, tmp_path):
    import invert_image as jcli
    from eta_inversion_tpu_torch import invert_image

    weights, png = checkpoint
    want, got = tmp_path / "jax.png", tmp_path / "port.png"
    jcli.main(argparse.Namespace(input=png, output=str(want), prompt=SRC, inv_method="diffinv",
                                 model="tiny", steps=STEPS, dtype="float32", seed=0,
                                 weights_dir=weights, method_cfg="{}"))
    invert_image.main(invert_image.build_parser().parse_args([
        "-i", png, "-o", str(got), "-p", SRC, "--model", "tiny", "--steps", str(STEPS),
        "--weights_dir", weights, "--device", "cpu"]))
    _close(got, want)


def _root_flags(name):
    """The flags the root CLI `name` declares: its add_argument strings and
    its add_argparse_arg entries of JAX's _ARGS."""
    from eta_inversion_tpu.utils.cli_utils import _ARGS

    src = (ROOT / name).read_text()
    flags = set(re.findall(r'add_argument\(\s*"(-[^"]+)"(?:,\s*"(-[^"]+)")?', src))
    out = {f for pair in flags for f in pair if f}
    for key in re.findall(r'add_argparse_arg\(parser,\s*"(\w+)"\)', src):
        out.update(_ARGS[key]["flags"])
    return out


@pytest.mark.parametrize("name", ["edit_image", "invert_image"])
def test_flag_table_matches_the_jax_clis(name):
    """The port's _ARGS is JAX's; each entry point takes every flag of its
    root CLI, with the root's defaults, and --device (cuda by default)."""
    import importlib

    from eta_inversion_tpu.utils.cli_utils import _ARGS as JARGS
    from eta_inversion_tpu_torch.utils.cli_utils import _ARGS

    assert _ARGS == JARGS
    parser = importlib.import_module(f"eta_inversion_tpu_torch.{name}").build_parser()
    ours = {s for a in parser._actions for s in a.option_strings} - {"-h", "--help"}
    assert ours == _root_flags(f"{name}.py") | {"--device"}
    required = ["-i", "x.png", "-s", "a", "-t", "b"] if name == "edit_image" else \
        ["-i", "x.png", "-p", "a"]
    args = parser.parse_args(required)
    assert (args.dtype, args.steps, args.model, args.inv_method, args.device,
            args.weights_dir, args.method_cfg) == ("float32", 50, "sd15", "diffinv", "cuda",
                                                   None, "{}")


def test_unported_methods_exit_with_the_registry_message(checkpoint, tmp_path):
    """Every registry key is ported; what the port still lacks exits with its
    message, no traceback: pix2pix_zero without a caption (its BLIP
    captioner, ROADMAP M10) from a fresh process, exit code 1; a scheduler
    the inverters refuse in this one."""
    from eta_inversion_tpu_torch import edit_image

    weights, png = checkpoint
    common = ["-i", png, "-o", str(tmp_path / "x.png"), "-s", SRC, "-t", TGT, "--model", "tiny",
              "--steps", "2", "--weights_dir", weights, "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-m", "eta_inversion_tpu_torch.edit_image", *common,
                           "--edit_method", "pix2pix_zero"], cwd=ROOT, capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    assert proc.returncode == 1
    assert "BLIP captioner is not ported yet (ROADMAP M10)" in proc.stderr
    assert "Traceback" not in proc.stderr
    with pytest.raises(SystemExit, match="unknown scheduler euler"):
        edit_image.main(edit_image.build_parser().parse_args(
            [*common, "--method_cfg", '{"scheduler": "euler"}']))
    assert not (tmp_path / "x.png").exists()
