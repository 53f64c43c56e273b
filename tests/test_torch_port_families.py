"""The other model families on the port -- SD-2.x (`tiny21`), v-prediction
(`tinyv`) and SDXL (`tinyxl`) -- against the JAX package, on the CPU: the
attention metas of all eight presets and the presets' fields equal JAX's
(configs alone, no model), and the JAX family grid
(tests/test_editing.py `test_family_golden`: each tiny family preset x
etainv+ptp and diffinv+simple, 6 steps) matches the JAX engine's outputs
within 1e-3, etainv's candidate noises drawn by JAX and injected.

Weights: the port's seeded init of each tiny preset written out as a flax
tree, both packages built from it (tests/torch_port_util.tiny_pair).  The
models alone are in tests/test_torch_port_families_models.py, nti, ddpminv
and edit_batch in tests/test_torch_port_families_edits.py, the checkpoint
round trip in tests/test_torch_port_weights.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

SRC = "a cat sitting next to a mirror"
TGT = "a tiger sitting next to a mirror"
STEPS = 6
PTP_CFG = {"is_replace_controller": True, "cross_replace_steps": 0.8, "self_replace_steps": 0.5}
FAMILIES = ["tiny21", "tinyv", "tinyxl"]
EDIT_TOL = 1e-3  # 2 x 6 UNet calls, a thresholded eta mask and an argmin between


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(preset):
    from tests.torch_port_util import tiny_pair

    return tiny_pair(preset=preset)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def _jax_draws(steps, count, shape_nhwc):
    """The JAX engine's candidate noises: PRNGKey(seed + 1), one split per
    backward step; returned NCHW per step."""
    rng = jax.random.PRNGKey(1)
    out = []
    for _ in range(steps):
        rng, k = jax.random.split(rng)
        n = np.array(jax.random.normal(k, (count,) + shape_nhwc, jnp.float32))
        out.append(torch.from_numpy(n).permute(0, 1, 4, 2, 3).contiguous())
    return out


@pytest.mark.parametrize("preset", ["sd15", "tiny", "sd21", "tiny21", "sd21v", "tinyv",
                                    "sdxl", "tinyxl"])
def test_attn_metas_match_jax(preset):
    """Same keys, same (self, cross) runs, every field of every meta equal:
    per-stage head counts, SDXL's depth-10 runs, the self / cross numbering
    masactrl and ptp read."""
    from eta_inversion_tpu.models import PRESETS as JPRESETS
    from eta_inversion_tpu.models.unet import build_attn_metas as jmetas
    from eta_inversion_tpu_torch.models import PRESETS
    from eta_inversion_tpu_torch.models.unet import build_attn_metas

    want, got = jmetas(JPRESETS[preset].unet), build_attn_metas(PRESETS[preset].unet)
    assert list(got) == list(want)
    for key in want:
        assert [tuple(vars(m).values()) for m in got[key]] == \
            [tuple(vars(m).values()) for m in want[key]], key
    # the presets themselves: the JAX package's, field by field
    jp, tp = JPRESETS[preset], PRESETS[preset]
    for part in ("unet", "vae", "text", "text2", "schedule"):
        a, b = getattr(jp, part), getattr(tp, part)
        assert (a is None) == (b is None), part
        if a is not None:
            assert {k: v for k, v in vars(b).items()} == \
                {k: v for k, v in vars(a).items() if k in vars(b)}, part
    assert jp.image_size == tp.image_size


@pytest.mark.parametrize("combo", [("etainv", "ptp"), ("diffinv", "simple")])
@pytest.mark.parametrize("preset", FAMILIES)
def test_family_grid_matches_jax(preset, combo):
    """tests/test_editing.py's family grid: the edit and reconstruction
    through both engines' editor.edit, 6 steps, etainv's defaults with the
    JAX candidate noises injected."""
    from eta_inversion_tpu import load_editor as jeditor, load_inverter as jinverter
    from eta_inversion_tpu_torch import load_editor, load_inverter

    jax_model, port = _pair(preset)
    inverter, editor = combo
    image = (np.random.RandomState(0).rand(1, 16, 16, 3).astype("float32") * 2 - 1)
    cfg = dict(PTP_CFG) if editor == "ptp" else None
    inv_cfg = {"edit_word_idx": (1, 1)} if inverter == "etainv" else None
    jinv = jinverter(jax_model, inverter, num_inference_steps=STEPS)
    want = jeditor(jinv, editor).edit(jnp.asarray(image), SRC, TGT, cfg=cfg and dict(cfg),
                                      inv_cfg=inv_cfg and dict(inv_cfg))
    kwargs = {}
    if inverter == "etainv":
        draws = _jax_draws(STEPS, jinv.noise_sample_count, (1, 8, 8, 4))
        kwargs["noise_fn"] = lambda i, shape: draws[i]
    got = load_editor(load_inverter(port, inverter, num_inference_steps=STEPS, **kwargs),
                      editor).edit(image, SRC, TGT, cfg=cfg and dict(cfg),
                                   inv_cfg=inv_cfg and dict(inv_cfg))
    assert set(got) == set(want)
    for key in want:
        g = got[key].numpy() if got[key].shape[-1] == 3 else _nhwc(got[key])
        np.testing.assert_allclose(g, np.asarray(want[key]), rtol=EDIT_TOL, atol=EDIT_TOL,
                                   err_msg=f"{preset} {inverter}+{editor}: {key}")
