"""The port's schedulers and models against the JAX package at `tiny` geometry.

Weights: the JAX preset's seeded params, mapped onto the port's modules by
`from_jax_params`.  Inputs: numpy with a seed.  Both sides run fp32 (JAX at
"highest" matmul precision, tests/conftest.py), so the bar is fp32 rounding
through a few dozen layers: 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eta_inversion_tpu_torch.models import load_diffusion_model as t_load

TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    from tests.torch_port_util import tiny_pair

    return tiny_pair()


@pytest.fixture(scope="module")
def tiny_model(pair):
    return pair[0]


@pytest.fixture(scope="module")
def port_model(pair):
    return pair[1]


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------

def test_schedule_tables_match_jax():
    from eta_inversion_tpu.schedulers import DiffusionSchedule as J
    from eta_inversion_tpu_torch.schedulers import DiffusionSchedule as T

    j, t = J(num_inference_steps=10), T(num_inference_steps=10)
    np.testing.assert_array_equal(t.alphas_cumprod.numpy(), np.asarray(j.alphas_cumprod))
    np.testing.assert_array_equal(t.timesteps_backward, j.timesteps_backward)
    for mode in ("sameshift", "samesame", "shiftshift"):
        np.testing.assert_array_equal(t.timesteps_forward(mode), j.timesteps_forward(mode))
    for ts in (-100, 0, 500, 999, 1200):
        assert float(t.alpha_at(ts)) == float(j.alpha_at(ts))
        np.testing.assert_allclose(float(t.variance(ts)), float(j.variance(ts)), rtol=1e-6)


@pytest.mark.parametrize("mode", ["sameshift", "samesame", "shiftshift"])
def test_ddim_inverse_step_matches_jax(mode):
    from eta_inversion_tpu.schedulers import DiffusionSchedule as J, ddim_inverse_step as jstep
    from eta_inversion_tpu_torch.schedulers import DiffusionSchedule as T, ddim_inverse_step

    rs = np.random.RandomState(0)
    lat, eps = rs.randn(2, 8, 8, 4).astype(np.float32), rs.randn(2, 8, 8, 4).astype(np.float32)
    for t in (0, 500, 980):
        want = jstep(J(num_inference_steps=50), jnp.asarray(lat), jnp.asarray(eps), t, mode)
        got = ddim_inverse_step(T(num_inference_steps=50), _nchw(lat), _nchw(eps), t, mode)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ddim_backward_step_elementwise_eta_matches_jax():
    from eta_inversion_tpu.schedulers import DiffusionSchedule as J, ddim_backward_step as jstep
    from eta_inversion_tpu.schedulers.ddim import pred_x0 as jx0
    from eta_inversion_tpu_torch.schedulers import DiffusionSchedule as T, ddim_backward_step
    from eta_inversion_tpu_torch.schedulers.ddim import pred_x0

    rs = np.random.RandomState(1)
    lat, eps, noise = (rs.randn(2, 8, 8, 4).astype(np.float32) for _ in range(3))
    eta = rs.rand(2, 8, 8, 1).astype(np.float32)  # per-pixel eta
    j, t = J(num_inference_steps=10), T(num_inference_steps=10)
    for ts in (900, 400, 0):
        want = jstep(j, jnp.asarray(lat), jnp.asarray(eps), ts, eta=jnp.asarray(eta),
                     noise=jnp.asarray(noise))
        got = ddim_backward_step(t, _nchw(lat), _nchw(eps), ts, eta=_nchw(eta),
                                 noise=_nchw(noise))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
        want0 = jstep(j, jnp.asarray(lat), jnp.asarray(eps), ts)
        got0 = ddim_backward_step(t, _nchw(lat), _nchw(eps), ts)
        np.testing.assert_allclose(_nhwc(got0), np.asarray(want0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_nhwc(pred_x0(t, _nchw(lat), _nchw(eps), ts)),
                                   np.asarray(jx0(j, jnp.asarray(lat), jnp.asarray(eps), ts)),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# model parts
# ---------------------------------------------------------------------------

def test_tokenizer_copy_matches_jax(tiny_model, port_model):
    prompts = ["a cat sitting next to a mirror", "", "a tiger, sitting!"]
    np.testing.assert_array_equal(port_model.tokenizer(prompts), tiny_model.tokenizer(prompts))


def test_timestep_embedding_matches_jax():
    from eta_inversion_tpu.models.layers import timestep_embedding as j
    from eta_inversion_tpu_torch.models.layers import timestep_embedding as t

    ts = np.array([0, 1, 500, 999])
    # sin/cos of fp32 arguments up to ~1000, where one ulp is 6e-5
    np.testing.assert_allclose(t(torch.from_numpy(ts), 320).numpy(),
                               np.asarray(j(jnp.asarray(ts), 320)), rtol=0, atol=TOL)


def test_clip_text_matches_jax(tiny_model, port_model):
    ids = tiny_model.tokenizer(["a cat sitting next to a mirror", ""])
    want = tiny_model.encode_text(ids)
    got = port_model.encode_text(ids)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_vae_encode_decode_matches_jax(tiny_model, port_model, test_image):
    want_z = jax.jit(tiny_model.vae_encode)(jnp.asarray(test_image))
    with torch.no_grad():
        got_z = port_model.vae.encode(_nchw(test_image)) * port_model.scaling_factor
    np.testing.assert_allclose(_nhwc(got_z), np.asarray(want_z), rtol=TOL, atol=TOL)
    z = np.random.RandomState(2).randn(2, 8, 8, 4).astype(np.float32)
    want = jax.jit(tiny_model.vae_decode)(jnp.asarray(z))
    with torch.no_grad():
        got = port_model.vae.decode(_nchw(z) / port_model.scaling_factor)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=TOL, atol=TOL)


def _engines(tiny_model, port_model, steps=10):
    from eta_inversion_tpu import load_inverter as jl
    from eta_inversion_tpu_torch import load_inverter as tl

    return (jl(tiny_model, "etainv", num_inference_steps=steps),
            tl(port_model, "etainv", num_inference_steps=steps))


@pytest.mark.parametrize("hooks_kind", ["none", "ptp", "store"])
def test_unet_with_hooks_matches_jax(tiny_model, port_model, hooks_kind):
    """UNet eps (and stored probabilities) under no hooks, ptp hooks (q/k
    substitution + cross replace/reweight + stores) and the eta-inversion
    forward store hooks."""
    from eta_inversion_tpu.editing.controller import BatchLayout as JLayout
    from eta_inversion_tpu.editing.ptp import (AttnStoreController as JStore,
                                               PtpController as JPtp)
    from eta_inversion_tpu_torch.editing.controller import BatchLayout
    from eta_inversion_tpu_torch.editing.ptp import AttnStoreController, PtpController

    rs = np.random.RandomState(3)
    jinv, tinv = _engines(tiny_model, port_model)
    n = 1 if hooks_kind == "store" else 4
    lat = rs.randn(n, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(n, 77, 32).astype(np.float32)
    t, i = 700, 2
    jhooks = thooks = None
    if hooks_kind == "ptp":
        kw = dict(is_replace_controller=True, cross_replace_steps=0.8, self_replace_steps=0.5,
                  blend_words=(("cat",), ("tiger",)),
                  equilizer_params={"words": ("tiger",), "values": (2.0,)})
        src, tgt = "a cat sitting next to a mirror", "a tiger sitting next to a mirror"
        jc, tc = JPtp(jinv, src, tgt, **kw), PtpController(tinv, src, tgt, **kw)
        jhooks = jc.hooks(i, jc.init_state(jinv, jnp.asarray(lat[:2]), None), JLayout(2, True))
        thooks = tc.hooks(i, tc.init_state(tinv, _nchw(lat[:2]), None), BatchLayout(2, True))
    elif hooks_kind == "store":
        jc = JStore(jinv, store_res=(8,), n_prompts=1, per_step_maps=True, resize=8)
        tc = AttnStoreController(tinv, store_res=(8,), n_prompts=1, per_step_maps=True,
                                 resize=8)
        jhooks, thooks = jc.hooks(i, None, JLayout(1, False)), tc.hooks(i, None, BatchLayout(1, False))
    from eta_inversion_tpu.ops.attn_ctrl import flatten_store

    @jax.jit  # one compile instead of op-by-op dispatch of the flax apply
    def apply(params, lat, ctx):
        eps, var = tiny_model.unet.apply({"params": params}, lat, t, ctx, jhooks,
                                         mutable=["attn_store"])
        return eps, flatten_store(var.get("attn_store", {}))

    want, jstore = apply(tiny_model.params["unet"], jnp.asarray(lat), jnp.asarray(ctx))
    store = {}
    with torch.no_grad():
        got = port_model.unet(_nchw(lat), t, _t(ctx), hooks=thooks, store=store)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=TOL, atol=TOL)
    assert sorted(store) == sorted(jstore)
    for k in store:
        np.testing.assert_allclose(store[k].numpy(), np.asarray(jstore[k]), rtol=TOL, atol=1e-6)


def test_from_jax_params_covers_the_flax_tree(port_model):
    """Every leaf of the JAX preset's param tree (shapes from an abstract
    init, no compile) maps onto one port parameter of the right shape."""
    from eta_inversion_tpu.models import TINY, init_random_params
    from eta_inversion_tpu_torch.models.convert import from_jax_params

    abstract = jax.eval_shape(lambda: init_random_params(TINY))
    tree = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), abstract)
    sd = from_jax_params(tree)
    names = dict(port_model.nets.named_parameters())
    assert sorted(sd) == sorted(names)
    for k, v in sd.items():
        assert tuple(names[k].shape) == v.shape, k


def test_seeded_init_follows_flax_initializers():
    """Same seed -> same weights; different seed -> different; per-tensor
    spreads are those of the flax initializers (lecun-normal kernels: std
    1/sqrt(fan_in); unit norm scales; zero biases)."""
    import math

    a, _ = t_load("tiny", seed=3)
    b, _ = t_load("tiny", seed=3)
    c, _ = t_load("tiny", seed=4)
    for (name, p), (_, q) in zip(a.nets.named_parameters(), b.nets.named_parameters()):
        assert torch.equal(p, q), name
    assert not torch.equal(a.unet.conv_in.weight, c.unet.conv_in.weight)
    for name, mod in a.nets.named_modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)) and mod.weight.numel() >= 4096:
            fan_in = mod.weight[0].numel()
            np.testing.assert_allclose(mod.weight.std().item(), 1 / math.sqrt(fan_in),
                                       rtol=0.1, err_msg=name)
            assert mod.weight.abs().max().item() <= 2 / math.sqrt(fan_in) / 0.8796 + 1e-6
        if isinstance(mod, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
            assert torch.all(mod.weight == 1) and torch.all(mod.bias == 0), name
