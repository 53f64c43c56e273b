"""The port's attention microbenchmarks (S1, S3, S4) and the flash backward
above head dim 128 (K4a / K4b at d = 256, 512) against the JAX package, on
the CPU.

The Pallas prototypes' kernels are closures inside the scripts' main() and
cannot be imported, so each variant's function is held against the JAX
kernels whose bodies are the same, run in interpret mode as
tests/test_kernels.py runs them: `flash_attention_packed` (K1's
`_flash_packed_kernel`, the body of S4's `mh_kernel`) and
`flash_attention_bhsd` with block_k < S (K3's `_flash_kernel`, the body of
S3's `prod_kernel` and S1's `kernel`).  On a CPU tensor every wrapper takes
its kernel's plain version.  fp32 on both sides; inputs from numpy with a
seed.  The CUDA kernels run only on the card: tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eta_inversion_tpu.ops import flash_attention as jfa
from eta_inversion_tpu_torch.microbench import attn_multihead_bench, flash_sweep
from eta_inversion_tpu_torch.microbench import D, H, make_input, merge, split
from eta_inversion_tpu_torch.ops import flash_attention as tfa

# fp32 on both sides, the same exact softmax summed in another order over a
# few hundred keys (the bar of tests/test_torch_port_ops.py)
TOL = 1e-4
# zero columns change no product: padded and native agree to fp32 rounding
PAD_TOL = 1e-6
B, S = 2, 512


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qkv():
    """The microbenchmarks' input x (their seed and scale, fp32) and the
    JAX kernels' outputs on (x, x/2, x/4): K3 on the split heads (merged
    back) and K1 on the packed layout."""
    x = make_input(B, S, "cpu", torch.float32)
    q, k, v = (jnp.asarray(t.numpy()) for t in (x, x * 0.5, x * 0.25))

    def flat(t):
        return t.reshape(B, S, H, D).transpose(0, 2, 1, 3).reshape(B * H, S, D)

    k3 = jfa.flash_attention_bhsd(flat(q), flat(k), flat(v), scale=D ** -0.5, block_q=128,
                                  block_k=128, interpret=True)
    k3 = np.asarray(k3).reshape(B, H, S, D).transpose(0, 2, 1, 3).reshape(B, S, H * D)
    k1 = np.asarray(jfa.flash_attention_packed(q, k, v, scale=D ** -0.5, heads=H, block_q=128,
                                               block_k=128, interpret=True))
    return x, {"K3": k3, "K1": k1}


def _all_variants():
    return ([("sweep", n) for n in flash_sweep.variants()]
            + [("multihead", n) for n in attn_multihead_bench.variants()])


@pytest.mark.parametrize("bench,name", _all_variants())
def test_variant_matches_jax_kernel(qkv, bench, name):
    """Each of the 13 variants (8 of the sweep, 5 of the multi-head bench)
    against the JAX kernel with its prototype's body: S4's v8 variants
    against K1, S1's and S3's against K3."""
    x, want = qkv
    tfa.reset_launch_counts()
    mod = flash_sweep if bench == "sweep" else attn_multihead_bench
    got = mod.call(mod.variants()[name], x)
    assert set(tfa.LAUNCHES.values()) == {0}  # the plain versions on a CPU tensor
    ref = want["K1" if name.startswith("v8") else "K3"]
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL, err_msg=name)


def test_pad128_equals_native(qkv):
    x, _ = qkv
    v = flash_sweep.variants()
    np.testing.assert_allclose(v["v0_current_pad128"](x).numpy(), v["v3_dnative"](x).numpy(),
                               rtol=PAD_TOL, atol=PAD_TOL)


def test_split_merge_round_trip():
    x = torch.randn(2, 16, H * D)
    assert torch.equal(merge(split(x), 2), x)
    assert torch.equal(split(x)[3], x[0, :, 3 * D:4 * D])


def test_tile_maps_cover_the_prototypes_blocks():
    """Every TPU block pair of the prototypes maps to the card tile that
    PERF.md records (the kernels' C entry points own which tiles exist: on
    the card an unknown one raises, tests/test_torch_port_cuda.py)."""
    assert {bb: flash_sweep.card_tile(*bb) for bb in ((512, 1024), (512, 2048), (256, 1024))} \
        == {(512, 1024): (4, 64), (512, 2048): (4, 128), (256, 1024): (2, 64)}
    # S3's blocks (512, 2048) have no card tile: the TF32 mode sizes its own
    # and refuses a chosen one
    with pytest.raises(ValueError, match="does not take"):
        tfa.fwd_library(D, True, flash_sweep.card_tile(512, 2048))
    # S4's blocks all map to the all-heads block's one tile (128 query rows,
    # 128 keys a staged tile)
    assert {bb: attn_multihead_bench.card_tile(*bb)
            for bb in ((512, 2048), (256, 2048), (512, 1024), (512, 4096))} \
        == {(512, 2048): (128, 128), (256, 2048): (128, 128), (512, 1024): (128, 128),
            (512, 4096): (128, 128)} == {bb: tfa.MULTIHEAD_TILE for bb in
                                          ((512, 2048), (256, 2048), (512, 1024), (512, 4096))}
    with pytest.raises(KeyError):
        flash_sweep.card_tile(128, 1024)
    with pytest.raises(KeyError):
        attn_multihead_bench.card_tile(128, 2048)


def test_wrappers_refuse_unknown_operands_and_run_plain_on_cpu():
    x = torch.randn(4, 64, 40)
    with pytest.raises(ValueError, match="operands"):
        tfa.flash_attention_bhsd_tiled(x, x, x, 0.1, operands="fp16")
    with pytest.raises(ValueError, match="operands"):
        tfa.flash_attention_multihead(x, x, x, 0.1, 8, operands="tf32")
    want = tfa.flash_attention_bhsd_plain(x, x, x, 0.1)
    assert torch.equal(tfa.flash_attention_bhsd_tiled(x, x, x, 0.1, "fp32", (4, 128)), want)
    p = torch.randn(1, 64, 320)
    for operands in ("bf16", "fp32"):
        assert torch.equal(tfa.flash_attention_multihead(p, p, p, 0.1, 8, operands, (1, 64)),
                           tfa.flash_attention_packed_plain(p, p, p, 0.1, 8))


# ---------------------------------------------------------------------------
# K4a / K4b above head dim 128
# ---------------------------------------------------------------------------

def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("bh,s,d", [(1, 256, 512), (2, 128, 256)])
def test_wide_backward_matches_jax_grad(bh, s, d):
    """d sum(sin(o)) / d(q, k, v) at the VAE's head dim: the port's plain
    backward (K4a's and K4b's plain versions) and CPU autograd through
    `_FlashAttention` (the autograd.Function the card's K4a / K4b sit
    behind) against jax.grad of flash_attention_bhsd run in interpret mode
    (its custom_vjp: the Pallas dQ and dK/dV kernels); relative L2."""
    rs = np.random.RandomState(d)
    q, k, v = (rs.randn(bh, s, d).astype(np.float32) for _ in range(3))
    scale = d ** -0.5

    def loss(q, k, v):
        o = jfa.flash_attention_bhsd(q, k, v, scale=scale, block_q=128, block_k=128,
                                     interpret=True)
        return jnp.sum(jnp.sin(o))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    o = tfa.flash_attention_bhsd_plain(tq, tk, tv, scale)
    lse = tfa.attention_lse_plain(tq, tk, scale)
    plain = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, torch.cos(o), scale)

    xs = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    tfa.reset_launch_counts()
    torch.sin(tfa._FlashAttention.apply(*xs, scale, None, 128)).sum().backward()
    assert set(tfa.LAUNCHES.values()) == {0}
    for name, w, p, x in zip("qkv", want, plain, xs):
        assert _rel(p.numpy(), w) <= TOL, f"plain d{name}"
        assert _rel(x.grad.numpy(), w) <= TOL, f"autograd d{name}"


def test_wide_backward_head_dim_limits():
    """The backward takes what the forward takes: multiples of 8 up to 512."""
    assert tfa.KERNEL_MAX_HEAD_DIM == 512
    tfa._check_head_dim(512)
    with pytest.raises(ValueError, match="up to 512"):
        tfa._check_head_dim(520)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa._check_head_dim(44)


def test_vae_attention_gradient_matches_jax():
    """The VAE mid-block attention (tiny preset's width: 32 channels, 8
    groups; 8x8 tokens), weights carried from the port to flax: gradients of
    sum(sin(out)) with respect to the input and every parameter."""
    from eta_inversion_tpu.models.vae import VAEAttention as JaxVAEAttention
    from eta_inversion_tpu_torch.models.vae import VAEAttention
    from tests.torch_port_util import flax_tree

    torch.manual_seed(0)
    mod = VAEAttention(32, groups=8)
    tree = flax_tree(mod)
    x = np.random.RandomState(1).randn(2, 8, 8, 32).astype(np.float32)

    def loss(params, x):
        return jnp.sum(jnp.sin(JaxVAEAttention(groups=8).apply({"params": params}, x)))

    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    gp, gx = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))

    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    torch.sin(mod(xt)).sum().backward()
    assert _rel(xt.grad.numpy().transpose(0, 2, 3, 1), gx) <= TOL
    for name in ("to_q", "to_k", "to_v", "to_out"):
        lin = getattr(mod, name)
        assert _rel(lin.weight.grad.numpy().T, gp[name]["kernel"]) <= TOL, name
        if name != "to_k":
            assert _rel(lin.bias.grad.numpy(), gp[name]["bias"]) <= TOL, name
    # a key bias shifts every score of a row alike: the softmax ignores it, so
    # its gradient is zero up to rounding on both sides
    assert np.abs(mod.to_k.bias.grad.numpy()).max() <= 1e-6
    assert np.abs(np.asarray(gp["to_k"]["bias"])).max() <= 1e-6
    assert _rel(mod.group_norm.weight.grad.numpy(), gp["group_norm"]["scale"]) <= TOL


def test_entry_points_run_on_the_cpu_without_jax():
    """Both microbenchmarks as a user runs them (`python -m ... --device
    cpu` at a small size), in a fresh process that imports nothing of JAX:
    every variant prints a line."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(2)
        from eta_inversion_tpu_torch.microbench import attn_multihead_bench, flash_sweep
        assert flash_sweep.main(["--device", "cpu", "--batch", "1", "--seq", "64"]) == 0
        assert attn_multihead_bench.main(["--device", "cpu", "--batch", "1", "--seq", "64"]) == 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "eta_inversion_tpu"))
        assert not bad, bad
    """)
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env=dict(os.environ, PYTHONPATH=str(root)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if "maxdiff_vs_v0" in ln]
    assert len(lines) == 13 and all("not timed" in ln for ln in lines)
