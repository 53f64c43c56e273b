"""The port's fused GEGLU (K6) and short-K cross-attention (K5) against the
JAX package, on the CPU.

Each opt-in entry point of eta_inversion_tpu_torch computes its kernel's
plain version on a CPU tensor; here that version is held against the JAX
Pallas kernel run in interpret mode (as tests/test_kernels.py runs it), the
K6 dispatch gate against the JAX gate call by call (and the kernel's operand
checks on every call the JAX gate takes), CPU autograd through the
fused entry point against `jax.grad` of the JAX one, and the tiny preset's
FeedForward weights, carried over by `from_jax_params`, through both fused
entry points.  Inputs come from numpy with a seed.  The CUDA kernels run only
on the card: tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eta_inversion_tpu.ops import flash_attention as jfa
from eta_inversion_tpu.ops import geglu as jg
from eta_inversion_tpu_torch.ops import flash_attention as tfa
from eta_inversion_tpu_torch.ops import geglu as tg

# fp32 on both sides: the short-K kernel's plain version and the Pallas
# kernel sum the same products in another order (outputs are O(1))
CROSSK_TOL = 1e-5
# bf16 GEGLU: both sides compute the projection in fp32 from the same bf16
# operands, then round h * gelu(gate) and the output to bf16; a product that
# lands on the other side of a rounding boundary moves an output by at most
# about one bf16 ulp of the largest output, 2^-8 of it (9e-4 of it measured)
GEGLU_RTOL = 2.0 ** -8
# bf16 gradients of sum(sin(out)), relative L2 per gradient: both take the
# vjp of the plain bf16 path, but torch and XLA round the bf16 products and
# row sums in other orders.  Worst is b2's gradient, a column sum of 2048 bf16
# rows of values up to 1: 1.2-1.3% measured (0.2-0.5% for the others)
GRAD_RTOL = 3e-2


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _geglu_args(n, c, inner, seed):
    """x (n, C), W1 (C, 2I), b1, W2 (I, C), b2 as numpy fp32 in the flax
    layout (tests/test_kernels.py's scales)."""
    rs = np.random.RandomState(seed)
    return ((rs.randn(n, c) * 0.5).astype(np.float32),
            (rs.randn(c, 2 * inner) * c ** -0.5).astype(np.float32),
            (rs.randn(2 * inner) * 0.1).astype(np.float32),
            (rs.randn(inner, c) * inner ** -0.5).astype(np.float32),
            (rs.randn(c) * 0.1).astype(np.float32))


def _jax(args, dtype=jnp.bfloat16):
    return [jnp.asarray(a, dtype) for a in args]


def _port(args, dtype=torch.bfloat16):
    """The same operands in nn.Linear's layout: W1 (2I, C), W2 (C, I)."""
    x, w1, b1, w2, b2 = args
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in (x, w1.T, b1, w2.T, b2)]


def _close_bf16(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= GEGLU_RTOL * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# K6: fused GEGLU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead,c,inner", [
    ((2048,), 64, 128),
    ((2, 1024), 64, 128),     # leading batch dims
    ((512,), 40, 1536),       # the 512-row JAX block; C not a multiple of 16
])
def test_fused_plain_matches_pallas_interpret(lead, c, inner):
    n = int(np.prod(lead))
    args = _geglu_args(n, c, inner, seed=n + c)
    args = (args[0].reshape(*lead, c),) + args[1:]
    want = jg.geglu_mlp(*_jax(args), dtype=jnp.bfloat16, interpret=True, force_fused=True)
    tg.reset_launch_counts()
    got = tg.geglu_mlp(*_port(args), force_fused=True)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)
    assert tg.LAUNCHES["geglu_fused"] == 0  # the plain version on a CPU tensor


@pytest.mark.parametrize("case,n,c,inner,dtype,force,fused", [
    ("gated", 2048, 64, 128, "bfloat16", True, True),
    ("fp32", 2048, 64, 128, "float32", True, False),
    ("ragged rows", 96, 64, 128, "bfloat16", True, False),
    ("not forced", 2048, 64, 128, "bfloat16", False, False),
    ("C % 8", 2048, 60, 128, "bfloat16", True, False),
    ("inner % 128", 2048, 64, 192, "bfloat16", True, False),
    ("512-row block", 512, 64, 1536, "bfloat16", True, True),
    ("256-row block", 256, 64, 2688, "bfloat16", True, True),
    ("256 rows, 512-row block", 256, 64, 1536, "bfloat16", True, False),
])
def test_fused_gate_matches_jax(case, n, c, inner, dtype, force, fused, monkeypatch):
    """The same calls take the fused function in both packages; the others
    take the plain path, bit for bit the port's geglu_mlp_xla."""
    args = _geglu_args(n, c, inner, seed=7)
    took = {"jax": 0, "port": 0}
    jfused, tfused = jg._fused, tg.geglu_mlp_fused

    def jrec(*a):
        took["jax"] += 1
        return jfused(*a)

    def trec(*a):
        took["port"] += 1
        return tfused(*a)

    monkeypatch.setattr(jg, "_fused", jrec)
    monkeypatch.setattr(tg, "geglu_mlp_fused", trec)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jg.geglu_mlp(*_jax(args, jdt), dtype=jdt, interpret=True, force_fused=force)
    got = tg.geglu_mlp(*_port(args, tdt), force_fused=force)
    assert took == {"jax": int(fused), "port": int(fused)}, case
    if not fused:
        assert torch.equal(got, tg.geglu_mlp_xla(*_port(args, tdt)))


@pytest.mark.parametrize("n,c,inner", [
    (2048, 320, 1280), (512, 640, 2560), (256, 1280, 5120),  # the sd15 levels
    (2048, 72, 128),     # C not a multiple of 16
    (2048, 8, 128),      # the narrowest C the gate takes
    (2048, 1288, 128),   # C above 1280
    (512, 2048, 2560),   # wider than any sd preset
])
def test_kernel_takes_every_call_the_jax_gate_takes(n, c, inner, monkeypatch):
    """Each (n, C, I) the JAX gate sends to its fused kernel reaches the
    port's K6 wrapper, and the kernel-side operand checks accept what the
    wrapper would pass the CUDA kernel: no upper bound on C, as in JAX."""
    took = {"jax": 0, "port": 0}

    def jrec(x, w1, b1, w2, b2, interpret):
        took["jax"] += 1
        return jnp.zeros(x.shape, x.dtype)

    def trec(*a):
        took["port"] += 1
        tg.check_kernel_operands(*a)
        return torch.zeros_like(a[0])

    monkeypatch.setattr(jg, "_fused", jrec)
    monkeypatch.setattr(tg, "geglu_mlp_fused", trec)
    shapes = ((n, c), (c, 2 * inner), (2 * inner,), (inner, c), (c,))
    jg.geglu_mlp(*(jnp.zeros(sh, jnp.bfloat16) for sh in shapes), dtype=jnp.bfloat16,
                 interpret=True, force_fused=True)
    x, w1, b1, w2, b2 = (torch.zeros(sh, dtype=torch.bfloat16) for sh in shapes)
    tg.geglu_mlp(x, w1.t(), b1, w2.t(), b2, force_fused=True)
    assert took == {"jax": 1, "port": 1}


def test_fused_autograd_matches_jax_grad():
    """d sum(sin(out)) / d(x, W1, b1, W2, b2) through the fused entry points:
    the JAX custom_vjp and the port's autograd.Function both differentiate
    the plain bf16 path."""
    args = _geglu_args(2048, 64, 128, seed=11)

    def loss(*a):
        out = jg.geglu_mlp(*a, dtype=jnp.bfloat16, interpret=True, force_fused=True)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*_jax(args))
    xs = [t.requires_grad_(True) for t in _port(args)]
    torch.sin(tg.geglu_mlp(*xs, force_fused=True).float()).sum().backward()
    for name, w, t in zip(("x", "w1", "b1", "w2", "b2"), want, xs):
        g = t.grad.float().numpy()
        if name in ("w1", "w2"):  # nn.Linear's layout back to the flax one
            g = g.T
        w = np.asarray(w, np.float32)
        assert t.grad.dtype == torch.bfloat16
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, (name, err)


def test_tiny_feedforwards_through_both_fused_entry_points():
    """The slice as a whole: every FeedForward of the tiny preset, its
    weights carried into the port by from_jax_params, through the port's
    geglu_mlp(force_fused=True) and JAX's on the flax params."""
    from eta_inversion_tpu_torch.models import load_diffusion_model
    from eta_inversion_tpu_torch.models.attention import FeedForward
    from tests.torch_port_util import flax_tree

    port, _ = load_diffusion_model("tiny", seed=3, device="cpu")
    tree = flax_tree(port.nets)
    port.load_jax_params(tree)  # the bridge under test
    ffs = [(name, m) for name, m in port.unet.named_modules() if isinstance(m, FeedForward)]
    assert len(ffs) == 4
    for i, (name, ff) in enumerate(ffs):
        node = tree["unet"]
        for part in name.split("."):
            node = node[part]
        c = ff.proj_out.out_features
        x = np.random.RandomState(i).randn(2, 1024, c).astype(np.float32)
        proj, out = node["geglu_proj"], node["proj_out"]
        want = jg.geglu_mlp(jnp.asarray(x), proj["kernel"], proj["bias"], out["kernel"], out["bias"],
                            dtype=jnp.bfloat16, interpret=True, force_fused=True)
        got = tg.geglu_mlp(torch.from_numpy(x).bfloat16(), ff.geglu_proj.weight,
                           ff.geglu_proj.bias, ff.proj_out.weight, ff.proj_out.bias,
                           force_fused=True)
        _close_bf16(got, want)


# ---------------------------------------------------------------------------
# K5: short-K cross-attention (and its prototype S2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sk,d,sq", [
    (sk, d, 256) for sk in (13, 77, 128, 200) for d in (8, 40, 160)  # 200 keys pad to 256
] + [
    (200, 8, 100), (200, 160, 100), (77, 40, 65),  # ragged Sq: a partial 64-row tile
])
def test_crossk_plain_matches_pallas_interpret(sk, d, sq):
    """K5's plain version (the function the card kernel is held to) against
    the Pallas kernel in interpret mode on the same seeded numpy inputs, fp32
    (no bf16 rounding on either side), within CROSSK_TOL: the kernel's key
    padding (to 128 in JAX, 256 above it) and its masking, head dims 8-160.
    The JAX grid needs block_q to divide Sq, so a ragged Sq is one block."""
    rs = np.random.RandomState(sk + d + sq)
    q = rs.randn(2, sq, d).astype(np.float32)
    k, v = (rs.randn(2, sk, d).astype(np.float32) for _ in range(2))
    scale = d ** -0.5
    block_q = min(sq, 128) if sq % 128 == 0 else sq
    want = jfa.crossk_attention_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sk=sk,
                                     scale=scale, block_q=block_q, interpret=True)
    tfa.reset_launch_counts()
    got = tfa.crossk_attention_bhsd(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), sk, scale, block_q=block_q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=CROSSK_TOL, atol=CROSSK_TOL)
    assert tfa.LAUNCHES["crossk_attention"] == 0


def test_crossk_reads_the_first_sk_rows_of_padded_kv():
    """S2's call: K/V already padded to 128 rows (with junk past sk, which a
    read past sk would show) give the unpadded result."""
    rs = np.random.RandomState(5)
    q = torch.from_numpy(rs.randn(3, 64, 40).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(3, 128, 40).astype(np.float32)) for _ in range(2))
    got = tfa.crossk_attention_bhsd(q, k, v, 77, 40 ** -0.5)
    want = tfa.crossk_attention_bhsd(q, k[:, :77], v[:, :77], 77, 40 ** -0.5)
    assert torch.equal(got, want)


# TF32's 10-bit mantissa: P and V rounded to nearest lose up to 2^-11 of each
# value, so a weighted average of V rows moves by at most about 2^-10 of the
# largest |v|; 2e-3 of the largest output leaves room for that, and a wrong
# key order or a dropped chunk is O(1)
CROSSK_TF32_RTOL = 2e-3


@pytest.mark.parametrize("bh,sq,d,sk", [(2, 256, 40, 77), (2, 256, 168, 77), (2, 256, 40, 300)])
def test_crossk_fp32_plain_matches_pallas_interpret(bh, sq, d, sk):
    """The inputs the card kernel used to refuse, fp32 and a head dim above
    160 and more than 256 keys: the plain version (what a CPU tensor
    computes) against the Pallas kernel in interpret mode within CROSSK_TOL,
    and the TF32 mode's yardstick (P and V rounded to TF32) within
    CROSSK_TF32_RTOL of it."""
    rs = np.random.RandomState(bh + sq + d + sk)
    q = rs.randn(bh, sq, d).astype(np.float32)
    k, v = (rs.randn(bh, sk, d).astype(np.float32) for _ in range(2))
    scale = d ** -0.5
    want = np.asarray(jfa.crossk_attention_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                sk=sk, scale=scale, block_q=sq, interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tfa.crossk_attention_bhsd(tq, tk, tv, sk, scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=CROSSK_TOL, atol=CROSSK_TOL)
    tf32 = tfa.crossk_attention_plain(tq, tk, tv, sk, scale, tf32=True).numpy()
    assert np.abs(tf32 - want).max() <= CROSSK_TF32_RTOL * np.abs(want).max()
    assert not np.array_equal(tf32, want)  # the roundings are there


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 36, 40, 80, 160, 168, 200, 512])
@pytest.mark.parametrize("sk", [1, 77, 256, 257, 1000])
def test_crossk_operands_reach_a_kernel_route(dtype, d, sk):
    """Every (dtype, head dim, sk) the JAX entry takes reaches a kernel route
    on the card, read from shapes alone: K5's bf16 or TF32 mode up to head
    dim 160, the forward kernels above it; the operands as TMA takes them
    (head dim a multiple of 8, last dim contiguous, 16-byte aligned rows),
    K / V cut to sk rows, and the padding changes nothing the plain version
    computes."""
    rs = np.random.RandomState(d + sk)
    q = torch.from_numpy(rs.randn(2, 70, d).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rs.randn(2, sk + 3, d).astype(np.float32)).to(dtype)
            for _ in range(2))
    route, qk, kk, vk = tfa.crossk_kernel_operands(q, k, v, sk, 0.3)
    if d > tfa.CROSSK_MAX_HEAD_DIM:
        assert route == tfa.fwd_library(d, dtype=dtype)
    else:
        assert route == (tfa.CROSSK_TF32 if dtype == torch.float32 else tfa.CROSSK_LIB)
    dp = -(-d // 8) * 8
    for x, rows in ((qk, 70), (kk, sk), (vk, sk)):
        assert x.shape == (2, rows, dp) and x.dtype == dtype and x.stride(-1) == 1
        assert all(s * x.element_size() % 16 == 0 for s in x.stride()[:-1])
    got = tfa.crossk_attention_plain(qk, kk, vk, sk, 0.3)[..., :d]
    assert torch.equal(got, tfa.crossk_attention_plain(q, k, v, sk, 0.3))


def test_crossk_operands_refuse_what_no_route_takes():
    """No route takes a head dim above 512 (ROADMAP Queue 3), no key, sk
    above k's rows, a scale that is not finite, another dtype."""
    q = torch.zeros(2, 64, 520)
    with pytest.raises(ValueError, match="up to 512"):
        tfa.crossk_kernel_operands(q, q, q, 64, 0.1)
    q = torch.zeros(2, 64, 40)
    with pytest.raises(ValueError, match="at least one key"):
        tfa.crossk_kernel_operands(q, q, q, 0, 0.1)
    with pytest.raises(ValueError, match="rows of k"):
        tfa.crossk_kernel_operands(q, q, q, 65, 0.1)
    with pytest.raises(ValueError, match="does not take"):
        tfa.crossk_kernel_operands(q, q, q, 64, float("nan"))
    with pytest.raises(ValueError, match="float16"):
        tfa.crossk_kernel_operands(q.half(), q.half(), q.half(), 64, 0.1)
