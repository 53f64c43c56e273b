"""Sweep of K3's flash-attention kernel variants at the SD backward-step
shape (B=32, H=8, S=4096, D=40), the counterpart of scripts/flash_sweep.py
(S1, the Pallas `flash` prototype of K3).

    python -m eta_inversion_tpu_torch.microbench.flash_sweep
    python -m eta_inversion_tpu_torch.microbench.flash_sweep --device cpu \\
        --batch 1 --seq 256

Times end to end from the packed (B, S, H*D) projection layout, the split /
merge transposes and the zero-padding of D to 128 in device memory included,
as the prototype does.  Its variants cross three choices: D native or padded
to 128; the matmul operands bf16 (K3's kernel) or fp32 (mm_bf16=False, on the
card the TF32 tensor cores); and the TPU block sizes, which are VMEM tiles
with no meaning on the card.  `card_tile` maps them onto the card's tile:
block_q 512 / 256 -> 4 / 2 warps of 16 query rows, block_k 1024 / 2048 -> 64
/ 128 keys per shared-memory tile.
"""

from __future__ import annotations

import sys

import torch.nn.functional as F

from . import D, make_input, merge, parse_args, run_variants, split
from ..ops import flash_attention as fa


def card_tile(block_q: int, block_k: int):
    """(warps, keys per tile) of the card for a TPU (block_q, block_k)."""
    return {512: 4, 256: 2}[block_q], {1024: 64, 2048: 128}[block_k]


def variants() -> dict:
    """The prototype's 8 variants, each x (B, S, H*D) -> (B, S, H*D)."""
    scale = D ** -0.5

    def v_current(x, block_q=512, block_k=1024, mm_bf16=False, dpad=128):
        q, k, v = split(x), split(x * 0.5), split(x * 0.25)
        if dpad:
            q, k, v = (F.pad(t, (0, dpad - D)) for t in (q, k, v))
        o = fa.flash_attention_bhsd_tiled(q, k, v, scale,
                                          operands="bf16" if mm_bf16 else "fp32",
                                          tile=card_tile(block_q, block_k))
        if dpad:
            o = o[..., :D]
        return merge(o, x.shape[0])

    return {
        "v0_current_pad128": lambda x: v_current(x),
        "v1_pad128_mmbf16": lambda x: v_current(x, mm_bf16=True),
        "v2_pad128_bk2048": lambda x: v_current(x, block_k=2048),
        "v3_dnative": lambda x: v_current(x, dpad=None),
        "v4_dnative_bk2048": lambda x: v_current(x, block_k=2048, dpad=None),
        "v5_dnative_mmbf16_bk2048":
            lambda x: v_current(x, block_k=2048, mm_bf16=True, dpad=None),
        "v6_dnative_mmbf16": lambda x: v_current(x, mm_bf16=True, dpad=None),
        "v7_dnative_mmbf16_bq256":
            lambda x: v_current(x, block_q=256, mm_bf16=True, dpad=None),
    }


def call(fn, x):
    """One variant's call on the bench's input x: attention(x, x/2, x/4)."""
    return fn(x)


def run(b, s, device="cuda", log=print):
    return run_variants(variants(), make_input(b, s, device), call, log)


def main(argv=None) -> int:
    a = parse_args(argv, __doc__.splitlines()[0])
    run(a.batch, a.seq, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
