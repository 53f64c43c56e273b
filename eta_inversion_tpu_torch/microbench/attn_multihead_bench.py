"""The multi-head kernel on the packed (B, S, H*D) projection layout (S4)
against the per-head flat kernel behind its split / merge transposes (S3),
at the SD backward-step shape (B=32, H=8, S=4096, D=40): the counterpart of
scripts/attn_multihead_bench.py.

    python -m eta_inversion_tpu_torch.microbench.attn_multihead_bench
    python -m eta_inversion_tpu_torch.microbench.attn_multihead_bench \\
        --device cpu --batch 1 --seq 256

v0_production_e2e is the prototype's production path: split q, k, v to
(B*H, S, D), K3's function with fp32 operands (S3, `prod_flash`), merge; the
copies are inside the timed window.  The v8 variants run S4
(`v8_multihead`), one block per (batch, query block) walking all heads.
Both sides contract fp32 operands, as the prototype's two kernels do: on the
card the TF32 tensor cores (S3 on the narrow kernel's TF32 mode, S4 on its
all-heads block in the same mode; each sizes its own tiles).  `card_tile`
maps S4's TPU block sizes onto the all-heads block's one tile, 128 query
rows a block and 128 keys a staged tile (fa.MULTIHEAD_TILE): the four v8
variants run the same kernel.
"""

from __future__ import annotations

import sys

from . import D, H, make_input, merge, parse_args, run_variants, split
from ..ops import flash_attention as fa

def card_tile(block_q: int, block_k: int):
    """The card tile (query rows a block, keys a staged tile) for a TPU
    (block_q, block_k) of the prototype: the all-heads block's one tile for
    each of its pairs."""
    if block_q not in (512, 256) or block_k not in (1024, 2048, 4096):
        raise KeyError((block_q, block_k))
    return fa.MULTIHEAD_TILE


def variants() -> dict:
    """The prototype's 5 variants, each (q, k, v) packed -> packed."""
    scale = D ** -0.5

    def v0_production(q, k, v):
        o = fa.flash_attention_bhsd_tiled(split(q), split(k), split(v), scale,
                                          operands="fp32")
        return merge(o, q.shape[0])

    def v8_multihead(q, k, v, block_q=512, block_k=2048):
        return fa.flash_attention_multihead(q, k, v, scale, H, operands="fp32",
                                            tile=card_tile(block_q, block_k))

    return {
        "v0_production_e2e": v0_production,
        "v8_mh_bq512_bk2048": v8_multihead,
        "v8_mh_bq256_bk2048": lambda q, k, v: v8_multihead(q, k, v, block_q=256),
        "v8_mh_bq512_bk1024": lambda q, k, v: v8_multihead(q, k, v, block_k=1024),
        "v8_mh_bq512_bk4096": lambda q, k, v: v8_multihead(q, k, v, block_k=4096),
    }


def call(fn, x):
    """One variant's call on the bench's input x: attention(x, x/2, x/4)."""
    return fn(x, x * 0.5, x * 0.25)


def run(b, s, device="cuda", log=print):
    return run_variants(variants(), make_input(b, s, device), call, log)


def main(argv=None) -> int:
    a = parse_args(argv, __doc__.splitlines()[0])
    run(a.batch, a.seq, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
