"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py                 # all phases, sd15 at 50 steps
    python3 chip_smoke.py --steps 20      # shorter edits
    python3 chip_smoke.py --phases device,build,kernels,fused

Phases, in order; any failure exits non-zero before the last line:

1. device   -- the card's name, and its name and power limit from nvidia-smi.
2. build    -- compile the CUDA kernels from csrc/ with nvcc, one process per
               source, all started together (timed), and load them; print
               each library's nvcc seconds and ptxas register / spill lines,
               and the count of warpgroup MMA (HGMMA) instructions in the
               SASS of the wgmma kernels, the narrow forward
               (flash_attention_narrow.cu, K1 and K2 at head dims up to 128,
               S1), the narrow backward (flash_attention_bwd_narrow.cu, K4a
               and K4b up to 128), the wide forward (flash_attention_wide.cu,
               K3 at d = 512), the bf16 backward above 128
               (flash_attention_bwd.cu, K4a and K4b at d = 512), the fp32
               kernels above 128 (flash_attention_bwd_tf32.cu), the short-K
               cross-attention (crossk_attention.cu, K5 and S2) and the fused GEGLU
               (geglu.cu, K6), which must not be 0.
3. kernels  -- each kernel against its plain PyTorch version on the card, on
               the same seeded bf16 inputs, at the main path's shapes; max abs
               error against a bound of 2% of the plain output's (or
               gradient's) largest magnitude, the forward kernels' LSE against
               the plain logsumexp, CUDA-event times of both (the timed calls
               queued behind a sleep kernel, so that the device's time, not
               the host's launch rate, is read), the time of one
               library call on the same inputs with the kernel it ran
               (F.scaled_dot_product_attention, forward or its backward alone,
               for the attention kernels; F.linear, F.gelu, the multiply and
               F.linear for the fused GEGLU), and each kernel's bound (the
               least time the card could take).  The narrow kernel's TF32
               mode on fp32 operands at K1's and K2's shapes, with its LSE
               and SDPA on the same fp32 inputs (on average closer to the
               fp32 result than the bf16 kernel on the inputs rounded to
               bf16), and its prep kernel (V transposed, bf16 q / k widened)
               bit for bit against its plain version.  K5 (wgmma with TMA
               loads and stores) at the UNet's three cross-attention shapes
               and S2, its Pallas prototype, at the prototype's, each with
               two launches that must give the same bits; S1 and S3, the
               prototypes of K3, are the narrow kernel with its one tile
               (bf16 operands, two launches bitwise equal) or its TF32 mode
               (fp32 products; the prep kernel timed apart), S4 the narrow
               kernel's all-heads block with the prototype's TF32 operands
               (its bf16 mode and K1's route timed beside it), all at the
               prototypes' (B, H, S, D) = (32, 8, 4096, 40), held against the
               plain version computed a chunk of heads at a time; K5 on the
               inputs past its one-pass bf16 mode: fp32 operands (its TF32 mode after
               the backward's prep kernel writes V^T) at the UNet's shapes,
               300 keys (128-key chunks with an online softmax) and head dim
               168 (the wide forward kernel with the key mask) and, since
               its repair, above 512 (640 and 1024, bf16 and fp32: the fp32
               forward's kernels, which stream d, bf16 operands widened to
               fp32 around them); K1-K3 also
               at the shapes a bucket-8 edit runs (plain versions computed a
               chunk of rows at a time), and at the families phase's: d = 64
               with 5, 10 and 20 heads at S = 1024-9216 (K1, K2), the VAE at
               S = 9216 and 16384 (K3), sdxl nti's K4a / K4b; the TF32
               rows must also be closer on average to the fp32 result than
               the bf16 mode.  K4a / K4b at nti's shapes (the
               wgmma kernels) and at d = 512 (flash_attention_bwd.cu: bf16
               scores materialized and bf16 GEMMs, wgmma + TMA); beside
               each K4 row the pair K4a + K4b, the function of SDPA's whole
               backward, timed in turns with it (at d = 512 SDPA's math
               backend, which also materializes the scores, timed after
               them, in brackets), and two launches of the pair that must
               give the same bits.  The fp32 kernels: K3 at the
               VAE's d = 512 with its LSE (flash_attention_bwd_tf32.cu: Vᵀ
               from the backward's prep kernel, the scores kernel's forward
               mode, the TF32 GEMM that forms P; two calls must give the
               same bits); K4a / K4b at nti's shapes on the narrow backward's TF32
               mode and at d = 512 on flash_attention_bwd_tf32.cu (scores and
               TF32 GEMMs), the pair beside SDPA and bitwise repeated as in
               bf16; their prep kernel (K, Q, dO transposed, D) against its
               plain version; each on fp32 inputs.  On fp32
               rows the library call is SDPA at the kernels' precision (its
               math backend with TF32 matmuls allowed); SDPA's default fp32
               call (the memory-efficient kernel) is timed beside it, with
               both calls' mean error against the fp32 plain result.  Then one gradient through the
               full-width sd15 VAE mid-block attention (512 px: S = 4096, d =
               512) against the plain path's, in bf16 and in fp32 (the fp32
               one, forward and backward, on flash_attention_bwd_tf32.cu).
4. fused    -- the opt-in entry points of K5 and K6 (the JAX package keeps
               both off its served paths) on one full-width sd15 UNet call
               (random weights from a seed, bf16, the ptp backward's 4 rows):
               the input of each of the 16 FeedForwards and the q/k/v of each
               of the 16 cross-attentions are captured, run through
               geglu_mlp(force_fused=True) and crossk_attention_bhsd, and held
               against the module's own plain result; the summed time of the
               16 calls against the plain path's; one gradient through K6's
               autograd.Function at the 64x64 shape against the plain path's.
5. microbench -- both attention microbenchmarks
               (eta_inversion_tpu_torch.microbench: flash_sweep, 8 variants;
               attn_multihead_bench, 5) at full width.  One call of each
               variant on a unit-scale input must be within 2% of the plain
               version's largest output (every tile and operand mode the
               benches launch); then, counted, the benches as a user runs
               them: every variant must run and end within 2% of its first
               variant's largest output.
6. serving  -- the sd15 etainv+ptp edit server (random weights from a seed)
               answers three 512x512 edits: two submitted concurrently and one
               HTTP POST /v1/edit on 127.0.0.1.  Each result must be a finite
               512x512x3 image, and the launch counts of the forward kernels
               (K1-K3) must have grown during the edits.  Tiny-preset edits on
               the card are also held against the same edits on the CPU:
               etainv+ptp, and etainv with masactrl (substitute, mask_auto),
               pnp and invedit, pix2pix_zero over diffinv and edict, edict+ptp
               and regdiffinv+ptp.
   batched  -- pair-batched serving: an sd15 etainv+ptp server built with
               --max_batch 8 (buckets 1/2/4/8) takes 8 concurrent requests in
               one bucket-8 dispatch (editing/batched.edit_batch; the bucket's
               shapes warmed first by a 2-step edit_batch outside the
               server), then 3 requests padded to bucket 4, then two of the 8
               pairs again as bucket-1 edits (editor.edit); the dispatch stats
               must say so, every image must be a finite 512x512x3, the
               forward kernels must have run.  Prints s/edit and peak device
               memory of each bucket, the bucket-1 edits' relative L2 from
               their batched results (not asserted: other candidate-noise
               draws, a bf16 argmin) and from their reconstructions.  Then
               one sd15 UNet call at 2B = 8 rows with the CFG shared prefix
               against the tiled latent: relative L2 within PREFIX_RTOL,
               device ms of both, exactly one K1 launch at B rows.
   fp32     -- fp32, the reference's default dtype, on the card (TF32 off for
               the matmuls and on for cuDNN's convolutions, PyTorch's
               defaults, printed; the attention kernels' products are TF32
               whatever these say): one gradient through fp32 self-attention
               (the TF32 mode forward, K4a / K4b on the narrow backward's
               TF32 mode after its prep) and one full-width sd15 fp32 UNet
               call (4 rows) against the
               plain attention path, as relative L2 errors; then one sd15
               fp32 etainv+ptp 512x512 edit served, which must be finite
               512x512x3, with its s/edit and the launches by route: K1 / K2
               on the TF32 mode and its prep kernel, the VAE's d = 512
               attention on flash_attention_bwd_tf32.cu; then one sd15 fp32
               nti+ptp edit served (FP32_NTI_STEPS steps), whose backward
               must run on the narrow backward's TF32 mode, one prep launch
               a pair.
7. nti      -- the sd15 nti+ptp edit server answers one 512x512 edit (null-
               text inversion: Adam on the null embedding through UNet
               gradients, 10 inner steps per step, --nti_steps 25 steps by
               default, half the inverter's 50, to fit the time limit); the result must be finite
               512x512x3 and every flash kernel's launch count, the backward's
               (K4a, K4b) included, must have grown.  Then one nti inner
               gradient at full width (UNet forward + backward with respect to
               the embedding) through the kernels is held against the same
               gradient on the plain attention path, and a gradient with the
               self-attention share dropped must miss the same bound.  One
               more inner gradient is profiled (torch.profiler): the device's
               busy share of its wall time, K4a's and K4b's share of device
               time, and the backward's launches by kernel instance.
   editors  -- the other editors and inverters at sd15 width (bf16, random
               weights from seed 0, one model in this process, each path
               once through load_inverter / load_editor / editor.edit, at
               --steps, the edict and pix2pix_zero paths at most at
               EDITOR_CUT_STEPS):
               masactrl substitute + etainv (K1, K2, K3 on the narrow kernel
               at the hooked 64x64 layers, K3 in the VAE), masactrl
               mask_auto + etainv (K1, K3), pnp + etainv (K1, K2, K3 narrow
               and VAE), invedit + etainv (K1, K3: no hooks), pix2pix_zero +
               diffinv and + edict (K1, K3, K4a, K4b: the guidance gradient
               runs back through the self-attention kernels), edict + ptp,
               regdiffinv + ptp (K1, K2, K3); then one bucket-2 edit_batch
               of pnp + etainv.  Each prints s/edit, peak device memory and
               its launches, must give finite 512x512x3 images and launch
               its kernels and not K5, K6, the microbenchmarks' or the fp32
               kernels; edict + ptp prints its reconstruction's relative L2
               from the encoded image.  Then the pix2pix_zero guidance
               gradient at full width (with respect to the latent) through
               the kernels: with the target latent apart from the source,
               against the plain attention path within GRAD_RTOL; with it
               near the source, against the model widened to exact fp32, no
               farther than P2P_WITNESS_RATIO times the plain path
               (scripts/torch_editors_precision.py prints the readings
               behind both, and EDICT's precision).
   families -- the other model families at full published width and
               depth (bf16, random weights from seed 0, one model at a
               time, freed before the next): an etainv+ptp edit through
               load_inverter / load_editor / editor.edit on sd21 (512 px,
               50 steps), sd21v (768 px, v-prediction, 20 steps) and sdxl
               (1024 px, depth 1/2/10, two text towers, text_time
               conditioning, 20 steps); each must give finite images of its
               size and exactly the launches its layer counts predict
               (K1 for the self layers above 32x32 and the forward loop's,
               K2 for ptp's 32x32 q/k substitution, K3 the VAE's encode
               and decode at S = 4096 / 9216 / 16384, d = 512); prints
               s/edit, peak device memory and the build; each model's text
               towers in bf16 against the same weights in fp32
               (TEXT_BF16_RTOL).  On sdxl a short nti + ptp edit (FAMILY_NTI)
               whose null embeddings keep the packed context row 77 exactly,
               and the inner gradient check of the nti phase at 1024 px
               (kernels vs plain within GRAD_RTOL).  Then tiny21, tinyv and
               tinyxl card vs CPU (etainv+ptp, diffinv+simple, nti+ptp), and
               one `python -m eta_inversion_tpu_torch.edit_image --model
               sdxl` process (FAMILY_CLI_STEPS steps, a 1024x1024 PNG).
8. checkpoint -- the sd15 random init (fp32, seed 0) written as a
               diffusers-layout checkpoint directory (about 4.3 GB of
               safetensors, under build/, removed after the cli phase) with
               the port's writer and inverse key maps, loaded back in bf16
               through load_diffusion_model(weights_dir=...): one UNet call
               and one VAE decode must give the in-memory model's bits; the
               write and load times and the host's RSS during the load.
9. cli      -- the port's entry points as a user runs them, one process
               each, on that checkpoint, bf16, a generated 512x512 PNG, at
               --steps: edit_image etainv+ptp (the main path through its
               user entry point), etainv+pnp, dirinv+ptp, ddpminv+ptp, cyclediff+simple,
               proxnpi+ptp, diffinv+ptp with {"scheduler": "dpm",
               "solver_order": 3} and with {"scheduler": "ddpm"}, and
               invert_image diffinv.  Each must write a 512x512x3 PNG and
               report K1 and K3 launches, K2's too under ptp and pnp (their
               hooks send the 32x32 self-attention to the flat kernel), and no
               opt-in or fp32 kernel's; each run's s/edit beside the card's name and
               power limit.

Each phase sets the launch counts to 0 before it drives its path and checks
them after: the kernels of its path must have been launched, and K5, K6 and
the microbenchmarks' kernels not at all on the served paths (6, batched,
fp32, 7, editors, families, 9),
nor the fp32 kernels on the bf16 ones.  The
line before the last is {"kernels": [...]}; the last line is {"ok": true,
"device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from eta_inversion_tpu_torch.ops import flash_attention as fa  # noqa: E402
from eta_inversion_tpu_torch.ops import geglu as gg  # noqa: E402

# The bound scales with the reference: with randn q/k/v the outputs are
# averages over S keys, of size about sqrt(e/S) (max |out| 0.13-0.4 at the
# shapes below), not O(1).  Both sides round the output to bf16 and the kernel
# also rounds the probabilities to bf16 before the PV product (as the TPU
# kernels do): that costs at most about one bf16 ulp of the largest output,
# 0.25-0.65% of max |out| in a CPU simulation at these shapes.  2% of max |out|
# leaves room for that, and a 3% error in the softmax normalisation misses it.
KERNEL_RTOL = 2e-2
# tiny-preset fp32 edit, card vs CPU: different summation orders over 2x10
# UNet calls, same bar as the port's JAX comparison
TINY_TOL = 1e-3
# the forward's LSE: a log of a row sum accumulated in fp32 from exact bf16
# products, against fp32 einsums: agreement to fp32 rounding; 1e-3 is a 0.1%
# error of the row sum
LSE_TOL = 1e-3
# the TF32 mode's LSE: Q and K reach the tensor cores truncated to TF32's 10
# mantissa bits, which shrinks each score by about 2^-10 of itself; at
# unit-variance scores the row logsumexp moves by about 1e-3.  1e-2 is a 1%
# error of the row sum
LSE_TF32_TOL = 1e-2
# fp32 on the card, kernels vs the plain attention path, relative L2: the
# TF32 mode rounds P and V to 10 mantissa bits and truncates Q and K
# (about 1e-3 of each self-attention output), compounded over the UNet's 16
# self-attention layers; a wrong key order or a dropped head is O(1)
FP32_RTOL = 1e-2
# nti inner gradient at full width, kernels vs the plain attention path, as
# a relative L2 error.  Both run the bf16 UNet; they differ where the kernels
# round P and dS to bf16 before their products (about 0.3% of the largest
# per-layer gradient on randn inputs, phase 3) and in the plain path's own
# bf16 autograd, compounded over the 9 self-attention layers the gradient
# crosses and the bf16 network around them.  10% leaves room for that; a
# gradient whose self-attention share is dropped (what autograd got before
# the backward kernels) is computed in the same run and must exceed it.
GRAD_RTOL = 0.1
# pix2pix_zero's guidance gradient with the target latent near the source's
# (where an edit starts): the map differences are a few bf16 roundings of
# the maps, so the kernels' and the plain path's bf16 gradients differ by
# about as much as the self-attention share and GRAD_RTOL cannot tell them
# apart.  There both are held against the gradient of the model widened to
# fp32 with exact attention: the kernels' distance from it may exceed the
# plain path's by at most this factor.  On the H100 the two were 5.364e-2
# and 5.365e-2 from it and the gradient with the self-attention share
# dropped 8.24e-2, 1.535x the plain path's: 1.25 lies between
# (scripts/torch_editors_precision.py prints these readings)
P2P_WITNESS_RATIO = 1.25

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): bf16 tensor
# cores, HBM3; and the exponential unit (MUFU): 16 ex2 results per SM per
# clock (CUDA C++ programming guide, arithmetic instruction throughput for
# compute capability 9.0) x 132 SMs x 1.98 GHz boost clock
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9
# fp32 outside the tensor cores (an FMA counts 2), for K6's gate: per gated
# element the scale, clamp (2), z^2, 8 FMAs of the erf polynomial, z * p,
# 1 + erf, 0.5 * x, the product, the two bias adds and h * gelu: 27 flops
PEAK_FP32_FLOPS = 67e12
GELU_FLOPS = 27

KERNELS = [
    # name, TPU kernel replaced, wrapper counter (less the "exclude" counter's
    # launches: K4a / K4b's wrappers count both kernels of each, and the
    # _wide counters those on flash_attention_bwd.cu), shapes (main-path
    # shape first); K4a / K4b take the packed layout of nti's gradient path
    # K1 and K2 (head dims up to 128) run on the narrow wgmma kernel
    # (their wrappers' launches in the fp32 phase are the TF32 mode's: that
    # phase checks it, and these rows do not count it)
    {"name": "K1 flash_attention_packed",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:337 (_packed_fwd_impl -> "
                 "_flash_packed_kernel :295)",
     "counter": "flash_attention_packed", "source": "flash_attention_narrow.cu",
     "skip_phases": ("fp32", "vae_grad_fp32"),
     # then the bucket-8 shapes (batched phase): the backward's 64x64 layers
     # at 4B = 32 rows, the shared prefix's first one at 2B, the forward at B
     "shapes": [("packed", 4, 4096, 8, 40), ("packed", 2, 1024, 8, 80),
                ("packed", 32, 4096, 8, 40), ("packed", 16, 4096, 8, 40),
                ("packed", 8, 4096, 8, 40), ("packed", 8, 1024, 8, 80),
                # pnp's 3-row UNet call (editors phase)
                ("packed", 3, 4096, 8, 40),
                # the families phase at d = 64: sd21's 64x64 backward (4 rows, 5
                # heads) and 32x32 forward (1 row, 10), sd21v's 96x96 and 48x48
                # backward, sdxl's 64x64 backward (10 heads) and 32x32 forward (20)
                ("packed", 4, 4096, 5, 64), ("packed", 1, 1024, 10, 64),
                ("packed", 4, 9216, 5, 64), ("packed", 4, 2304, 10, 64),
                ("packed", 4, 4096, 10, 64), ("packed", 1, 1024, 20, 64)]},
    {"name": "K2 flash_attention_bhsd (one pass)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:97 (_flash_fwd_impl, "
                 "block_k == S -> _flash_onepass_kernel :41)",
     "counter": "flash_attention_bhsd_onepass", "source": "flash_attention_narrow.cu",
     "skip_phases": ("fp32", "vae_grad_fp32"),
     # then bucket 8, then pnp's 3-row call (editors phase), then ptp's q/k
     # substitution at 32x32 on sd21 (4 rows x 10 heads) and sdxl (x 20)
     "shapes": [("onepass", 32, 1024, 1, 80), ("onepass", 256, 1024, 1, 80),
                ("onepass", 24, 1024, 1, 80), ("onepass", 40, 1024, 1, 64),
                ("onepass", 80, 1024, 1, 64)]},
    # fp32 K1 and K2 on the narrow kernel's TF32 mode, and its prep kernel
    # (prep shapes: K1's fp32 operands, S1's bf16 ones)
    {"name": "K1 / K2 TF32 mode (fp32 operands)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:337 (_packed_fwd_impl -> "
                 "_flash_packed_kernel :295) and :97 (_flash_fwd_impl, block_k == S -> "
                 "_flash_onepass_kernel :41), fp32 operands",
     "counter": "flash_attention_narrow_tf32", "source": "flash_attention_narrow.cu",
     "shapes": [("packed_fp32", 4, 4096, 8, 40), ("packed_fp32", 2, 1024, 8, 80),
                ("onepass_fp32", 32, 1024, 1, 80)]},
    {"name": "TF32 prep (V transposed, bf16 q / k widened)",
     "replaces": "none: the TF32 mode's operands for K1 / K2 "
                 "(eta_inversion_tpu/ops/flash_attention.py:295, :41), which read V as it lies",
     "counter": "flash_attention_tf32_prep", "source": "flash_attention_narrow.cu",
     "shapes": [("prep_fp32", 4, 4096, 8, 40), ("prep_bf16", 256, 4096, 1, 40)]},
    # K3 at the VAE mid-block attention (d = 512): decode's two rows, then
    # encode's one; head dims above 128 run on the wgmma kernel
    {"name": "K3 flash_attention_bhsd (blockwise)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:97 (_flash_fwd_impl, "
                 "block_k < S -> _flash_kernel :62)",
     "counter": "flash_attention_bhsd_blockwise", "source": "flash_attention_wide.cu",
     "exclude": "flash_attention_bhsd_blockwise_narrow",
     "skip_phases": ("fp32", "vae_grad_fp32"),
     # bucket 8: decode's 2B rows, encode's B; the VAE at 768 px (sd21v,
     # S = 9216) and 1024 px (sdxl, S = 16384), decode and encode
     "shapes": [("blockwise", 2, 4096, 1, 512), ("blockwise", 1, 4096, 1, 512),
                ("blockwise", 16, 4096, 1, 512), ("blockwise", 8, 4096, 1, 512),
                ("blockwise", 2, 9216, 1, 512), ("blockwise", 1, 9216, 1, 512),
                ("blockwise", 2, 16384, 1, 512), ("blockwise", 1, 16384, 1, 512)]},
    # K3 up to head dim 128 runs on the narrow kernel: the hooked 64x64
    # self-attention of masactrl (4 rows x 8 heads) and pnp (3 rows) at d = 40
    {"name": "K3 flash_attention_bhsd (blockwise), d <= 128",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:97 (_flash_fwd_impl, "
                 "block_k < S -> _flash_kernel :62)",
     "counter": "flash_attention_bhsd_blockwise_narrow", "source": "flash_attention_narrow.cu",
     "skip_phases": ("fp32", "vae_grad_fp32"),
     "shapes": [("blockwise", 32, 4096, 1, 40), ("blockwise", 24, 4096, 1, 40)]},
    {"name": "K4a flash_attention_bwd_dq",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:218 (_flash_bwd_impl -> "
                 "_flash_dq_kernel :144)",
     "counter": "flash_attention_bwd_dq", "exclude": "flash_attention_bwd_dq_wide",
     "source": "flash_attention_bwd_narrow.cu", "skip_phases": ("fp32", "vae_grad_fp32"),
     # nti's one row, then pix2pix_zero's guidance gradient on [latent; latent],
     # then nti on sdxl (10 heads at 64x64, 20 at 32x32, d = 64)
     "shapes": [("bwd_dq", 1, 4096, 8, 40), ("bwd_dq", 1, 1024, 8, 80),
                ("bwd_dq", 2, 4096, 8, 40), ("bwd_dq", 2, 1024, 8, 80),
                ("bwd_dq", 1, 4096, 10, 64), ("bwd_dq", 1, 1024, 20, 64)]},
    {"name": "K4b flash_attention_bwd_dkv",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:235 (_flash_bwd_impl -> "
                 "_flash_dkv_kernel :170)",
     "counter": "flash_attention_bwd_dkv", "exclude": "flash_attention_bwd_dkv_wide",
     "source": "flash_attention_bwd_narrow.cu", "skip_phases": ("fp32", "vae_grad_fp32"),
     "shapes": [("bwd_dkv", 1, 4096, 8, 40), ("bwd_dkv", 1, 1024, 8, 80),
                ("bwd_dkv", 2, 4096, 8, 40), ("bwd_dkv", 2, 1024, 8, 80),
                ("bwd_dkv", 1, 4096, 10, 64), ("bwd_dkv", 1, 1024, 20, 64)]},
    # K5 / S2 shapes: (kind, BH, Sq, D, sk); K5 at the 64x64, 32x32 and 16x16
    # cross-attentions of a 4-row sd15 UNet call
    {"name": "K5 crossk_attention_bhsd",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:506 (crossk_attention_bhsd -> "
                 "_crossk_kernel :488)",
     "counter": "crossk_attention", "source": "crossk_attention.cu",
     "shapes": [("crossk", 32, 4096, 40, 77), ("crossk", 32, 1024, 80, 77),
                ("crossk", 32, 256, 160, 77)]},
    # K5 past its one-pass bf16 mode: fp32 operands (its TF32 mode, after
    # the fp32 backward's prep kernel writes V^T) at the UNet's shapes, more
    # than 256 keys (128-key chunks, online softmax), a head dim above 160
    # (the wide forward kernel with the key mask)
    {"name": "K5 fp32 (TF32 mode)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:506 (crossk_attention_bhsd -> "
                 "_crossk_kernel :488), fp32 operands",
     "counter": "crossk_attention_tf32", "source": "crossk_attention.cu",
     "shapes": [("crossk_fp32", 32, 4096, 40, 77), ("crossk_fp32", 32, 1024, 80, 77),
                ("crossk_fp32", 32, 256, 160, 77)]},
    {"name": "K5 sk > 256 (128-key chunks)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:506 (crossk_attention_bhsd -> "
                 "_crossk_kernel :488), K / V padded to 384 keys",
     "counter": "crossk_attention_chunked", "source": "crossk_attention.cu",
     "shapes": [("crossk", 32, 4096, 40, 300)]},
    {"name": "K5 d > 160 (wide forward, key mask)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:506 (crossk_attention_bhsd -> "
                 "_crossk_kernel :488), head dim 168",
     "counter": "crossk_attention_wide", "source": "flash_attention_wide.cu",
     "shapes": [("crossk", 32, 256, 168, 77)]},
    # K5 above head dim 512 (refused before its repair): the fp32
    # forward's kernels, which stream d (flash_attention_bwd_tf32.cu: V^T by
    # the backward's prep kernel, the scores kernel's forward mode, the TF32
    # GEMM that forms P), for both dtypes; bf16 q, k, v widened to fp32 and o
    # rounded back to bf16 by torch's dtype casts
    {"name": "K5 d > 512, bf16 (widened; scores + TF32 GEMM)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:506 (crossk_attention_bhsd -> "
                 "_crossk_kernel :488), head dims 640 and 1024",
     "counter": "crossk_attention_wide", "source": "flash_attention_bwd_tf32.cu",
     "shapes": [("crossk", 32, 256, 640, 77), ("crossk", 8, 1024, 1024, 300)]},
    {"name": "K5 d > 512, fp32 (scores + TF32 GEMM)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:506 (crossk_attention_bhsd -> "
                 "_crossk_kernel :488), head dims 640 and 1024, fp32 operands",
     "counter": "crossk_attention_wide", "source": "flash_attention_bwd_tf32.cu",
     "shapes": [("crossk_fp32", 32, 256, 640, 77), ("crossk_fp32", 8, 1024, 1024, 300)]},
    {"name": "S2 cross_shortk (K5's kernel)",
     "replaces": "scripts/attn_microbench3.py:107 (cross_shortk -> kern_crossk :93)",
     "counter": "crossk_attention", "source": "crossk_attention.cu",
     "shapes": [("crossk_padded", 256, 4096, 40, 77), ("crossk_padded", 320, 4096, 40, 77)]},
    # K6 shapes: (kind, n, C, I), the FeedForwards of a 4-row sd15 UNet call
    {"name": "K6 geglu_mlp (fused)",
     "replaces": "eta_inversion_tpu/ops/geglu.py:105 (_fused_fwd_impl -> _geglu_kernel :74)",
     "counter": "geglu_fused", "source": "geglu.cu",
     "shapes": [("geglu", 16384, 320, 1280), ("geglu", 4096, 640, 2560),
                ("geglu", 1024, 1280, 5120)]},
    # the attention microbenchmarks' kernels at the prototypes' (32, 8, 4096,
    # 40): sweep shapes (kind, BH, S, D, D in memory), multi-head (B, S, H, d)
    {"name": "S1 flash, TF32 operands, D native",
     "replaces": "scripts/flash_sweep.py:70 (flash, mm_bf16=False -> kernel :33)",
     "counter": "flash_attention_bhsd_tf32", "source": "flash_attention_narrow.cu",
     "shapes": [("tiled_tf32", 256, 4096, 40, 40)]},
    {"name": "S1 flash, TF32 operands, D padded to 128",
     "replaces": "scripts/flash_sweep.py:70 (flash, mm_bf16=False -> kernel :33)",
     "counter": "flash_attention_bhsd_tf32", "source": "flash_attention_narrow.cu",
     "shapes": [("tiled_tf32", 256, 4096, 40, 128)]},
    {"name": "S1 flash, bf16 operands, D native",
     "replaces": "scripts/flash_sweep.py:70 (flash, mm_bf16=True -> kernel :33)",
     "counter": "flash_attention_bhsd_tiled", "source": "flash_attention_narrow.cu",
     "shapes": [("tiled", 256, 4096, 40, 40)]},
    {"name": "S1 flash, bf16 operands, D padded to 128",
     "replaces": "scripts/flash_sweep.py:70 (flash, mm_bf16=True -> kernel :33)",
     "counter": "flash_attention_bhsd_tiled", "source": "flash_attention_narrow.cu",
     "shapes": [("tiled", 256, 4096, 40, 128)]},
    {"name": "S3 prod_flash (TF32, flat route)",
     "replaces": "scripts/attn_multihead_bench.py:65 (prod_flash -> prod_kernel :40)",
     "counter": "flash_attention_bhsd_tf32", "source": "flash_attention_narrow.cu",
     "shapes": [("prod", 256, 4096, 40, 40)]},
    {"name": "S4 v8_multihead (TF32, all-heads block)",
     "replaces": "scripts/attn_multihead_bench.py:130 (v8_multihead -> mh_kernel :99)",
     "counter": "flash_attention_multihead_tf32", "source": "flash_attention_narrow.cu",
     "shapes": [("multihead", 32, 4096, 8, 40)]},
    # the backward above head dim 128: the VAE mid-block attention at 512
    # and 256 px (one head, flat)
    {"name": "K4a flash_attention_bwd_dq, d=512",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:218 (_flash_bwd_impl -> "
                 "_flash_dq_kernel :144)",
     "counter": "flash_attention_bwd_dq_wide", "source": "flash_attention_bwd.cu",
     "shapes": [("bwd_dq", 1, 4096, 1, 512), ("bwd_dq", 2, 1024, 1, 512)]},
    {"name": "K4b flash_attention_bwd_dkv, d=512",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:235 (_flash_bwd_impl -> "
                 "_flash_dkv_kernel :170)",
     "counter": "flash_attention_bwd_dkv_wide", "source": "flash_attention_bwd.cu",
     "shapes": [("bwd_dkv", 1, 4096, 1, 512), ("bwd_dkv", 2, 1024, 1, 512)]},
    # fp32 where the TF32 mode does not reach: K3 at the VAE mid-block's d =
    # 512 (decode's two rows, encode's one); each row's time includes the
    # route's Vᵀ prep launch
    {"name": "K3 fp32, d > 128 (scores + TF32 GEMM)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:97 (_flash_fwd_impl, "
                 "block_k < S -> _flash_kernel :62), fp32 operands",
     "counter": "flash_attention_fwd_fp32", "source": "flash_attention_bwd_tf32.cu",
     "shapes": [("blockwise_fp32", 2, 4096, 1, 512), ("blockwise_fp32", 1, 4096, 1, 512)]},
    # the fp32 backward: K4a / K4b at nti's shapes (its fp32 gradients) on the
    # narrow backward's TF32 mode, at the VAE mid-block's d = 512 (one and two
    # rows) on flash_attention_bwd_tf32.cu, and their prep kernel; each K4a /
    # K4b row's time includes the prep launch its wrapper makes
    {"name": "K4a fp32 (TF32 mode of the narrow backward)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:218 (_flash_bwd_impl -> "
                 "_flash_dq_kernel :144), fp32 operands, d <= 128",
     "counter": "flash_attention_bwd_dq_tf32", "source": "flash_attention_bwd_narrow.cu",
     "shapes": [("bwd_dq_fp32", 1, 4096, 8, 40), ("bwd_dq_fp32", 1, 1024, 8, 80)]},
    {"name": "K4b fp32 (TF32 mode of the narrow backward)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:235 (_flash_bwd_impl -> "
                 "_flash_dkv_kernel :170), fp32 operands, d <= 128",
     "counter": "flash_attention_bwd_dkv_tf32", "source": "flash_attention_bwd_narrow.cu",
     "shapes": [("bwd_dkv_fp32", 1, 4096, 8, 40), ("bwd_dkv_fp32", 1, 1024, 8, 80)]},
    {"name": "K4a fp32, d > 128 (scores + TF32 GEMM)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:218 (_flash_bwd_impl -> "
                 "_flash_dq_kernel :144), fp32 operands, d > 128",
     "counter": "flash_attention_bwd_dq_tf32_wide", "source": "flash_attention_bwd_tf32.cu",
     "shapes": [("bwd_dq_fp32", 1, 4096, 1, 512), ("bwd_dq_fp32", 2, 4096, 1, 512)]},
    {"name": "K4b fp32, d > 128 (scores + TF32 GEMMs)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:235 (_flash_bwd_impl -> "
                 "_flash_dkv_kernel :170), fp32 operands, d > 128",
     "counter": "flash_attention_bwd_dkv_tf32_wide", "source": "flash_attention_bwd_tf32.cu",
     "shapes": [("bwd_dkv_fp32", 1, 4096, 1, 512), ("bwd_dkv_fp32", 2, 4096, 1, 512)]},
    {"name": "TF32 backward prep (K, Q, dO transposed; D)",
     "replaces": "none: the fp32 backward's B operands and D for K4a / K4b "
                 "(eta_inversion_tpu/ops/flash_attention.py:210-213 build kt, qt, dot with XLA)",
     "counter": "flash_attention_bwd_tf32_prep", "source": "flash_attention_bwd_narrow.cu",
     "shapes": [("bwd_prep", 1, 4096, 8, 40), ("bwd_prep", 1, 1024, 8, 80),
                ("bwd_prep", 1, 4096, 1, 512)]},
]
FWD_COUNTERS = ("flash_attention_packed", "flash_attention_bhsd_onepass",
                "flash_attention_bhsd_blockwise")
FLASH_COUNTERS = FWD_COUNTERS + ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# the JAX package keeps K5 and K6 off its served paths, and so does the port;
# the microbenchmarks' kernels (S1, S3, S4) are on no served path either
MICROBENCH_COUNTERS = ("flash_attention_bhsd_tiled", "flash_attention_bhsd_tf32",
                       "flash_attention_multihead_tf32")
OPT_IN_COUNTERS = ("crossk_attention", "geglu_fused", "flash_attention_multihead",
                   *MICROBENCH_COUNTERS)
# the fp32 kernels: the TF32 mode and its prep kernel, the forward above head
# dim 128, and the backward's TF32 routes and their prep kernel, idle on the
# bf16 served paths
FP32_COUNTERS = ("flash_attention_narrow_tf32", "flash_attention_tf32_prep",
                 "flash_attention_fwd_fp32", "flash_attention_bwd_dq_tf32",
                 "flash_attention_bwd_dkv_tf32", "flash_attention_bwd_dq_tf32_wide",
                 "flash_attention_bwd_dkv_tf32_wide", "flash_attention_bwd_tf32_prep")
# the libraries of the wgmma kernels: the forward up to head dim 128 (K1,
# K2, S1), the backward up to 128 (K4a, K4b), the forward above it (K3 at the
# VAE's d = 512), the bf16 and the fp32 backward above it, the short-K
# cross-attention (K5, S2) and the fused GEGLU (K6)
WGMMA_LIBS = (fa.NARROW_LIB, fa.BWD_NARROW_LIB, fa.WIDE_LIB, fa.BWD_LIB, fa.BWD_TF32_LIB,
              "eti_crossk_attention", "eti_geglu")
# the VAE gradient check: kernels against the plain path, relative L2 per
# gradient.  One attention layer: the kernels round P and dS to bf16, the
# plain path's bf16 autograd rounds dP and its products, about 0.1-0.3% of
# the gradient; a dropped or mis-scaled dQ / dK / dV term is far above 1%
VAE_GRAD_RTOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def _reset_counts() -> None:
    fa.reset_launch_counts()
    gg.reset_launch_counts()


def _counts() -> dict:
    return {**fa.LAUNCHES, **gg.LAUNCHES}


def _check_opt_in_idle(counts: dict, phase: str, fp32: bool = False) -> None:
    """K5, K6 and the microbenchmarks' kernels idle on a served path, and
    on a bf16 one the fp32 kernels too."""
    launched = {k: counts[k] for k in OPT_IN_COUNTERS if counts[k]}
    if launched:
        raise RuntimeError(f"{phase}: the served path launched opt-in kernels {launched}")
    launched = {k: counts[k] for k in FP32_COUNTERS if counts[k]}
    if launched and not fp32:
        raise RuntimeError(f"{phase}: the bf16 path launched fp32 kernels {launched}")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke run needs one card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s); card 0: {name}")
    log(smi.stdout.strip().splitlines()[0])
    return name


def phase_build() -> None:
    from eta_inversion_tpu_torch.ops import cuda_build

    t0 = time.monotonic()
    cuda_build.load_libraries(fa._LIBS + gg._LIBS)  # one nvcc per source, started together
    fa.build_kernels()
    gg.build_kernels()
    log(f"[build] attention and GEGLU kernels ready in {time.monotonic() - t0:.1f} s")
    for name, info in cuda_build.build_info.items():
        log(f"[build] {name}: nvcc {info['seconds']:.1f} s -> {info['path']}")
        for line in str(info["log"]).splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "wgmma",
                                       "warning")):
                log(f"[build]   {line.strip()}")
    for lib in WGMMA_LIBS:
        hgmma = cuda_build.sass_count(lib, "HGMMA")
        log(f"[build] {lib}: {hgmma} HGMMA (wgmma) instructions in its SASS")
        if hgmma == 0:
            raise RuntimeError(f"{lib} holds no wgmma instruction: not the Hopper kernel")


def _inputs(kind, b, s, h, d, seed, n=3):
    """Seeded randn operands, bf16, or fp32 for a kind ending in "_fp32"."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = kind.removesuffix("_fp32")
    dtype = torch.float32 if kind.endswith("_fp32") else torch.bfloat16
    shape = (b, s, h * d) if base in ("packed", "bwd_dq", "bwd_dkv") else (b, s, d)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(n)]


# clock cycles of device sleep per timed call queued ahead of a timing, at
# least (a launch through a wrapper takes 20-60 us of host time), and the
# clock rate that turns a call's measured host time into cycles: the boost
# clock, so that the sleep errs long
SLEEP_CYCLES_PER_REP = 200_000
SLEEP_CLOCK_HZ = 1.98e9


def _time_ms(fn, reps: int) -> float:
    """Device ms per call of fn: CUDA events around `reps` calls that the host
    queues behind a sleep kernel, so that a kernel shorter than its host
    launch path is timed back to back on the device, not at the host's rate.
    The sleep covers three times the host time of one call, measured after
    the warm-up (an autograd backward takes several hundred microseconds)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(max(SLEEP_CYCLES_PER_REP, int(3 * host_s * SLEEP_CLOCK_HZ)) * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _roofline(mma_flops, exps, fp32_flops, nbytes, tf32_flops=0):
    """(ms, "operations" or "bytes"): the least time the card could take for
    one call: tensor-core flops at the bf16 (or TF32) peak, exponentials at
    the MUFU rate and other fp32 flops at the fp32 peak, against each input
    read and each output written once at the HBM rate."""
    ops_s = max(mma_flops / PEAK_BF16_FLOPS, tf32_flops / PEAK_TF32_FLOPS, exps / PEAK_EXP,
                fp32_flops / PEAK_FP32_FLOPS)
    bytes_s = nbytes / PEAK_HBM_BYTES
    return (ops_s * 1e3, "operations") if ops_s >= bytes_s else (bytes_s * 1e3, "bytes")


def _bound(kind, bh, s, d):
    """_roofline of a self-attention call (bf16 tensors, or fp32 for a kind
    ending in "_fp32"; fp32 LSE and D): one exponential per score."""
    base = kind.removesuffix("_fp32")
    mult = {"bwd_dq": 6, "bwd_dkv": 8}.get(base, 4)
    tensors = {"bwd_dq": 6, "bwd_dkv": 6}.get(base, 4)  # q,k,v,o,dO,dQ / q,k,v,dO,dK,dV
    vectors = 2 if base in ("bwd_dq", "bwd_dkv") else 0  # LSE and D, fp32
    elem = 4 if kind.endswith("_fp32") else 2
    nbytes = tensors * bh * s * d * elem + vectors * bh * s * 4
    flops = mult * bh * s * s * d
    if kind in ("tiled_tf32", "prod", "multihead") or kind.endswith("_fp32"):
        return _roofline(0, bh * s * s, 0, nbytes, tf32_flops=flops)
    return _roofline(flops, bh * s * s, 0, nbytes)


# now and then a profiler session records no device kernel at all (seen once
# in a run of some thirty sessions): _top_kernel tries this many
PROFILER_SESSIONS = 3


def _top_kernel(fn) -> str:
    """Name of the device kernel that took the longest over three calls of fn."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if evs:
            return max(evs, key=lambda e: e.self_device_time_total).key[:90]
    raise RuntimeError(f"{PROFILER_SESSIONS} profiler sessions recorded no device kernel")


def _sdpa(kind, q, k, v, h, d):
    """(B, H, S, D) views of the kernel's operands for
    F.scaled_dot_product_attention."""
    if kind.removesuffix("_fp32") in ("packed", "bwd_dq", "bwd_dkv", "multihead"):
        return [x.view(x.shape[0], x.shape[1], h, d).transpose(1, 2) for x in (q, k, v)]
    return [x[:, None] for x in (q, k, v)]


# the largest fp32 score tensor a plain forward builds at once: the bucket-8
# shapes (up to 17 GB of scores at (32, 4096, 8, 40)) run in chunks of rows
PLAIN_SCORE_BYTES = 2 << 30


def _fwd_case(kind, q, k, v, b, s, h, d, scale):
    """(kernel fn, plain fn, check fn -> [(kernel output, plain output)]
    (and checks the LSE), library fn, extra) for a forward kernel; on the
    narrow kernel's TF32 mode (fp32 operands) check also fills extra
    (_beside_tf32)."""
    fp32 = kind.endswith("_fp32")
    kind = kind.removesuffix("_fp32")
    rows = max(1, PLAIN_SCORE_BYTES // (h * s * s * 4))  # leading rows a plain chunk holds
    if kind == "packed":
        run = lambda: fa.flash_attention_packed(q, k, v, scale, heads=h)  # noqa: E731
        plain = lambda: _chunked(  # noqa: E731
            lambda *x: fa.flash_attention_packed_plain(*x, scale, h), q, k, v, rows)
        with_lse = lambda: fa.flash_attention_packed_fwd(q, k, v, scale, h, need_lse=True)  # noqa: E731
        lse_want = _chunked(lambda a, b_, _: fa.attention_lse_plain(
            fa._packed_to_flat(a, h), fa._packed_to_flat(b_, h), scale), q, k, v,
            rows).reshape(b, h, s)
    else:
        bk = s if kind == "onepass" else s // 4
        run = lambda: fa.flash_attention_bhsd(q, k, v, scale, block_q=256, block_k=bk)  # noqa: E731
        plain = lambda: _chunked(  # noqa: E731
            lambda *x: fa.flash_attention_bhsd_plain(*x, scale), q, k, v, rows)
        with_lse = lambda: fa.flash_attention_bhsd_fwd(q, k, v, scale, block_k=bk,  # noqa: E731
                                                       need_lse=True)
        lse_want = _chunked(lambda a, b_, _: fa.attention_lse_plain(a, b_, scale), q, k, v, rows)

    def check():
        got = run()
        want = plain()
        _, lse = with_lse()
        torch.cuda.synchronize()
        lse_err = (lse - lse_want).abs().max().item()
        lse_tol = LSE_TF32_TOL if fp32 else LSE_TOL
        log(f"[kernels]   LSE max_abs_err={lse_err:.3e} (bound {lse_tol})")
        if not lse_err <= lse_tol:
            raise RuntimeError(f"the forward's LSE disagrees with the plain logsumexp: {lse_err}")
        if fp32:
            extra.update(_beside_tf32(kind, q, k, v, h, scale, got, want,
                                      prep=d <= fa.NARROW_MAX_HEAD_DIM))
            extra.update(_beside_sdpa_fp32(qh, kh, vh, scale, want))
            if d > fa.NARROW_MAX_HEAD_DIM:  # materialized scores: a fixed order
                _, lse_again = with_lse()
                extra["bitwise_repeatable"] = torch.equal(got, run()) \
                    and torch.equal(lse, lse_again)
                if not extra["bitwise_repeatable"]:
                    raise RuntimeError("two calls of the fp32 forward above head dim 128 "
                                       "differ")
        return [(got, want)]

    extra = {}
    qh, kh, vh = _sdpa(kind, q, k, v, h, d)
    if fp32:
        library = _at_tf32(lambda: _sdpa_math(qh, kh, vh, scale))
    else:
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, scale=scale)
    return run, plain, check, library, extra


def _at_tf32(fn):
    """fn run with TF32 matmuls allowed: a library call on fp32 inputs at the
    precision of the port's fp32 attention kernels (TF32 products)."""
    def call():
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return call


def _sdpa_math(qh, kh, vh, scale):
    """F.scaled_dot_product_attention on its math backend (two matmuls and a
    softmax, which follow allow_tf32)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.MATH):
        return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale)


def _beside_sdpa_fp32(qh, kh, vh, scale, want) -> dict:
    """On the fp32 inputs of an fp32 row: SDPA's default call (the memory-
    efficient kernel, whose precision is its own) timed, and the mean error
    against the fp32 plain result of it and of the matched-precision library
    call (math backend, TF32 allowed)."""
    default = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, scale=scale)
    flat = want.reshape(qh.shape[0], qh.shape[2], qh.shape[1], qh.shape[3]).transpose(1, 2) \
        if want.dim() == 3 and qh.shape[1] > 1 else want.reshape(qh.shape)
    t_d, kernel = _time_library(default)
    tf32 = _at_tf32(lambda: _sdpa_math(qh, kh, vh, scale))()
    out = {"library_fp32_default_ms": t_d, "library_fp32_default_kernel": kernel,
           "sdpa_default_mean_abs_err":
               None if t_d is None else (default() - flat).abs().mean().item(),
           "library_mean_abs_err": (tf32 - flat).abs().mean().item()}
    log(f"[kernels]   SDPA default fp32 call {t_d} ms [{kernel}], mean |err| "
        f"{out['sdpa_default_mean_abs_err']}; SDPA math backend with TF32 (the library_ms "
        f"call) mean |err| {out['library_mean_abs_err']:.3e}")
    return out


def _beside_tf32(kind, q, k, v, h, scale, got, want, prep=True) -> dict:
    """On the fp32 inputs of an fp32 row: the mean error against the fp32
    plain result, which must be below the bf16 kernel's on the same inputs
    rounded to bf16, and (`prep`: the TF32 mode) the prep kernel's time alone
    (part of the row's)."""
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    heads = h if kind == "packed" else None
    bf16 = (fa.flash_attention_packed(qb, kb, vb, scale, heads=h) if heads
            else fa.flash_attention_bhsd(qb, kb, vb, scale, block_k=q.shape[1]))
    out = {"mean_abs_err": (got - want).abs().mean().item(),
           "bf16_mean_abs_err": (bf16.float() - want).abs().mean().item(),
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    if prep:
        out["prep_ms"] = _time_ms(lambda: fa.flash_attention_tf32_prep(q, k, v, heads), 20)
    log(f"[kernels]   mean |err| against the fp32 plain result: fp32 kernel "
        f"{out['mean_abs_err']:.3e}, bf16 kernel on the inputs rounded to bf16 "
        f"{out['bf16_mean_abs_err']:.3e}"
        + (f"; prep kernel alone {out['prep_ms']:.4f} ms" if prep else ""))
    if not out["mean_abs_err"] < out["bf16_mean_abs_err"]:
        raise RuntimeError("the TF32 mode is not closer to the fp32 result than bf16")
    return out


def _prep_case(kind, shape, seed):
    """The TF32 mode's prep kernel at (B, S, H, d) (H = 1: flat), fp32 or
    bf16 operands, bit for bit against its plain version.  No one PyTorch
    call computes it; the bound counts V read and V^T written (and for bf16
    q and k read and written widened)."""
    b, s, h, d = shape
    fp32 = kind == "prep_fp32"
    q, k, v = _inputs("packed_fp32" if fp32 else "onepass", b, s, h, d, seed)
    heads = h if h > 1 else None
    run = lambda: fa.flash_attention_tf32_prep(q, k, v, heads)  # noqa: E731
    plain = lambda: fa.tf32_prep_plain(q, k, v, heads)  # noqa: E731

    def check():
        got, want = run(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise RuntimeError("the TF32 prep kernel differs from its plain version")
        return list(zip(got, want)) if not fp32 else [(got[2], want[2])]

    n = b * s * h * d
    nbytes = n * 4 * 2 if fp32 else 3 * n * 2 + 3 * n * 4
    return (run, plain, check, None, _roofline(0, 0, 0, nbytes),
            f"shape(B,S,H,d)={shape} {'fp32' if fp32 else 'bf16'}")


def _bwd_prep_case(kind, shape, seed):
    """The fp32 backward's prep kernel at (B, S, H, d) (packed layout), as
    flash_attention_bwd launches it (K^T, Q^T, dO^T and D): the transposes
    bit for bit against its plain version, D (another summation order)
    within the row's bound.  No one PyTorch call computes it; the bound
    counts K, Q, dO and O read and the three transposes and D written."""
    b, s, h, d = shape
    q, k, do, o = _inputs("packed_fp32", b, s, h, d, seed, n=4)
    run = lambda: fa.flash_attention_bwd_tf32_prep(q, k, do, o, h)  # noqa: E731
    plain = lambda: fa.bwd_tf32_prep_plain(q, k, do, o, h)  # noqa: E731

    def check():
        got, want = run(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got[:3], want[:3])):
            raise RuntimeError("the TF32 backward prep kernel's transposes differ from its "
                               "plain version")
        return list(zip(got, want))

    n = b * s * h * d
    return (run, plain, check, None, _roofline(0, 0, 0, 7 * n * 4 + b * h * s * 4),
            f"shape(B,S,H,d)={shape} fp32")


def _bwd_case(kind, q, k, v, b, s, h, d, scale, seed):
    """As _fwd_case for K4a / K4b, on seeded q, k, v, dO and the plain
    forward's o and LSE (K4b also on the D that K4a wrote); check also fills
    extra (_beside_bwd)."""
    fp32 = kind.endswith("_fp32")
    kind = kind.removesuffix("_fp32")
    (do,) = _inputs(kind + ("_fp32" if fp32 else ""), b, s, h, d, seed + 50, n=1)
    o = fa.flash_attention_packed_plain(q, k, v, scale, h)
    lse = fa.attention_lse_plain(fa._packed_to_flat(q, h), fa._packed_to_flat(k, h),
                                 scale).reshape(b, h, s)
    flat = [fa._packed_to_flat(x, h) for x in (q, k, v, o, do)]
    _, dvec = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, heads=h)
    if kind == "bwd_dq":
        run = lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, heads=h)  # noqa: E731
        plain = lambda: fa.flash_attention_bwd_dq_plain(  # noqa: E731
            *flat[:4], lse, flat[4], scale)
    else:
        run = lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, do, dvec, scale, heads=h)  # noqa: E731
        plain = lambda: fa.flash_attention_bwd_dkv_plain(  # noqa: E731
            *flat[:3], lse, flat[4], dvec, scale)

    def check():
        got = run()
        want = plain()
        torch.cuda.synchronize()
        extra.update(_beside_bwd(pair, library, math_library))
        if fp32:
            extra.update(_beside_sdpa_bwd_fp32(pair, oh, qh, kh, vh, doh, scale))
        if kind == "bwd_dq":
            err_d = (got[1] - want[1]).abs().max().item()
            log(f"[kernels]   D = rowsum(dO o O) max_abs_err={err_d:.3e}")
            return [(fa._packed_to_flat(got[0], h), want[0])]
        return [(fa._packed_to_flat(x, h), y) for x, y in zip(got, want)]

    qh, kh, vh = (x.detach().requires_grad_(True) for x in _sdpa(kind, q, k, v, h, d))
    oh = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    doh = do.view(b, s, h, d).transpose(1, 2)
    if fp32:  # SDPA's backward at the kernels' precision: math backend, TF32
        oh_tf32 = _at_tf32(lambda: _sdpa_math(qh, kh, vh, scale))()
        library = _at_tf32(lambda: torch.autograd.grad(oh_tf32, (qh, kh, vh), doh,
                                                       retain_graph=True))
    else:
        library = lambda: torch.autograd.grad(oh, (qh, kh, vh), doh,  # noqa: E731
                                              retain_graph=True)
    # the bf16 route above head dim 128 materializes the scores and runs
    # GEMMs, as SDPA's math backend does: timed beside the pair as well
    math_library = None
    if not fp32 and d > fa.NARROW_MAX_HEAD_DIM:
        oh_math = _sdpa_math(qh, kh, vh, scale)
        math_library = lambda: torch.autograd.grad(oh_math, (qh, kh, vh), doh,  # noqa: E731
                                                   retain_graph=True)
    pair = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, scale, heads=h)  # noqa: E731
    extra = {}
    return run, plain, check, library, extra


def _beside_bwd(pair, library, math_library=None) -> dict:
    """On the inputs of a K4a / K4b row: the pair K4a + K4b (the function of
    the library call, SDPA's whole backward) timed in turns with the library
    call, pair, library, library, pair; and two launches of the pair, which
    must give the same bits (one thread sums each output element, in a fixed
    order).  `math_library` (the bf16 rows above head dim 128): SDPA's
    whole backward on its math backend, timed after the turns."""
    first, second = pair(), pair()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    if not same:
        raise RuntimeError("two launches of the backward on the same inputs differ")
    turns = [_time_ms(fn, 20) for fn in (pair, library, library, pair)]
    out = {"pair_ms": (turns[0] + turns[3]) / 2, "pair_library_ms": (turns[1] + turns[2]) / 2,
           "pair_ms_turns": [turns[0], turns[3]], "bitwise_repeatable": same}
    math = ""
    if math_library is not None:
        out["pair_library_math_ms"] = _time_ms(math_library, 20)
        math = f" [math backend {out['pair_library_math_ms']:.4f} ms]"
    log(f"[kernels]   in turns: K4a + K4b {turns[0]:.4f} / {turns[3]:.4f} ms, SDPA's whole "
        f"backward {turns[1]:.4f} / {turns[2]:.4f} ms{math} "
        f"({out['pair_ms'] / out['pair_library_ms']:.2f}x its time); two launches bitwise "
        f"equal")
    return out


def _beside_sdpa_bwd_fp32(pair, oh, qh, kh, vh, doh, scale) -> dict:
    """On the fp32 inputs of an fp32 K4a / K4b row: SDPA's default fp32
    backward (the memory-efficient kernel's) timed, and the mean error of dQ
    from the pair, from it and from the matched-precision library call
    against the plain fp32 autograd of the math backend with TF32 off."""
    default = lambda: torch.autograd.grad(oh, (qh, kh, vh), doh,  # noqa: E731
                                          retain_graph=True)
    want = torch.autograd.grad(_sdpa_math(qh, kh, vh, scale), (qh, kh, vh), doh)[0]
    oh_tf32 = _at_tf32(lambda: _sdpa_math(qh, kh, vh, scale))()
    tf32 = _at_tf32(lambda: torch.autograd.grad(oh_tf32, (qh, kh, vh), doh))()[0]
    dq = pair()[0]
    dq = dq.view(qh.shape[0], qh.shape[2], qh.shape[1], qh.shape[3]).transpose(1, 2)
    t_d, kernel = _time_library(default)
    out = {"library_fp32_default_ms": t_d, "library_fp32_default_kernel": kernel,
           "dq_mean_abs_err": (dq - want).abs().mean().item(),
           "sdpa_default_dq_mean_abs_err":
               None if t_d is None else (default()[0] - want).abs().mean().item(),
           "library_dq_mean_abs_err": (tf32 - want).abs().mean().item()}
    log(f"[kernels]   SDPA default fp32 backward {t_d} ms [{kernel}]; dQ mean |err| against "
        f"fp32 autograd: kernels {out['dq_mean_abs_err']:.3e}, SDPA default "
        f"{out['sdpa_default_dq_mean_abs_err']}, SDPA math backend with TF32 (the "
        f"library_ms call) {out['library_dq_mean_abs_err']:.3e}")
    return out


def _attention_case(kind, shape, seed):
    """A self-attention kernel (K1-K4b, and K1 / K2 on fp32 operands) at (B,
    S, H, d)."""
    b, s, h, d = shape
    q, k, v = _inputs(kind, b, s, h, d, seed=seed)
    scale = d ** -0.5
    if kind.startswith("bwd"):
        *case, extra = _bwd_case(kind, q, k, v, b, s, h, d, scale, seed=seed)
    else:
        *case, extra = _fwd_case(kind, q, k, v, b, s, h, d, scale)
    return (*case, _bound(kind, b * h, s, d), f"shape(B,S,H,d)={shape}", extra)


def _crossk_case(kind, shape, seed):
    """K5 at (BH, Sq, D, sk) on seeded q, k, v; for S2 ("crossk_padded") k
    and v come padded to 128 rows, as the prototype takes them.  The bound
    counts the sk keys the function reads."""
    bh, sq, d, sk = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = 128 if kind == "crossk_padded" else sk
    fp32 = kind.endswith("_fp32")
    dtype = torch.float32 if fp32 else torch.bfloat16
    q = torch.randn(bh, sq, d, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(bh, rows, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    scale = d ** -0.5
    run = lambda: fa.crossk_attention_bhsd(q, k, v, sk, scale)  # noqa: E731
    plain = lambda: fa.crossk_attention_plain(q, k, v, sk, scale, tf32=fp32)  # noqa: E731
    qh, kh, vh = q[:, None], k[:, None, :sk], v[:, None, :sk]
    if fp32:  # SDPA at the kernel's precision: its math backend, TF32 matmuls
        library = _at_tf32(lambda: _sdpa_math(qh, kh, vh, scale))
    else:
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, scale=scale)
    nbytes = (2 * bh * sq * d + 2 * bh * sk * d) * q.element_size()
    flops = 4 * bh * sq * sk * d
    bound = _roofline(0 if fp32 else flops, bh * sq * sk, 0, nbytes,
                      tf32_flops=flops if fp32 else 0)
    extra = {}

    def check():
        got = run()
        extra["bitwise_repeatable"] = _repeatable(got, run, "K5's kernel")
        return [(got, plain())]

    return run, plain, check, library, bound, f"shape(BH,Sq,D,sk)={shape}", extra


def _repeatable(got, run, what: str) -> bool:
    """A second launch of `run` gives got's bits, or RuntimeError."""
    if not torch.equal(got, run()):
        raise RuntimeError(f"two launches of {what} differ")
    return True


def _geglu_case(kind, shape, seed):
    """K6 at (n, C, I) on seeded bf16 x ~ N(0, 1) and weights at the sd15
    init's scale (1/sqrt(fan_in)), biases ~ N(0, 0.1^2)."""
    n, c, inner = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*sh, std):
        return (torch.randn(sh, generator=g, device="cuda") * std).bfloat16()

    x, w1, b1 = r(n, c, std=1.0), r(2 * inner, c, std=c ** -0.5), r(2 * inner, std=0.1)
    w2, b2 = r(c, inner, std=inner ** -0.5), r(c, std=0.1)
    run = lambda: gg.geglu_mlp_fused(x, w1, b1, w2, b2)  # noqa: E731
    plain = lambda: gg.geglu_mlp_fused_plain(x, w1, b1, w2, b2)  # noqa: E731

    def library():  # cuBLAS, F.gelu, the multiply, cuBLAS: no one call computes it
        s = torch.nn.functional.linear(x, w1, b1)
        return torch.nn.functional.linear(s[:, :inner] * torch.nn.functional.gelu(s[:, inner:]),
                                          w2, b2)

    nbytes = (2 * n * c + 3 * c * inner + 2 * inner + c) * 2
    bound = _roofline(6 * n * c * inner, 0, GELU_FLOPS * n * inner, nbytes)
    return run, plain, lambda: [(run(), plain())], library, bound, f"shape(n,C,I)={shape}"


# the plain versions at the prototypes' B*H = 256 would hold 256 x 4096^2 fp32
# scores (17 GB): they run this many heads (a chunk of batch elements) at a time
PLAIN_CHUNK_HEADS = 16


def _chunked(plain, q, k, v, rows):
    """plain over the leading dim `rows` at a time, concatenated."""
    return torch.cat([plain(q[i:i + rows], k[i:i + rows], v[i:i + rows])
                      for i in range(0, q.shape[0], rows)])


def _sweep_case(kind, shape, seed):
    """S1 / S3: K3's function through flash_attention_bhsd_tiled at (BH, S,
    D) with D zero-padded to `dpad` in device memory, operands bf16 on the
    narrow kernel's one tile ("tiled"; two launches must give the same bits)
    or fp32 products on its TF32 mode ("tiled_tf32"; "prod" is S3, the same
    call, which also times its split / merge transposes).  The TF32 rows
    also check that their mean error against the fp32 plain result is below
    the bf16 mode's on the same inputs, and time the prep kernel alone."""
    from eta_inversion_tpu_torch.microbench import merge, split

    bh, s, d, dpad = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.nn.functional.pad(torch.randn(bh, s, d, generator=g, device="cuda"),
                                       (0, dpad - d)).bfloat16() for _ in range(3))
    scale = d ** -0.5
    operands = "bf16" if kind == "tiled" else "fp32"
    run = lambda: fa.flash_attention_bhsd_tiled(q, k, v, scale, operands)  # noqa: E731
    plain = lambda: _chunked(  # noqa: E731
        lambda *a: fa.flash_attention_bhsd_plain(*a, scale), q, k, v, PLAIN_CHUNK_HEADS)
    extra = {}

    def check():
        got, want = run(), plain()
        if operands == "bf16":
            extra["bitwise_repeatable"] = _repeatable(got, run, "S1's bf16 route")
        if operands == "fp32":
            exact = _chunked(lambda *a: fa.flash_attention_bhsd_plain(*(x.float() for x in a),
                                                                      scale),
                             q, k, v, PLAIN_CHUNK_HEADS)
            bf16 = fa.flash_attention_bhsd_tiled(q, k, v, scale, "bf16")
            extra["mean_abs_err"] = (got.float() - exact).abs().mean().item()
            extra["bf16_mean_abs_err"] = (bf16.float() - exact).abs().mean().item()
            extra["prep_ms"] = _time_ms(lambda: fa.flash_attention_tf32_prep(q, k, v), 10)
            log(f"[kernels]   mean |err| against the fp32 plain result: TF32 "
                f"{extra['mean_abs_err']:.3e}, bf16 mode {extra['bf16_mean_abs_err']:.3e}; "
                f"the prep kernel (q, k widened, V^T) alone {extra['prep_ms']:.3f} ms, part "
                f"of the row's time")
            if not extra["mean_abs_err"] < extra["bf16_mean_abs_err"]:
                raise RuntimeError("the TF32 mode is not closer to the fp32 result than bf16")
        if kind == "prod":  # S3's split of q, k, v and merge of o, as the prototype times them
            b = bh // 8
            packed = merge(q[..., :d], b)
            extra["split_merge_ms"] = _time_ms(
                lambda: [merge(split(packed), b)] + [split(packed) for _ in range(2)], 20)
            log(f"[kernels]   split (q, k, v) + merge (o) around it: "
                f"{extra['split_merge_ms']:.3f} ms")
        return [(got, want)]

    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q[:, None], k[:, None], v[:, None], scale=scale)
    return (run, plain, check, library, _bound(kind, bh, s, dpad),
            f"shape(BH,S,D)=({bh}, {s}, {d}) in D={dpad}", extra)


def _multihead_case(kind, shape, seed):
    """S4: the narrow kernel's all-heads block at (B, S, H, d), the packed
    layout, its one tile, with the prototype's fp32 (TF32) products; the
    plain version one batch element (H heads) at a time.  Also checks that
    its mean error against the fp32 plain result is below its bf16 mode's,
    and times its bf16 mode beside K1's route (bf16, one block per (batch,
    head)) on the same inputs: the layout question with equal operands."""
    b, s, h, d = shape
    q, k, v = _inputs("packed", b, s, h, d, seed=seed)
    scale = d ** -0.5
    run = lambda: fa.flash_attention_multihead(q, k, v, scale, h, "fp32")  # noqa: E731
    plain = lambda: _chunked(  # noqa: E731
        lambda *a: fa.flash_attention_packed_plain(*a, scale, h), q, k, v,
        max(1, PLAIN_CHUNK_HEADS // h))
    extra = {}

    def check():
        got, want = run(), plain()
        exact = _chunked(lambda *a: fa.flash_attention_packed_plain(*(x.float() for x in a),
                                                                    scale, h),
                         q, k, v, max(1, PLAIN_CHUNK_HEADS // h))
        bf16 = fa.flash_attention_multihead(q, k, v, scale, h, "bf16")
        extra["mean_abs_err"] = (got.float() - exact).abs().mean().item()
        extra["bf16_mean_abs_err"] = (bf16.float() - exact).abs().mean().item()
        extra["bf16_max_abs_err"] = (bf16.float() - exact).abs().max().item()
        bf16_bound = KERNEL_RTOL * exact.abs().max().item()
        del exact
        extra["bf16_mode_ms"] = _time_ms(
            lambda: fa.flash_attention_multihead(q, k, v, scale, h, "bf16"), 10)
        extra["k1_route_ms"] = _time_ms(lambda: fa.flash_attention_packed(q, k, v, scale, h), 10)
        log(f"[kernels]   mean |err| against the fp32 plain result: TF32 "
            f"{extra['mean_abs_err']:.3e}, bf16 mode {extra['bf16_mean_abs_err']:.3e} "
            f"(bf16 max {extra['bf16_max_abs_err']:.3e}, bound {bf16_bound:.3e}); "
            f"bf16 mode {extra['bf16_mode_ms']:.3f} ms, K1's route on the same inputs "
            f"{extra['k1_route_ms']:.3f} ms")
        if not extra["mean_abs_err"] < extra["bf16_mean_abs_err"]:
            raise RuntimeError("S4's TF32 mode is not closer to the fp32 result than bf16")
        if not extra["bf16_max_abs_err"] <= bf16_bound:
            raise RuntimeError(f"S4's bf16 mode disagrees with the plain version: "
                               f"{extra['bf16_max_abs_err']} > {bf16_bound}")
        return [(got, want)]

    qh, kh, vh = _sdpa(kind, q, k, v, h, d)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, scale=scale)
    return (run, plain, check, library, _bound(kind, b * h, s, d), f"shape(B,S,H,d)={shape}",
            extra)


CASES = {"crossk": _crossk_case, "crossk_fp32": _crossk_case, "crossk_padded": _crossk_case,
         "geglu": _geglu_case,
         "tiled": _sweep_case, "tiled_tf32": _sweep_case, "prod": _sweep_case,
         "multihead": _multihead_case, "prep_fp32": _prep_case, "prep_bf16": _prep_case,
         "bwd_prep": _bwd_prep_case}


def phase_kernels() -> list:
    rows = []
    for i, kern in enumerate(KERNELS):
        errs, first, other_shapes = [], None, []
        for j, (kind, *shape) in enumerate(kern["shapes"]):
            make = CASES.get(kind, _attention_case)
            run, plain, check, library, (bound_ms, bound_by), label, *extra = make(
                kind, tuple(shape), 100 * i + j)
            err, bound = 0.0, 0.0
            for got, want in check():
                err = max(err, (got.float() - want.float()).abs().max().item())
                bound = max(bound, KERNEL_RTOL * want.float().abs().max().item())
            if not np.isfinite(err):
                raise RuntimeError(f"{kern['name']} at {label}: non-finite output")
            t_k, t_p = _time_ms(run, 20), _time_ms(plain, 5)
            t_l, lib_kernel = _time_library(library)
            log(f"[kernels] {kern['name']:38s} {label} "
                f"max_abs_err={err:.3e} (bound {bound:.3e} = {KERNEL_RTOL} x max|plain|) "
                f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms, library "
                f"{'none' if t_l is None else f'{t_l:.3f} ms'} [{lib_kernel}], "
                f"bound {bound_ms:.4f} ms ({bound_by})")
            if not err <= bound:
                raise RuntimeError(f"{kern['name']} disagrees with its plain version: "
                                   f"{err} > {bound}")
            errs.append(err)
            if j == 0:
                first = {"shape": label, "ms": t_k, "plain_ms": t_p, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": t_l, "library_kernel": lib_kernel,
                         **(extra[0] if extra else {})}
            else:
                other_shapes.append({"shape": label, "ms": t_k, "plain_ms": t_p,
                                     "library_ms": t_l, "bound_ms": bound_ms,
                                     "max_abs_err": err, **(extra[0] if extra else {})})
            del run, plain, check, library
            torch.cuda.empty_cache()
        source = kern["source"]
        rows.append({"name": kern["name"], "route": "cuda",
                     "source": f"eta_inversion_tpu_torch/csrc/{source}",
                     "replaces": kern["replaces"], "counter": kern["counter"],
                     "exclude": kern.get("exclude"), "skip_phases": kern.get("skip_phases", ()),
                     "max_abs_err": max(errs), **first, "other_shapes": other_shapes})
    torch.cuda.empty_cache()
    return rows


def _time_library(library):
    """(ms, name of its longest device kernel) of the library call, or (None,
    "none (...)") where there is none or no backend of it takes the shape."""
    if library is None:
        return None, "none (no one PyTorch call computes it)"
    try:
        t_l = _time_ms(library, 20)
    except RuntimeError as e:
        return None, f"none ({str(e).splitlines()[0][:100]})"
    return t_l, _top_kernel(library)


def phase_vae_grad(dtype=torch.bfloat16) -> dict:
    """One gradient through the full-width sd15 VAE mid-block attention at
    512 px (512 channels, one head, S = 4096, d = 512; random weights from a
    seed, bf16 or fp32): through the kernels (the blockwise forward with its
    LSE, then K4a / K4b at d = 512: flash_attention_bwd.cu in bf16,
    flash_attention_bwd_tf32.cu in fp32) against the plain attention path,
    for the input and the q / k / v projection weights."""
    from eta_inversion_tpu_torch.models import SD15
    from eta_inversion_tpu_torch.models.vae import VAEAttention

    c = SD15.vae.block_out_channels[-1]
    side = SD15.image_size // 2 ** (len(SD15.vae.block_out_channels) - 1)
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        torch.manual_seed(0)
        mod = VAEAttention(c, SD15.vae.norm_num_groups).cuda().to(dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(1, c, side, side, generator=g, device="cuda").to(dtype)
    fp32 = dtype == torch.float32
    # fp32: the TF32 kernels against the plain path (FP32_RTOL's reasoning)
    rtol = FP32_RTOL if fp32 else VAE_GRAD_RTOL

    def grads():
        mod.zero_grad()
        xg = x.clone().requires_grad_(True)
        torch.sin(mod(xg).float()).sum().backward()
        return [xg.grad.float()] + [getattr(mod, n).weight.grad.float()
                                    for n in ("to_q", "to_k", "to_v")]

    _reset_counts()
    got = grads()
    torch.cuda.synchronize()
    counts = _counts()
    gate = fa._kernel_eligible
    try:
        fa._kernel_eligible = lambda *a, **k: False
        want = grads()
    finally:
        fa._kernel_eligible = gate
    errs = {name: ((a - b).norm() / b.norm()).item()
            for a, b, name in zip(got, want, ("x", "to_q", "to_k", "to_v"))}
    log(f"[kernels] gradient through the sd15 VAE mid-block attention ({c} channels, "
        f"S={side * side}, d={c}, {dtype}): kernels vs plain path rel L2 "
        + ", ".join(f"d{n} {e:.3e}" for n, e in errs.items())
        + f" (bound {rtol}); launches "
        + json.dumps({k: n for k, n in counts.items() if n}))
    if not all(np.isfinite(e) and e <= rtol for e in errs.values()):
        raise RuntimeError(f"VAE attention gradient disagrees with the plain path: {errs}")
    sub, src = ("tf32_wide", "flash_attention_bwd_tf32.cu") if fp32 else \
        ("wide", "flash_attention_bwd.cu")
    if not counts[f"flash_attention_bwd_dq_{sub}"] == counts["flash_attention_bwd_dq"] == 1 \
            or not counts[f"flash_attention_bwd_dkv_{sub}"] == counts["flash_attention_bwd_dkv"] == 1:
        raise RuntimeError(f"the {dtype} VAE attention gradient's backward is not on {src}: "
                           f"{counts}")
    # its forward (K3 with the LSE): fp32 on the route above head dim 128 of
    # flash_attention_bwd_tf32.cu, bf16 on flash_attention_wide.cu
    if not counts["flash_attention_bhsd_blockwise"] == 1 \
            or counts["flash_attention_fwd_fp32"] != int(fp32):
        raise RuntimeError(f"the {dtype} VAE attention gradient's forward is not on "
                           f"{'flash_attention_bwd_tf32.cu' if fp32 else 'flash_attention_wide.cu'}"
                           f": {counts}")
    del mod, got, want
    torch.cuda.empty_cache()
    return counts


def phase_microbench() -> dict:
    """Both attention microbenchmarks at full width (32, 8, 4096, 40).
    First each variant's single call on a unit-scale input (the bench's
    input x 10, so the scores spread over a few units) against the plain
    version, within KERNEL_RTOL of its largest magnitude: the chained bench
    shrinks its outputs toward a constant row, which cannot tell a wrong
    kernel.  Then the benches as a user runs them, counts from 0: every
    variant runs and its final output stays within KERNEL_RTOL of the first
    variant's largest magnitude."""
    from eta_inversion_tpu_torch import microbench
    from eta_inversion_tpu_torch.microbench import attn_multihead_bench, flash_sweep

    b, s, h, d = microbench.B, microbench.S, microbench.H, microbench.D
    x = microbench.make_input(b, s, "cuda") * 10
    want = _chunked(lambda *a: fa.flash_attention_packed_plain(*a, d ** -0.5, h),
                    x, x * 0.5, x * 0.25, max(1, PLAIN_CHUNK_HEADS // h))
    bound = KERNEL_RTOL * want.float().abs().max().item()
    for mod in (flash_sweep, attn_multihead_bench):
        for name, fn in mod.variants().items():
            err = (mod.call(fn, x).float() - want.float()).abs().max().item()
            log(f"[microbench] one call of {name:26s} on the unit-scale input vs plain: "
                f"max_abs_err={err:.3e} (bound {bound:.3e})")
            if not err <= bound:
                raise RuntimeError(f"{name} disagrees with the plain version: {err} > {bound}")
    del x, want
    torch.cuda.empty_cache()

    _reset_counts()
    results = {}
    for mod in (flash_sweep, attn_multihead_bench):
        name = mod.__name__.rsplit(".", 1)[1]
        log(f"[microbench] python -m eta_inversion_tpu_torch.microbench.{name} "
            f"(B, H, S, D) = {(b, h, s, d)}, {microbench.LOOPS} chained calls per run:")
        res = mod.run(b, s, "cuda", log=lambda m: log(f"[microbench]   {m}"))
        for r in res:
            bound = KERNEL_RTOL * r["max_abs_v0"]
            if r["ms"] is None or not (np.isfinite(r["max_diff_vs_v0"])
                                       and r["max_diff_vs_v0"] <= bound):
                raise RuntimeError(f"{name} {r['name']}: did not run or differs from v0 by "
                                   f"{r['max_diff_vs_v0']} (bound {bound})")
        results[name] = res
    counts = _counts()
    log(f"[microbench] kernel launches: {json.dumps(counts)}")
    n = sum(len(r) for r in results.values())
    if n != 13:
        raise RuntimeError(f"expected the prototypes' 13 variants, ran {n}")
    for k in MICROBENCH_COUNTERS:
        if counts[k] == 0:
            raise RuntimeError(f"microbench never launched {k}")
    torch.cuda.empty_cache()
    return {"launches": counts, "results": results}


# the served ptp backward's rows: [u_src, u_tgt, c_src, c_tgt]
FUSED_ROWS = 4


def phase_fused() -> dict:
    """K5 and K6 through their opt-in entry points on the activations of one
    full-width sd15 UNet call: every FeedForward's input and every
    cross-attention's q, k, v, each held against the module's own plain
    result (the FeedForward's output; the dispatcher's plain short-K path)."""
    from eta_inversion_tpu_torch.models import SD15, init_like_flax_
    from eta_inversion_tpu_torch.models.attention import FeedForward
    from eta_inversion_tpu_torch.models.unet import UNet2DCondition
    from eta_inversion_tpu_torch.ops.attn_ctrl import AttnHooks

    class CrossCapture(AttnHooks):
        """Leaves self-attention on its usual path; records each
        cross-attention's q, k, v (B, H, S, D) and its output."""

        def __init__(self):
            self.calls = []

        def passthrough_attn(self, meta):
            return not meta.is_cross

        def qkv(self, meta, q, k, v):
            self.calls.append([meta, q, k, v])
            return q, k, v

        def out(self, meta, o):
            self.calls[-1].append(o)
            return o

    t0 = time.monotonic()
    with torch.no_grad(), torch.device("cuda"):
        unet = UNet2DCondition(SD15.unet).requires_grad_(False).eval()
        init_like_flax_(unet, torch.Generator("cuda").manual_seed(0))
        unet.to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(7)
    lat = torch.randn(FUSED_ROWS, 4, 64, 64, generator=g, device="cuda")
    ctx = torch.randn(FUSED_ROWS, 77, SD15.unet.cross_attention_dim, generator=g, device="cuda")
    ff_io, cross = [], CrossCapture()
    handles = [m.register_forward_hook(lambda mod, args, out: ff_io.append((mod, args[0], out)))
               for m in unet.modules() if isinstance(m, FeedForward)]
    _reset_counts()
    try:
        with torch.no_grad():
            eps = unet(lat, 501, ctx, hooks=cross)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    unet_counts = _counts()
    log(f"[fused] sd15 UNet (random weights, seed 0, bf16) built and called at {FUSED_ROWS} rows "
        f"in {time.monotonic() - t0:.1f} s: {len(ff_io)} FeedForward and "
        f"{len(cross.calls)} cross-attention calls captured")
    _check_opt_in_idle(unet_counts, "fused (the plain UNet call)")
    if len(ff_io) != 16 or len(cross.calls) != 16:
        raise RuntimeError(f"expected 16 FeedForward and 16 cross-attention calls, got "
                           f"{len(ff_io)} and {len(cross.calls)}")
    if not torch.isfinite(eps).all():
        raise RuntimeError("the UNet call gave a non-finite output")

    def weights(mod):
        return (mod.geglu_proj.weight, mod.geglu_proj.bias, mod.proj_out.weight, mod.proj_out.bias)

    def flat(meta, q, k, v, o):
        b, h, sq, d = q.shape
        return (*(t.reshape(b * h, t.shape[2], d).contiguous() for t in (q, k, v)),
                k.shape[2], d ** -0.5)

    # the opt-in entry points on each captured call, against the module's result
    _reset_counts()
    for name, calls in (("K6", [(x, weights(mod), want) for mod, x, want in ff_io]),
                        ("K5", [(flat(*c), None, c[4]) for c in cross.calls])):
        for args, w, want in calls:
            if name == "K6":
                got = gg.geglu_mlp(args, *w, force_fused=True)
            else:
                got = fa.crossk_attention_bhsd(*args)
                want = want.reshape(got.shape)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            bound = KERNEL_RTOL * want.float().abs().max().item()
            log(f"[fused]   {name} {tuple(want.shape)}: max_abs_err={err:.3e} (bound {bound:.3e})")
            if not (np.isfinite(err) and err <= bound):
                raise RuntimeError(f"{name} at {tuple(want.shape)} disagrees with the module's "
                                   f"plain result: {err} > {bound}")

    # one gradient through K6's autograd.Function at the 64x64 shape
    mod, x, _ = ff_io[0]

    def grad(force):
        xg = x.detach().clone().requires_grad_(True)
        out = gg.geglu_mlp(xg, *weights(mod), force_fused=force)
        (gx,) = torch.autograd.grad(torch.sin(out.float()).sum(), xg)
        return gx.float()

    g_kernel, g_plain = grad(True), grad(False)
    grad_err = ((g_kernel - g_plain).norm() / g_plain.norm()).item()
    counts = _counts()
    log(f"[fused] gradient wrt x through K6 at {tuple(x.shape)}: rel L2 {grad_err:.3e} from the "
        f"plain path's (bound {GRAD_RTOL}); launches {json.dumps(counts)}")
    if not (np.isfinite(grad_err) and grad_err <= GRAD_RTOL):
        raise RuntimeError(f"K6 gradient disagrees with the plain path: {grad_err}")
    want_counts = {"geglu_fused": len(ff_io) + 1, "crossk_attention": len(cross.calls)}
    if {k: counts[k] for k in want_counts} != want_counts:
        raise RuntimeError(f"launch counts {counts} differ from the calls made {want_counts}")

    # summed time of the 16 calls of each kernel against the module's own path
    ff_args = [(x, weights(mod)) for mod, x, _ in ff_io]
    cross_args = [flat(*c) for c in cross.calls]
    cross_bhsd = [(q, k, v, q.shape[-1] ** -0.5) for _, q, k, v, _ in cross.calls]
    with torch.no_grad():
        times = {
            "K6": _time_ms(lambda: [gg.geglu_mlp(a, *w, force_fused=True) for a, w in ff_args], 10),
            "FeedForward plain": _time_ms(lambda: [mod(a) for mod, a, _ in ff_io], 10),
            "K5": _time_ms(lambda: [fa.crossk_attention_bhsd(*a) for a in cross_args], 10),
            "cross-attention plain": _time_ms(lambda: [fa.attention(*a) for a in cross_bhsd], 10),
        }
    log(f"[fused] summed ms of the 16 calls (CUDA events): K6 {times['K6']:.3f} vs FeedForward "
        f"plain {times['FeedForward plain']:.3f}; K5 {times['K5']:.3f} vs cross-attention plain "
        f"{times['cross-attention plain']:.3f}")
    del unet, ff_io, cross, ff_args, cross_args, cross_bhsd
    torch.cuda.empty_cache()
    return {"launches": counts, "ms": times, "grad_rel_err": grad_err}


def _png_to_array(b64: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"))


def _check_image(arr: np.ndarray, what: str, size: int) -> None:
    if arr.shape != (size, size, 3) or arr.dtype != np.uint8:
        raise RuntimeError(f"{what}: expected ({size}, {size}, 3) uint8, got "
                           f"{arr.shape} {arr.dtype}")


# the paths held on the card against the CPU at the tiny preset: (inverter,
# its kwargs, editor, its kwargs, edit cfg, inv_cfg); etainv's candidate
# noises are drawn once for both devices; masactrl from layer 1 / step 1
# (the default start layer 10 is past the tiny UNet's four self layers)
TINY_ETA = {"eta": ((0.6, 0.0), (1.0, 0.7)), "noise_sample_count": 4}
TINY_PTP = dict(is_replace_controller=True, cross_replace_steps=0.8, self_replace_steps=0.5)
TINY_MASA = {"layer": 1, "step": 1}
TINY_PATHS = [("etainv", TINY_ETA, "ptp", {}, TINY_PTP, {"edit_word_idx": (1, 1)}),
              ("etainv", TINY_ETA, "masactrl", TINY_MASA, None, {"edit_word_idx": (1, 1)}),
              ("etainv", TINY_ETA, "masactrl", TINY_MASA, {"mode": "mask_auto"},
               {"edit_word_idx": (1, 1)}),
              ("etainv", TINY_ETA, "pnp", {}, None, {"edit_word_idx": (1, 1)}),
              ("etainv", TINY_ETA, "invedit", {}, None, {"edit_word_idx": (1, 1)}),
              ("diffinv", {}, "pix2pix_zero", {}, {"caption": "a cat"}, None),
              ("edict", {}, "ptp", {}, TINY_PTP, None),
              ("edict", {}, "pix2pix_zero", {}, {"caption": "a cat"}, None),
              ("regdiffinv", {}, "ptp", {}, TINY_PTP, None)]


def phase_tiny_reference(preset: str = "tiny", paths=TINY_PATHS, tag: str = "serving") -> float:
    """A tiny preset's edits (`paths`, 10 steps) on the card against the
    same edits on the CPU (fp32, TF32 off on both the matmul and the conv
    path): each edited image within TINY_TOL."""
    from eta_inversion_tpu_torch import load_editor, load_inverter
    from eta_inversion_tpu_torch.models import load_diffusion_model

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    img = np.random.RandomState(0).rand(1, 16, 16, 3).astype(np.float32) * 2 - 1
    models = {"cuda": load_diffusion_model(preset, device="cuda", seed=0)[0]}
    models["cpu"] = load_diffusion_model(preset, device="cpu", seed=0)[0]
    # same weights on both: the card's
    models["cpu"].nets.load_state_dict({k: v.cpu()
                                        for k, v in models["cuda"].nets.state_dict().items()})
    worst = 0.0
    for inverter, inv_kwargs, editor, ed_kwargs, cfg, inv_cfg in paths:
        outs = {}
        for dev, model in models.items():
            def noise_fn(i, shape, dev=dev):  # same candidate noises on both devices
                draw = np.random.RandomState(1000 + i).randn(*shape).astype(np.float32)
                return torch.from_numpy(draw).to(dev)

            inv = load_inverter(model, inverter, num_inference_steps=10, noise_fn=noise_fn,
                                **inv_kwargs)
            res = load_editor(inv, editor, **ed_kwargs).edit(
                img, "a cat sitting", "a tiger sitting", cfg=None if cfg is None else dict(cfg),
                inv_cfg=None if inv_cfg is None else dict(inv_cfg))
            outs[dev] = res["image"].float().cpu().numpy()
        err = float(np.abs(outs["cuda"] - outs["cpu"]).max())
        label = f"{inverter}+{editor}" + ("" if not cfg or "mode" not in cfg
                                          else f" {cfg['mode']}")
        log(f"[{tag}] {preset} {label} edit, card vs CPU: max_abs_err={err:.3e} "
            f"(bound {TINY_TOL})")
        if not err <= TINY_TOL:
            raise RuntimeError(f"{preset} {label} edit on the card disagrees with the CPU: {err}")
        worst = max(worst, err)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return worst


def phase_serving(steps: int) -> dict:
    from http.server import ThreadingHTTPServer

    from eta_inversion_tpu_torch import serve
    from eta_inversion_tpu_torch.serving import EditRequest

    args = serve.parse_args([
        "--model", "sd15", "--inverter", "etainv", "--editor", "ptp",
        "--steps", str(steps), "--dtype", "bfloat16", "--max_batch", "1",
        "--device", "cuda",
        "--inverter_kwargs", json.dumps({"eta": [[0.6, 0.0], [1.0, 0.7]],
                                         "noise_sample_count": 10})])
    t0 = time.monotonic()
    server, pre, post = serve.build_server(args)
    torch.cuda.synchronize()
    log(f"[serving] sd15 etainv+ptp server built in {time.monotonic() - t0:.1f} s "
        f"(random weights, seed 0, bf16), {steps} steps per edit"
        + ("" if steps == 50 else " (below the default 50 to fit the time limit)"))
    cfg = {"is_replace_controller": True, "cross_replace_steps": 0.8,
           "self_replace_steps": 0.5}
    inv_cfg = {"edit_word_idx": [1, 1]}
    rs = np.random.RandomState(1)
    images = [(rs.rand(512, 512, 3) * 255).astype(np.uint8) for _ in range(3)]
    prompts = [("a cat sitting next to a mirror", "a tiger sitting next to a mirror"),
               ("a dog running on the beach", "a wolf running on the beach"),
               ("a red car on a street", "a blue car on a street")]
    httpd = None
    try:
        # warm-up edit (cuBLAS/cuDNN plans, allocator); not counted
        server.edit(pre(images[0]), *prompts[0], cfg=cfg, inv_cfg=inv_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.monotonic()
        # two concurrent submits ...
        futs = [server.submit(EditRequest(pre(images[i]), *prompts[i], cfg=cfg,
                                          inv_cfg=inv_cfg)) for i in (0, 1)]
        # ... and one HTTP POST /v1/edit on 127.0.0.1
        serve.EditHandler.server_ctx = (server, pre, post)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.EditHandler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port = httpd.server_address[1]
        png = io.BytesIO()
        from PIL import Image

        Image.fromarray(images[2]).save(png, "PNG")
        body, ctype = _multipart({"source_prompt": prompts[2][0],
                                  "target_prompt": prompts[2][1],
                                  "cfg": json.dumps(cfg), "inv_cfg": json.dumps(inv_cfg)},
                                 png.getvalue())
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/edit", data=body,
                                     headers={"Content-Type": ctype}, method="POST")
        with urllib.request.urlopen(req, timeout=900) as r:
            http_res = json.loads(r.read())
        results = [f.result(timeout=900) for f in futs]
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        server.shutdown()
        serve.EditHandler.server_ctx = None  # the handler class held the model
    if "image" not in http_res:
        raise RuntimeError(f"HTTP edit failed: {http_res}")
    for i, res in enumerate(results):
        if res is None:
            raise RuntimeError(f"edit {i} returned None")
        img = res["image"]
        if not torch.isfinite(img).all():
            raise RuntimeError(f"edit {i}: non-finite image")
        _check_image(post(img), f"edit {i}", 512)
    _check_image(_png_to_array(http_res["image"]), "HTTP edit", 512)
    log(f"[serving] 3 edits (2 concurrent submits + 1 HTTP POST) in {secs:.2f} s: "
        f"{secs / 3:.2f} s/edit; peak device memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    log(f"[serving] kernel launches during the edits: {json.dumps(counts)}")
    missing = [k for k in FWD_COUNTERS if counts[k] == 0]
    if missing:
        raise RuntimeError(f"main path never launched: {missing}")
    _check_opt_in_idle(counts, "serving")
    return {"seconds_per_edit": secs / 3, "launches": counts, "peak_bytes": peak}


# the batched phase's bucket, and the shared prefix's bound: relative L2 of
# one bf16 UNet call with the prefix against the same call on the tiled
# latent.  A row computed in the same order gives the same bits, but cuDNN
# and the GEMMs may take other algorithms at B rows than at 2B, which moves
# the prefix's bf16 activations by about one rounding (2^-8 of them) that
# the rest of the UNet carries; 1e-2 is a few roundings, while a latent row
# paired with the wrong context row is O(1)
BATCH = 8
PREFIX_RTOL = 1e-2


def _kernel_ms(fn, calls: int = 3) -> float:
    """Summed device-kernel ms of one call of fn (torch.profiler over
    `calls` calls after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / calls
    if total <= 0:
        raise RuntimeError("the profiler recorded no device kernel")
    return total


def _prefix_check(unet) -> dict:
    """One sd15 UNet call at 2B = 8 rows with the CFG shared prefix (B = 4
    latent rows) and without it (the latent tiled): their relative L2
    difference, the summed device-kernel ms of each (torch.profiler, in
    turns: prefix, tiled, tiled, prefix; a UNet call's ~2,300 launches leave
    gaps that host-clock and event timings fold in) and how many K1 launches
    took B rows."""
    b, cfg = BATCH // 2, unet.config
    g = torch.Generator(device="cuda").manual_seed(11)
    lat = torch.randn(b, 4, cfg.sample_size, cfg.sample_size, generator=g, device="cuda")
    ctx = torch.randn(2 * b, 77, cfg.cross_attention_dim, generator=g, device="cuda")
    lat, ctx = lat.to(unet.conv_in.weight.dtype), ctx.to(unet.conv_in.weight.dtype)
    rows = []
    k1 = fa.flash_attention_packed

    def spy(q, *args, **kwargs):
        rows.append(q.shape[0])
        return k1(q, *args, **kwargs)

    def shared():
        return unet(lat, 501, ctx, cfg_shared_prefix=True)

    def full():
        return unet(torch.cat([lat, lat]), 501, ctx)

    fa.flash_attention_packed = spy  # attention_packed looks it up at each call
    try:
        with torch.no_grad():
            got = shared()
            shared_rows = list(rows)
            want = full()
            turns = [_kernel_ms(fn) for fn in (shared, full, full, shared)]
            times = {"shared": [turns[0], turns[3]], "full": [turns[1], turns[2]]}
    finally:
        fa.flash_attention_packed = k1
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    b_rows = sum(r == b for r in shared_rows)
    log(f"[batched] sd15 UNet call at 2B = {2 * b} rows, CFG shared prefix vs the tiled "
        f"latent: rel L2 {rel:.3e} (bound {PREFIX_RTOL}); device kernels "
        f"{times['shared'][0]:.3f} / {times['shared'][1]:.3f} ms a call vs "
        f"{times['full'][0]:.3f} / {times['full'][1]:.3f} tiled (in turns); K1 launches by "
        f"rows with the prefix: "
        f"{sorted(shared_rows)} ({b_rows} at B = {b} rows)")
    if got.shape != want.shape or not (np.isfinite(rel) and rel <= PREFIX_RTOL):
        raise RuntimeError(f"the CFG shared prefix changes the UNet's output: {rel}")
    if b_rows != 1:
        raise RuntimeError(f"expected one K1 launch at B rows (the first 64x64 "
                           f"self-attention), got {shared_rows}")
    return {"prefix_rel_l2": rel, "prefix_ms": times, "k1_b_row_launches": b_rows}


def phase_batched(steps: int) -> dict:
    """Pair-batched serving: an sd15 etainv+ptp server with --max_batch 8
    takes 8 concurrent requests in one bucket-8 dispatch (edit_batch), then
    3 in a bucket-4 dispatch padded by one; two of the 8 pairs again as
    bucket-1 edits (editor.edit), each against its batched result (printed,
    not asserted: etainv's argmin over its candidate noises may flip in
    bf16, and a batch draws its noises as one tensor); then the CFG shared
    prefix on one UNet call."""
    from eta_inversion_tpu_torch import load_editor, load_inverter, serve
    from eta_inversion_tpu_torch.editing.batched import edit_batch
    from eta_inversion_tpu_torch.serving import EditRequest

    inv_kwargs = {"eta": [[0.6, 0.0], [1.0, 0.7]], "noise_sample_count": 10}
    args = serve.parse_args([
        "--model", "sd15", "--inverter", "etainv", "--editor", "ptp", "--steps", str(steps),
        "--dtype", "bfloat16", "--max_batch", str(BATCH), "--device", "cuda",
        "--inverter_kwargs", json.dumps(inv_kwargs)])
    t0 = time.monotonic()
    server, pre, post = serve.build_server(args)
    model = server.editor.inverter.model
    torch.cuda.synchronize()
    log(f"[batched] sd15 etainv+ptp server (--max_batch {BATCH}, buckets {serve.BUCKETS}) "
        f"built in {time.monotonic() - t0:.1f} s (random weights, seed 0, bf16), {steps} steps "
        f"per edit" + ("" if steps == 50 else " (below the default 50 to fit the time limit)"))
    cfg = {"is_replace_controller": True, "cross_replace_steps": 0.8, "self_replace_steps": 0.5}
    inv_cfg = {"edit_word_idx": [1, 1]}
    animals = [("cat", "tiger"), ("dog", "wolf"), ("horse", "zebra"), ("duck", "swan"),
               ("cow", "bull"), ("mouse", "rat"), ("goat", "sheep"), ("fox", "bear")]
    prompts = [(f"a {a} sitting on a bench", f"a {b} sitting on a bench") for a, b in animals]
    rs = np.random.RandomState(3)
    images = [pre((rs.rand(512, 512, 3) * 255).astype(np.uint8)) for _ in range(BATCH)]

    def submit(idx):
        futs = [server.submit(EditRequest(images[i], *prompts[i], cfg=cfg, inv_cfg=inv_cfg))
                for i in idx]
        return [f.result(timeout=1200) for f in futs]

    def check(results, what):
        for i, res in enumerate(results):
            if res is None or not torch.isfinite(res["image"]).all():
                raise RuntimeError(f"{what} {i}: no result or a non-finite image")
            _check_image(post(res["image"]), f"{what} {i}", 512)

    try:
        # warm-up: the bucket-8 shapes' first calls (cuDNN / cuBLAS plans,
        # the allocator) through edit_batch on 2 steps, outside the server
        warm = load_inverter(model, "etainv", num_inference_steps=2, **inv_kwargs)
        edit_batch(load_editor(warm, "ptp"), np.concatenate(images), [p[0] for p in prompts],
                   [p[1] for p in prompts], cfgs=[cfg] * BATCH, inv_cfgs=[inv_cfg] * BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.monotonic()
        batched = submit(range(BATCH))
        torch.cuda.synchronize()
        secs8 = time.monotonic() - t0
        counts = _counts()
        peak8 = torch.cuda.max_memory_allocated()
        stats8 = server.stats_snapshot()
        check(batched, "batched edit")
        if stats8["dispatch_sizes"] != {BATCH: 1} or stats8["padded_slots"] != 0:
            raise RuntimeError(f"{BATCH} concurrent requests were not one bucket-{BATCH} "
                               f"dispatch: {stats8}")
        t0 = time.monotonic()
        check(submit(range(3)), "padded edit")
        torch.cuda.synchronize()
        secs4 = time.monotonic() - t0
        stats = server.stats_snapshot()
        if stats["dispatch_sizes"] != {BATCH: 1, 4: 1} or stats["padded_slots"] != 1:
            raise RuntimeError(f"3 requests were not one bucket-4 dispatch padded by one: {stats}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        solo = [server.edit(images[i], *prompts[i], cfg=cfg, inv_cfg=inv_cfg, timeout=1200)
                for i in (0, 1)]
        torch.cuda.synchronize()
        secs1 = (time.monotonic() - t0) / 2
        peak1 = torch.cuda.max_memory_allocated()
        check(solo, "solo edit")
        stats = server.stats_snapshot()
        if stats["dispatch_sizes"] != {BATCH: 1, 4: 1, 1: 2}:
            raise RuntimeError(f"the solo edits were not bucket-1 dispatches: {stats}")
    finally:
        server.shutdown()
    def rel_l2(key):
        return [((s[key].float() - b[key].float()).norm() / b[key].float().norm()).item()
                for s, b in zip(solo, batched)]

    rel, rel_inv = rel_l2("image"), rel_l2("image_inv")
    log(f"[batched] {BATCH} concurrent requests, one bucket-{BATCH} dispatch: {secs8:.2f} s, "
        f"{secs8 / BATCH:.3f} s/edit, peak device memory {peak8 / 2**30:.2f} GiB; 3 requests "
        f"padded to bucket 4: {secs4:.2f} s, {secs4 / 3:.3f} s/edit; bucket 1: {secs1:.3f} "
        f"s/edit, peak {peak1 / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); stats "
        f"{json.dumps(stats)}")
    log(f"[batched] pairs 0 and 1 as bucket-1 edits against their batched results: rel L2 "
        f"{rel[0]:.3e}, {rel[1]:.3e} (not asserted: other candidate-noise draws, a bf16 "
        f"argmin); their reconstructions (image_inv, the source rows snapped to the "
        f"forward trajectory, no draw): {rel_inv[0]:.3e}, {rel_inv[1]:.3e}")
    log(f"[batched] kernel launches during the bucket-{BATCH} dispatch: {json.dumps(counts)}")
    missing = [k for k in FWD_COUNTERS if counts[k] == 0]
    if missing:
        raise RuntimeError(f"batched path never launched: {missing}")
    _check_opt_in_idle(counts, "batched")
    prefix = _prefix_check(model.unet)
    del model, server
    torch.cuda.empty_cache()
    return {"seconds_per_edit": secs8 / BATCH, "seconds_per_edit_bucket1": secs1,
            "peak_bytes": peak8, "peak_bytes_bucket1": peak1, "launches": counts,
            "solo_rel_l2": rel, "solo_inv_rel_l2": rel_inv, **prefix}


def phase_fp32(steps: int) -> dict:
    """fp32 on the card: one gradient through fp32 self-attention and one
    full-width sd15 fp32 UNet call, each against the plain attention path
    (relative L2), then one sd15 fp32 etainv+ptp edit and one sd15 fp32
    nti+ptp edit served."""
    from eta_inversion_tpu_torch import serve
    from eta_inversion_tpu_torch.models import SD15, init_like_flax_
    from eta_inversion_tpu_torch.models.unet import UNet2DCondition

    flags = {"torch.backends.cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "torch.backends.cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    log(f"[fp32] {json.dumps(flags)} (PyTorch's defaults: fp32 GEMMs in fp32, convolutions "
        f"through cuDNN in TF32); the attention kernels' products are TF32 whatever these say")
    gate = fa._kernel_eligible

    def fp32_routed(counts):  # every K1-K3 launch of an fp32 path is an fp32 kernel's
        fwd = sum(counts[k] for k in FWD_COUNTERS)
        tf32 = counts["flash_attention_narrow_tf32"]
        return tf32 == counts["flash_attention_tf32_prep"] > 0 \
            and tf32 + counts["flash_attention_fwd_fp32"] == fwd

    # one gradient through fp32 self-attention at the UNet's 64x64 level: the
    # TF32 forward with its LSE, K4a / K4b on the narrow backward's TF32 mode
    # from it, after one prep launch
    b, s, h, d = 1, 4096, 8, 40
    base = _inputs("packed_fp32", b, s, h, d, seed=11)

    def grads():
        xs = [x.clone().requires_grad_(True) for x in base]
        torch.sin(fa.attention_packed(*xs, h)).sum().backward()
        return [x.grad for x in xs]

    _reset_counts()
    got = grads()
    torch.cuda.synchronize()
    grad_counts = {k: n for k, n in _counts().items() if n}
    try:
        fa._kernel_eligible = lambda *a, **k: False
        want = grads()
    finally:
        fa._kernel_eligible = gate
    grad_errs = {n: ((g - w).norm() / w.norm()).item() for g, w, n in zip(got, want, "qkv")}
    log(f"[fp32] gradient of sum(sin(o)) through fp32 self-attention at (B, S, H, d) = "
        f"{(b, s, h, d)}: kernels vs plain path rel L2 "
        + ", ".join(f"d{n} {e:.3e}" for n, e in grad_errs.items())
        + f" (bound {FP32_RTOL}); launches {json.dumps(grad_counts)}")
    if not all(np.isfinite(e) and e <= FP32_RTOL for e in grad_errs.values()):
        raise RuntimeError(f"fp32 attention gradient disagrees with the plain path: {grad_errs}")
    want_counts = {"flash_attention_packed": 1, "flash_attention_narrow_tf32": 1,
                   "flash_attention_tf32_prep": 1, "flash_attention_bwd_dq": 1,
                   "flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq_tf32": 1,
                   "flash_attention_bwd_dkv_tf32": 1, "flash_attention_bwd_tf32_prep": 1}
    if grad_counts != want_counts:
        raise RuntimeError(f"fp32 gradient launches {grad_counts}, expected {want_counts}")
    del base, got, want

    # one full-width sd15 UNet call in fp32 at the ptp backward's 4 rows
    t0 = time.monotonic()
    with torch.no_grad(), torch.device("cuda"):
        unet = UNet2DCondition(SD15.unet).requires_grad_(False).eval()
        init_like_flax_(unet, torch.Generator("cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(7)
    lat = torch.randn(FUSED_ROWS, 4, 64, 64, generator=g, device="cuda")
    ctx = torch.randn(FUSED_ROWS, 77, SD15.unet.cross_attention_dim, generator=g, device="cuda")
    _reset_counts()
    with torch.no_grad():
        eps = unet(lat, 501, ctx)
        torch.cuda.synchronize()
        unet_counts = _counts()
        try:
            fa._kernel_eligible = lambda *a, **k: False
            eps_plain = unet(lat, 501, ctx)
        finally:
            fa._kernel_eligible = gate
    unet_err = ((eps - eps_plain).norm() / eps_plain.norm()).item()
    log(f"[fp32] sd15 UNet (random weights, seed 0, fp32) at {FUSED_ROWS} rows, built and "
        f"called twice in {time.monotonic() - t0:.1f} s: kernels vs plain attention path rel L2 "
        f"{unet_err:.3e} (bound {FP32_RTOL}); launches "
        f"{json.dumps({k: n for k, n in unet_counts.items() if n})}")
    if not (torch.isfinite(eps).all() and np.isfinite(unet_err) and unet_err <= FP32_RTOL):
        raise RuntimeError(f"fp32 UNet call disagrees with the plain attention path: {unet_err}")
    if not fp32_routed(unet_counts):
        raise RuntimeError(f"fp32 UNet call: self-attention not on the TF32 mode: {unet_counts}")
    _check_opt_in_idle(unet_counts, "fp32 (the UNet call)", fp32=True)
    del unet, eps, eps_plain
    torch.cuda.empty_cache()

    # one fp32 etainv+ptp edit served
    args = serve.parse_args([
        "--model", "sd15", "--inverter", "etainv", "--editor", "ptp",
        "--steps", str(steps), "--dtype", "float32", "--max_batch", "1", "--device", "cuda",
        "--inverter_kwargs", json.dumps({"eta": [[0.6, 0.0], [1.0, 0.7]],
                                         "noise_sample_count": 10})])
    t0 = time.monotonic()
    server, pre, post = serve.build_server(args)
    torch.cuda.synchronize()
    log(f"[fp32] sd15 etainv+ptp server built in {time.monotonic() - t0:.1f} s (random weights, "
        f"seed 0, fp32), {steps} steps per edit")
    cfg = {"is_replace_controller": True, "cross_replace_steps": 0.8, "self_replace_steps": 0.5}
    image = (np.random.RandomState(3).rand(512, 512, 3) * 255).astype(np.uint8)
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.monotonic()
        res = server.edit(pre(image), "a cat sitting next to a mirror",
                          "a tiger sitting next to a mirror", cfg=cfg,
                          inv_cfg={"edit_word_idx": [1, 1]})
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.shutdown()
    if res is None or not torch.isfinite(res["image"]).all():
        raise RuntimeError("fp32 edit: no result or a non-finite image")
    _check_image(post(res["image"]), "fp32 edit", 512)
    routes = {k: counts[k] for k in FWD_COUNTERS + FP32_COUNTERS}
    log(f"[fp32] 1 edit (the process's first in fp32) in {secs:.2f} s/edit; peak device "
        f"memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); launches by "
        f"route {json.dumps(routes)}")
    if not fp32_routed(counts):
        raise RuntimeError(f"fp32 edit: K1-K3 not on the fp32 kernels: {routes}")
    if counts["flash_attention_fwd_fp32"] == 0:
        raise RuntimeError("fp32 edit: the VAE's d = 512 attention did not run on the "
                           "fp32 route above head dim 128 (flash_attention_bwd_tf32.cu)")
    _check_opt_in_idle(counts, "fp32", fp32=True)
    nti = _fp32_nti_edit()
    for k, n in nti["launches"].items():
        counts[k] += n
    return {"launches": counts, "seconds_per_edit": secs, "peak_bytes": peak,
            "grad_rel_err": grad_errs, "unet_rel_err": unet_err, "allow_tf32": flags,
            "nti": nti}


# steps of phase fp32's nti edit (10 inner steps each): fewer than the bf16
# nti phase's 50, to keep the run inside its time limit
FP32_NTI_STEPS = 10


def _fp32_nti_edit() -> dict:
    """One served sd15 fp32 nti+ptp edit: finite 512x512x3, its s/edit, and
    every backward launch on the narrow backward's TF32 mode, one prep
    launch a pair."""
    from eta_inversion_tpu_torch import serve

    args = serve.parse_args([
        "--model", "sd15", "--inverter", "nti", "--editor", "ptp",
        "--steps", str(FP32_NTI_STEPS), "--dtype", "float32", "--max_batch", "1",
        "--device", "cuda", "--inverter_kwargs", json.dumps({"num_inner_steps": 10})])
    server, pre, post = serve.build_server(args)
    inverter = server.editor.inverter
    cfg = {"is_replace_controller": True, "cross_replace_steps": 0.8, "self_replace_steps": 0.5}
    image = (np.random.RandomState(4).rand(512, 512, 3) * 255).astype(np.uint8)
    try:
        _reset_counts()
        t0 = time.monotonic()
        res = server.edit(pre(image), "a cat sitting next to a mirror",
                          "a tiger sitting next to a mirror", cfg=cfg)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = _counts()
    finally:
        server.shutdown()
    if res is None or not torch.isfinite(res["image"]).all():
        raise RuntimeError("fp32 nti edit: no result or a non-finite image")
    _check_image(post(res["image"]), "fp32 nti edit", 512)
    iters = sum(inverter.last_inner_steps)
    bwd = {k: counts[k] for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                                  "flash_attention_bwd_dq_tf32",
                                  "flash_attention_bwd_dkv_tf32",
                                  "flash_attention_bwd_tf32_prep")}
    log(f"[fp32] 1 sd15 nti+ptp edit in fp32 ({FP32_NTI_STEPS} steps x up to 10 inner "
        f"steps, {iters} inner iterations) in {secs:.2f} s/edit; backward launches "
        f"{json.dumps(bwd)}; forward launches "
        f"{json.dumps({k: counts[k] for k in FWD_COUNTERS + FP32_COUNTERS[:3]})}")
    if not (bwd["flash_attention_bwd_dq_tf32"] == bwd["flash_attention_bwd_dq"] > 0
            and bwd["flash_attention_bwd_dkv_tf32"] == bwd["flash_attention_bwd_dkv"]
            == bwd["flash_attention_bwd_tf32_prep"] == bwd["flash_attention_bwd_dq"]):
        raise RuntimeError(f"fp32 nti edit: the backward not on the TF32 mode: {bwd}")
    _check_opt_in_idle(counts, "fp32 nti", fp32=True)
    return {"launches": counts, "seconds_per_edit": secs, "inner_iterations": iters}


def phase_nti(steps: int, inner: int) -> dict:
    """One served sd15 nti+ptp edit, then the full-width gradient check on
    the same model."""
    from eta_inversion_tpu_torch import serve

    args = serve.parse_args([
        "--model", "sd15", "--inverter", "nti", "--editor", "ptp", "--steps", str(steps),
        "--dtype", "bfloat16", "--max_batch", "1", "--device", "cuda",
        "--inverter_kwargs", json.dumps({"num_inner_steps": inner})])
    t0 = time.monotonic()
    server, pre, post = serve.build_server(args)
    inverter = server.editor.inverter
    torch.cuda.synchronize()
    log(f"[nti] sd15 nti+ptp server built in {time.monotonic() - t0:.1f} s (random weights, "
        f"seed 0, bf16), {steps} steps x up to {inner} inner steps per edit"
        + ("" if (steps, inner) == (50, 10) else
           " (below the default 50 x 10 to fit the time limit)"))
    cfg = {"is_replace_controller": True, "cross_replace_steps": 0.8, "self_replace_steps": 0.5}
    image = (np.random.RandomState(2).rand(512, 512, 3) * 255).astype(np.uint8)
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.monotonic()
        res = server.edit(pre(image), "a cat sitting next to a mirror",
                          "a tiger sitting next to a mirror", cfg=cfg)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.shutdown()
    if res is None or not torch.isfinite(res["image"]).all():
        raise RuntimeError("nti edit: no result or a non-finite image")
    _check_image(post(res["image"]), "nti edit", 512)
    iters = sum(inverter.last_inner_steps)
    log(f"[nti] 1 edit in {secs:.2f} s/edit; peak device memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); {iters} inner iterations "
        f"(UNet forward + backward) over {steps} steps")
    log(f"[nti] kernel launches during the edit: {json.dumps(counts)}")
    # the backward's UNet calls (head dims 40 and 80) on the wgmma kernels,
    # not on flash_attention_bwd.cu
    missing = [k for k in FLASH_COUNTERS if counts[k] - counts.get(k + "_wide", 0) == 0]
    if missing:
        raise RuntimeError(f"nti path never launched: {missing}")
    _check_opt_in_idle(counts, "nti")
    grad = phase_grad_check(inverter)
    return {"seconds_per_edit": secs, "launches": counts, "peak_bytes": peak,
            "inner_iterations": iters, **grad}


def phase_grad_check(inverter, tag: str = "nti") -> dict:
    """One nti inner gradient at the model's full width (UNet forward +
    backward with respect to the null embedding, the nti loss; the UNet's
    output through to_eps) three ways: through the kernels; on the plain
    attention path (the dispatch gate closed, as the CPU takes it); and with
    the self-attention share dropped (the wrappers told no gradient is
    needed: the forward kernel alone, as before K4)."""
    model, t = inverter.model, 501
    s = model.latent_size
    g = torch.Generator(device="cuda").manual_seed(5)
    lat = torch.randn(1, 4, s, s, generator=g, device="cuda")
    target = torch.randn(1, 4, s, s, generator=g, device="cuda")

    def unet(x, t, ctx):
        return inverter.to_eps(model.unet(x, t, ctx), x, t)

    with torch.no_grad():
        uncond, cond = inverter.create_context("a cat sitting next to a mirror").chunk(2)
        eps_cond = unet(lat, t, cond)

    def grad():
        u = uncond.clone().requires_grad_(True)
        eps_u = unet(lat, t, u)
        eps = eps_u + inverter.guidance_scale_bwd * (eps_cond - eps_u)
        loss = torch.mean((inverter.step_backward(eps, t, lat) - target) ** 2)
        (gu,) = torch.autograd.grad(loss, u)
        return gu.float()

    fa.reset_launch_counts()
    g_kernel = grad()
    launched = dict(fa.LAUNCHES)
    share = _profile_gradient(grad, tag)
    gate, needs_grad = fa._kernel_eligible, fa._needs_grad
    try:
        fa._kernel_eligible = lambda *a, **k: False
        g_plain = grad()
        fa._kernel_eligible = gate
        fa._needs_grad = lambda *xs: False
        g_dropped = grad()
    finally:
        fa._kernel_eligible, fa._needs_grad = gate, needs_grad
    ref = g_plain.norm().item()
    err = (g_kernel - g_plain).norm().item() / ref
    err_dropped = (g_dropped - g_plain).norm().item() / ref
    log(f"[{tag}] full-width gradient wrt the null embedding: kernels vs plain attention "
        f"rel L2 {err:.3e} (bound {GRAD_RTOL}); self-attention share dropped vs plain "
        f"{err_dropped:.3e} (must exceed the bound); |g| {ref:.3e}; launches "
        f"K4a {launched['flash_attention_bwd_dq']} K4b {launched['flash_attention_bwd_dkv']}")
    if not (np.isfinite(err) and err <= GRAD_RTOL):
        raise RuntimeError(f"kernel gradient disagrees with the plain path: {err}")
    if not err_dropped > GRAD_RTOL:
        raise RuntimeError(f"the bound does not tell a dropped self-attention gradient: "
                           f"{err_dropped}")
    if launched["flash_attention_bwd_dq"] == 0 or launched["flash_attention_bwd_dkv"] == 0:
        raise RuntimeError("the kernel gradient launched no backward kernel")
    return {"grad_rel_err": err, "grad_rel_err_dropped": err_dropped, **share}


def _profile_gradient(grad, tag: str = "nti") -> dict:
    """Device time of one inner gradient by kernel (torch.profiler) against
    its synchronized wall time: the K4a / K4b share of device time and the
    device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.monotonic()
    grad()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        grad()
        torch.cuda.synchronize()
    evs = prof.key_averages()
    times = {e.key: e.self_device_time_total / 1e3 for e in evs}
    total = sum(times.values())
    # K4a / K4b by name: the wgmma kernels up to head dim 128, all nti's
    # gradients take (flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel)
    k4 = {name: sum(t for key, t in times.items() if name in key)
          for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_narrow_kernel")}
    # launches of each backward instance: its template argument is the head
    # dim padded to 16 (48: the 64x64 level's d = 40, 80: the 32x32 level's)
    launches = {}
    for e in evs:
        m = re.search(r"flash_bwd_\w+<\d+", e.key)
        if m and e.self_device_time_total > 0:
            launches[m.group(0) + ">"] = launches.get(m.group(0) + ">", 0) + e.count
    log(f"[{tag}] one inner gradient: wall {wall_ms:.2f} ms (synchronized, unprofiled); "
        f"device kernels {total:.2f} ms (busy {total / wall_ms:.1%} of the wall); "
        f"K4a {k4['flash_bwd_dq']:.3f} ms + K4b {k4['flash_bwd_dkv']:.3f} ms = "
        f"{(k4['flash_bwd_dq'] + k4['flash_bwd_dkv']) / total:.1%} of device "
        f"time; forward kernel (narrow) {k4['flash_narrow_kernel']:.3f} ms; backward launches "
        f"by instance {json.dumps(launches)}")
    if not launches:
        raise RuntimeError("the profiled inner gradient shows no backward kernel")
    return {"grad_wall_ms": wall_ms, "grad_device_ms": total,
            "k4_device_ms": k4["flash_bwd_dq"] + k4["flash_bwd_dkv"], "k4_launches": launches}


# the editors phase's paths at full width: (label, inverter, its kwargs,
# editor, its kwargs, edit cfg, inv_cfg, the counters that must grow; a
# "_narrow" counter less nothing, K4's less their "_wide" launches).  K2 runs
# where hooks send the 32x32 self-attention to the flat kernel (masactrl and
# pnp from their start layers, ptp's self-replace); invedit carries no hooks,
# so its UNet's self-attention is K1's alone, as in the JAX dispatch
EDITOR_ETA = {"eta": [[0.6, 0.0], [1.0, 0.7]], "noise_sample_count": 10}
EDITOR_WIDX = {"edit_word_idx": [1, 1]}
EDITOR_PTP = {"is_replace_controller": True, "cross_replace_steps": 0.8,
              "self_replace_steps": 0.5}
EDITOR_CAPTION = {"caption": "a cat sitting next to a mirror"}
K1_K3 = ("flash_attention_packed", "flash_attention_bhsd_blockwise")
K3_NARROW = ("flash_attention_bhsd_blockwise_narrow",)
K4 = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# most steps of the edict and pix2pix_zero paths: a pix2pix_zero step is three
# UNet calls and a gradient, edict's two to four calls; at 50 steps the three
# took 58 s of a 102 s phase on the H100, which would put the whole run 37%
# past its 513 s before this phase, so they are cut (the other paths keep
# --steps)
EDITOR_CUT_STEPS = 20
EDITOR_RUNS = [
    ("masactrl substitute + etainv", "etainv", EDITOR_ETA, "masactrl", None, EDITOR_WIDX,
     FWD_COUNTERS + K3_NARROW),
    ("masactrl mask_auto + etainv", "etainv", EDITOR_ETA, "masactrl", {"mode": "mask_auto"},
     EDITOR_WIDX, K1_K3),
    ("pnp + etainv", "etainv", EDITOR_ETA, "pnp", None, EDITOR_WIDX, FWD_COUNTERS + K3_NARROW),
    ("invedit + etainv", "etainv", EDITOR_ETA, "invedit", None, EDITOR_WIDX, K1_K3),
    ("pix2pix_zero + diffinv", "diffinv", {}, "pix2pix_zero", EDITOR_CAPTION, None, K1_K3 + K4),
    ("edict + ptp", "edict", {}, "ptp", EDITOR_PTP, None, FWD_COUNTERS),
    ("pix2pix_zero + edict", "edict", {}, "pix2pix_zero", EDITOR_CAPTION, None, K1_K3 + K4),
    ("regdiffinv + ptp", "regdiffinv", {}, "ptp", EDITOR_PTP, None, FWD_COUNTERS),
]


def _launched(counts: dict, need) -> list:
    """The counters of `need` that did not grow (K4a / K4b less their launches
    above head dim 128)."""
    return [k for k in need if counts[k] - counts.get(k + "_wide", 0) == 0]


def phase_editors(steps: int) -> dict:
    """The other editors and inverters at sd15 width, bf16, random weights
    from seed 0, each once in this process through load_inverter /
    load_editor / editor.edit (EDITOR_RUNS; the edict and pix2pix_zero paths
    at min(steps, EDITOR_CUT_STEPS), the others at `steps`), then one
    bucket-2 edit_batch of pnp + etainv and the pix2pix_zero guidance
    gradient checks.  Each path: s/edit, peak device memory, its launches,
    finite 512x512x3 outputs, its kernels launched, K5 / K6 / the
    microbenchmarks' and the fp32 kernels idle."""
    from eta_inversion_tpu_torch import load_editor, load_inverter
    from eta_inversion_tpu_torch.editing.batched import edit_batch
    from eta_inversion_tpu_torch.models import load_diffusion_model

    cut_steps = min(steps, EDITOR_CUT_STEPS)
    t0 = time.monotonic()
    model, (pre, post) = load_diffusion_model("sd15", dtype="bfloat16", seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[editors] sd15 model built in {time.monotonic() - t0:.1f} s (random weights, seed 0, "
        f"bf16); {steps} steps, the edict and pix2pix_zero paths {cut_steps}"
        + ("" if cut_steps == steps else " (cut to fit the time limit)"))
    src, tgt = "a cat sitting next to a mirror", "a tiger sitting next to a mirror"
    rs = np.random.RandomState(4)
    images = [pre((rs.rand(512, 512, 3) * 255).astype(np.uint8)) for _ in range(2)]
    total = {k: 0 for k in _counts()}
    runs = []

    def check_images(img, what):
        if img is None or not torch.isfinite(img).all():
            raise RuntimeError(f"{what}: no result or a non-finite image")
        for row in img:
            _check_image(post(row), what, 512)

    for label, inverter, inv_kwargs, editor, cfg, inv_cfg, need in EDITOR_RUNS:
        n = cut_steps if ("edict" in label or "pix2pix" in label) else steps
        inv = load_inverter(model, inverter, num_inference_steps=n, **inv_kwargs)
        ed = load_editor(inv, editor)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.monotonic()
        res = ed.edit(images[0], src, tgt, cfg=None if cfg is None else dict(cfg),
                      inv_cfg=None if inv_cfg is None else dict(inv_cfg))
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts, peak = _counts(), torch.cuda.max_memory_allocated()
        check_images(None if res is None else res["image"], label)
        extra = ""
        if inverter == "edict" and "latent_inv" in res:
            # the reconstruction: the x chain against the encoded image
            with torch.no_grad():
                z0 = inv.encode(images[0])[0]
            rec = ((res["latent_inv"].float() - z0).norm() / z0.norm()).item()
            extra = f"; reconstruction (latent_inv vs the encoded image) rel L2 {rec:.3e}"
        missing = _launched(counts, need)
        log(f"[editors] {label}: {secs:.2f} s/edit at {n} steps, peak device memory "
            f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated){extra}; launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
        if missing:
            raise RuntimeError(f"{label} never launched {missing}")
        _check_opt_in_idle(counts, label)
        for k, v in counts.items():
            total[k] += v
        runs.append({"run": label, "steps": n, "seconds_per_edit": secs, "peak_bytes": peak,
                     "launches": {k: v for k, v in counts.items() if v}})
        del inv, ed, res
        torch.cuda.empty_cache()

    # one bucket-2 edit_batch of pnp + etainv: 3B = 6 UNet rows, eps to 4B
    ed = load_editor(load_inverter(model, "etainv", num_inference_steps=steps, **EDITOR_ETA),
                     "pnp")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.monotonic()
    res = edit_batch(ed, np.concatenate(images), [src, "a dog running on the beach"],
                     [tgt, "a wolf running on the beach"], inv_cfgs=[EDITOR_WIDX] * 2)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    counts, peak = _counts(), torch.cuda.max_memory_allocated()
    check_images(None if res is None else res["image"], "pnp + etainv bucket 2")
    if res["image"].shape[0] != 2:
        raise RuntimeError(f"pnp bucket 2: {res['image'].shape[0]} images")
    log(f"[editors] pnp + etainv, edit_batch at B = 2: {secs:.2f} s, {secs / 2:.2f} s/edit, "
        f"peak device memory {peak / 2**30:.2f} GiB; launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    missing = _launched(counts, FWD_COUNTERS + K3_NARROW)
    if missing:
        raise RuntimeError(f"pnp bucket 2 never launched {missing}")
    _check_opt_in_idle(counts, "pnp bucket 2")
    for k, v in counts.items():
        total[k] += v
    runs.append({"run": "pnp + etainv bucket 2", "steps": steps, "seconds_per_edit": secs / 2,
                 "peak_bytes": peak, "launches": {k: v for k, v in counts.items() if v}})
    del ed, res
    grad = _p2p_grad_check(model)
    del model
    torch.cuda.empty_cache()
    return {"launches": total, "runs": runs, **grad}


@contextmanager
def widened_fp32(model, exact: bool = True):
    """The model widened to fp32 (its bf16 weights, exactly) inside the
    block; `exact`: attention on the plain path and TF32 off for the
    matmuls and convolutions, else on the TF32 attention kernels.  The
    model goes back to bf16 after (a lossless round trip)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    gate = fa._kernel_eligible
    model.nets.float()
    try:
        if exact:
            fa._kernel_eligible = lambda *a, **k: False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        yield
    finally:
        fa._kernel_eligible = gate
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        model.nets.to(torch.bfloat16)


@contextmanager
def attention_route(route: str):
    """"kernels" (as served), "plain" (the dispatch gate closed) or
    "dropped" (the wrappers told no gradient is needed: the self-attention
    share of a gradient is lost, what autograd got before the backward
    kernels)."""
    gate, needs_grad = fa._kernel_eligible, fa._needs_grad
    try:
        if route == "plain":
            fa._kernel_eligible = lambda *a, **k: False
        elif route == "dropped":
            fa._needs_grad = lambda *xs: False
        yield
    finally:
        fa._kernel_eligible, fa._needs_grad = gate, needs_grad


def p2p_gradient_inputs(model) -> dict:
    """The inputs of one pix2pix_zero guidance gradient at sd15 width (seed
    7): the source latent, a target drawn apart from it and one near it
    (source + 0.1 noise, as early in an edit), the caption's context and
    the target context (the caption plus the cat -> tiger direction)."""
    from eta_inversion_tpu_torch import load_editor, load_inverter

    inv = load_inverter(model, "diffinv")
    ed = load_editor(inv, "pix2pix_zero")
    g = torch.Generator(device="cuda").manual_seed(7)
    src = torch.randn(1, 4, 64, 64, generator=g, device="cuda")
    noise = torch.randn(1, 4, 64, 64, generator=g, device="cuda")
    targets = {"apart": torch.randn(1, 4, 64, 64, generator=g, device="cuda"),
               "near": src + 0.1 * noise}
    caption = EDITOR_CAPTION["caption"]
    with torch.no_grad():
        ctx = inv.create_context(caption, negative_prompt=caption)
        tgt_ctx = ctx.clone()
        tgt_ctx[1:2] += ed.construct_direction("a cat sitting next to a mirror",
                                               "a tiger sitting next to a mirror")
    return {"inv": inv, "ed": ed, "t": 501, "src": src, "targets": targets, "ctx": ctx,
            "tgt_ctx": tgt_ctx}


def p2p_gradient(p: dict, target: str) -> torch.Tensor:
    """The map loss of the CFG-duplicated 2-row UNet call against the
    source's stored cross maps, differentiated with respect to the target
    latent; the source's maps by the same attention path as the gradient's,
    as an edit computes both."""
    from eta_inversion_tpu_torch.editing.pix2pix_zero import StoreAllCrossHooks

    inv = p["inv"]
    with torch.no_grad():
        _, ref = inv.predict_noise(p["src"], p["t"], p["ctx"], inv.guidance_scale_bwd,
                                   hooks=StoreAllCrossHooks(), collect_store=True)
    return p["ed"].guidance_grad(p["targets"][target], p["t"], p["tgt_ctx"], ref).float()


def _p2p_grad_check(model) -> dict:
    """The pix2pix_zero guidance gradient at sd15 width through the kernels
    (K1 forward, K4a / K4b backward).  With the target drawn apart from the
    source: against the plain attention path, relative L2 within GRAD_RTOL.
    With the target near it: against the model widened to exact fp32 (the
    witness), the kernels' distance at most P2P_WITNESS_RATIO times the
    plain path's."""
    p = p2p_gradient_inputs(model)
    out = {}
    for target in ("apart", "near"):
        _reset_counts()
        g_kernel = p2p_gradient(p, target)
        launched = _counts()
        if _launched(launched, K4):
            raise RuntimeError("the pix2pix_zero gradient launched no backward kernel")
        with attention_route("plain"):
            g_plain = p2p_gradient(p, target)
        rel = (g_kernel - g_plain).norm().item() / g_plain.norm().item()
        msg = (f"[editors] full-width pix2pix_zero guidance gradient wrt the latent, target "
               f"{target}: kernels vs plain attention rel L2 {rel:.3e}")
        out[target] = {"rel_err": rel}
        if target == "near":
            with widened_fp32(model):
                g_exact = p2p_gradient(p, target)
            ref = g_exact.norm().item()
            err_k = (g_kernel - g_exact).norm().item() / ref
            err_p = (g_plain - g_exact).norm().item() / ref
            msg += (f"; from the exact fp32 gradient: kernels {err_k:.3e}, plain {err_p:.3e} "
                    f"(kernels at most {P2P_WITNESS_RATIO} x plain)")
            out[target].update(exact_err_kernels=err_k, exact_err_plain=err_p)
            ok = np.isfinite(err_k) and err_k <= P2P_WITNESS_RATIO * err_p
        else:
            msg += f" (bound {GRAD_RTOL})"
            ok = np.isfinite(rel) and rel <= GRAD_RTOL
        log(f"{msg}; |g| {g_plain.norm().item():.3e}; launches K1 "
            f"{launched['flash_attention_packed']} K4a {launched['flash_attention_bwd_dq']} "
            f"K4b {launched['flash_attention_bwd_dkv']}")
        if not ok:
            raise RuntimeError(f"pix2pix_zero kernel gradient, target {target}: {out[target]}")
    return {"p2p_grad": out}


def _rss_bytes() -> int:
    """This process's resident set size (VmRSS of /proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class _RssPeak:
    """The largest VmRSS seen while the block runs, sampled every 10 ms."""

    def __enter__(self):
        self.peak, self._stop = _rss_bytes(), threading.Event()

        def sample():
            while not self._stop.wait(0.01):
                self.peak = max(self.peak, _rss_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())


def phase_checkpoint(ckpt: str) -> dict:
    """The sd15 random init (fp32, seed 0) written as a diffusers-layout
    directory with the port's writer and inverse key maps
    (models/weights.save_pretrained), loaded back in bf16 through
    load_diffusion_model(weights_dir=...): one UNet call (2 rows) and one
    VAE decode must give the bits of the in-memory model cast to bf16.
    Prints the write and load times and the host's RSS during the load."""
    from eta_inversion_tpu_torch.models import load_diffusion_model
    from eta_inversion_tpu_torch.models.weights import save_pretrained

    t0 = time.monotonic()
    model, _ = load_diffusion_model("sd15", dtype="float32", seed=0, device="cuda")
    save_pretrained(model.nets, ckpt, model.preset)
    write_s = time.monotonic() - t0
    nbytes = sum(f.stat().st_size for f in Path(ckpt).rglob("*.safetensors"))
    model.nets.to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(21)
    lat = torch.randn(2, 4, 64, 64, generator=g, device="cuda")
    ctx = torch.randn(2, 77, 768, generator=g, device="cuda")
    z = torch.randn(1, 4, 64, 64, generator=g, device="cuda")

    def outputs(m):
        with torch.no_grad():
            return m.unet(lat, 501, ctx), m.vae.decode(z)

    want = outputs(model)
    torch.cuda.synchronize()
    del model
    torch.cuda.empty_cache()
    _reset_counts()
    with _RssPeak() as rss:
        before = _rss_bytes()
        t0 = time.monotonic()
        loaded, _ = load_diffusion_model("sd15", dtype="bfloat16", weights_dir=ckpt,
                                         device="cuda")
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
    got = outputs(loaded)
    torch.cuda.synchronize()
    counts = _counts()
    for g_, w, what in zip(got, want, ("UNet call", "VAE decode")):
        if not torch.equal(g_, w):
            raise RuntimeError(f"checkpoint: the loaded model's {what} differs from the "
                               f"in-memory model's (max |diff| "
                               f"{(g_.float() - w.float()).abs().max().item()})")
    log(f"[checkpoint] sd15 random init written as a diffusers-layout directory: "
        f"{nbytes / 1e9:.2f} GB of fp32 safetensors in {write_s:.1f} s (model init included)")
    log(f"[checkpoint] loaded in bf16 in {load_s:.2f} s; host RSS {before / 2**30:.2f} GiB "
        f"before the load, peak {rss.peak / 2**30:.2f} GiB during it (VmRSS sampled every "
        f"10 ms); one UNet call (2 rows) and one VAE decode bit-equal to the in-memory model's")
    del loaded
    torch.cuda.empty_cache()
    return {"launches": counts, "load_seconds": load_s, "write_seconds": write_s,
            "checkpoint_bytes": nbytes, "rss_before": before, "rss_peak": rss.peak}


# the cli phase's runs: (entry point, --inv_method, --edit_method or None,
# --method_cfg); the first is the main path through its user entry point
CLI_RUNS = [("edit_image", "etainv", "ptp", "{}"),
            ("edit_image", "etainv", "pnp", "{}"),
            ("edit_image", "dirinv", "ptp", "{}"),
            ("edit_image", "ddpminv", "ptp", "{}"),
            ("edit_image", "cyclediff", "simple", "{}"),
            ("edit_image", "proxnpi", "ptp", "{}"),
            ("edit_image", "diffinv", "ptp", '{"scheduler": "dpm", "solver_order": 3}'),
            ("edit_image", "diffinv", "ptp", '{"scheduler": "ddpm"}'),
            ("invert_image", "diffinv", None, "{}")]
# the forward kernels every run must launch: K1 (the UNet's self-attention)
# and K3 (the VAE's); K2 too under ptp and pnp, whose hooks send the 32x32
# self-attention to the flat one-pass kernel
CLI_COUNTERS = ("flash_attention_packed", "flash_attention_bhsd_blockwise")


def _cli_process(cmd, out: Path, label: str, size: int, need) -> tuple:
    """Run one entry-point process (`cmd`, writing `out`): it must exit 0,
    print its "Took" and "kernel launches" lines, write a size x size x 3
    PNG that is not flat, and have launched the kernels of `need` and none
    of K5, K6, the microbenchmarks' or the fp32 kernels.  (s/edit from its
    "Took" line, the process's wall seconds, its launches by counter.)"""
    from PIL import Image

    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"cli {label}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    took = re.search(r"^Took ([0-9.]+)s$", proc.stdout, re.M)
    launches = re.search(r"^kernel launches (\{.*\})$", proc.stdout, re.M)
    if not (took and launches):
        raise RuntimeError(f"cli {label}: no Took / kernel launches line in\n{proc.stdout}")
    counts = {k: 0 for k in _counts()}
    counts.update(json.loads(launches.group(1)))
    arr = np.asarray(Image.open(out))
    _check_image(arr, f"cli {label}", size)
    if arr.std() == 0:
        raise RuntimeError(f"cli {label}: a flat image")
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise RuntimeError(f"cli {label}: never launched {missing}")
    _check_opt_in_idle(counts, f"cli {label}")
    return float(took.group(1)), wall, counts


def phase_cli(ckpt: str, steps: int) -> dict:
    """The port's entry points as a user runs them, one process each:
    python -m eta_inversion_tpu_torch.edit_image / .invert_image on the
    checkpoint directory of the checkpoint phase, bf16, a generated 512x512
    PNG, `steps` steps (CLI_RUNS).  Each must write a 512x512x3 PNG that is
    not flat, and report (its "kernel launches" line) K1 and K3 launches
    (and K2's under ptp) and none of K5, K6, the microbenchmarks' or the
    fp32 kernels.  Prints
    each run's s/edit (its "Took" line) beside the card's name and power
    limit."""
    from PIL import Image

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    work = Path(ckpt) / "cli"
    work.mkdir()
    png = work / "in.png"
    Image.fromarray((np.random.RandomState(3).rand(512, 512, 3) * 255).astype(np.uint8)).save(png)
    src, tgt = "a cat sitting next to a mirror", "a tiger sitting next to a mirror"
    total = {k: 0 for k in _counts()}
    runs = []
    for entry, inv, ed, mcfg in CLI_RUNS:
        out = work / f"{entry}_{inv}_{ed}_{len(runs)}.png"
        cmd = [sys.executable, "-m", f"eta_inversion_tpu_torch.{entry}", "-i", str(png),
               "-o", str(out), "--model", "sd15", "--dtype", "bfloat16", "--steps", str(steps),
               "--weights_dir", ckpt, "--inv_method", inv, "--method_cfg", mcfg]
        cmd += ["-s", src, "-t", tgt, "--edit_method", ed] if ed else ["-p", src]
        label = f"{entry} {inv}" + (f"+{ed}" if ed else "") + ("" if mcfg == "{}" else f" {mcfg}")
        need = FWD_COUNTERS if ed in ("ptp", "pnp") else CLI_COUNTERS
        secs, wall, counts = _cli_process(cmd, out, label, 512, need)
        for k, v in counts.items():
            total[k] += v
        log(f"[cli] {label}: {secs:.2f} s/edit at {steps} steps ({smi}); the process "
            f"{wall:.1f} s (start, kernel libraries, checkpoint load); launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
        runs.append({"run": label, "seconds_per_edit": secs, "process_seconds": wall,
                     "launches": {k: v for k, v in counts.items() if v}})
    return {"launches": total, "runs": runs}


# the families phase: (preset, steps) of its etainv+ptp edits at full width;
# sd21 at the main path's 50 steps, the larger sd21v (768 px) and sdxl (1024
# px) at 20 to fit the time limit
FAMILY_RUNS = [("sd21", 50), ("sd21v", 20), ("sdxl", 20)]
# nti + ptp on sdxl: steps x inner iterations
FAMILY_NTI = (5, 2)
# the tiny homologues' paths, card against CPU
FAMILY_TINY_PATHS = [TINY_PATHS[0], ("diffinv", {}, "simple", {}, None, None),
                     ("nti", {"num_inner_steps": 2}, "ptp", {}, TINY_PTP, None)]
# the CLI run on sdxl (random weights)
FAMILY_CLI_STEPS = 4
# the text towers in bf16 against the same weights in fp32 (relative L2 of
# the context): bf16 keeps 8 mantissa bits, a rounding of 2^-9 relative per
# product, compounded through up to 32 residual layers (sdxl's bigG) and the
# un-normed penultimate states; a wrong activation (quick-gelu for gelu)
# or a dropped layer is O(1)
TEXT_BF16_RTOL = 5e-2


def _family_launches(metas, steps: int) -> dict:
    """The launches one etainv+ptp edit should make, from the layer counts:
    the forward loop's one-row UNet calls send every self-attention layer of
    S >= 1024 to K1 (the eta mask stores cross maps only); the backward's
    four-row calls send the layers above ptp's 32x32 threshold to K1 and
    those at 32x32 (S = 1024) to K2 (the q/k substitution, flat); below
    S = 1024 the plain path; the VAE's one attention layer is one K3 launch
    in the encode and one in the decode (both images in one call)."""
    selfs = [m for ms in metas.values() for m in ms if not m.is_cross and m.res ** 2 >= 1024]
    big = sum(1 for m in selfs if m.res > 32)
    at32 = sum(1 for m in selfs if m.res == 32)
    return {"flash_attention_packed": steps * (big + at32) + steps * big,
            "flash_attention_bhsd_onepass": steps * at32,
            "flash_attention_bhsd_blockwise": 2}


def _text_bf16_vs_fp32(model, prompt: str) -> float:
    """Relative L2 of the bf16 context (both towers; sdxl's packed row) from
    the same weights widened to fp32 (exact), text towers only."""
    ids = model.tokenizer([prompt])
    towers = [k for k in ("text", "text2") if k in model.nets]
    with torch.no_grad():
        bf = model.encode_text(ids).float()
        dt = model.dtype
        for k in towers:
            model.nets[k].float()
        model.dtype = torch.float32
        try:
            fp = model.encode_text(ids).float()
        finally:
            for k in towers:
                model.nets[k].to(dt)
            model.dtype = dt
    return ((bf - fp).norm() / fp.norm()).item()


def _family_nti(model, pre, post, image) -> dict:
    """A short sdxl nti + ptp edit (FAMILY_NTI): the packed context row (77)
    of every optimized null embedding must equal the unconditional
    context's; then the inner gradient check (kernels against the plain
    path within GRAD_RTOL)."""
    from eta_inversion_tpu_torch import load_editor, load_inverter

    steps, inner = FAMILY_NTI
    inv = load_inverter(model, "nti", num_inference_steps=steps, num_inner_steps=inner)
    seen = {}
    optimize = inv.null_optimization

    def spy(latents, context):
        seen["out"], seen["context"] = optimize(latents, context), context
        return seen["out"]

    inv.null_optimization = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.monotonic()
    res = load_editor(inv, "ptp").edit(image, "a cat sitting next to a mirror",
                                       "a tiger sitting next to a mirror", cfg=dict(EDITOR_PTP))
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    counts, peak = _counts(), torch.cuda.max_memory_allocated()
    size = model.image_size
    if res is None or not torch.isfinite(res["image"]).all():
        raise RuntimeError("sdxl nti+ptp: no result or a non-finite image")
    _check_image(post(res["image"]), "sdxl nti+ptp", size)
    ue, row = seen["out"]["uncond_embeddings"], seen["context"][:1, 77]
    moved = max((ue[i, :, 77].float() - row.float()).abs().max().item() for i in range(steps))
    text_moved = (ue[-1, :, :77].float() - seen["context"][:1, :77].float()).abs().max().item()
    log(f"[families] sdxl nti+ptp ({steps} steps x up to {inner} inner): {secs:.2f} s/edit, "
        f"peak device memory {peak / 2**30:.2f} GiB; packed row 77 of the null embeddings: max "
        f"|change| {moved} over {steps} steps (must be 0), text rows {text_moved:.3e}; launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    if moved != 0.0 or not text_moved > 0:
        raise RuntimeError(f"sdxl nti moved the packed row ({moved}) or left the text rows "
                           f"({text_moved})")
    missing = _launched(counts, FWD_COUNTERS + K4)
    if missing:
        raise RuntimeError(f"sdxl nti+ptp never launched {missing}")
    _check_opt_in_idle(counts, "sdxl nti+ptp")
    grad = phase_grad_check(inv, tag="families")
    return {"seconds_per_edit": secs, "peak_bytes": peak, "launches": counts, **grad}


def _family_cli(steps: int) -> dict:
    """python -m eta_inversion_tpu_torch.edit_image --model sdxl (random
    weights, bf16) as a user runs it: a 1024x1024x3 PNG, K1-K3 launched."""
    from PIL import Image

    work = Path(tempfile.mkdtemp(prefix="families-cli-", dir=ROOT / "build"))
    try:
        png, out = work / "in.png", work / "out.png"
        Image.fromarray((np.random.RandomState(5).rand(1024, 1024, 3) * 255)
                        .astype(np.uint8)).save(png)
        cmd = [sys.executable, "-m", "eta_inversion_tpu_torch.edit_image", "-i", str(png),
               "-o", str(out), "--model", "sdxl", "--dtype", "bfloat16", "--steps", str(steps),
               "--inv_method", "etainv", "--edit_method", "ptp",
               "-s", "a cat sitting next to a mirror", "-t", "a tiger sitting next to a mirror"]
        secs, wall, counts = _cli_process(cmd, out, "sdxl etainv+ptp", 1024, FWD_COUNTERS)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[families] cli edit_image --model sdxl etainv+ptp: {secs:.2f} s/edit "
        f"at {steps} steps; the process {wall:.1f} s (start, kernel libraries, random init); "
        f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
    return {"seconds_per_edit": secs, "process_seconds": wall, "launches": counts}


def phase_families() -> dict:
    """The other model families at full published width and depth, bf16,
    random weights from seed 0, one model at a time (built, used, freed):
    an etainv+ptp edit through load_inverter / load_editor / editor.edit
    on sd21 (512 px), sd21v (768 px, v-prediction) and sdxl (1024 px)
    (FAMILY_RUNS), each a finite image of the preset's size, with s/edit,
    peak device memory and its launches against the layer counts'
    prediction (_family_launches); each model's text towers in bf16 against
    fp32; on sdxl a short nti + ptp edit with the packed row checked and the
    inner gradient check.  Then the tiny homologues card against CPU and one
    edit_image process on sdxl."""
    from eta_inversion_tpu_torch import load_editor, load_inverter
    from eta_inversion_tpu_torch.models import load_diffusion_model

    total = {k: 0 for k in _counts()}
    runs = []

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    src, tgt = "a cat sitting next to a mirror", "a tiger sitting next to a mirror"
    for name, steps in FAMILY_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        model, (pre, post) = load_diffusion_model(name, dtype="bfloat16", seed=0, device="cuda")
        torch.cuda.synchronize()
        build_s, build_peak = time.monotonic() - t0, torch.cuda.max_memory_allocated()
        size = model.image_size
        text_err = _text_bf16_vs_fp32(model, src)
        log(f"[families] {name} built in {build_s:.1f} s (random weights, seed 0, bf16; peak "
            f"device memory {build_peak / 2**30:.2f} GiB while built: fp32 draws, then cast); "
            f"{size} px, {model.latent_size}x{model.latent_size} latents, "
            f"{sum(len(ms) for ms in model.attn_metas.values())} attention layers; text "
            f"context bf16 vs fp32 rel L2 {text_err:.3e} (bound {TEXT_BF16_RTOL})")
        if not text_err <= TEXT_BF16_RTOL:
            raise RuntimeError(f"{name}: the bf16 text towers drift from fp32: {text_err}")
        image = pre((np.random.RandomState(6).rand(size, size, 3) * 255).astype(np.uint8))
        inv = load_inverter(model, "etainv", num_inference_steps=steps, **EDITOR_ETA)
        ed = load_editor(inv, "ptp")
        predicted = _family_launches(model.attn_metas, steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.monotonic()
        res = ed.edit(image, src, tgt, cfg=dict(EDITOR_PTP), inv_cfg=dict(EDITOR_WIDX))
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts, peak = _counts(), torch.cuda.max_memory_allocated()
        for key in ("image", "image_inv"):
            if res is None or not torch.isfinite(res[key]).all():
                raise RuntimeError(f"{name} etainv+ptp: no result or a non-finite {key}")
            _check_image(post(res[key]), f"{name} etainv+ptp {key}", size)
        got = {k: counts[k] for k in predicted}
        log(f"[families] {name} etainv+ptp: {secs:.2f} s/edit at {steps} steps, {size} px; peak "
            f"device memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
            f"launches {json.dumps({k: v for k, v in counts.items() if v})}; predicted from the "
            f"layer counts {json.dumps(predicted)}")
        missing = _launched(counts, [k for k, v in predicted.items() if v])
        if missing:
            raise RuntimeError(f"{name} etainv+ptp never launched {missing}")
        if got != predicted:
            raise RuntimeError(f"{name} etainv+ptp launches {got}, layer counts say {predicted}")
        _check_opt_in_idle(counts, f"{name} etainv+ptp")
        add(counts)
        runs.append({"run": f"{name} etainv+ptp", "steps": steps, "size": size,
                     "seconds_per_edit": secs, "peak_bytes": peak, "build_seconds": build_s,
                     "text_bf16_rel_l2": text_err, "launches": got})
        del inv, ed, res
        if name == "sdxl":
            nti = _family_nti(model, pre, post, image)
            add(nti.pop("launches"))
            runs.append({"run": "sdxl nti+ptp", **nti})
        del model, pre, post
    torch.cuda.empty_cache()
    for preset in ("tiny21", "tinyv", "tinyxl"):
        phase_tiny_reference(preset, FAMILY_TINY_PATHS, tag="families")
    cli = _family_cli(FAMILY_CLI_STEPS)
    add(cli.pop("launches"))
    runs.append({"run": "cli sdxl etainv+ptp", **cli})
    return {"launches": total, "runs": runs}


def _multipart(fields: dict, png: bytes):
    boundary = "----etainvsmoke"
    parts = []
    for k, v in fields.items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\""
                     f"\r\n\r\n{v}\r\n".encode())
    parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
                 f"filename=\"in.png\"\r\nContent-Type: image/png\r\n\r\n".encode()
                 + png + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


PHASES = ("device", "build", "kernels", "fused", "microbench", "serving", "batched", "fp32",
          "nti", "editors", "families", "checkpoint", "cli")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    # the sd15 nti edit at 25 steps (the inverter's default is 50): it took
    # 92-111 s of a 762 s run at 50 once the families phase came (PR 20)
    ap.add_argument("--nti_steps", type=int, default=25)
    ap.add_argument("--nti_inner", type=int, default=10)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    name = phase_device()
    if "build" in phases:
        phase_build()
    rows = phase_kernels() if "kernels" in phases else []
    by_phase = {}
    if "kernels" in phases:
        by_phase["vae_grad"] = phase_vae_grad()
        by_phase["vae_grad_fp32"] = phase_vae_grad(torch.float32)
    if "fused" in phases:
        by_phase["fused"] = phase_fused()["launches"]
    if "microbench" in phases:
        by_phase["microbench"] = phase_microbench()["launches"]
    if "serving" in phases:
        phase_tiny_reference()
        by_phase["serving"] = phase_serving(args.steps)["launches"]
    if "batched" in phases:
        by_phase["batched"] = phase_batched(args.steps)["launches"]
    if "fp32" in phases:
        by_phase["fp32"] = phase_fp32(args.steps)["launches"]
    if "nti" in phases:
        by_phase["nti"] = phase_nti(args.nti_steps, args.nti_inner)["launches"]
    if "editors" in phases:
        by_phase["editors"] = phase_editors(args.steps)["launches"]
    if "families" in phases:
        (ROOT / "build").mkdir(exist_ok=True)
        by_phase["families"] = phase_families()["launches"]
    if "checkpoint" in phases or "cli" in phases:
        # the sd15 checkpoint (fp32, about 4.3 GB) lives under build/ for the
        # two phases and goes with them
        (ROOT / "build").mkdir(exist_ok=True)
        ckpt = tempfile.mkdtemp(prefix="checkpoint-", dir=ROOT / "build")
        try:
            if "checkpoint" not in phases:
                raise RuntimeError("the cli phase runs on the checkpoint phase's directory")
            by_phase["checkpoint"] = phase_checkpoint(ckpt)["launches"]
            if "cli" in phases:
                by_phase["cli"] = phase_cli(ckpt, args.steps)["launches"]
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
    for r in rows:
        counter, exclude, skip = r.pop("counter"), r.pop("exclude"), r.pop("skip_phases")
        r["launches_by_phase"] = {p: c[counter] - (c[exclude] if exclude else 0)
                                  for p, c in by_phase.items() if p not in skip}
        r["launches"] = sum(r["launches_by_phase"].values())
    print(json.dumps({"kernels": rows}))
    if set(phases) != set(PHASES):
        log(f"partial run ({args.phases}): no result line")
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
