"""Prompt-to-prompt editing (registry key "ptp") as attention hooks.

Counterpart of eta_inversion_tpu/editing/ptp.py:

  * `PtpHooks` -- per-layer edits: cross-attention replace / refine / reweight
    on materialized probabilities, and self-attention replacement at
    res^2 <= 32^2 as a q/k substitution (the attention kernel then computes
    softmax(q_src k_src^T) v_tgt without materializing probabilities);
  * `PtpController` -- accumulated attention-map sums, time-word alphas,
    equalizer and LocalBlend;
  * `AttnStoreController` -- map accumulation without edits (eta-inversion's
    forward masks);
  * host-side numpy tables (word alphas, seq_aligner mappers).

The value-folded cross edit the JAX package switches on only on a TPU
(`cross_fold`) is not ported: the port takes the materialized-probability
path (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attn_ctrl import AttnHooks, AttnLayerMeta
from . import seq_aligner
from .controller import BatchLayout, Controller
from .editor import ControllerBasedEditor

MAX_NUM_WORDS = 77


# ---------------------------------------------------------------------------
# host-side alpha tables
# ---------------------------------------------------------------------------

def update_alpha_time_word(alpha: np.ndarray, bounds, prompt_ind: int,
                           word_inds: Optional[np.ndarray] = None) -> np.ndarray:
    if isinstance(bounds, float):
        bounds = (0.0, bounds)
    start, end = int(bounds[0] * alpha.shape[0]), int(bounds[1] * alpha.shape[0])
    if word_inds is None:
        word_inds = np.arange(alpha.shape[2])
    alpha[:start, prompt_ind, word_inds] = 0
    alpha[start:end, prompt_ind, word_inds] = 1
    alpha[end:, prompt_ind, word_inds] = 0
    return alpha


def get_time_words_attention_alpha(prompts: Sequence[str], num_steps: int,
                                   cross_replace_steps, tokenizer,
                                   max_num_words: int = MAX_NUM_WORDS) -> np.ndarray:
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)
    alpha = np.zeros((num_steps + 1, len(prompts) - 1, max_num_words), dtype=np.float32)
    for i in range(len(prompts) - 1):
        alpha = update_alpha_time_word(alpha, cross_replace_steps["default_"], i)
    for key, item in cross_replace_steps.items():
        if key != "default_":
            inds = [seq_aligner.get_word_inds(prompts[i], key, tokenizer)
                    for i in range(1, len(prompts))]
            for i, ind in enumerate(inds):
                if len(ind) > 0:
                    alpha = update_alpha_time_word(alpha, item, i, ind)
    return alpha.reshape(num_steps + 1, len(prompts) - 1, 1, 1, max_num_words)


def get_equalizer(text: str, word_select, values, tokenizer) -> np.ndarray:
    if isinstance(word_select, (int, str)):
        word_select = (word_select,)
    eq = np.ones((1, MAX_NUM_WORDS), dtype=np.float32)
    for word, val in zip(word_select, values):
        inds = seq_aligner.get_word_inds(text, word, tokenizer)
        eq[:, inds] = val
    return eq


# ---------------------------------------------------------------------------
# resizing with jax.image.resize semantics
# ---------------------------------------------------------------------------

def _keys_cubic(x):
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"cubic": _keys_cubic, "bilinear": _triangle}


def _resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_in, n_out) interpolation matrix of jax.image.resize (half-pixel
    centres, edge weights renormalized, antialiased when downsampling)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def image_resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """jax.image.resize(x, shape, method) for "nearest", "bilinear", "cubic"."""
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = np.floor(((np.arange(n_out, dtype=np.float32) + 0.5) * n_in / n_out)
                           .astype(np.float32)).astype(np.int64)
            x = x.index_select(d, torch.as_tensor(idx, device=x.device))
        else:
            w = torch.as_tensor(_resize_weights(n_in, n_out, method), device=x.device)
            x = torch.tensordot(x.float(), w, dims=([d], [0])).movedim(-1, d)
    return x


# ---------------------------------------------------------------------------
# store aggregation
# ---------------------------------------------------------------------------

def store_keys_for(metas, res: int, places: Sequence[str], cross: bool = True) -> List[str]:
    """Store keys (in forward layer order) matching resolution + places."""
    flat = sorted((m for pair in metas.values() for m in pair), key=lambda m: m.idx)
    return [m.store_key for m in flat
            if m.is_cross == cross and m.res == res and m.place in places]


def nearest_cross_res(metas, want: int, places: Sequence[str]) -> int:
    """Closest resolution that has cross-attention layers in `places`."""
    avail = sorted({m.res for pair in metas.values() for m in pair
                    if m.is_cross and m.place in places})
    if want in avail:
        return want
    return min(avail, key=lambda r: abs(r - want))


def aggregate_store(store: Dict[str, torch.Tensor], keys: List[str], res: int,
                    n_prompts: int, select: int) -> torch.Tensor:
    """Average stored maps over (layers, heads) for row `select` ->
    (res, res, 77)."""
    maps = []
    for k in keys:
        m = store[k]
        if m[..., 0].numel() % (n_prompts * res * res):
            raise ValueError(f"store shape {tuple(m.shape)} not factorable as "
                             f"(n={n_prompts}, H, {res}x{res}, .)")
        maps.append(m.reshape(n_prompts, -1, res, res, m.shape[-1])[select])
    return torch.cat(maps, dim=0).mean(dim=0)


def aggregate_store_batched(store: Dict[str, torch.Tensor], keys: List[str],
                            res: int, n_prompts: int) -> torch.Tensor:
    """Per-row aggregation -> (n_prompts, res, res, 77)."""
    maps = [store[k].reshape(n_prompts, -1, res, res, store[k].shape[-1]) for k in keys]
    return torch.cat(maps, dim=1).mean(dim=1)


def attention_map_for_token(agg: torch.Tensor, token_idx: int,
                            resize: Optional[int] = 64) -> torch.Tensor:
    """Max-normalized (and optionally bicubic-resized) map of one token."""
    m = agg[..., token_idx]
    m = m / torch.clamp(m.max(), min=1e-12)
    if resize is not None and m.shape[-1] != resize:
        m = torch.clamp(image_resize(m, (resize, resize), "cubic"), 0.0, 1.0)
    return m


def normalized_token_maps(agg: torch.Tensor, resize: int = 64) -> torch.Tensor:
    """(res, res, 77) -> (resize, resize, 77), each channel max-normalized
    then bicubic-resized."""
    m = agg / torch.clamp(agg.amax(dim=(0, 1), keepdim=True), min=1e-12)
    if agg.shape[0] != resize:
        m = torch.clamp(image_resize(m, (resize, resize, m.shape[-1]), "cubic"), 0.0, 1.0)
    return m


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PtpHooks(AttnHooks):
    """Per-step ptp attention intervention."""

    layout: BatchLayout
    mode: str  # "replace" | "refine" | "none"
    alpha_i: Any  # (B, 1, 1, 77) cross-replace alpha for this step
    self_gate: bool  # self-replace active this step
    mapper_mat: Any = None  # (B, 77, 77) for replace
    mapper_idx: Any = None  # (B, 77) for refine
    refine_alphas: Any = None  # (B, 77) for refine
    equalizer: Any = None  # (B, 77) or None
    attn_replace_thres: int = 32 * 32
    store_keys: Tuple[str, ...] = ()
    do_edit: bool = True

    def wants_probs(self, meta: AttnLayerMeta) -> bool:
        # only cross-attention needs probabilities; self replacement is a
        # q/k substitution (`qkv`)
        return self.do_edit and meta.is_cross

    def store(self, meta: AttnLayerMeta) -> bool:
        return meta.store_key in self.store_keys

    def passthrough_attn(self, meta: AttnLayerMeta) -> bool:
        # self-attention above the replacement threshold (SD: 64x64) is
        # untouched and takes the packed kernel
        return (not meta.is_cross and not self.store(meta)
                and (not self.do_edit or self.layout.n_prompts < 2
                     or meta.res * meta.res > self.attn_replace_thres))

    def cfg_prefix_safe(self, first_self_meta: AttnLayerMeta) -> bool:
        # ptp acts on self-attention only at res^2 <= attn_replace_thres
        # (`qkv`), stores only cross maps and leaves hidden / out as they are:
        # the prefix through the first self layer is hook-free whenever that
        # layer lies above the threshold (SD: 64^2 > 32^2)
        return not self.do_edit or first_self_meta.res ** 2 > self.attn_replace_thres

    def replace_cross(self, base, repl):
        """base / repl: (B, H, hw, 77) source / target probabilities."""
        if self.mode == "replace":
            new = torch.einsum("bhpw,bwn->bhpn", base, self.mapper_mat.to(base.dtype))
        elif self.mode == "refine":
            # -1 (a target token with no source token, refine alpha 0) reads
            # the last column, as take_along_axis's negative index does in JAX
            idx = self.mapper_idx.remainder(base.shape[-1])
            idx = idx[:, None, None, :].expand(*base.shape[:3], -1)
            gathered = torch.gather(base, -1, idx)
            a = self.refine_alphas[:, None, None, :].to(base.dtype)
            new = gathered * a + repl * (1 - a)
        else:
            new = repl
        if self.equalizer is not None:
            new = new * self.equalizer[:, None, None, :].to(base.dtype)
        return new

    def qkv(self, meta: AttnLayerMeta, q, k, v):
        """Self-attention replacement as q/k substitution: the target cond
        rows take the source rows' q and k."""
        if (not self.do_edit or meta.is_cross or self.layout.n_prompts < 2
                or meta.res * meta.res > self.attn_replace_thres or not self.self_gate):
            return q, k, v
        n = self.layout.cond_start
        B = self.layout.n_pairs

        def subst(x):
            base = x[n: n + B]
            reps = (x.shape[0] - n - B) // B
            return torch.cat([x[: n + B]] + [base] * reps, dim=0)

        return subst(q), subst(k), v

    def probs(self, meta: AttnLayerMeta, p):
        if not self.do_edit or not meta.is_cross or self.layout.n_prompts < 2:
            return p
        n = self.layout.cond_start
        B = self.layout.n_pairs
        cond = p[n:]
        base, repl = cond[:B], cond[B:]
        a = self.alpha_i.to(p.dtype)
        new = self.replace_cross(base, repl)
        new = new * a + (1 - a) * repl
        return torch.cat([p[: n + B], new.to(p.dtype)], dim=0)


# ---------------------------------------------------------------------------
# controllers
# ---------------------------------------------------------------------------

def _store_heads_by_key(engine, latent):
    """Per-layer head counts for the store buffers; stores are sized for the
    preset's native latent geometry."""
    if latent.shape[-1] != engine.model.latent_size:
        raise ValueError(f"attention stores are sized for the preset's native latent "
                         f"geometry ({engine.model.latent_size}^2); got {latent.shape[-1]}"
                         f" -- preprocess inputs to the preset's image_size")
    return {m.store_key: m.heads for pair in engine.model.attn_metas.values() for m in pair}


class PtpController(Controller):
    """Full prompt-to-prompt edit controller (replace / refine [+reweight]
    [+LocalBlend]).  `source_prompt` / `target_prompt` may be lists of B
    prompts; the conditional rows are laid out [s_1..s_B, t_1..t_B]."""

    def __init__(self, engine, source_prompt, target_prompt,
                 is_replace_controller: bool = True,
                 cross_replace_steps: Union[float, Dict[str, Any]] = 0.8,
                 self_replace_steps: Union[float, Tuple[float, float]] = 0.4,
                 blend_words: Optional[Sequence] = None,
                 equilizer_params: Optional[Union[Dict[str, Any], Sequence]] = None,
                 attn_replace_thres: Optional[int] = None,
                 store_res: Optional[Tuple[int, ...]] = None,
                 store_places: Tuple[str, ...] = ("down", "up")):
        self.engine = engine
        tokenizer = engine.model.tokenizer
        batched = isinstance(source_prompt, (list, tuple))
        sources = list(source_prompt) if batched else [source_prompt]
        targets = list(target_prompt) if batched else [target_prompt]
        if len(sources) != len(targets):
            raise ValueError("source and target prompt lists differ in length")
        B = len(sources)
        self.n_pairs = B
        S = engine.num_inference_steps
        self.num_steps = S
        self.prompts = [sources[0], targets[0]]
        self.attn_replace_thres = attn_replace_thres or 32 * 32

        blend_list = blend_words if batched else [blend_words]
        if not batched:
            eq_list = [equilizer_params]
        else:
            eq_list = equilizer_params if equilizer_params is not None else [None] * B
        if blend_list is None:
            blend_list = [None] * B

        self.mode = "replace" if is_replace_controller else "refine"
        self.cross_alpha = np.concatenate([
            get_time_words_attention_alpha([s, t], S, cross_replace_steps, tokenizer)
            for s, t in zip(sources, targets)], axis=1)  # (S+1, B, 1, 1, 77)
        if isinstance(self_replace_steps, float):
            self_replace_steps = (0.0, self_replace_steps)
        self.self_range = (int(S * self_replace_steps[0]), int(S * self_replace_steps[1]))

        if self.mode == "replace":
            self.mapper_mat = np.concatenate([
                seq_aligner.get_replacement_mapper([s, t], tokenizer)
                for s, t in zip(sources, targets)], axis=0)  # (B, 77, 77)
            self.mapper_idx = self.refine_alphas = None
        else:
            pairs = [seq_aligner.get_refinement_mapper([s, t], tokenizer)
                     for s, t in zip(sources, targets)]
            self.mapper_idx = np.concatenate([m for m, _ in pairs], axis=0)
            self.refine_alphas = np.concatenate([a for _, a in pairs], axis=0)
            self.mapper_mat = None

        self.equalizer = None
        if any(eq is not None for eq in eq_list):
            self.equalizer = np.concatenate([
                np.ones((1, MAX_NUM_WORDS), dtype=np.float32) if eq is None
                else get_equalizer(tgt, eq["words"], eq["values"], tokenizer)
                for tgt, eq in zip(targets, eq_list)], axis=0)  # (B, 77)

        # LocalBlend; alpha rows follow the latent layout [s_1..s_B, t_1..t_B]
        self.blend = None
        if any(bw is not None for bw in blend_list):
            alpha_layers = np.zeros((2 * B, MAX_NUM_WORDS), dtype=np.float32)
            for i, (s, t, bw) in enumerate(zip(sources, targets, blend_list)):
                if bw is None:
                    continue
                for row, prompt, words in ((i, s, bw[0]), (B + i, t, bw[1])):
                    for word in ([words] if isinstance(words, str) else words):
                        alpha_layers[row, seq_aligner.get_word_inds(prompt, word, tokenizer)] = 1
            self.blend = {"alpha_layers": alpha_layers, "start_blend": int(0.2 * S),
                          "th": (0.3, 0.3)}

        # stores: cross maps at 16x16 from down+up, materialized only when
        # something consumes them (LocalBlend, or an explicit store_res)
        metas = engine.model.attn_metas
        explicit_store = store_res is not None
        if store_res is None:
            want = max(engine.model.preset.unet.sample_size // 4, 1)
            store_res = (nearest_cross_res(metas, want, store_places),)
        if self.blend is not None or explicit_store:
            self.store_keys = tuple(k for res in store_res
                                    for k in store_keys_for(metas, res, store_places))
        else:
            self.store_keys = ()
        self.store_res = store_res
        self.store_places = store_places

    def collect_store(self) -> bool:
        return len(self.store_keys) > 0

    def init_state(self, engine, latent, contexts):
        heads_by_key = _store_heads_by_key(engine, latent)
        dev = latent.device
        n = 2 * self.n_pairs

        def t(a):
            return torch.as_tensor(a, device=dev)

        state: Dict[str, Any] = {
            "cross_alpha": t(self.cross_alpha),
            "store_sum": {
                k: torch.zeros((n, heads_by_key[k], int(k.split("_")[2]) ** 2,
                                MAX_NUM_WORDS), dtype=torch.float32, device=dev)
                for k in self.store_keys},
        }
        if self.mapper_mat is not None:
            state["mapper_mat"] = t(self.mapper_mat)
        if self.mapper_idx is not None:
            state["mapper_idx"] = t(self.mapper_idx).long()
            state["refine_alphas"] = t(self.refine_alphas)
        if self.equalizer is not None:
            state["equalizer"] = t(self.equalizer)
        if self.blend is not None:
            state["alpha_layers"] = t(self.blend["alpha_layers"])
        return state

    def hooks(self, i, state, layout: BatchLayout) -> AttnHooks:
        lo, hi = self.self_range
        return PtpHooks(
            layout=layout, mode=self.mode, alpha_i=state["cross_alpha"][i],
            self_gate=lo <= i < hi, mapper_mat=state.get("mapper_mat"),
            mapper_idx=state.get("mapper_idx"), refine_alphas=state.get("refine_alphas"),
            equalizer=state.get("equalizer"), attn_replace_thres=self.attn_replace_thres,
            store_keys=self.store_keys)

    def end_step(self, i, t, latent, eps, store, state):
        state = dict(state)
        if self.store_keys:
            n = latent.shape[0]
            # cond half only (the reference stores attn[h//2:])
            state["store_sum"] = {k: v + store[k][-n:].float()
                                  for k, v in state["store_sum"].items()}
        if self.blend is not None and i + 1 > self.blend["start_blend"]:
            latent = self._local_blend(latent, state)
        return latent, state

    def _local_blend(self, x_t, state):
        """LocalBlend, per pair: word-attention mask, 3x3 max pool, nearest
        upsample, threshold, union with the source mask, and blend the
        unmasked region back to the pair's source latent.  x_t: (2B, c, h, w)."""
        b, _, h, w = x_t.shape
        B = self.n_pairs
        res = self.store_res[0]
        maps = torch.cat([state["store_sum"][k].reshape(b, -1, 1, res, res, MAX_NUM_WORDS)
                          for k in self.store_keys if f"_{res}_" in k], dim=1)
        alpha = state["alpha_layers"][:, None, None, None, None, :]
        mask = (maps * alpha).sum(-1).mean(1)  # (2B, 1, res, res)
        mask = F.max_pool2d(mask, 3, stride=1, padding=1)
        mask = image_resize(mask, (b, 1, h, w), "nearest")
        mask = mask / torch.clamp(mask.amax(dim=(2, 3), keepdim=True), min=1e-12)
        mask = mask > self.blend["th"][0]
        mask = torch.logical_or(torch.cat([mask[:B], mask[:B]]), mask).to(x_t.dtype)
        base = torch.cat([x_t[:B], x_t[:B]])
        blended = base + mask * (x_t - base)
        has_blend = torch.as_tensor(self.blend["alpha_layers"].any(axis=-1),
                                    dtype=x_t.dtype, device=x_t.device).reshape(b, 1, 1, 1)
        return has_blend * blended + (1 - has_blend) * x_t


class AttnStoreController(Controller):
    """Accumulate cross-attention maps without editing."""

    def __init__(self, engine, store_res: Tuple[int, ...] = (16,),
                 store_places: Tuple[str, ...] = ("down", "up"),
                 n_prompts: int = 1, per_step_maps: bool = False, resize: int = 64):
        self.engine = engine
        metas = engine.model.attn_metas
        store_res = tuple(nearest_cross_res(metas, r, store_places) for r in store_res)
        self.store_keys = tuple(k for res in store_res
                                for k in store_keys_for(metas, res, store_places))
        self.store_res = store_res
        self.n_prompts = n_prompts
        self.per_step_maps = per_step_maps
        self.resize = resize

    def collect_store(self) -> bool:
        return True

    def hooks(self, i, state, layout: BatchLayout) -> AttnHooks:
        keys = self.store_keys

        class _StoreHooks(AttnHooks):
            def store(self, meta):
                return meta.store_key in keys

            def passthrough_attn(self, meta):
                return meta.store_key not in keys

        return _StoreHooks()

    def init_state(self, engine, latent, contexts):
        heads_by_key = _store_heads_by_key(engine, latent)
        dev = latent.device
        state = {
            "store_sum": {
                k: torch.zeros((self.n_prompts, heads_by_key[k], int(k.split("_")[2]) ** 2,
                                MAX_NUM_WORDS), dtype=torch.float32, device=dev)
                for k in self.store_keys},
            "count": 0.0,
        }
        if self.per_step_maps:
            # running sum of per-step normalized token maps (eta-inversion's
            # forward "mean" masks), per sample
            state["norm_map_sum"] = torch.zeros(
                (self.n_prompts, self.resize, self.resize, MAX_NUM_WORDS),
                dtype=torch.float32, device=dev)
        return state

    def end_step(self, i, t, latent, eps, store, state):
        state = dict(state)
        n = self.n_prompts

        def cond(m):
            return (m[-n:] if m.shape[0] > n else m).float()

        state["store_sum"] = {k: v + cond(store[k]) for k, v in state["store_sum"].items()}
        state["count"] = state["count"] + 1.0
        if self.per_step_maps:
            # normalize THIS step's aggregated map, then average over steps
            res = self.store_res[0]
            step_maps = {k: cond(store[k]) for k in self.store_keys}
            agg = aggregate_store_batched(step_maps, list(self.store_keys), res, n)
            state["norm_map_sum"] = state["norm_map_sum"] + torch.stack(
                [normalized_token_maps(a, self.resize) for a in agg])
        return latent, state


class PromptToPromptEditor(ControllerBasedEditor):
    def make_controller(self, image, source_prompt, target_prompt, inv_res,
                        **kwargs) -> Controller:
        kwargs.pop("prompts", None)
        inv = self.inverter
        # eta-inversion bwd_* mask modes read this controller's store
        if getattr(inv, "mask_mode_cfg", None) is not None and (
                inv._mask_mode_is_bwd("mask_eta") or inv._mask_mode_is_bwd("mask_dirinv")):
            kwargs.setdefault("store_res", (inv._attn_res(),))
            kwargs.setdefault("store_places", tuple(inv.mask_mode_cfg["attn_from_where"]))
        return PtpController(inv, source_prompt, target_prompt, **kwargs)
