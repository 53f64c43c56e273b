"""Token-sequence alignment for prompt-to-prompt (a copy of eta_inversion_tpu/editing/seq_aligner.py; numpy only).

Behavioral counterpart of reference modules/utils/seq_aligner.py (itself
from google/prompt-to-prompt): Needleman-Wunsch global alignment producing
refinement mappers (target-token -> source-token index + "is new word" alphas)
and word-level replacement mapper matrices.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

GAP, MATCH, MISMATCH = 0, 1, -1


def global_align(x: Sequence[int], y: Sequence[int]) -> np.ndarray:
    """Needleman-Wunsch; returns the traceback matrix (1=left/gap-x, 2=up/gap-y,
    3=diagonal, 4=origin)."""
    nx, ny = len(x), len(y)
    score = np.zeros((nx + 1, ny + 1), dtype=np.int32)
    score[0, 1:] = (np.arange(ny) + 1) * GAP
    score[1:, 0] = (np.arange(nx) + 1) * GAP
    trace = np.zeros((nx + 1, ny + 1), dtype=np.int32)
    trace[0, 1:] = 1
    trace[1:, 0] = 2
    trace[0, 0] = 4
    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            left = score[i, j - 1] + GAP
            up = score[i - 1, j] + GAP
            diag = score[i - 1, j - 1] + (MATCH if x[i - 1] == y[j - 1] else MISMATCH)
            best = max(left, up, diag)
            score[i, j] = best
            if best == left:
                trace[i, j] = 1
            elif best == up:
                trace[i, j] = 2
            else:
                trace[i, j] = 3
    return trace


def _mapper_y_to_x(x: Sequence[int], y: Sequence[int], trace: np.ndarray) -> np.ndarray:
    i, j = len(x), len(y)
    pairs = []
    while i > 0 or j > 0:
        tb = trace[i, j]
        if tb == 3:
            i -= 1
            j -= 1
            pairs.append((j, i))
        elif tb == 1:
            j -= 1
            pairs.append((j, -1))
        elif tb == 2:
            i -= 1
        else:
            break
    pairs.reverse()
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


def get_mapper(x: str, y: str, tokenizer, max_len: int = 77) -> Tuple[np.ndarray, np.ndarray]:
    """Refinement mapper for one (source, target) prompt pair.

    Returns (mapper (max_len,) int64, alphas (max_len,) float32): for each
    target-token slot, the aligned source-token index (or -1 -> alpha 0 for
    newly-added words)."""
    x_seq = [tokenizer.bos_token_id] + tokenizer.encode(x) + [tokenizer.eos_token_id]
    y_seq = [tokenizer.bos_token_id] + tokenizer.encode(y) + [tokenizer.eos_token_id]
    trace = global_align(x_seq, y_seq)
    mapper_base = _mapper_y_to_x(x_seq, y_seq, trace)
    alphas = np.ones(max_len, dtype=np.float32)
    alphas[: mapper_base.shape[0]] = (mapper_base[:, 1] != -1).astype(np.float32)
    mapper = np.zeros(max_len, dtype=np.int64)
    mapper[: mapper_base.shape[0]] = mapper_base[:, 1]
    mapper[mapper_base.shape[0]:] = len(y_seq) + np.arange(max_len - len(y_seq))
    return mapper, alphas


def get_refinement_mapper(prompts: List[str], tokenizer, max_len: int = 77):
    mappers, alphas = [], []
    for i in range(1, len(prompts)):
        m, a = get_mapper(prompts[0], prompts[i], tokenizer, max_len)
        mappers.append(m)
        alphas.append(a)
    return np.stack(mappers), np.stack(alphas)


def get_word_inds(text: str, word_place, tokenizer) -> np.ndarray:
    """Token indices (bos offset included) covering the given word (by string
    or word position), reference seq_aligner.py:138-158 / ptp_utils.py:305-323."""
    split_text = text.split(" ")
    if isinstance(word_place, str):
        word_place = [i for i, word in enumerate(split_text) if word_place == word]
    elif isinstance(word_place, int):
        word_place = [word_place]
    out = []
    if len(word_place) > 0:
        if getattr(tokenizer, "one_token_per_word", False):
            out = [p + 1 for p in word_place]
        else:
            words_encode = [tokenizer.decode([item]).strip("#")
                            for item in tokenizer.encode(text)]
            cur_len, ptr = 0, 0
            for i in range(len(words_encode)):
                cur_len += len(words_encode[i])
                if ptr in word_place:
                    out.append(i + 1)
                if ptr < len(split_text) and cur_len >= len(split_text[ptr]):
                    ptr += 1
                    cur_len = 0
    return np.asarray(out, dtype=np.int64)


def get_replacement_mapper_(x: str, y: str, tokenizer, max_len: int = 77) -> np.ndarray:
    """Word-level replacement mapper matrix (max_len, max_len); prompts must
    have the same word count (reference seq_aligner.py:161-195)."""
    words_x = x.split(" ")
    words_y = y.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            "attention replacement edit can only be applied on prompts with the same "
            f"length but prompt A has {len(words_x)} words and prompt B has "
            f"{len(words_y)} words.")
    inds_replace = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    inds_source = [get_word_inds(x, i, tokenizer) for i in inds_replace]
    inds_target = [get_word_inds(y, i, tokenizer) for i in inds_replace]
    mapper = np.zeros((max_len, max_len), dtype=np.float32)
    i = j = 0
    cur_inds = 0
    while i < max_len and j < max_len:
        if cur_inds < len(inds_source) and len(inds_source[cur_inds]) > 0 \
                and inds_source[cur_inds][0] == i:
            inds_source_, inds_target_ = inds_source[cur_inds], inds_target[cur_inds]
            if len(inds_source_) == len(inds_target_):
                mapper[inds_source_, inds_target_] = 1
            else:
                ratio = 1 / len(inds_target_)
                for i_t in inds_target_:
                    mapper[inds_source_, i_t] = ratio
            cur_inds += 1
            i += len(inds_source_)
            j += len(inds_target_)
        elif cur_inds < len(inds_source):
            mapper[i, j] = 1
            i += 1
            j += 1
        else:
            mapper[j, j] = 1
            i += 1
            j += 1
    return mapper


def get_replacement_mapper(prompts: List[str], tokenizer, max_len: int = 77) -> np.ndarray:
    return np.stack([get_replacement_mapper_(prompts[0], p, tokenizer, max_len)
                     for p in prompts[1:]])
