"""CLIP text tokenizers (a copy of eta_inversion_tpu/models/tokenizer.py; numpy only).

The reference uses HuggingFace's `CLIPTokenizer` downloaded with the SD pipeline
(reference modules/inversion/diffusion_inversion.py:222-229).  This
environment has zero egress, so we provide:

  * `ClipBpeTokenizer` — a from-scratch CLIP byte-pair-encoding tokenizer that
    loads `vocab.json` + `merges.txt` from a local path (drop-in compatible with
    the original openai/clip vocab files);
  * `HashTokenizer` — a deterministic word-hash tokenizer used for tests and
    random-weight benchmarking when no vocab files are available.

Both expose the minimal interface the framework needs: `encode`, `decode`,
`__call__(prompts) -> int32 [B, 77] ids`, `model_max_length`, and special-token
ids (used by ptp word-index helpers, reference modules/utils/
ptp_utils.py:305-323).
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import List, Sequence

import numpy as np


class TokenizerBase:
    model_max_length: int = 77
    bos_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: int = 1  # CLIP pads with eos

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids) -> str:
        raise NotImplementedError

    def __call__(self, prompts: Sequence[str], max_length: int | None = None) -> np.ndarray:
        """Tokenize to fixed-length int32 ids, padded with eos (CLIP convention:
        bos + tokens + eos + pad(eos...))."""
        if isinstance(prompts, str):
            prompts = [prompts]
        L = max_length or self.model_max_length
        out = np.full((len(prompts), L), self.pad_token_id, dtype=np.int32)
        for i, p in enumerate(prompts):
            toks = [self.bos_token_id] + self.encode(p)[: L - 2] + [self.eos_token_id]
            out[i, : len(toks)] = np.asarray(toks, dtype=np.int32)
        return out


def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


# The canonical CLIP pre-token pattern uses unicode categories (\p{L}/\p{N});
# python's stdlib `re` can't express those, so prefer the `regex` module
# (transformers' own tokenizer imports `regex as re`).  The ASCII fallback
# diverges on accented words ("café" splits as "caf"+"é") — only used when
# `regex` is genuinely absent.
try:
    import regex as _regex

    _CLIP_PAT = _regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex ships with transformers
    _CLIP_PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        re.IGNORECASE,
    )


def _whitespace_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class ClipBpeTokenizer(TokenizerBase):
    """CLIP BPE tokenizer loading vocab/merges from local files.

    `vocab_path` is a vocab.json (token -> id); `merges_path` a merges.txt
    (optionally gzipped, openai bpe_simple_vocab_16e6 format also accepted).
    """

    def __init__(self, vocab_path: str, merges_path: str):
        with open(vocab_path, "r", encoding="utf-8") as f:
            self.encoder = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}

        if merges_path.endswith(".gz"):
            merges = gzip.open(merges_path, "rt", encoding="utf-8").read().split("\n")
            merges = merges[1 : 49152 - 256 - 2 + 1]
        else:
            with open(merges_path, "r", encoding="utf-8") as f:
                merges = f.read().split("\n")
            if merges and merges[0].startswith("#"):
                merges = merges[1:]
            merges = [m for m in merges if m]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}

        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token_id = self.encoder.get("<|startoftext|>", 49406)
        self.eos_token_id = self.encoder.get("<|endoftext|>", 49407)
        self.pad_token_id = self.eos_token_id
        self.vocab_size = len(self.encoder)

    @functools.lru_cache(maxsize=16384)
    def _bpe(self, token: str) -> str:
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        return " ".join(word)

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        for token in _CLIP_PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def decode(self, ids) -> str:
        if isinstance(ids, (int, np.integer)):
            ids = [int(ids)]
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytearray(self.byte_decoder.get(c, ord(" ")) for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()


class HashTokenizer(TokenizerBase):
    """Deterministic word-hash tokenizer (test/bench fallback; no vocab files).

    Splits on the CLIP word pattern and maps each word to a stable id in
    [num_special, vocab_size).  Not a real BPE — only for environments without
    vocab assets; decode returns a placeholder token string.
    """

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.pad_token_id = self.eos_token_id

    @staticmethod
    def _hash_word(word: str, mod: int) -> int:
        h = 2166136261
        for ch in word.encode("utf-8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return h % mod

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(text).lower()
        words = _CLIP_PAT.findall(text)
        mod = self.vocab_size - 2
        return [self._hash_word(w, mod) for w in words]

    def decode(self, ids) -> str:
        if isinstance(ids, (int, np.integer)):
            ids = [int(ids)]
        return " ".join(f"<tok{int(i)}>" for i in ids)


class WordPieceTokenizer(TokenizerBase):
    """BERT WordPiece tokenizer loading a local vocab.txt (one token per line,
    line number = id) — the BLIP captioner's text vocabulary.  Greedy
    longest-match-first subword segmentation, lowercased (bert-base-uncased
    convention, which BLIP uses)."""

    def __init__(self, vocab_path: str):
        with open(vocab_path, "r", encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.encoder = {t: i for i, t in enumerate(tokens)}
        self.decoder = {i: t for i, t in enumerate(tokens)}
        self.vocab_size = len(tokens)
        self.pad_token_id = self.encoder.get("[PAD]", 0)
        self.bos_token_id = self.encoder.get("[CLS]", 101)
        self.eos_token_id = self.encoder.get("[SEP]", 102)
        self.unk_token_id = self.encoder.get("[UNK]", 100)

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(text).lower()
        ids: List[int] = []
        for word in re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text):
            start, pieces = 0, []
            while start < len(word):
                end = len(word)
                piece = None
                while start < end:
                    sub = word[start:end]
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.encoder:
                        piece = sub
                        break
                    end -= 1
                if piece is None:
                    pieces = None
                    break
                pieces.append(self.encoder[piece])
                start = end
            ids.extend(pieces if pieces is not None else [self.unk_token_id])
        return ids

    def decode(self, ids) -> str:
        if isinstance(ids, (int, np.integer)):
            ids = [int(ids)]
        words: List[str] = []
        for i in ids:
            t = self.decoder.get(int(i), "")
            if t.startswith("##") and words:
                words[-1] += t[2:]
            elif t and not (t.startswith("[") and t.endswith("]")):
                words.append(t)
        return " ".join(words)


class HashWordTokenizer(HashTokenizer):
    """Hash fallback with caller-chosen special ids kept out of the hash range
    (BLIP's pad/[DEC]/[SEP] live at both ends of its vocab)."""

    def __init__(self, vocab_size: int, specials: Sequence[int] = ()):
        super().__init__(vocab_size=vocab_size)
        self.specials = set(int(s) for s in specials)

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(text).lower()
        words = _CLIP_PAT.findall(text)
        mod = self.vocab_size
        out = []
        for w in words:
            h = self._hash_word(w, mod)
            while h in self.specials:  # deterministic re-probe off specials
                h = (h + 1) % mod
            out.append(h)
        return out


def load_wordpiece_tokenizer(vocab_path: str | None = None,
                             vocab_size: int = 30524,
                             specials: Sequence[int] = ()) -> TokenizerBase:
    """BLIP text tokenizer: real WordPiece if a vocab.txt exists locally,
    else the deterministic hash fallback."""
    if vocab_path and os.path.exists(vocab_path):
        return WordPieceTokenizer(vocab_path)
    return HashWordTokenizer(vocab_size=vocab_size, specials=specials)


def load_tokenizer(vocab_dir: str | None = None, vocab_size: int = 49408) -> TokenizerBase:
    """Load the CLIP BPE tokenizer if vocab files exist, else the hash fallback.

    Accepts vocab files either at ``vocab_dir`` directly or under the
    diffusers checkpoint layout's ``tokenizer/`` subdirectory (real SD
    checkpoints ship ``tokenizer/vocab.json`` + ``tokenizer/merges.txt``)."""
    if vocab_dir:
        for sub in ("", "tokenizer"):
            d = os.path.join(vocab_dir, sub) if sub else vocab_dir
            vj = os.path.join(d, "vocab.json")
            for merges_name in ("merges.txt", "bpe_simple_vocab_16e6.txt.gz"):
                mp = os.path.join(d, merges_name)
                if os.path.exists(vj) and os.path.exists(mp):
                    return ClipBpeTokenizer(vj, mp)
    return HashTokenizer(vocab_size=vocab_size)
