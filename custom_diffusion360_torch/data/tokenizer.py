"""Pure-Python CLIP BPE tokenizer (port of custom_diffusion360_tpu/data/
tokenizer.py; no torch, HF or ``regex`` dependency).

One implementation for both towers, parameterized by the padding
convention: open_clip pads with 0 after <|endoftext|>, HF pads with the eot
id. Vocab sources: an open_clip ``bpe_simple_vocab_16e6.txt.gz`` merges
file (vocab derived from the merges as open_clip.SimpleTokenizer does), or
HF ``vocab.json`` + ``merges.txt``. ``additional_special_tokens`` (the V*
modifier tokens, e.g. "<new1>") are appended after the vocab, so their ids
(>= vocab_size) index the text towers' trainable ``modifier_rows``.

The pre-tokenizing pattern uses the standard library's ``re``: the JAX
package's ``regex`` classes map as ``[\\p{L}]+`` -> ``[^\\W\\d_]+`` (word
characters that are neither decimal digits nor ``_``), ``[\\p{N}]`` ->
``\\d`` and ``[^\\s\\p{L}\\p{N}]+`` -> ``(?:[^\\s\\w]|_)+``. The two agree on
letters, decimal digits, punctuation and ``_``; they differ on numerics that
are not decimal digits (``\\p{N}`` holds "½", "²", "Ⅻ"; here those count as
letters, since ``\\w`` holds them and ``\\d`` does not).
"""
from __future__ import annotations

import functools
import gzip
import html
import json
import re
from typing import List, Optional, Sequence

import numpy as np


@functools.lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class ClipTokenizer:
    """CLIP BPE. Construct via from_merges / from_hf_files, or from a merges
    list (tests)."""

    PATTERN = (
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        r"[^\W\d_]+|\d|(?:[^\s\w]|_)+"
    )

    def __init__(
        self,
        merges: Sequence[tuple],
        vocab: Optional[dict] = None,
        additional_special_tokens: Sequence[str] = (),
        context_length: int = 77,
        pad_style: str = "open_clip",  # or "hf"
    ):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        if vocab is None:
            # open_clip SimpleTokenizer derivation: bytes + bytes</w> + merges
            v = list(self.byte_encoder.values())
            v = v + [x + "</w>" for x in v]
            for m in merges:
                v.append("".join(m))
            v.extend(["<|startoftext|>", "<|endoftext|>"])
            vocab = {tok: i for i, tok in enumerate(v)}
        self.encoder = dict(vocab)
        self.base_vocab_size = len(self.encoder)
        for tok in additional_special_tokens:
            self.encoder[tok] = len(self.encoder)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.special = set(additional_special_tokens) | {"<|startoftext|>", "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.context_length = context_length
        self.pad_id = 0 if pad_style == "open_clip" else self.eot
        # special tokens (the V* modifiers included) match as single units
        special_alt = "|".join(re.escape(t) for t in additional_special_tokens)
        pattern = (special_alt + "|" if special_alt else "") + self.PATTERN
        self.pat = re.compile(pattern, re.IGNORECASE)
        self.cache = {t: t for t in self.special}

    @classmethod
    def from_merges(cls, path: str, **kw):
        """open_clip bpe_simple_vocab_16e6.txt.gz (first line a header;
        merges 1 .. 48894 used)."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1: 49152 - 256 - 2 + 1]]
        return cls(merges, **kw)

    @classmethod
    def from_hf_files(cls, vocab_json: str, merges_txt: str, **kw):
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines if m and not m.startswith("#version")]
        kw.setdefault("pad_style", "hf")
        return cls(merges, vocab=vocab, **kw)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
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
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
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
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in self.pat.findall(_clean(text)):
            if token in self.special:
                ids.append(self.encoder[token])
                continue
            token_b = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token_b).split(" ") if t in self.encoder)
        return ids

    def __call__(self, texts) -> np.ndarray:
        """texts: str or list[str] -> (B, context_length) int32, sot/eot
        wrapped; a long prompt is truncated with eot forced at the end."""
        if isinstance(texts, str):
            texts = [texts]
        n = self.context_length
        out = np.full((len(texts), n), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode_text(t) + [self.eot]
            if len(ids) > n:
                ids = ids[:n]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        return (
            bytearray(self.byte_decoder.get(c, 32) for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


def make_test_tokenizer(words: Sequence[str] = (), **kw) -> ClipTokenizer:
    """Tiny synthetic tokenizer (no CLIP vocabulary file): merges that fuse
    each of ``words`` character by character."""
    merges = []
    for w in words:
        w = w.lower()
        pieces = list(w[:-1]) + [w[-1] + "</w>"]
        while len(pieces) > 1:
            merges.append((pieces[0], pieces[1]))
            pieces = [pieces[0] + pieces[1]] + pieces[2:]
    return ClipTokenizer(merges, **kw)
