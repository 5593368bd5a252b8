"""CLIP BPE tokenizer — pure Python (port of vdx/models/tokenizer.py).

Full byte-pair-encoding implementation of the CLIP tokenizer contract the
reference exercises through diffusers (prompt -> 77 ids, BOS 49406 /
EOS 49407, lowercased, whitespace-normalised, EOS-padded).

The real vocab/merges files (49,408 entries) load through
:meth:`CLIPTokenizer.from_files` when present. Without them,
:class:`FallbackBPETokenizer` provides a deterministic byte-level scheme with
the same id-space layout (bytes -> low ids, BOS/EOS at 49406/49407): the
pipeline contract (shapes, padding, determinism) is identical, only the
learned merges differ. Ids match vdx's tokenizer exactly.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import re
from pathlib import Path
from typing import List, Optional

import numpy as np

BOS_ID = 49406
EOS_ID = 49407
CONTEXT_LENGTH = 77

# CLIP's pattern with Python-re word classes (re has no \p{L}/\p{N}).
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|\w+|[0-9]|[^\s\w]+""",
    re.IGNORECASE | re.UNICODE,
)


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2 byte<->unicode table (the standard BPE byte encoding)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPTokenizer:
    """Real CLIP BPE given vocab+merges files (hub artifacts)."""

    def __init__(self, vocab: dict, merges: List[tuple]):
        self.encoder = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {}

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "CLIPTokenizer":
        vocab = json.loads(Path(vocab_path).read_text())
        raw = Path(merges_path)
        text = (
            gzip.open(raw, "rt", encoding="utf-8").read()
            if raw.suffix == ".gz"
            else raw.read_text()
        )
        lines = text.split("\n")
        merges = [tuple(l.split()) for l in lines[1:] if l and len(l.split()) == 2]
        return cls(vocab, merges)

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self.cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        text = whitespace_clean(basic_clean(text)).lower()
        ids: List[int] = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token) if t in self.encoder)
        return ids

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        return _pad_batch([self.encode(t) for t in _as_list(texts)], context_length)


class FallbackBPETokenizer:
    """Deterministic byte-level stand-in with the CLIP id-space layout.

    utf-8 byte b -> id b + 1 (0 is reserved as pad-adjacent); BOS/EOS match
    CLIP exactly, so downstream shape/special-token handling is identical.
    """

    def encode(self, text: str) -> List[int]:
        text = whitespace_clean(basic_clean(text)).lower()
        return [b + 1 for b in text.encode("utf-8")]

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        return _pad_batch([self.encode(t) for t in _as_list(texts)], context_length)


def _as_list(texts):
    return [texts] if isinstance(texts, str) else list(texts)


def _pad_batch(all_ids: List[List[int]], context_length: int) -> np.ndarray:
    """CLIP padding: [BOS] ids [EOS] then EOS-pad to context length."""
    out = np.full((len(all_ids), context_length), EOS_ID, dtype=np.int32)
    for i, ids in enumerate(all_ids):
        ids = [BOS_ID] + ids[: context_length - 2] + [EOS_ID]
        out[i, : len(ids)] = ids
    return out


def load_tokenizer(vocab_path: Optional[str] = None, merges_path: Optional[str] = None):
    """Real BPE when artifacts exist; deterministic byte fallback otherwise."""
    if vocab_path and merges_path and Path(vocab_path).exists() and Path(merges_path).exists():
        return CLIPTokenizer.from_files(vocab_path, merges_path)
    return FallbackBPETokenizer()
