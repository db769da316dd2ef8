"""Plain text tokenizers: GPT-2 byte-level BPE and BERT WordPiece.

Functional rewrites of the algorithms behind the reference's vendored
HF-era tokenizers (sat/tokenization/glm/tokenization_gpt2.py,
tokenization_wordpiece.py), loading the same local vocab artifacts
(vocab.json + merges.txt, vocab.txt) — no hub access.  Both expose the
(tokens, vocab, encode, decode, __len__) surface core.Tokenizer
composes over, and both are golden-tested against HF transformers
constructed from the same files (tests/test_tokenization.py; the port's copy against
it in tests/test_torch_tokenization.py).

The port's own copy of scail_tpu/tokenization/text.py (host code, no jax);
the port imports nothing of scail_tpu.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List


# ---------------------------------------------------------------------------
# GPT-2 byte-level BPE
# ---------------------------------------------------------------------------
@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The reversible byte<->printable-unicode table of GPT-2
    (tokenization_gpt2.py:63-79)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class GPT2BPE:
    """Byte-level BPE over the GPT-2 split pattern
    (tokenization_gpt2.py:92-180)."""

    def __init__(self, vocab_file: str, merges_file: str,
                 errors: str = "replace"):
        import regex

        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.errors = errors
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version")]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, str] = {}
        self.pat = regex.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
            r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")

    # -- surface for core.Tokenizer ----------------------------------------
    def __len__(self):
        return len(self.encoder)

    @property
    def tokens(self) -> List[str]:
        return [self.decoder[i] for i in range(len(self.decoder))]

    @property
    def vocab(self) -> Dict[str, int]:
        return self.encoder

    # -- BPE ------------------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
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
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
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
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids = []
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors=self.errors)


# ---------------------------------------------------------------------------
# BERT WordPiece
# ---------------------------------------------------------------------------
def _is_whitespace(ch):
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WordPiece:
    """BERT basic+wordpiece tokenization (tokenization_wordpiece.py):
    clean/CJK-pad/lowercase/strip-accents/punct-split, then greedy
    longest-match subwords with the ## continuation prefix."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    self.vocab[tok] = i
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_chars = max_chars_per_word

    def __len__(self):
        return len(self.vocab)

    @property
    def tokens(self) -> List[str]:
        return [self.ids_to_tokens[i] for i in range(len(self.ids_to_tokens))]

    # -- basic tokenization ---------------------------------------------------
    def _basic(self, text: str) -> List[str]:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_cjk(cp):
                out.append(f" {ch} ")
            elif _is_whitespace(ch):
                out.append(" ")
            else:
                out.append(ch)
        words = "".join(out).strip().split()
        split = []
        for w in words:
            if self.do_lower_case:
                w = w.lower()
                w = "".join(c for c in unicodedata.normalize("NFD", w)
                            if unicodedata.category(c) != "Mn")
            buf = []
            for ch in w:
                if _is_punctuation(ch):
                    split.append("".join(buf)) if buf else None
                    split.append(ch)
                    buf = []
                else:
                    buf.append(ch)
            if buf:
                split.append("".join(buf))
        return [s for s in split if s]

    def tokenize(self, text: str) -> List[str]:
        pieces = []
        for word in self._basic(text):
            if len(word) > self.max_chars:
                pieces.append(self.unk_token)
                continue
            start, sub_tokens, bad = 0, [], False
            while start < len(word):
                end = len(word)
                cur = None
                while start < end:
                    substr = word[start:end]
                    if start > 0:
                        substr = "##" + substr
                    if substr in self.vocab:
                        cur = substr
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                sub_tokens.append(cur)
                start = end
            pieces.extend([self.unk_token] if bad else sub_tokens)
        return pieces

    def encode(self, text: str) -> List[int]:
        return [self.vocab[t] for t in self.tokenize(text)]

    def decode(self, ids: List[int]) -> str:
        toks = [self.ids_to_tokens[i] for i in ids]
        words: List[str] = []
        for t in toks:
            if t.startswith("##") and words:
                words[-1] += t[2:]
            else:
                words.append(t)
        return " ".join(words)
