"""Command-token tokenizer framework (reference:
sat/tokenization/glm/tokenization.py:29-368).

`Tokenization` carries ids + text + command-token attributes through the
data pipeline; `Tokenizer` composes a plain text tokenizer (anything
exposing tokens/vocab/encode/decode) with named command tokens whose
literal strings are protected from subword splitting: EncodeAsIds first
splits the text on every command-token string, then encodes the plain
spans with the text tokenizer.

The port's own copy of scail_tpu/tokenization/core.py (host code, no jax);
the port imports nothing of scail_tpu.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence


class CommandToken:
    """(tokenization.py:130-139).  lstrip/rstrip eat whitespace adjacent
    to the token during the split, mirroring the HF special-token rules."""

    def __init__(self, name: str, token: str, Id: int,
                 lstrip: bool = False, rstrip: bool = False):
        self.name, self.token, self.Id = name, token, Id
        self.lstrip, self.rstrip = lstrip, rstrip

    def __repr__(self):
        return f"CommandToken(name={self.name!r}, token={self.token!r}, Id={self.Id})"


def prep_command_tokens(tokenlist, token_format: str = "<{0}>"):
    return [CommandToken(name, token_format.format(name), Id)
            for name, Id in tokenlist]


class Tokenization:
    """Ids + (processed, original) text + command attributes
    (tokenization.py:29-118)."""

    def __init__(self, tokenization, text=None, original_text=None,
                 command_tokens=None, asIds: bool = True):
        self.tokenization = tokenization
        self.text = tokenization if text is None else text
        self.original_text = (self.text if original_text is None
                              else original_text)
        self.command_tokens = command_tokens
        self.asIds = asIds
        self.parse_command_tokens()

    def set_command_tokens(self, command_tokens):
        self.command_tokens = command_tokens
        return self.parse_command_tokens()

    def parse_command_tokens(self):
        if self.command_tokens is None:
            return None
        for ct in self.command_tokens:
            setattr(self, ct.name, ct.Id if self.asIds else ct.token)
        return None

    def __getitem__(self, index):
        return self.tokenization[index]

    def __len__(self):
        return len(self.tokenization)

    def __str__(self):
        return f"Tokenization = {self.tokenization}, Text = {self.text}"

    def insert(self, idx: int, other):
        if isinstance(other, CommandToken):
            self.tokenization.insert(idx, other.Id)
            if idx == 0:
                self.text = other.token + self.text
                self.original_text = other.token + self.original_text
            elif idx == len(self.tokenization) - 1:
                self.text += other.token
                self.original_text += other.token
        else:
            tok = other.tokenization if isinstance(other, Tokenization) else other
            self.tokenization = (self.tokenization[:idx] + tok
                                 + self.tokenization[idx:])

    def append(self, other):
        if isinstance(other, CommandToken):
            self.tokenization.append(other.Id)
            self.text += other.token
            self.original_text += other.token
        elif isinstance(other, Tokenization):
            self.tokenization.extend(other.tokenization)
            self.text += other.text
            self.original_text += other.original_text
        else:
            self.tokenization.append(other)
        return self

    def extend(self, other):
        if isinstance(other, CommandToken):
            self.tokenization.append(other.Id)
            self.text += other.token
            self.original_text += other.token
        elif isinstance(other, list) and other and isinstance(
                other[0], CommandToken):
            self.tokenization.extend([o.Id for o in other])
        elif isinstance(other, Tokenization):
            self.tokenization.extend(other.tokenization)
            self.text += other.text
            self.original_text += other.original_text
        else:
            self.tokenization.extend(other)
        return self


class Tokenizer:
    """Command tokens + text tokenizer under one id space
    (tokenization.py:142-368).  The text tokenizer owns its own ids; any
    command token may alias a text id (pad='<|endoftext|>') or extend
    past the text vocab (sop/eop)."""

    def __init__(self, text_tokenizer, command_tokens: Sequence[CommandToken]):
        self.text_tokenizer = text_tokenizer
        if not hasattr(self, "num_text_tokens"):
            self.num_text_tokens = len(text_tokenizer)
        self._command_tokens = list(command_tokens)
        self.command_name_map = {t.name: t for t in self._command_tokens}
        self.command_token_map = {t.token: t for t in self._command_tokens}
        self.command_id_map = {t.Id: t for t in self._command_tokens}

        # the text tokenizers build `tokens` anew on each access: read it once
        # (per index it is quadratic in the vocab: minutes at BERT's 30,522)
        text_tokens = text_tokenizer.tokens
        max_id = max(len(text_tokens) - 1, max(self.command_id_map.keys()))
        self._tokens = [text_tokens[i] if i < len(text_tokens) else f"[UNUSED{i}]"
                        for i in range(max_id + 1)]
        for idx, ct in self.command_id_map.items():
            self._tokens[idx] = ct.token
        self._vocab = {t.token: Id for Id, t in self.command_id_map.items()}
        self._vocab.update(text_tokenizer.vocab)

        if not hasattr(self, "num_command_tokens"):
            self.num_command_tokens = len(self._command_tokens)
        if not hasattr(self, "num_tokens"):
            self.num_tokens = len(self._tokens)

        self._command_token_tokens = list(self.command_token_map.keys())
        self.spaces_between_special_tokens = True

    # -- vocab views --------------------------------------------------------
    @property
    def command_tokens(self):
        return self._command_tokens

    @property
    def tokens(self):
        return self._tokens

    @property
    def vocab(self):
        return self._vocab

    def get_command(self, name: str) -> CommandToken:
        return self.command_name_map[name]

    def __len__(self):
        return self.num_tokens

    def __call__(self, text, process_fn=None):
        return self.EncodeAsIds(text, process_fn=process_fn)

    def tokenize(self, text):
        return self.EncodeAsIds(text).tokenization

    def detokenize(self, ids):
        return self.DecodeIds(ids)

    # -- encode -------------------------------------------------------------
    def _split_on_token(self, ct: CommandToken, text: str) -> List[str]:
        result = []
        split_text = text.split(ct.token)
        for i, sub in enumerate(split_text):
            if ct.rstrip and i > 0:
                sub = sub.lstrip()
            if ct.lstrip and i < len(split_text) - 1:
                sub = sub.rstrip()
            if i == 0 and not sub:
                result.append(ct.token)
            elif i == len(split_text) - 1:
                if sub:
                    result.append(sub)
            else:
                if sub:
                    result.append(sub)
                result.append(ct.token)
        return result

    def EncodeAsIds(self, text, process_fn=None) -> Tokenization:
        processed = process_fn(text) if process_fn is not None else text
        if not processed.strip():
            ids: List[int] = []
        else:
            spans = [processed]
            for ct in self._command_tokens:
                next_spans = []
                for sub in spans:
                    if sub in self._command_token_tokens:
                        next_spans.append(sub)
                    else:
                        next_spans.extend(self._split_on_token(ct, sub))
                spans = next_spans
            ids = list(itertools.chain.from_iterable(
                [self.command_token_map[s].Id]
                if s in self._command_token_tokens else self._encode(s)
                for s in spans))
        tok = Tokenization(ids, processed, text)
        tok.set_command_tokens(self._command_tokens)
        return tok

    def EncodeAsTokens(self, text, process_fn=None) -> Tokenization:
        tok = self.EncodeAsIds(text, process_fn=process_fn)
        tok.tokenization = [self.IdToToken(i) for i in tok.tokenization]
        return tok

    def _encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def _decode(self, ids: List[int]) -> str:
        raise NotImplementedError

    @staticmethod
    def clean_up_tokenization(out_string: str) -> str:
        return out_string

    # -- decode -------------------------------------------------------------
    def IdToToken(self, idx):
        if isinstance(idx, CommandToken):
            return idx.token
        return self._tokens[idx]

    def TokenToId(self, token):
        if isinstance(token, CommandToken):
            return token.Id
        return self._vocab[token]

    def DecodeIds(self, ids) -> str:
        if isinstance(ids, Tokenization):
            ids = ids.tokenization
        pieces, current = [], []
        for Id in ids:
            if isinstance(Id, CommandToken):
                pieces.append(self._decode(current))
                current = []
                pieces.append(Id.token)
            elif Id in self.command_id_map:
                pieces.append(self._decode(current))
                current = []
                pieces.append(self.command_id_map[Id].token)
            else:
                current.append(Id)
        if current:
            pieces.append(self._decode(current))
        joiner = " " if self.spaces_between_special_tokens else ""
        return self.clean_up_tokenization(joiner.join(pieces))

    def DecodeTokens(self, tokens) -> str:
        return self.DecodeIds([self.TokenToId(t) for t in tokens])
