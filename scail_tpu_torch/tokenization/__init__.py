"""Tokenizer factory (counterpart of scail_tpu/tokenization/__init__.py;
reference: sat/tokenization/__init__.py).

`get_tokenizer(args)` caches one tokenizer per process keyed by
tokenizer_type, supports an outer_tokenizer override, and dispatches:

  'fake'                        -> None (the SCAIL video path: prompts go
                                   straight to the conditioner's text
                                   encoders, arguments.py tokenizer_type)
  'hf_...'                      -> HF AutoTokenizer (transformers is
                                   imported in this branch alone: no other
                                   type needs it)
  'glm_GPT2BPETokenizer'        -> glm.GPT2BPETokenizer (vocab+merges)
  'glm_BertWordPieceTokenizer'  -> glm.BertWordPieceTokenizer (vocab.txt)
  'image'/'cogview'             -> image.ImageTokenizer over a VQ model
                                   (img_tokenizer_model, an optional
                                   img_tokenizer_params state dict)

sentencepiece-backed types (glm_ChineseSPTokenizer, icetk) raise with a
pointer — the package isn't in this environment.
"""

from __future__ import annotations

from typing import Optional

from scail_tpu_torch.tokenization.core import (CommandToken, Tokenization,  # noqa: F401
                                         Tokenizer, prep_command_tokens)
from scail_tpu_torch.tokenization.glm import (BertWordPieceTokenizer,  # noqa: F401
                                        GPT2BPETokenizer)
from scail_tpu_torch.tokenization.image import ImageTokenizer  # noqa: F401
from scail_tpu_torch.tokenization.text import GPT2BPE, WordPiece  # noqa: F401


def _get(args, name, default=None):
    if args is None:
        return default
    if isinstance(args, dict):
        return args.get(name, default)
    return getattr(args, name, default)


def get_tokenizer(args=None, *, tokenizer_type: Optional[str] = None,
                  outer_tokenizer=None):
    """(sat/tokenization/__init__.py:19-91): process-wide cached factory."""
    if outer_tokenizer is not None:
        get_tokenizer.tokenizer = outer_tokenizer
        get_tokenizer.tokenizer_type = "outer_tokenizer"
        return outer_tokenizer
    if tokenizer_type is None:
        if args is None:
            assert hasattr(get_tokenizer, "tokenizer"), "Never set tokenizer."
            return get_tokenizer.tokenizer
        tokenizer_type = _get(args, "tokenizer_type")
    if (getattr(get_tokenizer, "tokenizer_type", None) == tokenizer_type):
        return get_tokenizer.tokenizer

    if tokenizer_type == "fake":
        tok = None
    elif tokenizer_type == "glm_GPT2BPETokenizer":
        tok = GPT2BPETokenizer(
            vocab_file=_get(args, "vocab_file"),
            merges_file=_get(args, "merges_file"),
            roberta=str(_get(args, "tokenizer_model_type", "")).startswith(
                "roberta"),
            add_block_symbols=True,
            add_task_mask=bool(_get(args, "task_mask", False)),
            add_decoder_mask=float(_get(args, "block_mask_prob", 0.0)) > 0.0)
    elif tokenizer_type == "glm_BertWordPieceTokenizer":
        tok = BertWordPieceTokenizer(
            vocab_file=_get(args, "vocab_file"),
            tokenizer_model_type=_get(args, "tokenizer_model_type",
                                      "bert-large-uncased"),
            add_block_symbols=True,
            add_task_mask=bool(_get(args, "task_mask", False)),
            add_decoder_mask=float(_get(args, "block_mask_prob", 0.0)) > 0.0)
    elif tokenizer_type.startswith("hf_"):
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(
            _get(args, "tokenizer_model_type") or tokenizer_type[3:])
    elif tokenizer_type in ("glm_ChineseSPTokenizer", "icetk",
                            "icetk-glm-130B") or tokenizer_type.startswith(
                                "cogview_ICE"):
        raise ImportError(
            f"{tokenizer_type} needs the sentencepiece/icetk packages, "
            f"absent in this environment; use glm_GPT2BPETokenizer / "
            f"glm_BertWordPieceTokenizer, or pass outer_tokenizer=.")
    elif tokenizer_type.startswith(("image", "cogview")):
        model = _get(args, "img_tokenizer_model")
        params = _get(args, "img_tokenizer_params")
        assert model is not None, (
            "image tokenization needs img_tokenizer_model (a VQModel; "
            "img_tokenizer_params: its state dict, optional)")
        tok = ImageTokenizer(model, params)
    else:
        raise ValueError(f"unknown tokenizer_type {tokenizer_type!r}")

    get_tokenizer.tokenizer = tok
    get_tokenizer.tokenizer_type = tokenizer_type
    return tok
