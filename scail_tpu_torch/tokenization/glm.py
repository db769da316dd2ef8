"""GLM-family tokenizers: the command-token layouts over GPT-2 BPE and
BERT WordPiece (reference: sat/tokenization/glm/tokenization.py:370-583).

Block symbols (sop/eop), task masks (gMASK/sMASK) and the decoder mask
(dBLOCK) extend the text vocab exactly as the reference lays them out —
these ids are baked into released GLM checkpoints, so the layout is the
compatibility contract.

The port's own copy of scail_tpu/tokenization/glm.py (host code, no jax);
the port imports nothing of scail_tpu.
"""

from __future__ import annotations

from typing import Optional

from scail_tpu_torch.tokenization.core import CommandToken, Tokenizer
from scail_tpu_torch.tokenization.text import GPT2BPE, WordPiece


class GPT2BPETokenizer(Tokenizer):
    """(tokenization.py:370-427).  `roberta` vocabs alias the command
    tokens onto <s>/</s>/<pad>/<mask>; plain GPT-2 vocabs get all six
    appended after the text vocab when add_block_symbols is set."""

    def __init__(self, vocab_file: str, merges_file: str,
                 roberta: bool = False, add_block_symbols: bool = False,
                 add_task_mask: bool = False, add_decoder_mask: bool = False,
                 **_):
        text_tokenizer = GPT2BPE(vocab_file, merges_file)
        num_tokens = len(text_tokenizer)
        enc = text_tokenizer.encoder
        if roberta:
            command_tokens = [
                CommandToken("pad", "<|endoftext|>", enc["</s>"]),
                CommandToken("eos", "<|endoftext|>", enc["</s>"]),
                CommandToken("sep", "[SEP]", enc["<pad>"]),
                CommandToken("ENC", "[CLS]", enc["<s>"]),
                CommandToken("MASK", "[MASK]", enc["<mask>"], lstrip=True),
                CommandToken("unk", "[UNK]", enc["<unk>"]),
            ]
            if add_block_symbols:
                command_tokens.extend([
                    CommandToken("sop", "<|startofpiece|>", num_tokens),
                    CommandToken("eop", "<|endofpiece|>", num_tokens + 1),
                ])
                num_tokens += 2
        else:
            command_tokens = [
                CommandToken("pad", "<|endoftext|>", enc["<|endoftext|>"]),
                CommandToken("eos", "<|endoftext|>", enc["<|endoftext|>"]),
            ]
            if add_block_symbols:
                command_tokens.extend([
                    CommandToken("sop", "<|startofpiece|>", num_tokens),
                    CommandToken("eop", "<|endofpiece|>", num_tokens + 1),
                    CommandToken("ENC", "[CLS]", num_tokens + 2),
                    CommandToken("MASK", "[MASK]", num_tokens + 3,
                                 lstrip=True),
                    CommandToken("sep", "[SEP]", num_tokens + 4),
                    CommandToken("unk", "[UNK]", num_tokens + 5),
                ])
                num_tokens += 6
        if add_block_symbols:
            if add_task_mask:
                command_tokens.extend([
                    CommandToken("gMASK", "[gMASK]", num_tokens, lstrip=True),
                    CommandToken("sMASK", "[sMASK]", num_tokens + 1,
                                 lstrip=True),
                ])
                num_tokens += 2
            if add_decoder_mask:
                command_tokens.append(
                    CommandToken("dBLOCK", "[dBLOCK]", num_tokens))
                num_tokens += 1
        super().__init__(text_tokenizer, command_tokens)

    def _encode(self, text):
        return self.text_tokenizer.encode(text)

    def _decode(self, ids):
        return self.text_tokenizer.decode(ids)


class BertWordPieceTokenizer(Tokenizer):
    """(tokenization.py:484-583)."""

    def __init__(self, vocab_file: str, do_lower_case: Optional[bool] = None,
                 tokenizer_model_type: str = "bert-large-uncased",
                 add_block_symbols: bool = False, add_sentinel_token: int = 0,
                 add_task_mask: bool = False, add_decoder_mask: bool = False,
                 added_command_tokens=None, **_):
        if do_lower_case is None:
            do_lower_case = not ("-cased" in tokenizer_model_type
                                 or "chinese" in tokenizer_model_type)
        text_tokenizer = WordPiece(vocab_file, do_lower_case=do_lower_case)
        num_tokens = len(text_tokenizer)
        v = text_tokenizer.vocab
        command_tokens = [
            CommandToken("pad", "[PAD]", v["[PAD]"]),
            CommandToken("ENC", "[CLS]", v["[CLS]"]),
            CommandToken("MASK", "[MASK]", v["[MASK]"]),
            CommandToken("unk", "[UNK]", v["[UNK]"]),
            CommandToken("sep", "[SEP]", v["[SEP]"]),
            CommandToken("eos", "[PAD]", v["[PAD]"]),
        ]
        if add_block_symbols:
            command_tokens.extend([
                CommandToken("sop", "<|startofpiece|>", num_tokens),
                CommandToken("eop", "<|endofpiece|>", num_tokens + 1),
            ])
            num_tokens += 2
            if add_task_mask:
                command_tokens.extend([
                    CommandToken("gMASK", "[gMASK]", num_tokens),
                    CommandToken("sMASK", "[sMASK]", num_tokens + 1),
                ])
                num_tokens += 2
            if add_decoder_mask:
                command_tokens.append(
                    CommandToken("dBLOCK", "[dBLOCK]", num_tokens))
                num_tokens += 1
        if add_sentinel_token > 0:
            for i in range(1, add_sentinel_token):
                command_tokens.extend([
                    CommandToken(f"MASK{i}", f"[MASK{i}]", num_tokens),
                    CommandToken(f"sop{i}", f"<|startofpiece{i}|>",
                                 num_tokens + 1),
                ])
                num_tokens += 2
        for name, token in (added_command_tokens or []):
            command_tokens.append(CommandToken(name, token, num_tokens))
            num_tokens += 1
        super().__init__(text_tokenizer, command_tokens)

    def _encode(self, text):
        return self.text_tokenizer.encode(text)

    def _decode(self, ids):
        return self.text_tokenizer.decode(ids)

    @staticmethod
    def clean_up_tokenization(out_string: str) -> str:
        """English detokenization artifacts (tokenization.py:546-568)."""
        return (out_string.replace(" .", ".").replace(" ?", "?")
                .replace(" !", "!").replace(" ,", ",").replace(" ' ", "'")
                .replace(" n't", "n't").replace(" 'm", "'m")
                .replace(" 's", "'s").replace(" 've", "'ve")
                .replace(" 're", "'re"))
