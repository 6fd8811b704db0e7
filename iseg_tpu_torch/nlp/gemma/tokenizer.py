"""Gemma SentencePiece tokenizer + causal-LM preprocessor.

Parity with the reference ``nlp/gemma/gemma_tokenizer.py:23`` (SentencePiece
proto-based tokenizer) and ``gemma_causal_lm_preprocessor.py:28`` (prompt
packing with start/end tokens + padding masks).

Backends, resolved lazily by file type and availability:
  - ``*.json`` -> HuggingFace ``tokenizers`` fast format (Gemma publishes
    ``tokenizer.json`` alongside the SentencePiece proto);
  - ``*.model``/``*.spm`` -> ``sentencepiece`` if importable, else the
    in-tree pure-Python ModelProto reader/encoder (``sp_model.py``:
    unigram Viterbi + BPE, byte fallback, NormalizerSpec flags);
  - anything else -> a clear error.
The preprocessor logic is backend-independent; the ``tokenizers`` path is
exercised end-to-end against a real trained subword vocabulary in
``tests/test_gemma_tokenizer_real.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class GemmaTokenizer:
    """Lazy-backend SentencePiece tokenizer."""

    START_TOKEN = "<bos>"
    END_TOKEN = "<eos>"
    PAD_TOKEN = "<pad>"

    def __init__(self, proto_path: Optional[str] = None, backend=None):
        self._backend = backend
        if backend is None and proto_path is not None:
            self._backend = _load_backend(proto_path)

    def tokenize(self, text: str) -> list[int]:
        return self._require_backend().encode(text)

    def detokenize(self, ids: Sequence[int]) -> str:
        return self._require_backend().decode(list(ids))

    @property
    def pad_id(self) -> int:
        # protos trained with pad disabled report pad_id() == -1 (the
        # SentencePiece TrainerSpec default); -1 must never reach the
        # model (embedding take() would clip it to row 0 silently), so
        # pad with id 0 in that case — padded positions are masked out
        # by padding_mask / prompt_lengths everywhere downstream
        raw = getattr(self._require_backend(), "pad_id", lambda: 0)()
        return max(0, int(raw))

    @property
    def bos_id(self) -> int:
        return getattr(self._require_backend(), "bos_id", lambda: 2)()

    @property
    def eos_id(self) -> int:
        return getattr(self._require_backend(), "eos_id", lambda: 1)()

    def _require_backend(self):
        if self._backend is None:
            raise RuntimeError(
                "GemmaTokenizer needs a vocabulary: pass proto_path "
                "(a SentencePiece .model/.spm — read natively, no extra "
                "install needed — or a HuggingFace tokenizer.json) or a "
                "custom backend object with encode/decode."
            )
        return self._backend


class _FastTokenizersAdapter:
    """Backend over HuggingFace ``tokenizers`` (``tokenizer.json`` format —
    the fast-tokenizer export Gemma ships next to the SentencePiece proto).

    Special-token ids follow the Gemma convention recorded in the vocab
    itself: ``<pad>``/``<eos>``/``<bos>`` are looked up by string, with the
    reference defaults (0/1/2) as fallback."""

    def __init__(self, json_path: str):
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(json_path)

    def encode(self, text):
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids):
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def _id_of(self, token: str, default: int) -> int:
        tid = self._tok.token_to_id(token)
        return default if tid is None else tid

    def pad_id(self):
        return self._id_of(GemmaTokenizer.PAD_TOKEN, 0)

    def eos_id(self):
        return self._id_of(GemmaTokenizer.END_TOKEN, 1)

    def bos_id(self):
        return self._id_of(GemmaTokenizer.START_TOKEN, 2)

    def vocab_size(self):
        return self._tok.get_vocab_size()


def _load_backend(proto_path: str):
    if proto_path.endswith(".json"):
        return _FastTokenizersAdapter(proto_path)
    if not proto_path.endswith((".model", ".spm")):
        # anything else would hit the proto parser and die with an opaque
        # varint error — name the actual problem instead
        raise ValueError(
            f"unsupported tokenizer file {proto_path!r}: expected a "
            "HF tokenizers .json or a SentencePiece .model/.spm proto"
        )
    try:
        import sentencepiece as spm

        sp = spm.SentencePieceProcessor()
        sp.Load(proto_path)
        return sp
    except ImportError:
        pass
    # pure-Python ModelProto reader (sp_model.py): same encode/decode/*_id
    # protocol as SentencePieceProcessor, no native wheel needed
    from iseg_tpu_torch.nlp.gemma.sp_model import SentencePieceModel

    return SentencePieceModel(proto_path)


class GemmaCausalLMPreprocessor:
    """Pack prompts into fixed-length id/padding arrays
    (reference ``gemma_causal_lm_preprocessor.py:28``)."""

    def __init__(self, tokenizer: GemmaTokenizer, sequence_length: int = 512,
                 add_start_token: bool = True, add_end_token: bool = True):
        self.tokenizer = tokenizer
        self.sequence_length = sequence_length
        self.add_start_token = add_start_token
        self.add_end_token = add_end_token

    def for_training(self, texts: Sequence[str],
                     sequence_length: Optional[int] = None):
        """Next-token training pack (reference
        ``gemma_causal_lm_preprocessor.py:88`` ``call``): tokenize + pack
        to ``sequence_length + 1``, then split into inputs (all but the
        last token) and targets (all but the first), with the padding
        mask as the sample weight.

        Returns ``({"token_ids", "padding_mask"}, y, sample_weight)``,
        each ``[B, sequence_length]``."""
        seq = sequence_length or self.sequence_length
        pad = self.tokenizer.pad_id
        ids_rows, mask_rows = [], []
        for t in texts:
            ids = self.tokenizer.tokenize(t)
            if self.add_start_token:
                ids = [self.tokenizer.bos_id] + ids
            if self.add_end_token:
                ids = ids + [self.tokenizer.eos_id]
            ids = ids[: seq + 1]  # pack one extra for the shift-truncate
            mask_rows.append([1] * len(ids) + [0] * (seq + 1 - len(ids)))
            ids_rows.append(ids + [pad] * (seq + 1 - len(ids)))
        token_ids = np.asarray(ids_rows, np.int32)
        padding_mask = np.asarray(mask_rows, bool)
        x = {"token_ids": token_ids[:, :-1],
             "padding_mask": padding_mask[:, :-1]}
        return x, token_ids[:, 1:], padding_mask[:, 1:]

    def generate_postprocess(self, token_ids, lengths=None) -> list[str]:
        """Strip pad/start/end tokens and detokenize each row (reference
        ``generate_preprocess``'s inverse, :151)."""
        out = []
        special = {self.tokenizer.pad_id, self.tokenizer.bos_id,
                   self.tokenizer.eos_id}
        for i, row in enumerate(np.asarray(token_ids)):
            if lengths is not None:
                row = row[: int(np.asarray(lengths)[i])]
            out.append(self.tokenizer.detokenize(
                [int(t) for t in row if int(t) not in special]))
        return out

    def __call__(self, texts: Sequence[str], for_generation: bool = False):
        """Returns (token_ids [B, L], lengths [B]). For generation the end
        token is omitted."""
        ids_list = []
        lengths = []
        pad = self.tokenizer.pad_id
        for t in texts:
            ids = self.tokenizer.tokenize(t)
            if self.add_start_token:
                ids = [self.tokenizer.bos_id] + ids
            if self.add_end_token and not for_generation:
                ids = ids + [self.tokenizer.eos_id]
            ids = ids[: self.sequence_length]
            lengths.append(len(ids))
            ids_list.append(ids + [pad] * (self.sequence_length - len(ids)))
        return (np.asarray(ids_list, np.int32), np.asarray(lengths, np.int32))
