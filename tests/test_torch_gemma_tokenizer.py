"""The port's copies of ``sp_model.py`` and ``tokenizer.py`` (numpy and
standard library only; the port cannot import them from the JAX package)
give the originals' results: the same bytes for a serialized proto, the same
ids and strings for unigram and BPE models with byte fallback, the same
packed prompts.
"""

import numpy as np
import pytest

from iseg_tpu.nlp.gemma import sp_model as jax_sp
from iseg_tpu.nlp.gemma import tokenizer as jax_tok
from iseg_tpu_torch.nlp.gemma import sp_model as sp
from iseg_tpu_torch.nlp.gemma import tokenizer as tok

WORDS = ["▁the", "▁quick", "▁brown", "▁fox", "▁jump", "s", "▁over", "▁lazy", "▁dog",
         "▁", "t", "h", "e", "qu", "ick", "o", "ver", "▁a", "n", "d"]
TEXTS = ["the quick brown fox jumps over the lazy dog", "  the   fox ", "", "a dog and the fox",
         "naïve façade", "zebra 42", "the\tquick\nfox"]


def _proto(mod, model_type: int, byte_fallback: bool = True):
    """Gemma's special-token layout (pad 0, eos 1, bos 2, unk 3), then byte
    pieces, then a few words with falling scores."""
    pieces = [mod.SentencePiece("<pad>", 0.0, mod.CONTROL),
              mod.SentencePiece("<eos>", 0.0, mod.CONTROL),
              mod.SentencePiece("<bos>", 0.0, mod.CONTROL),
              mod.SentencePiece("<unk>", 0.0, mod.UNKNOWN)]
    if byte_fallback:
        pieces += mod.build_byte_pieces(-12.0)
    pieces += [mod.SentencePiece(w, -1.0 - 0.25 * i) for i, w in enumerate(WORDS)]
    return mod.SPModelProto(pieces=pieces, model_type=model_type, unk_id=3, bos_id=2, eos_id=1,
                            pad_id=0, byte_fallback=byte_fallback)


@pytest.mark.parametrize("byte_fallback", [True, False], ids=["bytes", "unk"])
@pytest.mark.parametrize("model_type", [1, 2], ids=["unigram", "bpe"])
def test_torch_gemma_sp_model_equals_original(model_type, byte_fallback):
    ours, theirs = _proto(sp, model_type, byte_fallback), _proto(jax_sp, model_type, byte_fallback)
    data = sp.serialize_model_proto(ours)
    assert data == jax_sp.serialize_model_proto(theirs)
    parsed = sp.parse_model_proto(data)
    want = jax_sp.parse_model_proto(data)
    assert vars(parsed).keys() == vars(want).keys()
    for key in vars(want):
        if key != "pieces":
            assert getattr(parsed, key) == getattr(want, key), key
    assert [(p.piece, p.score, p.type) for p in parsed.pieces] == \
        [(p.piece, p.score, p.type) for p in want.pieces]

    a, b = sp.SentencePieceModel(data), jax_sp.SentencePieceModel(data)
    assert a.vocab_size() == b.vocab_size() == len(ours.pieces)
    assert (a.unk_id(), a.bos_id(), a.eos_id(), a.pad_id()) == \
        (b.unk_id(), b.bos_id(), b.eos_id(), b.pad_id()) == (3, 2, 1, 0)
    for text in TEXTS:
        ids = a.encode(text)
        assert ids == b.encode(text), text
        assert a.decode(ids) == b.decode(ids)
        if byte_fallback and text.strip():
            assert a.decode(ids) == " ".join(text.split())  # the round trip is exact
    assert a.piece_to_id("▁fox") == b.piece_to_id("▁fox")
    assert a.id_to_piece(5) == b.id_to_piece(5)
    assert a.piece_to_id("nope") == 3


def test_torch_gemma_sp_model_reads_a_file(tmp_path):
    path = tmp_path / "tiny.model"
    path.write_bytes(sp.serialize_model_proto(_proto(sp, 1)))
    tokenizer = tok.GemmaTokenizer(str(path))  # the port's own reader, no extra install
    want = jax_tok.GemmaTokenizer(str(path))
    assert tokenizer.tokenize("the lazy dog") == want.tokenize("the lazy dog")
    assert (tokenizer.pad_id, tokenizer.bos_id, tokenizer.eos_id) == (0, 2, 1)
    with pytest.raises(ValueError, match="unsupported tokenizer file"):
        tok.GemmaTokenizer(str(tmp_path / "vocab.txt"))
    with pytest.raises(RuntimeError, match="needs a vocabulary"):
        tok.GemmaTokenizer().tokenize("x")


class _StubBackend:
    """Whitespace words hashed into [4, 100); ids 0/1/2 are pad/eos/bos."""

    def encode(self, text):
        return [4 + sum(map(ord, w)) % 96 for w in text.split()]

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids)


@pytest.mark.parametrize("add_start,add_end", [(True, True), (False, True), (True, False)])
def test_torch_gemma_preprocessor_equals_original(add_start, add_end):
    texts = ["the quick brown fox", "a", "", "one two three four five six seven eight nine"]
    kw = dict(sequence_length=6, add_start_token=add_start, add_end_token=add_end)
    ours = tok.GemmaCausalLMPreprocessor(tok.GemmaTokenizer(backend=_StubBackend()), **kw)
    theirs = jax_tok.GemmaCausalLMPreprocessor(jax_tok.GemmaTokenizer(backend=_StubBackend()),
                                               **kw)
    for for_generation in (False, True):
        got, want = ours(texts, for_generation), theirs(texts, for_generation)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    (gx, gy, gw), (wx, wy, ww) = ours.for_training(texts), theirs.for_training(texts)
    assert sorted(gx) == sorted(wx)
    for key in wx:
        np.testing.assert_array_equal(gx[key], wx[key])
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(gw, ww)
    ids, lengths = ours(texts, for_generation=True)
    assert ours.generate_postprocess(ids, lengths) == theirs.generate_postprocess(ids, lengths)
    assert ours.generate_postprocess(ids) == theirs.generate_postprocess(ids)


def test_torch_gemma_tokenizer_copy_imports_only_the_port():
    import inspect

    source = inspect.getsource(tok) + inspect.getsource(sp)
    assert "iseg_tpu_torch.nlp.gemma.sp_model" in source
    assert "iseg_tpu.nlp" not in source and "import jax" not in source
