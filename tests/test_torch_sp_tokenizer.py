"""The port's SentencePiece runtime (``autosmoothquant_tpu_torch/utils/
sp_tokenizer.py``) against the JAX package's: the cases of
``tests/test_sp_tokenizer.py``, parametrised, run through both packages. The
model bytes, parsed pieces, ids, pieces of each encoding and decodes must be
equal, and the port's must be what that file expects (its HF ``tokenizers``
oracle fixtures included)."""

import json
import os
import unicodedata

import pytest

from autosmoothquant_tpu.utils import sp_tokenizer as J
from autosmoothquant_tpu_torch.utils import sp_tokenizer as P

S = "▁"
NORMAL, UNKNOWN, CONTROL, BYTE = 1, 2, 3, 6
_FIX = os.path.join(os.path.dirname(__file__), "fixtures", "sp_oracle.json")


def bpe_pieces():
    """tests/test_sp_tokenizer.py's tiny BPE vocab."""
    p = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL)]
    for ch in [S, "a", "b", "c", "h", "e", "l", "o", "t"]:
        p.append((ch, -10.0, NORMAL))
    p += [(S + "h", -1.0, NORMAL), ("he", -2.0, NORMAL), ("ll", -3.0, NORMAL),
          ("llo", -3.5, NORMAL), (S + "hello", -0.5, NORMAL), (S + "he", -1.5, NORMAL),
          ("lo", -4.0, NORMAL)]
    p += [(f"<0x{i:02X}>", -100.0, BYTE) for i in range(256)]
    return p


def unigram_pieces():
    p = [("<unk>", 0.0, UNKNOWN)]
    p += [(ch, -10.0, NORMAL) for ch in [S, "a", "b"]]
    p += [("ab", -12.0, NORMAL), (S + "a", -9.0, NORMAL), (S + "ab", -15.0, NORMAL)]
    return p


def unknown_pieces():
    return [("<unk>", 0.0, UNKNOWN), (S, -1.0, NORMAL), ("a", -1.0, NORMAL)]


def nmt_pieces():
    return [("<unk>", 0.0, UNKNOWN), (S, -5.0, NORMAL), ("a", -5.0, NORMAL),
            ("b", -5.0, NORMAL)]


def _oracle():
    with open(_FIX) as f:
        return json.load(f)


def _norm(mod, spec):
    return None if spec is None else mod.NormalizerSpec(**spec)


# (pieces, model type, NormalizerSpec fields or None, [(text, expected
# pieces or None)]); the expectations are tests/test_sp_tokenizer.py's
CASES = {
    "bpe": (bpe_pieces, "bpe", None,
            [("hello", [S + "hello"]), ("hell", None), ("he told", None), ("héllo", None)]),
    "unigram": (unigram_pieces, "unigram", None, [("ab", [S + "ab"])]),
    "unigram_unknown": (unknown_pieces, "unigram", None, [("aza", None)]),
    "nmt_nfkc": (nmt_pieces, "unigram", dict(name="nmt_nfkc"),
                 [("a\t\nb", None), ("a b", None), ("a\x00​b", None), ("ab", None),
                  ("  a   b  ", None)]),
    "raw_whitespace": (nmt_pieces, "unigram",
                       dict(name="", add_dummy_prefix=False, remove_extra_whitespaces=False,
                            escape_whitespaces=False), [("ab", None), ("a b", None)]),
}
DECODES = {"bpe": ["hello", "hell", "he told", "héllo"], "unigram": ["ab"],
           "unigram_unknown": ["aa"]}


def _both(case):
    pieces_fn, mt, spec, _ = CASES[case]
    data = {m: m.write_model_proto(pieces_fn(), mt, _norm(m, spec)) for m in (J, P)}
    assert data[J] == data[P]
    parsed = {m: m.parse_model_proto(data[m]) for m in (J, P)}
    assert parsed[P][1] == parsed[J][1] == mt
    assert ([(p.text, p.score, p.type) for p in parsed[P][0]]
            == [(p.text, p.score, p.type) for p in parsed[J][0]])
    assert vars(parsed[P][2]) == vars(parsed[J][2])
    return {m: m.SentencePieceModel(*parsed[m]) for m in (J, P)}


@pytest.mark.parametrize("case", list(CASES))
def test_encode_and_decode_equal(case):
    models = _both(case)
    mj, mp = models[J], models[P]
    texts = CASES[case][3]
    for i, (text, want) in enumerate(texts):
        ids = mp.encode(text)
        assert ids == mj.encode(text), text
        assert [mp.pieces[t].text for t in ids] == [mj.pieces[t].text for t in ids]
        assert mp.decode(ids) == mj.decode(ids)
        if want is not None:
            assert [mp.pieces[t].text for t in ids] == want
        if case in DECODES:
            assert mp.decode(ids) == DECODES[case][i]
    if case == "bpe":
        assert sum(mp.pieces[t].type == BYTE for t in mp.encode("héllo")) == 2
    if case == "unigram_unknown":
        assert mp.unk_id in mp.encode("aza")
    if case == "nmt_nfkc":
        assert mp.encode("a\t\nb") == mp.encode("a b")
        assert mp.encode("a\x00​b") == mp.encode("ab")
        assert mp.encode("  a   b  ") == mp.encode("a b")
    if case == "raw_whitespace":
        assert mp.encode("ab") == [2, 3]


@pytest.mark.parametrize("kind", ["unigram", "bpe"])
def test_hf_tokenizers_oracle(kind):
    """The committed HF tokenizers oracle: both packages give its ids."""
    fix = _oracle()[kind]
    pieces = [(t, s, ty) for t, s, ty in fix["vocab"]]
    models = {m: m.SentencePieceModel(*m.parse_model_proto(
        m.write_model_proto(pieces, kind, m.NormalizerSpec(name="nfkc")))) for m in (J, P)}
    for text, want in fix["cases"]:
        got = models[P].encode(text)
        assert got == want == models[J].encode(text), text
        assert models[P].decode(got) == models[J].decode(got)


def test_nfkc_oracle():
    for inp, want in _oracle()["nfkc"]:
        assert unicodedata.normalize("NFKC", inp) == want, inp


@pytest.mark.parametrize("bos,eos", [(True, False), (False, True)])
def test_baichuan_tokenizer_surface(tmp_path, bos, eos):
    f = tmp_path / "tokenizer.model"
    f.write_bytes(P.write_model_proto(bpe_pieces(), "bpe"))
    toks = {m: m.BaichuanTokenizer(str(f), add_bos_token=bos, add_eos_token=eos)
            for m in (J, P)}
    tj, tp = toks[J], toks[P]
    assert tp.vocab_size == tj.vocab_size == len(bpe_pieces())
    assert (tp.bos_token_id, tp.eos_token_id, tp.unk_token_id) == (1, 2, 0)
    for text in ("hello", "hello hello", "he told", "héllo"):
        ids = tp.encode(text)
        assert ids == tj.encode(text)
        assert tp.decode(ids) == tj.decode(ids) == text
        assert tp.tokenize(text) == tj.tokenize(text)
        assert tp.convert_tokens_to_ids(tp.tokenize(text)) == tp.encode(
            text, add_special_tokens=False)
        assert tp(text, max_length=3, truncation=True).input_ids == ids[:3]
    ids = tp.encode("hello")
    assert (ids[0] == tp.bos_token_id) is bos and (ids[-1] == tp.eos_token_id) is eos
