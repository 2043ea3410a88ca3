"""In-repo SentencePiece runtime: a ``tokenizer.model`` read and run without
the ``sentencepiece`` package, the port's copy of
``autosmoothquant_tpu/utils/sp_tokenizer.py`` (the port imports nothing of
the JAX package; ``tests/test_torch_sp_tokenizer.py`` holds the two equal).

  * ``parse_model_proto`` reads a ``tokenizer.model`` file directly: a
    protobuf wire-format walk extracting the pieces table (ModelProto field
    1: SentencePiece{piece=1, score=2, type=3}), the trainer's model_type
    (BPE / unigram) and the NormalizerSpec, with no protobuf dependency;
    ``write_model_proto`` is its inverse.
  * ``SentencePieceModel.encode`` implements both algorithms:
      - BPE: repeatedly merge the adjacent pair whose concatenation is a
        known piece with the best (highest) score, sentencepiece's
        bpe_model.cc merge loop (scores are the merge ranks).
      - unigram: Viterbi over piece log-probs (unigram_model.cc), maximum
        total score segmentation.
    Both run over the standard normalization: whitespace -> U+2581 LOWER
    ONE EIGHTH BLOCK with a leading space (add_dummy_prefix), and unknown
    characters fall back to <0xNN> byte pieces when present.
  * ``BaichuanTokenizer`` exposes the HF-like surface the serving code uses:
    __call__ / encode / decode, bos / eos ids, vocab_size.

Pure Python: tokenization is host-side request preprocessing (microseconds
per prompt), never on the device's path.
"""

from __future__ import annotations

import dataclasses

from typing import Dict, List, Optional, Tuple

_SPACE = "▁"  # sentencepiece's whitespace symbol


# -- protobuf wire-format walk (no protobuf dependency) -----------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _walk_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes.
    value is int for varint fields, bytes for length-delimited."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:                      # varint
            v, i = _read_varint(buf, i)
            yield field, wire, v
        elif wire == 2:                    # length-delimited
            ln, i = _read_varint(buf, i)
            yield field, wire, buf[i:i + ln]
            i += ln
        elif wire == 5:                    # fixed32 (float scores)
            yield field, wire, buf[i:i + 4]
            i += 4
        elif wire == 1:                    # fixed64
            yield field, wire, buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


# SentencePiece.type values (sentencepiece_model.proto)
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _BYTE, _UNUSED = 1, 2, 3, 4, 6, 5


@dataclasses.dataclass
class Piece:
    text: str
    score: float
    type: int


@dataclasses.dataclass
class NormalizerSpec:
    """ModelProto field 4 (sentencepiece_model.proto NormalizerSpec). The
    precompiled charsmap (a darts double-array over the rule TSV) is not
    executed — instead the NAME selects a pure-Python reimplementation of
    the stock rule sets (nmt_nfkc / nfkc / their _cf casefold variants /
    identity), which covers every model sentencepiece's own trainer
    produces. Boolean defaults mirror the proto."""

    name: str = "nmt_nfkc"
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True


def parse_model_proto(data: bytes):
    """tokenizer.model bytes -> (pieces, model_type, NormalizerSpec).
    ModelProto: field 1 = repeated SentencePiece, field 2 = TrainerSpec
    (whose field 3 = model_type enum: 1 UNIGRAM, 2 BPE, 3 WORD, 4 CHAR),
    field 4 = NormalizerSpec (name=1, add_dummy_prefix=3,
    remove_extra_whitespaces=4, escape_whitespaces=5)."""
    import struct

    pieces: List[Piece] = []
    model_type = "unigram"
    norm = NormalizerSpec()
    for field, wire, val in _walk_fields(data):
        if field == 1 and wire == 2:
            text, score, ptype = "", 0.0, _NORMAL
            for f2, w2, v2 in _walk_fields(val):
                if f2 == 1 and w2 == 2:
                    text = v2.decode("utf-8", errors="replace")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append(Piece(text, score, ptype))
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _walk_fields(val):
                if f2 == 3 and w2 == 0:
                    model_type = {1: "unigram", 2: "bpe", 3: "word",
                                  4: "char"}.get(v2, "unigram")
        elif field == 4 and wire == 2:  # NormalizerSpec
            for f2, w2, v2 in _walk_fields(val):
                if f2 == 1 and w2 == 2:
                    norm.name = v2.decode("utf-8", errors="replace")
                elif f2 == 3 and w2 == 0:
                    norm.add_dummy_prefix = bool(v2)
                elif f2 == 4 and w2 == 0:
                    norm.remove_extra_whitespaces = bool(v2)
                elif f2 == 5 and w2 == 0:
                    norm.escape_whitespaces = bool(v2)
    return pieces, model_type, norm


def write_model_proto(pieces: List[Tuple[str, float, int]],
                      model_type: str = "bpe",
                      norm: Optional[NormalizerSpec] = None) -> bytes:
    """Inverse of parse_model_proto — synthesizes a valid tokenizer.model
    (used by tests; also handy for shipping tiny fixture tokenizers)."""
    import struct

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            out += bytes([b7 | (0x80 if v else 0)])
            if not v:
                return out

    def ld(field: int, payload: bytes) -> bytes:
        return varint((field << 3) | 2) + varint(len(payload)) + payload

    out = b""
    for text, score, ptype in pieces:
        body = ld(1, text.encode("utf-8"))
        body += varint((2 << 3) | 5) + struct.pack("<f", score)
        body += varint(3 << 3) + varint(ptype)
        out += ld(1, body)
    mt = {"unigram": 1, "bpe": 2, "word": 3, "char": 4}[model_type]
    out += ld(2, varint(3 << 3) + varint(mt))
    if norm is not None:
        body = ld(1, norm.name.encode("utf-8"))
        body += varint(3 << 3) + varint(int(norm.add_dummy_prefix))
        body += varint(4 << 3) + varint(int(norm.remove_extra_whitespaces))
        body += varint(5 << 3) + varint(int(norm.escape_whitespaces))
        out += ld(4, body)
    return out


# -- NMT text cleanup (the non-NFKC half of the stock nmt_nfkc rules,
#    sentencepiece builder.cc BuildNmtNfkcMap) ------------------------------

# line/paragraph separators and C0 whitespace controls normalize to SPACE
_NMT_TO_SPACE = frozenset(
    [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x85, 0x2028, 0x2029])
# other C0/C1 controls, DEL, zero-width marks and the BOM are removed
_NMT_REMOVE = frozenset(
    list(range(0x00, 0x09)) + [0x0E + i for i in range(0x1F - 0x0E + 1)]
    + [0x7F] + [c for c in range(0x80, 0xA0) if c != 0x85]
    + [0x200B, 0x200C, 0x200D, 0x200E, 0x200F, 0xFEFF])


def _nmt_clean(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp in _NMT_REMOVE:
            continue
        out.append(" " if cp in _NMT_TO_SPACE else ch)
    return "".join(out)


# -- the runtime --------------------------------------------------------------


class SentencePieceModel:
    """Pieces table + BPE/unigram encoding (the spm runtime surface this
    framework needs: encode-as-pieces, ids, decode)."""

    def __init__(self, pieces: List[Piece], model_type: str,
                 norm: Optional[NormalizerSpec] = None):
        self.pieces = pieces
        self.model_type = model_type
        self.norm = norm or NormalizerSpec()
        self.piece_to_id: Dict[str, int] = {
            p.text: i for i, p in enumerate(pieces)}
        self.unk_id = next((i for i, p in enumerate(pieces)
                            if p.type == _UNKNOWN), 0)
        self._byte_ids: Dict[int, int] = {}
        for i, p in enumerate(pieces):
            if p.type == _BYTE and len(p.text) == 6:  # "<0xNN>"
                self._byte_ids[int(p.text[3:5], 16)] = i
        self._max_len = max((len(p.text) for p in pieces), default=1)

    @classmethod
    def load(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls(*parse_model_proto(f.read()))

    # normalization per the model's NormalizerSpec (normalizer.cc order:
    # charsmap rules -> whitespace collapse -> dummy prefix -> escape).
    # The charsmap itself is name-dispatched: nmt_nfkc = NMT cleanup +
    # unicodedata NFKC (+ casefold for the _cf variants); "identity"/""
    # skips it. Oracle-checked against HF tokenizers' Rust NFKC
    # normalizer (tests/test_sp_tokenizer.py fixtures).
    def _normalize(self, text: str) -> str:
        import unicodedata

        name = self.norm.name
        if name.startswith("nmt_"):
            text = _nmt_clean(text)
        if "nfkc" in name:
            text = unicodedata.normalize("NFKC", text)
        elif "nfc" in name:
            text = unicodedata.normalize("NFC", text)
        if name.endswith("_cf"):
            text = text.casefold()
        if self.norm.remove_extra_whitespaces:
            while "  " in text:
                text = text.replace("  ", " ")
            text = text.strip(" ")
        if self.norm.add_dummy_prefix:
            text = " " + text
        if self.norm.escape_whitespaces:
            text = text.replace(" ", _SPACE)
        return text

    def _char_fallback(self, ch: str) -> List[int]:
        if ch in self.piece_to_id:
            return [self.piece_to_id[ch]]
        if self._byte_ids:
            return [self._byte_ids[b] for b in ch.encode("utf-8")
                    if b in self._byte_ids]
        return [self.unk_id]

    def encode(self, text: str) -> List[int]:
        if not text:
            return []
        s = self._normalize(text)
        if self.model_type == "bpe":
            return self._encode_bpe(s)
        return self._encode_unigram(s)

    # BPE: greedy best-score merges (spm bpe_model.cc). Symbols start as
    # single characters; each round merges the adjacent pair with the
    # highest piece score (ties by position) whose concatenation is a
    # piece. Plain best-pair scan per round — O(len^2) worst case, which
    # is microseconds at prompt scale and trivially correct (a lazy heap
    # needs position-shift bookkeeping that is easy to get subtly wrong).
    def _encode_bpe(self, s: str) -> List[int]:
        syms = list(s)
        while True:
            best_i, best_score = -1, None
            for i in range(len(syms) - 1):
                pid = self.piece_to_id.get(syms[i] + syms[i + 1])
                if pid is None:
                    continue
                sc = self.pieces[pid].score
                if best_score is None or sc > best_score:
                    best_i, best_score = i, sc
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        out: List[int] = []
        for sym in syms:
            pid = self.piece_to_id.get(sym)
            if pid is not None:
                out.append(pid)
            else:
                for ch in sym:
                    out.extend(self._char_fallback(ch))
        return out

    # unigram: Viterbi max-total-score segmentation (spm unigram_model.cc)
    def _encode_unigram(self, s: str) -> List[int]:
        n = len(s)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            for ln in range(1, min(self._max_len, n - i) + 1):
                pid = self.piece_to_id.get(s[i:i + ln])
                if pid is None or self.pieces[pid].type in (_CONTROL,
                                                            _UNKNOWN):
                    continue
                sc = best[i] + self.pieces[pid].score
                if sc > best[i + ln]:
                    best[i + ln] = sc
                    back[i + ln] = (i, pid)
            if best[i + 1] <= NEG / 2:  # no piece covers s[i] — fallback
                fb = self._char_fallback(s[i])
                sc = best[i] - 100.0 * len(fb)
                if sc > best[i + 1]:
                    best[i + 1] = sc
                    back[i + 1] = (i, -1)
        ids: List[int] = []
        pos = n
        while pos > 0:
            i, pid = back[pos]
            ids.append((i, pid))
            pos = i
        out: List[int] = []
        for i, pid in reversed(ids):
            if pid == -1:
                out.extend(self._char_fallback(s[i]))
            else:
                out.append(pid)
        return out

    def decode(self, ids: List[int]) -> str:
        parts: List[str] = []
        byte_run: List[int] = []

        def flush():
            if byte_run:
                parts.append(bytes(byte_run).decode("utf-8",
                                                    errors="replace"))
                byte_run.clear()

        for i in ids:
            if not 0 <= i < len(self.pieces):
                continue
            p = self.pieces[i]
            if p.type == _BYTE:
                byte_run.append(int(p.text[3:5], 16))
                continue
            flush()
            if p.type in (_CONTROL, _UNKNOWN):
                continue
            parts.append(p.text)
        flush()
        text = "".join(parts).replace(_SPACE, " ")
        return text[1:] if text.startswith(" ") else text


class BaichuanTokenizer:
    """The vendored tokenizer's surface (ref: tokenization_baichuan.py:24-…)
    over the in-repo runtime: bos/eos insertion flags, encode/decode,
    __call__ returning .input_ids — what utils/chat.py and the eval
    adapters consume."""

    def __init__(self, vocab_file: str, *, add_bos_token: bool = True,
                 add_eos_token: bool = False, unk_token: str = "<unk>",
                 bos_token: str = "<s>", eos_token: str = "</s>"):
        self.sp = SentencePieceModel.load(vocab_file)
        self.add_bos_token = add_bos_token
        self.add_eos_token = add_eos_token
        self.unk_token = unk_token
        self.bos_token = bos_token
        self.eos_token = eos_token

    @property
    def vocab_size(self) -> int:
        return len(self.sp.pieces)

    @property
    def bos_token_id(self) -> Optional[int]:
        return self.sp.piece_to_id.get(self.bos_token)

    @property
    def eos_token_id(self) -> Optional[int]:
        return self.sp.piece_to_id.get(self.eos_token)

    @property
    def unk_token_id(self) -> int:
        return self.sp.unk_id

    def tokenize(self, text: str) -> List[str]:
        return [self.sp.pieces[i].text for i in self.sp.encode(text)]

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        if isinstance(tokens, str):
            return self.sp.piece_to_id.get(tokens, self.sp.unk_id)
        return [self.sp.piece_to_id.get(t, self.sp.unk_id) for t in tokens]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self.sp.encode(text)
        if add_special_tokens:
            if self.add_bos_token and self.bos_token_id is not None:
                ids = [self.bos_token_id] + ids
            if self.add_eos_token and self.eos_token_id is not None:
                ids = ids + [self.eos_token_id]
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        del skip_special_tokens  # control pieces always skipped
        return self.sp.decode(list(ids))

    def __call__(self, text, add_special_tokens: bool = True,
                 max_length: Optional[int] = None, truncation: bool = False,
                 **_):
        import types

        ids = self.encode(text, add_special_tokens=add_special_tokens)
        if truncation and max_length is not None:
            ids = ids[:max_length]
        return types.SimpleNamespace(input_ids=ids)
