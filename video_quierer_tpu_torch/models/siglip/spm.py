"""Pure-Python SentencePiece unigram tokenizer for SigLIP text queries.

Copy of ``video_quierer_tpu/models/siglip/spm.py`` for the PyTorch port,
which imports nothing of the JAX package (the file itself is
framework-free); keep the two in step.

The reference delegates all text tokenization to HuggingFace processors
(video_search_overhaul.py:283-284); SigLIP's is a SentencePiece unigram
model (``spiece.model``).  The ``sentencepiece`` wheel is not in this
environment, so this module implements the inference side from scratch:

- :func:`load_model_proto` — a minimal protobuf *wire-format* decoder for
  ``sentencepiece.ModelProto`` (pieces / trainer_spec / normalizer_spec;
  field numbers from sentencepiece_model.proto).  No generated pb2 module
  or protobuf runtime needed.
- :class:`UnigramEncoder` — Viterbi segmentation over the unigram vocab
  (max total piece log-prob), with per-character ``<unk>`` fallback at the
  standard penalty (min_score − 10) and optional byte fallback.
- :class:`SigLIPSPTokenizer` — replicates HF ``SiglipTokenizer``'s encode
  path bit-for-bit (transformers/models/siglip/tokenization_siglip.py):
  big_vision canonicalization (ASCII punctuation stripped, whitespace
  collapsed), ``add_dummy_prefix`` disabled, the ``"<unk>" + text``
  prefix-encode-then-strip trick, ``</s>`` appended, padded with ``</s>``
  to a fixed 64-token context.

Normalization note: real spiece models carry a precompiled charsmap
implementing NMT-NFKC.  We approximate it with ``unicodedata`` NFKC plus
the NMT control-character rules — identical on the already-canonicalized
ASCII-ish queries SigLIP sees, and documented as an approximation for
exotic codepoints.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import string
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

logger = logging.getLogger(__name__)

SPIECE_UNDERLINE = "▁"

# ModelProto.SentencePiece.Type values (sentencepiece_model.proto).
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_UNK_PENALTY = 10.0


# ---------------------------------------------------------------------------
# Protobuf wire-format decoding (just enough for ModelProto)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long (corrupt spiece.model?)")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes.

    value is an int for varint/fixed wire types and raw bytes for
    length-delimited fields.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _sint32(raw: int) -> int:
    """Reinterpret a varint as a (possibly negative) int32."""
    raw &= (1 << 64) - 1
    if raw >= 1 << 63:  # negative int32/int64 encoded as 10-byte varint
        raw -= 1 << 64
    return int(np.int64(raw))


@dataclasses.dataclass
class SentencePieceModel:
    """Decoded ``spiece.model`` contents (inference-relevant subset)."""

    pieces: List[Tuple[str, float, int]]  # (piece, score, type)
    model_type: int = 1                   # TrainerSpec.ModelType; 1=UNIGRAM
    byte_fallback: bool = False
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    trainer_unk_id: int = 0

    def __post_init__(self):
        self.piece_to_id: Dict[str, int] = {}
        for i, (p, _, _) in enumerate(self.pieces):
            self.piece_to_id.setdefault(p, i)

    # -- special ids: derive from piece table (robust), trainer_spec backup
    def _find(self, names: Sequence[str], ptype: Optional[int]) -> int:
        for name in names:
            i = self.piece_to_id.get(name)
            if i is not None:
                return i
        if ptype is not None:
            for i, (_, _, t) in enumerate(self.pieces):
                if t == ptype:
                    return i
        return -1

    @property
    def unk_id(self) -> int:
        i = self._find(["<unk>"], UNKNOWN)
        return i if i >= 0 else self.trainer_unk_id

    @property
    def eos_id(self) -> int:
        return self._find(["</s>"], None)

    @property
    def pad_id(self) -> int:
        i = self._find(["<pad>"], None)
        return i if i >= 0 else self.eos_id

    @property
    def min_score(self) -> float:
        scores = [s for p, s, t in self.pieces if t == NORMAL]
        return min(scores) if scores else 0.0


def load_model_proto(src: Union[str, Path, bytes]) -> SentencePieceModel:
    """Decode a serialized ``sentencepiece.ModelProto``."""
    data = src if isinstance(src, bytes) else Path(src).read_bytes()
    pieces: List[Tuple[str, float, int]] = []
    model = SentencePieceModel(pieces)
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:  # repeated SentencePiece pieces
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = float(
                        np.frombuffer(v2.to_bytes(4, "little"),
                                      np.float32)[0])
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append((piece, score, ptype))
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 3 and w2 == 0:
                    model.model_type = v2
                elif f2 == 35 and w2 == 0:
                    model.byte_fallback = bool(v2)
                elif f2 == 40 and w2 == 0:
                    model.trainer_unk_id = _sint32(v2)
        elif field == 3 and wire == 2:  # NormalizerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 3 and w2 == 0:
                    model.add_dummy_prefix = bool(v2)
                elif f2 == 4 and w2 == 0:
                    model.remove_extra_whitespaces = bool(v2)
                elif f2 == 5 and w2 == 0:
                    model.escape_whitespaces = bool(v2)
    model.__post_init__()  # rebuild piece_to_id now that pieces are final
    return model


# ---------------------------------------------------------------------------
# Normalization (NMT-NFKC approximation) + unigram Viterbi
# ---------------------------------------------------------------------------

# NMT normalization: C0/C1 controls and soft hyphen removed; the whitespace
# family mapped to plain space (precompiled_charsmap rules from
# sentencepiece's builder.cc nmt rules).
_NMT_DROP = {0x00AD}
_NMT_DROP.update(range(0x00, 0x09))
_NMT_DROP.update(range(0x0B, 0x0E))
_NMT_DROP.update(range(0x0E, 0x20))
_NMT_DROP.add(0x7F)
_NMT_DROP.update(range(0x80, 0xA0))
_NMT_SPACE = {0x09, 0x0A, 0x0D, 0x2028, 0x2029, 0x00A0, 0x1680, 0x205F,
              0x3000, 0xFEFF} | set(range(0x2000, 0x200C))


def normalize_nmt_nfkc(text: str, *, add_dummy_prefix: bool,
                       remove_extra_whitespaces: bool,
                       escape_whitespaces: bool) -> str:
    out = []
    for ch in unicodedata.normalize("NFKC", text):
        cp = ord(ch)
        if cp in _NMT_DROP:
            continue
        out.append(" " if cp in _NMT_SPACE else ch)
    s = "".join(out)
    if remove_extra_whitespaces:
        s = re.sub(r" +", " ", s).strip(" ")
    if add_dummy_prefix and s:
        s = " " + s
    if escape_whitespaces:
        s = s.replace(" ", SPIECE_UNDERLINE)
    return s


class UnigramEncoder:
    """Viterbi max-log-prob segmentation over a unigram piece vocab."""

    def __init__(self, model: SentencePieceModel):
        self.model = model
        # Matchable pieces: NORMAL + USER_DEFINED (control/unk/byte pieces
        # never match surface text directly).
        self._scores: Dict[str, Tuple[float, int]] = {}
        self._max_len = 1
        for i, (p, s, t) in enumerate(model.pieces):
            if t in (NORMAL, USER_DEFINED) and p:
                if p not in self._scores:
                    self._scores[p] = (s, i)
                    self._max_len = max(self._max_len, len(p))
        self._unk_score = model.min_score - _UNK_PENALTY
        self._byte_ids: Dict[int, int] = {}
        if model.byte_fallback:
            for i, (p, _, t) in enumerate(model.pieces):
                if t == BYTE and len(p) == 6 and p.startswith("<0x"):
                    self._byte_ids[int(p[3:5], 16)] = i

    def encode(self, normalized: str) -> List[int]:
        """IDs for an already-normalized string (no specials appended)."""
        s = normalized
        n = len(s)
        if n == 0:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)  # (start, id)
        best[0] = 0.0
        unk_id = self.model.unk_id
        for end in range(1, n + 1):
            lo = max(0, end - self._max_len)
            for start in range(lo, end):
                if best[start] == NEG:
                    continue
                hit = self._scores.get(s[start:end])
                if hit is not None:
                    cand = best[start] + hit[0]
                    if cand > best[end]:
                        best[end] = cand
                        back[end] = (start, hit[1])
            if best[end] == NEG:  # unknown char fallback (len-1 span)
                start = end - 1
                if best[start] > NEG:
                    best[end] = best[start] + self._unk_score
                    back[end] = (start, unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            if pid == self.model.unk_id and self._byte_ids:
                ids.extend(self._byte_ids.get(b, self.model.unk_id)
                           for b in reversed(s[start:pos].encode("utf-8")))
            else:
                ids.append(pid)
            pos = start
        ids.reverse()
        return ids

    def encode_text(self, text: str) -> List[int]:
        """Normalize (per the model's NormalizerSpec) then encode."""
        m = self.model
        return self.encode(normalize_nmt_nfkc(
            text, add_dummy_prefix=m.add_dummy_prefix,
            remove_extra_whitespaces=m.remove_extra_whitespaces,
            escape_whitespaces=m.escape_whitespaces))


# ---------------------------------------------------------------------------
# HF SiglipTokenizer-equivalent front end
# ---------------------------------------------------------------------------

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def canonicalize_text(text: str) -> str:
    """big_vision prompt canonicalization: ASCII punctuation stripped,
    whitespace runs collapsed, ends trimmed
    (transformers/models/siglip/tokenization_siglip.py:275-294)."""
    text = text.translate(_PUNCT_TABLE)
    return re.sub(r"\s+", " ", text).strip()


class SigLIPSPTokenizer:
    """Drop-in for :class:`HashTokenizer` backed by a real spiece.model.

    Replicates HF ``SiglipTokenizer.__call__(padding="max_length",
    max_length=64, truncation=True)``: ids ``[pieces..., </s>, pad...]``
    with pad = ``</s>``, fixed shape ``[B, context_length]`` int32.
    """

    def __init__(self, spiece: Union[str, Path, bytes],
                 context_length: int = 64, unk_token: str = "<unk>"):
        self.model = load_model_proto(spiece)
        if self.model.model_type != 1:
            raise ValueError(
                f"spiece model_type={self.model.model_type}; only unigram "
                "(1) is supported")
        # HF disables the dummy prefix on load
        # (tokenization_siglip.py:139-150) and prepends SPIECE_UNDERLINE
        # itself in tokenize().
        self.model.add_dummy_prefix = False
        self.encoder = UnigramEncoder(self.model)
        self.context_length = int(context_length)
        self.eos = self.model.eos_id
        self.pad = self.eos  # HF: pad_token = "</s>"
        if self.eos < 0:
            raise ValueError("spiece vocab has no </s> piece")
        self._unk_token = unk_token
        self._unk_prefix_len = len(self.encoder.encode_text(unk_token))

    @property
    def vocab_size(self) -> int:
        return len(self.model.pieces)

    def encode(self, text: str) -> List[int]:
        """Content ids only (no eos/pad) — HF ``_tokenize`` equivalent."""
        text = SPIECE_UNDERLINE + text.replace(SPIECE_UNDERLINE, " ")
        text = canonicalize_text(text)
        # "<unk>" prefix trick: with add_dummy_prefix off, sentencepiece
        # strips a leading SPIECE_UNDERLINE; encoding "<unk>" + text and
        # dropping the prefix's pieces preserves it
        # (tokenization_siglip.py:311-330).
        ids = self.encoder.encode_text(self._unk_token + text)
        return ids[self._unk_prefix_len:] if \
            len(ids) >= self._unk_prefix_len else ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.context_length), self.pad, np.int32)
        for row, text in enumerate(texts):
            ids = self.encode(text)[: self.context_length - 1] + [self.eos]
            out[row, : len(ids)] = ids
        return out


def find_spiece_model(checkpoint_dir: Optional[Path] = None) -> Optional[Path]:
    """Locate a spiece.model: ``VQT_SIGLIP_SPIECE`` env var, else
    ``<checkpoint_dir>/spiece.model``."""
    import os
    env = os.environ.get("VQT_SIGLIP_SPIECE")
    if env and Path(env).exists():
        return Path(env)
    if checkpoint_dir is not None:
        cand = Path(checkpoint_dir) / "spiece.model"
        if cand.exists():
            return cand
    return None
