"""CLIP text tokenization.

Copy of ``video_quierer_tpu/models/clip/tokenizer.py`` for the PyTorch
port, which cannot import the JAX package (its ``__init__`` imports
jax); keep the two in step.

The reference delegates to HuggingFace's ``CLIPProcessor``
(video_search_overhaul.py:283-284). This environment has no network access,
so we implement the CLIP byte-pair encoding from scratch:

- :class:`CLIPBPETokenizer` — the real algorithm (lowercase + whitespace
  clean, CLIP's regex word splitter, bytes→unicode mapping, end-of-word
  ``</w>`` merges). Loads ``vocab.json`` + ``merges.txt`` from a local
  checkpoint directory (the standard HF tokenizer file pair).
- :class:`HashTokenizer` — deterministic fallback when no vocab files exist:
  each cleaned word hashes to a stable id. Alignment with CLIP weights is
  meaningless then, but the full pipeline (fixed [B,77] int32 batches, EOT
  pooling via argmax) stays exercisable end-to-end — mirroring the role of
  the reference's keyword fallback ``_encode_visual_query``
  (video_search_overhaul.py:297-322).

Both produce ``[77]`` int32 sequences: ``[SOT, ...tokens..., EOT, EOT...]``
(padded with EOT, which is also what HF's CLIP pad token is; EOT pooling
takes the FIRST position of the max id, so padding does not disturb it).
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CONTEXT_LENGTH = 77
SOT = 49406
EOT = 49407
VOCAB_SIZE = 49408

# CLIP's exact word-split pattern: letters group, ONE digit per token
# (multi-digit numbers split per digit — the rule the pretrained BPE vocab
# assumes), punctuation runs. Uses the `regex` module for \p classes; the
# stdlib fallback approximates them with unicode-aware classes
# ([^\W\d_] = letters only).
try:
    import regex as _regex
    _WORD_RE = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover
    _WORD_RE = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|[0-9]|[^\s\w]+|_+",
        re.IGNORECASE | re.UNICODE,
    )


# CJK Unified Ideograph blocks (transformers BasicTokenizer._is_chinese_char):
# the HF CLIPTokenizer (the reference's tokenizer, video_search_overhaul.py:
# 283-284) routes text through BasicTokenizer when ftfy is absent, which
# emits each CJK character as its own word — so each gets its own
# end-of-word byte token. Matched here for byte-exact parity
# (tests/fixtures/tokenizer_goldens.json).
_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def _space_cjk(text: str) -> str:
    # ASCII fast path: the per-character range walk below costs ~12 ms
    # per 256-query serving flush (measured on the 1-core bench VM) and
    # can never fire for ASCII text — every CJK block starts above
    # U+3400. str.isascii() is a C-speed scan.
    if text.isascii():
        return text
    out = []
    for ch in text:
        cp = ord(ch)
        if any(lo <= cp <= hi for lo, hi in _CJK_RANGES):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    return "".join(out)


def _clean(text: str) -> str:
    text = _space_cjk(text)
    text = re.sub(r"\s+", " ", text.strip())
    return text.lower()


@functools.cache
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte→printable-unicode mapping."""
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


class TokenizerBase:
    context_length: int = CONTEXT_LENGTH
    # special-token ids — instance attributes when the vocab defines its
    # own (CLIPBPETokenizer below); OpenAI's 49406/49407 otherwise
    sot: int = SOT
    eot: int = EOT

    def encode_ids(self, text: str) -> List[int]:
        raise NotImplementedError

    def __call__(self, texts) -> np.ndarray:
        """Tokenize to a fixed ``[B, 77]`` int32 batch."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.context_length), self.eot,
                      dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + \
                self.encode_ids(text)[: self.context_length - 2] + \
                [self.eot]
            out[i, : len(ids)] = ids
        return out


class CLIPBPETokenizer(TokenizerBase):
    """Byte-pair encoding with CLIP's end-of-word convention."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self._cache: Dict[str, List[str]] = {}
        self._word_cache: Dict[str, List[int]] = {}
        # special ids come from the LOADED vocab (they equal 49406/49407
        # for the OpenAI artifacts, but any other vocab places them
        # elsewhere — assuming the constants would emit out-of-range ids
        # and NaN the text tower)
        self.sot = self.encoder.get("<|startoftext|>", SOT)
        self.eot = self.encoder.get("<|endoftext|>", EOT)

    # -- loading ---------------------------------------------------------

    @classmethod
    def from_dir(cls, path: Path) -> "CLIPBPETokenizer":
        """Load the HF tokenizer file pair (vocab.json + merges.txt)."""
        path = Path(path)
        with open(path / "vocab.json") as f:
            vocab = json.load(f)
        merges = cls._read_merges(path / "merges.txt")
        return cls(vocab, merges)

    @classmethod
    def from_bpe_file(cls, path: Path) -> "CLIPBPETokenizer":
        """Load OpenAI's ``bpe_simple_vocab_16e6.txt(.gz)`` single file and
        reconstruct the vocab the way the original CLIP tokenizer does."""
        path = Path(path)
        opener = gzip.open if path.suffix == ".gz" else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines[1: 49152 - 256 - 2 + 1]]
        chars = list(_bytes_to_unicode().values())
        vocab_list = chars + [c + "</w>" for c in chars]
        vocab_list += ["".join(m) for m in merges]
        vocab_list += ["<|startoftext|>", "<|endoftext|>"]
        vocab = {tok: i for i, tok in enumerate(vocab_list)}
        return cls(vocab, merges)

    @staticmethod
    def _read_merges(path: Path) -> List[Tuple[str, str]]:
        merges = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        return merges

    # -- encoding --------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    # Serving-path hot loop: the coalescer tokenizes a whole flush
    # (width × ~8 words) on the host per dispatch, and real query
    # streams repeat words heavily — cache the WHOLE word→ids mapping,
    # not just the BPE merge (measured 15.6 → ~3 ms per 256-query
    # flush on the 1-core bench VM). Bounded so adversarial streams
    # can't grow it without limit.
    _WORD_CACHE_MAX = 65536

    def _word_ids(self, word: str) -> List[int]:
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        enc = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
        ids = [tid for tid in (self.encoder.get(p) for p in self._bpe(enc))
               if tid is not None]
        if len(self._word_cache) >= self._WORD_CACHE_MAX:
            self._word_cache.clear()
            self._cache.clear()
        self._word_cache[word] = ids
        return ids

    def encode_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _WORD_RE.findall(_clean(text)):
            ids.extend(self._word_ids(word))
        return ids


class HashTokenizer(TokenizerBase):
    """Deterministic word-hash tokenizer (no vocab files required).

    Parameterizable for non-CLIP vocabularies (e.g. SigLIP's 32k vocab /
    64-token context, whose SentencePiece model isn't available offline).
    """

    _WORD_CACHE_MAX = 65536

    def __init__(self, context_length: int = CONTEXT_LENGTH,
                 vocab_size: int = VOCAB_SIZE,
                 sot: int = SOT, eot: int = EOT):
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.sot = sot
        self.eot = eot
        self._word_cache: Dict[str, int] = {}

    def encode_ids(self, text: str) -> List[int]:
        lo = min(self.sot, self.eot)
        ids = []
        cache = self._word_cache
        for word in _WORD_RE.findall(_clean(text)):
            tid = cache.get(word)
            if tid is None:
                h = int.from_bytes(
                    hashlib.md5(word.encode("utf-8")).digest()[:4],
                    "little")
                tid = 1 + h % (lo - 1)  # below both specials
                if len(cache) >= self._WORD_CACHE_MAX:
                    cache.clear()
                cache[word] = tid
            ids.append(tid)
        return ids


def load_tokenizer(checkpoint_dir: Optional[Path] = None) -> TokenizerBase:
    """Best tokenizer available: real BPE if vocab files exist, else hash."""
    if checkpoint_dir is not None:
        d = Path(checkpoint_dir)
        if (d / "vocab.json").exists() and (d / "merges.txt").exists():
            return CLIPBPETokenizer.from_dir(d)
        for name in ("bpe_simple_vocab_16e6.txt.gz",
                     "bpe_simple_vocab_16e6.txt"):
            if (d / name).exists():
                return CLIPBPETokenizer.from_bpe_file(d / name)
    return HashTokenizer()
