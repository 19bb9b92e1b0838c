"""The word-hash tokenizer the program serves with when no vocabulary
files are present, frozen: a copy of ``HashTokenizer`` and its text
cleaning from ``video_quierer_tpu_torch/models/clip/tokenizer.py`` (ASCII
text only: the benchmark's queries are lowercase ASCII words, so the
CJK spacing and the ``regex`` word classes of the original change
nothing here).

Each cleaned word maps to ``1 + md5(word)[:4] (little-endian) % (SOT -
1)``; a query becomes ``[SOT, ids[:75], EOT]`` padded with EOT to 77.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Sequence

import numpy as np

CONTEXT_LENGTH = 77
SOT = 49406
EOT = 49407

_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|[0-9]|[^\s\w]+|_+",
    re.IGNORECASE | re.UNICODE,
)


def _clean(text: str) -> str:
    if not text.isascii():
        raise ValueError("the frozen tokenizer takes ASCII text only")
    return re.sub(r"\s+", " ", text.strip()).lower()


def encode_ids(text: str) -> List[int]:
    lo = min(SOT, EOT)
    return [1 + int.from_bytes(hashlib.md5(w.encode("utf-8")).digest()[:4],
                               "little") % (lo - 1)
            for w in _WORD_RE.findall(_clean(text))]


def tokenize(texts: Sequence[str]) -> np.ndarray:
    """``[B, 77]`` int64 ids."""
    out = np.full((len(texts), CONTEXT_LENGTH), EOT, dtype=np.int64)
    for i, text in enumerate(texts):
        ids = [SOT] + encode_ids(text)[: CONTEXT_LENGTH - 2] + [EOT]
        out[i, : len(ids)] = ids
    return out


def token_count(text: str) -> int:
    """Tokens of one query, SOT and EOT included."""
    return min(len(encode_ids(text)), CONTEXT_LENGTH - 2) + 2
