"""Port tokenizer (video_quierer_tpu_torch/models/clip/tokenizer.py, a
copy) vs the JAX package's: identical ids on the committed goldens and on
the hash tokenizer the seeded towers use."""

import json
from pathlib import Path

import numpy as np
import pytest

from video_quierer_tpu.models.clip import tokenizer as jax_tok
from video_quierer_tpu_torch.models.clip import tokenizer as torch_tok

FIXTURE = Path(__file__).parent / "fixtures" / "tokenizer_goldens.json"

PHRASES = [
    "a dog running on the beach",
    "Ünïcödé, punctuation!!! and digits 12345",
    "",
    "the " * 100,
    "猫 and 犬 side by side",
]


@pytest.fixture(scope="module")
def goldens():
    return json.loads(FIXTURE.read_text())["clip_bpe"]


def _bpe(mod, g):
    merges = [tuple(m.split(" ")) for m in g["merges"]]
    return mod.CLIPBPETokenizer(g["vocab"], merges)


def test_bpe_goldens_identical(goldens):
    port, ref = _bpe(torch_tok, goldens), _bpe(jax_tok, goldens)
    for case in goldens["goldens"]:
        assert port.encode_ids(case["text"]) == case["ids"]
        assert port.encode_ids(case["text"]) == ref.encode_ids(case["text"])


def test_bpe_batch_framing_identical(goldens):
    port, ref = _bpe(torch_tok, goldens), _bpe(jax_tok, goldens)
    texts = [c["text"] for c in goldens["goldens"]]
    np.testing.assert_array_equal(port(texts), ref(texts))


@pytest.mark.parametrize("context_length", [77, 16])
def test_hash_tokenizer_identical(context_length):
    port = torch_tok.HashTokenizer(context_length=context_length)
    ref = jax_tok.HashTokenizer(context_length=context_length)
    got, want = port(PHRASES), ref(PHRASES)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_load_tokenizer_defaults_to_hash():
    assert isinstance(torch_tok.load_tokenizer(None),
                      torch_tok.HashTokenizer)
