"""Seeded inputs, made by the benchmark and handed alike to the program
and to the plain reference: weights, library rows, frames, captions and
query words.

Everything is drawn from ``torch.Generator`` streams keyed by ``(seed,
tag)``, on the device, in a few large calls. The same seed gives the same
inputs; the reference regenerates them after the window instead of
keeping a copy beside the program.

Frozen copies (with their origin): :func:`words` follows
``chip_smoke.py:words`` (lowercase words of 4-8 letters, one token each
for the hash tokenizer), :func:`corpus_chunks` ``chip_smoke.py:
corpus_on_card`` (unit f32 rows from ``randn``), :func:`frame_pool`
``chip_smoke.py:seeded_frames`` (uniform uint8 RGB frames), here drawn
on the device and given a coarse colour layout.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

IMAGE = 224
SOT, EOT = 49406, 49407
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# rows a library chunk holds: whole videos of 200 frames (or 1,000)
CORPUS_CHUNK = 262_000


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    h = hashlib.blake2b(f"{int(seed)}/{tag}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(device, seed: int, tag: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, tag))


# -- weights ----------------------------------------------------------------

def _block_leaves(prefix: str, layers: int, d: int, f: int) -> list:
    out = []
    for i in range(layers):
        p = f"{prefix}.layers.{i}."
        out += [(p + "layer_norm1.weight", (d,), "ln_w"),
                (p + "layer_norm1.bias", (d,), "bias")]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(p + f"attn.{proj}.weight", (d, d), "dense"),
                    (p + f"attn.{proj}.bias", (d,), "bias")]
        out += [(p + "layer_norm2.weight", (d,), "ln_w"),
                (p + "layer_norm2.bias", (d,), "bias"),
                (p + "mlp.fc1.weight", (f, d), "dense"),
                (p + "mlp.fc1.bias", (f,), "bias"),
                (p + "mlp.fc2.weight", (d, f), "dense"),
                (p + "mlp.fc2.bias", (d,), "bias")]
    return out


def leaf_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter of the dual-tower CLIP,
    under the names of its published module tree (the port's state dict
    takes the same names)."""
    t, v = cfg["text_config"], cfg["vision_config"]
    dt, dv, p = t["hidden_size"], v["hidden_size"], v["patch_size"]
    seq = (v["image_size"] // p) ** 2 + 1
    out = [("text.token_embedding.weight", (t["vocab_size"], dt), "embed"),
           ("text.position_embedding", (t["max_position_embeddings"], dt),
            "embed")]
    out += _block_leaves("text", t["num_hidden_layers"], dt,
                         t["intermediate_size"])
    out += [("text.final_layer_norm.weight", (dt,), "ln_w"),
            ("text.final_layer_norm.bias", (dt,), "bias"),
            ("text_projection.weight", (cfg["projection_dim"], dt), "dense"),
            ("vision.patch_embedding.weight", (dv, p * p * 3), "dense"),
            ("vision.class_embedding", (dv,), "embed"),
            ("vision.position_embedding", (seq, dv), "embed"),
            ("vision.pre_layernorm.weight", (dv,), "ln_w"),
            ("vision.pre_layernorm.bias", (dv,), "bias")]
    out += _block_leaves("vision", v["num_hidden_layers"], dv,
                         v["intermediate_size"])
    out += [("vision.post_layernorm.weight", (dv,), "ln_w"),
            ("vision.post_layernorm.bias", (dv,), "bias"),
            ("visual_projection.weight", (cfg["projection_dim"], dv),
             "dense")]
    return out


def weights(cfg: dict, device, dtype: torch.dtype, seed: int
            ) -> Dict[str, torch.Tensor]:
    """The seeded state dict in ``dtype`` on ``device``: one ``randn``
    call for all leaves, each a view scaled in place — dense matrices
    LeCun-normal (std ``1/sqrt(fan_in)``), embeddings std 0.02, biases std
    0.02, LayerNorm scales ``1 + 0.02 n``; ``logit_scale`` the published
    init ``ln(1/0.07)``."""
    specs = leaf_specs(cfg)
    total = sum(math.prod(s) for _, s, _ in specs)
    flat = torch.randn(total, generator=generator(device, seed, "weights"),
                       device=device, dtype=dtype)
    sd, pos = {}, 0
    with torch.no_grad():
        for name, shape, kind in specs:
            n = math.prod(shape)
            leaf = flat[pos:pos + n].view(shape)
            pos += n
            if kind == "dense":
                leaf.mul_(1.0 / math.sqrt(shape[1]))
            else:
                leaf.mul_(0.02)
                if kind == "ln_w":
                    leaf.add_(1.0)
            sd[name] = leaf
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07), dtype=torch.float32,
                                     device=device)
    return sd


# -- library rows -----------------------------------------------------------

def corpus_chunks(device, n_rows: int, dim: int, seed: int
                  ) -> Iterator[Tuple[int, torch.Tensor]]:
    """``(first row, [<= CORPUS_CHUNK, dim] f32 unit rows)`` on ``device``,
    in order: the library, drawn chunk by chunk from one stream."""
    g = generator(device, seed, "corpus")
    for lo in range(0, n_rows, CORPUS_CHUNK):
        m = min(CORPUS_CHUNK, n_rows - lo)
        rows = torch.randn(m, dim, generator=g, device=device)
        rows /= torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
        yield lo, rows


# -- frames -----------------------------------------------------------------

def frame_pool(device, n_videos: int, n_frames: int, seed: int,
               image: int = IMAGE) -> np.ndarray:
    """``[n_videos, n_frames, image, image, 3]`` uint8 RGB frames made on
    ``device`` and copied to the host once: a random 7 x 7 colour layout
    (three quarters of the range) over uniform fine noise, so that frames
    differ in what the towers see and not only in their noise."""
    g = generator(device, seed, "frames")
    cell = image // 7
    out = np.empty((n_videos, n_frames, image, image, 3), np.uint8)
    for v in range(n_videos):
        coarse = torch.randint(0, 256, (n_frames, 7, 7, 3), generator=g,
                               device=device, dtype=torch.int32)
        fine = torch.randint(0, 64, (n_frames, image, image, 3),
                             generator=g, device=device, dtype=torch.int32)
        layout = coarse.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
        out[v] = (layout * 3 // 4 + fine).to(torch.uint8).cpu().numpy()
    return out


def normalize_pixels(frames_u8: torch.Tensor) -> torch.Tensor:
    """CLIP's published normalisation in f32: ``(x / 255 - mean) / std``,
    NHWC."""
    mean = torch.tensor(CLIP_MEAN, device=frames_u8.device)
    std = torch.tensor(CLIP_STD, device=frames_u8.device)
    return (frames_u8.float() / 255.0 - mean) / std


# -- captions and queries -----------------------------------------------------

def caption_ids(device, n: int, context: int, seed: int, tag: str,
                min_tokens: int, max_tokens: int) -> torch.Tensor:
    """``[n, context]`` int64 token ids: SOT, ``min_tokens..max_tokens``
    word ids below SOT, EOT, EOT padding (the tokenizer's layout)."""
    g = generator(device, seed, tag)
    ids = torch.randint(1, SOT, (n, context), generator=g, device=device)
    lens = torch.randint(min_tokens, max_tokens + 1, (n,), generator=g,
                         device=device)
    pos = torch.arange(context, device=device)[None]
    ids = torch.where(pos <= lens[:, None], ids, EOT)
    ids[:, 0] = SOT
    return ids


_LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def words(r: np.random.Generator, n: int) -> List[str]:
    """``n`` random lowercase words of 4-8 letters."""
    return ["".join(r.choice(_LETTERS, size=r.integers(4, 9)))
            for _ in range(n)]


def geometric_lengths(n: int, p: float, cap: int) -> np.ndarray:
    """``n`` query lengths of ``1 + Geometric(p)`` words capped at
    ``cap``, as a fixed multiset: each length occurs as often as its
    probability says (largest remainders), so every seed sends the same
    sizes, in another order."""
    lens = np.arange(2, cap + 1)
    prob = (1 - p) ** (lens - 2) * p
    prob[-1] += (1 - p) ** (cap - 1)
    want = prob * n
    counts = np.floor(want).astype(int)
    rest = n - counts.sum()
    counts[np.argsort(-(want - counts), kind="stable")[:rest]] += 1
    return np.repeat(lens, counts)


def query_pool(seed: int, n: int, vocab: int, p: float, cap: int
               ) -> List[str]:
    """``n`` queries over a fixed seeded vocabulary of ``vocab`` words,
    lengths from :func:`geometric_lengths`, shuffled by ``seed``."""
    vocab_words = words(rng(0, "vocabulary"), vocab)
    r = rng(seed, "queries")
    lens = r.permutation(geometric_lengths(n, p, cap))
    return [" ".join(vocab_words[i] for i in r.integers(0, vocab, size=m))
            for m in lens]
