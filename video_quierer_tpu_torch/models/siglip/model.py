"""SigLIP in PyTorch (counterpart of
``video_quierer_tpu/models/siglip/model.py``).

Architecture of ``google/siglip-base-patch16-224``, both towers:

- tanh-GELU activation, LayerNorm eps 1e-6;
- vision: a biased conv patchify (the flax conv as a matmul over NHWC
  patches, with bias), NO class token and NO pre-LN, learned positions,
  non-causal encoder blocks, post-LN over every token, then the MAP head
  (a learned probe attends over the tokens, then ``x + MLP(LN(x))``),
  pooled at the probe;
- text: token + learned position embedding, NON-causal encoder blocks,
  final LayerNorm, pooled at the LAST position (``x[:, -1]``), a linear
  head;
- no projection to a shared width: both towers give ``hidden_size``-wide
  rows, L2 normalised in f32.

The encoder blocks are the CLIP port's (``models/clip/model.py``, with
``act="gelu_tanh"``); their attention is kernel B3. The MAP head's one
query attends in plain PyTorch, as the flax head's einsums. Module and
parameter names follow the flax tree (``models/siglip/bridge.py`` maps
one onto the other).

Training (JAX ``:164-211``): ``forward(pixels, input_ids)`` returns
``(img, txt, exp(logit_scale), logit_bias)``, both scalars f32 parameters
initialised from the config, for :func:`siglip_sigmoid_loss`. ``dtype``
and ``remat`` work as in ``models/clip/model.py``; the MAP head keeps
its own einsum attention, as JAX's does. Under the trainer's tensor
parallelism the forwards take a ``plan`` (``models/clip/model.py``): the
encoder blocks go through ``plan.block`` and the MAP head through
``plan.map_head``, whose parts are :meth:`MAPHead.heads_out` on a column
slice of q, k and v.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from video_quierer_tpu_torch.models.clip.model import (
    MLP,
    EncoderBlock,
    LayerNorm,
    Linear,
    _normalize_f32,
    configure_towers,
    run_blocks,
)


@dataclasses.dataclass(frozen=True)
class SigLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class SigLIPTextConfig:
    vocab_size: int = 32_000
    context_length: int = 64
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    name: str = "siglip-base-patch16-224"
    vision: SigLIPVisionConfig = dataclasses.field(
        default_factory=SigLIPVisionConfig)
    text: SigLIPTextConfig = dataclasses.field(
        default_factory=SigLIPTextConfig)
    logit_scale_init: float = 2.303   # ln(10), the paper's t' init
    logit_bias_init: float = -10.0


def siglip_base_patch16() -> SigLIPConfig:
    return SigLIPConfig()


class MAPHead(nn.Module):
    """Multi-head attention pooling: a learned probe attends over the
    tokens (f32 logits, softmax, weights cast to the dtype), out-proj,
    then ``x + MLP(LN(x))``; returns the probe's row ``[B, D]``."""

    def __init__(self, d: int, num_heads: int, mlp_ratio: int, eps: float):
        super().__init__()
        self.num_heads = num_heads
        self.probe = nn.Parameter(torch.zeros(1, 1, d))
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d)
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)
        self.layernorm = LayerNorm(d, eps)
        self.mlp = MLP(d, mlp_ratio, "gelu_tanh")

    def heads_out(self, tokens: torch.Tensor, w: Dict[str, torch.Tensor],
                  num_heads: int) -> torch.Tensor:
        """The probe's attention over ``num_heads`` heads whose q, k, v
        columns are ``w["q_proj.weight"]``, ``w["q_proj.bias"]`` (and k,
        v): ``[B, 1, num_heads·hd]`` in the tokens' dtype, before the out
        projection."""
        b, s, d = tokens.shape
        dt = tokens.dtype
        q, k, v = (F.linear(x, w[f"{n}.weight"].to(dt),
                            w[f"{n}.bias"].to(dt))
                   for n, x in (("q_proj",
                                 self.probe.to(dt).expand(b, 1, d)),
                                ("k_proj", tokens), ("v_proj", tokens)))
        h = num_heads
        hd = q.shape[-1] // h
        qh = (q * hd ** -0.5).reshape(b, 1, h, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(),
                              k.reshape(b, s, h, hd).float())
        weights = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.float(),
                           v.reshape(b, s, h, hd).float())
        return out.to(dt).reshape(b, 1, h * hd)

    def part(self, tokens: torch.Tensor, w: Dict[str, torch.Tensor],
             num_heads: int) -> torch.Tensor:
        """One tensor-parallel part of the head's attention: its heads
        (:meth:`heads_out`) through the out projection's matching input
        columns ``w["out_proj.weight"]``, without its bias."""
        return F.linear(self.heads_out(tokens, w, num_heads),
                        w["out_proj.weight"].to(tokens.dtype))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        w = {f"{n}.{leaf}": getattr(getattr(self, n), leaf)
             for n in ("q_proj", "k_proj", "v_proj")
             for leaf in ("weight", "bias")}
        x = self.out_proj(self.heads_out(tokens, w, self.num_heads))
        x = x + self.mlp(self.layernorm(x))
        return x[:, 0]


class SigLIPVisionTower(nn.Module):
    def __init__(self, c: SigLIPVisionConfig):
        super().__init__()
        self.cfg = c
        self.compute_dtype: Optional[torch.dtype] = None
        self.remat = False
        d, p = c.hidden_size, c.patch_size
        # the flax conv kernel [p, p, 3, D] (HWIO) as a [D, p*p*3] matrix
        # over patches flattened in (row, column, channel) order, + bias
        self.patch_embedding = Linear(p * p * 3, d)
        self.position_embedding = nn.Parameter(
            torch.zeros(c.num_patches, d))
        self.layers = nn.ModuleList(
            EncoderBlock(c, causal=False, act="gelu_tanh")
            for _ in range(c.num_layers))
        self.post_layernorm = LayerNorm(d, c.layer_norm_eps)
        self.head = MAPHead(d, c.num_heads, c.mlp_ratio, c.layer_norm_eps)

    def embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """NHWC ``[B, H, W, 3]`` normalised pixels → tokens ``[B, S, D]``:
        patchify (with bias) and positions."""
        c = self.cfg
        b = pixels.shape[0]
        p, g = c.patch_size, c.image_size // c.patch_size
        dtype = self.compute_dtype or self.position_embedding.dtype
        patches = (pixels.to(dtype).reshape(b, g, p, g, p, 3)
                   .permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3))
        return self.patch_embedding(patches) \
            + self.position_embedding.to(dtype)[None]

    def pool(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        """Encoded tokens ``[B, S, D]`` → post-LN → the MAP head's row."""
        x = self.post_layernorm(x)
        return self.head(x) if plan is None else plan.map_head(self.head, x)

    def forward(self, pixels: torch.Tensor, plan=None) -> torch.Tensor:
        """NHWC ``[B, H, W, 3]`` normalised pixels → pooled features
        ``[B, hidden]`` in the tower dtype."""
        return self.pool(run_blocks(self.layers, self.embed(pixels),
                                    self.remat, plan=plan), plan)


class SigLIPTextTower(nn.Module):
    def __init__(self, c: SigLIPTextConfig):
        super().__init__()
        self.cfg = c
        self.compute_dtype: Optional[torch.dtype] = None
        self.remat = False
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(c.context_length, c.hidden_size))
        self.layers = nn.ModuleList(
            EncoderBlock(c, causal=False, act="gelu_tanh")
            for _ in range(c.num_layers))
        self.final_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.head = Linear(c.hidden_size, c.hidden_size)

    def forward(self, input_ids: torch.Tensor, plan=None) -> torch.Tensor:
        """``[B, S]`` ids → head features ``[B, hidden]``, pooled at the
        last position."""
        dtype = self.compute_dtype or self.token_embedding.weight.dtype
        x = F.embedding(input_ids, self.token_embedding.weight.to(dtype)) \
            + self.position_embedding[: input_ids.shape[1]].to(dtype)[None]
        x = run_blocks(self.layers, x, self.remat, plan=plan)
        return self.head(self.final_layer_norm(x)[:, -1])


class SigLIP(nn.Module):
    """Dual-tower SigLIP with a trainable logit scale and bias."""

    def __init__(self, cfg: SigLIPConfig,
                 dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.vision = SigLIPVisionTower(cfg.vision)
        self.text = SigLIPTextTower(cfg.text)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init))
        self.logit_bias = nn.Parameter(torch.tensor(cfg.logit_bias_init))
        configure_towers((self.vision, self.text), dtype, remat)

    def encode_image(self, pixels: torch.Tensor, normalize: bool = True,
                     plan=None) -> torch.Tensor:
        return _normalize_f32(self.vision(pixels, plan), normalize)

    def encode_text(self, input_ids: torch.Tensor, normalize: bool = True,
                    plan=None) -> torch.Tensor:
        return _normalize_f32(self.text(input_ids, plan), normalize)

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor,
                plan=None):
        """Training forward: ``(image_feats, text_feats, exp(logit_scale),
        logit_bias)``; each encoder block and the MAP head through
        ``plan`` when one is given."""
        return (self.encode_image(pixels, plan=plan),
                self.encode_text(input_ids, plan=plan),
                self.logit_scale.exp(), self.logit_bias)


def siglip_sigmoid_loss(image_feats: torch.Tensor, text_feats: torch.Tensor,
                        logit_scale: torch.Tensor, logit_bias: torch.Tensor
                        ) -> torch.Tensor:
    """Pairwise sigmoid loss (JAX ``siglip_sigmoid_loss``): every (i, j)
    pair a binary problem, positive on the diagonal; f32 logits."""
    logits = logit_scale * (image_feats.float() @ text_feats.float().t()) \
        + logit_bias
    n = logits.shape[0]
    signs = 2.0 * torch.eye(n, device=logits.device) - 1.0
    return -F.logsigmoid(signs * logits).mean()
