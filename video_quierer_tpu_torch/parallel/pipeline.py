"""Pipeline parallelism of the image tower, GPipe's schedule (counterpart
of ``video_quierer_tpu/parallel/pipeline.py``).

Stage ``s`` of ``S`` owns encoder layers ``[s·L/S, (s+1)·L/S)`` on
``devices[s]``; ``M`` microbatches flow stage to stage in GPipe order,
each hop a ``.to(next_device, non_blocking=True)``, so the pipeline stays
differentiable through the copies. Devices may repeat, as in a
``CorpusMesh``: one card (or ``"cpu"``) can hold several stages.

The JAX package runs the schedule under ``shard_map``: every stage runs
its layers at every one of the ``M + S - 1`` ticks and throws the bubble
ticks' results away, ``(M + S - 1) · L`` block calls a batch. The port is
single-controller and runs only the real (stage, microbatch) pairs, ``M ·
L`` block calls a batch, with the same results (ROADMAP C).

- :func:`stack_layer_params` / :func:`unstack_layer_params`: the
  per-layer modules' parameters on a leading ``[L, ...]`` axis and back
  (differentiable), for a ``block_apply`` that calls
  ``torch.func.functional_call`` on a layer's parameter dict;
- :func:`shard_layers`: stages of the layer modules themselves, moved to
  their devices (in place; a no-op on the device they are on), for a
  ``block_apply`` that calls the module — the serving path's, which keeps
  one copy of the weights;
- :func:`pipelined_encode_image`: the image embedding with the vision
  encoder's blocks pipelined, its front and back ends as the JAX
  function computes them (the conv as a patch matmul, ``_layer_norm``'s
  f32 form, the post-LN on the CLS token, the projection, the L2
  normalise in the compute dtype, then f32) — not the tower's LayerNorm
  modules, whose variance is another sum.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import torch
from torch import nn



@dataclasses.dataclass
class Stage:
    """One pipeline stage: its device and its layers, in order (modules
    or parameter dicts, whatever the ``block_apply`` takes)."""

    device: torch.device
    layers: List


def stack_layer_params(layers: Sequence[nn.Module]
                       ) -> Dict[str, torch.Tensor]:
    """The layers' parameters by name, stacked on a leading ``[L, ...]``
    axis (the axis the pipe splits). Layers whose parameters differ from
    layer 0's (a Switch-MoE block among dense ones) raise
    ``ValueError``."""
    named = [dict(layer.named_parameters()) for layer in layers]
    keys = list(named[0])
    for i, params in enumerate(named):
        if list(params) != keys:
            raise ValueError(f"layer {i}'s parameters differ from layer "
                             "0's: only identical blocks stack")
    return {k: torch.stack([p[k] for p in named]) for k in keys}


def unstack_layer_params(stacked: Dict[str, torch.Tensor],
                         num_layers: int) -> List[Dict[str, torch.Tensor]]:
    """Inverse of :func:`stack_layer_params`: one dict per layer (views)."""
    return [{k: v[i] for k, v in stacked.items()} for i in range(num_layers)]


def _per_stage(n_layers: int, n_stages: int) -> int:
    if n_stages < 1 or n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{n_stages} pipeline stages")
    return n_layers // n_stages


def shard_layers(layers: Sequence, devices: Sequence) -> List[Stage]:
    """Stages of ``layers`` (modules, or parameter dicts from
    :func:`unstack_layer_params`): stage ``s`` holds its contiguous
    ``L/S`` layers, moved to ``devices[s]`` (a module in place)."""
    per = _per_stage(len(layers), len(devices))
    stages = []
    for s, dev in enumerate(devices):
        dev = torch.device(dev)
        stages.append(Stage(dev, [_to(layer, dev) for layer in
                                  layers[s * per:(s + 1) * per]]))
    return stages


def _to(layer, dev: torch.device):
    if isinstance(layer, nn.Module):
        return layer.to(dev)
    return {k: v.to(dev, non_blocking=True) for k, v in layer.items()}


def pipeline_blocks(block_apply: Callable, stages: Sequence[Stage],
                    x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """``x [B, ...]`` through every stage's layers, GPipe's schedule:
    at tick ``t`` stage ``s`` runs microbatch ``t - s``.
    ``block_apply(layer, act)`` runs one layer. Returns ``[B, ...]`` on
    ``x``'s device, the layers' sequential result up to float
    reassociation."""
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by M={n_microbatches}")
    mb = b // n_microbatches
    n_stages = len(stages)
    acts: List = [x[m * mb:(m + 1) * mb] for m in range(n_microbatches)]
    for t in range(n_microbatches + n_stages - 1):
        for s, stage in enumerate(stages):
            m = t - s
            if not 0 <= m < n_microbatches:
                continue
            a = acts[m].to(stage.device, non_blocking=True)
            for layer in stage.layers:
                a = block_apply(layer, a)
            acts[m] = a
    return torch.cat([a.to(x.device, non_blocking=True) for a in acts])


def _layer_norm(x: torch.Tensor, ln, eps: float,
                dtype: torch.dtype) -> torch.Tensor:
    """JAX ``pipeline.py:_layer_norm``: f32 mean and (two-pass)
    variance, ``(y · scale + bias)`` in f32, cast to ``dtype``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mu).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * ln.weight.float() + ln.bias.float()).to(dtype)


def call_layer(layer: nn.Module, act: torch.Tensor) -> torch.Tensor:
    """``block_apply`` over module stages."""
    return layer(act)


def pipelined_encode_image(model, pixels: torch.Tensor, *,
                           stages: Sequence[Stage], n_microbatches: int,
                           normalize: bool = True) -> torch.Tensor:
    """CLIP image embedding ``[B, proj]`` f32 with the vision encoder's
    blocks pipelined over ``stages`` (module stages, from
    :func:`shard_layers` over ``model.vision.layers``). The front end and
    the head run on ``pixels``' device."""
    vt = model.vision
    c = vt.cfg
    dtype = vt.compute_dtype or vt.class_embedding.dtype
    x = _layer_norm(vt.tokens(pixels), vt.pre_layernorm, c.layer_norm_eps,
                    dtype)
    x = pipeline_blocks(call_layer, stages, x, n_microbatches)
    pooled = _layer_norm(x[:, 0], vt.post_layernorm, c.layer_norm_eps,
                         dtype)
    feats = pooled @ model.visual_projection.weight.to(dtype).t()
    if normalize:
        feats = feats / torch.linalg.vector_norm(feats, dim=-1,
                                                 keepdim=True)
    return feats.float()
