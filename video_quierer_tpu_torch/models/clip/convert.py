"""HuggingFace CLIP checkpoint → parameter tree (counterpart of
``video_quierer_tpu/models/clip/convert.py``).

Weights load from a **local** checkpoint directory in the HF layout
(``model.safetensors`` or ``pytorch_model.bin``, with ``vocab.json`` and
``merges.txt`` beside them); nothing is downloaded. The converter returns
the JAX package's numpy tree, array for array, so that the weights cross
into the port's modules through the one mapping the parity tests already
hold, ``bridge.params_from_jax``.

- :func:`load_safetensors` is the port's own reader of the safetensors
  format (the card's machine has no ``safetensors`` package): an 8-byte
  little-endian header length, the JSON header (``dtype``, ``shape``,
  ``data_offsets`` counted from the end of the header; ``__metadata__``
  skipped), then the raw little-endian bytes, mapped copy-on-write so a
  1.7 GB ViT-L/14 file is not read twice. It takes exactly the dtypes
  ``safetensors.numpy.load_file`` takes and raises where that raises
  (``BF16`` and the 8-bit floats: numpy has no such dtype).
- ``pytorch_model.bin`` goes through ``torch.load(weights_only=True)``.
- Conventions converted: torch ``Linear.weight`` ``[out, in]`` → kernel
  ``[in, out]``; the conv ``[D, 3, p, p]`` → HWIO ``[p, p, 3, D]``; HF's
  module names, ``pre_layrnorm`` spelling included. Keys the converter
  does not read (the ``position_ids`` buffers of older checkpoints) are
  ignored.
- :func:`find_local_checkpoint` looks where the reference looks:
  ``$VQT_CLIP_CHECKPOINT``, ``./checkpoints/<short name>``, then the HF
  hub cache's ``snapshots/`` under ``~/.cache/huggingface/hub``.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from video_quierer_tpu_torch.models.clip.config import CLIPConfig

# safetensors dtype → numpy dtype, as safetensors.numpy maps them
SAFETENSORS_DTYPES = {
    "BOOL": np.bool_, "U8": np.uint8, "I8": np.int8, "U16": np.uint16,
    "I16": np.int16, "F16": np.float16, "U32": np.uint32, "I32": np.int32,
    "F32": np.float32, "C64": np.complex64, "U64": np.uint64,
    "I64": np.int64, "F64": np.float64,
}
# dtypes the format has and numpy does not: load_file raises on them too
_NO_NUMPY_DTYPE = {"BF16", "F8_E4M3", "F8_E5M2", "F8_E8M0", "F8_E4M3FNUZ",
                   "F8_E5M2FNUZ", "F4", "F6_E2M3", "F6_E3M2"}
_MAX_HEADER = 100_000_000


def load_safetensors(path: Path) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file as ``{name: array}`` in file order: each
    array a copy-on-write view of the mapped file (writable; a write
    copies only its page)."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", f.read(8))
        if n > _MAX_HEADER or 8 + n > size:
            raise ValueError(f"{path}: header length {n} out of range")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) \
            if size > 8 + n else b""
    header.pop("__metadata__", None)
    entries = sorted(header.items(), key=lambda kv: kv[1]["data_offsets"])
    out, end = {}, 0
    for name, info in entries:
        dt = info["dtype"]
        if dt in _NO_NUMPY_DTYPE:
            raise TypeError(f"data type {dt!r} of tensor {name!r} has no "
                            "numpy counterpart")
        if dt not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: unknown data type {dt!r}")
        dtype = np.dtype(SAFETENSORS_DTYPES[dt]).newbyteorder("<")
        shape = tuple(int(d) for d in info["shape"])
        lo, hi = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        if lo != end or hi - lo != count * dtype.itemsize:
            raise ValueError(f"{path}: invalid offsets for tensor {name!r}")
        end = hi
        out[name] = np.frombuffer(buf, dtype, count, 8 + n + lo) \
            .reshape(shape) if count else np.zeros(shape, dtype)
    if 8 + n + end != size:
        raise ValueError(f"{path}: the header does not cover the file")
    return out


def _load_state_dict(ckpt_dir: Path) -> Dict[str, np.ndarray]:
    ckpt_dir = Path(ckpt_dir)
    st = ckpt_dir / "model.safetensors"
    if st.exists():
        return load_safetensors(st)
    bin_path = ckpt_dir / "pytorch_model.bin"
    if bin_path.exists():
        import torch
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in sd.items()}
    raise FileNotFoundError(
        f"no model.safetensors or pytorch_model.bin under {ckpt_dir}")


def _linear(sd, prefix: str, bias: bool = True) -> Dict[str, np.ndarray]:
    out = {"kernel": np.ascontiguousarray(sd[prefix + ".weight"].T)}
    if bias:
        out["bias"] = sd[prefix + ".bias"]
    return out


def _layernorm(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _encoder_layers(sd, prefix: str, n_layers: int) -> Dict:
    layers = {}
    for i in range(n_layers):
        p = f"{prefix}.layers.{i}"
        layers[f"layers_{i}"] = {
            "layer_norm1": _layernorm(sd, f"{p}.layer_norm1"),
            "layer_norm2": _layernorm(sd, f"{p}.layer_norm2"),
            "attn": {
                "q_proj": _linear(sd, f"{p}.self_attn.q_proj"),
                "k_proj": _linear(sd, f"{p}.self_attn.k_proj"),
                "v_proj": _linear(sd, f"{p}.self_attn.v_proj"),
                "out_proj": _linear(sd, f"{p}.self_attn.out_proj"),
            },
            "mlp": {
                "fc1": _linear(sd, f"{p}.mlp.fc1"),
                "fc2": _linear(sd, f"{p}.mlp.fc2"),
            },
        }
    return layers


def convert_hf_checkpoint(ckpt_dir: Path, cfg: CLIPConfig) -> Dict:
    """The JAX package's ``CLIP`` parameter tree (numpy leaves) from an HF
    checkpoint dir."""
    sd = _load_state_dict(ckpt_dir)
    v, t = cfg.vision, cfg.text
    patch = sd["vision_model.embeddings.patch_embedding.weight"]
    return {
        "vision": {
            "patch_embedding": {
                "kernel": np.ascontiguousarray(
                    np.transpose(patch, (2, 3, 1, 0))),
            },
            "class_embedding":
                sd["vision_model.embeddings.class_embedding"].reshape(-1),
            "position_embedding":
                sd["vision_model.embeddings.position_embedding.weight"],
            # NB: HF spells it "pre_layrnorm"
            "pre_layernorm": _layernorm(sd, "vision_model.pre_layrnorm"),
            "encoder": _encoder_layers(sd, "vision_model.encoder",
                                       v.num_layers),
            "post_layernorm": _layernorm(sd, "vision_model.post_layernorm"),
        },
        "text": {
            "token_embedding": {
                "embedding":
                    sd["text_model.embeddings.token_embedding.weight"],
            },
            "position_embedding":
                sd["text_model.embeddings.position_embedding.weight"],
            "encoder": _encoder_layers(sd, "text_model.encoder",
                                       t.num_layers),
            "final_layer_norm":
                _layernorm(sd, "text_model.final_layer_norm"),
        },
        "visual_projection": _linear(sd, "visual_projection", bias=False),
        "text_projection": _linear(sd, "text_projection", bias=False),
        "logit_scale": sd["logit_scale"].reshape(()),
    }


def find_local_checkpoint(name: str = "openai/clip-vit-base-patch32"
                          ) -> Optional[Path]:
    """Look for a usable local checkpoint directory.

    Checks (in order): ``$VQT_CLIP_CHECKPOINT``, ``./checkpoints/<name>``,
    the HF hub cache layout under ``~/.cache/huggingface``. The first
    directory holding either weight file wins.
    """
    cands = []
    env = os.environ.get("VQT_CLIP_CHECKPOINT")
    if env:
        cands.append(Path(env))
    short = name.split("/")[-1]
    cands.append(Path("checkpoints") / short)
    hub = Path.home() / ".cache" / "huggingface" / "hub" / \
        f"models--{name.replace('/', '--')}" / "snapshots"
    if hub.exists():
        cands.extend(sorted(hub.iterdir()))
    for c in cands:
        if c.is_dir() and ((c / "model.safetensors").exists()
                           or (c / "pytorch_model.bin").exists()):
            return c
    return None
