"""Fine-tuning CLI (counterpart of
``video_quierer_tpu/train/finetune.py``): contrastive fine-tuning of a
CLIP tower on a videos directory, on one card or on a mesh of cards
(DP × TP, or DP × EP for MoE towers), saved as a checkpoint the serving
engine loads (``model.orbax_checkpoint``).

Examples::

    # on the card (the default device)
    python -m video_quierer_tpu_torch.train.finetune --videos-dir ./videos \\
        --epochs 2 --batch 64 --out ./ckpt

    # on the CPU
    python -m video_quierer_tpu_torch.train.finetune --videos-dir ./videos \\
        --out ./ckpt --device cpu

    # a data-parallel fine-tune over 4 cards
    python -m video_quierer_tpu_torch.train.finetune --videos-dir ./videos \
        --epochs 2 --batch 64 --dp 4 --out ./ckpt

    # a Switch-MoE tower (8 experts every 2nd vision block), experts
    # split over an ``expert`` mesh axis
    python -m video_quierer_tpu_torch.train.finetune --videos-dir ./videos \
        --moe-experts 8 --dp 2 --ep 4 --out ./ckpt

The JAX CLI's flags, plus ``--device``. ``--dp/--tp/--ep`` build the
trainer's mesh (:func:`build_mesh`, JAX ``:37-58``): a ``(data, model)``
or ``(data, expert)`` ``DataMesh`` over the first ``dp·tp·ep`` cards, or
with ``--device cpu`` over as many ``"cpu"`` entries (one process either
way). ``--moe-experts/--moe-every/--moe-capacity`` build a Switch-MoE
vision tower (``parallel/moe.py``). The JAX CLI's refusals: ``--tp``
with ``--ep``, a mesh larger than the cards there are,
``--hf-checkpoint`` with MoE (a dense tree), and experts that do not
divide over ``--ep``. ``--hf-checkpoint`` starts from a local HF
checkpoint, read by ``models/clip/convert.py`` and the bridge. TF32 is
off: f32 products run in full f32, as in the server.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from pathlib import Path

logger = logging.getLogger("vqt.finetune")

VIDEO_SUFFIXES = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def build_mesh(dp: int, tp: int, ep: int, device: str = "cuda",
               devices=None):
    """The ``(data, model)`` or ``(data, expert)`` ``DataMesh`` of the CLI
    sizes (a pure ``--dp`` mesh has a ``model`` axis of 1), or None for
    one device. Its devices are ``devices`` when given, else the CUDA
    cards (``device`` "cuda") or ``n`` ``"cpu"`` entries (``device``
    "cpu", the host's stand-in for JAX's virtual devices)."""
    from video_quierer_tpu_torch.parallel.mesh import MODEL_AXIS, DataMesh
    from video_quierer_tpu_torch.parallel.moe import EXPERT_AXIS

    if tp > 1 and ep > 1:
        raise SystemExit("--tp and --ep are mutually exclusive here")
    n = dp * max(tp, 1) * max(ep, 1)
    if devices is None:
        import torch
        kind = torch.device(device).type
        devices = (["cpu"] * n if kind == "cpu" else
                   [torch.device(kind, i)
                    for i in range(torch.cuda.device_count())])
    if n > len(devices):
        raise SystemExit(f"mesh needs {n} devices, have {len(devices)}")
    if n == 1:
        return None
    if ep > 1:
        return DataMesh(devices[:n], ep, axis=EXPERT_AXIS)
    return DataMesh(devices[:n], max(tp, 1), axis=MODEL_AXIS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Fine-tune a CLIP tower on a videos directory")
    ap.add_argument("--videos-dir", required=True)
    ap.add_argument("--out", required=True,
                    help="checkpoint dir (servable via "
                         "model.orbax_checkpoint)")
    ap.add_argument("--model", default="openai/clip-vit-base-patch32")
    ap.add_argument("--hf-checkpoint", default=None,
                    help="local HF checkpoint dir to start from "
                         "(dense towers only)")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max-frames-per-video", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--weight-decay", type=float, default=0.01)
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "cosine"])
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--total-steps", type=int, default=None)
    ap.add_argument("--max-grad-norm", type=float, default=None)
    ap.add_argument("--ema-decay", type=float, default=None)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp", type=int, default=1, help="data-parallel size")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size (Megatron splits)")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel size (MoE towers)")
    ap.add_argument("--moe-experts", type=int, default=0,
                    help="Switch-MoE experts per MoE block (0 = dense)")
    ap.add_argument("--moe-every", type=int, default=2)
    ap.add_argument("--moe-capacity", type=float, default=1.25)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)

    if args.moe_experts and args.hf_checkpoint:
        raise SystemExit(
            "--hf-checkpoint starts from a dense tree; MoE towers "
            "train from init (or resume their own checkpoints)")
    if args.ep > 1 and args.moe_experts % args.ep:
        raise SystemExit("--moe-experts must divide evenly over --ep")
    mesh = build_mesh(args.dp, args.tp, args.ep, device=args.device)

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import torch

    from video_quierer_tpu_torch.models.clip import convert as convert_mod
    from video_quierer_tpu_torch.models.clip.bridge import params_from_jax
    from video_quierer_tpu_torch.models.clip.config import get_config
    from video_quierer_tpu_torch.models.clip.tokenizer import load_tokenizer
    from video_quierer_tpu_torch.train.checkpoint import save_checkpoint
    from video_quierer_tpu_torch.train.data import (
        load_captions,
        train_on_videos,
    )
    from video_quierer_tpu_torch.train.trainer import CLIPTrainer

    # f32 products in full f32 (cuDNN's TF32 default is on)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.model)
    if args.moe_experts:
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(
                cfg.vision, moe_experts=args.moe_experts,
                moe_every=args.moe_every, moe_capacity=args.moe_capacity))
    params = None
    if args.hf_checkpoint:
        params = params_from_jax(convert_mod.convert_hf_checkpoint(
            Path(args.hf_checkpoint), cfg), cfg)

    logger.info("device: %s; mesh: %s", args.device,
                mesh.shape if mesh else "single device")
    trainer = CLIPTrainer(
        cfg, mesh=mesh, learning_rate=args.lr,
        weight_decay=args.weight_decay,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        remat=args.remat, seed=args.seed, params=params,
        schedule=args.schedule, warmup_steps=args.warmup_steps,
        total_steps=args.total_steps, max_grad_norm=args.max_grad_norm,
        ema_decay=args.ema_decay, device=args.device)
    del params

    videos_dir = Path(args.videos_dir)
    video_paths = sorted(p for p in videos_dir.iterdir()
                         if p.suffix.lower() in VIDEO_SUFFIXES)
    if not video_paths:
        raise SystemExit(f"no videos under {videos_dir}")
    captions = load_captions(videos_dir)
    tokenizer = load_tokenizer()

    losses = train_on_videos(
        trainer, video_paths, tokenizer, epochs=args.epochs,
        batch_size=args.batch,
        max_frames_per_video=args.max_frames_per_video,
        captions=captions, image_size=cfg.vision.image_size)
    if losses:
        logger.info("steps: %d  first loss: %.4f  last loss: %.4f",
                    len(losses), losses[0], losses[-1])
    else:
        logger.warning("no full batches produced — nothing trained "
                       "(need >= %d frames)", args.batch)

    out = save_checkpoint(Path(args.out), trainer, int(trainer.state.step))
    logger.info("checkpoint: %s (serve with model.orbax_checkpoint)", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
