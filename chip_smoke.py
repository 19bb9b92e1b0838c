#!/usr/bin/env python3
"""Smoke run of the PyTorch port (video_quierer_tpu_torch) on one NVIDIA
GPU — the quickest proof that the port still starts on the card.

    python3 chip_smoke.py [--seed 0] [--videos 10000] [--frames 200]
    python3 chip_smoke.py --ab DIR [--ab-scans]
    python3 chip_smoke.py --exact-scans
    python3 chip_smoke.py --checkpoints
    python3 chip_smoke.py --train
    python3 chip_smoke.py --towers
    python3 chip_smoke.py --aimv2
    python3 chip_smoke.py --pp-cards 4
    python3 chip_smoke.py --hosts 2
    python3 chip_smoke.py --meshes
    python3 chip_smoke.py --train-mesh 4

Run from the root of a checkout. ``--ab DIR`` runs only a same-call A/B
of the text and vision kernel phases (B3 and the halves also at
ViT-L/14's shapes and, where the checkout has them, AIMv2's: B3 at head
width 128, the RMSNorm and gated halves, each at 256 frames on random
operands; and with ``--ab-scans`` the
search-tier scans B1, B4, B7, B8 — B8 also at B = 1 and 16, B1, B4 and
B7 at B = 1 and 256 —, B9 and B8 over bf16 rows at B = 1 and 64 and k =
10 and 40, B10 at B = 64 and B11 at B = 1, 64 and 256, both over the
whole corpus and over shard 0 of the 4-shard perm layout, and B12 at B =
1 and 64 on the IVF tier and on shard 0 of the tier over a 4-shard mesh)
of the checkout in
DIR (say the parent commit, unpacked with ``git archive``) against this
one, in the order DIR, this, this, DIR, and prints each kernel's ms per
run. ``--exact-scans`` runs phases 1 and 2, then only the hatch's exact
scans against their plain versions (phase 3's last part), timed;
``--checkpoints`` runs phases 1 and 2, then only phase 3's ViT-L/14 part
and phase 9; ``--train`` runs phases 1, 2 and 10; ``--towers`` runs
phases 1, 2 and 11; ``--aimv2`` runs phases 1, 2, phase 3's AIMv2 part
and phase 6's AIMv2 engine; ``--pp-cards N`` runs phases 1, 2 and ViT-L/14's
pipelined encode over N cards (stage s on cuda:s; needs N cards);
``--hosts N`` runs phases 1, 2 and phase 12's multi-process half over N
processes (needs N or more cards, a multiple of N); ``--meshes`` runs
phases 1, 2 and phase 13's one-card half; ``--train-mesh N`` runs phases
1, 2 and phase 13's multi-card half over N cards (an even N, at most the
cards visible).

Phases (any failure raises, and the script exits non-zero without its
last line):

1. environment: torch, CUDA and nvcc versions; the card's name and power
   limit as nvidia-smi gives them;
2. build: the CUDA kernels from video_quierer_tpu_torch/csrc into
   build/kernels/<hash of the sources>/ (nvcc, sm_90a), with each kernel's
   registers, shared memory and spills as ptxas reports them;
3. kernels vs plain: each kernel of the search and ingest paths against
   its plain PyTorch version at the paths' shapes (2,000,000 rows for the
   scans; one ViT-B/32 vision layer at 256 frames for the layer halves,
   and the whole vision encode), with the tolerance, both times (CUDA
   events, the second of two timed loops; B2, B3, B5, B6 and SDPA as
   device time, their calls captured in one CUDA graph and replayed,
   since their launches are short enough for the host to pace an eager
   loop, which is printed beside), the least time the card could
   take (bytes over 3.35 TB/s or operations over the data sheet's peak
   for their type, whichever is larger) and, where one PyTorch call
   computes the same function, that call's time (B3 also at the vision
   tower's shape, 256 frames x 12 heads, S = 50, beside SDPA; cuBLAS's
   time for B6's two bare GEMMs is printed as the GEMM core's
   yardstick; B8, the exact f32 scan, runs at B = 1, 16 and 64, with
   ``torch.mm`` alone, f32 without TF32, as the yardstick of its product
   only; B1, B4 and B7 at B = 1, 64 and 256, B4 and B7 with
   ``torch._int_mm`` alone over the int8 codes, or the unpacked nibbles,
   as their product's yardstick, and with their ring stages and the
   tile's ptxas register and spill line); then the split of one
   ingest batch of 256 frames into its stages; then the IVF tier on a
   seeded clustered corpus (2,000,000 rows around 1,024 unit centres,
   spread 0.02 per coordinate): its build (nlist auto = 1,024, split into
   upload, k-means, rebalance and pack), the probe scan B12 against its
   plain version pair by pair for 64 and for 1 noisy corpus-row queries
   (also as device time, its calls replayed from a CUDA graph), the
   tier's recall@10 against the exact scan (B8), gated at 0.8, then B12
   on shard 0 of the same tier spread over a 4-shard mesh on the card,
   at both B, with the pair list the mesh's search hands that shard;
   then the corpus-mesh and hatch kernels at the serving size: B10 (at B
   = 64) and B11 (at B = 1, 64 and 256), the perm-layout candidate scans,
   fetch 128, over shard 0 of the perm layout a 4-shard mesh places
   (503,808 rows) and over the whole corpus as one shard; B9 (the exact
   int8 scan) and B8 over bf16 rows at B = 1 and 64, k = 10 and 40 (the
   hatch's fetch at k = 10), over the 2M-row identity mirror: their
   per-span lists (8,192 rows a span, the reference's macro) against the
   plain version's at the same span, the merged top-10's scores against
   host f64, and the ring stages each launch takes; then the SigLIP
   kernels (``siglip-base-patch16-224``, seeded, bf16): B5 non-causal and
   B6 with tanh-GELU on one text layer at a fused flush of 64 queries x
   64 tokens, B3 at S = 64 (B = 1 and 64) and at the vision tower's 256
   frames x 12 heads x S = 196 beside SDPA, the whole text encode (B =
   64, fused) and vision encode (256 frames, module tower) against the
   same encodes on the plain versions, and B1 over a 2,000,000 x 768 bf16
   mirror at B = 1 and 64 with its ring stages; then the ViT-L/14 kernels
   (``openai/clip-vit-large-patch14``, seeded, bf16): B3 at 256 frames x
   16 heads x S = 257 beside SDPA, B5 and B6 on one vision layer at 256
   frames (T = 65,792, D = 1,024, F = 4,096; cuBLAS's two bare GEMMs
   beside B6) and B2 on the 768-wide, 12-head text tower at B = 64;
   then the AIMv2 kernels (``apple/aimv2-large-patch14-224-lit``, seeded,
   bf16): B3 at head width 128 beside SDPA at the text shapes (6 heads,
   causal; B = 1 and 64) and at the vision tower's 256 frames x 8 heads x
   S = 256, B5 with RMSNorm and bias-free projections and B6 with the
   SiLU-gated epilogue on one vision block at 256 frames (T = 65,536, D =
   1,024, F = 2,816; within two bf16 ulps of the plain version's largest
   output; cuBLAS's two bare GEMMs of each half beside it), the whole
   fused vision encode (256 frames) and fused text encode (B = 64) on the
   kernels against the same encodes on the halves' plain versions;
4. end to end: a seeded corpus of 10,000 videos x 200 frames (2,000,000
   unit rows x 512, drawn on the card) written once as the pickle v1.0
   cache; for each mirror
   dtype (bfloat16, then float32, int8 and int4), and then for the IVF
   tier (``index.kind = "ivf"`` over the bf16 mirror, nprobe 8, nlist
   auto, built by ``startup``), an engine loads it
   through ``engine.startup()``, then ingests 20 videos x 200 seeded
   uint8 frames through the decode pipeline (``batched_frames``) and the
   engine's ingest loop (``_ingest_batches``: the vision tower on the
   layer-half kernels, device-streamed mirror appends). The host store
   rows must equal the embedder's output with the reference's metadata,
   the mirror, perm column and re-rank store must equal what the host
   path writes, bit for bit, and 16 ingested frames are searched for
   (float32: each finds itself first; IVF: the 4,000 rows sit in the
   tier's fresh buffer, and each frame, as a vector query through the
   engine, finds itself first). Then the engine goes behind the
   port's HTTP server on a free local port, and single, coalesced and
   batch searches run over HTTP (bfloat16 also 77-token ones, and
   "data:image" and "data:imagex,abc", which hold no image and are
   searched as text: 200 with k rows, checked as the singles). Every
   response's schema is checked; single and batch rows are checked
   against a host exact top-10 over the grown f32 corpus with the query
   vector the port's encoder gives (int4: each returned score against its
   row's exact f32 score, and the order; its recall@10 against the exact
   scan is printed; IVF: the rows and scores equal the host's exact top-10
   over the rows the tier probes — the same clusters by the same numpy
   rule, the same tile budget, plus the fresh rows — and ``/api/stats``
   reports "approximate-ivf"; then the IVF split of one single search and
   of one batch of 64). The launch counters are set to 0 before each
   tier's ingest and again before its searches, and read after each: every
   kernel of that path must have launched (the layer halves 12 times per
   embed batch), the other kernels not, and both fallback counters must
   read 0;
5. corpus meshes and the exact-candidate hatch, each an engine over a
   smaller cache of the same shapes (the first 1,250 videos x 200 frames
   of phase 4's corpus: 250,000 rows, written once beside phase 4's)
   served through its own entry points (``search_ex`` for 8
   single queries, ``search_batch`` for one batch of 64, sent twice: the
   first and the second call's times and their split by the serving
   path's stage spans, ``utils/stageprof.py``, are printed, and the two
   calls' rows must agree), the launch counters set to 0 before the
   searches and read after: a 4-shard mesh
   on the one card (``corpus_mesh=CorpusMesh([cuda:0] * 4)``) in
   bfloat16 (first ingesting 2 videos x 200 seeded frames, which the mesh
   takes by re-placing its mirror: checked bit for bit), int8, float32
   and the IVF tier over the mesh (its clusters spread over the 4 shards);
   then ``VQT_CANDIDATE_TOPK=pallas`` on one card, int8 (B9) and bfloat16
   (B8 on bf16 rows); then ``index.corpus_shards = 1`` through the config
   (B10 over the whole corpus). Served rows equal the host exact top-10
   (IVF: the host's probed-exact top-10); each path's scan kernel launched
   and the single-card candidate kernels (B1, B4) not;
6. the SigLIP engine (``model.family = "siglip"``, bf16 tier, the phase-3
   towers injected; ``index.embed_dim`` widens to 768): ``startup()`` over
   an empty videos dir, then a seeded corpus of 10,000 videos x 200 frames
   x 768 drawn on the card and appended (no pickle written or loaded), an
   ingest of 20 x 200 seeded frames (the module vision tower: B3; the
   mirror checked bit for bit), then over HTTP 16 singles (module text
   tower: B3), 64 coalesced clients and a batch of 64 (fused text encode:
   B5 + B6 with tanh-GELU), every single and batch row held against the
   host exact top-10 over the grown f32 corpus; the launch counters from
   just before the searches to just after: B1 once a search dispatch,
   12 B3 a module-tower encode, 12 B5 and 12 B6 a fused flush, no other
   kernel, both fallback counters 0; single p50, batch ms and ingest
   frames/s printed with the card's name and power limit; then the same
   for the AIMv2 engine (``model.family = "aimv2"``, the phase-3 towers;
   512-wide rows): its ingest on the fused vision encode (24 launches of
   each gated half an embed batch, B3 at head width 128 inside each B5,
   no other kernel), its singles on the module text tower (B3 at head
   width 128: every B3 launch counted on ``attention.launches_hd128``
   too), its coalesced and batch searches on the fused text encode;
7. the query and maintenance surface over HTTP, on engines already
   running: on phase 4's bf16, f32 and int8 engines (after their own
   launch counts were read) and on phase 5's bf16 mesh (behind a server
   of its own), 8 ``/api/search/videos`` at k = 10 (rows against the host
   exact ranking: f64 sums of each video's f32 rows, f32 means,
   normalised, stable order, best frame = the lowest row with the
   video's highest f64 score; the device ranking's counter 8 on the
   single-card engines, 0 on the mesh, whose ranking runs on the host),
   8 ``/api/search/similar`` seeds (the host exact top-10 of the seed's
   row, the seed left out) and 8 ``/api/search/vector`` queries (the host
   exact top-10); on bf16 also ``/search`` against ``/api/search``,
   ``/api/cache/warm`` then cached searches, the video listings and the
   system routes. The launch counters are set to 0 just before and read
   just after: the engine's scan and B3 launched, no other kernel. Each
   route's host-clock p50 and the device ranking's CUDA-event time are
   printed. Then a small bf16 engine of its own (the 20 seeded videos,
   4,000 rows, ingested at startup) takes index save and load, cache
   export and import, a video delete, config set and reset, cache stats,
   health, rebuild (the rows bit for bit the first ingest's; B5/B6
   counted) and clear;
8. the ingest and introspection surface (the decode again replaced by
   ``seeded_extract``): on phase 4's bf16 engine once phase 5 is done,
   ``POST /api/config`` turns ``api.use_clip`` off, and 16 keyword and
   unknown queries go over HTTP one at a time (each the host exact top-10
   of the keyword encoder's vector; B1 once a search, no tower kernel, no
   fallback; ``processor_type`` "Visual"); ``POST /api/config`` turns
   CLIP on again (a 64 MB upload onto these 2M rows is left out for time:
   ~190-220 s, nearly all of it the save rewriting the whole pickle;
   phase 7's engine below still takes one); then the
   profiler route traces 8 singles, a batch of 64 and 64 coalesced
   clients (after an untraced round): the trace must name B1's, B2's
   and B3's kernels; the ten device kernels that took the most time and
   the device-busy share of the window are printed; then
   ``/api/openapi.json``, ``/api/docs``, ``/`` and ``/static/index.html``
   answer 200. On phase 7's 4,000-row engine: a 64 MB upload over HTTP
   with its SSE stream (B5 and B6 12 times and nothing else; the mirror
   bit for bit; three uploaded frames found first by their own rows), a
   lowered ``MAX_FILE_SIZE``'s 413 leaving no file, the video deleted.
   Then a bf16 engine with ``ingest.stream_mirror = false`` and
   ``cache.frame_memo_size = 4096`` that builds its own tower (wrapped
   in ``MemoizedEmbedder``): two ``/api/cache/rebuild``s of the 20
   seeded videos, the first all misses (B5 and B6 192 times), the second
   4,000 hits, no kernel launched, the rows bit for bit the first's;
9. checkpoints: the seeded towers' f32 weights written as HF checkpoint
   directories (HF's names and layouts, the conv as ``[D, 3, p, p]``,
   the ``position_ids`` buffers of older checkpoints; ``model.safetensors``
   written by hand, ``pytorch_model.bin`` by ``torch.save``; CLIP with a
   small ``vocab.json``/``merges.txt`` pair) and served by engines that
   build their own towers from them: ViT-B/32 through
   ``VQT_CLIP_CHECKPOINT`` (the operator's route), then once more from
   ``pytorch_model.bin`` (the load checks only); SigLIP base/16 through
   ``model.checkpoint_dir``; ViT-L/14 at full width (428M parameters,
   768-wide rows; first its fused vision encode at 256 frames against
   the module tower and the plain halves). Each: ``stats()["pretrained"]``
   true, the checkpoint's tokenizer, every parameter bit for bit the
   seeded tower's, text vectors bit for bit on the same ids, the load's
   seconds by stage; then a 2M-row seeded corpus, an ingest (20 videos;
   ViT-L/14 10) checked as phase 4's, and over HTTP 16 singles, 64
   coalesced clients and a batch of 64 (two-word queries: the
   character-level vocabulary keeps them in the 32-token bucket), rows
   against the host exact top-10, launches counted (B1, B2, B3 and the
   ingest's B5, B6; SigLIP: B1, B3, B5, B6);
10. training: B3 under autograd (its Function: the kernel forward, the
   einsum VJP backward) against autograd through its plain version at the
   trainer's shapes (B = 64: ViT-B/32 vision S = 50, 12 heads; text S =
   77, causal, 8 heads; f32 and bf16): the output and dq, dk, dv within
   the stated tolerance, one launch a forward and none a backward, timed
   (the forward alone, the forward with its backward both ways and
   SDPA's, and under remat); then ``CLIPTrainer`` at ViT-B/32's full
   width on seeded weights, one batch of 64 (seeded uint8 frames through
   ``train/data.py:frame_caption_batches``, its decode replaced as phase
   8's, captions from the file names through the hash tokenizer): 8 f32
   steps with the warmup-cosine schedule, the clip of the global norm and
   the EMA (every loss finite, the last below the first, B3 launched 24
   times a step and nothing else), one step under remat (48 launches, the
   first step's loss), the first step's loss and gradients without remat,
   under remat and with B3 swapped for its plain version, held against
   each other; 2 bf16 steps; a bf16 SigLIP base/16 step at B = 32; ms a
   step, frames/s, peak memory and the step's operations against the f32
   and bf16 peaks; then ``train/checkpoint.py``'s save and restore into a
   fresh trainer (params, moments, EMA and step bit for bit) and an engine
   with ``model.orbax_checkpoint`` set to the saved directory over a
   4,000-row seeded corpus: ``pretrained`` true, its image and text
   vectors against the trainer's towers on the saved weights (per-row
   cosine >= 0.999, bf16 serving), and over HTTP phase 4's searches, rows
   against the host exact top-10; last, one more f32 and one more bf16
   step each under ``torch.profiler``: the device-busy share of the step,
   its kernel launches and its six costliest kernels;
11. tower parallelism: ``vit-b-32-moe8`` (ViT-B/32's widths, 8 experts in
   every 2nd vision block, capacity 1.25; registered here through
   ``register_config``) on a seeded bf16 engine: its 256-frame encode
   (module tower: B3) against the f32 tower on the same weights with B3's
   plain version (per-row cosine >= MIN_COS, tokens routed alike >=
   MOE_MIN_ROUTED), timed beside the dense tower's module and fused
   encodes; then grown and served as phase 9's engines (a 2M-row corpus
   drawn on the card, 20 seeded videos ingested, B3 once a layer and
   embed batch, the mirror bit for bit; over HTTP 16 singles, 64
   coalesced clients and a batch of 64 against the host exact top-10);
   ``finetune.main`` with ``--moe-experts 8 --ep 1`` on the card (2 steps
   at B = 32, seeded frames, B3 24 times a step), its checkpoint served
   by an engine with ``model.orbax_checkpoint`` (vectors against the f32
   module tower on the saved parameters, 8 searches against the host
   exact top-10); a ViT-B/32 engine with ``model.parallel = "pp"`` and
   ``pipeline_microbatches = 4`` building its own tower (one stage on
   the card; its 256-frame encode against the sequential module tower,
   B3 M·L = 48 times; served as the MoE engine; the MoE, dense module and
   ``pp`` encodes traced by ``torch.profiler``); ViT-L/14's
   ``pipelined_encode_image`` over 4 stages on ``cuda:0`` at M = 4 (B3 96
   times) against its sequential module tower, both timed;
12. serving across cards. The data mesh on the one card
   (``data_mesh(devices=[cuda:0] * 4)``): 256 seeded frames through the
   mesh tower, four 64-frame parts (B5 and B6 12 times a part), and a
   batch of 64 ten-word texts, four parts of 16 (S = 16: B2 12 times a
   part), held against the meshless fused tower (per-row cosine >=
   DATA_MESH_MIN_COS) and the f32 plain tower (>= MIN_COS), both encodes
   timed against the meshless ones (CUDA events); then an engine built
   with ``mesh=`` (its own seeded tower) grown and served as phase 9's
   engines (ingest: B5 and B6 48 times an embed batch; 16 singles, 64
   coalesced clients and a batch of 64 of ten-word queries over HTTP,
   rows against the host exact top-10). Then, with 2 or more cards
   visible (``--hosts N`` alone: on N processes), the multi-process half:
   one 2M-row x 512 pickle v1.0 cache written once, N processes of this
   script (``--host-child``) started with ``VQT_COORDINATOR``,
   ``VQT_NUM_PROCESSES``, ``VQT_PROCESS_ID`` and their own
   ``CUDA_VISIBLE_DEVICES``; each starts an engine from the cache through
   the config path (``index.corpus_shards`` = the cards of every process,
   ``index.corpus_slices`` = N: NCCL, each process's shards on its own
   cards) in the bfloat16, int8 and float32 tiers, ingests the same 2
   seeded videos, and runs the same 16 singles and 3 batches of 64;
   process 0 gathers every process's rows and holds them against its own
   and against the host exact top-10 over the grown corpus; each
   ``all_gather`` of the merge is timed by CUDA events; a failed or
   timed-out process fails the run;
13. training meshes (``CLIPTrainer(mesh=...)``, one process). On the one
   card, ``data_mesh(devices=[cuda:0] * 4)``: B3 under autograd at a
   data row's part shapes (B = 32, S = 50 with 6 heads, S = 77 causal
   with 4) against its plain version as phase 10; ViT-B/32 at B = 64 in
   f32 (warmup-cosine, the clip, the EMA; 3 steps) and in bf16 (2
   steps) on (data 2, model 2), ``vit-b-32-moe8`` in f32 on (data 2,
   expert 2) and SigLIP base/16 in f32 at B = 32 on (data 2, model 2)
   (2 steps each): each first step's loss and gradients against the
   one-device ``CLIPTrainer`` from the same seed on the same batch (f32
   loss rtol 1e-5 and every gradient element within rtol 1e-4 / atol
   1e-6; bf16 loss rtol 1e-2; the MoE tower's tokens dropped per layer
   equal), then every step B3 the count the mesh implies (data rows x
   model parts x 24 layers) and nothing else, ms a step beside the
   one-device trainer's second step, and peak memory; the f32 trainer's
   checkpoint saved, restored onto one device (bit for bit) and served
   by a bf16 ``CLIPEmbedder`` (vectors against the trainer's towers,
   cosine >= MIN_COS), and one more f32 mesh step under
   ``torch.profiler`` (device-busy share); then the training half of the
   JAX package's ``dryrun_multichip`` at tiny shapes (a dp x tp CLIP
   step, a SigLIP step, an EMA + cosine step). With 4 cards visible
   (``--train-mesh N`` alone: on N), the f32 ViT-B/32 step over
   ``cuda:0 .. 3`` against the same grid on ``cuda:0``, both timed;
14. a JSON line of the kernels (B1, B4, B7 and B11 also under ``at_b`` at
   B = 1, 64 and 256, B10 and B11 also under ``shard`` on shard 0 of the
   4-shard layout, B11 there at each B under ``shard_at_b``; B12 under
   ``at_b`` at B = 1 and 64 and, under ``at_b["shard"]``, on shard 0 of
   the mesh at both B; the SigLIP path's B6 with tanh-GELU, B5, B3 at S =
   196 and B1 at D = 768, each with its SigLIP-engine launches; B1, B2,
   B3, B5 and B6 with their phase-8 launches under ``phase8_launches`` and
   their phase-9 ViT-B/32 launches under ``phase9_launches``; B1, B2 and
   B3 with phase 11's under ``phase11_launches``; the
   ViT-L/14 path's B3 at S = 257 (launched inside B5), B5, B6 and B2 at
   768 wide, with their phase-9 launches; B3 under autograd in phase
   10's steps, ``attention_train`` with its launches a step, and under
   remat, ``attention_train_remat``; B3 in phase 13's mesh steps,
   ``attention_train_mesh``, with its launches a step; phase 12's
   launches under ``phase12_launches``; the AIMv2 path's B3 at head
   width 128, S = 256 (launched inside B5) and S = 8 (the singles), B5
   with RMSNorm and B6 with the gated epilogue, each with its AIMv2-engine
   launches), the nvidia-smi line, and the
   result line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Every phase prints its time. Every seeded engine of phases 4-8 must
report ``stats()["pretrained"]`` false: no checkpoint found by discovery
may swap its weights. Needs one CUDA card; without one it exits non-zero
and prints no result.
Uses no network beyond its own localhost server, and stops what it starts.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import logging
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from video_quierer_tpu_torch import evaluation
from video_quierer_tpu_torch.api import routes as api_routes
from video_quierer_tpu_torch.api.server import create_server
from video_quierer_tpu_torch.engine import system as engine_system
from video_quierer_tpu_torch.engine.config import (
    EngineConfig,
    apply_env_overrides,
)
from video_quierer_tpu_torch.engine.fallback import KeywordQueryEncoder
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.ingest import frames as ingest_frames
from video_quierer_tpu_torch.ingest.frames import (
    sampling_interval,
    video_identity_hash,
)
from video_quierer_tpu_torch.ingest.pipeline import batched_frames
from video_quierer_tpu_torch.index import ivf
from video_quierer_tpu_torch.index.device_index import (
    DeviceVideoIndex,
    _device_exact_rerank,
    _round_capacity,
    video_rank_device,
)
from video_quierer_tpu_torch.models.aimv2.embedder import AIMv2Embedder
from video_quierer_tpu_torch.models.aimv2.fused import (
    fused_aimv2_text_encode,
    fused_aimv2_vision_encode,
)
from video_quierer_tpu_torch.models.clip import bridge as clip_bridge
from video_quierer_tpu_torch.models.clip import model as clip_model
from video_quierer_tpu_torch.models.clip.config import (
    get_config,
    register_config,
)
from video_quierer_tpu_torch.models.clip.embedder import (
    CLIPEmbedder,
    MemoizedEmbedder,
    trim_text_ids,
)
from video_quierer_tpu_torch.models.clip.tokenizer import (
    CLIPBPETokenizer,
    HashTokenizer,
    load_tokenizer,
)
from video_quierer_tpu_torch.models.siglip import bridge as siglip_bridge
from video_quierer_tpu_torch.models.siglip.embedder import (
    SigLIPEmbedder,
    siglip_tokenizer,
)
from video_quierer_tpu_torch.models.siglip.fused import \
    fused_siglip_text_encode
from video_quierer_tpu_torch.models.siglip.model import (
    SigLIP,
    siglip_base_patch16,
)
from video_quierer_tpu_torch.ops import fused_layer as fl
from video_quierer_tpu_torch.ops import kernels, topk
from video_quierer_tpu_torch.ops.attention import (
    HEAD_DIM,
    attention,
    attention_ref,
)
from video_quierer_tpu_torch.ops.preprocess import (
    SIGLIP_MEAN,
    SIGLIP_STD,
    normalize_images,
)
from video_quierer_tpu_torch.ops.quantize import (
    quantize_rows,
    quantize_rows_int4,
)
from video_quierer_tpu_torch.parallel.mesh import (
    CorpusMesh,
    data_mesh,
    initialize_distributed,
    pipe_devices,
)
from video_quierer_tpu_torch.train import checkpoint as train_ckpt
from video_quierer_tpu_torch.train.data import frame_caption_batches
from video_quierer_tpu_torch.train.trainer import CLIPTrainer, loss_fn
from video_quierer_tpu_torch.utils import stageprof

ROOT = Path(__file__).resolve().parent
DIM = 512
SIGLIP_DIM = 768        # siglip-base-patch16-224's rows (no projection)
K = 10
RESPONSE_KEYS = {"results", "search_time_ms", "from_cache", "query_id",
                 "performance"}
ROW_KEYS = {"video_name", "timestamp", "frame_id", "score",
            "formatted_time"}
ATTN_ATOL = 2e-2        # bf16 attention vs plain, valid rows
# bf16 layer half vs plain at ViT-B/32 widths, N(0, 1) activations: two
# bf16 ulps in [4, 8), where the largest of these activations lie
LAYER_ATOL = 2 * 2.0 ** -5
MIN_COS = 0.999         # bf16 tower rows vs plain
# the data mesh's bf16 rows vs the meshless tower's (the same kernels on
# parts of the batch)
DATA_MESH_MIN_COS = 0.9999
UNIT_ATOL = 1e-5        # f32 row norms of the towers' outputs
SCORE_ATOL = 1e-5       # returned scores vs host exact f32
SCAN_RTOL = 1e-5        # exact-scan kernel scores vs its plain version
# NVIDIA H100 SXM data sheet (700 W): HBM rate and dense peaks
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12,
              "f32": 67e12}
# each kernel's wrapper, by the name the kernels line gives it
WRAPPERS = {"cand_scan_prefix": topk.cand_scan_prefix,
            "fused_layer": fl.fused_layer, "attention": attention,
            "cand_scan_int8_prefix": topk.cand_scan_int8_prefix,
            "cand_scan_int4_prefix": topk.cand_scan_int4_prefix,
            "block_scan": topk.block_scan, "attn_half": fl.attn_half,
            "mlp_half": fl.mlp_half, "probe_scan": ivf.probe_scan,
            "cand_scan": topk.cand_scan,
            "cand_scan_int8": topk.cand_scan_int8,
            "block_scan_int8": topk.block_scan_int8,
            "block_scan_bf16": topk.block_scan_bf16,
            "rms_attn_half": fl.rms_attn_half,
            "gated_mlp_half": fl.gated_mlp_half}
# the scan each serving tier runs: the four mirror dtypes, then the IVF
# tier over the bf16 mirror; every search path also encodes (B2, B3),
# every ingest runs the vision tower (B5, B6)
SCANS = {"bfloat16": "cand_scan_prefix", "float32": "block_scan",
         "int8": "cand_scan_int8_prefix", "int4": "cand_scan_int4_prefix",
         "ivf": "probe_scan"}
MODES = {"float32": "exact-f32-scan", "ivf": "approximate-ivf"}
# the IVF phase's clustered corpus: unit centres, Gaussian spread per
# coordinate (narrow enough that every query's exact top-10 stays in its
# own cluster at 2M rows)
IVF_CENTRES = 1024
IVF_SPREAD = 0.02
IVF_RECALL = 0.8        # the reference's bar (tests/test_ivf.py)
INGEST = ("attn_half", "mlp_half")
INGEST_VIDEOS = 20
MESH_SHARDS = 4
MESH_INGEST_VIDEOS = 2
# the exact-candidate hatch's fetch at k = K (DeviceVideoIndex._rerank_fetch)
HATCH_K = min(max(4 * K, K + 16), topk.MAX_K)
# phase 5's engines start from a smaller cache of the same shapes: the first
# EXTRA_VIDEOS videos of phase 4's corpus (1,250 x 200 = 250,000 rows x
# 512), so that their seven startups cost less (phase 3 times the kernels
# at 2M rows)
EXTRA_VIDEOS = 1_250
# the engines of phase 5: (name, device_dtype, kind, mesh shards (0: none;
# -1: index.corpus_shards = 1 through the config), hatch, the scan kernel)
EXTRA = (("mesh bfloat16", "bfloat16", "exact", MESH_SHARDS, False,
          "cand_scan"),
         ("mesh int8", "int8", "exact", MESH_SHARDS, False, "cand_scan_int8"),
         ("mesh float32", "float32", "exact", MESH_SHARDS, False,
          "block_scan"),
         ("mesh ivf", "bfloat16", "ivf", MESH_SHARDS, False, "probe_scan"),
         ("hatch int8", "int8", "exact", 0, True, "block_scan_int8"),
         ("hatch bfloat16", "bfloat16", "exact", 0, True, "block_scan_bf16"),
         ("config corpus_shards=1", "bfloat16", "exact", -1, False,
          "cand_scan"))
FPS = 30.0
IMAGE = 224
# B3's shapes: (B, S, heads, causal). CLIP's text (8 heads, causal) and
# ViT-B/32 vision tower (S = 50); SigLIP's text singles and fused-batch
# width (S = 64, non-causal) and vision tower (S = 196, no class token)
ATTN_SHAPES = ((1, 8, 8, True), (64, 8, 8, True), (1, 77, 8, True),
               (64, 77, 8, True), (256, 50, 12, False))
SIGLIP_ATTN_SHAPES = ((1, 64, 12, False), (64, 64, 12, False),
                      (256, 196, 12, False))
# the SigLIP engine's serving path: B1 on every search; per search the text
# tower once, either the module tower (12 B3 launches) or the fused encode
# (12 B5 and 12 B6 launches); its ingest runs the module vision tower (B3)
SIGLIP_PATH = ("cand_scan_prefix", "attention", "attn_half", "mlp_half")
# AIMv2-L/14 LiT: B3's head width-128 shapes (B, S, heads, causal), the
# text tower's singles and fused batches (6 heads, causal; 4 words are an
# 8-token bucket) and the vision tower's 256 frames (8 heads, S = 256);
# its serving path, as SigLIP's with the gated halves; its ingest path
AIMV2 = "apple/aimv2-large-patch14-224-lit"
AIMV2_ATTN_SHAPES = ((1, 8, 6, True), (64, 16, 6, True),
                     (256, 256, 8, False))
AIMV2_PATH = ("cand_scan_prefix", "attention", "rms_attn_half",
              "gated_mlp_half")
AIMV2_INGEST = ("rms_attn_half", "gated_mlp_half")
# /api/search queries shaped like image URIs that hold no image (no
# OpenCV on the card's machine decodes one either): searched as text
IMAGE_SHAPED_TEXT = ("data:image", "data:imagex,abc")


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def timed(phase: str):
    t0 = time.perf_counter()
    yield
    log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` on the card: one warm-up call, then two
    timed loops of ``iters`` calls between CUDA events; the second counts."""
    fn()
    torch.cuda.synchronize()
    ms = 0.0
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
    return ms


def graph_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed between CUDA events (the second of two replays
    counts), so the wrappers' host work is left out. For the layer
    kernels and attention, whose launches are short enough that the
    eager loop of :func:`cuda_ms` times the host."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    ms = 0.0
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
    del graph
    return ms


def bound(bytes_moved: float, ops: float, kind: str) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak of their type, whichever is larger."""
    t_bytes = 1e3 * bytes_moved / HBM_BYTES_S
    t_ops = 1e3 * ops / PEAK_OPS_S[kind]
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def words(rng: np.random.Generator, n: int) -> str:
    """``n`` random lowercase words (one token each for the hash
    tokenizer)."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return " ".join("".join(rng.choice(letters, size=rng.integers(4, 9)))
                    for _ in range(n))


# -- phases 1-2 ---------------------------------------------------------------

def phase_environment() -> str:
    nvcc = subprocess.run([kernels._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc {nvcc.strip().splitlines()[-1]}")
    log(f"card: {smi}  ({torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible)")
    # the exact re-rank and the plain versions are f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.lib()
    log(f"build: {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s"
        + ("" if kernels.last_build else " (cached)"))
    for name, lines in ptxas_report().items():
        for line in lines:
            log(f"  ptxas {name}: {line}")


def ptxas_report() -> dict:
    """{entry function: its ptxas register and spill lines} of the build
    (its ``ptxas.log``, also when the build was cached)."""
    out, name = {}, ""
    log_file = kernels.build().parent / "ptxas.log"
    for line in log_file.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("Used" in line or "spill stores" in line):
            out.setdefault(name, []).append(
                line.strip().removeprefix("ptxas info    : "))
    return out


def codes_tile_ptxas(qn: int, rounds: int, int4: bool) -> str:
    """The ptxas lines of the live-prefix instantiation
    ``cand_kernel_i8<qn, rounds, false, int4>`` (B4, or B7 for int4)."""
    tag = f"cand_kernel_i8ILi{qn}ELi{rounds}ELb0ELb{int(int4)}E"
    return "; ".join(line for name, lines in ptxas_report().items()
                     if tag in name for line in lines)


# -- phase 3: kernels vs plain ------------------------------------------------

def compare_attention(dev, shapes=ATTN_SHAPES, row=(64, 77),
                      hd: int = HEAD_DIM) -> dict:
    """B3 against its plain version and SDPA at ``shapes`` (by default
    the CLIP text shapes, 8 heads, causal, and the vision tower's, B = 256
    frames, S = 50, 12 heads, non-causal) and head width ``hd``; returns
    the ``row`` = (B, S) result, the kernels line's."""
    out = {}
    for b, s, heads, causal in shapes:
        d = hd * heads
        g = torch.Generator(device=dev).manual_seed(1000 * s + b)
        q, k, v = ((0.5 * torch.randn(b, s, d, generator=g, device=dev))
                   .bfloat16() for _ in range(3))

        def kern():
            return attention(q, k, v, num_heads=heads, causal=causal)

        def plain():
            qs = (q.float() * hd ** -0.5).bfloat16()
            return attention_ref(qs, k, v, num_heads=heads, valid_len=s,
                                 causal=causal)

        # the yardstick: PyTorch's fused attention, one call on the same
        # inputs in the [B, heads, S, hd] layout (used nowhere in the port)
        qh, kh, vh = (t.view(b, s, heads, hd).transpose(1, 2)
                      for t in (q, k, v))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal, scale=hd ** -0.5)

        err = (kern().float() - plain().float()).abs().max().item()
        require(err <= ATTN_ATOL, f"B3 B={b} S={s}: max_abs_err {err}")
        ms, lms = graph_ms(kern, 50), graph_ms(library, 50)
        eager, pms = cuda_ms(kern, 50), cuda_ms(plain, 50)
        eager_lib = cuda_ms(library, 50)
        # q, k, v read and the output written once, bf16; QK^T and PV
        # over the (causal) pairs
        pairs = s * (s + 1) / 2 if causal else s * s
        lim = bound(4 * b * s * d * 2, 4 * b * d * pairs, "bf16")
        log(f"B3 attention B={b} S={s} H={heads} hd={hd} "
            f"{'causal' if causal else 'non-causal'}: max_abs_err "
            f"{err:.3e} (atol {ATTN_ATOL}) kernel {ms:.4f} ms sdpa "
            f"{lms:.4f} ms (device, graph replay; eager {eager:.4f} / "
            f"{eager_lib:.4f}) plain {pms:.4f} ms bound "
            f"{lim['bound_ms']:.4f} ms ({lim['bound_by']})")
        out[(b, s)] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                       **lim, "library_ms": lms}
    return out[row]


def compare_fused_layer(embedder: CLIPEmbedder, seed: int) -> dict:
    model = embedder.params
    ops = embedder._layer_ops(model)
    rng = np.random.default_rng(seed)
    out = {}
    for s, n_words in ((8, 4), (16, 11)):
        ids = trim_text_ids(embedder.tokenizer(
            [words(rng, n_words) for _ in range(64)]))
        require(ids.shape == (64, s), f"B2 ids shape {ids.shape}")
        ids_t = embedder.ids_tensor(ids)

        def kern():
            return fl.fused_text_encode(model, ids_t, ops)

        def plain():
            return fl.fused_text_encode(model, ids_t, ops,
                                        layer=fl.fused_layer_ref)

        with torch.inference_mode():
            a, p = kern(), plain()
            cos = torch.nn.functional.cosine_similarity(a, p, dim=-1)
            err = (a - p).abs().max().item()
            require(cos.min().item() >= MIN_COS,
                    f"B2 S={s}: min row cosine {cos.min().item()}")
            ms, eager = graph_ms(kern, 10), cuda_ms(kern, 10)
            pms = cuda_ms(plain, 10)
        # per layer: 12 W^2 bf16 weights read once and 2 x 12 W^2 flops a
        # token (q/k/v, out, fc1, fc2) plus causal attention; the stack's
        # input and output once
        t, layers, w = 64 * s, len(ops), embedder.cfg.text.hidden_size
        lim = bound(layers * 12 * w * w * 2 + 2 * t * w * 2,
                    layers * (2 * t * 12 * w * w
                              + 4 * 64 * w * s * (s + 1) / 2), "bf16")
        log(f"B2 fused text encode B=64 S={s} W={w} x{layers} layers: min "
            f"cosine {cos.min().item():.6f} (>= {MIN_COS}) max_abs_err "
            f"{err:.3e} kernel {ms:.3f} ms (device, graph replay; eager "
            f"{eager:.3f}) plain {pms:.3f} ms bound {lim['bound_ms']:.4f} "
            f"ms ({lim['bound_by']})")
        out[s] = {"max_abs_err": err, "ms": ms, "plain_ms": pms, **lim,
                  "library_ms": None}
    return out[16]


def compare_layer_halves(embedder: CLIPEmbedder, seed: int,
                         b: int = 256) -> tuple:
    """B5 and B6 against their plain versions on one layer of the seeded
    ViT-B/32 vision tower, bf16, at an ingest batch of ``b`` frames."""
    c = embedder.cfg.vision
    ops = embedder._layer_ops(embedder.params, "vision")[0]
    d, f, s = c.hidden_size, c.hidden_size * c.mlp_ratio, c.seq_len
    t = b * s
    g = torch.Generator(device=embedder.device).manual_seed(seed)
    x = torch.randn(t, d, generator=g, device=embedder.device).bfloat16()
    kw = {"s": s, "heads": c.num_heads, "eps": c.layer_norm_eps,
          "causal": False}
    b5, b6 = half_bounds(t, d, f, s)
    halves = {
        "B5 attention half": (lambda: fl.attn_half(x, ops, **kw),
                              lambda: fl.attn_half_ref(x, ops, **kw), b5),
        "B6 MLP half": (lambda: fl.mlp_half(x, ops, eps=c.layer_norm_eps),
                        lambda: fl.mlp_half_ref(x, ops, eps=c.layer_norm_eps),
                        b6),
    }
    with torch.inference_mode():
        # the GEMM core's yardstick: cuBLAS on B6's two bare products
        # (bf16, no LN or epilogue; used nowhere in the port)
        h = torch.randn(t, f, generator=g, device=embedder.device).bfloat16()
        w1, w2 = ops[5], ops[7]
        mm = (cuda_ms(lambda: torch.matmul(x, w1), 10),
              cuda_ms(lambda: torch.matmul(h, w2), 10))
        log(f"cuBLAS B6 GEMMs B={b}: [{t}, {d}] @ [{d}, {f}] {mm[0]:.3f} ms, "
            f"[{t}, {f}] @ [{f}, {d}] {mm[1]:.3f} ms, sum "
            f"{mm[0] + mm[1]:.3f} ms (bound "
            f"{1e3 * 4 * t * f * d / PEAK_OPS_S['bf16']:.4f} ms)")
        del h
        return time_halves(halves, f"B={b} frames (T={t}, D={d}, S={s})")


def half_bounds(t: int, d: int, f: int, s: int) -> tuple:
    """Bounds of B5 and B6 over ``t`` tokens of items of ``s``: x read and
    out written (bf16), the half's weights and biases read (bf16) and the
    LN rows (f32); B5's QKV and out-proj GEMMs plus QK^T and PV, B6's two
    GEMMs."""
    return (bound(2 * 2 * t * d + 2 * (4 * d * d + 4 * d) + 4 * 4 * d,
                  8 * t * d * d + 4 * t * s * d, "bf16"),
            bound(2 * 2 * t * d + 2 * (2 * d * f + f + d) + 4 * 4 * d,
                  4 * t * f * d, "bf16"))


def two_ulps(t: torch.Tensor) -> float:
    """Two bf16 ulps at ``t``'s largest magnitude (a GEMM output may round
    to the other side of a tie)."""
    top = t.float().abs().max().item()
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


def time_halves(halves: dict, shape: str, atol=None) -> tuple:
    """Each layer half against its plain version (max_abs_err within
    LAYER_ATOL, or ``atol(plain output)``) and timed: ``{name: (kernel,
    plain, bound)}`` -> their kernels-line numbers, in order."""
    out = []
    with torch.inference_mode():
        for name, (kern, plain, lim) in halves.items():
            want = plain()
            tol = LAYER_ATOL if atol is None else atol(want)
            err = (kern().float() - want.float()).abs().max().item()
            del want
            require(err <= tol, f"{name} {shape}: max_abs_err {err} "
                    f"(atol {tol})")
            ms, eager = graph_ms(kern, 10), cuda_ms(kern, 10)
            pms = cuda_ms(plain, 10)
            log(f"{name} {shape}: max_abs_err {err:.3e} (atol {tol}) "
                f"kernel {ms:.3f} ms (device, graph replay; eager "
                f"{eager:.3f}) plain {pms:.3f} ms bound "
                f"{lim['bound_ms']:.4f} ms ({lim['bound_by']})")
            out.append({"max_abs_err": err, "ms": ms, "plain_ms": pms,
                        **lim, "library_ms": None})
    return tuple(out)


def seeded_frames(seed: int, video: int, n: int) -> np.ndarray:
    """``n`` uint8 RGB frames of one seeded video."""
    return np.random.default_rng([seed, video]).integers(
        0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8)


def compare_vision_encode(embedder: CLIPEmbedder, seed: int,
                          b: int = 256) -> None:
    """The whole vision encode on the layer-half kernels against the plain
    pair: rows at per-row cosine >= MIN_COS, unit-norm within UNIT_ATOL."""
    model = embedder.params
    ops = embedder._layer_ops(model, "vision")
    frames = torch.from_numpy(seeded_frames(seed, 10_000, b)).to(
        embedder.device)
    with torch.inference_mode():
        pixels = normalize_images(frames, dtype=embedder.dtype)

        def kern():
            return fl.fused_vision_encode(model, pixels, ops)

        def plain():
            return fl.fused_vision_encode(model, pixels, ops,
                                          attn=fl.attn_half_ref,
                                          mlp=fl.mlp_half_ref)

        a, p = kern(), plain()
        cos = torch.nn.functional.cosine_similarity(a, p, dim=-1).min()
        norm = (torch.linalg.vector_norm(a, dim=-1) - 1).abs().max()
        require(cos.item() >= MIN_COS, f"vision encode: min cosine {cos}")
        require(norm.item() <= UNIT_ATOL, f"vision encode: norm error {norm}")
        ms, pms = cuda_ms(kern, 3), cuda_ms(plain, 3)
    log(f"vision encode B={b} frames x{len(ops)} layers (bf16): min cosine "
        f"{cos.item():.6f} (>= {MIN_COS}) vs the plain halves, max |norm - "
        f"1| {norm.item():.2e} (<= {UNIT_ATOL}); kernels {ms:.3f} ms plain "
        f"{pms:.3f} ms = {b / ms * 1e3:.0f} frames/s on the kernels")


def ingest_split(embedder: CLIPEmbedder, seed: int, device,
                 b: int = 256) -> None:
    """Where one embed batch of the ingest loop goes: each stage closed
    with a synchronise, on a scratch bf16 index (the third of three
    repetitions counts)."""
    model = embedder.params
    ops = embedder._layer_ops(model, "vision")
    c = embedder.cfg.vision
    frames = seeded_frames(seed, 10_001, b)
    index = DeviceVideoIndex(dim=DIM, device_dtype="bfloat16",
                             device=device)
    for _ in range(3):
        t = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            t[name] = 1e3 * (time.perf_counter() - t0)
            return r

        with torch.inference_mode():
            dev = stage("upload", lambda: torch.from_numpy(frames).to(device))
            x2 = stage("preprocess + patchify", lambda: fl.vision_embed(
                model, normalize_images(dev, dtype=embedder.dtype)))

            def layers():
                y = x2
                for o in ops:
                    y = fl.attn_half(y, o, s=c.seq_len, heads=c.num_heads,
                                     eps=c.layer_norm_eps, causal=False)
                    y = fl.mlp_half(y, o, eps=c.layer_norm_eps)
                return y

            y = stage(f"{len(ops)} layers", layers)
            feats = stage("epilogue", lambda: fl.vision_head(model, y, b))
        host = stage("fetch", lambda: feats.cpu().numpy())
        lo = len(index)
        stage("host append", lambda: index.add_batch(
            host, "split.mp4", [0.0] * b))
        stage("stream append", lambda: index.stream_rows_device(
            feats, offset=0, n=b, lo=lo))
    log(f"ingest split, one embed batch of {b} frames (bf16 tower, bf16 "
        "mirror, ms): " + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
        + f"; total {sum(t.values()):.3f}")


def corpus_on_card(dev, n_rows: int, seed: int, dim: int = DIM):
    """The scans' operands at the serving size: ``store`` (f32 unit rows,
    zero past ``n_rows``: the exact scan's matrix and the re-rank store)
    and ``perm`` (live-prefix mirror position -> host row)."""
    n_pad = _round_capacity(n_rows)
    g = torch.Generator(device=dev).manual_seed(seed)
    store = torch.randn(n_pad, dim, generator=g, device=dev)
    store /= torch.linalg.vector_norm(store, dim=-1, keepdim=True)
    store[n_rows:] = 0
    perm = torch.cat([
        torch.randperm(n_rows, generator=g, device=dev),
        torch.arange(n_rows, n_pad, device=dev)]).int()
    return store, perm


def unit_queries(dev, b: int, seed: int, dim: int = DIM) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, dim, generator=g, device=dev)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def compare_winners(name: str, b: int, kern, plain, merge, store, perm,
                    q, n_rows: int, fetch: int, exact: bool) -> dict:
    """Bucket winners of a candidate-scan kernel vs its plain version, and
    the top-K after merge + exact re-rank; times both."""
    tops = []
    for vals, idxs in (kern(), plain()):
        _, cand = merge(vals, idxs, perm, fetch=fetch)
        tops.append((vals, idxs) + _device_exact_rerank(
            store, q, cand, n_rows, K))
    (kv, ki, _, kr), (pv, pi, _, pr) = tops
    require(torch.equal(kr, pr), f"{name} B={b}: top-{K} rows differ")
    require(torch.equal(torch.isfinite(kv), torch.isfinite(pv)),
            f"{name} B={b}: live winners differ")
    if exact:
        require(torch.equal(kv, pv) and torch.equal(ki, pi),
                f"{name} B={b}: winners not bit-identical")
    both = torch.isfinite(kv)
    err = (kv[both] - pv[both]).abs().max().item()
    same = (ki == pi).float().mean().item()
    iters = 20 if b < 256 else 5
    ms, pms = cuda_ms(kern, iters), cuda_ms(plain, iters)
    log(f"{name} N={n_rows} B={b}: top-{K} identical after merge + "
        f"re-rank; winners " + ("bit-identical" if exact else
                                f"max_abs_err {err:.3e}, same positions "
                                f"{same:.6f}")
        + f"; kernel {ms:.3f} ms plain {pms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms}


def compare_cand_scan(store, perm, n_rows: int, seed: int,
                      widths=(1, 64, 256)) -> dict:
    """B1 over the bf16 live-prefix mirror (as wide as ``store``) at B in
    ``widths``, with the ring stages each launch takes: the B = 64 result,
    with every width's under ``at_b``."""
    mirror = store[perm.long()].bfloat16()
    dim = store.shape[1]
    out = {}
    for b in widths:
        q = unit_queries(store.device, b, seed + b, dim)
        stages = topk.cand_ring_stages(mirror, b, topk.CAND_ROUNDS)
        log(f"B1 candidate scan D={dim} B={b}: {stages} ring stages")
        out[b] = compare_winners(
            f"B1 candidate scan D={dim}", b,
            lambda: topk.cand_scan_prefix(mirror, q, n_rows,
                                          bucket=topk.CAND_BUCKET,
                                          rounds=topk.CAND_ROUNDS),
            lambda: topk.cand_scan_prefix_ref(
                mirror, q, n_rows, bucket=topk.CAND_BUCKET,
                rounds=topk.CAND_ROUNDS, block_rows=topk.CAND_BLOCK_ROWS),
            topk._cand_merge_cols, store, perm, q, n_rows, 128, False)
        out[b].update(_scan_bound(mirror.numel() * 2, b * dim * 2, b,
                                  "bf16", n_rows, dim), library_ms=None,
                      stages=stages)
    del mirror
    return dict(out[64], at_b={str(b): _brief(r) for b, r in out.items()})


def _brief(result: dict) -> dict:
    """The numbers of one width or layout beside a kernels-line entry."""
    return {k: result[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "max_abs_err", "device_ms", "stages")
            if k in result}


def _scan_bound(mirror_bytes: int, query_bytes: int, b: int, kind: str,
                n_rows: int, dim: int = DIM) -> dict:
    """Bound of a candidate scan: the mirror (and its scales) and the
    queries read once, the winners written once; 2 D operations per row
    and query."""
    n_pad = _round_capacity(n_rows)
    w = topk.CAND_ROUNDS * n_pad // topk.CAND_BUCKET
    return bound(mirror_bytes + query_bytes + w * b * 8,
                 2 * n_pad * dim * b, kind)


def int_mm_ms(codes, q_codes, b: int):
    """The yardstick of an int8 scan's product alone: ``torch._int_mm`` of
    the codes [N, D] s8 (for the int4 scan, its rows unpacked) and the
    query codes [D, B] s8 into [N, B] s32 (the port never calls it; the
    scans also scale and select). cuBLASLt's int8 product takes B a
    multiple of 8: None below that."""
    if b % 8:
        return None
    return cuda_ms(lambda: torch._int_mm(codes, q_codes.t()),
                   20 if b < 256 else 5)


def compare_codes_scan(store, perm, n_rows: int, seed: int,
                       tier: str) -> dict:
    """B4 (int8) or B7 (int4) over the quantized live-prefix mirror at B =
    1, 64 and 256: winners bit-identical to the plain version, the ring
    stages and the tile's ptxas line. The B = 64 result, with every width's
    under ``at_b``; ``library_ms`` is ``torch._int_mm`` over the int8 codes
    (B7: the unpacked nibbles) for the product alone (:func:`int_mm_ms`)."""
    quant, kern_fn, ref_fn, name = {
        "int8": (quantize_rows, topk.cand_scan_int8_prefix,
                 topk.cand_scan_int8_prefix_ref, "B4 int8 candidate scan"),
        "int4": (quantize_rows_int4, topk.cand_scan_int4_prefix,
                 topk.cand_scan_int4_prefix_ref, "B7 int4 candidate scan"),
    }[tier]
    codes, scales = quant(store[perm.long()])
    int4 = tier == "int4"
    # the yardstick's operand: the int8 codes, or the nibbles unpacked
    unpacked = torch.cat(topk._unpack_nibbles(codes), 1) if int4 else codes
    fetch = 128 if tier == "int8" else 256
    out = {}
    for b in (1, 64, 256):
        q = unit_queries(store.device, b, seed + b)
        q_codes, qscale = quantize_rows(q)
        out[b] = compare_winners(
            name, b,
            lambda: kern_fn(codes, scales, q_codes, qscale, n_rows,
                            bucket=topk.CAND_BUCKET,
                            rounds=topk.CAND_ROUNDS),
            lambda: ref_fn(codes, scales, q_codes, qscale, n_rows,
                           bucket=topk.CAND_BUCKET, rounds=topk.CAND_ROUNDS,
                           block_rows=topk.CAND_BLOCK_ROWS),
            topk._cand_merge, store, perm, q, n_rows, fetch, True)
        # int8 codes and f32 scales, rows and queries alike
        out[b].update(_scan_bound(codes.numel() + scales.numel() * 4,
                                  b * (DIM + 4), b, "int8", n_rows),
                      library_ms=int_mm_ms(unpacked, q_codes, b))
        r = out[b]
        qn = 16 if b <= 16 else 64
        stages = topk.codes_ring_stages(codes, b, topk.CAND_ROUNDS,
                                        int4=int4)
        log(f"{name} B={b}: kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.3f} ms"
            + ("" if r["library_ms"] is None else
               f", torch._int_mm (product alone) {r['library_ms']:.4f} ms")
            + f"; {stages} ring stages, ptxas (QN={qn}): "
            + codes_tile_ptxas(qn, topk.CAND_ROUNDS, int4))
    del codes, scales, unpacked
    return dict(out[64], at_b={str(b): _brief(r) for b, r in out.items()})


def check_tile_lists(name: str, kern, plain) -> tuple:
    """Per-tile lists of an exact-scan kernel against its plain version:
    live entries alike, scores within SCAN_RTOL, rows identical except
    where two scores tie within it. ``plain`` may give lists one entry
    deeper than the kernel's: that entry is the neighbour of the last one,
    so a row that a tie within SCAN_RTOL moves across the cut counts as
    tied there too. Returns (max_abs_err, tied entries)."""
    (kv, ki), (pv, pi) = kern(), plain()
    k = kv.shape[-1]
    below = pv[..., k:k + 1]                 # the plain's next entry, if any
    pv, pi = pv[..., :k], pi[..., :k]
    require(torch.equal(torch.isfinite(kv), torch.isfinite(pv)),
            f"{name}: live entries differ")
    live = torch.isfinite(pv)
    err = (kv[live] - pv[live]).abs().max().item()
    require(bool(((kv[live] - pv[live]).abs()
                  <= SCAN_RTOL * pv[live].abs()).all()),
            f"{name}: scores off by {err}")
    gap = torch.full_like(pv, float("inf"))
    gap[..., 1:] = pv[..., :-1] - pv[..., 1:]
    gap[..., :-1] = torch.minimum(gap[..., :-1], pv[..., :-1] - pv[..., 1:])
    if below.shape[-1]:
        gap[..., -1:] = torch.minimum(gap[..., -1:], pv[..., -1:] - below)
    apart = gap > SCAN_RTOL * pv.abs()
    require(torch.equal(ki[apart], pi[apart]), f"{name}: rows differ")
    return err, int((~apart & live).sum())


def compare_block_scan(store, n_rows: int, seed: int) -> dict:
    """B8, the exact f32 scan, at B = 1 (the FMA tile), 16 (a typical
    coalesced flush) and 64 (the 3xTF32 tile): rows identical to the plain
    version's (except where two scores tie within the tolerance), scores
    within SCAN_RTOL of it, the merged top-K within SCORE_ATOL of host f64.
    Bounds: the byte bound, and the operations bound of the tile's own
    products (3xTF32: three TF32 products at the TF32 peak; the FMA tile:
    one product at the f32 peak), with the f32-core bound of one product
    beside them. Library: ``torch.mm`` alone, f32 with TF32 off, at the
    same shape — a yardstick for the product only (the port never calls
    it; the scan also selects each tile's top K)."""
    out = {}
    n_tiles = -(-store.shape[0] // topk.SCAN_TILE_ROWS)
    for b in (1, 16, 64):
        q = unit_queries(store.device, b, seed + b)

        def kern():
            return topk.block_scan(store, q, n_rows, k=K)

        def plain(k=K):
            return topk.block_scan_ref(store, q, n_rows, k=k,
                                       tile_rows=topk.SCAN_TILE_ROWS)

        err, ties = check_tile_lists(f"B8 B={b}", kern,
                                     lambda: plain(K + 1))
        # the merged top-K against host f64 scores of the same rows
        vals, rows = topk.cosine_topk(store, q, n_rows, k=K)
        host = (store[rows.long()].double().cpu()
                @ q.double().cpu()[:, :, None])[..., 0]
        herr = (vals.double().cpu() - host).abs().max().item()
        require(herr <= SCORE_ATOL, f"B8 B={b}: host score error {herr}")
        iters = 20 if b == 1 else 10
        ms, pms = cuda_ms(kern, iters), cuda_ms(plain, iters)
        lms = cuda_ms(lambda: torch.mm(q, store.t()), iters)
        moved = store.numel() * 4 + b * DIM * 4 + n_tiles * b * K * 8
        flop = 2 * store.shape[0] * DIM * b
        tf32 = b > 8                         # vqt_block_scan's route
        lim = bound(moved, 3 * flop if tf32 else flop,
                    "tf32" if tf32 else "f32")
        cores = bound(moved, flop, "f32")
        log(f"B8 exact scan N={n_rows} B={b} k={K} "
            f"({'3xTF32' if tf32 else 'FMA'} tile): rows identical "
            f"({ties} tied entries), max_abs_err {err:.3e} (rtol "
            f"{SCAN_RTOL}), top-{K} vs host f64 {herr:.2e}; kernel "
            f"{ms:.3f} ms plain {pms:.3f} ms torch.mm alone {lms:.3f} ms; "
            f"bound {lim['bound_ms']:.3f} ms ({lim['bound_by']}: bytes "
            f"{1e3 * moved / HBM_BYTES_S:.3f}, 3xTF32 operations "
            f"{3e3 * flop / PEAK_OPS_S['tf32']:.3f}; f32-core bound "
            f"{cores['bound_ms']:.3f})")
        out[b] = {"max_abs_err": err, "ms": ms, "plain_ms": pms, **lim,
                  "library_ms": lms}
    return out[64]


def mesh_perm(n_rows: int, shards: int) -> tuple:
    """The perm layout a corpus mesh of ``shards`` shards places for
    ``n_rows`` rows — DeviceVideoIndex's capacity rule and its fixed
    permutation: ``(capacity, perm [capacity] i32)``."""
    index = DeviceVideoIndex(dim=DIM, device_dtype="bfloat16", device="cpu",
                             mesh=CorpusMesh(["cpu"] * shards))
    cap = _round_capacity(n_rows, index._granularity)
    index._require_perm(cap)
    return cap, index._perm


def _perm_bound(mirror_bytes: int, query_bytes: int, kind: str,
                rows: int, b: int) -> dict:
    """Bound of a perm-layout candidate scan over ``rows`` rows: the mirror
    (and scales), the perm column and the queries read once, the winners
    written once; 2 D operations per row and query."""
    w = topk.CAND_ROUNDS * rows // topk.CAND_BUCKET
    return bound(mirror_bytes + rows * 4 + query_bytes + w * b * 8,
                 2 * rows * DIM * b, kind)


def compare_perm_scans(store, n_rows: int, seed: int) -> tuple:
    """B10 (bf16) at B = 64 and B11 (int8) at B = 1, 64 and 256, fetch 128,
    over shard 0 of the perm layout of a MESH_SHARDS-shard mesh and over
    the whole corpus as one shard (liveness ``perm < n_rows``, the global
    count): the top-K after merge + exact re-rank identical to the plain
    version's, B11's winners bit-identical. Returns the one-shard (B10,
    B11) results at B = 64, each with the shard's numbers under
    ``shard``; B11's with every width's under ``at_b`` (one shard) and
    ``shard_at_b``."""
    dev, b = store.device, 64
    q = unit_queries(dev, b, seed + b)
    out = {}
    for shards in (MESH_SHARDS, 1):
        cap, perm_np = mesh_perm(n_rows, shards)
        rows = cap // shards
        perm = torch.from_numpy(perm_np[:rows]).to(dev)
        # positions holding rows past the store are dead (perm >= n_rows)
        src = torch.clamp(perm, max=store.shape[0] - 1).long()
        what = (f"shard 0 of {shards}, {rows} rows" if shards > 1
                else f"one shard, {rows} rows")
        mirror = store[src].bfloat16()
        b10 = compare_winners(
            f"B10 perm candidate scan ({what})", b,
            lambda: topk.cand_scan(mirror, perm, q, n_rows,
                                   bucket=topk.CAND_BUCKET,
                                   rounds=topk.CAND_ROUNDS),
            lambda: topk.cand_scan_ref(
                mirror, perm, q, n_rows, bucket=topk.CAND_BUCKET,
                rounds=topk.CAND_ROUNDS, block_rows=topk.CAND_BLOCK_ROWS),
            topk._cand_merge, store, perm, q, n_rows, 128, False)
        b10.update(_perm_bound(rows * DIM * 2, b * DIM * 2, "bf16", rows, b),
                   library_ms=None)
        del mirror
        log(f"B10 ({what}) B={b}: bound {b10['bound_ms']:.3f} ms "
            f"({b10['bound_by']})")
        codes, scales = quantize_rows(store[src])
        b11 = {}
        for bb in (1, 64, 256):
            qb = unit_queries(dev, bb, seed + bb)
            q_codes, qscale = quantize_rows(qb)
            b11[bb] = compare_winners(
                f"B11 int8 perm candidate scan ({what})", bb,
                lambda: topk.cand_scan_int8(
                    codes, scales, perm, q_codes, qscale, n_rows,
                    bucket=topk.CAND_BUCKET, rounds=topk.CAND_ROUNDS),
                lambda: topk.cand_scan_int8_ref(
                    codes, scales, perm, q_codes, qscale, n_rows,
                    bucket=topk.CAND_BUCKET, rounds=topk.CAND_ROUNDS,
                    block_rows=topk.CAND_BLOCK_ROWS),
                topk._cand_merge, store, perm, qb, n_rows, 128, True)
            b11[bb].update(_perm_bound(rows * (DIM + 4), bb * (DIM + 4),
                                       "int8", rows, bb), library_ms=None)
            r = b11[bb]
            log(f"B11 ({what}) B={bb}: kernel {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                f"{r['plain_ms']:.3f} ms")
        del codes, scales
        out[shards] = (b10, b11)
    b10, b11 = out[1]
    b10_shard, b11_shard = out[MESH_SHARDS]
    return (dict(b10, shard=_brief(b10_shard)),
            dict(b11[64], shard=_brief(b11_shard[64]),
                 at_b={str(bb): _brief(r) for bb, r in b11.items()},
                 shard_at_b={str(bb): _brief(r)
                             for bb, r in b11_shard.items()}))


def _host_scores(mat, scales, q, rows) -> torch.Tensor:
    """f64 scores, on the host, of the rows ``rows [B, k]`` of ``mat`` for
    the queries ``q [B, D]``, times the rows' scales where given."""
    e = mat[rows.long()].double().cpu()
    sc = (e @ q.double().cpu()[:, :, None])[..., 0]
    if scales is not None:
        sc = sc * scales[rows.long(), 0].double().cpu()
    return sc


def compare_exact_scans(store, n_rows: int, seed: int) -> tuple:
    """The hatch's exact scans over the identity mirror, both on the span
    tile: B9 over int8 codes (B = 1: the f32-query contract, split by the
    kernel into three bf16 parts; B = 64: the bf16-query one) and B8 over
    bf16 rows, at B = 1 and 64 and k = K and HATCH_K (the hatch's fetch).
    Per-span lists against the plain version's at the same span
    (check_tile_lists), the merged top-K's scores against host f64 scores
    of their rows within SCORE_ATOL; the ring stages each launch takes;
    bounds with the span lists' output bytes. Returns the B = 64, k =
    HATCH_K results (B9, B8 bf16)."""
    n = store.shape[0]
    n_spans = -(-n // topk.SCAN_SPAN_ROWS)
    codes, scales = quantize_rows(store)
    rows16 = store.bfloat16()
    span = topk.SCAN_SPAN_ROWS
    scans = {
        "B9 exact int8 scan": (
            codes, scales,
            lambda q, k: topk.block_scan_int8(codes, scales, q, n_rows, k=k),
            lambda q, k: topk.block_scan_int8_ref(
                codes, scales, topk._int8_scan_queries(q, n), n_rows, k=k,
                tile_rows=span),
            lambda q: topk.cosine_topk_int8(codes, scales, q, n_rows, k=K),
            lambda q: topk._int8_scan_queries(q, n), n * (DIM + 4)),
        "B8 exact scan over bf16 rows": (
            rows16, None,
            lambda q, k: topk.block_scan_bf16(rows16, q, n_rows, k=k),
            lambda q, k: topk.block_scan_ref(
                rows16, q.bfloat16().float(), n_rows, k=k, tile_rows=span),
            lambda q: topk.cosine_topk(rows16, q, n_rows, k=K),
            lambda q: q.bfloat16().float(), n * DIM * 2),
    }
    out = {}
    for name, (mat, sc, kern_fn, plain_fn, merged_fn, contract,
               matrix_bytes) in scans.items():
        for b in (1, 64):
            q = unit_queries(store.device, b, seed + b)
            vals, rows = merged_fn(q)
            herr = (vals.double().cpu()
                    - _host_scores(mat, sc, contract(q), rows)).abs().max()
            require(herr <= SCORE_ATOL,
                    f"{name} B={b}: host score error {herr}")
            for k in (K, HATCH_K):
                err, ties = check_tile_lists(
                    f"{name} B={b} k={k}", lambda: kern_fn(q, k),
                    lambda: plain_fn(q, k + 1))
                stages = topk.span_ring_stages(mat, b, k)
                ms = cuda_ms(lambda: kern_fn(q, k), 20 if b == 1 else 10)
                pms = cuda_ms(lambda: plain_fn(q, k), 5)
                # B9 at B = 1 multiplies f32 queries (the f32 peak); the
                # bf16 contracts' products are exact bf16 ones
                kind = "f32" if name.startswith("B9") and b == 1 else "bf16"
                lim = bound(matrix_bytes + b * DIM * 4 + n_spans * b * k * 8,
                            2 * n * DIM * b, kind)
                log(f"{name} N={n_rows} B={b} k={k} ({stages} ring stages "
                    f"a warpgroup): span lists identical ({ties} tied "
                    f"entries), max_abs_err {err:.3e} (rtol {SCAN_RTOL}), "
                    f"top-{K} vs host f64 {herr:.2e}; kernel {ms:.4f} ms "
                    f"plain {pms:.3f} ms bound {lim['bound_ms']:.3f} ms "
                    f"({lim['bound_by']})")
                out[name, b, k] = {"max_abs_err": err, "ms": ms,
                                   "plain_ms": pms, **lim,
                                   "library_ms": None}
    del codes, scales, rows16
    return tuple(out[name, 64, HATCH_K] for name in scans)


def clustered_corpus(dev, n_rows: int, seed: int):
    """``n_rows`` unit rows around ``IVF_CENTRES`` random unit centres (row
    i around centre i mod IVF_CENTRES, Gaussian spread ``IVF_SPREAD`` per
    coordinate, renormalized), and each row's centre."""
    g = torch.Generator(device=dev).manual_seed(seed)
    centres = torch.randn(IVF_CENTRES, DIM, generator=g, device=dev)
    centres /= torch.linalg.vector_norm(centres, dim=-1, keepdim=True)
    label = torch.arange(n_rows, device=dev) % IVF_CENTRES
    rows = torch.randn(n_rows, DIM, generator=g, device=dev)
    rows.mul_(IVF_SPREAD).add_(centres[label])
    rows /= torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    return rows, label


def log_build(what: str, split: dict) -> None:
    log(f"{what} build split (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items() if k != "evicted")
        + f"; total {sum(v for k, v in split.items() if k != 'evicted'):.3f}"
        f"; rows evicted by the rebalance {split['evicted']}")


def probe_bound(row_ids: np.ndarray, tile_list: np.ndarray, b: int
                ) -> tuple:
    """B12's bound for this pair list over tiles whose ids are ``row_ids
    [T, BLOCK_ROWS]``: each probed tile's live rows and its ids read once,
    the pair list and the queries read once, the lists written once; 2 D
    operations per live row of every pair. Also the live pairs (those on a
    tile with a live row), the distinct tiles they probe, and the bytes if
    every live pair read its own tile."""
    live_rows = (row_ids >= 0).sum(axis=1)              # per tile
    pairs = tile_list[live_rows[tile_list] > 0]
    tiles = np.unique(pairs)
    p = tile_list.shape[0]
    moved = (live_rows[tiles].sum() * DIM * 4 + tiles.size * ivf.BLOCK_ROWS
             * 4 + p * 8 + b * DIM * 4 + p * K * 8)
    per_pair = live_rows[pairs].sum() * DIM * 4 + pairs.size * (
        ivf.BLOCK_ROWS * 4)
    return (bound(moved, 2 * DIM * live_rows[pairs].sum(), "f32"),
            pairs.size, tiles.size, per_pair)


def check_probe(name: str, got, want) -> tuple:
    """B12's lists against the plain version's, pair by pair: pads in the
    same places, rows identical except where two scores tie within
    SCAN_RTOL, scores within SCAN_RTOL. Returns (max_abs_err, tied
    entries)."""
    (kv, ki), (pv, pi) = got, want
    pad = ~torch.isfinite(pv)
    require(torch.equal(~torch.isfinite(kv), pad)
            and bool((ki[pad] == -1).all())
            and bool((pi[pad] == -1).all()), f"{name}: pads differ")
    err = (kv[~pad] - pv[~pad]).abs().max().item()
    require(bool(((kv[~pad] - pv[~pad]).abs()
                  <= SCAN_RTOL * pv[~pad].abs()).all()),
            f"{name}: scores off by {err}")
    gap = torch.full_like(pv, float("inf"))
    gap[:, 1:] = pv[:, :-1] - pv[:, 1:]
    gap[:, :-1] = torch.minimum(gap[:, :-1], pv[:, :-1] - pv[:, 1:])
    apart = (gap > SCAN_RTOL * pv.abs()) & ~pad
    require(torch.equal(ki[apart], pi[apart]), f"{name}: rows differ")
    return err, int((~apart & ~pad).sum())


def time_probe(name: str, tiles, ids, row_ids: np.ndarray,
               tile_list: np.ndarray, qidx: np.ndarray, q) -> dict:
    """B12 on one pair list against its plain version (:func:`check_probe`),
    one launch counted, then timed: CUDA events around the wrapper call
    (every launch of the call), and the device time of the same calls
    replayed from a CUDA graph."""
    b = q.shape[0]
    tl, qi = (torch.from_numpy(x).to(q.device) for x in (tile_list, qidx))

    def kern():
        return ivf.probe_scan(tiles, ids, tl, qi, q, k=K)

    def plain():
        return ivf.probe_scan_ref(tiles, ids, tl, qi, q, k=K)

    before = ivf.probe_scan.launches
    got = kern()
    torch.cuda.synchronize()
    require(ivf.probe_scan.launches == before + 1, f"{name}: launch count")
    err, ties = check_probe(name, got, plain())
    ms = cuda_ms(kern, 20)
    device_ms = graph_ms(kern, 20)
    pms = cuda_ms(plain, 3 if b > 1 else 10)
    # the host's time a call, nothing synchronised inside the loop
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        kern()
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    # each of the call's kernels (the later two launch early and wait for
    # the one before, so their spans include that wait)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            kern()
        torch.cuda.synchronize()
    spans = {re.search(r"probe_[a-z]+_kernel", e.key)[0]:
             e.device_time_total / e.count / 1e3
             for e in prof.key_averages()
             if re.search(r"probe_[a-z]+_kernel", e.key)}
    lim, live, distinct, per_pair = probe_bound(row_ids, tile_list, b)
    log(f"{name} k={K}: {tile_list.size} pairs ({live} live, {distinct} "
        f"distinct tiles, {ivf.probe_chunks(tile_list.size)} chunks a "
        f"tile); rows identical ({ties} tied entries), pads identical, "
        f"max_abs_err {err:.3e} (rtol {SCAN_RTOL}); kernel {ms:.4f} ms "
        f"plain {pms:.4f} ms bound {lim['bound_ms']:.4f} ms "
        f"({lim['bound_by']}; {per_pair / HBM_BYTES_S * 1e3:.4f} ms if "
        f"every live pair read its own tile); device (graph replay) "
        f"{device_ms:.4f} ms; kernel spans (ms) " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(spans.items()))
        + f"; host {host_ms:.4f} ms a call")
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, **lim,
            "library_ms": None, "device_ms": device_ms}


def compare_probe_scan(dev, n_rows: int, seed: int) -> dict:
    """The IVF tier on a clustered corpus: build it (nlist auto, nprobe 8),
    hold B12 against its plain version pair by pair (:func:`time_probe`)
    at B = 64 and B = 1, then on shard 0 of the same tier spread over a
    MESH_SHARDS-shard mesh on this card (the pair list the mesh's search
    hands its first device, :meth:`IVFIndex._shard_pairs`) at both B, and
    gate the tier's recall@10 against the exact scan (B8) over the same
    rows. Returns the B = 64 result, every case's under ``at_b`` (the
    shard's under ``at_b["shard"]``)."""
    corpus, label = clustered_corpus(dev, n_rows, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    pick = torch.randint(n_rows, (64,), generator=g, device=dev)
    q = corpus[pick] + IVF_SPREAD * torch.randn(64, DIM, generator=g,
                                                device=dev)
    q /= torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    _, exact = topk.cosine_topk(corpus, q, n_rows, k=K)
    own = (label[exact.long()] == label[pick][:, None]).float().mean().item()
    require(own >= 0.9, f"IVF corpus: only {own:.3f} of the exact top-{K} "
            "in the query's own cluster")
    log(f"IVF corpus: {n_rows} rows around {IVF_CENTRES} centres (spread "
        f"{IVF_SPREAD}); {own:.4f} of the 64 queries' exact top-{K} lie in "
        "their own cluster")
    index = ivf.IVFIndex(nprobe=8, device=dev)
    index.build(corpus.cpu().numpy())
    del corpus
    stats = index.stats()
    log(f"IVF build: nlist {stats['nlist']}, {stats['tiles']} tiles (max "
        f"{stats['max_tiles_per_cluster']} per cluster, padding "
        f"{stats['padding_pct']}%), tile budget {index.tile_budget()}")
    log_build("IVF", index.last_build)
    out = {}
    for b in (64, 1):
        qb = q[:b]
        tile_list, qidx = index._probe_pairs(qb.cpu().numpy(), index.nprobe)
        out[str(b)] = time_probe(
            f"B12 probe scan N={n_rows} B={b}", index._tiled,
            index._row_ids_dev, index._row_ids, tile_list, qidx, qb)
    _, idxs = index.search(q.cpu().numpy(), k=K)
    recall = evaluation.recall_at_k(exact.cpu().numpy(), idxs)
    log(f"IVF recall@{K} (nprobe 8 of {stats['nlist']}) against the exact "
        f"scan over the same rows, 64 queries: {recall:.4f} (>= "
        f"{IVF_RECALL})")
    require(recall >= IVF_RECALL, f"IVF recall@{K} {recall}")
    # the same tier over a mesh of MESH_SHARDS shards on this card
    mesh = ivf.IVFIndex(nprobe=8, mesh=CorpusMesh([dev] * MESH_SHARDS))
    mesh.nlist = index.nlist
    mesh._set_built(index._centroids_np, index._tiled, index._row_ids,
                    index._tile_start_np, index._tile_counts_np,
                    index._n_built)
    del index
    shard = {}
    row_ids = mesh._sh_ids[0].cpu().numpy()
    for b in (64, 1):
        qb = q[:b]
        tile_lists, qidx, slots = mesh._shard_pairs(qb.cpu().numpy(),
                                                    mesh.nprobe)
        shard[str(b)] = _brief(time_probe(
            f"B12 shard 0 of {MESH_SHARDS} B={b} ({slots} slots a query)",
            mesh._sh_tiled[0], mesh._sh_ids[0], row_ids, tile_lists[0],
            qidx, qb))
    del mesh
    return dict(out["64"], at_b={**{b: _brief(r) for b, r in out.items()},
                                 "shard": shard})


# -- phase 3: the SigLIP kernels ----------------------------------------------

def compare_siglip_halves(embedder: SigLIPEmbedder, seed: int,
                          b: int = 64) -> tuple:
    """B5 (non-causal) and B6 (tanh-GELU) against their plain versions on
    one layer of the seeded SigLIP text tower, bf16, at a fused flush of
    ``b`` queries x 64 tokens (N(0, 1) activations, as the CLIP halves)."""
    c = embedder.cfg.text
    ops = embedder._layer_ops(embedder.params)[0]
    d, f, s = c.hidden_size, c.hidden_size * c.mlp_ratio, c.context_length
    t = b * s
    g = torch.Generator(device=embedder.device).manual_seed(seed + 5)
    x = torch.randn(t, d, generator=g, device=embedder.device).bfloat16()
    kw = {"s": s, "heads": c.num_heads, "eps": c.layer_norm_eps,
          "causal": False}
    mkw = {"eps": c.layer_norm_eps, "act": "gelu_tanh"}
    b5, b6 = half_bounds(t, d, f, s)
    shape = f"B={b} queries (T={t}, D={d}, S={s})"
    out = time_halves({
        "B5 attention half (SigLIP text, non-causal)": (
            lambda: fl.attn_half(x, ops, **kw),
            lambda: fl.attn_half_ref(x, ops, **kw), b5),
        "B6 MLP half (SigLIP text, tanh-GELU)": (
            lambda: fl.mlp_half(x, ops, **mkw),
            lambda: fl.mlp_half_ref(x, ops, **mkw), b6),
    }, shape)
    # what the tanh epilogue costs: the quick-GELU instantiation on the
    # same operands
    with torch.inference_mode():
        quick = graph_ms(lambda: fl.mlp_half(x, ops, eps=c.layer_norm_eps),
                         10)
    log(f"B6 MLP half with quick-GELU at the same {shape}: {quick:.3f} ms "
        f"(device, graph replay) against tanh-GELU's {out[1]['ms']:.3f}")
    return out


def plain_attention(q, k, v, *, num_heads: int, valid_len=None,
                    causal: bool = False) -> torch.Tensor:
    """B3's plain version behind ``attention``'s interface (q pre-scaled
    in f32 and rounded back, as the kernel loads it)."""
    hd = q.shape[-1] // num_heads
    qs = (q.float() * hd ** -0.5).to(q.dtype)
    return attention_ref(qs, k, v, num_heads=num_heads,
                         valid_len=q.shape[1] if valid_len is None
                         else valid_len, causal=causal)


@contextlib.contextmanager
def module_attention_plain():
    """The module towers' attention on its plain version, for the
    comparisons only (the serving path never takes it)."""
    clip_model.attention = plain_attention
    try:
        yield
    finally:
        clip_model.attention = attention


def compare_siglip_encodes(embedder: SigLIPEmbedder, seed: int,
                           b_text: int = 64, b_frames: int = 256) -> None:
    """The whole SigLIP text encode of ``b_text`` queries (the fused encode:
    B5 + B6 with tanh-GELU) and vision encode of ``b_frames`` seeded frames
    (the module tower: B3 and cuBLAS) against the same encodes on the plain
    versions: rows at per-row cosine >= MIN_COS, unit-norm within
    UNIT_ATOL."""
    model = embedder.params
    ops = embedder._layer_ops(model)
    rng = np.random.default_rng(seed + 3)
    ids = embedder.prepare_text_ids(embedder.tokenizer(
        [words(rng, 4) for _ in range(b_text)]))
    c = embedder.cfg
    require(ids.shape == (b_text, c.text.context_length),
            f"SigLIP ids shape {ids.shape}")
    ids_t = embedder.ids_tensor(ids)
    frames = torch.from_numpy(seeded_frames(seed, 10_002, b_frames)).to(
        embedder.device)

    def plain_image():
        with module_attention_plain():
            return model.encode_image(pixels)

    vops = embedder._layer_ops(model, "vision")

    def halves_image():
        """The vision tower on the layer halves (B5, B6 tanh-GELU): not
        the serving route (the module tower is, as in the JAX package),
        timed to show what the halves would give at S = 196."""
        v = model.vision
        x2 = v.embed(pixels).reshape(-1, v.cfg.hidden_size).contiguous()
        for o in vops:
            x2 = fl.attn_half(x2, o, s=v.cfg.num_patches,
                              heads=v.cfg.num_heads,
                              eps=v.cfg.layer_norm_eps, causal=False)
            x2 = fl.mlp_half(x2, o, eps=v.cfg.layer_norm_eps,
                             act="gelu_tanh")
        feats = v.pool(x2.reshape(b_frames, v.cfg.num_patches, -1))
        return feats.float() / torch.linalg.vector_norm(
            feats.float(), dim=-1, keepdim=True)

    with torch.inference_mode():
        pixels = normalize_images(frames, dtype=embedder.dtype,
                                  mean=SIGLIP_MEAN, std=SIGLIP_STD)
        encodes = (
            (f"SigLIP text encode B={b_text} S={ids.shape[1]} x"
             f"{len(ops)} layers (fused: B5 + B6 tanh-GELU)", b_text, "rows",
             lambda: fused_siglip_text_encode(model, ids_t, ops),
             lambda: fused_siglip_text_encode(model, ids_t, ops,
                                              attn=fl.attn_half_ref,
                                              mlp=fl.mlp_half_ref), 10),
            (f"SigLIP vision encode B={b_frames} frames S="
             f"{c.vision.num_patches} x{c.vision.num_layers} layers (module "
             "tower: B3)", b_frames, "frames",
             lambda: model.encode_image(pixels), plain_image, 3))
        for name, n, unit, kern, plain, iters in encodes:
            a, p = kern(), plain()
            cos = torch.nn.functional.cosine_similarity(a, p, dim=-1).min()
            norm = (torch.linalg.vector_norm(a, dim=-1) - 1).abs().max()
            require(a.shape == (n, c.vision.hidden_size)
                    and bool(torch.isfinite(a).all()), f"{name}: output")
            require(cos.item() >= MIN_COS, f"{name}: min cosine {cos}")
            require(norm.item() <= UNIT_ATOL, f"{name}: norm error {norm}")
            ms, pms = cuda_ms(kern, iters), cuda_ms(plain, iters)
            log(f"{name} (bf16): min cosine {cos.item():.6f} (>= {MIN_COS}) "
                f"vs the plain versions, max |norm - 1| {norm.item():.2e} "
                f"(<= {UNIT_ATOL}); kernels {ms:.3f} ms plain {pms:.3f} ms "
                f"= {n / ms * 1e3:.0f} {unit}/s on the kernels")
        a, h = model.encode_image(pixels), halves_image()
        cos = torch.nn.functional.cosine_similarity(a, h, dim=-1).min()
        require(cos.item() >= MIN_COS, f"SigLIP vision on the halves: {cos}")
        ms = cuda_ms(halves_image, 3)
        log(f"SigLIP vision encode B={b_frames} frames on the layer halves "
            f"(B5 + B6 tanh-GELU; not the serving route): {ms:.3f} ms = "
            f"{b_frames / ms * 1e3:.0f} frames/s, min cosine "
            f"{cos.item():.6f} against the module tower")


def phase_siglip_kernels(embedder: SigLIPEmbedder, args, device) -> dict:
    """Phase 3's SigLIP part: B5/B6 at the text shape, B3 at the SigLIP
    shapes beside SDPA, both encodes, and B1 over a 2,000,000 x 768 bf16
    mirror at B = 1 and 64; returns their kernels-line numbers."""
    b5, b6 = compare_siglip_halves(embedder, args.seed)
    b3 = compare_attention(device, SIGLIP_ATTN_SHAPES, row=(256, 196))
    compare_siglip_encodes(embedder, args.seed)
    n_rows = args.videos * args.frames
    store, perm = corpus_on_card(device, n_rows, args.seed + 11, SIGLIP_DIM)
    b1 = compare_cand_scan(store, perm, n_rows, args.seed + 11, (1, 64))
    del store, perm
    gc.collect()
    torch.cuda.empty_cache()
    return {"attn_half": b5, "mlp_half": b6, "attention": b3,
            "cand_scan_prefix": b1}


# -- phases 4 and 5: end to end -----------------------------------------------

def video_name(v: int) -> str:
    return f"video_{v:05d}.mp4"


def write_cache(corpus: np.ndarray, n_frames: int, path: Path) -> None:
    idx = DeviceVideoIndex(dim=corpus.shape[1], device_dtype="bfloat16",
                           device="cpu")            # host store only
    idx.reserve(len(corpus))
    stamps = [0.5 * t for t in range(n_frames)]
    for v in range(len(corpus) // n_frames):
        idx.add_batch(corpus[v * n_frames:(v + 1) * n_frames],
                      video_name(v), stamps)
    require(idx.save_to_disk(path), f"cache write to {path}")


def http(base: str, method: str, path: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        payload = json.loads(r.read())
        status = r.status
    return status, payload, time.perf_counter() - t0


def check_search_response(status: int, body: dict, k: int) -> None:
    require(status == 200, f"search status {status}")
    require(set(body) == RESPONSE_KEYS, f"response keys {sorted(body)}")
    require(body["from_cache"] is False, "answered from the query cache")
    require(len(body["results"]) == k, f"{len(body['results'])} rows")
    require(body["performance"] == {"results_count": k}, "performance")
    for r in body["results"]:
        require(set(r) == ROW_KEYS, f"row keys {sorted(r)}")


def check_exact(corpus: np.ndarray, name_of, qs: np.ndarray,
                rows_per_query) -> float:
    """Returned rows == host exact top-K of the f32 corpus under the
    index's query normalisation, with the video names ``name_of(row)``;
    returns the max score error."""
    qn = qs / (np.linalg.norm(qs, axis=1, keepdims=True) + 1e-10)
    scores = corpus @ qn.T                                 # [N, Q]
    worst = 0.0
    for j, rows in enumerate(rows_per_query):
        s = scores[:, j]
        top = np.argpartition(-s, K)[:K]
        top = top[np.lexsort((top, -s[top]))]
        got = [r["frame_id"] for r in rows]
        require(got == top.tolist(),
                f"rows {got} != host exact top-{K} {top.tolist()}")
        require([r["video_name"] for r in rows]
                == [name_of(int(t)) for t in top], "video names")
        err = np.abs(np.array([r["score"] for r in rows]) - s[top]).max()
        require(err <= SCORE_ATOL, f"score error {err}")
        worst = max(worst, float(err))
    return worst


def concurrent_phase(base: str, name: str, queries, k: int):
    with ThreadPoolExecutor(len(queries)) as pool:
        t0 = time.perf_counter()
        out = list(pool.map(
            lambda q: http(base, "POST", "/api/search",
                           {"query": q, "k": k, "use_cache": False}),
            queries))
        wall = time.perf_counter() - t0
    for status, body, _ in out:
        check_search_response(status, body, k)
    lat = [t for _, _, t in out]
    log(f"e2e {name}: {len(queries)} concurrent searches in {wall:.3f} s "
        f"= {len(queries) / wall:.1f} searches/s, p50 latency "
        f"{1e3 * float(np.median(lat)):.2f} ms")
    return [body["results"] for _, body, _ in out]


def check_scores(corpus: np.ndarray, qs: np.ndarray, rows_per_query
                 ) -> float:
    """Each returned score == its row's exact f32 score, rows in (score
    desc, row asc) order; returns the max score error."""
    check_order(rows_per_query)
    qn = qs / (np.linalg.norm(qs, axis=1, keepdims=True) + 1e-10)
    worst = 0.0
    for j, rows in enumerate(rows_per_query):
        ids = np.array([r["frame_id"] for r in rows])
        got = np.array([r["score"] for r in rows])
        err = np.abs(got - corpus[ids] @ qn[j]).max()
        require(err <= SCORE_ATOL, f"score error {err}")
        worst = max(worst, float(err))
    return worst


def check_order(rows_per_query) -> None:
    for rows in rows_per_query:
        s = [(-r["score"], r["frame_id"]) for r in rows]
        require(s == sorted(s), "rows not in (score desc, row asc) order")


def phase_end_to_end(embedder: CLIPEmbedder, args, device, smi: str
                     ) -> tuple:
    """Every mirror dtype: ingest onto one pickle cache, then the HTTP
    server; then the corpus-mesh and hatch engines (phase 5) over the same
    cache. Returns each dtype's launch counts on its search path and on
    its ingest path, and each phase-5 engine's search-path counts."""
    n = args.videos * args.frames
    t0 = time.perf_counter()
    corpus = corpus_on_card_rows(device, args.seed, n, DIM)
    log(f"corpus: {n} rows x {DIM} from seed {args.seed}, drawn on the "
        f"card, in {time.perf_counter() - t0:.1f} s")
    scratch = ROOT / "build" / "smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed + 1)
    launches, ingested = {}, {}
    n_extra = min(EXTRA_VIDEOS, args.videos)
    with tempfile.TemporaryDirectory(dir=scratch) as videos, \
            tempfile.TemporaryDirectory(dir=scratch) as small:
        t0 = time.perf_counter()
        write_cache(corpus, args.frames,
                    Path(videos) / "video_search_cache.pkl")
        log(f"pickle v1.0 cache written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        write_cache(corpus[:n_extra * args.frames], args.frames,
                    Path(small) / "video_search_cache.pkl")
        log(f"phase 5's pickle v1.0 cache ({n_extra} videos, "
            f"{n_extra * args.frames} rows) written in "
            f"{time.perf_counter() - t0:.1f} s")
        del corpus
        surface = {}
        for tier in SCANS:
            with timed(f"4, {tier} engine"):
                launches[tier], ingested[tier], kept = serve_dtype(
                    tier, videos, embedder, args, rng, device, surface)
            if kept is not None:
                bf16_engine = kept
        extra = {}
        for spec in EXTRA:
            with timed(f"5, {spec[0]} engine"):
                extra[spec[0]] = serve_extra(spec, small, n_extra, embedder,
                                             args, rng, device, surface)
        # phase 4's bf16 engine again, once phase 5's engines are done
        with timed("8, phase 4's bf16 engine: keyword, profiler"):
            surface["2m"] = phase_big_engine(bf16_engine, videos,
                                             args, rng, device, scratch, smi)
        del bf16_engine
        gc.collect()
        torch.cuda.empty_cache()
    with timed("7, maintenance engine"):
        surface["maintenance"] = phase_maintenance(embedder, args, device,
                                                   scratch)
    with timed("8, frame memo engine"):
        surface["memo"] = phase_memo(args, device, scratch)
    return launches, ingested, extra, surface


def serve_dtype(dtype: str, videos: str, embedder: CLIPEmbedder, args,
                rng, device, surface: dict) -> tuple:
    """One engine with ``index.device_dtype = dtype`` (``"ivf"``: the IVF
    tier over the bf16 mirror): it ingests, then serves behind the HTTP
    server. The launch counters are set to 0 just before the ingest and
    read just after it, then set to 0 just before the searches and read
    just after the last response, before the script's own reference
    encodes; then phase 7 (bf16, f32, int8) drives the query surface on
    the same server, its results going to ``surface[dtype]``. Returns the
    launch counts and, for bf16, the engine itself (phase 8 runs on it
    once every engine that loads the cache has run)."""
    config = EngineConfig()
    config.index.device_dtype = "bfloat16" if dtype == "ivf" else dtype
    if dtype == "ivf":
        config.index.kind = "ivf"
    engine = VideoSearchEngine(videos, config=config, embedder=embedder,
                               device=device)
    t0 = time.perf_counter()
    engine.startup()
    require_seeded(dtype, engine)
    n_base = args.videos * args.frames
    require(len(engine.index) == n_base, "startup row count")
    mode = engine.stats()["index"]["accuracy_mode"]
    require(mode == MODES.get(dtype, "exact-f32-rerank"), f"mode {mode}")
    log(f"[{dtype}] engine.startup(): {len(engine.index)} rows, mirror "
        f"{'' if mode == 'exact-f32-scan' else '+ re-rank store '}"
        f"{'+ IVF tiles ' if dtype == 'ivf' else ''}on the card, in "
        f"{time.perf_counter() - t0:.1f} s ({mode})")
    if dtype == "ivf":
        ann = engine.ann_stats()
        require(ann["active"] and ann["rows"] == n_base
                and ann["fresh_rows"] == 0, f"IVF tier {ann}")
        log(f"[ivf] tier: nlist {ann['nlist']}, nprobe {ann['nprobe']}, "
            f"{ann['tiles']} tiles (max {ann['max_tiles_per_cluster']} per "
            f"cluster, padding {ann['padding_pct']}%), tile budget "
            f"{engine._ivf.tile_budget()}; ivf_build "
            f"{engine.metrics.histogram_stats('ivf_build_ms')['max']:.1f} "
            "ms")
        log_build("[ivf] startup IVF", engine._ivf.last_build)
    ingested = ingest_tier(engine, dtype, videos, args, device)
    corpus = engine.index._emb[: len(engine.index)]

    def name_of(row: int) -> str:
        if row < n_base:
            return video_name(row // args.frames)
        return ingest_name((row - n_base) // args.frames)

    server = create_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        served = drive(base, dtype, rng)
        launches = {name: w.launches for name, w in WRAPPERS.items()}
        if dtype == "ivf":
            ivf_split(engine, rng, device)
        if dtype in SURFACE_SCANS:
            with timed(f"7, {dtype} engine surface"):
                surface[dtype] = phase_surface(
                    dtype, base, engine, embedder, name_of, args.frames,
                    rng, device, full=dtype == "bfloat16")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        engine.close()
    check_launches(dtype, engine, launches, SCANS[dtype])
    if dtype == "ivf":
        check_probed(engine, embedder, corpus, name_of, served, device)
    else:
        check_served(dtype, embedder, corpus, name_of, served, device)
    kept = engine if dtype == "bfloat16" else None
    del engine, server, corpus
    gc.collect()
    torch.cuda.empty_cache()
    return launches, ingested, kept


def require_seeded(tag: str, engine: VideoSearchEngine) -> None:
    """A seeded engine serves its seeded tower: no checkpoint found by
    discovery may swap its weights."""
    pretrained = engine.stats()["pretrained"]
    require(pretrained is False, f"[{tag}] pretrained {pretrained}")


def check_launches(tag: str, engine: VideoSearchEngine, launches: dict,
                   scan: str) -> None:
    """The search path launched its scan kernel and the text kernels (B2,
    B3), and no other kernel; both fallback counters read 0."""
    log(f"[{tag}] launches during the path: {launches}")
    path = (scan, "fused_layer", "attention")
    for name, count in launches.items():
        if name in path:
            require(count > 0, f"[{tag}] kernel {name} was not launched")
        else:
            require(count == 0, f"[{tag}] {name} launched {count} times")
    for name in ("embed_fallbacks", "fused_search_fallbacks"):
        count = engine.metrics.counter(name)
        require(count == 0, f"[{tag}] {name} = {count}")
    log(f"[{tag}] fallback counters: embed_fallbacks 0, "
        "fused_search_fallbacks 0")


def serve_extra(spec: tuple, videos: str, n_videos: int,
                embedder: CLIPEmbedder, args, rng, device,
                surface: dict) -> dict:
    """One phase-5 engine over the cache of ``n_videos`` videos in
    ``videos`` (see EXTRA): startup, for the
    bf16 mesh first an ingest of MESH_INGEST_VIDEOS seeded videos, then 8
    single searches and one batch of 64 through the engine's own entry
    points, the launch counters set to 0 just before and read just after;
    the rows against the host's exact (IVF: probed-exact) top-K. Returns
    the search path's launch counts."""
    tag, dtype, kind, shards, hatch, scan = spec
    config = EngineConfig()
    config.index.device_dtype = dtype
    config.index.kind = kind
    mesh = None
    if shards > 0:
        mesh = CorpusMesh([device] * shards)
    elif shards < 0:
        config.index.corpus_shards = 1       # the mesh the config builds
    if hatch:
        os.environ["VQT_CANDIDATE_TOPK"] = "pallas"
    try:
        engine = VideoSearchEngine(videos, config=config, embedder=embedder,
                                   device=device, corpus_mesh=mesh)
        t0 = time.perf_counter()
        engine.startup()
        require_seeded(tag, engine)
        index, n_base = engine.index, n_videos * args.frames
        require(len(index) == n_base, f"[{tag}] startup row count")
        mode = engine.accuracy_mode()
        require(mode == MODES.get(kind, MODES.get(dtype, "exact-f32-rerank")),
                f"[{tag}] mode {mode}")
        log(f"[{tag}] engine.startup(): {len(index)} rows, mesh "
            f"{index.mesh}, mirror layout {index._mirror_layout_cur}, "
            f"capacity {index._emb.shape[0]}, in "
            f"{time.perf_counter() - t0:.1f} s ({mode})")
        if kind == "ivf":
            ann = engine.ann_stats()
            require(ann["active"] and ann["devices"] == shards,
                    f"[{tag}] IVF tier {ann}")
            log(f"[{tag}] tier: nlist {ann['nlist']}, {ann['tiles']} tiles "
                f"over {ann['devices']} shards, tiles_per_device "
                f"{ann['tiles_per_device']}")
        if tag == "mesh bfloat16":
            ingest_tier(engine, dtype, videos, args, device,
                        n_videos=MESH_INGEST_VIDEOS, tag=tag)
        corpus = index._emb[: len(index)]

        def name_of(row: int) -> str:
            if row < n_base:
                return video_name(row // args.frames)
            return ingest_name((row - n_base) // args.frames)

        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        served = drive_engine(engine, tag, rng)
        torch.cuda.synchronize()
        launches = {name: w.launches for name, w in WRAPPERS.items()}
        check_launches(tag, engine, launches, scan)
        if tag in SURFACE_SCANS:
            with timed(f"7, {tag} engine surface"):
                surface[tag] = serve_surface(tag, engine, embedder,
                                             name_of, args.frames, rng,
                                             device)
        if kind == "ivf":
            check_probed(engine, embedder, corpus, name_of, served, device,
                         tag)
        else:
            check_served(dtype, embedder, corpus, name_of, served, device,
                         tag)
        engine.close()
        del engine, index, corpus
    finally:
        os.environ.pop("VQT_CANDIDATE_TOPK", None)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_surface(tag: str, engine: VideoSearchEngine,
                  embedder: CLIPEmbedder, name_of, frames: int, rng,
                  device) -> dict:
    """Phase 7 on a phase-5 engine: behind a server of its own for the
    routes' run."""
    server = create_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        return phase_surface(tag, f"http://127.0.0.1:"
                             f"{server.server_address[1]}", engine,
                             embedder, name_of, frames, rng, device,
                             full=False)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)


def drive_engine(engine: VideoSearchEngine, tag: str, rng) -> tuple:
    """8 single queries (``search_ex``: the module tower, B3) and one batch
    of 64 (``search_batch``: the fused tower, B2); returns the queries and
    rows as ``drive`` does."""
    singles, single_rows, lat = [words(rng, 4) for _ in range(8)], [], []
    for q in singles:
        t0 = time.perf_counter()
        rows, cached = engine.search_ex(q, k=K, use_cache=False)
        lat.append(time.perf_counter() - t0)
        require(not cached and len(rows) == K, f"[{tag}] single search")
        single_rows.append(rows)
    batch, times, splits, rows = [words(rng, 4) for _ in range(64)], [], [], []
    for _ in range(2):
        before = stageprof.snapshot()
        t0 = time.perf_counter()
        rows.append(engine.search_batch(batch, k=K))
        times.append(time.perf_counter() - t0)
        splits.append(stage_ms(before, stageprof.snapshot()))
    batch_rows = rows[0]
    require(len(batch_rows) == 64 and all(len(r) == K for r in batch_rows)
            and rows[1] == batch_rows, f"[{tag}] batch search")
    log(f"[{tag}] 8 single searches, p50 {1e3 * float(np.median(lat)):.2f} "
        f"ms (first {1e3 * lat[0]:.2f} ms); batch of 64, the same queries "
        f"twice: first {1e3 * times[0]:.2f} ms, second {1e3 * times[1]:.2f} "
        "ms")
    log(f"[{tag}] batch stages (host ms, first / second): " + ", ".join(
        f"{k} {splits[0][k]:.2f} / {splits[1].get(k, 0.0):.2f}"
        for k in splits[0]))
    return singles, single_rows, batch, batch_rows


def stage_ms(before: dict, after: dict) -> dict:
    """The stageprof spans' host ms between two snapshots."""
    return {k: 1e3 * (v[1] - before.get(k, (0, 0.0))[1])
            for k, v in after.items() if v[0] > before.get(k, (0, 0.0))[0]}


def ingest_name(v: int) -> str:
    return f"ingest_{v:02d}.mp4"


def seeded_extract(path: Path, *, seed: int, n: int, mode: str):
    """The decode stage's stand-in (the card's machine has no OpenCV): a
    60 s video at 30 fps, sampled by the reference's interval rule into
    ``n`` seeded uint8 frames and their timestamps."""
    v = int(Path(path).stem.split("_")[1])
    step = sampling_interval(int(60 * FPS), n, mode)
    return seeded_frames(seed, v, n), [k * step / FPS for k in range(n)]


def ingest_tier(engine: VideoSearchEngine, dtype: str, videos: str, args,
                device, n_videos: int = INGEST_VIDEOS, tag: str = "",
                path: tuple = INGEST, per_batch: int = 0) -> dict:
    """``n_videos`` seeded videos through ``batched_frames`` and the
    engine's ingest loop onto the loaded corpus (placeholder video files
    in the videos dir, so the hashes are recorded; removed again
    afterwards), then the checks: host rows and metadata, the mirror
    against the host path bit for bit, 16 ingested frames as queries,
    launch and fallback counts (the kernels of ``path`` ``per_batch``
    times an embed batch, by default once a layer, no other). ``tag``
    names the engine in the log."""
    tag = tag or dtype
    index, api, ing = engine.index, engine.config.api, engine.config.ingest
    n0, n = len(index), n_videos * args.frames
    paths = [Path(videos) / ingest_name(v) for v in range(n_videos)]
    for p in paths:
        p.write_bytes(b"seeded frames")
    recorded, batches = [], []
    embed = engine.embed_frames_device

    def recording(frames):
        feats_dev, feats = embed(frames)
        recorded.append(feats)
        return feats_dev, feats

    def counted(it):
        for batch in it:
            batches.append(len(batch))
            yield batch

    engine.embed_frames_device = recording
    extract = functools.partial(seeded_extract, seed=args.seed,
                                n=args.frames, mode=api.sampling_mode)
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with engine.lock:
            added = engine._ingest_batches(paths, counted(batched_frames(
                paths, max_frames=args.frames,
                sampling_mode=api.sampling_mode, batch_size=ing.batch_size,
                num_workers=ing.num_decode_workers,
                prefetch=ing.prefetch_videos, extract_fn=extract)))
            engine._ivf_after_ingest(0)       # as _ingest: IVF fresh rows
            for p in paths:
                index.video_hashes[p.name] = video_identity_hash(p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del engine.embed_frames_device
        for p in paths:
            p.unlink()
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    log(f"[{tag}] ingest: {added} frames of {n_videos} videos in "
        f"{len(batches)} embed batches, {wall:.3f} s = {added / wall:.1f} "
        f"frames/s (seeded frames, decode pipeline, vision tower, host "
        f"append, streamed mirror append); launches {launches}")
    require(added == n and len(index) == n0 + n, "ingest row count")
    per_batch = per_batch or engine._get_embedder().cfg.vision.num_layers
    for name, count in launches.items():
        want = per_batch * len(batches) if name in path else 0
        require(count == want, f"[{tag}] ingest: {name} launched {count} "
                f"times, not {want} ({per_batch} an embed batch x "
                f"{len(batches)} embed batches)")
    for name in ("embed_fallbacks", "fused_search_fallbacks"):
        require(engine.metrics.counter(name) == 0, f"[{tag}] {name}")
    # 1. host rows = the embedder's output, with the reference's metadata
    feats = np.concatenate(recorded)
    require(np.array_equal(index._emb[n0:n0 + n], feats), "host rows")
    step = sampling_interval(int(60 * FPS), args.frames, api.sampling_mode)
    rows = np.arange(n)
    require([index._video_names[v] for v in index._video_ids[n0:n0 + n]]
            == [ingest_name(r // args.frames) for r in rows], "video names")
    require(np.array_equal(index._timestamps[n0:n0 + n],
                           (rows % args.frames) * step / FPS), "timestamps")
    require(np.array_equal(index._frame_ids[n0:n0 + n], n0 + rows),
            "frame ids")
    require(all(index.video_hashes.get(p.name) for p in paths), "hashes")
    check_mirror(index, dtype, device, tag)
    if dtype == "ivf":
        search_ingested_ivf(engine, n0, n)
    else:
        search_ingested(index, dtype, n0, n, device, tag)
    return {"launches": launches, "batches": len(batches),
            "frames_s": added / wall}


def check_mirror(index: DeviceVideoIndex, dtype: str, device,
                 tag: str = "") -> None:
    """The mirror, its scales, the perm column and the re-rank store are
    what the host sync path writes from the host store, bit for bit: for
    every live position p, the host cast (or ``_quantize_host``) of host
    row ``perm[p]``. A mesh's mirror (no streaming: re-placed from the
    host store at the next sync) is checked whole, shard by shard against
    the fixed permutation."""
    tag = tag or dtype
    t0 = time.perf_counter()
    count = len(index)
    if index.mesh is not None:
        require(index._device_rows < count, f"[{tag}] the mesh streamed")
        index.sync_mirror()
        perm = torch.cat([p.to(device) for p in index._perm_dev])
        require(np.array_equal(perm.cpu().numpy(), index._perm),
                f"[{tag}] perm column")
        want = torch.from_numpy(index._emb[index._perm]).to(
            device, index._row_dtype)
        require(torch.equal(torch.cat([e.to(device)
                                       for e in index._device_emb]), want),
                f"[{tag}] mirror rows")
        log(f"[{tag}] ingest: the re-placed mirror ({len(index._device_emb)}"
            f" shards of {want.shape[0] // len(index._device_emb)} rows) and "
            f"its perm column equal the host store's, bit for bit (checked "
            f"in {time.perf_counter() - t0:.1f} s)")
        return
    require(index._device_rows == count, "mirror rows")
    if dtype == "float32":
        rows = index._emb[:count]
    else:
        perm = index._perm_dev.cpu().numpy()
        require(np.array_equal(perm, index._perm), "perm column")
        rows = index._emb[index._perm[:count]]
    if index._codes:
        step = 1 << 16
        with ThreadPoolExecutor(8) as pool:
            parts = list(pool.map(lambda i: index._quantize_host(
                rows[i:i + step]), range(0, count, step)))
        codes = torch.from_numpy(np.concatenate([c for c, _ in parts]))
        scales = torch.from_numpy(np.concatenate([s for _, s in parts]))
        require(torch.equal(index._device_emb[:count].cpu(), codes),
                "mirror codes")
        require(torch.equal(index._device_scales[:count].cpu(), scales),
                "mirror scales")
    else:
        want = torch.from_numpy(rows).to(device, index._row_dtype)
        require(torch.equal(index._device_emb[:count], want), "mirror rows")
        del want
    what = "mirror"
    if dtype != "float32":
        require(index._f32_rows == count, "re-rank store rows")
        require(torch.equal(index._device_f32[:count], torch.from_numpy(
            index._emb[:count]).to(device)), "re-rank store")
        what += ", perm column and re-rank store"
    log(f"[{tag}] ingest: {what} over all {count} live rows equal the "
        f"host path's, bit for bit (checked in "
        f"{time.perf_counter() - t0:.1f} s)")


def search_ingested(index: DeviceVideoIndex, dtype: str, n0: int, n: int,
                    device, tag: str = "") -> None:
    """16 ingested frames as query vectors: every returned score is its
    row's exact f32 score; float32 finds each frame itself first; recall@K
    against the exact scan, and the spread of the ingested embeddings'
    pairwise cosines, are printed."""
    count = len(index)
    pick = n0 + np.linspace(0, n - 1, 16).astype(np.int64)
    q = index._emb[pick]
    qn = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-10)
    rows = index.search_batch(q, k=K)
    err = 0.0
    for j, rr in enumerate(rows):
        ids = np.array([r["frame_id"] for r in rr])
        got = np.array([r["score"] for r in rr])
        err = max(err, float(np.abs(got - index._emb[ids] @ qn[j]).max()))
        if dtype == "float32":
            require(ids[0] == pick[j], f"self-query {pick[j]} -> {ids[0]}")
    tag = tag or dtype
    require(err <= SCORE_ATOL, f"[{tag}] self-query score error {err}")
    check_order(rows)
    truth = evaluation.exact_topk_ids(index._emb[:count], q, K, device)
    got = np.array([[r["frame_id"] for r in rr] for rr in rows])
    recall = evaluation.recall_at_k(truth, got)
    e = torch.from_numpy(index._emb[n0:n0 + n]).to(device)
    cos = (e @ e.t())[~torch.eye(n, dtype=torch.bool, device=device)]
    lo, mid, hi = (cos.min().item(), cos.median().item(), cos.max().item())
    log(f"[{tag}] ingest: 16 ingested frames as queries over {count} rows:"
        + (" each found itself first," if dtype == "float32" else "")
        + f" scores = exact f32 (max error {err:.2e}); recall@{K} vs the "
        f"exact scan {recall:.4f} (not gated); pairwise cosines of the "
        f"{n} ingested rows: min {lo:.4f} median {mid:.4f} max {hi:.6f}")


def search_singles(base, rng, n: int = 16, n_words: int = 4):
    singles = [words(rng, n_words) for _ in range(n)]
    rows, lat = [], []
    for q in singles:
        status, body, t = http(base, "POST", "/api/search",
                               {"query": q, "k": K, "use_cache": False})
        check_search_response(status, body, K)
        rows.append(body["results"])
        lat.append(t)
    return singles, rows, lat


def search_batch(base, rng, n_words: int = 4):
    """One ``/api/search/batch`` of 64; returns its queries and rows."""
    batch = [words(rng, n_words) for _ in range(64)]
    status, body, t = http(base, "POST", "/api/search/batch",
                           {"queries": batch, "k": K})
    require(status == 200 and body["query_count"] == 64
            and body["total_results"] == 64 * K, "batch response")
    return batch, [r["results"] for r in body["results"]], t


def drive(base, dtype, rng, timings: dict = None, n_words: int = 4):
    """The path of one mirror dtype over HTTP, and nothing else: 16 single
    queries (B=1, module tower: attention kernel B3; bfloat16: then the
    IMAGE_SHAPED_TEXT queries), coalesced rounds of 64 concurrent clients
    (fused layer kernel B2 once a flush holds >= 32; bfloat16: three short
    rounds and one of 77 tokens, attention at S=77), and one batch of 64
    (B2), each query ``n_words`` random words. Returns the single and batch
    queries and rows; ``timings``, when given, gets the single p50 and the
    batch's ms. ``dtype`` also tags the log (another tag than a mirror
    dtype: the exact-f32-rerank mode, no bfloat16 extras)."""
    status, health, _ = http(base, "GET", "/api/health")
    require(status == 200 and health["status"] == "healthy", "health")
    status, stats, _ = http(base, "GET", "/api/stats")
    mode = stats["index_performance"]["accuracy_mode"]
    require(status == 200 and mode == MODES.get(dtype, "exact-f32-rerank"),
            f"/api/stats accuracy_mode {mode}")
    log(f"[{dtype}] /api/stats: accuracy_mode {mode}")
    singles, single_rows, lat = search_singles(base, rng, n_words=n_words)
    log(f"[{dtype}] e2e single: 16 sequential searches, p50 latency "
        f"{1e3 * float(np.median(lat)):.2f} ms (first "
        f"{1e3 * lat[0]:.2f} ms), {1 / float(np.median(lat)):.1f} "
        "searches/s")
    if dtype == "bfloat16":
        # image-shaped queries that carry no image are searched as text,
        # as the reference's server does: 200, K rows, held with the
        # singles against the host exact top-K of their text embedding
        for q in IMAGE_SHAPED_TEXT:
            status, body, _ = http(base, "POST", "/api/search",
                                   {"query": q, "k": K, "use_cache": False})
            check_search_response(status, body, K)
            singles.append(q)
            single_rows.append(body["results"])
        log(f"[{dtype}] image-shaped text queries "
            f"{list(IMAGE_SHAPED_TEXT)}: 200, {K} rows each")
    # the flushes' composition (and so the encode path) is not known
    # here: the concurrent rows are held to their schema and order
    rounds = [(f"coalesced short, round {r}", n_words)
              for r in range(3 if dtype == "bfloat16" else 1)]
    if dtype == "bfloat16":
        rounds.append(("coalesced 77-token", 90))
    for name, n_words in rounds:
        check_order(concurrent_phase(base, f"[{dtype}] {name}",
                                     [words(rng, n_words) for _ in range(64)],
                                     K))
    batch, batch_rows, t = search_batch(base, rng, n_words)
    log(f"[{dtype}] e2e batch: 64 queries in one request, {1e3 * t:.2f} ms "
        f"= {64 / t:.1f} searches/s")
    if timings is not None:
        timings.update(single_p50_ms=1e3 * float(np.median(lat)),
                       batch_ms=1e3 * t)
    return singles, single_rows, batch, batch_rows


def served_vectors(embedder: CLIPEmbedder, singles, batch) -> tuple:
    """The query vectors the port's encoders give the served queries:
    singles through the module tower, the batch of 64 through the fused
    one."""
    q_single = np.stack([embedder.embed_text(q) for q in singles])
    with torch.inference_mode():
        q_batch = embedder.text_encode_fn(
            embedder.params, embedder.ids_tensor(
                embedder.prepare_text_ids(embedder.tokenizer(batch)))
        ).cpu().numpy()
    return q_single, q_batch


def check_probed(engine: VideoSearchEngine, embedder: CLIPEmbedder,
                 corpus: np.ndarray, name_of, served, device,
                 tag: str = "ivf") -> None:
    """The IVF tier's served rows against the host's exact top-K over the
    rows it probes: the query vector the port's encoder gives, normalized
    as the engine does; the same clusters by the same numpy rule (each
    single alone and the batch at once, as the engine scores them); the
    same tile budget over the built row ids, read back from the card once;
    plus the fresh rows. Rows identical, scores within SCORE_ATOL; recall@K
    against the full exact scan is printed, not gated."""
    singles, single_rows, batch, batch_rows = served
    q_single, q_batch = served_vectors(embedder, singles, batch)
    tier = engine._ivf
    row_ids = tier._row_ids
    counts = tier._tile_counts_np
    budget = min(int(counts.max()), max(1, 4 * int(np.median(counts))))
    nprobe = min(tier.nprobe, tier.nlist)
    fresh = np.arange(tier._n_built, corpus.shape[0])
    worst = 0.0
    groups = [(q[None], [rows]) for q, rows in zip(q_single, single_rows)]
    for qs, rows_per_query in groups + [(q_batch, batch_rows)]:
        qn = np.stack([q / (np.linalg.norm(q) + 1e-10) for q in qs])
        csims = qn @ tier._centroids_np.T
        for j, rows in enumerate(rows_per_query):
            clusters = np.argpartition(-csims[j], nprobe - 1)[:nprobe]
            cand = np.concatenate([
                row_ids[s: s + min(c, budget)].ravel() for s, c in zip(
                    tier._tile_start_np[clusters], counts[clusters])]
                + [fresh])
            cand = cand[cand >= 0]
            sc = corpus[cand] @ qn[j]
            top = np.lexsort((cand, -sc))[:K]
            got = [r["frame_id"] for r in rows]
            require(got == cand[top].tolist(), f"[{tag}] rows {got} != the "
                    f"host's probed-exact top-{K} {cand[top].tolist()}")
            require([r["video_name"] for r in rows]
                    == [name_of(int(t)) for t in cand[top]], "video names")
            err = np.abs(np.array([r["score"] for r in rows]) - sc[top]).max()
            require(err <= SCORE_ATOL, f"[{tag}] score error {err}")
            worst = max(worst, float(err))
    qs = np.concatenate([q_single, q_batch])
    truth = evaluation.exact_topk_ids(corpus, qs, K, device)
    got = np.array([[r["frame_id"] for r in rr]
                    for rr in single_rows + batch_rows])
    log(f"[{tag}] e2e single + batch: all {len(qs)} match the host's "
        f"probed-exact top-{K} (nprobe {nprobe}, tile budget {budget}, "
        f"{fresh.size} fresh rows; max score error {worst:.2e}); recall@{K} "
        f"against the full exact scan {evaluation.recall_at_k(truth, got):.4f}"
        " (not gated: the corpus is random noise)")


def search_ingested_ivf(engine: VideoSearchEngine, n0: int, n: int) -> None:
    """The ingested rows sit in the IVF tier's fresh buffer (no rebuild:
    4,000 < 0.25 x 2M); 16 ingested frames as vector queries through the
    engine each find themselves first, with exact f32 scores."""
    ann = engine.ann_stats()
    require(ann["rows"] == n0 and ann["fresh_rows"] == n
            and engine.metrics.counter("ivf_builds") == 1,
            f"[ivf] ingest: tier {ann}")
    index = engine.index
    pick = n0 + np.linspace(0, n - 1, 16).astype(np.int64)
    err = 0.0
    for row in pick:
        rows, _ = engine.search_by_vector_ex(index._emb[row], k=K,
                                             use_cache=False)
        ids = np.array([r["frame_id"] for r in rows])
        require(ids[0] == row, f"[ivf] self-query {row} -> {ids[0]}")
        q = index.normalize_query(index._emb[row])
        err = max(err, float(np.abs(np.array([r["score"] for r in rows])
                                    - index._emb[ids] @ q).max()))
        check_order([rows])
    require(err <= SCORE_ATOL, f"[ivf] self-query score error {err}")
    log(f"[ivf] ingest: {n} rows in the tier's fresh buffer over {n0} built "
        f"rows (no rebuild); 16 ingested frames as vector queries through "
        f"the engine each found themselves first, scores = exact f32 (max "
        f"error {err:.2e})")


def ivf_split(engine: VideoSearchEngine, rng, device) -> None:
    """Where one IVF search goes, for a single query and a batch of 64:
    each stage closed with a synchronise (the third of three repetitions
    counts)."""
    emb, index, tier = engine._get_embedder(), engine.index, engine._ivf
    for b in (1, 64):
        queries = [words(rng, 4) for _ in range(b)]
        for _ in range(3):
            t = {}

            def stage(name, fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn()
                torch.cuda.synchronize()
                t[name] = 1e3 * (time.perf_counter() - t0)
                return r

            q = stage("encode", lambda: emb.embed_texts(queries))
            qn = np.stack([index.normalize_query(r) for r in q])
            tl, qi = stage("host probe",
                           lambda: tier._probe_pairs(qn, tier.nprobe))
            ops = stage("upload", lambda: [torch.from_numpy(x).to(device)
                                           for x in (tl, qi, qn)])
            vals, idxs = stage("B12", lambda: ivf.probe_scan(
                tier._tiled, tier._row_ids_dev, *ops, k=K))
            v, i = stage("fetch", lambda: (vals.cpu().numpy(),
                                           idxs.cpu().numpy()))
            v, i = stage("host merge", lambda: ivf._merge_pairs(v, i, b, K))
            v, i = stage("fresh merge",
                         lambda: tier._merge_fresh(qn, v, i, K))
            stage("rows", lambda: index._rows_from(v, i))
        log(f"[ivf] IVF split, B={b} ({tl.size} pairs, ms): "
            + ", ".join(f"{k} {x:.3f}" for k, x in t.items())
            + f"; total {sum(t.values()):.3f}")


def check_served(dtype, embedder, corpus, name_of, served, device,
                 tag: str = "") -> None:
    """The served rows against the host exact top-K over the (grown)
    corpus, with the query vectors the port's encoders give (single: the
    module tower; batch: the fused tower); int4's scores against its rows'
    exact f32 scores, and the quantized tiers' recall@K against the exact
    scan."""
    tag = tag or dtype
    singles, single_rows, batch, batch_rows = served
    q_single, q_batch = served_vectors(embedder, singles, batch)
    if dtype == "bfloat16":
        err = check_exact(corpus, name_of, q_single, single_rows)
        sample = list(range(0, 64, 8))
        err = max(err, check_exact(corpus, name_of, q_batch[sample],
                                   [batch_rows[i] for i in sample]))
        log(f"[{tag}] e2e: all {len(singles)} singles and 8 sampled batch "
            f"queries match the host exact top-{K} (max score error "
            f"{err:.2e})")
        return
    qs = np.concatenate([q_single, q_batch])
    rows = single_rows + batch_rows
    if dtype == "int4":
        err = check_scores(corpus, qs, rows)
        log(f"[{tag}] e2e single + batch: every score equals its row's "
            f"exact f32 score (max error {err:.2e}), rows in order")
    else:
        err = check_exact(corpus, name_of, qs, rows)
        log(f"[{tag}] e2e single + batch: all {len(rows)} match the host "
            f"exact top-{K} (max score error {err:.2e})")
    if dtype in ("int8", "int4"):
        truth = evaluation.exact_topk_ids(corpus, qs, K, device)
        got = np.array([[r["frame_id"] for r in rr] for rr in rows])
        recall = evaluation.recall_at_k(truth, got)
        log(f"[{tag}] recall@{K} against the exact scan over "
            f"{len(rows)} queries: {recall:.4f}")
        if dtype == "int8":
            require(recall == 1.0, f"int8 recall@{K} {recall}")


# -- phase 7: the query and maintenance surface ------------------------------

# the kernels phase 7's routes launch on each engine: its scan (the
# vector, similar and text searches) and B3 (the text tower of
# /api/search/videos, /search, /api/search and the cache warm-up)
SURFACE_SCANS = {"bfloat16": "cand_scan_prefix", "float32": "block_scan",
                 "int8": "cand_scan_int8_prefix",
                 "mesh bfloat16": "cand_scan"}
SURFACE_QUERIES = 8
VIDEO_KEYS = {"video_name", "score", "frame_count", "best_timestamp"}
# two rows of one video whose f64 scores lie this close are a tie that
# f32 rounding may resolve either way (the best frame may then differ)
BEST_TIE = 1e-6


def request(base: str, method: str, path: str, body=None, headers=None):
    """``(status, headers, body bytes, seconds)`` of one request, whatever
    its status; a dict or list ``body`` goes as JSON."""
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
        headers = {"Content-Type": "application/json", **(headers or {})}
    req = urllib.request.Request(base + path, data=body, method=method,
                                 headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            out = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        out = e.code, e.headers, e.read()
    return (*out, time.perf_counter() - t0)


def call(base: str, method: str, path: str, body=None, headers=None,
         status: int = 200, times: dict = None):
    """One request that must answer ``status`` with the CORS headers;
    returns its JSON body (raw bytes for other content types); its time
    goes to ``times[path without the query]``."""
    st, hd, data, t = request(base, method, path, body, headers)
    require(st == status, f"{method} {path}: status {st}, not {status} "
            f"({data[:300]!r})")
    require(hd.get("Access-Control-Allow-Origin") == "*",
            f"{method} {path}: no CORS headers")
    if times is not None:
        times.setdefault(f"{method} {path.split('?')[0]}", []).append(t)
    if (hd.get("Content-Type") or "").startswith("application/json"):
        return json.loads(data)
    return data


def unit_means(corpus: np.ndarray, frames: int) -> np.ndarray:
    """The host reference's video means, from the corpus alone (video j:
    rows ``j * frames`` to ``(j + 1) * frames``, as the cache and the
    ingest lay them out): f64 sums of each video's f32 rows, f32 means,
    normalised."""
    sums = np.add.reduce(corpus.reshape(-1, frames, corpus.shape[1]),
                         axis=1, dtype=np.float64)
    means = (sums / frames).astype(np.float32)
    return means / np.maximum(np.linalg.norm(means, axis=-1, keepdims=True),
                              1e-10)


def check_video_rows(tag: str, corpus: np.ndarray, means: np.ndarray,
                     frames: int, name_of, timestamps: np.ndarray,
                     q: np.ndarray, rows: list, k: int) -> tuple:
    """Served ``/api/search/videos`` rows == the host exact ranking: stable
    order of the ``unit_means`` scores against the unit query; each
    winner's best frame = its lowest row with the highest f64 score (a
    served best frame within ``BEST_TIE`` of it is a tie, and counted).
    Returns (max score error, ties)."""
    qn = q / (np.linalg.norm(q) + 1e-10)
    scores = means @ qn
    order = np.argsort(-scores, kind="stable")[:k]
    require(len(rows) == len(order), f"[{tag}] {len(rows)} video rows, "
            f"not {len(order)}")
    worst, ties = 0.0, 0
    for r, v in zip(rows, order):
        own = np.arange(v * frames, (v + 1) * frames)
        require(set(r) == VIDEO_KEYS, f"[{tag}] video row keys {set(r)}")
        require(r["video_name"] == name_of(int(own[0]))
                and r["frame_count"] == frames,
                f"[{tag}] video {r['video_name']} != host "
                f"{name_of(int(own[0]))} ({frames} frames)")
        worst = max(worst, abs(r["score"] - float(scores[v])))
        s64 = corpus[own].astype(np.float64) @ qn.astype(np.float64)
        best = int(np.argmax(s64))
        if r["best_timestamp"] != float(timestamps[own[best]]):
            served = np.flatnonzero(timestamps[own] == r["best_timestamp"])
            require(len(served) == 1
                    and s64[best] - s64[served[0]] <= BEST_TIE,
                    f"[{tag}] {r['video_name']}: best frame at "
                    f"{r['best_timestamp']} s, host "
                    f"{timestamps[own[best]]} s")
            ties += 1
    require(worst <= SCORE_ATOL, f"[{tag}] video score error {worst}")
    return worst, ties


def top_rows(scores: np.ndarray, n: int) -> np.ndarray:
    """The top ``n`` rows of one query's scores: (score desc, row asc)."""
    top = np.argpartition(-scores, n)[:n]
    return top[np.lexsort((top, -scores[top]))]


def check_tops(tag: str, corpus: np.ndarray, name_of, queries: np.ndarray,
               rows_per_query, drop=None) -> float:
    """Served rows == the host exact top-K of each query (one pass over
    the corpus for all of them), ``drop[j]`` (the seed of a similar
    search) left out; returns the max score error."""
    qn = queries / (np.linalg.norm(queries, axis=1, keepdims=True) + 1e-10)
    scores = corpus @ qn.T
    worst = 0.0
    for j, rows in enumerate(rows_per_query):
        top = top_rows(scores[:, j], K + 1)
        top = [int(t) for t in top if drop is None or t != drop[j]][:K]
        got = [r["frame_id"] for r in rows]
        require(got == top, f"[{tag}] rows {got} != host exact top-{K} "
                f"{top}")
        require([r["video_name"] for r in rows] == [name_of(t) for t in top],
                f"[{tag}] video names")
        err = np.abs(np.array([r["score"] for r in rows])
                     - scores[top, j]).max()
        require(err <= SCORE_ATOL, f"[{tag}] score error {err}")
        worst = max(worst, float(err))
    return worst


def seed_row(corpus_frames: int, name_of, timestamps: np.ndarray,
             n_rows: int, name: str, t: float) -> int:
    """The host's seed of a similar search: the row of video ``name``
    (found by its first row's name) whose timestamp is nearest ``t``."""
    for lo in range(0, n_rows, corpus_frames):
        if name_of(lo) == name:
            own = np.arange(lo, lo + corpus_frames)
            return int(own[np.argmin(np.abs(timestamps[own] - t))])
    raise AssertionError(f"no rows of {name}")


def p50_ms(times: dict) -> dict:
    return {k: 1e3 * float(np.median(v)) for k, v in times.items()}


def time_video_ranking(index: DeviceVideoIndex, device) -> tuple:
    """The device ranking's CUDA-event time at k = K over the index's
    exact f32 rows, and the least time for the bytes it must read (the
    live f32 rows, the id column and the means, once)."""
    with index._sync_lock:
        rows = index._video_rank_rows()
        vid_ids, means, counts = index._sync_video_state_locked()
    q = torch.from_numpy(index.normalize_query(
        np.random.default_rng(3).standard_normal(index.dim)
        .astype(np.float32))).to(device)
    count = len(index)
    ms = cuda_ms(lambda: video_rank_device(rows, vid_ids, means, counts, q,
                                           count, K), 20)
    moved = count * index.dim * 4 + count * 4 + means.numel() * 4
    return ms, bound(moved, 2 * count * index.dim, "f32")["bound_ms"]


def phase_surface(tag: str, base: str, engine: VideoSearchEngine,
                  embedder: CLIPEmbedder, name_of, frames: int, rng, device,
                  full: bool) -> dict:
    """Phase 7 on a running engine behind the server at ``base``: 8
    ``/api/search/videos`` at k = K, 8 ``/api/search/similar`` seeds and 8
    ``/api/search/vector`` queries (``full``: then ``/search`` against
    ``/api/search``, the cache warm-up and a cached search, the video
    listings and the system routes), the launch counters and the device
    ranking's counter set to 0 just before and read just after; then the
    rows against the host's exact computations, the counters against the
    engine's path, and each route's host-clock p50."""
    index = engine.index
    corpus = index._emb[: len(index)]
    scan = SURFACE_SCANS[tag]
    device_ranking = index._video_rank_on_device()
    times: dict = {}
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    video_rank_device.launches = 0
    torch.cuda.synchronize()
    queries = [words(rng, 4) for _ in range(SURFACE_QUERIES)]
    video_rows = []
    for q in queries:
        body = call(base, "POST", "/api/search/videos",
                    {"query": q, "k": K}, times=times)
        require(set(body) == {"results", "search_time_ms", "query_id",
                              "performance"}, f"[{tag}] keys {set(body)}")
        video_rows.append(body["results"])
    seeds = [(name_of(int(v) * frames), float(t)) for v, t in zip(
        rng.integers(0, len(corpus) // frames, SURFACE_QUERIES),
        rng.uniform(0, 100, SURFACE_QUERIES))]
    similar = [call(base, "POST", "/api/search/similar",
                    {"video_name": n, "timestamp": t, "k": K,
                     "use_cache": False}, times=times)["results"]
               for n, t in seeds]
    vectors = rng.standard_normal((SURFACE_QUERIES, index.dim)).astype(
        np.float32)
    vector_rows = [call(base, "POST", "/api/search/vector",
                        {"vector": v.tolist(), "k": K, "use_cache": False},
                        times=times)["results"] for v in vectors]
    extra = surface_routes(tag, base, engine, rng, times) if full else None
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    ranked = video_rank_device.launches
    log(f"[{tag}] 7, launches during the surface routes: {launches}; "
        f"device video rankings {ranked}")
    for name, count in launches.items():
        if name in (scan, "attention"):
            require(count > 0, f"[{tag}] 7: kernel {name} not launched")
        else:
            require(count == 0, f"[{tag}] 7: {name} launched {count} times")
    require(ranked == (SURFACE_QUERIES if device_ranking else 0),
            f"[{tag}] 7: {ranked} device rankings, device path "
            f"{device_ranking}")
    for name in ("embed_fallbacks", "fused_search_fallbacks"):
        require(engine.metrics.counter(name) == 0, f"[{tag}] {name}")
    # the references (the port's text tower again: the same vectors)
    t0 = time.perf_counter()
    stamps = index._timestamps[: len(index)]
    means = unit_means(corpus, frames)
    worst, ties = 0.0, 0
    for q, rows in zip(queries, video_rows):
        err, tie = check_video_rows(tag, corpus, means, frames, name_of,
                                    stamps, embedder.embed_text(q), rows, K)
        worst, ties = max(worst, err), ties + tie
    seeds_rows = [seed_row(frames, name_of, stamps, len(index), n, t)
                  for n, t in seeds]
    qs = np.concatenate([corpus[seeds_rows], vectors] + (
        [np.stack([embedder.embed_text(q) for q in extra["queries"]])]
        if extra is not None else []))
    served = similar + vector_rows + (extra["rows"] if extra else [])
    drop = seeds_rows + [-1] * (len(served) - len(seeds_rows))
    err_top = check_tops(tag, corpus, name_of, qs, served, drop)
    log(f"[{tag}] 7: {SURFACE_QUERIES} /api/search/videos over "
        f"{len(index)} rows and {len(corpus) // frames} videos ("
        f"{'device' if device_ranking else 'host'} ranking) equal the host "
        f"exact ranking (max score error {worst:.2e}, {ties} best-frame "
        f"ties); {SURFACE_QUERIES} /similar (the seed left out), "
        f"{SURFACE_QUERIES} /vector"
        + (f" and {len(extra['rows'])} /api/search" if extra else "")
        + f" equal the host exact top-{K} (max score error {err_top:.2e}); "
        f"checked in {time.perf_counter() - t0:.1f} s")
    p50 = p50_ms(times)
    log(f"[{tag}] 7, host-clock p50 per route (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in p50.items()))
    out = {"p50_ms": p50, "launches": launches, "rankings": ranked}
    if device_ranking:
        out["ranking_ms"], out["ranking_bound_ms"] = time_video_ranking(
            index, device)
        log(f"[{tag}] 7, device video ranking (k = {K}): "
            f"{out['ranking_ms']:.4f} ms (CUDA events), bound "
            f"{out['ranking_bound_ms']:.4f} ms")
    return out


def surface_routes(tag: str, base: str, engine: VideoSearchEngine, rng,
                   times: dict) -> dict:
    """The rest of phase 7 on the bf16 engine: ``/search`` against
    ``/api/search``, ``/api/cache/warm`` then a cached search, the video
    listings, and the system routes. Returns the text queries and rows
    for the host check."""
    index = engine.index
    queries, rows = [words(rng, 4) for _ in range(4)], []
    for q in queries:
        legacy = call(base, "POST", "/search", {"query": q, "k": K,
                                                "use_cache": False},
                      times=times)
        api = call(base, "POST", "/api/search", {"query": q, "k": K,
                                                 "use_cache": False},
                   times=times)
        require(legacy["success"] and legacy["query"] == q, "/search body")
        require([(r["frame_id"], r["score"]) for r in legacy["results"]]
                == [(r["frame_id"], r["score"]) for r in api["results"]],
                f"[{tag}] /search and /api/search disagree")
        rows.append(api["results"])
    warm = [words(rng, 3) for _ in range(3)]
    body = call(base, "POST", "/api/cache/warm", {"queries": warm, "k": K},
                times=times)
    require(body == {"success": True, "warmed": 3}, f"warm {body}")
    for q in warm:
        body = call(base, "POST", "/api/search", {"query": q, "k": K},
                    times=times)
        require(body["from_cache"] is True and len(body["results"]) == K,
                f"[{tag}] a warmed query was not answered from the cache")
    counts = index.video_frame_counts()
    names = list(counts)
    offset = len(names) - 520
    body = call(base, "GET", f"/api/videos?limit=1000&offset={offset}",
                times=times)
    require(body["count"] == 520 and [v["filename"] for v in body["videos"]]
            == names[offset:] and body["limit"] == 1000
            and body["offset"] == offset, f"[{tag}] /api/videos page")
    body = call(base, "GET", "/api/videos?limit=1000", times=times)
    require(body["count"] == 1000 and all(
        v["frame_count"] == counts[v["filename"]] for v in body["videos"]),
        f"[{tag}] /api/videos first page")
    call(base, "GET", "/api/videos?limit=1001", status=400)
    body = call(base, "GET", "/api/videos/video_00042", times=times)
    require(body == {"video_id": "video_00042",
                     "filename": "video_00042.mp4", "exists": False,
                     "frame_count": counts["video_00042.mp4"]},
            f"/api/videos/video_00042: {body}")
    call(base, "GET", "/api/videos/no_such_video", status=404)
    body = call(base, "GET", "/videos", times=times)
    require([v["name"] for v in body["videos"]] == index.video_names(),
            "/videos")
    body = call(base, "GET", "/api", times=times)
    require(body["version"] == "2.1.0", "/api")
    text = call(base, "GET", "/metrics", times=times).decode()
    require("video_search_video_search_latency_ms_count "
            f"{SURFACE_QUERIES}" in text, "/metrics")
    body = call(base, "GET", "/api/metrics", times=times)
    require(body["histograms"]["video_search_latency_ms"]["count"]
            == SURFACE_QUERIES, "/api/metrics")
    body = call(base, "GET", "/api/config", times=times)
    require(body["success"] and body["config"]
            == engine.config.api.to_dict(), "/api/config")
    log(f"[{tag}] 7: /search == /api/search on {len(queries)} queries; "
        f"3 warmed queries answered from the cache; /api/videos pages "
        f"(limit 1000, offset {offset}: 520 videos), /api/videos/{{id}}, "
        "/videos, /api, /metrics, /api/metrics, /api/config: as the "
        "reference shapes them")
    return {"queries": queries, "rows": rows}


def phase_maintenance(embedder: CLIPEmbedder, args, device,
                      scratch: Path) -> dict:
    """Phase 7's maintenance routes on a small bf16 engine of its own: 20
    seeded videos x 200 frames ingested at startup (the decode stage
    replaced by ``seeded_extract``, as phase 4's ingest), then over HTTP:
    index save and load, cache export and import, a video delete (its rows
    never come back), config set and reset, cache stats and health, cache
    rebuild (the host rows bit for bit the first ingest's; B5/B6 counted)
    and last cache clear."""
    real = seeded_decode(args)
    times: dict = {}
    try:
        with tempfile.TemporaryDirectory(dir=scratch) as videos:
            vdir = Path(videos)
            for v in range(INGEST_VIDEOS):
                (vdir / ingest_name(v)).write_bytes(b"seeded frames")
            engine = VideoSearchEngine(vdir, config=EngineConfig(),
                                       embedder=embedder, device=device)
            engine.startup()
            require_seeded("maintenance", engine)
            index, n = engine.index, INGEST_VIDEOS * args.frames
            require(len(index) == n, f"maintenance startup rows "
                    f"{len(index)}")
            first = index._emb[:n].copy()
            meta = index.to_cache_dict()["metadata"]
            server = create_server(engine, "127.0.0.1", 0,
                                   config_path=vdir / "config.json")
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            base = f"http://127.0.0.1:{server.server_address[1]}"
            try:
                maintenance_routes(base, engine, vdir, first, meta, times)
                rebuild = maintenance_rebuild(base, engine, first, meta,
                                              times)
                with timed("8, upload on the maintenance engine"):
                    upload = maintenance_upload(base, engine, vdir, args,
                                                device, times)
                body = call(base, "POST", "/api/cache/clear", times=times)
                require(body["success"] and body["stats"][
                    "embeddings_count"] == 0 and len(index) == 0
                    and not engine.cache_path.exists(), f"clear {body}")
            finally:
                server.shutdown()
                server.server_close()
                thread.join(30)
                engine.close()
    finally:
        engine_system.batched_frames = real
    p50 = p50_ms(times)
    log("[maintenance] 7, host-clock p50 per route (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in p50.items()))
    return {"p50_ms": p50, **rebuild, "upload": upload}


def seeded_decode(args):
    """Patch ``engine/system.py:batched_frames`` so that every ingest of
    the engine decodes through ``seeded_extract`` (the engine passes its
    own ``extract_fn``, None under the interval rule); returns the real
    function, to be put back."""
    extract = functools.partial(seeded_extract, seed=args.seed,
                                n=args.frames,
                                mode=EngineConfig().api.sampling_mode)
    real = engine_system.batched_frames

    def seeded(*a, **kw):
        return real(*a, **{**kw, "extract_fn": extract})

    engine_system.batched_frames = seeded
    return real


def maintenance_routes(base: str, engine: VideoSearchEngine, vdir: Path,
                       first: np.ndarray, meta: list, times: dict) -> None:
    index, n = engine.index, len(first)
    probe = first[3 * (n // INGEST_VIDEOS) + 17]
    before = call(base, "POST", "/api/search/vector",
                  {"vector": probe.tolist(), "k": K, "use_cache": False})
    body = call(base, "POST", "/api/index/save?filepath=snapshot.pkl",
                times=times)
    require(body == {"status": "saved", "filepath": "snapshot.pkl"}
            and (vdir / "snapshot.pkl").exists(), f"save {body}")
    call(base, "POST", "/api/index/save?filepath=/etc/x.pkl", status=403)
    body = call(base, "POST", "/api/index/load?filepath=snapshot.pkl",
                times=times)
    require(body["status"] == "loaded" and np.array_equal(
        index._emb[:n], first) and index.to_cache_dict()["metadata"] == meta,
        "index load: rows or metadata changed")
    after = call(base, "POST", "/api/search/vector",
                 {"vector": probe.tolist(), "k": K, "use_cache": False})
    require(after["results"] == before["results"], "rows after load")
    data = call(base, "GET", "/api/cache/export", times=times)
    require(data == engine.cache_path.read_bytes(), "export bytes")
    body, headers = multipart_fields([("file", "export.pkl", data)])
    body = call(base, "POST", "/api/cache/import", body, headers,
                times=times)
    require(body["success"] and body["stats"]["embeddings_count"] == n
            and len(index) == n, f"import {body}")
    gone = ingest_name(3)
    body = call(base, "DELETE", f"/api/videos/{gone[:-4]}", times=times)
    require(body == {"status": "deleted", "video_id": gone[:-4],
                     "filename": gone}, f"delete {body}")
    require(gone not in index.video_names()
            and len(index) == n - n // INGEST_VIDEOS, "delete rows")
    rows = call(base, "POST", "/api/search/vector",
                {"vector": probe.tolist(), "k": K,
                 "use_cache": False})["results"]
    videos = call(base, "POST", "/api/search/videos",
                  {"query": "seeded frames", "k": INGEST_VIDEOS})["results"]
    require(rows and gone not in {r["video_name"] for r in rows + videos}
            and len(videos) == INGEST_VIDEOS - 1,
            "a deleted video's rows came back")
    (vdir / gone).write_bytes(b"seeded frames")     # for the rebuild
    body = call(base, "POST", "/api/config",
                {"max_frames": 150, "sampling_mode": "medium"}, times=times)
    written = json.loads((vdir / "config.json").read_text())
    require(body["success"] and written["max_frames"] == 150
            and engine.config.api.sampling_mode == "medium", "config set")
    call(base, "POST", "/api/config", {"max_frames": 0}, status=422)
    body = call(base, "POST", "/api/config/reset", times=times)
    require(body["success"] and json.loads((vdir / "config.json")
                                           .read_text())
            == EngineConfig().api.to_dict(), "config reset")
    body = call(base, "GET", "/api/cache/stats", times=times)
    require(body["success"] and body["embeddings"] == len(index)
            and body["videos"] == INGEST_VIDEOS - 1, f"stats {body}")
    body = call(base, "GET", "/api/cache/health", times=times)
    require(body["success"] and body["passed_checks"] == 5,
            f"health {body}")
    log(f"[maintenance] 7: index save/load (rows and metadata unchanged, "
        f"403 outside the videos dir), cache export ({len(data)} bytes = "
        "the cache file) and import, delete of "
        f"{gone} (its rows never come back), config set/refused/reset "
        "(config.json written), cache stats and health: as the reference")


def maintenance_rebuild(base: str, engine: VideoSearchEngine,
                        first: np.ndarray, meta: list, times: dict) -> dict:
    index, n = engine.index, len(first)
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    body = call(base, "POST", "/api/cache/rebuild", times=times)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    require(body["success"] and body["stats"]["embeddings_count"] == n,
            f"rebuild {body}")
    require(np.array_equal(index._emb[:n], first)
            and index.to_cache_dict()["metadata"] == meta,
            "rebuild: host rows differ from the first ingest's")
    layers = engine._get_embedder().cfg.vision.num_layers
    batches = -(-n // engine.config.ingest.batch_size)
    for name, count in launches.items():
        want = layers * batches if name in INGEST else 0
        require(count == want, f"rebuild: {name} launched {count} times, "
                f"not {want}")
    log(f"[maintenance] 7: cache rebuild re-ingested {n} rows, bit for bit "
        f"the first ingest's; launches {launches}")
    return {"rebuild_launches": launches}


# -- phase 8: upload, keyword engine, frame memo, profiler, docs and UI -------

UPLOAD_BYTES = 64 << 20     # the upload's file part
UPLOAD_CAP = 1 << 20        # the lowered MAX_FILE_SIZE of the 413 check
MEMO_SIZE = 4096            # >= the memo engine's 4,000 frames
KEYWORD_QUERIES = ("bright", "a dog", "dark street", "new phone app",
                   "red car", "football goal", "vehicle at night",
                   "bright car phone")
# the kernels each profiled path must show in the trace, by name
TRACE_KERNELS = {"B1 cand_scan_prefix": ("cand_kernel",),
                 "B2 fused text layer": ("gemm_wgmma", "ln_bf16"),
                 "B3 attention": ("attn_bf16",)}


def multipart_fields(fields) -> tuple:
    """A ``multipart/form-data`` body of ``(name, filename or None, bytes)``
    parts, and its content type header."""
    boundary = f"vqt-{os.getpid()}-{time.monotonic_ns()}"
    out = []
    for name, filename, data in fields:
        disp = f'form-data; name="{name}"'
        if filename is not None:
            disp += f'; filename="{filename}"'
        out.append(f"--{boundary}\r\nContent-Disposition: {disp}\r\n"
                   "Content-Type: application/octet-stream\r\n\r\n"
                   .encode())
        out.append(data)
        out.append(b"\r\n")
    out.append(f"--{boundary}--\r\n".encode())
    return b"".join(out), {"Content-Type":
                           f"multipart/form-data; boundary={boundary}"}


def follow_progress(base: str, upload_id: str, box: list) -> None:
    """Read the upload's server-sent events into ``box`` as ``(seconds,
    event, data)``, the time taken as each event arrives."""
    req = urllib.request.Request(
        f"{base}/api/videos/upload/progress/{upload_id}/stream")
    with urllib.request.urlopen(req, timeout=900) as r:
        event = None
        for raw in r:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: "):
                box.append((time.perf_counter(), event,
                            json.loads(line[6:])))


def upload_video(base: str, video_id: str, filename: str,
                 upload_id: str) -> dict:
    """POST ``UPLOAD_BYTES`` bytes as ``filename`` with ``?upload_id=``,
    the SSE stream opened first; returns the answer, the events, the
    progress record and, for each phase the events showed, the seconds
    from the POST's start to its first event (the stream polls the record
    every 0.15 s, so a shorter phase may not show)."""
    body, headers = multipart_fields([("video_id", None, video_id.encode()),
                                      ("file", filename,
                                       bytes(UPLOAD_BYTES))])
    events: list = []
    reader = threading.Thread(target=follow_progress,
                              args=(base, upload_id, events), daemon=True)
    reader.start()
    time.sleep(0.2)
    t0 = time.perf_counter()
    st, hd, data, wall = request(base, "POST",
                                 f"/api/videos/upload?upload_id={upload_id}",
                                 body, headers)
    reader.join(60)
    require(not reader.is_alive(), "the SSE stream did not end")
    record = call(base, "GET", f"/api/videos/upload/progress/{upload_id}")
    phases = {}
    for t, _, d in events:
        phases.setdefault(d["phase"], t - t0)
    return {"status": st, "headers": hd, "body": json.loads(data),
            "wall": wall, "events": events, "record": record,
            "phases_s": phases, "body_bytes": len(body)}


def check_upload(tag: str, up: dict, frames: int, size: int) -> None:
    """The answer, the record and the SSE events of a finished upload."""
    body, rec = up["body"], up["record"]
    require(up["status"] == 200 and body["status"] == "success"
            and body["frames_indexed"] == frames, f"[{tag}] upload {body}")
    require(up["headers"].get("Access-Control-Allow-Origin") == "*",
            f"[{tag}] upload: no CORS headers")
    require(rec["phase"] == "done" and rec["done"]
            and rec["bytes_received"] == size
            and rec["total_bytes"] == up["body_bytes"]
            and rec["frames_indexed"] == frames, f"[{tag}] record {rec}")
    kinds = {e for _, e, _ in up["events"]}
    require(kinds == {"progress"} and up["events"][-1][2]["phase"] == "done",
            f"[{tag}] SSE events "
            f"{[(e, d['phase']) for _, e, d in up['events']]}")


def maintenance_upload(base: str, engine: VideoSearchEngine, vdir: Path,
                       args, device, times: dict) -> dict:
    """Phase 8 on the maintenance engine: a 64 MB upload over HTTP with
    its SSE stream (the frames from ``seeded_extract``), the launches
    counted around it (B5 and B6 once per layer and embed batch, nothing
    else), the mirror bit for bit, an uploaded frame found first by its
    own row, a lowered cap's 413 leaving no file, and the video deleted."""
    index = engine.index
    n0 = len(index)
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    up = upload_video(base, "ingest", f"{INGEST_VIDEOS:02d}.mp4", "smoke-up")
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    name = ingest_name(INGEST_VIDEOS)
    check_upload("upload", up, args.frames, UPLOAD_BYTES)
    require(len(index) == n0 + args.frames and (vdir / name).exists(),
            "upload rows or file")
    layers = engine._tower().cfg.vision.num_layers
    batches = -(-args.frames // engine.config.ingest.batch_size)
    for kname, count in launches.items():
        want = layers * batches if kname in INGEST else 0
        require(count == want, f"upload: {kname} launched {count} times, "
                f"not {want}")
    check_mirror(index, "bfloat16", device, "upload")
    for j in (0, args.frames // 2, args.frames - 1):
        rows = call(base, "POST", "/api/search/vector",
                    {"vector": index._emb[n0 + j].tolist(), "k": K,
                     "use_cache": False}, times=times)["results"]
        require(rows[0]["frame_id"] == n0 + j and rows[0]["video_name"]
                == name, f"uploaded frame {n0 + j}: first {rows[0]}")
    real_cap = api_routes.MAX_FILE_SIZE
    api_routes.MAX_FILE_SIZE = UPLOAD_CAP
    try:
        big = upload_video(base, "ingest", f"{INGEST_VIDEOS + 1:02d}.mp4",
                           "smoke-big")
    finally:
        api_routes.MAX_FILE_SIZE = real_cap
    require(big["status"] == 413 and big["body"] == {
        "detail": "File too large (max 1GB)"}
        and "Access-Control-Allow-Origin" not in big["headers"],
        f"413 {big['status']} {big['body']}")
    require(big["record"]["phase"] == "error"
            and big["events"][-1][2]["phase"] == "error", "413 record")
    require(not list(vdir.glob(".upload_*"))
            and not (vdir / ingest_name(INGEST_VIDEOS + 1)).exists()
            and len(index) == n0 + args.frames, "413 left a file or rows")
    body = call(base, "DELETE", f"/api/videos/{name[:-4]}", times=times)
    require(body["status"] == "deleted" and len(index) == n0
            and not (vdir / name).exists(), f"delete upload {body}")
    log(f"[maintenance] 8: upload of {UPLOAD_BYTES} bytes (+ the SSE "
        f"stream): 200 in {up['wall']:.3f} s, {args.frames} frames, phases "
        f"first seen {fmt_s(up['phases_s'])}; launches {launches}; the "
        "mirror bit for bit; 3 uploaded frames found first by their rows; "
        f"413 past a {UPLOAD_CAP}-byte cap in {big['wall']:.3f} s with no "
        "file left; the video deleted")
    return {"launches": launches, "wall_s": up["wall"],
            "phases_s": up["phases_s"]}


def fmt_s(phases: dict) -> str:
    return ", ".join(f"{k} at {v:.3f} s" for k, v in phases.items())


def keyword_searches(base: str, engine: VideoSearchEngine, corpus,
                     name_of, rng) -> dict:
    """16 keyword and unknown queries one at a time over HTTP on the
    ``use_clip = false`` engine: the rows equal the host exact top-K of
    the keyword encoder's vectors (the encoder's draws followed in
    order); B1 once per search, no tower kernel, no fallback."""
    queries = []
    for q in KEYWORD_QUERIES:
        queries += [q, words(rng, 3)]
    encoder = KeywordQueryEncoder(dim=engine.index.dim)
    vectors = np.stack([encoder.embed_text(q) for q in queries])
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    rows, lat = [], []
    for q in queries:
        status, body, t = http(base, "POST", "/api/search",
                               {"query": q, "k": K, "use_cache": False})
        check_search_response(status, body, K)
        rows.append(body["results"])
        lat.append(t)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    for name, count in launches.items():
        want = len(queries) if name == "cand_scan_prefix" else 0
        require(count == want, f"keyword: {name} launched {count} times, "
                f"not {want}")
    require(engine.metrics.counter("embed_fallbacks") == 0,
            "keyword: embed_fallbacks")
    err = check_exact(corpus, name_of, vectors, rows)
    stats = call(base, "GET", "/api/stats")
    require(stats["feature_extraction"] == {"processor_type": "Visual"},
            f"keyword stats {stats['feature_extraction']}")
    p50 = 1e3 * float(np.median(lat))
    log(f"[keyword] 8: {len(queries)} keyword and unknown queries over "
        f"{len(corpus)} rows, one at a time: each the host exact top-{K} of "
        f"the encoder's vector (max score error {err:.2e}); launches "
        f"{launches}; embed_fallbacks 0; processor_type Visual; host-clock "
        f"p50 {p50:.2f} ms")
    return {"launches": launches, "p50_ms": p50}


def profile_round(base: str, rng) -> None:
    """8 single queries, a batch of 64 and 64 coalesced clients."""
    for _ in range(8):
        status, body, _ = http(base, "POST", "/api/search",
                               {"query": words(rng, 4), "k": K,
                                "use_cache": False})
        check_search_response(status, body, K)
    status, body, _ = http(base, "POST", "/api/search/batch",
                           {"queries": [words(rng, 5) for _ in range(64)],
                            "k": K})
    require(status == 200 and body["query_count"] == 64, "batch")
    concurrent_phase(base, "[profiled] 64 coalesced clients",
                     [words(rng, 4) for _ in range(64)], K)


def read_trace(path: Path) -> dict:
    """The device kernels of a Chrome trace, by name (count, total us),
    and the share of the traced window in which the device was busy
    (the union of its kernel, copy and set intervals)."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    require(spans, f"trace {path} holds no complete events")
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in spans
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, lo
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels: dict = {}
    for e in spans:
        if e.get("cat") == "kernel":
            c = kernels.setdefault(e["name"], [0, 0.0])
            c[0] += 1
            c[1] += float(e["dur"])
    return {"kernels": kernels, "busy": busy / (hi - lo),
            "window_ms": (hi - lo) / 1e3, "events": len(spans)}


def profile_engine(base: str, trace_dir: Path, rng, smi: str) -> dict:
    """The profiler route around one round of searches (after an untraced
    one): the trace names B1, B2 and B3, whose counters also moved; the
    ten device kernels that took the most time and the device-busy
    share of the traced window are printed."""
    profile_round(base, rng)                 # first-call costs untraced
    body = call(base, "POST", "/api/profiler/start",
                {"trace_dir": str(trace_dir)})
    require(body == {"success": True, "trace_dir": str(trace_dir)},
            f"profiler start {body}")
    st = request(base, "POST", "/api/profiler/start",
                 {"trace_dir": str(trace_dir)})[0]
    require(st == 409, f"a second profiler start answered {st}")
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    profile_round(base, rng)
    torch.cuda.synchronize()
    traced = time.perf_counter() - t0
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    body = call(base, "POST", "/api/profiler/stop")
    require(body["success"], f"profiler stop {body}")
    st = request(base, "POST", "/api/profiler/stop")[0]
    require(st == 409, f"a second profiler stop answered {st}")
    traces = sorted(trace_dir.glob("vqt_trace_*.json"))
    require(len(traces) == 1, f"traces {traces}")
    tr = read_trace(traces[0])
    names = list(tr["kernels"])
    for what, parts in TRACE_KERNELS.items():
        for part in parts:
            require(any(part in n for n in names),
                    f"the trace names no {part} kernel ({what})")
    for name in ("cand_scan_prefix", "fused_layer", "attention"):
        require(launches[name] > 0, f"profiled: {name} not launched")
    top = sorted(tr["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    log(f"[profiler] 8 ({smi}): a trace of 8 singles, a batch of 64 and 64 "
        f"coalesced clients ({traced:.3f} s of host clock; trace window "
        f"{tr['window_ms']:.1f} ms, {tr['events']} events, "
        f"{traces[0].stat().st_size} bytes): device busy "
        f"{100 * tr['busy']:.2f}% of the window; the kernels of B1, B2 and "
        f"B3 named; launches {launches}")
    for name, (count, us) in top:
        log(f"[profiler]   {us / 1e3:9.3f} ms  {count:5d} x  {name[:110]}")
    return {"busy_share": tr["busy"], "window_ms": tr["window_ms"],
            "launches": launches,
            "top10": [[n[:110], c, us / 1e3] for n, (c, us) in top]}


def check_docs_and_ui(base: str) -> None:
    spec = call(base, "GET", "/api/openapi.json")
    require(spec["openapi"] == "3.1.0" and "/api/videos/upload"
            in spec["paths"], "openapi.json")
    for path in ("/api/docs", "/", "/static/index.html"):
        data = call(base, "GET", path)
        require(len(data) > 0, f"{path} empty")
    log("[2m] 8: /api/openapi.json, /api/docs, / and /static/index.html "
        "answer 200")


def phase_big_engine(engine: VideoSearchEngine, videos: str, args, rng,
                     device, scratch: Path, smi: str) -> dict:
    """Phase 8 on phase 4's bf16 engine (2,000,000 cached rows and its
    4,000 ingested ones), behind a server of its own: ``POST /api/config``
    turns ``use_clip`` off (the keyword encoder: no tower) for 16 keyword
    and unknown queries, and on again; then the profiler route traces a
    round of searches; then the docs and UI routes. (A 64 MB upload onto
    these 2M rows is left out for time: ~190-220 s, nearly all of it the
    save rewriting the whole pickle; the upload route runs on phase 7's
    4,000-row engine.)"""
    n = len(engine.index)
    n_base = args.videos * args.frames
    corpus = engine.index._emb[:n]

    def name_of(row: int) -> str:
        if row < n_base:
            return video_name(row // args.frames)
        return ingest_name((row - n_base) // args.frames)

    server = create_server(engine, "127.0.0.1", 0,
                           config_path=Path(videos) / "config.json")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out = {}
    try:
        body = call(base, "POST", "/api/config", {"use_clip": False})
        require(body["config"]["use_clip"] is False and not engine.use_clip
                and engine._get_embedder() is None, "use_clip off")
        out["keyword"] = keyword_searches(base, engine, corpus, name_of, rng)
        body = call(base, "POST", "/api/config", {"use_clip": True})
        require(body["config"]["use_clip"] is True and engine.use_clip,
                "use_clip back on")
        out["profiler"] = profile_engine(base, scratch / "trace", rng, smi)
        check_docs_and_ui(base)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        engine.close()
    del server, corpus
    return out


def phase_memo(args, device, scratch: Path) -> dict:
    """Phase 8's frame memo: a bf16 engine with ``ingest.stream_mirror =
    false`` and ``cache.frame_memo_size = 4096`` builds its own tower and
    wraps it; over HTTP two ``/api/cache/rebuild``s of the 20 seeded
    videos: the first embeds all 4,000 frames (misses; B5 and B6 once per
    layer and embed batch), the second none (4,000 hits, no kernel
    launched) and gives the first's rows bit for bit."""
    real = seeded_decode(args)
    try:
        with tempfile.TemporaryDirectory(dir=scratch) as videos:
            vdir = Path(videos)
            config = EngineConfig()
            config.ingest.stream_mirror = False
            config.cache.frame_memo_size = MEMO_SIZE
            engine = VideoSearchEngine(vdir, config=config, device=device)
            engine.startup()
            memo = engine._get_embedder()
            require(isinstance(memo, MemoizedEmbedder)
                    and memo.max_size == MEMO_SIZE, f"memo {memo!r}")
            require_seeded("memo", engine)
            for v in range(INGEST_VIDEOS):
                (vdir / ingest_name(v)).write_bytes(b"seeded frames")
            server = create_server(engine, "127.0.0.1", 0,
                                   config_path=vdir / "config.json")
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            base = f"http://127.0.0.1:{server.server_address[1]}"
            n = INGEST_VIDEOS * args.frames
            layers = engine._tower().cfg.vision.num_layers
            batches = -(-n // config.ingest.batch_size)
            runs = []
            try:
                for want_embeds in (True, False):
                    hits, misses = memo.hits, memo.misses
                    for wrapper in WRAPPERS.values():
                        wrapper.launches = 0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    body = call(base, "POST", "/api/cache/rebuild")
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    launches = {k: w.launches for k, w in WRAPPERS.items()}
                    require(body["success"] and len(engine.index) == n,
                            f"memo rebuild {body}")
                    for kname, count in launches.items():
                        want = (layers * batches
                                if want_embeds and kname in INGEST else 0)
                        require(count == want, f"memo rebuild: {kname} "
                                f"launched {count} times, not {want}")
                    got = (memo.hits - hits, memo.misses - misses)
                    require(got == ((0, n) if want_embeds else (n, 0)),
                            f"memo hits, misses {got}")
                    runs.append({"launches": launches, "wall_s": wall,
                                 "hits": got[0], "misses": got[1],
                                 "rows": engine.index._emb[:n].copy()})
            finally:
                server.shutdown()
                server.server_close()
                thread.join(30)
                engine.close()
            require(np.array_equal(runs[0]["rows"], runs[1]["rows"]),
                    "memo: the second rebuild's rows differ")
    finally:
        engine_system.batched_frames = real
    log(f"[memo] 8: rebuild 1 embedded {n} frames in {runs[0]['wall_s']:.3f}"
        f" s (misses {runs[0]['misses']}; launches {runs[0]['launches']}); "
        f"rebuild 2 in {runs[1]['wall_s']:.3f} s: {runs[1]['hits']} hits, "
        "no kernel launched, rows bit for bit the first's")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {k: [{kk: vv for kk, vv in r.items() if kk != "rows"}
                for r in runs] for k in ("rebuilds",)}


# -- phase 6: the SigLIP engine -----------------------------------------------

def corpus_on_card_rows(dev, seed: int, n_rows: int,
                        dim: int = SIGLIP_DIM) -> np.ndarray:
    """A seeded corpus of ``n_rows`` unit rows x ``dim`` (the SigLIP
    engine's: 768), drawn on the card (numpy's generator is the slow part
    of phase 4's corpus) and fetched once."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn(n_rows, dim, generator=g, device=dev)
    rows /= torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    out = rows.cpu().numpy()
    del rows
    torch.cuda.empty_cache()
    return out


def check_tower_launches(engine: VideoSearchEngine, launches: dict,
                         tag: str = "siglip", path: tuple = SIGLIP_PATH
                         ) -> int:
    """The search path of the SigLIP (or, with ``path`` AIMV2_PATH, the
    AIMv2) engine launched B1 once a search dispatch, and per dispatch
    the text tower once: the module tower (one B3 launch a layer) or the
    fused encode (one launch of each half a layer, ``path[2:]``), at
    least once each; no other kernel; both fallback counters 0. Returns
    the fused flushes."""
    log(f"[{tag}] launches during the path: {launches}")
    layers = engine._get_embedder().cfg.text.num_layers
    b1, b3, b5, b6 = (launches[name] for name in path)
    for name, count in launches.items():
        if name not in path:
            require(count == 0, f"[{tag}] {name} launched {count} times")
    require(b3 > 0 and b3 % layers == 0, f"[{tag}] B3 launches {b3}")
    require(b5 > 0 and b5 == b6 and b5 % layers == 0,
            f"[{tag}] B5/B6 launches {b5}/{b6}")
    require(b1 == b3 // layers + b5 // layers,
            f"[{tag}] B1 launches {b1} != one a search dispatch "
            f"({b3 // layers} module-tower + {b5 // layers} fused)")
    for name in ("embed_fallbacks", "fused_search_fallbacks"):
        count = engine.metrics.counter(name)
        require(count == 0, f"[{tag}] {name} = {count}")
    log(f"[{tag}] {b5 // layers} fused flushes x {layers} {path[2]} + "
        f"{layers} {path[3]}, {b3 // layers} module-tower encodes x "
        f"{layers} B3, {b1} B1 scans (one a search dispatch); fallback "
        "counters: embed_fallbacks 0, fused_search_fallbacks 0")
    return b5 // layers


def phase_siglip_engine(embedder: SigLIPEmbedder, args, device,
                        smi: str) -> tuple:
    """``model.family = "siglip"`` at full width, bf16 tier:
    ``engine.startup()`` over an empty videos dir, a seeded corpus of
    ``args.videos`` x ``args.frames`` rows x 768 drawn on the card and
    appended video by video (as phase 9's corpora: no pickle written and
    loaded), an ingest of INGEST_VIDEOS seeded videos through the decode
    pipeline and the module vision tower (mirror checked bit for bit),
    then the HTTP server: 16 singles, 64 coalesced clients and a batch of
    64, rows held against the host exact top-K over the grown f32 corpus.
    Returns the search path's and the ingest's launches."""
    n = args.videos * args.frames
    scratch = ROOT / "build" / "smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed + 2)
    timings = {}
    with tempfile.TemporaryDirectory(dir=scratch) as videos:
        config = EngineConfig()
        config.model.family = "siglip"
        config.index.device_dtype = "bfloat16"
        engine = VideoSearchEngine(videos, config=config, embedder=embedder,
                                   device=device)
        require(config.index.embed_dim == SIGLIP_DIM,
                f"[siglip] index.embed_dim {config.index.embed_dim}")
        engine.startup()
        require_seeded("siglip", engine)
        t0 = time.perf_counter()
        corpus = corpus_on_card_rows(device, args.seed + 7, n)
        engine.index.reserve(n)
        stamps = [0.5 * t for t in range(args.frames)]
        for v in range(args.videos):
            engine.index.add_batch(
                corpus[v * args.frames:(v + 1) * args.frames],
                video_name(v), stamps)
        del corpus
        engine.index.sync_mirror()
        require(len(engine.index) == n, "[siglip] corpus row count")
        mode = engine.accuracy_mode()
        require(mode == "exact-f32-rerank", f"[siglip] mode {mode}")
        log(f"[siglip] corpus: {n} rows x {engine.index.dim} from seed "
            f"{args.seed + 7} drawn on the card, appended and placed (bf16 "
            f"mirror + re-rank store) in {time.perf_counter() - t0:.1f} s "
            f"({mode})")
        ingested = ingest_tier(engine, "bfloat16", videos, args, device,
                               tag="siglip", path=("attention",))
        corpus = engine.index._emb[: len(engine.index)]

        def name_of(row: int) -> str:
            if row < n:
                return video_name(row // args.frames)
            return ingest_name((row - n) // args.frames)

        server = create_server(engine, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            for wrapper in WRAPPERS.values():
                wrapper.launches = 0
            served = drive(base, "siglip", rng, timings)
            launches = {name: w.launches for name, w in WRAPPERS.items()}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(30)
            engine.close()
        check_tower_launches(engine, launches)
        check_served("siglip", embedder, corpus, name_of, served, device)
        del engine, server, corpus
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[siglip] on {smi}: single p50 {timings['single_p50_ms']:.2f} ms, "
        f"batch of 64 {timings['batch_ms']:.2f} ms, ingest "
        f"{ingested['frames_s']:.1f} frames/s")
    return launches, ingested


# -- phases 3 and 6: AIMv2 ----------------------------------------------------

def compare_aimv2_halves(embedder: AIMv2Embedder, seed: int,
                         b: int = 256) -> tuple:
    """B5 with RMSNorm and bias-free projections and B6 with the
    SiLU-gated epilogue against their plain versions on one block of the
    seeded AIMv2 vision tower, bf16, at an ingest batch of ``b`` frames
    (N(0, 1) activations; within two bf16 ulps of the plain output's
    largest magnitude), with cuBLAS's two bare GEMMs of each half as the
    GEMM core's yardstick."""
    c = embedder.cfg.vision
    ops = embedder._layer_ops(embedder.params, "vision")[0]
    d, f, s = c.hidden_size, c.intermediate_size, c.seq_len
    t = b * s
    g = torch.Generator(device=embedder.device).manual_seed(seed + 17)
    x = torch.randn(t, d, generator=g, device=embedder.device).bfloat16()
    kw = {"s": s, "heads": c.num_heads, "eps": c.rms_norm_eps,
          "causal": False}
    # x read and out written, the half's matrices read (bf16) and its
    # RMSNorm scale (f32); B5's QKV and out-proj GEMMs plus QK^T and PV,
    # B6's gate, up and down GEMMs
    b5 = bound(2 * 2 * t * d + 2 * 4 * d * d + 4 * d,
               8 * t * d * d + 4 * t * s * d, "bf16")
    b6 = bound(2 * 2 * t * d + 2 * 3 * d * f + 4 * d, 6 * t * d * f, "bf16")
    with torch.inference_mode():
        h = torch.randn(t, f, generator=g, device=embedder.device).bfloat16()
        rms, wqkv, wout, wgu, wdown = ops
        mm = {"B5": (cuda_ms(lambda: torch.matmul(x, wqkv), 10),
                     cuda_ms(lambda: torch.matmul(x, wout), 10)),
              "B6": (cuda_ms(lambda: torch.matmul(x, wgu), 10),
                     cuda_ms(lambda: torch.matmul(h, wdown), 10))}
        del h
    log(f"cuBLAS AIMv2 GEMMs B={b}: B5's [{t}, {d}] @ [{d}, {3 * d}] "
        f"{mm['B5'][0]:.3f} ms + [{t}, {d}] @ [{d}, {d}] {mm['B5'][1]:.3f} "
        f"ms = {sum(mm['B5']):.3f} ms; B6's [{t}, {d}] @ [{d}, {2 * f}] "
        f"{mm['B6'][0]:.3f} ms + [{t}, {f}] @ [{f}, {d}] {mm['B6'][1]:.3f} "
        f"ms = {sum(mm['B6']):.3f} ms")
    return time_halves({
        "B5 attention half (AIMv2, RMSNorm, no biases)": (
            lambda: fl.rms_attn_half(x, ops, **kw),
            lambda: fl.rms_attn_half_ref(x, ops, **kw), b5),
        "B6 MLP half (AIMv2, SiLU-gated)": (
            lambda: fl.gated_mlp_half(x, ops, eps=c.rms_norm_eps),
            lambda: fl.gated_mlp_half_ref(x, ops, eps=c.rms_norm_eps), b6),
    }, f"B={b} frames (T={t}, D={d}, F={f}, S={s})", atol=two_ulps)


def compare_aimv2_encodes(embedder: AIMv2Embedder, seed: int,
                          b_text: int = 64, b_frames: int = 256) -> None:
    """The fused vision encode of ``b_frames`` seeded frames and the fused
    text encode of ``b_text`` queries on the kernels against the same
    encodes on the halves' plain versions: rows at per-row cosine >=
    MIN_COS, unit-norm within UNIT_ATOL."""
    model = embedder.params
    vops = embedder._layer_ops(model, "vision")
    tops = embedder._layer_ops(model)
    rng = np.random.default_rng(seed + 19)
    ids = embedder.prepare_text_ids(embedder.tokenizer(
        [words(rng, 11) for _ in range(b_text)]))
    ids_t = embedder.ids_tensor(ids)
    frames = torch.from_numpy(seeded_frames(seed, 10_003, b_frames)).to(
        embedder.device)
    plain = {"attn": fl.rms_attn_half_ref, "mlp": fl.gated_mlp_half_ref}
    with torch.inference_mode():
        pixels = normalize_images(frames, dtype=embedder.dtype)
        encodes = (
            (f"AIMv2 vision encode B={b_frames} frames S="
             f"{model.cfg.vision.seq_len} x{len(vops)} layers (fused: B5 "
             "RMSNorm + B6 gated)", b_frames, "frames",
             lambda: fused_aimv2_vision_encode(model, pixels, vops),
             lambda: fused_aimv2_vision_encode(model, pixels, vops, **plain),
             3),
            (f"AIMv2 text encode B={b_text} S={ids.shape[1]} x{len(tops)} "
             "layers (fused, causal)", b_text, "rows",
             lambda: fused_aimv2_text_encode(model, ids_t, tops),
             lambda: fused_aimv2_text_encode(model, ids_t, tops, **plain),
             10))
        for name, n, unit, kern, ref, iters in encodes:
            a, p = kern(), ref()
            cos = torch.nn.functional.cosine_similarity(a, p, dim=-1).min()
            norm = (torch.linalg.vector_norm(a, dim=-1) - 1).abs().max()
            require(a.shape == (n, embedder.embed_dim)
                    and bool(torch.isfinite(a).all()), f"{name}: output")
            require(cos.item() >= MIN_COS, f"{name}: min cosine {cos}")
            require(norm.item() <= UNIT_ATOL, f"{name}: norm error {norm}")
            ms, pms = cuda_ms(kern, iters), cuda_ms(ref, iters)
            log(f"{name} (bf16): min cosine {cos.item():.6f} (>= {MIN_COS}) "
                f"vs the plain halves, max |norm - 1| {norm.item():.2e} (<= "
                f"{UNIT_ATOL}); kernels {ms:.3f} ms plain {pms:.3f} ms = "
                f"{n / ms * 1e3:.0f} {unit}/s on the kernels")


def phase_aimv2_kernels(embedder: AIMv2Embedder, device, seed: int) -> dict:
    """Phase 3's AIMv2 part: B3 at head width 128 beside SDPA, the gated
    halves at 256 frames, both fused encodes; returns the kernels-line
    numbers (B3 at the vision shape and at the singles' text shape)."""
    b3 = {}
    for shape in AIMV2_ATTN_SHAPES:
        b3[shape[:2]] = compare_attention(device, (shape,), row=shape[:2],
                                          hd=128)
    b5, b6 = compare_aimv2_halves(embedder, seed)
    compare_aimv2_encodes(embedder, seed)
    return {"attention": b3[(256, 256)], "attention_text": b3[(1, 8)],
            "rms_attn_half": b5, "gated_mlp_half": b6}


def phase_aimv2_engine(embedder: AIMv2Embedder, args, device,
                       smi: str) -> tuple:
    """``model.family = "aimv2"`` at full width, bf16 tier, as the SigLIP
    engine of this phase: a seeded corpus of ``args.videos`` x
    ``args.frames`` rows x 512 drawn on the card and appended, an ingest
    of INGEST_VIDEOS seeded videos through the decode pipeline and the
    fused vision encode (24 launches of each gated half an embed batch,
    no other kernel; ``attention.launches_hd128`` stays 0, B3 running
    inside B5), then the HTTP searches, held against the host exact
    top-K, with every B3 launch of the path at head width 128. Returns
    the search path's launches (with ``attention_hd128``) and the
    ingest's."""
    n = args.videos * args.frames
    scratch = ROOT / "build" / "smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed + 4)
    timings = {}
    with tempfile.TemporaryDirectory(dir=scratch) as videos:
        config = EngineConfig()
        config.model.family = "aimv2"
        config.index.device_dtype = "bfloat16"
        engine = VideoSearchEngine(videos, config=config, embedder=embedder,
                                   device=device)
        require(config.index.embed_dim == DIM,
                f"[aimv2] index.embed_dim {config.index.embed_dim}")
        engine.startup()
        require_seeded("aimv2", engine)
        t0 = time.perf_counter()
        corpus = corpus_on_card_rows(device, args.seed + 13, n, DIM)
        engine.index.reserve(n)
        stamps = [0.5 * t for t in range(args.frames)]
        for v in range(args.videos):
            engine.index.add_batch(
                corpus[v * args.frames:(v + 1) * args.frames],
                video_name(v), stamps)
        del corpus
        engine.index.sync_mirror()
        require(len(engine.index) == n, "[aimv2] corpus row count")
        log(f"[aimv2] corpus: {n} rows x {engine.index.dim} from seed "
            f"{args.seed + 13} drawn on the card, appended and placed in "
            f"{time.perf_counter() - t0:.1f} s ({engine.accuracy_mode()})")
        attention.launches_hd128 = 0
        ingested = ingest_tier(engine, "bfloat16", videos, args, device,
                               tag="aimv2", path=AIMV2_INGEST)
        require(attention.launches_hd128 == 0,
                f"[aimv2] ingest: {attention.launches_hd128} B3 launches "
                "outside B5")
        corpus = engine.index._emb[: len(engine.index)]

        def name_of(row: int) -> str:
            if row < n:
                return video_name(row // args.frames)
            return ingest_name((row - n) // args.frames)

        server = create_server(engine, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            for wrapper in WRAPPERS.values():
                wrapper.launches = 0
            attention.launches_hd128 = 0
            served = drive(base, "aimv2", rng, timings)
            launches = {name: w.launches for name, w in WRAPPERS.items()}
            wide = attention.launches_hd128
        finally:
            server.shutdown()
            server.server_close()
            thread.join(30)
            engine.close()
        check_tower_launches(engine, launches, "aimv2", AIMV2_PATH)
        require(wide == launches["attention"],
                f"[aimv2] {wide} of {launches['attention']} B3 launches at "
                "head width 128")
        check_served("aimv2", embedder, corpus, name_of, served, device)
        del engine, server, corpus
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[aimv2] on {smi}: single p50 {timings['single_p50_ms']:.2f} ms, "
        f"batch of 64 {timings['batch_ms']:.2f} ms, ingest "
        f"{ingested['frames_s']:.1f} frames/s")
    return dict(launches, attention_hd128=wide), ingested


def aimv2_kernel_entries(ak: dict, al: dict, ai: dict) -> list:
    """The kernels line's AIMv2 entries: phase 3's numbers ``ak``, the
    engine's search launches ``al`` and ingest ``ai``."""
    src = "video_quierer_tpu_torch/csrc/"
    ingest = ai["launches"]
    return [
        {"name": "attention_aimv2_vision", "route": "cuda",
         "source": src + "attention.cu", "replaces": None,
         "launches": ingest["rms_attn_half"], "via": "rms_attn_half",
         **ak["attention"]},
        {"name": "attention_aimv2_text", "route": "cuda",
         "source": src + "attention.cu", "replaces": None,
         "launches": al["attention_hd128"], **ak["attention_text"]},
        {"name": "rms_attn_half", "route": "cuda",
         "source": src + "fused_layer.cu", "replaces": None,
         "launches": ingest["rms_attn_half"],
         "search_launches": al["rms_attn_half"], **ak["rms_attn_half"]},
        {"name": "gated_mlp_half", "route": "cuda",
         "source": src + "fused_layer.cu", "replaces": None,
         "launches": ingest["gated_mlp_half"],
         "search_launches": al["gated_mlp_half"], **ak["gated_mlp_half"]}]


def phase_aimv2(args, device, smi: str) -> list:
    """Phase 3's AIMv2 part, then phase 6's AIMv2 engine on the same
    seeded towers; returns the kernels line's AIMv2 entries."""
    with timed("3, AIMv2 kernels"):
        aimv2 = AIMv2Embedder(model_name=AIMV2, dtype=torch.bfloat16,
                              device=device, seed=args.seed)
        ak = phase_aimv2_kernels(aimv2, device, args.seed)
    with timed("6, AIMv2 engine"):
        al, ai = phase_aimv2_engine(aimv2, args, device, smi)
    del aimv2
    gc.collect()
    torch.cuda.empty_cache()
    return aimv2_kernel_entries(ak, al, ai)


# -- phase 9: checkpoints -----------------------------------------------------

# ViT-L/14 at full width: 768-wide rows, B3 inside its B5 at 256 frames x 16
# heads x S = 257, and the seeded videos phase 9 ingests through it (half of
# phase 4's 20)
L14 = "openai/clip-vit-large-patch14"
L14_ATTN_SHAPES = ((256, 257, 16, False),)
L14_VIDEOS = 10
# the checkpoint engines' queries: two random words, so that the checkpoint
# vocabulary's character-level BPE ids stay in the 32 bucket (B2's)
CKPT_WORDS = 2
# safetensors' dtype names of the arrays phase 9 writes
ST_DTYPES = {np.dtype(np.float32): "F32", np.dtype(np.int64): "I64"}


def phase_l14_kernels(embedder: CLIPEmbedder, args, device) -> dict:
    """Phase 3's ViT-L/14 part (seeded, bf16): B3 at 256 frames x 16 heads
    x S = 257 beside SDPA, B5 and B6 on one vision layer at 256 frames (T =
    65,792, D = 1,024, F = 4,096; cuBLAS's two bare GEMMs beside B6), B2
    on the 768-wide text tower (12 heads) at B = 64; returns their
    kernels-line numbers."""
    b3 = compare_attention(device, L14_ATTN_SHAPES,
                           row=L14_ATTN_SHAPES[0][:2])
    b5, b6 = compare_layer_halves(embedder, args.seed)
    b2 = compare_fused_layer(embedder, args.seed)
    return {"attention": b3, "attn_half": b5, "mlp_half": b6,
            "fused_layer": b2}


def _hf_blocks(sd: dict, tower: str) -> dict:
    """``tower``'s encoder blocks ("text" or "vision") under HF's names."""
    out, pre = {}, f"{tower}.layers."
    for k, v in sd.items():
        if k.startswith(pre):
            i, rest = k[len(pre):].split(".", 1)
            if rest.startswith("attn."):
                rest = "self_" + rest
            out[f"{tower}_model.encoder.layers.{i}.{rest}"] = v
    return out


def _hf_patch(w: torch.Tensor, p: int) -> torch.Tensor:
    """The port's patch matrix ``[D, p*p*3]`` (row, column, channel) as
    HF's conv weight ``[D, 3, p, p]``."""
    return w.reshape(w.shape[0], p, p, 3).permute(0, 3, 1, 2)


def _ln_pair(out: dict, hf: str, sd: dict, port: str) -> None:
    for leaf in ("weight", "bias"):
        out[f"{hf}.{leaf}"] = sd[f"{port}.{leaf}"]


def _position_ids(out: dict, n_vision: int, n_text: int) -> None:
    """The int64 ``position_ids`` buffers older HF checkpoints carry (the
    converters ignore them)."""
    out["vision_model.embeddings.position_ids"] = \
        torch.arange(n_vision)[None]
    out["text_model.embeddings.position_ids"] = torch.arange(n_text)[None]


def _numpy(out: dict) -> dict:
    return {k: np.ascontiguousarray(v.detach().cpu().numpy())
            for k, v in out.items()}


def hf_clip_state(sd: dict, cfg) -> dict:
    """The port's ``CLIP`` state dict under HF ``CLIPModel``'s names and
    layouts: the converter's inverse (used here only, to write the
    checkpoints phase 9 loads)."""
    out = {
        "text_model.embeddings.token_embedding.weight":
            sd["text.token_embedding.weight"],
        "text_model.embeddings.position_embedding.weight":
            sd["text.position_embedding"],
        "text_projection.weight": sd["text_projection.weight"],
        "vision_model.embeddings.patch_embedding.weight":
            _hf_patch(sd["vision.patch_embedding.weight"],
                      cfg.vision.patch_size),
        "vision_model.embeddings.class_embedding":
            sd["vision.class_embedding"],
        "vision_model.embeddings.position_embedding.weight":
            sd["vision.position_embedding"],
        "visual_projection.weight": sd["visual_projection.weight"],
        "logit_scale": sd["logit_scale"],
    }
    _ln_pair(out, "text_model.final_layer_norm", sd, "text.final_layer_norm")
    # NB: HF spells it "pre_layrnorm"
    _ln_pair(out, "vision_model.pre_layrnorm", sd, "vision.pre_layernorm")
    _ln_pair(out, "vision_model.post_layernorm", sd, "vision.post_layernorm")
    out.update(_hf_blocks(sd, "text"))
    out.update(_hf_blocks(sd, "vision"))
    require(len(out) == len(sd), "HF CLIP names: a tensor was dropped")
    _position_ids(out, cfg.vision.seq_len, cfg.text.context_length)
    return _numpy(out)


def hf_siglip_state(sd: dict, cfg) -> dict:
    """The port's ``SigLIP`` state dict under HF ``SiglipModel``'s names and
    layouts (the MAP head's q/k/v packed into torch's ``in_proj``)."""
    h = "vision.head."
    out = {
        "text_model.embeddings.token_embedding.weight":
            sd["text.token_embedding.weight"],
        "text_model.embeddings.position_embedding.weight":
            sd["text.position_embedding"],
        "vision_model.embeddings.patch_embedding.weight":
            _hf_patch(sd["vision.patch_embedding.weight"],
                      cfg.vision.patch_size),
        "vision_model.embeddings.patch_embedding.bias":
            sd["vision.patch_embedding.bias"],
        "vision_model.embeddings.position_embedding.weight":
            sd["vision.position_embedding"],
        "vision_model.head.probe": sd[h + "probe"],
        "vision_model.head.attention.in_proj_weight": torch.cat(
            [sd[h + f"{n}_proj.weight"] for n in "qkv"]),
        "vision_model.head.attention.in_proj_bias": torch.cat(
            [sd[h + f"{n}_proj.bias"] for n in "qkv"]),
        "logit_scale": sd["logit_scale"],
        "logit_bias": sd["logit_bias"],
    }
    for hf, port in (("text_model.final_layer_norm", "text.final_layer_norm"),
                     ("text_model.head", "text.head"),
                     ("vision_model.post_layernorm", "vision.post_layernorm"),
                     ("vision_model.head.attention.out_proj",
                      h + "out_proj"),
                     ("vision_model.head.layernorm", h + "layernorm"),
                     ("vision_model.head.mlp.fc1", h + "mlp.fc1"),
                     ("vision_model.head.mlp.fc2", h + "mlp.fc2")):
        _ln_pair(out, hf, sd, port)
    out.update(_hf_blocks(sd, "text"))
    out.update(_hf_blocks(sd, "vision"))
    # six q/k/v tensors packed into two
    require(len(out) == len(sd) - 4, "HF SigLIP names: a tensor was dropped")
    _position_ids(out, cfg.vision.num_patches, cfg.text.context_length)
    return _numpy(out)


def write_safetensors(path: Path, arrays: dict) -> None:
    """``arrays`` as a ``.safetensors`` file, written by hand: the header's
    length (8 bytes, little-endian), the JSON header (each tensor's dtype,
    shape and data offsets counted from the header's end; padded with
    spaces to 8 bytes), then each array's raw little-endian bytes."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, a in arrays.items():
        header[name] = {"dtype": ST_DTYPES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for a in arrays.values():
            f.write(a.reshape(-1).data)


def write_bpe_vocab(d: Path) -> None:
    """A small ``vocab.json``/``merges.txt`` pair in HF's format: letters
    and their word-final ``</w>`` forms, a few merges, the two specials
    last (EOT the highest id), and ``merges.txt``'s ``#version`` line."""
    vocab = {}
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    for tok in ("do", "do</w>", "og</w>", "dog</w>", "<|startoftext|>",
                "<|endoftext|>"):
        vocab[tok] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\nd o\ndo g</w>\no g</w>\n")


def write_checkpoint(d: Path, seeded, family: str, fmt: str, seed: int
                     ) -> None:
    """The f32 weights ``seeded`` was built from (the port's seeded init,
    drawn again from ``seed``) as an HF checkpoint dir: ``model.safetensors``
    (written by hand) or ``pytorch_model.bin`` (``torch.save``), with the
    BPE vocabulary pair for CLIP."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed)
    if family == "clip":
        hf = hf_clip_state(clip_bridge.init_params(seeded.cfg, gen),
                           seeded.cfg)
    else:
        hf = hf_siglip_state(siglip_bridge.init_params(seeded.cfg, gen),
                             seeded.cfg)
    d.mkdir(parents=True)
    if fmt == "safetensors":
        write_safetensors(d / "model.safetensors", hf)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in hf.items()},
                   d / "pytorch_model.bin")
    if family == "clip":
        write_bpe_vocab(d)
    size = sum(f.stat().st_size for f in d.iterdir())
    log(f"[{d.name}] checkpoint: {len(hf)} tensors, {size / 1e9:.3f} GB "
        f"({fmt}) drawn and written in {time.perf_counter() - t0:.1f} s")


def require_same_params(tag: str, got, want) -> None:
    """The loaded tower's parameters equal the seeded tower's, bit for
    bit."""
    a, b = got.state_dict(), want.state_dict()
    require(a.keys() == b.keys(), f"[{tag}] parameter names differ")
    bad = [k for k in a if a[k].dtype != b[k].dtype
           or not torch.equal(a[k], b[k])]
    require(not bad, f"[{tag}] parameters differ: {bad[:4]}")
    n = sum(t.numel() for t in a.values())
    log(f"[{tag}] all {len(a)} parameter tensors ({n:,} values, "
        f"{next(iter(a.values())).dtype}) equal the seeded tower's, bit for "
        "bit")


def rss_gb() -> str:
    """This process's resident and peak resident host memory."""
    fields = dict(line.split(":", 1) for line in
                  Path("/proc/self/status").read_text().splitlines()
                  if line.startswith(("VmRSS", "VmHWM")))
    return ", ".join(f"{k} {int(v.split()[0]) / 2 ** 20:.2f} GB"
                     for k, v in fields.items())


def checkpoint_engine(tag: str, config: EngineConfig, videos: Path,
                      seeded, device):
    """An engine over ``videos`` with ``config`` (no tower injected: it
    builds its own from the checkpoint); its tower is built and checked
    first: ``stats()["pretrained"]`` true, the tokenizer, the parameters
    against ``seeded``'s. Returns the engine, its tower and the load's
    seconds."""
    engine = VideoSearchEngine(videos, config=config, device=device)
    before = rss_gb()
    t0 = time.perf_counter()
    tower = engine._tower()
    wall = time.perf_counter() - t0
    pretrained = engine.stats()["pretrained"]
    require(pretrained is True, f"[{tag}] pretrained {pretrained}")
    want = CLIPBPETokenizer if config.model.family == "clip" \
        else HashTokenizer
    require(type(tower.tokenizer) is want,
            f"[{tag}] tokenizer {type(tower.tokenizer).__name__}")
    log(f"[{tag}] tower loaded in {wall:.2f} s (stages, s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in tower.load_seconds.items())
        + f"); pretrained: true; tokenizer {want.__name__}; host memory "
        f"before: {before}; after: {rss_gb()}")
    require_same_params(tag, tower.params, seeded.params)
    return engine, tower, {"wall_s": wall, **tower.load_seconds}


def same_text_vectors(tag: str, tower, seeded, rng) -> None:
    """The loaded and the seeded tower give the same text vectors, bit for
    bit, on the same ids (the loaded tower's tokenizer): 8 singles (B = 1)
    and a batch of 64."""
    texts = [words(rng, CKPT_WORDS) for _ in range(64)]
    ids = tower.prepare_text_ids(tower.tokenizer(texts))
    with torch.inference_mode():
        for batch in [ids[i:i + 1] for i in range(8)] + [ids]:
            t = tower.ids_tensor(batch)
            require(torch.equal(tower.text_encode_fn(tower.params, t),
                                seeded.text_encode_fn(seeded.params, t)),
                    f"[{tag}] text vectors differ at B={len(batch)}")
    log(f"[{tag}] text vectors of 8 singles and a batch of 64 (S="
        f"{ids.shape[1]}) equal the seeded tower's, bit for bit")


def serve_checkpoint(tag: str, config: EngineConfig, seeded, args, device,
                     root: Path, smi: str, n_videos: int = INGEST_VIDEOS,
                     encode_check=None) -> dict:
    """One engine that loads its tower from a checkpoint: the load checks,
    the text vectors against the seeded tower, ``encode_check(tower)`` when
    given, startup (no cache), a seeded corpus of ``args.videos`` x
    ``args.frames`` unit rows (phase 4's size: as B1 keeps the top 2 rows
    of each 1,024-row bucket, a smaller corpus lets three of a query's top
    10 share a bucket; drawn on the card and appended video by video, not
    loaded from a pickle: the cache's save and load are phase 4's), an
    ingest of ``n_videos`` seeded videos (the vision tower; the mirror bit
    for bit), then over HTTP 16 singles, 64 coalesced clients and a batch
    of 64, the launch counters set to 0 just before and read just after,
    every single and 8 batch rows held against the host exact top-K over
    the grown corpus. Returns the load's seconds and the launches."""
    siglip = config.model.family == "siglip"
    videos = root / f"videos-{tag.replace('/', '-')}"
    engine, tower, load = checkpoint_engine(tag, config, videos, seeded,
                                            device)
    rng = np.random.default_rng(args.seed + 9)
    same_text_vectors(tag, tower, seeded, rng)
    if encode_check is not None:
        encode_check(tower)
    served = serve_grown(tag, engine, tower, args, device, smi, videos, rng,
                         n_videos=n_videos,
                         path=("attention",) if siglip else INGEST)
    del engine, tower
    gc.collect()
    torch.cuda.empty_cache()
    return {"load": load, **served}


def serve_grown(tag: str, engine: VideoSearchEngine, tower, args, device,
                smi: str, videos: Path, rng, n_videos: int = INGEST_VIDEOS,
                path: tuple = INGEST, per_batch: int = 0,
                n_words: int = CKPT_WORDS) -> dict:
    """``engine`` (its tower ``tower``) grown and served: startup (no
    cache), a seeded corpus of ``args.videos`` x ``args.frames`` unit rows
    drawn on the card and appended video by video, an ingest of
    ``n_videos`` seeded videos (``ingest_tier``: the kernels of ``path``
    ``per_batch`` times an embed batch), then over HTTP 16 singles, 64
    coalesced clients and a batch of 64, the launch counters set to 0 just
    before and read just after, every single and 8 batch rows held against
    the host exact top-K over the grown corpus (queries of ``n_words``
    random words). Returns the launches of the searches and of the
    ingest."""
    siglip = engine.config.model.family == "siglip"
    engine.startup()
    t0 = time.perf_counter()
    n_base = args.videos * args.frames
    rows = corpus_on_card_rows(device, args.seed + 9, n_base,
                               tower.embed_dim)
    engine.index.reserve(n_base)
    stamps = [0.5 * t for t in range(args.frames)]
    for v in range(args.videos):
        engine.index.add_batch(rows[v * args.frames:(v + 1) * args.frames],
                               video_name(v), stamps)
    del rows
    require(len(engine.index) == n_base, f"[{tag}] corpus row count")
    log(f"[{tag}] seeded corpus: {n_base} rows x {tower.embed_dim} drawn on "
        f"the card and appended in {time.perf_counter() - t0:.1f} s")
    ingested = ingest_tier(engine, "bfloat16", str(videos), args, device,
                           n_videos=n_videos, tag=tag, path=path,
                           per_batch=per_batch)
    corpus = engine.index._emb[: len(engine.index)]

    def name_of(row: int) -> str:
        if row < n_base:
            return video_name(row // args.frames)
        return ingest_name((row - n_base) // args.frames)

    server = create_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    timings = {}
    try:
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        served = drive(base, tag, rng, timings, n_words=n_words)
        launches = {name: w.launches for name, w in WRAPPERS.items()}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        engine.close()
    if siglip:
        check_tower_launches(engine, launches)
    else:
        check_launches(tag, engine, launches, "cand_scan_prefix")
    check_served("bfloat16", tower, corpus, name_of, served, device, tag=tag)
    log(f"[{tag}] on {smi}: single p50 {timings['single_p50_ms']:.2f} ms, "
        f"batch of 64 {timings['batch_ms']:.2f} ms, ingest "
        f"{ingested['frames_s']:.1f} frames/s; launches: ingest "
        f"{ingested['launches']}, searches {launches}")
    del server, corpus
    return {"launches": launches, "ingest": ingested, **timings}


def compare_l14_encode(tower: CLIPEmbedder, seed: int, b: int = 256) -> None:
    """ViT-L/14's fused vision encode (B5 + B6 x 24 layers at T = 65,792,
    D = 1,024, F = 4,096) against the module tower (B3 and cuBLAS) and
    against the plain halves on ``b`` seeded frames: per-row cosine >=
    MIN_COS, unit rows within UNIT_ATOL."""
    model = tower.params
    ops = tower._layer_ops(model, "vision")
    frames = torch.from_numpy(seeded_frames(seed, 10_003, b)).to(
        tower.device)
    with torch.inference_mode():
        pixels = normalize_images(frames, dtype=tower.dtype)

        def kern():
            return fl.fused_vision_encode(model, pixels, ops)

        a = kern()
        norm = (torch.linalg.vector_norm(a, dim=-1) - 1).abs().max().item()
        require(a.shape == (b, tower.embed_dim)
                and bool(torch.isfinite(a).all()), "L/14 encode: output")
        require(norm <= UNIT_ATOL, f"L/14 encode: norm error {norm}")
        cos = {}
        for name, ref in (("module tower", model.encode_image(pixels)),
                          ("plain halves", fl.fused_vision_encode(
                              model, pixels, ops, attn=fl.attn_half_ref,
                              mlp=fl.mlp_half_ref))):
            cos[name] = torch.nn.functional.cosine_similarity(
                a, ref, dim=-1).min().item()
            require(cos[name] >= MIN_COS,
                    f"L/14 encode vs the {name}: min cosine {cos[name]}")
        ms = cuda_ms(kern, 3)
        module_ms = cuda_ms(lambda: model.encode_image(pixels), 3)
    log(f"ViT-L/14 vision encode B={b} frames x{len(ops)} layers (bf16, "
        f"fused: B5 + B6): min row cosine {cos['module tower']:.6f} vs the "
        f"module tower, {cos['plain halves']:.6f} vs the plain halves (>= "
        f"{MIN_COS}), max |norm - 1| {norm:.2e}; {ms:.3f} ms = "
        f"{b / ms * 1e3:.0f} frames/s (module tower {module_ms:.3f} ms)")


def phase_checkpoints(embedder: CLIPEmbedder, siglip: SigLIPEmbedder,
                      l14: CLIPEmbedder, args, device, smi: str) -> dict:
    """Phase 9: the seeded towers written as HF checkpoints and served from
    them. ViT-B/32 from ``model.safetensors`` through
    ``VQT_CLIP_CHECKPOINT`` (the operator's route), then loaded once more
    from ``pytorch_model.bin``; SigLIP base/16 from ``model.safetensors``
    (``model.checkpoint_dir``); ViT-L/14 at full width. Returns each
    path's load seconds and launches."""
    scratch = ROOT / "build" / "smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        root = Path(tmp)
        with timed("9, ViT-B/32 from model.safetensors"):
            ckpt = root / "clip-vit-base-patch32"
            write_checkpoint(ckpt, embedder, "clip", "safetensors",
                             args.seed)
            os.environ["VQT_CLIP_CHECKPOINT"] = str(ckpt)
            try:
                config = apply_env_overrides(EngineConfig())
            finally:
                del os.environ["VQT_CLIP_CHECKPOINT"]
            require(config.model.checkpoint_dir == str(ckpt),
                    "VQT_CLIP_CHECKPOINT -> model.checkpoint_dir")
            config.index.device_dtype = "bfloat16"
            out["vit-b-32"] = serve_checkpoint(
                "ckpt vit-b/32", config, embedder, args, device, root, smi)
        with timed("9, ViT-B/32 from pytorch_model.bin"):
            ckpt = root / "clip-vit-base-patch32-bin"
            write_checkpoint(ckpt, embedder, "clip", "bin", args.seed)
            config = EngineConfig()
            config.model.checkpoint_dir = str(ckpt)
            engine, _, load = checkpoint_engine(
                "ckpt vit-b/32 .bin", config, root / "videos-bin", embedder,
                device)
            out["vit-b-32-bin"] = {"load": load}
            del engine
            shutil.rmtree(ckpt)
        with timed("9, SigLIP base/16 from model.safetensors"):
            ckpt = root / "siglip-base-patch16-224"
            write_checkpoint(ckpt, siglip, "siglip", "safetensors",
                             args.seed)
            config = EngineConfig()
            config.model.family = "siglip"
            config.model.checkpoint_dir = str(ckpt)
            config.index.device_dtype = "bfloat16"
            out["siglip"] = serve_checkpoint(
                "ckpt siglip", config, siglip, args, device, root, smi)
        with timed("9, ViT-L/14 from model.safetensors"):
            ckpt = root / "clip-vit-large-patch14"
            write_checkpoint(ckpt, l14, "clip", "safetensors", args.seed)
            config = EngineConfig()
            config.model.name = L14
            config.model.checkpoint_dir = str(ckpt)
            config.index.embed_dim = l14.embed_dim
            config.index.device_dtype = "bfloat16"
            out["vit-l-14"] = serve_checkpoint(
                "ckpt vit-l/14", config, l14, args, device, root, smi,
                n_videos=L14_VIDEOS,
                encode_check=lambda t: compare_l14_encode(t, args.seed))
    return out

# -- phase 10: training -----------------------------------------------------

# B3 under autograd at the trainer's shapes: (B, S, heads, causal), the
# ViT-B/32 vision tower's and the text tower's
TRAIN_ATTN_SHAPES = ((64, 50, 12, False), (64, 77, 8, True))
# forward and dq/dk/dv against autograd through the plain version: f32
# (two f32 matmul chains in other orders), bf16 (the forward's clamped
# unstabilised softmax against the stabilised one of the VJP, each rounded
# to bf16: tests/test_torch_train.py)
TRAIN_ATTN_ATOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 6e-2)}
TRAIN_B = 64
TRAIN_STEPS = 8
TRAIN_FRAMES = 8            # a video's frames: 8 videos make the batch of 64
TRAIN_LR = 3e-4
TRAIN_LAUNCHES = 24         # a step's B3 launches: 12 vision + 12 text layers
# a step's loss and gradients under remat (the same kernels and GEMMs run
# again) and with B3 swapped for its plain version (f32 throughout), per
# tensor: ||g - g_ref|| <= rtol ||g_ref|| + atol sqrt(n)
REMAT_TOL = (1e-5, 1e-8)
PLAIN_TOL = (1e-3, 1e-6)
SIGLIP_TRAIN_B = 32
# the train → serve engine's corpus: 20 videos x 200 frames
SERVE_VIDEOS, SERVE_FRAMES = 20, 200
SERVE_TEXTS = ("a dog on the beach", "two cats asleep", "a red car",
               "city lights at night")


def attention_train_bound(b: int, s: int, d: int, causal: bool, dtype,
                          forwards: int = 1) -> dict:
    """The least time of ``forwards`` attention forwards and one backward:
    each forward reads q, k, v and writes the output, the backward reads
    q, k, v and the output's gradient and writes dq, dk, dv; two products
    a forward (QK^T, PV) and four a backward (dP, dV, dQ, dK) over the
    (causal) pairs."""
    pairs = s * (s + 1) / 2 if causal else s * s
    esize = 2 if dtype == torch.bfloat16 else 4
    tensors = 4 * forwards + 7
    ops = 2 * b * d * pairs * (2 * forwards + 4)
    return bound(tensors * b * s * d * esize, ops,
                 "bf16" if dtype == torch.bfloat16 else "f32")


def compare_attention_grad(dev, shapes=TRAIN_ATTN_SHAPES) -> dict:
    """B3 under autograd (its Function: the kernel forward, the einsum VJP
    backward) against autograd through its plain version, at the
    trainer's shapes in f32 and bf16: the output and dq, dk, dv within
    TRAIN_ATTN_ATOL; one launch a forward, none a backward. Timed with
    CUDA events, the second of two loops: the forward alone (device time,
    graph replay), the forward with its backward both ways and SDPA's
    (the yardstick), and under remat (a forward without grad, then the
    forward and backward again). Returns {(S, dtype): numbers}."""
    out = {}
    for b, s, heads, causal in shapes:
        d = 64 * heads
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(2000 * s + b)
            q, k, v, grad = ((0.5 * torch.randn(b, s, d, generator=g,
                                                device=dev)).to(dtype)
                             for _ in range(4))

            def run(fn, q=q, k=k, v=v, grad=grad, heads=heads,
                    causal=causal):
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                o = fn(*leaves, num_heads=heads, causal=causal)
                return o, torch.autograd.grad(o, leaves, grad)

            def forward(q=q, k=k, v=v, heads=heads, causal=causal):
                with torch.no_grad():
                    return attention(q, k, v, num_heads=heads, causal=causal)

            qh, kh, vh, gh = (t.view(b, s, heads, 64).transpose(1, 2)
                              for t in (q, k, v, grad))

            def library(qh=qh, kh=kh, vh=vh, gh=gh, causal=causal):
                leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
                o = torch.nn.functional.scaled_dot_product_attention(
                    *leaves, is_causal=causal, scale=64 ** -0.5)
                return torch.autograd.grad(o, leaves, gh)

            before = attention.launches
            o_k, g_k = run(attention)
            torch.cuda.synchronize()
            require(attention.launches == before + 1,
                    f"B3 under autograd S={s}: "
                    f"{attention.launches - before} launches")
            o_p, g_p = run(plain_attention)
            err = (o_k.float() - o_p.float()).abs().max().item()
            gerr = max((a.float() - c.float()).abs().max().item()
                       for a, c in zip(g_k, g_p))
            atol, gatol = TRAIN_ATTN_ATOL[dtype]
            tag = f"B3 train S={s} H={heads} {str(dtype)[6:]}"
            require(err <= atol and gerr <= gatol,
                    f"{tag}: forward err {err}, gradient err {gerr}")
            require(all(t.dtype == dtype for t in g_k), f"{tag}: grad dtype")
            fwd_ms = graph_ms(forward, 20)
            ms, pms = cuda_ms(lambda: run(attention), 20), \
                cuda_ms(lambda: run(plain_attention), 20)
            lms = cuda_ms(library, 20)
            rms = cuda_ms(lambda: (forward(), run(attention)), 20)
            rpms = cuda_ms(lambda: (plain_attention(
                q, k, v, num_heads=heads, causal=causal),
                run(plain_attention)), 20)
            rlms = cuda_ms(lambda: (library(), library()), 10) / 2
            lim = attention_train_bound(b, s, d, causal, dtype)
            rlim = attention_train_bound(b, s, d, causal, dtype, forwards=2)
            log(f"{tag} {'causal' if causal else 'non-causal'} B={b}: "
                f"forward err {err:.3e}, dq/dk/dv err {gerr:.3e} (atol "
                f"{atol}, {gatol}); forward {fwd_ms:.4f} ms device; forward "
                f"+ backward {ms:.4f} ms (plain {pms:.4f}, sdpa {lms:.4f}, "
                f"bound {lim['bound_ms']:.4f} {lim['bound_by']}); under "
                f"remat {rms:.4f} ms (plain {rpms:.4f}, bound "
                f"{rlim['bound_ms']:.4f})")
            out[(s, dtype)] = {
                "step": {"max_abs_err": max(err, gerr), "ms": ms,
                         "plain_ms": pms, **lim, "library_ms": lms,
                         "forward_ms": fwd_ms, "forward_err": err,
                         "grad_err": gerr},
                "remat": {"max_abs_err": max(err, gerr), "ms": rms,
                          "plain_ms": rpms, **rlim, "library_ms": rlms}}
    return out


def train_flops(cfg, b: int) -> float:
    """The operations of one training step of ``cfg``'s two towers at
    batch ``b``: the forward's products (the patch embedding, per layer
    the q/k/v/out projections, the MLP and attention's two products over
    its (causal) pairs, the projections) times 3 for the backward's two
    products each; the elementwise work and the loss left out."""
    def tower(c, s, causal):
        d, f = c.hidden_size, c.hidden_size * c.mlp_ratio
        pairs = s * (s + 1) / 2 if causal else s * s
        return c.num_layers * (2 * s * (4 * d * d + 2 * d * f)
                               + 4 * d * pairs)
    v, t = cfg.vision, cfg.text
    fwd = (tower(v, v.seq_len, False) + tower(t, t.context_length, True)
           + 2 * v.num_patches * v.patch_size ** 2 * 3 * v.hidden_size
           + 2 * cfg.projection_dim * (v.hidden_size + t.hidden_size))
    return 3 * b * fwd


def train_batch(args, tokenizer, n_videos: int, mean, std):
    """One batch of ``n_videos x TRAIN_FRAMES`` (frame, caption) pairs
    through ``frame_caption_batches``: the decode replaced by seeded uint8
    frames (the card's machine has no OpenCV; the data module looks
    ``frames.extract_frames`` up at call time), the captions from the
    file names, tokenized by ``tokenizer``; returns (images, ids)."""
    def seeded(path, *, max_frames, sampling_mode, target_size):
        v = int(Path(path).stem.split("_")[1])
        return (seeded_frames(args.seed, 40_000 + v, max_frames),
                [k / FPS for k in range(max_frames)])

    real = ingest_frames.extract_frames
    ingest_frames.extract_frames = seeded
    try:
        paths = [Path(f"clip_{v:02d}_{words(np.random.default_rng(v), 2)}"
                      ".mp4".replace(" ", "_")) for v in range(n_videos)]
        batches = list(frame_caption_batches(
            paths, tokenizer, batch_size=n_videos * TRAIN_FRAMES,
            max_frames_per_video=TRAIN_FRAMES, image_size=IMAGE, mean=mean,
            std=std))
    finally:
        ingest_frames.extract_frames = real
    require(len(batches) == 1, f"training batches: {len(batches)}")
    return batches[0]


def zero_launches() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def read_launches(tag: str, want: int) -> dict:
    """The counts since ``zero_launches``: B3 ``want`` times, no other
    kernel (the towers train on the module path)."""
    got = {name: w.launches for name, w in WRAPPERS.items()}
    others = {k: n for k, n in got.items() if k != "attention" and n}
    require(got["attention"] == want and not others,
            f"[{tag}] launches {got} (want B3 {want}, nothing else)")
    return got


def step_grads(model, images, ids) -> tuple:
    """One forward and backward of ``model``: (loss, {name: grad})."""
    names, params = zip(*model.named_parameters())
    loss = loss_fn(model, images, ids)
    return loss.item(), dict(zip(names, torch.autograd.grad(loss, params)))


def grads_gap(got: dict, want: dict, tol: tuple, tag: str) -> float:
    """Per tensor ``||got - want|| <= rtol ||want|| + atol sqrt(n)``;
    returns the largest ``||got - want|| / ||want||``."""
    rtol, atol = tol
    worst = 0.0
    for name, w in want.items():
        diff = torch.linalg.vector_norm(got[name].double() - w.double())
        ref = torch.linalg.vector_norm(w.double())
        require(diff <= rtol * ref + atol * w.numel() ** 0.5,
                f"[{tag}] gradient {name}: |diff| {diff:.3e}, |g| {ref:.3e}")
        worst = max(worst, (diff / max(ref, 1e-30)).item())
    return worst


def module_from(cfg, params: dict, device, **kw):
    """A ``CLIP(cfg, **kw)`` on ``device`` holding ``params``."""
    with torch.device("meta"):
        model = clip_model.CLIP(cfg, **kw)
    model = model.to_empty(device=device)
    model.load_state_dict(params)
    return model


def same_state(tag: str, got: dict, want: dict) -> None:
    require(got.keys() == want.keys()
            and all(torch.equal(got[k], want[k]) for k in want),
            f"[{tag}] tensors differ")


def serve_trained(path: Path, trainer: CLIPTrainer, args, device, root: Path,
                  smi: str) -> dict:
    """An engine with ``model.orbax_checkpoint`` = ``path`` over a seeded
    corpus of SERVE_VIDEOS x SERVE_FRAMES rows: ``pretrained`` true; its
    image and text vectors against the trainer's own towers on the saved
    parameters (per-row cosine >= MIN_COS: the engine serves bf16); then
    over HTTP the searches of phase 4, rows against the host exact top-K."""
    config = EngineConfig()
    config.model.orbax_checkpoint = str(path)
    config.index.device_dtype = "bfloat16"
    videos = root / "videos-trained"
    engine = VideoSearchEngine(videos, config=config, device=device)
    t0 = time.perf_counter()
    tower = engine._tower()
    require(engine.stats()["pretrained"] is True, "[trained] pretrained")
    load_s = time.perf_counter() - t0
    frames = seeded_frames(args.seed, 50_000, 32)
    ids = tower.prepare_text_ids(tower.tokenizer(list(SERVE_TEXTS)))
    with torch.no_grad():
        img = trainer.model.encode_image(normalize_images(
            torch.from_numpy(frames).to(device)))
        txt = trainer.model.encode_text(tower.ids_tensor(ids))
    cos = {}
    for name, got, want in (
            ("image", tower.embed_frames(frames), img),
            ("text", tower.embed_texts(list(SERVE_TEXTS)), txt)):
        cos[name] = torch.nn.functional.cosine_similarity(
            torch.from_numpy(got), want.cpu(), dim=-1).min().item()
        require(cos[name] >= MIN_COS,
                f"[trained] {name} vectors: min cosine {cos[name]}")
    log(f"[trained] engine tower from {path.name} in {load_s:.2f} s "
        f"(stages, s: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     tower.load_seconds.items())
        + f"); pretrained: true; min row cosine against the trainer's "
        f"towers: image {cos['image']:.6f}, text {cos['text']:.6f} "
        f"(>= {MIN_COS}, bf16 serving)")
    engine.startup()
    rows = corpus_on_card_rows(device, args.seed + 10,
                               SERVE_VIDEOS * SERVE_FRAMES, DIM)
    stamps = [0.5 * t for t in range(SERVE_FRAMES)]
    for v in range(SERVE_VIDEOS):
        engine.index.add_batch(rows[v * SERVE_FRAMES:(v + 1) * SERVE_FRAMES],
                               video_name(v), stamps)
    corpus = engine.index._emb[: len(engine.index)]
    require(len(corpus) == len(rows), "[trained] corpus rows")
    server = create_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    timings = {}
    try:
        served = drive(base, "bfloat16", np.random.default_rng(args.seed + 10),
                       timings)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        engine.close()
    check_served("bfloat16", tower, corpus,
                 lambda row: video_name(row // SERVE_FRAMES), served, device,
                 tag="trained")
    log(f"[trained] on {smi}: single p50 {timings['single_p50_ms']:.2f} ms, "
        f"batch of 64 {timings['batch_ms']:.2f} ms over {len(corpus)} rows")
    del engine, tower, server
    return {"load_s": load_s, "min_cos": cos, **timings}


def timed_steps(trainer: CLIPTrainer, images, ids, n: int, tag: str
                ) -> tuple:
    """``n`` steps, each B3 TRAIN_LAUNCHES times and nothing else; returns
    (losses, host seconds a step, total launches)."""
    losses, secs, total = [], [], 0
    for i in range(n):
        zero_launches()
        t0 = time.perf_counter()
        losses.append(trainer.step(images, ids))     # float(): synchronises
        secs.append(time.perf_counter() - t0)
        total += read_launches(f"{tag} step {i}",
                               TRAIN_LAUNCHES)["attention"]
        require(np.isfinite(losses[-1]), f"[{tag}] step {i}: loss "
                f"{losses[-1]}")
    return losses, secs, total


def traced_step(trainer: CLIPTrainer, images, ids, trace_dir: Path,
                tag: str, smi: str) -> dict:
    """One more step under ``torch.profiler`` (CPU ops and CUDA kernels):
    the device-busy share of the step's window, its kernel launches and
    the six kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.step(images, ids)
        torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    path = trace_dir / f"train_{tag}.json"
    prof.export_chrome_trace(str(path))
    tr = read_trace(path)
    count = sum(c for c, _ in tr["kernels"].values())
    device_ms = sum(us for _, us in tr["kernels"].values()) / 1e3
    top = sorted(tr["kernels"].items(), key=lambda kv: -kv[1][1])[:6]
    log(f"[train {tag} traced] one step ({host_ms:.1f} ms of host clock "
        f"under the profiler; window {tr['window_ms']:.1f} ms): device "
        f"busy {100 * tr['busy']:.1f}% of the window, {count} kernel "
        f"launches, {device_ms:.1f} ms of kernel time; on {smi}")
    for name, (c, us) in top:
        log(f"[train {tag} traced]   {us / 1e3:8.3f} ms  {c:5d} x  "
            f"{name[:100]}")
    return {"busy_share": tr["busy"], "window_ms": tr["window_ms"],
            "kernel_launches": count, "kernel_ms": device_ms,
            "top6": [[n[:100], c, us / 1e3] for n, (c, us) in top]}


def phase_train(args, device, smi: str) -> dict:
    """Phase 10: B3 under autograd against its plain version at the
    training shapes, then ``CLIPTrainer`` at ViT-B/32's full width on one
    seeded batch of 64 (8 f32 steps, warmup-cosine, the clip, the EMA; a
    step under remat; 2 bf16 steps; the first step's loss and gradients
    with B3 swapped for its plain version), a bf16 SigLIP base/16 step at
    B = 32, then the checkpoint's round trip and an engine serving it;
    last, one more f32 and one more bf16 step each under the profiler."""
    out = {"attention": compare_attention_grad(device)}
    cfg = get_config("openai/clip-vit-base-patch32")
    mean = (0.48145466, 0.4578275, 0.40821073)
    std = (0.26862954, 0.26130258, 0.27577711)
    images, ids = train_batch(args, load_tokenizer(), TRAIN_B // TRAIN_FRAMES,
                              mean, std)
    images, ids = (torch.from_numpy(images).to(device),
                   torch.from_numpy(ids).to(device).long())
    kw = dict(learning_rate=TRAIN_LR, schedule="cosine", warmup_steps=2,
              total_steps=TRAIN_STEPS, max_grad_norm=1.0, ema_decay=0.99,
              device=device)
    trainer = CLIPTrainer(cfg, seed=args.seed, **kw)
    init = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    flops = train_flops(cfg, TRAIN_B)
    gc.collect()
    torch.cuda.reset_peak_memory_stats(device)
    losses, secs, launches = timed_steps(trainer, images, ids, TRAIN_STEPS,
                                         "f32")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    require(losses[-1] < losses[0], f"[f32] losses {losses}: no descent")
    step_s = float(np.mean(secs[2:]))
    out["f32"] = {"losses": losses, "step_ms": 1e3 * step_s,
                  "frames_s": TRAIN_B / step_s, "peak_gb": peak,
                  "launches": launches}
    bounds = {k: 1e3 * flops / PEAK_OPS_S[k] for k in ("f32", "bf16")}
    log(f"[train f32] ViT-B/32 B={TRAIN_B}, {TRAIN_STEPS} steps "
        f"(warmup-cosine to lr {TRAIN_LR}, clip 1.0, EMA 0.99): losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f"; {1e3 * step_s:.1f} ms "
        f"a step (mean of steps 3-{TRAIN_STEPS}; first "
        f"{1e3 * secs[0]:.1f}) = {TRAIN_B / step_s:.1f} frames/s; peak "
        f"memory {peak:.2f} GB; B3 {TRAIN_LAUNCHES} launches a step, "
        f"{launches} in all; {flops / 1e12:.3f} TFLOP a step: bound "
        f"{bounds['f32']:.2f} ms at the f32 peak, {bounds['bf16']:.2f} ms at "
        f"the bf16 peak; on {smi}")
    out["flops"], out["bound_ms"] = flops, bounds

    # one step under remat (through the trainer, from the same weights)
    remat = CLIPTrainer(cfg, params=init, remat=True, **kw)
    zero_launches()
    t0 = time.perf_counter()
    r_loss = remat.step(images, ids)
    r_ms = 1e3 * (time.perf_counter() - t0)
    r_launches = read_launches("remat step", 2 * TRAIN_LAUNCHES)["attention"]
    require(abs(r_loss - losses[0]) <= 1e-6 * abs(losses[0]),
            f"[remat] loss {r_loss} against {losses[0]}")
    del remat
    # the first step's gradients: no remat, remat, and B3's plain version
    grads = {}
    for name, model_kw in (("kernel", {}), ("remat", {"remat": True}),
                           ("plain", {})):
        model = module_from(cfg, init, device, **model_kw)
        zero_launches()
        if name == "plain":
            with module_attention_plain():
                grads[name] = step_grads(model, images, ids)
            read_launches("plain step", 0)
        else:
            grads[name] = step_grads(model, images, ids)
            read_launches(f"{name} step", TRAIN_LAUNCHES
                          * (2 if name == "remat" else 1))
        del model
    (l_k, g_k), (l_r, g_r), (l_p, g_p) = (grads[n] for n in
                                          ("kernel", "remat", "plain"))
    require(l_k == losses[0] or abs(l_k - losses[0]) <= 1e-6 * abs(l_k),
            f"[grads] loss {l_k} against the trainer's {losses[0]}")
    require(abs(l_r - l_k) <= 1e-6 * abs(l_k), f"[remat] loss {l_r} vs {l_k}")
    require(abs(l_p - l_k) <= 1e-5 * abs(l_k), f"[plain] loss {l_p} vs {l_k}")
    gap_r = grads_gap(g_r, g_k, REMAT_TOL, "remat")
    gap_p = grads_gap(g_k, g_p, PLAIN_TOL, "plain")
    del grads, g_k, g_r, g_p
    log(f"[train remat] one step: {r_launches} B3 launches, loss "
        f"{r_loss:.6f} (the f32 trainer's first {losses[0]:.6f}), "
        f"{r_ms:.1f} ms; first-step gradients: remat against none max "
        f"relative gap {gap_r:.2e} (rtol {REMAT_TOL[0]}), B3 against its "
        f"plain version {gap_p:.2e} (rtol {PLAIN_TOL[0]}), loss {l_p:.6f} "
        f"against {l_k:.6f}")
    out["remat"] = {"loss": r_loss, "ms": r_ms, "launches": r_launches,
                    "grad_gap": gap_r, "plain_grad_gap": gap_p}

    # train → serve: the checkpoint's round trip, then an engine serving it
    scratch = ROOT / "build" / "smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        path = train_ckpt.save_checkpoint(root / "ckpt", trainer,
                                          trainer.state.step)
        save_s = time.perf_counter() - t0
        fresh = CLIPTrainer(cfg, params=init, **kw)
        t0 = time.perf_counter()
        step = train_ckpt.restore_checkpoint(root / "ckpt", fresh)
        restore_s = time.perf_counter() - t0
        a, b = trainer.state, fresh.state
        require(step == b.step == a.step == TRAIN_STEPS
                and b.opt_state["count"] == a.opt_state["count"],
                f"[ckpt] step {step}")
        for name, got, want in (("params", b.params, a.params),
                                ("mu", b.opt_state["mu"], a.opt_state["mu"]),
                                ("nu", b.opt_state["nu"], a.opt_state["nu"]),
                                ("ema", b.ema_params, a.ema_params)):
            same_state(f"ckpt {name}", got, want)
        size = sum(f.stat().st_size for f in path.iterdir()) / 1e9
        log(f"[ckpt] {path.name}: {size:.3f} GB saved in {save_s:.2f} s, "
            f"restored into a fresh trainer in {restore_s:.2f} s: params, "
            "moments, EMA and step bit for bit")
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
        out["serve"] = serve_trained(path, trainer, args, device, root, smi)
        out["f32"]["traced"] = traced_step(trainer, images, ids, root,
                                           "f32", smi)
    del trainer, init
    gc.collect()
    torch.cuda.empty_cache()

    # bf16: 2 steps from the seeded weights
    bf16 = CLIPTrainer(cfg, seed=args.seed, dtype=torch.bfloat16, **kw)
    torch.cuda.reset_peak_memory_stats(device)
    b_losses, b_secs, b_launches = timed_steps(bf16, images, ids, 2, "bf16")
    b_peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        b_traced = traced_step(bf16, images, ids, Path(tmp), "bf16", smi)
    del bf16
    log(f"[train bf16] ViT-B/32 B={TRAIN_B}, 2 steps: losses "
        + ", ".join(f"{x:.4f}" for x in b_losses) + f"; second step "
        f"{1e3 * b_secs[1]:.1f} ms = {TRAIN_B / b_secs[1]:.1f} frames/s "
        f"(first {1e3 * b_secs[0]:.1f}); peak memory {b_peak:.2f} GB; "
        f"bound {bounds['bf16']:.2f} ms; on {smi}")
    out["bf16"] = {"losses": b_losses, "step_ms": 1e3 * b_secs[1],
                   "frames_s": TRAIN_B / b_secs[1], "peak_gb": b_peak,
                   "launches": b_launches, "traced": b_traced}

    # SigLIP base/16, bf16, one step at B = 32
    scfg = siglip_base_patch16()
    with torch.device("meta"):
        smodel = SigLIP(scfg, dtype=torch.bfloat16)
    s_images, s_ids = train_batch(args, siglip_tokenizer(scfg),
                                  SIGLIP_TRAIN_B // TRAIN_FRAMES,
                                  SIGLIP_MEAN, SIGLIP_STD)
    siglip = CLIPTrainer(model=smodel, seed=args.seed, **kw)
    s_losses, s_secs, s_launches = timed_steps(siglip, s_images, s_ids, 1,
                                               "siglip bf16")
    del siglip, smodel
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train siglip] base/16 bf16 B={SIGLIP_TRAIN_B} (S = 196 vision, "
        f"64 text): loss {s_losses[0]:.4f}, {1e3 * s_secs[0]:.1f} ms (first "
        f"step), {s_launches} B3 launches")
    out["siglip"] = {"loss": s_losses[0], "ms": 1e3 * s_secs[0],
                     "launches": s_launches}
    return out


def train_kernel_entries(tr: dict) -> list:
    """The kernels line's training entries: B3 under autograd as a step
    runs it (its numbers at the vision shape, f32; the text shape and bf16
    under ``at``), and under remat."""
    src = "video_quierer_tpu_torch/csrc/attention.cu"
    att = tr["attention"]
    at = {f"S={s} {str(dt)[6:]}": att[(s, dt)]["step"]
          for s, dt in att if (s, dt) != (50, torch.float32)}
    base = {"route": "cuda", "source": src,
            "replaces": "video_quierer_tpu/ops/attention.py:143"}
    return [
        {"name": "attention_train", **base,
         "launches": tr["f32"]["launches"],
         "launches_per_step": TRAIN_LAUNCHES,
         "steps": TRAIN_STEPS, "shape": "B=64 S=50 H=12 f32, forward + "
         "backward", **att[(50, torch.float32)]["step"], "at": at},
        {"name": "attention_train_remat", **base,
         "launches": tr["remat"]["launches"],
         "shape": "B=64 S=50 H=12 f32, forward twice + backward",
         **att[(50, torch.float32)]["remat"]}]


# one A/B run: the text and vision kernel phases (and the search-tier
# scans with --ab-scans) of the chip_smoke.py in the working directory, in
# a fresh process, then the device time (CUDA graph replay) of B3, B2, B5
# and B6 at the same shapes, timed the same way in either tree; the
# kernels' ms go to one "ab-row" JSON line
# -- phase 11: tower parallelism ----------------------------------------------

# ViT-B/32's published widths with a Switch-MoE MLP in every 2nd vision block
# (8 experts, capacity factor 1.25): 6 layers x 8 experts x 2 x 768 x 3,072
# expert weights, ~453 MB in bf16
MOE = "vit-b-32-moe8"
MOE_EXPERTS, MOE_EVERY, MOE_CAPACITY = 8, 2, 1.25
# the bf16 kernel tower against the f32 plain tower on the same weights:
# the share of (token, MoE layer) pairs routed to the same expert (a bf16
# rounding flips near-tied routers), and the rows' cosine (MIN_COS)
MOE_MIN_ROUTED = 0.95
# fine-tuning --moe-experts 8 at --ep 1: 8 seeded videos x 8 frames in
# batches of 32 (2 steps, 24 B3 launches a step)
MOE_TRAIN_VIDEOS, MOE_TRAIN_FRAMES, MOE_TRAIN_BATCH = 8, 8, 32
PP_MICROBATCHES = 4
PP_L14_STAGES = 4


def moe_config():
    c = get_config("openai/clip-vit-base-patch32")
    return dataclasses.replace(c, name=MOE, vision=dataclasses.replace(
        c.vision, moe_experts=MOE_EXPERTS, moe_every=MOE_EVERY,
        moe_capacity=MOE_CAPACITY))


def router_choices(model) -> tuple:
    """Forward hooks recording each MoE router's expert choice (the
    argmax of its logits), per layer; returns (choices, handles)."""
    choices, handles = {}, []
    for i, layer in enumerate(model.vision.layers):
        if hasattr(layer, "moe"):
            def hook(mod, inp, out, i=i):
                choices[i] = out.float().argmax(-1)
            handles.append(layer.moe.router.register_forward_hook(hook))
    return choices, handles


def traced_encode(fn, trace_dir: Path, tag: str, smi: str) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device-busy share
    of its window, its kernel launches and kernel time, and the eight
    kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = trace_dir / f"encode_{tag.replace(' ', '_')}.json"
    prof.export_chrome_trace(str(path))
    tr = read_trace(path)
    count = sum(c for c, _ in tr["kernels"].values())
    device_ms = sum(us for _, us in tr["kernels"].values()) / 1e3
    top = sorted(tr["kernels"].items(), key=lambda kv: -kv[1][1])[:8]
    log(f"[{tag} traced] window {tr['window_ms']:.1f} ms: device busy "
        f"{100 * tr['busy']:.1f}%, {count} kernel launches, "
        f"{device_ms:.2f} ms of kernel time; on {smi}")
    for name, (c, us) in top:
        log(f"[{tag} traced]   {us / 1e3:8.3f} ms  {c:5d} x  {name[:100]}")
    return {"busy_share": tr["busy"], "window_ms": tr["window_ms"],
            "kernel_launches": count, "kernel_ms": device_ms,
            "top8": [[n[:100], c, us / 1e3] for n, (c, us) in top]}


def compare_moe_tower(moe: CLIPEmbedder, sd: dict, dense: CLIPEmbedder,
                      seed: int, device, trace_dir: Path, smi: str,
                      b: int = 256) -> dict:
    """The MoE tower's 256-frame encode on the card (bf16, the module
    tower: B3 and cuBLAS, the expert products ``torch.bmm``) against the
    f32 module tower on the same weights with B3's plain version: per-row
    cosine and the share of tokens routed alike; timed beside the dense
    ViT-B/32 tower's module and fused encodes, and the MoE and dense
    module encodes traced."""
    frames = torch.from_numpy(seeded_frames(seed, 11_000, b)).to(device)
    ref = module_from(moe.cfg, sd, device).eval()
    got_r, h1 = router_choices(moe.params)
    want_r, h2 = router_choices(ref)
    with torch.inference_mode():
        zero_launches()
        got = moe._encode_image_fn(moe.params, frames)
        launches = WRAPPERS["attention"].launches
        with module_attention_plain():
            want = ref.encode_image(normalize_images(frames))
    for h in h1 + h2:
        h.remove()
    require(launches == moe.cfg.vision.num_layers,
            f"[moe] B3 launches {launches} in one encode")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    alike = torch.cat([(got_r[i] == want_r[i]).float() for i in want_r])
    out = {"min_cos": cos.min().item(), "mean_cos": cos.mean().item(),
           "routed_alike": alike.mean().item(),
           "moe_layers": len(want_r)}
    require(out["min_cos"] >= MIN_COS,
            f"[moe] tower vs f32 plain: min cosine {out['min_cos']}")
    require(out["routed_alike"] >= MOE_MIN_ROUTED,
            f"[moe] tokens routed alike {out['routed_alike']}")
    del ref
    with torch.inference_mode():
        pixels = normalize_images(frames, dtype=torch.bfloat16)
        out["ms"] = cuda_ms(lambda: moe._encode_image_fn(moe.params,
                                                         frames), 3)
        out["dense_module_ms"] = cuda_ms(
            lambda: dense.params.encode_image(pixels), 3)
        out["dense_fused_ms"] = cuda_ms(
            lambda: dense._encode_image_fn(dense.params, frames), 3)
        out["trace"] = traced_encode(
            lambda: moe._encode_image_fn(moe.params, frames), trace_dir,
            "moe encode", smi)
        out["dense_module_trace"] = traced_encode(
            lambda: dense.params.encode_image(pixels), trace_dir,
            "dense module encode", smi)
    log(f"[moe] {MOE} encode of {b} frames (bf16, module tower, B3 x "
        f"{launches}): min row cosine {out['min_cos']:.6f} (mean "
        f"{out['mean_cos']:.6f}) against the f32 plain tower (>= "
        f"{MIN_COS}); tokens routed alike {out['routed_alike']:.4f} over "
        f"{out['moe_layers']} MoE layers (>= {MOE_MIN_ROUTED}); {out['ms']:.3f} "
        f"ms = {b / out['ms'] * 1e3:.0f} frames/s; dense ViT-B/32 module "
        f"tower {out['dense_module_ms']:.3f} ms, fused "
        f"{out['dense_fused_ms']:.3f} ms")
    return out


def phase_moe_engine(dense: CLIPEmbedder, args, device, root: Path,
                     smi: str) -> dict:
    """A seeded bf16 engine serving ``MOE``: the tower checked against the
    f32 plain tower (``compare_moe_tower``), then grown and served as
    phase 9's engines (``serve_grown``: 2M rows, an ingest of 20 seeded
    videos through the module tower, B3 once a layer and embed batch; the
    searches over HTTP against the host exact top-10)."""
    register_config(MOE, moe_config)
    t0 = time.perf_counter()
    sd = clip_bridge.init_params(moe_config(),
                                 torch.Generator().manual_seed(args.seed))
    init_s = time.perf_counter() - t0
    moe = CLIPEmbedder(model_name=MOE, dtype=torch.bfloat16, device=device,
                       state_dict=sd)
    require(not moe._fused_vision, "[moe] the fused vision encode is on")
    experts = sum(p.numel() * p.element_size() for n, p in
                  moe.params.named_parameters() if ".moe.w" in n)
    log(f"[moe] {MOE}: seeded init {init_s:.1f} s; expert weights "
        f"{experts / 1e6:.1f} MB (bf16)")
    out = {"tower": compare_moe_tower(moe, sd, dense, args.seed, device,
                                      root, smi),
           "init_s": init_s}
    del sd
    config = EngineConfig()
    config.model.name = MOE
    config.index.device_dtype = "bfloat16"
    videos = root / "videos-moe"
    engine = VideoSearchEngine(videos, config=config, embedder=moe,
                               device=device)
    require_seeded("moe", engine)
    out.update(serve_grown("moe", engine, moe, args, device, smi, videos,
                           np.random.default_rng(args.seed + 11),
                           path=("attention",)))
    del engine, moe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe_train(args, device, root: Path, smi: str) -> dict:
    """``python -m video_quierer_tpu_torch.train.finetune --moe-experts 8``
    at ``--ep 1`` on the card (its ``main``, the decode replaced by seeded
    frames as phase 10's): 2 steps at B = 32 on ViT-B/32, B3 24 times a
    step and nothing else; then an engine with ``model.name`` = ``MOE``
    and ``model.orbax_checkpoint`` = the saved step serves it: its image
    and text vectors against the f32 module tower on the saved
    parameters, and 8 searches over 4,000 seeded rows against the host
    exact top-10."""
    from video_quierer_tpu_torch.train import finetune
    vdir, out_dir = root / "videos-moe-train", root / "ckpt-moe"
    vdir.mkdir(parents=True, exist_ok=True)
    for v in range(MOE_TRAIN_VIDEOS):
        (vdir / f"clip_{v:02d}_{words(np.random.default_rng(v), 2)}.mp4"
         .replace(" ", "_")).write_bytes(b"seeded frames")

    def seeded(path, *, max_frames, sampling_mode, target_size):
        v = int(Path(path).stem.split("_")[1])
        return (seeded_frames(args.seed, 41_000 + v, max_frames),
                [k / FPS for k in range(max_frames)])

    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logging.getLogger("vqt.finetune").addHandler(handler)
    # the CLI's logging.basicConfig: undone afterwards
    root_log = logging.getLogger()
    saved = root_log.level, list(root_log.handlers)
    real = ingest_frames.extract_frames
    ingest_frames.extract_frames = seeded
    zero_launches()
    t0 = time.perf_counter()
    try:
        rc = finetune.main([
            "--videos-dir", str(vdir), "--out", str(out_dir),
            "--moe-experts", str(MOE_EXPERTS), "--moe-every",
            str(MOE_EVERY), "--moe-capacity", str(MOE_CAPACITY), "--ep",
            "1", "--batch", str(MOE_TRAIN_BATCH), "--max-frames-per-video",
            str(MOE_TRAIN_FRAMES), "--lr", str(TRAIN_LR), "--seed",
            str(args.seed), "--device", str(device)])
        torch.cuda.synchronize()
    finally:
        ingest_frames.extract_frames = real
        logging.getLogger("vqt.finetune").removeHandler(handler)
        root_log.setLevel(saved[0])
        root_log.handlers[:] = saved[1]
    wall = time.perf_counter() - t0
    steps = MOE_TRAIN_VIDEOS * MOE_TRAIN_FRAMES // MOE_TRAIN_BATCH
    launches = read_launches("moe train", TRAIN_LAUNCHES * steps)
    summary = [r for r in records if r.startswith("steps:")]
    require(rc == 0 and summary and summary[0].startswith(f"steps: {steps}"),
            f"[moe train] finetune rc {rc}, log {records}")
    losses = [float(x) for x in re.findall(r"loss: ([-\d.naif]+)",
                                           summary[0])]
    require(len(losses) == 2 and all(np.isfinite(losses)),
            f"[moe train] losses {losses}")
    path = out_dir / f"step_{steps}"
    log(f"[moe train] finetune --moe-experts {MOE_EXPERTS} --ep 1 on the "
        f"card: {steps} steps at B={MOE_TRAIN_BATCH} (ViT-B/32 widths), "
        f"first loss {losses[0]:.4f}, last {losses[1]:.4f}; {wall:.1f} s "
        f"with the seeded init and the save; launches {launches}; "
        f"checkpoint {path.name}")
    params = train_ckpt.load_params(path)
    v = moe_config().vision
    require(params["vision.layers.1.moe.w1"].shape
            == (MOE_EXPERTS, v.hidden_size,
                       v.hidden_size * v.mlp_ratio),
            "[moe train] expert stack shape")
    config = EngineConfig()
    config.model.name = MOE
    config.model.orbax_checkpoint = str(path)
    config.index.device_dtype = "bfloat16"
    engine = VideoSearchEngine(root / "videos-moe-trained", config=config,
                               device=device)
    t0 = time.perf_counter()
    tower = engine._tower()
    load_s = time.perf_counter() - t0
    require(engine.stats()["pretrained"] is True, "[moe trained] pretrained")
    ref = module_from(tower.cfg, params, device).eval()
    frames = seeded_frames(args.seed, 51_000, 32)
    ids = tower.prepare_text_ids(tower.tokenizer(list(SERVE_TEXTS)))
    with torch.inference_mode():
        img = ref.encode_image(normalize_images(
            torch.from_numpy(frames).to(device)))
        txt = ref.encode_text(tower.ids_tensor(ids))
    cos = {}
    for name, got, want in (
            ("image", tower.embed_frames(frames), img),
            ("text", tower.embed_texts(list(SERVE_TEXTS)), txt)):
        cos[name] = torch.nn.functional.cosine_similarity(
            torch.from_numpy(got), want.cpu(), dim=-1).min().item()
        require(cos[name] >= MIN_COS,
                f"[moe trained] {name} vectors: min cosine {cos[name]}")
    del ref, params
    engine.startup()
    rows = corpus_on_card_rows(device, args.seed + 12,
                               SERVE_VIDEOS * SERVE_FRAMES, DIM)
    stamps = [0.5 * t for t in range(SERVE_FRAMES)]
    for v in range(SERVE_VIDEOS):
        engine.index.add_batch(rows[v * SERVE_FRAMES:(v + 1) * SERVE_FRAMES],
                               video_name(v), stamps)
    rng = np.random.default_rng(args.seed + 12)
    queries = [words(rng, 4) for _ in range(8)]
    zero_launches()
    served = [engine.search_ex(q, k=K, use_cache=False)[0] for q in queries]
    search_launches = {k: w.launches for k, w in WRAPPERS.items() if
                       w.launches}
    err = check_exact(engine.index._emb[: len(engine.index)],
                      lambda row: video_name(row // SERVE_FRAMES),
                      np.stack([tower.embed_text(q) for q in queries]),
                      served)
    engine.close()
    log(f"[moe trained] engine tower ({MOE}) from {path.name} in "
        f"{load_s:.2f} s; pretrained: true; min row cosine against the f32 "
        f"module tower on the saved parameters: image {cos['image']:.6f}, "
        f"text {cos['text']:.6f} (>= {MIN_COS}, bf16 serving); 8 searches "
        f"over {len(rows)} rows equal the host exact top-{K} (max score "
        f"error {err:.2e}); launches {search_launches}; on {smi}")
    del engine, tower, rows
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "wall_s": wall, "launches": launches,
            "load_s": load_s, "min_cos": cos,
            "search_launches": search_launches}


def phase_pp_engine(dense: CLIPEmbedder, args, device, root: Path,
                    smi: str) -> dict:
    """A ViT-B/32 engine with ``model.parallel = "pp"`` and
    ``pipeline_microbatches = 4`` that builds its own seeded bf16 tower:
    one stage on the one card; its 256-frame encode against the dense
    module tower (the same seeded weights as phase 3's embedder) and
    timed beside it; then grown and served as phase 9's engines (B3 M · L
    = 48 times an embed batch), rows against the host exact top-10."""
    config = EngineConfig()
    config.model.parallel = "pp"
    config.model.pipeline_microbatches = PP_MICROBATCHES
    config.index.device_dtype = "bfloat16"
    videos = root / "videos-pp"
    engine = VideoSearchEngine(videos, config=config, device=device)
    tower = engine._tower()
    require_seeded("pp", engine)
    stages = tower._pipe_stages
    layers = tower.cfg.vision.num_layers
    require(tuple(st.device for st in stages) == pipe_devices(depth=layers)
            and stages[0].device == device and not tower._fused_vision,
            f"[pp] stages {[(st.device, len(st.layers)) for st in stages]}")
    frames = torch.from_numpy(seeded_frames(args.seed, 12_000, 256)).to(
        device)
    with torch.inference_mode():
        zero_launches()
        got = tower._encode_image_fn(tower.params, frames)
        launches = WRAPPERS["attention"].launches
        pixels = normalize_images(frames, dtype=torch.bfloat16)
        want = dense.params.encode_image(pixels)
        ms = cuda_ms(lambda: tower._encode_image_fn(tower.params, frames), 3)
        module_ms = cuda_ms(lambda: dense.params.encode_image(pixels), 3)
        trace = traced_encode(
            lambda: tower._encode_image_fn(tower.params, frames), root,
            "pp encode", smi)
    require(launches == PP_MICROBATCHES * layers,
            f"[pp] B3 launches {launches} in one encode")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    require(cos.min().item() >= MIN_COS, f"[pp] min cosine {cos.min()}")
    log(f"[pp] ViT-B/32 pipelined encode of 256 frames, {len(stages)} "
        f"stage(s) x {layers // len(stages)} layers, M={PP_MICROBATCHES} "
        f"(B3 x {launches} = M·L): min row cosine {cos.min().item():.6f} "
        f"against the sequential module tower; {ms:.3f} ms (module tower "
        f"{module_ms:.3f} ms)")
    out = {"stages": len(stages), "encode_launches": launches, "ms": ms,
           "module_ms": module_ms, "min_cos": cos.min().item(),
           "trace": trace}
    out.update(serve_grown("pp", engine, tower, args, device, smi, videos,
                           np.random.default_rng(args.seed + 13),
                           path=("attention",),
                           per_batch=PP_MICROBATCHES * layers))
    del engine, tower
    gc.collect()
    torch.cuda.empty_cache()
    return out


def compare_pp_l14(l14: CLIPEmbedder, seed: int, device,
                   b: int = 256) -> dict:
    """ViT-L/14's ``pipelined_encode_image`` over PP_L14_STAGES stages on
    the one card (M = 4, one 256-frame batch) against its sequential
    module tower: per-row cosine, both timed, B3's launches (M · L = 96)."""
    from video_quierer_tpu_torch.parallel.pipeline import (
        pipelined_encode_image,
        shard_layers,
    )
    model = l14.params
    stages = shard_layers(model.vision.layers, [device] * PP_L14_STAGES)
    frames = torch.from_numpy(seeded_frames(seed, 13_000, b)).to(device)
    layers = l14.cfg.vision.num_layers
    with torch.inference_mode():
        pixels = normalize_images(frames, dtype=l14.dtype)

        def pp():
            return pipelined_encode_image(model, pixels, stages=stages,
                                          n_microbatches=PP_MICROBATCHES)

        zero_launches()
        got = pp()
        launches = WRAPPERS["attention"].launches
        want = model.encode_image(pixels)
        ms = cuda_ms(pp, 3)
        seq_ms = cuda_ms(lambda: model.encode_image(pixels), 3)
    require(launches == PP_MICROBATCHES * layers,
            f"[pp l14] B3 launches {launches}")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    require(cos.min().item() >= MIN_COS, f"[pp l14] min cosine {cos.min()}")
    log(f"[pp l14] ViT-L/14 pipelined encode, {b} frames over "
        f"{PP_L14_STAGES} stages on {device} x {layers // PP_L14_STAGES} "
        f"layers, M={PP_MICROBATCHES} (B3 x {launches} = M·L): min row "
        f"cosine {cos.min().item():.6f} against the sequential module "
        f"tower; {ms:.3f} ms (sequential {seq_ms:.3f} ms)")
    return {"launches": launches, "ms": ms, "sequential_ms": seq_ms,
            "min_cos": cos.min().item()}


def compare_pp_cards(l14: CLIPEmbedder, seed: int, n_cards: int,
                     b: int = 256) -> dict:
    """ViT-L/14's ``pipelined_encode_image`` over ``n_cards`` cards (stage
    ``s`` on ``cuda:s``, M = 4 and 8) against its sequential module tower
    on ``cuda:0``, one 256-frame batch: per-row cosine, times, B3's
    launches. The vision layers move to their cards, so the sequential
    encode runs first."""
    from video_quierer_tpu_torch.parallel.pipeline import (
        pipelined_encode_image,
        shard_layers,
    )
    require(torch.cuda.device_count() >= n_cards,
            f"{n_cards} cards asked for, {torch.cuda.device_count()} seen")
    model, dev0 = l14.params, torch.device("cuda", 0)
    frames = torch.from_numpy(seeded_frames(seed, 13_000, b)).to(dev0)
    layers = l14.cfg.vision.num_layers
    out = {"cards": n_cards}
    with torch.inference_mode():
        pixels = normalize_images(frames, dtype=l14.dtype)
        want = model.encode_image(pixels)
        out["sequential_ms"] = cuda_ms(lambda: model.encode_image(pixels), 3)
        stages = shard_layers(model.vision.layers,
                              [torch.device("cuda", i)
                               for i in range(n_cards)])
        for m in (PP_MICROBATCHES, 2 * PP_MICROBATCHES):
            def pp():
                return pipelined_encode_image(model, pixels, stages=stages,
                                              n_microbatches=m)

            zero_launches()
            got = pp()
            launches = WRAPPERS["attention"].launches
            require(launches == m * layers, f"[pp cards] B3 {launches}")
            cos = torch.nn.functional.cosine_similarity(
                got, want, dim=-1).min().item()
            require(cos >= MIN_COS, f"[pp cards] min cosine {cos}")
            ms = cuda_ms(pp, 3)
            out[f"m{m}"] = {"ms": ms, "launches": launches, "min_cos": cos}
            log(f"[pp cards] ViT-L/14 pipelined encode, {b} frames over "
                f"{n_cards} cards x {layers // n_cards} layers, M={m} (B3 x "
                f"{launches}): min row cosine {cos:.6f} against the "
                f"sequential module tower on cuda:0; {ms:.3f} ms "
                f"(sequential {out['sequential_ms']:.3f} ms)")
    return out


def phase_towers(dense: CLIPEmbedder, l14: CLIPEmbedder, args, device,
                 smi: str) -> dict:
    """Phase 11: the MoE engine, MoE fine-tuning and its checkpoint
    served, the ``pp`` engine, and ViT-L/14 pipelined over 4 stages."""
    scratch = ROOT / "build" / "smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=scratch) as root:
        root = Path(root)
        with timed("11, MoE engine"):
            out["moe"] = phase_moe_engine(dense, args, device, root, smi)
        with timed("11, MoE fine-tuning"):
            out["moe_train"] = phase_moe_train(args, device, root, smi)
        with timed("11, pp engine"):
            out["pp"] = phase_pp_engine(dense, args, device, root, smi)
        with timed("11, ViT-L/14 pipelined"):
            out["pp_l14"] = compare_pp_l14(l14, args.seed, device)
    return out


def tower_launches(tw: dict) -> dict:
    """Phase 11's launches of B1, B2 and B3, by path, for the kernels
    line."""
    moe, pp = tw["moe"], tw["pp"]
    out = {}
    for name, key in (("cand_scan_prefix", "cand_scan_prefix"),
                      ("fused_text_layer", "fused_layer"),
                      ("attention", "attention")):
        out[name] = {"moe_search": moe["launches"][key],
                     "moe_ingest": moe["ingest"]["launches"][key],
                     "pp_search": pp["launches"][key],
                     "pp_ingest": pp["ingest"]["launches"][key],
                     "moe_trained_search":
                         tw["moe_train"]["search_launches"].get(key, 0)}
    out["attention"].update(
        moe_train=tw["moe_train"]["launches"]["attention"],
        pp_encode=pp["encode_launches"],
        l14_pp_encode=tw["pp_l14"]["launches"])
    return out


# -- phase 12: serving across cards -------------------------------------------

# the data mesh on the one card: [cuda:0] x DATA_PARTS, so a 256-frame
# batch is four 64-frame parts (B5 + B6 each) and a batch of 64 texts four
# parts of 16 (B2 each, at 10-word queries: S = 16, 16 x 16 = MIN_TOKENS)
DATA_PARTS = 4
DATA_WORDS = 10
# the multi-process half: the tiers each process serves, its searches
HOST_TIERS = ("bfloat16", "int8", "float32")
HOST_SCANS = {"bfloat16": "cand_scan", "int8": "cand_scan_int8",
              "float32": "block_scan"}
HOST_SINGLES = 16
HOST_BATCH_ROUNDS = 3
# a child's rendezvous or collective that takes longer raises; a child
# that takes longer than HOST_RUN_S is killed and fails the run
HOST_COLLECTIVE_S = 300
HOST_RUN_S = 900
# the videos each process ingests onto the cache's corpus
HOST_INGEST_VIDEOS = 2


def part_launches(tag: str, names: tuple, parts: int, layers: int) -> dict:
    """The launches since ``zero_launches``: each of ``names`` ``layers``
    times a part, nothing else; returns them a part."""
    got = {name: w.launches for name, w in WRAPPERS.items()}
    for name, count in got.items():
        want = parts * layers if name in names else 0
        require(count == want, f"[{tag}] {name} launched {count} times, not "
                f"{want} ({layers} a part x {parts} parts)")
    return {name: got[name] // parts for name in names}


def compare_data_mesh(tower: CLIPEmbedder, dense: CLIPEmbedder, seed: int,
                      device, rng) -> dict:
    """The data-mesh tower against the meshless fused one (the same
    weights) and the f32 plain tower: 256 seeded frames in DATA_PARTS
    parts (B5 + B6 a part), a batch of 64 texts in DATA_PARTS parts (B2 a
    part); launches a part; both encodes timed against the meshless ones
    (CUDA events)."""
    layers = tower.cfg.vision.num_layers
    frames = torch.from_numpy(seeded_frames(seed, 13_000, 256)).to(device)
    texts = [words(rng, DATA_WORDS) for _ in range(64)]
    ids = tower.ids_tensor(tower.prepare_text_ids(tower.tokenizer(texts)))
    require(ids.shape[1] == 16, f"[data mesh] text bucket {ids.shape}")
    with torch.inference_mode():
        zero_launches()
        got = tower._encode_image_mesh(frames)
        torch.cuda.synchronize()
        vision = part_launches("data mesh vision", INGEST, DATA_PARTS,
                               layers)
        zero_launches()
        got_t = tower.text_encode_fn(tower.params, ids)
        torch.cuda.synchronize()
        text = part_launches("data mesh text", ("fused_layer",),
                             DATA_PARTS, tower.cfg.text.num_layers)
        want = dense._encode_image_fn(dense.params, frames)
        want_t = dense.text_encode_fn(dense.params, ids)
        ref = module_from(tower.cfg, {k: v.float() for k, v in
                                      tower.params.state_dict().items()},
                          device).eval()
        with module_attention_plain():
            plain = ref.encode_image(normalize_images(frames))
            plain_t = ref.encode_text(ids)
        del ref
        cos = torch.nn.functional.cosine_similarity
        out = {"parts": DATA_PARTS, "vision_launches_a_part": vision,
               "text_launches_a_part": text,
               "vision_vs_meshless_max_abs": (got - want).abs().max().item(),
               "vision_vs_meshless_min_cos": cos(got, want, dim=-1).min()
               .item(),
               "vision_vs_plain_f32_min_cos": cos(got, plain, dim=-1).min()
               .item(),
               "text_vs_meshless_min_cos": cos(got_t, want_t, dim=-1).min()
               .item(),
               "text_vs_plain_f32_min_cos": cos(got_t, plain_t, dim=-1).min()
               .item()}
        require(out["vision_vs_meshless_min_cos"] >= DATA_MESH_MIN_COS
                and out["text_vs_meshless_min_cos"] >= DATA_MESH_MIN_COS,
                f"[data mesh] against the meshless tower {out}")
        require(out["vision_vs_plain_f32_min_cos"] >= MIN_COS
                and out["text_vs_plain_f32_min_cos"] >= MIN_COS,
                f"[data mesh] against the f32 plain tower {out}")
        out["vision_ms"] = cuda_ms(lambda: tower._encode_image_mesh(frames),
                                   3)
        out["vision_meshless_ms"] = cuda_ms(
            lambda: dense._encode_image_fn(dense.params, frames), 3)
        out["text_ms"] = cuda_ms(
            lambda: tower.text_encode_fn(tower.params, ids), 5)
        out["text_meshless_ms"] = cuda_ms(
            lambda: dense.text_encode_fn(dense.params, ids), 5)
    log(f"[data mesh] {DATA_PARTS} parts on {device}: 256 frames, B5 "
        f"{vision['attn_half']} and B6 {vision['mlp_half']} launches a part; "
        f"64 texts (S = 16), B2 {text['fused_layer']} a part; rows against "
        f"the meshless tower: vision min cosine "
        f"{out['vision_vs_meshless_min_cos']:.7f} (max |diff| "
        f"{out['vision_vs_meshless_max_abs']:.2e}), text "
        f"{out['text_vs_meshless_min_cos']:.7f} (>= {DATA_MESH_MIN_COS}); "
        f"against the f32 plain tower: vision "
        f"{out['vision_vs_plain_f32_min_cos']:.6f}, text "
        f"{out['text_vs_plain_f32_min_cos']:.6f} (>= {MIN_COS}); encode ms "
        f"(CUDA events): vision {out['vision_ms']:.3f} against "
        f"{out['vision_meshless_ms']:.3f} meshless, text "
        f"{out['text_ms']:.3f} against {out['text_meshless_ms']:.3f}")
    return out


def phase_data_mesh(dense: CLIPEmbedder, args, device, smi: str) -> dict:
    """Phase 12's one-card half: a ``data_mesh`` of DATA_PARTS x the card,
    the tower checked (``compare_data_mesh``), then an engine built with
    ``mesh=`` (its own seeded tower, the weights of ``dense``) grown and
    served as phase 9's engines: the 2M-row corpus drawn on the card, an
    ingest (B5 and B6 DATA_PARTS x 12 times an embed batch), 16 singles,
    64 coalesced clients and a batch of 64 over HTTP, rows against the
    host exact top-10."""
    scratch = ROOT / "build" / "smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    mesh = data_mesh(devices=[device] * DATA_PARTS)
    with tempfile.TemporaryDirectory(dir=scratch) as videos:
        config = EngineConfig()
        config.index.device_dtype = "bfloat16"
        engine = VideoSearchEngine(videos, config=config, device=device,
                                   mesh=mesh)
        tower = engine._tower()
        require_seeded("data mesh", engine)
        require(tower.mesh is mesh and tower._fused_vision,
                f"[data mesh] tower mesh {tower.mesh}")
        require_same_params("data mesh", tower.params, dense.params)
        out = compare_data_mesh(tower, dense, args.seed, device,
                                np.random.default_rng(args.seed + 17))
        out.update(serve_grown(
            "data mesh", engine, tower, args, device, smi, Path(videos),
            np.random.default_rng(args.seed + 19),
            per_batch=DATA_PARTS * tower.cfg.vision.num_layers,
            n_words=DATA_WORDS))
        del engine, tower
    gc.collect()
    torch.cuda.empty_cache()
    return out


class GatherTimer:
    """CUDA events around every ``torch.distributed.all_gather`` while
    active (the corpus mesh's cross-process merge makes one a search)."""

    def __init__(self):
        self.pairs = []
        self._real = None

    def __enter__(self):
        self._real = torch.distributed.all_gather

        def timed_gather(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._real(*a, **kw)
            end.record()
            self.pairs.append((start, end))
            return out
        torch.distributed.all_gather = timed_gather
        return self

    def __exit__(self, *exc):
        torch.distributed.all_gather = self._real

    def take(self) -> list:
        """The ms of each gather since the last ``take``."""
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in self.pairs]
        self.pairs = []
        return ms


def host_ingest(engine: VideoSearchEngine, args) -> int:
    """HOST_INGEST_VIDEOS seeded videos through ``batched_frames`` and the
    engine's ingest loop (the same frames on every process; no file is
    written in the shared videos dir)."""
    paths = [Path(engine.videos_dir) / ingest_name(v)
             for v in range(HOST_INGEST_VIDEOS)]
    api, ing = engine.config.api, engine.config.ingest
    extract = functools.partial(seeded_extract, seed=args.seed,
                                n=args.frames, mode=api.sampling_mode)
    with engine.lock:
        return engine._ingest_batches(paths, batched_frames(
            paths, max_frames=args.frames, sampling_mode=api.sampling_mode,
            batch_size=ing.batch_size, num_workers=ing.num_decode_workers,
            prefetch=ing.prefetch_videos, extract_fn=extract))


def host_tier(dtype: str, videos: Path, embedder: CLIPEmbedder, args,
              device, timer: GatherTimer) -> dict:
    """One tier on this process: an engine from the shared cache through
    the config path (``corpus_shards`` = the cards of every process,
    ``corpus_slices`` = the processes), an ingest, HOST_SINGLES singles
    and HOST_BATCH_ROUNDS batches of 64 (the same queries on every
    process), the launches and the gathers' ms. Rank 0 holds every
    process's rows against its own and against the host exact top-10."""
    dist = torch.distributed
    rank, procs = dist.get_rank(), dist.get_world_size()
    config = EngineConfig()
    config.index.device_dtype = dtype
    config.index.corpus_shards = torch.cuda.device_count() * procs
    config.index.corpus_slices = procs
    engine = VideoSearchEngine(str(videos), config=config, embedder=embedder,
                               device=device)
    mesh = engine.index.mesh
    require(mesh.multiprocess and mesh.process_count == procs
            and mesh.n_local == torch.cuda.device_count(),
            f"[hosts {dtype}] mesh {mesh}")
    t0 = time.perf_counter()
    engine.startup()
    startup_s = time.perf_counter() - t0
    n_base = args.videos * args.frames
    require(len(engine.index) == n_base, f"[hosts {dtype}] startup rows")
    t0 = time.perf_counter()
    added = host_ingest(engine, args)
    ingest_s = time.perf_counter() - t0
    require(added == HOST_INGEST_VIDEOS * args.frames, "host ingest rows")
    rng = np.random.default_rng(args.seed + 23)
    singles = [words(rng, 4) for _ in range(HOST_SINGLES)]
    batch = [words(rng, 4) for _ in range(64)]
    timer.take()
    zero_launches()
    single_rows, lat, gather1 = [], [], []
    for q in singles:
        t0 = time.perf_counter()
        rows, _ = engine.search_ex(q, k=K, use_cache=False)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        single_rows.append(rows)
        gather1 += timer.take()
    batch_rows, blat, gather64 = None, [], []
    for _ in range(HOST_BATCH_ROUNDS):
        t0 = time.perf_counter()
        rows = engine.search_batch(batch, k=K)
        torch.cuda.synchronize()
        blat.append(time.perf_counter() - t0)
        gather64 += timer.take()
        require(batch_rows is None or rows == batch_rows,
                f"[hosts {dtype}] batch rounds disagree")
        batch_rows = rows
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    require(len(gather1) == HOST_SINGLES
            and len(gather64) == HOST_BATCH_ROUNDS,
            f"[hosts {dtype}] gathers {len(gather1)}, {len(gather64)}")
    check_launches(f"hosts {dtype} rank {rank}", engine, launches,
                   HOST_SCANS[dtype])
    out = {"startup_s": startup_s, "ingest_s": ingest_s,
           "single_p50_ms": 1e3 * float(np.median(lat)),
           "batch_p50_ms": 1e3 * float(np.median(blat)),
           "gather_ms_b1_p50": float(np.median(gather1)),
           "gather_ms_b64_p50": float(np.median(gather64)),
           "launches": {k: v for k, v in launches.items() if v}}
    served = (singles, single_rows, batch, batch_rows)
    everyone = [None] * procs
    dist.all_gather_object(everyone, (out, single_rows, batch_rows))
    if rank == 0:
        for r, (_, s_rows, b_rows) in enumerate(everyone):
            require(s_rows == single_rows and b_rows == batch_rows,
                    f"[hosts {dtype}] rank {r}'s rows differ from rank 0's")
        corpus = engine.index._emb[: len(engine.index)]

        def name_of(row: int) -> str:
            if row < n_base:
                return video_name(row // args.frames)
            return ingest_name((row - n_base) // args.frames)

        check_served(dtype, embedder, corpus, name_of, served, device,
                     tag=f"hosts {dtype}")
        log(f"[hosts {dtype}] every one of {procs} processes returned the "
            f"same rows")
    engine.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"ranks": [o for o, _, _ in everyone]}


def gather_alone(timer: GatherTimer, device, iters: int = 20) -> dict:
    """The merge's collective alone: an ``all_gather`` of the bf16 tier's
    ``[1, B, 2, 128]`` int32 buffer at B = 1 and 64, every one started
    right after a barrier and a synchronise (so the wait for a slower
    process, which the searches' gathers include, is left out); p50 ms."""
    dist = torch.distributed
    out = {}
    for b in (1, 64):
        buf = torch.zeros((1, b, 2, 128), dtype=torch.int32, device=device)
        got = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
        ms = []
        for i in range(iters + 3):
            dist.barrier()
            torch.cuda.synchronize()
            dist.all_gather(got, buf)
            taken = timer.take()
            if i >= 3:                  # three warm-up gathers
                ms += taken
        out[f"b{b}_p50_ms"] = float(np.median(ms))
    return out


def host_child(args) -> int:
    """One process of ``--hosts N`` (``VQT_COORDINATOR``,
    ``VQT_NUM_PROCESSES``, ``VQT_PROCESS_ID`` and ``CUDA_VISIBLE_DEVICES``
    set by the parent): every tier over the shared cache in
    ``args.host_child``; rank 0 writes the summary beside it."""
    logging.basicConfig(level=logging.WARNING)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    require(initialize_distributed(device, timeout_s=HOST_COLLECTIVE_S),
            "VQT_COORDINATOR is not set")
    rank = torch.distributed.get_rank()
    kernels.lib()                       # built by the parent's phase 2
    embedder = CLIPEmbedder(dtype=torch.bfloat16, device=device,
                            seed=args.seed)
    out = {}
    try:
        with GatherTimer() as timer:
            for dtype in HOST_TIERS:
                t0 = time.perf_counter()
                out[dtype] = host_tier(dtype, args.host_child, embedder,
                                       args, device, timer)
                out[dtype]["seconds"] = time.perf_counter() - t0
                log(f"[hosts {dtype}] rank {rank}: "
                    + json.dumps(out[dtype]["ranks"][rank]))
            alone = [None] * torch.distributed.get_world_size()
            torch.distributed.all_gather_object(alone,
                                                gather_alone(timer, device))
            out["gather_alone"] = alone
        if rank == 0:
            (args.host_child / "summary.json").write_text(json.dumps(out))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_hosts(n_hosts: int, args, device, smi: str) -> dict:
    """Phase 12's multi-process half: one 2M-row x 512 pickle v1.0 cache
    (drawn on the card, written once), then ``n_hosts`` processes of
    ``chip_smoke.py --host-child``, each on its own visible cards with
    ``VQT_COORDINATOR``, ``VQT_NUM_PROCESSES`` and ``VQT_PROCESS_ID`` set;
    a failed or timed-out child fails the phase."""
    cards = torch.cuda.device_count()
    require(n_hosts >= 2 and cards % n_hosts == 0,
            f"--hosts {n_hosts} over {cards} visible cards")
    per = cards // n_hosts
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = (visible.split(",") if visible else
           [str(i) for i in range(cards)])
    scratch = ROOT / "build" / "smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    n = args.videos * args.frames
    with tempfile.TemporaryDirectory(dir=scratch) as videos:
        videos = Path(videos)
        t0 = time.perf_counter()
        corpus = corpus_on_card_rows(device, args.seed + 21, n, DIM)
        write_cache(corpus, args.frames, videos / "video_search_cache.pkl")
        del corpus
        log(f"[hosts] cache of {n} rows x {DIM} written in "
            f"{time.perf_counter() - t0:.1f} s")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs, logs = [], []
        for rank in range(n_hosts):
            env = dict(os.environ, VQT_COORDINATOR=f"127.0.0.1:{port}",
                       VQT_NUM_PROCESSES=str(n_hosts),
                       VQT_PROCESS_ID=str(rank),
                       CUDA_VISIBLE_DEVICES=",".join(
                           ids[rank * per:(rank + 1) * per]))
            logs.append(open(videos.parent / f"host-{port}-{rank}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--host-child", str(videos), "--seed", str(args.seed),
                 "--videos", str(args.videos), "--frames",
                 str(args.frames)], cwd=ROOT, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        try:
            for p in procs:
                p.wait(timeout=max(1.0, HOST_RUN_S
                                   - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        for rank, f in enumerate(logs):
            f.seek(0)
            text = f.read()
            f.close()
            os.unlink(f.name)
            tail = text if rank == 0 or codes[rank] else text[-2000:]
            log(f"---- host process {rank} (exit {codes[rank]}) ----\n"
                + tail.rstrip())
        require(all(c == 0 for c in codes),
                f"[hosts] a process failed: exit codes {codes}")
        summary = json.loads((videos / "summary.json").read_text())
    summary["processes"], summary["cards_each"] = n_hosts, per
    log(f"[hosts] {n_hosts} processes x {per} card(s) on {smi}: " + ", ".join(
        f"{d}: single p50 "
        + "/".join(f"{r['single_p50_ms']:.2f}" for r in summary[d]["ranks"])
        + " ms, batch of 64 p50 "
        + "/".join(f"{r['batch_p50_ms']:.2f}" for r in summary[d]["ranks"])
        + " ms, all_gather p50 at B = 1 "
        + "/".join(f"{r['gather_ms_b1_p50']:.4f}"
                   for r in summary[d]["ranks"])
        + " ms, at B = 64 "
        + "/".join(f"{r['gather_ms_b64_p50']:.4f}"
                   for r in summary[d]["ranks"]) + " ms"
        for d in HOST_TIERS) + " (per rank); the all_gather alone, after a "
        "barrier, p50 at B = 1 "
        + "/".join(f"{r['b1_p50_ms']:.4f}" for r in summary["gather_alone"])
        + " ms, at B = 64 "
        + "/".join(f"{r['b64_p50_ms']:.4f}" for r in summary["gather_alone"])
        + " ms")
    return summary


def data_mesh_launches(dm: dict, hosts) -> dict:
    """Phase 12's launches for the kernels line: B5, B6 and B2 a data-mesh
    part; the data-mesh engine's ingest (B5, B6) and searches (B1, B2,
    B3); with the processes' half, each process's scans (B10, B11, B8) in
    each tier."""
    out = {"attn_half": {"a_part": dm["vision_launches_a_part"]["attn_half"],
                         "ingest": dm["ingest"]["launches"]["attn_half"]},
           "mlp_half": {"a_part": dm["vision_launches_a_part"]["mlp_half"],
                        "ingest": dm["ingest"]["launches"]["mlp_half"]},
           "fused_text_layer": {
               "a_part": dm["text_launches_a_part"]["fused_layer"],
               "search": dm["launches"]["fused_layer"]},
           "attention": {"search": dm["launches"]["attention"]},
           "cand_scan_prefix": {"search": dm["launches"]["cand_scan_prefix"]}}
    if hosts is not None:
        for dtype, scan in HOST_SCANS.items():
            out.setdefault(scan, {})[f"processes_{dtype}"] = [
                r["launches"].get(scan, 0) for r in hosts[dtype]["ranks"]]
    return out


# -- phase 13: training meshes ------------------------------------------------

# the one-card mesh: [cuda:0] x 4 as (data 2, model 2) or (data 2, expert 2)
MESH_DATA, MESH_PARTS = 2, 2
MESH_STEPS = 3
MESH_SIGLIP_B = 32
# each mesh's first step against the one-device trainer from the same seed
# on the same batch: the loss (rtol by dtype) and, in f32, every gradient
# element by element (rtol, atol)
MESH_LOSS_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
MESH_GRAD_TOL = (1e-4, 1e-6)
# B3 under autograd at a mesh part's shapes: a data row of 32 frames, 6 of
# the vision tower's 12 heads; 4 of the text tower's 8
MESH_ATTN_SHAPES = ((32, 50, 6, False), (32, 77, 4, True))
# the analogue of the JAX package's dryrun_multichip (its training half):
# tiny towers whose heads are the kernel's 64 wide
DRYRUN_CLIP, DRYRUN_IMAGE, DRYRUN_CONTEXT, DRYRUN_B = \
    "train-mesh-tiny", 32, 16, 8


def mesh_b3_per_step(cfg, mesh) -> int:
    """B3's launches a mesh step implies: every data row runs every layer
    of both towers, once a part of a ``model`` axis (each part its own
    heads) and once on an ``expert`` mesh (attention unsplit)."""
    parts = len(mesh.grid[0]) if mesh.axis == "model" else 1
    return len(mesh.grid) * parts * (cfg.vision.num_layers
                                     + cfg.text.num_layers)


def moe_drop_hooks(model) -> tuple:
    """Forward hooks on a one-device tower's MoE layers recording the
    tokens each drops (its routing recomputed from the layer's input), in
    layer order; returns (drops, handles)."""
    from video_quierer_tpu_torch.parallel import moe as moe_mod
    drops, handles = [], []

    def hook(layer, inputs, _):
        x = inputs[0]
        n = x.shape[0] * x.shape[1]
        probs = torch.softmax(layer.router(x.reshape(n, -1).float()), -1)
        keep = moe_mod.route(probs, moe_mod.capacity(
            n, layer.num_experts, layer.capacity_factor))[3]
        drops.append(int((~keep).sum()))

    for m in model.modules():
        if isinstance(m, moe_mod.SwitchMoEMLP):
            handles.append(m.register_forward_hook(hook))
    return drops, handles


def mesh_grads_gap(got: dict, want: dict, tag: str) -> float:
    """Every gradient element within MESH_GRAD_TOL of the one-device
    trainer's; returns the largest ``|got - want| - rtol |want|``."""
    rtol, atol = MESH_GRAD_TOL
    require(got.keys() == want.keys(), f"[{tag}] gradient names")
    worst = 0.0
    for name, w in want.items():
        excess = ((got[name] - w).abs() - rtol * w.abs()).max().item()
        require(excess <= atol, f"[{tag}] gradient {name}: |diff| - rtol "
                f"|g| = {excess:.3e} > {atol}")
        worst = max(worst, excess)
    return worst


def mesh_case(tag: str, make, mesh, images, ids, dtype, steps: int,
              smi: str, moe: bool = False):
    """One mesh configuration. ``make(mesh)`` builds its trainer and
    ``make(None)`` the one-device trainer from the same seed; the first
    step's loss and gradients are held against the one-device trainer's
    on the same batch (MESH_LOSS_RTOL; in f32 MESH_GRAD_TOL element by
    element; an MoE tower's dropped tokens layer by layer equal), then
    applied, then ``steps - 1`` more steps; every step launches B3 the
    count the mesh implies and nothing else. Returns (the trainer, its
    numbers)."""
    dev = mesh.devices[0]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    one = make(None)
    drops, handles = moe_drop_hooks(one.model) if moe else ([], [])
    want_loss, want = one.value_and_grad(images, ids)
    for h in handles:
        h.remove()
    # the one-device trainer's ms a step, warm (its second step), to set
    # beside the mesh's in this run
    one.apply_gradients(want)
    t0 = time.perf_counter()
    one.step(images, ids)
    one_ms = 1e3 * (time.perf_counter() - t0)
    one_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del one
    gc.collect()
    torch.cuda.empty_cache()
    trainer = make(mesh)
    per_step = mesh_b3_per_step(trainer.cfg, mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    loss, got = trainer.value_and_grad(images, ids)
    first_ms = 1e3 * (time.perf_counter() - t0)
    total = read_launches(f"{tag} first step", per_step)["attention"]
    rtol = MESH_LOSS_RTOL[dtype]
    require(np.isfinite(loss) and abs(loss - want_loss)
            <= rtol * abs(want_loss), f"[{tag}] first loss {loss} against "
            f"the one-device {want_loss} (rtol {rtol})")
    require(all(bool(torch.isfinite(g).all()) for g in got.values()),
            f"[{tag}] gradients not finite")
    gap = mesh_grads_gap(got, want, tag) if dtype == torch.float32 else None
    dropped = None
    if moe:
        dropped = [int(v) for v in trainer.last_dropped.values()]
        require(dropped == drops, f"[{tag}] tokens dropped per layer "
                f"{dropped}, one device {drops}")
    trainer.apply_gradients(got)
    del got, want
    losses, secs = [loss], []
    for i in range(1, steps):
        zero_launches()
        t0 = time.perf_counter()
        losses.append(trainer.step(images, ids))     # float(): synchronises
        secs.append(time.perf_counter() - t0)
        total += read_launches(f"{tag} step {i}", per_step)["attention"]
        require(np.isfinite(losses[-1]), f"[{tag}] step {i}: loss "
                f"{losses[-1]}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    step_ms = 1e3 * float(np.mean(secs))
    log(f"[{tag}] mesh {mesh.shape} over {len(set(mesh.devices))} card(s), "
        f"B={len(images)}: first loss {loss:.6f} against the one-device "
        f"{want_loss:.6f} (rtol {rtol})"
        + (f", gradients within rtol {MESH_GRAD_TOL[0]} / atol "
           f"{MESH_GRAD_TOL[1]} (largest excess {gap:.2e})"
           if gap is not None else "")
        + (f", tokens dropped per MoE layer {dropped} (= one device)"
           if moe else "")
        + f"; losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; {step_ms:.1f} ms a step (mean of steps 2-{steps}; first with "
        f"its gradients gathered {first_ms:.1f}; the one-device trainer's "
        f"second step {one_ms:.1f}); B3 {per_step} launches a step as the mesh "
        f"implies, {total} in all; peak memory {peak:.2f} GB (the one-device "
        f"trainer's {one_peak:.2f}); on {smi}")
    return trainer, {"losses": losses, "want_loss": want_loss,
                     "grad_excess": gap, "dropped": dropped,
                     "step_ms": step_ms, "first_ms": first_ms,
                     "one_device_step_ms": one_ms, "peak_gb": peak,
                     "one_device_peak_gb": one_peak,
                     "launches": total, "launches_per_step": per_step}


def mesh_checkpoint_served(trainer: CLIPTrainer, cfg, kw: dict, args,
                           device, root: Path) -> dict:
    """The mesh trainer's checkpoint: saved (whole tensors), restored onto
    a one-device trainer (params, moments, EMA and step bit for bit the
    mesh's gathered), then served by a bf16 ``CLIPEmbedder`` with
    ``orbax_checkpoint`` set to it: ``pretrained``, and its image and text
    vectors against the f32 module towers on the trainer's parameters
    (per-row cosine >= MIN_COS)."""
    t0 = time.perf_counter()
    path = train_ckpt.save_checkpoint(root / "ckpt-mesh", trainer,
                                      trainer.state.step)
    save_s = time.perf_counter() - t0
    one = CLIPTrainer(cfg, seed=args.seed, **kw)
    step = train_ckpt.restore_checkpoint(root / "ckpt-mesh", one)
    a, b = trainer.state, one.state
    require(step == b.step == a.step and b.opt_state["count"]
            == a.opt_state["count"], f"[mesh ckpt] step {step}")
    for name, got, want in (("params", b.params, a.params),
                            ("mu", b.opt_state["mu"], a.opt_state["mu"]),
                            ("nu", b.opt_state["nu"], a.opt_state["nu"]),
                            ("ema", b.ema_params, a.ema_params)):
        same_state(f"mesh ckpt {name}", got, dict(want.items()))
    del one
    gc.collect()
    torch.cuda.empty_cache()
    tower = CLIPEmbedder(dtype=torch.bfloat16, device=device,
                         orbax_checkpoint=path)
    require(tower.pretrained is True, "[mesh ckpt] pretrained")
    ref = module_from(cfg, dict(trainer.state.params.items()),
                      device).eval()
    frames = seeded_frames(args.seed, 53_000, 32)
    ids = tower.prepare_text_ids(tower.tokenizer(list(SERVE_TEXTS)))
    with torch.inference_mode():
        img = ref.encode_image(normalize_images(
            torch.from_numpy(frames).to(device)))
        txt = ref.encode_text(tower.ids_tensor(ids))
    cos = {}
    for name, got, want in (
            ("image", tower.embed_frames(frames), img),
            ("text", tower.embed_texts(list(SERVE_TEXTS)), txt)):
        cos[name] = torch.nn.functional.cosine_similarity(
            torch.from_numpy(got), want.cpu(), dim=-1).min().item()
        require(cos[name] >= MIN_COS,
                f"[mesh ckpt] {name} vectors: min cosine {cos[name]}")
    log(f"[mesh ckpt] {path.name} saved from the mesh in {save_s:.2f} s, "
        "restored onto one device (params, moments, EMA and step bit for "
        "bit), served by a bf16 CLIPEmbedder: pretrained; min row cosine "
        f"against the trainer's towers: image {cos['image']:.6f}, text "
        f"{cos['text']:.6f} (>= {MIN_COS})")
    del tower, ref
    return {"save_s": save_s, "min_cos": cos}


def dryrun_meshes(device) -> dict:
    """The JAX package's ``dryrun_multichip`` (its training half) on the
    one-card mesh at tiny shapes (towers 128 wide, heads of 64): a dp x tp
    CLIP step, a SigLIP step and an EMA + cosine step, each loss
    finite."""
    from video_quierer_tpu_torch.models.clip.config import (
        CLIPConfig,
        CLIPTextConfig,
        CLIPVisionConfig,
    )
    from video_quierer_tpu_torch.models.siglip.model import (
        SigLIPConfig,
        SigLIPTextConfig,
        SigLIPVisionConfig,
    )
    mesh = data_mesh(devices=[device] * (MESH_DATA * MESH_PARTS),
                     model_parallel=MESH_PARTS)
    tiny = CLIPConfig(
        name=DRYRUN_CLIP, projection_dim=64,
        vision=CLIPVisionConfig(image_size=DRYRUN_IMAGE, patch_size=8,
                                hidden_size=128, num_layers=2, num_heads=2),
        text=CLIPTextConfig(vocab_size=64, context_length=DRYRUN_CONTEXT,
                            hidden_size=128, num_layers=2, num_heads=2,
                            eot_token_id=63))
    sg = SigLIPConfig(
        name="train-mesh-siglip-tiny",
        vision=SigLIPVisionConfig(image_size=DRYRUN_IMAGE, patch_size=8,
                                  hidden_size=128, num_layers=2,
                                  num_heads=2, mlp_ratio=2),
        text=SigLIPTextConfig(vocab_size=64, context_length=DRYRUN_CONTEXT,
                              hidden_size=128, num_layers=2, num_heads=2,
                              mlp_ratio=2))
    rng = np.random.default_rng(13)
    images = rng.standard_normal((DRYRUN_B, DRYRUN_IMAGE, DRYRUN_IMAGE,
                                  3)).astype(np.float32)
    ids = rng.integers(1, 62, (DRYRUN_B, DRYRUN_CONTEXT)).astype(np.int32)
    ids[:, -1] = 63
    with torch.device("meta"):
        sg_model = SigLIP(sg)
    out = {}
    for tag, make in (
            ("clip", lambda: CLIPTrainer(tiny, mesh=mesh, device=device,
                                         learning_rate=1e-3)),
            ("siglip", lambda: CLIPTrainer(model=sg_model, mesh=mesh,
                                           device=device,
                                           learning_rate=1e-3)),
            ("ema-cosine", lambda: CLIPTrainer(
                tiny, mesh=mesh, device=device, learning_rate=1e-3,
                schedule="cosine", warmup_steps=1, total_steps=4,
                ema_decay=0.9))):
        trainer = make()
        zero_launches()
        out[tag] = trainer.step(images, ids)
        read_launches(f"dryrun {tag}", MESH_DATA * MESH_PARTS * 4)
        require(np.isfinite(out[tag]), f"[dryrun {tag}] loss {out[tag]}")
    require(trainer.state.ema_params is not None, "[dryrun] EMA")
    log(f"[dryrun] the training half of dryrun_multichip on {mesh.shape}: "
        f"clip loss {out['clip']:.4f}, siglip loss {out['siglip']:.4f}, "
        f"ema-cosine loss {out['ema-cosine']:.4f}")
    return out


def phase_train_mesh(args, device, smi: str) -> dict:
    """Phase 13's one-card half: ``DataMesh([cuda:0] * 4)`` at full
    width: ViT-B/32 at B = 64 in f32 (warmup-cosine, the clip, the EMA)
    and in bf16 on (data 2, model 2), ``vit-b-32-moe8`` on (data 2,
    expert 2), SigLIP base/16 at B = 32 on (data 2, model 2), each
    against the one-device trainer (``mesh_case``); the f32 trainer's
    checkpoint restored onto one device and served; the tiny dryrun; B3
    under autograd at a part's shapes against its plain version."""
    out = {"attention": compare_attention_grad(device, MESH_ATTN_SHAPES)}
    n = MESH_DATA * MESH_PARTS
    tp = data_mesh(devices=[device] * n, model_parallel=MESH_PARTS)
    ep = data_mesh(devices=[device] * n, model_parallel=MESH_PARTS,
                   axis="expert")
    cfg = get_config("openai/clip-vit-base-patch32")
    mean = (0.48145466, 0.4578275, 0.40821073)
    std = (0.26862954, 0.26130258, 0.27577711)
    images, ids = train_batch(args, load_tokenizer(), TRAIN_B // TRAIN_FRAMES,
                              mean, std)
    images, ids = (torch.from_numpy(images).to(device),
                   torch.from_numpy(ids).to(device).long())
    kw = dict(learning_rate=TRAIN_LR, schedule="cosine",
              total_steps=MESH_STEPS, max_grad_norm=1.0, ema_decay=0.99,
              device=device)

    def clip_trainer(config, dtype=torch.float32, **extra):
        return lambda mesh: CLIPTrainer(config, seed=args.seed, mesh=mesh,
                                        dtype=dtype, **kw, **extra)

    scratch = ROOT / "build" / "smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    trainer, out["f32"] = mesh_case("mesh vit-b-32 f32", clip_trainer(cfg),
                                    tp, images, ids, torch.float32,
                                    MESH_STEPS, smi)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        out["f32"]["checkpoint"] = mesh_checkpoint_served(
            trainer, cfg, kw, args, device, Path(tmp))
        out["f32"]["traced"] = traced_step(trainer, images, ids, Path(tmp),
                                           "mesh f32", smi)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    trainer, out["bf16"] = mesh_case(
        "mesh vit-b-32 bf16", clip_trainer(cfg, torch.bfloat16), tp, images,
        ids, torch.bfloat16, 2, smi)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    trainer, out["moe"] = mesh_case(
        f"mesh {MOE} f32", clip_trainer(moe_config()), ep, images, ids,
        torch.float32, 2, smi, moe=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    scfg = siglip_base_patch16()
    s_images, s_ids = train_batch(args, siglip_tokenizer(scfg),
                                  MESH_SIGLIP_B // TRAIN_FRAMES,
                                  SIGLIP_MEAN, SIGLIP_STD)

    def siglip_trainer(mesh):
        with torch.device("meta"):
            model = SigLIP(scfg)
        return CLIPTrainer(model=model, seed=args.seed, mesh=mesh, **kw)

    trainer, out["siglip"] = mesh_case(
        "mesh siglip base/16 f32", siglip_trainer, tp, s_images, s_ids,
        torch.float32, 2, smi)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    out["dryrun"] = dryrun_meshes(device)
    return out


def busy_by_device(path: Path) -> dict:
    """Per device of a Chrome trace: the share of the traced window in
    which it ran a kernel, a copy or a set, and its ms of copies."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    by_dev: dict = {}
    for e in spans:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev = e.get("args", {}).get("device", e.get("pid"))
            by_dev.setdefault(str(dev), []).append(e)
    out = {}
    for dev, evs in sorted(by_dev.items()):
        busy, end = 0.0, lo
        for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in evs):
            if b > end:
                busy += b - max(a, end)
                end = b
        copies = sum(float(e["dur"]) for e in evs
                     if e.get("cat") == "gpu_memcpy") / 1e3
        out[dev] = {"busy_share": busy / (hi - lo), "copy_ms": copies}
    return out


def compare_train_mesh_cards(args, device, n_cards: int, smi: str) -> dict:
    """Phase 13's multi-card half: ViT-B/32 at B = 64 in f32 on a (data
    n/2, model 2) mesh over ``cuda:0 .. n-1`` and on the same grid over
    ``[cuda:0] * n``, each against the one-device trainer on ``cuda:0``
    (``mesh_case``), 3 steps each; ms a step of both, and per-card peak
    memory of the cards' mesh."""
    require(torch.cuda.device_count() >= n_cards and n_cards % 2 == 0,
            f"--train-mesh {n_cards}: {torch.cuda.device_count()} cards "
            "visible; it needs an even count, at most the visible cards")
    cfg = get_config("openai/clip-vit-base-patch32")
    mean = (0.48145466, 0.4578275, 0.40821073)
    std = (0.26862954, 0.26130258, 0.27577711)
    images, ids = train_batch(args, load_tokenizer(), TRAIN_B // TRAIN_FRAMES,
                              mean, std)
    images, ids = (torch.from_numpy(images).to(device),
                   torch.from_numpy(ids).to(device).long())

    def make(mesh):
        return CLIPTrainer(cfg, seed=args.seed, mesh=mesh,
                           learning_rate=TRAIN_LR, device=device)

    out = {}
    for tag, devs in (("cards", [torch.device("cuda", i)
                                 for i in range(n_cards)]),
                      ("one card", [device] * n_cards)):
        mesh = data_mesh(devices=devs, model_parallel=MESH_PARTS)
        for d in set(devs):
            torch.cuda.reset_peak_memory_stats(d)
        trainer, out[tag] = mesh_case(f"mesh {tag} vit-b-32 f32", make,
                                      mesh, images, ids, torch.float32,
                                      MESH_STEPS, smi)
        out[tag]["peak_gb_per_card"] = [
            torch.cuda.max_memory_allocated(d) / 2 ** 30
            for d in sorted(set(devs), key=lambda d: d.index)]
        scratch = ROOT / "build" / "smoke"
        scratch.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=scratch) as tmp:
            name = f"mesh {tag}"
            traced = traced_step(trainer, images, ids, Path(tmp), name, smi)
            traced["by_device"] = busy_by_device(
                Path(tmp) / f"train_{name}.json")
        log(f"[mesh {tag} traced] per device (busy share of the window, ms "
            "of copies): " + ", ".join(
                f"{d} {v['busy_share']:.3f} {v['copy_ms']:.2f}"
                for d, v in traced["by_device"].items()))
        out[tag]["traced"] = traced
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[mesh cards] ViT-B/32 f32 B={TRAIN_B} on (data {n_cards // 2}, "
        f"model 2): {out['cards']['step_ms']:.1f} ms a step over "
        f"{n_cards} cards, {out['one card']['step_ms']:.1f} ms on one card "
        f"(the one-device trainer's step "
        f"{out['cards']['one_device_step_ms']:.1f} ms); peak memory per card "
        + ", ".join(f"{g:.2f}" for g in out["cards"]["peak_gb_per_card"])
        + f" GB; on {smi}")
    return out


def train_mesh_kernel_entry(tm: dict) -> dict:
    """The kernels line's mesh-step entry: B3 under autograd at a data
    row's part shape (f32 vision; the text shape and bf16 under ``at``),
    with the launches of phase 13's mesh steps."""
    att = tm["attention"]
    at = {f"S={s} {str(dt)[6:]}": att[(s, dt)]["step"]
          for s, dt in att if (s, dt) != (50, torch.float32)}
    launches = {k: tm[k]["launches"] for k in ("f32", "bf16", "moe",
                                               "siglip")}
    return {"name": "attention_train_mesh", "route": "cuda",
            "source": "video_quierer_tpu_torch/csrc/attention.cu",
            "replaces": "video_quierer_tpu/ops/attention.py:143",
            "launches": tm["f32"]["launches"],
            "launches_per_step": tm["f32"]["launches_per_step"],
            "steps": MESH_STEPS, "launches_by_case": launches,
            "shape": "B=32 S=50 H=6 f32 (a data row's model part), forward "
            "+ backward", **att[(50, torch.float32)]["step"], "at": at}


_AB_RUN = """
import json, sys, numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as c
from video_quierer_tpu_torch.ops import fused_layer as fl
from video_quierer_tpu_torch.ops.attention import attention
seed, scans, n_rows = int(sys.argv[1]), sys.argv[2] == "1", int(sys.argv[3])
dev = torch.device("cuda", 0)


def graph_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    for _ in range(2):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


c.phase_environment()
c.phase_build()
emb = c.CLIPEmbedder(dtype=torch.bfloat16, device=dev, seed=seed)
row = {"B3": c.compare_attention(dev)["ms"],
       "B2": c.compare_fused_layer(emb, seed)["ms"]}
row["B5"], row["B6"] = (r["ms"] for r in c.compare_layer_halves(emb, seed))
c.ingest_split(emb, seed, dev)
# device time of the same calls, whichever timer the tree's own uses
with torch.inference_mode():
    q, k, v = (0.5 * torch.randn(64, 77, 512, device=dev).bfloat16()
               for _ in range(3))
    row["B3 device"] = graph_ms(
        lambda: attention(q, k, v, num_heads=8, causal=True), 50)
    ids = emb.ids_tensor(c.trim_text_ids(emb.tokenizer(
        [c.words(np.random.default_rng(seed), 11) for _ in range(64)])))
    ops = emb._layer_ops(emb.params)
    row["B2 device"] = graph_ms(
        lambda: fl.fused_text_encode(emb.params, ids, ops), 10)
    vc = emb.cfg.vision
    vops = emb._layer_ops(emb.params, "vision")[0]
    x = torch.randn(256 * vc.seq_len, vc.hidden_size, device=dev).bfloat16()
    row["B5 device"] = graph_ms(lambda: fl.attn_half(
        x, vops, s=vc.seq_len, heads=vc.num_heads, eps=vc.layer_norm_eps,
        causal=False), 10)
    row["B6 device"] = graph_ms(
        lambda: fl.mlp_half(x, vops, eps=vc.layer_norm_eps), 10)
    del x


def rand(*shape, scale=1.0):
    return (scale * torch.randn(*shape, device=dev)).bfloat16()


def b3_device(s, heads, hd):
    q, k, v = (rand(256, s, heads * hd, scale=0.5) for _ in range(3))
    return graph_ms(lambda: attention(q, k, v, num_heads=heads), 10)


# ViT-L/14's vision shapes (256 frames, S = 257, D = 1,024, F = 4,096) on
# random operands, and AIMv2-L/14's (S = 256, F = 2,816) where the tree
# has its kernels
with torch.inference_mode():
    row["B3 L/14 device"] = b3_device(257, 16, 64)
    d, f, t = 1024, 4096, 256 * 257
    x = rand(t, d)
    ln = torch.stack([1 + 0.1 * torch.randn(d), 0.1 * torch.randn(d),
                      1 + 0.1 * torch.randn(d), 0.1 * torch.randn(d)]
                     ).to(dev)
    lops = (ln, rand(d, 3 * d, scale=d ** -0.5), rand(3 * d, scale=0.02),
            rand(d, d, scale=d ** -0.5), rand(d, scale=0.02),
            rand(d, f, scale=d ** -0.5), rand(f, scale=0.02),
            rand(f, d, scale=f ** -0.5), rand(d, scale=0.02))
    row["B5 L/14 device"] = graph_ms(lambda: fl.attn_half(
        x, lops, s=257, heads=16, eps=1e-5, causal=False), 10)
    row["B6 L/14 device"] = graph_ms(
        lambda: fl.mlp_half(x, lops, eps=1e-5), 10)
    del x, lops
    if hasattr(fl, "gated_mlp_half"):
        row["B3-128 device"] = b3_device(256, 8, 128)
        d, f, t = 1024, 2816, 256 * 256
        x = rand(t, d)
        gops = (1 + 0.1 * torch.randn(2, d, device=dev),
                rand(d, 3 * d, scale=d ** -0.5), rand(d, d, scale=d ** -0.5),
                fl.interleave_gate_up(rand(d, f, scale=d ** -0.5),
                                      rand(d, f, scale=d ** -0.5)),
                rand(f, d, scale=f ** -0.5))
        row["B5-RMS device"] = graph_ms(lambda: fl.rms_attn_half(
            x, gops, s=256, heads=8, eps=1e-5, causal=False), 10)
        row["B6-gated device"] = graph_ms(
            lambda: fl.gated_mlp_half(x, gops, eps=1e-5), 10)
        del x, gops
if scans:
    store, perm = c.corpus_on_card(dev, n_rows, seed)
    row["B1"] = c.compare_cand_scan(store, perm, n_rows, seed)["ms"]
    row["B4"] = c.compare_codes_scan(store, perm, n_rows, seed, "int8")["ms"]
    row["B7"] = c.compare_codes_scan(store, perm, n_rows, seed, "int4")["ms"]
    row["B8"] = c.compare_block_scan(store, n_rows, seed)["ms"]
    for b in (1, 16):
        q = c.unit_queries(dev, b, seed + b)
        row[f"B8 B={b}"] = c.cuda_ms(
            lambda: c.topk.block_scan(store, q, n_rows, k=c.K), 20)
    scan = dict(bucket=c.topk.CAND_BUCKET, rounds=c.topk.CAND_ROUNDS)
    mirror = store[perm.long()].bfloat16()
    for b in (1, 256):
        q = c.unit_queries(dev, b, seed + b)
        row[f"B1 B={b}"] = c.cuda_ms(lambda: c.topk.cand_scan_prefix(
            mirror, q, n_rows, **scan), 20 if b == 1 else 5)
    del mirror
    # B4 at B = 1 and 256 (its B = 64 above), through the wrapper both
    # trees have
    codes, scales = c.quantize_rows(store[perm.long()])
    for b in (1, 256):
        qc, qs = c.quantize_rows(c.unit_queries(dev, b, seed + b))
        row[f"B4 B={b}"] = c.cuda_ms(lambda: c.topk.cand_scan_int8_prefix(
            codes, scales, qc, qs, n_rows, **scan), 20 if b == 1 else 5)
    del codes, scales
    # B7 at B = 1 and 256 likewise
    packed, scales = c.quantize_rows_int4(store[perm.long()])
    for b in (1, 256):
        qc, qs = c.quantize_rows(c.unit_queries(dev, b, seed + b))
        row[f"B7 B={b}"] = c.cuda_ms(lambda: c.topk.cand_scan_int4_prefix(
            packed, scales, qc, qs, n_rows, **scan), 20 if b == 1 else 5)
    del packed, scales
    # the hatch's exact scans, B9 and B8 over bf16 rows, through the
    # wrappers both trees have, at B = 1 and 64, k = K and HATCH_K
    codes, scales = c.quantize_rows(store)
    rows16 = store.bfloat16()
    for b in (1, 64):
        q = c.unit_queries(dev, b, seed + b)
        for k in (c.K, c.HATCH_K):
            row[f"B9 B={b} k={k}"] = c.cuda_ms(
                lambda: c.topk.block_scan_int8(codes, scales, q, n_rows,
                                               k=k), 20 if b == 1 else 10)
            row[f"B8 bf16 B={b} k={k}"] = c.cuda_ms(
                lambda: c.topk.block_scan_bf16(rows16, q, n_rows, k=k),
                20 if b == 1 else 10)
    del codes, scales, rows16
    # B10 at B = 64 and B11 at B = 1, 64 and 256 over the whole corpus as
    # one shard, then over shard 0 of the 4-shard perm layout
    q = c.unit_queries(dev, 64, seed + 64)
    for shards in (1, c.MESH_SHARDS):
        cap, perm_np = c.mesh_perm(n_rows, shards)
        sperm = torch.from_numpy(perm_np[:cap // shards]).to(dev)
        src = torch.clamp(sperm, max=store.shape[0] - 1).long()
        mirror = store[src].bfloat16()
        tag = "" if shards == 1 else " shard"
        row["B10" + tag] = c.cuda_ms(
            lambda: c.topk.cand_scan(mirror, sperm, q, n_rows, **scan), 20)
        del mirror
        codes, scales = c.quantize_rows(store[src])
        for b in (1, 64, 256):
            qc, qs = c.quantize_rows(c.unit_queries(dev, b, seed + b))
            row[f"B11{tag} B={b}"] = c.cuda_ms(
                lambda: c.topk.cand_scan_int8(codes, scales, sperm, qc, qs,
                                              n_rows, **scan),
                20 if b < 256 else 5)
        del codes, scales
    del store, perm
    torch.cuda.empty_cache()
    # B12 through compare_probe_scan, which both trees have: its log lines
    # give B = 64 and B = 1; the index it builds and the queries it probes
    # with are kept to time shard 0 of the same tier over a 4-shard mesh,
    # with the pair list that a mesh search hands its first device
    # (recorded from IVFIndex._search_sharded, the kernel not run)
    import re
    seen, kept, probed = [], [], {}
    Index, scan, log = c.ivf.IVFIndex, c.ivf.probe_scan, c.log

    class Kept(Index):
        def build(self, emb):
            super().build(emb)
            kept.append(self)

        def _probe_pairs(self, queries, nprobe):
            probed.setdefault(queries.shape[0], queries)
            return super()._probe_pairs(queries, nprobe)

    c.log = lambda msg: (seen.append(msg), log(msg))
    c.ivf.IVFIndex = Kept
    c.compare_probe_scan(dev, n_rows, seed)
    c.ivf.IVFIndex, c.log = Index, log
    for msg in seen:
        m = re.match(r"B12 probe scan N=[0-9]+ B=([0-9]+) .*?kernel "
                     r"([0-9.]+) ms",
                     msg)
        if m:
            row[f"B12 B={m[1]}"] = float(m[2])
    index = kept[0]
    mesh = Index(nprobe=8, mesh=c.CorpusMesh([dev] * c.MESH_SHARDS))
    mesh.nlist = index.nlist
    mesh._set_built(index._centroids_np, index._tiled, index._row_ids,
                    index._tile_start_np, index._tile_counts_np,
                    index._n_built)
    del index, kept[:]
    for b in (1, 64):
        calls = []

        def record(*args, k):
            calls.append(args)
            p = args[2].shape[0]
            return (torch.full((p, k), float("-inf"), device=args[0].device),
                    torch.full((p, k), -1, dtype=torch.int32,
                               device=args[0].device))

        c.ivf.probe_scan = record
        mesh.search(probed[b], k=c.K)
        c.ivf.probe_scan = scan
        first = calls[0]
        row[f"B12 shard B={b}"] = c.cuda_ms(lambda: scan(*first, k=c.K), 20)
print("ab-row " + json.dumps(row), flush=True)
"""


def phase_ab(parent: Path, args) -> int:
    """Same-call A/B of this tree's kernel phases against another
    checkout's (``--ab DIR``, e.g. the parent commit unpacked with ``git
    archive``): runs parent, this tree, this tree, parent, each in its own
    process on the one card, then prints each kernel's ms per run."""
    runs = [("parent", parent), ("change", ROOT), ("change", ROOT),
            ("parent", parent)]
    rows = []
    for tag, tree in runs:
        log(f"== A/B run {len(rows) + 1}: {tag} ({tree})")
        proc = subprocess.run(
            [sys.executable, "-c", _AB_RUN, str(args.seed),
             "1" if args.ab_scans else "0",
             str(args.videos * args.frames)], cwd=tree,
            capture_output=True, text=True)
        log(proc.stdout.rstrip())
        if proc.returncode != 0:
            log(proc.stderr[-4000:])
            return 1
        rows.append(json.loads(proc.stdout.split("ab-row ")[-1]))
    # a kernel one tree lacks reads "-" in its runs
    keys = dict.fromkeys(k for r in rows for k in r)
    log("A/B kernel ms (parent, change, change, parent): " + "; ".join(
        f"{k} " + " / ".join(f"{r[k]:.4f}" if k in r else "-" for r in rows)
        for k in keys))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--videos", type=int, default=10_000)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--ab", type=Path, default=None, metavar="DIR",
                    help="only the same-call A/B of the kernel phases "
                         "against the checkout in DIR")
    ap.add_argument("--ab-scans", action="store_true",
                    help="with --ab: the search-tier scans (B1, B4, B7, "
                         "B8, B9, B10, B11, B8 over bf16 rows, B12) too")
    ap.add_argument("--exact-scans", action="store_true",
                    help="only the hatch's exact scans (B9, B8 over bf16 "
                         "rows) against their plain versions, timed")
    ap.add_argument("--checkpoints", action="store_true",
                    help="only the ViT-L/14 kernels and phase 9 (the "
                         "towers served from HF checkpoints)")
    ap.add_argument("--train", action="store_true",
                    help="only phase 10 (B3 under autograd, the trainer, "
                         "train -> serve)")
    ap.add_argument("--towers", action="store_true",
                    help="only phase 11 (the MoE engine, MoE fine-tuning, "
                         "the pp engine, ViT-L/14 pipelined)")
    ap.add_argument("--aimv2", action="store_true",
                    help="only phase 3's AIMv2 part and phase 6's AIMv2 "
                         "engine")
    ap.add_argument("--pp-cards", type=int, default=0, metavar="N",
                    help="only ViT-L/14's pipelined encode over N cards "
                         "(stage s on cuda:s) against its sequential tower")
    ap.add_argument("--hosts", type=int, default=0, metavar="N",
                    help="only phase 12's multi-process half: N processes "
                         "serving one corpus over the visible cards")
    ap.add_argument("--meshes", action="store_true",
                    help="only phase 13's one-card half (the training "
                         "meshes over [cuda:0] x 4)")
    ap.add_argument("--train-mesh", type=int, default=0, metavar="N",
                    help="only phase 13's multi-card half: the mesh step "
                         "over cuda:0 .. N-1 against [cuda:0] x N")
    ap.add_argument("--host-child", type=Path, default=None,
                    metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if args.host_child is not None:
        return host_child(args)
    if args.ab is not None:
        return phase_ab(args.ab.resolve(), args)
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    with timed("1, environment"):
        smi = phase_environment()
    with timed("2, build"):
        phase_build()
    n_rows = args.videos * args.frames
    if args.exact_scans:
        with timed("3, hatch scan kernels"):
            store, _ = corpus_on_card(device, n_rows, args.seed)
            compare_exact_scans(store, n_rows, args.seed)
        log(smi)
        return 0
    if args.checkpoints:
        with timed("3, ViT-L/14 kernels"):
            l14 = CLIPEmbedder(model_name=L14, dtype=torch.bfloat16,
                               device=device, seed=args.seed)
            phase_l14_kernels(l14, args, device)
        stageprof.enable(True)
        with timed("9, checkpoints"):
            ck = phase_checkpoints(
                CLIPEmbedder(dtype=torch.bfloat16, device=device,
                             seed=args.seed),
                SigLIPEmbedder(dtype=torch.bfloat16, device=device,
                               seed=args.seed), l14, args, device, smi)
        log(f"phase 9 summary ({smi}): " + json.dumps(ck))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.train:
        with timed("10, training"):
            tr = phase_train(args, device, smi)
        log(f"phase 10 kernels ({smi}): "
            + json.dumps(train_kernel_entries(tr)))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.meshes:
        with timed("13, training meshes"):
            tm = phase_train_mesh(args, device, smi)
        log(f"phase 13 kernels ({smi}): "
            + json.dumps(train_mesh_kernel_entry(tm)))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.train_mesh:
        with timed(f"13, {args.train_mesh} cards"):
            tc = compare_train_mesh_cards(args, device, args.train_mesh, smi)
        log(f"phase 13 cards summary ({smi}): " + json.dumps(tc))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.hosts:
        with timed(f"12, {args.hosts} processes"):
            hosts = phase_hosts(args.hosts, args, device, smi)
        log(f"phase 12 processes summary ({smi}): " + json.dumps(hosts))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.pp_cards:
        l14 = CLIPEmbedder(model_name=L14, dtype=torch.bfloat16,
                           device=device, seed=args.seed)
        with timed(f"11, ViT-L/14 pipelined over {args.pp_cards} cards"):
            pc = compare_pp_cards(l14, args.seed, args.pp_cards)
        log(f"pp cards summary ({smi}): " + json.dumps(pc))
        return 0
    if args.aimv2:
        entries = phase_aimv2(args, device, smi)
        log(f"AIMv2 kernels ({smi}): " + json.dumps(entries))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.towers:
        dense = CLIPEmbedder(dtype=torch.bfloat16, device=device,
                             seed=args.seed)
        l14 = CLIPEmbedder(model_name=L14, dtype=torch.bfloat16,
                           device=device, seed=args.seed)
        tw = phase_towers(dense, l14, args, device, smi)
        log(f"phase 11 launches ({smi}): "
            + json.dumps(tower_launches(tw)))
        log(f"phase 11 summary ({smi}): " + json.dumps(tw))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    with timed("3, text and vision kernels"):
        embedder = CLIPEmbedder(dtype=torch.bfloat16, device=device,
                                seed=args.seed)
        b3 = compare_attention(device)
        b2 = compare_fused_layer(embedder, args.seed)
        b5, b6 = compare_layer_halves(embedder, args.seed)
        compare_vision_encode(embedder, args.seed)
        ingest_split(embedder, args.seed, device)
    with timed("3, scan kernels"):
        store, perm = corpus_on_card(device, n_rows, args.seed)
        b1 = compare_cand_scan(store, perm, n_rows, args.seed)
        b4 = compare_codes_scan(store, perm, n_rows, args.seed, "int8")
        b7 = compare_codes_scan(store, perm, n_rows, args.seed, "int4")
        b8 = compare_block_scan(store, n_rows, args.seed)
        del perm
    with timed("3, mesh and hatch scan kernels"):
        b10, b11 = compare_perm_scans(store, n_rows, args.seed)
        b9, b8h = compare_exact_scans(store, n_rows, args.seed)
        del store
        torch.cuda.empty_cache()
    with timed("3, IVF tier"):
        b12 = compare_probe_scan(device, n_rows, args.seed)
        gc.collect()
        torch.cuda.empty_cache()
    with timed("3, SigLIP kernels"):
        siglip = SigLIPEmbedder(dtype=torch.bfloat16, device=device,
                                seed=args.seed)
        sk = phase_siglip_kernels(siglip, args, device)
    with timed("3, ViT-L/14 kernels"):
        l14 = CLIPEmbedder(model_name=L14, dtype=torch.bfloat16,
                           device=device, seed=args.seed)
        lk = phase_l14_kernels(l14, args, device)
    # the serving path's stage spans: phase 5 splits its batches by them
    stageprof.enable(True)
    launches, ingested, extra, surface = phase_end_to_end(embedder, args,
                                                          device, smi)
    with timed("6, SigLIP engine"):
        sl, si = phase_siglip_engine(siglip, args, device, smi)
    aimv2_entries = phase_aimv2(args, device, smi)
    with timed("9, checkpoints"):
        ck = phase_checkpoints(embedder, siglip, l14, args, device, smi)
    with timed("10, training"):
        tr = phase_train(args, device, smi)
    tw = phase_towers(embedder, l14, args, device, smi)
    with timed("12, data mesh"):
        dm = phase_data_mesh(embedder, args, device, smi)
    hosts = None
    if torch.cuda.device_count() >= 2:
        with timed(f"12, {torch.cuda.device_count()} processes"):
            hosts = phase_hosts(torch.cuda.device_count(), args, device, smi)
    else:
        log("phase 12's multi-process half skipped: "
            f"{torch.cuda.device_count()} card visible, it needs 2 or more "
            "(chip_smoke.py --hosts N runs it on N or more cards)")
    with timed("13, training meshes"):
        tm = phase_train_mesh(args, device, smi)
    if torch.cuda.device_count() >= 4:
        with timed("13, 4 cards"):
            tm["cards"] = compare_train_mesh_cards(args, device, 4, smi)
    else:
        log("phase 13's multi-card half skipped: "
            f"{torch.cuda.device_count()} card visible, it needs 4 "
            "(chip_smoke.py --train-mesh 4 runs it on 4 cards)")
    l14_ingest = ck["vit-l-14"]["ingest"]["launches"]
    l14_search = ck["vit-l-14"]["launches"]
    src = "video_quierer_tpu_torch/csrc/"
    kernels_line = {"kernels": [
        {"name": "cand_scan_prefix", "route": "cuda",
         "source": src + "cand_scan.cu",
         "replaces": "video_quierer_tpu/ops/topk.py:1419",
         "launches": launches["bfloat16"]["cand_scan_prefix"], **b1},
        {"name": "fused_text_layer", "route": "cuda",
         "source": src + "fused_layer.cu",
         "replaces": "video_quierer_tpu/ops/fused_layer.py:386",
         "launches": launches["bfloat16"]["fused_layer"], **b2},
        {"name": "attention", "route": "cuda",
         "source": src + "attention.cu",
         "replaces": "video_quierer_tpu/ops/attention.py:143",
         "launches": launches["bfloat16"]["attention"], **b3},
        {"name": "attn_half", "route": "cuda",
         "source": src + "fused_layer.cu",
         "replaces": "video_quierer_tpu/ops/fused_layer.py:425",
         "launches": ingested["bfloat16"]["launches"]["attn_half"], **b5},
        {"name": "mlp_half", "route": "cuda",
         "source": src + "fused_layer.cu",
         "replaces": "video_quierer_tpu/ops/fused_layer.py:462",
         "launches": ingested["bfloat16"]["launches"]["mlp_half"], **b6},
        {"name": "cand_scan_int8_prefix", "route": "cuda",
         "source": src + "cand_scan_codes.cu",
         "replaces": "video_quierer_tpu/ops/topk.py:1467",
         "launches": launches["int8"]["cand_scan_int8_prefix"], **b4},
        {"name": "cand_scan_int4_prefix", "route": "cuda",
         "source": src + "cand_scan_codes.cu",
         "replaces": "video_quierer_tpu/ops/topk.py:1609",
         "launches": launches["int4"]["cand_scan_int4_prefix"], **b7},
        {"name": "block_scan", "route": "cuda",
         "source": src + "block_scan.cu",
         "replaces": "video_quierer_tpu/ops/topk.py:319",
         "launches": launches["float32"]["block_scan"], **b8},
        {"name": "probe_scan", "route": "cuda",
         "source": src + "probe_scan.cu",
         "replaces": "video_quierer_tpu/index/ivf.py:94",
         "launches": launches["ivf"]["probe_scan"], **b12},
        {"name": "block_scan_int8", "route": "cuda",
         "source": src + "block_scan.cu",
         "replaces": "video_quierer_tpu/ops/topk.py:388",
         "launches": extra["hatch int8"]["block_scan_int8"], **b9},
        {"name": "cand_scan", "route": "cuda",
         "source": src + "cand_scan.cu",
         "replaces": "video_quierer_tpu/ops/topk.py:1294",
         "launches": extra["mesh bfloat16"]["cand_scan"], **b10},
        {"name": "cand_scan_int8", "route": "cuda",
         "source": src + "cand_scan_codes.cu",
         "replaces": "video_quierer_tpu/ops/topk.py:1340",
         "launches": extra["mesh int8"]["cand_scan_int8"], **b11},
        {"name": "block_scan_bf16", "route": "cuda",
         "source": src + "block_scan.cu",
         "replaces": "video_quierer_tpu/ops/topk.py:319",
         "launches": extra["hatch bfloat16"]["block_scan_bf16"], **b8h},
        # the SigLIP engine's path (model.family = "siglip", 768 wide)
        {"name": "mlp_half_gelu_tanh", "route": "cuda",
         "source": src + "fused_layer.cu",
         "replaces": "video_quierer_tpu/ops/fused_layer.py:462",
         "launches": sl["mlp_half"], **sk["mlp_half"]},
        {"name": "attn_half_siglip_text", "route": "cuda",
         "source": src + "fused_layer.cu",
         "replaces": "video_quierer_tpu/ops/fused_layer.py:425",
         "launches": sl["attn_half"], **sk["attn_half"]},
        {"name": "attention_siglip_vision", "route": "cuda",
         "source": src + "attention.cu",
         "replaces": "video_quierer_tpu/ops/attention.py:143",
         "launches": si["launches"]["attention"], **sk["attention"]},
        {"name": "cand_scan_prefix_d768", "route": "cuda",
         "source": src + "cand_scan.cu",
         "replaces": "video_quierer_tpu/ops/topk.py:1419",
         "launches": sl["cand_scan_prefix"], **sk["cand_scan_prefix"]},
        # ViT-L/14 served from its checkpoint (phase 9): B3 at S = 257 runs
        # inside each B5 launch of its ingest
        {"name": "attention_l14_vision", "route": "cuda",
         "source": src + "attention.cu",
         "replaces": "video_quierer_tpu/ops/attention.py:143",
         "launches": l14_ingest["attn_half"], "via": "attn_half",
         **lk["attention"]},
        {"name": "attn_half_l14", "route": "cuda",
         "source": src + "fused_layer.cu",
         "replaces": "video_quierer_tpu/ops/fused_layer.py:425",
         "launches": l14_ingest["attn_half"], **lk["attn_half"]},
        {"name": "mlp_half_l14", "route": "cuda",
         "source": src + "fused_layer.cu",
         "replaces": "video_quierer_tpu/ops/fused_layer.py:462",
         "launches": l14_ingest["mlp_half"], **lk["mlp_half"]},
        {"name": "fused_text_layer_d768", "route": "cuda",
         "source": src + "fused_layer.cu",
         "replaces": "video_quierer_tpu/ops/fused_layer.py:386",
         "launches": l14_search["fused_layer"], **lk["fused_layer"]},
    ]}
    # phase 8's launches, beside each kernel's main-path count
    big, maint = surface["2m"], surface["maintenance"]
    slice_launches = {
        "cand_scan_prefix": {
            "keyword_engine": big["keyword"]["launches"]["cand_scan_prefix"],
            "profiled": big["profiler"]["launches"]["cand_scan_prefix"]},
        "fused_text_layer": {
            "profiled": big["profiler"]["launches"]["fused_layer"]},
        "attention": {"profiled": big["profiler"]["launches"]["attention"]}}
    for name in INGEST:
        slice_launches[name] = {
            "upload": maint["upload"]["launches"][name],
            "memo_rebuilds": [r["launches"][name]
                              for r in surface["memo"]["rebuilds"]]}
    # phase 9's ViT-B/32 checkpoint engine: its searches and its ingest
    b32 = ck["vit-b-32"]
    ckpt_launches = {name: {"search": b32["launches"][w],
                            "ingest": b32["ingest"]["launches"][w]}
                     for name, w in (("cand_scan_prefix", "cand_scan_prefix"),
                                     ("fused_text_layer", "fused_layer"),
                                     ("attention", "attention"),
                                     ("attn_half", "attn_half"),
                                     ("mlp_half", "mlp_half"))}
    # phase 10: B3 under autograd in the trainer's steps; phase 13: in the
    # mesh steps
    kernels_line["kernels"] += aimv2_entries
    kernels_line["kernels"] += train_kernel_entries(tr)
    kernels_line["kernels"].append(train_mesh_kernel_entry(tm))
    # phase 11: the MoE, MoE-training and pp paths
    towers_launches = tower_launches(tw)
    # phase 12: the data mesh's parts, its engine, and the processes' scans
    mesh_launches = data_mesh_launches(dm, hosts)
    for entry in kernels_line["kernels"]:
        if entry["name"] in slice_launches:
            entry["phase8_launches"] = slice_launches[entry["name"]]
        if entry["name"] in ckpt_launches:
            entry["phase9_launches"] = ckpt_launches[entry["name"]]
        if entry["name"] in towers_launches:
            entry["phase11_launches"] = towers_launches[entry["name"]]
        if entry["name"] in mesh_launches:
            entry["phase12_launches"] = mesh_launches[entry["name"]]
    log(f"phase 7 and 8 summary ({smi}; host-clock p50 ms per route, device "
        "ranking ms by CUDA events): " + json.dumps(surface))
    log(f"phase 9 summary ({smi}; load seconds by stage, launches): "
        + json.dumps(ck))
    log(f"phase 10 summary ({smi}): " + json.dumps(
        {k: v for k, v in tr.items() if k != "attention"}))
    log(f"phase 11 summary ({smi}): " + json.dumps(tw))
    log(f"phase 12 summary ({smi}): " + json.dumps(
        {"data_mesh": dm, "processes": hosts}))
    log(f"phase 13 summary ({smi}): " + json.dumps(
        {k: v for k, v in tm.items() if k != "attention"}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
