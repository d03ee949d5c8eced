#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``gaviko_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing its own line:

1. environment: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, whether PyYAML and tensorstore import;
2. build: compiles the CUDA kernels from ``gaviko_tpu_torch/csrc`` (nvcc,
   one process per source, in parallel) and prints the seconds;
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16 (relative MAE <= 1e-2) and fp32 with TF32 off (<= 1e-4), with median
   CUDA-event times (per call, over 10 back-to-back calls; for B8 also over
   10 calls replayed as one CUDA graph, ``graph_ms``) of kernel, plain
   version and the one PyTorch call that
   computes the same function (``library_ms``; timed here only, the port
   never calls it) or, where no one call does, the chain of calls
   (``chain_ms``), and the least time the card could take (``bound_ms``).
   First at the shapes the GAViKO vit-l16 B8 serving path gives its three
   forward kernels, then at the shapes the vit-b16 B8 serving path gives
   its three (LN+qkv and LN+kv, the fused MLP with the residual, the CLS
   attention), then at the shapes the B4 train step gives all five of
   GAViKO (fused MHSA forward with lse and backward, local attention
   forward with dropout 0.2 and backward, patchify), then at the shapes the
   vit-b16 B8 train step gives its five (fused MHSA with dropout 0.1 and
   lse, its backward replaying the mask, the fused MLP with dropout 0.1 and
   the saved pre-GELU hidden, the fused MLP backward, patchify with the
   patch rows, and patchify at a K of 315 that its rows pass pads to whole
   16-byte rows; every output compared, the saved ones too), then the flash
   attention kernel B10 at the vit-t16 B8 serving shapes (the head views
   of the packed qkv, 1001 rows) and streaming at N = 2353, then A, B, B8
   and the packed-qkv VJP of ``fused_mhsa`` at head dim 128 (vit-b16 with
   ``dim_head: 128``, B8), then A, B and B8 at head dims 192 and 256
   (vit-b16 widths, 12 heads, B8), with B10 beside SDPA on the head views
   of each of those packed projections, then B11 (``csrc/int8_linear.cu``) at
   the GAViKO vit-l16 B8 int8 serving shapes (8,320 rows: the qkv
   projection with its LN, the out-projection with its bias, which must be
   bit-equal to its plain version, the MLP and the last layer's 264-row
   MLP), vit-b16's residual MLP and vit-b16's out-projection at
   ``dim_head`` 192 (2304 -> 768, bit-equal too), with the max ULP against
   the plain version, the int8 bound (1,979 TOPS), the fp chain the route
   replaces and ``torch._int_mm`` of the same codes (``int_mm_ms``: the
   library's int8 products alone, timed only), then the general instances of A, B and B10 at head dims 320
   and 512 (B2, 4 heads) and of B8 at 96 and 320 (B8), then A and B at 16
   heads of 1344 and B10 at 1352 (B1: the forward tile's streamed-Q plan,
   B's streamed owned rows), then B12, the LN +
   linear backward (``csrc/ln_linear_bwd.cu``), at the shapes the two
   hybrid train runs give it (vit-b16 B8: 8,064 rows, 768 -> 2,304;
   GAViKO vit-l16 B4: 4,160 rows, 1,024 -> 3,072), with dW and without,
   beside autograd's chain of the LN + linear backward, then B9 and B12 at
   widths above 1,024 that JAX's gates admit (Queue C 11: 8,064 rows, 1,152
   -> 1,152, 2,048 -> 768 and 1,280 -> 768); then B7's outputs
   on fixed inputs, bit-equal (sha256) to the digests of the kernel on
   ``csrc/gemm_sm90.cuh`` at its 128 x 128 tile, B12's bit-equal to the
   digests of B12 on the same GEMM, both also at the GEMM's other compiled
   tile (``TILE_DIGEST_BLOCKS``: bf16); then the tile phase: each GEMM
   instance's registers and spills from ptxas (no C7514), then B6, B7, B9,
   B12, B11 and patchify on each compiled tile of the GEMM
   (``ops/_blocks.py``; B6 and B7 through ``GAVIKO_MLP_BLOCK``, B9 and B12
   through ``GAVIKO_LNL_BLOCK``, B11 and patchify through their ``block``
   argument) against their plain versions under the same budgets, reruns
   bit-equal, the plan's launches on the forced tile, and each tile's ms
   beside the policy's tile and the chain's, at vit-b16 B8 (8,064 rows, bf16
   and fp32) and B64 (64,512, bf16), GAViKO int8 B8 (8,320 rows), and
   below one wave of 128-row tiles (bf16 and int8: vit-b16 B1, GAViKO's
   last layer at B8, 264 rows; these also as CUDA graph replays), and
   patchify at GAViKO B8 and vit-b16 B1; then A's and B10's outputs on fixed
   inputs bit-equal (sha256) to the tile's before Q's chunks could stream,
   then C and D (dropout 0.2, B4) at a latent of 64 on GAViKO's grid, at
   GAViKO's grid for image_size 224 (10x14x14) and at the latents of Queue
   C 12 on GAViKO's grid (640 in fp32, 1,168 in bf16: D's passes stream
   S's depth in chunks), beside SDPA with the dense window mask; C's and
   D's outputs on fixed inputs at latents 20 and 64 bit-equal (sha256) to
   the digests in ``LOCAL_DIGESTS`` (the kernels before the chunked passes
   came). Every case of patchify, A, B10, B, B8, C, D, B6, B7, B9, B12 and
   B11 also runs again and must be bit-equal to its first run; patchify,
   A, B10, B, C, D, B6, B7, B9 and B12 in fp32 are bounded at 495 / 3
   TFLOP/s (each product as three TF32 ones);
4. serving, for GAViKO vit-l16 (``gaviko_tpu_torch/configs/gaviko.yaml``), the
   plain vit-b16 ViT (``gaviko_tpu_torch/configs/vit.yaml``, method ``fft``),
   vit-t16 (the same config with ``model.backbone: vit-t16``: 3 heads, the
   unfused attention route, B10 in 11 layers) and vit-b16 with
   ``model.dim_head`` 128, 192 and 256 (A at that head dim, B8 in the last
   layer), the last four built in memory: builds the ``Predictor`` (bf16, micro-batch 8, random
   weights from seed 0), starts ``serve()`` on 127.0.0.1, POSTs 16
   synthetic (120, 160, 160) volumes, 8 at a time, and checks the answers,
   ``/healthz``, ``/metrics`` and every kernel's launches: each batch is
   one forward, which launches each kernel ``serving_launches`` times
   (GAViKO: none of the vit-b16 kernels; the ViTs by the gates);
5. plain check, after each serving phase: one batch's served logits
   against the same params run through the plain versions on the card
   (relative MAE <= 2e-2), the end-to-end volumes/s of ``predict_logits``
   at B8 bf16, one forward under ``torch.profiler`` (device busy ms, wall
   ms, idle share) and, for vit-b16, one forward at B64 (the JAX bench's
   headline batch) in CUDA-event ms; then int8 serving: GAViKO vit-l16,
   vit-b16 fft and vit-b16 at ``dim_head`` 192 with ``quantize="int8"``
   (bf16 weights quantized after the cast) served as in phase 4 with 2
   int8_linear and 1 int8_mlp calls a layer (the vit-b16 CLS-fast last
   layer deferring to them), the plain check at 1e-2 (vit-b16 at 2e-2),
   the profiled forward's B11 kernels counted by name (a layer: the row
   pass 3, the linear GEMM 2, fc1, the hidden's codes and fc2 1 each), and
   the logits against the bf16 fp
   predictor's on the same volumes (relative MAE <= 5e-2, argmax agreement
   reported);
6. train: the GAViKO vit-l16 model of the same config (random init from
   seed 0, frozen backbone, full depth) through ``split_params``,
   ``make_optimizer`` and ``make_steps``: 3 train steps and one eval step
   at B4 on synthetic volumes, at the config's fp32 (TF32 off) and at
   bf16, with per-step loss, step ms (CUDA events), volumes/s, peak memory
   and the launches of each kernel a step (each of the four attention
   kernels 24 a step, and B13, the multi-tensor Adam, once after its norm
   kernel);
7. train check: the same 3 steps, seeds and batches inside
   ``plain_versions()``: fp32 per-step loss within 1e-4 relative, step-1
   logits within 1e-4 and step-1 gradients of the loss (every trainable
   tensor) within 1e-3 relative MAE; bf16 loss within 2e-2, logits within
   1e-2, gradient cosine >= 0.99 and relative MAE <= 5e-2. Where a bf16
   logit crosses an edge of the focal loss's clamp between the two runs,
   the gradients are gated under one logits cotangent instead, and the
   loss gradients' difference is split into the kernels' and the clamp's
   shares (see ``phase_train_check``);
8. vit-b16 train and train check: phases 6 and 7 for the plain ViT of
   ``gaviko_tpu_torch/configs/vit.yaml``, method ``fft`` (every tensor trains;
   dropout and emb_dropout 0.1; random init from seed 0; full depth), at
   B8: 3 train steps and one eval step in fp32 (TF32 off) and bf16, with
   the exact launches a step (bf16: patchify 1 and each of A, B, B6 and B7
   11; fp32, where the fused MLP's gate is false: patchify 1, A and B 11),
   then the same steps through the plain versions under ``TRAIN_BUDGET``;
   then the hybrid train route (``GAVIKO_LNQKV_HYBRID=1``, set for these
   runs only): the same vit-b16 steps in fp32 and bf16, whose qkv takes B12
   as its backward in each full layer (11 a step), and GAViKO vit-l16 with
   ``freeze_vit: false`` at B4 in bf16 (B12 in all 24 global layers), each
   with its train check;
9. vit-t16 train and train check: phases 6 and 7 for vit-t16 at B8, with
   the config's dropout 0.1 (plain attention with ``layers.dropout`` on
   the probabilities: no attention kernel) in fp32 and bf16, and
   dropout-free in bf16 (B10 in 3 layers a step, its backward the plain
   version's VJP), at CUT_DEPTH (4) layers;
10. vit-b16 with ``dim_head: 128``, train and train check in fp32 and bf16
   (A and B at head dim 128 in 3 layers a step), and with 192 and 256 in
   bf16, at CUT_DEPTH (4) layers; then ``train.fused_optimizer: false``
   (``chain``): vit-b16 fft at CUT_DEPTH, 3 fp32 steps with the optax
   chain's state (``ChainState``) against the same steps with the fused
   state, losses and params within CHAIN_BUDGET, B13 once a step;
11. B13 (``csrc/fused_adam.cu``) at the trainable leaves of the GAViKO train
   run (604 tensors, 2.27 M elements: one cooperative launch) and of the
   vit-b16 fft run (140, 88.2 M: two launches), in f32 and bf16 storage
   with the cycled beta1, clipping off and on, on fresh leaves and on
   leaves at odd element offsets of one buffer (16-byte vectors after a
   scalar head, and grads one element off their moments: element by
   element): every output against the plain version (2 f32 ULP, 1 bf16
   ULP, of each output's largest term), two runs bit-equal, and the
   kernel's, the plain version's and PyTorch's foreach-norm + fused-Adam
   chain's ms, the bound, and the device kernels of one
   ``fused_optim.step`` under the profiler;
12. trainer check: the first two steps of the trainer phase's run (GAViKO
   vit-l16 from its loader) with the kernels and through the plain
   versions, fp32 with TF32 off: params within 1e-4 relative MAE;
13. trainer: ``python -m gaviko_tpu_torch.cli.train`` on 12 synthetic
   (120, 160, 160) volumes (8 train, 4 val) with a copy of gaviko.yaml
   (vit-l16, B4, fp32, 2 epochs, save_threshold -1, the second step
   profiled), again with 3 epochs and ``--resume auto``, then
   ``cli.evaluate`` on the best checkpoint and ``cli.infer`` on the folder:
   the 15-field CSV with a row a step, the resume at epoch 2, the
   trainable-only checkpoint, 4 eval and 12 inference rows, and the
   profiled step's ms, volumes/s, idle share and launches (B13's too: one
   kernel, its leaves' gradients fitting in L2);
14. the rest of the PEFT zoo (``ZOO``: deep and shallow VPT, AdaptFormer,
   SSF, MeLO, DVPT, EVP), each from its shipped config (vit-b16, full
   width and depth, random init from seed 0; shallow VPT is vpt.yaml with
   ``deep_prompt: false``): one B8 bf16 batch through ``predict_logits``
   with the launches ``zoo_launches`` derives from the gates, against the
   plain versions (relative MAE <= 2e-2), and one profiled forward; the
   same with ``quantize="int8"`` (``zoo_launches(..., quantized=True)``,
   also against the method's bf16 logits by INT8_FP_BUDGET; SSF logs the
   JAX package's refusal and serves full precision); then 3 train steps
   and one eval step at B8 in fp32 (TF32 off) and bf16 with exact launches
   a step and a profiled step, each with its train check under
   ``TRAIN_BUDGET``;
15. weights: a synthetic vit-l16 timm file (timm's in21k inventory and
   shapes, 1.3 GB, from seed 0) converted by ``weights/convert.py`` and
   loaded onto the card by ``build_params`` for GAViKO: every landed key
   bit-equal to the converted array, the 24 to_qkv biases dropped, the
   seconds writing, converting and loading;
16. augment: ``ops/augment.train_augment`` at GAViKO's B4 (4, 1, 120, 160,
   160) f32, every volume warped, both methods against the same call on
   the CPU (<= 1e-5 absolute), ms a batch; the GAViKO B4 bf16 train step's
   ms with and without device augmentation;
17. loader (host): the rescale's and the int16 widening's GB/s on one
   volume; two epochs of the 12 synthetic volumes (the first with the
   engine's start) through the threaded loader, ``grain`` on threads and on 2 processes,
   raw and with the host train transform, volumes/s, batches bit-equal;
18. trainer_input: ``cli.train`` in this process on gaviko.yaml switched as
   gaviko_tpu.yaml switches it (``data.loader: grain`` on 2 processes,
   ``train.device_augment``, bf16), starting from phase 15's timm file, 1
   epoch: a CSV row a step, each train step's wrapped-kernel launches
   exactly ``gaviko_train_launches(spec, "bf16")``, the frozen backbone
   still the converted tensors, the profiled step's trace;
19. parallel_one: ``cli.train`` in this process on
   ``gaviko_tpu_torch/configs/gaviko_tpu.yaml`` (``train.parallel`` on,
   ``data: auto``: a 1 x 1 mesh; vit-l16 GAViKO, bf16, device augmentation,
   the grain loader, B8), overridden in one epoch and the paths (24 train
   and 8 val synthetic volumes): every train step is ``ParallelTrainer``'s
   (none from ``make_steps``) with exactly ``gaviko_train_launches(spec,
   "bf16")``, the CSV, the resume state and the best checkpoint written.
   Where tensorstore imports (phase 1 says), ``checkpoint_backend: orbax``
   runs as shipped: the resume directory, then a second ``cli.train
   --resume auto`` at two epochs that resumes from it and trains epoch 2
   only; without tensorstore the option must refuse naming it, and the run
   takes ``checkpoint_backend: npz``;
20. parallel_two: 2 ranks spawned on cuda:0 over gloo (NCCL refuses two
   ranks on one card), one spawn for every job, after the 1-rank runs:
   GAViKO vit-l16 (gaviko_tpu.yaml) with data 2 and ZeRO, then model 2
   (the frozen backbone's heads and hidden split), vit.yaml fft at depth 2
   with model 2 and ``GAVIKO_LNQKV_HYBRID=1`` (B6, B7, B9, B12 and B8 on
   their shards) and with data 2, ZeRO and ``accumulation_steps: 2`` (four
   micro-steps, B13 on the ZeRO slices of the running mean at the second
   and fourth), and MeLO, SSF and AdaptFormer (their shipped configs at
   vit-b16 widths and CUT_DEPTH layers) with model 2: the bf16 steps of the
   global batch 8 and one eval step each, against a 1-rank run of the same
   batches and seeds under the bf16 train-check budgets (per-step loss; the
   update, mu and nu of the resume state the ranks gather, with the 1-rank
   state's leaves), each rank's launches a step the 1-rank step's, and the
   wall and collective seconds a step (gloo through the host: not NCCL
   figures); then GAViKO vit-l16 int8 serving (``quantize="int8"``, B8
   bf16) on data 2 and on model 2, rank 0's logits against phase 5's
   1-rank int8 logits (INT8_PLAIN_BUDGET) and each rank's launches of a
   forward exactly ``serving_launches(spec, True)``; then the mesh
   artifacts of PAR_ARTIFACTS (GAViKO vit-l16 and vit-b16 ``fft`` at 2 x 1
   and 1 x 2, AdaptFormer at 1 x 2; B8 bf16, exported for cuda in this
   process) against the live ``Predictor(mesh_shape=...)`` (bit-equal, and
   on a rerun) and the single-device logits, each rank's launches and
   collectives those of its program; the vit-b16 1 x 2 rank 0's kernel ops
   through ``torch.library.opcheck`` at its shard arguments, then
   ``serve()`` over that artifact: 16 POSTs 8 at a time equal to
   ``predict_logits``, /healthz, /reload;
21. parallel_kernels: A and B on heads 8..15 of vit-l16's 16 (B4, 1,040
   rows, dropout 0.1) against their plain versions and bit-equal to the
   whole layer's kernels on those heads; B13's sharded step (its norm
   kernel into a device scalar, then its update) at GAViKO's trainable
   leaves bit-equal to its one-launch step;
22. deploy (run on the live predictors of phases 4 and 5, right after
   their own checks): GAViKO vit-l16 (B8 bf16), vit-t16 (B10 in the
   program) and vit-b16 ``fft`` int8 exported by
   ``deploy.export_artifact`` for ``cuda`` (the manifest's ``gaviko::``
   ops exactly ``serving_launches``), loaded in a ``DeployedPredictor``
   and bit-equal to the live ``Predictor`` on the same 8 volumes, then 16
   volumes served 8 at a time through ``serve()`` with exact launches a
   batch, against the live predictor's served logits (relative MAE <=
   2e-2, int8 1e-2; bit-equality reported); export s,
   artifact MB, load s, first-forward ms, ``predict_logits`` vol/s beside
   the live predictor's, a B8 forward's ms eager, from the predictor's
   program and from the program as exported (its per-call checks kept), and
   the host µs a call of A and C eagerly and through their ``gaviko::``
   ops; the int8 artifact then reloads a checkpoint of one quantized
   weight (sidecars re-quantized as ``quantize_weight`` does, exact
   launches after); ``cli.export`` -> ``cli.infer --artifact`` on
   vit.yaml and a folder of 8 volumes (``deploy_cli``); and
   ``torch.library.opcheck`` of every ``gaviko::`` op on the card with the
   arguments those artifacts gave it (B10 at the vit-t16 serving shapes),
   and B10 at head dim 36 (``opcheck``).

It then prints the kernels as one JSON line (the local attention kernels
at GAViKO's B4 fp32 train shapes with the fp32 train run's launches;
patchify, A, B, B6 and B7 at the vit-b16 B8 bf16 train shapes with the
vit-b16 bf16 train run's launches; LN+linear and CLS attention at the
vit-b16 B8 bf16 serving shapes with the vit-b16 serving run's launches;
B10 at the vit-t16 B8 bf16 serving shapes with the vit-t16 serving run's
launches; rows ``*_dh128``, ``*_dh192`` and ``*_dh256`` for A, B and B8 at
those head dims with the dim_head-D bf16 train run's or serving run's
launches; ``fused_adam_gaviko`` and ``fused_adam_vitb16`` for B13 at f32
storage with the GAViKO fp32 and vit-b16 bf16 train runs' launches;
``int8_linear`` and ``int8_mlp`` for B11 at the GAViKO vit-l16 B8 bf16
int8 serving shapes with that run's launches; ``ln_linear_bwd`` and
``ln_linear_bwd_l16`` for B12 at the vit-b16 and GAViKO vit-l16 bf16
hybrid train shapes with the bf16 hybrid runs' launches; on the rows of
the six kernels on the GEMM, ``tiles`` the policy's tile of each GEMM launch
at the row's shapes and ``tile_ms`` the tile phase's ms of each tile at its
nearest case (bf16); each row's
``zoo_launches`` the launches a forward or a step of every zoo run that
launched it, ``deploy_launches`` its launches in the first forward (one
batch) of each artifact of phase 22 that launched it, ``trainer_input_launches`` its launches in the last train
step of phase 18 and, on the rows at the parallel runs' head dim and
widths, ``parallel_launches`` its launches a step in phases 19 and 20 on
rank 0 and in the vit-b16 tensor-parallel eval step), the
nvidia-smi line, and as its last line ``{"ok": true, "device":
{...}}``. Any failure exits non-zero before that line; without a CUDA
device it exits 2.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

CONFIG = "gaviko_tpu_torch/configs/gaviko.yaml"
VIT_CONFIG = "gaviko_tpu_torch/configs/vit.yaml"
B = 8
HEADLINE_B = 64  # the JAX bench's vit-b16 serving batch
N_REQUESTS = 16
BF16_BUDGET, F32_BUDGET, SERVE_BUDGET = 1e-2, 1e-4, 2e-2
TRAIN_B, TRAIN_STEPS, TRAIN_TOTAL_STEPS = 4, 3, 100
# Layers of the vit-t16 and head-dim train runs (phases 9-10): they check
# routes and kernels at a head count or head dim, which depth does not
# change; cut to keep the whole run well inside its time limit.
CUT_DEPTH = 4
VIT_TRAIN_B = 8  # vit.yaml's batch_size
LOCAL_RATE, LOCAL_SEED = 0.2, 1234567
VIT_RATE, VIT_SEED = 0.1, -7654321  # vit.yaml's dropout
KERNEL_CALLS = 10  # back-to-back calls a timed kernel, library or plain sample
# Train-check budgets: (loss relative, step-1 logits relative MAE, gradient
# relative MAE, cosine floor).
TRAIN_BUDGET = {"fp32": (1e-4, F32_BUDGET, 1e-3, None),
                "bf16": (2e-2, BF16_BUDGET, 5e-2, 0.99)}
# Trainer check: relative MAE of the update two fp32 steps applied against
# the plain path's (H100 readings 3.6e-7 and 2.0e-6; 1 for no update).
TRAINER_UPDATE_BUDGET = 1e-4
# fused_optimizer: false against the fused state, the same B13 steps: losses
# (relative) and params (absolute) after three fp32 steps.
CHAIN_BUDGET = 1e-6
# H100 SXM peaks (NVIDIA's data sheet; dense, 700 W): bytes/s and ops/s by
# input type. f32 is held to the SIMT rate, but for A, B10, B, C, D, B6, B7,
# B9, B12 and patchify, which run each f32 product as three TF32 ones on the
# tensor cores (495e12 / 3).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12, "torch.int8": 1979e12,
            "3xtf32": 495e12 / 3}
# Head dims above what the forward tile holds resident (ROADMAP Queue C 6):
# A and B at 16 heads of 1344 (JAX's fused gate admits it), B10 at 1352,
# one batch of 1,001 rows padded to 1,008.
WIDE_MHSA, WIDE_FLASH, WIDE_HEADS = 1344, 1352, 16
SOURCES = {
    "patchify": ("gaviko_tpu_torch/csrc/patchify.cu", "gaviko_tpu/ops/patchify.py:50"),
    "fused_mhsa": ("gaviko_tpu_torch/csrc/fused_mhsa.cu",
                   "gaviko_tpu/ops/flash_attention.py:309"),
    "fused_mhsa_bwd": ("gaviko_tpu_torch/csrc/fused_mhsa_bwd.cu",
                       "gaviko_tpu/ops/flash_attention.py:494"),
    "local_attention": ("gaviko_tpu_torch/csrc/local_attention.cu",
                        "gaviko_tpu/ops/flash_attention.py:830"),
    "local_attention_bwd": ("gaviko_tpu_torch/csrc/local_attention_bwd.cu",
                            "gaviko_tpu/ops/flash_attention.py:946"),
    "ln_linear": ("gaviko_tpu_torch/csrc/ln_linear.cu", "gaviko_tpu/ops/ln_linear.py:58"),
    "ln_linear_bwd": ("gaviko_tpu_torch/csrc/ln_linear_bwd.cu",
                      "gaviko_tpu/ops/ln_linear.py:144"),
    "fused_mlp": ("gaviko_tpu_torch/csrc/fused_mlp.cu", "gaviko_tpu/ops/fused_mlp.py:116"),
    "fused_mlp_bwd": ("gaviko_tpu_torch/csrc/fused_mlp_bwd.cu",
                      "gaviko_tpu/ops/fused_mlp.py:340"),
    "cls_attention": ("gaviko_tpu_torch/csrc/cls_attention.cu",
                      "gaviko_tpu/ops/cls_attention.py:58"),
    "flash_attention": ("gaviko_tpu_torch/csrc/flash_attention.cu",
                        "gaviko_tpu/ops/flash_attention.py:183"),
    "fused_adam": ("gaviko_tpu_torch/csrc/fused_adam.cu", "gaviko_tpu/ops/fused_adam.py:30"),
    "int8_linear": ("gaviko_tpu_torch/csrc/int8_linear.cu", "gaviko_tpu/ops/int8_linear.py:66"),
    "int8_mlp": ("gaviko_tpu_torch/csrc/int8_linear.cu", "gaviko_tpu/ops/int8_linear.py:122"),
}
# int8 serving (B11): GAViKO's int8 logits against the same predictor
# through the plain versions (vit-b16's at SERVE_BUDGET: bf16 rounds at
# other points in its fp kernels and their plain versions, and a code that
# moves at a rounding boundary carries through 12 unpooled layers; an H100
# read 1.79e-2), and each against the bf16 fp predictor's on the same
# volumes (JAX's own int8-vs-fp budget). The PEFT zoo's int8 runs take
# vit-b16's budgets (H100 readings: against the plain versions 5.4e-3 to
# 1.59e-2, deep VPT the highest; against bf16 8.3e-3 to 2.0e-2).
INT8_PLAIN_BUDGET, INT8_FP_BUDGET = 1e-2, 5e-2
# B11 cases that must equal their plain version bit for bit (no LN: the
# same codes, int32 sums and roundings).
BIT_EQUAL = ("int8_linear_out", "int8_linear_out2304")
# The general instances of A, B, B10 (head dims 320 and 512) and B8 (96,
# 320): kernel cases only, as no shipped model has those head dims.
GENERAL_DIM_HEADS = (320, 512)
GENERAL_CLS = ((96, 8), (320, 4))  # (head dim, heads): heads * dim_head % 128 == 0
# The kernels of the JSON line by the path whose shapes and launches they
# are reported at.
LINE_PATH = {"local_attention": "train", "local_attention_bwd": "train",
             "ln_linear": "vit", "cls_attention": "vit", "patchify": "vit_train",
             "fused_mhsa": "vit_train", "fused_mhsa_bwd": "vit_train",
             "fused_mlp": "vit_train", "fused_mlp_bwd": "vit_train",
             "flash_attention": "t16", "int8_linear": "int8", "int8_mlp": "int8"}
# The head-dim-128, 192 and 256 instances of A, B and B8, reported as rows of
# their own at the vit-b16 dim_head-D shapes: row name -> (kernel, the run
# whose launches the row carries).
DIM_HEADS = (128, 192, 256)
# B8 has no row at 256: at vit-b16 widths (12 x 256 = 3072) its gate, JAX's
# VMEM budget, is false, so that path runs no B8 (its kernel case still runs).
DH_ROWS = {row: (kernel, run) for d in DIM_HEADS for row, kernel, run in (
    (f"fused_mhsa_dh{d}", "fused_mhsa", f"dh{d}_train"),
    (f"fused_mhsa_bwd_dh{d}", "fused_mhsa_bwd", f"dh{d}_train"),
    (f"cls_attention_dh{d}", "cls_attention", f"dh{d}")) if (kernel, d) != ("cls_attention", 256)}
# Configurations built in memory from vit.yaml (method fft): vit-t16 (3
# heads, the unfused attention route) and vit-b16 with dim_head 128, 192 and
# 256 (the fused route at those head dims).
T16 = {"backbone": "vit-t16"}
DH = {d: {"dim_head": d} for d in DIM_HEADS}
# B13 rows, at the trainable leaves of the GAViKO fp32 train run and of the
# vit-b16 fft train run (whose bf16 precision keeps f32 masters and
# moments): row name -> the run whose leaves and launches the row carries.
ADAM_ROWS = {"fused_adam_gaviko": "train", "fused_adam_vitb16": "vit_train"}
ADAM_STEP = 40  # the step count whose lr and cycled beta1 the B13 cases take
# B12 at the shapes of the two runs with GAVIKO_LNQKV_HYBRID=1: (rows, dim,
# out) of vit-b16 B8 (8 x 1,001 rows padded to 1,008) and GAViKO vit-l16 B4
# (4 x 1,033 padded to 1,040), by row-name suffix; each with dW and without.
LN_BWD_SHAPES = {"": (8 * 1008, 768, 2304), "_l16": (4 * 1040, 1024, 3072)}
# The B12 rows of the JSON line (bf16): row name -> the run whose launches
# it carries.
LN_BWD_ROWS = {"ln_linear_bwd": "vit_train_hybrid", "ln_linear_bwd_l16": "gaviko_trainable_hybrid"}
# B9 and B12 at widths above 1,024 that JAX's gates admit (Queue C 11), at
# vit-b16 B8's rows: (rows, dim, out) by case-name suffix; B12 at the first.
C11_SHAPES = {"_c11": (8 * 1008, 1152, 1152), "_c11_2048": (8 * 1008, 2048, 768),
              "_c11_1280": (8 * 1008, 1280, 768)}
# sha256 of B7's seven outputs on the inputs of ``b7_digests`` (rows 2,002,
# dim 768, mlp 3,072, exact GELU, the residual, dropout 0.1), as the kernel
# redesigned on csrc/gemm_sm90.cuh gives them (read on an NVIDIA H100 80GB
# HBM3, CUDA 12.8; the redesign changed the order of its sums, so the bits
# before it are not these).
B7_DIGESTS = {
    "torch.bfloat16": "8f8cc55a30525e5318d4d0f91ad48ae3d6f57a388e7c31bf69319e202480f68c",
    "torch.float32": "19689bd4e03480e473fb903cb25b0389e5a081df7936da4dbb02c9d682c40529"}
# sha256 of B12's outputs on the inputs of ``b12_digests``, as the kernel
# redesigned on csrc/gemm_sm90.cuh gives them (read on an NVIDIA H100 80GB
# HBM3, CUDA 12.8; the redesign changed the order of its sums, so the bits
# before it are not these).
B12_DIGESTS = {
    "torch.bfloat16": "a4228266c2b75d7ff18e30b08425e99f4a04754c9ec2e843cd29b314f18a08b3",
    "torch.float32": "f49d3962ce0f76bd898d77f74c8b1b9aaba849b861706fe873b4e7407c98d2c0"}
# sha256 of B7's and B12's outputs on the inputs of ``b7_digests`` and
# ``b12_digests`` at the GEMM's other compiled tile (ops/_blocks.py: 64
# rows, bf16 only), by tile rows (read on an NVIDIA H100 80GB HBM3, CUDA
# 12.8): the 128-row digests, since no output of either sums across a tile's
# rows but B7's db1, whose partials a tile round to the same bf16.
TILE_DIGEST_BLOCKS = (64,)
B7_TILE_DIGESTS = {block: {"torch.bfloat16": B7_DIGESTS["torch.bfloat16"]}
                   for block in TILE_DIGEST_BLOCKS}
B12_TILE_DIGESTS = {block: {"torch.bfloat16": B12_DIGESTS["torch.bfloat16"]}
                    for block in TILE_DIGEST_BLOCKS}
# The tile phase: the six kernels on csrc/gemm_sm90.cuh at every compiled
# tile, at the shapes the tile policy (ops/_blocks.py) was set at. B6, B7,
# B9 and B12 by case suffix: (rows, dim, mlp, qkv, the kernels run there):
# vit-b16 at B8 and B64 (8 and 64 x 1,008 rows; fp32 at B8 only), and, in
# bf16 only, below one wave of 128-row tiles on 132 SMs: vit-b16 at B1
# (fc2 48 tiles) and GAViKO vit-l16's last layer at B8 (8 x 33 rows: B6's
# launches, B7's dg, B9). B11 at GAViKO vit-l16 int8 serving B8 (8 x 1,040
# rows, and the last layer's 8 x 33); patchify at GAViKO B8 (8,000 rows,
# 3,072 -> 1,024) and at vit-b16 B1 (1,000 rows to 768: 48 tiles).
_VIT_KERNELS = ("fused_mlp", "fused_mlp_bwd", "ln_linear", "ln_linear_bwd")
TILE_CASES = {"": (8 * 1008, 768, 3072, 2304, _VIT_KERNELS),
              "_b64": (64 * 1008, 768, 3072, 2304, _VIT_KERNELS),
              "_b1": (1008, 768, 3072, 2304, ("fused_mlp",)),
              "_last": (8 * 33, 1024, 4096, 3072, ("fused_mlp", "fused_mlp_bwd", "ln_linear"))}
# Cases below one wave: host-bound calls, so each tile is also timed as a
# CUDA graph replay (``_graph_ms``), the card's time alone.
BELOW_WAVE = ("_b1", "_last")
# sha256 of A's and B10's outputs on the inputs of ``attention_digests``, as
# the forward tile gave them before Q's chunks could stream and its pieces
# moved into csrc/hopper.cuh (read on an NVIDIA H100 80GB HBM3, CUDA 12.8):
# the instances that fit resident must stay bit-equal.
ATTN_DIGESTS = {
    "fused_mhsa_serving_bf16": "c49cf64d79922116a7dceb19fde170e28f06c8f22bbd696f5660460bcf14682b",
    "fused_mhsa_train_f32": "fec69a322de58182853a9669f620c7d2920528d405360145a52c54523c9c0131",
    "flash_attention_t16_bf16": "0121f4fa7ddf7c6350ba37db01d4e88bb4a30b442ebd94048e3c1f9b09d65ac5",
    "flash_attention_t16_f32": "9c4fd498b4adbd72e44a100b0865ff36cbac19b9b60d66fdbe036e1337d1b8a7",
    "fused_mhsa_dh512_bf16": "508e52df9a782ff71fe93b7df4c3938ab148811909af6160e52b34c6c215d253",
    "flash_attention_dh512_bf16": "306fd9a38aac45ad940eeaf80104e216f5a0ea05fe323256cc02c32641b4ba79",
}
# sha256 of C's and D's outputs on the inputs of scripts/local_digests.py
# (GAViKO's grid, B4, dropout 0.2, latents 20 and 64), as the kernels gave
# them before Queue C 12's chunked passes came (read on an NVIDIA H100 80GB
# HBM3, CUDA 12.8): the latents whose staged rows fit stay bit-equal.
LOCAL_DIGESTS = {
    "dl20_bf16": "1bd788f5a34d18584d9b85858f8e83f309a636eadd2797fd069b653b21639e8e",
    "dl20_f32": "cd02928edc45a424f936d59d114f7b2a06166336ba8d939dd81059452e2a5efe",
    "dl64_bf16": "4d20586c8dfea6bcf387cfe1811ec0d0e12c8bfced0463f32390f7bd15dc1f94",
    "dl64_f32": "cdc2f4932f28c2f77ad0c7185072281b9fa1e81f0d8350a5d14fce60e666d053",
}
TRAINER_VOLUMES = (8, 4)  # train and val volumes of the trainer phase
# The PEFT zoo's shipped configs (vit-b16, B8): (method, config, model
# entries replaced in memory); shallow VPT is vpt.yaml with deep_prompt off.
ZOO = (("deep_vpt", "gaviko_tpu_torch/configs/vpt.yaml", None),
       ("shallow_vpt", "gaviko_tpu_torch/configs/vpt.yaml", {"deep_prompt": False}),
       ("adaptformer", "gaviko_tpu_torch/configs/adaptformer.yaml", None),
       ("ssf", "gaviko_tpu_torch/configs/ssf.yaml", None),
       ("melo", "gaviko_tpu_torch/configs/melo.yaml", None),
       ("dvpt", "gaviko_tpu_torch/configs/dvpt.yaml", None),
       ("evp", "gaviko_tpu_torch/configs/evp.yaml", None))


def _ptxas(log: str) -> list:
    """Each kernel's registers and spills from nvcc's ``-Xptxas -v`` log, as
    "<kernel name><template arguments of its mangled name>: <what ptxas
    said>"."""
    import re

    def name(line):  # the length-prefixed "<...>kernel" of the mangled name, then its arguments
        for run in re.finditer(r"\d+", line):
            for k in range(len(run.group())):
                at, n = run.end(), int(run.group()[k:])
                if line[at:at + n].endswith("kernel") and line[at + n:at + n + 1] == "I":
                    args = re.match(r"I(.*?)EEEv", line[at + n:])
                    return line[at:at + n] + (args.group(1) if args else "")
        return line.split("'")[1][-40:]

    out, kernel = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = name(line)
        elif "registers" in line or "spill" in line:
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return out


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _rel_mae(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().mean() / want.abs().mean().clamp_min(1e-30))


def _rel_mae_np(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).mean() / max(np.abs(want).mean(), 1e-30))


def _median_ms(fn, reps: int = 20, warmup: int = 3, calls: int = 1) -> float:
    """Median over ``reps`` of the CUDA-event ms of ``calls`` back-to-back
    calls, per call. With several calls the host enqueues the next launch
    while the card runs the last one, so a short kernel's time is not its
    host launch overhead."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def _graph_ms(fn, reps: int = 20) -> float:
    """Median device ms per call of ``fn``, KERNEL_CALLS calls captured in
    one CUDA graph and replayed: no host time between launches (what a
    short kernel such as B8 takes on the card, apart from the host's
    enqueueing, which ``_median_ms`` includes where it is the longer)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(KERNEL_CALLS):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / KERNEL_CALLS)
    return statistics.median(times)


def _tensor_core_f32(name: str) -> bool:
    """A case whose f32 products run as three TF32 ones on the tensor cores
    (A, B10, B and the packed-qkv VJP of A then B; C and D; B6 and B7; B9
    and B12; patchify's GEMM), bounded at 495 / 3 TFLOP/s."""
    return name.startswith(("fused_mhsa", "flash_attention", "local_attention", "fused_mlp",
                            "ln_linear", "patchify"))


def _rerun_bit_equal(name: str) -> bool:
    """A case whose rerun must be bit-equal: no atomics in A, B10, B, C, D,
    B6, B7, B9, B12 and patchify, the partials of B8, of C and D's split
    warps and of B7's and B12's column sums combined in a fixed order, and
    B11's int32 sums and row maxima (exact in any order)."""
    return name.startswith(("fused_mhsa", "flash_attention", "cls_attention",
                            "local_attention", "fused_mlp", "int8", "ln_linear", "patchify"))


def _bound(work, dtype) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for the input type (or "3xtf32")."""
    nbytes, ops = work
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[str(dtype)]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _window_pairs(DHW, local_k) -> int:
    """(query, key) pairs inside the 3-D window: what the local kernels
    compute for each batch entry."""
    from gaviko_tpu_torch.ops.local_attention import local_mask_additive_np

    return int((local_mask_additive_np(tuple(DHW), tuple(local_k)) == 0).sum())


def _sdpa_grad(q, k, v, g, **kw):
    """One autograd backward of F.scaled_dot_product_attention (the graph
    is built once, outside the timed call)."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().contiguous().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(*leaves, **kw)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def _mlp_chain(x, gamma, beta, w1, b1, w2, b2, rate=0.0):
    """x + [dropout] fc2([dropout] GELU(fc1(LN(x)))) as PyTorch's chain of
    calls."""
    import torch.nn.functional as F

    h = F.gelu(F.linear(F.layer_norm(x, (x.shape[-1],), gamma, beta, 1e-5), w1, b1))
    return x + F.dropout(F.linear(F.dropout(h, rate), w2, b2), rate)


def _mlp_chain_grad(args, dy):
    """One autograd backward of :func:`_mlp_chain` (the graph is built once,
    outside the timed call)."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in args]
    with torch.enable_grad():
        out = _mlp_chain(*leaves)
    return lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)


def _kernel_cases(dtype, gen, batch, train):
    """Cases at the shapes the GAViKO vit-l16 path gives each kernel:
    (name, call, compare, work, library, chain). ``call`` runs the kernel,
    or its plain version inside ``plain_versions()``; ``compare`` cuts what
    is compared from its result; ``work`` is (bytes, operations) the
    function needs; ``library`` is the one PyTorch call that computes the
    same function, or None; ``chain`` the chain of PyTorch calls that does
    where no one call does, or None. ``train`` adds the backward kernels
    and the local dropout of the train step."""
    import torch
    import torch.nn.functional as F

    from gaviko_tpu_torch.ops.flash_attention import (
        flash_local_attention, fused_mhsa, fused_mhsa_bwd, local_attention_bwd,
        local_reference, mhsa_reference)
    from gaviko_tpu_torch.ops.local_attention import local_mask_additive
    from gaviko_tpu_torch.ops.patchify import patchify_fused

    dev, H, D, n_pad, n_true = "cuda", 16, 64, 1040, 1033
    DHW, local_k, dl, n_tok = (10, 10, 10), (6, 6, 6), 20, 1000
    mhsa_scale, local_scale = D ** -0.5, 1024 ** -0.5

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    img = torch.rand(batch, 1, 120, 160, 160, generator=gen, device=dev).to(dtype)
    w = randn(1024, 1, 12, 16, 16, std=0.02)
    bias = randn(1024, std=0.02)
    qkv = randn(batch, n_pad, 3 * 1024)
    q, k, v = randn(batch, n_tok, 3 * dl).split(dl, dim=-1)
    rate = LOCAL_RATE if train else 0.0
    pairs = batch * _window_pairs(DHW, local_k)
    mhsa_products = batch * H * n_pad * n_true * D  # multiply-adds of one product
    heads4 = qkv.view(batch, n_pad, 3, H, D).permute(2, 0, 3, 1, 4)
    key_mask = (torch.arange(n_pad, device=dev) < n_true).view(1, 1, 1, n_pad)
    win_mask = local_mask_additive(DHW, local_k, device=dev).to(dtype)
    out_bytes = batch * n_tok * 1024 * img.element_size()
    cases = [
        ("patchify", lambda: patchify_fused(img, w, bias), lambda r: r,
         (_nbytes(img, w, bias) + out_bytes, 2 * batch * n_tok * 1024 * w[0].numel()),
         lambda: F.conv3d(img, w, bias, stride=(12, 16, 16)), None),
        ("fused_mhsa", lambda: fused_mhsa(qkv, H, D, mhsa_scale, n_true, with_lse=train),
         (lambda r: (r[0][:, :n_true], r[1])) if train else (lambda r: r[:, :n_true]),
         (_nbytes(qkv) * 4 // 3 + (batch * H * n_pad * 4 if train else 0),
          4 * mhsa_products),
         lambda: F.scaled_dot_product_attention(*heads4, attn_mask=key_mask), None),
        ("local_attention", lambda: flash_local_attention(
            q, k, v, local_scale, DHW, local_k, rate, LOCAL_SEED), lambda r: r,
         (4 * batch * n_tok * dl * img.element_size() + batch * n_tok * 4, 4 * dl * pairs),
         lambda: F.scaled_dot_product_attention(
             q[:, None], k[:, None], v[:, None], attn_mask=win_mask, scale=local_scale),
         None),
    ]
    if not train:
        return cases
    with torch.no_grad():
        out, lse = mhsa_reference(qkv, H, D, mhsa_scale, n_true, with_lse=True)
        lout, llse = local_reference(q, k, v, local_scale, DHW, local_k, rate,
                                     LOCAL_SEED, with_lse=True)
    dout = randn(batch, n_pad, H * D)
    dout[:, n_true:] = 0  # pad rows carry no cotangent on the train path
    ldout = randn(batch, n_tok, dl)
    dout4 = dout.view(batch, n_pad, H, D).transpose(1, 2)
    cases += [
        ("fused_mhsa_bwd", lambda: fused_mhsa_bwd(qkv, out, lse, dout, H, D, mhsa_scale,
                                                  n_true), lambda r: r,
         (_nbytes(qkv, out, dout, lse, qkv), 10 * mhsa_products),
         _sdpa_grad(*heads4, dout4, attn_mask=key_mask), None),
        ("local_attention_bwd", lambda: local_attention_bwd(
            q, k, v, lout, llse, ldout, local_scale, DHW, local_k, rate, LOCAL_SEED),
         lambda r: r,
         (_nbytes(q, k, v, lout, ldout, llse) + 3 * _nbytes(ldout), 10 * dl * pairs),
         _sdpa_grad(q[:, None], k[:, None], v[:, None], ldout[:, None],
                    attn_mask=win_mask, scale=local_scale), None),
    ]
    return cases


def _local_kernel_cases(dtype, gen, batch):
    """Cases (as in :func:`_kernel_cases`) for kernels C and D (dropout
    0.2) at shapes they refused before ROADMAP Queue C items 8 and 12 were
    repaired: GAViKO's 10x10x10 grid with a latent of 64 (q, k, v views of
    [B, 1000, 192]), GAViKO's grid at image_size 224 (10x14x14, 1960 rows)
    with its latent of 20, and GAViKO's grid with a latent of 640 in f32 or
    1,168 in bf16 (Queue C 12: D's passes stream S's depth in chunks).
    Kernel cases only: no shipped config has them. The library call is SDPA
    with the dense additive window mask."""
    import torch
    import torch.nn.functional as F

    from gaviko_tpu_torch.ops.flash_attention import (
        flash_local_attention, local_attention_bwd, local_reference)
    from gaviko_tpu_torch.ops.local_attention import local_mask_additive

    dev, local_k, scale = "cuda", (6, 6, 6), 1024 ** -0.5
    cases = []
    c12 = (("dl640", (10, 10, 10), 640) if dtype == torch.float32
           else ("dl1168", (10, 10, 10), 1168))
    for tag, DHW, dl in (("dl64", (10, 10, 10), 64), ("g224", (10, 14, 14), 20), c12):
        n_tok = DHW[0] * DHW[1] * DHW[2]
        q, k, v = torch.randn(batch, n_tok, 3 * dl, generator=gen, device=dev).to(
            dtype).split(dl, dim=-1)
        dout = torch.randn(batch, n_tok, dl, generator=gen, device=dev).to(dtype)
        with torch.no_grad():
            out, lse = local_reference(q, k, v, scale, DHW, local_k, LOCAL_RATE, LOCAL_SEED,
                                       with_lse=True)
        pairs = batch * _window_pairs(DHW, local_k)
        mask = local_mask_additive(DHW, local_k, device=dev).to(dtype)
        size = q.element_size()
        cases += [
            (f"local_attention_{tag}", lambda q=q, k=k, v=v, DHW=DHW: flash_local_attention(
                q, k, v, scale, DHW, local_k, LOCAL_RATE, LOCAL_SEED), lambda r: r,
             (4 * batch * n_tok * dl * size + batch * n_tok * 4, 4 * dl * pairs),
             lambda q=q, k=k, v=v, mask=mask: F.scaled_dot_product_attention(
                 q[:, None], k[:, None], v[:, None], attn_mask=mask, scale=scale), None),
            (f"local_attention_bwd_{tag}", lambda q=q, k=k, v=v, out=out, lse=lse, dout=dout,
             DHW=DHW: local_attention_bwd(q, k, v, out, lse, dout, scale, DHW, local_k,
                                          LOCAL_RATE, LOCAL_SEED), lambda r: r,
             (_nbytes(q, k, v, out, dout, lse) + 3 * _nbytes(dout), 10 * dl * pairs),
             _sdpa_grad(q[:, None], k[:, None], v[:, None], dout[:, None], attn_mask=mask,
                        scale=scale), None),
        ]
    return cases


def _vit_kernel_cases(dtype, gen, batch):
    """Cases (as in :func:`_kernel_cases`) at the shapes the vit-b16 serving
    path gives its three kernels: the LN+qkv and LN+kv projections, the
    fused MLP with the residual (the config's exact GELU) and the CLS
    attention of the last layer. The bytes and operations count what this
    run's inputs need: the CLS attention reads the keys below n_true."""
    import torch
    import torch.nn.functional as F

    from gaviko_tpu_torch.ops.cls_attention import cls_attention
    from gaviko_tpu_torch.ops.fused_mlp import fused_mlp
    from gaviko_tpu_torch.ops.ln_linear import fused_ln_linear

    dev, H, D, n_pad, n_true, dim, mlp = "cuda", 12, 64, 1008, 1001, 768, 3072
    inner = H * D
    rows = batch * n_pad

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    x = randn(batch, n_pad, dim)
    gamma, beta = (1.0 + randn(dim, std=0.1)).to(dtype), randn(dim, std=0.1)
    w_qkv = randn(3 * inner, dim, std=dim ** -0.5)
    w1, b1 = randn(mlp, dim, std=dim ** -0.5), randn(mlp, std=0.1)
    w2, b2 = randn(dim, mlp, std=mlp ** -0.5), randn(dim, std=0.1)
    kv, q0 = randn(batch, n_pad, 2 * inner), randn(batch, inner)
    size = x.element_size()
    key_mask = (torch.arange(n_pad, device=dev) < n_true).view(1, 1, 1, n_pad)
    q4 = q0.view(batch, H, 1, D)
    k4, v4 = kv.view(batch, n_pad, 2, H, D).permute(2, 0, 3, 1, 4)
    cases = []
    for name, w in (("ln_linear", w_qkv), ("ln_linear_kv", w_qkv[inner:])):
        cases.append((
            name, lambda w=w: fused_ln_linear(x, gamma, beta, w), lambda r: r,
            (_nbytes(x, gamma, beta, w) + rows * w.shape[0] * size,
             2 * rows * dim * w.shape[0]),
            None, lambda w=w: F.linear(F.layer_norm(x, (dim,), gamma, beta, 1e-5), w)))
    cases += [
        ("fused_mlp",
         lambda: fused_mlp(x, gamma, beta, w1, b1, w2, b2, 1e-5, "exact", residual=True),
         lambda r: r, (_nbytes(x, gamma, beta, w1, b1, w2, b2, x), 4 * rows * dim * mlp),
         None,
         lambda: x + F.linear(F.gelu(F.linear(F.layer_norm(x, (dim,), gamma, beta, 1e-5),
                                              w1, b1)), w2, b2)),
        ("cls_attention", lambda: cls_attention(kv, q0, H, D, D ** -0.5, n_true), lambda r: r,
         (batch * n_true * 2 * inner * size + 2 * _nbytes(q0), 4 * batch * n_true * inner),
         lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=key_mask), None),
    ]
    return cases


def _vit_train_kernel_cases(dtype, gen, batch):
    """Cases (as in :func:`_kernel_cases`) at the shapes the vit-b16 train
    step gives its five kernels: fused MHSA with dropout and lse, its
    backward replaying the mask, the fused MLP with dropout, the residual
    and the saved pre-GELU hidden, the fused MLP backward, patchify with the
    patch rows (and, at a small geometry, with a K of 315 that the rows pass
    pads to whole 16-byte rows). Every output is compared, the saved ones
    too."""
    import torch
    import torch.nn.functional as F

    from gaviko_tpu_torch.ops.flash_attention import (
        fused_mhsa, fused_mhsa_bwd, mhsa_reference)
    from gaviko_tpu_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_forward, mlp_reference
    from gaviko_tpu_torch.ops.patchify import patchify_kernel

    dev, H, D, n_pad, n_true, dim, mlp = "cuda", 12, 64, 1008, 1001, 768, 3072
    n_tok, patch = 1000, 12 * 16 * 16
    inner, rows, scale = H * D, batch * n_pad, D ** -0.5

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    qkv = randn(batch, n_pad, 3 * inner)
    dout = randn(batch, n_pad, inner)
    dout[:, n_true:] = 0  # pad rows carry no cotangent on the train path
    x, dy = randn(batch, n_pad, dim), randn(batch, n_pad, dim)
    gamma, beta = (1.0 + randn(dim, std=0.1)).to(dtype), randn(dim, std=0.1)
    w1, b1 = randn(mlp, dim, std=dim ** -0.5), randn(mlp, std=0.1)
    w2, b2 = randn(dim, mlp, std=mlp ** -0.5), randn(dim, std=0.1)
    mlp_args = (x, gamma, beta, w1, b1, w2, b2)
    img = torch.rand(batch, 1, 120, 160, 160, generator=gen, device=dev).to(dtype)
    w, bias, pos = randn(dim, 1, 12, 16, 16, std=0.02), randn(dim, std=0.02), randn(n_tok, dim)
    img3 = torch.rand(2, 3, 6, 10, 14, generator=gen, device=dev).to(dtype)
    w3, b3, pos3 = randn(36, 3, 3, 5, 7, std=0.05), randn(36, std=0.02), randn(8, 36)
    with torch.no_grad():
        out, lse = mhsa_reference(qkv, H, D, scale, n_true, VIT_RATE, with_lse=True,
                                  seed=VIT_SEED)
        _, a = mlp_reference(*mlp_args, 1e-5, "exact", VIT_RATE, True, VIT_SEED, save_a=True)
    heads4 = qkv.view(batch, n_pad, 3, H, D).permute(2, 0, 3, 1, 4)
    dout4 = dout.view(batch, n_pad, H, D).transpose(1, 2)
    key_mask = (torch.arange(n_pad, device=dev) < n_true).view(1, 1, 1, n_pad)
    mhsa_products = batch * H * n_pad * n_true * D
    size = x.element_size()
    return [
        ("fused_mhsa", lambda: fused_mhsa(qkv, H, D, scale, n_true, VIT_RATE, with_lse=True,
                                          seed=VIT_SEED),
         lambda r: (r[0][:, :n_true], r[1]),
         (_nbytes(qkv) * 4 // 3 + _nbytes(lse), 4 * mhsa_products),
         lambda: F.scaled_dot_product_attention(*heads4, attn_mask=key_mask,
                                                dropout_p=VIT_RATE), None),
        ("fused_mhsa_bwd", lambda: fused_mhsa_bwd(qkv, out, lse, dout, H, D, scale, n_true,
                                                  VIT_RATE, VIT_SEED), lambda r: r,
         (_nbytes(qkv, out, dout, lse, qkv), 10 * mhsa_products),
         _sdpa_grad(*heads4, dout4, attn_mask=key_mask, dropout_p=VIT_RATE), None),
        ("fused_mlp", lambda: fused_mlp_forward(*mlp_args, 1e-5, "exact", VIT_RATE, True,
                                                VIT_SEED, save_a=True), lambda r: r,
         (_nbytes(*mlp_args, x) + rows * mlp * size, 4 * rows * dim * mlp),
         None, lambda: _mlp_chain(*mlp_args, VIT_RATE)),
        ("fused_mlp_bwd", lambda: fused_mlp_bwd(*mlp_args, dy, a, 1e-5, "exact", VIT_RATE,
                                                True, VIT_SEED), lambda r: r,
         (_nbytes(x, gamma, beta, w1, w2, dy, a) + _nbytes(*mlp_args), 8 * rows * dim * mlp),
         None, _mlp_chain_grad(mlp_args, dy)),
        ("patchify", lambda: patchify_kernel(img, w, bias, pos, save_rows=True), lambda r: r,
         (_nbytes(img, w, bias, pos) + batch * n_tok * (dim + patch) * size,
          2 * batch * n_tok * dim * patch),
         lambda: F.conv3d(img, w, bias, stride=(12, 16, 16)), None),
        # K = 3 x 3 x 5 x 7 = 315, no whole number of 16-byte vectors: the
        # rows pass pads the patch matrix (and the weight) to whole rows
        ("patchify_k315", lambda: patchify_kernel(img3, w3, b3, pos3, save_rows=True),
         lambda r: r, (_nbytes(img3, w3, b3, pos3) + 2 * 8 * (36 + 315) * size,
                       2 * 2 * 8 * 36 * 315),
         lambda: F.conv3d(img3, w3, b3, stride=(3, 5, 7)), None),
    ]


def _ln_linear_chain_grad(x, gamma, beta, w, dy, need_dw):
    """One autograd backward of ``F.linear(F.layer_norm(x), w)`` (the graph
    is built once, outside the timed call); W a leaf only when ``need_dw``."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta)]
    wl = w.detach().requires_grad_(need_dw)
    with torch.enable_grad():
        y = F.linear(F.layer_norm(leaves[0], (x.shape[-1],), leaves[1], leaves[2], 1e-5), wl)
    targets = leaves + [wl] if need_dw else leaves
    return lambda: torch.autograd.grad(y, targets, dy, retain_graph=True)


def _ln_bwd_kernel_cases(dtype, gen):
    """Cases (as in :func:`_kernel_cases`) for B12 at LN_BWD_SHAPES, with
    dW and without (a frozen W): x, gamma, beta, W and a cotangent dy whose
    rows have about unit norm. No one PyTorch call computes this function;
    the chain is autograd's backward of LN and the linear."""
    import torch

    from gaviko_tpu_torch.ops.ln_linear import ln_linear_bwd

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    cases = []
    for suffix, (rows, dim, out) in LN_BWD_SHAPES.items():
        x = randn(rows, dim)
        gamma, beta = (1.0 + randn(dim, std=0.1)).to(dtype), randn(dim, std=0.1)
        w, dy = randn(out, dim, std=dim ** -0.5), randn(rows, out, std=out ** -0.5)
        for need_dw in (True, False):
            outs = (x, gamma, beta, w) if need_dw else (x, gamma, beta)
            cases.append((
                f"ln_linear_bwd{suffix}" + ("" if need_dw else "_no_dw"),
                lambda x=x, gamma=gamma, beta=beta, w=w, dy=dy, need_dw=need_dw: ln_linear_bwd(
                    x, gamma, beta, w, dy, 1e-5, need_dw),
                lambda r: tuple(t for t in r if t is not None),
                (_nbytes(x, gamma, beta, w, dy, *outs), 2 * (1 + need_dw) * rows * out * dim),
                None, _ln_linear_chain_grad(x, gamma, beta, w, dy, need_dw)))
    return cases


def _c11_kernel_cases(dtype, gen):
    """Cases (as in :func:`_kernel_cases`) for B9 at C11_SHAPES and B12 (with
    dW) at the first: widths above 1,024 that JAX's gates admit, which the
    port refused before its LN + linear kernels moved to the GEMM (Queue C
    11). No shipped backbone has them; their chains are PyTorch's LN and
    linear, and autograd's backward of them."""
    import torch
    import torch.nn.functional as F

    from gaviko_tpu_torch.ops.ln_linear import fused_ln_linear, ln_linear_bwd

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    cases = []
    for suffix, (rows, dim, out) in C11_SHAPES.items():
        x = randn(rows, dim, std=2.0) + 0.5
        gamma, beta = (1.0 + randn(dim, std=0.1)).to(dtype), randn(dim, std=0.1)
        w = randn(out, dim, std=dim ** -0.5)
        cases.append((
            f"ln_linear{suffix}", lambda x=x, gamma=gamma, beta=beta, w=w: fused_ln_linear(
                x, gamma, beta, w), lambda r: r,
            (_nbytes(x, gamma, beta, w) + rows * out * x.element_size(), 2 * rows * dim * out),
            None, lambda x=x, gamma=gamma, beta=beta, w=w: F.linear(
                F.layer_norm(x, (x.shape[-1],), gamma, beta, 1e-5), w)))
        if suffix == "_c11":
            dy = randn(rows, out, std=out ** -0.5)
            cases.append((
                f"ln_linear_bwd{suffix}", lambda x=x, gamma=gamma, beta=beta, w=w, dy=dy:
                ln_linear_bwd(x, gamma, beta, w, dy, 1e-5, True),
                lambda r: r, (_nbytes(x, gamma, beta, w, dy, x, gamma, beta, w),
                              4 * rows * out * dim),
                None, _ln_linear_chain_grad(x, gamma, beta, w, dy, True)))
    return cases


def _digests(name: str, call, arrays, dtypes=None) -> dict:
    """sha256 of the outputs of ``call(*tensors)``, by dtype, on ``arrays``
    (numpy) put on the card in ``dtypes`` (bf16 and fp32); two calls must
    agree bit for bit."""
    import hashlib

    import torch

    digests = {}
    for dtype in dtypes or (torch.bfloat16, torch.float32):
        args = [torch.from_numpy(a.astype(np.float32)).to("cuda", dtype) for a in arrays]
        runs = []
        for _ in range(2):
            h = hashlib.sha256()
            for t in call(*args):
                if t is not None:
                    h.update(t.float().cpu().numpy().tobytes())
            runs.append(h.hexdigest())
        if runs[0] != runs[1]:
            raise RuntimeError(f"{name} {dtype}: two calls differ")
        digests[str(dtype)] = runs[0]
    return digests


@contextlib.contextmanager
def _env(name: str, value: Optional[str]):
    """Environment variable ``name`` set to ``value`` (None: unset) inside."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _tile_dtypes(block: int) -> tuple:
    """bf16 and fp32 where each has a compiled tile of ``block`` rows
    (ops/_blocks.py's TILES)."""
    import torch

    from gaviko_tpu_torch.ops import _blocks

    return tuple(dt for dt in (torch.bfloat16, torch.float32)
                 if any(bm == block for bm, _ in _blocks.TILES[dt]))


def b7_digests(block: int = 128) -> dict:
    """sha256 of B7's seven outputs, by dtype, on inputs made with numpy
    (see B7_DIGESTS), every launch on tiles of ``block`` rows
    (``GAVIKO_MLP_BLOCK``); two calls must agree bit for bit."""
    from gaviko_tpu_torch.ops import _blocks
    from gaviko_tpu_torch.ops.fused_mlp import fused_mlp_bwd

    rows, dim, mlp = 2002, 768, 3072
    rng = np.random.RandomState(0)
    arrays = (rng.randn(rows, dim), 1.0 + 0.1 * rng.randn(dim), 0.1 * rng.randn(dim),
              rng.randn(mlp, dim) * dim ** -0.5, 0.1 * rng.randn(mlp),
              rng.randn(dim, mlp) * mlp ** -0.5, 0.1 * rng.randn(dim), rng.randn(rows, dim),
              rng.randn(rows, mlp))
    with _env(_blocks.MLP_ENV, str(block)):
        return _digests("B7", lambda *t: fused_mlp_bwd(*t, 1e-5, "exact", VIT_RATE, True,
                                                       VIT_SEED), arrays, _tile_dtypes(block))


def b12_digests(block: int = 128) -> dict:
    """sha256 of B12's four outputs (with dW), by dtype, at the vit-b16
    hybrid shapes on inputs made with numpy (see B12_DIGESTS), its GEMM
    launch on tiles of ``block`` rows (``GAVIKO_LNL_BLOCK``); two calls must
    agree bit for bit."""
    from gaviko_tpu_torch.ops import _blocks
    from gaviko_tpu_torch.ops.ln_linear import ln_linear_bwd

    rows, dim, out = LN_BWD_SHAPES[""]
    rng = np.random.RandomState(1)
    arrays = (2.0 * rng.randn(rows, dim) + 0.5, 1.0 + 0.1 * rng.randn(dim), 0.1 * rng.randn(dim),
              rng.randn(out, dim) * dim ** -0.5, rng.randn(rows, out) * out ** -0.5)
    with _env(_blocks.LNL_ENV, str(block)):
        return _digests("B12", lambda *t: ln_linear_bwd(*t, 1e-5, True), arrays,
                        _tile_dtypes(block))


def phase_b7_bits(card: str) -> None:
    """B7's and B12's outputs on fixed inputs bit-equal to the digests of
    their kernels on csrc/gemm_sm90.cuh: at 128 x 128 to B7_DIGESTS and
    B12_DIGESTS (the tile before the tile policy), at the other compiled
    tiles to B7_TILE_DIGESTS and B12_TILE_DIGESTS."""
    got = {"b7": b7_digests(), "b12": b12_digests()}
    want = {"b7": B7_DIGESTS, "b12": B12_DIGESTS}
    for block in TILE_DIGEST_BLOCKS:
        got[f"b7_{block}"], got[f"b12_{block}"] = b7_digests(block), b12_digests(block)
        want[f"b7_{block}"] = B7_TILE_DIGESTS.get(block)
        want[f"b12_{block}"] = B12_TILE_DIGESTS.get(block)
    print(json.dumps({"phase": "b7_bits", "digests": got, "want": want, "card": card}),
          flush=True)
    if got != want:
        raise RuntimeError(f"B7 or B12 outputs changed: {got} != {want}")


# The GEMM launches of each kernels-line row on csrc/gemm_sm90.cuh, at the
# row's shapes in bf16: (plan function, its arguments, the plan's launches).
LINE_TILES = {
    "patchify": ("patchify", (8, 1, (120, 160, 160), (12, 16, 16), 768), "products"),
    "fused_mlp": ("mlp", (8 * 1008, 768, 3072), "forward"),
    "fused_mlp_bwd": ("mlp", (8 * 1008, 768, 3072), "backward"),
    "ln_linear": ("ln_linear", ("forward", 8 * 1008, 768, 2304), "products"),
    "ln_linear_bwd": ("ln_linear", ("backward", *LN_BWD_SHAPES[""]), "products"),
    "ln_linear_bwd_l16": ("ln_linear", ("backward", *LN_BWD_SHAPES["_l16"]), "products"),
    "int8_linear": ("int8", ("linear", 8 * 1040, 1024, 3072), "products"),
    "int8_mlp": ("int8", ("mlp", 8 * 1040, 1024, 4096), "products"),
}


def _line_tiles(row: str) -> list:
    """The tiles (BM, BN) the policy gives each GEMM launch of a kernels-line
    row (LINE_TILES), as the environment stands."""
    import torch

    from gaviko_tpu_torch.ops.fused_mlp import mlp_plan
    from gaviko_tpu_torch.ops.gemm_plan import patchify_plan
    from gaviko_tpu_torch.ops.int8_linear import int8_plan
    from gaviko_tpu_torch.ops.ln_linear import ln_linear_plan

    kind, args, field = LINE_TILES[row]
    plan = {"patchify": patchify_plan, "mlp": mlp_plan, "ln_linear": ln_linear_plan,
            "int8": int8_plan}[kind](*args, torch.bfloat16)
    return [list(launch[0].tile_shape) for launch in getattr(plan, field)]


def _tile_cases(dtype, gen):
    """The tile phase's cases in ``dtype``: (name, the operand dtype of its
    GEMM's tiles, run(block) -> the kernel's result on tiles of ``block``
    rows (None: the policy's), tiles() -> the tiles its plan gives each
    GEMM launch as the environment stands, compare, work, chain). B6 and B7
    take the tile through GAVIKO_MLP_BLOCK, B9 and B12 through
    GAVIKO_LNL_BLOCK, B11 and patchify through their ``block`` argument."""
    import torch
    import torch.nn.functional as F

    from gaviko_tpu_torch.ops import _blocks
    from gaviko_tpu_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_forward, mlp_plan
    from gaviko_tpu_torch.ops.gemm_plan import patchify_plan
    from gaviko_tpu_torch.ops.int8_linear import int8_linear, int8_mlp, int8_plan, quantize_weight
    from gaviko_tpu_torch.ops.ln_linear import fused_ln_linear, ln_linear_bwd, ln_linear_plan
    from gaviko_tpu_torch.ops.patchify import patchify_kernel

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    def tiles_of(*launches):
        return [list(launch[0].tile_shape) for launch in launches]

    def by_env(env, fn):
        def run(block):
            with _env(env, None if block is None else str(block)):
                return fn()
        return run

    bf16 = dtype == torch.bfloat16
    cases = []
    for suffix, (rows, dim, mlp, qkv, kernels) in TILE_CASES.items():
        if suffix and not bf16:
            continue
        x, dy = randn(rows, dim), randn(rows, dim)
        gamma, beta = (1.0 + randn(dim, std=0.1)).to(dtype), randn(dim, std=0.1)
        w1, b1 = randn(mlp, dim, std=dim ** -0.5), randn(mlp, std=0.1)
        w2, b2 = randn(dim, mlp, std=mlp ** -0.5), randn(dim, std=0.1)
        args = (x, gamma, beta, w1, b1, w2, b2)
        with torch.no_grad():
            _, a = fused_mlp_forward(*args, 1e-5, "exact", VIT_RATE, True, VIT_SEED, save_a=True)
        w_qkv, g_qkv = randn(qkv, dim, std=dim ** -0.5), randn(rows, qkv, std=qkv ** -0.5)
        mplan = lambda rows=rows, dim=dim, mlp=mlp: mlp_plan(rows, dim, mlp, dtype)  # noqa: E731
        lplan = lambda kind, rows=rows, dim=dim, qkv=qkv: ln_linear_plan(  # noqa: E731
            kind, rows, dim, qkv, dtype)
        vit = {
            "fused_mlp": (by_env(_blocks.MLP_ENV, lambda args=args: (
                fused_mlp_forward(*args, 1e-5, "exact", 0.0, True))),
                lambda mplan=mplan: tiles_of(*mplan().forward),
                (2 * _nbytes(x) + _nbytes(*args[1:]), 4 * rows * dim * mlp),
                lambda args=args: _mlp_chain(*args)),
            "fused_mlp_bwd": (by_env(_blocks.MLP_ENV, lambda args=args, dy=dy, a=a: (
                fused_mlp_bwd(*args, dy, a, 1e-5, "exact", VIT_RATE, True, VIT_SEED))),
                lambda mplan=mplan: tiles_of(*mplan().backward),
                (_nbytes(*args, dy, a, *args), 8 * rows * dim * mlp), _mlp_chain_grad(args, dy)),
            "ln_linear": (by_env(_blocks.LNL_ENV, lambda x=x, g=gamma, b=beta,
                                 w=w_qkv: fused_ln_linear(x, g, b, w)),
                          lambda lplan=lplan: tiles_of(*lplan("forward").products),
                          (_nbytes(x, gamma, beta, w_qkv, g_qkv), 2 * rows * dim * qkv),
                          lambda x=x, g=gamma, b=beta, w=w_qkv, dim=dim: F.linear(
                              F.layer_norm(x, (dim,), g, b, 1e-5), w)),
            "ln_linear_bwd": (by_env(
                _blocks.LNL_ENV, lambda x=x, g=gamma, b=beta, w=w_qkv, d=g_qkv: ln_linear_bwd(
                    x, g, b, w, d, 1e-5, True)),
                lambda lplan=lplan: tiles_of(*lplan("backward").products),
                (_nbytes(x, gamma, beta, w_qkv, g_qkv, x, gamma, beta, w_qkv),
                 4 * rows * dim * qkv),
                _ln_linear_chain_grad(x, gamma, beta, w_qkv, g_qkv, True)),
        }
        for kernel in kernels:
            run, tiles, work, chain = vit[kernel]
            cases.append((f"{kernel}{suffix}", dtype, run, tiles, lambda r: r, work, chain))
    # patchify: GAViKO B8, 8 volumes of 120 x 160 x 160 in 12 x 16 x 16
    # patches (8,000 rows of 3,072) to vit-l16's 1,024; in bf16 also vit-b16
    # B1 (1,000 rows to 768).
    for suffix, b, dim in (("", 8, 1024), ("_b1", 1, 768))[:2 if bf16 else 1]:
        img = torch.rand(b, 1, 120, 160, 160, generator=gen, device="cuda").to(dtype)
        pw, pb = randn(dim, 1, 12, 16, 16, std=0.02), randn(dim, std=0.02)
        cases.append((
            f"patchify{suffix}", dtype, lambda block, img=img, pw=pw, pb=pb: patchify_kernel(
                img, pw, pb, block=block),
            lambda b=b, dim=dim: tiles_of(*patchify_plan(b, 1, (120, 160, 160), (12, 16, 16), dim,
                                                         dtype).products), lambda r: r,
            (_nbytes(img, pw, pb) + b * 1000 * dim * img.element_size(),
             2 * b * 1000 * 3072 * dim),
            lambda img=img, pw=pw, pb=pb: F.conv3d(img, pw, pb, stride=(12, 16, 16))))
    if not bf16:
        return cases
    # B11 at GAViKO vit-l16 int8 serving B8 (bf16 activations): the qkv
    # projection with its LN and the MLP at 8,320 rows, and both at the last
    # layer's 264 pooled rows.
    i8, d, h = torch.int8, 1024, 4096
    for suffix, rows in (("", 8 * 1040), ("_last", 8 * 33)):
        x = randn(rows, d)
        gamma, beta = (1.0 + randn(d, std=0.1)).to(dtype), randn(d, std=0.1)
        wq, sq = quantize_weight(randn(3 * d, d, std=d ** -0.5))
        w1, s1 = quantize_weight(randn(h, d, std=d ** -0.5))
        w2, s2 = quantize_weight(randn(d, h, std=h ** -0.5))
        b1, b2 = randn(h, std=0.1), randn(d, std=0.1)
        margs = (x, gamma, beta, w1, s1, b1, w2, s2, b2, 1e-5, "exact", False)
        cases += [
            (f"int8_linear{suffix}", i8, lambda block, x=x, wq=wq, sq=sq, g=gamma, b=beta:
             int8_linear(x, wq, sq, gamma=g, beta=b, block=block),
             lambda rows=rows: tiles_of(*int8_plan("linear", rows, d, 3 * d, dtype).products),
             lambda r: r, (_nbytes(x, wq, sq, gamma, beta) + rows * 3 * d * x.element_size(),
                           2 * rows * d * 3 * d), None),
            (f"int8_mlp{suffix}", i8, lambda block, margs=margs: int8_mlp(*margs, block=block),
             lambda rows=rows: tiles_of(*int8_plan("mlp", rows, d, h, dtype).products),
             lambda r: r, (2 * _nbytes(x) + _nbytes(w1, s1, b1, w2, s2, b2, gamma, beta),
                           4 * rows * d * h), None),
        ]
    return cases


def phase_tiles(card: str, logs: dict) -> dict:
    """The tile phase: first each GEMM instance's registers and spills from
    the build's ptxas ``logs`` (the build fails the phase where ptxas
    serialised an instance's wgmma, C7514); then for each case of
    :func:`_tile_cases` in bf16 and fp32 (TF32 off), the kernel on each
    compiled tile of its operand dtype against its plain version (the
    budgets of phase 3), a rerun bit-equal, the plan's tiles under the
    forcing (each launch on the forced tile), and the kernel's ms a tile
    beside the policy's tile and its chain's ms; below one wave
    (BELOW_WAVE) also each one's CUDA-graph ms. Returns {(name, dtype):
    line}."""
    import torch

    from gaviko_tpu_torch.ops import _blocks
    from gaviko_tpu_torch.ops._build import plain_versions

    serialised = [ln.strip() for log in logs.values() for ln in log.splitlines()
                  if "C7514" in ln and "gemm_kernel" in ln]
    print(json.dumps({"phase": "tiles_ptxas", "tiles": {str(dt): [list(t) for t in ts]
                                                        for dt, ts in _blocks.TILES.items()},
                      "gemm_kernels": {n: [ln for ln in _ptxas(log) if "gemm_kernel" in ln]
                                       for n, log in sorted(logs.items())},
                      "c7514": serialised, "sms": _blocks.sms(), "card": card}), flush=True)
    if serialised:
        raise RuntimeError(f"ptxas serialised a GEMM instance's wgmma: {serialised}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    results = {}
    for dtype, budget in ((torch.bfloat16, BF16_BUDGET), (torch.float32, F32_BUDGET)):
        for name, tdtype, run, tiles, cut, work, chain in _tile_cases(dtype, gen):
            rate = (torch.int8 if tdtype == torch.int8 else "3xtf32"
                    if dtype == torch.float32 else dtype)
            bound_ms, bound_by = _bound(work, rate)
            graphed = name.endswith(BELOW_WAVE)
            with torch.no_grad():
                with plain_versions():
                    want = cut(run(None))
                policy = tiles()
                line = {"phase": "tiles", "name": name, "dtype": str(dtype),
                        "policy": policy, "bound_ms": bound_ms, "bound_by": bound_by,
                        "chain_ms": None if chain is None else _median_ms(
                            chain, reps=10, calls=KERNEL_CALLS),
                        "by_tile": {}, "card": card}
                for bm, bn in _blocks.TILES[tdtype]:
                    got = cut(run(bm))
                    torch.cuda.synchronize()
                    rel, max_abs = _compare(got, want)
                    again = cut(run(bm))
                    pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
                    rerun_equal = all(torch.equal(a, b) for a, b in pairs)
                    if name.startswith(("fused_mlp", "ln_linear")):
                        env = _blocks.MLP_ENV if name.startswith("fused_mlp") else _blocks.LNL_ENV
                        with _env(env, str(bm)):
                            forced = tiles()
                    else:
                        forced = None  # the block argument reaches the plan directly
                    line["by_tile"][f"{bm}x{bn}"] = {
                        "rel_mae": rel, "max_abs_err": max_abs, "rerun_bit_equal": rerun_equal,
                        "ms": _median_ms(lambda: run(bm), reps=10, calls=KERNEL_CALLS)}
                    if graphed:
                        line["by_tile"][f"{bm}x{bn}"]["graph_ms"] = _graph_ms(lambda: run(bm))
                    if not rel <= budget:
                        raise RuntimeError(f"{name} {dtype} at {bm}x{bn}: rel MAE {rel} > {budget}")
                    if not rerun_equal:
                        raise RuntimeError(f"{name} {dtype} at {bm}x{bn}: a rerun differs")
                    if forced is not None and any(t != [bm, bn] for t in forced):
                        raise RuntimeError(f"{name}: {bm} rows forced, the plan gives {forced}")
                line["ms"] = _median_ms(lambda: run(None), reps=10, calls=KERNEL_CALLS)
                if graphed:
                    line["graph_ms"] = _graph_ms(lambda: run(None))
            results[(name, str(dtype))] = line
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return results


def attention_digests() -> dict:
    """sha256 of A's and B10's outputs on inputs made with numpy, by case
    (see ATTN_DIGESTS): A at GAViKO vit-l16 serving B8 bf16 (16 heads of
    64, 1,033 rows padded to 1,040) and train B4 fp32 with lse and dropout
    0.1, B10 at vit-t16 B8 (the head views of the packed qkv, 3 heads of
    64, 1,001 rows) in bf16 and fp32, and both at head dim 512 (B2, 4
    heads: the general instance) in bf16; two calls must agree bit for
    bit."""
    import hashlib

    import torch

    from gaviko_tpu_torch.ops.flash_attention import _split_heads, flash_attention, fused_mhsa

    rng = np.random.RandomState(11)

    def packed(*shape, dtype):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to("cuda", dtype)

    serve = packed(8, 1040, 3 * 1024, dtype=torch.bfloat16)
    train = packed(4, 1040, 3 * 1024, dtype=torch.float32)
    t16 = {dt: packed(8, 1008, 3 * 192, dtype=dt) for dt in (torch.bfloat16, torch.float32)}
    wide = packed(2, 1008, 3 * 2048, dtype=torch.bfloat16)
    views = {dt: [t[:, :, :1001] for t in _split_heads(x, 3, 64)] for dt, x in t16.items()}
    wide_views = [t[:, :, :1001] for t in _split_heads(wide, 4, 512)]
    cases = {
        "fused_mhsa_serving_bf16": lambda: fused_mhsa(serve, 16, 64, 0.125, 1033),
        "fused_mhsa_train_f32": lambda: fused_mhsa(train, 16, 64, 0.125, 1033, VIT_RATE,
                                                   with_lse=True, seed=VIT_SEED),
        "flash_attention_t16_bf16": lambda: flash_attention(*views[torch.bfloat16], 0.125),
        "flash_attention_t16_f32": lambda: flash_attention(*views[torch.float32], 0.125),
        "fused_mhsa_dh512_bf16": lambda: fused_mhsa(wide, 4, 512, 512 ** -0.5, 1001),
        "flash_attention_dh512_bf16": lambda: flash_attention(*wide_views, 512 ** -0.5),
    }
    digests = {}
    for name, run in cases.items():
        runs = []
        for _ in range(2):
            got = run()
            h = hashlib.sha256()
            for t in got if isinstance(got, tuple) else (got,):
                h.update(t.float().cpu().numpy().tobytes())
            runs.append(h.hexdigest())
        if runs[0] != runs[1]:
            raise RuntimeError(f"{name}: two calls differ")
        digests[name] = runs[0]
    return digests


def phase_attention_bits(card: str) -> None:
    """A and B10 bit-equal to their outputs before the repair of the head
    dims above 1280 (the tile's streamed-Q instance) and the move of the
    tile's pieces into csrc/hopper.cuh."""
    got = attention_digests()
    print(json.dumps({"phase": "attention_bits", "digests": got, "want": ATTN_DIGESTS,
                      "card": card}), flush=True)
    if got != ATTN_DIGESTS:
        raise RuntimeError(f"A / B10 outputs changed: {got} != {ATTN_DIGESTS}")


def phase_local_bits(card: str) -> None:
    """C's and D's outputs on fixed inputs at latents 20 and 64
    (``scripts/local_digests.py``) bit-equal to the kernels' before the
    chunked passes of Queue C 12 came (LOCAL_DIGESTS)."""
    from scripts.local_digests import local_digests

    got = local_digests()
    print(json.dumps({"phase": "local_bits", "digests": got, "want": LOCAL_DIGESTS,
                      "card": card}), flush=True)
    if got != LOCAL_DIGESTS:
        raise RuntimeError(f"C / D outputs changed: {got} != {LOCAL_DIGESTS}")


def _t16_kernel_cases(dtype, gen, batch):
    """Cases (as in :func:`_kernel_cases`) for B10: at the shapes the vit-t16
    serving path gives it (the head views of the packed qkv sliced to the
    1001 real rows, read in place), the same at batch 32 (a probe: four
    times the CTAs, to show what the one-wave grid of batch 8 costs), and
    streaming at N = 2353 (a 12x14x14 grid and the CLS token, longer than
    JAX's whole-K limit of 2048)."""
    import torch
    import torch.nn.functional as F

    from gaviko_tpu_torch.ops.flash_attention import _split_heads, flash_attention

    dev, H, D, n_pad, n_true, n_long = "cuda", 3, 64, 1008, 1001, 2353
    scale = D ** -0.5

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    qkv = randn(batch, n_pad, 3 * H * D)
    q, k, v = (t[:, :, :n_true] for t in _split_heads(qkv, H, D))
    q4, k4, v4 = (t[:, :, :n_true] for t in _split_heads(randn(4 * batch, n_pad, 3 * H * D), H, D))
    ql, kl, vl = (randn(2, H, n_long, D) for _ in range(3))
    size = qkv.element_size()

    def work(b, n):
        return 4 * b * H * n * D * size, 4 * b * H * n * n * D

    return [
        ("flash_attention", lambda: flash_attention(q, k, v, scale), lambda r: r,
         work(batch, n_true), lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
         None),
        (f"flash_attention_b{4 * batch}", lambda: flash_attention(q4, k4, v4, scale),
         lambda r: r, work(4 * batch, n_true),
         lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale), None),
        ("flash_attention_stream", lambda: flash_attention(ql, kl, vl, scale), lambda r: r,
         work(2, n_long), lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale),
         None),
    ]


def _dh_kernel_cases(dtype, gen, batch, D):
    """Cases (as in :func:`_kernel_cases`) for A, B and B8 at head dim D,
    at the vit-b16 dim_head-D shapes (12 heads, 1001 rows padded to 1008):
    A with dropout 0.1 and lse and B replaying the mask (the train step's),
    B8 (the serving forward's last layer), B10 on the head views of the
    packed qkv sliced to the 1001 real rows (read in place, beside SDPA;
    no shipped path reaches B10 at these head dims, as the fused gate
    holds there) and, at 128, the packed-qkv VJP of fused_mhsa (A then B
    under autograd)."""
    import torch
    import torch.nn.functional as F

    from gaviko_tpu_torch.ops.cls_attention import cls_attention
    from gaviko_tpu_torch.ops.flash_attention import (
        _split_heads, flash_attention, fused_mhsa, fused_mhsa_bwd, mhsa_reference)

    dev, H, n_pad, n_true = "cuda", 12, 1008, 1001
    inner, scale = H * D, D ** -0.5

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    qkv = randn(batch, n_pad, 3 * inner)
    dout = randn(batch, n_pad, inner)
    dout[:, n_true:] = 0  # pad rows carry no cotangent on the train path
    kv, q0 = randn(batch, n_pad, 2 * inner), randn(batch, inner)
    with torch.no_grad():
        out, lse = mhsa_reference(qkv, H, D, scale, n_true, VIT_RATE, with_lse=True,
                                  seed=VIT_SEED)
    heads4 = qkv.view(batch, n_pad, 3, H, D).permute(2, 0, 3, 1, 4)
    dout4 = dout.view(batch, n_pad, H, D).transpose(1, 2)
    key_mask = (torch.arange(n_pad, device=dev) < n_true).view(1, 1, 1, n_pad)
    k4, v4 = kv.view(batch, n_pad, 2, H, D).permute(2, 0, 3, 1, 4)
    products = batch * H * n_pad * n_true * D
    size = qkv.element_size()
    leaf = qkv.detach().requires_grad_(True)

    def vjp():
        with torch.enable_grad():
            return torch.autograd.grad(
                fused_mhsa(leaf, H, D, scale, n_true, VIT_RATE, seed=VIT_SEED), leaf, dout)[0]

    cases = [
        (f"fused_mhsa_dh{D}", lambda: fused_mhsa(qkv, H, D, scale, n_true, VIT_RATE,
                                                 with_lse=True, seed=VIT_SEED),
         lambda r: (r[0][:, :n_true], r[1]),
         (_nbytes(qkv) * 4 // 3 + _nbytes(lse), 4 * products),
         lambda: F.scaled_dot_product_attention(*heads4, attn_mask=key_mask,
                                                dropout_p=VIT_RATE), None),
        (f"fused_mhsa_bwd_dh{D}", lambda: fused_mhsa_bwd(qkv, out, lse, dout, H, D, scale,
                                                         n_true, VIT_RATE, VIT_SEED),
         lambda r: r, (_nbytes(qkv, out, dout, lse, qkv), 10 * products),
         _sdpa_grad(*heads4, dout4, attn_mask=key_mask, dropout_p=VIT_RATE), None),
        (f"cls_attention_dh{D}", lambda: cls_attention(kv, q0, H, D, scale, n_true),
         lambda r: r,
         (batch * n_true * 2 * inner * size + 2 * _nbytes(q0), 4 * batch * n_true * inner),
         lambda: F.scaled_dot_product_attention(q0.view(batch, H, 1, D), k4, v4,
                                                attn_mask=key_mask), None),
    ]
    q, k, v = (x[:, :, :n_true] for x in _split_heads(qkv, H, D))
    cases.append((f"flash_attention_dh{D}", lambda: flash_attention(q, k, v, scale),
                  lambda r: r, (4 * batch * H * n_true * D * size,
                                4 * batch * H * n_true * n_true * D),
                  lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), None))
    if D == 128:
        cases.append(("fused_mhsa_vjp_dh128", vjp, lambda r: r,
                      (_nbytes(qkv, dout, qkv), 14 * products), None, None))
    return cases


def _wide_kernel_cases(dtype, gen, batch):
    """Cases (as in :func:`_kernel_cases`) for A and B at WIDE_HEADS heads of
    WIDE_MHSA (A with dropout 0.1 and lse, B replaying the mask) and B10 at
    WIDE_FLASH on [batch, 3, 1001, D]: the forward tile's streamed-Q plan
    and B's streamed owned rows."""
    import torch
    import torch.nn.functional as F

    from gaviko_tpu_torch.ops.flash_attention import (
        flash_attention, fused_mhsa, fused_mhsa_bwd, mhsa_reference)

    dev, H, D, n_pad, n_true = "cuda", WIDE_HEADS, WIDE_MHSA, 1008, 1001
    inner, scale = H * D, D ** -0.5

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    qkv = randn(batch, n_pad, 3 * inner)
    dout = randn(batch, n_pad, inner)
    dout[:, n_true:] = 0
    with torch.no_grad():
        out, lse = mhsa_reference(qkv, H, D, scale, n_true, VIT_RATE, with_lse=True,
                                  seed=VIT_SEED)
    heads4 = qkv.view(batch, n_pad, 3, H, D).permute(2, 0, 3, 1, 4)
    dout4 = dout.view(batch, n_pad, H, D).transpose(1, 2)
    key_mask = (torch.arange(n_pad, device=dev) < n_true).view(1, 1, 1, n_pad)
    products = batch * H * n_pad * n_true * D
    q, k, v = (randn(batch, 3, n_true, WIDE_FLASH) for _ in range(3))
    return [
        (f"fused_mhsa_dh{D}", lambda: fused_mhsa(qkv, H, D, scale, n_true, VIT_RATE,
                                                 with_lse=True, seed=VIT_SEED),
         lambda r: (r[0][:, :n_true], r[1]),
         (_nbytes(qkv) * 4 // 3 + _nbytes(lse), 4 * products),
         lambda: F.scaled_dot_product_attention(*heads4, attn_mask=key_mask,
                                                dropout_p=VIT_RATE), None),
        (f"fused_mhsa_bwd_dh{D}", lambda: fused_mhsa_bwd(qkv, out, lse, dout, H, D, scale,
                                                         n_true, VIT_RATE, VIT_SEED),
         lambda r: r, (_nbytes(qkv, out, dout, lse, qkv), 10 * products),
         _sdpa_grad(*heads4, dout4, attn_mask=key_mask, dropout_p=VIT_RATE), None),
        (f"flash_attention_dh{WIDE_FLASH}", lambda: flash_attention(q, k, v, WIDE_FLASH ** -0.5),
         lambda r: r, (_nbytes(q, k, v, q), 4 * batch * 3 * n_true * n_true * WIDE_FLASH),
         lambda: F.scaled_dot_product_attention(q, k, v, scale=WIDE_FLASH ** -0.5), None),
    ]


def _int8_kernel_cases(dtype, gen, batch):
    """Cases (as in :func:`_kernel_cases`) for B11 at the shapes the GAViKO
    vit-l16 int8 serving path gives it (1,033 rows padded to 1,040, times
    the batch: 8,320 at B8): the qkv projection with its LN (1024 -> 3072),
    the out-projection with its bias (1024 -> 1024), the MLP (1024 -> 4096
    -> 1024, exact GELU, no residual) and the last layer's MLP on the 33
    pooled rows a volume; then vit-b16's residual MLP (8,064 rows, 768 ->
    3072 -> 768) and vit-b16's out-projection at ``dim_head`` 192 (2304 ->
    768, Queue C 10). The bytes count each input once (int8 weights, f32
    scales) and the output once; the operations are int8. ``chain`` is the
    fp calls the route replaces in the working dtype (F.layer_norm +
    F.linear; at vit-l16 B9 and B6 are gated off). Each case carries a
    seventh entry: ``torch._int_mm`` of the same codes, each product of
    the function once (the library's int8 product alone, without the
    quantization, the dequantization or the epilogue; timed only)."""
    import torch
    import torch.nn.functional as F

    from gaviko_tpu_torch.ops.fused_mlp import gelu_by_mode
    from gaviko_tpu_torch.ops.int8_linear import (
        _int8_matmul, _ln_f32, _quant_rows, fma_f32, int8_linear, int8_mlp, quantize_weight)

    dev, dim, mlp, vdim, vmlp = "cuda", 1024, 4096, 768, 3072
    rows, last, vrows = batch * 1040, batch * 33, batch * 1008

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    def ln(x, g, b):
        return F.layer_norm(x, (x.shape[-1],), g, b, 1e-5)

    def codes(xf):
        return _quant_rows(xf)[0].to(torch.int8)

    def int_mm(*pairs):
        return lambda: [torch._int_mm(a, w.t()) for a, w in pairs]

    def mlp_case(x, d, h, residual):
        g, b = (1.0 + randn(d, std=0.1)).to(dtype), randn(d, std=0.1)
        w1, b1 = randn(h, d, std=d ** -0.5), randn(h, std=0.1)
        w2, b2 = randn(d, h, std=h ** -0.5), randn(d, std=0.1)
        (q1, s1), (q2, s2) = quantize_weight(w1), quantize_weight(w2)
        n = x.shape[0]
        hc, sh = _quant_rows(_ln_f32(x.float(), g, b, 1e-5))
        a = fma_f32(_int8_matmul(hc, q1), sh * s1.reshape(-1), b1.float())
        gc = codes(gelu_by_mode(a, "exact"))

        def chain():
            y = F.linear(F.gelu(F.linear(ln(x, g, b), w1, b1)), w2, b2)
            return x + y if residual else y

        return (lambda: int8_mlp(x, g, b, q1, s1, b1, q2, s2, b2, 1e-5, "exact", residual),
                (2 * _nbytes(x) + _nbytes(q1, s1, b1, q2, s2, b2, g, b), 4 * n * d * h), chain,
                int_mm((hc.to(torch.int8), q1), (gc, q2)))

    x = randn(rows, dim)
    gamma, beta = (1.0 + randn(dim, std=0.1)).to(dtype), randn(dim, std=0.1)
    w_qkv, w_out, b_out = (randn(3 * dim, dim, std=dim ** -0.5), randn(dim, dim, std=dim ** -0.5),
                           randn(dim, std=0.1))
    (q_qkv, s_qkv), (q_out, s_out) = quantize_weight(w_qkv), quantize_weight(w_out)
    x_wide = randn(vrows, 3 * vdim)
    w_wide, b_wide = randn(vdim, 3 * vdim, std=(3 * vdim) ** -0.5), randn(vdim, std=0.1)
    q_wide, s_wide = quantize_weight(w_wide)
    size = x.element_size()
    cases = [
        ("int8_linear", lambda: int8_linear(x, q_qkv, s_qkv, gamma=gamma, beta=beta),
         lambda r: r,
         (_nbytes(x, q_qkv, s_qkv, gamma, beta) + rows * 3 * dim * size, 2 * rows * dim * 3 * dim),
         None, lambda: F.linear(ln(x, gamma, beta), w_qkv),
         int_mm((codes(_ln_f32(x.float(), gamma, beta, 1e-5)), q_qkv))),
        ("int8_linear_out", lambda: int8_linear(x, q_out, s_out, bias=b_out), lambda r: r,
         (2 * _nbytes(x) + _nbytes(q_out, s_out, b_out), 2 * rows * dim * dim),
         None, lambda: F.linear(x, w_out, b_out), int_mm((codes(x.float()), q_out))),
        ("int8_linear_out2304", lambda: int8_linear(x_wide, q_wide, s_wide, bias=b_wide),
         lambda r: r,
         (_nbytes(x_wide, q_wide, s_wide, b_wide) + vrows * vdim * size,
          2 * vrows * 3 * vdim * vdim),
         None, lambda: F.linear(x_wide, w_wide, b_wide), int_mm((codes(x_wide.float()), q_wide))),
    ]
    for name, xs, d, h, residual in (("int8_mlp", x, dim, mlp, False),
                                     ("int8_mlp_last", x[:last], dim, mlp, False),
                                     ("int8_mlp_vitb16", randn(vrows, vdim), vdim, vmlp, True)):
        run, work, chain, lib = mlp_case(xs.contiguous(), d, h, residual)
        cases.append((name, run, lambda r: r, work, None, chain, lib))
    return cases


def _general_kernel_cases(dtype, gen, batch):
    """Cases (as in :func:`_kernel_cases`) for the general instances of A, B
    and B10 at head dims 320 and 512 (``batch`` x 4 heads, 1001 rows
    padded to 1008; A with dropout 0.1 and lse, B replaying the mask; B10
    on the head views of the packed qkv sliced to the real rows) and of B8
    at 96 (8 heads) and 320 (4 heads), B8."""
    import torch
    import torch.nn.functional as F

    from gaviko_tpu_torch.ops.cls_attention import cls_attention
    from gaviko_tpu_torch.ops.flash_attention import (
        _split_heads, flash_attention, fused_mhsa, fused_mhsa_bwd, mhsa_reference)

    dev, H, n_pad, n_true = "cuda", 4, 1008, 1001

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    key_mask = (torch.arange(n_pad, device=dev) < n_true).view(1, 1, 1, n_pad)
    cases = []
    for D in GENERAL_DIM_HEADS:
        inner, scale = H * D, D ** -0.5
        qkv = randn(batch, n_pad, 3 * inner)
        dout = randn(batch, n_pad, inner)
        dout[:, n_true:] = 0
        with torch.no_grad():
            out, lse = mhsa_reference(qkv, H, D, scale, n_true, VIT_RATE, with_lse=True,
                                      seed=VIT_SEED)
        heads4 = qkv.view(batch, n_pad, 3, H, D).permute(2, 0, 3, 1, 4)
        dout4 = dout.view(batch, n_pad, H, D).transpose(1, 2)
        q, k, v = (t[:, :, :n_true] for t in _split_heads(qkv, H, D))
        products = batch * H * n_pad * n_true * D
        size = qkv.element_size()
        cases += [
            (f"fused_mhsa_dh{D}", lambda qkv=qkv, D=D: fused_mhsa(
                qkv, H, D, D ** -0.5, n_true, VIT_RATE, with_lse=True, seed=VIT_SEED),
             lambda r: (r[0][:, :n_true], r[1]),
             (_nbytes(qkv) * 4 // 3 + _nbytes(lse), 4 * products),
             lambda heads4=heads4: F.scaled_dot_product_attention(
                 *heads4, attn_mask=key_mask, dropout_p=VIT_RATE), None),
            (f"fused_mhsa_bwd_dh{D}", lambda qkv=qkv, out=out, lse=lse, dout=dout, D=D:
             fused_mhsa_bwd(qkv, out, lse, dout, H, D, D ** -0.5, n_true, VIT_RATE, VIT_SEED),
             lambda r: r, (_nbytes(qkv, out, dout, lse, qkv), 10 * products),
             _sdpa_grad(*heads4, dout4, attn_mask=key_mask, dropout_p=VIT_RATE), None),
            (f"flash_attention_dh{D}", lambda q=q, k=k, v=v, D=D: flash_attention(
                q, k, v, D ** -0.5), lambda r: r,
             (4 * batch * H * n_true * D * size, 4 * batch * H * n_true * n_true * D),
             lambda q=q, k=k, v=v, D=D: F.scaled_dot_product_attention(
                 q, k, v, scale=D ** -0.5), None),
        ]
    for D, heads in GENERAL_CLS:
        inner, b8 = heads * D, 8
        kv, q0 = randn(b8, n_pad, 2 * inner), randn(b8, inner)
        k4, v4 = kv.view(b8, n_pad, 2, heads, D).permute(2, 0, 3, 1, 4)
        cases.append((
            f"cls_attention_dh{D}", lambda kv=kv, q0=q0, D=D, heads=heads: cls_attention(
                kv, q0, heads, D, D ** -0.5, n_true), lambda r: r,
            (b8 * n_true * 2 * inner * kv.element_size() + 2 * _nbytes(q0),
             4 * b8 * n_true * inner),
            lambda q0=q0, k4=k4, v4=v4, D=D, heads=heads: F.scaled_dot_product_attention(
                q0.view(b8, heads, 1, D), k4, v4, attn_mask=key_mask), None))
    return cases


def _compare(got, want) -> tuple:
    """(relative MAE, max abs error) of a result or the worst of a tuple."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    rel, max_abs = 0.0, 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise RuntimeError("non-finite kernel output")
        rel = max(rel, _rel_mae(g, w))
        max_abs = max(max_abs, float((g.double() - w.double()).abs().max()))
    return rel, max_abs


def phase_kernels(card: str, batch: int, path: str) -> dict:
    """Every case of ``path`` ("serving" and "train": GAViKO vit-l16; "vit"
    and "vit_train": vit-b16 serving and training; "t16": B10 at vit-t16
    serving and streaming; "dh128", "dh192", "dh256": A, B and B8 at vit-b16
    with dim_head 128, 192 or 256; "int8": B11; "general": the general
    head-dim instances; "ln_bwd": B12 at LN_BWD_SHAPES, batch None; "c11":
    B9 and B12 at C11_SHAPES, batch None;
    "local": C and D at a latent of 64 and at the 10x14x14 grid) in
    bf16 and fp32 (TF32 off): kernel vs plain version on the same inputs,
    then the times.
    Returns the lines by (name, dtype)."""
    import torch

    from gaviko_tpu_torch.ops._build import plain_versions

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    # dh192/dh256's f32 kernel B runs for ~0.1 s; the general instances are
    # slow by design.
    reps = 5 if path in ("dh192", "dh256", "wide") else 3 if path == "general" else 20
    results = {}
    for dtype, budget in ((torch.bfloat16, BF16_BUDGET), (torch.float32, F32_BUDGET)):
        if path == "vit":
            cases = _vit_kernel_cases(dtype, gen, batch)
        elif path == "vit_train":
            cases = _vit_train_kernel_cases(dtype, gen, batch)
        elif path == "t16":
            cases = _t16_kernel_cases(dtype, gen, batch)
        elif path.startswith("dh"):
            cases = _dh_kernel_cases(dtype, gen, batch, int(path[2:]))
        elif path == "int8":
            cases = _int8_kernel_cases(dtype, gen, batch)
        elif path == "general":
            cases = _general_kernel_cases(dtype, gen, batch)
        elif path == "wide":
            cases = _wide_kernel_cases(dtype, gen, batch)
        elif path == "ln_bwd":
            cases = _ln_bwd_kernel_cases(dtype, gen)
        elif path == "c11":
            cases = _c11_kernel_cases(dtype, gen)
        elif path == "local":
            cases = _local_kernel_cases(dtype, gen, batch)
        else:
            cases = _kernel_cases(dtype, gen, batch, path == "train")
        for name, run, cut, work, library, chain, *int_mm in cases:
            with torch.no_grad():
                got = cut(run())
                with plain_versions():
                    want = cut(run())
                torch.cuda.synchronize()
                rel, max_abs = _compare(got, want)
                rerun_equal = None
                if _rerun_bit_equal(name):
                    again = cut(run())
                    pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
                    rerun_equal = all(torch.equal(a, b) for a, b in pairs)
                rate = (torch.int8 if path == "int8" else "3xtf32" if dtype == torch.float32
                        and _tensor_core_f32(name) else dtype)
                bound_ms, bound_by = _bound(work, rate)
                line = {"phase": "kernel", "path": path,
                        "name": name, "dtype": str(dtype), "batch": batch,
                        "rel_mae": rel, "max_abs_err": max_abs, "budget": budget,
                        "ms": _median_ms(run, reps=reps, calls=KERNEL_CALLS),
                        "bound_ms": bound_ms,
                        "bound_by": bound_by, "bytes": work[0], "operations": work[1],
                        "library_ms": None if library is None else _median_ms(
                            library, reps=reps, calls=KERNEL_CALLS),
                        "cudnn_tf32": torch.backends.cudnn.allow_tf32, "card": card}
                if chain is not None:
                    line["chain_ms"] = _median_ms(chain, reps=reps, calls=KERNEL_CALLS)
                if name.startswith(("cls_attention", "local_attention")):  # the host may set ms
                    line["graph_ms"] = _graph_ms(run)
                    # autograd's backward (D's library call) runs on its
                    # engine's thread, outside the capture
                    line["library_graph_ms"] = None if "bwd" in name else _graph_ms(library)
                if path == "int8":
                    line["max_ulp"] = _ulps(got, want)
                    line["int_mm_ms"] = _median_ms(int_mm[0], reps=reps, calls=KERNEL_CALLS)
                if rerun_equal is not None:
                    line["rerun_bit_equal"] = rerun_equal
                with plain_versions():
                    line["plain_ms"] = _median_ms(run, reps=5, warmup=1,
                                                  calls=KERNEL_CALLS)
            results[(name, str(dtype))] = line
            print(json.dumps(line), flush=True)
            if not rel <= budget:
                raise RuntimeError(f"{name} {dtype}: rel MAE {rel} > {budget}")
            if rerun_equal is False:
                raise RuntimeError(f"{name} {dtype}: a rerun is not bit-equal to the first run")
            if name in BIT_EQUAL and max_abs != 0.0:
                raise RuntimeError(f"{name} {dtype}: not bit-equal to its plain version "
                                   f"(max abs err {max_abs})")
        del cases
        torch.cuda.empty_cache()
    return results


def _wrappers():
    """Every kernel wrapper, whose ``launches`` counters a phase reads."""
    from gaviko_tpu_torch.ops.cls_attention import cls_attention
    from gaviko_tpu_torch.ops.flash_attention import (
        flash_attention, flash_local_attention, fused_mhsa, fused_mhsa_bwd,
        local_attention_bwd)
    from gaviko_tpu_torch.ops.fused_adam import fused_adam
    from gaviko_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_bwd
    from gaviko_tpu_torch.ops.int8_linear import int8_linear, int8_mlp
    from gaviko_tpu_torch.ops.ln_linear import fused_ln_linear, ln_linear_bwd
    from gaviko_tpu_torch.ops.patchify import patchify_fused

    return {"patchify": patchify_fused, "fused_mhsa": fused_mhsa,
            "local_attention": flash_local_attention, "fused_mhsa_bwd": fused_mhsa_bwd,
            "local_attention_bwd": local_attention_bwd, "ln_linear": fused_ln_linear,
            "ln_linear_bwd": ln_linear_bwd,
            "fused_mlp": fused_mlp, "fused_mlp_bwd": fused_mlp_bwd,
            "cls_attention": cls_attention, "flash_attention": flash_attention,
            "fused_adam": fused_adam, "int8_linear": int8_linear, "int8_mlp": int8_mlp}


def _vit_routes(spec, dtype) -> dict:
    """Which kernel each of the plain ViT's sites takes, by the port's
    gates (the JAX package's): the stream is padded to a multiple of 8;
    "hybrid" is the train route's qkv under GAVIKO_LNQKV_HYBRID (as set
    now)."""
    from gaviko_tpu_torch.core.vit import lnqkv_hybrid_enabled
    from gaviko_tpu_torch.ops.cls_attention import cls_attention_supported
    from gaviko_tpu_torch.ops.flash_attention import fused_mhsa_supported
    from gaviko_tpu_torch.ops.fused_mlp import fused_mlp_supported
    from gaviko_tpu_torch.ops.ln_linear import ln_linear_hybrid_supported, ln_linear_supported

    n_pad = -(-(spec.num_patches + 1) // 8) * 8
    inner = spec.heads * spec.dim_head
    return {"fused_mhsa": fused_mhsa_supported(spec.heads, spec.dim_head, n_pad),
            "qkv": ln_linear_supported(spec.dim, 3 * inner, dtype),
            "kv": ln_linear_supported(spec.dim, 2 * inner, dtype),
            "mlp": fused_mlp_supported(spec.dim, spec.mlp_dim, dtype),
            "cls": cls_attention_supported(spec.heads, spec.dim_head, n_pad, dtype),
            "hybrid": (lnqkv_hybrid_enabled()
                       and ln_linear_hybrid_supported(spec.dim, 3 * inner, dtype))}


def serving_launches(spec, quantized: bool = False) -> dict:
    """Launches of each kernel in one bf16 serving forward: GAViKO runs
    patchify, then the MHSA (B10 where the fused gate is false, as at
    vit-t16's 3 heads) and local attention in every layer, and the fused
    LN+qkv and the fused MLP in every layer where their gates hold (at
    vit-s16 widths; not at vit-l16's); the plain
    ViT runs patchify and, in all but the last layer, the fused LN+qkv
    where its gate holds and the fused MHSA (or, where the MHSA gate is
    false, as for vit-t16's 3 heads, the flash attention kernel B10) and
    the fused MLP where its gate holds; in the CLS-fast last layer LN+kv and
    the CLS attention where their gates hold. ``quantized`` (int8
    sidecars): every layer's qkv (with its LN) and out-projection run
    int8_linear and its MLP int8_mlp, and the plain ViT's last layer is a
    full one (the CLS-fast path defers to the int8 kernels)."""
    import torch

    want = dict.fromkeys(_wrappers(), 0)
    want["patchify"] = 1
    if quantized:
        want.update(int8_linear=2 * spec.depth, int8_mlp=spec.depth)
    r = _vit_routes(spec, torch.bfloat16)
    if spec.method == "gaviko":
        from gaviko_tpu_torch.ops.flash_attention import fused_mhsa_supported

        fused = fused_mhsa_supported(spec.heads, spec.dim_head,
                                     _pad8(spec.num_prompts + 1 + spec.num_patches))
        want.update(fused_mhsa=spec.depth * fused, flash_attention=spec.depth * (not fused),
                    local_attention=spec.depth)
        if not quantized:
            want.update(ln_linear=spec.depth * r["qkv"], fused_mlp=spec.depth * r["mlp"])
        return want
    if quantized:
        want.update(fused_mhsa=spec.depth * r["fused_mhsa"],
                    flash_attention=spec.depth * (not r["fused_mhsa"]))
        return want
    full = spec.depth - 1
    want.update(ln_linear=full * r["qkv"] + r["kv"],
                fused_mhsa=full * r["fused_mhsa"], flash_attention=full * (not r["fused_mhsa"]),
                fused_mlp=full * r["mlp"], cls_attention=int(r["cls"]))
    return want


def _npz(vol: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, data=vol)
    return buf.getvalue()


def _config(config_path: str, method: str, model_over=None) -> dict:
    """The shipped config with the method override and, given
    ``model_over``, those ``model`` entries replaced (in memory)."""
    from gaviko_tpu_torch.config import apply_method_override, load_config

    config = apply_method_override(load_config(config_path), method)
    if model_over:
        config["model"].update(model_over)
    return config


def make_predictor(config_path: str, method: str, model_over=None, quantize=None):
    from gaviko_tpu_torch.serving import Predictor

    config = _config(config_path, method, model_over)
    t0 = time.perf_counter()
    predictor = Predictor(config, batch_size=B, dtype="bfloat16",
                          pretrained_dir=None, quantize=quantize, device="cuda:0")
    spec = predictor.spec
    print(json.dumps({"phase": "predictor", "seconds": time.perf_counter() - t0,
                      "method": method, "backbone": spec.backbone, "depth": spec.depth,
                      "dim": spec.dim, "heads": spec.heads, "dim_head": spec.dim_head,
                      "volume": [spec.frames, *spec.image_size],
                      "gelu": spec.gelu, "pool": spec.pool, "batch_size": B,
                      "dtype": "bfloat16", "quantize": quantize}), flush=True)
    return predictor


def phase_serving(predictor, vols, spec=None, quantized=None) -> tuple:
    """POST every volume, B at a time; returns (launches, served logits).
    Each batch the dispatcher runs is one forward, so every kernel must
    launch ``serving_launches`` times the number of batches. ``spec`` and
    ``quantized`` are the predictor's own unless given (a
    ``DeployedPredictor`` has neither)."""
    from gaviko_tpu_torch.serving import serve

    spec = predictor.spec if spec is None else spec
    if quantized is None:
        quantized = predictor._quantize == "int8"

    bodies = [_npz(v) for v in vols]
    server = serve(predictor, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(body):
        req = urllib.request.Request(f"{url}/predict", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            if r.status != 200:
                raise RuntimeError(f"/predict answered {r.status}")
            return json.load(r)

    try:
        wrappers = _wrappers()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=B) as ex:
            answers = list(ex.map(post, bodies))
        seconds = time.perf_counter() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.load(r)
        with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
            metrics = json.load(r)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    logits = np.asarray([a["logits"] for a in answers], np.float64)
    classes = np.asarray([a["class"] for a in answers])
    want = {n: c * metrics["batches_total"] for n, c in serving_launches(
        spec, quantized).items()}
    print(json.dumps({"phase": "serving", "method": spec.method,
                      "predictor": type(predictor).__name__, "quantize": quantized,
                      "requests": len(answers), "seconds": seconds, "launches": launches,
                      "want_launches": want, "metrics": metrics}), flush=True)
    if logits.shape != (len(vols), spec.num_classes):
        raise RuntimeError(f"served logits have shape {logits.shape}")
    if not np.isfinite(logits).all():
        raise RuntimeError("served logits are not finite")
    if not ((classes >= 0) & (classes < 5)).all() or \
            not (classes == logits.argmax(-1)).all():
        raise RuntimeError(f"served classes are wrong: {classes}")
    if health.get("status") != "ok":
        raise RuntimeError(f"/healthz answered {health}")
    if metrics["requests_total"] != len(vols) or \
            metrics["batches_total"] >= len(vols):
        raise RuntimeError(f"requests were not coalesced: {metrics}")
    if launches != want:
        raise RuntimeError(f"serving launched {launches}, want {want}")
    return launches, logits


def phase_plain_check(predictor, vols, served, card: str, headline_batch=None,
                      budget=SERVE_BUDGET, fp_served=None) -> None:
    """Served logits of one batch against the plain versions on the card
    (relative MAE <= ``budget``), the end-to-end rate of predict_logits at
    B8 bf16, one forward under the profiler (device busy ms, wall ms and
    idle share) and, given ``headline_batch``, one forward at that batch in
    CUDA-event ms. An int8 predictor's profiled forward must show the B11
    kernels by name, 2 int8_linear and 1 int8_mlp a layer, and given
    ``fp_served`` (the bf16 fp predictor's logits of the same volumes) its
    logits are held to them (relative MAE <= INT8_FP_BUDGET, argmax
    agreement reported)."""
    from gaviko_tpu_torch.ops._build import plain_versions
    from gaviko_tpu_torch.utils.layouts import put_volume

    with plain_versions():
        plain = predictor.predict_logits(vols).astype(np.float64)
    rel = float(np.abs(served - plain).mean() / max(np.abs(plain).mean(), 1e-30))
    agree = float((served.argmax(-1) == plain.argmax(-1)).mean())

    def rate(reps):
        predictor.predict_logits(vols)
        t0 = time.perf_counter()
        for _ in range(reps):
            predictor.predict_logits(vols)
        return reps * len(vols) / (time.perf_counter() - t0)

    import torch

    kernel_rate = rate(5)
    with plain_versions():
        plain_rate = rate(2)
    batch = put_volume(np.stack([v[None] for v in vols]), torch.bfloat16, predictor.device)
    kernel_fwd = _median_ms(lambda: predictor._forward(predictor.params, batch), reps=5)
    with plain_versions():
        plain_fwd = _median_ms(
            lambda: predictor._forward(predictor.params, batch), reps=3, warmup=1)
    quantized = predictor._quantize == "int8"

    def forward():
        return predictor._forward(predictor.params, batch)

    profile = (_profile_int8_forward(forward, predictor.spec.depth) if quantized
               else profile_step(forward))
    line = {"phase": "plain_check", "method": predictor.spec.method, "rel_mae": rel,
            "quantize": predictor._quantize,
            "budget": budget, "argmax_agreement": agree, "vol_per_s": kernel_rate,
            "plain_vol_per_s": plain_rate, "forward_ms": kernel_fwd,
            "plain_forward_ms": plain_fwd, "batch_size": len(vols), "profile": profile,
            "card": card}
    if headline_batch is not None:
        big = put_volume(np.zeros((headline_batch, *batch.shape[1:]), np.float32),
                         torch.bfloat16, predictor.device)
        line[f"forward_ms_b{headline_batch}"] = _median_ms(
            lambda: predictor._forward(predictor.params, big), reps=5)
        del big
    if fp_served is not None:
        line["rel_mae_vs_fp"] = float(np.abs(served - fp_served).mean()
                                      / max(np.abs(fp_served).mean(), 1e-30))
        line["argmax_agreement_vs_fp"] = float((served.argmax(-1) == fp_served.argmax(-1)).mean())
        line["fp_budget"] = INT8_FP_BUDGET
    print(json.dumps(line), flush=True)
    if not rel <= budget:
        raise RuntimeError(f"served logits vs plain: rel MAE {rel} > {budget}")
    if fp_served is not None and not line["rel_mae_vs_fp"] <= INT8_FP_BUDGET:
        raise RuntimeError(f"int8 logits vs bf16 fp: rel MAE {line['rel_mae_vs_fp']} > "
                           f"{INT8_FP_BUDGET}")


# Deployment (phase 22): an artifact's served logits against its live
# Predictor's on the same volumes, by the serving budgets (bf16 2e-2, int8
# 1e-2); its first forward's are the live Predictor's bit for bit.
DEPLOY_BUDGET = {None: SERVE_BUDGET, "int8": INT8_PLAIN_BUDGET}
DEPLOY_RELOAD_KEY = "transformer.layers.0.0.to_qkv.weight"  # the int8 reload's overlaid weight
OPCHECK_OPS = ("patchify", "fused_mhsa", "flash_attention", "local_attention", "fused_mlp",
               "cls_attention", "ln_linear", "int8_linear", "int8_mlp")  # every gaviko:: op
HOST_CALLS, HOST_REPEATS = 50, 7


def _host_us(fn) -> float:
    """Median host µs a call over HOST_CALLS back-to-back calls with no
    synchronisation between them (``scripts/attention_host_us.py``'s
    method): what a host-bound forward pays a launch."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(HOST_REPEATS):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        times.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def _deploy_host_us(spec) -> dict:
    """Host µs a call of A and C at the GAViKO B8 bf16 serving shapes,
    eagerly (the wrapper) and as the exported program calls them (its
    ``gaviko::`` op, which runs the same launch)."""
    import torch

    from gaviko_tpu_torch.ops import _build
    from gaviko_tpu_torch.ops.flash_attention import flash_local_attention, fused_mhsa

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_true = spec.num_prompts + 1 + spec.num_patches
    inner, dl = spec.heads * spec.dim_head, spec.local_dim
    qkv = torch.randn(B, _pad8(n_true), 3 * inner, generator=gen, device="cuda").bfloat16()
    local = torch.randn(B, spec.num_patches, 3 * dl, generator=gen, device="cuda").bfloat16()
    q, k, v = local.chunk(3, dim=-1)
    a = (qkv, spec.heads, spec.dim_head, spec.dim_head ** -0.5, n_true)
    c = (q, k, v, spec.dim ** -0.5)
    dhw, win = tuple(spec.DHW), tuple(spec.local_k)
    with torch.inference_mode():
        return {"fused_mhsa": {"eager": _host_us(lambda: fused_mhsa(*a)),
                               "artifact": _host_us(lambda: _build.op("fused_mhsa")(*a))},
                "local_attention": {
                    "eager": _host_us(lambda: flash_local_attention(*c, dhw, win)),
                    "artifact": _host_us(lambda: _build.op("local_attention")(
                        *c, list(dhw), list(win)))}}


def _record_op_args(store: dict):
    """A dispatch mode that records, into ``store``, the arguments of the
    first call of each ``gaviko::`` op run inside it (an exported program's
    forward), for ``phase_opcheck``; every call runs as it would without it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func.namespace == "gaviko":
                store.setdefault(_op_name(func), (func, args, kwargs))
            return func(*args, **kwargs)

    return Record()


def _op_name(op) -> str:
    """``gaviko::fused_mhsa.default`` -> ``fused_mhsa``."""
    return op.name().split("::")[1].split(".")[0]


def phase_deploy(name: str, config: dict, predictor, vols, live_served, card: str,
                 op_args: dict) -> dict:
    """A deployment artifact of the live ``predictor``'s model (``deploy``):
    exported for ``cuda`` (B8 bf16, int8 as the predictor is), its manifest
    calling each ``gaviko::`` op ``serving_launches`` times; loaded in a
    ``DeployedPredictor``; its first forward's logits the live predictor's
    on the same 8 volumes bit for bit (the same kernels on the same
    arguments), then 16 volumes served 8 at a time through ``serve()`` with
    exact launches a batch, against the live predictor's served logits
    (relative MAE by DEPLOY_BUDGET, bit-equality reported). Prints export s, artifact MB, load s, first-forward ms,
    ``predict_logits`` vol/s beside the live predictor's (turns: live,
    artifact, artifact, live), a B8 forward's CUDA-event ms eager, from the
    predictor's program and from the program as exported (its per-call
    input checks and asserts kept), and (GAViKO) the host µs a call of A
    and C eager and through their ops. An int8 artifact
    then reloads a checkpoint of one quantized weight: its sidecars must be
    ``quantize_weight``'s of the new weight, its logits move, and a forward
    still launches exactly. Returns the launches of the first forward (one
    batch), read from the wrappers' counters, and its logits (what the mesh
    artifacts of phase 20 are held to), and records each ``gaviko::`` op's
    arguments in one more forward into ``op_args``."""
    import torch

    from gaviko_tpu_torch.deploy import DeployedPredictor, export_artifact
    from gaviko_tpu_torch.ops.int8_linear import INT8_SUFFIX, SCALE_SUFFIX, quantize_weight
    from gaviko_tpu_torch.utils.layouts import put_volume

    t_start = time.perf_counter()
    spec, quantize = predictor.spec, predictor._quantize
    budget = DEPLOY_BUDGET[quantize]
    per_batch = serving_launches(spec, quantize == "int8")
    line = {"phase": "deploy", "model": name, "method": spec.method,
            "backbone": spec.backbone, "quantize": quantize, "budget": budget, "card": card}
    with tempfile.TemporaryDirectory(prefix="gaviko_deploy_") as root:
        path = os.path.join(root, f"{name}.gaviko")
        t0 = time.perf_counter()
        platform = predictor.device.type  # cuda here; the CPU rehearses the phase
        meta = export_artifact(config, path, batch_size=B, dtype="bfloat16",
                               pretrained_dir=None, quantize=quantize, platforms=(platform,))
        line["export_s"] = time.perf_counter() - t0
        line["artifact_mb"] = os.path.getsize(path) / 1e6
        line["ops"] = meta["ops"][platform]
        t0 = time.perf_counter()
        dep = DeployedPredictor(path, device=predictor.device)
        torch.cuda.synchronize()
        line["load_s"] = time.perf_counter() - t0
        wrappers = _wrappers()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        first = dep.predict_logits(vols[:B])
        line["first_forward_ms"] = (time.perf_counter() - t0) * 1e3
        first_launches = {n: w.launches for n, w in wrappers.items()}
        line["first_launches_exact"] = first_launches == per_batch
        live = predictor.predict_logits(vols[:B])
        line["rel_mae"] = _rel_mae_np(first, live)
        line["bit_equal"] = bool(np.array_equal(first, live))
        print(json.dumps({"phase": "deploy_loaded", **line}), flush=True)

        launches, served = phase_serving(dep, vols, spec=spec, quantized=quantize == "int8")
        line["served_rel_mae"] = _rel_mae_np(served, live_served)
        line["served_bit_equal"] = bool(np.array_equal(served, live_served))

        def rate(p, reps=3):
            p.predict_logits(vols[:B])
            t0 = time.perf_counter()
            for _ in range(reps):
                p.predict_logits(vols[:B])
            return reps * B / (time.perf_counter() - t0)

        turns = [rate(predictor), rate(dep), rate(dep), rate(predictor)]
        line["live_vol_per_s"], line["vol_per_s"] = turns[::3], turns[1:3]
        batch = put_volume(np.stack([v[None] for v in vols[:B]]), torch.bfloat16,
                           predictor.device)
        with torch.no_grad(), _record_op_args(op_args):  # not inference tensors
            dep._program(dep._device_params, batch)
        with zipfile.ZipFile(path) as z:  # the program as exported, its checks kept
            checked = torch.export.load(io.BytesIO(z.read(f"program.{platform}.pt2"))).module()
        with torch.inference_mode():
            line["live_forward_ms"] = _median_ms(
                lambda: predictor.model.apply(predictor.params, batch, spec), reps=5)
            line["forward_ms"] = _median_ms(lambda: dep._program(dep._device_params, batch),
                                            reps=5)
            line["forward_ms_checked"] = _median_ms(lambda: checked(dep._device_params, batch),
                                                    reps=5)
        del checked
        if spec.method == "gaviko":
            line["host_us"] = _deploy_host_us(spec)

        if quantize == "int8":
            key = DEPLOY_RELOAD_KEY
            new_w = (dep.params[key].float() * 2.0 + 0.01).to(dep.params[key].dtype)
            ckpt = os.path.join(root, "reload.pt")
            torch.save({key: new_w}, ckpt)
            dep.reload_checkpoint(ckpt)
            w_i8, scale = quantize_weight(new_w)
            requantized = all(torch.equal(t.cpu(), want) for t, want in (
                (dep.params[key + INT8_SUFFIX], w_i8), (dep.params[key + SCALE_SUFFIX], scale),
                (dep._device_params[key + INT8_SUFFIX], w_i8)))
            for w in wrappers.values():
                w.launches = 0
            reloaded = dep.predict_logits(vols[:B])
            reload_launches = {n: w.launches for n, w in wrappers.items()}
            line["reload"] = {"key": key, "requantized": requantized,
                              "rel_change": _rel_mae_np(reloaded, first),
                              "launches_exact": reload_launches == per_batch}
            if not (requantized and line["reload"]["rel_change"] > 0
                    and reload_launches == per_batch):
                raise RuntimeError(f"deploy {name}: reload failed: {line['reload']}, "
                                   f"launches {reload_launches}")
        del dep
        torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t_start
    print(json.dumps(line), flush=True)
    want_ops = {f"gaviko::{n}": c for n, c in per_batch.items() if c}
    if line["ops"] != want_ops:
        raise RuntimeError(f"deploy {name}: the program calls {line['ops']}, want {want_ops}")
    if first_launches != per_batch:
        raise RuntimeError(f"deploy {name}: a batch launched {first_launches}, "
                           f"want {per_batch}")
    if not line["bit_equal"]:
        raise RuntimeError(f"deploy {name}: the artifact's logits differ from the live "
                           f"predictor's (rel MAE {line['rel_mae']})")
    if not line["served_rel_mae"] <= budget:
        raise RuntimeError(f"deploy {name}: served_rel_mae {line['served_rel_mae']} > {budget}")
    return first_launches, first


def phase_deploy_cli(predictor, vols, card: str, op_args: dict) -> None:
    """``python -m gaviko_tpu_torch.cli.export`` then ``cli.infer
    --artifact`` (both in this process) on vit.yaml ``fft`` at B8 bf16 and a
    folder of 8 volumes: the CSV's classes are those of a
    ``DeployedPredictor`` of the exported file, whose logits are within
    SERVE_BUDGET of the live ``predictor``'s on the same volumes. Records
    each ``gaviko::`` op's arguments in one more forward into ``op_args``."""
    import yaml

    import torch

    from gaviko_tpu_torch.cli import export as export_cli
    from gaviko_tpu_torch.cli import infer as infer_cli
    from gaviko_tpu_torch.config import load_config
    from gaviko_tpu_torch.deploy import DeployedPredictor
    from gaviko_tpu_torch.utils.layouts import put_volume

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gaviko_deploy_cli_") as root:
        folder = os.path.join(root, "volumes")
        os.makedirs(folder)
        names = [f"vol_{i:02d}.npz" for i in range(B)]
        for n, v in zip(names, vols[:B]):
            np.savez(os.path.join(folder, n), data=v)
        config = load_config(VIT_CONFIG)
        config["utils"].update(log_dir=os.path.join(root, "log"))
        config_path = os.path.join(root, "vit.yaml")
        with open(config_path, "w") as f:
            yaml.safe_dump(config, f)
        path = os.path.join(root, "vit.gaviko")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            export_cli.main(["--config", config_path, "--method", "fft", "--output", path,
                             "--platforms", predictor.device.type])
        csv_path = infer_cli.main(["--artifact", path, "--image_folder", folder,
                                   "--results_dir", os.path.join(root, "outputs"),
                                   "--device", str(predictor.device)])
        with open(csv_path) as f:
            rows = dict(line.split(",") for line in f.read().splitlines()[1:])
        dep = DeployedPredictor(path, device=predictor.device)
        logits = dep.predict_logits(vols[:B])
        batch = put_volume(np.stack([v[None] for v in vols[:B]]), torch.bfloat16,
                           predictor.device)
        with torch.no_grad(), _record_op_args(op_args):  # not inference tensors
            dep._program(dep._device_params, batch)
        del batch
        classes = {n: str(int(c)) for n, c in zip(names, logits.argmax(-1))}
        rel = _rel_mae_np(logits, predictor.predict_logits(vols[:B]))
        del dep
    line = {"phase": "deploy_cli", "export_line": out.getvalue().strip(), "rows": len(rows),
            "classes_match": rows == classes, "rel_mae": rel, "budget": SERVE_BUDGET,
            "seconds": time.perf_counter() - t_start, "card": card}
    print(json.dumps(line), flush=True)
    if rows != classes or not rel <= SERVE_BUDGET or "wrote " not in line["export_line"]:
        raise RuntimeError(f"deploy_cli failed: {line}")


def _opcheck(cases: dict) -> tuple:
    """``torch.library.opcheck`` (schema, autograd registration, the fake
    against the kernel's output: shape, dtype, strides and aliasing, and a
    dynamic-shape trace) of each case, name -> (op, args, kwargs), on the
    card -> ({name: the shapes, each test's result, "SUCCESS" or the error,
    and the seconds}, {name: its tests that failed})."""
    import torch

    results = {}
    for name, (op, args, kwargs) in sorted(cases.items()):
        args = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        t0 = time.perf_counter()
        result = torch.library.opcheck(op, args, kwargs, raise_exception=False)
        results[name] = {"shapes": [list(a.shape) for a in args if isinstance(a, torch.Tensor)],
                         **{k: str(v) for k, v in result.items()},
                         "s": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    failed = {k: {t: r for t, r in v.items() if t.startswith("test_") and r != "SUCCESS"}
              for k, v in results.items()}
    return results, {k: v for k, v in failed.items() if v}


def phase_opcheck(op_args: dict, card: str) -> None:
    """``_opcheck`` on every ``gaviko::`` op: each with the arguments an
    artifact of phase 22 gave it (``op_args``; B10 at the vit-t16 B8 bf16
    serving shapes, head views of a packed qkv), and ``flash_attention``
    (B10) at those shapes with a head dim of 36, whose fake is a slice of a
    padded buffer."""
    import torch

    from gaviko_tpu_torch.models.factory import build_model

    t_start = time.perf_counter()
    spec = build_model(_config(VIT_CONFIG, "fft", T16)["model"]).spec
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, d = spec.num_patches + 1, spec.heads, 36
    qkv = torch.randn(B, n, 3 * h * d, generator=gen, device="cuda").bfloat16()
    q, k, v = qkv.view(B, n, 3, h, d).permute(2, 0, 3, 1, 4)
    cases = {**op_args, f"flash_attention_d{d}": (torch.ops.gaviko.flash_attention.default,
                                                  (q, k, v, d ** -0.5), {})}
    results, failed = _opcheck(cases)
    print(json.dumps({"phase": "opcheck", "ops": results, "failed": failed,
                      "seconds": time.perf_counter() - t_start, "card": card}), flush=True)
    missing = set(OPCHECK_OPS) - {_op_name(op) for op, _, _ in cases.values()}
    if failed or missing:
        raise RuntimeError(f"opcheck failed: {failed}, ops not checked: {sorted(missing)}")


def train_setup(model_over=None):
    """The vit-l16 GAViKO model of the shipped config (or as ``model_over``
    changes it; random init from seed 0, on the card), TRAIN_STEPS
    synthetic batches and each step's dropout seeds: two a layer, the local
    branch's, with the backbone frozen; with it trainable also the two
    embedding sites and, a layer, two in the attention (the MHSA kernel, the
    out-projection) and one in the MLP on the fused route or two on the
    plain one."""
    import torch

    from gaviko_tpu_torch.models.factory import build_model
    from gaviko_tpu_torch.ops.fused_mlp import fused_mlp_supported

    config = _config(CONFIG, "gaviko", model_over)
    model = build_model(config["model"])
    spec = model.spec
    params = {k: v.to("cuda") for k, v in
              model.init(torch.Generator().manual_seed(0), spec).items()}

    def n_seeds(precision):
        if spec.freeze_vit:
            return 2 * spec.depth
        mlp = 1 if fused_mlp_supported(spec.dim, spec.mlp_dim, _dtype(precision)) else 2
        return 2 + (4 + mlp) * spec.depth

    seeds = {p: _step_seeds(n_seeds(p)) for p in ("fp32", "bf16")}
    return config, model, params, _batches(TRAIN_B, 0), seeds, gaviko_train_launches


def _batches(batch: int, seed: int, steps: int = TRAIN_STEPS) -> list:
    """``steps`` synthetic (volumes, labels) batches on the card."""
    import torch

    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(rng.rand(batch, 1, 120, 160, 160).astype(np.float32))
             .to("cuda"), torch.from_numpy(rng.randint(0, 5, batch)).long().to("cuda"))
            for _ in range(steps)]


def _step_seeds(n_seeds: int, steps: int = TRAIN_STEPS) -> list:
    """Each step's dropout seeds."""
    import torch

    return [torch.randint(-2 ** 31, 2 ** 31, (n_seeds,),
                          generator=torch.Generator().manual_seed(i)).tolist()
            for i in range(steps)]


def gaviko_train_launches(spec, precision: str) -> dict:
    """A GAViKO step: patchify once, each of the four attention kernels in
    every layer, and one B13 update (after its norm kernel) over every
    trainable tensor. With the backbone frozen, the global layers run
    ``train=False`` under a gradient: B9 and B12 for the qkv where B9's gate
    holds (not at vit-l16); trainable, B12 for the qkv where the hybrid
    route is on (GAVIKO_LNQKV_HYBRID) and its gate holds. B6 and B7 where
    the fused MLP's gate holds (not at vit-l16); no CLS attention, B10 or
    B11 (training ignores int8 sidecars, and the step has none)."""
    d = spec.depth
    r = _vit_routes(spec, _dtype(precision))
    want = dict.fromkeys(_wrappers(), 0)
    want.update(patchify=1, fused_adam=1, fused_mhsa=d, local_attention=d, fused_mhsa_bwd=d,
                local_attention_bwd=d, fused_mlp=d * r["mlp"], fused_mlp_bwd=d * r["mlp"])
    if spec.freeze_vit:
        want.update(ln_linear=d * r["qkv"], ln_linear_bwd=d * r["qkv"])
    else:
        want.update(ln_linear_bwd=d * r["hybrid"])
    return want


def _dtype(precision: str):
    import torch

    return torch.bfloat16 if precision == "bf16" else torch.float32


def vit_train_launches(spec, precision: str) -> dict:
    """A plain-ViT fft step: patchify once; in every full layer A and B
    where the fused MHSA's gate holds, else the flash attention kernel B10
    where dropout is off (its backward is the plain version's VJP) and no
    kernel where it is on (plain attention with dropout); B6 and B7 there
    too where the fused MLP's gate holds (bf16 at vit-b16, never at
    vit-t16); the CLS-fast last layer runs plain PyTorch in training; one
    B13 update over every trainable tensor; with GAVIKO_LNQKV_HYBRID=1, B12
    in every full layer where the hybrid gate holds (its forward is LN and a
    GEMM: no kernel)."""
    full = spec.depth - 1
    r = _vit_routes(spec, _dtype(precision))
    want = dict.fromkeys(_wrappers(), 0)
    want.update(patchify=1, fused_adam=1, fused_mhsa=full * r["fused_mhsa"],
                fused_mhsa_bwd=full * r["fused_mhsa"], fused_mlp=full * r["mlp"],
                fused_mlp_bwd=full * r["mlp"], ln_linear_bwd=full * r["hybrid"],
                flash_attention=full * (not r["fused_mhsa"] and spec.dropout == 0.0))
    return want


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def zoo_launches(spec, dtype, train: bool, quantized: bool = False) -> dict:
    """Launches of each kernel in one forward of a PEFT method (``train``
    False: serving, no gradient) or in one train step (the forward under a
    gradient with the method's train flags, its backward, one B13 update),
    by the port's gates (the JAX package's), for the shipped
    ``freeze_vit: true`` (MeLO trains its whole backbone in train mode).
    ``quantized``: serving with int8 sidecars (``quantize_backbone``).

    A layer's attention takes B9 for its qkv where the layer runs
    ``train=False``, no override, weights of the stream's dtype and B9's
    gate hold, with B12 as its backward where a gradient reaches it and the
    hybrid gate holds; then A (B under a gradient) where the fused MHSA's
    gate holds at the stream's length, else B10 unless dropout is live. Its
    MLP takes B6 (B7 under a gradient) where the fused MLP's gate holds at
    the stream's dtype. The CLS-fast last layer takes B9 for its kv as
    above (not SSF's or MeLO's plain GEMMs) and B8 without a gradient where
    B8's gate holds at the stream's length. Streams: VPT 1 + P + N rows
    (deep: fresh prompts replace prompt_dim rows a layer), AdaptFormer, SSF
    and MeLO N + 1 padded to a multiple of 8, DVPT P + 1 + N, EVP N + 1; EVP
    in bf16 runs an f32 stream on bf16 weights (two patchify calls). A
    gradient reaches every layer but AdaptFormer's first (its adapter
    follows the layer's attention and MLP). With int8 sidecars every layer
    but the CLS-fast last one runs B11: ``int8_linear`` for its qkv (not
    MeLO's LoRA-merged one) and its out-projection, ``int8_mlp`` for its
    MLP; the CLS-fast last layer keeps its full-precision routes, as the
    JAX package's zoo models do. SSF is served in full precision
    (``quantize_backbone`` refuses it)."""
    import torch

    from gaviko_tpu_torch.core.vit import cls_fast_enabled
    from gaviko_tpu_torch.ops.cls_attention import cls_attention_supported
    from gaviko_tpu_torch.ops.flash_attention import fused_mhsa_supported
    from gaviko_tpu_torch.ops.fused_mlp import fused_mlp_supported
    from gaviko_tpu_torch.ops.ln_linear import ln_linear_hybrid_supported, ln_linear_supported

    m = spec.method
    if m != "melo" and not spec.freeze_vit:
        raise ValueError("zoo_launches counts the shipped freeze_vit: true")
    q8 = quantized and m != "ssf"
    train_mode = train and m == "melo"  # the layers' own train flag
    inner = spec.heads * spec.dim_head
    stream = torch.float32 if m == "evp" else dtype
    same = stream == dtype  # weights of the stream's dtype
    n0 = spec.num_patches + 1
    want = dict.fromkeys(_wrappers(), 0)
    want.update(patchify=2 if m == "evp" else 1, fused_adam=int(train))

    def b9(out: int, grad: bool) -> None:
        if not train_mode and same and ln_linear_supported(spec.dim, out, stream):
            want["ln_linear"] += 1
            want["ln_linear_bwd"] += grad and ln_linear_hybrid_supported(spec.dim, out, stream)

    def layer(n: int, grad: bool) -> None:
        if q8:
            want["int8_linear"] += 1 + (m != "melo")
        elif m not in ("ssf", "melo"):
            b9(3 * inner, grad)
        if fused_mhsa_supported(spec.heads, spec.dim_head, n):
            want["fused_mhsa"] += 1
            want["fused_mhsa_bwd"] += grad
        elif not (train_mode and spec.dropout > 0.0):
            want["flash_attention"] += 1
        if q8:
            want["int8_mlp"] += 1
        elif m != "ssf" and fused_mlp_supported(spec.dim, spec.mlp_dim, stream):
            want["fused_mlp"] += 1
            want["fused_mlp_bwd"] += grad

    if m in ("deep_vpt", "shallow_vpt"):
        rows = [n0 + spec.num_prompts]
        for _ in range(1, spec.depth):
            rows.append(rows[-1] - spec.prompt_dim + spec.num_prompts if spec.deep_prompt
                        else rows[-1])
    else:
        n = {"dvpt": n0 + spec.num_prompts, "evp": n0}.get(m, _pad8(n0))
        rows = [n] * spec.depth
    fast = m != "dvpt" and cls_fast_enabled(spec)
    for i, n in enumerate(rows[:-1] if fast else rows):
        layer(n, train and not (m == "adaptformer" and i == 0))
    if fast:
        if m not in ("ssf", "melo"):
            b9(2 * inner, train)
        want["cls_attention"] += not train and cls_attention_supported(
            spec.heads, spec.dim_head, rows[-1], stream)
    return want


def cut_vit_train_setup(model_over):
    """``vit_train_setup`` with the backbone at CUT_DEPTH layers."""
    from gaviko_tpu_torch import config

    saved = dict(config.VIT_CONFIG_MAP)
    config.VIT_CONFIG_MAP.update({k: dict(v, depth=CUT_DEPTH) for k, v in saved.items()})
    try:
        return vit_train_setup(model_over)
    finally:
        config.VIT_CONFIG_MAP.update(saved)


def vit_train_setup(model_over=None):
    """The ViT of vit.yaml, method fft (vit-b16, or as ``model_over``
    changes it; random init from seed 0, on the card), TRAIN_STEPS
    synthetic B8 batches and each step's seeds: one for the embedding,
    three a full layer on the fused MLP route or four on the plain one,
    four in the CLS-fast last layer (none where the rates are 0)."""
    import torch

    from gaviko_tpu_torch.models.factory import build_model

    config = _config(VIT_CONFIG, "fft", model_over)
    model = build_model(config["model"])
    spec = model.spec
    params = {k: v.to("cuda") for k, v in
              model.init(torch.Generator().manual_seed(0), spec).items()}

    def n_seeds(precision):
        mlp = 1 if _vit_routes(spec, _dtype(precision))["mlp"] else 2
        return (int(spec.emb_dropout > 0.0)
                + int(spec.dropout > 0.0) * ((spec.depth - 1) * (2 + mlp) + 4))

    seeds = {p: _step_seeds(n_seeds(p)) for p in ("fp32", "bf16")}
    return config, model, params, _batches(VIT_TRAIN_B, 1), seeds, vit_train_launches


def run_train(config, model, params, batches, seeds, launches, precision: str,
              profiled: bool = True, keep: bool = False) -> dict:
    """TRAIN_STEPS train steps (the counted, timed main path), optionally one
    more under the profiler, and one eval step, through the port's public
    train API. ``keep``: the result also holds the trainable tensors and
    the optimizer state after the counted steps (``profiled`` must be off)."""
    import torch

    from gaviko_tpu_torch.core.layers import SeedStream
    from gaviko_tpu_torch.train import loop
    from gaviko_tpu_torch.train.losses import make_criterion

    train_cfg = {**config["train"], "precision": precision}
    criterion = make_criterion(train_cfg)
    fused = loop.make_optimizer(train_cfg, TRAIN_TOTAL_STEPS)
    train_step, eval_step, _ = loop.make_steps(model, criterion, fused,
                                               loop.compute_dtype_of(train_cfg))
    trainable, frozen = loop.split_params(model, params)
    # The step updates the trainable tensors in place on the card (B13), so
    # each run starts from its own copy.
    trainable = {k: v.clone() for k, v in trainable.items()}
    opt_state = loop.init_opt_state(trainable, fused)
    seeds = seeds[precision]

    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for (x, y), step_seeds in zip(batches, seeds):
        stream = SeedStream(step_seeds)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        trainable, opt_state, loss, _ = train_step(trainable, opt_state, frozen, x, y,
                                                   stream)
        stop.record()
        stop.synchronize()
        step_ms.append(start.elapsed_time(stop))
        losses.append(float(loss))
        if stream.count != len(step_seeds):
            raise RuntimeError(f"a step used {stream.count} of {len(step_seeds)} seeds")
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    profile = profile_step(lambda: train_step(
        trainable, opt_state, frozen, *batches[0], SeedStream(seeds[0]))) if profiled else None
    eval_loss, _, logits = eval_step(trainable, frozen, *batches[0])
    if not np.isfinite([*losses, float(eval_loss)]).all() or not torch.isfinite(logits).all():
        raise RuntimeError(f"train {precision}: non-finite loss or logits")
    kept = {"params": trainable, "opt_state": opt_state} if keep and not profiled else {}
    return {**kept, "losses": losses, "step_ms": step_ms, "launches": launches,
            "peak_bytes": peak, "eval_loss": float(eval_loss),
            "trainable": len(trainable), "trainable_shapes": [tuple(v.shape) for v in
                                                                trainable.values()],
            "profile": profile}


def step1_grads(config, model, params, batches, seeds, launches, precision: str,
                cotangent=None) -> tuple:
    """Step 1's logits and the gradients of every trainable tensor: of the
    config's loss, or, given a logits ``cotangent``, of sum(logits *
    cotangent), which backpropagates that cotangent through the model."""
    from gaviko_tpu_torch.train import loop
    from gaviko_tpu_torch.train.losses import make_criterion

    train_cfg = {**config["train"], "precision": precision}
    criterion = make_criterion(train_cfg)
    if cotangent is not None:
        def criterion(logits, labels):
            return (logits * cotangent).sum()
    trainable, frozen = loop.split_params(model, params)
    _, logits, grads = loop.make_loss_and_grads(
        model, criterion, loop.compute_dtype_of(train_cfg))(
            trainable, frozen, *batches[0], seeds[precision][0])
    if not all(bool(g.isfinite().all()) for g in grads.values()):
        raise RuntimeError(f"train {precision}: non-finite gradient")
    return logits.float(), grads


# B11's device kernels in one int8 forward, by a part of their names, a
# layer: int8_linear is the row pass and one GEMM (the qkv projection and the
# out-projection), int8_mlp the row pass, fc1 (the f32 hidden and its rows'
# maxima), the hidden's codes and fc2.
INT8_KERNELS_A_LAYER = {"int8_rows_kernel": 3, "Int8LinearEpi": 2, "Int8Fc1Epi": 1,
                        "int8_hidden_kernel": 1, "Int8Fc2Epi": 1}


def _profile_int8_forward(forward, depth: int) -> dict:
    """:func:`profile_step` of an int8 forward whose trace must show the
    device kernels B11's wrappers launched in it, 2 int8_linear and 1
    int8_mlp calls a layer, exactly: INT8_KERNELS_A_LAYER times the depth
    by name. A trace that shows fewer of them while the wrappers launched
    every one has lost device records (once on the H100: 1,976 of the
    forward's 2,063 kernels traced) and is taken again, at most three
    times; ``attempts`` says how many it took."""
    from gaviko_tpu_torch.ops.int8_linear import int8_linear, int8_mlp

    want = {n: c * depth for n, c in INT8_KERNELS_A_LAYER.items()}
    for attempt in range(1, 4):
        before = int8_linear.launches, int8_mlp.launches
        profile = profile_step(forward, tuple(want))
        launched = (int8_linear.launches - before[0], int8_mlp.launches - before[1])
        if launched != (2 * depth, depth):
            raise RuntimeError(f"the int8 forward made {launched} int8_linear / int8_mlp calls, "
                               f"not {(2 * depth, depth)}")
        profile["attempts"] = attempt
        counts = profile["kernel_counts"]
        if counts == want:
            return profile
        if any(counts[n] > want[n] for n in want):
            break
    raise RuntimeError(f"the profiled int8 forward ran {profile['kernel_counts']}, not {want}")


_PROFILED_STEP = "chip_smoke_profiled_step"


def profile_step(step, count_names=()) -> dict:
    """One more step under torch.profiler: the wall time, the device's busy
    time (the sum of its kernels, which one stream runs one at a time) and
    so its idle share, the kernels that took the most device time, and the
    number of device kernels whose name holds each of ``count_names``.

    A session late in a long process can drop the device records of its
    first launches (up to 6 of a vit-b16 int8 forward's 141 on an H100), so
    each session opens with 32 throwaway launches, and only the device
    records that start inside the step's ``record_function`` range count
    (less the range's own annotation on the device's timeline)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warm = torch.zeros(1, device="cuda")
        for _ in range(32):
            warm.add_(1.0)
        torch.cuda.synchronize()
        with record_function(_PROFILED_STEP):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    opened = min(e.time_range.start for e in events if e.name == _PROFILED_STEP)
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.time_range.start >= opened and e.name != _PROFILED_STEP]
    by_name, busy_us = {}, 0.0
    for e in device:
        us = e.time_range.elapsed_us()
        busy_us += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    counts = {c: sum(1 for e in device if c in e.name) for c in count_names}
    return {"wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms, "device_kernels": len(device),
            "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top}, "kernel_counts": counts}


def phase_train(setup, precision: str, card: str) -> dict:
    result = run_train(*setup, precision)
    spec = setup[1].spec
    batch = setup[3][0][0].shape[0]
    per_step = {n: c / TRAIN_STEPS for n, c in result["launches"].items()}
    median = statistics.median(result["step_ms"])
    print(json.dumps({"phase": "train", "method": spec.method, "backbone": spec.backbone,
                      "precision": precision, "batch": batch,
                      "depth": spec.depth, "losses": result["losses"],
                      "eval_loss": result["eval_loss"], "step_ms": result["step_ms"],
                      "median_step_ms": median, "vol_per_s": 1e3 * batch / median,
                      "peak_memory_gib": result["peak_bytes"] / 2 ** 30,
                      "launches_per_step": per_step,
                      "trainable_tensors": result["trainable"],
                      "profile": result["profile"], "card": card}),
          flush=True)
    want = setup[5](spec, precision)
    if per_step != want:
        raise RuntimeError(f"train {precision}: launches a step {per_step}, want {want}")
    return result


def _grad_diff(got: dict, want: dict) -> dict:
    """Relative MAE and cosine over all trainable gradients, and the worst
    relative MAE of one tensor (among tensors with a nonzero gradient)."""
    a = np.concatenate([got[k].double().flatten().cpu().numpy() for k in want])
    b = np.concatenate([want[k].double().flatten().cpu().numpy() for k in want])
    per_tensor = {k: _rel_mae(got[k], g) for k, g in want.items() if float(g.abs().mean()) > 0}
    worst = max(per_tensor, key=per_tensor.get)
    return {"rel_mae": float(np.abs(a - b).mean() / np.abs(b).mean()),
            "cosine": float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))),
            "worst_tensor": worst, "worst_tensor_rel_mae": per_tensor[worst]}


def _loss_cotangent(setup, logits):
    """d loss / d logits of the config's criterion at step 1's labels."""
    import torch

    from gaviko_tpu_torch.train.losses import make_criterion

    leaf = logits.clone().requires_grad_(True)
    with torch.enable_grad():
        make_criterion(setup[0]["train"])(leaf, setup[3][0][1]).backward()
    return leaf.grad


def _share(part: dict, minus: dict, scale: dict) -> float:
    """mean |part - minus| over all trainable tensors, relative to mean
    |scale|: one term of a gradient difference, in the units of rel MAE."""
    num = sum(float((part[k].double() - minus[k].double()).abs().sum()) for k in scale)
    den = sum(float(scale[k].double().abs().sum()) for k in scale)
    return num / den


def phase_train_check(setup, precision: str, kernel: dict, card: str) -> None:
    """The same steps through the plain versions: per-step losses, step-1
    logits and step-1 gradients of the loss against the kernels' run.

    The config's parity focal loss clamps the logits to [1e-16, 1 - 1e-16]
    before its softmaxes, so its gradient jumps where a logit crosses 0 or
    1. In bf16 the two runs' logits differ by rounding and one can fall on
    the two sides of an edge. Only then are the gradients gated under one
    logits cotangent (the loss's at the plain run's logits) backpropagated
    through both runs, and the difference of the loss gradients is split in
    two: the kernels' share (both runs' backward of that one cotangent) and
    the clamp's share (the kernel run's backward of the change in cotangent
    between the two runs' logits)."""
    from gaviko_tpu_torch.ops._build import plain_versions

    with plain_versions():
        plain = run_train(*setup, precision, profiled=False)
        plain_logits, plain_grads = step1_grads(*setup, precision)
    kernel_logits, kernel_grads = step1_grads(*setup, precision)
    crossings = sum(int(((kernel_logits > edge) != (plain_logits > edge)).sum())
                    for edge in (1e-16, 1.0 - 1e-16))
    loss_budget, logits_budget, grad_budget, cos_floor = TRAIN_BUDGET[precision]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(kernel["losses"], plain["losses"])]
    logits_rel = _rel_mae(kernel_logits, plain_logits)
    line = {"phase": "train_check", "method": setup[1].spec.method, "precision": precision,
            "kernel_losses": kernel["losses"], "plain_losses": plain["losses"],
            "loss_rel": loss_rel, "step1_logits_rel_mae": logits_rel,
            "logits_crossing_a_clamp_edge": crossings,
            "grads_of_the_loss": _grad_diff(kernel_grads, plain_grads),
            "gated": "grads_of_the_loss"}
    if precision == "bf16" and crossings:
        cot = _loss_cotangent(setup, plain_logits)
        with plain_versions():
            _, plain_cot_grads = step1_grads(*setup, precision, cot)
        _, kernel_cot_grads = step1_grads(*setup, precision, cot)
        line.update(grads_under_one_cotangent=_grad_diff(kernel_cot_grads, plain_cot_grads),
                    gated="grads_under_one_cotangent",
                    loss_grad_share_of_the_kernels=_share(
                        kernel_cot_grads, plain_cot_grads, plain_grads),
                    loss_grad_share_of_the_clamp=_share(
                        kernel_grads, kernel_cot_grads, plain_grads))
    grads = line[line["gated"]]
    line.update(plain_step_ms=plain["step_ms"], card=card,
                budget={"loss_rel": loss_budget, "logits_rel_mae": logits_budget,
                        "grad_rel_mae": grad_budget, "cosine": cos_floor})
    print(json.dumps(line), flush=True)
    if max(loss_rel) > loss_budget:
        raise RuntimeError(f"train {precision}: loss rel {loss_rel} > {loss_budget}")
    if not logits_rel <= logits_budget:
        raise RuntimeError(f"train {precision}: step-1 logits rel MAE {logits_rel} > "
                           f"{logits_budget}")
    worst = grads["rel_mae"] if cos_floor is not None else max(
        grads["rel_mae"], grads["worst_tensor_rel_mae"])
    if not worst <= grad_budget:
        raise RuntimeError(f"train {precision}: {line['gated']} rel MAE {worst} > "
                           f"{grad_budget}")
    if cos_floor is not None and not grads["cosine"] >= cos_floor:
        raise RuntimeError(f"train {precision}: {line['gated']} cosine {grads['cosine']} "
                           f"< {cos_floor}")


def _ulps(got, want, mag=None) -> float:
    """max |got - want| in units in the last place, in want's dtype (24
    significant bits in f32, 8 in bf16), of ``mag``: the largest term of the
    sum that made want (want itself by default), since m' = b1 m + (1 - b1)
    g and p' = p - lr u can cancel."""
    import torch

    bits = 24 if want.dtype == torch.float32 else 8
    ref = want.double().abs() if mag is None else torch.maximum(want.double().abs(), mag)
    _, exp = torch.frexp(ref)
    return float(((got.double() - want.double()).abs() / torch.pow(2.0, exp - bits)).max())


# B13's leaf layouts: fresh tensors; every leaf's four tensors one element
# past a 16-byte boundary of one buffer each (16-byte vectors after a scalar
# head); every other leaf's grad one element off its moments and param
# (element by element).
ADAM_LAYOUTS = ("aligned", "unaligned", "mixed")


def _adam_leaves(shapes, dtype, gen, grad_std, layout="aligned"):
    """Random (grads, mu, nu, params) of ``shapes`` on the card, laid out
    as ``layout`` (ADAM_LAYOUTS) says."""
    import torch

    def randn(shape, std):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    def laid_out(xs, shifted):
        if layout == "aligned":
            return xs
        sizes = [x.numel() for x in xs]
        starts = np.cumsum([0] + [-(-(n + 1) // 16) * 16 for n in sizes[:-1]]).tolist()
        buf = torch.empty(starts[-1] + sizes[-1] + 16, dtype=dtype, device="cuda")
        out = []
        for i, (x, at) in enumerate(zip(xs, starts)):
            at += 1 if layout == "unaligned" or (shifted and i % 2) else 0
            view = buf[at:at + x.numel()].view(x.shape)
            view.copy_(x)
            out.append(view)
        return out

    grads = laid_out([randn(s, grad_std) for s in shapes], True)
    mu = laid_out([randn(s, 1e-3) for s in shapes], False)
    nu = laid_out([randn(s, 1e-3).float().square().to(dtype) for s in shapes], False)
    params = laid_out([randn(s, 0.02) for s in shapes], False)
    return grads, mu, nu, params


def _same_phase_copy(t):
    """A copy of ``t`` at its byte offset modulo 16 (``clone`` would start
    on a fresh, aligned allocation): B13 sees the same alignment."""
    import torch

    skip = (t.data_ptr() % 16) // t.element_size()
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _adam_chain(grads, mu, nu, params, lr, b1, clip=1.0):
    """PyTorch's own multi-tensor clip + Adam, for its time only (the port
    never calls it): torch._foreach_norm for the global norm, the clip
    scale, then torch._fused_adam_."""
    import torch

    steps = [torch.zeros((), device="cuda") for _ in params]

    def run():
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = (clip / norm).clamp(max=1.0)
        torch._foreach_mul_(grads, scale)
        torch._fused_adam_(params, grads, mu, nu, [], steps, lr=lr, beta1=b1, beta2=0.999,
                           weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False)

    return run


def _op_counts(fn) -> dict:
    """The PyTorch operators (aten, on the host) and the device events of
    one call of ``fn`` under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    return {"aten_ops": sum(e.name.startswith("aten::") for e in events
                            if e.device_type == DeviceType.CPU),
            "device_events": sum(e.device_type == DeviceType.CUDA for e in events)}


def phase_chain(card: str) -> dict:
    """``train.fused_optimizer: false``: vit.yaml's fft at vit-b16 widths
    and CUT_DEPTH layers, TRAIN_STEPS fp32 steps at B8 with the optax
    chain's state (``ChainState``: leaves [count, *mu, *nu, count]), against
    the same steps with the fused state. Both step B13 on the same math, so
    the losses (relative) and the trainable tensors (absolute) after the
    steps agree within CHAIN_BUDGET (the line says whether bit for bit);
    each step launches exactly ``vit_train_launches``, B13 once."""
    import torch

    from gaviko_tpu_torch.train.fused_optim import ChainState
    from gaviko_tpu_torch.utils.checkpoint import opt_leaves

    t0 = time.perf_counter()
    config, *rest = cut_vit_train_setup(None)
    spec = rest[0].spec
    runs = {}
    for name, flag in (("fused", True), ("chain", False)):
        cfg = {**config, "train": {**config["train"], "fused_optimizer": flag}}
        t = time.perf_counter()
        runs[name] = run_train(cfg, *rest, "fp32", profiled=False, keep=True)
        runs[name]["seconds"] = time.perf_counter() - t
    fused, chain = runs["fused"], runs["chain"]
    diff = max(float((chain["params"][k] - fused["params"][k]).abs().max())
               for k in fused["params"])
    want = vit_train_launches(spec, "fp32")
    per_step = {n: c / TRAIN_STEPS for n, c in chain["launches"].items()}
    n = len(fused["params"])
    line = {"phase": "chain", "backbone": spec.backbone, "depth": spec.depth,
            "batch": VIT_TRAIN_B, "precision": "fp32", "losses": chain["losses"],
            "fused_losses": fused["losses"], "step_ms": chain["step_ms"],
            "fused_step_ms": fused["step_ms"], "params_max_abs_diff": diff,
            "bit_equal": diff == 0.0 and chain["losses"] == fused["losses"],
            "state": type(chain["opt_state"]).__name__,
            "state_leaves": len(opt_leaves(chain["opt_state"])), "want_leaves": 2 + 2 * n,
            "launches_per_step": per_step, "b13_per_step": per_step["fused_adam"],
            "seconds": time.perf_counter() - t0, "card": card}
    print(json.dumps(line), flush=True)
    del runs, fused, chain
    torch.cuda.empty_cache()
    if line["state"] != ChainState.__name__ or line["state_leaves"] != 2 + 2 * n:
        raise RuntimeError(f"chain: state {line['state']} with {line['state_leaves']} leaves")
    if per_step != want or line["b13_per_step"] != 1:
        raise RuntimeError(f"chain: launches a step {per_step}, want {want}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(line["losses"], line["fused_losses"]))
    if not (loss_rel <= CHAIN_BUDGET and diff <= CHAIN_BUDGET):
        raise RuntimeError(f"chain: losses {line['losses']} vs {line['fused_losses']}, params "
                           f"differ by {diff} (budget {CHAIN_BUDGET})")
    return line


def phase_adam(card: str, name: str, shapes) -> dict:
    """B13 on the trainable leaves ``shapes`` of a train run: f32 and bf16
    storage, the cycled beta1 of step ADAM_STEP of 100, clipping off
    (gradients of std 1e-6: gn < 1) and on (std 1), on fresh leaves, and
    with clipping on also on leaves at odd element offsets of one buffer
    (ADAM_LAYOUTS): every output of the kernel against the plain version on
    the same inputs (f32 within 2 ULP, bf16 within 1 ULP, of each output's
    largest term; ``max_ulp`` the worst), and a second run of the kernel
    bit-equal to the first. Then, with clipping on, over back-to-back calls:
    the kernel's one launch or two alone (``ms``; ``one_pass`` says which),
    the whole wrapper call with its host work (``call_ms``), the plain
    version and PyTorch's own foreach-norm + fused-Adam chain; the bound (g,
    m, v and p read and m', v' and p' written once an element, over 3.35
    TB/s); and the PyTorch operators and device kernels a later
    ``fused_optim.step`` issues (its table held), against the plain step's.
    Returns the lines by dtype."""
    import torch

    from gaviko_tpu_torch.ops import fused_adam as fa
    from gaviko_tpu_torch.ops._build import plain_versions
    from gaviko_tpu_torch.ops.fused_adam import fused_adam
    from gaviko_tpu_torch.train import fused_optim
    from gaviko_tpu_torch.train import schedule as schedule_lib

    sched, beta1 = schedule_lib.onecycle_cos(3e-4, 100), schedule_lib.onecycle_beta1(100)
    lr, b1, c1, c2 = fused_optim.step_scalars(ADAM_STEP, sched, beta1)
    n = sum(int(np.prod(s)) for s in shapes)
    gen = torch.Generator(device="cuda").manual_seed(7)
    lines = {}
    for dtype in (torch.float32, torch.bfloat16):
        budget = 2 if dtype == torch.float32 else 1
        max_abs, bit_equal, layout_ulp = 0.0, True, {}
        # the last run's leaves (fresh, clipping on) are the timed ones
        for grad_std, layout in ((1e-6, "aligned"), *((1.0, lay) for lay in ADAM_LAYOUTS[1:]),
                                 (1.0, "aligned")):
            grads, mu, nu, params = _adam_leaves(shapes, dtype, gen, grad_std, layout)
            ulp = 0.0
            with plain_versions():
                want = fused_adam(grads, mu, nu, params, lr, b1, c1, c2)
            runs = []
            for _ in range(2):
                copies = [[_same_phase_copy(t) for t in ts] for ts in (mu, nu, params)]
                runs.append(fused_adam(grads, *copies, lr, b1, c1, c2))
            torch.cuda.synchronize()
            for i in range(len(shapes)):
                mags = ((params[i].double() - want[0][i].double()).abs().maximum(
                            params[i].double().abs()),
                        (b1 * mu[i].double()).abs().maximum(
                            ((1 - b1) * grads[i].double()).abs()), None)
                for got, ref, mag in zip(runs[0], want, mags):
                    if not torch.isfinite(got[i]).all():
                        raise RuntimeError(f"B13 {name} {dtype}: non-finite output")
                    ulp = max(ulp, _ulps(got[i], ref[i], mag))
                    max_abs = max(max_abs, float((got[i].double() - ref[i].double()).abs().max()))
            bit_equal &= all(torch.equal(a, b) for x, y in zip(*runs) for a, b in zip(x, y))
            layout_ulp[layout] = max(layout_ulp.get(layout, 0.0), ulp)
            del want, runs
        worst_ulp = max(layout_ulp.values())
        copies = [[t.clone() for t in ts] for ts in (mu, nu, params)]
        table = fa.AdamTable(*copies)
        call_ms = _median_ms(lambda: fused_adam(grads, *copies, lr, b1, c1, c2, table=table),
                             calls=KERNEL_CALLS)
        ms = _median_ms(lambda: fa.launch_table(table, copies[2][0], 1.0, 1e-8),
                        calls=KERNEL_CALLS)
        with plain_versions():
            plain_ms = _median_ms(lambda: fused_adam(grads, mu, nu, params, lr, b1, c1, c2),
                                  reps=3, warmup=1, calls=2)
        chain = [[t.clone() for t in ts] for ts in (grads, mu, nu, params)]
        chain_ms = _median_ms(_adam_chain(*chain, lr, b1), calls=KERNEL_CALLS)
        size = torch.empty((), dtype=dtype).element_size()
        bound_ms, bound_by = _bound((7 * n * size, 12 * n), "torch.float32")
        keys = [str(i) for i in range(len(shapes))]
        state = fused_optim.FusedAdamState(ADAM_STEP, dict(zip(keys, copies[0])),
                                           dict(zip(keys, copies[1])))
        step_args = (dict(zip(keys, grads)), state, dict(zip(keys, copies[2])), sched)
        # The first step builds the kernel's table and hands it on with the
        # state; count the operators of the next one, as every later step.
        held = fused_optim.step(*step_args, b1=beta1)
        ops = _op_counts(lambda: fused_optim.step(step_args[0], held[1], held[0], sched,
                                                  b1=beta1))
        with plain_versions():
            plain_ops = _op_counts(lambda: fused_optim.step(*step_args, b1=beta1))
        line = {"phase": "kernel", "path": "adam", "name": name, "dtype": str(dtype),
                "leaves": len(shapes), "elements": n, "lr": lr, "b1": b1,
                "max_ulp": worst_ulp, "ulp_by_layout": layout_ulp, "ulp_budget": budget,
                "max_abs_err": max_abs, "bit_equal_reruns": bit_equal,
                "one_pass": table.one_pass, "ms": ms, "call_ms": call_ms,
                "plain_ms": plain_ms, "chain_ms": chain_ms, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": 7 * n * size,
                "operations": 12 * n, "step_ops": ops, "plain_step_ops": plain_ops,
                "card": card}
        print(json.dumps(line), flush=True)
        lines[str(dtype)] = line
        if not worst_ulp <= budget:
            raise RuntimeError(f"B13 {name} {dtype}: {worst_ulp} ULP > {budget}")
        if not bit_equal:
            raise RuntimeError(f"B13 {name} {dtype}: two runs differ")
        if ops["aten_ops"] > 50:  # the plain step issues ~20 a leaf
            raise RuntimeError(f"B13 {name} {dtype}: one optimizer step issued {ops}")
        del grads, mu, nu, params, copies, chain, table, held
        torch.cuda.empty_cache()
    return lines


def _trainer_files(root: str, label: int, volumes=TRAINER_VOLUMES,
                   config_path: str = CONFIG) -> tuple:
    """The trainer phase's synthetic dataset under ``root``: (120, 160,
    160) .npz volumes, 8 train and 4 val (or ``volumes``), and the CSV
    (every volume of class ``label``), plus a copy of gaviko.yaml (or
    ``config_path``) pointing at them. Returns (config path, config, volume
    folder)."""
    import yaml

    from gaviko_tpu_torch.config import load_config

    n_train, n_val = volumes
    folder = os.path.join(root, "volumes")
    os.makedirs(folder, exist_ok=True)
    rows = ["mri_path,kl_grade,subset"]
    for i in range(n_train + n_val):
        name = f"vol_{i:02d}.npz"
        path = os.path.join(folder, name)
        if not os.path.exists(path):
            vol = np.random.RandomState(100 + i).rand(120, 160, 160).astype(np.float32)
            np.savez(path, data=vol)
        rows.append(f"{name},{label},{'train' if i < n_train else 'val'}")
    with open(os.path.join(root, "labels.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    config = load_config(config_path)
    config["data"].update(data_path=os.path.join(root, "labels.csv"), image_folder=folder,
                          test_data=os.path.join(root, "labels.csv"))
    config["utils"].update(log_dir=os.path.join(root, "log"),
                           results_dir=os.path.join(root, "outputs"))
    config["train"].update(num_epochs=2, save_threshold=-1,
                           profile={"enabled": True, "start_step": 1, "num_steps": 1})
    path = os.path.join(root, "gaviko.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path, config, folder


def phase_trainer_check(root: str, card: str) -> list:
    """The first two steps of the trainer phase's run (the CLI's model:
    GAViKO vit-l16, random init from seed 0; its loader's first two train
    batches and its dropout seeds), with the kernels and inside
    ``plain_versions()``, each from its own copy of the params, fp32 with
    TF32 off: the trainable params within 1e-4 relative MAE, and the update
    the two steps applied (final params less initial ones) within
    TRAINER_UPDATE_BUDGET relative MAE of the plain path's (1 if the
    optimizer applied nothing; the params' own MAE is dominated by their
    initial values, which two steps move by ~3e-4). Every volume
    is labelled with the class the random-init model gives most of the val
    volumes, so that training keeps that class, the first validation scores
    above 0 and the best checkpoint is written. Returns that class and the
    names of the trainable tensors."""
    import torch

    from gaviko_tpu_torch.cli.train import make_loaders
    from gaviko_tpu_torch.data import transforms as T
    from gaviko_tpu_torch.models.factory import build_model
    from gaviko_tpu_torch.models.pretrained import build_params
    from gaviko_tpu_torch.ops._build import plain_versions
    from gaviko_tpu_torch.train import loop
    from gaviko_tpu_torch.train.losses import make_criterion
    from gaviko_tpu_torch.utils.layouts import put_volume

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, config, folder = _trainer_files(root, 0)
    model = build_model(config["model"])
    params = {k: v.to("cuda") for k, v in build_params(
        model, torch.Generator().manual_seed(0), pretrained_dir=None).items()}
    n_train, n_val = TRAINER_VOLUMES
    paths = [os.path.join(folder, f"vol_{i:02d}.npz") for i in range(n_train + n_val)]
    train_cfg = config["train"]
    fused = loop.make_optimizer(train_cfg, 2 * (n_train // config["data"]["batch_size"]))
    train_step, _, predict_step = loop.make_steps(model, make_criterion(train_cfg), fused)
    trainable, frozen = loop.split_params(model, params)
    with torch.no_grad():
        x = put_volume(np.stack([T.eval_transform(np.load(p)["data"][None])
                                 for p in paths[n_train:]]), torch.float32, "cuda")
        val_classes = predict_step(trainable, frozen, x).argmax(-1).tolist()
    label = max(set(val_classes), key=val_classes.count)
    _, config, _ = _trainer_files(root, label)
    loader = make_loaders(config)[0]
    loader.set_epoch(0)
    batches = [(put_volume(x, torch.float32, "cuda"), torch.from_numpy(y).long().cuda())
               for x, y, _ in list(loader)[:2]]
    seeds = loop.default_step_seeds(0)
    runs = {}
    for name in ("kernels", "plain"):
        with plain_versions(name == "plain"):
            tr = {k: v.clone() for k, v in trainable.items()}
            state = loop.init_opt_state(tr, fused)
            losses = []
            for step, (xb, yb) in enumerate(batches):
                tr, state, loss, _ = train_step(tr, state, frozen, xb, yb, seeds(step))
                losses.append(float(loss))
            runs[name] = (tr, losses)
    got, want = runs["kernels"][0], runs["plain"][0]
    rel = _rel_mae(torch.cat([got[k].flatten() for k in got]),
                   torch.cat([want[k].flatten() for k in got]))
    upd = _rel_mae(torch.cat([(got[k] - trainable[k]).flatten() for k in got]),
                   torch.cat([(want[k] - trainable[k]).flatten() for k in got]))
    line = {"phase": "trainer_check", "steps": len(batches), "trainable_tensors": len(got),
            "kernel_losses": runs["kernels"][1], "plain_losses": runs["plain"][1],
            "params_rel_mae": rel, "budget": F32_BUDGET, "update_rel_mae": upd,
            "update_budget": TRAINER_UPDATE_BUDGET,
            "val_classes_at_init": val_classes, "label": label, "card": card}
    print(json.dumps(line), flush=True)
    if not rel <= F32_BUDGET:
        raise RuntimeError(f"trainer check: params rel MAE {rel} > {F32_BUDGET}")
    if not upd <= TRAINER_UPDATE_BUDGET:
        raise RuntimeError(f"trainer check: update rel MAE {upd} > {TRAINER_UPDATE_BUDGET}")
    keys = set(trainable)
    del params, trainable, frozen, runs, batches
    torch.cuda.empty_cache()
    return label, keys


def _cli(module: str, *args) -> None:
    """``python -m gaviko_tpu_torch.cli.<module> args``; raises on failure."""
    proc = subprocess.run([sys.executable, "-m", f"gaviko_tpu_torch.cli.{module}", *args],
                          capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise RuntimeError(f"cli.{module} exited {proc.returncode}:\n{proc.stderr[-4000:]}")


def _csv_rows(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _trace_stats(path: str) -> dict:
    """One profiled train step's chrome trace: wall ms (first to last
    event), device busy ms (the sum of its kernels, which one stream runs one
    at a time), idle share, kernel launches, and B13's among them (its
    one-launch kernel, or its norm and update kernels)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "dur" in e and "ts" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    wall_us = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    busy_us = sum(e["dur"] for e in kernels)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us, "launches": len(kernels),
            "b13_one_pass_launches": sum("adam_norm_update" in e["name"] for e in kernels),
            "b13_update_launches": sum("adam_update" in e["name"] for e in kernels),
            "b13_norm_launches": sum("adam_sumsq" in e["name"] for e in kernels)}


def phase_trainer(root: str, label: int, trainable_keys, card: str, one_pass: bool) -> dict:
    """The port's CLIs end to end at full width (GAViKO vit-l16, batch 4,
    fp32, gaviko.yaml with num_epochs 2, save_threshold -1 and the second
    step profiled) on the synthetic volumes: ``cli.train``, then again with
    num_epochs 3 and ``--resume auto``, ``cli.evaluate`` on the best
    checkpoint and ``cli.infer`` on the volume folder, each a subprocess.
    Checks the 15-field CSV with a row a step, that the resume continued at
    epoch 2, the trainable-only checkpoint and the 4- and 12-row outputs;
    reads the profiled step's trace, whose B13 is one kernel where
    ``one_pass`` (its leaves' gradients fit in L2), else two."""
    import torch
    import yaml

    from gaviko_tpu_torch.utils.logging import TRAIN_LOG_FIELDS

    t0 = time.perf_counter()
    cfg_path, config, folder = _trainer_files(root, label)
    weights, outputs = os.path.join(root, "weights"), os.path.join(root, "outputs")
    _cli("train", "--config", cfg_path, "--method", "gaviko", "--results_dir", weights)
    t_train = time.perf_counter() - t0
    config["train"].update(num_epochs=3, profile={"enabled": False})
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    _cli("train", "--config", cfg_path, "--method", "gaviko", "--results_dir", weights,
         "--resume", "auto")
    log_dir = config["utils"]["log_dir"]
    first = _csv_rows(os.path.join(log_dir, "gaviko_training_log_v1.csv"))
    resumed = _csv_rows(os.path.join(log_dir, "gaviko_training_log_v2.csv"))
    n_train, n_val = TRAINER_VOLUMES
    batch = config["data"]["batch_size"]
    per_epoch = -(-n_train // batch) + -(-n_val // batch)
    exp_dir = os.path.join(weights, "experiments", "gaviko")
    best = sorted(f for f in os.listdir(exp_dir) if f.endswith(".pt"))
    saved = set(torch.load(os.path.join(exp_dir, best[-1]), weights_only=True)) if best else set()
    _cli("evaluate", "--config", cfg_path, "--method", "gaviko", "--checkpoint",
         os.path.join(exp_dir, best[-1]) if best else "none", "--results_dir", outputs)
    _cli("infer", "--config", cfg_path, "--method", "gaviko", "--checkpoint",
         os.path.join(exp_dir, best[-1]) if best else "none", "--results_dir", outputs)
    prefix = os.path.join(outputs, "gaviko_" + config["model"]["backbone"].replace("-", "_"))
    eval_rows = _csv_rows(prefix + "_eval_results_v1.csv")
    infer_rows = _csv_rows(prefix + "_inference_results_v1.csv")
    with open(prefix + "_eval_results_v1_metrics.txt") as f:
        metrics = f.read().strip().splitlines()
    trace = _trace_stats(os.path.join(log_dir, "profile", "trace.json"))
    trace["ms_per_step"] = trace["wall_ms"]
    trace["vol_per_s"] = 1e3 * batch / trace["wall_ms"]
    line = {"phase": "trainer", "csv_fields": len(first[0]) if first else 0,
            "csv_rows": len(first), "want_rows": 2 * per_epoch,
            "resumed_epochs": sorted({int(r["epoch"]) for r in resumed}),
            "best_checkpoints": best, "checkpoint_keys": len(saved),
            "trainable_keys": len(trainable_keys), "eval_rows": len(eval_rows),
            "infer_rows": len(infer_rows), "metrics": metrics, "profiled_step": trace,
            "seconds_first_train": t_train, "seconds": time.perf_counter() - t0, "card": card}
    print(json.dumps(line), flush=True)
    if list(first[0]) != TRAIN_LOG_FIELDS or len(first) != 2 * per_epoch:
        raise RuntimeError(f"trainer: CSV {len(first)} rows of {list(first[0])}")
    if line["resumed_epochs"] != [2] or len(resumed) != per_epoch:
        raise RuntimeError(f"trainer: the resume ran epochs {line['resumed_epochs']}")
    if not best or saved != trainable_keys:
        raise RuntimeError(f"trainer: best checkpoints {best} hold {len(saved)} keys, "
                           f"want the {len(trainable_keys)} trainable ones")
    if len(eval_rows) != n_val or len(infer_rows) != n_train + n_val:
        raise RuntimeError(f"trainer: {len(eval_rows)} eval and {len(infer_rows)} "
                           "inference rows")
    b13 = (trace["b13_one_pass_launches"], trace["b13_norm_launches"],
           trace["b13_update_launches"])
    if b13 != ((1, 0, 0) if one_pass else (0, 1, 1)):
        raise RuntimeError(f"trainer: the profiled step ran B13 {trace}")
    return line


def zoo_train_setup(method: str, config_path: str, model_over=None):
    """A PEFT method of its shipped config (vit-b16, random init from seed
    0, on the card), TRAIN_STEPS synthetic B8 batches and each step's
    dropout seeds: with the backbone frozen only the prompts' (deep VPT one
    a layer, shallow VPT one); MeLO trains its backbone in train mode (the
    embedding, then as the plain ViT's fft step); none for the others."""
    import torch

    from gaviko_tpu_torch.models.factory import build_model

    config = _config(config_path, method, model_over)
    model = build_model(config["model"])
    spec = model.spec
    params = {k: v.to("cuda") for k, v in
              model.init(torch.Generator().manual_seed(0), spec).items()}

    def n_seeds(precision):
        if method in ("deep_vpt", "shallow_vpt"):
            return int(spec.prompt_dropout > 0.0) * (spec.depth if spec.deep_prompt else 1)
        if method == "melo":
            mlp = 1 if _vit_routes(spec, _dtype(precision))["mlp"] else 2
            return (int(spec.emb_dropout > 0.0)
                    + int(spec.dropout > 0.0) * ((spec.depth - 1) * (2 + mlp) + 4))
        return 0

    seeds = {p: _step_seeds(n_seeds(p)) for p in ("fp32", "bf16")}
    return (config, model, params, _batches(VIT_TRAIN_B, 2), seeds,
            lambda s, precision: zoo_launches(s, _dtype(precision), True))


class _Warnings(logging.Handler):
    """The messages of the warnings logged while it is attached."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_zoo_serving(config_path: str, method: str, model_over, vols, card: str,
                      quantize=None, fp_served=None) -> tuple:
    """One bf16 B8 batch through ``predict_logits`` with every kernel's
    launches counted (``zoo_launches``), against the same params through
    the plain versions on the card (relative MAE <= SERVE_BUDGET), and one
    forward under the profiler. ``quantize="int8"``: the Predictor adds
    the int8 sidecars (B11 in every layer but the CLS-fast last one), and
    the logits are also held to ``fp_served``, the method's bf16 served
    logits of the same volumes (INT8_FP_BUDGET), as the vit_int8 run's
    are; SSF must log the JAX package's refusal and serve full precision
    (no B11 launch). Returns the launches and the served logits."""
    import torch

    from gaviko_tpu_torch.ops._build import plain_versions
    from gaviko_tpu_torch.utils.layouts import put_volume

    caught = _Warnings()
    logging.getLogger().addHandler(caught)
    try:
        predictor = make_predictor(config_path, method, model_over, quantize=quantize)
    finally:
        logging.getLogger().removeHandler(caught)
    spec = predictor.spec
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    served = predictor.predict_logits(vols).astype(np.float64)
    launches = {n: w.launches for n, w in wrappers.items()}
    with plain_versions():
        plain = predictor.predict_logits(vols).astype(np.float64)
    rel = float(np.abs(served - plain).mean() / max(np.abs(plain).mean(), 1e-30))
    batch = put_volume(np.stack([v[None] for v in vols]), torch.bfloat16, predictor.device)
    forward_ms = _median_ms(lambda: predictor._forward(predictor.params, batch), reps=5)
    profile = profile_step(lambda: predictor._forward(predictor.params, batch))
    quantized = quantize == "int8"
    want = zoo_launches(spec, torch.bfloat16, False, quantized)
    line = {"phase": "zoo_serving", "method": method, "backbone": spec.backbone,
            "depth": spec.depth, "batch_size": len(vols), "dtype": "bfloat16",
            "quantize": quantize, "rel_mae": rel, "budget": SERVE_BUDGET,
            "argmax_agreement": float((served.argmax(-1) == plain.argmax(-1)).mean()),
            "forward_ms": forward_ms, "launches": launches, "want_launches": want,
            "profile": profile, "card": card}
    refused = any("int8 quantization is not supported for SSF" in m for m in caught.messages)
    if quantized:
        line.update(rel_mae_vs_fp=_rel_mae_np(served, fp_served), fp_budget=INT8_FP_BUDGET,
                    argmax_agreement_vs_fp=float((served.argmax(-1)
                                                  == fp_served.argmax(-1)).mean()),
                    int8_refused=refused)
    print(json.dumps(line), flush=True)
    del predictor
    torch.cuda.empty_cache()
    if served.shape != (len(vols), spec.num_classes) or not np.isfinite(served).all():
        raise RuntimeError(f"{method}: served logits {served.shape}, finite "
                           f"{np.isfinite(served).all()}")
    if launches != want:
        raise RuntimeError(f"{method} serving launched {launches}, want {want}")
    if not rel <= SERVE_BUDGET:
        raise RuntimeError(f"{method} served logits vs plain: rel MAE {rel} > {SERVE_BUDGET}")
    if quantized and not (line["rel_mae_vs_fp"] <= INT8_FP_BUDGET
                          and refused == (method == "ssf")):
        raise RuntimeError(f"{method} int8: rel MAE vs bf16 {line['rel_mae_vs_fp']} > "
                           f"{INT8_FP_BUDGET}, or the SSF refusal logged: {refused}")
    return launches, served


@contextlib.contextmanager
def _lnqkv_hybrid(on: bool):
    """GAVIKO_LNQKV_HYBRID set to "1" (on) or "0" for one run, then restored."""
    prev = os.environ.get("GAVIKO_LNQKV_HYBRID")
    os.environ["GAVIKO_LNQKV_HYBRID"] = "1" if on else "0"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["GAVIKO_LNQKV_HYBRID"]
        else:
            os.environ["GAVIKO_LNQKV_HYBRID"] = prev


# ---------------------------------------------------------------------------
# The trainer's input and starting weights: timm conversion, on-device
# augmentation, the host loader engines, and the trainer on all three.
# ---------------------------------------------------------------------------

AUGMENT_B = 4  # GAViKO's train batch
AUGMENT_BUDGET = 1e-5  # largest |card - CPU| of an augmented batch in [0, 1]


def phase_weights(root: str, card: str) -> tuple:
    """A synthetic vit-l16 timm file (``convert.synthetic_timm_state``, seed
    0, as a ``.pt``) under ``root/pretrained``; ``convert.load_pretrain`` of
    it, then
    GAViKO (gaviko.yaml) built on the card by ``build_params`` from it. Every
    converted key that lands must equal the converted array bit for bit;
    the to_qkv biases drop (no destination: PARITY #3). Returns
    (pretrained_dir, a few converted tensors to check the trainer's start
    against)."""
    import torch

    from gaviko_tpu_torch.models.factory import build_model
    from gaviko_tpu_torch.models.pretrained import build_params
    from gaviko_tpu_torch.weights import convert

    config = _config(CONFIG, "gaviko")
    model = build_model(config["model"])
    spec = model.spec
    pretrained = os.path.join(root, "pretrained")
    os.makedirs(pretrained, exist_ok=True)
    t0 = time.perf_counter()
    state = convert.synthetic_timm_state(spec.backbone, 0)
    path = os.path.join(pretrained, convert.TIMM_MODEL_NAMES[spec.backbone] + ".pt")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    t_write = time.perf_counter() - t0
    n_timm = len(state)
    del state
    t0 = time.perf_counter()
    conv = convert.load_pretrain(spec.backbone, spec.num_patches, spec.frame_patch_size,
                                 pretrained)
    t_convert = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = build_params(model, torch.Generator("cuda").manual_seed(0),
                          pretrained_dir=pretrained, require_pretrained=True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    landed = [k for k in conv if k in params]
    dropped = sorted(set(conv) - set(landed))
    mismatched = [k for k in landed
                  if not torch.equal(params[k].cpu(), torch.from_numpy(conv[k]))]
    devices = sorted({str(params[k].device) for k in landed})
    keep = ("pos_embedding", "conv_proj.0.weight", "transformer.attns.0.to_qkv.weight",
            f"transformer.mlps.{spec.depth - 1}.net.4.weight")
    sample = {k: torch.from_numpy(conv[k].copy()) for k in keep}
    line = {"phase": "weights", "backbone": spec.backbone, "method": spec.method,
            "timm_file": os.path.basename(path), "timm_keys": n_timm,
            "timm_bytes": os.path.getsize(path), "converted_keys": len(conv),
            "landed_keys": len(landed), "dropped_keys": len(dropped),
            "dropped_kinds": sorted({k.split(".")[-2] + "." + k.split(".")[-1]
                                     for k in dropped}),
            "landed_bytes": int(sum(conv[k].nbytes for k in landed)),
            "mismatched": mismatched[:5], "devices": devices,
            "seconds_write": t_write, "seconds_convert": t_convert,
            "seconds_build_params": t_build, "card": card}
    print(json.dumps(line), flush=True)
    del params, conv
    torch.cuda.empty_cache()
    if mismatched:
        raise RuntimeError(f"weights: {len(mismatched)} landed keys differ from the "
                           f"converted arrays, e.g. {mismatched[:3]}")
    if devices != ["cuda:0"] or len(landed) != 6 + 11 * spec.depth or \
            any(not k.endswith("to_qkv.bias") for k in dropped):
        raise RuntimeError(f"weights: {len(landed)} keys landed on {devices}, dropped "
                           f"{dropped[:4]}")
    return pretrained, sample


def phase_augment(card: str) -> dict:
    """``ops/augment.train_augment`` at GAViKO's B4 (4, 1, 120, 160, 160)
    f32 on the card, one draw of parameters from seed 0 with every volume
    warped (p_affine 1) and the first and third flipped, each method
    against the same call on the CPU (AUGMENT_BUDGET), ms per batch (CUDA
    events, median of 10) and the bytes bound; then the GAViKO vit-l16
    train step at B4 bf16 (random init) without and with device
    augmentation in turns, 4 steps each after a warm-up of each, ms a step
    (CUDA events; the step is host-bound, so this is close to its wall
    time)."""
    import torch

    from gaviko_tpu_torch.ops.augment import draw_augment_params, train_augment
    from gaviko_tpu_torch.train import loop
    from gaviko_tpu_torch.train.losses import make_criterion

    x_cpu = torch.from_numpy(
        np.random.RandomState(0).rand(AUGMENT_B, 1, 120, 160, 160).astype(np.float32) * 900)
    x = x_cpu.cuda()
    params = draw_augment_params(torch.Generator().manual_seed(0), AUGMENT_B, p_affine=1.0)
    params = params._replace(flip=torch.arange(AUGMENT_B) % 2 == 0)
    line = {"phase": "augment", "batch": list(x.shape), "flips": int(params.flip.sum()),
            "card": card}
    for method in ("shear", "gather"):
        got = train_augment(x, params, method).cpu()
        want = train_augment(x_cpu, params, method)
        err = float((got - want).abs().max())
        ms = _median_ms(lambda: train_augment(x, params, method), reps=10, warmup=2)
        line[method] = {"max_abs_err": err, "ms": ms,
                        "finite": bool(torch.isfinite(got).all()),
                        "bound_ms": 1e3 * 2 * x.numel() * 4 / HBM_BYTES_PER_S}
    config, model, params0, batches, seeds, _ = train_setup()
    train_cfg = config["train"]
    criterion = make_criterion(train_cfg)
    fused = loop.make_optimizer(train_cfg, TRAIN_TOTAL_STEPS)
    trainable, frozen = loop.split_params(model, params0)
    state = loop.init_opt_state(trainable, fused)
    draw = loop.default_step_augment(0)
    xb, yb = batches[0]
    steps = {on: loop.make_steps(model, criterion, fused, torch.bfloat16,
                                 device_augment=on)[0] for on in (False, True)}

    def step(on):
        nonlocal trainable, state
        trainable, state, _, _ = steps[on](trainable, state, frozen, xb, yb, seeds["bf16"][0],
                                           draw(0, xb.shape[0]) if on else None)

    step_ms = {False: [], True: []}
    for on in (False, True):
        step(on)
    for _ in range(4):
        for on in (False, True):
            step_ms[on].append(_median_ms(lambda: step(on), reps=1, warmup=0))
    line["train_step_b4_bf16_ms"] = {
        "without": statistics.median(step_ms[False]),
        "with_augment": statistics.median(step_ms[True]),
        "without_runs": step_ms[False], "with_augment_runs": step_ms[True]}
    print(json.dumps(line), flush=True)
    del params0, batches, x
    torch.cuda.empty_cache()
    for method in ("shear", "gather"):
        if not (line[method]["finite"] and line[method]["max_abs_err"] <= AUGMENT_BUDGET):
            raise RuntimeError(f"augment {method}: card vs CPU {line[method]}")
    return line


def _engine_epochs(make, ds, batch: int, epochs: int = 2) -> tuple:
    """``epochs`` epochs of one loader engine: ([{seconds, first_batch_s,
    volumes, vol_per_s} an epoch], the batches of every epoch). The first
    epoch's time includes the engine's start (a process engine spawns its
    workers there; later epochs reuse them)."""
    loader = make(ds, batch, shuffle=True, num_workers=8, seed=0, pad_to_batch=True)
    stats, batches = [], []
    try:
        for _ in range(epochs):
            t0 = time.perf_counter()
            first = None
            for item in loader:
                batches.append(item)
                first = first or time.perf_counter() - t0
            secs = time.perf_counter() - t0
            vols = sum(b[2] for b in batches[-len(loader):])
            stats.append({"seconds": secs, "first_batch_s": first, "volumes": vols,
                          "vol_per_s": vols / secs})
    finally:
        if hasattr(loader, "close"):
            loader.close()
    return stats, batches


def phase_loader(folder: str, card: str) -> dict:
    """The host side: the port's min-max rescale (``transforms.
    rescale_intensity``) and int16 widening (``VolumeDataset.load``'s
    ``astype``) on one (1, 120, 160, 160) volume (host clock, median of 5;
    GB/s of the bytes each must move: the rescale reads the volume and
    writes it, the widening reads 2 bytes and writes 4 an element), then two
    epochs of the synthetic volumes through the threaded ``Loader``, ``grain``
    on threads and ``grain`` on 2 processes (the first with their start), with the
    raw transform of ``device_augment`` and with the host train transform
    (after one warm-up epoch of the threaded loader: the files cached, the
    imports done); every engine's batches bit-equal to the threaded
    loader's."""
    import functools

    from gaviko_tpu_torch.data import pipeline, transforms
    from gaviko_tpu_torch.data.grain_pipeline import GrainLoader

    def host_ms(fn, reps=5):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(times)

    rng = np.random.RandomState(0)
    vol = rng.rand(1, 120, 160, 160).astype(np.float32) * 900
    raw = (rng.rand(1, 120, 160, 160) * 3000).astype(np.int16)
    n = vol.size
    line = {"phase": "loader", "cpu_count": os.cpu_count(), "card": card}
    for name, fn, nbytes in (
            ("rescale", lambda: transforms.rescale_intensity(vol), 8 * n),
            ("widen_i16", lambda: np.asarray(raw, dtype=np.float32), 6 * n)):
        ms = host_ms(fn)
        line[name] = {"ms": ms, "gb_s": nbytes / ms / 1e6}
    paths = sorted(os.path.join(folder, f) for f in os.listdir(folder) if f.endswith(".npz"))
    labels = np.zeros(len(paths), np.int64)
    engines = {"loader": pipeline.Loader,
               "grain_threads": functools.partial(GrainLoader, processes=0),
               "grain_2_processes": functools.partial(GrainLoader, processes=2)}
    same = True
    for tf_name, tf in (("raw", transforms.raw_volume), ("train", transforms.train_transform)):
        ds = pipeline.VolumeDataset(paths, labels, tf, train=True)
        _engine_epochs(pipeline.Loader, ds, TRAIN_B, epochs=1)
        ref = None
        line[tf_name] = {}
        for name, make in engines.items():
            line[tf_name][name], batches = _engine_epochs(make, ds, TRAIN_B)
            if ref is None:
                ref = batches
            else:
                same = same and len(ref) == len(batches) and all(
                    np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                    for a, b in zip(ref, batches))
    line["engines_bit_equal"] = same
    print(json.dumps(line), flush=True)
    if not same:
        raise RuntimeError("loader: the engines' batches differ")
    return line


@contextlib.contextmanager
def _count_train_steps(record: list):
    """Within: every train step that ``loop.make_steps`` builds appends the
    launches of each kernel wrapper during that step (counts set to 0 just
    before it, read just after) to ``record``."""
    from gaviko_tpu_torch.train import loop

    wrappers, inner = _wrappers(), loop.make_steps

    def make_steps(*args, **kwargs):
        train_step, eval_step, predict_step = inner(*args, **kwargs)

        def counted(*a, **kw):
            for w in wrappers.values():
                w.launches = 0
            out = train_step(*a, **kw)
            record.append({n: w.launches for n, w in wrappers.items()})
            return out

        return counted, eval_step, predict_step

    loop.make_steps = make_steps
    try:
        yield
    finally:
        loop.make_steps = inner


def phase_trainer_input(root: str, pretrained: str, sample: dict, card: str) -> dict:
    """``gaviko_tpu_torch.cli.train`` (in this process) with gaviko.yaml
    switched as gaviko_tpu.yaml switches it: ``data.loader: grain`` on 2
    processes, ``train.device_augment``, ``train.precision: bf16``, starting
    from the converted vit-l16 timm file of phase ``weights``; 1 epoch on the
    synthetic volumes (B4), the second step profiled. Checks a CSV row a
    step, each train step's wrapped-kernel launches equal to
    ``gaviko_train_launches(spec, "bf16")``, and the frozen backbone equal
    to the converted tensors at the end."""
    import torch
    import yaml

    from gaviko_tpu_torch.cli import train as cli_train
    from gaviko_tpu_torch.models.factory import build_model

    t0 = time.perf_counter()
    cfg_path, config, folder = _trainer_files(root, 0)
    config["data"].update(loader="grain", grain_processes=2)
    config["model"]["pretrained_dir"] = pretrained
    config["train"].update(num_epochs=1, device_augment=True, precision="bf16",
                           save_dir=os.path.join(root, "weights_input"))
    config["utils"]["log_dir"] = os.path.join(root, "log_input")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    record = []
    with _count_train_steps(record):
        result = cli_train.main(["--config", cfg_path, "--method", "gaviko"])
    seconds = time.perf_counter() - t0
    spec = build_model(config["model"]).spec
    want = gaviko_train_launches(spec, "bf16")
    log_dir = config["utils"]["log_dir"]
    rows = _csv_rows(result["csv_log"])
    n_train, n_val = TRAINER_VOLUMES
    batch = config["data"]["batch_size"]
    n_steps = -(-n_train // batch)
    trace = _trace_stats(os.path.join(log_dir, "profile", "trace.json"))
    params = result["params"]
    start_kept = {k: bool(torch.equal(params[k].detach().cpu(), v)) for k, v in sample.items()}
    line = {"phase": "trainer_input", "loader": "grain", "grain_processes": 2,
            "device_augment": True, "precision": "bf16", "csv_rows": len(rows),
            "want_rows": n_steps + -(-n_val // batch), "train_steps": len(record),
            "step_launches": record, "want_launches": want, "profiled_step": trace,
            "start_from_timm": start_kept, "seconds": seconds, "card": card}
    print(json.dumps(line), flush=True)
    del result, params
    torch.cuda.empty_cache()
    if len(rows) != line["want_rows"] or len(record) != n_steps:
        raise RuntimeError(f"trainer_input: {len(rows)} CSV rows, {len(record)} train steps")
    if any(r != want for r in record):
        raise RuntimeError(f"trainer_input: launches {record}, want {want} a step")
    if not all(start_kept.values()):
        raise RuntimeError(f"trainer_input: frozen backbone moved from the timm file "
                           f"{start_kept}")
    return line


PAR_CONFIG = "gaviko_tpu_torch/configs/gaviko_tpu.yaml"
PAR_B = 8  # gaviko_tpu.yaml's global batch
PAR_VOLUMES = (24, 8)  # 3 steps and one eval batch at B8
# The 2-rank runs on cuda:0 (gloo): job -> (data, model) of the mesh. The
# train jobs: GAViKO data 2 + ZeRO and model 2; vit-b16 fft at depth 2 on
# model 2 (hybrid flag) and on data 2 + ZeRO with accumulation_steps 2
# (PAR_ACCUM_STEPS micro-steps: two updates); MeLO, SSF and AdaptFormer at
# vit-b16 widths and CUT_DEPTH layers on model 2. The serving job: GAViKO
# vit-l16 int8 at B8 on each mesh of PAR_INT8_MESHES.
PAR_MESH = {"gaviko_dp": (2, 1), "gaviko_tp": (1, 2), "vit_tp": (1, 2), "vit_accum": (2, 1),
            "melo_tp": (1, 2), "ssf_tp": (1, 2), "adaptformer_tp": (1, 2)}
PAR_ACCUM, PAR_ACCUM_STEPS = 2, 4
PAR_INT8_MESHES = ((2, 1), (1, 2))
# The mesh artifacts (deploy.py), B8 bf16, exported for cuda in this
# process and served by the 2 ranks: (model, mesh). GAViKO vit-l16 of
# gaviko.yaml; vit-b16 fft of vit.yaml (at 1 x 2 B6 on half the hidden
# columns, B9 on the heads' rows and B8 on a head shard in the CLS-fast
# last layer); AdaptFormer of its shipped config (its adapters whole on
# both ranks). PAR_HTTP's artifact is also served over HTTP. Rank 0's
# logits are held to the single-device bf16 logits by BF16_BUDGET
# (GAViKO) or SERVE_BUDGET: at 1 x 2 each split block's two partial
# outputs are rounded to bf16 before their sum, 24 sums a forward, and
# vit.yaml's random-init logits are small (mean |logit| 0.33). H100
# readings at 1 x 2: vit 1.82e-2 (1.77e-2 with the plain versions on both
# sides, 8.3e-7 in fp32: the sums' rounding, not the kernels),
# AdaptFormer 5.6e-3 (mean |logit| 1.27); vit at 2 x 1 2.4e-3.
PAR_ARTIFACT_MODELS = {"gaviko": (CONFIG, "gaviko"), "vit": (VIT_CONFIG, "fft"),
                       "adaptformer": ("gaviko_tpu_torch/configs/adaptformer.yaml",
                                       "adaptformer")}
PAR_ARTIFACTS = (("gaviko", (2, 1)), ("gaviko", (1, 2)), ("vit", (2, 1)), ("vit", (1, 2)),
                 ("adaptformer", (1, 2)))
PAR_HTTP = ("vit", (1, 2))
PAR_HTTP_SHIFT = np.arange(5, dtype=np.float32)  # the reload's shift of the head's bias
PAR_TIMEOUT_S = 600
# The worst leaf's own relative MAE of the 2-rank state against one rank's,
# by model (H100 readings, sound / planted fault, update, mu, nu). vit-b16:
# 8.0e-3, 1.2e-2, 9.1e-3 / 0.78, 0.74, 0.65 without the model sum of a split
# block's LN and bias gradients (the all-leaf MAE read 6.5e-3 there). GAViKO,
# whose prompt projections' small gradients sit near bf16's rounding: 0.29,
# 0.95, 0.21 / 6.9, 124, 4.3 with copy_in's backward not summed over model.
# The accumulating run and the zoo's are held to vit's, but AdaptFormer's
# mu: its adapters' up projections start at zero, so step 1 gives the
# adapter's LayerNorm and down projection no gradient and the next steps
# small ones, and the last layer's adapter sums them over the 8 pooled rows
# only (H100 readings: worst leaf 0.054, 0.25 (its last adapter's LN weight),
# 0.044, all-leaf mu 1.2e-2; MeLO 0.015, 0.037, 0.042; SSF 0.053, 0.017,
# 0.0071; vit_accum 0.011, 0.0079, 0.0082). AdaptFormer with copy_in's
# backward not summed over model (scripts/parallel_gate_faults.py
# adaptformer_tp): worst leaf 0.36, 0.37, 0.44, all-leaf 0.23, 0.15, 0.021,
# update cosine 0.80: its mu leaf budget passes that fault, which the
# update's and nu's leaf budgets and the all-leaf update and mu budgets
# (rel MAE 5e-2, cosine 0.99) catch.
PAR_LEAF_BUDGET = {"gaviko": {"params_update": 1.0, "mu": 10.0, "nu": 1.0},
                   **{m: {"params_update": 0.1, "mu": 0.1, "nu": 0.1}
                      for m in ("vit", "melo", "ssf")},
                   "adaptformer": {"params_update": 0.1, "mu": 1.0, "nu": 0.1}}
# The parallel runs whose B13 launches each B13 row of the kernels line carries.
PAR_ADAM_RUNS = {"fused_adam_gaviko": ("parallel_one", "gaviko_dp", "gaviko_tp"),
                 "fused_adam_vitb16": ("vit_tp", "vit_accum")}


def _tensorstore_version():
    """tensorstore's version where it imports (the orbax resume directory
    needs it), else None."""
    try:
        import tensorstore  # noqa: F401
    except ImportError:
        return None
    from importlib.metadata import PackageNotFoundError, version

    try:
        return version("tensorstore")
    except PackageNotFoundError:
        return "imported"


def phase_parallel_one(root: str, card: str) -> dict:
    """``cli.train`` (in this process) on gaviko_tpu.yaml: ``train.parallel``
    on (data auto, model 1, ZeRO), vit-l16 GAViKO in bf16 with
    ``train.device_augment``, the grain loader, B8, flops and memory
    logging; overridden: one epoch and the paths (a synthetic dataset of 24
    train and 8 val volumes). Where tensorstore imports, the config's
    ``checkpoint_backend: orbax`` runs as shipped: the run writes the resume
    directory ``experiments/gaviko/resume_state``, and a second ``cli.train``
    with ``--resume auto`` and two epochs resumes from it and trains epoch 2
    only. Without tensorstore the option must refuse naming it, and the run
    takes ``checkpoint_backend: npz``. One process is a 1 x 1 mesh: every
    train step must be ``ParallelTrainer.train_step`` (none from
    ``make_steps``), with exactly ``gaviko_train_launches(spec, "bf16")`` a
    step."""
    import torch
    import yaml

    from gaviko_tpu_torch.cli import train as cli_train
    from gaviko_tpu_torch.config import load_config
    from gaviko_tpu_torch.models.factory import build_model
    from gaviko_tpu_torch.parallel import mesh as pmesh
    from gaviko_tpu_torch.train import loop
    from gaviko_tpu_torch.train.fused_optim import init
    from gaviko_tpu_torch.utils.checkpoint import save_train_state_orbax

    t0 = time.perf_counter()
    _, _, folder = _trainer_files(root, 1, PAR_VOLUMES)
    config = load_config(PAR_CONFIG)
    orbax = _tensorstore_version() is not None
    overrides = {"train.num_epochs": 1}
    refusal = None
    if not orbax:
        try:
            save_train_state_orbax(os.path.join(root, "refused"), {}, init({}), {})
        except ImportError as e:
            refusal = str(e)
        if not refusal or "tensorstore" not in refusal or os.path.exists(
                os.path.join(root, "refused")):
            raise RuntimeError(f"parallel_one: without tensorstore the orbax backend must "
                               f"refuse and write nothing, got {refusal!r}")
        overrides["train.checkpoint_backend"] = "npz"
        config["train"]["checkpoint_backend"] = "npz"
    config["train"].update(num_epochs=1, save_dir=os.path.join(root, "weights_par"))
    labels = os.path.join(root, "labels.csv")
    config["data"].update(data_path=labels, image_folder=folder, test_data=labels)
    config["utils"].update(log_dir=os.path.join(root, "log_par"),
                           results_dir=os.path.join(root, "outputs_par"))
    print(json.dumps({"phase": "parallel_one_config", "config": PAR_CONFIG,
                      "checkpoint_backend": config["train"]["checkpoint_backend"],
                      "tensorstore": _tensorstore_version(), "orbax_refusal": refusal,
                      "overrides": overrides, "paths": "a temporary directory",
                      "train.parallel": config["train"]["parallel"]}), flush=True)
    cfg_path = os.path.join(root, "gaviko_tpu.yaml")
    wrappers, record, made = _wrappers(), [], []
    inner_step, inner_make = pmesh.ParallelTrainer.train_step, loop.make_steps

    def counted(self, *a, **kw):
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_step(self, *a, **kw)
        torch.cuda.synchronize()
        record.append({"seconds": time.perf_counter() - t,
                       "launches": {n: w.launches for n, w in wrappers.items()}})
        return out

    def make_steps(*a, **kw):
        made.append(1)
        return inner_make(*a, **kw)

    def run(epochs: int, *flags):
        config["train"]["num_epochs"] = epochs
        with open(cfg_path, "w") as f:
            yaml.safe_dump(config, f)
        record.clear()
        pmesh.ParallelTrainer.train_step, loop.make_steps = counted, make_steps
        try:
            return cli_train.main(["--config", cfg_path, "--method", "gaviko", *flags])
        finally:
            pmesh.ParallelTrainer.train_step, loop.make_steps = inner_step, inner_make

    result = run(1)
    first = list(record)
    spec = build_model(config["model"]).spec
    want = gaviko_train_launches(spec, "bf16")
    rows = _csv_rows(result["csv_log"])
    resume = os.path.join(config["train"]["save_dir"], "experiments", "gaviko",
                          "resume_state" if orbax else "resume_state.npz")
    line = {"phase": "parallel_one", "mesh": "1 x 1", "train_steps": len(first),
            "make_steps_calls": len(made), "csv_rows": len(rows),
            "step_seconds": [r["seconds"] for r in first],
            "step_launches": [r["launches"] for r in first], "want_launches": want,
            "checkpoint_backend": config["train"]["checkpoint_backend"],
            "resume_state": os.path.isdir(resume) if orbax else os.path.isfile(resume),
            "best_checkpoint": bool(result["best_ckpt_path"]),
            "seconds": time.perf_counter() - t0, "card": card}
    del result
    n_steps = -(-PAR_VOLUMES[0] // PAR_B)
    if orbax and line["resume_state"]:
        t = time.perf_counter()
        resumed = run(2, "--resume", "auto")
        line["resumed"] = {"train_steps": len(record), "csv_rows": len(_csv_rows(
            resumed["csv_log"])), "step_launches": [r["launches"] for r in record],
            "seconds": time.perf_counter() - t}
        del resumed
    print(json.dumps(line), flush=True)
    torch.cuda.empty_cache()
    if len(first) != n_steps or made:
        raise RuntimeError(f"parallel_one: {len(first)} parallel steps, make_steps called "
                           f"{len(made)} times")
    if any(r["launches"] != want for r in first):
        raise RuntimeError(f"parallel_one: launches {first}, want {want} a step")
    if len(rows) != n_steps + 1 or not line["resume_state"] or not line["best_checkpoint"]:
        raise RuntimeError(f"parallel_one: {len(rows)} CSV rows, resume state "
                           f"{line['resume_state']}, best {line['best_checkpoint']}")
    if orbax:
        r = line["resumed"]
        if (r["train_steps"] != n_steps or r["csv_rows"] != n_steps + 1
                or any(c != want for c in r["step_launches"])):
            raise RuntimeError(f"parallel_one: the resume from {resume} ran {r}, want epoch 2 "
                               f"only ({n_steps} steps of {want})")
    return line


def _par_setup(job: str):
    """(config, model, params, batches, per-step seeds, launches a step) of
    a parallel train job: GAViKO vit-l16 of gaviko_tpu.yaml (frozen
    backbone, B8 raw volumes for the device augmentation); vit.yaml's fft
    at depth 2 (B8; PAR_ACCUM_STEPS batches for ``vit_accum``); a zoo
    method's shipped config at CUT_DEPTH (B8). Random init from seed 0 on
    the card, the same in every process."""
    import dataclasses

    import torch

    from gaviko_tpu_torch.models.factory import build_model

    method = job.split("_")[0]
    n_batches = PAR_ACCUM_STEPS if job == "vit_accum" else TRAIN_STEPS
    if method == "gaviko":
        config = _config(PAR_CONFIG, "gaviko")
        model = build_model(config["model"])
        n_seeds, launches = 2 * model.spec.depth, gaviko_train_launches
    elif method == "vit":
        config = _config(VIT_CONFIG, "fft")
        model = build_model(config["model"])
        model = dataclasses.replace(model, spec=dataclasses.replace(model.spec, depth=2))
        n_seeds, launches = 1 + 3 * (model.spec.depth - 1) + 4, vit_train_launches
        if job == "vit_accum":
            config["train"]["accumulation_steps"] = PAR_ACCUM
    else:
        zoo_config, over = next((c, o) for m, c, o in ZOO if m == method)
        config = _config(zoo_config, method, over)
        model = build_model(config["model"])
        model = dataclasses.replace(model, spec=dataclasses.replace(model.spec, depth=CUT_DEPTH))
        n_seeds = (1 + 3 * (CUT_DEPTH - 1) + 4) if method == "melo" else 0

        def launches(spec, precision):
            return zoo_launches(spec, _dtype(precision), True)
    params = {k: v.to("cuda") for k, v in
              model.init(torch.Generator().manual_seed(0), model.spec).items()}
    return (config, model, params, _batches(PAR_B, 5, n_batches),
            _step_seeds(n_seeds, n_batches), launches)


def _timed_collectives(spent: list) -> None:
    """Add the seconds of every all_reduce and broadcast (the card synced
    before and after each) to ``spent[0]``: gloo's, through the host."""
    import torch
    import torch.distributed as dist

    def timed(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            return out

        return call

    dist.all_reduce, dist.broadcast = timed(dist.all_reduce), timed(dist.broadcast)


def _par_want(want: dict, step: int, accum: int) -> dict:
    """A micro-step's launches: B13 runs on every ``accum``-th only."""
    return {**want, "fused_adam": want["fused_adam"] * ((step + 1) % accum == 0)}


def _cpu_state(trainable, opt) -> tuple:
    """(trainable, optimizer state) on the CPU, in the state's own layout
    (``FusedAdamState`` or, accumulating, ``MultiStepState``)."""
    from gaviko_tpu_torch.train.fused_optim import FusedAdamState, MultiStepState

    def cpu(d):
        return {k: v.cpu() for k, v in d.items()}

    if isinstance(opt, MultiStepState):
        inner = opt.inner
        opt = MultiStepState(opt.mini_step, opt.gradient_step,
                             FusedAdamState(inner.count, cpu(inner.mu), cpu(inner.nu)),
                             cpu(opt.acc))
    else:
        opt = FusedAdamState(opt.count, cpu(opt.mu), cpu(opt.nu))
    return cpu(trainable), opt


def _par_run(job: str, world: int) -> dict:
    """The batches of ``job`` (bf16 train steps; micro-steps for
    ``vit_accum``) and one eval step: on one process through
    ``make_steps``, or as this rank of a ``PAR_MESH[job]`` mesh through
    ``ParallelTrainer`` (its rows of each global batch, the global batch's
    augmentation draws). Returns the losses, each step's seconds, collective
    seconds and kernel launches (counts set to 0 just before a step, read
    just after), the eval's launches, and on rank 0 the whole resume state
    on the CPU."""
    import torch
    import torch.distributed as dist

    from gaviko_tpu_torch.core.layers import SeedStream
    from gaviko_tpu_torch.parallel.mesh import ParallelTrainer, make_mesh
    from gaviko_tpu_torch.train import loop
    from gaviko_tpu_torch.train.losses import make_criterion

    config, model, params, batches, seeds, launches = _par_setup(job)
    train_cfg = {**config["train"], "precision": "bf16"}
    criterion = make_criterion(train_cfg)
    fused = loop.make_optimizer(train_cfg, TRAIN_TOTAL_STEPS)
    cdt = loop.compute_dtype_of(train_cfg)
    augment_on = bool(train_cfg.get("device_augment"))
    trainable, frozen = loop.split_params(model, params)
    want = launches(model.spec, "bf16")
    out = {"want_launches": [_par_want(want, i, fused["accum"]) for i in range(len(batches))],
           "start": {k: v.cpu() for k, v in trainable.items()}}
    draws = loop.default_step_augment(0)
    if world == 1:
        step, eval_step, _ = loop.make_steps(model, criterion, fused, cdt, augment_on)
        opt, rank, rows = loop.init_opt_state(trainable, fused), 0, slice(None)
    else:
        mesh = make_mesh(*PAR_MESH[job])
        par = ParallelTrainer(model, criterion, fused, mesh, trainable, frozen,
                              compute_dtype=cdt, device_augment=augment_on)
        step, eval_step = par.train_step, par.eval_step
        trainable, frozen, opt, rank = par.trainable, par.frozen, par.opt_state, mesh.rank
        per = PAR_B // mesh.data
        rows = slice(mesh.d * per, (mesh.d + 1) * per)
    spent, wrappers = [0.0], _wrappers()
    if world > 1:
        _timed_collectives(spent)
    out.update(losses=[], step_s=[], collective_s=[], launches=[])
    for i, ((x, y), s) in enumerate(zip(batches, seeds)):
        for w in wrappers.values():
            w.launches = 0
        spent[0] = 0.0
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainable, opt, loss, _ = step(trainable, opt, frozen, x[rows], y[rows], SeedStream(s),
                                       draws(i, PAR_B) if augment_on else None)
        loss = float(loss)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t)
        out["collective_s"].append(spent[0])
        out["losses"].append(loss)
        out["launches"].append({n: w.launches for n, w in wrappers.items()})
    for w in wrappers.values():
        w.launches = 0
    eval_loss, _, logits = eval_step(trainable, frozen, *(t[rows] for t in batches[0]))
    out["eval_loss"], out["eval_launches"] = float(eval_loss), {
        n: w.launches for n, w in wrappers.items()}
    out["eval_logits"] = logits.float().cpu()
    if world > 1:
        trainable, opt = par.gather_state(trainable, opt)
    if rank == 0:
        out["state"] = _cpu_state(trainable, opt)
    if world > 1:
        dist.barrier()
    return out


def _par_serve(world: int) -> dict:
    """GAViKO vit-l16 int8 serving (gaviko.yaml, ``quantize="int8"``, B8
    bf16) on each mesh of PAR_INT8_MESHES: every rank quantizes the whole
    weights and builds the Predictor; rank 0 predicts the first B of the
    serving phases' volumes, the other rank follows. Each rank's launches
    of that one forward (counts set to 0 just before, read just after), its
    seconds, and on rank 0 the logits."""
    import torch
    import torch.distributed as dist

    from gaviko_tpu_torch.serving import Predictor

    rng = np.random.RandomState(0)  # main()'s serving volumes
    vols = [rng.rand(120, 160, 160).astype(np.float32) for _ in range(B)]
    out, wrappers = {}, _wrappers()
    for shape in PAR_INT8_MESHES:
        t0 = time.perf_counter()
        pred = Predictor(_config(CONFIG, "gaviko"), batch_size=B, dtype="bfloat16",
                         pretrained_dir=None, quantize="int8", mesh_shape=shape,
                         device="cuda:0")
        built = time.perf_counter() - t0
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        if pred.mesh.rank == 0:
            logits = pred.predict_logits(vols)
            pred.close()
        else:
            logits = None
            pred.follow()
        torch.cuda.synchronize()
        out["x".join(map(str, shape))] = {
            "logits": logits, "launches": {n: w.launches for n, w in wrappers.items()},
            "predictor_s": built, "predict_s": time.perf_counter() - t}
        del pred
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def _mesh_name(model: str, shape) -> str:
    return f"{model}_{shape[0]}x{shape[1]}"


def _mesh_artifact_path(root: str, model: str, shape) -> str:
    return os.path.join(root, f"mesh_{_mesh_name(model, shape)}.gaviko")


def _lead_or_follow(pred, vols):
    """Rank 0: ``predict_logits(vols)`` and release the other ranks -> the
    logits; a following rank: follow until then -> None."""
    if pred.mesh.rank == 0:
        logits = pred.predict_logits(vols)
        pred.close()
        return logits
    pred.follow()
    return None


def _par_http(pred, vols, root: str) -> dict:
    """``serving.serve`` over the mesh predictor ``pred`` on rank 0, the other
    rank following: ``predict_logits`` of ``vols``, then each volume POSTed
    to /predict, ``B`` at a time, GET /healthz and /metrics, POST /reload of
    a checkpoint that shifts the head's bias by PAR_HTTP_SHIFT and one more
    POST of the first volume. Each rank's launches over the whole round
    (counts set to 0 just before, read just after); on rank 0 the logits,
    the answers and the seconds of the POSTs."""
    import torch

    from gaviko_tpu_torch.serving import serve

    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = {}
    if pred.mesh.rank != 0:
        pred.follow()
    else:
        out["direct"] = pred.predict_logits(vols)
        server = serve(pred, host="127.0.0.1", port=0)
        url = f"http://127.0.0.1:{server.server_address[1]}"
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()

        def call(path, body=None):
            req = urllib.request.Request(f"{url}{path}", data=body,
                                         method="GET" if body is None else "POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                return json.load(r)

        try:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=B) as ex:
                answers = list(ex.map(lambda v: call("/predict", _npz(v)), vols))
            out["post_s"] = time.perf_counter() - t0
            out["http"] = np.asarray([a["logits"] for a in answers], np.float32)
            out["classes"] = np.asarray([a["class"] for a in answers])
            out["healthz"], out["metrics"] = call("/healthz"), call("/metrics")
            key = "mlp_head.bias"
            ckpt = os.path.join(root, "http_reload.pt")
            torch.save({key: pred.params[key].float() + torch.from_numpy(PAR_HTTP_SHIFT)}, ckpt)
            out["reload"] = call("/reload", json.dumps({"checkpoint": ckpt}).encode())
            out["reloaded"] = np.float32(call("/predict", _npz(vols[0]))["logits"])
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
            pred.close()
    torch.cuda.synchronize()
    out["launches"] = {n: w.launches for n, w in wrappers.items()}
    return out


def _par_mesh_artifact(world: int, root: str, artifacts) -> dict:
    """The mesh artifacts, (model, shape) each, that ``phase_parallel_two``
    exported into ``root`` (B8 bf16, cuda): every rank loads the artifact
    (``DeployedPredictor``) and builds the live ``Predictor(mesh_shape=...)``
    of the same config (seed 0, the artifact's weights); rank 0 predicts
    the first B of the serving phases' volumes once with each, the other
    rank follows. Each rank's launches and collectives of those forwards
    (counts set to 0 just before, read just after), then ``predict_logits``
    seconds in turns (live, artifact, artifact, live), and on rank 0 both
    logits and whether the artifact's last turn gave its first logits bit
    for bit. GAViKO at TP2: the collective op's fake against its result on
    the card, and its refusal with no group bound. PAR_HTTP's artifact:
    rank 0's kernel ops of its first forward through ``_opcheck``,
    then ``_par_http`` on all 16 of the volumes."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from gaviko_tpu_torch.deploy import DeployedPredictor
    from gaviko_tpu_torch.ops import library
    from gaviko_tpu_torch.serving import Predictor

    rng = np.random.RandomState(0)  # main()'s serving volumes
    vols = [rng.rand(120, 160, 160).astype(np.float32) for _ in range(N_REQUESTS)]
    out, wrappers = {}, _wrappers()

    def counted(pred, record=None):
        for w in wrappers.values():
            w.launches = 0
        calls = library.model_all_reduces
        torch.cuda.synchronize()
        t = time.perf_counter()
        with record if record is not None else contextlib.nullcontext():
            logits = _lead_or_follow(pred, vols[:B])
        torch.cuda.synchronize()
        return (logits, {n: w.launches for n, w in wrappers.items()},
                library.model_all_reduces - calls, time.perf_counter() - t)

    def timed(pred):
        t = time.perf_counter()
        logits = _lead_or_follow(pred, vols[:B])
        torch.cuda.synchronize()
        return time.perf_counter() - t, logits

    for model, shape in artifacts:
        t0 = time.perf_counter()
        dep = DeployedPredictor(_mesh_artifact_path(root, model, shape), device="cuda:0")
        torch.cuda.synchronize()
        res = {"load_s": time.perf_counter() - t0, "m": dep.mesh.m}
        live = Predictor(_config(*PAR_ARTIFACT_MODELS[model]), batch_size=B, dtype="bfloat16",
                         pretrained_dir=None, mesh_shape=shape, device="cuda:0")
        op_args = {}
        record = (_record_op_args(op_args) if (model, shape) == PAR_HTTP and dep.mesh.rank == 0
                  else None)
        res["logits"], res["launches"], res["collectives"], res["first_s"] = counted(dep, record)
        if record is not None:  # the fakes at a head shard and a hidden slice; the
            # collective needs the other rank
            res["opcheck"] = _opcheck({k: c for k, c in op_args.items()
                                       if k != "model_all_reduce"})
        res["live_logits"], res["live_launches"], _, res["live_first_s"] = counted(live)
        turns = [timed(p) for p in (live, dep, dep, live)]
        res["live_predict_s"], res["predict_s"] = [t[0] for t in turns[::3]], [
            t[0] for t in turns[1:3]]
        if dep.mesh.rank == 0:
            res["rerun_equal"] = bool(np.array_equal(turns[2][1], res["logits"]))
        if model == "gaviko" and dep.mesh.model > 1:
            gen = torch.Generator(device="cuda:0").manual_seed(0)  # one x on both ranks
            x = torch.randn(B, 1040, 1024, generator=gen, device="cuda:0").bfloat16()
            op = torch.ops.gaviko.model_all_reduce.default
            try:
                op(x)
                res["op_refused_unbound"] = False
            except RuntimeError:
                res["op_refused_unbound"] = True
            with library.bound_model_group(dep.mesh.model_group):
                real = op(x)
            with FakeTensorMode() as mode:
                fake = op(mode.from_tensor(x))
            res["op_fake_matches"] = (fake.shape == real.shape and fake.dtype == real.dtype
                                      and fake.stride() == real.stride()
                                      and fake.device == real.device)
            res["op_sums"] = bool(torch.equal(real, x + x))
        if (model, shape) == PAR_HTTP:
            res["http"] = _par_http(dep, vols, root)
        out[_mesh_name(model, shape)] = res
        del dep, live
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def _par_rank(rank: int, world: int, out_dir: str, jobs, artifacts) -> None:
    """A spawned rank: joins the gloo group on cuda:0 and runs each job of
    ``jobs`` in turn (``_par_run``, vit_tp with GAVIKO_LNQKV_HYBRID=1;
    ``int8_serve``: ``_par_serve``; ``mesh_artifact``: ``_par_mesh_artifact``
    on ``artifacts``, exported into ``out_dir``'s parent), saving {job:
    result}."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", world_size=world,
                            rank=rank)
    try:
        out = {}
        for job in jobs:
            t0 = time.perf_counter()
            with _lnqkv_hybrid(job == "vit_tp"):
                if job == "mesh_artifact":
                    out[job] = _par_mesh_artifact(world, os.path.dirname(out_dir), artifacts)
                else:
                    out[job] = (_par_serve(world) if job == "int8_serve"
                                else _par_run(job, world))
            out[job]["seconds"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn_ranks(jobs, world: int, out_dir: str, artifacts=()) -> list:
    """``world`` ranks running ``jobs`` (``artifacts``: the (model, shape) of
    each mesh artifact the ``mesh_artifact`` job serves), joined within
    PAR_TIMEOUT_S; a rank that dies or hangs fails the phase (the others are
    killed)."""
    import torch
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(_par_rank, args=(world, out_dir, list(jobs), list(artifacts)),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + PAR_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
            if time.monotonic() > deadline:
                raise RuntimeError(f"parallel {jobs}: the ranks outlasted {PAR_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _shift_invariant(job: str, params) -> dict:
    """name -> the elements of that trainable tensor whose gradient is zero
    in exact arithmetic, for ``job``: SSF's shift of the keys (the middle
    third of every attention's ``ssf_shift_1``) adds one vector to every
    key, which the softmax ignores. What the backward leaves there is
    rounding, which Adam scales to a full step of either sign, in either
    run alike; those elements are left out of the update's comparison
    (H100 reading with them: update rel MAE 0.069, cosine 0.957, worst leaf
    a ``ssf_shift_1`` at 0.37, while mu and nu agreed to 1.0e-2 and
    4.4e-3)."""
    if not job.startswith("ssf"):
        return {}
    out = {}
    for k, v in params.items():
        if k.endswith(".0.ssf_shift_1"):
            third = v.shape[0] // 3
            mask = np.zeros(v.shape[0], bool)
            mask[third:2 * third] = True
            out[k] = mask
    return out


def _state_diff(got, want, start, skip=None) -> dict:
    """The 2-rank resume state against the 1-rank one: same keys, shapes and
    dtypes; for the params (their update from ``start``; the elements of
    ``skip`` left out, see ``_shift_invariant``), mu and nu (and,
    accumulating, the running mean ``acc``), the relative MAE and cosine
    over every leaf together, and the worst leaf's own relative MAE (and its
    name)."""
    import torch

    from gaviko_tpu_torch.train.fused_optim import MultiStepState

    (gp, gopt), (wp, wopt) = got, want
    if type(gopt) is not type(wopt):
        raise RuntimeError(f"parallel: a {type(gopt).__name__} against a "
                           f"{type(wopt).__name__}")
    multi = isinstance(wopt, MultiStepState)
    gin, win = (gopt.inner, wopt.inner) if multi else (gopt, wopt)
    if set(gp) != set(wp) or any(gp[k].shape != wp[k].shape or gp[k].dtype != wp[k].dtype
                                 for k in wp) or gin.count != win.count or (multi and (
            gopt.mini_step, gopt.gradient_step) != (wopt.mini_step, wopt.gradient_step)):
        raise RuntimeError("parallel: the gathered resume state differs in its leaves")
    out = {}
    skip = skip or {}

    def update(p):
        return {k: (p[k] - start[k])[~torch.from_numpy(skip[k])] if k in skip else
                p[k] - start[k] for k in wp}

    terms = [("params_update", update(gp), update(wp)), ("mu", gin.mu, win.mu),
             ("nu", gin.nu, win.nu)]
    if multi and any(float(a.abs().max()) > 0 for a in wopt.acc.values()):
        terms.append(("acc", gopt.acc, wopt.acc))
    for name, g, w in terms:
        a = np.concatenate([g[k].double().flatten().numpy() for k in sorted(w)])
        b = np.concatenate([w[k].double().flatten().numpy() for k in sorted(w)])
        scale = float(np.abs(b).mean())
        leaf = {k: _rel_mae(g[k], w[k]) for k in w}
        worst = max(leaf, key=leaf.get)
        out[name] = {"rel_mae": float(np.abs(a - b).mean()) / scale,
                     "cosine": float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))),
                     "worst_leaf": leaf[worst], "worst_leaf_name": worst}
    return out


def phase_parallel_two(root: str, card: str, int8_served: Optional[np.ndarray] = None,
                       artifact_refs: Optional[dict] = None) -> dict:
    """2 ranks spawned on cuda:0 over gloo (NCCL refuses two ranks on one
    card), one spawn for every job of PAR_MESH and the int8 serving job.
    Train jobs: GAViKO vit-l16 of gaviko_tpu.yaml with data 2 and ZeRO, then
    data 1 x model 2 (the frozen backbone's heads and hidden split);
    vit.yaml fft at depth 2 with model 2 and GAVIKO_LNQKV_HYBRID=1 (B6, B7,
    B9, B12 and B8 on their shards), and with data 2, ZeRO and
    accumulation_steps 2 (four micro-steps: B13 on the ZeRO slices of the
    running mean at the second and fourth); MeLO (its LoRA-merged qkv whole
    on both ranks), SSF (ssf_1 split with the qkv rows) and AdaptFormer at
    vit-b16 widths and CUT_DEPTH with model 2. Each runs its bf16 steps and
    an eval step from the seeds and batches of a 1-rank run of the same
    global batch (``make_steps``, run first, alone on the card), held to it
    under the bf16 train-check budgets: per-step loss, the update of the
    trainable tensors and the whole resume state gathered by the ranks
    (rank 0 writes it; the same leaves as the 1-rank state), over all
    leaves and leaf by leaf (PAR_LEAF_BUDGET), and the eval step's logits
    and loss. Each step's launches on each rank are the 1-rank step's.
    The serving job (given ``int8_served``): GAViKO vit-l16 int8 at B8 on
    data 2 and on model 2 (the int8 blocks whole on both ranks), rank 0's
    logits against the 1-rank int8 Predictor's ``int8_served``
    (INT8_PLAIN_BUDGET), each rank's launches of one forward
    ``serving_launches(spec, True)``.
    The mesh artifact job (given ``artifact_refs``: each model of
    PAR_ARTIFACT_MODELS -> single-device logits of the first B volumes,
    GAViKO's from phase 22's artifact, vit-b16's and AdaptFormer's from
    their served bf16 Predictors): each artifact of PAR_ARTIFACTS exported
    for cuda here at B8 bf16 (one program a model rank), served by both
    ranks: rank 0's logits bit-equal to the live
    ``Predictor(mesh_shape=...)``'s on the same volumes and on a rerun, and
    within BF16_BUDGET (GAViKO) or SERVE_BUDGET of the model's reference;
    each rank's launches of one forward the live mesh forward's,
    ``serving_launches(spec)`` (``zoo_launches`` for AdaptFormer); each
    model rank's program calling those ops and the collective as often as
    the rank ran them. PAR_HTTP's artifact then serves 16 volumes over
    HTTP, B at a time: the logits equal ``predict_logits``'s, /healthz
    answers ok, /reload answers reloaded and moves the logits by the
    bias's shift, and each rank launches each kernel that many forwards'
    worth.
    Prints the wall and collective seconds a step: gloo through the host,
    not an NCCL figure."""
    import torch

    from gaviko_tpu_torch.models.factory import build_model
    from gaviko_tpu_torch.utils.checkpoint import save_train_state

    loss_budget, _, grad_budget, cos_floor = TRAIN_BUDGET["bf16"]
    lines, ones = {}, {}
    t0 = time.perf_counter()
    for job in PAR_MESH:
        t = time.perf_counter()
        with _lnqkv_hybrid(job == "vit_tp"):
            ones[job] = _par_run(job, 1)
        ones[job]["seconds"] = time.perf_counter() - t
        torch.cuda.empty_cache()
    exports = {}
    if artifact_refs is not None:
        from gaviko_tpu_torch.deploy import export_artifact

        for model, shape in PAR_ARTIFACTS:
            t = time.perf_counter()
            path = _mesh_artifact_path(root, model, shape)
            meta = export_artifact(_config(*PAR_ARTIFACT_MODELS[model]), path, batch_size=B,
                                   dtype="bfloat16", pretrained_dir=None, platforms=("cuda",),
                                   mesh_shape=shape)
            exports[(model, shape)] = {
                "export_s": time.perf_counter() - t, "artifact_mb": os.path.getsize(path) / 1e6,
                "ops": meta["ops"]["cuda"], "placements": len(meta["placements"])}
    t_two = time.perf_counter()
    jobs = [*PAR_MESH, *(["int8_serve"] if int8_served is not None else []),
            *(["mesh_artifact"] if artifact_refs is not None else [])]
    ranks = _spawn_ranks(jobs, 2, os.path.join(root, "two"), exports)
    print(json.dumps({"phase": "parallel_two_spawn", "jobs": jobs,
                      "one_rank_seconds": t_two - t0,
                      "two_rank_seconds": time.perf_counter() - t_two,
                      "job_seconds": {f"rank{r}": {j: res[j]["seconds"] for j in res}
                                      for r, res in enumerate(ranks)}, "card": card}),
          flush=True)
    for job in PAR_MESH:
        one, two = ones[job], ranks[0][job]
        start, want_launches = one["start"], one["want_launches"]
        for name, res in (("one", one), ("two", two)):
            save_train_state(os.path.join(root, f"{job}_{name}.npz"), *res["state"],
                             meta={"epoch": 1, "global_step": len(res["losses"])})
        with np.load(os.path.join(root, f"{job}_one.npz")) as a, \
                np.load(os.path.join(root, f"{job}_two.npz")) as b:
            same_files = (sorted(a.files) == sorted(b.files)
                          and all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                                  for k in a.files))
        skip = _shift_invariant(job, start)
        diff = _state_diff(two["state"], one["state"], start, skip)
        loss_rel = [abs(x - w) / abs(w) for x, w in zip(two["losses"], one["losses"])]
        eval_rel = abs(two["eval_loss"] - one["eval_loss"]) / abs(one["eval_loss"])
        logits_rel = _rel_mae(two["eval_logits"], one["eval_logits"])
        leaf_budget = PAR_LEAF_BUDGET[job.split("_")[0]]
        line = {"phase": "parallel_two", "job": job, "mesh": "x".join(map(str, PAR_MESH[job])),
                "backend": "gloo, both ranks on cuda:0 (collectives through the host; not "
                           "an NCCL figure)",
                "losses": two["losses"], "one_rank_losses": one["losses"],
                "loss_rel": loss_rel, "eval_loss": two["eval_loss"],
                "one_rank_eval_loss": one["eval_loss"], "eval_loss_rel": eval_rel,
                "eval_logits_rel_mae": logits_rel,
                "state": diff, "resume_files_same_leaves": same_files,
                "update_elements_left_out": {k: int(m.sum()) for k, m in skip.items()},
                "state_layout": type(two["state"][1]).__name__,
                "step_s": {f"rank{r}": res[job]["step_s"] for r, res in enumerate(ranks)},
                "collective_s": {f"rank{r}": res[job]["collective_s"]
                                 for r, res in enumerate(ranks)},
                "one_rank_step_s": one["step_s"],
                "launches": {f"rank{r}": res[job]["launches"][-1]
                             for r, res in enumerate(ranks)},
                "eval_launches": {f"rank{r}": res[job]["eval_launches"]
                                  for r, res in enumerate(ranks)},
                "seconds": {"one_rank": one["seconds"],
                            **{f"rank{r}": res[job]["seconds"] for r, res in enumerate(ranks)}},
                "card": card,
                "budget": {"loss_rel": loss_budget, "rel_mae": grad_budget,
                           "cosine": cos_floor, "eval_logits_rel_mae": BF16_BUDGET,
                           "worst_leaf": leaf_budget}}
        print(json.dumps(line), flush=True)
        for r, res in enumerate(ranks):
            if res[job]["launches"] != want_launches or one["launches"] != want_launches:
                raise RuntimeError(f"parallel {job}: rank {r} launches {res[job]['launches']}, "
                                   f"one rank {one['launches']}, want {want_launches}")
            if res[job]["eval_launches"] != one["eval_launches"]:
                raise RuntimeError(f"parallel {job}: rank {r} eval launches "
                                   f"{res[job]['eval_launches']}, one rank "
                                   f"{one['eval_launches']}")
        if max(loss_rel) > loss_budget or not same_files:
            raise RuntimeError(f"parallel {job}: loss rel {loss_rel}, same leaves {same_files}")
        if not (eval_rel <= loss_budget and logits_rel <= BF16_BUDGET):
            raise RuntimeError(f"parallel {job}: eval loss rel {eval_rel}, logits rel MAE "
                               f"{logits_rel} outside the bf16 budget")
        for name, d in diff.items():
            if not (d["rel_mae"] <= grad_budget and d["cosine"] >= cos_floor
                    and d["worst_leaf"] <= leaf_budget.get(name, leaf_budget["mu"])):
                raise RuntimeError(f"parallel {job}: {name} {d} outside the bf16 budget")
        lines[job] = line
        if job == "gaviko_dp":
            lines["gaviko_trainable_shapes"] = [tuple(v.shape) for v in start.values()]
    spec = build_model(_config(CONFIG, "gaviko")["model"]).spec
    if int8_served is not None:
        want = serving_launches(spec, quantized=True)
        for mesh in ("x".join(map(str, shape)) for shape in PAR_INT8_MESHES):
            res = ranks[0]["int8_serve"][mesh]
            rel = _rel_mae_np(res["logits"], int8_served)
            line = {"phase": "parallel_int8_serving", "mesh": mesh, "batch": B,
                    "dtype": "bfloat16", "rel_mae_vs_one_rank": rel, "budget": INT8_PLAIN_BUDGET,
                    "argmax_agreement": float((res["logits"].argmax(-1)
                                               == int8_served.argmax(-1)).mean()),
                    "launches": {f"rank{r}": rr["int8_serve"][mesh]["launches"]
                                 for r, rr in enumerate(ranks)}, "want_launches": want,
                    "predictor_s": {f"rank{r}": rr["int8_serve"][mesh]["predictor_s"]
                                    for r, rr in enumerate(ranks)},
                    "predict_s": res["predict_s"], "card": card}
            print(json.dumps(line), flush=True)
            if any(c != want for c in line["launches"].values()):
                raise RuntimeError(f"parallel int8 {mesh}: launches {line['launches']}, "
                                   f"want {want}")
            if not (res["logits"].shape == int8_served.shape and np.isfinite(res["logits"]).all()
                    and rel <= INT8_PLAIN_BUDGET):
                raise RuntimeError(f"parallel int8 {mesh}: logits rel MAE {rel} against one rank")
            lines[f"int8_{mesh}"] = line
    if artifact_refs is None:
        return lines
    for (model, shape), exported in exports.items():
        mesh = _mesh_name(model, shape)
        spec = build_model(_config(*PAR_ARTIFACT_MODELS[model])["model"]).spec
        want_plain = (zoo_launches(spec, torch.bfloat16, False) if model == "adaptformer"
                      else serving_launches(spec))
        budget = BF16_BUDGET if model == "gaviko" else SERVE_BUDGET
        ref = artifact_refs[model]
        res = {f"rank{r}": rr["mesh_artifact"][mesh] for r, rr in enumerate(ranks)}
        r0 = res["rank0"]
        bit_equal = bool(np.array_equal(r0["logits"], r0["live_logits"]))
        rel = _rel_mae_np(r0["logits"], ref)
        ops_match = {}
        for r, rr in res.items():
            calls = {f"gaviko::{n}": c for n, c in rr["launches"].items() if c}
            if rr["collectives"]:
                calls["gaviko::model_all_reduce"] = rr["collectives"]
            ops_match[r] = calls == exported["ops"][rr["m"]]
        line = {"phase": "parallel_mesh_artifact", "model": model, "mesh": "x".join(
                    map(str, shape)), "batch": B, "dtype": "bfloat16", "platform": "cuda",
                "backend": "gloo, both ranks on cuda:0 (collectives through the host; not "
                           "an NCCL figure)",
                **exported, "load_s": {r: rr["load_s"] for r, rr in res.items()},
                "predict_s": r0["predict_s"], "live_predict_s": r0["live_predict_s"],
                "first_s": r0["first_s"], "live_first_s": r0["live_first_s"],
                "bit_equal_to_live": bit_equal, "rerun_bit_equal": r0["rerun_equal"],
                "rel_mae_vs_single_device": rel, "budget": budget,
                "launches": {r: rr["launches"] for r, rr in res.items()},
                "live_launches": {r: rr["live_launches"] for r, rr in res.items()},
                "want_launches": want_plain,
                "collectives": {r: rr["collectives"] for r, rr in res.items()},
                "ops_match_launches": ops_match,
                **{k: {r: rr[k] for r, rr in res.items()} for k in
                   ("op_refused_unbound", "op_fake_matches", "op_sums") if k in r0},
                "card": card}
        print(json.dumps(line), flush=True)
        for r, rr in res.items():
            if not (rr["launches"] == rr["live_launches"] == want_plain and ops_match[r]):
                raise RuntimeError(f"mesh artifact {mesh}: {r} launches {rr['launches']}, "
                                   f"live {rr['live_launches']}, want {want_plain}; "
                                   f"collectives {rr['collectives']}, program "
                                   f"{exported['ops'][rr['m']]}")
            if "op_sums" in r0 and not (rr["op_refused_unbound"] and rr["op_fake_matches"]
                                        and rr["op_sums"] and rr["collectives"]):
                raise RuntimeError(f"mesh artifact {mesh}: {r}'s collective op: {line}")
        if not (bit_equal and r0["rerun_equal"] and r0["logits"].shape == ref.shape
                and np.isfinite(r0["logits"]).all() and rel <= budget):
            raise RuntimeError(f"mesh artifact {mesh}: bit-equal to live {bit_equal}, on a "
                               f"rerun {r0['rerun_equal']}, rel MAE {rel} against the "
                               f"single-device logits")
        lines[f"artifact_{mesh}"] = line
        if (model, shape) == PAR_HTTP:
            checked, failed = r0["opcheck"]
            print(json.dumps({"phase": "parallel_mesh_opcheck", "mesh": mesh, "ops": checked,
                              "failed": failed, "card": card}), flush=True)
            if failed or set(checked) != {n for n, c in want_plain.items() if c}:
                raise RuntimeError(f"mesh artifact {mesh}: opcheck on the shard: {failed}, "
                                   f"checked {sorted(checked)}")
            lines[f"http_{mesh}"] = _check_mesh_http(
                mesh, {r: rr["http"] for r, rr in res.items()}, want_plain, card)
    return lines


def _check_mesh_http(mesh: str, res: dict, want: dict, card: str) -> dict:
    """``_par_http``'s round, each rank's result in ``res``: rank 0's HTTP
    logits and classes those of ``predict_logits`` on the same volumes, bit
    for bit; /healthz ok; the requests coalesced; /reload answered
    "reloaded" and the next answer moved by PAR_HTTP_SHIFT (within bf16's
    rounding of the logits); each rank's launches ``want`` times the
    forwards of the round (two micro-batches of the direct call, the
    batches of the 16 POSTs, the last POST)."""
    r0 = res["rank0"]
    metrics = r0["metrics"]
    forwards = 2 + metrics["batches_total"] + 1
    moved = r0["reloaded"] - r0["http"][0]
    line = {"phase": "parallel_mesh_http", "mesh": mesh, "requests": len(r0["http"]),
            "post_s": r0["post_s"], "metrics": metrics, "healthz": r0["healthz"],
            "reload": r0["reload"],
            "http_equal_to_predict_logits": bool(np.array_equal(r0["http"], r0["direct"])),
            "classes_match": bool((r0["classes"] == r0["direct"].argmax(-1)).all()),
            "reload_shift_err": float(np.abs(moved - PAR_HTTP_SHIFT).max()),
            "launches": {r: rr["launches"] for r, rr in res.items()},
            "want_launches": {n: c * forwards for n, c in want.items()}, "card": card}
    print(json.dumps(line), flush=True)
    if not (line["http_equal_to_predict_logits"] and line["classes_match"]
            and r0["healthz"] == {"status": "ok"} and r0["reload"] == {"status": "reloaded"}
            and metrics["requests_total"] == N_REQUESTS
            and metrics["batches_total"] < N_REQUESTS and line["reload_shift_err"] <= 5e-2):
        raise RuntimeError(f"mesh HTTP {mesh}: {line}")
    if any(c != line["want_launches"] for c in line["launches"].values()):
        raise RuntimeError(f"mesh HTTP {mesh}: launches {line['launches']}, want "
                           f"{line['want_launches']}")
    return line


def phase_parallel_kernels(card: str, shapes) -> dict:
    """A and B on GAViKO's tensor-parallel shard (vit-l16 B4: heads 8..15 of
    16, 1,040 rows, dropout 0.1 to exercise the head offset's bits) against
    their plain versions and bit-equal to the whole layer's kernels on those
    heads; B13's sharded step (norm kernel, a device scalar, update kernel)
    at GAViKO's trainable leaves bit-equal to its one-launch step (0 ULP)."""
    import torch

    from gaviko_tpu_torch.ops import fused_adam as fa
    from gaviko_tpu_torch.ops.flash_attention import (
        fused_mhsa, fused_mhsa_bwd, mhsa_bwd_reference, mhsa_reference)

    gen = torch.Generator(device="cuda").manual_seed(7)
    B, n_pad, n_true, H, heads, head0, D = 4, 1040, 1033, 16, 8, 8, 64
    dt = torch.bfloat16
    qkv = (torch.randn(B, n_pad, 3 * H * D, generator=gen, device="cuda")).to(dt)
    dout = (torch.randn(B, n_pad, H * D, generator=gen, device="cuda")).to(dt)
    cols = torch.cat([torch.arange(head0 * D, (head0 + heads) * D, device="cuda") + j * H * D
                      for j in range(3)])
    part, o = qkv[..., cols].contiguous(), slice(head0 * D, (head0 + heads) * D)
    pdout = dout[..., o].contiguous()
    kw = dict(heads_total=H, head0=head0)
    scale = D ** -0.5

    def fwd():
        return fused_mhsa(part, heads, D, scale, n_true, 0.1, True, 99, **kw)

    out, lse = fwd()
    dq = fused_mhsa_bwd(part, out, lse, pdout, heads, D, scale, n_true, 0.1, 99, **kw)
    want = mhsa_reference(part, heads, D, scale, n_true, 0.1, False, 99, **kw)
    dwant = mhsa_bwd_reference(part, out, lse, pdout, heads, D, scale, n_true, 0.1, 99, **kw)
    whole, wlse = fused_mhsa(qkv, H, D, scale, n_true, 0.1, True, 99)
    wd = fused_mhsa_bwd(qkv, whole, wlse, dout, H, D, scale, n_true, 0.1, 99)
    line = {"phase": "parallel_kernels", "shard": f"heads {head0}..{head0 + heads - 1} of {H}",
            "fused_mhsa_rel_mae": _rel_mae(out[:, :n_true], want[:, :n_true]),
            "fused_mhsa_bwd_rel_mae": _rel_mae(dq, dwant),
            "fused_mhsa_equal_to_whole_layer": bool(torch.equal(out, whole[..., o])),
            "fused_mhsa_bwd_equal_to_whole_layer": bool(torch.equal(dq, wd[..., cols])),
            "fused_mhsa_ms": _median_ms(fwd),
            "fused_mhsa_bwd_ms": _median_ms(lambda: fused_mhsa_bwd(
                part, out, lse, pdout, heads, D, scale, n_true, 0.1, 99, **kw))}
    # B13 at GAViKO's trainable leaves (f32): the sharded step on one rank.
    grads, mu, nu, params = _adam_leaves(shapes, torch.float32, gen, 1.0)
    scalars = (3e-4, 0.93, 0.1351, 0.00299)
    runs = []
    for reduce in (None, lambda t: None):
        state = [[t.clone() for t in ts] for ts in (mu, nu, params)]
        runs.append(fa.fused_adam(grads, *state, *scalars, clip=1.0, eps=1e-8,
                                  norm_reduce=reduce))
    line["fused_adam_sharded_equal_to_one_launch"] = all(
        torch.equal(x, y) for a, b in zip(*runs) for x, y in zip(a, b))
    line["fused_adam_leaves"] = len(shapes)
    line["card"] = card
    print(json.dumps(line), flush=True)
    if not (line["fused_mhsa_rel_mae"] <= BF16_BUDGET and line["fused_mhsa_bwd_rel_mae"]
            <= BF16_BUDGET and line["fused_mhsa_equal_to_whole_layer"]
            and line["fused_mhsa_bwd_equal_to_whole_layer"]
            and line["fused_adam_sharded_equal_to_one_launch"]):
        raise RuntimeError(f"parallel_kernels: {line}")
    return line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    from gaviko_tpu_torch.ops import _build

    t_start = time.perf_counter()
    smi = _nvidia_smi()
    try:
        import yaml  # noqa: F401
        has_yaml = "ok"
    except ImportError:
        has_yaml = "missing"
    print(json.dumps({"phase": "env", "nvidia_smi": smi,
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "yaml": has_yaml, "tensorstore": _tensorstore_version() or "missing"}),
          flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "ptxas": {n: _ptxas(log) for n, log in logs.items()}}), flush=True)

    kernels = {"serving": phase_kernels(smi, B, "serving"),
               "vit": phase_kernels(smi, B, "vit"),
               "train": phase_kernels(smi, TRAIN_B, "train"),
               "vit_train": phase_kernels(smi, VIT_TRAIN_B, "vit_train"),
               "t16": phase_kernels(smi, B, "t16"),
               **{f"dh{d}": phase_kernels(smi, VIT_TRAIN_B, f"dh{d}") for d in DIM_HEADS},
               "int8": phase_kernels(smi, B, "int8"),
               "general": phase_kernels(smi, 2, "general"),
               "wide": phase_kernels(smi, 1, "wide"),
               "local": phase_kernels(smi, TRAIN_B, "local"),
               "ln_bwd": phase_kernels(smi, None, "ln_bwd"),  # LN_BWD_SHAPES
               "c11": phase_kernels(smi, None, "c11")}  # C11_SHAPES
    phase_b7_bits(smi)
    t0 = time.perf_counter()
    tile_lines = phase_tiles(smi, logs)
    print(json.dumps({"phase": "tiles_done", "seconds": time.perf_counter() - t0}), flush=True)
    phase_attention_bits(smi)
    phase_local_bits(smi)
    rng = np.random.RandomState(0)
    vols = [rng.rand(120, 160, 160).astype(np.float32) for _ in range(N_REQUESTS)]
    launches, fp_served, deploy, op_args = {}, {}, {}, {}
    for name, config, method, over, headline in (
            ("serving", CONFIG, "gaviko", None, None), ("vit", VIT_CONFIG, "fft", None, HEADLINE_B),
            ("t16", VIT_CONFIG, "fft", T16, None),
            *((f"dh{d}", VIT_CONFIG, "fft", DH[d], None) for d in DIM_HEADS)):
        predictor = make_predictor(config, method, over)
        launches[name], fp_served[name] = phase_serving(predictor, vols)
        phase_plain_check(predictor, vols[:B], fp_served[name][:B], smi, headline)
        # Deployment (phase 22) on the live predictor: GAViKO's artifact, and
        # cli.export -> cli.infer --artifact on vit.yaml.
        if name == "serving":
            deploy["gaviko"], artifact_logits = phase_deploy(
                "gaviko", _config(config, method, over), predictor, vols, fp_served[name], smi,
                op_args)
        elif name == "t16":  # B10 inside an exported program
            deploy["t16"], _ = phase_deploy("t16", _config(config, method, over), predictor,
                                            vols, fp_served[name], smi, op_args)
        elif name == "vit":
            phase_deploy_cli(predictor, vols, smi, op_args)
        del predictor
        torch.cuda.empty_cache()
    # int8 serving (B11): GAViKO vit-l16, vit-b16 fft and vit-b16 at
    # dim_head 192 (out-projections 2304 -> 768, Queue C 10), quantized after
    # the cast to bf16, against the plain versions and the fp predictors.
    for name, config, method, over, fp_name, budget in (
            ("int8", CONFIG, "gaviko", None, "serving", INT8_PLAIN_BUDGET),
            ("vit_int8", VIT_CONFIG, "fft", None, "vit", SERVE_BUDGET),
            ("vit_int8_dh192", VIT_CONFIG, "fft", DH[192], "dh192", SERVE_BUDGET)):
        predictor = make_predictor(config, method, over, quantize="int8")
        launches[name], served = phase_serving(predictor, vols)
        phase_plain_check(predictor, vols[:B], served[:B], smi, budget=budget,
                          fp_served=fp_served[fp_name][:B])
        if name == "int8":  # the 1-rank logits the int8 mesh runs are held to
            int8_served = np.asarray(served[:B], np.float64)
        if name == "vit_int8":  # phase 22: the int8 artifact, and its reload
            deploy[name], _ = phase_deploy(name, _config(config, method, over), predictor,
                                           vols, served, smi, op_args)
        del predictor
        torch.cuda.empty_cache()
    phase_opcheck(op_args, smi)  # phase 22: every gaviko:: op's fake against its kernel
    del op_args

    # Train runs: (name, setup, precisions, the precision whose launches the
    # kernels line reports, GAVIKO_LNQKV_HYBRID for the run). vit-t16 trains
    # with the config's dropout 0.1 (plain attention with dropout, no
    # attention kernel) and dropout-free (B10 forward, the plain version's
    # VJP backward). The hybrid runs take B12 as the qkv's backward: vit-b16
    # fft and GAViKO vit-l16 with a trainable backbone.
    t16_no_dropout = {**T16, "dropout": 0.0, "emb_dropout": 0.0}
    adam_shapes = {}
    for name, make_setup, precisions, reported, hybrid in (
            ("train", train_setup, ("fp32", "bf16"), "fp32", False),
            ("vit_train", vit_train_setup, ("fp32", "bf16"), "bf16", False),
            ("vit_train_hybrid", vit_train_setup, ("fp32", "bf16"), "bf16", True),
            ("gaviko_trainable_hybrid", lambda: train_setup({"freeze_vit": False}),
             ("bf16",), "bf16", True),
            ("t16_train", lambda: cut_vit_train_setup(T16), ("fp32", "bf16"), "bf16", False),
            ("t16_train_no_dropout", lambda: cut_vit_train_setup(t16_no_dropout), ("bf16",),
             "bf16", False),
            ("dh128_train", lambda: cut_vit_train_setup(DH[128]), ("fp32", "bf16"), "bf16",
             False),
            ("dh192_train", lambda: cut_vit_train_setup(DH[192]), ("bf16",), "bf16", False),
            ("dh256_train", lambda: cut_vit_train_setup(DH[256]), ("bf16",), "bf16", False)):
        with _lnqkv_hybrid(hybrid):
            setup = make_setup()
            runs = {p: phase_train(setup, p, smi) for p in precisions}
            adam_shapes[name] = runs[reported]["trainable_shapes"]
            for precision, run in runs.items():
                phase_train_check(setup, precision, run, smi)
        launches[name] = runs[reported]["launches"]
        del setup, runs
        torch.cuda.empty_cache()

    # fused_optimizer: false (the optax chain's state) against the fused state.
    phase_chain(smi)

    # B13 at the trainable leaves of the GAViKO and vit-b16 train runs.
    adam = {row: phase_adam(smi, row, adam_shapes[run]) for row, run in ADAM_ROWS.items()}

    # The trainer and its CLIs at full width, after the check of its first
    # two steps against the plain versions.
    with tempfile.TemporaryDirectory(prefix="gaviko_trainer_") as root:
        label, trainable_keys = phase_trainer_check(root, smi)
        phase_trainer(root, label, trainable_keys, smi,
                      adam["fused_adam_gaviko"]["torch.float32"]["one_pass"])

    # The rest of the PEFT zoo at vit-b16, full width and depth, each from
    # its shipped config: served in bf16 at B8, then trained in fp32 and
    # bf16 at B8 with the train check.
    zoo, zoo_served = {}, {}
    for method, config, over in ZOO:
        t_method = time.perf_counter()
        zoo[f"{method}_serve"], zoo_served[method] = phase_zoo_serving(config, method, over,
                                                                       vols[:B], smi)
        zoo[f"{method}_int8"], _ = phase_zoo_serving(config, method, over, vols[:B], smi,
                                                     "int8", zoo_served[method])
        setup = zoo_train_setup(method, config, over)
        for precision in ("fp32", "bf16"):
            run = phase_train(setup, precision, smi)
            phase_train_check(setup, precision, run, smi)
            zoo[f"{method}_train_{precision}"] = {n: c // TRAIN_STEPS
                                                  for n, c in run["launches"].items()}
        del setup, run
        torch.cuda.empty_cache()
        print(json.dumps({"phase": "zoo_method_done", "method": method,
                          "seconds": time.perf_counter() - t_method}), flush=True)

    # The trainer's input and starting weights: the vit-l16 timm file
    # converted onto the card, the augmentation on the card, the host loader
    # engines, then the GAViKO trainer on all of them (grain on 2 processes,
    # device augmentation, bf16).
    with tempfile.TemporaryDirectory(prefix="gaviko_input_") as root:
        pretrained, sample = phase_weights(root, smi)
        phase_augment(smi)
        phase_loader(_trainer_files(root, 0)[2], smi)
        trainer_input = phase_trainer_input(root, pretrained, sample, smi)
    input_launches = trainer_input["step_launches"][-1]

    # Multi-device training and serving (parallel/mesh.py): gaviko_tpu.yaml
    # through cli.train on a 1 x 1 mesh (orbax resume directory where
    # tensorstore imports), then 2 ranks on cuda:0 over gloo against one
    # rank (train jobs, the accumulating one and the zoo's tensor
    # parallelism included, GAViKO int8 serving, and GAViKO's mesh
    # artifacts against the live mesh Predictor and phase 22's artifact),
    # then A and B on a head shard and B13's sharded step.
    with tempfile.TemporaryDirectory(prefix="gaviko_parallel_") as root:
        par_one = phase_parallel_one(root, smi)
        par_two = phase_parallel_two(root, smi, int8_served, {
            "gaviko": artifact_logits, "vit": fp_served["vit"][:B],
            "adaptformer": zoo_served["adaptformer"]})
    phase_parallel_kernels(smi, par_two.pop("gaviko_trainable_shapes"))
    parallel_launches = {"parallel_one": par_one["step_launches"][-1],
                         **{job: line["launches"]["rank0"] for job, line in par_two.items()},
                         "vit_tp_eval": par_two["vit_tp"]["eval_launches"]["rank0"]}

    # Each kernel at the shapes of the path LINE_PATH names, with that
    # path's launches: the local attention kernels at GAViKO's B4 fp32 train
    # shapes; patchify, A, B, B6 and B7 at the vit-b16 B8 bf16 train shapes;
    # LN+linear (the qkv projection) and CLS attention at the vit-b16 B8
    # bf16 serving shapes; B10 at the vit-t16 B8 bf16 serving shapes with
    # the vit-t16 serving run's launches. Then A, B and B8 at head dim 128
    # (bf16) with the dim_head-128 train or serving run's launches. B11
    # (int8_linear: the qkv projection with its LN; int8_mlp: the MLP) at
    # the GAViKO vit-l16 B8 bf16 int8 serving shapes with that run's
    # launches. B12 (with dW) at the vit-b16 and GAViKO vit-l16 bf16 hybrid
    # train shapes with those runs' launches.
    rows = []
    line_rows = [(n, n, LINE_PATH[n], LINE_PATH[n]) for n in SOURCES if n in LINE_PATH]
    line_rows += [(row, n, run.split("_")[0], run) for row, (n, run) in DH_ROWS.items()]
    line_rows += [(row, "ln_linear_bwd", "ln_bwd", run) for row, run in LN_BWD_ROWS.items()]
    for row_name, n, path, run in line_rows:
        src, tpu = SOURCES[n]
        dtype = "torch.float32" if path == "train" else "torch.bfloat16"
        line = kernels[path][(row_name, dtype)]
        row = {"name": row_name, "route": "cuda", "source": src, "replaces": tpu,
               "launches": launches[run][n],
               **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "dtype", "batch", "path")}}
        for key in ("chain_ms", "int_mm_ms"):
            if key in line:
                row[key] = line[key]
        row["zoo_launches"] = {run: c[n] for run, c in zoo.items() if c[n]}
        row["deploy_launches"] = {run: c[n] for run, c in deploy.items() if c[n]}
        row["trainer_input_launches"] = input_launches[n]
        if row_name in LINE_TILES:  # the GEMM's kernels: the policy's tiles, each tile's ms
            row["tiles"] = _line_tiles(row_name)
            tile_line = tile_lines.get((row_name.replace("_l16", ""), "torch.bfloat16"))
            row["tile_ms"] = {"case": tile_line["name"], "policy": tile_line["policy"],
                              **{t: v["ms"] for t, v in tile_line["by_tile"].items()}}
        if row_name == n:  # the parallel runs are at head dim 64 and vit-b16 / vit-l16 widths
            row["parallel_launches"] = {run: c[n] for run, c in parallel_launches.items()
                                        if c[n]}
        rows.append(row)
    # B13 at f32 storage (both runs keep f32 masters and moments), with its
    # run's B13 launches (one a step: its norm kernel, then its update).
    src, tpu = SOURCES["fused_adam"]
    for row_name, run in ADAM_ROWS.items():
        line = adam[row_name]["torch.float32"]
        rows.append({"name": row_name, "route": "cuda", "source": src, "replaces": tpu,
                     "launches": launches[run]["fused_adam"],
                     **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "chain_ms", "dtype",
                                             "leaves", "elements", "path")},
                     "zoo_launches": {run: c["fused_adam"] for run, c in zoo.items()
                                      if c["fused_adam"]},
                     "trainer_input_launches": input_launches["fused_adam"],
                     "parallel_launches": {run: parallel_launches[run]["fused_adam"]
                                           for run in PAR_ADAM_RUNS[row_name]}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"phase": "done", "seconds": time.perf_counter() - t_start}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
