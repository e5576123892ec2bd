"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failing check raises; the exit code is then non-zero):

1. build — compile every hand-written CUDA kernel of the main path with nvcc
   (``semanticlens_tpu_torch/csrc/*.cu``), all sources at once;
2. kernels — call each kernel's wrapper on the card at the shapes the main
   path gives it, plus ragged, zero-row, near-duplicate, wide-norm and
   threshold cases, and hold the result against its plain PyTorch version
   (atol 3e-5); time kernel, plain version, and one PyTorch library call
   computing the same function (device time from the replay of a CUDA graph
   of 20 launches, with the inputs warm in L2 and with them cold, and the
   host-loop time beside it); compute each kernel's bounds from the card's
   data-sheet rates;
2b. k1b — K1b, the top-k in the tiled kernel's epilogue, through
   ``topk_cosine_search`` at the audit search's shape (``K1B``: 1024 ×
   1,048,576 × 512, k = 32) and at two smaller tiled shapes with planted
   ties (duplicated and dead rows and queries; one past K1's 512-wide flush
   in D): values bitwise equal to the chunked path's (K1 blocks and the
   merge) and indices equal, its plain version within atol 3e-5; one
   ``k1.launches.tiled`` and one ``search.k1b`` a call; K1's full matrix at
   2048² × 512 bitwise the tree's before K1b (``K1_REDUNDANCY_SHA256``);
   K1b's device time warm and cold (CUDA-graph replay) and the whole
   call's host time beside the chunked path, the plain version, one
   PyTorch formulation (cuBLAS fp32 matmul + ``torch.topk``) and the
   3×TF32 bound;
2c. moe — the MoE combine kernel (``csrc/moe.cu``) through ``ops/moe.combine`` at
   ``MOE``'s shapes (DeepSeek-V2-Lite's 8,192 tokens × top-6 of 64 × 2,048;
   37 tokens × top-2 × 5,120; every pair on one expert): within one bf16
   step of the float32 slot-ordered sum, one ``moe.combine.kernel`` a call;
   at the first shape its device time warm and cold (CUDA-graph replay), the
   host time, the byte bound and its share, the plain version and the
   operator chain it replaced (float32 cast, weighting, ``index_add_``) as
   ``library_ms``; then one forward of DeepSeek-V2-Lite at full width cut to
   ``MOE_FORWARD``'s depth on 16 × 512 tokens, one ``moe.combine.kernel`` per
   MoE layer (the count the ``kernels`` line gives the kernel);
2d. kda — the KDA recurrence kernel (``csrc/kda.cu``) through
   ``ops/kda.recurrence`` at ``KDA``'s shapes (Kimi Linear's text sweep, 4 ×
   2,048 tokens × 32 heads of 128; one (sequence, head) of 37 tokens; a
   float32 case of 301 tokens): the largest error against the plain
   float32 token loop over every token of each case, in units of the
   output's scale, one ``kda.kernel`` a
   call; at the first shape its device time warm and cold (CUDA-graph
   replay), the host time, the plain loop's time, and the least time
   (7·d² operations a token-head at the bf16 peak, or 2·(5·d + 1) bytes at
   the HBM rate) with its share; then one forward of Kimi Linear at full
   width, cut to ``KDA_FORWARD``'s depth (three KDA layers and one MLA, 128
   of 256 experts held) on 4 × 2,048 tokens, one ``kda.kernel`` per KDA
   layer and one ``moe.combine.kernel`` per MoE layer;
3. reference — the slice at full model width on 16 images in float32 on the
   card, held against the same code on the CPU (plain kernel versions);
4. quickstart — the README quickstart through the port's entry points at
   full width: ResNet-50 bf16 tapping layer3/layer4, OpenCLIP ViT-B/32 bf16,
   both with random weights from seed 0, 2048 synthetic 256×256 uint8 images
   at batch 256: the fused Collect+Embed pass, the concept DB, text probing,
   clarity, redundancy and polysemanticity. Kernel launch counts are set to
   0 just before and read just after; every kernel of the path must have
   launched (K1: both its streaming and its tiled kernel);
5. analyze — README step 5 and the audit scores on the quickstart's DB:
   ``label_components`` over a 1000-word vocabulary (cosine and soft-WPMI
   from the collected evidence and embedding table), ``match_components``,
   ``semantic_coverage``, ``drift_score``, ``null_calibrated_polysemanticity``,
   and ``topk_cosine_search`` at audit scale (1024 queries × 1,048,576
   components × 512, k=32) with its device time in K1 and in the top-k
   merge apart (a ``torch.profiler`` trace of the same call); the labels
   and the search held against dense K1 + stable sort, the merge against a
   stable sort merge on the same blocks (tied rows included), and timed
   beside it;
6. serve — ``SearchService`` over the quickstart's DB behind ``serve`` on
   loopback: 200 sequential and 8 concurrent clients' text searches
   (latency p50/p99), ``/label`` cold and cached, ``/healthz``, the 400 of a
   broken ``POST /image_search`` upload; served ids equal to offline probing;
7. resume — a fused sweep of 1024 images checkpointed every 512 and
   preempted after the batch at sample 768, resumed, and held identical to
   an uninterrupted sweep (ids, values, embedding table);
8. folder — the bring-your-own path: 2048 synthetic 500×375 images encoded
   with nvJPEG (quality 90, 4:2:0) into a 4-class JPEG folder; nvJPEG's
   decode of the committed fixtures (``tests/data/torch_jpeg``) held to the
   JAX package's PIL arrays (mean |Δ| ≤ 1.5 levels, PSNR ≥ 40 dB); a
   torchvision-layout ResNet-50 ``nn.Module`` (bf16, seed 0) through
   ``TorchSubjectModel`` held to the native ``ResNet(50)`` on the same state
   dict (layer3/layer4 taps within 2^-7 relative); then ``ImageFolder`` →
   the fused Collect+Embed pass with OpenCLIP RN50 bf16 (embed dim 1024) →
   concept DB, text probing, redundancy, ``visualize_components`` to a PNG,
   and ``POST /image_search`` with a fixture's bytes. Prints the decode rate,
   the fused pass cold and warm, the RN50 tower and the adapter against the
   native ResNet per batch, the RN50 tower's bf16 error against float32,
   the image-search latency and peak memory;
8b. formats — the [folder] path over every format of the JAX ``ImageFolder``
   but WebP, which 8c takes (``FORMATS``; 60 s bound): what nvJPEG answers for the
   committed four-plane fixtures asked for NVJPEG_OUTPUT_UNCHANGED (the
   probe); every committed fixture (``tests/data/torch_formats``) decoded at
   full resolution on the card against PIL's arrays (PNG and BMP exact, CMYK,
   YCCK and RGB-coded JPEG within ``DECODE_BOUNDS``); a 4-class folder of
   2048 images at 500×375 — 1792 nvJPEG-encoded JPEGs, 128 PNGs and 64
   BMPs written here (all five filter types, Adam7, gray, palette, RGBA, 16
   bits; palette, 5-6-5, V5 bit fields, RLE8, top-down), 32 copies of the
   CMYK / YCCK fixtures and 32 PNGs under a ``.JPEG`` name — decoded alone
   per format (every PNG and BMP equal to what it was written from), then
   ResNet-50 bf16 through ``TorchSubjectModel`` → the fused pass with CLIP
   RN50 (every file decoded, cold and warm) → probing and redundancy; and
   ``POST /image_search`` with a PNG, a BMP and a CMYK JPEG, each equal to
   the in-process search on its decode;
8c. webp — the [folder] path over WebP (``WEBP``; 60 s bound): the two host
   decoders' build seconds (``csrc/webp_lossless.cpp``, ``webp_lossy.cpp``,
   built with the kernels in phase 1); every committed WebP fixture
   (``tests/data/torch_formats``) decoded on the card, its array's SHA-256
   equal to PIL's (``pil_webp_sha256.json``); each full-width variant (lossy
   q75 and q90, lossless, lossy with alpha, an animation's first frame)
   decoded 256 times alone, the host bitstream decode timed apart, every
   output equal; a 4-class folder of 1024 copies (768 lossy, 192 lossless,
   64 lossy with alpha) through the worker's decode, then ResNet-50 bf16
   through ``TorchSubjectModel`` → the fused pass with CLIP RN50 (every file
   decoded, cold and warm) → probing and redundancy; and ``POST
   /image_search`` with a lossy and a lossless WebP, each equal to the
   in-process search on its decode (K1 counted from 0 as the ``webp`` path);
9. lrp — config 4 (``BASELINE.json``), the attribution path: gates first
   (the float32 ResNet-50 on 4 images and 2 layer3 components, TF32 off:
   heatmaps of each composite on the card against the port on the CPU
   within ``LRP_HEAT_ATOL``, crop boxes equal, batched against single;
   conservation of Σ relevance through one bottleneck and one ViT-B/16
   block; ViT-B/16 bf16 at full width, forward on 64 images and heatmaps
   of one ``blocks.11.mlp.fc2`` component, the float32 ViT card against
   CPU); then ResNet-50 bf16 (seed 0) over 5000 synthetic 224² uint8
   images, ``RelevanceComponentVisualizer`` on layer3 (1,024 components,
   ε-plus-flat, 8 examples each), ``Lens.compute_concept_db`` at batch 256
   (32 components per LRP backward, attribution-cropped examples embedded
   by CLIP ViT-B/32 bf16), text probing, redundancy and clarity. Prints the
   sweep's images/s, the concept DB's seconds and heatmaps/s with its split
   (attribution, blur + crop, resize, embed), a warm attribution burst and
   peak memory;
10. siglip — BASELINE config 3 ("ViT-B/16 backbone, MLP/attention components
   → SigLIP embedding + text_probing search"): the subject ViT-B/16 bf16
   (seed 0) over 2048 synthetic 224² uint8 images at batch 256,
   ``blocks.11.mlp.fc1`` (3,072 neurons) and ``blocks.11.attn.heads`` (12)
   with ``aggregate_transformer_mean`` and 25 samples, SigLIP2 ViT-B/16 bf16
   from ``create("siglip2")`` (375 M parameters, seed 0, hash tokenizer):
   the (3,084 × 25 × 768) concept DB, text probing, ``label_components``
   over 1000 words, clarity, redundancy; then ``python -m
   semanticlens_tpu_torch.serve --fm siglip2`` in its own process over the
   DB file Lens wrote, whose ``/text_search`` ids must equal offline probing.
   Gates, float32 card against CPU: SigLIP's image and text embeddings on 4
   images and 4 prompts, and config 3 on 16 images as ``[reference]`` does
   (values, ids, probe scores, clarity, redundancy);
11. mobileclip — MobileCLIP-S2 bf16 (seed 0): 256 images at 256² and a
   prompt batch timed beside SigLIP and CLIP ViT-B/32; the head components
   of phase 10 re-embedded into a MobileCLIP concept DB (their ids from the
   cache), probing and redundancy at D = 512; float32 card vs CPU on 2
   images first;
12. dissect — CLIP ViT-B/32's own block-11 MLP neurons (3,072 × 512) and
   attention heads (12 × 64 × 512) as joint-space directions, labelled over
   1000 words; the float32 directions card vs CPU first;
13. sae — the training path: an SAE on ResNet-50 bf16 (seed 0) layer3
   (d_in 1024, 8192 latents, TopK 32, AuxK 256, 4096 rows per step, 16
   positions per image, 256 images per batch; the JAX ``tools/train_sae.py``
   defaults) over 2048 synthetic 224² images through
   ``SAEComponentVisualizer.train``: one cold epoch, then a warm run of 32
   steps (l0 = 32 on every step, finite loss and parameters, fvu falling);
   a run at ``dead_steps=2`` puts AuxK on the loss with finite gradients
   that reach the dead latents' decoder rows; ``python -m
   semanticlens_tpu_torch.train_sae --epochs 1 --out …`` in its own process
   (the JAX tool's JSON keys; its ``.npz`` loads through ``convert`` into an
   ``SAESubjectModel`` named with the file's digest) while the float32 gates
   run: 5 steps of TopK+AuxK, ReLU+L1, JumpReLU and a skip transcoder, card
   against CPU (``SAE_GATE``), and the trained dictionary's top-32 latent
   ids on 16 images card against CPU; then the audit:
   ``SAEComponentVisualizer`` with 25 samples and CLIP ViT-B/32 bf16
   (fused pass cold and warm, the 8192 × 25 × 512 concept DB), probing with
   8 words, labels over 1000 words, clarity and redundancy over 8192
   components;
14. audit — BASELINE config 5 (``AUDIT5``): ``full_audit.main`` in process
   twice on 2048 synthetic 224² images, ResNet-50 bf16 → layer1–layer4
   (3,840 components, 25 samples) → CLIP ViT-B/32 bf16 at batch 256, the
   three default queries, 1000 words and two image queries: cosine labels
   cold, soft-WPMI labels warm. Gates: the DB shapes, finite scores, each
   run's top-5 per query and the cold labels equal to dense K1 + stable
   sort; ``python -m semanticlens_tpu_torch.full_audit --image-dir`` over a
   512-image 4-class JPEG folder in its own process (the report's keys,
   class composition) while the float32 gate runs: the audit on 16 images
   card against CPU, all four layers (evidence ids, and the card's scores
   and top-5 on the CPU run's DB within 1e-5 relative / equal);
15. causal — ResNet-50 float32 layer3 (``CAUSAL``): the necessity ratios of
   the 32 components with the strongest evidence over 512 synthetic
   images, ``ablation_effects`` over all 1,024 channels on 8 images (8,192
   forward rows), ``python -m semanticlens_tpu_torch.causal_audit --depth
   50 --image-size 224`` in its own process; invariants on the card
   (keep-all mask, ``steer`` at alpha 0, whole-layer patching, K·B rows
   against K forwards, the SAE and transcoder paths against each other) and
   ablation, patching, steering and necessity ratios card against CPU
   (``CAUSAL_GATE``);
16. featviz — ``featviz.synthesize`` on ResNet-50 bf16 layer3 at 224² (K =
   16, 64 steps; cold then warm), ``SynthesisComponentVisualizer`` (32
   components × 2 variants) → CLIP ViT-B/32 concept DB → probing, labels,
   clarity, redundancy, a second visualizer reloading the gallery without
   optimizing, and the float32 gate (4 steps on 2 canvases, card against
   CPU, ``FEATVIZ_GATE``).

17. lm — the LM subjects (``LM``, ``LM_GATE``): the float32 gates first (every
   family at its published width cut to 2 layers — Llama-3.2-1B, GPT-2,
   Gemma-2-2B, Qwen2.5-0.5B, Phi-3-mini — weights drawn on the card from seed
   0, 8 left-padded rows of 64 tokens: logits, the MLP and heads taps card
   against CPU, a left-padded row against its unpadded tokens, the keep-all
   ablation Δ) while ``python -m semanticlens_tpu_torch.lm_audit --family
   gemma2`` runs at the tool's defaults in its own process (its three JSON
   stages' keys against ``REPORT_KEYS``); then the JAX ``tools/lm_audit.py``
   workflow at full width on Llama-3.2-1B bf16 (``model.layers.15.mlp.act_fn``,
   8,192 neurons, and ``…self_attn.heads``, 32) and GPT-2 bf16
   (``transformer.h.11.mlp.act``, 3,072, and ``…attn.heads``, 12) over the
   tool's topic corpus at 2048 texts of 64 tokens, CLIP ViT-B/32 float32
   embedding the evidence strings: collect and embed (cold, then warm
   apart), soft-WPMI labels over the topics, clarity and redundancy,
   necessity ratios of the 32 clearest neurons, ε-plus-flat token relevance
   of 8 evidence rows (Llama's conserving the target within
   ``LM_GATE["conservation_rel"]``), highlighted evidence and the text
   report; then ``TextSAEComponentVisualizer.train`` on GPT-2's
   ``transformer.h.6.mlp.act`` (8192 latents, TopK 32, one epoch of 32 steps
   of 4096 token rows: l0 = 32 on every step, fvu falling) and the latents
   audited. Prints the weight draws' seconds (numpy in the JAX layout on
   GPT-2, on the card for both), tokens/s, strings/s and every stage's
   seconds.
18. zoo — the vision zoo, part one (``ZOO``, ``ZOO_GATE``; ``phase_zoo``): the float32 gates
   first (ResNet-50d, ResNeXt-50 32x4d, Wide-ResNet-50-2, VGG-16 and -BN,
   DenseNet-121, ConvNeXt-Tiny in timm and torchvision naming,
   EfficientNet-B0, EfficientNetV2-S, MobileNetV2, MobileNetV3-Large,
   MNASNet1_0 and RegNetY-400MF at published width, seed 0, 2 images at
   224²: logits and every default ``full_audit`` tap card against CPU), the
   ε-plus-flat and ε heatmaps of ConvNeXt-Tiny ``stages.2`` and
   EfficientNet-B0 ``features.6`` / ``features.3`` card against CPU (float32,
   and float64 for the function), Σ relevance through one block of each,
   while ``python -m semanticlens_tpu_torch.full_audit --arch densenet`` and
   ``python -m semanticlens_tpu_torch.causal_audit --arch mobilenetv2`` run
   in their own processes; then the main path, ``full_audit.main --arch
   convnext`` (ConvNeXt-Tiny bf16 → stages.0–3, 1,440 components, 25
   samples, CLIP ViT-B/32 bf16, 2048 images at 224², 1000 words, two image
   queries; cold cosine labels, warm soft-WPMI), and each other family of
   the slice through ``full_audit.main`` at the JAX tool's defaults over
   512 images. Prints each family's gate readings, images/s, first forward
   and component count, the ConvNeXt audit's (``main_path``) stage seconds and peak memory,
   and K1's launches on the main path and on the other families apart.
19. zoo2 — the vision zoo, part two (``ZOO2``; ``phase_zoo`` as for zoo): the
   float32 gates of Swin-T, Swin-V2-T, MaxViT-T, GoogLeNet, Inception-v3,
   ShuffleNetV2 x1_0, AlexNet and SqueezeNet 1_0 / 1_1, the heatmaps of
   Swin-T ``features.5`` and GoogLeNet ``inception4c``, z⁺ through an
   Inception block, Σ relevance through a Swin and an Inception block, the
   ``full_audit --arch inception --variant v3`` and ``causal_audit --arch
   swin`` CLIs; then the main path, ``full_audit.main --arch swin`` (Swin-T
   bf16 → features.1/3/5/7, 1,440 components) at zoo's sizes, and the other
   seven families over 512 images.
20. mesh — the multi-GPU layer on the machine's one card (``MESH``,
   ``MESH_GATE``; ``phase_mesh``): (a) world 1 over NCCL in this process,
   config 5 at ``[audit]``'s sizes (ResNet-50 bf16 → layer1–4, CLIP ViT-B/32,
   2048 images at 224², batch 256) through
   ``ActivationComponentVisualizer(mesh=data_mesh())`` and a
   ``shard_concept_db`` Analyze, equal to the plain run (ids, bf16 values,
   concept DB, scores; K1 counted here as the ``mesh`` path), the
   data-parallel SAE trainer at ``[sae]``'s widths (20 steps) equal to the
   plain trainer, and Llama-3.2-1B with ``shard_params`` at tp = 1
   collecting ``model.layers.15.mlp.act_fn`` over 2048 × 64 tokens equal to
   the plain run; (b) two gloo ranks sharing ``cuda:0``
   (``parallel.launch.spawn``, ``mesh_rank``): the meshed engine,
   ``collect_multihost`` and ``fused_multihost`` at global batch 256 equal
   to one process at batch 128 (each rank's rows meet the same kernels at
   the same shapes), the bytes and milliseconds of the state merge and of
   the selected-rows exchange, and the SAE trainer at world 2 against one
   process (step-1 parameters, the fvu trajectory) with two controls that
   must break those bounds: a skipped gradient all-reduce and the rank-mean
   of fvu ratios. Prints the mesh path's images/s beside the plain path's.
21. int8 — the int8 inference path (``ops/quant.py``; ``INT8``, ``INT8_GATE``;
   ``phase_int8``): card against CPU on the same float32 inputs, ``x_q``
   and the int32 accumulators of ``int8_matmul`` at ViT-B/32's four linears
   at batch 256 and at 5 and 17 rows, and of ``int8_conv`` at ResNet-50's
   stage convs and ResNeXt-50 32×4d's grouped 3×3s (batch 8), equal
   exactly; ViT-B/32, SigLIP2 ViT-B/16 and MobileCLIP-S2 at full width, bf16,
   ``quantize="int8"`` against float per image (cosine ≥ 0.995) and both
   towers' images/s; ViT-B/32's linears and three ResNet-50 convs at batch
   256 split into quantize, im2col, ``_int_mm`` and epilogue beside their
   bounds and the bf16 product; LRP heatmaps of the float32 int8 ResNet-50
   against its dequantized float twin within ``[lrp]``'s bounds; ResNet-50
   bf16 and int8 on the quickstart's layer3/layer4 over its 2048-image pool
   (pooled taps per image ≥ 0.99, top-k id overlap and value cosine),
   collect and the fused pass with either tower int8; the int8 concept DB
   through redundancy, probing and ``topk_cosine_search`` (K1 counted from 0
   as the ``int8`` path).

Each of phases 8b, 8c and 14–21 prints its wall seconds beside its bound
(``bound_s``).

After the build, ``[env]`` reports whether ``g++``, libjpeg, ``zlib.h``,
``png.h``, libwebp (``find_library("webp")`` and ``webp/decode.h``), the CUDA
toolkit's nvJPEG and matplotlib exist.

Each path's K1 launches are counted from 0 and printed per path; the
analyze path must launch the tiled kernel, the serve path the streaming
kernel at least twice per text request (one per layer). Every (batch, M,
N, D) that K1 launches on the paths of phases 4–16 is recorded, and each
that phase 2 did not check is held against the plain version afterwards.

Prints the kernels' JSON line and the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits non-zero before printing any result. The quickstart's cache goes to a
temporary directory; the kernel build goes to the package's ignored
``csrc/build`` directory.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import importlib.util
import io
import json
import math
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.dont_write_bytecode = True

import numpy as np  # noqa: E402
import torch  # noqa: E402

from semanticlens_tpu_torch.utils.flops import H100_SXM  # noqa: E402

# H100 SXM data-sheet rates (dense, utils/flops.py): fp32 outside the tensor
# cores, TF32 and int8 on the tensor cores, HBM3.
PEAK_BF16_FLOPS = H100_SXM["bf16"]
PEAK_FP32_FLOPS = H100_SXM["fp32"]
PEAK_TF32_FLOPS = H100_SXM["tf32"]
PEAK_INT8_OPS = H100_SXM["int8"]
PEAK_BYTES_PER_S = H100_SXM["hbm_bytes_per_s"]
L2_BYTES = 50e6
ATOL = 3e-5
GRAPH_LAUNCHES = 20
# topk_cosine_search at audit scale: 2 GiB of fp32 components.
AUDIT = {"queries": 1024, "components": 1 << 20, "k": 32, "chunk": 65536}
# [k1b] shapes (Q, N, D, k): the audit search, labeling a 2048-component layer over 1000 words, and a shape past
# K1's 512-wide flush in D (SigLIP's width) with no dimension a multiple of the 128 × 256 tile; the last two with
# planted ties.
K1B = {"audit": (1024, 1 << 20, 512, 32), "labels": (2048, 1000, 512, 5), "d768": (300, 70_001, 768, 32)}
# [moe] shapes (tokens N, top-k, experts E, width H, routing): DeepSeek-V2-Lite's combine at the text sweep's 16 × 512
# tokens, a ragged N with a wide row, and one expert taking every pair.
MOE = {"textsweep": (8192, 6, 64, 2048, "top-k"), "ragged": (37, 2, 8, 5120, "top-k"),
       "one_expert": (512, 6, 64, 2048, "one expert")}
# [moe]'s model forward: DeepSeek-V2-Lite at full width cut to one dense and three MoE layers, on (B, T) tokens
MOE_FORWARD = {"depth": 4, "tokens": (16, 512)}
# [kda] shapes (B, T, heads, head size, dtype): Kimi Linear's text sweep, one (sequence, head) of a length that is
# not a multiple of the kernel's 16-token stage, and float32 operands (the kernel's arithmetic unrounded).
KDA = {"textsweep": (4, 2048, 32, 128, torch.bfloat16), "one_chain": (1, 37, 1, 128, torch.bfloat16),
       "float32": (3, 301, 5, 128, torch.float32)}
# [kda]'s model forward: Kimi Linear at full width cut to three KDA layers and one MLA (the published period), 128 of
# 256 experts held, on (B, T) tokens
KDA_FORWARD = {"depth": 4, "full_attn_layers": (4,), "held_experts": range(128), "tokens": (4, 2048)}
# SHA-256 of K1's output bytes for x = default_rng(0).standard_normal((2048, 512), float32) against itself,
# as the tree before K1b computed it (NVIDIA H100 80GB HBM3): K1b left the tiled kernel's output unchanged.
K1_REDUNDANCY_SHA256 = "314c7cb8770192c1b5339236dc7f903c6fc2fa18235f52b308fddcd2a638c6c1"
# The preempted sweep: checkpoints every 512 samples, stops after the batch at 768.
RESUME = {"images": 1024, "batch": 256, "checkpoint": 512, "crash_at": 768}
# The bring-your-own path: a JPEG folder encoded on the card (ImageNet-val's common size).
FOLDER = {"images": 2048, "width": 500, "height": 375, "quality": 90, "classes": 4, "batch": 256}
FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "torch_jpeg"
# [formats]: the [folder] path over a folder of every format the JAX ImageFolder reads but WebP ([webp]); 60 s bound
FORMATS = {"images": 2048, "jpeg": 1792, "png": 128, "bmp": 64, "cmyk": 32, "png_as_jpeg": 32, "width": 500,
           "height": 375, "classes": 4, "batch": 256, "bound_s": 60}
FORMAT_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "torch_formats"
# Host decoders built with the kernels (plain C++ with no library, so the card machine's g++ builds them).
HOST_DECODERS = ("webp_lossless", "webp_lossy")
# [webp]: the [folder] path over a folder of copies of the full-width WebP fixtures; 60 s bound
WEBP = {"images": 1024, "lossy": 768, "lossless": 192, "lossy_alpha": 64, "classes": 4, "batch": 256,
        "decodes_alone": 256, "host_decodes_alone": 64, "bound_s": 60}
WEBP_VARIANTS = {"lossy_q75": "webp_lossy_q75_500x375.webp", "lossy_q90": "webp_lossy_q90_500x375.webp",
                 "lossless": "webp_lossless_500x375.webp", "lossy_alpha": "webp_lossy_alpha_500x375.webp",
                 "anim": "webp_anim_500x375.webp"}
# The decode of the fixtures against the JAX package's PIL arrays.
DECODE_BOUNDS = {"mean_abs_levels": 1.5, "psnr_db": 40.0}
# The config-4 relevance path (BASELINE.json config 4, the sizes of tools/bench_relevance_e2e.py;
# sweep at the port's batch of 256).
LRP = {"images": 5000, "size": 224, "layer": "layer3", "n_ref": 8, "sweep_batch": 256, "attr_batch": 256,
       "vit_images": 64}
# float32 ResNet-50 heatmaps (abs-max normalised), card against CPU, per composite: ε and the plain
# gradient tip at near-zero denominators and ReLU inputs (tests/test_torch_relevance.py measured
# 5.2e-5 / 5.3e-3 / 6.7e-3 between the port and the JAX package on the CPU).
LRP_HEAT_ATOL = {"epsilon_plus_flat": 1e-3, "epsilon": 5e-2, "gradient": 5e-2}
LRP_BATCHED_TOL = {"rtol": 1e-4, "atol": 1e-5}  # the JAX package's batched-vs-single test
LRP_CONSERVATION_RTOL = 1e-3  # the JAX package's ViT-block conservation test
LRP_VIT_TOL = {"logits_rel": 1e-3, "heatmap": 1e-3}
# BASELINE config 3 (ViT-B/16 subject, MLP neurons and attention heads, SigLIP2, text probing) at the
# quickstart's sizes; its float32 gates, card against CPU, relative to the largest |value|.
CONFIG3 = {"images": 2048, "batch": 256, "num_samples": 25,
           "components": {"blocks.11.mlp.fc1": 3072, "blocks.11.attn.heads": 12}}
FM_GATE_REL = 1e-4
# The SAE phase: the JAX tools/train_sae.py defaults on ResNet-50 layer3, its audit, and the float32
# card-vs-CPU gates at a small width (parameters and metrics within ``rel`` of the largest magnitude
# after ``steps`` steps; TopK selections agreeing on at least ``topk_rows`` of the rows).
SAE = {"images": 2048, "size": 224, "layer": "layer3", "latents": 8192, "k": 32, "aux_k": 256, "batch": 256,
       "batch_rows": 4096, "positions": 16, "warm_epochs": 4, "aux_images": 1024, "num_samples": 25,
       "code_images": 16}
SAE_GATE = {"d_in": 64, "d_out": 32, "latents": 512, "k": 4, "rows": 1024, "batch_rows": 256, "steps": 5,
            "rel": 1e-5, "topk_rows": 0.99, "code_ids_share": 0.99, "near_tie_rel": 1e-4}
# BASELINE config 5 (tools/full_audit.py): ResNet-50 bf16 → layer1–layer4 → CLIP ViT-B/32 bf16, the JAX
# tool's defaults at 2048 synthetic images (in process, cold then warm) and over a 512-image JPEG
# folder (the CLI in its own process); the float32 gate, card against CPU, on ``gate_images``.
AUDIT5 = {"images": 2048, "folder_images": 512, "gate_images": 16, "gate_samples": 5, "gate_batch": 8,
          "image_queries": [0, 1], "bound_s": 90,
          "db_shapes": {"layer1": [256, 25, 512], "layer2": [512, 25, 512], "layer3": [1024, 25, 512],
                        "layer4": [2048, 25, 512]}}
# The causal path on ResNet-50 float32 layer3: card-vs-CPU gates on ``gate_images``, the necessity ratios of
# the ``components`` strongest components over an evidence sweep of ``images``, and the whole layer's
# ablation profile on ``profile_images``; an SAE / transcoder of ``latents`` (TopK ``k``) drawn from seed 0.
CAUSAL = {"images": 512, "size": 224, "layer": "layer3", "gate_images": 4, "gate_components": 8,
          "patch_components": 4, "components": 32, "evidence": 8, "profile_images": 8, "latents": 1024, "k": 32,
          "bound_s": 45}
# Feature synthesis: the JAX tools/bench_featviz.py defaults (ResNet-50 bf16 layer3 at 224², K = 16 canvases,
# 64 steps), the synthesis visualizer (32 components × 2 variants at max_batch 64) and the float32 gate.
FEATVIZ = {"k": 16, "steps": 64, "layer": "layer3", "size": 224, "cv_components": 32, "cv_variants": 2,
           "max_batch": 64, "gate_canvases": 2, "gate_steps": 4, "bound_s": 60}
# Card-vs-CPU float32 gates of the causal and synthesis phases.
# A Δ is a difference of two float32 forwards: its error scales with the logits, not with |Δ| (float32
# against float64 on these inputs reads 1.4e-5 / 1.1e-4 of the largest |Δ| for zero / mean ablation and
# 7.4e-7 of the logits: precision_float32.py), so Δs and outputs are held to the output scale, the ratios
# (quotients of Δ norms) relative.
CAUSAL_GATE = {"card_vs_cpu_of_output": 1e-5, "necessity_rel": 1e-4, "invariant": 1e-6}
# Synthesis: float32 moves step 1's canvas gradient by ~2e-3 (L2, relative) from float64 while its loss
# moves by ~2e-7, and Adam moves every canvas entry by about lr whatever its gradient's size, so canvases a
# few steps on part far more than the forward (precision_float32.py, on the CPU). The backward's function
# is held in float64, card against CPU; each device's float32 gradient against its own float64 one.
FEATVIZ_GATE = {"step1_loss_rel": 1e-5, "step1_objective_rel": 1e-5, "step1_grad_float64_card_vs_cpu": 1e-8,
                "step1_grad_float32_vs_float64_card": 5e-2, "step1_grad_float32_vs_float64_cpu": 5e-2,
                "steps_objective_rel": 5e-2}
# The LM subjects (ROADMAP item 10): the JAX tools/lm_audit.py workflow at the full width of Llama-3.2-1B
# (bf16, 16 layers, vocab 128256) and GPT-2 (no cut) over the tool's topic corpus at 2048 texts of 64
# tokens with its stand-in tokenizer (codepoints mod vocab, pad id vocab − 1); CLIP ViT-B/32 in float32
# (the tool's dtype) embeds the evidence strings. The text SAE: GPT-2 block 6's MLP (d_in 3072) → 8192
# latents, TopK 32 (AuxK 256, as [sae]), one epoch of the corpus's 131,072 token rows, 4096 per step.
LM = {"texts": 2048, "seq_len": 64, "evidence": 5, "batch": 128, "necessity_components": 32,
      "relevance_rows": 8, "llama": "llama-3.2-1b",
      "llama_layers": ["model.layers.15.mlp.act_fn", "model.layers.15.self_attn.heads"],
      "gpt2_layers": ["transformer.h.11.mlp.act", "transformer.h.11.attn.heads"],
      "sae_layer": "transformer.h.6.mlp.act", "sae_latents": 8192, "sae_k": 32, "sae_aux_k": 256,
      "sae_batch_rows": 4096, "sae_batch": 64, "bound_s": 120,
      "db_shapes": {"model.layers.15.mlp.act_fn": [8192, 5, 512], "model.layers.15.self_attn.heads": [32, 5, 512],
                    "transformer.h.11.mlp.act": [3072, 5, 512], "transformer.h.11.attn.heads": [12, 5, 512],
                    "transformer.h.6.mlp.act.sae": [8192, 5, 512]}}
# Float32 card-vs-CPU gates of every LM family at its published width, depth cut to 2, on 8 left-padded
# rows of 64 tokens (vocabularies real): logits and the audited MLP and heads taps within 1e-5 of each
# one's scale; a left-padded row against its unpadded tokens at the real positions within the same bound;
# the keep-all ablation mask's Δ within CAUSAL_GATE["invariant"] of the logits. Token relevance in bf16 on
# Llama-3.2-1B (bias-free, no position embeddings) conserves the component's summed activation within
# ``conservation_rel`` of its l1 norm over the tokens (ε-plus-flat, ε 1e-6).
LM_GATE = {"rows": 8, "seq_len": 64, "depth": 2, "rel": 1e-5, "conservation_rel": 0.1,
           "families": [("llama-3.2-1b", "Llama", "model.layers.1.mlp.act_fn", "model.layers.1.self_attn.heads"),
                        ("gpt2", "GPT2", "transformer.h.1.mlp.act", "transformer.h.1.attn.heads"),
                        ("gemma-2-2b", "Gemma2", "model.layers.1.mlp.act_fn", "model.layers.1.self_attn.heads"),
                        ("qwen2.5-0.5b", "Qwen2", "model.layers.1.mlp.act_fn", "model.layers.1.self_attn.heads"),
                        ("phi-3-mini-4k", "Phi3", "model.layers.1.mlp.activation_fn",
                         "model.layers.1.self_attn.heads")]}
# The vision zoo (ROADMAP item 8), one phase per half, both run by ``phase_zoo``: the main path is full_audit at
# ``main`` (the JAX tool's default subject of the family, bf16) at AUDIT5's sizes, cold then warm, K1 counted from 0 for
# it alone; then every other family of the half through full_audit at the JAX tool's defaults for its --arch /
# --variant over ``family_images`` (K1 counted apart), each family's first forward timed. The float32 gates hold each
# family at published width card against CPU on ``gate_images`` images (seed-0 weights); ``cli`` runs in processes of
# its own meanwhile. Blocks are ``(label, family, kwargs, make, input shape)``, ``make(model, params)`` giving the
# block's function of its input: ``z_plus_blocks`` take ε-plus-flat relevance (one rule consumed first, as
# mid-network) from non-negative inputs card against CPU, ``conservation_blocks`` Σ relevance at ε 1e-9 on the card.
def _no_taps():
    from semanticlens_tpu_torch.models.base import TapCollector

    return TapCollector(())


def _cl(v):
    return v.contiguous(memory_format=torch.channels_last)


ZOO = {"label": "zoo", "main": ["--arch", "convnext"],
       "images": 2048, "family_images": 512, "gate_images": 2, "size": 224, "bound_s": 150,
       "db_shapes": {"stages.0": [96, 25, 512], "stages.1": [192, 25, 512], "stages.2": [384, 25, 512],
                     "stages.3": [768, 25, 512]},
       "cli": {"full_audit": ["--arch", "densenet"],
               "causal_audit": ["--arch", "mobilenetv2", "--layer", "features.14"]},
       "gates": [("resnet50d", "ResNet", {"depth": 50, "variant": "d"}, ["--variant", "d"]),
                 ("resnext50_32x4d", "ResNet", {"depth": 50, "groups": 32, "width_per_group": 4}, ["--variant", "x"]),
                 ("wide_resnet50_2", "ResNet", {"depth": 50, "width_per_group": 128}, ["--variant", "wide"]),
                 ("vgg16", "VGG", {"depth": 16}, ["--arch", "vgg"]),
                 ("vgg16_bn", "VGG", {"depth": 16, "batch_norm": True}, ["--arch", "vgg"]),
                 ("densenet121", "DenseNet", {"depth": 121}, ["--arch", "densenet"]),
                 ("convnext_tiny", "ConvNeXt", {"variant": "tiny"}, ["--arch", "convnext"]),
                 ("convnext_tiny_torchvision", "ConvNeXt", {"variant": "tiny", "naming": "torchvision"},
                  ["--arch", "convnext"]),
                 ("efficientnet_b0", "EfficientNet", {"variant": "b0"}, ["--arch", "efficientnet"]),
                 ("efficientnet_v2_s", "EfficientNetV2", {"variant": "v2_s"},
                  ["--arch", "efficientnet", "--variant", "v2_s"]),
                 ("mobilenet_v2", "MobileNetV2", {}, ["--arch", "mobilenet"]),
                 ("mobilenet_v3_large", "MobileNetV3", {"variant": "large"}, ["--arch", "mobilenet", "--variant", "large"]),
                 ("mnasnet1_0", "MNASNet", {"variant": "1_0"}, ["--arch", "mnasnet"]),
                 ("regnet_y_400mf", "RegNet", {"variant": "y_400mf"}, ["--arch", "regnet"])],
       "families": [["--variant", "d"], ["--variant", "x"], ["--variant", "wide"], ["--arch", "vgg"],
                    ["--arch", "densenet"], ["--arch", "efficientnet"], ["--arch", "efficientnet", "--variant", "v2_s"],
                    ["--arch", "mobilenet"], ["--arch", "mobilenet", "--variant", "large"],
                    ["--arch", "mobilenet", "--variant", "small"], ["--arch", "mnasnet"], ["--arch", "regnet"]],
       # (family, kwargs, layer): ε-plus-flat and ε heatmaps of components 0 and 1 on gate_images. (EfficientNet-B0's
       # features.6 is not among them: its seed-0 activations are ~1e-10, so its maps are exactly 0 on both.)
       "heatmaps": [("ConvNeXt", {"variant": "tiny"}, "stages.2"), ("EfficientNet", {"variant": "b0"}, "features.3")],
       "z_plus_blocks": [
           ("resnext50_32x4d layer3.0", "ResNet", {"depth": 50, "groups": 32, "width_per_group": 4},
            lambda m, p: lambda v: m._bottleneck_block(p, "layer3.0", _cl(v), 2, _no_taps()), (2, 512, 28, 28)),
           ("mobilenet_v2 features.3", "MobileNetV2", {},
            lambda m, p: lambda v: m._inverted_residual(p, _cl(v), "features.3", m.blocks[2], _no_taps()),
            (2, 24, 56, 56))],
       "conservation_blocks": [
           ("convnext stages.2.blocks.1", "ConvNeXt", {"variant": "tiny"},
            lambda m, p: lambda v: m._block(lambda k: p[k], "stages.2.blocks.1", _cl(v), _no_taps()), (2, 384, 14, 14)),
           ("efficientnet features.6.1", "EfficientNet", {"variant": "b0"},
            lambda m, p: lambda v: m._mbconv(p, _cl(v), "features.6.1", m.stages[5][1], _no_taps()), (2, 192, 7, 7))],
       # heatmaps card against CPU by composite: mean |Δ| over the map's mean |h| (see ZOO_GATE)
       "heat_mean_rel": {"epsilon_plus_flat": 0.1, "epsilon": 1e-3}}
# Zoo gates, card against CPU in float32 (TF32 off): logits and every default full_audit tap within ``rel`` of
# each one's scale. Heatmaps: z⁺ on these families' signed inputs (residual streams, SiLU outputs) makes
# ε-plus-flat ill-conditioned at isolated pixels in both packages: on the CPU the port's float32 abs-max
# normalised heatmaps are 0.028–0.045 (max) from its float64 ones on ConvNeXt-Tiny stages.2 and up to 0.155 on
# EfficientNet-B0 features.3, the JAX package's 0.038–0.071 / 0.011–0.030, while their mean |Δ| is 2e-6–1.1e-4;
# the port's float32 islands (LayerNorm statistics, BN scale) keep a float64 run 0.011–0.018 apart card against
# CPU. So ε-plus-flat heatmaps are held card against CPU by their mean |Δ| over their mean |h| (each half's
# ``heat_mean_rel``: a map's mean |h| is far below its abs-max 1, 8.5e-4 on EfficientNet-B0 features.3) and the z⁺
# rule itself where it is well-conditioned (``z_plus_blocks``) within LRP_HEAT_ATOL["epsilon_plus_flat"] of the
# relevance scale. ε heatmaps are held by their max at LRP_HEAT_ATOL["epsilon"] and by their mean at 1e-3: a
# float32 near-tie in a max-pool window can go the other way on the card, handing that window's relevance to a
# neighbour, so a few pixels of a map move far while the rest agree (GoogLeNet inception4c: the same max with
# cuDNN held deterministic, and float64 runs agree card against CPU; ``precision_heatmaps.py``), and at [zoo]'s
# ε-plus-flat 0.1 TF32 would pass (ConvNeXt-Tiny 0.031, EfficientNet-B0 0.0081 of the mean |h|; sound 5.9e-5 /
# 4.9e-6). For each composite two controls go through the same gate and must break ``heat_mean_rel``, else it
# could not tell a fault from float32 rounding: the card's maps of the other composite against the CPU's (a wrong
# composite), and the card's maps with TF32 on (a precision fault).
ZOO_GATE = {"rel": 1e-5}
ZOO2 = {"label": "zoo2", "main": ["--arch", "swin"],
        "images": 2048, "family_images": 512, "gate_images": 2, "size": 224, "bound_s": 150,
        "db_shapes": {"features.1": [96, 25, 512], "features.3": [192, 25, 512], "features.5": [384, 25, 512],
                      "features.7": [768, 25, 512]},
        "cli": {"full_audit": ["--arch", "inception", "--variant", "v3"],
                "causal_audit": ["--arch", "swin", "--layer", "features.5"]},
        "gates": [("swin_t", "SwinTransformer", {}, ["--arch", "swin"]),
                  ("swin_v2_t", "SwinTransformerV2", {}, ["--arch", "swin_v2"]),
                  ("maxvit_t", "MaxViT", {}, ["--arch", "maxvit"]),
                  ("googlenet", "GoogLeNet", {}, ["--arch", "inception"]),
                  ("inception_v3", "InceptionV3", {}, ["--arch", "inception", "--variant", "v3"]),
                  ("shufflenet_v2_x1_0", "ShuffleNetV2", {}, ["--arch", "shufflenet"]),
                  ("alexnet", "AlexNet", {}, ["--arch", "alexnet"]),
                  ("squeezenet1_0", "SqueezeNet", {}, ["--arch", "squeezenet"]),
                  ("squeezenet1_1", "SqueezeNet", {"version": "1_1"}, ["--arch", "squeezenet", "--variant", "1_1"])],
        "families": [["--arch", "swin_v2"], ["--arch", "maxvit"], ["--arch", "inception"],
                     ["--arch", "inception", "--variant", "v3"], ["--arch", "shufflenet"], ["--arch", "alexnet"],
                     ["--arch", "squeezenet"]],
        "heatmaps": [("SwinTransformer", {}, "features.5"), ("GoogLeNet", {}, "inception4c")],
        "z_plus_blocks": [
            ("googlenet inception4c", "GoogLeNet", {},
             lambda m, p: lambda v: m._inception(p, _cl(v), "inception4c", _no_taps()), (2, 512, 14, 14))],
        "conservation_blocks": [
            ("swin features.5.1", "SwinTransformer", {},
             lambda m, p: lambda v: m._block(p, v, "features.5.1", 12, 3, _no_taps()), (2, 14, 14, 384)),
            ("googlenet inception4c", "GoogLeNet", {},
             lambda m, p: lambda v: m._inception(p, _cl(v), "inception4c", _no_taps()), (2, 512, 14, 14))],
        # ε-plus-flat tighter than [zoo]'s: on these maps TF32 moves the ε-plus-flat heatmaps by 0.098 (Swin-T
        # features.5) and 0.0048 (GoogLeNet inception4c) of their mean |h|, under [zoo]'s 0.1, so that bound could
        # not tell a precision fault from float32 rounding here. The sound card-vs-CPU readings are 1.6e-4 and
        # 1.3e-5, the wrong composite ≈ 1 (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
        "heat_mean_rel": {"epsilon_plus_flat": 1e-3, "epsilon": 1e-3}}
# [mesh] (ROADMAP item 13, the multi-GPU layer) on the one card this machine has: (a) world 1 over NCCL in this
# process — config 5 at [audit]'s sizes through the meshed visualizer and a component-sharded Analyze, the
# data-parallel SAE trainer at [sae]'s widths, Llama-3.2-1B's ``shard_params`` at tp = 1 over 2048 × 64 tokens,
# each equal to its plain run; (b) two gloo ranks sharing the card (NCCL refuses two ranks on one GPU), started
# by ``parallel.launch.spawn``: the meshed engine, ``collect_multihost`` and ``fused_multihost`` at global batch
# 256 against one process at batch 128 (ids and bf16 values equal), the SAE trainer at world 2 against one
# process on the same global minibatches, with two controls that must break the bounds. Two ranks on one card
# measure overhead, not scaling. Tensor parallelism at tp = 2 is not run on the card: DTensor over gloo runs
# no CUDA forward (torch 2.11 on the card: on a "cuda" DeviceMesh a segmentation fault in
# ``_functional_collectives.wait_tensor``, on a "cpu" one the replicated operands land on the CPU;
# ``tp_gloo_probe`` below, PERF.md), and NCCL refuses two ranks on one GPU; tp = 1 over NCCL runs in (a),
# tp = 2 on the CPU tests.
MESH = {"images": 2048, "size": 224, "batch": 256, "rank_batch": 128, "num_samples": 25,
        "layers": ["layer1", "layer2", "layer3", "layer4"],
        "sae_rows": 16384, "sae_d_in": 1024, "sae_latents": 8192, "sae_k": 32, "sae_batch_rows": 4096,
        "sae_steps": 20, "lm_texts": 2048, "lm_seq": 64, "lm_batch": 128, "lm_layer": "model.layers.15.mlp.act_fn",
        "world": 2, "rank_timeout_s": 400, "bound_s": 120}
# The SAE trainer at world 2 against one process (float32, TF32 off), set from the card's readings (PERF.md):
# the step-1 parameters' max |Δ| over their scale (sound 1.2e-4: Adam's first step is ±lr wherever |g| ≫ eps,
# so a gradient near 0 moves by rounding; a skipped gradient all-reduce reads 2.0), step 1's fvu (the same
# parameters: sums in another order only; the rank-mean of fvu ratios moves it by 2.5e-4), and the fvu
# trajectory's max relative gap over the 20 steps (sound 2.1e-4, the rank-mean control 1.1e-3).
MESH_GATE = {"sae_step1_rel": 1e-3, "sae_fvu_step1_rel": 1e-5, "sae_fvu_rel": 5e-4}
PROBE_WORDS = ["dog", "cat", "car", "tree", "bird", "house", "person", "boat"]
TEMPLATES = ["a photo of a {}"]
# The int8 inference path (``ops/quant.py``): W8A8 with dynamic activation scales, ``torch._int_mm`` (cuBLASLt)
# for every product, an int8 im2col for convs. Gates: card against CPU on the same float32 inputs at ViT-B/32's
# linears at batch 256 (256 · 50 rows) and at 5 and 17 rows (``_int_mm``'s > 16-row rule), and at ResNet-50's
# stage convs and ResNeXt-50 32×4d's grouped 3×3s at batch 8: ``x_q`` and the int32 accumulators equal
# exactly. The towers at full width, bf16, batch 256, int8 against float per image (the JAX package's
# cosine 0.995); ResNet-50's pooled layer3/layer4 taps, int8 against bf16, per image (0.99); LRP through the
# int8 ResNet-50 against the dequantized float model at ``[lrp]``'s float32 bounds. Then the quickstart's pool
# (2048 images) through collect and the fused pass with either tower int8, Analyze with K1 on the int8
# concept DB, and ViT-B/32's linears and three ResNet-50 convs at batch 256 split into their passes beside the
# int8 bound and the bf16 product (``split_convs``: (cin, cout, kernel, stride, input side)).
INT8 = {"images": 2048, "batch": 256, "num_samples": 25, "layers": ["layer3", "layer4"], "gate_batch": 8,
        "tokens": 50, "small_rows": [5, 17], "dense": [(768, 2304), (768, 768), (768, 3072), (3072, 768)],
        "split_convs": [(64, 64, 3, 1, 56), (256, 64, 1, 1, 56), (256, 256, 3, 1, 14)],
        "lrp_images": 4, "timed_iters": 20, "bound_s": 60}
# (cin, cout, kernel, stride, input side, groups): ResNet-50's distinct stage convs at 224² (stride 2 on the
# first 3×3 of stages 2–4 and on the downsample), then ResNeXt-50 32×4d's grouped 3×3s of stages 1 and 2.
INT8_CONVS = [(64, 64, 1, 1, 56, 1), (64, 64, 3, 1, 56, 1), (64, 256, 1, 1, 56, 1), (256, 64, 1, 1, 56, 1),
              (256, 128, 1, 1, 56, 1), (128, 128, 3, 2, 56, 1), (256, 512, 1, 2, 56, 1), (128, 512, 1, 1, 28, 1),
              (512, 256, 1, 1, 28, 1), (256, 256, 3, 2, 28, 1), (512, 1024, 1, 2, 28, 1), (1024, 256, 1, 1, 14, 1),
              (256, 256, 3, 1, 14, 1), (1024, 512, 1, 1, 14, 1), (512, 512, 3, 2, 14, 1), (1024, 2048, 1, 2, 14, 1),
              (2048, 512, 1, 1, 7, 1), (512, 512, 3, 1, 7, 1), (512, 2048, 1, 1, 7, 1),
              (128, 128, 3, 1, 56, 32), (256, 256, 3, 2, 56, 32)]
INT8_GATE = {"tower_cosine": 0.995, "pooled_tap_cosine": 0.99}


def log(msg: str):
    print(msg, flush=True)


class TorchvisionBottleneck(torch.nn.Module):
    """torchvision's ``Bottleneck`` (v1.5: the stride on the 3×3 conv), one in-place ReLU for all three."""

    def __init__(self, in_ch: int, width: int, stride: int):
        super().__init__()
        nn = torch.nn
        self.conv1, self.bn1 = nn.Conv2d(in_ch, width, 1, bias=False), nn.BatchNorm2d(width)
        self.conv2, self.bn2 = nn.Conv2d(width, width, 3, stride, 1, bias=False), nn.BatchNorm2d(width)
        self.conv3, self.bn3 = nn.Conv2d(width, width * 4, 1, bias=False), nn.BatchNorm2d(width * 4)
        self.relu = nn.ReLU(inplace=True)
        if stride != 1 or in_ch != width * 4:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, width * 4, 1, stride, bias=False),
                                            nn.BatchNorm2d(width * 4))

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return self.relu(out + identity)


class TorchvisionResNet50(torch.nn.Module):
    """A torchvision-layout ResNet-50 in plain ``torch.nn``: the bring-your-own subject of ``[folder]``.

    Module and parameter names are torchvision's, so its ``state_dict()``
    loads into the port's native ``ResNet`` (``load_torch_state_dict``), and
    the initialization is torchvision's (Kaiming-normal fan-out convs, unit
    BN, PyTorch's default Linear).
    """

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = 64
        for stage, n_blocks in enumerate((3, 4, 6, 3), start=1):
            width = 64 * 2 ** (stage - 1)
            blocks = []
            for b in range(n_blocks):
                blocks.append(TorchvisionBottleneck(in_ch, width, 2 if stage > 1 and b == 0 else 1))
                in_ch = width * 4
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(2048, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(torch.flatten(self.avgpool(x), 1))


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back host calls, by CUDA events.

    Host enqueue time is inside this number wherever it exceeds the work on
    the card (small shapes); :func:`graph_ms` is the device time.
    """
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, inputs: list, launches: int = GRAPH_LAUNCHES, replays: int = 5) -> float:
    """Device time of one ``fn(*args)``: CUDA events around replays of a graph of
    at least ``launches`` calls, the i-th on ``inputs[i % len(inputs)]``."""
    launches = max(launches, len(inputs))
    fn(*inputs[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*inputs[0])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (launches * replays)


def cold_l2_inputs(x, y) -> list:
    """Copies of (x, y) that together hold twice the L2, so that a graph cycling
    through them finds each launch's inputs evicted: they come from HBM."""
    per_copy = 4 * (x.numel() + (0 if y is x else y.numel()))
    copies = []
    for _ in range(math.ceil(2 * L2_BYTES / per_copy)):
        xc = x.clone()
        copies.append((xc, xc if y is x else y.clone()))
    return copies


def phase_build():
    """Every CUDA source (nvcc) and the host WebP decoders (g++), all compiled at once."""
    from semanticlens_tpu_torch.utils import cuda_build

    names = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")) + list(HOST_DECODERS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        for fut in [ex.submit(cuda_build.build, n) for n in names]:
            fut.result()
    for name in names:
        entry = cuda_build.BUILD_LOG[name]
        log(f"[build] {cuda_build.source_path(name).name}: {entry['seconds']:.2f} s")
        for line in entry["compiler_output"].splitlines():
            log(f"[build]   {line}")
        # ptxas C7518: wgmma serialized (a branch touches its accumulators in the K loop)
        if "C7518" in entry["compiler_output"]:
            raise AssertionError(f"{name}.cu: ptxas serializes wgmma (C7518); see the [build] lines")
    log(f"[build] all kernels and host decoders: {time.perf_counter() - t0:.2f} s")


def cosine_bounds_ms(batch, m, n, d) -> dict:
    """K1's three bounds on this card, by name (ms).

    - tf32x3_tensor_core: the dot as three TF32 products (the tiled kernel's
      arithmetic, as precise as fp32) at 495 TFLOP/s;
    - fp32_cuda_core: the dot and both norms in fp32 FMA (the streaming
      kernel's arithmetic) at 67 TFLOP/s;
    - hbm_bytes: each input read once and the output written once at 3.35 TB/s.
    """
    dots = 2.0 * batch * m * n * d
    return {
        "tf32x3_tensor_core": 1e3 * 3 * dots / PEAK_TF32_FLOPS,
        "fp32_cuda_core": 1e3 * (dots + 2.0 * batch * (m + n) * d) / PEAK_FP32_FLOPS,
        "hbm_bytes": 1e3 * 4.0 * batch * (m * d + n * d + m * n) / PEAK_BYTES_PER_S,
    }


def named_bound(variant, bounds) -> tuple[float, str]:
    """The bound of the kernel that ran: its arithmetic's time or the bytes', whichever is larger."""
    ops = bounds["tf32x3_tensor_core" if variant == "tiled" else "fp32_cuda_core"]
    return (ops, "operations") if ops >= bounds["hbm_bytes"] else (bounds["hbm_bytes"], "bytes")


def library_cosine(x, y):
    """One PyTorch formulation of the same function (cuBLAS fp32 matmul + rescale); timed, never used."""
    return torch.matmul(x, y.transpose(-1, -2)) * (
        torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12).reciprocal()
        * torch.linalg.vector_norm(y, dim=-1).clamp_min(1e-12).reciprocal().unsqueeze(-2)
    )


def phase_kernels(dev):
    """K1 against its plain version at the main path's shapes and edge cases; times and bounds."""
    from semanticlens_tpu_torch.ops import cosine as k1

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32)

    def near_duplicate_bank(m, d):  # rows in pairs y, y + 1e-3·noise: redundancy takes its max there
        base = randn(m // 2, d)
        return torch.cat([base, base + 1e-3 * randn(m // 2, d)])

    def wide_norms(m, n, d):  # row norms spread over 1e-3 .. 1e3
        def scale(rows):
            return 10.0 ** (6.0 * torch.rand(rows, 1, generator=gen, device=dev) - 3.0)

        return randn(m, d) * scale(m), randn(n, d) * scale(n)

    def with_zero_rows(m, n, d):
        x, y = randn(m, d), randn(n, d)
        x[::7] = 0.0
        y[::5] = 0.0
        return x, y

    t = k1.STREAMING_MAX_M
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bank = near_duplicate_bank(2048, 512)
    cases = {
        "probe 8x1024x512": (randn(8, 512), randn(1024, 512)),
        "probe 8x2048x512": (randn(8, 512), randn(2048, 512)),
        "redundancy 256x256x512": (randn(256, 512),) * 2,  # the full audit's layer1 and layer2
        "redundancy 512x512x512": (randn(512, 512),) * 2,
        "redundancy 1024x1024x512": (randn(1024, 512),) * 2,
        "redundancy 2048x2048x512": (randn(2048, 512),) * 2,
        "audit 4096x8192x512": (randn(4096, 512), randn(8192, 512)),
        f"threshold M={t} {t}x2048x512": (randn(t, 512), randn(2048, 512)),
        f"past threshold M={t + 1} {t + 1}x1024x512": (randn(t + 1, 512), randn(1024, 512)),
        f"past threshold M*N {t}x2049x512": (randn(t, 512), randn(2049, 512)),
        "near-duplicates 2048x2048x512": (near_duplicate_bank(2048, 512),) * 2,
        # near-parallel rows at large D: the tiled kernel's accumulation must not drift with D
        "near-duplicates D=1280 1024x1024x1280": (near_duplicate_bank(1024, 1280),) * 2,
        "near-duplicates D=4096 1024x1024x4096": (near_duplicate_bank(1024, 4096),) * 2,
        "near-duplicates probe 8x2048x512": (bank[:8] + 1e-3 * randn(8, 512), bank),
        "wide norms 1024x1024x512": wide_norms(1024, 1024, 512),
        "wide norms probe 16x2048x512": wide_norms(16, 2048, 512),
        "zero rows 300x200x512": with_zero_rows(300, 200, 512),
        "zero rows 2x3x32": (torch.zeros(2, 32, device=dev), torch.ones(3, 32, device=dev)),
        "ragged 300x513x130": (randn(300, 130), randn(513, 130)),
        "D=33 probe 5x700x33": (randn(5, 33), randn(700, 33)),
        "D=130 probe 12x513x130": (randn(12, 130), randn(513, 130)),
        "D=513 200x300x513": (randn(200, 513), randn(300, 513)),
        "D=513 probe 8x1000x513": (randn(8, 513), randn(1000, 513)),
        "batched 3x70x90x33": (randn(3, 70, 33), randn(3, 90, 33)),
        "ragged batch 2x130x130x64": (randn(2, 130, 64), randn(2, 130, 64)),
        # the audit-and-serve paths: an audit chunk, labels and soft-WPMI over 1000
        # words, match, /label over 64 components, one text query per layer
        "audit chunk 1024x65536x512": (randn(1024, 512), randn(65536, 512)),
        "labels 1024x1000x512": (randn(1024, 512), randn(1000, 512)),
        "labels 2048x1000x512": (randn(2048, 512), randn(1000, 512)),
        "soft-WPMI chunk 4096x1000x512": (randn(4096, 512), randn(1000, 512)),
        "match 1024x2048x512": (randn(1024, 512), randn(2048, 512)),
        "serve label 64x1000x512": (randn(64, 512), randn(1000, 512)),
        "serve query 1x1024x512": (randn(1, 512), randn(1024, 512)),
        "serve query 1x2048x512": (randn(1, 512), randn(2048, 512)),
        # the bring-your-own path: CLIP RN50 embeds in 1024 dimensions
        "probe 8x1024x1024": (randn(8, 1024), randn(1024, 1024)),
        "probe 8x2048x1024": (randn(8, 1024), randn(2048, 1024)),
        "redundancy 1024x1024x1024": (randn(1024, 1024),) * 2,
        "redundancy 2048x2048x1024": (randn(2048, 1024),) * 2,
        "near-duplicates 2048x2048x1024": (near_duplicate_bank(2048, 1024),) * 2,
        "serve query 1x1024x1024": (randn(1, 1024), randn(1024, 1024)),
        "serve query 1x2048x1024": (randn(1, 1024), randn(2048, 1024)),
        # config 3: SigLIP embeds in 768 dimensions, the first main-path D whose last 512-wide
        # K group is partial; 3,072 MLP neurons and 12 heads of ViT-B/16
        "probe 8x3072x768": (randn(8, 768), randn(3072, 768)),
        "redundancy 3072x3072x768": (randn(3072, 768),) * 2,
        "near-duplicates 3072x3072x768": (near_duplicate_bank(3072, 768),) * 2,
        "labels 3072x1000x768": (randn(3072, 768), randn(1000, 768)),
        "probe 8x12x768": (randn(8, 768), randn(12, 768)),
        "serve query 1x3072x768": (randn(1, 768), randn(3072, 768)),
        # MobileCLIP's head DB and the dissected ViT-B/32 directions (D = 512)
        "probe 8x12x512": (randn(8, 512), randn(12, 512)),
        "labels 3072x1000x512": (randn(3072, 512), randn(1000, 512)),
        "labels 768x1000x512": (randn(768, 512), randn(1000, 512)),
        # the SAE audit: 8,192 latents probed (8·8192 = STREAMING_MAX_MN), labelled and compared
        "probe 8x8192x512": (randn(8, 512), randn(8192, 512)),
        "labels 8192x1000x512": (randn(8192, 512), randn(1000, 512)),
        "redundancy 8192x8192x512": (randn(8192, 512),) * 2,
        # the LM subjects: GPT-2's 3,072 MLP neurons compared, topics against Llama's and GPT-2's neurons
        "redundancy 3072x3072x512": (randn(3072, 512),) * 2,
        "topics 5x8192x512": (randn(5, 512), randn(8192, 512)),
        "topics 5x3072x512": (randn(5, 512), randn(3072, 512)),
        # the vision zoo: ConvNeXt-Tiny's stages.3 bank (the zoo main path's largest), and the 1,280-channel
        # heads of EfficientNet-B0 and MobileNetV2
        "redundancy 768x768x512": (randn(768, 512),) * 2,
        "redundancy 1280x1280x512": (randn(1280, 512),) * 2,
        # the vision zoo, part two: GoogLeNet's inception4e bank (832 channels); its inception5b and ShuffleNet's
        # conv5 are the 1024² case above
        "redundancy 832x832x512": (randn(832, 512),) * 2,
    }
    timed = ("probe 8x1024x512", "probe 8x2048x512", "redundancy 256x256x512", "redundancy 512x512x512",
             "redundancy 1024x1024x512",
             "redundancy 2048x2048x512", "audit 4096x8192x512", "probe 8x2048x1024",
             "redundancy 2048x2048x1024", "probe 8x3072x768", "redundancy 3072x3072x768", "probe 8x8192x512",
             "redundancy 8192x8192x512", "redundancy 3072x3072x512", "redundancy 768x768x512",
             "redundancy 1280x1280x512", "redundancy 832x832x512")
    rows, max_err, checked = [], {"streaming": 0.0, "tiled": 0.0}, set()
    for label, (x, y) in cases.items():
        batch = x.shape[0] if x.ndim == 3 else 1
        m, d = x.shape[-2:]
        n = y.shape[-2]
        checked.add((batch, m, n, d))
        plan = k1.plan_launch(batch, m, n, d, num_sms)
        variant = plan.variant
        out = k1.cosine_similarity_matrix(x, y)
        torch.cuda.synchronize()
        ref = k1.cosine_similarity_matrix_plain(x, y)
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"K1 {label}: shape {tuple(out.shape)} / non-finite output")
        err = float((out - ref).abs().max())
        if not err <= ATOL:
            raise AssertionError(f"K1 {label} ({variant}): max abs err {err:.3g} > {ATOL}")
        max_err[variant] = max(max_err[variant], err)
        row = {"shape": label, "variant": variant, "max_abs_err": err}
        if variant == "tiled":
            row["tile"] = list(k1.TILE_CONFIGS[plan.config])
        if label in timed:
            bounds = cosine_bounds_ms(batch, m, n, d)
            bound, bound_by = named_bound(variant, bounds)
            warm, cold = [(x, y)], cold_l2_inputs(x, y)
            row.update(
                ms=time_ms(lambda x=x, y=y: k1.cosine_similarity_matrix(x, y)),
                plain_ms=time_ms(lambda x=x, y=y: k1.cosine_similarity_matrix_plain(x, y)),
                library_ms=time_ms(lambda x=x, y=y: library_cosine(x, y)),
                device_ms=graph_ms(k1.cosine_similarity_matrix, warm),
                plain_device_ms=graph_ms(k1.cosine_similarity_matrix_plain, warm),
                library_device_ms=graph_ms(library_cosine, warm),
                device_ms_cold_l2=graph_ms(k1.cosine_similarity_matrix, cold),
                library_device_ms_cold_l2=graph_ms(library_cosine, cold),
                device_ms_again=graph_ms(k1.cosine_similarity_matrix, warm),
                bounds_ms=bounds, bound_ms=bound, bound_by=bound_by,
            )
            del cold
            # A bytes bound reads each input once from HBM, as the cold-L2 launches
            # do; an operations bound holds at any cache level.
            row["share_of_bound_cold_l2"] = bound / row["device_ms_cold_l2"]
            if bound_by == "operations":
                row["share_of_bound"] = bound / row["device_ms"]
            y_bytes = 4.0 * batch * n * d
            if y_bytes < L2_BYTES:
                row["note"] = (f"y ({y_bytes / 1e6:.1f} MB) fits in the 50 MB L2: device_ms reads it "
                               "from L2, device_ms_cold_l2 from HBM")
        rows.append(row)
        log(f"[kernels] K1 {json.dumps(row)}")

    # Error against float64 by D on near-parallel rows: the tiled kernel's
    # accumulation must not drift with D.
    for d in (512, 1024, 2048, 4096, 8192):
        bank = near_duplicate_bank(1024, d)
        b64 = bank.double()
        ref = (b64 @ b64.T) / (b64.norm(dim=1, keepdim=True) * b64.norm(dim=1))
        errs = {name: float((fn(bank, bank).double() - ref).abs().max())
                for name, fn in (("kernel", k1.cosine_similarity_matrix),
                                 ("plain", k1.cosine_similarity_matrix_plain))}
        if not errs["kernel"] <= ATOL:
            raise AssertionError(f"K1 near-duplicates D={d}: {errs['kernel']:.3g} from float64 > {ATOL}")
        log(f"[kernels] K1 max abs err vs float64, near-duplicates 1024x1024x{d}: {json.dumps(errs)}")

    return rows, max_err, checked


def k1_redundancy_sha256(dev) -> str:
    """SHA-256 of K1's full matrix (the tiled kernel) for ``K1_REDUNDANCY_SHA256``'s input."""
    from semanticlens_tpu_torch.ops.cosine import cosine_similarity_matrix

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2048, 512), dtype=np.float32)).to(dev)
    return hashlib.sha256(cosine_similarity_matrix(x, x).cpu().numpy().tobytes()).hexdigest()


def k1b_inputs(dev, q, n, d, ties: bool, seed: int = 22):
    """(queries, bank) on the card; with ``ties``: every third bank row a copy of row 1, every third dead (zero),
    one query on the copies' direction, one dead and one opposite."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bank = torch.randn(n, d, generator=gen, device=dev)
    queries = torch.randn(q, d, generator=gen, device=dev)
    if ties:
        bank[4::3] = bank[1]
        bank[2::3] = 0.0
        queries[0], queries[1], queries[2] = bank[1], 0.0, -bank[1]
    return queries, bank


def phase_k1b(dev) -> dict:
    """K1b against the chunked path (bitwise), its plain version and K1's full matrix; counters and times."""
    from semanticlens_tpu_torch import scores
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.utils.profiling import counters, reset

    digest = k1_redundancy_sha256(dev)
    if digest != K1_REDUNDANCY_SHA256:
        raise AssertionError(f"[k1b] K1's full matrix changed: sha256 {digest}, before K1b {K1_REDUNDANCY_SHA256}")
    out = {"k1_redundancy_sha256": digest}
    for name, (q, n, d, k) in K1B.items():
        queries, bank = k1b_inputs(dev, q, n, d, ties=name != "audit")
        if not k1.takes_k1b(dev, q, n, d, k):
            raise AssertionError(f"[k1b] {name}: the search would not take K1b")
        search = functools.partial(scores.topk_cosine_search, queries, bank, k)
        search()  # the build and the first launch
        reset("k1.launches.tiled", "k1.launches.streaming", "search.k1b")
        vals, idx = search()
        torch.cuda.synchronize()
        launched = {key: counters().get(key, 0) for key in ("k1.launches.tiled", "k1.launches.streaming", "search.k1b")}
        if launched != {"k1.launches.tiled": 1, "k1.launches.streaming": 0, "search.k1b": 1}:
            raise AssertionError(f"[k1b] {name}: counters {launched}")
        chunked = functools.partial(scores._chunked_topk, queries, bank, k, AUDIT["chunk"])
        ref_vals, ref_idx = chunked()
        if not (torch.equal(vals, ref_vals) and torch.equal(idx, ref_idx)):
            bad = (vals != ref_vals) | (idx != ref_idx)
            raise AssertionError(f"[k1b] {name}: {int(bad.sum())} of {bad.numel()} entries differ from the chunked "
                                 f"path (rows {bad.any(1).nonzero().flatten()[:8].tolist()}), max value gap "
                                 f"{float((vals - ref_vals).abs().max())}")
        splits = k1.k1b_splits(q, n, k1._num_sms(torch.cuda.current_device()))
        plain = functools.partial(k1.cosine_topk_plain, queries, bank, k, splits)
        plain_vals, _ = plain()
        plain_err = float((vals - plain_vals).abs().max())
        if not plain_err <= ATOL:
            raise AssertionError(f"[k1b] {name}: K1b against its plain version: {plain_err}")
        # The copies' query picks copies only; the dead query's scores all tie at 0: the first k columns.
        if name != "audit" and not (bool((idx[0] % 3 == 1).all()) and idx[1].tolist() == list(range(k))):
            raise AssertionError(f"[k1b] {name}: tied rows picked {idx[0].tolist()} and {idx[1].tolist()}")
        candidates = functools.partial(k1.cosine_topk_candidates, queries, bank, k)
        cold = cold_l2_inputs(queries, bank) if 4 * (q + n) * d < L2_BYTES else [(queries, bank)]
        bounds = cosine_bounds_ms(1, q, n, d)
        row = {
            "shape": [q, n, d, k], "splits": splits, "max_abs_err_vs_plain": plain_err,
            "device_ms": graph_ms(lambda a, b: k1.cosine_topk_candidates(a, b, k), [(queries, bank)]),
            "device_ms_cold_l2": graph_ms(lambda a, b: k1.cosine_topk_candidates(a, b, k), cold),
            "ms": time_ms(search),  # the whole call: K1b, the merge, the host's work
            "merge_ms": time_ms(functools.partial(k1.merge_candidates, *candidates(), k)),
            "chunked_ms": time_ms(chunked, iters=5, warmup=1),
            "plain_ms": time_ms(plain, iters=3, warmup=1),
            "library_ms": time_ms(lambda: torch.topk(library_cosine(queries, bank), k, dim=1), iters=5, warmup=1),
            "bound_ms": bounds["tf32x3_tensor_core"], "bound_by": "operations",
        }
        row["share_of_bound_cold_l2"] = row["bound_ms"] / row["device_ms_cold_l2"]
        out[name] = row
        log(f"[k1b] {name}: {json.dumps(row)}")
        del queries, bank, cold
        torch.cuda.empty_cache()
    return out


def moe_inputs(dev, n, k, e, h, one_expert: bool, seed: int = 24):
    """(y_sorted (N·k, H) bf16, weights (N, k) float32, dispatch) of N tokens routed top-k over E experts by a
    softmax of random scores, as DeepSeek-V2's router weights them; ``one_expert``: every pair to expert 0."""
    from semanticlens_tpu_torch.ops import moe

    gen = torch.Generator(device=dev).manual_seed(seed)
    weights, experts = torch.topk(torch.randn(n, e, generator=gen, device=dev).softmax(-1), k, dim=-1)
    d = moe.dispatch(torch.zeros_like(experts) if one_expert else experts, e)
    return torch.randn(n * k, h, generator=gen, device=dev).bfloat16(), weights, d


def library_combine(y_sorted, w_sorted, d, n):
    """The combine as PyTorch operators, as the port ran it before its kernel (float32 cast, broadcast
    weighting, atomic ``index_add_``, cast back), ``w_sorted`` (P,) the weights in the sorted order; timed, never
    used."""
    out = torch.zeros(n, y_sorted.shape[1], dtype=torch.float32, device=y_sorted.device)
    return out.index_add_(0, d.token, y_sorted.float() * w_sorted[:, None]).to(y_sorted.dtype)


def moe_forward_launches(dev) -> dict:
    """One forward of DeepSeek-V2-Lite at full width, cut to ``MOE_FORWARD``'s depth, on the text sweep's
    16 × 512 tokens: one ``moe.combine.kernel`` launch per MoE layer, read from the forward's own run."""
    from semanticlens_tpu_torch.utils.profiling import counters, reset

    model = lm_subject("deepseek-v2-lite", "DeepseekV2", dev, torch.bfloat16, depth=MOE_FORWARD["depth"])
    params = model.init(0, device_draw=True)
    gen = torch.Generator(device=dev).manual_seed(24)
    toks = torch.randint(0, model.vocab_size - 1, MOE_FORWARD["tokens"], generator=gen, device=dev,
                         dtype=torch.int32)  # no pad id
    moe_layers = sum(model.is_moe(i) for i in range(model.depth))
    with torch.no_grad():
        model.apply(params, toks)  # the build and the first launches
        reset("moe.combine.kernel")
        logits, _ = model.apply(params, toks)
        torch.cuda.synchronize()
    launches = counters().get("moe.combine.kernel", 0)
    row = {"depth": model.depth, "tokens": list(MOE_FORWARD["tokens"]), "moe_layers": moe_layers,
           "launches": launches, "logits_finite": bool(torch.isfinite(logits).all())}
    del model, params, logits
    torch.cuda.empty_cache()
    if launches != moe_layers or moe_layers < 2 or not row["logits_finite"]:
        raise AssertionError(f"[moe] forward: {json.dumps(row)}: not one combine kernel per MoE layer")
    return row


def moe_kernel_entry(rows: dict) -> dict:
    """The combine kernel's row of the ``kernels`` line from :func:`phase_moe`'s rows: the launches of the model
    forward (the only path of this script that runs an MoE layer) and the times at the text sweep's shape."""
    return {"name": "moe_combine", "route": "cuda", "source": "semanticlens_tpu_torch/csrc/moe.cu", "replaces": None,
            "launches": rows["forward"]["launches"],
            "launches_by_path": {"deepseek_v2_forward": rows["forward"]["launches"]},
            **{key: rows["textsweep"][key] for key in (
                "shape", "max_abs_err", "max_bf16_steps", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "library_device_ms", "device_ms_cold_l2", "share_of_bound_cold_l2")}}


def phase_moe(dev) -> dict:
    """The MoE combine kernel against its plain version at ``MOE``'s shapes: one bf16 step of agreement, one
    ``moe.combine.kernel`` a call; at the text sweep's shape its device time warm and cold (CUDA-graph replay),
    the host time, the byte bound, the plain version and the operator chain it replaced (``library_ms``)."""
    from semanticlens_tpu_torch.ops import moe
    from semanticlens_tpu_torch.utils.profiling import counters, reset

    out = {}
    for name, (n, k, e, h, routing) in MOE.items():
        y, weights, d = moe_inputs(dev, n, k, e, h, routing == "one expert")
        combine = functools.partial(moe.combine, y, weights, d, n)
        combine()  # the build and the first launch
        reset("moe.combine.kernel")
        got = combine()
        torch.cuda.synchronize()
        if counters().get("moe.combine.kernel") != 1:
            raise AssertionError(f"[moe] {name}: {counters().get('moe.combine.kernel')} kernel launches for one call")
        exact = moe.combine_plain(y.float(), weights, d, n)
        scale = float(y.float().abs().max() * weights.sum(dim=1).max())
        err = (got.float() - exact).abs()
        steps = float((err / (exact.abs() * 2.0**-7 + scale * 2.0**-20)).max())  # bf16 steps from the float32 sum
        if not steps <= 1.0:
            raise AssertionError(f"[moe] {name}: {steps:.3f} bf16 steps from the float32 sum")
        plain_equal = float((got == moe.combine_plain(y, weights, d, n)).float().mean())
        row = {"shape": [n, k, e, h], "routing": routing, "max_bf16_steps": steps, "max_abs_err": float(err.max()),
               "share_equal_to_plain": plain_equal}
        if name == "textsweep":
            bytes_moved = y.numel() * y.element_size() + n * h * y.element_size() + 2 * 4 * n * k
            cold = [(y, weights, d), (y.clone(), weights, d)]  # each copy past the L2: the rows come from HBM
            w_sorted = weights.reshape(-1)[torch.argsort(d.pos)]  # what the replaced chain gathered in dispatch
            row.update({
                "device_ms": graph_ms(lambda a, b, c: moe.combine(a, b, c, n), [(y, weights, d)]),
                "device_ms_cold_l2": graph_ms(lambda a, b, c: moe.combine(a, b, c, n), cold),
                "ms": time_ms(combine),
                "plain_ms": time_ms(functools.partial(moe.combine_plain, y, weights, d, n), iters=5, warmup=1),
                "library_device_ms": graph_ms(lambda a, b, c: library_combine(a, b, c, n), [(y, w_sorted, d)]),
                "library_ms": time_ms(functools.partial(library_combine, y, w_sorted, d, n), iters=5, warmup=1),
                "bytes": bytes_moved, "bound_ms": 1e3 * bytes_moved / PEAK_BYTES_PER_S, "bound_by": "bytes",
            })
            row["share_of_bound_cold_l2"] = row["bound_ms"] / row["device_ms_cold_l2"]
            del cold, w_sorted
        out[name] = row
        log(f"[moe] {name}: {json.dumps(row)}")
        del y, weights, d, got, exact
        torch.cuda.empty_cache()
    out["forward"] = moe_forward_launches(dev)
    log(f"[moe] forward: {json.dumps(out['forward'])}")
    return out


def kda_inputs(dev, b, t, h, d, dtype, seed: int = 27):
    """(q, k, v, g, beta) as Kimi Linear's KDA layer hands them over: q and k unit-normed (q scaled by d^-½), v
    random, the log decays −A · softplus(f − 4.6) (softplus about 0.01, HF's initial range), beta in (0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def unit(z):
        return z * torch.rsqrt(z.square().sum(-1, keepdim=True))

    q = (unit(torch.randn(b, t, h, d, generator=gen, device=dev)) * d**-0.5).to(dtype)
    k = unit(torch.randn(b, t, h, d, generator=gen, device=dev)).to(dtype)
    v = torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
    g = -3.0 * torch.nn.functional.softplus(torch.randn(b, t, h, d, generator=gen, device=dev) - 4.6)
    return q, k, v, g, torch.rand(b, t, h, generator=gen, device=dev)


def kda_forward_launches(dev) -> dict:
    """One forward of Kimi Linear at full width, cut to ``KDA_FORWARD``'s depth, holding its experts, on the text
    sweep's 4 × 2,048 tokens: one ``kda.kernel`` launch per KDA layer and one ``moe.combine.kernel`` per MoE layer,
    read from the forward's own run."""
    from semanticlens_tpu_torch.models import KimiLinear
    from semanticlens_tpu_torch.utils.profiling import counters, reset

    kw = dict(KimiLinear._HF_VARIANTS["kimi-linear-48b-a3b"], depth=KDA_FORWARD["depth"],
              full_attn_layers=KDA_FORWARD["full_attn_layers"])
    model = KimiLinear(**kw, held_experts=KDA_FORWARD["held_experts"], dtype=torch.bfloat16, device=dev)
    params = model.init(0, device_draw=True)
    gen = torch.Generator(device=dev).manual_seed(27)
    toks = torch.randint(0, model.vocab_size, KDA_FORWARD["tokens"], generator=gen, device=dev, dtype=torch.int32)
    kda_layers = sum(not model.is_mla(i) for i in range(model.depth))
    moe_layers = sum(model.is_moe(i) for i in range(model.depth))
    with torch.no_grad():
        model.apply(params, toks)  # the build and the first launches
        reset("kda.kernel", "moe.combine.kernel")
        logits, _ = model.apply(params, toks)
        torch.cuda.synchronize()
    got = counters()
    row = {"depth": model.depth, "tokens": list(KDA_FORWARD["tokens"]), "kda_layers": kda_layers,
           "kda_launches": got.get("kda.kernel", 0), "moe_layers": moe_layers,
           "combine_launches": got.get("moe.combine.kernel", 0), "logits_finite": bool(torch.isfinite(logits).all())}
    del model, params, logits
    torch.cuda.empty_cache()
    if (row["kda_launches"], row["combine_launches"]) != (kda_layers, moe_layers) or not row["logits_finite"]:
        raise AssertionError(f"[kda] forward: {json.dumps(row)}: not one kernel per KDA and per MoE layer")
    return row


def kda_kernel_entry(rows: dict) -> dict:
    """The recurrence kernel's row of the ``kernels`` line from :func:`phase_kda`'s rows: the launches of the model
    forward and the times at the text sweep's shape."""
    return {"name": "kda_recurrence", "route": "cuda", "source": "semanticlens_tpu_torch/csrc/kda.cu",
            "replaces": None, "launches": rows["forward"]["kda_launches"],
            "launches_by_path": {"kimi_linear_forward": rows["forward"]["kda_launches"]},
            **{key: rows["textsweep"][key] for key in (
                "shape", "max_err_over_scale", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                "device_ms_cold_l2", "share_of_bound_cold_l2")}}


def phase_kda(dev) -> dict:
    """The KDA recurrence kernel against its plain version at ``KDA``'s shapes, one ``kda.kernel`` a call; at the
    text sweep's shape its device time warm and cold (CUDA-graph replay), the host time, the plain loop's time and
    the least time; then the cut model's forward."""
    from semanticlens_tpu_torch.ops import kda
    from semanticlens_tpu_torch.utils.profiling import counters, reset

    out = {}
    for name, (b, t, h, d, dtype) in KDA.items():
        inputs = kda_inputs(dev, b, t, h, d, dtype)
        call = functools.partial(kda.recurrence, *inputs)
        call()  # the build and the first launch
        reset("kda.kernel")
        got = call()
        torch.cuda.synchronize()
        if counters().get("kda.kernel") != 1:
            raise AssertionError(f"[kda] {name}: {counters().get('kda.kernel')} kernel launches for one call")
        t0 = time.perf_counter()
        want = kda.recurrence_plain(*inputs).float()  # every token: the state carried over the whole sequence
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = float((got.float() - want).abs().max() / want.abs().max())
        tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5  # one bf16 rounding of the output; float32 sums
        if not err <= tol:
            raise AssertionError(f"[kda] {name}: error {err:.3g} of the output's scale, above {tol:.3g}")
        row = {"shape": [b, t, h, d], "dtype": str(dtype).removeprefix("torch."), "max_err_over_scale": err}
        if name == "textsweep":
            token_heads = b * t * h
            ops_s, bytes_s = 7 * d * d * token_heads / PEAK_BF16_FLOPS, 2 * (5 * d + 1) * token_heads / PEAK_BYTES_PER_S
            cold = [inputs, tuple(x.clone() for x in inputs)]  # each copy past the L2
            row.update({
                "device_ms": graph_ms(lambda *x: kda.recurrence(*x), [inputs]),
                "device_ms_cold_l2": graph_ms(lambda *x: kda.recurrence(*x), cold),
                "ms": time_ms(call, iters=5, warmup=1),
                "plain_ms": 1e3 * plain_s,
                "bound_ms": 1e3 * max(ops_s, bytes_s), "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            })
            row["share_of_bound_cold_l2"] = row["bound_ms"] / row["device_ms_cold_l2"]
            del cold
        out[name] = row
        log(f"[kda] {name}: {json.dumps(row)}")
        del inputs, got, want
        torch.cuda.empty_cache()
    out["forward"] = kda_forward_launches(dev)
    log(f"[kda] forward: {json.dumps(out['forward'])}")
    return out


@contextlib.contextmanager
def recording_k1_shapes(shapes: set):
    """Add the (batch, M, N, D) of every K1 launch made inside to ``shapes``."""
    from semanticlens_tpu_torch.ops import cosine as k1

    plan_launch = k1.plan_launch

    def recording(batch, m, n, d, num_sms):
        shapes.add((batch, m, n, d))
        return plan_launch(batch, m, n, d, num_sms)

    k1.plan_launch = recording
    try:
        yield
    finally:
        k1.plan_launch = plan_launch


def phase_main_path_shapes(dev, shapes: set, checked: set, max_err: dict):
    """K1 against its plain version at every shape the main paths launched that
    ``phase_kernels`` did not check (data-dependent ones, such as the unique
    evidence rows of soft-WPMI), on seeded random inputs (not counted)."""
    from semanticlens_tpu_torch.ops import cosine as k1

    gen = torch.Generator(device=dev).manual_seed(2)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    extra = sorted(shapes - checked)
    for batch, m, n, d in extra:
        lead = (batch,) if batch > 1 else ()
        x = torch.randn(*lead, m, d, generator=gen, device=dev)
        y = torch.randn(*lead, n, d, generator=gen, device=dev)
        variant = k1.plan_launch(batch, m, n, d, num_sms).variant
        err = float((k1.cosine_similarity_matrix(x, y) - k1.cosine_similarity_matrix_plain(x, y)).abs().max())
        if not err <= ATOL:
            raise AssertionError(f"K1 main-path shape {batch}x{m}x{n}x{d} ({variant}): max abs err {err:.3g} > {ATOL}")
        max_err[variant] = max(max_err[variant], err)
    log(f"[kernels] K1 shapes launched on the main paths: {len(shapes)}, all held against the plain "
        f"version ({len(shapes & checked)} among the cases above, {len(extra)} more: "
        f"{json.dumps([list(e) for e in extra])})")


def _make_images(n, seed=0, size=256):
    return np.random.default_rng(seed).integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


def run_slice(device, dtype, images, num_samples, batch_size, cache_dir):
    """The README quickstart (steps 1–4) through the port's entry points."""
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    times = {}
    t0 = time.perf_counter()
    model = ResNet(depth=50, dtype=dtype, device=device)
    model.params = model.init(seed=0)
    model.name = "resnet50"
    fm = OpenClip("ViT-B-32", dtype=dtype, device=device, seed=0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    times["weights_s"] = time.perf_counter() - t0

    dataset = ArrayDataset(images, name="synthetic-uint8")
    cv = ActivationComponentVisualizer(
        model=model,
        dataset_model=dataset,
        dataset_fm=dataset,
        layer_names=["layer3", "layer4"],
        num_samples=num_samples,
        aggregate_fn=aggregate_conv_mean,
        model_preprocess=make_preprocess_fn(size=224),
        cache_dir=cache_dir,
    )
    lens = Lens(fm)

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        times[key] = time.perf_counter() - t
        return out

    concept_db = timed("collect_embed_s", lambda: lens.compute_concept_db(cv, batch_size=batch_size))
    agg_db = {k: v.mean(1) for k, v in concept_db.items()}
    queries = ["dog", "cat", "car", "tree", "bird", "house", "person", "boat"]
    hits = timed("text_probing_s", lambda: lens.text_probing(queries, agg_db, templates=["a photo of a {}"]))
    clarity = timed("clarity_s", lambda: lens.eval_clarity(concept_db))
    redundancy = timed("redundancy_s", lambda: lens.eval_redundancy(agg_db))
    poly = timed("polysemanticity_s", lambda: lens.eval_polysemanticity(concept_db))
    return {
        "cv": cv,
        "fm": fm,
        "lens": lens,
        "queries": queries,
        "concept_db": concept_db,
        "ids": {k: cv.get_max_reference(k) for k in concept_db},
        "values": {k: cv.actmax_cache[k].activations.float().numpy() for k in concept_db},
        "hits": hits,
        "clarity": {k: v.cpu().numpy() for k, v in clarity.items()},
        "redundancy": {k: float(v) for k, v in redundancy.items()},
        "poly": {k: v.cpu().numpy() for k, v in poly.items()},
        "times": times,
    }


def check_outputs(res, n_images, num_samples, label):
    expect = {"layer3": 1024, "layer4": 2048}
    for layer, c in expect.items():
        db = res["concept_db"][layer]
        if db.shape != (c, num_samples, 512):
            raise AssertionError(f"{label}: concept DB {layer} shape {db.shape}")
        if not np.isfinite(db).all():
            raise AssertionError(f"{label}: concept DB {layer} has non-finite values")
        ids = res["ids"][layer]
        if ids.shape != (c, num_samples) or ids.min() < -1 or ids.max() >= n_images:
            raise AssertionError(f"{label}: ids of {layer} out of range [{ids.min()}, {ids.max()}]")
        if res["hits"][layer].shape != (8, c) or not np.isfinite(res["hits"][layer]).all():
            raise AssertionError(f"{label}: probe scores of {layer}")
        for key in ("clarity", "poly"):
            v = res[key][layer]
            if v.shape != (c,) or not np.isfinite(v).all():
                raise AssertionError(f"{label}: {key} of {layer}")
        if not np.isfinite(res["redundancy"][layer]):
            raise AssertionError(f"{label}: redundancy of {layer}")


def phase_reference(dev):
    """float32 slice on 16 images: the card against the CPU (plain kernel versions).

    Collect+Embed: top-k ids and values and the full embedding table. Analyze:
    the card's scores on the CPU run's concept DB, i.e. on identical inputs
    (a near-tie that orders one top-k slot differently must not look like a
    scoring error). Polysemanticity draws k-means starts from per-device
    random streams, so it is checked for shape and finiteness only.
    """
    images = _make_images(16, seed=1)
    results = {}
    for device in (dev, torch.device("cpu")):
        with tempfile.TemporaryDirectory() as tmp:
            results[device.type] = run_slice(device, torch.float32, images, 5, 8, tmp)
        check_outputs(results[device.type], 16, 5, f"reference[{device.type}]")
    gpu, cpu = results["cuda"], results["cpu"]
    np.testing.assert_allclose(gpu["cv"].embedding_table, cpu["cv"].embedding_table, rtol=1e-3, atol=1e-4)
    cpu_db = cpu["concept_db"]
    cpu_agg = {k: v.mean(1) for k, v in cpu_db.items()}
    lens = gpu["lens"]
    hits = lens.text_probing(gpu["queries"], cpu_agg, templates=["a photo of a {}"])
    clarity = lens.eval_clarity(cpu_db)
    redundancy = lens.eval_redundancy(cpu_agg)
    report = {}
    for layer in ("layer3", "layer4"):
        np.testing.assert_allclose(gpu["values"][layer], cpu["values"][layer], rtol=2**-7, atol=1e-3)
        id_match = float((gpu["ids"][layer] == cpu["ids"][layer]).mean())
        if id_match < 0.98:
            raise AssertionError(f"reference: only {id_match:.3f} of {layer} ids agree with the CPU")
        np.testing.assert_allclose(hits[layer], cpu["hits"][layer], atol=1e-4)
        np.testing.assert_allclose(clarity[layer].cpu().numpy(), cpu["clarity"][layer], atol=1e-5)
        np.testing.assert_allclose(float(redundancy[layer]), cpu["redundancy"][layer], atol=1e-5)
        report[layer] = {"id_match": id_match,
                         "max_probe_diff": float(np.abs(hits[layer] - cpu["hits"][layer]).max())}
    log(f"[reference] cuda vs cpu float32, 16 images: {json.dumps(report)}")


def phase_quickstart(dev):
    from semanticlens_tpu_torch.ops import cosine as k1

    n_images, batch = 2048, 256
    images = _make_images(n_images, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        k1.reset_launch_counts()
        res = run_slice(dev, torch.bfloat16, images, 25, batch, tmp)
        launches = k1.launch_counts()
        check_outputs(res, n_images, 25, "quickstart")
        # probe (8 prompts → streaming) and redundancy (→ tiled) of two layers
        if launches["total"] < 4 or launches["streaming"] < 1 or launches["tiled"] < 1:
            raise AssertionError(f"K1 launches on the main path: {launches}")
        # Steady-state rate of the fused pass, with everything warm (not counted).
        cv, fm = res["cv"], res["fm"]

        def embed_fn(raw):
            return fm.encode_image(fm.preprocess(raw))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cv.engine.run_fused(cv.params, cv.dataset, batch, embed_fn)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    times = res["times"]
    res["warm_s"] = warm_s
    summary = {
        "images": n_images,
        "batch": batch,
        "images_per_s_first_pass": n_images / times["collect_embed_s"],
        "images_per_s_warm_pass": n_images / warm_s,
        "k1_launches": launches,
        **{k: round(v, 4) for k, v in times.items()},
        "redundancy": res["redundancy"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"[quickstart] {json.dumps(summary)}")
    return launches, res


def vocabulary(n: int = 1000) -> list[str]:
    """A synthetic vocabulary of ``n`` distinct words (the hash tokenizer needs no files)."""
    stems = ("dog", "cat", "car", "tree", "bird", "house", "boat", "sky", "road", "flower")
    return [f"{stems[i % len(stems)]} {i // len(stems)}" for i in range(n)]


def dense_topk(x, y, k):
    """Dense K1 + stable descending sort: the reference for every streamed top-k."""
    from semanticlens_tpu_torch.ops.cosine import cosine_similarity_matrix

    vals, idx = torch.sort(cosine_similarity_matrix(x, y), dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def sort_merge(best_vals, best_idx, sim, start):
    """The plain version of ``scores._merge_topk``: a stable descending sort of the
    running state followed by the block of columns [start, start + c), cut to k."""
    k = best_vals.shape[1]
    col = torch.arange(start, start + sim.shape[1], dtype=torch.int32, device=sim.device)
    all_vals = torch.cat([best_vals, sim], dim=1)
    all_idx = torch.cat([best_idx, col[None, :].expand(sim.shape[0], -1)], dim=1)
    vals, order = torch.sort(all_vals, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(all_idx, 1, order[:, :k])


def k1_and_rest_device_ms(fn):
    """Device time of ``fn()`` from a ``torch.profiler`` trace: (K1's kernels, every other kernel) in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    k1_us = rest_us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if "cosine_" in e.key:
            k1_us += us
        else:
            rest_us += us
    if not (k1_us > 0 and rest_us > 0):
        raise AssertionError(f"the profiler saw no device time (K1 {k1_us} us, other kernels {rest_us} us)")
    return k1_us / 1e3, rest_us / 1e3


def phase_analyze(dev, res):
    """README step 5 and the audit scores on the quickstart's DB; K1 counted from 0."""
    from semanticlens_tpu_torch import scores
    from semanticlens_tpu_torch.lens import _embed_vocabulary
    from semanticlens_tpu_torch.ops import cosine as k1

    lens, cv, fm, db = res["lens"], res["cv"], res["fm"], res["concept_db"]
    agg = {k: v.mean(1) for k, v in db.items()}
    words, templates = vocabulary(1000), ["a photo of a {}"]
    evidence = {k: cv.get_max_reference(k) for k in db}
    gen = torch.Generator(device=dev).manual_seed(1)
    n_audit, q_audit, k_audit, chunk = AUDIT["components"], AUDIT["queries"], AUDIT["k"], AUDIT["chunk"]
    audit_bank = torch.randn(n_audit, 512, generator=gen, device=dev)  # 2 GiB of fp32 components
    audit_queries = torch.randn(q_audit, 512, generator=gen, device=dev)
    torch.cuda.synchronize()

    times = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[key] = time.perf_counter() - t
        return out

    k1.reset_launch_counts()
    labels = timed("label_cosine_s", lambda: lens.label_components(words, agg, top_m=5, templates=templates))
    wpmi = timed("label_wpmi_s", lambda: lens.label_components(
        words, agg, top_m=5, templates=templates, scoring="wpmi", evidence_ids=evidence,
        image_embeds=cv.embedding_table))
    match_idx, match_cos = timed("match_s", lambda: scores.match_components(agg["layer3"], agg["layer4"], device=dev))
    coverage = timed("coverage_s", lambda: scores.semantic_coverage(agg["layer3"], agg["layer4"], device=dev))
    drift = timed("drift_s", lambda: {k: scores.drift_score(v, v, device=dev) for k, v in db.items()})
    npi = timed("npi_s", lambda: scores.null_calibrated_polysemanticity(db["layer4"], cv.embedding_table,
                                                                          device=dev))
    audit_vals, audit_idx = timed("audit_topk_s", lambda: scores.topk_cosine_search(
        audit_queries, audit_bank, k_audit, chunk_size=chunk))
    launches = k1.launch_counts()
    # cosine labels 1 and soft-WPMI 2 (dataset mean, evidence rows) per layer, match,
    # coverage, and one for the audit search (K1b)
    if launches["tiled"] < 2 * (1 + 2) + 2 + 1:
        raise AssertionError(f"[analyze] K1 launches: {launches}")

    # Shapes and finiteness.
    for layer in agg:
        c = agg[layer].shape[0]
        for name, (w, v) in (("cosine", labels[layer]), ("wpmi", wpmi[layer])):
            if len(w) != c or any(len(row) != 5 for row in w) or v.shape != (c, 5) or not np.isfinite(v).all():
                raise AssertionError(f"[analyze] {name} labels of {layer}")
        d = drift[layer].cpu().numpy()
        live = np.abs(agg[layer]).sum(1) > 0
        if not (np.isnan(d) == ~live).all() or np.abs(d[live]).max() > 1e-5:
            raise AssertionError(f"[analyze] drift(db, db) of {layer}: max {np.abs(d[live]).max()}")
    if match_idx.shape != (agg["layer3"].shape[0],) or not torch.isfinite(match_cos[match_idx >= 0]).all() or not 0 <= coverage <= 1:
        raise AssertionError("[analyze] match / coverage")
    npi_v, poly, null_mean, null_std = npi
    if npi_v.shape != (agg["layer4"].shape[0],) or not np.isfinite(poly).all() or not np.isfinite([null_mean, null_std]).all():
        raise AssertionError("[analyze] null-calibrated polysemanticity")
    if audit_idx.shape != (q_audit, k_audit) or not torch.isfinite(audit_vals).all():
        raise AssertionError("[analyze] audit top-k")

    # On the card against dense K1 + stable sort (not counted).
    vocab_embeds = _embed_vocabulary(fm, words, templates, 1024)
    for layer in agg:
        bank = torch.as_tensor(agg[layer], device=dev)
        vals, idx = dense_topk(bank, vocab_embeds, 5)
        if labels[layer][0] != [[words[j] for j in row] for row in idx.tolist()]:
            raise AssertionError(f"[analyze] cosine labels of {layer} differ from dense K1 + sort")
        if not np.abs(labels[layer][1] - vals.cpu().numpy()).max() <= 1e-6:
            raise AssertionError(f"[analyze] cosine label scores of {layer}")
    small = audit_bank[: 2 * chunk]
    got_vals, got_idx = scores.topk_cosine_search(audit_queries, small, k_audit, chunk_size=chunk)
    ref_vals, ref_idx = dense_topk(audit_queries, small, k_audit)
    search_err = float((got_vals - ref_vals).abs().max())
    if not torch.equal(got_idx, ref_idx.to(torch.int32)) or search_err > 1e-6:
        raise AssertionError(f"[analyze] topk_cosine_search vs dense K1 + sort: err {search_err}")
    # The merge where duplicated and dead rows tie at the k-th value, chunk by chunk
    # against its plain version on the same K1 blocks.
    tie_bank = audit_bank[:4096].clone()
    tie_bank[::3] = 0.0
    tie_bank[1::3] = tie_bank[1]
    state = plain_state = (torch.full((q_audit, k_audit), -torch.inf, device=dev),
                           torch.full((q_audit, k_audit), -1, dtype=torch.int32, device=dev))
    for start in range(0, tie_bank.shape[0], 1024):
        block = k1.cosine_similarity_matrix(audit_queries, tie_bank[start : start + 1024])
        state = scores._merge_topk(*state, block, start)
        plain_state = sort_merge(*plain_state, block, start)
    if not (torch.equal(state[0], plain_state[0]) and torch.equal(state[1], plain_state[1])):
        raise AssertionError("[analyze] the merge differs from a stable sort merge on tied rows")

    # The split of the audit search's device time, from a trace of the same call.
    k1_ms, merge_ms = k1_and_rest_device_ms(
        lambda: scores.topk_cosine_search(audit_queries, audit_bank, k_audit, chunk_size=chunk))
    # One merge of an audit chunk into the search's state, against its plain version (a
    # stable sort), on the same inputs.
    block = k1.cosine_similarity_matrix(audit_queries, audit_bank[:chunk])
    merged = scores._merge_topk(audit_vals, audit_idx, block, n_audit)
    plain = sort_merge(audit_vals, audit_idx, block, n_audit)
    if not (torch.equal(merged[0], plain[0]) and torch.equal(merged[1], plain[1])):
        raise AssertionError("[analyze] the audit merge differs from a stable sort merge")
    merge_chunk_ms = time_ms(lambda: scores._merge_topk(audit_vals, audit_idx, block, n_audit))
    sort_merge_chunk_ms = time_ms(lambda: sort_merge(audit_vals, audit_idx, block, n_audit))
    summary = {
        "vocabulary": len(words), "k1_launches": launches,
        **{k: round(v, 4) for k, v in times.items()},
        "audit": {"queries": q_audit, "components": n_audit, "dim": audit_bank.shape[1], "k": k_audit, "chunk": chunk,
                  "k1_device_ms": k1_ms, "merge_device_ms": merge_ms, "merge_share": merge_ms / (k1_ms + merge_ms),
                  "merge_chunk_ms": merge_chunk_ms, "sort_merge_chunk_ms": sort_merge_chunk_ms,
                  "k1_bound_ms": cosine_bounds_ms(1, q_audit, n_audit, 512)["tf32x3_tensor_core"]},
        "topk_vs_dense_max_abs_err": search_err,
        "coverage_layer3_in_layer4": coverage,
        "npi": {"null_mean": null_mean, "null_std": null_std, "median": float(np.nanmedian(npi_v))},
    }
    log(f"[analyze] {json.dumps(summary)}")
    del audit_bank
    torch.cuda.empty_cache()
    return launches


def _http_json(url, data=None, method=None):
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _percentiles(ms: list[float]) -> dict:
    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)), "n": len(ms)}


def phase_serve(dev, res):
    """SearchService over the quickstart's DB on loopback; K1 counted from 0 after warm-up."""
    from semanticlens_tpu_torch.lens import text_probing
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.serve import SearchService, serve

    fm = res["fm"]
    agg = {k: v.mean(1) for k, v in res["concept_db"].items()}
    templates = ["a photo of a {}"]
    t0 = time.perf_counter()
    service = SearchService(fm, agg, templates=templates)
    start_s = time.perf_counter() - t0
    server, thread = serve(service, port=0, background=True)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    words = vocabulary(200)
    try:
        k1.reset_launch_counts()
        seq_ms, per_request = [], []
        for i in range(200):
            before = k1.launch_counts()["streaming"]
            t = time.perf_counter()
            status, out = _http_json(f"{base}/text_search?q={urllib.parse.quote(words[i])}&k=5")
            seq_ms.append(1e3 * (time.perf_counter() - t))
            per_request.append(k1.launch_counts()["streaming"] - before)
            if status != 200 or sorted(out["results"]) != ["layer3", "layer4"]:
                raise AssertionError(f"[serve] text_search: {status} {out}")
        if min(per_request) < 2:
            raise AssertionError(f"[serve] K1 streaming launches per text request: {min(per_request)} < 2")

        conc_ms, errors = [], []
        lock = threading.Lock()

        def client(c):
            try:
                for i in range(25):
                    t = time.perf_counter()
                    status, _ = _http_json(f"{base}/text_search?q={urllib.parse.quote(words[(7 * c + i) % 200])}&k=5")
                    with lock:
                        conc_ms.append(1e3 * (time.perf_counter() - t))
                    if status != 200:
                        raise AssertionError(f"status {status}")
            except Exception as exc:  # raised again below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        conc_wall = time.perf_counter() - t
        if errors or len(conc_ms) != 200:
            raise AssertionError(f"[serve] concurrent clients: {errors[:3]}")

        # The layers under a request: the HTTP round trip alone, and the service in-process.
        healthz_ms, inproc_ms = [], []
        for i in range(50):
            t = time.perf_counter()
            _http_json(f"{base}/healthz")
            healthz_ms.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            service.text_search(words[i], k=5)
            inproc_ms.append(1e3 * (time.perf_counter() - t))

        label_url = f"{base}/label?words={urllib.parse.quote(','.join(vocabulary(1000)))}&top_m=3&max_components=64"
        label_ms = []
        for _ in range(2):  # cold (embeds the vocabulary), then cached
            t = time.perf_counter()
            status, out = _http_json(label_url)
            label_ms.append(1e3 * (time.perf_counter() - t))
            if status != 200 or len(out["results"]["layer4"]) != 64 or not out["truncated"]:
                raise AssertionError(f"[serve] label: {status}")
        if _http_json(f"{base}/healthz") != (200, {"ok": True, "layers": ["layer3", "layer4"]}):
            raise AssertionError("[serve] healthz")
        status, out = _http_json(f"{base}/image_search?k=5", data=b"\xff\xd8\xff" + bytes(64), method="POST")
        if status != 400 or "request body" not in out["error"]:
            raise AssertionError(f"[serve] POST /image_search of a broken JPEG: {status} {out}")
        launches = k1.launch_counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    # Served results equal offline probing + stable top-k on the same DB (not counted).
    max_diff = 0.0
    for query in words[:20]:
        served = service.text_search(query, k=5)
        probe = text_probing(fm, query, agg, templates=templates)
        for layer, scores in probe.items():
            order = np.argsort(-scores[0], kind="stable")[:5]
            if served[layer]["ids"] != order.tolist():
                raise AssertionError(f"[serve] {query!r} {layer}: served ids differ from offline probing")
            max_diff = max(max_diff, float(np.abs(np.asarray(served[layer]["scores"]) - scores[0][order]).max()))
    service.close()
    if max_diff > 1e-6:
        raise AssertionError(f"[serve] served scores differ from offline probing by {max_diff}")
    summary = {
        "start_s": round(start_s, 4), "sequential": _percentiles(seq_ms),
        "in_process_text_search": _percentiles(inproc_ms), "http_healthz": _percentiles(healthz_ms),
        "concurrent_8_clients": {**_percentiles(conc_ms), "requests_per_s": 200 / conc_wall},
        "label_1000_words_64_components_ms": {"cold": label_ms[0], "cached": label_ms[1]},
        "k1_streaming_launches_per_text_request": min(per_request), "k1_launches": launches,
        "max_score_diff_vs_offline_probing": max_diff,
    }
    log(f"[serve] {json.dumps(summary)}")
    return launches


class PreemptedSweep:
    """The quickstart's images as a dataset that streams its own batches and raises once it
    has yielded the batch at sample ``crash_at`` (a preempted sweep)."""

    def __init__(self, images, name, crash_at):
        self.images_, self.name, self.crash_at = images, name, crash_at

    def __len__(self):
        return len(self.images_)

    def __getitem__(self, i):
        return self.images_[i], 0

    def iter_batches(self, batch_size, pad_last=True, start_index=0):
        from semanticlens_tpu_torch.data import ArrayDataset, iter_batches

        for batch in iter_batches(ArrayDataset(self.images_), batch_size, start_index=start_index):
            yield batch
            if batch.start_index == self.crash_at:
                raise RuntimeError(f"preempted after the batch at sample {self.crash_at}")


def phase_resume(dev):
    """Fused sweep preempted after sample 768, resumed from its checkpoint at 512, held
    identical to an uninterrupted sweep."""
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    n, batch, every, crash_at = RESUME["images"], RESUME["batch"], RESUME["checkpoint"], RESUME["crash_at"]
    images = _make_images(n, seed=2)
    model = ResNet(depth=50, dtype=torch.bfloat16, device=dev)
    model.params, model.name = model.init(seed=0), "resnet50"
    lens = Lens(OpenClip("ViT-B-32", dtype=torch.bfloat16, device=dev, seed=0))

    def sweep(root, dataset, checkpoint):
        cv = ActivationComponentVisualizer(model, dataset, dataset, ["layer3", "layer4"], 25,
                                           aggregate_fn=aggregate_conv_mean, cache_dir=str(root),
                                           model_preprocess=make_preprocess_fn(size=224))
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            lens.compute_concept_db(cv, batch_size=batch, checkpoint=checkpoint)
        finally:
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
        return cv, seconds

    def outputs(cv):
        return {"ids": {k: cv.get_max_reference(k) for k in cv.layer_names},
                "values": {k: cv.actmax_cache[k].activations.view(torch.int16).numpy() for k in cv.layer_names},
                "table": cv.embedding_table}

    times = {}
    k1.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ref_cv, times["uninterrupted_s"] = sweep(tmp / "ref", ArrayDataset(images, name="resume"), 0)
        ref = outputs(ref_cv)
        _, times["uninterrupted_checkpointed_s"] = sweep(tmp / "ckpt", ArrayDataset(images, name="resume"), every)
        _, times["uninterrupted_again_s"] = sweep(tmp / "again", ArrayDataset(images, name="resume"), 0)
        crashing = PreemptedSweep(images, "resume", crash_at=crash_at)
        try:
            sweep(tmp / "run", crashing, every)
        except RuntimeError as exc:
            if "preempted" not in str(exc):
                raise
        else:
            raise AssertionError("[resume] the preempted sweep did not stop")
        ckpt = next((tmp / "run").rglob("_checkpoint-fused"))
        progress = json.loads((ckpt / "progress.json").read_text())
        if progress["next_start"] != every:
            raise AssertionError(f"[resume] checkpoint at {progress}, expected next_start {every}")
        resumed_cv, times["resumed_s"] = sweep(tmp / "run", ArrayDataset(images, name="resume"), every)
        got = outputs(resumed_cv)
        if ckpt.exists():
            raise AssertionError("[resume] checkpoint directory left after success")
    launches = k1.launch_counts()
    identical = {
        "ids": all(np.array_equal(got["ids"][k], ref["ids"][k]) for k in ref["ids"]),
        "values": all(np.array_equal(got["values"][k], ref["values"][k]) for k in ref["values"]),
        "table": bool(np.array_equal(got["table"], ref["table"])),
    }
    summary = {"images": n, "batch": batch, "checkpoint": every, "crash_after_sample": crash_at,
               "resumed_from": progress["next_start"], "identical": identical, "k1_launches": launches,
               **{k: round(v, 4) for k, v in times.items()}}
    log(f"[resume] {json.dumps(summary)}")
    if not all(identical.values()):
        raise AssertionError(f"[resume] resumed sweep differs from the uninterrupted one: {identical}")
    return launches


def phase_env():
    """What host image decoders would need on this machine (g++, libjpeg, zlib.h, png.h, libwebp), nvJPEG,
    and matplotlib."""
    import ctypes.util

    def headers(name):
        return [p for d in ("/usr/include", "/usr/local/include") if Path(p := f"{d}/{name}").exists()]

    cuda = Path("/usr/local/cuda")
    env = {"gxx": shutil.which("g++"), "libjpeg": ctypes.util.find_library("jpeg"),
           "libturbojpeg": ctypes.util.find_library("turbojpeg"), "jpeglib_h": headers("jpeglib.h"),
           "zlib_h": headers("zlib.h"), "png_h": headers("png.h"), "libwebp": ctypes.util.find_library("webp"),
           "webp_decode_h": headers("webp/decode.h"),
           # the CUDA toolkit's own JPEG decoder, a way round a missing libjpeg
           "nvjpeg": sorted(str(p) for d in ("lib64", "targets/x86_64-linux/lib")
                            for p in (cuda / d).glob("libnvjpeg.so*"))[:1],
           "nvjpeg_h": [str(p) for d in ("include", "targets/x86_64-linux/include")
                        if (p := cuda / d / "nvjpeg.h").exists()][:1]}
    # For information: the port does not use matplotlib (and so does not import it here either).
    spec = importlib.util.find_spec("matplotlib")
    env["matplotlib"] = spec.origin if spec is not None else None
    log(f"[env] {json.dumps(env)}")


def synthetic_scenes(gen, n, h, w, dev) -> torch.Tensor:
    """(n, h, w, 3) uint8 on the card from ``gen``: colour gradients, sharp discs, sensor noise."""
    y = torch.linspace(0.0, 1.0, h, device=dev).view(1, h, 1, 1)
    x = torch.linspace(0.0, 1.0, w, device=dev).view(1, 1, w, 1)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    img = 255 * rand(n, 1, 1, 3) + (255 * rand(n, 1, 1, 3) - 128) * x + (255 * rand(n, 1, 1, 3) - 128) * y
    yy, xx = y * h, x * w
    for _ in range(5):
        cy, cx = h * rand(n, 1, 1, 1), w * rand(n, 1, 1, 1)
        radius = 10 + (min(h, w) / 3) * rand(n, 1, 1, 1)
        img = torch.where((yy - cy) ** 2 + (xx - cx) ** 2 < radius**2, 255 * rand(n, 1, 1, 3), img)
    img = img + 6 * torch.randn(n, h, w, 3, generator=gen, device=dev)
    return img.clamp_(0, 255).round_().to(torch.uint8)


def make_jpeg_folder(dev, root: Path, n: int = FOLDER["images"]) -> dict:
    """``n`` synthetic images encoded with nvJPEG (quality 90, 4:2:0) into a
    class-per-subdirectory folder; returns the encode's numbers."""
    from semanticlens_tpu_torch.data.native_decoder import NvJpegDecoder

    h, w, classes = FOLDER["height"], FOLDER["width"], FOLDER["classes"]
    encoder = NvJpegDecoder(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    total_bytes, t0, chunk = 0, time.perf_counter(), 256
    for start in range(0, n, chunk):
        scenes = synthetic_scenes(gen, min(chunk, n - start), h, w, dev)
        for i in range(scenes.shape[0]):
            index = start + i
            data = encoder.encode(scenes[i], FOLDER["quality"])
            folder = root / f"class_{index * classes // n}"
            folder.mkdir(parents=True, exist_ok=True)
            (folder / f"{index:05d}.jpg").write_bytes(data)
            total_bytes += len(data)
    encoder.close()
    return {"images": n, "size": [w, h], "quality": FOLDER["quality"], "classes": classes,
            "mean_kb": total_bytes / n / 1024, "encode_s": round(time.perf_counter() - t0, 4)}


def check_fixture_decode(dev) -> dict:
    """nvJPEG (planes, then libjpeg's upsampling and colour conversion) and the float32 resize on the
    committed fixtures against the JAX package's PIL arrays at 224: mean |Δ|, max |Δ|, PSNR."""
    from semanticlens_tpu_torch.data import ImageFolder

    ref = np.load(FIXTURES / "pil_224.npz")
    ds = ImageFolder(FIXTURES, image_size=224, device=dev)
    batch = ds.get_batch(0, len(ds)).cpu().numpy()
    report = {}
    for i, (path, _) in enumerate(ds.samples):
        if not np.array_equal(batch[i], ds[i][0]):  # a batch decoded without waiting = one image at a time
            raise AssertionError(f"[folder] {path.name}: get_batch differs from a single decode")
        diff = batch[i].astype(np.float64) - ref[path.name]
        mse = float((diff**2).mean())
        report[path.name] = {"mean_abs": float(np.abs(diff).mean()), "max_abs": float(np.abs(diff).max()),
                             "psnr_db": 10 * math.log10(255.0**2 / max(mse, 1e-12))}
    log(f"[folder] decode vs PIL (JAX ImageFolder(decoder='pil')), image_size 224: {json.dumps(report)}")
    missed = {k: v for k, v in report.items()
              if v["mean_abs"] > DECODE_BOUNDS["mean_abs_levels"] or v["psnr_db"] < DECODE_BOUNDS["psnr_db"]}
    if missed:
        raise AssertionError(f"[folder] decode misses {DECODE_BOUNDS} on {sorted(missed)}")
    return report


def check_truncated_refused(dev) -> str:
    """A fixture with an EXIF thumbnail spliced in (a whole JPEG in APP1, EOI included), cut inside its
    scan: nvJPEG would decode it, the check before it must refuse it; the whole file decodes as the fixture."""
    from semanticlens_tpu_torch.data.native_decoder import JpegError, NvJpegDecoder

    main, thumb = ((FIXTURES / name).read_bytes() for name in ("a_420_500x375.jpg", "e_small_160x120.jpg"))
    tiff = (b"II*\x00" + struct.pack("<IHI", 8, 0, 14)  # IFD0: no entries; IFD1 at 14 locates the thumbnail at 44
            + struct.pack("<HHHIIHHIII", 2, 0x0201, 4, 1, 44, 0x0202, 4, 1, len(thumb), 0) + thumb)
    payload = b"Exif\x00\x00" + tiff
    whole = main[:2] + b"\xff\xe1" + struct.pack(">H", 2 + len(payload)) + payload + main[2:]
    scan = whole.rfind(b"\xff\xda")
    decoder = NvJpegDecoder(dev)
    if not torch.equal(decoder.decode(whole), decoder.decode(main)):
        raise AssertionError("[folder] the thumbnail-bearing file decodes other than the fixture")
    try:
        decoder.decode(whole[: scan + (len(whole) - scan) // 2], "cut.jpg")
    except JpegError as exc:
        return str(exc)
    finally:
        decoder.close()
    raise AssertionError("[folder] nvJPEG path decoded a truncated file with a thumbnail")


def rn50_precision(dev, fm, pre) -> dict:
    """The bf16 RN50 tower against the same weights in float32 on the same batch, with the attention
    pool in bf16 (the tower as it runs) and in float32 on the bf16 trunk."""
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.foundation_models import clip as tclip

    fm32 = OpenClip("RN50", dtype=torch.float32, device=dev, seed=0)
    with torch.inference_mode():
        ref = fm32.encode_image(pre)
        bf16 = fm.encode_image(pre)
        trunk = tclip.resnet_trunk(fm.params, fm.cfg, pre, dtype=torch.bfloat16)
        pool32 = tclip.attention_pool({k: v.float() for k, v in fm.params.items()}, trunk.float())
    del fm32

    def err(e):
        return {"rel_l2": float((e - ref).norm() / ref.norm()),
                "min_cosine": float(torch.nn.functional.cosine_similarity(e, ref).min())}

    return {"pool_bf16": err(bf16), "pool_fp32": err(pool32)}


def phase_folder(dev):
    """The bring-your-own path at full width: a torchvision-layout ResNet-50 ``nn.Module`` through
    ``TorchSubjectModel``, a JPEG ``ImageFolder`` decoded on the card, CLIP RN50; K1 counted from 0."""
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ImageFolder
    from semanticlens_tpu_torch.data.native_decoder import NvJpegDecoder
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.models import ResNet, TorchSubjectModel
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
    from semanticlens_tpu_torch.serve import SearchService, serve
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n, batch = FOLDER["images"], FOLDER["batch"]
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        summary["folder"] = make_jpeg_folder(dev, tmp / "jpegs")
        summary["fixtures"] = check_fixture_decode(dev)
        summary["truncated_with_thumbnail"] = check_truncated_refused(dev)
        ds = ImageFolder(tmp / "jpegs", image_size=224, name="synthetic-jpeg", device=dev)
        if len(ds) != n or len(ds.class_to_idx) != FOLDER["classes"]:
            raise AssertionError(f"[folder] ImageFolder lists {len(ds)} images in {len(ds.class_to_idx)} classes")

        # Decode alone: the worker thread's batches, every one waited for.
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in ds.iter_batches(batch):
            b.ready.synchronize()
        summary["decode_images_per_s"] = n / (time.perf_counter() - t)

        # The subject: a torchvision-layout ResNet-50, seed 0, bf16, through the adapter; the same
        # state dict in the port's native ResNet.
        torch.manual_seed(0)
        module = TorchvisionResNet50().to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
        subject = TorchSubjectModel(module, name="torchvision-resnet50", device=dev)
        native = ResNet(depth=50, dtype=torch.bfloat16, device=dev)
        native_params = native.load_torch_state_dict(module.state_dict())
        summary["subject_params"] = sum(p.numel() for p in module.parameters())
        model_pre = make_preprocess_fn(size=224)
        first = ds.get_batch(0, batch)
        with torch.inference_mode():
            pre = model_pre(first)
            _, a_taps = subject.apply({}, pre, ("layer3", "layer4"))
            _, n_taps = native.apply(native_params, pre, ("layer3", "layer4"))
        taps_report = {}
        for layer in ("layer3", "layer4"):
            a, b_ = a_taps[layer], n_taps[layer].float()
            rel = ((a - b_).abs() / b_.abs().clamp_min(1e-30)).masked_fill((a - b_) == 0, 0.0)
            taps_report[layer] = {"max_rel": float(rel.max()), "equal_share": float((a == b_).float().mean())}
            if a.shape != b_.shape or not torch.allclose(a, b_, rtol=2**-7, atol=0.0):
                raise AssertionError(f"[folder] adapter tap {layer} differs from the native ResNet-50: {taps_report}")
        summary["adapter_vs_native_taps"] = taps_report
        summary["adapter_ms_per_batch"] = time_ms(lambda: subject.apply({}, pre, ("layer3", "layer4")), 5, 2)
        summary["native_ms_per_batch"] = time_ms(lambda: native.apply(native_params, pre, ("layer3", "layer4")), 5, 2)
        del native, native_params, a_taps, n_taps

        fm = OpenClip("RN50", dtype=torch.bfloat16, device=dev, seed=0)
        with torch.inference_mode():
            clip_pre = fm.preprocess(first)
            summary["rn50_ms_per_batch"] = time_ms(lambda: fm.encode_image(clip_pre), 5, 2)
            summary["rn50_precision_64_images"] = rn50_precision(dev, fm, clip_pre[:64])
        del first, pre, clip_pre

        cv = ActivationComponentVisualizer(
            model=subject, dataset_model=ds, dataset_fm=ds, layer_names=["layer3", "layer4"], num_samples=25,
            aggregate_fn=aggregate_conv_mean, model_preprocess=model_pre, cache_dir=str(tmp / "cache"))
        lens = Lens(fm)
        queries, templates = ["dog", "cat", "car", "tree", "bird", "house", "person", "boat"], ["a photo of a {}"]
        fixture = (FIXTURES / "a_420_500x375.jpg").read_bytes()
        k1.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        db = lens.compute_concept_db(cv, batch_size=batch)
        torch.cuda.synchronize()
        summary["fused_pass_cold_s"] = time.perf_counter() - t
        agg = {k: v.mean(1) for k, v in db.items()}
        hits = lens.text_probing(queries, agg, templates=templates)
        redundancy = {k: float(v) for k, v in lens.eval_redundancy(agg).items()}
        plot = cv.visualize_components([0, 1, 2, 3], "layer4", n_samples=9, nrows=3)
        service = SearchService(fm, agg, templates=templates)
        server, thread = serve(service, port=0, background=True)
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/image_search?k=5"
            search_ms, out = [], None
            for _ in range(20):
                t = time.perf_counter()
                status, out = _http_json(url, data=fixture, method="POST")
                search_ms.append(1e3 * (time.perf_counter() - t))
                if status != 200:
                    raise AssertionError(f"[folder] POST /image_search: {status} {out}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        launches = k1.launch_counts()
        decoder = NvJpegDecoder(dev)
        direct = service.image_search(decoder.decode(fixture, "a_420_500x375.jpg"), k=5)
        service.close()
        if out["results"] != direct:
            raise AssertionError("[folder] the uploaded JPEG's results differ from image_search on its decode")

        for layer, c in (("layer3", 1024), ("layer4", 2048)):
            if db[layer].shape != (c, 25, 1024) or not np.isfinite(db[layer]).all():
                raise AssertionError(f"[folder] concept DB {layer}: {db[layer].shape}")
            ids = cv.get_max_reference(layer)
            if ids.min() < -1 or ids.max() >= n:  # -1: an empty slot of a dead component
                raise AssertionError(f"[folder] ids of {layer} out of range [{ids.min()}, {ids.max()}]")
            if hits[layer].shape != (8, c) or not np.isfinite(hits[layer]).all() or not np.isfinite(redundancy[layer]):
                raise AssertionError(f"[folder] probing / redundancy of {layer}")
        png = Path(plot).read_bytes()
        if not png.startswith(b"\x89PNG\r\n\x1a\n") or Path(plot).parent.name != "plots":
            raise AssertionError(f"[folder] visualize_components wrote {plot}")
        width, height = struct.unpack(">II", png[16:24])
        if launches["streaming"] < 1 or launches["tiled"] < 2:
            raise AssertionError(f"[folder] K1 launches on the path: {launches}")

        def embed_fn(raw):
            return fm.encode_image(fm.preprocess(raw))

        torch.cuda.synchronize()
        t = time.perf_counter()
        cv.engine.run_fused(cv.params, ds, batch, embed_fn)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
    summary.update({
        "images_per_s_fused_cold": n / summary["fused_pass_cold_s"], "images_per_s_fused_warm": n / warm_s,
        "image_search_http": _percentiles(search_ms), "plot": {"name": Path(plot).name, "width": width,
                                                               "height": height, "bytes": len(png)},
        "redundancy": redundancy, "k1_launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    })
    log(f"[folder] {json.dumps(summary)}")
    return launches


# --------------------------------------------------------------------------- #
# [formats]: PNG, BMP and four-plane JPEGs on the [folder] path
# --------------------------------------------------------------------------- #
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def png_bytes(samples: np.ndarray, depth: int, colour: int, *, palette: bytes = b"", interlace: bool = False,
              filters=(0, 1, 2, 3, 4)) -> bytes:
    """(H, W, C) samples of 4, 8 or 16 bits → a PNG (stdlib zlib), row r filtered with
    ``filters[r % len(filters)]``, Adam7 on request."""
    bpp = max(1, samples.shape[2] * depth // 8)
    stream = bytearray()
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        flat = sub.reshape(sub.shape[0], -1)
        if depth == 16:
            raw = flat.astype(">u2").view(np.uint8).astype(np.int32)
        elif depth == 4:
            raw = (np.pad(flat, ((0, 0), (0, flat.shape[1] % 2)))[:, 0::2] << 4
                   | np.pad(flat, ((0, 0), (0, flat.shape[1] % 2)))[:, 1::2]).astype(np.int32)
        else:
            raw = flat.astype(np.int32)
        left = np.pad(raw, ((0, 0), (bpp, 0)))[:, : raw.shape[1]]
        up = np.vstack([np.zeros_like(raw[:1]), raw[:-1]])
        up_left = np.pad(up, ((0, 0), (bpp, 0)))[:, : raw.shape[1]]
        p = left + up - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        by_type = np.stack([raw, raw - left, raw - up, raw - (left + up) // 2, raw - paeth])
        types = np.resize(np.asarray(filters), raw.shape[0])
        rows = by_type[types, np.arange(raw.shape[0])] & 255
        stream += np.hstack([types[:, None], rows]).astype(np.uint8).tobytes()
    h, w = samples.shape[:2]
    head = _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace)))
    head += _png_chunk(b"PLTE", palette) if palette else b""
    return (b"\x89PNG\r\n\x1a\n" + head + _png_chunk(b"IDAT", zlib.compress(bytes(stream), 1))
            + _png_chunk(b"IEND", b""))


def bmp_bytes(width: int, height: int, bits: int, pixels: bytes, *, compression: int = 0, table: bytes = b"",
              masks: tuple = (), header: int = 40, top_down: bool = False) -> bytes:
    """A BMP file (INFO or V5 header) around ``pixels``, the rows as stored."""
    info = struct.pack("<IIiHHIIiiII", header, width, -height if top_down else height, 1, bits, compression,
                       len(pixels), 2835, 2835, 0, 0)
    if header > 40:
        info += struct.pack("<4I", *masks) + bytes(header - 56)
        tail = table
    else:
        tail = (struct.pack("<3I", *masks[:3]) if compression == 3 else b"") + table
    start = 14 + len(info) + len(tail)
    return b"BM" + struct.pack("<IHHI", start + len(pixels), 0, 0, start) + info + tail + pixels


def _bmp_rows(rows: np.ndarray, top_down: bool = False) -> bytes:
    padded = np.pad(rows, ((0, 0), (0, -rows.shape[1] % 4)))
    return (padded if top_down else padded[::-1]).tobytes()


def _rle8(rows: np.ndarray) -> bytes:
    """BI_RLE8 of palette indices: runs of equal indices, pairs of single pixels, end of line per row."""
    out = bytearray()
    for row in rows[::-1]:
        starts = np.flatnonzero(np.r_[True, row[1:] != row[:-1]])
        for s, e in zip(starts, np.r_[starts[1:], len(row)]):
            for a in range(s, e, 255):
                out += bytes((min(255, e - a), row[s]))
        out += b"\x00\x00"
    return bytes(out) + b"\x00\x01"


# The [formats] folder's PNG and BMP variants: name → (writer of (RGB uint8 image, generator) → (bytes, the
# RGB PIL decodes it to)). Together they use all five filter types, Adam7, gray, palette, RGBA and 16 bits;
# BMP rows bottom-up and top-down, palette, 5-6-5 bit fields, a V5 header and RLE8.
def _quantize332(rgb):
    idx = (rgb[..., 0] >> 5) << 5 | (rgb[..., 1] >> 5) << 2 | rgb[..., 2] >> 6
    table = np.stack([(np.arange(256) >> 5) * 36, ((np.arange(256) >> 2) & 7) * 36, (np.arange(256) & 3) * 85], -1)
    return idx.astype(np.uint8), table.astype(np.uint8)


def _gray(rgb):
    return ((rgb.astype(np.int32) * (77, 150, 29)).sum(-1) >> 8).astype(np.uint8)


def _png_variants():
    def rgb8(img, g):
        return png_bytes(img, 8, 2), img

    def rgb8_adam7(img, g):
        return png_bytes(img, 8, 2, interlace=True), img

    def gray8_paeth(img, g):
        gray = _gray(img)
        return png_bytes(gray[..., None], 8, 0, filters=(4,)), np.repeat(gray[..., None], 3, -1)

    def palette8(img, g):
        idx, table = _quantize332(img)
        return png_bytes(idx[..., None], 8, 3, palette=table.tobytes()), table[idx]

    def palette4_adam7(img, g):
        idx = _gray(img) >> 4
        table = g.integers(0, 256, (16, 3), dtype=np.uint8)
        return png_bytes(idx[..., None], 4, 3, palette=table.tobytes(), interlace=True), table[idx]

    def rgba8(img, g):
        alpha = g.integers(0, 256, img.shape[:2] + (1,), dtype=np.uint8)
        return png_bytes(np.concatenate([img, alpha], -1), 8, 6, filters=(1, 3)), img

    def rgb16(img, g):
        wide = img.astype(np.int64) << 8 | g.integers(0, 256, img.shape)
        return png_bytes(wide, 16, 2, filters=(2, 4)), img

    def gray16(img, g):  # PIL's I;16 clips at 255 on the way to RGB
        wide = _gray(img).astype(np.int64) * 4
        return png_bytes(wide[..., None], 16, 0), np.repeat(np.minimum(wide, 255)[..., None], 3, -1).astype(np.uint8)

    return [rgb8, rgb8_adam7, gray8_paeth, palette8, palette4_adam7, rgba8, rgb16, gray16]


def _bmp_variants():
    def bgr24(img, g):
        return bmp_bytes(img.shape[1], img.shape[0], 24, _bmp_rows(img[..., ::-1].reshape(img.shape[0], -1))), img

    def bgr24_top_down(img, g):
        h, w = img.shape[:2]
        return bmp_bytes(w, h, 24, _bmp_rows(img[..., ::-1].reshape(h, -1), True), top_down=True), img

    def palette8(img, g):
        idx, table = _quantize332(img)
        quad = np.hstack([table[:, ::-1], np.zeros((256, 1), np.uint8)]).tobytes()
        return bmp_bytes(img.shape[1], img.shape[0], 8, _bmp_rows(idx), table=quad), table[idx]

    def bitfields565(img, g):
        r, gg, b = (img[..., 0] >> 3).astype(np.int32), (img[..., 1] >> 2).astype(np.int32), (img[..., 2] >> 3)
        v = (r << 11 | gg << 5 | b).astype("<u2")
        want = np.stack([r * 255 // 31, gg * 255 // 63, b.astype(np.int32) * 255 // 31], -1).astype(np.uint8)
        return bmp_bytes(img.shape[1], img.shape[0], 16, _bmp_rows(v.view(np.uint8).reshape(img.shape[0], -1)),
                         compression=3, masks=(0xF800, 0x7E0, 0x1F)), want

    def rgba32_v5(img, g):
        h, w = img.shape[:2]
        px = np.concatenate([img, g.integers(0, 256, (h, w, 1), dtype=np.uint8)], -1)
        return bmp_bytes(w, h, 32, _bmp_rows(px.reshape(h, -1)), compression=3, header=124,
                         masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)), img

    def rle8(img, g):  # eight gray levels through a random palette: the flat areas run-length coding is for
        idx = _gray(img) >> 5 << 5
        table = g.integers(0, 256, (256, 3), dtype=np.uint8)
        quad = np.hstack([table[:, ::-1], np.zeros((256, 1), np.uint8)]).tobytes()
        return bmp_bytes(img.shape[1], img.shape[0], 8, _rle8(idx), compression=1, table=quad), table[idx]

    return [bgr24, bgr24_top_down, palette8, bitfields565, rgba32_v5, rle8]


def nvjpeg_four_plane_probe(dev) -> dict:
    """What nvJPEG answers for each committed CMYK, YCCK and RGB-coded fixture asked for
    NVJPEG_OUTPUT_UNCHANGED: its component count and subsampling, the status of the decode and each
    plane's size and mean."""
    from semanticlens_tpu_torch.data.native_decoder import NvJpegDecoder

    decoder, report = NvJpegDecoder(dev), {}
    for path in sorted(FORMAT_FIXTURES.glob("*.jpg")):
        data = path.read_bytes()
        widths, heights, n, css = (ctypes.c_int * 4)(), (ctypes.c_int * 4)(), ctypes.c_int(), ctypes.c_int()
        status = decoder._lib.sl_nvjpeg_info(decoder._ctx, data, len(data), widths, heights, ctypes.byref(n),
                                             ctypes.byref(css))
        entry = {"info_status": status, "components": n.value, "subsampling": css.value,
                 "planes": [[heights[c], widths[c]] for c in range(min(n.value, 4))]}
        if status == 0:
            full = max(h for h, _ in entry["planes"]) * max(w for _, w in entry["planes"])
            planes = [torch.zeros(full, dtype=torch.uint8, device=dev)[: h * w].view(h, w) for h, w in entry["planes"]]
            pointers = (ctypes.c_void_p * len(planes))(*[p.data_ptr() for p in planes])
            pitches = (ctypes.c_int * len(planes))(*[p.stride(0) for p in planes])
            entry["decode_status"] = decoder._lib.sl_nvjpeg_decode_planes(
                decoder._ctx, data, len(data), len(planes), 0, pointers, pitches,
                torch.cuda.current_stream(dev).cuda_stream)
            torch.cuda.synchronize()
            entry["plane_means"] = [round(float(p.float().mean()), 3) for p in planes]
        report[path.name] = entry
    decoder.close()
    return report


def check_format_fixtures(dev) -> dict:
    """Every committed PNG, BMP and CMYK / YCCK / RGB-coded JPEG fixture at full resolution on the card
    against PIL's array: PNG and BMP max |Δ| 0, JPEG within DECODE_BOUNDS."""
    from semanticlens_tpu_torch.data import image_decode
    from semanticlens_tpu_torch.data.native_decoder import NvJpegDecoder

    ref = np.load(FORMAT_FIXTURES / "pil_full.npz")
    decoder, report, missed = NvJpegDecoder(dev), {}, []
    for name in ref.files:
        data = (FORMAT_FIXTURES / name).read_bytes()
        got = image_decode.decode(data, name, dev, nvjpeg=decoder).cpu().numpy()
        diff = got.astype(np.float64) - ref[name]
        mse = float((diff**2).mean())
        entry = {"format": image_decode.sniff(data), "max_abs": float(np.abs(diff).max()),
                 "mean_abs": float(np.abs(diff).mean()), "psnr_db": 10 * math.log10(255.0**2 / max(mse, 1e-12))}
        report[name] = entry
        lossless = entry["format"] != "jpeg"
        if (lossless and entry["max_abs"] != 0) or (not lossless and (
                entry["mean_abs"] > DECODE_BOUNDS["mean_abs_levels"] or entry["psnr_db"] < DECODE_BOUNDS["psnr_db"])):
            missed.append(name)
    decoder.close()
    log(f"[formats] fixtures vs PIL at full resolution: {json.dumps(report)}")
    if missed:
        raise AssertionError(f"[formats] fixture decode misses (lossless exact, JPEG {DECODE_BOUNDS}): {missed}")
    return report


def _write_variant(writer, image: np.ndarray, seed: int, path: Path) -> tuple[int, np.ndarray]:
    data, want = writer(image, np.random.default_rng(seed))
    path.write_bytes(data)
    return len(data), want


def make_mixed_folder(dev, root: Path) -> tuple[dict, dict]:
    """FORMATS' mixed class-per-subdirectory folder: YCbCr JPEGs (nvJPEG, as [folder]), PNG and BMP
    variants (written here), copies of the four-plane fixtures, PNGs under a .JPEG name. Returns
    (numbers, {path: the RGB the file decodes to} for every PNG and BMP)."""
    from semanticlens_tpu_torch.data.native_decoder import NvJpegDecoder

    h, w, n, classes = FORMATS["height"], FORMATS["width"], FORMATS["images"], FORMATS["classes"]
    kinds = (["jpeg"] * FORMATS["jpeg"] + ["png"] * FORMATS["png"] + ["bmp"] * FORMATS["bmp"]
             + ["cmyk"] * FORMATS["cmyk"] + ["png_as_jpeg"] * FORMATS["png_as_jpeg"])
    order = np.random.default_rng(5).permutation(n)  # formats spread over the classes and batches
    four_plane = sorted(p for p in FORMAT_FIXTURES.glob("*.jpg") if not p.name.startswith("rgb"))
    png_writers, bmp_writers = _png_variants(), _bmp_variants()
    encoder, gen = NvJpegDecoder(dev), torch.Generator(device=dev).manual_seed(11)
    expected, sizes, t0, chunk, pending = {}, {k: 0 for k in set(kinds)}, time.perf_counter(), 256, {}
    with ThreadPoolExecutor(8) as pool:  # PNG and BMP files are written on host threads (zlib drops the GIL)
        for start in range(0, n, chunk):
            scenes = synthetic_scenes(gen, min(chunk, n - start), h, w, dev)
            host_scenes = None
            for i in range(scenes.shape[0]):
                index = int(order[start + i])
                kind = kinds[index]
                folder = root / f"class_{(start + i) * classes // n}"
                folder.mkdir(parents=True, exist_ok=True)
                suffix = {"png": ".png", "bmp": ".bmp", "png_as_jpeg": ".JPEG"}.get(kind, ".jpg")
                path = folder / f"{start + i:05d}_{kind}{suffix}"
                if kind in ("png", "bmp", "png_as_jpeg"):
                    if host_scenes is None:
                        host_scenes = scenes.cpu().numpy()
                    writers = bmp_writers if kind == "bmp" else png_writers
                    pending[path] = (kind, pool.submit(_write_variant, writers[index % len(writers)],
                                                       host_scenes[i], index, path))
                    continue
                if kind == "jpeg":
                    data = encoder.encode(scenes[i], FOLDER["quality"])
                else:
                    data = four_plane[index % len(four_plane)].read_bytes()
                path.write_bytes(data)
                sizes[kind] += len(data)
        for path, (kind, future) in pending.items():
            size, expected[path] = future.result()
            sizes[kind] += size
    encoder.close()
    counts = {k: kinds.count(k) for k in sizes}
    return {"images": n, "size": [w, h], "classes": classes, "counts": counts,
            "mean_kb": {k: sizes[k] / counts[k] / 1024 for k in sizes},
            "write_s": round(time.perf_counter() - t0, 4)}, expected


def phase_formats(dev):
    """Every format of the JAX ImageFolder but WebP on the [folder] path at full width; K1 counted from 0."""
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ImageFolder, image_decode
    from semanticlens_tpu_torch.data.native_decoder import NvJpegDecoder
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.models import TorchSubjectModel
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
    from semanticlens_tpu_torch.serve import SearchService, serve
    from semanticlens_tpu_torch.utils import cuda_build, make_preprocess_fn

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    n, batch = FORMATS["images"], FORMATS["batch"]
    summary = {"nvjpeg_four_plane_probe": nvjpeg_four_plane_probe(dev)}
    log(f"[formats] nvJPEG NVJPEG_OUTPUT_UNCHANGED probe: {json.dumps(summary['nvjpeg_four_plane_probe'])}")
    summary["fixtures"] = check_format_fixtures(dev)
    summary["png_cpu_build_s"] = cuda_build.BUILD_LOG["png_cpu"]["seconds"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        summary["folder"], expected = make_mixed_folder(dev, tmp / "mixed")
        ds = ImageFolder(tmp / "mixed", image_size=224, name="synthetic-mixed", device=dev)
        if len(ds) != n or len(ds.class_to_idx) != FORMATS["classes"]:
            raise AssertionError(f"[formats] ImageFolder lists {len(ds)} images in {len(ds.class_to_idx)} classes")
        by_kind = {}
        for path, _ in ds.samples:
            by_kind.setdefault(path.stem.split("_", 1)[1], []).append(path)

        # Decode alone, per format, at full resolution (the first 256 YCbCr JPEGs; every other file), then
        # each PNG and BMP held to the RGB it was written from.
        rates, decoder, outputs = {}, NvJpegDecoder(dev), {}
        for kind, paths in sorted(by_kind.items()):
            paths = paths[:256]
            blobs = [p.read_bytes() for p in paths]
            torch.cuda.synchronize()
            t = time.perf_counter()
            images = [image_decode.decode(b, p.name, dev, nvjpeg=decoder) for b, p in zip(blobs, paths)]
            torch.cuda.synchronize()
            rates[kind] = len(paths) / (time.perf_counter() - t)
            outputs.update((p, im) for p, im in zip(paths, images) if p in expected)
        summary["decode_images_per_s_alone"] = rates
        wrong = [p.name for p, want in expected.items()
                 if not torch.equal(outputs[p], torch.from_numpy(np.ascontiguousarray(want)).to(dev))]
        summary["lossless_files_exact"] = f"{len(expected) - len(wrong)} of {len(expected)}"
        if wrong:
            raise AssertionError(f"[formats] {len(wrong)} PNG / BMP files decode other than written: {wrong[:8]}")
        del expected, outputs, images
        # The sweep's own decode (worker thread, decode + resize to 224), every batch waited for, no model.
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in ds.iter_batches(batch):
            b.ready.synchronize()
        summary["decode_images_per_s_worker"] = n / (time.perf_counter() - t)

        torch.manual_seed(0)
        module = TorchvisionResNet50().to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
        subject = TorchSubjectModel(module, name="torchvision-resnet50", device=dev)
        fm = OpenClip("RN50", dtype=torch.bfloat16, device=dev, seed=0)
        cv = ActivationComponentVisualizer(
            model=subject, dataset_model=ds, dataset_fm=ds, layer_names=["layer3", "layer4"], num_samples=25,
            aggregate_fn=aggregate_conv_mean, model_preprocess=make_preprocess_fn(size=224),
            cache_dir=str(tmp / "cache"))
        lens = Lens(fm)
        decoded, names, lock, decode = {}, set(), threading.Lock(), image_decode.decode

        def counting(data, name, device, nvjpeg=None):  # every decode of the sweep, by format and by file
            image = decode(data, name, device, nvjpeg=nvjpeg)
            with lock:
                kind = image_decode.sniff(data)
                decoded[kind] = decoded.get(kind, 0) + 1
                names.add(name)
            return image

        k1.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with patched(image_decode, decode=counting):
            db = lens.compute_concept_db(cv, batch_size=batch)
        torch.cuda.synchronize()
        summary["fused_pass_cold_s"] = time.perf_counter() - t
        summary["decoded_in_sweep"] = decoded
        missing = {str(p) for p, _ in ds.samples} - names
        if missing:
            raise AssertionError(f"[formats] the sweep decoded {decoded} and missed {len(missing)} files")
        agg = {k: v.mean(1) for k, v in db.items()}
        hits = lens.text_probing(PROBE_WORDS, agg, templates=TEMPLATES)
        redundancy = {k: float(v) for k, v in lens.eval_redundancy(agg).items()}
        for layer, c in (("layer3", 1024), ("layer4", 2048)):
            if db[layer].shape != (c, 25, 1024) or not np.isfinite(db[layer]).all():
                raise AssertionError(f"[formats] concept DB {layer}: {db[layer].shape}")
            ids = cv.get_max_reference(layer)
            if ids.min() < -1 or ids.max() >= n:
                raise AssertionError(f"[formats] ids of {layer} out of range [{ids.min()}, {ids.max()}]")
            if hits[layer].shape != (8, c) or not np.isfinite(hits[layer]).all():
                raise AssertionError(f"[formats] probing of {layer}")

        # Uploads: a PNG, a BMP and a four-plane JPEG of the folder through POST /image_search, each equal to
        # the in-process search on the same bytes' decode.
        service = SearchService(fm, agg, templates=TEMPLATES)
        server, thread = serve(service, port=0, background=True)
        uploads, decoder = {}, NvJpegDecoder(dev)
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/image_search?k=5"
            for kind in ("png", "bmp", "cmyk"):
                path = by_kind[kind][0]
                data = path.read_bytes()
                t = time.perf_counter()
                status, out = _http_json(url, data=data, method="POST")
                ms = 1e3 * (time.perf_counter() - t)
                if status != 200:
                    raise AssertionError(f"[formats] POST /image_search with {path.name}: {status} {out}")
                direct = service.image_search(image_decode.decode(data, path.name, dev, nvjpeg=decoder), k=5)
                if out["results"] != direct:
                    raise AssertionError(f"[formats] the uploaded {kind} differs from image_search on its decode")
                uploads[kind] = {"file": path.name, "ms": ms}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            service.close()
            decoder.close()
        launches = k1.launch_counts()
        if launches["streaming"] < 1 or launches["tiled"] < 2:
            raise AssertionError(f"[formats] K1 launches on the path: {launches}")

        def embed_fn(raw):
            return fm.encode_image(fm.preprocess(raw))

        torch.cuda.synchronize()
        t = time.perf_counter()
        cv.engine.run_fused(cv.params, ds, batch, embed_fn)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
    summary.update({
        "images_per_s_fused_cold": n / summary["fused_pass_cold_s"], "images_per_s_fused_warm": n / warm_s,
        "uploads": uploads, "redundancy": redundancy, "k1_launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "phase_s": time.perf_counter() - t_phase, "bound_s": FORMATS["bound_s"],
    })
    summary["within_bound"] = summary["phase_s"] <= FORMATS["bound_s"]
    log(f"[formats] {json.dumps(summary)}")
    return launches


def webp_fixture_refs() -> dict:
    """name → {"shape", "sha256"} of PIL's RGB array of each committed WebP fixture (written where PIL is)."""
    return json.loads((FORMAT_FIXTURES / "pil_webp_sha256.json").read_text())


def sha256_of(image: torch.Tensor) -> str:
    return hashlib.sha256(np.ascontiguousarray(image.cpu().numpy()).tobytes()).hexdigest()


def check_webp_fixtures(dev) -> dict:
    """Every committed WebP fixture decoded on the card at full resolution, exactly PIL's array (its SHA-256)."""
    from semanticlens_tpu_torch.data import image_decode

    refs = webp_fixture_refs()
    missed = []
    for name, ref in refs.items():
        got = image_decode.decode((FORMAT_FIXTURES / name).read_bytes(), name, dev)
        if got.device.type != dev.type or list(got.shape) != ref["shape"] or sha256_of(got) != ref["sha256"]:
            missed.append(name)
    report = {"fixtures": len(refs), "exact": len(refs) - len(missed)}
    log(f"[webp] fixtures vs PIL at full resolution: {json.dumps(report)}")
    if missed:
        raise AssertionError(f"[webp] fixtures that decode other than PIL's array on the card: {missed}")
    return report


def make_webp_folder(root: Path) -> dict:
    """WEBP's class-per-subdirectory folder of copies of the full-width fixtures: lossy (q75 and q90 in turn),
    lossless and lossy with alpha, spread over the classes and batches."""
    n, classes = WEBP["images"], WEBP["classes"]
    kinds = ["lossy"] * WEBP["lossy"] + ["lossless"] * WEBP["lossless"] + ["lossy_alpha"] * WEBP["lossy_alpha"]
    order = np.random.default_rng(7).permutation(n)
    blobs = {k: (FORMAT_FIXTURES / v).read_bytes() for k, v in WEBP_VARIANTS.items()}
    counts, sizes = {}, {}
    for i in range(n):
        kind = kinds[int(order[i])]
        variant = ("lossy_q75", "lossy_q90")[i % 2] if kind == "lossy" else kind
        folder = root / f"class_{i * classes // n}"
        folder.mkdir(parents=True, exist_ok=True)
        (folder / f"{i:05d}_{variant}.webp").write_bytes(blobs[variant])
        counts[variant] = counts.get(variant, 0) + 1
        sizes[variant] = len(blobs[variant])
    return {"images": n, "classes": classes, "counts": counts, "kb": {k: v / 1024 for k, v in sizes.items()}}


def phase_webp(dev):
    """WebP on the [folder] path at full width: fixtures exact on the card, decode alone per variant, the
    fused RN50 sweep over 1024 files cold and warm, and WebP uploads; K1 counted from 0."""
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ImageFolder, image_decode, webp
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.models import TorchSubjectModel
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
    from semanticlens_tpu_torch.serve import SearchService, serve
    from semanticlens_tpu_torch.utils import cuda_build, make_preprocess_fn

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    n, batch, reps, host_reps = WEBP["images"], WEBP["batch"], WEBP["decodes_alone"], WEBP["host_decodes_alone"]
    summary = {"build_s": {name: cuda_build.BUILD_LOG[name]["seconds"] for name in HOST_DECODERS},
               "fixtures": check_webp_fixtures(dev)}

    # Decode alone per variant at 500×375: the host bitstream decode by itself, then the whole decode
    # (container, bitstream, one upload, conversion on the card), every output equal to the first, whose
    # SHA-256 was PIL's above.
    refs = webp_fixture_refs()
    rates, host_rates, wrong = {}, {}, []
    for variant, name in WEBP_VARIANTS.items():
        data = (FORMAT_FIXTURES / name).read_bytes()
        want = image_decode.decode(data, name, dev)
        if sha256_of(want) != refs[name]["sha256"]:
            raise AssertionError(f"[webp] {name} decodes other than PIL's array")
        header = webp.read_header(data, name)
        w, h, bits = header.frame.width, header.frame.height, header.bitstream()
        host = webp.decode_lossless if header.lossless else webp.decode_lossy
        t = time.perf_counter()
        for _ in range(host_reps):
            host(bits, w, h, name)
        host_rates[variant] = host_reps / (time.perf_counter() - t)
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = [image_decode.decode(data, name, dev) for _ in range(reps)]
        torch.cuda.synchronize()
        rates[variant] = reps / (time.perf_counter() - t)
        wrong += [f"{variant}#{i}" for i, out in enumerate(outs) if not torch.equal(out, want)]
        del outs
    summary.update({"decode_images_per_s_alone": rates, "host_bitstream_images_per_s": host_rates,
                    "decodes_alone_exact": f"{len(WEBP_VARIANTS) * reps - len(wrong)} of {len(WEBP_VARIANTS) * reps}"})
    if wrong:
        raise AssertionError(f"[webp] {len(wrong)} repeated decodes differ from the first: {wrong[:8]}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        summary["folder"] = make_webp_folder(tmp / "webp")
        ds = ImageFolder(tmp / "webp", image_size=224, name="synthetic-webp", device=dev)
        if len(ds) != n or len(ds.class_to_idx) != WEBP["classes"]:
            raise AssertionError(f"[webp] ImageFolder lists {len(ds)} images in {len(ds.class_to_idx)} classes")
        # The sweep's own decode (worker thread, decode + resize to 224), every batch waited for, no model.
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in ds.iter_batches(batch):
            b.ready.synchronize()
        summary["decode_images_per_s_worker"] = n / (time.perf_counter() - t)

        torch.manual_seed(0)
        module = TorchvisionResNet50().to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
        subject = TorchSubjectModel(module, name="torchvision-resnet50", device=dev)
        fm = OpenClip("RN50", dtype=torch.bfloat16, device=dev, seed=0)
        cv = ActivationComponentVisualizer(
            model=subject, dataset_model=ds, dataset_fm=ds, layer_names=["layer3", "layer4"], num_samples=25,
            aggregate_fn=aggregate_conv_mean, model_preprocess=make_preprocess_fn(size=224),
            cache_dir=str(tmp / "cache"))
        lens = Lens(fm)
        decoded, names, lock, decode = {}, set(), threading.Lock(), image_decode.decode

        def counting(data, name, device, nvjpeg=None):  # every decode of the sweep, by format and by file
            image = decode(data, name, device, nvjpeg=nvjpeg)
            with lock:
                kind = image_decode.sniff(data)
                decoded[kind] = decoded.get(kind, 0) + 1
                names.add(name)
            return image

        k1.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with patched(image_decode, decode=counting):
            db = lens.compute_concept_db(cv, batch_size=batch)
        torch.cuda.synchronize()
        summary["fused_pass_cold_s"] = time.perf_counter() - t
        summary["decoded_in_sweep"] = decoded
        missing = {str(p) for p, _ in ds.samples} - names
        if missing or set(decoded) != {"webp"}:
            raise AssertionError(f"[webp] the sweep decoded {decoded} and missed {len(missing)} files")
        agg = {k: v.mean(1) for k, v in db.items()}
        hits = lens.text_probing(PROBE_WORDS, agg, templates=TEMPLATES)
        redundancy = {k: float(v) for k, v in lens.eval_redundancy(agg).items()}
        for layer, c in (("layer3", 1024), ("layer4", 2048)):
            if db[layer].shape != (c, 25, 1024) or not np.isfinite(db[layer]).all():
                raise AssertionError(f"[webp] concept DB {layer}: {db[layer].shape}")
            ids = cv.get_max_reference(layer)
            if ids.min() < -1 or ids.max() >= n:
                raise AssertionError(f"[webp] ids of {layer} out of range [{ids.min()}, {ids.max()}]")
            if hits[layer].shape != (8, c) or not np.isfinite(hits[layer]).all():
                raise AssertionError(f"[webp] probing of {layer}")

        # Uploads: a lossy and a lossless WebP through POST /image_search, each equal to the in-process
        # search on the same bytes' decode.
        service = SearchService(fm, agg, templates=TEMPLATES)
        server, thread = serve(service, port=0, background=True)
        uploads = {}
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/image_search?k=5"
            for variant in ("lossy_q75", "lossless"):
                name = WEBP_VARIANTS[variant]
                data = (FORMAT_FIXTURES / name).read_bytes()
                t = time.perf_counter()
                status, out = _http_json(url, data=data, method="POST")
                ms = 1e3 * (time.perf_counter() - t)
                if status != 200:
                    raise AssertionError(f"[webp] POST /image_search with {name}: {status} {out}")
                if out["results"] != service.image_search(image_decode.decode(data, name, dev), k=5):
                    raise AssertionError(f"[webp] the uploaded {variant} differs from image_search on its decode")
                uploads[variant] = {"file": name, "ms": ms}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            service.close()
        launches = k1.launch_counts()
        if launches["streaming"] < 1 or launches["tiled"] < 2:
            raise AssertionError(f"[webp] K1 launches on the path: {launches}")

        def embed_fn(raw):
            return fm.encode_image(fm.preprocess(raw))

        torch.cuda.synchronize()
        t = time.perf_counter()
        cv.engine.run_fused(cv.params, ds, batch, embed_fn)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
    summary.update({
        "images_per_s_fused_cold": n / summary["fused_pass_cold_s"], "images_per_s_fused_warm": n / warm_s,
        "uploads": uploads, "redundancy": redundancy, "k1_launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "phase_s": time.perf_counter() - t_phase, "bound_s": WEBP["bound_s"],
    })
    summary["within_bound"] = summary["phase_s"] <= WEBP["bound_s"]
    log(f"[webp] {json.dumps(summary)}")
    return launches


def imagenet_preprocess_as_input(x):
    """:func:`imagenet_preprocess` for float pixels, in their own dtype (float64 in the precision gates)."""
    from semanticlens_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

    mean = torch.tensor(IMAGENET_MEAN, device=x.device, dtype=x.dtype)
    std = torch.tensor(IMAGENET_STD, device=x.device, dtype=x.dtype)
    return (x / 255.0 - mean) / std


def batch_norm_any_dtype(x, weight, bias, running_mean, running_var, *, eps=1e-5):
    """The port's inference batch norm, with float64 statistics for a float64 ``x`` (the port's casts
    them to float32, so a float64 zoo model runs only with this in place of ``zoo.batch_norm``)."""
    from semanticlens_tpu_torch.models import layers

    if x.dtype != torch.float64:
        return layers.batch_norm(x, weight, bias, running_mean, running_var, eps=eps)
    return torch.nn.functional.batch_norm(x, running_mean.double(), running_var.double(), weight.double(),
                                          bias.double(), training=False, eps=eps)


def imagenet_preprocess(x):
    """uint8 (or float 0–255) NHWC pixels → ImageNet-normalized float32, as the config-4 tool does."""
    from semanticlens_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x.to(torch.float32) / 255.0 - mean) / std


class StageTimer:
    """Synchronised wall time of wrapped calls, summed per stage."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    def wrap(self, stage: str, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[stage] = self.seconds.get(stage, 0.0) + time.perf_counter() - t
            return out

        return timed


def crop_boxes(heat):
    from semanticlens_tpu_torch.utils import render

    return render._square_crop_boxes(render._filtered_heat(heat.float(), 51), 0.01)


def lrp_conservation(dev) -> dict:
    """ε composite in float32 on the card: Σ R_in against Σ R_out through one ResNet-50 bottleneck
    (layer3.0, with its projection shortcut) and one ViT-B/16 block, R_out seeded as the output."""
    from semanticlens_tpu_torch.models import ResNet, VisionTransformer
    from semanticlens_tpu_torch.models import layers as L

    def conserved(fn, x):
        xx = x.clone().requires_grad_(True)
        with L.lrp_composite("epsilon", epsilon=1e-9):
            out = fn(xx)
        (r_in,) = torch.autograd.grad(out, xx, out.detach())
        return float(r_in.double().sum()), float(out.detach().double().sum())

    gen = torch.Generator(device=dev).manual_seed(5)
    resnet = ResNet(depth=50, dtype=torch.float32, device=dev)
    rp = resnet.init(seed=0)
    x = torch.relu(torch.randn(2, 512, 28, 28, generator=gen, device=dev)).contiguous(memory_format=torch.channels_last)
    block = conserved(lambda xx: resnet._bottleneck_block(rp, "layer3.0", xx, 2, lambda _, v: v), x)

    vit = VisionTransformer(dtype=torch.float32, device=dev)
    vp, p, w = vit.init(seed=0), "blocks.0", vit.width

    def vit_block(xx):
        h = L.layer_norm(xx, vp[f"{p}.norm1.weight"], vp[f"{p}.norm1.bias"], eps=vit.LN_EPS)
        qkv = L.linear(h, vp[f"{p}.attn.qkv.weight"], vp[f"{p}.attn.qkv.bias"])
        h = L.scaled_dot_product_attention(qkv[..., :w], qkv[..., w : 2 * w], qkv[..., 2 * w :], vit.heads)
        xx = L.residual_add(xx, L.linear(h, vp[f"{p}.attn.proj.weight"], vp[f"{p}.attn.proj.bias"]))
        h = L.layer_norm(xx, vp[f"{p}.norm2.weight"], vp[f"{p}.norm2.bias"], eps=vit.LN_EPS)
        h = L.gelu(L.linear(h, vp[f"{p}.mlp.fc1.weight"], vp[f"{p}.mlp.fc1.bias"]))
        return L.residual_add(xx, L.linear(h, vp[f"{p}.mlp.fc2.weight"], vp[f"{p}.mlp.fc2.bias"]))

    vblock = conserved(vit_block, torch.randn(2, 197, w, generator=gen, device=dev))
    report = {}
    for name, (r_in, r_out) in (("bottleneck layer3.0", block), ("vit-b/16 block 0", vblock)):
        rel = abs(r_in - r_out) / abs(r_out)
        if not rel <= LRP_CONSERVATION_RTOL:
            raise AssertionError(f"[lrp] {name}: sum R_in {r_in:.6g} vs sum R_out {r_out:.6g} (rel {rel:.3g})")
        report[name] = {"sum_r_in": r_in, "sum_r_out": r_out, "rel": rel}
    return report


def lrp_float32_gates(dev, images) -> dict:
    """The float32 ResNet-50 (seed 0, TF32 off) on 4 images and 2 layer3 components: heatmaps on
    the card against the port on the CPU for each composite, crop boxes equal; batched against
    single on the card."""
    from semanticlens_tpu_torch.collect.relevance_based import _Preprocessed
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.relevance import make_attribution_fn, make_batched_attribution_fn

    layer = LRP["layer"]
    x = images[:4]
    models = []  # the card's, then the CPU's
    for device in (dev, torch.device("cpu")):
        m = ResNet(depth=50, dtype=torch.float32, device=device)
        models.append((_Preprocessed(m, imagenet_preprocess), m.init(seed=0)))
    gaps = {}
    for composite, atol in LRP_HEAT_ATOL.items():
        for comp in (0, 1):
            card, cpu = (make_attribution_fn(m, layer, composite=composite)(p, x, comp).cpu() for m, p in models)
            gap = float((card - cpu).abs().max())
            gaps[f"{composite}[{comp}]"] = gap
            if not (gap <= atol and torch.isfinite(card).all()):
                raise AssertionError(f"[lrp] float32 heatmaps {composite} component {comp}: card vs CPU {gap:.3g} > {atol}")
            if crop_boxes(card) != crop_boxes(cpu):
                raise AssertionError(f"[lrp] crop boxes {composite} component {comp}: {crop_boxes(card)} vs {crop_boxes(cpu)}")
    m, p = models[0]
    pair = np.stack([images[:4], images[4:8]])
    batched = make_batched_attribution_fn(m, layer)(p, pair, [0, 1]).cpu()
    single = torch.stack([make_attribution_fn(m, layer)(p, pair[k], k).cpu() for k in range(2)])
    bgap = float(((batched - single).abs() - LRP_BATCHED_TOL["rtol"] * single.abs()).max())
    if not bgap <= LRP_BATCHED_TOL["atol"]:
        raise AssertionError(f"[lrp] batched vs single on the card: excess {bgap:.3g} over rtol/atol {LRP_BATCHED_TOL}")
    return {"heatmap_gap_card_vs_cpu": gaps, "batched_vs_single_excess": bgap}


def lrp_vit(dev) -> dict:
    """ViT-B/16 at full width: bf16 forward on 64 images and one ``blocks.11.mlp.fc2`` component's
    heatmaps, finite; the float32 model on 2 images, card against CPU."""
    from semanticlens_tpu_torch.models import VisionTransformer
    from semanticlens_tpu_torch.relevance import make_attribution_fn

    gen = torch.Generator(device=dev).manual_seed(3)
    images = torch.randint(0, 255, (LRP["vit_images"], 224, 224, 3), generator=gen, device=dev, dtype=torch.uint8)
    x = imagenet_preprocess(images)
    vit = VisionTransformer(dtype=torch.bfloat16, device=dev)
    params = vit.init(seed=0)
    n_params = sum(t.numel() for t in params.values())
    layer = "blocks.11.mlp.fc2"
    with torch.inference_mode():
        vit.apply(params, x)  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _ = vit.apply(params, x)
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t) * 1e3
    heat_fn = make_attribution_fn(vit, layer)
    heat_fn(params, x[:8], 0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    heat = heat_fn(params, x[:8], 0)
    torch.cuda.synchronize()
    lrp_ms = (time.perf_counter() - t) * 1e3
    if logits.shape != (LRP["vit_images"], 1000) or not torch.isfinite(logits).all():
        raise AssertionError(f"[lrp] ViT-B/16 bf16 logits {tuple(logits.shape)} not finite")
    if heat.shape != (8, 224, 224) or not torch.isfinite(heat).all() or not heat.abs().sum() > 0:
        raise AssertionError("[lrp] ViT-B/16 bf16 heatmaps not finite")

    out = []  # (logits, heatmaps) on the card, then on the CPU
    for device in (dev, torch.device("cpu")):
        v32 = VisionTransformer(dtype=torch.float32, device=device)
        p32 = v32.init(seed=0)
        xs = x[:2].to(device)
        with torch.inference_mode():
            lg, _ = v32.apply(p32, xs)
        out.append((lg.cpu(), make_attribution_fn(v32, layer)(p32, xs, 0).cpu()))
    (card_logits, card_heat), (cpu_logits, cpu_heat) = out
    logit_gap = float((card_logits - cpu_logits).abs().max() / cpu_logits.abs().max())
    heat_gap = float((card_heat - cpu_heat).abs().max())
    if not (logit_gap <= LRP_VIT_TOL["logits_rel"] and heat_gap <= LRP_VIT_TOL["heatmap"]):
        raise AssertionError(f"[lrp] ViT-B/16 float32 card vs CPU: logits {logit_gap:.3g}, heatmaps {heat_gap:.3g} "
                             f"(bounds {LRP_VIT_TOL})")
    return {"params": n_params, "forward_ms_bf16_64": forward_ms, "lrp_ms_bf16_8": lrp_ms,
            "float32_card_vs_cpu": {"logits_rel": logit_gap, "heatmap": heat_gap}}


def phase_lrp(dev):
    """Config 4 at full width: LRP-selected, attribution-cropped concept examples on ResNet-50 bf16
    (layer3, 1,024 components × 8), their CLIP ViT-B/32 embeddings, then Analyze with K1; the
    float32, conservation and ViT-B/16 gates first. K1 counted from 0 around the main path."""
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import RelevanceComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.ops import cosine as k1

    torch.cuda.empty_cache()
    n, size, layer, n_ref = LRP["images"], LRP["size"], LRP["layer"], LRP["n_ref"]
    images = np.random.default_rng(0).integers(0, 255, (n, size, size, 3), dtype=np.uint8)
    summary = {"gates": lrp_float32_gates(dev, images), "conservation": lrp_conservation(dev), "vit": lrp_vit(dev)}
    log(f"[lrp] gates: {json.dumps(summary)}")

    model = ResNet(depth=50, dtype=torch.bfloat16, device=dev)
    model.params = model.init(seed=0)
    model.name = "resnet50"
    fm = OpenClip("ViT-B-32", dtype=torch.bfloat16, device=dev, seed=0)
    lens = Lens(fm)
    timer = StageTimer()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        k1.reset_launch_counts()
        cv = RelevanceComponentVisualizer(model, ArrayDataset(images, name=f"synthetic{n}"), [layer],
                                          preprocess_fn=imagenet_preprocess, num_samples=n_ref, storage_dir=tmp)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cv.run(batch_size=LRP["sweep_batch"], checkpoint=0)
        torch.cuda.synchronize()
        summary["sweep_s"] = time.perf_counter() - t
        attribution = cv._batched_attribution_fn(layer)
        cv._attribution_fns[f"{layer}//batched"] = timer.wrap("attribution", attribution)
        cv.plot_fn = timer.wrap("blur_crop", cv.plot_fn)
        fm.preprocess = timer.wrap("resize", fm.preprocess)
        fm.encode_image = timer.wrap("embed", fm.encode_image)
        t = time.perf_counter()
        db = lens.compute_concept_db(cv, batch_size=LRP["attr_batch"], n_ref=n_ref)[layer]
        torch.cuda.synchronize()
        summary["concept_db_s"] = time.perf_counter() - t
        summary["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        del fm.preprocess, fm.encode_image
        ids = cv.get_act_max_sample_ids(layer)
        agg = {layer: db.mean(axis=1)}
        queries = ["dog", "cat", "car", "tree", "bird", "house", "person", "boat"]
        t = time.perf_counter()
        hits = lens.text_probing(queries, agg, templates=["a photo of a {}"])[layer]
        redundancy = float(lens.eval_redundancy(agg)[layer])
        clarity = lens.eval_clarity({layer: db})[layer].cpu().numpy()
        torch.cuda.synchronize()
        summary["analyze_s"] = time.perf_counter() - t
        launches = k1.launch_counts()

        # The warm attribution burst: K components × n_ref images already on the card.
        k = max(1, min(32, LRP["attr_batch"] // n_ref))
        gen = torch.Generator(device=dev).manual_seed(1)
        burst = torch.randint(0, 255, (k, n_ref, size, size, 3), generator=gen, device=dev, dtype=torch.uint8).float()
        comps = torch.arange(k, device=dev)
        attribution(model.params, burst, comps)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(4):
            attribution(model.params, burst, comps)
        torch.cuda.synchronize()
        summary["burst_heatmaps_per_s"] = 4 * k * n_ref / (time.perf_counter() - t)

    n_components = ids.shape[0]
    filled = ids >= 0
    zero_rows = np.abs(db).sum(axis=-1) == 0
    if db.shape != (1024, n_ref, 512) or not np.isfinite(db).all():
        raise AssertionError(f"[lrp] concept DB shape {db.shape} or non-finite values")
    if not np.array_equal(zero_rows, ~filled):
        raise AssertionError(f"[lrp] zero rows {int(zero_rows.sum())} vs unfilled slots {int((~filled).sum())}")
    if hits.shape != (len(queries), n_components) or not np.isfinite(hits).all() or not np.isfinite(redundancy):
        raise AssertionError("[lrp] probing or redundancy of the relevance concept DB")
    if clarity.shape != (n_components,):
        raise AssertionError(f"[lrp] clarity shape {clarity.shape}")
    if launches["streaming"] < 1 or launches["tiled"] < 1:
        raise AssertionError(f"[lrp] K1 launches on the path: {launches}")
    n_heatmaps = int(filled.sum())
    stages = dict(timer.seconds)
    stages["gather_upload_other"] = summary["concept_db_s"] - sum(stages.values())
    summary.update({
        "images": n, "layer": layer, "components": n_components, "n_ref": n_ref, "heatmaps": n_heatmaps,
        "sweep_images_per_s": n / summary["sweep_s"],
        "concept_db_heatmaps_per_s": n_heatmaps / summary["concept_db_s"],
        "concept_db_stages_s": stages, "unfilled_slots": int((~filled).sum()),
        "redundancy": redundancy, "clarity_finite": int(np.isfinite(clarity).sum()), "k1_launches": launches,
    })
    log(f"[lrp] {json.dumps(summary)}")
    return launches


# --------------------------------------------------------------------------- #
# BASELINE config 3: ViT-B/16 → MLP neurons and attention heads → SigLIP2 → text probing;
# MobileCLIP-S2; dissection of CLIP ViT-B/32's own neurons
# --------------------------------------------------------------------------- #
def rel_gap(card, cpu) -> float:
    """max |card − cpu| over max |cpu|: float32 card against CPU, relative to the values' scale."""
    card, cpu = (torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).float().cpu()
                 for v in (card, cpu))
    if card.shape != cpu.shape:
        raise AssertionError(f"card shape {tuple(card.shape)} != CPU shape {tuple(cpu.shape)}")
    return float((card - cpu).abs().max() / cpu.abs().max().clamp_min(1e-30))


def config3_models(device, dtype, vit_np, siglip_np):
    """The subject ViT-B/16 (timm naming) and SigLIP2 from ``create``, both from the given numpy weights."""
    from semanticlens_tpu_torch.foundation_models import create
    from semanticlens_tpu_torch.models import VisionTransformer

    model = VisionTransformer(dtype=dtype, device=device)
    model.params = model.load_jax_params(vit_np)
    model.name = "vit_b_16"
    return model, create("siglip2", jax_params=siglip_np, dtype=dtype, device=device)


def run_config3(model, fm, images, num_samples, batch_size, cache_dir, vocab=None):
    """Config 3 through the port's entry points: the fused Collect+Embed pass on the two ViT taps, the
    SigLIP concept DB, text probing, labels over ``vocab`` (when given), clarity and redundancy."""
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.ops.aggregators import aggregate_transformer_mean
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    on_card = fm.device.type == "cuda"
    dataset = ArrayDataset(images, name=f"synthetic{len(images)}-224")
    cv = ActivationComponentVisualizer(
        model=model, dataset_model=dataset, dataset_fm=dataset, layer_names=list(CONFIG3["components"]),
        num_samples=num_samples, aggregate_fn=aggregate_transformer_mean, model_preprocess=make_preprocess_fn(size=224),
        cache_dir=str(cache_dir))
    lens = Lens(fm)
    times = {}

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        times[key] = time.perf_counter() - t
        return out

    db = timed("concept_db_s", lambda: lens.compute_concept_db(cv, batch_size=batch_size))
    agg = {k: v.mean(1) for k, v in db.items()}
    hits = timed("text_probing_s", lambda: lens.text_probing(PROBE_WORDS, agg, templates=TEMPLATES))
    labels = None
    if vocab:
        labels = timed("labels_s", lambda: lens.label_components(vocab, agg, top_m=3, templates=TEMPLATES))
    clarity = timed("clarity_s", lambda: lens.eval_clarity(db))
    redundancy = timed("redundancy_s", lambda: lens.eval_redundancy(agg))
    return {
        "cv": cv, "lens": lens, "fm": fm, "concept_db": db, "agg": agg, "hits": hits, "labels": labels,
        "ids": {k: cv.get_max_reference(k) for k in db},
        "values": {k: cv.actmax_cache[k].activations.float().numpy() for k in db},
        "clarity": {k: v.cpu().numpy() for k, v in clarity.items()},
        "redundancy": {k: float(v) for k, v in redundancy.items()},
        "times": times,
    }


def check_labels(labels, n_components: int, vocab: list, label: str):
    """Label words come from the vocabulary; cosine scores are finite, in [-1, 1] and sorted."""
    words, scores = labels
    known = set(vocab)
    if len(words) != n_components or scores.shape != (n_components, 3) or not np.isfinite(scores).all():
        raise AssertionError(f"{label}: labels of shape {scores.shape} for {n_components} components")
    if any(w not in known for row in words for w in row):
        raise AssertionError(f"{label}: a label outside the vocabulary")
    if scores.min() < -1 - 1e-5 or scores.max() > 1 + 1e-5 or (np.diff(scores, axis=1) > 1e-6).any():
        raise AssertionError(f"{label}: label scores out of [-1, 1] or unsorted")


def check_config3(res, n_images, num_samples, label, vocab=None) -> dict:
    """Shapes, finite values, ids in range and labels in range; returns the unfilled-slot counts."""
    unfilled = {}
    for layer, c in CONFIG3["components"].items():
        db, ids = res["concept_db"][layer], res["ids"][layer]
        if db.shape != (c, num_samples, 768) or not np.isfinite(db).all():
            raise AssertionError(f"{label}: concept DB {layer} shape {db.shape} or non-finite values")
        if ids.shape != (c, num_samples) or ids.min() < -1 or ids.max() >= n_images:
            raise AssertionError(f"{label}: ids of {layer} out of range [{ids.min()}, {ids.max()}]")
        if not np.array_equal(np.abs(db).sum(-1) == 0, ids < 0):
            raise AssertionError(f"{label}: zero rows of {layer} differ from its unfilled slots")
        if res["hits"][layer].shape != (len(PROBE_WORDS), c) or not np.isfinite(res["hits"][layer]).all():
            raise AssertionError(f"{label}: probe scores of {layer}")
        filled = (ids >= 0).all(axis=1)
        clarity = res["clarity"][layer]
        if clarity.shape != (c,) or not np.isfinite(clarity[filled]).all():
            raise AssertionError(f"{label}: clarity of {layer}")
        if not np.isfinite(res["redundancy"][layer]):
            raise AssertionError(f"{label}: redundancy of {layer}")
        if vocab:
            check_labels(res["labels"][layer], c, vocab, f"{label} {layer}")
        unfilled[layer] = int((ids < 0).sum())
    return unfilled


def config3_float32_gates(dev, vit_np, siglip_np) -> dict:
    """float32 card (TF32 off) against the CPU: SigLIP's image and text embeddings on 4 images and 4
    prompts, then config 3 on 16 images as ``[reference]`` does for the quickstart."""
    models = {kind: config3_models(d, torch.float32, vit_np, siglip_np)
              for kind, d in (("card", dev), ("cpu", torch.device("cpu")))}
    images = _make_images(4, seed=3, size=224)
    prompts = ["a photo of a dog", "a red car on a road", "tree", "two birds in the sky"]
    emb = {}
    for kind, (_, fm) in models.items():
        with torch.inference_mode():
            emb[kind] = (fm.encode_image(fm.preprocess(torch.from_numpy(images))).cpu(),
                         fm.encode_text(fm.tokenize(prompts)).cpu())
    report = {"siglip_image_rel": rel_gap(emb["card"][0], emb["cpu"][0]),
              "siglip_text_rel": rel_gap(emb["card"][1], emb["cpu"][1])}
    if not max(report.values()) <= FM_GATE_REL:
        raise AssertionError(f"[siglip] float32 SigLIP card vs CPU: {report} > {FM_GATE_REL}")

    images = _make_images(16, seed=1, size=224)
    results = {}
    for kind, (model, fm) in models.items():
        with tempfile.TemporaryDirectory() as tmp:
            results[kind] = run_config3(model, fm, images, 5, 8, tmp)
        check_config3(results[kind], 16, 5, f"[siglip] reference[{kind}]")
    gpu, cpu_res = results["card"], results["cpu"]
    report["embedding_table_rel"] = rel_gap(gpu["cv"].embedding_table, cpu_res["cv"].embedding_table)
    if not report["embedding_table_rel"] <= FM_GATE_REL:
        raise AssertionError(f"[siglip] float32 embedding table card vs CPU: {report['embedding_table_rel']:.3g}")
    # The card's scores on the CPU run's DB: identical inputs, as in [reference].
    cpu_db, cpu_agg, lens = cpu_res["concept_db"], cpu_res["agg"], gpu["lens"]
    hits = lens.text_probing(PROBE_WORDS, cpu_agg, templates=TEMPLATES)
    clarity = lens.eval_clarity(cpu_db)
    redundancy = lens.eval_redundancy(cpu_agg)
    for layer in CONFIG3["components"]:
        np.testing.assert_allclose(gpu["values"][layer], cpu_res["values"][layer], rtol=2**-7, atol=1e-3)
        id_match = float((gpu["ids"][layer] == cpu_res["ids"][layer]).mean())
        if id_match < 0.98:
            raise AssertionError(f"[siglip] reference: only {id_match:.3f} of {layer} ids agree with the CPU")
        np.testing.assert_allclose(hits[layer], cpu_res["hits"][layer], atol=1e-4)
        np.testing.assert_allclose(clarity[layer].cpu().numpy(), cpu_res["clarity"][layer], atol=1e-5)
        np.testing.assert_allclose(float(redundancy[layer]), cpu_res["redundancy"][layer], atol=1e-5)
        report[layer] = {"id_match": id_match,
                         "max_probe_diff": float(np.abs(hits[layer] - cpu_res["hits"][layer]).max())}
    return report


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_for_server(proc, base: str, log_path: Path, timeout_s: float = 300.0):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"the serve CLI exited with {proc.returncode}:\n{log_path.read_text()[-4000:]}")
        try:
            if _http_json(f"{base}/healthz")[0] == 200:
                return
        except (urllib.error.URLError, ConnectionError):
            pass
        time.sleep(0.5)
    raise AssertionError(f"the serve CLI did not answer within {timeout_s} s:\n{log_path.read_text()[-4000:]}")


def phase_siglip(dev, root: Path):
    """Config 3 at full width: ViT-B/16 bf16 → blocks.11.mlp.fc1 (3,072) and blocks.11.attn.heads (12) →
    SigLIP2 bf16 concept DB → probing, labels over 1,000 words, clarity, redundancy (K1 counted from 0);
    then ``python -m semanticlens_tpu_torch.serve --fm siglip2`` over the written DB, answering text queries
    over HTTP while the float32 gates run."""
    from semanticlens_tpu_torch.foundation_models import create
    from semanticlens_tpu_torch.foundation_models import siglip as sig
    from semanticlens_tpu_torch.lens import text_probing
    from semanticlens_tpu_torch.models import VisionTransformer
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.serve import load_aggregated_db

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n, batch, ns = CONFIG3["images"], CONFIG3["batch"], CONFIG3["num_samples"]
    summary = {}
    t = time.perf_counter()
    siglip_np = sig.init_siglip_params_jax_layout(0, sig.SIGLIP_PRESETS["ViT-B-16-SigLIP2"])
    summary["siglip_numpy_init_s"] = time.perf_counter() - t
    summary["siglip_params"] = int(sum(v.size for v in siglip_np.values()))
    images = _make_images(n, seed=0, size=224)
    vocab = vocabulary(1000)

    t = time.perf_counter()
    model = VisionTransformer(dtype=torch.bfloat16, device=dev)
    model.params = model.init(seed=0)
    model.name = "vit_b_16"
    fm = create("siglip2", jax_params=siglip_np, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    summary["weights_upload_s"] = time.perf_counter() - t
    k1.reset_launch_counts()
    res = run_config3(model, fm, images, ns, batch, root / "cache", vocab=vocab)
    launches = k1.launch_counts()
    summary["unfilled_slots"] = check_config3(res, n, ns, "[siglip]", vocab)
    if launches["streaming"] < 1 or launches["tiled"] < 2:  # probing; labels and redundancy of the MLP layer
        raise AssertionError(f"[siglip] K1 launches on the path: {launches}")
    cv = res["cv"]

    def embed_fn(raw):
        return fm.encode_image(fm.preprocess(raw))

    torch.cuda.synchronize()
    t = time.perf_counter()
    cv.engine.run_fused(cv.params, cv.dataset, batch, embed_fn)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    with torch.inference_mode():
        raw = torch.from_numpy(images[:batch]).to(dev)
        pre = fm.preprocess(raw)
        tokens8 = fm.tokenize([TEMPLATES[0].format(w) for w in PROBE_WORDS])
        tokens1000 = fm.tokenize([TEMPLATES[0].format(w) for w in vocab])
        vit_pre = cv.engine.input_preprocess(raw)
        summary.update({
            "siglip_image_ms_per_256": time_ms(lambda: fm.encode_image(pre), 5, 2),
            "siglip_text_ms_per_8_prompts": time_ms(lambda: fm.encode_text(tokens8), 10, 2),
            "siglip_text_ms_per_1000_prompts": time_ms(lambda: fm.encode_text(tokens1000), 3, 1),
            "vit_b16_subject_ms_per_256": time_ms(
                lambda: model.apply(model.params, vit_pre, tuple(CONFIG3["components"])), 5, 2),
        })
    del raw, pre, vit_pre

    # The serve CLI over the DB file Lens wrote, started now and queried after the gates.
    db_file = next((cv.storage_dir / "concept_database" / fm.name).glob("concept_db-*.safetensors"))
    port, log_path = _free_port(), root / "serve_cli.log"
    base = f"http://127.0.0.1:{port}"
    with open(log_path, "w") as log_file:
        t_cli = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "semanticlens_tpu_torch.serve", "--db", str(db_file),
                                 "--fm", "siglip2", "--port", str(port)], cwd=Path(__file__).resolve().parent,
                                stdout=log_file, stderr=subprocess.STDOUT)
        try:
            summary["gates"] = config3_float32_gates(dev, model.init_jax_layout(0), siglip_np)
            _wait_for_server(proc, base, log_path)
            summary["serve_cli_ready_s"] = time.perf_counter() - t_cli
            agg = load_aggregated_db(db_file)
            query_ms, max_diff = [], 0.0
            for i, word in enumerate(PROBE_WORDS + vocab[:12]):
                t = time.perf_counter()
                status, out = _http_json(f"{base}/text_search?q={urllib.parse.quote(word)}&k=5")
                query_ms.append(1e3 * (time.perf_counter() - t))
                if status != 200 or sorted(out["results"]) != sorted(CONFIG3["components"]):
                    raise AssertionError(f"[siglip] the serve CLI's /text_search: {status} {out}")
                if i < len(PROBE_WORDS):  # served ids equal offline probing of the same DB
                    probe = text_probing(fm, word, agg, templates=TEMPLATES)
                    for layer, scores in probe.items():
                        order = np.argsort(-scores[0], kind="stable")[:5]
                        if out["results"][layer]["ids"] != order.tolist():
                            raise AssertionError(f"[siglip] {word!r} {layer}: served ids differ from offline probing")
                        max_diff = max(max_diff, float(np.abs(np.asarray(out["results"][layer]["scores"])
                                                              - scores[0][order]).max()))
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    times = res["times"]
    summary.update({
        "images": n, "batch": batch, "components": {k: v.shape[0] for k, v in res["concept_db"].items()},
        "concept_db_shape_total": [sum(v.shape[0] for v in res["concept_db"].values()), ns, 768],
        "images_per_s_fused_cold": n / times["concept_db_s"], "images_per_s_fused_warm": n / warm_s,
        **{k: round(v, 4) for k, v in times.items()},
        "serve_cli_text_search": _percentiles(query_ms), "served_vs_offline_max_score_diff": max_diff,
        "redundancy": res["redundancy"], "k1_launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    })
    log(f"[siglip] {json.dumps(summary)}")
    return launches, {"model": model, "images": images, "root": root,
                      "siglip_image_ms_per_256": summary["siglip_image_ms_per_256"],
                      "head_ids": res["ids"]["blocks.11.attn.heads"]}


def phase_mobileclip(dev, ctx):
    """MobileCLIP-S2 bf16 at full width (seed 0): 256 images at 256² and a prompt batch timed beside
    SigLIP and CLIP ViT-B/32; the [siglip] phase's 12 head components re-embedded into a MobileCLIP concept
    DB and probed (K1 at D = 512, counted from 0); float32 card vs CPU on 2 images first."""
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.foundation_models import ClipMobile, OpenClip, create
    from semanticlens_tpu_torch.foundation_models import mobileclip as mc
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.ops.aggregators import aggregate_transformer_mean
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    summary = {}
    s2_np = mc.init_mobileclip_params_jax_layout(0, mc.MOBILECLIP_PRESETS["MobileCLIP-S2"])
    two = torch.from_numpy(_make_images(2, seed=4, size=256))
    emb = {}
    for kind, device in (("card", dev), ("cpu", torch.device("cpu"))):
        fm32 = create("mobileclip-s2", jax_params=s2_np, dtype=torch.float32, device=device)
        with torch.inference_mode():
            emb[kind] = fm32.encode_image(fm32.preprocess(two)).cpu()
    summary["float32_card_vs_cpu_rel"] = rel_gap(emb["card"], emb["cpu"])
    if not summary["float32_card_vs_cpu_rel"] <= FM_GATE_REL:
        raise AssertionError(f"[mobileclip] float32 card vs CPU: {summary['float32_card_vs_cpu_rel']:.3g}")
    del fm32

    t = time.perf_counter()
    fm = ClipMobile("s2", dtype=torch.bfloat16, device=dev, seed=0)
    torch.cuda.synchronize()
    summary["weights_s"] = time.perf_counter() - t
    summary["params"] = int(sum(v.numel() for v in fm.params.values()))
    vitb32 = OpenClip("ViT-B-32", dtype=torch.bfloat16, device=dev, seed=0)
    raw = torch.from_numpy(_make_images(256, seed=0, size=256)).to(dev)
    with torch.inference_mode():
        pre, pre32 = fm.preprocess(raw), vitb32.preprocess(raw)
        tokens = fm.tokenize([TEMPLATES[0].format(w) for w in PROBE_WORDS])
        embeds = fm.encode_image(pre)
        if embeds.shape != (raw.shape[0], 512) or not torch.isfinite(embeds).all():
            raise AssertionError(f"[mobileclip] image embeddings {tuple(embeds.shape)}")
        text = fm.encode_text(tokens)
        if text.shape != (len(PROBE_WORDS), 512) or not torch.isfinite(text).all():
            raise AssertionError(f"[mobileclip] text embeddings {tuple(text.shape)}")
        summary.update({
            "mobileclip_s2_image_ms_per_256": time_ms(lambda: fm.encode_image(pre), 5, 2),
            "mobileclip_s2_text_ms_per_8_prompts": time_ms(lambda: fm.encode_text(tokens), 10, 2),
            "siglip_image_ms_per_256": ctx["siglip_image_ms_per_256"],
            "vit_b32_image_ms_per_256": time_ms(lambda: vitb32.encode_image(pre32), 5, 2),
        })
    del raw, pre, pre32

    # The [siglip] phase's head components: their collected ids from its cache, re-embedded.
    dataset = ArrayDataset(ctx["images"], name=f"synthetic{len(ctx['images'])}-224")
    layer = "blocks.11.attn.heads"
    k1.reset_launch_counts()
    cv = ActivationComponentVisualizer(
        model=ctx["model"], dataset_model=dataset, dataset_fm=dataset, layer_names=[layer],
        num_samples=CONFIG3["num_samples"], aggregate_fn=aggregate_transformer_mean,
        model_preprocess=make_preprocess_fn(size=224), cache_dir=str(ctx["root"] / "cache"))
    lens = Lens(fm)
    torch.cuda.synchronize()
    t = time.perf_counter()
    db = lens.compute_concept_db(cv, batch_size=CONFIG3["batch"])[layer]
    torch.cuda.synchronize()
    summary["concept_db_s"] = time.perf_counter() - t
    agg = {layer: db.mean(1)}
    hits = lens.text_probing(PROBE_WORDS, agg, templates=TEMPLATES)[layer]
    redundancy = float(lens.eval_redundancy(agg)[layer])
    launches = k1.launch_counts()
    if not np.array_equal(cv.get_max_reference(layer), ctx["head_ids"]):
        raise AssertionError("[mobileclip] the head components' ids differ from the [siglip] phase's")
    if db.shape != (12, CONFIG3["num_samples"], 512) or not np.isfinite(db).all():
        raise AssertionError(f"[mobileclip] concept DB shape {db.shape} or non-finite values")
    if hits.shape != (len(PROBE_WORDS), 12) or not np.isfinite(hits).all() or not np.isfinite(redundancy):
        raise AssertionError("[mobileclip] probing or redundancy of the head concept DB")
    if launches["streaming"] < 1:
        raise AssertionError(f"[mobileclip] K1 launches on the path: {launches}")
    summary.update({"redundancy": redundancy, "k1_launches": launches,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    log(f"[mobileclip] {json.dumps(summary)}")
    return launches, vitb32


def phase_dissect(dev, fm):
    """FM dissection on CLIP ViT-B/32 (the quickstart's FM): block 11's 3,072 MLP-neuron directions and
    its 12 × 64 attention-head directions in the joint space, labelled over 1,000 words (K1 counted from 0);
    the float32 directions card against CPU first."""
    from semanticlens_tpu_torch.foundation_models import OpenClip, dissect
    from semanticlens_tpu_torch.foundation_models.clip import CLIP_PRESETS, init_clip_params_jax_layout
    from semanticlens_tpu_torch.lens import label_components
    from semanticlens_tpu_torch.ops import cosine as k1

    summary = {}
    np32 = init_clip_params_jax_layout(0, CLIP_PRESETS["ViT-B-32"])
    dirs = {}
    for kind, device in (("card", dev), ("cpu", torch.device("cpu"))):
        fm32 = OpenClip("ViT-B-32", jax_params=np32, dtype=torch.float32, device=device)
        dirs[kind] = [fn(fm32.params, fm32.cfg, 11, tower=tower).cpu()
                             for fn in (dissect.mlp_neuron_directions, dissect.attention_head_directions)
                             for tower in ("visual", "text")]
    summary["float32_card_vs_cpu_rel"] = max(rel_gap(a, b) for a, b in zip(dirs["card"], dirs["cpu"]))
    if not summary["float32_card_vs_cpu_rel"] <= FM_GATE_REL:
        raise AssertionError(f"[dissect] float32 directions card vs CPU: {summary['float32_card_vs_cpu_rel']:.3g}")
    del fm32

    vocab = vocabulary(1000)
    k1.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    mlp = dissect.mlp_neuron_directions(fm.params, fm.cfg, 11)
    heads = dissect.attention_head_directions(fm.params, fm.cfg, 11)
    labels = label_components(fm, vocab, {"mlp": mlp, "heads": heads.reshape(-1, heads.shape[-1])}, top_m=3,
                              templates=TEMPLATES)
    torch.cuda.synchronize()
    summary["directions_and_labels_s"] = time.perf_counter() - t
    launches = k1.launch_counts()
    if mlp.shape != (3072, 512) or heads.shape != (12, 64, 512) or not (torch.isfinite(mlp).all()
                                                                       and torch.isfinite(heads).all()):
        raise AssertionError(f"[dissect] directions {tuple(mlp.shape)} {tuple(heads.shape)}")
    check_labels(labels["mlp"], 3072, vocab, "[dissect] mlp")
    check_labels(labels["heads"], 768, vocab, "[dissect] heads")
    if launches["tiled"] < 2:
        raise AssertionError(f"[dissect] K1 launches on the path: {launches}")
    summary.update({"top_label_neuron_0": labels["mlp"][0][0], "k1_launches": launches})
    log(f"[dissect] {json.dumps(summary)}")
    return launches


# --------------------------------------------------------------------------- #
# The training path: an SAE on ResNet-50 layer3 (8192 latents, TopK 32), its latents audited as components
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def recording_sae_steps(record: list):
    """Append ``(stats, per-step metrics)`` of every run of optimizer steps the SAE trainers make
    inside to ``record`` (device tensors, read after the timed work)."""
    from semanticlens_tpu_torch import sae

    run_steps = sae._run_steps

    def recording(cfg, optimizer, paired=False, **kwargs):
        run = run_steps(cfg, optimizer, paired, **kwargs)

        def recorded(*args):
            out = run(*args)
            record.append((out[2], out[3]))
            return out

        return recorded

    sae._run_steps = recording
    try:
        yield
    finally:
        sae._run_steps = run_steps


def sae_history(record: list) -> dict:
    """Every step's metrics of a recorded run, as host numpy arrays."""
    return {name: torch.cat([m[name] for _, m in record]).cpu().numpy() for name in record[0][1]}


def sae_float32_gates(dev) -> dict:
    """float32 card (TF32 off) against the CPU, from the same initial parameters on the same rows:
    ``SAE_GATE["steps"]`` steps of TopK with AuxK, ReLU+L1, JumpReLU and a skip transcoder. The card
    runs once more with TF32 on, as a control: the bound must hold for every sound run and be broken
    by every control, else it could not tell a TF32 GEMM from float32."""
    from semanticlens_tpu_torch import sae

    g, cpu = SAE_GATE, torch.device("cpu")
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(g["rows"], g["d_in"])).astype(np.float32)
    targets = np.tanh(rows @ rng.normal(size=(g["d_in"], g["d_out"])) / 8.0).astype(np.float32)
    flavours = {"topk_auxk": {"k": g["k"], "aux_k": 64, "dead_steps": 2}, "relu_l1": {"k": 0},
                "jumprelu": {"k": 0, "jumprelu": True}, "skip_transcoder": {"k": g["k"], "d_out": g["d_out"],
                                                                            "skip": True}}
    out = {"bound_rel": g["rel"], "float32": {}, "tf32_control": {}}
    for name, kw in flavours.items():
        cfg = sae.SAEConfig(d_in=g["d_in"], n_latents=g["latents"], batch_rows=g["batch_rows"], seed=0, **kw)
        y = targets if cfg.is_transcoder else None
        init = sae.init_sae(torch.Generator().manual_seed(0), cfg, cpu)
        if y is not None:
            init = sae._calibrate_transcoder_init(init, torch.from_numpy(rows), torch.from_numpy(y))
        init = {n: v.numpy() for n, v in init.items()}
        cp, cs, cm = sae.train_sae_from_rows(rows, cfg, targets=y, steps=g["steps"], params=init, device=cpu)
        for mode, tf32 in (("float32", False), ("tf32_control", True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                gp, gs, gm = sae.train_sae_from_rows(rows, cfg, targets=y, steps=g["steps"], params=init, device=dev)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            entry = {"params_rel": max(rel_gap(gp[n], cp[n]) for n in cp if n != "k"),
                     "metrics_rel": max(abs(gm[n] - cm[n]) / max(abs(cm[n]), 1e-12) for n in cm),
                     "stats_equal": bool(torch.equal(gs["last_fired"].cpu(), cs["last_fired"])
                                         and torch.equal(gs["step"].cpu(), cs["step"]))}
            if cfg.aux_k:
                entry["dead_latents"] = int((cs["last_fired"] >= cfg.dead_steps).sum())
            if cfg.k:
                x = torch.from_numpy(rows)
                sel = [torch.topk(sae._pre_activations(p, x.to(d)), cfg.k).indices.sort(-1).values.cpu()
                       for p, d in ((gp, dev), (cp, cpu))]
                entry["topk_rows_agree"] = float((sel[0] == sel[1]).all(-1).float().mean())
            out[mode][name] = entry
        entry = out["float32"][name]
        if not (entry["params_rel"] <= g["rel"] and entry["metrics_rel"] <= g["rel"] and entry["stats_equal"]
                and entry.get("topk_rows_agree", 1.0) >= g["topk_rows"] and entry.get("dead_latents", 1) > 0):
            raise AssertionError(f"[sae] float32 card vs CPU, {name}: {entry}")
    if any(max(e["params_rel"], e["metrics_rel"]) <= g["rel"] for e in out["tf32_control"].values()):
        raise AssertionError(f"[sae] a TF32 control stays within the float32 bound {g['rel']}: {out}")
    return out


def sae_code_gate(dev, dictionary, images) -> dict:
    """The trained dictionary on ``images`` through a float32 ResNet-50 (seed 0, TF32 off), card against
    CPU: the top-k latent ids of every position, equal up to near-ties (latents whose CPU pre-activation
    is within ``near_tie_rel`` of the row's largest |value| from the k-th)."""
    from semanticlens_tpu_torch import sae
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    layer, k, prep = SAE["layer"], SAE["k"], make_preprocess_fn(size=SAE["size"])
    weights = ResNet(depth=50, device="cpu").init_jax_layout(0)
    pre, ids = [], []  # card, CPU
    for device in (dev, torch.device("cpu")):
        model = ResNet(depth=50, dtype=torch.float32, device=device)
        wrapped = sae.SAESubjectModel(model, layer, dictionary, base_params=model.load_jax_params(weights))
        with torch.inference_mode():
            _, taps = wrapped.base.apply(wrapped.params["base"], prep(torch.from_numpy(images).to(device)), (layer,))
            p = sae._pre_activations(wrapped.params["sae"], taps[layer]).reshape(-1, SAE["latents"])
            pre.append(p.cpu())
            ids.append(torch.topk(p, k).indices.sort(-1).values.cpu())
    same = (ids[0] == ids[1]).all(-1)
    cpu_pre = pre[1]
    kth = torch.topk(cpu_pre, k).values[:, -1:]
    near = (cpu_pre - kth).abs() <= SAE_GATE["near_tie_rel"] * cpu_pre.abs().amax(-1, keepdim=True)
    for row in torch.nonzero(~same).flatten().tolist():
        differ = set(ids[0][row].tolist()) ^ set(ids[1][row].tolist())
        if not all(bool(near[row, j]) for j in differ):
            raise AssertionError(f"[sae] position {row}: card and CPU top-{k} latents differ beyond near-ties")
    share = float(same.float().mean())
    if share < SAE_GATE["code_ids_share"]:
        raise AssertionError(f"[sae] top-{k} latent ids equal on only {share:.4f} of positions")
    return {"positions": int(same.numel()), "ids_equal_share": share, "pre_rel": rel_gap(pre[0], pre[1])}


def phase_sae(dev, root: Path):
    """The training path at full width: an SAE on ResNet-50 bf16 layer3 (8192 latents, TopK 32) trained
    through ``SAEComponentVisualizer.train`` (cold epoch, warm run, AuxK run), the CLI in its own process
    while the float32 gates run, then the audit of the 8192 latents with CLIP ViT-B/32 (K1 counted from 0)."""
    import dataclasses
    import hashlib

    from semanticlens_tpu_torch import Lens, convert, sae
    from semanticlens_tpu_torch.collect import SAEComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset, Subset
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.train_sae import REPORT_KEYS
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n, layer, batch = SAE["images"], SAE["layer"], SAE["batch"]
    tap = f"{layer}.sae"
    images = _make_images(n, seed=0, size=SAE["size"])
    dataset = ArrayDataset(images, name=f"synthetic{n}-{SAE['size']}")
    model = ResNet(depth=50, dtype=torch.bfloat16, device=dev)
    model.params = model.init(seed=0)
    model.name = "resnet50"
    prep = make_preprocess_fn(size=SAE["size"])
    cfg = sae.SAEConfig(d_in=1024, n_latents=SAE["latents"], k=SAE["k"], aux_k=SAE["aux_k"],
                        batch_rows=SAE["batch_rows"], positions_per_image=SAE["positions"], seed=0)
    summary = {"config": {k: v for k, v in dataclasses.asdict(cfg).items() if k in (
        "d_in", "n_latents", "k", "aux_k", "dead_steps", "lr", "batch_rows", "positions_per_image")}}
    k1.reset_launch_counts()

    # 1. Train: one cold epoch, then a warm run of 32 steps (4 epochs of 8 image batches).
    runs = {}
    for name, epochs in (("cold", 1), ("warm", SAE["warm_epochs"])):
        record = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        with recording_sae_steps(record):
            trained = SAEComponentVisualizer.train(model, dataset, layer, cfg, batch_size=batch, epochs=epochs,
                                                   model_preprocess=prep)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        hist, stats = sae_history(record), record[-1][0]
        steps = int(stats["step"])
        runs[name] = trained
        summary[f"train_{name}"] = {
            "epochs": epochs, "steps": steps, "seconds": seconds, "steps_per_s": steps / seconds,
            "rows_per_s": steps * cfg.batch_rows / seconds,
            "images_per_s": epochs * (n // batch) * batch / seconds,
            "final_loss": float(hist["loss"][-1]), "final_fvu": float(hist["fvu"][-1]),
            "first_fvu": float(hist["fvu"][0]), "final_l0": float(hist["l0"][-1]),
            "fired_latents": int((stats["last_fired"] < steps).sum()),  # fired on at least one step of the run
        }
        if name == "warm":
            expected = epochs * (n // batch) * (batch * cfg.positions_per_image // cfg.batch_rows)  # 32
            if steps != expected or not (hist["l0"] == SAE["k"]).all():
                raise AssertionError(f"[sae] warm run: {steps} steps, l0 per step {hist['l0'].tolist()}")
            if not np.isfinite(hist["loss"]).all() or not hist["fvu"][-1] < hist["fvu"][0]:
                raise AssertionError(f"[sae] warm run: loss {hist['loss'].tolist()}, fvu {hist['fvu'].tolist()}")
    if not all(torch.isfinite(v).all() for n_, v in runs["warm"].items() if n_ != "k"):
        raise AssertionError("[sae] non-finite trained parameters")
    summary["train_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30

    # The AuxK run: dead_steps=2 on 1024 images (4 steps); AuxK must be on the loss and its gradients finite.
    aux_cfg = dataclasses.replace(cfg, dead_steps=2)
    record = []
    with recording_sae_steps(record):
        aux_params = SAEComponentVisualizer.train(model, Subset(dataset, 0, SAE["aux_images"]), layer, aux_cfg,
                                                  batch_size=batch, model_preprocess=prep)
    hist, last_fired = sae_history(record), record[-1][0]["last_fired"]
    dead = last_fired >= aux_cfg.dead_steps
    extract = sae._make_row_extractor(sae._PreprocessedModel(model, prep), layer, cfg)
    rows = extract(model.params, torch.from_numpy(images[:batch]).to(dev),
                   torch.Generator(device=dev).manual_seed(1))[: cfg.batch_rows]
    leaves = {n_: v.detach().requires_grad_(True) for n_, v in aux_params.items() if n_ != "k"}
    loss, (_, metrics) = sae._loss_fn(leaves, rows, aux_cfg, last_fired)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    summary["auxk"] = {"dead_latents": int(dead.sum()), "aux_term": float(loss.detach() - metrics["mse"]),
                       "loss_minus_mse_per_step": (hist["loss"] - hist["mse"]).tolist(),
                       "dead_decoder_rows_grad_abs_sum": float(grads["W_dec"][dead].abs().sum())}
    if not (summary["auxk"]["dead_latents"] > 0 and summary["auxk"]["aux_term"] > 0
            and summary["auxk"]["dead_decoder_rows_grad_abs_sum"] > 0
            and all(torch.isfinite(g).all() for g in grads.values())):
        raise AssertionError(f"[sae] AuxK at dead_steps=2: {summary['auxk']}")
    del leaves, grads, rows, aux_params

    # 2. The CLI in its own process (the JAX tool's defaults, one epoch), while the float32 gates run.
    npz, log_path = root / "sae.npz", root / "train_sae_cli.log"
    with open(log_path, "w") as log_file:
        t_cli = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "semanticlens_tpu_torch.train_sae", "--epochs", "1",
                                 "--out", str(npz)], cwd=Path(__file__).resolve().parent, stdout=log_file,
                                stderr=subprocess.STDOUT)
        try:
            summary["float32_gates"] = sae_float32_gates(dev)
            summary["code_gate"] = sae_code_gate(dev, runs["warm"], images[: SAE["code_images"]])
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    summary["cli_process_s"] = time.perf_counter() - t_cli
    lines = log_path.read_text().strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"[sae] the train_sae CLI exited with {rc}:\n" + "\n".join(lines[-40:]))
    report = json.loads(lines[-1])
    if tuple(report) != REPORT_KEYS or report["l0"] != SAE["k"] or not np.isfinite(report["final_loss"]):
        raise AssertionError(f"[sae] the train_sae CLI's JSON line: {report}")
    with np.load(npz) as arrays:
        digest = hashlib.sha256(np.ascontiguousarray(arrays["W_dec"], np.float32).tobytes()).hexdigest()[:8]
    cli_model = sae.SAESubjectModel(model, layer, convert.load_sae_npz(npz, dev))
    if not cli_model.name.endswith(f"_{SAE['latents']}k{SAE['k']}_{digest}"):
        raise AssertionError(f"[sae] {cli_model.name} does not carry the file's digest {digest}")
    summary["cli"] = {"report": report, "artifact_digest": digest, "subject_name": cli_model.name}
    del cli_model

    # 4. The audit: the warm run's dictionary as 8192 components, CLIP ViT-B/32, 25 samples each.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fm = OpenClip("ViT-B-32", dtype=torch.bfloat16, device=dev, seed=0)
    lens = Lens(fm)
    cv = SAEComponentVisualizer(model, dataset, dataset, layer, runs["warm"], SAE["num_samples"],
                                model_preprocess=prep, cache_dir=str(root / "cache"))
    vocab = vocabulary(1000)
    torch.cuda.synchronize()
    t = time.perf_counter()
    db = lens.compute_concept_db(cv, batch_size=batch)[tap]
    torch.cuda.synchronize()
    summary["concept_db_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cv.engine.run_fused(cv.params, cv.dataset, batch, lambda raw: fm.encode_image(fm.preprocess(raw)))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    agg = {tap: db.mean(axis=1)}
    t = time.perf_counter()
    hits = lens.text_probing(PROBE_WORDS, agg, templates=TEMPLATES)[tap]
    labels = lens.label_components(vocab, agg, top_m=3, templates=TEMPLATES)[tap]
    clarity = lens.eval_clarity({tap: db})[tap].cpu().numpy()
    redundancy = float(lens.eval_redundancy(agg)[tap])
    torch.cuda.synchronize()
    summary["analyze_s"] = time.perf_counter() - t
    launches = k1.launch_counts()
    ids = cv.get_max_reference(tap)
    filled = ids >= 0
    zero_rows = np.abs(db).sum(axis=-1) == 0
    c = SAE["latents"]
    if db.shape != (c, SAE["num_samples"], 512) or not np.isfinite(db).all():
        raise AssertionError(f"[sae] concept DB shape {db.shape} or non-finite values")
    if ids.shape != (c, SAE["num_samples"]) or ids.min() < -1 or ids.max() >= n:
        raise AssertionError(f"[sae] ids out of range [{ids.min()}, {ids.max()}]")
    if not np.array_equal(zero_rows, ~filled):
        raise AssertionError(f"[sae] zero rows {int(zero_rows.sum())} vs unfilled slots {int((~filled).sum())}")
    if hits.shape != (len(PROBE_WORDS), c) or not np.isfinite(hits).all() or not np.isfinite(redundancy):
        raise AssertionError("[sae] probing or redundancy of the SAE concept DB")
    check_labels(labels, c, vocab, "[sae]")
    if clarity.shape != (c,):
        raise AssertionError(f"[sae] clarity shape {clarity.shape}")
    if launches["streaming"] < 1 or launches["tiled"] < 2:
        raise AssertionError(f"[sae] K1 launches on the path: {launches}")
    summary.update({
        "images": n, "batch": batch, "components": c, "num_samples": SAE["num_samples"],
        "images_per_s_fused_cold": n / summary["concept_db_s"], "images_per_s_fused_warm": n / warm_s,
        "latents_with_evidence": int(filled.any(axis=1).sum()), "unfilled_slots": int((~filled).sum()),
        "redundancy": redundancy, "clarity_finite": int(np.isfinite(clarity).sum()), "k1_launches": launches,
        "audit_peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    })
    log(f"[sae] {json.dumps(summary)}")
    return launches


@contextlib.contextmanager
def patched(obj, **attrs):
    """Set attributes of ``obj`` inside the block, restore them after."""
    old = {name: getattr(obj, name) for name in attrs}
    for name, value in attrs.items():
        setattr(obj, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(obj, name, value)


@contextlib.contextmanager
def recording_concept_dbs(record: list):
    """Append ``(lens, cv, concept DB)`` of every ``Lens.compute_concept_db`` call made inside."""
    from semanticlens_tpu_torch.lens import Lens

    compute = Lens.compute_concept_db

    def recording(self, cv, **kwargs):
        db = compute(self, cv, **kwargs)
        record.append((self, cv, db))
        return db

    with patched(Lens, compute_concept_db=recording):
        yield


def _max_rel(got, want, scale) -> float:
    """max |got − want| over ``scale`` (tensors or arrays, compared in float64 on the host)."""
    def host(x):
        return x.detach().to("cpu", torch.float64).numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)

    return float(np.abs(host(got) - host(want)).max() / scale)


def _scale(x) -> float:
    return float((x.detach().abs().max() if isinstance(x, torch.Tensor) else np.abs(x).max()))


def audit_float32_gate(dev) -> tuple[dict, list]:
    """``full_audit.main`` in float32 (ResNet-50 and CLIP ViT-B/32 at full width, seed 0) on the card and on
    the CPU over the same 16 images, all four layers. The collected evidence agrees (as ``[reference]``
    holds it), and the card's Analyze on the CPU run's concept DB and query embeddings (identical
    inputs, so a bf16 near-tie in one top-k slot is not mistaken for a scoring error) gives the CPU
    report's clarity and redundancy within 1e-5 relative and its top-5 ids, up to components whose
    float64 cosines tie within K1's atol (the banks' components sit at cosines ≈ 0.99 of each other).
    Returns the measurements and the layers that miss."""
    from semanticlens_tpu_torch import full_audit, scores
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean

    images = _make_images(AUDIT5["gate_images"], seed=1, size=224)

    def build_model(args, device):
        model = ResNet(depth=50, dtype=torch.float32, device=device)
        model.params, model.name = model.init(seed=0), "resnet50-audit"
        return model, aggregate_conv_mean

    runs = {}
    for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
        record = []
        argv = ["--n-samples", str(AUDIT5["gate_samples"]), "--batch", str(AUDIT5["gate_batch"])]
        with patched(full_audit, build_model=build_model,
                     build_fm=lambda args, d: OpenClip("ViT-B-32", dtype=torch.float32, device=d, seed=0),
                     load_dataset=lambda args, d: ArrayDataset(images, name="audit-gate")), \
                recording_concept_dbs(record), contextlib.redirect_stdout(io.StringIO()):
            report = full_audit.main(argv + (["--cpu"] if device.type == "cpu" else []))
        runs[key] = (report, *record[0])
    (gpu, glens, gcv, gdb), (cpu, clens, ccv, cdb) = runs["card"], runs["cpu"]
    queries = ["dog", "car wheel", "striped pattern"]
    with torch.inference_mode():
        q_cpu = clens.fm.encode_text(clens.fm.tokenize(queries)).float()
    out, failed = {}, []
    for layer in AUDIT5["db_shapes"]:
        agg_cpu = cdb[layer].mean(1)
        clarity = float(glens.eval_clarity({layer: cdb[layer]})[layer].mean())
        redundancy = float(glens.eval_redundancy({layer: agg_cpu})[layer])
        _, top5 = scores.topk_cosine_search(q_cpu.to(dev), torch.as_tensor(agg_cpu, device=dev), 5)
        top5 = {q: top5[i].tolist() for i, q in enumerate(queries)}
        q64, b64 = q_cpu.double().cpu().numpy(), agg_cpu.astype(np.float64)
        norms = np.outer(np.linalg.norm(q64, axis=1), np.linalg.norm(b64, axis=1))
        cos64 = (q64 @ b64.T) / np.maximum(norms, 1e-12)  # zero rows (silent components) give 0, as in K1
        want = cpu["top5_per_query"][layer]
        tie_gap = max(float(np.abs(np.sort(cos64[i, top5[w]]) - np.sort(cos64[i, want[w]])).max())
                      for i, w in enumerate(queries))
        c_cpu, r_cpu = cpu["scores"][layer]["clarity_mean"], cpu["scores"][layer]["redundancy"]
        out[layer] = {
            "evidence_ids_share": float((gcv.get_max_reference(layer) == ccv.get_max_reference(layer)).mean()),
            "db_max_abs_diff": float(np.abs(gdb[layer] - cdb[layer]).max()),
            "clarity_rel_diff": abs(clarity - c_cpu) / abs(c_cpu),
            "redundancy_rel_diff": abs(redundancy - r_cpu) / abs(r_cpu),
            "top5_equal": top5 == want,
            "top5_float64_cosine_gap": tie_gap,  # between the two top-5 sets' true cosines
            # the card's own report against the CPU's (its DB differs where a bf16 top-k slot tips)
            "report_clarity_rel_diff": abs(gpu["scores"][layer]["clarity_mean"] - c_cpu) / abs(c_cpu),
            "report_redundancy_rel_diff": abs(gpu["scores"][layer]["redundancy"] - r_cpu) / abs(r_cpu),
            "report_top5_equal": gpu["top5_per_query"][layer] == cpu["top5_per_query"][layer],
        }
        o = out[layer]
        if not (o["evidence_ids_share"] >= 0.98 and o["clarity_rel_diff"] <= 1e-5 and o["redundancy_rel_diff"] <= 1e-5
                and tie_gap <= ATOL):
            failed.append(layer)
    if gpu["db_shapes"] != cpu["db_shapes"]:
        failed.append("db_shapes")
    return out, failed


def check_audit_reports(tag: str, reports: dict, record: list, db_shapes: dict, words: list, dev):
    """Gates on ``full_audit.main`` reports (not counted): the JAX tool's keys, the DB shapes, finite scores,
    image probing of every layer; each run's top-5 and the cold run's cosine labels equal to dense K1 + a
    stable sort over its own banks (``record``: the ``(lens, cv, db)`` of each run)."""
    from semanticlens_tpu_torch import full_audit
    from semanticlens_tpu_torch.lens import _embed_vocabulary

    queries, templates = ["dog", "car wheel", "striped pattern"], ["a photo of a {}"]
    for name, report in reports.items():
        if tuple(report) != full_audit.REPORT_KEYS or report["db_shapes"] != db_shapes:
            raise AssertionError(f"[{tag}] {name}: keys {list(report)}, db shapes {report['db_shapes']}")
        values = [v for s in report["scores"].values() for v in s.values()]
        if len(values) != 4 * len(db_shapes) or not np.isfinite(values).all():
            raise AssertionError(f"[{tag}] {name}: scores {report['scores']}")
        if set(report["image_probe_top_neuron"]) != set(db_shapes):
            raise AssertionError(f"[{tag}] {name}: image probing {report['image_probe_top_neuron']}")
    for (name, report), (lens, _, db) in zip(reports.items(), record):
        fm = lens.fm
        with torch.inference_mode():
            q = fm.encode_text(fm.tokenize(queries)).float()
        vocab_embeds = _embed_vocabulary(fm, words, templates, 1024) if name == "cold" else None
        for layer, shape in db_shapes.items():
            bank = torch.as_tensor(db[layer].mean(1), device=dev)
            _, idx = dense_topk(q, bank, 5)
            if report["top5_per_query"][layer] != {w: idx[i].tolist() for i, w in enumerate(queries)}:
                raise AssertionError(f"[{tag}] {name}: top-5 of {layer} differ from dense K1 + stable sort")
            got = report["component_labels"][layer]
            if vocab_embeds is not None:
                vals, idx = dense_topk(bank, vocab_embeds, 1)
                if [got[str(i)]["word"] for i in range(16)] != [words[j] for j in idx[:16, 0].tolist()] or not (
                        np.allclose([got[str(i)]["score"] for i in range(16)], vals[:16, 0].cpu().numpy(),
                                    rtol=0, atol=1e-6)):
                    raise AssertionError(f"[{tag}] cosine labels of {layer} differ from dense K1 + stable sort")
            elif len(got) != min(16, shape[0]) or any(v["word"] not in words or not np.isfinite(v["score"])
                                                      for v in got.values()):
                raise AssertionError(f"[{tag}] soft-WPMI labels of {layer}: {got}")


def phase_audit(dev, root: Path):
    """BASELINE config 5 at full width through ``full_audit.main`` (K1 counted from 0 around the two
    in-process runs); the CLI over a JPEG folder in its own process while the float32 gate runs."""
    from semanticlens_tpu_torch import full_audit
    from semanticlens_tpu_torch.ops import cosine as k1

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    words = vocabulary(1000)
    argv = ["--n-synthetic", str(AUDIT5["images"]), "--vocabulary", *words,
            "--image-query-indices", *map(str, AUDIT5["image_queries"])]
    reports, walls, record, shapes = {}, {}, [], set()
    k1.reset_launch_counts()
    with recording_k1_shapes(shapes), recording_concept_dbs(record), contextlib.redirect_stdout(io.StringIO()):
        for name, extra in (("cold", []), ("warm", ["--label-scoring", "wpmi"])):
            t = time.perf_counter()
            reports[name] = full_audit.main(argv + extra)
            walls[name] = time.perf_counter() - t
    launches = k1.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    if launches["streaming"] < 1 or launches["tiled"] < 1:
        raise AssertionError(f"[audit] K1 launches on the path: {launches}")
    check_audit_reports("audit", reports, record, AUDIT5["db_shapes"], words, dev)
    del record
    torch.cuda.empty_cache()

    # The CLI in its own process over a 4-class JPEG folder, while the float32 gate runs.
    encode = make_jpeg_folder(dev, root / "jpegs", AUDIT5["folder_images"])
    out_path, err_path = root / "full_audit_cli.json", root / "full_audit_cli.log"
    with open(out_path, "w") as out_file, open(err_path, "w") as err_file:
        t_cli = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "semanticlens_tpu_torch.full_audit", "--image-dir",
                                 str(root / "jpegs")], cwd=Path(__file__).resolve().parent, stdout=out_file,
                                stderr=err_file)
        try:
            gate, gate_missed = audit_float32_gate(dev)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    cli_s = time.perf_counter() - t_cli
    lines = out_path.read_text().strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"[audit] the full_audit CLI exited with {rc}:\n{err_path.read_text()[-4000:]}")
    cli = json.loads(lines[-1])
    if (tuple(cli) != full_audit.REPORT_KEYS or cli["n_images"] != AUDIT5["folder_images"]
            or cli["db_shapes"] != AUDIT5["db_shapes"] or "class-composition" not in cli["stages"]
            or set(cli["class_selective_components"]) != set(AUDIT5["db_shapes"])):
        raise AssertionError(f"[audit] the CLI's report: {json.dumps(cli)[:2000]}")
    phase_s = time.perf_counter() - t_phase
    summary = {
        "images": AUDIT5["images"], "components": sum(s[0] for s in AUDIT5["db_shapes"].values()),
        "db_shapes": reports["cold"]["db_shapes"],
        "images_per_s_fused_cold": reports["cold"]["stages"]["collect+embed"]["items_per_sec"],
        "images_per_s_fused_warm": reports["warm"]["stages"]["collect+embed"]["items_per_sec"],
        "main_wall_s": walls,
        "stages_s": {name: {stage: round(v["seconds"], 4) for stage, v in r["stages"].items()}
                     for name, r in reports.items()},
        "scores_cold": reports["cold"]["scores"],
        "k1_launches": launches, "k1_shapes": sorted(list(s) for s in shapes),
        "peak_mem_gb": peak_gb,
        "float32_gate": gate,
        "cli": {"process_s": cli_s, "n_images": cli["n_images"], "jpeg_encode": encode,
                "images_per_s_fused": cli["stages"]["collect+embed"]["items_per_sec"],
                "stages_s": {stage: round(v["seconds"], 4) for stage, v in cli["stages"].items()},
                "class_selective_components": {k: len(v) for k, v in cli["class_selective_components"].items()}},
        "phase_s": phase_s, "bound_s": AUDIT5["bound_s"], "within_bound": phase_s <= AUDIT5["bound_s"],
    }
    log(f"[audit] {json.dumps(summary)}")
    if gate_missed:  # after the line, so that a miss still prints every measurement
        raise AssertionError(f"[audit] float32 card vs CPU misses on {gate_missed}")
    return launches


def _causal_models(device):
    from semanticlens_tpu_torch import sae
    from semanticlens_tpu_torch.models import ResNet

    model = ResNet(depth=50, dtype=torch.float32, device=device)
    model.params, model.name = model.init(seed=0), "resnet50"
    dictionaries = {}
    for kind, d_out in (("sae", 0), ("tc", 1024)):
        cfg = sae.SAEConfig(d_in=1024, n_latents=CAUSAL["latents"], k=CAUSAL["k"], d_out=d_out, seed=0)
        dictionaries[kind] = sae.finalize_sae_params(sae.init_sae(torch.Generator().manual_seed(0), cfg, device), cfg)
    return model, dictionaries


def causal_measurements(device, images, source) -> dict:
    """The causal functions' outputs on ``device`` for the card-vs-CPU gates (float32 ResNet-50 layer3)."""
    from semanticlens_tpu_torch import causal, sae

    model, dicts = _causal_models(device)
    p, layer = model.params, CAUSAL["layer"]
    ids = (np.arange(CAUSAL["gate_components"]) * 127).tolist()
    direction = np.random.default_rng(4).normal(scale=0.1, size=1024).astype(np.float32)
    with torch.no_grad():
        clean = model.apply(p, causal._images(model, images))[0]
    out = {"clean": clean}
    for mode in ("zero", "mean"):
        out[f"ablation_{mode}"] = causal.ablation_effects(model, p, layer, images, ids, mode=mode)
    out["patch"] = causal.activation_patch(model, p, layer, images, source, ids[: CAUSAL["patch_components"]])[0]
    out["steer"] = causal.steer(model, p, layer, images, direction, alpha=1.0)
    half = images.shape[0] // 2
    out["necessity"] = causal.necessity_ratio(model, p, layer, ids, images[:half], images[half:])
    out["sae_ablation"] = causal.sae_latent_ablation(model, p, layer, dicts["sae"], images, list(range(8)))
    tc = sae.TranscoderSubjectModel(model, "layer3.0", layer, dicts["tc"], replace=True)
    with torch.no_grad():
        out["transcoder"] = tc.apply(tc.params, causal._images(model, images))[0]
    return out


def causal_card_invariants(dev, images, source) -> dict:
    """Invariants on the card, each as max |Δ| over the clean output's scale."""
    from semanticlens_tpu_torch import causal, sae
    from semanticlens_tpu_torch.models import interventions

    model, dicts = _causal_models(dev)
    p, layer = model.params, CAUSAL["layer"]
    x, src = causal._images(model, images), causal._images(model, source)
    ids = (np.arange(CAUSAL["gate_components"]) * 127).tolist()
    with torch.no_grad():
        clean = model.apply(p, x)[0]
        scale = _scale(clean)
        keep_all = causal._masked_forwards(model, p, layer, x, torch.ones((1, 1024), device=dev),
                                           lambda v, m: (v * m).to(v.dtype))[0]
        src_logits = model.apply(p, src)[0]
        sub = sae.SAESubjectModel(model, layer, dicts["sae"])
        with interventions({sub.sae_tap: lambda z: z}):
            sae_identity = sub.apply(sub.params, x)[0]
        keep = torch.ones(CAUSAL["latents"], device=dev)
        keep[3] = 0.0
        with interventions({sub.sae_tap: lambda z: z * keep}):
            sae_ablated = sub.apply(sub.params, x)[0]
        tc = sae.TranscoderSubjectModel(model, "layer3.0", layer, dicts["tc"])
        with interventions({tc.tc_tap: lambda z: z}):
            tc_identity = tc.apply(tc.params, x)[0]
        tc_replace = sae.TranscoderSubjectModel(model, "layer3.0", layer, dicts["tc"], replace=True)
        tc_replaced = tc_replace.apply(tc_replace.params, x)[0]
    batched = causal.ablation_effects(model, p, layer, x, ids)
    singles = torch.cat([causal.ablation_effects(model, p, layer, x, [c]) for c in ids])
    latent = causal.sae_latent_ablation(model, p, layer, dicts["sae"], x, [3])[0]
    return {
        "keep_all_mask_delta": _max_rel(keep_all, clean, scale),
        "steer_alpha0_vs_clean": _max_rel(causal.steer(model, p, layer, x, torch.ones(1024, device=dev), alpha=0.0),
                                          clean, scale),
        "patch_whole_layer_vs_source": _max_rel(causal.activation_patch(model, p, layer, x, src)[0], src_logits,
                                                _scale(src_logits)),
        "batched_vs_single_forwards": _max_rel(batched, singles, scale),
        # an SAE latent through sae_latent_ablation and through SAESubjectModel's intervention path
        "sae_latent_vs_subject_intervention": _max_rel(latent, sae_identity - sae_ablated, scale),
        "transcoder_replace_vs_identity_intervention": _max_rel(tc_replaced, tc_identity, _scale(tc_identity)),
        "transcoder_patch_moves_output": _max_rel(tc_replaced, clean, scale),
    }


def phase_causal(dev, root: Path):
    """Interventions on ResNet-50 float32 (TF32 off): the whole layer3 necessity profile and the
    necessity ratios of its strongest components, invariants on the card, the card against the CPU,
    and ``python -m semanticlens_tpu_torch.causal_audit`` in its own process (K1 is not on this path)."""
    from semanticlens_tpu_torch import causal
    from semanticlens_tpu_torch.causal_audit import REPORT_KEYS
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.ops.aggregators import aggregate_max_auto

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    layer, size = CAUSAL["layer"], CAUSAL["size"]
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, size=(CAUSAL["images"], size, size, 3), dtype=np.uint8).astype(np.float32) / 255.0
    model, _ = _causal_models(dev)
    k1.reset_launch_counts()

    # 1. Necessity ratios of the 32 components with the strongest evidence (8 evidence, 8 control images).
    t = time.perf_counter()
    ds = ArrayDataset(images, name="causal-synthetic")
    cv = ActivationComponentVisualizer(model=model, dataset_model=ds, dataset_fm=ds, layer_names=[layer],
                                       num_samples=CAUSAL["evidence"], aggregate_fn=aggregate_max_auto)
    act = cv.run(batch_size=128)[layer]
    torch.cuda.synchronize()
    evidence_s = time.perf_counter() - t
    comps = np.argsort(-act.activations.to(torch.float32).numpy()[:, 0])[: CAUSAL["components"]]
    t = time.perf_counter()
    ratios = []
    for comp in comps:
        ev = act.sample_ids[comp]
        ev = ev[ev >= 0]
        control = rng.choice(len(images), size=ev.size, replace=False)
        ratios.append(float(causal.necessity_ratio(model, model.params, layer, [int(comp)], images[ev],
                                                   images[control])[0]))
    ratio_s = time.perf_counter() - t

    # 2. The whole layer's necessity profile: all 1,024 channels on 8 images, 8,192 forward rows.
    x = causal._images(model, images[: CAUSAL["profile_images"]])
    causal.ablation_effects(model, model.params, layer, x, [0, 1])  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    profile = causal.ablation_effects(model, model.params, layer, x, list(range(1024)))
    torch.cuda.synchronize()
    profile_s = time.perf_counter() - t
    launches = k1.launch_counts()
    rows = 1024 * CAUSAL["profile_images"]
    necessity = torch.linalg.vector_norm(profile, dim=-1).mean(1)  # (1024,) per-channel effect
    if profile.shape != (1024, CAUSAL["profile_images"], 1000) or not torch.isfinite(profile).all():
        raise AssertionError(f"[causal] ablation profile {tuple(profile.shape)} or non-finite values")
    if not (np.isfinite(ratios).all() and min(ratios) > 0):
        raise AssertionError(f"[causal] necessity ratios {ratios}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del profile, model, cv, act
    torch.cuda.empty_cache()

    # 3. The CLI in its own process while the invariants and the card-vs-CPU gates run.
    out_path, err_path = root / "causal_audit_cli.json", root / "causal_audit_cli.log"
    gate_images = images[: CAUSAL["gate_images"]]
    source = images[CAUSAL["gate_images"] : 2 * CAUSAL["gate_images"]]
    with open(out_path, "w") as out_file, open(err_path, "w") as err_file:
        t_cli = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "semanticlens_tpu_torch.causal_audit", "--depth", "50",
                                 "--image-size", str(size)], cwd=Path(__file__).resolve().parent, stdout=out_file,
                                stderr=err_file)
        try:
            invariants = causal_card_invariants(dev, gate_images, source)
            card = causal_measurements(dev, gate_images, source)
            cpu = causal_measurements(torch.device("cpu"), gate_images, source)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    cli_s = time.perf_counter() - t_cli
    lines = out_path.read_text().strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"[causal] the causal_audit CLI exited with {rc}:\n{err_path.read_text()[-4000:]}")
    cli = json.loads(lines[-1])
    out_scale = _scale(cpu["clean"])
    gates = {name: {"vs_output_scale": _max_rel(card[name], cpu[name], out_scale),
                    "vs_largest_delta": _max_rel(card[name], cpu[name], _scale(cpu[name]))}
             for name in ("ablation_zero", "ablation_mean", "patch", "steer", "sae_ablation", "transcoder")}
    gates["necessity"] = {"rel": _max_rel(card["necessity"], cpu["necessity"], _scale(cpu["necessity"]))}
    phase_s = time.perf_counter() - t_phase
    summary = {
        "layer": layer, "size": size, "dtype": "float32",
        "evidence_images": len(images), "evidence_s": evidence_s,
        "necessity_components": len(ratios), "necessity_s": ratio_s,
        "median_ratio": float(np.median(ratios)), "min_ratio": float(np.min(ratios)), "max_ratio": float(np.max(ratios)),
        "profile": {"channels": 1024, "images": CAUSAL["profile_images"], "rows": rows, "seconds": profile_s,
                    "ablated_forwards_per_s": rows / profile_s, "rows_per_forward": causal.ROWS_PER_FORWARD,
                    "most_necessary": torch.argsort(necessity, descending=True)[:5].tolist()},
        "invariants_vs_output_scale": invariants, "card_vs_cpu": gates,
        "cli": {"process_s": cli_s, "report": cli}, "k1_launches": launches, "peak_mem_gb": peak_gb,
        "phase_s": phase_s, "bound_s": CAUSAL["bound_s"], "within_bound": phase_s <= CAUSAL["bound_s"],
    }
    log(f"[causal] {json.dumps(summary)}")
    # Gates after the line, so that a miss still prints every measurement.
    missed = [name for name, g in gates.items() if name != "necessity"
              and not g["vs_output_scale"] <= CAUSAL_GATE["card_vs_cpu_of_output"]]
    if not gates["necessity"]["rel"] <= CAUSAL_GATE["necessity_rel"]:
        missed.append("necessity")
    missed += [name for name, v in invariants.items() if name != "transcoder_patch_moves_output"
               and not v <= CAUSAL_GATE["invariant"]]
    if not invariants["transcoder_patch_moves_output"] > 0:
        missed.append("transcoder_patch_moves_output")
    if tuple(cli) != REPORT_KEYS or cli["components"] != 8 or not np.isfinite(cli["median_ratio"]):
        missed.append("cli")
    if missed:
        raise AssertionError(f"[causal] gates missed: {missed}")
    return launches


def phase_featviz(dev, root: Path):
    """Feature synthesis on ResNet-50 bf16 layer3 at 224² (cold, then warm), the synthesis visualizer
    through Lens with CLIP ViT-B/32 (K1 counted from 0 around both), the gallery reload, and the
    float32 gate card against CPU."""
    from semanticlens_tpu_torch import Lens, featviz
    from semanticlens_tpu_torch.collect import SynthesisComponentVisualizer
    from semanticlens_tpu_torch.collect import synthesis_based
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.models import zoo as zoo_module
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    layer, size, k, steps = FEATVIZ["layer"], FEATVIZ["size"], FEATVIZ["k"], FEATVIZ["steps"]
    model = ResNet(depth=50, dtype=torch.bfloat16, device=dev)
    model.params, model.name = model.init(seed=0), "resnet50"
    cfg = featviz.SynthesisConfig(steps=steps)
    k1.reset_launch_counts()

    # 1. synthesize: components 0–15 cold (seed 0), 16–31 warm (seed 1).
    runs, missed = {}, []
    for name, ids, seed in (("cold", list(range(k)), 0), ("warm", list(range(k, 2 * k)), 1)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        images, objective, trace = featviz.synthesize(model, model.params, layer, ids, aggregate_conv_mean,
                                                      image_size=size, model_preprocess=imagenet_preprocess,
                                                      config=cfg, seed=seed, return_trace=True)
        seconds = time.perf_counter() - t
        z0 = featviz._init_canvas(cfg, k, size + 2 * cfg.jitter, torch.Generator().manual_seed(seed)).to(dev)
        img0 = torch.sigmoid(z0)[:, cfg.jitter : cfg.jitter + size, cfg.jitter : cfg.jitter + size]
        with torch.no_grad():
            start = featviz._forward_objective(model, model.params, layer, aggregate_conv_mean, imagenet_preprocess,
                                               img0, torch.tensor(ids, device=dev)).float().cpu().numpy()
        # a component silent at the start and at the end (a ReLU that never fires) has no gradient to ascend
        silent = (start == 0.0) & (objective == 0.0)
        runs[name] = {"seconds": seconds, "fwd_bwd_per_s": k * steps / seconds, "canvases_per_s": k / seconds,
                      "objective_start": start.tolist(), "objective_final": objective.tolist(),
                      "canvases_ascended": int((objective > start).sum()), "silent_canvases": int(silent.sum()),
                      "trace_first_last": [float(trace[0]), float(trace[-1])]}
        if not (np.isfinite(objective).all() and np.isfinite(trace).all() and ((objective > start) | silent).all()
                and images.shape == (k, size, size, 3) and images.min() >= 0.0 and images.max() <= 1.0):
            missed.append(f"{name} synthesis")

    # 2. The synthesis visualizer: 32 components × 2 variants, one synthesize call of 64 canvases.
    fm = OpenClip("ViT-B-32", dtype=torch.bfloat16, device=dev, seed=0)
    lens = Lens(fm)
    cv_args = dict(layer_names=[layer], n_components=FEATVIZ["cv_components"], num_samples=FEATVIZ["cv_variants"],
                   aggregate_fn=aggregate_conv_mean, image_size=size, model_preprocess=imagenet_preprocess,
                   config=cfg, seed=0, max_batch=FEATVIZ["max_batch"], cache_dir=str(root / "featviz"))
    cv = SynthesisComponentVisualizer(model, **cv_args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cv.run()
    gallery_s = time.perf_counter() - t
    t = time.perf_counter()
    db = lens.compute_concept_db(cv, batch_size=256)[layer]
    torch.cuda.synchronize()
    db_s = time.perf_counter() - t
    agg = {layer: db.mean(1)}
    t = time.perf_counter()
    hits = lens.text_probing(PROBE_WORDS, agg, templates=TEMPLATES)[layer]
    labels = lens.label_components(vocabulary(1000), agg, top_m=3, templates=TEMPLATES)[layer]
    redundancy = float(lens.eval_redundancy(agg)[layer])
    clarity = lens.eval_clarity({layer: db})[layer].cpu().numpy()
    torch.cuda.synchronize()
    analyze_s = time.perf_counter() - t
    launches = k1.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    c = FEATVIZ["cv_components"]
    if db.shape != (c, FEATVIZ["cv_variants"], 512) or not np.isfinite(db).all():
        raise AssertionError(f"[featviz] concept DB shape {db.shape} or non-finite values")
    if hits.shape != (len(PROBE_WORDS), c) or not np.isfinite(hits).all() or not np.isfinite(redundancy):
        raise AssertionError("[featviz] probing or redundancy of the synthesized DB")
    if clarity.shape != (c,) or not np.isfinite(clarity).all():
        raise AssertionError("[featviz] clarity of the synthesized DB")
    check_labels(labels, c, vocabulary(1000), "[featviz]")
    if launches["total"] < 1:
        raise AssertionError(f"[featviz] K1 launches on the path: {launches}")

    # A second visualizer on the same cache_dir reloads the gallery without optimizing, and its DB is identical.
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return featviz.synthesize(*args, **kwargs)

    with patched(synthesis_based, synthesize=counting):
        cv2 = SynthesisComponentVisualizer(model, **cv_args)
        db2 = cv2._compute_concept_db(fm, batch_size=256)[layer]
    reload = {"synthesize_calls": len(calls), "db_max_abs_diff": float(np.abs(db2 - db).max())}
    if calls or not np.array_equal(db2, db):
        missed.append("reload")

    # 3. Card against CPU on the same z0 and draws (the CPU generator's, on both devices): step 1's loss,
    # objective and canvas gradient in float64 (the same function: the backward's formula) and in float32
    # (each within float32's reach of its float64 gradient), then 4 whole float32 steps.
    gate_cfg, n_gate = featviz.SynthesisConfig(steps=FEATVIZ["gate_steps"]), FEATVIZ["gate_canvases"]
    step1, after = {}, {}
    with patched(zoo_module, batch_norm=batch_norm_any_dtype):
        for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
            for dtype in (torch.float32, torch.float64):
                m = ResNet(depth=50, dtype=dtype, device=device)
                m.params = {name: v.to(dtype) for name, v in m.init(seed=0).items()}
                generator = torch.Generator().manual_seed(0)
                leaf = featviz._init_canvas(gate_cfg, n_gate, size + 2 * gate_cfg.jitter, generator)
                leaf = leaf.to(device, dtype).requires_grad_(True)
                offsets, flips = featviz._draws(gate_cfg, n_gate, generator)
                loss, obj = featviz._loss(m, m.params, layer, aggregate_conv_mean, imagenet_preprocess_as_input,
                                          gate_cfg, size, leaf, torch.arange(n_gate, device=device),
                                          offsets[0].tolist(), flips[0].to(device))
                (grad,) = torch.autograd.grad(loss, [leaf])
                step1[key, dtype] = (float(loss.detach()), float(obj.detach()), grad.detach().double().cpu())
                if dtype == torch.float32:
                    after[key] = featviz.synthesize(m, m.params, layer, list(range(n_gate)), aggregate_conv_mean,
                                                    image_size=size, model_preprocess=imagenet_preprocess,
                                                    config=gate_cfg, seed=0)

    def grad_rel(a, b):
        return float((step1[a][2] - step1[b][2]).norm() / step1[b][2].norm())

    f32, f64 = torch.float32, torch.float64
    gate_err = {
        "step1_loss_rel": abs(step1["card", f32][0] - step1["cpu", f32][0]) / abs(step1["cpu", f32][0]),
        "step1_objective_rel": abs(step1["card", f32][1] - step1["cpu", f32][1]) / abs(step1["cpu", f32][1]),
        "step1_grad_float64_card_vs_cpu": grad_rel(("card", f64), ("cpu", f64)),
        "step1_grad_float32_vs_float64_card": grad_rel(("card", f32), ("card", f64)),
        "step1_grad_float32_vs_float64_cpu": grad_rel(("cpu", f32), ("cpu", f64)),
        "step1_grad_float32_card_vs_cpu": grad_rel(("card", f32), ("cpu", f32)),
        "steps_images_max_abs": float(np.abs(after["card"][0] - after["cpu"][0]).max()),
        "steps_objective_rel": _max_rel(after["card"][1], after["cpu"][1], _scale(after["cpu"][1])),
    }
    phase_s = time.perf_counter() - t_phase
    summary = {
        "layer": layer, "size": size, "k": k, "steps": steps, "synthesize": runs,
        "visualizer": {"components": c, "variants": FEATVIZ["cv_variants"], "max_batch": FEATVIZ["max_batch"],
                       "gallery_s": gallery_s, "fwd_bwd_per_s": c * FEATVIZ["cv_variants"] * steps / gallery_s,
                       "concept_db_s": db_s, "analyze_s": analyze_s, "redundancy": redundancy},
        "reload": reload, "float32_gate": gate_err, "k1_launches": launches, "peak_mem_gb": peak_gb,
        "phase_s": phase_s, "bound_s": FEATVIZ["bound_s"], "within_bound": phase_s <= FEATVIZ["bound_s"],
    }
    log(f"[featviz] {json.dumps(summary)}")
    missed += [name for name, bound in FEATVIZ_GATE.items() if not gate_err[name] <= bound]
    if missed:  # after the line, so that a miss still prints every measurement
        raise AssertionError(f"[featviz] gates missed: {missed}")
    return launches


def lm_corpus(vocab: int, n: int, seq_len: int):
    """The JAX lm_audit tool's topic corpus, its stand-in tokenizer at ``vocab``, left-padded with vocab − 1."""
    from semanticlens_tpu_torch.collect import TokenTextDataset
    from semanticlens_tpu_torch.lm_audit import TOPICS

    texts = [f"{TOPICS[i % len(TOPICS)]} appears in sentence {i}" for i in range(n)]
    return TokenTextDataset.from_texts(texts, lambda t: [ord(c) % vocab for c in t], seq_len, pad="left",
                                       pad_id=vocab - 1, name=f"lm-topics-{n}x{seq_len}")


def lm_subject(family: str, cls_name: str, device, dtype, depth: int | None = None):
    """A published-width LM subject from its zoo name, pad-aware (pad id vocab − 1), optionally cut in depth."""
    from semanticlens_tpu_torch import models

    cls = getattr(models, cls_name)
    preset = cls._HF_VARIANTS[family]
    if cls is models.GPT2:
        kw = dict(zip(("width", "depth", "heads"), preset))
        vocab = 50257
    else:
        kw = dict(preset)
        vocab = kw["vocab_size"]
    if depth is not None:
        kw["depth"] = depth
    return cls(**kw, dtype=dtype, pad_id=vocab - 1, device=device)


def lm_float32_gates(dev) -> dict:
    """Every family at its published width, depth 2, float32 (TF32 off), card against the port on the CPU
    on 8 left-padded rows of 64 tokens: logits and taps; on the card, a left-padded row against its
    unpadded tokens, and the keep-all ablation mask's Δ (weights drawn on the card from seed 0)."""
    from semanticlens_tpu_torch import causal

    out = {}
    t_rows, t = LM_GATE["rows"], LM_GATE["seq_len"]
    for family, cls_name, mlp, heads in LM_GATE["families"]:
        card = lm_subject(family, cls_name, dev, torch.float32, depth=LM_GATE["depth"])
        cpu = lm_subject(family, cls_name, "cpu", torch.float32, depth=LM_GATE["depth"])
        t0 = time.perf_counter()
        params = card.init(0, device_draw=True)
        cpu_params = {k: v.cpu() for k, v in params.items()}
        init_s = time.perf_counter() - t0
        vocab, pad = card.vocab_size, card.pad_id
        ids = np.random.default_rng(1).integers(0, vocab - 1, size=(t_rows, t)).astype(np.int32)
        for r in range(t_rows):
            ids[r, : 4 * r] = pad  # row r left-padded by 4·r tokens
        x = torch.from_numpy(ids)
        with torch.no_grad():
            c_out, c_taps = card.apply(params, x, (mlp, heads))
            t0 = time.perf_counter()
            p_out, p_taps = cpu.apply(cpu_params, x, (mlp, heads))
            cpu_s = time.perf_counter() - t0
            gate = {"logits": _max_rel(c_out, p_out, _scale(p_out)),
                    "mlp_tap": _max_rel(c_taps[mlp], p_taps[mlp], _scale(p_taps[mlp])),
                    "heads_tap": _max_rel(c_taps[heads], p_taps[heads], _scale(p_taps[heads]))}
            n_pad = 4 * (t_rows - 1)
            u_out, u_taps = card.apply(params, x[t_rows - 1 :, n_pad:], (mlp,))
            gate["padded_row_vs_unpadded"] = max(
                _max_rel(c_out[t_rows - 1 :, n_pad:], u_out, _scale(u_out)),
                _max_rel(c_taps[mlp][t_rows - 1 :, n_pad:], u_taps[mlp], _scale(u_taps[mlp])))
            keep_all = torch.ones((1, c_taps[mlp].shape[-1]), dtype=torch.float32, device=dev)
            kept = causal._masked_forwards(card, params, mlp, x.to(dev), keep_all, lambda v, m: (v * m).to(v.dtype))
            gate["keep_all_delta_of_logits"] = _max_rel(kept[0], c_out, _scale(c_out))
        out[family] = {**gate, "vocab": vocab, "width": card.width, "init_s": init_s, "cpu_forward_s": cpu_s,
                       "finite": bool(torch.isfinite(c_out).all())}
        del card, cpu, params, cpu_params, c_out, c_taps, p_out, p_taps, kept
        torch.cuda.empty_cache()
    return out


def lm_audit_stages(dev, lm, layers, ds, fm, lens, root: Path, label: str) -> tuple[dict, object]:
    """The lm_audit workflow on one full-width subject: collect → embed (cold, then warm apart) → soft-WPMI
    labels over the topics → clarity and redundancy (cold and warm) → necessity ratios of the clearest MLP
    components against control rows → ε-plus-flat token relevance of 8 evidence rows → highlighted evidence
    → the text report. Returns the summary and the visualizer."""
    from semanticlens_tpu_torch import causal
    from semanticlens_tpu_torch.collect import TextActivationComponentVisualizer
    from semanticlens_tpu_torch.lm_audit import TOPICS
    from semanticlens_tpu_torch.relevance import highlight_evidence, make_token_relevance_fn

    n, seq, batch = len(ds), ds.images.shape[1], LM["batch"]
    mlp = layers[0]
    rng = np.random.default_rng(0)
    cv = TextActivationComponentVisualizer(model=lm, dataset_model=ds, dataset_fm=ds.texts_view(),
                                           layer_names=layers, num_samples=LM["evidence"], cache_dir=str(root))
    summary = {"layers": layers, "texts": n, "seq_len": seq, "batch": batch}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, time.perf_counter() - t0

    db, s = timed(lambda: lens.compute_concept_db(cv, batch_size=batch))
    summary["collect_embed_cold_s"] = s
    _, s = timed(lambda: cv._run(batch_size=batch, checkpoint=0))
    summary["collect_warm"] = {"seconds": s, "tokens_per_s": n * seq / s, "texts_per_s": n / s}
    _, s = timed(lambda: cv._embed_vision_dataset(lens.fm, batch, checkpoint=0))
    summary["embed_warm"] = {"seconds": s, "strings_per_s": n / s}
    summary["collect_embed_cold"] = {"tokens_per_s": n * seq / summary["collect_embed_cold_s"]}
    db = {k: np.asarray(v) for k, v in db.items()}
    agg = {k: v.mean(1) for k, v in db.items()}
    ids = {k: np.asarray(cv.get_max_reference(k)) for k in layers}
    summary["sentinel_slots"] = {}
    for k in layers:
        if list(db[k].shape) != LM["db_shapes"][k] or not np.isfinite(db[k]).all():
            raise AssertionError(f"[lm] {label} {k}: DB {db[k].shape} or non-finite values")
        # A slot no sample filled keeps the reference's sentinel (id −1, value 0.0): a component whose
        # token-mean is never positive has one. Every filled slot names a sample with a non-empty text.
        filled = ids[k] >= 0
        values = cv.actmax_cache[k].activations.float().numpy()
        if ids[k].min() < -1 or ids[k].max() >= n or (values[~filled] != 0.0).any():
            raise AssertionError(f"[lm] {label} {k}: evidence ids out of [0, {n}) or a sentinel with a value")
        texts = cv.get_max_reference_texts(k)
        if not all(t for row, ok in zip(texts, filled) for t, f in zip(row, ok) if f):
            raise AssertionError(f"[lm] {label} {k}: an empty evidence string")
        summary["sentinel_slots"][k] = {"slots": int((~filled).sum()), "components": int((~filled).any(1).sum())}

    stages = {}
    for run in ("cold", "warm"):
        labels, s_lab = timed(lambda: lens.label_components(
            TOPICS, agg, scoring="wpmi", evidence_ids=ids, image_embeds=cv.embedding_table))
        clarity, s_cla = timed(lambda: lens.eval_clarity(db))
        redundancy, s_red = timed(lambda: lens.eval_redundancy(agg))
        stages[run] = {"labels_s": s_lab, "clarity_s": s_cla, "redundancy_s": s_red}
    summary["analyze"] = stages
    clarity = {k: torch.as_tensor(v).float().cpu().numpy() for k, v in clarity.items()}
    for k in layers:
        words = labels[k][0]
        if len(words) != db[k].shape[0] or not all(w[0] in TOPICS for w in words):
            raise AssertionError(f"[lm] {label} {k}: labels outside the topic vocabulary")
        if not np.isfinite(clarity[k]).all() or not np.isfinite(float(torch.as_tensor(redundancy[k]))):
            raise AssertionError(f"[lm] {label} {k}: non-finite clarity or redundancy")
    summary["clarity_mean"] = {k: float(np.mean(v)) for k, v in clarity.items()}
    summary["redundancy"] = {k: float(torch.as_tensor(v)) for k, v in redundancy.items()}

    full = (ids[mlp] >= 0).all(1)  # components with every evidence slot filled
    clearest = np.argsort(-np.where(full, clarity[mlp], -np.inf))[: LM["necessity_components"]]
    tokens = ds.images

    def necessity():
        ratios = []
        for comp in clearest:
            ev = ids[mlp][comp]
            ctl = rng.choice(n, size=ev.size, replace=False)
            ratios.append(float(causal.necessity_ratio(lm, lm.params, mlp, [int(comp)], tokens[ev], tokens[ctl])[0]))
        return ratios

    ratios, s = timed(necessity)
    if not (np.isfinite(ratios).all() and min(ratios) > 0):
        raise AssertionError(f"[lm] {label} necessity ratios {ratios}")
    summary["necessity"] = {"components": len(ratios), "seconds": s, "median": float(np.median(ratios)),
                            "min": float(np.min(ratios)), "max": float(np.max(ratios))}

    # Token relevance: the top evidence row of each of the 8 clearest components, unnormalised, so the
    # per-row sums can be held against the component's summed activation.
    fn = make_token_relevance_fn(lm, mlp, composite="epsilon_plus_flat", abs_norm=False)
    pairs = [(int(c), int(ids[mlp][c][0])) for c in clearest[: LM["relevance_rows"]]]

    def relevance():
        return torch.cat([fn(lm.params, tokens[row : row + 1], comp) for comp, row in pairs])

    rel, s = timed(relevance)
    _, s_warm = timed(relevance)
    rows = np.array([row for _, row in pairs])
    with torch.no_grad():
        _, taps = lm.apply(lm.params, tokens[rows], (mlp,))
    act = taps[mlp].float()[torch.arange(len(pairs)), :, torch.as_tensor([c for c, _ in pairs])]  # (8, T)
    conservation = ((rel.sum(1) - act.sum(1)).abs() / act.abs().sum(1)).cpu().numpy()
    if rel.shape != (len(pairs), seq) or not torch.isfinite(rel).all():
        raise AssertionError(f"[lm] {label} token relevance {tuple(rel.shape)} or non-finite values")
    pad = lm.pad_id
    strings = [["" if tok == pad else chr(tok) for tok in tokens[row]] for row in rows]
    highlighted = highlight_evidence(strings, rel)
    if not all("**" in h for h in highlighted):
        raise AssertionError(f"[lm] {label} highlight_evidence marked no token")
    summary["relevance"] = {"rows": len(pairs), "cold_s": s, "rows_per_s_cold": len(pairs) / s,
                            "warm_s": s_warm, "rows_per_s_warm": len(pairs) / s_warm,
                            "conservation_rel": [float(c) for c in conservation], "example": highlighted[0]}
    report = cv.visualize_components(clearest[:4].tolist(), mlp)
    path = cv.storage_dir / "plots" / f"{mlp}-components.txt"
    if not path.exists() or path.read_text() != report or "''" in report:
        raise AssertionError(f"[lm] {label} the text report is missing or has empty evidence")
    return summary, cv


def phase_lm(dev, root: Path):
    """The LM subjects: the float32 gates of every family at published width (the gemma2 CLI in its own
    process meanwhile), then the lm_audit workflow on Llama-3.2-1B bf16 and GPT-2 bf16 at full width with
    CLIP ViT-B/32 float32, and the text SAE on GPT-2 trained and audited (K1 counted from 0 around both)."""
    from semanticlens_tpu_torch import Lens, sae
    from semanticlens_tpu_torch.collect import TextSAEComponentVisualizer
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.lm_audit import REPORT_KEYS, TOPICS
    from semanticlens_tpu_torch.ops import cosine as k1

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    summary = {}

    # 1. The gemma2 CLI at the tool's defaults in its own process while the float32 gates run.
    out_path, err_path = root / "lm_audit_cli.json", root / "lm_audit_cli.log"
    with open(out_path, "w") as out_file, open(err_path, "w") as err_file:
        t_cli = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "semanticlens_tpu_torch.lm_audit", "--family", "gemma2"],
                                cwd=Path(__file__).resolve().parent, stdout=out_file, stderr=err_file)
        try:
            gates = lm_float32_gates(dev)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    summary["gates"] = gates
    cli_lines = [json.loads(line) for line in out_path.read_text().splitlines() if line.startswith("{")]
    summary["cli"] = {"family": "gemma2", "process_s": time.perf_counter() - t_cli, "rc": rc, "stages": cli_lines}
    gates_s = time.perf_counter() - t_phase

    # 2. Weights: the numpy draw in the JAX layout (init(seed)) timed on GPT-2, the device draw on both.
    ds = lm_corpus(128256, LM["texts"], LM["seq_len"])
    init = {}
    llama = lm_subject(LM["llama"], "Llama", dev, torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llama.params = llama.init(0, device_draw=True)
    torch.cuda.synchronize()
    init["llama_device_draw_s"] = time.perf_counter() - t0
    init["llama_weights"] = sum(v.numel() for v in llama.params.values())
    llama.name = "llama-3.2-1b-seed0"
    gpt2 = lm_subject("gpt2", "GPT2", dev, torch.bfloat16)
    t0 = time.perf_counter()
    numpy_params = gpt2.init(0)
    torch.cuda.synchronize()
    init["gpt2_numpy_draw_s"] = time.perf_counter() - t0
    init["gpt2_weights"] = sum(v.numel() for v in numpy_params.values())
    del numpy_params
    t0 = time.perf_counter()
    gpt2.params = gpt2.init(0, device_draw=True)
    torch.cuda.synchronize()
    init["gpt2_device_draw_s"] = time.perf_counter() - t0
    gpt2.name = "gpt2-seed0"
    t0 = time.perf_counter()
    fm = OpenClip("ViT-B-32", dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    init["clip_numpy_draw_s"] = time.perf_counter() - t0
    init["numpy_weights_per_s"] = init["gpt2_weights"] / init["gpt2_numpy_draw_s"]
    summary["init"] = init
    lens = Lens(fm)

    # 3. The main path, K1 counted from 0: Llama-3.2-1B, GPT-2, the text SAE trained and audited.
    k1.reset_launch_counts()
    summary["llama"], _ = lm_audit_stages(dev, llama, LM["llama_layers"], ds, fm, lens, root / "llama", "llama")
    del llama
    torch.cuda.empty_cache()
    ds_gpt2 = lm_corpus(50257, LM["texts"], LM["seq_len"])
    summary["gpt2"], _ = lm_audit_stages(dev, gpt2, LM["gpt2_layers"], ds_gpt2, fm, lens, root / "gpt2", "gpt2")
    cfg = sae.SAEConfig(d_in=3072, n_latents=LM["sae_latents"], k=LM["sae_k"], aux_k=LM["sae_aux_k"],
                        batch_rows=LM["sae_batch_rows"], seed=0)
    record = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_sae_steps(record):
        dictionary = TextSAEComponentVisualizer.train(gpt2, ds_gpt2, LM["sae_layer"], cfg,
                                                      batch_size=LM["sae_batch"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    hist = sae_history(record)
    steps = len(hist["l0"])
    cv_sae = TextSAEComponentVisualizer(gpt2, ds_gpt2, ds_gpt2.texts_view(), LM["sae_layer"], dictionary,
                                        LM["evidence"], cache_dir=str(root / "sae"))
    tap = cv_sae.layer_names[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sae_db = np.asarray(lens.compute_concept_db(cv_sae, batch_size=LM["batch"])[tap])
    sae_agg = sae_db.mean(1)
    sae_words = lens.label_components(TOPICS, {tap: sae_agg}, scoring="wpmi",
                                      evidence_ids={tap: cv_sae.get_max_reference(tap)},
                                      image_embeds=cv_sae.embedding_table)[tap][0]
    sae_clarity = torch.as_tensor(lens.eval_clarity({tap: sae_db})[tap]).float().cpu().numpy()
    sae_red = float(torch.as_tensor(lens.eval_redundancy({tap: sae_agg})[tap]))
    torch.cuda.synchronize()
    audit_s = time.perf_counter() - t0
    launches = k1.launch_counts()
    summary["sae"] = {"layer": LM["sae_layer"], "d_in": cfg.d_in, "latents": cfg.n_latents, "k": cfg.k,
                      "aux_k": cfg.aux_k, "batch_rows": cfg.batch_rows, "steps": steps, "train_s": train_s,
                      "steps_per_s": steps / train_s, "rows_per_s": steps * cfg.batch_rows / train_s,
                      "l0": [float(hist["l0"].min()), float(hist["l0"].max())],
                      "fvu_first": float(hist["fvu"][0]), "fvu_last": float(hist["fvu"][-1]),
                      "audit_s": audit_s, "clarity_mean": float(np.nanmean(sae_clarity)), "redundancy": sae_red}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    phase_s = time.perf_counter() - t_phase
    summary.update({"k1_launches": launches, "peak_mem_gb": peak_gb, "gates_and_cli_s": gates_s,
                    "phase_s": phase_s, "bound_s": LM["bound_s"], "within_bound": phase_s <= LM["bound_s"]})
    log(f"[lm] {json.dumps(summary)}")

    # Gates after the line, so that a miss still prints every measurement.
    missed = [f"{family}:{name}" for family, g in gates.items() for name in
              ("logits", "mlp_tap", "heads_tap", "padded_row_vs_unpadded") if not g[name] <= LM_GATE["rel"]]
    missed += [f"{family}:keep_all" for family, g in gates.items()
               if not g["keep_all_delta_of_logits"] <= CAUSAL_GATE["invariant"]]
    missed += [f"{family}:finite" for family, g in gates.items() if not g["finite"]]
    if not max(summary["llama"]["relevance"]["conservation_rel"]) <= LM_GATE["conservation_rel"]:
        missed.append("llama:conservation")
    if rc != 0 or [c.get("stage") for c in cli_lines] != list(REPORT_KEYS) or any(
            tuple(c) != REPORT_KEYS[c["stage"]] for c in cli_lines):
        missed.append("cli")
    if steps != LM["texts"] * LM["seq_len"] // cfg.batch_rows or not np.all(hist["l0"] == cfg.k):
        missed.append("sae:l0")
    if not hist["fvu"][-1] < hist["fvu"][0] or not np.isfinite(hist["loss"]).all():
        missed.append("sae:fvu")
    if list(sae_db.shape) != LM["db_shapes"][tap] or not np.isfinite(sae_db).all() or len(sae_words) != cfg.n_latents:
        missed.append("sae:audit")
    if not (launches["streaming"] > 0 and launches["tiled"] > 0):
        missed.append("k1_launches")
    if missed:
        raise AssertionError(f"[lm] gates missed: {missed}{'' if rc == 0 else chr(10) + err_path.read_text()[-4000:]}")
    return launches


def zoo_models(cls_name: str, kw: dict, dtype, devices) -> list:
    """``(model, params)`` of one zoo family on each device, one numpy draw (seed 0) for all."""
    from semanticlens_tpu_torch import models

    built = [getattr(models, cls_name)(**kw, dtype=dtype, device=d) for d in devices]
    weights = built[0].init_jax_layout(0)
    return [(m, m.load_jax_params(weights)) for m in built]


def zoo_default_layers(label: str, argv: list) -> list:
    """The JAX tool's default ``full_audit`` layers of the family (torchvision names for ConvNeXt's twin)."""
    from semanticlens_tpu_torch import full_audit
    from semanticlens_tpu_torch.models.convnext import _to_torchvision

    layers = full_audit._zoo_model(full_audit.parse_args(argv), "cpu")[1]
    return [_to_torchvision(layer) for layer in layers] if label.endswith("torchvision") else list(layers)


def zoo_float32_gates(dev, cfg) -> dict:
    """Every family of ``cfg["gates"]`` at published width in float32 (seed 0), card against CPU on 2 images at
    224²: logits and every default full_audit tap relative to each one's scale."""
    x = torch.rand(cfg["gate_images"], cfg["size"], cfg["size"], 3, generator=torch.Generator().manual_seed(4)) * 2 - 1
    out = {}
    for label, cls_name, kw, argv in cfg["gates"]:
        layers = zoo_default_layers(label, argv)
        t = time.perf_counter()
        (card, card_p), (cpu, cpu_p) = zoo_models(cls_name, kw, torch.float32, (dev, torch.device("cpu")))
        with torch.inference_mode():
            got, got_taps = card.apply(card_p, x.to(dev), layers)
            want, want_taps = cpu.apply(cpu_p, x, layers)
        taps = {layer: _max_rel(got_taps[layer], want_taps[layer], _scale(want_taps[layer])) for layer in layers}
        out[label] = {"weights": sum(v.numel() for v in cpu_p.values()), "layers": layers,
                      "logits": _max_rel(got, want, _scale(want)), "taps": taps, "worst_tap": max(taps.values()),
                      "finite": bool(torch.isfinite(got).all()), "s": time.perf_counter() - t}
        del card, card_p, cpu, cpu_p
    return out


def heatmap_rows(dev, cfg) -> dict:
    """ε-plus-flat and ε heatmaps (components 0 and 1, abs-max normalised) of each ``cfg["heatmaps"]`` family and
    layer, card against CPU in float32 and in float64, the card's float32 ε maps again with cuDNN held to
    deterministic algorithms, and the ``heat_mean_rel`` controls (a wrong composite; TF32 on) of both composites."""
    from semanticlens_tpu_torch.relevance import make_attribution_fn

    x = torch.rand(cfg["gate_images"], cfg["size"], cfg["size"], 3, generator=torch.Generator().manual_seed(5)) * 2 - 1
    cpu = torch.device("cpu")
    composites = ("epsilon_plus_flat", "epsilon")
    out = {}
    for cls_name, kw, layer in cfg["heatmaps"]:
        h = {}
        for dtype in (torch.float32, torch.float64):
            for where, (model, params) in zip(("card", "cpu"), zoo_models(cls_name, kw, dtype, (dev, cpu))):
                for composite in composites:
                    fn = make_attribution_fn(model, layer, composite=composite)

                    def maps():
                        return torch.stack([fn(params, x.to(model.device), c).cpu().double() for c in (0, 1)])

                    h[(where, dtype, composite)] = maps()
                    if where == "card" and dtype == torch.float32:
                        with patched(torch.backends.cuda.matmul, allow_tf32=True), \
                                patched(torch.backends.cudnn, allow_tf32=True):
                            h[("tf32", dtype, composite)] = maps()
                        if composite == "epsilon":
                            with patched(torch.backends.cudnn, deterministic=True, benchmark=False):
                                h[("deterministic", dtype, composite)] = maps()

        def gap(a, b, dtype=torch.float32):
            return (h[(a[0], dtype, a[1])] - h[(b[0], dtype, b[1])]).abs()

        row = {"finite": all(bool(torch.isfinite(v).all()) for k, v in h.items() if k[0] != "tf32"),
               "control_tf32_finite": all(bool(torch.isfinite(v).all()) for k, v in h.items() if k[0] == "tf32")}
        for composite, other in zip(composites, reversed(composites)):
            card, cpu_ = ("card", composite), ("cpu", composite)
            mean_h = float(h[("cpu", torch.float32, composite)].abs().mean())
            row[composite] = {
                "abs_max_float32": float(h[("card", torch.float32, composite)].abs().max()),
                "mean_abs_h_float32": mean_h,
                "float32_max": float(gap(card, cpu_).max()), "float32_mean": float(gap(card, cpu_).mean()),
                "float32_mean_rel": float(gap(card, cpu_).mean()) / mean_h,
                "control_wrong_composite_mean_rel": float(gap(("card", other), cpu_).mean()) / mean_h,
                "control_tf32_mean_rel": float(gap(("tf32", composite), cpu_).mean()) / mean_h,
                "float64_max": float(gap(card, cpu_, torch.float64).max()),
                "float32_vs_float64_card_max": float((h[("card", torch.float32, composite)]
                                                      - h[("card", torch.float64, composite)]).abs().max()),
                "float32_vs_float64_cpu_max": float((h[("cpu", torch.float32, composite)]
                                                     - h[("cpu", torch.float64, composite)]).abs().max())}
        row["epsilon"]["float32_max_cudnn_deterministic"] = float(gap(("deterministic", "epsilon"),
                                                                      ("cpu", "epsilon")).max())
        out[f"{cls_name}:{layer}"] = row
    return out


def zoo_heatmaps(dev, cfg) -> dict:
    """:func:`heatmap_rows` of ``cfg["heatmaps"]``; ε-plus-flat relevance through each ``cfg["z_plus_blocks"]`` block
    fed non-negative inputs, card against CPU; Σ relevance through each ``cfg["conservation_blocks"]`` block at ε
    1e-9 on the card."""
    from semanticlens_tpu_torch.models import layers as L

    cpu = torch.device("cpu")
    out = heatmap_rows(dev, cfg)

    def relevance(fn, xx, composite, epsilon, skip=0):
        xx = xx.requires_grad_(True)
        with L.lrp_composite(composite, epsilon=epsilon):
            for _ in range(skip):
                L._next_rule("conv")
            o = fn(xx)
        (r_in,) = torch.autograd.grad(o, xx, o.detach())
        return r_in, o.detach()

    gen = torch.Generator().manual_seed(6)
    z_plus = {}
    for label, cls_name, kw, make, shape in cfg["z_plus_blocks"]:
        xb = torch.randn(*shape, generator=gen).abs()
        (cm, cp), (pm, pp) = zoo_models(cls_name, kw, torch.float32, (dev, cpu))
        card_r, _ = relevance(make(cm, cp), xb.to(dev), "epsilon_plus_flat", 1e-6, skip=1)
        cpu_r, _ = relevance(make(pm, pp), xb, "epsilon_plus_flat", 1e-6, skip=1)
        z_plus[label] = _max_rel(card_r, cpu_r, _scale(cpu_r))
    conservation = {}
    for label, cls_name, kw, make, shape in cfg["conservation_blocks"]:
        (m, p), = zoo_models(cls_name, kw, torch.float32, (dev,))
        r_in, o = relevance(make(m, p), torch.randn(*shape, generator=gen).to(dev), "epsilon", 1e-9)
        r_in, r_out = float(r_in.double().sum()), float(o.double().sum())
        conservation[label] = {"sum_r_in": r_in, "sum_r_out": r_out, "rel": abs(r_in - r_out) / abs(r_out)}
    return out | {"z_plus_blocks_rel": z_plus, "conservation": conservation}


def zoo_heatmap_misses(heat: dict, heat_mean_rel: dict) -> list:
    """The heatmap gates' misses, a control that a composite's ``heat_mean_rel`` gate lets through among them."""
    maps = {name: row for name, row in heat.items() if ":" in name}

    def heat_ok(row, composite, mean_rel):
        return (row["finite"] and row[composite]["mean_abs_h_float32"] > 0
                and row["epsilon"]["float32_max"] <= LRP_HEAT_ATOL["epsilon"] and mean_rel <= heat_mean_rel[composite])

    missed = [f"{name} {composite}" for name, row in maps.items() for composite in ("epsilon_plus_flat", "epsilon")
              if not heat_ok(row, composite, row[composite]["float32_mean_rel"])]
    missed += [f"{name} {composite} passes {control}" for name, row in maps.items()
               for composite in ("epsilon_plus_flat", "epsilon")
               for control in ("control_wrong_composite_mean_rel", "control_tf32_mean_rel")
               if heat_ok(row, composite, row[composite][control])]
    missed += [f"z+ {name}" for name, rel in heat["z_plus_blocks_rel"].items()
               if not rel <= LRP_HEAT_ATOL["epsilon_plus_flat"]]
    missed += [f"conservation {name}" for name, c in heat["conservation"].items() if not c["rel"] <= LRP_CONSERVATION_RTOL]
    return missed


def phase_zoo(dev, root: Path, cfg) -> dict:
    """One half of the vision zoo (``ZOO`` or ``ZOO2``): the float32 gates of every family and the heatmap gates (the
    ``cfg["cli"]`` commands in their own processes meanwhile), then the main path, K1 counted from 0:
    ``full_audit.main`` at ``cfg["main"]`` and AUDIT5's sizes, cold and warm; then every other family through
    ``full_audit.main`` at the JAX tool's defaults over ``family_images``, K1 counted apart. Each run's first forward
    is timed. Returns the main path's K1 launches."""
    from semanticlens_tpu_torch import causal_audit, full_audit
    from semanticlens_tpu_torch.ops import cosine as k1

    tag = cfg["label"]
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    summary = {}

    # 1. The two CLIs in their own processes while the float32 and heatmap gates run.
    cmds = {"full_audit": ["semanticlens_tpu_torch.full_audit", *cfg["cli"]["full_audit"], "--n-synthetic",
                           str(cfg["family_images"])],
            "causal_audit": ["semanticlens_tpu_torch.causal_audit", *cfg["cli"]["causal_audit"], "--image-size",
                             str(cfg["size"])]}
    procs, t_cli = {}, time.perf_counter()
    with contextlib.ExitStack() as files:
        try:
            for name, cmd in cmds.items():
                out, err = (files.enter_context(open(root / f"{name}.{ext}", "w")) for ext in ("out", "err"))
                procs[name] = subprocess.Popen([sys.executable, "-m", *cmd], cwd=Path(__file__).resolve().parent,
                                               stdout=out, stderr=err)
            gates = zoo_float32_gates(dev, cfg)
            heat = zoo_heatmaps(dev, cfg)
            rcs = {name: proc.wait(timeout=600) for name, proc in procs.items()}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
    cli = {"process_s": time.perf_counter() - t_cli, "rc": rcs}
    lines = {name: [json.loads(line) for line in (root / f"{name}.out").read_text().splitlines()
                    if line.startswith("{")] for name in cmds}
    if lines["full_audit"]:
        fa = lines["full_audit"][-1]
        cli["full_audit"] = {"keys_ok": tuple(fa) == full_audit.REPORT_KEYS, "db_shapes": fa.get("db_shapes"),
                             "images_per_s_fused": fa["stages"]["collect+embed"]["items_per_sec"]}
    if lines["causal_audit"]:
        cli["causal_audit"] = lines["causal_audit"][-1] | {
            "keys_ok": tuple(lines["causal_audit"][-1]) == causal_audit.REPORT_KEYS}
    summary.update({"float32_gates": gates, "heatmaps": heat, "cli": cli,
                    "gates_and_cli_s": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()

    # 2. The main path, K1 counted from 0 for it alone; then the other families, K1 counted apart.
    words = vocabulary(1000)
    argv = [*cfg["main"], "--n-synthetic", str(cfg["images"]), "--vocabulary", *words,
            "--image-query-indices", *map(str, AUDIT5["image_queries"])]
    reports, walls, record, families, forwards = {}, {}, [], {}, []
    fm_memo = {}
    build_fm_real, build_model_real = full_audit.build_fm, full_audit.build_model

    def build_fm(args, device):  # one seed-0 CLIP ViT-B/32 for the families' runs
        if "fm" not in fm_memo:
            fm_memo["fm"] = build_fm_real(args, device)
        return fm_memo["fm"]

    def build_model(args, device):  # the subject, the first forward of each one built timed
        model, aggregate_fn = build_model_real(args, device)
        apply, first = model.apply, {"model": model.name}
        forwards.append(first)

        def timed_apply(params, x, tap_names=()):
            if "s" in first:
                return apply(params, x, tap_names)
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = apply(params, x, tap_names)
            torch.cuda.synchronize()
            first["s"] = time.perf_counter() - t
            return result

        model.apply = timed_apply
        return model, aggregate_fn

    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(io.StringIO()), patched(full_audit, build_model=build_model):
        k1.reset_launch_counts()
        with recording_concept_dbs(record):
            for name, extra in (("cold", []), ("warm", ["--label-scoring", "wpmi"])):
                t = time.perf_counter()
                reports[name] = full_audit.main(argv + extra)
                walls[name] = time.perf_counter() - t
                walls[f"{name}_first_forward"] = forwards[-1]["s"]
        launches = k1.launch_counts()
        main_peak_gb = torch.cuda.max_memory_allocated() / 2**30
        k1.reset_launch_counts()
        with patched(full_audit, build_fm=build_fm):
            for fam in cfg["families"]:
                t = time.perf_counter()
                report = full_audit.main(fam + ["--n-synthetic", str(cfg["family_images"])])
                families[" ".join(fam)] = {
                    "model": forwards[-1]["model"], "layers": report["layers"],
                    "components": sum(v[0] for v in report["db_shapes"].values()), "db_shapes": report["db_shapes"],
                    "images_per_s_collect_embed": report["stages"]["collect+embed"]["items_per_sec"],
                    "first_forward_s": forwards[-1]["s"], "main_s": time.perf_counter() - t,
                    "finite": bool(np.isfinite([v for sc in report["scores"].values() for v in sc.values()]).all()),
                    "keys_ok": tuple(report) == full_audit.REPORT_KEYS}
        family_launches = k1.launch_counts()
    del fm_memo
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    try:
        check_audit_reports(tag, reports, record, cfg["db_shapes"], words, dev)
        report_missed = []
    except AssertionError as e:
        report_missed = [str(e)]
    del record
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    summary.update({
        "main_path": {
            "images": cfg["images"], "components": sum(s[0] for s in cfg["db_shapes"].values()),
            "db_shapes": reports["cold"]["db_shapes"],
            "images_per_s_fused_cold": reports["cold"]["stages"]["collect+embed"]["items_per_sec"],
            "images_per_s_fused_warm": reports["warm"]["stages"]["collect+embed"]["items_per_sec"],
            "main_wall_s": walls,
            "stages_s": {name: {stage: round(v["seconds"], 4) for stage, v in r["stages"].items()}
                         for name, r in reports.items()},
            "scores_cold": reports["cold"]["scores"], "peak_mem_gb": main_peak_gb},
        "families": families, "k1_launches_main": launches, "k1_launches_families": family_launches,
        "peak_mem_gb": peak_gb, "phase_s": phase_s, "bound_s": cfg["bound_s"],
        "within_bound": phase_s <= cfg["bound_s"]})
    log(f"[{tag}] {json.dumps(summary)}")
    log(f"[{tag}] K1 launches by variant: main path {json.dumps(launches)}, "
        f"other families {json.dumps(family_launches)}")

    # Gates after the line, so that a miss still prints every measurement.
    missed = [f"{label}:logits" for label, g in gates.items() if not (g["logits"] <= ZOO_GATE["rel"] and g["finite"])]
    missed += [f"{label}:taps" for label, g in gates.items() if not g["worst_tap"] <= ZOO_GATE["rel"]]
    missed += zoo_heatmap_misses(heat, cfg["heat_mean_rel"]) + report_missed
    missed += [f"family {fam}" for fam, f in families.items() if not (f["finite"] and f["keys_ok"])]
    if rcs != {"full_audit": 0, "causal_audit": 0} or not cli.get("full_audit", {}).get("keys_ok") or not cli.get(
            "causal_audit", {}).get("keys_ok"):
        missed.append("cli")
    missed += [f"k1_launches {path} {variant}" for path, counts in (("main", launches), ("families", family_launches))
               for variant in ("tiled", "streaming") if not counts[variant] > 0]
    if not phase_s <= cfg["bound_s"]:
        missed.append(f"phase {phase_s:.1f} s > {cfg['bound_s']} s")
    if missed:
        tails = "".join(f"\n{name}: {(root / f'{name}.err').read_text()[-3000:]}" for name, rc in rcs.items() if rc)
        raise AssertionError(f"[{tag}] gates missed: {missed}{tails}")
    return launches


def _synthetic_images(n: int, size: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


def _config5_models(dev):
    """ResNet-50 bf16 and CLIP ViT-B/32 bf16, both from seed 0, with the audit's preprocess."""
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    model = ResNet(depth=50, dtype=torch.bfloat16, device=dev)
    model.params, model.name = model.init(seed=0), "resnet50-mesh"
    fm = OpenClip("ViT-B-32", dtype=torch.bfloat16, device=dev, seed=0)
    return model, fm, make_preprocess_fn(size=MESH["size"], crop=MESH["size"])


def _states_equal(a, b) -> bool:
    return all(torch.equal(a[k].ids.cpu(), b[k].ids.cpu()) and torch.equal(a[k].values.cpu(), b[k].values.cpu())
               for k in b)


def _sae_cfg():
    from semanticlens_tpu_torch import sae

    return sae.SAEConfig(d_in=MESH["sae_d_in"], n_latents=MESH["sae_latents"], k=MESH["sae_k"],
                         batch_rows=MESH["sae_batch_rows"], seed=0)


def _sae_rows() -> np.ndarray:
    """Gaussian rows scaled row by row by a log-normal factor: heavy-tailed, as a layer's activations are,
    so that the two halves of a minibatch differ in variance (what the rank-mean fvu control needs to show)."""
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((MESH["sae_rows"], MESH["sae_d_in"]), np.float32)
    return rows * rng.lognormal(0.0, 1.0, (MESH["sae_rows"], 1)).astype(np.float32)


def mesh_world1(dev, root: Path) -> tuple[dict, dict]:
    """[mesh] (a): world 1 over NCCL in this process; returns (K1 launches of the meshed audit, readings)."""
    import os

    from semanticlens_tpu_torch import Lens, sae
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.collect.engine import CollectEngine
    from semanticlens_tpu_torch.core import data_mesh, data_model_mesh, init_distributed, shard_concept_db
    from semanticlens_tpu_torch.core.mesh import barrier
    from semanticlens_tpu_torch.data import ArrayDataset, Subset
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean, aggregate_transformer_mean
    from semanticlens_tpu_torch.parallel import llama_param_specs_2d, shard_params

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    init_distributed("nccl", store_path=root / "store", timeout_s=300)
    out = {}
    try:
        mesh = data_mesh()
        barrier()  # the communicator's first use, outside the timed runs
        model, fm, pre = _config5_models(dev)
        ds = ArrayDataset(_synthetic_images(MESH["images"], MESH["size"]), name="synthetic-mesh")
        lens = Lens(fm)

        def audit(m, score=True):
            cv = ActivationComponentVisualizer(model, ds, ds, MESH["layers"], MESH["num_samples"],
                                               aggregate_fn=aggregate_conv_mean, model_preprocess=pre, mesh=m)
            torch.cuda.synchronize()
            t = time.perf_counter()
            db = lens.compute_concept_db(cv, batch_size=MESH["batch"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if not score:
                return MESH["images"] / wall
            scored = db if m is None else shard_concept_db(db, m)
            agg = {k: v.mean(1) for k, v in db.items()}
            scores = {"clarity": lens.eval_clarity(scored), "poly": lens.eval_polysemanticity(scored),
                      "redundancy": lens.eval_redundancy(agg),
                      "probe": lens.text_probing(["dog"], agg, templates=TEMPLATES)}
            torch.cuda.synchronize()
            return cv, db, scores, MESH["images"] / wall

        audit(None, score=False)  # warm: cuDNN's first calls and the allocator
        k1.reset_launch_counts()
        meshed = audit(mesh)
        launches = k1.launch_counts()
        plain = audit(None)
        rates = {"mesh": [meshed[3]], "plain": [plain[3]]}
        for _ in range(2):  # in turns, so that neither path is favoured by the order
            rates["mesh"].append(audit(mesh, score=False))
            rates["plain"].append(audit(None, score=False))
        for name in MESH["layers"]:
            if not (np.array_equal(meshed[0].get_max_reference(name), plain[0].get_max_reference(name))
                    and torch.equal(meshed[0].actmax_cache[name].state.values.cpu(),
                                    plain[0].actmax_cache[name].state.values.cpu())
                    and np.array_equal(meshed[1][name], plain[1][name])):
                raise AssertionError(f"[mesh] (a) the meshed audit's {name} differs from the plain audit's")
            for key, by_layer in plain[2].items():
                if not torch.equal(torch.as_tensor(meshed[2][key][name]).cpu(), torch.as_tensor(by_layer[name]).cpu()):
                    raise AssertionError(f"[mesh] (a) {key} of {name} differs between meshed and plain audits")
        out["audit"] = {"images_per_s_mesh": rates["mesh"], "images_per_s_plain": rates["plain"],
                        "mesh_over_plain": float(np.mean(rates["mesh"]) / np.mean(rates["plain"])),
                        "components": sum(meshed[1][k].shape[0] for k in MESH["layers"])}
        del meshed, plain

        rows = torch.from_numpy(_sae_rows()).to(dev)
        cfg = _sae_cfg()
        dp, _, dp_m = sae.train_sae_from_rows(rows, cfg, steps=MESH["sae_steps"], mesh=mesh)
        one, _, one_m = sae.train_sae_from_rows(rows, cfg, steps=MESH["sae_steps"])
        if any(not torch.equal(dp[n], one[n]) for n in one if n != "k") or dp_m != one_m:
            raise AssertionError(f"[mesh] (a) the data-parallel SAE trainer differs at world 1: {dp_m} vs {one_m}")
        out["sae"] = {"fvu": one_m["fvu"], "l0": one_m["l0"]}
        del rows, dp, one

        llama = lm_subject(LM["llama"], "Llama", dev, torch.bfloat16)
        llama.params, llama.name = llama.init(0, device_draw=True), "llama-3.2-1b-seed0"
        toks = lm_corpus(128256, MESH["lm_texts"], MESH["lm_seq"])
        tp_mesh = data_model_mesh(1)
        sharded = shard_params(llama.params, tp_mesh, llama_param_specs_2d(llama))
        runs = {}
        for label, params, m in (("plain", llama.params, None), ("tp1", sharded, tp_mesh)):
            eng = CollectEngine(llama, [MESH["lm_layer"]], aggregate_transformer_mean, 5, mesh=m,
                                input_preprocess=lambda x: x.to(torch.int32))
            eng.run(params, Subset(toks, 0, 2 * MESH["lm_batch"]), MESH["lm_batch"])  # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            runs[label] = eng.run(params, toks, MESH["lm_batch"])[0]
            torch.cuda.synchronize()
            out[f"lm_tokens_per_s_{label}"] = MESH["lm_texts"] * MESH["lm_seq"] / (time.perf_counter() - t)
        if not _states_equal(runs["tp1"], runs["plain"]):
            a, b = runs["tp1"][MESH["lm_layer"]], runs["plain"][MESH["lm_layer"]]
            raise AssertionError(f"[mesh] (a) Llama-3.2-1B at tp = 1 differs from the plain run: ids equal "
                                 f"{(a.ids == b.ids).float().mean().item():.4f}, max |Δ value| "
                                 f"{(a.values.float() - b.values.float()).abs().max().item():.3g}")
        del llama, sharded, runs
    finally:
        torch.distributed.destroy_process_group()
    return launches, out


def mesh_rank(rank: int, world: int, dev, out: str):
    """[mesh] (b) on one of two gloo ranks sharing ``cuda:0``; rank 0 also runs the one-process references
    and writes ``mesh_ranks.json`` to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from semanticlens_tpu_torch import sae
    from semanticlens_tpu_torch.collect.engine import CollectEngine
    from semanticlens_tpu_torch.core import data_mesh
    from semanticlens_tpu_torch.core.mesh import all_reduce, barrier
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
    from semanticlens_tpu_torch.parallel import collect_multihost, fused_multihost, multihost

    mesh = data_mesh()
    res = {"rank": rank}
    rank_log = functools.partial(print, f"[mesh] rank {rank}:", file=sys.stderr, flush=True)
    rank_log("group and mesh up")
    model, fm, pre = _config5_models(dev)
    ds = ArrayDataset(_synthetic_images(MESH["images"], MESH["size"]), name="synthetic-mesh")
    layers, k, b = MESH["layers"], MESH["num_samples"], MESH["rank_batch"]

    def engine(m=None):
        return CollectEngine(model, layers, aggregate_conv_mean, k, mesh=m, input_preprocess=pre)

    def embed(x):
        return fm.encode_image_local(fm.preprocess(x))

    def timed(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        value = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return value, time.perf_counter() - t

    rank_log("models and data built")
    (dp_states, dp_embeds, _), dp_cold_s = timed(engine(mesh).run_fused, model.params, ds, b * world, embed)
    _, dp_s = timed(engine(mesh).run_fused, model.params, ds, b * world, embed)
    rank_log("meshed fused sweep done")
    (dp_run, _), _ = timed(engine(mesh).run, model.params, ds, b * world)
    (mh_states, _), mh_s = timed(collect_multihost, engine(), model.params, ds, b)
    rank_log("collect_multihost done")
    exchanges = {"merge": [], "rows": []}
    merge, gather = multihost.merge_states_across_processes, multihost.gather_selected_rows

    def timed_merge(states):
        barrier()  # both sweeps done: the time is the exchange's alone
        merged, ms = timed(merge, states)
        exchanges["merge"].append({"ms": ms * 1e3, "bytes": world * sum(st.values.numel() * 2 + st.ids.numel() * 4
                                                                           for st in states.values())})
        return merged

    def timed_gather(needed, local_rows, start, stop):
        barrier()
        rows, ms = timed(gather, needed, local_rows, start, stop)
        exchanges["rows"].append({"ms": ms * 1e3, "bytes": world * rows.nbytes, "rows": int(rows.shape[0])})
        return rows

    multihost.merge_states_across_processes, multihost.gather_selected_rows = timed_merge, timed_gather
    try:
        (fmh_states, fmh_db, _), fmh_s = timed(fused_multihost, engine(), model.params, ds, b, embed)
    finally:
        multihost.merge_states_across_processes, multihost.gather_selected_rows = merge, gather
    rank_log("fused_multihost done")
    res["images_per_s"] = {"meshed_fused_cold": MESH["images"] / dp_cold_s, "meshed_fused": MESH["images"] / dp_s,
                           "collect_multihost": MESH["images"] / mh_s,
                           "fused_multihost": MESH["images"] / fmh_s}
    res["exchanges"] = exchanges
    if rank == 0:  # one process at batch 128: each rank's rows met the same kernels at the same shapes
        (ref, ref_embeds, _), ref_s = timed(engine().run_fused, model.params, ds, b, embed)
        res["images_per_s"]["one_process_fused"] = MESH["images"] / ref_s
        res["equal"] = {"meshed_fused": _states_equal(dp_states, ref), "meshed_run": _states_equal(dp_run, ref),
                        "embeds": bool(np.array_equal(dp_embeds, ref_embeds)),
                        "collect_multihost": _states_equal(mh_states, ref),
                        "fused_multihost": _states_equal(fmh_states, ref)}
        db_equal = True
        for name in layers:
            ids = ref[name].ids.cpu().numpy()
            want = ref_embeds[ids]
            want[ids < 0] = 0.0
            db_equal &= bool(np.array_equal(fmh_db[name], want))
        res["equal"]["fused_multihost_db"] = db_equal
    del dp_states, dp_embeds, dp_run, mh_states, fmh_states, fmh_db, model, fm, ds
    torch.cuda.empty_cache()

    rank_log("references done")
    # the SAE trainer at world 2 against one process on the same global minibatches
    rows = torch.from_numpy(_sae_rows()).to(dev)
    cfg = _sae_cfg()
    history = []
    run_steps = sae._run_steps

    def recording(*args, **kwargs):
        run = run_steps(*args, **kwargs)

        def recorded(*a):
            out_ = run(*a)
            history.append(out_[3]["fvu"])
            return out_

        return recorded

    def train(steps, m, **patch):
        history.clear()
        old = {name: getattr(sae, name) for name in patch}
        for name, value in patch.items():
            setattr(sae, name, value)
        sae._run_steps = recording
        try:
            (params, _, _), s = timed(sae.train_sae_from_rows, rows, cfg, steps=steps, mesh=m)
        finally:
            sae._run_steps = run_steps
            for name, value in old.items():
                setattr(sae, name, value)
        return params, torch.cat(history).cpu().numpy(), s

    def rank_mean_fvu(err, target, group):  # control: the mean of the ranks' own fvu ratios
        local = torch.sum(err * err) / torch.clamp_min(torch.sum((target - torch.mean(target, dim=0)) ** 2), 1e-9)
        return all_reduce(local, group) / world

    sound1, _, _ = train(1, mesh)
    _, sound_fvu, sound_s = train(MESH["sae_steps"], mesh)
    skip1, _, _ = train(1, mesh, _all_reduce_grads=lambda grads, group: grads)
    _, mean_fvu, _ = train(MESH["sae_steps"], mesh, _fvu=rank_mean_fvu)
    res["sae_step_ms_world2"] = sound_s / MESH["sae_steps"] * 1e3
    if rank == 0:
        one1, _, _ = train(1, None)
        _, one_fvu, one_s = train(MESH["sae_steps"], None)
        res["sae_step_ms_one_process"] = one_s / MESH["sae_steps"] * 1e3

        def step1_rel(params):
            return max(float((params[n] - one1[n]).abs().max() / one1[n].abs().max().clamp_min(1e-30))
                       for n in one1 if n != "k")

        def fvu_rel(fvu):
            gap = np.abs(fvu - one_fvu) / np.abs(one_fvu)
            return {"fvu_step1_rel": float(gap[0]), "fvu_rel": float(gap.max())}

        res["sae"] = {"sound": {"step1_rel": step1_rel(sound1), **fvu_rel(sound_fvu)},
                      "skipped_grad_all_reduce": {"step1_rel": step1_rel(skip1)},
                      "rank_mean_fvu_ratios": fvu_rel(mean_fvu),
                      "fvu_first_last": [float(one_fvu[0]), float(one_fvu[-1])]}
    del rows
    torch.cuda.empty_cache()

    rank_log("SAE done")
    if rank == 0:
        (Path(out) / "mesh_ranks.json").write_text(json.dumps(res))


def phase_mesh(dev, root: Path) -> dict:
    """[mesh]: (a) in this process, then (b) on two gloo ranks sharing the card."""
    from semanticlens_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches, world1 = mesh_world1(dev, root)
    if launches["streaming"] < 1 or launches["tiled"] < 1:
        raise AssertionError(f"[mesh] K1 launches on the meshed audit: {launches}")
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    launch.spawn(mesh_rank, MESH["world"], root / "ranks", args=(str(root),), backend="gloo", device="cuda:0",
                 timeout_s=MESH["rank_timeout_s"])
    ranks_s = time.perf_counter() - t_ranks
    ranks = json.loads((root / "mesh_ranks.json").read_text())
    phase_s = time.perf_counter() - t_phase
    summary = {"note": "one card: (a) world 1 over NCCL; (b) two gloo ranks share cuda:0, so its rates "
                       "measure the layer's overhead, not scaling across cards; tp = 2 not run on the card",
               "world1": world1, "k1_launches": launches, "ranks_s": ranks_s, "ranks": ranks, "gate": MESH_GATE,
               "phase_s": phase_s, "bound_s": MESH["bound_s"], "within_bound": phase_s <= MESH["bound_s"]}
    log(f"[mesh] {json.dumps(summary)}")
    missed = [k for k, ok in ranks["equal"].items() if not ok]
    sae_ = ranks["sae"]
    gates = ("sae_step1_rel", "sae_fvu_step1_rel", "sae_fvu_rel")
    missed += [f"sae world 2 against one process: {g}" for g in gates if sae_["sound"][g[4:]] > MESH_GATE[g]]
    if sae_["skipped_grad_all_reduce"]["step1_rel"] <= MESH_GATE["sae_step1_rel"]:
        missed.append("the skipped-all-reduce control stayed within the step-1 bound")
    missed += [f"the rank-mean-fvu control stayed within {g}" for g in gates[1:]
               if sae_["rank_mean_fvu_ratios"][g[4:]] <= MESH_GATE[g]]
    if missed:  # after the line, so that a miss still prints every measurement
        raise AssertionError(f"[mesh] misses: {missed}")
    return launches


# The reproducer behind [mesh]'s missing tp = 2 (not run by ``main``): each variant on two gloo ranks sharing
# ``cuda:0``, in its own pair of processes so that a crash ends only that variant. ``c10d_*`` call the process
# group's all-gather on CUDA tensors directly; ``dtensor@{cpu,cuda}`` gathers a ``Shard(0)`` DTensor whose local
# chunk lies on the card, on a DeviceMesh of that device type; ``gpt2@{cpu,cuda}`` is GPT-2 (124 M, float32, TF32
# off, full width and depth) with ``gpt2_param_specs_2d`` placements at tp = 2 against its plain forward.
TP_PROBE = {"variants": ["c10d_all_gather_into_tensor", "c10d_all_gather", "dtensor@cpu", "dtensor@cuda",
                         "gpt2@cpu", "gpt2@cuda"],
            "tokens": (4, 64), "tap": "transformer.h.11.mlp.c_fc", "timeout_s": 300}


def tp_probe_rank(rank: int, world: int, dev, out: str, variant: str):
    """One variant of :func:`tp_gloo_probe` on one gloo rank; rank 0 writes ``{variant}.json`` to ``out``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    torch.backends.cuda.matmul.allow_tf32 = False
    kind, _, mesh_type = variant.partition("@")
    res = {"variant": variant, "backend": dist.get_backend(), "device": str(dev), "torch": torch.__version__}
    x = torch.arange(8 * 4, dtype=torch.float32, device=dev).reshape(8, 4) * (rank + 1)
    want = torch.cat([x / (rank + 1) * (r + 1) for r in range(world)])
    if kind == "c10d_all_gather_into_tensor":
        got = torch.empty(world * 8, 4, device=dev)
        dist.all_gather_into_tensor(got, x)
    elif kind == "c10d_all_gather":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        got = torch.cat(parts)
    else:
        mesh = DeviceMesh(mesh_type, torch.arange(world).reshape(1, world), mesh_dim_names=("data", "model"))
        res["mesh_device_type"] = mesh.device_type
    if kind == "dtensor":
        got = DTensor.from_local(x, mesh["model"], [Shard(0)], run_check=False).full_tensor()
    if kind in ("c10d_all_gather_into_tensor", "c10d_all_gather", "dtensor"):
        res["equal"] = bool(torch.equal(got.cpu(), want.cpu()))
    if kind == "gpt2":
        from semanticlens_tpu_torch.core.mesh import full_tensor, tensor_parallel_region
        from semanticlens_tpu_torch.parallel import gpt2_param_specs_2d, shard_params

        model = lm_subject("gpt2", "GPT2", dev, torch.float32)
        params = model.init(0, device_draw=True)
        toks = torch.from_numpy(np.random.default_rng(3).integers(0, 50256, TP_PROBE["tokens"])).to(dev)
        sharded = shard_params(params, mesh, gpt2_param_specs_2d(model))
        with tensor_parallel_region():
            logits, taps = model.apply(sharded, toks, (TP_PROBE["tap"],))
            logits, tap = full_tensor(logits), full_tensor(taps[TP_PROBE["tap"]])
        with torch.no_grad():
            ref_logits, ref_taps = model.apply(params, toks, (TP_PROBE["tap"],))
        res["logits_rel"] = _max_rel(logits, ref_logits, _scale(ref_logits))
        res["tap_rel"] = _max_rel(tap, ref_taps[TP_PROBE["tap"]], _scale(ref_taps[TP_PROBE["tap"]]))
    if rank == 0:
        (Path(out) / f"{variant}.json").write_text(json.dumps(res))


def tp_gloo_probe(root: str) -> dict:
    """Whether gloo carries DTensor's collectives on CUDA tensors for two ranks sharing ``cuda:0``.

    Run on a card: ``python -c "import chip_smoke as cs; cs.tp_gloo_probe('tp_probe')"``. Prints one JSON
    line per variant (its readings, or the launcher's error with the first rank traceback) and writes them
    all to ``{root}/tp_probe.json``; a rank killed by a signal prints its Python stack to standard error.
    """
    from semanticlens_tpu_torch.parallel import launch

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    results = {"smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True, timeout=60).stdout.strip()}
    for variant in TP_PROBE["variants"]:
        t = time.perf_counter()
        try:
            launch.spawn(tp_probe_rank, 2, root / variant.replace("@", "_"), args=(str(root), variant),
                         backend="gloo", device="cuda:0", timeout_s=TP_PROBE["timeout_s"])
            results[variant] = json.loads((root / f"{variant}.json").read_text())
        except RuntimeError as err:  # the probe records each variant's failure; it is not a phase
            results[variant] = {"error": str(err)[-3000:]}
        results[variant]["seconds"] = time.perf_counter() - t
        log(f"[tp_probe] {variant}: {json.dumps(results[variant])}")
    (root / "tp_probe.json").write_text(json.dumps(results, indent=1))
    return results


# --------------------------------------------------------------------------- int8
def int8_card_vs_cpu(dev) -> dict:
    """``x_q`` and the int32 accumulators of ``int8_matmul`` / ``int8_conv`` on the card against the CPU, on the
    same float32 inputs, at the main path's shapes: exactly equal, or this raises. The weights are quantized
    on each device too and must agree bit for bit."""
    from semanticlens_tpu_torch.ops import quant as tq

    gen = torch.Generator().manual_seed(0)
    cases = 0

    def both(fn, *cpu_args):
        card = fn(*(a.to(dev) for a in cpu_args))
        cpu = fn(*cpu_args)
        return [c.cpu() for c in card], cpu

    def exact(tag, card, cpu):
        for name, a, b in zip(("x_q", "acc", "q", "scale"), card, cpu):
            if not torch.equal(a, b):
                raise AssertionError(f"[int8] card vs CPU {tag}: {name} differs in {int((a != b).sum())} entries")

    def dense(x, w):
        qt = tq.quantize_weight(w)
        x_q, _ = tq.quantize_rows(x)
        return x_q, tq.int_mm(x_q.reshape(-1, x_q.shape[-1]), qt.q), qt.q, qt.scale

    rows = [INT8["batch"] * INT8["tokens"], *INT8["small_rows"]]
    for k, n in INT8["dense"]:
        w = torch.randn(n, k, generator=gen) * k**-0.5
        for m in rows:
            x = torch.randn(m, k, generator=gen)
            exact(f"dense {m}x{k}->{n}", *both(dense, x, w))
            cases += 1

    def conv(x, w, stride, padding, groups):
        qt = tq.quantize_weight(w)
        x_q, _ = tq.quantize_samples(x)
        return x_q, tq.int8_conv_acc(x_q, qt.q, stride=stride, padding=padding, groups=groups), qt.q, qt.scale

    for cin, cout, k, stride, side, groups in INT8_CONVS:
        x = torch.randn(INT8["gate_batch"], cin, side, side, generator=gen).abs()  # post-ReLU activations
        x = x.contiguous(memory_format=torch.channels_last)
        w = torch.randn(cout, cin // groups, k, k, generator=gen) * (cin // groups * k * k) ** -0.5
        card, cpu = both(lambda xx, ww: conv(xx, ww, stride, k // 2, groups), x, w)
        exact(f"conv {cin}->{cout} {k}x{k}/{stride} at {side}² groups {groups}", card, cpu)
        cases += 1
    return {"cases": cases, "all_exact": True}


def _per_image_cosine(a, b) -> torch.Tensor:
    a, b = a.float().flatten(1), b.float().flatten(1)
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))


def _images_per_s(fn, batches, n_images) -> float:
    fn(batches[0])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        fn(b)
    torch.cuda.synchronize()
    return n_images / (time.perf_counter() - t0)


def int8_towers(dev, images) -> tuple[dict, tuple]:
    """ViT-B/32, SigLIP2 ViT-B/16 and MobileCLIP-S2 at full width, bf16, each built twice from one numpy draw
    (float, ``quantize="int8"``): per-image cosine over 256 images, and both towers' images/s over the pool
    on preprocessed device-resident batches. Returns the readings and the ViT-B/32 pair."""
    from semanticlens_tpu_torch.foundation_models import clip as tclip
    from semanticlens_tpu_torch.foundation_models import mobileclip as tmc
    from semanticlens_tpu_torch.foundation_models import siglip as tsig

    batch = INT8["batch"]
    towers = {
        "vit_b_32": lambda np_params, q: tclip.OpenClip("ViT-B-32", jax_params=np_params, dtype=torch.bfloat16,
                                                        device=dev, quantize=q),
        "siglip2_vit_b_16": lambda np_params, q: tsig.SigLipV2(jax_params=np_params, dtype=torch.bfloat16,
                                                               device=dev, quantize=q),
        "mobileclip_s2": lambda np_params, q: tmc.ClipMobile("s2", jax_params=np_params, dtype=torch.bfloat16,
                                                             device=dev, quantize=q),
    }
    draws = {"vit_b_32": lambda: tclip.init_clip_params_jax_layout(0, tclip.CLIP_PRESETS["ViT-B-32"]),
             "siglip2_vit_b_16": lambda: tsig.init_siglip_params_jax_layout(
                 0, tsig.SIGLIP_PRESETS["ViT-B-16-SigLIP2"]),
             "mobileclip_s2": lambda: tmc.init_mobileclip_params_jax_layout(
                 0, tmc.MOBILECLIP_PRESETS["MobileCLIP-S2"])}
    out, vit_pair = {}, None
    for name, build in towers.items():
        t0 = time.perf_counter()
        np_params = draws[name]()
        fm, fmq = build(np_params, None), build(np_params, "int8")
        del np_params
        build_s = time.perf_counter() - t0
        batches = [fm.preprocess(torch.from_numpy(images[i : i + batch]).to(dev)) for i in range(0, len(images), batch)]
        with torch.inference_mode():
            a, b = fm.encode_image(batches[0]), fmq.encode_image(batches[0])
            cos = _per_image_cosine(a, b)
            if not (torch.isfinite(b).all() and b.shape == a.shape):
                raise AssertionError(f"[int8] {name}: int8 embeddings {tuple(b.shape)} not finite or misshapen")
            rates = {tag: _images_per_s(m.encode_image, batches, len(images)) for tag, m in (("bf16", fm),
                                                                                            ("int8", fmq))}
        out[name] = {"cosine_min": float(cos.min()), "cosine_mean": float(cos.mean()),
                     "images_per_s": rates, "int8_over_bf16": rates["int8"] / rates["bf16"],
                     "name": fmq.name, "build_s": build_s}
        if name == "vit_b_32":
            vit_pair = (fm, fmq)
        del fm, fmq, batches, a, b
        torch.cuda.empty_cache()
    return out, vit_pair


def _int8_bounds_ms(ops: float, int8_bytes: float, bf16_bytes: float) -> dict:
    """The least time of the int8 and the bf16 version: operations over the dtype's peak against bytes over
    HBM's rate (``utils/flops.py``), the larger."""
    from semanticlens_tpu_torch.utils.flops import H100_SXM

    hbm = H100_SXM["hbm_bytes_per_s"]
    return {"int8": max(ops / H100_SXM["int8"], int8_bytes / hbm) * 1e3,
            "bf16": max(ops / H100_SXM["bf16"], bf16_bytes / hbm) * 1e3}


def int8_splits(dev) -> dict:
    """Where an int8 product's time goes, bf16 activations, ms by CUDA events over ``timed_iters`` launches
    (``time_ms``). ViT-B/32's linears at batch 256 (12,800 rows): the row quantize, ``_int_mm``, the epilogue
    (int32 → float32, both scales, cast), the whole ``int8_matmul`` and the bf16 ``F.linear``. ResNet-50 convs
    at batch 256 (``INT8["split_convs"]``): the per-sample quantize, the im2col copy, ``_int_mm``, the
    epilogue, the whole ``int8_conv`` and cuDNN's bf16 convolution. Each beside its int8 and bf16 bounds."""
    from semanticlens_tpu_torch.ops import quant as tq

    iters, batch = INT8["timed_iters"], INT8["batch"]
    m = batch * INT8["tokens"]
    rows = {}
    for k, n in INT8["dense"]:
        x = torch.randn(m, k, device=dev, dtype=torch.bfloat16)
        w = torch.randn(n, k, device=dev) * k**-0.5
        qt, wb = tq.quantize_weight(w), w.to(torch.bfloat16)
        x_q, x_scale = tq.quantize_rows(x)
        acc = tq.int_mm(x_q, qt.q)
        ms = {"quantize": time_ms(lambda: tq.quantize_rows(x), iters),
              "int_mm": time_ms(lambda: tq.int_mm(x_q, qt.q), iters),
              "epilogue": time_ms(lambda: (acc.float() * x_scale * qt.scale).to(torch.bfloat16), iters),
              "int8_matmul": time_ms(lambda: tq.int8_matmul(x, qt), iters),
              "bf16_linear": time_ms(lambda: torch.nn.functional.linear(x, wb), iters)}
        bounds = _int8_bounds_ms(2.0 * m * k * n, 2 * m * k + n * k + 4 * n + 2 * m * n,
                                 2 * m * k + 2 * n * k + 2 * m * n)
        rows[f"linear {m}x{k}->{n}"] = {"ms": ms, "bound_ms": bounds,
                                        "int_mm_share_of_int8_bound": bounds["int8"] / ms["int_mm"],
                                        "int8_over_bf16": ms["int8_matmul"] / ms["bf16_linear"]}
        del x, w, qt, wb, x_q, x_scale, acc
    for cin, cout, k, stride, side in INT8["split_convs"]:
        x = torch.randn(batch, cin, side, side, device=dev, dtype=torch.bfloat16).abs()
        x = x.contiguous(memory_format=torch.channels_last)
        w = torch.randn(cout, cin, k, k, device=dev) * (cin * k * k) ** -0.5
        qt = tq.quantize_weight(w)
        wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        pad = k // 2
        x_q, x_scale = tq.quantize_samples(x)
        cols = tq.im2col(x_q, k, k, stride=stride, padding=pad)
        ho = cols.shape[1]
        cols2d = cols.reshape(batch * ho * ho, cin * k * k)
        acc = tq.int_mm(cols2d, qt.q.reshape(cout, -1)).view(batch, ho, ho, cout)
        ms = {"quantize": time_ms(lambda: tq.quantize_samples(x), iters),
              "im2col": time_ms(lambda: cols.reshape(batch * ho * ho, cin * k * k), iters),
              "int_mm": time_ms(lambda: tq.int_mm(cols2d, qt.q.reshape(cout, -1)), iters),
              "epilogue": time_ms(lambda: (acc.float() * x_scale.view(-1, 1, 1, 1) * qt.scale).to(torch.bfloat16),
                                    iters),
              "int8_conv": time_ms(lambda: tq.int8_conv(x, qt, stride=stride, padding=pad), iters),
              "bf16_conv": time_ms(lambda: torch.nn.functional.conv2d(x, wb, stride=stride, padding=pad), iters)}
        out_elems = batch * ho * ho * cout
        bounds = _int8_bounds_ms(2.0 * out_elems * cin * k * k, 2 * x.numel() + qt.q.numel() + 4 * cout + 2 * out_elems,
                                 2 * x.numel() + 2 * w.numel() + 2 * out_elems)
        rows[f"conv {batch}x{cin}x{side}² {k}x{k}/{stride} ->{cout}"] = {
            "ms": ms, "bound_ms": bounds, "int_mm_share_of_int8_bound": bounds["int8"] / ms["int_mm"],
            "int8_over_bf16": ms["int8_conv"] / ms["bf16_conv"]}
        del x, w, qt, wb, x_q, x_scale, cols, cols2d, acc
    torch.cuda.empty_cache()
    return rows


def int8_lrp_gate(dev, images) -> dict:
    """Heatmaps through the int8 ResNet-50 (float32, TF32 off) against the float ResNet-50 whose stage convs
    are its dequantized int8 weights, on 4 images and 2 layer3 components, within ``[lrp]``'s float32 bounds;
    a composite dequantizes, so the two must agree."""
    from semanticlens_tpu_torch.collect.relevance_based import _Preprocessed
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.ops.quant import QuantizedTensor, dequantize
    from semanticlens_tpu_torch.relevance import make_attribution_fn

    x = images[: INT8["lrp_images"], :224, :224]
    mq = ResNet(depth=50, dtype=torch.float32, device=dev, quantize="int8")
    pq = mq.init(seed=0)
    mf = ResNet(depth=50, dtype=torch.float32, device=dev)
    pf = {k: dequantize(v).contiguous(memory_format=torch.channels_last) if isinstance(v, QuantizedTensor) else v
          for k, v in pq.items()}
    gaps = {}
    for composite in ("epsilon_plus_flat", "epsilon"):
        for comp in (0, 1):
            hq, hf = (make_attribution_fn(_Preprocessed(m, imagenet_preprocess), LRP["layer"], composite=composite)(
                p, x, comp).cpu() for m, p in ((mq, pq), (mf, pf)))
            gap = float((hq - hf).abs().max())
            gaps[f"{composite}[{comp}]"] = gap
            if not (gap <= LRP_HEAT_ATOL[composite] and torch.isfinite(hq).all() and hq.abs().max() > 0):
                raise AssertionError(f"[int8] LRP {composite} component {comp}: int8 vs dequantized {gap:.3g} > "
                                     f"{LRP_HEAT_ATOL[composite]}")
    del mq, pq, mf, pf
    torch.cuda.empty_cache()
    return {"heatmap_gap_int8_vs_dequantized": gaps, "bound": {c: LRP_HEAT_ATOL[c] for c in ("epsilon_plus_flat",
                                                                                              "epsilon")}}


def _fidelity(states_f, states_q) -> dict:
    """Per layer: the mean share of each component's top-k ids that int8 keeps, and the values' cosine."""
    out = {}
    for layer in states_f:
        ids_f, ids_q = states_f[layer].ids.cpu().numpy(), states_q[layer].ids.cpu().numpy()
        overlap = np.mean([len(set(a) & set(b)) / len(a) for a, b in zip(ids_f, ids_q)])
        vf = states_f[layer].values.float().cpu().numpy().ravel()
        vq = states_q[layer].values.float().cpu().numpy().ravel()
        out[layer] = {"topk_id_overlap": float(overlap),
                      "value_cosine": float((vf * vq).sum() / (np.linalg.norm(vf) * np.linalg.norm(vq)))}
    return out


def int8_collect(dev, images, vit_pair, root: Path) -> tuple[dict, dict]:
    """ResNet-50 bf16 and int8 on the quickstart's layers over the pool: pooled taps per image, the collect
    and the fused pass (embed tower bf16 / int8, subject bf16 / int8) in turns, top-k fidelity; then the
    concept DB of the int8 fused pass and Analyze on it (redundancy, probing, ``topk_cosine_search``) with
    K1 counted from 0. Returns the readings and K1's launches."""
    from semanticlens_tpu_torch import Lens, scores
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.ops import cosine as k1
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    fm, fmq = vit_pair
    batch, layers = INT8["batch"], INT8["layers"]
    dataset = ArrayDataset(images, name="synthetic-uint8")
    cvs = {}
    for tag, q in (("bf16", None), ("int8", "int8")):
        model = ResNet(depth=50, dtype=torch.bfloat16, device=dev, quantize=q)
        model.params = model.init(seed=0)
        model.name = f"resnet50-{tag}"
        cvs[tag] = ActivationComponentVisualizer(model=model, dataset_model=dataset, dataset_fm=dataset,
                                                 layer_names=layers, num_samples=INT8["num_samples"],
                                                 aggregate_fn=aggregate_conv_mean,
                                                 model_preprocess=make_preprocess_fn(size=224),
                                                 cache_dir=root / tag)
    pre = make_preprocess_fn(size=224)
    x = pre(torch.from_numpy(images[:batch]).to(dev))
    with torch.inference_mode():
        taps = {tag: cv.model.apply(cv.params, x, layers)[1] for tag, cv in cvs.items()}
    pooled = {layer: _per_image_cosine(taps["bf16"][layer].mean(dim=(1, 2)), taps["int8"][layer].mean(dim=(1, 2)))
              for layer in layers}
    del taps, x

    def embed_with(tower):
        return lambda raw: tower.encode_image(tower.preprocess(raw))

    def rate(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, len(images) / (time.perf_counter() - t0)

    states, rates = {}, {}  # each rate twice, in turns: the first of each also warms
    for tag in ("bf16", "int8", "bf16", "int8"):
        (states[tag], _), r = rate(lambda: cvs[tag].engine.run(cvs[tag].params, dataset, batch))
        rates.setdefault(f"collect_{tag}", []).append(r)
    fused = {"subject_bf16_embed_bf16": ("bf16", fm), "subject_bf16_embed_int8": ("bf16", fmq),
             "subject_int8_embed_int8": ("int8", fmq)}
    for key, (tag, tower) in [*fused.items(), *fused.items()]:
        _, r = rate(lambda: cvs[tag].engine.run_fused(cvs[tag].params, dataset, batch, embed_with(tower)))
        rates.setdefault(f"fused_{key}", []).append(r)
    fidelity = _fidelity(states["bf16"], states["int8"])

    lens = Lens(fmq)
    concept_db = lens.compute_concept_db(cvs["int8"], batch_size=batch)
    agg = {k: v.mean(1) for k, v in concept_db.items()}
    k1.reset_launch_counts()
    redundancy = lens.eval_redundancy(agg)
    hits = lens.text_probing(PROBE_WORDS, agg, templates=TEMPLATES)
    components = torch.from_numpy(np.concatenate([agg[layer] for layer in layers])).to(dev)
    queries = fmq.encode_text(fmq.tokenize([TEMPLATES[0].format(w) for w in PROBE_WORDS]))
    values, idx = scores.topk_cosine_search(queries, components, 5)
    torch.cuda.synchronize()
    launches = k1.launch_counts()
    for layer, c in (("layer3", 1024), ("layer4", 2048)):
        if concept_db[layer].shape != (c, INT8["num_samples"], 512) or not np.isfinite(concept_db[layer]).all():
            raise AssertionError(f"[int8] concept DB {layer}: {tuple(concept_db[layer].shape)} or not finite")
        if hits[layer].shape != (len(PROBE_WORDS), c) or not np.isfinite(hits[layer]).all():
            raise AssertionError(f"[int8] probe scores of {layer}")
    if not (torch.isfinite(values).all() and int(idx.min()) >= 0 and int(idx.max()) < components.shape[0]):
        raise AssertionError("[int8] topk_cosine_search on the int8 concept DB")
    return {"pooled_tap_cosine_min": {k: float(v.min()) for k, v in pooled.items()},
            "images_per_s": rates, "fidelity": fidelity,
            "redundancy": {k: float(v) for k, v in redundancy.items()}, "k1_launches": launches}, launches


def phase_int8(dev, root: Path) -> dict:
    """[int8]: the card-against-CPU integer gates, the three towers and ResNet-50 int8 against their float
    selves, LRP through the int8 ResNet-50, collect and fused passes, Analyze on the int8 concept DB, and the
    split of int8 linears and convs into their passes. Logs every reading before it raises on a miss."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    images = _make_images(INT8["images"], seed=0)  # the quickstart's pool
    summary = {"gates": int8_card_vs_cpu(dev)}
    summary["towers"], vit_pair = int8_towers(dev, images)
    summary["splits"] = int8_splits(dev)
    summary["lrp"] = int8_lrp_gate(dev, images)
    summary["collect"], launches = int8_collect(dev, images, vit_pair, root)
    del vit_pair
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    summary |= {"gate": INT8_GATE, "phase_s": phase_s, "bound_s": INT8["bound_s"],
                "within_bound": phase_s <= INT8["bound_s"]}
    log(f"[int8] {json.dumps(summary)}")
    missed = [f"{name} cosine {t['cosine_min']:.5f}" for name, t in summary["towers"].items()
              if not t["cosine_min"] >= INT8_GATE["tower_cosine"]]
    missed += [f"pooled {layer} cosine {c:.5f}" for layer, c in summary["collect"]["pooled_tap_cosine_min"].items()
               if not c >= INT8_GATE["pooled_tap_cosine"]]
    if launches["streaming"] < 1 or launches["tiled"] < 1:
        missed.append(f"K1 launches on the int8 concept DB: {launches}")
    if missed:
        raise AssertionError(f"[int8] misses: {missed}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_start = time.perf_counter()
    marks = [t_start]
    phase_s = {}

    def done(phase: str):  # wall seconds of each phase, printed as [phases]
        marks.append(time.perf_counter())
        phase_s[phase] = round(marks[-1] - marks[-2], 2)

    phase_build()
    phase_env()
    done("build_env")
    rows, max_err, checked = phase_kernels(dev)
    done("kernels")
    phase_k1b(dev)
    done("k1b")
    moe_rows = phase_moe(dev)
    done("moe")
    kda_rows = phase_kda(dev)
    done("kda")
    phase_reference(dev)
    done("reference")
    shapes = set()
    with recording_k1_shapes(shapes):
        launches, res = phase_quickstart(dev)
        done("quickstart")
        by_path = {"quickstart": launches, "analyze": phase_analyze(dev, res)}
        done("analyze")
        by_path["serve"] = phase_serve(dev, res)
        done("serve")
        del res
        by_path["resume"] = phase_resume(dev)
        done("resume")
        by_path["folder"] = phase_folder(dev)
        done("folder")
        by_path["formats"] = phase_formats(dev)
        done("formats")
        by_path["webp"] = phase_webp(dev)
        done("webp")
        by_path["lrp"] = phase_lrp(dev)
        done("lrp")
        with tempfile.TemporaryDirectory() as tmp:
            by_path["siglip"], ctx = phase_siglip(dev, Path(tmp))
            by_path["mobileclip"], vitb32 = phase_mobileclip(dev, ctx)
            del ctx
            by_path["dissect"] = phase_dissect(dev, vitb32)
            del vitb32
        done("siglip_mobileclip_dissect")
        with tempfile.TemporaryDirectory() as tmp:
            by_path["sae"] = phase_sae(dev, Path(tmp))
        done("sae")
        for name, phase in (("audit", phase_audit), ("causal", phase_causal), ("featviz", phase_featviz),
                            ("lm", phase_lm), ("zoo", functools.partial(phase_zoo, cfg=ZOO)),
                            ("zoo2", functools.partial(phase_zoo, cfg=ZOO2)), ("mesh", phase_mesh),
                            ("int8", phase_int8)):
            with tempfile.TemporaryDirectory() as tmp:
                by_path[name] = phase(dev, Path(tmp))
            done(name)
    log(f"[phases] wall seconds: {json.dumps(phase_s)}")
    log(f"[launches] K1 per path: {json.dumps(by_path)}")
    phase_main_path_shapes(dev, shapes, checked, max_err)

    def entry(variant, shape):
        row = next(r for r in rows if r["shape"] == shape)
        if row["variant"] != variant:
            raise AssertionError(f"K1 {shape} ran the {row['variant']} kernel, not {variant}")
        return {
            "name": f"cosine_similarity_matrix[{variant}]",
            "route": "cuda",
            "source": "semanticlens_tpu_torch/csrc/cosine.cu",
            "replaces": "semanticlens_tpu/ops/pallas_ops.py:72",
            "launches": launches[variant],
            "launches_k1_total": launches["total"],
            "launches_by_path": {path: counts[variant] for path, counts in by_path.items()},
            "max_abs_err": max_err[variant],
            **{key: row[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",  # ms: host loop of 20 calls
                "device_ms", "plain_device_ms", "library_device_ms",  # CUDA-graph replay, inputs warm in L2
                "device_ms_cold_l2", "library_device_ms_cold_l2", "share_of_bound_cold_l2", "bounds_ms")},
            "shape": shape,
        }

    def at_shape(shape):
        row = next(r for r in rows if r["shape"] == shape)
        return {key: row[key] for key in ("ms", "plain_ms", "plain_device_ms", "library_ms", "device_ms", "device_ms_cold_l2",
                                          "library_device_ms", "library_device_ms_cold_l2", "bound_ms",
                                          "bound_by", "share_of_bound_cold_l2")} | {"shape": shape} | (
            {"tile": row["tile"]} if "tile" in row else {})

    kernels = {"kernels": [
        entry("tiled", "redundancy 2048x2048x512") | {"at_layer1": at_shape("redundancy 256x256x512"),
                                                      "at_layer2": at_shape("redundancy 512x512x512"),
                                                      "at_d1024": at_shape("redundancy 2048x2048x1024"),
                                                      "at_d768": at_shape("redundancy 3072x3072x768"),
                                                      "at_sae": at_shape("redundancy 8192x8192x512"),
                                                      "at_gpt2": at_shape("redundancy 3072x3072x512"),
                                                      "at_convnext": at_shape("redundancy 768x768x512"),
                                                      "at_zoo_heads": at_shape("redundancy 1280x1280x512"),
                                                      "at_zoo2_1024": at_shape("redundancy 1024x1024x512"),
                                                      "at_zoo2_832": at_shape("redundancy 832x832x512")},
        entry("streaming", "probe 8x2048x512") | {"at_d1024": at_shape("probe 8x2048x1024"),
                                                  "at_d768": at_shape("probe 8x3072x768"),
                                                  "at_sae": at_shape("probe 8x8192x512")},
        moe_kernel_entry(moe_rows), kda_kernel_entry(kda_rows)]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
