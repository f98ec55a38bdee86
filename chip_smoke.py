#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc``, holds each of the seven round-step
kernels against its plain PyTorch version on the card (at the main path's
shapes, and at a small odd shape in several dtypes and in both ops, or
at qblock 8 for the quantized step), then drives the
port's paths through their entry points at p = 1152 ranks (the paper's
36 x 32 cluster):

  * broadcast: a 16 MiB float32 payload from root 100, n = 58 blocks in
    68 rounds on a [1152, 59, 72316] float32 buffer; every rank must hold
    the payload, the "cuda" backend must equal the "torch" one, and the
    overlapped round loop must equal the sequential one;
  * reduce (sum and max) and allreduce: 16 MiB float32 contributions per
    rank made on the card, n = 58, 68 rounds, root 100, on a
    [1152, 60, 72316] buffer; the root must hold the exact sum of
    integer-valued contributions (and their max) with every other rank
    drained, "cuda" must equal "torch" on standard-normal contributions,
    the overlapped loop must equal the sequential one, and allreduce
    must leave the sum on every rank;
  * allgather: 8 KiB float32 per rank, n = 43, 53 rounds, on
    [1152 * 1152, 44, 48] rank-major rows; every rank must hold every
    rank's blocks, "cuda" must equal "torch", overlapped must equal
    sequential; the four copy kernels are also held bit for bit against
    their plain versions and timed alone at these 192-byte rows (their
    short-row grid), and again at 1 KiB rows (64 units of 16 bytes, the
    row x chunk grid) over a buffer of the same size;
  * quantized_allreduce: the trainer's 4 MiB gradient bucket per rank
    (the q/k/v projection weights and biases of one Qwen2-0.5B layer,
    1,033,344 float32, bucketed by ``make_bucket_spec``/``bucketize``),
    int8 blocks and float32 scales on the wire, n = 14 blocks of 73,984
    (289 quantization blocks of 256), 24 reduce and 24 broadcast rounds,
    root 100, two steps with error feedback (the second step's input is
    its gradients plus the first step's error); every rank's row must be
    identical, "cuda" must equal "torch" bit for bit, and sums plus
    errors must give back the exact sum;
  * the two-level host plans of the same 1152 ranks as 36 nodes x 32
    cores (``hier_host_plan``, block counts from the port's
    ``_resolve_hier_blocks``, the levels' ``optimal_hier_blocks`` capped):
    hier_broadcast of the broadcast's 16 MiB from root 100, n = (41, 37);
    hier_reduce (sum and max of the reduce's contributions, 19.3 GB, and
    a sum of int32 contributions that wraps) and hier_allreduce to and
    from root 100, n = (41, 37); hier_allgather of the allgather's 8 KiB a
    rank, n = (30, 5).  Every rank must hold the exact result, "cuda"
    must equal "torch" bit for bit, each path must launch its kernels
    as often as its levels' rounds say, and the port's
    ``simulate_hier_*(backend="cuda")`` must certify the plans at 36 x 32.
    Each line gives the flat path's time of this run beside its own;
  * the two-level communicator, ``get_hier_comm(StackedGrid(36, 32))``,
    whose levels each run once over all 1152 rows (the exchange a roll
    of ``view(36, 32, ...)`` along dim 0 or 1): hiercomm_broadcast,
    hiercomm_reduce (f32 sum, f32 max, an int32 sum that wraps),
    hiercomm_allreduce and hiercomm_allgather at the hier_* payloads,
    block counts from the port's ``_resolve_hier_blocks``.  Each is exact
    at full size, launches its kernels once a round of each level (the
    reduce 89 acc_shuffles, the allgather 2 packs, 42 shuffles and 2
    unpacks), and equals ``hier_host_plan`` and the "torch" backend bit
    for bit at 1 MiB a rank (the allgather at its full size, every
    rank's copy too); each line gives its time, host call, bytes-bound
    and peak beside the host plan's time of this run;
  * the plan/execute communicator, ``get_comm(StackedGroup(1152))`` with
    pytree payloads: comm_broadcast of {"w": 12 MiB f32, "b": 4 MiB int32}
    a rank from root 100 (n = 58, 68 rounds), with ``broadcast_state`` of
    one Qwen2-0.5B layer's bf16 q/k/v weights, their f32 biases and an
    int32 step counter (three messages a round); comm_reduce of the same
    pytree (an f32 sum of normal values and a wrapping int32 sum, then
    max) and comm_allreduce (2 x 68 rounds); comm_allgather of 8 KiB f32
    a rank (n = 43, 53 rounds); comm_reduce_scatter of [1152, 1152 x 2048]
    f32 integer values (block_acc_shuffle and block_acc_shuffle_staged are
    also held bit for bit against their plain versions and timed alone at
    its 192-byte rows, their short-row grid); comm_allgatherv of int32
    rows of capacity 2048 with seeded sizes in [64, 2048].  Each is held
    exactly against the expected values, per leaf bit for bit against the
    port's host_plan where one exists, "cuda" against "torch" (at 1 MiB a
    rank for the 16 MiB payloads), overlapped against sequential, and by
    its launches, and prints its time beside the flat host plan's;
  * each overlapped path above (the host plans' broadcast_overlap,
    reduce_overlap and allgather_overlap lines, and the communicator's
    broadcast, reduce, allgather and reduce_scatter) is also run once,
    warm, under ``torch.profiler``: its exchange (the rolls) must run on
    a CUDA stream other than its pre-pack's, and its line gives the
    stream ids, the share of rounds whose pre-pack meets that round's
    rolls in time, and its time beside the sequential one's;
  * comm_quantized_allreduce: the communicator's int8-wire allreduce of
    the same 4 MiB bucket at p = 1152, root 100, as a one-leaf payload
    (its sums and errors equal to the host plan's bit for bit) and as the
    6-leaf q/k/v pytree, two error-feedback steps each: every rank's sums
    identical, "cuda" equal to "torch", sums plus errors the exact sum,
    and the launches of its rounds (a leaf: R + 1 qacc_shuffles, 2 packs,
    2(R - 1) shuffles, 2 unpacks), timed beside the host plan.

Then the training path of Qwen2-0.5B at its published width (24 layers,
d_model 896, vocab 151,936, 494,032,768 parameters in bf16, random
weights from the seed) over ``StackedGroup(4)``:

  * compressed_grad_sync of its full gradient in the reference's layout
    (14 leaves in 10 buckets of 4 MiB, n = 99), two error-feedback steps,
    with the same checks and launches;
  * train: ``make_train_step`` with ``grad_sync="compressed"``, 2
    microbatches and ``remat="full"`` takes 3 steps of ``SyntheticLM``
    batches (global batch 8 of 1024 tokens); the same steps with
    ``grad_sync="auto"`` start from the same weights, and one step with
    ``stream_grad_sync=True``.  Every loss finite, the compressed ones
    within 0.05 x max(1, loss_0) of the auto ones (the reference's
    ``mp_worker.check_gradsync`` bound), the streamed step within it of
    the post-backward one (its loss, and the loss on the next batch after
    it); per step its time, tokens/s, loss, grad_norm, the sync's share
    and the peak memory.  The streamed step runs once more from the
    same state, bit-equal to the first and with its loss, under
    ``torch.cuda.set_sync_debug_mode("warn")``, where no module of the
    sync may make the host wait, and under ``torch.profiler``, where
    every round-step kernel (the bucket syncs) must run on one stream
    other than the backward's and some of them must meet backward
    kernels in time (``streamed_repeat`` gives the share).  Training
    runs attention through its plain version, as the reference trains
    through jnp: an auto step launches no kernel.
  * train_launch: the same configuration through the training
    launcher's entry point, ``repro_torch.launch.train.main`` with the
    reference's flags (``--mesh 4x1 --grad-sync compressed --global-batch
    8 --seq 1024 --microbatches 2``) and a temporary checkpoint
    directory: run 1 trains 4 steps and saves at step 4 (13.8 GB: bf16
    stored as f32, the [4, bucket] error buckets), run 2 (``--steps 6``)
    must print "resumed from step 4" and "done: 2 steps", a third call
    restores the checkpoint into a template on the card that must equal
    run 1's final state bit for bit, and run 2's step-5 and step-6 losses
    must lie within 1e-3 x max(1, loss_0) of an uninterrupted 6-step
    run's (and whether they are bit-equal is reported); each run's
    round-step launches must be its steps times a compressed step's over
    its dp ranks, which at 4x1 is the train phase's step; ms a step, tokens/s, the checkpoint's bytes written
    and read, the host copy's, the write's and the restores' seconds, and
    the peaks.  With under twice the checkpoint's bytes free under the
    temporary directory it runs at ``--mesh 2x1`` (one round fewer a
    sync, so its own launch counts) and says so;
  * analysis (after the collectives and the compressed sync, before
    their cached plans are dropped): ``python -m repro_torch.analysis``'s
    four passes in this process on the card (plans with their device
    tables on the card, the kernel records' replay and their launch grids
    against the compiled launcher, lint, the cache), each with 0
    findings and ``checked > 0``; ``audit_plan`` on every plan object the
    run above executed and left in the plan cache (the p = 1152 host
    plans, sequential and overlapped, the communicator's plans over
    ``StackedGroup(1152)``, the 36 x 32 ``HierComm`` and host plans, the
    quantized allreduce, the compressed sync's), its ``device-table``
    check reading back every device slot table they index and
    ``audit_cache`` every cached tensor's version; the write-set probe of
    the seven round-step kernels (every operand filled with sentinels,
    each kernel launched at every grid shape it has, at 16-byte and
    narrower units, over every launch of the schedules of p = 2, 3, 5, 8
    and n = 1, 4: the elements that changed must be its record's write
    set, with the plain version's bits, and its launch grid the one
    ``block_pack_launch_shape`` reports); and the negative control, each
    record with one write dropped, which the comparison of what the
    kernel changed must report (the plain version's comparison, which
    would catch it first, is skipped for it).  Its launches count on no
    path: every path's counts are set to 0 just before it runs;
  * train_encdec: whisper-small at full width trains 2 auto steps and 2
    compressed steps over ``StackedGroup(4)`` on 8 utterances of 1500
    frames (seeded f32 normal stub-frontend embeddings) and 8 x 448
    decoder tokens from ``SyntheticLM``, AdamW at lr 1e-3 with one warm-up
    step: losses finite, compressed within 1e-3 x max(1, loss_0) of auto,
    every leaf under ``enc`` and every cross-attention leaf moved by the
    first step; ms a step, the sync's ms, tokens/s and the peak;
  * train_vlm: llama-3.2-vision-11b at full width cut to one 5-layer
    super-block (4 self-attention layers, 1 gated cross-attention layer,
    gate 0.5; 40 layers with AdamW state would not fit), 2 auto steps on
    2 prompts of 4096 tokens over 2 x 1601 image embeddings (halved, and
    said, past a 75 GB peak): losses finite, ``img_proj``, the
    cross-attention projections and the gate moved by the first step; ms
    a step, tokens/s and the peak.

Then the serving path of zamba2-2.7b at its full published configuration
(54 Mamba2 layers and one shared attention block applied after every 6,
d_model 2560, 2.42 B parameters in bf16, random weights from a seeded
``torch.Generator``):

  * model_kernels: flash attention held against its plain version at
    zamba2's prefill (B 2, S 4096, 32 heads of 80, causal) and
    h2o-danube-1.8b's sliding window at B 1 (32 / 8 heads of 80, window
    4096, S 8192), each in bf16 (timed) and in f32, and a small odd shape in f32 and bf16, causal and not,
    each case with its tolerance and max |plain|; the SSD scan at zamba2's shape
    (80 heads of 64, N 64, chunk 256), mamba2-780m's (48 heads, N 128)
    and a small odd shape with two groups and a ragged last chunk, each
    also phase by phase (chunk states, state pass, chunk outputs, each
    CUDA phase fed the plain phases' inputs), the phases timed at the
    two model shapes;
  * prefill: ``make_prefill_step`` on 2 prompts of 4096 tokens must launch
    exactly 9 flash attentions and 54 SSD scans, and its last-position
    logits must equal the "torch" backend's within the stated tolerance;
  * serve: ``ServeLoop`` (4 slots, max_seq 128) must answer 8 requests of
    16-64 prompt tokens with 16 greedy tokens each;
  * prefill_f32: the same prefill with the model in f32, where "cuda"
    must equal "torch" within 1e-3 of the logits' scale.

Then the dense and ssm configurations at their full published widths,
one after the other, each freed before the next (random bf16 weights
from the seed): qwen2-0.5b (24 layers, 14 / 2 heads of 64, tied
embeddings, vocab 151,936), granite-3-2b (40 layers, 32 / 8 heads of
64, vocab 49,155), h2o-danube-1.8b (24 layers, 32 / 8 heads of 80, a
4096-wide sliding window), mamba2-780m (48 Mamba2 layers, 48 heads of
64, state 128, no attention) and stablelm-12b (40 layers, 32 / 8 heads
of 160, 12.1 B parameters):

  * model_kernels (the same line) also holds flash attention against its
    plain version at their prefill shapes, timed in bf16 beside SDPA and
    the bound and checked again in f32: qwen2-0.5b's GQA [2, 4096, 14 / 2,
    64], granite-3-2b's [2, 4096, 32 / 8, 64], h2o-danube-1.8b's window at [2, 8192, 32 / 8, 80] (SDPA given
    the window as a boolean mask, with the backend it picks) and
    stablelm-12b's [2, 4096, 32 / 8, 160], in bf16 on the tensor-core
    instance sized to heads of 160 (with its registers and spills) and
    in f32 on the CUDA-core kernel, both timed;
  * prefill_zoo: 2 prompts of 4096 tokens (h2o-danube-1.8b 8192, where
    its window leaves keys out; its logits must move without the window)
    must launch exactly 24, 40, 24, 0 and 40 flash attentions (and
    mamba2-780m 48 SSD scans, nothing else), and give last-position
    logits within ZOO_PREFILL_RTOL of the "torch" backend's scale; its
    greedy tokens, time, tokens/s, the kernel's share, peak, parameters
    and weight bytes;
  * decode_zoo: the serve loop above (4 slots, 8 requests, 16 greedy
    tokens each), which must launch no kernel;
  * prefill_zoo_f32: the same prefill in f32 within 1e-3, at full depth
    where twice the bf16 prefill's peak stays under 75 GB, else on the
    layers that fit (printed);
  * zoo: the group's seconds.

Then the two memory families at their full published widths (random
weights from the seed, every cross-attention gate set to 0.5: at the
reference's init value 0 the cross-attention drops out of the logits),
their cross-attention running the flash attention kernel:

  * model_kernels (the same line) also holds flash attention against its
    plain version at their shapes, timed in bf16 beside SDPA and the
    bound: llama-3.2-vision-11b's self-attention (B 2, S 4096, 32 / 8
    heads of 128, causal) and cross-attention (4096 queries over 1601
    image rows), whisper-small's encoder (B 8, 1500 frames, 12 heads of
    64, non-causal), decoder (448 tokens, causal) and cross-attention
    (448 over 1500), and each family's decode cross-attention (one query
    row); the non-causal ones again in f32;
  * prefill_vlm: llama-3.2-vision-11b (40 layers, a gated cross-attention
    layer every 5th, 9.79 B parameters in bf16) on 2 prompts of 4096
    tokens with 2 x 1601 image embeddings must launch 40 flash
    attentions (32 causal, 8 cross) and give last-position logits within
    the stated tolerance of the "torch" backend's; prefill_vlm_f32 runs
    one super-block (5 layers) at full width in f32 within 1e-3;
  * decode_vlm: a cache of 4 slots and 128 positions holding
    ``encode_memory`` of 4 images; prompts of 16-64 tokens fed token by
    token, then 16 greedy tokens each, 8 launches a step; each prompt's
    prefill against its decode (first token, largest logit gap: a
    finding, no gate);
  * prefill_encdec, decode_encdec, prefill_encdec_f32: whisper-small (12
    encoder and 12 decoder layers) on 8 utterances of 1500 frames and 8
    x 448 decoder tokens, 36 launches (12 encoder, 12 causal, 12 cross);
    decode over 8 slots of 512 positions, 12 launches a step; the f32
    prefill at full depth.

Then the moe family at its full published width: deepseek-moe-16b (28
layers, d_model 2048, 16 heads of 128, 64 routed experts top-6 of width
1408 and 2 shared ones, capacity factor 1.25, vocab 102,400; 16.88 B
parameters in bf16, random weights from the seed), its attention
running the flash attention kernel:

  * model_kernels (the same line) also holds flash attention against its
    plain version at its prefill shape (B 2, S 4096, 16 / 16 heads of
    128, causal), timed in bf16 beside SDPA and the bound, again in f32;
  * prefill_moe: 2 prompts of 4096 tokens (C = 960 rows an expert) must
    launch 28 flash attentions, and give last-position logits within
    MOE_PREFILL_RTOL of the "torch" backend's scale; its time, tokens/s,
    the attention's and the moe blocks' shares (the first layer's block
    timed alone on its input, by stage: routing, dispatch, experts,
    combine, shared experts), the share of dropped (token, k) slots, the
    operations bound by part and the peak above the phase's start;
  * decode_moe: a ``ServeLoop`` of 4 slots and 128 positions (C = 1 a
    step: the slots compete) answers 8 requests of 16-64 prompt tokens
    with 16 greedy tokens each, twice with the same tokens; ms a step,
    torch calls a step, the dropped share and the bytes bound; a no-drop
    variant (capacity factor E / K, so C = T) gives each prompt's
    prefill beside its decode (a finding in bf16);
  * prefill_moe_f32: 2 of the 28 layers at full width in f32 (28 would be
    67.5 GB), "cuda" within 1e-3 of "torch", and the no-drop variant's
    prefill equal to its decode: the same next token, logits within 1e-3
    of their scale.

Then deepseek-v3-671b at its full published width (d_model 7168, 128
heads of multi-head latent attention: q_lora 1536, kv_lora 512, q and k
heads of 128 nope + 64 rope, v heads of 128; 256 routed experts top-8
of width 2048 and 1 shared; vocab 129,280; multi-token prediction), cut
in depth to 2 of its 61 layers (25.22 B parameters in bf16, random from
the seed), its self-attention on the flash attention kernel's
tensor-core instance for q/k heads of 192 and v heads of 128:

  * model_kernels (the same line) also holds flash attention against its
    plain version at its prefill shape (B 2, S 4096, 128 / 128 heads,
    q/k 192, v 128, causal), timed in bf16 beside SDPA (and the backend
    SDPA picks) and the bound, with the instance's registers and spills;
    and in f32, the CUDA-core kernel, timed the same way;
  * prefill_mla, decode_mla, prefill_mla_f32: as the moe phases above,
    2 flash attention launches at the 192-wide key, last-position
    logits within MLA_PREFILL_RTOL of the "torch" backend's scale;
    decode through the absorbed MLA over the compressed cache (C = 1 a
    step); the f32 check on 1 layer (54.9 GB) and 2 x 1024 tokens;
  * loss_mtp: ``loss_fn`` with its MTP term on 1 layer at full width in
    bf16, backend "torch", 2 x 512 tokens, forward and backward: ce, aux
    and mtp finite beside ln V, every gradient finite, the MTP leaves'
    not 0; its time and peak (no optimizer: AdamW's moments would not
    fit beside 55 GB of weights and gradients).

Last, the dryrun phase (a budget of 90 s): the port's dry run
(``python -m repro_torch.launch.dryrun --mesh single``, one process a
cell, started together) of zamba2-2.7b x prefill_32k, qwen2-0.5b x
train_4k, deepseek-v3-671b x decode_32k, llama-3.2-vision-11b x
decode_32k and whisper-small x prefill_32k, each record and the
roofline table (``repro_torch.launch.roofline`` with this card's
constants) printed; the dry run's counts of the prefill and the auto
train step this run measured, at their own sizes on meta on a 1 x 1
mesh: each count's compute time (FLOPs over the bf16 peak) must not
exceed the measured time of the same call, and its argument bytes must
equal the real parameters' and the real train state's bytes on the card
(memory time and the estimated peak printed beside the measured peak,
unchecked); ALPHA, the median wall time of one round of a warm p = 2
broadcast plan over many rounds (the roofline's latency term of this
run); and the four ``examples/torch_*.py``,
a subprocess each on the card, each of which must exit 0, report the
kernel launches of ``EXAMPLE_LAUNCHES`` and end with ``OK``.

Matrix products run with TF32 off (``allow_tf32 = False`` for matmul and
cuDNN), so the plain versions' products are full f32.

Each path is run with the launch counts set to 0 just before it and read
just after, and must have gone through its kernels.  Every phase prints
one JSON line; the "wall" line gives the whole run's seconds, the build
included.  The last line is ``{"ok": true, "device": {...}}``; any
failed check ends the run with a nonzero exit before it.  Without a CUDA
device, or outside a checkout, the script exits nonzero and prints no
result.  It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import ast
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

P = 1152                      # ranks: the paper's 36 x 32 cluster
NODES, HIER_CORES = 36, 32    # its two levels, for the hierarchical plans
PAYLOAD_BYTES = 16 << 20      # 16 MiB float32 per rank (broadcast, reduce)
GATHER_BYTES = 8 << 10        # 8 KiB float32 per rank (allgather)
KIB_BS = 256                  # 1 KiB float32 rows: 64 units, the row x chunk grid
BCAST_ROOT = 100              # a nonzero root catches relabelling faults
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
ODD = (37, 6, 131)            # R, nslots, bs: a row with no 16-byte multiple
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/block_pack.cu"
SOURCES = {"flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu"}
REPLACES = {
    "block_pack": "src/repro/kernels/block_pack.py:140",
    "block_unpack": "src/repro/kernels/block_pack.py:172",
    "block_shuffle": "src/repro/kernels/block_pack.py:216",
    "block_shuffle_staged": "src/repro/kernels/block_pack.py:273",
    "block_acc_shuffle": "src/repro/kernels/block_pack.py:342",
    "block_acc_shuffle_staged": "src/repro/kernels/block_pack.py:417",
    "block_qacc_shuffle": "src/repro/kernels/block_pack.py:507",
    "flash_attention": "src/repro/kernels/flash_attention.py:91",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:70",
}
#: The path whose run gives each kernel's launch count in the kernels line.
PATH_OF = {
    "block_pack": "broadcast", "block_unpack": "broadcast",
    "block_shuffle": "broadcast", "block_shuffle_staged": "broadcast_overlap",
    "block_acc_shuffle": "reduce", "block_acc_shuffle_staged": "reduce_overlap",
    "block_qacc_shuffle": "quantized_allreduce",
    "flash_attention": "prefill", "ssd_scan": "prefill",
}
#: The allgather path whose run gives each copy kernel's launch count at
#: the allgather's short rows: block_pack runs once a round only there.
AG_PATH_OF = {"block_pack": "allgather_overlap", "block_unpack": "allgather",
              "block_shuffle": "allgather",
              "block_shuffle_staged": "allgather_overlap"}
QBLOCK = 256                  # elements per quantization block (the default)
BUCKET_BYTES = 4 << 20        # the trainer's gradient bucket (TrainConfig)
ODD_Q = (37, 6, 8, 5)         # R, nslots, qb, blocks a row: a short odd shape
#: The q/k/v projections of one Qwen2-0.5B layer (d_model 896, 14 query
#: heads and 2 kv heads of 64; src/repro/configs/qwen2_0p5b.py), as
#: [out, in] weights with biases: 1,033,344 float32, one 4 MiB bucket.
QKV_SHAPES = {
    "q_proj": {"weight": (896, 896), "bias": (896,)},
    "k_proj": {"weight": (128, 896), "bias": (128,)},
    "v_proj": {"weight": (128, 896), "bias": (128,)},
}
#: Dense peaks of an H100 SXM (NVIDIA data sheet): bf16 tensor cores, and
#: f32 outside the tensor cores (what a kernel computing in f32 can use).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TF32_FLOPS = 495e12           # dense TF32 tensor cores (the scan's 3xTF32 products)
ARCH = "zamba2-2.7b"          # the hybrid config: both model kernels on its path
PREFILL_B, PREFILL_S = 2, 4096
#: Kernel vs plain version, elementwise |got - want| <= atol + rtol |want|,
#: as (atol, rtol).  Attention in f32 at 2e-5 (tests/test_kernels.py's);
#: in bf16 both compute in f32 and round the output once, so they differ
#: by at most one bf16 step (2^-7 of |want|): the limit is two steps, plus
#: 1e-5 for f32 summation-order differences near zero.  At a causal row of
#: ~2000 random keys |want| is ~0.03, so a relative limit, not 2e-2
#: absolute, is what catches a dropped key block.  The scan: 1e-4 (f32
#: sums in another order).
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-5, 2.0 ** -6)}
SCAN_TOL = 1e-4
#: "cuda" vs "torch" prefill of the bf16 model: the two backends differ in
#: f32 summation order inside attention and the scan, each output then
#: rounded to bf16, and such differences grow over 63 residual blocks.
#: tools/prefill_spread.py measured max |logits - plain| / max |plain| at
#: 0.039-0.049 over seeds 0-7 (0.042 at seed 0, this run's) on an NVIDIA
#: H100 80GB HBM3 at 700 W; the limit is twice the largest.  The f32
#: prefill below is the tight check of the same path.
PREFILL_RTOL = 0.1
#: The same model in f32 (full-width products with TF32 off): only the
#: order of f32 sums differs, so max |logits - plain| <= 1e-3 * max |plain|.
PREFILL_RTOL_F32 = 1e-3
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_REQUESTS, SERVE_NEW = 4, 128, 8, 16
#: The memory families at full width, random weights from the seed.
#: llama-3.2-vision-11b (vlm) prefills the zamba2 prefill's 2 x 4096
#: tokens with 1601 image embeddings a prompt and decodes over 4 slots of
#: 128 positions; whisper-small (encdec) prefills 8 utterances of 1500
#: audio frames and 448 decoder tokens (its published decoder context,
#: arXiv:2212.04356) and decodes over 8 slots of 512 positions.  Decode
#: feeds prompts of 16-64 tokens token by token, then SERVE_NEW greedy
#: tokens each.  The stub frontends' embeddings are standard normal f32.
VLM_ARCH, VLM_SLOTS, VLM_MAX_SEQ = "llama-3.2-vision-11b", 4, 128
ENC_ARCH, ENC_B, ENC_S, ENC_SLOTS, ENC_MAX_SEQ = "whisper-small", 8, 448, 8, 512
#: Every xattn layer's gate.  The reference initialises it to 0, where
#: tanh(gate) * h drops the cross-attention from the logits and a wrong
#: cross-attention would pass every comparison; a trained checkpoint's
#: gates are not 0.
XATTN_GATE = 0.5
#: The vlm's f32 check runs one super-block (5 layers: 4 self-attention,
#: 1 cross-attention) at full width: 40 layers would be 39 GB of f32
#: weights.  whisper-small's f32 check runs at full depth (0.3 B).
VLM_F32_LAYERS = 5
#: deepseek-moe-16b (moe) at full width, random bf16 weights from the seed:
#: the zamba2 prefill's 2 x 4096 tokens, then the serve loop's 4 slots of
#: 128 positions and 8 requests.  Its f32 check runs 2 of the 28 layers at
#: full width: 28 layers in f32 would be 67.5 GB of weights.
MOE_ARCH, MOE_F32_LAYERS = "deepseek-moe-16b", 2
#: "cuda" vs "torch" prefill of the bf16 moe model.  As PREFILL_RTOL's
#: rounding differences, and on top of them routing: a token whose K-th
#: and (K+1)-th router logits lie closer than that difference takes
#: another expert in the other backend, and a slot it frees or takes can
#: change which later slots are dropped.
#: tools/prefill_spread.py --arch deepseek-moe-16b measured max |logits -
#: plain| / max |plain| at 0.056-0.197 over seeds 0-7 (0.111 at seed 0,
#: this run's; tokens routed otherwise 0.3-0.5 % at layer 0, 33-37 % at
#: layer 27) on an NVIDIA H100 80GB HBM3 at 700 W; the limit is twice the
#: largest.  The f32 prefill is the tight check of the same path.
MOE_PREFILL_RTOL = 0.4
#: deepseek-v3-671b (moe with multi-head latent attention and MTP) at full
#: width, random bf16 weights from the seed, cut in depth to 2 of its 61
#: layers: each keeps its 256 experts of 2048 and the shared one, so 2
#: layers are 25.22 B parameters, 50.4 GB in bf16 (3 would be 73.5 GB).
#: Its f32 check runs 1 layer (54.9 GB) on 2 x 1024 tokens.  The MTP loss
#: runs 1 layer in bf16 on 2 x 512 tokens, forward and backward: weights
#: and gradients are 55 GB, and AdamW's moments would not fit beside them.
MLA_ARCH, MLA_LAYERS, MLA_F32_LAYERS, MLA_F32_SEQ = "deepseek-v3-671b", 2, 1, 1024
MTP_LAYERS, MTP_B, MTP_S = 1, 2, 512
#: The flash attention instance MLA's bf16 prefill runs (q/k 192, v 128),
#: by its ptxas name.
MLA_INSTANCE = "flash_fwd_mma_kernelI13__nv_bfloat16Li12ELi16ELb1EE"
#: "cuda" vs "torch" prefill of the 2-layer bf16 deepseek-v3, as
#: MOE_PREFILL_RTOL.  tools/prefill_spread.py --arch deepseek-v3-671b
#: --layers 2 measured max |logits - plain| / max |plain| at 0.0074-0.140
#: over seeds 0-7 (0.0074 at seed 0, this run's; tokens routed otherwise
#: 0.7-1.1 % at layer 0, 5.3-6.0 % at layer 1) on an NVIDIA H100 80GB
#: HBM3 at 700 W; the limit is twice the largest, rounded up.
MLA_PREFILL_RTOL = 0.3
#: The dense and ssm configurations at full width, random bf16 weights from
#: the seed, in the order the prefill_zoo, decode_zoo and prefill_zoo_f32
#: phases run them: arch -> (key of its kernels-line entry, tokens a
#: prompt of its 2, the prefill's exact launches: one a layer).
#: h2o-danube-1.8b prefills 8192 tokens: at 4096 its 4096-wide window
#: covers every key and would never bite.
ZOO = {
    "qwen2-0.5b": ("qwen2_0p5b", 4096, {"flash_attention": 24}),
    "granite-3-2b": ("granite_3_2b", 4096, {"flash_attention": 40}),
    "h2o-danube-1.8b": ("h2o_danube_1p8b", 8192, {"flash_attention": 24}),
    "mamba2-780m": ("mamba2_780m", 4096, {"ssd_scan": 48}),
    "stablelm-12b": ("stablelm_12b", 4096, {"flash_attention": 40}),
}
#: "cuda" vs "torch" bf16 prefill of each, as PREFILL_RTOL: twice the
#: largest max |logits - plain| / max |plain| that tools/prefill_spread.py
#: (--arch <arch>, danube --seq 8192) measured over seeds 0-7 on an NVIDIA
#: H100 80GB HBM3 at 700 W, rounded up (the largest, then seed 0's, this
#: run's, in the comment).
ZOO_PREFILL_RTOL = {
    "qwen2-0.5b": 0.04,         # 0.0198; 0.0190
    "granite-3-2b": 0.045,      # 0.0223; 0.0195
    "h2o-danube-1.8b": 0.039,   # 0.0191; 0.0162 (2 x 8192 tokens)
    "mamba2-780m": 0.11,        # 0.0512; 0.0426
    "stablelm-12b": 0.044,      # 0.0215; 0.0194
}
#: zamba2's and the zoo's f32 prefill runs at full depth where twice the
#: bf16 prefill's peak (f32 weights and activations) stays under this many
#: bytes, else on the first layers that do.
F32_PEAK = 75e9
#: The flash attention instance stablelm-12b's bf16 prefill runs (q, k and
#: v heads of 160), by its ptxas name.
W160_INSTANCE = "flash_fwd_mma_kernelI13__nv_bfloat16Li10ELi20ELb1EE"
#: The training path: Qwen2-0.5B at full width over 4 stacked ranks, global
#: batch 8 of 1024 tokens, 3 steps.  By the shapes, the sync holds about 4
#: f32 copies of the 494 M-element gradient a rank: 4 x 494 M x 4 B x 4 =
#: 32 GB at 4 ranks, twice that at 8, beside the model.
TRAIN_ARCH, TRAIN_P, TRAIN_B, TRAIN_S, TRAIN_STEPS = "qwen2-0.5b", 4, 8, 1024, 3
#: The training launcher's mesh for the same configuration (the train
#: phase's 4 ranks as --mesh 4x1).  Its checkpoint is the state with bf16
#: stored as f32: 494 M parameters (1.98 GB), two f32 moments (3.95 GB)
#: and the [4, bucket] f32 error buckets (7.9 GB), 13.8 GB.  With under
#: twice that free under the temporary directory it runs at 2x1.
LAUNCH_MESH = "4x1"
#: The memory families' training: 2 steps each, AdamW at lr 1e-3 with one
#: warm-up step, so the first step moves every leaf with a gradient (an
#: f32 norm scale by ~1e-3, a bf16 weight of ~0.02 by ~8 of its steps).
#: whisper-small trains on ENC_B utterances of 1500 frames and ENC_S
#: decoder tokens; llama-3.2-vision-11b on PREFILL_B prompts of PREFILL_S
#: tokens over 1601 image rows, cut to one super-block: 40 layers with
#: AdamW's f32 moments would be 9.79 B x 12 bytes and more, the super-block
#: is 2.16 B parameters.  Past a peak of VLM_TRAIN_PEAK bytes the vlm's
#: tokens are halved.
MEM_TRAIN_STEPS, MEM_TRAIN_LR, VLM_TRAIN_LAYERS, VLM_TRAIN_PEAK = 2, 1e-3, 5, 75e9
#: The dry run's cells on the single-pod mesh, the examples run on the card,
#: the rounds of the p = 2 broadcast plan ALPHA is timed over, and the
#: phase's budget in seconds.
DRYRUN_CELLS = [("zamba2-2.7b", "prefill_32k"), ("qwen2-0.5b", "train_4k"),
                ("deepseek-v3-671b", "decode_32k"),
                ("llama-3.2-vision-11b", "decode_32k"), ("whisper-small", "prefill_32k")]
EXAMPLES = ["torch_quickstart.py", "torch_collective_demo.py", "torch_serve_demo.py",
            "torch_train_lm.py"]
#: The kernel launches each example must report on the card (its inputs
#: are fixed): rows 1-4's round-step kernels in the quickstart and the
#: collective demo, the flash kernel in the serve demo's prefill and
#: decode, none in the trainer (it trains on the plain path).
EXAMPLE_LAUNCHES = {
    "torch_quickstart.py": {"block_pack": 2, "block_unpack": 2, "block_shuffle": 10},
    "torch_collective_demo.py": {"block_pack": 7, "block_unpack": 7,
                                 "block_shuffle": 34, "block_acc_shuffle": 6},
    "torch_serve_demo.py": {"flash_attention": 4},
    "torch_train_lm.py": {},
}
ALPHA_BLOCKS, ALPHA_CALLS, DRYRUN_BUDGET_S = 256, 30, 90
#: What the earlier phases measured of the calls the dryrun phase counts:
#: "prefill" (model_phases) and "train_auto" (train_phases).
MEASURED: dict = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    sys.exit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def analysis_phase(torch, card) -> None:
    """The static analysis on the card (see the module docstring): the
    CLI's passes, the run's own plans, the write-set probe and its
    negative control; any finding fails the run."""
    from repro_torch.analysis import audit_cache, audit_plan
    from repro_torch.analysis import kernelaudit as ka
    from repro_torch.analysis.__main__ import PASSES
    from repro_torch.core import engine
    from repro_torch.kernels import block_pack as bp

    t_phase = time.perf_counter()
    # (b)'s plans are those the run executed: taken before (a) adds its own
    ran = [(key, v) for key, v in list(engine._plan_cache.items())
           if hasattr(v, "statics") and hasattr(v, "kind")]
    passes = {}
    for name, fn in PASSES:                                  # (a)
        t0 = time.perf_counter()
        rep = fn(torch.device("cuda"))
        torch.cuda.synchronize()
        passes[name] = {"checked": rep.checked, "findings": len(rep.findings),
                        "seconds": time.perf_counter() - t0}
        check(rep.ok and rep.checked > 0,
              f"analysis: the {name} pass on the card: {rep.summary()[:2000]}")
    t0 = time.perf_counter()                                 # (b)
    plans, tables, table_bytes, kinds = 0, 0, 0, {}
    for key, plan in ran:
        rep = audit_plan(plan)
        check(rep.ok and rep.checked > 1,
              f"analysis: audit_plan({key!r}): {rep.summary()[:2000]}")
        plans += 1
        flats = [plan] if hasattr(plan, "device_tables") else []
        for level in (getattr(plan, "inter", None), getattr(plan, "intra", None)):
            flats += [f for f in (level if isinstance(level, tuple) else (level,))
                      if f is not None and hasattr(f, "device_tables")]
        for flat in flats:
            tables += len(flat.device_tables)
            table_bytes += sum(t.tensor.numel() * 4 for t in flat.device_tables)
        label = f"{type(plan).__name__}:{plan.kind}"
        kinds[label] = kinds.get(label, 0) + 1
    cache = audit_cache()
    torch.cuda.synchronize()
    check(cache.ok and cache.checked > 0,
          f"analysis: audit_cache: {cache.summary()[:2000]}")
    own = {"plans": plans, "by_class_and_kind": kinds, "device_tables": tables,
           "device_table_bytes": table_bytes,
           "max_p": max((getattr(pl, "p", 0) for _, pl in ran), default=0),
           "cache_checked": cache.checked,
           "seconds": time.perf_counter() - t0}
    check(plans > 0 and tables > 0, "analysis: the run left no plan to audit")
    t0 = time.perf_counter()                                 # (c)
    probe = ka.probe_kernels("cuda")
    torch.cuda.synchronize()
    check(probe.ok and probe.checked > 0,
          f"analysis: the write-set probe: {probe.summary()[:3000]}")
    shapes = {}
    for name, geoms in ka.GEOMETRIES.items():
        for g in geoms:
            sh = bp.launch_shape(name, **g.shape_args(8))
            shapes.setdefault(name, []).append(
                {"bs": g.bs, "qb": g.qb, "route": ["row x chunk", "short rows",
                                                   "warp per block"][sh.route],
                 "unit": sh.unit, "grid_y": sh.grid_y, "steps": sh.steps})
    probe_s = time.perf_counter() - t0
    t0 = time.perf_counter()                                 # (d)
    caught = {}
    for name, spec in bp.KERNEL_AUDITS.items():
        # the plain version's comparison is skipped, so that the dropped
        # write reaches the comparison of what the kernel changed
        bad = ka.probe_kernels("cuda", names=[name], ps=(5,), ns=(4,),
                               geometries={name: ka.GEOMETRIES[name][:1]},
                               specs={name: ka.dropped_write(spec)},
                               sides=("kernel",))
        caught[name] = sum(f.check == "write-set"
                           and f.message.startswith("the kernel ")
                           for f in bad.findings)
        check(caught[name] > 0 and caught[name] == len(bad.findings),
              f"analysis: the kernel's write set missed {name}'s record "
              f"with a dropped write: {bad.summary()[:2000]}")
    emit({"phase": "analysis", "passes": passes, "own_plans": own,
          "probe": {"launches_probed": probe.checked, "findings": 0,
                    "seconds": probe_s, "grid_shapes": shapes},
          "negative_control": {"write_set_findings": caught,
                               "seconds": time.perf_counter() - t0},
          "seconds": time.perf_counter() - t_phase, "card": card})


def cuda_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, in ms (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(torch, fn, runs: int):
    """Median and list of ``runs`` single-call device times (the first
    run warms up)."""
    times = [cuda_ms(torch, fn, 1, warm=int(i == 0)) for i in range(runs)]
    return sorted(times)[runs // 2], times


def bits(torch, t):
    """``t`` viewed as integers of its width, so NaN lanes compare by bits."""
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(width[t.element_size()])


def same_bits(torch, a, b, rows: int = 64) -> bool:
    """Bitwise equality over the leading dimension in chunks (no
    full-size temporaries on a 20 GB buffer)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return all(torch.equal(bits(torch, a[i:i + rows]), bits(torch, b[i:i + rows]))
               for i in range(0, a.shape[0], rows))


def max_abs_err(torch, a, b, rows: int = 64) -> float:
    """max |a - b| over the leading dimension in chunks; elements equal
    bit for bit count 0 (so matching infinities and NaNs do too), and so
    does a NaN against a NaN."""
    worst = 0.0
    for i in range(0, a.shape[0], rows):
        x, y = a[i:i + rows], b[i:i + rows]
        d = (x.double() - y.double()).abs()
        d[bits(torch, x) == bits(torch, y)] = 0
        if x.is_floating_point():
            d[torch.isnan(x) & torch.isnan(y)] = 0
        worst = max(worst, float(d.max()))
    return worst


def all_equal_to(torch, t, value, rows: int = 64) -> bool:
    return all(bool((t[i:i + rows] == value).all())
               for i in range(0, t.shape[0], rows))


def ms_of_bytes(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def random_operands(torch, g, R, nslots, bs, dtype):
    """Random buffer, message and slot vectors; about a quarter of the
    rows take the case of coinciding slots (send == recv, fwd == acc)."""
    dev = "cuda"
    if dtype.is_floating_point:
        buf = torch.randn((R, nslots, bs), generator=g, device=dev).to(dtype)
        msg = torch.randn((R, bs), generator=g, device=dev).to(dtype)
    else:
        buf = torch.randint(-100, 100, (R, nslots, bs), generator=g,
                            device=dev, dtype=dtype)
        msg = torch.randint(-100, 100, (R, bs), generator=g, device=dev,
                            dtype=dtype)
    recv = torch.randint(0, nslots, (R,), generator=g, device=dev,
                         dtype=torch.int32)
    send = torch.randint(0, nslots, (R,), generator=g, device=dev,
                         dtype=torch.int32)
    same = torch.rand((R,), generator=g, device=dev) < 0.25
    send = torch.where(same, recv, send).contiguous()
    return buf, msg, recv, send


def compare_kernels(torch, bp, ref, g, R, nslots, bs, dtype, timed: bool):
    """The broadcast's kernels vs their plain versions (bitwise) on the
    same inputs; at the path's shapes also their times.  Returns
    {name: record}."""
    buf, msg, recv, send = random_operands(torch, g, R, nslots, bs, dtype)
    out = {}
    k = bp.block_pack(buf, send)
    r = ref.block_pack_ref(buf, send)
    check(same_bits(torch, k, r), f"block_pack != plain at {R, nslots, bs} {dtype}")
    out["block_pack"] = {"max_abs_err": max_abs_err(torch, k, r)}
    del k, r

    snap = buf.clone()
    bp.block_unpack(buf, msg, recv)
    ref.block_unpack_ref(snap, msg, recv)
    check(same_bits(torch, buf, snap),
          f"block_unpack != plain at {R, nslots, bs} {dtype}")
    out["block_unpack"] = {"max_abs_err": max_abs_err(torch, buf, snap)}

    snap.copy_(buf)
    _, k = bp.block_shuffle(buf, msg, recv, send)
    _, r = ref.block_shuffle_ref(snap, msg, recv, send)
    check(same_bits(torch, buf, snap) and same_bits(torch, k, r),
          f"block_shuffle != plain at {R, nslots, bs} {dtype}")
    out["block_shuffle"] = {"max_abs_err": max(max_abs_err(torch, buf, snap),
                                               max_abs_err(torch, k, r))}
    del snap, k, r
    torch.cuda.synchronize()
    if not timed:
        return out

    row_bytes = bs * buf.element_size()
    # A shuffle row whose two slots coincide moves msg to buf[recv] and to
    # out and reads nothing of buf: three row transfers, not four.
    coincide = int((recv == send).sum())
    rows = torch.arange(R, device="cuda")
    gidx = send.long().view(R, 1, 1).expand(R, 1, bs)
    out["block_pack"].update(
        ms=cuda_ms(torch, lambda: bp.block_pack(buf, send), 10),
        plain_ms=cuda_ms(torch, lambda: ref.block_pack_ref(buf, send), 5),
        library_ms=cuda_ms(torch, lambda: torch.gather(buf, 1, gidx), 5),
        bound_ms=ms_of_bytes(2 * R * row_bytes))
    out["block_unpack"].update(
        ms=cuda_ms(torch, lambda: bp.block_unpack(buf, msg, recv), 10),
        plain_ms=cuda_ms(torch, lambda: ref.block_unpack_ref(buf, msg, recv), 5),
        library_ms=cuda_ms(torch, lambda: buf.index_put_((rows, recv.long()), msg), 5),
        bound_ms=ms_of_bytes(2 * R * row_bytes))
    out["block_shuffle"].update(
        ms=cuda_ms(torch, lambda: bp.block_shuffle(buf, msg, recv, send), 10),
        plain_ms=cuda_ms(torch, lambda: ref.block_shuffle_ref(buf, msg, recv, send), 5),
        library_ms=None,
        bound_ms=ms_of_bytes((4 * R - coincide) * row_bytes))
    return out


def copy_kernels_at(torch, bp, ref, g, recv_d, send_d, nslots, bs):
    """The four copy kernels alone on a [rows, nslots, bs] float32
    buffer, over the slot rows recv_d, send_d ([rounds, rows] int32, the
    plan's own or a prefix of them): each held bit for bit against its
    plain version at the rounds with the most and the fewest coincident
    slots (each kernel that writes the buffer with a message of its own,
    so a write it drops shows), then timed over every round it takes
    (kernel, plain and library time a launch).  Bounds: each input read
    once, each output written once, plus the int32 slot vectors; a
    coincident shuffle row moves three rows, not four.  Returns
    ({name: record}, {what was checked})."""
    R, rows = len(recv_d), recv_d.shape[1]
    row, idx = bs * 4, rows * 4
    work = torch.randn((rows, nslots, bs), generator=g, device="cuda")
    msgs = torch.randn((3, rows, bs), generator=g, device="cuda")
    msg = msgs[0]
    same = [int((recv_d[t] == send_d[t + 1]).sum()) for t in range(R - 1)]
    chunk = max(1, (512 << 20) // (nslots * row))   # ~0.5 GB of buffer rows
    eq = lambda a, b: same_bits(torch, a, b, rows=chunk)  # noqa: E731
    err = lambda a, b: max_abs_err(torch, a, b, rows=chunk)  # noqa: E731
    names = ("block_pack", "block_unpack", "block_shuffle", "block_shuffle_staged")
    out = {name: {"max_abs_err": 0.0} for name in names}
    # the rounds with the most and the fewest coincident slots
    checked = sorted({max(range(R - 1), key=same.__getitem__),
                      min(range(R - 1), key=same.__getitem__)})

    def held(name, t, *pairs):
        check(all(eq(a, b) for a, b in pairs),
              f"{name} != plain at the allgather's rows, round {t}")
        out[name]["max_abs_err"] = max([out[name]["max_abs_err"]]
                                       + [err(a, b) for a, b in pairs])

    for t in checked:
        recv, send = recv_d[t], send_d[t + 1]
        held("block_pack", t, (bp.block_pack(work, send), ref.block_pack_ref(work, send)))
        snap = work.clone()
        bp.block_unpack(work, msg, recv)
        held("block_unpack", t, (work, ref.block_unpack_ref(snap, msg, recv)))
        _, k = bp.block_shuffle(work, msgs[1], recv, send)
        _, r = ref.block_shuffle_ref(snap, msgs[1], recv, send)
        held("block_shuffle", t, (work, snap), (k, r))
        pre = ref.block_pack_ref(work, send)
        _, k = bp.block_shuffle_staged(work, msgs[2], pre, recv, send)
        _, r = ref.block_shuffle_staged_ref(snap, msgs[2], pre, recv, send)
        held("block_shuffle_staged", t, (work, snap), (k, r))
        del snap, k, r
    torch.cuda.synchronize()

    ar = torch.arange(rows, device="cuda")

    def per_launch(fn, n):
        return cuda_ms(torch, lambda: [fn(i) for i in range(n)], 1) / n

    pack_bytes = 2 * rows * row + idx
    shuffle_bytes = sum((4 * rows - c) * row + 2 * idx for c in same) / (R - 1)
    out["block_pack"].update(
        ms=per_launch(lambda i: bp.block_pack(work, send_d[i]), R),
        plain_ms=per_launch(lambda i: ref.block_pack_ref(work, send_d[i]), R),
        library_ms=per_launch(lambda i: torch.gather(
            work, 1, send_d[i].long().view(rows, 1, 1).expand(rows, 1, bs)), R),
        bound_ms=ms_of_bytes(pack_bytes), timed_launches=R)
    out["block_unpack"].update(
        ms=per_launch(lambda i: bp.block_unpack(work, msg, recv_d[i]), R),
        plain_ms=per_launch(lambda i: ref.block_unpack_ref(work, msg, recv_d[i]), R),
        library_ms=per_launch(lambda i: work.index_put_((ar, recv_d[i].long()), msg), R),
        bound_ms=ms_of_bytes(pack_bytes), timed_launches=R)
    out["block_shuffle"].update(
        ms=per_launch(lambda i: bp.block_shuffle(work, msg, recv_d[i], send_d[i + 1]),
                      R - 1),
        plain_ms=per_launch(lambda i: ref.block_shuffle_ref(
            work, msg, recv_d[i], send_d[i + 1]), R - 1),
        library_ms=None, bound_ms=ms_of_bytes(shuffle_bytes), timed_launches=R - 1)
    out["block_shuffle_staged"].update(
        ms=per_launch(lambda i: bp.block_shuffle_staged(
            work, msg, pre, recv_d[i], send_d[i + 1]), R - 1),
        plain_ms=per_launch(lambda i: ref.block_shuffle_staged_ref(
            work, msg, pre, recv_d[i], send_d[i + 1]), R - 1),
        library_ms=None, bound_ms=ms_of_bytes(shuffle_bytes), timed_launches=R - 1)
    return out, {"rounds_checked": checked,
                 "their_coincident_rows": [same[t] for t in checked]}


def seed_specials(torch, buf, msg):
    """NaN, +-0 and the least f32 denormal at fixed places of a float
    buffer and message (the cases where max and sum are easiest to get
    wrong)."""
    fb, fm = buf.view(-1), msg.view(-1)
    fb[0::7] = float("nan")
    fm[1::11] = float("nan")
    fb[2::5], fm[2::5] = -0.0, 0.0
    fb[3::5], fm[3::5] = 0.0, -0.0
    fb[4::13], fm[4::13] = 1e-45, 1e-45


def compare_reduce_kernels(torch, bp, ref, g, R, nslots, bs, dtype, op,
                           timed: bool, specials: bool = False):
    """The three kernels of this slice vs their plain versions (bitwise)
    on the same inputs; at the reduce path's shapes also their times.
    Returns {name: record}."""
    buf, msg, acc, fwd = random_operands(torch, g, R, nslots, bs, dtype)
    if specials:
        seed_specials(torch, buf, msg)
    where = f"at {R, nslots, bs} {dtype} {op}"
    out = {}
    snap = buf.clone()
    pre = ref.block_pack_ref(buf, fwd)
    _, k = bp.block_shuffle_staged(buf, msg, pre, acc, fwd)
    _, r = ref.block_shuffle_staged_ref(snap, msg, pre, acc, fwd)
    check(same_bits(torch, buf, snap) and same_bits(torch, k, r),
          f"block_shuffle_staged != plain {where}")
    out["block_shuffle_staged"] = {"max_abs_err": max(
        max_abs_err(torch, buf, snap), max_abs_err(torch, k, r))}

    snap.copy_(buf)
    _, k = bp.block_acc_shuffle(buf, msg, acc, fwd, op=op)
    _, r = ref.block_acc_shuffle_ref(snap, msg, acc, fwd, op)
    check(same_bits(torch, buf, snap) and same_bits(torch, k, r),
          f"block_acc_shuffle != plain {where}")
    out["block_acc_shuffle"] = {"max_abs_err": max(
        max_abs_err(torch, buf, snap), max_abs_err(torch, k, r))}

    pre = ref.block_pack_ref(buf, fwd)
    snap.copy_(buf)
    _, k = bp.block_acc_shuffle_staged(buf, msg, pre, acc, fwd, op=op)
    _, r = ref.block_acc_shuffle_staged_ref(snap, msg, pre, acc, fwd, op)
    check(same_bits(torch, buf, snap) and same_bits(torch, k, r),
          f"block_acc_shuffle_staged != plain {where}")
    out["block_acc_shuffle_staged"] = {"max_abs_err": max(
        max_abs_err(torch, buf, snap), max_abs_err(torch, k, r))}
    del snap, k, r
    torch.cuda.synchronize()
    if not timed:
        return out

    row_bytes = bs * buf.element_size()
    coincide = int((acc == fwd).sum())
    out["block_shuffle_staged"].update(
        ms=cuda_ms(torch, lambda: bp.block_shuffle_staged(buf, msg, pre, acc, fwd), 10),
        plain_ms=cuda_ms(torch, lambda: ref.block_shuffle_staged_ref(
            buf, msg, pre, acc, fwd), 5),
        library_ms=None,
        bound_ms=ms_of_bytes((4 * R - coincide) * row_bytes))
    out["block_acc_shuffle"].update(
        ms=cuda_ms(torch, lambda: bp.block_acc_shuffle(buf, msg, acc, fwd, op=op), 10),
        plain_ms=cuda_ms(torch, lambda: ref.block_acc_shuffle_ref(
            buf, msg, acc, fwd, op), 5),
        library_ms=None,
        bound_ms=ms_of_bytes((6 * R - 2 * coincide) * row_bytes))
    out["block_acc_shuffle_staged"].update(
        ms=cuda_ms(torch, lambda: bp.block_acc_shuffle_staged(
            buf, msg, pre, acc, fwd, op=op), 10),
        plain_ms=cuda_ms(torch, lambda: ref.block_acc_shuffle_staged_ref(
            buf, msg, pre, acc, fwd, op), 5),
        library_ms=None,
        bound_ms=ms_of_bytes((6 * R - 2 * coincide) * row_bytes))
    return out


def counted_run(torch, kernels, fn):
    """``fn()`` with every launch count set to 0 just before it and read
    just after -> (result, {kernel: launches > 0}).  ``kernels``: the
    wrapper modules, each with ``LAUNCHES`` and ``reset_launches``."""
    for mod in kernels:
        mod.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    return res, {k: v for mod in kernels for k, v in mod.LAUNCHES.items() if v}


#: The round-step pack kernels (not the unpack ones) and torch.roll's
#: kernel, by their names in a profiler trace.
PACK_KERNEL = re.compile(r"(?<![A-Za-z_])pack(_short)?_kernel")
ROLL_KERNEL = re.compile(r"(?<![A-Za-z_])roll")
#: Every round-step kernel of csrc/block_pack.cu.
ROUND_KERNEL = re.compile(r"(?<![A-Za-z])(un|q?acc_)?(pack|shuffle)\w*_kernel")
#: The modules of the streamed bucket sync, whose host syncs count.
SYNC_FILES = ("compression.py", "comm.py", "collectives.py", "quant_ops.py",
              "block_pack.py", "_build.py")


def traced_kernels(torch, fn) -> tuple:
    """``fn()`` under ``torch.profiler`` with CUDA activity -> (its
    result, its kernels as ``(name, stream, start_us, end_us)``, read
    from the exported trace)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, [(e["name"], e["args"]["stream"], e["ts"], e["ts"] + e["dur"])
                 for e in events if e.get("cat") == "kernel"]


def busy_union(spans) -> tuple:
    """The union of ``(start, end)`` spans, sorted and merged -> its
    ``(starts, ends)``."""
    starts, ends = [], []
    for a, b in sorted(spans):
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def overlap_us(union, a, b) -> float:
    """How much of the span ``(a, b)`` the merged ``union`` covers."""
    import bisect

    starts, ends = union
    i, got = bisect.bisect_right(ends, a), 0.0    # the first span ending after a
    while i < len(starts) and starts[i] < b:
        got += min(b, ends[i]) - max(a, starts[i])
        i += 1
    return got


def overlaps(union, a, b) -> bool:
    """Whether the span ``(a, b)`` meets the merged ``union``."""
    return overlap_us(union, a, b) > 0


def overlap_streams(torch, name, fn) -> dict:
    """One overlapped call of ``fn`` (warm: each caller has just timed
    it) under the profiler: its rolls (the exchange) must run on a stream
    other than its packs'.  Also the share of pre-packs (the packs after
    the first roll) that meet a roll, and of their time under one; a pack
    issued in round t can meet only round t's rolls."""
    _, kern = traced_kernels(torch, fn)
    rolls = [k for k in kern if ROLL_KERNEL.search(k[0])]
    packs = [k for k in kern if PACK_KERNEL.search(k[0])]
    check(rolls and packs, f"{name}: the trace shows {len(rolls)} rolls and "
                           f"{len(packs)} packs")
    roll_s, pack_s = sorted({k[1] for k in rolls}), sorted({k[1] for k in packs})
    check(not set(roll_s) & set(pack_s) and len(pack_s) == 1,
          f"{name}: the exchange ran on stream(s) {roll_s}, the pre-pack on {pack_s}")
    first = min(k[2] for k in rolls)
    pre = [k for k in packs if k[2] >= first]
    union = busy_union([k[2:] for k in rolls])
    met = [overlap_us(union, k[2], k[3]) for k in pre]
    pre_us = sum(k[3] - k[2] for k in pre)
    return {"exchange_streams": roll_s, "pack_stream": pack_s[0],
            "rolls": len(rolls), "pre_packs": len(pre),
            "rounds_overlapped_share": sum(m > 0 for m in met) / len(pre) if pre else 0.0,
            "pre_pack_time_overlapped_share": sum(met) / pre_us if pre_us else 0.0,
            "roll_us_mean": sum(k[3] - k[2] for k in rolls) / len(rolls),
            "pre_pack_us_mean": pre_us / len(pre) if pre else 0.0,
            "traced_call_ms": (max(k[3] for k in kern) - min(k[2] for k in kern)) / 1e3}


def sync_streams(kern) -> dict:
    """A streamed train step's trace: its round-step kernels (the bucket
    syncs) must run on one stream other than the backward's (the stream
    with the most kernel time), and the share of that stream's kernels
    whose time meets a backward kernel's."""
    busy = {}
    for _, stream, a, b in kern:
        busy[stream] = busy.get(stream, 0.0) + (b - a)
    main = max(busy, key=busy.get)
    rounds = [k for k in kern if ROUND_KERNEL.search(k[0])]
    side = sorted({k[1] for k in rounds})
    check(rounds and len(side) == 1 and side[0] != main,
          f"train streamed: the syncs' kernels ran on stream(s) {side}, the "
          f"backward on {main}")
    on_side = [k for k in kern if k[1] == side[0]]
    union = busy_union([k[2:] for k in kern if k[1] == main])
    hit = [k for k in on_side if overlaps(union, k[2], k[3])]
    share = len(hit) / len(on_side)
    check(share > 0, "train streamed: no sync kernel overlaps the backward")
    return {"backward_stream": main, "sync_stream": side[0],
            "round_step_kernels": len(rounds), "sync_stream_kernels": len(on_side),
            "overlapping_backward_share": share,
            "sync_stream_busy_ms": busy[side[0]] / 1e3,
            "overlapping_busy_ms": sum(b - a for _, _, a, b in hit) / 1e3,
            "backward_stream_busy_ms": busy[main] / 1e3}


def host_syncs(torch, fn) -> tuple:
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")`` -> (its
    result, the places of its synchronizing calls, as ``file:line``)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sorted({f"{os.path.basename(w.filename)}:{w.lineno}" for w in seen
                        if "synchroniz" in str(w.message)})


def same_or_nan(torch, a, b, rows: int = 64) -> bool:
    """Bitwise equality with NaN lanes compared by position (a NaN made by
    the card's arithmetic carries its own payload)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    for i in range(0, a.shape[0], rows):
        x, y = a[i:i + rows], b[i:i + rows]
        if x.dtype.is_floating_point:
            nan = torch.isnan(x)
            if not torch.equal(nan, torch.isnan(y)):
                return False
            x, y = torch.where(nan, 0, x), torch.where(nan, 0, y)
        if not torch.equal(bits(torch, x), bits(torch, y)):
            return False
    return True


def qacc_operands(torch, qops, g, R, nslots, qb, nbk):
    """Random operands of the quantized step: a float32 buffer whose
    quantization blocks span 10^-4..10^4, a small error state, an int8
    message with its scales, slot vectors with about a quarter of the
    rows coincident, and NaN, inf, zero and tiny (scale-floor) blocks."""
    dev, bs = "cuda", qb * nbk
    mag = 10.0 ** torch.randint(-4, 5, (R, nslots, nbk, 1), generator=g,
                                device=dev).float()
    buf = (torch.randn((R, nslots, nbk, qb), generator=g, device=dev)
           * mag).view(R, nslots, bs)
    err = torch.randn((R, nslots, bs), generator=g, device=dev) * 1e-3
    q, s = qops.quant_blocks(torch.randn((R * nbk, qb), generator=g, device=dev))
    q, s = q.view(R, bs), s.view(R, nbk)
    acc = torch.randint(0, nslots, (R,), generator=g, device=dev, dtype=torch.int32)
    fwd = torch.randint(0, nslots, (R,), generator=g, device=dev, dtype=torch.int32)
    same = torch.rand((R,), generator=g, device=dev) < 0.25
    fwd = torch.where(same, acc, fwd).contiguous()
    buf[0, :, :qb] = 0.0
    buf[1, :, qb:qb + 1] = 1e-13
    buf[R // 2, :, bs - 1] = float("nan")
    buf[R - 1, :, 0] = float("inf")
    s[R // 3, nbk - 1] = float("nan")
    return buf, err, q.contiguous(), s.contiguous(), acc, fwd


def qacc_row_bytes(bs, nb, coincide, rows):
    """Bytes of one quantized step: a row whose slots differ moves six
    float32 rows (buf[acc], buf[fwd], err[fwd], each read and written),
    two int8 rows and two scale rows; a coincident row four float32 rows."""
    row, wire = bs * 4, 2 * (bs + nb * 4)
    return (6 * rows - 2 * coincide) * row + rows * wire


def quantized_bytes(P_, n, R, bs, nb, slots, in_elems) -> tuple:
    """Bytes one quantized allreduce of a leaf must move, from the plan's
    own tables (``slots``: fwd, acc, recv, send, over all ``P_`` ranks):
    its ``in_elems`` float32 a rank copied into the [n+2, bs] buffer, the
    qacc_shuffles, the rolls of the int8 payload and the scales, the
    root's requantization, the broadcast of both and the dequantize."""
    row, qrow, srow = bs * 4, bs, nb * 4
    _, coincide = reduce_bytes(P_, n, R, row, *slots[:2])
    bq, _ = bcast_bytes(P_, n, R, qrow, *slots[2:], upload_rows=2)
    bsc, _ = bcast_bytes(P_, n, R, srow, *slots[2:], upload_rows=2)
    return {
        "setup": P_ * in_elems * 4 + P_ * n * row + 2 * P_ * row
        + P_ * (n + 2) * row,
        "zero_messages": P_ * (qrow + srow),
        "qacc_shuffle": qacc_row_bytes(bs, nb, coincide, (R + 1) * P_),
        "reduce_rolls": R * 2 * P_ * (qrow + srow),
        "root_requantize": 3 * n * row + n * (qrow + srow),
        "broadcast_rounds": sum(bq.values()) + sum(bsc.values()),
        "dequantize": P_ * n * (qrow + srow + row),
    }, coincide


def quantized_launches(plan, leaves: int) -> dict:
    """The launches of one call of a quantized_allreduce plan: each leaf
    takes R + 1 qacc_shuffles, then the broadcast of its int8 payload and
    its scales (two buffers: a pack, R - 1 shuffles and an unpack each)."""
    R = len(plan.statics[0].ks)
    out = {"block_qacc_shuffle": (R + 1) * leaves, "block_pack": 2 * leaves,
           "block_shuffle": 2 * (R - 1) * leaves, "block_unpack": 2 * leaves}
    return {k: v for k, v in out.items() if v}


def completeness(torch, src, out, err, p, chunk=1 << 16):
    """max |sum_r src - (p * out_row + sum_r err)| over a [p, m] f32 pair
    of a quantized sum (``out``: the rows' common result in sum units,
    [m]), and whether it is within the reference test's tolerance
    (f64 sums, chunks of ``chunk`` elements)."""
    worst, within = 0.0, True
    for i in range(0, src.shape[1], chunk):
        s = src[:, i:i + chunk].double()
        exact = s.sum(0)
        resid = (out[i:i + chunk].double() + err[:, i:i + chunk].double().sum(0)
                 - exact).abs()
        tol = 1e-4 * torch.maximum(exact.abs(), s.abs().amax(0) * p) + 1e-6
        worst = max(worst, float(resid.max()))
        within = within and bool((resid <= tol).all())
    return worst, within


def compare_qacc(torch, bp, ref, qops, g, R, nslots, qb, nbk, timed: bool):
    """block_qacc_shuffle vs its plain version on the same inputs (bits,
    NaN by position; the scales bit for bit, NaN included); at the path's
    shape also the times.  Returns the kernel's record."""
    buf, err, q, s, acc, fwd = qacc_operands(torch, qops, g, R, nslots, qb, nbk)
    got = bp.block_qacc_shuffle(buf.clone(), err.clone(), q, s, acc, fwd)
    want = ref.block_qacc_shuffle_ref(buf, err, q, s, acc, fwd)
    where = f"at {R, nslots, qb * nbk} qb={qb}"
    check(all(same_or_nan(torch, k, w) for k, w in zip(got, want)),
          f"block_qacc_shuffle != plain {where}")
    check(torch.equal(bits(torch, got[3]), bits(torch, want[3])),
          f"block_qacc_shuffle scales differ in their bits {where}")
    rec = {"max_abs_err": max(max_abs_err(torch, k, w)
                              for k, w in zip(got, want) if k.is_floating_point())}
    del got, want
    torch.cuda.synchronize()
    if not timed:
        return rec
    coincide = int((acc == fwd).sum())
    rec.update(
        ms=cuda_ms(torch, lambda: bp.block_qacc_shuffle(buf, err, q, s, acc, fwd), 10),
        plain_ms=cuda_ms(torch, lambda: ref.block_qacc_shuffle_ref(
            buf, err, q, s, acc, fwd), 3),
        library_ms=None,
        bound_ms=ms_of_bytes(qacc_row_bytes(qb * nbk, nbk, coincide, R)))
    return rec


def bcast_bytes(P_, n, rows, row, recv_h, send_h, upload_rows) -> dict:
    """Bytes the broadcast must move, from the plan's own tables."""
    coincide = sum(int((recv_h[t] == send_h[t + 1]).sum())
                   for t in range(rows - 1))
    return {
        "zero_fill": P_ * (n + 1) * row,
        "root_upload": upload_rows * n * row,
        "pack": 2 * P_ * row,
        "roll": rows * 2 * P_ * row,
        # a row whose receive slot is its next send slot reads nothing of buf
        "shuffle": (4 * (rows - 1) * P_ - coincide) * row,
        "unpack": 2 * P_ * row,
    }, coincide


def reduce_bytes(P_, n, R, row, fwd_h, acc_h) -> dict:
    """Bytes the reduce must move, from the plan's own tables: a row of an
    acc_shuffle whose acc slot is its fwd slot moves four rows, not six."""
    nxt = list(fwd_h[1:]) + [[n] * P_]
    coincide = int((fwd_h[0] == n).sum()) + sum(
        int((acc_h[t] == nxt[t]).sum()) for t in range(R))
    return {
        "initial_copy": 2 * P_ * n * row,
        "fills": 2 * P_ * row,
        "zero_message": P_ * row,
        "roll": R * 2 * P_ * row,
        "acc_shuffle": (6 * (R + 1) * P_ - 2 * coincide) * row,
    }, coincide


def allgather_bytes(P_, n, R, row, recv_rows, send_rows) -> dict:
    """Bytes the allgather must move over its P_ * P_ rank-major rows,
    from the plan's own row tables ([R, P_ * P_] int32, on the device),
    the int32 slot vectors included."""
    rows, idx = P_ * P_, P_ * P_ * 4
    coincide = sum(int((recv_rows[t] == send_rows[t + 1]).sum())
                   for t in range(R - 1))
    return {
        "zero_fill": rows * (n + 1) * row,
        "own_blocks": 2 * P_ * n * row,
        "pack": 2 * rows * row + idx,
        "roll": R * 2 * rows * row,
        "shuffle": (4 * (R - 1) * rows - coincide) * row + (R - 1) * 2 * idx,
        "unpack": 2 * rows * row + idx,
    }, coincide


def level_bytes(flat, m: int, itemsize: int, upload_rows: int = 1) -> int:
    """Bytes one run of a hier level's flat plan must move, from its own
    slot tables: m elements re-blocked into the plan's n blocks (the
    padded tail included)."""
    row = -(-m // flat.n) * itemsize
    R = len(flat.ks)
    if flat.kind == "reduce":
        by, _ = reduce_bytes(flat.p, flat.n, R, row, *flat.slots)
    elif flat.kind == "broadcast":
        by, _ = bcast_bytes(flat.p, flat.n, R, row, *flat.slots, upload_rows)
    else:
        by, _ = allgather_bytes(flat.p, flat.n, R, row, *flat.device_slots)
    return sum(by.values())


def model_kernel_ptxas(ptxas) -> dict:
    """Registers and spill bytes of each model kernel, from ptxas's lines
    (an entry, then its stack and spill line, then its register line), by
    kernel name and its mangled template arguments."""
    out, name = {}, None
    for ln in ptxas:
        if "Compiling entry" in ln:
            m = re.search(r"\d+((?:flash_fwd|ssd)_[a-z_]*kernel)(I\w*?EE)?", ln)
            name = m.group(1) + (m.group(2) or "") if m else None
        elif name and "spill" in ln:
            nums = [int(w) for w in re.findall(r"(\d+) bytes spill", ln)]
            out[name] = {"spill_stores": nums[0], "spill_loads": nums[1]}
        elif name and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used ")[1].split()[0])
    return out


def bound_ms(flops: float, nbytes: float, peak: float):
    """The least time for the work: the larger of operations over the
    peak rate and bytes over the memory rate -> (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak * 1e3, ms_of_bytes(nbytes)
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attn_work(B, S, H, Hkv, hd, causal, window, itemsize, Skv=None, hd_v=None):
    """FLOPs of attention of S queries over Skv keys (default S) on the
    (query, key) pairs it must see (all S * Skv; causal, S == Skv: the
    triangle, cut by the window) -- q.k, 2 * hd a pair, and p.v, 2 * hd_v
    (default hd) -- and the bytes of q, k, v read once and out written
    once."""
    Skv = S if Skv is None else Skv
    hd_v = hd if hd_v is None else hd_v
    if not causal:
        pairs = S * Skv
    else:
        w = min(window or S, S)
        pairs = w * (w + 1) // 2 + (S - w) * w
    return (2 * B * H * (hd + hd_v) * pairs,
            itemsize * B * (hd + hd_v) * (H * S + Hkv * Skv))


def scan_work(B, S, H, P, G, N, chunk):
    """FLOPs of the chunked SSD scan per batch row and chunk of L
    positions: the lower triangle of C B^T (N) once per group, since it
    depends on the group alone; per head the lower triangle of W x (P),
    the inter-chunk C S and the state update (2 L N P each); and the
    bytes of x, B, C, dt, A_log, D read once and y written once (f32)."""
    Q = min(chunk, S)
    per_row = 0
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        per_row += H * (L * (L + 1) * P + 4 * L * N * P) + G * L * (L + 1) * N
    return B * per_row, 4 * (2 * B * S * H * P + 2 * B * S * G * N + B * S * H + 2 * H)


def sdpa_backend(torch, q, k, v, causal: bool, gqa: bool, mask=None):
    """The backend ``scaled_dot_product_attention`` picks for these
    operands (its dispatcher's own choice), or None where this torch does
    not say."""
    try:
        from torch.nn.attention import SDPBackend

        names = {int(m.value): n for n, m in SDPBackend.__members__.items()}
        return names.get(int(torch._fused_sdp_choice(q, k, v, attn_mask=mask,
                                                      is_causal=causal,
                                                      enable_gqa=gqa)))
    except (AttributeError, ImportError, RuntimeError, TypeError):
        return None


def compare_attention(torch, fa, g, B, S, H, Hkv, hd, causal, window, dtype,
                      timed: bool, Skv=None, hd_v=None, masked_library=False):
    """flash_attention of S queries over Skv keys (default S), values of
    hd_v (default hd), vs its plain version on the same random q, k, v;
    timed: also kernel, plain and library (scaled_dot_product_attention,
    with the backend it picks: no window only, or with
    ``masked_library`` the causal window as an explicit boolean mask)
    times and the bound.  Returns the record."""
    import torch.nn.functional as F

    Skv = S if Skv is None else Skv
    hd_v = hd if hd_v is None else hd_v
    q, k, v = (torch.randn((B, s, h, w), generator=g, device="cuda").to(dtype)
               for s, h, w in ((S, H, hd), (Skv, Hkv, hd), (Skv, Hkv, hd_v)))
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.blocked_attention(q, k, v, causal, window)
    name = str(dtype).removeprefix("torch.")
    atol, rtol = ATTN_TOL[name]
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol),
          f"flash_attention != plain at {B, S, Skv, H, Hkv, hd} {name} "
          f"causal={causal} window={window}: max abs {err}")
    rec = {"shape": [B, S, H, Hkv, hd], "seq_kv": Skv, "hd_v": hd_v, "dtype": name,
           "causal": causal, "window": window, "max_abs_err": err,
           "max_abs_plain": float(want.float().abs().max()),
           "atol": atol, "rtol": rtol}
    del got, want
    if not timed:
        return rec
    flops, nbytes = attn_work(B, S, H, Hkv, hd, causal, window, q.element_size(),
                              Skv, hd_v)
    rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, PEAK_FLOPS[name])
    rec.update(flops=flops, bytes=nbytes,
               ms=cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal,
                                                            window=window), 10),
               plain_ms=cuda_ms(torch, lambda: fa.blocked_attention(q, k, v, causal,
                                                                    window), 3))
    rec["tflops"] = flops / rec["ms"] * 1e-9
    # the kernel's own tensor-core work: q.k once, p.v twice (P split hi + lo)
    rec["bound_ms_split_p"] = (flops * (hd + 2 * hd_v) / (hd + hd_v)
                               / PEAK_FLOPS[name] * 1e3)
    rec["library_ms"] = rec["library_backend"] = None
    if window is None:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rec["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=H != Hkv), 10)
        rec["library_backend"] = sdpa_backend(torch, qt, kt, vt, causal, H != Hkv)
    elif masked_library:
        # query i sees keys i - window < j <= i, as a [S, Skv] boolean mask
        i, j = torch.arange(S, device="cuda")[:, None], torch.arange(Skv, device="cuda")
        mask = (j <= i) & (i - j < window)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rec["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=H != Hkv), 10)
        rec["library_backend"] = sdpa_backend(torch, qt, kt, vt, False, H != Hkv, mask)
        rec["library_mask"] = "boolean [S, Skv]"
    return rec


def compare_scan_phases(torch, ss, ops, chunk, timed: bool):
    """Each phase of the CUDA scan against its plain phase, the CUDA phase
    fed the plain phases' inputs; timed: each phase's kernel and plain
    times.  Returns {phase: record}."""
    x, Bm, Cm, dt, A_log, D = ops
    want_cum, want_sloc = ss.ssd_chunk_states(x, Bm, dt, A_log, chunk)
    want_prev = ss.ssd_state_pass(want_cum, want_sloc)
    want_y = ss.ssd_chunk_outputs(x, Bm, Cm, dt, D, want_cum, want_prev, chunk)
    cum, sloc = ss.chunk_states(*ops, chunk=chunk)
    prev = ss.state_pass(want_cum, want_sloc.clone())
    y = ss.chunk_outputs(*ops, want_cum, want_prev, chunk=chunk)
    recs = {}
    for name, pairs in (("chunk_states", ((cum, want_cum), (sloc, want_sloc))),
                        ("state_pass", ((prev, want_prev),)),
                        ("chunk_outputs", ((y, want_y),))):
        err = max(float((a - b).abs().max()) for a, b in pairs)
        check(all(torch.allclose(a, b, atol=SCAN_TOL, rtol=SCAN_TOL) for a, b in pairs),
              f"ssd_scan phase {name} != plain at {tuple(x.shape)}: max abs {err}")
        recs[name] = {"max_abs_err": err, "tolerance": SCAN_TOL}
    del cum, sloc, prev, y, want_y
    if timed:
        spare = want_sloc.clone()
        runs = {
            "chunk_states": (lambda: ss.chunk_states(*ops, chunk=chunk),
                             lambda: ss.ssd_chunk_states(x, Bm, dt, A_log, chunk)),
            "state_pass": (lambda: ss.state_pass(want_cum, spare),
                           lambda: ss.ssd_state_pass(want_cum, want_sloc)),
            "chunk_outputs": (
                lambda: ss.chunk_outputs(*ops, want_cum, want_prev, chunk=chunk),
                lambda: ss.ssd_chunk_outputs(x, Bm, Cm, dt, D, want_cum, want_prev,
                                             chunk)),
        }
        for name, (kernel, plain) in runs.items():
            recs[name].update(ms=cuda_ms(torch, kernel, 10),
                              plain_ms=cuda_ms(torch, plain, 3))
    return recs


def compare_scan(torch, ss, g, B, S, H, P, G, N, chunk, timed: bool):
    """ssd_scan vs its plain version on the same random inputs (dt in
    [0.01, 0.2], A in -[0.5, 2]), and each of its phases vs the plain
    phase; timed: also kernel and plain times and the bounds.  Returns
    the record."""
    x = torch.randn((B, S, H, P), generator=g, device="cuda")
    Bm, Cm = (torch.randn((B, S, G, N), generator=g, device="cuda") for _ in range(2))
    dt = 0.01 + 0.19 * torch.rand((B, S, H), generator=g, device="cuda")
    A_log = torch.log(0.5 + 1.5 * torch.rand((H,), generator=g, device="cuda"))
    D = torch.randn((H,), generator=g, device="cuda")
    ops = (x, Bm, Cm, dt, A_log, D)
    got = ss.ssd_scan(*ops, chunk=chunk)
    want = ss.ssd_chunked(*ops, chunk)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, atol=SCAN_TOL, rtol=SCAN_TOL),
          f"ssd_scan != plain at {B, S, H, P, G, N} chunk {chunk}: max abs {err}")
    rec = {"shape": [B, S, H, P, G, N], "chunk": chunk, "dtype": "float32",
           "max_abs_err": err, "max_abs_plain": float(want.abs().max()),
           "tolerance": SCAN_TOL}
    del got, want
    rec["phases"] = compare_scan_phases(torch, ss, ops, chunk, timed)
    if not timed:
        return rec
    flops, nbytes = scan_work(B, S, H, P, G, N, chunk)
    rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, PEAK_FLOPS["float32"])
    # the kernel's own tensor-core work: three TF32 products per f32 product
    rec["bound_ms_3xtf32"] = 3 * flops / TF32_FLOPS * 1e3
    rec.update(flops=flops, bytes=nbytes, library_ms=None,
               ms=cuda_ms(torch, lambda: ss.ssd_scan(*ops, chunk=chunk), 10),
               plain_ms=cuda_ms(torch, lambda: ss.ssd_chunked(*ops, chunk), 3))
    rec["tflops"] = flops / rec["ms"] * 1e-9
    return rec


def hier_blocks(torch, kind, shape):
    """The port's block counts of a hier plan (``_resolve_hier_blocks``:
    the levels' optima under DEFAULT_MODEL, capped at the elements a
    level splits) for one float32 leaf of this global shape."""
    from repro_torch.core.comm import payload_spec
    from repro_torch.core.costmodel import DEFAULT_MODEL
    from repro_torch.core.hier import _resolve_hier_blocks

    spec = payload_spec({"x": torch.empty(shape, device="meta")})
    return _resolve_hier_blocks(kind, spec, NODES, HIER_CORES, None, None,
                                DEFAULT_MODEL, DEFAULT_MODEL)


def hier_phases(torch, np, card, kmods, g, flat_ms) -> tuple:
    """The two-level host plans at the paper's 36 x 32 topology: the
    broadcast of the flat broadcast's payload, reduce (sum, max, int32
    sum) and allreduce of the flat reduce's contributions, and the
    allgather of the flat allgather's, each "cuda" bit for bit against
    "torch" and the exact result, and each certified by the port's
    message-passing simulator.  ``flat_ms``: the flat paths' times of
    this run, printed beside.  Returns ({phase: launches}, {kind: ms})."""
    from repro_torch.core import (
        hier_host_plan,
        hier_rounds,
        simulate_hier_allreduce,
        simulate_hier_broadcast,
        simulate_hier_reduce,
    )
    from repro_torch.core.hier import _split as hier_split

    elems = PAYLOAD_BYTES // 4
    counts = {}

    def launches_of(plan):
        """Rounds of each level and the launches one run makes: a forward
        level of R rounds packs once, shuffles R - 1 times and unpacks
        once; a reduce level acc_shuffles R + 1 times; the reduce's and
        the allgather's intra level runs once a node, the broadcast's
        once."""
        want, rounds = {}, {}
        for name, level, times in (("inter", plan.inter, 1),
                                   ("intra", plan.intra, NODES)):
            for flat in (level if isinstance(level, tuple) else (level,)):
                R = len(flat.ks)
                rounds[f"{name}_{flat.kind}"] = R
                if flat.kind == "reduce":
                    steps = {"block_acc_shuffle": times * (R + 1)}
                else:
                    k = 1 if flat.kind == "broadcast" else times
                    steps = {"block_pack": k, "block_shuffle": k * (R - 1),
                             "block_unpack": k}
                for kname, c in steps.items():
                    want[kname] = want.get(kname, 0) + c
        return want, rounds

    def every_rank(out, want_row):
        """[NODES, HIER_CORES, m] equal to want_row [m] at every rank, a
        node at a time."""
        return all(torch.equal(out[j], want_row.expand(HIER_CORES, -1))
                   for j in range(NODES))

    def timed(plan, plain, x):
        """CUDA-event times (warm, median of 5; plain median of 3), peak
        memory since the last reset (it counts what earlier phases left
        allocated: the cached flat plans' slot tables, the allgather's
        [R, 1152^2] row tables above all), and the host time of the call
        (it returns before the device has finished, except where a sweep
        synchronises to check its copies)."""
        ms, runs = median_ms(torch, lambda: plan.run(x), 5)
        peak = torch.cuda.max_memory_allocated()
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan.run(x)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        plain_ms, plain_runs = median_ms(torch, lambda: plain.run(x), 3)
        return {"ms": ms, "ms_runs": runs, "plain_ms": plain_ms,
                "plain_ms_runs": plain_runs,
                "host_call_ms": sorted(host)[2],
                "max_memory_allocated": peak,
                "allocated_before_the_phase": before}

    def node_loop(plan, x):
        """The re-blocking of node 0's contributions, one intra run (node
        0's) and the inter run of a reduce or allgather plan, each timed
        alone on what the sweep hands it (CUDA events, mean of 3)."""
        split = hier_split(x[0], plan.n_intra)
        width = x.shape[-1] * (1 if plan.kind == "reduce" else HIER_CORES)
        parts = hier_split(torch.zeros((NODES, width), dtype=x.dtype,
                                       device="cuda"), plan.n_inter)
        seam = cuda_ms(torch, lambda: hier_split(x[0], plan.n_intra), 3)
        one = cuda_ms(torch, lambda: plan.intra.run(split), 3)
        inter = cuda_ms(torch, lambda: plan.inter.run(parts), 3)
        return {"intra_split_one_node": seam, "intra_run_one_node": one,
                "intra_splits_and_runs_all_nodes": NODES * (seam + one),
                "inter_run": inter}

    # 8a. hier_broadcast: 16 MiB f32 from root 100 (node 3, core 4)
    nN, nC = hier_blocks(torch, "broadcast", (P, elems))
    payload = np.random.default_rng(SEED).standard_normal(elems, dtype=np.float32)
    want_row = torch.from_numpy(payload).cuda()
    plan = hier_host_plan("broadcast", NODES, HIER_CORES, nN, nC, root=BCAST_ROOT)
    plain = hier_host_plan("broadcast", NODES, HIER_CORES, nN, nC,
                           root=BCAST_ROOT, backend="torch")
    expect, rounds = launches_of(plan)
    check(sum(rounds.values()) == hier_rounds("broadcast", NODES, HIER_CORES,
                                              nN, nC), f"hier rounds {rounds}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out, got = counted_run(torch, kmods, lambda: plan.run(payload))
    check(got == expect, f"hier broadcast launches {got} != {expect}")
    counts["hier_broadcast"] = got
    check(tuple(out.shape) == (NODES, HIER_CORES, elems) and every_rank(out, want_row),
          "hier broadcast: a rank does not hold the root's payload")
    out_plain = plain.run(payload)
    check(same_bits(torch, out, out_plain, rows=1),
          "hier broadcast: cuda backend != torch backend")
    del out, out_plain
    sim = simulate_hier_broadcast(NODES, HIER_CORES, nN, nC, root=BCAST_ROOT,
                                  backend="cuda")
    t = timed(plan, plain, payload)
    bound = (level_bytes(plan.inter, elems, 4, upload_rows=1)
             + level_bytes(plan.intra, elems, 4, upload_rows=2))
    emit({"phase": "hier_broadcast", "nodes": NODES, "cores": HIER_CORES,
          "n": [nN, nC], "rounds": rounds, "root": BCAST_ROOT,
          "payload_bytes": PAYLOAD_BYTES, "launches": got,
          "every_rank_holds_payload": True, "equal_to_torch_backend": True,
          "simulated": {"rounds": sim.rounds, "messages": sim.messages,
                        "backend": sim.backend},
          **t, "bytes_moved": bound, "bytes_bound_ms": ms_of_bytes(bound),
          "flat_ms": flat_ms["broadcast"], "card": card})
    del want_row
    torch.cuda.empty_cache()

    # 8b. hier_reduce (sum, max) and hier_allreduce: 16 MiB f32 a rank,
    #     integer-valued first (exact sums), then standard normal
    nN, nC = hier_blocks(torch, "reduce", (P, elems))
    nNa, nCa = hier_blocks(torch, "allreduce", (P, elems))
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    contrib = torch.randint(-8, 9, (NODES, HIER_CORES, elems), generator=g,
                            device="cuda", dtype=torch.float32)
    plans = {op: (hier_host_plan("reduce", NODES, HIER_CORES, nN, nC,
                                 root=BCAST_ROOT, op=op),
                  hier_host_plan("reduce", NODES, HIER_CORES, nN, nC,
                                 root=BCAST_ROOT, op=op, backend="torch"))
             for op in ("sum", "max")}
    plan_r, plain_r = plans["sum"]
    plan_a = hier_host_plan("allreduce", NODES, HIER_CORES, nNa, nCa,
                            root=BCAST_ROOT)
    plain_a = hier_host_plan("allreduce", NODES, HIER_CORES, nNa, nCa,
                             root=BCAST_ROOT, backend="torch")
    expect_r, rounds_r = launches_of(plan_r)
    expect_a, rounds_a = launches_of(plan_a)
    out, got = counted_run(torch, kmods, lambda: plan_r.run(contrib))
    check(got == expect_r, f"hier reduce launches {got} != {expect_r}")
    counts["hier_reduce"] = got
    exact = contrib.view(P, elems).sum(0)
    check(torch.equal(out, exact), "hier reduce: root != values.sum over ranks")
    del out
    t_r = timed(plan_r, plain_r, contrib)
    loop_r = node_loop(plan_r, contrib)
    out, got = counted_run(torch, kmods, lambda: plan_a.run(contrib))
    check(got == expect_a, f"hier allreduce launches {got} != {expect_a}")
    counts["hier_allreduce"] = got
    check(every_rank(out, exact), "hier allreduce: a rank does not hold the sum")
    del out, exact
    t_a = timed(plan_a, plain_a, contrib)
    torch.cuda.empty_cache()

    contrib.normal_(generator=g)
    out = plan_r.run(contrib)
    check(same_bits(torch, out, plain_r.run(contrib), rows=elems),
          "hier reduce: cuda backend != torch backend on normal values")
    out = plan_a.run(contrib)
    check(same_bits(torch, out, plain_a.run(contrib), rows=1),
          "hier allreduce: cuda backend != torch backend on normal values")
    del out
    plan_m, plain_m = plans["max"]
    out, got = counted_run(torch, kmods, lambda: plan_m.run(contrib))
    check(got == expect_r, f"hier max launches {got} != {expect_r}")
    check(torch.equal(out, contrib.view(P, elems).amax(0)),
          "hier reduce max: root != values.amax over ranks")
    check(same_bits(torch, out, plain_m.run(contrib), rows=elems),
          "hier reduce max: cuda backend != torch backend")
    del out, contrib
    torch.cuda.empty_cache()
    contrib = torch.randint(-2 ** 31, 2 ** 31, (NODES, HIER_CORES, elems),
                            generator=g, device="cuda", dtype=torch.int32)
    out, got = counted_run(torch, kmods, lambda: plan_r.run(contrib))
    check(got == expect_r, f"hier int32 reduce launches {got} != {expect_r}")
    check(out.dtype == torch.int32 and torch.equal(
        out, contrib.view(P, elems).sum(0, dtype=torch.int32)),
        "hier reduce int32: root != values.sum over ranks (wrapping)")
    red_peak = torch.cuda.max_memory_allocated()
    del out, contrib
    torch.cuda.empty_cache()
    sims = {op: simulate_hier_reduce(NODES, HIER_CORES, nN, nC, root=BCAST_ROOT,
                                     op=op, backend="cuda").rounds
            for op in ("+", "max")}
    sim_a = simulate_hier_allreduce(NODES, HIER_CORES, nNa, nCa,
                                    root=BCAST_ROOT, backend="cuda")
    bound_r = (NODES * level_bytes(plan_r.intra, elems, 4)
               + level_bytes(plan_r.inter, elems, 4))
    red_c, bc_c = plan_a.intra
    red_n, bc_n = plan_a.inter
    bound_a = (NODES * level_bytes(red_c, elems, 4) + level_bytes(red_n, elems, 4)
               + level_bytes(bc_n, elems, 4, upload_rows=2)
               + level_bytes(bc_c, elems, 4, upload_rows=2))
    emit({"phase": "hier_reduce", "nodes": NODES, "cores": HIER_CORES,
          "n": [nN, nC], "rounds": rounds_r, "root": BCAST_ROOT,
          "ops": ["sum", "max", "sum int32"], "payload_bytes": PAYLOAD_BYTES,
          "contribution_bytes": P * PAYLOAD_BYTES, "launches": expect_r,
          "root_equals_exact_sum": True, "equal_to_torch_backend": True,
          "max_root_equals_amax": True, "int32_root_equals_wrapped_sum": True,
          "simulated_rounds": sims, **t_r, "max_memory_allocated_int32": red_peak,
          "bytes_moved": bound_r, "bytes_bound_ms": ms_of_bytes(bound_r),
          "breakdown_ms": loop_r, "flat_ms": flat_ms["reduce"], "card": card})
    emit({"phase": "hier_allreduce", "nodes": NODES, "cores": HIER_CORES,
          "n": [nNa, nCa], "rounds": rounds_a, "root": BCAST_ROOT, "op": "sum",
          "launches": expect_a, "every_rank_holds_exact_sum": True,
          "equal_to_torch_backend": True,
          "simulated": {"rounds": sim_a.rounds, "messages": sim_a.messages},
          **t_a, "bytes_moved": bound_a, "bytes_bound_ms": ms_of_bytes(bound_a),
          "flat_ms": flat_ms["allreduce"], "card": card})

    # 8c. hier_allgather: 8 KiB f32 a rank
    e = GATHER_BYTES // 4
    nN, nC = hier_blocks(torch, "allgather", (P * e,))
    vals = torch.randn((NODES, HIER_CORES, e), generator=g, device="cuda")
    plan_g = hier_host_plan("allgather", NODES, HIER_CORES, nN, nC)
    plain_g = hier_host_plan("allgather", NODES, HIER_CORES, nN, nC,
                             backend="torch")
    expect_g, rounds_g = launches_of(plan_g)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out, got = counted_run(torch, kmods, lambda: plan_g.run(vals))
    check(got == expect_g, f"hier allgather launches {got} != {expect_g}")
    counts["hier_allgather"] = got
    check(torch.equal(out, vals.view(P, e)),
          "hier allgather: the result is not every rank's values, rank-major")
    check(same_bits(torch, out, plain_g.run(vals)),
          "hier allgather: cuda backend != torch backend")
    del out
    t_g = timed(plan_g, plain_g, vals)
    loop_g = node_loop(plan_g, vals)
    bound_g = (NODES * level_bytes(plan_g.intra, e, 4)
               + level_bytes(plan_g.inter, HIER_CORES * e, 4))
    emit({"phase": "hier_allgather", "nodes": NODES, "cores": HIER_CORES,
          "n": [nN, nC], "rounds": rounds_g, "bytes_per_rank": GATHER_BYTES,
          "launches": expect_g, "every_rank_holds_every_block": True,
          "equal_to_torch_backend": True, **t_g,
          "bytes_moved": bound_g, "bytes_bound_ms": ms_of_bytes(bound_g),
          "breakdown_ms": loop_g, "flat_ms": flat_ms["allgather"], "card": card})
    del vals
    torch.cuda.empty_cache()
    return counts, {"broadcast": t["ms"], "reduce": t_r["ms"],
                    "allreduce": t_a["ms"], "allgather": t_g["ms"]}


#: The launches of the hiercomm paths at 36 x 32 with n = (41, 37) (46 +
#: 41 rounds) and, for the allgather, (30, 5) (35 + 9 rounds): one plan
#: over all 1152 rows launches each level's kernels once a round.
HIERCOMM_LAUNCHES = {
    "broadcast": {"block_pack": 2, "block_shuffle": 85, "block_unpack": 2},
    "reduce": {"block_acc_shuffle": 89},
    "allreduce": {"block_acc_shuffle": 89, "block_pack": 2,
                  "block_shuffle": 85, "block_unpack": 2},
    "allgather": {"block_pack": 2, "block_shuffle": 42, "block_unpack": 2},
}


def hiercomm_phases(torch, np, card, kmods, g, host_ms) -> dict:
    """The two-level communicator over ``StackedGrid(36, 32)``: every
    level runs once over all 1152 rows of the card, the exchange a roll
    of ``view(36, 32, ...)`` along dim 0 (inter) or dim 1 (intra).  At the
    hier_* phases' payloads (16 MiB a rank, root 100; the allgather 8 KiB
    a rank): broadcast; reduce (f32 sum of integer values, f32 max, a
    wrapping int32 sum); allreduce; allgather, each exact at full size
    and by its launches, and bit for bit against ``hier_host_plan`` and
    the "torch" backend at 1 MiB a rank (the allgather at its full
    size).  Each line gives its time (CUDA events, warm, median of 5),
    the host time of the call, the bytes-bound of all 1152 rows from the
    levels' flat plans, the peak since the phase began and the host
    plan's time of this run (``host_ms``).  Returns {phase: launches}."""
    from repro_torch.core import StackedGrid, get_hier_comm, hier_host_plan

    grid = StackedGrid(NODES, HIER_CORES)
    hc, plain = get_hier_comm(grid), get_hier_comm(grid, backend="torch")
    elems, small = PAYLOAD_BYTES // 4, (1 << 20) // 4
    rN, rC = divmod(BCAST_ROOT, HIER_CORES)
    counts = {}

    def fresh():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def run_counted(name, kind, plan, x):
        out, got = counted_run(torch, kmods, lambda: plan(x))
        check(got == comm_launches(plan, 1) == HIERCOMM_LAUNCHES[kind],
              f"{name} launches {got}, statics say {comm_launches(plan, 1)}")
        counts[name] = got
        return out

    def timed(plan, x, before):
        ms, runs = median_ms(torch, lambda: plan(x), 5)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan(x)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return {"ms": ms, "ms_runs": runs, "host_call_ms": sorted(host)[2],
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "allocated_before_the_phase": before}

    def every_row(t, row, rows=64):
        return all(torch.equal(t[i:i + rows], row.expand(min(rows, t.shape[0] - i), -1))
                   for i in range(0, t.shape[0], rows))

    def level_plans(kind, plan):
        """The flat host plans of each level, as (inter, intra) lists."""
        hp = hier_host_plan(kind, NODES, HIER_CORES, plan.n_inter, plan.n_intra,
                            root=plan.root, op=plan.op or "sum")
        return [(hp.inter if isinstance(hp.inter, tuple) else (hp.inter,)),
                (hp.intra if isinstance(hp.intra, tuple) else (hp.intra,))]

    def bound_of(kind, plan, m_inter, m_intra):
        """Bytes of all 1152 rows of f32: each level's flat plan once a
        core (inter) or a node (intra), at the elements a rank holds at
        that level; a broadcast level's source rows (the root's, then the
        leaders') read and written once; the reduce's root mask."""
        inter, intra = level_plans(kind, plan)
        total = 0
        for flat in inter:
            total += (level_bytes(flat, m_inter, 4, upload_rows=2)
                      + (HIER_CORES - 1) * level_bytes(flat, m_inter, 4, upload_rows=0))
        for flat in intra:
            total += NODES * level_bytes(flat, m_intra, 4, upload_rows=2)
        if kind == "reduce":
            total += (P - 1) * m_inter * 4
        return total

    def small_checks(kind, x, **kw):
        """At 1 MiB a rank: "cuda" bit for bit against hier_host_plan and
        against the "torch" backend; the launches of the call."""
        plan = hc.plan(kind, x, **kw)
        out, got = counted_run(torch, kmods, lambda: plan(x))
        check(got == comm_launches(plan, 1), f"hiercomm {kind} at 1 MiB: {got}")
        check(same_bits(torch, out, plain.plan(kind, x, **kw)(x)),
              f"hiercomm {kind} at 1 MiB: cuda backend != torch backend")
        hp = hier_host_plan(kind, NODES, HIER_CORES, plan.n_inter, plan.n_intra,
                            root=plan.root, op=kw.get("op", "sum"))
        if kind == "broadcast":
            want = hp.run(x[BCAST_ROOT]).reshape(P, -1)
        elif kind == "reduce":
            want = torch.zeros_like(out)
            want[BCAST_ROOT] = hp.run(x)
        else:
            want = hp.run(x).reshape(P, -1)
        check(same_bits(torch, out, want),
              f"hiercomm {kind} at 1 MiB: != hier_host_plan {kind}")
        return {"n": [plan.n_inter, plan.n_intra], "launches": got}

    def emit_phase(name, kind, plan, t, m_inter, m_intra, **extra):
        bound = bound_of(kind, plan, m_inter, m_intra)
        emit({"phase": name, "grid": [NODES, HIER_CORES],
              "n": [plan.n_inter, plan.n_intra],
              "rounds": {"inter": plan.rounds_inter, "intra": plan.rounds_intra},
              **extra, **t, "bytes_moved": bound, "bytes_bound_ms": ms_of_bytes(bound),
              "host_plan_ms": host_ms[kind], "card": card})

    # hiercomm_broadcast: 16 MiB f32 a rank from root 100 (node 3, core 4)
    before = fresh()
    x = torch.randn((P, elems), generator=g, device="cuda")
    plan = hc.plan("broadcast", x, root=BCAST_ROOT)
    out = run_counted("hiercomm_broadcast", "broadcast", plan, x)
    check(every_row(out, x[BCAST_ROOT]),
          "hiercomm broadcast: a rank does not hold the root's slice")
    del out
    t = timed(plan, x, before)
    at_1mib = small_checks("broadcast", x[:, :small], root=BCAST_ROOT)
    emit_phase("hiercomm_broadcast", "broadcast", plan, t, elems, elems,
               root=BCAST_ROOT, payload_bytes=PAYLOAD_BYTES,
               launches=counts["hiercomm_broadcast"],
               every_rank_holds_root_slice=True, at_1MiB_equal_to_host_plan_and_torch=at_1mib)
    del x

    # hiercomm_reduce (f32 sum of integer values, f32 max, int32 sum that
    # wraps) and hiercomm_allreduce of the f32 integer values
    before = fresh()
    x = torch.randint(-8, 9, (P, elems), generator=g, device="cuda",
                      dtype=torch.float32)
    exact = x.sum(0)
    plan = hc.plan("reduce", x, root=BCAST_ROOT)
    out = run_counted("hiercomm_reduce", "reduce", plan, x)
    check(torch.equal(out[BCAST_ROOT], exact)
          and all_equal_to(torch, out[:BCAST_ROOT], 0)
          and all_equal_to(torch, out[BCAST_ROOT + 1:], 0),
          "hiercomm reduce: root != values.sum over ranks, or a rank not drained")
    del out
    t_r = timed(plan, x, before)
    plan_a = hc.plan("allreduce", x, root=BCAST_ROOT)
    torch.cuda.reset_peak_memory_stats()
    out = run_counted("hiercomm_allreduce", "allreduce", plan_a, x)
    check(every_row(out, exact), "hiercomm allreduce: a rank does not hold the sum")
    del out
    t_a = timed(plan_a, x, before)
    x.normal_(generator=g)
    plan_m = hc.plan("reduce", x, root=BCAST_ROOT, op="max")
    out = run_counted("hiercomm_reduce_max", "reduce", plan_m, x)
    check(torch.equal(out[BCAST_ROOT], x.amax(0)),
          "hiercomm reduce max: root != values.amax over ranks")
    del out
    small_r = {op: small_checks("reduce", x[:, :small], root=BCAST_ROOT, op=op)
               for op in ("sum", "max")}
    small_a = small_checks("allreduce", x[:, :small], root=BCAST_ROOT)
    del x, exact
    torch.cuda.empty_cache()
    xi = torch.randint(-2 ** 31, 2 ** 31, (P, elems), generator=g, device="cuda",
                       dtype=torch.int32)
    plan_i = hc.plan("reduce", xi, root=BCAST_ROOT)
    out = run_counted("hiercomm_reduce_int32", "reduce", plan_i, xi)
    check(out.dtype == torch.int32
          and torch.equal(out[BCAST_ROOT], xi.sum(0, dtype=torch.int32)),
          "hiercomm reduce int32: root != values.sum over ranks (wrapping)")
    del out
    small_r["sum int32"] = small_checks("reduce", xi[:, :small], root=BCAST_ROOT)
    del xi
    emit_phase("hiercomm_reduce", "reduce", plan, t_r, elems, elems, root=BCAST_ROOT,
               ops=["sum", "max", "sum int32"], payload_bytes=PAYLOAD_BYTES,
               launches=counts["hiercomm_reduce"], root_equals_exact_sum=True,
               max_root_equals_amax=True, int32_root_equals_wrapped_sum=True,
               at_1MiB_equal_to_host_plan_and_torch=small_r)
    emit_phase("hiercomm_allreduce", "allreduce", plan_a, t_a, elems, elems,
               root=BCAST_ROOT, op="sum", launches=counts["hiercomm_allreduce"],
               every_rank_holds_exact_sum=True,
               at_1MiB_equal_to_host_plan_and_torch=small_a)

    # hiercomm_allgather: 8 KiB f32 a rank, checked at its full size
    e = GATHER_BYTES // 4
    before = fresh()
    x = torch.randn((P, e), generator=g, device="cuda")
    plan = hc.plan("allgather", x)
    out = run_counted("hiercomm_allgather", "allgather", plan, x)
    check(torch.equal(out, x), "hiercomm allgather: not every rank's values, rank-major")
    check(same_bits(torch, out, plain.plan("allgather", x)(x)),
          "hiercomm allgather: cuda backend != torch backend")
    hp = hier_host_plan("allgather", NODES, HIER_CORES, plan.n_inter, plan.n_intra)
    check(same_bits(torch, out, hp.run(x.view(NODES, HIER_CORES, e))),
          "hiercomm allgather: != hier_host_plan allgather")
    del out
    copies = plan.per_rank(x)
    check(tuple(copies.shape) == (P, P, e)
          and all(torch.equal(copies[i], x) for i in range(P)),
          "hiercomm allgather: a rank's copy is not every rank's values")
    del copies
    t_g = timed(plan, x, before)
    emit_phase("hiercomm_allgather", "allgather", plan, t_g, HIER_CORES * e, e,
               bytes_per_rank=GATHER_BYTES, launches=counts["hiercomm_allgather"],
               every_rank_holds_every_block=True, equal_to_torch_backend=True,
               equal_to_host_plan=True)
    del x
    torch.cuda.empty_cache()
    return counts


def comm_launches(plan, buffers: int) -> dict:
    """The launches one call of a communicator plan (flat or hier) makes:
    each of its ``buffers`` round-step buffers (one a leaf; allgatherv:
    one a leaf and block size) takes each phase's rounds -- a forward
    phase of R rounds packs once, shuffles R - 1 times and unpacks once
    (overlapped: a pack every round and the staged shuffle), a reversed
    phase acc_shuffles R + 1 times (overlapped: once, then a pack and a
    staged acc_shuffle a round).  A hier plan has no overlapped loop."""
    overlap = getattr(plan, "overlap", False)
    out = {}
    for phase in plan.statics:
        R = len(phase.ks)
        if phase.direction == "fwd":
            steps = {"block_pack": R if overlap else 1,
                     ("block_shuffle_staged" if overlap
                      else "block_shuffle"): R - 1,
                     "block_unpack": 1}
        elif overlap:
            steps = {"block_acc_shuffle": 1, "block_pack": R,
                     "block_acc_shuffle_staged": R}
        else:
            steps = {"block_acc_shuffle": R + 1}
        for k, c in steps.items():
            if c:
                out[k] = out.get(k, 0) + c * buffers
    return out


def coincident(a, b) -> int:
    """Rows where two [rows] slot vectors on the card agree."""
    return int((a == b).sum())


def scatter_bytes(P_, n, R, row, fwd_rows, acc_rows, in_bytes, out_bytes) -> dict:
    """Bytes the reduce_scatter must move over its P_ * P_ rank-major rows,
    from its own row tables ([R+1, rows] fwd with the garbage row last,
    [R, rows] acc, int32 on the card): the contributions read and laid
    into blocks, the garbage slot and zero message, the rolls, the
    acc_shuffles (a row whose acc slot is its fwd slot moves four rows,
    not six) with their slot vectors, and the own rows out."""
    rows = P_ * P_
    idx = rows * 4
    coincide = coincident(fwd_rows[0], n) + sum(
        coincident(acc_rows[t], fwd_rows[t + 1]) for t in range(R))
    return {
        "initial_copy": in_bytes + rows * n * row,
        "fills": rows * row,
        "zero_message": rows * row,
        "roll": R * 2 * rows * row,
        "acc_shuffle": (6 * (R + 1) * rows - 2 * coincide) * row
                       + (R + 1) * 2 * idx,
        "own_rows": 2 * out_bytes,
    }, coincide


def gatherv_bytes(P_, n, R, groups, cap, itemsize) -> dict:
    """Bytes the allgatherv must move: for each group of roots of one
    block size (``(bs, roots, recv_rows, send_rows)``, the row tables on
    the card) the allgather's steps over its P_ * len(roots) rows, and
    the own blocks in and rank 0's rows out (each input element read
    once, the [P_, cap] result zeroed and written)."""
    out = dict.fromkeys(("zero_fill", "pack", "roll", "shuffle", "unpack"), 0)
    data = 0
    for bs, roots, recv_rows, send_rows in groups:
        rows, row, idx = P_ * len(roots), bs * itemsize, P_ * len(roots) * 4
        same = sum(coincident(recv_rows[t], send_rows[t + 1]) for t in range(R - 1))
        out["zero_fill"] += rows * (n + 1) * row
        out["pack"] += 2 * rows * row + idx
        out["roll"] += R * 2 * rows * row
        out["shuffle"] += (4 * (R - 1) * rows - same) * row + (R - 1) * 2 * idx
        out["unpack"] += 2 * rows * row + idx
        data += len(roots) * n * row
    out["own_blocks"] = P_ * cap * itemsize + data
    out["result"] = 2 * P_ * cap * itemsize + data
    return out


def acc_kernels_at(torch, bp, ref, g, fwd_rows, acc_rows, nslots, bs) -> dict:
    """block_acc_shuffle and block_acc_shuffle_staged (op sum) alone on a
    [rows, nslots, bs] float32 buffer over a plan's own row tables (fwd
    [R+1, rows] with the garbage row last, acc [R, rows]): each held bit
    for bit against its plain version at the rounds with the most and the
    fewest coincident rows, each time on a buffer of fresh normal values
    (the staged one with pre packed from it by that round's fwd row),
    then timed over every round (kernel and plain time a launch; the
    staged one with the last checked pre).  Bound: six rows a row, four
    where acc == fwd, plus the two int32 slot vectors, averaged over the
    rounds.  Returns {kernel: record}."""
    R, rows = len(acc_rows), acc_rows.shape[1]
    row, idx = bs * 4, rows * 4
    work = torch.empty((rows, nslots, bs), device="cuda")
    msg = torch.randn((rows, bs), generator=g, device="cuda")
    same = [coincident(acc_rows[t], fwd_rows[t + 1]) for t in range(R)]
    checked = sorted({max(range(R), key=same.__getitem__),
                      min(range(R), key=same.__getitem__)})
    chunk = max(1, (512 << 20) // (nslots * row))
    eq = lambda a, b: same_bits(torch, a, b, rows=chunk)  # noqa: E731
    err = lambda a, b: max_abs_err(torch, a, b, rows=chunk)  # noqa: E731
    names = ("block_acc_shuffle", "block_acc_shuffle_staged")
    out = {name: {"max_abs_err": 0.0, "rounds_checked": checked,
                  "their_coincident_rows": [same[t] for t in checked]}
           for name in names}
    for t in checked:
        acc, fwd = acc_rows[t], fwd_rows[t + 1]
        for name in names:
            work.normal_(generator=g)
            snap = work.clone()
            if name == "block_acc_shuffle":
                _, k = bp.block_acc_shuffle(work, msg, acc, fwd)
                _, r = ref.block_acc_shuffle_ref(snap, msg, acc, fwd)
            else:
                pre = ref.block_pack_ref(work, fwd)
                _, k = bp.block_acc_shuffle_staged(work, msg, pre, acc, fwd)
                _, r = ref.block_acc_shuffle_staged_ref(snap, msg, pre, acc, fwd)
            check(eq(work, snap) and eq(k, r),
                  f"{name} != plain at the reduce_scatter's rows, round {t}")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                           err(work, snap), err(k, r))
            del snap, k, r
    torch.cuda.synchronize()

    def per_launch(fn):
        return cuda_ms(torch, lambda: [fn(i) for i in range(R)], 1) / R

    bound = ms_of_bytes(sum((6 * rows - 2 * c) * row + 2 * idx for c in same) / R)
    out["block_acc_shuffle"].update(
        ms=per_launch(lambda i: bp.block_acc_shuffle(work, msg, acc_rows[i],
                                                     fwd_rows[i + 1])),
        plain_ms=per_launch(lambda i: ref.block_acc_shuffle_ref(
            work, msg, acc_rows[i], fwd_rows[i + 1])),
        library_ms=None, timed_launches=R, bound_ms=bound)
    out["block_acc_shuffle_staged"].update(
        ms=per_launch(lambda i: bp.block_acc_shuffle_staged(
            work, msg, pre, acc_rows[i], fwd_rows[i + 1])),
        plain_ms=per_launch(lambda i: ref.block_acc_shuffle_staged_ref(
            work, msg, pre, acc_rows[i], fwd_rows[i + 1])),
        library_ms=None, timed_launches=R, bound_ms=bound)
    return out


def comm_phases(torch, np, card, kmods, g, flat):
    """The plan/execute communicator over a StackedGroup of the 1152 ranks
    on the card, through ``get_comm(group).plan(kind, payload)(payload)``:
    broadcast (with ``broadcast_state`` of a mixed-dtype state), reduce
    (f32 sum, int32 sum, max), allreduce, allgather, reduce_scatter and
    allgatherv.  Each result is held exactly against the expected values,
    per leaf bit for bit against the port's host_plan of the same kind and
    n where one exists, "cuda" against "torch" (at 1 MiB a rank for the
    16 MiB payloads, at full size for the rest), overlapped against
    sequential, and by its launch counts.  ``flat``: the flat host plans'
    times of this run at the same bytes.  Returns ({phase: launches}, the
    records of block_acc_shuffle and block_acc_shuffle_staged alone at the
    reduce_scatter's rows)."""
    from repro_torch.core import StackedGroup, get_bundle, get_comm, host_plan
    from repro_torch.core.comm import _rotated_rows, _with_garbage
    from repro_torch.core.roundstep import broadcast_slot_plan, scatter_slot_plan
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels import block_pack as bp
    from repro_torch.kernels import ref
    from repro_torch.train.restore_broadcast import DCN_MODEL, broadcast_state

    group = StackedGroup(P)
    comm, plain = get_comm(group), get_comm(group, backend="torch")
    counts = {}
    f32, i32, bf16 = torch.float32, torch.int32, torch.bfloat16

    def meta(shapes):
        return {k: torch.empty(sh, dtype=dt, device="meta")
                for k, (sh, dt) in shapes.items()}

    def build(kind, spec, **kw):
        t0 = time.perf_counter()
        plan = comm.plan(kind, spec, **kw)
        return plan, time.perf_counter() - t0

    def blocked(n, E, dtype, normal):
        """A [P, E] leaf: the first E columns of a [P, n * ceil(E / n)]
        tensor with a zero tail, so the host plan takes it as [P, n, bs]
        blocks without a copy.  Standard normal, or int32 over the whole
        range (sums wrap)."""
        full = torch.zeros((P, n * -(-E // n)), dtype=dtype, device="cuda")
        x = full[:, :E]
        if normal:
            x.normal_(generator=g)
        else:
            x.random_(-2 ** 31, 2 ** 31, generator=g)
        return full, x

    def every_row(t, row, rows=64):
        return all(torch.equal(t[i:i + rows], row.expand(min(rows, t.shape[0] - i), -1))
                   for i in range(0, t.shape[0], rows))

    def same_tree(a, b, rows=64):
        return all(same_bits(torch, u, v, rows=rows)
                   for u, v in zip(tree_flatten(a)[0], tree_flatten(b)[0]))

    def timed(plan, x):
        """CUDA-event times (warm, median of 5), the host time of the call
        (median of 5; it returns before the card has finished) and the
        peak memory since the phase began."""
        ms, runs = median_ms(torch, lambda: plan(x), 5)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan(x)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return {"ms": ms, "ms_runs": runs, "host_call_ms": sorted(host)[2],
                "max_memory_allocated": torch.cuda.max_memory_allocated()}

    def fresh():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def small_vs_plain(kind, shapes, **kw):
        """"cuda" against "torch" at 1 MiB a rank (the same pytree, same
        p), bit for bit, and the launches of the "cuda" call."""
        n = comm.plan(kind, meta(shapes), **kw).n_blocks
        x = {k: blocked(n, sh[1], dt, dt != i32)[1] for k, (sh, dt) in shapes.items()}
        plan = comm.plan(kind, x, **kw)
        out, got = counted_run(torch, kmods, lambda: plan(x))
        check(got == comm_launches(plan, len(x)),
              f"comm {kind} at 1 MiB: launches {got}")
        check(same_tree(out, plain.plan(kind, x, **kw)(x)),
              f"comm {kind} at 1 MiB a rank: cuda backend != torch backend")
        return {"n": n, "launches": got}

    W, B = PAYLOAD_BYTES * 3 // 16, PAYLOAD_BYTES // 16   # 12 MiB f32, 4 MiB int32
    big = {"w": ((P, W), f32), "b": ((P, B), i32)}
    small = {"w": ((P, W // 16), f32), "b": ((P, B // 16), i32)}

    # comm_broadcast: {"w": 12 MiB f32, "b": 4 MiB int32} a rank
    fresh()
    plan, build_s = build("broadcast", meta(big), root=BCAST_ROOT)
    n, R = plan.n_blocks, plan.rounds
    (wfull, w), (bfull, b) = blocked(n, W, f32, True), blocked(n, B, i32, False)
    x = {"w": w, "b": b}
    out, got = counted_run(torch, kmods, lambda: plan(x))
    check(got == comm_launches(plan, 2), f"comm broadcast launches {got}")
    counts["comm_broadcast"] = got
    check(all(every_row(out[k], x[k][BCAST_ROOT]) for k in x),
          "comm broadcast: a rank does not hold the root's slices")
    hp = host_plan("broadcast", P, n, root=BCAST_ROOT)
    for k, full in (("w", wfull), ("b", bfull)):
        ref_out = hp.run(full[BCAST_ROOT].view(n, -1)).reshape(P, -1)[:, :x[k].shape[1]]
        check(same_bits(torch, out[k], ref_out),
              f"comm broadcast leaf {k} != host_plan broadcast")
        del ref_out
    plan_ov = comm.plan("broadcast", x, root=BCAST_ROOT, overlap=True)
    out_ov, got_ov = counted_run(torch, kmods, lambda: plan_ov(x))
    check(got_ov == comm_launches(plan_ov, 2), f"comm broadcast overlap {got_ov}")
    counts["comm_broadcast_overlap"] = got_ov
    check(same_tree(out_ov, out), "comm overlapped broadcast != sequential")
    del out, out_ov
    small_b = small_vs_plain("broadcast", small, root=BCAST_ROOT)
    fresh()
    t = timed(plan, x)
    t_ov = timed(plan_ov, x)["ms"]
    st_ov = overlap_streams(torch, "comm_broadcast overlap", lambda: plan_ov(x))
    recv_h, send_h = plan.statics[0].slots
    by = {k: bcast_bytes(P, n, R, -(-v.shape[1] // n) * v.element_size(),
                         recv_h, send_h, upload_rows=2)[0] for k, v in x.items()}
    bound = sum(sum(v.values()) for v in by.values())
    del x, w, b, wfull, bfull
    torch.cuda.empty_cache()
    # broadcast_state: one Qwen2-0.5B layer's q/k/v (bf16 weights, f32
    # biases) and an int32 step counter; one message a dtype a round
    state = {name: {"weight": torch.randn((P,) + sh["weight"], generator=g,
                                          device="cuda").to(bf16),
                    "bias": torch.randn((P,) + sh["bias"], generator=g, device="cuda")}
             for name, sh in QKV_SHAPES.items()}
    state["step"] = torch.randint(0, 10 ** 6, (P,), generator=g, device="cuda",
                                  dtype=i32)
    st, got_st = counted_run(torch, kmods,
                             lambda: broadcast_state(group, state, root=BCAST_ROOT))
    leaves = tree_flatten(state)[0]
    check(all(every_row(o.reshape(P, -1), v[BCAST_ROOT].reshape(1, -1))
              for o, v in zip(tree_flatten(st)[0], leaves)),
          "broadcast_state: a rank does not hold the root's state")
    check(same_tree(st, broadcast_state(group, state, root=BCAST_ROOT, backend="torch")),
          "broadcast_state: cuda backend != torch backend")
    packed = {}
    for v in leaves:
        packed[v.dtype] = packed.get(v.dtype, 0) + v[0].numel()
    st_plan = get_comm(group, model=DCN_MODEL).plan(
        "broadcast", {str(dt).removeprefix("torch."): torch.empty(
            (P, e), dtype=dt, device="meta") for dt, e in packed.items()},
        root=BCAST_ROOT)                 # the plan broadcast_state ran: a cache hit
    check(got_st == comm_launches(st_plan, 3), f"broadcast_state launches {got_st}")
    counts["comm_broadcast_state"] = got_st
    st_ms, _ = median_ms(torch, lambda: broadcast_state(group, state, root=BCAST_ROOT), 5)
    del st, state, leaves
    emit({"phase": "comm_broadcast", "p": P, "n": n, "rounds": R, "root": BCAST_ROOT,
          "leaves": {k: [list(sh), str(dt).removeprefix("torch.")]
                     for k, (sh, dt) in big.items()},
          "bytes_per_rank": PAYLOAD_BYTES, "plan_build_s": build_s,
          "launches": got, "every_rank_holds_root_slices": True,
          "leaves_equal_to_host_plan": True, "equal_to_torch_backend_at_1MiB": small_b,
          "overlap_equal_to_sequential": True, "overlap_launches": got_ov,
          **t, "overlap_ms": t_ov, "overlap_streams": st_ov, "flat_ms": flat["broadcast"],
          "bytes_moved": bound, "bytes_bound_ms": ms_of_bytes(bound),
          "broadcast_state": {"n": st_plan.n_blocks, "rounds": st_plan.rounds,
                              "messages_a_round": 3, "launches": got_st,
                              "equal_to_torch_backend": True, "ms": st_ms},
          "card": card})

    # comm_reduce (f32 sum of normal values and a wrapping int32 sum in
    # one pytree, then both as max) and comm_allreduce
    fresh()
    plan, build_s = build("reduce", meta(big), root=BCAST_ROOT)
    n, R = plan.n_blocks, plan.rounds
    (wfull, w), (bfull, b) = blocked(n, W, f32, True), blocked(n, B, i32, False)
    x = {"w": w, "b": b}
    out, got = counted_run(torch, kmods, lambda: plan(x))
    check(got == comm_launches(plan, 2), f"comm reduce launches {got}")
    counts["comm_reduce"] = got
    check(torch.equal(out["b"][BCAST_ROOT], b.sum(0, dtype=i32)),
          "comm reduce: int32 root != values.sum over ranks (wrapping)")
    check(all(all_equal_to(torch, out[k][:BCAST_ROOT], 0)
              and all_equal_to(torch, out[k][BCAST_ROOT + 1:], 0) for k in x),
          "comm reduce: a rank but the root does not hold zeros")
    roots = {k: out[k][BCAST_ROOT].clone() for k in x}
    del out
    torch.cuda.empty_cache()
    hp = host_plan("reduce", P, n, root=BCAST_ROOT)
    for k, full in (("w", wfull), ("b", bfull)):
        hrow = hp.run(full.view(P, n, -1))[BCAST_ROOT].reshape(-1)[:x[k].shape[1]]
        check(same_bits(torch, roots[k][None], hrow[None]),
              f"comm reduce leaf {k} != host_plan reduce")
        del hrow
        torch.cuda.empty_cache()
    plan_ov = comm.plan("reduce", x, root=BCAST_ROOT, overlap=True)
    out, got_ov = counted_run(torch, kmods, lambda: plan_ov(x))
    check(got_ov == comm_launches(plan_ov, 2), f"comm reduce overlap {got_ov}")
    counts["comm_reduce_overlap"] = got_ov
    check(all(same_bits(torch, out[k][BCAST_ROOT][None], roots[k][None])
              and all_equal_to(torch, out[k][:BCAST_ROOT], 0)
              and all_equal_to(torch, out[k][BCAST_ROOT + 1:], 0) for k in x),
          "comm overlapped reduce != sequential")
    del out
    plan_max = comm.plan("reduce", x, root=BCAST_ROOT, op="max")
    out, got_max = counted_run(torch, kmods, lambda: plan_max(x))
    check(got_max == got, f"comm reduce max launches {got_max}")
    check(all(torch.equal(out[k][BCAST_ROOT], x[k].amax(0)) for k in x),
          "comm reduce max: root != values.amax over ranks")
    del out
    torch.cuda.empty_cache()
    small_r = {op: small_vs_plain("reduce", small, root=BCAST_ROOT, op=op)
               for op in ("sum", "max")}
    fresh()
    t = timed(plan, x)
    t_ov = timed(plan_ov, x)["ms"]
    st_ov = overlap_streams(torch, "comm_reduce overlap", lambda: plan_ov(x))
    fwd_h, acc_h = plan.statics[0].slots
    rows = {k: -(-v.shape[1] // n) * v.element_size() for k, v in x.items()}
    bound = sum(sum(reduce_bytes(P, n, R, rows[k], fwd_h, acc_h)[0].values())
                + (P - 1) * v.shape[1] * v.element_size() for k, v in x.items())
    # allreduce: 2 x R rounds, every rank the sum
    fresh()
    plan_a, build_a = build("allreduce", x, root=BCAST_ROOT)
    out, got_a = counted_run(torch, kmods, lambda: plan_a(x))
    check(got_a == comm_launches(plan_a, 2), f"comm allreduce launches {got_a}")
    counts["comm_allreduce"] = got_a
    check(all(every_row(out[k], roots[k][None]) for k in x),
          "comm allreduce: a rank does not hold the reduce's sum")
    del out
    small_a = small_vs_plain("allreduce", small, root=BCAST_ROOT)
    fresh()
    t_a = timed(plan_a, x)
    recv_h, send_h = plan_a.statics[1].slots
    bound_a = sum(sum(reduce_bytes(P, n, R, rows[k], fwd_h, acc_h)[0].values())
                  + sum(bcast_bytes(P, n, R, rows[k], recv_h, send_h,
                                    upload_rows=2)[0].values()) for k in x)
    del x, w, b, wfull, bfull, roots
    torch.cuda.empty_cache()
    emit({"phase": "comm_reduce", "p": P, "n": n, "rounds": R, "root": BCAST_ROOT,
          "ops": ["sum (w f32 normal, b int32 wrapping)", "max"],
          "leaves": {k: [list(sh), str(dt).removeprefix("torch.")]
                     for k, (sh, dt) in big.items()},
          "bytes_per_rank": PAYLOAD_BYTES, "plan_build_s": build_s,
          "launches": got, "int32_root_equals_wrapped_sum": True,
          "non_roots_hold_zeros": True, "leaves_equal_to_host_plan": True,
          "max_root_equals_amax": True, "equal_to_torch_backend_at_1MiB": small_r,
          "overlap_equal_to_sequential": True, "overlap_launches": got_ov,
          **t, "overlap_ms": t_ov, "overlap_streams": st_ov, "flat_ms": flat["reduce"],
          "bytes_moved": bound, "bytes_bound_ms": ms_of_bytes(bound), "card": card})
    emit({"phase": "comm_allreduce", "p": P, "n": n, "rounds": plan_a.rounds,
          "root": BCAST_ROOT, "op": "sum",
          "leaves": {k: [list(sh), str(dt).removeprefix("torch.")]
                     for k, (sh, dt) in big.items()}, "plan_build_s": build_a,
          "launches": got_a, "every_rank_holds_the_sum": True,
          "equal_to_torch_backend_at_1MiB": small_a, **t_a,
          "flat_ms": flat["allreduce"], "bytes_moved": bound_a,
          "bytes_bound_ms": ms_of_bytes(bound_a), "card": card})

    # comm_allgather: {"a": 8 KiB f32} a rank, [1152^2, 44, 48] rows
    fresh()
    E = GATHER_BYTES // 4
    plan, build_s = build("allgather", meta({"a": ((P, E), f32)}))
    n, R = plan.n_blocks, plan.rounds
    full, a = blocked(n, E, f32, True)
    x = {"a": a}
    out, got = counted_run(torch, kmods, lambda: plan(x))
    check(got == comm_launches(plan, 1), f"comm allgather launches {got}")
    counts["comm_allgather"] = got
    check(torch.equal(out["a"], a), "comm allgather: the result is not every rank's slice")
    # every rank's copy, not only the first: exact, and against the host
    # plan's rows of that rank
    copies = plan.per_rank(x)["a"]                     # [P, P, E]
    hp = host_plan("allgather", P, n)
    hv = hp.run(full.view(P, n, -1))                   # [P, P, n, bs]
    check(same_bits(torch, copies, a.expand(P, -1, -1)),
          "comm allgather: a rank's copy is not every rank's slice")
    check(all(same_bits(torch, copies[i:i + 64],
                        hv[i:i + 64].reshape(-1, P, hv.shape[2] * hv.shape[3])[:, :, :E])
              for i in range(0, P, 64)),
          "comm allgather: a rank's copy != host_plan allgather's rows of it")
    del copies, hv
    check(same_tree(out, plain.plan("allgather", x)(x)),
          "comm allgather: cuda backend != torch backend")
    plan_ov = comm.plan("allgather", x, overlap=True)
    out_ov, got_ov = counted_run(torch, kmods, lambda: plan_ov(x))
    check(got_ov == comm_launches(plan_ov, 1), f"comm allgather overlap {got_ov}")
    counts["comm_allgather_overlap"] = got_ov
    check(same_tree(out_ov, out), "comm overlapped allgather != sequential")
    del out, out_ov
    fresh()
    t = timed(plan, x)
    t_ov = timed(plan_ov, x)["ms"]
    st_ov = overlap_streams(torch, "comm_allgather overlap", lambda: plan_ov(x))
    bs = -(-E // n)
    by, _ = allgather_bytes(P, n, R, bs * 4, *hp.device_slots)
    bound = sum(by.values()) + 2 * P * E * 4     # + rank 0's rows out
    emit({"phase": "comm_allgather", "p": P, "n": n, "rounds": R,
          "leaves": {"a": [[P, E], "float32"]}, "bytes_per_rank": GATHER_BYTES,
          "buffer_shape": [P * P, n + 1, bs], "plan_build_s": build_s,
          "launches": got, "result_equals_every_slice": True,
          "every_rank_copy_exact": True, "every_rank_copy_equal_to_host_plan": True,
          "equal_to_host_plan": True, "equal_to_torch_backend": True,
          "overlap_equal_to_sequential": True, "overlap_launches": got_ov,
          **t, "overlap_ms": t_ov, "overlap_streams": st_ov, "flat_ms": flat["allgather"],
          "bytes_moved": bound, "bytes_bound_ms": ms_of_bytes(bound), "card": card})
    del x, a, full
    torch.cuda.empty_cache()

    # comm_reduce_scatter: [1152, 1152 x 2048] f32 integer values
    # (exact sums), a [1152^2, n+1, bs] f32 buffer
    fresh()
    L = P * E
    plan, build_s = build("reduce_scatter", meta({"m": ((P, L), f32)}))
    n, R = plan.n_blocks, plan.rounds
    m = torch.randint(-8, 9, (P, L), generator=g, device="cuda", dtype=f32)
    x = {"m": m}
    out, got = counted_run(torch, kmods, lambda: plan(x))
    check(got == comm_launches(plan, 1), f"comm reduce_scatter launches {got}")
    counts["comm_reduce_scatter"] = got
    exact = torch.zeros((L,), device="cuda")
    for i in range(0, P, 64):
        exact += m[i:i + 64].sum(0)
    check(torch.equal(out["m"], exact.view(P, E)),
          "comm reduce_scatter: row r != the sum of every rank's shard r")
    keep = out["m"].clone()
    del out, exact
    torch.cuda.empty_cache()
    check(same_bits(torch, plain.plan("reduce_scatter", x)(x)["m"], keep),
          "comm reduce_scatter: cuda backend != torch backend")
    torch.cuda.empty_cache()
    plan_ov = comm.plan("reduce_scatter", x, overlap=True)
    out, got_ov = counted_run(torch, kmods, lambda: plan_ov(x))
    check(got_ov == comm_launches(plan_ov, 1), f"comm reduce_scatter overlap {got_ov}")
    counts["comm_reduce_scatter_overlap"] = got_ov
    check(same_bits(torch, out["m"], keep), "comm overlapped reduce_scatter != sequential")
    del out
    fresh()
    t = timed(plan, x)
    t_ov = timed(plan_ov, x)["ms"]
    st_ov = overlap_streams(torch, "comm_reduce_scatter overlap", lambda: plan_ov(x))
    bundle = get_bundle(P, 0)
    fwd, acc, _ = scatter_slot_plan(bundle, n)
    everyone = range(P)
    fwd_rows = _rotated_rows(_with_garbage(fwd, n), P, everyone, everyone, None, "cuda")
    acc_rows = _rotated_rows(acc, P, everyone, everyone, None, "cuda")
    bs = -(-E // n)
    by, rs_coincide = scatter_bytes(P, n, R, bs * 4, fwd_rows, acc_rows,
                                    P * L * 4, P * E * 4)
    bound = sum(by.values())
    del x, m, keep
    torch.cuda.empty_cache()
    # the two kernels alone at these 192-byte rows, over the plan's own rows
    acc_recs = acc_kernels_at(torch, bp, ref, g, fwd_rows, acc_rows, n + 1, bs)
    for name, path in (("block_acc_shuffle", "comm_reduce_scatter"),
                       ("block_acc_shuffle_staged", "comm_reduce_scatter_overlap")):
        acc_recs[name].update(kernel=name, path=path, rows=P * P, row_bytes=bs * 4)
    del fwd_rows, acc_rows
    torch.cuda.empty_cache()
    emit({"phase": "comm_reduce_scatter", "p": P, "n": n, "rounds": R,
          "leaves": {"m": [[P, L], "float32"]}, "input_bytes": P * L * 4,
          "buffer_shape": [P * P, n + 1, bs], "plan_build_s": build_s,
          "launches": got, "rows_equal_exact_sums": True,
          "equal_to_torch_backend": True, "overlap_equal_to_sequential": True,
          "overlap_launches": got_ov, **t, "overlap_ms": t_ov, "overlap_streams": st_ov,
          "flat_ms": None, "allgather_flat_ms": flat["allgather"],
          "bytes_moved": bound, "bytes_by_step": by,
          "acc_rows_acc_eq_fwd": rs_coincide,
          "bytes_bound_ms": ms_of_bytes(bound),
          "kernels_at_these_rows": acc_recs, "card": card})

    # comm_allgatherv: int32 capacity 2048, sizes in [64, 2048]
    fresh()
    rng = np.random.default_rng(SEED)
    sizes = [int(s) for s in rng.integers(64, E + 1, size=P)]
    v = torch.randint(-2 ** 31, 2 ** 31, (P, E), generator=g, device="cuda", dtype=i32)
    x = {"v": v}
    plan, build_s = build("allgatherv", x, sizes=sizes)
    n, R = plan.n_blocks, plan.rounds
    by_bs = {}
    for j, s_ in enumerate(sizes):
        by_bs.setdefault(max(1, -(-s_ // n)), []).append(j)
    out, got = counted_run(torch, kmods, lambda: plan(x))
    check(got == comm_launches(plan, len(by_bs)), f"comm allgatherv launches {got}")
    counts["comm_allgatherv"] = got
    want = v.clone()
    want[torch.arange(E, device="cuda")[None, :]
         >= torch.tensor(sizes, device="cuda")[:, None]] = 0
    check(torch.equal(out["v"], want),
          "comm allgatherv: row j is not rank j's first sizes[j] elements")
    copies = plan.per_rank(x)["v"]                     # every rank's copy
    check(same_bits(torch, copies, want.expand(P, -1, -1)),
          "comm allgatherv: a rank's copy is not every rank's rows")
    del copies
    check(same_tree(out, plain.plan("allgatherv", x, sizes=sizes)(x)),
          "comm allgatherv: cuda backend != torch backend")
    del out, want
    fresh()
    t = timed(plan, x)
    recv, _, ks = broadcast_slot_plan(get_bundle(P, 0), n)
    shifts = [int(get_bundle(P, 0).skip[int(k)]) for k in ks]
    groups = [(bs_, roots, _rotated_rows(recv, P, everyone, roots, None, "cuda"),
               _rotated_rows(recv, P, everyone, roots, shifts, "cuda"))
              for bs_, roots in sorted(by_bs.items())]
    by = gatherv_bytes(P, n, R, groups, E, 4)
    bound = sum(by.values())
    del groups, x, v
    torch.cuda.empty_cache()
    emit({"phase": "comm_allgatherv", "p": P, "n": n, "rounds": R,
          "leaves": {"v": [[P, E], "int32"]}, "capacity": E, "sizes_min_max_sum": [min(sizes), max(sizes), sum(sizes)],
          "block_sizes": len(by_bs), "plan_build_s": build_s,
          "launches": got, "launches_total": sum(got.values()),
          "rows_equal_their_sizes": True, "every_rank_copy_exact": True,
          "equal_to_torch_backend": True,
          **t, "flat_ms": None, "allgather_flat_ms": flat["allgather"],
          "bytes_moved": bound, "bytes_by_step": by,
          "bytes_bound_ms": ms_of_bytes(bound), "card": card})
    return counts, acc_recs


def comm_quantized_phase(torch, np, card, kmods, g, host) -> dict:
    """The communicator's quantized_allreduce over StackedGroup(1152), root
    100, of the 4 MiB bucket as a one-leaf payload and of the same q/k/v
    weights and biases as a 6-leaf pytree, two error-feedback steps each.
    The one-leaf sums and errors must equal the host plan's (``host``:
    this run's plan, its inputs maker, time and bound) bit for bit; both
    payloads: every rank's sums the same, "cuda" equal to "torch" (NaN by
    position), sums plus errors the exact sum within the reference test's
    tolerance, the launches of the rounds.  Returns {payload: launches}."""
    from repro_torch.core.comm import StackedGroup, get_comm
    from repro_torch.optim.compression import tree_flatten, tree_unflatten

    group = StackedGroup(P)
    comm, plain = get_comm(group), get_comm(group, backend="torch")
    n, bs, elems = host["n"], host["bs"], host["elems"]
    lines, out_launches = {}, {}

    def payloads():
        """Each rank's q/k/v gradients: the bucket as one [P, 1033344]
        leaf, the host plan's padded [P, n, bs] blocks, and the tree."""
        vals, _ = host["make"]()
        leaves, treedef = tree_flatten({k: {n_: torch.empty(sh, device="meta")
                                            for n_, sh in d.items()}
                                        for k, d in QKV_SHAPES.items()})
        flat = vals.view(P, -1)[:, :elems]
        parts, off = [], 0
        for x in leaves:
            size = math.prod(x.shape)
            parts.append(flat[:, off:off + size].reshape((P,) + tuple(x.shape)))
            off += size
        return vals, tree_unflatten(treedef, parts)

    vals, tree = payloads()
    for name in ("one_leaf", "pytree"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if name == "one_leaf":
            x = [vals.view(P, -1)[:, :elems].contiguous()]
        else:
            x = {k: {n_: v.contiguous() for n_, v in d.items()} for k, d in tree.items()}
        L = len(tree_flatten(x)[0])
        plan = comm.plan("quantized_allreduce", x, root=BCAST_ROOT, qblock=QBLOCK)
        pplan = plain.plan("quantized_allreduce", x, root=BCAST_ROOT, qblock=QBLOCK)
        expect = quantized_launches(plan, L)
        steps, hvals = [], vals
        for step_no in (1, 2):
            (sums, errs), got = counted_run(torch, kmods, lambda: plan(x))
            check(got == expect, f"comm quantized {name} step {step_no} launches "
                                 f"{got} != {expect}")
            out_launches[name] = got
            s_l, e_l = tree_flatten(sums)[0], tree_flatten(errs)[0]
            x_l = tree_flatten(x)[0]
            resid_max, same_rows = 0.0, True
            for xs, ss_, es in zip(x_l, s_l, e_l):
                check(bool(torch.isfinite(ss_).all()) and bool(torch.isfinite(es).all()),
                      f"comm quantized {name}: non-finite sums or errors")
                xs2, ss2, es2 = xs.reshape(P, -1), ss_.reshape(P, -1), es.reshape(P, -1)
                same_rows = same_rows and all(
                    same_bits(torch, ss2[i:i + 64], ss2[0].expand(min(64, P - i), -1))
                    for i in range(0, P, 64))
                resid, within = completeness(torch, xs2, ss2[0], es2, P)
                check(within, f"comm quantized {name} step {step_no}: sums + errors "
                              f"miss the exact sum by {resid}")
                resid_max = max(resid_max, resid)
            check(same_rows, f"comm quantized {name} step {step_no}: ranks differ")
            if name == "one_leaf":
                hout, herr = host["plan"].run(hvals)
                check(same_bits(torch, hout.reshape(P, -1)[:, :elems], s_l[0])
                      and same_bits(torch, herr.reshape(P, -1)[:, :elems], e_l[0]),
                      f"comm quantized one leaf step {step_no} != host plan")
                del hout, herr
            psums, perrs = pplan(x)
            check(all(same_or_nan(torch, a.reshape(P, -1), b.reshape(P, -1))
                      for a, b in zip(s_l + e_l, tree_flatten(psums)[0]
                                      + tree_flatten(perrs)[0])),
                  f"comm quantized {name} step {step_no}: cuda != torch")
            del psums, perrs
            steps.append({"step": step_no, "completeness_max_abs": resid_max})
            if step_no == 1:
                # error feedback: the next gradients plus this step's errors
                vals2, tree2 = payloads()
                if name == "one_leaf":
                    x = [vals2.view(P, -1)[:, :elems] + e_l[0]]
                    hvals = torch.zeros_like(vals2)
                    hvals.view(P, -1)[:, :elems] = x[0]
                else:
                    x = tree_unflatten(tree_flatten(x)[1], [
                        (a + b).contiguous() for a, b in zip(tree_flatten(tree2)[0], e_l)])
                del vals2, tree2, sums, errs, s_l, e_l
                torch.cuda.empty_cache()
        del sums, errs
        torch.cuda.empty_cache()
        ms, runs = median_ms(torch, lambda: plan(x), 5)
        peak = torch.cuda.max_memory_allocated()
        host_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan(x)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        plain_ms, plain_runs = median_ms(torch, lambda: pplan(x), 3)
        R = len(plan.statics[0].ks)
        slots = plan.statics[0].slots + plan.statics[1].slots
        by = {}
        for leaf in tree_flatten(x)[0]:
            size = math.prod(leaf.shape[1:])
            lbs = -(-(-(-size // plan.n_blocks)) // QBLOCK) * QBLOCK
            b, _ = quantized_bytes(P, plan.n_blocks, R, lbs, lbs // QBLOCK, slots, size)
            for k, v in b.items():
                by[k] = by.get(k, 0) + v
        lines[name] = {"leaves": L, "n": plan.n_blocks, "rounds": plan.rounds,
                       "launches": expect, "steps": steps,
                       "every_rank_identical": True, "equal_to_torch_backend": True,
                       "sums_plus_errors_complete": True,
                       **({"equal_to_host_plan": True} if name == "one_leaf" else {}),
                       "ms": ms, "ms_runs": runs, "plain_ms": plain_ms,
                       "plain_ms_runs": plain_runs, "host_call_ms": sorted(host_ms)[2],
                       "bytes_moved": sum(by.values()), "bytes_by_step": by,
                       "bytes_bound_ms": ms_of_bytes(sum(by.values())),
                       "max_memory_allocated": peak}
        del x, plan, pplan
    del vals, tree
    torch.cuda.empty_cache()
    emit({"phase": "comm_quantized_allreduce", "p": P, "root": BCAST_ROOT,
          "qblock": QBLOCK, "bucket_elems": elems, **lines,
          "host_plan_ms": host["ms"], "host_plan_bytes_bound_ms": host["bound_ms"],
          "card": card})
    return {f"comm_quantized_allreduce/{k}": v for k, v in out_launches.items()}


def train_phases(torch, np, card, kmods, g) -> dict:
    """Qwen2-0.5B at its published width (24 layers, d_model 896, vocab
    151,936; 494,032,768 parameters, random bf16 weights from the seed):
    compressed_grad_sync of its full gradient at p = 4 stacked ranks, then
    the trainer's steps.  Returns {path: launches} for the kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.core.collectives import circulant_qallreduce
    from repro_torch.core.comm import StackedGroup, get_comm
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.models.convert import stack_layers
    from repro_torch.optim import compression as comp
    from repro_torch.train import (
        TrainConfig,
        grad_bucket_spec,
        init_train_state,
        make_eval_step,
        make_train_step,
    )
    from repro_torch.train import trainer as trainer_mod

    cfg = get_config(TRAIN_ARCH)
    group = StackedGroup(TRAIN_P)
    spec = grad_bucket_spec(cfg, TrainConfig())
    check((spec.num_buckets, len(spec.leaf_sizes), sum(spec.leaf_sizes))
          == (10, 14, 494_032_768), f"qwen2-0.5b buckets {spec.num_buckets}")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    tree0 = stack_layers(model, cfg)
    del model
    leaves0, treedef = tree_flatten(tree0)
    launches = {}

    # --- compressed_grad_sync of the full gradient, two feedback steps
    def grads():
        return tree_unflatten(treedef, [
            (torch.randn((TRAIN_P,) + tuple(x.shape), generator=g, device="cuda")
             * 1e-3).to(x.dtype) for x in leaves0])

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    errs = comp.init_grad_sync_state(spec, TRAIN_P)
    plan = None
    steps = []
    for step_no in (1, 2):
        gr = grads()
        (mean, new), got = counted_run(torch, kmods, lambda: comp.compressed_grad_sync(
            gr, errs, group, spec))
        if plan is None:
            plan = get_comm(group).plan("quantized_allreduce", [
                torch.empty((TRAIN_P, s), device="meta") for s in spec.bucket_sizes])
            expect = quantized_launches(plan, spec.num_buckets)
        check(got == expect, f"compressed_grad_sync launches {got} != {expect}")
        launches["compressed_grad_sync"] = got
        m_l = tree_flatten(mean)[0]
        check(all(bool(torch.isfinite(m.float()).all()) for m in m_l)
              and all(bool(torch.isfinite(e).all()) for e in new),
              f"compressed_grad_sync step {step_no}: non-finite mean or errors")
        check(all(same_bits(torch, m[r], m[0]) for m in m_l for r in range(1, TRAIN_P)),
              f"compressed_grad_sync step {step_no}: ranks differ")
        # completeness, a bucket at a time: sum_r (g + e) == p * mean + sum_r new
        targets = comp._bucket_rows(tree_flatten(gr)[0], spec)
        means = comp._bucket_rows([m[:1] for m in m_l], spec)
        worst = 0.0
        for b, (t, e_in, mb, e_out) in enumerate(zip(targets, errs, means, new)):
            resid, within = completeness(torch, t + e_in, mb[0] * TRAIN_P, e_out,
                                         TRAIN_P, chunk=1 << 22)
            check(within, f"compressed_grad_sync step {step_no} bucket {b}: "
                          f"mean + errors miss the exact sum by {resid}")
            worst = max(worst, resid)
        del targets, means
        torch.cuda.empty_cache()
        pmean, pnew = comp.compressed_grad_sync(gr, errs, group, spec, backend="torch")
        check(all(same_or_nan(torch, a, b) for a, b in
                  zip(m_l + list(new), tree_flatten(pmean)[0] + list(pnew))),
              f"compressed_grad_sync step {step_no}: cuda != torch")
        del pmean, pnew, m_l, mean
        steps.append({"step": step_no, "launches": got, "completeness_max_abs": worst})
        errs = new
        del new
        torch.cuda.empty_cache()
    sync_ms, sync_runs = median_ms(torch, lambda: comp.compressed_grad_sync(
        gr, errs, group, spec), 3)
    # one call alone: its peak above what the caller holds, and the
    # allreduce of the ten buckets alone (the rest is bucketing and the
    # downcast of the mean)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    comp.compressed_grad_sync(gr, errs, group, spec)
    torch.cuda.synchronize()
    sync_peak = torch.cuda.max_memory_allocated() - held
    targets = [t + e for t, e in zip(comp._bucket_rows(tree_flatten(gr)[0], spec), errs)]
    ar_ms, ar_runs = median_ms(torch, lambda: circulant_qallreduce(group, targets), 3)
    del targets
    R = len(plan.statics[0].ks)
    slots = plan.statics[0].slots + plan.statics[1].slots
    by = {"bucketize": 0}
    for size in spec.bucket_sizes:
        bs = -(-(-(-size // plan.n_blocks)) // QBLOCK) * QBLOCK
        b, _ = quantized_bytes(TRAIN_P, plan.n_blocks, R, bs, bs // QBLOCK, slots, size)
        for k, v in b.items():
            by[k] = by.get(k, 0) + v
    for x, size in zip(leaves0, spec.leaf_sizes):
        # read the gradient, write the f32 target after reading the error;
        # then read the sum, write the mean, read and write the error
        by["bucketize"] += TRAIN_P * size * (x.element_size() + 4 + 4
                                             + 4 + x.element_size() + 8)
    del gr, errs
    torch.cuda.empty_cache()
    ar_bytes = sum(v for k, v in by.items() if k != "bucketize")
    emit({"phase": "compressed_grad_sync", "arch": TRAIN_ARCH, "p": TRAIN_P,
          "buckets": spec.num_buckets, "leaves": len(spec.leaf_sizes),
          "elems_per_rank": sum(spec.leaf_sizes), "n": plan.n_blocks,
          "rounds": plan.rounds, "launches": expect, "steps": steps,
          "every_rank_identical": True, "equal_to_torch_backend": True,
          "sums_plus_errors_complete": True, "ms": sync_ms, "ms_runs": sync_runs,
          "allreduce_ms": ar_ms, "allreduce_ms_runs": ar_runs,
          "allreduce_bytes_bound_ms": ms_of_bytes(ar_bytes),
          "bytes_moved": sum(by.values()), "bytes_by_step": by,
          "bytes_bound_ms": ms_of_bytes(sum(by.values())),
          "peak_above_held_bytes": sync_peak,
          "max_memory_allocated": sync_peak + held, "card": card})

    # --- the trainer: compressed against auto from the same weights
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B, seed=SEED))
    batches = [data.batch_at(i) for i in range(TRAIN_STEPS)]
    tokens = TRAIN_B * TRAIN_S
    evaluate = make_eval_step(cfg)
    sync_times, update_times = [], []
    real_sync, real_update = trainer_mod.compressed_grad_sync, trainer_mod.apply_updates

    def timer(fn, times):
        """``fn`` timed on the host clock, the card synchronised around it."""
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    def run(tcfg, n_steps, eval_after_first=False, keep=False):
        """``n_steps`` steps of ``tcfg`` from the initial state -> (their
        records, the eval loss after the first, and with ``keep`` the
        final state's leaves on the host)."""
        state = init_train_state(cfg, tcfg, params=tree0, group=group)
        step = make_train_step(cfg, tcfg, group=group)
        recs, evals = [], None
        if tcfg.grad_sync == "auto":
            MEASURED["train_auto"] = {"state_bytes": sum(
                x.numel() * x.element_size() for x in tree_flatten(state)[0])}
        for i in range(n_steps):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            sync_times.clear()
            update_times.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (state, m), got = counted_run(torch, kmods, lambda: step(state, batches[i]))
            ms = (time.perf_counter() - t0) * 1e3
            rec = {"step": i + 1, "ms": ms, "tokens_per_s": tokens / (ms / 1e3),
                   "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "launches": got}
            if sync_times:
                rec.update(sync_ms=sum(sync_times), sync_share=sum(sync_times) / ms)
            rec.update(update_ms=sum(update_times),
                       grads_ms=ms - sum(sync_times) - sum(update_times))
            recs.append(rec)
            if eval_after_first and i == 0:
                evals = float(evaluate(state["params"], batches[1]))
        kept = [x.cpu() for x in tree_flatten(state)[0]] if keep else None
        del state
        torch.cuda.empty_cache()
        return (recs, evals, kept) if keep else (recs, evals)

    def streamed_again(tcfg):
        """The first step of ``tcfg`` again from the initial state, under
        ``torch.profiler`` and ``set_sync_debug_mode("warn")`` -> (its
        record, the state's leaves on the host, its kernels)."""
        state = init_train_state(cfg, tcfg, params=tree0, group=group)
        step = make_train_step(cfg, tcfg, group=group)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ((state, m), kern), syncs = host_syncs(torch, lambda: traced_kernels(
            torch, lambda: step(state, batches[0])))
        ms = (time.perf_counter() - t0) * 1e3
        in_sync = [at for at in syncs if at.split(":")[0] in SYNC_FILES]
        check(not in_sync, f"train streamed: host syncs in the sync: {in_sync}")
        rec = {"ms_traced": ms, "loss": float(m["loss"]), "host_syncs_in_the_sync": in_sync,
               "host_syncs_elsewhere": [at for at in syncs if at not in in_sync]}
        got = [x.cpu() for x in tree_flatten(state)[0]]
        del state, step, m
        torch.cuda.empty_cache()
        return rec, got, kern

    trainer_mod.compressed_grad_sync = timer(real_sync, sync_times)
    trainer_mod.apply_updates = timer(real_update, update_times)
    try:
        comp_cfg = TrainConfig(grad_sync="compressed", microbatches=2, remat="full")
        comp_steps, comp_eval = run(comp_cfg, TRAIN_STEPS, eval_after_first=True)
        stream_cfg = replace(comp_cfg, stream_grad_sync=True)
        stream_steps, stream_eval, leaves = run(stream_cfg, 1, eval_after_first=True,
                                                keep=True)
        # again from the same state, traced: bit-equal to the first
        repeat, got, kern = streamed_again(stream_cfg)
        check(all(torch.equal(bits(torch, a), bits(torch, b)) for a, b in zip(leaves, got)),
              "train: two streamed steps from one state differ")
        repeat["streams"] = sync_streams(kern)
        del leaves, got, kern
        auto_steps, auto_eval = run(TrainConfig(grad_sync="auto", microbatches=2,
                                                remat="full"), TRAIN_STEPS,
                                    eval_after_first=True)
    finally:
        trainer_mod.compressed_grad_sync = real_sync
        trainer_mod.apply_updates = real_update
    del tree0, leaves0
    torch.cuda.empty_cache()
    bound = 0.05 * max(1.0, auto_steps[0]["loss"])
    losses = [r["loss"] for r in comp_steps + auto_steps + stream_steps]
    check(all(math.isfinite(x) for x in losses + [comp_eval, auto_eval, stream_eval]),
          f"train: non-finite loss {losses}")
    gap = max(abs(c["loss"] - a["loss"]) for c, a in zip(comp_steps, auto_steps))
    check(gap <= bound, f"train: compressed losses {[r['loss'] for r in comp_steps]} "
                        f"leave the auto ones {[r['loss'] for r in auto_steps]} by {gap}")
    check(abs(comp_eval - auto_eval) <= bound,
          f"train: eval after a compressed step {comp_eval}, after auto {auto_eval}")
    stream_gap = max(abs(stream_steps[0]["loss"] - comp_steps[0]["loss"]),
                     abs(stream_eval - comp_eval))
    check(stream_gap <= bound, f"train: the streamed step leaves the post-backward "
                               f"one by {stream_gap}")
    check(repeat["loss"] == stream_steps[0]["loss"],
          "train: the streamed repeat's loss differs from the first streamed step's")
    # streamed: each bucket's marker runs a one-leaf allreduce of its own
    expect_stream = {}
    for size in spec.bucket_sizes:
        b_plan = get_comm(group).plan("quantized_allreduce", [
            torch.empty((TRAIN_P, size), device="meta")])
        for k, v in quantized_launches(b_plan, 1).items():
            expect_stream[k] = expect_stream.get(k, 0) + v
    for rec in comp_steps:
        check(rec["launches"] == expect, f"train step launches {rec['launches']} "
                                         f"!= {expect}")
    check(stream_steps[0]["launches"] == expect_stream,
          f"streamed step launches {stream_steps[0]['launches']} != {expect_stream}")
    for rec in auto_steps:
        check(not rec["launches"], f"auto step launched {rec['launches']}")
    MEASURED["train_auto"].update(
        ms=min(r["ms"] for r in auto_steps),
        max_memory_allocated=max(r["max_memory_allocated"] for r in auto_steps))
    launches["train_step"] = comp_steps[0]["launches"]
    launches["train_step_streamed"] = stream_steps[0]["launches"]
    emit({"phase": "train", "arch": TRAIN_ARCH, "p": TRAIN_P, "global_batch": TRAIN_B,
          "seq": TRAIN_S, "tokens_per_step": tokens, "microbatches": 2, "remat": "full",
          "compressed": comp_steps, "auto": auto_steps, "streamed": stream_steps,
          "eval_after_step_1": {"compressed": comp_eval, "auto": auto_eval,
                                "streamed": stream_eval},
          "max_loss_gap": gap, "streamed_gap": stream_gap, "bound": bound,
          "streamed_repeat": repeat, "streamed_repeat_bit_equal": True,
          "card": card})
    return launches


def launch_train(args):
    """``repro_torch.launch.train.main(args)`` with its printed lines caught
    -> (result, lines)."""
    import io

    from repro_torch.launch import train as launch

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = launch.main(args)
    return res, buf.getvalue().splitlines()


def state_bytes(torch, state) -> int:
    """The bytes of a state as the checkpoint stores it (bf16 as f32)."""
    from repro_torch.core.tree import tree_flatten

    return sum(x.numel() * (4 if x.dtype == torch.bfloat16 else x.element_size())
               for x in tree_flatten(state)[0])


def train_launch_phase(torch, np, card, kmods, step_launches) -> dict:
    """Qwen2-0.5B at full width through ``python -m repro_torch.launch.train``'s
    ``main`` and the reference's flags: run 1 trains 4 compressed steps over
    4 stacked ranks and saves at step 4; run 2 (``--steps 6``) resumes from
    it; a third call restores the checkpoint into a template on the card,
    which must equal run 1's final state bit for bit; an uninterrupted
    6-step run without saves gives the losses run 2's must match.  Each
    run's launches are its steps times a compressed sync's over the mesh's
    dp ranks; at 4x1 that is ``step_launches``, the train phase's step.
    Returns the launches a step of the round-step kernels."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.train import CheckpointManager, TrainConfig, train_state_shape

    cfg = get_config(TRAIN_ARCH)
    work = tempfile.mkdtemp(prefix="train_launch_")
    try:
        mesh, note = LAUNCH_MESH, None
        ckpt_bytes = state_bytes(torch, train_state_shape(
            cfg, TrainConfig(grad_sync="compressed"), dp=int(mesh.split("x")[0])))
        free = shutil.disk_usage(work).free
        if free < 2 * ckpt_bytes:
            mesh = "2x1"
            note = (f"{free} bytes free under {work}, under twice the 4x1 "
                    f"checkpoint's {ckpt_bytes}: run at --mesh 2x1")
            ckpt_bytes = state_bytes(torch, train_state_shape(
                cfg, TrainConfig(grad_sync="compressed"), dp=2))
        dp = int(mesh.split("x")[0])
        per_step = quantized_launches_of(torch, cfg, dp)
        check(dp != TRAIN_P or per_step == step_launches,
              f"train_launch: a step's launches {per_step} != the train phase's "
              f"{step_launches}")
        base = ["--arch", TRAIN_ARCH, "--mesh", mesh, "--grad-sync", "compressed",
                "--global-batch", str(TRAIN_B), "--seq", str(TRAIN_S),
                "--microbatches", "2"]
        ckdir = str(Path(work) / "ckpt")
        runs = {}

        def run(name, argv, steps):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            (res, lines), got = counted_run(torch, kmods, lambda: launch_train(argv))
            expect = {k: v * steps for k, v in per_step.items()}
            check(got == expect, f"train_launch {name}: launches {got} != {expect} "
                                 f"({steps} x a compressed step over {dp} ranks)")
            res["peak"] = torch.cuda.max_memory_allocated()
            res["lines"] = lines
            runs[name] = res
            return res

        first = run("run_1", base + ["--steps", "4", "--ckpt-every", "4",
                                     "--ckpt-dir", ckdir], 4)
        check(first["resumed_from"] is None and "done: 4 steps" in first["lines"][-1],
              f"train_launch run 1: {first['lines']}")
        leaves, treedef = tree_flatten(first.pop("state"))
        final1 = [x.cpu() for x in leaves]          # run 1's final state
        del leaves
        torch.cuda.empty_cache()
        written = (Path(ckdir) / "step_0000000004" / "arrays.npz").stat().st_size
        second = run("run_2", base + ["--steps", "6", "--ckpt-every", "4",
                                      "--ckpt-dir", ckdir], 2)
        check("resumed from step 4" in second["lines"]
              and second["lines"][-1].startswith("done: 2 steps"),
              f"train_launch run 2 did not resume: {second['lines']}")
        second.pop("state")
        torch.cuda.empty_cache()
        straight = run("uninterrupted", base + ["--steps", "6", "--ckpt-every", "1000",
                                                "--ckpt-dir", str(Path(work) / "none")], 6)
        straight.pop("state")
        torch.cuda.empty_cache()

        # the third call: the checkpoint into a template on the card
        template = tree_unflatten(treedef, [torch.empty_like(x, device="cuda")
                                            for x in final1])
        mgr = CheckpointManager(ckdir, keep=2)
        step, restored, extra = mgr.restore_latest(template)
        del template
        check((step, extra) == (4, {"data_step": 4}),
              f"train_launch restore: step {step}, extra {extra}")
        back = tree_flatten(restored)[0]
        check(all(y.is_cuda and y.dtype == x.dtype and y.shape == x.shape
                  and torch.equal(bits(torch, x), bits(torch, y.cpu()))
                  for x, y in zip(final1, back)),
              "train_launch: the restored state is not run 1's final state")
        del restored, back, final1
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    loss0 = straight["losses"][1]
    bound = 1e-3 * max(1.0, loss0)
    gaps = {s: abs(second["losses"][s] - straight["losses"][s]) for s in (5, 6)}
    losses = [v for r in runs.values() for v in r["losses"].values()]
    check(all(math.isfinite(x) for x in losses), f"train_launch: non-finite loss {losses}")
    check(max(gaps.values()) <= bound,
          f"train_launch: resumed losses {second['losses']} leave the uninterrupted "
          f"{straight['losses']} by {gaps}")
    tokens = TRAIN_B * TRAIN_S
    ck = first["checkpoint"]
    out = {"phase": "train_launch", "arch": TRAIN_ARCH, "entry":
           "repro_torch.launch.train.main", "mesh": mesh, "dp": dp,
           "note": note, "global_batch": TRAIN_B, "seq": TRAIN_S, "microbatches":
           first["microbatches"], "remat": "full",
           "printed": {k: r["lines"] for k, r in runs.items()},
           "losses": {k: r["losses"] for k, r in runs.items()},
           "resumed_losses_gap": gaps, "bound": bound,
           "resumed_equal_uninterrupted_bits": all(
               second["losses"][s] == straight["losses"][s] for s in (5, 6)),
           "restored_equal_run_1_final_state": True,
           "ms_per_step": {k: r["ms_per_step"] for k, r in runs.items()},
           "tokens_per_s": {k: tokens / (r["ms_per_step"] / 1e3) for k, r in runs.items()},
           "checkpoint_bytes": ck["save_bytes"], "checkpoint_file_bytes": written,
           "checkpoint_bytes_from_shapes": ckpt_bytes,
           "host_copy_s": ck["save_host_copy_s"], "write_s": ck["save_write_s"],
           "wait_s": ck.get("wait_s"),
           "restore_s": {"run_2": second["checkpoint"]["restore_s"],
                         "into_template": mgr.stats["restore_s"]},
           "bytes_read": second["checkpoint"]["restore_bytes"],
           "launches_per_step": per_step,
           "launches_equal_train_phase": per_step == step_launches,
           "max_memory_allocated": {k: r["peak"] for k, r in runs.items()},
           "card": card}
    emit(out)
    return dict(per_step)


def unmoved(torch, before, after, names) -> list:
    """The names of the leaves whose values did not change."""
    return [n for n, a, b in zip(names, before, after)
            if torch.equal(a, b.to(a.device))]


def memory_batches(torch, cfg, B, S, steps):
    from repro_torch.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=SEED,
                                  memory_tokens=memory_len(cfg), d_model=cfg.d_model))
    return [{k: torch.from_numpy(v).cuda() for k, v in data.batch_at(i).items()}
            for i in range(steps)]


def memory_train_run(torch, kmods, cfg, tcfg, group, params, batches, watch,
                     sync_times):
    """``make_train_step`` over ``batches`` from a copy of ``params`` ->
    (per-step records, the watched leaves that did not move in step 1)."""
    from repro_torch.core.tree import path_key, tree_flatten_with_path
    from repro_torch.train import init_train_state, make_train_step

    state = init_train_state(cfg, tcfg, params=params, group=group)
    step = make_train_step(cfg, tcfg, group=group)
    pairs = [(path_key(p), x) for p, x in tree_flatten_with_path(state["params"])[0]
             if watch(path_key(p))]
    names = [n for n, _ in pairs]
    first = [x.detach().clone() for _, x in pairs]
    recs, still = [], None
    for i, batch in enumerate(batches):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sync_times.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, m), got = counted_run(torch, kmods, lambda: step(state, batch))
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"step": i + 1, "ms": ms, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "launches": got,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if sync_times:
            rec["sync_ms"] = sum(sync_times)
        recs.append(rec)
        if i == 0:
            now = [x for n, x in tree_flatten_with_path(state["params"])[0]
                   if watch(path_key(n))]
            still = unmoved(torch, first, now, names)
            del first, now
    del state
    torch.cuda.empty_cache()
    return recs, still, names


def memory_train_phases(torch, np, card, kmods) -> dict:
    """whisper-small at full width (auto and compressed over
    StackedGroup(TRAIN_P)) and llama-3.2-vision-11b at full width cut to
    one super-block (auto), trained on the card through
    ``make_train_step`` with seeded frontend embeddings; every vlm gate
    0.5.  Returns the round-step launches of a compressed whisper step."""
    from repro_torch.configs import get_config
    from repro_torch.core.comm import StackedGroup
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import TrainConfig
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.models import init_params

    sync_times = []
    real_sync = trainer_mod.compressed_grad_sync

    def timed_sync(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_sync(*a, **kw)
        torch.cuda.synchronize()
        sync_times.append((time.perf_counter() - t0) * 1e3)
        return out

    opt = AdamWConfig(lr=MEM_TRAIN_LR, warmup_steps=1)

    # --- whisper-small: auto and compressed from the same weights
    cfg = get_config(ENC_ARCH)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    batches = memory_batches(torch, cfg, ENC_B, ENC_S, MEM_TRAIN_STEPS)

    def enc_watch(name):
        return name.startswith("enc/") or "/xattn/" in name

    tcfg = TrainConfig(microbatches=2, remat="full", opt=opt)
    trainer_mod.compressed_grad_sync = timed_sync
    try:
        auto, auto_still, watched = memory_train_run(
            torch, kmods, cfg, tcfg, None, params, batches, enc_watch, sync_times)
        comp, comp_still, _ = memory_train_run(
            torch, kmods, cfg, replace(tcfg, grad_sync="compressed"),
            StackedGroup(TRAIN_P), params, batches, enc_watch, sync_times)
    finally:
        trainer_mod.compressed_grad_sync = real_sync
    del params, batches
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in auto + comp]
    check(all(math.isfinite(x) for x in losses), f"train_encdec: non-finite loss {losses}")
    bound = 1e-3 * max(1.0, auto[0]["loss"])
    gap = max(abs(a["loss"] - c["loss"]) for a, c in zip(auto, comp))
    check(gap <= bound, f"train_encdec: compressed {[r['loss'] for r in comp]} leave "
                        f"auto {[r['loss'] for r in auto]} by {gap}")
    check(not auto_still and not comp_still,
          f"train_encdec: leaves that did not move in step 1: {auto_still or comp_still}")
    check(all(not r["launches"] for r in auto), "train_encdec: an auto step launched")
    expect = quantized_launches_of(torch, cfg, TRAIN_P)
    check(all(r["launches"] == expect for r in comp),
          f"train_encdec: compressed launches {[r['launches'] for r in comp]} != {expect}")
    tokens, frames = ENC_B * ENC_S, ENC_B * memory_len(cfg)
    for r in auto + comp:
        r.update(tokens_per_s=tokens / (r["ms"] / 1e3),
                 frames_per_s=frames / (r["ms"] / 1e3))
    emit({"phase": "train_encdec", "arch": ENC_ARCH, "params": sum(
              x.numel() for x in init_params(cfg, device="meta").parameters()),
          "batch": {"utterances": ENC_B, "frames": memory_len(cfg), "tokens": ENC_S},
          "microbatches": 2, "remat": "full", "opt": {"lr": opt.lr, "warmup_steps": 1},
          "p": TRAIN_P, "auto": auto, "compressed": comp, "max_loss_gap": gap,
          "bound": bound, "watched_leaves": len(watched),
          "every_enc_and_cross_attention_leaf_moved": True, "card": card})

    # --- llama-3.2-vision-11b, one super-block at full width, auto
    cfg = replace(get_config(VLM_ARCH), n_layers=VLM_TRAIN_LAYERS)
    params = gated_params(torch, init_params, cfg)
    n_params = sum(x.numel() for x in params.parameters())

    def vlm_watch(name):
        return name == "img_proj" or "/xattn/" in name or name.endswith("/gate")

    S, cut = PREFILL_S, None
    while True:
        batches = memory_batches(torch, cfg, PREFILL_B, S, MEM_TRAIN_STEPS)
        recs, still, watched = memory_train_run(
            torch, kmods, cfg, TrainConfig(microbatches=1, remat="full", opt=opt),
            None, params, batches, vlm_watch, sync_times)
        del batches
        peak = max(r["max_memory_allocated"] for r in recs)
        if peak <= VLM_TRAIN_PEAK or S <= 512:
            break
        cut = f"peak {peak} bytes at {S} tokens a prompt: halved"
        S //= 2
    del params
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in recs]
    check(all(math.isfinite(x) for x in losses), f"train_vlm: non-finite loss {losses}")
    check(not still, f"train_vlm: leaves that did not move in step 1: {still}")
    check(all(not r["launches"] for r in recs), "train_vlm: a step launched a kernel")
    for r in recs:
        r["tokens_per_s"] = PREFILL_B * S / (r["ms"] / 1e3)
    emit({"phase": "train_vlm", "arch": VLM_ARCH, "layers": VLM_TRAIN_LAYERS,
          "cut": f"{VLM_TRAIN_LAYERS} of 40 layers (4 self-attention, 1 gated "
                 f"cross-attention) at full width: 40 layers with AdamW state "
                 f"would not fit", "tokens_cut": cut, "params": n_params,
          "batch": {"prompts": PREFILL_B, "tokens": S, "image_rows": memory_len(cfg)},
          "microbatches": 1, "remat": "full", "opt": {"lr": opt.lr, "warmup_steps": 1},
          "gate": XATTN_GATE, "steps": recs, "watched_leaves": watched,
          "img_proj_and_cross_attention_moved": True, "card": card})
    return dict(expect)


def quantized_launches_of(torch, cfg, p) -> dict:
    """The round-step launches of one compressed_grad_sync of ``cfg``'s
    gradient over StackedGroup(p)."""
    from repro_torch.core.comm import StackedGroup, get_comm
    from repro_torch.train import TrainConfig, grad_bucket_spec

    spec = grad_bucket_spec(cfg, TrainConfig())
    plan = get_comm(StackedGroup(p)).plan("quantized_allreduce", [
        torch.empty((p, s), device="meta") for s in spec.bucket_sizes])
    return quantized_launches(plan, spec.num_buckets)


def model_phases(torch, np, card, kmods, g, launches, kern, ptx) -> None:
    """The model kernels against their plain versions, then zamba2-2.7b's
    prefill and a continuous-batching serve loop at full width, and the
    prefill again in f32.  Fills ``launches`` and ``kern`` for the two
    kernels; ``ptx``: the build's registers and spills by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import layer_pattern

    cfg = get_config(ARCH)
    s = cfg.ssm
    H_ssm = s.expand * cfg.d_model // s.head_dim

    # 10. each model kernel against its plain version
    t0 = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    attn = compare_attention(torch, fa, g, PREFILL_B, PREFILL_S, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd, True, None, bf16, timed=True)
    attn_cases = [dict(attn, case="zamba2-2.7b prefill")]
    attn_cases.append(dict(compare_attention(torch, fa, g, 1, 8192, 32, 8, 80, True,
                                             4096, bf16, timed=True),
                           case="h2o-danube-1.8b window"))
    torch.cuda.empty_cache()
    # the main shapes again in f32, where the limit is 2e-5
    for case, args in (
            ("zamba2-2.7b prefill", (PREFILL_B, PREFILL_S, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.hd, True, None)),
            ("h2o-danube-1.8b window", (1, 8192, 32, 8, 80, True, 4096))):
        attn_cases.append(dict(compare_attention(torch, fa, g, *args, f32,
                                                 timed=False), case=case))
        torch.cuda.empty_cache()
    for dtype in (f32, bf16):
        for causal, window in ((True, None), (False, None), (True, 100)):
            attn_cases.append(dict(compare_attention(
                torch, fa, g, 2, 333, 6, 2, 40, causal, window, dtype, timed=False),
                case="odd"))
    # the memory families' shapes: heads of 128 (vlm) and 64 (whisper),
    # cross-attention with Sq != Skv, and decode's one query row; timed in
    # bf16, the non-causal ones checked again in f32
    for key, (case, path, args, skv) in memory_attn_cases(get_config).items():
        rec = dict(compare_attention(torch, fa, g, *args, bf16, timed=True, Skv=skv),
                   case=case)
        attn_cases.append(rec)
        kern[f"flash_attention@{key}"] = dict(rec, kernel="flash_attention", path=path)
        torch.cuda.empty_cache()
        if not args[5]:
            attn_cases.append(dict(compare_attention(
                torch, fa, g, *args, f32, timed=False, Skv=skv), case=case))
            torch.cuda.empty_cache()
    # deepseek-moe-16b's self-attention: 16 heads of 128, no GQA; timed in
    # bf16, checked again in f32
    moe = get_config(MOE_ARCH)
    moe_args = (PREFILL_B, PREFILL_S, moe.n_heads, moe.n_kv_heads, moe.hd, True, None)
    rec = dict(compare_attention(torch, fa, g, *moe_args, bf16, timed=True),
               case=f"{MOE_ARCH} prefill")
    attn_cases.append(rec)
    kern["flash_attention@moe_self"] = dict(rec, kernel="flash_attention",
                                            path="prefill_moe")
    torch.cuda.empty_cache()
    attn_cases.append(dict(compare_attention(torch, fa, g, *moe_args, f32, timed=False),
                           case=f"{MOE_ARCH} prefill"))
    torch.cuda.empty_cache()
    # deepseek-v3's MLA self-attention: 128 heads, q and k of 192 (128 nope +
    # 64 rope), v of 128: bf16 on the tensor-core instance sized to them,
    # timed beside SDPA and the bound; f32 (the CUDA-core kernel) timed too
    check(MLA_INSTANCE in ptx, f"the build reports no {MLA_INSTANCE}")
    mla = get_config(MLA_ARCH)
    mla_args = (PREFILL_B, PREFILL_S, mla.n_heads, mla.n_kv_heads,
                mla.mla.qk_nope_dim + mla.mla.qk_rope_dim, True, None)
    rec = dict(compare_attention(torch, fa, g, *mla_args, bf16, timed=True,
                                 hd_v=mla.mla.v_head_dim),
               case=f"{MLA_ARCH} prefill", instance=MLA_INSTANCE, **ptx[MLA_INSTANCE])
    attn_cases.append(rec)
    torch.cuda.empty_cache()
    simt = dict(compare_attention(torch, fa, g, *mla_args, f32, timed=True,
                                  hd_v=mla.mla.v_head_dim),
                case=f"{MLA_ARCH} prefill", instance="flash_fwd_simt_kernelIfLi8EE")
    attn_cases.append(simt)
    kern["flash_attention@mla_self"] = dict(
        rec, kernel="flash_attention", path="prefill_mla", f32_simt_ms=simt["ms"],
        f32_plain_ms=simt["plain_ms"], f32_library_ms=simt["library_ms"],
        f32_library_backend=simt["library_backend"])
    torch.cuda.empty_cache()
    # the dense configurations' self-attention at their prefill_zoo shapes,
    # timed in bf16 beside SDPA and the bound, checked again in f32:
    # qwen2-0.5b's GQA of 14 / 2 heads of 64, granite-3-2b's 32 / 8 of 64,
    # h2o-danube-1.8b's 32 / 8 of 80 with its window over B 2 x 8192 (SDPA
    # given the window as a boolean mask) and stablelm-12b's 32 / 8 of 160:
    # bf16 on the tensor-core instance sized to them, f32 on the CUDA-core
    # kernel, both timed
    check(W160_INSTANCE in ptx, f"the build reports no {W160_INSTANCE}")
    for arch, (key, S, expect) in ZOO.items():
        c = get_config(arch)
        if "flash_attention" not in expect:
            continue
        args = (PREFILL_B, S, c.n_heads, c.n_kv_heads, c.hd, True, c.sliding_window)
        wide = c.hd > 128
        rec = dict(compare_attention(torch, fa, g, *args, bf16, timed=True,
                                     masked_library=c.sliding_window is not None),
                   case=f"{arch} prefill",
                   **({"instance": W160_INSTANCE, **ptx[W160_INSTANCE]} if wide else {}))
        attn_cases.append(rec)
        torch.cuda.empty_cache()
        rec32 = dict(compare_attention(torch, fa, g, *args, f32, timed=wide),
                     case=f"{arch} prefill")
        attn_cases.append(rec32)
        torch.cuda.empty_cache()
        kern[f"flash_attention@{key}"] = dict(rec, kernel="flash_attention",
                                              path="prefill_zoo")
        if wide:
            rec32["instance"] = "flash_fwd_simt_kernelIfLi10EE"
            kern[f"flash_attention@{key}"].update(
                f32_simt_ms=rec32["ms"], f32_plain_ms=rec32["plain_ms"],
                f32_library_ms=rec32["library_ms"],
                f32_library_backend=rec32["library_backend"])
    scan = compare_scan(torch, ss, g, PREFILL_B, PREFILL_S, H_ssm, s.head_dim,
                        s.n_groups, s.d_state, s.chunk, timed=True)
    scan_cases = [dict(scan, case="zamba2-2.7b prefill"),
                  dict(compare_scan(torch, ss, g, 2, 4096, 48, 64, 1, 128, 256,
                                    timed=True), case="mamba2-780m"),
                  dict(compare_scan(torch, ss, g, 1, 333, 6, 24, 2, 20, 64,
                                    timed=False), case="odd, 2 groups, ragged")]
    kern["ssd_scan@mamba2_780m"] = dict(scan_cases[1], kernel="ssd_scan",
                                        path="prefill_zoo")
    torch.cuda.empty_cache()
    emit({"phase": "model_kernels", "flash_attention": attn_cases,
          "ssd_scan": scan_cases, "peak_flops": PEAK_FLOPS,
          "hbm_bytes_per_s": HBM_BYTES_PER_S,
          "seconds": time.perf_counter() - t0, "card": card})

    # 11-13. prefill, serve and prefill_f32: zamba2-2.7b FULL, 2 x 4096 tokens
    pattern, R, shared = layer_pattern(cfg)
    expect = {"flash_attention": R * shared, "ssd_scan": R * len(pattern)}
    MEASURED["prefill"] = serve_model(
        torch, np, card, kmods, cfg, PREFILL_B, PREFILL_S, expect, PREFILL_RTOL,
        {"flash_attention": attn["ms"], "ssd_scan": scan["ms"]},
        ("prefill", "serve", "prefill_f32"))
    launches.update(expect)
    kern["flash_attention"], kern["ssd_scan"] = attn, scan


def serve_model(torch, np, card, kmods, cfg, B, S, expect, rtol, kernel_ms, phases,
                zoo=False) -> dict:
    """``cfg`` at full width, random bf16 weights from the seed: the prefill
    of B prompts of S tokens (launches exactly ``expect``, last-position
    logits within ``rtol`` of the "torch" backend's scale), a
    ``ServeLoop`` of SERVE_SLOTS slots answering SERVE_REQUESTS requests
    (no launch), then the prefill in f32 within PREFILL_RTOL_F32: at full
    depth where its estimated peak (twice the bf16 prefill's) stays under
    F32_PEAK, else on the first layers that do.  ``kernel_ms``: each launched kernel's
    time alone at its prefill shape, for its share; ``phases``: the three
    lines' names; ``zoo``: the lines also give each phase's seconds, the
    greedy tokens and the f32 depth and peak.  With a sliding window
    shorter than S the prefill line also gives how far the logits move
    without it, which must be more than 0 (the window reached the
    kernel).  Frees its parameters.
    Returns what the dry run reads of the prefill."""
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serve.engine import Request, ServeLoop, make_prefill_step

    pre_name, serve_name, f32_name = phases
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    rng = np.random.default_rng(SEED)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).cuda()
    step = make_prefill_step(cfg)
    plain_step = make_prefill_step(cfg, backend="torch")
    logits, got = counted_run(torch, kmods, lambda: step(params, tok))
    check(got == expect, f"{cfg.name} prefill launches {got} != {expect}")
    check(tuple(logits.shape) == (B, 1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{cfg.name} prefill logits {tuple(logits.shape)} not finite or misshapen")
    plain_logits, got = counted_run(torch, kmods, lambda: plain_step(params, tok))
    check(got == {}, f"the torch backend launched {got}")
    diff = float((logits.float() - plain_logits.float()).abs().max())
    scale = float(plain_logits.float().abs().max())
    check(diff <= rtol * scale,
          f"{cfg.name} prefill: cuda backend differs from torch by {diff} (scale {scale})")
    same_top = (logits.argmax(-1) == plain_logits.argmax(-1)).tolist()
    pre_extra = {}
    if zoo:
        pre_extra["greedy_tokens"] = logits.argmax(-1).flatten().tolist()
    if cfg.sliding_window is not None and S > cfg.sliding_window:
        wide = make_prefill_step(replace(cfg, sliding_window=None))(params, tok)
        moved = float((wide.float() - logits.float()).abs().max())
        check(moved > 0, f"{cfg.name} prefill: the logits do not move without the "
                         f"window {cfg.sliding_window} at {S} tokens")
        pre_extra.update(window=cfg.sliding_window, no_window_vs_window_max_abs=moved)
        del wide
    del plain_logits
    torch.cuda.empty_cache()
    pre_ms, pre_runs = median_ms(torch, lambda: step(params, tok), 3)
    pre_peak = torch.cuda.max_memory_allocated()
    plain_pre_ms, plain_pre_runs = median_ms(torch, lambda: plain_step(params, tok), 3)
    torch.cuda.empty_cache()
    shares = {f"{k}_share": kernel_ms[k] * expect[k] / pre_ms for k in expect}
    rest = 1
    for v in shares.values():
        rest -= v
    emit({"phase": pre_name, "arch": cfg.name, "batch": B, "seq": S,
          "params": n_params, "param_count": cfg.param_count(),
          "weight_bytes": weight_bytes, "init_s": init_s,
          "launches": expect, "finite": True,
          "cuda_vs_torch_max_abs": diff, "torch_logits_max_abs": scale,
          "tolerance_rel": rtol, "same_greedy_token": same_top,
          "ms": pre_ms, "ms_runs": pre_runs,
          "tokens_per_s": B * S / pre_ms * 1e3,
          "plain_ms": plain_pre_ms, "plain_ms_runs": plain_pre_runs,
          **shares, "rest_share": rest,
          "max_memory_allocated": pre_peak, **pre_extra,
          **({"phase_seconds": time.perf_counter() - t_phase} if zoo else {}),
          "card": card})
    del logits

    # serve: ServeLoop answers 8 requests, 16 greedy tokens each
    t_phase = time.perf_counter()
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, 65, SERVE_REQUESTS)]
    reqs = [Request(i, p, max_new=SERVE_NEW) for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    loop = ServeLoop(cfg, params, batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ)
    for r in reqs:
        loop.submit(r)

    def serve():
        n = 0
        while loop.step() or loop.queue:
            n += 1
        return n

    t0 = time.perf_counter()
    steps, got = counted_run(torch, kmods, serve)
    serve_s = time.perf_counter() - t0
    check(all(r.done and len(r.out) == SERVE_NEW for r in reqs),
          f"{cfg.name} serve: a request did not finish with its tokens")
    check(got == {}, f"{cfg.name} serve (decode only) launched {got}")
    serve_peak = torch.cuda.max_memory_allocated()
    # the greedy first token of two prompts: prefill step vs the loop, and
    # prefill logits vs token-by-token decode logits (a finding, no gate)
    agree = []
    for r in reqs[:2]:
        t = torch.tensor([r.prompt], device="cuda")
        pl = step(params, t)[0, 0].float()
        cache = init_cache(cfg, 1, len(r.prompt))
        for i in range(len(r.prompt)):
            dl, cache = decode_step(params, cfg, cache, t[:, i:i + 1])
        agree.append({"rid": r.rid, "prompt_len": len(r.prompt),
                      "prefill_first_token": int(pl.argmax()),
                      "serve_first_token": r.out[0],
                      "prefill_vs_decode_logits_max_abs": float(
                          (pl - dl[0, 0].float()).abs().max()),
                      "logits_max_abs": float(pl.abs().max())})
    # torch calls in one decode step over the slots (what sets the host's pace)
    cache = init_cache(cfg, SERVE_SLOTS, SERVE_MAX_SEQ)
    ops_per_step = torch_calls(torch, lambda: decode_step(
        params, cfg, cache, torch.ones((SERVE_SLOTS, 1), dtype=torch.long,
                                       device="cuda")))
    del cache
    emit({"phase": serve_name, "arch": cfg.name, "batch_slots": SERVE_SLOTS,
          "max_seq": SERVE_MAX_SEQ, "requests": SERVE_REQUESTS,
          "prompt_lens": [len(p) for p in prompts], "max_new": SERVE_NEW,
          "all_done": True, "engine_steps": steps, "seconds": serve_s,
          "ms_per_decode_step": serve_s / steps * 1e3,
          "generated_tok_per_s": SERVE_REQUESTS * SERVE_NEW / serve_s,
          "kernel_launches": got, "first_tokens": agree,
          "torch_ops_per_decode_step": ops_per_step,
          "max_memory_allocated": serve_peak,
          **({"phase_seconds": time.perf_counter() - t_phase} if zoo else {}),
          "card": card})
    del params, loop
    torch.cuda.empty_cache()

    # the same prefill in f32: "cuda" against "torch" at a tight tolerance
    t_phase = time.perf_counter()
    cfg32 = replace(cfg, dtype="float32")
    expect32 = expect
    if 2 * pre_peak > F32_PEAK:
        layers = max(1, int(cfg.n_layers * F32_PEAK / (2 * pre_peak)))
        cfg32 = replace(cfg32, n_layers=layers)
        expect32 = {k: v * layers // cfg.n_layers for k, v in expect.items()}
    if zoo:
        torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg32, torch.Generator(device="cuda").manual_seed(SEED))
    step32 = make_prefill_step(cfg32)
    logits, got = counted_run(torch, kmods, lambda: step32(params, tok))
    check(got == expect32, f"{cfg.name} f32 prefill launches {got} != {expect32}")
    plain_logits = make_prefill_step(cfg32, backend="torch")(params, tok)
    diff = float((logits - plain_logits).abs().max())
    scale = float(plain_logits.abs().max())
    check(bool(torch.isfinite(logits).all()) and diff <= PREFILL_RTOL_F32 * scale,
          f"{cfg.name} f32 prefill: cuda backend differs from torch by {diff} "
          f"(scale {scale})")
    f32_extra = ({"n_layers": cfg32.n_layers, "published_layers": cfg.n_layers,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "phase_seconds": time.perf_counter() - t_phase} if zoo else {})
    emit({"phase": f32_name, "arch": cfg.name, "batch": B, "seq": S,
          "launches": got, "cuda_vs_torch_max_abs": diff,
          "torch_logits_max_abs": scale, "tolerance_rel": PREFILL_RTOL_F32,
          "same_greedy_token": (logits.argmax(-1) == plain_logits.argmax(-1)).tolist(),
          **f32_extra, "card": card})
    del params, logits, plain_logits
    torch.cuda.empty_cache()
    return {"ms": min(pre_runs), "weight_bytes": weight_bytes,
            "max_memory_allocated": pre_peak}


def zoo_phases(torch, np, card, kmods, launches, kern) -> None:
    """The five configurations of ZOO at full width, one after the other,
    each freed before the next: prefill_zoo, decode_zoo and
    prefill_zoo_f32 (``serve_model``), each kernel's share from its time
    alone at the same shape in model_kernels; then the group's seconds."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    for arch, (key, S, expect) in ZOO.items():
        name = next(iter(expect))
        serve_model(torch, np, card, kmods, get_config(arch), PREFILL_B, S, expect,
                    ZOO_PREFILL_RTOL[arch], {name: kern[f"{name}@{key}"]["ms"]},
                    ("prefill_zoo", "decode_zoo", "prefill_zoo_f32"), zoo=True)
        launches[f"{name}@{key}"] = expect[name]
    emit({"phase": "zoo", "configs": list(ZOO), "seconds": time.perf_counter() - t0,
          "card": card})


def torch_calls(torch, fn) -> int:
    """The torch operator calls ``fn()`` makes (what sets a host-bound
    step's pace)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            CountOps.n += 1
            return func(*args, **(kwargs or {}))

    with CountOps():
        fn()
    return CountOps.n


def memory_len(cfg) -> int:
    """Rows of the stub frontend's output: image tokens or audio frames."""
    return cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames


def memory_attn_cases(get_config) -> dict:
    """The memory families' attention shapes: key -> (case, the path that
    launches it, (B, S, H, Hkv, hd, causal, window), Skv)."""
    v, w = get_config(VLM_ARCH), get_config(ENC_ARCH)
    vh, wh = (v.n_heads, v.n_kv_heads, v.hd), (w.n_heads, w.n_kv_heads, w.hd)
    T, F_ = v.n_image_tokens, w.n_audio_frames
    return {
        "vlm_self": (f"{VLM_ARCH} self", "prefill_vlm",
                     (PREFILL_B, PREFILL_S, *vh, True, None), PREFILL_S),
        "vlm_cross": (f"{VLM_ARCH} cross", "prefill_vlm",
                      (PREFILL_B, PREFILL_S, *vh, False, None), T),
        "vlm_decode_cross": (f"{VLM_ARCH} decode cross", "decode_vlm",
                             (VLM_SLOTS, 1, *vh, False, None), T),
        "whisper_encoder": (f"{ENC_ARCH} encoder", "prefill_encdec",
                            (ENC_B, F_, *wh, False, None), F_),
        "whisper_decoder": (f"{ENC_ARCH} decoder", "prefill_encdec",
                            (ENC_B, ENC_S, *wh, True, None), ENC_S),
        "whisper_cross": (f"{ENC_ARCH} cross", "prefill_encdec",
                          (ENC_B, ENC_S, *wh, False, None), F_),
        "whisper_decode_cross": (f"{ENC_ARCH} decode cross", "decode_encdec",
                                 (ENC_SLOTS, 1, *wh, False, None), F_),
    }


def gated_params(torch, init_params, cfg):
    """Random weights from the seed, every xattn gate at XATTN_GATE."""
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    for layer in params.layers:
        if layer.typ == "xattn":
            layer.gate.fill_(XATTN_GATE)
    return params


def memory_prefill(torch, kmods, cfg, params, tok, mem, expect, rtol) -> tuple:
    """``make_prefill_step`` with ``memory_embeds``: its launches must be
    ``expect``, its last-position logits finite and within ``rtol`` of the
    largest "torch" logit of the "torch" backend's.  Returns the record
    and the two steps."""
    from repro_torch.serve.engine import make_prefill_step

    step = make_prefill_step(cfg)
    plain_step = make_prefill_step(cfg, backend="torch")
    logits, got = counted_run(torch, kmods, lambda: step(params, tok, mem))
    by_shape = shape_launches(kmods)
    check(got == expect, f"{cfg.name} prefill launches {got} != {expect}")
    check(tuple(logits.shape) == (tok.shape[0], 1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{cfg.name} prefill logits {tuple(logits.shape)} not finite or misshapen")
    plain, got = counted_run(torch, kmods, lambda: plain_step(params, tok, mem))
    check(got == {}, f"the torch backend launched {got}")
    diff = float((logits.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    check(diff <= rtol * scale,
          f"{cfg.name} {cfg.dtype} prefill: cuda backend differs from torch by "
          f"{diff} (scale {scale})")
    rec = {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "batch": tok.shape[0], "seq": tok.shape[1], "memory_rows": mem.shape[1],
           "xattn_gate": XATTN_GATE if cfg.family == "vlm" else None,
           "launches": expect, "finite": True, "cuda_vs_torch_max_abs": diff,
           "torch_logits_max_abs": scale, "tolerance_rel": rtol,
           "same_greedy_token": (logits.argmax(-1) == plain.argmax(-1)).tolist()}
    return rec, by_shape, step, plain_step


def shape_launches(kmods) -> dict:
    """The flash_attention wrapper's launches by shape since the last
    reset: (causal, Sq, Skv, H, Hkv, hd) -> launches."""
    return next(dict(m.LAUNCHES_BY_SHAPE) for m in kmods
                if hasattr(m, "LAUNCHES_BY_SHAPE"))


def shape_key(case) -> tuple:
    """A ``memory_attn_cases`` entry's key in ``LAUNCHES_BY_SHAPE``."""
    _, _, (_, S, H, Hkv, hd, causal, _), skv = case
    return (causal, S, skv, H, Hkv, hd)


def greedy_decode(torch, decode_step, params, cfg, cache, prompts, new):
    """Each slot's prompt fed token by token through ``decode_step``, then
    ``new`` greedy tokens -> (tokens generated a slot, each slot's logits
    at its last prompt token, steps)."""
    outs, first = [[] for _ in prompts], [None] * len(prompts)
    steps = max(map(len, prompts)) - 1 + new
    cur = [p[0] for p in prompts]
    for t in range(steps):
        logits, cache = decode_step(params, cfg, cache,
                                    torch.tensor(cur, device="cuda")[:, None])
        nxt = logits[:, 0].argmax(-1).tolist()
        for i, p in enumerate(prompts):
            if t == len(p) - 1:
                first[i] = logits[i, 0].float().clone()
            if t >= len(p) - 1 and len(outs[i]) < new:
                outs[i].append(nxt[i])
            cur[i] = p[t + 1] if t + 1 < len(p) else nxt[i]
    return outs, first, steps


def memory_model_phases(torch, np, card, kmods, launches, kern) -> None:
    """llama-3.2-vision-11b and whisper-small at full width: the bf16
    prefill with its frontend embeddings ("cuda" against "torch"), the
    prefill in f32, and greedy decode over a cache holding the encoded
    memory.  Fills ``launches`` for the kernels line's memory-family rows
    of ``kern``, each shape's count read from the wrapper's
    ``LAUNCHES_BY_SHAPE``."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, encode_memory, init_cache, init_params
    from repro_torch.models import layer_pattern

    cases = memory_attn_cases(get_config)
    rng = np.random.default_rng(SEED)
    for arch, B, S, slots, max_seq in (
            (VLM_ARCH, PREFILL_B, PREFILL_S, VLM_SLOTS, VLM_MAX_SEQ),
            (ENC_ARCH, ENC_B, ENC_S, ENC_SLOTS, ENC_MAX_SEQ)):
        cfg = get_config(arch)
        tag = cfg.family
        pattern, R, _ = layer_pattern(cfg)
        per_shape = ({"vlm_self": R * pattern.count("attn"),
                      "vlm_cross": R * pattern.count("xattn")} if tag == "vlm" else
                     {"whisper_encoder": cfg.encoder_layers,
                      "whisper_decoder": R * pattern.count("dec"),
                      "whisper_cross": R * pattern.count("dec")})
        per_step = R * (pattern.count("xattn") + pattern.count("dec"))
        expect = {"flash_attention": sum(per_shape.values())}
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).cuda()
        mem = torch.from_numpy(rng.standard_normal(
            (B, memory_len(cfg), cfg.d_model), dtype=np.float32)).cuda()

        # prefill, bf16
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = gated_params(torch, init_params, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rec, by_shape, step, plain_step = memory_prefill(
            torch, kmods, cfg, params, tok, mem, expect, PREFILL_RTOL)
        measured = {k: by_shape.get(shape_key(cases[k]), 0) for k in per_shape}
        check(measured == per_shape and sum(by_shape.values()) == sum(measured.values()),
              f"{arch} prefill launches by shape {by_shape} != {per_shape}")
        torch.cuda.empty_cache()
        pre_ms, pre_runs = median_ms(torch, lambda: step(params, tok, mem), 3)
        peak = torch.cuda.max_memory_allocated()
        plain_ms, plain_runs = median_ms(torch, lambda: plain_step(params, tok, mem), 3)
        kernel_ms = {k: kern[f"flash_attention@{k}"]["ms"] * n
                     for k, n in per_shape.items()}
        for k, n in measured.items():
            launches[f"flash_attention@{k}"] = n
            kern[f"flash_attention@{k}"]["path_launches"] = expect["flash_attention"]
        emit({"phase": f"prefill_{tag}", **rec,
              "params": sum(p.numel() for p in params.parameters()),
              "param_count": cfg.param_count(),
              "weight_bytes": sum(p.numel() * p.element_size()
                                  for p in params.parameters()),
              "init_s": init_s, "launches_by_shape": measured,
              "ms": pre_ms, "ms_runs": pre_runs,
              "tokens_per_s": B * S / pre_ms * 1e3,
              "plain_ms": plain_ms, "plain_ms_runs": plain_runs,
              "flash_attention_ms": kernel_ms,
              "flash_attention_share": sum(kernel_ms.values()) / pre_ms,
              "max_memory_allocated": peak, "memory_allocated_at_start": start,
              "card": card})

        # decode over a cache holding the encoded memory
        lens = rng.integers(16, 65, slots)
        prompts = [rng.integers(0, cfg.vocab, int(n)).tolist() for n in lens]
        dmem = torch.from_numpy(rng.standard_normal(
            (slots, memory_len(cfg), cfg.d_model), dtype=np.float32)).cuda()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        cache = init_cache(cfg, slots, max_seq, memory=encode_memory(params, cfg, dmem))
        t0 = time.perf_counter()
        (outs, first, steps), got = counted_run(torch, kmods, lambda: greedy_decode(
            torch, decode_step, params, cfg, cache, prompts, SERVE_NEW))
        dec_s = time.perf_counter() - t0
        key = f"{'vlm' if tag == 'vlm' else 'whisper'}_decode_cross"
        dec_shape = shape_launches(kmods)
        check(got == {"flash_attention": per_step * steps}
              and dec_shape == {shape_key(cases[key]): per_step * steps},
              f"{arch} decode launches {got}, by shape {dec_shape} != "
              f"{per_step} a step x {steps}")
        check(all(len(o) == SERVE_NEW for o in outs), f"{arch} decode: a slot "
              "did not get its tokens")
        dec_peak = torch.cuda.max_memory_allocated()
        launches[f"flash_attention@{key}"] = dec_shape[shape_key(cases[key])]
        kern[f"flash_attention@{key}"]["launches_per_step"] = per_step
        step_ops = torch_calls(torch, lambda: decode_step(
            params, cfg, cache, torch.ones((slots, 1), dtype=torch.long, device="cuda")))
        del cache
        # a finding, no gate: each prompt's prefill against its decode
        agree = []
        for i, p in enumerate(prompts):
            pl = step(params, torch.tensor([p], device="cuda"), dmem[i:i + 1])[0, 0]
            agree.append({"prompt_len": len(p),
                          "prefill_first_token": int(pl.argmax()),
                          "decode_first_token": outs[i][0],
                          "prefill_vs_decode_logits_max_abs": float(
                              (pl.float() - first[i]).abs().max()),
                          "logits_max_abs": float(pl.float().abs().max())})
        emit({"phase": f"decode_{tag}", "arch": cfg.name, "batch_slots": slots,
              "max_seq": max_seq, "memory_rows": memory_len(cfg),
              "prompt_lens": lens.tolist(), "max_new": SERVE_NEW, "steps": steps,
              "launches": got, "launches_per_step": per_step, "seconds": dec_s,
              "ms_per_decode_step": dec_s / steps * 1e3,
              "generated_tok_per_s": slots * SERVE_NEW / dec_s,
              "fed_and_generated_tok_per_s": slots * steps / dec_s,
              "torch_ops_per_decode_step": step_ops, "first_tokens": agree,
              "max_memory_allocated": dec_peak, "memory_allocated_at_start": start,
              "card": card})
        del params, step, plain_step
        torch.cuda.empty_cache()

        # the prefill in f32 (vlm: one super-block), "cuda" against "torch"
        cfg32 = replace(cfg, dtype="float32")
        if tag == "vlm":
            cfg32 = replace(cfg32, n_layers=VLM_F32_LAYERS)
        pattern, R, _ = layer_pattern(cfg32)
        expect32 = {"flash_attention": R * len(pattern) + R * pattern.count("dec")
                    + cfg32.encoder_layers}
        params = gated_params(torch, init_params, cfg32)
        rec, _, _, _ = memory_prefill(torch, kmods, cfg32, params, tok, mem,
                                      expect32, PREFILL_RTOL_F32)
        emit({"phase": f"prefill_{tag}_f32", **rec, "card": card})
        del params
        torch.cuda.empty_cache()


def moe_flops(cfg, B, S) -> dict:
    """The prefill's operations by part, from the shapes: each expert's
    SwiGLU over its padded E x C rows (and, for comparison, over the
    T x K real slots), the shared experts, the attention projections (GQA,
    or MLA's down, up and output projections) and attention itself (the
    causal triangle), per layer times its layers; the router's f32
    product apart (it runs outside the tensor cores)."""
    from repro_torch.models.moe import capacity

    mo, d, L, T = cfg.moe, cfg.d_model, cfg.n_layers, B * S
    swiglu = 2 * 3 * d * mo.d_expert             # a row of one expert, 3 products
    H, m = cfg.n_heads, cfg.mla
    if m is None:
        hd = cfg.hd
        proj = 2 * T * d * (2 * H * hd + 2 * cfg.n_kv_heads * hd)
        attn, _ = attn_work(B, S, H, cfg.n_kv_heads, hd, True, None, 2)
    else:
        qk = m.qk_nope_dim + m.qk_rope_dim
        proj = 2 * T * (d * m.q_lora_rank + m.q_lora_rank * H * qk
                        + d * (m.kv_lora_rank + m.qk_rope_dim)
                        + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
                        + H * m.v_head_dim * d)
        attn, _ = attn_work(B, S, H, H, qk, True, None, 2, hd_v=m.v_head_dim)
    return {"routed_padded": L * swiglu * mo.n_experts * capacity(cfg, T),
            "routed_real": L * swiglu * T * mo.top_k,
            "shared": L * swiglu * mo.n_shared * T,
            "attention_projections": L * proj, "attention": L * attn,
            "router_f32": L * 2 * T * d * mo.n_experts}


@contextlib.contextmanager
def moe_drops(torch):
    """Counts, while inside, the (token, k) slots every ``moe_apply`` of
    the model keeps and drops (its routing computed once more, on the
    device, no host sync): yields {"kept": [...], "dropped": [...]}, one
    tensor a call, and "first": the first call's (block, input)."""
    from repro_torch.models import transformer as tt
    from repro_torch.models.moe import route

    seen = {"kept": [], "dropped": []}
    plain = tt.moe_apply

    def counting(p, x, cfg):
        seen.setdefault("first", (p, x))
        r, _ = route(p, x.reshape(-1, x.shape[-1]), cfg)
        seen["kept"].append(r.keep.sum())
        seen["dropped"].append((~r.keep).sum())
        return plain(p, x, cfg)

    tt.moe_apply = counting
    try:
        yield seen
    finally:
        tt.moe_apply = plain


def drop_share(seen) -> dict:
    """The dropped share of the slots a ``moe_drops`` run saw, overall and
    the least and most of one call."""
    kept = [int(t) for t in seen["kept"]]
    dropped = [int(t) for t in seen["dropped"]]
    per_call = [d / (k + d) for k, d in zip(kept, dropped)]
    return {"dropped_share": sum(dropped) / (sum(kept) + sum(dropped)),
            "dropped_slots": sum(dropped), "slots": sum(kept) + sum(dropped),
            "calls": len(kept), "min_call_share": min(per_call),
            "max_call_share": max(per_call)}


def nodrop_agreement(torch, params, cfg, prompts) -> list:
    """With ``capacity_factor = E / K`` (C = T: no slot dropped, so a token's
    output does not depend on the others), each prompt's prefill against
    token-by-token decode over SERVE_SLOTS slots: next tokens and the
    largest logit gap, a record a prompt."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.moe import capacity
    from repro_torch.serve.engine import make_prefill_step

    mo = cfg.moe
    nodrop = replace(cfg, moe=replace(mo, capacity_factor=mo.n_experts / mo.top_k))
    check(all(capacity(nodrop, t) >= t for t in [SERVE_SLOTS] + list(map(len, prompts))),
          "no-drop variant: a capacity below its tokens")
    step = make_prefill_step(nodrop)
    agree = []
    for lo in range(0, len(prompts), SERVE_SLOTS):
        group = prompts[lo:lo + SERVE_SLOTS]
        cache = init_cache(nodrop, len(group), SERVE_MAX_SEQ)
        outs, first, _ = greedy_decode(torch, decode_step, params, nodrop, cache,
                                       group, 1)
        del cache
        for p, out, dl in zip(group, outs, first):
            pl = step(params, torch.tensor([p], device="cuda"))[0, 0].float()
            agree.append({"prompt_len": len(p),
                          "prefill_first_token": int(pl.argmax()),
                          "decode_first_token": out[0],
                          "prefill_vs_decode_logits_max_abs": float(
                              (pl - dl).abs().max()),
                          "logits_max_abs": float(pl.abs().max())})
    return agree


def mtp_params(cfg) -> int:
    """Parameters outside ``param_count()`` besides ``ln_f``: with MTP, the
    ``attn`` block ``mtp`` (GQA, two norms, a SwiGLU of d_ff) and
    ``mtp_proj`` [2d, d]."""
    if not cfg.mtp:
        return 0
    d, hd = cfg.d_model, cfg.hd
    gqa = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    return gqa + 2 * d + 3 * d * cfg.d_ff + 2 * d * d


def moe_phases(torch, np, card, kmods, launches, kern, arch=MOE_ARCH, layers=None,
               f32_layers=MOE_F32_LAYERS, f32_seq=PREFILL_S,
               rtol=MOE_PREFILL_RTOL) -> None:
    """A moe config at full width (deepseek-moe-16b: phases ``*_moe``; with
    MLA, deepseek-v3: ``*_mla``), cut to ``layers`` layers when given: the
    bf16 prefill of 2 x 4096 tokens ("cuda" against "torch" within
    ``rtol``, one flash attention launch a layer, the moe block timed
    alone by stage, the dropped slots), a continuous-batching serve loop,
    the first tokens of a no-drop variant against its prefill, and an
    f32 prefill of ``f32_layers`` layers on ``f32_seq`` tokens a prompt."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params, layer_pattern
    from repro_torch.models import moe as tm
    from repro_torch.models.layers import swiglu_apply
    from repro_torch.serve.engine import Request, ServeLoop, make_prefill_step

    cfg = get_config(arch)
    published = cfg.n_layers
    if layers is not None:
        cfg = replace(cfg, n_layers=layers)
    tag = "moe" if cfg.mla is None else "mla"
    key = f"flash_attention@{tag}_self"
    mo = cfg.moe
    pattern, R, _ = layer_pattern(cfg)
    expect = {"flash_attention": R * len(pattern)}
    hd_q = cfg.hd if cfg.mla is None else cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
    by_shape = {(True, PREFILL_S, PREFILL_S, cfg.n_heads, cfg.n_kv_heads, hd_q):
                expect["flash_attention"]}
    rng = np.random.default_rng(SEED)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (PREFILL_B, PREFILL_S))).cuda()

    # prefill, bf16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    outside = cfg.d_model + mtp_params(cfg)
    check(n_params == cfg.param_count() + outside,
          f"{arch}: {n_params} parameters, param_count() + ln_f (+ MTP) "
          f"{cfg.param_count() + outside}")
    step = make_prefill_step(cfg)
    plain_step = make_prefill_step(cfg, backend="torch")
    logits, got = counted_run(torch, kmods, lambda: step(params, tok))
    check(got == expect, f"{arch} prefill launches {got} != {expect}")
    got_by_shape = shape_launches(kmods)
    check(got_by_shape == by_shape,
          f"{arch} prefill launches by shape {got_by_shape} != {by_shape}")
    launches[key] = got["flash_attention"]
    kern[key]["path_launches"] = got["flash_attention"]
    check(tuple(logits.shape) == (PREFILL_B, 1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{arch} prefill logits {tuple(logits.shape)} not finite or misshapen")
    plain, got = counted_run(torch, kmods, lambda: plain_step(params, tok))
    check(got == {}, f"the torch backend launched {got}")
    diff = float((logits.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    check(diff <= rtol * scale,
          f"{arch} prefill: cuda backend differs from torch by {diff} "
          f"(scale {scale})")
    same_top = (logits.argmax(-1) == plain.argmax(-1)).tolist()
    del plain
    torch.cuda.empty_cache()
    pre_ms, pre_runs = median_ms(torch, lambda: step(params, tok), 3)
    peak = torch.cuda.max_memory_allocated()
    plain_ms, plain_runs = median_ms(torch, lambda: plain_step(params, tok), 3)
    with moe_drops(torch) as seen:
        step(params, tok)
    drops = drop_share(seen)
    torch.cuda.empty_cache()

    # the first layer's moe block alone on its input in this prefill, by stage
    block, x = seen.pop("first")
    xt = x.reshape(-1, cfg.d_model)
    T = xt.shape[0]
    r, _ = tm.route(block, xt, cfg)
    buf = tm.dispatch(xt, r, cfg)
    y = tm.expert_ffn(block, buf)
    stages = {"routing": cuda_ms(torch, lambda: tm.route(block, xt, cfg), 5),
              "dispatch": cuda_ms(torch, lambda: tm.dispatch(xt, r, cfg), 5),
              "experts": cuda_ms(torch, lambda: tm.expert_ffn(block, buf), 5),
              "combine": cuda_ms(torch, lambda: tm.combine(y, r, T), 5),
              "shared": cuda_ms(torch, lambda: swiglu_apply(block.shared, xt), 5)}
    moe_ms = cuda_ms(torch, lambda: tm.moe_apply(block, x, cfg), 5)
    first_drop = float((~r.keep).float().mean())
    del block, x, xt, r, buf, y
    torch.cuda.empty_cache()
    flops = moe_flops(cfg, PREFILL_B, PREFILL_S)
    bf16_flops = sum(v for k, v in flops.items()
                     if k not in ("routed_real", "router_f32"))
    ops_ms = (bf16_flops / PEAK_FLOPS["bfloat16"]
              + flops["router_f32"] / PEAK_FLOPS["float32"]) * 1e3
    attn_ms = kern[key]["ms"] * expect["flash_attention"]
    emit({"phase": f"prefill_{tag}", "arch": arch, "dtype": cfg.dtype,
          "n_layers": cfg.n_layers, "published_layers": published,
          "cut": None if layers is None else f"{layers} of {published} layers, "
                                             "each at full width",
          "batch": PREFILL_B, "seq": PREFILL_S, "launches_by_shape": {
              str(list(k)): v for k, v in got_by_shape.items()},
          "experts": mo.n_experts, "top_k": mo.top_k, "shared": mo.n_shared,
          "capacity": tm.capacity(cfg, PREFILL_B * PREFILL_S),
          "params": n_params, "param_count": cfg.param_count(),
          "params_outside_param_count": outside,
          "weight_bytes": weight_bytes, "init_s": init_s,
          "launches": expect, "finite": True,
          "cuda_vs_torch_max_abs": diff, "torch_logits_max_abs": scale,
          "cuda_vs_torch_rel": diff / scale, "tolerance_rel": rtol,
          "same_greedy_token": same_top,
          "ms": pre_ms, "ms_runs": pre_runs,
          "tokens_per_s": PREFILL_B * PREFILL_S / pre_ms * 1e3,
          "plain_ms": plain_ms, "plain_ms_runs": plain_runs,
          "flash_attention_ms": attn_ms, "flash_attention_share": attn_ms / pre_ms,
          "moe_block_ms": moe_ms, "moe_block_stages_ms": stages,
          "moe_block_dropped_share": first_drop,
          "moe_share": moe_ms * R / pre_ms, **drops,
          "flops": flops, "flops_counted": bf16_flops + flops["router_f32"],
          "bound_ms": max(ops_ms, ms_of_bytes(weight_bytes)),
          "bound_by": "operations" if ops_ms >= ms_of_bytes(weight_bytes) else "bytes",
          "weights_bytes_ms": ms_of_bytes(weight_bytes),
          "max_memory_allocated": peak, "memory_allocated_at_start": start,
          "peak_above_start": peak - start, "card": card})

    # decode: ServeLoop answers 8 requests, 16 greedy tokens each
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, 65, SERVE_REQUESTS)]

    def serve_all(config):
        reqs = [Request(i, p, max_new=SERVE_NEW) for i, p in enumerate(prompts)]
        loop = ServeLoop(config, params, batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ)
        for req in reqs:
            loop.submit(req)
        n = 0
        while loop.step() or loop.queue:
            n += 1
        return reqs, n

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    (reqs, steps), got = counted_run(torch, kmods, lambda: serve_all(cfg))
    dec_s = time.perf_counter() - t0
    check(all(r.done and len(r.out) == SERVE_NEW for r in reqs),
          f"{arch} serve: a request did not finish with its tokens")
    check(got == {}, f"{arch} serve (decode only) launched {got}")
    dec_peak = torch.cuda.max_memory_allocated()
    with moe_drops(torch) as seen:
        again, _ = serve_all(cfg)
    dec_drops = drop_share(seen)
    del seen                    # its "first" holds a block of the model
    check([r.out for r in again] == [r.out for r in reqs],
          f"{arch} serve: a second run gave other tokens")
    cache = init_cache(cfg, SERVE_SLOTS, SERVE_MAX_SEQ)
    step_ops = torch_calls(torch, lambda: decode_step(
        params, cfg, cache, torch.ones((SERVE_SLOTS, 1), dtype=torch.long,
                                       device="cuda")))
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    del cache
    # a step reads every weight but the embedding table (B rows of it) and
    # the MTP block and projection (training only), and every cache
    step_bytes = weight_bytes - params.embed.numel() * params.embed.element_size() \
        - mtp_params(cfg) * params.embed.element_size() + cache_bytes

    # no-drop variant (C = T): each prompt's prefill against its decode, a
    # finding in bf16 (routing flips with rounding), checked in f32 below
    agree = nodrop_agreement(torch, params, cfg, prompts)
    emit({"phase": f"decode_{tag}", "arch": arch, "n_layers": cfg.n_layers,
          "batch_slots": SERVE_SLOTS,
          "max_seq": SERVE_MAX_SEQ, "requests": SERVE_REQUESTS,
          "prompt_lens": [len(p) for p in prompts], "max_new": SERVE_NEW,
          "all_done": True, "engine_steps": steps, "seconds": dec_s,
          "ms_per_decode_step": dec_s / steps * 1e3,
          "generated_tok_per_s": SERVE_REQUESTS * SERVE_NEW / dec_s,
          "kernel_launches": got, "torch_ops_per_decode_step": step_ops,
          "capacity": tm.capacity(cfg, SERVE_SLOTS), **dec_drops,
          "step_bytes": step_bytes, "bytes_bound_ms": ms_of_bytes(step_bytes),
          "nodrop_capacity_factor": mo.n_experts / mo.top_k,
          "nodrop_first_tokens": agree,
          "nodrop_first_tokens_equal": sum(a["prefill_first_token"]
                                           == a["decode_first_token"] for a in agree),
          "max_memory_allocated": dec_peak, "memory_allocated_at_start": start,
          "card": card})
    del params, step, plain_step
    torch.cuda.empty_cache()

    # the prefill in f32, f32_layers layers at full width: "cuda" against
    # "torch"; the no-drop variant's prefill against its decode
    cfg32 = replace(cfg, dtype="float32", n_layers=f32_layers)
    tok = tok[:, :f32_seq].contiguous()
    params = init_params(cfg32, torch.Generator(device="cuda").manual_seed(SEED))
    logits, got = counted_run(torch, kmods, lambda: make_prefill_step(cfg32)(params, tok))
    check(got == {"flash_attention": f32_layers}, f"{arch} f32 prefill launches {got}")
    plain = make_prefill_step(cfg32, backend="torch")(params, tok)
    diff = float((logits - plain).abs().max())
    scale = float(plain.abs().max())
    check(bool(torch.isfinite(logits).all()) and diff <= PREFILL_RTOL_F32 * scale,
          f"{arch} f32 prefill: cuda backend differs from torch by {diff} "
          f"(scale {scale})")
    same_top = (logits.argmax(-1) == plain.argmax(-1)).tolist()
    del logits, plain
    agree = nodrop_agreement(torch, params, cfg32, prompts)
    check(all(a["prefill_first_token"] == a["decode_first_token"]
              and a["prefill_vs_decode_logits_max_abs"]
              <= PREFILL_RTOL_F32 * a["logits_max_abs"] for a in agree),
          f"{arch} f32 no-drop variant: a prefill differs from its decode: "
          f"{agree}")
    emit({"phase": f"prefill_{tag}_f32", "arch": arch, "dtype": "float32",
          "n_layers": f32_layers, "published_layers": published,
          "cut": f"{f32_layers} of {published} layers, each at full width",
          "batch": PREFILL_B, "seq": f32_seq,
          "launches": got, "cuda_vs_torch_max_abs": diff,
          "torch_logits_max_abs": scale, "tolerance_rel": PREFILL_RTOL_F32,
          "same_greedy_token": same_top, "nodrop_first_tokens": agree,
          "nodrop_first_tokens_equal": True, "card": card})
    del params
    torch.cuda.empty_cache()


def mtp_loss_phase(torch, np, card, kmods) -> None:
    """deepseek-v3's training loss with its multi-token-prediction term, at
    full width cut to MTP_LAYERS layer, bf16, through the plain attention
    (``backend="torch"``: the kernels have no backward): forward and
    backward on MTP_B x MTP_S tokens.  ce, aux and mtp finite, the loss
    their weighted sum, every gradient finite and the MTP leaves' not 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import loss_fn

    cfg = replace(get_config(MLA_ARCH), n_layers=MTP_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    names = [n for n, _ in params.named_parameters()]
    leaves = [p.requires_grad_() for p in params.parameters()]
    weight_bytes = sum(p.numel() * p.element_size() for p in leaves)
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab, (MTP_B, MTP_S))
    labels = np.concatenate([tokens[:, 1:], np.full((MTP_B, 1), -100)], axis=1)
    batch = {"tokens": torch.from_numpy(tokens).cuda(),
             "labels": torch.from_numpy(labels).cuda()}

    def step():
        loss, metrics = loss_fn(params, cfg, batch, backend="torch")
        grads = torch.autograd.grad(loss, leaves)
        return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
                grads)

    (loss, metrics, grads), got = counted_run(torch, kmods, step)
    peak = torch.cuda.max_memory_allocated()
    check(got == {}, f"{MLA_ARCH} loss launched {got}")
    check(math.isfinite(loss) and all(map(math.isfinite, metrics.values()))
          and set(metrics) == {"ce", "aux", "mtp"},
          f"{MLA_ARCH} loss {loss} metrics {metrics}")
    parts = metrics["ce"] + 0.3 * metrics["mtp"] + 0.01 * metrics["aux"]
    check(abs(loss - parts) <= 1e-5 * abs(parts),
          f"{MLA_ARCH} loss {loss} != ce + 0.3 mtp + 0.01 aux = {parts}")
    torch.cuda.empty_cache()
    # in slices of 2^26 elements: a whole expert stack's mask would be 3.5 GB
    check(all(bool(torch.isfinite(c).all()) for g in grads
              for c in g.view(-1).split(1 << 26)),
          f"{MLA_ARCH}: a gradient is not finite")
    mtp_grads = {n: float(g.abs().max()) for n, g in zip(names, grads)
                 if n.startswith("mtp")}
    check(len(mtp_grads) == 10 and all(v > 0 for v in mtp_grads.values()),
          f"{MLA_ARCH}: the MTP leaves' gradients {mtp_grads}")
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    del grads
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del out
        torch.cuda.empty_cache()
    published = get_config(MLA_ARCH).n_layers
    emit({"phase": "loss_mtp", "arch": MLA_ARCH, "dtype": cfg.dtype,
          "n_layers": MTP_LAYERS, "published_layers": published,
          "cut": f"{MTP_LAYERS} of {published} layers, each at full width; no optimizer",
          "batch": MTP_B, "seq": MTP_S, "backend": "torch", "launches": got,
          "loss": loss, **metrics, "ln_vocab": math.log(cfg.vocab),
          "finite": True, "mtp_grad_max_abs": mtp_grads,
          "params": sum(p.numel() for p in leaves), "weight_bytes": weight_bytes,
          "grad_bytes": grad_bytes, "ms": sorted(times)[1], "ms_runs": times,
          "tokens_per_s": MTP_B * MTP_S / sorted(times)[1] * 1e3,
          "max_memory_allocated": peak, "memory_allocated_at_start": start,
          "peak_above_start": peak - start, "card": card})
    del params, leaves, batch
    torch.cuda.empty_cache()


def alpha_s(torch) -> float:
    """ALPHA: the median wall time of one round of a warm p = 2 broadcast
    plan on the card (a plan of ALPHA_BLOCKS blocks, ALPHA_CALLS calls)."""
    from repro_torch.core.comm import StackedGroup, get_comm

    x = torch.zeros((2, 4 * ALPHA_BLOCKS), device="cuda")
    plan = get_comm(StackedGroup(2)).plan("broadcast", x, n_blocks=ALPHA_BLOCKS)
    for _ in range(3):
        plan(x)
    times = []
    for _ in range(ALPHA_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / plan.rounds)
    return sorted(times)[len(times) // 2]


def dryrun_phase(torch, card) -> None:
    """The dry run and the roofline on this card, the counts of two calls
    this run measured, ALPHA and the examples (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.common import ShapeConfig
    from repro_torch.train.trainer import TrainConfig

    t0 = time.perf_counter()
    alpha = alpha_s(torch)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    procs = {}
    for arch, shape in DRYRUN_CELLS:
        procs[(arch, shape)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", "single", "--out-dir", str(work)],
            env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for script in EXAMPLES:
        extra = ["--ckpt-dir", str(work / "ckpt")] if "train" in script else []
        procs[script] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / script), *extra], env=env,
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # the dry run's counts of the two calls this run measured, at their
    # own sizes, on a 1 x 1 mesh (one card)
    const = {**roofline.card_constants(), "alpha": alpha}
    one = Mesh((1, 1), ("data", "model"))
    counts = {}
    for name, arch, shape, tcfg in (
            ("prefill", ARCH, ShapeConfig("smoke_prefill", "prefill", PREFILL_S,
                                          PREFILL_B), None),
            ("train_auto", TRAIN_ARCH, ShapeConfig("smoke_train", "train", TRAIN_S,
                                                   TRAIN_B),
             TrainConfig(grad_sync="auto", microbatches=2, remat="full"))):
        rec = dryrun.trace_cell(get_config(arch), shape, one,
                                microbatches=tcfg.microbatches if tcfg else None,
                                tcfg=tcfg)
        got, by = MEASURED[name], rec["memory"]["argument_bytes_by_input"]
        terms = roofline.terms({"arch": arch, "shape": shape.name, **rec}, const)
        real = got["weight_bytes"] if name == "prefill" else got["state_bytes"]
        counted = by["params"] if name == "prefill" else by["state"]
        counts[name] = {
            "arch": arch, "batch": shape.global_batch, "seq": shape.seq_len,
            "flops": rec["flops_weighted"], "bytes": rec["bytes_weighted"],
            "trace_s": rec["lower_s"], "ops": rec["ops"],
            "compute_s": terms["compute_s"], "memory_s": terms["memory_s"],
            "measured_s": got["ms"] / 1e3,
            "compute_share_of_measured": terms["compute_s"] / (got["ms"] / 1e3),
            "argument_bytes": counted, "real_bytes": real,
            "peak_estimate_bytes": rec["memory"]["peak_estimate_bytes"],
            "max_memory_allocated": got["max_memory_allocated"]}
        check(terms["compute_s"] <= got["ms"] / 1e3,
              f"dryrun: {name} counts {rec['flops_weighted']} FLOPs, "
              f"{terms['compute_s']} s at the peak, over its measured {got['ms']} ms")
        check(counted == real, f"dryrun: {name} argument bytes {counted} on meta, "
                               f"{real} on the card")

    examples, records = {}, []
    for key, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        if isinstance(key, str):
            check(proc.returncode == 0 and out.strip().endswith("OK"),
                  f"dryrun: example {key} exited {proc.returncode}:\n{out[-3000:]}")
            said = [ln for ln in out.splitlines() if ln.startswith("kernel launches: ")]
            check(len(said) == 1, f"dryrun: example {key} printed no launch counts")
            examples[key] = ast.literal_eval(said[0].split(": ", 1)[1])
            check(examples[key] == EXAMPLE_LAUNCHES[key],
                  f"dryrun: example {key} launched {examples[key]}, "
                  f"expected {EXAMPLE_LAUNCHES[key]}")
            continue
        check(proc.returncode == 0, f"dryrun: cell {key} exited {proc.returncode}:\n"
                                    f"{out[-3000:]}")
        with open(dryrun.cell_path(*key, "single", out_dir=str(work))) as f:
            rec = json.load(f)
        check(rec["flops_weighted"] > 0 and rec["memory"]["argument_bytes"] > 0,
              f"dryrun: cell {key} counted nothing")
        emit({"phase": "dryrun_cell", **rec})
        records.append(rec)
    shutil.rmtree(work, ignore_errors=True)
    rows = [roofline.terms(r, const) for r in records]
    for line in roofline.markdown_table(rows, const).splitlines():
        print(line, flush=True)
    seconds = time.perf_counter() - t0
    emit({"phase": "dryrun", "seconds": seconds, "budget_s": DRYRUN_BUDGET_S,
          "within_budget": seconds <= DRYRUN_BUDGET_S,
          "alpha_us": alpha * 1e6, "alpha_rounds": ALPHA_BLOCKS,
          "cells": {f"{r['arch']} x {r['shape']}": {
              k: t[k] for k in ("compute_s", "memory_s", "bottleneck", "useful_ratio",
                                "fits_hbm", "peak_gb")} | {"trace_s": r["lower_s"]}
              for r, t in zip(records, rows)},
          "counts": counts, "examples": examples, "card": card})


def main() -> None:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA device")
    sys.path.insert(0, str(SRC))
    from repro_torch.core import (
        DEFAULT_MODEL,
        get_bundle,
        host_plan,
        num_rounds,
        optimal_num_blocks_allgather,
        optimal_num_blocks_bcast,
        optimal_num_blocks_reduce,
        verify_bundle,
    )
    from repro_torch.core.comm import _forward_rounds as forward_rounds
    from repro_torch.core.engine import plan_cache_clear
    from repro_torch.core.comm import _roll as roll_rows
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import block_pack as bp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_ops as qops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.optim.compression import (
        bucketize,
        make_bucket_spec,
        tree_flatten,
        tree_unflatten,
        unbucketize,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kmods = (bp, fa, ss)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # 2. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    logs = _build.build(force=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    ptx = model_kernel_ptxas(ptxas)
    emit({"phase": "build", "seconds": build_s, "nvcc": _build.nvcc_path(),
          "ptxas_lines": len(ptxas),
          "max_registers": max(int(ln.split("Used ")[1].split()[0])
                               for ln in ptxas if "registers" in ln),
          "spills": sorted({ln for ln in ptxas if "spill" in ln}),
          "model_kernels": ptx})

    # 3. kernels vs plain versions on the card
    n = optimal_num_blocks_bcast(P, PAYLOAD_BYTES, DEFAULT_MODEL)
    n_red = optimal_num_blocks_reduce(P, PAYLOAD_BYTES, DEFAULT_MODEL)
    elems = PAYLOAD_BYTES // 4
    bs = math.ceil(elems / n)
    bs_red = math.ceil(elems / n_red)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    kern = compare_kernels(torch, bp, ref, g, P, n + 1, bs, torch.float32,
                           timed=True)
    emit({"phase": "kernels_vs_plain", "shape": [P, n + 1, bs],
          "dtype": "float32", "equal": True,
          "max_abs_diff": {k: v["max_abs_err"] for k, v in kern.items()}})
    for dtype in (torch.bfloat16, torch.int64, torch.int8):
        odd = compare_kernels(torch, bp, ref, g, *ODD, dtype, timed=False)
        emit({"phase": "kernels_vs_plain", "shape": list(ODD),
              "dtype": str(dtype).removeprefix("torch."), "equal": True,
              "max_abs_diff": {k: v["max_abs_err"] for k, v in odd.items()}})
    torch.cuda.empty_cache()
    for op in ("max", "sum"):       # sum last: its times go in the kernels line
        rec = compare_reduce_kernels(torch, bp, ref, g, P, n_red + 2, bs_red,
                                     torch.float32, op, timed=op == "sum")
        emit({"phase": "kernels_vs_plain", "shape": [P, n_red + 2, bs_red],
              "dtype": "float32", "op": op, "equal": True,
              "max_abs_diff": {k: v["max_abs_err"] for k, v in rec.items()}})
        torch.cuda.empty_cache()
    kern.update(rec)
    for dtype in (torch.bfloat16, torch.float16, torch.float64, torch.int64,
                  torch.int32, torch.int8):
        for op in ("sum", "max"):
            odd = compare_reduce_kernels(torch, bp, ref, g, *ODD, dtype, op,
                                         timed=False)
            emit({"phase": "kernels_vs_plain", "shape": list(ODD),
                  "dtype": str(dtype).removeprefix("torch."), "op": op,
                  "equal": True,
                  "max_abs_diff": {k: v["max_abs_err"] for k, v in odd.items()}})
    for op in ("sum", "max"):
        odd = compare_reduce_kernels(torch, bp, ref, g, *ODD, torch.float32, op,
                                     timed=False, specials=True)
        emit({"phase": "kernels_vs_plain", "shape": list(ODD),
              "dtype": "float32", "op": op, "inputs": "nan, +-0, denormal",
              "equal": True,
              "max_abs_diff": {k: v["max_abs_err"] for k, v in odd.items()}})

    launches = {}               # kernel -> launches on its path's run

    # 4. the broadcast through its entry point, sequential and overlapped
    t0 = time.perf_counter()
    for root in (0, BCAST_ROOT):
        verify_bundle(get_bundle(P, root))
    emit({"phase": "verify_bundle", "p": P, "roots": [0, BCAST_ROOT],
          "seconds": time.perf_counter() - t0})

    rounds = num_rounds(P, n)
    rng = np.random.default_rng(SEED)
    flat = np.zeros(n * bs, np.float32)
    flat[:elems] = rng.standard_normal(elems, dtype=np.float32)
    values = flat.reshape(n, bs)

    plan = host_plan("broadcast", P, n, root=BCAST_ROOT, backend="cuda")
    out, got = counted_run(torch, kmods, lambda: plan.run(values))
    expect = {"block_pack": 1, "block_shuffle": rounds - 1, "block_unpack": 1}
    check(got == expect, f"broadcast launches {got} != {expect}")
    launches.update(got)
    check(tuple(out.shape) == (P, n, bs), f"result shape {tuple(out.shape)}")
    vals_dev = torch.from_numpy(values).cuda()
    for i in range(0, P, 64):
        j = min(i + 64, P)
        check(torch.equal(out[i:j], vals_dev.expand(j - i, n, bs)),
              f"ranks {i}..{j - 1} do not hold the root payload")
    out_plain = host_plan("broadcast", P, n, root=BCAST_ROOT,
                          backend="torch").run(values)
    check(same_bits(torch, out, out_plain), "broadcast: cuda backend != torch backend")
    del out_plain
    plan_ov = host_plan("broadcast", P, n, root=BCAST_ROOT, overlap=True)
    out_ov, got = counted_run(torch, kmods, lambda: plan_ov.run(values))
    expect = {"block_pack": rounds, "block_shuffle_staged": rounds - 1,
              "block_unpack": 1}
    check(got == expect, f"overlapped broadcast launches {got} != {expect}")
    launches["block_shuffle_staged"] = got["block_shuffle_staged"]
    check(same_bits(torch, out_ov, out), "overlapped broadcast != sequential")
    del out, out_ov
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    bcast_ms, times = median_ms(torch, lambda: plan.run(values), 5)
    peak_bytes = torch.cuda.max_memory_allocated()
    plain = host_plan("broadcast", P, n, root=BCAST_ROOT, backend="torch")
    plain_ms, plain_times = median_ms(torch, lambda: plain.run(values), 3)
    ov_ms, ov_times = median_ms(torch, lambda: plan_ov.run(values), 5)
    ov_streams = overlap_streams(torch, "broadcast_overlap", lambda: plan_ov.run(values))
    zeros_ms = cuda_ms(torch, lambda: torch.zeros((P, n + 1, bs),
                                                  device="cuda"), 3)
    upload_ms = cuda_ms(torch, lambda: vals_dev.copy_(torch.from_numpy(values)), 3)
    # Each step of the round loop, run over the plan's own skips and slot
    # rows on a buffer of the path's shape, one CUDA-event timing per step.
    recv_d, send_d = plan.device_slots
    work = torch.zeros((P, n + 1, bs), device="cuda")
    msg = torch.randn((P, bs), generator=g, device="cuda")

    def rolls():
        for s in plan.skips:
            torch.roll(msg, s, dims=0)

    def shuffles():
        for t in range(rounds - 1):
            bp.block_shuffle(work, msg, recv_d[t], send_d[t + 1])

    step_ms = {
        "pack": cuda_ms(torch, lambda: bp.block_pack(work, send_d[0]), 5),
        "roll": cuda_ms(torch, rolls, 1),
        "shuffle": cuda_ms(torch, shuffles, 1),
        "unpack": cuda_ms(torch, lambda: bp.block_unpack(work, msg, recv_d[-1]), 5),
    }
    del work, msg

    row = bs * 4
    bytes_moved, coincide = bcast_bytes(P, n, rounds, row, *plan.slots,
                                        upload_rows=1)
    bcast_bound_bytes = sum(bytes_moved.values())
    # The overlapped loop packs the next send block each round as well.
    ov_bytes = bcast_bound_bytes + (rounds - 1) * 2 * P * row
    emit({"phase": "broadcast", "p": P, "n": n, "bs": bs, "rounds": rounds,
          "root": BCAST_ROOT, "payload_bytes": PAYLOAD_BYTES,
          "buffer_bytes": P * (n + 1) * row,
          "launches": {k: launches[k] for k in
                       ("block_pack", "block_shuffle", "block_unpack")},
          "all_ranks_hold_payload": True, "equal_to_torch_backend": True,
          "ms": bcast_ms, "ms_runs": times,
          "plain_ms": plain_ms, "plain_ms_runs": plain_times,
          "bytes_moved": bcast_bound_bytes, "bytes_by_step": bytes_moved,
          "bytes_bound_ms": ms_of_bytes(bcast_bound_bytes),
          "shuffle_rows_recv_eq_next_send": coincide,
          "breakdown_ms": {"zero_fill": zeros_ms, "root_upload": upload_ms,
                           **step_ms},
          "max_memory_allocated": peak_bytes,
          "card": card})
    emit({"phase": "broadcast_overlap", "p": P, "n": n, "rounds": rounds,
          "launches": {"block_pack": rounds, "block_shuffle_staged": rounds - 1,
                       "block_unpack": 1},
          "equal_to_sequential": True, "ms": ov_ms, "ms_runs": ov_times,
          "sequential_ms": bcast_ms, "bytes_bound_ms": ms_of_bytes(ov_bytes),
          "streams": ov_streams, "card": card})
    del vals_dev
    torch.cuda.empty_cache()

    # 5. reduce, max, overlapped reduce and allreduce (contributions on the card)
    R = num_rounds(P, n_red)
    torch.cuda.reset_peak_memory_stats()
    contrib = torch.randint(-8, 9, (P, n_red, bs_red), generator=g,
                            device="cuda", dtype=torch.float32)
    contrib.view(P, -1)[:, elems:] = 0           # the last block's padding
    plan_r = host_plan("reduce", P, n_red, root=BCAST_ROOT, op="sum")
    out, got = counted_run(torch, kmods, lambda: plan_r.run(contrib))
    check(got == {"block_acc_shuffle": R + 1},
          f"reduce launches {got} != {{'block_acc_shuffle': {R + 1}}}")
    launches["block_acc_shuffle"] = got["block_acc_shuffle"]
    exact = contrib.sum(0)
    check(torch.equal(out[BCAST_ROOT], exact), "reduce: root != values.sum(0)")
    check(all_equal_to(torch, out[:BCAST_ROOT], 0)
          and all_equal_to(torch, out[BCAST_ROOT + 1:], 0),
          "reduce: a non-root rank was not drained to 0")
    root_rows = out[BCAST_ROOT].clone()
    del out
    plan_rov = host_plan("reduce", P, n_red, root=BCAST_ROOT, op="sum",
                         overlap=True)
    out, got = counted_run(torch, kmods, lambda: plan_rov.run(contrib))
    expect = {"block_acc_shuffle": 1, "block_pack": R,
              "block_acc_shuffle_staged": R}
    check(got == expect, f"overlapped reduce launches {got} != {expect}")
    launches["block_acc_shuffle_staged"] = got["block_acc_shuffle_staged"]
    # Sequential non-root rows are all +0 (checked above), so this is the
    # whole result compared bit for bit.
    check(same_bits(torch, out[BCAST_ROOT], root_rows)
          and all(same_bits(torch, out[r], torch.zeros_like(root_rows))
                  for r in range(P) if r != BCAST_ROOT),
          "overlapped reduce != sequential")
    del out, root_rows
    red_ms, red_times = median_ms(torch, lambda: plan_r.run(contrib), 5)
    red_peak = torch.cuda.max_memory_allocated()
    red_ov_ms, red_ov_times = median_ms(torch, lambda: plan_rov.run(contrib), 5)
    red_ov_streams = overlap_streams(torch, "reduce_overlap",
                                     lambda: plan_rov.run(contrib))
    plan_r_plain = host_plan("reduce", P, n_red, root=BCAST_ROOT, op="sum",
                             backend="torch")
    red_plain_ms, red_plain_times = median_ms(
        torch, lambda: plan_r_plain.run(contrib), 3)

    # allreduce: reduce to the root, then broadcast the root's blocks
    plan_b = host_plan("broadcast", P, n_red, root=BCAST_ROOT)

    def allreduce():
        return plan_b.run(plan_r.run(contrib)[BCAST_ROOT].clone())

    torch.cuda.empty_cache()
    out, got = counted_run(torch, kmods, allreduce)
    expect = {"block_acc_shuffle": R + 1, "block_pack": 1,
              "block_shuffle": R - 1, "block_unpack": 1}
    check(got == expect, f"allreduce launches {got} != {expect}")
    for i in range(0, P, 64):
        j = min(i + 64, P)
        check(torch.equal(out[i:j], exact.expand(j - i, n_red, bs_red)),
              f"allreduce: ranks {i}..{j - 1} do not hold values.sum(0)")
    del out
    allred_ms, allred_times = median_ms(torch, allreduce, 5)
    allred_peak = torch.cuda.max_memory_allocated()
    del exact
    torch.cuda.empty_cache()

    # standard-normal contributions: cuda == torch, bit for bit
    contrib.normal_(generator=g)
    contrib.view(P, -1)[:, elems:] = 0
    root_rows = plan_r.run(contrib)[BCAST_ROOT].clone()
    torch.cuda.empty_cache()
    plain_root = plan_r_plain.run(contrib)[BCAST_ROOT].clone()
    check(same_bits(torch, root_rows, plain_root),
          "reduce: cuda backend != torch backend on normal contributions")
    del root_rows, plain_root
    torch.cuda.empty_cache()
    plan_max = host_plan("reduce", P, n_red, root=BCAST_ROOT, op="max")
    out, got = counted_run(torch, kmods, lambda: plan_max.run(contrib))
    check(got == {"block_acc_shuffle": R + 1}, f"max launches {got}")
    check(torch.equal(out[BCAST_ROOT], contrib.amax(0)),
          "reduce max: root != values.amax(0)")
    check(all_equal_to(torch, out[:BCAST_ROOT], float("-inf"))
          and all_equal_to(torch, out[BCAST_ROOT + 1:], float("-inf")),
          "reduce max: a non-root rank was not drained to -inf")
    del out, contrib
    torch.cuda.empty_cache()

    # breakdown of one reduce, each step timed alone over the plan's own
    # skips and slot rows on a buffer of the path's shape
    row_r = bs_red * 4
    work = torch.zeros((P, n_red + 2, bs_red), device="cuda")
    src = torch.zeros((P, n_red, bs_red), device="cuda")
    msg = torch.randn((P, bs_red), generator=g, device="cuda")
    fwd_d, acc_d = plan_r.device_slots

    def red_fills():
        work[:, n_red].zero_()
        work[:, n_red + 1].fill_(0)

    def red_rolls():
        for s in plan_r.skips:
            torch.roll(msg, -s, dims=0)

    def acc_shuffles():
        bp.block_acc_shuffle(work, msg, fwd_d[R], fwd_d[0])
        for t in range(R):
            bp.block_acc_shuffle(work, msg, acc_d[t], fwd_d[t + 1])

    red_steps = {
        "initial_copy": cuda_ms(torch, lambda: work[:, :n_red].copy_(src), 3),
        "fills": cuda_ms(torch, red_fills, 3),
        "zero_message": cuda_ms(torch, lambda: torch.zeros((P, bs_red),
                                                           device="cuda"), 3),
        "roll": cuda_ms(torch, red_rolls, 1),
        "acc_shuffle": cuda_ms(torch, acc_shuffles, 1),
    }
    del work, src, msg
    torch.cuda.empty_cache()
    red_bytes, red_coincide = reduce_bytes(P, n_red, R, row_r, *plan_r.slots)
    red_bound = sum(red_bytes.values())
    red_ov_bound = red_bound + R * 2 * P * row_r      # + the per-round pack
    # The root's rows reach the broadcast by two device copies (the clone,
    # then into the buffer): four row transfers per block.
    bc_bytes, _ = bcast_bytes(P, n_red, R, row_r, *plan_b.slots, upload_rows=4)
    allred_bound = red_bound + sum(bc_bytes.values())
    emit({"phase": "reduce", "p": P, "n": n_red, "bs": bs_red, "rounds": R,
          "root": BCAST_ROOT, "op": "sum", "payload_bytes": PAYLOAD_BYTES,
          "buffer_bytes": P * (n_red + 2) * row_r,
          "contribution_bytes": P * n_red * row_r,
          "launches": {"block_acc_shuffle": R + 1},
          "root_equals_exact_sum": True, "non_roots_drained": True,
          "equal_to_torch_backend_on_normal_values": True,
          "max_root_equals_amax": True, "max_non_roots_drained": True,
          "ms": red_ms, "ms_runs": red_times,
          "plain_ms": red_plain_ms, "plain_ms_runs": red_plain_times,
          "bytes_moved": red_bound, "bytes_by_step": red_bytes,
          "bytes_bound_ms": ms_of_bytes(red_bound),
          "acc_rows_acc_eq_fwd": red_coincide,
          "breakdown_ms": red_steps,
          "max_memory_allocated": red_peak, "card": card})
    emit({"phase": "reduce_overlap", "p": P, "n": n_red, "rounds": R,
          "launches": {"block_acc_shuffle": 1, "block_pack": R,
                       "block_acc_shuffle_staged": R},
          "equal_to_sequential": True, "ms": red_ov_ms,
          "ms_runs": red_ov_times, "sequential_ms": red_ms,
          "bytes_bound_ms": ms_of_bytes(red_ov_bound), "streams": red_ov_streams,
          "card": card})
    emit({"phase": "allreduce", "p": P, "n": n_red, "rounds": 2 * R,
          "root": BCAST_ROOT, "op": "sum",
          "launches": {"block_acc_shuffle": R + 1, "block_pack": 1,
                       "block_shuffle": R - 1, "block_unpack": 1},
          "every_rank_holds_exact_sum": True,
          "ms": allred_ms, "ms_runs": allred_times,
          "bytes_bound_ms": ms_of_bytes(allred_bound),
          "max_memory_allocated": allred_peak, "card": card})

    # 6. allgather, sequential and overlapped
    n_ag = optimal_num_blocks_allgather(P, P * GATHER_BYTES, DEFAULT_MODEL)
    ag_elems = GATHER_BYTES // 4
    bs_ag = math.ceil(ag_elems / n_ag)
    R_ag = num_rounds(P, n_ag)
    t0 = time.perf_counter()
    plan_ag = host_plan("allgather", P, n_ag)
    plan_s = time.perf_counter() - t0
    vals_ag = torch.zeros((P, n_ag, bs_ag), device="cuda")
    vals_ag.view(P, -1)[:, :ag_elems] = torch.randn(
        (P, ag_elems), generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    out, got = counted_run(torch, kmods, lambda: plan_ag.run(vals_ag))
    expect = {"block_pack": 1, "block_shuffle": R_ag - 1, "block_unpack": 1}
    check(got == expect, f"allgather launches {got} != {expect}")
    ag_launches = {"allgather": got}
    for i in range(0, P, 64):
        j = min(i + 64, P)
        check(torch.equal(out[i:j], vals_ag.expand(j - i, P, n_ag, bs_ag)),
              f"allgather: ranks {i}..{j - 1} do not hold every rank's blocks")
    plain_ag = host_plan("allgather", P, n_ag, backend="torch")
    out_plain = plain_ag.run(vals_ag)
    check(same_bits(torch, out, out_plain), "allgather: cuda backend != torch backend")
    del out_plain
    torch.cuda.empty_cache()
    plan_agov = host_plan("allgather", P, n_ag, overlap=True)
    out_ov, got = counted_run(torch, kmods, lambda: plan_agov.run(vals_ag))
    expect = {"block_pack": R_ag, "block_shuffle_staged": R_ag - 1,
              "block_unpack": 1}
    check(got == expect, f"overlapped allgather launches {got} != {expect}")
    ag_launches["allgather_overlap"] = got
    check(same_bits(torch, out_ov, out), "overlapped allgather != sequential")
    del out, out_ov
    torch.cuda.empty_cache()
    ag_ms, ag_times = median_ms(torch, lambda: plan_ag.run(vals_ag), 5)
    ag_peak = torch.cuda.max_memory_allocated()
    ag_ov_ms, ag_ov_times = median_ms(torch, lambda: plan_agov.run(vals_ag), 5)
    ag_ov_streams = overlap_streams(torch, "allgather_overlap",
                                    lambda: plan_agov.run(vals_ag))
    ag_plain_ms, ag_plain_times = median_ms(torch, lambda: plain_ag.run(vals_ag), 3)
    rows_ag, row_ag = P * P, bs_ag * 4
    recv_rows, send_rows = plan_ag.device_slots
    idx = rows_ag * 4                                   # one int32 slot vector
    ag_bytes, ag_coincide = allgather_bytes(P, n_ag, R_ag, row_ag, recv_rows,
                                            send_rows)
    ag_bound = sum(ag_bytes.values())
    ag_ov_bound = ag_bound + (R_ag - 1) * (2 * rows_ag * row_ag + idx)
    # the four copy kernels alone at the allgather's 192-byte rows, over the
    # plan's own slot rows: bit-exact against plain, then timed a launch
    short, short_check = copy_kernels_at(torch, bp, ref, g, *plan_ag.device_slots,
                                         n_ag + 1, bs_ag)
    torch.cuda.empty_cache()
    # and at 1 KiB rows, which take the row x chunk grid: a buffer of the
    # same bytes, over the first rows of the plan's slot rows
    rows_1k = rows_ag * bs_ag // KIB_BS
    wide, wide_check = copy_kernels_at(
        torch, bp, ref, g, recv_rows[:, :rows_1k], send_rows[:, :rows_1k],
        n_ag + 1, KIB_BS)
    torch.cuda.empty_cache()
    for name, rec in short.items():
        rec.update(kernel=name, path=AG_PATH_OF[name], rows=rows_ag, row_bytes=row_ag)
        launches[f"{name}@allgather"] = ag_launches[AG_PATH_OF[name]][name]
        kern[f"{name}@allgather"] = rec
    emit({"phase": "allgather", "p": P, "n": n_ag, "bs": bs_ag,
          "rounds": R_ag, "bytes_per_rank": GATHER_BYTES,
          "buffer_bytes": rows_ag * (n_ag + 1) * row_ag,
          "plan_build_s": plan_s, "launches": {
              "block_pack": 1, "block_shuffle": R_ag - 1, "block_unpack": 1},
          "every_rank_holds_every_block": True,
          "equal_to_torch_backend": True,
          "ms": ag_ms, "ms_runs": ag_times,
          "plain_ms": ag_plain_ms, "plain_ms_runs": ag_plain_times,
          "bytes_moved": ag_bound, "bytes_by_step": ag_bytes,
          "bytes_bound_ms": ms_of_bytes(ag_bound),
          "shuffle_rows_recv_eq_next_send": ag_coincide,
          "kernels_at_these_rows": short, "kernels_checked_at": short_check,
          "kernels_at_1KiB_rows": {"shape": [rows_1k, n_ag + 1, KIB_BS],
                                   "checked_at": wide_check, **wide},
          "max_memory_allocated": ag_peak, "card": card})
    emit({"phase": "allgather_overlap", "p": P, "n": n_ag, "rounds": R_ag,
          "launches": {"block_pack": R_ag, "block_shuffle_staged": R_ag - 1,
                       "block_unpack": 1},
          "equal_to_sequential": True, "ms": ag_ov_ms,
          "ms_runs": ag_ov_times, "sequential_ms": ag_ms,
          "bytes_bound_ms": ms_of_bytes(ag_ov_bound), "streams": ag_ov_streams,
          "card": card})
    del vals_ag
    torch.cuda.empty_cache()

    # 7. the quantized allreduce of one 4 MiB gradient bucket, two steps
    #    with error feedback
    spec = make_bucket_spec({k: {n_: torch.empty(sh, device="meta")
                                 for n_, sh in d.items()}
                             for k, d in QKV_SHAPES.items()}, BUCKET_BYTES)
    check(spec.num_buckets == 1, f"{spec.num_buckets} buckets, expected 1")
    (q_elems,) = spec.bucket_sizes
    n_q = min(optimal_num_blocks_reduce(P, q_elems, DEFAULT_MODEL),
              -(-q_elems // QBLOCK))
    bs_q = -(-(-(-q_elems // n_q)) // QBLOCK) * QBLOCK
    nb_q = bs_q // QBLOCK
    R_q = num_rounds(P, n_q)

    kern["block_qacc_shuffle"] = compare_qacc(
        torch, bp, ref, qops, g, P, n_q + 2, QBLOCK, nb_q, timed=True)
    emit({"phase": "kernels_vs_plain", "shape": [P, n_q + 2, bs_q],
          "qblock": QBLOCK, "equal": True, "nan_by_position": True,
          "max_abs_diff": {"block_qacc_shuffle":
                           kern["block_qacc_shuffle"]["max_abs_err"]}})
    odd = compare_qacc(torch, bp, ref, qops, g, *ODD_Q, timed=False)
    emit({"phase": "kernels_vs_plain", "shape": [ODD_Q[0], ODD_Q[1],
                                                 ODD_Q[2] * ODD_Q[3]],
          "qblock": ODD_Q[2], "equal": True, "nan_by_position": True,
          "max_abs_diff": {"block_qacc_shuffle": odd["max_abs_err"]}})
    torch.cuda.empty_cache()

    def grads_as_bucket():
        """Each rank's q/k/v gradients (a tree per rank), bucketed as
        the trainer buckets them and zero-padded to n blocks."""
        leaves, treedef = tree_flatten(
            {k: {n_: torch.empty(sh, device="meta") for n_, sh in d.items()}
             for k, d in QKV_SHAPES.items()})
        per_leaf = [torch.randn((P, *x.shape), generator=g, device="cuda")
                    * 1e-3 for x in leaves]
        vals = torch.zeros((P, n_q * bs_q), device="cuda")
        for r in range(P):
            vals[r, :q_elems] = bucketize(
                tree_unflatten(treedef, [x[r] for x in per_leaf]), spec)[0]
        return vals.view(P, n_q, bs_q), tree_unflatten(
            treedef, [x[0].clone() for x in per_leaf])

    def completeness(vals, out, err):
        """max |sum(values) - (out + sum(err))| and whether it is within
        the reference test's tolerance (f64 sums)."""
        exact = torch.zeros(vals.shape[1:], dtype=torch.float64, device="cuda")
        esum, vmax = torch.zeros_like(exact), torch.zeros_like(exact)
        for i in range(0, P, 64):
            exact += vals[i:i + 64].double().sum(0)
            esum += err[i:i + 64].double().sum(0)
            vmax = torch.maximum(vmax, vals[i:i + 64].double().abs().amax(0))
        resid = (out[0].double() + esum - exact).abs()
        tol = 1e-4 * torch.maximum(exact.abs(), vmax * P) + 1e-7
        return float(resid.max()), bool((resid <= tol).all())

    expect_q = {"block_qacc_shuffle": R_q + 1, "block_pack": 2,
                "block_shuffle": 2 * (R_q - 1), "block_unpack": 2}
    plan_q = host_plan("quantized_allreduce", P, n_q, root=BCAST_ROOT,
                       qblock=QBLOCK)
    plain_q = host_plan("quantized_allreduce", P, n_q, root=BCAST_ROOT,
                        qblock=QBLOCK, backend="torch")
    check(len(plan_q.ks) == R_q, f"quantized rounds {len(plan_q.ks)} != {R_q}")
    torch.cuda.reset_peak_memory_stats()
    vals, tree0 = grads_as_bucket()
    steps = []
    for step_no in (1, 2):
        (out, err), got = counted_run(torch, kmods, lambda: plan_q.run(vals))
        check(got == expect_q,
              f"quantized allreduce step {step_no} launches {got} != {expect_q}")
        launches["block_qacc_shuffle"] = got["block_qacc_shuffle"]
        check(tuple(out.shape) == (P, n_q, bs_q) and tuple(err.shape) == (P, n_q, bs_q),
              f"quantized result shapes {tuple(out.shape)}, {tuple(err.shape)}")
        check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(err).all()),
              f"quantized step {step_no}: non-finite sums or errors")
        for i in range(0, P, 64):
            j = min(i + 64, P)
            check(same_bits(torch, out[i:j], out[0].expand(j - i, n_q, bs_q)),
                  f"quantized step {step_no}: ranks {i}..{j - 1} differ from rank 0")
        resid, within = completeness(vals, out, err)
        check(within, f"quantized step {step_no}: sums + errors miss the exact "
                      f"sum by {resid}")
        torch.cuda.empty_cache()
        pout, perr = plain_q.run(vals)
        check(same_or_nan(torch, out, pout) and same_or_nan(torch, err, perr),
              f"quantized step {step_no}: cuda backend != torch backend")
        del pout, perr
        steps.append({"step": step_no, "launches": got,
                      "completeness_max_abs": resid})
        if step_no == 1:
            g2, _ = grads_as_bucket()
            vals = g2 + err                 # error feedback: g2 + err1
            del g2, out, err
            torch.cuda.empty_cache()
    mean, deltas = unbucketize([out[0].reshape(-1)[:q_elems] / P], spec, tree0)
    check([tuple(x.shape) for x in tree_flatten(mean)[0]]
          == [tuple(x.shape) for x in tree_flatten(tree0)[0]]
          and bool((deltas[0] == 0).all()), "unbucketize of the mean")
    q_peak = torch.cuda.max_memory_allocated()
    del out, err, mean, deltas, tree0
    torch.cuda.empty_cache()
    q_ms, q_times = median_ms(torch, lambda: plan_q.run(vals), 5)
    q_plain_ms, q_plain_times = median_ms(torch, lambda: plain_q.run(vals), 3)

    # breakdown: each step of one call timed alone, over the plan's own
    # skips and slot rows on buffers of the path's shapes
    fwd_q, acc_q, recv_q, send_q = plan_q.device_slots
    red_skips, bc_skips = plan_q.skips
    work = torch.zeros((P, n_q + 2, bs_q), device="cuda")
    werr = torch.zeros_like(work)
    qmsg = torch.zeros((P, bs_q), dtype=torch.int8, device="cuda")
    smsg = torch.zeros((P, nb_q), device="cuda")
    qbuf = torch.zeros((P, n_q + 1, bs_q), dtype=torch.int8, device="cuda")
    sbuf = torch.zeros((P, n_q + 1, nb_q), device="cuda")

    def q_setup():
        b = torch.empty((P, n_q + 2, bs_q), device="cuda")
        b[:, :n_q] = vals
        b[:, n_q:].zero_()
        torch.zeros_like(b)

    def q_qaccs():
        bp.block_qacc_shuffle(work, werr, qmsg, smsg, fwd_q[R_q], fwd_q[0])
        for t in range(R_q):
            bp.block_qacc_shuffle(work, werr, qmsg, smsg, acc_q[t], fwd_q[t + 1])

    def q_rolls():
        for s_ in red_skips:
            torch.roll(qmsg, -s_, dims=0)
            torch.roll(smsg, -s_, dims=0)

    def q_root():
        d = work[BCAST_ROOT, :n_q].reshape(n_q * nb_q, QBLOCK)
        q_, s_ = qops.quant_blocks(d)
        werr[BCAST_ROOT, :n_q] += qops.quant_error(d, q_, s_).view(n_q, bs_q)

    def q_bcast():
        qb_ = torch.zeros((P, n_q + 1, bs_q), dtype=torch.int8, device="cuda")
        sb_ = torch.zeros((P, n_q + 1, nb_q), device="cuda")
        forward_rounds(plan_q.step, [qb_, sb_], [(recv_q, send_q)] * 2,
                       bc_skips, roll_rows)

    def q_dequant():
        o = qbuf[:, :n_q].float().view(P, n_q, nb_q, QBLOCK)
        o.mul_(sbuf[:, :n_q, :, None])

    q_steps = {"setup": cuda_ms(torch, q_setup, 3),
               "qacc_shuffle": cuda_ms(torch, q_qaccs, 1),
               "reduce_rolls": cuda_ms(torch, q_rolls, 1),
               "root_requantize": cuda_ms(torch, q_root, 3),
               "broadcast_rounds": cuda_ms(torch, q_bcast, 1),
               "dequantize": cuda_ms(torch, q_dequant, 3)}
    del work, werr, qbuf, sbuf, vals
    torch.cuda.empty_cache()

    row_q = bs_q * 4
    q_bytes, q_coincide = quantized_bytes(P, n_q, R_q, bs_q, nb_q, plan_q.slots,
                                          n_q * bs_q)
    q_bound = sum(q_bytes.values())
    emit({"phase": "quantized_allreduce", "p": P, "n": n_q, "bs": bs_q,
          "qblock": QBLOCK, "rounds": 2 * R_q, "root": BCAST_ROOT,
          "bucket_elems": q_elems, "bucket_bytes": BUCKET_BYTES,
          "leaves": {k: {n_: list(sh) for n_, sh in d.items()}
                     for k, d in QKV_SHAPES.items()},
          "buffer_bytes": P * (n_q + 2) * row_q,
          "launches": expect_q, "steps": steps,
          "every_rank_identical": True, "equal_to_torch_backend": True,
          "sums_plus_errors_complete": True,
          "ms": q_ms, "ms_runs": q_times,
          "plain_ms": q_plain_ms, "plain_ms_runs": q_plain_times,
          "bytes_moved": q_bound, "bytes_by_step": q_bytes,
          "bytes_bound_ms": ms_of_bytes(q_bound),
          "qacc_rows_acc_eq_fwd": q_coincide,
          "breakdown_ms": q_steps,
          "max_memory_allocated": q_peak, "card": card})

    # 7b. the communicator's quantized_allreduce of the same bucket, one
    #     leaf and the 6-leaf q/k/v pytree
    del qmsg, smsg
    torch.cuda.empty_cache()
    qcomm = comm_quantized_phase(torch, np, card, kmods, g, {
        "plan": plan_q, "make": grads_as_bucket, "n": n_q, "bs": bs_q,
        "elems": q_elems, "ms": q_ms, "bound_ms": ms_of_bytes(q_bound)})

    # 8. the two-level host plans at 36 x 32
    del plan_q, plain_q
    torch.cuda.empty_cache()
    flat_ms = {"broadcast": bcast_ms, "reduce": red_ms, "allreduce": allred_ms,
               "allgather": ag_ms}
    hier, hier_ms = hier_phases(torch, np, card, kmods, g, flat_ms)
    torch.cuda.empty_cache()

    # 8b. the two-level communicator over StackedGrid(36, 32)
    hiercomm = hiercomm_phases(torch, np, card, kmods, g, hier_ms)

    # 9. the plan/execute communicator over the 1152 ranks, pytree payloads
    comm, acc_recs = comm_phases(torch, np, card, kmods, g, flat_ms)
    for name, rec in acc_recs.items():
        launches[f"{name}@reduce_scatter"] = comm[rec["path"]][name]
        kern[f"{name}@reduce_scatter"] = rec
    comm.update(qcomm)
    torch.cuda.empty_cache()

    # 9b. Qwen2-0.5B: the compressed sync of its gradient, the trainer
    train = train_phases(torch, np, card, kmods, g)
    torch.cuda.empty_cache()

    # 9e. the static analysis: the CLI's passes, the plans above, the
    #     kernels' write-set probe and its negative control
    analysis_phase(torch, card)
    torch.cuda.empty_cache()

    # 10-13. the model kernels, zamba2-2.7b's prefill and the serve loop;
    #        the collectives' cached plans (their device slot tables, ~6 GB
    #        at p = 1152) are not used past this point
    plan_cache_clear()
    torch.cuda.empty_cache()

    # 9c. Qwen2-0.5B through the training launcher: train, save, resume
    train["train_launch"] = train_launch_phase(torch, np, card, kmods,
                                               train["train_step"])
    torch.cuda.empty_cache()

    # 9d. whisper-small and llama-3.2-vision-11b (one super-block) train
    train["train_encdec"] = memory_train_phases(torch, np, card, kmods)
    torch.cuda.empty_cache()

    model_phases(torch, np, card, kmods, g, launches, kern, ptx)

    # 13a. qwen2-0.5b, granite-3-2b, h2o-danube-1.8b, mamba2-780m and
    #      stablelm-12b: prefill, decode and the f32 check
    zoo_phases(torch, np, card, kmods, launches, kern)

    # 13b. llama-3.2-vision-11b and whisper-small: prefill and decode
    memory_model_phases(torch, np, card, kmods, launches, kern)

    # 13c. deepseek-moe-16b: prefill and decode
    moe_phases(torch, np, card, kmods, launches, kern)

    # 13d. deepseek-v3-671b cut to 2 layers: MLA prefill, absorbed decode,
    #      the f32 check; then the training loss with its MTP term
    moe_phases(torch, np, card, kmods, launches, kern, arch=MLA_ARCH,
               layers=MLA_LAYERS, f32_layers=MLA_F32_LAYERS, f32_seq=MLA_F32_SEQ,
               rtol=MLA_PREFILL_RTOL)
    mtp_loss_phase(torch, np, card, kmods)

    # 13e. the dry run, its counts against this run's, ALPHA, the examples
    dryrun_phase(torch, card)

    # 14. the whole run's wall time, then the kernels line, each kernel
    #     with the launch count of its path
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start, "card": card})
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": SOURCES.get(rec.get("kernel", name), KERNEL_SOURCE),
         "replaces": REPLACES[rec.get("kernel", name)],
         "path": rec.get("path", PATH_OF.get(name)),
         "launches": launches[name],
         "max_abs_err": rec["max_abs_err"],
         "ms": rec["ms"], "plain_ms": rec["plain_ms"],
         "bound_ms": rec["bound_ms"], "bound_by": rec.get("bound_by", "bytes"),
         "library_ms": rec["library_ms"],
         **({"hier_launches": {ph: c[name] for ph, c in hier.items() if name in c}}
            if any(name in c for c in hier.values()) else {}),
         **({"hiercomm_launches": {ph: c[name] for ph, c in hiercomm.items()
                                   if name in c}}
            if any(name in c for c in hiercomm.values()) else {}),
         **({"comm_launches": {ph: c[name] for ph, c in comm.items() if name in c}}
            if any(name in c for c in comm.values()) else {}),
         **({"train_launches": {ph: c[name] for ph, c in train.items() if name in c}}
            if any(name in c for c in train.values()) else {})}
        for name, rec in kern.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
