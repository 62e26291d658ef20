"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the torch / CUDA versions and the card's name and power limit.
2. Builds the CUDA kernels of soccerdiffusion_tpu_torch/csrc (nvcc, sm_90a)
   and reads the library's SASS (cuobjdump -sass): every instance of the
   ViT-block, encoder-stack, decoder-layer, tdot, chunk-sampler, denoiser
   and context-encoder kernels and every bf16 instance of the flash kernels
   must hold tensor-core instructions (HMMA / HGMMA), the chunk sampler's
   and the denoiser's head_dim-128 instances among them; the fp32 flash
   instances are logged as scalar. Holds the Python mirror of the decoder
   kernels' shared-memory plan (ops/fused_denoise.py:pass_smem_bytes, which
   their shape checks use) equal to the C function (sd_pass_smem_bytes)
   over head_dim 32 / 64 / 128, 2 / 4 / 8 layers, S from 0 to 1023, every
   block size, one block and a cluster, both kernels' carries; and the int8
   chunk kernel's (fused_chunk.py:int8_smem_bytes, sd_int8_smem_bytes).
3. Holds each serving kernel against its plain PyTorch version on the card
   at the h128 serving path's shapes (S=301 context tokens, 30 DDIM steps,
   B=64 and B=1024; bf16 weights from a seeded flax-layout random init) and
   times both with CUDA events; the denoiser's context K/V pack kernel
   (pack_context_kv) too, bit for bit its plain version.
4. Drives the proprioceptive serving loop through
   RolloutEngine.make_rollout_fn at the bench configuration (default.yaml
   architecture without images, bf16, B=1024): 5 replan periods of 30-step
   DDIM with the fused encoder + chunk kernels, 5 of the 1-step distilled
   student through the fused denoiser, then 5 of 30-step DDIM through the
   per-step denoiser (fused=True: 30 denoiser launches a period), with
   every launch counter zeroed just before and read just after each; then
   checks a short rollout of the kernel path against the same engine's
   plain versions on the CPU.
5. Holds the training kernels (fused encoder stack and fused decoder layer,
   forward and backward) against their plain versions at the training
   shapes (T=100 / L=2 encoder stacks, T=10 x S=302 decoder layers) at B=64
   and B=256: the output, the input gradients and every weight gradient.
6. Trains through training/train.py's loop (synthetic data, the bench
   configuration with encoder_fused_stack and decoder_fused_block, bf16,
   B=64, 20 steps) with the four training counters zeroed just before and
   read just after, then the same loop with both knobs off; then 3 steps
   on the card against the same 3 steps on the CPU (plain versions).
7. The camera-conditioned flagship (vit_flagship.yaml's model, built in
   code: h256, 4 heads of 64, the 8-block width-256 ViT over 224 px frames
   in 64 patches of 28 px, quick GELU, bf16): holds the fused ViT block,
   the head_dim-64 chunk, denoiser and encoder-stack-forward instances and
   the image-frame stack's head_dim-32 forward against their plain versions
   at B=64 and B=256 robots (2 frames per robot for the ViT), and the ViT
   block at the raw-frame lane's 640 frames; drives 5 replan periods at
   B=64 of each of the three lanes of the JAX package's serving benchmark
   (30-step DDIM with the image-token cache, the same with raw frames, the
   distilled student with the cache) with the launch counters zeroed
   before and read after each; then 2 cached DDIM periods on the card
   against the same engine's plain versions on the CPU.
8. The flagship's training (soccerdiffusion_tpu_torch/training/configs/
   vit_flagship.yaml): holds the ViT block's backward (N=128 and N=640
   frames), the head_dim-64 encoder-stack backward (T=100, L=2), the
   image-frame stack's backward (head_dim 32, 8 heads, T=10, L=1) and the
   head_dim-64 decoder layer's forward and backward (T=10 over S=312 memory
   rows) against their plain versions at B=64 and B=256 robots (every
   output, input gradient and weight gradient); trains 20 steps through
   training/train.py on packed dummy data (uint8 frames, pre-patchified) at
   B=64 with every launch counter zeroed before and read after (exact
   launches per step checked), then 3 steps at the YAML's own B=256 (ms of
   the last step, peak device memory); then 3 steps on the card against the
   same 3 steps on the CPU (plain versions) at B=2.
9. Flash attention (ops/flash_attention.py): holds the kernel's forward
   and backward (o, dq, dk, dv) against their plain versions in fp32 and
   bf16 at the flash flagship's shapes at B=64 robots (the ViT over 640
   frames, the image-frame stack, the proprioceptive stacks, the decoder's
   self- and cross-attention), the h128 stacks' head_dim 32, the "auto"
   threshold (Tq = Tk = 256), Tk = 1536, an unaligned shape and head_dim
   48, each timed beside F.scaled_dot_product_attention's forward and one
   torch.autograd.grad through it (library_ms; the port never calls it). Then the flash flagship, vit_flagship.yaml's
   model with attention_impl="pallas" and the three fused knobs off, so
   that every attention runs the kernel: 5 replan periods of 30-step DDIM
   with the image-token cache at B=64 through RolloutEngine(fused=False)
   and 2 periods on the card against the CPU; 20 training steps through
   training/train.py on packed dummy data at B=64 and 3 card-vs-CPU steps
   at B=2; exact flash launches per period and per step, and no fused
   kernel. Phase 6 also trains the unfused h128 step with "pallas" (the
   head_dim-32 T=100 shape); every earlier path, which runs "auto" at
   shapes under its threshold, launches no flash kernel.
10. The ResNet / Swin slice. default_tpu.yaml's model (ResNet18 at 224 px
   with the spatial head, h128, bf16, remat_image_encoder "conv_only"):
   the per-frame encoder timed over 128 and 640 frames (FLOPs per ms
   against the bf16 peak); the chunk sampler, the K/V pack and the
   denoiser against their plain versions at its lanes' shape (head_dim 32,
   S=311, B=64); 5 replan periods at B=64 of each serving lane
   (cached 30-step DDIM through the chunk sampler, the same with raw
   frames, the distilled student through the denoiser and its K/V pack;
   exact launches per period, no fused encoder) and 2 cached periods on
   the card against the CPU at B=4; 20 training steps through
   training/train.py on packed whole-frame uint8 data at B=64 (no kernel
   of the port runs there: the ResNet is cuDNN's convolutions, the layers
   unfused), 3 at the YAML's B=128 with "conv_only" and with remat off
   (peak device memory of each), 3 card-vs-CPU steps at B=2 (losses,
   update norm, BatchNorm running statistics). ResNet50 and Swin-T
   forwards on the card against the CPU (float32, TF32 off) and timed in
   bf16. decoder_only.yaml's model in bf16: the chunk sampler, the K/V pack
   and the denoiser against their plain versions at S=0 context tokens
   (B=64 and 256), its two serving lanes at B=64 (exact launches) and 20
   training steps.
11. larger_model.yaml's model at full width in bf16 (hidden 512, 4 decoder
   heads of 128, 8 decoder layers, 4-layer stacks, ResNet18 at 224 px,
   S=311), flax's seeded initial weights: the chunk sampler, the K/V pack
   and the denoiser at head_dim 128 against their plain versions at B=64;
   its three serving lanes at B=64 (cached 30-step DDIM and raw frames
   through the chunk sampler, the distilled student through the denoiser
   and 8 pack launches; exact launches per period); 2 periods card vs CPU
   of the chunk lane and of the distilled lane at B=4.
12. Distillation and guidance. larger_model_distill.yaml at full width in
   bf16 (hidden 512, 8 decoder layers of head_dim 128, ResNet18 at 224 px,
   its own B=32): training/train.py trains a teacher 2 steps with
   modality_dropout 0.15, training/distill.py's CLI distills it 2 steps as
   a 1-step student, a guided 4-step student (3.0@image) and a 1-step
   student of 2 teacher draws (no kernel of the port runs there: the
   YAML's fused knobs are off); load_policy_checkpoint decodes each; each
   mode's step is timed on the teacher (median of 3 after 1, with the
   peak device memory of one step); at B=64 the
   1-step student serves on the head_dim-128 denoiser and its pack, the
   4-step student on the chunk sampler at T=4, the teacher guided
   (3.0@image, raw frames) on the plain sampler (exact launches per
   period); 3 steps of the guided 4-step mode card vs CPU in float32.
   Then vit_flagship.yaml at B=64: one step of a 4-step student with the
   counters zeroed before and read after (the teacher's encode on the ViT
   blocks and the stacks, its 30-step rollout on the decoder layers'
   forward, the student on their forward and backward; exact launches) and
   its peak device memory, the 1- and 4-step students' step times, and 3
   bf16 steps card vs CPU at B=2 (losses, update norm, the frozen
   parameters bit for bit the teacher's).
13. The recorded-data path. Writes a SQLite database with the port's
   create_schema + insert_dummy_data (2 recordings x 800 rows at 100 Hz, a
   480 px frame every 10 rows, ~110 MB) and migrates a v1 database beside
   it. The h128 fused configuration (bench_config with encoder_fused_stack
   and decoder_fused_block, bf16) from it: DeviceResidentData's batches
   equal the host-assembled ones moved to the card bit for bit; the packed
   rows' assemblers (C++ on 1 and 8 threads, numpy) timed on a B=64 batch;
   train() --db 4 steps at B=64 with --device-data and 4 without (exact
   launches of the stacks and decoder layers, fwd + bwd; step ms the median
   of 3 after 1), --decoder-pretraining 2 steps and --pretrained-decoder
   from it (the decoder equal to the checkpoint's raw parameters before
   any step), the --device-data checkpoint served at B=64 on the context
   encoder and the chunk sampler (exact launches). vit_flagship.yaml:
   from_sqlite, PackedDataset.from_windowed (480 -> 224 px once), save,
   load (memory-mapped), prepatchify, both assemblers on a B=64 batch;
   train() --db --packed 4 steps at B=64 (exact ViT / stack / decoder
   launches) and 3 steps of the loaded shard's batches card vs CPU; the cue
   head with image_encoder_lr_mult 3 on the "vision" dummy windows: 2 steps
   at B=64 (aux_cue_loss finite, two AdamW groups) and 3 steps card vs CPU.
   default_tpu.yaml streamed from the database (frames read and resized
   per window on the host): one batch's host time and 2 train() steps at
   B=64. Each time is printed beside the card's name and power limit.
14. evaluation/ and the CLI on vit_flagship.yaml (the "vision" dummy task),
   through the port's cli in-process: `db create-schema`, `dummy-data -n 2
   -s 400` and `migrate` on a fresh database, which from_sqlite reads; a
   teacher from `cli train` and a 1-step student from `cli distill`, 2 steps
   each at B=32 (exact launches); `cli report` on the card (the teacher, the
   student, --solver-row ddim10, --guidance-row 2.0@image; 64 windows, 3
   chunks, B=32): its wall time, exact ViT / stack / decoder-layer launches
   (report_launches derives them from run_report), every row finite; the
   ViT block, the encoder stacks and the decoder layers at this phase's
   shapes on the checkpoints' weights, each launch captured as the model
   makes it and held against its plain version: the student's served
   sampler on a RealtimeController's B=1 batch (10 frames of a window) and
   the teacher's encode and denoise of the report's first batch (B=32);
   then whole chunks on the card against a CPU copy of the model (plain
   versions): both served samplers at B=1 and the teacher's 30-step open
   loop at B=32; the same report at 16 windows, 2 chunks, B=8 on the card
   and on the CPU in float32 (fused knobs off: the kernels take bf16), the
   noise drawn on the CPU, every MSE, MAE and divergence value within 2%;
   `cli serve` for 3 s at 50 Hz of the teacher (ddim30) and the student on
   the simulated plant and of the student over UDP loopback against a
   UdpRobotServer thread (replans, plan p50 / p95 / max and the first
   plan, commands delivered, tick lateness p50 / p99; exact launches per
   replan, finite chunks, every tick after the first chunk arrived
   commanding the plant; each serve in its own interpreter, as deployed);
   inference.plot.sample_open_loop on the card (exact
   launches), and `cli plot` / `cli db plot-window` writing PNGs where
   matplotlib is installed, failing naming it where it is not. The
   results go under the JSON line's "evaluation" key.
15. parallel/ on two ranks that share the card over gloo (each rank its own
   interpreter, `initialize_distributed` on a free local port, NCCL being
   one rank a card), each path held against the same work in one process
   on the card (par_checks): data-parallel training (`TrainStep.__call__`,
   t / noise drawn for the global batch from the same seed) of
   proprio_fused.yaml and vit_flagship.yaml at a global B=64 (2 x 32, 3
   steps, rows 4-5 and 4-6 launching on every rank) and of default_tpu.yaml
   in float32 at B=8 (the synchronised BatchNorm): every rank's losses,
   parameters and running statistics equal, the losses within
   STEP_LOSS_TOL, the update within STEP_UPDATE_TOL and the statistics
   within TRAIN_TOL of one process; default_tpu.yaml's first forward in
   train mode before any update: every BatchNorm layer's batch mean and
   biased variance and the running statistics, channel by channel, within
   the float32 summation bound derived at BN_LAMBDA; the fleet
   (`RolloutEngine.make_sharded_rollout`, bench_config's model, ddim30 and
   distilled1, 1024 robots as 2 x 512, 2 periods, rows 1-3): each shard bit
   for bit one process's rollout over its robots with its folded
   generator; ring attention (seq=2) and tensor parallelism (model=2) on
   the h128 unfused model in float32: the forward within PAR_F32_TOL of one
   process's "xla" forward and two steps against one process; `cli train
   --mesh data=2 --device cuda:0 --dist-backend gloo` under
   torch.distributed.run for 2 steps (one checkpoint, which loads). Where
   the machine has two cards or more, the NCCL paths on two of them (below,
   --nccl); with one card it says that they did not run. Each path's times
   beside the card's name and power limit (gloo through host memory: a
   record of the path, not of NCCL).
16. Checkpoints the port did not write (checkpoint_phase): a JAX-format
   (state.msgpack, written by utils/flax_msgpack.pack from seeded
   flax-layout trees) h128 teacher with params, a different EMA and AdamW
   moments, served by load_policy: 5 ddim30 periods at B=1024 through the
   fused encoder and chunk kernels (exactly 5 + 5 launches), bit for bit
   the chunks of load_jax_params(the EMA tree), not those of the raw
   params, and the kernel path against its plain versions on the CPU; the
   same checkpoint as a distilled_decoder student through the fused
   denoiser (2 periods at B=1024) and `cli serve` at B=1 in its own
   interpreter (exact launches a replan, every tick after the first chunk
   commanding); default_tpu.yaml (ResNet18) with batch_stats and opt_state
   {} (the BatchNorm buffers bit for bit, 2 cached ddim30 periods at B=64);
   `train.py --checkpoint` from a JAX checkpoint of proprio_fused.yaml for
   3 steps (rows 4-5 forward and backward) against the same start in the
   port's format (losses and parameters within CKPT_RESUME_TOL); a
   reference-layout .pth (tests/torch_reference_policy.py) at h128,
   standard and legacy ema_model.*, through the port's
   import_torch_checkpoint (the replica's float32 output within
   CKPT_REF_TOL of scale of the port's, 2 ddim30 periods through the
   kernels); an orbax checkpoint, a truncated state.msgpack and a state.pt
   of another format each refused. Each checkpoint's MB and load seconds
   and its periods' ms beside phase 4's and the card's name and power
   limit. The results go under the JSON line's "checkpoints" key.
17. The JAX kernels' other forms (variants_phase, ~50-90 s): the int8
   context K/V chunk kernel (csrc/fused_chunk_int8.cu) against its plain
   version at h128 (S=301, 30 DDIM steps) for B=64 at R = 8, 16, 1, 2, 4
   and 32 robots a block and B=1024 at R = 8 and 16, at the flagship's
   head_dim 64 (B=64) and larger_model's head_dim 128 (B=64), R = 8 and 16:
   the kernel's record of every (step, layer) held against the plain
   quantiser and cross-attention on its own inputs (query scales bit for
   bit the block's, int8 queries exact, K/V scales and elements, the
   cross-attention's output bit for bit in CROSS_EQUAL_SHARE of it, with a
   per-robot query scale and unrounded probabilities as controls that must
   fail), the chunk after one step and 30 within INT8_RMS_SHARE of the int8
   form's own quantisation error (RMS; the bf16 kernel the control that
   must fail), and the int8 and bf16 kernels' times on the same inputs; the
   engine with fused_kv_quant="int8", fused_block_robots=16 for 5 ddim30
   periods at B=1024 (exact launches) and 2 periods card vs CPU at B=8
   (blocks of 4); fused_group_robots=4 rollouts bit for bit those of 1;
   "qstat" at h128 B=64 (kernel vs plain, one sample() launch); the
   flagship's cached ddim30 lane with int8 K/V
   and, with vit_fused_gelu "poly", 5 periods each at B=64 (exact
   launches); the ViT block under "poly" and "bf16", forward and backward
   at 128 and 640 frames against the plain versions, beside exact GELU's
   times and torch.nn's quick-GELU layer (for "bf16"); 20 flagship
   training steps with "bf16" and 4 with "poly" (exact launches a step);
   encoder_fused_block at h128: the ViT block at the proprioceptive stacks'
   shape (B=64, T=100, 4 heads of 32) forward and backward, 20 train.py
   steps (6 ViT-block forwards and 6 backwards a step) and 3 steps card vs
   CPU; larger_model's cached lane with int8 K/V (5 periods at B=64). Step
   2's SASS check also requires IMMA in every int8 instance and 8 ViT-block
   instances each way (head_dim 32 / 64 x four GELUs). The results go under
   the JSON line's "variants" key.
18. Recorded data through the port's ingest/ and the flat optimizer
   (ingest_phase, ~150-250 s): a 60 s Bit-Bots bag written by the port's
   MCAP writer without zstd (joint states, commands and IMU at 100 Hz, a 10
   Hz 640 x 480 bgr8 camera, the game state every 0.5 s; the committed zstd
   fixture imported too where zstandard imports), `cli import`, `cli pack`
   at the flagship's 224 px and `cli db recording2mcap` (exit 0, the rows
   the rates give within one, every frame the port's resize of the frame
   written; import s and rows/s, pack and export s, DB and shard MB); h128
   proprio_fused.yaml `train --db --device-data` from the imported database
   and the flagship `train --packed DIR` from the shards, 20 steps at B=64
   each with flat_optimizer on and off: the parameters bit for bit, the
   training kernels' launches a step as steps 6 and 8 count them, ms/step
   (host clock, steps 12-20) and one optimizer step's device ops
   (torch.profiler); a JAX-format flat_optimizer checkpoint and a masked
   distillation one written from seeded trees, each resumed bit for bit
   what the same start in the port's format gives; the h128 checkpoint
   trained flat from the imported data served for 5 periods at B=1024
   (exact launches). The results go under the JSON line's "ingest" key.
19. The camera ledger (ledger_phase, evaluation/ledger.py): its --fast
   --vision run at run F's widths and shapes (h128, 100-step contexts, 96
   px frames in 36 patches, the width-128 ViT of 4 heads of 32, 5 frames,
   B=64; --fast's depths and steps) in bf16 through the fused ViT-block,
   encoder-stack and decoder-layer kernels: teacher training, a guided
   (5.0@image) 2-draw 1-step student, the report with a cfg5 row and
   posterior means of 2, with every launch counter zeroed before and read
   after (rows 4-6 each launched forward and backward, no other kernel);
   the JSON holds every top-level key of docs/quality_ledger_vision_r5f.json,
   every value finite, the JAX report's sampler labels; then on the
   teacher's weights the ViT block over 320 frames (T=36, W=128), the
   T=100 and T=5 (image-sequence) stacks and the decoder layer over S=307
   at B=64, each forward and backward against its plain version and timed
   beside its torch.nn layers. The results go under the JSON line's
   "ledger" key.
20. The last modules of the JAX package (mfu_phase, examples_phase):
   training/train.py on proprio_fused.yaml and vit_flagship.yaml at B=64
   in bf16 with --device-data, 20 steps each in 4 logging windows, through
   rows 4-6 (each counter exactly the YAML's launches a step); the step's
   FLOPs the trainer logged must equal utils/profiling.py:estimate_flops of
   the config with its fused knobs off, and every metrics line's mfu lie in
   (0, 1) (against the card's bf16 peak). One flagship step under
   profiling.trace writes a Chrome trace whose CUDA kernels name the
   decoder-layer, encoder-stack and ViT-block kernels, forward and
   backward. Then every example of soccerdiffusion_tpu_torch/examples/ runs
   its main() on the card at its default arguments (fetch_data on the
   fixture bag feeding preliminary_context_robot --csv; realtime_demo also
   with --udp) to its PASS line, launching no kernel (their tiny configs
   set no fused knob); where matplotlib is missing, the two plotting
   examples must fail naming it after their data work. The launches of
   rows 4-6 in the JSON line include phase 20's; its record goes under the
   "mfu" and "examples" keys.
21. Prints one JSON line of per-kernel results, then as its last line
   {"ok": true, "device": {...}}. Where one torch.nn call computes the
   same function as a kernel (the encoder-stack, ViT-block and
   decoder-layer forwards; one torch.autograd.grad through the same layers
   for their backwards, checked against the plain backward;
   scaled_dot_product_attention for the flash forward, one autograd.grad
   through it for the flash backward), its time on the same inputs is the
   entry's library_ms; the port never calls those.

Exits non-zero, without the last line, when CUDA is unavailable or any
phase fails. Imports nothing of JAX or of the JAX package.

    python3 chip_smoke.py --profile-training [--flagship [--flash]] [--profile-out FILE]
    python3 chip_smoke.py --profile-serving [--flash | --resnet | --larger] [--profile-out FILE]
    python3 chip_smoke.py --profile-training --resnet [--profile-out FILE]
    python3 chip_smoke.py --bisect-resnet-bf16
    python3 chip_smoke.py --profile-realtime [--profile-out FILE]
    python3 chip_smoke.py --quality-ledger [--vision [--fused]] [--ledger-out DIR]
    python3 chip_smoke.py --nccl

build the kernels and instead trace, with torch.profiler, the h128 B=64
training step (fused knobs on, then off), with --flagship the flagship's
B=64 training step (packed data; with --flash the flash flagship's), or 3
replan periods of each flagship serving lane at B=64 (with --flash the
flash flagship's cached ddim30 lane; with --resnet default_tpu.yaml's
three lanes, with --larger larger_model.yaml's; --profile-training
--resnet its B=64 training step): per step or period the host wall clock,
the device busy time (the union of the device ops' intervals), the
device's idle share, both taken from the same trace, and the largest device
ops. FILE receives the full tables. --bisect-resnet-bf16 measures, without
a gate, default_tpu.yaml's bf16 training steps card vs CPU on seeded noise
frames and on the dummy frames, then holds the pieces of its ResNet18 (the
stem convolution, BatchNorm, max pool, a residual block, the whole
encoder) in bf16 on the card and on the CPU each against float64
(bisect_resnet_bf16). --profile-realtime traces 3 plans of `cli serve`'s
sampler at B=1 on the flagship (ddim30, then the distilled student).
--quality-ledger runs evaluation/ledger.py on the card: its defaults (the
h128 ledger: train 2000 steps, 4- and 1-step students distilled 400 steps
each, the report with dpmpp10@lambda and ddim10 rows over 256 windows and
10 chunks); with --vision run F's camera recipe (ledger.RUN_F: 24k teacher
steps of the depth-6 ViT model in bf16, 4- and 1-step students of the
7.0@image 8-draw teacher, 1200 steps each, the cfg5 / 7 / 9 rows and
posterior means of 8; --fused adds the three training kernels), then 4-
and 1-step students distilled from the 5.0@image 8-draw teacher and
reported beside it (DIR/quality_ledger{,_cfg5}.{json,md}, the checkpoints
in DIR/work; about 45 min on one H100). It exits 1, naming why, where a
value is not finite or, with --vision, the teacher's open-loop MSE is not
under 0.1 of the noise floor or its cfg5 posterior-mean boundary ratio
under 2x.
--nccl (a machine with two cards or more) runs phase 15's paths over NCCL,
one rank a card, on 2 ranks and on every card, each against one process:
the data-parallel steps of proprio_fused.yaml and of default_tpu.yaml in
float32 (the synchronised BatchNorm, with its first-forward statistics),
the sharded h128 fleet (ddim30, distilled1), ring attention and tensor
parallelism ({"data": N / 2, "seq" or "model": 2}), and proprio_fused.yaml
over a "dcn" x "data" mesh over LOCAL_WORLD_SIZE blocks of half the ranks
(two nodes, as torchrun sets it on two hosts). None prints the ok line.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import json
import logging
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# kernel-vs-plain tolerance on the card, as a share of the output's scale:
# max |kernel - plain| <= TOL * max |plain|. Both sides round to bf16 at the
# same points, so they differ by fp32 summation order plus the bf16
# roundings that order flips (2^-8 = 0.4% of the value each), carried
# through the layers and, for the chunk, 30 solver steps. The seeded random
# model is untrained: its eps is not unit-scale and the DDIM chunk grows to
# |x| ~ 1e3, so an absolute bound would mean nothing. Measured on an H100:
# kernel - plain ~0.5% of scale at every step count, bf16 plain - fp32
# plain ~1.4% after 30 steps (PERF.md).
TOL = 2e-2
ROLLOUT_TOL = 2e-2  # the same bound on each replan period's chunk
BENCH_B, CHUNKS = 1024, 5
# the flagship: kernel checks at B robots (2 frames each for the ViT), the
# three serving lanes at FLAG_B robots for CHUNKS periods each
FLAG_BATCHES, FLAG_B = (64, 256), 64
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core FLOP/s
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12
# training kernels: every output and weight gradient within TRAIN_TOL x
# max|plain| of that tensor (bf16 at the same rounding points, fp32 sums in
# another order); the key-bias gradients, zero in exact arithmetic, within
# TRAIN_TOL x the largest weight gradient of their layer instead
TRAIN_TOL = 2e-2
TRAIN_BATCHES, TRAIN_STEPS, TRAIN_BATCH = (64, 256), 20, 64
TRAIN_LOG_EVERY = 4  # two epochs of 10 steps: syncs at steps 4, 8 | 12, 16, 20
# 3 steps on the card vs on the CPU: the losses within 2e-2 relative; the
# parameter updates within 0.1 of the update norm (AdamW normalises each
# step to ~lr, so entries whose gradient is float noise, such as the key
# biases, take steps of either sign)
STEP_LOSS_TOL, STEP_UPDATE_TOL = 2e-2, 0.1
# the flagship's training: the ViT backward's frames (2 and 10 per robot at
# B=64), the training path's batch (the benchmark's cell) and the YAML's own
FLAG_VIT_FRAMES, FLAG_TRAIN_B, FLAG_TRAIN_FULL_B = (128, 640), 64, 256
FLAG_YAML = (Path(__file__).resolve().parent / "soccerdiffusion_tpu_torch" / "training" / "configs"
             / "vit_flagship.yaml")
# kernel launches per flagship training step: 8 ViT blocks, 3 proprioceptive
# stacks (head_dim 64) + the image-frame stack (head_dim 32), 4 decoder
# layers (head_dim 64), each forward and backward
FLAG_TRAIN_LAUNCHES = {
    "fused_vit_block_fwd": 8, "fused_vit_block_bwd": 8,
    "fused_encoder_stack_fwd": 4, "fused_encoder_stack_fwd_hd64": 3,
    "fused_encoder_stack_bwd": 4, "fused_encoder_stack_bwd_hd64": 3,
    "fused_decoder_layer_fwd": 4, "fused_decoder_layer_fwd_hd64": 4,
    "fused_decoder_layer_bwd": 4, "fused_decoder_layer_bwd_hd64": 4}
# torch.nn's layers against the plain version, only to show that they were
# built from the same weights (a wrong mapping gives errors of the order of
# the output): torch rounds the residual stream to bf16 at every sublayer
LIBRARY_TOL = 0.1
# kernels that must run on the tensor cores: every instance whose mangled
# name holds the second string (the bf16 flash instances; the others: every
# instance) has HMMA (mma.sync) or HGMMA (wgmma) instructions in its SASS
TENSOR_CORE_KERNELS = (
    ("vit_block_fwd_kernel", ""), ("vit_block_bwd_kernel", ""), ("encoder_stack_fwd_kernel", ""),
    ("encoder_stack_bwd_kernel", ""), ("tdot_kernel", ""), ("decoder_layer_fwd_kernel", ""),
    ("decoder_layer_bwd_kernel", ""), ("fused_chunk_kernel", ""), ("fused_denoise_kernel", ""),
    ("fused_chunk_kernel", "ILi128E"), ("fused_denoise_kernel", "ILi128E"),
    ("fused_chunk_int8_kernel", ""),
    ("fused_encoder_kernel", ""), ("flash_fwd_kernel", "__nv_bfloat16"),
    ("flash_bwd_dq_kernel", "__nv_bfloat16"), ("flash_bwd_dkdv_kernel", "__nv_bfloat16"))
# kernels whose every instance must hold IMMA (mma.sync on the int8 tensor
# cores): the int8 chunk's scores and value sums
IMMA_KERNELS = ("fused_chunk_int8_kernel",)
# the ViT block's instances: head_dim 32 / 64 x the four GELUs, forward and backward
VIT_INSTANCES = {"vit_block_fwd_kernel": 8, "vit_block_bwd_kernel": 8}
# kernel instances that stay scalar fp32 FMAs (logged with their counts)
SCALAR_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
# H100 SXM fp32 peak outside the tensor cores (NVIDIA data sheet): the bound
# of the flash kernel's fp32 instances
FP32_FLOPS = 67e12
# the flash kernel against its plain version, (B, Tq, Tk, H, D): the flash
# flagship's shapes at B=64 robots (the ViT over 10 frames per robot), the
# h128 stacks' head_dim 32, the "auto" threshold, the TPU kernel's streamed
# regime (Tk > 1024), an unaligned shape and head_dim 48; the first is the
# one the JSON line's flash entries time
FLASH_SHAPES = {
    "vit_640_frames": (640, 64, 64, 4, 64),
    "frame_stack": (64, 10, 10, 8, 32),
    "stacks": (64, 100, 100, 4, 64),
    "decoder_self": (64, 10, 10, 4, 64),
    "decoder_cross": (64, 10, 312, 4, 64),
    "h128_stacks": (64, 100, 100, 4, 32),
    "auto_threshold": (16, 256, 256, 4, 64),
    "tk_1536": (8, 64, 1536, 4, 64),
    "unaligned": (3, 7, 13, 2, 8),
    "head_dim_48": (2, 196, 196, 4, 48),
}


def log(*a):
    print(*a, flush=True)


def bench_config():
    from soccerdiffusion_tpu_torch.config import ModelConfig

    return ModelConfig(  # bench.py:73-90 with its defaults (patch 1, bf16)
        num_joints=20, hidden_dim=128, trajectory_prediction_length=10,
        action_context_length=100, joint_state_context_length=100, imu_context_length=100,
        use_images=False, use_gamestate=True, num_action_history_encoder_layers=2,
        num_imu_encoder_layers=2, joint_state_encoder_layers=2, num_decoder_layers=4,
        encoder_patch_size=1, compute_dtype="bfloat16")


def build_model(cfg, device, seed=1):
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params, random_jax_params

    model = DiffusionPolicy(cfg)
    return load_jax_params(model, *random_jax_params(model, seed)).to(device).eval()


def random_batch(cfg, b, device, rng):
    t = lambda a: torch.from_numpy(a).to(device)
    return {
        "joint_command_history": t(rng.uniform(0, 2 * np.pi, (b, 100, 20)).astype(np.float32)),
        "rotation": t(rng.normal(size=(b, 100, cfg.imu_input_dim)).astype(np.float32)),
        "joint_state": t(rng.uniform(0, 2 * np.pi, (b, 100, 20)).astype(np.float32)),
        "game_state": t(rng.integers(0, 4, (b,))),
    }


# ------------------------------------------------------- bounds
# The least time the card could take for a kernel's work: the larger of its
# bytes (each input read once, each output written once) over the HBM rate
# and its matmul FLOPs (bf16 operands) over the bf16 tensor-core peak.

def nbytes(*tensors) -> int:
    """Bytes of the tensors (nested lists / tuples flattened; None skipped)."""
    total = 0
    for t in tensors:
        if isinstance(t, (list, tuple)):
            total += nbytes(*t)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def bound(flops: float, io_bytes: int, peak: float = BF16_FLOPS) -> dict:
    t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ------------------------------------------------------- library calls
# torch.nn's pre-norm layers compute the same functions as the fused
# encoder-stack, ViT-block and decoder-layer forwards (with torch's own
# rounding points: a bf16 residual stream). Built here from the kernels'
# bf16 weights and timed for the library_ms column; the port never calls
# them. The fused context encoder, chunk sampler and denoiser, and the
# backward kernels, have no one-call counterpart (library_ms null).

def quick_gelu(z):
    return z * torch.sigmoid(1.702 * z)


def torch_encoder(w, num_heads: int, activation="gelu"):
    """nn.TransformerEncoderLayer (one layer) or nn.TransformerEncoder (L
    layers) on stacked (L, ...) weights in STACK_WEIGHTS order."""
    from torch import nn

    L, E, FF = w[0].shape[0], w[0].shape[-1], w[8].shape[-1]
    layers = []
    for l in range(L):
        g1, be1, wqkv, bqkv, wo, bo, g2, be2, w1, b1, w2, b2 = (t[l] for t in w)
        layer = nn.TransformerEncoderLayer(
            E, num_heads, FF, dropout=0.0, activation=activation, layer_norm_eps=1e-6,
            batch_first=True, norm_first=True, device=wqkv.device, dtype=wqkv.dtype)
        with torch.no_grad():
            for dst, src in ((layer.norm1.weight, g1), (layer.norm1.bias, be1),
                             (layer.self_attn.in_proj_weight, wqkv.t()),
                             (layer.self_attn.in_proj_bias, bqkv),
                             (layer.self_attn.out_proj.weight, wo.t()),
                             (layer.self_attn.out_proj.bias, bo),
                             (layer.norm2.weight, g2), (layer.norm2.bias, be2),
                             (layer.linear1.weight, w1.t()), (layer.linear1.bias, b1),
                             (layer.linear2.weight, w2.t()), (layer.linear2.bias, b2)):
                dst.copy_(src)
        layers.append(layer.eval())
    if L == 1:
        return layers[0]
    stack = nn.TransformerEncoder(layers[0], L, enable_nested_tensor=False)
    stack.layers = nn.ModuleList(layers)
    return stack.eval()


def torch_decoder_layer(w, num_heads: int):
    """nn.TransformerDecoderLayer on weights in WEIGHT_NAMES order (the
    memory enters the cross-attention un-normed, as in the fused layer)."""
    from torch import nn

    (g1, be1, wqkv, bqkv, wso, bso, g2, be2, wcq, bcq, wck, bck, wcv, bcv, wco, bco,
     g3, be3, w1, b1, w2, b2) = w
    E, FF = g1.shape[0], w1.shape[-1]
    layer = nn.TransformerDecoderLayer(
        E, num_heads, FF, dropout=0.0, activation="gelu", layer_norm_eps=1e-6,
        batch_first=True, norm_first=True, device=wqkv.device, dtype=wqkv.dtype)
    with torch.no_grad():
        for dst, src in ((layer.norm1.weight, g1), (layer.norm1.bias, be1),
                         (layer.self_attn.in_proj_weight, wqkv.t()),
                         (layer.self_attn.in_proj_bias, bqkv),
                         (layer.self_attn.out_proj.weight, wso.t()),
                         (layer.self_attn.out_proj.bias, bso),
                         (layer.norm2.weight, g2), (layer.norm2.bias, be2),
                         (layer.multihead_attn.in_proj_weight, torch.cat([wcq, wck, wcv], 1).t()),
                         (layer.multihead_attn.in_proj_bias, torch.cat([bcq, bck, bcv])),
                         (layer.multihead_attn.out_proj.weight, wco.t()),
                         (layer.multihead_attn.out_proj.bias, bco),
                         (layer.norm3.weight, g3), (layer.norm3.bias, be3),
                         (layer.linear1.weight, w1.t()), (layer.linear1.bias, b1),
                         (layer.linear2.weight, w2.t()), (layer.linear2.bias, b2)):
            dst.copy_(src)
    return layer.eval()


def library_ms(name, label, library_fn, ref) -> float:
    """The CUDA-event time of one library call; its output must agree with
    the plain version's ``ref`` within LIBRARY_TOL of the scale (a check that
    the layer was built from the same weights, not a tolerance of the port)."""
    with torch.no_grad():
        got = library_fn().float()
        err, scale = (got - ref.float()).abs().max().item(), ref.float().abs().max().item()
        ms = median_ms(library_fn)
    log(f"  {name} {label}: torch.nn library call {ms:.3f} ms, |library - plain| {err:.4e} "
        f"(max|plain| {scale:.4e}, tol {LIBRARY_TOL} x max|plain|)")
    if not err <= LIBRARY_TOL * scale:
        raise AssertionError(f"{name}: the torch.nn layers built for library_ms do not compute "
                             "the same function")
    return ms


def dec_zero(E: int) -> dict:
    """The decoder layer's gradients that are zero in exact arithmetic: the
    key third of the self-attention's q|k|v bias, the cross-attention's key
    bias."""
    return {"bqkv": slice(E, 2 * E), "bck": slice(None)}


def _encoder_params(layer):
    """A torch.nn encoder layer's parameters in STACK_WEIGHTS order."""
    sa = layer.self_attn
    return [layer.norm1.weight, layer.norm1.bias, sa.in_proj_weight, sa.in_proj_bias,
            sa.out_proj.weight, sa.out_proj.bias, layer.norm2.weight, layer.norm2.bias,
            layer.linear1.weight, layer.linear1.bias, layer.linear2.weight, layer.linear2.bias]


def encoder_grad_fn(w, num_heads: int, x, dy, activation="gelu", stacked=True):
    """One torch.autograd.grad through torch_encoder's layers (train mode,
    dropout 0) built from ``w`` (stacked (L, ...)), with respect to x and
    every parameter: a function returning [dx, *the 12 weight gradients in
    STACK_WEIGHTS order, stacked on L unless ``stacked`` is False (one
    layer), Dense kernels as (in, out)]."""
    mod = torch_encoder(w, num_heads, activation).train()
    layers = [mod] if w[0].shape[0] == 1 else list(mod.layers)
    params = [p for layer in layers for p in _encoder_params(layer)]
    x = x.detach().requires_grad_(True)

    def run():
        dx, *g = torch.autograd.grad(mod(x), [x, *params], dy)
        per = [g[12 * l:12 * (l + 1)] for l in range(len(layers))]
        # (out, in) weights back to the kernels' (in, out)
        grads = [torch.stack([p[i].t() if p[i].dim() == 2 else p[i] for p in per])
                 for i in range(12)]
        return [dx] + (grads if stacked else [g[0] for g in grads])

    return run


def decoder_grad_fn(w, num_heads: int, x, mem, dy):
    """One torch.autograd.grad through torch_decoder_layer (train mode,
    dropout 0) with respect to x, mem and every parameter: a function
    returning [dx, dmem, *the 22 weight gradients in WEIGHT_NAMES order]."""
    layer = torch_decoder_layer(w, num_heads).train()
    sa, ca = layer.self_attn, layer.multihead_attn
    params = [layer.norm1.weight, layer.norm1.bias, sa.in_proj_weight, sa.in_proj_bias,
              sa.out_proj.weight, sa.out_proj.bias, layer.norm2.weight, layer.norm2.bias,
              ca.in_proj_weight, ca.in_proj_bias, ca.out_proj.weight, ca.out_proj.bias,
              layer.norm3.weight, layer.norm3.bias, layer.linear1.weight, layer.linear1.bias,
              layer.linear2.weight, layer.linear2.bias]
    x, mem = x.detach().requires_grad_(True), mem.detach().requires_grad_(True)

    def run():
        (dx, dmem, g1, be1, wqkv, bqkv, wso, bso, g2, be2, wc, bc, wco, bco, g3, be3, w1, b1, w2,
         b2) = torch.autograd.grad(layer(x, mem), [x, mem, *params], dy)
        wcq, wck, wcv = (t.t() for t in wc.chunk(3, 0))
        bcq, bck, bcv = bc.chunk(3)
        return [dx, dmem, g1, be1, wqkv.t(), bqkv, wso.t(), bso, g2, be2, wcq, bcq, wck, bck, wcv,
                bcv, wco.t(), bco, g3, be3, w1.t(), b1, w2.t(), b2]

    return run


def library_bwd_ms(name, label, grad_fn, ref, names, zero) -> float:
    """The CUDA-event time of ``grad_fn`` (one torch.autograd.grad through
    the torch.nn layer); each of its gradients must agree with the plain
    backward's (``ref``: the input gradient(s), then the weight gradients
    named ``names``) within LIBRARY_TOL of that gradient's scale, the parts
    in ``zero`` (zero in exact arithmetic) within LIBRARY_TOL of the layer's
    largest weight gradient: a check that the layer was built from the same
    weights."""
    got = grad_fn()
    n_in = len(ref) - len(names)
    top = max(r.float().abs().max().item() for r in ref[n_in:])
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float(), r.float()
        key = names[i - n_in] if i >= n_in else None
        err = (g - r).abs()
        if key in zero:
            worst = max(worst, err[..., zero[key]].max().item() / top)
            err[..., zero[key]] = 0
        worst = max(worst, err.max().item() / max(r.abs().max().item(), 1e-30))
    ms = median_ms(grad_fn)
    log(f"  {name} {label}: torch.nn autograd.grad {ms:.3f} ms, max |library - plain| / scale "
        f"{worst:.4e} (tol {LIBRARY_TOL})")
    if not worst <= LIBRARY_TOL:
        raise AssertionError(f"{name}: the torch.nn layers built for library_ms do not compute "
                             "the same gradients")
    return ms


def sdpa_bwd_ms(name, label, q, k, v, do, ref) -> float:
    """The CUDA-event time of one torch.autograd.grad through
    F.scaled_dot_product_attention's output with respect to q, k and v (the
    forward run once, outside the timed call: the backward alone, as the
    flash backward kernels compute it). Its gradients must agree with the
    plain backward's (``ref``: dq, dk, dv) within LIBRARY_TOL of each one's
    scale: a check that the call computes the same function, not a
    tolerance of the port."""
    from torch.nn import functional as F

    leaves = [x.detach().transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    dout = do.transpose(1, 2)
    run = lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)
    worst = 0.0
    for g, r in zip(run(), ref):
        g, r = g.transpose(1, 2).float(), r.float()
        worst = max(worst, (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30))
    ms = median_ms(run)
    log(f"  {name} {label}: SDPA autograd.grad {ms:.3f} ms, max |library - plain| / scale "
        f"{worst:.4e} (tol {LIBRARY_TOL})")
    if not worst <= LIBRARY_TOL:
        raise AssertionError(f"{name}: scaled_dot_product_attention's gradients do not match the "
                             "plain backward")
    return ms


def attn_flops(tq, tk, e):  # scores and value sums over all heads
    return 4 * tq * tk * e


def enc_layer_flops(t, e, ff):  # pre-norm self-attention layer with an ff-wide MLP
    return 2 * t * e * 3 * e + attn_flops(t, t, e) + 2 * t * e * e + 4 * t * e * ff


def dec_layer_flops(p, s, e, ff):  # self-attention, cross-attention over s keys, MLP
    return 2 * p * e * 3 * e + attn_flops(p, p, e) + 6 * p * e * e + attn_flops(p, s, e) + 4 * p * e * ff


def decoder_pass_flops(cfg, s):  # one denoiser pass over s context keys + the step token
    p, j, e = cfg.trajectory_prediction_length, cfg.num_joints, cfg.hidden_dim
    return 4 * p * j * e + cfg.num_decoder_layers * dec_layer_flops(p, s + 1, e, e)


def median_ms(fn, reps=5, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, kernel_fn, plain_fn, b, flops, inputs, library_fn=None, tol=TOL, bnd=None):
    """Kernel vs plain version: the error (within ``tol`` x max|plain|),
    both CUDA-event times, the bound (``bnd``, or ``flops`` and the bytes of
    ``inputs`` and the kernel's output) and the time of ``library_fn``, one
    PyTorch call computing the same function."""
    got, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    out_bytes = nbytes(got)  # the output as the kernel writes it (bf16 or fp32)
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name} B={b}: shape {tuple(got.shape)} vs {tuple(ref.shape)} "
                             "or non-finite output")
    max_abs = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = max_abs <= tol * scale
    k_ms, p_ms = median_ms(kernel_fn), median_ms(plain_fn)
    bnd = bnd or bound(flops, nbytes(inputs) + out_bytes)
    log(f"{name} B={b}: max_abs_err={max_abs:.4e} max|plain|={scale:.4e} "
        f"(tol {tol} x max|plain|) kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} B={b} disagrees with its plain version")
    lib = None if library_fn is None else library_ms(name, f"B={b}", library_fn, ref)
    return {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms, **bnd, "library_ms": lib}


def merge(results, name, r):
    """Keep the largest error over the batch sizes and the last (largest)
    batch's times and bound."""
    prev = results.get(name)
    results[name] = {**r, "max_abs_err": r["max_abs_err"] if prev is None
                     else max(prev["max_abs_err"], r["max_abs_err"])}


def decoder_checks(model, context, noise, device, b, suffix=""):
    """The chunk sampler (30-step DDIM), the denoiser's K/V pack and the
    denoiser (eps and in-kernel DDIM forms) against their plain versions on
    one context."""
    from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table
    from soccerdiffusion_tpu_torch.diffusion.ddim import ddim_timesteps
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
    from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser

    cfg, S = model.config, context.shape[1]
    den, chunk = FusedDenoiser(model), FusedChunkSampler(model)
    coefs = solver_coef_table(make_schedule(1000), 30, "ddim")
    table = model.step_encoding(torch.as_tensor(ddim_timesteps(1000, 30).astype(np.int64),
                                                device=device))[:, 0]
    stk, stv = chunk.step_tables(table)
    e, L = cfg.hidden_dim, cfg.num_decoder_layers
    chunk_flops = b * (2 * S * e * 2 * L * e + 30 * decoder_pass_flops(cfg, S))
    r_chunk = compare("fused_chunk" + suffix,
                      lambda: chunk.sample_kernel(context, noise, stk, stv, coefs),
                      lambda: chunk.sample_plain(context, noise, stk, stv, coefs), b, chunk_flops,
                      [chunk.kernel_weights, context, noise, stk, stv])
    context_kv = model.precompute_context_kv(context)
    # the pack: a permutation, bit for bit the plain pack's (max_abs_err 0)
    r_pack = compare("fused_denoise_pack" + suffix, lambda: den.pack_kernel(context_kv).kv,
                     lambda: den.pack_plain(context_kv).kv, b, 0, [context_kv])
    if r_pack["max_abs_err"] != 0:
        raise AssertionError(f"the pack kernel B={b} is not the plain pack")
    packed = den.pack_context_kv(context_kv)
    ddim = [1.3, 0.8, 0.9, 0.4]  # eps form and in-kernel DDIM form
    r_den = max((compare("fused_denoise" + suffix,
                         lambda c=c: den.run_kernel(packed, noise, stk[3], stv[3], c),
                         lambda c=c: den.run_plain(packed, noise, stk[3], stv[3], c), b,
                         b * decoder_pass_flops(cfg, S),
                         [den.kernel_weights, context_kv, noise, stk[3], stv[3]])
                 for c in (None, ddim)), key=lambda r: r["max_abs_err"])
    return r_chunk, r_den, r_pack


def kernel_phase(cfg, model, device):
    from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder

    enc = FusedContextEncoder(model)
    results = {}
    for b in (64, BENCH_B):
        rng = np.random.default_rng(b)
        batch = random_batch(cfg, b, device, rng)
        with torch.no_grad():
            e = cfg.hidden_dim
            flops = b * sum(2 * st.tokens * st.in_dim * e + st.layers * enc_layer_flops(st.tokens, e, e)
                            for st in enc.stacks)
            merge(results, "fused_encoder", compare(
                "fused_encoder", lambda: enc.encode_kernel(batch), lambda: enc.encode_plain(batch), b,
                flops, [list(batch.values()), [st.weights() for st in enc.stacks], enc.gs_table]))
            context = enc.encode_plain(batch)
            noise = torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32)).to(device)
            r_chunk, r_den, r_pack = decoder_checks(model, context, noise, device, b)
        merge(results, "fused_chunk", r_chunk)
        merge(results, "fused_denoise", r_den)
        merge(results, "fused_denoise_pack", r_pack)
    return results


def engine(model, cfg, device, **kw):
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.inference import RolloutEngine

    return RolloutEngine(model, make_schedule(1000), Normalizer.identity(cfg.num_joints),
                         num_inference_steps=30, fused_encoder=kw.pop("fused_encoder", True),
                         device=device, **kw)


def zero_counters():
    """Set every kernel wrapper's launch counter to 0."""
    from soccerdiffusion_tpu_torch.ops import fused_vit_block
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
    from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import FusedDecoderLayer
    from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser
    from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder
    from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import FusedEncoderStack
    from soccerdiffusion_tpu_torch.ops.flash_attention import FlashAttention

    for c in (FusedContextEncoder, FusedChunkSampler, FusedDenoiser):
        c.launches = 0
    FusedDenoiser.pack_launches = FusedChunkSampler.int8_launches = 0
    for c in (FusedEncoderStack, FusedDecoderLayer):
        c.fwd_launches = c.bwd_launches = c.fwd_launches_hd64 = c.bwd_launches_hd64 = 0
    FusedEncoderStack.fwd_launches_hd16 = FusedEncoderStack.bwd_launches_hd16 = 0
    fused_vit_block.forward_kernel.launches = fused_vit_block.backward_kernel.launches = 0
    FlashAttention.launches = FlashAttention.backward_launches = 0


def read_counters() -> dict:
    from soccerdiffusion_tpu_torch.ops import fused_vit_block
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
    from soccerdiffusion_tpu_torch.ops.fused_decoder_layer import FusedDecoderLayer
    from soccerdiffusion_tpu_torch.ops.fused_denoise import FusedDenoiser
    from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder
    from soccerdiffusion_tpu_torch.ops.fused_encoder_stack import FusedEncoderStack
    from soccerdiffusion_tpu_torch.ops.flash_attention import FlashAttention

    return {"fused_encoder": FusedContextEncoder.launches, "fused_chunk": FusedChunkSampler.launches,
            "fused_chunk_int8": FusedChunkSampler.int8_launches,
            "fused_denoise": FusedDenoiser.launches,
            "fused_denoise_pack": FusedDenoiser.pack_launches,
            "fused_encoder_stack_fwd": FusedEncoderStack.fwd_launches,
            "fused_encoder_stack_fwd_hd64": FusedEncoderStack.fwd_launches_hd64,
            "fused_encoder_stack_bwd": FusedEncoderStack.bwd_launches,
            "fused_encoder_stack_bwd_hd64": FusedEncoderStack.bwd_launches_hd64,
            "fused_encoder_stack_fwd_hd16": FusedEncoderStack.fwd_launches_hd16,
            "fused_encoder_stack_bwd_hd16": FusedEncoderStack.bwd_launches_hd16,
            "fused_decoder_layer_fwd": FusedDecoderLayer.fwd_launches,
            "fused_decoder_layer_fwd_hd64": FusedDecoderLayer.fwd_launches_hd64,
            "fused_decoder_layer_bwd": FusedDecoderLayer.bwd_launches,
            "fused_decoder_layer_bwd_hd64": FusedDecoderLayer.bwd_launches_hd64,
            "fused_vit_block_fwd": fused_vit_block.forward_kernel.launches,
            "fused_vit_block_bwd": fused_vit_block.backward_kernel.launches,
            "flash_attention_fwd": FlashAttention.launches,
            "flash_attention_bwd": FlashAttention.backward_launches}


def no_flash(*launches):
    """The paths that run attention_impl="auto" (every path but the flash
    ones) stay under its threshold: no flash kernel may have run."""
    for got in launches:
        if got["flash_attention_fwd"] or got["flash_attention_bwd"]:
            raise AssertionError(f"a flash kernel ran on an \"auto\" path: {got}")


def timed_rollout(eng, device, seed, b=BENCH_B, periods=CHUNKS):
    """ms per replan period of a ``periods``-period rollout at B=b, and the
    launch counts of that rollout (zeroed just before, read just after)."""
    run = eng.make_rollout_fn(periods)
    carry = eng.init(b, torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    _, chunks = run(carry)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / periods
    launches = read_counters()
    cfg = eng.cfg
    if (tuple(chunks.shape) != (periods, b, eng.replan_every, cfg.num_joints)
            or not torch.isfinite(chunks).all()):
        raise AssertionError(f"bad chunks: shape {tuple(chunks.shape)}, "
                             f"finite={bool(torch.isfinite(chunks).all())}")
    return ms, launches


def main_path_phase(cfg, model, device):
    ddim30 = engine(model, cfg, device, fused="chunk")
    distilled = engine(model, cfg, device, distilled=True, fused=True)
    per_step = engine(model, cfg, device, fused=True)
    plain = engine(model, cfg, device, fused=False, fused_encoder=False)
    for eng in (ddim30, distilled, per_step, plain):  # warm-up: allocator, first launches
        eng.make_rollout_fn(1)(eng.init(BENCH_B, torch.Generator(device=device).manual_seed(0)))
    ms_ddim, l_ddim = timed_rollout(ddim30, device, 1)
    ms_dist, l_dist = timed_rollout(distilled, device, 2)
    ms_step, l_step = timed_rollout(per_step, device, 3)
    names = ("fused_encoder", "fused_chunk", "fused_denoise", "fused_denoise_pack")
    launches = {name: l_ddim[name] + l_dist[name] + l_step[name] for name in names}
    log(f"main path B={BENCH_B}, {CHUNKS} periods each: ddim30 (fused encoder + chunk kernels) "
        f"{ms_ddim:.2f} ms/period; distilled1 (fused encoder + denoiser kernels) "
        f"{ms_dist:.2f} ms/period; ddim30 per-step (fused encoder + 30 denoiser launches) "
        f"{ms_step:.2f} ms/period; launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    want = {"fused_encoder": CHUNKS, "fused_chunk": 0, "fused_denoise": 30 * CHUNKS,
            "fused_denoise_pack": cfg.num_decoder_layers * CHUNKS}  # a pack launch a layer
    if {name: l_step[name] for name in names} != want:
        raise AssertionError(f"per-step ddim30 launches {l_step}, expected {want}")
    no_flash(l_ddim, l_dist, l_step)
    ms_plain, l_plain = timed_rollout(plain, device, 1)
    no_flash(l_plain)
    log(f"unfused plain-PyTorch rollout (fused=False, bf16) B={BENCH_B}: {ms_plain:.2f} ms/period")
    return launches, {"ddim30": ms_ddim, "distilled1": ms_dist, "ddim30_per_step": ms_step,
                      "ddim30_unfused": ms_plain}


def to_device(carry, device):
    """The rollout carry on another device, with a fresh generator there."""
    move = lambda obj: dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)
        if getattr(obj, f.name) is not None})
    return dataclasses.replace(carry, controller=move(carry.controller), plant=move(carry.plant),
                               generator=torch.Generator(device=device))


def reference_phase(cfg, model, device, b=8, tol=ROLLOUT_TOL, **kw):
    """Closed-loop periods of the kernel path, each held against the same
    engine's plain versions on the CPU from the same state and noise (the
    untrained model's loop is chaotic, so the states are re-synchronised
    every period), each within ``tol`` x max|plain|."""
    rng = np.random.default_rng(5)
    kw = kw or dict(fused="chunk")
    gpu = engine(model, cfg, device, **kw)
    cpu = engine(copy.deepcopy(model).cpu(), cfg, "cpu", **kw)
    carry = gpu.init(b, torch.Generator(device=device).manual_seed(0))
    for period in range(2):
        noise = torch.from_numpy(rng.normal(size=(b, cfg.trajectory_prediction_length,
                                                  cfg.num_joints)).astype(np.float32))
        _, ref = cpu.replan_period(to_device(carry, "cpu"), noise)
        carry, got = gpu.replan_period(carry, noise)
        err, scale = (got.cpu() - ref).abs().max().item(), ref.abs().max().item()
        log(f"serving loop B={b} period {period}: kernels on {device} vs plain versions on cpu: "
            f"max_abs_err={err:.4e} max|plain|={scale:.4e} (tol {tol} x max|plain|)")
        if not err <= tol * scale:
            raise AssertionError("the kernel path disagrees with the plain path")


def err_line(name, got, ref, tol_scale=None):
    """max |got - ref| against TRAIN_TOL x tol_scale (default max|ref|)."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or non-finite")
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    tol_scale = scale if tol_scale is None else tol_scale
    ok = err <= TRAIN_TOL * tol_scale
    log(f"  {name}: max_abs_err={err:.4e} max|plain|={scale:.4e} tol={TRAIN_TOL * tol_scale:.4e} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def grads_check(names, got, ref, zero):
    """Every weight gradient; those in ``zero`` (name -> last-axis slice,
    zero in exact arithmetic) against the layer's largest gradient."""
    top = max(r.float().abs().max().item() for r in ref)
    errs = []
    for name, g, r in zip(names, got, ref):
        if name in zero:
            cut = zero[name]
            errs.append(err_line(f" d{name}[exact zero part]", g[..., cut], r[..., cut], top))
            keep = torch.ones(g.shape[-1], dtype=torch.bool, device=g.device)
            keep[cut] = False
            g, r = g[..., keep], r[..., keep]
            if not g.numel():
                continue
        errs.append(err_line(f" d{name}", g, r))
    return max(errs)


def training_kernel_phase(cfg, model, device):
    """Kernels C / D (encoder stack fwd / bwd) on the action-history stack's
    weights and A / B (decoder layer fwd / bwd) on decoder layer 0's, at the
    training shapes, against their plain versions."""
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes

    H, E = 4, cfg.hidden_dim
    S = cfg.action_context_length + cfg.imu_context_length + cfg.joint_state_context_length + 2
    enc_w = [t.detach().to(torch.bfloat16) for t in
             fes.stack_weights(model.action_history_encoder.seq.encoder.layers)]
    dec_w = [t.detach().to(torch.bfloat16) for t in
             fdl.layer_weights(model.diffusion_action_generator.decoder.layers[0])]
    results = {}
    for b in TRAIN_BATCHES:
        rng = np.random.default_rng(100 + b)
        t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device, torch.bfloat16)
        x, dy, xd, mem, dyd = t(b, 100, E), t(b, 100, E), t(b, 10, E), t(b, S, E), t(b, 10, E)
        log(f"encoder stack B={b} T=100 L=2 E={E}:")
        y, acts = fes.forward_kernel(x, enc_w, H)
        e_fwd = err_line("y", y, fes.forward_plain(x, enc_w, H))
        dx, grads = fes.backward_kernel(acts, dy, enc_w, H)
        dx_ref, grads_ref = fes.backward_plain(x, dy, enc_w, H)
        e_bwd = max(err_line("dx", dx, dx_ref),
                    grads_check(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(E, 2 * E)}))
        log(f"decoder layer B={b} T=10 S={S} E={E}:")
        e_dfwd = err_line("y", fdl.forward_kernel(xd, mem, dec_w, H), fdl.forward_plain(xd, mem, dec_w, H))
        ddx, dmem, dgrads = fdl.backward_kernel(xd, mem, dyd, dec_w, H)
        ddx_ref, dmem_ref, dgrads_ref = fdl.backward_plain(xd, mem, dyd, dec_w, H)
        e_dbwd = max(err_line("dx", ddx, ddx_ref), err_line("dmem", dmem, dmem_ref),
                     grads_check(fdl.WEIGHT_NAMES, dgrads, dgrads_ref,
                                 {"bqkv": slice(E, 2 * E), "bck": slice(None)}))
        enc_lib, dec_lib = torch_encoder(enc_w, H), torch_decoder_layer(dec_w, H)
        enc_flops = b * 2 * enc_layer_flops(100, E, E)  # L=2
        dec_flops = b * (dec_layer_flops(10, S, E, E) + 4 * S * E * E)  # + memory K/V
        # backward: recompute the forward, then two products per forward product
        times = {
            "fused_encoder_stack_fwd": (e_fwd, lambda: fes.forward_kernel(x, enc_w, H),
                                        lambda: fes.forward_plain(x, enc_w, H),
                                        enc_flops, [x, enc_w, y, acts], lambda: enc_lib(x)),
            "fused_encoder_stack_bwd": (e_bwd, lambda: fes.backward_kernel(acts, dy, enc_w, H),
                                        lambda: fes.backward_plain(x, dy, enc_w, H),
                                        3 * enc_flops, [acts, dy, enc_w, dx, grads],
                                        LibraryGrad(encoder_grad_fn(enc_w, H, x, dy),
                                                    fes.STACK_WEIGHTS, {"bqkv": slice(E, 2 * E)})),
            "fused_decoder_layer_fwd": (e_dfwd, lambda: fdl.forward_kernel(xd, mem, dec_w, H),
                                        lambda: fdl.forward_plain(xd, mem, dec_w, H),
                                        dec_flops, [xd, mem, dec_w, xd], lambda: dec_lib(xd, mem)),
            "fused_decoder_layer_bwd": (e_dbwd, lambda: fdl.backward_kernel(xd, mem, dyd, dec_w, H),
                                        lambda: fdl.backward_plain(xd, mem, dyd, dec_w, H),
                                        3 * dec_flops, [xd, mem, dyd, dec_w, ddx, dmem, dgrads],
                                        LibraryGrad(decoder_grad_fn(dec_w, H, xd, mem, dyd),
                                                    fdl.WEIGHT_NAMES, dec_zero(E))),
        }
        time_checked(results, f"B={b}", times)
    return results


@dataclasses.dataclass(frozen=True)
class LibraryGrad:
    """A backward kernel's library call for time_checked: ``fn`` returns the
    torch.nn layer's input and weight gradients (encoder_grad_fn /
    decoder_grad_fn), ``names`` names the weight gradients and ``zero`` maps
    those that are zero in exact arithmetic to their slice."""
    fn: object
    names: tuple
    zero: dict


def time_checked(results, label, times):
    """Time each checked kernel beside its plain version (and its library
    call), with its bound: ``times`` maps a name to (max_abs_err, kernel_fn,
    plain_fn, flops, the tensors it reads and writes, library_fn, a
    LibraryGrad for a backward, or None); merged into ``results``."""
    for name, (err, kernel_fn, plain_fn, flops, io, lib_fn) in times.items():
        k_ms, p_ms = median_ms(kernel_fn), median_ms(plain_fn)
        bnd = bound(flops, nbytes(io))
        log(f"{name} {label}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) (max_abs_err {err:.4e})")
        if isinstance(lib_fn, LibraryGrad):  # a backward: (dx[, dmem], grads) of the plain version
            *inputs, grads = plain_fn()
            lib = library_bwd_ms(name, label, lib_fn.fn, [*inputs, *grads], lib_fn.names,
                                 lib_fn.zero)
        else:
            lib = None if lib_fn is None else library_ms(name, label, lib_fn, plain_fn())
        merge(results, name, {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **bnd,
                              "library_ms": lib})


def train_config(fused: bool, attention_impl: str = "auto"):
    from soccerdiffusion_tpu_torch.config import Config, TrainConfig

    model = dataclasses.replace(bench_config(), encoder_fused_stack=fused, decoder_fused_block=fused,
                                attention_impl=attention_impl)
    return Config(model=model, train=TrainConfig(batch_size=TRAIN_BATCH, lr=1e-4,
                                                 log_every=TRAIN_LOG_EVERY,
                                                 ema_decay=0.999))


def timed_training(config, tmp, label, packed=False):
    """training/train.py's loop on synthetic data for TRAIN_STEPS steps in two
    epochs. ms/step is the host clock from the second epoch's first logging
    window's end to the last window's end, over the steps between: each
    window ends in a device sync and the windows run back to back, so this
    times whole steps from one sync to another, past the epoch start (the
    prefetch thread's start) and the warm-up of the first epoch."""
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train

    metrics = f"{tmp}/metrics_{label}.jsonl"
    state = train(config, RunOptions(
        output=f"{tmp}/ckpt_{label}", dummy_data=True, packed=packed, epochs=2,
        steps_per_epoch=TRAIN_STEPS // 2, seed=0, metrics=metrics))
    torch.cuda.synchronize()
    records = [json.loads(line) for line in open(metrics)]
    losses = [r["loss"] for r in records]
    if state.step != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"training ran {state.step} steps, logged losses {losses}")
    if not all(torch.isfinite(p).all() for p in state.model.parameters()):
        raise AssertionError("non-finite parameters after training (a step's loss was not finite)")
    second = [r for r in records if r["epoch"] == 1]
    steps = [b["step"] - a["step"] for a, b in zip(second, second[1:])]
    seconds = [n / r["steps_per_sec"] for n, r in zip(steps, second[1:])]
    if sum(steps) < 2 * TRAIN_LOG_EVERY:
        raise AssertionError(f"too few timed steps: {steps}")
    return 1e3 * sum(seconds) / sum(steps), losses


def training_path_phase():
    with tempfile.TemporaryDirectory() as tmp:
        zero_counters()
        ms_fused, losses = timed_training(train_config(True), tmp, "fused")
        counts = read_counters()
        no_flash(counts)
        launches = {name: n for name, n in counts.items()
                    if name.startswith(("fused_encoder_stack", "fused_decoder_layer"))}
        log(f"training main path (train.py loop, synthetic data, bf16, B={TRAIN_BATCH}, "
            f"{TRAIN_STEPS} steps, fused knobs on): {ms_fused:.3f} ms/step, "
            f"{TRAIN_BATCH * 1e3 / ms_fused:.1f} samples/s; logged losses {losses}; launches {launches}")
        want = {"fused_encoder_stack_fwd": 3, "fused_encoder_stack_fwd_hd64": 0,
                "fused_encoder_stack_bwd": 3, "fused_encoder_stack_bwd_hd64": 0,
                "fused_decoder_layer_fwd": 4, "fused_decoder_layer_fwd_hd64": 0,
                "fused_decoder_layer_bwd": 4, "fused_decoder_layer_bwd_hd64": 0}
        for name, per_step in want.items():
            if launches[name] != per_step * TRAIN_STEPS:
                raise AssertionError(f"{name}: {launches[name]} launches on the training path, "
                                     f"expected {per_step} per step")
        zero_counters()
        ms_plain, _ = timed_training(train_config(False), tmp, "plain")
        no_flash(read_counters())
        log(f"unfused training step (knobs off, bf16 cuBLAS + torch ops), same loop: "
            f"{ms_plain:.3f} ms/step, {TRAIN_BATCH * 1e3 / ms_plain:.1f} samples/s")
        # the same unfused step with every attention through the flash kernel (head_dim 32)
        config = train_config(False, "pallas")
        zero_counters()
        ms_flash, _ = timed_training(config, tmp, "flash")
        flash = check_flash_launches("h128 unfused training, attention_impl=\"pallas\"",
                                     read_counters(), flash_per_pass(config.model) * TRAIN_STEPS,
                                     flash_per_pass(config.model) * TRAIN_STEPS)
        log(f"unfused training step with attention_impl=\"pallas\", same loop: {ms_flash:.3f} "
            f"ms/step, {TRAIN_BATCH * 1e3 / ms_flash:.1f} samples/s; launches {flash}")
    return launches, {"fused": ms_fused, "unfused": ms_plain, "unfused_pallas": ms_flash}, flash


def training_reference_phase(device, cfg, batches, seed, gate=True, aux_cue_weight=0.0,
                             lr_mults=None) -> dict:
    """The kernel path's training steps on the card against the same steps of
    the plain versions on the CPU, one per batch of ``batches`` (dicts of CPU
    tensors with the target ``joint_command``), from the same init, t and
    noise: the losses, the update norm and the BatchNorm running
    statistics, each against its tolerance; raises past one unless ``gate``
    is False (a measurement, not a check). ``aux_cue_weight`` and
    ``lr_mults`` (module -> learning-rate multiplier) go to the step and the
    optimizer; the aux cue losses must be finite. Returns the measures."""
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer, make_train_step
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

    rng = np.random.default_rng(seed)
    base = DiffusionPolicy(cfg)
    base = load_jax_params(base, *flax_init_params(base, 3))
    runs = {}
    for dev in (device, "cpu"):
        model = copy.deepcopy(base).to(dev)
        opt = make_optimizer(model, 1e-3, 10, grad_clip_norm=1.0, module_lr_mults=lr_mults)
        runs[dev] = (model, create_train_state(model, opt),
                     make_train_step(model, make_schedule(1000), opt,
                                     Normalizer.identity(cfg.num_joints),
                                     aux_cue_weight=aux_cue_weight), [])
    aux = {dev: [] for dev in runs}
    for batch in batches:
        target = batch["joint_command"]
        t = torch.from_numpy(rng.integers(0, 1000, (target.shape[0],)))
        noise = torch.from_numpy(rng.normal(size=tuple(target.shape)).astype(np.float32))
        for dev, (model, state, step, losses) in runs.items():
            on = lambda x: x.to(dev)
            metrics = step.apply(state, {k: on(v) for k, v in batch.items()}, on(t), on(noise))
            losses.append(metrics["loss"].item())
            if aux_cue_weight > 0.0:
                aux[dev].append(metrics["aux_cue_loss"].item())
    if aux_cue_weight > 0.0:
        log(f"aux_cue_loss on {device} {aux[device]}, on cpu {aux['cpu']}")
        if not all(np.isfinite(aux[device] + aux["cpu"])):
            raise AssertionError("a non-finite aux cue loss")
    (gm, _, _, gl), (cm, _, _, cl) = runs[device], runs["cpu"]
    ok, loss_rel = True, []
    for i, (lg, lc) in enumerate(zip(gl, cl)):
        rel = abs(lg - lc) / abs(lc)
        loss_rel.append(rel)
        ok &= rel <= STEP_LOSS_TOL
        log(f"training step {i}: loss on {device} (kernels) {lg:.6f}, on cpu (plain versions) "
            f"{lc:.6f}, relative difference {rel:.3e} (tol {STEP_LOSS_TOL})")
    p0 = dict(base.named_parameters())
    num = den = max_diff = scale = 0.0
    for (name, pg), pc in zip(gm.named_parameters(), cm.parameters()):
        pg, pc = pg.detach().cpu(), pc.detach()
        num += ((pg - pc) ** 2).sum().item()
        den += ((pc - p0[name].detach()) ** 2).sum().item()
        max_diff, scale = max(max_diff, (pg - pc).abs().max().item()), max(scale, pc.abs().max().item())
    upd = (num / den) ** 0.5
    ok &= upd <= STEP_UPDATE_TOL
    log(f"after {len(batches)} steps: |params(card) - params(cpu)| / |update(cpu)| = {upd:.3e} "
        f"(tol {STEP_UPDATE_TOL}); max |param difference| / max|param| = {max_diff / scale:.3e}")
    # the BatchNorm running statistics (a model with a ResNet): each within TRAIN_TOL of scale
    cpu_buffers = dict(cm.named_buffers())
    worst = 0.0
    for name, bg in gm.named_buffers():
        if name.endswith((".mean", ".var")):
            bc = cpu_buffers[name]
            rel = (bg.cpu() - bc).abs().max().item() / max(bc.abs().max().item(), 1e-30)
            worst = max(worst, rel)
            ok &= rel <= TRAIN_TOL
    if any(n.endswith((".mean", ".var")) for n in cpu_buffers):
        log(f"after {len(batches)} steps: BatchNorm running statistics, card vs cpu: max "
            f"|difference| / max|cpu| = {worst:.3e} (tol {TRAIN_TOL})")
    if gate and not ok:
        raise AssertionError("the kernel training path disagrees with the plain path")
    return {"loss_rel": loss_rel, "update_norm": upd, "running_stats_rel": worst, "within": ok,
            **({"aux_cue_loss": aux} if aux_cue_weight > 0.0 else {})}


def h128_reference_batches(b=8, steps=3):
    """Random h128 batches (CPU tensors) with their targets."""
    cfg, rng = train_config(True).model, np.random.default_rng(11)
    batches = []
    for _ in range(steps):
        batch = random_batch(cfg, b, "cpu", rng)
        target = rng.uniform(0, 2 * np.pi, (b, 10, 20)).astype(np.float32)
        batch["joint_command"] = torch.from_numpy(target)
        batches.append(batch)
    return batches


# ------------------------------------------------------- the flagship

def flagship_config():
    """vit_flagship.yaml's model (the port's copy of the JAX package's YAML)."""
    from soccerdiffusion_tpu_torch.config import Config

    return Config.from_yaml(str(FLAG_YAML)).model


def flagship_train_config(batch: int):
    """vit_flagship.yaml at ``batch`` robots, logging every TRAIN_LOG_EVERY steps."""
    from soccerdiffusion_tpu_torch.config import Config

    config = Config.from_yaml(str(FLAG_YAML))
    return dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=batch, log_every=TRAIN_LOG_EVERY))


def flagship_kernel_phase(model, device):
    """At B=64 and B=256 robots, against their plain versions: the fused ViT
    block (block 0's weights, 2 frames per robot of 64 tokens), the
    encoder-stack forward at head_dim 64 (the action-history stack) and at
    head_dim 32 (the image-frame stack: 10 tokens, 8 heads, 1 layer), and
    the head_dim-64 chunk sampler and denoiser (on the context of a random
    batch with cached image tokens); then the ViT block at the raw-frame
    lane's 10 frames per robot at B=FLAG_B. The ViT block and the stacks
    beside their torch.nn layers."""
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    cfg = model.config
    vit = model.image_sequence_encoder.image_encoder
    T, W, H = (cfg.image_resolution // cfg.vit_patch_size) ** 2, cfg.vit_width, vit.num_heads
    gelu = cfg.vit_fused_gelu
    bf16 = lambda ts: [t.detach().to(torch.bfloat16) for t in ts]
    vit_w = bf16(fes.encoder_layer_weights(vit.blocks.layers[0]))
    vit_lib = torch_encoder([t[None] for t in vit_w], H, quick_gelu if gelu == "quick" else "gelu")
    stack_w = bf16(fes.stack_weights(model.action_history_encoder.seq.encoder.layers))
    seq_enc = model.image_sequence_encoder.seq.encoder
    seq_w, Hs = bf16(fes.stack_weights(seq_enc.layers)), seq_enc.num_heads
    stack_lib, seq_lib = torch_encoder(stack_w, 4), torch_encoder(seq_w, Hs)
    E, Ts, L = cfg.hidden_dim, cfg.action_context_length, cfg.num_action_history_encoder_layers
    Ti, Li = cfg.image_context_length, cfg.num_image_sequence_encoder_layers
    results = {}

    def vit_check(name, x, b):
        return compare(name, lambda: fvb.forward_kernel(x, vit_w, H, gelu),
                       lambda: fvb.forward_plain(x, vit_w, H, gelu), b,
                       x.shape[0] * enc_layer_flops(T, W, 4 * W), [x, vit_w], lambda: vit_lib(x))

    for b in FLAG_BATCHES:
        rng = np.random.default_rng(300 + b)
        t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device, torch.bfloat16)
        x, xs, xi = t(2 * b, T, W), t(b, Ts, E), t(b, Ti, E)
        with torch.no_grad():
            merge(results, "fused_vit_block_fwd", vit_check("fused_vit_block_fwd", x, b))
            merge(results, "fused_encoder_stack_fwd_hd64", compare(
                "fused_encoder_stack_fwd_hd64", lambda: fes.forward_kernel(xs, stack_w, 4)[0],
                lambda: fes.forward_plain(xs, stack_w, 4), b,
                b * L * enc_layer_flops(Ts, E, E), [xs, stack_w], lambda: stack_lib(xs)))
            merge(results, "fused_encoder_stack_fwd_imgseq", compare(
                "fused_encoder_stack_fwd_imgseq", lambda: fes.forward_kernel(xi, seq_w, Hs)[0],
                lambda: fes.forward_plain(xi, seq_w, Hs), b,
                b * Li * enc_layer_flops(Ti, E, E), [xi, seq_w], lambda: seq_lib(xi)))
            batch = random_batch(cfg, b, device, rng)
            batch["image_tokens"] = t(b, cfg.image_context_length, E).float()
            context = model.encode_context(batch)
            noise = torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32)).to(device)
            r_chunk, r_den, r_pack = decoder_checks(model, context, noise, device, b, "_hd64")
        merge(results, "fused_chunk_hd64", r_chunk)
        merge(results, "fused_denoise_hd64", r_den)
        merge(results, "fused_denoise_pack_hd64", r_pack)
    rng = np.random.default_rng(400)
    x = torch.from_numpy(rng.normal(size=(10 * FLAG_B, T, W)).astype(np.float32)).to(
        device, torch.bfloat16)
    with torch.no_grad():
        results["fused_vit_block_fwd_raw_frames"] = vit_check("fused_vit_block_fwd_raw_frames",
                                                              x, FLAG_B)
    return results


# launches per replan period of each flagship lane: the 8 ViT blocks over the
# frames that arrived (cache) or all 10 per robot (raw); 3 proprioceptive
# stacks (head_dim 64) + the image-frame stack (8 heads, head_dim 32); the sampler
FLAG_LANES = {
    "ddim30": (dict(fused="chunk"), {"fused_vit_block_fwd": 8, "fused_encoder_stack_fwd": 4,
                                     "fused_encoder_stack_fwd_hd64": 3, "fused_chunk": 1}),
    "ddim30_raw_frames": (dict(fused="chunk", cache_image_tokens=False),
                          {"fused_vit_block_fwd": 8, "fused_encoder_stack_fwd": 4,
                           "fused_encoder_stack_fwd_hd64": 3, "fused_chunk": 1}),
    "distilled1": (dict(distilled=True, fused="chunk"),
                   {"fused_vit_block_fwd": 8, "fused_encoder_stack_fwd": 4,
                    "fused_encoder_stack_fwd_hd64": 3, "fused_denoise": 1,
                    "fused_denoise_pack": 4}),  # the K/V pack: a launch per decoder layer
}


def flagship_path_phase(model, device):
    """The three serving lanes of the flagship at B=FLAG_B through
    RolloutEngine.make_rollout_fn, CHUNKS periods each, every launch counter
    zeroed just before each lane and read just after; each kernel of a lane
    must run exactly its count per period and no other kernel may run.
    Returns each lane's launches and ms per period."""
    cfg = model.config
    periods, launches = {}, {}
    for lane, (kw, per_period) in FLAG_LANES.items():
        eng = engine(model, cfg, device, fused_encoder=False, **kw)
        eng.make_rollout_fn(1)(eng.init(FLAG_B, torch.Generator(device=device).manual_seed(0)))
        ms, got = timed_rollout(eng, device, 1, FLAG_B, CHUNKS)
        want = {name: per_period.get(name, 0) * CHUNKS for name in got}
        log(f"flagship lane {lane} B={FLAG_B}, {CHUNKS} periods: {ms:.2f} ms/period, "
            f"{FLAG_B * 1e3 / ms:.1f} chunks/s; launches {got}")
        if got != want:
            raise AssertionError(f"flagship lane {lane}: launches {got}, expected {want}")
        periods[lane], launches[lane] = ms, got
    return launches, periods


def flagship_training_kernel_phase(model, device):
    """The flagship training step's kernels against their plain versions:
    the ViT block's backward (block 0's weights, quick GELU) at
    FLAG_VIT_FRAMES frames; at B=64 and B=256 robots the head_dim-64
    encoder-stack backward (the action-history stack, T=100, L=2), the
    image-frame stack's backward (head_dim 32, 8 heads, T=10, L=1) and the
    head_dim-64 decoder layer (layer 0) forward and backward over the
    training memory: the 311 context tokens and the step token. Every
    output, input gradient and weight gradient within TRAIN_TOL of scale."""
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    cfg = model.config
    vit = model.image_sequence_encoder.image_encoder
    T, W, H = (cfg.image_resolution // cfg.vit_patch_size) ** 2, cfg.vit_width, vit.num_heads
    gelu, E = cfg.vit_fused_gelu, cfg.hidden_dim
    act = quick_gelu if gelu == "quick" else "gelu"
    bf16 = lambda ts: [t.detach().to(torch.bfloat16) for t in ts]
    vit_w = bf16(fes.encoder_layer_weights(vit.blocks.layers[0]))
    stack_w = bf16(fes.stack_weights(model.action_history_encoder.seq.encoder.layers))
    seq_enc = model.image_sequence_encoder.seq.encoder
    seq_w, Hs = bf16(fes.stack_weights(seq_enc.layers)), seq_enc.num_heads
    layer = model.diffusion_action_generator.decoder.layers[0]
    dec_w, Hd, FF = bf16(fdl.layer_weights(layer)), layer.num_heads, layer.mlp.linear1.out_features
    Ts, L = cfg.action_context_length, cfg.num_action_history_encoder_layers
    Ti, Li = cfg.image_context_length, cfg.num_image_sequence_encoder_layers
    S = Ts + cfg.imu_context_length + cfg.joint_state_context_length + Ti + 2
    dec_lib = torch_decoder_layer(dec_w, Hd)
    rng = np.random.default_rng(500)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device, torch.bfloat16)
    results = {}
    for n in FLAG_VIT_FRAMES:
        x, dy = t(n, T, W), t(n, T, W)
        log(f"fused ViT block backward N={n} frames T={T} W={W} ({gelu} GELU):")
        dx, grads = fvb.backward_kernel(x, dy, vit_w, H, gelu)
        dx_ref, grads_ref = fvb.backward_plain(x, dy, vit_w, H, gelu)
        err = max(err_line("dx", dx, dx_ref),
                  grads_check(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(W, 2 * W)}))
        # backward: recompute the forward, then two products per forward product
        time_checked(results, f"N={n} frames", {"fused_vit_block_bwd": (
            err, lambda: fvb.backward_kernel(x, dy, vit_w, H, gelu),
            lambda: fvb.backward_plain(x, dy, vit_w, H, gelu),
            3 * n * enc_layer_flops(T, W, 4 * W), [x, dy, vit_w, dx, grads],
            LibraryGrad(encoder_grad_fn([t[None] for t in vit_w], H, x, dy, act, stacked=False),
                        fes.STACK_WEIGHTS, {"bqkv": slice(W, 2 * W)}))})
    for b in FLAG_BATCHES:
        xs, dys, xi, dyi = t(b, Ts, E), t(b, Ts, E), t(b, Ti, E), t(b, Ti, E)
        xd, mem, dyd = t(b, 10, E), t(b, S, E), t(b, 10, E)
        times = {}
        for name, x, dy, w, heads, layers in (
                ("fused_encoder_stack_bwd_hd64", xs, dys, stack_w, 4, L),
                ("fused_encoder_stack_bwd_imgseq", xi, dyi, seq_w, Hs, Li)):
            log(f"{name} B={b} T={x.shape[1]} L={layers} {heads} heads:")
            _, acts = fes.forward_kernel(x, w, heads)
            dx, grads = fes.backward_kernel(acts, dy, w, heads)
            dx_ref, grads_ref = fes.backward_plain(x, dy, w, heads)
            err = max(err_line("dx", dx, dx_ref),
                      grads_check(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(E, 2 * E)}))
            times[name] = (err,
                           lambda a=acts, dy=dy, w=w, h=heads: fes.backward_kernel(a, dy, w, h),
                           lambda x=x, dy=dy, w=w, h=heads: fes.backward_plain(x, dy, w, h),
                           3 * b * layers * enc_layer_flops(x.shape[1], E, E),
                           [acts, dy, w, dx, grads],
                           LibraryGrad(encoder_grad_fn(w, heads, x, dy), fes.STACK_WEIGHTS,
                                       {"bqkv": slice(E, 2 * E)}))
        log(f"decoder layer B={b} T=10 S={S} E={E} {Hd} heads:")
        y = fdl.forward_kernel(xd, mem, dec_w, Hd)
        e_fwd = err_line("y", y, fdl.forward_plain(xd, mem, dec_w, Hd))
        ddx, dmem, dgrads = fdl.backward_kernel(xd, mem, dyd, dec_w, Hd)
        ddx_ref, dmem_ref, dgrads_ref = fdl.backward_plain(xd, mem, dyd, dec_w, Hd)
        e_bwd = max(err_line("dx", ddx, ddx_ref), err_line("dmem", dmem, dmem_ref),
                    grads_check(fdl.WEIGHT_NAMES, dgrads, dgrads_ref,
                                {"bqkv": slice(E, 2 * E), "bck": slice(None)}))
        dec_flops = b * (dec_layer_flops(10, S, E, FF) + 4 * S * E * E)  # + memory K/V
        times["fused_decoder_layer_fwd_hd64"] = (
            e_fwd, lambda: fdl.forward_kernel(xd, mem, dec_w, Hd),
            lambda: fdl.forward_plain(xd, mem, dec_w, Hd), dec_flops, [xd, mem, dec_w, y],
            lambda: dec_lib(xd, mem))
        times["fused_decoder_layer_bwd_hd64"] = (
            e_bwd, lambda: fdl.backward_kernel(xd, mem, dyd, dec_w, Hd),
            lambda: fdl.backward_plain(xd, mem, dyd, dec_w, Hd), 3 * dec_flops,
            [xd, mem, dyd, dec_w, ddx, dmem, dgrads],
            LibraryGrad(decoder_grad_fn(dec_w, Hd, xd, mem, dyd), fdl.WEIGHT_NAMES, dec_zero(E)))
        time_checked(results, f"B={b}", times)
    return results


def flagship_training_path_phase():
    """training/train.py on vit_flagship.yaml with packed dummy data: TRAIN_STEPS
    steps at FLAG_TRAIN_B with every launch counter zeroed just before and
    read just after (each kernel exactly its FLAG_TRAIN_LAUNCHES per step, no
    other kernel), then 3 steps at the YAML's FLAG_TRAIN_FULL_B: the last
    step's host time between device syncs and the peak device memory.
    Returns the launches, ms per step at both batches and the peak bytes."""
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        zero_counters()
        ms, losses = timed_training(flagship_train_config(FLAG_TRAIN_B), tmp, "flagship",
                                    packed=True)
        launches = read_counters()
        want = {name: FLAG_TRAIN_LAUNCHES.get(name, 0) * TRAIN_STEPS for name in launches}
        log(f"flagship training main path (train.py, vit_flagship.yaml, --packed dummy data, "
            f"B={FLAG_TRAIN_B}, {TRAIN_STEPS} steps): {ms:.3f} ms/step, "
            f"{FLAG_TRAIN_B * 1e3 / ms:.1f} samples/s; logged losses {losses}; launches {launches}")
        if launches != want:
            raise AssertionError(f"flagship training: launches {launches}, expected {want}")
        config = flagship_train_config(FLAG_TRAIN_FULL_B)
        config = dataclasses.replace(config, train=dataclasses.replace(config.train, log_every=1))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        metrics = f"{tmp}/metrics_full.jsonl"
        state = train(config, RunOptions(output=f"{tmp}/ckpt_full", dummy_data=True, packed=True,
                                         epochs=1, steps_per_epoch=3, seed=1, metrics=metrics))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        last = [json.loads(line) for line in open(metrics)][-1]
        ms_full = 1e3 / last["steps_per_sec"]
        if state.step != 3 or not np.isfinite(last["loss"]):
            raise AssertionError(f"B={FLAG_TRAIN_FULL_B}: {state.step} steps, "
                                 f"last loss {last['loss']}")
        log(f"flagship training at the YAML's B={FLAG_TRAIN_FULL_B}, 3 steps: the last "
            f"{ms_full:.3f} ms, {FLAG_TRAIN_FULL_B * 1e3 / ms_full:.1f} samples/s, loss "
            f"{last['loss']:.6f}; peak device memory {peak / 2**30:.2f} GiB")
    return launches, {f"B{FLAG_TRAIN_B}": ms, f"B{FLAG_TRAIN_FULL_B}": ms_full}, peak


def flagship_reference_batches(b=2, steps=3):
    """The first shuffled packed batches of the flagship's dummy data at B=b."""
    from soccerdiffusion_tpu_torch.data.pipeline import to_tensors
    from soccerdiffusion_tpu_torch.training.train import build_dataset

    dataset = build_dataset(flagship_train_config(b), 0, True, packed=True)
    return [to_tensors(batch) for batch in itertools.islice(dataset.batches(b, seed=0), steps)]


# ------------------------------------------------------- flash attention

def flash_flagship_config():
    """vit_flagship.yaml's model with every attention through the flash
    kernel: attention_impl="pallas" and the three fused knobs off."""
    return dataclasses.replace(flagship_config(), attention_impl="pallas", vit_fused_block=False,
                               encoder_fused_stack=False, decoder_fused_block=False)


def flash_train_config(batch: int):
    return dataclasses.replace(flagship_train_config(batch), model=flash_flagship_config())


def flash_per_pass(cfg) -> int:
    """Attention calls of one forward of ``cfg``'s model with every layer
    unfused: the proprioceptive stacks' layers, the ViT blocks and the
    image-frame stack's layers, each decoder layer's self- and
    cross-attention."""
    n = (cfg.num_action_history_encoder_layers + cfg.num_imu_encoder_layers
         + cfg.joint_state_encoder_layers + 2 * cfg.num_decoder_layers)
    if cfg.use_images:
        n += cfg.vit_depth + cfg.num_image_sequence_encoder_layers
    return n


def check_flash_launches(label, got, fwd, bwd) -> dict:
    """Exactly ``fwd`` / ``bwd`` flash launches and no other kernel's."""
    want = {name: 0 for name in got}
    want.update(flash_attention_fwd=fwd, flash_attention_bwd=bwd)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    return {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd}


def flash_kernel_phase(device):
    """The flash kernel's forward (o) and backward (dq, dk, dv) against the
    plain versions on the same inputs (the backward on the plain forward's
    o and log-sum-exp) at every FLASH_SHAPES entry in fp32 and bf16, with
    CUDA-event times of both, of F.scaled_dot_product_attention's forward
    and of one autograd.grad through it on the same inputs, and the bound
    (bf16: the tensor-core peak; fp32: the fp32 peak). Returns the JSON entries (errors: the largest over every
    check; times: the first shape's in bf16) and every shape's numbers."""
    from torch.nn import functional as F

    from soccerdiffusion_tpu_torch.ops import flash_attention as fa

    shapes = {}
    for dtype in (torch.float32, torch.bfloat16):
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        for label, (B, Tq, Tk, H, D) in FLASH_SHAPES.items():
            rng = np.random.default_rng(len(shapes))
            t = lambda T: torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32)).to(
                device, dtype)
            q, k, v, do = t(Tq), t(Tk), t(Tk), t(Tq)
            name = f"{label} {str(dtype).removeprefix('torch.')}"
            log(f"flash attention {name} (B={B}, Tq={Tq}, Tk={Tk}, H={H}, D={D}):")
            o, lse = fa.forward_kernel(q, k, v)
            o_ref, lse_ref = fa.plain_forward(q, k, v)
            grads = fa.backward_kernel(q, k, v, o_ref, lse_ref, do)
            grads_ref = fa.plain_backward(q, k, v, o_ref, lse_ref, do)
            torch.cuda.synchronize()
            e_fwd = err_line("o", o, o_ref)  # TRAIN_TOL = TOL x max|plain|
            e_bwd = max(err_line(f"d{n}", g, r) for n, g, r in zip("qkv", grads, grads_ref))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, T, D) views
            lib = library_ms("flash_attention_fwd", name,
                             lambda: F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2),
                             o_ref)
            lib_bwd = sdpa_bwd_ms("flash_attention_bwd", name, q, k, v, do, grads_ref)
            flops = 4 * B * H * Tq * Tk * D
            row = {}
            for key, err, kernel_fn, plain_fn, fl, io, lib_ms in (
                    ("fwd", e_fwd, lambda: fa.forward_kernel(q, k, v),
                     lambda: fa.plain_forward(q, k, v), flops, [q, k, v, o, lse], lib),
                    ("bwd", e_bwd, lambda: fa.backward_kernel(q, k, v, o_ref, lse_ref, do),
                     lambda: fa.plain_backward(q, k, v, o_ref, lse_ref, do), 3 * flops,
                     [q, k, v, o_ref, lse_ref, do, grads], lib_bwd)):
                k_ms, p_ms = median_ms(kernel_fn), median_ms(plain_fn)
                bnd = bound(fl, nbytes(io), peak)
                log(f"  {key}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library "
                    f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
                    f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
                row[key] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **bnd,
                            "library_ms": lib_ms}
            shapes[name] = row
    first = f"{next(iter(FLASH_SHAPES))} bfloat16"
    results = {f"flash_attention_{key}": {
        **shapes[first][key], "max_abs_err": max(r[key]["max_abs_err"] for r in shapes.values())}
        for key in ("fwd", "bwd")}
    return results, shapes


def flash_serving_phase(model, device):
    """The flash flagship's cached 30-step DDIM lane at B=FLAG_B through
    RolloutEngine(fused=False), CHUNKS periods with every counter zeroed
    before and read after (exactly the model's attention calls per period
    on the flash kernel, no other kernel), then 2 periods on the card
    against the same engine on the CPU."""
    cfg = model.config
    eng = engine(model, cfg, device, fused=False, fused_encoder=False)
    eng.make_rollout_fn(1)(eng.init(FLAG_B, torch.Generator(device=device).manual_seed(0)))
    ms, got = timed_rollout(eng, device, 1, FLAG_B, CHUNKS)
    # encoders once per period (the ViT on the arrived frames), the decoder at every step
    per_period = flash_per_pass(cfg) + (eng.num_inference_steps - 1) * 2 * cfg.num_decoder_layers
    launches = check_flash_launches("flash flagship serving", got, per_period * CHUNKS, 0)
    log(f"flash flagship lane ddim30 (attention_impl=\"pallas\", fused=False) B={FLAG_B}, "
        f"{CHUNKS} periods: {ms:.2f} ms/period, {FLAG_B * 1e3 / ms:.1f} chunks/s; {per_period} "
        f"flash launches per period")
    reference_phase(cfg, model, device, b=4, fused=False, fused_encoder=False)
    return launches, ms


def flash_training_path_phase():
    """training/train.py on the flash flagship with packed dummy data:
    TRAIN_STEPS steps at FLAG_TRAIN_B, every counter zeroed before and read
    after (exactly flash_per_pass forward and backward launches per step,
    no other kernel). Returns the launches and ms per step."""
    config = flash_train_config(FLAG_TRAIN_B)
    per_step = flash_per_pass(config.model)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        zero_counters()
        ms, losses = timed_training(config, tmp, "flash_flagship", packed=True)
        launches = check_flash_launches("flash flagship training", read_counters(),
                                        per_step * TRAIN_STEPS, per_step * TRAIN_STEPS)
    log(f"flash flagship training (train.py, attention_impl=\"pallas\", fused knobs off, --packed "
        f"dummy data, B={FLAG_TRAIN_B}, {TRAIN_STEPS} steps): {ms:.3f} ms/step, "
        f"{FLAG_TRAIN_B * 1e3 / ms:.1f} samples/s; logged losses {losses}; {per_step} flash "
        f"launches per step, forward and backward")
    return launches, ms


# ------------------------------------------------------- the ResNet / Swin slice

CONFIG_DIR = Path(__file__).resolve().parent / "soccerdiffusion_tpu_torch" / "training" / "configs"
# the ResNet serving lanes at RESNET_B robots: the chunk sampler or the
# distilled denoiser and its K/V pack (a launch per decoder layer), no
# fused encoder (an image config takes the model's context encoder), no
# ViT block and no fused stack (default_tpu.yaml's knobs are off)
RESNET_B, RESNET_FRAMES = 64, (128, 640)
RESNET_LANES = {
    "ddim30": (dict(fused="chunk"), {"fused_chunk": 1}),
    "ddim30_raw_frames": (dict(fused="chunk", cache_image_tokens=False), {"fused_chunk": 1}),
    "distilled1": (dict(distilled=True, fused=True), {"fused_denoise": 1,
                                                      "fused_denoise_pack": 4}),
}
RESNET_TRAIN_B, RESNET_TRAIN_FULL_B = 64, 128
# ResNet50 / Swin-T forwards on the card against the CPU in float32 (TF32 off):
# cuDNN's and the CPU's convolution algorithms sum in other orders
ENCODER_F32_TOL = 1e-3
# the decoder-only tier's checks (S=0 context tokens) and lanes
DECODER_ONLY_BATCHES, DECODER_ONLY_B = (64, 256), 64


def yaml_config(name: str, **train):
    """The port's copy of training/configs/<name>.yaml, its train section's
    fields replaced by ``train``."""
    from soccerdiffusion_tpu_torch.config import Config

    config = Config.from_yaml(str(CONFIG_DIR / name))
    return dataclasses.replace(config, train=dataclasses.replace(config.train, **train))


def forward_flops(module, x) -> int:
    """Multiply-add FLOPs (2 per MAC) of the convolutions and dense layers of
    one forward of ``module`` on ``x``, counted from their shapes by hooks."""
    total = [0]

    def hook(mod, inputs, out):
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw
        elif isinstance(mod, torch.nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            module(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def image_encoder_phase(model, device) -> dict:
    """The per-frame image encoder of ``model`` (eval mode, bf16, no grad)
    timed with CUDA events over RESNET_FRAMES frames, with its convolution
    and dense FLOPs per ms against the bf16 tensor-core peak."""
    enc = model.image_sequence_encoder.image_encoder
    res = model.config.image_resolution
    rng = np.random.default_rng(600)
    out = {}
    with torch.no_grad():
        for n in RESNET_FRAMES:
            x = torch.from_numpy(rng.normal(size=(n, res, res, 3)).astype(np.float32)).to(
                device, torch.bfloat16)
            flops = forward_flops(enc, x)
            ms = median_ms(lambda: enc(x))
            rate = flops / (ms * 1e-3)
            log(f"{model.config.image_encoder_type} per-frame encoder, {n} frames at {res} px "
                f"(bf16, eval): {ms:.3f} ms, {flops / n / 1e9:.3f} GFLOP a frame, "
                f"{rate / 1e12:.1f} TFLOP/s = {rate / BF16_FLOPS:.3f} of 989 TFLOP/s")
            out[f"N{n}"] = {"ms": ms, "gflop": flops / 1e9, "tflops": rate / 1e12,
                            "share_of_bf16_peak": rate / BF16_FLOPS}
    return out


def resnet_kernel_phase(model, device) -> dict:
    """The decoder kernels at the ResNet lanes' shape (head_dim 32, S=311
    context tokens: 300 proprioceptive, 10 image tokens, the game state)
    against their plain versions at RESNET_B robots, on the context of a
    random batch with cached image tokens."""
    cfg = model.config
    rng = np.random.default_rng(900)
    with torch.no_grad():
        batch = random_batch(cfg, RESNET_B, device, rng)
        batch["image_tokens"] = torch.from_numpy(rng.normal(
            size=(RESNET_B, cfg.image_context_length, cfg.hidden_dim)).astype(np.float32)).to(device)
        context = model.encode_context(batch)
        noise = torch.from_numpy(rng.normal(size=(RESNET_B, 10, 20)).astype(np.float32)).to(device)
        r_chunk, r_den, r_pack = decoder_checks(model, context, noise, device, RESNET_B,
                                                "_resnet")
    return {"fused_chunk_resnet": r_chunk, "fused_denoise_resnet": r_den,
            "fused_denoise_pack_resnet": r_pack}


def lanes_phase(model, device, lanes, b, label) -> tuple[dict, dict]:
    """Each lane of ``lanes`` at B=b through RolloutEngine.make_rollout_fn,
    CHUNKS periods, every counter zeroed just before and read just after;
    each kernel exactly its count per period, no other kernel."""
    cfg = model.config
    periods, launches = {}, {}
    for lane, (kw, per_period) in lanes.items():
        eng = engine(model, cfg, device, fused_encoder=False, **kw)
        eng.make_rollout_fn(1)(eng.init(b, torch.Generator(device=device).manual_seed(0)))
        ms, got = timed_rollout(eng, device, 1, b, CHUNKS)
        want = {name: per_period.get(name, 0) * CHUNKS for name in got}
        log(f"{label} lane {lane} B={b}, {CHUNKS} periods: {ms:.2f} ms/period, "
            f"{b * 1e3 / ms:.1f} chunks/s; launches {got}")
        if got != want:
            raise AssertionError(f"{label} lane {lane}: launches {got}, expected {want}")
        periods[lane], launches[lane] = ms, got
    return launches, periods


def peak_training(config, tmp, label) -> tuple[float, int]:
    """3 steps of training/train.py (packed dummy data, a sync each step): the
    last step's ms and the peak device memory."""
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train

    config = dataclasses.replace(config, train=dataclasses.replace(config.train, log_every=1))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics = f"{tmp}/metrics_{label}.jsonl"
    state = train(config, RunOptions(output=f"{tmp}/ckpt_{label}", dummy_data=True, packed=True,
                                     epochs=1, steps_per_epoch=3, seed=1, metrics=metrics))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    last = [json.loads(line) for line in open(metrics)][-1]
    if state.step != 3 or not np.isfinite(last["loss"]):
        raise AssertionError(f"{label}: {state.step} steps, last loss {last['loss']}")
    ms = 1e3 / last["steps_per_sec"]
    log(f"{label}, 3 steps: the last {ms:.3f} ms, "
        f"{config.train.batch_size * 1e3 / ms:.1f} samples/s, loss {last['loss']:.6f}; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    return ms, peak


def resnet_training_phase() -> dict:
    """training/train.py on default_tpu.yaml (ResNet18 at 224 px, bf16,
    remat_image_encoder "conv_only") with packed whole-frame uint8 dummy
    data: TRAIN_STEPS steps at RESNET_TRAIN_B with every counter zeroed
    before and read after (no kernel of the port runs: the ResNet is
    cuDNN's, the layers are unfused), then 3 steps at the YAML's own
    RESNET_TRAIN_FULL_B with "conv_only" and with remat off: the last
    step's ms and the peak device memory of each."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        zero_counters()
        config = yaml_config("default_tpu.yaml", batch_size=RESNET_TRAIN_B,
                             log_every=TRAIN_LOG_EVERY)
        ms, losses = timed_training(config, tmp, "resnet", packed=True)
        launches = read_counters()
        log(f"ResNet training main path (train.py, default_tpu.yaml, --packed whole-frame uint8 "
            f"dummy data, B={RESNET_TRAIN_B}, {TRAIN_STEPS} steps): {ms:.3f} ms/step, "
            f"{RESNET_TRAIN_B * 1e3 / ms:.1f} samples/s; logged losses {losses}; launches "
            f"{launches}")
        if any(launches.values()):
            raise AssertionError(f"a kernel of the port ran on the ResNet training path: {launches}")
        out[f"B{RESNET_TRAIN_B}"] = ms
        for remat in ("conv_only", False):
            config = yaml_config("default_tpu.yaml", batch_size=RESNET_TRAIN_FULL_B)
            config = dataclasses.replace(config, model=dataclasses.replace(
                config.model, remat_image_encoder=remat))
            label = f"B{RESNET_TRAIN_FULL_B}_remat_{remat or 'off'}"
            ms, peak = peak_training(config, tmp, f"default_tpu.yaml {label}")
            out[label] = {"ms": ms, "peak_bytes": peak}
    return out


def reference_batches(config, b=2, steps=3):
    """The first shuffled packed batches of ``config``'s dummy data at B=b."""
    from soccerdiffusion_tpu_torch.data.pipeline import to_tensors
    from soccerdiffusion_tpu_torch.training.train import build_dataset

    dataset = build_dataset(config, 0, True, packed=True)
    return [to_tensors(batch) for batch in itertools.islice(dataset.batches(b, seed=0), steps)]


def noise_frame_batches(config, b=2, steps=3, seed=3):
    """reference_batches with every frame's pixels replaced by seeded uint8
    noise (the dummy frames hold 4 distinct pixel values, whose ReLU and
    max-pool ties rounding may break either way), as
    tests/test_torch_image_configs.py:packed_batches does."""
    rng = np.random.default_rng(seed)
    batches = reference_batches(config, b, steps)
    for batch in batches:
        batch["image_u8"] = torch.from_numpy(
            rng.integers(0, 256, tuple(batch["image_u8"].shape), dtype=np.uint8))
    return batches


def bisect_resnet_bf16(device, frames=16, seed=21) -> dict:
    """Where the bf16 ResNet step departs between the card and the CPU: the
    pieces of default_tpu.yaml's ResNet18 (train mode, as in the step), each
    forward and backward in bf16 on the card and on the CPU against the same
    module in float64 on the CPU (the float32 masters cast at use, as in
    bf16), on seeded uint8 noise frames normalised as the model's encoder
    sees them: the stem convolution, its BatchNorm (float32 statistics and
    casts), the stem's max pool, one residual block (layer2_0: strided, with
    the downsample skip) and the whole per-frame encoder. Each piece's input
    is the float64 pipeline's, rounded to bf16 once, so that only the piece
    differs; the output gradient is seeded normal noise; the running
    statistics are restored after each call. Per piece and side: max |side
    - float64| / max |float64| of the output, of the input gradient and
    (the worst) of the weight gradients; card vs CPU beside."""
    from torch.nn import functional as F

    from soccerdiffusion_tpu_torch.data.pipeline import device_normalize_images

    cpu_enc = build_model(yaml_config("default_tpu.yaml").model, "cpu", seed=4)
    cpu_enc = cpu_enc.image_sequence_encoder.image_encoder.train()
    card_enc = copy.deepcopy(cpu_enc).to(device)
    rng = np.random.default_rng(seed)
    u8 = torch.from_numpy(rng.integers(0, 256, (frames, 224, 224, 3), dtype=np.uint8))
    x64 = device_normalize_images(u8, torch.ones(frames)).double()
    stem_pool = lambda x: F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)

    def whole(enc):
        def fn(x):
            enc.dtype = x.dtype  # the encoder casts its input to its dtype
            return enc(x)
        return fn

    def pieces(enc):  # name -> (function, the modules whose weights it holds)
        return {"stem conv": (enc.conv1, [enc.conv1]), "stem BatchNorm": (enc.bn1, [enc.bn1]),
                "stem max pool": (stem_pool, []),
                "residual block layer2_0": (enc.layer2_0, [enc.layer2_0]),
                "per-frame encoder": (whole(enc), [enc])}

    saved = copy.deepcopy(cpu_enc.state_dict())
    with torch.no_grad():  # each piece's float64 input: the float64 pipeline up to it
        c1 = cpu_enc.conv1(x64)
        b1 = F.relu(cpu_enc.bn1(c1))
        inputs = {"stem conv": x64, "stem BatchNorm": c1, "stem max pool": b1,
                  "residual block layer2_0": cpu_enc.layer1_1(cpu_enc.layer1_0(stem_pool(b1))),
                  "per-frame encoder": x64}
    cpu_enc.load_state_dict(saved)
    err = lambda got, want: ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
    out = {}
    for name, x in inputs.items():
        x = x.to(torch.bfloat16).double()  # bf16-representable
        results = {}
        for side, enc, dev, dtype in (("float64", cpu_enc, "cpu", torch.float64),
                                      ("cpu", cpu_enc, "cpu", torch.bfloat16),
                                      ("card", card_enc, device, torch.bfloat16)):
            fn, mods = pieces(enc)[name]
            params = [p for m in mods for p in m.parameters()]
            state = copy.deepcopy(enc.state_dict())
            xi = x.to(dev, dtype).requires_grad_(True)
            y = fn(xi)
            dy = torch.from_numpy(np.random.default_rng(seed + 1).normal(
                size=tuple(y.shape))).to(dev, y.dtype)
            grads = torch.autograd.grad(y, [xi] + params, dy)
            enc.load_state_dict(state)  # the running statistics as they were
            results[side] = [t.detach().double().cpu() for t in (y, *grads)]
        ref, row = results["float64"], {}
        for side in ("cpu", "card"):
            got = results[side]
            row[side] = {"output": err(got[0], ref[0]), "input_grad": err(got[1], ref[1]),
                         "weight_grads": max((err(g, r) for g, r in zip(got[2:], ref[2:])),
                                             default=0.0)}
        row["card_vs_cpu"] = {"output": err(results["card"][0], results["cpu"][0]),
                              "input_grad": err(results["card"][1], results["cpu"][1])}
        log(f"bf16 {name}: vs float64 on the cpu: cpu {row['cpu']}, card {row['card']}; "
            f"card vs cpu {row['card_vs_cpu']}")
        out[name] = row
    return out


def encoders_reference_phase(device) -> dict:
    """ResNet50 and Swin-T per-frame forwards at 224 px (seeded random
    params and BatchNorm statistics, eval mode): float32 on the card
    against the CPU on 4 frames (ENCODER_F32_TOL of scale; TF32 off), and
    the bf16 forward timed over 128 frames on the card."""
    from soccerdiffusion_tpu_torch.models.vision import make_image_encoder
    from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params, random_jax_params

    out = {}
    for kind in ("resnet50", "swin_transformer_tiny"):
        cpu = make_image_encoder(kind, 128, 224, use_final_avgpool=False)
        load_jax_params(cpu, *random_jax_params(cpu, seed=7))
        cpu.eval()
        gpu = copy.deepcopy(cpu).to(device)
        rng = np.random.default_rng(700)
        x = torch.from_numpy(rng.normal(size=(4, 224, 224, 3)).astype(np.float32))
        with torch.no_grad():
            ref = cpu(x)
            got = gpu(x.to(device)).cpu()
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        log(f"{kind} forward, 4 frames at 224 px, float32: card vs cpu max_abs_err={err:.4e} "
            f"max|cpu|={scale:.4e} (tol {ENCODER_F32_TOL} x max|cpu|)")
        if not (torch.isfinite(got).all() and err <= ENCODER_F32_TOL * scale):
            raise AssertionError(f"{kind}: the card's forward disagrees with the CPU's")
        bf = make_image_encoder(kind, 128, 224, use_final_avgpool=False, dtype=torch.bfloat16)
        bf.load_state_dict(cpu.state_dict())
        bf = bf.to(device).eval()
        x = torch.from_numpy(rng.normal(size=(128, 224, 224, 3)).astype(np.float32)).to(
            device, torch.bfloat16)
        flops = forward_flops(bf, x)
        with torch.no_grad():
            ms = median_ms(lambda: bf(x))
        rate = flops / (ms * 1e-3)
        log(f"{kind} per-frame encoder, 128 frames (bf16, eval): {ms:.3f} ms, "
            f"{flops / 128 / 1e9:.3f} GFLOP a frame, {rate / 1e12:.1f} TFLOP/s = "
            f"{rate / BF16_FLOPS:.3f} of 989 TFLOP/s")
        out[kind] = {"max_abs_err_f32": err, "ms_128_frames_bf16": ms,
                     "share_of_bf16_peak": rate / BF16_FLOPS}
    return out


def decoder_only_phase(device) -> tuple[dict, dict, dict, float]:
    """decoder_only.yaml's model (h256, 4 heads of 64, every context
    modality off; bf16): the chunk sampler, the K/V pack and the denoiser
    against their plain versions at S=0 context tokens (only the step
    token's key) at DECODER_ONLY_BATCHES robots; its serving lanes (the
    chunk sampler, the distilled denoiser) at DECODER_ONLY_B with exact
    launches per period; then TRAIN_STEPS training steps through
    training/train.py at TRAIN_BATCH."""
    cfg = dataclasses.replace(yaml_config("decoder_only.yaml").model, compute_dtype="bfloat16")
    model = build_model(cfg, device, seed=8)
    results = {}
    for b in DECODER_ONLY_BATCHES:
        rng = np.random.default_rng(800 + b)
        with torch.no_grad():
            context = model.encode_context({"joint_command": torch.zeros((b, 0, 0),
                                                                         device=device)})
            noise = torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32)).to(device)
            r_chunk, r_den, r_pack = decoder_checks(model, context, noise, device, b, "_s0")
        merge(results, "fused_chunk_s0", r_chunk)
        merge(results, "fused_denoise_s0", r_den)
        merge(results, "fused_denoise_pack_s0", r_pack)
    lanes = {"ddim30": RESNET_LANES["ddim30"], "distilled1": RESNET_LANES["distilled1"]}
    launches, periods = lanes_phase(model, device, lanes, DECODER_ONLY_B, "decoder-only")
    with tempfile.TemporaryDirectory() as tmp:
        config = dataclasses.replace(yaml_config("decoder_only.yaml", batch_size=TRAIN_BATCH,
                                                 log_every=TRAIN_LOG_EVERY), model=cfg)
        zero_counters()
        ms, losses = timed_training(config, tmp, "decoder_only")
        no_flash(read_counters())
    log(f"decoder-only training (train.py, decoder_only.yaml in bf16, synthetic data, "
        f"B={TRAIN_BATCH}, {TRAIN_STEPS} steps): {ms:.3f} ms/step; logged losses {losses}")
    return results, launches, periods, ms


# ------------------------------------------------------- larger_model

# larger_model.yaml's serving lanes at LARGER_B robots: the decoder kernels'
# head_dim-128 instances (hidden 512, 4 heads of 128, 8 decoder layers): the
# chunk sampler, or the distilled denoiser and its K/V pack (a launch per
# decoder layer: 8); no fused encoder (an image config takes the model's
# context encoder)
LARGER_B = 64
LARGER_LANES = {
    "ddim30": (dict(fused="chunk"), {"fused_chunk": 1}),
    "ddim30_raw_frames": (dict(fused="chunk", cache_image_tokens=False), {"fused_chunk": 1}),
    "distilled1": (dict(distilled=True, fused=True), {"fused_denoise": 1,
                                                      "fused_denoise_pack": 8}),
}


def larger_config():
    """larger_model.yaml's model in bf16 (the YAML serves in the compute
    dtype it is given; the decoder kernels take bf16)."""
    return dataclasses.replace(yaml_config("larger_model.yaml").model, compute_dtype="bfloat16")


def larger_model(device, seed=5):
    """larger_model.yaml's policy with flax's seeded initial variables
    (``flax_init_params``: the random ResNet18 init the YAML starts from)."""
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

    model = DiffusionPolicy(larger_config())
    return load_jax_params(model, *flax_init_params(model, seed)).to(device).eval()


def larger_model_phase(device) -> tuple[dict, dict, dict]:
    """larger_model.yaml at full width (``larger_model``'s weights): the
    chunk sampler, the K/V pack and the denoiser at head_dim 128 against
    their plain versions at LARGER_B robots on the context of a random batch
    with cached image tokens; the three serving lanes at LARGER_B with exact
    launches per period; 2 periods card vs CPU of the chunk lane and of the
    distilled lane."""
    model = larger_model(device)
    cfg = model.config
    rng = np.random.default_rng(1100)
    with torch.no_grad():
        batch = random_batch(cfg, LARGER_B, device, rng)
        tokens = rng.normal(size=(LARGER_B, cfg.image_context_length, cfg.hidden_dim))
        batch["image_tokens"] = torch.from_numpy(tokens.astype(np.float32)).to(device)
        context = model.encode_context(batch)
        noise = torch.from_numpy(rng.normal(size=(LARGER_B, 10, 20)).astype(np.float32)).to(device)
        r_chunk, r_den, r_pack = decoder_checks(model, context, noise, device, LARGER_B, "_hd128")
    launches, periods = lanes_phase(model, device, LARGER_LANES, LARGER_B, "larger_model")
    for kw in (dict(fused="chunk"), dict(distilled=True, fused=True)):
        reference_phase(cfg, model, device, b=4, fused_encoder=False, **kw)
    return ({"fused_chunk_hd128": r_chunk, "fused_denoise_hd128": r_den,
             "fused_denoise_pack_hd128": r_pack}, launches, periods)


# ------------------------------------------------------- the decoder kernels' shared memory

def smem_mirror_phase() -> int:
    """ops/fused_denoise.py:pass_smem_bytes, which the wrappers' shape checks
    use, against the C function the kernels launch with
    (sd_pass_smem_bytes) over a grid: head_dim 32 / 64 (hidden 128 and 256)
    / 128, L in {2, 4, 8}, S in {0, 311, ..., 1023}, every block size each
    head dim runs, one block and a cluster, the chunk sampler's carry and
    the denoiser's. Returns the number of cases."""
    from soccerdiffusion_tpu_torch.ops import _build
    from soccerdiffusion_tpu_torch.ops.fused_denoise import pass_smem_bytes, padded_keys, r4

    lib, n = _build.library(), 0
    widths = {32: [(128, 4)], 64: [(128, 2), (256, 4)], 128: [(512, 4)]}
    threads = {32: (512, 256), 64: (512,), 128: (256,)}
    P, J, Jp = 10, 20, 32
    for D, shapes in widths.items():
        for (E, H), L, S, th, cs, carry in itertools.product(
                shapes, (2, 4, 8), (0, 311, 415, 447, 543, 575, 639, 1023), threads[D], (1, 2),
                (0, 2 * r4(P * J))):
            args = (L, P, E, H, J, Jp, padded_keys(S), th, cs, carry)
            want, got = lib.sd_pass_smem_bytes(_build.ints(*args)), pass_smem_bytes(*args)
            if want != got:
                raise AssertionError(f"pass_smem_bytes{args}: Python mirror {got}, C {want}")
            n += 1
    log(f"shared-memory plan: the Python mirror equals sd_pass_smem_bytes in all {n} cases")
    from soccerdiffusion_tpu_torch.ops.fused_chunk import int8_keys, int8_smem_bytes

    m = 0
    for D, shapes in widths.items():
        for (E, H), L, S in itertools.product(shapes, (2, 4, 8), (1, 301, 311, 447, 575, 1023)):
            args = (L, P, E, H, J, Jp, int8_keys(S))
            want, got = lib.sd_int8_smem_bytes(_build.ints(*args)), int8_smem_bytes(*args)
            if want != got:
                raise AssertionError(f"int8_smem_bytes{args}: Python mirror {got}, C {want}")
            m += 1
    log(f"int8 chunk's shared memory: the Python mirror equals sd_int8_smem_bytes in all {m} "
        "cases")
    return n + m


# ------------------------------------------------------- distillation and guidance
# larger_model_distill.yaml at full width (hidden 512, 8 decoder layers of 4
# heads of 128, 4-layer stacks, ResNet18 at 224 px) and its own B=32, in bf16
# (the decoder kernels' dtype) with modality dropout 0.15: a teacher trained
# 2 steps, three students distilled 2 steps each through the CLI, each
# served at LARGER_B; the flagship's distillation step at DISTILL_FLAG_B
DISTILL_YAML = "larger_model_distill.yaml"
DISTILL_MODES = {
    "student1": ["--student-steps", "1"],
    "student4_guided_image": ["--student-steps", "4", "--guidance", "3.0@image"],
    "student1_draws2": ["--student-steps", "1", "--teacher-draws", "2"],
}
DISTILL_STEPS, DISTILL_FLAG_B = 2, 64
# kernel launches of one flagship distillation step of a K-step student:
# the teacher's encode (8 ViT blocks, 3 hd64 stacks + the image-frame
# stack), its 30-step rollout (4 decoder layers a step, forward only), the
# student's K steps (4 layers each, forward and backward)
def flag_distill_launches(k: int) -> dict:
    fwd, bwd = 4 * (30 + k), 4 * k
    return {"fused_vit_block_fwd": 8, "fused_encoder_stack_fwd": 4,
            "fused_encoder_stack_fwd_hd64": 3, "fused_decoder_layer_fwd": fwd,
            "fused_decoder_layer_fwd_hd64": fwd, "fused_decoder_layer_bwd": bwd,
            "fused_decoder_layer_bwd_hd64": bwd}


def distill_setup(teacher, device, **kw):
    """A student copied from ``teacher`` (on ``device``), its masked
    optimizer, state and distillation step (30 teacher steps)."""
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.training.distill import TRAINABLE, make_distill_step
    from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer

    teacher = teacher.to(device).eval().requires_grad_(False)
    student = copy.deepcopy(teacher).requires_grad_(True)
    opt = make_optimizer(student, 1e-3, 10, trainable=TRAINABLE)
    step = make_distill_step(student, make_schedule(1000), opt, teacher_inference_steps=30, **kw)
    return teacher, student, create_train_state(student, opt), step


def distill_inputs(cfg, batch, device, rng, draws=1):
    b = batch["joint_command"].shape[0]
    shape = (b, cfg.trajectory_prediction_length, cfg.num_joints)
    noise = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
    draw = (torch.from_numpy(rng.normal(size=(draws, *shape)).astype(np.float32)).to(device)
            if draws > 1 else None)
    return noise, draw


def timed_distill(label, teacher, batch, device, **kw) -> tuple[float, int]:
    """(ms of a distillation step on ``device``: the median of 3 after 1, each
    between device syncs (host clock); the device's peak memory in bytes
    during the second step)."""
    _, student, state, step = distill_setup(teacher, device, **kw)
    rng = np.random.default_rng(7)
    times = []
    for i in range(4):
        noise, draw = distill_inputs(student.config, batch, device, rng, kw.get("teacher_draws", 1))
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = step.apply(state, teacher, batch, noise, draw)
        loss = metrics["loss"].item()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            peak = torch.cuda.max_memory_allocated()
        if not np.isfinite(loss):
            raise AssertionError(f"{label}: distillation step {i} loss {loss}")
    ms = statistics.median(times[1:])
    log(f"distillation step {label}: {ms:.2f} ms (median of 3 after 1; steps {times}); peak "
        f"device memory {peak / 2**30:.2f} GiB")
    return ms, peak


def distill_reference_phase(device, cfg, batches, seed, **kw) -> dict:
    """Distillation steps on the card against the same steps of the plain
    versions on the CPU, one per batch of ``batches`` (CPU tensors), from the
    same teacher (flax's seeded init) and noise: the losses within
    STEP_LOSS_TOL relative, the students' update norm within STEP_UPDATE_TOL,
    and on both devices every parameter outside the denoiser and the step
    token bit for bit the teacher's. Raises past a gate."""
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.training.distill import TRAINABLE
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

    base = DiffusionPolicy(cfg)
    base = load_jax_params(base, *flax_init_params(base, seed))
    rng = np.random.default_rng(seed)
    runs = {dev: (*distill_setup(copy.deepcopy(base), dev, **kw), []) for dev in (device, "cpu")}
    for batch in batches:
        noise, draw = distill_inputs(cfg, batch, "cpu", rng, kw.get("teacher_draws", 1))
        for dev, (teacher, _, state, step, losses) in runs.items():
            on = lambda x: None if x is None else x.to(dev)
            metrics = step.apply(state, teacher, {k: on(v) for k, v in batch.items()}, on(noise),
                                 on(draw))
            losses.append(metrics["loss"].item())
    (tg, sg, _, _, gl), (tc, sc, _, _, cl) = runs[device], runs["cpu"]
    loss_rel = [abs(lg - lc) / abs(lc) for lg, lc in zip(gl, cl)]
    p0 = dict(base.named_parameters())
    num = den = 0.0
    for (name, pg), pc in zip(sg.named_parameters(), sc.parameters()):
        num += ((pg.detach().cpu() - pc.detach()) ** 2).sum().item()
        den += ((pc.detach() - p0[name].detach()) ** 2).sum().item()
    upd = (num / den) ** 0.5
    for teacher, student in ((tg, sg), (tc, sc)):
        frozen = dict(teacher.named_parameters())
        for name, p in student.named_parameters():
            if not name.startswith(TRAINABLE) and not torch.equal(p, frozen[name]):
                raise AssertionError(f"distillation moved the frozen parameter {name}")
    log(f"distillation card vs cpu ({cfg.compute_dtype}, {kw}, B={len(batches[0]['joint_command'])}, "
        f"{len(batches)} steps): losses card {gl}, cpu {cl}, relative differences {loss_rel} "
        f"(tol {STEP_LOSS_TOL}); update norm {upd:.3e} (tol {STEP_UPDATE_TOL}); frozen "
        f"parameters bit for bit the teacher's on both")
    if max(loss_rel) > STEP_LOSS_TOL or upd > STEP_UPDATE_TOL:
        raise AssertionError("the card's distillation steps disagree with the plain path")
    return {"loss_rel": loss_rel, "update_norm": upd}


def served_period(label, model, device, per_period, b=LARGER_B, **kw) -> tuple[float, dict]:
    """A checkpoint's policy served at B=b, CHUNKS periods after a warm-up
    one, every counter zeroed just before and read just after: each kernel
    exactly its count per period, no other kernel."""
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.inference import RolloutEngine

    eng = RolloutEngine(model, make_schedule(1000), kw.pop("normalizer"), device=device, **kw)
    eng.make_rollout_fn(1)(eng.init(b, torch.Generator(device=device).manual_seed(0)))
    ms, got = timed_rollout(eng, device, 1, b, CHUNKS)
    want = {name: per_period.get(name, 0) * CHUNKS for name in got}
    log(f"served {label} B={b}, {CHUNKS} periods: {ms:.2f} ms/period, {b * 1e3 / ms:.1f} "
        f"chunks/s; launches {got}")
    if got != want:
        raise AssertionError(f"served {label}: launches {got}, expected {want}")
    return ms, got


def distill_larger_phase(device) -> dict:
    """larger_model_distill.yaml at full width in bf16: train() 2 steps with
    modality dropout 0.15 (packed data), distill.main 2 steps in each of
    DISTILL_MODES, load_policy_checkpoint on each student; each mode's
    step timed on the trained teacher; the 1-step student served on the
    head_dim-128 denoiser and its pack, the 4-step student on the chunk
    sampler at T=4, the guided teacher (3.0@image, raw frames) on the plain
    sampler; then 3 float32 steps card vs CPU (the guided 4-step mode)."""
    import yaml

    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.training import distill
    from soccerdiffusion_tpu_torch.training.checkpoint import load_policy
    from soccerdiffusion_tpu_torch.training.train import RunOptions, build_dataset, train
    from soccerdiffusion_tpu_torch.data.pipeline import to_tensors

    out = {"launches": {}, "step_ms": {}, "peak_bytes": {}, "period_ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        params = yaml.safe_load(open(CONFIG_DIR / DISTILL_YAML))
        params.update(compute_dtype="bfloat16", modality_dropout=0.15, log_every=1)
        yml = Path(tmp) / DISTILL_YAML
        yml.write_text(yaml.safe_dump(params))
        config = Config.from_dict(params)
        teacher_ckpt = f"{tmp}/teacher"
        t0 = time.perf_counter()
        state = train(config, RunOptions(output=teacher_ckpt, dummy_data=True, packed=True,
                                         epochs=1, steps_per_epoch=2, seed=0,
                                         metrics=f"{tmp}/teacher.jsonl"), hyperparams=params)
        losses = [json.loads(line)["loss"] for line in open(f"{tmp}/teacher.jsonl")]
        log(f"{DISTILL_YAML} teacher (bf16, modality_dropout 0.15, B={config.train.batch_size}): "
            f"train() {state.step} steps in {time.perf_counter() - t0:.1f} s, losses {losses}")
        if state.step != 2 or not all(np.isfinite(losses)):
            raise AssertionError(f"teacher training: {state.step} steps, losses {losses}")
        del state
        students = {}
        for mode, flags in DISTILL_MODES.items():
            path = f"{tmp}/{mode}"
            t0 = time.perf_counter()
            zero_counters()
            st = distill.main([str(yml), teacher_ckpt, "-o", path, "--dummy-data", "--epochs", "1",
                               "--steps-per-epoch", str(DISTILL_STEPS), "--metrics",
                               f"{tmp}/{mode}.jsonl", *flags])
            torch.cuda.synchronize()
            got = read_counters()
            records = [json.loads(line) for line in open(f"{tmp}/{mode}.jsonl")]
            log(f"distill.main {mode} ({' '.join(flags)}): {st.step} steps in "
                f"{time.perf_counter() - t0:.1f} s, losses {[r['loss'] for r in records]}, "
                f"grad norms {[r['grad_norm'] for r in records]}; launches {got}")
            if st.step != DISTILL_STEPS or not all(np.isfinite(r["loss"]) for r in records):
                raise AssertionError(f"distill.main {mode}: {st.step} steps, {records}")
            if any(got.values()):  # the YAML turns no fused knob on
                raise AssertionError(f"a kernel of the port ran on {mode}'s distillation: {got}")
            students[mode] = load_policy(path, device)
            del st
        torch.cuda.empty_cache()
        s1, s4 = students["student1"], students["student4_guided_image"]
        if (s1[2], s1[3]) != (1, True) or (s4[2], s4[3]) != (4, False):
            raise AssertionError(f"load_policy_checkpoint: (steps, distilled) {s1[2:4]}, {s4[2:4]}")
        if s4[4].get("distilled_guidance_null") != ["image"]:
            raise AssertionError(f"the guided student's flags: {s4[4]}")
        # each mode's step on the trained teacher (median of 3 after 1)
        teacher, t_norm, _, _, _ = load_policy(teacher_ckpt, device)
        dataset = build_dataset(config, 0, True)
        batch = {k: v.to(device) for k, v in to_tensors(next(dataset.batches(
            config.train.batch_size, seed=0))).items()}
        for mode, kw in (("student1", {}),
                         ("student4_guided_image", dict(student_steps=4, guidance_scale=3.0,
                                                        guidance_null=("image",))),
                         ("student1_draws2", dict(teacher_draws=2))):
            out["step_ms"][mode], out["peak_bytes"][mode] = timed_distill(
                f"{DISTILL_YAML} {mode} B={config.train.batch_size}", teacher, batch, device, **kw)
        del batch
        # the students served on the head_dim-128 kernels, the teacher guided
        model, norm, steps, distilled, _ = s1
        out["period_ms"]["student1"], out["launches"]["student1"] = served_period(
            "student1 (distilled=True, fused=True)", model, device,
            {"fused_denoise": 1, "fused_denoise_pack": 8}, normalizer=norm,
            num_inference_steps=steps, distilled=distilled, fused=True)
        model, norm, steps, _, _ = s4
        out["period_ms"]["student4"], out["launches"]["student4"] = served_period(
            "student4 (fused=\"chunk\", T=4)", model, device, {"fused_chunk": 1}, normalizer=norm,
            num_inference_steps=steps, fused="chunk")
        out["period_ms"]["teacher_guided_image"], _ = served_period(
            "teacher, guided 3.0@image on the plain sampler (raw frames)", teacher, device, {},
            normalizer=t_norm, num_inference_steps=30, guidance_scale=3.0,
            guidance_null=("image",), cache_image_tokens=False)
    del students, teacher
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(yaml_config(DISTILL_YAML).model, compute_dtype="float32")
    out["card_vs_cpu"] = distill_reference_phase(
        device, f32, reference_batches(yaml_config(DISTILL_YAML)), 15, student_steps=4,
        guidance_scale=3.0, guidance_null=("image",))
    return out


def distill_flagship_phase(device) -> dict:
    """vit_flagship.yaml (flax's seeded init) at DISTILL_FLAG_B robots: one
    distillation step of a 4-step student with every counter zeroed just
    before and read just after (exactly flag_distill_launches(4): the
    teacher's encode on the ViT blocks and the stacks, its rollout and the
    student on the decoder layers) and its peak device memory; the 1- and
    4-step students' step times; then 3 bf16 steps card vs CPU at B=2."""
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

    cfg = flagship_config()
    teacher = DiffusionPolicy(cfg)
    teacher = load_jax_params(teacher, *flax_init_params(teacher, 16)).to(device)
    batch = {k: v.to(device) for k, v in flagship_reference_batches(DISTILL_FLAG_B, 1)[0].items()}
    teacher, _, state, step = distill_setup(teacher, device, student_steps=4)
    noise, _ = distill_inputs(cfg, batch, device, np.random.default_rng(3))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    metrics = step.apply(state, teacher, batch, noise)
    torch.cuda.synchronize()
    launches, peak = read_counters(), torch.cuda.max_memory_allocated()
    want = {name: flag_distill_launches(4).get(name, 0) for name in launches}
    log(f"flagship distillation step (4-step student, B={DISTILL_FLAG_B}): loss "
        f"{metrics['loss'].item():.6f}, grad norm {metrics['grad_norm'].item():.6f}; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    if launches != want:
        raise AssertionError(f"flagship distillation: launches {launches}, expected {want}")
    del state, step
    ms = {f"student{k}": timed_distill(f"vit_flagship.yaml student{k} B={DISTILL_FLAG_B}",
                                       teacher, batch, device, student_steps=k)[0] for k in (1, 4)}
    del teacher, batch
    torch.cuda.empty_cache()
    ref = distill_reference_phase(device, cfg, flagship_reference_batches(), 16, student_steps=4)
    return {"launches": launches, "step_ms": ms, "peak_bytes": peak, "card_vs_cpu": ref}


# ------------------------------------------------------- recorded data (SQLite)

# the recorded-data database: 2 recordings of 800 rows at 100 Hz, a 480 px
# frame every 10 rows (the schema's default frame size, ~110 MB)
DB_RECORDINGS, DB_ROWS, DB_IMAGE_STEP, DB_IMAGE_SIZE, RECORDED_B = 2, 800, 10, 480, 64
# h128 fused training step: 3 stacks and 4 decoder layers (head_dim 32), fwd + bwd
H128_STEP_LAUNCHES = {"fused_encoder_stack_fwd": 3, "fused_encoder_stack_bwd": 3,
                      "fused_decoder_layer_fwd": 4, "fused_decoder_layer_bwd": 4}


def host_ms(fn, reps=5, warm=1) -> float:
    """Median host-clock ms of ``fn()`` (work on the host only)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def median_after_first(metrics_path) -> tuple[float, list[float]]:
    """ms of each step of a log_every=1 run (host clock between the device
    syncs that end consecutive steps), and the median of those after the first."""
    steps = [1e3 / json.loads(line)["steps_per_sec"] for line in open(metrics_path)]
    return statistics.median(steps[1:]), steps


def recorded_train(config, tmp, label, steps, device, **opts) -> tuple:
    """training/train.py's train() for ``steps`` steps (one epoch, a sync
    each step) with every counter zeroed just before and read just after:
    (state, launches, median step ms, every step's ms, the metric records)."""
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train

    config = dataclasses.replace(config, train=dataclasses.replace(config.train, log_every=1))
    metrics = f"{tmp}/metrics_{label}.jsonl"
    torch.cuda.synchronize()
    zero_counters()
    state = train(config, RunOptions(output=f"{tmp}/ckpt_{label}", epochs=1, steps_per_epoch=steps,
                                     seed=0, metrics=metrics, device=device, **opts))
    torch.cuda.synchronize()
    launches = read_counters()
    records = [json.loads(line) for line in open(metrics)]
    if state.step != steps or not all(np.isfinite(r["loss"]) for r in records):
        raise AssertionError(f"{label}: {state.step} steps, losses {[r['loss'] for r in records]}")
    ms, each = median_after_first(metrics)
    return state, launches, ms, each, records


def expect_launches(label, got, per_step, steps) -> dict:
    """Each kernel exactly ``per_step`` launches a step, no other kernel;
    returns the kernels that ran."""
    want = {name: per_step.get(name, 0) * steps for name in got}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    return {name: n for name, n in got.items() if n}


def write_recorded_db(path) -> float:
    """The recorded-data database (the port's create_schema +
    insert_dummy_data), and a v1 database (no elbow-yaw columns) migrated to
    v2 beside it; returns the seconds the write took."""
    import sqlite3

    from soccerdiffusion_tpu_torch.config import CANONICAL_JOINT_NAMES_20
    from soccerdiffusion_tpu_torch.data.dummy import insert_dummy_data
    from soccerdiffusion_tpu_torch.data.migrations import migrate, schema_version
    from soccerdiffusion_tpu_torch.data.schema import connect, create_schema

    t0 = time.perf_counter()
    conn = connect(path)
    create_schema(conn)
    insert_dummy_data(conn, DB_RECORDINGS, DB_ROWS, DB_IMAGE_STEP, seed=0, image_size=DB_IMAGE_SIZE)
    version = schema_version(conn)
    conn.close()
    seconds = time.perf_counter() - t0
    old = sqlite3.connect(path.with_name("v1.sqlite3"))
    cols = ", ".join(f'"{n}" FLOAT DEFAULT 0.0' for n in CANONICAL_JOINT_NAMES_20)
    for table in ("JointStates", "JointCommands"):
        old.execute(f"CREATE TABLE {table} (_id INTEGER PRIMARY KEY, stamp FLOAT, "
                    f"recording_id INTEGER, {cols})")
    old.execute('INSERT INTO JointStates (stamp, recording_id, "HeadPan") VALUES (0, 1, 1.5)')
    old.commit()
    before = schema_version(old)
    after = migrate(old)
    elbow = old.execute('SELECT "RElbowYaw", "LElbowYaw" FROM JointStates').fetchone()
    old.close()
    log(f"recorded-data database: {DB_RECORDINGS} recordings x {DB_ROWS} rows, a "
        f"{DB_IMAGE_SIZE} px frame every {DB_IMAGE_STEP} rows, {path.stat().st_size} bytes, "
        f"written in {seconds:.2f} s, schema v{version}; a v1 database migrated v{before} -> "
        f"v{after} (elbow yaw {elbow})")
    if version != 2 or (before, after) != (1, 2) or elbow != (0.0, 0.0):
        raise AssertionError("the schema or its migration is wrong")
    return seconds


def recorded_h128_phase(db, tmp, device, smi) -> dict:
    """bench_config with the fused stacks and decoder layers (h128, bf16) on
    the database: DeviceResidentData's batches equal the host-assembled
    batches moved to the card bit for bit; train() --db 4 steps with
    --device-data and 4 without (exact launches; step ms: median of 3 after
    1), --decoder-pretraining 2 steps, --pretrained-decoder from it (the
    decoder equals the checkpoint's raw parameters before any step), and the
    --device-data checkpoint served on the context encoder and the chunk
    sampler at B=64."""
    from soccerdiffusion_tpu_torch.data import WindowedDataset
    from soccerdiffusion_tpu_torch.data.packed import PackedDataset
    from soccerdiffusion_tpu_torch.data.pipeline import DeviceResidentData, to_tensors
    from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint, load_policy

    out = {"launches": {}, "step_ms": {}}
    config = train_config(True)
    config = dataclasses.replace(config, train=dataclasses.replace(config.train,
                                                                   batch_size=RECORDED_B))
    t0 = time.perf_counter()
    dataset = WindowedDataset.from_sqlite(db, config.model)
    out["db_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    resident = DeviceResidentData(dataset, device)
    torch.cuda.synchronize()
    out["device_data_build_s"] = time.perf_counter() - t0
    for seed in (0, 1):
        for host, dev in zip(itertools.islice(dataset.batches(RECORDED_B, seed=seed), 3),
                             resident.batches(RECORDED_B, seed=seed)):
            for k, v in to_tensors(host).items():
                if not torch.equal(v.to(device), dev[k]):
                    raise AssertionError(f"a device-resident batch differs from the host's: {k}")
    batch_bytes = sum(v.nbytes for v in next(dataset.batches(RECORDED_B, seed=0)).values())
    out["h2d_bytes_per_step"] = {"device_data": 8 * RECORDED_B, "host_batches": batch_bytes}
    # the rows alone (no frames): the C++ assembler against the numpy loop
    idx = np.random.default_rng(1).permutation(len(dataset))[:RECORDED_B]
    rows = {"native": PackedDataset.from_windowed(dataset),
            "native_8_threads": PackedDataset.from_windowed(dataset, num_threads=8),
            "numpy": PackedDataset.from_windowed(dataset, assembler="numpy")}
    want = rows["numpy"].assemble(idx)
    for name in ("native", "native_8_threads"):
        got = rows[name].assemble(idx)
        if any(not np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError(f"the {name} assembler's rows differ from the numpy assembler's")
    out["assemble_rows_ms"] = {name: host_ms(lambda ds=ds: ds.assemble(idx))
                               for name, ds in rows.items()}
    log(f"h128 from the database: from_sqlite {out['db_load_s']:.3f} s ({len(dataset)} windows), "
        f"DeviceResidentData {out['device_data_build_s']:.3f} s; its batches equal the host's "
        f"moved to the card bit for bit (2 seeds x 3 batches); H2D bytes per step: "
        f"{8 * RECORDED_B} with --device-data (the epoch's order, uploaded once), "
        f"{batch_bytes} without; assemble a packed B={RECORDED_B} batch of rows: native (1 "
        f"thread, the default) {out['assemble_rows_ms']['native']:.3f} ms, native (8 threads) "
        f"{out['assemble_rows_ms']['native_8_threads']:.3f} ms, numpy "
        f"{out['assemble_rows_ms']['numpy']:.3f} ms (host, median of 5; equal batches) ({smi})")
    del resident
    for label, opts in (("device_data", dict(device_data=True)), ("host_batches", {})):
        _, got, ms, each, _ = recorded_train(config, tmp, f"h128_{label}", 4, device,
                                             dummy_data=False, db=str(db), **opts)
        out["launches"][label] = expect_launches(f"h128 --db {label}", got, H128_STEP_LAUNCHES, 4)
        out["step_ms"][label] = ms
        log(f"h128 train --db {'--device-data ' if opts else ''}B={RECORDED_B}, 4 steps: "
            f"{ms:.3f} ms/step (median of 3 after 1; steps {[round(x, 3) for x in each]}); "
            f"launches {got} ({smi})")
    _, got, _, _, _ = recorded_train(config, tmp, "h128_pretraining", 2, device, dummy_data=False,
                                     db=str(db), device_data=True, decoder_pretraining=True)
    # the decoder pretraining runs the decoder layers only, against random context tokens
    out["launches"]["decoder_pretraining"] = expect_launches(
        "h128 --decoder-pretraining", got,
        {"fused_decoder_layer_fwd": 4, "fused_decoder_layer_bwd": 4}, 2)
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train

    raw = load_checkpoint(f"{tmp}/ckpt_h128_pretraining")["params"]
    state = train(config, RunOptions(output=f"{tmp}/unused", epochs=0, dummy_data=False,
                                     db=str(db), device=device,
                                     pretrained_decoder=f"{tmp}/ckpt_h128_pretraining"))
    copied = 0
    for name, p in state.model.named_parameters():
        if name.startswith(("diffusion_action_generator.", "step_encoding.")):
            copied += 1
            if not torch.equal(p.detach().cpu(), raw[name]):
                raise AssertionError(f"--pretrained-decoder: {name} is not the checkpoint's")
    log(f"--pretrained-decoder: {copied} decoder / step-token tensors equal the pretraining "
        f"checkpoint's raw parameters before the first step")
    del state
    model, norm, steps, _, _ = load_policy(f"{tmp}/ckpt_h128_device_data", device)
    out["served_ms"], served = served_period(
        "the --db --device-data checkpoint (fused=\"chunk\", fused encoder)", model, device,
        {"fused_encoder": 1, "fused_chunk": 1}, b=RECORDED_B, normalizer=norm,
        num_inference_steps=steps, fused="chunk", fused_encoder=True)
    out["launches"]["served"] = {name: n for name, n in served.items() if n}
    log(f"served period {out['served_ms']:.3f} ms at B={RECORDED_B} ({smi})")
    return out


def recorded_flagship_phase(db, tmp, device, smi) -> dict:
    """vit_flagship.yaml on the database: from_sqlite, PackedDataset.from_windowed
    (480 -> 224 px once), save, load (memory-mapped), prepatchify; the native
    and the numpy assembler timed on a B=64 batch; train() --db --packed 4
    steps at B=64 (exact launches; median of 3 after 1); 3 steps of the
    loaded shard's batches on the card against the CPU. Then the cue head
    and image_encoder_lr_mult 3 on --dummy-data (the "vision" task's
    windows): train() 2 steps at B=64 and 3 steps card vs CPU."""
    from soccerdiffusion_tpu_torch.data import WindowedDataset, generate_dummy_arrays
    from soccerdiffusion_tpu_torch.data.packed import PackedDataset
    from soccerdiffusion_tpu_torch.data.pipeline import to_tensors

    out = {"launches": {}}
    config = flagship_train_config(RECORDED_B)
    cfg = config.model
    t0 = time.perf_counter()
    windows = WindowedDataset.from_sqlite(db, cfg)
    out["db_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = PackedDataset.from_windowed(windows)
    out["pack_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed.save(f"{tmp}/shard")
    out["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = PackedDataset.load(f"{tmp}/shard", cfg)
    out["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded.prepatchify_images(cfg.vit_patch_size)
    out["prepatchify_s"] = time.perf_counter() - t0
    numpy_rows = PackedDataset.load(f"{tmp}/shard", cfg, assembler="numpy")
    numpy_rows.images = loaded.images
    idx = np.random.default_rng(0).permutation(len(loaded))[:RECORDED_B]
    want, got = numpy_rows.assemble(idx), loaded.assemble(idx)
    for k in want:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"the native assembler's {k} differs from the numpy one's")
    out["assemble_ms"] = {name: host_ms(lambda ds=ds: ds.assemble(idx))
                          for name, ds in (("native", loaded), ("numpy", numpy_rows))}
    log(f"flagship from the database: from_sqlite {out['db_load_s']:.3f} s; from_windowed (resize "
        f"{len(packed.images)} frames {DB_IMAGE_SIZE} -> {cfg.image_resolution} px) "
        f"{out['pack_s']:.3f} s; save {out['save_s']:.3f} s, load (mmap) {out['load_s']:.3f} s, "
        f"prepatchify {out['prepatchify_s']:.3f} s; assemble a B={RECORDED_B} batch: native "
        f"{out['assemble_ms']['native']:.3f} ms, numpy {out['assemble_ms']['numpy']:.3f} ms "
        f"(host, median of 5; equal batches) ({smi})")
    _, got, ms, each, _ = recorded_train(config, tmp, "flagship_db", 4, device, dummy_data=False,
                                         db=str(db), packed=True)
    out["launches"]["db_packed"] = expect_launches("flagship --db --packed", got,
                                                   FLAG_TRAIN_LAUNCHES, 4)
    out["step_ms"] = {"db_packed": ms}
    log(f"flagship train --db --packed B={RECORDED_B}, 4 steps: {ms:.3f} ms/step (median of 3 "
        f"after 1; steps {[round(x, 3) for x in each]}); launches {got} ({smi})")
    batches = [to_tensors(b) for b in itertools.islice(loaded.batches(2, seed=0), 3)]
    out["card_vs_cpu"] = training_reference_phase(device, cfg, batches, 16)

    cue = dataclasses.replace(
        config, model=dataclasses.replace(cfg, aux_cue_head=True),
        train=dataclasses.replace(config.train, dummy_task="vision", aux_cue_weight=0.1,
                                  image_encoder_lr_mult=3.0))
    state, got, _, each, records = recorded_train(cue, tmp, "flagship_cue", 2, device,
                                                    dummy_data=True)
    cue_launches = expect_launches("flagship cue head", got, FLAG_TRAIN_LAUNCHES, 2)
    aux = [r["aux_cue_loss"] for r in records]
    groups = [(g["lr_mult"], len(g["params"])) for g in state.optimizer.adamw.param_groups]
    log(f"flagship --dummy-data (vision) with the cue head and image_encoder_lr_mult 3, "
        f"B={RECORDED_B}, 2 steps: steps {[round(x, 3) for x in each]} ms, aux_cue_loss {aux}, "
        f"AdamW groups (lr_mult, tensors) {groups}; launches {got} ({smi})")
    if not all(np.isfinite(aux)) or sorted(m for m, _ in groups) != [1.0, 3.0]:
        raise AssertionError(f"cue head run: aux {aux}, groups {groups}")
    out["launches"]["cue"], out["cue_step_ms"], out["aux_cue_loss"] = cue_launches, each, aux
    del state
    torch.cuda.empty_cache()
    kw = dict(num_recordings=2, num_samples=200, num_joints=cfg.num_joints,
              image_size=cfg.image_resolution, seed=3, task="vision")
    vision = WindowedDataset.from_dummy(generate_dummy_arrays(**kw), cue.model)
    batches = [to_tensors(b) for b in itertools.islice(vision.batches(2, seed=0), 3)]
    out["cue_card_vs_cpu"] = training_reference_phase(
        device, cue.model, batches, 17, aux_cue_weight=0.1,
        lr_mults={"image_sequence_encoder": 3.0})
    return out


def recorded_resnet_phase(db, tmp, device, smi) -> dict:
    """default_tpu.yaml (ResNet18 at 224 px, bf16) on the database through
    the streamed path: each window's frames read from SQLite and resized
    480 -> 224 on the host; one batch's host time, then train() --db 2
    steps at B=64 (no kernel of the port runs: cuDNN and unfused layers)."""
    from soccerdiffusion_tpu_torch.data import WindowedDataset

    config = yaml_config("default_tpu.yaml", batch_size=RECORDED_B)
    dataset = WindowedDataset.from_sqlite(db, config.model)
    t0 = time.perf_counter()
    batch = next(dataset.batches(RECORDED_B, seed=0))
    host_ms = 1e3 * (time.perf_counter() - t0)
    frames = sum(rec.images.fetch_count for rec in dataset.recordings)
    _, got, _, each, _ = recorded_train(config, tmp, "default_tpu_db", 2, device, dummy_data=False,
                                        db=str(db))
    log(f"default_tpu.yaml streamed from the database: a B={RECORDED_B} batch of "
        f"{tuple(batch['image_data'].shape)} frames in {host_ms:.1f} ms on the host ({frames} "
        f"frames read and resized); train --db 2 steps: {[round(x, 3) for x in each]} ms; "
        f"launches {got} ({smi})")
    if any(got.values()):
        raise AssertionError(f"a kernel of the port ran on the ResNet training path: {got}")
    return {"streamed_batch_host_ms": host_ms, "frames_per_batch": frames, "step_ms": each}


def recorded_data_phase(device, smi) -> dict:
    """The recorded-data path: a SQLite database of 480 px frames, then the
    h128, flagship and default_tpu phases above on it."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        db = Path(tmp) / "db.sqlite3"
        out = {"db_write_s": write_recorded_db(db), "db_bytes": db.stat().st_size}
        out["h128"] = recorded_h128_phase(db, tmp, device, smi)
        torch.cuda.empty_cache()
        out["flagship"] = recorded_flagship_phase(db, tmp, device, smi)
        torch.cuda.empty_cache()
        out["default_tpu"] = recorded_resnet_phase(db, tmp, device, smi)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"recorded-data phase: {out['phase_s']:.1f} s")
    return out


# phase 14: evaluation/ and the CLI on vit_flagship.yaml. The checkpoints
# train at B=32 (cut from the YAML's 256) on the "vision" dummy task, whose
# windows carry the image-boundary and Bayes-oracle probes
EVAL_TRAIN_B, EVAL_STEPS = 32, 2
EVAL_WINDOWS, EVAL_CHUNKS, EVAL_BATCH = 64, 3, 32
EVAL_SOLVER_STEPS = 10  # the report's --solver-row ddim10
EVAL_CPU = dict(windows=16, chunks=2, batch_size=8)  # the card-vs-CPU report
SERVE_S = 3.0  # seconds served
EVAL_TOL = 2e-2  # PERF.md §2: each MSE, MAE and divergence value card vs CPU, relative


def eval_yaml(path: Path, **changes) -> Path:
    """vit_flagship.yaml on the "vision" dummy task at B=EVAL_TRAIN_B."""
    import yaml

    params = yaml.safe_load(FLAG_YAML.read_text())
    params.update(dummy_task="vision", batch_size=EVAL_TRAIN_B, **changes)
    path.write_text(yaml.safe_dump(params))
    return path


# the flagship's launches per encode of raw frames (8 ViT blocks; the ViT
# runs per frame, so one launch a block whatever the frame count), per
# encode of the context from frame tokens (3 proprioceptive stacks at
# head_dim 64 + the image-frame stack at head_dim 32), and per full
# model.denoise (4 decoder layers at head_dim 64)
EVAL_FRAMES = {"fused_vit_block_fwd": 8}
EVAL_STACKS = {"fused_encoder_stack_fwd": 4, "fused_encoder_stack_fwd_hd64": 3}
EVAL_DENOISE = {"fused_decoder_layer_fwd": 4, "fused_decoder_layer_fwd_hd64": 4}


def launch_sum(*terms) -> dict:
    """sum of count x launches over (count, launches) pairs."""
    out: dict = {}
    for n, launches in terms:
        for name, k in launches.items():
            out[name] = out.get(name, 0) + n * k
    return out


def report_launches(nb: int, nbb: int, chunks: int, t: int, s: int) -> dict:
    """The kernel launches of phase 14's `cli report` on vit_flagship.yaml's
    fused knobs (evaluation/report.py:run_report with a t-step teacher, a
    1-step distilled student, one s-step DDIM solver row and one image
    guidance row; nb batches of held-out windows, nbb of boundary windows).

    Every open-loop pass encodes raw frames (EVAL_FRAMES + EVAL_STACKS) and
    denoises with full passes (EVAL_DENOISE). Encodes: the teacher's open
    loop nb, its context / image sensitivity 3 nb, the image-shuffled pass
    nb, the boundary probes 2 nbb (sensitivity) + 2 nbb (two passes), the
    guidance row 2 nb + 4 nbb (two encodes a batch, three passes), the
    student's and the solver row's open loop and agreement 3 nb each: 13 nb
    + 8 nbb. Full passes: t nb + 9 nb + t nb + (6 + 2 t) nbb + (t nb + 2 t
    nbb) + (nb + (t + 1) nb) + (s nb + (t + s) nb) = (5 t + 11 + 2 s) nb +
    (6 + 4 t) nbb. The 6 closed-loop rollouts (two a divergence row, two of
    the self-consistency) run the engine's token cache: each period encodes
    its new frames (EVAL_FRAMES) and the context from tokens (EVAL_STACKS);
    the iterative samplers denoise against cached K/V (the plain layer
    math), the distilled student's rollout runs one full pass a period."""
    enc = 13 * nb + 8 * nbb
    passes = (5 * t + 11 + 2 * s) * nb + (6 + 4 * t) * nbb + chunks
    periods = 6 * chunks
    return launch_sum((enc + periods, EVAL_FRAMES), (enc + periods, EVAL_STACKS),
                      (passes, EVAL_DENOISE))


def serve_launches(distilled: bool, steps: int = 0) -> dict:
    """Launches of one `cli serve` replan (make_chunk_sampler on the
    controller's raw frames): the encode, and for the distilled student its
    one full pass; the iterative sampler denoises against cached K/V (no
    kernel). ``steps`` full passes instead: the open-loop plot's sampler."""
    return launch_sum((1, EVAL_FRAMES), (1, EVAL_STACKS),
                      (1 if distilled else steps, EVAL_DENOISE))


def numbers(tree, path=""):
    """(path, value) of every number in a report dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from numbers(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from numbers(v, f"{path}[{i}]")
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield path, float(tree)


def cli_ok(argv, label):
    from soccerdiffusion_tpu_torch import cli

    rc = cli.main(list(map(str, argv)))
    if rc != 0:
        raise AssertionError(f"cli {label}: exit code {rc}")


def eval_db_phase(tmp: Path) -> dict:
    """`cli db create-schema | dummy-data -n 2 -s 400 | migrate` on a fresh
    database, then from_sqlite reads the flagship's windows from it."""
    from soccerdiffusion_tpu_torch.data import WindowedDataset

    db = tmp / "eval.sqlite3"
    t0 = time.perf_counter()
    for verb in (["create-schema"], ["dummy-data", "-n", "2", "-s", "400"], ["migrate"]):
        cli_ok(["db", *verb, "--db", db], f"db {verb[0]}")
    seconds = time.perf_counter() - t0
    ds = WindowedDataset.from_sqlite(str(db), flagship_config())
    item = ds[len(ds) // 2]
    log(f"cli db create-schema, dummy-data -n 2 -s 400, migrate: {seconds:.2f} s, "
        f"{db.stat().st_size} bytes; from_sqlite {len(ds)} windows, frames "
        f"{item['image_data'].shape}")
    if len(ds) != 2 * (400 - 10) or not np.isfinite(item["image_data"]).all():
        raise AssertionError(f"from_sqlite of the CLI's database: {len(ds)} windows")
    return {"db_s": seconds, "db_bytes": db.stat().st_size, "windows": len(ds)}


def eval_checkpoints(tmp: Path, device) -> tuple[Path, Path, Path, dict]:
    """A teacher (`cli train`, EVAL_STEPS steps) and a 1-step student (`cli
    distill`, EVAL_STEPS steps), each with its exact launches."""
    yml = eval_yaml(tmp / "flagship_vision.yaml")
    teacher, student = tmp / "teacher", tmp / "student"
    common = ["--dummy-data", "--epochs", 1, "--steps-per-epoch", EVAL_STEPS, "--device", device]
    out = {}
    for label, argv, per_step in (
            ("train", ["train", "-c", yml, "-o", teacher, *common], FLAG_TRAIN_LAUNCHES),
            ("distill", ["distill", yml, teacher, "-o", student, "--student-steps", 1, *common],
             flag_distill_launches(1))):
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        cli_ok(argv, label)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_counters()
        out[label] = {"s": seconds,
                      "launches": expect_launches(f"cli {label}", got, per_step, EVAL_STEPS)}
        log(f"cli {label} vit_flagship.yaml (vision task) B={EVAL_TRAIN_B}, {EVAL_STEPS} steps: "
            f"{seconds:.2f} s; launches {out[label]['launches']}")
    return yml, teacher, student, out


def eval_report_phase(tmp: Path, teacher, student, device, smi) -> dict:
    """`cli report` on the card: the teacher, the student, --solver-row
    ddim10 and --guidance-row 2.0@image at --windows 64 --chunks 3
    --batch-size 32; wall time, exact launches, every number finite."""
    out_path = tmp / "report"
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    cli_ok(["report", "--teacher", teacher, "--student", student, "--solver-row",
            f"ddim{EVAL_SOLVER_STEPS}", "--guidance-row", "2.0@image", "--dummy-data",
            "--windows", EVAL_WINDOWS, "--chunks", EVAL_CHUNKS, "--batch-size", EVAL_BATCH,
            "--out", out_path, "--device", device], "report")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counters()
    result = json.loads(out_path.with_suffix(".json").read_text())
    nb = -(-result["num_windows"] // EVAL_BATCH)
    nbb = -(-result["image_shuffled_open_loop_boundary"]["num_windows"] // EVAL_BATCH)
    t_steps = result["checkpoints"][0]["open_loop"]["sampler"]
    want = report_launches(nb, nbb, EVAL_CHUNKS, int(t_steps.removeprefix("ddim")),
                           EVAL_SOLVER_STEPS)
    want = {name: want.get(name, 0) for name in got}
    markdown = out_path.with_suffix(".md").read_text()
    log(f"cli report on the card ({nb} + {nbb} batches of {EVAL_BATCH}, {EVAL_CHUNKS} chunks): "
        f"{wall:.2f} s; launches {got} ({smi})")
    log(markdown)
    if got != want:
        raise AssertionError(f"cli report: launches {got}, expected {want}")
    bad = [p for p, v in numbers({k: result[k] for k in ("noise_floor_mse", "checkpoints",
                                                          "guidance")}) if not np.isfinite(v)]
    if bad or [c["name"] for c in result["checkpoints"]] != [
            "teacher", "student", f"teacher+ddim{EVAL_SOLVER_STEPS}"]:
        raise AssertionError(f"cli report: non-finite {bad}, rows {result['checkpoints']}")
    return {"wall_s": wall, "launches": {k: v for k, v in got.items() if v},
            "batches": [nb, nbb], "noise_floor_mse": result["noise_floor_mse"],
            "rows": {c["name"]: c["open_loop"]["mse"] for c in result["checkpoints"]},
            "oracle": result.get("oracle_open_loop")}


class CapturedLaunches:
    """While entered, records the arguments of the first ``keep[module]``
    forward launches of rows 4-6 (the ViT block, the encoder stack, the
    decoder layer) as the model hands them to the kernels' wrappers."""

    def __init__(self, keep: dict):
        self.keep, self.calls, self.saved = keep, [], {}

    def __enter__(self):
        for module, limit in self.keep.items():
            orig = self.saved[module] = module.forward_kernel

            def record(*args, module=module, orig=orig, limit=limit):
                if sum(m is module for m, _ in self.calls) < limit:
                    self.calls.append((module, args))
                return orig(*args)

            record.__dict__ = orig.__dict__  # a wrapper's counter may live on the function
            module.forward_kernel = record
        return self

    def __exit__(self, *exc):
        for module, orig in self.saved.items():
            module.forward_kernel = orig


def path_kernel_checks(model, run, b: int, suffix: str) -> dict:
    """Runs ``run()`` (one encode and one full denoise of ``model`` on the
    card) with the launches captured, then holds each captured launch of the
    ViT block, the encoder stack and the decoder layer against its plain
    version on the same inputs (compare(): TOL x max|plain|, both timed,
    and the torch.nn layer on the same weights for library_ms). Returns the
    instances, named by kernel and head_dim plus ``suffix``,
    each with its largest error over the launches."""
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    cfg = model.config
    with torch.no_grad(), CapturedLaunches({fvb: 8, fes: 4, fdl: cfg.num_decoder_layers}) as cap:
        run()
    torch.cuda.synchronize()
    saved, results = cap.saved, {}
    for i, (module, args) in enumerate(cap.calls):
        if module is fvb:
            x, w, heads, gelu = args
            name, flops = "fused_vit_block_fwd", x.shape[0] * enc_layer_flops(
                x.shape[1], x.shape[2], w[8].shape[-1])
            inputs, kernel = [x, w], lambda args=args: saved[fvb](*args)
            plain = lambda x=x, w=w, heads=heads, gelu=gelu: fvb.forward_plain(x, w, heads, gelu)
            library_fn = lambda x=x, lib=torch_encoder([t[None] for t in w], heads, quick_gelu
                                                       if gelu == "quick" else "gelu"): lib(x)
        elif module is fes:
            x, w, heads = args
            (_, t, e), layers = x.shape, w[0].shape[0]
            name = "fused_encoder_stack_fwd_" + ("hd64" if e == 64 * heads else "imgseq")
            flops = b * layers * enc_layer_flops(t, e, w[8].shape[-1])
            inputs, kernel = [x, w], lambda args=args: saved[fes](*args)[0]
            plain = lambda x=x, w=w, heads=heads: fes.forward_plain(x, w, heads)
            library_fn = lambda x=x, lib=torch_encoder(w, heads): lib(x)
        else:
            x, mem, w, heads = args[:4]
            (_, p, e), s = x.shape, mem.shape[1]
            name = "fused_decoder_layer_fwd" + ("_hd64" if e == 64 * heads else "")
            flops = b * (dec_layer_flops(p, s, e, w[18].shape[-1]) + 4 * s * e * e)  # + memory K/V
            inputs, kernel = [x, mem, w], lambda args=args: saved[fdl](*args)
            plain = lambda x=x, mem=mem, w=w, heads=heads: fdl.forward_plain(x, mem, w, heads)
            library_fn = lambda x=x, mem=mem, lib=torch_decoder_layer(w, heads): lib(x, mem)
        with torch.no_grad():
            merge(results, name + suffix,
                  compare(f"{name}{suffix}[{i}]", kernel, plain, b, flops, inputs, library_fn))
    want = {"fused_vit_block_fwd", "fused_encoder_stack_fwd_hd64",
            "fused_encoder_stack_fwd_imgseq", "fused_decoder_layer_fwd_hd64"}
    if {name.removesuffix(suffix) for name in results} != want:
        raise AssertionError(f"{suffix}: captured {sorted(results)}, expected {sorted(want)}")
    return results


def chunk_vs_cpu(label, card_fn, cpu_fn) -> dict:
    """One chunk of a phase-14 sampler on the card (kernels) against the same
    sampler of a CPU copy of the model (plain versions) on the same batch
    and noise: ROLLOUT_TOL x max|plain|."""
    got, ref = card_fn().float().cpu(), cpu_fn().float()
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    log(f"{label}: card (kernels) vs cpu (plain versions) max_abs_err={err:.4e} "
        f"max|plain|={scale:.4e} (tol {ROLLOUT_TOL} x max|plain|)")
    if got.shape != ref.shape or not torch.isfinite(got).all() or not err <= ROLLOUT_TOL * scale:
        raise AssertionError(f"{label}: the card's chunk disagrees with the plain path")
    return {"max_abs_err": err, "max_abs_plain": scale}


def controller_batch(cfg, sampler, frames, device) -> tuple[dict, torch.Tensor]:
    """The batch and noise of the last replan of a RealtimeController (B=1)
    run for one virtual second on the simulated plant, with a camera that
    plays ``frames`` at the image rate, plans inline (plan_in_thread=False)
    through ``sampler``."""
    from soccerdiffusion_tpu_torch.inference.realtime import RealtimeController, SimulatedRobotIO

    class Camera(SimulatedRobotIO):
        shown = 0

        def read_image(self):
            self.shown += 1
            return frames[(self.shown - 1) % len(frames)]

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

        def sleep(self, dt):
            self.t += dt

    seen = []

    def sample_fn(batch, noise):
        seen[:] = [{k: v.clone() for k, v in batch.items()}, noise.clone()]
        return sampler(batch, noise)

    clock = Clock()
    RealtimeController(cfg, sample_fn, Camera(cfg.num_joints), clock=clock, sleep_fn=clock.sleep,
                       plan_in_thread=False, device=device).run(1.0)
    return seen[0], seen[1]


def eval_kernel_phase(teacher, student, device) -> dict:
    """Rows 4-6 at the shapes of phase 14's paths, on the checkpoints'
    weights: the controller's B=1 batch (the student's served sampler: the
    ViT over 10 frames, the four stacks, the four decoder layers) and the
    report's first held-out batch of EVAL_BATCH windows (the teacher's
    encode and a full denoise pass). Each captured launch against its plain
    version (path_kernel_checks); then whole chunks card vs CPU: the
    teacher's and the student's served samplers on the controller batch and
    the teacher's open-loop sampling of the report batch (its ddim steps,
    the report's noise stream)."""
    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.evaluation.openloop import (
        eval_batches,
        held_out_indices,
        sample_trajectories,
    )
    from soccerdiffusion_tpu_torch.inference import make_chunk_sampler
    from soccerdiffusion_tpu_torch.training.checkpoint import build_policy, load_policy_checkpoint
    from soccerdiffusion_tpu_torch.training.train import build_dataset

    models = {}
    for label, path in (("teacher", teacher), ("student", student)):
        hp, state, norm, steps, distilled = load_policy_checkpoint(path)
        config = Config.from_dict(hp)
        models[label] = {dev: build_policy(config.model, state, dev) for dev in (device, "cpu")}
        models[label].update(norm=norm, steps=steps, distilled=distilled, config=config)
    config = models["teacher"]["config"]
    cfg, schedule = config.model, make_schedule(config.train.train_denoising_timesteps)
    dataset = build_dataset(config, 0, True)
    samplers = {(label, dev): make_chunk_sampler(m[dev], schedule, m["norm"], m["steps"],
                                                 m["distilled"])
                for label, m in models.items() for dev in (device, "cpu")}
    frames = dataset[len(dataset) // 2]["image_data"]
    batch, noise = controller_batch(cfg, samplers[("student", device)], frames, device)
    on_cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    student = models["student"][device]
    results = path_kernel_checks(student, lambda: samplers[("student", device)](batch, noise), 1,
                                 "_serve")
    chunks = {f"serve_{label}_B1": chunk_vs_cpu(
        f"cli serve's {label} sampler on the controller batch (B=1)",
        lambda label=label: samplers[(label, device)](batch, noise),
        lambda label=label: samplers[(label, "cpu")](on_cpu(batch), noise.cpu()))
        for label in ("teacher", "student")}

    indices = held_out_indices(len(dataset), EVAL_WINDOWS, 0)[:EVAL_BATCH]
    rb = next(eval_batches(dataset, indices, EVAL_BATCH))
    shape = (len(indices), cfg.trajectory_prediction_length, cfg.num_joints)
    rnoise = torch.randn(shape, generator=torch.Generator().manual_seed(0))  # stream 0, on the CPU
    t = models["teacher"]

    def open_loop(dev):
        model = t[dev]
        context = model.encode_context({k: torch.from_numpy(v).to(dev) for k, v in rb.items()})
        return sample_trajectories(model, schedule, context, rnoise.to(dev), t["steps"],
                                   t["distilled"])

    def encode_and_denoise():
        model = t[device]
        context = model.encode_context({k: torch.from_numpy(v).to(device) for k, v in rb.items()})
        model.denoise(context, rnoise.to(device),
                      torch.full((len(indices),), 500, dtype=torch.int64, device=device))

    results.update(path_kernel_checks(t[device], encode_and_denoise, len(indices), "_report"))
    chunks[f"report_teacher_B{len(indices)}"] = chunk_vs_cpu(
        f"cli report's teacher open loop ({t['steps']} steps, B={len(indices)})",
        lambda: open_loop(device), lambda: open_loop("cpu"))
    return {"kernels": results, "chunks": chunks}


def eval_card_vs_cpu(teacher, student, device) -> dict:
    """The same report at EVAL_CPU's size on the card and on the CPU (plain
    versions) in float32, the noise drawn on the CPU and moved: every MSE,
    MAE and divergence value within EVAL_TOL relative. The kernels take
    bf16 only, so this float32 report runs the model with the fused knobs
    off; eval_kernel_phase holds the kernels at this phase's shapes."""
    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.evaluation import report
    from soccerdiffusion_tpu_torch.training.checkpoint import load_policy_checkpoint
    from soccerdiffusion_tpu_torch.training.train import build_dataset

    hp, state, norm, steps, distilled = load_policy_checkpoint(teacher)
    hp = {**hp, "compute_dtype": "float32", "vit_fused_block": False,
          "encoder_fused_stack": False, "decoder_fused_block": False}
    dataset = build_dataset(Config.from_dict(hp), 0, True)

    def noise_fn(stream_seed, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(stream_seed))

    results, seconds = {}, {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        results[dev] = report.run_report(
            str(teacher), [str(student)], dataset, teacher_loaded=(hp, state, norm, steps, distilled),
            solver_rows=[("ddim", EVAL_SOLVER_STEPS)], guidance_rows=[(2.0, ("image",))],
            noise_fn=noise_fn, device=dev, **EVAL_CPU)
        seconds[dev] = time.perf_counter() - t0
    card, cpu = dict(numbers(results[device])), dict(numbers(results["cpu"]))
    if card.keys() != cpu.keys():
        raise AssertionError(f"card and CPU reports differ in keys: {card.keys() ^ cpu.keys()}")
    gated = [p for p in cpu if re.search(r"mse|mae|div", p.rsplit(".", 1)[-1])]
    rel = {p: abs(card[p] - cpu[p]) / max(abs(cpu[p]), 1e-12) for p in gated}
    worst = max(rel, key=rel.get)
    log(f"report card vs cpu (float32, {EVAL_CPU}): {len(gated)} MSE / MAE / divergence values, "
        f"largest departure {rel[worst]:.3e} at {worst} (card {card[worst]:.6g}, cpu "
        f"{cpu[worst]:.6g}; tol {EVAL_TOL}); card {seconds[device]:.1f} s, cpu "
        f"{seconds['cpu']:.1f} s")
    if rel[worst] > EVAL_TOL or not all(np.isfinite(card[p]) for p in gated):
        raise AssertionError("the card's report disagrees with the plain path on the CPU")
    return {"values": len(gated), "max_rel": rel[worst], "at": worst, "s": seconds}


# one `cli serve` in its own interpreter, as a deployment runs it (the smoke's
# own process state does not ride into the plan's host time): the verb's
# numbers and the launch counters of that process, as a JSON line
SERVE_CODE = """\
import json, sys
import chip_smoke
from soccerdiffusion_tpu_torch import cli

chip_smoke.zero_counters()
stats = cli.serve(cli.build_parser().parse_args(json.loads(sys.argv[1])))
stats["counters"] = chip_smoke.read_counters()
print("SERVE_STATS " + json.dumps(stats), flush=True)
"""


def serve_process(argv) -> dict:
    """`cli serve` with ``argv`` in a fresh interpreter; its stats and counters."""
    proc = subprocess.run([sys.executable, "-c", SERVE_CODE, json.dumps(argv)],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=600)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("SERVE_STATS ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"cli serve {argv}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1].removeprefix("SERVE_STATS "))


def eval_serve_phase(teacher, student, device, smi) -> dict:
    """`cli serve` for SERVE_S seconds, each in its own process: the teacher
    (ddim30) and the student (distilled1) on the simulated plant, the
    student over UDP loopback against a UdpRobotServer thread of this
    process; exact launches per replan (the warm-up replan included),
    finite chunks, and every tick after the first chunk arrived commanding
    the plant (over UDP: received by the robot-side server). The first
    plan's latency and the share of the scheduled ticks that commanded are
    logged, not gated: the teacher's host-bound plans take about the
    200 ms replan period, so that share rides on host noise."""
    import threading

    from soccerdiffusion_tpu_torch.inference.realtime import SimulatedRobotIO
    from soccerdiffusion_tpu_torch.inference.transport import UdpRobotServer

    out = {}
    for label, ckpt, distilled, udp in (("teacher_ddim30", teacher, False, False),
                                        ("student_distilled1", student, True, False),
                                        ("student_distilled1_udp", student, True, True)):
        argv = ["serve", str(ckpt), "--duration", str(SERVE_S), "--device", device]
        server = thread = None
        if udp:
            plant = SimulatedRobotIO(flagship_config().num_joints)
            server = UdpRobotServer(plant, "127.0.0.1:0", rate_hz=50.0)
            thread = threading.Thread(target=server.serve, args=(None, 600.0), daemon=True)
            thread.start()
            argv += ["--udp", "%s:%d" % server.local_addr]
        try:
            stats = serve_process(argv)
            sent = stats["ticks"] - stats["ticks_without_chunk"]
            deadline = time.monotonic() + 5.0  # the server's receive thread drains the socket
            while server is not None and server.commands_received < sent and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            if server is not None:
                server._stop.set()
                thread.join(timeout=10.0)
                server.close()
        got = stats.pop("counters")
        if udp:
            stats["commands_delivered"] = server.commands_received
            finite = bool(np.isfinite(plant.positions).all())
        else:
            finite = True
        per = serve_launches(distilled)
        want = {name: per.get(name, 0) * (stats["replans"] + 1) for name in got}
        stats["launches"] = {k: v for k, v in got.items() if v}
        out[label] = stats
        log(f"cli serve {label}, {SERVE_S:g} s at 50 Hz (own process): {stats['replans']} "
            f"replans, plan p50 {stats['plan_ms']['p50']:.2f} / p95 {stats['plan_ms']['p95']:.2f} "
            f"/ max {stats['plan_ms']['max']:.2f} ms, first {stats['first_plan_ms']:.2f} ms; "
            f"commands delivered {stats['commands_delivered']} of {stats['ticks_scheduled']} "
            f"scheduled, {sent} ticks after the first chunk ({stats['ticks']} run); tick lateness p50 "
            f"{stats['tick_lateness_ms']['p50']:.3f} / p99 {stats['tick_lateness_ms']['p99']:.3f} "
            f"ms; overruns {stats['overruns']}; launches {stats['launches']} ({smi})")
        if got != want:
            raise AssertionError(f"cli serve {label}: launches {got}, expected {want}")
        if stats["nonfinite_chunks"] or not finite or not stats["commands_delivered"] == sent >= 1:
            raise AssertionError(f"cli serve {label}: {stats}")
    return out


def eval_plot_phase(tmp: Path, yml, teacher, device) -> dict:
    """inference.plot.sample_open_loop on the card (exact launches, finite
    output); then `cli plot` and `cli db plot-window` write PNGs where
    matplotlib is installed, or fail naming it where it is not."""
    import importlib.util

    from soccerdiffusion_tpu_torch import cli
    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.evaluation.openloop import eval_batches
    from soccerdiffusion_tpu_torch.inference.plot import sample_open_loop
    from soccerdiffusion_tpu_torch.training.checkpoint import load_policy
    from soccerdiffusion_tpu_torch.training.train import build_dataset

    model, norm, steps, distilled, hp = load_policy(teacher, device)
    config = Config.from_dict(hp)
    batch = next(eval_batches(build_dataset(config, 0, True), [0, 100, 200, 300], 4))
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    cfg = config.model
    noise = torch.randn((4, cfg.trajectory_prediction_length, cfg.num_joints),
                        generator=torch.Generator(device=device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    zero_counters()
    traj, start = sample_open_loop(model, norm, make_schedule(1000), batch, steps, distilled, noise)
    torch.cuda.synchronize()
    got = read_counters()
    want = serve_launches(False, steps)
    want = {name: want.get(name, 0) for name in got}
    if got != want or traj.shape != noise.shape or not torch.isfinite(traj).all():
        raise AssertionError(f"sample_open_loop: launches {got} (expected {want}), "
                             f"finite={bool(torch.isfinite(traj).all())}")
    have = importlib.util.find_spec("matplotlib") is not None
    png = tmp / "window.png"
    if have:
        cli_ok(["plot", teacher, "--dummy-data", "--num-samples", 1, "-o", tmp / "plots",
                "--device", device], "plot")
        cli_ok(["db", "plot-window", 0, png, "--config", yml, "--dummy-data"], "db plot-window")
        for path in (tmp / "plots" / "sample_0.png", png):
            if path.read_bytes()[:8] != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{path} is not a PNG")
    else:
        try:
            cli.main(["plot", str(teacher), "--dummy-data", "--num-samples", "1", "-o",
                      str(tmp / "plots"), "--device", device])
            raise AssertionError("cli plot ran without matplotlib")
        except ImportError as exc:
            if "matplotlib" not in str(exc):
                raise
        if cli.main(["db", "plot-window", "0", str(png), "--config", str(yml),
                     "--dummy-data"]) != 1:
            raise AssertionError("cli db plot-window ran without matplotlib")
    log(f"sample_open_loop on the card (B=4, {steps} steps): launches {got}; matplotlib "
        f"{'installed: cli plot and db plot-window wrote PNGs' if have else 'absent: cli plot and db plot-window failed naming it'}")
    return {"launches": {k: v for k, v in got.items() if v}, "matplotlib": have}


def evaluation_phase(device, smi) -> dict:
    """Phase 14: evaluation/ and the CLI driven on vit_flagship.yaml through
    the port's cli: the db verbs, a teacher and a student from `cli train` /
    `cli distill`, `cli report` on the card, rows 4-6 and whole chunks at
    the serve and report shapes against their plain versions, the report
    card vs CPU, `cli serve` (simulated plant and UDP), the open-loop plot."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        out = {"db": eval_db_phase(tmp)}
        yml, teacher, student, out["checkpoints"] = eval_checkpoints(tmp, device)
        out["report"] = eval_report_phase(tmp, teacher, student, device, smi)
        out["kernels_on_path"] = eval_kernel_phase(teacher, student, device)
        torch.cuda.empty_cache()
        out["report_card_vs_cpu"] = eval_card_vs_cpu(teacher, student, device)
        torch.cuda.empty_cache()
        out["serve"] = eval_serve_phase(teacher, student, device, smi)
        out["plot"] = eval_plot_phase(tmp, yml, teacher, device)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"evaluation phase: {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------- parallel/ (phase 15)
# two ranks share the card over gloo (NCCL refuses two ranks on one device);
# every rank's work is held against the same work in one process on the card
PAR_WORLD = 2
PAR_TRAIN_B, PAR_RESNET_B, PAR_STEPS = 64, 8, 3  # global batches: 2 x 32, 2 x 4
PAR_FLEET_B, PAR_PERIODS = 1024, 2  # robots: 2 x 512
PAR_RING_B = 16
# the float32 ring / TP forward against one process's "xla" forward, as a
# share of the output's scale (only the order of float32 sums differs)
PAR_F32_TOL = 1e-4
PAR_TRAIN_CASES = {  # (config, batches, seed of the init and the generator)
    "proprio_fused": ("proprio_fused.yaml", "h128", 31),
    "vit_flagship": ("vit_flagship.yaml", "flagship", 32),
    "default_tpu_f32": ("default_tpu.yaml", "resnet", 33),
}
# over NCCL (--nccl): the data-parallel cases without the flagship
PAR_NCCL_CASES = ("proprio_fused", "default_tpu_f32")
PAR_FLEET_LANES = {"ddim30": dict(fused="chunk"), "distilled1": dict(distilled=True, fused=True)}
# The synchronised BatchNorm's first forward (train mode, before any
# update): each layer's batch mean and biased variance against one process
# at the global batch, channel by channel. Both sides sum the same N float32
# terms of a channel (N = rows x frames x H x W of the global batch) in
# other orders (the ranks' partial sums and an all-reduce; one process's
# var_mean). By the probabilistic bound on float32 summation (Higham and
# Mary 2019: |fl(sum) - sum| <= lambda sqrt(N) u sum|x| in any order, with
# probability >= 1 - 2 N exp(-lambda^2 / 2); u = 2^-24, lambda = 8: a
# failure chance under 3e-8 a channel at N = 1e6) each side's mean lies
# within lambda sqrt(N) u mean|x| of the exact one, the two within twice
# that. The two-pass variance sums N squares (x - mean)^2 >= 0, each
# rounded twice (the subtraction and the square) after the mean's error,
# which enters only at second order (the derivative of sum (x - m)^2 in m
# vanishes at the mean): 2 (lambda sqrt(N) + 3) u var. The running
# statistics, 0.9 r + 0.1 batch, take a tenth of that plus their own two
# roundings: 0.1 tol + 4 u |r|. A count or a sum that misses a rank's rows
# is off by a share of the batch (1/8 at B=8), far beyond these.
BN_LAMBDA, F32_U = 8.0, 2.0 ** -24

RANK_CODE = """\
import sys
import chip_smoke
sys.exit(chip_smoke.parallel_rank(sys.argv[1:]))
"""


def par_train_config(name: str):
    config = yaml_config(PAR_TRAIN_CASES[name][0])
    if name == "default_tpu_f32":  # the synchronised BatchNorm in float32 (TF32 off)
        config = dataclasses.replace(config, model=dataclasses.replace(
            config.model, compute_dtype="float32"))
    return config


def par_ring_config(attention_impl: str):
    """The h128 configuration unfused in float32: "ring" or its "xla" reference."""
    return dataclasses.replace(bench_config(), compute_dtype="float32",
                               attention_impl=attention_impl)


def par_axis_shape(world: int, axis: str) -> dict:
    """The ring ("seq") or tensor-parallel ("model") mesh on ``world`` ranks:
    the axis over 2 ranks, "data" over the rest (a "data" axis of 1 carries
    the whole batch)."""
    return {"data": world // 2, axis: 2}


def par_inputs() -> dict:
    """The global batches (CPU tensors) every rank and the one-process runs read."""
    flag = flagship_train_config(PAR_TRAIN_B)
    h128 = h128_reference_batches(b=PAR_TRAIN_B, steps=PAR_STEPS)
    rng = np.random.default_rng(34)
    ring = random_batch(bench_config(), PAR_RING_B, "cpu", rng)
    ring["joint_command"] = torch.from_numpy(
        rng.uniform(0, 2 * np.pi, (PAR_RING_B, 10, 20)).astype(np.float32))
    return {"h128": h128,
            "flagship": reference_batches(flag, b=PAR_TRAIN_B, steps=PAR_STEPS),
            "resnet": reference_batches(yaml_config("default_tpu.yaml"), b=PAR_RESNET_B,
                                        steps=PAR_STEPS),
            "ring": ring, "ring_noisy": torch.from_numpy(
                rng.normal(size=(PAR_RING_B, 10, 20)).astype(np.float32)),
            "ring_t": torch.from_numpy(rng.integers(0, 1000, (PAR_RING_B,)))}


def par_model(cfg, device, seed):
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

    model = DiffusionPolicy(cfg)
    return load_jax_params(model, *flax_init_params(model, seed)).to(device)


def par_train(cfg, batches, device, seed, mesh=None) -> dict:
    """PAR_STEPS steps of TrainStep.__call__ (t, noise drawn for the global
    batch from a generator seeded alike everywhere): this rank's share under
    ``mesh``, else the whole batch in one process. The losses, grad norms,
    final parameters and buffers, the launches, and ms per step: the host
    clock from the device sync ending the first step (a rank's process
    meets its first cuBLAS / cuDNN calls there) to the one ending the last."""
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.parallel.mesh import shard_batch
    from soccerdiffusion_tpu_torch.parallel.tensor_parallel import shard_model
    from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer, make_train_step

    model = par_model(cfg, device, seed)
    if mesh is not None:
        shard_model(model, mesh)
    opt = make_optimizer(model, 1e-3, 10, grad_clip_norm=1.0)
    state = create_train_state(model, opt)
    step = make_train_step(model, make_schedule(1000), opt, Normalizer.identity(cfg.num_joints),
                           mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(seed)
    local = [shard_batch(mesh, b) if mesh is not None else b for b in batches]
    local = [{k: v.to(device) for k, v in b.items()} for b in local]
    params0 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()} \
        if mesh is None else None
    torch.cuda.synchronize()
    zero_counters()
    losses, norms, ends = [], [], []
    for batch in local:
        metrics = step(state, batch, generator)
        losses.append(metrics["loss"].item())  # a device sync
        norms.append(metrics["grad_norm"].item())
        ends.append(time.perf_counter())
    ms = (ends[-1] - ends[0]) * 1e3 / (len(local) - 1) if len(local) > 1 else float("nan")
    launches = read_counters()
    tp = getattr(model, "tensor_parallel", None)
    full = lambda n, t: (t if tp is None else tp.full(n, t)).detach().cpu()
    return {"loss": losses, "grad_norm": norms, "ms_per_step": ms, "launches": launches,
            "params0": params0, "params": {n: full(n, p) for n, p in model.named_parameters()},
            "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()}}


def bn_first_forward(cfg, batch, device, seed, mesh=None) -> dict:
    """One forward of ``cfg`` in train mode on the global ``batch`` (this
    rank's rows under ``mesh``), before any update: every BatchNorm layer's
    batch (variance, mean) as models/layers.py:batch_statistics returns
    them, in call order, with the channel's global element count and mean
    |x|, and the running statistics after the forward."""
    from soccerdiffusion_tpu_torch.data.pipeline import prepare_batch
    from soccerdiffusion_tpu_torch.models import layers
    from soccerdiffusion_tpu_torch.parallel.mesh import batch_group, shard_batch, use_mesh

    model = par_model(cfg, device, seed).train()
    rng = np.random.default_rng(seed)
    b = batch["joint_command"].shape[0]
    full = {**batch, "bn_noisy": torch.from_numpy(rng.normal(size=(
        b, cfg.trajectory_prediction_length, cfg.num_joints)).astype(np.float32)),
        "bn_t": torch.from_numpy(rng.integers(0, 1000, (b,)))}
    local = {k: v.to(device) for k, v in (shard_batch(mesh, full) if mesh is not None
                                          else full).items()}
    ranks = batch_group(mesh)[1] if mesh is not None else 1
    noisy, t = local.pop("bn_noisy"), local.pop("bn_t")
    records, batch_statistics = [], layers.batch_statistics

    def recording(x32):
        var, mean = batch_statistics(x32)
        dims = tuple(range(x32.ndim - 1))
        records.append({"var": var.double().cpu(), "mean": mean.double().cpu(),
                        "count": x32.numel() // x32.shape[-1] * ranks,
                        "abs_mean": x32.abs().double().mean(dims).cpu()})
        return var, mean

    layers.batch_statistics = recording
    try:
        with torch.no_grad(), use_mesh(mesh):
            model(prepare_batch(local, keep_u8=cfg.use_images), noisy, t)
    finally:
        layers.batch_statistics = batch_statistics
    return {"layers": records, "running": {n: v.double().cpu() for n, v in model.named_buffers()
                                           if n.endswith((".mean", ".var"))}}


def bn_check(label, ranks, one, smi) -> dict:
    """Every rank's first-forward BatchNorm statistics equal, and each
    layer's batch mean / variance and running statistics within the float32
    summation bound (BN_LAMBDA above) of one process's, channel by channel."""
    first = ranks[0]
    for r, got in enumerate(ranks[1:], 1):
        if any(not torch.equal(a[k], b[k]) for a, b in zip(got["layers"], first["layers"])
               for k in ("var", "mean")) or \
                any(not torch.equal(got["running"][n], v) for n, v in first["running"].items()):
            raise AssertionError(f"{label}: rank {r}'s BatchNorm statistics differ from rank 0's")
    if len(first["layers"]) != len(one["layers"]) or not one["layers"]:
        raise AssertionError(f"{label}: {len(first['layers'])} BatchNorm calls on the ranks, "
                             f"{len(one['layers'])} in one process")
    worst, ratio, counts, tols = 0.0, 0.0, set(), []
    for i, (got, want) in enumerate(zip(first["layers"], one["layers"])):
        if got["count"] != want["count"]:
            raise AssertionError(f"{label}: BatchNorm call {i} counts {got['count']} elements a "
                                 f"channel, one process {want['count']}")
        n = want["count"]
        counts.add(n)
        lam = BN_LAMBDA * n ** 0.5
        tol = {"mean": 2 * lam * F32_U * want["abs_mean"],
               "var": 2 * (lam + 3) * F32_U * want["var"]}
        for k in ("mean", "var"):
            gap = (got[k] - want[k]).abs()
            ratio = max(ratio, (gap / tol[k].clamp_min(1e-300)).max().item())
            worst = max(worst, (gap / want[k].abs().clamp_min(1e-30)).max().item())
            if not bool((gap <= tol[k]).all()):
                raise AssertionError(f"{label}: BatchNorm call {i} batch {k} off by "
                                     f"{gap.max().item():.3e} (tolerance {tol[k].min().item():.3e}"
                                     f"..{tol[k].max().item():.3e})")
        tols.append(tol)
    # the running statistics, by module in call order (each BatchNorm runs once a forward)
    names = list(dict.fromkeys(n.rsplit(".", 1)[0] for n in one["running"]))
    if len(names) != len(tols):
        raise AssertionError(f"{label}: {len(names)} BatchNorm modules, {len(tols)} calls")
    run_ratio = 0.0
    for module, tol in zip(names, tols):
        for k in ("mean", "var"):
            want, got = one["running"][f"{module}.{k}"], first["running"][f"{module}.{k}"]
            bound = 0.1 * tol[k] + 4 * F32_U * want.abs()
            gap = (got - want).abs()
            run_ratio = max(run_ratio, (gap / bound.clamp_min(1e-300)).max().item())
            if not bool((gap <= bound).all()):
                raise AssertionError(f"{label}: running {k} of {module} off by "
                                     f"{gap.max().item():.3e}")
    log(f"parallel {label}: first-forward BatchNorm statistics of {len(names)} layers, "
        f"{len(ranks)} ranks vs one process (elements a channel {min(counts)}..{max(counts)}): "
        f"batch mean / var largest relative gap {worst:.3e}, largest gap / tolerance "
        f"{ratio:.3e}; running statistics gap / tolerance {run_ratio:.3e} [{smi}]")
    return {"layers": len(names), "max_rel_gap": worst, "max_gap_over_tol": ratio,
            "running_max_gap_over_tol": run_ratio, "counts": [min(counts), max(counts)]}


def par_forward(cfg, inputs, device, seed, mesh=None):
    from soccerdiffusion_tpu_torch.parallel.mesh import use_mesh
    from soccerdiffusion_tpu_torch.parallel.tensor_parallel import shard_model

    model = par_model(cfg, device, seed).eval()
    if mesh is not None:
        shard_model(model, mesh)
    on = lambda v: v.to(device)
    with torch.no_grad(), use_mesh(mesh):
        out = model({k: on(v) for k, v in inputs["ring"].items() if k != "joint_command"},
                    on(inputs["ring_noisy"]), on(inputs["ring_t"]))
    return out.cpu()


def par_fleet(device, mesh=None, rank=0, world=PAR_WORLD) -> dict:
    """PAR_PERIODS replan periods of each fleet lane on bench_config's model:
    the sharded rollout of PAR_FLEET_B robots under ``mesh``, else, in one
    process, an unsharded rollout over the robots of shard ``rank`` of
    ``world`` with fold_in(the seeded generator, rank)."""
    from soccerdiffusion_tpu_torch.inference.rollout import fold_in
    from soccerdiffusion_tpu_torch.parallel.mesh import make_mesh

    cfg = bench_config()
    model = build_model(cfg, device)
    out = {}
    for i, (lane, kw) in enumerate(PAR_FLEET_LANES.items()):
        eng = engine(model, cfg, device, **kw)
        generator = torch.Generator(device=device).manual_seed(40 + i)
        carry = eng.init(PAR_FLEET_B, generator)
        if mesh is not None:
            carry, run = eng.shard_carry(carry, mesh), eng.make_sharded_rollout(PAR_PERIODS, mesh)
        else:
            # this shard's robots: the rows of rank ``rank`` of a data mesh (no group)
            carry = eng.shard_carry(carry, make_mesh({"data": world}, world, rank))
            carry = dataclasses.replace(carry, generator=fold_in(generator, rank))
            run = eng.make_rollout_fn(PAR_PERIODS)
        eng.make_rollout_fn(1)(eng.init(8, torch.Generator(device=device).manual_seed(0)))
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        _, chunks = run(carry)
        torch.cuda.synchronize()
        out[lane] = {"chunks": chunks.cpu(), "launches": read_counters(),
                     "ms_per_period": (time.perf_counter() - t0) * 1e3 / PAR_PERIODS}
    return out


def parallel_rank(argv) -> int:
    """One rank of the parallel phase (in its own interpreter): argv is
    (work dir, rank, world, port, backend, device). Joins the process group,
    runs every parallel path and writes its results to <dir>/rank<r>.pt:
    the data-parallel training cases (over NCCL without the flagship), the
    synchronised BatchNorm's first forward, the fleet, ring attention and
    tensor parallelism, and over NCCL a "dcn" x "data" mesh over torchrun's
    LOCAL_WORLD_SIZE blocks of ranks."""
    import os

    from soccerdiffusion_tpu_torch.parallel import comm
    from soccerdiffusion_tpu_torch.parallel.distributed import initialize_distributed
    from soccerdiffusion_tpu_torch.parallel.mesh import make_mesh

    work, rank, world, port, backend, device = argv
    rank, world = int(rank), int(world)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend=backend,
                                    device=device)
    inputs = torch.load(Path(work) / "inputs.pt", weights_only=False)
    out, t0 = {"backend": backend, "device": str(device), "world": world}, time.perf_counter()
    data = make_mesh({"data": world})
    for name, (_, batches, seed) in PAR_TRAIN_CASES.items():
        if backend == "nccl" and name not in PAR_NCCL_CASES:
            continue
        out[name] = par_train(par_train_config(name).model, inputs[batches], device, seed, data)
        torch.cuda.empty_cache()
    out["bn_first"] = bn_first_forward(par_train_config("default_tpu_f32").model,
                                       inputs["resnet"][0], device, 33, data)
    out["fleet"] = par_fleet(device, data, world=world)
    for axis in ("seq", "model"):
        mesh = make_mesh(par_axis_shape(world, axis))
        cfg = par_ring_config("ring" if axis == "seq" else "xla")
        out[f"{axis}_forward"] = par_forward(cfg, inputs, device, 35, mesh)
        out[f"{axis}_step"] = par_train(cfg, [inputs["ring"]] * 2, device, 35, mesh)
    if backend == "nccl":
        per_node = int(os.environ["LOCAL_WORLD_SIZE"])
        mesh = make_mesh({"dcn": world // per_node, "data": per_node})
        out["dcn_data"] = par_train(par_train_config("proprio_fused").model, inputs["h128"],
                                    device, 31, mesh)
        out["dcn_shape"] = mesh.shape
    out["rank_s"] = time.perf_counter() - t0
    torch.save(out, Path(work) / f"rank{rank}.pt")
    comm.barrier()
    return 0


def run_ranks(work: Path, backend: str, devices: list[str], timeout=900) -> list[dict]:
    """Start a rank a device (one interpreter each) and read their results.
    The ranks see LOCAL_WORLD_SIZE = half of them: two nodes for the "dcn"
    axis, as torchrun sets it on each of two hosts."""
    import os

    port = _free_port()
    env = {**os.environ, "LOCAL_WORLD_SIZE": str(max(1, len(devices) // 2))}
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, str(work), str(r),
                               str(len(devices)), str(port), backend, devices[r]],
                              cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(len(devices))]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError("parallel ranks failed: " + "".join(
            f"\n--- rank {r} (exit {procs[r].returncode})\n{logs[r][-3000:]}" for r in failed))
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(len(devices))]


def par_check_train(label, ranks, one, batch, smi, rows=None) -> dict:
    """Every rank's losses and parameters equal (one all-reduced step each),
    and held against one process: losses (STEP_LOSS_TOL), the parameters'
    update (STEP_UPDATE_TOL), BatchNorm statistics (TRAIN_TOL of scale)."""
    first = ranks[0]
    for r, got in enumerate(ranks[1:], 1):
        if got["loss"] != first["loss"] or any(not torch.equal(got["params"][n], p)
                                               for n, p in first["params"].items()):
            raise AssertionError(f"{label}: rank {r} holds other losses or parameters than rank 0")
        if any(not torch.equal(got["buffers"][n], b) for n, b in first["buffers"].items()):
            raise AssertionError(f"{label}: rank {r}'s BatchNorm statistics differ from rank 0's")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(first["loss"], one["loss"])]
    p0 = one["params0"]
    num = sum(((first["params"][n] - p) ** 2).sum().item() for n, p in one["params"].items())
    den = sum(((p - p0[n]) ** 2).sum().item() for n, p in one["params"].items())
    upd = (num / den) ** 0.5
    stats = [(first["buffers"][n] - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
             for n, b in one["buffers"].items() if n.endswith((".mean", ".var"))]
    worst = max(stats, default=0.0)
    rows = batch // PAR_WORLD if rows is None else rows
    log(f"parallel {label}: {len(ranks)} ranks x {rows} rows vs one process at B={batch}: "
        f"losses {first['loss']} vs {one['loss']} (relative {max(loss_rel):.3e}, tol "
        f"{STEP_LOSS_TOL}), update {upd:.3e} (tol {STEP_UPDATE_TOL}), BatchNorm statistics "
        f"{worst:.3e} (tol {TRAIN_TOL}); ms/step ranks {[r['ms_per_step'] for r in ranks]}, one "
        f"process {one['ms_per_step']:.3f}; launches per rank "
        f"{[{n: c for n, c in r['launches'].items() if c} for r in ranks]} [{smi}]")
    if max(loss_rel) > STEP_LOSS_TOL or upd > STEP_UPDATE_TOL or worst > TRAIN_TOL:
        raise AssertionError(f"parallel {label} disagrees with one process")
    return {"loss_rel": max(loss_rel), "update_norm": upd, "running_stats_rel": worst,
            "ms_per_step_ranks": [r["ms_per_step"] for r in ranks],
            "ms_per_step_one_process": one["ms_per_step"],
            "launches_per_rank": [r["launches"] for r in ranks]}


def par_check_launches(label, launches, names):
    for r, got in enumerate(launches):
        missing = [n for n in names if got[n] == 0]
        if missing:
            raise AssertionError(f"parallel {label}: rank {r} launched no {missing}: {got}")


PROPRIO_TRAIN_KERNELS = ("fused_encoder_stack_fwd", "fused_encoder_stack_bwd",
                         "fused_decoder_layer_fwd", "fused_decoder_layer_bwd")


class ParReferences:
    """The one-process runs on the card that the ranks' work is held
    against, each computed once, in the smoke's own process."""

    def __init__(self, inputs, device):
        self.inputs, self.device, self.cache = inputs, device, {}

    def get(self, key, fn):
        if key not in self.cache:
            self.cache[key] = fn()
            torch.cuda.empty_cache()
        return self.cache[key]

    def train(self, name):
        _, batches, seed = PAR_TRAIN_CASES[name]
        return self.get(name, lambda: par_train(par_train_config(name).model,
                                                self.inputs[batches], self.device, seed))

    def bn_first(self):
        return self.get("bn_first", lambda: bn_first_forward(
            par_train_config("default_tpu_f32").model, self.inputs["resnet"][0], self.device, 33))

    def fleet(self, world, rank):
        return self.get(("fleet", world, rank),
                        lambda: par_fleet(self.device, rank=rank, world=world))

    def xla(self):
        return self.get("xla", lambda: (
            par_forward(par_ring_config("xla"), self.inputs, self.device, 35),
            par_train(par_ring_config("xla"), [self.inputs["ring"]] * 2, self.device, 35)))


def par_checks(label, ranks, refs: ParReferences, smi) -> dict:
    """Each path the ranks ran, held against one process: the training
    cases, the first-forward BatchNorm statistics, the fleet, ring attention
    and tensor parallelism, and (where run) the "dcn" x "data" mesh."""
    world, out = len(ranks), {}
    for name, (_, batches, _) in PAR_TRAIN_CASES.items():
        if name in ranks[0]:
            batch = refs.inputs[batches][0]["joint_command"].shape[0]
            out[name] = par_check_train(f"{name} ({label})", [r[name] for r in ranks],
                                        refs.train(name), batch, smi, batch // world)
    par_check_launches(f"proprio_fused ({label})", out["proprio_fused"]["launches_per_rank"],
                       PROPRIO_TRAIN_KERNELS)
    if "vit_flagship" in out:
        par_check_launches(f"vit_flagship ({label})", out["vit_flagship"]["launches_per_rank"], (
            "fused_vit_block_fwd", "fused_vit_block_bwd", "fused_encoder_stack_fwd_hd64",
            "fused_encoder_stack_bwd_hd64", "fused_decoder_layer_fwd_hd64",
            "fused_decoder_layer_bwd_hd64"))
    out["bn_first"] = bn_check(f"synchronised BatchNorm ({label})",
                               [r["bn_first"] for r in ranks], refs.bn_first(), smi)
    # the fleet: each shard bit for bit one process's rollout over its robots
    fleet, per = {}, PAR_FLEET_B // world
    for r in range(world):
        one = refs.fleet(world, r)
        for lane in PAR_FLEET_LANES:
            for got in ranks:
                if not torch.equal(got["fleet"][lane]["chunks"][:, r * per:(r + 1) * per],
                                   one[lane]["chunks"]):
                    raise AssertionError(f"parallel fleet {lane} ({label}): shard {r} differs "
                                         "from one process's rollout over its robots")
            fleet.setdefault(lane, {"ms_per_period_one_process": []})[
                "ms_per_period_one_process"].append(one[lane]["ms_per_period"])
    for lane in PAR_FLEET_LANES:
        launches = [got["fleet"][lane]["launches"] for got in ranks]
        fleet[lane].update(ms_per_period_ranks=[g["fleet"][lane]["ms_per_period"]
                                                for g in ranks], launches_per_rank=launches)
        log(f"parallel fleet {lane} ({label}): {world} x {per} robots, {PAR_PERIODS} periods, "
            f"each shard bit for bit one process's; ms/period ranks "
            f"{fleet[lane]['ms_per_period_ranks']}, one process ({per} robots) "
            f"{fleet[lane]['ms_per_period_one_process']}; launches {launches} [{smi}]")
    par_check_launches(f"fleet ddim30 ({label})", fleet["ddim30"]["launches_per_rank"],
                       ("fused_encoder", "fused_chunk"))
    par_check_launches(f"fleet distilled1 ({label})", fleet["distilled1"]["launches_per_rank"],
                       ("fused_encoder", "fused_denoise", "fused_denoise_pack"))
    out["fleet"] = fleet
    # ring attention and tensor parallelism against "xla" in one process
    want, one = refs.xla()
    for axis, name in (("seq", "ring"), ("model", "tensor_parallel")):
        shape = par_axis_shape(world, axis)
        errs = [(r[f"{axis}_forward"] - want).abs().max().item() / want.abs().max().item()
                for r in ranks]
        log(f"parallel {name} ({label}, {shape}) forward vs one process's xla forward: "
            f"{max(errs):.3e} of scale (tol {PAR_F32_TOL})")
        if max(errs) > PAR_F32_TOL:
            raise AssertionError(f"parallel {name} ({label}): the forward disagrees with xla")
        out[name] = {"mesh": shape, "forward_rel": max(errs), **par_check_train(
            f"{name} ({label}, {shape})", [r[f"{axis}_step"] for r in ranks], one, PAR_RING_B,
            smi, PAR_RING_B // shape["data"])}
    if "dcn_data" in ranks[0]:
        shape = ranks[0]["dcn_shape"]
        out["dcn_data"] = {"mesh": shape, **par_check_train(
            f"proprio_fused ({label}, {shape})", [r["dcn_data"] for r in ranks],
            refs.train("proprio_fused"), PAR_TRAIN_B, smi, PAR_TRAIN_B // world)}
        par_check_launches(f"dcn x data ({label})", out["dcn_data"]["launches_per_rank"],
                           PROPRIO_TRAIN_KERNELS)
    return out


def par_cli_phase(work: Path, smi) -> dict:
    """`cli train --mesh data=2 --device cuda:0 --dist-backend gloo
    --dummy-data` for 2 steps under torch.distributed.run: one checkpoint,
    which loads."""
    from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint

    out = work / "cli_ckpt"
    argv = [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={PAR_WORLD}",
            "--master_addr=127.0.0.1", f"--master_port={_free_port()}", "-m",
            "soccerdiffusion_tpu_torch.cli", "train", "-c", str(CONFIG_DIR / "proprio_fused.yaml"),
            "--mesh", f"data={PAR_WORLD}", "--device", "cuda:0", "--dist-backend", "gloo",
            "--dummy-data", "--epochs", "1", "--steps-per-epoch", "2", "-o", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli train --mesh: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    ckpt = load_checkpoint(out)
    checkpoints = sorted(p.name for p in work.iterdir() if p.name.startswith("cli_ckpt"))
    if ckpt["step"] != 2 or checkpoints != ["cli_ckpt"]:
        raise AssertionError(f"cli train --mesh: step {ckpt['step']}, {checkpoints}")
    log(f"parallel cli train --mesh data={PAR_WORLD} (torchrun, gloo, one card): 2 steps, one "
        f"checkpoint, {seconds:.1f} s with start-up [{smi}]")
    return {"seconds": seconds, "steps": ckpt["step"]}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_checks(work: Path, refs: ParReferences, smi, worlds) -> dict:
    """Every parallel path over NCCL, one rank a card, on each of ``worlds``
    ranks, against one process (``refs``; the inputs in <work>/inputs.pt):
    the data-parallel steps of proprio_fused.yaml and of default_tpu.yaml in
    float32 (the synchronised BatchNorm) with its first-forward statistics,
    the sharded h128 fleet (ddim30, distilled1), ring attention and tensor
    parallelism, and proprio_fused.yaml over a "dcn" x "data" mesh."""
    out = {}
    for world in worlds:
        t0 = time.perf_counter()
        ranks = run_ranks(work, "nccl", [f"cuda:{r}" for r in range(world)])
        out[world] = par_checks(f"nccl x {world}", ranks, refs, smi)
        out[world].update(wall_s=time.perf_counter() - t0, rank_s=[r["rank_s"] for r in ranks])
        log(f"parallel nccl x {world}: every path held, {out[world]['wall_s']:.1f} s "
            f"(ranks {out[world]['rank_s']}) [{smi}]")
    return out


def nccl_phase(device, smi) -> dict:
    """``--nccl``: nccl_checks on 2 ranks and on every card of the machine."""
    cards = torch.cuda.device_count()
    if cards < PAR_WORLD:
        raise AssertionError(f"--nccl needs {PAR_WORLD} cards or more (one rank a card); this "
                             f"machine has {cards}")
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as work:
        inputs = par_inputs()
        torch.save(inputs, Path(work) / "inputs.pt")
        return nccl_checks(Path(work), ParReferences(inputs, device), smi,
                           sorted({PAR_WORLD, cards}))


def parallel_phase(device, smi) -> dict:
    """Phase 15: parallel/ on two ranks sharing the card over gloo, each path
    held against one process on the card (par_checks); the NCCL paths where
    there are two cards or more."""
    t0 = time.perf_counter()
    out = {}
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as work:
        work = Path(work)
        inputs = par_inputs()
        torch.save(inputs, work / "inputs.pt")
        t1 = time.perf_counter()
        shared = "cuda:0" if torch.device(device).type == "cuda" else "cpu"
        ranks = run_ranks(work, "gloo", [shared] * PAR_WORLD)
        out["ranks_s"] = time.perf_counter() - t1
        refs = ParReferences(inputs, device)
        out.update(par_checks("gloo", ranks, refs, smi))
        out["cli"] = par_cli_phase(work, smi)
        if torch.cuda.device_count() >= PAR_WORLD:
            out["nccl"] = nccl_checks(work, refs, smi, (PAR_WORLD,))
        else:
            out["nccl"] = f"not run: {torch.cuda.device_count()} card(s), NCCL takes one rank a card"
            log(f"parallel: the NCCL paths are not run: this machine has "
                f"{torch.cuda.device_count()} card(s), NCCL takes one rank a card")
    out["phase_s"] = time.perf_counter() - t0
    log(f"parallel phase: {out['phase_s']:.1f} s (ranks {out['ranks_s']:.1f} s) [{smi}]")
    return out


# ------------------------------------------------------- checkpoints (phase 16)
# checkpoints the port did not write: the JAX package's state.msgpack (made
# here with utils/flax_msgpack.pack from seeded flax-layout trees, as the JAX
# package lays them out) and the reference's .pth (tests/torch_reference_policy.py)
CKPT_STEP, CKPT_EPOCH, CKPT_PERIODS = 120, 3, 2
# the reference replica's float32 denoiser output against the port's (TF32
# off), as a share of its scale: two float32 implementations of the same
# layers, summing in other orders (3.2e-6 measured on an H100). The replica
# runs torch.nn's composite layers: torch's fused inference fast path for
# nn.TransformerEncoderLayer / MultiheadAttention sat 3.4e-5 of scale from
# them on the card (the port and the composite path agree on the CPU and
# the card alike), so it is logged, not gated
CKPT_REF_TOL = 1e-5
# a resume from the JAX checkpoint against the same start in the port's
# format: losses and parameters, relative (both start from equal tensors)
CKPT_RESUME_TOL = 1e-6
CKPT_RESUME_STEPS = 3


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def jax_opt_state(mu, nu, count) -> dict:
    """optax.adamw's state under the JAX trainer's one-cycle schedule
    (chain(scale_by_adam, add_decayed_weights, scale_by_schedule)) as
    flax's to_state_dict lays it out."""
    c = np.asarray(count, np.int32)
    return {"0": {"count": c, "mu": mu, "nu": nu}, "1": {}, "2": {"count": c.copy()}}


def write_jax_checkpoint(path: Path, hyperparams, params, norm, batch_stats=None, opt_state=None,
                         ema=None, step=CKPT_STEP, epoch=CKPT_EPOCH) -> int:
    """A checkpoint directory in the JAX package's format (soccerdiffusion_tpu/
    training/checkpoint.py:save_checkpoint's state.msgpack and
    hyperparams.json) of flax-layout numpy trees; returns its bytes."""
    from soccerdiffusion_tpu_torch.utils import flax_msgpack

    tree = {"step": np.asarray(step, np.int32), "params": params, "batch_stats": batch_stats or {},
            "opt_state": {} if opt_state is None else opt_state,
            "norm": {"mean": norm[0], "std": norm[1]}}
    if ema:
        tree["ema_params"] = ema
    data = flax_msgpack.pack(tree)
    path.mkdir(parents=True, exist_ok=True)
    (path / "state.msgpack").write_bytes(data)
    (path / "hyperparams.json").write_text(
        json.dumps({"hyperparams": hyperparams, "current_epoch": epoch}, indent=2))
    return len(data)


def ckpt_norm(num_joints: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.uniform(2.5, 3.5, num_joints).astype(np.float32),
            rng.uniform(0.5, 1.5, num_joints).astype(np.float32))


def ckpt_moments(model, seed: int):
    """Seeded AdamW moments (mu, nu) in the flax layout of ``model``'s params."""
    from soccerdiffusion_tpu_torch.utils.jax_params import random_jax_params

    mu = tree_map(lambda a: 1e-3 * a, random_jax_params(model, seed)[0])
    nu = tree_map(lambda a: 1e-6 * a * a, random_jax_params(model, seed + 1)[0])
    return mu, nu


def timed_load(path, device, **kw):
    """load_policy on ``device``, timed to its tensors on the card."""
    from soccerdiffusion_tpu_torch.training.checkpoint import load_policy

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = load_policy(path, device, **kw)
    torch.cuda.synchronize()
    return loaded, time.perf_counter() - t0


def ckpt_size_mb(path: Path) -> float:
    return sum(f.stat().st_size for f in path.iterdir()) / 1e6


def ckpt_rollout(model, normalizer, steps, device, b, periods, seed, **kw):
    """``periods`` replan periods of a RolloutEngine on the checkpoint's
    model and normaliser at B=b (a B=8 warm-up first), every counter zeroed
    just before and read just after: (chunks, ms/period, launches)."""
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.inference import RolloutEngine

    eng = RolloutEngine(model, make_schedule(1000), normalizer, num_inference_steps=steps,
                        device=device, **kw)
    eng.make_rollout_fn(1)(eng.init(8, torch.Generator(device=device).manual_seed(0)))
    run = eng.make_rollout_fn(periods)
    carry = eng.init(b, torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    _, chunks = run(carry)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / periods
    launches = read_counters()
    if not torch.isfinite(chunks).all():
        raise AssertionError("a checkpoint's rollout gave non-finite chunks")
    return chunks.cpu(), ms, launches


def expect_exact(label, got, want):
    full = {name: want.get(name, 0) for name in got}
    if got != full:
        raise AssertionError(f"{label}: launches {got}, expected {full}")


def ckpt_teacher_phase(work: Path, device, smi, phase4_ms) -> dict:
    """1. A JAX-format h128 teacher (params and a different EMA, AdamW
    moments, the normaliser, the step) served by load_policy: 5 ddim30
    periods at B=1024 through the fused encoder and chunk kernels, bit for
    bit the chunks of a model filled by load_jax_params from the EMA tree,
    and not those of the raw params; then the kernel path against its plain
    versions on the CPU (reference_phase)."""
    from soccerdiffusion_tpu_torch.config import Config, TrainConfig
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

    cfg = bench_config()
    hp = Config(model=cfg, train=TrainConfig()).to_dict()
    skeleton = DiffusionPolicy(cfg)
    params, ema = flax_init_params(skeleton, 61)[0], flax_init_params(skeleton, 62)[0]
    norm = ckpt_norm(cfg.num_joints, 63)
    mu, nu = ckpt_moments(skeleton, 64)
    path = work / "jax_teacher"
    write_jax_checkpoint(path, hp, params, norm, opt_state=jax_opt_state(mu, nu, CKPT_STEP),
                         ema=ema)
    # the first load meets the process's first imports of the loader's modules
    first_s = timed_load(path, device)[1]
    (model, normalizer, steps, distilled, _), read_s = timed_load(path, device)
    if (steps, distilled) != (30, False):
        raise AssertionError(f"JAX teacher: served at {steps} steps, distilled={distilled}")
    direct = load_jax_params(DiffusionPolicy(cfg), ema).to(device).eval()
    raw = timed_load(path, device, prefer_ema=False)[0][0]
    same_norm = Normalizer(mean=torch.from_numpy(norm[0]), std=torch.from_numpy(norm[1]))
    kw = dict(fused="chunk", fused_encoder=True)
    got, ms, launches = ckpt_rollout(model, normalizer, steps, device, BENCH_B, CHUNKS, 7, **kw)
    want = ckpt_rollout(direct, same_norm, steps, device, BENCH_B, CHUNKS, 7, **kw)[0]
    other = ckpt_rollout(raw, normalizer, steps, device, BENCH_B, CHUNKS, 7, **kw)[0]
    expect_exact("JAX teacher ddim30", launches, {"fused_encoder": CHUNKS, "fused_chunk": CHUNKS})
    if not torch.equal(got, want):
        raise AssertionError("JAX teacher: its chunks differ from load_jax_params(ema)'s")
    ema_gap = (got - other).abs().max().item()
    if ema_gap == 0.0:
        raise AssertionError("JAX teacher: the raw params serve the EMA's chunks")
    reference_phase(cfg, model, device)
    mb = ckpt_size_mb(path)
    log(f"checkpoint JAX teacher (h128, {mb:.2f} MB, params + EMA + AdamW moments): "
        f"load_policy {read_s:.3f} s (the process's first: {first_s:.3f}); {CHUNKS} ddim30 "
        f"periods B={BENCH_B}: {ms:.2f} ms/period "
        f"(phase 4 {phase4_ms:.2f}); bit for bit load_jax_params(ema tree); raw params' chunks "
        f"differ by {ema_gap:.3e}; launches {nonzero(launches)} [{smi}]")
    return {"path": path, "hyperparams": hp, "norm": norm, "mb": mb, "read_s": read_s,
            "first_read_s": first_s,
            "ms_per_period": ms, "phase4_ms_per_period": phase4_ms, "launches": launches,
            "ema_vs_raw_max_abs": ema_gap}


def ckpt_student_phase(work: Path, teacher: dict, device, smi) -> dict:
    """2. The teacher's checkpoint as a distilled_decoder student (with
    proprio_fused.yaml's fused stack and decoder-layer knobs): through
    RolloutEngine's fused denoiser (2 periods at B=1024: the encoder, one
    denoiser launch and a pack a layer each period), and through `cli serve`
    at B=1 for SERVE_S seconds in its own interpreter (the sampler runs the
    model's own layers: 3 encoder-stack and 4 decoder-layer forwards a
    replan), every tick after the first chunk commanding the plant."""
    path = work / "jax_student"
    shutil.copytree(teacher["path"], path)
    hp = {**teacher["hyperparams"], "distilled_decoder": True, "encoder_fused_stack": True,
          "decoder_fused_block": True}
    (path / "hyperparams.json").write_text(
        json.dumps({"hyperparams": hp, "current_epoch": CKPT_EPOCH}, indent=2))
    (model, normalizer, steps, distilled, _), read_s = timed_load(path, device)
    if (steps, distilled) != (1, True):
        raise AssertionError(f"JAX student: served at {steps} steps, distilled={distilled}")
    layers = model.config.num_decoder_layers
    _, ms, launches = ckpt_rollout(model, normalizer, steps, device, BENCH_B, CKPT_PERIODS, 8,
                                   distilled=True, fused=True, fused_encoder=True)
    expect_exact("JAX student distilled1", launches, {
        "fused_encoder": CKPT_PERIODS, "fused_denoise": CKPT_PERIODS,
        "fused_denoise_pack": layers * CKPT_PERIODS})
    del model
    stats = serve_process(["serve", str(path), "--duration", str(SERVE_S), "--device", device])
    got = stats.pop("counters")
    sent = stats["ticks"] - stats["ticks_without_chunk"]
    per = {"fused_encoder_stack_fwd": 3, "fused_decoder_layer_fwd": layers}
    expect_exact("JAX student cli serve", got,
                 {k: n * (stats["replans"] + 1) for k, n in per.items()})
    if stats["nonfinite_chunks"] or not stats["commands_delivered"] == sent >= 1:
        raise AssertionError(f"JAX student cli serve: {stats}")
    log(f"checkpoint JAX student (distilled_decoder): load_policy {read_s:.3f} s; "
        f"{CKPT_PERIODS} distilled1 periods B={BENCH_B}: {ms:.2f} ms/period, launches "
        f"{nonzero(launches)}; cli serve {SERVE_S:g} s at B=1: {stats['replans']} replans, plan p50 "
        f"{stats['plan_ms']['p50']:.2f} ms, {stats['commands_delivered']} commands for "
        f"{sent} ticks after the first chunk, launches {nonzero(got)} [{smi}]")
    return {"read_s": read_s, "ms_per_period": ms, "launches": launches,
            "serve": {**stats, "launches": {k: v for k, v in got.items() if v}}}


def ckpt_resnet_phase(work: Path, device, smi) -> dict:
    """3. default_tpu.yaml (ResNet18) in the JAX format with batch_stats and
    opt_state {} (the JAX importer's shape): the BatchNorm buffers bit for
    bit the written statistics, then 2 cached ddim30 periods at B=64."""
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.utils.jax_params import _flatten, random_jax_params

    config = yaml_config("default_tpu.yaml")
    cfg = config.model
    params, stats = random_jax_params(DiffusionPolicy(cfg), 66)
    path = work / "jax_resnet"
    write_jax_checkpoint(path, config.to_dict(), params, ckpt_norm(cfg.num_joints, 67),
                         batch_stats=stats, opt_state={})
    (model, normalizer, steps, _, _), read_s = timed_load(path, device)
    buffers = dict(model.named_buffers())
    written = _flatten(stats)
    for flax_path, value in written.items():
        name = flax_path.replace("/", ".")
        if not torch.equal(buffers[name].cpu(), torch.from_numpy(value)):
            raise AssertionError(f"JAX ResNet checkpoint: buffer {name} differs from the written "
                                 "batch_stats")
    _, ms, launches = ckpt_rollout(model, normalizer, steps, device, RESNET_B, CKPT_PERIODS, 9,
                                   fused="chunk")
    expect_exact("JAX ResNet ddim30", launches, {"fused_chunk": CKPT_PERIODS})
    mb = ckpt_size_mb(path)
    log(f"checkpoint JAX default_tpu (ResNet18, {mb:.2f} MB, batch_stats, opt_state {{}}): "
        f"load_policy {read_s:.3f} s; {len(written)} BatchNorm buffers bit for bit; "
        f"{CKPT_PERIODS} cached ddim30 periods B={RESNET_B}: {ms:.2f} ms/period; launches "
        f"{nonzero(launches)} [{smi}]")
    return {"mb": mb, "read_s": read_s, "buffers": len(written), "ms_per_period": ms,
            "launches": launches}


def ckpt_resume_phase(work: Path, device, smi) -> dict:
    """4. `train.py --checkpoint` from a JAX checkpoint of proprio_fused.yaml
    (params, AdamW moments at count CKPT_STEP) for CKPT_RESUME_STEPS steps
    (rows 4-5 forward and backward), against the same start written in the
    port's own format (the moments set on the AdamW state directly):
    losses and parameters within CKPT_RESUME_TOL relative."""
    import yaml

    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.training.checkpoint import save_checkpoint
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train
    from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, flax_parameters, load_jax_params

    raw = yaml.safe_load((CONFIG_DIR / "proprio_fused.yaml").read_text())
    config = Config.from_dict({**raw, "log_every": 1, "epochs": 2})
    cfg, tc, hp = config.model, config.train, config.to_dict()
    skeleton = DiffusionPolicy(cfg)
    params = flax_init_params(skeleton, 68)[0]
    mu, nu = ckpt_moments(skeleton, 69)
    norm = ckpt_norm(cfg.num_joints, 70)
    count = CKPT_RESUME_STEPS
    jax_dir, port_dir = work / "resume_jax", work / "resume_port"
    write_jax_checkpoint(jax_dir, hp, params, norm, opt_state=jax_opt_state(mu, nu, count),
                         step=count, epoch=0)
    model = load_jax_params(DiffusionPolicy(cfg), params).to(device)
    opt = make_optimizer(model, tc.lr, 2 * CKPT_RESUME_STEPS, tc.weight_decay,
                         grad_clip_norm=tc.grad_clip_norm)
    moments = [flax_parameters(skeleton, m) for m in (mu, nu)]
    for name, p in model.named_parameters():
        opt.adamw.state[p] = {"step": torch.tensor(float(count), device=device),
                              "exp_avg": moments[0][name].to(device),
                              "exp_avg_sq": moments[1][name].to(device)}
    state = create_train_state(model, opt)
    state.step = count
    save_checkpoint(port_dir, state, Normalizer(mean=torch.from_numpy(norm[0]),
                                                std=torch.from_numpy(norm[1])), hp, 0)
    runs = {}
    for label, start in (("jax", jax_dir), ("port", port_dir)):
        metrics = work / f"resume_{label}.jsonl"
        zero_counters()
        t0 = time.perf_counter()
        st = train(config, RunOptions(output=str(work / f"resumed_{label}"), checkpoint=str(start),
                                      dummy_data=True, epochs=2,
                                      steps_per_epoch=CKPT_RESUME_STEPS, seed=0,
                                      metrics=str(metrics), device=device))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[label] = {"step": st.step, "seconds": seconds, "launches": read_counters(),
                       "loss": [json.loads(line)["loss"] for line in open(metrics)],
                       "params": {n: p.detach().cpu() for n, p in st.model.named_parameters()}}
        del st
    a, b = runs["jax"], runs["port"]
    if a["step"] != b["step"] or a["step"] != count + CKPT_RESUME_STEPS or \
            len(a["loss"]) != CKPT_RESUME_STEPS:
        raise AssertionError(f"resume: steps {a['step']} / {b['step']}, losses {a['loss']}")
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a["loss"], b["loss"]))
    param_rel = max((a["params"][n] - p).abs().max().item() / max(p.abs().max().item(), 1e-30)
                    for n, p in b["params"].items())
    for label, run in runs.items():
        missing = [k for k in PROPRIO_TRAIN_KERNELS if run["launches"][k] == 0]
        if missing:
            raise AssertionError(f"resume from the {label} format launched no {missing}")
    log(f"checkpoint resume (proprio_fused.yaml, JAX format vs the port's, {CKPT_RESUME_STEPS} "
        f"steps from step {count}): losses {a['loss']} vs {b['loss']} (largest relative gap "
        f"{loss_rel:.3e}, tol {CKPT_RESUME_TOL}), parameters largest relative gap "
        f"{param_rel:.3e}; {a['seconds']:.2f} s / {b['seconds']:.2f} s with the load; launches "
        f"{ {k: v for k, v in a['launches'].items() if v} } [{smi}]")
    if loss_rel > CKPT_RESUME_TOL or param_rel > CKPT_RESUME_TOL:
        raise AssertionError("resume from the JAX format disagrees with the port's format")
    return {"loss_rel": loss_rel, "param_rel": param_rel, "losses": a["loss"],
            "seconds": [a["seconds"], b["seconds"]], "launches": a["launches"]}


def reference_replica():
    """tests/torch_reference_policy.py (the reference's architecture in torch,
    without JAX), loaded from its file: a ``tests`` package installed on
    the machine would shadow the repository's directory of that name."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "torch_reference_policy.py"
    spec = importlib.util.spec_from_file_location("torch_reference_policy", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def nonzero(launches: dict) -> dict:
    return {name: n for name, n in launches.items() if n}


def ckpt_reference_phase(work: Path, device, smi) -> dict:
    """5. A reference-layout .pth of the h128 architecture (the replica of
    tests/torch_reference_policy.py), standard and legacy ema_model.* with
    --hyperparams, through the port's import_torch_checkpoint: both imports
    hold the same tensors; the replica's own float32 output on the card
    (torch.nn's composite layers, the MHA fast path off) against the port's
    float32 model (TF32 off) within CKPT_REF_TOL of scale; 2 ddim30 periods
    at B=1024 through the kernels."""
    import yaml

    from soccerdiffusion_tpu_torch.config import Config, TrainConfig
    from soccerdiffusion_tpu_torch.training.checkpoint import build_policy, load_checkpoint
    from soccerdiffusion_tpu_torch.utils import import_torch_checkpoint

    replica_module = reference_replica()
    TorchReferencePolicy = replica_module.TorchReferencePolicy
    reference_state_dict = replica_module.reference_state_dict
    cfg = bench_config()
    hp = Config(model=cfg, train=TrainConfig()).to_dict()
    torch.manual_seed(71)
    replica = TorchReferencePolicy(cfg).eval()
    sd = reference_state_dict(replica)
    norm = ckpt_norm(cfg.num_joints, 72)
    sd["mean"], sd["std"] = torch.from_numpy(norm[0]), torch.from_numpy(norm[1])
    torch.save({"model_state_dict": sd, "hyperparams": hp, "current_epoch": 2}, work / "ref.pth")
    legacy = {f"ema_model.{k}": v for k, v in sd.items()}
    legacy.update({"ema_model.initted": torch.tensor(True), "ema_model.step": torch.tensor(100)})
    torch.save(legacy, work / "ref_ema.pth")
    (work / "ref.yaml").write_text(yaml.safe_dump(hp))
    t0 = time.perf_counter()
    import_torch_checkpoint.main([str(work / "ref.pth"), "-o", str(work / "ref_std")])
    import_s = time.perf_counter() - t0
    import_torch_checkpoint.main([str(work / "ref_ema.pth"), "-o", str(work / "ref_legacy"),
                                  "--hyperparams", str(work / "ref.yaml")])
    std, old = load_checkpoint(work / "ref_std"), load_checkpoint(work / "ref_legacy")
    if list(std["params"]) != list(old["params"]) or any(
            not torch.equal(std["params"][k], v) for k, v in old["params"].items()):
        raise AssertionError("reference import: the legacy EMA file's tensors differ")
    model32 = build_policy(dataclasses.replace(cfg, compute_dtype="float32"), std["params"], device)
    rng = np.random.default_rng(73)
    batch = random_batch(cfg, 64, device, rng)
    noisy = torch.from_numpy(rng.normal(size=(64, 10, 20)).astype(np.float32)).to(device)
    t = torch.from_numpy(rng.integers(0, 1000, (64,))).to(device)
    replica = replica.to(device)
    fastpath = torch.backends.mha.get_fastpath_enabled()
    with torch.no_grad():
        got, fused = model32(batch, noisy, t), replica(batch, noisy, t)
        torch.backends.mha.set_fastpath_enabled(False)
        try:
            want = replica(batch, noisy, t)
        finally:
            torch.backends.mha.set_fastpath_enabled(fastpath)
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    fused_err = (fused - want).abs().max().item() / scale
    del model32, replica
    (model, normalizer, steps, _, _), read_s = timed_load(work / "ref_std", device)
    _, ms, launches = ckpt_rollout(model, normalizer, steps, device, BENCH_B, CKPT_PERIODS, 10,
                                   fused="chunk", fused_encoder=True)
    expect_exact("reference import ddim30", launches,
                 {"fused_encoder": CKPT_PERIODS, "fused_chunk": CKPT_PERIODS})
    mb = ckpt_size_mb(work / "ref_std")
    log(f"checkpoint reference .pth (h128) -> import_torch_checkpoint ({import_s:.3f} s) -> "
        f"state.pt ({mb:.2f} MB): load_policy {read_s:.3f} s; the replica's float32 output vs "
        f"the port's: {err / scale:.3e} of scale {scale:.3e} (tol {CKPT_REF_TOL}; torch's fused "
        f"inference fast path of the same replica: {fused_err:.3e}, not gated); standard and legacy "
        f"EMA imports equal; {CKPT_PERIODS} ddim30 periods B={BENCH_B}: {ms:.2f} ms/period; "
        f"launches {nonzero(launches)} [{smi}]")
    if not err <= CKPT_REF_TOL * scale:
        raise AssertionError("the imported reference model disagrees with the reference's output")
    return {"import_s": import_s, "mb": mb, "read_s": read_s, "ref_rel_err": err / scale,
            "ref_fastpath_rel_err": fused_err,
            "ms_per_period": ms, "launches": launches}


def ckpt_refusals(work: Path, teacher: dict) -> dict:
    """6. An orbax checkpoint, a truncated state.msgpack and a state.pt of
    another format each raise ValueError naming what is wrong."""
    from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint

    orbax, cut, other = work / "orbax", work / "truncated", work / "other_pt"
    orbax.mkdir()
    (orbax / "hyperparams.json").write_text(json.dumps(
        {"hyperparams": teacher["hyperparams"], "current_epoch": 0, "backend": "orbax"}))
    shutil.copytree(teacher["path"], cut)
    data = (cut / "state.msgpack").read_bytes()
    (cut / "state.msgpack").write_bytes(data[: len(data) // 2])
    other.mkdir()
    shutil.copy(teacher["path"] / "hyperparams.json", other / "hyperparams.json")
    torch.save({"format": "another/1"}, other / "state.pt")
    out = {}
    for label, path, text in (("orbax", orbax, "needs orbax and tensorstore"),
                              ("truncated", cut, "truncated"),
                              ("other_pt", other, "is not a soccerdiffusion_tpu_torch/1")):
        try:
            load_checkpoint(path)
        except ValueError as e:
            if text not in str(e):
                raise AssertionError(f"refusal {label}: {e}") from e
            out[label] = str(e)
        else:
            raise AssertionError(f"refusal {label}: {path} loaded")
    log(f"checkpoint refusals: {out}")
    return out


def checkpoint_phase(device, smi, phase4_ms) -> dict:
    """Phase 16: checkpoints the port did not write, served, resumed and
    refused on the card (ckpt_*_phase above)."""
    t0 = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as work:
        work = Path(work)
        teacher = ckpt_teacher_phase(work, device, smi, phase4_ms)
        out = {"teacher": {k: v for k, v in teacher.items()
                           if k not in ("path", "hyperparams", "norm")}}
        torch.cuda.empty_cache()
        out["student"] = ckpt_student_phase(work, teacher, device, smi)
        torch.cuda.empty_cache()
        out["resnet"] = ckpt_resnet_phase(work, device, smi)
        torch.cuda.empty_cache()
        out["resume"] = ckpt_resume_phase(work, device, smi)
        torch.cuda.empty_cache()
        out["reference"] = ckpt_reference_phase(work, device, smi)
        out["refusals"] = ckpt_refusals(work, teacher)
    out["phase_s"] = time.perf_counter() - t0
    log(f"checkpoint phase: {out['phase_s']:.1f} s [{smi}]")
    return out


# ------------------------------------------------------- the kernel variants (phase 17)
# int8 context K/V. Both the kernel and its plain version compute the same
# integers, so they differ only where an fp32 value lands on the other side
# of a quantisation boundary in one and not the other; over a 30-step chunk
# such flips grow as any rounding does, so the chunks alone cannot show the
# mechanism. It is held instead on the kernel's own record of every (step,
# layer) (sample_int8_kernel(record=True)), from the inputs it had there:
#   * the query scales: each equal, bit for bit, to the max |q| / 127 of the
#     kernel's bf16 queries over the R robots of its block (a per-robot
#     scale, the control, differs wherever a robot is not its block's max);
#   * the int8 queries: each equal to the plain quantiser at that scale;
#   * the K / V scales: one per block, within KV_SCALE_RTOL of the plain
#     quantiser's over the fp32 projections (summation order), and the int8
#     K/V off the plain quantiser in at most KV_FLIP_SHARE of the elements;
#   * the cross-attention's bf16 output: at least CROSS_EQUAL_SHARE of it
#     bit for bit the plain int8 cross-attention (int8_cross) of the
#     kernel's own queries and K/V, where two controls on the same inputs,
#     the probabilities left unrounded (not in 1/127 steps) and a per-robot
#     query scale, must each come out below it.
# The chunks: the kernel's RMS distance from the plain int8 chunk, at one
# step and at 30, at most INT8_RMS_SHARE of the RMS of the int8 form's own
# quantisation error (plain int8 - plain bf16) on the same inputs, where the
# bf16 kernel's chunk, the control, must come out above it; and the max
# distance within that whole error (max|plain int8 - plain bf16|).
# The limits sit between the kernel's readings and the controls' (a
# calibration on an H100 at 700 W, every R and head dim of phase 17): the
# cross-attention bit for bit in 0.9972-0.9994 of the elements, the
# controls in 0.16-0.18 (unrounded probabilities) and 0.25-0.63 (per-robot
# scales, R >= 2); the chunks' RMS distance 0.25-0.62 of the quantisation's,
# the bf16 kernel's 0.998-1.007.
INT8_TOL = 2 * TOL  # the int8 closed loop, card vs CPU (reference_phase)
KV_FLIP_SHARE, KV_SCALE_RTOL = 1e-4, 1e-5
CROSS_EQUAL_SHARE, INT8_RMS_SHARE = 0.99, 0.8
INT8_BLOCKS, INT8_ENGINE_BLOCK, INT8_REF_BLOCK = (8, 16), 16, 4
# the other cluster shapes (R robots a block on C = 1, 2, 4, 8 blocks of 1 to
# 4 robots), held at B=64 (error only)
INT8_OTHER_BLOCKS = (1, 2, 4, 32)
# H100 SXM dense int8 tensor-core peak (NVIDIA data sheet), ops/s
INT8_OPS = 1979e12
VARIANT_GELUS = ("poly", "bf16")
POLY_TRAIN_STEPS = 4
# launches per h128 training step with encoder_fused_block (and the decoder's
# fused layers): the 3 proprioceptive stacks' 2 layers each as ViT blocks
PROPRIO_BLOCK_LAUNCHES = {"fused_vit_block_fwd": 6, "fused_vit_block_bwd": 6,
                          "fused_decoder_layer_fwd": 4, "fused_decoder_layer_bwd": 4}


def int8_bound(cfg, b, S, T, io_bytes) -> dict:
    """The int8 chunk's least time: its bytes (``io_bytes``: the inputs, the
    output and the int8 K/V written once) over the HBM rate, against its
    operations at their rates: the cross-attention's scores and value sums
    (int8) at the int8 peak, the rest (the K/V projection, every other
    product of the T passes) at the bf16 peak."""
    p, e, L = cfg.trajectory_prediction_length, cfg.hidden_dim, cfg.num_decoder_layers
    int8_ops = b * T * L * attn_flops(p, S, e)
    bf16_ops = b * (2 * S * e * 2 * L * e + T * decoder_pass_flops(cfg, S)) - b * T * L * attn_flops(
        p, S + 1, e)
    t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S, bf16_ops / BF16_FLOPS + int8_ops / INT8_OPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rms(x: torch.Tensor) -> float:
    return x.float().pow(2).mean().sqrt().item()


def int8_cross_unrounded_p(smp, q2, kv, stk_l, stv_l, robots: int) -> torch.Tensor:
    """A control of int8_coupling_checks: the plain int8 cross-attention
    (FusedChunkSampler.int8_cross) with its probabilities left unrounded
    instead of in 1/127 steps."""
    from soccerdiffusion_tpu_torch.ops.fused_chunk import block_scale, quantise

    kq, vq, sk, sv = kv
    H, D = smp.num_heads, smp.head_dim
    heads = lambda t: t.reshape(t.shape[0], t.shape[1], H, D).transpose(1, 2)
    scale = 1.0 / D ** 0.5
    sq = block_scale(q2, robots)
    s = (heads(quantise(q2, sq)) @ heads(kq).transpose(-1, -2)) * ((sq * sk) * scale)[..., None]
    s_x = (heads(q2) * stk_l.float().reshape(H, 1, D)).sum(-1, keepdim=True) * scale
    m = torch.maximum(s.amax(-1, keepdim=True), s_x)
    p, p_x = torch.exp(s - m), torch.exp(s_x - m)
    o = (p @ heads(vq)) * sv[..., None] + p_x * stv_l.float().reshape(H, 1, D)
    o = o / (p.sum(-1, keepdim=True) + p_x)
    return smp._round(o.transpose(1, 2).reshape(q2.shape))


def int8_coupling_checks(smp, context, noise, stk, stv, coefs, R, name) -> dict:
    """The int8 kernel's record of every (step, layer) against the plain
    quantiser and cross-attention on the kernel's own inputs (the comment
    above INT8_TOL), with their controls. Returns the readings."""
    from soccerdiffusion_tpu_torch.ops.fused_chunk import int8_scale, quantise, unpack_int8_kv

    S = context.shape[1]
    _, rec = smp.sample_int8_kernel(context, noise, stk, stv, coefs, R, record=True)
    B, T, L = rec["sq"].shape
    q2 = rec["q2"].float()
    amax = q2.abs().amax((3, 4))  # (B, T, L)
    block = int8_scale(amax.view(B // R, R, T, L).amax(1)).repeat_interleave(R, 0)
    own = int8_scale(amax)
    sq_off, sq_own_off = int((rec["sq"] != block).sum()), int((rec["sq"] != own).sum())
    qq_off = int((rec["qq"].float() != quantise(q2, rec["sq"][..., None, None])).sum())
    plain_kv = smp.int8_context_kv(context, R)
    k, v = unpack_int8_kv(rec["kv"], S)
    kv_off = kv_scale_err = 0
    for l, (kq, vq, sk, sv) in enumerate(plain_kv):
        kv_off += int((k[:, l].float() != kq).sum() + (v[:, l].float() != vq).sum())
        for got, want in ((rec["sk"][:, l], sk[:, 0, 0]), (rec["sv"][:, l], sv[:, 0, 0])):
            kv_scale_err = max(kv_scale_err, ((got - want).abs() / want).max().item())
    one_scale = all(bool((x.view(B // R, R, L) == x.view(B // R, R, L)[:, :1]).all())
                    for x in (rec["sk"], rec["sv"]))
    forms = {"kernel": R, "per_robot_sq": 1, "unrounded_p": None}
    equal, err = dict.fromkeys(forms, 0), 0.0
    for l in range(L):
        kvl = (k[:, l].float(), v[:, l].float(), rec["sk"][:, l, None, None],
               rec["sv"][:, l, None, None])
        for t in range(T):
            q, got = q2[:, t, l], rec["cross"][:, t, l].float()
            for form, robots in forms.items():
                want = (int8_cross_unrounded_p(smp, q, kvl, stk[t, l], stv[t, l], R)
                        if robots is None else smp.int8_cross(q, kvl, stk[t, l], stv[t, l], robots))
                equal[form] += int((got == want).sum())
                if form == "kernel":
                    err = max(err, (got - want).abs().max().item())
    share = {form: n / rec["cross"].numel() for form, n in equal.items()}
    out = {"query_scales_off": sq_off, "per_robot_scales_off": sq_own_off,
           "query_ints_off": qq_off, "kv_elements_differing": kv_off,
           "kv_elements": 2 * k.numel(), "kv_scale_rel_err": kv_scale_err,
           "cross_equal_share": share["kernel"], "cross_max_abs_err": err,
           "control_per_robot_sq_equal_share": share["per_robot_sq"],
           "control_unrounded_p_equal_share": share["unrounded_p"]}
    log(f"{name} B={B} R={R} record of {T} steps x {L} layers: query scales off the block's "
        f"{sq_off} (a per-robot scale: {sq_own_off} of {rec['sq'].numel()} off), int8 queries "
        f"off {qq_off}; K/V scales one per block {one_scale}, rel err {kv_scale_err:.3e} (at most "
        f"{KV_SCALE_RTOL}); int8 K/V elements off {kv_off} of {2 * k.numel()} (at most "
        f"{KV_FLIP_SHARE} of them); cross-attention bit for bit the plain one in "
        f"{share['kernel']:.6f} (at least {CROSS_EQUAL_SHARE}; max_abs_err {err:.4e}), controls: "
        f"a per-robot query scale {share['per_robot_sq']:.6f}, probabilities unrounded "
        f"{share['unrounded_p']:.6f}")
    if sq_off or qq_off or not one_scale or kv_scale_err > KV_SCALE_RTOL \
            or kv_off > KV_FLIP_SHARE * 2 * k.numel() or share["kernel"] < CROSS_EQUAL_SHARE:
        raise AssertionError(f"{name} R={R}: the int8 kernel's record disagrees with its plain "
                             "quantiser and cross-attention")
    if share["unrounded_p"] >= CROSS_EQUAL_SHARE or (R > 1 and (
            not sq_own_off or share["per_robot_sq"] >= CROSS_EQUAL_SHARE)):
        raise AssertionError(f"{name} R={R}: a control passes the record's gate")
    return out


def int8_checks(model, context, noise, device, b, name, blocks=INT8_BLOCKS,
                timed=INT8_BLOCKS) -> tuple[dict, list]:
    """The int8 chunk kernel at each R of ``blocks`` robots a block on one
    context, against its plain version: one step and the 30-step DDIM chunk
    (RMS within INT8_RMS_SHARE of the int8 form's own quantisation error,
    max within the whole of it, the bf16 kernel's chunk the control) and
    its record (int8_coupling_checks); at R in ``timed`` its
    time, the plain version's and the bf16 kernel's on the same inputs.
    Returns the merged result (the last timed R's times) and one record
    per R."""
    from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table
    from soccerdiffusion_tpu_torch.diffusion.ddim import ddim_timesteps
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler, int8_keys

    cfg, S = model.config, context.shape[1]
    coefs = solver_coef_table(make_schedule(1000), 30, "ddim")
    table = model.step_encoding(torch.as_tensor(ddim_timesteps(1000, 30).astype(np.int64),
                                                device=device))[:, 0]
    bf16_chunk = FusedChunkSampler(model)
    stk, stv = bf16_chunk.step_tables(table)
    bf16_ms = median_ms(lambda: bf16_chunk.sample_kernel(context, noise, stk, stv, coefs))
    unquantised = {T: bf16_chunk.sample_plain(context, noise, stk, stv, coefs[:T]) for T in (1, 30)}
    control = {T: bf16_chunk.sample_kernel(context, noise, stk, stv, coefs[:T]) for T in (1, 30)}
    results, records = {}, []
    for R in blocks:
        smp = FusedChunkSampler(model, block_robots=R, context_kv_quant="int8")
        rec = {"batch": b, "block_robots": R}
        for T in (1, 30):
            got = smp.sample_kernel(context, noise, stk, stv, coefs[:T], R)
            plain = smp.sample_plain(context, noise, stk, stv, coefs[:T], R)
            quant = plain - unquantised[T]
            read = {"max_abs_err": (got - plain).abs().max().item(), "rms_err": rms(got - plain),
                    "quant_max": quant.abs().max().item(), "quant_rms": rms(quant),
                    "control_rms_err": rms(control[T] - plain),
                    "max_plain": plain.abs().max().item()}
            limit = INT8_RMS_SHARE * read["quant_rms"]
            log(f"{name} B={b} R={R} {T} step(s): kernel vs plain int8 RMS {read['rms_err']:.4e} "
                f"max {read['max_abs_err']:.4e}; the int8 form's quantisation error (plain int8 - "
                f"plain bf16) RMS {read['quant_rms']:.4e} max {read['quant_max']:.4e}; the "
                f"control (the bf16 kernel) RMS {read['control_rms_err']:.4e}; limit RMS "
                f"{limit:.4e} ({INT8_RMS_SHARE} of the quantisation's), max {read['quant_max']:.4e}"
                f"; max|plain| {read['max_plain']:.4e}")
            if not (torch.isfinite(got).all() and read["rms_err"] <= limit
                    and read["max_abs_err"] <= read["quant_max"]):
                raise AssertionError(f"{name} R={R}: {T} step(s) disagree with the plain version")
            if read["control_rms_err"] <= limit:
                raise AssertionError(f"{name} R={R}: the control (bf16 kernel) passes the gate")
            rec.update({f"{key}_{T}": value for key, value in read.items()})
        if R in timed:
            kv_bytes = b * cfg.num_decoder_layers * 2 * int8_keys(S) * cfg.hidden_dim
            io = nbytes(smp.kernel_weights, context.to(torch.bfloat16), noise, stk, stv) + \
                nbytes(noise) + kv_bytes
            r = compare(f"{name} R={R}",
                        lambda: smp.sample_kernel(context, noise, stk, stv, coefs, R),
                        lambda: smp.sample_plain(context, noise, stk, stv, coefs, R), b, 0, [],
                        tol=rec["quant_max_30"] / rec["max_plain_30"],
                        bnd=int8_bound(cfg, b, S, 30, io))
            log(f"{name} B={b} R={R}: int8 kernel {r['ms']:.3f} ms against the bf16 kernel's "
                f"{bf16_ms:.3f} ms on the same inputs")
            merge(results, name, r)
            rec.update({"ms": r["ms"], "bf16_ms": bf16_ms})
        else:
            merge(results, name, {**results[name], "max_abs_err": rec["max_abs_err_30"]})
        rec.update(int8_coupling_checks(smp, context, noise, stk, stv, coefs, R, name))
        records.append(rec)
    return results, records


def variant_serving_phase(model, device) -> tuple[dict, dict, dict]:
    """h128 (bench_config): the int8 chunk at B=64 and BENCH_B
    (int8_checks) and at INT8_OTHER_BLOCKS at B=64, "qstat" at B=64 (its
    sampler driven once through sample(), its launch counted), the
    engine's 5 int8 ddim30 periods at BENCH_B (fused_block_robots=16: exact
    launches) and 2 periods card vs CPU at B=8 (blocks of 4), groups of 4
    robots bit for bit the ungrouped engine's chunks."""
    from soccerdiffusion_tpu_torch.diffusion import make_schedule, solver_coef_table
    from soccerdiffusion_tpu_torch.diffusion.ddim import ddim_timesteps
    from soccerdiffusion_tpu_torch.ops.fused_chunk import FusedChunkSampler
    from soccerdiffusion_tpu_torch.ops.fused_encoder import FusedContextEncoder

    cfg = model.config
    enc = FusedContextEncoder(model)
    results, records, launches = {}, [], {}
    for b in (64, BENCH_B):
        rng = np.random.default_rng(1700 + b)
        with torch.no_grad():
            context = enc.encode_plain(random_batch(cfg, b, device, rng))
            noise = torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32)).to(device)
            r, rec = int8_checks(model, context, noise, device, b, "fused_chunk_int8",
                                 INT8_BLOCKS + (INT8_OTHER_BLOCKS if b == 64 else ()))
        merge(results, "fused_chunk_int8", r["fused_chunk_int8"])
        records += rec
        if b == 64:  # "qstat", the JAX package's experiment-only orientation
            qs = FusedChunkSampler(model, cross_orientation="qstat")
            table = model.step_encoding(torch.as_tensor(
                ddim_timesteps(1000, 30).astype(np.int64), device=device))[:, 0]
            stk, stv = qs.step_tables(table)
            coefs = solver_coef_table(make_schedule(1000), 30, "ddim")
            S, e, L = context.shape[1], cfg.hidden_dim, cfg.num_decoder_layers
            with torch.no_grad():
                results["fused_chunk_qstat"] = compare(
                    "fused_chunk_qstat", lambda: qs.sample_kernel(context, noise, stk, stv, coefs),
                    lambda: qs.sample_plain(context, noise, stk, stv, coefs), b,
                    b * (2 * S * e * 2 * L * e + 30 * decoder_pass_flops(cfg, S)),
                    [qs.kernel_weights, context, noise, stk, stv])
                torch.cuda.synchronize()
                zero_counters()
                out = qs.sample(context, noise, table, make_schedule(1000), 30)
                torch.cuda.synchronize()
                got = nonzero(read_counters())
            if got != {"fused_chunk": 1} or not torch.isfinite(out).all():
                raise AssertionError(f"qstat sample(): launches {got}")
            launches["fused_chunk_qstat"] = got["fused_chunk"]
    eng = engine(model, cfg, device, fused="chunk", fused_kv_quant="int8",
                 fused_block_robots=INT8_ENGINE_BLOCK)
    eng.make_rollout_fn(1)(eng.init(BENCH_B, torch.Generator(device=device).manual_seed(0)))
    ms, got = timed_rollout(eng, device, 1)
    want = {name: 0 for name in got} | {"fused_encoder": CHUNKS, "fused_chunk_int8": CHUNKS}
    log(f"int8 K/V serving (RolloutEngine fused='chunk', fused_kv_quant='int8', "
        f"fused_block_robots={INT8_ENGINE_BLOCK}) B={BENCH_B}, {CHUNKS} periods: {ms:.2f} "
        f"ms/period; launches {nonzero(got)}")
    if got != want:
        raise AssertionError(f"int8 serving: launches {got}, expected {want}")
    launches["fused_chunk_int8"] = got["fused_chunk_int8"]
    reference_phase(cfg, model, device, b=8, tol=INT8_TOL, fused="chunk", fused_kv_quant="int8",
                    fused_block_robots=INT8_REF_BLOCK)
    # groups of robots compute the ungrouped function: the same chunks bit for bit
    chunks = {}
    for g in (1, 4):
        e = engine(model, cfg, device, fused="chunk", fused_group_robots=g)
        _, chunks[g] = e.make_rollout_fn(2)(e.init(64, torch.Generator(device=device).manual_seed(3)))
    if not torch.equal(chunks[1], chunks[4]):
        raise AssertionError("fused_group_robots=4 changed the chunks")
    log("fused_group_robots=4: B=64, 2 periods, the chunks bit for bit those of 1")
    return results, launches, {"int8_records": records, "int8_ms_per_replan_period": ms}


def vit_variant_checks(model, device) -> dict:
    """The flagship's ViT block (block 0's weights) under "poly" and "bf16",
    forward and backward at FLAG_VIT_FRAMES frames, against their plain
    versions, timed beside exact GELU's kernel on the same inputs and, for
    "bf16" (quick-GELU in bf16), torch.nn's quick-GELU layer."""
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    cfg = model.config
    vit = model.image_sequence_encoder.image_encoder
    T, W, H = (cfg.image_resolution // cfg.vit_patch_size) ** 2, cfg.vit_width, vit.num_heads
    vit_w = [t.detach().to(torch.bfloat16) for t in fes.encoder_layer_weights(vit.blocks.layers[0])]
    rng = np.random.default_rng(1717)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device, torch.bfloat16)
    results, exact = {}, {}
    for n in FLAG_VIT_FRAMES:
        x, dy = t(n, T, W), t(n, T, W)
        exact[n] = (median_ms(lambda: fvb.forward_kernel(x, vit_w, H, "exact")),
                    median_ms(lambda: fvb.backward_kernel(x, dy, vit_w, H, "exact")))
        log(f"fused ViT block N={n} exact GELU: forward {exact[n][0]:.3f} ms, backward "
            f"{exact[n][1]:.3f} ms")
        for gelu in VARIANT_GELUS:
            lib = torch_encoder([w[None] for w in vit_w], H, quick_gelu) if gelu == "bf16" else None
            with torch.no_grad():
                merge(results, f"fused_vit_block_fwd_{gelu}", compare(
                    f"fused_vit_block_fwd_{gelu} N={n}",
                    lambda g=gelu: fvb.forward_kernel(x, vit_w, H, g),
                    lambda g=gelu: fvb.forward_plain(x, vit_w, H, g), n,
                    n * enc_layer_flops(T, W, 4 * W), [x, vit_w],
                    None if lib is None else (lambda: lib(x))))
            log(f"fused ViT block backward N={n} ({gelu} GELU):")
            dx, grads = fvb.backward_kernel(x, dy, vit_w, H, gelu)
            dx_ref, grads_ref = fvb.backward_plain(x, dy, vit_w, H, gelu)
            err = max(err_line("dx", dx, dx_ref),
                      grads_check(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(W, 2 * W)}))
            time_checked(results, f"N={n} frames", {f"fused_vit_block_bwd_{gelu}": (
                err, lambda g=gelu: fvb.backward_kernel(x, dy, vit_w, H, g),
                lambda g=gelu: fvb.backward_plain(x, dy, vit_w, H, g),
                3 * n * enc_layer_flops(T, W, 4 * W), [x, dy, vit_w, dx, grads],
                None if gelu == "poly" else LibraryGrad(
                    encoder_grad_fn([w[None] for w in vit_w], H, x, dy, quick_gelu,
                                    stacked=False), fes.STACK_WEIGHTS, {"bqkv": slice(W, 2 * W)}))})
    return results, {f"N{n}": {"fwd_ms": f, "bwd_ms": b} for n, (f, b) in exact.items()}


def gelu_flagship_config(gelu: str):
    return dataclasses.replace(flagship_config(), vit_fused_gelu=gelu)


def gelu_train_config(gelu: str, batch: int):
    config = flagship_train_config(batch)
    return dataclasses.replace(config, model=dataclasses.replace(config.model,
                                                                 vit_fused_gelu=gelu))


def variant_flagship_phase(device) -> tuple[dict, dict, dict]:
    """The flagship (vit_flagship.yaml's model): the int8 chunk at head_dim
    64 (B=64) and its cached ddim30 lane with int8 K/V (5 periods, blocks of
    16); under "poly" 5 cached ddim30 periods; the ViT block's variants
    (vit_variant_checks); 20 training steps under "bf16" and
    POLY_TRAIN_STEPS under "poly" through train.py (packed dummy data, exact
    launches a step)."""
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train

    flag = build_model(flagship_config(), device, seed=3)
    cfg = flag.config
    rng = np.random.default_rng(1764)
    b = FLAG_B
    batch = random_batch(cfg, b, device, rng)
    batch["image_tokens"] = torch.from_numpy(
        rng.normal(size=(b, cfg.image_context_length, cfg.hidden_dim)).astype(np.float32)).to(device)
    with torch.no_grad():
        context = flag.encode_context(batch)
        noise = torch.from_numpy(rng.normal(size=(b, 10, 20)).astype(np.float32)).to(device)
        r, records = int8_checks(flag, context, noise, device, b, "fused_chunk_int8_hd64")
    results, launches = dict(r), {}
    lane = FLAG_LANES["ddim30"][1]
    for label, model, kw, per_period in (
            ("int8", flag, dict(fused_kv_quant="int8", fused_block_robots=INT8_ENGINE_BLOCK),
             {**lane, "fused_chunk": 0, "fused_chunk_int8": 1}),
            ("poly", None, {}, lane)):
        if model is None:
            model = build_model(gelu_flagship_config("poly"), device, seed=3)
        eng = engine(model, model.config, device, fused="chunk", fused_encoder=False, **kw)
        eng.make_rollout_fn(1)(eng.init(FLAG_B, torch.Generator(device=device).manual_seed(0)))
        ms, got = timed_rollout(eng, device, 1, FLAG_B, CHUNKS)
        want = {name: per_period.get(name, 0) * CHUNKS for name in got}
        log(f"flagship cached ddim30 lane ({label}) B={FLAG_B}, {CHUNKS} periods: {ms:.2f} "
            f"ms/period; launches {nonzero(got)}")
        if got != want:
            raise AssertionError(f"flagship {label} lane: launches {got}, expected {want}")
        launches[label] = (got, ms)
    vit, exact = vit_variant_checks(flag, device)
    results.update(vit)
    del flag, model
    torch.cuda.empty_cache()
    train_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        zero_counters()
        ms_bf16, losses = timed_training(gelu_train_config("bf16", FLAG_TRAIN_B), tmp, "bf16",
                                         packed=True)
        got = read_counters()
        log(f"flagship training with vit_fused_gelu bf16 (train.py, packed dummy data, "
            f"B={FLAG_TRAIN_B}, {TRAIN_STEPS} steps): {ms_bf16:.3f} ms/step; losses {losses}")
        train_launches["bf16"] = expect_launches("bf16 flagship training", got,
                                                 FLAG_TRAIN_LAUNCHES, TRAIN_STEPS)
        zero_counters()
        state = train(gelu_train_config("poly", FLAG_TRAIN_B), RunOptions(
            output=f"{tmp}/ckpt_poly", dummy_data=True, packed=True, epochs=1,
            steps_per_epoch=POLY_TRAIN_STEPS, seed=0, metrics=f"{tmp}/metrics_poly.jsonl"))
        torch.cuda.synchronize()
        got = read_counters()
        if state.step != POLY_TRAIN_STEPS or not all(torch.isfinite(p).all()
                                                     for p in state.model.parameters()):
            raise AssertionError("the poly flagship training did not run its steps")
        train_launches["poly"] = expect_launches("poly flagship training", got,
                                                 FLAG_TRAIN_LAUNCHES, POLY_TRAIN_STEPS)
        log(f"flagship training with vit_fused_gelu poly, {POLY_TRAIN_STEPS} steps: launches "
            f"{train_launches['poly']}")
    return results, {"serving": launches, "training": train_launches}, {
        "int8_hd64_records": records, "vit_exact": exact, "bf16_train_ms_per_step": ms_bf16,
        "flagship_int8_ms_per_replan_period": launches["int8"][1],
        "flagship_poly_ms_per_replan_period": launches["poly"][1]}


def encoder_fused_block_config():
    """The h128 training configuration with encoder_fused_block: the stacks'
    layers as ViT blocks (the fused stack off, which would win), the
    decoder's fused layers on."""
    config = train_config(True)
    return dataclasses.replace(config, model=dataclasses.replace(
        config.model, encoder_fused_block=True, encoder_fused_stack=False))


def encoder_fused_block_phase(device) -> tuple[dict, dict, float]:
    """encoder_fused_block at h128: the ViT block at the proprioceptive
    stacks' shape (B=64 robots, T=100, W=128, 4 heads of 32, exact GELU)
    forward and backward against the plain versions and torch.nn; 20
    train.py steps at B=64 (exact launches: 6 ViT-block forwards and 6
    backwards a step, the decoder's 4 + 4); 3 steps card vs CPU."""
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    config = encoder_fused_block_config()
    model = build_model(config.model, device, seed=2)
    layer = model.action_history_encoder.seq.encoder.layers[0]
    w = [t.detach().to(torch.bfloat16) for t in fes.encoder_layer_weights(layer)]
    E, T, H = config.model.hidden_dim, config.model.action_context_length, layer.num_heads
    rng = np.random.default_rng(1777)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device, torch.bfloat16)
    x, dy = t(TRAIN_BATCH, T, E), t(TRAIN_BATCH, T, E)
    results = {}
    with torch.no_grad():
        results["fused_vit_block_fwd_proprio"] = compare(
            "fused_vit_block_fwd_proprio", lambda: fvb.forward_kernel(x, w, H, "exact"),
            lambda: fvb.forward_plain(x, w, H, "exact"), TRAIN_BATCH,
            TRAIN_BATCH * enc_layer_flops(T, E, E), [x, w],
            lambda lib=torch_encoder([a[None] for a in w], H): lib(x))
    log(f"fused ViT block backward at the proprioceptive stacks' shape B={TRAIN_BATCH}:")
    dx, grads = fvb.backward_kernel(x, dy, w, H, "exact")
    dx_ref, grads_ref = fvb.backward_plain(x, dy, w, H, "exact")
    err = max(err_line("dx", dx, dx_ref),
              grads_check(fes.STACK_WEIGHTS, grads, grads_ref, {"bqkv": slice(E, 2 * E)}))
    time_checked(results, f"B={TRAIN_BATCH}", {"fused_vit_block_bwd_proprio": (
        err, lambda: fvb.backward_kernel(x, dy, w, H, "exact"),
        lambda: fvb.backward_plain(x, dy, w, H, "exact"), 3 * TRAIN_BATCH * enc_layer_flops(T, E, E),
        [x, dy, w, dx, grads],
        LibraryGrad(encoder_grad_fn([a[None] for a in w], H, x, dy, stacked=False),
                    fes.STACK_WEIGHTS, {"bqkv": slice(E, 2 * E)}))})
    del model
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        zero_counters()
        ms, losses = timed_training(config, tmp, "encoder_fused_block")
        got = read_counters()
    log(f"h128 training with encoder_fused_block (train.py, synthetic data, B={TRAIN_BATCH}, "
        f"{TRAIN_STEPS} steps): {ms:.3f} ms/step; losses {losses}")
    launches = expect_launches("encoder_fused_block training", got, PROPRIO_BLOCK_LAUNCHES,
                               TRAIN_STEPS)
    training_reference_phase(device, config.model, h128_reference_batches(), 17)
    return results, launches, ms


def variant_larger_phase(device) -> tuple[dict, int, dict]:
    """larger_model.yaml (head_dim 128, 8 decoder layers): the int8 chunk at
    LARGER_B against its plain version (int8_checks) and its cached ddim30
    lane with int8 K/V (blocks of 16, exact launches)."""
    model = larger_model(device)
    cfg = model.config
    rng = np.random.default_rng(1791)
    with torch.no_grad():
        batch = random_batch(cfg, LARGER_B, device, rng)
        tokens = rng.normal(size=(LARGER_B, cfg.image_context_length, cfg.hidden_dim))
        batch["image_tokens"] = torch.from_numpy(tokens.astype(np.float32)).to(device)
        context = model.encode_context(batch)
        noise = torch.from_numpy(rng.normal(size=(LARGER_B, 10, 20)).astype(np.float32)).to(device)
        results, records = int8_checks(model, context, noise, device, LARGER_B,
                                       "fused_chunk_int8_hd128")
    eng = engine(model, cfg, device, fused="chunk", fused_encoder=False, fused_kv_quant="int8",
                 fused_block_robots=INT8_ENGINE_BLOCK)
    eng.make_rollout_fn(1)(eng.init(LARGER_B, torch.Generator(device=device).manual_seed(0)))
    ms, got = timed_rollout(eng, device, 1, LARGER_B, CHUNKS)
    want = {name: 0 for name in got} | {"fused_chunk_int8": CHUNKS}
    log(f"larger_model cached ddim30 lane with int8 K/V B={LARGER_B}, {CHUNKS} periods: "
        f"{ms:.2f} ms/period; launches {nonzero(got)}")
    if got != want:
        raise AssertionError(f"larger_model int8 lane: launches {got}, expected {want}")
    return results, got["fused_chunk_int8"], {"int8_hd128_records": records,
                                              "larger_int8_ms_per_replan_period": ms}


def variants_phase(device) -> tuple[dict, dict, dict]:
    """Phase 17: every kernel variant of the slice (module docstring)."""
    t0 = time.perf_counter()
    model = build_model(bench_config(), device)
    results, serving, info = variant_serving_phase(model, device)
    del model
    torch.cuda.empty_cache()
    flag_results, flag_launches, flag_info = variant_flagship_phase(device)
    results.update(flag_results)
    torch.cuda.empty_cache()
    efb_results, efb_launches, efb_ms = encoder_fused_block_phase(device)
    results.update(efb_results)
    torch.cuda.empty_cache()
    larger_results, larger_launches, larger_info = variant_larger_phase(device)
    results.update(larger_results)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 17 (kernel variants): {seconds:.1f} s")
    launches = {
        "fused_chunk_int8": serving["fused_chunk_int8"],
        "fused_chunk_qstat": serving["fused_chunk_qstat"],
        "fused_chunk_int8_hd64": flag_launches["serving"]["int8"][0]["fused_chunk_int8"],
        "fused_chunk_int8_hd128": larger_launches,
        "fused_vit_block_fwd_poly": flag_launches["serving"]["poly"][0]["fused_vit_block_fwd"]
        + flag_launches["training"]["poly"]["fused_vit_block_fwd"],
        "fused_vit_block_bwd_poly": flag_launches["training"]["poly"]["fused_vit_block_bwd"],
        "fused_vit_block_fwd_bf16": flag_launches["training"]["bf16"]["fused_vit_block_fwd"],
        "fused_vit_block_bwd_bf16": flag_launches["training"]["bf16"]["fused_vit_block_bwd"],
        "fused_vit_block_fwd_proprio": efb_launches["fused_vit_block_fwd"],
        "fused_vit_block_bwd_proprio": efb_launches["fused_vit_block_bwd"]}
    return results, launches, {**info, **flag_info, **larger_info,
                               "encoder_fused_block_train_ms_per_step": efb_ms,
                               "seconds": seconds}


# phase 18: recorded data through the port's ingest/ (a Bit-Bots bag written,
# imported, packed and exported by the port), training from it with the flat
# optimizer (flat_optimizer) beside the per-tensor one, the two resumes the
# flat optimizer brings, and the trained checkpoint served
INGEST_SECONDS = 60  # of play in the synthesised bag
INGEST_HZ, INGEST_CAMERA_EVERY, INGEST_GAMESTATE_EVERY = 100, 10, 50  # 100 / 10 / 2 Hz
INGEST_FRAME = (480, 640)  # bgr8, INTER_AREA to the schema's 480 x 480
INGEST_T0 = 1_700_000_000 * 10 ** 9
INGEST_STEPS, INGEST_B = 20, 64
FLAT_RESUME_STEPS = 2
# the Bit-Bots messages the bag carries beyond ros2_schemas' (the topics and
# schemas of tests/test_mcap_io.py:synthesize_bitbots_bag)
_HEADER = ("=" * 80 + "\nMSG: std_msgs/Header\nbuiltin_interfaces/Time stamp\nstring frame_id\n"
           + "=" * 80 + "\nMSG: builtin_interfaces/Time\nint32 sec\nuint32 nanosec\n")
JOINT_COMMAND_SCHEMA = ("std_msgs/Header header\nstring[] joint_names\nfloat64[] positions\n"
                        "float64[] velocities\nfloat64[] accelerations\nfloat64[] max_currents\n"
                        + _HEADER)
IMU_SCHEMA = ("std_msgs/Header header\ngeometry_msgs/Quaternion orientation\n"
              "float64[9] orientation_covariance\ngeometry_msgs/Vector3 angular_velocity\n"
              "float64[9] angular_velocity_covariance\ngeometry_msgs/Vector3 linear_acceleration\n"
              "float64[9] linear_acceleration_covariance\n" + "=" * 80
              + "\nMSG: geometry_msgs/Quaternion\nfloat64 x\nfloat64 y\nfloat64 z\nfloat64 w\n"
              + "=" * 80 + "\nMSG: geometry_msgs/Vector3\nfloat64 x\nfloat64 y\nfloat64 z\n"
              + _HEADER)
GAMESTATE_SCHEMA = ("std_msgs/Header header\nuint8 game_state\nuint8 secondary_state\n"
                    "bool first_half\nuint8 own_score\nuint8 rival_score\nbool penalized\n"
                    "uint16 seconds_till_unpenalized\nuint8 team_color\n" + _HEADER)


def ingest_frame(k: int) -> np.ndarray:
    """The bag's k-th camera frame (bgr8), from its own seed."""
    return np.random.default_rng(1000 + k).integers(0, 256, (*INGEST_FRAME, 3), dtype=np.uint8)


def write_ingest_bag(path: Path, seconds: int) -> dict:
    """A Bit-Bots bag written by the port's MCAP writer (no zstd: the card's
    machine may lack zstandard): joint states, commands and IMU at 100 Hz, a
    10 Hz 640 x 480 bgr8 camera, the game state every 0.5 s."""
    from types import SimpleNamespace

    from soccerdiffusion_tpu_torch.config import CANONICAL_JOINT_NAMES_22
    from soccerdiffusion_tpu_torch.ingest import ros2_schemas
    from soccerdiffusion_tpu_torch.ingest.mcap_io import McapWriter, encode_cdr

    joints = list(CANONICAL_JOINT_NAMES_22)
    header = lambda sec, frame="base_link": SimpleNamespace(
        stamp=SimpleNamespace(sec=sec, nanosec=0), frame_id=frame)
    types = {"/joint_states": ("sensor_msgs/msg/JointState", ros2_schemas.JOINT_STATE_SCHEMA),
             "/DynamixelController/command": ("bitbots_msgs/msg/JointCommand",
                                              JOINT_COMMAND_SCHEMA),
             "/imu/data": ("sensor_msgs/msg/Imu", IMU_SCHEMA),
             "/camera/image_proc": ("sensor_msgs/msg/Image", ros2_schemas.IMAGE_SCHEMA),
             "/gamestate": ("bitbots_msgs/msg/GameState", GAMESTATE_SCHEMA)}
    t0 = time.perf_counter()
    ticks = seconds * INGEST_HZ
    with open(path, "wb") as f:
        w = McapWriter(f)
        w.start()
        channel = {topic: w.register_channel(topic, "cdr", w.register_schema(
            name, "ros2msg", text.encode())) for topic, (name, text) in types.items()}

        def put(topic, t, msg):
            w.add_message(channel[topic], t, t, encode_cdr(types[topic][1], types[topic][0], msg))

        for i in range(ticks):
            t = INGEST_T0 + i * (10 ** 9 // INGEST_HZ)
            pos = (0.3 * np.sin(i / 25.0 + np.arange(22) * 0.1)).tolist()
            put("/joint_states", t, SimpleNamespace(header=header(i), name=joints, position=pos,
                                                    velocity=[], effort=[]))
            put("/DynamixelController/command", t + 1000, SimpleNamespace(
                header=header(i), joint_names=joints, positions=(np.asarray(pos) + 0.01).tolist(),
                velocities=[], accelerations=[], max_currents=[]))
            ang = 0.05 * np.sin(i / 10.0)
            zero = SimpleNamespace(x=0.0, y=0.0, z=0.0)
            put("/imu/data", t + 2000, SimpleNamespace(
                header=header(i, "imu"), orientation=SimpleNamespace(
                    x=float(np.sin(ang / 2)), y=0.0, z=0.0, w=float(np.cos(ang / 2))),
                orientation_covariance=[0.0] * 9, angular_velocity=zero,
                angular_velocity_covariance=[0.0] * 9,
                linear_acceleration=SimpleNamespace(x=0.0, y=0.0, z=9.8),
                linear_acceleration_covariance=[0.0] * 9))
            if i % INGEST_CAMERA_EVERY == 0:
                h, wd = INGEST_FRAME
                put("/camera/image_proc", t + 3000, SimpleNamespace(
                    header=header(i, "camera"), height=h, width=wd, encoding="bgr8",
                    is_bigendian=0, step=3 * wd,
                    data=ingest_frame(i // INGEST_CAMERA_EVERY).tobytes()))
            if i % INGEST_GAMESTATE_EVERY == 0:
                put("/gamestate", t + 4000, SimpleNamespace(
                    header=header(i), game_state=3, secondary_state=0, first_half=True,
                    own_score=1, rival_score=0, penalized=False, seconds_till_unpenalized=0,
                    team_color=1))
        w.finish()
    return {"ticks": ticks, "write_s": time.perf_counter() - t0,
            "bytes": path.stat().st_size}


def mb(path: Path) -> float:
    files = [path] if path.is_file() else [p for p in path.rglob("*") if p.is_file()]
    return sum(p.stat().st_size for p in files) / 1e6


def ingest_cli_phase(work: Path, seconds: int, smi) -> dict:
    """The bag through `cli import`, `cli pack` (the flagship's 224 px) and
    `cli db recording2mcap` on the card's host. Gates: exit 0; the rows the
    rates give (joint rows at 50 Hz over the recording, a frame each 0.1 s,
    a game state each 0.5 s; within one row, the resamplers' float grid);
    every imported frame equal to the port's resize of the frame written."""
    import sqlite3

    from soccerdiffusion_tpu_torch import cli
    from soccerdiffusion_tpu_torch.data.resize import resize_area
    from soccerdiffusion_tpu_torch.ingest.mcap_io import McapReader

    bag, db = work / "game.mcap", work / "ingest.sqlite3"
    out = {"seconds_of_play": seconds, "bag": write_ingest_bag(bag, seconds)}
    try:
        import zstandard  # noqa: F401 -- only whether it imports

        out["zstandard"] = True
    except ImportError:
        out["zstandard"] = False
    log(f"ingest: a {seconds} s Bit-Bots bag written by the port ({out['bag']['ticks']} ticks, "
        f"{out['bag']['bytes'] / 1e6:.1f} MB, {out['bag']['write_s']:.2f} s); zstandard "
        f"{'imports' if out['zstandard'] else 'does not import'} here [{smi}]")

    def run(label, argv):
        t0 = time.perf_counter()
        rc = cli.main(argv)
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli {label}: exit {rc}")
        return seconds

    out["import_s"] = run("import", ["import", "bit-bots", str(bag), "lab", "--db", str(db)])
    conn = sqlite3.connect(db)
    counts = {t: conn.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
              for t in ("JointStates", "JointCommands", "Rotation", "Image", "GameState")}
    ticks = out["bag"]["ticks"]
    span = (ticks - 1) / INGEST_HZ  # from the first complete sample to the last IMU message
    want = {"JointStates": 1 + int(span * 50), "JointCommands": 1 + int(span * 50),
            "Rotation": 1 + int(span * 50), "Image": ticks // INGEST_CAMERA_EVERY,
            "GameState": ticks // INGEST_GAMESTATE_EVERY}
    off = {t: counts[t] - want[t] for t in counts}
    out["rows"], out["rows_expected"] = counts, want
    out["import_rows_per_s"] = sum(counts.values()) / out["import_s"]
    if any(abs(d) > 1 for d in off.values()):
        raise AssertionError(f"imported rows {counts}, the rates give {want}")
    # the frames: the first complete sample (the tick-0 IMU message) is time zero
    first = INGEST_T0 + 2000
    checked = 0
    for stamp, data in conn.execute("SELECT stamp, data FROM Image ORDER BY _id"):
        tick = round((stamp * 1e9 + first - INGEST_T0 - 3000) / (10 ** 9 // INGEST_HZ))
        if tick % INGEST_CAMERA_EVERY:
            raise AssertionError(f"an imported frame at {stamp} s lies on no camera tick")
        want_frame = resize_area(ingest_frame(tick // INGEST_CAMERA_EVERY), 480, 480)[:, :, ::-1]
        if bytes(data) != np.ascontiguousarray(want_frame).tobytes():
            raise AssertionError(f"the frame imported at {stamp} s is not the port's resize of "
                                 "the frame written")
        checked += 1
    conn.close()
    out["frames_checked"] = checked
    out["db_mb"] = mb(db)
    out["pack_s"] = run("pack", ["pack", "bit-bots", str(bag), "lab", str(work / "shards"),
                                 "--config", str(FLAG_YAML)])
    out["shards_mb"] = mb(work / "shards")
    out["export_s"] = run("db recording2mcap", ["db", "recording2mcap", "1",
                                                str(work / "export.mcap"), "--db", str(db)])
    exported = McapReader.from_file(work / "export.mcap")
    per_topic: dict[str, int] = {}
    for ch, _, _ in exported.iter_messages():
        per_topic[ch.topic] = per_topic.get(ch.topic, 0) + 1
    if per_topic.get("/image") != counts["Image"] or \
            per_topic.get("/joint_states") != counts["JointStates"]:
        raise AssertionError(f"the export holds {per_topic}, the database {counts}")
    out["export_mb"] = mb(work / "export.mcap")
    if out["zstandard"]:
        fixture = Path(__file__).resolve().parent / "tests" / "fixtures" / "bitbots_synth.mcap"
        out["fixture_import_s"] = run("import (the committed zstd bag)", [
            "import", "bit-bots", str(fixture), "lab", "--db", str(work / "fixture.sqlite3")])
    log(f"ingest: cli import {out['import_s']:.2f} s ({out['import_rows_per_s']:.0f} rows/s; rows "
        f"{counts}, the rates give {want}), {checked} frames equal the port's resize of the "
        f"frames written; DB {out['db_mb']:.1f} MB; cli pack (224 px) {out['pack_s']:.2f} s, "
        f"shards {out['shards_mb']:.1f} MB; cli db recording2mcap {out['export_s']:.2f} s, "
        f"{out['export_mb']:.1f} MB ({per_topic}) [{smi}]")
    return out


def flat_training_run(config, work: Path, label, device, **opts) -> tuple:
    """train() for INGEST_STEPS steps in one epoch (a sync every
    TRAIN_LOG_EVERY), every counter zeroed just before and read just after:
    (state, launches, ms/step on the host clock between the syncs that end
    steps 12 and 20)."""
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train

    metrics = work / f"metrics_{label}.jsonl"
    torch.cuda.synchronize()
    zero_counters()
    state = train(config, RunOptions(output=str(work / f"ckpt_{label}"), epochs=1,
                                     steps_per_epoch=INGEST_STEPS, seed=0, metrics=str(metrics),
                                     device=device, dummy_data=False, **opts))
    torch.cuda.synchronize()
    launches = read_counters()
    records = [json.loads(line) for line in open(metrics)]
    if state.step != INGEST_STEPS or not all(np.isfinite(r["loss"]) for r in records):
        raise AssertionError(f"{label}: {state.step} steps, losses {[r['loss'] for r in records]}")
    # a record's step is 0-based: 11 ends the 12th step
    timed = [(b["step"] - a["step"], b) for a, b in zip(records, records[1:]) if a["step"] >= 11]
    ms = 1e3 * sum(n / r["steps_per_sec"] for n, r in timed) / sum(n for n, _ in timed)
    return state, launches, ms


def optimizer_launches(cfg, flat: bool, device) -> tuple[int, float, float]:
    """Device ops of one optimizer step (torch.profiler) on ``cfg``'s model,
    flat or per-tensor, their device-busy ms, and the step's host-clock ms
    to a device sync (median of 5, outside the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from soccerdiffusion_tpu_torch.training.trainer import make_optimizer

    model = build_model(cfg, device, seed=7)
    opt = make_optimizer(model, 1e-4, 100, flat=flat)
    for p in model.parameters():
        p.grad = 1e-3 * torch.randn_like(p)
    opt.step(0)  # AdamW's state is made at the first step
    torch.cuda.synchronize()
    wall = []
    for count in range(1, 6):
        t0 = time.perf_counter()
        opt.step(count)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        opt.step(6)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the optimizer's trace holds no device ops")
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3
    return len(dev), busy, statistics.median(wall)


def ingest_training_phase(work: Path, device, smi) -> dict:
    """h128 proprio_fused.yaml `train --db --device-data` from the imported
    database and the flagship `train --packed DIR` from `cli pack`'s shards,
    20 steps at B=64 each with flat_optimizer on and off. Gates: the
    parameters bit for bit between the two (AdamW is elementwise), and the
    training kernels' launches per step as phases 6 and 8 count them."""
    import yaml

    from soccerdiffusion_tpu_torch.config import Config

    raw = yaml.safe_load((CONFIG_DIR / "proprio_fused.yaml").read_text())
    cases = {"h128": (Config.from_dict({**raw, "batch_size": INGEST_B,
                                        "log_every": TRAIN_LOG_EVERY}),
                      dict(db=str(work / "ingest.sqlite3"), device_data=True), H128_STEP_LAUNCHES),
             "flagship": (flagship_train_config(INGEST_B), dict(packed=str(work / "shards")),
                          FLAG_TRAIN_LAUNCHES)}
    out = {}
    for name, (config, opts, per_step) in cases.items():
        runs = {}
        for flat in (False, True):
            cfg = dataclasses.replace(config, train=dataclasses.replace(config.train,
                                                                        flat_optimizer=flat))
            label = f"{name}_{'flat' if flat else 'per_tensor'}"
            state, got, ms = flat_training_run(cfg, work, label, device, **opts)
            expect_launches(label, got, per_step, INGEST_STEPS)
            if flat and not state.optimizer.in_buffer():
                raise AssertionError(f"{label}: a parameter left the flat buffer")
            runs[flat] = {"ms": ms, "params": {n: p.detach().clone()
                                               for n, p in state.model.named_parameters()}}
            del state
            torch.cuda.empty_cache()
        differ = [n for n, p in runs[False]["params"].items()
                  if not torch.equal(p, runs[True]["params"][n])]
        launches = {flat: optimizer_launches(config.model, flat, device) for flat in (False, True)}
        out[name] = {"ms_per_step": {"per_tensor": runs[False]["ms"], "flat": runs[True]["ms"]},
                     "optimizer_device_ops": {"per_tensor": launches[False][0],
                                              "flat": launches[True][0]},
                     "optimizer_busy_ms": {"per_tensor": launches[False][1],
                                           "flat": launches[True][1]},
                     "optimizer_host_ms": {"per_tensor": launches[False][2],
                                           "flat": launches[True][2]},
                     "params_equal": not differ}
        log(f"{name} from the imported data, {INGEST_STEPS} steps at B={INGEST_B}: per-tensor "
            f"{runs[False]['ms']:.3f} ms/step, flat {runs[True]['ms']:.3f} ms/step (host clock, "
            f"steps 12-20); one optimizer step: {launches[False][0]} device ops "
            f"({launches[False][1]:.3f} ms busy, {launches[False][2]:.3f} ms host clock) "
            f"per-tensor, {launches[True][0]} ({launches[True][1]:.3f} ms, "
            f"{launches[True][2]:.3f} ms) flat; parameters bit for bit: {not differ} [{smi}]")
        if differ:
            raise AssertionError(f"{name}: flat and per-tensor parameters differ in {differ[:5]}")
    return out


def ravel_tree(tree) -> np.ndarray:
    """jax.flatten_util.ravel_pytree's vector of a flax tree: the leaves in
    sorted-key order, each in C order, float32."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            leaves.append(np.asarray(node, np.float32).reshape(-1))

    walk(tree)
    return np.concatenate(leaves)


def jax_masked_opt_state(mu, nu, count, trainable) -> dict:
    """optax.masked(adamw chain)'s state over ``trainable`` top-level modules,
    as flax's to_state_dict lays it out: the frozen modules' moments are
    empty maps (optax's MaskedNode)."""
    mask = lambda tree: {k: tree[k] if k in trainable else {} for k in sorted(tree)}
    return {"inner_state": jax_opt_state(mask(mu), mask(nu), count)}


def moments_state(opt, mu, nu, skeleton, count, device) -> dict:
    """The port optimizer's state by parameter holding flax-layout moments
    mapped straight from their trees (no unravel, no mask)."""
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_parameters

    moments = [flax_parameters(skeleton, m) for m in (mu, nu)]
    return {"state": {i: {"step": torch.tensor(float(count)),
                          "exp_avg": moments[0][name].to(device),
                          "exp_avg_sq": moments[1][name].to(device)}
                      for i, name in enumerate(opt.state_names)},
            "param_groups": opt.state_dict()["param_groups"]}


def flat_resume_phase(work: Path, device, smi) -> dict:
    """JAX-format checkpoints written from seeded trees (flax_msgpack, as
    phase 16): proprio_fused.yaml with flat_optimizer (one flat mu / nu in
    ravel_pytree's order) and a distillation student (optax.masked moments
    over distill.TRAINABLE). Gate: each resumed for FLAT_RESUME_STEPS steps
    gives, bit for bit, what the same start written in the port's format
    gives (`train.py -p` for the first, the distill step for the second)."""
    import yaml

    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.data.pipeline import to_tensors
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
    from soccerdiffusion_tpu_torch.training.distill import TRAINABLE, make_distill_step
    from soccerdiffusion_tpu_torch.training.train import RunOptions, build_dataset, train
    from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

    raw = yaml.safe_load((CONFIG_DIR / "proprio_fused.yaml").read_text())
    config = Config.from_dict({**raw, "log_every": 1, "epochs": 2, "flat_optimizer": True})
    cfg, tc, hp = config.model, config.train, config.to_dict()
    skeleton = DiffusionPolicy(cfg)
    params = flax_init_params(skeleton, 71)[0]
    mu, nu = ckpt_moments(skeleton, 72)
    norm = ckpt_norm(cfg.num_joints, 73)
    normalizer = Normalizer(mean=torch.from_numpy(norm[0]), std=torch.from_numpy(norm[1]))
    count, out = 5, {}

    # 1. flat_optimizer: the JAX package's one flat mu / nu
    dirs = {"jax": work / "flat_jax", "port": work / "flat_port"}
    write_jax_checkpoint(dirs["jax"], hp, params, norm, step=count, epoch=0,
                         opt_state=jax_opt_state(ravel_tree(mu), ravel_tree(nu), count))
    model = load_jax_params(DiffusionPolicy(cfg), params).to(device)
    opt = make_optimizer(model, tc.lr, 2 * FLAT_RESUME_STEPS, tc.weight_decay, flat=True)
    opt.load_state_dict(moments_state(opt, mu, nu, skeleton, count, device))
    state = create_train_state(model, opt)
    state.step = count
    save_checkpoint(dirs["port"], state, normalizer, hp, 0)
    del state, model, opt
    runs = {}
    for label, start in dirs.items():
        zero_counters()
        st = train(config, RunOptions(output=str(work / f"flat_resumed_{label}"),
                                      checkpoint=str(start), dummy_data=True, epochs=2,
                                      steps_per_epoch=FLAT_RESUME_STEPS, seed=0, device=device))
        if not st.optimizer.in_buffer() or st.step != count + FLAT_RESUME_STEPS:
            raise AssertionError(f"flat resume from the {label} format: step {st.step}, "
                                 f"in the buffer {st.optimizer.in_buffer()}")
        runs[label] = ({n: p.detach().clone() for n, p in st.model.named_parameters()},
                       read_counters())
        del st
    differ = [n for n, p in runs["jax"][0].items() if not torch.equal(p, runs["port"][0][n])]
    out["flat"] = {"params_equal": not differ,
                   "launches": {k: v for k, v in runs["jax"][1].items() if v}}
    log(f"flat_optimizer resume (proprio_fused.yaml, {FLAT_RESUME_STEPS} steps from step "
        f"{count}): the JAX format's flat mu / nu against the port's state.pt, parameters bit "
        f"for bit: {not differ}; launches {out['flat']['launches']} [{smi}]")
    if differ:
        raise AssertionError(f"flat resume: the JAX format's parameters differ in {differ[:5]}")

    # 2. distillation: optax.masked moments over TRAINABLE only
    dconfig = Config.from_dict({**raw, "log_every": 1})
    dhp = {**dconfig.to_dict(), "distilled_num_steps": 2}
    dirs = {"jax": work / "distill_jax", "port": work / "distill_port"}
    write_jax_checkpoint(dirs["jax"], dhp, params, norm, step=count, epoch=0,
                         opt_state=jax_masked_opt_state(mu, nu, count, TRAINABLE))
    student = load_jax_params(DiffusionPolicy(cfg), params).to(device)
    opt = make_optimizer(student, tc.lr, 10, tc.weight_decay, trainable=TRAINABLE)
    opt.load_state_dict(moments_state(opt, mu, nu, skeleton, count, device))
    st = create_train_state(student, opt)
    st.step = count
    save_checkpoint(dirs["port"], st, normalizer, dhp, 0)
    del st, student, opt
    teacher = load_jax_params(DiffusionPolicy(cfg), flax_init_params(skeleton, 74)[0])
    teacher = teacher.to(device).eval().requires_grad_(False)
    dataset = build_dataset(dconfig, 0, True)
    batches = [to_tensors(b) for b in itertools.islice(dataset.batches(INGEST_B, seed=0),
                                                       FLAT_RESUME_STEPS)]
    results = {}
    for label, start in dirs.items():
        student = DiffusionPolicy(cfg).to(device)
        opt = make_optimizer(student, tc.lr, 10, tc.weight_decay, trainable=TRAINABLE)
        st = create_train_state(student, opt)
        load_checkpoint(start, st)
        step = make_distill_step(student, make_schedule(tc.train_denoising_timesteps), opt,
                                 teacher_inference_steps=10, student_steps=2)
        gen = torch.Generator(device=device).manual_seed(5)
        zero_counters()
        losses = [step(st, teacher, {k: v.to(device) for k, v in b.items()}, gen)["loss"].item()
                  for b in batches]
        results[label] = (losses, {n: p.detach().clone() for n, p in student.named_parameters()},
                          read_counters())
        del st, student, opt
    differ = [n for n, p in results["jax"][1].items() if not torch.equal(p, results["port"][1][n])]
    out["distill"] = {"params_equal": not differ and results["jax"][0] == results["port"][0],
                      "losses": results["jax"][0],
                      "launches": {k: v for k, v in results["jax"][2].items() if v}}
    log(f"distillation resume (proprio_fused.yaml's student, optax.masked moments over "
        f"{TRAINABLE}, {FLAT_RESUME_STEPS} steps): losses {results['jax'][0]} vs "
        f"{results['port'][0]}, parameters bit for bit: {not differ}; launches "
        f"{out['distill']['launches']} [{smi}]")
    if not out["distill"]["params_equal"]:
        raise AssertionError(f"distillation resume: the JAX format differs ({differ[:5]})")
    return out


def ingest_phase(device, smi) -> dict:
    """Phase 18: the port's ingest/ on the card's host, training from what it
    wrote with the flat optimizer and without, the flat and distillation
    resumes, and the h128 checkpoint trained from the imported data served
    at B=1024 (rows 1-2, exact launches)."""
    from soccerdiffusion_tpu_torch.training.checkpoint import load_policy

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        out = {"cli": ingest_cli_phase(work, INGEST_SECONDS, smi)}
        out["training"] = ingest_training_phase(work, device, smi)
        torch.cuda.empty_cache()
        out["resumes"] = flat_resume_phase(work, device, smi)
        torch.cuda.empty_cache()
        model, norm, steps, _, _ = load_policy(work / "ckpt_h128_flat", device)
        out["served_ms"], served = served_period(
            "the h128 checkpoint trained flat from the imported data (fused=\"chunk\", fused "
            "encoder)", model, device, {"fused_encoder": 1, "fused_chunk": 1}, b=BENCH_B,
            normalizer=norm, num_inference_steps=steps, fused="chunk", fused_encoder=True)
        out["served_launches"] = {k: v for k, v in served.items() if v}
        del model
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"ingest phase: {out['phase_s']:.1f} s [{smi}]")
    return out


# ------------------------------------------------------- the camera ledger (phase 19)
# evaluation/ledger.py --fast --vision on the card: --fast's depths (a layer
# a stack, one ViT block, one decoder layer) and step counts at run F's
# widths and shapes (h128, 100-step contexts, 96 px frames in 36 patches of
# 16 px, the width-128 ViT with 4 heads of 32, 5 frames, B=64), bf16,
# through the three training kernels; a guided 2-draw 1-step student, a cfg5
# guidance row, posterior means of 2
LEDGER_SHAPES = ("hidden_dim=128", "action_context_length=100", "imu_context_length=100",
                 "joint_state_context_length=100", "image_resolution=96", "vit_patch_size=16",
                 "vit_width=128", "image_context_length=5", "batch_size=64",
                 "compute_dtype=bfloat16")
LEDGER_B, LEDGER_FRAMES = 64, 5
LEDGER_SMOKE_K = 2  # the student's teacher draws and the posterior means
# rows 4-6: the path's kernels (the report's samplers are the plain ones);
# the image-sequence stack (8 heads) at head_dim 16
LEDGER_KERNELS = ("fused_vit_block_fwd", "fused_vit_block_bwd", "fused_encoder_stack_fwd",
                  "fused_encoder_stack_bwd", "fused_encoder_stack_fwd_hd16",
                  "fused_encoder_stack_bwd_hd16", "fused_decoder_layer_fwd",
                  "fused_decoder_layer_bwd")
# the recorded run F ledger, whose top-level keys a ledger's JSON must hold
R5F_JSON = Path(__file__).resolve().parent / "docs" / "quality_ledger_vision_r5f.json"
# --quality-ledger --vision: run F's students distilled from the cfg5 teacher
# (docs/quality_ledger_vision_r5f2.md, r5f3.md) beside the ledger's own cfg7 ones
CFG5_GUIDANCE = "5.0@image"


def ledger_smoke_argv(device, tmp: Path) -> list[str]:
    from soccerdiffusion_tpu_torch.evaluation import ledger

    return (ledger.FUSED + [a for kv in LEDGER_SHAPES for a in ("--set", kv)]
            + ["--fast", "--vision", "--student-steps", "1", "--student-guidance", CFG5_GUIDANCE,
               "--student-teacher-draws", str(LEDGER_SMOKE_K), "--guidance-rows", CFG5_GUIDANCE,
               "--posterior-mean", str(LEDGER_SMOKE_K), "--out", str(tmp / "ledger"),
               "--workdir", str(tmp / "work"), "--device", device])


def ledger_kernel_checks(model, device) -> dict:
    """Rows 4-6 at the camera ledger's shapes on ``model``'s weights against
    their plain versions (every output, input gradient and weight gradient
    within TRAIN_TOL of scale), timed beside their torch.nn layers: the ViT
    block (block 0; T=36 tokens, W=128, 4 heads of 32, exact GELU) over a
    step's LEDGER_B x LEDGER_FRAMES = 320 frames, the action-history stack
    (T=100) and the image-sequence stack (T=5) at B=64, and decoder layer 0
    (T=10 over S=307 memory rows: the 306 context tokens and the step token)
    at B=64, each forward and backward."""
    from soccerdiffusion_tpu_torch.ops import fused_decoder_layer as fdl
    from soccerdiffusion_tpu_torch.ops import fused_encoder_stack as fes
    from soccerdiffusion_tpu_torch.ops import fused_vit_block as fvb

    cfg = model.config
    vit = model.image_sequence_encoder.image_encoder
    T, W, H = (cfg.image_resolution // cfg.vit_patch_size) ** 2, cfg.vit_width, vit.num_heads
    E, gelu, b = cfg.hidden_dim, cfg.vit_fused_gelu, LEDGER_B
    bf16 = lambda ts: [t.detach().to(torch.bfloat16) for t in ts]
    vit_w = bf16(fes.encoder_layer_weights(vit.blocks.layers[0]))
    seq_enc = model.image_sequence_encoder.seq.encoder
    stacks = {"": (bf16(fes.stack_weights(model.action_history_encoder.seq.encoder.layers)), 4,
                   cfg.action_context_length),
              "_imgseq": (bf16(fes.stack_weights(seq_enc.layers)), seq_enc.num_heads,
                          cfg.image_context_length)}
    layer = model.diffusion_action_generator.decoder.layers[0]
    dec_w, Hd, FF = bf16(fdl.layer_weights(layer)), layer.num_heads, layer.mlp.linear1.out_features
    S = (cfg.action_context_length + cfg.imu_context_length + cfg.joint_state_context_length
         + cfg.image_context_length + 2)
    rng = np.random.default_rng(1919)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device, torch.bfloat16)
    zero = lambda n: {"bqkv": slice(n, 2 * n)}
    results = {}
    n = b * LEDGER_FRAMES
    x, dy = t(n, T, W), t(n, T, W)
    vit_flops = n * enc_layer_flops(T, W, 4 * W)
    act = quick_gelu if gelu == "quick" else "gelu"
    vit_lib = torch_encoder([w[None] for w in vit_w], H, act)
    log(f"camera ledger: fused ViT block N={n} frames T={T} W={W} {H} heads ({gelu} GELU):")
    with torch.no_grad():
        results["fused_vit_block_fwd_ledger"] = compare(
            "fused_vit_block_fwd_ledger", lambda: fvb.forward_kernel(x, vit_w, H, gelu),
            lambda: fvb.forward_plain(x, vit_w, H, gelu), b, vit_flops, [x, vit_w],
            lambda: vit_lib(x))
    dx, grads = fvb.backward_kernel(x, dy, vit_w, H, gelu)
    dx_ref, grads_ref = fvb.backward_plain(x, dy, vit_w, H, gelu)
    err = max(err_line("dx", dx, dx_ref), grads_check(fes.STACK_WEIGHTS, grads, grads_ref, zero(W)))
    times = {"fused_vit_block_bwd_ledger": (
        err, lambda: fvb.backward_kernel(x, dy, vit_w, H, gelu),
        lambda: fvb.backward_plain(x, dy, vit_w, H, gelu), 3 * vit_flops,
        [x, dy, vit_w, dx, grads],
        LibraryGrad(encoder_grad_fn([w[None] for w in vit_w], H, x, dy, act, stacked=False),
                    fes.STACK_WEIGHTS, zero(W)))}
    for suffix, (w, heads, tt) in stacks.items():
        name, layers = f"fused_encoder_stack_%s_ledger{suffix}", w[0].shape[0]
        xs, dys = t(b, tt, E), t(b, tt, E)
        flops = b * layers * enc_layer_flops(tt, E, E)
        log(f"camera ledger: encoder stack{suffix} B={b} T={tt} L={layers} {heads} heads:")
        lib = torch_encoder(w, heads)
        with torch.no_grad():
            results[name % "fwd"] = compare(
                name % "fwd", lambda x=xs, w=w, h=heads: fes.forward_kernel(x, w, h)[0],
                lambda x=xs, w=w, h=heads: fes.forward_plain(x, w, h), b, flops, [xs, w],
                lambda x=xs, lib=lib: lib(x))
        _, acts = fes.forward_kernel(xs, w, heads)
        dxs, g = fes.backward_kernel(acts, dys, w, heads)
        dxs_ref, g_ref = fes.backward_plain(xs, dys, w, heads)
        err = max(err_line("dx", dxs, dxs_ref), grads_check(fes.STACK_WEIGHTS, g, g_ref, zero(E)))
        times[name % "bwd"] = (
            err, lambda a=acts, dy=dys, w=w, h=heads: fes.backward_kernel(a, dy, w, h),
            lambda x=xs, dy=dys, w=w, h=heads: fes.backward_plain(x, dy, w, h), 3 * flops,
            [acts, dys, w, dxs, g],
            LibraryGrad(encoder_grad_fn(w, heads, xs, dys), fes.STACK_WEIGHTS, zero(E)))
    xd, mem, dyd = t(b, 10, E), t(b, S, E), t(b, 10, E)
    dec_flops = b * (dec_layer_flops(10, S, E, FF) + 4 * S * E * E)  # + the memory's K/V
    dec_lib = torch_decoder_layer(dec_w, Hd)
    log(f"camera ledger: decoder layer B={b} T=10 S={S} E={E} {Hd} heads:")
    with torch.no_grad():
        results["fused_decoder_layer_fwd_ledger"] = compare(
            "fused_decoder_layer_fwd_ledger", lambda: fdl.forward_kernel(xd, mem, dec_w, Hd),
            lambda: fdl.forward_plain(xd, mem, dec_w, Hd), b, dec_flops, [xd, mem, dec_w],
            lambda: dec_lib(xd, mem))
    ddx, dmem, dgrads = fdl.backward_kernel(xd, mem, dyd, dec_w, Hd)
    ddx_ref, dmem_ref, dgrads_ref = fdl.backward_plain(xd, mem, dyd, dec_w, Hd)
    err = max(err_line("dx", ddx, ddx_ref), err_line("dmem", dmem, dmem_ref),
              grads_check(fdl.WEIGHT_NAMES, dgrads, dgrads_ref, dec_zero(E)))
    times["fused_decoder_layer_bwd_ledger"] = (
        err, lambda: fdl.backward_kernel(xd, mem, dyd, dec_w, Hd),
        lambda: fdl.backward_plain(xd, mem, dyd, dec_w, Hd), 3 * dec_flops,
        [xd, mem, dyd, dec_w, ddx, dmem, dgrads],
        LibraryGrad(decoder_grad_fn(dec_w, Hd, xd, mem, dyd), fdl.WEIGHT_NAMES, dec_zero(E)))
    time_checked(results, f"B={b}", times)
    return results


def check_ledger_json(result: dict, k: int) -> None:
    """A ledger's JSON: every top-level key of the run F ledger, every value
    finite, and the guidance and posterior-mean rows labelled as the JAX
    report labels them (``k`` draws; one cfg5 guidance row, one 1-step student)."""
    missing = sorted(set(json.loads(R5F_JSON.read_text())) - set(result))
    bad = [p for p, v in numbers(result) if not np.isfinite(v)]
    teacher = result["checkpoints"][0]["open_loop"]["sampler"]
    labels = ([r["sampler"] for r in result["guidance"]],
              [r["sampler"] for r in result["posterior_mean_boundary"]["rows"]])
    want = ([f"{teacher}+cfg5(image)"], [f"{teacher}xmean{k}", f"{teacher}+cfg5(image)xmean{k}",
                                         "distilled1", f"distilled1xmean{k}"])
    log(f"ledger JSON: {len(result)} keys, missing {missing}; not finite {bad[:5]}; samplers "
        f"{labels}")
    if missing or bad or labels != want:
        raise AssertionError(f"ledger JSON: missing keys {missing}, values not finite {bad[:5]}, "
                             f"samplers {labels} (want {want})")


def ledger_phase(device, smi) -> tuple[dict, dict, dict]:
    """Phase 19: evaluation/ledger.py's smoke run (ledger_smoke_argv: train,
    distill, report) with every launch counter zeroed just before and read
    just after: each of rows 4-6 forward and backward launched, no other
    kernel; the JSON checked (check_ledger_json); then the kernels at the
    run's shapes on its teacher's weights (ledger_kernel_checks). Returns
    (the kernels' results, the run's launches, the phase's record)."""
    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.evaluation import ledger
    from soccerdiffusion_tpu_torch.training.checkpoint import build_policy, load_policy_checkpoint

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        zero_counters()
        result = ledger.main(ledger_smoke_argv(device, tmp))
        launches = read_counters()
        wall = time.perf_counter() - t0
        params, state, *_ = load_policy_checkpoint(tmp / "work" / "teacher.ckpt")
    log(f"camera ledger (--fast at run F's widths): {wall:.1f} s [{smi}]; stages "
        f"{result['wall_s']}; launches {nonzero(launches)}")
    idle = [k for k in LEDGER_KERNELS if not launches[k]]
    other = {k: v for k, v in nonzero(launches).items() if k not in LEDGER_KERNELS}
    if idle or other or 3 * launches["fused_encoder_stack_fwd_hd16"] != (
            launches["fused_encoder_stack_fwd"] - launches["fused_encoder_stack_fwd_hd16"]):
        raise AssertionError(f"camera ledger launches: {idle} never launched, {other} launched "
                             "off the path, or not three proprioceptive stacks an image stack")
    check_ledger_json(result, LEDGER_SMOKE_K)
    model = build_policy(Config.from_dict(params).model, state, device)
    results = ledger_kernel_checks(model, device)
    record = {"wall_s": wall, "stages_s": result["wall_s"], "launches": nonzero(launches),
              "teacher_open_loop_mse": result["checkpoints"][0]["open_loop"]["mse"],
              "noise_floor_mse": result["noise_floor_mse"]}
    log(f"camera ledger phase: {time.perf_counter() - t0:.1f} s [{smi}]")
    return results, launches, record


def quality_ledger(device, smi, out_dir: Path, vision: bool, fused: bool) -> int:
    """evaluation/ledger.py on the card: its defaults (the h128 ledger), or
    with ``vision`` run F's camera recipe (ledger.RUN_F, and with ``fused``
    ledger.FUSED) followed by its 4- and 1-step students distilled from the
    same teacher under CFG5_GUIDANCE and reported beside it, without
    guidance rows. Every launch counter is zeroed before and read after
    each stage. Writes ``out_dir``/quality_ledger{,_cfg5}.{json,md} and the
    checkpoints under ``out_dir``/work (the cfg5 students under its cfg5/);
    returns 1 where ledger.ledger_faults (``vision``) or a value that is
    not finite says the ledger failed, else 0."""
    from soccerdiffusion_tpu_torch.evaluation import ledger
    from soccerdiffusion_tpu_torch.evaluation import report as report_mod

    work = out_dir / "work"
    argv = ((ledger.RUN_F + (ledger.FUSED if fused else []) if vision else [])
            + ["--out", str(out_dir / "quality_ledger"), "--workdir", str(work),
               "--device", device])
    log(f"quality ledger: evaluation/ledger.py {' '.join(argv)}")
    t0 = time.perf_counter()
    zero_counters()
    result = ledger.main(argv)
    record = {"wall_s": time.perf_counter() - t0, "stages_s": result["wall_s"],
              "launches": nonzero(read_counters())}
    log(f"quality ledger: {record['wall_s']:.1f} s ({smi}); stages {result['wall_s']}; "
        f"launches {record['launches']}")
    log((out_dir / "quality_ledger.md").read_text())
    faults = (ledger.ledger_faults(result) if vision else
              [f"{p} = {v}" for p, v in numbers(result) if not np.isfinite(v)])
    if vision:
        args = ledger.parse_args(argv)
        args.student_guidance, args.guidance_rows = CFG5_GUIDANCE, []
        config = ledger.ledger_config(args)
        (work / "cfg5").mkdir(exist_ok=True)
        cfg_path = work / "cfg5" / "config.yaml"
        shutil.copyfile(work / "config.yaml", cfg_path)
        zero_counters()
        seconds = ledger.distill_students(args, cfg_path, work / "teacher.ckpt",
                                          ledger.steps_per_epoch(config, args.seed))
        record["cfg5_distill"] = {"stages_s": {Path(k).stem: v for k, v in seconds.items()},
                                  "launches": nonzero(read_counters())}
        t0 = time.perf_counter()
        cfg5 = report_mod.main(ledger.report_argv(args, config, work / "teacher.ckpt", seconds,
                                                  str(out_dir / "quality_ledger_cfg5")))
        record["cfg5_report_s"] = time.perf_counter() - t0
        log(f"cfg5 students: {record['cfg5_distill']}; report {record['cfg5_report_s']:.1f} s")
        log((out_dir / "quality_ledger_cfg5.md").read_text())
        faults += [f"cfg5 report: {p} = {v}" for p, v in numbers(cfg5) if not np.isfinite(v)]
    log(json.dumps({"quality_ledger": record, "gpu": smi}))
    for fault in faults:
        log(f"quality ledger FAILED: {fault}")
    return 1 if faults else 0


# ------------------------------------------------------- phase 20
# The last modules of the JAX package: utils/profiling.py's MFU meter and
# trace through the training kernels, and the example zoo.

# two epochs of 10 steps (the dummy data holds 18 batches of 64 an epoch):
# 4 logging windows, each closed by one sync
MFU_B, MFU_STEPS, MFU_LOG_EVERY = 64, 20, 5
MFU_CONFIGS = {"proprio_fused": ("proprio_fused.yaml", H128_STEP_LAUNCHES),
               "vit_flagship": ("vit_flagship.yaml", FLAG_TRAIN_LAUNCHES)}
# the kernels a flagship training step must show by name in its trace
# (csrc/: sd::decoder_layer_{fwd,bwd}_kernel<D>, sd::encoder_stack_{fwd,bwd}_kernel,
# sd::vit_block_{fwd,bwd}_kernel<D, gelu>)
TRACED_KERNELS = ("decoder_layer_fwd_kernel", "decoder_layer_bwd_kernel",
                  "encoder_stack_fwd_kernel", "encoder_stack_bwd_kernel",
                  "vit_block_fwd_kernel", "vit_block_bwd_kernel")


class LogLines(logging.Handler):
    """Keeps the messages of the port's logger that hold ``needle``."""

    def __init__(self, needle: str):
        super().__init__()
        self.needle, self.lines = needle, []

    def emit(self, record):
        if self.needle in record.getMessage():
            self.lines.append(record.getMessage())


def mfu_run(name: str, tmp: Path, smi) -> tuple[dict, dict, object]:
    """``train`` on ``name``'s YAML at MFU_B, MFU_STEPS steps in two epochs
    with --device-data, the launch counters zeroed just before and read just
    after (exactly the YAML's per-step launches), the FLOPs the trainer
    logged equal to ``estimate_flops`` of the config with its fused knobs
    off, and every metrics line's mfu finite in (0, 1). Returns (record,
    launches, the final TrainState)."""
    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.training.train import RunOptions, train
    from soccerdiffusion_tpu_torch.utils import profiling

    yaml_name, per_step = MFU_CONFIGS[name]
    config = Config.from_yaml(str(CONFIG_DIR / yaml_name))
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=MFU_B, log_every=MFU_LOG_EVERY))
    metrics = tmp / f"metrics_{name}.jsonl"
    flops_log = LogLines("train step FLOPs")
    port_logger = logging.getLogger("soccerdiffusion_tpu_torch")
    level = port_logger.level
    port_logger.addHandler(flops_log)
    port_logger.setLevel(logging.INFO)
    t0 = time.perf_counter()
    try:
        torch.cuda.synchronize()
        zero_counters()
        state = train(config, RunOptions(output=str(tmp / f"ckpt_{name}"), dummy_data=True,
                                         device_data=True, epochs=2,
                                         steps_per_epoch=MFU_STEPS // 2, seed=0,
                                         metrics=str(metrics)))
        torch.cuda.synchronize()
        launches = read_counters()
    finally:
        port_logger.removeHandler(flops_log)
        port_logger.setLevel(level)
    wall = time.perf_counter() - t0
    want = {k: per_step.get(k, 0) * MFU_STEPS for k in launches}
    if state.step != MFU_STEPS or launches != want:
        raise AssertionError(f"{name}: {state.step} steps, launches {launches}, expected {want}")
    if len(flops_log.lines) != 1:
        raise AssertionError(f"{name}: the trainer logged the step's FLOPs {len(flops_log.lines)} "
                             f"times: {flops_log.lines}")
    logged = int(flops_log.lines[0].rsplit("(", 1)[1].rstrip(")"))
    unfused = dataclasses.replace(config.model, **profiling.UNFUSED)
    counted = profiling.estimate_flops(state.model, unfused, MFU_B)
    if logged != counted:
        raise AssertionError(f"{name}: the trainer logged {logged} FLOPs a step, estimate_flops "
                             f"of the unfused config counts {counted}")
    records = [json.loads(line) for line in open(metrics)]
    mfus = [r["mfu"] for r in records]
    if len(records) < 2 or not all(m is not None and np.isfinite(m) and 0 < m < 1 for m in mfus):
        raise AssertionError(f"{name}: metrics lines' mfu {mfus} (want >= 2 lines, each in (0, 1))")
    peak = profiling.device_peak_flops("cuda", config.model.compute_dtype)
    last_window = logged * records[-1]["steps_per_sec"] / peak
    log(f"phase 20 {name} (B={MFU_B}, bf16, --device-data, {MFU_STEPS} steps through rows 4-6): "
        f"{logged:.4e} FLOPs a step (the unfused layers), mfu over the run {mfus[-1]:.4f}, "
        f"last window {last_window:.4f} ({1e3 / records[-1]['steps_per_sec']:.3f} ms/step) "
        f"against {peak:.3g} FLOP/s; lines {[round(m, 4) for m in mfus]}; {wall:.1f} s [{smi}]")
    return ({"flops_per_step": logged, "mfu": mfus, "mfu_last_window": last_window,
             "ms_per_step_last_window": 1e3 / records[-1]["steps_per_sec"], "peak_flops": peak,
             "wall_s": wall, "launches": nonzero(launches)}, launches, state)


def traced_step_check(state, tmp: Path) -> dict:
    """One flagship training step under utils/profiling.py's ``trace``: the
    Chrome trace it writes must name the decoder-layer, encoder-stack and
    ViT-block kernels, forward and backward, among its CUDA events."""
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.inference.controller import (
        init_controller_state,
        make_controller_batch,
    )
    from soccerdiffusion_tpu_torch.training.trainer import make_train_step
    from soccerdiffusion_tpu_torch.utils import profiling

    cfg = state.model.config
    batch = make_controller_batch(cfg, init_controller_state(cfg, MFU_B, device="cuda"))
    batch["joint_command"] = torch.zeros((MFU_B, cfg.trajectory_prediction_length,
                                          cfg.num_joints), device="cuda")
    step = make_train_step(state.model, make_schedule(1000), state.optimizer,
                           Normalizer.identity(cfg.num_joints))
    generator = torch.Generator(device="cuda").manual_seed(0)
    with profiling.trace(tmp / "trace"):
        step(state, batch, generator)
    events = json.loads((tmp / "trace" / profiling.TRACE_FILE).read_text())["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    named = {k: [n for n in kernels if k in n] for k in TRACED_KERNELS}
    if not all(named.values()):
        raise AssertionError(f"the traced step names no {[k for k, v in named.items() if not v]} "
                             f"among its {len(kernels)} CUDA kernels: {kernels[:40]}")
    log(f"phase 20 trace: one flagship step, {len(events)} events, {len(kernels)} CUDA kernel "
        f"names; {named}")
    return {"events": len(events), "cuda_kernel_names": len(kernels), "kernels": named}


def mfu_phase(smi) -> tuple[dict, dict]:
    """Phase 20 (a) and (b): the trainer's MFU on proprio_fused.yaml and
    vit_flagship.yaml through rows 4-6 (mfu_run), then one traced flagship
    step (traced_step_check). Returns (the record, the launches by config)."""
    record, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name in MFU_CONFIGS:
            record[name], launches[name], state = mfu_run(name, tmp, smi)
        record["trace"] = traced_step_check(state, tmp)
    del state
    torch.cuda.empty_cache()
    return record, launches


def run_example(name: str, *argv) -> tuple[int | None, str, str]:
    """``soccerdiffusion_tpu_torch.examples.<name>.main([*argv, "--device",
    "cuda"])`` in this process: (its return code, or None where it raised
    ImportError; what it printed; the ImportError's message or "")."""
    import contextlib
    import importlib
    import io

    main_fn = importlib.import_module(f"soccerdiffusion_tpu_torch.examples.{name}").main
    out, error, rc = io.StringIO(), "", None
    with contextlib.redirect_stdout(out):
        try:
            rc = main_fn([*argv, "--device", "cuda"])
        except ImportError as exc:
            error = str(exc)
    return rc, out.getvalue(), error


def examples_phase(smi) -> dict:
    """Phase 20 (c): every ported example's main() on the card at its default
    arguments (fetch_data on the fixture bag, its CSV feeding
    preliminary_context_robot --csv, as tests/test_examples.py does) with
    the launch counters zeroed just before and read just after: each prints
    its PASS line, and none reaches a kernel of the port (their tiny
    configs set no fused knob, as the JAX scripts run without Pallas).
    Where a module an example needs is missing, the example must fail
    naming it: matplotlib for the two plotting examples, after their data
    work (preliminary_context_robot: after the open-loop MSE), zstandard for
    the fixture bag's zstd chunks; fetch_data then reads a bag of the same
    topics that the port's writer writes without compression
    (write_ingest_bag, 6 s)."""
    import importlib.util

    have = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "zstandard")}
    fixture = Path(__file__).resolve().parent / "tests" / "fixtures" / "bitbots_synth.mcap"
    record = {"modules": have}
    saved_tempdir = tempfile.tempdir
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tempfile.tempdir = str(tmp)  # the examples' throwaway databases and checkpoint
        bag = fixture
        if not have["zstandard"]:
            bag = tmp / "legs.mcap"
            record["uncompressed_bag"] = write_ingest_bag(bag, 6)
        fetch = ("fetch_data", (str(bag), "-o", str(tmp / "legs.csv")),
                 "wrote 600 rows x 12 joints", None)
        cases = [
            ("sine_diffusion_toy", (), "SINE TOY PASSED", None),
            ("ar_bin_baseline", (), "AR BIN BASELINE PASSED", None),
            ("mlp_denoiser_multijoint", (), "MLP MULTI-JOINT PASSED", None),
            *([] if bag == fixture else [("fetch_data", (str(fixture), "-o", str(tmp / "x.csv")),
                                          "", "zstandard")]),
            fetch,
            ("preliminary_context_robot", ("--out", str(tmp / "prelim_db.png")),
             f"wrote {tmp / 'prelim_db.png'}", "matplotlib"),
            ("preliminary_context_robot", ("--csv", str(tmp / "legs.csv"),
                                           "--out", str(tmp / "prelim_csv.png")),
             f"wrote {tmp / 'prelim_csv.png'}", "matplotlib"),
            ("e2e_smoke", (), "E2E SMOKE PASSED", None),
            ("realtime_demo", (), "REALTIME DEMO PASSED", None),
            ("realtime_demo", ("--udp",), "REALTIME UDP DEMO PASSED", None),
            ("visualize_dataset", ("--dummy", "-o", str(tmp / "viz")),
             f"wrote plots to {tmp / 'viz'}/", "matplotlib"),
        ]
        try:
            for name, argv, line, needs in cases:
                label = " ".join([name, *(Path(a).name if "/" in a else a for a in argv)])
                t0 = time.perf_counter()
                torch.cuda.synchronize()
                zero_counters()
                rc, out, error = run_example(name, *argv)
                launches = nonzero(read_counters())
                seconds = time.perf_counter() - t0
                if needs and not have[needs]:
                    ok = (rc is None and needs in error
                          and (name != "preliminary_context_robot" or "open-loop MSE" in out))
                    verdict = f"ImportError naming {needs}: {error!r}"
                else:
                    ok = rc == 0 and line in out
                    verdict = line
                tail = out.strip().splitlines()[-3:]
                log(f"phase 20 example {label}: {seconds:.1f} s, rc {rc}, {verdict if ok else '?'}; "
                    f"launches {launches}; {tail}")
                if not ok or launches:
                    raise AssertionError(f"example {label}: rc {rc}, error {error!r}, launches "
                                         f"{launches}, output:\n{out[-3000:]}")
                record[label] = {"s": seconds, "last_lines": tail,
                                 **({"import_error": error} if error else {})}
        finally:
            tempfile.tempdir = saved_tempdir
    log(f"phase 20 examples: {sum(r['s'] for r in record.values() if 's' in r):.1f} s [{smi}]")
    return record


def sass_phase() -> dict:
    """cuobjdump -sass of the built kernel library: every instance of each
    TENSOR_CORE_KERNELS kernel (bf16 only where it says so) must hold
    tensor-core instructions; the fp32 flash instances, which stay scalar,
    are logged. Returns per kernel its instances and the fewest HMMA / HGMMA
    instructions of one."""
    from soccerdiffusion_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise AssertionError("cuobjdump not found: the tensor-core check needs the CUDA toolkit's")
    lib = _build.build_dir() / "libsd_kernels.so"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        counts[chunk.split(None, 1)[0]] = len(re.findall(r"\bHG?MMA\b", chunk))
    found = {}
    for kernel, only in TENSOR_CORE_KERNELS:
        n = [c for fn, c in counts.items() if kernel in fn and only in fn]
        label = f"{kernel} ({only} instances)" if only else kernel
        log(f"SASS {label}: {len(n)} instance(s), HMMA/HGMMA instructions {n}")
        if not n or min(n) == 0:
            raise AssertionError(f"{label}: an instance without tensor-core instructions "
                                 f"(HMMA/HGMMA counts {n})")
        found[label] = {"instances": len(n), "min_mma_instructions": min(n)}
    for kernel in IMMA_KERNELS:
        n = [len(re.findall(r"\bIMMA\b", chunk)) for chunk in sass.split("Function : ")[1:]
             if kernel in chunk.split(None, 1)[0]]
        log(f"SASS {kernel}: {len(n)} instance(s), IMMA instructions {n}")
        if not n or min(n) == 0:
            raise AssertionError(f"{kernel}: an instance without int8 tensor-core instructions "
                                 f"(IMMA counts {n})")
        found[f"{kernel} (IMMA)"] = {"instances": len(n), "min_mma_instructions": min(n)}
    for kernel, want in VIT_INSTANCES.items():
        if found[kernel]["instances"] != want:
            raise AssertionError(f"{kernel}: {found[kernel]['instances']} instances, expected "
                                 f"{want} (head_dim 32 / 64 x four GELUs)")
    for kernel in SCALAR_KERNELS:
        n = {fn: c for fn, c in counts.items() if kernel in fn and "__nv_bfloat16" not in fn}
        log(f"SASS {kernel} (float instances, scalar fp32): {len(n)} instance(s), HMMA/HGMMA "
            f"instructions {sorted(n.values())}")
    return found


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def trace(label, run, steps, out):
    """One torch.profiler trace of ``steps`` calls of ``run``: per call the
    host wall clock, the device busy time (union of the device ops'
    intervals) and idle share, both from this trace, and the largest device
    ops; the full table goes to ``out``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the trace holds no device ops: torch.profiler saw no device time")
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3 / steps
    per_name: dict[str, list] = {}
    for e in dev:
        tot = per_name.setdefault(e.name, [0.0, 0])
        tot[0] += (e.time_range.end - e.time_range.start) / 1e3 / steps
        tot[1] += 1
    launch_ms = sum(e.self_cpu_time_total for e in prof.key_averages()
                    if e.key.startswith(("cudaLaunch", "cuLaunch"))) / 1e3 / steps
    log(f"=== {label}, {steps} under torch.profiler: wall {wall_ms:.3f} ms each, device busy "
        f"{busy_ms:.3f} ms ({len(dev) / steps:.0f} device ops each), device idle share "
        f"{1 - busy_ms / wall_ms:.3f}, host in kernel-launch calls {launch_ms:.3f} ms each")
    for op, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:8.3f} ms each {n / steps:6.1f} each  {op[:110]}")
    if out:
        with open(out, "a") as f:
            f.write(f"=== {label}\n")
            f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
            f.write("\n")


def profile_serving(device, out, periods=3, flash=False, resnet=False, larger=False):
    """A trace of ``periods`` replan periods of each flagship lane at
    B=FLAG_B, or (``flash``) of the flash flagship's cached ddim30 lane, or
    (``resnet``) of each default_tpu.yaml lane at RESNET_B, or (``larger``)
    of each larger_model.yaml lane at LARGER_B."""
    if larger:
        model = larger_model(device)
        lanes = {lane: kw for lane, (kw, _) in LARGER_LANES.items()}
    elif resnet:
        model = build_model(yaml_config("default_tpu.yaml").model, device, seed=4)
        lanes = {lane: kw for lane, (kw, _) in RESNET_LANES.items()}
    elif flash:
        model = build_model(flash_flagship_config(), device, seed=3)
        lanes = {"ddim30 flash (fused=False)": dict(fused=False)}
    else:
        model = build_model(flagship_config(), device, seed=3)
        lanes = {lane: kw for lane, (kw, _) in FLAG_LANES.items()}
    for lane, kw in lanes.items():
        b = LARGER_B if larger else RESNET_B if resnet else FLAG_B
        eng = engine(model, model.config, device, fused_encoder=False, **kw)
        carry = [eng.init(b, torch.Generator(device=device).manual_seed(0))]

        def period():
            carry[0] = eng.replan_period(carry[0])[0]

        period()  # warm-up
        name = "larger_model" if larger else "ResNet" if resnet else "flagship"
        trace(f"{name} lane {lane}, B={b}, replan periods", period, periods, out)


def profile_realtime(device, out, plans=3):
    """A trace of ``plans`` replans of `cli serve`'s sampler at B=1 on the
    flagship (seeded random weights; make_chunk_sampler on the controller's
    raw-frame batch): the 30-step DDIM teacher, then the distilled student."""
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.inference import make_chunk_sampler
    from soccerdiffusion_tpu_torch.inference.controller import (
        init_controller_state,
        make_controller_batch,
    )

    model = build_model(flagship_config(), device, seed=3)
    cfg = model.config
    batch = make_controller_batch(cfg, init_controller_state(cfg, 1, device=device))
    noise = torch.randn((1, cfg.trajectory_prediction_length, cfg.num_joints), device=device)
    for label, distilled in (("teacher ddim30", False), ("student distilled1", True)):
        sampler = make_chunk_sampler(model, make_schedule(1000),
                                     Normalizer.identity(cfg.num_joints), 30, distilled)
        sampler(batch, noise)  # warm-up
        trace(f"flagship cli-serve plan ({label}), B=1", lambda: sampler(batch, noise), plans,
              out)


def profile_training(config, label, out, packed=False, steps=5, warm=5):
    """One torch.profiler trace of ``steps`` steps of training/train.py's step
    (its dataset and data path for ``config``) after ``warm`` steps outside
    it. Wall and device busy time both come from this trace."""
    from soccerdiffusion_tpu_torch.data import Normalizer
    from soccerdiffusion_tpu_torch.data.pipeline import prefetch_to_device
    from soccerdiffusion_tpu_torch.diffusion import make_schedule
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.training.train import build_dataset
    from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer, make_train_step
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_init_params, load_jax_params

    tc, device = config.train, torch.device("cuda")
    dataset = build_dataset(config, 0, True, packed)
    normalizer = Normalizer.fit(dataset.sample_targets(tc.num_normalization_samples, seed=0))
    model = DiffusionPolicy(config.model)
    model = load_jax_params(model, *flax_init_params(model, 0)).to(device)
    opt = make_optimizer(model, tc.lr, warm + steps, tc.weight_decay, grad_clip_norm=tc.grad_clip_norm)
    state = create_train_state(model, opt, ema=tc.ema_decay > 0.0)
    step = make_train_step(model, make_schedule(tc.train_denoising_timesteps), opt, normalizer,
                           ema_decay=tc.ema_decay)
    generator = torch.Generator(device=device).manual_seed(0)
    batches = prefetch_to_device(dataset.batches(tc.batch_size, shuffle=True, seed=0), device)
    try:
        for _ in range(warm):
            step(state, next(batches), generator)
        trace(f"training step {label}, B={tc.batch_size}, steps",
              lambda: step(state, next(batches), generator), steps, out)
    finally:
        batches.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile-training", action="store_true",
                        help="trace the training step with torch.profiler instead of the smoke run")
    parser.add_argument("--flagship", action="store_true",
                        help="with --profile-training: trace the flagship's training step instead")
    parser.add_argument("--flash", action="store_true",
                        help="with --profile-training --flagship or --profile-serving: the "
                             "flash flagship (every attention through the flash kernel)")
    parser.add_argument("--profile-serving", action="store_true",
                        help="trace the flagship's serving lanes with torch.profiler instead")
    parser.add_argument("--resnet", action="store_true",
                        help="with --profile-training or --profile-serving: default_tpu.yaml's "
                             "ResNet18 model (training step at B=64, serving lanes at B=64)")
    parser.add_argument("--larger", action="store_true",
                        help="with --profile-serving: larger_model.yaml's serving lanes at B=64")
    parser.add_argument("--bisect-resnet-bf16", action="store_true",
                        help="instead of the smoke run: default_tpu.yaml's bf16 training steps "
                             "card vs CPU on noise and on dummy frames (measured, not gated), "
                             "then its ResNet18's pieces in bf16, card and CPU each against "
                             "float64")
    parser.add_argument("--profile-realtime", action="store_true",
                        help="trace the flagship's cli-serve plans at B=1 (ddim30, distilled1) "
                             "with torch.profiler instead")
    parser.add_argument("--profile-out", default=None, help="file for the full profiler tables")
    parser.add_argument("--quality-ledger", action="store_true",
                        help="instead of the smoke run: evaluation/ledger.py on the card, the "
                             "h128 ledger (train 2000 steps, distill 4- and 1-step students 400 "
                             "steps each, report)")
    parser.add_argument("--vision", action="store_true",
                        help="with --quality-ledger: run F's camera recipe (ledger.RUN_F, bf16), "
                             "then its students of the cfg5 teacher")
    parser.add_argument("--fused", action="store_true",
                        help="with --quality-ledger --vision: through the fused ViT-block, "
                             "encoder-stack and decoder-layer kernels (ledger.FUSED)")
    parser.add_argument("--ledger-out", default="build/quality_ledger",
                        help="directory for the ledger's quality_ledger.{json,md}")
    parser.add_argument("--nccl", action="store_true",
                        help="instead of the smoke run: phase 15's parallel paths (data-parallel "
                             "steps, the synchronised BatchNorm, the fleet, ring, TP, dcn x data) "
                             "over NCCL, one rank a card, on 2 ranks and on every card, each "
                             "against one process (needs two cards or more)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from soccerdiffusion_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full fp32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s ({_build.build_dir()})")
    build_log = _build.build_dir() / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(line.strip(), file=sys.stderr)

    if args.profile_realtime:
        profile_realtime(device, args.profile_out)
        return 0
    if args.nccl:
        log(json.dumps({"nccl": nccl_phase(device, smi), "gpu": smi}))
        return 0
    if args.quality_ledger:
        return quality_ledger(device, smi, Path(args.ledger_out), args.vision, args.fused)
    if args.bisect_resnet_bf16:
        config = yaml_config("default_tpu.yaml")  # bf16, "conv_only"
        step = {frames: training_reference_phase(device, config.model, batches, 14, gate=False)
                for frames, batches in (("noise", noise_frame_batches(config)),
                                        ("dummy", reference_batches(config)))}
        log(json.dumps({"bf16_steps_card_vs_cpu": step, "pieces": bisect_resnet_bf16(device)}))
        return 0
    if args.profile_training or args.profile_serving:
        if args.profile_training and args.resnet:
            profile_training(yaml_config("default_tpu.yaml", batch_size=RESNET_TRAIN_B),
                             "ResNet (default_tpu.yaml, packed whole-frame uint8 dummy data)",
                             args.profile_out, packed=True)
        elif args.profile_training and args.flagship and args.flash:
            profile_training(flash_train_config(FLAG_TRAIN_B), "flash flagship (vit_flagship.yaml, "
                             "attention_impl=pallas, fused knobs off, packed dummy data)",
                             args.profile_out, packed=True)
        elif args.profile_training and args.flagship:
            profile_training(flagship_train_config(FLAG_TRAIN_B), "flagship (vit_flagship.yaml, "
                             "packed dummy data)", args.profile_out, packed=True)
        elif args.profile_training:
            for fused in (True, False):
                profile_training(train_config(fused), "fused" if fused else "unfused",
                                 args.profile_out)
        if args.profile_serving:
            profile_serving(device, args.profile_out, flash=args.flash, resnet=args.resnet,
                            larger=args.larger)
        return 0
    tensor_cores = sass_phase()
    smem_cases = smem_mirror_phase()
    cfg = bench_config()
    model = build_model(cfg, device)
    results = kernel_phase(cfg, model, device)
    launches, periods = main_path_phase(cfg, model, device)
    reference_phase(cfg, model, device)
    train_model = build_model(train_config(True).model, device, seed=2)
    results.update(training_kernel_phase(cfg, train_model, device))
    train_launches, step_ms, h128_flash = training_path_phase()
    training_reference_phase(device, train_config(True).model, h128_reference_batches(), 11)
    del model, train_model
    torch.cuda.empty_cache()

    flagship = build_model(flagship_config(), device, seed=3)
    results.update(flagship_kernel_phase(flagship, device))
    flag_launches, flag_periods = flagship_path_phase(flagship, device)
    reference_phase(flagship.config, flagship, device, b=4, fused="chunk", fused_encoder=False)
    results.update(flagship_training_kernel_phase(flagship, device))
    del flagship
    torch.cuda.empty_cache()
    flag_train_launches, flag_train_ms, flag_train_peak = flagship_training_path_phase()
    training_reference_phase(device, flagship_config(), flagship_reference_batches(), 12)

    flash_results, flash_shapes = flash_kernel_phase(device)
    results.update(flash_results)
    flash = build_model(flash_flagship_config(), device, seed=3)
    flash_serve, flash_period_ms = flash_serving_phase(flash, device)
    del flash
    torch.cuda.empty_cache()
    flash_train, flash_train_ms = flash_training_path_phase()
    training_reference_phase(device, flash_flagship_config(), flagship_reference_batches(), 13)

    # the ResNet / Swin slice: default_tpu.yaml's model, then the decoder-only tier
    resnet = build_model(yaml_config("default_tpu.yaml").model, device, seed=4)
    resnet_encoder = image_encoder_phase(resnet, device)
    results.update(resnet_kernel_phase(resnet, device))
    resnet_launches, resnet_periods = lanes_phase(resnet, device, RESNET_LANES, RESNET_B, "ResNet")
    reference_phase(resnet.config, resnet, device, b=4, fused="chunk", fused_encoder=False)
    del resnet
    torch.cuda.empty_cache()
    resnet_train = resnet_training_phase()
    # in float32 (TF32 off): no kernel of the port runs on this step, and in bf16
    # cuDNN's and the CPU's roundings break the ResNet's ReLU / max-pool ties
    # differently, which AdamW turns into +-lr steps of the entries whose
    # gradient is rounding noise (update norm 0.23 in bf16, PERF.md)
    training_reference_phase(device, dataclasses.replace(
        yaml_config("default_tpu.yaml").model, compute_dtype="float32"),
        reference_batches(yaml_config("default_tpu.yaml")), 14)
    other_encoders = encoders_reference_phase(device)
    # larger_model.yaml: the decoder kernels' head_dim-128 instances
    larger_results, larger_launches, larger_periods = larger_model_phase(device)
    results.update(larger_results)
    torch.cuda.empty_cache()
    s0_results, s0_launches, s0_periods, s0_train_ms = decoder_only_phase(device)
    results.update(s0_results)
    torch.cuda.empty_cache()
    # distillation and guidance: larger_model_distill.yaml, then the flagship
    distill_larger = distill_larger_phase(device)
    torch.cuda.empty_cache()
    distill_flagship = distill_flagship_phase(device)
    torch.cuda.empty_cache()
    # the recorded-data path: SQLite, the resize, packed shards, device-resident data
    recorded = recorded_data_phase(device, smi)
    # evaluation/ and the CLI: vit_flagship.yaml through train, distill, report, serve, plot
    evaluation = evaluation_phase(device, smi)
    results.update(evaluation["kernels_on_path"].pop("kernels"))
    # parallel/: two ranks on the card over gloo, each path against one process
    parallel = parallel_phase(device, smi)
    # checkpoints the port did not write: the JAX package's and the reference's
    checkpoints = checkpoint_phase(device, smi, periods["ddim30"])
    # the kernel variants: int8 K/V, qstat, groups, the poly / bf16 GELUs, encoder_fused_block
    variant_results, variant_launches, variants = variants_phase(device)
    results.update(variant_results)
    # recorded data through the port's ingest/, trained with the flat optimizer
    ingest = ingest_phase(device, smi)
    # the camera ledger: train, distill and report through rows 4-6
    ledger_results, ledger_launches, ledger = ledger_phase(device, smi)
    results.update(ledger_results)
    # the last modules of the JAX package: the trainer's MFU through rows 4-6,
    # the trace, the example zoo
    mfu, mfu_launches = mfu_phase(smi)
    examples = examples_phase(smi)
    h128_mfu, flag_mfu = mfu_launches["proprio_fused"], mfu_launches["vit_flagship"]

    # where each kernel instance ran: (source, the TPU kernel it replaces (the
    # pack: the JAX denoiser's pack_context_kv, whose layout the kernel's
    # K/V stream needs), its launches over the main paths that run it at the
    # checked shapes)
    csrc, tpu = "soccerdiffusion_tpu_torch/csrc/", "soccerdiffusion_tpu/ops/"
    flag = lambda name, lanes=tuple(FLAG_LANES): sum(flag_launches[lane][name] for lane in lanes)
    hd32_stack = flag("fused_encoder_stack_fwd") - flag("fused_encoder_stack_fwd_hd64")
    # phase 14: `cli serve`'s three runs (B=1) and `cli report` (batches of EVAL_BATCH)
    served = lambda name: sum(run["launches"].get(name, 0) for run in evaluation["serve"].values())
    reported = lambda name: evaluation["report"]["launches"].get(name, 0)
    eval_rows = {}
    for path, count in (("serve", served), ("report", reported)):
        eval_rows.update({
            f"fused_vit_block_fwd_{path}": ("vit_block.cuh", "fused_vit_block.py:703",
                                            count("fused_vit_block_fwd")),
            f"fused_encoder_stack_fwd_hd64_{path}": ("fused_encoder_stack.cu",
                                                     "fused_encoder_stack.py:274",
                                                     count("fused_encoder_stack_fwd_hd64")),
            f"fused_encoder_stack_fwd_imgseq_{path}": (
                "fused_encoder_stack.cu", "fused_encoder_stack.py:274",
                count("fused_encoder_stack_fwd") - count("fused_encoder_stack_fwd_hd64")),
            f"fused_decoder_layer_fwd_hd64_{path}": ("fused_decoder_layer.cu",
                                                     "fused_decoder_layer.py:343",
                                                     count("fused_decoder_layer_fwd_hd64"))})
    table = {
        "fused_encoder": ("fused_encoder.cu", "fused_encoder.py:319", launches["fused_encoder"]),
        "fused_chunk": ("fused_chunk.cu", "fused_chunk.py:518", launches["fused_chunk"]),
        "fused_denoise": ("fused_denoise.cu", "fused_denoise.py:382", launches["fused_denoise"]),
        "fused_denoise_pack": ("fused_denoise.cu", "fused_denoise.py:310",
                               launches["fused_denoise_pack"]),
        # the h128 training path: phase 6 and phase 20's proprio_fused.yaml
        **{name: ("fused_encoder_stack.cu" if "stack" in name else "fused_decoder_layer.cu", line,
                  train_launches[name] + h128_mfu[name])
           for name, line in (("fused_encoder_stack_fwd", "fused_encoder_stack.py:274"),
                              ("fused_encoder_stack_bwd", "fused_encoder_stack.py:300"),
                              ("fused_decoder_layer_fwd", "fused_decoder_layer.py:343"),
                              ("fused_decoder_layer_bwd", "fused_decoder_layer.py:371"))},
        "fused_vit_block_fwd": ("vit_block.cuh", "fused_vit_block.py:703",
                                flag("fused_vit_block_fwd", ("ddim30", "distilled1"))),
        # 640 frames a launch: the raw-frame lane and phase 20's B=64 flagship steps
        "fused_vit_block_fwd_raw_frames": ("vit_block.cuh", "fused_vit_block.py:703",
                                           flag("fused_vit_block_fwd", ("ddim30_raw_frames",))
                                           + flag_mfu["fused_vit_block_fwd"]),
        "fused_chunk_hd64": ("fused_chunk.cu", "fused_chunk.py:518", flag("fused_chunk")),
        "fused_denoise_hd64": ("fused_denoise.cu", "fused_denoise.py:382", flag("fused_denoise")),
        "fused_denoise_pack_hd64": ("fused_denoise.cu", "fused_denoise.py:310",
                                    flag("fused_denoise_pack")),
        "fused_encoder_stack_fwd_hd64": ("fused_encoder_stack.cu", "fused_encoder_stack.py:274",
                                         flag("fused_encoder_stack_fwd_hd64")
                                         + flag_mfu["fused_encoder_stack_fwd_hd64"]),
        "fused_encoder_stack_fwd_imgseq": ("fused_encoder_stack.cu", "fused_encoder_stack.py:274",
                                           hd32_stack + flag_mfu["fused_encoder_stack_fwd"]
                                           - flag_mfu["fused_encoder_stack_fwd_hd64"]),
        # the flagship's training path: phase 8 and phase 20's vit_flagship.yaml
        "fused_vit_block_bwd": ("vit_block.cuh", "fused_vit_block.py:722",
                                flag_train_launches["fused_vit_block_bwd"]
                                + flag_mfu["fused_vit_block_bwd"]),
        "fused_encoder_stack_bwd_hd64": ("fused_encoder_stack.cu", "fused_encoder_stack.py:300",
                                         flag_train_launches["fused_encoder_stack_bwd_hd64"]
                                         + flag_mfu["fused_encoder_stack_bwd_hd64"]),
        "fused_encoder_stack_bwd_imgseq": ("fused_encoder_stack.cu", "fused_encoder_stack.py:300",
                                           flag_train_launches["fused_encoder_stack_bwd"]
                                           - flag_train_launches["fused_encoder_stack_bwd_hd64"]
                                           + flag_mfu["fused_encoder_stack_bwd"]
                                           - flag_mfu["fused_encoder_stack_bwd_hd64"]),
        "fused_decoder_layer_fwd_hd64": ("fused_decoder_layer.cu", "fused_decoder_layer.py:343",
                                         flag_train_launches["fused_decoder_layer_fwd_hd64"]
                                         + flag_mfu["fused_decoder_layer_fwd_hd64"]),
        "fused_decoder_layer_bwd_hd64": ("fused_decoder_layer.cu", "fused_decoder_layer.py:371",
                                         flag_train_launches["fused_decoder_layer_bwd_hd64"]
                                         + flag_mfu["fused_decoder_layer_bwd_hd64"]),
        # the flash paths: flagship serving and training, the h128 unfused step
        "flash_attention_fwd": ("flash_attention.cu", "flash_attention.py:228",
                                sum(p["flash_attention_fwd"] for p in (flash_serve, flash_train,
                                                                       h128_flash))),
        "flash_attention_bwd": ("flash_attention.cu", "flash_attention.py:284",
                                sum(p["flash_attention_bwd"] for p in (flash_serve, flash_train,
                                                                       h128_flash))),
        # the ResNet lanes (default_tpu.yaml): the decoder kernels at hd32, S=311
        "fused_chunk_resnet": ("fused_chunk.cu", "fused_chunk.py:518",
                               sum(n["fused_chunk"] for n in resnet_launches.values())),
        "fused_denoise_resnet": ("fused_denoise.cu", "fused_denoise.py:382",
                                 sum(n["fused_denoise"] for n in resnet_launches.values())),
        "fused_denoise_pack_resnet": ("fused_denoise.cu", "fused_denoise.py:310",
                                      sum(n["fused_denoise_pack"]
                                          for n in resnet_launches.values())),
        # larger_model.yaml's lanes: the decoder kernels at head_dim 128, S=311
        "fused_chunk_hd128": ("fused_chunk.cu", "fused_chunk.py:518",
                              sum(n["fused_chunk"] for n in larger_launches.values())),
        "fused_denoise_hd128": ("fused_denoise.cu", "fused_denoise.py:382",
                                sum(n["fused_denoise"] for n in larger_launches.values())),
        "fused_denoise_pack_hd128": ("fused_denoise.cu", "fused_denoise.py:310",
                                     sum(n["fused_denoise_pack"]
                                         for n in larger_launches.values())),
        # the decoder-only tier's lanes: the decoder kernels at S=0 context tokens
        "fused_chunk_s0": ("fused_chunk.cu", "fused_chunk.py:518",
                           sum(n["fused_chunk"] for n in s0_launches.values())),
        "fused_denoise_s0": ("fused_denoise.cu", "fused_denoise.py:382",
                             sum(n["fused_denoise"] for n in s0_launches.values())),
        "fused_denoise_pack_s0": ("fused_denoise.cu", "fused_denoise.py:310",
                                  sum(n["fused_denoise_pack"] for n in s0_launches.values())),
        **eval_rows,
        # phase 17: the JAX kernels' other forms
        "fused_chunk_int8": ("fused_chunk_int8.cu", "fused_chunk.py:518",
                             variant_launches["fused_chunk_int8"]),
        "fused_chunk_int8_hd64": ("fused_chunk_int8.cu", "fused_chunk.py:518",
                                  variant_launches["fused_chunk_int8_hd64"]),
        "fused_chunk_int8_hd128": ("fused_chunk_int8.cu", "fused_chunk.py:518",
                                   variant_launches["fused_chunk_int8_hd128"]),
        "fused_chunk_qstat": ("fused_chunk.cu", "fused_chunk.py:518",
                              variant_launches["fused_chunk_qstat"]),
        **{name: ("vit_block.cuh",
                  "fused_vit_block.py:703" if "_fwd_" in name else "fused_vit_block.py:722",
                  variant_launches[name])
           for name in variant_launches if name.startswith("fused_vit_block")},
        # phase 19: the camera ledger (the proprioceptive stacks at head_dim 32,
        # the image-sequence stack at 16)
        "fused_vit_block_fwd_ledger": ("vit_block.cuh", "fused_vit_block.py:703",
                                       ledger_launches["fused_vit_block_fwd"]),
        "fused_vit_block_bwd_ledger": ("vit_block.cuh", "fused_vit_block.py:722",
                                       ledger_launches["fused_vit_block_bwd"]),
        **{f"fused_encoder_stack_{way}_ledger{suffix}": (
            "fused_encoder_stack.cu", f"fused_encoder_stack.py:{line}",
            ledger_launches[f"fused_encoder_stack_{way}_hd16"] if suffix else
            ledger_launches[f"fused_encoder_stack_{way}"]
            - ledger_launches[f"fused_encoder_stack_{way}_hd16"])
           for way, line in (("fwd", 274), ("bwd", 300)) for suffix in ("", "_imgseq")},
        "fused_decoder_layer_fwd_ledger": ("fused_decoder_layer.cu", "fused_decoder_layer.py:343",
                                           ledger_launches["fused_decoder_layer_fwd"]),
        "fused_decoder_layer_bwd_ledger": ("fused_decoder_layer.cu", "fused_decoder_layer.py:371",
                                           ledger_launches["fused_decoder_layer_bwd"]),
    }
    kernels = [{"name": name, "route": "cuda", "source": csrc + table[name][0],
                "replaces": tpu + table[name][1], "launches": table[name][2], **r}
               for name, r in results.items()]
    missing = sorted(set(table) - set(results)) + [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels not checked or not launched on a main path: {missing}")
    log(json.dumps({"kernels": kernels, "ms_per_replan_period": periods, "batch": BENCH_B,
                    "flagship_ms_per_replan_period": flag_periods, "flagship_batch": FLAG_B,
                    "train_ms_per_step": step_ms, "train_batch": TRAIN_BATCH,
                    "flagship_train_ms_per_step": flag_train_ms,
                    "flagship_train_batch": FLAG_TRAIN_B,
                    "flagship_train_peak_bytes": flag_train_peak,
                    "flash_flagship_ms_per_replan_period": flash_period_ms,
                    "flash_flagship_train_ms_per_step": flash_train_ms,
                    "flash_launches": {"flagship_serving": flash_serve,
                                       "flagship_training": flash_train, "h128_training": h128_flash},
                    "flash_shapes": flash_shapes, "tensor_core_sass": tensor_cores,
                    "resnet": {"yaml": "default_tpu.yaml", "encoder": resnet_encoder,
                               "ms_per_replan_period": resnet_periods, "batch": RESNET_B,
                               "launches": resnet_launches, "train": resnet_train,
                               "other_encoders": other_encoders},
                    "larger_model": {"yaml": "larger_model.yaml",
                                     "ms_per_replan_period": larger_periods, "batch": LARGER_B,
                                     "launches": larger_launches},
                    "decoder_only": {"ms_per_replan_period": s0_periods, "batch": DECODER_ONLY_B,
                                     "train_ms_per_step": s0_train_ms},
                    "distill": {"larger_model_distill": {**distill_larger,
                                                         "batch": LARGER_B},
                                "flagship": {**distill_flagship, "batch": DISTILL_FLAG_B}},
                    "smem_mirror_cases": smem_cases,
                    "recorded_data": recorded,
                    "evaluation": evaluation,
                    "parallel": parallel,
                    "checkpoints": checkpoints,
                    "variants": variants,
                    "ingest": ingest,
                    "ledger": ledger,
                    "mfu": mfu,
                    "examples": examples,
                    "gpu": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
