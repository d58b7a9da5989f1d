#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main paths on one GPU and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py [--profile]

Phases, each of which raises (non-zero exit, no result line) on failure:
  1. the card's name and power limit; build every CUDA kernel from
     src/repro_torch/kernels/csrc (one nvcc per source, in parallel);
     then the reference's threefry draws (`repro_torch.prng`) on the card
     against the CPU: bits and uniforms over 2²⁴ elements bitwise, normals
     within the CPU tests' 4 ulp, and the time to draw OPT-125M's and
     recurrentgemma-2b's initial weights on the card;
  2. each kernel against its plain version on the card at the main paths'
     shapes, with stated tolerances, then timed (CUDA events, warm-up,
     median) beside the plain version, a PyTorch library call where one
     computes the same function, and the card's bound for the same work,
     and where the host's launch overhead would hide the kernel, by device
     time under torch.profiler too; flash_attention at head_dim 256 also
     with its registers, local and shared memory and blocks an SM, and on
     the tensor-core kernel at head_dim 128 (moonshot's training shape,
     yi-6b's prefill and a 2048-token prompt, beside SDPA with enable_gqa
     and its bytes, f32 and 3xTF32 bounds) and at MLA's q·k heads 96
     (minicpm3-4b) and 192 (deepseek-v2) at their training and serve
     shapes, each failing on any local memory or on two calls that
     differ; the vlm and audio paths' shapes (whisper-medium's encoder
     non-causal over 1500 frames and its cross-attention of 64 queries on
     them at head_dim 64, internvl2-76b's 320 positions at 128, group 8)
     beside SDPA and their bytes and operations bounds; inputs x8, where
     no f32 evaluation
     meets the 1e-5 gate against another, held to be no further from the
     f64 value than attention_plain is;
     perturbed_matmul also per shape beside cuBLAS, at M = BM·C rows (z
     drawn once per weight), and with its registers, shared memory and
     cluster size; ssd_scan's two entries (y only, as training calls it,
     and with the final state) checked in five cases and timed warm and
     with the L2 flushed, with its three kernels' registers, local memory
     and shared memory, and its stateful entry at mamba2-370m's serve
     shapes (chunk 32 and chunk 48); rglru_scan also at S = 1 from h0 (a
     decode step of recurrentgemma-2b); then the bf16 instances
     (`check_bf16_kernels`): seeded_axpy_bf16 over every OPT-125M leaf,
     a ragged leaf, an odd view, layer slices and in place, and
     seeded_gather_bf16 over the fused path's rows, against the plain
     bf16 versions (bitwise, or 1 bf16 ulp on at most BF16_AXPY_SHARE),
     one bf16 θ pass beside its byte and issue bounds; flash_attention's
     bf16 kernel on the tensor cores (16, 32, 64 and 128; 96 padded to
     128) in BF16_FLASH's cases (a 2048-token prompt and whisper-medium's
     encoder and cross-attention among them) within one bf16 ulp of the
     f32 result, two calls bitwise, no local memory at any head dim, timed
     at BF16_FLASH_TIMED's shapes by device time beside SDPA in bf16 (P
     rounded to bf16 before P·V: another function) and the larger of the
     bytes and the kernel's three bf16 passes at 989 TFLOP/s;
     perturbed_matmul_bf16 (on the tensor cores, w + eps·z in three bf16
     pieces) at the fused path's 7 projections, ragged shapes, a ragged K
     and K % 8 == 4 within one bf16 ulp of the f32 result, its identity
     probes bitwise against seeded_axpy_bf16 (one on w + eps·z near
     2^-112, whose lo pieces are subnormal), timed beside cuBLAS bf16 on
     the resolved weights and its bound (bytes, 3×bf16 operations or one
     draw a weight, the largest);
  3. small-input references: tiny runs on the GPU (kernels) and on the CPU
     (plain versions) from the same weights agree — the reduced vlm
     (internvl2-76b) and audio (whisper-medium with 32 frames) rounds, the
     chained dense round, the fused dense round, the ssm round and the
     hybrid round, then the tiny dense round on squad over a wrapped
     rician channel (path loss, CSI phase error, outage) under
     analog/static, analog/reversed, perfect, sign/solution, sign/static
     and sign/reversed, and sign/solution at horizon 800, whose first
     rounds are silent, then the tiny dense round under digital and
     smart_digital (the card's uniform rows bitwise the host's) and
     FO-Adam on the tiny dense, ssm and hybrid models, and the reduced
     deepseek-v2 (MLA, MoE with a shared expert) and moonshot (MoE)
     rounds, chained and fused, whose GPU loop run a second run repeats
     bitwise — and the GPU scan engine (a captured CUDA graph replayed)
     equals the GPU loop engine bitwise; then the tiny dense, ssm and
     hybrid serve paths and the reduced deepseek-v2, moonshot,
     internvl2-76b and whisper-medium ones (24 + 16 tokens): prefill
     logits and state, the teacher-forced logits and serve_loop's tokens,
     GPU against CPU;
  4. thirteen paths, each through `repro_torch.core.fedsim.run` at full width
     with an eval hook, first on the loop engine, then from the same seed
     init on the scan engine (SCAN: rounds, chunk, eval cadence), the
     launch counters set to 0 just before each run and read just after;
     each scan run equals its loop run bitwise (losses, p_hat, accuracies,
     final weights or, for the hybrid, their per-leaf checksums), launches
     as many kernels, replays every round but each chunk's first, bills
     the uplink bits of the clients each round's mask admits, and passes
     the same peak gates; steady ms/round of both engines. The first four
     take the training CLI's defaults (5 clients, batch 8, seq 64,
     n_perturb 4, analog/solution/Rayleigh, sst2):
       chained  — OPT-125M, the chained (MeZO) dual forward; fails at 2.9 θ
                  of peak device memory or more;
       fused    — OPT-125M with `fused_perturbation=True` (perturbed
                  weights never materialize), plus one full-width fused
                  dual forward held against a fresh one; fails at 2.9 θ;
       mamba2   — mamba2-370m (the ssm family), chained;
       hybrid   — recurrentgemma-2b (RG-LRU and local attention at
                  head_dim 256), chained; fails above 2.0 θ;
       sign     — OPT-125M, chained, Sign-pAirZero with Theorem 4's
                  schedule at horizon 32 on squad over the wrapped rician
                  channel; fails if a round is silent, if no round has a
                  client in outage, or at 2.9 θ;
       fo       — OPT-125M, the first-order baseline (FO-Adam at the
                  CLI's lr, `transport="fo"`): one forward and one backward
                  a round, captured whole under scan; scan ≡ loop also in
                  both Adam moments, no privacy spent, 16·d uplink bits a
                  client; fails at 12 θ;
       mla      — minicpm3-4b whole (MLA, flash_attention at head_dim 96),
                  chained; fails at 2.0 θ;
       moe      — deepseek-v2-236b at full width, depth cut to 2 of its 60
                  layers (DEPTH; MLA at head_dim 192, 2 shared and 160
                  routed experts top-6), chained; fails at 2.0 θ;
       moe-fused — moonshot-v1-16b-a3b at full width, depth cut to 4 of
                  its 48 layers (64 experts top-6, GQA at head_dim 128),
                  with `fused_perturbation=True` (the router and attention
                  projections by perturbed_matmul, the expert banks
                  resolved a layer at a time), plus one full-width fused
                  dual forward held against a fresh one; fails at 2.0 θ;
       audio    — whisper-medium whole (24 encoder and 24 decoder layers,
                  flash_attention at head_dim 64: non-causal over 1500
                  frames in the encoder, 64 text queries on them in the
                  cross-attention, causal in the decoder: 72 launches a
                  forward), chained; each batch carries its 1500 frame
                  embeddings (the pipeline's stub frontend, staged from
                  pinned host memory); fails at AUDIO_PEAK_THETA;
       vlm      — internvl2-76b at full width, depth cut to 2 of its 80
                  layers (DEPTH; 256 patch embeddings in front of 64
                  tokens, GQA at head_dim 128, group 8), chained; fails at
                  2.0 θ;
       bf16     — OPT-125M in bf16 (`dtype=torch.bfloat16`), chained, as
                  `chained`; fails at `bf16_peak_gate` of the bf16 θ
                  (θ, two [2560, V] f32 logits, the lm head's f32 copy
                  that `unembed` made before its bf16 GEMM with f32
                  output, and half a θ: 4.61; a θ-sized copy fails it);
       bf16-fused — the same with `fused_perturbation=True`, plus one
                  full-width bf16 fused dual forward from the path's
                  trained weights held within BF16_FUSED_RTOL of the
                  same on the plain versions on the card, rounded where
                  the kernels round (w + eps·z kept in f32), and two
                  controls beyond that tolerance (w + eps·z rounded to
                  bf16, as `repro`'s XLA path; f32 weights and kernels);
     after the chained path the impl check (`run_impl_check`): 2 rounds
     with impl="pallas" bitwise the chained run's first two, and with
     impl="xla" no kernel launched and losses within IMPL_RTOL;
     then two scenario paths (ROADMAP A9) at the CLI's defaults,
     OPT-125M, each on the loop engine and then on the scan engine
     (SCENARIO_SCAN) from the same init, with the eavesdropper's capture
     (`privacy.Adversary`, an `AttackHook`), exact launches, the uplink
     bill and a peak gate reckoned from the path's structure:
       attacked  — analog/solution, sign_flip on a quarter of the clients,
                  robust_decode over ATTACK_GROUPS = 4 sub-slots (the
                  uplink bills one payload a client-round on 4 resource
                  blocks), desync (fraction 0.25, lag ≤ 4, phase std 0.1:
                  each direction adds a fresh-mode dual forward on the
                  lagged seed, 2 axpys a leaf and 2 forwards); scan ≡
                  loop bitwise (losses, p̂, p_clients, obs_y, final
                  weights), a loop run with the adversary off ≡ the loop
                  run; fails at ATTACKED_PEAK_THETA = 3.9 θ (chained's
                  2.41-2.50 θ plus the stale forward's perturbed copy,
                  1 θ); then a loop run with desync off for the stale
                  forward's share of a round, seed_replay on the capture
                  and the ε̂ audit at AUDIT_TRIALS = 1500 paired traces
                  on the card, `dominated`, its statistics within
                  AUDIT_RTOL = 1e-5 of the largest of the CPU's;
       fo-desync — FO-Adam, desync (fraction 0.25, phase std 0.1,
                  16-symbol frames: frame gains and interference normals
                  drawn on the card each round), obs_grad0 captured (a
                  forward and backward over client 0's rows a round, one
                  more flash launch a layer); scan ≡ loop bitwise (Adam
                  moments and the captured gradients too); fails at
                  FO_DESYNC_PEAK_THETA = 13 θ (the fo path's 9.7-9.9 θ;
                  under scan the pipelined chunk's captured gradients and
                  the graph's own, 3 θ); then DLG (600 steps, embed
                  space, cosine) on round 0's captured gradient for
                  client 0's [8, 64] batch from the seed-0 init, its first
                  DLG_CHECK_STEPS = 5 residuals with the kernels within
                  DLG_PLAIN_RTOL = 1e-4 of the plain versions' on the
                  card, its seconds, final residual and token accuracy;
     then the `observed` path (ROADMAP A9's obs/), OPT-125M chained at the
     CLI's defaults, OBSERVED_ROUNDS = 8 rounds on the loop engine and on
     the scan engine (chunks of 4), each with telemetry off and on
     (`cost=True`, memory samples, a MetricsSink, a warn HealthMonitor
     and a torch.profiler session): on ≡ off bitwise (losses, p̂, the
     final weights' fingerprint), exact launches, `peak_bytes` ==
     `max_memory_allocated`, the ledger's last row == the run's accounting,
     the merged profile holding the axpy and flash kernels, and the first
     round's counted operations within COST_RTOL = 2% of `round_flops`,
     the kernels' own part of them within KERNEL_FLOPS_RTOL = 1e-9 of its
     attention and axpy terms; a guarded run (an abort-policy monitor and
     a saver, so each boundary takes the checkpoint-then-abort copy)
     bitwise off too; the overheads in ms/round and the TFLOP/s; the
     copy's cost per boundary alone; on each engine an abort at ABORT_LR
     whose checkpoint is bitwise the weights of a run to its boundary;
     and two CLI runs in
     subprocesses: every artifact, passing `tools/check_trace.py --ledger
     --summary --expect-chunk-traces 1 --expect-step-builds 1` (the merged
     profile also `--require-device-lane`), and an abort that exits 3 and
     leaves a CRC-valid checkpoint at its last boundary;
  5. the `resume` path (OPT-125M chained, the CLI's defaults, checkpoints
     every RESUME_EVERY = 4 rounds into temporary directories removed
     after use): 8 rounds on the loop with an elastic event at round 4
     (K 5 → 3); then 4 rounds on scan and a second scan run to 8 that
     resumes at 4 and equals rounds 4-7 of the loop run bitwise (losses,
     p̂, accuracies, final weights; the DP ledger within 1e-12 relative);
     then 8 loop rounds with dropout 0.1 and stragglers 0.05 whose second
     checkpoint write is torn (`latest_valid` must return step 4, `latest`
     step 8) and a resumed run whose mask rows are a fresh FaultModel's
     from round 4; every run with exact launches, mask rows that bill the
     uplink, and the 2.9 θ peak gate on both engines with the checkpointer
     on; then 12 scan rounds for the ms/round with checkpoints, the stall
     of each boundary in both snapshot modes, the writer's seconds for one
     save from the host and `restore`'s seconds onto the card;
  6. the serve paths at full width, one after the other, each freed
     before the next: opt-125m, mamba2-370m, recurrentgemma-2b, yi-6b,
     minicpm3-4b, deepseek-v2 and moonshot with their depth cut as in
     phase 4, whisper-medium (zero frames, a cross cache over 1500 of
     them) and internvl2-76b (its depth cut, 256 zero patch embeddings in
     front of the prompt), through `repro_torch.launch.serve.serve_loop`
     at the serve CLI's defaults (batch 4, prompt 32, gen 16; yi-6b also
     once through `serve.main`): prefill ms, decode ms a step (CUDA
     events, the median of 15), tokens/s, the decode bound (θ bytes at
     3.35 TB/s), peak / θ; each fails on launches other than
     serve_expected_launches, a peak above 1.25 θ (whisper-medium: plus
     its cross cache's 0.31 θ), a prefill with the kernels that differs
     from the plain versions on the card, or (but for the hybrid)
     teacher-forced decode logits that differ from the full forward's
     (the moe family's at a capacity factor that drops no token,
     `no_drop`); `--profile` adds one decode step's idle share; then
     opt-125m and yi-6b served from bf16 weights with a bf16 cache, θ
     and the peak gate at 2 bytes a parameter (the gate plus the lm
     head's f32 copy that `unembed` made before its bf16 GEMM with f32
     output; no copy is made now), every prefill attention call within one bf16 ulp
     of the f32 result of its own inputs, the kernels' prefill logits
     against the plain versions' and decode ≡ forward within
     BF16_LOGITS_TOL of the logits' largest magnitude, each beside a
     control that must lie beyond it (the plain prefill with the causal
     mask flipped; decode with its cache position off by one);
  7. one `serve` JSON line, one `bf16` JSON line (ms a round of the bf16
     paths beside chained's and fused's, ms a decode step of the bf16
     serves, peaks over θ, with the card's name and power limit), one
     `table2` JSON line (peak / θ of the chained, sign and fo paths,
     the ZO / FO-Adam peak ratio, and OPT-125M's uplink bits a round under
     every transport), one `kernels` JSON line (launches from the loop
     runs and the serve runs, by path; a bf16 instance's from the bf16
     paths and serves, an f32 one's from the others), then the result
     line.

Needs one CUDA device and the repository checkout (it imports the port
from src/); exits non-zero without either. `--profile` adds one more loop
round and one more scan chunk of each path under torch.profiler and
prints where their device time goes (top kernels by device time, and the
device's busy share). `chip_scenarios.py` runs the named phase-4 paths
alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM TF32 on the tensor cores, dense
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 on the tensor cores, dense
# per path: rounds (both engines), rounds a scan chunk, eval cadence
SCAN = {"chained": (8, 4, 4), "fused": (4, 2, 2), "bf16": (8, 4, 4),
        "bf16-fused": (4, 2, 2), "mamba2": (4, 2, 2),
        "hybrid": (3, 3, 3), "sign": (8, 4, 4), "fo": (8, 4, 4),
        "mla": (4, 2, 2), "moe": (4, 2, 2), "moe-fused": (4, 2, 2),
        "audio": (3, 2, 2), "vlm": (3, 2, 2)}
# full width, depth cut so that θ fits one 80 GB card in f32: the layers
# kept (deepseek-v2: 2 × 15.89 + 4.19 = 35.97 GB of θ; moonshot: 4 × 2.28
# + 2.68 = 11.81 GB; internvl2: 2 × 3.42 + embed and lm_head 2 × 4.20 =
# 15.25 GB); every other config runs whole
DEPTH = {"deepseek-v2-236b": 2, "moonshot-v1-16b-a3b": 4,
         "internvl2-76b": 2}
# paths whose final weights are compared as per-leaf checksums
# (`fingerprint`), not copied to the host
LARGE = ("hybrid", "mla", "moe", "moe-fused", "audio", "vlm")
# the sign path's channel: rician under path loss, CSI phase error and
# deep-fade outage, so clients drop out of some rounds (mask rows < K)
WRAPPED_RICIAN = dict(model="rician", rician_k=3.0, cell_radius=100.0,
                      phase_err_std=0.1, outage_db=-10.0)
# the sign path's planned horizon: Theorem 4's schedule at the CLI's 800
# leaves rounds 0-726 silent (c = 0), so a few rounds would check nothing;
# at 32 no round is silent
SIGN_HORIZON = 32
# the audio path's peak gate (× θ): activations over 1500 frames are about
# θ-sized at whisper-medium's width (2.71 θ on the loop, 2.86-2.92 on scan
# on an H100, PERF.md §2), so a θ-sized copy would show at 3.7 or more
AUDIO_PEAK_THETA = 3.3
# the scenario paths (ROADMAP A9): rounds (both engines), rounds a chunk
SCENARIO_SCAN = {"attacked": (8, 4), "fo-desync": (4, 2)}
# robust_decode's orthogonal sub-slots on the attacked path
ATTACK_GROUPS = 4
# the attacked path's peak gate (× θ): the chained path's 2.41-2.50 θ plus
# the stale clients' fresh-mode dual forward, which holds one perturbed
# copy of θ beside w: about 3.4-3.5 θ; a second θ-sized copy would show
# at 4.4 or more
ATTACKED_PEAK_THETA = 3.9
# the fo-desync path's peak gate (× θ), reckoned before its first run:
# the fo path's 9.7-9.9 θ plus the captured gradients; on the loop the
# forward and backward over client 0's rows run beside the averaged
# gradient (1 θ) at a fifth of the activations, under the first
# backward's peak; under scan a chunk's first round runs while the
# previous chunk's captured gradients (2 θ) wait to be synced and the
# graph holds its own (1 θ); the frame gains and the interference act in
# place, a leaf of normals at a time
FO_DESYNC_PEAK_THETA = 13.0
# the audit's paired traces (the training CLI's --audit-trials default),
# and its statistics on the card against the CPU's: max|Δ| over the
# largest |statistic| of each arm (a statistic sums signed per-round
# LLRs, so one near 0 has no relative precision; the y that enter them
# sum K terms in another order, with normals 2 ulps apart on 1.6e-5 of
# draws, PERF.md §6)
AUDIT_TRIALS = 1500
AUDIT_RTOL = 1e-5
# DLG's first steps with the kernels against the plain versions
DLG_CHECK_STEPS = 5
DLG_PLAIN_RTOL = 1e-4
# the observed path: rounds and scan chunk; its first round's counted
# operations against `round_flops` (the counted ones are the analytic
# count's terms, each counted once: only a term the count misses parts
# them); the lr whose first update sends the loss past 10x its best, with
# one direction a round (on the CPU at opt-125m's reduced config, 6.3 to
# 8357 at lr 2), and the aborted run's planned rounds
OBSERVED_ROUNDS = 8
OBSERVED_CHUNK = 4
# how far a telemetry run's peak may exceed the plain run's, in θ
OBSERVED_PEAK_SLACK = 0.01
# kernels the merged profile must hold (substrings of their names)
PROFILED_KERNELS = ("axpy_kernel", "flash_fwd")
COST_RTOL = 0.02
# the kernels' own counted operations against the analytic count's
# attention and axpy terms: the same integers summed in another order
KERNEL_FLOPS_RTOL = 1e-9
# the guarded runs' checkpoint cadence: a saver that never saves in
# OBSERVED_ROUNDS rounds, so they time the boundary copy alone
GUARD_EVERY = 1000
ABORT_LR = 2.0
ABORT_ROUNDS = 12
# the resume path's checkpoint, eval and scan-chunk cadence
RESUME_EVERY = 4
N_PERTURB = 4                  # the training CLI's default
M_ROWS = 5 * 8 * 64            # clients × batch × seq: rows of every matmul
PMM_SHAPES = ((768, 768), (768, 3072), (3072, 768))
# one OPT-125M layer: wq, wk, wv, wo; wi, wg; wd
PMM_LAYER = (((768, 768),) * 4 + ((768, 3072),) * 2 + ((3072, 768),))
# the CPU tests' tolerance for normals (tests/test_torch_prng.py)
NORMAL_ULPS = 4
# the serve CLI's defaults (`python -m repro.launch.serve`)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 32, 16
SERVE_ARCHS = ("opt-125m", "mamba2-370m", "recurrentgemma-2b", "yi-6b",
               "minicpm3-4b", "deepseek-v2-236b", "moonshot-v1-16b-a3b",
               "whisper-medium", "internvl2-76b")
# decode ≡ forward, teacher-forced: tests/test_torch_serve.py's DECODE
# (the reference's own, tests/test_models.py)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
# a full-width prefill with the kernels against the plain versions on the
# card: max|Δ| ≤ SERVE_PLAIN_TOL · max|plain|, for the logits and for each
# cache or state leaf (f32 sums in another order, through every layer)
SERVE_PLAIN_TOL = 1e-4
# the tiny serve paths on the card (kernels) against the CPU (plain)
TINY_SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
# a serve path's peak device memory: θ, the decode state and transients;
# the audio family's decode state also holds its cross cache over every
# frame (whisper-medium: 24 layers × batch 4 × 1500 × 1024 × 4 B × (k, v)
# = 1.18 GB, 0.31 of its θ), and its gate is 1.25 θ plus that share
# (`serve_peak_gate`)
SERVE_PEAK_THETA = 1.25


def full_width(arch: str):
    """The config at full width: whole, or its depth cut to DEPTH."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    if arch in DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH[arch])
    return cfg


def depth_note(cfg) -> str:
    """", depth cut to n of N layers" for a config DEPTH cuts, else """""
    from repro_torch.configs import get_arch
    full = get_arch(cfg.name).n_layers
    return "" if cfg.n_layers == full else \
        f", depth cut to {cfg.n_layers} of {full} layers"


def no_drop(cfg):
    """A moe config at capacity factor E/k: every expert can take every
    token of a dispatch group, so no token is dropped, as in a one-token
    decode step (identity on other configs)."""
    if not cfg.moe.enabled:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts
        / cfg.moe.n_experts_per_tok))


def time_ms(torch, fn, warmup: int = 3, reps: int = 15) -> float:
    """Median CUDA-event time of one call of fn, after warm-up. For a call
    whose device time is below its host launch overhead this is the
    overhead; device_ms gives the device's own time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of one call of fn: the self time of its CUDA
    kernels under torch.profiler over reps calls, after a warm-up. Unlike
    time_ms it leaves out the host's launch overhead, which exceeds the
    device time of a call this short (tens of microseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a capture that lost every kernel event (see device_span_ms) is taken
    # again, at most twice
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / reps / 1e3
    raise AssertionError(f"no kernel time recorded in {reps} calls")


def device_span_ms(torch, fn, reps: int = 20) -> float:
    """Median device span of one call of fn that launches several kernels:
    from its first kernel's start to its last kernel's end under
    torch.profiler, after a warm-up. Unlike device_ms it counts kernels
    that overlap (a programmatic dependent launch) once, and the gaps
    between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the profiler now and then returns fewer kernel events than were
    # launched (seen on the H100: none at all for a whole capture); such a
    # capture measures nothing, so it is taken again, at most twice
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e.time_range.start, e.time_range.end)
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
        per = len(kernels) // reps
        if per > 0 and per * reps == len(kernels):
            break
    else:
        raise AssertionError(f"{len(kernels)} kernels in {reps} calls")
    return statistics.median(
        max(end for _, end in kernels[i:i + per]) - kernels[i][0]
        for i in range(0, len(kernels), per)) / 1e3


def bound_ms(n_bytes: float, n_flops: float) -> tuple:
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def attention_f64(torch, q, k, v, causal: bool = True, window=None):
    """attention_plain's function evaluated in float64: the value that an
    f32 evaluation (attention_plain's own included) approximates, for
    inputs whose scores are too large for any f32 evaluation to stay within
    the flash gate of another."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    kd = k.double().repeat_interleave(group, dim=1)
    vd = v.double().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.double() * (1.0 / d ** 0.5), kd)
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), vd)


def ulps(torch, a, b) -> int:
    ai = a.contiguous().view(torch.int32).to(torch.int64)
    bi = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ai - bi).abs().max())


def require_equal(torch, got, want, what: str) -> None:
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        err = float((got - want).abs().max())
        raise AssertionError(f"{what}: not bitwise equal (max err {err})")


def sass_path_instructions(name: str, kernels: tuple) -> dict:
    """The fewest SASS instructions a thread of each named kernel in the
    built library of csrc/<name>.cu issues from its entry to its final
    EXIT (`cuobjdump -sass`): the shortest path through the kernel's
    control flow, with predicated early EXITs not taken and a CALL counted
    as one instruction, so the slow paths that branches skip (the precise
    logf/sqrtf/cosf's special cases, a 64-bit division's) count nothing. A
    lower bound on what a thread that does the work issues."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    fns, current = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            current = next((k for k in kernels if k in fn.group(1)), None)
            if current:
                fns[current] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if current and ins:
            fns[current].append((int(ins.group(1), 16), ins.group(2)))
    if set(fns) != set(kernels):
        raise AssertionError(f"{name}: SASS for {sorted(fns)}, want "
                             f"{sorted(kernels)}")
    out = {}
    for kernel, code in fns.items():
        at = {addr: i for i, (addr, _) in enumerate(code)}

        def successors(i):
            text = code[i][1]
            predicated = text.startswith("@")
            op = text.split()[1 if predicated else 0]
            nxt = [i + 1] if i + 1 < len(code) else []
            if op == "EXIT":
                return nxt if predicated else None      # None: the end
            if op.startswith("BRA"):
                target = [at[int(text.split()[-1], 16)]]
                conditional = predicated or "," in text
                return target + nxt if conditional else target
            if op.startswith("RET"):
                return []
            return nxt

        dist, heap, best = {0: 1}, [(1, 0)], None
        while heap:
            d, i = heapq.heappop(heap)
            if d > dist[i]:
                continue
            succ = successors(i)
            if succ is None:
                best = d
                break
            for j in succ:
                if d + 1 < dist.get(j, math.inf):
                    dist[j] = d + 1
                    heapq.heappush(heap, (d + 1, j))
        out[kernel] = best
    return out


def issue_bound_ms(torch, per_element: float, elements: int) -> float:
    """The least time to issue `per_element` instructions for each of
    `elements` elements, 32 lanes a warp instruction: one warp instruction
    a cycle on each of an SM's 4 schedulers, at the card's maximum SM
    clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_element * elements / 32 / (sms * 4 * mhz * 1e6) * 1e3


def check_prng(torch, dev) -> dict:
    """The reference's threefry draws on the card against the CPU: bits
    and uniforms of 2²⁴ elements bitwise, a draw from a batch of split keys
    too, normals within NORMAL_ULPS (the card's and the CPU's log1p may
    round apart); then the weight init of OPT-125M and recurrentgemma-2b
    on the card, timed."""
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.models import registry

    n = 1 << 24
    key = prng.key(20)
    keys = prng.split(prng.fold_in(key, 7), 3)
    for what, fn in (("bits", lambda k: prng.random_bits(k, (n,))),
                     ("uniform", lambda k: prng.uniform(k, (n,))),
                     ("batched uniform", lambda k: prng.uniform(
                         prng.split(prng.fold_in(k, 7), 3), (1000, 37)))):
        require_equal(torch, fn(key.to(dev)).cpu(), fn(key), f"prng {what}")
    z_dev = prng.normal(key.to(dev), (n,)).cpu()
    z_cpu = prng.normal(key, (n,))
    z_ulps = ulps(torch, z_dev, z_cpu)
    z_share = float((z_dev != z_cpu).float().mean())
    if z_ulps > NORMAL_ULPS:
        raise AssertionError(f"prng normal: {z_ulps} ulp between the card "
                             f"and the CPU (> {NORMAL_ULPS})")
    require_equal(torch, prng.normal(keys.to(dev), (64, 33)).cpu(),
                  prng.normal(keys, (64, 33)), "prng batched normal")
    init_s = {}
    for name in ("opt-125m", "recurrentgemma-2b"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = registry.init_params(get_arch(name), prng.key(0), dev)
        torch.cuda.synchronize()
        init_s[name] = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
    print(f"prng: bits and uniform over {n} elements bitwise card vs CPU; "
          f"normal {z_ulps} ulp max, {z_share:.3e} of elements differ; init "
          f"on the card: OPT-125M {init_s['opt-125m']:.3f} s, "
          f"recurrentgemma-2b {init_s['recurrentgemma-2b']:.3f} s",
          flush=True)
    return {"normal_max_ulp": z_ulps, "normal_share_differ": z_share,
            "init_s": init_s}


def check_seeded_axpy(torch, dev) -> list:
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import zo
    from repro_torch.kernels import seeded_axpy as sa
    from repro_torch.models import registry

    cfg = get_arch("opt-125m")
    shapes = list(registry.shapes(cfg)) + [(1_000_003,)]   # + ragged
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = torch.tensor(-3e-3, dtype=torch.float32, device=dev)
    # the kernels read each leaf seed from device memory
    seed_t = lambda v: sa.seed_tensor(v, dev)  # noqa: E731
    max_err = 0.0
    for i, shape in enumerate(shapes):
        w = torch.randn(shape, generator=gen, device=dev)
        seed = zo.leaf_seed(0xC0FFEE, i)
        got = sa.seeded_axpy_cuda(w, seed_t(seed), scale,
                                  torch.empty_like(w))
        want = sa.seeded_axpy_plain(w, seed, scale)
        err = float((got - want).abs().max())
        # |Δz| ≤ 4 ulp of |z| (< 6) times |scale|, plus one ulp of the sum
        tol = 3e-3 * 4 * 6 * 2.0 ** -23 + float(want.abs().max()) * 2.0 ** -23
        if not err <= tol:
            raise AssertionError(f"seeded_axpy {shape}: max err {err} > {tol}")
        max_err = max(max_err, err)
        if len(shape) == 3:
            # a layer slice with its base counter draws the whole leaf's
            # bits there (the fused path's resolve), bitwise as the plain
            for layer in (1, shape[0] - 1):
                off = layer * shape[1] * shape[2]
                sl = sa.seeded_axpy_cuda(w[layer], seed_t(seed), scale,
                                         torch.empty_like(w[layer]), off)
                require_equal(torch, sl, got[layer],
                              f"seeded_axpy {shape} layer {layer} slice")
                require_equal(torch, sl, sa.seeded_axpy_plain(
                    w[layer], seed, scale, off),
                    f"seeded_axpy {shape} layer {layer} vs plain")
        # in place (out aliases w) gives the same bits as out of place
        sa.seeded_axpy_cuda(w, seed_t(seed), scale, w)
        if not torch.equal(w, got):
            raise AssertionError(f"seeded_axpy {shape}: in-place differs")
        del w, got, want
    # counters that wrap past 2³², on a ragged leaf
    w = torch.randn(1_000_003, generator=gen, device=dev)
    off = 2**32 - 123_457
    require_equal(torch, sa.seeded_axpy_cuda(w, seed_t(99), scale,
                                             torch.empty_like(w), off),
                  sa.seeded_axpy_plain(w, 99, scale, off),
                  "seeded_axpy wrapping offset")
    # z probe: w = 0, scale = 1 returns z itself; every bit of z follows
    # from the hash bits, so a wrong hash bit would show as a gross error
    n = 4_000_037
    one = torch.ones((), dtype=torch.float32, device=dev)
    zeros = torch.zeros(n, device=dev)
    z_k = sa.seeded_axpy_cuda(zeros, seed_t(77), one, torch.empty_like(zeros))
    z_p = sa.draw_z((n,), 77, dev)
    z_ulps = ulps(torch, z_k, z_p)
    z_same = float((z_k == z_p).float().mean())
    if z_ulps > 2:
        raise AssertionError(f"seeded_axpy z probe: {z_ulps} ulp from plain")
    # scale 0 probe: the axpy adds exactly nothing
    w = torch.randn(n, generator=gen, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if not torch.equal(sa.seeded_axpy_cuda(w, seed_t(5), zero,
                                           torch.empty_like(w)), w):
        raise AssertionError("seeded_axpy scale-0 probe changed w")
    print(f"seeded_axpy: {len(shapes)} shapes ok, max err {max_err:.3e}; "
          f"layer slices and a wrapping offset bitwise; z probe {z_ulps} "
          f"ulp max, {z_same:.6f} bit-identical", flush=True)

    # gathered rows: the main path's [40, 64] tokens of the embedding table
    table = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (40, 64), generator=gen,
                           device=dev)
    eps = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    rows = sa.seeded_gather_cuda(table, tokens, seed_t(4321), eps)
    require_equal(torch, rows, sa.seeded_gather_plain(table, tokens, 4321,
                                                      eps), "seeded_gather")
    whole = sa.seeded_axpy_cuda(table, seed_t(4321), eps,
                                torch.empty_like(table))
    require_equal(torch, rows, whole[tokens], "seeded_gather vs table rows")
    off = 2**32 - 5000
    require_equal(torch, sa.seeded_gather_cuda(table, tokens[:3], seed_t(8),
                                               eps, off),
                  sa.seeded_gather_plain(table, tokens[:3], 8, eps, off),
                  "seeded_gather wrapping offset")
    one_seed = seed_t(1)
    g_ms = time_ms(torch, lambda: sa.seeded_gather_cuda(table, tokens,
                                                        one_seed, eps))
    g_plain = time_ms(torch, lambda: sa.seeded_gather_plain(table, tokens, 1,
                                                            eps))
    g_dev = device_ms(torch, lambda: sa.seeded_gather_cuda(table, tokens,
                                                           one_seed, eps))
    n_el = tokens.numel() * cfg.d_model
    g_bound, g_by = bound_ms(8.0 * n_el + 8 * tokens.numel(), 12.0 * n_el)
    print("seeded_gather: [40,64] rows of the [50272,768] table bitwise vs "
          f"plain and vs the whole-table draw; {g_ms:.4f} ms, device time "
          f"{g_dev:.4f} ms, bound {g_bound:.6f} ms by {g_by}", flush=True)
    del table, whole, rows

    # one θ pass over full OPT-125M (12 launches), as `zo.perturb` runs it
    params = registry.init_params(cfg, prng.key(0), dev)
    leaves = [t for _, t in zo.flatten(params)]
    n_total = sum(t.numel() for t in leaves)
    row = zo.seed_row(1234, len(leaves), dev)
    ms = time_ms(torch, lambda: zo.perturb(params, row, scale, inplace=True))
    plain_ms = time_ms(torch, lambda: [sa.seeded_axpy_plain(t, 9, scale)
                                       for t in leaves], warmup=1, reps=3)
    # f32 work per element: 2 unit conversions + 2 floors, log, ×(−2),
    # sqrt, ×2π, cos, ×r, ×scale, +w (the integer hash is not counted)
    b_ms, b_by = bound_ms(8.0 * n_total, 12.0 * n_total)
    del params, leaves
    torch.cuda.empty_cache()
    # the issue bound (ROADMAP B4): an axpy thread draws 4 elements, a
    # gather thread one
    # the f32 instances (axpy_kernel<float>, gather_kernel<float>)
    sass = sass_path_instructions("seeded_axpy",
                                  ("axpy_kernelIfE", "gather_kernelIfE"))
    per_el = {"axpy_kernel": sass["axpy_kernelIfE"] / 4,
              "gather_kernel": float(sass["gather_kernelIfE"])}
    issue = {"axpy_kernel": issue_bound_ms(torch, per_el["axpy_kernel"],
                                           n_total),
             "gather_kernel": issue_bound_ms(torch, per_el["gather_kernel"],
                                             n_el)}
    print(f"seeded_axpy issue bound: SASS path {sass} instructions a "
          "thread; "
          f"{per_el['axpy_kernel']:.1f} per element over {n_total} elements "
          f"{issue['axpy_kernel']:.4f} ms (byte bound {b_ms:.4f} ms); "
          f"gather {per_el['gather_kernel']:.0f} per element over {n_el} "
          f"elements {issue['gather_kernel']:.6f} ms (byte bound "
          f"{g_bound:.6f} ms)", flush=True)
    return [{"name": "seeded_axpy", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/seeded_axpy.cu",
             "replaces": "src/repro/kernels/seeded_axpy.py:83",
             "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
             "issue_bound_ms": issue["axpy_kernel"],
             "sass_instructions_per_element": per_el["axpy_kernel"],
             "shape": f"one θ pass, {n_total} f32 elements in 12 leaves"},
            {"name": "seeded_gather", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/seeded_axpy.cu",
             "replaces": "src/repro/kernels/seeded_axpy.py:83",
             "max_abs_err": 0.0, "ms": g_ms, "plain_ms": g_plain,
             "bound_ms": g_bound, "bound_by": g_by, "library_ms": None,
             "device_ms": g_dev, "issue_bound_ms": issue["gather_kernel"],
             "sass_instructions_per_element": per_el["gather_kernel"],
             "shape": "[40,64] tokens of a [50272,768] table"}]


def check_flash_attention(torch, dev) -> dict:
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [  # (q shape, kv shape, causal, window)
        ((40, 12, 64, 64), (40, 12, 64, 64), True, None),   # main path
        ((2, 8, 48, 64), (2, 2, 80, 64), True, 32),          # GQA, Sq<Skv
        ((3, 4, 33, 16), (3, 4, 33, 16), False, None),       # tiny-model D
        # head_dim 256 (recurrentgemma-2b): group 10 at the main shape,
        # a window that binds (32 of 64 keys), Sq < Skv
        ((40, 10, 64, 256), (40, 1, 64, 256), True, None),
        ((4, 10, 64, 256), (4, 1, 64, 256), True, 32),
        ((3, 10, 37, 256), (3, 1, 80, 256), True, 48),
        # head_dim 256's head chunks: group 1, 3 (80 rows not filled), 4
        # on two kv heads; group 10 over 300 keys (ten key tiles: the
        # online rescale runs); non-causal; window 1 (each row sees only
        # itself); one query row
        ((2, 4, 64, 256), (2, 4, 64, 256), True, None),
        ((2, 6, 40, 256), (2, 2, 40, 256), True, None),
        ((2, 8, 50, 256), (2, 2, 50, 256), True, None),
        ((2, 10, 64, 256), (2, 1, 300, 256), True, None),
        ((3, 10, 37, 256), (3, 1, 80, 256), False, None),
        ((2, 10, 64, 256), (2, 1, 64, 256), True, 1),
        ((2, 10, 1, 256), (2, 1, 70, 256), True, None),
        # Skv over one key tile of the head_dim <= 64 kernel (32 keys)
        ((2, 12, 200, 64), (2, 12, 200, 64), True, None),
        ((2, 12, 37, 64), (2, 4, 300, 64), True, 64),
        ((3, 4, 150, 32), (3, 4, 150, 32), False, None),
        # head_dim 128 (yi-6b, moonshot; the tensor-core kernel): yi-6b's
        # prefill (group 8 on four kv heads), a long prompt, moonshot's
        # training shape (group 1), group 1 over 70 keys, a window that
        # binds with Sq < Skv, and non-causal
        ((4, 32, 32, 128), (4, 4, 32, 128), True, None),
        ((1, 32, 2048, 128), (1, 4, 2048, 128), True, None),
        ((40, 16, 64, 128), (40, 16, 64, 128), True, None),
        ((2, 4, 70, 128), (2, 4, 70, 128), True, None),
        ((2, 16, 45, 128), (2, 2, 130, 128), True, 40),
        ((3, 8, 33, 128), (3, 4, 33, 128), False, None),
        # MLA's q·k heads, the tensor-core kernel. 96 (minicpm3-4b): its
        # training and serve shapes, GQA with a window over several key
        # tiles, non-causal. 192 (deepseek-v2): its training and serve
        # shapes, group 8 with a window, group 2 non-causal, one query row.
        # 24 (the reduced MLA configs): zero-padded to the 32 instance by
        # the wrapper
        ((40, 40, 64, 96), (40, 40, 64, 96), True, None),
        ((4, 40, 32, 96), (4, 40, 32, 96), True, None),
        ((2, 6, 70, 96), (2, 2, 130, 96), True, 40),
        ((3, 4, 33, 96), (3, 4, 33, 96), False, None),
        ((40, 128, 64, 192), (40, 128, 64, 192), True, None),
        ((4, 128, 32, 192), (4, 128, 32, 192), True, None),
        ((2, 16, 45, 192), (2, 2, 130, 192), True, 40),
        ((3, 6, 33, 192), (3, 3, 33, 192), False, None),
        ((2, 10, 1, 192), (2, 1, 70, 192), True, None),
        ((2, 4, 24, 24), (2, 4, 24, 24), True, None),
        # the tensor-core kernel (96, 128 and 192) at its edges: Sq not a
        # multiple of a warp's 16 rows and Skv not of the 32-key tile, 300
        # keys over two kv heads (the online rescale over ten tiles), group
        # 8 at 96 with a window, window 1 (each row sees only itself), one
        # query row
        ((2, 4, 37, 96), (2, 4, 37, 96), True, None),
        ((2, 4, 37, 128), (2, 4, 37, 128), True, None),
        ((2, 4, 37, 192), (2, 4, 37, 192), True, None),
        ((2, 4, 70, 96), (2, 2, 300, 96), True, None),
        ((2, 4, 70, 128), (2, 2, 300, 128), True, None),
        ((2, 4, 70, 192), (2, 2, 300, 192), True, None),
        ((2, 16, 45, 96), (2, 2, 130, 96), True, 40),
        ((2, 4, 64, 96), (2, 4, 64, 96), True, 1),
        ((2, 4, 64, 128), (2, 4, 64, 128), True, 1),
        ((2, 4, 64, 192), (2, 4, 64, 192), True, 1),
        ((2, 10, 1, 96), (2, 1, 70, 96), True, None),
        ((2, 10, 1, 128), (2, 1, 70, 128), True, None),
        # the vlm and audio paths: head_dim 64 non-causal over
        # whisper-medium's 1500 frames (the encoder's self-attention, the
        # cross-attention of 64 text queries in training and of a 32-token
        # prompt in serving); head_dim 128 at internvl2-76b's 256 patches
        # and 64 tokens (training) or a 32-token prompt (serving), group 8
        ((2, 16, 1500, 64), (2, 16, 1500, 64), False, None),
        ((2, 16, 64, 64), (2, 16, 1500, 64), False, None),
        ((4, 16, 32, 64), (4, 16, 1500, 64), False, None),
        ((2, 64, 320, 128), (2, 8, 320, 128), True, None),
        ((4, 64, 288, 128), (4, 8, 288, 128), True, None),
    ]
    max_err = 0.0
    tc_err = {96: 0.0, 128: 0.0, 192: 0.0}
    for qs, ks, causal, window in cases:
        q = torch.randn(qs, generator=gen, device=dev)
        k = torch.randn(ks, generator=gen, device=dev)
        v = torch.randn(ks, generator=gen, device=dev)
        got = fa.flash_attention_cuda(q, k, v, causal, window)
        want = fa.attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"flash_attention {qs}/{ks}: max err {err}")
        max_err = max(max_err, err)
        if qs[-1] in tc_err:
            tc_err[qs[-1]] = max(tc_err[qs[-1]], err)
    print(f"flash_attention: {len(cases)} cases ok, max err {max_err:.3e}; "
          f"tensor-core kernel, max err at 96 {tc_err[96]:.3e}, at 128 "
          f"{tc_err[128]:.3e}, at 192 {tc_err[192]:.3e}", flush=True)
    large = flash_attention_large_scores(torch, dev, gen)

    b, h, s, d = cases[0][0]
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
               for _ in range(3))
    ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, True))
    plain_ms = time_ms(torch, lambda: fa.attention_plain(q, k, v, True))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True))
    dev_ms = device_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, True))
    lib_dev_ms = device_ms(torch, lambda: sdpa(q, k, v, is_causal=True))
    # per visible pair: q·k (2d), p·v (2d), exp and the sum (≈3)
    flops = b * h * fa.visible_pairs(s, s) * (4 * d + 3)
    b_ms, b_by = bound_ms(4.0 * 4 * b * h * s * d, flops)

    # recurrentgemma-2b's attention: 10 q heads on one kv head, head_dim
    # 256; the window (2048) does not bind at seq 64
    (b2, h2, s2, d2), kv_shape = cases[3][0], cases[3][1]
    q2 = torch.randn((b2, h2, s2, d2), generator=gen, device=dev)
    k2, v2 = (torch.randn(kv_shape, generator=gen, device=dev)
              for _ in range(2))
    ms2 = time_ms(torch, lambda: fa.flash_attention_cuda(q2, k2, v2, True,
                                                         2048))
    plain2 = time_ms(torch, lambda: fa.attention_plain(q2, k2, v2, True,
                                                       2048))
    lib2 = time_ms(torch, lambda: sdpa(q2, k2, v2, is_causal=True,
                                       enable_gqa=True))
    dev2 = device_ms(torch, lambda: fa.flash_attention_cuda(q2, k2, v2, True,
                                                            2048))
    lib_dev2 = device_ms(torch, lambda: sdpa(q2, k2, v2, is_causal=True,
                                             enable_gqa=True))
    attrs2 = fa.kernel_attributes(d2)
    flops2 = b2 * h2 * (s2 * (s2 + 1) // 2) * (4 * d2 + 3)
    bytes2 = 4.0 * (2 * b2 * h2 * s2 * d2 + 2 * b2 * kv_shape[1] * s2 * d2)
    b2_ms, b2_by = bound_ms(bytes2, flops2)
    print(f"flash_attention: [{b},{h},{s},{d}] causal {ms:.4f} ms (plain "
          f"{plain_ms:.4f}, SDPA {library_ms:.4f}, bound {b_ms:.4f}; device "
          f"time {dev_ms:.4f}, SDPA {lib_dev_ms:.4f}); "
          f"[{b2},{h2},{s2},{d2}] on [{','.join(map(str, kv_shape))}] causal "
          f"{ms2:.4f} ms (plain {plain2:.4f}, SDPA {lib2:.4f}, bound "
          f"{b2_ms:.4f} by {b2_by}; device time {dev2:.4f}, SDPA "
          f"{lib_dev2:.4f})", flush=True)
    print(f"flash_attention head_dim {d2} kernel: {attrs2}", flush=True)
    hd128 = flash_attention_128(torch, dev, gen)
    mla = flash_attention_mla(torch, dev, gen)
    frontends = flash_attention_frontends(torch, dev, gen)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:104",
            "max_abs_err": max(max_err, *(r["max_abs_err"]
                                          for r in frontends.values())),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
            "shape": f"[{b},{h},{s},{d}] causal",
            "head_dim_256": {
                "ms": ms2, "plain_ms": plain2, "bound_ms": b2_ms,
                "bound_by": b2_by, "library_ms": lib2, "device_ms": dev2,
                "library_device_ms": lib_dev2, "kernel_attributes": attrs2,
                "shape": f"q [{b2},{h2},{s2},{d2}] k/v "
                         f"[{','.join(map(str, kv_shape))}] causal"},
            "head_dim_128": hd128, "tc_max_abs_err": tc_err,
            "large_scores": large, "frontends": frontends, **mla}


# inputs x8 (scores x64) at 96, 128 and 192: no f32 evaluation stays within
# the flash gate of another here (attention_plain is 30-60 times the gate
# from the f64 value, as is the f32 FMA kernel these instances replaced), so
# the kernel is held to be no further from the f64 value than
# attention_plain is. One TF32 pass would be hundreds of times further.
FLASH_LARGE = (((2, 8, 64, 96), (2, 8, 64, 96)),
               ((2, 4, 70, 96), (2, 2, 300, 96)),
               ((2, 8, 64, 128), (2, 8, 64, 128)),
               ((2, 4, 70, 128), (2, 2, 300, 128)),
               ((2, 8, 64, 192), (2, 8, 64, 192)),
               ((2, 4, 70, 192), (2, 2, 300, 192)))


def gate_share(got, want) -> float:
    """max |got - want| / (1e-5 + 1e-5 |want|): at most 1 passes the
    flash gate (allclose at rtol = atol = 1e-5)."""
    return float(((got.double() - want.double()).abs()
                  / (1e-5 + 1e-5 * want.double().abs())).max())


def flash_attention_large_scores(torch, dev, gen) -> list:
    from repro_torch.kernels import flash_attention as fa

    out = []
    for qs, ks in FLASH_LARGE:
        q = 8 * torch.randn(qs, generator=gen, device=dev)
        k, v = (8 * torch.randn(ks, generator=gen, device=dev)
                for _ in range(2))
        exact = attention_f64(torch, q, k, v)
        plain = fa.attention_plain(q, k, v)
        got = fa.flash_attention_cuda(q, k, v)
        row = {"shape": f"q {list(qs)} k/v {list(ks)} x8 causal",
               "kernel_vs_f64": gate_share(got, exact),
               "plain_vs_f64": gate_share(plain, exact),
               "kernel_vs_plain": gate_share(got, plain)}
        print(f"flash_attention x8 {row['shape']}: from the f64 value "
              f"{row['kernel_vs_f64']:.2f} gates (attention_plain "
              f"{row['plain_vs_f64']:.2f}); from attention_plain "
              f"{row['kernel_vs_plain']:.2f}", flush=True)
        if not row["kernel_vs_f64"] <= row["plain_vs_f64"]:
            raise AssertionError(f"flash_attention x8 {qs}/{ks}: further "
                                 "from the f64 value than attention_plain")
        out.append(row)
    return out


# head_dim 128's shapes on this slice's paths, causal: moonshot's training
# forward (5 clients × batch 8 × seq 64, GQA group 1), yi-6b's serve
# prefill (batch 4, prompt 32, group 8) and a 2048-token prompt
GQA_FLASH = {"moonshot train": ((40, 16, 64, 128), (40, 16, 64, 128)),
             "yi-6b prefill": ((4, 32, 32, 128), (4, 4, 32, 128)),
             "long prompt": ((1, 32, 2048, 128), (1, 4, 2048, 128))}


def flash_attention_128(torch, dev, gen) -> dict:
    """The head_dim-128 instance (the tensor-core kernel) at GQA_FLASH's
    shapes, each timed beside the plain version, SDPA with `enable_gqa` and
    its bounds: bytes at 3.35 TB/s, the visible pairs' f32 FMA at 67
    TFLOP/s and their three TF32 passes at 495 TFLOP/s. The kernel runs the
    products in three TF32 passes, so its share is taken against the larger
    of the bytes and the TF32 bound (a share above 100% fails: the bound
    would be wrong). No local memory allowed (a spill), and two calls must
    agree bitwise."""
    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    attrs = fa.kernel_attributes(128)
    print(f"flash_attention head_dim 128 kernel: {attrs}", flush=True)
    if attrs["local_bytes"] != 0:
        raise AssertionError(f"flash_attention head_dim 128: {attrs['local_bytes']}"
                             " bytes of local memory a thread (a spill)")
    out = {"kernel_attributes": attrs}
    for label, (qs, ks) in GQA_FLASH.items():
        b, h, s, d = qs
        q = torch.randn(qs, generator=gen, device=dev)
        k, v = (torch.randn(ks, generator=gen, device=dev) for _ in range(2))
        row = {"shape": f"q [{b},{h},{s},{d}] k/v [{','.join(map(str, ks))}]"
                        " causal"}
        row["ms"] = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v))
        row["plain_ms"] = time_ms(torch, lambda: fa.attention_plain(q, k, v))
        row["library_ms"] = time_ms(torch, lambda: sdpa(
            q, k, v, is_causal=True, enable_gqa=True))
        row["device_ms"] = device_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v))
        row["library_device_ms"] = device_ms(torch, lambda: sdpa(
            q, k, v, is_causal=True, enable_gqa=True))
        pairs = b * h * fa.visible_pairs(s, s)
        row["bound_bytes_ms"] = (4.0 * (2 * q.numel() + 2 * k.numel())
                                 / HBM_BYTES_PER_S * 1e3)
        # per pair: q·k and p·v, 2d flops each (and the softmax's ≈ 3 in
        # f32); three TF32 passes of both products on the tensor cores
        row["bound_f32_ms"] = pairs * (4 * d + 3) / F32_FLOPS_PER_S * 1e3
        row["bound_tf32_ms"] = pairs * 3 * 4 * d / TF32_FLOPS_PER_S * 1e3
        by_bytes = row["bound_bytes_ms"] >= row["bound_tf32_ms"]
        row["bound_ms"] = max(row["bound_bytes_ms"], row["bound_tf32_ms"])
        row["bound_by"] = "bytes" if by_bytes else "operations (3xTF32)"
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        if row["share_of_bound"] > 1.0:
            raise AssertionError(f"flash_attention head_dim 128 {label}: "
                                 f"{row['device_ms']} ms is under its bound "
                                 f"{row['bound_ms']} ms")
        # a fixed order of sums and no atomics: two calls agree bitwise
        # (the scan engine's graph replay relies on it)
        if not torch.equal(fa.flash_attention_cuda(q, k, v),
                           fa.flash_attention_cuda(q, k, v)):
            raise AssertionError(f"flash_attention head_dim 128 {label}: "
                                 "two calls differ")
        row["bitwise_repeat"] = True
        print(f"flash_attention head_dim 128, {label} {row['shape']}: "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, SDPA "
              f"{row['library_ms']:.4f}); device time {row['device_ms']:.4f}"
              f" (SDPA {row['library_device_ms']:.4f}); bounds: bytes "
              f"{row['bound_bytes_ms']:.4f}, f32 FMA at 67 TFLOP/s "
              f"{row['bound_f32_ms']:.4f}, three TF32 passes at 495 TFLOP/s"
              f" {row['bound_tf32_ms']:.4f}; {100 * row['share_of_bound']:.1f}%"
              f" of the {row['bound_by']} bound", flush=True)
        out[label] = row
    return out


# the vlm and audio paths' training shapes (5 clients × batch 8): q, k/v
# and whether causal. whisper-medium's encoder self-attention over 1500
# frames and its cross-attention of 64 text queries on them (head_dim 64,
# the f32 FMA kernel), internvl2-76b's 256 patches and 64 tokens
# (head_dim 128, group 8, the tensor-core kernel)
FRONTEND_FLASH = {
    "whisper-medium encoder": ((40, 16, 1500, 64), (40, 16, 1500, 64),
                               False),
    "whisper-medium cross": ((40, 16, 64, 64), (40, 16, 1500, 64), False),
    "internvl2-76b train": ((40, 64, 320, 128), (40, 8, 320, 128), True)}


def flash_attention_frontends(torch, dev, gen) -> dict:
    """FRONTEND_FLASH's shapes, each held against the plain version within
    the flash gate (rtol = atol = 1e-5) at the batch the paths run, then
    timed beside it, SDPA (with `enable_gqa`) and its bound: the bytes at
    3.35 TB/s (q, k, v read and the output written once) against the
    visible pairs' two products in three TF32 passes at 495 TFLOP/s, which
    compute this f32 function within the same gate at every head dim (the
    f32 FMA count at 67 TFLOP/s, 4d + 3 a pair, is printed beside it). A
    share above 100% fails (the bound would be wrong), and two calls must
    agree bitwise."""
    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for label, (qs, ks, causal) in FRONTEND_FLASH.items():
        b, h, sq, d = qs
        skv = ks[2]
        q = torch.randn(qs, generator=gen, device=dev)
        k, v = (torch.randn(ks, generator=gen, device=dev) for _ in range(2))
        row = {"shape": f"q {list(qs)} k/v {list(ks)} "
                        + ("causal" if causal else "non-causal")}
        flash = lambda: fa.flash_attention_cuda(q, k, v, causal)  # noqa
        lib = lambda: sdpa(q, k, v, is_causal=causal,  # noqa: E731
                           enable_gqa=True)
        got, want = flash(), fa.attention_plain(q, k, v, causal)
        row["max_abs_err"] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"flash_attention {label}: max err "
                                 f"{row['max_abs_err']}")
        del got, want
        row["ms"] = time_ms(torch, flash)
        row["plain_ms"] = time_ms(torch, lambda: fa.attention_plain(
            q, k, v, causal))
        row["library_ms"] = time_ms(torch, lib)
        row["device_ms"] = device_ms(torch, flash)
        row["library_device_ms"] = device_ms(torch, lib)
        pairs = b * h * fa.visible_pairs(sq, skv, causal)
        row["bound_bytes_ms"] = (4.0 * (2 * q.numel() + 2 * k.numel())
                                 / HBM_BYTES_PER_S * 1e3)
        row["bound_f32_ms"] = pairs * (4 * d + 3) / F32_FLOPS_PER_S * 1e3
        row["bound_ops_ms"] = pairs * 3 * 4 * d / TF32_FLOPS_PER_S * 1e3
        by_bytes = row["bound_bytes_ms"] >= row["bound_ops_ms"]
        row["bound_ms"] = max(row["bound_bytes_ms"], row["bound_ops_ms"])
        row["bound_by"] = "bytes" if by_bytes else "operations (3xTF32)"
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        if row["share_of_bound"] > 1.0:
            raise AssertionError(f"flash_attention {label}: "
                                 f"{row['device_ms']} ms is under its bound "
                                 f"{row['bound_ms']} ms")
        if not torch.equal(flash(), flash()):
            raise AssertionError(f"flash_attention {label}: two calls "
                                 "differ")
        row["bitwise_repeat"] = True
        print(f"flash_attention {label}, {row['shape']}: max err against "
              f"plain {row['max_abs_err']:.3e}; {row['ms']:.4f} ms "
              f"(plain {row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f});"
              f" device time {row['device_ms']:.4f} (SDPA "
              f"{row['library_device_ms']:.4f}); bounds: bytes "
              f"{row['bound_bytes_ms']:.4f}, three TF32 passes at 495 "
              f"TFLOP/s {row['bound_ops_ms']:.4f} (f32 FMA at 67 TFLOP/s "
              f"{row['bound_f32_ms']:.4f}); "
              f"{100 * row['share_of_bound']:.1f}% of the {row['bound_by']}"
              " bound", flush=True)
        out[label] = row
    return out


# MLA's instances at the shapes of this slice's paths: the training forward
# (5 clients × batch 8 × seq 64) and the serve prefill (batch 4, prompt
# 32); q, k and v of one shape, causal
MLA_FLASH = {96: {"minicpm3-4b train": (40, 40, 64, 96),
                  "minicpm3-4b prefill": (4, 40, 32, 96)},
             192: {"deepseek-v2 train": (40, 128, 64, 192),
                   "deepseek-v2 prefill": (4, 128, 32, 192)}}


def flash_attention_mla(torch, dev, gen) -> dict:
    """The head_dim-96 and 192 instances (the tensor-core kernel) at
    MLA_FLASH's shapes, each timed beside the plain version, SDPA and the
    bound, with the instance's registers, local and shared memory; no
    local memory allowed (a spill), and two calls must agree bitwise. The
    scale is MLA's, 1/√D."""
    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for d, shapes in MLA_FLASH.items():
        attrs = fa.kernel_attributes(d)
        print(f"flash_attention head_dim {d} kernel: {attrs}", flush=True)
        if attrs["local_bytes"] != 0:
            raise AssertionError(f"flash_attention head_dim {d}: "
                                 f"{attrs['local_bytes']} bytes of local "
                                 "memory a thread (a spill)")
        rows = {"kernel_attributes": attrs}
        for label, shape in shapes.items():
            b, h, s, _ = shape
            q, k, v = (torch.randn(shape, generator=gen, device=dev)
                       for _ in range(3))
            row = {"shape": f"q/k/v [{b},{h},{s},{d}] causal"}
            row["ms"] = time_ms(torch, lambda: fa.flash_attention_cuda(
                q, k, v))
            row["plain_ms"] = time_ms(torch, lambda: fa.attention_plain(
                q, k, v))
            row["library_ms"] = time_ms(torch, lambda: sdpa(
                q, k, v, is_causal=True))
            row["device_ms"] = device_ms(torch, lambda: fa.flash_attention_cuda(
                q, k, v))
            row["library_device_ms"] = device_ms(torch, lambda: sdpa(
                q, k, v, is_causal=True))
            flops = b * h * fa.visible_pairs(s, s) * (4 * d + 3)
            row["bound_ms"], row["bound_by"] = bound_ms(4.0 * 4 * q.numel(),
                                                        flops)
            # a fixed order of sums and no atomics: two calls agree bitwise
            # (the scan engine's graph replay relies on it)
            if not torch.equal(fa.flash_attention_cuda(q, k, v),
                               fa.flash_attention_cuda(q, k, v)):
                raise AssertionError(f"flash_attention head_dim {d} {label}:"
                                     " two calls differ")
            row["bitwise_repeat"] = True
            print(f"flash_attention head_dim {d}, {label} {row['shape']}: "
                  f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, SDPA "
                  f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} by "
                  f"{row['bound_by']}; device time {row['device_ms']:.4f}, "
                  f"SDPA {row['library_device_ms']:.4f})", flush=True)
            rows[label] = row
        out[f"head_dim_{d}"] = rows
    return out


def check_perturbed_matmul(torch, dev) -> dict:
    """Against the plain version at every main-path (K, N) with M = 2560
    and at ragged and cluster-padded shapes, to max|Δ| ≤ 1e-5·max|ref|
    (f32 sums in another order); the identity probes bitwise against the
    seeded_axpy kernel."""
    from repro_torch.kernels import perturbed_matmul as pmm
    from repro_torch.kernels import seeded_axpy as sa

    gen = torch.Generator(device=dev).manual_seed(2)
    eps = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    cases = [(M_ROWS, k, n, 3 * k * n) for k, n in PMM_SHAPES]
    cases += [(37, 200, 300, 2**32 - 7777),        # ragged, wrapping off
              # M not a multiple of the cluster's rows; a long K at a small
              # M; N ragged with a wrapping off
              (M_ROWS + 37, 768, 768, 11 * 768 * 768),
              (300, 3072, 768, 5 * 3072 * 768),
              (640, 768, 300, 2**32 - 4242)]
    max_err = max_rel = 0.0
    for m, k, n, off in cases:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        got = pmm.perturbed_matmul_cuda(x, w, sa.seed_tensor(55, dev), off,
                                        eps)
        want = pmm.perturbed_matmul_plain(x, w, 55, off, eps)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ref = float(want.abs().max())
        if not err <= 1e-5 * ref:
            raise AssertionError(f"perturbed_matmul [{m},{k}]x[{k},{n}]: max "
                                 f"err {err} > 1e-5 x {ref}")
        max_err, max_rel = max(max_err, err), max(max_rel, err / ref)
    probes = ((768, 768, 5 * 768 * 768), (200, 300, 2**32 - 7777),
              (3072, 768, 7 * 3072 * 768))
    for k, n, off in probes:
        w = torch.randn((k, n), generator=gen, device=dev)
        s66 = sa.seed_tensor(66, dev)
        probe = pmm.perturbed_matmul_cuda(torch.eye(k, device=dev), w, s66,
                                          off, eps)
        axpy = sa.seeded_axpy_cuda(w, s66, eps, torch.empty_like(w), off)
        require_equal(torch, probe, axpy,
                      f"perturbed_matmul identity probe [{k},{n}]")
    print(f"perturbed_matmul: {len(cases)} cases ok, max err {max_err:.3e}"
          f", max |err|/max|ref| {max_rel:.3e}; {len(probes)} identity "
          "probes bitwise", flush=True)

    # one OPT-125M layer's seven projections at M = 2560
    x = {k: torch.randn((M_ROWS, k), generator=gen, device=dev)
         for k in (768, 3072)}
    ws = [torch.randn(s, generator=gen, device=dev) for s in PMM_LAYER]
    s7 = sa.seed_tensor(7, dev)
    resolved = [sa.seeded_axpy_cuda(w, s7, eps, torch.empty_like(w), 0)
                for w in ws]
    per_shape, per_shape_lib = {}, {}
    for (k, n) in PMM_SHAPES:
        i = PMM_LAYER.index((k, n))
        per_shape[f"{k}x{n}"] = time_ms(
            torch, lambda: pmm.perturbed_matmul_cuda(x[k], ws[i], s7, 0, eps))
        per_shape_lib[f"{k}x{n}"] = time_ms(
            torch, lambda: torch.matmul(x[k], resolved[i]))
    ms = time_ms(torch, lambda: [pmm.perturbed_matmul_cuda(
        x[w.shape[0]], w, s7, 0, eps) for w in ws])
    plain_ms = time_ms(torch, lambda: [pmm.perturbed_matmul_plain(
        x[w.shape[0]], w, 7, 0, eps) for w in ws])
    library_ms = time_ms(torch, lambda: [torch.matmul(x[w.shape[0]], r)
                                         for w, r in zip(ws, resolved)])
    dev_ms = device_ms(torch, lambda: [pmm.perturbed_matmul_cuda(
        x[w.shape[0]], w, s7, 0, eps) for w in ws], reps=5)
    lib_dev_ms = device_ms(torch, lambda: [torch.matmul(x[w.shape[0]], r)
                                           for w, r in zip(ws, resolved)],
                           reps=5)
    # the same layer at M = BM·C rows (z drawn once per weight) beside
    # cuBLAS there
    m_one = pmm.BM[torch.float32] * pmm.CLUSTER[torch.float32]
    one_ms = time_ms(torch, lambda: [pmm.perturbed_matmul_cuda(
        x[w.shape[0]][:m_one], w, s7, 0, eps) for w in ws])
    one_lib = time_ms(torch, lambda: [torch.matmul(x[w.shape[0]][:m_one], r)
                                      for w, r in zip(ws, resolved)])
    attrs = {f"{k}x{n}": pmm.kernel_attributes(M_ROWS, n)
             for k, n in PMM_SHAPES}
    flops = sum(2.0 * M_ROWS * k * n for k, n in PMM_LAYER)
    n_bytes = sum(4.0 * (M_ROWS * k + k * n + M_ROWS * n)
                  for k, n in PMM_LAYER)
    b_ms, b_by = bound_ms(n_bytes, flops)
    draws = M_ROWS / m_one
    print(f"perturbed_matmul per call at M={M_ROWS}: "
          + ", ".join(f"{s} {t:.4f} ms (cuBLAS {per_shape_lib[s]:.4f})"
                      for s, t in per_shape.items())
          + f"; one layer's 7 {ms:.4f} ms, plain {plain_ms:.4f} ms, cuBLAS "
          f"SGEMM on resolved weights {library_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s); device time "
          f"{dev_ms:.4f} ms, cuBLAS {lib_dev_ms:.4f} ms", flush=True)
    print(f"perturbed_matmul one layer's 7 at M={m_one} (one draw per "
          f"weight): {one_ms:.4f} ms, cuBLAS {one_lib:.4f} ms", flush=True)
    for s, a in attrs.items():
        print(f"perturbed_matmul kernel at {M_ROWS}x{s}: {a}", flush=True)
    return {"name": "perturbed_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/perturbed_matmul.cu",
            "replaces": "src/repro/kernels/perturbed_matmul.py:71",
            "max_abs_err": max_err, "max_rel_err": max_rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "library": "torch.matmul (cuBLAS SGEMM) on resolved w + eps*z",
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
            "per_call_ms": per_shape, "per_call_library_ms": per_shape_lib,
            "cluster": pmm.CLUSTER[torch.float32], "draws_per_weight": draws,
            "one_draw_rows": m_one,
            "one_draw_ms": one_ms, "one_draw_library_ms": one_lib,
            "kernel_attributes": attrs,
            "shape": f"one OPT-125M layer's 7 projections at M={M_ROWS}"}


def ssd_inputs(torch, dev, gen, bsz, s, h, p, n, with_state):
    x = torch.randn((bsz, s, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((bsz, s, h), generator=gen, device=dev))
    a = -torch.exp(0.5 * torch.randn(h, generator=gen, device=dev))
    b = 0.5 * torch.randn((bsz, s, n), generator=gen, device=dev)
    c = 0.5 * torch.randn((bsz, s, n), generator=gen, device=dev)
    s0 = (torch.randn((bsz, h, p, n), generator=gen, device=dev)
          if with_state else None)
    return x, dt, a, b, c, s0


def time_cold_ms(torch, fn, reps: int = 15) -> float:
    """Median CUDA-event time of one call of fn with the L2 flushed before
    each (a 256 MB write, outside the timed span; it also hides the host's
    launch overhead, so this is the device's time with inputs cold)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_ssd_scan(torch, dev) -> dict:
    """Both entries against `ssd_plain`, to max|Δ| ≤ 2e-5·max|ref| (f32
    sums in another order): y in every case, the final state from the
    stateful entry; the y-only entry returns no state. Then both timed at
    the main shape, warm and with the L2 flushed, beside their bounds."""
    from repro_torch.kernels import ssd_scan

    gen = torch.Generator(device=dev).manual_seed(3)
    main = (40, 64, 32, 64, 128, 64, False)        # full mamba2-370m
    cases = [main,
             (2, 512, 4, 64, 128, 256, True),      # chunk 256, two chunks
             (3, 48, 8, 16, 16, 48, True),         # the tiny run's widths
             # zero state skipped on chunk 0, carried into chunk 1
             (2, 512, 4, 64, 128, 256, False),
             (2, 128, 5, 32, 64, 64, True)]        # odd H, narrow widths
    max_err = max_rel = 0.0
    for bsz, s, h, p, n, chunk, st in cases:
        args = ssd_inputs(torch, dev, gen, bsz, s, h, p, n, st)
        y, state = ssd_scan.ssd_scan_cuda(*args, chunk)
        y1, none = ssd_scan.ssd_scan_cuda(*args, chunk, want_state=False)
        y_ref, state_ref = ssd_scan.ssd_plain(*args, chunk)
        torch.cuda.synchronize()
        if none is not None:
            raise AssertionError("ssd_scan y-only entry returned a state")
        for name, got, want in (("y", y, y_ref), ("state", state, state_ref),
                                ("y (y-only entry)", y1, y_ref)):
            err = float((got - want).abs().max())
            ref = float(want.abs().max())
            if not err <= 2e-5 * ref:
                raise AssertionError(f"ssd_scan {name} B{bsz} S{s} H{h} P{p} "
                                     f"N{n} chunk {chunk}: max err {err} > "
                                     f"2e-5 x {ref}")
            max_err, max_rel = max(max_err, err), max(max_rel, err / ref)
    print(f"ssd_scan: {len(cases)} cases ok (both entries' y, the stateful "
          f"entry's final state), max err {max_err:.3e}, max |err|/max|ref| "
          f"{max_rel:.3e}", flush=True)

    bsz, s, h, p, n, chunk, _ = main
    args = ssd_inputs(torch, dev, gen, bsz, s, h, p, n, False)
    entries = {"y_only": lambda: ssd_scan.ssd_scan_cuda(
                   *args, chunk, want_state=False),
               "stateful": lambda: ssd_scan.ssd_scan_cuda(*args, chunk)}
    out = {}
    for name, fn in entries.items():
        b_ms, b_by = bound_ms(*ssd_scan.work(
            bsz, s, h, p, n, chunk, False, name == "stateful"))
        out[name] = {"ms": time_ms(torch, fn), "cold_ms": time_cold_ms(
            torch, fn), "device_span_ms": device_span_ms(torch, fn),
            "bound_ms": b_ms, "bound_by": b_by}
    plain_ms = time_ms(torch, lambda: ssd_scan.ssd_plain(*args, chunk))
    attrs = ssd_scan.kernel_attributes(chunk)
    for name, row in out.items():
        print(f"ssd_scan {name} B{bsz} S{s} H{h} P{p} N{n} chunk {chunk}: "
              f"{row['ms']:.4f} ms warm, {row['cold_ms']:.4f} ms L2 flushed, "
              f"device span {row['device_span_ms']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']}", flush=True)
    print(f"ssd_scan plain {plain_ms:.4f} ms", flush=True)
    for name, a in attrs.items():
        print(f"ssd_scan kernel {name} at chunk {chunk}: {a}", flush=True)
    serve, serve_err = ssd_scan_serve_shapes(torch, dev, gen)
    max_err = max(max_err, serve_err)
    y_only = out["y_only"]
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:82",
            "max_abs_err": max_err, "max_rel_err": max_rel,
            "ms": y_only["ms"], "plain_ms": plain_ms,
            "bound_ms": y_only["bound_ms"], "bound_by": y_only["bound_by"],
            "library_ms": None, "device_span_ms": y_only["device_span_ms"],
            "cold_ms": y_only["cold_ms"], "stateful": out["stateful"],
            "kernel_attributes": attrs, "serve": serve,
            "shape": f"B{bsz} S{s} H{h} P{p} N{n} chunk {chunk}, y only "
                     "(the training call); `stateful` returns the state"}


def ssd_scan_serve_shapes(torch, dev, gen) -> tuple:
    """The stateful entry at the mamba2-370m serve shapes: the prefill of
    a 32-token prompt (chunk 32) and the 48-token teacher-forced forward's
    length (chunk 48), batch 4, no state0; y and the final state against
    `ssd_plain` to 2e-5·max|ref|, then timed beside the plain version and
    the bound. Returns (rows, max abs err)."""
    from repro_torch.kernels import ssd_scan

    bsz, h, p, n = 4, 32, 64, 128
    out, max_err = {}, 0.0
    for s in (32, 48):
        args = ssd_inputs(torch, dev, gen, bsz, s, h, p, n, False)
        y, state = ssd_scan.ssd_scan_cuda(*args, s)
        y_ref, state_ref = ssd_scan.ssd_plain(*args, s)
        torch.cuda.synchronize()
        for name, got, want in (("y", y, y_ref), ("state", state, state_ref)):
            err = float((got - want).abs().max())
            ref = float(want.abs().max())
            if not err <= 2e-5 * ref:
                raise AssertionError(f"ssd_scan stateful {name} B{bsz} S{s} "
                                     f"chunk {s}: max err {err} > 2e-5 x "
                                     f"{ref}")
            max_err = max(max_err, err)
        fn = lambda: ssd_scan.ssd_scan_cuda(*args, s)  # noqa: E731
        b_ms, b_by = bound_ms(*ssd_scan.work(bsz, s, h, p, n, s, False, True))
        row = {"ms": time_ms(torch, fn), "device_span_ms": device_span_ms(
            torch, fn), "plain_ms": time_ms(
            torch, lambda: ssd_scan.ssd_plain(*args, s)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": f"B{bsz} S{s} H{h} P{p} N{n} chunk {s}, stateful"}
        print(f"ssd_scan stateful {row['shape']}: ok vs plain; {row['ms']:.4f}"
              f" ms warm, device span {row['device_span_ms']:.4f} ms (plain "
              f"{row['plain_ms']:.4f}, bound {b_ms:.4f} by {b_by})",
              flush=True)
        out[f"chunk_{s}"] = row
    return out, max_err


def check_rglru_scan(torch, dev) -> dict:
    """Bitwise against `linear_recurrence_plain` (both round a multiply,
    then an add, per step) at the main shape with h0 zero and random, a
    ragged shape and S = 1."""
    from repro_torch.kernels import rglru_scan

    gen = torch.Generator(device=dev).manual_seed(4)
    main = (40, 64, 2560)                       # full recurrentgemma-2b
    cases = [(main, False), (main, True), ((3, 37, 200), True),
             ((5, 1, 96), True), ((4, 1, 2560), True)]
    for (bsz, s, d), with_h0 in cases:
        # the hybrid's gate: a = exp(-8·softplus(2)·σ(r)) in (0, 1)
        a = torch.exp(-8.0 * 2.127 * torch.sigmoid(
            torch.randn((bsz, s, d), generator=gen, device=dev)))
        x = torch.randn((bsz, s, d), generator=gen, device=dev)
        h0 = (torch.randn((bsz, d), generator=gen, device=dev)
              if with_h0 else None)
        hs, last = rglru_scan.rglru_scan_cuda(a, x, h0)
        hs_ref, last_ref = rglru_scan.linear_recurrence_plain(a, x, h0)
        require_equal(torch, hs, hs_ref, f"rglru_scan hs [{bsz},{s},{d}]")
        require_equal(torch, last, last_ref,
                      f"rglru_scan h_last [{bsz},{s},{d}]")
    print(f"rglru_scan: {len(cases)} cases bitwise (hs and h_last)",
          flush=True)

    bsz, s, d = main
    a = torch.rand((bsz, s, d), generator=gen, device=dev)
    x = torch.randn((bsz, s, d), generator=gen, device=dev)
    ms = time_ms(torch, lambda: rglru_scan.rglru_scan_cuda(a, x))
    dev_ms = device_ms(torch, lambda: rglru_scan.rglru_scan_cuda(a, x))
    plain_ms = time_ms(torch, lambda: rglru_scan.linear_recurrence_plain(
        a, x))
    # a, x read and hs written once, h_last written; a multiply and an add
    b_ms, b_by = bound_ms(4.0 * (3 * bsz * s * d + bsz * d),
                          2.0 * bsz * s * d)
    print(f"rglru_scan: [{bsz},{s},{d}] {ms:.4f} ms (plain {plain_ms:.4f}, "
          f"bound {b_ms:.4f} by {b_by}; device time {dev_ms:.4f})",
          flush=True)
    # one decode step of recurrentgemma-2b's serve path: S = 1 from h0
    a1 = torch.rand((4, 1, d), generator=gen, device=dev)
    x1 = torch.randn((4, 1, d), generator=gen, device=dev)
    h1 = torch.randn((4, d), generator=gen, device=dev)
    step = {"ms": time_ms(torch, lambda: rglru_scan.rglru_scan_cuda(
                a1, x1, h1)),
            "device_ms": device_ms(torch, lambda: rglru_scan.rglru_scan_cuda(
                a1, x1, h1)),
            "plain_ms": time_ms(torch, lambda: rglru_scan
                                .linear_recurrence_plain(a1, x1, h1)),
            "library_ms": None, "shape": f"a, x [4,1,{d}], h0 [4,{d}]"}
    # a, x, h0 read, hs and h_last written
    step["bound_ms"], step["bound_by"] = bound_ms(4.0 * 5 * 4 * d,
                                                  2.0 * 4 * d)
    print(f"rglru_scan decode step {step['shape']}: {step['ms']:.4f} ms "
          f"(plain {step['plain_ms']:.4f}, bound {step['bound_ms']:.6f} by "
          f"{step['bound_by']}; device time {step['device_ms']:.4f})",
          flush=True)
    return {"name": "rglru_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan.py:52",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_ms": dev_ms, "shape": f"a, x [{bsz},{s},{d}], h0 zero",
            "decode_step": step}


# ---------------------------------------------------------------------------
# bf16 (ROADMAP A12's first part)
# ---------------------------------------------------------------------------

BF16_FLASH = {  # (q, k/v, causal, window) the bf16 instances are held on
    "OPT-125M train": ((40, 12, 64, 64), (40, 12, 64, 64), True, None),
    "yi-6b prefill": ((4, 32, 32, 128), (4, 4, 32, 128), True, None),
    "GQA window Sq<Skv": ((2, 8, 48, 64), (2, 2, 80, 64), True, 32),
    "Skv over tiles": ((2, 12, 37, 64), (2, 4, 300, 64), True, 64),
    "head_dim 32 non-causal": ((3, 4, 150, 32), (3, 4, 150, 32), False, None),
    "head_dim 16": ((3, 4, 33, 16), (3, 4, 33, 16), False, None),
    "128 ragged": ((2, 4, 37, 128), (2, 4, 37, 128), True, None),
    "128 over 300 keys": ((2, 4, 70, 128), (2, 2, 300, 128), True, None),
    "128 window 1": ((2, 4, 64, 128), (2, 4, 64, 128), True, 1),
    "128 one query": ((2, 10, 1, 128), (2, 1, 70, 128), True, None),
    "96 padded to 128": ((2, 4, 37, 96), (2, 4, 37, 96), True, None),
    # a 2048-token prompt at 128, and whisper-medium's encoder and its
    # cross-attention of 64 text queries on 1500 frames at 64 (A12 item 3)
    "2048-token prompt": ((1, 32, 2048, 128), (1, 4, 2048, 128), True, None),
    "whisper encoder": ((40, 16, 1500, 64), (40, 16, 1500, 64), False, None),
    "whisper cross": ((40, 16, 64, 64), (40, 16, 1500, 64), False, None),
}
# the cases timed beside SDPA in bf16 and the bound: the bf16 paths'
# training shape, yi-6b's prefill, and the three above
BF16_FLASH_TIMED = ("OPT-125M train", "yi-6b prefill", "2048-token prompt",
                    "whisper encoder", "whisper cross")
BF16_PATHS = ("bf16", "bf16-fused")
BF16_SERVE_ARCHS = ("opt-125m", "yi-6b")
# a bf16 serve's keys in the `bf16` JSON line: times, peaks, and each
# logits check's reading beside its control
BF16_SERVE_KEYS = ("prefill_ms", "decode_ms", "peak_theta", "theta_mb",
                   "attention_ulp", "plain_rel_err", "plain_control_rel",
                   "decode_vs_forward_rel", "decode_control_rel")
# at most this share of a bf16 seeded_axpy / gather pass may differ from
# the plain version, by 1 bf16 ulp: z agrees to a few f32 ulp, which moves
# the rounding of w + scale·z only where it sits that close to a bf16
# midpoint (bitwise expected: the card's plain z is the kernel's)
BF16_AXPY_SHARE = 1e-5
# decode ≡ forward and the kernels' prefill against the plain versions in
# bf16, as a share of the logits' largest magnitude: each attention call
# is within one bf16 ulp of its f32 result (`kernels_checked`), but the two
# sides round other sums in other orders, and each later bf16 rounding
# carries a flip up to a whole ulp. On the H100 they read 1.12e-2 to
# 1.78e-2 (opt-125m, yi-6b); the controls, the causal mask flipped and
# decode's cache position off by one, 0.191 to 1.25
BF16_LOGITS_TOL = 0.05
# the bf16-fused path's dual forward from its trained weights against the
# plain versions rounded where the kernels round: each kernel call is
# within one bf16 ulp of its f32 result, but an f32 sum's order that flips
# one bf16 rounding is carried up to a whole ulp by every later rounding,
# and the trained weights amplify it (losses 32-44): 6.96e-3 on the H100,
# where the controls read 2.24e-2 (w + eps·z rounded to bf16) and 5.37e-2
# (f32 throughout)
BF16_FUSED_RTOL = 1.2e-2
# the impl="xla" check: the chained f32 round on the plain versions against
# the kernels' (attention within its 1e-5 gate, the axpys bitwise)
IMPL_ROUNDS = 2
IMPL_RTOL = 1e-4


def bf16_ulp(torch, x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def within_bf16_ulp(torch, got, ref, what: str) -> float:
    """A bf16 result against the f32 value it rounds: within one bf16 ulp
    of |ref|, or where a sum cancels toward zero of max|ref| / 256 (the
    f32 terms are as large as the largest outputs). Returns the largest
    error in those ulps; raises above 1."""
    torch.cuda.synchronize()
    ref = ref.float()
    tol = bf16_ulp(torch, torch.clamp_min(ref.abs(),
                                          float(ref.abs().max()) / 256))
    worst = float(((got.float() - ref).abs() / tol).max())
    if not worst <= 1.0:
        raise AssertionError(f"{what}: {worst:.3f} bf16 ulp from the f32 "
                             "result")
    return worst


def bf16_axpy_match(torch, got, want, what: str) -> tuple:
    """Bitwise, or 1 bf16 ulp apart on at most BF16_AXPY_SHARE of the
    elements; returns the share that differs and the largest |got − want|."""
    torch.cuda.synchronize()
    differ = got != want
    share = float(differ.float().mean())
    if share == 0.0:
        return 0.0, 0.0
    gap = (got.float() - want.float()).abs()[differ]
    if share > BF16_AXPY_SHARE or bool(
            (gap > bf16_ulp(torch, want[differ])).any()):
        raise AssertionError(f"{what}: {share:.3e} of the elements differ "
                             f"(max {float(gap.max())})")
    return share, float(gap.max())


def check_bf16_kernels(torch, dev) -> list:
    """Each bf16 instance against its plain version on the card at the bf16
    paths' shapes, with the stated gates, then timed beside the plain
    version, a library call and its bound. seeded_axpy_bf16 and
    seeded_gather_bf16 against the plain bf16 version (BF16_AXPY_SHARE);
    flash_attention's bf16 kernel (Q·Kᵀ in one bf16 pass, P in two bf16
    pieces) within one bf16 ulp of the f32 result (the plain version on the
    same inputs widened), no local memory, two calls bitwise, timed at
    BF16_FLASH_TIMED's shapes; perturbed_matmul_bf16 (three bf16 pieces on the tensor
    cores) within one bf16 ulp of the f32 result (w + eps·z in f32, as the
    kernel) in every x-copy path (K % 8 == 0, K % 8 == 4, ragged K), its
    identity probes bitwise against seeded_axpy_bf16, one of them on
    w + eps·z near 2^-112 whose lo pieces are subnormal."""
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import zo
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import perturbed_matmul as pmm
    from repro_torch.kernels import seeded_axpy as sa
    from repro_torch.models import registry

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(30)
    seed_t = lambda v: sa.seed_tensor(v, dev)  # noqa: E731
    scale = torch.tensor(-3e-3, dtype=torch.float32, device=dev)
    cfg = get_arch("opt-125m")
    rows = []

    # seeded_axpy_bf16: every OPT-125M leaf shape, a ragged leaf, a view
    # at an odd element (the scalar path), layer slices, in place
    shapes = list(registry.shapes(cfg)) + [(1_000_003,)]
    worst = err = 0.0
    for i, shape in enumerate(shapes):
        w = torch.randn(shape, generator=gen, device=dev).to(bf16)
        seed = zo.leaf_seed(0xB16, i)
        got = sa.seeded_axpy_cuda(w, seed_t(seed), scale, torch.empty_like(w))
        want = sa.seeded_axpy_plain(w, seed, scale)
        share, gap = bf16_axpy_match(torch, got, want,
                                     f"seeded_axpy_bf16 {shape}")
        worst, err = max(worst, share), max(err, gap)
        if len(shape) == 3:
            off = shape[1] * shape[2]
            sl = sa.seeded_axpy_cuda(w[1], seed_t(seed), scale,
                                     torch.empty_like(w[1]), off)
            require_equal(torch, sl, got[1], f"seeded_axpy_bf16 {shape} "
                          "layer slice")
        sa.seeded_axpy_cuda(w, seed_t(seed), scale, w)
        require_equal(torch, w, got, f"seeded_axpy_bf16 {shape} in place")
    w = torch.randn(4097, generator=gen, device=dev).to(bf16)[1:]
    share, gap = bf16_axpy_match(
        torch, sa.seeded_axpy_cuda(w, seed_t(3), scale, torch.empty_like(w),
                                   17),
        sa.seeded_axpy_plain(w, 3, scale, 17), "seeded_axpy_bf16 odd view")
    worst, err = max(worst, share), max(err, gap)
    # one bf16 θ pass over full OPT-125M, as `zo.perturb` runs it
    params = registry.init_params(cfg, prng.key(0), dev, bf16)
    leaves = [t for _, t in zo.flatten(params)]
    n_total = sum(t.numel() for t in leaves)
    row_seeds = zo.seed_row(1234, len(leaves), dev)
    ms = time_ms(torch, lambda: zo.perturb(params, row_seeds, scale,
                                           inplace=True))
    plain_ms = time_ms(torch, lambda: [sa.seeded_axpy_plain(t, 9, scale)
                                       for t in leaves], warmup=1, reps=3)
    b_ms, b_by = bound_ms(4.0 * n_total, 12.0 * n_total)
    del params, leaves
    torch.cuda.empty_cache()
    sass = sass_path_instructions("seeded_axpy", (
        "axpy_kernelI13__nv_bfloat16", "gather_kernelI13__nv_bfloat16"))
    per_el = sass["axpy_kernelI13__nv_bfloat16"] / 4
    issue = issue_bound_ms(torch, per_el, n_total)
    print(f"seeded_axpy_bf16: {len(shapes)} shapes, an odd view, layer "
          f"slices and in place; {worst:.3e} of the elements differ from "
          f"plain (gate {BF16_AXPY_SHARE}), by at most {err}; one bf16 "
          f"theta pass {ms:.4f} ms (plain {plain_ms:.4f}), byte bound {b_ms:.4f} ms, "
          f"issue bound {issue:.4f} ms ({per_el:.1f} SASS instructions an "
          f"element, {sass} a thread)", flush=True)
    rows.append({"name": "seeded_axpy_bf16", "counter": "seeded_axpy",
                 "dtype": "bfloat16", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/seeded_axpy.cu",
                 "replaces": "src/repro/kernels/seeded_axpy.py:83",
                 "max_abs_err": err, "share_differ": worst, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": max(b_ms, issue),
                 "bound_by": "issue" if issue > b_ms else b_by,
                 "byte_bound_ms": b_ms, "issue_bound_ms": issue,
                 "library_ms": None,
                 "sass_instructions_per_element": per_el,
                 "shape": f"one bf16 θ pass, {n_total} elements in 12 "
                          "leaves"})

    # seeded_gather_bf16: the fused path's [40, 64] rows of the bf16 table
    table = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        device=dev).to(bf16)
    tokens = torch.randint(0, cfg.vocab_size, (40, 64), generator=gen,
                           device=dev)
    eps = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    got = sa.seeded_gather_cuda(table, tokens, seed_t(4321), eps)
    g_share, g_err = bf16_axpy_match(torch, got, sa.seeded_gather_plain(
        table, tokens, 4321, eps), "seeded_gather_bf16")
    whole = sa.seeded_axpy_cuda(table, seed_t(4321), eps,
                                torch.empty_like(table))
    require_equal(torch, got, whole[tokens], "seeded_gather_bf16 vs rows")
    one = seed_t(1)
    g_ms = time_ms(torch, lambda: sa.seeded_gather_cuda(table, tokens, one,
                                                        eps))
    g_plain = time_ms(torch, lambda: sa.seeded_gather_plain(table, tokens, 1,
                                                            eps))
    g_dev = device_ms(torch, lambda: sa.seeded_gather_cuda(table, tokens,
                                                           one, eps))
    n_el = tokens.numel() * cfg.d_model
    gb_ms, gb_by = bound_ms(4.0 * n_el + 8 * tokens.numel(), 12.0 * n_el)
    g_issue = issue_bound_ms(torch, float(
        sass["gather_kernelI13__nv_bfloat16"]), n_el)
    print(f"seeded_gather_bf16: [40,64] rows, {g_share:.3e} differ from "
          f"plain (by at most {g_err}), bitwise the whole-table pass's "
          f"rows; {g_ms:.4f} ms, device time {g_dev:.4f} ms (plain {g_plain:.4f}), byte bound "
          f"{gb_ms:.6f} ms, issue bound {g_issue:.6f} ms", flush=True)
    rows.append({"name": "seeded_gather_bf16", "counter": "seeded_gather",
                 "dtype": "bfloat16", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/seeded_axpy.cu",
                 "replaces": "src/repro/kernels/seeded_axpy.py:83",
                 "max_abs_err": g_err, "share_differ": g_share, "ms": g_ms,
                 "device_ms": g_dev, "plain_ms": g_plain,
                 "bound_ms": max(gb_ms, g_issue),
                 "bound_by": "issue" if g_issue > gb_ms else gb_by,
                 "byte_bound_ms": gb_ms, "issue_bound_ms": g_issue,
                 "library_ms": None,
                 "shape": "[40,64] tokens of a bf16 [50272,768] table"})
    del table, whole, got

    # flash_attention's bf16 instances: flash_fwd_bf16_kernel<d>
    attrs = {d: fa.kernel_attributes(d, bf16) for d in fa.BF16_HEAD_DIMS}
    for d, a in attrs.items():
        print(f"flash_attention bf16 head_dim {d} kernel: {a}", flush=True)
        if a["local_bytes"] != 0:
            raise AssertionError(f"flash_attention bf16 head_dim {d}: "
                                 f"{a['local_bytes']} bytes of local memory")
    f_worst = 0.0
    timed = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, (qs, ks, causal, window) in BF16_FLASH.items():
        q = torch.randn(qs, generator=gen, device=dev).to(bf16)
        k, v = (torch.randn(ks, generator=gen, device=dev).to(bf16)
                for _ in range(2))
        got = fa.flash_attention_cuda(q, k, v, causal, window)
        if got.dtype != bf16:
            raise AssertionError(f"flash_attention bf16 {label}: {got.dtype}")
        ref = fa.attention_plain(q.float(), k.float(), v.float(), causal,
                                 window)
        f_worst = max(f_worst, within_bf16_ulp(
            torch, got, ref, f"flash_attention bf16 {label}"))
        if not torch.equal(got, fa.flash_attention_cuda(q, k, v, causal,
                                                        window)):
            raise AssertionError(f"flash_attention bf16 {label}: two calls "
                                 "differ")
        del got, ref
        if label not in BF16_FLASH_TIMED:
            continue
        b, h, s, d = qs
        row = {"shape": f"q [{','.join(map(str, qs))}] k/v "
                        f"[{','.join(map(str, ks))}] "
                        + ("causal" if causal else "non-causal")}
        flash = lambda: fa.flash_attention_cuda(q, k, v, causal)  # noqa
        lib = lambda: sdpa(q, k, v, is_causal=causal,  # noqa: E731
                           enable_gqa=ks[1] != qs[1])
        plain = lambda: fa.attention_plain(q, k, v, causal)  # noqa: E731
        row["ms"] = time_ms(torch, flash)
        row["plain_ms"] = time_ms(torch, plain)
        row["device_ms"] = device_ms(torch, flash)
        row["library_ms"] = time_ms(torch, lib)
        row["library_device_ms"] = device_ms(torch, lib)
        # bytes: q, k, v read and the output written once; operations: the
        # kernel's passes on each visible pair, Q K^T in one (2d flops)
        # and P V in two (4d), at bf16's rate
        pairs = b * h * fa.visible_pairs(s, ks[2], causal)
        row["bound_bytes_ms"] = (2.0 * (2 * q.numel() + 2 * k.numel())
                                 / HBM_BYTES_PER_S * 1e3)
        row["bound_ops_ms"] = pairs * 6 * d / BF16_FLOPS_PER_S * 1e3
        by_bytes = row["bound_bytes_ms"] >= row["bound_ops_ms"]
        row["bound_ms"] = max(row["bound_bytes_ms"], row["bound_ops_ms"])
        row["bound_by"] = "bytes" if by_bytes else "operations"
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        if row["share_of_bound"] > 1.0:
            raise AssertionError(f"flash_attention bf16 {label}: "
                                 f"{row['device_ms']} ms is under its bound "
                                 f"{row['bound_ms']} ms")
        print(f"flash_attention bf16 {label} {row['shape']}: "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, SDPA in "
              f"bf16 {row['library_ms']:.4f}: P rounded to bf16 before P·V, "
              f"another function); device time {row['device_ms']:.4f} "
              f"(SDPA {row['library_device_ms']:.4f}); bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']} (bytes "
              f"{row['bound_bytes_ms']:.5f}, bf16 operations "
              f"{row['bound_ops_ms']:.5f}), {100 * row['share_of_bound']:.1f}"
              "% of it", flush=True)
        timed[label] = row
    print(f"flash_attention bf16: {len(BF16_FLASH)} cases within "
          f"{f_worst:.3f} bf16 ulp of the f32 result, two calls bitwise",
          flush=True)
    main = timed["OPT-125M train"]
    rows.append({"name": "flash_attention_bf16", "counter": "flash_attention",
                 "dtype": "bfloat16", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:104",
                 "max_abs_err": f_worst, "max_err_unit": "bf16 ulp of the "
                 "f32 result", **{k: main[k] for k in (
                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "device_ms", "library_device_ms", "share_of_bound",
                     "shape")},
                 "library": "SDPA in bf16 (P rounded to bf16 before P.V: "
                            "another function)",
                 **{label: timed[label] for label in BF16_FLASH_TIMED[1:]},
                 "kernel_attributes": attrs})

    # perturbed_matmul_bf16: the fused path's 7 projections at M = 2560
    cases = [(M_ROWS, k, n, 3 * k * n) for k, n in PMM_SHAPES]
    cases += [(37, 200, 300, 2**32 - 7777), (M_ROWS + 37, 768, 768, 0),
              (300, 3072, 768, 5 * 3072 * 768),
              # K % 8 == 4: the x tile's 8-byte copies
              (300, 772, 640, 123457)]
    p_worst = 0.0
    for m, k, n, off in cases:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(bf16)
        got = pmm.perturbed_matmul_cuda(x, w, seed_t(55), off, eps)
        ref = pmm.perturbed_matmul_plain(x.float(), w.float(), 55, off, eps)
        p_worst = max(p_worst, within_bf16_ulp(
            torch, got, ref, f"perturbed_matmul_bf16 [{m},{k}]x[{k},{n}]"))
    # a ragged K: the bf16 x tile's element-by-element copies
    x = torch.randn((130, 203), generator=gen, device=dev).to(bf16)
    w = torch.randn((203, 130), generator=gen, device=dev).to(bf16)
    p_worst = max(p_worst, within_bf16_ulp(
        torch, pmm.perturbed_matmul_cuda(x, w, seed_t(8), 0, eps),
        pmm.perturbed_matmul_plain(x.float(), w.float(), 8, 0, eps),
        "perturbed_matmul_bf16 ragged K"))
    for k, n, off in ((768, 768, 5 * 768 * 768), (3072, 768, 0)):
        w = torch.randn((k, n), generator=gen, device=dev).to(bf16)
        probe = pmm.perturbed_matmul_cuda(
            torch.eye(k, device=dev, dtype=bf16), w, seed_t(66), off, eps)
        require_equal(torch, probe, sa.seeded_axpy_cuda(
            w, seed_t(66), eps, torch.empty_like(w), off),
            f"perturbed_matmul_bf16 identity probe [{k},{n}]")
    # the identity probe on w + eps·z near 2^-112, whose lo pieces fall
    # below 2^-126 (subnormal, or past bf16's last bit at 2^-133)
    tiny = torch.tensor(2.0 ** -113, dtype=torch.float32, device=dev)
    w = (torch.randn((768, 768), generator=gen, device=dev)
         * 2.0 ** -112).to(bf16)
    probe = pmm.perturbed_matmul_cuda(
        torch.eye(768, device=dev, dtype=bf16), w, seed_t(67), 99, tiny)
    require_equal(torch, probe, sa.seeded_axpy_cuda(
        w, seed_t(67), tiny, torch.empty_like(w), 99),
        "perturbed_matmul_bf16 identity probe, subnormal lo pieces")
    v = sa.seeded_axpy_cuda(w.float(), seed_t(67), tiny,
                            torch.empty_like(w, dtype=torch.float32), 99)
    rest = v - v.to(bf16).float()
    rest = rest - (rest.view(torch.int32) & -65536).view(torch.float32)
    lo = (rest.view(torch.int32) & -65536).view(torch.float32)
    sub_share = float(((lo != 0) & (lo.abs() < 2.0 ** -126)).float().mean())
    if not sub_share > 0.5:
        raise AssertionError(f"perturbed_matmul_bf16 subnormal probe: only "
                             f"{sub_share:.3f} of its lo pieces are "
                             "subnormal")
    x = {k: torch.randn((M_ROWS, k), generator=gen, device=dev).to(bf16)
         for k in (768, 3072)}
    ws = [torch.randn(s, generator=gen, device=dev).to(bf16)
          for s in PMM_LAYER]
    s7 = seed_t(7)
    resolved = [sa.seeded_axpy_cuda(w, s7, eps, torch.empty_like(w), 0)
                for w in ws]
    p_ms = time_ms(torch, lambda: [pmm.perturbed_matmul_cuda(
        x[w.shape[0]], w, s7, 0, eps) for w in ws])
    p_plain = time_ms(torch, lambda: [pmm.perturbed_matmul_plain(
        x[w.shape[0]], w, 7, 0, eps) for w in ws])
    p_lib = time_ms(torch, lambda: [torch.matmul(x[w.shape[0]], r)
                                    for w, r in zip(ws, resolved)])
    p_dev = device_ms(torch, lambda: [pmm.perturbed_matmul_cuda(
        x[w.shape[0]], w, s7, 0, eps) for w in ws], reps=5)
    p_lib_dev = device_ms(torch, lambda: [torch.matmul(x[w.shape[0]], r)
                                          for w, r in zip(ws, resolved)],
                          reps=5)
    # the bound: the largest of the bytes, the three bf16 products (3 ×
    # 2·M·K·N at BF16_FLOPS_PER_S) and one draw of each weight at
    # seeded_axpy_bf16's issue rate (per_el SASS instructions a weight)
    flops = sum(2.0 * M_ROWS * k * n for k, n in PMM_LAYER)
    n_bytes = sum(2.0 * (M_ROWS * k + k * n + M_ROWS * n)
                  for k, n in PMM_LAYER)
    pb_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    pb_ops = 3 * flops / BF16_FLOPS_PER_S * 1e3
    pb_issue = issue_bound_ms(torch, per_el,
                              sum(k * n for k, n in PMM_LAYER))
    pb_ms = max(pb_bytes, pb_ops, pb_issue)
    pb_term = ("bytes" if pb_ms == pb_bytes else "3xbf16 operations"
               if pb_ms == pb_ops else "one draw a weight (issue)")
    pb_by = "bytes" if pb_ms == pb_bytes else "operations"
    p_attrs = pmm.kernel_attributes(M_ROWS, 768, bf16)
    print(f"perturbed_matmul_bf16: {len(cases) + 1} cases within "
          f"{p_worst:.3f} bf16 ulp of the f32 result, identity probes "
          f"bitwise against seeded_axpy_bf16 (one on w + eps*z near "
          f"2^-112: {sub_share:.3f} of its lo pieces subnormal); one "
          f"layer's 7 at M={M_ROWS} {p_ms:.4f} ms (plain {p_plain:.4f}, "
          f"cuBLAS bf16 on resolved w {p_lib:.4f}); device time "
          f"{p_dev:.4f} ms (cuBLAS {p_lib_dev:.4f}); bound {pb_ms:.4f} ms "
          f"by {pb_term} (bytes {pb_bytes:.4f}, 3xbf16 operations "
          f"{pb_ops:.4f}, one draw a weight {pb_issue:.4f}), "
          f"{pb_ms / p_dev:.3f} of it by device time; kernel {p_attrs}",
          flush=True)
    rows.append({"name": "perturbed_matmul_bf16",
                 "counter": "perturbed_matmul", "dtype": "bfloat16",
                 "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/perturbed_matmul.cu",
                 "replaces": "src/repro/kernels/perturbed_matmul.py:71",
                 "max_abs_err": p_worst,
                 "max_err_unit": "bf16 ulp of the f32 result", "ms": p_ms,
                 "plain_ms": p_plain, "bound_ms": pb_ms, "bound_by": pb_by,
                 "bound_term": pb_term, "byte_bound_ms": pb_bytes,
                 "bf16_ops_bound_ms": pb_ops, "issue_bound_ms": pb_issue,
                 "bound_share": pb_ms / p_dev,
                 "subnormal_lo_share": sub_share,
                 "library_ms": p_lib,
                 "library": "torch.matmul (cuBLAS bf16) on resolved w + "
                            "eps*z in bf16",
                 "device_ms": p_dev, "library_device_ms": p_lib_dev,
                 "kernel_attributes": p_attrs,
                 "shape": f"one OPT-125M layer's 7 projections at "
                          f"M={M_ROWS}, bf16"})
    return rows


def pz_defaults(cfg, rounds: int, n_perturb: int = N_PERTURB,
                fused: bool = False, mechanism: str = "analog",
                scheme: str = "solution", wrapped: bool = False):
    """The training CLI's defaults (`python -m repro.launch.train`) for a
    transport and power-control scheme; `wrapped` swaps Rayleigh for
    WRAPPED_RICIAN."""
    from repro_torch.configs.base import (ChannelConfig, DPConfig,
                                          PairZeroConfig, PowerControlConfig,
                                          TransportConfig, ZOConfig)
    chan = WRAPPED_RICIAN if wrapped else dict(model="rayleigh")
    return PairZeroConfig(
        variant="sign" if mechanism == "sign" else "analog", n_clients=5,
        rounds=rounds,
        zo=ZOConfig(mu=1e-3, lr=5e-3, clip_gamma=5.0, n_perturb=n_perturb),
        channel=ChannelConfig(n0=1.0, power=100.0, d=cfg.param_count(),
                              **chan),
        dp=DPConfig(epsilon=5.0, delta=0.01),
        power=PowerControlConfig(scheme=scheme),
        transport=TransportConfig(mechanism=mechanism, scheme=scheme),
        seed=0, fused_perturbation=fused)


class Payloads:
    """A round hook that keeps each round's host metrics: the clients'
    payloads of the first direction (`p_clients`; none under FO) and the
    mask's sum (`k_eff`)."""
    cadence = 0

    def __init__(self):
        self.p_clients, self.k_eff = [], []

    def on_start(self, exp) -> None:
        pass

    def on_round(self, t, metrics) -> None:
        self.p_clients.append([float(x) for x in
                               metrics.get("p_clients", ())])
        self.k_eff.append(float(metrics["k_eff"]))

    def on_boundary(self, t_done: int, exp) -> None:
        pass

    def close(self, exp) -> None:
        pass


def parted_at_flip(name: str, pz, a, b):
    """Two runs of a digital transport from the same weights: the round at
    which they part, or None. Their losses agree (rtol 1e-4) up to that
    round, and there their p̂ differ by a whole number of quantizer cells
    over K·n_perturb: a projection within rounding of a cell's threshold
    rounds to the neighbouring cell on one device (every client is
    scheduled on the Rayleigh channel, so K_eff = K). Raises on any other
    difference."""
    from repro_torch.core import transport as tp
    mech = tp.resolve(pz)
    cell = 2 * mech.clip / (2 ** mech.quant_bits - 1) / (
        pz.n_clients * pz.zo.n_perturb)
    for r, (la, lb, pa, pb) in enumerate(zip(a.losses, b.losses, a.p_hats,
                                             b.p_hats)):
        if not math.isclose(la, lb, rel_tol=1e-4):
            raise AssertionError(f"tiny {name}, round {r}: losses {la} vs "
                                 f"{lb}")
        cells = (pa - pb) / cell
        if abs(pa - pb) <= 1e-5:
            continue
        if round(cells) == 0 or abs(pa - pb - round(cells) * cell) > 1e-5:
            raise AssertionError(f"tiny {name}, round {r}: p_hat {pa} vs "
                                 f"{pb}, {cells:.4f} cells of {cell}")
        return r
    return None


def check_small_reference(torch, dev) -> None:
    """Tiny models, 3 rounds: the GPU run (kernels) and the CPU run (plain
    versions) from the same weights agree (losses rtol 1e-4), and the GPU
    scan run (one chunk: an eager round, then two graph replays) equals the
    GPU loop run bitwise — the reduced vlm (internvl2-76b, 8 patch
    embeddings a row) and audio (whisper-medium, `tiny_audio`) families,
    chained dense, fused dense, the ssm family and the hybrid family (5
    layers: one rra group and a tail of two) on the default round; then
    the tiny dense model on squad over WRAPPED_RICIAN at horizon
    SIGN_HORIZON under each further (transport, scheme) pair,
    and sign/solution at horizon 800, whose first rounds are silent (p_hat
    0 and no privacy spent on both engines); then the tiny dense round
    under digital and smart_digital, whose GPU and CPU runs may part where
    a payload rounds into the neighbouring quantizer cell
    (`parted_at_flip`), and whose uniform rows drawn on the card equal the
    host's bitwise; then FO-Adam on the tiny dense, ssm and hybrid models
    (scan ≡ loop also in both Adam moments). Each GPU run, silent rounds
    included, launches what expected_launches counts. Where a sign run's
    GPU and CPU losses part, the payloads of both runs are printed: a
    projection within rounding of 0 can take opposite signs on the two
    devices."""
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import engine, fedsim, zo
    from repro_torch.data.pipeline import FederatedPipeline
    from repro_torch.data.tasks import TaskSpec
    from repro_torch.models import registry

    tiny = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                       head_dim=16)
    ssm = get_arch("mamba2-370m").reduced()
    hyb = get_arch("recurrentgemma-2b").reduced(n_layers=5)
    deepseek = get_arch("deepseek-v2-236b").reduced()
    moonshot = get_arch("moonshot-v1-16b-a3b").reduced()
    runs = [(name, cfg, "sst2", pz_defaults(cfg, rounds=8, n_perturb=2,
                                            fused=fused))
            for name, cfg, fused in (("vlm", get_arch(
                                          "internvl2-76b").reduced(), False),
                                     ("audio", tiny_audio(), False),
                                     ("chained", tiny, False),
                                     ("fused", tiny, True),
                                     ("ssm", ssm, False),
                                     ("hybrid", hyb, False),
                                     ("mla+moe chained", deepseek, False),
                                     ("mla+moe fused", deepseek, True),
                                     ("moe chained", moonshot, False),
                                     ("moe fused", moonshot, True))]
    for mechanism, scheme in (("analog", "static"), ("analog", "reversed"),
                              ("perfect", "perfect"), ("sign", "solution"),
                              ("sign", "static"), ("sign", "reversed")):
        runs.append((f"{mechanism}/{scheme}", tiny, "squad", pz_defaults(
            tiny, rounds=SIGN_HORIZON, n_perturb=2, mechanism=mechanism,
            scheme=scheme, wrapped=True)))
    runs.append(("sign/solution, horizon 800 (silent)", tiny, "squad",
                 pz_defaults(tiny, rounds=800, n_perturb=2, mechanism="sign",
                             wrapped=True)))
    for mechanism in ("digital", "smart_digital"):
        runs.append((mechanism, tiny, "sst2", pz_defaults(
            tiny, rounds=8, n_perturb=2, mechanism=mechanism)))
    for name, cfg in (("fo", tiny), ("fo ssm", ssm), ("fo hybrid", hyb)):
        runs.append((name, cfg, "sst2", pz_defaults(
            cfg, rounds=8, n_perturb=2, mechanism="fo")))

    for name, cfg, task, pz in runs:
        pipe = FederatedPipeline(task, TaskSpec(task, cfg.vocab_size, 24),
                                 5, 4, seed=0, **frontend(cfg))
        mechanism = pz.transport.mechanism
        fo = mechanism == "fo"
        digital = mechanism in ("digital", "smart_digital")

        def weights(device):
            return tree_to(registry.init_params(cfg, prng.key(3), "cpu"),
                           device)

        seen = {"gpu": Payloads(), "cpu": Payloads(), "scan": Payloads()}
        want = expected_launches(cfg, 3, pz.fused_perturbation,
                                 n_perturb=pz.zo.n_perturb, fo=fo)
        reset_launches()
        gpu = fedsim.run(cfg, pz, pipe, 3, params=weights(dev), device=dev,
                         hooks=[seen["gpu"]])
        launches = {"loop": read_launches()}
        cpu = fedsim.run(cfg, pz, pipe, 3, params=weights("cpu"),
                         device="cpu", hooks=[seen["cpu"]])
        parted = None
        if digital:
            parted = parted_at_flip(name, pz, gpu, cpu)
            rows = engine.uniform_rows(pz.seed, 0, 3, pz.zo.n_perturb, 5)
            on_card = prng.uniform(engine.direction_keys(
                pz.seed, 0, 3, pz.zo.n_perturb).to(dev), (5,))
            require_equal(torch, on_card.cpu(), torch.from_numpy(rows),
                          f"tiny {name}: uniform rows on the card")
        for r, (a, b) in enumerate(zip(gpu.losses, cpu.losses)):
            if digital:
                break
            if not math.isclose(a, b, rel_tol=1e-4):
                for q in range(r + 1):
                    print(f"tiny {name} round {q}: payloads GPU "
                          f"{seen['gpu'].p_clients[q]} CPU "
                          f"{seen['cpu'].p_clients[q]}", flush=True)
                raise AssertionError(f"tiny {name} run, round {r}: GPU loss "
                                     f"{a} vs CPU loss {b}")
        # the scan engine on the card: one eager round, then two replays of
        # the captured round, bitwise the loop engine's
        reset_launches()
        scan = fedsim.run(cfg, pz, pipe, 3, params=weights(dev), device=dev,
                          engine="scan", chunk_rounds=3, hooks=[seen["scan"]])
        launches["scan"] = read_launches()
        if cfg.moe.enabled:
            # the dispatch and combine are free of atomics: a second GPU
            # loop run repeats the first bitwise
            reset_launches()
            again = fedsim.run(cfg, pz, pipe, 3, params=weights(dev),
                               device=dev)
            launches["again"] = read_launches()
            if again.losses != gpu.losses or again.p_hats != gpu.p_hats \
                    or not all(torch.equal(a, b) for (_, a), (_, b) in zip(
                        zo.flatten(again.params), zo.flatten(gpu.params))):
                raise AssertionError(f"tiny {name}: a second GPU run "
                                     f"{again.losses} differs from the "
                                     f"first {gpu.losses}")
        if any(run != want for run in launches.values()):
            raise AssertionError(f"tiny {name}: launches {launches}, "
                                 f"expected {want} in each GPU run")
        state = {"params": (scan.params, gpu.params)}
        if fo:
            state.update(m=(scan.opt_state["m"], gpu.opt_state["m"]),
                         v=(scan.opt_state["v"], gpu.opt_state["v"]))
        if scan.losses != gpu.losses or scan.p_hats != gpu.p_hats \
                or scan.privacy_spent != gpu.privacy_spent or not all(
                torch.equal(a, b) for x, y in state.values()
                for (_, a), (_, b) in zip(zo.flatten(x), zo.flatten(y))):
            raise AssertionError(f"tiny {name} scan run: losses "
                                 f"{scan.losses} vs loop {gpu.losses}, or "
                                 "its p_hat, privacy spent, parameters or "
                                 "Adam moments differ")
        if seen["gpu"].k_eff != seen["cpu"].k_eff \
                or seen["scan"].k_eff != seen["gpu"].k_eff:
            raise AssertionError(f"tiny {name}: mask sums {seen['gpu'].k_eff}"
                                 f" (GPU), {seen['cpu'].k_eff} (CPU), "
                                 f"{seen['scan'].k_eff} (scan)")
        if "silent" in name or fo or digital:
            for what, res in (("GPU loop", gpu), ("CPU", cpu),
                              ("GPU scan", scan)):
                if res.privacy_spent != 0.0 or ("silent" in name and any(
                        p != 0.0 for p in res.p_hats)):
                    raise AssertionError(
                        f"tiny {name} ({what}): p_hat {res.p_hats}, privacy "
                        f"spent {res.privacy_spent}; want none spent"
                        + (" and p_hat 0" if "silent" in name else ""))
        agree = "match CPU" if parted is None else \
            f"part from CPU at a one-cell flip in round {parted}:"
        print(f"small-input reference ({name}, {cfg.name}, {task}): GPU "
              f"losses {gpu.losses} {agree} {cpu.losses} (rtol 1e-4"
              + ("" if parted is None else " before it") + f"); p_hat "
              f"{gpu.p_hats}; mask sums {seen['gpu'].k_eff}; privacy spent "
              f"{gpu.privacy_spent:.6g}; the scan engine's match the loop's "
              "bitwise" + (" (Adam moments too)" if fo else "")
              + ("; a second GPU loop run repeats the first bitwise"
                 if cfg.moe.enabled else ""), flush=True)


@contextlib.contextmanager
def plain_versions(wrong_mask: bool = False):
    """The models' kernel entry points (`ops.attention`, `ops.ssd`,
    `ops.linear_recurrence`) swapped for their plain versions, on any
    device: the comparison side of a serve check. Nothing counts a
    launch inside. `wrong_mask` flips attention's causal mask: a wrong
    kernel, the control reading of a check."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, rglru_scan
    saved = ops.attention, ops.ssd, ops.linear_recurrence

    def attention(q, k, v, *, causal=True, window=None, scale=None):
        return fa.attention_plain(q, k, v, causal != wrong_mask, window,
                                  scale)

    def ssd(x, dt, a, b, c, state0=None, chunk=128, want_state=True):
        return ops._ssd_plain(x, dt, a, b, c, state0, chunk, want_state)

    ops.attention, ops.ssd = attention, ssd
    ops.linear_recurrence = rglru_scan.linear_recurrence_plain
    try:
        yield
    finally:
        ops.attention, ops.ssd, ops.linear_recurrence = saved


@contextlib.contextmanager
def kernels_checked(torch, what: str):
    """Every `ops.attention` and `ops.perturbed_matmul` call inside also
    held within one bf16 ulp of the f32 result of its own inputs (the
    plain version on them widened, w + eps·z in f32, `within_bf16_ulp`);
    yields {entry: [each call's error in those ulps]}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import perturbed_matmul as pmm
    saved = ops.attention, ops.perturbed_matmul
    errs = {"attention": [], "perturbed_matmul": []}

    def attention(q, k, v, *, causal=True, window=None, scale=None):
        out = saved[0](q, k, v, causal=causal, window=window, scale=scale)
        ref = fa.attention_plain(q.float(), k.float(), v.float(), causal,
                                 window, scale)
        errs["attention"].append(within_bf16_ulp(
            torch, out, ref, f"{what} attention call "
            f"{len(errs['attention'])}"))
        return out

    def perturbed_matmul(x, pp):
        out = saved[1](x, pp)
        ref = pmm.perturbed_matmul_plain(x.float(), pp.w.float(), pp.seed,
                                         pp.off, pp.scale())
        errs["perturbed_matmul"].append(within_bf16_ulp(
            torch, out, ref, f"{what} perturbed_matmul call "
            f"{len(errs['perturbed_matmul'])}"))
        return out

    ops.attention, ops.perturbed_matmul = attention, perturbed_matmul
    try:
        yield errs
    finally:
        ops.attention, ops.perturbed_matmul = saved


def rel_err(got, want) -> float:
    """max|got − want| / max|want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def bf16_logits_gate(what: str, reading: float, control: float) -> None:
    """A bf16 logits check: its reading within BF16_LOGITS_TOL, and its
    control reading (the same comparison against a wrong computation)
    beyond it, so that the gate tells the two apart."""
    if not reading <= BF16_LOGITS_TOL:
        raise AssertionError(f"{what}: {reading:.3e} of the largest logit "
                             f"(tol {BF16_LOGITS_TOL})")
    if not control > BF16_LOGITS_TOL:
        raise AssertionError(f"{what}: the control reads {control:.3e}, "
                             f"within the tolerance {BF16_LOGITS_TOL}: the "
                             "check cannot tell a wrong result apart")


def tokens_on(torch, tokens, dev):
    return torch.as_tensor(tokens, device=dev).long()


def teacher_forced(torch, cfg, params, seq, s: int, shift: int = 0):
    """Prefill of seq[:, :s] (behind the family's zero frontend input, as
    serve_loop's), then decode steps fed seq[:, s:-1] one token at a time:
    the logits [B, n − s, V] that predict positions s .. n − 1. `shift`
    moves each decode step's cache position by that many (a wrong cache
    slot and position: the control reading of decode ≡ forward)."""
    from repro_torch.launch import serve
    from repro_torch.models import registry
    mod = registry.get_module(cfg)
    n = seq.shape[1]
    logits, cache, pos = serve.start(cfg, params, seq[:, :s], n - s)
    rows = [logits[:, -1]]
    for i in range(n - s - 1):
        logits, cache = mod.decode_step(params, cfg, cache,
                                        seq[:, s + i:s + i + 1],
                                        pos + i + shift)
        rows.append(logits[:, -1])
    return torch.stack(rows, dim=1)


def forward_logits(cfg, params, seq):
    """The full forward's logits of seq [B, n] behind the same zero
    frontend input as serve_loop's: the vlm's zero patch embeddings
    prepended (their positions sliced off), the audio family's zero frames
    (its forward's default) encoded for the decoder."""
    from repro_torch.launch import serve
    from repro_torch.models import layers, registry
    mod = registry.get_module(cfg)
    front = serve.frontend_zeros(cfg, seq.shape[0],
                                 layers.head(params)["w"])
    if front is None:
        x = mod.forward(params, cfg, seq)
    else:
        x = mod.forward(params, cfg, seq, prefix_embeds=front)[
            :, front.shape[1]:]
    return layers.logits(params, x)


def leaves_rel_err(torch, got, want, what: str, tol: float) -> float:
    """max|Δ| / max|want| of each leaf of two trees (or two tensors),
    raising above tol; the largest."""
    from repro_torch.core import zo
    pairs = (zip(zo.flatten(got), zo.flatten(want)) if isinstance(got, dict)
             else [(("", got), ("", want))])
    worst = 0.0
    for (path, g), (_, w) in pairs:
        err = float((g.float() - w.float()).abs().max())
        ref = float(w.float().abs().max())
        if not err <= tol * ref:
            raise AssertionError(f"{what} {path}: max err {err} > {tol} x "
                                 f"{ref}")
        worst = max(worst, err / ref if ref else 0.0)
    return worst


def tiny_audio():
    """whisper-medium.reduced() with 32 frames: the kernel takes no more
    queries than keys (Sq <= Skv), so the text (24 tokens a prompt, 24
    a training row) must not outnumber the frames."""
    from repro_torch.configs import get_arch
    cfg = get_arch("whisper-medium").reduced()
    return dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, n_frontend_tokens=32))


def check_small_serve(torch, dev) -> None:
    """The serve paths of the tiny dense, ssm and hybrid models (24 + 16
    tokens, so the hybrid's decode wraps its 32-slot window), of the
    reduced deepseek-v2 (MLA's latent cache, MoE with a shared expert) and
    moonshot (GQA, MoE), and of the reduced internvl2-76b (8 zero patch
    embeddings in front) and whisper-medium (32 zero frames,
    `tiny_audio`) on the card
    (kernels) against the CPU (plain versions) from the same weights: the
    prefill logits and every state leaf, the teacher-forced logits along
    the CPU's greedy output (TINY_SERVE_TOL), and serve_loop's tokens
    equal."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import zo
    from repro_torch.launch import serve
    from repro_torch.models import registry

    tiny = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                       head_dim=16)
    for cfg in (tiny, get_arch("mamba2-370m").reduced(),
                get_arch("recurrentgemma-2b").reduced(n_layers=5),
                get_arch("deepseek-v2-236b").reduced(),
                get_arch("moonshot-v1-16b-a3b").reduced(),
                get_arch("internvl2-76b").reduced(), tiny_audio()):
        cpu = registry.init_params(cfg, prng.key(3), "cpu")
        gpu = tree_to(cpu, dev)
        tokens = np.random.default_rng(0).integers(
            8, cfg.vocab_size, size=(2, 24)).astype(np.int32)
        got = serve.start(cfg, gpu, tokens_on(torch, tokens, dev), 0)[:2]
        want = serve.start(cfg, cpu, tokens_on(torch, tokens, "cpu"), 0)[:2]
        for what, g, w in (("logits", got[0], want[0]),
                           ("state", got[1], want[1])):
            for (path, a), (_, b) in zip(zo.flatten({"x": g}),
                                         zo.flatten({"x": w})):
                if not torch.allclose(a.cpu(), b, **TINY_SERVE_TOL):
                    raise AssertionError(
                        f"tiny serve {cfg.name} prefill {what} {path}: max "
                        f"err {float((a.cpu() - b).abs().max())}")
        out_cpu = serve.serve_loop(cfg, cpu, tokens, 16)
        seq = tokens_on(torch, out_cpu, "cpu")
        tf_cpu = teacher_forced(torch, cfg, cpu, seq, 24)
        tf_gpu = teacher_forced(torch, cfg, gpu, seq.to(dev), 24).cpu()
        if not torch.allclose(tf_gpu, tf_cpu, **TINY_SERVE_TOL):
            raise AssertionError(f"tiny serve {cfg.name}: teacher-forced "
                                 "logits, max err "
                                 f"{float((tf_gpu - tf_cpu).abs().max())}")
        out_gpu = serve.serve_loop(cfg, gpu, tokens, 16)
        if not np.array_equal(out_gpu, out_cpu):
            top2 = torch.topk(tf_cpu, 2, dim=-1).values
            raise AssertionError(
                f"tiny serve {cfg.name}: GPU tokens {out_gpu[:, 24:]} vs CPU "
                f"{out_cpu[:, 24:]}; smallest top-2 gap "
                f"{float((top2[..., 0] - top2[..., 1]).min())}")
        print(f"small-input serve ({cfg.name}): prefill logits and state, "
              "and the teacher-forced logits of 16 greedy steps, on the card "
              "match the CPU (rtol 1e-4, atol 1e-5); tokens equal "
              f"{out_gpu[0, 24:].tolist()}", flush=True)


def tree_to(tree, device):
    """A nested dict / list of tensors moved to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def serve_expected_launches(cfg, gen: int) -> dict:
    """What serve_loop's prefill and gen − 1 decode steps launch: the
    prefill's attention (dense, moe, vlm, audio and hybrid) and stateful
    SSD (ssm) in every such layer (the audio family's encoder, decoder
    self- and cross-attention), the recurrence in every recurrent block of
    the prefill and of each decode step. Decode attention is plain, as in
    the reference (no Pallas kernel there)."""
    from repro_torch.models import hybrid
    out = dict.fromkeys(counters(), 0)
    if cfg.family == "ssm":
        out["ssd_scan"] = cfg.n_layers
    elif cfg.family == "hybrid":
        kinds = hybrid.layer_kinds(cfg)
        out["flash_attention"] = kinds.count("a")
        out["rglru_scan"] = kinds.count("r") * gen
    else:
        out["flash_attention"] = attention_calls(cfg)
    return out


def profile_decode_step(torch, cfg, params, tokens, dev) -> float:
    """One decode step (batch SERVE_BATCH, at the prompt's end + 1) under
    torch.profiler, after one unprofiled step: the share of its wall time
    the device was idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.models import registry
    mod = registry.get_module(cfg)
    seq = tokens_on(torch, tokens, dev)
    _, cache, s = serve.start(cfg, params, seq, 2)
    tok = seq[:, -1:]
    mod.decode_step(params, cfg, cache, tok, s)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    mod.decode_step(params, cfg, cache, tok, s + 1)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    prof.stop()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    print(f"profile serve {cfg.name}: one decode step, wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({busy / wall_us:.3f} of wall, idle {1 - busy / wall_us:.3f}), "
          f"{launches} kernels", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / busy:6.3f} x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    return 1 - busy / wall_us


def serve_peak_gate(cfg) -> float:
    """SERVE_PEAK_THETA, plus for the audio family its cross cache's share
    of θ (the cross k/v over every frame, from `serve_cache_shapes`)."""
    from repro_torch.models import registry
    cache = registry.serve_cache_shapes(cfg, SERVE_BATCH,
                                        SERVE_PROMPT + SERVE_GEN)
    cross = sum(4 * c.numel() for name, c in cache.items()
                if name.startswith("cross"))
    return SERVE_PEAK_THETA + cross / (4 * cfg.param_count())


def run_serve_path(torch, dev, arch: str, profiling: bool,
                   dtype=None) -> dict:
    """One architecture served at full width through `serve.serve_loop` at
    the CLI's defaults from seed-0 weights, after a warm-up call (a prefill
    and one step): prefill ms, decode ms a step (the median of the
    SERVE_GEN − 1 steps, CUDA events), tokens/s, the decode bound (θ bytes
    at the card's rate), peak / θ; exact launches of the timed run
    (counters set to 0 just before it, read just after), peak at most
    `serve_peak_gate` θ, the prefill with the kernels against the plain
    versions on the card, and (but for the hybrid, whose prefill returns a
    zero state) decode ≡ forward, teacher-forced along its own output (the
    moe family's both at `no_drop` capacity: a one-token decode step drops
    no token, a capacity-bound forward does; the vlm and audio families
    behind the same zero patch embeddings or frames). yi-6b also runs once
    through `serve.main`. Configs in DEPTH run at full width with their
    depth cut. In bf16 (`dtype`) the weights are bf16, θ and the peak gate
    count 2 bytes a parameter (the gate also the lm head's f32 copy that
    `unembed` made before its bf16 GEMM with f32 output), and the kernels-vs-plain prefill and decode ≡
    forward hold to BF16_LOGITS_TOL of the largest magnitude."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.launch import serve
    from repro_torch.models import registry

    cfg = full_width(arch)
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    theta = theta_of(torch, cfg, dtype)
    row = {"name": f"serve {arch}" + (" bf16" if bf16 else ""),
           "dtype": str(dtype)[6:]}
    if arch == "yi-6b" and not bf16:
        t0 = time.perf_counter()
        cli = serve.main(["--arch", arch, "--device", "cuda"])
        row["cli_s"] = time.perf_counter() - t0
        if cli.shape != (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN):
            raise AssertionError(f"serve.main {arch}: output {cli.shape}")
        print(f"serve {arch}: `python -m repro_torch.launch.serve --arch "
              f"{arch}` ran in {row['cli_s']:.1f} s with its weight init",
              flush=True)
        release_device_memory(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = registry.init_params(cfg, prng.key(0), dev, dtype)
    torch.cuda.synchronize()
    row["init_s"] = time.perf_counter() - t0
    tokens = np.random.default_rng(0).integers(
        8, cfg.vocab_size, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    serve.serve_loop(cfg, params, tokens, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []

    def hook(stage):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.append(event)

    reset_launches()
    t0 = time.perf_counter()
    out = serve.serve_loop(cfg, params, tokens, SERVE_GEN, hook=hook)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    steps = [a.elapsed_time(b) for a, b in zip(events[1:], events[2:])]
    row.update(
        launches=launches, prefill_ms=events[0].elapsed_time(events[1]),
        decode_ms=statistics.median(steps), decode_ms_min=min(steps),
        decode_ms_max=max(steps), tokens_per_s=SERVE_BATCH * SERVE_GEN / wall,
        wall_s=wall, decode_bound_ms=theta / HBM_BYTES_PER_S * 1e3,
        peak_theta=peak / theta, theta_mb=theta / 1e6)
    expected = serve_expected_launches(cfg, SERVE_GEN)
    if launches != expected:
        raise AssertionError(f"serve {arch}: launches {launches}, expected "
                             f"{expected}")
    # in bf16 the gate also holds the lm head's f32 copy, which `unembed`
    # made before its bf16 GEMM with f32 output (kept as it was reckoned)
    row["peak_gate_theta"] = serve_peak_gate(cfg) + (
        4 * cfg.vocab_size * cfg.d_model / theta if bf16 else 0.0)
    if not row["peak_theta"] <= row["peak_gate_theta"]:
        raise AssertionError(f"serve {arch}: peak {row['peak_theta']:.3f} x "
                             f"theta, want <= {row['peak_gate_theta']:.3f}")
    if out.shape != (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN) \
            or not (out[:, :SERVE_PROMPT] == tokens).all() \
            or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"serve {arch}: output {out}")

    prompt = tokens_on(torch, tokens, dev)
    with (kernels_checked(torch, row["name"]) if bf16
          else contextlib.nullcontext()) as ulps:
        kernels = serve.start(cfg, params, prompt, 0)[:2]
    before = read_launches()
    with plain_versions():
        plain = serve.start(cfg, params, prompt, 0)[:2]
    if bf16:
        row["attention_ulp"] = max(ulps["attention"])
        with plain_versions(wrong_mask=True):
            wrong = serve.start(cfg, params, prompt, 0)[0]
        row["plain_control_rel"] = rel_err(kernels[0], wrong)
        del wrong
    if read_launches() != before:
        raise AssertionError(f"serve {arch}: the plain prefill launched "
                             "kernels")
    plain_tol = BF16_LOGITS_TOL if bf16 else SERVE_PLAIN_TOL
    row["plain_rel_err"] = max(
        leaves_rel_err(torch, kernels[0], plain[0], f"{row['name']} prefill "
                       "logits, kernels vs plain", plain_tol),
        leaves_rel_err(torch, kernels[1], plain[1], f"{row['name']} prefill "
                       "state, kernels vs plain", plain_tol))
    if bf16:
        bf16_logits_gate(f"{row['name']} prefill, kernels vs plain",
                         row["plain_rel_err"], row["plain_control_rel"])
    del kernels, plain
    if cfg.family != "hybrid":
        seq = tokens_on(torch, out, dev)
        tf = teacher_forced(torch, no_drop(cfg), params, seq, SERVE_PROMPT)
        fw = forward_logits(no_drop(cfg), params, seq)[
            :, SERVE_PROMPT - 1:-1]
        row["decode_vs_forward_err"] = float((tf - fw).abs().max())
        if bf16:
            row["decode_vs_forward_rel"] = rel_err(tf, fw)
            row["decode_control_rel"] = rel_err(teacher_forced(
                torch, no_drop(cfg), params, seq, SERVE_PROMPT, shift=1), fw)
            bf16_logits_gate(f"{row['name']} teacher-forced decode vs "
                             "forward", row["decode_vs_forward_rel"],
                             row["decode_control_rel"])
        elif not torch.allclose(tf, fw, **DECODE_TOL):
            raise AssertionError(f"serve {arch}: teacher-forced decode vs "
                                 "forward logits, max err "
                                 f"{row['decode_vs_forward_err']} (rtol/atol "
                                 f"{DECODE_TOL['rtol']})")
        del seq, tf, fw
    if profiling:
        row["decode_idle"] = profile_decode_step(torch, cfg, params, tokens,
                                                 dev)
    print(f"{row['name']}{depth_note(cfg)}: weight init on the card "
          f"{row['init_s']:.3f} s; "
          f"batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, gen {SERVE_GEN}: "
          f"prefill {row['prefill_ms']:.3f} ms, decode {row['decode_ms']:.3f}"
          f" ms/step (median of {len(steps)}; {row['decode_ms_min']:.3f}-"
          f"{row['decode_ms_max']:.3f}), {row['tokens_per_s']:.1f} tokens/s "
          f"({wall:.3f} s); decode bound {row['decode_bound_ms']:.3f} ms "
          f"(theta {row['theta_mb']:.1f} MB at 3.35 TB/s), "
          f"{row['decode_bound_ms'] / row['decode_ms']:.3f} of it; peak "
          f"{row['peak_theta']:.3f} x theta (gate "
          f"{row['peak_gate_theta']:.3f}); kernels vs plain prefill max "
          f"rel err {row['plain_rel_err']:.3e}"
          + (f"; decode vs forward max err {row['decode_vs_forward_err']:.3e}"
             if "decode_vs_forward_err" in row else "")
          + (f"; bf16: every prefill attention call within "
             f"{row['attention_ulp']:.3f} bf16 ulp of its f32 result, "
             f"logits' share of the largest: kernels vs plain "
             f"{row['plain_rel_err']:.3e} (control, causal mask flipped: "
             f"{row['plain_control_rel']:.3e}), decode vs forward "
             f"{row['decode_vs_forward_rel']:.3e} (control, cache position "
             f"off by one: {row['decode_control_rel']:.3e}), tol "
             f"{BF16_LOGITS_TOL}" if bf16 else "")
          + f"; sample row {out[0, SERVE_PROMPT:].tolist()}", flush=True)
    print(f"{row['name']}: launches {launches}", flush=True)
    del params
    release_device_memory(torch)
    return row


def counters():
    from repro_torch.kernels import ops
    return ops.LAUNCH_COUNTERS


def reset_launches() -> None:
    from repro_torch.core import engine
    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    engine.replays = 0


def read_launches() -> dict:
    from repro_torch.kernels import ops
    return ops.read_launches()


def expected_launches(cfg, rounds: int, fused: bool, evals: int = 0,
                      n_perturb: int = N_PERTURB, fo: bool = False) -> dict:
    """What `rounds` rounds and `evals` greedy evals (one forward each, on
    untagged weights) must launch, from the model's structure. A silent
    round (c = 0) launches as many: its update runs with p_hat = 0. An FO
    round is one forward through the kernels (its backward recomputes the
    plain versions) and no axpy."""
    from repro_torch.models import hybrid, registry
    n_leaves = len(registry.shapes(cfg))
    rollouts = rounds * (1 if fo else n_perturb * 2)
    forwards = rollouts + evals
    out = dict.fromkeys(counters(), 0)
    if cfg.family == "ssm":
        out["ssd_scan"] = forwards * cfg.n_layers
    elif cfg.family == "hybrid":
        kinds = hybrid.layer_kinds(cfg)
        out["flash_attention"] = forwards * kinds.count("a")
        out["rglru_scan"] = forwards * kinds.count("r")
    else:
        out["flash_attention"] = forwards * attention_calls(cfg)
    if fo:
        return out
    if fused:
        # per rollout, each layer: its projections by perturbed_matmul
        # (GQA's four, or MLA's wkv_a, wo and wq_a, wq_b or wq; the MLP's
        # three, or the router and a shared MLP's three) and one resolve
        # per layer norm (ln1, ln2; MLA's kv_norm and q_norm), MLA's wkv_b
        # and each expert bank; then the final norm and the untied lm head,
        # and one gather of the embedding rows. The update is one axpy per
        # leaf.
        mla, moe = cfg.mla, cfg.moe
        q_lora = mla.q_lora_rank > 0
        pmm = (3 + q_lora if mla.enabled else 4) + (
            1 + 3 * (moe.n_shared_experts > 0) if moe.enabled else 3)
        res = 2 + (2 + q_lora if mla.enabled else 0) + (
            3 if moe.enabled else 0)
        out["perturbed_matmul"] = rollouts * pmm * cfg.n_layers
        resolves = res * cfg.n_layers + 1 + (0 if cfg.tie_embeddings else 1)
        out["seeded_axpy"] = (rollouts * resolves
                              + rounds * n_perturb * n_leaves)
        out["seeded_gather"] = rollouts
    else:
        # chained walk: w → w+μz → w−μz → updated, one axpy per leaf each
        out["seeded_axpy"] = rounds * n_perturb * 3 * n_leaves
    return out


def frontend(cfg) -> dict:
    """The pipeline's stub-frontend arguments for `cfg` (its patch or
    frame embeddings ride in every batch; none for the other families)."""
    return dict(frontend_tokens=cfg.frontend.n_frontend_tokens,
                d_model=cfg.d_model)


def attention_calls(cfg) -> int:
    """flash_attention launches of one forward of a transformer family:
    one a layer; the audio family's encoder layers once and its decoder
    layers twice (self- and cross-attention)."""
    if cfg.family == "audio":
        return (cfg.n_encoder_layers or cfg.n_layers) + 2 * cfg.n_layers
    return cfg.n_layers


def path_setup(name: str, cfg, fused: bool):
    """A path's run config and data: the CLI's defaults on sst2 at horizon
    800 (for `fo` with the first-order transport), or for `sign`
    Sign-pAirZero over WRAPPED_RICIAN on squad at horizon SIGN_HORIZON."""
    from repro_torch.data.pipeline import FederatedPipeline
    from repro_torch.data.tasks import TaskSpec
    if name == "sign":
        task = "squad"
        pz = pz_defaults(cfg, rounds=SIGN_HORIZON, mechanism="sign",
                         wrapped=True)
    else:
        task = "sst2"
        pz = pz_defaults(cfg, rounds=800, fused=fused,
                         mechanism="fo" if name == "fo" else "analog")
    pipe = FederatedPipeline(task, TaskSpec(task, cfg.vocab_size, 64),
                             n_clients=5, per_client_batch=8, seed=0,
                             **frontend(cfg))
    return pz, pipe


def check_uplink(name: str, res, pz, k_eff: list, d: int) -> None:
    """The uplink bits equal the payload bits of one client (a model of d
    parameters) times the sum of the mask rows the rounds ran with; on the
    sign path also every round transmits (c > 0) and some round has a
    client in outage."""
    from repro_torch.core import transport as tp
    mech = tp.resolve(pz)
    want = mech.payload_bits(pz, d) * sum(k_eff)
    if len(k_eff) != res.steps or res.uplink_bits != want:
        raise AssertionError(f"{name}: uplink bits {res.uplink_bits}, want "
                             f"{mech.payload_bits(pz, d)} x {sum(k_eff)} "
                             f"(mask sums {k_eff})")
    if name != "sign":
        return
    c = res.schedule.c[:res.steps]
    if not (c > 0).all():
        raise AssertionError(f"sign: silent rounds, c {c.tolist()}")
    if not min(k_eff) < pz.n_clients:
        raise AssertionError(f"sign: mask sums {k_eff}, want a round with "
                             f"fewer than {pz.n_clients} clients")
    print(f"path sign: c {[float(x) for x in c]} (no silent round); mask "
          f"sums {k_eff}; uplink bits {res.uplink_bits} = "
          f"{mech.payload_bits(pz, d)} x {sum(k_eff)}", flush=True)


class Stamp:
    """A round hook that synchronizes the card and stamps the host clock
    at every chunk boundary (placed before and after the eval hook, so
    the time between chunks leaves the eval out)."""
    cadence = 0

    def __init__(self, torch):
        self.torch = torch
        self.times = []

    def on_start(self, exp) -> None:
        pass

    def on_round(self, t, metrics) -> None:
        pass

    def on_boundary(self, t_done: int, exp) -> None:
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter())

    def close(self, exp) -> None:
        pass


def final_state(torch, res, name: str) -> dict:
    """A run's final state on the host, by path: the parameters (those of
    the LARGE paths as `fingerprint` checksums) and under FO both Adam
    moments."""
    from repro_torch.core import zo
    if name in LARGE:
        return fingerprint(torch, res.params)
    out = {p: t.cpu() for p, t in zo.flatten(res.params)}
    if res.opt_state is not None:
        for moment in ("m", "v"):
            out.update({f"{moment}:{p}": t.cpu() for p, t in
                        zo.flatten(res.opt_state[moment])})
    return out


def fingerprint(torch, params) -> dict:
    """Per leaf: the f64 sum, the max |w| and the sum of the f32 bit
    patterns (exact: any changed bit moves it), on the host."""
    from repro_torch.core import zo
    out = {}
    for path, t in zo.flatten(params):
        bits = t.view(torch.int32).to(torch.int64).sum()
        out[path] = (float(t.to(torch.float64).sum()),
                     float(t.abs().max()), int(bits))
    return out


def run_path(torch, dev, name: str, cfg, fused: bool, scan: tuple) -> dict:
    """`fedsim.run` of the loop engine at full width with the CLI defaults
    and an eval hook, for the rounds its scan run takes; the launch
    counters are set to 0 just before and read just after. Steady
    ms/round: the median over rounds 2 onward of the host-clock time
    between synchronized stamps, eval left out."""
    from repro_torch.core import fedsim

    rounds, _, every = scan
    pz, pipe = path_setup(name, cfg, fused)
    dtype = path_dtype(torch, name)
    theta_bytes = theta_of(torch, cfg, dtype)
    pre, post, seen = Stamp(torch), Stamp(torch), Payloads()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = fedsim.run(cfg, pz, pipe, rounds, device=dev, dtype=dtype,
                     hooks=[pre, fedsim.EvalHook(every), post, seen])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    fo = name == "fo"
    if len(res.losses) != rounds or not all(map(math.isfinite, res.losses)):
        raise AssertionError(f"{name}: losses {res.losses}")
    if not all(map(math.isfinite, res.p_hats)) \
            or len(res.p_hats) != (0 if fo else rounds):
        raise AssertionError(f"{name}: p_hats {res.p_hats}")
    if not (res.privacy_spent == 0 if fo else res.privacy_spent > 0):
        raise AssertionError(f"{name}: privacy spent {res.privacy_spent}")
    expected = expected_launches(cfg, rounds, fused, rounds // every, fo=fo)
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"{expected}")
    check_uplink(name, res, pz, seen.k_eff, cfg.param_count())
    steady = statistics.median(pre.times[r] - post.times[r - 1]
                               for r in range(1, rounds))
    print(f"path {name}: {cfg.name}{depth_note(cfg)}, {rounds} rounds "
          "(loop engine); run "
          f"{wall:.3f} s with weight init and schedule solve; steady "
          f"{steady * 1e3:.1f} ms/round, {1 / steady:.3f} rounds/s; losses "
          f"{res.losses}; p_hat {res.p_hats}; accuracies {res.accuracies}; "
          f"privacy spent {res.privacy_spent:.6g} of "
          f"{res.privacy_budget:.6g}; prep stall {res.prep_stall_s:.4f} s",
          flush=True)
    reserved = torch.cuda.max_memory_reserved()
    print(f"path {name}: peak device memory {peak / 1e6:.1f} MB = "
          f"{peak / theta_bytes:.2f} x theta ({theta_bytes / 1e6:.1f} MB "
          f"{str(dtype)[6:]}); max reserved {reserved / 1e6:.1f} MB = "
          f"{reserved / theta_bytes:.2f} x theta", flush=True)
    print(f"path {name}: launches {launches}", flush=True)
    return {"name": name, "cfg": cfg, "pz": pz, "pipe": pipe, "res": res,
            "params": res.params, "launches": launches, "dtype": dtype,
            "peak_theta": peak / theta_bytes, "ms_per_round": steady * 1e3}


def path_dtype(torch, name: str):
    """The parameters' dtype of a path: bf16 for BF16_PATHS."""
    return torch.bfloat16 if name in BF16_PATHS else torch.float32


def theta_of(torch, cfg, dtype) -> int:
    """θ's bytes: every parameter at `dtype`'s element size."""
    return torch.empty((), dtype=dtype).element_size() * cfg.param_count()


def bf16_peak_gate(cfg, rows: int = M_ROWS) -> float:
    """The bf16 training paths' peak over a bf16 θ, reckoned from their
    structure: θ, the [rows, V] f32 logits twice (the logits and their
    log-softmax's work), the lm head's [V, D] f32 copy (which `unembed`
    made by widening the bf16 weights until it took one bf16 GEMM with f32
    output; the gate is kept as it was reckoned), and half a θ for the
    bf16 activations and the graph pool: 4.61 for OPT-125M. A θ-sized copy
    fails it: the paths' peaks (3.80 θ on the loop engine, 3.98 on scan,
    on an H100, with the copy) plus one θ exceed it."""
    theta = 2 * cfg.param_count()
    head = 4 * cfg.vocab_size * cfg.d_model
    return 1.5 + (2 * 4 * rows * cfg.vocab_size + head) / theta


def check_peak(name: str, peak_theta: float, cfg=None) -> None:
    if name in BF16_PATHS and not peak_theta < bf16_peak_gate(cfg):
        raise AssertionError(f"{name} path peak {peak_theta:.2f} x theta, "
                             f"want < {bf16_peak_gate(cfg):.2f}")
    if name == "audio" and not peak_theta < AUDIO_PEAK_THETA:
        # whisper-medium: θ (3.84 GB) + the eval's encoder over 64 × 1500
        # frames (its MLP's three [96000, 4096] f32 transients, 1.2 θ) and
        # the batches' frames on the card (0.06 θ a round)
        raise AssertionError(f"audio path peak {peak_theta:.2f} x theta, "
                             f"want < {AUDIO_PEAK_THETA}")
    if name in ("mla", "moe", "moe-fused", "vlm") and not peak_theta < 2.0:
        # θ (11.8-36.0 GB) + the [2560, V] f32 logits and their
        # log-sum-exp, the expanded MLA k/v, the expert dispatch or the
        # vlm's MLP over 320 positions, and under fused one layer's
        # resolved banks and the lm head: about 1.2-1.4 θ; a θ-sized copy
        # would show as 2.2 θ or more
        raise AssertionError(f"{name} path peak {peak_theta:.2f} x theta, "
                             "want < 2.0")
    if name == "hybrid" and not peak_theta <= 2.0:
        # θ + the [2560, 256000] logits + their log-sum-exp ≈ 1.45 θ; a
        # θ-sized copy would show as about 2.5 θ
        raise AssertionError(f"hybrid path peak {peak_theta:.2f} x theta, "
                             "want <= 2.0")
    if name in ("chained", "fused", "sign", "resume") \
            and not peak_theta < 2.9:
        # OPT-125M: θ + activations + the [2560, V] f32 logits ≈ 2.46 θ; a
        # θ-sized copy would show as about 3.4 θ
        raise AssertionError(f"{name} path peak {peak_theta:.2f} x theta, "
                             "want < 2.9")
    if name == "fo" and not peak_theta < 12.0:
        # weights, grads and two moments 4 θ, the saved activations and the
        # logits with their log-softmax and grad about 5 θ (PERF.md §6)
        raise AssertionError(f"fo path peak {peak_theta:.2f} x theta, "
                             "want < 12")


def run_scan_path(torch, dev, loop: dict, scan: tuple, final) -> dict:
    """The same rounds under `engine="scan"` from the same seed init, with
    an eval hook: the same bits as the loop run (losses, p̂, accuracies and
    the final parameters, `final` being the loop run's on the host or
    their `fingerprint`), the same launches, one replayed graph for every
    round but each chunk's first, and the same peak gates. Steady ms/round:
    host-clock time over chunks 2 onward between synchronized stamps, eval
    left out, over their rounds."""
    from repro_torch.core import engine, fedsim

    name, cfg, pz, pipe = loop["name"], loop["cfg"], loop["pz"], loop["pipe"]
    rounds, chunk, every = scan
    fused = pz.fused_perturbation
    theta_bytes = theta_of(torch, cfg, loop["dtype"])
    pre, post, seen = Stamp(torch), Stamp(torch), Payloads()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = fedsim.run(cfg, pz, pipe, rounds, engine="scan", chunk_rounds=chunk,
                     hooks=[pre, fedsim.EvalHook(every), post, seen],
                     device=dev, dtype=loop["dtype"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, replays = read_launches(), engine.replays
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()

    ref = loop["res"]
    if res.losses != ref.losses or res.p_hats != ref.p_hats:
        raise AssertionError(f"{name} scan: losses {res.losses} p_hat "
                             f"{res.p_hats} differ from the loop's "
                             f"{ref.losses} {ref.p_hats}")
    if res.privacy_spent != ref.privacy_spent \
            or res.uplink_bits != ref.uplink_bits:
        raise AssertionError(f"{name} scan: privacy spent "
                             f"{res.privacy_spent} vs {ref.privacy_spent}, "
                             f"uplink bits {res.uplink_bits} vs "
                             f"{ref.uplink_bits}")
    check_uplink(name, res, pz, seen.k_eff, cfg.param_count())
    n_evals = rounds // every
    if len(res.accuracies) != n_evals or not all(
            0.0 <= a <= 1.0 for a in res.accuracies) \
            or res.accuracies != ref.accuracies:
        raise AssertionError(f"{name} scan: accuracies {res.accuracies}, "
                             f"loop {ref.accuracies}, want {n_evals} in "
                             "[0, 1]")
    mine = final_state(torch, res, name)
    if mine.keys() != final.keys() or not all(
            a == final[k] if isinstance(a, tuple) else torch.equal(a, final[k])
            for k, a in mine.items()):
        raise AssertionError(f"{name} scan: final parameters (or Adam "
                             "moments) differ from the loop run's")
    expected = expected_launches(cfg, rounds, fused, n_evals,
                                 fo=name == "fo")
    if launches != expected:
        raise AssertionError(f"{name} scan: launches {launches}, expected "
                             f"{expected}")
    bounds = engine.chunk_boundaries(0, rounds, chunk, (every,))
    if replays != rounds - len(bounds):
        raise AssertionError(f"{name} scan: {replays} replays, want "
                             f"{rounds - len(bounds)}")
    check_peak(name, peak / theta_bytes, cfg)
    steady = None
    if len(bounds) > 1:
        spans = [pre.times[c] - post.times[c - 1]
                 for c in range(1, len(bounds))]
        steady = sum(spans) / (rounds - bounds[0][1])
    print(f"path {name} scan: {rounds} rounds in chunks of {chunk} "
          f"({len(bounds)} chunks, {replays} rounds replayed), eval every "
          f"{every}; run {wall:.3f} s; steady "
          + ("n/a (one chunk)" if steady is None else
             f"{steady * 1e3:.1f} ms/round")
          + f" (loop {loop['ms_per_round']:.1f}); losses, p_hat, "
          f"accuracies {res.accuracies} and final parameters "
          + ("and Adam moments " if name == "fo" else "")
          + f"equal to the loop run's; prep stall {res.prep_stall_s:.4f} s",
          flush=True)
    print(f"path {name} scan: peak device memory {peak / 1e6:.1f} MB = "
          f"{peak / theta_bytes:.2f} x theta; max reserved "
          f"{reserved / 1e6:.1f} MB = {reserved / theta_bytes:.2f} x theta",
          flush=True)
    print(f"path {name} scan: launches {launches}", flush=True)
    return {"params": res.params, "steady": steady,
            "peak_theta": peak / theta_bytes,
            "reserved_theta": reserved / theta_bytes}


def time_scan_chunks(torch, dev, loop: dict, params, rounds: int,
                     chunk: int) -> float:
    """Steady ms/round of the scan engine over `rounds` rounds in chunks of
    `chunk` on `params` (the cached graph), chunks 2 onward."""
    from repro_torch.core import engine, fedsim
    stamp = Stamp(torch)
    torch.cuda.synchronize()
    fedsim.run(loop["cfg"], loop["pz"], loop["pipe"], rounds, engine="scan",
               chunk_rounds=chunk, params=params, hooks=[stamp], device=dev,
               dtype=loop["dtype"])
    bounds = engine.chunk_boundaries(0, rounds, chunk)
    return (stamp.times[-1] - stamp.times[0]) / (rounds - bounds[0][1])


@contextlib.contextmanager
def recorded_routing(log: list):
    """`layers._moe_rows` wrapped to append each call's router logits
    [B, T, E] (one call per MoE layer and dispatch group, in order) to
    `log`: the comparison side of the fused check on the moe family."""
    from repro_torch.models import layers
    inner = layers._moe_rows

    def rows(banks, x, logits, k, cap):
        log.append(logits.detach().double().cpu())
        return inner(banks, x, logits, k, cap)

    layers._moe_rows = rows
    try:
        yield
    finally:
        layers._moe_rows = inner


def routing_parted(torch, fused: list, fresh: list, k: int):
    """The batch rows whose top-k routing parts between two forwards, walked
    layer by layer (a row that parted is not compared further: its hidden
    state differs from there on). A token may part only on a near-tie: its
    top-k+1 logits in the fresh forward have two within 2·max|Δ| of its
    logits of each other (the necessary condition for two experts to swap
    ranks), else this raises. Returns the parted rows [B] and the number
    of tokens that parted."""
    parted = torch.zeros(fresh[0].shape[0], dtype=torch.bool)
    tokens = 0
    for layer, (a, r) in enumerate(zip(fused, fresh)):
        ia = torch.sort(a, dim=-1, descending=True, stable=True).indices
        vr, ir = torch.sort(r, dim=-1, descending=True, stable=True)
        differ = (ia[..., :k] != ir[..., :k]).any(-1) & ~parted[:, None]
        if not differ.any():
            continue
        gap = (vr[..., :k] - vr[..., 1:k + 1]).min(-1).values
        bound = 2 * (a - r).abs().amax(-1)
        if (differ & (gap > bound)).any():
            raise AssertionError(
                f"fused vs fresh: MoE layer call {layer} routes "
                f"{int((differ & (gap > bound)).sum())} tokens differently "
                "with no near-tie to explain it")
        tokens += int(differ.sum())
        parted |= differ.any(-1)
    return parted, tokens


def check_fused_against_fresh(torch, dev, path: dict) -> None:
    """One full-width fused dual forward against a fresh one from the same
    weights and batch (losses rtol 1e-4: the fused kernel sums in another
    order than cuBLAS): the path's trained weights, or under MoE the
    seed-0 weights. The router's top-k is discrete: a token whose ranks
    around the k-th logit are within rounding may route to another expert
    in the two forwards (`routing_parted`, which fails on any other
    difference), and a client with such a row is left out of the loss
    comparison of that rollout. After the moe-fused path's 4 rounds at the
    CLI's lr the weights have moved by several times their init scale
    (losses 17 → 57), and each layer amplifies the two forwards' rounding
    differences many times over: from the third layer on they exceed the
    router's gaps, and on the H100 a row of every client parted there.
    The seed-0 weights hold the fused dual forward to the same function
    without that amplification."""
    from repro_torch import prng
    from repro_torch.core import engine, pairzero, zo
    from repro_torch.models import registry
    cfg, params = path["cfg"], path["params"]
    if cfg.moe.enabled:
        params = registry.init_params(cfg, prng.key(0), dev)
    batch = {k: v[0] for k, v in engine.stack_batches(path["pipe"], 0, 1,
                                                       dev).items()}
    loss_fn = pairzero.make_loss_fn(cfg)
    seeds = zo.seed_row(zo.perturb_seed(1234, 0), len(zo.flatten(params)),
                        dev)
    out, logs = {}, {}
    for mode in ("fused", "fresh"):
        logs[mode] = []
        with recorded_routing(logs[mode]):
            lp, lm, _ = zo.dual_forward(lambda p: loss_fn(p, batch), params,
                                        seeds, 1e-3, mode=mode)
        out[mode] = torch.stack([lp, lm]).cpu()
    keep = torch.ones_like(out["fresh"], dtype=torch.bool)
    note = ""
    if cfg.moe.enabled:
        n_clients, rows = batch["tokens"].shape[:2]
        half = len(logs["fresh"]) // 2
        moved = []
        for rollout in range(2):
            span = slice(rollout * half, (rollout + 1) * half)
            parted, tokens = routing_parted(
                torch, logs["fused"][span], logs["fresh"][span],
                cfg.moe.n_experts_per_tok)
            keep[rollout] = ~parted.reshape(n_clients, rows).any(-1)
            moved.append(tokens)
        note = (f"; MoE routing parted on near-ties at {moved} tokens "
                f"(rollouts +, -), {int((~keep).sum())} of "
                f"{keep.numel()} (rollout, client) losses left out")
        print(f"fused vs fresh: {note[2:]}", flush=True)
        if not keep.any():
            raise AssertionError("fused vs fresh: every client's routing "
                                 "parted; nothing left to compare")
    got, want = out["fused"][keep], out["fresh"][keep]
    if not torch.allclose(got, want, rtol=1e-4, atol=0):
        raise AssertionError(f"fused dual forward {out['fused'].tolist()} vs "
                             f"fresh {out['fresh'].tolist()}{note}")
    print(f"fused vs fresh dual forward at full width: max rel diff "
          f"{float(((got - want) / want).abs().max()):.3e}"
          f" (rtol 1e-4){note}", flush=True)


@contextlib.contextmanager
def f32_perturbed_weights():
    """The plain perturbed_matmul handed w widened to f32: w + eps·z built
    and kept in f32, as the kernel keeps it, the product rounded once to
    x's dtype."""
    from repro_torch.kernels import perturbed_matmul as pmm
    saved = pmm.perturbed_matmul_plain

    def plain(x, w, seed, off, eps):
        return saved(x, w.float(), seed, off, eps)

    pmm.perturbed_matmul_plain = plain
    try:
        yield
    finally:
        pmm.perturbed_matmul_plain = saved


def check_fused_against_plain(torch, dev, path: dict) -> dict:
    """The bf16-fused path's dual forward at full width, from its trained
    weights and round 0's batch, against the same on the plain versions on
    the card rounded where the kernels round (impl "xla" with
    `f32_perturbed_weights`): losses within BF16_FUSED_RTOL. Fused ≡ fresh
    cannot hold bitwise in bf16, since fresh rounds w + eps·z to bf16 and
    fused does not, in `repro` too. Two controls from the same weights must
    lie beyond the tolerance, so that the check tells them apart: the
    plain versions as `repro`'s XLA path runs them (w + eps·z rounded to
    bf16, which the kernel must not do) and the f32 fused dual forward on
    f32 copies of the weights (no bf16 rounding at all). Each kernel call
    of the dual forward is also held within one bf16 ulp of the f32 result
    of its own inputs (`kernels_checked`), so what the losses' gap shows
    is the two forwards' rounding carried through the layers. The plain
    forwards launch no kernel. Returns the readings."""
    from torch.utils import _pytree

    from repro_torch.core import engine, pairzero, zo
    from repro_torch.kernels import ops
    cfg, params = path["cfg"], path["params"]
    batch = {k: v[0] for k, v in engine.stack_batches(path["pipe"], 0, 1,
                                                       dev).items()}
    loss_fn = pairzero.make_loss_fn(cfg)
    seeds = zo.seed_row(zo.perturb_seed(1234, 0), len(zo.flatten(params)),
                        dev)

    def dual(weights, impl, widen=False):
        before = read_launches()
        with ops.use_impl(impl), (f32_perturbed_weights() if widen
                                  else contextlib.nullcontext()):
            lp, lm, _ = zo.dual_forward(lambda p: loss_fn(p, batch),
                                        weights, seeds, 1e-3, mode="fused")
        if impl == "xla" and read_launches() != before:
            raise AssertionError("bf16-fused: the plain dual forward "
                                 "launched kernels")
        return torch.stack([lp, lm]).float().cpu()

    def rel(a, b):
        return float(((a - b) / b).abs().max())

    with kernels_checked(torch, "bf16-fused dual forward") as ulps:
        got = dual(params, None)
    out = {"calls": {k: len(v) for k, v in ulps.items()},
           "call_ulp": max(max(v) for v in ulps.values()),
           "rel": rel(got, dual(params, "xla", widen=True)),
           "control_rounded": rel(got, dual(params, "xla")),
           "control_f32": rel(got, dual(_pytree.tree_map(
               lambda t: t.float(), params), None))}
    print(f"bf16-fused dual forward at full width from the trained weights "
          f"(losses {got.tolist()}): each of its {out['calls']} kernel calls "
          f"within {out['call_ulp']:.3f} bf16 ulp of the f32 result of its "
          f"own inputs; max rel diff {out['rel']:.3e} against "
          f"the plain versions with w + eps*z in f32 (rtol "
          f"{BF16_FUSED_RTOL}); controls: w + eps*z rounded to bf16 "
          f"{out['control_rounded']:.3e}, f32 weights and kernels "
          f"{out['control_f32']:.3e}", flush=True)
    if not out["rel"] <= BF16_FUSED_RTOL:
        raise AssertionError(f"bf16-fused dual forward: {out['rel']:.3e} "
                             "from the plain versions")
    if not min(out["control_rounded"], out["control_f32"]) > BF16_FUSED_RTOL:
        raise AssertionError("bf16-fused dual forward: a control lies within "
                             f"rtol {BF16_FUSED_RTOL}: the check cannot tell "
                             "it apart")
    return out


def run_impl_check(torch, dev, path: dict) -> dict:
    """`impl=` on the card, chained OPT-125M (f32) for IMPL_ROUNDS rounds
    from the chained path's seed init: "pallas" launches the kernels and
    repeats the chained loop run's first rounds bitwise; "xla" launches no
    kernel and its losses lie within IMPL_RTOL of them."""
    from repro_torch.core import fedsim
    cfg, pz, pipe = path["cfg"], path["pz"], path["pipe"]
    want = path["res"].losses[:IMPL_ROUNDS]
    out = {"name": "impl"}
    for impl in ("pallas", "xla"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fedsim.run(cfg, pz, pipe, IMPL_ROUNDS, device=dev, impl=impl)
        torch.cuda.synchronize()
        out[f"{impl}_s"] = time.perf_counter() - t0
        launches = read_launches()
        if impl == "pallas":
            expected = expected_launches(cfg, IMPL_ROUNDS, False)
            if launches != expected or res.losses != want:
                raise AssertionError(f"impl pallas: launches {launches} "
                                     f"(want {expected}), losses "
                                     f"{res.losses} (want {want})")
        else:
            rel = max(abs(a - b) / abs(b) for a, b in zip(res.losses, want))
            if any(launches.values()) or not rel <= IMPL_RTOL:
                raise AssertionError(f"impl xla: launches {launches}, losses "
                                     f"{res.losses} vs the kernels' {want}")
            out["xla_rel_err"] = rel
        del res
    out["launches"] = dict.fromkeys(counters(), 0)
    print(f"impl on the card, chained OPT-125M, {IMPL_ROUNDS} rounds: "
          f"'pallas' bitwise the kernel run ({out['pallas_s']:.2f} s), 'xla' "
          f"no kernel launched, losses within {out['xla_rel_err']:.3e} "
          f"(rtol {IMPL_RTOL}) ({out['xla_s']:.2f} s)", flush=True)
    return out


class StartProfile:
    """A round hook that synchronizes the card and starts the profiler (and
    the wall clock) at the chunk boundary after `at` rounds."""
    cadence = 0

    def __init__(self, torch, prof, at: int):
        self.torch, self.prof, self.at = torch, prof, at
        self.t0 = None

    def on_start(self, exp) -> None:
        pass

    def on_round(self, t, metrics) -> None:
        pass

    def on_boundary(self, t_done: int, exp) -> None:
        if t_done == self.at:
            self.torch.cuda.synchronize()
            self.t0 = time.perf_counter()
            self.prof.start()

    def close(self, exp) -> None:
        pass


def profile_run(torch, path: dict, dev, what: str, skip: int = 0,
                **run_kw) -> None:
    """A run of a path under torch.profiler, from its start or from the
    chunk boundary after `skip` rounds: the kernels that take the device
    time, and the share of the profiled wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import fedsim
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    start = StartProfile(torch, prof, skip)
    torch.cuda.synchronize()
    if not skip:
        start.on_boundary(0, None)
    try:
        fedsim.run(path["cfg"], path["pz"], path["pipe"], device=dev,
                   hooks=[start], **run_kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start.t0) * 1e6
    finally:
        prof.stop()
    # kernel-level rows only: the aten ops above them carry the same time
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile {path['name']}: {what}, wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms ({busy / wall_us:.3f} of wall, "
          f"idle {1 - busy / wall_us:.3f})", flush=True)
    # the top 15, and the port's own kernels wherever they rank
    ours = ("axpy_kernel", "gather_kernel", "flash_fwd", "pmm_kernel",
            "ssd_kernel", "ssd_cb_kernel", "rglru_kernel")
    for i, (dev_us, count, key) in enumerate(rows):
        if i < 15 or any(name in key for name in ours):
            print(f"  {dev_us / 1e3:9.3f} ms {dev_us / busy:6.3f} "
                  f"x{count:<5d} {key[:90]}", flush=True)


class StallProbe:
    """A round hook placed after a `CheckpointHook`: the training thread's
    seconds in each boundary's `save` (the checkpointer's `stall_s` step)."""
    cadence = 0

    def __init__(self, ckpt_hook):
        self.ckpt_hook = ckpt_hook
        self.stalls = []
        self._last = 0.0

    def on_start(self, exp) -> None:
        pass

    def on_round(self, t, metrics) -> None:
        pass

    def on_boundary(self, t_done: int, exp) -> None:
        saver = self.ckpt_hook._saver
        if saver is not None and saver.stall_s != self._last:
            self.stalls.append(saver.stall_s - self._last)
            self._last = saver.stall_s

    def close(self, exp) -> None:
        pass


class MaskRows:
    """Within the block, keep the host mask rows of every control trace a
    run builds (`engine.build_trace` wrapped)."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        from repro_torch.core import engine
        self._real = real = engine.build_trace

        def build_trace(*args, **kwargs):
            trace = real(*args, **kwargs)
            self.rows.append(trace.host_masks.copy())
            return trace
        engine.build_trace = build_trace
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine
        engine.build_trace = self._real
        return False


def resume_run(torch, dev, cfg, pz, pipe, rounds: int, directory: str,
               what: str, engine: str = "loop", double_buffer: bool = True,
               **run_kw) -> dict:
    """One run of the resume path: `fedsim.run` with an eval hook and a
    `CheckpointHook` every RESUME_EVERY rounds in `directory`, the launch
    counters set to 0 just before and read just after; gates its losses,
    privacy, launches, replays, uplink bits and peak."""
    import numpy as np

    from repro_torch.core import engine as eng, fedsim

    every = RESUME_EVERY
    theta_bytes = 4 * cfg.param_count()
    pre, post, seen = Stamp(torch), Stamp(torch), Payloads()
    ck = fedsim.CheckpointHook(directory, every, double_buffer=double_buffer)
    probe = StallProbe(ck)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with MaskRows() as masks:
        t0 = time.perf_counter()
        res = fedsim.run(cfg, pz, pipe, rounds, engine=engine,
                         chunk_rounds=every, device=dev,
                         hooks=[pre, fedsim.EvalHook(every), post, ck, probe,
                                seen], **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, replays = read_launches(), eng.replays
    peak = torch.cuda.max_memory_allocated()

    name = f"resume {what}"
    steps = rounds - res.resumed_from
    if res.steps != steps or len(res.losses) != steps \
            or not all(map(math.isfinite, res.losses + res.p_hats)):
        raise AssertionError(f"{name}: {res.steps} rounds, losses "
                             f"{res.losses}, p_hat {res.p_hats}")
    if not res.privacy_spent > 0:
        raise AssertionError(f"{name}: privacy spent {res.privacy_spent}")
    evals = rounds // every - res.resumed_from // every
    expected = expected_launches(cfg, steps, False, evals)
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"{expected}")
    bounds = eng.chunk_boundaries(res.resumed_from, rounds,
                                  1 if engine == "loop" else every, (every,))
    if engine == "scan" and replays != steps - len(bounds):
        raise AssertionError(f"{name}: {replays} replays, want "
                             f"{steps - len(bounds)}")
    rows = np.concatenate(masks.rows)
    if [float(r.sum()) for r in rows] != seen.k_eff:
        raise AssertionError(f"{name}: mask row sums {rows.sum(axis=1)} vs "
                             f"the rounds' k_eff {seen.k_eff}")
    check_uplink("resume", res, pz, seen.k_eff, cfg.param_count())
    check_peak("resume", peak / theta_bytes)
    print(f"path {name}: {cfg.name}, {engine} engine, rounds "
          f"{res.resumed_from}-{rounds} (resumed_from {res.resumed_from}), "
          f"checkpoint every {every} (double_buffer {double_buffer}); run "
          f"{wall:.3f} s; losses {res.losses}; p_hat {res.p_hats}; "
          f"accuracies {res.accuracies}; privacy spent "
          f"{res.privacy_spent:.6g}; mask sums {seen.k_eff}; ckpt stall "
          f"{res.ckpt_stall_s:.4f} s (per boundary "
          f"{[round(x, 4) for x in probe.stalls]}); retry "
          f"{res.retry_attempts}; peak {peak / theta_bytes:.2f} x theta; "
          f"launches {launches}", flush=True)
    return {"res": res, "launches": launches, "rows": rows,
            "peak_theta": peak / theta_bytes, "stalls": probe.stalls,
            "pre": pre.times, "post": post.times}


def host_tree(tree):
    """A copy of a parameter tree with every leaf on the host."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [host_tree(v) for v in tree]
    return tree.cpu()


def run_resume_path(torch, dev, cfg, chained: dict) -> dict:
    """The `resume` path: OPT-125M at full width, chained, the CLI's
    defaults, checkpoints every RESUME_EVERY rounds into temporary
    directories (removed after each part):
      1. faults off, an elastic event at round 4 (K 5 → 3): 8 rounds on the
         loop; then in a fresh directory 4 rounds on scan and a second scan
         run to 8 that resumes at 4 and equals rounds 4-7 of the loop run
         bitwise (losses, p̂, accuracies, final weights), its DP ledger
         within 1e-12 relative, its mask rows 3 clients;
      2. dropout 0.1 and stragglers 0.05, and the second write of
         `ckpt_write` torn: 8 rounds on the loop; `latest_valid` returns
         step 4 and `latest` step 8; a resumed run starts at 4, and its
         mask rows are those of a fresh FaultModel drawn from round 4 (the
         reference's behaviour);
    then 12 rounds on scan with checkpoints every 4 for the scan ms/round
    and the stall, the writer's seconds for one save from the host, and
    `restore`'s seconds onto the card."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import fedsim
    from repro_torch.runtime import (ElasticSchedule, FaultInjector,
                                     FaultModel, combined_mask)

    pz, pipe = path_setup("chained", cfg, False)
    theta_mb = 4 * cfg.param_count() / 1e6
    elastic = ElasticSchedule(5, events=((4, 3),))
    out = {"name": "resume"}

    def fresh_dir():
        return tempfile.mkdtemp(prefix="chip_smoke_ckpt_")

    # 1. resume ≡ uninterrupted
    d = fresh_dir()
    try:
        loop = resume_run(torch, dev, cfg, pz, pipe, 8, d, "loop",
                          elastic=elastic)
        ref = loop["res"]
        final = final_state(torch, ref, "resume")
        host = host_tree(ref.params)
        t0 = time.perf_counter()
        ckpt.save(d, 100, host, keep=10)
        writer_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, _, _ = ckpt.restore(os.path.join(d, "step_00000100"), ref.params)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d)
    out.update(launches=loop["launches"], peak_theta=loop["peak_theta"])
    steps = [loop["pre"][r] - loop["post"][r - 1] for r in range(1, 8)]
    out["ms_per_round"] = statistics.median(steps) * 1e3
    out["ms_per_round_mean"] = statistics.mean(steps) * 1e3
    ref.params = None
    release_device_memory(torch)

    d = fresh_dir()
    try:
        first = resume_run(torch, dev, cfg, pz, pipe, 4, d, "scan, first",
                           engine="scan", double_buffer=False,
                           elastic=elastic)
        first["res"].params = None
        resumed = resume_run(torch, dev, cfg, pz, pipe, 8, d,
                             "scan, resumed", engine="scan",
                             elastic=elastic)
    finally:
        shutil.rmtree(d)
    res = resumed["res"]
    if res.resumed_from != 4 or res.losses != ref.losses[4:] \
            or res.p_hats != ref.p_hats[4:] \
            or res.accuracies != ref.accuracies[1:]:
        raise AssertionError(f"resume: the resumed scan run (from "
                             f"{res.resumed_from}) {res.losses} "
                             f"{res.p_hats} {res.accuracies} differs from "
                             f"rounds 4-7 of the loop run {ref.losses} "
                             f"{ref.p_hats} {ref.accuracies}")
    if not math.isclose(res.privacy_spent, ref.privacy_spent,
                        rel_tol=1e-12, abs_tol=0.0):
        raise AssertionError(f"resume: privacy spent {res.privacy_spent} vs "
                             f"{ref.privacy_spent}")
    if set(resumed["rows"].sum(axis=1).tolist()) != {3.0}:
        raise AssertionError(f"resume: mask rows {resumed['rows']}, want 3 "
                             "clients from round 4")
    mine = final_state(torch, res, "resume")
    if mine.keys() != final.keys() or not all(
            torch.equal(a, final[k]) for k, a in mine.items()):
        raise AssertionError("resume: the resumed run's final weights "
                             "differ from the loop run's")
    print("path resume: the resumed scan run equals rounds 4-7 of the "
          "uninterrupted loop run bitwise (losses, p_hat, accuracies, final "
          "weights); privacy spent within 1e-12", flush=True)
    out["scan_peak_theta"] = max(first["peak_theta"],
                                 resumed["peak_theta"])
    out["stalls"] = {"loop, double_buffer": loop["stalls"],
                     "scan, sync": first["stalls"],
                     "scan, double_buffer": resumed["stalls"]}
    res.params = None
    del final, mine
    release_device_memory(torch)

    # 2. faults and a torn write
    fkw = dict(dropout_p=0.1, straggler_p=0.05, seed=pz.seed)
    d = fresh_dir()
    try:
        faulted = resume_run(
            torch, dev, cfg, pz, pipe, 8, d, "faulted", double_buffer=False,
            fault=FaultModel(5, **fkw),
            injector=FaultInjector.from_specs(["ckpt_write:torn_write:@1"]))
        faulted["res"].params = None
        valid, newest = ckpt.latest_valid(d), ckpt.latest(d)
        if not (valid.endswith("step_00000004")
                and newest.endswith("step_00000008")):
            raise AssertionError(f"resume: latest_valid {valid}, latest "
                                 f"{newest}")
        again = resume_run(torch, dev, cfg, pz, pipe, 8, d,
                           "faulted, resumed", fault=FaultModel(5, **fkw))
    finally:
        shutil.rmtree(d)
    fm = FaultModel(5, **fkw)
    want = np.stack([combined_mask(t, fm, None, 5) for t in range(8)])
    if not np.array_equal(faulted["rows"], want):
        raise AssertionError(f"resume: faulted rows {faulted['rows']} vs a "
                             f"host FaultModel's {want}")
    fm = FaultModel(5, **fkw)
    want = np.stack([combined_mask(t, fm, None, 5) for t in range(4, 8)])
    if again["res"].resumed_from != 4 \
            or not np.array_equal(again["rows"], want):
        raise AssertionError(f"resume: the faulted resume (from "
                             f"{again['res'].resumed_from}) rows "
                             f"{again['rows']} vs a fresh FaultModel's from "
                             f"round 4 {want}")
    print(f"path resume: torn step_00000008 skipped (latest_valid "
          f"{os.path.basename(valid)}); the faulted resume starts at 4 and "
          f"its mask rows {again['rows'].sum(axis=1).tolist()} are a fresh "
          "FaultModel's from round 4", flush=True)
    out["stalls"]["loop, sync"] = faulted["stalls"]
    again["res"].params = None
    release_device_memory(torch)

    # scan ms/round with checkpoints every 4: chunks 2 and 3 of 12 rounds
    stamp = Stamp(torch)
    ck = fedsim.CheckpointHook(fresh_dir(), RESUME_EVERY)
    try:
        torch.cuda.synchronize()
        res = fedsim.run(cfg, pz, pipe, 12, engine="scan",
                         chunk_rounds=RESUME_EVERY, hooks=[stamp, ck],
                         device=dev)
    finally:
        shutil.rmtree(ck.directory)
    out["scan_ms_per_round"] = (stamp.times[2] - stamp.times[0]) / 8 * 1e3
    res.params = None
    print(f"path resume: steady ms/round with checkpoints every "
          f"{RESUME_EVERY}: loop median {out['ms_per_round']:.1f} (mean "
          f"{out['ms_per_round_mean']:.1f}), scan "
          f"{out['scan_ms_per_round']:.1f} (chained, no checkpoints: loop "
          f"{chained['ms_per_round']:.1f}, scan "
          f"{chained['scan_ms_per_round']:.1f}); ckpt stall per boundary "
          f"(s) {json.dumps(out['stalls'])}, scan 12 rounds "
          f"{res.ckpt_stall_s:.4f} s; writer {writer_s:.3f} s a save of "
          f"{theta_mb:.1f} MB from the host; restore {restore_s:.3f} s onto "
          f"the card; peak {out['peak_theta']:.2f} x theta loop, "
          f"{out['scan_peak_theta']:.2f} scan", flush=True)
    release_device_memory(torch)
    return out


def scenario_setup(name: str, cfg):
    """The scenario paths' run configs at the CLI's defaults on sst2 over
    Rayleigh: `attacked`, analog/solution with sign_flip on a quarter of
    the clients, robust_decode over ATTACK_GROUPS sub-slots and desync
    (fraction 0.25, lag up to 4, phase std 0.1); `fo-desync`, FO-Adam with
    desync (fraction 0.25, phase std 0.1, 16-symbol frames)."""
    from repro_torch.configs.base import ByzantineConfig, DesyncConfig
    from repro_torch.data.pipeline import FederatedPipeline
    from repro_torch.data.tasks import TaskSpec
    if name == "attacked":
        pz = dataclasses.replace(
            pz_defaults(cfg, rounds=800),
            byzantine=ByzantineConfig(behavior="sign_flip", fraction=0.25,
                                      defense="robust_decode",
                                      groups=ATTACK_GROUPS),
            desync=DesyncConfig(fraction=0.25, max_lag=4, phase_std=0.1))
    else:
        pz = dataclasses.replace(
            pz_defaults(cfg, rounds=800, mechanism="fo"),
            desync=DesyncConfig(fraction=0.25, phase_std=0.1,
                                frame_symbols=16))
    pipe = FederatedPipeline("sst2", TaskSpec("sst2", cfg.vocab_size, 64),
                             n_clients=5, per_client_batch=8, seed=0)
    return pz, pipe


def scenario_run(torch, dev, cfg, pz, pipe, rounds: int,
                 adversary: bool = True, **kw) -> dict:
    """One `fedsim.run` of a scenario path from the seed-0 init, with the
    eavesdropper's capture (`privacy.Adversary` and an `AttackHook`) on or
    off; the launch counters set to 0 just before and read just after.
    ms/round: the median time between synchronized chunk boundaries from
    the second on, over their rounds."""
    from repro_torch import privacy as pv
    from repro_torch.core import engine, fedsim
    stamp, hook, seen = Stamp(torch), pv.AttackHook(), Payloads()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = fedsim.run(cfg, pz, pipe, rounds, device=dev,
                     adversary=pv.Adversary() if adversary else None,
                     hooks=[stamp, hook, seen], **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, replays = read_launches(), engine.replays
    peak = torch.cuda.max_memory_allocated() / (4 * cfg.param_count())
    if len(res.losses) != rounds or not all(map(math.isfinite, res.losses)):
        raise AssertionError(f"losses {res.losses}")
    bounds = engine.chunk_boundaries(0, rounds, kw.get("chunk_rounds", 1)
                                     if kw.get("engine") == "scan" else 1)
    spans = [(stamp.times[c] - stamp.times[c - 1]) / (b - a)
             for c, (a, b) in enumerate(bounds) if c > 0]
    return {"res": res, "hook": hook, "seen": seen, "captured": adversary,
            "launches": launches,
            "replays": replays, "peak_theta": peak, "wall": wall,
            "ms_per_round": statistics.median(spans) * 1e3,
            "bounds": bounds}


def scenario_expected_launches(cfg, pz, rounds: int,
                               captured: bool) -> dict:
    """`expected_launches` of the path, plus under ZO desync each
    direction's fresh-mode dual forward on the lagged seed: two rollouts,
    each one axpy a leaf (w ± μz into a new tree) and one forward; under
    FO with the capture on, the forward over client 0's rows a round."""
    from repro_torch.models import registry
    fo = pz.transport.mechanism == "fo"
    out = expected_launches(cfg, rounds, False, fo=fo,
                            n_perturb=pz.zo.n_perturb)
    if fo and captured:
        out["flash_attention"] += rounds * attention_calls(cfg)
    if not fo and pz.desync is not None:
        stale = rounds * pz.zo.n_perturb * 2
        out["seeded_axpy"] += stale * len(registry.shapes(cfg))
        out["flash_attention"] += stale * attention_calls(cfg)
    return out


def scenario_gates(name: str, run: dict, cfg, pz, what: str) -> None:
    """Exact launches, the uplink bill (the defense's through
    `uplink_bits_total`: robust_decode bills one payload a client-round on
    ATTACK_GROUPS resource blocks, no extra bits), the privacy spend and
    the path's peak gate."""
    import numpy as np
    from repro_torch import byzantine as byz
    from repro_torch.core import transport as tp
    rounds = len(run["res"].losses)
    expected = scenario_expected_launches(cfg, pz, rounds,
                                          run["captured"])
    if run["launches"] != expected:
        raise AssertionError(f"{name} {what}: launches {run['launches']}, "
                             f"expected {expected}")
    res, k_eff = run["res"], run["seen"].k_eff
    mech, defense = tp.resolve(pz), byz.resolve_defense(pz)
    d = cfg.param_count()
    plain_bits = mech.payload_bits(pz, d) * float(np.sum(k_eff))
    want = tp.uplink_bits_total(mech, defense, pz, d, float(np.sum(k_eff)),
                                rounds)
    if res.uplink_bits != want or want != round(plain_bits):
        raise AssertionError(f"{name} {what}: uplink bits "
                             f"{res.uplink_bits}, want {want}")
    if defense is not None and defense.resource_blocks() != ATTACK_GROUPS:
        raise AssertionError(f"{name}: {defense.resource_blocks()} resource "
                             f"blocks, want {ATTACK_GROUPS}")
    fo = mech.kind == "fo"
    if not (res.privacy_spent == 0 if fo else res.privacy_spent > 0):
        raise AssertionError(f"{name} {what}: privacy spent "
                             f"{res.privacy_spent}")
    gate = FO_DESYNC_PEAK_THETA if fo else ATTACKED_PEAK_THETA
    if not run["peak_theta"] < gate:
        raise AssertionError(f"{name} {what}: peak {run['peak_theta']:.2f} "
                             f"x theta, want < {gate}")
    print(f"path {name} {what}: {rounds} rounds, run {run['wall']:.3f} s, "
          f"steady {run['ms_per_round']:.1f} ms/round; losses "
          f"{res.losses}; p_hat {res.p_hats}; privacy spent "
          f"{res.privacy_spent:.6g}; uplink bits {res.uplink_bits}"
          + (f" on {defense.resource_blocks()} resource blocks"
             if defense is not None else "")
          + f"; peak {run['peak_theta']:.2f} x theta (gate {gate}); "
          f"launches {run['launches']}", flush=True)


def same_scenario(name: str, a: dict, b: dict, final_a, torch,
                  what: str) -> None:
    """Run b equals run a bitwise: losses, p̂, the clients' payloads, the
    captured observations (both, when both captured) and the final state
    (parameters, and under FO both Adam moments)."""
    import numpy as np
    ra, rb = a["res"], b["res"]
    if ra.losses != rb.losses or ra.p_hats != rb.p_hats:
        raise AssertionError(f"{name} {what}: losses {rb.losses} p_hat "
                             f"{rb.p_hats} vs {ra.losses} {ra.p_hats}")
    if a["seen"].p_clients != b["seen"].p_clients:
        raise AssertionError(f"{name} {what}: p_clients differ")
    oa, ob = a["hook"].observations(), b["hook"].observations()
    if oa and ob and (oa.keys() != ob.keys() or not all(
            np.array_equal(oa[k], ob[k]) for k in oa)):
        raise AssertionError(f"{name} {what}: captured observations differ")
    mine = final_state(torch, rb, name)
    if mine.keys() != final_a.keys() or not all(
            torch.equal(v, final_a[k]) for k, v in mine.items()):
        raise AssertionError(f"{name} {what}: final parameters (or Adam "
                             "moments) differ")


def run_attacked_path(torch, dev, cfg) -> dict:
    """The `attacked` path: loop, scan and a loop run without the
    adversary, each gated (`scenario_gates`), scan and the capture-off run
    bitwise the loop run; then the stale forward's share of a round (a
    loop run with desync off), seed_replay on the capture and the ε̂ audit
    at AUDIT_TRIALS paired traces on the card, its statistics held against
    the same call on the CPU."""
    import numpy as np
    from repro_torch import byzantine as byz
    from repro_torch import privacy as pv
    from repro_torch.privacy import audit as pa
    from repro_torch.runtime import desync as ds
    name = "attacked"
    pz, pipe = scenario_setup(name, cfg)
    rounds, chunk = SCENARIO_SCAN[name]
    stale = ds.resolve(pz).sync_trace(0, rounds, pz.n_clients)[0]
    cohort = byz.resolve_behavior(pz).client_mask(pz.n_clients)
    if not stale.sum() > 0 or cohort.sum() != 1:
        raise AssertionError(f"attacked: stale rows {stale.tolist()}, "
                             f"cohort {cohort.tolist()}")
    loop = scenario_run(torch, dev, cfg, pz, pipe, rounds)
    scenario_gates(name, loop, cfg, pz, "loop")
    final = final_state(torch, loop["res"], name)
    loop["res"].params = None
    scan = scenario_run(torch, dev, cfg, pz, pipe, rounds, engine="scan",
                        chunk_rounds=chunk)
    scenario_gates(name, scan, cfg, pz, "scan")
    if scan["replays"] != rounds - len(scan["bounds"]):
        raise AssertionError(f"attacked scan: {scan['replays']} replays")
    same_scenario(name, loop, scan, final, torch, "scan")
    scan["res"].params = None
    off = scenario_run(torch, dev, cfg, pz, pipe, rounds, adversary=False)
    scenario_gates(name, off, cfg, pz, "adversary off")
    same_scenario(name, loop, off, final, torch, "adversary off")
    off["res"].params = None
    synced = scenario_run(torch, dev, cfg, dataclasses.replace(
        pz, desync=None), pipe, rounds, adversary=False)
    synced["res"].params = None
    share = 1.0 - synced["ms_per_round"] / loop["ms_per_round"]
    print(f"path attacked: stale clients per round {stale.sum(axis=1)}; "
          f"scan and the capture-off loop equal the loop run bitwise "
          f"(losses, p_hat, p_clients, obs_y, final weights); loop "
          f"{loop['ms_per_round']:.1f} ms/round, scan "
          f"{scan['ms_per_round']:.1f}, desync off "
          f"{synced['ms_per_round']:.1f}: the stale forward {share:.3f} of "
          "a round", flush=True)

    res, hook = loop["res"], loop["hook"]
    audited = byz.resolve_defense(pz).audited_pz(pz)
    sent = np.asarray(res.transport.transmitted(hook.payloads()))
    replay = pv.get("seed_replay")().run(hook.observations(), sent,
                                         res.schedule.c, hook.k_eff())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = pv.audit_transport(res.transport, res.schedule, audited,
                                rounds=res.steps, trials=AUDIT_TRIALS,
                                spent=res.privacy_spent, device=dev)
    audit_s = time.perf_counter() - t0
    if not result.dominated or result.trials != AUDIT_TRIALS:
        raise AssertionError(f"attacked: audit {result.to_dict()}")
    canary = res.transport.canary_payload(audited)
    kw = dict(rounds=res.steps, n_clients=pz.n_clients, trials=AUDIT_TRIALS)
    on_card = pa.paired_trace_statistics(res.transport, res.schedule,
                                         canary, device=dev, **kw)
    on_cpu = pa.paired_trace_statistics(res.transport, res.schedule,
                                        canary, device="cpu", **kw)
    # a statistic is a sum of signed per-round LLRs and may lie near 0, so
    # its error is taken relative to the largest statistic of its arm
    worst = max(float(np.max(np.abs(g - w)) / np.max(np.abs(w)))
                for g, w in zip(on_card, on_cpu))
    each = max(float(np.max(np.abs(g - w) / np.abs(w)))
               for g, w in zip(on_card, on_cpu))
    if not worst <= AUDIT_RTOL:
        raise AssertionError(f"attacked: paired statistics on the card "
                             f"{worst:.3g} of the largest from the CPU's, "
                             f"want <= {AUDIT_RTOL}")
    on_cpu_audit = pv.audit_transport(
        res.transport, res.schedule, audited, rounds=res.steps,
        trials=AUDIT_TRIALS, spent=res.privacy_spent, device="cpu")
    if on_cpu_audit.dominated != result.dominated:
        raise AssertionError(f"attacked: audit on the CPU "
                             f"{on_cpu_audit.to_dict()}")
    print(f"path attacked: seed_replay victim_rmse "
          f"{replay['victim_rmse']:.6g}, mean_rmse {replay['mean_rmse']:.6g}"
          f", mean_corr {replay['mean_corr']:.6g}; audit eps_hat "
          f"{result.eps_hat:.6g} <= analytic {result.eps_analytic:.6g} "
          f"(spent {result.spent:.6g}, {AUDIT_TRIALS} trials x "
          f"{result.rounds} rounds, fpr {result.fpr:.4g}, fnr "
          f"{result.fnr:.4g}) in {audit_s:.3f} s on the card (eps_hat on "
          f"the CPU {on_cpu_audit.eps_hat:.6g}); paired statistics within "
          f"{worst:.3g} of the largest of the CPU's (gate {AUDIT_RTOL}; "
          f"each within {each:.3g} of its own)", flush=True)
    return {"name": name, "launches": loop["launches"],
            "peak_theta": loop["peak_theta"],
            "ms_per_round": loop["ms_per_round"],
            "scan_ms_per_round": scan["ms_per_round"],
            "scan_peak_theta": scan["peak_theta"],
            "stale_share": share, "audit_s": audit_s,
            "eps_hat": result.eps_hat, "eps_analytic": result.eps_analytic}


def run_fo_desync_path(torch, dev, cfg) -> dict:
    """The `fo-desync` path: FO-Adam under desync with client 0's
    gradient captured, on the loop and the scan engine (scan ≡ loop
    bitwise, Adam moments and the captured gradients too), each gated;
    then DLG on round 0's captured gradient for client 0's batch, from
    the seed-0 init the run started from: DLG_CHECK_STEPS steps with the
    kernels held against the same steps with the plain versions on the
    card (residuals rtol DLG_PLAIN_RTOL), then the reference's 600."""
    import numpy as np
    from repro_torch import prng
    from repro_torch import privacy as pv
    from repro_torch.models import registry
    name = "fo-desync"
    pz, pipe = scenario_setup(name, cfg)
    rounds, chunk = SCENARIO_SCAN[name]
    loop = scenario_run(torch, dev, cfg, pz, pipe, rounds)
    scenario_gates(name, loop, cfg, pz, "loop")
    final = final_state(torch, loop["res"], name)
    loop["res"].params = loop["res"].opt_state = None
    scan = scenario_run(torch, dev, cfg, pz, pipe, rounds, engine="scan",
                        chunk_rounds=chunk)
    scenario_gates(name, scan, cfg, pz, "scan")
    if scan["replays"] != rounds - len(scan["bounds"]):
        raise AssertionError(f"fo-desync scan: {scan['replays']} replays")
    same_scenario(name, loop, scan, final, torch, "scan")
    scan["res"].params = scan["res"].opt_state = None
    del final
    g0 = loop["hook"].observations()["obs_grad0"]
    if g0.shape != (rounds, cfg.param_count()) or not np.isfinite(g0).all():
        raise AssertionError(f"fo-desync: obs_grad0 {g0.shape}")
    print(f"path fo-desync: scan equals the loop run bitwise (losses, "
          f"final weights, both Adam moments, obs_grad0 [{rounds}, "
          f"{cfg.param_count()}]); loop {loop['ms_per_round']:.1f} "
          f"ms/round, scan {scan['ms_per_round']:.1f}", flush=True)
    release_device_memory(torch)

    params = registry.init_params(cfg, prng.key(pz.seed), dev)
    batch = pipe.batch(0)
    kw = dict(targets=batch["targets"][0], mask=batch["mask"][0],
              true_tokens=batch["tokens"][0])
    g_star = g0[0]
    del g0
    short = pv.get("dlg")(steps=DLG_CHECK_STEPS)
    with_kernels = short.run(cfg, params, g_star, **kw)["residuals"]
    with plain_versions():
        plain = short.run(cfg, params, g_star, **kw)["residuals"]
    worst = float(np.max(np.abs(with_kernels - plain) / np.abs(plain)))
    if not worst <= DLG_PLAIN_RTOL:
        raise AssertionError(f"fo-desync: DLG residuals with the kernels "
                             f"{with_kernels} vs plain {plain}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    attack = pv.get("dlg")()
    out = attack.run(cfg, params, g_star, **kw)
    torch.cuda.synchronize()
    dlg_s = time.perf_counter() - t0
    dlg_launches = read_launches()
    dlg_peak = torch.cuda.max_memory_allocated() / (4 * cfg.param_count())
    if not math.isfinite(out["final_residual"]) \
            or dlg_launches["flash_attention"] != attack.steps \
            * attention_calls(cfg):
        raise AssertionError(f"fo-desync: DLG {out['final_residual']}, "
                             f"launches {dlg_launches}")
    print(f"path fo-desync: DLG ({attack.steps} steps, embed space, "
          f"cosine) on round "
          f"0's obs_grad0 for client 0's {list(kw['targets'].shape)} batch: "
          f"{dlg_s:.3f} s, final_residual {out['final_residual']:.6g} (step "
          f"0: {out['residuals'][0]:.6g}), token_accuracy "
          f"{out['token_accuracy']:.6g} (chance {out['chance_accuracy']:.3g})"
          f", peak {dlg_peak:.2f} x theta, flash launches "
          f"{dlg_launches['flash_attention']}; its first {DLG_CHECK_STEPS} "
          f"residuals with the kernels within {worst:.3g} of the plain "
          f"versions' (rtol {DLG_PLAIN_RTOL})", flush=True)
    return {"name": name, "launches": loop["launches"],
            "peak_theta": loop["peak_theta"],
            "ms_per_round": loop["ms_per_round"],
            "scan_ms_per_round": scan["ms_per_round"],
            "scan_peak_theta": scan["peak_theta"], "dlg_s": dlg_s,
            "dlg_final_residual": out["final_residual"],
            "dlg_token_accuracy": out["token_accuracy"]}


def round_flops(cfg, pz, clients: int, batch: int, seq: int) -> dict:
    """The operations of one chained round of a dense transformer, from its
    shapes (the gate `cost_stats["flops"]` is held to).

    A chained round runs 2·n_perturb forwards (w + μz and w − μz for each
    direction), each over T = clients · batch · seq tokens, and walks every
    leaf 3 times a direction with `seeded_axpy` (perturb, flip, restore
    and update), 12 f32 operations an element (`seeded_axpy.flops`). A
    forward, per token: in each layer the attention's projections 2·d·(Hq
    + 2·Hkv + Hq)·hd and the gated MLP's three matmuls 2·3·d·d_ff, then
    the untied lm head 2·d·V; and in each layer flash_attention over the
    clients · batch sequences, each head's seq·(seq+1)/2 causal pairs at
    4·hd + 3 operations (`flash_attention.flops`). The loss's log-softmax,
    the norms and the activations are elementwise and not counted (as
    `FlopCounterMode` counts none of them).

    OPT-125M at the training CLI's defaults (5 clients, batch 8, seq 64,
    n_perturb 4; d 768, 12 heads of 64, d_ff 3072, V 50272, 12 layers,
    θ = 190,474,752 parameters): 303.7 MFLOP a token, 777.5 GFLOP of
    matmuls and 3.1 GFLOP of attention a forward, 27.4 GFLOP of axpys, so
    6.27 TFLOP a round."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    tokens = clients * batch * seq
    per_token = cfg.n_layers * (2 * d * (2 * hq + 2 * hkv) * hd
                                + 2 * 3 * d * cfg.d_ff) \
        + 2 * d * cfg.vocab_size
    attention = cfg.n_layers * clients * batch * hq * (
        seq * (seq + 1) // 2) * (4 * hd + 3)
    n_perturb = pz.zo.n_perturb
    forwards = 2 * n_perturb
    axpy = 3 * n_perturb * cfg.param_count() * 12
    return {"matmul": float(forwards * per_token * tokens),
            "attention": float(forwards * attention),
            "axpy": float(axpy),
            "total": float(forwards * (per_token * tokens + attention)
                           + axpy)}


def observed_run(torch, dev, cfg, pz, pipe, rounds: int, mode: str,
                 logdir=None, **kw) -> dict:
    """One chained OPT-125M run from the seed init, `mode` "off",
    "telemetry" (`cost=True`, memory every 4 rounds, a `MetricsSink` and a
    warn-policy `HealthMonitor`), "profiled" (those and a
    `ProfilerSession` around the run) or "guarded" (no telemetry; an
    abort-policy `HealthMonitor` and a `CheckpointHook` whose saver never
    saves, so every boundary takes the checkpoint-then-abort copy, as a
    guarded run's does); the cached executors freed first
    (a graph kept from an earlier run holds its memory pool), launch
    counts set to 0 just before and read just after, the allocator's peak
    reset before and read right after the run returns, before the
    profiler stops. ms/round: the median over chunks 2 onward of the time
    between synchronized boundary stamps, over their rounds."""
    from repro_torch import obs
    from repro_torch.core import engine, fedsim
    stamp = Stamp(torch)
    hooks = [stamp]
    telemetry = sink = profiler = None
    if mode != "off":
        telemetry = obs.Telemetry.on(memory_sample_every=4, cost=True)
        sink = obs.MetricsSink(os.path.join(logdir, f"{mode}.jsonl"))
        hooks += [sink, obs.HealthMonitor("warn")]
    if mode == "profiled":
        profiler = obs.ProfilerSession(logdir=os.path.join(logdir, "prof"))
    if mode == "guarded":
        hooks.append(obs.HealthMonitor("abort"))
        kw = dict(kw, checkpoint_dir=os.path.join(logdir, "guard"),
                  checkpoint_every=GUARD_EVERY)
    release_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    if profiler is not None:
        profiler.start()
    t0 = time.perf_counter()
    res = fedsim.run(cfg, pz, pipe, rounds, device=dev, hooks=hooks,
                     telemetry=telemetry, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    if profiler is not None:
        profiler.stop()
    bounds = engine.chunk_boundaries(0, rounds, kw.get("chunk_rounds", 1)
                                     if kw.get("engine") == "scan" else 1)
    per_round = [(stamp.times[c] - stamp.times[c - 1]) / (b - a)
                 for c, (a, b) in enumerate(bounds) if c > 0]
    return {"res": res, "wall": wall, "peak": peak, "launches": launches,
            "ms_per_round": statistics.median(per_round) * 1e3,
            "telemetry": telemetry, "sink": sink, "profiler": profiler}


def boundary_copy_ms(torch, params, reps: int = 5) -> tuple:
    """The checkpoint-then-abort copy of one boundary
    (`fedsim._BoundaryCopy.take`, every leaf into pinned host buffers, on
    the stream): the median of `reps` synchronized copies after one that
    allocates the buffers, and the host's share (the enqueue alone)."""
    from repro_torch.core import fedsim
    copy = fedsim._BoundaryCopy()
    copy.take(params)
    torch.cuda.synchronize()
    whole, enqueue = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        copy.take(params)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        whole.append(time.perf_counter() - t0)
        enqueue.append(t1 - t0)
    return statistics.median(whole) * 1e3, statistics.median(enqueue) * 1e3


def cli_run(argv: list) -> subprocess.CompletedProcess:
    """`python -m repro_torch.launch.train` at full width in a subprocess
    (on the card), from the repository root."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *argv], capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=600)


def check_trace_run(*args) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, str(REPO / "tools" /
                                                "check_trace.py"),
                           *map(str, args)], capture_output=True, text=True,
                          cwd=REPO, timeout=300)


def run_observed_path(torch, dev, cfg) -> dict:
    """The `observed` path: chained OPT-125M at the CLI's defaults,
    OBSERVED_ROUNDS rounds on the loop engine and then on the scan engine
    (chunks of OBSERVED_CHUNK), each with telemetry off and on: on must be
    bitwise off (losses, p̂, the final weights' fingerprint), with exact
    launches, `peak_bytes` equal to `max_memory_allocated`, the ledger's
    last row equal to the run's accounting, the merged profile holding the
    kernels, and the first round's `cost_stats` flops within COST_RTOL of
    `round_flops` (the kernels' part within KERNEL_FLOPS_RTOL of its
    attention and axpy terms), and a guarded run bitwise off with its
    overhead; then the checkpoint-then-abort copy's cost per boundary
    alone, an abort at ABORT_LR in process on each engine (its checkpoint
    bitwise the weights of a run of the same rounds), and two CLI runs in
    subprocesses: one with
    every artifact, held to `tools/check_trace.py`, and one that aborts
    (exit 3, a CRC-valid checkpoint at its last boundary)."""
    import tempfile
    from repro_torch import obs
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import fedsim
    name = "observed"
    pz, pipe = path_setup("chained", cfg, False)
    rounds, chunk = OBSERVED_ROUNDS, OBSERVED_CHUNK
    want_flops = round_flops(cfg, pz, 5, 8, 64)
    expected = expected_launches(cfg, rounds, False)
    theta_bytes = 4 * cfg.param_count()
    out = {"name": name}
    t_path = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="observed_") as tmp:
        for engine_name, kw in (("loop", {}),
                                ("scan", dict(engine="scan",
                                              chunk_rounds=chunk))):
            t_engine = time.perf_counter()
            logdir = os.path.join(tmp, engine_name)
            os.makedirs(logdir)
            runs = {}
            # the guarded run next to the plain run it is timed against
            for mode in ("off", "guarded", "telemetry", "profiled"):
                run = runs[mode] = observed_run(torch, dev, cfg, pz, pipe,
                                                rounds, mode, logdir=logdir,
                                                **kw)
                run["final"] = fingerprint(torch, run["res"].params)
                run["res"].params = None
            off = runs["off"]
            what = f"{name} {engine_name}"
            for mode in ("telemetry", "profiled"):
                res, ref, on = runs[mode]["res"], off["res"], runs[mode]
                if res.losses != ref.losses or res.p_hats != ref.p_hats \
                        or on["final"] != off["final"]:
                    raise AssertionError(f"{what} {mode}: telemetry on "
                                         f"differs from off: losses "
                                         f"{res.losses} vs {ref.losses}")
                if res.peak_bytes != on["peak"] or on["peak"] <= 0:
                    raise AssertionError(f"{what} {mode}: peak_bytes "
                                         f"{res.peak_bytes} != "
                                         f"max_memory_allocated "
                                         f"{on['peak']}")
                # telemetry keeps nothing on the card: a run it kept alive
                # (a reference cycle through a hook) would add a θ
                if not on["peak"] - off["peak"] <= OBSERVED_PEAK_SLACK \
                        * theta_bytes:
                    raise AssertionError(f"{what} {mode}: peak "
                                         f"{on['peak']} vs off "
                                         f"{off['peak']}")
                final_row = obs.final_row(on["sink"].path)
                if (final_row["bits_cum"], final_row["dp_spent_cum"],
                        final_row["peak_bytes"]) != (res.uplink_bits,
                                                     res.privacy_spent,
                                                     res.peak_bytes):
                    raise AssertionError(f"{what} {mode}: ledger "
                                         f"{final_row} vs the run's "
                                         "accounting")
                cost = res.cost_stats
                err = abs(cost["flops"] - want_flops["total"]) \
                    / want_flops["total"]
                if not err <= COST_RTOL:
                    raise AssertionError(f"{what} {mode}: cost_stats flops "
                                         f"{cost['flops']:.6g}, analytic "
                                         f"{want_flops}")
                # the kernels count their own work: the attention and axpy
                # terms, which are under 1% of the total
                want_kernel = want_flops["attention"] + want_flops["axpy"]
                if not abs(cost["kernel_flops"] - want_kernel) \
                        <= KERNEL_FLOPS_RTOL * want_kernel:
                    raise AssertionError(f"{what} {mode}: the kernels' "
                                         f"flops {cost['kernel_flops']!r}, "
                                         f"analytic {want_kernel!r}")
            guarded = runs["guarded"]
            if guarded["res"].losses != off["res"].losses \
                    or guarded["res"].p_hats != off["res"].p_hats \
                    or guarded["final"] != off["final"]:
                raise AssertionError(f"{what} guarded: the run with the "
                                     f"abort snapshot differs from off: "
                                     f"{guarded['res'].losses}")
            for mode, run in runs.items():
                if run["launches"] != expected:
                    raise AssertionError(f"{what} {mode}: launches "
                                         f"{run['launches']}, expected "
                                         f"{expected}")
            prof = runs["profiled"]
            events, meta = prof["profiler"].device_events(
                prof["telemetry"].tracer.epoch)
            kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
            ours = [k for k in PROFILED_KERNELS if
                    not any(k in n for n in kernels)]
            if "error" in meta or not meta["anchor"] or ours:
                raise AssertionError(f"{what}: profile {meta}; kernels "
                                     f"missing {ours}")
            res = prof["res"]
            cost = res.cost_stats
            tel_ms = runs["telemetry"]["ms_per_round"] - off["ms_per_round"]
            prof_ms = prof["ms_per_round"] - off["ms_per_round"]
            guard_ms = guarded["ms_per_round"] - off["ms_per_round"]
            tflops = cost["flops"] / (off["ms_per_round"] * 1e-3) / 1e12
            modes = ("off", "telemetry", "profiled", "guarded")
            peaks = " / ".join(f"{runs[m]['peak'] / theta_bytes:.2f}"
                               for m in modes)
            extra = " / ".join(str(runs[m]["peak"] - off["peak"])
                               for m in ("telemetry", "profiled", "guarded"))
            # the first round's dispatch (counted) against the second's
            first = [s["dur"] * 1e3 for s in
                     runs["telemetry"]["telemetry"].tracer.spans("dispatch")
                     [:2]]
            print(f"path {what}: telemetry (cost, memory, ledger, health "
                  f"warn) and telemetry with the profiler equal off "
                  f"bitwise (losses {res.losses}, p_hat, final weights); "
                  f"ms/round off {off['ms_per_round']:.1f}, telemetry "
                  f"{runs['telemetry']['ms_per_round']:.1f} (overhead "
                  f"{tel_ms:.1f}), profiled {prof['ms_per_round']:.1f} "
                  f"(overhead {prof_ms:.1f}), guarded (abort monitor and "
                  f"saver, the boundary copy each chunk, bitwise off) "
                  f"{guarded['ms_per_round']:.1f} (overhead "
                  f"{guard_ms:.1f}); wall "
                  + " / ".join(f"{runs[m]['wall']:.3f}" for m in modes)
                  + f" s; the telemetry run's first dispatch (counted) "
                  f"{first[0]:.1f} ms, its second {first[1]:.1f}; peak off "
                  f"/ telemetry / profiled / guarded {peaks} x theta "
                  f"(+{extra} bytes),"
                  f" each run's peak_bytes = max_memory_allocated; cost_stats "
                  f"flops {cost['flops']:.6g} vs analytic "
                  f"{want_flops['total']:.6g} (err {err:.2e}; matmul "
                  f"{want_flops['matmul']:.6g}, attention "
                  f"{want_flops['attention']:.6g}, axpy "
                  f"{want_flops['axpy']:.6g}; kernels "
                  f"{cost['kernel_flops']:.6g}), bytes "
                  f"{cost['bytes_accessed']:.6g} (kernels "
                  f"{cost['kernel_bytes']:.6g}), {tflops:.1f} TFLOP/s at "
                  f"the off run's ms/round; compile_stats "
                  f"{res.compile_stats}; profile {meta['events']} events, "
                  f"{meta['kernels']} kernels; "
                  f"{len(prof['telemetry'].tracer.events())} host events; "
                  f"{time.perf_counter() - t_engine:.1f} s", flush=True)
            out[f"{engine_name}_telemetry_ms"] = tel_ms
            out[f"{engine_name}_profiled_ms"] = prof_ms
            out[f"{engine_name}_guarded_ms"] = guard_ms
            out[f"{engine_name}_ms_per_round"] = off["ms_per_round"]
            out["tflops"] = tflops
            if engine_name == "loop":
                out["launches"] = off["launches"]
                out["cost_flops"] = cost["flops"]
            del runs, off, prof, res, events
            release_device_memory(torch)

        # the checkpoint-then-abort copy of one boundary
        from repro_torch import prng
        from repro_torch.models import registry
        params = registry.init_params(cfg, prng.key(pz.seed), dev)
        copy_ms, enqueue_ms = boundary_copy_ms(torch, params)
        del params
        out["abort_copy_ms"] = copy_ms
        print(f"path {name}: checkpoint-then-abort copy {copy_ms:.2f} ms a "
              f"boundary ({theta_bytes / copy_ms / 1e6:.1f} GB/s for "
              f"{theta_bytes / 1e6:.1f} MB; the host's enqueue "
              f"{enqueue_ms:.3f} ms); end to end, the guarded runs' "
              f"overhead {out['loop_guarded_ms']:.1f} ms/round on loop (a "
              f"copy every round), {out['scan_guarded_ms']:.1f} on scan "
              f"(one every {chunk} rounds)", flush=True)

        # an abort in process on each engine: its checkpoint holds the
        # boundary's weights (on the loop engine every round is one)
        diverging = dataclasses.replace(
            pz, rounds=ABORT_ROUNDS,
            zo=dataclasses.replace(pz.zo, lr=ABORT_LR, n_perturb=1))
        for engine_name, kw in (("loop", {}),
                                ("scan", dict(engine="scan",
                                              chunk_rounds=chunk))):
            t_abort = time.perf_counter()
            directory = os.path.join(tmp, f"abort_{engine_name}")
            res = fedsim.run(cfg, diverging, pipe, ABORT_ROUNDS, device=dev,
                             hooks=[obs.HealthMonitor("abort")],
                             checkpoint_dir=directory,
                             checkpoint_every=2 * chunk, **kw)
            abort_round, steps = res.health_abort_round, res.steps
            res.params = None
            path = ckpt.latest_valid(directory)
            if abort_round < 0 or path is None:
                raise AssertionError(f"{name} {engine_name}: no abort "
                                     f"({res.losses}) or no checkpoint in "
                                     f"{os.listdir(directory)}")
            boundary = int(path.rsplit("_", 1)[1])
            at = fedsim.run(cfg, diverging, pipe, boundary, device=dev,
                            **kw)
            restored, step, extra = ckpt.restore(path, at.params)
            if step != extra["round"] or fingerprint(torch, restored) \
                    != fingerprint(torch, at.params):
                raise AssertionError(f"{name} {engine_name}: the abort's "
                                     f"checkpoint at {path} is not the "
                                     f"weights after {boundary} rounds")
            print(f"path {name} {engine_name}: lr {ABORT_LR} aborts at "
                  f"round {abort_round} ({res.health_abort_reason}; losses "
                  f"{res.losses}); {steps} rounds executed, the checkpoint "
                  f"at step {step} equals the weights of a {boundary}-round"
                  f" run bitwise; {time.perf_counter() - t_abort:.1f} s",
                  flush=True)
            del at, restored
            release_device_memory(torch)

        # the CLI with every artifact, and the CLI's abort
        art = {k: os.path.join(tmp, f"cli.{k}") for k in
               ("trace.json", "metrics.jsonl", "profile.json", "out.json")}
        t0 = time.perf_counter()
        proc = cli_run(["--rounds", str(rounds), "--engine", "scan",
                        "--chunk-rounds", str(chunk),
                        "--trace-out", art["trace.json"],
                        "--metrics-out", art["metrics.jsonl"],
                        "--profile-out", art["profile.json"],
                        "--out", art["out.json"]])
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{name}: CLI exit {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        gates = ["--ledger", art["metrics.jsonl"], "--summary",
                 art["out.json"], "--expect-chunk-traces", "1",
                 "--expect-step-builds", "1"]
        t_check = time.perf_counter()
        for trace, extra_gate in ((art["trace.json"], []),
                                  (art["profile.json"],
                                   ["--require-device-lane"])):
            check = check_trace_run(trace, *gates, *extra_gate)
            if check.returncode != 0:
                raise AssertionError(f"{name}: check_trace {trace}: "
                                     f"{check.stdout[-3000:]}")
            print(f"path {name} CLI: {check.stdout.strip()}", flush=True)
        with open(art["profile.json"]) as f:
            meta = json.load(f)["otherData"]
        summary = json.loads(open(art["out.json"]).read())
        print(f"path {name} CLI: {rounds} rounds scan chunk {chunk} with "
              f"--trace-out --metrics-out --profile-out in {cli_s:.1f} s "
              f"(the run {summary['wall_time_s']} s); "
              f"profile {meta['profile']['events']} events, "
              f"{meta['profile']['kernels']} kernels; compile_stats "
              f"{meta['compile_stats']}; peak_bytes {summary['peak_bytes']}"
              f"; check_trace {time.perf_counter() - t_check:.1f} s",
              flush=True)
        t_cli = time.perf_counter()
        directory = os.path.join(tmp, "cli_abort")
        proc = cli_run(["--rounds", str(ABORT_ROUNDS), "--engine", "scan",
                        "--chunk-rounds", str(chunk), "--lr", str(ABORT_LR),
                        "--n-perturb", "1", "--health-policy", "abort",
                        "--checkpoint-dir", directory,
                        "--checkpoint-every", str(2 * chunk)])
        path = ckpt.latest_valid(directory)
        if proc.returncode != 3 or path is None \
                or not ckpt.valid_checkpoint(path):
            raise AssertionError(f"{name}: the CLI's abort exited "
                                 f"{proc.returncode}, checkpoint {path}: "
                                 f"{proc.stdout[-2000:]}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["step"] != boundary or manifest["extra"]["round"] \
                != boundary:
            raise AssertionError(f"{name}: the CLI's abort checkpoint "
                                 f"{manifest['step']}, want {boundary}")
        print(f"path {name} CLI abort: exit 3, a CRC-valid checkpoint at "
              f"step {manifest['step']} (its last boundary); "
              f"{time.perf_counter() - t_cli:.1f} s; the path "
              f"{time.perf_counter() - t_path:.1f} s", flush=True)
    return out


def training_path(torch, dev, name: str, cfg, fused: bool,
                  profiling: bool) -> list:
    """One phase-4 training path: the loop run and its gates, then the scan
    run from the same seed init, each freed before the next; the chained
    path also runs the impl check. Returns the rows for the kernels line
    (the path's, and the impl check's)."""
    out = []
    scan = SCAN[name]
    path = run_path(torch, dev, name, cfg, fused, scan)
    check_peak(name, path["peak_theta"], cfg)
    if name == "bf16-fused":
        fused_check = check_fused_against_plain(torch, dev, path)
    elif fused:
        check_fused_against_fresh(torch, dev, path)
    if name == "chained":
        out.append(run_impl_check(torch, dev, path))
    # the loop run's final weights (and Adam moments) on the host (the
    # hybrid's as checksums), taken before the profiled round moves
    # them; then freed, so the scan run's peak is its own
    final = final_state(torch, path["res"], name)
    if profiling:
        profile_run(torch, path, dev, "one round (loop engine)",
                    rounds=1, params=path["params"])
    path["params"] = path["res"].params = path["res"].opt_state = None
    torch.cuda.empty_cache()
    scanned = run_scan_path(torch, dev, path, scan, final)
    rounds, chunk, _ = scan
    if scanned["steady"] is None:
        # one chunk: time two more chunks on the cached graph
        scanned["steady"] = time_scan_chunks(
            torch, dev, path, scanned["params"], 2 * rounds, chunk)
        print(f"path {name} scan: steady {scanned['steady'] * 1e3:.1f} "
              f"ms/round over a second chunk of {chunk} (loop "
              f"{path['ms_per_round']:.1f})", flush=True)
    if profiling:
        # an FO run starts a fresh Adam state, whose leaves the cached
        # graph does not read: profile its second chunk, after the
        # capture
        skip = chunk if name == "fo" else 0
        profile_run(torch, path, dev, f"one scan chunk of {chunk} rounds",
                    skip=skip, rounds=skip + chunk, engine="scan",
                    chunk_rounds=chunk, params=scanned["params"])
    row = {k: path[k] for k in ("name", "launches", "peak_theta",
                                "ms_per_round")}
    row.update(dtype=str(path["dtype"])[6:],
               scan_ms_per_round=scanned["steady"] * 1e3,
               scan_peak_theta=scanned["peak_theta"],
               scan_reserved_theta=scanned["reserved_theta"])
    if name == "bf16-fused":
        row["fused_vs_plain"] = fused_check
    del path, scanned, final
    release_device_memory(torch)
    return [row] + out


def bf16_summary(paths: list) -> dict:
    """The bf16 paths' ms a round and peak / θ beside the f32 chained and
    fused paths' of the same call."""
    return {p["name"]: {k: p[k] for k in ("ms_per_round",
                                           "scan_ms_per_round",
                                           "peak_theta", "scan_peak_theta",
                                           "fused_vs_plain") if k in p}
            for p in paths if p["name"] in ("chained", "fused") + BF16_PATHS}


def release_device_memory(torch) -> None:
    """Free what earlier runs keep on the card, so the next path's peak is
    its own: the cached executors' graphs and their memory pools, and
    cuBLAS's workspaces (32 MiB for each pair of cuBLAS handle and stream
    it ran on: the FO runs' backward adds a handle, on the autograd
    engine's device thread, for each stream)."""
    from repro_torch.core import engine
    torch.cuda.synchronize()
    engine.get_executor.cache_clear()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()


def table2(paths: list, cfg) -> dict:
    """The paper's Table II columns from this run: peak device memory / θ
    of the chained (ZO), sign and fo (FO-Adam) paths on each engine, the
    chained path's peak over FO-Adam's (the paper's "25%"), and the uplink
    bits a round of OPT-125M under every transport at the CLI's defaults
    (5 clients, n_perturb 4, 8 quantizer bits)."""
    from repro_torch.core import transport as tp
    peaks = {p["name"]: {"loop": p["peak_theta"],
                         "scan": p["scan_peak_theta"]}
             for p in paths if p["name"] in ("chained", "sign", "fo")}
    d = cfg.param_count()
    bits = {}
    for mechanism in tp.available():
        pz = pz_defaults(cfg, rounds=800, mechanism=mechanism)
        bits[mechanism] = tp.resolve(pz).bits_per_round(pz, d)
    return {"peak_theta": peaks,
            "zo_over_fo_peak": {e: peaks["chained"][e] / peaks["fo"][e]
                                for e in ("loop", "scan")},
            "bits_per_round": bits, "d": d}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS may otherwise reduce a bf16 GEMM's split-K partials in bf16;
    # `repro` accumulates in f32 (preferred_element_type)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    start = time.perf_counter()

    def phase(what: str) -> None:
        print(f"phase done: {what}, {time.perf_counter() - start:.1f} s "
              "since the build began", flush=True)

    print(f"kernel build: {build.build():.1f} s", flush=True)
    prng_row = check_prng(torch, dev)
    rows = check_seeded_axpy(torch, dev)
    rows += [check_flash_attention(torch, dev),
             check_perturbed_matmul(torch, dev), check_ssd_scan(torch, dev),
             check_rglru_scan(torch, dev)]
    rows += check_bf16_kernels(torch, dev)
    release_device_memory(torch)
    phase("1-2, the build, prng and each kernel against its plain version")
    check_small_reference(torch, dev)
    check_small_serve(torch, dev)
    release_device_memory(torch)
    phase("3, the small-input references")

    opt, mamba = get_arch("opt-125m"), get_arch("mamba2-370m")
    rgemma = get_arch("recurrentgemma-2b")
    profiling = "--profile" in sys.argv[1:]
    paths = []
    for name, cfg, fused in (("chained", opt, False), ("fused", opt, True),
                             ("mamba2", mamba, False),
                             ("hybrid", rgemma, False), ("sign", opt, False),
                             ("fo", opt, False),
                             ("mla", full_width("minicpm3-4b"), False),
                             ("moe", full_width("deepseek-v2-236b"), False),
                             ("moe-fused", full_width("moonshot-v1-16b-a3b"),
                              True),
                             ("audio", full_width("whisper-medium"), False),
                             ("vlm", full_width("internvl2-76b"), False),
                             ("bf16", opt, False), ("bf16-fused", opt, True)):
        paths += training_path(torch, dev, name, cfg, fused, profiling)

    bf16_row = bf16_summary(paths)
    phase("4, the training paths (bf16 and bf16-fused, the impl check)")
    for run_scenario in (run_attacked_path, run_fo_desync_path):
        paths.append(run_scenario(torch, dev, opt))
        release_device_memory(torch)
    phase("4, the scenario paths (attacked, fo-desync)")
    paths.append(run_observed_path(torch, dev, opt))
    release_device_memory(torch)
    phase("4, the observed path")
    chained = next(p for p in paths if p["name"] == "chained")
    paths.append(run_resume_path(torch, dev, opt, chained))
    phase("5, the resume path")

    served = [run_serve_path(torch, dev, arch, profiling)
              for arch in SERVE_ARCHS]
    served += [run_serve_path(torch, dev, arch, profiling, torch.bfloat16)
               for arch in BF16_SERVE_ARCHS]
    paths += served
    phase("6, the serve paths (opt-125m and yi-6b also in bf16)")

    print(json.dumps({"serve": served}), flush=True)
    for row in served:
        if row["name"].removeprefix("serve ").split()[0] in BF16_SERVE_ARCHS:
            bf16_row[row["name"]] = {k: row[k] for k in BF16_SERVE_KEYS
                                     if k in row}
    print(json.dumps({"bf16": bf16_row, "power": smi}), flush=True)
    print(json.dumps({"table2": table2(paths, opt), "prng": prng_row}),
          flush=True)
    for row in rows:
        # a bf16 instance counts on its kernel's counter in the bf16 paths,
        # an f32 one in the others
        counter = row.get("counter", row["name"])
        dtype = row.get("dtype", "float32")
        by_path = {p["name"]: p["launches"][counter] for p in paths
                   if p.get("dtype", "float32") == dtype}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: launched by no path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
