#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, one line each:

1. require a CUDA device; pin TF32 off for matmuls and convolutions;
   print the card's ``nvidia-smi`` name and power limit;
2. build the port's CUDA kernels from ``tpu21cmvae_torch/ops/kernels/csrc``
   and print each kernel's ``ptxas`` registers and spill bytes;
3. hold K3 (the fused gram value-and-gradient kernel) against its plain
   PyTorch version on the card, at the flagship widths of
   ``pretrained/direct_synthetic.npz``, for batches 1, 37, 1024 (the
   fits'), 4096 and 65,537 and seven tier pairs (the bf16 pairs run the
   tensor-core ``fused_gram_mma.cu``; (highest, highest) the
   register-tiled ``fused_loglik_grad_gram_f32.cu``, at every tile
   height, forced, and at the height the wrapper picks; (highest,
   default) and (highest, high) ``fused_gram_mixed.cu``, fp32 forward and
   tensor-core backward, at 32 and 16 rows, forced, and at the picked
   height; on both, the value held bit for bit to the fp32 K2's at the
   same height; the reverse pairs (high, highest) and (default, highest)
   ``fused_gram_mma.cu``'s reverse mode, its tensor-core forward and an
   fp32 backward on the CUDA cores, the value held bit for bit to the
   tensor-core K2's at the value tier);
4. time K3 and its plain version at 4096 and 65,536 rows (CUDA events,
   warmup excluded, median of repeats), and the kernel's device time per
   call over back-to-back calls; then the fp32 K3 at every tile height,
   forced, in turns; then ``fused_gram_mixed.cu`` at both mixed pairs in
   turns with the fp32 K3; then the reverse mode at both reverse pairs in
   turns with the tensor-core K3 at (high, high); then K3's wide route,
   ``fused_loglik_grad_gram.cu``, at (highest, highest) and both reverse
   pairs on a randomly initialised network of hidden (3200, 64, 64), too
   wide for the register-tiled fp32 K3 and the reverse mode, held to
   plain and timed at 4096 and 65,536 rows;
5. the main path through the public entry points: load the checkpoint,
   predict (held to a float64 NumPy forward of the same file), sample a
   posterior with HMC, whose every leapfrog step runs K3 at (high,
   default) on ``fused_gram_mma.cu``, and score the draws and the truth
   by the plain likelihood at the exact tier; then a short HMC at the
   exact tier (``loglik_and_grad_fn(precision="contract",
   backend="kernel")`` into ``sample_hmc``), whose every leapfrog step
   runs K3 on ``fused_loglik_grad_gram_f32.cu``, the final walkers'
   carried log-density held to the plain exact-tier likelihood; then the
   same with a bf16 force (``grad_precision="default"``), every leapfrog
   step on ``fused_gram_mixed.cu``; then with a bf16x3 value and an exact
   force (``loglik_and_grad_fn(precision="high",
   grad_precision="highest")``), every leapfrog step on
   ``fused_gram_mma.cu``'s reverse mode, its acceptance within 0.05 of
   the exact-tier run's and its carried log-density held to the plain
   likelihood at bf16x3; each at exactly the launches its leapfrog counts
   imply;
6. hold K1 (the fused MLP) against its plain version, as predict
   (``make_fused_emulate``) and as the direct likelihood's sum of squares
   (``make_fused_loglik``), and K2 (the fused gram value) against its
   plain version, at the flagship widths for batches 1, 37, 1024
   (target-ESS MH's), 8192 and 65,537 and tiers highest, high and default (K1 runs ``fused_mlp.cu``
   at highest and the tensor-core ``fused_mlp_mma.cu`` at high and
   default; K2 ``fused_loglik_gram.cu`` at highest and
   ``fused_gram_mma.cu`` at high and default);
7. time K1 (predict and sumsq) and K2 against their plain versions at
   8192 rows (the MH batch) and 1,048,576 rows (``bench_mcmc.py``'s
   batch), and K1 sumsq and K2 at the exact tier also at 409,600 rows
   (each chain's draws, which phase 8 scores), with the kernels' device
   time per call over back-to-back calls, and print the achieved
   TFLOP/s; then the register-tiled fp32 kernels (``fused_mlp.cu``,
   ``fused_loglik_gram.cu``) at 64- and 32-row tiles, forced, in turns;
8. the gradient-free main path through the public entry points:
   ``sample_posterior(sampler="mh")`` and ``sampler="ensemble"``, whose
   every proposal batch runs K2 at high (``fused_gram_mma.cu``), then
   the draws' likelihoods through ``loglik_fn(method="direct",
   backend="kernel")`` at the exact tier (``precision="contract"``:
   ``fused_mlp.cu``) and at bf16x3 (``precision="high"``:
   ``fused_mlp_mma.cu``), the bf16x3 scores held to the exact ones by
   ``bench_mcmc.py``'s likelihood gate, and through the gram form at the
   exact tier (K2 on ``fused_loglik_gram.cu``), held to the direct form;
9. the same kernels under the operands of a foreground-marginalized
   noise spec (``model.marginalize_foreground(25.0, n_terms=5)``, flat
   and proper coefficient prior: a dense 451 × 451 whitening folded into
   the output layer): K1 (sumsq), K2 and K3 against their plain versions
   at the batches and tiers of phases 3 and 6, the existing tolerances;
   the noise-level marginal's wrap (``marginalize_noise_scale``) of K2's
   value and K3's value and gradient against the same wrap of the plain
   versions; and injection invariance on the card: the exact-tier K2
   value must not move when ``F·a`` is added to the observation, while
   the diagonal-noise value moves by hundreds of nats;
10. the marginalized posterior path through the public entry points: an
    observation with a 1.5·10³ mK foreground, the spec
    ``marginalize_noise_scale(marginalize_foreground(25.0), alpha=3,
    beta=2)`` and a Gaussian prior on tau, through
    ``sample_posterior(..., log_prior=prior.log_prior)`` for HMC, MH and
    the ensemble at the sizes of phases 5 and 8: the launch counts (read
    through the wrapped likelihood objects) equal the diagonal spec's,
    the prior narrows tau, each chain's draws are scored by the direct
    form (K1) and the gram form (K2) at the exact tier under the same
    spec and held to each other; then the diagonal and the marginalized
    runs in turns (diagonal, marginalized, marginalized, diagonal), wall
    seconds of each, and the kernels' device time per call under both
    operand sets, in turns too;
11. ``fisher_forecast`` at the truth under 25.0, the foreground-
    marginalized spec and the proper-prior noise-level marginal over it
    (each marginalization loses information), and
    ``posterior_predictive`` over the marginalized HMC chain's draws (the
    95 % band contains the truth signal in at least 80 % of the bins);
12. an importance-sampling witness of the flat-box posterior that
    shares no code with the samplers (uniform draws over the box, then
    Student-t rounds, every draw scored by the plain exact-tier
    likelihood), with its own log Z under the flat box prior; then the adaptive gradient samplers through
    ``sample_posterior``: ``sampler="chees"`` and ``"nuts"`` (4096
    walkers, NUTS to depth 6), every leapfrog step K3 at (high, default)
    through the memoized wrapper HMC uses; launches between one per
    iteration and the cap of leapfrogs per iteration; the truth typical
    in likelihood, and each sampler's marginal medians and truth ranks
    held to the witness's;
13. the fits on K3, inside the box phase 12's draws span:
    ``fit_params`` (1024 uniform starts × 300 Adam steps) and
    ``profile_likelihood`` (16 grid points of tau × 256 starts), exactly
    301 K3 launches each; the fit at least as likely as the truth less 1
    nat, the profile's peak within 1 nat of the fit, and K3's value at
    the fit and at every profile point held to the plain likelihood;
    then ``sample_posterior(sampler="mh", target_ess=…)``, whose chunks
    run K2 at high, once to a target it reaches and once to one it
    cannot reach in two chunks, the launches read per chunk;
14. batched posteriors and calibration in plain PyTorch (no kernel: the
    stacked-observation likelihoods have none): ``sample_posterior_batch``
    of 8 observations × 512 walkers with MH, HMC and NUTS (one step and,
    under NUTS, one ensemble metric per observation), NUTS's truths
    typical in likelihood and HMC's modes reached for every observation;
    ``goodness_of_fit`` of phase 5's
    HMC draws, ``goodness_of_fit_batch`` of the MH batch and a small
    ``sbc``, their p-values printed, not gated;
15. the evidence through ``log_evidence`` at the JAX package's defaults,
    on phase 5's observation: nested sampling, SMC and the stepping-stone
    ladder (warm-started by a 1024-start fit on K3 at (high, default)),
    every batch on K2 at bf16x3 (``fused_gram_mma.cu``), and Laplace
    with importance sampling at the exact tier (its ascent on the fp32
    K3, its IS rounds on the fp32 K2); nested's, SMC's and Laplace's
    log Z within max(1, 4σ) nats of phase 12's witness, the launches of
    each method counted per wrapper, and each kernel held to its plain
    version on rows the paths scored, in calls of the paths' batches;
16. parallel tempering and SMC as samplers through ``sample_posterior``
    (16 rungs × 256 walkers; 4096 particles), K2 at bf16x3: finite
    draws, every ladder edge exchanging, and each one's share of draws
    in the low-fx mode beside the witness's;
17. the variational fits and the flow evidence at the JAX defaults, on
    phase 5's observation: ``fit_advi`` (600 steps × 512 draws, one K3
    launch at (high, default) per step), ``fit_flow`` (a 400-step ADVI
    warm start, then 1500 steps × 256 draws of a 6-layer, 64-wide RealNVP
    flow, one K3 launch per step) and ``log_evidence(method="flow")``
    (the same fit, then one fp32 K2 launch on 16,384 importance draws),
    every wrapper's count set to 0 before each and held to those counts;
    the flow's log Z within max(1, 4σ) nats of phase 12's witness; K3 at
    256 and 512 rows and the fp32 K2 at 16,384 held to their plain
    versions on rows of the fits' distributions and on the sweep's own
    rows, and timed; then ``log_evidence_batch(final="nested")`` on four
    of phase 14's observations, every row through the batched Laplace
    sweep, the batched flow escalation and ``nested_sampling_batch`` (the
    stacked likelihoods in plain PyTorch), each row finite;
18. training: the flagship at full width from random weights (seed 0) on
    the reference's data scale (``synthetic_dataset(26888, 1704, 1704)``,
    106 batches of 256 per epoch) through ``DirectEmulator.train``. K1
    (contract direct likelihood), K2 (bf16x3) and K3 (high, default) are
    memoized on one observation before training; two epochs of the
    published recipe on the card and on the CPU from the same weights
    and shuffles, the first 20 steps' losses within the CPU parity
    tests' bound and the epochs' within 0.5 (past step ≈ 25 the
    trajectories separate as far as a CPU run with one weight moved by
    one ulp, rerun beside them), the card's epochs traced by
    ``torch.profiler`` for the device's busy time; 16 epochs of the
    recipe reach the verify skill's gate (mean test error < 3 %); the
    device loop (``device_loop=True``) and a run checkpointed at 8
    epochs and resumed equal the host loop, and the resumed model saves
    and reloads to the same predictions; the wrappers built before
    training, called again, equal fresh ones bit for bit and hold to
    their plain versions on the trained weights at phases 6's and 3's
    batches; then three epochs of the tier-native (bf16) fine-tune,
    printed, not gated.
19. the other families on phase 18's golden split: the shipped
    autoencoder and VAE emulators and three-member deep ensemble through
    ``load_model``; their predictions against a float64 NumPy forward of
    each file; the golden errors of ``tests/test_pretrained.py``; the
    ensemble's mixtures on every route (K1 at contract and bf16x3, direct
    form; K2 at bf16x3 and fp32; K3 at (high, default), (fp32, fp32), the
    mixed pair (fp32, bf16) and the reverse pair (bf16x3, fp32), the last
    on ``fused_gram_mma.cu``'s reverse mode), each
    one member-batched wrapper over the stacked
    weights, against the same mixtures of the plain versions at 4096 and
    8192 rows; each route's member-batched launch (M = 3) equal to the
    three members' single launches bit for bit at 37, 256 and 4096 rows,
    within tolerance of its member-batched plain version, and timed
    beside the three single launches at 256 and 4096 rows; the same two
    checks for a randomly initialised three-member ensemble of hidden
    (3200, 64, 64), too wide for the reverse mode, whose mixture at
    (bf16x3, fp32) runs ``fused_loglik_grad_gram.cu`` (one launch per
    call, counted); the shipped ensemble's HMC
    (4096, 100 + 100) and MH (8192, 200 + 500) through
    ``sample_posterior``, launching exactly member 0's count alone (one
    launch per step), the chains bit for bit those of the per-member
    mixture (three single launches per step) on the same seed, every
    route's stacked operands folded once, the draws scored at the
    contract tier by K1 and the fp32 K2, held to each other, the truth
    typical; the
    AE's and VAE's HMC (1024, 100 + 100) and MH through autograd; both
    families trained three epochs per stage from seed 0 (host loop,
    device loop and a resumed run bit for bit) and the VAE's first 20
    steps on the card held to the CPU's on the same seam normals.
20. the serving surface on the shipped checkpoint and phase 5's
    observation: ``make_server(model, port=0)`` in a daemon thread,
    ``warmup(up_to=4096)``, then over HTTP to 127.0.0.1 ``/health``;
    ``/predict`` at 1, 37 and 4096 rows (one fp32 K1 launch each, held
    to the float64 NumPy forward within 1e-5 and to the plain fp32
    predict); ``/loglik`` at 4096 rows (K2 at bf16x3, held to the plain
    likelihood there); ``/sample`` MH at phase 8's sizes (exactly 701 K2
    launches, phase 8's best-draw gate); ``/fit`` 1024 × 300 inside phase
    13's box (exactly 301 K3 launches at (bf16x3, bf16x3), the best within
    1 nat of the truth; then the served K3 held to plain, value and
    gradient, on 1024 prior draws); ``/evidence``
    Laplace at the JAX defaults (2001 K3 + 3 K2 launches, log Z within 1
    nat of phase 15's exact-tier one); ``/gof`` on the ``/sample`` draws;
    an async ``/sample`` polled through ``/result/<id>`` while
    ``/health`` answers; two concurrent ``/predict`` clients; the
    host-clock medians of 20 requests (``/predict`` at 1 and 256 rows,
    ``/loglik`` at 4096); every wrapper folded once. Then the CLI in
    subprocesses on the card: ``predict`` (held to the float64 forward),
    ``sample --sampler hmc`` (its K3 launches read from its output),
    ``export-artifact`` (replayed here on the card within 5e-5 of
    ``predict``) and ``verify`` on the synthetic split (ok, the golden
    checks SKIP).

21. the distributed half: in one process on ``Mesh([cuda:0, cuda:0])``,
    HMC at phase 5's sizes and MH at phase 8's through ``sample_posterior``
    without and with ``mesh=``, the sharded chains bit for bit the
    unsharded ones at exactly 2 × 1823 K3 and 2 × 701 K2 launches (two
    chunks of half the rows per call); the fp32 K3 at 4096 rows against
    its two 2048-row halves (tile heights and bitwise equality printed);
    two processes on the card in one gloo group (this script with
    ``--rank``), each rank's MH the unsharded chain at 701 launches of
    its half of the rows, and ``dp_fit`` of the flagship on phase 18's
    split over both, its first 20 steps within 2e-6 of the one-process
    ``fit``; ``tune_direct_halving`` (4 candidates, 2 rungs of 2 epochs)
    on that split and the CLI's ``tune --trials 2 --halving``.

22. the wide route, ``fused_loglik_grad_gram.cu``, at every K2 tier and
    K3 pair on three seeded networks the dedicated kernels refuse (by
    width, (1536,)×3; by shared memory at every pair, (4096, 4096), whose
    plan spills to the workspace; by depth, (256,)×12): held to plain at
    37, 1024, 4096 and 65,537 rows and timed at 4096 and 65,536 with the
    workspace's bytes; then HMC (K3 at (high, default)) and MH (K2 at
    bf16x3) through ``sample_posterior`` on (1536,)×3 at the launches
    their sizes imply (``wide_routes_phase``).

23. K1 on the wide route (``k1_fused_mlp_wide``) and a dense first layer
    on K2 and K3: (a) on phase 22's three networks at every tier,
    predict and Σy², held to ``fused_mlp_reference`` at 37, 1024, 4096
    and 65,537 rows and timed at 4096 and 65,536 (``k1_wide_phase``);
    (b) 65,536 rows served on (1536,)×3 through
    ``ShardedEmulator.for_model(backend="kernel")`` at bf16x3, its wide
    K1 launches counted and the signals held to ``predict_fn``
    (``served_wide_phase``); (c) a seeded fan-in-12 direct model of the
    flagship's hidden widths: K2 at every tier and K3 at every pair held
    to plain at 37, 4096 and 65,537 rows (gradients at a tensor-core
    value tier pooled over the 69,670 rows), timed, and HMC (K3 at
    (high, default), 4096 walkers, 20 + 20) through ``sample_posterior``
    at its launches (``fan_in_phase``); (d) the flagship's K1 launches
    and every earlier wrapper's route unchanged (``main_path_guard``).

Then one JSON line listing every kernel with its time, its plain
version's and its bound (phase 18's launches under
``launches_trained``, beside the total; phase 19's under
``launches_ensemble`` and phase 20's under ``launches_serve`` and
``launches_cli``, in it; phase 23's served wide K1 under ``fused_mlp_wide``
and its fan-in HMC under ``launches_fan_in_hmc``; phase 21's sharded runs under
``launches_mesh`` and each rank's under ``launches_mesh_ranks``, beside;
the served wrappers' largest |Δ| from plain under
``max_abs_err_serve``), the card's name and power limit, and a last
line
``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero without that line; it also exits non-zero, with
no result, where no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpu21cmvae_torch.data.synthetic import PAR_RANGES, synthetic_dataset, synthetic_params
from tpu21cmvae_torch.foregrounds import linlog_basis
from tpu21cmvae_torch.models import load_model
from tpu21cmvae_torch.models.autoencoder import AutoEncoderEmulator
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.models.ensemble import DeepEnsemble
from tpu21cmvae_torch.models.vae import VAEEmulator
from tpu21cmvae_torch.noisescale import marginalize_noise_scale
from tpu21cmvae_torch.ops.kernels import _build
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    loglik_grad_gram_members_reference,
    loglik_grad_gram_reference,
    loglik_gram_members_reference,
    loglik_gram_reference,
    make_fused_loglik,
    make_fused_loglik_grad_gram,
    make_fused_loglik_gram,
    ops_plan,
    pack_wide_operands,
    WideLaunch,
)
from tpu21cmvae_torch.ops.kernels.fused_mlp import (
    _fused_mlp_wide_cuda,
    fused_mlp_members_reference,
    fused_mlp_reference,
    k1_wide_plan,
    make_fused_emulate,
    pack_wide_mlp,
)
from tpu21cmvae_torch.ops.kernels.wide import WideLaunch as K1WideLaunch
from tpu21cmvae_torch.ops.loglik import make_loglik, make_loglik_and_grad
from tpu21cmvae_torch.priors import GaussianBoxPrior
from tpu21cmvae_torch.sampling.gradient import sample_hmc
from tpu21cmvae_torch.sampling.mh import sample_mh
from tpu21cmvae_torch.ops.transforms import preproc
from tpu21cmvae_torch.utils.config import (
    AE_EMULATOR_TRAIN_DEFAULT,
    AE_TRAIN_DEFAULT,
    DIRECT_TRAIN_DEFAULT,
    DirectEmulatorConfig,
)
from tpu21cmvae_torch.ops.fold import _log_clamp, tier_matmul
from tpu21cmvae_torch.ops.transforms import Normalizer
from tpu21cmvae_torch.parallel.inference import ShardedEmulator
from tpu21cmvae_torch.ops.mlp import fused_skinny_dense
from tpu21cmvae_torch.utils.metrics import (
    grad_gate_beside,
    grad_gate_violation,
    error,
    grad_rel_error,
    loglik_gate_violation,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "pretrained", "direct_synthetic.npz")
KERNELS = "tpu21cmvae_torch/ops/kernels/csrc/"
K1_SOURCE, K1_REPLACES = KERNELS + "fused_mlp.cu", "tpu21cmvae/ops/pallas/fused_mlp.py:357"
K1_MMA_SOURCE = KERNELS + "fused_mlp_mma.cu"  # K1 at the bf16 tiers
K2_SOURCE = KERNELS + "fused_loglik_gram.cu"
K2_REPLACES = "tpu21cmvae/ops/pallas/fused_loglik.py:204"
K3_SOURCE = KERNELS + "fused_loglik_grad_gram.cu"  # K3 on a network too wide for the others
K3_F32_SOURCE = KERNELS + "fused_loglik_grad_gram_f32.cu"  # K3 at (fp32, fp32)
K3_MIXED_SOURCE = KERNELS + "fused_gram_mixed.cu"  # K3 at (fp32, bf16 tier)
K3_REPLACES = "tpu21cmvae/ops/pallas/fused_loglik.py:401"
GRAM_MMA_SOURCE = KERNELS + "fused_gram_mma.cu"  # K2 and K3 at the bf16 tiers
TIERS = ("highest", "high", "default")
TIER_PAIRS = (("highest", "highest"), ("highest", "default"), ("high", "high"),
              ("high", "default"), ("highest", "high"), ("high", "highest"),
              ("default", "highest"))
# Phases 3-4 draw the rows of these pairs and of the fp32 K3's heights from
# the smoke's generator, and those of every pair, height and turn after
# them from a generator of their own (ADDED_SEED), so that the observation
# of phases 5-21, drawn from the smoke's generator after them, stays the
# same whatever kernel checks are added.
FIRST_PAIRS, ADDED_SEED = TIER_PAIRS[:4], 3
MAIN_TIERS = ("high", "default")  # what sample_posterior runs K3 at
EXACT_TIERS = ("highest", "highest")  # K3 on fused_loglik_grad_gram_f32.cu
MIXED_TIERS = ("highest", "default")  # K3 on fused_gram_mixed.cu: an exact value, a bf16 force
MIXED_PAIRS = (MIXED_TIERS, ("highest", "high"))
# K3 on fused_gram_mma.cu's reverse mode: a tensor-core forward, an fp32 backward
REVERSE_TIERS = ("high", "highest")
REVERSE_PAIRS = (REVERSE_TIERS, ("default", "highest"))
# K3's wide route, fused_loglik_grad_gram.cu: (fp32, fp32) and the reverse
# pairs on a network whose widest layer does not fit two 8-row fp32
# buffers, randomly initialised from WIDE_SEED
WIDE_HIDDEN, WIDE_SEED = (3200, 64, 64), 5
WIDE_PAIRS = (EXACT_TIERS, *REVERSE_PAIRS)
# Phase 22: the wide route at every K2 tier and K3 pair on three seeded
# networks the dedicated kernels refuse (by width at the samplers' tiers,
# by the workspace at every pair, by depth), and the samplers on the
# first; rows and networks from a generator of their own
WIDE_NETS = {"1536x3": (1536, 1536, 1536), "4096x2": (4096, 4096), "256x12": (256,) * 12}
WIDE_ROUTES_SEED = 22
WIDE_ROUTES = [(t, None) for t in TIERS] + [(a, b) for a in TIERS for b in TIERS]
# Phase 23: K1's wide route on phase 22's networks, the served path on
# (1536,)×3 at bf16x3 (where the dedicated K1 refuses it), and a seeded
# fan-in-12 direct model of the flagship's hidden widths
K1_WIDE_BATCHES = (37, 1024, 4096, 65537)
SERVED_ROWS, SERVED_TIER = 65536, "high"
FAN_IN, FAN_IN_SEED = 12, 12
FAN_IN_BATCHES = (37, 4096, 65537)
POOLED_ROWS = 65536  # the gradient gate beside plain over at least this many rows
# the flagship's launches of fused_mlp.cu and fused_mlp_mma.cu on phases
# 1-22's paths
FLAGSHIP_K1_LAUNCHES = {"fused_mlp": 59, "fused_mlp_mma": 2}
K3_F32_HEIGHTS = (64, 32, 16, 8)  # its tile heights, forced in phases 3 and 4
K3_MIXED_HEIGHTS = (32, 16)  # fused_gram_mixed.cu's, forced in phase 3
EXACT_HMC = dict(n_walkers=4096, n_warmup=20, n_steps=20)  # phase 5's exact-value runs
NOISE_VAR = 25.0
# Value tolerance, kernel vs plain: |Δ logL| ≤ rtol·(|logL| + c/2) + 1e-2
# nats. Both compute the same products and differ only in summation
# order. The gram form sums quad = ‖r‖² − c from terms of size ~c (c =
# b·b of the folded output layer, ~2.5·10⁴ for the observation here), so
# its rounding scales with |logL| + c/2, not with |logL|: near the mode
# |logL| ≪ c/2. At an fp32 value tier rtol is 1e-5. At the bf16 tiers an
# ulp of difference in an activation can move its bf16-rounded part (lo =
# bf16_rn(a − hi), or bf16_rn(a)) by one bf16 step, ~2⁷ ulps, on elements
# at a rounding boundary. Two summation orders of the same plain version
# (fp32 against float64 accumulation of the same tier operands, 65,537
# prior draws, flagship checkpoint, CPU) differ by up to 6.2e-7 of that
# scale at fp32, 3.2e-5 at bf16x3 and 1.2e-3 at single-pass bf16, which
# rounds every activation (K2; K1's sumsq 5.9e-7, 3.6e-5 and 9.8e-4), so
# rtol is 1e-5, 1e-4 and 5e-3. K1's sumsq value takes the same scale,
# not |logL| alone: its residual r = h@W + b is the difference of terms
# of size |b| too, so its error in ½‖r‖² is ~ε·‖r‖·‖b‖ ≤ ε·(|logL| + c/2).
VALUE_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 5e-3}
VALUE_ATOL = 1e-2
# K1's predictions, kernel vs plain, relative to their amplitude (max
# |signal|): the same two summation orders differ by up to 4.3e-7, 2.1e-5
# and 7.2e-4 of it at the three tiers, so the tolerance is 1e-5 at fp32
# (the golden forward's bound) and 1e-4 at bf16x3. At bf16 one rounding
# flip in an early layer moves a whole row, so the extreme over many rows
# is heavy-tailed: kernel vs plain reached 2.3e-3 at 65,537 rows on an
# H100. The tolerance there is 5e-3, below the bf16 tier's own error
# against the fp32 tier on this checkpoint (6.6e-3).
AMPLITUDE_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 5e-3}
TIMING_ROWS = ((8192, 20), (1_048_576, 3))  # (rows, repeats)
MH_WALKERS, MH_WARMUP, MH_STEPS = 8192, 200, 500  # bench_mcmc's MH batch, JAX defaults
ENS_WALKERS, ENS_WARMUP, ENS_STEPS = 8192, 100, 500  # sample_ensemble's JAX defaults
DRAWS = MH_WALKERS * (MH_STEPS // 10)  # 409,600: each chain's kept draws (thin 10)
F32_HEIGHTS = (64, 32)  # the register-tiled fp32 kernels' tile heights timed in phase 7
GRAD_Q999_F32 = 1e-4  # q99.9 of per-row gradient error at (highest, highest)
# Published dense peaks of one H100 SXM at its 700 W limit: bf16 on the
# tensor cores, fp32 on the CUDA cores, HBM3 bytes per second.
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# The marginalized path (phases 9-11): a 5-term linlog foreground
# (tests/test_foregrounds.py's coefficients), an InvGamma(3, 2) prior on
# the noise level and a Planck-style Gaussian prior on tau.
FG_TERMS, FG_COEFFS = 5, (1500.0, -120.0, 40.0, -8.0, 2.0)
FG_PRIOR_VAR = 1e6  # the proper coefficient prior of phase 9
LEVEL_ALPHA, LEVEL_BETA = 3.0, 2.0
TAU_INDEX, TAU_SIGMA = 3, 0.006
HMC_SIZES = dict(n_walkers=4096, n_warmup=100, n_steps=200)  # phase 5's run
SAMPLER_SIZES = {
    "hmc": HMC_SIZES,
    "mh": dict(n_walkers=MH_WALKERS, n_warmup=MH_WARMUP, n_steps=MH_STEPS),
    "ensemble": dict(n_walkers=ENS_WALKERS, n_warmup=ENS_WARMUP, n_steps=ENS_STEPS),
}
ACCEPT_RANGE = {"hmc": (0.3, 0.99), "mh": (0.15, 0.5), "ensemble": (0.05, 0.95)}
BAND_SHARE = 0.8  # bins of the truth inside the 95 % predictive band (the CPU test's share)
# Phases 12-14: the adaptive samplers, the fits and the batched posteriors.
CHEES_SIZES = dict(n_walkers=4096, n_warmup=200, n_steps=100)
CHEES_MAX_LEAPFROG = 128  # sample_chees's default cap
NUTS_SIZES = dict(n_walkers=4096, n_warmup=100, n_steps=100)
NUTS_MAX_DEPTH = 6
# Phase 12's importance-sampling witness: uniform draws over the box,
# then Student-t rounds fitted to the last stage's weighted draws.
WITNESS_BOX_ROWS, WITNESS_ROWS, WITNESS_ROUNDS, WITNESS_DF = 2**24, 2**22, 3, 5
WITNESS_CHUNK, WITNESS_MIN_ESS = 2**20, 1000
WITNESS_FX_SPLIT = 2e-3  # between the two fx modes of the flagship observation
FIT_STARTS, FIT_STEPS = 1024, 300
PROFILE_POINTS, PROFILE_STARTS, PROFILE_HALF_WIDTH = 16, 256, 0.012  # tau ± 0.012
ESS_WALKERS, ESS_CHUNK, ESS_WARMUP = 1024, 200, 200
ESS_TARGET, ESS_MAX_CHUNKS = 200.0, 6  # reached inside max_chunks: the convergence exit
ESS_UNREACHED, ESS_CAPPED_CHUNKS = 1e6, 2  # never reached: the max_chunks exit
BATCH_OBS, BATCH_WALKERS = 8, 512
BATCH_SIZES = {
    "mh": dict(n_warmup=300, n_steps=300, thin=10),
    "hmc": dict(n_warmup=60, n_steps=60, thin=5),
    "nuts": dict(n_warmup=50, n_steps=30, thin=5, max_depth=5, adapt_blocks=BATCH_OBS),
}
SBC_SIMS, SBC_WALKERS = 16, 256
# Phases 15-16 run the evidence estimators at the JAX package's defaults;
# the launch counts they are held to follow from these.
NESTED_LIVE, NESTED_BATCH, NESTED_MH = 1024, 128, 24
SMC_PARTICLES, SMC_MH = 4096, 8
LAPLACE_STEPS, LAPLACE_ROUNDS, LAPLACE_IS = 2000, 3, 16384
LADDER_RUNGS, LADDER_WALKERS, LADDER_STEPS, LADDER_WARMUP = 32, 256, 400, 200
LADDER_FIT_STEPS = 500  # the warm start's fit: max(1024, n_walkers) starts
EVIDENCE_GATE_NATS, EVIDENCE_GATE_SIGMAS = 1.0, 4.0
PT_SIZES = dict(n_rungs=16, n_walkers=256, n_steps=400, n_warmup=200, thin=10)
# Phase 17: the variational fits at the JAX package's defaults, and the
# batched evidence on four of phase 14's observations at a cut ascent.
ADVI_STEPS, ADVI_MC = 600, 512
FLOW_WARM, FLOW_STEPS, FLOW_MC, FLOW_IS = 400, 1500, 256, 16384
# K3 is held to plain on this many draws of each fitted distribution, in
# calls of the path's batch: over one call of 256 rows the gradient gate's
# q99.9 is 0.745 of the largest row's error, so a single kink row (a ReLU
# pre-activation within rounding of 0, whose gradient is set-valued) would
# decide it, against the gate's definition (metrics.py::grad_gate_violation)
HELD_DRAWS = 4096
EVIDENCE_BATCH_OBS = 4
EVIDENCE_BATCH_CUTS = dict(n_starts=1024, n_steps=500)  # the JAX defaults: 4096 × 2000
# Phase 18: training the flagship at the reference's data scale (bench.py's
# golden split: 26,888 training rows, 106 batches of 256 per epoch).
TRAIN_SPLIT = dict(n_train=26888, n_val=1704, n_test=1704, seed=0)
TRAIN_EPOCHS = 16  # the recipe, the device loop and the resumed run (≈ 0.75 s each on the card's host)
PARITY_EPOCHS = 2  # the card against the CPU
FINETUNE_EPOCHS = 3  # the tier-native fine-tune
# Card against CPU, from the same weights and shuffles. Each of the first
# 20 steps' losses: the bound the CPU parity tests hold the port's
# training to against JAX's (tests/test_torch_train.py). Past step ≈ 25,
# Adam at lr 0.01 amplifies rounding differences into separate
# trajectories: the CPU run with one weight moved by one ulp separates
# as far (0.13 relative at epoch 2's losses, against the card's 0.27, on
# an H100 80GB HBM3 at 700 W), and is rerun here beside it; the
# per-epoch losses are held to 0.5.
PARITY_TIGHT_STEPS, TRAIN_LOSS_RTOL, PARITY_EPOCH_RTOL = 20, 2e-6, 0.5
TEST_ERROR_GATE = 3.0  # mean relative test error, %: the verify skill's gate
TRAINED_BATCHES = {"k1": (1, 37, 8192, 65537), "k2": (1, 37, 8192, 65537),  # phase 6's
                   "k3": (1, 37, 4096, 65537)}  # phase 3's; held_batches adds 1024
# Phase 19: the other families from their shipped checkpoints, on phase 18's
# golden split; the golden errors are tests/test_pretrained.py's bounds.
FAMILY_PATHS = {"ae": os.path.join(ROOT, "pretrained", "ae_synthetic.npz"),
                "vae": os.path.join(ROOT, "pretrained", "vae_synthetic.npz"),
                "ensemble": os.path.join(ROOT, "pretrained", "ensemble_direct")}
MIXTURE_ROWS = (4096, 8192)
# the ensemble's member-batched routes: its mixture's builder keywords,
# the kernel source that runs it, and its (value, backward) tiers
ENS_ROUTES = {
    "k1": (dict(method="direct", precision="contract"), K1_SOURCE, ("highest", None)),
    "k1_mma": (dict(method="direct", precision="high"), K1_MMA_SOURCE, ("high", None)),
    "k2": (dict(), GRAM_MMA_SOURCE, ("high", None)),
    "k2_f32": (dict(precision="contract"), K2_SOURCE, ("highest", None)),
    "k3": (dict(grad_precision=MAIN_TIERS[1]), GRAM_MMA_SOURCE, MAIN_TIERS),
    "k3_f32": (dict(precision="contract"), K3_F32_SOURCE, EXACT_TIERS),
    "k3_mixed": (dict(precision=MIXED_TIERS[0], grad_precision=MIXED_TIERS[1]),
                 K3_MIXED_SOURCE, MIXED_TIERS),
    "k3_reverse": (dict(precision=REVERSE_TIERS[0], grad_precision=REVERSE_TIERS[1]),
                   GRAM_MMA_SOURCE, REVERSE_TIERS),
    "k3_wide": (dict(precision=REVERSE_TIERS[0], grad_precision=REVERSE_TIERS[1]),
                K3_SOURCE, REVERSE_TIERS),
}
# the routes run on an ensemble of networks too wide for the reverse mode
# (:func:`wide_ensemble`), not on the shipped one
WIDE_ENS_KEYS = ("k3_wide",)
MEMBER_ROWS = (37, 256, 4096)  # member-batched against three single launches, bit for bit
MEMBER_TIMING_ROWS = (256, 4096)
BOUND_TIER = {"highest": "f32", "high": "bf16x3", "default": "bf16"}
# MH at phase 8's sizes: at 100 + 200 steps the ensemble's best draw stayed
# 6.5 nats below the truth (an H100 80GB HBM3 at 700 W), short of phase 8's
# gate; random-walk MH needs phase 8's length to reach the mode
MH_SIZES = dict(n_walkers=MH_WALKERS, n_warmup=MH_WARMUP, n_steps=MH_STEPS)
ENS_SAMPLERS = {"hmc": dict(n_walkers=4096, n_warmup=100, n_steps=100), "mh": MH_SIZES}
FAMILY_SAMPLERS = {"hmc": dict(n_walkers=1024, n_warmup=100, n_steps=100), "mh": MH_SIZES}
FAMILY_EPOCHS = 3  # of each training stage


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def read_leaves(path: str):
    """A checkpoint's leaves in float64 and its metadata, read with NumPy."""
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        leaves = [data[f"leaf_{i}"].astype(np.float64) for i in range(header["n_leaves"])]
    return leaves, header["metadata"]


def numpy_mlp(layers, h):
    """A ReLU MLP of ``(w, b)`` layers with a linear head, in NumPy."""
    for i, (w, b) in enumerate(layers):
        h = h @ w + b
        if i < len(layers) - 1:
            h = np.maximum(h, 0.0)
    return h


def numpy_inputs(raw, pmin, pmax):
    """The network's inputs of raw parameter rows: log10 of columns 0-2
    (fx == 0 clamped to 1e-6), then the affine map onto [-1, 1]."""
    x = np.asarray(raw, np.float64).copy()
    x[:, 2] = np.where(x[:, 2] == 0.0, 1e-6, x[:, 2])
    x[:, :3] = np.log10(x[:, :3])
    return 2.0 * (x - pmin) / (pmax - pmin) - 1.0


def numpy_forward(path: str, raw: np.ndarray) -> np.ndarray:
    """The checkpoint's signals in float64 NumPy: its own reading of the
    file (leaf order: Normalizer fields, then each layer's b, w)."""
    leaves, _ = read_leaves(path)
    mean, std, pmin, pmax = leaves[:4]
    layers = [(leaves[i + 1], leaves[i]) for i in range(4, len(leaves), 2)]
    return numpy_mlp(layers, numpy_inputs(raw, pmin, pmax)) * std + mean


def numpy_family_forward(path: str, raw: np.ndarray) -> np.ndarray:
    """A two-stage family's signals in float64 NumPy (params → latent MLP,
    then the decoder): its own reading of the file, whose leaves follow
    the sorted keys of the checkpoint's tree — the autoencoder's ``dec``,
    ``em``, ``enc``, ``normalizer``; the VAE's ``em``, ``normalizer``,
    ``vae`` (its ``dec`` first) — each layer's b before its w."""
    leaves, meta = read_leaves(path)
    it = iter(leaves)

    def take(hidden):
        layers = []
        for _ in range(len(hidden) + 1):
            b = next(it)
            layers.append((next(it), b))
        return layers

    if meta["kind"] == "AutoEncoderEmulator":
        dec, em = take(meta["dec_hidden_dims"]), take(meta["em_hidden_dims"])
        take(meta["enc_hidden_dims"])
        mean, std, pmin, pmax = (next(it) for _ in range(4))
    else:
        em = take(meta["em_hidden_dims"])
        mean, std, pmin, pmax = (next(it) for _ in range(4))
        dec = take(meta["dec_hidden_dims"])
    z = numpy_mlp(em, numpy_inputs(raw, pmin, pmax))
    return numpy_mlp(dec, z) * std + mean


def rows(n: int, rng) -> torch.Tensor:
    """n prior draws with an fx == 0 row first (the log-clamp path)."""
    x = synthetic_params(n, rng).astype(np.float32)
    x[0, 2] = 0.0
    return torch.as_tensor(x, device="cuda")


def held_batches(sizes, rng):
    """``(n, rows(n))`` for each of ``sizes`` in turn, and before the
    first size above ``FIT_STARTS`` its head of ``FIT_STARTS`` rows (the
    batch of the fits and of target-ESS MH). Taking that batch as a head,
    not as a draw of its own, leaves the generator's later draws, and so
    the observation of phases 5-14, as they were."""
    head = True
    for n in sizes:
        x = rows(n, rng)
        if head and n > FIT_STARTS:
            head = False
            yield FIT_STARTS, x[:FIT_STARTS]
        yield n, x


def timed(fn):
    """``(fn(), wall seconds)``, the device synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def scores(loglik, model, x, dev) -> np.ndarray:
    """``loglik(params, x)`` of the rows ``x`` (one row or many) as float32
    NumPy, without a graph."""
    with torch.no_grad():
        return loglik(model.params, torch.as_tensor(np.atleast_2d(x), dtype=torch.float32,
                                                    device=dev)).cpu().numpy()


def time_ms(fn, repeats: int, warmup: int = 3) -> float:
    """Median device time of one call (CUDA events), warmup excluded."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def stream_ms(fn, calls: int, rounds: int = 3) -> float:
    """Device time of one call: ``calls`` back-to-back calls between one
    pair of CUDA events, over ``calls``, the median of ``rounds``, after
    a warmup. Unlike :func:`time_ms` it leaves out the host's time before
    each launch once the host keeps ahead of the device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def kernel_name(mangled: str) -> str:
    """``name<template args>`` of a mangled kernel in an anonymous
    namespace (``_ZN<len><namespace><len><name>I…E``), else ``mangled``."""
    found = re.match(r"_ZN(\d+)", mangled)
    if not found:
        return mangled
    rest = mangled[found.end() + int(found.group(1)):]
    found = re.match(r"(\d+)", rest)
    if not found:
        return mangled
    end = found.end() + int(found.group(1))
    args = re.match(r"I((?:L[a-z]-?\d+E)+)E", rest[end:])
    values = re.findall(r"L[a-z](-?\d+)E", args.group(1)) if args else []
    return rest[found.end():end] + (f"<{','.join(values)}>" if values else "")


def ptxas_report(log: str) -> dict:
    """Registers and spill-store bytes of every kernel in a ``ptxas -v``
    log, by :func:`kernel_name`."""
    report, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
            report[name] = {}
        elif name and "spill stores" in line:
            report[name]["spill_store_bytes"] = int(line.split("bytes spill stores")[0]
                                                    .split(",")[-1])
        elif name and "registers" in line:
            report[name]["registers"] = int(line.split("Used ")[1].split(" ")[0])
    return report


def bound(kernel, widths, n, tier, grad_tier=None):
    """The least time (ms) an H100 could take for one call on ``n`` rows
    and what bounds it: the larger of the bytes the call must move (the
    rows in, the results out, the weights as the kernel reads them, each
    once) over the HBM rate, and its products over the peak rate of
    their type (bf16x3: three bf16 products each; the skinny layer and
    the fp32 tier on the CUDA cores; a first layer of fan-in above 8 is a
    tier product like the others, and K3's backward runs it too).
    ``widths``: K1's layer sizes, or K2's and K3's trunk (n_in, hidden…)
    with the gram head H×H."""
    first = widths[0] * widths[1]
    dense = [a * b for a, b in zip(widths[1:-1], widths[2:])]
    skinny = first if widths[0] <= 8 else 0
    if not skinny:
        dense.append(first)
    products = {"k1": [(sum(dense), tier)],
                "k2": [(sum(dense) + widths[-1] ** 2, tier)],
                "k3": [(sum(dense) + widths[-1] ** 2, tier), (sum(dense), grad_tier)]}[kernel]
    bf16 = sum(2 * p * {"bf16x3": 3, "bf16": 1, "f32": 0}[t] for p, t in products)
    f32 = sum(2 * p for p, t in products if t == "f32")
    f32 += 2 * skinny * (2 if kernel == "k3" else 1)
    weights = sum(p * {"bf16x3": 4, "bf16": 2, "f32": 4}[t] for p, t in products)
    weights += 4 * (skinny + sum(widths[1:]))
    out = {"k1": 4, "k2": 4, "k3": 4 + 4 * widths[0]}[kernel]
    t_bytes = (weights + n * (4 * widths[0] + out)) / PEAK_BYTES
    t_ops = n * (bf16 / PEAK_BF16 + f32 / PEAK_F32)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def kernel_entry(name, source, replaces, launches, marginalized, err, t, bound_ms,
                 **extra) -> dict:
    """One entry of the kernels line; no single PyTorch call computes a
    whole folded network with its gram head or backward, so library_ms
    is null. ``launches``: the main paths' launches under diagonal noise
    (phases 5, 8, 12 and 13); ``marginalized``: those of the marginalized path
    (phase 10), counted in the total and shown beside it. ``extra``:
    further keys (another batch's figures)."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches + marginalized, "launches_marginalized": marginalized,
            "max_abs_err": err, "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bound_ms[0], "bound_by": bound_ms[1],
            "library_ms": None, **extra}


def trunk_flops(widths) -> int:
    """fp32 FLOPs per row of a dense network of ``widths``."""
    return 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def gram_flops(trunk, backward: bool) -> int:
    """FLOPs per row of K2 (the trunk and the gram head H×H) or, with
    ``backward``, of K3 (the trunk's backward too)."""
    return trunk_flops(trunk) * (2 if backward else 1) + 2 * trunk[-1] ** 2


def value_kernels(model, obs, tier, dev, tile_rows=None):
    """K1 as predict, K1 as the direct likelihood and K2, each as
    ``(kernel call, plain call)`` on rows ``x``, at ``tier``;
    ``tile_rows`` forces the fp32 kernels' tile height."""
    emulate = make_fused_emulate(model.config, model.normalizer, precision=tier,
                                 tile_rows=tile_rows, device=dev)
    direct = make_fused_loglik(model.config, model.normalizer, obs, NOISE_VAR,
                               precision=tier, tile_rows=tile_rows, device=dev)
    gram = make_fused_loglik_gram(model.config, model.normalizer, obs, NOISE_VAR,
                                  precision=tier, tile_rows=tile_rows, device=dev)
    check(gram.tensor_cores == (tier != "highest"), f"K2 route at {tier}")
    ops_e, ops_d = emulate.operands(model.params), direct.mlp.operands(model.params)
    ops_g = gram.operands(model.params)
    return {
        "k1_predict": (lambda x: emulate(model.params, x),
                       lambda x: fused_mlp_reference(ops_e, x)),
        "k1_sumsq": (lambda x: direct(model.params, x),
                     lambda x: -0.5 * fused_mlp_reference(ops_d, x)),
        "k2": (lambda x: gram(model.params, x), lambda x: loglik_gram_reference(ops_g, x)),
    }, 0.5 * abs(float(ops_g.c))


def value_kernels_vs_plain(model, obs, rng, dev):
    """Phase 6: K1 (predict, sumsq) and K2 against their plain versions.
    Returns the largest |Δ logL| of K1's sumsq at the contract tier
    (``fused_mlp.cu``) and at bf16x3 (``fused_mlp_mma.cu``) and of K2 at
    the contract tier (``fused_loglik_gram.cu``) and at bf16x3
    (``fused_gram_mma.cu``), the tiers of the main path, in nats."""
    report = {}
    k1_err = k1_mma_err = k2_err = k2_mma_err = 0.0
    for tier in TIERS:
        pairs, half_c = value_kernels(model, obs, tier, dev)
        for n, x in held_batches((1, 37, 8192, 65537), rng):
            with torch.no_grad():
                out = {key: (kernel(x), plain(x)) for key, (kernel, plain) in pairs.items()}
            torch.cuda.synchronize()
            (yk, yp), (dk, dp), (gk, gp) = (
                (a.cpu().numpy(), b.cpu().numpy()) for a, b in out.values()
            )
            check(yk.shape == (n, 451) and dk.shape == (n,) and gk.shape == (n,),
                  f"K1/K2 shapes {tier} n={n}")
            check(bool(np.isfinite(yk).all() and np.isfinite(dk).all()
                       and np.isfinite(gk).all()), f"K1/K2 finite {tier} n={n}")
            amp = float(np.abs(yk - yp).max() / np.abs(yp).max())
            check(amp <= AMPLITUDE_RTOL[tier], f"K1 predict {tier} n={n}: {amp:.3g}")
            entry = {"k1_predict_rel_amp": amp}
            for key, got, want in (("k1_sumsq", dk, dp), ("k2", gk, gp)):
                tol = VALUE_RTOL[tier] * (np.abs(want) + half_c) + VALUE_ATOL
                dv = np.abs(got - want)
                check(bool((dv <= tol).all()),
                      f"{key} value {tier} n={n}: worst |Δ|/tol {float((dv / tol).max()):.3g}")
                entry[f"{key}_max_abs"] = float(dv.max())
                entry[f"{key}_worst_over_tol"] = float((dv / tol).max())
            if tier == "highest":
                k1_err = max(k1_err, entry["k1_sumsq_max_abs"])
                k2_err = max(k2_err, entry["k2_max_abs"])
            if tier == "high":
                k1_mma_err = max(k1_mma_err, entry["k1_sumsq_max_abs"])
                k2_mma_err = max(k2_mma_err, entry["k2_max_abs"])
            report[f"{tier}/{n}"] = entry
    print("phase 6: K1 and K2 == plain within tolerance at every batch and tier "
          + json.dumps(report), flush=True)
    return k1_err, k1_mma_err, k2_err, k2_mma_err


@torch.no_grad()
def time_pair(kernel, plain, x, repeats, flops) -> dict:
    """A kernel and its plain version on rows ``x``: ms per wrapper call
    (each the mean of two medians, in turns plain, kernel, kernel,
    plain), the kernel's device ms per call, and the achieved TFLOP/s of
    ``flops`` per row."""
    t = [time_ms(fn, repeats, warmup=1)
         for fn in (lambda: plain(x), lambda: kernel(x), lambda: kernel(x), lambda: plain(x))]
    kernel_ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    n = x.shape[0]
    return {"kernel_ms": kernel_ms, "kernel_stream_ms": stream_ms(lambda: kernel(x), repeats),
            "plain_ms": plain_ms, "kernel_tflops": flops * n / kernel_ms / 1e9,
            "plain_tflops": flops * n / plain_ms / 1e9}


def time_value_kernels(model, obs, rng, dev) -> dict:
    """Phase 7: ms per call of K1 (predict and sumsq) and K2 and their
    plain versions, with the achieved TFLOP/s of each at fp32-equivalent
    FLOPs (a bf16x3 product counts once); K1 sumsq and K2 at the exact
    tier also at the main path's batch; then the fp32 kernels' two tile
    heights."""
    sizes = model.config.mlp().sizes
    flops = {"k1_predict": trunk_flops(sizes), "k1_sumsq": trunk_flops(sizes),
             "k2": trunk_flops(sizes[:-1]) + 2 * sizes[-2] ** 2}
    timings = {}
    for tier in TIERS:
        pairs, _ = value_kernels(model, obs, tier, dev)
        sizes_here = TIMING_ROWS + (((DRAWS, 3),) if tier == "highest" else ())
        for n, repeats in sizes_here:
            x = rows(n, rng)
            for key, (kernel, plain) in pairs.items():
                if n == DRAWS and key == "k1_predict":
                    continue  # the main path scores draws; it predicts none
                timings[f"{key}/{tier}/{n}"] = time_pair(kernel, plain, x, repeats, flops[key])
            del x
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"phase 7: median ms per call {json.dumps(timings)}", flush=True)

    heights = {}  # device and wrapper ms per call of each height, in turns a, b, b, a
    kernels = {h: value_kernels(model, obs, "highest", dev, tile_rows=h)[0] for h in F32_HEIGHTS}
    for n in (DRAWS, 1_048_576):
        x = rows(n, rng)
        for key in ("k1_sumsq", "k2"):
            a, b = (kernels[h][key][0] for h in F32_HEIGHTS)
            with torch.no_grad():
                t = [time_ms(lambda: fn(x), 3, warmup=1) for fn in (a, b, b, a)]
                dev_t = [stream_ms(lambda: fn(x), 3) for fn in (a, b, b, a)]
            heights[f"{key}/{n}"] = {
                str(h): {"kernel_ms": (t[i] + t[3 - i]) / 2,
                         "kernel_stream_ms": (dev_t[i] + dev_t[3 - i]) / 2}
                for i, h in enumerate(F32_HEIGHTS)}
        del x
        torch.cuda.empty_cache()
    print(f"phase 7: fp32 tile heights {json.dumps(heights)}", flush=True)
    return timings


def gradient_free_main_path(model, truth, obs, dev):
    """Phase 8: MH and the stretch ensemble through ``sample_posterior``
    (K2 on every proposal batch), then each chain's draws scored through
    the direct likelihood (K1) at the exact tier (``fused_mlp.cu``) and
    at bf16x3 (``fused_mlp_mma.cu``), the bf16x3 scores under the
    likelihood gate against the exact ones. Returns the launch counts of
    these runs: K1 exact, K1 bf16x3, K2 exact, K2 bf16x3, and K2 bf16x3's
    by sampler."""
    k2 = model.loglik_fn(obs, NOISE_VAR, backend="kernel")
    k1 = model.loglik_fn(obs, NOISE_VAR, method="direct", precision="contract",
                         backend="kernel")
    k1_mma = model.loglik_fn(obs, NOISE_VAR, method="direct", precision="high",
                             backend="kernel")
    k2_exact = model.loglik_fn(obs, NOISE_VAR, precision="contract", backend="kernel")
    check(k2.fused.tensor_cores and not k2_exact.fused.tensor_cores, "K2 routes")
    half_c = 0.5 * abs(float(k2_exact.fused.operands(model.params).c))
    out = {}
    k1_launches = k1_mma_launches = k2_launches = k2_exact_launches = 0
    for sampler, kw in (
        ("mh", dict(n_walkers=MH_WALKERS, n_warmup=MH_WARMUP, n_steps=MH_STEPS)),
        ("ensemble", dict(n_walkers=ENS_WALKERS, n_warmup=ENS_WARMUP, n_steps=ENS_STEPS)),
    ):
        k2.launches = 0
        res, wall = timed(lambda: model.sample_posterior(obs, NOISE_VAR, sampler=sampler, **kw))
        launches = k2.launches
        check(model.loglik_fn(obs, NOISE_VAR, backend="kernel") is k2,
              f"{sampler}: sample_posterior used the memoized K2 wrapper")
        per_step = 1 if sampler == "mh" else 2
        need = 1 + per_step * (kw["n_warmup"] + kw["n_steps"])
        check(launches >= need, f"{sampler}: K2 launches {launches} < {need}")
        n_keep = kw["n_steps"] // 10
        check(res.chain.shape == (n_keep, kw["n_walkers"], 7),
              f"{sampler}: chain shape {res.chain.shape}")
        check(bool(np.isfinite(res.chain).all() and np.isfinite(res.logp).all()),
              f"{sampler}: finite chains")
        acc = float(np.mean(res.accept_rate))
        if sampler == "mh":
            check(0.15 <= acc <= 0.5, f"mh: mean post-warmup acceptance {acc:.3f}")
        else:
            check(0.05 <= acc <= 0.95, f"ensemble: mean acceptance {acc:.3f}")
        flat = res.flat
        k1.launches = k1_mma.launches = k2_exact.launches = 0
        ll_draws = scores(k1, model, flat, dev)
        ll_truth = float(scores(k1, model, truth, dev)[0])
        ll_high = scores(k1_mma, model, flat, dev)
        ll_gram = scores(k2_exact, model, flat, dev)
        k1_launches += k1.launches
        k1_mma_launches += k1_mma.launches
        k2_launches += launches
        k2_exact_launches += k2_exact.launches
        check(k1.launches == 2, f"{sampler}: K1 launches {k1.launches} != 2")
        check(k1_mma.launches == 1, f"{sampler}: K1 bf16x3 launches {k1_mma.launches} != 1")
        check(k2_exact.launches == 1, f"{sampler}: K2 exact launches {k2_exact.launches} != 1")
        # the gram form (K2) against the direct form (K1), both at the exact
        # tier, on the same draws: the fold's cancellation scale, as phase 6
        gram_tol = VALUE_RTOL["highest"] * (np.abs(ll_draws) + half_c) + VALUE_ATOL
        gram_worst = float((np.abs(ll_gram - ll_draws) / gram_tol).max())
        check(gram_worst <= 1.0, f"{sampler}: exact gram vs direct, worst |Δ|/tol {gram_worst:.3g}")
        check(bool(np.isfinite(ll_draws).all() and np.isfinite(ll_high).all()),
              f"{sampler}: finite draw likelihoods")
        # bf16x3 against the exact tier on the same draws: bench_mcmc.py's
        # gate, |ΔlogL| ≤ 0.25 + 1.5e-3·(max logL − logL)
        gate = loglik_gate_violation(ll_high, ll_draws)
        check(gate <= 0.0, f"{sampler}: bf16x3 likelihood gate {gate:.3g}")
        # The samplers reach the mode: the best draw is at least as likely
        # as the truth, less 5 nats. The typical-truth check of phase 5
        # (the truth inside every marginal's central 99.9 %, its likelihood
        # rank in [0.001, 0.999]) is printed, not gated: at these settings
        # it fails the same way in the JAX package's samplers, whose MH
        # leaves over half of the walkers far from the mode after 700
        # steps and whose ensemble puts the truth outside the fx marginal
        # (PERF.md).
        check(float(ll_draws.max()) >= ll_truth - 5.0,
              f"{sampler}: best draw {float(ll_draws.max()):.2f} < logL(truth) "
              f"{ll_truth:.2f} − 5")
        mean, sd = flat.mean(0), flat.std(0)
        out[sampler] = {
            "wall_s": wall, "k2_launches": launches, "k1_launches": k1.launches,
            "k1_bf16x3_launches": k1_mma.launches, "bf16x3_gate_violation": gate,
            "k2_exact_launches": k2_exact.launches, "exact_gram_vs_direct_worst_over_tol":
            gram_worst,
            "bf16x3_max_abs_dlogl": float(np.abs(ll_high - ll_draws).max()),
            "accept": acc, "step_size": res.step_size,
            "rhat_max": float(res.rhat().max()),
            "z": (np.abs(mean - truth) / sd).tolist(),
            "truth_rank": np.mean(flat < truth, axis=0).tolist(),
            "truth_inside_central_999": inside_central_999(flat, truth),
            "loglik_truth": ll_truth, "loglik_draws_max": float(ll_draws.max()),
            "share_at_least_truth": float(np.mean(ll_draws >= ll_truth)),
            "share_far_below_minus_1000": float(np.mean(ll_draws < -1000.0)),
        }
    print("phase 8: " + json.dumps(out), flush=True)
    per_sampler = {name: entry["k2_launches"] for name, entry in out.items()}
    return k1_launches, k1_mma_launches, k2_exact_launches, k2_launches, per_sampler


def k3_wrapper(model, obs, tiers, dev, tile_rows=None, noise_var=NOISE_VAR):
    return make_fused_loglik_grad_gram(model.config, model.normalizer, obs, noise_var,
                                       precision=tiers[0], grad_precision=tiers[1],
                                       tile_rows=tile_rows, device=dev)


def k3_vs_plain(model, obs, rng, added, dev):
    """Phase 3: K3 against its plain version at every tier pair; the
    fp32 pair at every tile height and the mixed pairs (an fp32 value, a
    bf16 backward) at both of theirs, forced, and each at the wrapper's
    own choice, the value equal to the fp32 K2's at the same height bit
    for bit; the reverse pairs (a bf16 value, an fp32 backward), the
    value equal to the tensor-core K2's at the value tier bit for bit.
    Rows come from ``rng`` for ``FIRST_PAIRS`` and the fp32 heights, else
    from ``added``. Returns the wrappers by tier pair (the fp32 and mixed
    pairs' pick their height) and the largest |Δ logL| by tier pair at
    4096 rows (pairs with an fp32 tier: over every batch)."""
    wrappers = {tiers: k3_wrapper(model, obs, tiers, dev) for tiers in TIER_PAIRS}
    cases = [(f"{a}/{b}", (a, b), fn, rng if (a, b) in FIRST_PAIRS else added)
             for (a, b), fn in wrappers.items()]
    cases += [(f"highest/highest@{h}", EXACT_TIERS,
               k3_wrapper(model, obs, EXACT_TIERS, dev, h), rng) for h in K3_F32_HEIGHTS]
    cases += [(f"{a}/{b}@{h}", (a, b), k3_wrapper(model, obs, (a, b), dev, h), added)
              for a, b in MIXED_PAIRS for h in K3_MIXED_HEIGHTS]
    k2 = {h: make_fused_loglik_gram(model.config, model.normalizer, obs, NOISE_VAR,
                                    precision="highest", tile_rows=h, device=dev)
          for h in K3_F32_HEIGHTS}
    k2_mma = {t: make_fused_loglik_gram(model.config, model.normalizer, obs, NOISE_VAR,
                                        precision=t, device=dev) for t in MAIN_TIERS}
    report = {}
    err = {tiers: 0.0 for tiers in TIER_PAIRS}
    for label, tiers, fn, draws in cases:
        ops = fn.operands(model.params)
        check(fn.tensor_cores == ("highest" not in tiers), f"K3 route at {tiers}")
        check(fn.register_tiled == (tiers == EXACT_TIERS), f"K3 fp32 route at {tiers}")
        check(fn.mixed == (tiers in MIXED_PAIRS), f"K3 mixed route at {tiers}")
        check(fn.reverse == (tiers in REVERSE_PAIRS), f"K3 reverse route at {tiers}")
        for n, x in held_batches((1, 37, 4096, 65537), draws):
            fn.launches = 0
            vk, gk = fn(model.params, x)
            check(fn.launches == 1, f"K3 {label} n={n}: {fn.launches} launches")
            vp, gp = loglik_grad_gram_reference(ops, x)
            if fn.register_tiled or fn.mixed:
                same = torch.equal(vk, k2[fn.rows_for(n)](model.params, x))
                check(same, f"K3 value != K2 fp32 value bit for bit, {label} n={n}")
            if fn.reverse:
                same = torch.equal(vk, k2_mma[tiers[0]](model.params, x))
                check(same, f"K3 value != tensor-core K2 value bit for bit, {label} n={n}")
            torch.cuda.synchronize()
            vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
            check(vk.shape == (n,) and gk.shape == (n, 7), f"shapes {label} n={n}")
            check(bool(np.isfinite(vk).all() and np.isfinite(gk).all()),
                  f"finite {label} n={n}")
            tol = VALUE_RTOL[tiers[0]] * (np.abs(vp) + 0.5 * abs(float(ops.c))) + VALUE_ATOL
            dv = np.abs(vk - vp)
            check(bool((dv <= tol).all()),
                  f"value {label} n={n}: worst |Δ|/tol {float((dv / tol).max()):.3g}")
            check(gk[0, 2] == 0.0, f"fx == 0 gradient slot {label} n={n}: {gk[0, 2]}")
            rel = grad_rel_error(gk, gp)
            q999 = float(np.quantile(rel, 0.999))
            gate = grad_gate_violation(gk, gp)
            check(gate <= 0.0, f"gradient gate {label} n={n}: {gate:.3g}")
            if tiers == EXACT_TIERS:
                check(q999 <= GRAD_Q999_F32, f"gradient q99.9 {label} n={n}: {q999:.3g}")
            if "highest" in tiers or n == 4096:
                err[tiers] = max(err[tiers], float(dv.max()))
            report[f"{label}/{n}"] = {
                "value_max_abs": float(dv.max()),
                "value_worst_over_tol": float((dv / tol).max()),
                "grad_q999_rel": q999,
                "grad_max_rel": float(rel.max()),
            }
            if fn.register_tiled or fn.mixed:
                report[f"{label}/{n}"]["tile_rows"] = fn.rows_for(n)
    torch.cuda.synchronize()
    print(f"phase 3: kernel == plain within tolerance at every batch, tier pair and tile "
          f"height; the fp32 and mixed K3's values == fp32 K2 value, the reverse pairs' == "
          f"tensor-core K2 value bit for bit {json.dumps(report)}", flush=True)
    return wrappers, err


def mixed_in_turns(model, wrappers, timings, rng) -> dict:
    """Phase 4: ``fused_gram_mixed.cu`` at both mixed pairs in turns with
    the fp32 K3, at 4096 and 65,536 rows (:func:`in_turns`)."""
    trunk = model.config.mlp().sizes[:-1]
    runs = {"highest/highest": lambda x: wrappers[EXACT_TIERS](model.params, x)}
    for tiers in MIXED_PAIRS:
        runs[f"{tiers[0]}/{tiers[1]}"] = lambda x, fn=wrappers[tiers]: fn(model.params, x)
    return in_turns(runs, timings, trunk, rng, "mixed K3")


def in_turns(runs, timings, trunk, rng, label) -> dict:
    """``runs`` (key → call on rows; each key ``<value tier>/<backward
    tier>[/…]``) in turns, forward order then reversed, at 4096 and 65,536
    rows: ms per call and device ms per call, each the mean of its two
    turns, with the pair's plain ms (from ``timings``) and bound."""
    order = list(runs) + list(runs)[::-1]
    out = {}
    for n, repeats in ((4096, 50), (65536, 20)):
        x = rows(n, rng)
        t, d = {k: [] for k in runs}, {k: [] for k in runs}
        for k in order:
            t[k].append(time_ms(lambda: runs[k](x), repeats))
            d[k].append(stream_ms(lambda: runs[k](x), repeats))
        out[str(n)] = {k: {"kernel_ms": sum(t[k]) / 2, "kernel_stream_ms": sum(d[k]) / 2}
                       for k in runs}
        for k, entry in out[str(n)].items():
            a, b = k.split("/")[:2]
            entry["plain_ms"] = timings[f"{a}/{b}/{n}"]["plain_ms"]
            entry["bound_ms"] = bound("k3", trunk, n, BOUND_TIER[a], BOUND_TIER[b])[0]
    torch.cuda.synchronize()
    print(f"phase 4: {label} in turns {json.dumps(out)}", flush=True)
    return out


def reverse_in_turns(model, wrappers, timings, rng) -> dict:
    """Phase 4: ``fused_gram_mma.cu``'s reverse mode at both reverse pairs
    in turns with the tensor-core K3 at (high, high), at 4096 and 65,536
    rows (:func:`in_turns`)."""
    trunk = model.config.mlp().sizes[:-1]
    runs = {"high/high": lambda x: wrappers[("high", "high")](model.params, x)}
    for tiers in REVERSE_PAIRS:
        runs[f"{tiers[0]}/{tiers[1]}"] = lambda x, fn=wrappers[tiers]: fn(model.params, x)
    return in_turns(runs, timings, trunk, rng, "reverse K3")


def wide_network_k3(model, rng, dev) -> dict:
    """Phase 4: ``fused_loglik_grad_gram.cu``, K3's wide route, on a
    network of hidden ``WIDE_HIDDEN`` (too wide for the register-tiled
    fp32 K3 and for the reverse mode), randomly initialised from
    ``WIDE_SEED`` with the flagship's normalizer, at each of
    ``WIDE_PAIRS``: the wrapper routes it there, and it is held to the
    plain version at 37, 4096 and 65,537 rows (the value tier's
    tolerance, the gradient gate, the fx == 0 slot 0), then timed with
    plain at 4096 and 65,536 rows (``kernel_ms``, ``kernel_stream_ms``
    and the tile height the wrapper picks), with its bound. Returns the
    report by pair."""
    config = DirectEmulatorConfig(hidden_dims=WIDE_HIDDEN)
    wide = DirectEmulator(config=config, normalizer=model.normalizer, seed=WIDE_SEED, device=dev)
    obs = wide.predict(synthetic_params(1, rng)[0]) + rng.normal(0.0, 5.0, config.n_bins)
    trunk = config.mlp().sizes[:-1]
    out = {"hidden": list(WIDE_HIDDEN)}
    for tiers in WIDE_PAIRS:
        label = f"{tiers[0]}/{tiers[1]}"
        fn = k3_wrapper(wide, obs, tiers, dev)
        check(fn.wide and not (fn.register_tiled or fn.tensor_cores or fn.mixed or fn.reverse),
              f"K3 {label} on hidden {WIDE_HIDDEN} routes to fused_loglik_grad_gram.cu")
        ops = fn.operands(wide.params)
        check(ops.program is not None, f"the wide route's operands at {label} carry its program")
        rep = {"max_abs": 0.0, "worst_over_tol": 0.0, "heights": list(fn.heights)}
        for n, x in held_batches((37, 4096, 65537), rng):
            fn.launches = 0
            vk, gk = fn(wide.params, x)
            check(fn.launches == 1, f"wide K3 {label} n={n}: {fn.launches} launches")
            vp, gp = loglik_grad_gram_reference(ops, x)
            vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
            check(bool(np.isfinite(vk).all() and np.isfinite(gk).all()),
                  f"wide K3 {label} finite n={n}")
            tol = VALUE_RTOL[tiers[0]] * (np.abs(vp) + 0.5 * abs(float(ops.c))) + VALUE_ATOL
            dv = np.abs(vk - vp)
            check(bool((dv <= tol).all()),
                  f"wide K3 {label} value n={n}: {float((dv / tol).max()):.3g}")
            gate = grad_gate_violation(gk, gp)
            check(gate <= 0.0, f"wide K3 {label} gradient gate n={n}: {gate:.3g}")
            check(gk[0, 2] == 0.0, f"wide K3 {label} fx == 0 gradient slot n={n}: {gk[0, 2]}")
            rep["max_abs"] = max(rep["max_abs"], float(dv.max()))
            rep["worst_over_tol"] = max(rep["worst_over_tol"], float((dv / tol).max()))
        for n, repeats in ((4096, 50), (65536, 20)):
            x = rows(n, rng)
            b = bound("k3", trunk, n, BOUND_TIER[tiers[0]], "f32")
            rep[str(n)] = {
                "kernel_ms": time_ms(lambda: fn(wide.params, x), repeats),
                "kernel_stream_ms": stream_ms(lambda: fn(wide.params, x), repeats),
                "plain_ms": time_ms(lambda: loglik_grad_gram_reference(ops, x), repeats),
                "bound_ms": b[0], "bound_by": b[1], "tile_rows": fn.rows_for(n),
            }
        out[label] = rep
    torch.cuda.synchronize()
    print(f"phase 4: fused_loglik_grad_gram.cu on hidden {WIDE_HIDDEN} {json.dumps(out)}",
          flush=True)
    return out


def time_k3(model, obs, wrappers, rng, added, dev) -> dict:
    """Phase 4: ms per call of K3 and its plain version by tier pair at
    4096 and 65,536 rows, then the fp32 K3's tile heights, forced, in
    turns (64, 32, 16, 8, 8, 16, 32, 64): ms per wrapper call and device
    ms per call, each the mean of its two turns; then the mixed kernel in
    turns (:func:`mixed_in_turns`, under ``"mixed_turns"``), the reverse
    mode in turns (:func:`reverse_in_turns`, under ``"reverse_turns"``)
    and the wide route ``fused_loglik_grad_gram.cu`` on a too-wide network
    at each of its pairs (:func:`wide_network_k3`, under ``"wide"``). Rows as in phase 3: from ``rng`` for
    ``FIRST_PAIRS`` and the heights, else from ``added``."""
    timings = {}
    for tiers, fn in wrappers.items():
        ops = fn.operands(model.params)
        for n, repeats in ((4096, 50), (65536, 20)):
            x = rows(n, rng if tiers in FIRST_PAIRS else added)
            kernel_ms = time_ms(lambda: fn(model.params, x), repeats)
            plain_ms = time_ms(lambda: loglik_grad_gram_reference(ops, x), repeats)
            timings[f"{tiers[0]}/{tiers[1]}/{n}"] = {
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "kernel_stream_ms": stream_ms(lambda: fn(model.params, x), repeats),
            }
            if fn.register_tiled or fn.mixed:
                timings[f"{tiers[0]}/{tiers[1]}/{n}"]["tile_rows"] = fn.rows_for(n)
    torch.cuda.synchronize()
    print(f"phase 4: median ms per call {json.dumps(timings)}", flush=True)
    timings["reverse_turns"] = reverse_in_turns(model, wrappers, timings, added)
    timings["wide"] = wide_network_k3(model, added, dev)

    forced = {h: k3_wrapper(model, obs, EXACT_TIERS, dev, h) for h in K3_F32_HEIGHTS}
    turns = K3_F32_HEIGHTS + K3_F32_HEIGHTS[::-1]
    heights = {}
    for n, repeats in ((4096, 50), (65536, 20)):
        x = rows(n, rng)
        t = [time_ms(lambda: forced[h](model.params, x), repeats) for h in turns]
        dev_t = [stream_ms(lambda: forced[h](model.params, x), repeats) for h in turns]
        heights[str(n)] = {
            str(h): {"kernel_ms": (t[i] + t[-1 - i]) / 2,
                     "kernel_stream_ms": (dev_t[i] + dev_t[-1 - i]) / 2}
            for i, h in enumerate(K3_F32_HEIGHTS)}
    torch.cuda.synchronize()
    print(f"phase 4: fp32 K3 tile heights {json.dumps(heights)}", flush=True)
    timings["mixed_turns"] = mixed_in_turns(model, wrappers, timings, added)
    return timings


def hmc_launches(n_warmup: int, n_steps: int, seed: int = 0, n_leapfrog: int = 8) -> int:
    """The gradient calls ``sample_hmc`` makes at its defaults: one at the
    start, then one per leapfrog step, each iteration's count drawn from
    ⌈L/2⌉ … L by its host generator seeded with ``seed``, replayed here."""
    host = torch.Generator().manual_seed(seed)
    low = max(1, (n_leapfrog + 1) // 2)
    return 1 + sum(int(torch.randint(low, n_leapfrog + 1, (), generator=host))
                   for _ in range(n_warmup + n_steps))


def exact_value_hmc(model, obs, dev, grad_precision=None, precision="contract",
                    accept_near=None):
    """Phase 5's short HMCs: through ``loglik_and_grad_fn(precision=...,
    grad_precision=..., backend="kernel")`` and ``sample_hmc``, every
    leapfrog step on ``fused_loglik_grad_gram_f32.cu`` (the exact tier),
    on ``fused_gram_mixed.cu`` (an exact value, ``grad_precision=
    "default"``: a bf16 force) or, at ``precision="high",
    grad_precision="highest"``, on ``fused_gram_mma.cu``'s reverse mode
    (a bf16x3 value, an exact force), at exactly the launches its
    leapfrog counts imply. The log-density each final walker carries,
    less the sigmoid map's log-Jacobian (the prior is flat), is the
    kernel's logL there: it is held to the plain likelihood at the value
    tier within that tier's value tolerance plus the Jacobian's own
    rounding (the walker's place in the box is known to fp32 only).
    ``accept_near``: an acceptance rate the run's must be within 0.05 of.
    Returns the kernel's launches and the mean acceptance."""
    if precision != "contract":
        label = f"{precision}-value, exact force,"
    elif grad_precision is None:
        label = "exact-tier"
    else:
        label = f"exact-value, {grad_precision} force,"
    valgrad = model.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel", precision=precision,
                                       grad_precision=grad_precision)
    if precision != "contract":
        check(valgrad.reverse and not valgrad.tensor_cores,
              f"{label} HMC runs fused_gram_mma.cu's reverse mode")
    elif grad_precision is None:
        check(not valgrad.tensor_cores and valgrad.register_tiled,
              "exact-tier HMC runs fused_loglik_grad_gram_f32.cu")
    else:
        check(valgrad.mixed and not valgrad.tensor_cores,
              f"{label} HMC runs fused_gram_mixed.cu")
    valgrad.launches = 0
    res, wall = timed(lambda: sample_hmc(valgrad, model.params, device=dev, **EXACT_HMC))
    launches = valgrad.launches
    n_walkers, n_steps = EXACT_HMC["n_walkers"], EXACT_HMC["n_steps"]
    want = hmc_launches(EXACT_HMC["n_warmup"], n_steps)
    check(launches == want, f"{label} K3 launches {launches}, not {want}")
    check(res.chain.shape == (n_steps // 5, n_walkers, 7), f"{label} chain shape {res.chain.shape}")
    check(bool(np.isfinite(res.chain).all() and np.isfinite(res.logp).all()),
          f"{label} HMC: finite chain and logp")
    acc = float(np.mean(res.accept_rate))
    check(0.3 <= acc <= 0.99, f"{label} HMC: mean acceptance {acc:.3f}")
    if accept_near is not None:
        check(abs(acc - accept_near) <= 0.05,
              f"{label} HMC: acceptance {acc:.3f}, the exact tier's {accept_near:.3f}")
    final = res.final.astype(np.float64)
    lo, hi = np.asarray(PAR_RANGES, np.float64).T
    s = (final - lo) / (hi - lo)
    eps = float(np.finfo(np.float32).eps)
    ds = eps * (np.abs(lo) + np.abs(final) + (hi - lo)) / (hi - lo)
    with np.errstate(divide="ignore", invalid="ignore"):
        jac = np.sum(np.log(s) + np.log1p(-s), axis=1)
        jac_err = np.sum(ds * (1.0 / s + 1.0 / (1.0 - s)), axis=1)
    inside = np.isfinite(jac) & np.isfinite(jac_err)  # a walker rounded onto the box's edge
    ops = valgrad.operands(model.params)
    tier = "highest" if precision == "contract" else precision
    plain = model.loglik_fn(obs, NOISE_VAR, precision=precision)  # backend "torch"
    ll = scores(plain, model, res.final, dev)
    tol = VALUE_RTOL[tier] * (np.abs(ll) + 0.5 * abs(float(ops.c))) + VALUE_ATOL + jac_err
    gap = np.abs(res.logp - jac - ll)
    worst = float((gap[inside] / tol[inside]).max())
    check(float(inside.mean()) >= 0.5, f"{label} HMC: {inside.mean():.3f} of walkers inside")
    check(worst <= 1.0, f"{label} HMC: carried logp vs plain logL, worst |Δ|/tol {worst:.3g}")
    key = ("k3_reverse_launches" if valgrad.reverse else "k3_mixed_launches" if valgrad.mixed
           else "k3_f32_launches")
    print(f"phase 5: {label} HMC " + json.dumps({
        "wall_s": wall, key: launches, "tile_rows": valgrad.rows_for(n_walkers),
        "accept": acc, "step_size": res.step_size, "walkers_checked": float(inside.mean()),
        "carried_logp_vs_plain_worst_over_tol": worst,
        "carried_logp_vs_plain_max_abs": float(gap[inside].max()),
        "loglik_final_max": float(ll.max()),
    }), flush=True)
    return launches, acc


def foreground_observation(model, truth, rng):
    """The marginalized path's observation, ``truth signal + F·a + N(0,
    25)`` with the linlog basis ``F`` on the model's axis, and ``F``."""
    basis = linlog_basis(model.frequencies, FG_TERMS)
    obs = model.predict(truth) + basis @ np.asarray(FG_COEFFS) + rng.normal(
        0.0, 5.0, model.config.n_bins)
    return obs.astype(np.float32), basis


def unwrap_level_marginal(spec, value, n_bins):
    """From a noise-level-marginalized value ``const − a·log t``: the
    base likelihood ``log_norm − (t − β)`` and the wrap's slope ``a/t``
    (d wrapped / d base), by the spec's own constants in float64."""
    a, const = spec.shape_coef(n_bins), spec.log_norm_const(n_bins)
    t = np.exp((const - np.asarray(value, np.float64)) / a)
    return spec.base_log_norm() - (t - (spec.beta or 0.0)), a / t


def marginalized_kernels_vs_plain(model, truth, obs, basis, rng, dev):
    """Phase 9: K1 (sumsq), K2 and K3 against their plain versions under
    the operands of a foreground-marginalized spec (flat and proper
    coefficient prior), at the batches and tiers of phases 3 and 6 and
    their tolerances; the noise-level marginal's wrap over K2 and K3
    against the same wrap of the plain versions (tolerance: the base
    value's, times the wrap's slope a/t); injection invariance at the
    exact tier. Returns the largest |Δ logL| per kernel source at the
    tiers of the kernels line."""
    cfg, norm, n_bins = model.config, model.normalizer, model.config.n_bins
    specs = {"flat": model.marginalize_foreground(NOISE_VAR, n_terms=FG_TERMS),
             "proper": model.marginalize_foreground(NOISE_VAR, n_terms=FG_TERMS,
                                                    prior_var=FG_PRIOR_VAR)}
    batches = (1, 37, 8192, 65537)
    xs = {n: rows(n, rng) for n in batches}
    worst, err = {}, {}

    def note(key, share, max_abs=None, source=None):
        worst[key] = max(worst.get(key, 0.0), share)
        if source is not None:
            err[source] = max(err.get(source, 0.0), max_abs)

    for name, mn in specs.items():
        for tier in TIERS:
            direct = make_fused_loglik(cfg, norm, obs, mn, precision=tier, device=dev)
            gram = make_fused_loglik_gram(cfg, norm, obs, mn, precision=tier, device=dev)
            check(gram.tensor_cores == (tier != "highest"), f"K2 route at {tier} ({name})")
            ops_d, ops_g = direct.mlp.operands(model.params), gram.operands(model.params)
            half_c = 0.5 * abs(float(ops_g.c))
            for n, x in xs.items():
                with torch.no_grad():
                    pairs = {
                        "k1_sumsq": (direct(model.params, x),
                                     -0.5 * fused_mlp_reference(ops_d, x) + mn.log_norm),
                        "k2": (gram(model.params, x), loglik_gram_reference(ops_g, x)),
                    }
                for key, (got, want) in pairs.items():
                    got, want = got.cpu().numpy(), want.cpu().numpy()
                    check(got.shape == (x.shape[0],) and bool(np.isfinite(got).all()),
                          f"{key} shape and finite, {name} {tier} n={n}")
                    tol = VALUE_RTOL[tier] * (np.abs(want) + half_c) + VALUE_ATOL
                    dv = np.abs(got - want)
                    share = float((dv / tol).max())
                    check(share <= 1.0, f"{key} value {name} {tier} n={n}: worst |Δ|/tol "
                                        f"{share:.3g}")
                    source = {("k1_sumsq", "highest"): "fused_mlp",
                              ("k1_sumsq", "high"): "fused_mlp_mma",
                              ("k2", "highest"): "fused_loglik_gram",
                              ("k2", "high"): "fused_loglik_gram_mma"}.get((key, tier))
                    note(f"{key}/{name}/{tier}", share, float(dv.max()), source)
        for tiers in TIER_PAIRS:
            fn = k3_wrapper(model, obs, tiers, dev, noise_var=mn)
            ops = fn.operands(model.params)
            check(fn.tensor_cores == ("highest" not in tiers), f"K3 route at {tiers} ({name})")
            half_c = 0.5 * abs(float(ops.c))
            for n, x in xs.items():
                vk, gk = fn(model.params, x)
                vp, gp = loglik_grad_gram_reference(ops, x)
                vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
                check(bool(np.isfinite(vk).all() and np.isfinite(gk).all()),
                      f"K3 finite {name} {tiers} n={n}")
                tol = VALUE_RTOL[tiers[0]] * (np.abs(vp) + half_c) + VALUE_ATOL
                dv = np.abs(vk - vp)
                share = float((dv / tol).max())
                check(share <= 1.0, f"K3 value {name} {tiers} n={n}: worst |Δ|/tol {share:.3g}")
                check(gk[0, 2] == 0.0, f"K3 fx == 0 slot {name} {tiers} n={n}")
                gate = grad_gate_violation(gk, gp)
                check(gate <= 0.0, f"K3 gradient gate {name} {tiers} n={n}: {gate:.3g}")
                if tiers == EXACT_TIERS:
                    q999 = float(np.quantile(grad_rel_error(gk, gp), 0.999))
                    check(q999 <= GRAD_Q999_F32, f"K3 gradient q99.9 {name} n={n}: {q999:.3g}")
                source = {EXACT_TIERS: "fused_loglik_grad_gram_f32",
                          MIXED_TIERS: "fused_gram_mixed",
                          REVERSE_TIERS: "fused_loglik_grad_gram_reverse",
                          MAIN_TIERS: "fused_loglik_grad_gram_mma"}.get(tiers)
                if "highest" in tiers or n == 8192:
                    note(f"k3/{name}/{tiers[0]}-{tiers[1]}", share, float(dv.max()), source)
                else:
                    note(f"k3/{name}/{tiers[0]}-{tiers[1]}", share)

    # the noise-level marginal's wrap, outside the kernel wrappers
    wraps = {"proper_over_fg": marginalize_noise_scale(specs["flat"], alpha=LEVEL_ALPHA,
                                                       beta=LEVEL_BETA),
             "jeffreys_over_25": marginalize_noise_scale(NOISE_VAR)}
    for name, sm in wraps.items():
        for tier in TIERS:
            k2 = make_loglik(cfg, norm, obs, sm, backend="kernel", method="gram",
                             precision=tier)
            fused = k2.base.fused
            ops = fused.operands(model.params)
            plain = sm.wrap_value(lambda p, x, ops=ops: loglik_gram_reference(ops, x), n_bins)
            half_c = 0.5 * abs(float(ops.c))
            for n in (37, 8192):
                k2.launches = 0
                with torch.no_grad():
                    got = k2(model.params, xs[n]).cpu().numpy()
                    want = plain(model.params, xs[n]).cpu().numpy()
                check(k2.launches == fused.launches == 1, f"wrapped K2 launches, {name} {tier}")
                base, slope = unwrap_level_marginal(sm, want, n_bins)
                tol = slope * (VALUE_RTOL[tier] * (np.abs(base) + half_c) + VALUE_ATOL) + 1e-3
                share = float((np.abs(got - want) / tol).max())
                check(bool(np.isfinite(got).all()) and share <= 1.0,
                      f"wrapped K2 {name} {tier} n={n}: worst |Δ|/tol {share:.3g}")
                note(f"k2_wrapped/{name}/{tier}", share)
        for tiers in (EXACT_TIERS, MAIN_TIERS):
            k3 = make_loglik_and_grad(cfg, norm, obs, sm, backend="kernel", precision=tiers[0],
                                      grad_precision=tiers[1])
            ops = k3.base.operands(model.params)
            plain = sm.wrap_valgrad(lambda p, x, ops=ops: loglik_grad_gram_reference(ops, x),
                                    n_bins)
            half_c = 0.5 * abs(float(ops.c))
            for n in (37, 8192):
                k3.launches = 0
                vk, gk = (t.cpu().numpy() for t in k3(model.params, xs[n]))
                vp, gp = (t.cpu().numpy() for t in plain(model.params, xs[n]))
                check(k3.launches == k3.base.launches == 1, f"wrapped K3 launches, {name}")
                base, slope = unwrap_level_marginal(sm, vp, n_bins)
                tol = slope * (VALUE_RTOL[tiers[0]] * (np.abs(base) + half_c) + VALUE_ATOL) + 1e-3
                share = float((np.abs(vk - vp) / tol).max())
                check(bool(np.isfinite(vk).all() and np.isfinite(gk).all()) and share <= 1.0,
                      f"wrapped K3 {name} {tiers} n={n}: worst |Δ|/tol {share:.3g}")
                gate = grad_gate_violation(gk, gp)
                check(gate <= 0.0, f"wrapped K3 gradient gate {name} {tiers} n={n}: {gate:.3g}")
                note(f"k3_wrapped/{name}/{tiers[0]}-{tiers[1]}", share)

    # injection invariance at the exact tier: P·F = 0 under the flat prior,
    # up to the fp32 rounding of (b − obs) @ R (the JAX suite's bound:
    # 1e-3 of max|logL| over prior draws); also read near the mode
    moved_obs = (obs + basis @ rng.normal(0.0, 100.0, FG_TERMS)).astype(np.float32)
    near = np.clip(truth * (1.0 + 0.01 * rng.normal(size=(8192, truth.shape[0]))),
                   PAR_RANGES[:, 0], PAR_RANGES[:, 1]).astype(np.float32)
    sets = {"prior_draws": xs[8192], "near_truth": torch.as_tensor(near, device=dev)}
    drift = {}
    for label, x in sets.items():
        with torch.no_grad():
            vals = {
                (spec, which): make_fused_loglik_gram(cfg, norm, o, nv, precision="highest",
                                                      device=dev)(model.params, x).cpu().numpy()
                for spec, nv in (("marginalized", specs["flat"]), ("diagonal", NOISE_VAR))
                for which, o in (("obs", obs), ("moved", moved_obs))
            }
        scale = float(np.abs(vals["marginalized", "obs"]).max())
        d = float(np.abs(vals["marginalized", "moved"] - vals["marginalized", "obs"]).max())
        plain_move = float(np.abs(vals["diagonal", "moved"] - vals["diagonal", "obs"]).min())
        drift[label] = {"max_abs_drift": d, "max_abs_loglik": scale, "drift_over_max": d / scale,
                        "diagonal_min_move": plain_move}
    check(drift["prior_draws"]["drift_over_max"] < 1e-3,
          f"injection invariance: drift {drift['prior_draws']}")
    check(drift["prior_draws"]["diagonal_min_move"] > 100.0,
          f"the diagonal-noise value must move under injection: {drift['prior_draws']}")
    print("phase 9: K1, K2 and K3 == plain under the marginalized operands at every batch, "
          "tier and coefficient prior, and under the noise-level wrap; worst |Δ|/tol "
          + json.dumps(worst) + " injection " + json.dumps(drift), flush=True)
    return err


def time_both_operand_sets(model, obs_diag, obs_fg, mn, rng, dev) -> dict:
    """Device ms per call (:func:`stream_ms`) of the main path's kernels
    under the diagonal spec's operands and the marginalized spec's, in
    turns diagonal, marginalized, marginalized, diagonal."""
    cfg, norm = model.config, model.normalizer
    cases = {
        "k3/high-default/4096": (4096, 50, lambda o, nv: k3_wrapper(model, o, MAIN_TIERS, dev,
                                                                    noise_var=nv)),
        "k2/high/8192": (8192, 20, lambda o, nv: make_fused_loglik_gram(
            cfg, norm, o, nv, precision="high", device=dev)),
        f"k1_sumsq/highest/{DRAWS}": (DRAWS, 3, lambda o, nv: make_fused_loglik(
            cfg, norm, o, nv, precision="highest", device=dev)),
        f"k2/highest/{DRAWS}": (DRAWS, 3, lambda o, nv: make_fused_loglik_gram(
            cfg, norm, o, nv, precision="highest", device=dev)),
    }
    out = {}
    for key, (n, repeats, build) in cases.items():
        x = rows(n, rng)
        diag, marg = build(obs_diag, NOISE_VAR), build(obs_fg, mn)
        with torch.no_grad():
            t = [stream_ms(lambda: fn(model.params, x), repeats)
                 for fn in (diag, marg, marg, diag)]
        out[key] = {"diagonal_stream_ms": (t[0] + t[3]) / 2,
                    "marginalized_stream_ms": (t[1] + t[2]) / 2}
        del x
        torch.cuda.empty_cache()
    return out


def marginalized_posterior_path(model, truth, obs_diag, obs, rng, dev, diag_launches):
    """Phase 10: HMC, MH and the ensemble through ``sample_posterior``
    under the foreground- and noise-level-marginalized spec with a
    Gaussian prior on tau. ``diag_launches``: each sampler's launch count
    under the diagonal spec (phases 5 and 8). Returns the launches of the
    marginalized runs by kernel source, the HMC chain's draws, and the
    specs."""
    n_bins = model.config.n_bins
    mn = model.marginalize_foreground(NOISE_VAR, n_terms=FG_TERMS)
    spec = marginalize_noise_scale(mn, alpha=LEVEL_ALPHA, beta=LEVEL_BETA)
    prior = GaussianBoxPrior.for_params({TAU_INDEX: (float(truth[TAU_INDEX]), TAU_SIGMA)})
    k1 = model.loglik_fn(obs, spec, method="direct", precision="contract", backend="kernel")
    k2_exact = model.loglik_fn(obs, spec, precision="contract", backend="kernel")
    half_c = 0.5 * abs(float(k2_exact.base.fused.operands(model.params).c))
    launches = {"fused_mlp": 0, "fused_loglik_gram": 0, "fused_loglik_gram_mma": 0,
                "fused_loglik_grad_gram_mma": 0}
    out, hmc_draws = {}, None

    def sampling_kernel(sampler, o, nv):
        if sampler == "hmc":
            return model.loglik_and_grad_fn(o, nv, backend="kernel", grad_precision=MAIN_TIERS[1])
        return model.loglik_fn(o, nv, backend="kernel")

    def run(sampler, o, nv, **extra):
        fn = sampling_kernel(sampler, o, nv)
        fn.launches = 0
        res, wall = timed(lambda: model.sample_posterior(o, nv, sampler=sampler,
                                                         **SAMPLER_SIZES[sampler], **extra))
        return res, wall, fn.launches

    for sampler, sizes in SAMPLER_SIZES.items():
        # in turns: diagonal, marginalized, marginalized, diagonal; then the
        # marginalized spec under the flat box alone, for tau's spread
        turns = [run(sampler, obs_diag, NOISE_VAR),
                 run(sampler, obs, spec, log_prior=prior.log_prior),
                 run(sampler, obs, spec, log_prior=prior.log_prior),
                 run(sampler, obs_diag, NOISE_VAR)]
        flat_prior, flat_wall, _ = run(sampler, obs, spec)
        res, _, n_launch = turns[1]
        fn = sampling_kernel(sampler, obs, spec)
        check(fn.base.tensor_cores if sampler == "hmc" else fn.base.fused.tensor_cores,
              f"{sampler}: the marginalized run's kernel is fused_gram_mma.cu")
        for _, _, count in turns:
            check(count == diag_launches[sampler],
                  f"{sampler}: {count} launches; the diagonal path of phases 5 and 8 made "
                  f"{diag_launches[sampler]}")
        source = "fused_loglik_grad_gram_mma" if sampler == "hmc" else "fused_loglik_gram_mma"
        launches[source] += n_launch
        thin = 5 if sampler == "hmc" else 10
        check(res.chain.shape == (sizes["n_steps"] // thin, sizes["n_walkers"], 7),
              f"{sampler}: chain shape {res.chain.shape}")
        check(bool(np.isfinite(res.chain).all() and np.isfinite(res.logp).all()),
              f"{sampler}: finite chains under the marginalized spec")
        acc = float(np.mean(res.accept_rate))
        lo_acc, hi_acc = ACCEPT_RANGE[sampler]
        check(lo_acc <= acc <= hi_acc, f"{sampler}: mean acceptance {acc:.3f}")
        tau_sd = float(res.flat[:, TAU_INDEX].std())
        tau_sd_flat = float(flat_prior.flat[:, TAU_INDEX].std())
        check(tau_sd < tau_sd_flat, f"{sampler}: tau sd {tau_sd:.4g} under the prior, "
                                    f"{tau_sd_flat:.4g} under the flat box")
        # the draws scored by the direct form (K1) and the gram form (K2) at
        # the exact tier under the same spec, held to each other as phase 8
        # holds them: the base value's tolerance times the wrap's slope
        k1.launches = k2_exact.launches = 0
        ll_draws = scores(k1, model, res.flat, dev)
        ll_truth = float(scores(k1, model, truth, dev)[0])
        ll_gram = scores(k2_exact, model, res.flat, dev)
        check(k1.launches == 2 and k2_exact.launches == 1,
              f"{sampler}: scoring launches {k1.launches}, {k2_exact.launches}")
        launches["fused_mlp"] += k1.launches
        launches["fused_loglik_gram"] += k2_exact.launches
        base, slope = unwrap_level_marginal(spec, ll_draws, n_bins)
        tol = slope * (VALUE_RTOL["highest"] * (np.abs(base) + half_c) + VALUE_ATOL) + 1e-3
        gram_worst = float((np.abs(ll_gram - ll_draws) / tol).max())
        check(bool(np.isfinite(ll_draws).all()) and gram_worst <= 1.0,
              f"{sampler}: exact gram vs direct under the spec, worst |Δ|/tol {gram_worst:.3g}")
        check(float(ll_draws.max()) >= ll_truth - 5.0,
              f"{sampler}: best draw {float(ll_draws.max()):.2f} < logL(truth) {ll_truth:.2f} − 5")
        if sampler == "hmc":
            hmc_draws = res.flat
        flat = res.flat
        out[sampler] = {
            "wall_s_diagonal": [turns[0][1], turns[3][1]],
            "wall_s_marginalized": [turns[1][1], turns[2][1]],
            "wall_s_marginalized_flat_prior": flat_wall,
            "launches": n_launch, "accept": acc, "accept_diagonal": float(np.mean(
                turns[0][0].accept_rate)),
            "tau_sd": tau_sd, "tau_sd_flat_prior": tau_sd_flat,
            "exact_gram_vs_direct_worst_over_tol": gram_worst,
            "rhat_max": float(res.rhat().max()),
            "z": (np.abs(flat.mean(0) - truth) / flat.std(0)).tolist(),
            "loglik_truth": ll_truth, "loglik_draws_max": float(ll_draws.max()),
            "share_at_least_truth": float(np.mean(ll_draws >= ll_truth)),
        }
    out["kernel_stream_ms"] = time_both_operand_sets(model, obs_diag, obs, mn, rng, dev)
    print("phase 10: " + json.dumps(out), flush=True)
    return launches, hmc_draws, mn, spec


def forecast_and_band(model, truth, hmc_draws, mn, spec):
    """Phase 11: Fisher forecasts at the truth under the diagonal, the
    foreground-marginalized and the noise-level-marginalized spec, and
    the predictive band of the marginalized HMC chain's draws."""
    f0, sig0 = model.fisher_forecast(truth, NOISE_VAR)
    fm, sigm = model.fisher_forecast(truth, mn)
    ft, sigt = model.fisher_forecast(truth, spec)
    check(bool(np.isfinite(sig0).all() and np.isfinite(sigm).all() and np.isfinite(sigt).all()),
          "finite forecast errors")
    check(bool((sigm >= sig0 * (1 - 1e-9)).all()),
          f"foreground marginalization must not shrink sigma: {sig0} {sigm}")
    # the noise-level marginal: F_t = (α/β)·(2α + n_eff)/(2α + n_eff + 2)·F; at
    # the prior-mean precision α/β the t factor < 1 is lost information
    n_eff = model.config.n_bins - FG_TERMS
    t_factor = (2 * LEVEL_ALPHA + n_eff) / (2 * LEVEL_ALPHA + n_eff + 2.0)
    want = LEVEL_ALPHA / LEVEL_BETA * t_factor * fm
    check(bool(np.allclose(ft, want, rtol=1e-5, atol=1e-7 * np.abs(want).max())),
          "Student-t Fisher factor")
    check(bool((sigt * np.sqrt(LEVEL_ALPHA / LEVEL_BETA) >= sigm * (1 - 1e-9)).all()),
          f"noise-level marginalization must not shrink sigma at equal precision: {sigm} {sigt}")
    band = model.posterior_predictive(hmc_draws, quantiles=(0.025, 0.5, 0.975))
    sig = model.predict(truth)
    inside = float(np.mean((sig >= band.bands[0]) & (sig <= band.bands[2])))
    check(band.bands.shape == (3, model.config.n_bins) and bool(np.isfinite(band.bands).all()),
          "predictive band shape and finite")
    check(inside >= BAND_SHARE, f"truth inside the 95 % band in {inside:.3f} of the bins")
    print("phase 11: " + json.dumps({
        "sigma_diagonal": sig0.tolist(), "sigma_fg_marginalized": sigm.tolist(),
        "sigma_level_marginalized": sigt.tolist(), "t_factor": t_factor,
        "truth_inside_95_band": inside,
        "median_max_abs_mk": float(np.abs(band.bands[1] - sig).max()),
        "band_mean_width_mk": float(np.mean(band.bands[2] - band.bands[0])),
    }), flush=True)


def inside_central_999(flat, truth) -> bool:
    """Whether ``truth`` lies inside every marginal's central 99.9 % of
    the draws ``flat`` (phase 5's typical-truth check)."""
    lo_q, hi_q = np.quantile(flat, [0.0005, 0.9995], axis=0)
    return bool(((truth >= lo_q) & (truth <= hi_q)).all())


def main_k3(model, obs):
    """The memoized K3 wrapper of HMC, ChEES, NUTS and the fits."""
    return model.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel",
                                    grad_precision=MAIN_TIERS[1])


def exact_loglik(model, obs):
    """The plain likelihood at the exact tier (fp32, no kernel)."""
    return model.loglik_fn(obs, NOISE_VAR, precision="contract")


def truth_likelihood_rank(model, obs, flat, truth, dev):
    """``(share, logL(truth), max logL(draws))`` under the plain
    likelihood at the exact tier: ``share`` is the share of the draws
    ``flat`` that score at least as high as the truth (the truth's rank
    in likelihood, which phase 5 holds inside [0.001, 0.999]); phase 8
    holds the best draw above the truth less 5 nats."""
    exact = exact_loglik(model, obs)
    ll = scores(exact, model, flat, dev)
    ll_truth = float(scores(exact, model, truth, dev)[0])
    return float(np.mean(ll >= ll_truth)), ll_truth, float(ll.max())


def weighted_quantiles(x, w, qs):
    """Quantiles ``qs`` of the columns of ``x`` under the weights ``w``
    (summing to 1), on the device."""
    order = torch.argsort(x, dim=0)
    cdf = torch.cumsum(w[order], dim=0)
    at = torch.stack([torch.searchsorted(cdf[:, j].contiguous(),
                                         torch.as_tensor(qs, dtype=cdf.dtype, device=x.device))
                      for j in range(x.shape[1])], dim=1).clamp(max=x.shape[0] - 1)
    return torch.gather(torch.gather(x, 0, order), 0, at)


@torch.no_grad()
def importance_witness(model, obs, truth, dev) -> dict:
    """The flat-box posterior by importance sampling, a witness that
    shares no code with the samplers: every draw is scored by the plain
    exact-tier likelihood. The box splits at fx = ``WITNESS_FX_SPLIT``
    into two strata, each sampled on its own: coordinates ``z``, the
    logit of each parameter's place in the stratum, on a log scale for
    fstar, Vc and fx (the scale ``synthetic_params`` draws them on);
    first ``WITNESS_BOX_ROWS`` draws uniform in ``z``, then
    ``WITNESS_ROUNDS`` rounds of ``WITNESS_ROWS`` draws from a Student t
    (``WITNESS_DF`` degrees of freedom) fitted to the previous stage's
    weighted draws, its covariance doubled (population Monte Carlo). The
    strata's last rounds, weighted by their mass estimates, give each
    marginal's median, its interquartile range over 1.349 (the robust
    scale), the truth's rank, the effective sample size and each
    stratum's share of the mass, under the flat box prior the samplers
    use and under the log-uniform prior the truth was drawn from. The
    mean of a stratum's last-round weights estimates ∫ L dx over it, so
    their sum over the strata, over the box's volume, is the evidence
    under the flat box prior (``logz_flat``), its standard error
    (``logz_flat_err``) from the weights' variance."""
    gen = torch.Generator(device=dev).manual_seed(0)
    d = PAR_RANGES.shape[0]
    logs = torch.zeros(d, dtype=torch.bool, device=dev)
    logs[:3] = True
    exact = exact_loglik(model, obs)
    nu = WITNESS_DF

    def stratum(box):
        lo, hi = (torch.as_tensor(box[:, i], dtype=torch.float64, device=dev) for i in (0, 1))
        t_lo, t_hi = torch.where(logs, lo.log(), lo), torch.where(logs, hi.log(), hi)
        log_span = torch.log(t_hi - t_lo).sum()

        def weigh(z, log_q):
            """The draws ``z`` in raw units, their log-weights under the
            flat box prior, and the log-uniform prior's log-density ratio
            to it."""
            s = torch.sigmoid(z)
            t = t_lo + (t_hi - t_lo) * s
            x = torch.where(logs, t.exp(), t)
            ll = torch.cat([exact(model.params, c.float()) for c in x.split(WITNESS_CHUNK)])
            jac = (F.logsigmoid(z) + F.logsigmoid(-z)).sum(1) + log_span
            log_x = torch.where(logs, t, torch.zeros_like(t)).sum(1)
            log_w = torch.nan_to_num(ll.double() + jac + log_x - log_q, nan=-np.inf)
            return x, log_w, -log_x

        u = torch.rand((WITNESS_BOX_ROWS, d), generator=gen, device=dev, dtype=torch.float64)
        z = torch.logit(u.clamp(1e-12, 1.0 - 1e-12))
        log_q = (F.logsigmoid(z) + F.logsigmoid(-z)).sum(1)
        ess = []
        for stage in range(WITNESS_ROUNDS + 1):
            x, log_w, to_log_prior = weigh(z, log_q)
            w, n_eff = normalized(log_w)
            ess.append(n_eff)
            if stage == WITNESS_ROUNDS:
                return x, log_w, to_log_prior, ess
            mu = w @ z
            cov = ((z - mu) * w[:, None]).T @ (z - mu)
            chol = torch.linalg.cholesky(2.0 * cov + 1e-4 * torch.eye(d, dtype=cov.dtype,
                                                                      device=dev))
            eps = torch.randn((WITNESS_ROWS, d), generator=gen, device=dev, dtype=torch.float64)
            g = (torch.randn((WITNESS_ROWS, nu), generator=gen, device=dev,
                             dtype=torch.float64) ** 2).sum(1) / nu
            z = mu + (eps @ chol.T) / g.sqrt()[:, None]
            log_q = (math.lgamma((nu + d) / 2) - math.lgamma(nu / 2)
                     - 0.5 * d * math.log(nu * math.pi) - torch.log(torch.diagonal(chol)).sum()
                     - 0.5 * (nu + d) * torch.log1p((eps * eps).sum(1) / g / nu))

    def normalized(log_w):
        w = torch.exp(log_w - log_w.max())
        w = w / w.sum()
        return w, float(1.0 / (w * w).sum())

    low, high = PAR_RANGES.copy(), PAR_RANGES.copy()
    low[2, 1] = high[2, 0] = WITNESS_FX_SPLIT
    # equal rows per stratum, so pooled weights are each stratum's mass estimate
    strata = [stratum(box) for box in (low, high)]
    x = torch.cat([s[0] for s in strata])
    truth_t = torch.as_tensor(truth, dtype=torch.float64, device=dev)
    out = {"fx_split": WITNESS_FX_SPLIT, "ess_by_stage": [s[3] for s in strata]}
    log_mean, log_var = [], []  # each stratum's log ∫ L dx and log Var of its estimate
    for _, log_w, _, _ in strata:
        w = torch.exp(log_w - log_w.max())
        log_mean.append(float(log_w.max() + torch.log(w.mean())))
        log_var.append(float(2.0 * log_w.max() + torch.log(w.var() / w.numel())))
    log_integral = float(np.logaddexp.reduce(log_mean))
    out["logz_flat"] = log_integral - float(np.log(PAR_RANGES[:, 1] - PAR_RANGES[:, 0]).sum())
    out["logz_flat_err"] = math.exp(0.5 * float(np.logaddexp.reduce(log_var)) - log_integral)
    for prior, lw in (("flat", torch.cat([s[1] for s in strata])),
                      ("log_uniform", torch.cat([s[1] + s[2] for s in strata]))):
        w, n_eff = normalized(lw)
        q25, q50, q75 = weighted_quantiles(x, w, (0.25, 0.5, 0.75))
        out[prior] = {"ess": n_eff, "mass_fx_below_split": float(w[:WITNESS_ROWS].sum()),
                      "median": q50.tolist(), "scale": ((q75 - q25) / 1.349).tolist(),
                      "truth_rank": (w @ (x < truth_t).double()).tolist()}
    return out


def adaptive_main_path(model, truth, obs, dev):
    """Phase 12: ChEES and NUTS through ``sample_posterior``, every
    leapfrog step on the memoized K3 wrapper (shared with HMC and the
    fits, so its launches are read as deltas). The truth must be typical
    in likelihood (its rank in [0.001, 0.999], as phase 5 holds it), and
    each sampler must agree with :func:`importance_witness` in every
    marginal: its median within half the witness's robust scale, the
    truth's rank within 0.02 plus four of the witness's standard errors.
    Whether the truth lies inside every marginal's central 99.9 % is
    printed, not gated: the truth was drawn log-uniform in fstar, Vc and
    fx, the posterior has a flat prior there, and the witness puts it in
    those marginals' far tails too. Returns the launches by sampler and
    the pooled draws and the witness."""
    k3 = main_k3(model, obs)
    check(k3.tensor_cores, "the adaptive samplers' K3 runs fused_gram_mma.cu")
    witness, witness_s = timed(lambda: importance_witness(model, obs, truth, dev))
    flat_w = witness["flat"]
    print("phase 12: witness " + json.dumps({"wall_s": witness_s, **witness}), flush=True)
    check(flat_w["ess"] >= WITNESS_MIN_ESS,
          f"importance witness: effective sample size {flat_w['ess']:.0f} < {WITNESS_MIN_ESS}")
    out, launches, pooled = {}, {}, []
    for sampler, sizes, extra, cap in (
        ("chees", CHEES_SIZES, dict(max_leapfrog=CHEES_MAX_LEAPFROG), CHEES_MAX_LEAPFROG),
        ("nuts", NUTS_SIZES, dict(max_depth=NUTS_MAX_DEPTH), 2**NUTS_MAX_DEPTH - 1),
    ):
        before = k3.launches
        res, wall = timed(lambda: model.sample_posterior(obs, NOISE_VAR, sampler=sampler,
                                                         thin=5, **sizes, **extra))
        n = k3.launches - before
        check(main_k3(model, obs) is k3, f"{sampler}: sample_posterior used HMC's K3 wrapper")
        iters = sizes["n_warmup"] + sizes["n_steps"]
        check(1 + iters <= n <= 1 + iters * cap,
              f"{sampler}: K3 launches {n} outside [{1 + iters}, {1 + iters * cap}]")
        check(res.chain.shape == (sizes["n_steps"] // 5, sizes["n_walkers"], 7),
              f"{sampler}: chain shape {res.chain.shape}")
        check(bool(np.isfinite(res.chain).all() and np.isfinite(res.logp).all()),
              f"{sampler}: finite chains")
        flat = res.flat
        pooled.append(flat)
        launches[sampler] = n
        rank = np.mean(flat < truth, axis=0)
        median = np.median(flat, axis=0)
        apart = np.abs(median - flat_w["median"]) / np.asarray(flat_w["scale"])
        r_w = np.asarray(flat_w["truth_rank"])
        rank_tol = 0.02 + 4.0 * np.sqrt(r_w * (1.0 - r_w) / flat_w["ess"])
        out[sampler] = {
            "wall_s": wall, "k3_launches": n, "launches_per_iteration": (n - 1) / iters,
            "step_size": res.step_size, "accept": float(np.mean(res.accept_rate)),
            "trajectory_length": getattr(res, "trajectory_length", None),
            "mean_leapfrog": getattr(res, "mean_leapfrog", None),
            "divergence_rate": getattr(res, "divergence_rate", None),
            "rhat_max": float(res.rhat().max()),
            "truth_rank": rank.tolist(), "truth_inside_central_999": inside_central_999(flat, truth),
            "share_at_least_truth": truth_likelihood_rank(model, obs, flat, truth, dev)[0],
            "median": median.tolist(), "median_apart_in_witness_scale": apart.tolist(),
            "truth_rank_minus_witness": (rank - r_w).tolist(),
        }
        print(f"phase 12: {sampler} " + json.dumps(out[sampler]), flush=True)
        share = out[sampler]["share_at_least_truth"]
        check(0.001 <= share <= 0.999, f"{sampler}: likelihood rank of the truth {share:.4f}")
        check(bool((apart <= 0.5).all()),
              f"{sampler}: medians apart from the witness's by {apart} of its robust scale")
        check(bool((np.abs(rank - r_w) <= rank_tol).all()),
              f"{sampler}: truth ranks {rank} against the witness's {r_w} (tolerance {rank_tol})")
    return launches, np.concatenate(pooled), witness


def fit_box(draws, truth):
    """The fits' search box: each marginal's central 99.9 % of ``draws``
    and the truth, widened by a quarter of that width on each side,
    inside the prior box."""
    lo, hi = np.quantile(draws, [0.0005, 0.9995], axis=0)
    lo, hi = np.minimum(lo, truth), np.maximum(hi, truth)
    pad = 0.25 * (hi - lo)
    return np.stack([np.maximum(lo - pad, PAR_RANGES[:, 0]),
                     np.minimum(hi + pad, PAR_RANGES[:, 1])], axis=1)


def fits_and_target_ess(model, truth, obs, draws, dev):
    """Phase 13: ``fit_params`` from uniform starts and
    ``profile_likelihood`` of tau, both inside :func:`fit_box` of phase
    12's draws and on the memoized K3 wrapper (exactly ``n_steps + 1``
    launches each). The fit's best must be at least as likely as the
    truth less 1 nat, the profile's peak within 1 nat of the fit's best,
    and K3's value at the fit's best and at every profile point within
    the bf16x3 value tolerance of the plain exact-tier likelihood there.
    Then MH chunked to a target ESS on the memoized K2 wrapper, once to a
    target it reaches and once to one it cannot reach in ``max_chunks``.
    Returns the launches by path."""
    k3 = main_k3(model, obs)
    exact = exact_loglik(model, obs)
    half_c = 0.5 * abs(float(k3.operands(model.params).c))
    box = fit_box(draws, truth)

    def k3_vs_plain_worst(value, at):
        """Worst |K3 value − plain exact-tier logL| over its tolerance."""
        want = scores(exact, model, at, dev).astype(np.float64)
        tol = VALUE_RTOL[MAIN_TIERS[0]] * (np.abs(want) + half_c) + VALUE_ATOL
        return float((np.abs(np.asarray(value, np.float64) - want) / tol).max())

    ll_truth = float(scores(exact, model, truth, dev)[0])
    before = k3.launches
    fit, fit_s = timed(lambda: model.fit_params(obs, NOISE_VAR, n_starts=FIT_STARTS,
                                                n_steps=FIT_STEPS, bounds=box, seed=0))
    n_fit = k3.launches - before
    check(n_fit == FIT_STEPS + 1, f"fit_params: K3 launches {n_fit} != {FIT_STEPS + 1}")
    check(fit.params.shape == (FIT_STARTS, 7) and bool(np.isfinite(fit.best_logp)),
          "fit_params: shape and a finite best")
    ll_best = float(scores(exact, model, fit.best, dev)[0])
    fit_worst = k3_vs_plain_worst([fit.best_logp], fit.best)
    check(fit_worst <= 1.0, f"fit_params: K3 best_logp vs plain, worst |Δ|/tol {fit_worst:.3g}")
    check(ll_best >= ll_truth - 1.0,
          f"fit_params: best {ll_best:.3f} < logL(truth) {ll_truth:.3f} − 1 (exact tier)")
    lo, hi = box[TAU_INDEX]
    centre = float(np.clip(fit.best[TAU_INDEX], lo + PROFILE_HALF_WIDTH, hi - PROFILE_HALF_WIDTH))
    grid = np.linspace(centre - PROFILE_HALF_WIDTH, centre + PROFILE_HALF_WIDTH, PROFILE_POINTS)
    before = k3.launches
    prof, prof_s = timed(lambda: model.profile_likelihood(
        obs, NOISE_VAR, TAU_INDEX, grid, n_starts=PROFILE_STARTS, n_steps=FIT_STEPS,
        bounds=box, seed=0))
    n_prof = k3.launches - before
    check(n_prof == FIT_STEPS + 1, f"profile_likelihood: K3 launches {n_prof} != {FIT_STEPS + 1}")
    check(bool(np.isfinite(prof.logl).all()), "profile_likelihood: finite profile")
    prof_worst = k3_vs_plain_worst(prof.logl, prof.params)
    check(prof_worst <= 1.0,
          f"profile_likelihood: K3 logl vs plain, worst |Δ|/tol {prof_worst:.3g}")
    gap = float(prof.logl.max() - fit.best_logp)
    check(abs(gap) <= 1.0, f"profile peak {gap:.3f} nats from the best fit")

    k2 = model.loglik_fn(obs, NOISE_VAR, backend="kernel")
    check(k2.fused.tensor_cores, "target_ess: K2 runs fused_gram_mma.cu")
    ess_out, n_ess = {}, 0
    for label, target, max_chunks in (("reached", ESS_TARGET, ESS_MAX_CHUNKS),
                                      ("capped", ESS_UNREACHED, ESS_CAPPED_CHUNKS)):
        before = k2.launches
        run, wall = timed(lambda: model.sample_posterior(
            obs, NOISE_VAR, sampler="mh", target_ess=target, n_walkers=ESS_WALKERS,
            n_steps=ESS_CHUNK, n_warmup=ESS_WARMUP, thin=10, max_chunks=max_chunks, seed=0))
        n = k2.launches - before
        n_ess += n
        chunks = run.chain.shape[0] // (ESS_CHUNK // 10)
        want = (1 + ESS_WARMUP + ESS_CHUNK) + (chunks - 1) * (1 + ESS_CHUNK)
        check(n == want, f"target_ess {label}: {chunks} chunks, K2 launches {n} != {want}")
        check(bool(np.isfinite(run.chain).all()), f"target_ess {label}: finite chain")
        bulk, tail = run.ess(), run.ess_tail()
        reached = bool(np.isfinite(tail).all() and min(bulk.min(), tail.min()) >= target)
        if label == "reached":
            check(reached and chunks <= max_chunks,
                  f"target_ess: {target} not reached in {chunks} chunks")
        else:
            check(not reached and chunks == max_chunks,
                  f"target_ess {label}: {chunks} chunks, reached {reached}")
        ess_out[label] = {"wall_s": wall, "k2_launches": n, "chunks": chunks, "target": target,
                          "min_bulk_ess": float(bulk.min()), "min_tail_ess": float(tail.min()),
                          "reached": reached}
    print("phase 13: " + json.dumps({
        "box": box.tolist(), "loglik_truth_exact": ll_truth,
        "fit": {"wall_s": fit_s, "k3_launches": n_fit, "best_logp_k3": fit.best_logp,
                "best_logp_exact": ll_best, "best_minus_truth_exact": ll_best - ll_truth,
                "k3_vs_plain_worst_over_tol": fit_worst,
                "starts_within_1_nat_of_best": int((fit.logp > fit.best_logp - 1.0).sum()),
                "best": fit.best.tolist(), "truth": truth.tolist()},
        "profile": {"wall_s": prof_s, "k3_launches": n_prof, "grid": grid.tolist(),
                    "logl": prof.logl.tolist(), "peak_minus_best_fit": gap,
                    "k3_vs_plain_worst_over_tol": prof_worst,
                    "interval_68": list(prof.interval(0.68))},
        "target_ess": ess_out,
    }), flush=True)
    return {"fit": n_fit, "profile": n_prof, "target_ess": n_ess}


def batched_and_calibration(model, hmc_result, obs, rng, dev):
    """Phase 14: ``sample_posterior_batch`` with MH, HMC and NUTS (plain
    PyTorch: the stacked-observation likelihoods have no kernel): under
    NUTS each observation's truth typical in likelihood (phase 12), under
    HMC each observation's best draw within 5 nats of its truth (phase 8),
    MH's numbers and every marginal inclusion printed; then the
    goodness-of-fit checks and a small SBC, their p-values printed."""
    from tpu21cmvae_torch.calibration import sbc

    truths = synthetic_params(BATCH_OBS, rng)
    obs_b = model.predict(truths) + rng.normal(0.0, np.sqrt(NOISE_VAR), (BATCH_OBS, 451))
    batches = {}
    for sampler, kw in BATCH_SIZES.items():
        res, wall = timed(lambda: model.sample_posterior_batch(
            obs_b, NOISE_VAR, sampler=sampler, n_walkers=BATCH_WALKERS, seed=1, **kw))
        n_keep = kw["n_steps"] // kw["thin"]
        check(res.chain.shape == (n_keep, BATCH_OBS, BATCH_WALKERS, 7),
              f"batch {sampler}: chain shape {res.chain.shape}")
        check(bool(np.isfinite(res.result.chain).all() and np.isfinite(res.result.logp).all()),
              f"batch {sampler}: finite chains")
        check(res.result.block_step_sizes.shape == (BATCH_OBS,),
              f"batch {sampler}: one step per observation")
        ranks = [truth_likelihood_rank(model, obs_b[o], res.flat(o), truths[o], dev)
                 for o in range(BATCH_OBS)]
        shares = [share for share, _, _ in ranks]
        best = [ll_max - ll_truth for _, ll_truth, ll_max in ranks]
        batches[sampler] = res
        entry = {"wall_s": wall, "accept": float(np.mean(res.result.accept_rate)),
                 "block_step_sizes": res.result.block_step_sizes.tolist(),
                 "rhat_max": [float(res.per_obs(o).rhat().max()) for o in range(BATCH_OBS)],
                 "share_at_least_truth": shares, "best_minus_truth": best,
                 "truth_inside_central_999": [inside_central_999(res.flat(o), truths[o])
                                              for o in range(BATCH_OBS)],
                 "mean_leapfrog": getattr(res.result, "mean_leapfrog", None),
                 "divergence_rate": getattr(res.result, "divergence_rate", None)}
        print(f"phase 14: batch {sampler} " + json.dumps(entry), flush=True)
        # NUTS mixes (one metric per observation): the truth typical in
        # likelihood, as phase 12 holds it; HMC reaches every observation's
        # mode, as phase 8 holds a sampler that does not mix. Random-walk MH
        # with 512 walkers leaves some observations' walkers all far from
        # the mode after 600 steps: it is printed, not gated.
        if sampler == "nuts":
            check(all(0.001 <= v <= 0.999 for v in shares),
                  f"batch nuts: likelihood rank of each observation's truth {shares}")
        elif sampler == "hmc":
            check(min(best) >= -5.0, f"batch hmc: best draw − logL(truth) {best}")
    gof, gof_s = timed(lambda: model.goodness_of_fit(obs, NOISE_VAR, hmc_result))
    gofb, gofb_s = timed(lambda: model.goodness_of_fit_batch(obs_b, NOISE_VAR, batches["mh"]))
    check(0.0 <= gof.p_value <= 1.0 and bool(((gofb.p_values >= 0) & (gofb.p_values <= 1)).all()),
          "goodness-of-fit p-values in [0, 1]")
    study, sbc_s = timed(lambda: sbc(model, n_sims=SBC_SIMS, n_walkers=SBC_WALKERS,
                                     noise_var=NOISE_VAR, seed=3))
    check(study.ranks.shape == (SBC_SIMS, 7)
          and bool(((study.ranks >= 0) & (study.ranks <= SBC_WALKERS)).all()),
          "sbc: ranks shape and range")
    print("phase 14: " + json.dumps({
        "gof_hmc": {"wall_s": gof_s, "p_value": gof.p_value,
                    "q_over_dof": float(np.mean(gof.q)) / gof.dof},
        "gof_batch_mh": {"wall_s": gofb_s, "p_values": gofb.p_values.tolist(),
                         "flagged": gofb.flagged.tolist()},
        "sbc": {"wall_s": sbc_s, "pvalues": study.pvalues.tolist(), "n_sims": SBC_SIMS,
                "n_walkers": SBC_WALKERS},
    }), flush=True)
    return obs_b


def evidence_wrappers(model, obs) -> dict:
    """The memoized kernel wrappers the evidence paths run, by name: K2
    at bf16x3 (nested, SMC, PT, the ladder), K2 and K3 at fp32 (Laplace's
    IS rounds and ascent), K3 at (high, default) (the ladder's warm
    start)."""
    return {
        "k2": model.loglik_fn(obs, NOISE_VAR, backend="kernel"),
        "k2_f32": model.loglik_fn(obs, NOISE_VAR, backend="kernel", precision="contract"),
        "k3_f32": model.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel",
                                           precision="contract"),
        "k3": main_k3(model, obs),
    }


def value_worst(got, want, tier, half_c):
    """``(worst |Δ|/tol, max |Δ|)`` of values against their plain ones."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = VALUE_RTOL[tier] * (np.abs(want) + half_c) + VALUE_ATOL
    dv = np.abs(got - want)
    return float((dv / tol).max()), float(dv.max())


@torch.no_grad()
def hold_at_path_batches(model, obs, live, population, cloud, dev) -> dict:
    """Each kernel of the evidence paths against its plain version on rows
    a path scored, in calls of the path's own batch (fresh wrappers: these
    launches count for no path): K2 at bf16x3 on nested's final live set
    in calls of ``NESTED_BATCH`` rows and on SMC's final population in
    calls of its half-moves' and its independence moves' rows, K2 at fp32
    on Laplace's IS cloud in calls of ``LAPLACE_IS`` rows, the fp32 K3 on
    the cloud's first 4096 rows (the ascent's batch), value and gradient.
    Returns the worst |Δ|/tol and the largest |Δ logL| by case."""
    report = {}
    for label, tier, rows, batch in (
        ("k2_bf16x3_nested", "high", live, NESTED_BATCH),
        ("k2_bf16x3_smc_half", "high", population, SMC_PARTICLES // 2),
        ("k2_bf16x3_smc", "high", population, SMC_PARTICLES),
        ("k2_f32_laplace_is", "highest", cloud, LAPLACE_IS),
    ):
        pairs, half_c = value_kernels(model, obs, tier, dev)
        kernel, plain = pairs["k2"]
        worst = max_abs = 0.0
        for x in torch.as_tensor(rows, dtype=torch.float32, device=dev).split(batch):
            w, m = value_worst(kernel(x).cpu().numpy(), plain(x).cpu().numpy(), tier, half_c)
            worst, max_abs = max(worst, w), max(max_abs, m)
        check(worst <= 1.0, f"{label}: K2 vs plain, worst |Δ|/tol {worst:.3g}")
        report[label] = {"rows": int(rows.shape[0]), "batch": batch, "worst_over_tol": worst,
                         "max_abs": max_abs}
    k3 = k3_wrapper(model, obs, EXACT_TIERS, dev)
    x = torch.as_tensor(cloud[:4096], dtype=torch.float32, device=dev)
    vk, gk = k3(model.params, x)
    vp, gp = loglik_grad_gram_reference(k3.operands(model.params), x)
    vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
    worst, max_abs = value_worst(vk, vp, "highest", 0.5 * abs(float(k3.operands(model.params).c)))
    q999 = float(np.quantile(grad_rel_error(gk, gp), 0.999))
    check(worst <= 1.0 and grad_gate_violation(gk, gp) <= 0.0 and q999 <= GRAD_Q999_F32,
          f"k3_f32_laplace: worst |Δ|/tol {worst:.3g}, gradient q99.9 {q999:.3g}")
    report["k3_f32_laplace_ascent"] = {"rows": 4096, "worst_over_tol": worst, "max_abs": max_abs,
                                       "grad_q999_rel": q999}
    return report


def evidence_path(model, obs, witness, dev):
    """Phase 15: ``log_evidence`` by nested sampling, SMC, Laplace and the
    ladder at the JAX defaults, each run with every evidence wrapper's
    count set to 0 just before it and read just after (the launches each
    method must make follow from its sizes). Nested's, SMC's and
    Laplace's log Z must lie within max(1, 4σ) nats of the witness's
    (σ: the two standard errors combined); nested must finish before
    ``max_iters``, Laplace's Hessian be negative-definite. The ladder is
    printed, not gated: the JAX package documents its bias at the default
    budget (``tpu21cmvae/sampling/evidence.py:238-241``). Returns the
    launches by method and wrapper, and each method's log Z."""
    wrappers = evidence_wrappers(model, obs)
    check(wrappers["k2"].fused.tensor_cores and not wrappers["k2_f32"].fused.tensor_cores,
          "evidence: K2 at bf16x3 on fused_gram_mma.cu, at fp32 on fused_loglik_gram.cu")
    check(wrappers["k3_f32"].register_tiled and wrappers["k3"].tensor_cores,
          "evidence: K3 at fp32 on fused_loglik_grad_gram_f32.cu, (high, default) on "
          "fused_gram_mma.cu")
    w_logz, w_err = witness["logz_flat"], witness["logz_flat_err"]
    out, launches, results = {"witness": {"logz": w_logz, "logz_err": w_err}}, {}, {}
    for method in ("nested", "smc", "laplace", "ladder"):
        for w in wrappers.values():
            w.launches = 0
        res, wall = timed(lambda: model.log_evidence(obs, NOISE_VAR, method=method, seed=0))
        n = launches[method] = {name: w.launches for name, w in wrappers.items()}
        check(all(evidence_wrappers(model, obs)[k] is w for k, w in wrappers.items()),
              f"{method}: log_evidence used the memoized wrappers")
        results[method] = res
        gap = res.logz - w_logz
        out[method] = {"wall_s": wall, "logz": res.logz, "logz_err": res.logz_err,
                       "minus_witness": gap, "launches": n}
        want = {name: 0 for name in wrappers}
        if method == "nested":
            want["k2"] = 1 + NESTED_MH * (res.n_iters // NESTED_BATCH)
            out[method].update(n_iters=res.n_iters, n_like=res.n_like, h=res.h, ess=res.ess,
                               truncated=res.truncated, accept=res.accept_rate)
        elif method == "smc":
            want["k2"] = n["k2"]
            check(1 + 3 * SMC_MH * res.n_stages <= n["k2"] <= 1 + 12 * SMC_MH * res.n_stages,
                  f"smc: K2 launches {n['k2']} for {res.n_stages} stages")
            out[method].update(n_stages=res.n_stages,
                               accept=float(np.mean(res.accept_rate)),
                               share_fx_below_split=float(np.mean(res.final[:, 2]
                                                                  < WITNESS_FX_SPLIT)))
        elif method == "laplace":
            want.update(k3_f32=LAPLACE_STEPS + 1, k2_f32=LAPLACE_ROUNDS)
            out[method].update(logz_laplace=res.logz_laplace, khat=res.khat, is_ess=res.is_ess,
                               pd=res.pd, map_logp=res.map_logp, map=res.map_params.tolist())
        else:
            want.update(k3=LADDER_FIT_STEPS + 1, k2=1 + 2 * (LADDER_WARMUP + LADDER_STEPS))
            out[method].update(ladder_drift=res.ladder_drift,
                               swap_rate_min=float(res.swap_rate.min()),
                               accept_min=float(res.accept_rate.min()))
        check(n == want, f"{method}: launches {n} != {want}")
        if method != "ladder":
            sigma = math.hypot(res.logz_err, w_err)
            tol = max(EVIDENCE_GATE_NATS, EVIDENCE_GATE_SIGMAS * sigma)
            out[method]["gate_nats"] = tol
            check(bool(np.isfinite(res.logz)) and abs(gap) <= tol,
                  f"{method}: log Z {res.logz:.3f} is {gap:+.3f} from the witness's "
                  f"{w_logz:.3f} (tolerance {tol:.3f})")
    check(not results["nested"].truncated, "nested: truncated at max_iters")
    check(results["laplace"].pd, "laplace: Hessian not negative-definite at the mode")
    # the bf16x3 tier's bias on nested's final live set: its logL (K2 at
    # bf16x3) against the plain exact tier on the same points
    nested = results["nested"]
    live = nested.samples[-NESTED_LIVE:]
    exact = scores(exact_loglik(model, obs), model, live, dev).astype(np.float64)
    out["nested"]["live_max_abs_dlogl_bf16x3_vs_exact"] = float(
        np.abs(nested.logl[-NESTED_LIVE:] - exact).max())
    out["held_at_path_batches"] = hold_at_path_batches(
        model, obs, live, results["smc"].final, results["laplace"]._is_x, dev)
    print("phase 15: " + json.dumps(out), flush=True)
    return launches, {method: float(res.logz) for method, res in results.items()}


def tempered_samplers(model, obs, witness, dev):
    """Phase 16: ``sample_posterior(sampler="pt")`` (``PT_SIZES``) and
    ``sampler="smc"`` (the defaults, another seed than phase 15's), each
    on the memoized K2 wrapper with its count set to 0 just before: PT
    makes one launch for the start and two per step; finite draws, every
    ladder edge exchanging. Each one's share of draws with fx below
    ``WITNESS_FX_SPLIT`` is printed beside the witness's mass there.
    Returns the launches by sampler."""
    k2 = model.loglik_fn(obs, NOISE_VAR, backend="kernel")
    out = {"witness_mass_fx_below_split": witness["flat"]["mass_fx_below_split"]}
    launches = {}
    for sampler, kw in (("pt", PT_SIZES), ("smc", dict(seed=1))):
        k2.launches = 0
        res, wall = timed(lambda: model.sample_posterior(obs, NOISE_VAR, sampler=sampler, **kw))
        n = launches[sampler] = k2.launches
        check(model.loglik_fn(obs, NOISE_VAR, backend="kernel") is k2,
              f"{sampler}: sample_posterior used the memoized K2 wrapper")
        flat = res.flat
        check(bool(np.isfinite(flat).all() and np.isfinite(res.logp).all()),
              f"{sampler}: finite draws")
        entry = {"wall_s": wall, "k2_launches": n, "draws": int(flat.shape[0]),
                 "share_fx_below_split": float(np.mean(flat[:, 2] < WITNESS_FX_SPLIT)),
                 "median": np.median(flat, axis=0).tolist()}
        if sampler == "pt":
            steps = kw["n_warmup"] + kw["n_steps"]
            check(n == 1 + 2 * steps, f"pt: K2 launches {n} != {1 + 2 * steps}")
            check(res.chain.shape == (kw["n_steps"] // kw["thin"], kw["n_walkers"], 7),
                  f"pt: chain shape {res.chain.shape}")
            check(bool((res.swap_rate > 0).all()), f"pt: an edge never swapped {res.swap_rate}")
            entry.update(swap_rate=res.swap_rate.tolist(), accept=float(np.mean(res.accept_rate)),
                         rhat_max=float(res.rhat().max()))
        else:
            check(res.final.shape == (SMC_PARTICLES, 7), f"smc: population {res.final.shape}")
            check(1 + 3 * SMC_MH * res.n_stages <= n <= 1 + 12 * SMC_MH * res.n_stages,
                  f"smc: K2 launches {n} for {res.n_stages} stages")
            entry.update(logz=res.logz, logz_err=res.logz_err, n_stages=res.n_stages)
        out[sampler] = entry
    print("phase 16: " + json.dumps(out), flush=True)
    return launches


def kink_margin(ops, x) -> np.ndarray:
    """Per row, the smallest |pre-activation| of any hidden unit of the
    plain forward at ``ops``' value tier, over the mean |pre-activation|
    of its layer: near 0 the ReLU's gradient is set-valued (a kink row),
    and two summation orders may land on either side."""
    z = fused_skinny_dense(_log_clamp(x), ops.w0, ops.b0)
    margins = []
    for w, b in (*zip(ops.w, ops.b), (None, None)):
        margins.append((z.abs() / z.abs().mean(1, keepdim=True)).min(1).values)
        if w is not None:
            z = tier_matmul(torch.relu(z), w, ops.tier) + b
    return torch.stack(margins).min(0).values.cpu().numpy()


@torch.no_grad()
def hold_variational_batches(model, obs, advi_rows, flow_rows, is_rows, dev) -> dict:
    """Phase 17's kernels against their plain versions, fresh wrappers
    (these launches count for no path): K3 at (high, default) on
    ``HELD_DRAWS`` draws of the fitted ADVI Gaussian in calls of its 512
    rows and of the fitted flow in calls of its 256 (the distributions the
    fits' last steps scored), value and gradient, the gate over all the
    draws; the fp32 K2 on the importance sweep's own rows in one call of
    16,384. Each pair is then timed at that batch (``time_pair``).
    Returns worst |Δ|/tol, largest |Δ logL|, gradient q99.9, the worst
    gradient row's error and kink margin (:func:`kink_margin`) beside the
    rows' median margin, and the times, by case."""
    report = {}
    trunk = model.config.mlp().sizes[:-1]
    k3 = k3_wrapper(model, obs, MAIN_TIERS, dev)
    ops = k3.operands(model.params)
    half_c = 0.5 * abs(float(ops.c))
    for label, rows, batch in (("k3_high_default_advi", advi_rows, ADVI_MC),
                               ("k3_high_default_flow", flow_rows, FLOW_MC)):
        x = torch.as_tensor(rows, dtype=torch.float32, device=dev)
        calls = [(k3(model.params, q), loglik_grad_gram_reference(ops, q)) for q in x.split(batch)]
        vk, gk, vp, gp = (torch.cat([c[i][j] for c in calls]).cpu().numpy()
                          for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)))
        x = x[:batch]
        worst, max_abs = value_worst(vk, vp, MAIN_TIERS[0], half_c)
        rel = grad_rel_error(gk, gp)
        q999 = float(np.quantile(rel, 0.999))
        margin = kink_margin(ops, torch.as_tensor(rows, dtype=torch.float32, device=dev))
        check(worst <= 1.0 and grad_gate_violation(gk, gp) <= 0.0,
              f"{label}: worst |Δ|/tol {worst:.3g}, gradient gate "
              f"{grad_gate_violation(gk, gp):.3g}")
        report[label] = {"rows": int(x.shape[0]), "held_rows": int(vk.shape[0]),
                         "worst_over_tol": worst, "max_abs": max_abs, "grad_q999_rel": q999,
                         "grad_max_rel": float(rel.max()),
                         "worst_row_kink_margin": float(margin[int(np.argmax(rel))]),
                         "median_kink_margin": float(np.median(margin)),
                         **time_pair(lambda q: k3(model.params, q),
                                     lambda q: loglik_grad_gram_reference(ops, q), x, 50,
                                     gram_flops(trunk, True)),
                         "bound_ms": bound("k3", trunk, int(x.shape[0]), "bf16x3", "bf16")[0]}
    pairs, half_c = value_kernels(model, obs, "highest", dev)
    kernel, plain = pairs["k2"]
    x = torch.as_tensor(is_rows, dtype=torch.float32, device=dev)
    worst, max_abs = value_worst(kernel(x).cpu().numpy(), plain(x).cpu().numpy(), "highest",
                                 half_c)
    check(worst <= 1.0, f"k2_f32_flow_is: K2 vs plain, worst |Δ|/tol {worst:.3g}")
    report["k2_f32_flow_is"] = {"rows": int(x.shape[0]), "worst_over_tol": worst,
                                "max_abs": max_abs,
                                **time_pair(kernel, plain, x, 50, gram_flops(trunk, False)),
                                "bound_ms": bound("k2", trunk, int(x.shape[0]), "f32")[0]}
    return report


def staged(stages: dict):
    """Wrap the batched evidence's stage functions where
    ``laplace_evidence_multi_auto`` looks them up, adding each call's wall
    seconds (device synchronized) to ``stages``; returns the undo."""
    import tpu21cmvae_torch.flows as flows_mod
    import tpu21cmvae_torch.nested as nested_mod
    import tpu21cmvae_torch.sampling.evidence as evidence_mod

    saved = []
    for mod, name, stage in ((evidence_mod, "laplace_evidence_multi", "laplace"),
                             (flows_mod, "evidence_with_flow_batch", "flow"),
                             (nested_mod, "nested_sampling_batch", "nested")):
        fn = getattr(mod, name)

        def wrapped(*args, _fn=fn, _stage=stage, **kwargs):
            out, wall = timed(lambda: _fn(*args, **kwargs))
            stages[_stage] = stages.get(_stage, 0.0) + wall
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return undo


def variational_path(model, obs, witness, obs_batch, dev):
    """Phase 17: ``fit_advi``, ``fit_flow`` and ``log_evidence(method="flow")``
    at the JAX defaults, every evidence wrapper's count set to 0 just
    before each and read just after (ADVI: one K3 launch at (high,
    default) per step; the flow: one per warm-start and fit step; its
    evidence one fp32 K2 launch more); the flow's log Z within max(1, 4σ)
    nats of the witness's; the kernels held to plain at the paths'
    batches; then ``log_evidence_batch(method="auto", final="nested")``
    on ``obs_batch`` with the ascent cut to ``EVIDENCE_BATCH_CUTS`` and
    ``khat_threshold=-inf``, so that every row runs every stage (at 0.7
    which rows escalate would depend on the draws): every row finite,
    each stage's wall printed. Returns the launches by path and
    wrapper."""
    wrappers = evidence_wrappers(model, obs)
    w_logz, w_err = witness["logz_flat"], witness["logz_flat_err"]
    flow_kw = dict(n_steps=FLOW_STEPS, warm_steps=FLOW_WARM, n_mc=FLOW_MC)
    runs = {
        "advi": lambda: model.fit_advi(obs, NOISE_VAR, n_steps=ADVI_STEPS, n_mc=ADVI_MC, seed=0),
        "flow_fit": lambda: model.fit_flow(obs, NOISE_VAR, seed=0, **flow_kw),
        "flow_evidence": lambda: model.log_evidence(obs, NOISE_VAR, method="flow", seed=0,
                                                    n_is=FLOW_IS, **flow_kw),
    }
    wants = {"advi": dict(k3=ADVI_STEPS), "flow_fit": dict(k3=FLOW_WARM + FLOW_STEPS),
             "flow_evidence": dict(k3=FLOW_WARM + FLOW_STEPS, k2_f32=1)}
    # the observation's fingerprint, for a CPU rerun that replays its draws
    # (scripts/compare_flow_evidence_cpu.py)
    out, launches, results = {"witness": {"logz": w_logz, "logz_err": w_err},
                              "obs_sum": float(np.sum(obs)), "obs_0": float(obs[0])}, {}, {}
    for path, run in runs.items():
        for w in wrappers.values():
            w.launches = 0
        res, wall = timed(run)
        n = launches[path] = {name: w.launches for name, w in wrappers.items()}
        check(all(evidence_wrappers(model, obs)[k] is w for k, w in wrappers.items()),
              f"{path}: the memoized wrappers")
        want = {name: 0 for name in wrappers}
        want.update(wants[path])
        check(n == want, f"{path}: launches {n} != {want}")
        results[path] = res
        elbo = res.elbo if path != "flow_evidence" else res.flow.elbo
        check(bool(np.isfinite(elbo).all()), f"{path}: finite ELBO")
        out[path] = {"wall_s": wall, "launches": n,
                     "elbo_tail_mean": float(elbo[-100:].mean()),
                     "elbo_tail_sd": float(elbo[-100:].std()),
                     "elbo_head_mean": float(elbo[:100].mean())}
    advi, flow, ev = results["advi"], results["flow_fit"], results["flow_evidence"]
    box = PAR_RANGES.astype(np.float32)
    for path, res in (("advi", advi), ("flow_fit", flow)):
        draws = res.sample(4096, seed=1)
        check(bool(np.isfinite(draws).all() and (draws >= box[:, 0]).all()
                   and (draws <= box[:, 1]).all()), f"{path}: finite draws in the box")
        out[path].update(median=np.median(draws, axis=0).tolist(),
                         share_fx_below_split=float(np.mean(draws[:, 2] < WITNESS_FX_SPLIT)))
    gap = ev.logz - w_logz
    sigma = math.hypot(ev.logz_err, w_err)
    tol = max(EVIDENCE_GATE_NATS, EVIDENCE_GATE_SIGMAS * sigma)
    out["flow_evidence"].update(
        logz=ev.logz, logz_err=ev.logz_err, minus_witness=gap, gate_nats=tol, khat=ev.khat,
        is_ess=ev.is_ess, n_draws=ev.n_draws,
        same_flow_as_fit_flow_max_abs=max(
            float(np.abs(a - b).max()) for a, b in zip(
                [ev.flow.theta["mu"], ev.flow.theta["a"]] +
                [layer["w2"] for layer in ev.flow.theta["layers"]],
                [flow.theta["mu"], flow.theta["a"]] +
                [layer["w2"] for layer in flow.theta["layers"]])))
    check(bool(np.isfinite(ev.logz)) and abs(gap) <= tol,
          f"flow: log Z {ev.logz:.3f} is {gap:+.3f} from the witness's {w_logz:.3f} "
          f"(tolerance {tol:.3f})")
    out["held_at_path_batches"] = hold_variational_batches(
        model, obs, advi.sample(HELD_DRAWS, seed=2), flow.sample(HELD_DRAWS, seed=2), ev._x, dev)
    print("phase 17: " + json.dumps(out), flush=True)

    stages = {}
    undo = staged(stages)
    try:
        batch, wall = timed(lambda: model.log_evidence_batch(
            obs_batch, NOISE_VAR, method="auto", khat_threshold=-math.inf, final="nested",
            seed=0, **EVIDENCE_BATCH_CUTS))
    finally:
        undo()
    rows = []
    for r in batch:
        fr, fe = r.final_result, r.escalation
        check(fr is not None and fe is not None, "evidence batch: every row ran every stage")
        check(bool(np.isfinite(r.logz) and np.isfinite(fe.logz) and np.isfinite(fr.logz)),
              f"evidence batch: finite log Z {r.logz}, flow {fe.logz}, nested {fr.logz}")
        rows.append({"method_used": r.method_used, "logz": r.logz, "logz_err": r.logz_err,
                     "logz_laplace": r.logz_laplace, "pd": r.pd, "flow_logz": fe.logz,
                     "flow_logz_err": fe.logz_err, "flow_khat": fe.khat,
                     "flow_is_ess": fe.is_ess, "nested_logz": fr.logz,
                     "nested_logz_err": fr.logz_err, "nested_iters": fr.n_iters,
                     "nested_truncated": fr.truncated})
    print("phase 17: evidence batch " + json.dumps({
        "n_obs": len(batch), "wall_s": wall, "stage_wall_s": stages,
        "cuts": {**EVIDENCE_BATCH_CUTS, "khat_threshold": "-inf"},
        "rows": rows}), flush=True)
    return launches


def trained_wrappers(model, obs, memo: bool = True) -> dict:
    """Phase 18's likelihood wrappers on ``obs`` at σ² = 25, memoized on
    the model unless ``memo=False``: K1 as the contract-tier direct
    likelihood (``fused_mlp.cu``), K2 at bf16x3 and K3 at (high, default)
    (``fused_gram_mma.cu``)."""
    return {
        "k1": model.loglik_fn(obs, NOISE_VAR, method="direct", precision="contract",
                              backend="kernel", memo=memo),
        "k2": model.loglik_fn(obs, NOISE_VAR, backend="kernel", memo=memo),
        "k3": model.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel",
                                       grad_precision=MAIN_TIERS[1], memo=memo),
    }


def outputs(fn, model, x) -> tuple:
    """A wrapper's outputs on rows ``x`` as a tuple of tensors, no graph."""
    with torch.no_grad():
        out = fn(model.params, x)
    return out if isinstance(out, tuple) else (out,)


@torch.no_grad()
def trained_kernels_vs_plain(model, memo, obs, rng) -> dict:
    """Phase 18 step 7: the wrappers memoized before training, called
    again without a rebuild, against fresh ``memo=False`` wrappers (bit
    for bit: a stale packed operand would differ) and against the plain
    versions on operands folded from the trained weights (values within
    ``VALUE_RTOL``, K3's gradient under ``bench_mcmc.py``'s gate), at the
    batches of phases 6 and 3. Returns the report by kernel."""
    fresh = trained_wrappers(model, obs, memo=False)
    params = model.params
    half_c = 0.5 * abs(float(fresh["k2"].fused.operands(params).c))
    plain = {
        "k1": lambda x: (-0.5 * fused_mlp_reference(fresh["k1"].fused.mlp.operands(params), x),),
        "k2": lambda x: (loglik_gram_reference(fresh["k2"].fused.operands(params), x),),
        "k3": lambda x: loglik_grad_gram_reference(fresh["k3"].operands(params), x),
    }
    tiers = {"k1": "highest", "k2": MAIN_TIERS[0], "k3": MAIN_TIERS[0]}
    report = {}
    for key, sizes in TRAINED_BATCHES.items():
        entry = {"worst_over_tol": 0.0, "max_abs": 0.0}
        for n, x in held_batches(sizes, rng):
            got, same, want = outputs(memo[key], model, x), outputs(fresh[key], model, x), plain[key](x)
            check(all(torch.equal(a, b) for a, b in zip(got, same)),
                  f"{key} memoized before training != a fresh wrapper, n={n}")
            got, want = [t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want]
            check(bool(all(np.isfinite(a).all() for a in got)), f"{key} finite, n={n}")
            worst, max_abs = value_worst(got[0], want[0], tiers[key], half_c)
            check(worst <= 1.0, f"{key} on the trained weights vs plain, n={n}: "
                                f"worst |Δ|/tol {worst:.3g}")
            entry["worst_over_tol"] = max(entry["worst_over_tol"], worst)
            entry["max_abs"] = max(entry["max_abs"], max_abs)
            if key == "k3":
                gate = grad_gate_violation(got[1], want[1])
                check(gate <= 0.0, f"k3 gradient gate on the trained weights, n={n}: {gate:.3g}")
                entry["grad_q999_rel"] = max(entry.get("grad_q999_rel", 0.0),
                                             float(np.quantile(grad_rel_error(got[1], want[1]),
                                                               0.999)))
        report[key] = entry
    return report


def record_steps(model) -> list:
    """Route ``model.train``'s loss through a wrapper that keeps each
    training batch's mean loss (a device tensor, no host read) in the
    returned list; the validation passes run without grad and are not
    kept."""
    steps, base = [], model.loss_fn

    def loss_fn(precision=None):
        inner = base(precision)

        def loss(params, x, y):
            per_sample = inner(params, x, y)
            if torch.is_grad_enabled():
                steps.append(per_sample.detach().mean())
            return per_sample

        return loss

    model.loss_fn = loss_fn
    return steps


def device_busy_ms(prof):
    """Summed device time of the kernels a ``torch.profiler`` run traced,
    in ms; None when it traced none."""
    total = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 if total > 0 else None


def same_history(a, b) -> bool:
    """Two histories of the same run: losses bit for bit, the epochs and
    the stop decisions equal."""
    return (a.loss == b.loss and a.val_loss == b.val_loss and a.lr == b.lr
            and (a.stopped_epoch, a.best_epoch) == (b.stopped_epoch, b.best_epoch))


def forward_rel_amp(model, raw) -> float:
    """Largest |bf16 forward − contract forward| over each row's amplitude
    (``bench.py``'s forward gate metric) on raw parameter rows."""
    x = torch.as_tensor(raw, dtype=torch.float32, device=model.device)
    ref = model.predict_fn()(model.params, x).cpu().numpy()
    got = model.predict_fn("default")(model.params, x).cpu().numpy()
    return float((np.abs(got - ref) / np.abs(ref).max(axis=1, keepdims=True)).max())


def training_phase(dev, smi) -> dict:
    """Phase 18: train the flagship (full width, random weights from seed
    0) at the reference's data scale through ``DirectEmulator.train``.
    Kernel wrappers are memoized on one observation before training; the
    card's first epochs are held to the CPU's; the recipe trains to the
    verify skill's test-error gate; the device loop and a resumed run
    equal the host loop; the wrappers built before training then hold to
    plain on the trained weights; a short tier-native fine-tune is
    printed. Returns each kernel's launches in this phase."""
    t_phase = time.perf_counter()
    data = synthetic_dataset(**TRAIN_SPLIT)
    model = DirectEmulator(data, device=dev, seed=0)
    rng = np.random.default_rng(18)
    obs = data.signal_test[0] + rng.normal(0.0, 5.0, model.config.n_bins)
    memo = trained_wrappers(model, obs)
    x0 = rows(FIT_STARTS, rng)
    before = {k: outputs(fn, model, x0)[0].cpu().numpy() for k, fn in memo.items()}
    check(all(fn.launches == 1 for fn in memo.values()), "one launch per wrapper before training")
    n_steps = -(-TRAIN_SPLIT["n_train"] // DIRECT_TRAIN_DEFAULT.batch_size)

    # the card against the CPU, from the same weights and shuffles, and
    # the CPU once more with one weight moved by one ulp
    parity = dataclasses.replace(DIRECT_TRAIN_DEFAULT, epochs=PARITY_EPOCHS)
    runs = {}
    for name, where in (("cpu", "cpu"), ("cpu_one_ulp", "cpu"), ("card", dev)):
        m = DirectEmulator(data, device=where, seed=0)
        if name == "cpu_one_ulp":
            with torch.no_grad():
                w = m.params[2]["w"].view(-1)
                w[0] = float(np.nextafter(np.float32(w[0].item()), np.float32(1.0)))
        steps = record_steps(m)
        if where == "cpu":
            m.train(train_config=parity)
        else:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                m.train(train_config=parity)
                torch.cuda.synchronize()
            busy = device_busy_ms(prof)
        runs[name] = (torch.stack(steps).cpu().numpy(),
                      np.array(m.history.loss + m.history.val_loss))
    step_gap = {k: np.abs(runs[k][0] - runs["cpu"][0]) / runs["cpu"][0]
                for k in ("card", "cpu_one_ulp")}
    epoch_gap = {k: float(np.max(np.abs(runs[k][1] - runs["cpu"][1]) / runs["cpu"][1]))
                 for k in ("card", "cpu_one_ulp")}
    tight = float(step_gap["card"][:PARITY_TIGHT_STEPS].max())
    check(runs["card"][0].shape == (PARITY_EPOCHS * n_steps,), "one loss per training step")
    check(tight <= TRAIN_LOSS_RTOL,
          f"card vs CPU, first {PARITY_TIGHT_STEPS} steps' losses: {tight:.3g} > {TRAIN_LOSS_RTOL}")
    check(epoch_gap["card"] <= PARITY_EPOCH_RTOL,
          f"card vs CPU per-epoch losses: {epoch_gap['card']:.3g} > {PARITY_EPOCH_RTOL}")

    # the recipe
    cfg = dataclasses.replace(DIRECT_TRAIN_DEFAULT, epochs=TRAIN_EPOCHS)
    _, train_s = timed(lambda: model.train(train_config=cfg))
    h = model.history
    check(bool(np.isfinite(h.loss + h.val_loss).all()), "finite training losses")
    check(h.val_loss[-1] < h.val_loss[0], f"val loss {h.val_loss[0]:.4g} → {h.val_loss[-1]:.4g}")
    test_err = model.test_error()
    check(float(test_err.mean()) < TEST_ERROR_GATE,
          f"mean test error {float(test_err.mean()):.3f} % ≥ {TEST_ERROR_GATE} %")
    epoch_s = float(np.median(h.epoch_time_s))

    # the device loop: the scan's float32 rate equals the host's float64
    # one rounded until a fifth plateau step; past it, JAX's own
    # fit-against-scan bound (1e-6)
    loop = DirectEmulator(data, device=dev, seed=0)
    _, loop_s = timed(lambda: loop.train(train_config=cfg, device_loop=True))
    hd = loop.history
    same_lr = [float(np.float32(a)) for a in h.lr] == hd.lr
    loop_gap = float(np.max(np.abs(np.array(hd.loss + hd.val_loss) - np.array(h.loss + h.val_loss))
                            / np.array(h.loss + h.val_loss)))
    check((hd.stopped_epoch, hd.best_epoch) == (h.stopped_epoch, h.best_epoch)
          and loop_gap <= (0.0 if same_lr else 1e-6),
          f"device loop vs host loop: {loop_gap:.3g} (rates equal: {same_lr})")

    # resume: half the epochs, a restart from the checkpoint, the rest
    with tempfile.TemporaryDirectory() as ckpt:
        first = DirectEmulator(data, device=dev, seed=0)
        first.train(epochs=TRAIN_EPOCHS // 2, train_config=cfg, checkpoint_dir=ckpt)
        resumed = DirectEmulator(data, device=dev, seed=0)
        resumed.train(train_config=cfg, checkpoint_dir=ckpt, resume=True)
        check(same_history(resumed.history, h), "resumed run != uninterrupted run")
        reloaded = DirectEmulator.from_checkpoint(resumed.save(os.path.join(ckpt, "m.npz")),
                                                  device=dev)
    pred = model.predict(data.par_test)
    check(np.array_equal(reloaded.predict(data.par_test), pred)
          and np.array_equal(resumed.predict(data.par_test), pred),
          "reloaded and resumed predictions != the uninterrupted model's")

    # the kernels on the trained weights, through the wrappers built before
    check(all(trained_wrappers(model, obs)[k] is fn for k, fn in memo.items()),
          "the memoized wrappers survive training")
    moved = {k: float(np.abs(outputs(fn, model, x0)[0].cpu().numpy() - before[k]).max())
             for k, fn in memo.items()}
    check(all(v > 0.0 for v in moved.values()), f"training moved every wrapper's value: {moved}")
    held = trained_kernels_vs_plain(model, memo, obs, rng)
    launches = {k: fn.launches for k, fn in memo.items()}
    check(all(launches[k] == 3 + len(sizes) for k, sizes in TRAINED_BATCHES.items()),
          f"launches of the memoized wrappers {launches}")

    # a short tier-native fine-tune of the resumed copy (printed, not gated)
    bf16_before = forward_rel_amp(resumed, data.par_test)
    tune = dataclasses.replace(DIRECT_TRAIN_DEFAULT, epochs=FINETUNE_EPOCHS)
    resumed.train(train_config=tune, loss_precision="default")
    x_test = torch.as_tensor(data.par_test, dtype=torch.float32, device=dev)
    native = resumed.predict_fn("default")(resumed.params, x_test).cpu().numpy()

    out = {
        "card": smi, "rows": TRAIN_SPLIT, "steps_per_epoch": n_steps,
        "parity": {"first_steps_rel_gap": tight,
                   "step_rel_gap": {k: {i: float(v[i]) for i in (0, 10, 20, 30, 50, 105, 211)
                                        if i < v.shape[0]} for k, v in step_gap.items()},
                   "epoch_rel_gap": epoch_gap,
                   "losses": {k: v[1].tolist() for k, v in runs.items()}},
        "loss": h.loss, "val_loss": h.val_loss, "lr": h.lr,
        "stopped_epoch": h.stopped_epoch, "best_epoch": h.best_epoch,
        "test_error_mean_pct": float(test_err.mean()),
        "test_error_median_pct": float(np.median(test_err)),
        "train_wall_s": train_s, "s_per_epoch": epoch_s, "steps_per_s": n_steps / epoch_s,
        "device_busy_ms_per_epoch": None if busy is None else busy / PARITY_EPOCHS,
        "host_share": None if busy is None else 1.0 - busy / PARITY_EPOCHS / (1e3 * epoch_s),
        "device_loop_wall_s": loop_s, "device_loop_rel_gap": loop_gap,
        "device_loop_rates_equal": same_lr,
        "wrapper_value_moved": moved, "trained_vs_plain": held, "launches_trained": launches,
        "finetune_default": {"loss": resumed.history.loss, "val_loss": resumed.history.val_loss,
                             "bf16_rel_amp_trained": bf16_before,
                             "bf16_rel_amp_tuned": forward_rel_amp(resumed, data.par_test),
                             "test_error_mean_pct_at_bf16": float(
                                 error(data.signal_test, native).mean())},
        "phase_wall_s": time.perf_counter() - t_phase,
    }
    print("phase 18: " + json.dumps(out), flush=True)
    return launches, data


@contextlib.contextmanager
def recorded_steps():
    """Keep each training batch's mean loss (a device tensor, no host
    read) in the yielded list while the block runs, by wrapping the
    training loop's step."""
    from tpu21cmvae_torch.train import loop

    steps, base = [], loop._train_step

    def step(*args, **kwargs):
        loss, state = base(*args, **kwargs)
        steps.append(loss)
        return loss, state

    loop._train_step = step
    try:
        yield steps
    finally:
        loop._train_step = base


def ensemble_wrappers(ens, obs, keys=None) -> dict:
    """The ensemble's memoized kernel mixtures on ``obs`` at σ² = 25, one
    per route of ``keys`` (default: the routes of :data:`ENS_ROUTES` the
    shipped ensemble runs): each one member-batched wrapper, one launch
    per call. Its entry points run K1 as the contract-tier direct
    likelihood, K2 at bf16x3 (MH), K3 at (high, default) (HMC) and the
    fp32 K2 (the gram form at the contract tier); K1 at bf16x3, the fp32
    K3 and the mixed and reverse K3 pairs are built the same way."""
    keys = keys or [k for k in ENS_ROUTES if k not in WIDE_ENS_KEYS]
    return {key: (ens.loglik_and_grad_fn if key.startswith("k3") else ens.loglik_fn)(
        obs, NOISE_VAR, backend="kernel", **ENS_ROUTES[key][0]) for key in keys}


def batched_wrapper(mix):
    """The member-batched kernel wrapper under a kernel mixture: K3's
    wrapper, or K1's and K2's under their autograd shell."""
    return getattr(mix.members, "fused", mix.members)


def ensemble_half_c(ens, wrappers, key="k2_f32") -> float:
    """The largest member's gram cancellation scale c/2 (phase 6's), read
    from the stacked operands of the mixture of route ``key`` (``c`` is
    (M, 1))."""
    ops = batched_wrapper(wrappers[key]).operands(ens.params)
    return 0.5 * float(ops.c.abs().max())


@torch.no_grad()
def mixture_vs_plain(ens, obs, wrappers, rng, c_key="k2_f32") -> dict:
    """The ensemble's kernel mixtures against the same mixtures over the
    plain versions at ``MIXTURE_ROWS``: values within the member bound
    (logsumexp is 1-Lipschitz in the max norm), K3's gradient under
    ``bench_mcmc.py``'s gate (the fp32 pair also under its q99.9 bound).
    Returns the report by route and c/2 (:func:`ensemble_half_c` of
    ``c_key``)."""
    half_c = ensemble_half_c(ens, wrappers, c_key)
    report = {}
    for key, fn in wrappers.items():
        kw, _, tiers = ENS_ROUTES[key]
        plain = (ens.loglik_and_grad_fn if key.startswith("k3") else ens.loglik_fn)(
            obs, NOISE_VAR, **kw)
        entry = {"worst_over_tol": 0.0, "max_abs": 0.0}
        for n in MIXTURE_ROWS:
            x = rows(n, rng)
            got, want = outputs(fn, ens, x), outputs(plain, ens, x)
            got, want = [t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want]
            check(bool(all(np.isfinite(a).all() for a in got)), f"ensemble {key} finite, n={n}")
            worst, max_abs = value_worst(got[0], want[0], tiers[0], half_c)
            check(worst <= 1.0, f"ensemble {key} vs plain, n={n}: worst |Δ|/tol {worst:.3g}")
            entry["worst_over_tol"] = max(entry["worst_over_tol"], worst)
            entry["max_abs"] = max(entry["max_abs"], max_abs)
            if key.startswith("k3"):
                gate = grad_gate_violation(got[1], want[1])
                check(gate <= 0.0, f"ensemble {key} gradient gate, n={n}: {gate:.3g}")
                if tiers == EXACT_TIERS:
                    q999 = float(np.quantile(grad_rel_error(got[1], want[1]), 0.999))
                    check(q999 <= GRAD_Q999_F32, f"ensemble {key} gradient q99.9 {q999:.3g}")
                entry["grad_gate_violation"] = max(entry.get("grad_gate_violation", -np.inf),
                                                   gate)
        report[key] = entry
    return report, half_c


def single_wrappers(ens, obs, key, dev) -> list:
    """One single-model kernel wrapper per member at route ``key``'s
    tiers (the launches the member-batched one replaces)."""
    kw, _, (tier, grad_tier) = ENS_ROUTES[key]
    cfg, norm = ens.config, ens.normalizer
    if key.startswith("k1"):
        return [make_fused_loglik(cfg, norm, obs, NOISE_VAR, precision=tier, device=dev)
                for _ in ens.members]
    if key.startswith("k2"):
        return [make_fused_loglik_gram(cfg, norm, obs, NOISE_VAR, precision=tier, device=dev)
                for _ in ens.members]
    return [make_fused_loglik_grad_gram(cfg, norm, obs, NOISE_VAR, precision=tier,
                                        grad_precision=grad_tier, device=dev)
            for _ in ens.members]


def members_plain(key, batched, ops, x):
    """The member-batched plain version of route ``key`` on stacked
    ``ops``: ``(values (M, B),)`` or ``(values, gradients (M, B, 7))``."""
    if key.startswith("k1"):
        return (-0.5 * fused_mlp_members_reference(ops, x) + batched.log_norm,)
    if key.startswith("k2"):
        return (loglik_gram_members_reference(ops, x),)
    return loglik_grad_gram_members_reference(ops, x)


@torch.no_grad()
def member_batched_vs_single(ens, obs, wrappers, half_c, rng, dev) -> dict:
    """Phase 19 (a), (b), (d): every route's member-batched launch (M =
    3) against the three members' single-model launches, bit for bit
    (``torch.equal``), at ``MEMBER_ROWS``; against its member-batched
    plain version within the route's tolerance there; and timed, one
    member-batched launch beside three single ones, at
    ``MEMBER_TIMING_ROWS``, with the bound of three members' work.
    Returns the report by route."""
    views = ens.member_params(ens.params)
    sizes = ens.config.mlp().sizes
    report = {}
    for key, mix in wrappers.items():
        _, source, (tier, grad_tier) = ENS_ROUTES[key]
        batched = batched_wrapper(mix)
        check(batched.members == 3, f"ensemble {key}: {batched.members} members")
        singles = single_wrappers(ens, obs, key, dev)
        ops = (batched.mlp if key.startswith("k1") else batched).operands(ens.params)
        entry = {"source": source, "worst_over_tol": 0.0, "max_abs": 0.0}
        for n in MEMBER_ROWS:
            x = rows(n, rng)
            got = outputs(batched, ens, x)
            want = [f(p, x) for f, p in zip(singles, views)]
            want = [w if isinstance(w, tuple) else (w,) for w in want]
            for part, g in enumerate(got):
                check(g.shape[0] == 3, f"ensemble {key}: shape {tuple(g.shape)}")
                for m in range(3):
                    check(torch.equal(g[m], want[m][part]),
                          f"ensemble {key}, n={n}, member {m}, output {part}: "
                          "member-batched != single launch")
            plain = [t.cpu().numpy() for t in members_plain(key, batched, ops, x)]
            got = [t.cpu().numpy() for t in got]
            worst, max_abs = value_worst(got[0], plain[0], tier, half_c)
            check(worst <= 1.0, f"ensemble {key} member-batched vs plain, n={n}: {worst:.3g}")
            if len(got) > 1:
                for m in range(3):
                    gate = grad_gate_violation(got[1][m], plain[1][m])
                    check(gate <= 0.0, f"ensemble {key} member {m} gradient gate, n={n}")
            entry["worst_over_tol"] = max(entry["worst_over_tol"], worst)
            entry["max_abs"] = max(entry["max_abs"], max_abs)
        kernel = key[:2]
        widths = sizes if kernel == "k1" else sizes[:-1]
        timing = {}
        for n in MEMBER_TIMING_ROWS:
            x = rows(n, rng)

            def one():
                return batched(ens.params, x)

            def three():
                return [f(p, x) for f, p in zip(singles, views)]

            b = bound(kernel, widths, n, BOUND_TIER[tier], BOUND_TIER.get(grad_tier))
            timing[str(n)] = {
                "kernel_ms": time_ms(one, 20), "kernel_stream_ms": stream_ms(one, 20),
                "single3_ms": time_ms(three, 20), "single3_stream_ms": stream_ms(three, 20),
                "plain_ms": time_ms(lambda: members_plain(key, batched, ops, x), 5),
                "bound_ms": 3 * b[0], "bound_by": b[1],
            }
        entry["timing"] = timing
        check(mix.folds == 1, f"ensemble {key}: {mix.folds} folds of the stacked operands")
        report[key] = entry
    return report


def wide_ensemble(normalizer, rng, dev):
    """Phase 19: three members of hidden ``WIDE_HIDDEN``, randomly
    initialised from ``WIDE_SEED`` + 1, + 2, + 3 with ``normalizer``, and
    an observation: member 0's prediction of a prior draw from ``rng``
    with noise of σ = 5 from ``rng``."""
    config = DirectEmulatorConfig(hidden_dims=WIDE_HIDDEN)
    ens = DeepEnsemble([DirectEmulator(config=config, normalizer=normalizer,
                                       seed=WIDE_SEED + 1 + i, device=dev) for i in range(3)])
    obs = ens.members[0].predict(synthetic_params(1, rng)[0]) + rng.normal(0.0, 5.0, config.n_bins)
    return ens, obs


def wide_ensemble_routes(normalizer, dev):
    """Phase 19: the routes of :data:`WIDE_ENS_KEYS` on
    :func:`wide_ensemble`, whose mixtures run ``fused_loglik_grad_gram.cu``
    member-batched: each mixture held to plain (:func:`mixture_vs_plain`;
    its count set to 0 just before and read just after, one launch per
    call), then its member-batched launch against the three members'
    single launches and its member-batched plain version
    (:func:`member_batched_vs_single`). Returns the report and the
    launches by route."""
    rng = np.random.default_rng(194)
    ens, obs = wide_ensemble(normalizer, rng, dev)
    wrappers = ensemble_wrappers(ens, obs, WIDE_ENS_KEYS)
    for key, mix in wrappers.items():
        fn = batched_wrapper(mix)
        check(fn.wide and not (fn.reverse or fn.register_tiled or fn.tensor_cores or fn.mixed),
              f"ensemble {key} on hidden {WIDE_HIDDEN} routes to fused_loglik_grad_gram.cu")
        mix.launches = 0
    held, half_c = mixture_vs_plain(ens, obs, wrappers, rng, c_key=WIDE_ENS_KEYS[0])
    launches = {key: mix.launches for key, mix in wrappers.items()}
    check(all(n == len(MIXTURE_ROWS) for n in launches.values()),
          f"wide ensemble launches {launches}")
    for key, entry in member_batched_vs_single(ens, obs, wrappers, half_c, rng, dev).items():
        held[key]["member_batched"] = entry
    return held, launches


class PerMemberMixture:
    """The ensemble's mixture as it ran before the member axis, kept here
    as a reference and nowhere else: one single-model kernel likelihood
    per member, each on its views of the stacked weights, M launches per
    call, the logsumexp (and the softmax-weighted gradient) as the
    library's mixture forms them."""

    def __init__(self, fns, views, grad: bool):
        self.fns, self.views, self.grad = fns, views, grad
        self._log_m = math.log(len(fns))

    def __call__(self, stacked, raw):
        out = [f(p, raw) for f, p in zip(self.fns, self.views(stacked))]
        if not self.grad:
            return torch.logsumexp(torch.stack(out), dim=0) - self._log_m
        lm = torch.stack([o[0] for o in out])
        gm = torch.stack([o[1] for o in out])
        w = torch.softmax(lm, dim=0)
        return torch.logsumexp(lm, dim=0) - self._log_m, torch.sum(w[..., None] * gm, dim=0)


def per_member_mixture(ens, obs, sampler) -> PerMemberMixture:
    """The reference mixture of ``sampler``'s likelihood: K3 at (high,
    default) per member for HMC, K2 at bf16x3 per member for MH."""
    if sampler == "hmc":
        fns = [make_loglik_and_grad(ens.config, ens.normalizer, obs, NOISE_VAR,
                                    backend="kernel", grad_precision=MAIN_TIERS[1])
               for _ in ens.members]
    else:
        fns = [make_loglik(ens.config, ens.normalizer, obs, NOISE_VAR, backend="kernel",
                           method="gram")
               for _ in ens.members]
    return PerMemberMixture(fns, ens.member_params, grad=sampler == "hmc")


def family_sampler_checks(name, res, sizes, ll_draws, ll_truth, sampler) -> dict:
    """The checks every phase-19 chain passes: its shape, finite draws,
    and the truth typical — under HMC its likelihood rank among the draws
    inside [0.001, 0.999] (phase 5's gate), under MH the best draw at
    least as likely as the truth less 5 nats (phase 8's: random-walk MH
    leaves a share of the walkers far from the mode at these lengths)."""
    thin = 5 if sampler == "hmc" else 10
    shape = (sizes["n_steps"] // thin, sizes["n_walkers"], 7)
    check(res.chain.shape == shape, f"{name} {sampler}: chain shape {res.chain.shape}")
    check(bool(np.isfinite(res.chain).all() and np.isfinite(res.logp).all()
               and np.isfinite(ll_draws).all()), f"{name} {sampler}: finite draws")
    share = float(np.mean(ll_draws >= ll_truth))
    if sampler == "hmc":
        check(0.001 <= share <= 0.999, f"{name} hmc: likelihood rank of the truth {share:.4f}")
    else:
        check(float(ll_draws.max()) >= ll_truth - 5.0,
              f"{name} mh: best draw {float(ll_draws.max()):.2f} < logL(truth) {ll_truth:.2f} − 5")
    return {"share_at_least_truth": share, "loglik_truth": ll_truth,
            "loglik_draws_max": float(ll_draws.max()), "accept": float(np.mean(res.accept_rate)),
            "step_size": res.step_size, "rhat_max": float(res.rhat().max())}


def ensemble_main_path(ens, truth, obs, dev) -> dict:
    """The ensemble's HMC and MH through ``sample_posterior``: the launches
    exactly those of member 0 alone at the same sizes and seed (one
    member-batched launch per call), the chains bit for bit those of the
    per-member mixture (:class:`PerMemberMixture`, M launches per call) on
    the same seeds, every route's stacked operands folded once across the
    phase; the draws scored by the mixture at the contract tier through
    K1 (the direct form) and through the fp32 K2 (the gram form), held to
    each other. Returns the launches by kernel and the report."""
    single = ens.members[0]
    wrappers = ensemble_wrappers(ens, obs)
    single_fn = {"hmc": main_k3(single, obs),
                 "mh": single.loglik_fn(obs, NOISE_VAR, backend="kernel")}
    key_of = {"hmc": "k3", "mh": "k2"}
    run_of = {"hmc": sample_hmc, "mh": sample_mh}
    out, launches = {}, {"k1": 0, "k2": 0, "k3": 0, "k2_f32": 0}
    half_c = ensemble_half_c(ens, wrappers)
    for sampler, sizes in ENS_SAMPLERS.items():
        single_fn[sampler].launches = 0
        _, single_s = timed(lambda: single.sample_posterior(obs, NOISE_VAR, sampler=sampler,
                                                            **sizes))
        want = single_fn[sampler].launches
        mix = wrappers[key_of[sampler]]
        mix.launches = 0
        res, wall = timed(lambda: ens.sample_posterior(obs, NOISE_VAR, sampler=sampler, **sizes))
        got = mix.launches
        check(got == want, f"ensemble {sampler}: {got} launches != member 0's ({want})")
        launches[key_of[sampler]] += got
        ref = per_member_mixture(ens, obs, sampler)
        ref_res, ref_wall = timed(lambda: run_of[sampler](ref, ens.params, bounds=None,
                                                          device=dev, **sizes))
        same = (np.array_equal(res.chain, ref_res.chain) and np.array_equal(res.logp, ref_res.logp))
        check(same, f"ensemble {sampler}: chain != the per-member mixture's on the same seed")
        ref_launches = sum(f.launches for f in ref.fns)
        check(ref_launches == 3 * want,
              f"ensemble {sampler}: per-member mixture {ref_launches} launches != 3 × {want}")
        flat = res.flat
        wrappers["k1"].launches = wrappers["k2_f32"].launches = 0
        ll_draws = scores(wrappers["k1"], ens, flat, dev)
        ll_gram = scores(wrappers["k2_f32"], ens, flat, dev)
        ll_truth = float(scores(wrappers["k1"], ens, truth, dev)[0])
        check(wrappers["k1"].launches == 2 and wrappers["k2_f32"].launches == 1,
              f"ensemble {sampler}: scoring launches {wrappers['k1'].launches}, "
              f"{wrappers['k2_f32'].launches}")
        launches["k1"] += wrappers["k1"].launches
        launches["k2_f32"] += wrappers["k2_f32"].launches
        gram_worst, _ = value_worst(ll_gram, ll_draws, "highest", half_c)
        check(gram_worst <= 1.0, f"ensemble {sampler}: exact gram vs direct {gram_worst:.3g}")
        out[sampler] = {"wall_s": wall, "member0_wall_s": single_s, "launches": got,
                        "per_member_mixture_wall_s": ref_wall,
                        "per_member_mixture_launches": ref_launches, "same_chain": same,
                        "exact_gram_vs_direct_worst_over_tol": gram_worst,
                        **family_sampler_checks("ensemble", res, sizes, ll_draws, ll_truth,
                                                sampler)}
    folds = {k: wrappers[k].folds for k in launches}
    check(all(f == 1 for f in folds.values()), f"ensemble operand folds {folds}")
    out["folds"] = folds
    return launches, out


def family_samplers(name, model, truth, obs, dev) -> dict:
    """HMC and MH through an autoencoder-family model's ``sample_posterior``
    (plain PyTorch with autograd on the card), the draws and the truth
    scored by its likelihood."""
    loglik, out = model.loglik_fn(obs, NOISE_VAR), {}
    for sampler, sizes in FAMILY_SAMPLERS.items():
        res, wall = timed(lambda: model.sample_posterior(obs, NOISE_VAR, sampler=sampler,
                                                         **sizes))
        ll_draws = scores(loglik, model, res.flat, dev)
        ll_truth = float(scores(loglik, model, truth, dev)[0])
        out[sampler] = {"wall_s": wall, **family_sampler_checks(name, res, sizes, ll_draws,
                                                                ll_truth, sampler)}
    return out


def family_training(name, cls, config, data, dev) -> dict:
    """Three epochs of each stage from seed 0 at the shipped widths: the
    host loop (checkpointing every epoch), the device loop, and a run
    resumed from the host run's checkpoints as a run preempted inside
    stage A after its next-to-last epoch left them, equal bit for bit;
    the losses printed."""
    stage_a = {"ae": "ae_train_config", "vae": "vae_train_config"}[name]
    cfgs = {stage_a: dataclasses.replace(AE_TRAIN_DEFAULT, epochs=FAMILY_EPOCHS),
            "em_train_config": dataclasses.replace(AE_EMULATOR_TRAIN_DEFAULT,
                                                   epochs=FAMILY_EPOCHS)}
    runs, walls = {}, {}
    with tempfile.TemporaryDirectory() as ckpt:
        for run in ("host", "device"):
            m = cls(data, config=config, seed=0, device=dev)
            kw = dict(device_loop=True) if run == "device" else dict(checkpoint_dir=ckpt,
                                                                      checkpoint_every=1)
            runs[run], walls[run] = timed(lambda: (m, m.train(**cfgs, **kw)))
        os.remove(os.path.join(ckpt, f"stage_{name}", f"ckpt_{FAMILY_EPOCHS - 1:06d}.npz"))
        shutil.rmtree(os.path.join(ckpt, "stage_em"))
        m = cls(data, config=config, seed=0, device=dev)
        runs["resumed"], walls["resumed"] = timed(
            lambda: (m, m.train(**cfgs, checkpoint_dir=ckpt, resume=True)))
    host, losses = runs["host"]
    check(all(np.isfinite(v).all() for v in losses), f"{name}: finite training losses")
    for run in ("device", "resumed"):
        m, got = runs[run]
        same = got == losses and all(
            torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(m.params),
                                              torch.utils._pytree.tree_leaves(host.params)))
        check(same, f"{name}: the {run} run != the host loop")
    return {"losses": [list(v) for v in losses], "wall_s": walls,
            "test_error_mean_pct": float(host.test_error().mean())}


def vae_card_vs_cpu(config, data, dev) -> dict:
    """One epoch of the VAE's stage A from seed 0 on the card and on the
    CPU, on the same shuffles and seam normals: the first
    ``PARITY_TIGHT_STEPS`` steps' losses within ``TRAIN_LOSS_RTOL`` (phase
    18's bound and reason)."""
    cfg = dataclasses.replace(AE_TRAIN_DEFAULT, epochs=1)
    steps = {}
    for where in ("cpu", dev):
        m = VAEEmulator(data, config=config, seed=0, device=where)
        with recorded_steps() as rec:
            m.train(vae_train_config=cfg,
                    em_train_config=dataclasses.replace(AE_EMULATOR_TRAIN_DEFAULT, epochs=0))
        steps[str(where)] = torch.stack(rec).cpu().numpy()
    cpu, card = steps["cpu"], steps[str(dev)]
    gap = np.abs(card - cpu) / np.abs(cpu)
    tight = float(gap[:PARITY_TIGHT_STEPS].max())
    check(tight <= TRAIN_LOSS_RTOL, f"vae card vs CPU, first {PARITY_TIGHT_STEPS} steps: "
                                    f"{tight:.3g} > {TRAIN_LOSS_RTOL}")
    return {"first_steps_rel_gap": tight, "epoch_rel_gap_max": float(gap.max())}


def families_phase(truth, obs, data, dev, smi) -> dict:
    """Phase 19: the autoencoder and VAE emulators and the three-member
    deep ensemble from their shipped checkpoints through ``load_model`` on
    the card: predictions against a float64 NumPy forward of each file,
    the golden errors, the ensemble's kernel mixtures against plain, each
    route's member-batched launch against the members' single launches,
    its HMC and MH on phase 5's observation (the main path: one
    member-batched K3 or K2 launch per step), the AE's and VAE's samplers
    through autograd, and both families' training. Returns the
    ensemble's launches by kernel and its kernel report."""
    t_phase = time.perf_counter()
    models, walls = {}, {}
    for name, path in FAMILY_PATHS.items():
        models[name], walls[f"load_{name}"] = timed(lambda: load_model(path, data, device=dev))
    ae, vae, ens = models["ae"], models["vae"], models["ensemble"]
    check((type(ae), type(vae), type(ens)) == (AutoEncoderEmulator, VAEEmulator, DeepEnsemble)
          and len(ens.members) == 3, "load_model dispatch")

    # predictions against a float64 NumPy forward of each file
    batch = synthetic_params(4096, np.random.default_rng(19))
    batch[0, 2] = 0.0
    pred_err = {}
    for name in ("ae", "vae"):
        ref = numpy_family_forward(FAMILY_PATHS[name], batch)
        pred_err[name] = float(np.abs(models[name].predict(batch) - ref).max() / np.abs(ref).max())
    member_paths = sorted(os.path.join(FAMILY_PATHS["ensemble"], f)
                          for f in os.listdir(FAMILY_PATHS["ensemble"]))
    ref = np.mean([numpy_forward(p, batch) for p in member_paths], axis=0)
    pred_err["ensemble"] = float(np.abs(ens.predict(batch) - ref).max() / np.abs(ref).max())
    check(all(v <= 1e-5 for v in pred_err.values()), f"predict vs float64 forward {pred_err}")

    # the golden errors (tests/test_pretrained.py's bounds)
    err_ae, rec_ae = ae.test_error(), ae.test_error(use_autoencoder=True)
    err_vae, err_ens = vae.test_error(), ens.test_error()
    y_val = preproc(torch.as_tensor(np.asarray(data.signal_val, np.float32), device=dev),
                    vae.normalizer)
    with torch.no_grad():
        mu = vae.vae.encode(vae.vae.params, y_val)[0].cpu().numpy()
    active = int((mu.var(axis=0) > 0.01).sum())
    curves = vae.latent_traversal(dim=0, values=np.linspace(-2, 2, 5))
    _, std = ens.predict_with_uncertainty(data.par_test[:8])
    golden = {"ae_mean_pct": float(err_ae.mean()), "ae_reconstruction_pct": float(rec_ae.mean()),
              "vae_mean_pct": float(err_vae.mean()), "vae_median_pct": float(np.median(err_vae)),
              "vae_active_latents": active, "ensemble_mean_pct": float(err_ens.mean()),
              "ensemble_std_max": float(std.max())}
    check(err_ae.mean() < 0.25 and rec_ae.mean() < 0.20, f"AE golden errors {golden}")
    check(err_vae.mean() < 0.35 and np.median(err_vae) < 0.35
          and 2 * active >= vae.config.latent_dim
          and curves.shape == (5, 451) and bool(np.isfinite(curves).all()),
          f"VAE golden errors {golden}")
    check(err_ens.mean() < 0.25 and bool(np.isfinite(std).all()) and std.max() > 0,
          f"ensemble golden errors {golden}")

    # the ensemble: its kernel mixtures against plain, each member-batched
    # launch against the members' single launches, then the main path
    wrappers = ensemble_wrappers(ens, obs)
    (held, half_c), walls["mixture_vs_plain"] = timed(
        lambda: mixture_vs_plain(ens, obs, wrappers, np.random.default_rng(191)))
    batched, walls["member_batched"] = timed(lambda: member_batched_vs_single(
        ens, obs, wrappers, half_c, np.random.default_rng(192), dev))
    for key, entry in batched.items():
        held[key]["member_batched"] = entry
    launches, ens_paths = ensemble_main_path(ens, truth, obs, dev)
    (wide_held, wide_launches), walls["wide_ensemble"] = timed(
        lambda: wide_ensemble_routes(ens.normalizer, dev))
    held.update(wide_held)
    launches.update(wide_launches)

    # the autoencoder families: samplers through autograd, then training
    samplers = {}
    for name in ("ae", "vae"):
        samplers[name], walls[f"samplers_{name}"] = timed(
            lambda: family_samplers(name, models[name], truth, obs, dev))
    training = {}
    for name, cls, config in (("ae", AutoEncoderEmulator, ae.config),
                              ("vae", VAEEmulator, vae.config)):
        training[name], walls[f"training_{name}"] = timed(
            lambda: family_training(name, cls, config, data, dev))
    parity, walls["vae_card_vs_cpu"] = timed(lambda: vae_card_vs_cpu(vae.config, data, dev))

    out = {"card": smi, "predict_rel_err": pred_err, "golden": golden,
           "mixture_vs_plain": held, "ensemble": ens_paths, "ensemble_launches": launches,
           "samplers": samplers, "training": training, "vae_card_vs_cpu": parity,
           "wall_s": walls, "phase_wall_s": time.perf_counter() - t_phase}
    print("phase 19: " + json.dumps(out), flush=True)
    return launches, held


# -- phase 20: the HTTP service, the CLI and the artifact on the card -------


def http(server, path, payload=None, timeout=600):
    """One request to ``server`` on 127.0.0.1 (GET without ``payload``);
    the decoded JSON reply and the host-clock seconds it took."""
    import urllib.request

    host, port = server.server_address[:2]
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = json.loads(r.read())
    return body, time.perf_counter() - t0


def served_rows(n: int, seed: int) -> np.ndarray:
    """n prior draws with an fx == 0 row first, as float32 NumPy."""
    x = synthetic_params(n, np.random.default_rng(seed)).astype(np.float32)
    x[0, 2] = 0.0
    return x


def predict_rel_err(got, raw) -> float:
    ref = numpy_forward(CHECKPOINT, raw)
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


def cli(args, timeout=600) -> str:
    """``python3 -m tpu21cmvae_torch ARGS`` from the checkout's root on
    the card (the default ``--device cuda``); its standard output, the
    command's failure raising."""
    proc = subprocess.run([sys.executable, "-m", "tpu21cmvae_torch", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    check(proc.returncode == 0,
          f"CLI {args[0]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout


def serving_phase(truth, obs, box, laplace_logz, dev, smi) -> dict:
    """Phase 20: the service, the CLI and the deployment artifact on the
    card, on ``pretrained/direct_synthetic.npz`` and phase 5's
    observation (σ² = 25). ``make_server(model, port=0)`` serves from a
    daemon thread after ``warmup(up_to=4096)``; every request goes over
    HTTP to 127.0.0.1. ``/predict`` runs the fp32 K1, ``/loglik`` and
    ``/sample`` K2 at bf16x3, ``/fit`` and Laplace's ascent K3 at
    (bf16x3, bf16x3) through the service's routed likelihood; each
    wrapper's count is set to 0 just before its request and read just
    after. ``box``: phase 13's fit box (``/fit`` reaches the mode inside
    it); ``laplace_logz``: phase 15's in-process Laplace log Z at the
    exact tier. Each served wrapper is then held to its plain version on
    its request's rows (K1 on ``/predict``'s, K2 on ``/loglik``'s, K3 on
    1024 prior draws, ``/fit``'s batch: value and gradient), after its
    count was read. Then the host-clock medians of 20 requests, and the
    CLI in subprocesses. Returns the served launches by kernel, the CLI's
    HMC launches and each served kernel's largest |Δ| from plain."""
    import threading

    from tpu21cmvae_torch import deploy
    from tpu21cmvae_torch.ops.kernels.fused_mlp import FusedMLP
    from tpu21cmvae_torch.serve import make_server

    t_phase = time.perf_counter()
    model = load_model(CHECKPOINT, device=dev)
    server = make_server(model, port=0)
    service = server.service
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    out, walls, held = {"card": smi}, {}, {}
    try:
        _, walls["warmup_4096"] = timed(lambda: service.warmup(up_to=4096))
        (k1,) = service._sharded.fns
        check(isinstance(k1, FusedMLP) and k1.tier == "f32",
              "serve: /predict runs the fp32 K1 (fused_mlp.cu)")
        health, _ = http(server, "/health")
        check(health["status"] == "ok" and health["devices"] == [str(model.device)],
              f"serve: /health {health}")

        # /predict at 1, 37 and 4096 rows: one fp32 K1 launch each
        pred = {}
        for n in (1, 37, 4096):
            raw = served_rows(n, 200 + n)
            k1.launches = 0
            body, wall = http(server, "/predict", {"params": raw.tolist()})
            got = np.asarray(body["signals"], np.float64)
            err = predict_rel_err(got, raw)
            check(got.shape == (n, 451) and err <= 1e-5 and k1.launches == 1,
                  f"serve: /predict {n} rows: shape {got.shape}, rel err {err:.3g}, "
                  f"K1 launches {k1.launches}")
            plain = model.predict_fn()(model.params, torch.as_tensor(raw, device=dev))
            d = float(np.abs(got - plain.cpu().numpy()).max())
            amp_d = d / float(np.abs(got).max())
            check(amp_d <= AMPLITUDE_RTOL["highest"],
                  f"serve: /predict {n} rows vs plain fp32: {amp_d:.3g} of the amplitude")
            held["k1"] = max(held.get("k1", 0.0), d)
            pred[n] = {"rel_err": err, "k1_launches": k1.launches, "wall_s": wall,
                       "max_abs_vs_plain": d}
        out["predict"] = pred
        launches = {"k1": sum(p["k1_launches"] for p in pred.values())}

        # /loglik at 4096 rows: K2 at bf16x3, held to the plain likelihood there
        raw = served_rows(4096, 204)
        body, wall = http(server, "/loglik", {"params": raw.tolist(), "obs": obs.tolist(),
                                              "noise_var": NOISE_VAR})
        ((sharded, routed),) = service._loglik.values()
        k2, k3 = routed.value.fused, routed.valgrad
        check(k2.tensor_cores and k2.tier == "bf16x3" and k2.launches == 1,
              f"serve: /loglik ran K2 at bf16x3 on fused_gram_mma.cu ({k2.launches} launches)")
        check(k3.tensor_cores and (k3.tier, k3.grad_tier) == ("bf16x3", "bf16x3"),
              "serve: the routed K3 runs (bf16x3, bf16x3) on fused_gram_mma.cu")
        got = np.asarray(body["loglik"], np.float64)
        want = scores(model.loglik_fn(obs, NOISE_VAR), model, raw, dev).astype(np.float64)
        half_c = 0.5 * abs(float(k2.operands(model.params).c))
        worst, held["k2"] = value_worst(got, want, "high", half_c)
        check(worst <= 1.0, f"serve: /loglik vs plain bf16x3, worst |Δ|/tol {worst:.3g}")
        out["loglik"] = {"rows": 4096, "worst_over_tol": worst, "max_abs": held["k2"],
                         "wall_s": wall, "k2_launches": k2.launches}
        launches["k2"], launches["k3"] = k2.launches, 0

        # /sample: MH at phase 8's sizes, 1 + 200 + 500 K2 launches
        exact = exact_loglik(model, obs)
        ll_truth = float(scores(exact, model, truth, dev)[0])
        k2.launches = 0
        sample, wall = http(server, "/sample", {
            "obs": obs.tolist(), "noise_var": NOISE_VAR, "sampler": "mh",
            "n_walkers": MH_WALKERS, "n_warmup": MH_WARMUP, "n_steps": MH_STEPS, "thin": 10,
            "seed": 0, "max_samples": 4096})
        want_k2 = 1 + MH_WARMUP + MH_STEPS
        check(k2.launches == want_k2, f"serve: /sample K2 launches {k2.launches} != {want_k2}")
        draws = np.asarray(sample["samples"], np.float32)
        ll_draws = scores(exact, model, draws, dev)
        check(draws.shape == (4096, 7) and bool(np.isfinite(ll_draws).all())
              and 0.15 <= sample["accept_rate"] <= 0.5, "serve: /sample draws and acceptance")
        # phase 8's gate: the best draw at least as likely as the truth less 5
        # nats; the typical-truth measures printed (phase 8's note: MH leaves
        # a share of its walkers far from the mode at these sizes)
        check(float(ll_draws.max()) >= ll_truth - 5.0,
              f"serve: /sample best draw {float(ll_draws.max()):.2f} < logL(truth) "
              f"{ll_truth:.2f} − 5")
        out["sample"] = {"wall_s": wall, "k2_launches": k2.launches,
                         "accept": sample["accept_rate"], "n_samples": sample["n_samples"],
                         "loglik_truth_exact": ll_truth,
                         "loglik_draws_max": float(ll_draws.max()),
                         "share_at_least_truth": float(np.mean(ll_draws >= ll_truth)),
                         "truth_inside_central_999": inside_central_999(draws, truth),
                         "rhat_max": max(sample["rhat"])}
        launches["k2"] += k2.launches

        # /fit: 1024 × 300 inside phase 13's box, exactly 301 K3 launches
        k3.launches = 0
        fit, wall = http(server, "/fit", {"obs": obs.tolist(), "noise_var": NOISE_VAR,
                                          "n_starts": FIT_STARTS, "n_steps": FIT_STEPS,
                                          "bounds": box.tolist(), "seed": 0})
        check(k3.launches == FIT_STEPS + 1,
              f"serve: /fit K3 launches {k3.launches} != {FIT_STEPS + 1}")
        ll_best = float(scores(exact, model, np.asarray(fit["best"], np.float32), dev)[0])
        check(ll_best >= ll_truth - 1.0,
              f"serve: /fit best {ll_best:.3f} < logL(truth) {ll_truth:.3f} − 1 (exact tier)")
        out["fit"] = {"wall_s": wall, "k3_launches": k3.launches, "best_logp_served":
                      fit["best_logp"], "best_logp_exact": ll_best,
                      "best_minus_truth_exact": ll_best - ll_truth}
        launches["k3"] += k3.launches
        # the served K3 against its plain version at /fit's batch, its count read
        x = torch.as_tensor(served_rows(FIT_STARTS, 206), device=dev)
        with torch.no_grad():
            vk, gk = k3(model.params, x)
            vp, gp = loglik_grad_gram_reference(k3.operands(model.params), x)
        vk, gk, vp, gp = (t.cpu().numpy() for t in (vk, gk, vp, gp))
        worst, held["k3"] = value_worst(vk, vp, "high",
                                        0.5 * abs(float(k3.operands(model.params).c)))
        gate = grad_gate_violation(gk, gp)
        check(worst <= 1.0 and gate <= 0.0,
              f"serve: routed K3 vs plain at (bf16x3, bf16x3): worst |Δ|/tol {worst:.3g}, "
              f"gradient gate {gate:.3g}")
        out["fit"]["k3_vs_plain"] = {"rows": FIT_STARTS, "worst_over_tol": worst,
                                     "max_abs": held["k3"], "grad_gate_violation": gate}

        # /evidence Laplace at the JAX defaults: 2001 K3 launches (the ascent)
        # and 3 K2 launches (the IS rounds), at the served tier
        k2.launches = k3.launches = 0
        lap, wall = http(server, "/evidence", {"obs": obs.tolist(), "noise_var": NOISE_VAR,
                                               "method": "laplace", "seed": 0})
        n_lap = {"k2": k2.launches, "k3": k3.launches}
        check(n_lap == {"k2": LAPLACE_ROUNDS, "k3": LAPLACE_STEPS + 1},
              f"serve: /evidence Laplace launches {n_lap}")
        gap = lap["logz"] - laplace_logz
        check(lap["pd"] and abs(gap) <= 1.0,
              f"serve: /evidence Laplace log Z {lap['logz']:.3f} is {gap:+.3f} from phase 15's "
              f"{laplace_logz:.3f}")
        out["evidence_laplace"] = {"wall_s": wall, "launches": n_lap, "logz": lap["logz"],
                                   "minus_phase15": gap, "map_logp": lap["map_logp"]}
        launches["k2"] += n_lap["k2"]
        launches["k3"] += n_lap["k3"]

        # /gof on the /sample draws
        gof, wall = http(server, "/gof", {"obs": obs.tolist(), "noise_var": NOISE_VAR,
                                          "draws": sample["samples"]})
        check(gof["dof"] == 451 and np.isfinite(gof["p_value"]) and gof["n_draws"] == 512,
              f"serve: /gof {gof}")
        out["gof"] = {"wall_s": wall, "p_value": gof["p_value"], "q_over_dof": gof["q_over_dof"],
                      "max_bin_z": gof["max_bin_z"]}

        # an async /sample polled through /result/<id>, /health answering meanwhile
        k2.launches = 0
        sub, _ = http(server, "/sample", {"obs": obs.tolist(), "noise_var": NOISE_VAR,
                                          "async": True, "n_walkers": MH_WALKERS,
                                          "n_warmup": 100, "n_steps": 300, "seed": 1})
        health_s, polls, status = [], 0, {"status": "queued"}
        while status["status"] not in ("done", "error"):
            _, hs = http(server, "/health")
            health_s.append(hs)
            status, _ = http(server, sub["result_path"])
            polls += 1
            time.sleep(0.02)
        check(status["status"] == "done" and set(status) == set(sample) | {"status"},
              f"serve: async /sample ended {status.get('status')}: {status.get('error')}")
        check(k2.launches == 1 + 100 + 300, f"serve: async /sample K2 launches {k2.launches}")
        check(max(health_s) < 1.0, f"serve: /health took {max(health_s):.3f} s during a job")
        out["async_sample"] = {"polls": polls, "health_s_max": max(health_s),
                               "k2_launches": k2.launches}
        launches["k2"] += k2.launches

        # two concurrent /predict clients, both answered correctly
        k1.launches = 0
        raws = [served_rows(256, 300 + i) for i in range(2)]
        replies = [None, None]

        def client(i):
            replies[i] = http(server, "/predict", {"params": raws[i].tolist()})[0]

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        errs = [predict_rel_err(replies[i]["signals"], raws[i]) for i in range(2)]
        check(max(errs) <= 1e-5 and k1.launches == 2,
              f"serve: concurrent /predict rel errs {errs}, K1 launches {k1.launches}")
        out["concurrent_predict"] = {"rel_err": errs}
        launches["k1"] += k1.launches

        # request times: host-clock medians of 20 requests
        medians = {}
        for name, path, payload in (
                ("predict_1", "/predict", {"params": served_rows(1, 401).tolist()}),
                ("predict_256", "/predict", {"params": served_rows(256, 402).tolist()}),
                ("loglik_4096", "/loglik", {"params": served_rows(4096, 403).tolist(),
                                            "obs": obs.tolist(), "noise_var": NOISE_VAR})):
            k1.launches = k2.launches = 0
            walls_s = [http(server, path, payload)[1] for _ in range(20)]
            medians[name] = {"median_ms": 1e3 * float(np.median(walls_s)),
                             "min_ms": 1e3 * min(walls_s), "max_ms": 1e3 * max(walls_s),
                             "launches": k1.launches + k2.launches}
            check(k1.launches + k2.launches == 20, f"serve: {name} launches")
            launches["k1" if path == "/predict" else "k2"] += 20
        out["request_medians"] = medians
        check(k2.operands.folds == 1 and k3.operands.folds == 1 and k1.operands.folds == 1,
              "serve: every wrapper folded its operands once")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    # the CLI in subprocesses, on the card
    cli_out = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        raw = served_rows(64, 500)
        np.save(os.path.join(tmp, "p.npy"), raw)
        t0 = time.perf_counter()
        cli(["predict", CHECKPOINT, os.path.join(tmp, "p.npy"), "--out",
             os.path.join(tmp, "s.npy")])
        err = predict_rel_err(np.load(os.path.join(tmp, "s.npy")), raw)
        check(err <= 1e-5, f"CLI predict vs float64 forward: {err:.3g}")
        cli_out["predict"] = {"rel_err": err, "wall_s": time.perf_counter() - t0}

        with open(os.path.join(tmp, "obs.json"), "w") as fh:
            json.dump({"obs": obs.tolist(), "noise_var": NOISE_VAR}, fh)
        t0 = time.perf_counter()
        text = cli(["sample", CHECKPOINT, "--obs", os.path.join(tmp, "obs.json"), "--sampler",
                    "hmc", "--walkers", "1024", "--warmup", "50", "--steps", "50", "--out",
                    os.path.join(tmp, "chain.npz")])
        n_hmc = int(re.search(r"kernel launches: (\d+)", text).group(1))
        chain = np.load(os.path.join(tmp, "chain.npz"))
        check(n_hmc >= 100 and bool(np.isfinite(chain["chain"]).all())
              and chain["chain"].shape == (10, 1024, 7),
              f"CLI sample --sampler hmc: {n_hmc} K3 launches, chain {chain['chain'].shape}")
        cli_out["sample_hmc"] = {"k3_launches": n_hmc, "wall_s": time.perf_counter() - t0}

        t0 = time.perf_counter()
        art = os.path.join(tmp, "em.pt2")
        cli(["export-artifact", CHECKPOINT, "--out", art])
        fn = deploy.load_artifact(art, device=dev)
        raw = served_rows(1000, 501)
        replay_err = float(np.abs(fn(raw) - model.predict(raw)).max())
        check("cuda" in fn.platforms and fn.device.type == "cuda" and replay_err <= 5e-5
              and fn(raw[0]).shape == (451,),
              f"CLI export-artifact: platforms {fn.platforms}, replay |Δ| {replay_err:.3g}")
        cli_out["export_artifact"] = {"platforms": list(fn.platforms), "max_abs_err": replay_err,
                                      "bytes": os.path.getsize(art),
                                      "wall_s": time.perf_counter() - t0}

        t0 = time.perf_counter()
        cli(["verify", "--out", os.path.join(tmp, "report.json")], timeout=900)
        with open(os.path.join(tmp, "report.json")) as fh:
            report = json.load(fh)
        status = {c["name"]: c["status"] for c in report["checks"]}
        check(report["ok"] and status["direct_golden"] == status["ae_golden"] == "SKIP"
              and report["pass"] == 4, f"CLI verify: {status}")
        cli_out["verify"] = {"status": status, "wall_s": time.perf_counter() - t0,
                             "deploy": next(c["detail"] for c in report["checks"]
                                            if c["name"] == "deploy_artifact")}
    out.update(cli=cli_out, served_launches=launches, served_max_abs_vs_plain=held,
               wall_s=walls, phase_wall_s=time.perf_counter() - t_phase)
    print("phase 20: " + json.dumps(out), flush=True)
    return launches, n_hmc, held



# -- phase 21: the distributed half and the tuner -------------------------------

# HMC and MH at phases 5's and 8's sizes launch exactly these counts
# unsharded (one per likelihood call: the start, then every leapfrog
# step of the jittered counts, or every MH step); a mesh of two entries
# launches each call twice, on half the rows.
HMC_LAUNCHES, MH_LAUNCHES = 1823, 1 + MH_WARMUP + MH_STEPS
MESH_TUNE = dict(n_initial=4, rungs=2, rung_epochs=2)  # tune_direct_halving on the golden split
RANK_TIMEOUT_S = 600  # each two-process worker's communicate()


def same_result(a, b) -> bool:
    """Every array and number of two sampler results equal, bit for bit."""
    for k, v in vars(a).items():
        w = getattr(b, k)
        if isinstance(v, np.ndarray) and not np.array_equal(v, w, equal_nan=True):
            return False
        if isinstance(v, float) and not (v == w or (np.isnan(v) and np.isnan(w))):
            return False
    return True


def record_dp_steps() -> list:
    """Keep each data-parallel training step's mean loss (a device
    tensor) in the returned list: ``_DataParallel.train_step`` wrapped,
    for the process that calls this."""
    from tpu21cmvae_torch.parallel import train_dp

    steps, base = [], train_dp._DataParallel.train_step

    def train_step(self, *args, **kwargs):
        loss, state = base(self, *args, **kwargs)
        steps.append(loss.detach())
        return loss, state

    train_dp._DataParallel.train_step = train_step
    return steps


def golden_arrays(model, data):
    """The golden split's four arrays as ``DirectEmulator.train`` makes
    them, on the model's device."""
    from tpu21cmvae_torch.ops.transforms import par_transform

    def rows_of(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=model.device)

    norm = model.normalizer
    return (par_transform(rows_of(data.par_train), norm), preproc(rows_of(data.signal_train), norm),
            par_transform(rows_of(data.par_val), norm), preproc(rows_of(data.signal_val), norm))


def mesh_fit(dev, mesh=None):
    """Two epochs of the flagship's recipe from seed 0 on the golden split
    (phase 18's parity run) through ``fit``, or ``dp_fit`` over ``mesh``:
    ``(per-step losses, per-epoch losses, wall s)``."""
    from tpu21cmvae_torch.parallel import dp_fit
    from tpu21cmvae_torch.train.loop import fit

    data = synthetic_dataset(**TRAIN_SPLIT)
    model = DirectEmulator(data, device=dev, seed=0)
    cfg = dataclasses.replace(DIRECT_TRAIN_DEFAULT, epochs=PARITY_EPOCHS)
    arrays = golden_arrays(model, data)
    if mesh is None:
        steps = []
        inner = model.loss_fn()

        def loss(params, x, y):
            per_sample = inner(params, x, y)
            if torch.is_grad_enabled():
                steps.append(per_sample.detach().mean())
            return per_sample

        (_, _, hist), wall = timed(lambda: fit(model.params, loss, *arrays, cfg))
    else:
        steps = record_dp_steps()
        (_, _, hist), wall = timed(lambda: dp_fit(model.params, model.loss_fn(), *arrays, cfg,
                                                  mesh))
    return (torch.stack(steps).cpu().numpy().tolist(), hist.loss + hist.val_loss, wall)


def gloo_cuda_probe(dev) -> dict:
    """Which gloo collectives take CUDA tensors here: each tried once on a
    small tensor, the error kept where one refuses (a probe of the
    library, not a check: the port moves CUDA tensors through the host
    on gloo whatever it shows)."""
    import torch.distributed as tdist

    out = {}
    t = torch.ones(4, device=dev)
    for name, call in (
        ("all_reduce", lambda: tdist.all_reduce(t.clone())),
        ("broadcast", lambda: tdist.broadcast(t.clone(), src=0)),
        ("all_gather", lambda: tdist.all_gather([torch.empty_like(t) for _ in range(2)], t)),
    ):
        try:
            call()
            torch.cuda.synchronize()
            out[name] = True
        except Exception as exc:  # noqa: BLE001 - the probe's answer is the refusal
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
    return out


def rank_main(rank: int, port: int, tmp: str) -> int:
    """One of phase 21's two processes on the card: join the gloo group,
    run MH at phase 8's sizes over the global mesh (this process scores
    its half of every proposal batch), then ``dp_fit`` over it; write
    what it saw to ``tmp/rank<rank>.json``."""
    from tpu21cmvae_torch.parallel import make_mesh, multihost_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.load_library()  # the parent built it
    multihost_init(coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=rank,
                   initialization_timeout=120)
    mesh = make_mesh()
    from tpu21cmvae_torch.parallel import mesh as mesh_mod

    check(mesh.size == 2 and mesh.processes == (0, 1) and mesh.process_index == rank
          and mesh_mod._GROUP["nccl"] is None,
          f"rank {rank}: global mesh {mesh}, NCCL group {mesh_mod._GROUP['nccl']}")
    probe = gloo_cuda_probe(dev)
    ref = np.load(os.path.join(tmp, "ref.npz"))
    model = DirectEmulator.from_checkpoint(CHECKPOINT, device=dev)
    obs = ref["obs"]
    k2 = model.loglik_fn(obs, NOISE_VAR, backend="kernel")
    k2.launches = 0
    res, mh_wall = timed(lambda: model.sample_posterior(obs, NOISE_VAR, sampler="mh",
                                                        mesh=mesh, **MH_SIZES))
    launches = k2.launches
    same = all(np.array_equal(getattr(res, k), ref[f"mh_{k}"])
               for k in ("chain", "final", "logp", "accept_rate"))
    steps, epochs, fit_wall = mesh_fit(dev, mesh)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump({"k2_launches": launches, "mh_equal": same, "mh_wall_s": mh_wall,
                   "steps": steps, "epochs": epochs, "fit_wall_s": fit_wall,
                   "gloo_cuda": probe}, fh)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def two_processes(obs, mh_plain, dev) -> dict:
    """Phase 21 (b): this script twice more, as ranks 0 and 1 of a gloo
    group on 127.0.0.1, both on this card (NCCL refuses two processes on
    one card). Each rank's MH must equal ``mh_plain`` bit for bit with
    701 launches of its half of the rows; its ``dp_fit`` is returned for
    the caller to hold to the one-process ``fit``. A rank that fails or
    hangs fails the phase."""
    tmp = tempfile.mkdtemp(prefix="t21_ranks_")
    try:
        np.savez(os.path.join(tmp, "ref.npz"), obs=obs,
                 **{f"mh_{k}": getattr(mh_plain, k)
                    for k in ("chain", "final", "logp", "accept_rate")})
        port = free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   str(port), tmp], cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S) + (p.returncode,))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            check(False, f"phase 21: the two ranks did not finish in {RANK_TIMEOUT_S} s")
        for r, (out, err, rc) in enumerate(outs):
            check(rc == 0, f"phase 21: rank {r} exited {rc}:\n{out[-2000:]}\n{err[-4000:]}")
        ranks = []
        for r in (0, 1):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r, got in enumerate(ranks):
        check(got["mh_equal"], f"phase 21: rank {r}'s MH differs from the unsharded chain")
        check(got["k2_launches"] == MH_LAUNCHES,
              f"phase 21: rank {r} launched K2 {got['k2_launches']} times, not {MH_LAUNCHES}")
    check(ranks[0]["steps"] == ranks[1]["steps"] and ranks[0]["epochs"] == ranks[1]["epochs"],
          "phase 21: the two ranks' dp_fit runs differ")
    return ranks


MIXED_ROWS = 512  # rows of each likelihood held row-wise on Mesh([cuda:0, cpu])
MIXED_RTOL = 1e-4  # fp32 on the card vs fp32 on the host, relative to the largest |value|


def rel_gap(got, want) -> float:
    """The largest ``|got − want|`` over every output, each relative to
    its own largest ``|want|``."""
    pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
    return max(float((g.detach().to(w.device) - w.detach()).abs().max()
                     / w.detach().abs().max().clamp_min(1e-30))
               for g, w in pairs)


def mixed_mesh(model, obs, dev) -> dict:
    """Phase 21 (d): ``Mesh([cuda:0, cpu])``, a mesh of two distinct
    devices in one process, where every likelihood's replica on the host
    is made anew there (phase 21 (a)'s mesh repeats one device, where a
    replica is the likelihood itself). Each likelihood a sampler on a
    mesh replicates, of the flagship and of a full-width autoencoder with
    random weights (the stacked and per-row-gradient ones, K2 and K3 whose
    host replica runs the plain version, and the autodiff gradient that
    ``MeshSplit.valgrad`` derives per device), scores ``MIXED_ROWS`` rows
    split over the mesh, held row-wise to the same call on the card within
    ``MIXED_RTOL`` at the exact fp32 tier. Then the entry points the
    stacked and wrapped likelihoods serve run end to end on that mesh
    beside their runs without it: finite results of the unsharded shapes
    (the host's rounding differs from the card's, so the chains need not
    match; the gaps are printed)."""
    from tpu21cmvae_torch.ops.loglik import make_loglik_and_grad_multi, make_loglik_multi
    from tpu21cmvae_torch.parallel import Mesh
    from tpu21cmvae_torch.sampling._common import MeshSplit

    t0 = time.perf_counter()
    mesh = Mesh([dev, torch.device("cpu")])
    rng = np.random.default_rng(23)
    obs_batch = np.stack([obs, model.predict(synthetic_params(1, rng)[0])]).astype(np.float32)
    ae = AutoEncoderEmulator(synthetic_dataset(n_train=512, n_val=64, n_test=64, seed=1),
                             seed=5, device=dev)
    obs_ae = (ae.predict(synthetic_params(1, rng)[0])
              + rng.normal(0.0, 5.0, ae.config.n_bins)).astype(np.float32)
    x = rows(MIXED_ROWS, rng)
    k2 = model.loglik_fn(obs, NOISE_VAR, backend="kernel", precision="contract")
    cases = {
        "direct_gram": (model, model.loglik_fn(obs, NOISE_VAR, precision="contract"), 1),
        "direct_k2": (model, k2, 1),
        "direct_k3": (model, model.loglik_and_grad_fn(
            obs, NOISE_VAR, backend="kernel", precision="contract",
            grad_precision="contract"), 1),
        "direct_k2_autodiff_valgrad": (model, MeshSplit(k2, mesh).valgrad, 1),
        "multi_gram": (model, make_loglik_multi(model.config, model.normalizer, obs_batch,
                                                NOISE_VAR, precision="contract"), 2),
        "multi_valgrad": (model, make_loglik_and_grad_multi(
            model.config, model.normalizer, obs_batch, NOISE_VAR, precision="contract"), 2),
        "ae_loglik": (ae, ae.loglik_fn(obs_ae, NOISE_VAR), 1),
        "ae_valgrad": (ae, ae.loglik_and_grad_fn(obs_ae, NOISE_VAR), 1),
    }
    out = {"devices": [str(d) for d in mesh.device_list], "rows": MIXED_ROWS, "rel_gap": {}}
    for name, (m, fn, groups) in cases.items():
        if isinstance(fn, MeshSplit):  # the per-device autodiff gradient itself
            split, whole = fn, MeshSplit(k2, Mesh([dev])).valgrad
        else:
            split, whole = MeshSplit(fn, mesh, groups), fn
        want = whole(m.params, x)
        got = split(m.params, x)
        gap = rel_gap(got, want)
        out["rel_gap"][name] = gap
        check(all(bool(torch.isfinite(t).all()) for t in (got if isinstance(got, tuple)
                                                           else (got,)))
              and gap <= MIXED_RTOL,
              f"phase 21 (d): {name} split over {out['devices']} vs the card alone: "
              f"{gap:.3g} > {MIXED_RTOL}")

    def both(name, run, values, gap):
        """``run`` without the mesh and on it: the same shapes, finite."""
        a, b = (values(run(kw)) for kw in ({}, {"mesh": mesh}))
        check(a.shape == b.shape and bool(np.isfinite(b).all()),
              f"phase 21 (d): {name} on {out['devices']}: shape {b.shape} (unsharded "
              f"{a.shape}), finite {bool(np.isfinite(b).all())}")
        out[f"{name}_gap"] = gap(a, b)

    def chain(r):
        return np.asarray(r.chain).reshape(-1, 7)

    def mean_gap(a, b):  # |Δ posterior mean| over the unsharded std, worst parameter
        return float((np.abs(a.mean(0) - b.mean(0)) / a.std(0)).max())

    both("batch_mh", lambda kw: model.sample_posterior_batch(
        obs_batch, NOISE_VAR, sampler="mh", n_walkers=256, n_warmup=100, n_steps=200, thin=10,
        seed=0, **kw), chain, mean_gap)
    both("batch_hmc", lambda kw: model.sample_posterior_batch(
        obs_batch, NOISE_VAR, sampler="hmc", n_walkers=128, n_warmup=50, n_steps=50, thin=5,
        seed=0, **kw), chain, mean_gap)
    both("ae_hmc", lambda kw: ae.sample_posterior(
        obs_ae, NOISE_VAR, sampler="hmc", n_walkers=128, n_warmup=50, n_steps=50, thin=5,
        seed=0, **kw), chain, mean_gap)
    both("laplace_multi", lambda kw: model.log_evidence_batch(
        obs_batch, NOISE_VAR, method="laplace", n_starts=64, n_steps=2000, **kw),
        lambda rs: np.array([r.logz for r in rs]),
        lambda a, b: float(np.abs(a - b).max()))
    out["wall_s"] = time.perf_counter() - t0
    return out


def mesh_phase(model, obs, dev, smi) -> dict:
    """Phase 21: the distributed half and the tuner on the card.

    (a) One process, ``Mesh([cuda:0, cuda:0])``: HMC at phase 5's sizes
    (K3 at (high, default)) and MH at phase 8's (K2 at bf16x3) through
    ``sample_posterior``, each without the mesh and then with it; the
    sharded chain must equal the unsharded one bit for bit and launch
    exactly twice as often (two chunks of half the rows per call, both on
    the memoized wrapper: its replica on its own device is itself). The
    fp32 K3's tile height, picked per batch, is read at 4096 rows and at
    each 2048-row half, and the halves held bit for bit to the whole
    (printed: a finding, not a gate).
    (b) Two processes on this card in one gloo group
    (:func:`two_processes`): MH per rank, and ``dp_fit`` of the flagship
    on phase 18's split, its first 20 steps held to the one-process
    ``fit`` within phase 18's 2e-6, its epochs printed beside.
    (c) ``tune_direct_halving`` on phase 18's split, and the CLI's
    ``tune`` in a subprocess.
    (d) ``Mesh([cuda:0, cpu])`` (:func:`mixed_mesh`): the likelihoods'
    replicas on a second device, row-wise, and the stacked and wrapped
    likelihoods' entry points end to end. Returns the in-process
    launches by path."""
    from tpu21cmvae_torch.parallel import Mesh
    from tpu21cmvae_torch.sampling._common import MeshSplit
    from tpu21cmvae_torch.tuner import tune_direct_halving

    t_phase = time.perf_counter()
    mesh = Mesh([dev, dev])
    out, launches = {"card": smi}, {}
    k3 = model.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel", grad_precision=MAIN_TIERS[1])
    k2 = model.loglik_fn(obs, NOISE_VAR, backend="kernel")
    runs = {}
    for sampler, fn, sizes, n in (("hmc", k3, HMC_SIZES, HMC_LAUNCHES),
                                  ("mh", k2, MH_SIZES, MH_LAUNCHES)):
        for name, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
            fn.launches = 0
            res, wall = timed(lambda: model.sample_posterior(obs, NOISE_VAR, sampler=sampler,
                                                             **sizes, **kw))
            launches[f"{sampler}_{name}"] = fn.launches
            runs[sampler, name] = res
            out[f"{sampler}_{name}_wall_s"] = wall
        check(launches[f"{sampler}_plain"] == n and launches[f"{sampler}_mesh"] == 2 * n,
              f"phase 21: {sampler} launches {launches[f'{sampler}_plain']} unsharded and "
              f"{launches[f'{sampler}_mesh']} on the mesh, not {n} and {2 * n}")
        equal = same_result(runs[sampler, "plain"], runs[sampler, "mesh"])
        out[f"{sampler}_bitwise"] = equal
        check(equal, f"phase 21: the sharded {sampler} chain differs from the unsharded one")
    check(bool(np.isfinite(runs["hmc", "mesh"].logp).all()), "phase 21: finite HMC logp")

    k3_f32 = make_fused_loglik_grad_gram(model.config, model.normalizer, obs, NOISE_VAR,
                                         precision=EXACT_TIERS[0], grad_precision=EXACT_TIERS[1],
                                         device=dev)
    x = rows(HMC_SIZES["n_walkers"], np.random.default_rng(21))
    whole = k3_f32(model.params, x)
    halves = MeshSplit(k3_f32, mesh)(model.params, x)
    check(all(bool(torch.isfinite(t).all()) for t in (*whole, *halves)), "phase 21: finite K3")
    out["k3_f32_split"] = {
        "heights": [k3_f32.rows_for(x.shape[0]), k3_f32.rows_for(x.shape[0] // 2)],
        "value_bitwise": bool(torch.equal(whole[0], halves[0])),
        "grad_bitwise": bool(torch.equal(whole[1], halves[1])),
        "grad_max_abs": float((whole[1] - halves[1]).abs().max()),
    }

    ranks = two_processes(obs, runs["mh", "plain"], dev)
    steps, epochs, fit_wall = mesh_fit(dev)
    dp_steps = np.array(ranks[0]["steps"])
    gap = np.abs(dp_steps - np.array(steps)) / np.array(steps)
    tight = float(gap[:PARITY_TIGHT_STEPS].max())
    check(tight <= TRAIN_LOSS_RTOL,
          f"phase 21: dp_fit vs fit, first {PARITY_TIGHT_STEPS} steps: {tight:.3g} > "
          f"{TRAIN_LOSS_RTOL}")
    out["two_processes"] = {
        "k2_launches_per_rank": [r["k2_launches"] for r in ranks],
        "mh_wall_s_per_rank": [r["mh_wall_s"] for r in ranks],
        "gloo_cuda_collectives": ranks[0]["gloo_cuda"],
        "dp_fit_first_steps_rel_gap": tight, "dp_fit_max_step_rel_gap": float(gap.max()),
        "dp_fit_epochs_loss_then_val": ranks[0]["epochs"], "fit_epochs_loss_then_val": epochs,
        "dp_fit_wall_s": ranks[0]["fit_wall_s"], "fit_wall_s": fit_wall,
        "nccl": "unverified: NCCL needs a card per process; this machine has one",
    }

    data = synthetic_dataset(**TRAIN_SPLIT)
    result, tune_wall = timed(lambda: tune_direct_halving(data, seed=0, device=dev, **MESH_TUNE))
    errs = [t.val_error for t in result.trials]
    n_final = max(1, MESH_TUNE["n_initial"] // 2)
    check(len(result.trials) == n_final and errs == sorted(errs)
          and all(np.isfinite(errs))
          and all(t.epochs_ran == MESH_TUNE["rungs"] * MESH_TUNE["rung_epochs"]
                  for t in result.trials),
          f"phase 21: tune_direct_halving trials {result.leaderboard()}")
    eff = result.best_efficient()
    out["tune"] = {"wall_s": tune_wall, "val_error": errs,
                   "hidden_dims": [list(t.config.hidden_dims) for t in result.trials],
                   "best_efficient": list(eff.config.hidden_dims),
                   "padded_flops_per_row": [t.padded_flops_per_row for t in result.trials]}
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "tpu21cmvae_torch", "tune", "--trials", "2",
                          "--halving"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(cli.returncode == 0 and cli.stdout.count("val_err=") >= 1,
          f"phase 21: CLI tune exited {cli.returncode}:\n{cli.stdout[-1500:]}\n"
          f"{cli.stderr[-1500:]}")
    out["cli_tune"] = {"wall_s": time.perf_counter() - t0,
                       "leaderboard": cli.stdout.strip().splitlines()[-1]}
    out["mixed_mesh"] = mixed_mesh(model, obs, dev)
    out.update(launches=launches, phase_wall_s=time.perf_counter() - t_phase)
    print("phase 21: " + json.dumps(out), flush=True)
    return launches, [r["k2_launches"] for r in ranks]


def wide_route_call(net, obs, tiers, dev):
    """K2 (``tiers[1]`` None) or K3 at ``tiers`` on ``net``'s wrapper, and
    the wide route's operands, its launches (:class:`WideLaunch`, whose
    workspace the call allocates) and its call: the wrapper's own where it
    routes the network there, else (a dedicated kernel holds it) the wide
    route's operands packed all the same and launched directly at the
    tallest height."""
    k3 = tiers[1] is not None
    if k3:
        fn = make_fused_loglik_grad_gram(net.config, net.normalizer, obs, NOISE_VAR,
                                         precision=tiers[0], grad_precision=tiers[1], device=dev)
    else:
        fn = make_fused_loglik_gram(net.config, net.normalizer, obs, NOISE_VAR,
                                    precision=tiers[0], device=dev)
    ops = fn.operands(net.params)
    if fn.wide:
        check(not (fn.tensor_cores or fn.mixed or fn.reverse or fn.register_tiled),
              f"{tiers}: one route")
        return fn, ops, fn.wide_launch, lambda x: fn(net.params, x)
    ops = pack_wide_operands(dataclasses.replace(ops, slabs=None, packed=None, program=None,
                                                 frags=None))
    route = WideLaunch(ops_plan(ops), k3, torch.cuda.get_device_properties(dev)
                       .multi_processor_count, dev)
    return fn, ops, route, lambda x: route(ops, x, route.plan.heights[0])


def exact_gradient(net, obs, dev):
    """The plain K3 at (fp32, fp32) on ``net``'s weights: ``x →`` the
    exact gradient, against which a tensor-core tier's kernel and plain
    version are each held (``grad_gate_beside``)."""
    ops = make_fused_loglik_grad_gram(net.config, net.normalizer, obs, NOISE_VAR,
                                      precision="highest", grad_precision="highest",
                                      device=dev).operands(net.params)
    return lambda x: loglik_grad_gram_reference(ops, x)[1].cpu().numpy()


def wide_routes_phase(model, dev) -> dict:
    """Phase 22: the wide route, ``fused_loglik_grad_gram.cu``, at every
    K2 tier and K3 pair on three networks randomly initialised from
    ``WIDE_ROUTES_SEED`` with the flagship's normalizer (``WIDE_NETS``:
    (1536,)×3, which the dedicated kernels refuse at the samplers' tiers;
    (4096, 4096), whose plan spills to the workspace at every pair;
    (256,)×12, deeper than their eight layers). Each route: one launch per
    wrapper call where the wrapper routes the network there (on (1536,)×3
    a tier or pair whose dedicated kernel holds it keeps that kernel, and
    the wide route's operands are launched directly), held to the plain
    version at 37, 4096 and 65,537 rows (values within ``VALUE_RTOL``, the
    fx == 0 slot exactly 0, gradients under the gate at an fp32 value
    tier; at a bf16 or bf16x3 value tier, where on networks this wide or
    deep kernel and plain each flip more ReLU masks than the gate's 0.1 %
    of rows, as the CPU emulation of the same program does, every row no
    less accurate than plain against the exact (fp32, fp32) gradient by
    the gate's margins, over the 70,694 held rows together:
    ``grad_gate_beside``; over 4096 rows its q99.9 is the fifth-largest
    row's error, which two roundings of one tier move by more than the
    gate's margin on (256,)×12, over 65,536 rows by far less:
    ``scripts/grad_gate_spread_cpu.py``), then timed with plain at 4096
    and 65,536 rows beside its bound, with the workspace's bytes. Then,
    on (1536,)×3, ``sample_posterior`` runs HMC (K3 at (high, default),
    phase 5's exact-run sizes) and MH (K2 at high, phase 8's sizes), each
    wrapper's count set to 0 before and read after: the launches their
    sizes imply, finite draws, and the best draw (scored by the plain
    likelihood at the exact tier) at least as likely as the truth less 5
    nats. Returns the report, with the samplers' launches."""
    rng = np.random.default_rng(WIDE_ROUTES_SEED)
    report = {}
    t_phase = time.perf_counter()
    for label, hidden in WIDE_NETS.items():
        config = DirectEmulatorConfig(hidden_dims=hidden)
        net = DirectEmulator(config=config, normalizer=model.normalizer, seed=WIDE_ROUTES_SEED,
                             device=dev)
        truth = synthetic_params(1, rng)[0]
        obs = net.predict(truth) + rng.normal(0.0, 5.0, config.n_bins)
        trunk = config.mlp().sizes[:-1]
        out = {"hidden": list(hidden)}
        exact = exact_gradient(net, obs, dev)
        for tiers in WIDE_ROUTES:
            k3 = tiers[1] is not None
            key = f"k3 {tiers[0]}/{tiers[1]}" if k3 else f"k2 {tiers[0]}"
            fn, ops, route, call = wide_route_call(net, obs, tiers, dev)
            check(fn.wide or label == "1536x3", f"{label} {key} routes to the wide route")
            plan = route.plan
            plain = loglik_grad_gram_reference if k3 else loglik_gram_reference
            half_c = 0.5 * abs(float(ops.c))
            rep = {"wrapper_route": "wide" if fn.wide else "dedicated",
                   "spilled": len(plan.spilled), "masks_in_ws": plan.masks_in_ws,
                   "heights": list(plan.heights), "worst_over_tol": 0.0, "max_abs": 0.0}
            pooled = []  # (kernel, plain, exact) gradients of every held batch
            for n, x in held_batches((37, 4096, 65537), rng):
                fn.launches = 0
                got = call(x)
                check(fn.launches == int(fn.wide), f"{label} {key} n={n}: {fn.launches} launches")
                want = plain(ops, x)
                vk, vp = (got[0], want[0]) if k3 else (got, want)
                vk, vp = vk.cpu().numpy(), vp.cpu().numpy()
                check(bool(np.isfinite(vk).all()), f"{label} {key} finite values n={n}")
                worst, max_abs = value_worst(vk, vp, tiers[0], half_c)
                check(worst <= 1.0, f"{label} {key} value n={n}: worst |Δ|/tol {worst:.3g}")
                rep["worst_over_tol"] = max(rep["worst_over_tol"], worst)
                rep["max_abs"] = max(rep["max_abs"], max_abs)
                if k3:
                    gk, gp = got[1].cpu().numpy(), want[1].cpu().numpy()
                    check(bool(np.isfinite(gk).all()), f"{label} {key} finite gradients n={n}")
                    check(gk[0, 2] == 0.0, f"{label} {key} fx == 0 gradient slot n={n}")
                    rel = grad_rel_error(gk, gp)
                    rep[f"grad_q999_{n}"] = float(np.quantile(rel, 0.999))
                    if tiers[0] != "highest":  # a tensor-core forward: masks flip on both
                        ge = exact(x)
                        pooled.append((gk, gp, ge))
                        rep[f"grad_off_share_{n}"] = float(np.mean(rel > 1e-2))
                        rep[f"grad_q999_exact_{n}"] = [float(np.quantile(grad_rel_error(g, ge),
                                                                         0.999)) for g in (gk, gp)]
                    else:
                        gate = grad_gate_violation(gk, gp)
                        check(gate <= 0.0, f"{label} {key} gradient gate n={n}: {gate:.3g}")
            if pooled:  # the gate's q99.9 over every held row, as phase 17 pools its draws
                gate = grad_gate_beside(*(np.concatenate(g) for g in zip(*pooled)))
                rep["grad_gate_beside"] = gate
                check(gate <= 0.0, f"{label} {key} gradient gate beside plain, every held row: "
                      f"{gate:.3g}")
            for n, repeats in ((4096, 5), (65536, 3)):
                x = rows(n, rng)
                b = bound("k3" if k3 else "k2", trunk, n, BOUND_TIER[tiers[0]],
                          BOUND_TIER[tiers[1]] if k3 else None)
                rep[str(n)] = {
                    "kernel_ms": time_ms(lambda: call(x), repeats, warmup=1),
                    "kernel_stream_ms": stream_ms(lambda: call(x), repeats, rounds=1),
                    "plain_ms": time_ms(lambda: plain(ops, x), repeats, warmup=1),
                    "bound_ms": b[0], "bound_by": b[1],
                    "tile_rows": fn.rows_for(n) if fn.wide else plan.heights[0]}
            rep["workspace_bytes"] = 0 if route.workspace is None else route.workspace.numel()
            out[key] = rep
        report[label] = out
        print(f"phase 22: wide route on hidden {label} {json.dumps(out)}", flush=True)
    report["held_s"] = time.perf_counter() - t_phase

    # the samplers through sample_posterior on (1536,)×3
    t0 = time.perf_counter()
    config = DirectEmulatorConfig(hidden_dims=WIDE_NETS["1536x3"])
    net = DirectEmulator(config=config, normalizer=model.normalizer, seed=WIDE_ROUTES_SEED,
                         device=dev)
    truth = synthetic_params(1, rng)[0]
    obs = net.predict(truth) + rng.normal(0.0, 5.0, config.n_bins)
    exact = net.loglik_fn(obs, NOISE_VAR, precision="contract")  # plain, the exact tier
    valgrad = net.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel",
                                     grad_precision=MAIN_TIERS[1])
    k2 = net.loglik_fn(obs, NOISE_VAR, backend="kernel")
    check(valgrad.wide and k2.fused.wide,
          "the samplers' K3 and K2 on (1536,)×3 run the wide route")
    samplers = {}
    for sampler, sizes, fn in (("hmc", EXACT_HMC, valgrad), ("mh", MH_SIZES, k2)):
        fn.launches = 0
        res, wall = timed(lambda: net.sample_posterior(obs, NOISE_VAR, sampler=sampler, **sizes))
        launches = fn.launches
        want = (hmc_launches(sizes["n_warmup"], sizes["n_steps"]) if sampler == "hmc"
                else 1 + sizes["n_warmup"] + sizes["n_steps"])
        check(launches == want, f"(1536,)×3 {sampler}: launches {launches}, not {want}")
        thin = 5 if sampler == "hmc" else 10
        check(res.chain.shape == (sizes["n_steps"] // thin, sizes["n_walkers"], 7),
              f"(1536,)×3 {sampler}: chain shape {res.chain.shape}")
        flat = res.flat
        ll = np.concatenate([scores(exact, net, q, dev) for q in np.array_split(
            flat, max(1, flat.shape[0] // 65536))])
        ll_truth = float(scores(exact, net, truth, dev)[0])
        check(bool(np.isfinite(res.chain).all() and np.isfinite(res.logp).all()
                   and np.isfinite(ll).all()), f"(1536,)×3 {sampler}: finite draws")
        check(float(ll.max()) >= ll_truth - 5.0,
              f"(1536,)×3 {sampler}: best draw {float(ll.max()):.2f} < logL(truth) "
              f"{ll_truth:.2f} − 5")
        samplers[sampler] = {"launches": launches, "wall_s": wall,
                             "accept": float(np.mean(res.accept_rate)),
                             "loglik_truth": ll_truth, "loglik_draws_max": float(ll.max()),
                             "share_at_least_truth": float(np.mean(ll >= ll_truth))}
    report["samplers"] = samplers
    report["samplers_s"] = time.perf_counter() - t0
    print(f"phase 22: sample_posterior on hidden (1536,)×3 {json.dumps(samplers)}", flush=True)
    return report


def k1_wide_call(net, tier, reduce, obs, dev):
    """K1 at ``tier`` on ``net``: predict (``make_fused_emulate``) or the
    direct likelihood's Σy² (``make_fused_loglik``'s K1), its operands, its
    launches and its call: the wrapper's own where it routes the network
    to the wide route, else the wide route's K1 operands packed all the
    same and launched directly at the tallest height."""
    if reduce == "sumsq":
        fn = make_fused_loglik(net.config, net.normalizer, obs, NOISE_VAR, precision=tier,
                               device=dev).mlp
    else:
        fn = make_fused_emulate(net.config, net.normalizer, precision=tier, device=dev)
    ops = fn.operands(net.params)
    if fn.wide:
        return fn, ops, fn.wide_launch, lambda x: fn(net.params, x)
    plan = k1_wide_plan(fn.sizes, fn.tier, reduce)
    ops = pack_wide_mlp(ops, plan)
    route = K1WideLaunch(plan, _fused_mlp_wide_cuda, torch.cuda.get_device_properties(dev)
                         .multi_processor_count, dev)
    return fn, ops, route, lambda x: route(ops, x, plan.heights[0])


def k1_wide_phase(model, rng, dev) -> dict:
    """Phase 23 (a): K1's wide route (``k1_fused_mlp_wide``) on phase 22's
    three networks (``WIDE_NETS``, seeded as there, at full width) at
    every tier, predict and Σy²: one launch per wrapper call where the
    wrapper routes the network there (where a dedicated kernel holds it,
    the wide operands are launched directly), held to
    ``fused_mlp_reference`` at ``K1_WIDE_BATCHES`` (predict within
    ``AMPLITUDE_RTOL`` of the amplitude; Σy² as ½Σy² within ``VALUE_RTOL``
    of the folded likelihood's scale, c the output layer's b·b), then timed
    with plain at 4096 and 65,536 rows beside its bound."""
    report = {}
    for label, hidden in WIDE_NETS.items():
        config = DirectEmulatorConfig(hidden_dims=hidden)
        net = DirectEmulator(config=config, normalizer=model.normalizer, seed=WIDE_ROUTES_SEED,
                             device=dev)
        obs = net.predict(synthetic_params(1, rng)[0]) + rng.normal(0.0, 5.0, config.n_bins)
        out = {"hidden": list(hidden)}
        for tier in TIERS:
            for reduce in ("none", "sumsq"):
                key = f"{tier} {'sumsq' if reduce == 'sumsq' else 'predict'}"
                fn, ops, route, call = k1_wide_call(net, tier, reduce, obs, dev)
                check(fn.wide or label == "1536x3", f"K1 {label} {key} routes to the wide route")
                half_c = 0.5 * float(ops.b[-1] @ ops.b[-1])
                rep = {"wrapper_route": fn.route, "spilled": len(route.plan.spilled),
                       "heights": list(route.plan.heights), "worst_over_tol": 0.0,
                       "max_abs": 0.0}
                for n, x in held_batches(K1_WIDE_BATCHES, rng):
                    fn.launches = 0
                    got = call(x)
                    check(fn.launches == int(fn.wide), f"K1 {label} {key} n={n}: launches")
                    got, want = got.cpu().numpy(), fused_mlp_reference(ops, x).cpu().numpy()
                    shape = (n,) if reduce == "sumsq" else (n, config.n_bins)
                    check(got.shape == shape and bool(np.isfinite(got).all()),
                          f"K1 {label} {key} n={n}: shape and finite")
                    if reduce == "none":
                        worst = float(np.abs(got - want).max() / np.abs(want).max()
                                      / AMPLITUDE_RTOL[tier])
                        max_abs = float(np.abs(got - want).max())
                    else:
                        worst, max_abs = value_worst(-0.5 * got, -0.5 * want, tier, half_c)
                    check(worst <= 1.0, f"K1 {label} {key} n={n}: worst |Δ|/tol {worst:.3g}")
                    rep["worst_over_tol"] = max(rep["worst_over_tol"], worst)
                    rep["max_abs"] = max(rep["max_abs"], max_abs)
                for n, repeats in ((4096, 5), (65536, 3)):
                    x = rows(n, rng)
                    b = bound("k1", config.mlp().sizes, n, BOUND_TIER[tier])
                    rep[str(n)] = {
                        "kernel_ms": time_ms(lambda: call(x), repeats, warmup=1),
                        "kernel_stream_ms": stream_ms(lambda: call(x), repeats, rounds=1),
                        "plain_ms": time_ms(lambda: fused_mlp_reference(ops, x), repeats,
                                            warmup=1),
                        "bound_ms": b[0], "bound_by": b[1],
                        "tile_rows": fn.rows_for(n) if fn.wide else route.plan.heights[0]}
                rep["workspace_bytes"] = (0 if route.workspace is None
                                          else route.workspace.numel())
                out[key] = rep
        report[label] = out
        print(f"phase 23: K1 wide route on hidden {label} {json.dumps(out)}", flush=True)
    return report


def served_wide_phase(model, rng, dev) -> dict:
    """Phase 23 (b): ``SERVED_ROWS`` rows served on (1536,)×3 through
    ``ShardedEmulator.for_model(backend="kernel")`` at bf16x3, where the
    dedicated K1 refuses the network: its K1 (the wide route) counted from
    0 (one launch per call), the signals held to the model's
    ``predict_fn`` at the same tier within ``AMPLITUDE_RTOL``."""
    config = DirectEmulatorConfig(hidden_dims=WIDE_NETS["1536x3"])
    net = DirectEmulator(config=config, normalizer=model.normalizer, seed=WIDE_ROUTES_SEED,
                         device=dev)
    svc = ShardedEmulator.for_model(net, backend="kernel", precision=SERVED_TIER)
    (k1,) = [fn for fn in svc.fns if fn is not None]
    check(k1.wide, "the served K1 on (1536,)×3 at bf16x3 runs the wide route")
    raw = synthetic_params(SERVED_ROWS, rng).astype(np.float32)
    raw[0, 2] = 0.0
    svc(raw[:1024])  # warm the operand cache and the workspace
    k1.launches = 0
    got, wall = timed(lambda: svc(raw))
    launches = k1.launches
    with torch.no_grad():
        want = net.predict_fn(precision=SERVED_TIER)(
            net.params, torch.as_tensor(raw, device=dev)).cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    check(got.shape == (SERVED_ROWS, config.n_bins) and bool(np.isfinite(got).all()),
          "served K1: shape and finite")
    check(launches >= 1, f"served K1: {launches} wide launches")
    check(rel <= AMPLITUDE_RTOL[SERVED_TIER], f"served K1 vs predict_fn: {rel:.3g}")
    out = {"rows": SERVED_ROWS, "tier": SERVED_TIER, "launches": launches, "wall_s": wall,
           "rel_amp": rel, "max_abs": float(np.abs(got - want).max())}
    print("phase 23: served on hidden (1536,)×3 " + json.dumps(out), flush=True)
    return out


def fan_in_model(dev):
    """A direct model with ``FAN_IN`` inputs (a dense first layer) and the
    flagship's hidden widths, randomly initialised from ``FAN_IN_SEED``
    with a seeded normalizer of its own over a box of positive columns
    0–2; the box, an observation of a truth inside it and a row sampler
    (row 0 at fx == 0)."""
    rng = np.random.default_rng(FAN_IN_SEED)
    lo = rng.uniform(0.1, 1.0, FAN_IN).astype(np.float32)
    hi = lo + rng.uniform(0.5, 2.0, FAN_IN).astype(np.float32)
    logs = _log_clamp(torch.as_tensor(np.stack([lo, hi]))).to(dev)
    config = DirectEmulatorConfig(n_params=FAN_IN)
    norm = Normalizer(signal_mean=torch.as_tensor(rng.normal(0.0, 20.0, config.n_bins),
                                                  dtype=torch.float32, device=dev),
                      signal_std=torch.tensor(30.0, device=dev), par_min=logs[0],
                      par_max=logs[1])
    net = DirectEmulator(config=config, normalizer=norm, seed=FAN_IN_SEED, device=dev)
    truth = rng.uniform(lo, hi).astype(np.float32)
    obs = net.predict(truth) + rng.normal(0.0, 5.0, config.n_bins)

    def draw(n):
        x = rng.uniform(lo, hi, (n, FAN_IN)).astype(np.float32)
        x[0, 2] = 0.0
        return torch.as_tensor(x, device=dev)

    return net, np.stack([lo, hi], 1), truth, obs, draw


def fan_in_phase(dev) -> dict:
    """Phase 23 (c): the fan-in-12 model (:func:`fan_in_model`): K2 at
    every tier and K3 at every pair on the wide route with a dense first
    layer, one launch per call, held to plain at ``FAN_IN_BATCHES``
    (values within ``VALUE_RTOL``, the fx == 0 slot 0, gradients under the
    gate per batch at an fp32 value tier, at a tensor-core one beside plain
    against the exact gradient over the 69,670 rows pooled), timed at 4096
    and 65,536 rows; then HMC through ``sample_posterior`` (4096 walkers,
    20 + 20, K3 at (high, default)) in its box: exactly the launches
    ``hmc_launches`` replays, finite chains, acceptance in the HMC range,
    the best draw at least as likely as the truth less 5 nats."""
    net, box, truth, obs, draw = fan_in_model(dev)
    trunk = net.config.mlp().sizes[:-1]
    exact = exact_gradient(net, obs, dev)
    out = {"n_params": FAN_IN, "hidden": list(net.config.hidden_dims)}
    for tiers in WIDE_ROUTES:
        k3 = tiers[1] is not None
        key = f"k3 {tiers[0]}/{tiers[1]}" if k3 else f"k2 {tiers[0]}"
        fn, ops, route, call = wide_route_call(net, obs, tiers, dev)
        check(fn.wide and fn.plan.dense, f"fan-in {key}: the wide route, a dense first layer")
        plain = loglik_grad_gram_reference if k3 else loglik_gram_reference
        half_c = 0.5 * abs(float(ops.c))
        rep = {"worst_over_tol": 0.0, "max_abs": 0.0}
        pooled = []
        for n in FAN_IN_BATCHES:
            x = draw(n)
            fn.launches = 0
            got = call(x)
            check(fn.launches == 1, f"fan-in {key} n={n}: {fn.launches} launches")
            want = plain(ops, x)
            vk, vp = ((got[0], want[0]) if k3 else (got, want))
            worst, max_abs = value_worst(vk.cpu().numpy(), vp.cpu().numpy(), tiers[0], half_c)
            check(bool(torch.isfinite(vk).all()) and worst <= 1.0,
                  f"fan-in {key} value n={n}: worst |Δ|/tol {worst:.3g}")
            rep["worst_over_tol"] = max(rep["worst_over_tol"], worst)
            rep["max_abs"] = max(rep["max_abs"], max_abs)
            if k3:
                gk, gp = got[1].cpu().numpy(), want[1].cpu().numpy()
                check(bool(np.isfinite(gk).all()) and gk[0, 2] == 0.0,
                      f"fan-in {key} n={n}: finite gradients, the fx == 0 slot 0")
                if tiers[0] == "highest":
                    gate = grad_gate_violation(gk, gp)
                    check(gate <= 0.0, f"fan-in {key} gradient gate n={n}: {gate:.3g}")
                else:
                    pooled.append((gk, gp, exact(x)))
        if pooled:
            g = [np.concatenate(t) for t in zip(*pooled)]
            check(g[0].shape[0] >= POOLED_ROWS, f"fan-in {key}: {g[0].shape[0]} pooled rows")
            rep["grad_gate_beside"] = grad_gate_beside(*g)
            check(rep["grad_gate_beside"] <= 0.0,
                  f"fan-in {key} gradient gate beside plain: {rep['grad_gate_beside']:.3g}")
        for n, repeats in ((4096, 5), (65536, 3)):
            x = draw(n)
            b = bound("k3" if k3 else "k2", trunk, n, BOUND_TIER[tiers[0]],
                      BOUND_TIER[tiers[1]] if k3 else None)
            rep[str(n)] = {"kernel_ms": time_ms(lambda: call(x), repeats, warmup=1),
                           "kernel_stream_ms": stream_ms(lambda: call(x), repeats, rounds=1),
                           "plain_ms": time_ms(lambda: plain(ops, x), repeats, warmup=1),
                           "bound_ms": b[0], "bound_by": b[1], "tile_rows": fn.rows_for(n)}
        out[key] = rep
    print(f"phase 23: fan-in {FAN_IN} {json.dumps(out)}", flush=True)

    valgrad = net.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel",
                                     grad_precision=MAIN_TIERS[1])
    check(valgrad.wide and valgrad.plan.dense, "fan-in HMC: K3 on the wide route")
    plain_ll = net.loglik_fn(obs, NOISE_VAR, precision="contract")
    valgrad.launches = 0
    res, wall = timed(lambda: net.sample_posterior(obs, NOISE_VAR, sampler="hmc", bounds=box,
                                                   **EXACT_HMC))
    launches = valgrad.launches
    want = hmc_launches(EXACT_HMC["n_warmup"], EXACT_HMC["n_steps"])
    check(launches == want, f"fan-in HMC: {launches} K3 launches, not {want}")
    check(res.chain.shape == (EXACT_HMC["n_steps"] // 5, EXACT_HMC["n_walkers"], FAN_IN),
          f"fan-in HMC: chain shape {res.chain.shape}")
    acc = float(np.mean(res.accept_rate))
    ll = scores(plain_ll, net, res.flat, dev)
    ll_truth = float(scores(plain_ll, net, truth, dev)[0])
    check(bool(np.isfinite(res.chain).all() and np.isfinite(ll).all()), "fan-in HMC: finite")
    check(ACCEPT_RANGE["hmc"][0] <= acc <= ACCEPT_RANGE["hmc"][1],
          f"fan-in HMC: acceptance {acc:.3f}")
    check(float(ll.max()) >= ll_truth - 5.0,
          f"fan-in HMC: best draw {float(ll.max()):.2f} < logL(truth) {ll_truth:.2f} − 5")
    out["hmc"] = {"launches": launches, "wall_s": wall, "accept": acc,
                  "loglik_truth": ll_truth, "loglik_draws_max": float(ll.max())}
    print("phase 23: fan-in HMC " + json.dumps(out["hmc"]), flush=True)
    return out


def main_path_guard(model, obs, launches: dict, wide_routes: dict, dev) -> dict:
    """Phase 23 (d): the flagship's K1 launches on phases 1-22's paths
    (``launches``: by kernel) are ``FLAGSHIP_K1_LAUNCHES``, and every
    wrapper of those phases keeps its route: the flagship's K1, K2 and K3
    at every tier and pair on their dedicated kernels, phase 19's wide
    ensemble's K3 on the wide route, and phase 22's networks on theirs
    (the dedicated kernel at the four tiers and pairs where one holds
    (1536,)×3, else the wide route)."""
    check(launches == FLAGSHIP_K1_LAUNCHES,
          f"flagship K1 launches {launches}, not {FLAGSHIP_K1_LAUNCHES}")
    cfg, norm = model.config, model.normalizer
    routes = {}
    for tier in TIERS:
        want = "f32" if tier == "highest" else "mma"
        routes[f"k1 {tier}"] = (make_fused_emulate(cfg, norm, precision=tier, device=dev).route,
                                make_fused_loglik(cfg, norm, obs, NOISE_VAR, precision=tier,
                                                  device=dev).mlp.route)
        check(routes[f"k1 {tier}"] == (want, want), f"flagship K1 {tier}: {routes[f'k1 {tier}']}")
        k2 = make_fused_loglik_gram(cfg, norm, obs, NOISE_VAR, precision=tier, device=dev)
        check(not k2.wide and k2.tensor_cores == (tier != "highest"), f"flagship K2 {tier}")
        for grad in TIERS:
            k3 = k3_wrapper(model, obs, (tier, grad), dev)
            a, b = BOUND_TIER[tier], BOUND_TIER[grad]
            want = ("f32" if a == b == "f32" else "mixed" if a == "f32" else
                    "reverse" if b == "f32" else "mma")
            got = [r for r, on in (("f32", k3.register_tiled), ("mixed", k3.mixed),
                                   ("reverse", k3.reverse), ("mma", k3.tensor_cores),
                                   ("wide", k3.wide)) if on]
            check(got == [want], f"flagship K3 {tier}/{grad}: {got}")
            routes[f"k3 {tier}/{grad}"] = want
    wide_k3 = make_fused_loglik_grad_gram(DirectEmulatorConfig(hidden_dims=WIDE_HIDDEN), norm,
                                          obs, NOISE_VAR, precision="high",
                                          grad_precision="highest", device=dev)
    check(wide_k3.wide and not wide_k3.plan.dense, "phase 19's wide ensemble: the wide route")
    dedicated = {("highest", None), ("default", None), ("highest", "highest"),
                 ("default", "default")}
    for label, report in wide_routes.items():
        if label not in WIDE_NETS:
            continue
        for tiers in WIDE_ROUTES:
            key = f"k3 {tiers[0]}/{tiers[1]}" if tiers[1] else f"k2 {tiers[0]}"
            want = "dedicated" if label == "1536x3" and tiers in dedicated else "wide"
            check(report[key]["wrapper_route"] == want, f"phase 22 {label} {key}: route")
    out = {"k1_launches": launches, "flagship_routes": routes}
    print("phase 23: main-path guard " + json.dumps(out), flush=True)
    return out


def main() -> int:
    # -- phase 1: device ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1: torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    print(smi, flush=True)

    # -- phase 2: build -----------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"phase 2: built {os.path.relpath(lib_path, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    with open(_build.ptxas_log_path(lib_path)) as fh:
        print("phase 2: ptxas " + json.dumps(ptxas_report(fh.read())), flush=True)

    dev = torch.device("cuda")
    model = DirectEmulator.from_checkpoint(CHECKPOINT, device=dev)
    rng = np.random.default_rng(0)
    truth = synthetic_params(1, rng)[0]
    obs = model.predict(truth) + rng.normal(0.0, 5.0, model.config.n_bins)

    # -- phases 3-4: K3 vs plain at flagship widths, and its timing ----------
    added = np.random.default_rng(ADDED_SEED)
    wrappers, k3_err = k3_vs_plain(model, obs, rng, added, dev)
    timings = time_k3(model, obs, wrappers, rng, added, dev)

    # -- phase 5: the main path ---------------------------------------------
    t0 = time.perf_counter()
    model = DirectEmulator.from_checkpoint(CHECKPOINT, device=dev)
    one = model.predict(truth)
    batch = synthetic_params(4096, rng)
    batch[0, 2] = 0.0
    many = model.predict(batch)
    ref_one = numpy_forward(CHECKPOINT, truth[None])[0]
    ref_many = numpy_forward(CHECKPOINT, batch)
    err_one = float(np.abs(one - ref_one).max() / np.abs(ref_one).max())
    err_many = float(np.abs(many - ref_many).max() / np.abs(ref_many).max())
    check(one.shape == (451,) and many.shape == (4096, 451), "predict shapes")
    check(err_one <= 1e-5 and err_many <= 1e-5,
          f"predict vs float64 forward: {err_one:.3g}, {err_many:.3g}")
    obs = one + rng.normal(0.0, 5.0, 451)
    n_warmup, n_steps = 100, 200
    valgrad = model.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel",
                                       grad_precision=MAIN_TIERS[1])
    valgrad.launches = 0
    res, hmc_s = timed(lambda: model.sample_posterior(
        obs, NOISE_VAR, sampler="hmc", n_walkers=4096, n_warmup=n_warmup, n_steps=n_steps))
    launches = valgrad.launches
    check(model.loglik_and_grad_fn(obs, NOISE_VAR, backend="kernel",
                                   grad_precision=MAIN_TIERS[1]) is valgrad,
          "sample_posterior used the memoized K3 wrapper")
    check(valgrad.tensor_cores, "HMC's K3 runs fused_gram_mma.cu")
    check(launches >= n_warmup + n_steps,
          f"K3 launches {launches} < {n_warmup + n_steps}")
    check(bool(np.isfinite(res.chain).all() and np.isfinite(res.logp).all()),
          "finite chains")
    check(res.chain.shape == (n_steps // 5, 4096, 7), f"chain shape {res.chain.shape}")
    acc = float(np.mean(res.accept_rate))
    check(0.3 <= acc <= 0.99, f"mean acceptance {acc:.3f}")
    flat = res.flat
    mean, sd = flat.mean(0), flat.std(0)
    # The truth must be a typical posterior point. Per parameter: inside
    # the pooled chain's central 99.9 %. In likelihood: the share of
    # draws scoring at least logL(truth) (exact tier) inside [0.001,
    # 0.999] — the truth's rank among the draws, as simulation-based
    # calibration reads it. (|mean − truth|/sd is printed, not gated: at
    # these sampler settings a share of walkers stays far from the mode
    # and drags the mean, in the JAX sampler as in this one.)
    lo_q, hi_q = np.quantile(flat, [0.0005, 0.9995], axis=0)
    check(bool(((truth >= lo_q) & (truth <= hi_q)).all()),
          f"truth inside the central 99.9 % of every marginal: {lo_q} {hi_q}")
    share, ll_truth, ll_max = truth_likelihood_rank(model, obs, flat, truth, dev)
    check(0.001 <= share <= 0.999, f"likelihood rank of the truth {share:.4f}")
    print("phase 5: " + json.dumps({
        "predict_rel_err": [err_one, err_many],
        "truth": truth.tolist(), "mean": mean.tolist(), "sd": sd.tolist(),
        "z": (np.abs(mean - truth) / sd).tolist(),
        "truth_rank": np.mean(flat < truth, axis=0).tolist(),
        "loglik_truth": ll_truth, "share_at_least_truth": share,
        "loglik_draws_max": ll_max,
        "rhat_max": float(res.rhat().max()),
        "accept": acc, "step_size": res.step_size, "k3_launches": launches,
        "hmc_wall_s": hmc_s, "phase_wall_s": time.perf_counter() - t0,
    }), flush=True)

    k3_f32_launches, exact_accept = exact_value_hmc(model, obs, dev)
    k3_mixed_launches, _ = exact_value_hmc(model, obs, dev, grad_precision=MIXED_TIERS[1])
    k3_reverse_launches, _ = exact_value_hmc(model, obs, dev, precision=REVERSE_TIERS[0],
                                             grad_precision=REVERSE_TIERS[1],
                                             accept_near=exact_accept)

    # -- phases 6-8: the value kernels and the gradient-free samplers -------
    k1_err, k1_mma_err, k2_err, k2_mma_err = value_kernels_vs_plain(model, obs, rng, dev)
    value_t = time_value_kernels(model, obs, rng, dev)
    k1_launches, k1_mma_launches, k2_launches, k2_mma_launches, sampler_launches = (
        gradient_free_main_path(model, truth, obs, dev))
    sampler_launches["hmc"] = launches

    # -- phases 9-11: noise models and priors, the same kernels ---------------
    obs_fg, basis = foreground_observation(model, truth, rng)
    fg_err = marginalized_kernels_vs_plain(model, truth, obs_fg, basis, rng, dev)
    marg, hmc_draws, mn, spec = marginalized_posterior_path(
        model, truth, obs, obs_fg, rng, dev, sampler_launches)
    forecast_and_band(model, truth, hmc_draws, mn, spec)

    # -- phases 12-14: adaptive samplers, fits, batched posteriors --------------
    adaptive, adaptive_draws, witness = adaptive_main_path(model, truth, obs, dev)
    fits = fits_and_target_ess(model, truth, obs, adaptive_draws, dev)
    obs_batch = batched_and_calibration(model, res, obs, rng, dev)

    # -- phases 15-16: the evidence path, PT and SMC as samplers ----------------
    evidence, evidence_logz = evidence_path(model, obs, witness, dev)
    tempered = tempered_samplers(model, obs, witness, dev)

    # -- phase 17: the variational fits, the flow evidence, the batch ---------
    variational = variational_path(model, obs, witness, obs_batch[:EVIDENCE_BATCH_OBS], dev)

    # -- phase 18: training the flagship; the kernels on the trained weights --
    trained, golden_split = training_phase(dev, smi)

    # -- phase 19: the other families; the ensemble's member-batched kernels -
    ens_launches, ens_held = families_phase(truth, obs, golden_split, dev, smi)

    # -- phase 20: the HTTP service, the CLI and the artifact on the card ------
    serve, cli_hmc, serve_err = serving_phase(truth, obs, fit_box(adaptive_draws, truth),
                                   evidence_logz["laplace"], dev, smi)
    # -- phase 21: mesh= on the card, two processes, data-parallel training,
    # the tuner ------------------------------------------------------------------
    mesh_launches, rank_launches = mesh_phase(model, obs, dev, smi)
    # -- phase 22: the wide route at every K2 tier and K3 pair on three
    # networks the dedicated kernels refuse; the samplers on one ------------
    wide_routes = wide_routes_phase(model, dev)
    # -- phase 23: K1's wide route, the served path on it, a dense first
    # layer on K2 and K3 (fan-in 12), the main path's guard --------------------
    t23 = time.perf_counter()
    k1_wide = k1_wide_phase(model, np.random.default_rng(WIDE_ROUTES_SEED + 1), dev)
    served = served_wide_phase(model, np.random.default_rng(WIDE_ROUTES_SEED + 2), dev)
    fan_in = fan_in_phase(dev)
    main_path_guard(model, obs, {
        "fused_mlp": k1_launches + ens_launches["k1"] + serve["k1"] + marg.get("fused_mlp", 0),
        "fused_mlp_mma": k1_mma_launches + marg.get("fused_mlp_mma", 0)}, wide_routes, dev)
    print(f"phase 23: wall {time.perf_counter() - t23:.1f} s", flush=True)
    new_k3 = {"launches_chees": adaptive["chees"], "launches_nuts": adaptive["nuts"],
              "launches_fit": fits["fit"], "launches_profile": fits["profile"],
              "launches_ladder_warm_start": evidence["ladder"]["k3"],
              **{f"launches_{m}": variational[m]["k3"]
                 for m in ("advi", "flow_fit", "flow_evidence")}}
    new_k2 = {"launches_target_ess": fits["target_ess"],
              **{f"launches_{m}": evidence[m]["k2"] for m in ("nested", "smc", "ladder")},
              "launches_pt": tempered["pt"], "launches_smc_sampler": tempered["smc"]}

    # each kernel at the tier and the scale nearest to its main-path use
    # (the fp32 K1 and K2 at each chain's draws, with their 1 M-row
    # figures beside; the fp32, mixed and reverse K3 at phase 5's short
    # HMCs' walkers, with their 65,536-row figures and phase 4's turns
    # beside); the wide route fused_loglik_grad_gram.cu runs only a network
    # the others refuse: K3's launches there are phase 19's wide ensemble's
    # and phase 22's HMC (its row times phase 4's wide network at (fp32,
    # fp32), the reverse pairs' beside, and phase 22's device ms per call
    # at 4096 and 65,536 rows by network and route), K2's phase 22's MH (its
    # row times (1536,)×3 at bf16x3); the launches
    # of phases 12-13 and 15-16 count in the totals, by path beside them
    big = 1_048_576
    k1_sizes, trunk = model.config.mlp().sizes, model.config.mlp().sizes[:-1]

    def at_big(t, b):
        return {"ms_1m": t["kernel_ms"], "stream_ms_1m": t["kernel_stream_ms"],
                "plain_ms_1m": t["plain_ms"], "bound_ms_1m": b[0]}

    def at_64k(t, b):
        return {"ms_64k": t["kernel_ms"], "stream_ms_64k": t["kernel_stream_ms"],
                "plain_ms_64k": t["plain_ms"], "bound_ms_64k": b[0]}

    wide = timings["wide"]
    k1_served = k1_wide["1536x3"][f"{SERVED_TIER} predict"]
    wide_pairs = [f"{a}/{b}" for a, b in WIDE_PAIRS]
    wide_k2 = wide_routes["1536x3"]["k2 high"]
    wide_stream = {label: {key: [r["4096"]["kernel_stream_ms"], r["65536"]["kernel_stream_ms"]]
                           for key, r in wide_routes[label].items() if key != "hidden"}
                   for label in WIDE_NETS}
    wide_err = max(r["max_abs"] for label in WIDE_NETS for key, r in wide_routes[label].items()
                   if key.startswith("k3"))
    exact = wide_pairs[0]

    def turns(key, part="mixed_turns"):
        """Phase 4's turns of ``key`` at 4096 and 65,536 rows."""
        return {n: timings[part][n][key] for n in ("4096", "65536")}

    def entry(name, source, replaces, n_launch, err, *args, **extra):
        """The entry of kernel ``name``: its launches on the diagonal paths
        and on the marginalized one, its worst error under either."""
        return kernel_entry(name, source, replaces, n_launch, marg.get(name, 0),
                            max(err, fg_err.get(name, 0.0)), *args, **extra)

    def ensemble(key):
        """Phase 19's launches of the ensemble's ``key`` route (counted in
        the entry's total), its mixture's worst error against plain there,
        and its member-batched launch (M = 3) against three single ones:
        the worst error against its plain version and the times by rows
        (``kernel_ms``/``kernel_stream_ms`` of one member-batched launch,
        ``single3_*`` of three single launches, ``bound_ms`` of three
        members' work)."""
        mb = ens_held[key]["member_batched"]
        return {"launches_ensemble": ens_launches.get(key, 0),
                "max_abs_err_ensemble": ens_held[key]["max_abs"],
                "ensemble_worst_over_tol": ens_held[key]["worst_over_tol"],
                "max_abs_err_members": mb["max_abs"], "members_worst_over_tol":
                mb["worst_over_tol"], "member_batched_m3": mb["timing"]}

    print(json.dumps({"kernels": [
        entry("fused_mlp", K1_SOURCE, K1_REPLACES,
              k1_launches + ens_launches["k1"] + serve["k1"], k1_err,
              value_t[f"k1_sumsq/highest/{DRAWS}"], bound("k1", k1_sizes, DRAWS, "f32"),
              launches_trained=trained["k1"], launches_serve=serve["k1"],
              max_abs_err_serve=serve_err["k1"], **ensemble("k1"),
              **at_big(value_t[f"k1_sumsq/highest/{big}"],
                       bound("k1", k1_sizes, big, "f32"))),
        entry("fused_mlp_mma", K1_MMA_SOURCE, K1_REPLACES, k1_mma_launches, k1_mma_err,
              value_t[f"k1_sumsq/high/{big}"], bound("k1", k1_sizes, big, "bf16x3"),
              launches_trained=0, launches_serve=0, **ensemble("k1_mma")),
        entry("fused_loglik_gram", K2_SOURCE, K2_REPLACES,
              k2_launches + evidence["laplace"]["k2_f32"]
              + variational["flow_evidence"]["k2_f32"] + ens_launches["k2_f32"], k2_err,
              value_t[f"k2/highest/{DRAWS}"], bound("k2", trunk, DRAWS, "f32"),
              launches_laplace_is=evidence["laplace"]["k2_f32"],
              launches_flow_is=variational["flow_evidence"]["k2_f32"], launches_trained=0,
              launches_serve=0, **ensemble("k2_f32"),
              **at_big(value_t[f"k2/highest/{big}"], bound("k2", trunk, big, "f32"))),
        entry("fused_loglik_gram_mma", GRAM_MMA_SOURCE, K2_REPLACES,
              k2_mma_launches + sum(new_k2.values()) + ens_launches["k2"] + serve["k2"]
              + mesh_launches["mh_plain"] + mesh_launches["mh_mesh"],
              k2_mma_err, value_t["k2/high/8192"], bound("k2", trunk, 8192, "bf16x3"),
              launches_trained=trained["k2"], launches_serve=serve["k2"],
              max_abs_err_serve=serve_err["k2"], **new_k2,
              launches_mesh=mesh_launches["mh_mesh"], launches_mesh_ranks=rank_launches,
              **ensemble("k2")),
        entry("fused_loglik_grad_gram_f32", K3_F32_SOURCE, K3_REPLACES,
              k3_f32_launches + evidence["laplace"]["k3_f32"],
              k3_err[EXACT_TIERS], timings["highest/highest/4096"],
              bound("k3", trunk, 4096, "f32", "f32"),
              launches_exact_hmc=k3_f32_launches,
              launches_laplace_ascent=evidence["laplace"]["k3_f32"], launches_trained=0,
              launches_serve=0, **ensemble("k3_f32"),
              **at_64k(timings["highest/highest/65536"],
                       bound("k3", trunk, 65536, "f32", "f32"))),
        entry("fused_gram_mixed", K3_MIXED_SOURCE, K3_REPLACES,
              k3_mixed_launches + ens_launches.get("k3_mixed", 0),
              max(k3_err[MIXED_TIERS], k3_err[MIXED_PAIRS[1]]), timings["highest/default/4096"],
              bound("k3", trunk, 4096, "f32", "bf16"), launches_exact_value_hmc=k3_mixed_launches,
              launches_trained=0, launches_serve=0, in_turns={
                  "highest/default": turns("highest/default"),
                  "highest/high": turns("highest/high")},
              **ensemble("k3_mixed"),
              **at_64k(timings["highest/default/65536"],
                       bound("k3", trunk, 65536, "f32", "bf16"))),
        entry("fused_loglik_grad_gram_reverse", GRAM_MMA_SOURCE, K3_REPLACES,
              k3_reverse_launches + ens_launches.get("k3_reverse", 0),
              max(k3_err[REVERSE_TIERS], k3_err[REVERSE_PAIRS[1]]),
              timings["high/highest/4096"], bound("k3", trunk, 4096, "bf16x3", "f32"),
              launches_exact_force_hmc=k3_reverse_launches, launches_trained=0,
              launches_serve=0, in_turns={
                  "high/highest": turns("high/highest", "reverse_turns"),
                  "default/highest": turns("default/highest", "reverse_turns"),
                  "high/high": turns("high/high", "reverse_turns")},
              **ensemble("k3_reverse"),
              **at_64k(timings["high/highest/65536"],
                       bound("k3", trunk, 65536, "bf16x3", "f32"))),
        entry("fused_loglik_grad_gram", K3_SOURCE, K3_REPLACES,
              ens_launches["k3_wide"] + wide_routes["samplers"]["hmc"]["launches"]
              + fan_in["hmc"]["launches"],
              max(wide_err, *(wide[p]["max_abs"] for p in wide_pairs)), wide[exact]["4096"],
              (wide[exact]["4096"]["bound_ms"], wide[exact]["4096"]["bound_by"]),
              hidden=wide["hidden"], launches_trained=0, launches_serve=0,
              launches_wide_hmc=wide_routes["samplers"]["hmc"]["launches"],
              launches_fan_in_hmc=fan_in["hmc"]["launches"],
              fan_in_12={key: {n: r[n] for n in ("4096", "65536")}
                         for key, r in fan_in.items() if key.startswith("k")},
              stream_ms_by_network_4096_65536=wide_stream,
              tile_rows=wide[exact]["4096"]["tile_rows"],
              reverse_pairs={p: {n: wide[p][n] for n in ("4096", "65536")}
                             for p in wide_pairs if p != exact},
              hidden_ensemble=list(WIDE_HIDDEN), **ensemble("k3_wide"),
              **at_64k(wide[exact]["65536"], (wide[exact]["65536"]["bound_ms"],))),
        entry("fused_mlp_wide", K3_SOURCE, K1_REPLACES, served["launches"],
              max(r["max_abs"] for label in WIDE_NETS for key, r in k1_wide[label].items()
                  if key.endswith("predict")),
              k1_served["65536"], (k1_served["65536"]["bound_ms"],
                                   k1_served["65536"]["bound_by"]),
              hidden=list(WIDE_NETS["1536x3"]), tier=SERVED_TIER, rows=65536,
              launches_served=served["launches"], launches_trained=0, launches_serve=0,
              max_abs_err_served=served["max_abs"],
              max_abs_err_sumsq=max(r["max_abs"] for label in WIDE_NETS
                                    for key, r in k1_wide[label].items()
                                    if key.endswith("sumsq")),
              ms_4096=k1_served["4096"]["kernel_ms"],
              plain_ms_4096=k1_served["4096"]["plain_ms"],
              bound_ms_4096=k1_served["4096"]["bound_ms"],
              stream_ms_by_network_4096_65536={
                  label: {key: [r["4096"]["kernel_stream_ms"], r["65536"]["kernel_stream_ms"]]
                          for key, r in k1_wide[label].items() if key != "hidden"}
                  for label in WIDE_NETS}),
        entry("fused_loglik_gram_wide", K3_SOURCE, K2_REPLACES,
              wide_routes["samplers"]["mh"]["launches"],
              max(r["max_abs"] for label in WIDE_NETS for key, r in wide_routes[label].items()
                  if key.startswith("k2")),
              wide_k2["4096"], (wide_k2["4096"]["bound_ms"], wide_k2["4096"]["bound_by"]),
              hidden=list(WIDE_NETS["1536x3"]), launches_wide_mh=wide_routes["samplers"]["mh"][
                  "launches"], launches_trained=0, launches_serve=0,
              **at_64k(wide_k2["65536"], (wide_k2["65536"]["bound_ms"],))),
        entry("fused_loglik_grad_gram_mma", GRAM_MMA_SOURCE, K3_REPLACES,
              launches + sum(new_k3.values()) + ens_launches["k3"] + serve["k3"] + cli_hmc
              + mesh_launches["hmc_plain"] + mesh_launches["hmc_mesh"],
              k3_err[MAIN_TIERS], timings[f"{MAIN_TIERS[0]}/{MAIN_TIERS[1]}/4096"],
              bound("k3", trunk, 4096, "bf16x3", "bf16"), launches_hmc=launches,
              launches_trained=trained["k3"], launches_serve=serve["k3"],
              max_abs_err_serve=serve_err["k3"], launches_cli=cli_hmc, **new_k3,
              launches_mesh=mesh_launches["hmc_mesh"], **ensemble("k3")),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # one of phase 21's two processes
        sys.exit(rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
