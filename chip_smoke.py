#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``rgp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. Require a CUDA device; print the card's name and power limit
   (``nvidia-smi``) and the TF32 flags, which must both be off.
2. Build K1 and K2, the hand-written CUDA Psi2 time-sum kernel and its
   backward, from ``rgp_tpu_torch/csrc/psi2_{fwd,bwd}.cu``, K3, the
   predictive's Psi2 contraction (``csrc/psi2_contract.cu``), and the
   roofline's exp probe (``csrc/exp_probe.cu``; phase 12a): nvcc, sm_90a,
   all at once.
3. Hold K1 and K2 against their plain PyTorch versions, run in float64 on the
   card from the same float32 inputs, at the config-1 layer shapes (T, M, Q) =
   (512, 100, 20) and (512, 100, 1), a shape that does not align to tiles
   (65, 130, 5), a production shape (2048, 256, 32), the config-2 hidden
   layers (250, 100, 16) and (250, 100, 12) (Q padded to the compiled width
   20; config 2's output layer is (250, 100, 1)), and at shapes whose
   K2 columns do not fit in shared memory, (40, 600, 128) (both kernels) and
   (24, 1200, 20) (K2). Tolerance per element: K1 |k - p| <= 2e-4 |p| +
   2e-5 max|p|, and its output exactly symmetric; K2, all five outputs with a
   random cotangent, 3e-4 |p| + 3e-5 max|p|, and a transposed and an expanded
   cotangent giving the bits of their dense copies. Per kernel and shape:
   the wrapper time and the plain float32 version's (CUDA events, warm,
   median of 30), the device time and device launches per call
   (torch.profiler; each kernel must be one launch a call, alone), a rerun
   that must give the same bits, and the bound. Then the autograd Function's
   gradients for (p, Z, mu, s) (K1 + K2, float32) against autograd of the
   plain chunked path (float64) at the config-1 layer shapes, at K2's
   tolerance.
   3d. The batched kernels (a leading batch axis of instances, one launch):
   at (512, 100, 20), (512, 100, 1) and (2048, 256, 32), B = 8 and 32, Z
   shared (batch stride 0) and batched. Every instance's outputs bit-identical
   to its own single launch (K2 with a random and with an expanded
   cotangent), within the tolerances above of the batched plain versions in
   float64, and one launch a batched call; with Z shared, the device time of
   one batched call beside B single launches, and the bound (B single
   bounds).
   3k. K3, each row's Psi2 contracted with the predictive's matrices
   (``rgp_tpu_torch/csrc/psi2_contract.cu``), at config 1's layers (T, M,
   Q, D) = (16384, 100, 20, 1) and (16384, 100, 1, 1), config 2's
   (1024, 100, 16, 1), (1024, 100, 12, 1) and (1024, 100, 1, 1), and two
   columns at (1024, 100, 20, 2): against its plain version in float64 on
   the card from the same float32 inputs, per row |k - p| <= 2e-6 times the
   sum of the terms' magnitudes, one device launch a call, a rerun's bits;
   the wrapper time, the device time, the plain float32 version's time,
   the materialised contraction it replaced (Psi2_t formed, then the two
   einsums) and the bound (``roofline.k3_bound_ms``).
4. Serve config 1 in float32 on the card: actuator data,
   ``deep_rgp_config(wins=[0,10], u_win=10, num_inducing=100)``,
   ``init_params(seed=0)``, then ``elbo`` (forward), ``compute_whitenings``,
   ``predict_train`` and ``freerun`` over the 512-step test horizon. The launch
   counts are set to 0 just before and read just after: K1 must rise by 2 per
   pass over the layers, K2 must not run and the plain Psi2 path must not be
   taken; K3 (``psi2_contract.launches``) must not run in ``elbo`` and
   ``compute_whitenings``, must run once in ``predict_train`` (its output
   layer) and once a layer a step in ``freerun``. Outputs must be finite;
   time freerun and predict_train, and profile one call of each (device
   busy share, device ops per step). Then the repo's
   f32-lane gates at its tests' sizes (T=128): float32 through K1 against
   float64 through the plain path from the same parameters, ELBO
   |e32-e64|/(1+|e64|) < 1e-3 at M=32 and a 64-step freerun trajectory
   rms/scale < 5e-2 at M=16.
5. Train config 1 in float32 on the card (``rgp_tpu_torch.bench.config1``):
   Adam on -elbo, cosine decay to 1%, whitening refresh every 100 steps, 500
   steps (``bench.py`` runs 1000; cut to fit phase 10) timed after a 20-step
   warm-up. Counted over the timed call: K2 runs
   2 per step, K1 at least 2 per step, the plain Psi2 path never. Every loss
   is finite and the last ELBO is above the first. Print iterations/s, ms per
   step and the trained freerun RMSE beside the zero predictor's, and profile
   training steps. Then the f32-lane gate after training
   (tests/test_f32_lane.py): config-2 shape (drives, wins=[0,2,2], T=64...128,
   M=16), 20 float32 Adam steps through K1/K2, then |e32-e64|/(1+|e64|) < 1e-3.
   5c. Config 1's restarts as one batch, ``config1.fit_restarts`` (the twin
   of ``bench.py --restarts 8``), 8 restarts, 200 steps: K1 and K2 exactly
   one launch a layer a step for all restarts (K1 also one a layer a
   whitening refresh), the plain path never; ms and device ops a step beside
   phase 5's single restart; every final ELBO and the kept restart's RMSE.
   Then the same 8 seeds one at a time through ``config1.fit``: every
   restart's final ELBO, and the kept restart's, within the float32 order
   spread of config 1's endpoint (ROADMAP Queue 3: 244.66 - 201.85) of the
   sequential run's, and the same restart kept, or else the two picks a
   near tie within that spread (the flip is printed).
6. float64 on the card (plain path): the golden-setup ELBO (actuator, M=50,
   seed 0, block=None) must equal -5946.347076392082 at rtol 1e-8, and 50
   Adam(1e-2) steps must pass the golden trajectory at steps 0, 9 and 24 at
   rtol 1e-6 (step 49 is printed only: the reference trajectory crosses a
   ladder rung there, ROADMAP.md Queue 3).
7. Configs 2 and 3 in float32 through ``rgp_tpu_torch.bench.harness``, the
   entry point of ``python -m rgp_tpu_torch.bench``. Config 2: ``rgp2_mlp``
   on drives at full width (T=250 train, wins [0,6,6], u_win 10, M=100,
   back-constraint MLP (32,)), 300 Adam steps, 1 restart. Counted over the
   run: K2 exactly 3 launches per step (two hidden layers and the output), K1
   at least 3, the plain Psi2 path never. Every loss finite, the last ELBO
   above the first, the harness's freerun over the 250 test steps finite
   with positive variances (losses, means, variances, config and loss are
   the fit that ``run(return_fit=True)`` kept). Print it/s, ms per steady
   step, the freerun RMSE beside the zero predictor's and the degeneracy
   flags, and time and profile 10 more steps of that loss from the trained
   point (device busy share, device ops per step). Config 3: ``gp_narx``
   and ``gp_narx_matern`` on actuator at M=50, 300 steps each (``all.py``'s
   rows run 1000; cut to fit phase 10): every loss
   finite, the ELBO rises; print it/s, the first and last ELBO, the RMSE
   beside the zero predictor's and the flags; then time and profile 10
   steady ``gp_narx`` steps in the same way.
8. Config 4 in float32 through the harness on ``long_corpus`` at full width
   (T=16384: a NARX design of 12278 x 15, ``y_win`` 10, ``u_win`` 5, M=100,
   batch 512): the five routes at 300 steps each (``rgp_tpu/bench/all.py``'s
   quick budget runs ``gp_narx_collapsed`` and ``svgp_natgrad`` at 1000; cut
   to fit phase 10). Certain
   inputs: over the five runs K1 and K2 launch 0 times and the plain Psi2 path
   is never taken. Every route but the EMA one (recorded as diverging in
   BASELINE.md) must have finite losses, a last ELBO above the first and a
   finite freerun over the 4096 test steps; the freerun RMSE is printed, not
   gated (the SVGP scored through its q(u) is recorded as worse than the zero
   predictor). Per route: the harness record, ms a steady step and device ops
   and busy share a step (10 steps from the trained point through
   ``fit_adam`` or ``fit_minibatch``), and the wall time of a 4096-step
   freerun for ``svgp_natgrad`` and ``gp_narx_collapsed``. Then one
   ``svgp.elbo`` with uncertain inputs at (T, M, Q) = (512, 100, 20), forward
   and backward: exactly one K1 and one K2 launch; the Psi2 K1 gave inside it
   and the gradient of Z through K2 (at the cotangent the bound handed K2)
   against their plain float64 versions at K1's and K2's tolerances, and
   the ELBO against the float64 plain bound at 2e-4 relative.

9. Config 5 in float32 at the committed anchor ``artifacts/pcheck_params_r5.npz``
   (the flagship: actuator, ``deep_rgp_config(wins=[0,10], u_win=10,
   num_inducing=100)``, 25 hyperparameters).
   9a. The potential: the frozen-basis float64 potential at the anchor must
   equal ``U_f64_frozen`` of ``artifacts/surrogate_check_r5.json`` (-13.3)
   within its rounding (0.05). At the last draw of each of the first 128
   chains of ``artifacts/pcheck_tpu_r5.npz``, one batched float32
   value-and-gradient through ``make_rgp_potential``'s vmapped potential on
   each route, ``scan`` (the plain chunked Psi2, block 32) and ``auto`` (K1/K2
   through the Function's vmap rule: exactly one batched K1 and one batched
   K2 launch a layer for all chains, the plain path never), against the float64 plain
   potential at the same points. float32 itself is up to ~1.6 nats off
   float64 at these points (the plain route, measured on the card; the
   surrogate check's 0.79 was the worst of four points), so each route is held
   against what float32 does: the plain route's median value error within 1
   nat, and each route's worst value error and worst gradient error at most
   twice the plain float32 route's own. Per route: ms per batched
   value-and-gradient, device ops and busy share, launches, peak memory.
   9b. The NUTS twin (``rgp_tpu_torch.bench.sampling.bench_nuts``) at
   half ``rgp_tpu/bench/all.py``'s quick budget (128 chains, 12 warmup steps,
   4 draws; the quick budget's 24 and 8 cut to fit phase 10) with the JAX
   protocol (``scan``): every draw finite, every group's
   final step size at least 1e-2 (a collapsed step size is the death-spiral
   signature), K2 never launched and K1 only by the frozen whitening's ladder
   pass at the anchor (one per layer). Printed, not gated: the twin's JSON
   line, and the
   draws' moment statistics against ``artifacts/pcheck_tpu_r5.npz`` (the same
   float32 frozen-basis surrogate) and, for information only, against the
   float64 fresh-basis chain ``artifacts/pcheck_cpu_r5.npz`` (another
   surrogate).
   9c. ``sample_nuts`` with 4 chains (``auto``, a fresh laddered whitening per
   evaluation, ``hessian_precondition=True``), 6 warmup steps and 4 draws:
   finite draws, and K1 and K2 launched on that path.
   9d. The SMC twin (``bench_smc``, 1024 particles over the 512 test steps of
   the flagship fitted for 300 steps): a finite log-marginal and every step's
   ESS above 0; steps/s, the log-marginal and the mean ESS fraction printed.
10. Tempered SMC and the examples, float32, on the same anchor.
   10a. One batched tempered log-likelihood (``sample.api.make_rgp_loglik``:
   ``rgp.elbo`` with the default jitter and a fresh laddered whitening) at 512
   particles drawn from ``sample_tempered``'s prior (std 3 about the
   anchor), on both routes: ``auto`` must launch K1 exactly once a layer for
   all particles (2) with no K2 and no plain path, ``scan`` (block 32) no K1.
   Per route: ms a call, device ops, busy share, peak memory. The routes are
   held against float64 (plain) at 16 particles and against each other at
   512 under phase 9a's rule, in relative gaps |x - e64| / (1 + |e64|) (the
   prior's draws reach ELBOs of -1e6): the plain route's median gap within
   the f32 lane's 1e-3, the kernel route's worst gap at most twice the plain
   route's, and the median auto-against-scan gap at most twice the plain
   route's median gap to float64. A particle whose two routes part by more,
   or are not both finite, is printed with each layer's ladder rung on each
   route.
   10b. ``sample_tempered`` at 512 particles with the reference's defaults
   (50 stages, ESS target 0.5, 3 moves, step scale 0.5): K1 exactly 2 per
   log-likelihood evaluation, no K2, no plain path; log Z finite, the beta
   schedule increasing to ``beta_final`` (a truncation below 1 is printed,
   not failed), 0 < accept <= 1, every particle finite, and the ELBO at the
   particle mean no more than 50 nats below the anchor's. Printed: log Z,
   stages, accept, wall seconds, evaluations and particle-evaluations per
   second.
   10c. The five example scripts (``rgp_tpu_torch.examples``) in this
   process on the card at the cut sizes of ``_EXAMPLES``: each must print its
   JSON line; wall seconds and launch counts printed.

11. The sharded paths (``rgp_tpu_torch.parallel``, ``sample.api.nuts_sharded``
   and ``smc(..., mesh=)``) on ranks spawned on the card after the kernels
   are built (each rank loads them from ``build/``). Two ranks share the one
   card over gloo, whose all-reduce takes CUDA tensors (NCCL refuses two
   ranks on one device); every number comes back to this process, and a
   rank that fails or a deadline that passes fails the script. Config 1's
   width at the anchor.
   11a. ``sequence_sharded_rgp_elbo``, value and gradients: float64 (plain
   path) against single-process ``rgp.elbo`` on the card, the value at rtol
   1e-9 and each leaf's gradient within 1e-8 of its largest; float32 through
   K1 and K2 (exactly one K1 and one K2 per layer per value-and-gradient per
   rank, no plain path), its gaps to float64 within twice the larger of the
   single-process float32 routes' (``scan`` and ``auto``: phase 9a's rule),
   every ladder rung printed for all three.
   11b. The same for ``data_parallel_collapsed_elbo`` on the anchor's hidden
   layer (T=512 over the ranks; one K1 and one K2 a rank) and
   ``inducing_sharded_collapsed_elbo`` on it (M=100, 50 rows a rank; plain
   torch, no kernel).
   11c. 50 sequence-sharded float32 Adam steps from the anchor: the ranks'
   parameters the same bits at the end, K1 and K2 2 a step a rank; ms a step,
   device ops a step (rank 0), and single-process ``rgp.elbo`` steps beside.
   The ranks share the card, so no speedup is expected.
   11d. ``smc(..., mesh)`` at 1024 particles over the 512 test steps: the
   ranks agree bit for bit, and the log-marginal is within ``_P11_SMC_RTOL``
   (1 + |log Z|) of the single-process filter with the same draws; steps/s
   beside 9d's.
   11e. ``nuts_sharded`` on config 5's potential (``auto``), 2 x 16 chains, 6
   warmup steps, 4 draws: the step size and mass the same bits on both
   ranks, K1 and K2 launched in each; chain steps/s.
   11f. One rank on NCCL: the float32 sequence-sharded value and gradients
   under 11a's rule, through the backend's collectives.

12. The rest of ``rgp_tpu_torch/bench/`` on the card.
   12a. ``roofline`` at (2048, 256, 32): the exp probe against its plain
   float32 chain at 1e-5 relative; ``calibrate``'s measured ceilings beside
   the published H100 peaks; every ``measure_ops`` row with its time,
   binding resource and share of the published peak; the K1 row exactly one
   K1 launch a call and the kernels' forward-and-backward row one K1 and one
   K2, their bounds phase 3's (K1's, and K1's plus K2's); ``capture_trace``'s
   top device ops.
   12b. ``layer_step.run_shape`` at (512, 100, 10, 10) and (2048, 256, 16,
   16), ``_P12_LAYER_ITERS`` iterations: over each timed call of the full
   bound and of the pre-materialized bounds, K1 and K2 each 2 launches an
   iteration and the plain Psi2 path never; wall ms, device ms and device
   ops an iteration, and the gather share on device and wall time.
   12c. ``serving.serve`` on the anchor's model (``_flagship(0, ...,
   params_npz=anchor)``, no training), 3 requests, batch 64: every output
   finite, element 0 of the batched freerun equal to an unbatched freerun on
   the same inputs within 1e-4 of its largest, or within the single float32
   freerun's distance from float64 where that is larger (the variances);
   steps/s, latencies and the batched steps/s. K3's count, set to 0 before
   ``serve`` and read after it, must cover its eager freeruns (once a layer
   a step) and ``predict_train`` calls (once each); the unbatched freerun
   after it, and the batched one with its steps eager (grad mode on: the
   launches that captured graphs replay do not pass the wrapper), must each
   launch K3 once a layer a step.
   12d. ``multimodality.run`` at 32 restarts, M=100, 200 steps, chunks of
   100: K1 exactly one launch a layer for all restarts in every forward
   (refreshes and the freeruns' posteriors included), K2 one a layer in every
   backward, never the plain path; every loss finite; ms and device ops a
   step, busy share, peak memory, RMSE min/median/max and the correlation
   table (phase 5 prints the single-restart step). Then at 4 restarts in
   float64 (plain path): the batched step's ELBOs equal 4 single-restart
   ``rgp.elbo`` calls at rtol 1e-10 and their gradients within 1e-8 of each
   leaf's largest (11a's rule).
   12e. ``posterior_check`` at the anchor: ``card`` at 32 chains, 6 warmup
   steps, 2 draws (K2 never, K1 only for the frozen whitening); ``compare``
   against ``artifacts/pcheck_cpu_r5.npz`` (printed); ``surrogate-check`` on
   the JAX package's ``pcheck_tpu_r5.npz`` and ``pcheck_cpu_r5_freshfloor.npz``
   (the reference draws the record was made from): its ``U_f64_fresh`` and
   ``U_f64_frozen`` at all 9 points of ``artifacts/surrogate_check_r5.json``
   within 0.02, the float32 column printed. Where the fresh basis's float32
   trial Cholesky takes another floor rung on the card than in the record,
   the fresh value must match at the record's rung, and the flip is printed.
   12f. ``python -m rgp_tpu_torch.bench.all --quick --only
   tasks_narendra_gp_narx --out <tmp>``: its row has return code 0, a parsed
   result, ``git_sha`` and the card.

Each phase prints its wall seconds. The line before the last is ``{"kernels": [...]}``: a row each for K1,
K2 and K3 (its shapes from phase 3k, its launches by path from phases 4 and 12c); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

_GOLDEN_E0 = -5946.347076392082  # tests/test_golden_regression.py
_GOLDEN_TRAJ = {0: -5946.347076393514, 9: -3795.857900524881, 24: -2375.0372891290613,
                49: -1293.6259234232734}
_TRAIN_STEPS = 500  # cut from bench.py's 1000 to fit phase 10 in the run's 1200 s
# phase 5c: config 1's restarts as one batch (bench.py's --restarts 8), cut
# to 200 steps (two whitening refreshes), and the same seeds one at a time
_P5_RESTARTS, _P5_RESTART_STEPS = 8, 200
# the float32 config-1 endpoint's spread across summation orders (ROADMAP
# Queue 3, "The f32 config-1 endpoint moves with summation order": ELBO
# 201.85-244.66 across K1/K2 T splits)
_P5_ELBO_SPREAD = 244.66 - 201.85
# config 1's layers, a ragged shape, a production shape, then config 2's
# hidden layers (Q 16 and 12 run at the compiled width 20; its output layer is
# (250, 100, 1))
_K1_SHAPES = [(512, 100, 20), (512, 100, 1), (65, 130, 5), (2048, 256, 32), (250, 100, 16), (250, 100, 12)]
_CONFIG2_STEPS = 300  # rgp_tpu/bench/all.py's quick sweep
_CONFIG3_STEPS = 300  # cut from rgp_tpu/bench/all.py's 1000 (config-3 rows) to fit phase 10
# shapes whose K2 columns do not fit in shared memory: the kernel streams them
_K2_STREAM_SHAPES = [(40, 600, 128), (24, 1200, 20)]
# config 4's routes and steps: all five at 300 (rgp_tpu/bench/all.py's quick
# budget runs the exact route and the named SVGP route at 1000; cut to fit
# phase 10)
_C4_ROUTES = {"gp_narx_collapsed": 300, "svgp_natgrad": 300, "svgp_natgrad_collapsed": 300,
              "gp_narx_minibatch": 300, "gp_narx_minibatch_ema": 300}
_C4_BATCH = 512  # rgp_tpu/bench/harness.py's default
_C4_TIMED_FREERUNS = ("gp_narx_collapsed", "svgp_natgrad")
_SVGP_UNCERTAIN = (512, 100, 20)  # (T, M, Q): config 1's hidden-layer shape
# phase 3d: the batched kernels at config 1's layers and the production shape
_BATCHED_SHAPES = [(512, 100, 20), (512, 100, 1), (2048, 256, 32)]
_BATCHES = (8, 32)
# config 5: the committed anchor and the JAX package's draws at it
_C5_ANCHOR = "artifacts/pcheck_params_r5.npz"
_C5_TPU_DRAWS = "artifacts/pcheck_tpu_r5.npz"  # (256 chains, 64 draws, 25): the f32 frozen-basis surrogate
_C5_CPU_DRAWS = "artifacts/pcheck_cpu_r5.npz"  # (4, 400, 25): the f64 fresh-basis chain, another surrogate
_C5_U_ANCHOR = -13.3  # U_f64_frozen at the anchor, artifacts/surrogate_check_r5.json (2 decimals)
_C5_CHAINS = 128
_C5_WARMUP, _C5_DRAWS = 12, 4  # half rgp_tpu/bench/all.py:35's quick budget (24, 8), to fit phase 10
_C5_SMC_PARTICLES = 1024  # rgp_tpu/bench/all.py:128
_C5_TEMPERED_PARTICLES = 512  # sample_tempered's default
_C5_PRIOR_STD = 3.0  # sample_tempered's default prior, centred on the anchor
# phase 11: the sharded paths on ranks spawned on the one card
_P11_WORLD = 2  # gloo ranks sharing the card (NCCL refuses two ranks on one device)
_P11_ADAM_STEPS = 50
_P11_SMC_PARTICLES = 1024  # phase 9d's
_P11_NUTS = dict(n_chains=32, n_warmup=6, n_samples=4, max_depth=4)  # 16 chains a rank
_P11_TIMEOUT = 600.0  # seconds for one spawn of ranks, start-up included
_P11_PG_TIMEOUT = 300.0  # seconds for one collective
_P11_F64_RTOL = 1e-9  # float64 sharded value against the single-process one
_P11_F64_GRAD_RTOL = 1e-8  # float64 gradients, over each leaf's largest
# float32 log-marginal of the sharded filter against the single-process one
# with the same draws, relative to 1 + |log Z|. The ranks transition their
# halves of the particles, which rounds otherwise than the whole batch, and
# over 512 steps the latent trajectories carry it: 8.4e-6 on an H100 (first
# run of this phase, ESS up to 4 of 1024 apart). A slicing or draw fault
# moves it by nats.
_P11_SMC_RTOL = 1e-4
# phase 12: the rest of bench/
_P12_EXP_ELEMS = 8 * 1024 * 1024  # roofline.calibrate's exp-probe array
_P12_ROOFLINE_SHAPE = (2048, 256, 32)  # roofline.py's production shape
_P12_LAYER_SHAPES = [(512, 100, 10, 10), (2048, 256, 16, 16)]  # layer_step.py's flagship and production
_P12_LAYER_ITERS = 50  # cut from layer_step.py's 200 to fit the run's 1200 s
_P12_SERVING = dict(repeat=3, batch=64)  # serving.py's width, 3 requests (its default is 20)
# element 0 of the batched freerun against the single freerun, of the
# largest entry: 1e-4, or the single float32 freerun's own distance from
# float64 where that is larger. The variance is a difference of O(1) terms
# (quad - mean^2 + psi0 - trace), so the batched kernels' other rounding
# moves it more: 2.5e-4 of the largest on an H100 at 700 W (the means
# 1.2e-6; the single freerun's variances 9.4e-4 from float64).
_P12_SERVING_RTOL = 1e-4
_P12_RESTARTS, _P12_MM_ITERS, _P12_MM_CHUNK = 32, 200, 100  # multimodality.py's width; 10000 steps cut to 200
_P12_F64_RESTARTS = 4
_P12_CARD = dict(chains=32, warmup=6, samples=2)  # posterior_check.py's 256, 96, 64, cut
_P12_SURROGATE = "artifacts/surrogate_check_r5.json"
# the reference draws that record was made from: its ref_chain points are the
# last draws of this fresh-floor chain (-288.40 / 40.02 at chain 0), not of
# pcheck_cpu_r5.npz
_P12_SURROGATE_REF = "artifacts/pcheck_cpu_r5_freshfloor.npz"
_P12_SURROGATE_TOL = 0.02  # the record's 2 decimals, and float64 summation order
_P12_ALL_TIMEOUT = 900.0
# the five examples at cut sizes (their defaults train for thousands of steps)
_EXAMPLES = [
    ("actuator_rgp", ["--iters", "200"]),
    ("drives_deep_rgp", ["--iters", "200", "--back-cstr"]),
    ("minibatch_svgp", ["--iters", "200"]),
    ("nuts_smc_demo", ["--iters", "200", "--samples", "2", "--warmup", "4"]),
    ("evidence_tempered_smc", ["--iters", "200", "--particles", "256"]),
]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def time_host_ms(fn, n):
    """Median host time of ``fn`` ending in a synchronize."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_one_launch(per_call, names, kernel, shape):
    """One device launch a call: the kernel is the only device op."""
    check(per_call == 1 and len(names) == 1 and kernel in next(iter(names)),
          f"{kernel} at (T,M,Q)={shape}: {per_call} device ops per call, {names}; want the kernel alone, once")


def bit_identical(a, b):
    """Two results of the same call on the same inputs are equal bit for bit."""
    if isinstance(a, (tuple, list)):
        return all(bit_identical(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def _card_events(prof):
    """{kernel or copy name: (device us, count)} of a torch.profiler trace
    (:func:`rgp_tpu_torch.bench.psi2_times.card_events`)."""
    from rgp_tpu_torch.bench.psi2_times import card_events

    return card_events(prof)


def profile_device(fn, label, steps):
    """One profiled call of ``fn``: device busy time (the sum of CUDA kernel
    and copy time from torch.profiler, user annotations left out) against the
    host wall time of the call, and the kernels launched. Only the card's
    activity is traced, and its events are summed as the profiler recorded
    them (:func:`_card_events`), without the per-event Python objects that
    ``key_averages()`` builds (minutes at 10^5 device ops a call).
    :func:`profile_readings` sets the two readings side by side. Profiling
    slows the host side, so the busy share here is a lower bound on the unprofiled
    one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = _card_events(prof)
    busy_us = sum(us for us, _ in by_name.values())
    n_kernels = sum(c for _, c in by_name.values())
    top = sorted(((us, c, k[:60]) for k, (us, c) in by_name.items()), reverse=True)
    row = {
        "what": label, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
        "device_busy_share": busy_us / 1e3 / wall_ms if busy_us else "not measured",
        "device_ops": n_kernels, "device_ops_per_step": n_kernels / steps,
        "top_by_device_time": [{"us": t, "count": c, "name": k} for t, c, k in top[:6]],
    }
    print("profile", json.dumps(row))
    return row


def profile_readings(fn, label):
    """The device ops and busy time of one call of ``fn`` read three ways:
    ``key_averages()`` of a trace of host and card, :func:`_card_events` of
    that same trace, and :func:`profile_device` (a trace of the card alone).
    Printed side by side, so that device op counts read the first way and
    the last can be compared."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, busy_us = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ops += e.count
            busy_us += e.self_device_time_total
    events = _card_events(prof).values()
    card_only = profile_device(fn, label, 1)
    row = {"what": label,
           "key_averages_host_and_card": {"device_ops": ops, "device_busy_ms": busy_us / 1e3},
           "events_host_and_card": {"device_ops": sum(c for _, c in events),
                                    "device_busy_ms": sum(us for us, _ in events) / 1e3},
           "events_card_only": {"device_ops": card_only["device_ops"],
                                "device_busy_ms": card_only["device_busy_ms"]}}
    print("profile readings", json.dumps(row))
    return row


def phase_k1(psi2):
    """Phase 3: K1 against its plain version; returns per-shape results. The
    bound is :func:`rgp_tpu_torch.bench.roofline.k1_bound_ms`."""
    from rgp_tpu_torch.bench.psi2_times import device_per_call, time_cuda_ms
    from rgp_tpu_torch.bench.roofline import k1_bound_ms
    from rgp_tpu_torch.kernels import RBF

    dev = torch.device("cuda")
    rows = []
    for i, (T, M, Q) in enumerate(_K1_SHAPES + _K2_STREAM_SHAPES[:1]):
        rng = np.random.default_rng(100 + i)
        mu = torch.as_tensor(rng.standard_normal((T, Q)), device=dev)
        s = torch.as_tensor(rng.uniform(0.05, 0.4, (T, Q)), device=dev)
        Z = torch.as_tensor(rng.standard_normal((M, Q)), device=dev)
        # lengthscale sqrt(Q) keeps Psi2 entries O(1) at every width
        p = RBF(input_dim=Q).init(lengthscale=math.sqrt(Q), dtype=torch.float64, device=dev)
        pre = psi2.rbf_psi2_precompute(p, Z, mu, s)
        args32 = [x.to(torch.float32).contiguous() for x in (*pre, Z)]
        args64 = [x.to(torch.float64) for x in args32]

        k = psi2.psi2_time_sum(*args32)
        torch.cuda.synchronize()
        ref = psi2.psi2_time_sum_plain(*args64)
        err = (k.double() - ref).abs()
        pmax = ref.abs().max()
        tol = 2e-4 * ref.abs() + 2e-5 * pmax
        ok = bool(torch.isfinite(k).all()) and bool((err <= tol).all())
        same = bit_identical(k, psi2.psi2_time_sum(*args32))
        k_ms = time_cuda_ms(lambda: psi2.psi2_time_sum(*args32))
        dev_ms, per_call, names = device_per_call(lambda: psi2.psi2_time_sum(*args32))
        plain_ms = time_cuda_ms(lambda: psi2.psi2_time_sum_plain(*args32))
        bound_ms, bound_by = k1_bound_ms(T, M, Q)
        row = {
            "T": T, "M": M, "Q": Q,
            "max_abs_err": float(err.max()),
            "max_rel_err": float(err.max() / pmax),
            "worst_err_over_tol": float((err / tol).max()),
            "ms": k_ms, "device_ms": dev_ms, "launches_per_call": per_call, "bit_identical": same,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print("k1", json.dumps(row))
        check(ok, f"K1 disagrees with its plain version at (T,M,Q)={T, M, Q}: {row}")
        check(same, f"K1 gave different bits on a rerun at (T,M,Q)={T, M, Q}")
        check_one_launch(per_call, names, "psi2_fwd_kernel", (T, M, Q))
        check(bool(torch.equal(k, k.T)), f"K1's output is not exactly symmetric at (T,M,Q)={T, M, Q}")
        rows.append(row)
    return rows


_K3_SHAPES = [(16384, 100, 20, 1), (16384, 100, 1, 1), (1024, 100, 16, 1), (1024, 100, 12, 1), (1024, 100, 1, 1),
              (1024, 100, 20, 2)]


def phase_k3(psi2_contract):
    """Phase 3k: K3 against its plain version; returns per-shape results."""
    from rgp_tpu_torch.bench.psi2_times import device_per_call, time_cuda_ms
    from rgp_tpu_torch.bench.roofline import k3_bound_ms
    from rgp_tpu_torch.kernels import RBF
    from rgp_tpu_torch.ops import psi_stats
    from rgp_tpu_torch.ops.cuda import psi2

    dev = torch.device("cuda")
    rows = []
    for i, (T, M, Q, D) in enumerate(_K3_SHAPES):
        rng = np.random.default_rng(300 + i)
        def t64(x):
            return torch.as_tensor(x, dtype=torch.float64, device=dev)

        mu, s = t64(rng.standard_normal((T, Q))), t64(rng.uniform(0.05, 0.4, (T, Q)))
        Z = t64(rng.standard_normal((M, Q)))
        p = RBF(input_dim=Q).init(variance=0.8, lengthscale=math.sqrt(Q), dtype=torch.float64, device=dev)
        A = rng.standard_normal((M, M)) / M
        alpha, W = t64(0.5 * rng.standard_normal((M, D))), t64(A @ A.T)
        args32 = [x.to(torch.float32).contiguous() for x in (*psi2.rbf_psi2_precompute(p, Z, mu, s), Z, alpha, W)]
        args64 = [x.double() for x in args32]

        def call():
            return psi2_contract.psi2_contract(*args32)

        k = call()
        torch.cuda.synchronize()
        ref = psi2_contract.psi2_contract_plain(*args64)
        base, E, D1, w, Zd, al, Wd = args64
        m, n = torch.triu_indices(M, M, device=dev)
        scale = torch.exp(base[:, None] + E[:, m] + E[:, n] - D1[m, n] - 0.5 * (w @ (Zd[m] * Zd[n]).T)) \
            @ psi2_contract._weights(al, Wd, m, n).abs()
        err = (k.double() - ref).abs()
        tol = 2e-6 * scale + 1e-7
        ok = bool(torch.isfinite(k).all()) and bool((err <= tol).all())
        same = bit_identical(k, call())
        k_ms = time_cuda_ms(call)
        dev_ms, per_call, names = device_per_call(call)
        plain_ms = time_cuda_ms(lambda: psi2_contract.psi2_contract_plain(*args32), n=5, warm=1)
        kern, p32 = RBF(input_dim=Q), {k_: v.float() for k_, v in p.items()}
        mu32, s32, Z32, al32, W32 = (x.float() for x in (mu, s, Z, alpha, W))

        def materialised():
            p2t = psi_stats.psi2_per_t(kern, p32, Z32, mu32, s32)
            quad = torch.einsum("md,tmn,nd->td", al32, p2t, al32)
            return quad - torch.einsum("mn,tnm->t", W32, p2t)[:, None]

        mat_ms = time_cuda_ms(materialised, n=10)
        bound, bound_by = k3_bound_ms(T, M, Q, D)
        row = {"T": T, "M": M, "Q": Q, "D": D,
               "max_abs_err": float(err.max()), "worst_err_over_tol": float((err / tol).max()),
               "ms": k_ms, "device_ms": dev_ms, "launches_per_call": per_call, "bit_identical": same,
               "plain_ms": plain_ms, "materialised_ms": mat_ms, "bound_ms": bound, "bound_by": bound_by,
               "share": bound / dev_ms}
        print("k3", json.dumps(row))
        check(ok, f"K3 disagrees with its plain version at (T,M,Q,D)={T, M, Q, D}: {row}")
        check(same, f"K3 gave different bits on a rerun at (T,M,Q,D)={T, M, Q, D}")
        check_one_launch(per_call, names, "psi2_contract_kernel", (T, M, Q, D))
        rows.append(row)
    return rows


def _within(k, p, rel=3e-4, rel_max=3e-5):
    """(ok, max_abs_err, worst err/tol) for |k - p| <= rel |p| + rel_max max|p|."""
    err = (k.double() - p).abs()
    tol = rel * p.abs() + rel_max * p.abs().max()
    ok = bool(torch.isfinite(k).all()) and bool((err <= tol).all())
    return ok, float(err.max()), float((err / tol.clamp(min=1e-300)).max())


def phase_k2(psi2):
    """Phase 3b: K2 against its plain version at K1's shapes and at shapes it
    streams, all five outputs, with a random cotangent; a transposed and an
    expanded cotangent against their dense copies; returns per-shape
    results. The bound is :func:`rgp_tpu_torch.bench.roofline.k2_bound_ms`."""
    from rgp_tpu_torch.bench.psi2_times import device_per_call, time_cuda_ms
    from rgp_tpu_torch.bench.roofline import k2_bound_ms
    from rgp_tpu_torch.kernels import RBF

    dev = torch.device("cuda")
    rows = []
    for i, (T, M, Q) in enumerate(_K1_SHAPES + _K2_STREAM_SHAPES):
        rng = np.random.default_rng(200 + i)
        mu = torch.as_tensor(rng.standard_normal((T, Q)), device=dev)
        s = torch.as_tensor(rng.uniform(0.05, 0.4, (T, Q)), device=dev)
        Z = torch.as_tensor(rng.standard_normal((M, Q)), device=dev)
        G = torch.as_tensor(rng.standard_normal((M, M)), device=dev)
        p = RBF(input_dim=Q).init(lengthscale=math.sqrt(Q), dtype=torch.float64, device=dev)
        pre = psi2.rbf_psi2_precompute(p, Z, mu, s)
        args32 = [x.to(torch.float32).contiguous() for x in (*pre, Z, G)]
        args32.append(psi2.psi2_time_sum(*args32[:5]))  # out, which dD1 reads
        args64 = [x.to(torch.float64) for x in args32]

        k = psi2.psi2_time_sum_bwd(*args32)
        torch.cuda.synchronize()
        ref = psi2.psi2_time_sum_bwd_plain(*args64)
        per = {}
        for name, a, b in zip(("dbase", "dE", "dD1", "dw", "dzC"), k, ref):
            ok, err, worst = _within(a, b)
            per[name] = {"ok": ok, "max_abs_err": err, "max_rel_err": err / float(b.abs().max()),
                         "worst_err_over_tol": worst}
        same = bit_identical(k, psi2.psi2_time_sum_bwd(*args32))
        k_ms = time_cuda_ms(lambda: psi2.psi2_time_sum_bwd(*args32))
        dev_ms, per_call, names = device_per_call(lambda: psi2.psi2_time_sum_bwd(*args32))
        plain_ms = time_cuda_ms(lambda: psi2.psi2_time_sum_bwd_plain(*args32))
        bound_ms, bound_by = k2_bound_ms(T, M, Q)
        if i == 0:  # the cotangent is read through its strides
            g32, out32 = args32[5], args32[6]
            for label, g in (("transposed", g32.T), ("expanded", g32[:1, :1].expand(M, M))):
                same_g = bit_identical(psi2.psi2_time_sum_bwd(*args32[:5], g, out32),
                                       psi2.psi2_time_sum_bwd(*args32[:5], g.contiguous(), out32))
                check(same_g, f"K2 with a {label} cotangent differs from its dense copy")
        row = {
            "T": T, "M": M, "Q": Q, "outputs": per, "plan": psi2.bwd_plan(M, Q),
            "max_abs_err": max(v["max_abs_err"] for v in per.values()),
            "max_rel_err": max(v["max_rel_err"] for v in per.values()),
            "ms": k_ms, "device_ms": dev_ms, "launches_per_call": per_call, "bit_identical": same,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print("k2", json.dumps(row))
        check(all(v["ok"] for v in per.values()),
              f"K2 disagrees with its plain version at (T,M,Q)={T, M, Q}: {per}")
        check(same, f"K2 gave different bits on a rerun at (T,M,Q)={T, M, Q}")
        check_one_launch(per_call, names, "psi2_bwd_kernel", (T, M, Q))
        rows.append(row)
    return rows


def phase_vjp(psi2, psi_stats):
    """Phase 3c: gradients of sum(Psi2 * G) for (p, Z, mu, s) through the
    autograd Function (K1 + K2, float32) against autograd of the plain chunked
    path in float64, at the config-1 layer shapes."""
    from rgp_tpu_torch.kernels import RBF

    dev = torch.device("cuda")
    for i, (T, M, Q) in enumerate(_K1_SHAPES[:2]):
        rng = np.random.default_rng(300 + i)
        mu = rng.standard_normal((T, Q))
        s = rng.uniform(0.05, 0.4, (T, Q))
        Z = rng.standard_normal((M, Q))
        G = rng.standard_normal((M, M))
        p64 = RBF(input_dim=Q).init(lengthscale=math.sqrt(Q), dtype=torch.float64, device=dev)
        grads = {}
        for dtype in (torch.float32, torch.float64):
            p = {k: v.to(dtype).requires_grad_() for k, v in p64.items()}
            x = [torch.as_tensor(a, dtype=dtype, device=dev).requires_grad_() for a in (Z, mu, s)]
            if dtype == torch.float32:
                out = psi2.rbf_psi2_sum(p, *x)
            else:
                out = psi_stats._rbf_psi2_sum_chunked(p, *x, 128)
            (out * torch.as_tensor(G, dtype=dtype, device=dev)).sum().backward()
            grads[dtype] = {"log_var": p["log_var"].grad, "log_ls": p["log_ls"].grad,
                            "Z": x[0].grad, "mu": x[1].grad, "s": x[2].grad}
        per = {}
        for name, a in grads[torch.float32].items():
            ok, err, worst = _within(a, grads[torch.float64][name])
            per[name] = {"ok": ok, "max_abs_err": err, "worst_err_over_tol": worst}
        print("vjp", json.dumps({"T": T, "M": M, "Q": Q, "grads": per}))
        check(all(v["ok"] for v in per.values()),
              f"the Function's VJP disagrees with autograd of the plain path at {T, M, Q}: {per}")


def _batched_psi2_args(psi2, rng, B, T, M, Q, shared_z):
    """B instances' float32 (base, E, D1, w, Z) on the card: each its own mu,
    s and lengthscale (sqrt(Q), scaled by 1 + 0.05 b), and Z shared
    (expanded, batch stride 0: the chain case) or each instance's own (the
    restart case)."""
    from rgp_tpu_torch.kernels import RBF

    dev = torch.device("cuda")
    Z0 = torch.as_tensor(rng.standard_normal((M, Q)), device=dev)
    cols = []
    for b in range(B):
        mu = torch.as_tensor(rng.standard_normal((T, Q)), device=dev)
        s = torch.as_tensor(rng.uniform(0.05, 0.4, (T, Q)), device=dev)
        Z = Z0 if shared_z else torch.as_tensor(rng.standard_normal((M, Q)), device=dev)
        p = RBF(input_dim=Q).init(lengthscale=math.sqrt(Q) * (1.0 + 0.05 * b), dtype=torch.float64, device=dev)
        cols.append([x.to(torch.float32) for x in (*psi2.rbf_psi2_precompute(p, Z, mu, s), Z)])
    args = [torch.stack(xs) for xs in zip(*cols)]
    if shared_z:
        args[4] = args[4][0].expand(B, M, Q)
    return args


def _device_ms_per_call(fn, launches, calls=20):
    """(device ms, recorded device ops) a call of ``fn``, which makes
    ``launches`` kernel launches and nothing else on the card: the mean
    recorded duration of its kernels over ``calls`` back-to-back calls in a
    trace of the card alone, times ``launches``. CUPTI drops records (the
    last of a window of kernels of a millisecond or more, every time on an
    H100), which leaves the mean of those it kept as it is."""
    from rgp_tpu_torch.bench.psi2_times import card_window

    _, ops, by_name = card_window(fn, calls)
    n = sum(c for _, c in by_name.values())
    check(n > 0, "the profiler recorded no device operation")
    return sum(us for us, _ in by_name.values()) / n / 1e3 * launches, ops


def phase_batched(psi2, card):
    """Phase 3d: K1 and K2 over a batch of instances in one launch, at config
    1's layer shapes and the production shape, B = 8 and 32, Z shared and
    batched. Per instance, every output bit-identical to the instance's own
    single launch (K2 with a random and with an expanded cotangent), and
    within phase 3's tolerances of the batched plain version in float64; one
    launch a batched call (the counters). With Z shared: the device time of
    one batched call beside B single launches (:func:`_device_ms_per_call`),
    the wrapper times, and the bound, B single bounds. Returns the rows."""
    from rgp_tpu_torch.bench.psi2_times import time_cuda_ms
    from rgp_tpu_torch.bench.roofline import k1_bound_ms, k2_bound_ms

    dev = torch.device("cuda")
    rows = []
    for i, ((T, M, Q), B, shared_z) in enumerate(
            (shape, B, z) for shape in _BATCHED_SHAPES for B in _BATCHES for z in (True, False)):
        rng = np.random.default_rng(400 + i)
        args = _batched_psi2_args(psi2, rng, B, T, M, Q, shared_z)
        singles = [[x[b].contiguous() for x in args] for b in range(B)]
        G = torch.as_tensor(rng.standard_normal((B, M, M)), dtype=torch.float32, device=dev)
        g_exp = torch.ones((1, 1, 1), dtype=torch.float32, device=dev).expand(B, M, M)
        n1, n2 = psi2.launches, psi2.bwd_launches
        out = psi2.psi2_time_sum_batched(*args)
        grads = psi2.psi2_time_sum_bwd_batched(*args, G, out)
        grads_e = psi2.psi2_time_sum_bwd_batched(*args, g_exp, out)
        torch.cuda.synchronize()
        counted = (psi2.launches - n1, psi2.bwd_launches - n2)
        same = {
            "k1": all(bit_identical(out[b], psi2.psi2_time_sum(*singles[b])) for b in range(B)),
            "k2": all(bit_identical([x[b] for x in grads], psi2.psi2_time_sum_bwd(*singles[b], G[b], out[b]))
                      for b in range(B)),
            "k2_expanded_cotangent": all(
                bit_identical([x[b] for x in grads_e], psi2.psi2_time_sum_bwd(*singles[b], g_exp[b], out[b]))
                for b in range(B)),
        }
        args64 = [x.double() for x in args]
        ref = psi2.psi2_time_sum_batched_plain(*args64)
        ref2 = psi2.psi2_time_sum_bwd_batched_plain(*args64, G.double(), out.double())
        k1_worst, k2_worst, ok = 0.0, 0.0, True
        for b in range(B):
            k_ok, _, worst = _within(out[b], ref[b], 2e-4, 2e-5)
            ok &= k_ok
            k1_worst = max(k1_worst, worst)
            for a, r in zip(grads, ref2):
                k_ok, _, worst = _within(a[b], r[b])
                ok &= k_ok
                k2_worst = max(k2_worst, worst)
        row = {"T": T, "M": M, "Q": Q, "B": B, "z": "shared" if shared_z else "batched",
               "launches_counted": {"k1": counted[0], "k2": counted[1] // 2}, "bit_identical_to_singles": same,
               "k1_worst_err_over_tol": k1_worst, "k2_worst_err_over_tol": k2_worst}
        if shared_z:
            for name, batched, one, bound in (
                    ("k1", lambda: psi2.psi2_time_sum_batched(*args),
                     lambda: [psi2.psi2_time_sum(*x) for x in singles], k1_bound_ms(T, M, Q)),
                    ("k2", lambda: psi2.psi2_time_sum_bwd_batched(*args, G, out),
                     lambda: [psi2.psi2_time_sum_bwd(*x, G[b], out[b]) for b, x in enumerate(singles)],
                     k2_bound_ms(T, M, Q))):
                dev_ms, ops = _device_ms_per_call(batched, 1)
                singles_ms, singles_ops = _device_ms_per_call(one, B)
                row[name] = {"device_ms": dev_ms, "device_ops_recorded_per_call": ops,
                             "singles_device_ms": singles_ms, "singles_device_ops_recorded": singles_ops,
                             "ms": time_cuda_ms(batched), "singles_ms": time_cuda_ms(one),
                             "bound_ms": B * bound[0], "bound_by": bound[1]}
                check(ops <= 1.0, f"batched {name} at {T, M, Q} x {B}: {ops} device ops recorded a call, want "
                      f"its one launch alone")
        row["card"] = card
        print("batched", json.dumps(row))
        check(counted == (1, 2), f"batched K1/K2 at {T, M, Q} x {B}: launches {counted}, want 1 K1 and 1 K2 a call")
        check(all(same.values()), f"batched K1/K2 at {T, M, Q} x {B} ({row['z']} Z) differ from single launches: "
              f"{same}")
        check(ok, f"batched K1/K2 at {T, M, Q} x {B} ({row['z']} Z) disagree with the batched plain versions: "
              f"worst err/tol K1 {k1_worst}, K2 {k2_worst}")
        rows.append(row)
    return rows


def phase_serving(psi2, psi_stats, psi2_contract):
    """Phase 4: config 1 in float32 on the card through the port's entry
    points. Returns (K1 launches, K3 launches by stage)."""
    from rgp_tpu_torch.data import datasets
    from rgp_tpu_torch.models import rgp

    data = datasets.actuator()
    d32 = datasets.standardized_tensors(data, dtype=torch.float32)
    cfg = rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=100)
    params = rgp.init_params(cfg, d32.Y, d32.U, seed=0)
    Y, U, Ut = d32.Y, d32.U, d32.U_test
    n_layers = cfg.n_hidden + 1
    check(Y.is_cuda and params["out"]["Z"].is_cuda, "entry points did not build on the card")

    psi2.launches = 0
    psi2.bwd_launches = 0
    psi_stats.plain_psi2_calls = 0
    stage, k3 = {}, {}

    def counted(name, fn):
        n1 = psi2.launches
        psi2_contract.launches = 0
        out = fn()
        torch.cuda.synchronize()
        stage[name], k3[name] = psi2.launches - n1, psi2_contract.launches
        return out

    with torch.no_grad():
        e32 = counted("elbo", lambda: rgp.elbo(cfg, params, Y, U, block=None))
        wh = counted("compute_whitenings", lambda: rgp.compute_whitenings(cfg, params, Y, U, block=None))
        pm, pv = counted("predict_train", lambda: rgp.predict_train(cfg, params, Y, U))
        fm, fv = counted("freerun", lambda: rgp.freerun(cfg, params, Y, U, Ut))
    launches, plain = psi2.launches, psi_stats.plain_psi2_calls
    T_star = int(Ut.shape[0])
    k3_want = {"elbo": 0, "compute_whitenings": 0, "predict_train": 1, "freerun": n_layers * T_star}
    print("serving launches", json.dumps({"k1": launches, "k2": psi2.bwd_launches, "per_stage": stage,
                                          "k3_per_stage": k3, "k3_want": k3_want, "plain_psi2_calls": plain}))
    check(psi2.bwd_launches == 0, f"serving launched K2 {psi2.bwd_launches} times")
    for name, n in stage.items():
        check(n >= n_layers, f"{name}: K1 launched {n} times, want >= {n_layers} (one per layer)")
    check(plain == 0, f"psi_statistics took the plain Psi2 path {plain} times on float32 CUDA")
    check(k3 == k3_want, f"K3 launches by stage {k3}, want {k3_want} (none in the bound, one per moment-matched "
          f"prediction of a layer: the output layer in predict_train, every layer a step in freerun)")

    check(e32.shape == () and bool(torch.isfinite(e32)), f"elbo not a finite scalar: {e32}")
    check(len(wh) == n_layers and all(bool(torch.isfinite(w.W).all()) for w in wh),
          "compute_whitenings: non-finite basis")
    T, T_star = Y.shape[0], Ut.shape[0]
    for name, (m, v), n in (("predict_train", (pm, pv), T), ("freerun", (fm, fv), T_star)):
        check(m.shape == (n, 1) and v.shape == (n, 1), f"{name}: shapes {m.shape}, {v.shape}")
        check(bool(torch.isfinite(m).all() and torch.isfinite(v).all() and (v > 0).all()),
              f"{name}: non-finite mean or non-positive variance")

    # the same parameters in float64 (plain path), for the record: at this
    # untrained init point the float32 bound is far from float64 in the JAX
    # reference too, so no gate applies here (the f32-lane gates run below at
    # the sizes the repo's own tests use)
    with torch.no_grad():
        e64 = float(rgp.elbo(cfg, _cast(params, torch.float64), Y.double(), U.double(), block=None))
    print("full-size f32 vs f64 elbo", json.dumps({"elbo32": float(e32), "elbo64": e64}))

    y_test = data.y_test[:, 0]
    pred = d32.sy.inverse(fm.double().cpu().numpy())[:, 0]
    rmse = float(np.sqrt(np.mean((pred - y_test) ** 2)))
    zero_rmse = float(np.sqrt(np.mean(y_test ** 2)))

    with torch.no_grad():
        freerun_ms = time_host_ms(lambda: rgp.freerun(cfg, params, Y, U, Ut), n=3)
        predict_ms = time_host_ms(lambda: rgp.predict_train(cfg, params, Y, U), n=10)
        profile_device(lambda: rgp.freerun(cfg, params, Y, U, Ut), "freerun", int(T_star))
        profile_readings(lambda: rgp.predict_train(cfg, params, Y, U), "predict_train")
    serving = {
        "config": "rgp1L_actuator_M100 float32 (init point, untrained)",
        "freerun_rmse": rmse, "zero_predictor_rmse": zero_rmse,
        "freerun_horizon_steps": int(T_star), "freerun_latency_ms": freerun_ms,
        "freerun_steps_per_s": T_star / (freerun_ms / 1e3),
        "predict_train_latency_ms": predict_ms,
    }
    print("serving", json.dumps(serving))
    return launches, k3


def phase_f32_lane(psi2):
    """Phase 4b: the repo's f32-lane gates (tests/test_f32_lane.py) on the
    card: float32 through K1 against float64 through the plain path, from the
    same float32 parameters, at the tests' sizes."""
    from rgp_tpu_torch.data import datasets
    from rgp_tpu_torch.data.windows import Standardizer
    from rgp_tpu_torch.models import rgp

    d = datasets.actuator()
    T = 128
    dev = torch.device("cuda")

    def std(a):
        return torch.as_tensor(Standardizer.fit(a).transform(a), dtype=torch.float32, device=dev)

    Y, U = std(d.y_train[:T]), std(d.u_train[:T])
    su = Standardizer.fit(d.u_train[:T])
    Ut = torch.as_tensor(su.transform(d.u_test[:64]), dtype=torch.float32, device=dev)
    n0 = psi2.launches
    with torch.no_grad():
        cfg = rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=32)
        p32 = rgp.init_params(cfg, Y, U, seed=0)
        e32 = float(rgp.elbo(cfg, p32, Y, U, block=None))
        e64 = float(rgp.elbo(cfg, _cast(p32, torch.float64), Y.double(), U.double(), block=None))
        cfg = rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=16)
        p32 = rgp.init_params(cfg, Y, U, seed=0)
        m32, v32 = rgp.freerun(cfg, p32, Y, U, Ut)
        m64, _ = rgp.freerun(cfg, _cast(p32, torch.float64), Y.double(), U.double(), Ut.double())
    rel = abs(e32 - e64) / (1.0 + abs(e64))
    traj = float(((m32.double() - m64) ** 2).mean().sqrt() / ((m64 ** 2).mean().sqrt() + 1e-9))
    print("f32 lane", json.dumps({"elbo32": e32, "elbo64": e64, "rel": rel,
                                  "freerun_rms_over_scale": traj, "k1_launches": psi2.launches - n0}))
    check(psi2.launches - n0 >= 4, "f32 lane did not go through K1")
    check(rel < 1e-3, f"f32 ELBO {e32} vs f64 {e64}: rel {rel} (gate 1e-3)")
    check(bool(torch.isfinite(m32).all() and (v32 > 0).all()), "f32 freerun not finite")
    check(traj < 5e-2, f"f32 freerun off f64 by rms/scale {traj} (gate 5e-2)")


def phase_training(psi2, psi_stats):
    """Phase 5: config-1 training in float32 on the card, through the port's
    benchmark entry points. Returns the launch counts of the timed call and
    the single-restart step: ms a step of the timed run, device ops a step."""
    from rgp_tpu_torch import train
    from rgp_tpu_torch.bench import config1
    from rgp_tpu_torch.models import rgp

    cfg, params, Y, U, Ut, sy, d = config1.setup(torch.float32)
    n_layers = cfg.n_hidden + 1
    config1.fit(cfg, params, Y, U, 20, 1e-2)  # warm-up: allocator, cuSOLVER, autograd
    torch.cuda.synchronize()

    psi2.launches = 0
    psi2.bwd_launches = 0
    psi_stats.plain_psi2_calls = 0
    p_fit, losses, ips = config1.timed_fit(cfg, params, Y, U, _TRAIN_STEPS, 1e-2, warmup=0)
    counts = {"k1": psi2.launches, "k2": psi2.bwd_launches, "plain_psi2_calls": psi_stats.plain_psi2_calls}
    refreshes = -(-_TRAIN_STEPS // config1.WHITEN_EVERY)
    print("training launches", json.dumps({**counts, "steps": _TRAIN_STEPS, "whitening_refreshes": refreshes}))
    check(counts["k2"] == n_layers * _TRAIN_STEPS,
          f"K2 launched {counts['k2']} times in {_TRAIN_STEPS} steps, want {n_layers} per step")
    check(counts["k1"] >= n_layers * _TRAIN_STEPS,
          f"K1 launched {counts['k1']} times in {_TRAIN_STEPS} steps, want >= {n_layers} per step")
    check(counts["plain_psi2_calls"] == 0, f"training took the plain Psi2 path {counts['plain_psi2_calls']} times")

    elbos = (-losses.double()).cpu().numpy()
    check(losses.shape == (_TRAIN_STEPS,) and bool(np.isfinite(elbos).all()), "a training loss is not finite")
    check(elbos[-1] > elbos[0], f"training did not raise the ELBO: {elbos[0]} -> {elbos[-1]}")
    with torch.no_grad():
        fm, fv = rgp.freerun(cfg, p_fit, Y, U, Ut)
    check(bool(torch.isfinite(fm).all() and (fv > 0).all()), "trained freerun not finite")
    pred = sy.inverse(fm.double().cpu().numpy())
    result = {
        "config": "rgp1L_actuator_M100 float32, cosine decay 1e-2 -> 1e-4, whitening every 100",
        "steps": _TRAIN_STEPS, "iters_per_s": ips, "ms_per_step": 1e3 / ips,
        "elbo_first": float(elbos[0]), "elbo_last": float(elbos[-1]),
        "freerun_rmse_trained": float(np.sqrt(np.mean((pred - d.y_test) ** 2))),
        "zero_predictor_rmse": float(np.sqrt(np.mean(d.y_test ** 2))),
    }
    print("training", json.dumps(result))

    # steady steps with fixed bases (a refresh is 1 step in 100): host time of
    # the forward bound, of forward + backward, and of whole Adam steps, each
    # ending in a synchronize; then one profiled run of 10 steps
    with torch.no_grad():
        wh = rgp.compute_whitenings(cfg, params, Y, U, block=None)
    leaves = [x.detach().clone().requires_grad_() for _, x in train.leaves_with_paths(params)]
    p = train.with_leaves(params, leaves)

    def loss():
        return -rgp.elbo(cfg, p, Y, U, block=None, whitening=wh)

    steps = 10
    split = {
        "forward_ms": time_host_ms(loss, n=20),
        "forward_backward_ms": time_host_ms(lambda: torch.autograd.grad(loss(), leaves), n=20),
        "adam_step_ms": time_host_ms(lambda: train.fit_adam(
            lambda q: -rgp.elbo(cfg, q, Y, U, block=None, whitening=wh), params, iters=steps,
            learning_rate=1e-2), n=3) / steps,
        "whitening_refresh_ms": time_host_ms(lambda: rgp.compute_whitenings(cfg, p, Y, U, block=None), n=10),
    }
    print("training step split", json.dumps(split))
    prof = profile_device(lambda: train.fit_adam(
        lambda q: -rgp.elbo(cfg, q, Y, U, block=None, whitening=wh), params, iters=steps,
        learning_rate=1e-2), "training steps", steps)
    return counts, {"ms_per_step": result["ms_per_step"], "device_ops_per_step": prof["device_ops_per_step"]}


def phase_restarts(psi2, psi_stats, single_step, card):
    """Phase 5c: config 1's restarts as one batch (``config1.fit_restarts``,
    ``bench.py``'s ``--restarts``) at ``_P5_RESTARTS`` restarts, float32,
    ``_P5_RESTART_STEPS`` steps: K1 and K2 one launch a layer a step for all
    restarts (K1 also one a layer a whitening refresh), the plain path never;
    every final ELBO finite; ms and device ops a step beside phase 5's single
    restart; the kept restart's freerun RMSE beside the zero predictor's.
    Then the same seeds one at a time through ``config1.fit`` for the same
    steps: each restart's batched final ELBO within the float32 order spread
    of its own, and the kept restart the same, or else a near tie (the two
    picks' batched ELBOs within that spread). Returns the launch counts."""
    from rgp_tpu_torch.bench import config1
    from rgp_tpu_torch.models import rgp
    from rgp_tpu_torch.params import leaves_with_paths

    cfg, _, Y, U, Ut, sy, d = config1.setup(torch.float32)
    n_layers = cfg.n_hidden + 1
    seeds, iters = range(_P5_RESTARTS), _P5_RESTART_STEPS
    inits = [rgp.init_params(cfg, Y, U, seed=s, dtype=Y.dtype) for s in seeds]
    config1.fit_batched(cfg, config1.stack_restarts(inits), Y, U, 2, 1e-2)  # warm-up
    torch.cuda.synchronize()
    _c5_zero(psi2, psi_stats)
    t0 = time.perf_counter()
    kept, elbos = config1.fit_restarts(cfg, Y, U, iters, 1e-2, seeds)
    wall = time.perf_counter() - t0
    counts = _c5_counts(psi2, psi_stats)
    refreshes = -(-iters // config1.WHITEN_EVERY)
    want = {"k1": n_layers * (iters + refreshes), "k2": n_layers * iters, "plain_psi2_calls": 0}
    prof = profile_device(lambda: config1.fit_batched(cfg, config1.stack_restarts(inits), Y, U, 5, 1e-2),
                          f"config1 restarts as one batch, {len(seeds)} restarts", 5)
    with torch.no_grad():
        fm, fv = rgp.freerun(cfg, kept, Y, U, Ut)
    pred = sy.inverse(fm.double().cpu().numpy())

    # the same seeds one at a time
    t1 = time.perf_counter()
    fits = [config1.fit(cfg, p, Y, U, iters, 1e-2) for p in inits]
    finals = [-float(f.losses[-1]) for f in fits]
    wall_single = time.perf_counter() - t1
    kept_single = config1.select_restart(cfg, finals, [f.params for f in fits])
    # the batched run's kept restart is the sequential restart nearest to it
    # (different seeds' trained parameters differ at O(1))
    flat = torch.cat([x.flatten() for _, x in leaves_with_paths(kept)])
    kept_batched = int(np.argmin([float((torch.cat([x.flatten() for _, x in leaves_with_paths(f.params)]) - flat)
                                        .abs().max()) for f in fits]))
    spread = _P5_ELBO_SPREAD
    row = {
        "restarts": len(seeds), "steps": iters, "whitening_refreshes": refreshes, "launches": counts,
        "k1_per_step": (counts["k1"] - n_layers * refreshes) / iters, "k2_per_step": counts["k2"] / iters,
        "ms_per_step": 1e3 * wall / iters, "device_ops_per_step": prof["device_ops_per_step"],
        "device_busy_share": prof["device_busy_share"],
        "single_restart_ms_per_step_phase5": single_step["ms_per_step"],
        "single_restart_device_ops_per_step_phase5": single_step["device_ops_per_step"],
        "final_elbos": elbos, "kept": kept_batched,
        "freerun_rmse_kept": float(np.sqrt(np.mean((pred - d.y_test) ** 2))),
        "zero_predictor_rmse": float(np.sqrt(np.mean(d.y_test ** 2))),
        "sequential": {"final_elbos": finals, "kept": kept_single, "seconds": wall_single,
                       "ms_per_restart_step": 1e3 * wall_single / (iters * len(seeds))},
        "elbo_gaps_batched_vs_sequential": [a - b for a, b in zip(elbos, finals)],
        "kept_elbo_gap": elbos[kept_batched] - finals[kept_single], "order_spread": spread, "card": card,
    }
    print("config1 restarts", json.dumps(row))
    if kept_batched != kept_single:
        print(f"config1 restarts: the guard kept restart {kept_batched} batched and {kept_single} one at a time "
              f"(batched ELBOs {elbos[kept_batched]} and {elbos[kept_single]})")
    check(counts == want, f"config1 restarts: launches {counts}, want {want} (one K1 and one K2 a layer a step)")
    check(all(math.isfinite(e) for e in elbos + finals), f"config1 restarts: a final ELBO is not finite: {row}")
    check(bool(torch.isfinite(fm).all() and (fv > 0).all()), "config1 restarts: the kept freerun is not finite")
    far = {r: g for r, g in enumerate(row["elbo_gaps_batched_vs_sequential"]) if not abs(g) <= spread}
    check(not far, f"config1 restarts: restarts {sorted(far)} end {far} from their sequential runs' final ELBOs, "
          f"beyond the float32 order spread {spread}")
    check(abs(row["kept_elbo_gap"]) <= spread,
          f"config1 restarts: the kept restart's ELBO {elbos[kept_batched]} is {row['kept_elbo_gap']} from the "
          f"sequential run's {finals[kept_single]}, beyond the float32 order spread {spread}")
    check(kept_batched == kept_single or abs(elbos[kept_batched] - elbos[kept_single]) <= spread,
          f"config1 restarts: the guard kept restart {kept_batched} batched and {kept_single} one at a time, "
          f"and they are no near tie")
    return counts


def phase_f32_lane_trained(psi2):
    """Phase 5b: tests/test_f32_lane.py's after-training gate on the card:
    config-2 shape, 20 float32 Adam steps through K1/K2, then the trained
    parameters' float32 ELBO against float64 (plain path)."""
    from rgp_tpu_torch import train
    from rgp_tpu_torch.data import datasets
    from rgp_tpu_torch.models import rgp

    d = datasets.standardized_tensors(datasets.drives(T=128, seed=7), dtype=torch.float32)
    Y, U = d.Y, d.U
    cfg = rgp.deep_rgp_config(wins=[0, 2, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=16)
    p32 = rgp.init_params(cfg, Y, U, dtype=torch.float32)
    n0 = psi2.bwd_launches
    res = train.fit_adam(lambda p: -rgp.elbo(cfg, p, Y, U, block=None), p32, iters=20, learning_rate=1e-2)
    k2 = psi2.bwd_launches - n0
    with torch.no_grad():
        e32 = float(rgp.elbo(cfg, res.params, Y, U, block=None))
        e64 = float(rgp.elbo(cfg, _cast(res.params, torch.float64), Y.double(), U.double(), block=None))
    rel = abs(e32 - e64) / (1.0 + abs(e64))
    print("f32 lane after training", json.dumps({"elbo32": e32, "elbo64": e64, "rel": rel, "k2_launches": k2,
                                                  "last_loss": float(res.losses[-1])}))
    check(k2 > 0, "the f32 training lane did not go through K2")
    check(bool(torch.isfinite(res.losses).all()), "a float32 training loss is not finite")
    check(rel < 1e-3, f"trained f32 ELBO {e32} vs f64 {e64}: rel {rel} (gate 1e-3)")


def phase_golden():
    """Phase 6: the float64 golden ELBO and trajectory on the card."""
    from rgp_tpu_torch import train
    from rgp_tpu_torch.data import datasets
    from rgp_tpu_torch.models import rgp

    d64 = datasets.standardized_tensors(datasets.actuator(), dtype=torch.float64)
    cfg = rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=50)
    params = rgp.init_params(cfg, d64.Y, d64.U, dtype=torch.float64, seed=0)
    with torch.no_grad():
        e0 = float(rgp.elbo(cfg, params, d64.Y, d64.U, block=None))
    rel = abs(e0 - _GOLDEN_E0) / abs(_GOLDEN_E0)
    print("golden f64", json.dumps({"elbo": e0, "golden": _GOLDEN_E0, "rel": rel}))
    check(rel <= 1e-8, f"f64 golden ELBO {e0} vs {_GOLDEN_E0}: rel {rel}")

    res = train.fit_adam(lambda p: rgp.neg_elbo(cfg, p, d64.Y, d64.U, block=None), params,
                         iters=50, learning_rate=1e-2)
    elbos = (-res.losses).cpu().numpy()
    traj = {i: {"elbo": float(elbos[i]), "golden": g, "rel": abs(elbos[i] - g) / abs(g)}
            for i, g in _GOLDEN_TRAJ.items()}
    print("golden f64 trajectory", json.dumps(traj))
    for i in (0, 9, 24):
        check(traj[i]["rel"] <= 1e-6, f"f64 golden trajectory step {i}: {traj[i]}")


def _harness_run(harness, task, method, **kw):
    """One ``harness.run``, its kept fit returned beside the record; every
    loss must be finite and the last ELBO above the first."""
    out, fit = harness.run(task, method, return_fit=True, **kw)
    losses = fit.res.losses.double().cpu().numpy()
    check(losses.shape == (kw["iters"],) and bool(np.isfinite(losses).all()), f"{method}: a loss is not finite")
    check(-losses[-1] > -losses[0], f"{method} did not raise the ELBO: {-losses[0]} -> {-losses[-1]}")
    return out, fit


def _steady_steps(fit, label, steps=10):
    """Host time per Adam step of the fit's own loss from its trained point,
    then one profiled run of ``steps``."""
    from rgp_tpu_torch import train

    def run():
        return train.fit_adam(fit.loss, fit.res.params, iters=steps, learning_rate=1e-2)

    ms = time_host_ms(run, n=3) / steps
    return ms, profile_device(run, label, steps)


def phase_configs_2_3(psi2, psi_stats):
    """Phase 7: configs 2 and 3 through the benchmark harness in float32 on
    the card, the counts set to 0 just before each run and read just after."""
    from rgp_tpu_torch.bench import harness

    psi2.launches = 0
    psi2.bwd_launches = 0
    psi_stats.plain_psi2_calls = 0
    c2, fit2 = _harness_run(harness, "drives", "rgp2_mlp", iters=_CONFIG2_STEPS, restarts=1)
    counts = {"k1": psi2.launches, "k2": psi2.bwd_launches, "plain_psi2_calls": psi_stats.plain_psi2_calls}
    print("config2 launches", json.dumps({**counts, "steps": _CONFIG2_STEPS}))
    n_layers = fit2.cfg.n_hidden + 1  # two hidden layers and the output
    check(n_layers == 3, f"config 2 has {n_layers} psi layers, want 3")
    check(counts["k2"] == n_layers * _CONFIG2_STEPS,
          f"config 2: K2 launched {counts['k2']} times in {_CONFIG2_STEPS} steps, want {n_layers} per step")
    check(counts["k1"] >= n_layers * _CONFIG2_STEPS,
          f"config 2: K1 launched {counts['k1']} times in {_CONFIG2_STEPS} steps, want >= {n_layers} per step")
    check(counts["plain_psi2_calls"] == 0, f"config 2 took the plain Psi2 path {counts['plain_psi2_calls']} times")

    # the harness's own freerun over the 250 test steps: finite means,
    # positive variances (its record gives only the RMSE)
    fm, fv = fit2.means, fit2.vars
    check(fm.shape == (250, 1) and bool(torch.isfinite(fm).all() and (fv > 0).all()),
          "config 2 freerun: non-finite mean or non-positive variance")

    ms_step, prof = _steady_steps(fit2, "config2 training steps")
    row = {"config": "rgp2_mlp drives T=250 M=100 float32, cosine decay 1e-2 -> 1e-4",
           "steps": _CONFIG2_STEPS, "iters_per_s_harness": c2["iters_per_sec"], "ms_per_step_steady": ms_step,
           "elbo_first": c2["elbo_first"], "elbo_last": c2["elbo_last"], "freerun_rmse": c2["freerun_rmse"],
           "zero_predictor_rmse": c2["zero_predictor_rmse"], "degenerate_reasons": c2["degenerate_reasons"],
           "wall_seconds": c2["wall_seconds"], "device_busy_share": prof["device_busy_share"],
           "device_ops_per_step": prof["device_ops_per_step"]}
    print("config2", json.dumps(row))
    print("config2 harness", json.dumps(c2))

    for method in ("gp_narx", "gp_narx_matern"):
        c3, fit3 = _harness_run(harness, "actuator", method, iters=_CONFIG3_STEPS, num_inducing=50)
        print("config3", json.dumps({k: c3[k] for k in (
            "method", "iters", "iters_per_sec", "wall_seconds", "elbo_first", "elbo_last", "freerun_rmse",
            "zero_predictor_rmse", "degenerate_reasons", "final_noise_min")}))
        check(np.isfinite(c3["freerun_rmse"]), f"config 3 {method}: freerun RMSE not finite")
        if method == "gp_narx":  # config 3's steady steps (RBF), as for config 2
            ms3, prof3 = _steady_steps(fit3, "config3 training steps")
            print("config3 steady", json.dumps({"method": method, "ms_per_step_steady": ms3,
                                                "device_busy_share": prof3["device_busy_share"],
                                                "device_ops_per_step": prof3["device_ops_per_step"]}))
    return counts


def _c4_steady(method, fit, data, steps=10):
    """Host time per training step of a config-4 route from its trained
    point, through the training loop the route uses (``fit_adam`` at a fixed
    whitening for the exact route, ``fit_minibatch`` at batch 512 with the
    clip, and the natural-gradient block for the SVGP routes; the EMA route's
    plain minibatch loss), then one profiled run of ``steps``."""
    from rgp_tpu_torch import train
    from rgp_tpu_torch.inference.collapsed_vi import whitening_basis

    p0 = fit.res.params
    if method == "gp_narx_collapsed":
        with torch.no_grad():
            wh = whitening_basis(fit.cfg.kernel.K(p0["kern"], p0["Z"]))

        def run():
            return train.fit_adam(lambda q: fit.loss(q, wh), p0, iters=steps, learning_rate=1e-4)
    else:
        ng = {"natgrad_block": "qu", "natgrad_lr": 0.005} if method.startswith("svgp") else {}

        def run():
            return train.fit_minibatch(fit.loss, p0, data, iters=steps, batch_size=_C4_BATCH, seed=1,
                                       learning_rate=1e-4, clip_norm=10.0, **ng)

    ms = time_host_ms(run, n=3) / steps
    return ms, profile_device(run, f"config4 {method} training steps", steps)


def phase_config4(psi2, psi_stats, card):
    """Phase 8: config 4's five routes through the harness in float32 on the
    card, the counts set to 0 just before and read just after the runs."""
    from rgp_tpu_torch.bench import harness
    from rgp_tpu_torch.data import datasets
    from rgp_tpu_torch.data.windows import narx_design

    d = datasets.standardized_tensors(datasets.long_corpus(), dtype=torch.float32)
    X, Yt = narx_design(d.Y, d.U, 10, 5)
    data = {"X": X, "Y": Yt}
    n_test = d.U_test.shape[0]
    psi2.launches = 0
    psi2.bwd_launches = 0
    psi_stats.plain_psi2_calls = 0
    fits = {}
    for method, steps in _C4_ROUTES.items():
        kw = {} if method == "gp_narx_collapsed" else {"batch_size": _C4_BATCH}
        rec, fit = harness.run("long_corpus", method, iters=steps, return_fit=True, **kw)
        print("config4 harness", json.dumps(rec))
        losses = fit.res.losses.double().cpu().numpy()
        check(losses.shape == (steps,), f"{method}: {losses.shape[0]} losses for {steps} steps")
        if method != "gp_narx_minibatch_ema":
            check(bool(np.isfinite(losses).all()), f"{method}: a loss is not finite")
            check(-losses[-1] > -losses[0], f"{method} did not raise the ELBO: {-losses[0]} -> {-losses[-1]}")
            check(fit.means.shape == (n_test, 1) and bool(torch.isfinite(fit.means).all()
                                                          and (fit.vars > 0).all()),
                  f"{method} freerun: non-finite mean or non-positive variance")
        fits[method] = (rec, fit)
    counts = {"k1": psi2.launches, "k2": psi2.bwd_launches, "plain_psi2_calls": psi_stats.plain_psi2_calls}
    print("config4 launches", json.dumps({**counts, "steps": sum(_C4_ROUTES.values())}))
    check(counts == {"k1": 0, "k2": 0, "plain_psi2_calls": 0},
          f"config 4 (certain inputs) reached the Psi2 time sum: {counts}")

    for method, (rec, fit) in fits.items():
        ms, prof = _c4_steady(method, fit, data)
        row = {"method": method, "steps": rec["iters"], "cut": "300 of all.py's 1000 quick-budget steps"
               if rec["iters"] == 300 else None, "batch_size": None if method == "gp_narx_collapsed" else _C4_BATCH,
               "iters_per_s_harness": rec["iters_per_sec"], "wall_seconds": rec["wall_seconds"],
               "ms_per_step_steady": ms, "device_ops_per_step": prof["device_ops_per_step"],
               "device_busy_share": prof["device_busy_share"], "elbo_first": rec["elbo_first"],
               "elbo_last": rec["elbo_last"], "freerun_rmse": rec["freerun_rmse"],
               "zero_predictor_rmse": rec["zero_predictor_rmse"], "degenerate_reasons": rec["degenerate_reasons"],
               "final_noise_min": rec["final_noise_min"], "card": card}
        if method in _C4_TIMED_FREERUNS:
            row["freerun_steps"] = n_test
            row["freerun_wall_s"] = time_host_ms(fit.freerun, n=1) / 1e3
        print("config4", json.dumps(row))
    return counts


def phase_svgp_uncertain(psi2, psi_stats):
    """Phase 8b: one ``svgp.elbo`` with uncertain inputs, forward and
    backward, on float32 CUDA tensors: exactly one K1 and one K2 launch. The
    Psi2 that K1 gave inside it is held against the plain version in float64
    at K1's tolerance, and the gradient of Z through K2 (the VJP of the Psi2
    sum at the cotangent the bound handed K2) against the plain float64 VJP
    at the same cotangent at K2's; the ELBO against the float64 plain bound at
    K1's relative 2e-4. The whole gradient of Z is printed against the
    float64 plain one beside the float32 plain one's error: the float32
    bound's Z gradient is a sum of path contributions ~10x its size, so its
    rounding alone exceeds K2's tolerance, kernel or no kernel (CPU: float32
    plain against float64, 55x). Returns the launch counts."""
    from rgp_tpu_torch.inference import svi
    from rgp_tpu_torch.kernels import RBF
    from rgp_tpu_torch.models import svgp
    from rgp_tpu_torch.ops.psi_stats import PsiStats, psi01

    T, M, Q = _SVGP_UNCERTAIN
    dev = torch.device("cuda")
    rng = np.random.default_rng(400)
    X = torch.as_tensor(rng.standard_normal((T, Q)), dtype=torch.float32, device=dev)
    Xv = torch.as_tensor(rng.uniform(0.05, 0.4, (T, Q)), dtype=torch.float32, device=dev)
    Y = torch.sin(X.sum(-1, keepdim=True) / math.sqrt(Q))
    cfg = svgp.SVGPConfig(RBF(input_dim=Q), M)
    # lengthscale sqrt(Q) keeps Psi2 entries O(1) at this width
    params = svgp.init_params(cfg, X, seed=0, lengthscale=math.sqrt(Q))

    # the Psi2 that svgp.elbo's K1 produces, kept to read its cotangent
    captured = []
    kernel_sum = psi_stats.rbf_psi2_sum

    def capture(*args):
        out = kernel_sum(*args)
        out.retain_grad()
        captured.append(out)
        return out

    Z = params["Z"].clone().requires_grad_(True)
    psi2.launches = 0
    psi2.bwd_launches = 0
    psi_stats.plain_psi2_calls = 0
    psi_stats.rbf_psi2_sum = capture
    try:
        e = svgp.elbo(cfg, {**params, "Z": Z}, X, Y, X_var=Xv)
        e.backward()
        e = e.detach()
    finally:
        psi_stats.rbf_psi2_sum = kernel_sum
    torch.cuda.synchronize()
    counts = {"k1": psi2.launches, "k2": psi2.bwd_launches, "plain_psi2_calls": psi_stats.plain_psi2_calls}
    check(counts == {"k1": 1, "k2": 1, "plain_psi2_calls": 0} and len(captured) == 1,
          f"svgp.elbo with uncertain inputs: launches {counts}, want one K1 and one K2")
    psi2_k, G = captured[0].detach(), captured[0].grad

    def plain_bound(dtype):
        q = _cast(params, dtype)
        Zp = q["Z"].clone().requires_grad_(True)
        mu, s, y = X.to(dtype), Xv.to(dtype), Y.to(dtype)
        psi0, psi1 = psi01(cfg.kernel, q["kern"], Zp, mu, s)
        p2 = psi_stats._rbf_psi2_sum_chunked(q["kern"], Zp, mu, s, 128)
        ep = svi.svi_bound(cfg.kernel, q["kern"], Zp, q["log_noise"], q["qu"], PsiStats(psi0, psi1, p2), y)
        (gz,) = torch.autograd.grad(ep, Zp)
        return ep.detach(), gz, p2.detach()

    e64, gz64, psi2_64 = plain_bound(torch.float64)
    _, gz32, _ = plain_bound(torch.float32)
    ok_k1, err_k1, worst_k1 = _within(psi2_k, psi2_64, rel=2e-4, rel_max=2e-5)
    # the gradient of Z through the Psi2 sum at the bound's cotangent G:
    # K2 (float32) against the plain float64 VJP of the same sum
    q64 = _cast(params, torch.float64)
    Zk = params["Z"].clone().requires_grad_(True)
    (vjp_k,) = torch.autograd.grad(psi2.rbf_psi2_sum(params["kern"], Zk, X, Xv), Zk, grad_outputs=G)
    Z64 = q64["Z"].clone().requires_grad_(True)
    (vjp_64,) = torch.autograd.grad(
        psi_stats._rbf_psi2_sum_chunked(q64["kern"], Z64, X.double(), Xv.double(), 128), Z64,
        grad_outputs=G.double())
    ok_k2, err_k2, worst_k2 = _within(vjp_k, vjp_64)
    rel_e = abs(float(e) - float(e64)) / abs(float(e64))
    err_total = float((Z.grad.double() - gz64).abs().max())
    err_total32 = float((gz32.double() - gz64).abs().max())
    row = {"T": T, "M": M, "Q": Q, "launches": counts, "elbo": float(e), "elbo_plain_f64": float(e64),
           "elbo_rel_err": rel_e, "psi2_k1": {"max_abs_err": err_k1, "worst_err_over_tol": worst_k1},
           "grad_Z_through_k2": {"max_abs_err": err_k2, "worst_err_over_tol": worst_k2,
                                 "max_abs": float(vjp_64.abs().max())},
           "grad_Z_total": {"max_abs": float(gz64.abs().max()), "max_abs_err_k1k2_f32": err_total,
                            "max_abs_err_plain_f32": err_total32}}
    print("svgp uncertain elbo", json.dumps(row))
    check(bool(torch.isfinite(e)) and rel_e <= 2e-4, f"svgp.elbo through K1 {float(e)} vs plain {float(e64)}")
    check(ok_k1, f"svgp.elbo's Psi2 from K1 disagrees with the plain version: worst err/tol {worst_k1}")
    check(ok_k2, f"svgp.elbo's grad Z through K2 disagrees with the plain VJP: worst err/tol {worst_k2}")
    check(bool(torch.isfinite(Z.grad).all()), "svgp.elbo's grad Z is not finite")
    return counts


def _c5_counts(psi2, psi_stats):
    return {"k1": psi2.launches, "k2": psi2.bwd_launches, "plain_psi2_calls": psi_stats.plain_psi2_calls}


def _c5_zero(psi2, psi_stats):
    psi2.launches = 0
    psi2.bwd_launches = 0
    psi_stats.plain_psi2_calls = 0


def phase_config5_potential(psi2, psi_stats, root, card):
    """Phase 9a: the config-5 potential at the anchor (float64) and at 128
    of the JAX package's draws, batched, on both Psi2 routes (float32).
    Returns the launch counts of the ``auto`` route's one batched
    value-and-gradient."""
    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.sample.api import make_rgp_potential
    from rgp_tpu_torch.sample.hmc import value_and_grad

    dev = torch.device("cuda")
    anchor = os.path.join(root, _C5_ANCHOR)
    cfg, p64, Y64, U64, _, _ = _flagship(0, torch.float64, anchor)
    pot64, flat64, _, b64 = make_rgp_potential(cfg, p64, Y64, U64, block=64, psi_prefer="scan",
                                                fixed_whitening=True)
    with torch.no_grad():
        u_anchor = float(pot64(flat64))
    print("config5 anchor", json.dumps({"U_f64_frozen": u_anchor, "artifact": _C5_U_ANCHOR, "card": card}))
    check(abs(u_anchor - _C5_U_ANCHOR) <= 0.05,
          f"frozen f64 potential at the anchor {u_anchor}, surrogate_check_r5.json has {_C5_U_ANCHOR}")

    with np.load(os.path.join(root, _C5_TPU_DRAWS)) as z:
        points = z["draws"][:_C5_CHAINS, -1]  # the last draw of each of the first 128 chains
    Z64 = torch.tensor(points, dtype=torch.float64, device=dev)
    # float64 reference, 32 chains at a time (no per-chunk recompute under vmap)
    ref = [value_and_grad(b64, Z64[i:i + 32]) for i in range(0, _C5_CHAINS, 32)]
    u64, g64 = torch.cat([r[0] for r in ref]), torch.cat([r[1] for r in ref])
    del ref, b64, pot64

    cfg32, p32, Y32, U32, _, _ = _flagship(0, torch.float32, anchor)
    Z32 = torch.tensor(points, dtype=torch.float32, device=dev)
    rows, counts = {}, {}
    for route in ("scan", "auto"):
        _, _, _, batched = make_rgp_potential(cfg32, p32, Y32, U32, block=32, psi_prefer=route,
                                              fixed_whitening=True)
        value_and_grad(batched, Z32)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _c5_zero(psi2, psi_stats)
        u, g = value_and_grad(batched, Z32)
        torch.cuda.synchronize()
        counts[route] = _c5_counts(psi2, psi_stats)
        peak = torch.cuda.max_memory_allocated()
        ms = time_host_ms(lambda: value_and_grad(batched, Z32), n=3)
        prof = profile_device(lambda: value_and_grad(batched, Z32), f"config5 potential {route}", 1)
        u_err = (u.double() - u64).abs()
        g_err = (g.double() - g64).abs()
        rows[route] = {
            "route": route, "chains": _C5_CHAINS, "launches": counts[route], "ms_per_value_and_grad": ms,
            "device_ops": prof["device_ops"], "device_busy_share": prof["device_busy_share"],
            "peak_memory_bytes": peak, "value_max_abs_err_vs_f64": float(u_err.max()),
            "value_median_abs_err_vs_f64": float(u_err.median()), "grad_max_abs_err_vs_f64": float(g_err.max()),
            "grad_max_abs_f64": float(g64.abs().max()), "finite": bool(torch.isfinite(u).all()
                                                                       and torch.isfinite(g).all()),
            "card": card,
        }
        print("config5 potential", json.dumps(rows[route]))
        del batched
        torch.cuda.empty_cache()
    n_layers = cfg32.n_hidden + 1
    check(counts["auto"] == {"k1": n_layers, "k2": n_layers, "plain_psi2_calls": 0},
          f"auto potential at {_C5_CHAINS} chains: launches {counts['auto']}, want one K1 and one K2 a layer "
          f"for all chains (the batched kernels) and no plain path")
    check(counts["scan"]["k1"] == 0 and counts["scan"]["k2"] == 0 and counts["scan"]["plain_psi2_calls"] > 0,
          f"scan potential: launches {counts['scan']}, want the plain path only")
    plain = rows["scan"]
    check(plain["value_median_abs_err_vs_f64"] <= 1.0,
          f"config 5 plain float32 potential: median {plain['value_median_abs_err_vs_f64']} nats from float64")
    for route, row in rows.items():
        check(row["finite"], f"config 5 {route} potential: non-finite value or gradient")
        for what in ("value", "grad"):
            key = f"{what}_max_abs_err_vs_f64"
            check(row[key] <= 2.0 * plain[key],
                  f"config 5 {route} potential: {what} error {row[key]} above twice the plain float32 "
                  f"route's {plain[key]}")
    return counts["auto"]


def phase_config5_nuts(psi2, psi_stats, root, card):
    """Phase 9b: the NUTS twin at half the quick budget, the JAX protocol."""
    from rgp_tpu_torch.bench.posterior_check import compare_draws
    from rgp_tpu_torch.bench.sampling import bench_nuts

    _c5_zero(psi2, psi_stats)
    rec, draws, diverging = bench_nuts(_C5_CHAINS, _C5_WARMUP, _C5_DRAWS, 6, 0,
                                       params_npz=os.path.join(root, _C5_ANCHOR), return_draws=True)
    counts = _c5_counts(psi2, psi_stats)
    print("config5 nuts launches", json.dumps(counts))
    print("config5 nuts", json.dumps(rec))
    for path, note in ((_C5_TPU_DRAWS, "the same f32 frozen-basis surrogate"),
                       (_C5_CPU_DRAWS, "f64 fresh-basis chain, another surrogate: information only")):
        with np.load(os.path.join(root, path)) as z:
            stats = compare_draws(draws, diverging, z["draws"], z["diverging"])
        print("config5 nuts moments", json.dumps({"against": path, "note": note, **stats, "card": card}))
    check(draws.shape == (_C5_CHAINS, _C5_DRAWS, 25) and bool(np.isfinite(draws).all()),
          f"config 5 NUTS: draws of shape {draws.shape}, or not finite")
    eps = rec["details"]["step_size_per_group"]
    check(min(eps) >= 1e-2, f"config 5 NUTS: the step size collapsed to {eps}")
    # scan: K1 only for the frozen whitening's ladder pass at the anchor, one per layer
    check(counts["k1"] == 2 and counts["k2"] == 0, f"config 5 NUTS twin (scan) launches: {counts}")
    return rec


def phase_config5_sample_nuts(psi2, psi_stats, root, card):
    """Phase 9c: the port's own few-chain config-5 path through K1/K2."""
    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.sample.api import sample_nuts

    cfg, params, Y, U, _, _ = _flagship(0, torch.float32, os.path.join(root, _C5_ANCHOR))
    _c5_zero(psi2, psi_stats)
    t0 = time.perf_counter()
    res = sample_nuts(cfg, params, Y, U, 0, n_samples=4, n_warmup=6, n_chains=4, max_depth=5,
                      hessian_precondition=True)
    s = res.samples.cpu().numpy()
    wall = time.perf_counter() - t0
    counts = _c5_counts(psi2, psi_stats)
    row = {"chains": 4, "n_warmup": 6, "n_samples": 4, "max_depth": 5, "wall_seconds": wall,
           "launches": counts, "mean_accept": float(res.accept_prob.mean()),
           "divergence_rate": float(res.diverging.double().mean()), "step_size": float(res.step_size),
           "card": card}
    print("config5 sample_nuts", json.dumps(row))
    check(bool(np.isfinite(s).all()), "config 5 sample_nuts: a draw is not finite")
    check(counts["k1"] > 0 and counts["k2"] > 0, f"config 5 sample_nuts did not reach K1 and K2: {counts}")
    return counts


def phase_config5_smc(card):
    """Phase 9d: the SMC twin at 1024 particles."""
    from rgp_tpu_torch.bench.sampling import bench_smc

    rec, res = bench_smc(_C5_SMC_PARTICLES, 300, return_result=True)
    print("config5 smc", json.dumps({**rec, "min_ess": float(res.ess_history.min()), "card": card}))
    check(bool(torch.isfinite(res.log_marginal)), f"config 5 SMC: log-marginal {float(res.log_marginal)}")
    check(bool((res.ess_history > 0).all()), "config 5 SMC: a step's ESS is 0")
    return rec


def _tempered_particles(flat0, n, seed=0):
    """``n`` draws from ``sample_tempered``'s prior: N(flat0, 3^2), on a
    generator on the card."""
    gen = torch.Generator(device=flat0.device).manual_seed(seed)
    return flat0[None, :] + _C5_PRIOR_STD * torch.randn((n, flat0.shape[0]), generator=gen, dtype=flat0.dtype,
                                                         device=flat0.device)


def _ladder_rung(wh):
    """The floor ladder's rung behind the whitening ``wh`` as a 0-d tensor (0,
    1 or 2 for the spectral floor times 1, 1e3, 1e6), read off the basis:
    where the floor clamps the spectrum, lambda_eff's smallest over its
    largest is the floor. -1 where it clamps nothing. Tensor dataflow only, so
    it runs under ``torch.func.vmap``."""
    from rgp_tpu_torch.inference.collapsed_vi import default_spectral_floor

    lam_eff = 1.0 / (wh.W * wh.W).sum(0)
    rung = torch.round(torch.log10(lam_eff.min() / lam_eff.max() / default_spectral_floor(wh.W.dtype)) / 3.0)
    return torch.where((wh.topup > 0).any(), rung, torch.full_like(rung, -1.0))


@contextlib.contextmanager
def _rung_spies():
    """A list that fills, while the block runs, with the rung each ladder of
    the collapsed bound takes: per layer, the whitening's floor rung (see
    :func:`_ladder_rung`), then the jitter rungs (0, 3, 7 for the base
    jitter times 1, 1e3, 1e7) of its two Cholesky factorizations, Kt's and
    Ct's. The ladders are read by spies put in place of ``whitening_basis``
    and ``jitchol`` in ``collapsed_vi``, where the bound looks them up; the
    records are tensors (they run under ``torch.func.vmap`` too)."""
    from rgp_tpu_torch import linalg
    from rgp_tpu_torch.inference import collapsed_vi

    records = []
    basis, chol = collapsed_vi.whitening_basis, collapsed_vi.jitchol

    def spy_basis(*args, **kw):
        wh = basis(*args, **kw)
        records.append(_ladder_rung(wh))
        return wh

    def spy_chol(A, jitter0=1e-6):
        L, jitter = linalg.jitchol_with_jitter(A, jitter0)
        scale = torch.clamp(torch.diagonal(A).mean(), min=1e-30)
        records.append(torch.round(torch.log10(jitter / (jitter0 * scale))).detach())
        return L

    collapsed_vi.whitening_basis, collapsed_vi.jitchol = spy_basis, spy_chol
    try:
        yield records
    finally:
        collapsed_vi.whitening_basis, collapsed_vi.jitchol = basis, chol


def _batched_rungs(cfg, params, Y, U, V, route, block=32):
    """One batched tempered log-likelihood of the particles ``V`` on a route
    (``auto`` reads Psi2 from K1, ``scan`` from the plain path summed in
    chunks of ``block`` time steps), with the rungs each ladder took for each
    particle in that batch (:func:`_rung_spies`). Returns (values (N,),
    rungs (N, 3 x layers))."""
    from rgp_tpu_torch.sample.api import _hyper_elbo

    hyper_elbo = _hyper_elbo(cfg, params, Y, U, block=None if route == "auto" else block, psi_prefer=route)[0]
    n_rungs = 3 * (cfg.n_hidden + 1)
    with _rung_spies() as records:
        def one(v):
            records.clear()
            value = hyper_elbo(v, False)
            check(len(records) == n_rungs, f"the rung spies read {len(records)} ladders, want {n_rungs}: the "
                  f"bound no longer looks up whitening_basis and jitchol in collapsed_vi")
            return value, torch.stack(records)

        with torch.no_grad():
            return torch.func.vmap(one)(V)


def _psi2_batch(cfg, params, Y, U, unravel, V, route):
    """Each layer's Psi2 time sum at every particle of ``V`` on a route,
    batched as the log-likelihood batches it: a tuple of (N, M, M)."""
    from rgp_tpu_torch.models import rgp
    from rgp_tpu_torch.sample.api import merge_hypers

    def one(v):
        p = merge_hypers(params, unravel(v))
        return tuple(stats.psi2 for _, _, stats, *_ in
                     rgp._layer_stats(cfg, p, Y, U, None if route == "auto" else 32, route, False))

    with torch.no_grad():
        return torch.func.vmap(one)(V)


def _psi2_worst(psi2_32, psi2_64, rel=2e-4, rel_max=2e-5):
    """Per particle and layer, the worst |x - x64| over ``_within``'s
    tolerance rel |x64| + rel_max max|x64| (inf where x is not finite):
    (N, layers)."""
    cols = []
    for a, b in zip(psi2_32, psi2_64):
        tol = rel * b.abs() + rel_max * b.abs().amax((1, 2), keepdim=True)
        worst = ((a.double() - b).abs() / tol.clamp(min=1e-300)).amax((1, 2))
        cols.append(torch.where(torch.isfinite(a).flatten(1).all(1), worst, torch.full_like(worst, math.inf)))
    return torch.stack(cols, 1)


def phase_tempered_loglik(psi2, psi_stats, root, card):
    """Phase 10a: one batched tempered log-likelihood at 512 particles from
    ``sample_tempered``'s prior around the anchor, on both Psi2 routes
    (float32), held against each other and against float64 at every
    particle. Returns the launch counts of the ``auto`` route's call."""
    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.models import rgp
    from rgp_tpu_torch.params import leaves_with_paths, positive, with_leaves
    from rgp_tpu_torch.sample.api import make_rgp_loglik

    anchor = os.path.join(root, _C5_ANCHOR)
    cfg, p32, Y32, U32, _, _ = _flagship(0, torch.float32, anchor)
    n_layers = cfg.n_hidden + 1
    out, counts, rows = {}, {}, {}
    for route in ("auto", "scan"):
        loglik, flat0, unravel = make_rgp_loglik(cfg, p32, Y32, U32, psi_prefer=route,
                                                 block=None if route == "auto" else 32)
        V = _tempered_particles(flat0, _C5_TEMPERED_PARTICLES)  # the same draws on both routes
        loglik(V)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _c5_zero(psi2, psi_stats)
        out[route] = loglik(V)
        torch.cuda.synchronize()
        counts[route] = _c5_counts(psi2, psi_stats)
        peak = torch.cuda.max_memory_allocated()
        ms = time_host_ms(lambda: loglik(V), n=3)
        prof = profile_device(lambda: loglik(V), f"tempered loglik {route}", 1)
        rows[route] = {"route": route, "particles": _C5_TEMPERED_PARTICLES, "launches": counts[route],
                       "ms_per_call": ms, "device_ops": prof["device_ops"],
                       "device_busy_share": prof["device_busy_share"], "peak_memory_bytes": peak,
                       "non_finite": int((~torch.isfinite(out[route])).sum()), "card": card}
        print("tempered loglik", json.dumps(rows[route]))
        del loglik
        torch.cuda.empty_cache()
    check(counts["auto"] == {"k1": n_layers, "k2": 0, "plain_psi2_calls": 0},
          f"tempered loglik auto at {_C5_TEMPERED_PARTICLES} particles: launches {counts['auto']}, want one K1 a "
          f"layer for all particles, no K2 and no plain path")
    check(counts["scan"]["k1"] == 0 and counts["scan"]["k2"] == 0 and counts["scan"]["plain_psi2_calls"] > 0,
          f"tempered loglik scan: launches {counts['scan']}, want the plain path only")

    # Every particle again, on both float32 routes and on the plain route in
    # float64 at the same float32 inputs (the anchor and the draws widened, so
    # that only the arithmetic differs), with the rungs each ladder took. The
    # float32 rung passes must give the timed calls' bits. Where all three
    # take the same rungs, the float32 routes evaluate float64's regularized
    # model and are held to it. The prior's draws reach ELBOs of -1e6, where
    # float32 is tens of nats off float64, so the gaps are relative,
    # |x - e64| / (1 + |e64|) as in the repo's f32-lane gate, under phase 9a's
    # rule: the plain float32 route's median gap within the lane's 1e-3, and
    # its gaps the yardstick of the kernel route's over the same particles.
    # Near a rung's edge the factor at that rung is near-singular in float32,
    # so even there a route's value follows the rounding of Psi2 by up to a
    # few tenths relative. A particle whose rungs differ evaluates another
    # model (float32 rounding decides a trial Cholesky), a cliff of up to
    # thousands of nats: it is counted and printed, and K1's Psi2 is held to
    # float64 there as at every other particle.
    p64 = with_leaves(p32, [x.double() for _, x in leaves_with_paths(p32)])
    Y64, U64 = Y32.double(), U32.double()
    _, _, unravel64 = make_rgp_loglik(cfg, p64, Y64, U64, psi_prefer="scan", block=32)
    batch, rungs = {}, {}
    for route in out:
        batch[route], rungs[route] = _batched_rungs(cfg, p32, Y32, U32, V, route)
    e64, rungs["f64"] = _batched_rungs(cfg, p64, Y64, U64, V.double(), "scan")
    # the plain route again with another order of the same float32 sum (time
    # chunks of 64), to show how far rounding order alone moves the bound
    scan64, rungs["scan_block64"] = _batched_rungs(cfg, p32, Y32, U32, V, "scan", block=64)
    torch.cuda.empty_cache()
    same_bits = {route: bool(torch.equal(batch[route], out[route])) for route in out}
    route_flip = (rungs["auto"] != rungs["scan"]).any(1)
    dtype_flip = (rungs["scan"] != rungs["f64"]).any(1)
    ok64 = torch.isfinite(e64)
    same = ok64 & ~route_flip & ~dtype_flip
    same_order = same & (rungs["scan_block64"] == rungs["scan"]).all(1)
    rel = {route: (batch[route].double() - e64).abs() / (1.0 + e64.abs()) for route in out}
    gap = (batch["auto"].double() - batch["scan"].double()).abs() / (1.0 + batch["scan"].double().abs())
    gap_order = (scan64.double() - batch["scan"].double()).abs() / (1.0 + batch["scan"].double().abs())

    # K1's Psi2 at every particle against the plain float64 Psi2, in units of
    # K1's tolerance. Lengthscales of e^-6 from the prior amplify float32
    # rounding past that tolerance on the plain path too, so the plain
    # float32 Psi2 is the yardstick, particle by particle as phase 9a's rule
    # holds a route: K1 within twice its error, or within the tolerance
    psi2_64 = _psi2_batch(cfg, p64, Y64, U64, unravel64, V.double(), "scan")
    k1_worst = _psi2_worst(_psi2_batch(cfg, p32, Y32, U32, unravel, V, "auto"), psi2_64)
    plain_worst = _psi2_worst(_psi2_batch(cfg, p32, Y32, U32, unravel, V, "scan"), psi2_64)
    del psi2_64
    torch.cuda.empty_cache()

    def detail(i):
        hyp = unravel64(V[i].double())
        betas = [float(1.0 / positive(rgp._fln(cfg, h["log_noise"])))
                 for h in [*hyp["layers"], hyp["out"]]]
        return {"particle": i, "auto": float(batch["auto"][i]), "scan": float(batch["scan"][i]),
                "scan_block64": float(scan64[i]), "f64": float(e64[i]),
                "rungs_auto": rungs["auto"][i].int().tolist(),
                "rungs_scan": rungs["scan"][i].int().tolist(),
                "rungs_scan_block64": rungs["scan_block64"][i].int().tolist(), "rungs_f64": rungs["f64"][i].int().tolist(),
                "beta_per_layer": betas, "k1_psi2_worst_err_over_tol": k1_worst[i].tolist(),
                "plain_psi2_worst_err_over_tol": plain_worst[i].tolist()}

    def argmax_at(x, mask):
        return int(torch.where(mask, x, torch.full_like(x, -1.0)).argmax())

    yard = float(rel["scan"][same].max())
    row = {"particles": _C5_TEMPERED_PARTICLES, "f64_finite": int(ok64.sum()),
           "value_f64_range": [float(e64[ok64].min()), float(e64[ok64].max())],
           "rung_pass_gives_the_same_bits": same_bits,
           "route_flips": int(route_flip.sum()), "f32_f64_flips": int((dtype_flip & ~route_flip).sum()),
           "same_rungs": int(same.sum()),
           "scan_vs_f64_rel": {"max_same_rungs": yard, "median": float(rel["scan"][ok64].median()),
                               "max": float(rel["scan"][ok64].max())},
           "auto_vs_f64_rel": {"max_same_rungs": float(rel["auto"][same].max()),
                               "median": float(rel["auto"][ok64].median()), "max": float(rel["auto"][ok64].max())},
           "auto_vs_scan_rel": {"max_same_rungs": float(gap[same].max()),
                                "median": float(gap[torch.isfinite(gap)].median())},
           "scan_block64_vs_scan_rel": {"same_rungs": int(same_order.sum()),
                                        "max_same_rungs": float(gap_order[same_order].max()),
                                        "median": float(gap_order[torch.isfinite(gap_order)].median())},
           "k1_psi2_vs_f64_worst_err_over_tol": float(k1_worst.max()),
           "plain_psi2_vs_f64_worst_err_over_tol": float(plain_worst.max()),
           "k1_psi2_over_yardstick": float((k1_worst / torch.clamp(2.0 * plain_worst, min=1.0)).max()),
           "plain_psi2_beyond_tol_particles": int((plain_worst > 1.0).any(1).sum()),
           "card": card}
    print("tempered loglik vs f64", json.dumps(row))
    for what, i in (("worst scan vs f64, same rungs", argmax_at(rel["scan"], same)),
                    ("worst auto vs f64, same rungs", argmax_at(rel["auto"], same)),
                    ("worst auto vs scan, same rungs", argmax_at(gap, same)),
                    ("worst scan block 64 vs scan, same rungs", argmax_at(gap_order, same_order)),
                    ("worst scan vs f64", argmax_at(rel["scan"], ok64))):
        print("tempered loglik worst", json.dumps({"what": what, **detail(i)}))
    for i in torch.nonzero(route_flip).flatten().tolist():
        print("tempered loglik flip", json.dumps(detail(i)))
    check(all(same_bits.values()), f"the rung passes do not give the timed calls' values: {same_bits}")
    check(int(ok64.sum()) == _C5_TEMPERED_PARTICLES,
          f"the float64 tempered log-likelihood is not finite at {_C5_TEMPERED_PARTICLES - int(ok64.sum())} "
          f"of {_C5_TEMPERED_PARTICLES} particles")
    k1_over = (k1_worst / torch.clamp(2.0 * plain_worst, min=1.0)).amax(1)
    check(row["k1_psi2_over_yardstick"] <= 1.0,
          f"K1's Psi2 is off the float64 plain Psi2 at particle {int(k1_over.argmax())}: "
          f"{detail(int(k1_over.argmax()))}, beyond twice the plain float32 Psi2's error and K1's tolerance")
    check(row["scan_vs_f64_rel"]["median"] <= 1e-3,
          f"plain float32 tempered log-likelihood: median relative gap {row['scan_vs_f64_rel']['median']} to "
          f"float64 (gate 1e-3)")
    check(row["auto_vs_f64_rel"]["median"] <= 2.0 * row["scan_vs_f64_rel"]["median"],
          f"auto tempered log-likelihood: median relative gap {row['auto_vs_f64_rel']['median']} to float64, "
          f"above twice the plain float32 route's {row['scan_vs_f64_rel']['median']}")
    check(row["auto_vs_f64_rel"]["max_same_rungs"] <= 2.0 * yard,
          f"auto tempered log-likelihood: relative gap {row['auto_vs_f64_rel']['max_same_rungs']} to float64 "
          f"where every route takes float64's rungs, above twice the plain float32 route's {yard} there")
    check(row["auto_vs_scan_rel"]["median"] <= 2.0 * row["scan_vs_f64_rel"]["median"],
          f"auto against scan at {_C5_TEMPERED_PARTICLES} particles: median relative gap "
          f"{row['auto_vs_scan_rel']['median']}, above twice the plain route's median gap to float64")
    return counts["auto"], rows


def phase_tempered_smc(psi2, psi_stats, root, card):
    """Phase 10b: ``sample_tempered`` at 512 particles with the reference's
    defaults on the anchor (float32, K1 through the vmap rule). Returns the
    launch counts."""
    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.models import rgp
    from rgp_tpu_torch.sample.api import merge_hypers, sample_tempered

    cfg, params, Y, U, _, _ = _flagship(0, torch.float32, os.path.join(root, _C5_ANCHOR))
    n_layers = cfg.n_hidden + 1
    gen = torch.Generator(device=Y.device).manual_seed(0)
    _c5_zero(psi2, psi_stats)
    t0 = time.perf_counter()
    res, unravel = sample_tempered(cfg, params, Y, U, gen, n_particles=_C5_TEMPERED_PARTICLES,
                                   prior_std=_C5_PRIOR_STD, max_stages=50, ess_target=0.5, n_moves=3,
                                   step_scale=0.5)
    log_z = float(res.log_Z)  # the host read that ends the run
    wall = time.perf_counter() - t0
    counts = _c5_counts(psi2, psi_stats)
    evals = 1 + 3 * res.n_stages
    with torch.no_grad():
        e_anchor = float(rgp.elbo(cfg, params, Y, U, block=None))
        e_mean = float(rgp.elbo(cfg, merge_hypers(params, unravel(res.particles.mean(0))), Y, U, block=None))
    betas = res.betas[:res.n_stages].double().cpu()
    beta_final = float(res.beta_final)
    row = {"particles": _C5_TEMPERED_PARTICLES, "max_stages": 50, "ess_target": 0.5, "n_moves": 3,
           "step_scale": 0.5, "prior_std": _C5_PRIOR_STD, "log_Z": log_z, "n_stages": res.n_stages,
           "beta_final": beta_final, "truncated": beta_final < 1.0, "accept_rate": float(res.accept_rate),
           "wall_seconds": wall, "loglik_evaluations": evals, "evaluations_per_s": evals / wall,
           "particle_evaluations_per_s": evals * _C5_TEMPERED_PARTICLES / wall, "launches": counts,
           "elbo_anchor": e_anchor, "elbo_at_particle_mean": e_mean,
           "betas_head": betas[:5].tolist(), "card": card}
    print("tempered smc", json.dumps(row))
    if row["truncated"]:
        print(f"tempered smc: TRUNCATED at beta={beta_final:.6g} after {res.n_stages} stages; log_Z covers the "
              f"anneal up to it")
    check(counts == {"k1": n_layers * evals, "k2": 0, "plain_psi2_calls": 0},
          f"sample_tempered: launches {counts}, want {n_layers} K1 per evaluation of all particles "
          f"({evals}), no K2 and no plain path")
    check(math.isfinite(log_z), f"sample_tempered: log_Z {log_z}")
    check(res.n_stages >= 1 and bool((torch.diff(torch.cat([betas.new_zeros(1), betas])) > 0).all())
          and float(betas[-1]) == beta_final, f"sample_tempered: the beta schedule is not increasing: {betas}")
    check(0.0 < row["accept_rate"] <= 1.0, f"sample_tempered: accept rate {row['accept_rate']}")
    check(bool(torch.isfinite(res.particles).all()), "sample_tempered: a particle is not finite")
    check(e_mean > e_anchor - 50.0, f"sample_tempered: the ELBO at the particle mean {e_mean} is more than 50 nats "
          f"below the anchor's {e_anchor}")
    return counts


def phase_examples(psi2, psi_stats, card):
    """Phase 10c: the five example scripts in this process on the card, each
    at the cut size printed; each must print its JSON line."""
    import contextlib
    import importlib
    import io

    rows = {}
    for name, argv in _EXAMPLES:
        mod = importlib.import_module(f"rgp_tpu_torch.examples.{name}")
        _c5_zero(psi2, psi_stats)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            record = mod.main(argv)
        wall = time.perf_counter() - t0
        printed = buf.getvalue().strip().splitlines()
        check(bool(printed) and json.loads(printed[-1]) == json.loads(json.dumps(record)),
              f"example {name} did not print its JSON line")
        rows[name] = {"argv": argv, "wall_seconds": wall, "launches": _c5_counts(psi2, psi_stats),
                      "printed": printed, "card": card}
        print("example", json.dumps(rows[name]))
    return rows


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _p11_value_and_grads(fn, params):
    """(value, [each leaf's gradient as float64 numpy]) of ``fn(params)``:
    one backward; a leaf the value does not use gets zeros."""
    from rgp_tpu_torch.params import leaves_with_paths, with_leaves

    leaves = [x.detach().clone().requires_grad_() for _, x in leaves_with_paths(params)]
    value = fn(with_leaves(params, leaves))
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return float(value.detach()), [np.zeros(tuple(x.shape)) if g is None else g.double().cpu().numpy()
                          for x, g in zip(leaves, grads)]


def _p11_hidden_layer(cfg, params, Y, U):
    """The anchor's hidden layer as a collapsed bound's operands: (kernel,
    its parameters {kern, Z, log_noise}, X_mu, X_s, target means, target
    variances), the inputs and targets detached."""
    from rgp_tpu_torch.models import rgp

    with torch.no_grad():
        mus, lams = rgp._hidden_moments(cfg, params, Y, U)
        X_mu, X_s = rgp._layer_inputs(cfg, 0, mus[0], lams[0], None, None, U)
    L = cfg.layers[0].win
    lp = params["layers"][0]
    return (cfg.layers[0].kernel, {k: lp[k] for k in ("kern", "Z", "log_noise")}, X_mu, X_s, mus[0][L:],
            lams[0][L:])


def _p11_bounds(cfg, params, Y, U, mesh):
    """{name: q -> bound}: 11a's sequence-sharded RGP bound of the whole
    params, and 11b's data-parallel and inducing-sharded bounds of the hidden
    layer's {kern, Z, log_noise}; with ``mesh=None`` their single-process
    counterparts, each a dict {route: q -> bound} over the Psi2 routes."""
    from rgp_tpu_torch.inference.collapsed_vi import collapsed_bound
    from rgp_tpu_torch.models import rgp
    from rgp_tpu_torch.ops.psi_stats import psi_statistics
    from rgp_tpu_torch.parallel import (
        data_parallel_collapsed_elbo,
        inducing_sharded_collapsed_elbo,
        sequence_sharded_rgp_elbo,
    )

    kern, q0, X_mu, X_s, tgt, tgt_var = _p11_hidden_layer(cfg, params, Y, U)
    operands = (X_mu, X_s, tgt, tgt_var)
    if mesh is not None:
        return {
            "sequence": (params, lambda p: sequence_sharded_rgp_elbo(cfg, p, Y, U, mesh)),
            "data_parallel": (q0, lambda q: data_parallel_collapsed_elbo(
                kern, q["kern"], q["Z"], rgp._fln(cfg, q["log_noise"]), *operands, mesh)),
            "inducing": (q0, lambda q: inducing_sharded_collapsed_elbo(
                kern, q["kern"], q["Z"], rgp._fln(cfg, q["log_noise"]), *operands, mesh)),
        }

    def layer(route):
        def bound(q):
            stats = psi_statistics(kern, q["kern"], q["Z"], X_mu, X_s, block=None, prefer=route)
            return collapsed_bound(kern, q["kern"], q["Z"], rgp._fln(cfg, q["log_noise"]), stats, tgt, tgt_var)
        return bound

    routes = ("auto", "scan")
    return {
        "sequence": (params, {r: (lambda p, r=r: rgp.elbo(cfg, p, Y, U, block=None, psi_prefer=r)) for r in routes}),
        "data_parallel": (q0, {r: layer(r) for r in routes}),
        "inducing": (q0, {r: layer(r) for r in routes}),
    }


def _p11_rank(rank, root, dev_type):
    """One rank of phase 11's gloo world on the card (11a-11e); returns its
    numbers to the parent. Each path's launch counts are set to 0 just before
    it and read just after, in this rank."""
    import torch.distributed as dist

    from rgp_tpu_torch import train
    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.ops import psi_stats
    from rgp_tpu_torch.ops.cuda import psi2
    from rgp_tpu_torch.params import leaves_with_paths
    from rgp_tpu_torch.parallel import make_mesh, sequence_sharded_rgp_elbo
    from rgp_tpu_torch.sample.api import make_rgp_potential, nuts_sharded, smc

    torch.set_num_threads(1)  # the ranks share the host's cores
    dev = torch.device(dev_type)
    anchor = os.path.join(root, _C5_ANCHOR)
    world = dist.get_world_size()
    mesh = make_mesh(data=world)
    out = {"backend": dist.get_backend(), "world": world}

    def counted(fn):
        _c5_zero(psi2, psi_stats)
        result = fn()
        _sync(dev)
        return result, _c5_counts(psi2, psi_stats)

    # 11a, 11b: values and gradients in float64 and float32
    for dtype in (torch.float64, torch.float32):
        cfg, params, Y, U, _, _ = _flagship(0, dtype, anchor, device=dev)
        for name, (q, bound) in _p11_bounds(cfg, params, Y, U, mesh).items():
            with _rung_spies() as rungs:
                (value, grads), counts = counted(lambda: _p11_value_and_grads(bound, q))
            out[(name, str(dtype))] = {"value": value, "grads": grads, "launches": counts,
                                       "rungs": [float(r) for r in rungs]}

    # 11c: sharded Adam steps at config 1's width
    cfg, params, Y, U, _, _ = _flagship(0, torch.float32, anchor, device=dev)

    def loss(p):
        return -sequence_sharded_rgp_elbo(cfg, p, Y, U, mesh)

    train.fit_adam(loss, params, iters=2, learning_rate=1e-2)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    fit, counts = counted(lambda: train.fit_adam(loss, params, iters=_P11_ADAM_STEPS, learning_rate=1e-2))
    wall = time.perf_counter() - t0

    def five():
        train.fit_adam(loss, params, iters=5, learning_rate=1e-2)

    if rank == 0:
        prof = profile_device(five, "phase 11c sharded Adam steps, rank 0 of 2", 5)
        ops = prof["device_ops_per_step"]
    else:  # the same collectives as profile_device's two calls
        five()
        five()
        _sync(dev)
        ops = None
    out["adam"] = {"steps": _P11_ADAM_STEPS, "wall_seconds": wall, "ms_per_step": 1e3 * wall / _P11_ADAM_STEPS,
                   "device_ops_per_step": ops, "launches": counts, "losses": fit.losses.double().cpu().numpy(),
                   "params": [x.cpu().numpy() for _, x in leaves_with_paths(fit.params)]}

    # 11d: particle-sharded SMC over the test span
    cfg, params, Y, U, Ut, Yt = _flagship(0, torch.float32, anchor, device=dev)
    pmesh = make_mesh(particle=world)
    smc(cfg, params, Y, U, Ut[:32], Yt[:32], torch.Generator(device=dev).manual_seed(0),
        n_particles=_P11_SMC_PARTICLES, mesh=pmesh)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    res, counts = counted(lambda: smc(cfg, params, Y, U, Ut, Yt, torch.Generator(device=dev).manual_seed(0),
                                      n_particles=_P11_SMC_PARTICLES, mesh=pmesh))
    wall = time.perf_counter() - t0
    out["smc"] = {"log_marginal": float(res.log_marginal), "ess_history": res.ess_history.double().cpu().numpy(),
                  "wall_seconds": wall, "steps_per_s": int(res.ess_history.shape[0]) / wall, "launches": counts}

    # 11e: chain-sharded NUTS on config 5's potential (auto route)
    _, flat0, _, batched = make_rgp_potential(cfg, params, Y, U)
    n_chains = _P11_NUTS["n_chains"]
    z0 = flat0[None, :] + 0.01 * torch.randn((n_chains, flat0.shape[0]), generator=torch.Generator().manual_seed(0),
                                             dtype=flat0.dtype).to(dev)
    kw = {k: v for k, v in _P11_NUTS.items() if k != "n_chains"}
    t0 = time.perf_counter()
    res, counts = counted(lambda: nuts_sharded(batched, z0, 0, make_mesh(chain=world), n_chains=n_chains, **kw))
    wall = time.perf_counter() - t0
    out["nuts"] = {"step_size": res.step_size.cpu().numpy(), "mass_inv": res.mass_inv.cpu().numpy(),
                   "launches": counts, "wall_seconds": wall,
                   "chain_steps_per_s": n_chains * (kw["n_warmup"] + kw["n_samples"]) / wall,
                   "mean_accept": float(res.accept_prob.mean()), "finite": bool(torch.isfinite(res.samples).all()),
                   "samples_shape": list(res.samples.shape)}
    return out


def _p11_nccl_rank(rank, root, dev_type):
    """11f: one rank on NCCL, the sequence-sharded float32 value and
    gradients at the anchor through the backend's collectives."""
    import torch.distributed as dist

    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.ops import psi_stats
    from rgp_tpu_torch.ops.cuda import psi2
    from rgp_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dev = torch.device(dev_type)
    cfg, params, Y, U, _, _ = _flagship(0, torch.float32, os.path.join(root, _C5_ANCHOR), device=dev)
    q, bound = _p11_bounds(cfg, params, Y, U, make_mesh(data=dist.get_world_size()))["sequence"]
    _c5_zero(psi2, psi_stats)
    value, grads = _p11_value_and_grads(bound, q)
    _sync(dev)
    return {"backend": dist.get_backend(), "value": value, "grads": grads, "launches": _c5_counts(psi2, psi_stats)}


def _p11_gaps(row, ref):
    """(|value - ref value|, the largest |gradient - ref gradient| over every
    leaf, the largest of that over the leaf's largest |ref gradient|)."""
    diffs = [np.abs(a - b).max() for a, b in zip(row["grads"], ref["grads"])]
    scaled = [d / max(np.abs(b).max(), 1e-300) for d, b in zip(diffs, ref["grads"])]
    return abs(row["value"] - ref["value"]), float(max(diffs)), float(max(scaled))


def phase_sharded(psi2, psi_stats, root, card, smc_9d, dev_type="cuda"):
    """Phase 11: the sharded paths (``rgp_tpu_torch.parallel``, the sharded
    samplers) on ranks spawned on the card, against single-process runs in
    this process. Returns {path: (K1, K2) launches summed over ranks}."""
    import tempfile

    from rgp_tpu_torch import train
    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.models import rgp
    from rgp_tpu_torch.params import leaves_with_paths
    from rgp_tpu_torch.parallel._launch import spawn_ranks
    from rgp_tpu_torch.sample.api import smc

    dev = torch.device(dev_type)
    anchor = os.path.join(root, _C5_ANCHOR)
    # The kernels were built in phase 2: a rank finds them under build/ and
    # loads them. Two ranks on one card run over gloo (NCCL refuses two
    # ranks on one device); gloo's all-reduce takes the CUDA tensors, staging
    # them through the host. NCCL runs one rank (11f).
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rdv:
        ranks = spawn_ranks(_p11_rank, _P11_WORLD, backend="gloo", init_method=f"file://{rdv}/gloo",
                            args=(root, dev_type), timeout=_P11_TIMEOUT, pg_timeout=_P11_PG_TIMEOUT)
        t_ranks = time.perf_counter() - t0
        (nccl,) = spawn_ranks(_p11_nccl_rank, 1, backend="nccl", init_method=f"file://{rdv}/nccl",
                              args=(root, dev_type), timeout=_P11_TIMEOUT, pg_timeout=_P11_PG_TIMEOUT)
    print("phase 11 ranks", json.dumps({"gloo_world": _P11_WORLD, "gloo_seconds": t_ranks,
                                        "nccl_seconds": time.perf_counter() - t0 - t_ranks,
                                        "backends": [r["backend"] for r in ranks] + [nccl["backend"]]}))
    check([r["backend"] for r in ranks] == ["gloo"] * _P11_WORLD and nccl["backend"] == "nccl",
          "phase 11: the ranks ran on other backends than asked")

    # single-process references on the card: float64 (plain path) and both
    # float32 routes, each with its ladder rungs
    refs = {}
    for dtype in (torch.float64, torch.float32):
        cfg, params, Y, U, _, _ = _flagship(0, dtype, anchor, device=dev)
        for name, (q, bounds) in _p11_bounds(cfg, params, Y, U, None).items():
            for route, bound in bounds.items():
                if dtype == torch.float64 and route == "auto":
                    continue  # float64 takes the plain path on either route
                with _rung_spies() as rungs:
                    value, grads = _p11_value_and_grads(bound, q)
                refs[(name, str(dtype), route)] = {"value": value, "grads": grads,
                                                   "rungs": [float(r) for r in rungs]}
    f64, f32 = str(torch.float64), str(torch.float32)
    counts = {}
    n_layers = cfg.n_hidden + 1
    for name, k_f32 in (("sequence", n_layers), ("data_parallel", 1), ("inducing", 0)):
        ref64 = refs[(name, f64, "scan")]
        # float64: sharded against single-process, value and every leaf
        rows64 = [r[(name, f64)] for r in ranks]
        gaps64 = [_p11_gaps(row, ref64) for row in rows64]
        # float32, phase 9a's rule: each within twice the single-process
        # float32 routes' gap to float64
        rows32 = [r[(name, f32)] for r in ranks]
        yard = [_p11_gaps(refs[(name, f32, route)], ref64) for route in ("scan", "auto")]
        yard_v, yard_g = max(y[0] for y in yard), max(y[1] for y in yard)
        gaps32 = [_p11_gaps(row, ref64) for row in rows32]
        row = {
            "path": name, "ranks": _P11_WORLD,
            "f64_value": ref64["value"], "f64_rel_value_gap": [g[0] / abs(ref64["value"]) for g in gaps64],
            "f64_grad_gap_over_leaf_max": [g[2] for g in gaps64],
            "f32_value_sharded": [r["value"] for r in rows32],
            "f32_value_single": {route: refs[(name, f32, route)]["value"] for route in ("scan", "auto")},
            "f32_value_gap_vs_f64": [g[0] for g in gaps32], "f32_grad_gap_vs_f64": [g[1] for g in gaps32],
            "f32_yardstick_value_gap": yard_v, "f32_yardstick_grad_gap": yard_g,
            "rungs_sharded_f32": [r["rungs"] for r in rows32],
            "rungs_single_f32": {route: refs[(name, f32, route)]["rungs"] for route in ("scan", "auto")},
            "rungs_f64": ref64["rungs"],
            "launches_f32_per_rank": [r["launches"] for r in rows32],
            "launches_f64_per_rank": [r["launches"] for r in rows64], "card": card,
        }
        print("phase 11 bound", json.dumps(row))
        for r in ranks[1:]:
            check(r[(name, f32)]["value"] == rows32[0]["value"] and r[(name, f64)]["value"] == rows64[0]["value"],
                  f"phase 11 {name}: the ranks returned different values")
        check(all(g[0] <= _P11_F64_RTOL * abs(ref64["value"]) for g in gaps64),
              f"phase 11 {name} float64: value {[g[0] for g in gaps64]} from the single-process one")
        check(all(g[2] <= _P11_F64_GRAD_RTOL for g in gaps64),
              f"phase 11 {name} float64: gradients {[g[2] for g in gaps64]} of the leaf's largest from the "
              f"single-process ones")
        check(all(math.isfinite(g[0]) and g[0] <= 2.0 * yard_v and g[1] <= 2.0 * yard_g for g in gaps32),
              f"phase 11 {name} float32: gaps to float64 {gaps32} above twice the single-process routes' "
              f"({yard_v}, {yard_g})")
        want = {"k1": k_f32, "k2": k_f32, "plain_psi2_calls": 0}
        check(all(r["launches"] == want for r in rows32),
              f"phase 11 {name} float32 launches per rank {row['launches_f32_per_rank']}, want {want}")
        check(all(r["launches"]["k1"] == 0 and r["launches"]["k2"] == 0 for r in rows64),
              f"phase 11 {name} float64 launched a kernel: {row['launches_f64_per_rank']}")
        counts[name] = sum(r["launches"]["k1"] for r in rows32), sum(r["launches"]["k2"] for r in rows32)

    # 11c: the ranks' Adam steps against single-process steps from the anchor
    adam = [r["adam"] for r in ranks]
    check(all(all(np.array_equal(a, b) for a, b in zip(r["params"], adam[0]["params"])) for r in adam[1:]),
          "phase 11c: the ranks' parameters differ after the sharded Adam steps")
    check(all(bool(np.isfinite(r["losses"]).all()) for r in adam), "phase 11c: a sharded loss is not finite")
    want = {"k1": n_layers * _P11_ADAM_STEPS, "k2": n_layers * _P11_ADAM_STEPS, "plain_psi2_calls": 0}
    check(all(r["launches"] == want for r in adam), f"phase 11c launches {[r['launches'] for r in adam]}, "
          f"want {want} per rank")
    cfg, params, Y, U, Ut, Yt = _flagship(0, torch.float32, anchor, device=dev)

    def single_loss(p):
        return -rgp.elbo(cfg, p, Y, U, block=None)

    train.fit_adam(single_loss, params, iters=2, learning_rate=1e-2)
    _sync(dev)
    t0 = time.perf_counter()
    single = train.fit_adam(single_loss, params, iters=_P11_ADAM_STEPS, learning_rate=1e-2)
    _sync(dev)
    single_ms = 1e3 * (time.perf_counter() - t0) / _P11_ADAM_STEPS
    single_ops = profile_device(lambda: train.fit_adam(single_loss, params, iters=5, learning_rate=1e-2),
                                "phase 11c single-process Adam steps", 5)["device_ops_per_step"]
    drift = max(float(np.abs(a - b.cpu().numpy()).max() / max(np.abs(b.cpu().numpy()).max(), 1e-30))
                for a, (_, b) in zip(adam[0]["params"], leaves_with_paths(single.params)))
    print("phase 11c adam", json.dumps({
        "steps": _P11_ADAM_STEPS, "ranks": _P11_WORLD, "ms_per_step": [r["ms_per_step"] for r in adam],
        "device_ops_per_step_rank0": adam[0]["device_ops_per_step"], "launches_per_rank": [r["launches"] for r in adam],
        "elbo_first_last": [-float(adam[0]["losses"][0]), -float(adam[0]["losses"][-1])],
        "single_process_ms_per_step": single_ms, "single_process_device_ops_per_step": single_ops,
        "single_process_elbo_first_last": [-float(single.losses[0]), -float(single.losses[-1])],
        "params_drift_vs_single_over_leaf_max": drift,
        "note": "both ranks share the one card, so no speedup is expected", "card": card}))
    counts["adam"] = sum(r["launches"]["k1"] for r in adam), sum(r["launches"]["k2"] for r in adam)

    # 11d: the ranks' filter against the single-process filter with the same draws
    sm = [r["smc"] for r in ranks]
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    single = smc(cfg, params, Y, U, Ut, Yt, gen, n_particles=_P11_SMC_PARTICLES)
    lm = float(single.log_marginal)
    single_rate = int(single.ess_history.shape[0]) / (time.perf_counter() - t0)
    gap = abs(sm[0]["log_marginal"] - lm)
    print("phase 11d smc", json.dumps({
        "particles": _P11_SMC_PARTICLES, "ranks": _P11_WORLD, "log_marginal": [r["log_marginal"] for r in sm],
        "single_process_log_marginal": lm, "gap": gap, "tolerance": _P11_SMC_RTOL * (1.0 + abs(lm)),
        "ess_max_abs_diff": float(np.abs(sm[0]["ess_history"] - single.ess_history.double().cpu().numpy()).max()),
        "steps_per_s": [r["steps_per_s"] for r in sm], "single_process_steps_per_s_anchor": single_rate,
        "phase_9d_steps_per_s": smc_9d["value"], "launches_per_rank": [r["launches"] for r in sm],
        "note": "both ranks share the one card; 9d filters the flagship fitted for 300 steps, 11d the anchor",
        "card": card}))
    check(all(r["log_marginal"] == sm[0]["log_marginal"] and np.array_equal(r["ess_history"], sm[0]["ess_history"])
              for r in sm[1:]), "phase 11d: the ranks' filters differ")
    check(math.isfinite(sm[0]["log_marginal"]) and bool((sm[0]["ess_history"] > 0).all()),
          f"phase 11d: log-marginal {sm[0]['log_marginal']} or an ESS of 0")
    check(gap <= _P11_SMC_RTOL * (1.0 + abs(lm)),
          f"phase 11d: sharded log-marginal {sm[0]['log_marginal']} against the single-process {lm}")

    # 11e: chain-sharded NUTS
    nu = [r["nuts"] for r in ranks]
    print("phase 11e nuts", json.dumps({
        **{k: v for k, v in _P11_NUTS.items()}, "ranks": _P11_WORLD, "step_size": [float(r["step_size"]) for r in nu],
        "launches_per_rank": [r["launches"] for r in nu], "chain_steps_per_s": [r["chain_steps_per_s"] for r in nu],
        "wall_seconds": [r["wall_seconds"] for r in nu], "mean_accept": nu[0]["mean_accept"],
        "samples_shape": nu[0]["samples_shape"], "card": card}))
    check(all(np.array_equal(r["step_size"], nu[0]["step_size"]) and np.array_equal(r["mass_inv"], nu[0]["mass_inv"])
              for r in nu[1:]), "phase 11e: the ranks' step sizes or masses differ")
    check(all(r["finite"] for r in nu), "phase 11e: a draw is not finite")
    check(all(r["launches"]["k1"] > 0 and r["launches"]["k2"] > 0 and r["launches"]["plain_psi2_calls"] == 0
              for r in nu), f"phase 11e launches {[r['launches'] for r in nu]}: want K1 and K2 in every rank")
    counts["nuts"] = sum(r["launches"]["k1"] for r in nu), sum(r["launches"]["k2"] for r in nu)

    # 11f: one rank on NCCL against the single-process float32 routes
    ref64 = refs[("sequence", f64, "scan")]
    g = _p11_gaps(nccl, ref64)
    yard = [_p11_gaps(refs[("sequence", f32, route)], ref64) for route in ("scan", "auto")]
    print("phase 11f nccl", json.dumps({"value": nccl["value"], "gap_vs_f64": g[:2],
                                        "yardstick": [max(y[0] for y in yard), max(y[1] for y in yard)],
                                        "launches": nccl["launches"], "card": card}))
    check(g[0] <= 2.0 * max(y[0] for y in yard) and g[1] <= 2.0 * max(y[1] for y in yard),
          f"phase 11f: NCCL rank's gaps {g[:2]} above twice the single-process float32 routes'")
    check(nccl["launches"] == {"k1": n_layers, "k2": n_layers, "plain_psi2_calls": 0},
          f"phase 11f launches {nccl['launches']}")
    counts["nccl"] = nccl["launches"]["k1"], nccl["launches"]["k2"]
    return counts


def phase_roofline(psi2, psi_stats, card):
    """Phase 12a: the roofline at (2048, 256, 32): the exp probe against its
    plain chain, the measured ceilings beside the published peaks, every hot
    op's time, binding resource and share of the published peak; the K1 and
    K2 rows one launch a call each, with phase 3's bounds; the top device ops
    of the production step. Returns the launches of the measured ops."""
    from rgp_tpu_torch.bench import roofline
    from rgp_tpu_torch.ops.cuda import exp_probe

    dev = torch.device("cuda")
    x = torch.rand(_P12_EXP_ELEMS, generator=torch.Generator(dev).manual_seed(12), device=dev) + 0.5
    n0 = exp_probe.launches
    y = exp_probe.exp_chain(x, 64)
    torch.cuda.synchronize()
    ref = exp_probe.exp_chain_plain(x, 64)
    rel = float(((y - ref).abs() / ref.abs()).max())
    print("exp probe", json.dumps({"elements": _P12_EXP_ELEMS, "k": 64, "max_rel_err": rel,
                                   "launches": exp_probe.launches - n0}))
    check(exp_probe.launches - n0 == 1 and bool(torch.isfinite(y).all()), "exp probe: not one launch, or not finite")
    check(rel <= 1e-5, f"exp probe off its plain chain by {rel} relative (gate 1e-5)")

    ceilings = roofline.calibrate()
    print("roofline ceilings", json.dumps({**ceilings, "card": card}))
    _c5_zero(psi2, psi_stats)
    ops = roofline.measure_ops(*_P12_ROOFLINE_SHAPE)
    counts = _c5_counts(psi2, psi_stats)
    rep = roofline.report(ceilings, ops)
    for r in rep["ops"]:
        print("roofline op", json.dumps({k: r[k] for k in (
            "op", "ms", "binding_resource", "roofline_fraction", "util_mxu", "util_vpu_exp", "util_hbm",
            "bound_ms", "bound_by", "peak_share", "k1_per_call", "k2_per_call", "plain_psi2_per_call")}))
    rows = {r["op"]: r for r in rep["ops"]}
    k1_ms, _ = roofline.k1_bound_ms(*_P12_ROOFLINE_SHAPE)
    k2_ms, _ = roofline.k2_bound_ms(*_P12_ROOFLINE_SHAPE)
    for name, want in (("psi2_sum_k1", (1.0, 0.0)), ("psi2_fwd_bwd_k1k2", (1.0, 1.0)),
                       ("psi2_sum_plain", (0.0, 0.0)), ("psi2_fwd_bwd_plain", (0.0, 0.0))):
        got = (rows[name]["k1_per_call"], rows[name]["k2_per_call"])
        check(got == want, f"roofline {name}: K1/K2 launches a call {got}, want {want}")
    check(rows["psi2_sum_k1"]["bound_ms"] == k1_ms == rows["psi2_sum_plain"]["bound_ms"],
          f"roofline psi2_sum rows' bound {rows['psi2_sum_k1']['bound_ms']} is not phase 3's {k1_ms}")
    fb = rows["psi2_fwd_bwd_k1k2"]["bound_ms"]
    check(fb == rows["psi2_fwd_bwd_plain"]["bound_ms"] and math.isclose(fb, k1_ms + k2_ms, rel_tol=1e-12),
          f"roofline psi2_fwd_bwd rows' bound {fb} is not phase 3's K1 + K2 {k1_ms + k2_ms}")
    check(all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rep["ops"]), "roofline: a time is not positive")
    trace = roofline.capture_trace(None, *_P12_ROOFLINE_SHAPE, top=10)
    print("roofline trace", json.dumps(trace))
    check(trace[0]["n_events"] > 0, "roofline trace: the profiler recorded no device op")
    return counts


def phase_layer_step(psi2, psi_stats):
    """Phase 12b: ``layer_step.run_shape`` at the flagship and production
    shapes: K1 and K2 two launches an iteration in each loss (hidden and
    output layer), never the plain Psi2 path. Returns the launches."""
    from rgp_tpu_torch.bench import layer_step

    _c5_zero(psi2, psi_stats)
    for T, M, win, u_win in _P12_LAYER_SHAPES:
        row = layer_step.run_shape(T, M, win, u_win, iters=_P12_LAYER_ITERS)
        print("layer step", json.dumps(row))
        for loss, n in row["launches_per_iter"].items():
            check(n == {"k1": 2.0, "k2": 2.0, "plain_psi2": 0.0},
                  f"layer step ({T}, {M}) {loss}: launches an iteration {n}, want K1 2, K2 2, plain 0")
        check(all(isinstance(row[k], float) and math.isfinite(row[k]) for k in (
            "full_layer_step_ms", "premat_bound_ms", "full_layer_step_device_ms", "premat_bound_device_ms")),
              f"layer step ({T}, {M}): a time is missing")
    return _c5_counts(psi2, psi_stats)


def phase_serving_batched(psi2, psi_stats, psi2_contract, root, card):
    """Phase 12c: ``serving.serve`` on the anchor (no training): finite
    outputs, element 0 of the batched freerun equal to an unbatched freerun
    of the same inputs under ``_P12_SERVING_RTOL``'s rule (a float64 freerun
    of the same inputs is the yardstick); K3's launches through ``serve``
    and the unbatched freerun. Returns (record, launches, K3 launches)."""
    from torch.utils._pytree import tree_map

    from rgp_tpu_torch.bench import serving
    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.models import rgp

    model = _flagship(0, torch.float32, os.path.join(root, _C5_ANCHOR))
    _c5_zero(psi2, psi_stats)
    psi2_contract.launches = 0
    rec, (means, variances), Us = serving.serve(model, return_outputs=True, **_P12_SERVING)
    counts = _c5_counts(psi2, psi_stats)
    k3_serve = psi2_contract.launches
    print("serving batched", json.dumps(rec))
    cfg, params, Y, U, Ut = model[:5]
    B, T_star = _P12_SERVING["batch"], Ut.shape[0]
    check(means.shape == variances.shape == (B, T_star, 1), f"batched freerun shapes {means.shape}")
    check(bool(torch.isfinite(means).all() and torch.isfinite(variances).all() and (variances > 0).all()),
          "batched freerun: an output is not finite or a variance not positive")
    with torch.no_grad():
        psi2_contract.launches = 0
        single = rgp.freerun(cfg, params, Y, U, Us[0])
        k3_single = psi2_contract.launches
        f64 = rgp.freerun(cfg, _cast(params, torch.float64), Y.double(), U.double(), Us[0].double())
    # the batched steps run eagerly where grad mode is on (no graph replays,
    # whose launches do not pass the wrapper): one K3 launch a layer a step
    # for all B candidates
    psi2_contract.launches = 0
    with torch.enable_grad():
        rgp.freerun(cfg, tree_map(lambda x: x.detach() if torch.is_tensor(x) else x, params), Y, U, Us)
    torch.cuda.synchronize()
    k3_batched = psi2_contract.launches
    # serve's eager calls, the untimed one first: freerun and predict_train
    # repeat + 1 times each (its batched freeruns add their captures)
    n_layers, calls = cfg.n_hidden + 1, _P12_SERVING["repeat"] + 1
    k3 = {"serve": k3_serve, "serve_min": calls * (n_layers * T_star + 1), "single_freerun": k3_single,
          "batched_freerun_eager": k3_batched, "want_a_freerun": n_layers * T_star}

    def gap(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    row = {}
    for i, name in enumerate(("mean", "var")):
        row[name] = {"batched_vs_single": gap((means, variances)[i][0], single[i]),
                     "single_vs_f64": gap(single[i], f64[i])}
        row[name]["gate"] = max(_P12_SERVING_RTOL, row[name]["single_vs_f64"])
    timing = {k: v for k, v in rec["details"].items() if "latency" in k or "steps_per_sec" in k}
    print("serving batched vs single", json.dumps({**row, "launches": counts, "k3_launches": k3, **timing,
                                                   "card": card}))
    for name, r in row.items():
        check(r["batched_vs_single"] <= r["gate"],
              f"batched freerun element 0: {name}s off the single freerun by {r['batched_vs_single']} of "
              f"the largest (gate {r['gate']})")
    check(counts["k2"] == 0 and counts["plain_psi2_calls"] == 0, f"serving launches {counts}")
    check(k3_serve >= k3["serve_min"] and k3_single == k3_batched == n_layers * T_star,
          f"K3 launches {k3}: want one a layer a step in serve's eager freeruns and one a predict_train, and "
          f"one a layer a step in a freerun, batched over {B} candidates or not")
    return rec, counts, k3


def phase_multimodality(psi2, psi_stats, card):
    """Phase 12d: ``multimodality.run`` at full width, restarts as one batch:
    K1 once a layer for all restarts in every forward (refreshes and the
    freeruns' posteriors included), K2 once a layer in every backward, the
    plain path never; every loss finite; ms and device ops a step, busy share
    and peak memory (phase 5 prints config 1's single-restart step). Then at
    ``_P12_F64_RESTARTS`` restarts in float64 (plain path): the batched step's
    ELBOs equal single-restart ``rgp.elbo`` calls at rtol 1e-10, and each
    leaf's gradients within ``_P11_F64_GRAD_RTOL`` of its largest (phase
    11's rule: the batched cuSOLVER factorizations round otherwise than the
    single-matrix ones, and the gradients carry Kmm's conditioning: 2.3e-10
    on an H100 at 700 W). Returns the launches."""
    import tempfile

    from rgp_tpu_torch.bench import multimodality as mm
    from rgp_tpu_torch.data import datasets
    from rgp_tpu_torch.models import rgp
    from rgp_tpu_torch.params import leaves_with_paths, with_leaves

    R, iters, chunk = _P12_RESTARTS, _P12_MM_ITERS, _P12_MM_CHUNK
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        _c5_zero(psi2, psi_stats)
        summary = mm.run(R, iters, 1e-2, 0, chunk, os.path.join(tmp, "table.csv"))
        counts = _c5_counts(psi2, psi_stats)
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(tmp, "table.csv")) as f:
            table = f.read()
    n_layers = 2
    refreshes = iters // 100
    want = {"k1": n_layers * (iters + refreshes + 1), "k2": n_layers * iters, "plain_psi2_calls": 0}
    print("multimodality", json.dumps({**summary, "launches": counts, "want": want, "card": card}))
    print("multimodality table\n" + table.strip())
    check(counts == want, f"multimodality launches {counts}, want {want} ({n_layers} layers a pass, all {R} "
          f"restarts in one launch)")
    check(all(math.isfinite(summary[k]) for k in ("rmse_min", "rmse_median", "rmse_max")),
          "multimodality: an RMSE is not finite")
    check(all(math.isfinite(float(r.split(",")[2])) for r in table.strip().splitlines()[1:]),
          "multimodality: a final ELBO is not finite")

    # one batched step, profiled: device ops, busy share
    t = datasets.standardized_tensors(datasets.load("actuator"), dtype=torch.float32)
    cfg = rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=100)
    stacked = mm.stack_restarts([rgp.init_params(cfg, t.Y, t.U, seed=s) for s in range(R)])
    leaves = [x.detach().clone().requires_grad_() for _, x in leaves_with_paths(stacked)]
    p = with_leaves(stacked, leaves)
    wh = mm.restart_whitenings(cfg, p, t.Y, t.U)

    def step():
        return torch.autograd.grad(mm.restart_losses(cfg, p, t.Y, t.U, wh).sum(), leaves)

    prof = profile_device(step, f"multimodality batched step, {R} restarts", 1)
    step_ms = time_host_ms(step, n=5)
    print("multimodality step", json.dumps({
        "restarts": R, "ms_per_step_fit": 1e3 * summary["fit_seconds"] / iters, "value_and_grad_ms": step_ms,
        "device_ops_per_step": prof["device_ops"], "device_busy_share": prof["device_busy_share"],
        "peak_memory_bytes": peak, "card": card}))

    # float64 on the card (plain path): the batched step against single restarts
    t64 = datasets.standardized_tensors(datasets.load("actuator"), dtype=torch.float64)
    singles = [rgp.init_params(cfg, t64.Y, t64.U, seed=s, dtype=torch.float64) for s in range(_P12_F64_RESTARTS)]
    stacked = mm.stack_restarts(singles)
    leaves = [x.clone().requires_grad_() for _, x in leaves_with_paths(stacked)]
    n1 = psi2.launches
    wh = mm.restart_whitenings(cfg, stacked, t64.Y, t64.U)
    losses = mm.restart_losses(cfg, with_leaves(stacked, leaves), t64.Y, t64.U, wh)
    grads = torch.autograd.grad(losses.sum(), leaves)
    worst = {"value": 0.0, "grad": 0.0}
    for r, pr in enumerate(singles):
        with torch.no_grad():
            wh_r = rgp.compute_whitenings(cfg, pr, t64.Y, t64.U, block=None)
        lv = [x.clone().requires_grad_() for _, x in leaves_with_paths(pr)]
        loss = -rgp.elbo(cfg, with_leaves(pr, lv), t64.Y, t64.U, block=None, whitening=wh_r)
        g1 = torch.autograd.grad(loss, lv)
        worst["value"] = max(worst["value"], abs(losses[r].item() - loss.item()) / abs(loss.item()))
        worst["grad"] = max(worst["grad"], max(float((gs[r] - g).abs().max() / g.abs().max().clamp(min=1e-300))
                                               for gs, g in zip(grads, g1)))
    print("multimodality f64 batched vs single", json.dumps({**worst, "restarts": _P12_F64_RESTARTS,
                                                               "k1_launches": psi2.launches - n1}))
    check(psi2.launches == n1, "multimodality float64: a kernel launched")
    check(worst["value"] <= 1e-10 and worst["grad"] <= _P11_F64_GRAD_RTOL,
          f"multimodality float64: the batched step is {worst} from the single restarts (gates 1e-10 in "
          f"value, {_P11_F64_GRAD_RTOL} of each leaf's largest gradient)")
    return counts


def phase_posterior_check(psi2, psi_stats, root, card):
    """Phase 12e: ``posterior_check`` at the anchor: ``card`` at 32 chains
    (K2 never, K1 only for the frozen whitening, one a layer), ``compare``
    against the JAX package's float64 chain (printed, not gated), and
    ``surrogate-check`` on the JAX package's draws (``_P12_SURROGATE_REF``
    for the reference chains): the float64 columns at all 9 points of
    ``artifacts/surrogate_check_r5.json`` within 0.02, the fresh-basis
    column at the record's floor rung where the card's float32 trial took
    another (:func:`_surrogate_rung_flips`).
    Returns the launches of ``card``."""
    import tempfile

    from rgp_tpu_torch.bench import posterior_check as pc

    anchor = os.path.join(root, _C5_ANCHOR)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "card.npz")
        _c5_zero(psi2, psi_stats)
        rec = pc.mode_card(anchor, out, max_depth=6, target_accept=0.6, group_size=128, seg=3, seed=0,
                           **_P12_CARD)
        counts = _c5_counts(psi2, psi_stats)
        print("posterior check card", json.dumps({**rec, "launches": counts, "card": card}))
        check(counts["k2"] == 0 and counts["k1"] == 2,
              f"posterior check card: launches {counts}, want K1 2 (the frozen whitening) and K2 0")
        with np.load(out) as z:
            check(z["draws"].shape == (_P12_CARD["chains"], _P12_CARD["samples"], 25)
                  and bool(np.isfinite(z["draws"]).all()), "posterior check card: draws not finite")
        cmp = pc.mode_compare(out, os.path.join(root, _C5_CPU_DRAWS))
        print("posterior check compare", json.dumps({**cmp, "note": "against the JAX package's float64 "
                                                      "fresh-basis chain: information only"}))
    tpu_npz, ref_npz = os.path.join(root, _C5_TPU_DRAWS), os.path.join(root, _P12_SURROGATE_REF)
    sur = pc.mode_surrogate_check(anchor, tpu_npz, ref_npz=ref_npz)
    with open(os.path.join(root, _P12_SURROGATE)) as f:
        ref = json.load(f)
    print("posterior check surrogate", json.dumps(sur))
    check([r["point"] for r in sur["points"]] == [r["point"] for r in ref["points"]],
          f"surrogate check points {[r['point'] for r in sur['points']]} are not the recorded ones")
    gaps = {r["point"]: [abs(r[k] - q[k]) for k in ("U_f64_fresh", "U_f64_frozen")]
            for r, q in zip(sur["points"], ref["points"])}
    flips = _surrogate_rung_flips(anchor, tpu_npz, ref_npz, sur, ref, gaps)
    print("posterior check surrogate gaps", json.dumps({"gaps_f64_fresh_frozen": gaps, "rung_flips": flips,
                                                        "f32_frozen": {r["point"]: r["U_f32_frozen"]
                                                                       for r in sur["points"]}}))
    check(all(g[1] <= _P12_SURROGATE_TOL for g in gaps.values()),
          f"surrogate check: a frozen-basis float64 potential is off the recorded one by more than "
          f"{_P12_SURROGATE_TOL}: {gaps}")
    check(all(g[0] <= _P12_SURROGATE_TOL or flips.get(p, {}).get("confirmed") for p, g in gaps.items()),
          f"surrogate check: a fresh-basis float64 potential is off the recorded one by more than "
          f"{_P12_SURROGATE_TOL} without a floor-rung flip behind it: {gaps}, {flips}")
    return counts


@contextlib.contextmanager
def _forced_floor_rungs(rungs):
    """``whitening_basis`` (where the collapsed bound looks it up) with the
    i-th call's spectral floor at rung ``rungs[i]`` (the base floor times 1,
    1e3, 1e6) and no trial Cholesky."""
    from rgp_tpu_torch.inference import collapsed_vi

    basis, it = collapsed_vi.whitening_basis, iter(rungs)

    def forced(Kmm, psi2=None, beta=None, spectral_floor=None):
        return basis(Kmm, spectral_floor=collapsed_vi.default_spectral_floor(Kmm.dtype) * 1e3 ** next(it))

    collapsed_vi.whitening_basis = forced
    try:
        yield
    finally:
        collapsed_vi.whitening_basis = basis


def _surrogate_rung_flips(anchor, tpu_npz, ref_npz, sur, ref, gaps):
    """{point: ...} for each point where the fresh-basis float64 potential
    misses the record: its value at every combination of the layers' floor
    rungs, which combination gives the record's value and which the card's.
    The fresh basis picks its floor by a float32 trial Cholesky; on the card
    that trial can pass where the reference's failed (ROADMAP.md Queue 3),
    and then the record is reproduced at the reference's rung ("confirmed")."""
    import itertools

    from rgp_tpu_torch.bench.sampling import _flagship
    from rgp_tpu_torch.sample.api import make_rgp_potential

    misses = [p for p, g in gaps.items() if g[0] > _P12_SURROGATE_TOL]
    if not misses:
        return {}
    cfg, p64, Y, U, _, _ = _flagship(0, torch.float64, anchor)
    fresh, flat0, _, _ = make_rgp_potential(cfg, p64, Y, U, block=64, psi_prefer="scan", fixed_whitening=False)
    with np.load(tpu_npz) as z:
        draws = z["draws"].reshape(-1, flat0.shape[0])
    with np.load(ref_npz) as z:
        last = z["draws"][:, -1]
    ours = {r["point"]: r["U_f64_fresh"] for r in sur["points"]}
    recorded = {q["point"]: q["U_f64_fresh"] for q in ref["points"]}
    out = {}
    for name in misses:
        v = (flat0.cpu().numpy() if name == "anchor" else draws[int(name.rsplit("_", 1)[1])]
             if name.startswith("tpu_draw_") else last[int(name[len("ref_chain")])])
        vals = {}
        for combo in itertools.product(range(3), repeat=cfg.n_hidden + 1):
            with torch.no_grad(), _forced_floor_rungs(combo):
                vals[str(combo)] = float(fresh(torch.as_tensor(v, dtype=torch.float64, device=flat0.device)))
        rec_rungs = [c for c, u in vals.items() if abs(u - recorded[name]) <= _P12_SURROGATE_TOL]
        card_rungs = [c for c, u in vals.items() if abs(u - ours[name]) <= 1e-9 * (1.0 + abs(u))]
        out[name] = {"values_by_rungs": vals, "record_rungs": rec_rungs, "card_rungs": card_rungs,
                     "confirmed": bool(rec_rungs and card_rungs and not set(rec_rungs) & set(card_rungs))}
    return out


def phase_all(root, card):
    """Phase 12f: ``bench.all --quick --only tasks_narendra_gp_narx`` as a
    subprocess: its row has return code 0, a parsed result, the code's sha
    and the card."""
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rows.jsonl")
        r = subprocess.run([sys.executable, "-m", "rgp_tpu_torch.bench.all", "--quick", "--only",
                            "tasks_narendra_gp_narx", "--out", out], cwd=root, capture_output=True, text=True,
                           timeout=_P12_ALL_TIMEOUT)
        check(r.returncode == 0, f"bench.all exited {r.returncode}: {r.stderr[-2000:]}")
        with open(out) as f:
            rows = [json.loads(line) for line in f]
    print("bench all", json.dumps(rows))
    check(len(rows) == 1 and rows[0]["name"] == "tasks_narendra_gp_narx", f"bench.all rows: {rows}")
    row = rows[0]
    check(row.get("returncode") == 0 and isinstance(row.get("result"), dict),
          f"bench.all row: return code {row.get('returncode')}, result {row.get('result')}")
    check(isinstance(row.get("git_sha"), str) and row.get("card") == card, f"bench.all row: sha or card missing: {row}")


def ptxas_report(log):
    """{compile-time Q width (K3: "Q/D"): {"registers", "spill_bytes"}} of
    each kernel instance, from the ptxas report nvcc wrote beside the
    library."""
    import re

    out, width = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?kernelILi(\d+)E(?:Li(\d+)E)?", line)
        if m:  # K3's instances also name their column width: "Q/D"
            width = int(m.group(1)) if m.group(2) is None else f"{m.group(1)}/{m.group(2)}"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and width is not None:
            out.setdefault(width, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and width is not None:
            out.setdefault(width, {})["registers"] = int(m.group(1))
    return out


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "rgp_tpu_torch")):
        fail(f"no rgp_tpu_torch package beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, root)

    # phase 1
    from rgp_tpu_torch.bench.config1 import card as query_card

    card = query_card()
    print(card)  # name and power limit, as nvidia-smi prints them
    from rgp_tpu_torch import linalg  # noqa: F401  (pins TF32 off at import)
    from rgp_tpu_torch.ops import psi_stats
    from rgp_tpu_torch.ops.cuda import psi2, psi2_contract

    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32}
    print("tf32", json.dumps(tf32))
    check(not any(tf32.values()), f"TF32 is on: {tf32}")
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s wall")
        return out

    # phase 2
    t0 = time.perf_counter()
    libs = psi2.build()
    build_s = time.perf_counter() - t0
    print(f"kernel build (K1, K2, K3 and the exp probe at once): {build_s:.1f} s")
    print(f"phase 2: {build_s:.1f} s wall")
    ptxas = {}
    for name, so in libs.items():
        print(f"  {name}: {os.path.relpath(so, root)}")
        log = so.with_suffix(".log")
        ptxas[name] = ptxas_report(log.read_text()) if log.exists() else "not reported"
        print(f"  ptxas {name} (Q width: registers, spill bytes):", json.dumps(ptxas[name]))

    k1_rows = timed("3 (K1)", phase_k1, psi2)
    k2_rows = timed("3 (K2)", phase_k2, psi2)
    k3_rows = timed("3k (K3)", phase_k3, psi2_contract)
    timed("3 (VJP)", phase_vjp, psi2, psi_stats)
    batched_rows = timed("3d (batched K1/K2)", phase_batched, psi2, card)
    serving, k3_serving = timed("4", phase_serving, psi2, psi_stats, psi2_contract)
    timed("4 (f32 lane)", phase_f32_lane, psi2)
    training, single_step = timed("5", phase_training, psi2, psi_stats)
    timed("5 (f32 lane)", phase_f32_lane_trained, psi2)
    restarts = timed("5c (restarts as one batch)", phase_restarts, psi2, psi_stats, single_step, card)
    timed("6", phase_golden)
    config2 = timed("7", phase_configs_2_3, psi2, psi_stats)
    config4 = timed("8", phase_config4, psi2, psi_stats, card)
    uncertain = timed("8 (svgp uncertain)", phase_svgp_uncertain, psi2, psi_stats)
    t9 = time.perf_counter()
    c5_potential = timed("9a (config 5 potential)", phase_config5_potential, psi2, psi_stats, root, card)
    timed("9b (config 5 NUTS twin)", phase_config5_nuts, psi2, psi_stats, root, card)
    c5_sample = timed("9c (config 5 sample_nuts)", phase_config5_sample_nuts, psi2, psi_stats, root, card)
    smc_9d = timed("9d (config 5 SMC twin)", phase_config5_smc, card)
    print(f"phase 9: {time.perf_counter() - t9:.1f} s wall")
    t10 = time.perf_counter()
    tempered_ll, _ = timed("10a (tempered log-likelihood)", phase_tempered_loglik, psi2, psi_stats, root, card)
    tempered = timed("10b (sample_tempered)", phase_tempered_smc, psi2, psi_stats, root, card)
    timed("10c (examples)", phase_examples, psi2, psi_stats, card)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s wall")
    sharded = timed("11 (sharded paths on ranks)", phase_sharded, psi2, psi_stats, root, card, smc_9d)
    t12 = time.perf_counter()
    roofline_ops = timed("12a (roofline)", phase_roofline, psi2, psi_stats, card)
    layer_step = timed("12b (layer step)", phase_layer_step, psi2, psi_stats)
    _, serving_batched, k3_batched = timed("12c (batched serving)", phase_serving_batched, psi2, psi_stats,
                                           psi2_contract, root, card)
    p12 = {
        "roofline_measure_ops": roofline_ops,
        f"layer_step_2shapes_{_P12_LAYER_ITERS}iters": layer_step,
        f"serving_batched_{_P12_SERVING['batch']}": serving_batched,
        f"multimodality_{_P12_RESTARTS}restarts_{_P12_MM_ITERS}steps": timed(
            "12d (multimodality)", phase_multimodality, psi2, psi_stats, card),
        f"posterior_check_card_{_P12_CARD['chains']}chains": timed("12e (posterior check)", phase_posterior_check,
                                                                   psi2, psi_stats, root, card),
    }
    timed("12f (bench all)", phase_all, root, card)
    print(f"phase 12: {time.perf_counter() - t12:.1f} s wall")

    def by_path(i):
        """The sharded paths' launches of K1 (i=0) or K2 (i=1), summed over
        their ranks, and phase 12's."""
        return {f"sharded_sequence_vg_{_P11_WORLD}ranks": sharded["sequence"][i],
                f"sharded_data_parallel_vg_{_P11_WORLD}ranks": sharded["data_parallel"][i],
                f"sharded_inducing_vg_{_P11_WORLD}ranks": sharded["inducing"][i],
                f"sharded_sequence_adam_{_P11_ADAM_STEPS}steps_{_P11_WORLD}ranks": sharded["adam"][i],
                f"sharded_nuts_{_P11_NUTS['n_chains']}chains_{_P11_WORLD}ranks": sharded["nuts"][i],
                "sharded_sequence_vg_nccl_1rank": sharded["nccl"][i],
                **{name: c[("k1", "k2")[i]] for name, c in p12.items()}}

    def row(name, src, replaces, tpu_kernel, launches, by_path, rows):
        main_row = rows[0]  # (512, 100, 20): config 1's hidden layer
        key = "k1" if name == "psi2_fwd" else "k2"
        batched = [{**{k: r[k] for k in ("T", "M", "Q", "B", "z", "launches_counted", "card")},
                    "bit_identical_to_singles": r["bit_identical_to_singles"][key],
                    "worst_err_over_tol": r[f"{key}_worst_err_over_tol"], **r.get(key, {})} for r in batched_rows]
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "tpu_kernel": tpu_kernel,
            "launches": launches, "launches_by_path": by_path,
            "shape": [main_row["T"], main_row["M"], main_row["Q"]],
            "max_abs_err": main_row["max_abs_err"], "max_rel_err": main_row["max_rel_err"],
            "ms": main_row["ms"], "device_ms": main_row["device_ms"],
            "launches_per_call": main_row["launches_per_call"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes it",
            "shapes": rows, "batched": batched, "ptxas": ptxas[name], "card": card,
        }

    k3_main = k3_rows[0]  # (16384, 100, 20, 1): config 1's hidden layer in its rollout cell
    k3_by_path = {f"serving_{name}": n for name, n in k3_serving.items()}
    k3_by_path.update({f"serving_batched_{_P12_SERVING['batch']}_{name}": k3_batched[name]
                       for name in ("serve", "single_freerun", "batched_freerun_eager")})
    k3_row = {
        "name": "psi2_contract", "route": "cuda", "source": "rgp_tpu_torch/csrc/psi2_contract.cu",
        "replaces": "rgp_tpu/inference/collapsed_vi.py::predict_uncertain's Psi2_t and its two einsums (XLA)",
        "tpu_kernel": None,
        "launches": sum(k3_by_path.values()), "launches_by_path": k3_by_path,
        "shape": [k3_main["T"], k3_main["M"], k3_main["Q"], k3_main["D"]],
        "max_abs_err": k3_main["max_abs_err"], "worst_err_over_tol": k3_main["worst_err_over_tol"],
        "ms": k3_main["ms"], "device_ms": k3_main["device_ms"], "launches_per_call": k3_main["launches_per_call"],
        "plain_ms": k3_main["plain_ms"], "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
        "library_ms": None, "library_note": "no single PyTorch call computes it",
        "materialised_ms": k3_main["materialised_ms"], "shapes": k3_rows, "ptxas": ptxas["psi2_contract"],
        "card": card,
    }
    print(json.dumps({"kernels": [
        row("psi2_fwd", "rgp_tpu_torch/csrc/psi2_fwd.cu", "rgp_tpu/ops/pallas/psi2.py:147",
            "rgp_tpu/ops/pallas/psi2.py::_psi2_kernel (_psi2_pallas_raw)", training["k1"],
            {"training": training["k1"], "serving": serving, "config1_restarts_batched": restarts["k1"],
             "config2_training": config2["k1"],
             "config4_training": config4["k1"], "svgp_uncertain_elbo": uncertain["k1"],
             "config5_potential_auto": c5_potential["k1"], "config5_sample_nuts_4chains": c5_sample["k1"],
             "tempered_loglik_auto": tempered_ll["k1"], "tempered_smc": tempered["k1"], **by_path(0)}, k1_rows),
        row("psi2_bwd", "rgp_tpu_torch/csrc/psi2_bwd.cu", "rgp_tpu/ops/pallas/psi2.py:274",
            "rgp_tpu/ops/pallas/psi2.py::_psi2_bwd_kernel (_psi2_bwd_raw)", training["k2"],
            {"training": training["k2"], "serving": 0, "config1_restarts_batched": restarts["k2"],
             "config2_training": config2["k2"],
             "config4_training": config4["k2"], "svgp_uncertain_elbo": uncertain["k2"],
             "config5_potential_auto": c5_potential["k2"], "config5_sample_nuts_4chains": c5_sample["k2"],
             "tempered_loglik_auto": tempered_ll["k2"], "tempered_smc": tempered["k2"], **by_path(1)}, k2_rows),
        k3_row,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
