#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``prob_mbrl_tpu_torch``) on one NVIDIA
card: builds the CUDA kernels from ``prob_mbrl_tpu_torch/csrc``, holds each
against its plain PyTorch version (on Cartpole's shapes, then on those of
the other envs), drives MC-PILCO policy optimisation on Cartpole at
full width through the kernels, on each of its routes and with each option
of the ``utils.rollout`` route (orthogonal mixing, inferred noise,
non-PEGASUS noise, prioritized replay on the native sum tree), then three
Deep-PILCO episodes through the driver on Cartpole and one on each of the
other four analytic envs and on the lunar lander, whose run is then
replayed by ``evaluate_policy``, one on Cartpole learning the reward, and
one of the with-value driver, whose critic the whole-rollout kernel refits;
then the particles sharded over ranks that share the card: the sharded
row 5 (K8), the sharded routes and one sharded episode of the driver; then
model-based DDPG (an iteration, the Q-value rollout and one episode of its
driver) and the conditional density networks (``train_model`` and the two
BNN regression drivers), on rows 1-2; last, the sequence-model driver
(``transformer_models``: its steps and one episode), model ensembles with a
randomized prior, and RAdam and SdLBFGS fits, on rows 1-2.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  0. needs CUDA; TF32 off for matmul and cuDNN; prints the card's name and
     power limit as ``nvidia-smi`` reports them.
  1. builds the kernels (one ``nvcc`` per source, all started together),
     then the native sum tree (``g++``, host code).
  2. each kernel against its plain version on the card. The fused MLP at
     the policy (5->200->200->2, Bernoulli masks) and dynamics
     (6->200->200->10, concrete masks) shapes, B in {1, 37, 100, 1500},
     and the value path's critic (5->200->200->1, concrete masks) at
     B = 1000: forward output, dx, dW, db and d(mask); each launch plan
     (clusters of 8 CTAs) with the clusters of it the card holds at once.
     The rollout step at the main path's widths, B in {2, 37, 100, 1500,
     5761}: (nxt, r) and the cotangents of the policy params, the states
     and eps; its times and launch plans at B = 100 and 5761 (phase 4b's
     batch). The whole rollout at the main path's widths and T = 15,
     B in {16, 37, 100, 1500} with the reward
     mean-only shortcut (and B = 100 without it): loss, mean_return and the
     gradients wrt the policy params and action_eps, by the forward and
     backward kernels and by the one-launch value-and-grad. The step and
     rollout inputs put the pole all round the circle, so rewards range
     from exp(-8) to 1. The grid rollout at the main path's widths and
     T = 15, B in {16, 37, 1000, 1500}, states and rewards moment-matched
     (states only at B = 37): disc, raw, vret, states_all and the gradients
     wrt the policy params and action_eps of random cotangents of all four.
     Each output is held to a tolerance relative to its
     own largest plain value (``hold``). Times at the
     main-path shapes (B = 100): the MLP and step kernels replay the work in
     a CUDA graph, timed with CUDA events; the rollout kernels (cooperative
     launches) are timed with CUDA events around 20 launches in a row; the
     grid kernels the same way at B = 1000 (the value path's) and B = 100,
     with the kernel's own time split (``%globaltimer`` laps of CTA 0:
     weight staging, MLP walk, per-cluster moments, grid barriers, MM
     adjoint, recompute, VJP + dW accumulation, final sums) of the grid
     kernels at B = 1000 and of the one-launch value-and-grad at B = 100,
     each with its launch plan.
  2b. rows 3-9 at the other envs' shapes ([200, 200] MLPs, seeded
     weights, states whose angles span the circle): the double cartpole
     (embedded D = 8, U = 1, exp-quadratic tip reward), rendezvous (D = 8,
     U = 4, four tip rows, the negative quadratic reward, rewards ~ -10^2 to
     -5 10^4), the pendulum (D = 3) and the differentiable lunar lander
     (``JaxLunarLander``, built directly: D = 8, U = 2, the lander's reward,
     reward kind 2), the lander a second time with its policy saturated so
     that the actions sit exactly on the reward's kinks (+-1, the clip's
     ties, and the gates' edges, some |a1| 2^-12 from 0.5), and a learned
     reward (reward kind 3: no reward function, a dynamics head of 2 (D + 1)
     whose output D is the reward) at Cartpole's shapes (D = 5, U = 1) and
     at the lander's (D = 8, U = 2, the Box2D lander's head of 18, states at
     the lander's scales); the step (rows 6-7) and the whole rollout (rows
     3-5, reward mean-only on and off) at B = 100, T = 15, the grid kernels
     (rows 8-9) at B = 1000, states and rewards moment-matched, each output
     held as in phase 2; at D = 8 and with a learned reward each row's
     time, plain time and bound printed beside phase 2's D = 5 ones and the
     card's name and power limit.
  2c. rows 3-5 with the value update's TD(H) critic refit in the launch
     (the with-value driver's [200, 200] concrete-dropout MSE critic, Adam
     1e-4, polyak 1, H = 15) at B = 100 without moment matching (the
     with-value driver's) and B = 1000 with it (phase 7's): loss,
     mean_return, the policy grads and d action_eps as phase 2 holds them
     (d action_eps at B = 1000 per particle, ``hold_rows``), and the refit's
     outputs (v_loss, Adam's mu' and nu' to STEP_TOL of their max|plain| or
     the plain version's sensitivity, and entry by entry where they lie well
     above it, ``hold_entries``; params' and target' by ``hold_adam``, in
     units of lr, at most one entry in 1000 beyond ADAM_TOL); each row's
     time beside its time without a critic, its plain time and its bound
     (the rollout's work and the critic's), and row 5's own time split at
     B = 100.
  2m. rows 3-9 with a mixture dynamics head (``GaussianMixtureDensity``,
     ``--dyn_components K``): Cartpole's shapes with K = 2 (a head of 23)
     and K = 5, the most the kernels take (a head of 56), rows 3-7 at
     B = 100 (3-5 with the reward mean-only shortcut and without) and rows
     8-9 at B = 1000; rows 3-5 with K = 2 and a learned reward, with
     grouped MM (G = 10) and with the critic refit (B = 100, no MM). Each
     output held as in phase 2 against the plain version, whose head
     records its picks (``PickingMixture``): where it fails, the plain
     version again with each pick whose u_cat lies within float32
     rounding of a cumulative sum flipped, at most one pick in 1000 of the
     B T, each logged (``held_against``). Each row's time, plain time and
     bound at both K beside the diagonal head's, with the launch plans and
     the particles the card holds.
  2p. rows 3-9 with the other policy heads: a ``TanhSquashedDensity`` over
     the Gaussian (its own bound 2 inside the policy's 10) on Cartpole and
     a ``CategoricalDensity`` on the differentiable lander (U = 2), rows
     3-7 at B = 100 (3-5 with the reward mean-only shortcut and without)
     and rows 8-9 at B = 1000, held as in phase 2 (the categorical picks
     through ``held_against``, ``PickingCategorical``); each row's time,
     plain time and bound beside the diagonal head's on the same env.
  2w. the wide instance of rows 3-9 (``csrc/fused_step_wide.cu``,
     ``fused_rollout_wide.cu``: D <= 16, U <= 8, a tip of up to 16 rows,
     each moment-matching site factored and differentiated on a warp) at
     the JAX package's benchmark shapes (``bench.py`` ``build()``: D = 5,
     U = 1, a tip of 5 rows, [200, 200]) and at D = 16, U = 8, rows 3-7 at
     B = 100 and 8-9 at B = 1000, held as in phase 2; grouped MM at D = 16
     (groups of 50 and 100, against float64); the wide instance on
     rendezvous's inputs (D = 8, U = 4) against the narrow instance's
     outputs; each wide row's time, plain time and bound beside the narrow
     instance's at D = 8, and row 5's time split at D = 8 in both instances
     and at D = 16 (the moment-matching parts a step).
  2cw. rows 3-5 of the wide instance with phase 2c's critic refit in the
     launch (``csrc/fused_rollout_critic_*_wide.cu``): the JAX benchmark's
     value variant (bench.py ``mc_pilco_none_B100_value``: D = 5, U = 1, a
     tip of 5 rows, B = 100, no MM) and B = 1000 with MM, the same at
     D = 16, U = 8, and there grouped in groups of 50, held as phase 2c
     holds them (grouped against float64); each case's rows timed beside
     the same rows without a critic and phase 2c's narrow rows with it, and
     the critic's part of row 5's own time split.
  3. the route of ``fused_rollout=False``: ``mc_pilco`` with B = 100
     particles, horizon 15, moment matching of states and rewards, on
     dynamics and policy MLPs of [200, 200], every MLP call through the
     fused-MLP kernels (launch counts 2*T*iters each); one iteration is
     compared with the plain (unfused) path on the same initial states and
     noise.
     3v: the same call for 10 iterations with each option no fused tier
     takes (the gate's reason printed): ``mm_method='mix'``,
     ``infer_noise_variables``, ``pegasus=False``, ``prioritized_replay``
     (the native sum tree of 2^20 leaves) at B = 100, and ``'mix'`` at
     B = 1000 (auto-grouped into 4 groups of 250); fused-MLP launches
     exactly 2*T*iters each way, one iteration compared with the plain path
     (with priorities the action-perturbation grads too), the ms an
     iteration beside phase 3's; then the sum tree's host times at 2^20
     leaves (a chunk's draw of 100 and its priority update).
  4. the step tier on the same setup: a loop of
     ``make_fused_value_and_grad(mode='step')``, clip and Adam; the step
     kernels launch T*iters times each; one iteration is compared with the
     plain path. 4b: ``mc_pilco`` on the step tier as the gate picks it, at
     a batch one particle beyond what the card holds of the whole-rollout
     kernel at once (``rollout_capacity``; T*iters step launches each, one
     iteration compared with the plain path).
  5. the main path: the same ``mc_pilco`` call as phase 3 with the default
     ``fused_rollout``, which on CUDA takes the whole-rollout tier: one
     ``fused_rollout_vg`` launch per iteration and no step or fused-MLP
     launch; one iteration through the differentiable whole-rollout loss
     (``fused_rollout_fwd`` and ``_bwd``) is compared with the plain path.
     5m: the same with a mixture dynamics head of K = 2 (``--dyn_components
     2``): the gate names ``'full'``, one ``fused_rollout_vg`` an iteration
     and nothing else, one iteration compared with the plain path, the ms
     an iteration beside phase 5's. 5p: the same (30 iterations) with the
     ``TanhSquashedDensity`` policy head.
  6. the route of ``MCPILCO.loss`` on that tier: a loop of the
     differentiable loss (one forward and one backward kernel per
     iteration), clip and Adam.
  7. the value path: ``mc_pilco`` at B = 1000 with a TD(H) critic (the
     Deep-PILCO with-value driver's default: a [200, 200] concrete-dropout
     MSE critic, Adam 1e-4, polyak 1, H = 15), where the gate names the
     whole-rollout tier: one ``fused_rollout_vg`` per iteration with the
     refit and the bootstrap in it, nothing else; v_loss falling; the ms an
     iteration on that tier and forced to the grid tier (the grid kernels
     and the refit on the fused MLP between them) in turns in this call;
     one iteration on each of the two tiers compared with the plain path
     (loss, mean_return, v_loss, clipped grads, refit critic). Then the same
     under a fixed critic (``value_spec`` and ``value_params``, no update;
     10 iterations): the
     grid tier, one ``fused_grid_fwd`` and ``_bwd`` and one fused-MLP
     launch each way (the bootstrap) an iteration, no refit, the critic's
     params unmoved; one iteration held against the plain path.
     7o: the critic's options in rows 3-5's refit (``CRITIC_OPTION_SETS``:
     angle embedding, concrete input dropout and a swish output; spectral
     norm of every layer; both): rows 3-5 at B = 100 (no MM) with each set
     and at B = 1000 (MM) with both, held as phase 2c holds them and timed
     beside 2c's critic without them; then phase 7's value path with both
     (the gate's ``'full'``, one ``fused_rollout_vg`` an iteration, v_loss
     falling, the tiers' ms, one iteration of each against the plain
     path).
  7w. the value path on the JAX benchmark's value variant at full width
     (D = 5, U = 1, B = 100, T = 15, no MM, the with-value driver's critic,
     H = 15): the gate names ``'full'`` in the wide instance, 20 iterations
     with one ``fused_rollout_vg`` launch of its critic instance each and
     nothing else, v_loss falling, the ms an iteration on that tier and
     forced to ``'grid'`` in turns, one iteration of each tier against the
     plain path (the refit critic's params by the lr rule); then 3
     iterations of ``MCPILCO.loss`` + autograd with the critic (rows 3-4's
     critic instances, for the ``kernels`` line).
  5w. ``mc_pilco`` on the JAX benchmark's workload at D = 16, U = 8, where
     the gate names ``'full'`` in the wide instance: 30 iterations with one
     ``fused_rollout_vg`` (wide) launch each and nothing else; 3 more held
     against the ``utils.rollout`` route (each loss; the params by the lr
     rule, ``hold_lr``); one iteration against the plain path; then 5
     iterations of each of the step, loss and grid tiers (their wide
     kernels' launches for the ``kernels`` line).
  8. the episode: the torch ``deep_pilco_mm`` driver (``main`` through the
     port's parser with the entry point's settings) on Cartpole into a
     temporary folder under ``build/``, at full width (dynamics and policy
     [200, 200], fit batch 100, 100 particles, horizon 15, 40 control
     steps) with three cuts: 2 episodes instead of 100, 500 fit steps
     instead of 2000 and 200 policy iterations an episode instead of 1000.
     Per episode: E_lml (and
     its first- and last-50 means, the last above the first), imagined and
     real return, ms per fit step and per policy iteration; every value
     finite; launch counts exactly fused-MLP forward 2*(500 + 40) (a fit
     step and a control step each launch one), backward 2*500 and
     ``fused_rollout_vg`` 2*200, nothing else; the tier the gate names for
     the driver's configuration (``'full'``); from the checkpoint, one fit
     step through the kernels against the plain path on the same minibatch
     and noise (loss and every grad, logit_p's among them) and the fit's
     device-busy share over 50 steps under torch.profiler.
  9. the envs: one episode of phase 8's driver, widths and cuts, the fit
     cut further to 150 steps (100 policy iterations, 40 control steps,
     seed 1) on each of
     Pendulum, DoubleCartpole, CartAcrobot, Rendezvous and LunarLander
     (``-e``; the class ``make('LunarLander')`` gives is printed: the
     differentiable lander without Box2D, as the JAX registry has it, else
     the Box2D one): every value finite, E_lml rising within the fit, the
     gate's tier ``'full'`` and launch counts exactly fused-MLP forward
     150 + the control steps taken (40, or fewer where the lander's
     episode ends), backward 150 and ``fused_rollout_vg`` 100 (on the
     Box2D lander, which has no reward function, the driver learns the
     reward, which row 5 takes as reward kind 3); from the checkpoint one
     fit step (loss and every grad within 1e-4 of its max|plain|) and one
     policy iteration through row 5 (loss and grads within the plain
     path's sensitivity, at least 1e-4 of |loss| and 1e-3 of max|grad|)
     against their plain paths; ms a fit step and a policy iteration per
     env; then the lander's run replayed by ``evaluate_policy.evaluate``
     once a snapshot on the card (one finite return per snapshot, no
     matplotlib imported). Last, one such episode of ``deep_pilco_mm
     --learn_reward`` on Cartpole: the learned reward on the whole-rollout
     kernel (kind 3), ``fused_rollout_vg`` 200 and no fused-MLP launch from
     the policy loop, E_lml rising, a fit step and a row-5 policy iteration
     held against their plain paths; then one of ``deep_pilco_mm
     --dyn_components 2``, held the same way: the mixture head fitted
     through rows 1-2 (a head of 23) and sampled in row 5; last, one of
     ``deep_pilco_mm --mm_method experimental_mix --prioritized_replay
     --plot_level 0`` (the card's machine has no matplotlib): the gate
     takes no tier, the policy loop on the ``utils.rollout`` route
     (fused-MLP launches 2 T an iteration each way besides the fit's and
     the control steps'), priority scores finite, one fit step held.
  10. the with-value driver: one ``deep_pilco_no_mm_with_value`` episode
     with phase 8's widths and cuts (no moment matching, the [200, 200] MSE
     critic refit every policy iteration): launches exact (fused-MLP forward
     500 + 40, backward 500, ``fused_rollout_vg`` 200 with the refit in
     each, nothing else), every value finite (v_loss too), E_lml rising, one
     fit step held against the plain path; v_loss over the episode and the
     ms a fit step and a policy iteration.
  11. particle sharding (``parallel``) over gloo ranks spawned once for the
     phase, sharing the one card (NCCL refuses two ranks on one device;
     ``torch.cuda.device_count()`` is printed): 11a K8, row 5 on each rank's
     slice with one all-reduce of loss, mean_return and grads, at B = 100,
     T = 15 in 10 MM groups on 2 ranks, in 20 groups on 4 ranks, without
     MM on 2 ranks and, with the mixture head of K = 2, in 10 groups on 2
     ranks, each held against one unsharded row-5 launch at B = 100
     on the same inputs and against the plain version (in float64 with
     groups, as phase 2g holds row 5), exactly one ``fused_rollout_vg`` and
     one all-reduce on each rank, and its ms a call beside the unsharded
     launch's; 11b phase 5g's ``mc_pilco`` call on 2 ranks (100 iterations:
     exactly 100 ``fused_rollout_vg`` launches and 100 all-reduces on each
     rank, the first 4 losses within rtol 1e-3 / atol 1e-6 of phase 5g's,
     the params' bits the same on both ranks, ms an iteration beside 5g's);
     11c phase 3's ungrouped-MM route on 2 ranks (5 iterations, fused-MLP
     launches and all-reduces exact, losses against phase 3's); 11d the step
     tier on each rank at twice phase 4g's batch (10 iterations, step
     launches exact); 11e one ``deep_pilco_mm --n_devices 2 --dist_backend
     gloo --mm_groups 10`` episode at phase 8's widths, the fit cut to 100
     steps and the policy to 50 iterations (launches exact on each rank,
     E_lml rising, one results folder, written by rank 0 alone). Ranks that
     share a card measure no multi-card speed, and NCCL is not run.
  12. model-based DDPG at the MBDDPG driver's widths (Cartpole, D = 5,
     U = 1, actor, critic and dynamics [200, 200], a learned reward, B =
     100, T = 15): one ``make_ddpg_iteration_fn`` iteration with exactly
     7 T fused-MLP forward and 3 T backward launches, held against the same
     iteration on unfused MLPs with the same draws (metrics within 1e-4 of
     their size or the plain path's sensitivity, params by the lr rule,
     ``hold_lr``) and timed (ms an iteration, host clock; the device's
     busy share over 3 iterations under torch.profiler);
     ``rollout_with_Qvalues`` (3 T + 2 forward launches) held the same way;
     then one episode of ``examples/mbddpg.py --ps_iters 1 --n_rnd_epi 2``
     cut to 500 fit steps and 20 DDPG iterations (40 control
     steps), launches exact.
  13. the conditional density networks: ``train_model`` (5 steps, batch
     100) of ``density_network_mlp`` and ``mixture_density_network_mlp`` at
     relu [200, 200] on each BNN regression dataset, one fused-MLP forward
     and backward a step, held against the unfused MLP; then the
     ``bnn_regression`` and ``bnn_regression_2d`` drivers at 200 steps a
     model: their hhSinLU MLPs stay off the kernel (no launch), NLL finite,
     ms a step.
  14. the sequence-model driver, ensembles and the optimisers, on rows 1-2:
     14b one episode of ``transformer_models.main`` (``TM_ARGV``; Cartpole,
     a transformer of 64 wide, 4 layers of 4 heads, the [64, 64]
     Bernoulli-dropout policy; 100 dynamics, 200 flow and 20 policy steps
     of 25 x0s and T = 16, 40 control steps): launches exactly 20 x 16 + the
     control steps forward and 20 x 16 backward, values
     finite, E_lml rising, ms a dyn, flow and pol step; then 14a on its
     trained models one ``pol_step`` with exactly 16 fused-MLP forward and
     16 backward launches, held against the unfused policy on the same
     draws (loss within 1e-4 of its size or 3 times the plain path's
     sensitivity, params by ``hold_lr``), one ``dyn_step`` and one
     ``flow_step`` held the same way against the same steps on CPU
     tensors, and the policy step's device-busy share under torch.profiler;
     14c ``make_ensemble_train_fn`` at 5 members of the main
     path's dynamics (6 -> [200, 200] -> 10, concrete dropout), batch 100,
     bootstrap masks, 50 steps (exactly 5 x 50 launches each way) held
     against the unfused members on the same draws, then one
     ``train_regressor`` step of a ``RandomPriorMLP``-backed regressor (2
     forward, 1 backward launch) held the same way; 14d ``train_regressor``
     steps on the same dynamics with ``RAdam`` and ``SdLBFGS`` at their
     defaults, 20 each through the kernels, held against unfused, ms a
     step.

Each kernel's launches in the ``kernels`` line come from the run of the
route that carries it (rows 1-2 phase 8, the episode; rows 6-7 phase 4,
row 5 phase 5, rows 3-4 phase 6, rows 8-9 phase 7's fixed critic; the wide
instance's phase 5w, its critic instances phase 7w), with every count set
to 0 just before the run.

``tools/profile_torch_main_path.py`` breaks a main-path iteration down
(host split and a torch.profiler trace) on the same setup.

It imports nothing of JAX and nothing of the JAX package.
"""
import collections
import contextlib
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from prob_mbrl_tpu_torch import envs, native
from prob_mbrl_tpu_torch import parallel as tpar
from prob_mbrl_tpu_torch.algorithms import mbddpg as ddpg
from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                     make_mc_pilco_fn,
                                                     mc_pilco,
                                                     seeded_generator,
                                                     update_priorities)
from prob_mbrl_tpu_torch.algorithms.value import Adam, make_value_update_fn
from prob_mbrl_tpu_torch.examples import bnn_regression as bnn
from prob_mbrl_tpu_torch.examples import bnn_regression_2d as bnn2
from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc
from prob_mbrl_tpu_torch.examples import deep_pilco_mm as dpm
from prob_mbrl_tpu_torch.examples import deep_pilco_no_mm_with_value as dvm
from prob_mbrl_tpu_torch.examples import evaluate_policy
from prob_mbrl_tpu_torch.examples import mbddpg as ddpg_driver
from prob_mbrl_tpu_torch.examples import transformer_models as tmd
from prob_mbrl_tpu_torch.models import (CategoricalDensity,
                                        DiagGaussianDensity, DynamicsModel,
                                        GaussianMixtureDensity, MLPSpec,
                                        ModelEnsemble, Policy,
                                        RandomPriorMLP, Regressor,
                                        TanhSquashedDensity, bdropout,
                                        bootstrap_masks, cdropout,
                                        density_network_mlp,
                                        make_ensemble_train_fn,
                                        mixture_density_network_mlp)
from prob_mbrl_tpu_torch.ops.cuda import build, critic
from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as fr
from prob_mbrl_tpu_torch.ops.math import clip_grad_norm
from prob_mbrl_tpu_torch.ops.moment_matching import standardize_noise
from prob_mbrl_tpu_torch.optim import RAdam, SdLBFGS
from prob_mbrl_tpu_torch.utils.apply_controller import apply_controller
from prob_mbrl_tpu_torch.utils.checkpoint import load_checkpoint
from prob_mbrl_tpu_torch.utils.core import tree_leaves, tree_map
from prob_mbrl_tpu_torch.utils.experience import ExperienceDataset
from prob_mbrl_tpu_torch.utils.rollout import rollout_with_Qvalues
from prob_mbrl_tpu_torch.utils.train_model import train_model
from prob_mbrl_tpu_torch.utils.train_regressor import (make_train_fn,
                                                       normalize_dataset)

# published H100 SXM peaks: HBM bytes/s, float32 FLOP/s outside the tensor
# cores (the kernels use float32 FMA)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

SHAPES = {'policy': ((5, 200, 200, 2), 'bernoulli'),
          'dynamics': ((6, 200, 200, 10), 'concrete')}
# the value path's critic (phase 7), whose refit runs the fused MLP at B = 1000
CRITIC = ((5, 200, 200, 1), 'concrete')
BATCHES = (1, 37, 100, 1500)
MAIN_B = 100
MAIN_T = 15
ITERS = 100  # MC-PILCO iterations of the main path (an episode runs 1000)
ROUTE_ITERS = 30  # iterations of the fused-MLP route (phase 3)
STEP_ITERS = 100  # iterations of the step tier (phase 4)
STEP_ROUTE_ITERS = 10  # mc_pilco iterations on the step tier (phase 4b)
LOSS_ITERS = 30  # iterations of the differentiable rollout loss (phase 6)
STEP_BATCHES = (2, 37, 100, 1500, 5761)
# the step tier's batch where the gate sends it (phase 4b: one particle
# beyond what an H100 holds of the whole-rollout kernel at once)
STEP_BIG_B = 5761
ROLLOUT_BATCHES = (16, 37, 100, 1500)
GRID_BATCHES = (16, 37, 1000, 1500)
GRID_B = 1000  # particles of the value path (phase 7)
VALUE_ITERS = 100  # mc_pilco iterations of the value path
FIXED_ITERS = 10  # mc_pilco iterations under a fixed critic (phase 7)
ROLLOUT_LAUNCHES = 20  # launches timed in a row per rollout kernel
# phase 2g: grouped MM (mm_groups) at B = 100 (rows 3-7) and 1000 (rows 8-9)
GROUPS_B100 = (10, 50)
GROUPS_B1000 = (100, 500)
GROUPED_CRITIC = 10  # phase 2c's grouped case: rows 3-5 with the critic
MIXTURE_KS = (2, 5, 8, 16)  # phase 2m: mixture heads on every row
MIXTURE_BIG_K = 32  # phase 2m: rows 3-5 at B = MAIN_B
WIDE_MIXTURE_K = 8  # phase 2w: a mixture head at D = 16, U = 8
MANY_K = 8  # phase 5m: the main path with --dyn_components 8
GROUPS_MAIN = 10  # phase 5g: the main path with mm_groups
GROUPED_ROUTE_ITERS = 5  # phase 5g: iterations on the utils.rollout route
ITER_MS = {}  # ms an iteration of each mc_pilco run, by its tag
LOSSES = {}  # the losses of each mc_pilco run, by its tag
# phase 2b: rows 3-9 at these envs' shapes (rows 3-7 at B = MAIN_B, rows 8-9
# at B = GRID_B), each row timed at D = 8 and with a learned reward: (env,
# learned); the last two learn the reward (the kernels' reward kind 3):
# Cartpole's shapes (a head of 12) and the lander's (D = 8, U = 2, a head of
# 18: the Box2D lander's, whose reward the driver learns)
ENV_KERNEL_ENVS = (('DoubleCartpole', False), ('Rendezvous', False),
                   ('Pendulum', False), ('JaxLunarLander', False),
                   ('Cartpole', True), ('JaxLunarLander', True))
SEED = 1
# phase 8, the episode: the deep_pilco_mm driver at its full widths and
# default fit, with the episodes cut from 100 to 3 and the policy
# iterations from 1000 to 200
EPISODES = 2
EPISODE_POL_ITERS = 200
FIT_ITERS = 500
CONTROL_H = 40
EPISODE_ARGV = ['--seed', str(SEED), '--ps_iters', str(EPISODES),
                '--pol_opt_iters', str(EPISODE_POL_ITERS),
                '--dyn_opt_iters', str(FIT_ITERS), '--dyn_batch_size', '100',
                '--pol_batch_size', str(MAIN_B), '--pred_H', str(MAIN_T),
                '--control_H', str(CONTROL_H), '--dyn_shape', '200,200',
                '--pol_shape', '200,200']
BUSY_STEPS = 50  # fit steps under torch.profiler
# phase 9: one episode of the same driver and cuts on each of these envs, then
# one on Cartpole with --learn_reward (the rollout kernels' reward kind 3),
# each fit cut further to ENV_FIT_ITERS steps and its policy to ENV_POL_ITERS
# iterations
ENV_FIT_ITERS = 150
ENV_POL_ITERS = 100
ENV_EPISODE_ENVS = ('Pendulum', 'DoubleCartpole', 'CartAcrobot', 'Rendezvous',
                    'LunarLander')
# kernel vs plain version, per output: |kernel - plain| <= REL_TOL *
# max|plain| (float32 products summed in another order; no TF32 on either
# side); the step and the rollout STEP_TOL * max|plain|, or the plain
# version's own sensitivity (see phase_step_kernels)
REL_TOL = 1e-4
STEP_TOL = 1e-3

# phase 2o: the model options rows 3-9 take (build_models' options): B1
# spectral norm, B2 input dropout and output nonlinearities, B3 angle
# embedding inside the models, and all three
OPTION_SETS = {'B1': ('sn',), 'B2': ('drop',), 'B3': ('ang',),
               'B1-B3': ('sn', 'drop', 'ang')}
ALL_OPTIONS = OPTION_SETS['B1-B3']
OPTION_ITERS = 30  # phase 5o: the main path with B1-B3
# phase 2p: the policy heads rows 3-9 take besides the diagonal Gaussian,
# each on an env with its action dims (a categorical head of one action is
# degenerate: its one-hot is always 1): the TanhSquashedDensity (its own
# bound HEAD_MAX_U) on Cartpole, the CategoricalDensity on the
# differentiable lander (U = 2)
HEAD_MAX_U = 2.0
HEAD_ENVS = (('tanh', 'Cartpole'), ('cat', 'JaxLunarLander'))
HEAD_ITERS = 30  # phase 5p: the main path with the tanh head
# phase 7o: the critic's model options in the refit (critic_spec): B angle
# embedding, concrete input dropout 0.1 and a swish output, C spectral norm
# of every layer, and all of them
CRITIC_OPTION_SETS = {'B': ('ang', 'drop', 'out'), 'C': ('sn',),
                      'B+C': ('ang', 'drop', 'out', 'sn')}
CRITIC_OPTIONS = CRITIC_OPTION_SETS['B+C']
BF16_ROUTE_ITERS = 10  # phase 3h: phase 3's route on fused bf16 MLPs
BF16_FIT_STEPS = 100  # phase 3h: train_regressor on a fused bf16 dynamics MLP
# the bf16 instances' bound: float32 bytes over HBM_BYTES_PER_S, products
# over the published dense bf16 tensor-core peak
BF16_FLOP_PER_S = 989e12
BF16 = ('fused_mlp_fwd_bf16', 'fused_mlp_bwd_bf16')
# phase 2w: rows 3-9 and grouped MM in the wide instance of the rollout
# kernels (D <= 16, U <= 8, a tip of up to 16 rows): the JAX package's own
# benchmark workload (bench.py build(): D = 5, U = 1, [200, 200], its reward
# exp(-0.5 (|s|^2 + 1e-4 |a|^2)), a tip of 5 rows, which the narrow
# instance's 4 do not take; envs.state_reward) and the same at D = 16,
# U = 8; rows 3-7 at B = MAIN_B, 8-9 at GRID_B, grouped at D = 16 in groups
# of 50 (rows 3-7) and 100 (rows 8-9), every group full rank (B / G > D)
BENCH_SHAPES = {'Bench5': (5, 1), 'Bench16': (16, 8)}
WIDE_ENVS = ('Bench5', 'Bench16')
WIDE_GROUPS = (2, 10)  # groups at B = MAIN_B, at GRID_B
# the narrow instance's env whose rows phase 2w runs again in the wide one
WIDE_ON_NARROW = 'Rendezvous'
# phase 5w: mc_pilco on the wide instance's whole-rollout tier at D = 16,
# U = 8; WIDE_ROUTE_ITERS of them held against the utils.rollout route; the
# step, loss and grid tiers' loops (their launch counts) WIDE_LOOP_ITERS each
WIDE_ITERS = 30
WIDE_ROUTE_ITERS = 3
WIDE_LOOP_ITERS = 5
WIDE_LR = 1e-3  # mc_pilco's Adam
# phase 2cw: rows 3-5 of the wide instance with the critic refit, (env, B,
# MM, groups): the JAX benchmark's value variant (bench.py
# mc_pilco_none_B100_value: D = 5, B = 100, no MM) and phase 7's B = 1000
# with MM, the same at D = 16, U = 8, and there grouped in groups of 50
WIDE_CRITIC_CASES = (('Bench5', MAIN_B, False, None),
                     ('Bench5', GRID_B, True, None),
                     ('Bench16', MAIN_B, False, None),
                     ('Bench16', GRID_B, True, None),
                     ('Bench16', MAIN_B, True, WIDE_GROUPS[0]))
WIDE_VALUE_ITERS = 20  # phase 7w: mc_pilco on the benchmark's value variant
WIDE_VALUE_LOSS_ITERS = 3  # phase 7w: MCPILCO.loss + autograd with the critic

SOURCES = {'fused_mlp_fwd': 'prob_mbrl_tpu_torch/csrc/fused_mlp.cu',
           'fused_mlp_bwd': 'prob_mbrl_tpu_torch/csrc/fused_mlp.cu',
           'fused_mlp_fwd_bf16': 'prob_mbrl_tpu_torch/csrc/fused_mlp.cu',
           'fused_mlp_bwd_bf16': 'prob_mbrl_tpu_torch/csrc/fused_mlp.cu',
           'fused_step_fwd': 'prob_mbrl_tpu_torch/csrc/fused_step.cu',
           'fused_step_bwd': 'prob_mbrl_tpu_torch/csrc/fused_step.cu',
           'fused_rollout_fwd': 'prob_mbrl_tpu_torch/csrc/fused_rollout.cu',
           'fused_rollout_bwd': 'prob_mbrl_tpu_torch/csrc/fused_rollout.cu',
           'fused_rollout_vg': 'prob_mbrl_tpu_torch/csrc/fused_rollout.cu',
           'fused_grid_fwd': 'prob_mbrl_tpu_torch/csrc/fused_rollout.cu',
           'fused_grid_bwd': 'prob_mbrl_tpu_torch/csrc/fused_rollout.cu',
           # the wide instance (phase 2w): the same device code with
           # WideLimits
           'fused_step_fwd_wide':
               'prob_mbrl_tpu_torch/csrc/fused_step_wide.cu',
           'fused_step_bwd_wide':
               'prob_mbrl_tpu_torch/csrc/fused_step_wide.cu',
           'fused_rollout_fwd_wide':
               'prob_mbrl_tpu_torch/csrc/fused_rollout_wide.cu',
           'fused_rollout_bwd_wide':
               'prob_mbrl_tpu_torch/csrc/fused_rollout_wide.cu',
           'fused_rollout_vg_wide':
               'prob_mbrl_tpu_torch/csrc/fused_rollout_wide.cu',
           'fused_grid_fwd_wide':
               'prob_mbrl_tpu_torch/csrc/fused_rollout_wide.cu',
           'fused_grid_bwd_wide':
               'prob_mbrl_tpu_torch/csrc/fused_rollout_wide.cu',
           # the wide instance's rows 3-5 with the critic refit (phase 2cw)
           'fused_rollout_fwd_wide_critic':
               'prob_mbrl_tpu_torch/csrc/fused_rollout_critic_fwd_wide.cu',
           'fused_rollout_bwd_wide_critic':
               'prob_mbrl_tpu_torch/csrc/fused_rollout_critic_bwd_wide.cu',
           'fused_rollout_vg_wide_critic':
               'prob_mbrl_tpu_torch/csrc/fused_rollout_critic_vg_wide.cu'}
REPLACES = {'fused_mlp_fwd': 'prob_mbrl_tpu/ops/pallas/fused_mlp.py:222',
            'fused_mlp_bwd': 'prob_mbrl_tpu/ops/pallas/fused_mlp.py:247',
            'fused_mlp_fwd_bf16': 'prob_mbrl_tpu/ops/pallas/fused_mlp.py:222',
            'fused_mlp_bwd_bf16': 'prob_mbrl_tpu/ops/pallas/fused_mlp.py:247',
            'fused_step_fwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:1166',
            'fused_step_bwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:1206',
            'fused_rollout_fwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:813',
            'fused_rollout_bwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:859',
            'fused_rollout_vg': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:981',
            'fused_grid_fwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:1462',
            'fused_grid_bwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:1542'}
WIDE_KERNELS = tuple(n for n in SOURCES if n.endswith('_wide'))
WIDE_CRITIC_KERNELS = tuple(n for n in SOURCES if n.endswith('_wide_critic'))
REPLACES.update({n: REPLACES[n[:-len('_wide')]] for n in WIDE_KERNELS})
REPLACES.update({n: REPLACES[n[:-len('_wide_critic')]]
                 for n in WIDE_CRITIC_KERNELS})


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain version
# ---------------------------------------------------------------------------


def mlp_problem(dims, masks, B, seed):
    """Inputs of one fused-MLP call, made with numpy from a seed:
    (x, ws, bs, ms, g) with masks as the main path builds them."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    x = t(rng.randn(B, dims[0]))
    ws = [t(rng.randn(a, b) * np.sqrt(2.0 / (a + b)) * np.sqrt(2.0))
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [t(rng.uniform(-0.1, 0.1, b)) for b in dims[1:]]
    ms = []
    for d in dims[1:-1]:
        u = rng.rand(B, d)
        ms.append(t((u < 0.9) / 0.9 if masks == 'bernoulli' else u < 0.9))
    g = t(rng.randn(B, dims[-1]))
    return x, ws, bs, ms, g


def hold(what, a, r, rel_tol, moved=None):
    """Hold a kernel's output ``a`` against the plain version's ``r``: ``a``
    is finite and max|a - r| <= rel_tol * max|r|, or, given the plain
    version's output ``moved`` on inputs moved by 1e-6 relative, 3 *
    max|moved - r| where that is larger. Returns (max abs err, err /
    max|r|, tolerance / max|r|)."""
    if not torch.isfinite(a).all():
        raise AssertionError(f'{what}: kernel output is not finite')
    err = float((a - r).abs().max())
    scale = float(r.abs().max())
    tol = rel_tol * scale
    if moved is not None:
        tol = max(tol, 3 * float((moved - r).abs().max()))
    if err > tol:
        raise AssertionError(f'{what}: max abs err {err:.3e} > tolerance '
                             f'{tol:.3e} (max|plain| {scale:.3e})')
    if not scale:
        return err, 0.0, 0.0
    return err, err / scale, tol / scale


def hold_rows(what, a, r, rel_tol, moved=None, along=None):
    """Hold a per-particle gradient (the grid rollout's d action_eps): the
    2-norm of ``a - r`` within ``rel_tol`` of ``r``'s, and at most one
    element in 1000 beyond ``hold``'s elementwise tolerance. A ReLU unit
    whose pre-activation lies within float32 rounding of 0 takes the other
    branch in one of the two versions (their sums run in another order);
    that moves one particle's entry alone, far beyond the elementwise
    tolerance at B = 1000 (the plain version in float32 against float64
    does the same at other places), while a fault in a row, a step or a
    block moves the norm. Given ``along``, the plain version forced along
    the kernel's own states (``hold_grid_eps_on_edge``), the worst particle
    in each 1000 is left out of the norm and each of its entries must lie
    within the elementwise tolerance of ``along``'s: a particle that the
    trajectories' drift moved across a ReLU's edge. Returns (max abs err,
    the norm's relative error, rel_tol)."""
    if not torch.isfinite(a).all():
        raise AssertionError(f'{what}: kernel output is not finite')
    scale = float(r.abs().max())
    tol = rel_tol * scale
    if moved is not None:
        tol = max(tol, 3 * float((moved - r).abs().max()))
    d = (a - r).abs()
    off = int((d > tol).sum())
    diff, left = a - r, []
    if along is not None:
        per = diff.double().pow(2).sum((0, 2))
        left = torch.topk(per, a.shape[1] // 1000).indices.tolist()
        off_along = float((a - along)[:, left].abs().max()) if left else 0.0
        if off_along > tol:
            raise AssertionError(f'{what}: particle(s) {left} left out of '
                                 f'the norm lie {off_along:.3e} from the '
                                 f'plain version along the kernel\'s '
                                 f'states, beyond {tol:.3e}')
        diff = diff.clone()
        diff[:, left] = 0
    n_err, n_ref = float(torch.linalg.vector_norm(diff)), float(
        torch.linalg.vector_norm(r))
    if n_err > rel_tol * n_ref or off * 1000 > d.numel():
        raise AssertionError(f'{what}: |kernel - plain| {n_err:.3e} against '
                             f'|plain| {n_ref:.3e}, {off} of {d.numel()} '
                             f'elements beyond {tol:.3e}')
    if off or left:
        log(f'[phase 2] {what}: {off} of {d.numel()} elements beyond '
            f'{tol:.3e} (largest {float(d.max()):.3e}), norm relative error '
            f'{float(torch.linalg.vector_norm(a - r)) / n_ref:.3e}'
            + (f', {n_err / n_ref:.3e} without particle(s) {left}'
               if left else ''))
    return float(d.max()), n_err / max(n_ref, 1e-30), rel_tol


# the plain versions' mixture picks (phase 2m, ``PickingMixture``): each
# sample call's record, the calls of one forward (T), and the picks to take
# instead of the drawn ones, {(step, particle): component}
PICKS = {'calls': [], 'T': 1, 'force': {}}
Pick = collections.namedtuple('Pick', 'cdf margin idx alt')


def recorded_pick(soft, u):
    """The hard pick ``sum_j (u > cumsum(soft)_j)`` of each row, as the
    heads compute it, recorded in ``PICKS['calls']`` (the cumulative sums,
    u's distance from the nearest, the pick and the index across that sum)
    and replaced where ``PICKS['force']`` names this call's rows."""
    cdf = torch.cumsum(soft, -1)
    idx = torch.sum((u > cdf).to(torch.int64), -1)
    gap = (u - cdf).detach()
    near = gap.abs().argmin(-1)
    side = torch.gather(gap, -1, near[..., None])[..., 0]
    t = len(PICKS['calls']) % PICKS['T']
    PICKS['calls'].append(Pick(cdf.detach(), side.abs(), idx.detach(),
                               torch.where(side > 0, near, near + 1)))
    force = {b: j for (c, b), j in PICKS['force'].items() if c == t}
    if force:
        idx = idx.clone()
        for b, j in force.items():
            idx[b] = j
    return idx


class PickingMixture(GaussianMixtureDensity):
    """The mixture head of the plain versions in phase 2m: samples as
    ``GaussianMixtureDensity`` does (the same operations, so the same
    bits), its pick through ``recorded_pick`` (call t of a forward of
    ``PICKS['T']`` steps)."""

    def sample(self, x, noise, scaling_params=None, sampling_temperature=0.1):
        mean, log_std, logit_pi = self.distribution(x, scaling_params)
        K = self.n_components
        k_soft = torch.softmax(
            (torch.log_softmax(logit_pi, -1) + noise['z_pi'])
            / sampling_temperature, -1)
        idx = recorded_pick(k_soft, noise['u_cat'])
        hard = (idx[..., None] == torch.arange(K, device=idx.device)).to(
            k_soft.dtype)
        k = ((hard - k_soft).detach() + k_soft)[..., None, :]
        samples = torch.sum(mean * k, -1)
        stds = torch.exp(torch.sum(log_std * k, -1))
        return samples + noise['z_normal'] * stds


class PickingCategorical(CategoricalDensity):
    """The categorical policy head of the plain versions in phase 2p:
    samples as ``CategoricalDensity`` does (the same operations), its pick
    through ``recorded_pick``."""

    def apply(self, x, noise=None, return_samples=False,
              sampling_temperature=0.1):
        if not return_samples:
            return x[..., :self.output_dims]
        soft = torch.softmax(
            (torch.log_softmax(x, -1) + noise['z']) / sampling_temperature,
            -1)
        idx = recorded_pick(soft, noise['u_cat'])
        hard = (idx[..., None] == torch.arange(
            self.output_dims, device=idx.device)).to(soft.dtype)
        return (hard - soft).detach() + soft


def picking_pol(pol):
    """``pol`` with a categorical head a ``PickingCategorical`` (any other
    head as it is): the policy of the plain versions in phase 2p."""
    d = pol.output_density
    if not isinstance(d, CategoricalDensity):
        return pol
    return dataclasses.replace(pol, output_density=PickingCategorical(
        d.output_dims))


def picking(dyn):
    """``dyn`` with its mixture head a ``PickingMixture`` (a diagonal head
    as it is): the models of the plain versions in phase 2m."""
    d = dyn.regressor.output_density
    if not isinstance(d, GaussianMixtureDensity):
        return dyn
    return dataclasses.replace(dyn, regressor=dataclasses.replace(
        dyn.regressor, output_density=PickingMixture(
            d.output_dims, d.n_components, d.max_noise_std)))


EDGE_SENS = 10  # an edge pick: u_cat within 10x the cdfs' own sensitivity


def pick_variants(plain_outputs, T, what):
    """The plain version's outputs, ``plain_outputs()`` (its first forward
    the reference, its second that on inputs moved by 1e-6 relative), as
    drawn; then, for a mixture head, with the picks on an edge flipped to
    the component across their sum. An edge pick is one whose u_cat lies
    within EDGE_SENS times the largest change of a cumulative sum between
    those two forwards: float32 rounding in another order may pick the
    other component there, which moves that particle's step and, through
    the moments, every particle after it. At most one pick in 1000 of the
    B T may be flipped: each edge pick alone, in order of its distance,
    then all of them, where they are that few; each variant is logged.
    The caller holds the kernel against each in turn until one holds."""
    PICKS['calls'], PICKS['T'], PICKS['force'] = [], T, {}
    out = plain_outputs()
    calls = PICKS['calls']
    yield out
    if not calls:
        return
    ref, moved = calls[:T], calls[T:2 * T]
    sens = max(float((a.cdf - b.cdf).abs().max()) for a, b in zip(ref, moved))
    tol = EDGE_SENS * max(sens, 1e-7)
    edges = sorted((float(c.margin[b]), t, b, int(c.alt[b]))
                   for t, c in enumerate(ref)
                   for b in torch.nonzero(c.margin < tol)[:, 0].tolist())
    allowed = max(1, ref[0].idx.numel() * T // 1000)
    log(f'[picks] {what}: {len(edges)} pick(s) on an edge (u_cat within '
        f'{tol:.2e} of a cumulative sum, {EDGE_SENS}x the sums\' change '
        f'{sens:.2e} under inputs moved by 1e-6 relative); at most '
        f'{allowed} may be flipped')
    tries = [[e] for e in edges[:8]]
    if 1 < len(edges) <= allowed:
        tries.append(edges)
    for flips in tries:
        PICKS['calls'], PICKS['force'] = [], {(t, b): j
                                              for _, t, b, j in flips}
        log(f'[picks] {what}: the plain version with '
            + ', '.join(f'step {t} particle {b} on component {j} (u_cat '
                        f'{m:.2e} from the sum)' for m, t, b, j in flips))
        yield plain_outputs()
    PICKS['force'] = {}


def held_against(what, plain_outputs, T, hold_all):
    """``hold_all(outputs)`` against each of ``pick_variants``' plain
    outputs in turn: the first that holds, or the first failure raised."""
    first = None
    try:
        for out in pick_variants(plain_outputs, T, what):
            try:
                result = hold_all(out)
            except AssertionError as e:
                first = first or e
                continue
            if first is not None:
                log(f'[picks] {what}: held against that variant (as '
                    f'drawn: {first})')
            return result
    finally:
        PICKS['force'] = {}
    raise first


def in_float64(x):
    """``x`` (a tensor, or a dict, list or tuple of them) with its floating
    tensors cast to float64, differentiably (gradients reach float32
    leaves)."""
    if torch.is_tensor(x):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: in_float64(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, '_fields'):
        return type(x)(*(in_float64(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(in_float64(v) for v in x)
    return x


def rel_err(a, r):
    """max|a - r| relative to max|r|."""
    return float((a - r).abs().max()) / max(float(r.abs().max()), 1e-30)


def float64(fn):
    """The plain version ``fn`` run in float64 on float32 inputs: the
    reference of the grouped rows (phase 2g). A group of 10 particles in
    D = 5 has a covariance whose eigenvalues span ~1e-5, and the float32
    plain version's autograd through the group's mean and Cholesky loses
    up to ~4e-3 of a gradient there, where the kernels' adjoint keeps
    ~2e-6 (PERF.md). Also the reference of a mixture head's rows (phase
    2m): the float32 plain version's autograd through the head's pick lost
    up to 1.7e-3 of a gradient at K = 32 and 8.3e-3 of the grid's d
    action_eps at D = 16, K = 8, where the kernels kept 1.5e-6 of float64
    (``tools/torch_mixture_precision.py``)."""
    return lambda *a, **k: fn(*in_float64(a), **in_float64(k))


def grads_through(fn, x, ws, bs, ms, g):
    leaves = [v.detach().clone().requires_grad_(True) for v in
              [x, *ws, *bs, *ms]]
    n = len(ws)
    lx, lw, lb, lm = (leaves[0], leaves[1:1 + n], leaves[1 + n:1 + 2 * n],
                      leaves[1 + 2 * n:])
    out = fn(lx, lw, lb, lm, ('relu', 'relu'))
    out.backward(g)
    return [out.detach()] + [v.grad for v in leaves]


def mlp_bytes_flops(dims, B):
    """Bytes each kernel must move (inputs read once, outputs written once)
    and the operations it does, for one call at batch B."""
    hid = dims[1:-1]
    w = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    b = sum(dims[1:])
    h = B * sum(hid)
    fwd_bytes = 4 * (B * dims[0] + w + b + h + h + B * dims[-1])
    fwd_flops = 2 * B * w + B * dims[-1] + B * sum(hid) * 3
    bwd_bytes = 4 * (B * dims[0] + w + h + h + B * dims[-1]
                     + B * dims[0] + w + b + h)
    bwd_flops = 4 * B * w + B * sum(dims[1:]) + 5 * h
    return {'fused_mlp_fwd': (fwd_bytes, fwd_flops),
            'fused_mlp_bwd': (bwd_bytes, bwd_flops)}


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def time_graph(fn, n=50, reps=9):
    """Median device time of one ``fn()`` in ms: ``n`` calls captured in a
    CUDA graph (no host launch gaps), the graph replayed ``reps`` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def kernel_timings(dims, masks, B=MAIN_B):
    """ms of each kernel, its plain version and the torch.matmul chain of the
    same products, at batch B. The plain backward is autograd through
    ``fused_mlp_plain``: its time is that of the plain forward and
    ``torch.autograd.grad`` in one graph, less the plain forward's."""
    nl = ('relu', 'relu')
    x, ws, bs, ms, g = mlp_problem(dims, masks, B, seed=7)
    _, a_res = fm._fwd_cuda(x, ws, bs, ms, nl)
    posts = [torch.relu(a) for a in a_res]
    hs = [x] + [p * m for p, m in zip(posts, ms)]
    has_b = (True,) * len(ws)
    gas = []  # layer-output gradients, for the backward's product chain
    g_a = g
    for l in range(len(ws) - 1, -1, -1):
        gas.insert(0, g_a)
        if l:
            g_a = (g_a @ ws[l].t()) * ms[l - 1] * (a_res[l - 1] > 0)
    leaves = [v.detach().clone().requires_grad_(True) for v in
              [x, *ws, *bs, *ms]]
    n = len(ws)
    lx, lw, lb, lm = (leaves[0], leaves[1:1 + n], leaves[1 + n:1 + 2 * n],
                      leaves[1 + 2 * n:])

    def plain_fwd():
        return fm.fused_mlp_plain(lx, lw, lb, lm, nl)

    def plain_fwd_bwd():
        torch.autograd.grad(plain_fwd(), leaves, g)

    def lib_fwd():
        for h, w in zip(hs, ws):
            torch.matmul(h, w)

    def lib_bwd():
        for l, w in enumerate(ws):
            torch.matmul(hs[l].t(), gas[l])
            torch.matmul(gas[l], w.t())

    plain_fwd_ms = time_graph(plain_fwd)
    t = {
        'fused_mlp_fwd': dict(
            ms=time_graph(lambda: fm._fwd_cuda(x, ws, bs, ms, nl)),
            plain_ms=plain_fwd_ms, library_ms=time_graph(lib_fwd)),
        'fused_mlp_bwd': dict(
            ms=time_graph(lambda: fm._bwd_cuda(x, ws, has_b, ms, a_res, nl,
                                               g)),
            plain_ms=time_graph(plain_fwd_bwd) - plain_fwd_ms,
            library_ms=time_graph(lib_bwd)),
    }
    for name, (nbytes, flops) in mlp_bytes_flops(dims, B).items():
        t[name].update(bytes=nbytes, flops=flops)
        t[name]['bound_ms'], t[name]['bound_by'] = bound(nbytes, flops)
    return t


def phase_mlp_kernels():
    """The fused-MLP kernels against the plain version at the policy and
    dynamics shapes (B in BATCHES) and the critic's (B = GRID_B); each
    launch plan and the clusters of it the card holds; times at the main
    path's batch (the kernels line: the mean of policy and dynamics) and
    the critic's."""
    names = ['fused_mlp_fwd', 'fused_mlp_bwd']
    worst = {n: 0.0 for n in names}
    labels = ['out', 'dx'] + ['dW%d' % i for i in range(3)] + [
        'db%d' % i for i in range(3)] + ['dmask0', 'dmask1']
    cases = [(net, dims, masks, B) for net, (dims, masks) in SHAPES.items()
             for B in BATCHES] + [('critic', *CRITIC, GRID_B)]
    for net, dims, masks, B in cases:
        x, ws, bs, ms, g = mlp_problem(dims, masks, B, seed=B)
        got = grads_through(fm.fused_mlp, x, ws, bs, ms, g)
        ref = grads_through(fm.fused_mlp_plain, x, ws, bs, ms, g)
        torch.cuda.synchronize()
        here = {n: 0.0 for n in names}
        rel = 0.0  # worst err / max|plain| of an output
        for lab, a, r in zip(labels, got, ref):
            err, r_err, _ = hold(f'{net} B={B} {lab}', a, r, REL_TOL)
            kern = 'fused_mlp_fwd' if lab == 'out' else 'fused_mlp_bwd'
            here[kern] = max(here[kern], err)
            rel = max(rel, r_err)
        for n in names:
            worst[n] = max(worst[n], here[n])
        log(f'[phase 2] {net} {dims} B={B}: kernel vs plain max abs err '
            f'fwd {here["fused_mlp_fwd"]:.3e} bwd '
            f'{here["fused_mlp_bwd"]:.3e}, worst of an output relative to '
            f'its max|plain| {rel:.3e} (tolerance {REL_TOL:.0e}) ok')
    for net, dims, B in [(net, dims, MAIN_B)
                         for net, (dims, _) in SHAPES.items()] + [
                             ('critic', CRITIC[0], GRID_B)]:
        plan = fm.launch_plan(dims, B)
        log(f'[phase 2] {net} {dims} B={B}: {plan}; the card holds '
            f'{fm.max_clusters("cuda", False, plan.threads, plan.fwd_smem)} '
            'forward and '
            f'{fm.max_clusters("cuda", True, plan.threads, plan.bwd_smem)} '
            'backward clusters of it at once')
    per_net = {net: kernel_timings(dims, masks)
               for net, (dims, masks) in SHAPES.items()}
    timed = [(net, MAIN_B, tt) for net, tt in per_net.items()] + [
        ('critic', GRID_B, kernel_timings(*CRITIC, B=GRID_B))]
    for net, B, tt in timed:
        for name, v in tt.items():
            log(f'[phase 2] {name} {net} B={B}: kernel {v["ms"]:.4f} ms, '
                f'plain {v["plain_ms"]:.4f} ms, torch.matmul chain '
                f'{v["library_ms"]:.4f} ms, bound {v["bound_ms"]:.6f} ms '
                f'({v["bound_by"]})')
    # the main path launches each kernel as often for the policy as for the
    # dynamics: report the mean of the two shapes
    rows = {}
    for name in names:
        vals = [per_net[net][name] for net in SHAPES]
        mean = {k: float(np.mean([v[k] for v in vals]))
                for k in ('ms', 'plain_ms', 'library_ms', 'bytes', 'flops')}
        mean['bound_ms'], mean['bound_by'] = bound(mean.pop('bytes'),
                                                   mean.pop('flops'))
        rows[name] = dict(mean, max_abs_err=worst[name])
    return rows


def env_models(env, hidden=(200, 200), nonlin='relu', learned=False,
               components=0, options=()):
    """The Deep-PILCO drivers' default models ([200, 200] relu MLPs, or
    these widths and activations) for ``env``, with its reward and action
    bounds: (dyn, pol, D, U). ``'JaxLunarLander'`` is the differentiable
    lander, built directly (``make('LunarLander')`` gives the Box2D lander
    where Box2D is installed). ``learned``: the env's shapes with the
    reward learned (no reward_func, a dynamics head of 2 (D + 1); the
    kernels' reward kind 3), as the driver builds them with --learn_reward
    or for the Box2D lander, which has no reward function (the
    differentiable lander's D = 8, U = 2). ``components`` K: a mixture
    dynamics head of K Gaussians; ``options`` as ``build_models``.
    ``'Bench5'``, ``'Bench16'`` (``BENCH_SHAPES``): the JAX
    package's benchmark models (bench.py build(), max_u 10) at D, U, with
    its reward (``envs.state_reward``, a tip of D rows)."""
    if env == 'Cartpole':
        D, U, high, rf = 5, 1, (10.0,), envs.cartpole_reward()
    elif env in BENCH_SHAPES:
        D, U = BENCH_SHAPES[env]
        high, rf = (10.0,), envs.state_reward(D)
    else:
        e = (envs.JaxLunarLander(device='cpu') if env == 'JaxLunarLander'
             else envs.make(env, device='cpu'))
        D, U = e.observation_size, e.action_size
        high, rf = [float(v) for v in e.action_space.high], e.reward_func
    return build_models(D, U, high, None if learned else rf, hidden,
                        nonlin, components, options) + (D, U)


def env_label(env, learned=False):
    """``env`` as the logs name it, with ``learned`` as ``env_models``."""
    return f'{env} (reward learned)' if learned else env


def net_dims(dyn, pol):
    """(policy MLP dims, dynamics MLP dims) of the models."""
    return [fr._mlp_dims(pol.mlp), fr._mlp_dims(dyn.regressor.mlp)]


def stats_data(env, rng, n=200, learned=False):
    """[n, D + U] inputs and [n, D] targets the dynamics' whitening stats
    are fit to, drawn from ``rng`` at each env's scales; with a learned
    reward the targets have a rewards' column after them ([n, D + 1])."""
    if learned:
        X, Y = stats_data(env, rng, n)
        return X, np.concatenate([Y, rng.randn(n, 1)], 1)
    if env in BENCH_SHAPES:  # states ~0.5, actions ~5
        D, U = BENCH_SHAPES[env]
        return (rng.randn(n, D + U) * ([0.5] * D + [5.0] * U),
                0.1 * rng.randn(n, D))
    scale = {'Cartpole': [1, 2, 3, 0.7, 0.7, 5],
             'Pendulum': [3, 0.7, 0.7, 2.5],
             'DoubleCartpole': [1, 2, 3, 3, 0.7, 0.7, 0.7, 0.7, 20],
             'Rendezvous': [10] * 4 + [1] * 4 + [100] * 4,
             'JaxLunarLander': [0.5] * 4 + [0.3, 0.5, 0.5, 0.5, 1, 1]}[env]
    D = len(scale) - {'Rendezvous': 4, 'JaxLunarLander': 2}.get(env, 1)
    return rng.randn(n, len(scale)) * scale, 0.1 * rng.randn(n, D)


def env_states(env, rng, B):
    """Embedded states whose angles span the circle (Cartpole's pole:
    rewards from exp(-8), hanging, to 1; the pendulum; both poles of the
    double cartpole), or rendezvous's positions ~10 and velocities ~1
    (relative-state costs ~10^2 to 10^3; with the untrained policy's forces
    of up to 100 a dim, rewards down to ~-5 10^4), or the lander's states
    (``'JaxLunarLander'``), or the benchmark's states ~0.5 a dim
    (``BENCH_SHAPES``: rewards exp(-0.5 |s|^2) from ~exp(-16) to 1 at
    D = 16)."""
    if env in BENCH_SHAPES:
        return 0.5 * rng.randn(B, BENCH_SHAPES[env][0])
    if env == 'Rendezvous':
        return np.concatenate([10 * rng.randn(B, 4), rng.randn(B, 4)], 1)
    if env == 'JaxLunarLander':
        # over the pad and beside it, moving, tilted, legs in and out of
        # contact
        return np.stack([rng.uniform(-1, 1, B), rng.uniform(0, 1.4, B),
                         0.5 * rng.randn(B), 0.5 * rng.randn(B),
                         0.3 * rng.randn(B), 0.5 * rng.randn(B),
                         rng.uniform(0, 1, B), rng.uniform(0, 1, B)], 1)
    if env == 'Cartpole':
        th = rng.uniform(-np.pi, np.pi, B)
        return np.stack([0.3 * rng.randn(B), rng.randn(B), rng.randn(B),
                         np.sin(th), np.cos(th)], 1)
    if env == 'Pendulum':
        th = rng.uniform(-np.pi, np.pi, B)
        return np.stack([2 * rng.randn(B), np.sin(th), np.cos(th)], 1)
    th = rng.uniform(-np.pi, np.pi, (B, 2))
    return np.concatenate([0.3 * rng.randn(B, 1), rng.randn(B, 3),
                           np.sin(th), np.cos(th)], 1)


# the lander's saturated problems (phase 2b): the policy's mean outputs
# biased to SATURATE_BIAS, so that tanh gives actions of exactly 1 (torch's
# tanh and the kernels' tanhf alike), and action noise from TIE_EPS, per
# action dim, so that a = 1 + eps lands on the reward's kinks: a0 on 1 and -1
# (the clip's ties), 0 (the main gate's edge), inside and beyond; a1 on 1 and
# -1, on 0.5 and -0.5 (the side gate's edges), 2^-12 either side of 0.5,
# inside and beyond
SATURATE_BIAS = 60.0
TIE_EPS = ((0.0, -2.0, -0.5, 0.5, -1.0, -0.25),
           (0.0, -2.0, -0.5, -1.5, -0.5 - 2 ** -12, -0.5 + 2 ** -12, 0.5,
            -1.25))


def saturate(pol_params, U):
    """Bias the policy's U mean outputs to SATURATE_BIAS, in place."""
    with torch.no_grad():
        pol_params['mlp']['linear_out']['b'][:U] = SATURATE_BIAS


def tie_eps(seed, shape):
    """Action noise of ``shape`` [..., 2], each dim's entries drawn from
    its TIE_EPS."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.choice(TIE_EPS[k], shape[:-1]) for k in range(2)],
                    -1)


def step_problem(B, seed, env='Cartpole', saturated=False, learned=False,
                 groups=None, components=0, options=()):
    """One rollout step at the main path's widths ([200, 200] MLPs; by
    default embedded Cartpole, D = 5, U = 1), its inputs made from a seed.
    The state resample needs a full-rank particle covariance, B > D: below
    that its factor is float32 rounding noise (ROADMAP Queue 3), so B = 2
    resamples the rewards only. ``saturated`` (the lander): the policy
    saturated and the actions on the reward's kinks (``saturate``,
    ``tie_eps``); ``learned`` as ``env_models``; ``groups``: MM per group of
    B / groups particles, its noise standardized per group (the states
    resampled where a group has more particles than D); ``components`` K:
    a mixture dynamics head of K Gaussians, whose plain version picks its
    components through ``PickingMixture``; ``options`` the models' options
    (``build_models``). Returns (kernel step, plain step, policy leaves,
    states, eps, (g_nxt, g_r), timing inputs)."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    dyn, pol, D, U = env_models(env, learned=learned, components=components,
                                options=options)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dyn_params = dyn.init(gen, device='cuda')
    pol_params = pol.init(gen, device='cuda')
    if saturated:
        saturate(pol_params, U)
    leaves = [p.requires_grad_(True) for p in grad_leaves(pol_params)]
    stats = dyn.fit_stats(*map(t, stats_data(env, rng, learned=learned)))
    dyn_noise = dyn.sample_noise(gen, (B,), device='cuda')
    pol_noise = pol.sample_noise(gen, (B,), device='cuda')
    states = t(env_states(env, rng, B))
    eps = t(0.1 * rng.randn(B, U))
    if saturated:
        eps = t(tie_eps(seed + 2, (B, U)))
    G = groups or 1

    def per_group(z):
        return standardize_noise(z.reshape(G, B // G, -1)).reshape(z.shape)

    z_mm = per_group(t(rng.randn(B, D)))
    z_rr = per_group(t(rng.randn(B, 1)))
    cot = (t(rng.randn(B, D)), t(rng.randn(B, 1)))
    mm_states = B // G > D
    k = fr.StepKernel(dyn, pol, mm_states, True, pol_params, dyn_params,
                      stats, dyn_noise, pol_noise, B, states.device, groups)
    plain = fr.make_step_plain(picking(dyn), picking_pol(pol), mm_states,
                               True, groups)

    def kernel(s, e):
        return k(s, e, z_mm, z_rr)

    def plain_step(s, e, f64=False):
        a = (pol_params, s, z_mm, z_rr, e, dyn_params, stats, dyn_noise,
             pol_noise)
        return plain(*(in_float64(a) if f64 else a))

    return kernel, plain_step, leaves, states, eps, cot, (k, z_mm, z_rr)


def step_outputs(step, leaves, states, eps, cot):
    """(nxt, r) and the cotangents of the policy leaves, states and eps."""
    s = states.detach().clone().requires_grad_(True)
    e = eps.detach().clone().requires_grad_(True)
    nxt, r = step(s, e)
    grads = torch.autograd.grad((nxt * cot[0]).sum() + (r * cot[1]).sum(),
                                leaves + [s, e])
    return [nxt.detach(), r.detach()] + list(grads)


def head_dims_of(dyn_dims, K=0):
    """(E, the dynamics density's noise a particle): a diagonal head's 2 E
    outputs and E noise, or a mixture's 2 E K + K + 1 outputs and E + K + 1
    noise (``components`` K)."""
    if not K:
        return dyn_dims[-1] // 2, dyn_dims[-1] // 2
    E = (dyn_dims[-1] - K - 1) // (2 * K)
    return E, E + K + 1


def step_bytes_flops(B, pol_dims, dyn_dims, D, U, K=0):
    """Bytes each step kernel must move (inputs read once, outputs written
    once) and the operations it does, for one call at batch B. The backward
    takes the step's inputs and its pre-MM outputs, so it recomputes both
    MLPs' forward; its products are that, both dx chains and the policy's
    dW. The dynamics head has 2 E outputs: E = D, or D + 1 with a learned
    reward, whose density noise and output scaling are E wide; a mixture of
    K has 2 E K + K + 1 and its noise E + K + 1 (``head_dims_of``), and its
    pick and weighted sums ~12 K + 6 E K operations a particle."""
    def weights(dims):
        return sum(a * b for a, b in zip(dims[:-1], dims[1:])) + sum(dims[1:])

    E, Z = head_dims_of(dyn_dims, K)
    wp, wd = weights(pol_dims), weights(dyn_dims)
    masks = B * (sum(pol_dims[1:-1]) + sum(dyn_dims[1:-1]))
    # states, eps, both density noises, the MM noise
    state = B * (D + 2 * U + Z + D + 1)
    stats = 2 * (D + U) + 2 * E
    mults = 2 * B * (wp + wd)  # products of both MLPs (bias adds included)
    elem = (3 * (masks + B * (D + U)) + B * D * (3 * D + 4)  # epilogues + MM
            + (B * (12 * K + 6 * E * K) if K else 0))  # the mixture's pick
    fwd_bytes = 4 * (wp + wd + masks + state + stats + 2 * B * (D + 1))
    bwd_bytes = 4 * (wp + wd + masks + state + stats + 2 * B * (D + 1)
                     + B * (D + U) + wp)
    wpp = sum(a * b for a, b in zip(pol_dims[:-1], pol_dims[1:]))
    wdd = sum(a * b for a, b in zip(dyn_dims[:-1], dyn_dims[1:]))
    bwd_flops = mults + 2 * B * (2 * wpp + wdd) + 3 * elem
    return {'fused_step_fwd': (fwd_bytes, mults + elem),
            'fused_step_bwd': (bwd_bytes, bwd_flops)}


def step_plans(k):
    """The step kernels' launch plans of ``k`` on this card, as text."""
    return '; '.join(
        f'{name}: {p.clusters} clusters of 8 CTAs walk {p.tiles} tiles of '
        f'{p.tile_rows} rows, weights '
        f'{"resident" if p.resident else "read in place"}, {p.smem} bytes of '
        'shared memory a CTA' for name, p in zip(('forward', 'backward'),
                                                  k.plans()))


def step_timings(B, env='Cartpole', learned=False, groups=None,
                 components=0, options=()):
    """ms of each step kernel and of the plain step at batch B (MM per
    group of B / groups with ``groups``), and the kernels' launch plans. The
    plain backward is its forward and ``torch.autograd.grad`` in one graph,
    less the plain forward's. No single PyTorch call computes a rollout
    step, so there is no library time. ``components`` and ``options`` as
    ``step_problem``."""
    kernel, plain, leaves, states, eps, cot, (k, z_mm, z_rr) = step_problem(
        B, seed=7, env=env, learned=learned, groups=groups,
        components=components, options=options)
    residuals = k.forward(states, eps, z_mm, z_rr)[2:]

    def plain_fwd_bwd():
        step_outputs(plain, leaves, states, eps, cot)

    plain_fwd_ms = time_graph(lambda: plain(states, eps))
    t = {
        'fused_step_fwd': dict(
            ms=time_graph(lambda: k.forward(states, eps, z_mm, z_rr)),
            plain_ms=plain_fwd_ms),
        'fused_step_bwd': dict(
            ms=time_graph(lambda: k.backward(states, eps, z_mm, z_rr,
                                             *residuals, cot[0], cot[1],
                                             True)),
            plain_ms=time_graph(plain_fwd_bwd) - plain_fwd_ms),
    }
    for name, (nbytes, flops) in step_bytes_flops(B, *k.dims, k.D, k.U,
                                                  k.K).items():
        t[name]['bound_ms'], t[name]['bound_by'] = bound(nbytes, flops)
        t[name]['library_ms'] = None
    return t, step_plans(k)


def check_step(B, env='Cartpole', tag='phase 2', saturated=False,
               learned=False, groups=None, components=0, options=()):
    """The step kernels against the plain step at batch B on ``env``'s
    shapes (``phase_step_kernels``' tolerance; ``saturated``, ``learned``,
    ``groups`` and ``components`` as ``step_problem``; grouped or with a
    mixture head, against the plain step in float64, ``float64``; a mixture
    head through ``held_against``; ``options`` as ``step_problem``); the
    largest error of each."""
    kernel, plain, leaves, states, eps, cot, (k, _, _) = step_problem(
        B, seed=B, env=env, saturated=saturated, learned=learned,
        groups=groups, components=components, options=options)
    if groups or components:
        plain = functools.partial(plain, f64=True)
    env = env_label(env, learned)
    if groups:
        env = f'{env} mm_groups={groups}'
    if components:
        env = f'{env} mixture K={components}'
    if options:
        env = f'{env} options {"+".join(options)}'
    got = step_outputs(kernel, leaves, states, eps, cot)

    def plain_outputs():
        return (step_outputs(plain, leaves, states, eps, cot),
                step_outputs(plain, leaves, states * (1 + 1e-6), eps, cot))

    labels = (['nxt', 'r'] + [f'd pol leaf {i}' for i in
                              range(len(leaves))] + ['d states', 'd eps'])

    def hold_all(outs):
        ref, moved = outs
        torch.cuda.synchronize()
        here = {'fused_step_fwd': 0.0, 'fused_step_bwd': 0.0}
        rel = loose = 0.0
        for lab, a, r, m in zip(labels, got, ref, moved):
            err, r_err, r_tol = hold(f'{env} step B={B} {lab}', a, r,
                                     STEP_TOL, m)
            kern = ('fused_step_fwd' if lab in ('nxt', 'r')
                    else 'fused_step_bwd')
            here[kern] = max(here[kern], err)
            rel, loose = max(rel, r_err), max(loose, r_tol)
        return here, rel, loose, ref

    here, rel, loose, ref = held_against(f'{env} step B={B}', plain_outputs,
                                         1, hold_all)
    state_mm = 'on' if B // k.G > k.D else 'off'
    if saturated:
        env = f'{env} saturated'
    log(f'[{tag}] {env} (D={k.D}, U={k.U}) rollout step B={B} (state MM '
        f'{state_mm}; max|r| {float(ref[1].abs().max()):.4g}): kernel vs '
        f'plain max abs err fwd {here["fused_step_fwd"]:.3e} bwd '
        f'{here["fused_step_bwd"]:.3e}; worst of an output relative to its '
        f'max|plain| {rel:.3e}, loosest tolerance {loose:.3e} relative '
        f'({STEP_TOL:.0e} or the plain step\'s sensitivity) ok')
    return here


def phase_step_kernels():
    """The step kernels against the plain step. Tolerance per output:
    STEP_TOL * max|plain| of that output (float32 sums in another order,
    amplified by the 5x5 Cholesky and its adjoint), or 3x the plain step's
    own change when the states move by 1e-6 relative, whichever is
    larger."""
    names = ['fused_step_fwd', 'fused_step_bwd']
    worst = {n: 0.0 for n in names}
    for B in STEP_BATCHES:
        here = check_step(B)
        for n in names:
            worst[n] = max(worst[n], here[n])
    rows = None
    for B in (MAIN_B, STEP_BIG_B):
        tt, plans = step_timings(B)
        log(f'[phase 2] rollout step B={B}: {plans}')
        for name, v in tt.items():
            log(f'[phase 2] {name} B={B}: kernel {v["ms"]:.4f} ms, plain '
                f'{v["plain_ms"]:.4f} ms, no single library call, bound '
                f'{v["bound_ms"]:.6f} ms ({v["bound_by"]})')
        rows = rows or tt
    for name, v in rows.items():
        v['max_abs_err'] = worst[name]
    return rows


def rollout_problem(B, seed, mean_only=True, T=MAIN_T, env='Cartpole',
                    saturated=False, learned=False, groups=None,
                    components=0, options=()):
    """The whole rollout at the main path's widths ([200, 200] MLPs; by
    default embedded Cartpole, D = 5, U = 1; states and rewards
    moment-matched, discount 0.9), its inputs made from a seed
    (``saturated``, ``learned``, ``groups`` and ``components`` as
    ``step_problem``: with groups of D particles or fewer the rewards alone
    are resampled, and the argument of the states' MM noise is None;
    ``options`` as ``step_problem``). Returns (kernel loss, kernel
    value-and-grad, plain loss, policy params, policy leaves, the arguments
    after the policy params, (dyn, pol, w_t))."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    dyn, pol, D, U = env_models(env, learned=learned, components=components,
                                options=options)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dyn_params = dyn.init(gen, device='cuda')
    pol_params = pol.init(gen, device='cuda')
    if saturated:
        saturate(pol_params, U)
    leaves = [p.requires_grad_(True) for p in grad_leaves(pol_params)]
    stats = dyn.fit_stats(*map(t, stats_data(env, rng, learned=learned)))
    dyn_noise = dyn.sample_noise(gen, (B,), device='cuda')
    pol_noise = pol.sample_noise(gen, (B,), device='cuda')
    # angles all round the circle (the main path starts hanging, where the
    # reward is about exp(-8))
    x0 = t(env_states(env, rng, B))
    z_mm = fr.prepare_mm_noise(t(rng.randn(B, D)), T, B, groups)
    z_rr = fr.prepare_mm_noise(t(rng.randn(B, 1)), T, B, groups)
    eps = t(0.1 * rng.randn(T, B, U))
    if saturated:
        eps = t(tie_eps(seed + 2, (T, B, U)))
    w_t = 0.9 ** np.arange(T, dtype=np.float32)
    mm_states = groups is None or B // groups > D
    if not mm_states:
        z_mm = None
    make = (dyn, pol, T, w_t, mm_states, True, True)
    kw = dict(mm_rewards_mean_only=mean_only, mm_groups=groups)
    return (fr.make_fused_loss(*make, mode='full', **kw),
            fr.make_fused_value_and_grad(*make, mode='full', **kw),
            fr.make_loss_plain(picking(dyn), picking_pol(pol), *make[2:],
                               **kw), pol_params,
            leaves,
            [x0, dyn_params, stats, dyn_noise, pol_noise, z_mm, z_rr, eps],
            (dyn, pol, w_t))


def rollout_outputs(loss_fn, pol_params, leaves, args, x0_scale=1.0,
                    g=(0.7, 1.3)):
    """loss, mean_return and the gradients wrt the policy leaves and
    action_eps of g[0] * loss + g[1] * mean_return."""
    a = list(args)
    a[0] = a[0] * x0_scale
    a[-1] = a[-1].clone().requires_grad_(True)
    loss, mret, _ = loss_fn(pol_params, *a)
    grads = torch.autograd.grad(g[0] * loss + g[1] * mret, leaves + [a[-1]])
    return [loss.detach(), mret.detach(), *grads]


def time_launches(fn, n=ROLLOUT_LAUNCHES, reps=5):
    """Median device time of one ``fn()`` in ms: CUDA events around ``n``
    calls in a row (the host enqueues them faster than the card runs them,
    so the span is the card's), repeated ``reps`` times."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def rollout_timings(env='Cartpole', split=True, learned=False, groups=None,
                    components=0, options=()):
    """ms of each rollout kernel (CUDA events around launches in a row: a
    cooperative launch is not captured in a graph here) and of the plain
    version (CUDA graph replay) at the main-path batch and horizon. The
    plain backward is the plain forward and ``torch.autograd.grad`` in one
    graph, less the plain forward; the plain value-and-grad is that graph.
    No single PyTorch call computes a rollout, so there is no library
    time. With ``split`` it logs the kernel's own time split of row 5;
    ``groups``, ``components`` and ``options`` as ``rollout_problem``."""
    _, _, plain, pol_params, leaves, args, (dyn, pol, w_t) = rollout_problem(
        MAIN_B, 7, env=env, learned=learned, groups=groups,
        components=components, options=options)
    x0, dyn_params, stats, dyn_noise, pol_noise, z_mm, z_rr, eps = args
    k = fr.RolloutKernel(dyn, pol, MAIN_T, w_t, z_mm is not None, True, True,
                         True, MAIN_B, x0.device, mm_groups=groups)
    sk = k.bind(pol_params, x0, dyn_params, stats, dyn_noise, pol_noise,
                z_mm, z_rr, eps)
    _, _, res = k.forward(sk)
    g_loss = torch.ones((), device='cuda')
    g_mret = torch.zeros((), device='cuda')

    def plain_fwd():
        return plain(pol_params, *args)

    def plain_vg():
        torch.autograd.grad(plain_fwd()[0], leaves)

    plain_fwd_ms = time_graph(plain_fwd, n=5)
    plain_vg_ms = time_graph(plain_vg, n=5)
    t = {
        'fused_rollout_fwd': dict(ms=time_launches(lambda: k.forward(sk)),
                                  plain_ms=plain_fwd_ms),
        'fused_rollout_bwd': dict(
            ms=time_launches(lambda: k.backward(sk, res, g_loss, g_mret,
                                                True)),
            plain_ms=plain_vg_ms - plain_fwd_ms),
        'fused_rollout_vg': dict(ms=time_launches(lambda: k.value_and_grad(
            sk)), plain_ms=plain_vg_ms),
    }
    D, U = x0.shape[1], eps.shape[2]
    work = rollout_bytes_flops(MAIN_B, MAIN_T, *net_dims(dyn, pol), D, U,
                               r_mm=False, K=components)
    for name in t:
        t[name]['bound_ms'], t[name]['bound_by'] = bound(*work[name])
        t[name]['library_ms'] = None
    if split:
        log_split(f'fused_rollout_vg B={MAIN_B} ({k_plan(MAIN_B)})',
                  time_split(k, lambda: k.value_and_grad(sk)))
    return t


def k_plan(B, env='Cartpole', learned=False, components=0, options=()):
    """The whole-rollout kernel's launch plan at the main widths and batch
    B on this card for ``env``'s shapes (a mixture head of ``components``,
    the models' ``options``), as text."""
    dyn, pol, D, _ = env_models(env, learned=learned, components=components,
                                options=options)
    lim = fr.kernel_instance(dyn, pol)
    p = fr.rollout_plan(*net_dims(dyn, pol), D, B, MAIN_T,
                        fr.max_clusters(torch.cuda.current_device(), lim),
                        components=components,
                        options=fr.walk_options(dyn, pol), lim=lim)
    return (f'{lim.name} instance, {p.clusters} clusters of {p.particles} '
            f'particles in {p.tiles} tile(s) of {p.tile_rows} rows, weights '
            f'{"resident" if p.resident else "read in place"}, {p.smem} '
            'bytes of shared memory a CTA')


def rollout_bytes_flops(B, T, pol_dims, dyn_dims, D, U, r_mm, K=0):
    """Bytes each rollout kernel must move (inputs read once, outputs
    written once) and the operations it does, for one call at batch B and
    horizon T (``r_mm``: the rewards are resampled, not reduced by the
    mean-only shortcut). The operations are T times the step's
    (``step_bytes_flops``). Row 4 takes only the boundary states and pre-MM
    outputs, no pre-activations, so its count includes the recompute of
    both MLPs' forward products, as the step backward's does; row 5 is one
    forward and its VJP, so it counts those products once. The grid kernels
    (rows 8-9) are rows 3-4 with per-particle outputs: the forward writes
    states_all [T, B, D] (the boundary states after x0) and disc, raw, vret
    [B] and reads vw_t; the backward reads those, the cotangents of disc,
    raw, vret and g_sall [T, B, D]. ``K``: a mixture head's components
    (``step_bytes_flops``)."""
    step = step_bytes_flops(B, pol_dims, dyn_dims, D, U, K)
    f_fwd, f_bwd = step['fused_step_fwd'][1], step['fused_step_bwd'][1]

    def weights(dims):
        return sum(a * b for a, b in zip(dims[:-1], dims[1:])) + sum(dims[1:])

    # the dynamics density's outputs (D + 1: learned) and noise
    E, Z = head_dims_of(dyn_dims, K)
    wp, wd = weights(pol_dims), weights(dyn_dims)
    mults = 2 * B * (wp + wd)  # both MLPs' products in one step
    masks = B * (sum(pol_dims[1:-1]) + sum(dyn_dims[1:-1]))
    stats = 2 * (D + U) + 2 * E
    # weights, masks, stats, x0, both density noises, w_t, the MM noise
    # stacks and action_eps
    inputs = (wp + wd + masks + stats + B * (D + U + Z) + T
              + T * B * (D + U + (1 if r_mm else 0)))
    residuals = (T + 1) * B * D + T * B * (D + 1)  # boundary states, pre-MM
    sall, per_particle = T * B * D, 3 * B  # states_all; disc, raw, vret
    pre = B * D + T * B * (D + 1)  # the other residuals: x0's slot, pre-MM
    # the grid forward's bytes; the backward reads the same but for disc,
    # raw, vret their cotangents, and g_sall besides
    grid = inputs + T + sall + pre + per_particle
    return {'fused_rollout_fwd': (4 * (inputs + residuals + 2), T * f_fwd),
            'fused_rollout_bwd': (4 * (inputs + residuals + 2 + wp
                                       + T * B * U), T * f_bwd),
            'fused_rollout_vg': (4 * (inputs + 2 + wp),
                                 T * (f_fwd + f_bwd - mults)),
            'fused_grid_fwd': (4 * grid, T * f_fwd),
            'fused_grid_bwd': (4 * (grid + sall + wp + T * B * U),
                               T * f_bwd)}


def kernel_states(dyn, pol, w_t, mean_only, pp, args, scale=1.0,
                  groups=None, T=MAIN_T):
    """The whole-rollout kernel's own post-MM states s_1 ... s_T [T, B, D]
    on ``rollout_problem``'s inputs ``args`` (x0 scaled by ``scale``): its
    forward's residual, the trajectory its gradients are taken along."""
    x0, dyn_params, stats, dyn_noise, pol_noise, z_mm, z_rr, eps = args
    k = fr.RolloutKernel(dyn, pol, T, w_t, z_mm is not None, True, True,
                         mean_only, x0.shape[0], x0.device, mm_groups=groups)
    sk = k.bind(pp, (x0 * scale).contiguous(), dyn_params, stats, dyn_noise,
                pol_noise, z_mm, z_rr, eps)
    return k.forward(sk)[2][0][1:]


def forced_loss_plain(dyn, pol, w_t, mm_states, mean_only, states,
                      groups=None, T=MAIN_T):
    """``fr.make_loss_plain``'s loss (``rollout_problem``'s: rewards
    moment-matched or mean-only, maximized) along the trajectory ``states``
    [T, B, D] (a kernel's), as ``forced_grid_plain``: each step from the
    kernel's s_t, its next state that value through a straight-through
    term, so every ReLU decides on the kernel's states."""
    step = fr.make_step_plain(dyn, pol, mm_states, not mean_only, groups)
    w_list = [float(w) for w in np.asarray(w_t)]

    def loss_fn(pol_params, x0, dyn_params, dyn_stats, dyn_noise, pol_noise,
                z_mm_t, z_rr_t, action_eps=None, extras=()):
        t_of = iter(range(T))

        def forced(s, eps, zm, zr):
            nxt, r = step(pol_params, s, zm, zr, eps, dyn_params, dyn_stats,
                          dyn_noise, pol_noise)
            return nxt + (states[next(t_of)] - nxt).detach(), r

        disc, raw, _, _ = fr._rollout(forced, x0, T, w_list, None,
                                      mean_only, action_eps, z_mm_t, z_rr_t,
                                      groups)
        return -disc.mean(), raw.mean(), ()

    return loss_fn


def hold_on_edge(what, a, r, rel_tol, moved, B, along):
    """Hold a gradient summed over B particles of rows 3-5 (``hold``), or,
    where that fails, as on a ReLU's edge: a pre-activation within the two
    versions' drift of 0 takes the other branch in one of them and moves
    one particle's term (~max|r| / B) of a few entries, so at most one
    entry in 50 lies beyond ``hold``'s tolerance (rel_tol max|r|, or 3
    max|moved - r|) and none beyond it plus 4 max|r| / B; and elementwise
    (``hold``) against ``along()``, the plain version along the kernel's own
    states and the same at x0 moved by 1e-6 relative, where every ReLU
    decides as the kernel's did. Logs the entries beyond. Returns ``hold``'s
    (max abs err, err / max|r|, tolerance / max|r|) against the free-running
    plain version."""
    try:
        return hold(what, a, r, rel_tol, moved)
    except AssertionError as e:
        first = e
    scale = float(r.abs().max())
    tol = max(rel_tol * scale, 3 * float((moved - r).abs().max()))
    err = (a - r).abs()
    off = int((err > tol).sum())
    if off * 50 > a.numel() or float(err.max()) > tol + 4 * scale / B:
        raise first
    forced, forced_m = along()
    hold(f'{what} along the kernel\'s states', a, forced, rel_tol, forced_m)
    log(f'[phase 2] {what}: {off} of {a.numel()} entries beyond {tol:.3e} '
        f'(largest {float(err.max()):.3e}, max|plain| {scale:.3e}) against '
        f'the free-running plain version, a ReLU on its edge: within '
        f'{float((a - forced).abs().max()):.3e} of the plain version along '
        'the kernel\'s states')
    return float(err.max()), float(err.max()) / scale, (
        tol + 4 * scale / B) / scale


def check_rollout(B, mean_only, env='Cartpole', tag='phase 2',
                  saturated=False, learned=False, groups=None, components=0,
                  options=()):
    """The whole-rollout kernels against the plain version at batch B on
    ``env``'s shapes (``phase_rollout_kernels``' tolerance; ``saturated``,
    ``groups`` and ``components`` as ``step_problem``; grouped or with a
    mixture head, against the plain version in float64, ``float64``; a
    mixture head through ``held_against``; ``options`` as
    ``step_problem``); the largest error of each."""
    kloss, kvg, plain, pp, leaves, args, models = rollout_problem(
        B, B, mean_only, env=env, saturated=saturated, learned=learned,
        groups=groups, components=components, options=options)
    # the wide instance's envs: a gradient that fails its hold is held on a
    # ReLU's edge (hold_on_edge) given the plain version along the kernel's
    # own states, made when first needed
    edge = env in BENCH_SHAPES
    forced = {}

    def along(g):
        if g not in forced:
            dyn, pol, w_t = models
            forced[g] = [rollout_outputs(forced_loss_plain(
                dyn, pol, w_t, args[5] is not None, mean_only,
                kernel_states(dyn, pol, w_t, mean_only, pp, args, scale,
                              groups), groups), pp, leaves, args, scale, g)
                for scale in (1.0, 1 + 1e-6)]
        return forced[g]

    if groups or components:
        plain = float64(plain)
    got = rollout_outputs(kloss, pp, leaves, args)
    vl, vm, vgrads, _ = kvg(pp, *args)

    def plain_outputs():
        return (rollout_outputs(plain, pp, leaves, args),
                rollout_outputs(plain, pp, leaves, args, 1 + 1e-6),
                rollout_outputs(plain, pp, leaves, args, g=(1.0, 0.0))[:-1],
                rollout_outputs(plain, pp, leaves, args, 1 + 1e-6,
                                g=(1.0, 0.0))[:-1])

    n = len(leaves)
    labels = (['loss', 'mean_return']
              + [f'd pol leaf {i}' for i in range(n)] + ['d eps'])
    names = ['fused_rollout_fwd', 'fused_rollout_bwd', 'fused_rollout_vg']
    # the lander's d action_eps per particle and step: a ReLU unit of the
    # dynamics within float32 rounding of 0 moves one particle's entries
    # alone (seen at B = 1500, saturated), held as the grid's (hold_rows)
    eps_by_rows = env == 'JaxLunarLander'
    env = env_label(env, learned)
    if saturated:
        env = f'{env} saturated'
    if groups:
        env = (f'{env} mm_groups={groups} (states'
               f'{"" if args[5] is not None else " not"} resampled)')
    if components:
        env = f'{env} mixture K={components}'
    if options:
        env = f'{env} options {"+".join(options)}'

    def hold_all(outs):
        ref, moved, vref, vmoved = outs
        torch.cuda.synchronize()
        checks = ([('fused_rollout_fwd', lab, a, r, m) for lab, a, r, m in
                   zip(labels[:2], got[:2], ref[:2], moved[:2])]
                  + [('fused_rollout_bwd', lab, a, r, m) for lab, a, r, m in
                     zip(labels[2:], got[2:], ref[2:], moved[2:])]
                  + [('fused_rollout_vg', lab, a, r, m) for lab, a, r, m in
                     zip(labels[:-1], [vl, vm, *grad_leaves(vgrads)], vref,
                         vmoved)])
        here = {nm: 0.0 for nm in names}
        rel = loose = 0.0
        for i, (kern, lab, a, r, m) in enumerate(checks):
            check = hold_rows if eps_by_rows and lab == 'd eps' else hold
            if edge and lab.startswith('d '):
                vg = kern == 'fused_rollout_vg'
                j = labels.index(lab)
                check = functools.partial(
                    hold_on_edge, B=B, along=lambda g=(1.0, 0.0) if vg else (
                        0.7, 1.3), j=j: [o[j] for o in along(g)])
            err, r_err, r_tol = check(f'{env} rollout B={B} {kern} {lab}', a,
                                      r, STEP_TOL, m)
            here[kern] = max(here[kern], err)
            rel, loose = max(rel, r_err), max(loose, r_tol)
        return here, rel, loose, ref

    here, rel, loose, ref = held_against(f'{env} rollout B={B}',
                                         plain_outputs, MAIN_T, hold_all)
    log(f'[{tag}] {env} rollout B={B} T={MAIN_T} (reward mean-only '
        f'{"on" if mean_only else "off"}; loss {float(ref[0]):.6f}, '
        f'mean_return {float(ref[1]):.6f}): kernel vs plain max abs err '
        + ', '.join(f'{nm[len("fused_rollout_"):]} {here[nm]:.3e}'
                    for nm in names)
        + f'; worst of an output relative to its max|plain| {rel:.3e}, '
        f'loosest tolerance {loose:.3e} relative ({STEP_TOL:.0e} or the '
        'plain version\'s sensitivity) ok')
    return here


def phase_rollout_kernels():
    """The whole-rollout kernels against the plain version. Tolerance per
    output: STEP_TOL * max|plain| of that output, or 3x the plain version's
    own change when x0 moves by 1e-6 relative, whichever is larger (T
    chained resamples amplify float32 differences in the sums' order)."""
    names = ['fused_rollout_fwd', 'fused_rollout_bwd', 'fused_rollout_vg']
    worst = {n: 0.0 for n in names}
    cases = [(B, True) for B in ROLLOUT_BATCHES] + [(MAIN_B, False)]
    for B, mean_only in cases:
        here = check_rollout(B, mean_only)
        for nm in names:
            worst[nm] = max(worst[nm], here[nm])
    rows = rollout_timings()
    for name, v in rows.items():
        v['max_abs_err'] = worst[name]
        log(f'[phase 2] {name} B={MAIN_B} T={MAIN_T}: kernel {v["ms"]:.4f} ms '
            f'(CUDA events around {ROLLOUT_LAUNCHES} launches), plain '
            f'{v["plain_ms"]:.4f} ms (graph replay), no single library call, '
            f'bound {v["bound_ms"]:.6f} ms ({v["bound_by"]})')
    return rows


def grid_problem(B, seed, mm_states=True, mm_rewards=True, T=MAIN_T,
                 env='Cartpole', saturated=False, learned=False, groups=None,
                 components=0, options=()):
    """The grid rollout on ``rollout_problem``'s inputs: (kernel rollout,
    plain rollout, policy params, leaves, the rollout's arguments after the
    policy params, cotangents of disc, raw, vret and states_all, (dyn, pol,
    w_t, vw_t)); vret weighs step t by (T - 1 - t) / T. With ``groups``
    (as ``rollout_problem``) the states are resampled where a group has more
    particles than D; ``components`` and ``options`` as
    ``rollout_problem``."""
    _, _, _, pp, leaves, args, (dyn, pol, w_t) = rollout_problem(
        B, seed, False, T, env=env, saturated=saturated, learned=learned,
        groups=groups, components=components, options=options)
    mm_states = mm_states and args[5] is not None
    x0, dyn_params, stats, dyn_noise, pol_noise, z_mm, z_rr, eps = args
    rng = np.random.RandomState(seed + 1)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    vw_t = (T - 1 - np.arange(T)) / T  # 0 at the last step
    cot = [t(rng.randn(B, 1)) for _ in range(3)] + [
        t(rng.randn(T, B, x0.shape[1]))]
    make = (dyn, pol, T, mm_states, mm_rewards, groups)
    return (fr.make_grid_rollout(*make),
            fr.make_grid_rollout_plain(picking(dyn), picking_pol(pol),
                                       *make[2:]),
            pp, leaves, [x0, z_mm if mm_states else None,
                         z_rr if mm_rewards else None, eps, dyn_params, stats,
                         dyn_noise, pol_noise, w_t, vw_t], cot,
            (dyn, pol, w_t, vw_t))


def grid_outputs(fn, pp, leaves, args, cot, x0_scale=1.0):
    """disc, raw, vret, states_all and the gradients wrt the policy leaves
    and action_eps of sum(output * cotangent) over the four outputs."""
    a = list(args)
    a[0] = a[0] * x0_scale
    a[3] = a[3].clone().requires_grad_(True)
    outs = fn(pp, *a)
    grads = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)),
                                leaves + [a[3]])
    return [o.detach() for o in outs] + list(grads)


def forced_grid_plain(dyn, pol, T, mm_states, mm_rewards, states_all):
    """``fr.make_grid_rollout_plain``'s rollout along the trajectory
    ``states_all`` [T, B, D] (a kernel's): step t runs the plain step from
    s_t and its next state takes the value of states_all[t] through a
    straight-through term, so the gradients are the plain step's VJPs
    chained along that trajectory. Along the kernel's own trajectory every
    ReLU decides on the states the kernel's did, where against the
    free-running plain version, whose states drift from the kernel's by
    float32 rounding over T resamples, a unit near 0 may take the other
    branch in one of the two."""
    step = fr.make_step_plain(dyn, pol, mm_states, mm_rewards)

    def rollout(pol_params, x0, z_mm_t, z_rr_t, action_eps, dyn_params,
                dyn_stats, dyn_noise, pol_noise, w_t, vw_t):
        s, disc, raw, vret, sall = x0, 0.0, 0.0, 0.0, []
        for t in range(T):
            nxt, r = step(pol_params, s,
                          None if z_mm_t is None else z_mm_t[t],
                          None if z_rr_t is None else z_rr_t[t],
                          action_eps[t], dyn_params, dyn_stats, dyn_noise,
                          pol_noise)
            disc = disc + float(w_t[t]) * r
            raw = raw + r
            vret = vret + float(vw_t[t]) * r
            s = nxt + (states_all[t] - nxt).detach()
            sall.append(s)
        return disc, raw, vret, torch.stack(sall)

    return rollout


def hold_grid_eps_on_edge(what, kern, dyn, pol, mm_rewards, pp, leaves,
                          args, cot, got, ref, moved):
    """The grid's d action_eps ([T, B, U]; ``grid_outputs``' last) where the
    two versions' trajectories drift across a dynamics ReLU's edge for one
    particle (the learned lander at B = 1000): elementwise (``hold``)
    against the plain version forced along the kernel's own states
    (``forced_grid_plain``; its sensitivity along the kernel's states from
    x0 moved by 1e-6 relative), then against the free-running plain
    version by ``hold_rows`` given that forced version. Logs the left-out
    particle's error against both, the plain version's own change there and
    the states' drift. Returns ``hold_rows``' result."""
    T = args[3].shape[0]
    k_moved = grid_outputs(kern, pp, leaves, args, cot, 1 + 1e-6)
    forced, forced_m = (
        grid_outputs(forced_grid_plain(dyn, pol, T, args[1] is not None,
                                       mm_rewards, sall), pp, leaves, args,
                     cot, scale)[-1]
        for sall, scale in ((got[3], 1.0), (k_moved[3], 1 + 1e-6)))
    a, r, m = got[-1], ref[-1], moved[-1]
    hold(f'{what} along the kernel\'s states', a, forced, STEP_TOL,
         forced_m)
    per = (a - r).double().pow(2).sum((0, 2))
    for b in torch.topk(per, a.shape[1] // 1000).indices.tolist():
        log(f'[phase 2] {what}: particle {b} max abs err '
            f'{float((a - r)[:, b].abs().max()):.3e} against the '
            f'free-running plain version, '
            f'{float((a - forced)[:, b].abs().max()):.3e} against the plain '
            f'version along the kernel\'s states; the free-running plain '
            f'version\'s own change there when x0 moves by 1e-6 relative '
            f'{float((m - r)[:, b].abs().max()):.3e}; the kernel\'s states '
            f'there from the plain version\'s '
            f'{float((got[3] - ref[3])[:, b].abs().max()):.3e}')
    return hold_rows(what, a, r, STEP_TOL, m, along=forced)


SPLIT = ('weight staging', 'MLP walk (forward)',
         'per-cluster moments + merge + resample (forward)', 'grid barriers',
         'MM adjoint (backward)', 'recompute (backward)',
         'VJP + dW accumulation (backward)', 'loss and dW sums',
         'critic refit and bootstrap')


def time_split(k, launch, n=ROLLOUT_LAUNCHES):
    """The kernel's own time split in ms per ``launch()`` (``%globaltimer``
    laps of CTA 0, its waits at the barriers included), over n launches."""
    k.split = torch.zeros(fr.SPLIT_PARTS, dtype=torch.int64, device='cuda')
    for _ in range(n):
        launch()
    torch.cuda.synchronize()
    parts = (k.split.double() / n / 1e6).tolist()
    k.split = None
    return parts


def log_split(what, parts):
    log(f'[phase 2] {what} time split (CTA 0\'s clock, barrier waits '
        'included): ' + ', '.join(f'{lab} {ms:.4f} ms'
                                  for lab, ms in zip(SPLIT, parts))
        + f' = {sum(parts):.4f} ms')


def grid_timings(B, split=False, env='Cartpole', learned=False, groups=None,
                 components=0, options=()):
    """ms of each grid kernel and of the plain version at batch B, T = 15
    (CUDA events around launches in a row, as ``rollout_timings``; the plain
    backward is the plain forward and ``torch.autograd.grad`` in one graph
    less the forward), and with ``split`` the kernel's own time split in ms
    per launch; ``groups``, ``components`` and ``options`` as
    ``grid_problem``."""
    _, plain, pp, leaves, args, cot, (dyn, pol, w_t, vw_t) = grid_problem(
        B, 7, env=env, learned=learned, groups=groups, components=components,
        options=options)
    x0, z_mm, z_rr, eps, dyn_params, stats, dyn_noise, pol_noise = args[:8]
    k = fr.GridKernel(dyn, pol, MAIN_T, w_t, vw_t, z_mm is not None, True, B,
                      x0.device, groups)
    sk = k.bind(pp, x0, dyn_params, stats, dyn_noise, pol_noise, z_mm, z_rr,
                eps)
    res = k.forward(sk)[-1]

    def plain_fwd():
        return plain(pp, *args)

    def plain_fwd_bwd():
        outs = plain_fwd()
        torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)),
                            leaves)

    def bwd():
        k.backward(sk, res, *cot, True)

    plain_fwd_ms = time_graph(plain_fwd, n=5)
    t = {'fused_grid_fwd': dict(ms=time_launches(lambda: k.forward(sk)),
                                plain_ms=plain_fwd_ms),
         'fused_grid_bwd': dict(ms=time_launches(bwd),
                                plain_ms=time_graph(plain_fwd_bwd, n=5)
                                - plain_fwd_ms)}
    work = rollout_bytes_flops(B, MAIN_T, *net_dims(dyn, pol), x0.shape[1],
                               eps.shape[2], r_mm=True, K=components)
    for name in t:
        t[name]['bound_ms'], t[name]['bound_by'] = bound(*work[name])
        t[name]['library_ms'] = None
    parts = None
    if split:
        parts = time_split(k, lambda: (k.forward(sk), bwd()))
    return t, parts


def check_grid(B, mm_rewards, env='Cartpole', tag='phase 2',
               saturated=False, learned=False, groups=None, components=0,
               options=()):
    """The grid kernels against the plain grid rollout at batch B on
    ``env``'s shapes, states moment-matched (``phase_grid_kernels``'
    tolerance; ``saturated``, ``learned``, ``groups`` and ``components``
    as ``step_problem``; grouped or with a mixture head, against the plain
    version in float64, ``float64``; a mixture head through
    ``held_against``; ``options`` as ``step_problem``); the largest error
    of each."""
    names = ['fused_grid_fwd', 'fused_grid_bwd']
    kern, plain, pp, leaves, args, cot, (dyn, pol, _, _) = grid_problem(
        B, B, True, mm_rewards, env=env, saturated=saturated,
        learned=learned, groups=groups, components=components,
        options=options)
    if groups or components:
        plain = float64(plain)
    got = grid_outputs(kern, pp, leaves, args, cot)

    def plain_outputs():
        return (grid_outputs(plain, pp, leaves, args, cot),
                grid_outputs(plain, pp, leaves, args, cot, 1 + 1e-6))

    labels = (['disc', 'raw', 'vret', 'states_all']
              + [f'd pol leaf {i}' for i in range(len(leaves))] + ['d eps'])
    # the learned lander's d action_eps at B = 1000: the trajectories'
    # drift crosses a dynamics ReLU's edge for one particle
    # (hold_grid_eps_on_edge)
    on_edge = env == 'JaxLunarLander' and learned and not saturated
    env = env_label(env, learned)
    if saturated:
        env = f'{env} saturated'
    if groups:
        env = f'{env} mm_groups={groups}'
    if components:
        env = f'{env} mixture K={components}'
    if options:
        env = f'{env} options {"+".join(options)}'

    def hold_all(outs):
        ref, moved = outs
        torch.cuda.synchronize()
        here = {n: 0.0 for n in names}
        rel = loose = 0.0
        for i, (lab, a, r, m) in enumerate(zip(labels, got, ref, moved)):
            kern_name = names[0] if i < 4 else names[1]
            what = f'{env} grid B={B} {lab}'
            if lab != 'd eps':
                err, r_err, r_tol = hold(what, a, r, STEP_TOL, m)
            elif on_edge:
                err, r_err, r_tol = hold_grid_eps_on_edge(
                    what, kern, dyn, pol, mm_rewards, pp, leaves, args, cot,
                    got, ref, moved)
            else:
                err, r_err, r_tol = hold_rows(what, a, r, STEP_TOL, m)
            here[kern_name] = max(here[kern_name], err)
            rel, loose = max(rel, r_err), max(loose, r_tol)
        return here, rel, loose, ref

    here, rel, loose, ref = held_against(f'{env} grid B={B}', plain_outputs,
                                         MAIN_T, hold_all)
    what = ('states and rewards' if args[1] is not None and mm_rewards else
            'states only' if args[1] is not None else 'rewards only')
    log(f'[{tag}] {env} grid B={B} T={MAIN_T} ({what} moment-matched; '
        f'mean disc {float(ref[0].mean()):.6f}): kernel vs plain max abs '
        f'err fwd {here[names[0]]:.3e}, bwd {here[names[1]]:.3e}; worst '
        f'of an output relative to its max|plain| {rel:.3e}, loosest '
        f'tolerance {loose:.3e} relative ({STEP_TOL:.0e} or the plain '
        'version\'s sensitivity) ok')
    return here


def phase_grid_kernels():
    """The grid kernels against the plain grid rollout (tolerances as
    ``phase_rollout_kernels``); times at B = 1000 (the value path's) and
    B = 100 (the main path's). Returns the B = 1000 rows."""
    names = ['fused_grid_fwd', 'fused_grid_bwd']
    worst = {n: 0.0 for n in names}
    cases = [(B, True) for B in GRID_BATCHES] + [(37, False)]
    for B, mm_rewards in cases:
        here = check_grid(B, mm_rewards)
        for n in names:
            worst[n] = max(worst[n], here[n])
    rows, parts = grid_timings(GRID_B, split=True)
    for B, tt in ((GRID_B, rows), (MAIN_B, grid_timings(MAIN_B)[0])):
        for name, v in tt.items():
            log(f'[phase 2] {name} B={B} T={MAIN_T}: kernel {v["ms"]:.4f} ms '
                f'(CUDA events around {ROLLOUT_LAUNCHES} launches), plain '
                f'{v["plain_ms"]:.4f} ms (graph replay), no single library '
                f'call, bound {v["bound_ms"]:.6f} ms ({v["bound_by"]})')
    log_split(f'grid B={GRID_B} forward + backward ({k_plan(GRID_B)})',
              parts)
    for name, v in rows.items():
        v['max_abs_err'] = worst[name]
    return rows


# ---------------------------------------------------------------------------
# phase 2c: rows 3-5 with the value update's critic refit in the launch
# ---------------------------------------------------------------------------

# the with-value driver's critic (examples/deep_pilco_common.py:147-166):
# [200, 200] relu MLP, concrete dropout 0.1, a plain head, MSE TD(H), H = T,
# reg_weight 1e-4, Adam 1e-4, polyak 1
VALUE_LR = 1e-4
# rows 3-5 with that critic: (B, moment matching) of the with-value driver
# (B = 100, no MM) and of phase 7 (B = 1000, states and rewards matched)
CRITIC_CASES = ((MAIN_B, False), (GRID_B, True))
# params' and target' after the critic's Adam step, kernel vs plain, in
# units of lr (hold_adam), and the share of entries that may need their
# gradient's rounding room beyond it (one in ADAM_EDGE)
ADAM_TOL = 1e-3
ADAM_EDGE = 1000
# mu' and nu' entry by entry where the plain entry is above ENTRY_STRONG
# times the plain version's sensitivity: within ENTRY_REL of its size
# (hold_entries)
ENTRY_STRONG = 100
ENTRY_REL = 0.5


def critic_spec(D, head='mse', hidden=(200, 200), drop='concrete', H=MAIN_T,
                tau=1.0, discount=0.9, options=()):
    """The critic (a ``Regressor`` on the D states: a plain head for the MSE
    loss, a ``DiagGaussianDensity(1)`` for the NLL) and its TD(H) update
    (``discount`` over H steps, reg_weight 1e-4, Adam VALUE_LR, polyak
    ``tau``): (V, update). ``options`` of its MLP: 'ang' angle embedding of
    state dim 3, 'drop' concrete input dropout 0.1, 'out' a swish output,
    'sn' spectral norm of every layer (sn_max_K 10, one power iteration)
    (CRITIC_OPTION_SETS)."""
    density = head == 'nll'
    dropout = {'concrete': cdropout(0.1), 'bernoulli': bdropout(0.1),
               None: None}[drop]
    ang = (3,) if 'ang' in options else ()
    kw = {}
    if 'drop' in options:
        kw['input_dropout'] = cdropout(0.1)
    if 'out' in options:
        kw['output_nonlin'] = 'swish'
    if 'sn' in options:
        kw.update(spectral_norm=True, spectral_norm_output=True)
    V = Regressor(MLPSpec(D + len(ang), 2 if density else 1, hidden,
                          dropout=dropout, **kw),
                  DiagGaussianDensity(1) if density else None,
                  angle_dims=ang)
    return V, make_value_update_fn(V, Adam(VALUE_LR), H, discount=discount,
                                   polyak=tau, use_density=density)


def critic_problem(B, seed, mm=True, head='mse', H=MAIN_T, tau=1.0,
                   T=MAIN_T, hidden=(200, 200), drop='concrete', groups=None,
                   components=0, coptions=(), env='Cartpole'):
    """Rows 3-5 with the critic of ``critic_spec`` refit in the launch, on
    ``rollout_problem``'s inputs (``env``'s shapes, Cartpole's by default;
    states and rewards moment-matched with ``mm``, per group of B / groups
    with ``groups``, else neither), the critic's stats fit to
    seeded data and its Adam state fresh: (kernel loss, kernel
    value-and-grad, plain loss, policy params, policy leaves, the arguments
    after the policy params, the critic's extras (params, target, Adam
    state, stats, noise), (dyn, pol, w_t, update)). The plain loss runs the
    critic on the unfused MLP; ``components`` as ``rollout_problem``;
    ``coptions`` the critic's options (``critic_spec``)."""
    _, _, _, pp, leaves, args, (dyn, pol, w_t) = rollout_problem(
        B, seed, False, T, env=env, groups=groups, components=components)
    if not mm:
        args = args[:5] + [None, None, args[7]]
    D = args[0].shape[1]
    V, update = critic_spec(D, head, hidden, drop, H, tau, options=coptions)
    update_p = make_value_update_fn(fr.unfused(V), update.optimizer, H,
                                    discount=0.9, polyak=tau,
                                    use_density=head == 'nll')
    rng = np.random.RandomState(seed + 3)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 50)
    vp = V.init(gen, device='cuda')
    vt = V.init(gen, device='cuda') if tau < 1 else vp
    vstats = V.fit_stats(t(env_states(env, rng, 200)),
                         t(rng.randn(200, 1)))
    extras = (vp, vt, update.optimizer.init(vp), vstats,
              V.sample_noise(gen, (B,), device='cuda'))
    w_H = 0.9 ** T
    make = (dyn, pol, T, w_t, mm, mm, True)
    return (fr.make_fused_loss(*make, mode='full', value_update=update,
                               w_H=w_H, mm_groups=groups),
            fr.make_fused_value_and_grad(*make, mode='full',
                                         value_update=update, w_H=w_H,
                                         mm_groups=groups),
            fr.make_loss_plain(fr.unfused(picking(dyn)),
                               fr.unfused(picking_pol(pol)), T,
                               w_t, mm, mm, True, groups,
                               value_update=update_p, w_H=w_H),
            pp, leaves, args, extras, (dyn, pol, w_t, update))


def aux_flat(aux):
    """The refit's outputs as copies: params', target', mu', nu' flat, the
    Adam count and v_loss."""
    vp, vt, vo, vl = aux

    def flat(tree):
        return torch.cat([v.detach().reshape(-1) for v in tree_leaves(tree)])

    return {'params': flat(vp), 'target': flat(vt), 'mu': flat(vo.mu),
            'nu': flat(vo.nu), 'count': int(vo.count),
            'v_loss': vl.detach().reshape(()).clone()}


def critic_outputs(loss_fn, pp, leaves, args, extras, x0_scale=1.0,
                   g=(0.7, 1.3)):
    """``rollout_outputs`` with the critic's extras: ([loss, mean_return,
    the gradients wrt the policy leaves and action_eps of g[0] * loss +
    g[1] * mean_return], ``aux_flat`` of the refit's outputs)."""
    a = list(args)
    a[0] = a[0] * x0_scale
    a[-1] = a[-1].clone().requires_grad_(True)
    loss, mret, aux = loss_fn(pp, *a, extras=extras)
    aux = aux_flat(aux)
    grads = torch.autograd.grad(g[0] * loss + g[1] * mret, leaves + [a[-1]])
    return [loss.detach(), mret.detach(), *grads], aux


def hold_adam(what, a, r, g, g_tol, lr, eps, weight=1.0):
    """Hold params' (``weight`` 1) or target' (``weight`` tau) after one
    Adam step from a fresh state, kernel ``a`` vs plain ``r``, in units of
    lr. The step of an entry is lr g / (|g| + eps), so a gradient that
    differs by at most ``g_tol`` from the plain ``g`` moves it by at most lr
    g_tol eps / (max(|g| - g_tol, 0) + eps)^2, up to 2 lr where the
    gradient's sign is not determined at float32 (entries at rounding
    level): each entry is held within weight lr (ADAM_TOL + that bound, at
    most 2), and at most one entry in ADAM_EDGE may need more than ADAM_TOL
    lr (each logged), so a fault in the steps of many small-gradient
    entries (zeroed, sign flipped, skipped) fails. Returns the largest
    |a - r| / lr."""
    if not torch.isfinite(a).all():
        raise AssertionError(f'{what}: kernel output is not finite')
    room = torch.clamp(g_tol * eps / (torch.clamp(g.abs() - g_tol, min=0)
                                      + eps) ** 2, max=2.0)
    allowed = weight * lr * (ADAM_TOL + room)
    d = (a - r).abs()
    bad = int((d > allowed).sum())
    edge = (d > weight * lr * ADAM_TOL).nonzero().flatten().tolist()
    if bad:
        i = int(torch.argmax(d - allowed))
        raise AssertionError(f'{what}: {bad} entries beyond their tolerance, '
                             f'the worst {float(d[i]):.3e} against '
                             f'{float(allowed[i]):.3e} (gradient '
                             f'{float(g[i]):.3e})')
    if len(edge) * ADAM_EDGE > d.numel():
        raise AssertionError(f'{what}: {len(edge)} of {d.numel()} entries '
                             f'beyond {ADAM_TOL:g} lr, more than one in '
                             f'{ADAM_EDGE}')
    for i in edge:
        log(f'[phase 2c] {what}: entry {i} of {d.numel()} '
            f'{float(d[i]) / lr:.3e} lr from the plain version, beyond '
            f'{ADAM_TOL:g} lr and within its gradient\'s rounding room '
            f'{float(allowed[i]) / (weight * lr):.3e} lr (gradient '
            f'{float(g[i]):.3e}, tolerance {g_tol:.3e})')
    return float(d.max()) / lr


def hold_entries(what, a, r, moved):
    """Hold a gradient-like output of the refit (mu', nu') entry by entry
    where the plain version's entry lies well above its own sensitivity
    (|r| > ENTRY_STRONG max(max|moved - r|, float32's epsilon max|r|)):
    there the kernel's entry lies within ENTRY_REL |r| of it (so it has its
    sign), which ``hold``'s max-relative rule cannot see of an entry far
    below the largest. A ReLU of V0 that one particle's pre-activation puts
    within rounding of 0 moves the entries it feeds by that particle's
    share, about 1 / sqrt(B) of an entry summed over B shares of either sign
    (1/4 at B = 16); at most one held entry in ADAM_EDGE may lie beyond,
    each logged. Returns the largest relative error of a held entry."""
    scale = float(r.abs().max())
    sens = float((moved - r).abs().max())
    strong = r.abs() > ENTRY_STRONG * max(sens, 1.2e-7 * scale)
    rel = ((a - r).abs() / r.abs().clamp(min=1e-30))[strong]
    off = (rel > ENTRY_REL).nonzero().flatten()
    if len(off) * ADAM_EDGE > rel.numel():
        raise AssertionError(f'{what}: {len(off)} of {rel.numel()} '
                             f'entries above {ENTRY_STRONG:g} times the '
                             f'plain version\'s sensitivity lie beyond '
                             f'{ENTRY_REL:g} of their size')
    idx = strong.nonzero().flatten()
    for j in off.tolist():
        i = int(idx[j])
        log(f'[phase 2c] {what}: entry {i} {float(a[i]):.6e} against '
            f'{float(r[i]):.6e}, beyond {ENTRY_REL:g} of its size')
    return float(rel.max()) if rel.numel() else 0.0


def hold_refit(what, got, ref, moved, update, first_count):
    """The refit's outputs of a kernel (``aux_flat``) against the plain
    version's: the count one past ``first_count``, v_loss, mu' and nu'
    (the gradient) to STEP_TOL of their max|plain| or the plain version's
    sensitivity and entry by entry by ``hold_entries``, params' and target'
    by ``hold_adam``. Returns the largest error of each."""
    if got['count'] != first_count + 1:
        raise AssertionError(f'{what}: Adam count {got["count"]}')
    out = {}
    for k in ('v_loss', 'mu', 'nu'):
        out[k] = hold(f'{what} {k}', got[k], ref[k], STEP_TOL, moved[k])[1]
    for k in ('mu', 'nu'):
        out[f'{k} entries'] = hold_entries(f'{what} {k}', got[k], ref[k],
                                           moved[k])
    opt = update.optimizer
    g_ref = ref['mu'] / (1 - opt.b1)
    g_tol = max(STEP_TOL * float(ref['mu'].abs().max()),
                3 * float((moved['mu'] - ref['mu']).abs().max())) / (1 - opt.b1)
    out['params'] = hold_adam(f'{what} params\'', got['params'],
                              ref['params'], g_ref, g_tol, opt.lr, opt.eps)
    out['target'] = hold_adam(f'{what} target\'', got['target'],
                              ref['target'], g_ref, g_tol, opt.lr, opt.eps,
                              update.polyak)
    return out


def check_critic(B, mm, head='mse', H=MAIN_T, tau=1.0, tag='phase 2c',
                 drop='concrete', groups=None, components=0, coptions=(),
                 env='Cartpole'):
    """Rows 3-5 with the critic refit in the launch against the plain
    version at batch B: loss, mean_return, the policy grads and d
    action_eps (``check_rollout``'s tolerances; d action_eps per particle by
    ``hold_rows`` at B >= 1000, as the grid's) and the refit's outputs of
    rows 3 and 5 (``hold_refit``); ``groups`` as ``critic_problem``, the
    rollout's outputs then held against the plain version in float64
    (``float64``; the refit's against the float32 one, whose Adam step
    ``hold_adam`` measures); ``components`` as ``rollout_problem``, a
    mixture head held through ``held_against``; ``coptions`` the critic's
    options (``critic_spec``); ``env`` as ``critic_problem``. Returns the
    largest error of each row."""
    kloss, kvg, plain, pp, leaves, args, extras, (_, _, _, update) = \
        critic_problem(B, B + 11, mm, head, H, tau, drop=drop, groups=groups,
                       components=components, coptions=coptions, env=env)
    ref_fn = float64(plain) if groups else plain
    got, gaux = critic_outputs(kloss, pp, leaves, args, extras)
    vl, vm, vgrads, vaux = kvg(pp, *args, extras=extras)
    vaux = aux_flat(vaux)
    f32 = ''

    def plain_outputs():
        nonlocal f32
        ref, raux = critic_outputs(ref_fn, pp, leaves, args, extras)
        moved, maux = critic_outputs(ref_fn, pp, leaves, args, extras,
                                     1 + 1e-6)
        vref, vraux = critic_outputs(ref_fn, pp, leaves, args, extras,
                                     g=(1.0, 0.0))
        vmoved, vmaux = critic_outputs(ref_fn, pp, leaves, args, extras,
                                       1 + 1e-6, g=(1.0, 0.0))
        if groups:  # the refit against the float32 plain version
            ref32, raux = critic_outputs(plain, pp, leaves, args, extras)
            worst = max(rel_err(a, r) for a, r in zip(ref32[2:], ref[2:]))
            f32 = f', the float32 plain version\'s from it {worst:.3e}'
            maux = critic_outputs(plain, pp, leaves, args, extras,
                                  1 + 1e-6)[1]
            vraux = critic_outputs(plain, pp, leaves, args, extras,
                                   g=(1.0, 0.0))[1]
            vmaux = critic_outputs(plain, pp, leaves, args, extras, 1 + 1e-6,
                                   g=(1.0, 0.0))[1]
        return ref, raux, moved, maux, vref, vraux, vmoved, vmaux

    n = len(leaves)
    labels = (['loss', 'mean_return']
              + [f'd pol leaf {i}' for i in range(n)] + ['d eps'])
    names = ['fused_rollout_fwd', 'fused_rollout_bwd', 'fused_rollout_vg']
    what = ((f'{env} ' if env != 'Cartpole' else '')
            + f'critic ({head}, {drop} dropout, H={H}, polyak {tau}) rollout '
            f'B={B} mm {"on" if mm else "off"}'
            + (f' mm_groups={groups}' if groups else '')
            + (f' mixture K={components}' if components else '')
            + (f' options {"+".join(coptions)}' if coptions else ''))

    def hold_all(outs):
        ref, raux, moved, maux, vref, vraux, vmoved, vmaux = outs
        torch.cuda.synchronize()
        checks = ([('fused_rollout_fwd', lab, a, r, m) for lab, a, r, m in
                   zip(labels[:2], got[:2], ref[:2], moved[:2])]
                  + [('fused_rollout_bwd', lab, a, r, m) for lab, a, r, m in
                     zip(labels[2:], got[2:], ref[2:], moved[2:])]
                  + [('fused_rollout_vg', lab, a, r, m) for lab, a, r, m in
                     zip(labels[:-1], [vl, vm, *tree_leaves(vgrads)],
                         vref[:-1], vmoved[:-1])])
        here = {nm: 0.0 for nm in names}
        for kern, lab, a, r, m in checks:
            check = hold_rows if lab == 'd eps' and B >= 1000 else hold
            err = check(f'{what} {kern} {lab}', a, r, STEP_TOL, m)[0]
            here[kern] = max(here[kern], err)
        first = int(extras[2].count)
        refit = {}
        for kern, (a, r, m) in (('fused_rollout_fwd', (gaux, raux, maux)),
                                ('fused_rollout_vg', (vaux, vraux, vmaux))):
            refit[kern] = hold_refit(f'{what} {kern}', a, r, m, update,
                                     first)
        return here, refit, ref, raux

    here, refit, ref, raux = held_against(what, plain_outputs, MAIN_T,
                                          hold_all)
    if groups:
        f32 = ('; grads from the float64 plain version, relative to its '
               f'max: the kernel\'s (row 4) '
               f'{max(rel_err(a, r) for a, r in zip(got[2:], ref[2:])):.3e}'
               + f32)
    log(f'[{tag}] {what} T={MAIN_T} (loss {float(ref[0]):.6f}, v_loss '
        f'{float(raux["v_loss"]):.6f}){f32}: kernel vs plain max abs err '
        + ', '.join(f'{nm[len("fused_rollout_"):]} {here[nm]:.3e}'
                    for nm in names)
        + '; the refit, error / max|plain| (params\' and target\' in lr): '
        + '; '.join(f'{nm[len("fused_rollout_"):]} '
                    + ', '.join(f'{k} {v:.3e}' for k, v in r.items())
                    for nm, r in refit.items()) + ' ok')
    return here


def critic_bytes_flops(B, cdims, D):
    """Bytes and operations of the critic's part of rows 3-5 at batch B:
    a forward is 2 B S operations (S = sum d_in d_out), a backward to dW
    and the input 4 B S, to the input alone 2 B S. Row 3 runs V(target,
    s_H), V0 and its backward, and the bootstrap's forward (10 B S); row 5
    also the bootstrap's backward (12 B S); row 4 the bootstrap's forward
    and backward (4 B S). Bytes: rows 3 and 5 read params, target, Adam's
    mu and nu (4 N floats, N the critic's leaves), the noise (u and u_hard
    of each hidden layer) and the stats, and write params', target', mu',
    nu', the count and v_loss; row 4 reads params' and the noise."""
    S = sum(a * b for a, b in zip(cdims[:-1], cdims[1:]))
    N = S + sum(cdims[1:]) + sum(cdims[1:-1])
    noise = 2 * B * sum(cdims[1:-1])
    stats = 2 * D + 2
    return {'fused_rollout_fwd': (4 * (8 * N + noise + stats + 3), 10 * B * S),
            'fused_rollout_bwd': (4 * (N + noise + stats), 4 * B * S),
            'fused_rollout_vg': (4 * (8 * N + noise + stats + 3), 12 * B * S)}


def critic_timings(B, mm, split=False, coptions=(), env='Cartpole',
                   groups=None):
    """ms of rows 3-5 with the driver's critic refit in the launch (CUDA
    events around launches in a row, as ``rollout_timings``), of the same
    rows without a critic on the same inputs (``bare_ms``; the reward not
    mean-only) and of the plain version (CUDA graph replay: the plain
    forward with its refit; the backward that and ``torch.autograd.grad``
    less it; row 5 the whole graph), at batch B, T = 15; the bound counts
    the rollout's work and the critic's (``critic_bytes_flops``). With
    ``split`` it logs row 5's own time split and the critic's share of it;
    ``coptions`` the critic's options (``critic_spec``); ``env`` and
    ``groups`` as ``critic_problem``."""
    _, _, plain, pp, leaves, args, extras, (dyn, pol, w_t, update) = \
        critic_problem(B, 7, mm, coptions=coptions, env=env, groups=groups)
    x0, dyn_params, stats, dyn_noise, pol_noise, z_mm, z_rr, eps = args
    w_H = 0.9 ** MAIN_T
    k = fr.RolloutKernel(dyn, pol, MAIN_T, w_t, mm, mm, True, False, B,
                         x0.device, update, w_H, mm_groups=groups)
    sk = k.bind(pp, x0, dyn_params, stats, dyn_noise, pol_noise, z_mm, z_rr,
                eps)
    cb = k.bind_critic(extras)
    _, _, res = k.forward(sk, cb)
    g_loss = torch.ones((), device='cuda')
    g_mret = torch.zeros((), device='cuda')
    bare = fr.RolloutKernel(dyn, pol, MAIN_T, w_t, mm, mm, True, False, B,
                            x0.device, mm_groups=groups)
    bare_res = bare.forward(sk)[2]
    bare_ms = {
        'fused_rollout_fwd': time_launches(lambda: bare.forward(sk)),
        'fused_rollout_bwd': time_launches(lambda: bare.backward(
            sk, bare_res, g_loss, g_mret, True)),
        'fused_rollout_vg': time_launches(lambda: bare.value_and_grad(sk))}

    def plain_fwd():
        return plain(pp, *args, extras=extras)

    def plain_vg():
        torch.autograd.grad(plain_fwd()[0], leaves)

    plain_fwd_ms = time_graph(plain_fwd, n=5)
    plain_vg_ms = time_graph(plain_vg, n=5)
    t = {
        'fused_rollout_fwd': dict(ms=time_launches(lambda: k.forward(sk, cb)),
                                  plain_ms=plain_fwd_ms),
        'fused_rollout_bwd': dict(
            ms=time_launches(lambda: k.backward(sk, res, g_loss, g_mret, True,
                                                cb)),
            plain_ms=plain_vg_ms - plain_fwd_ms),
        'fused_rollout_vg': dict(ms=time_launches(
            lambda: k.value_and_grad(sk, cb)), plain_ms=plain_vg_ms),
    }
    D, U = x0.shape[1], eps.shape[2]
    work = rollout_bytes_flops(B, MAIN_T, *net_dims(dyn, pol), D, U,
                               r_mm=mm)
    cwork = critic_bytes_flops(B, critic.critic_dims(update.spec), D)
    for name in t:
        (b0, f0), (b1, f1) = work[name], cwork[name]
        t[name]['bound_ms'], t[name]['bound_by'] = bound(b0 + b1, f0 + f1)
        t[name]['bare_ms'] = bare_ms[name]
    if split:
        parts = time_split(k, lambda: k.value_and_grad(sk, cb))
        log_split(f'{env} fused_rollout_vg with the critic B={B}', parts)
        log(f'[phase 2] {env} fused_rollout_vg with the critic B={B}: the '
            f'critic\'s part (refit and bootstrap) {parts[-1]:.4f} ms of '
            f'{sum(parts):.4f} ({100 * parts[-1] / sum(parts):.1f}%)')
    return t


def phase_critic_kernels():
    """Phase 2c: rows 3-5 with the with-value driver's critic refit in the
    launch, held against the plain version (``check_critic``) at the
    CRITIC_CASES, and timed there beside the same rows without a critic
    and the card's name and power limit. Returns the times {(B, mm):
    times}."""
    for B, mm in CRITIC_CASES:
        check_critic(B, mm)
    check_critic(MAIN_B, True, groups=GROUPED_CRITIC)
    card = card_line()
    out = {}
    for B, mm in CRITIC_CASES:
        tt = out[(B, mm)] = critic_timings(B, mm, split=B == MAIN_B)
        for name, v in tt.items():
            log(f'[phase 2c] {name} with the critic B={B} T={MAIN_T} MM '
                f'{"on" if mm else "off"}: kernel {v["ms"]:.4f} ms (CUDA '
                f'events around {ROLLOUT_LAUNCHES} launches; without a '
                f'critic {v["bare_ms"]:.4f} ms), plain {v["plain_ms"]:.4f} '
                f'ms (graph replay), bound {v["bound_ms"]:.6f} ms '
                f'({v["bound_by"]}); {card}')
    return out


# ---------------------------------------------------------------------------
# phase 2cw: rows 3-5 of the wide instance with the critic refit
# ---------------------------------------------------------------------------


def phase_wide_critic_kernels(critic_rows, card):
    """Phase 2cw: rows 3-5 of the wide instance with the with-value driver's
    critic (JAX bench.py's value variant's: [200, 200], concrete dropout,
    MSE, Adam 1e-4, polyak 1, H = 15) refit in the launch, at
    WIDE_CRITIC_CASES, held against the plain version as phase 2c holds
    them (``check_critic``; grouped against float64), then each case timed
    beside the same rows without a critic and phase 2c's narrow rows with
    the critic (``critic_rows``), with the critic's part of row 5's own
    time split, the card's name and power limit (``card``). Returns the
    benchmark's value variant's rows (D = 5, B = 100, no MM) for the
    kernels line, keyed by the wide critic kernels' names."""
    worst = {n: 0.0 for n in WIDE_CRITIC_KERNELS}
    for env, B, mm, groups in WIDE_CRITIC_CASES:
        dyn, pol, D, U = env_models(env)
        if fr.kernel_instance(dyn, pol) is not fr.WIDE:
            raise AssertionError(f'{env} does not take the wide instance')
        here = check_critic(B, mm, tag='phase 2cw', groups=groups, env=env)
        for n, e in here.items():
            worst[n + '_wide_critic'] = max(worst[n + '_wide_critic'], e)
    rows = {}
    for env, B, mm, groups in WIDE_CRITIC_CASES:
        D, U = BENCH_SHAPES[env]
        tt = critic_timings(B, mm, split=True, env=env, groups=groups)
        narrow = critic_rows.get((B, mm)) if not groups else None
        for name, v in tt.items():
            beside = (f'; the narrow instance with the critic (phase 2c, '
                      f'Cartpole D=5) {narrow[name]["ms"]:.4f} ms'
                      if narrow else '')
            log(f'[phase 2cw] {name} with the critic, {env} (D={D}, U={U}) '
                f'B={B} T={MAIN_T} MM {"on" if mm else "off"}'
                + (f' mm_groups={groups}' if groups else '')
                + f': wide instance {v["ms"]:.4f} ms (CUDA events around '
                f'{ROLLOUT_LAUNCHES} launches; without a critic '
                f'{v["bare_ms"]:.4f} ms{beside}), plain {v["plain_ms"]:.4f} '
                f'ms (graph replay), bound {v["bound_ms"]:.6f} ms '
                f'({v["bound_by"]}); {card}')
        if (env, B, mm, groups) == WIDE_CRITIC_CASES[0]:
            rows = {n + '_wide_critic': dict(v, max_abs_err=worst[
                n + '_wide_critic'], library_ms=None) for n, v in tt.items()}
    return rows


# ---------------------------------------------------------------------------
# phase 2g: rows 3-9 with grouped moment matching
# ---------------------------------------------------------------------------


def phase_grouped_kernels(rows, card):
    """Phase 2g: rows 3-9 with MM per group (``mm_groups``) held against
    their plain versions as phase 2 holds them: rows 6-7 and 3-5 at
    B = 100 with G in GROUPS_B100 (10 groups of 10, JAX's bench variant;
    50 groups of 2, whose states are not resampled: a group of 2 has a
    rank-1 covariance in D = 5), rows 3-5 with the reward mean-only
    shortcut on and off where the states are resampled; rows 8-9 at
    B = 1000 with G in GROUPS_B1000. Each row's time, plain time and bound
    at the first G (B = 100 for rows 3-7, 1000 for rows 8-9) beside phase
    2's ungrouped time (``rows``) and the card's name and power limit."""
    D = 5
    for G in GROUPS_B100:
        check_step(MAIN_B, tag='phase 2g', groups=G)
        for mean_only in ((True, False) if MAIN_B // G > D else (False,)):
            check_rollout(MAIN_B, mean_only, tag='phase 2g', groups=G)
    for G in GROUPS_B1000:
        check_grid(GRID_B, True, tag='phase 2g', groups=G)
    G3, G8 = GROUPS_B100[0], GROUPS_B1000[0]
    tt, plans = step_timings(MAIN_B, groups=G3)
    timed = [(MAIN_B, G3, tt), (MAIN_B, G3, rollout_timings(
        split=False, groups=G3)), (GRID_B, G8, grid_timings(GRID_B,
                                                            groups=G8)[0])]
    for B, G, tt in timed:
        for name, v in tt.items():
            log(f'[phase 2g] {name} B={B} mm_groups={G}: kernel '
                f'{v["ms"]:.4f} ms (ungrouped {rows[name]["ms"]:.4f} ms), '
                f'plain {v["plain_ms"]:.4f} ms, bound {v["bound_ms"]:.6f} ms '
                f'({v["bound_by"]}); {card}')


# ---------------------------------------------------------------------------
# phase 2b: rows 3-9 at the envs' shapes
# ---------------------------------------------------------------------------


def phase_env_kernels(rows, card):
    """Rows 3-9 against their plain versions (``hold``, ``hold_rows``) at the
    shapes of the envs beside Cartpole, states and rewards moment-matched:
    the double cartpole (embedded D = 8 = kMaxD, U = 1, the exp-quadratic tip
    reward), rendezvous (D = 8, U = 4 = kMaxU, four tip rows, the quadratic
    reward), the pendulum (D = 3) and the differentiable lander (D = 8,
    U = 2, the lander's reward, kind 2; built directly, whatever ``make``
    gives), the lander once more saturated (``step_problem``: actions
    exactly on the reward's kinks). Rows 6-7 and 3-5 at B = 100, T = 15
    (3-5 with the reward mean-only shortcut and without), rows 8-9 at
    B = 1000. Then the learned reward (reward kind 3, ``learned``) at
    Cartpole's shapes (D = 5, U = 1, a head of 12) and at the lander's
    (D = 8, U = 2, a head of 18, the Box2D lander's; states at the lander's
    scales), whose grid gradient wrt action_eps is also held along the
    kernel's own states (``hold_grid_eps_on_edge``). At D = 8 and with a
    learned reward each row's time, its bound and its plain version's time
    beside the D = 5 time of phase 2 (``rows``) from this call and the
    card's name and power limit (``card``). Returns the times of each env
    timed, {label: times}."""
    out = {}
    for env, learned in ENV_KERNEL_ENVS:
        check_step(MAIN_B, env, 'phase 2b', learned=learned)
        for mean_only in (True, False):
            check_rollout(MAIN_B, mean_only, env, 'phase 2b',
                          learned=learned)
        check_grid(GRID_B, True, env, 'phase 2b', learned=learned)
        if env == 'JaxLunarLander' and not learned:
            check_step(MAIN_B, env, 'phase 2b', saturated=True)
            for mean_only in (True, False):
                check_rollout(MAIN_B, mean_only, env, 'phase 2b',
                              saturated=True)
            check_grid(GRID_B, True, env, 'phase 2b', saturated=True)
        dyn, _, D, U = env_models(env, learned=learned)
        if D != fr.MAX_D and not learned:
            continue
        steps, plans = step_timings(MAIN_B, env, learned)
        label = env_label(env, learned)
        log(f'[phase 2b] {label} launch plans: step B={MAIN_B} {plans}; '
            f'rollout B={MAIN_B} {k_plan(MAIN_B, env, learned)}; grid '
            f'B={GRID_B} {k_plan(GRID_B, env, learned)}')
        times = out[label] = {
            **steps, **rollout_timings(env, False, learned),
            **grid_timings(GRID_B, env=env, learned=learned)[0]}
        for name, v in times.items():
            B = GRID_B if name.startswith('fused_grid') else MAIN_B
            log(f'[phase 2b] {name} B={B}: {label} (D={D}, U={U}, reward '
                f'kind {fr.reward_kind(dyn.reward_func)}) kernel '
                f'{v["ms"]:.4f} ms beside Cartpole (D=5, U=1) '
                f'{rows[name]["ms"]:.4f} ms; plain {v["plain_ms"]:.4f} ms '
                f'(Cartpole {rows[name]["plain_ms"]:.4f}); bound '
                f'{v["bound_ms"]:.6f} ms ({v["bound_by"]}; Cartpole '
                f'{rows[name]["bound_ms"]:.6f}); {card}')
    return out


# ---------------------------------------------------------------------------
# phase 2m: rows 3-9 with a mixture dynamics head
# ---------------------------------------------------------------------------


def grid_batch(env='Cartpole', components=0):
    """GRID_B, or the particles the card holds at once at ``env``'s shapes
    with a mixture head of ``components`` where that is fewer (the grid
    kernels' cooperative launch needs every cluster resident)."""
    dyn, pol = env_models(env, components=components)[:2]
    return min(GRID_B, fr.rollout_capacity(dyn, pol, 'cuda'))


def phase_mixture_kernels(rows, card):
    """Rows 3-9 with a ``GaussianMixtureDensity`` dynamics head (the
    kernels' ``StepArgs::K``) against their plain versions, each pick on an
    edge allowed to differ (``held_against``): Cartpole's shapes with K in
    MIXTURE_KS (2, 5, 8 and 16: heads of 23, 56, 89 and 177), rows 3-7 at
    B = 100 (3-5 with the reward mean-only shortcut and without) and rows
    8-9 at GRID_B or, where the card holds fewer particles at once, that
    many (``grid_batch``: 960 at K = 16 on an H100); rows 3-5 at B = 100
    with K = MIXTURE_BIG_K = 32 (a head of 353, without the shortcut), with
    K = 2 and a learned reward (a head of 27), grouped MM (G = 10) and the
    critic refit (B = 100, no MM, phase 2c's first case). Each K's capacity
    and launch plans, and each row's time, its bound and its plain
    version's time beside K = 5's and the diagonal head's from this call
    (``rows``), with the card's name and power limit (``card``)."""
    for K in MIXTURE_KS:
        check_step(MAIN_B, tag='phase 2m', components=K)
        for mean_only in (True, False):
            check_rollout(MAIN_B, mean_only, tag='phase 2m', components=K)
        check_grid(grid_batch(components=K), True, tag='phase 2m',
                   components=K)
    check_rollout(MAIN_B, False, tag='phase 2m', components=MIXTURE_BIG_K)
    check_rollout(MAIN_B, False, tag='phase 2m', learned=True, components=2)
    check_rollout(MAIN_B, True, tag='phase 2m', groups=10, components=2)
    check_critic(MAIN_B, False, tag='phase 2m', components=2)
    five = {}
    for K in MIXTURE_KS + (MIXTURE_BIG_K,):
        dyn, pol = env_models('Cartpole', components=K)[:2]
        Bg = grid_batch(components=K)
        times = rollout_timings(split=False, components=K)
        plans = f'rollout B={MAIN_B} {k_plan(MAIN_B, components=K)}'
        if K != MIXTURE_BIG_K:
            steps, step_plan = step_timings(MAIN_B, components=K)
            times = {**steps, **times,
                     **grid_timings(Bg, components=K)[0]}
            plans = (f'step B={MAIN_B} {step_plan}; {plans}; grid B={Bg} '
                     f'{k_plan(Bg, components=K)}')
        log(f'[phase 2m] mixture K={K} (a head of {11 * K + 1}) launch '
            f'plans: {plans}; the card holds '
            f'{fr.rollout_capacity(dyn, pol, "cuda")} particles of the '
            'whole-rollout kernel at once')
        for name, v in times.items():
            B = Bg if name.startswith('fused_grid') else MAIN_B
            beside = (f' (K=5 {five[name]["ms"]:.4f} ms)'
                      if name in five and K != 5 else '')
            log(f'[phase 2m] {name} B={B}: Cartpole mixture K={K} kernel '
                f'{v["ms"]:.4f} ms{beside} beside the diagonal head '
                f'{rows[name]["ms"]:.4f} ms; plain {v["plain_ms"]:.4f} ms '
                f'(diagonal {rows[name]["plain_ms"]:.4f}); bound '
                f'{v["bound_ms"]:.6f} ms ({v["bound_by"]}; diagonal '
                f'{rows[name]["bound_ms"]:.6f}); {card}')
        if K == 5:
            five = times


# ---------------------------------------------------------------------------
# phase 2h: rows 1-2 with bf16 operands
# ---------------------------------------------------------------------------


def bf16_bound(nbytes, flops):
    """The bf16 instances' bound: the float32 bytes they move over
    HBM_BYTES_PER_S, or their products over the bf16 tensor-core peak,
    whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def hold_bf16(what, a, r):
    """A bf16 instance's output ``a`` against the bf16 plain version's
    ``r``: finite; every entry within 1e-5 * max|r| + 1e-6 but for a share
    of at most 5%, which must lie within 1e-2 * max|r| (an operand within
    rounding of a bf16 tie, which the two round to neighbouring bf16
    values: ``tests/test_torch_fused_mlp_bf16.py``'s rule). Returns (max
    abs err, err / max|r|, share off the tight bound)."""
    if not torch.isfinite(a).all():
        raise AssertionError(f'{what}: kernel output is not finite')
    err = (a - r).abs()
    scale = float(r.abs().max())
    share = float((err > 1e-5 * scale + 1e-6).float().mean())
    worst = float(err.max())
    if share > 0.05 or worst > 1e-2 * scale + 1e-6:
        raise AssertionError(f'{what}: kernel vs plain max abs err {worst:.3e}'
                             f' (max|plain| {scale:.3e}), {share:.4f} of '
                             'entries off 1e-5 relative')
    return worst, worst / max(scale, 1e-30), share


def bf16_timings(dims, masks, B=MAIN_B):
    """ms of each bf16 instance, of its plain version (``fused_mlp_plain``
    with bf16 operands; the backward as ``kernel_timings``') and of the
    chain of ``torch.matmul`` on bf16 operands of the same products, at
    batch B."""
    nl, bf = ('relu', 'relu'), torch.bfloat16
    x, ws, bs, ms, g = mlp_problem(dims, masks, B, seed=7)
    _, a_res = fm._fwd_cuda(x, ws, bs, ms, nl, True)
    hs = [x] + [torch.relu(a) * m for a, m in zip(a_res, ms)]
    gas, g_a = [], g
    for l in range(len(ws) - 1, -1, -1):
        gas.insert(0, g_a)
        if l:
            g_a = (g_a @ ws[l].t()) * ms[l - 1] * (a_res[l - 1] > 0)
    hb, wb, gb = ([v.to(bf) for v in vs] for vs in (hs, ws, gas))
    leaves = [v.detach().clone().requires_grad_(True) for v in
              [x, *ws, *bs, *ms]]
    n = len(ws)
    lx, lw, lb, lm = (leaves[0], leaves[1:1 + n], leaves[1 + n:1 + 2 * n],
                      leaves[1 + 2 * n:])

    def plain_fwd():
        return fm.fused_mlp_plain(lx, lw, lb, lm, nl, compute_dtype=bf)

    def plain_fwd_bwd():
        torch.autograd.grad(plain_fwd(), leaves, g)

    def lib_fwd():
        for h, w in zip(hb, wb):
            torch.matmul(h, w)

    def lib_bwd():
        for l, w in enumerate(wb):
            torch.matmul(hb[l].t(), gb[l])
            torch.matmul(gb[l], w.t())

    has_b = (True,) * n
    plain_fwd_ms = time_graph(plain_fwd)
    t = {
        'fused_mlp_fwd_bf16': dict(
            ms=time_graph(lambda: fm._fwd_cuda(x, ws, bs, ms, nl, True)),
            plain_ms=plain_fwd_ms, library_ms=time_graph(lib_fwd)),
        'fused_mlp_bwd_bf16': dict(
            ms=time_graph(lambda: fm._bwd_cuda(x, ws, has_b, ms, a_res, nl,
                                               g, True)),
            plain_ms=time_graph(plain_fwd_bwd) - plain_fwd_ms,
            library_ms=time_graph(lib_bwd)),
    }
    for name, (nbytes, flops) in mlp_bytes_flops(dims, B).items():
        t[name + '_bf16'].update(bytes=nbytes, flops=flops)
    return t


def phase_bf16_mlp(rows, card):
    """Phase 2h: the bf16 instances of rows 1-2 against the bf16 plain
    version (``hold_bf16``) at the policy's and the dynamics' shapes, B =
    100 (the main path's) and 1000 (the value path's), and with tanh and
    swish; each launch plan; times at B = 100 (the kernels line: the mean of
    policy and dynamics, as rows 1-2's) beside the float32 rows' (``rows``)
    and the card (``card``). Returns the bf16 rows."""
    worst = {n: 0.0 for n in BF16}
    labels = ['out', 'dx'] + ['dW%d' % i for i in range(3)] + [
        'db%d' % i for i in range(3)] + ['dmask0', 'dmask1']
    kern = functools.partial(fm.fused_mlp, compute_dtype='bfloat16')
    plain = functools.partial(fm.fused_mlp_plain, compute_dtype='bfloat16')
    cases = [(net, dims, masks, B) for net, (dims, masks) in SHAPES.items()
             for B in (MAIN_B, GRID_B)]
    for net, dims, masks, B in cases:
        x, ws, bs, ms, g = mlp_problem(dims, masks, B, seed=B + 1)
        got = grads_through(kern, x, ws, bs, ms, g)
        ref = grads_through(plain, x, ws, bs, ms, g)
        torch.cuda.synchronize()
        rel = share = 0.0
        for lab, a, r in zip(labels, got, ref):
            err, r_err, off = hold_bf16(f'{net} B={B} bf16 {lab}', a, r)
            name = BF16[0] if lab == 'out' else BF16[1]
            worst[name] = max(worst[name], err)
            rel, share = max(rel, r_err), max(share, off)
        plan = fm.launch_plan(dims, B, True)
        held = [fm.max_clusters('cuda', bwd, plan.threads, smem, True)
                for bwd, smem in ((False, plan.fwd_smem),
                                  (True, plan.bwd_smem))]
        log(f'[phase 2h] {net} {dims} B={B} bf16 operands: kernel vs bf16 '
            f'plain, worst of an output relative to its max|plain| '
            f'{rel:.3e}, largest share of entries off 1e-5 relative '
            f'{share:.4f} (at most 0.05 within 1e-2) ok; {plan}; the card '
            f'holds {held[0]} forward and {held[1]} backward clusters of it '
            'at once')
    per_net = {net: bf16_timings(dims, masks)
               for net, (dims, masks) in SHAPES.items()}
    out = {}
    for name in BF16:
        for net in SHAPES:
            v = per_net[net][name]
            log(f'[phase 2h] {name} {net} B={MAIN_B}: kernel {v["ms"]:.4f} '
                f'ms, plain {v["plain_ms"]:.4f} ms, torch.matmul chain on '
                f'bf16 operands {v["library_ms"]:.4f} ms; {card}')
        vals = [per_net[net][name] for net in SHAPES]
        mean = {k: float(np.mean([v[k] for v in vals]))
                for k in ('ms', 'plain_ms', 'library_ms', 'bytes', 'flops')}
        mean['bound_ms'], mean['bound_by'] = bf16_bound(mean.pop('bytes'),
                                                        mean.pop('flops'))
        out[name] = dict(mean, max_abs_err=worst[name])
        f32 = rows[name[:-len('_bf16')]]
        log(f'[phase 2h] {name} B={MAIN_B}, mean of policy and dynamics: '
            f'kernel {mean["ms"]:.4f} ms beside float32 {f32["ms"]:.4f}; '
            f'plain {mean["plain_ms"]:.4f}; torch.matmul chain on bf16 '
            f'operands {mean["library_ms"]:.4f}; bound '
            f'{mean["bound_ms"]:.6f} ms ({mean["bound_by"]}: float32 bytes '
            f'at {HBM_BYTES_PER_S:.3g} B/s, products at {BF16_FLOP_PER_S:.3g}'
            f' FLOP/s); {card}')
    return out


# ---------------------------------------------------------------------------
# phase 2o: the model options in rows 3-9
# ---------------------------------------------------------------------------


def phase_option_kernels(rows, card):
    """Phase 2o: rows 3-9 on Cartpole with each option set of OPTION_SETS
    (B1 spectral norm, B2 input dropout and output nonlinearities, B3 angle
    embedding inside the models, and all three) against their plain
    versions (``make_loss_plain``, ``make_step_plain``, the plain grid
    rollout: the tolerances of phase 2), rows 3-7 at B = 100 and rows 8-9
    at B = 1000; with all three, rows 3-5 without the reward mean-only
    shortcut, in 10 MM groups and with a mixture head (K = 2), rows 6-7
    with the mixture head. Each row's time with all three beside the
    float32 rows' (``rows``) and the card (``card``)."""
    for label, opts in OPTION_SETS.items():
        dyn, pol = env_models('Cartpole', options=opts)[:2]
        why = fr.kernel_refuses(dyn, pol)
        if why is not None:
            raise AssertionError(f'the gate refuses {label}: {why}')
        check_step(MAIN_B, tag=f'phase 2o {label}', options=opts)
        check_rollout(MAIN_B, True, tag=f'phase 2o {label}', options=opts)
        check_grid(GRID_B, True, tag=f'phase 2o {label}', options=opts)
    tag = 'phase 2o B1-B3'
    check_rollout(MAIN_B, False, tag=tag, options=ALL_OPTIONS)
    check_rollout(MAIN_B, True, tag=tag, groups=GROUPS_MAIN,
                  options=ALL_OPTIONS)
    check_rollout(MAIN_B, True, tag=tag, components=2, options=ALL_OPTIONS)
    check_step(MAIN_B, tag=tag, components=2, options=ALL_OPTIONS)
    steps, plans = step_timings(MAIN_B, options=ALL_OPTIONS)
    log(f'[{tag}] launch plans: step B={MAIN_B} {plans}; rollout '
        f'B={MAIN_B} {k_plan(MAIN_B, options=ALL_OPTIONS)}; grid B={GRID_B} '
        f'{k_plan(GRID_B, options=ALL_OPTIONS)}')
    times = {**steps, **rollout_timings(split=False, options=ALL_OPTIONS),
             **grid_timings(GRID_B, options=ALL_OPTIONS)[0]}
    for name, v in times.items():
        B = GRID_B if name.startswith('fused_grid') else MAIN_B
        log(f'[{tag}] {name} B={B}: Cartpole with B1-B3 kernel '
            f'{v["ms"]:.4f} ms beside without {rows[name]["ms"]:.4f} ms; '
            f'plain {v["plain_ms"]:.4f} ms; bound {v["bound_ms"]:.6f} ms '
            f'({v["bound_by"]}); {card}')


# ---------------------------------------------------------------------------
# phase 2p: the other policy heads in rows 3-9
# ---------------------------------------------------------------------------


def phase_head_kernels(rows, env_rows, card):
    """Phase 2p: rows 3-9 with each policy head of HEAD_ENVS (the
    ``TanhSquashedDensity`` on Cartpole, the ``CategoricalDensity`` on the
    differentiable lander, U = 2) against their plain versions (the
    tolerances of phase 2; the categorical picks through ``held_against``,
    at most one pick in 1000 on an edge flipped), rows 3-7 at B = 100 (3-5
    with the reward mean-only shortcut and without) and rows 8-9 at
    B = 1000. Each row's time, plain time and bound beside the diagonal
    head's on the same env from this call (``rows``: Cartpole's, phase 2;
    ``env_rows``: the lander's, phase 2b) and the card (``card``)."""
    for head, env in HEAD_ENVS:
        opts = (head,)
        dyn, pol = env_models(env, options=opts)[:2]
        why = fr.kernel_refuses(dyn, pol)
        if why is not None:
            raise AssertionError(f'the gate refuses the {head} head: {why}')
        tag = f'phase 2p {head}'
        check_step(MAIN_B, env, tag, options=opts)
        for mean_only in (True, False):
            check_rollout(MAIN_B, mean_only, env, tag, options=opts)
        check_grid(GRID_B, True, env, tag, options=opts)
        steps, plans = step_timings(MAIN_B, env, options=opts)
        log(f'[{tag}] {env} launch plans: step B={MAIN_B} {plans}; rollout '
            f'B={MAIN_B} {k_plan(MAIN_B, env, options=opts)}; grid '
            f'B={GRID_B} {k_plan(GRID_B, env, options=opts)}')
        times = {**steps, **rollout_timings(env, False, options=opts),
                 **grid_timings(GRID_B, env=env, options=opts)[0]}
        base = rows if env == 'Cartpole' else env_rows[env]
        for name, v in times.items():
            B = GRID_B if name.startswith('fused_grid') else MAIN_B
            log(f'[{tag}] {name} B={B}: {env} {head} head kernel '
                f'{v["ms"]:.4f} ms beside the diagonal head '
                f'{base[name]["ms"]:.4f} ms; plain {v["plain_ms"]:.4f} ms '
                f'(diagonal {base[name]["plain_ms"]:.4f}); bound '
                f'{v["bound_ms"]:.6f} ms ({v["bound_by"]}); {card}')


# ---------------------------------------------------------------------------
# phase 2w: the wide instance of rows 3-9 and grouped MM
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def forced_instance(lim):
    """Within it the kernels bind the instance ``lim`` (a ``fr.Limits``,
    which must take the models) wherever the gate would choose one."""
    chosen = fr.kernel_instance
    fr.kernel_instance = lambda dyn, pol: lim
    try:
        yield
    finally:
        fr.kernel_instance = chosen


def wide_against_narrow(env, tag='phase 2w'):
    """Rows 3-9 of the wide instance on the inputs of ``check_step``,
    ``check_rollout`` (no mean-only shortcut) and ``check_grid`` at
    ``env``'s shapes, which the narrow instance takes too: each output held
    against the narrow instance's (``hold``, STEP_TOL of its max|.|), and
    every wide kernel launched."""
    def outputs():
        kernel, _, leaves, states, eps, cot, _ = step_problem(MAIN_B, MAIN_B,
                                                              env)
        outs = {'step': step_outputs(kernel, leaves, states, eps, cot)}
        kloss, kvg, _, pp, leaves, args, _ = rollout_problem(
            MAIN_B, MAIN_B, False, env=env)
        vl, vm, vgrads, _ = kvg(pp, *args)
        outs['rollout'] = (rollout_outputs(kloss, pp, leaves, args)
                           + [vl, vm, *grad_leaves(vgrads)])
        kern, _, pp, leaves, args, cot, _ = grid_problem(GRID_B, GRID_B,
                                                         env=env)
        outs['grid'] = grid_outputs(kern, pp, leaves, args, cot)
        torch.cuda.synchronize()
        return outs

    narrow = outputs()
    reset_counts()
    with forced_instance(fr.WIDE):
        wide = outputs()
    idle = [n for n in WIDE_KERNELS if not fr.LAUNCHES_WIDE[n]]
    if idle:
        raise AssertionError(f'the wide instance launched no {idle}')
    for what in narrow:
        worst = rel = 0.0
        for i, (a, r) in enumerate(zip(wide[what], narrow[what])):
            err, r_err, _ = hold(f'{env} {what} output {i}, wide instance '
                                 'vs narrow', a, r, STEP_TOL)
            worst, rel = max(worst, err), max(rel, r_err)
        log(f'[{tag}] {env} {what} (B={GRID_B if what == "grid" else MAIN_B})'
            f': the wide instance vs the narrow one on the same inputs, max '
            f'abs diff {worst:.3e} over {len(narrow[what])} outputs (worst '
            f'{rel:.3e} of an output\'s max|.|, tolerance {STEP_TOL:.0e}) ok')


def vg_split(env, lim):
    """Row 5's own time split at B = MAIN_B on ``env``'s shapes through the
    instance ``lim``, in ms per launch (``time_split``)."""
    _, _, _, pp, _, args, (dyn, pol, w_t) = rollout_problem(MAIN_B, 7,
                                                            env=env)
    x0, dyn_params, stats, dyn_noise, pol_noise, z_mm, z_rr, eps = args
    with forced_instance(lim):
        k = fr.RolloutKernel(dyn, pol, MAIN_T, w_t, True, True, True, True,
                             MAIN_B, x0.device)
        sk = k.bind(pp, x0, dyn_params, stats, dyn_noise, pol_noise, z_mm,
                    z_rr, eps)
        return time_split(k, lambda: k.value_and_grad(sk))


def phase_wide_kernels(env_rows, card):
    """Phase 2w: the wide instance of rows 3-9 (D <= 16, U <= 8, a tip of up
    to 16 rows) against the plain versions (``check_step``,
    ``check_rollout``, ``check_grid``: ``hold`` and ``hold_rows``) at
    ``WIDE_ENVS``' shapes, the JAX benchmark's (D = 5, U = 1, a tip of 5
    rows) and D = 16, U = 8, rows 3-7 at B = MAIN_B and 8-9 at GRID_B;
    grouped MM at D = 16 (``WIDE_GROUPS``, against the plain version in
    float64); a mixture head of WIDE_MIXTURE_K = 8 components at D = 16
    (a head of 265; rows 8-9 at ``grid_batch``, the 480 particles an H100
    holds at once), its times and bounds beside the diagonal head's; the
    wide instance on rendezvous's D = 8, U = 4 inputs against
    the narrow instance's outputs (``wide_against_narrow``). Then each wide
    row's time, bound and plain time beside the narrow instance's at D = 8
    (rendezvous, phase 2b's ``env_rows``) with the card's name and power
    limit (``card``), and row 5's time split at D = 8 in both instances and
    at D = 16: its moment-matching parts per step are the factor's and the
    adjoint's cost. Returns the D = 16 rows for the kernels line, keyed by
    the wide kernels' names."""
    worst = {n: 0.0 for n in WIDE_KERNELS}

    def note(here):
        for n, e in here.items():
            worst[n + '_wide'] = max(worst[n + '_wide'], e)

    for env in WIDE_ENVS:
        dyn, pol, D, U = env_models(env)
        if fr.kernel_instance(dyn, pol) is not fr.WIDE:
            raise AssertionError(f'{env} (D={D}, U={U}) does not take the '
                                 'wide instance')
        note(check_step(MAIN_B, env, 'phase 2w'))
        for mean_only in (True, False):
            note(check_rollout(MAIN_B, mean_only, env, 'phase 2w'))
        note(check_grid(GRID_B, True, env, 'phase 2w'))
    env, (g_main, g_grid) = WIDE_ENVS[-1], WIDE_GROUPS
    note(check_step(MAIN_B, env, 'phase 2w', groups=g_main))
    note(check_rollout(MAIN_B, False, env, 'phase 2w', groups=g_main))
    note(check_grid(GRID_B, True, env, 'phase 2w', groups=g_grid))
    Km, Bm = WIDE_MIXTURE_K, grid_batch(env, WIDE_MIXTURE_K)
    note(check_step(MAIN_B, env, 'phase 2w', components=Km))
    note(check_rollout(MAIN_B, False, env, 'phase 2w', components=Km))
    note(check_grid(Bm, True, env, 'phase 2w', components=Km))
    wide_against_narrow(WIDE_ON_NARROW)
    narrow = env_rows[WIDE_ON_NARROW]
    rows = {}
    for env in WIDE_ENVS:
        dyn, _, D, U = env_models(env)
        steps, plans = step_timings(MAIN_B, env)
        log(f'[phase 2w] {env} launch plans: step B={MAIN_B} {plans}; '
            f'rollout B={MAIN_B} {k_plan(MAIN_B, env)}; grid B={GRID_B} '
            f'{k_plan(GRID_B, env)}')
        times = {**steps, **rollout_timings(env, False),
                 **grid_timings(GRID_B, env=env)[0]}
        for name, v in times.items():
            B = GRID_B if name.startswith('fused_grid') else MAIN_B
            n8 = narrow[name]
            log(f'[phase 2w] {name} B={B}: {env} (D={D}, U={U}, a tip of {D} '
                f'rows) wide instance {v["ms"]:.4f} ms beside the narrow '
                f'instance at D=8 ({WIDE_ON_NARROW}, U=4) {n8["ms"]:.4f} ms; '
                f'plain {v["plain_ms"]:.4f} ms (D=8 {n8["plain_ms"]:.4f}); '
                f'bound {v["bound_ms"]:.6f} ms ({v["bound_by"]}; D=8 '
                f'{n8["bound_ms"]:.6f}); {card}')
        rows = {n + '_wide': v for n, v in times.items()}
    dyn, pol, D, U = env_models(env, components=Km)
    steps, plans = step_timings(MAIN_B, env, components=Km)
    log(f'[phase 2w] {env} mixture K={Km} launch plans: step B={MAIN_B} '
        f'{plans}; rollout B={MAIN_B} {k_plan(MAIN_B, env, components=Km)}; '
        f'grid B={Bm} {k_plan(Bm, env, components=Km)}; the card holds '
        f'{fr.rollout_capacity(dyn, pol, "cuda")} particles of the '
        'whole-rollout kernel at once')
    times = {**steps, **rollout_timings(env, False, components=Km),
             **grid_timings(Bm, env=env, components=Km)[0]}
    for name, v in times.items():
        grid = name.startswith('fused_grid')
        B, diag = (Bm if grid else MAIN_B), rows[name + '_wide']
        log(f'[phase 2w] {name} B={B}: {env} (D={D}, U={U}) mixture K={Km} '
            f'wide instance {v["ms"]:.4f} ms beside the diagonal head '
            f'{diag["ms"]:.4f} ms (B={GRID_B if grid else MAIN_B}); '
            f'plain {v["plain_ms"]:.4f} ms (diagonal '
            f'{diag["plain_ms"]:.4f}); bound {v["bound_ms"]:.6f} ms '
            f'({v["bound_by"]}; diagonal {diag["bound_ms"]:.6f}); {card}')
    for name, v in rows.items():
        v['max_abs_err'] = worst[name]
    cases = ((WIDE_ON_NARROW, fr.NARROW), (WIDE_ON_NARROW, fr.WIDE),
             (WIDE_ENVS[-1], fr.WIDE))
    for env, lim in cases:
        parts = vg_split(env, lim)
        D = env_models(env)[2]
        log_split(f'{env} (D={D}) {lim.name} instance fused_rollout_vg '
                  f'B={MAIN_B}', parts)
        log(f'[phase 2w] {env} D={D}, {lim.name} instance: moment matching '
            f'{1e3 * parts[2] / MAIN_T:.2f} us a step forward (moments, '
            f'merge, factor, resample) and {1e3 * parts[4] / MAIN_T:.2f} us '
            f'a step backward (sums, adjoint) in row 5 at B={MAIN_B} '
            f'(CTA 0\'s clock); {card}')
    return rows


def wide_setup(env='Bench16', seed=SEED):
    """Phase 5w's models (the JAX benchmark's at ``env``'s D, U), seeded
    parameters, stats fit to ``stats_data``, an x0 pool of 40 states
    (``env_states``) and the initial-state noise, as ``main_path_setup``
    returns them (no env runs at these shapes)."""
    dyn, pol, D, U = env_models(env)
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dyn_params = dyn.init(gen, device='cuda')
    pol_params = tree_map(lambda p: p.requires_grad_(True),
                          pol.init(gen, device='cuda'))
    dyn_stats = dyn.fit_stats(*map(t, stats_data(env, rng)))
    pool = env_states(env, rng, 40).astype(np.float32)
    return (dyn, pol, dyn_params, pol_params, dyn_stats, t(pool),
            1e-2 * pool.std(0))


def phase_wide_path(card):
    """Phase 5w: ``mc_pilco`` on the JAX benchmark's workload at D = 16,
    U = 8 (``wide_setup``), where the gate names ``'full'`` in the wide
    instance: WIDE_ITERS iterations with one ``fused_rollout_vg_wide``
    launch each and nothing else; WIDE_ROUTE_ITERS more held against the
    same iterations on the ``utils.rollout`` route (each iteration's loss,
    and the params after them by ``hold_lr``); one iteration's loss and
    grads against the plain path (``compare_paths``); then the step, loss
    and grid tiers' loops (``phase_loop``, WIDE_LOOP_ITERS each), whose
    launches are the other wide kernels'. Returns {kernel: launches} of the
    run that carries each wide kernel."""
    T, B = MAIN_T, MAIN_B
    setup = wide_setup()
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True)
    opt = make_mc_pilco_fn(dyn, pol, cfg, 'cuda')
    lim = fr.kernel_instance(dyn, pol)
    if lim is not fr.WIDE or opt.tier('cuda') != 'full':
        raise AssertionError(f'the gate names {opt.tier("cuda")!r} in the '
                             f'{getattr(lim, "name", None)} instance for the '
                             "benchmark at D=16, U=8; expected 'full', wide")

    def run(iters, fused_rollout, pool=x0_pool):
        stamps = []
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                         pol_params)
        params, _, metrics, n = mc_pilco(
            pool, dyn, pol, T, dyn_params, dyn_stats, start,
            opt_iters=iters, mm_states=True, mm_rewards=True,
            init_state_noise=init_noise, n_particles=B, seed=SEED, chunk=1,
            on_iteration=lambda done, m: stamps.append(time.perf_counter()),
            fused_rollout=fused_rollout)
        torch.cuda.synchronize()
        if n != iters:
            raise AssertionError(f'{n} steps for {iters} iterations')
        return params, metrics, counts(), t0, stamps

    _, metrics, launches, t0, stamps = run(WIDE_ITERS, None)
    report('phase 5w', "mc_pilco on the JAX benchmark's workload at D=16, "
           'U=8 (the wide instance)', WIDE_ITERS, t0, stamps,
           metrics['loss'], metrics['mean_return'], launches,
           expect(fused_rollout_vg_wide=WIDE_ITERS), T, B, 'Bench16')
    log(f'[phase 5w] tier {opt.tier("cuda")}, {lim.name} instance; '
        f'{ITER_MS["phase 5w"]:.3f} ms an iteration beside phase 5\'s '
        f'{ITER_MS.get("phase 5", float("nan")):.3f} (Cartpole, D=5; host '
        f'clock, this call); {card}')
    pk, mk = run(WIDE_ROUTE_ITERS, None)[:2]
    pr, mr, route = run(WIDE_ROUTE_ITERS, False)[:3]
    pm, mm_ = run(WIDE_ROUTE_ITERS, False, x0_pool * (1 + 1e-6))[:2]
    if any(route[n] for n in WIDE_KERNELS):
        raise AssertionError(f'the utils.rollout route launched {route}')
    for i, (lk, lr_, lm) in enumerate(zip(mk['loss'], mr['loss'],
                                         mm_['loss'])):
        hold(f'phase 5w iteration {i} loss', torch.tensor([lk]),
             torch.tensor([lr_]), 1e-3, torch.tensor([lm]))
    worst = hold_lr('phase 5w params', flat(pk), flat(pr), flat(pm),
                    WIDE_ROUTE_ITERS, WIDE_LR, tag='phase 5w')
    log(f'[phase 5w] {WIDE_ROUTE_ITERS} iterations, kernel vs utils.rollout '
        f'route: losses {np.asarray(mk["loss"])} vs {np.asarray(mr["loss"])}'
        f'; params within {worst:.3e} lr a step (at most 2) ok')
    compare_paths(setup, lambda p, x0, noise, *step: loss_and_grads(
        opt, p, x0, dyn_params, dyn_stats, noise, *step), 'phase 5w', SEED,
        T, B)
    n = WIDE_LOOP_ITERS
    runs = {'fused_rollout_vg_wide': launches}
    for tier, kernels in (('step', ('fused_step_fwd_wide',
                                    'fused_step_bwd_wide')),
                          ('loss', ('fused_rollout_fwd_wide',
                                    'fused_rollout_bwd_wide')),
                          ('grid', ('fused_grid_fwd_wide',
                                    'fused_grid_bwd_wide'))):
        per = T * n if tier == 'step' else n
        got = phase_loop(n, tier, f'phase 5w {tier}',
                         expect(**{k: per for k in kernels}), setup=setup,
                         env='Bench16')
        runs.update({k: got for k in kernels})
    return runs


def phase_wide_value_path(card):
    """Phase 7w: ``mc_pilco`` on JAX bench.py's value variant
    (``mc_pilco_none_B100_value``: its models at D = 5, U = 1, a tip of 5
    rows, B = 100, T = 15, no MM; the with-value driver's critic, H = 15)
    at full width, where the gate names ``'full'`` in the wide instance:
    ``phase_value_path`` for WIDE_VALUE_ITERS iterations, one
    ``fused_rollout_vg`` launch of the wide critic instance each (counted
    as ``fused_rollout_vg_wide``) and nothing else, v_loss
    falling, the ms an iteration on ``'full'`` and forced to ``'grid'`` in
    turns, one iteration of each tier against the plain path (the refit
    critic's params by the lr rule); then WIDE_VALUE_LOSS_ITERS iterations
    of ``MCPILCO.loss`` + autograd with the critic (one launch each of the
    wide critic instances of rows 3 and 4, counted as
    ``fused_rollout_fwd_wide`` and ``_bwd_wide``, and nothing else). Returns
    {kernel: launches} of the run that carries each wide critic kernel."""
    T, B = MAIN_T, MAIN_B
    setup = wide_setup('Bench5')
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    if fr.kernel_instance(dyn, pol) is not fr.WIDE:
        raise AssertionError('the benchmark\'s models do not take the wide '
                             'instance')
    launches, opts, (V, state, vstats) = phase_value_path(
        WIDE_VALUE_ITERS, SEED, T, B, 'phase 7w', setup=setup, mm=False,
        vg='fused_rollout_vg_wide', lr_rule=True, env='Bench5')
    log(f'[phase 7w] {ITER_MS["phase 7w"]:.3f} ms an iteration on tier full '
        f'(the wide instance) beside phase 7\'s {ITER_MS["phase 7"]:.3f} '
        f'(Cartpole B={GRID_B}, MM; host clock, this call); {card}')
    opt = opts['full']
    noise = opt.prepare_noise(opt.sample_noise(
        seeded_generator('cuda', SEED, 0), x0_pool.shape[-1], 'cuda'), 'cuda')
    init = torch.tensor(init_noise, device='cuda')
    carry = (state['params'], state['target'], state['opt_state'])
    params = [p.requires_grad_(True) for p in tree_leaves(pol_params)]
    n = WIDE_VALUE_LOSS_ITERS
    reset_counts()
    for i in range(n):
        x0 = opt.sample_x0(x0_pool, seeded_generator('cuda', SEED, i), init)
        loss, _, aux = opt.loss(pol_params, x0, dyn_params, dyn_stats, noise,
                                carry, vstats)
        grads = torch.autograd.grad(loss, params)
        carry = aux[:3]
        if not (torch.isfinite(loss) and torch.isfinite(aux[3])
                and all(torch.isfinite(g).all() for g in grads)):
            raise AssertionError('non-finite loss, v_loss or grads on the '
                                 'phase 7w loss route')
    torch.cuda.synchronize()
    loss_launches = counts()
    want = expect(fused_rollout_fwd_wide=n, fused_rollout_bwd_wide=n)
    if loss_launches != want:
        raise AssertionError(f'launches {loss_launches} on the phase 7w loss '
                             f'route, expected {want}')
    log(f'[phase 7w] {n} iterations of MCPILCO.loss + autograd with the '
        f'critic: launches {loss_launches} ok')
    return {'fused_rollout_vg_wide_critic': launches,
            'fused_rollout_fwd_wide_critic': loss_launches,
            'fused_rollout_bwd_wide_critic': loss_launches}


# ---------------------------------------------------------------------------
# phase 7o: the critic's model options in rows 3-5's refit
# ---------------------------------------------------------------------------


def phase_critic_options(critic_rows, card, iters=VALUE_ITERS):
    """Phase 7o: the critic with each set of CRITIC_OPTION_SETS (B angle
    embedding, concrete input dropout and a swish output; C spectral norm of
    every layer; both) in rows 3-5's refit: ``check_critic`` at B = 100
    without MM for each set and at B = 1000 with MM for both, both sets'
    times at phase 2c's cases beside phase 2c's critic without them
    (``critic_rows``), then phase 7's value path with both
    (``phase_value_path``: the gate names ``'full'``, one
    ``fused_rollout_vg`` an iteration and nothing else, v_loss falling, the
    tiers' ms and one iteration of each against the plain path). Returns the
    value path's launch counts."""
    for opts in CRITIC_OPTION_SETS.values():
        check_critic(MAIN_B, False, tag='phase 7o', coptions=opts)
    check_critic(GRID_B, True, tag='phase 7o', coptions=CRITIC_OPTIONS)
    for B, mm in CRITIC_CASES:
        tt = critic_timings(B, mm, coptions=CRITIC_OPTIONS)
        for name, v in tt.items():
            log(f'[phase 7o] {name} with the critic\'s options '
                f'{"+".join(CRITIC_OPTIONS)} B={B} MM {"on" if mm else "off"}'
                f': kernel {v["ms"]:.4f} ms beside the critic without them '
                f'{critic_rows[(B, mm)][name]["ms"]:.4f} ms; plain '
                f'{v["plain_ms"]:.4f} ms; bound {v["bound_ms"]:.6f} ms '
                f'({v["bound_by"]}); {card}')
    return phase_value_path(iters, tag='phase 7o', coptions=CRITIC_OPTIONS)[0]


# ---------------------------------------------------------------------------
# phases 3-7: the routes, the main path among them
# ---------------------------------------------------------------------------


def random_episode(env, steps, seed):
    """One episode of uniform random actions: (observations [steps+1, D],
    actions [steps, U]) as numpy."""
    rng = np.random.RandomState(seed)
    env.seed(seed)
    obs = [env.reset()]
    acts = []
    for _ in range(steps):
        u = rng.uniform(env.action_space.low, env.action_space.high)
        o, _, _, _ = env.step(u)
        obs.append(o)
        acts.append(np.asarray(u, np.float32))
    return np.stack(obs).astype(np.float32), np.stack(acts)


def build_models(D, U, max_u, reward_func, hidden=(200, 200),
                 nonlin='relu', components=0, options=()):
    """The Deep-PILCO examples' default models (by default [200, 200] relu
    MLPs), concrete dropout 0.1 on the dynamics, Bernoulli 0.1 on the
    policy; without ``reward_func`` the dynamics learn the reward (a head of
    D + 1 outputs); with ``components`` K the dynamics head is a mixture of
    K Gaussians (``--dyn_components K``). ``options`` of both MLPs: 'sn'
    spectral norm of every layer (sn_max_K 1: a layer's norm at most 1,
    which keeps the policy's tanh off its flat tails), 'drop' input dropout
    (Bernoulli 0.1 on the policy, concrete 0.1 on the dynamics) and output
    nonlinearities (tanh on the policy, swish on the dynamics), 'ang' angle
    embedding inside the models (the policy's state dim 0, the dynamics'
    state dim 2 and its last action dim), 'bf16' the fused MLP kernel with
    bf16 operands (``fused=True``); the policy's head 'tanh' a
    ``TanhSquashedDensity`` over the Gaussian (its own bound HEAD_MAX_U
    inside the policy's), 'cat' a ``CategoricalDensity`` of U actions."""
    E = D if reward_func is not None else D + 1
    head = (GaussianMixtureDensity(E, components) if components
            else DiagGaussianDensity(E))
    pkw, dkw = {}, {}
    if 'sn' in options:
        for kw in (pkw, dkw):
            kw.update(spectral_norm=True, spectral_norm_output=True,
                      sn_max_K=1.0)
    if 'drop' in options:
        pkw.update(input_dropout=bdropout(0.1), output_nonlin='tanh')
        dkw.update(input_dropout=cdropout(0.1), output_nonlin='swish')
    if 'bf16' in options:
        for kw in (pkw, dkw):
            kw.update(fused=True, compute_dtype='bfloat16')
    pang, dang = ((0,), (2, D + U - 1)) if 'ang' in options else ((), ())
    dyn = DynamicsModel(
        Regressor(MLPSpec(D + U + len(dang), head.n_inputs, hidden,
                          dropout=cdropout(0.1), nonlin=nonlin, **dkw),
                  head, angle_dims=dang),
        reward_func=reward_func)
    phead = DiagGaussianDensity(U)
    if 'tanh' in options:
        phead = TanhSquashedDensity(phead, HEAD_MAX_U)
    elif 'cat' in options:
        phead = CategoricalDensity(U)
    pol = Policy(MLPSpec(D + len(pang), phead.n_inputs, hidden,
                         dropout=bdropout(0.1), nonlin=nonlin, **pkw),
                 phead, angle_dims=pang, max_u=tuple(max_u))
    return dyn, pol


def grad_leaves(tree):
    """The leaves of a params tree that take a gradient, in
    ``tree_leaves``' order: all but spectral norm's ``sn_u``, the power
    iteration's vector."""
    return [p for name, p in flat_leaves(tree) if not name.endswith('/sn_u')]


def loss_and_grads(opt, pol_params, x0, dyn_params, dyn_stats, noise,
                   step_noise=None):
    """One iteration's loss and policy grads through ``opt.loss`` (on the
    whole-rollout tier, its forward and backward kernels) on CUDA; without
    PEGASUS with the per-step density noise ``step_noise``, and with
    priorities the grads of a zero action perturbation after the policy's
    (what the priority scores are made of)."""
    params = tree_leaves(pol_params)
    eps = None
    if opt.cfg.with_priorities:
        eps = torch.zeros((opt.cfg.steps, opt.B, len(opt.pol.max_u)),
                          dtype=x0.dtype, device=x0.device,
                          requires_grad=True)
        params = params + [eps]
    loss, _ = opt.loss(pol_params, x0, dyn_params, dyn_stats,
                       opt.prepare_noise(noise, 'cuda'), action_eps=eps,
                       step_noise=step_noise)
    grads = torch.autograd.grad(loss, params, allow_unused=True)  # sn_u
    return float(loss.detach()), torch.cat([
        (torch.zeros_like(p) if g is None else g).reshape(-1)
        for p, g in zip(params, grads)])


def compare_paths(setup, kernel_path, tag, seed=SEED, T=MAIN_T, B=MAIN_B,
                  groups=None, options=None, plain_kernels=False, f64=False):
    """One iteration's loss and policy grads on the same initial states and
    noise, through ``kernel_path(pol_params, x0, noise as drawn) -> (loss,
    flat grads)`` and through the plain path (``utils.rollout`` on unfused
    MLPs; MM per group of B / groups with ``groups``; ``options``: more
    fields of the ``MCPILCOConfig``; without PEGASUS both paths take the
    same per-step density noise, ``kernel_path``'s fourth argument; with
    ``plain_kernels`` the plain path is the same models' route on the fused
    MLP's plain version, ``plain_fused_mlp``). The tolerance is the
    plain path's own sensitivity to x0 moved by 1e-6 relative (times 3), at
    least 1e-4 relative on the loss and 1e-3 of max|grad| on the grads.
    Grouped or with ``f64`` (a mixture head), the plain path runs in
    float64 (``float64`` says why); grouped, the
    float32 plain path's largest distance from it at x0 and at x0 moved by
    +-1e-6 relative (times 3) is one more floor of the tolerance: where the
    rewards lie far in the exp-quadratic's tail (a loss of 1e-12 after
    phase 5g's iterations) no float32 rollout holds the loss to 1e-4 of
    itself, and the float32 rounding there is as random as a draw."""
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True, mm_groups=groups,
                        fused_rollout=False, **(options or {}))
    if plain_kernels:
        opt_p = make_mc_pilco_fn(dyn, pol, cfg, 'cuda')
        plain_path = plain_fused_mlp
    else:
        opt_p = make_mc_pilco_fn(fr.unfused(dyn), fr.unfused(pol), cfg,
                                 'cuda')
        plain_path = contextlib.nullcontext
    D = x0_pool.shape[-1]
    noise = opt_p.sample_noise(seeded_generator('cuda', seed, 1), D, 'cuda')
    x0 = opt_p.sample_x0(x0_pool, seeded_generator('cuda', seed, 2),
                         torch.tensor(init_noise, device='cuda'))
    step = opt_p.sample_step_noise(seeded_generator('cuda', seed, 3), 'cuda')
    extra = () if step is None else (step,)
    lk, gk = kernel_path(pol_params, x0, noise, *extra)
    cast = in_float64 if groups or f64 else (lambda x: x)
    with plain_path():
        lp, gp = loss_and_grads(opt_p, *cast((pol_params, x0, dyn_params,
                                              dyn_stats, noise, *extra)))
        ls, gs = loss_and_grads(opt_p, *cast((pol_params, x0 * (1 + 1e-6),
                                              dyn_params, dyn_stats, noise,
                                              *extra)))
    l_tol = max(1e-4 * abs(lp), 3 * abs(ls - lp))
    g_tol = max(1e-3 * float(gp.abs().max()), 3 * float((gs - gp).abs().max()))
    f32 = ''
    if groups:
        dl = dg = 0.0
        for scale, (l64, g64) in ((1.0, (lp, gp)), (1 + 1e-6, (ls, gs)),
                                  (1 - 1e-6, (None, None))):
            if l64 is None:
                l64, g64 = loss_and_grads(opt_p, *cast((
                    pol_params, x0 * scale, dyn_params, dyn_stats, noise,
                    *extra)))
            l32, g32 = loss_and_grads(opt_p, pol_params, x0 * scale,
                                      dyn_params, dyn_stats, noise, *extra)
            dl = max(dl, abs(l32 - l64))
            dg = max(dg, float((g32 - g64).abs().max()))
        l_tol, g_tol = max(l_tol, 3 * dl), max(g_tol, 3 * dg)
        f32 = (f'; the float32 plain path from the float64 one, at most: '
               f'loss {dl:.3e}, grads {dg:.3e}')
    l_err, g_err = abs(lk - lp), float((gk - gp).abs().max())
    log(f'[{tag}] one iteration, kernel vs plain path: loss {lk:.7g} vs '
        f'{lp:.7g} (err {l_err:.3e}, tolerance {l_tol:.3e}); grads max abs '
        f'err {g_err:.3e} (tolerance {g_tol:.3e}, max|grad| '
        f'{float(gp.abs().max()):.3e}){f32}')
    if not (np.isfinite(lk) and torch.isfinite(gk).all()):
        raise AssertionError('non-finite loss or grads on the kernel path')
    if l_err > l_tol or g_err > g_tol:
        raise AssertionError('kernel path and plain path disagree')


def main_path_setup(seed=SEED, components=0, model_options=()):
    """The main path's models, parameters, stats, x0 pool and initial-state
    noise: Cartpole, one 40-step random-action episode, seeded weights
    (``components`` K: a mixture dynamics head of K Gaussians;
    ``model_options``: ``build_models``' options)."""
    env = envs.make('Cartpole', device='cuda')
    obs, acts = random_episode(env, 40, seed)
    D, U = obs.shape[1], acts.shape[1]
    X = torch.tensor(np.concatenate([obs[:-1], acts], 1), device='cuda')
    Y = torch.tensor(obs[1:] - obs[:-1], device='cuda')
    x0_pool = torch.tensor(obs, device='cuda')
    dyn, pol = build_models(D, U, env.action_space.high, env.reward_func,
                            components=components, options=model_options)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dyn_params = dyn.init(gen, device='cuda')
    pol_params = pol.init(gen, device='cuda')
    dyn_stats = dyn.fit_stats(X, Y)
    init_noise = 1e-2 * obs.std(0)
    return dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise


def counts():
    return {**fm.LAUNCHES, **fm.LAUNCHES_BF16, **fr.LAUNCHES,
            **fr.LAUNCHES_WIDE}


@contextlib.contextmanager
def plain_fused_mlp():
    """Within it, the models' fused-MLP calls run the kernels' plain
    version (``fm.fused_mlp_plain``) on CUDA tensors too: the reference of
    a route through the bf16 instances, whose operands the unfused path
    does not round alike (it narrows the activations between layers)."""
    kernel = fm.fused_mlp
    fm.fused_mlp = fm.fused_mlp_plain
    try:
        yield
    finally:
        fm.fused_mlp = kernel


def reset_counts():
    fm.reset_launch_counts()
    fr.reset_launch_counts()


def expect(**nonzero):
    """Launch counts of a run: ``nonzero`` and 0 for every other kernel."""
    return {n: nonzero.get(n, 0) for n in counts()}


def report(tag, what, iters, t0, stamps, losses, rets, launches, want,
           T=MAIN_T, B=MAIN_B, env='Cartpole', mm=True):
    """Check a run's losses and launch counts and log its iteration time,
    which ``ITER_MS[tag]`` keeps."""
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(rets))):
        raise AssertionError(f'non-finite loss or mean_return on the {tag} '
                             'run')
    if len(losses) != iters:
        raise AssertionError(f'{len(losses)} losses for {iters} iterations')
    if launches != want:
        raise AssertionError(f'launches {launches} on the {tag} run, '
                             f'expected {want}')
    ms_iter = float(np.median(np.diff([t0] + stamps)) * 1e3)
    log(f'[{tag}] {what}, {env} B={B} T={T} [200,200] '
        f'{"mm_states mm_rewards" if mm else "no MM"}: {iters} iterations '
        f'in {stamps[-1] - t0:.3f} s; '
        f'launches {launches} (expected {want})')
    log(f'[{tag}] mean_return first {rets[0]:.6f} last {rets[-1]:.6f}; '
        f'loss first {losses[0]:.6f} last {losses[-1]:.6f}')
    ITER_MS[tag] = ms_iter
    LOSSES[tag] = np.asarray(losses)
    log(f'[{tag}] median {ms_iter:.3f} ms per iteration (host clock, '
        f'synchronised each iteration) = '
        f'{B * T / (ms_iter / 1e3):.1f} particle-steps/s on '
        f'{torch.cuda.get_device_name(0)}')


def phase_mc_pilco(iters, fused_rollout, tag, want, tier, seed=SEED,
                   T=MAIN_T, B=MAIN_B, groups=None, components=0,
                   options=None, model_options=()):
    """``mc_pilco`` for ``iters`` iterations by the route ``fused_rollout``
    picks (MM per group of B / groups with ``groups``; a mixture dynamics
    head of ``components``; ``options``: more ``MCPILCOConfig`` fields,
    given to ``mc_pilco`` by its names; ``model_options``: the models'
    options, ``build_models``), whose tier the gate must name ``tier``
    (None: its reason is logged), then one iteration through
    ``MCPILCO.loss`` on that route against the plain path (with bf16
    fused MLPs, the same path on the kernels' plain version). Returns the
    launch counts of the run: every count is set to 0 just before it and
    read just after."""
    options = options or {}
    setup = main_path_setup(seed, components, model_options)
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True, mm_groups=groups,
                        fused_rollout=fused_rollout, **options)
    opt = make_mc_pilco_fn(dyn, pol, cfg, 'cuda')
    if opt.tier('cuda') != tier:
        raise AssertionError(f'the gate names {opt.tier("cuda")!r} for B={B} '
                             f'on this card, expected {tier!r}')
    why = fr.refuses(cfg, dyn, pol)
    if why is not None:
        log(f'[{tag}] the gate takes no fused tier: {why}')
    loop_kw = {('prioritized_replay' if k == 'with_priorities' else k): v
               for k, v in options.items()}
    stamps = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pol_params, _, metrics, n_steps = mc_pilco(
        x0_pool, dyn, pol, T, dyn_params, dyn_stats, pol_params,
        opt_iters=iters, mm_states=True, mm_rewards=True, mm_groups=groups,
        init_state_noise=init_noise, n_particles=B, seed=seed, chunk=1,
        on_iteration=lambda done, m: stamps.append(time.perf_counter()),
        fused_rollout=fused_rollout, **loop_kw)
    torch.cuda.synchronize()
    launches = counts()
    if n_steps != iters:
        raise AssertionError(f'{n_steps} steps for {iters} iterations')
    report(tag, f'mc_pilco fused_rollout={fused_rollout}'
           + (f' mm_groups={groups}' if groups else '')
           + (f' dyn_components={components}' if components else '')
           + (f' options {"+".join(model_options)}' if model_options else '')
           + ''.join(f' {k}={v}' for k, v in loop_kw.items()),
           iters, t0, stamps,
           metrics['loss'], metrics['mean_return'], launches, want, T, B)
    if 'priority_scores' in metrics:
        scores = metrics['priority_scores']
        log(f'[{tag}] priority scores {scores.shape}, mean {scores.mean():.6e}'
            f', max {scores.max():.6e}')
        if not (np.all(np.isfinite(scores)) and scores.max() > 0):
            raise AssertionError('the priority scores are not finite and '
                                 'positive')
    log(f'[{tag}] tier {opt.tier("cuda")}')
    compare_paths((dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool,
                   init_noise),
                  lambda p, x0, noise, *step: loss_and_grads(
                      opt, p, x0, dyn_params, dyn_stats, noise, *step),
                  tag, seed, T, B, groups, options, 'bf16' in model_options,
                  f64=bool(components))
    return launches


def phase_bf16_fit(card):
    """Phase 3h's fit: BF16_FIT_STEPS ``train_regressor`` steps
    (``make_train_fn``, Adam 1e-3, minibatches of 100) of the main path's
    dynamics model with ``fused=True`` bf16 MLPs on the main path's
    40-step episode: one bf16 forward and backward launch a step and none
    else, finite losses, E_lml rising (the mean of the last 10 steps above
    the first 10's). Returns the launch counts."""
    setup = main_path_setup(SEED, model_options=('bf16',))
    dyn, dyn_params = setup[0], setup[2]
    env = envs.make('Cartpole', device='cuda')
    obs, acts = random_episode(env, 40, SEED)
    X = torch.tensor(np.concatenate([obs[:-1], acts], 1), device='cuda')
    Y = torch.tensor(obs[1:] - obs[:-1], device='cuda')
    Xn, Yn = normalize_dataset(dyn.fit_stats(X, Y), X, Y)
    train = make_train_fn(dyn.regressor, Adam(1e-3), 100)
    gen = seeded_generator('cuda', SEED, 9)
    state = Adam(1e-3).init(dyn_params)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, metrics, _ = train(dyn_params, state, Xn, Yn, gen, BF16_FIT_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / BF16_FIT_STEPS * 1e3
    launches = counts()
    want = expect(fused_mlp_fwd_bf16=BF16_FIT_STEPS,
                  fused_mlp_bwd_bf16=BF16_FIT_STEPS)
    lml, loss = np.asarray(metrics['E_lml']), np.asarray(metrics['loss'])
    if launches != want:
        raise AssertionError(f'launches {launches} on the bf16 fit, '
                             f'expected {want}')
    if not (np.all(np.isfinite(loss)) and np.all(np.isfinite(lml))):
        raise AssertionError('non-finite loss or E_lml on the bf16 fit')
    if not lml[-10:].mean() > lml[:10].mean():
        raise AssertionError('E_lml did not rise on the bf16 fit: '
                             f'{lml[:10].mean():.4f} -> '
                             f'{lml[-10:].mean():.4f}')
    log(f'[phase 3h] train_regressor, dynamics [200,200] fused=True bf16, '
        f'{BF16_FIT_STEPS} steps of 100 rows: E_lml {lml[:10].mean():.4f} '
        f'(first 10) -> {lml[-10:].mean():.4f} (last 10), loss '
        f'{loss[0]:.4f} -> {loss[-1]:.4f}; launches {launches}; {ms:.3f} ms '
        f'a step (host clock); {card}')
    return launches


def sum_tree_timings(reps=50):
    """Host times of the prioritized replay's native sum tree at 2^20
    leaves (``mc_pilco(prioritized_replay=True)``): filling it with the
    pool's 2 B rows and renormalizing once, then per chunk the draw of B
    initial states and the priority update with renormalization
    (``mc_pilco.update_priorities``), medians of ``reps``."""
    tree_t0 = time.perf_counter()
    tree = native.make_sum_tree(2 ** 20)
    rows = np.random.RandomState(SEED).randn(2 * MAIN_B, 5)
    for row in rows:
        tree.append(row, tree.max_p)
    tree.renormalize()
    fill = time.perf_counter() - tree_t0
    scores = np.random.RandomState(SEED + 1).rand(MAIN_B) * 1e-3
    draws, updates = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, idxs, _ = tree.sample(MAIN_B)
        t1 = time.perf_counter()
        update_priorities(tree, idxs, scores, 0.6, 1e-8)
        updates.append(time.perf_counter() - t1)
        draws.append(t1 - t0)
    log(f'[phase 3v] native sum tree, 2^20 leaves (host clock): filled with '
        f'{2 * MAIN_B} rows and renormalized in {1e3 * fill:.3f} ms; a '
        f'chunk\'s draw of {MAIN_B} {1e3 * np.median(draws):.4f} ms, its '
        f'update and renormalization {1e3 * np.median(updates):.4f} ms '
        f'(medians of {reps}); {card_line()}')


# phase 3v: the options of the utils.rollout route, each as phase 3 runs:
# (name, MCPILCOConfig fields, particles)
VARIANT_ITERS = 10
VARIANTS = (('mix', dict(mm_method='mix'), MAIN_B),
            ('infer_noise_variables', dict(infer_noise_variables=True),
             MAIN_B),
            ('pegasus=False', dict(pegasus=False), MAIN_B),
            ('prioritized_replay', dict(with_priorities=True), MAIN_B),
            ('mix', dict(mm_method='mix'), GRID_B))


def phase_variants():
    """Phase 3v: phase 3's ``mc_pilco`` call (B = 100, T = 15, [200, 200],
    MM of states and rewards) for VARIANT_ITERS iterations with each of
    VARIANTS (``mix`` at B = 1000 auto-grouped into 4 groups of 250), the
    default ``fused_rollout``: the gate takes no fused tier (its reason
    logged), every MLP call goes through the fused-MLP kernels (launches
    exactly 2 T an iteration each way), one iteration held against the
    plain path on the same inputs, the ms an iteration beside phase 3's;
    then the native sum tree's host times at 2^20 leaves."""
    T = MAIN_T
    for name, options, B in VARIANTS:
        tag = f'phase 3v {name} B={B}'
        phase_mc_pilco(VARIANT_ITERS, None, tag, expect(
            fused_mlp_fwd=2 * T * VARIANT_ITERS,
            fused_mlp_bwd=2 * T * VARIANT_ITERS), None, B=B, options=options)
        log(f'[{tag}] {ITER_MS[tag]:.3f} ms an iteration on the '
            f'utils.rollout route beside phase 3\'s '
            f'{ITER_MS["phase 3"]:.3f} (host clock, this call); '
            f'{card_line()}')
    sum_tree_timings()


def phase_loop(iters, tier, tag, want, seed=SEED, T=MAIN_T, B=MAIN_B,
               setup=None, env='Cartpole'):
    """A loop of ``iters`` iterations (x0 draw, loss and grads, clip, Adam)
    on the main path's setup (or ``setup``, as ``main_path_setup`` returns
    it; ``env`` names it in the log), with the loss and grads of ``tier``:
    ``'step'``,
    ``make_fused_value_and_grad(mode='step')`` (the step kernels);
    ``'grid'``, the same with ``mode='grid'`` (the grid kernels);
    ``'loss'``, ``MCPILCO.loss`` on the whole-rollout tier and autograd
    (``fused_rollout_fwd`` and ``_bwd``). Returns the launch counts of the
    loop, set to 0 just before it."""
    setup = setup or main_path_setup(seed)
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True)
    opt = make_mc_pilco_fn(dyn, pol, cfg, 'cuda')
    if opt.tier('cuda') != 'full':
        raise AssertionError(f'the gate names {opt.tier("cuda")!r} for the '
                             'main configuration on this card')
    vg = fr.make_fused_value_and_grad(dyn, pol, T, opt.w_t, True, True, True,
                                      mode='grid' if tier == 'grid'
                                      else 'step')

    def loss_grads(p, x0, noise):
        if tier in ('step', 'grid'):
            loss, mret, grads, _ = vg(p, x0, dyn_params, dyn_stats, *noise)
            return loss, mret, tree_leaves(grads)
        loss, mret = opt.loss(p, x0, dyn_params, dyn_stats, noise)
        return loss, mret, torch.autograd.grad(loss, tree_leaves(p))

    params = [p.requires_grad_(True) for p in tree_leaves(pol_params)]
    adam = torch.optim.Adam(params, lr=1e-3)
    D = x0_pool.shape[-1]
    noise = opt.prepare_noise(opt.sample_noise(
        seeded_generator('cuda', seed, 0), D, 'cuda'), 'cuda')
    init = torch.tensor(init_noise, device='cuda')
    losses, rets, stamps = [], [], []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in range(iters):
        x0 = opt.sample_x0(x0_pool, seeded_generator('cuda', seed, n), init)
        loss, mret, grads = loss_grads(pol_params, x0, noise)
        for p, g in zip(params, clip_grad_norm(list(grads), 1.0)):
            p.grad = g
        adam.step()
        losses.append(loss.detach())
        rets.append(mret.detach())
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    launches = counts()
    report(tag, {'step': "make_fused_value_and_grad(mode='step')",
                 'grid': "make_fused_value_and_grad(mode='grid')",
                 'loss': 'MCPILCO.loss + autograd'}[tier] + ' + clip + Adam',
           iters, t0, stamps, torch.stack(losses).cpu().numpy(),
           torch.stack(rets).cpu().numpy(), launches, want, T, B, env)
    if tier == 'step':
        def kernel_path(p, x0, noise):
            loss, _, grads = loss_grads(p, x0, opt.prepare_noise(noise,
                                                                 'cuda'))
            return float(loss), torch.cat([g.reshape(-1) for g in grads])

        compare_paths(setup, kernel_path, tag, seed, T, B)
    return launches


def phase_grouped_paths(capacity):
    """Phases 5g and 4g: ``mc_pilco`` with MM per group. 5g: phase 5's
    configuration with ``mm_groups`` = GROUPS_MAIN on the whole-rollout tier
    (ITERS iterations, exactly one ``fused_rollout_vg`` launch each and
    nothing else), then GROUPED_ROUTE_ITERS iterations of the same
    configuration on the ``utils.rollout`` route (``fused_rollout=False``,
    the fused MLP 2 T times each way an iteration), the ms an iteration of
    each beside phase 5's. 4g: the step tier at the smallest multiple of 10
    particles beyond ``capacity`` (what the card holds of the whole-rollout
    kernel at once), groups of 10 (STEP_ROUTE_ITERS iterations, exactly T
    launches of each step kernel an iteration). Each run's loss held against
    the plain path (``compare_paths``, grouped)."""
    T, G = MAIN_T, GROUPS_MAIN
    phase_mc_pilco(ITERS, None, 'phase 5g', expect(fused_rollout_vg=ITERS),
                   'full', groups=G)
    phase_mc_pilco(GROUPED_ROUTE_ITERS, False, 'phase 5g route', expect(
        fused_mlp_fwd=2 * T * GROUPED_ROUTE_ITERS,
        fused_mlp_bwd=2 * T * GROUPED_ROUTE_ITERS), None, groups=G)
    log(f'[phase 5g] mm_groups={G}: {ITER_MS["phase 5g"]:.3f} ms an '
        f'iteration on the whole-rollout tier, '
        f'{ITER_MS["phase 5g route"]:.3f} on the utils.rollout route, '
        f'ungrouped {ITER_MS["phase 5"]:.3f} (phase 5), in this call')
    big = (capacity // 10 + 1) * 10
    log(f'[phase 4g] B={big} (beyond the {capacity} particles the card '
        f'holds of the whole-rollout kernel) in {big // 10} groups of 10 '
        'takes the step tier')
    phase_mc_pilco(STEP_ROUTE_ITERS, None, 'phase 4g', expect(
        fused_step_fwd=T * STEP_ROUTE_ITERS,
        fused_step_bwd=T * STEP_ROUTE_ITERS), 'step', B=big, groups=big // 10)


def critic_setup(D, seed=SEED, T=MAIN_T, options=()):
    """The Deep-PILCO with-value driver's default critic
    (``examples/deep_pilco_common.py`` ``build_critic``): ``critic_spec``'s
    MSE critic with H = T and uniform TD weights (and its ``options``).
    Returns (V, update, value_state, stats)."""
    V, update = critic_spec(D, H=T, discount=None, options=options)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 100)
    vp = V.init(gen, device='cuda')
    return (V, update, dict(params=vp, target=vp,
                            opt_state=update.optimizer.init(vp)),
            V.init_stats(device='cuda'))


def value_opts(setup, V, update, T=MAIN_T, B=GRID_B, mm=True):
    """``MCPILCO`` with the critic at B particles, states and rewards
    moment-matched (or, without ``mm``, neither): {'full': as the gate makes
    it (the whole-rollout tier, one ``fused_rollout_vg`` launch with the
    refit in it), 'grid': the same with its value-and-grad and loss forced
    to the grid tier (``mode='grid'``: the grid kernels, the refit on the
    fused MLP and the bootstrap between them), the tier of a critic the
    kernels refuse}."""
    dyn, pol = setup[:2]
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=mm, mm_rewards=mm)
    opts = {'full': make_mc_pilco_fn(dyn, pol, cfg, 'cuda', V, update),
            'grid': make_mc_pilco_fn(dyn, pol, cfg, 'cuda', V, update)}
    opt = opts['grid']
    args = (dyn, pol, T, opt.w_t, mm, mm, True)
    kw = dict(value_update=update, w_H=opt.w_H, mode='grid')
    opt.fused_vg = fr.make_fused_value_and_grad(*args, **kw)
    opt.fused_loss = fr.make_fused_loss(*args, **kw)
    return opts


def value_tier_times(setup, opts, state, vstats, n=30, seed=SEED):
    """Host ms of an ``MCPILCO.iteration`` with the critic (each ended by a
    synchronise, the median of n after 3 of warm-up) through each of
    ``value_opts``' two, in turns (full, grid, grid, full), each run on
    copies of the policy from the critic's ``state``. Returns {'full': ms,
    'grid': ms}, each the mean of its two runs."""
    _, _, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    opt = opts['grid']
    noise = opt.prepare_noise(opt.sample_noise(
        seeded_generator('cuda', seed, 0), x0_pool.shape[-1], 'cuda'), 'cuda')
    init = torch.tensor(init_noise, device='cuda')

    def run(o):
        p = tree_map(lambda v: v.detach().clone().requires_grad_(True),
                     pol_params)
        adam = torch.optim.Adam(tree_leaves(p), lr=1e-3)
        carry = (state['params'], state['target'], state['opt_state'])
        times = []
        for i in range(n + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry = o.iteration(p, adam, dyn_params, dyn_stats, x0_pool,
                                noise, seeded_generator('cuda', seed, i),
                                init, carry, vstats)[3]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times[3:])) * 1e3

    ms = {'full': [], 'grid': []}
    for tier in ('full', 'grid', 'grid', 'full'):
        ms[tier].append(run(opts[tier]))
    return {k: float(np.mean(v)) for k, v in ms.items()}


def compare_value_paths(setup, opt, V, state, vstats, seed=SEED, T=MAIN_T,
                        tier='full', tag='phase 7', mm=True, lr_rule=False):
    """One iteration with the critic on the same initial states and noise,
    through ``opt`` (on ``tier``: the whole-rollout tier, rows 3 and 4 with
    the refit, or forced to the grid tier, ``value_opts``) and through its
    plain path
    (``make_loss_plain`` with the value update: the per-step rollout, the
    rewards resampled step by step, on unfused MLPs, the critic unfused
    too): loss, mean_return, v_loss, the clipped policy grads and the refit
    critic's params. The ``utils.rollout`` route is not this path's plain
    version: it resamples the [T, B, 1] rewards in one call, whose jitter
    JAX's safe Cholesky chooses for all steps at once, so a step whose
    reward variance is ~1e-10 of the largest step's gets a larger jitter,
    which moves per-particle rewards (what the critic reads) and not their
    means. Tolerance: the plain path's own change under a 1e-6 relative move
    of x0 (times 3), at least 1e-4 relative on the three scalars, 1e-3 of
    max|grad| on the grads and 1e-3 of the refit's largest step on the
    critic's params, or with ``lr_rule`` the critic's params by the lr rule
    of one Adam step (``hold_lr``). ``mm``: as ``value_opts``."""
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    update_p = make_value_update_fn(fr.unfused(V), Adam(VALUE_LR), T,
                                    polyak=1.0, use_density=False)
    plain = fr.make_loss_plain(fr.unfused(dyn), fr.unfused(pol), T, opt.w_t,
                               mm, mm, True, value_update=update_p,
                               w_H=opt.w_H)
    noise = opt.prepare_noise(opt.sample_noise(
        seeded_generator('cuda', seed, 1), x0_pool.shape[-1], 'cuda'), 'cuda')
    x0 = opt.sample_x0(x0_pool, seeded_generator('cuda', seed, 2),
                       torch.tensor(init_noise, device='cuda'))
    carry = (state['params'], state['target'], state['opt_state'])
    params = [q.requires_grad_(True) for q in tree_leaves(pol_params)]
    before = torch.cat([v.reshape(-1) for v in tree_leaves(carry[0])])

    def run(loss_fn):
        loss, mret, aux = loss_fn()
        grads = clip_grad_norm(list(torch.autograd.grad(loss, params)), 1.0)
        return {'loss': loss.detach(), 'mean_return': mret.detach(),
                'v_loss': aux[3],
                'grads': torch.cat([g.reshape(-1) for g in grads]),
                'critic': torch.cat([v.reshape(-1)
                                     for v in tree_leaves(aux[0])])}

    def plain_at(x):
        return lambda: plain(pol_params, x, dyn_params, dyn_stats,
                             *noise[:4], extras=(*carry, vstats, noise[4]))

    got = run(lambda: opt.loss(pol_params, x0, dyn_params, dyn_stats, noise,
                               carry, vstats))
    ref, moved = run(plain_at(x0)), run(plain_at(x0 * (1 + 1e-6)))
    floor = {'loss': 1e-4 * float(ref['loss'].abs()),
             'mean_return': 1e-4 * float(ref['mean_return'].abs()),
             'v_loss': 1e-4 * float(ref['v_loss'].abs()),
             'grads': 1e-3 * float(ref['grads'].abs().max()),
             'critic': 1e-3 * float((ref['critic'] - before).abs().max())}
    bad = []
    if lr_rule:
        worst = hold_lr(f'{tag} tier {tier} refit critic params',
                        got['critic'], ref['critic'], moved['critic'], 1,
                        VALUE_LR, tag=tag)
        log(f'[{tag}] one iteration on tier {tier}, kernel vs plain path: '
            f'the refit critic\'s params within {worst:.3e} lr (at most 2) '
            'ok')
        del floor['critic']
    for k, f in floor.items():
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f'non-finite {k} on the kernel path')
        err = float((got[k] - ref[k]).abs().max())
        tol = max(f, 3 * float((moved[k] - ref[k]).abs().max()))
        log(f'[{tag}] one iteration on tier {tier}, kernel vs plain path: '
            f'{k} max abs err {err:.3e} (tolerance {tol:.3e}; plain '
            f'{float(ref[k].abs().max()):.6e} max abs)')
        if err > tol:
            bad.append(k)
    if bad:
        raise AssertionError(f'kernel path on tier {tier} and plain path '
                             f'disagree: {bad}')


def phase_value_path(iters=VALUE_ITERS, seed=SEED, T=MAIN_T, B=GRID_B,
                     tag='phase 7', coptions=(), setup=None, mm=True,
                     vg='fused_rollout_vg', lr_rule=False, env='Cartpole'):
    """``mc_pilco`` at B = 1000 with the critic of ``critic_setup`` (with
    ``coptions``; the log's ``tag``) on the main path's setup (or ``setup``,
    as ``main_path_setup`` returns it, of ``env``; states and rewards
    moment-matched with ``mm``), where
    the gate must name the whole-rollout tier: the launch counts of the run
    (set to 0 just before it: one ``vg`` an iteration, the
    refit and the bootstrap in it, nothing else), v_loss falling, the ms an
    iteration on that tier and forced to the grid tier in the same call
    (``value_tier_times``), and one iteration on each of the two against the
    plain path (``lr_rule`` as ``compare_value_paths``). Returns the launch
    counts, ``opts`` (``value_opts``) and the critic's (V, state, stats)."""
    setup = setup or main_path_setup(seed)
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    V, update, state, vstats = critic_setup(x0_pool.shape[-1], seed, T,
                                            coptions)
    opts = value_opts(setup, V, update, T, B, mm)
    opt = opts['full']
    if opt.tier('cuda') != 'full':
        raise AssertionError(f'the gate names {opt.tier("cuda")!r} for the '
                             f'value path at B={B}, expected \'full\'')
    stamps = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pol_params, _, metrics, n_steps = mc_pilco(
        x0_pool, dyn, pol, T, dyn_params, dyn_stats, pol_params,
        opt_iters=iters, mm_states=mm, mm_rewards=mm,
        init_state_noise=init_noise, n_particles=B, seed=seed, chunk=1,
        on_iteration=lambda done, m: stamps.append(time.perf_counter()),
        value_spec=V, value_stats=vstats, value_update_fn=update,
        value_state=state)
    torch.cuda.synchronize()
    launches = counts()
    if n_steps != iters or int(state['opt_state'].count) != iters:
        raise AssertionError('the run did not take every iteration')
    report(tag, 'mc_pilco with a TD(H) critic (tier full)', iters, t0,
           stamps, metrics['loss'], metrics['mean_return'], launches,
           expect(**{vg: iters}), T, B, env, mm)
    v = metrics['v_loss']
    if not np.all(np.isfinite(v)):
        raise AssertionError('non-finite v_loss on the value path')
    first, last = float(v[:10].mean()), float(v[-10:].mean())
    log(f'[{tag}] v_loss first {v[0]:.6e} last {v[-1]:.6e} (min '
        f'{v.min():.6e}, max {v.max():.6e}; first-10 mean {first:.6e}, '
        f'last-10 mean {last:.6e}), all finite')
    if not last < first:
        raise AssertionError('v_loss did not fall on the value path')
    ms = value_tier_times(setup, opts, state, vstats, seed=seed)
    log(f'[{tag}] an iteration with the critic at B={B} (host clock, '
        f'synchronised, median of 30, two runs each in turns): tier full '
        f'{ms["full"]:.3f} ms, forced to tier grid {ms["grid"]:.3f} ms; '
        f'{card_line()}')
    for tier, o in opts.items():
        compare_value_paths(setup, o, V, state, vstats, seed, T, tier, tag,
                            mm, lr_rule)
    ITER_MS[tag] = ms['full']
    return launches, opts, (V, state, vstats)


def phase_fixed_critic(iters=FIXED_ITERS, seed=SEED, T=MAIN_T, B=GRID_B):
    """``mc_pilco`` at B = 1000 under a fixed critic (``value_spec`` and
    ``value_params`` of ``critic_setup``, no update), where the gate must
    name the grid tier (the whole-rollout kernel adds no bootstrap): one
    ``fused_grid_fwd`` and one ``fused_grid_bwd`` an iteration, the critic's
    MLP once each way for the bootstrap and its VJP, no refit; the critic's
    params untouched. Then one iteration's loss, mean_return and clipped
    policy grads against the plain path (``make_loss_plain`` with the fixed
    critic, unfused MLPs) on the same x0 and noise, held as
    ``compare_value_paths`` holds them. Returns the launch counts, set to 0
    just before the run."""
    setup = main_path_setup(seed)
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    V, _, state, vstats = critic_setup(x0_pool.shape[-1], seed, T)
    vp = state['params']
    kept = torch.cat([v.reshape(-1) for v in tree_leaves(vp)]).clone()
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True)
    opt = make_mc_pilco_fn(dyn, pol, cfg, 'cuda', V)
    if opt.tier('cuda') != 'grid':
        raise AssertionError(f'the gate names {opt.tier("cuda")!r} for a '
                             f'fixed critic at B={B}, expected \'grid\'')
    stamps = []
    run_params = tree_map(lambda v: v.detach().clone(), pol_params)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, metrics, n_steps = mc_pilco(
        x0_pool, dyn, pol, T, dyn_params, dyn_stats, run_params,
        opt_iters=iters, mm_states=True, mm_rewards=True,
        init_state_noise=init_noise, n_particles=B, seed=seed, chunk=1,
        on_iteration=lambda done, m: stamps.append(time.perf_counter()),
        value_spec=V, value_params=vp, value_stats=vstats)
    torch.cuda.synchronize()
    launches = counts()
    if n_steps != iters or 'v_loss' in metrics:
        raise AssertionError('the fixed-critic run took a wrong course')
    if not torch.equal(torch.cat([v.reshape(-1) for v in tree_leaves(vp)]),
                       kept):
        raise AssertionError('the fixed critic\'s params moved')
    report('phase 7 fixed critic', 'mc_pilco under a fixed critic (tier '
           'grid)', iters, t0, stamps, metrics['loss'],
           metrics['mean_return'], launches,
           expect(fused_grid_fwd=iters, fused_grid_bwd=iters,
                  fused_mlp_fwd=iters, fused_mlp_bwd=iters), T, B)
    plain = fr.make_loss_plain(fr.unfused(dyn), fr.unfused(pol), T, opt.w_t,
                               True, True, True, w_H=opt.w_H,
                               value_spec=fr.unfused(V))
    noise = opt.prepare_noise(opt.sample_noise(
        seeded_generator('cuda', seed, 1), x0_pool.shape[-1], 'cuda'), 'cuda')
    x0 = opt.sample_x0(x0_pool, seeded_generator('cuda', seed, 2),
                       torch.tensor(init_noise, device='cuda'))
    params = [q.requires_grad_(True) for q in tree_leaves(pol_params)]

    def run(loss_fn):
        loss, mret = loss_fn()[:2]
        grads = clip_grad_norm(list(torch.autograd.grad(loss, params)), 1.0)
        return {'loss': loss.detach(), 'mean_return': mret.detach(),
                'grads': torch.cat([g.reshape(-1) for g in grads])}

    def plain_at(x):
        return lambda: plain(pol_params, x, dyn_params, dyn_stats,
                             *noise[:4], extras=(vp, vstats, noise[4]))

    got = run(lambda: opt.loss(pol_params, x0, dyn_params, dyn_stats, noise,
                               value_stats=vstats, value_params=vp))
    ref, moved = run(plain_at(x0)), run(plain_at(x0 * (1 + 1e-6)))
    bare = run(lambda: plain(pol_params, x0, dyn_params, dyn_stats,
                             *noise[:4], extras=(None, vstats, noise[4])))
    if not float((bare['loss'] - ref['loss']).abs()) > 0:
        raise AssertionError('the bootstrap did not move the loss')
    floor = {'loss': 1e-4 * float(ref['loss'].abs()),
             'mean_return': 1e-4 * float(ref['mean_return'].abs()),
             'grads': 1e-3 * float(ref['grads'].abs().max())}
    for k, f in floor.items():
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f'non-finite {k} on the kernel path')
        err = float((got[k] - ref[k]).abs().max())
        tol = max(f, 3 * float((moved[k] - ref[k]).abs().max()))
        log(f'[phase 7 fixed critic] one iteration, kernel vs plain path: '
            f'{k} max abs err {err:.3e} (tolerance {tol:.3e}; plain '
            f'{float(ref[k].abs().max()):.6e} max abs; without the '
            f'bootstrap {float(bare[k].abs().max()):.6e})')
        if err > tol:
            raise AssertionError(f'kernel path and plain path disagree: {k}')
    return launches


# ---------------------------------------------------------------------------
# phase 8: the episode
# ---------------------------------------------------------------------------


def busy_time(events):
    """Union of the events' device intervals (us) and the window they span."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, end - spans[0][0]


def device_events(prof):
    """Device work of a torch.profiler run: kernels and copies, not the
    spans of user annotations it also files under the device."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)
            and '#' not in e.name]


def flat_leaves(tree, prefix=''):
    """(path, tensor) pairs of nested dicts and lists, dict keys in sorted
    order (``tree_leaves``' order and leaves)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flat_leaves(tree[k], f'{prefix}/{k}')]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flat_leaves(v, f'{prefix}/{i}')]
    return [] if tree is None else [(prefix, tree)]


def driver_models(args):
    """The env ``args.env`` on the card and the models the driver builds
    for it: (env, dyn, pol), the reward learned where the env has none
    (the Box2D lander) or ``--learn_reward`` asks."""
    env = envs.make(args.env, device='cuda')
    rf = getattr(env, 'reward_func', None)
    dyn, pol = dpc.build_models(
        env.observation_size, env.action_size, env.action_space.high,
        env.action_space.low, args, args.learn_reward or not callable(rf),
        rf)
    return env, dyn, pol


def episode_fit_checks(results, args, tag='phase 8', profile=True):
    """From the run's checkpoint (experience and dynamics params): one fit
    step of the kernel path against the plain path (fused=False) on the same
    minibatch and noise, loss and every grad (logit_p among them) held to
    REL_TOL of the leaf's own max|plain|; then, with ``profile``, the fit's
    device-busy share over BUSY_STEPS steps under torch.profiler."""
    exp = ExperienceDataset()
    ck = load_checkpoint(results, exp=exp, device='cuda')
    _, dyn, _ = driver_models(args)
    X, Y = (torch.as_tensor(a, device='cuda')
            for a in exp.get_dynmodel_dataset(
                deltas=True, return_costs=dyn.reward_func is None))
    Xn, Yn = normalize_dataset(dyn.fit_stats(X, Y), X, Y)
    n, B = Xn.shape[0], args.dyn_batch_size
    gen = seeded_generator('cuda', SEED, 8)
    idx = torch.randint(0, n, (B,), generator=gen, device='cuda')
    noise = dyn.regressor.sample_noise(gen, (B,), device='cuda')
    ones = torch.ones((B,), device='cuda')
    out = {}
    for path, reg in (('kernel', dyn.regressor),
                      ('plain', fr.unfused(dyn.regressor))):
        train = make_train_fn(reg, Adam(args.dyn_lr), B)
        loss, _, grads = train.value_and_grad(ck['dyn'], Xn[idx], Yn[idx],
                                              noise, ones, n)
        out[path] = [('loss', loss)] + flat_leaves(grads)
    errs = []
    for (name, a), (_, r) in zip(out['kernel'], out['plain']):
        _, rel, _ = hold(f'[{tag}] fit step {name}', a, r, REL_TOL)
        errs.append(f'{name} {rel:.2e}')
    log(f'[{tag}] one fit step ({n} rows, B={B}), kernel vs plain path, '
        f'error / max|plain| per output (tolerance {REL_TOL:g}): '
        + ', '.join(errs))
    if not profile:
        return

    train = make_train_fn(dyn.regressor, Adam(args.dyn_lr), B)
    params, state = ck['dyn'], Adam(args.dyn_lr).init(ck['dyn'])
    params, state, _, _ = train(params, state, Xn, Yn, gen, 5)  # warm
    device_profile('phase 8', 'fit',
                   lambda: train(params, state, Xn, Yn, gen, BUSY_STEPS),
                   BUSY_STEPS)


def device_profile(tag, what, run, n, unit='step'):
    """Run ``run()``, ``n`` units of work, under torch.profiler and log the
    device activities a unit, the device's busy ms a unit and its share of
    the window between the first and the last kernel, and the six kernels
    that take the most of it. Returns (busy, window) in ms a unit."""
    from torch.profiler import ProfilerActivity, profile
    a = 'an' if unit[0] in 'aeiou' else 'a'
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = device_events(prof)
    if not dev:
        raise AssertionError('the profiler recorded no device activity')
    busy, window = busy_time(dev)
    by_name = {}
    for e in dev:
        k = by_name.setdefault(e.name, [0.0, 0])
        k[0] += e.time_range.end - e.time_range.start
        k[1] += 1
    log(f'[{tag}] {what} under torch.profiler, {n} {unit}s: '
        f'{len(dev) / n:.0f} device activities {a} {unit}; device busy '
        f'{busy / n / 1e3:.4f} ms {a} {unit}, {100 * busy / window:.1f}% '
        f'of the {window / n / 1e3:.4f} ms {a} {unit} between the first '
        f'and last kernel (idle {100 * (1 - busy / window):.1f}%)')
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f'[{tag}]   {us / n / 1e3:.4f} ms {a} {unit}, '
            f'{cnt / n:.0f} {a} {unit}, {100 * us / busy:.1f}% of busy: '
            f'{name[:80]}')
    return busy / n / 1e3, window / n / 1e3


def episode_policy_check(results, args, tag):
    """From the run's checkpoint (experience, fitted dynamics and trained
    policy params): one policy iteration's loss and grads through row 5 (the
    value-and-grad ``MCPILCO`` takes on the ``'full'`` tier) against the
    plain path (``compare_paths``: ``utils.rollout`` on unfused MLPs, the
    same x0 and noise, the tolerance the plain path's own sensitivity, at
    least 1e-4 of |loss| and 1e-3 of max|grad|), with the experience's
    states as the x0 pool, as phase 5 does; with a learned reward the
    dynamics' stats take the rewards' column too."""
    exp = ExperienceDataset()
    ck = load_checkpoint(results, exp=exp, device='cuda')
    _, dyn, pol = driver_models(args)
    X, Y = (torch.as_tensor(a, device='cuda')
            for a in exp.get_dynmodel_dataset(
                deltas=True, return_costs=dyn.reward_func is None))
    stats = dyn.fit_stats(X, Y)
    pool = np.concatenate([np.asarray(ep, np.float32) for ep in exp.states])
    pol_params = tree_map(lambda p: p.requires_grad_(True), ck['pol'])
    B, T = args.pol_batch_size, args.pred_H
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True)
    opt = make_mc_pilco_fn(dyn, pol, cfg, 'cuda')
    if opt.tier('cuda') != 'full':
        raise AssertionError(f'the gate names {opt.tier("cuda")!r}')

    def row5(p, x0, noise):
        loss, _, grads, _ = opt.fused_vg(p, x0, ck['dyn'], stats,
                                         *opt.prepare_noise(noise, 'cuda'))
        return float(loss), torch.cat([g.reshape(-1)
                                       for g in tree_leaves(grads)])

    compare_paths((dyn, pol, ck['dyn'], pol_params, stats,
                   torch.as_tensor(pool, device='cuda'),
                   1e-2 * pool.std(0)), row5, tag, SEED, T, B)


def run_episodes(argv, episodes, tag, checks, settings=dpm.SETTINGS,
                 tier='full'):
    """A torch Deep-PILCO driver (``main`` through its parser and the entry
    point's ``settings``, by default ``deep_pilco_mm``'s) with ``argv`` into
    a temporary folder under ``build/``, every count set to 0 just before
    it. Checks every value finite (v_loss too with a critic), E_lml rising
    within each fit, the tier the gate names for the driver's configuration
    (``tier``: ``'full'``, whether the env gives the reward or the driver
    learns it, and with the with-value driver's critic refit in the kernel)
    and its exact launch counts: fused-MLP forward one a fit step and one a
    control step taken (the lander may end an episode early; counted from
    the experience), backward one a fit step, and ``fused_rollout_vg`` one a
    policy iteration, no fused-MLP launch from the policy loop (with
    ``tier`` None, the ``utils.rollout`` route: no rollout kernel, the
    fused MLP 2 T times each way a policy iteration); then ``checks(results
    folder, args)`` on its checkpoint. Returns the launch counts and the
    per-episode records."""
    root = Path(__file__).resolve().parent / 'build'
    root.mkdir(exist_ok=True)
    folder = tempfile.mkdtemp(prefix='chip_smoke_episode_', dir=root)
    try:
        argv = argv + ['-o', folder]
        parsed = dpc.get_argument_parser().parse_args(argv)
        fit_iters, pol_opt_iters = parsed.dyn_opt_iters, parsed.pol_opt_iters
        records = []
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        returns, results = dpc.main(**settings, argv=argv, device='cuda',
                                    on_episode=records.append)
        torch.cuda.synchronize()
        launches = counts()
        wall = time.perf_counter() - t0
        if len(records) != episodes or len(returns) != episodes:
            raise AssertionError(f'{len(records)} episodes, expected '
                                 f'{episodes}')
        for r in records:
            dm, pm = r['dyn_metrics'], r['pol_metrics']
            vals = [dm['loss'], dm['E_lml'], pm['loss'], pm['mean_return'],
                    [r['real_return'], r['imagined_return'], r['E_lml']]]
            vals += [pm['v_loss']] if 'v_loss' in pm else []
            if not all(np.all(np.isfinite(v)) for v in vals):
                raise AssertionError(f'non-finite value in episode '
                                     f'{r["episode"]}')
            first, last = dm['E_lml'][:50].mean(), dm['E_lml'][-50:].mean()
            log(f'[{tag}] episode {r["episode"]}: E_lml {r["E_lml"]:.6f} '
                f'(fit: first-50 mean {first:.6f}, last-50 mean {last:.6f}); '
                f'imagined return {r["imagined_return"]:.6f}; real return '
                f'{r["real_return"]:.6f}; fit '
                f'{1e3 * r["fit_s"] / fit_iters:.4f} ms a step ({fit_iters} in {r["fit_s"]:.3f} s); policy '
                f'{1e3 * r["pol_s"] / pol_opt_iters:.4f} ms an iteration '
                f'({pol_opt_iters} in {r["pol_s"]:.3f} s, the optimizer\'s '
                'build included)')
            if not last > first:
                raise AssertionError(f'E_lml did not rise in the fit of '
                                     f'episode {r["episode"]}')
        args = dpc.get_argument_parser().parse_args(argv)
        for k, v in settings['arg_overrides'].items():
            setattr(args, k, v)
        _, dyn, pol = driver_models(args)
        cfg = MCPILCOConfig(
            n_particles=args.pol_batch_size, steps=args.pred_H,
            mm_states=settings['mm_states'], mm_rewards=settings['mm_rewards'],
            mm_groups=args.mm_groups,
            mm_method=args.mm_method.replace('experimental_', ''),
            with_priorities=args.prioritized_replay)
        critic = (dpc.build_critic(dyn.state_dims, args,
                                   dpc.driver_discount(args))
                  if settings.get('use_value') else ())
        reward = ('a learned reward' if dyn.reward_func is None
                  else 'the env\'s reward')
        got = make_mc_pilco_fn(dyn, pol, cfg, 'cuda', *critic).tier('cuda')
        log(f'[{tag}] the tier mc_pilco takes for the driver\'s '
            f'configuration ({reward}, reward kind '
            f'{fr.reward_kind(dyn.reward_func)}): {got!r}')
        if got != tier:
            raise AssertionError(f'the gate names {got!r}, expected '
                                 f'{tier!r}')
        exp = ExperienceDataset()
        exp.load(str(Path(results) / 'experience.pkl'))
        steps = sum(len(ep) for ep in exp.states)
        pol_iters = episodes * pol_opt_iters
        if tier is None:
            route = 2 * args.pred_H * pol_iters
            want = expect(fused_mlp_fwd=episodes * fit_iters + steps + route,
                          fused_mlp_bwd=episodes * fit_iters + route)
        else:
            want = expect(fused_mlp_fwd=episodes * fit_iters + steps,
                          fused_mlp_bwd=episodes * fit_iters,
                          fused_rollout_vg=pol_iters)
        log(f'[{tag}] {episodes} episode(s) in {wall:.3f} s, {steps} control '
            f'steps taken; launches {launches} (expected {want})')
        if launches != want:
            raise AssertionError('launch counts of the episode run differ')
        checks(results, args)
        return launches, records
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def phase_episode():
    """Phase 8: EPISODES full-width Cartpole episodes (``run_episodes``),
    then ``episode_fit_checks`` on the checkpoint. Returns the launch
    counts."""
    return run_episodes(EPISODE_ARGV, EPISODES, 'phase 8',
                        episode_fit_checks)[0]


def phase_value_episode():
    """Phase 10: one full-width episode of the with-value driver
    (``deep_pilco_no_mm_with_value``: no moment matching, the [200, 200]
    concrete-dropout MSE critic refit every policy iteration, H = 15) with
    phase 8's widths and cuts (``run_episodes``: launches exact, the refit
    inside the ``fused_rollout_vg`` of each policy iteration), one fit step
    held against the plain path, v_loss finite; logs v_loss over the
    episode and the ms a fit step and a policy iteration."""
    tag = 'phase 10'

    def checks(results, args):
        episode_fit_checks(results, args, tag, profile=False)

    _, (r,) = run_episodes(EPISODE_ARGV + ['--ps_iters', '1'], 1, tag,
                           checks, settings=dvm.SETTINGS)
    v = r['pol_metrics']['v_loss']
    log(f'[{tag}] v_loss over the episode\'s {len(v)} policy iterations: '
        f'first {v[0]:.6e}, last {v[-1]:.6e}, first-20 mean '
        f'{v[:20].mean():.6e}, last-20 mean {v[-20:].mean():.6e}, '
        f'{len(np.unique(v))} distinct values')
    if len(np.unique(v)) <= len(v) // 2:
        raise AssertionError('the episode\'s v_loss history repeats: its '
                             'entries are not each iteration\'s own')
    log(f'[{tag}] fit {1e3 * r["fit_s"] / FIT_ITERS:.4f} ms a step, policy '
        f'{1e3 * r["pol_s"] / EPISODE_POL_ITERS:.4f} ms an iteration (the '
        f'critic refit in it); {card_line()}')


def evaluate_check(results, tag):
    """The ``evaluate_policy`` replay of the run in ``results`` on the card,
    once a snapshot: one point per policy snapshot, every return finite,
    and matplotlib not imported by it."""
    had_mpl = 'matplotlib' in sys.modules
    curve = evaluate_policy.evaluate(results, n_evals=1, device='cuda')
    exp = ExperienceDataset()
    exp.load(str(Path(results) / 'experience.pkl'))
    snapshots = sum(1 for p in exp.policy_parameters if p)
    log(f'[{tag}] evaluate_policy: {len(curve)} point(s) for {snapshots} '
        f'snapshot(s): ' + ', '.join(f'{n} steps, return {m:.6f}'
                                     for n, m, _ in curve))
    if len(curve) != snapshots or not np.all(np.isfinite(curve)):
        raise AssertionError('evaluate_policy gave a wrong curve')
    if 'matplotlib' in sys.modules and not had_mpl:
        raise AssertionError('the replay imported matplotlib')


def phase_env_episodes():
    """Phase 9: one full-width episode of the same driver and cuts on each
    of ENV_EPISODE_ENVS (``run_episodes``; the fit ENV_FIT_ITERS steps),
    then one on Cartpole with ``--learn_reward`` (whose policy iterations
    the whole-rollout kernel takes with the learned reward, kind 3) and one
    with ``--dyn_components 2`` (the mixture head in rows 1-2's fit and in
    row 5), each
    checked by one fit step and one policy iteration (row 5) against their
    plain paths; the lander's run then replayed by ``evaluate_policy``.
    Logs which class ``make('LunarLander')`` gives and each run's fit ms a
    step and policy ms an iteration."""
    runs = [(env, ['-e', env]) for env in ENV_EPISODE_ENVS]
    runs.append(('Cartpole --learn_reward', ['--learn_reward']))
    runs.append(('Cartpole --dyn_components 2', ['--dyn_components', '2']))
    runs.append(('Cartpole --mm_method experimental_mix --prioritized_replay',
                 ['--mm_method', 'experimental_mix', '--prioritized_replay',
                  '--plot_level', '0']))
    for name, argv in runs:
        tag = f'phase 9 {name}'
        if name == 'LunarLander':
            log(f'[{tag}] make(\'LunarLander\') gives '
                f'{type(envs.make(name, device="cuda")).__name__}')

        route = '--prioritized_replay' in argv

        def checks(results, args):
            episode_fit_checks(results, args, tag, profile=False)
            if not route:
                episode_policy_check(results, args, tag)
            if args.env == 'LunarLander':
                evaluate_check(results, tag)

        _, (r,) = run_episodes(EPISODE_ARGV + ['--ps_iters', '1',
                                               '--dyn_opt_iters',
                                               str(ENV_FIT_ITERS),
                                               '--pol_opt_iters',
                                               str(ENV_POL_ITERS)] + argv,
                               1, tag, checks, tier=None if route else 'full')
        if route:
            scores = r['pol_metrics']['priority_scores']
            log(f'[{tag}] priority scores {scores.shape}: finite '
                f'{bool(np.all(np.isfinite(scores)))}, mean '
                f'{scores.mean():.6e}')
            if not (np.all(np.isfinite(scores)) and scores.max() > 0):
                raise AssertionError('the episode\'s priority scores are not '
                                     'finite and positive')
        log(f'[{tag}] fit {1e3 * r["fit_s"] / ENV_FIT_ITERS:.4f} ms a step, '
            f'policy {1e3 * r["pol_s"] / ENV_POL_ITERS:.4f} ms an '
            'iteration')


# ---------------------------------------------------------------------------
# phase 11: particle sharding over gloo ranks that share the card
# ---------------------------------------------------------------------------

SHARD_TIMEOUT = 300  # seconds a call to the ranks may take before it fails
# (ranks, mm_groups, moment matching, mixture components: 0 a diagonal
# head)
K8_CASES = ((2, GROUPS_MAIN, True, 0), (4, 2 * GROUPS_MAIN, True, 0),
            (2, None, False, 0), (2, GROUPS_MAIN, True, 2),
            (2, GROUPS_MAIN, True, 8))
SHARD_ROUTE_ITERS = 5  # phase 11c: iterations of the sharded route
SHARD_FIT_ITERS = 100  # phase 11e: the episode's fit steps
SHARD_POL_ITERS = 50  # phase 11e: its policy iterations


def on_host(tree):
    """``tree``'s tensors detached and on the host, to go to the ranks."""
    return tree_map(lambda t: t.detach().cpu(), tree)


def shard_counts():
    return counts(), tpar.COLLECTIVES['all_reduce']


def reset_shard_counts():
    reset_counts()
    tpar.reset_collective_counts()


def k8_rank(mesh, inputs, w_t, mm_states, mm_rewards, groups, components=0):
    """A rank of phase 11a: K8 on its slices of the global inputs (one call,
    counted, then timed; a mixture dynamics head of ``components``).
    Returns (loss, mean_return and the policy grads on the host, launches,
    all-reduces, ms a call)."""
    dyn, pol, _, _ = env_models('Cartpole', components=components)
    pp, args = tree_map(lambda t: t.to(mesh.device), inputs)
    x0, dp, st, dn, pn, zm, zr, eps = args
    vg = fr.make_fused_sharded_value_and_grad(
        dyn, pol, MAIN_T, w_t, mm_states, mm_rewards, True, mesh,
        mm_groups=groups, mode='full', mm_rewards_mean_only=mm_rewards)
    x0, dn, pn = tpar.shard_particles((x0, dn, pn), mesh)
    zm, zr, eps = tpar.shard_particles((zm, zr, eps), mesh, axis=1)

    def call():
        return vg(pp, x0, dp, st, dn, pn, zm, zr, eps)

    reset_shard_counts()
    loss, mret, grads, _ = call()
    torch.cuda.synchronize()
    launches, all_reduces = shard_counts()
    out = on_host([loss, mret, *tree_leaves(grads)])
    return out, launches, all_reduces, time_launches(call)


def k8_case(ranks, n, groups, mm, card, components=0):
    """Phase 11a, one case: K8 on ``n`` ranks (``groups`` MM groups of B =
    MAIN_B particles, or no MM; a mixture dynamics head of ``components``,
    its noise sliced with the particles) against one unsharded row-5 launch
    at B = MAIN_B on the same inputs, here, and against the plain version (in
    float64 with groups, as phase 2g holds row 5), each output within
    STEP_TOL of its max or the plain version's sensitivity; exactly one
    ``fused_rollout_vg`` launch and one all-reduce on each rank."""
    _, kvg, plain, pp, leaves, args, (dyn, pol, w_t) = rollout_problem(
        MAIN_B, 11, groups=groups, components=components)
    mm_states = mm and args[5] is not None
    if not mm:
        args[5] = args[6] = None
        make = (dyn, pol, MAIN_T, w_t, False, False, True)
        kvg = fr.make_fused_value_and_grad(*make, mode='full')
        plain = fr.make_loss_plain(picking(dyn), *make[1:])
    ref = kvg(pp, *args)
    kref = [ref[0], ref[1], *tree_leaves(ref[2])]
    if groups:
        plain = float64(plain)
    vref = rollout_outputs(plain, pp, leaves, args, g=(1.0, 0.0))[:-1]
    vmoved = rollout_outputs(plain, pp, leaves, args, 1 + 1e-6,
                             g=(1.0, 0.0))[:-1]
    ms_ref = time_launches(lambda: kvg(pp, *args))
    outs = ranks.run(k8_rank, on_host((pp, args)), w_t, mm_states, mm,
                     groups, components, timeout=SHARD_TIMEOUT)
    what = (f'K8 on {n} ranks, B={MAIN_B} T={MAIN_T} '
            + (f'mm_groups={groups} (states'
               f'{"" if mm_states else " not"} resampled)' if mm
               else 'no MM')
            + (f' mixture K={components}' if components else ''))
    labels = (['loss', 'mean_return']
              + [f'd pol leaf {i}' for i in range(len(leaves))])
    worst = worst_k = 0.0
    for rank, (out, launches, all_reduces, ms) in enumerate(outs):
        if launches != expect(fused_rollout_vg=1) or all_reduces != 1:
            raise AssertionError(f'{what}, rank {rank}: launches {launches}, '
                                 f'{all_reduces} all-reduces; expected one '
                                 'fused_rollout_vg and one all-reduce')
        for lab, a, k, r, m in zip(labels, out, kref, vref, vmoved):
            a = a.cuda()
            err, rel, _ = hold(f'{what} rank {rank} {lab} vs the plain '
                               'version', a, r, STEP_TOL, m)
            # against the kernel at B = MAIN_B: STEP_TOL of its max or the
            # plain version's own sensitivity
            err_k, rel_k, _ = hold(f'{what} rank {rank} {lab} vs the '
                                   'unsharded row 5', a, k, STEP_TOL,
                                   k + (m - r))
            worst, worst_k = max(worst, rel), max(worst_k, rel_k)
        log(f'[phase 11a] {what}, rank {rank}: launches {launches}, '
            f'{all_reduces} all-reduce; {ms:.4f} ms a K8 call (row 5 on '
            f'{MAIN_B // n} particles and the all-reduce through the host, '
            f'the ranks sharing one card), unsharded row 5 {ms_ref:.4f} ms '
            f'here; {card}')
    log(f'[phase 11a] {what}: loss {float(kref[0]):.6e}; worst output '
        f'error relative to its max, against the unsharded row 5 '
        f'{worst_k:.3e}, against the plain version'
        f'{" in float64" if groups else ""} {worst:.3e} (tolerance '
        f'{STEP_TOL:.0e} or the plain version\'s sensitivity) ok')


def mc_pilco_rank(mesh, iters, groups, fused_rollout, B):
    """A rank of phases 11b-11d: phase 5's ``mc_pilco`` call with ``mesh``
    (``iters`` iterations, B particles in ``groups`` MM groups; unsharded on
    the current card with ``mesh`` None), every count set to 0 just before
    it. Returns a dict: tier, losses, mean returns, launches, all-reduces,
    ms an iteration and whether the params' bits agree over the ranks."""
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = \
        main_path_setup(SEED)
    cfg = MCPILCOConfig(n_particles=B, steps=MAIN_T, mm_states=True,
                        mm_rewards=True, mm_groups=groups,
                        fused_rollout=fused_rollout)
    device = x0_pool.device
    tier = make_mc_pilco_fn(dyn, pol, cfg, device, mesh=mesh).tier(device)
    stamps = []
    reset_shard_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pol_params, _, metrics, _ = mc_pilco(
        x0_pool, dyn, pol, MAIN_T, dyn_params, dyn_stats, pol_params,
        opt_iters=iters, mm_states=True, mm_rewards=True, mm_groups=groups,
        init_state_noise=init_noise, n_particles=B, seed=SEED, chunk=1,
        on_iteration=lambda done, m: stamps.append(time.perf_counter()),
        fused_rollout=fused_rollout, mesh=mesh)
    torch.cuda.synchronize()
    launches, all_reduces = shard_counts()
    return dict(tier=tier, losses=metrics['loss'],
                rets=metrics['mean_return'], launches=launches,
                all_reduces=all_reduces,
                ms=float(np.median(np.diff([t0] + stamps)) * 1e3),
                same=mesh is None or tpar.same_on_every_rank(pol_params,
                                                             mesh))


def sharded_run(ranks, tag, what, iters, groups, fused_rollout, B, tier,
                want, all_reduces, against=None):
    """Phases 11b-11d: ``mc_pilco_rank`` on each rank; the tier, exact
    launches and all-reduces on each rank, finite losses, the same losses
    and param bits on every rank, and with ``against`` = (the tag of an
    unsharded run of this call, k) the first k losses within JAX's rule for
    a sharded run (rtol 1e-3, atol 1e-6, ``tests/test_fused_rollout.py
    :697-701``; later ones drift apart as Adam turns rounding-level
    gradient entries into steps of up to lr). Returns the ms an iteration
    of each rank."""
    outs = ranks.run(mc_pilco_rank, iters, groups, fused_rollout, B,
                     timeout=SHARD_TIMEOUT)
    for rank, o in enumerate(outs):
        if o['tier'] != tier:
            raise AssertionError(f'[{tag}] rank {rank} takes {o["tier"]!r}, '
                                 f'expected {tier!r}')
        if o['launches'] != want or o['all_reduces'] != all_reduces:
            raise AssertionError(f'[{tag}] rank {rank}: launches '
                                 f'{o["launches"]}, {o["all_reduces"]} '
                                 f'all-reduces; expected {want}, '
                                 f'{all_reduces}')
        if not (np.all(np.isfinite(o['losses'])) and o['same']):
            raise AssertionError(f'[{tag}] rank {rank}: non-finite losses '
                                 'or params that differ over the ranks')
        if not np.array_equal(o['losses'], outs[0]['losses']):
            raise AssertionError(f'[{tag}] the ranks\' losses differ')
    losses = outs[0]['losses']
    log(f'[{tag}] {what} on {len(outs)} ranks sharing one card, B={B} '
        f'T={MAIN_T}: tier {tier!r}; launches on each rank '
        f'{outs[0]["launches"]}, {all_reduces} all-reduces (expected); loss '
        f'first {losses[0]:.6e} last {losses[-1]:.6e}; the params\' bits the '
        'same on every rank')
    if against is not None:
        against, k = against
        got, ref = losses[:k], LOSSES[against][:k]
        err = float(np.max(np.abs(got - ref) / np.abs(ref)))
        log(f'[{tag}] the first {k} losses against the unsharded run '
            f'({against}): {got.tolist()} vs {ref.tolist()}, max relative '
            f'err {err:.3e} (rtol 1e-3, atol 1e-6)')
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-6)
    return [o['ms'] for o in outs]


def driver_rank(mesh, argv, folder, settings=dpm.SETTINGS):
    """A rank of phases 11e and 11f: the driver's ``main`` (``settings``:
    its entry point's, ``deep_pilco_mm``'s by default) on this rank of
    ``mesh``, every count set to 0 just before it. Returns (launches,
    all-reduces, real returns, results folder, the per-episode records:
    rank 0's only, and the critic's params on the host as the driver's own
    check of the ranks' params saw them after the episode, or None)."""
    records, checked = [], []
    real = tpar.same_on_every_rank

    def spy(tree, m):
        checked.append(on_host(tree))
        return real(tree, m)

    tpar.same_on_every_rank = spy  # the driver calls parallel's
    try:
        reset_shard_counts()
        returns, results = dpc.main(**settings, argv=argv + ['-o', folder],
                                    device=mesh.device, mesh=mesh,
                                    on_episode=records.append)
        torch.cuda.synchronize()
    finally:
        tpar.same_on_every_rank = real
    value_state = checked[-1][2] if checked else None
    return (*shard_counts(), returns, results, records,
            value_state and tree_leaves(value_state['params']))


def shard_episode(ranks, card):
    """Phase 11e: one ``deep_pilco_mm --n_devices 2 --dist_backend gloo
    --mm_groups 10`` episode at phase 8's widths, the fit cut to
    SHARD_FIT_ITERS steps and the policy to SHARD_POL_ITERS iterations:
    exact launches on each rank (the fused MLP forward once a fit step, and
    on rank 0 once a control step: rank 0 alone acts; ``fused_rollout_vg``
    once a policy iteration; one all-reduce a fit step and a policy
    iteration), E_lml rising, rank 0 alone writing (one results folder), the
    driver's own check of the ranks' params passed."""
    tag = 'phase 11e'
    root = Path(__file__).resolve().parent / 'build'
    root.mkdir(exist_ok=True)
    folder = tempfile.mkdtemp(prefix='chip_smoke_shard_', dir=root)
    try:
        argv = EPISODE_ARGV + [
            '--ps_iters', '1', '--dyn_opt_iters', str(SHARD_FIT_ITERS),
            '--pol_opt_iters', str(SHARD_POL_ITERS), '--mm_groups',
            str(GROUPS_MAIN), '--n_devices', str(ranks.n), '--dist_backend',
            'gloo']
        t0 = time.perf_counter()
        outs = ranks.run(driver_rank, argv, folder, timeout=SHARD_TIMEOUT)
        wall = time.perf_counter() - t0
        written = sorted(str(Path(d).relative_to(folder))
                         for d, _, fs in os.walk(folder)
                         if 'latest_policy.pkl' in fs)
        results = outs[0][3]
        if written != [str(Path(results).relative_to(folder))]:
            raise AssertionError(f'[{tag}] results written to {written}')
        (r,) = outs[0][4]
        exp = ExperienceDataset()
        exp.load(str(Path(results) / 'experience.pkl'))
        steps = sum(len(ep) for ep in exp.states)
        for rank, (launches, all_reduces, returns, res, records, _) in \
                enumerate(outs):
            want = expect(fused_mlp_fwd=SHARD_FIT_ITERS
                          + (steps if rank == 0 else 0),
                          fused_mlp_bwd=SHARD_FIT_ITERS,
                          fused_rollout_vg=SHARD_POL_ITERS)
            reduces = SHARD_FIT_ITERS + SHARD_POL_ITERS
            if launches != want or all_reduces != reduces:
                raise AssertionError(f'[{tag}] rank {rank}: launches '
                                     f'{launches}, {all_reduces} all-reduces;'
                                     f' expected {want}, {reduces}')
            if res != results or returns != outs[0][2] or (
                    rank and records):
                raise AssertionError(f'[{tag}] rank {rank} returned another '
                                     'run\'s results, or its own records')
        dm, pm = r['dyn_metrics'], r['pol_metrics']
        first, last = dm['E_lml'][:50].mean(), dm['E_lml'][-50:].mean()
        if not (last > first and all(np.all(np.isfinite(v)) for v in (
                dm['loss'], pm['loss'], pm['mean_return']))):
            raise AssertionError(f'[{tag}] E_lml did not rise or a value is '
                                 'not finite')
        log(f'[{tag}] deep_pilco_mm {" ".join(argv[-8:])} on {ranks.n} gloo '
            f'ranks sharing one card: one episode in {wall:.3f} s; E_lml '
            f'{r["E_lml"]:.6f} (fit: first-50 mean {first:.6f}, last-50 '
            f'{last:.6f}); imagined return {r["imagined_return"]:.6f}, real '
            f'{r["real_return"]:.6f}; fit {1e3 * r["fit_s"] / SHARD_FIT_ITERS:.4f}'
            f' ms a step, policy {1e3 * r["pol_s"] / SHARD_POL_ITERS:.4f} ms '
            f'an iteration; launches rank 0 {outs[0][0]}, rank 1 '
            f'{outs[1][0]} (expected; {steps} control steps on rank 0 '
            'alone); one results folder, written by rank 0; the ranks\' '
            f'params the same bits (the driver checks); {card}')
    finally:
        shutil.rmtree(folder, ignore_errors=True)


# phase 11f: each option of the utils.rollout route under particle sharding,
# one mc_pilco call on 2 ranks against the same call unsharded: (name,
# mc_pilco keywords, particles, critic: None, 'fixed' or 'update')
MM_BOTH = dict(mm_states=True, mm_rewards=True)
SHARD_OPTIONS = (
    ('a fixed critic', MM_BOTH, MAIN_B, 'fixed'),
    ('a TD(H) value update', {}, GRID_B, 'update'),
    ('CVaR', dict(cvar_eps=0.25, **MM_BOTH), MAIN_B, None),
    ('straddling MM groups', dict(mm_groups=3, **MM_BOTH), 102, None),
    ('mm_method=mix', dict(mm_method='mix', **MM_BOTH), MAIN_B, None),
    ('infer_noise_variables', dict(infer_noise_variables=True, **MM_BOTH),
     MAIN_B, None),
    ('pegasus=False', dict(pegasus=False, **MM_BOTH), MAIN_B, None),
    ('prioritized_replay', dict(prioritized_replay=True, **MM_BOTH), MAIN_B,
     None))
SHARD_OPTION_ITERS = 3  # iterations of each phase 11f call
# phase 11f's policy steps: the CPU tests' (SGD, no clipping), so that the
# params' change is lr times the sum of the gradients, which the holds see
SHARD_OPTION_LR = 1e-2


def option_rank(mesh, options, B, critic_kind, iters=SHARD_OPTION_ITERS):
    """A rank of phase 11f (``mesh`` None: the unsharded call, here, forced
    to the ``utils.rollout`` route, which a sharded run with any of these
    options takes; unsharded the gate sends a critic to a fused tier):
    ``mc_pilco`` on the main path's setup with ``options`` at B particles
    (with the with-value driver's critic, fixed or refit every iteration,
    ``critic_setup``), ``iters`` iterations of one each, every count set to
    0 just before it. Returns a dict: the tier, the losses, mean returns,
    v_losses and priority scores, the final policy (and critic) params and
    the sum tree's drawn leaves on the host, the launches, all-reduces and
    all-gathers, ms an iteration, and whether the policy's params and the
    critic's state hold the same bits on every rank. The policy takes SGD
    steps of SHARD_OPTION_LR without clipping."""
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = \
        main_path_setup(SEED)
    device = x0_pool.device
    kw, state = {}, None
    if critic_kind:
        V, update, state, vstats = critic_setup(x0_pool.shape[-1])
        kw = dict(value_spec=V, value_stats=vstats)
        if critic_kind == 'update':
            kw.update(value_update_fn=update, value_state=state)
        else:
            kw['value_params'] = state['params']
    fused = None if mesh is not None else False
    cfg = {('with_priorities' if k == 'prioritized_replay' else k): v
           for k, v in options.items()}
    tier = make_mc_pilco_fn(
        dyn, pol, MCPILCOConfig(n_particles=B, steps=MAIN_T,
                                fused_rollout=fused, **cfg), device,
        value_spec=kw.get('value_spec'),
        value_update=kw.get('value_update_fn'), mesh=mesh).tier(device)
    drawn, make_tree = [], native.make_sum_tree

    def spy_tree(*a, **k):
        tree = make_tree(*a, **k)
        sample = tree.sample

        def spy(*a, **k):
            out = sample(*a, **k)
            drawn.append(np.asarray(out[1]))
            return out

        tree.sample = spy
        return tree

    native.make_sum_tree = spy_tree
    start = [p.detach().clone() for p in tree_leaves(pol_params)]
    stamps = []
    try:
        reset_shard_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pol_params, _, metrics, _ = mc_pilco(
            x0_pool, dyn, pol, MAIN_T, dyn_params, dyn_stats, pol_params,
            opt_iters=iters, init_state_noise=init_noise, n_particles=B,
            seed=SEED, chunk=1, mesh=mesh, fused_rollout=fused,
            optimizer=functools.partial(torch.optim.SGD, lr=SHARD_OPTION_LR),
            clip_grad=None,
            on_iteration=lambda done, m: stamps.append(time.perf_counter()),
            **options, **kw)
        torch.cuda.synchronize()
    finally:
        native.make_sum_tree = make_tree
    launches, all_reduces = shard_counts()
    kept = (pol_params, state)
    return dict(tier=tier, losses=metrics['loss'],
                rets=metrics['mean_return'], v_losses=metrics.get('v_loss'),
                scores=metrics.get('priority_scores'),
                params=on_host(tree_leaves(pol_params)),
                moved=[(p - q).detach().cpu() for p, q in
                       zip(tree_leaves(pol_params), start)],
                critic=None if state is None
                else on_host(tree_leaves(state['params'])),
                drawn=drawn, launches=launches, all_reduces=all_reduces,
                all_gathers=tpar.COLLECTIVES['all_gather'],
                ms=float(np.median(np.diff([t0] + stamps)) * 1e3),
                same=mesh is None or tpar.same_on_every_rank(kept, mesh))


def hold_option(tag, got, ref, iters=SHARD_OPTION_ITERS):
    """A rank's phase 11f run held against the unsharded one with the CPU
    tests' tolerances (``tests/test_torch_parallel_options.py``): the first
    loss rtol 1e-5 / atol 1e-6 (one call), every loss and mean return rtol
    1e-3 / atol 1e-6, the policy's params within 2 lr a step and their
    change (lr times the sum of the gradients: SGD, no clipping) within
    1e-6 + 1e-3 of its max (the gradients' rule), v_losses rtol 1e-3 and
    the critic's params within 2 VALUE_LR an Adam step (the sums' other
    order moves rounding-level gradient entries, which Adam turns into
    steps of up to lr), priority scores rtol 1e-3 / atol 1e-4 of their
    max, the sum tree's drawn leaves equal. Returns the largest relative
    error of the losses."""
    np.testing.assert_allclose(got['losses'][0], ref['losses'][0], rtol=1e-5,
                               atol=1e-6, err_msg=f'{tag} first loss')
    for key in ('losses', 'rets') + (('v_losses',) if ref['v_losses']
                                     is not None else ()):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-3, atol=1e-6,
                                   err_msg=f'{tag} {key}')
    scale = max(float(m.abs().max()) for m in ref['moved'])
    err = max(float((a - b).abs().max())
              for a, b in zip(got['moved'], ref['moved']))
    if not (scale > 0 and err <= 1e-6 + 1e-3 * scale):
        raise AssertionError(f'[{tag}] the params\' change {err:.3e} from '
                             f'the unsharded one\'s (its max {scale:.3e})')
    for key, lr in (('params', SHARD_OPTION_LR), ('critic', VALUE_LR)):
        for a, b in zip(got[key] or (), ref[key] or ()):
            err = float((a - b).abs().max())
            if err > 2 * lr * iters:
                raise AssertionError(f'[{tag}] {key} {err:.3e} apart, beyond '
                                     f'2 lr a step ({2 * lr * iters:.1e})')
    if ref['scores'] is not None:
        d = np.abs(got['scores'] - ref['scores'])
        i = np.unravel_index(np.argmax(d / np.abs(ref['scores'])), d.shape)
        log(f'[{tag}] priority scores: worst relative error '
            f'{float(d[i] / abs(ref["scores"][i])):.3e} at (iteration, '
            f'group) {tuple(int(j) for j in i)}')
        np.testing.assert_allclose(got['scores'], ref['scores'], rtol=1e-3,
                                   atol=1e-4 * np.abs(ref['scores']).max(),
                                   err_msg=f'{tag} priority scores')
    for a, b in zip(got['drawn'], ref['drawn']):
        np.testing.assert_array_equal(a, b, err_msg=f'{tag} tree draws')
    if len(got['drawn']) != len(ref['drawn']):
        raise AssertionError(f'[{tag}] {len(got["drawn"])} tree draws, '
                             f'unsharded {len(ref["drawn"])}')
    return float(np.max(np.abs(got['losses'] - ref['losses'])
                        / np.abs(ref['losses'])))


def shard_options(ranks, card):
    """Phase 11f: each of SHARD_OPTIONS in one ``mc_pilco`` call of
    SHARD_OPTION_ITERS iterations on the 2 ranks (``option_rank``) and the
    same call unsharded on the card, here: the ``utils.rollout`` route on
    both (the gate gives none of these options a fused tier under a mesh;
    the unsharded call is forced to the route), the same launches on each
    rank as unsharded (every MLP call through the fused MLP), losses and
    the params' bits (the critic state's too) the same on both ranks, each
    rank held against the unsharded run (``hold_option``); the all-reduces
    and all-gathers an iteration and the ms an iteration beside the
    unsharded run's. Returns the value update's (launches, all-reduces) an
    iteration, for the with-value episode."""
    tag = 'phase 11f'
    per_iter = None
    for name, options, B, critic_kind in SHARD_OPTIONS:
        what = (f'{name} B={B}' + (f' ({critic_kind} critic)'
                                   if critic_kind else ''))
        ref = option_rank(None, options, B, critic_kind)
        outs = ranks.run(option_rank, options, B, critic_kind,
                         timeout=SHARD_TIMEOUT)
        worst = 0.0
        for rank, o in enumerate(outs):
            if o['tier'] is not None or ref['tier'] is not None:
                raise AssertionError(f'[{tag}] {what}: tier {o["tier"]!r}, '
                                     'expected the utils.rollout route')
            if o['launches'] != ref['launches'] or \
                    not o['launches']['fused_mlp_fwd']:
                raise AssertionError(f'[{tag}] {what} rank {rank}: launches '
                                     f'{o["launches"]}, unsharded '
                                     f'{ref["launches"]}')
            if not (o['same'] and np.array_equal(o['losses'],
                                                 outs[0]['losses'])):
                raise AssertionError(f'[{tag}] {what}: the ranks\' losses or '
                                     'params differ')
            worst = max(worst, hold_option(f'{tag} {what} rank {rank}', o,
                                           ref))
        it = SHARD_OPTION_ITERS
        o = outs[0]
        log(f'[{tag}] {what} on 2 ranks sharing one card, T={MAIN_T}: loss '
            f'first {o["losses"][0]:.6e} last {o["losses"][-1]:.6e}, max '
            f'relative error of the losses against the unsharded run '
            f'{worst:.3e} (first rtol 1e-5, then 1e-3)'
            + (f', v_loss last {o["v_losses"][-1]:.6e}'
               if o['v_losses'] is not None else '')
            + (f', tree draws equal ({len(o["drawn"])})' if o['drawn']
               else '') + '; the params\' bits'
            + (' and the critic state\'s' if critic_kind else '')
            + ' the same on both ranks; launches an iteration: fused MLP '
            f'{o["launches"]["fused_mlp_fwd"] // it} forward, '
            f'{o["launches"]["fused_mlp_bwd"] // it} backward (as unsharded);'
            f' {o["all_reduces"] / it:g} all-reduces and '
            f'{o["all_gathers"] / it:g} all-gathers an iteration; '
            f'{outs[0]["ms"]:.3f} / {outs[1]["ms"]:.3f} ms an iteration on '
            f'ranks 0 / 1, unsharded {ref["ms"]:.3f} (host clock, '
            f'synchronised each iteration); {card}')
        if critic_kind == 'update':
            per_iter = ({k: v // it for k, v in o['launches'].items()},
                        o['all_reduces'] // it)
    return per_iter


def value_shard_episode(ranks, card, per_iter):
    """Phase 11f's episode: one ``deep_pilco_no_mm_with_value --n_devices 2
    --dist_backend gloo`` episode cut as phase 11e's (SHARD_FIT_ITERS fit
    steps, SHARD_POL_ITERS policy iterations) on the ``utils.rollout``
    route: exact launches and all-reduces on each rank (one fused-MLP
    forward and backward and one all-reduce a fit step, rank 0's control
    steps, and a policy iteration's ``per_iter`` of phase 11f's value
    update), every value finite, the critic's params the same bits on both
    ranks after the episode (as the driver's own check saw them), one
    results folder, written by rank 0."""
    tag = 'phase 11f episode'
    root = Path(__file__).resolve().parent / 'build'
    root.mkdir(exist_ok=True)
    folder = tempfile.mkdtemp(prefix='chip_smoke_shard_value_', dir=root)
    try:
        argv = EPISODE_ARGV + [
            '--ps_iters', '1', '--dyn_opt_iters', str(SHARD_FIT_ITERS),
            '--pol_opt_iters', str(SHARD_POL_ITERS), '--n_devices',
            str(ranks.n), '--dist_backend', 'gloo']
        t0 = time.perf_counter()
        outs = ranks.run(driver_rank, argv, folder, dvm.SETTINGS,
                         timeout=SHARD_TIMEOUT)
        wall = time.perf_counter() - t0
        results = outs[0][3]
        written = sorted(str(Path(d).relative_to(folder))
                         for d, _, fs in os.walk(folder)
                         if 'latest_critic.pkl' in fs)
        if written != [str(Path(results).relative_to(folder))]:
            raise AssertionError(f'[{tag}] results written to {written}')
        (r,) = outs[0][4]
        exp = ExperienceDataset()
        exp.load(str(Path(results) / 'experience.pkl'))
        steps = sum(len(ep) for ep in exp.states)
        launches_it, reduces_it = per_iter
        for rank, (launches, all_reduces, _, res, _, crit) in enumerate(outs):
            want = {k: SHARD_POL_ITERS * v for k, v in launches_it.items()}
            want['fused_mlp_fwd'] += SHARD_FIT_ITERS + (steps if rank == 0
                                                        else 0)
            want['fused_mlp_bwd'] += SHARD_FIT_ITERS
            reduces = SHARD_FIT_ITERS + SHARD_POL_ITERS * reduces_it
            if launches != want or all_reduces != reduces or res != results:
                raise AssertionError(f'[{tag}] rank {rank}: launches '
                                     f'{launches}, {all_reduces} all-reduces;'
                                     f' expected {want}, {reduces}')
            for a, b in zip(crit, outs[0][5]):
                if not torch.equal(a, b):
                    raise AssertionError(f'[{tag}] the ranks\' critics '
                                         'differ')
        pm = r['pol_metrics']
        if not all(np.all(np.isfinite(v)) for v in (
                r['dyn_metrics']['loss'], pm['loss'], pm['mean_return'],
                pm['v_loss'])):
            raise AssertionError(f'[{tag}] a value is not finite')
        log(f'[{tag}] deep_pilco_no_mm_with_value {" ".join(argv[-6:])} on '
            f'{ranks.n} gloo ranks sharing one card: one episode in '
            f'{wall:.3f} s on the utils.rollout route (the critic refit on '
            f'the fused MLP, its loss and grads all-reduced); E_lml '
            f'{r["E_lml"]:.6f}, v_loss first {pm["v_loss"][0]:.6e} last '
            f'{pm["v_loss"][-1]:.6e}, imagined return '
            f'{r["imagined_return"]:.6f}, real {r["real_return"]:.6f}; fit '
            f'{1e3 * r["fit_s"] / SHARD_FIT_ITERS:.4f} ms a step, policy '
            f'{1e3 * r["pol_s"] / SHARD_POL_ITERS:.4f} ms an iteration; '
            f'launches rank 0 {outs[0][0]}, rank 1 {outs[1][0]} (expected); '
            f'the critic\'s {sum(t.numel() for t in outs[0][5])} params the '
            f'same bits on both ranks; one results folder, written by rank 0;'
            f' {card}')
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def phase_sharded(card, capacity):
    """Phase 11: particle sharding over gloo ranks that share the one card
    (NCCL refuses two ranks on one device), spawned once for the phase.
    11a K8 (``k8_case``) in each of K8_CASES; 11b phase 5g's ``mc_pilco``
    call on 2 ranks (ITERS iterations on K8: exactly one ``fused_rollout_vg``
    and one all-reduce an iteration on each rank; the first 4 losses
    against phase 5g's; ms an iteration beside 5g's); 11c phase 3's
    ungrouped route on 2 ranks (SHARD_ROUTE_ITERS iterations: the fused MLP
    2 T times each way an iteration, 4 T + 4 all-reduces an iteration: the
    moments' two sums a step forward and backward but for the last step's,
    whose states no loss reads, the reward mean and the loss each way,
    mean_return and the grads; losses against phase 3's); 11d the step
    tier per rank at twice phase 4g's batch (T launches of each step kernel
    and one all-reduce an iteration); 11e the driver (``shard_episode``);
    11f each option of the ``utils.rollout`` route on 2 ranks against the
    same call unsharded (``shard_options``), then the with-value driver's
    episode (``value_shard_episode``). What this cannot show: ranks that share a card measure no multi-card
    speed, and NCCL is not run."""
    T = MAIN_T
    log(f'[phase 11] torch.cuda.device_count() = '
        f'{torch.cuda.device_count()}: gloo ranks share card 0')
    with tpar.Ranks(4, 'gloo', 'cuda', timeout=SHARD_TIMEOUT) as ranks4, \
            tpar.Ranks(2, 'gloo', 'cuda', timeout=SHARD_TIMEOUT) as ranks2:
        for n, groups, mm, components in K8_CASES:
            k8_case(ranks2 if n == 2 else ranks4, n, groups, mm, card,
                    components)
        ms = sharded_run(ranks2, 'phase 11b', f'mc_pilco mm_groups='
                         f'{GROUPS_MAIN}', ITERS, GROUPS_MAIN, None, MAIN_B,
                         'full', expect(fused_rollout_vg=ITERS), ITERS,
                         against=('phase 5g', 4))
        log(f'[phase 11b] {ms[0]:.3f} / {ms[1]:.3f} ms an iteration on ranks '
            f'0 / 1 (each on {MAIN_B // 2} particles; the ranks share one '
            f'card and all-reduce through the host), unsharded '
            f'{ITER_MS["phase 5g"]:.3f} (phase 5g, this call); {card}')
        it = SHARD_ROUTE_ITERS
        ms = sharded_run(ranks2, 'phase 11c', 'mc_pilco fused_rollout=False '
                         '(ungrouped MM, all-reduced moments)', it, None,
                         False, MAIN_B, None, expect(
                             fused_mlp_fwd=2 * T * it,
                             fused_mlp_bwd=2 * T * it), (4 * T + 4) * it,
                         against=('phase 3', it))
        log(f'[phase 11c] {ms[0]:.3f} / {ms[1]:.3f} ms an iteration on ranks '
            f'0 / 1, unsharded {ITER_MS["phase 3"]:.3f} (phase 3); {card}')
        big = 2 * (capacity // 10 + 1) * 10
        ms = sharded_run(ranks2, 'phase 11d', f'mc_pilco mm_groups='
                         f'{big // 10}', STEP_ROUTE_ITERS, big // 10, None,
                         big, 'step', expect(
                             fused_step_fwd=T * STEP_ROUTE_ITERS,
                             fused_step_bwd=T * STEP_ROUTE_ITERS),
                         STEP_ROUTE_ITERS)
        log(f'[phase 11d] B={big} in {big // 10} groups on 2 ranks ('
            f'{big // 2} particles each, beyond the {capacity} the card holds '
            f'of the whole-rollout kernel): {ms[0]:.3f} / {ms[1]:.3f} ms an '
            f'iteration, unsharded B={big // 2} {ITER_MS["phase 4g"]:.3f} '
            f'(phase 4g); {card}')
        shard_episode(ranks2, card)
        t0 = time.perf_counter()
        per_iter = shard_options(ranks2, card)
        log(f'[phase 11f] the {len(SHARD_OPTIONS)} option calls took '
            f'{time.perf_counter() - t0:.3f} s')
        value_shard_episode(ranks2, card, per_iter)


# ---------------------------------------------------------------------------
# phase 12: model-based DDPG; phase 13: the conditional density networks
# ---------------------------------------------------------------------------

DDPG_B = 100  # the driver's --dyn_batch_size, DDPG's minibatch
DDPG_T = MAIN_T  # the driver's --pred_H, the imagined horizon
DDPG_ITERS = 20  # iterations timed on the host clock
DDPG_PROFILED = 3  # iterations under torch.profiler
DDPG_ARGV = ['--seed', str(SEED), '--ps_iters', '1', '--n_rnd_epi', '2',
             '--dyn_opt_iters', '500', '--fit_iters', '20']
DENSITY_STEPS = 5  # train_model steps held against the unfused MLP
DENSITY_BATCH = 100
BNN_ITERS = 200  # the BNN regression drivers' steps a model


def clone_tree(tree):
    return tree_map(torch.clone, tree)


def hold_lr(what, a, r, moved, steps, lr, weight=1.0, tag='phase 12'):
    """Hold params (``weight`` 1) or a polyak target (``weight`` tau) after
    ``steps`` Adam steps, kernel ``a`` vs plain ``r`` (flat), by the lr rule
    of ``hold_adam``: a gradient entry at rounding level can move an entry
    by up to lr a step more in one version than in the other, so each entry
    lies within 2 weight lr a step, and at most one in ADAM_EDGE beyond
    weight lr ADAM_TOL a step, or 3 times the plain path's own move under
    inputs moved by 1e-6 relative (``moved``), or two float32 ulps of the
    entry. Returns the largest |a - r| / (weight lr steps)."""
    if not torch.isfinite(a).all():
        raise AssertionError(f'{what}: kernel output is not finite')
    unit = weight * lr * steps
    d = (a - r).abs()
    if float(d.max()) > 2 * unit:
        raise AssertionError(f'{what}: an entry {float(d.max()):.3e} from '
                             f'the plain version, beyond 2 lr a step')
    room = torch.maximum(3 * (moved - r).abs(), 2.4e-7 * r.abs())
    edge = (d > ADAM_TOL * unit + room).nonzero().flatten().tolist()
    if len(edge) * ADAM_EDGE > d.numel():
        raise AssertionError(f'{what}: {len(edge)} of {d.numel()} entries '
                             f'beyond {ADAM_TOL:g} lr a step and the plain '
                             'path\'s sensitivity')
    for i in edge:
        log(f'[{tag}] {what}: entry {i} of {d.numel()} '
            f'{float(d[i]) / unit:.3e} lr a step from the plain version')
    return float(d.max()) / unit


def hold_value(what, a, r, m, tag):
    """A scalar (or a trace of them) of the kernel path ``a`` against the
    plain path ``r``: within 1e-4 of its size or 3 times the plain path's
    own move ``m`` under inputs moved by 1e-6 relative. Returns the
    largest error."""
    a, r, m = (np.atleast_1d(np.asarray(x, np.float64)) for x in (a, r, m))
    err = np.abs(a - r)
    tol = np.maximum(1e-4 * np.abs(r), 3 * np.abs(m - r))
    if not (np.all(np.isfinite(a)) and np.all(err <= tol)):
        raise AssertionError(f'[{tag}] {what}: kernel {a} plain {r} '
                             f'(tolerance {tol})')
    return float(err.max())


def hold_moments(what, a, r, m, tag):
    """Adam's (or RAdam's) first moment after the steps, in the states that
    the path under test (``a``) and the reference (``r``) returned, leaf by
    leaf by ``hold``: within REL_TOL of the leaf's max|r| or 3 times
    max|m - r|, ``m`` a second reference run that measures the reference's
    own error (the plain path on inputs moved by 1e-6 relative; or, where
    ``r`` is the step in float64, the same step in float32). After one
    step from a fresh state it is 0.1 times the gradient that the step
    used; the params alone do not see a wrong gradient, since Adam's first
    step moves an entry by about lr whatever the gradient's size, and not at
    all when a leaf's gradient is scaled by a constant. Returns the largest
    error / max|r| over the leaves, and logs the leaf that has it with the
    reference's own error there."""
    names = [n for n, _ in flat_leaves(a.mu)]
    leaves = zip(*(tree_leaves(s.mu) for s in (a, r, m)))
    f32 = (lambda t: t.to('cpu', torch.float32))
    errs = [(hold(f'[{tag}] {what} first moment, leaf {i}', f32(x), f32(y),
                  REL_TOL, moved=f32(z))[1], rel_err(f32(z), f32(y)), i)
            for i, (x, y, z) in enumerate(leaves)]
    worst, own, i = max(errs)
    log(f'[{tag}] {what} first moment: worst leaf {names[i]} ({worst:.3e} '
        f'of its max|reference|; the reference\'s own error there '
        f'{own:.3e})')
    return worst


def flat(tree):
    return torch.cat([t.detach().reshape(-1) for t in tree_leaves(tree)])


def ddpg_setup(seed=SEED):
    """MBDDPG's models at the driver's widths on Cartpole (D = 5, U = 1,
    learned reward), seeded params and fresh Adam states, the dynamics'
    stats and a 4096-state pool from two 40-step random episodes."""
    env = envs.make('Cartpole', device='cuda')
    env.seed(seed)
    rnd = np.random.RandomState(seed)
    exp = ExperienceDataset()
    for _ in range(2):
        exp.append_episode(*apply_controller(
            env, lambda x, t=0: rnd.uniform(env.action_space.low,
                                            env.action_space.high), 40))
    D, U = env.observation_size, env.action_size
    actor, critic, dyn = (ddpg.make_actor(D, U, 10.0),
                          ddpg.make_critic(D, U), ddpg.make_dyn_model(D, U))
    X, Y = exp.get_dynmodel_dataset(deltas=True, return_costs=True)
    gen = seeded_generator('cuda', seed, 12)
    ap, cp, dp = (m.init(gen, device='cuda') for m in (actor, critic, dyn))
    opt = Adam(1e-3)
    state = (ap, clone_tree(ap), opt.init(ap), cp, clone_tree(cp),
             opt.init(cp), critic.init_stats(device='cuda'), dp,
             dyn.fit_stats(torch.tensor(X, device='cuda'),
                           torch.tensor(Y, device='cuda')))
    pool = torch.tensor(exp.sample_states(4096, timestep=None, rng=rnd),
                        device='cuda')
    return (actor, critic, dyn), state, pool, gen


def ddpg_iteration(models, state, pool, noise, fused=True, scale=1.0):
    """One iteration of ``make_ddpg_iteration_fn`` on copies of ``state``
    (``fused=False``: every MLP on the unfused path; ``scale``: the pool
    scaled) with ``noise``: (flat actor, actor target, critic, critic
    target, metrics)."""
    if not fused:
        models = tuple(fr.unfused(m) for m in models)
    it = ddpg.make_ddpg_iteration_fn(*models, Adam(1e-3), Adam(1e-3),
                                     DDPG_T, DDPG_B)
    out = it(*clone_tree(state), pool * scale, noise=noise)
    return [flat(out[i]) for i in (0, 1, 3, 4)], {
        k: float(v) for k, v in out[6].items()}


def check_ddpg_iteration(models, state, pool, gen, card):
    """Phase 12's iteration: launch counts of one iteration through the
    kernels (fused-MLP forward 7 T, backward 3 T), its metrics and params
    against the same iteration on unfused MLPs with the same draws, the ms
    an iteration over DDPG_ITERS, and the device's busy share over
    DDPG_PROFILED iterations under torch.profiler."""
    actor, critic, dyn = models
    noise = ddpg.draw_ddpg_noise(gen, actor, critic, dyn, DDPG_T, DDPG_B,
                                 pool.shape[0], 'cuda')
    reset_counts()
    torch.cuda.synchronize()
    got, gm = ddpg_iteration(models, state, pool, noise)
    torch.cuda.synchronize()
    launches = counts()
    want = expect(fused_mlp_fwd=7 * DDPG_T, fused_mlp_bwd=3 * DDPG_T)
    log(f'[phase 12] one DDPG iteration (B={DDPG_B}, T={DDPG_T}, '
        f'{DDPG_T} minibatches): launches {launches} (expected {want})')
    if launches != want:
        raise AssertionError('launch counts of the DDPG iteration differ')
    reset_counts()
    ref, rm = ddpg_iteration(models, state, pool, noise, fused=False)
    moved, mm = ddpg_iteration(models, state, pool, noise, fused=False,
                               scale=1 + 1e-6)
    if counts() != expect():
        raise AssertionError('the unfused iteration launched a kernel')
    for k in gm:
        err = hold_value(k, gm[k], rm[k], mm[k], 'phase 12')
        log(f'[phase 12] {k}: kernel {gm[k]:.7g} plain {rm[k]:.7g} (err '
            f'{err:.3e})')
    names = ('actor', 'actor target', 'critic', 'critic target')
    worst = [hold_lr(n, a, r, m, DDPG_T, 1e-3, 0.005 if 'target' in n
                     else 1.0) for n, a, r, m in zip(names, got, ref, moved)]
    log('[phase 12] params after the sweep\'s ' + str(DDPG_T) + ' Adam steps, '
        'kernel vs plain, largest |a - r| in lr a step: '
        + ', '.join(f'{n} {w:.3e}' for n, w in zip(names, worst)))
    it = ddpg.make_ddpg_iteration_fn(*models, Adam(1e-3), Adam(1e-3),
                                     DDPG_T, DDPG_B)
    s = clone_tree(state)
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DDPG_ITERS):
        s = it(*s[:6], *state[6:], pool, generator=gen)[:6]
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    ms = float(np.median(np.diff([t0] + stamps)) * 1e3)
    ITER_MS['phase 12'] = ms
    log(f'[phase 12] {ms:.3f} ms a DDPG iteration (median of {DDPG_ITERS}, '
        f'host clock, synchronised each; {10 * DDPG_T} fused-MLP launches '
        f'each); {card}')

    def iterations():
        r = s
        for _ in range(DDPG_PROFILED):
            r = it(*r[:6], *state[6:], pool, generator=gen)[:6]

    device_profile('phase 12', 'DDPG', iterations, DDPG_PROFILED,
                   'iteration')


def check_q_rollout(models, state, pool, gen):
    """``rollout_with_Qvalues`` with the critic at B = DDPG_B, T = DDPG_T
    through the kernels (fused-MLP forward 3 T + 2, no backward) against
    the unfused MLPs on the same draws: states, actions, rewards and
    Q-values within STEP_TOL of their max|plain| or 3 times the plain
    path's sensitivity to x0 moved by 1e-6 relative."""
    actor, critic, dyn = models
    ap, cp, cstats, dp, dstats = state[0], state[3], state[6], state[7], \
        state[8]
    x0 = pool[:DDPG_B]
    dn = dyn.sample_noise(gen, (DDPG_B,), device='cuda')
    an = actor.sample_noise(gen, (DDPG_B,), device='cuda')
    qn = critic.sample_noise(gen, (DDPG_B,), device='cuda')

    def run(fused, scale=1.0):
        a, c, d = models if fused else tuple(fr.unfused(m) for m in models)
        with torch.no_grad():
            return rollout_with_Qvalues(x0 * scale, d, a, DDPG_T, c, dp,
                                        dstats, ap, dn, an, cp, cstats, qn)

    reset_counts()
    got = run(True)
    torch.cuda.synchronize()
    launches = counts()
    want = expect(fused_mlp_fwd=3 * DDPG_T + 2)
    if launches != want:
        raise AssertionError(f'rollout_with_Qvalues launched {launches}, '
                             f'expected {want}')
    ref, moved = run(False), run(False, 1 + 1e-6)
    errs = [hold(f'rollout_with_Qvalues {n}', g, r, STEP_TOL, m)[1]
            for n, g, r, m in zip(('states', 'actions', 'rewards',
                                   'qvalues'), got, ref, moved)]
    if got[3].shape != (DDPG_T + 1, DDPG_B, 1):
        raise AssertionError(f'qvalues of shape {tuple(got[3].shape)}')
    log(f'[phase 12] rollout_with_Qvalues B={DDPG_B} T={DDPG_T}: launches '
        f'{launches}; kernel vs plain, max err / max|plain|: states '
        f'{errs[0]:.3e}, actions {errs[1]:.3e}, rewards {errs[2]:.3e}, '
        f'qvalues {errs[3]:.3e}')


def phase_ddpg(card):
    """Phase 12: model-based DDPG at the driver's widths (``ddpg_setup``):
    one iteration held against the unfused MLPs and timed, the Q-value
    rollout held the same way, then one episode of the MBDDPG driver
    (``DDPG_ARGV``: 500 fit steps, 20 DDPG iterations of T = 15, every
    other flag at its default, 40 control steps), its launch
    counts exact (fused-MLP forward 500 + 20 * 7 T + the control steps,
    backward 500 + 20 * 3 T). Returns the episode's launch counts."""
    models, state, pool, gen = ddpg_setup()
    check_ddpg_iteration(models, state, pool, gen, card)
    check_q_rollout(models, state, pool, gen)
    root = Path(__file__).resolve().parent / 'build'
    root.mkdir(exist_ok=True)
    folder = tempfile.mkdtemp(prefix='chip_smoke_mbddpg_', dir=root)
    try:
        argv = DDPG_ARGV + ['-o', folder]
        args = ddpg_driver.get_parser().parse_args(argv)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent, returns, results = ddpg_driver.main(argv, device='cuda')
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        exp = ExperienceDataset()
        exp.load(str(Path(results) / 'experience.pkl'))
        steps = len(exp.states[-1])
        iters = args.fit_iters * args.ps_iters
        fits = args.dyn_opt_iters * args.ps_iters
        want = expect(fused_mlp_fwd=fits + 7 * args.pred_H * iters + steps,
                      fused_mlp_bwd=fits + 3 * args.pred_H * iters)
        log(f'[phase 12] mbddpg episode: {fits} fit steps, {iters} DDPG '
            f'iterations (T={args.pred_H}), {steps} control steps in '
            f'{wall:.3f} s (host clock); real return {returns[-1]:.6f}; '
            f'launches {launches} (expected {want}); {card}')
        if launches != want:
            raise AssertionError('launch counts of the mbddpg episode differ')
        if not (np.all(np.isfinite(returns))
                and torch.isfinite(flat(agent.critic_params)).all()):
            raise AssertionError('non-finite return or critic params')
        return launches
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def density_case(name, model, X, Y, card):
    """``train_model`` for DENSITY_STEPS steps at batch DENSITY_BATCH
    through the kernels (one fused-MLP forward and one backward a step)
    against the unfused MLP on the same indices and noise: loss and E_lml
    of each step within 1e-4 of their size or 3 times the plain path's
    sensitivity to the inputs moved by 1e-6 relative, the params by the lr
    rule (``hold_lr``)."""
    gen = seeded_generator('cuda', SEED, 13)
    params = model.init(gen, device='cuda')
    scaling = model.fit_scaling(X, Y)
    n = DENSITY_STEPS
    idx = torch.randint(0, X.shape[0], (n, DENSITY_BATCH), generator=gen,
                        device='cuda')
    noise = model.sample_noise(gen, (n, DENSITY_BATCH), device='cuda')

    def run(m, scale=1.0):
        p, _, metrics = train_model(m, clone_tree(params), scaling, X * scale,
                                    Y, iters=n, batchsize=DENSITY_BATCH,
                                    idx=idx, noise=noise)
        return flat(p), metrics

    if not model.mlp._kernel_takes_it():
        raise AssertionError(f'{name}: the fused MLP does not take it')
    reset_counts()
    got, gm = run(model)
    torch.cuda.synchronize()
    launches = counts()
    want = expect(fused_mlp_fwd=n, fused_mlp_bwd=n)
    if launches != want:
        raise AssertionError(f'{name}: launches {launches}, expected {want}')
    plain = fr.unfused(model)
    (ref, rm), (moved, mm) = run(plain), run(plain, 1 + 1e-6)
    for k in ('loss', 'E_lml'):
        hold_value(f'{name} {k}', gm[k], rm[k], mm[k], 'phase 13')
    worst = hold_lr(f'{name} params', got, ref, moved, n, 1e-4,
                    tag='phase 13')
    log(f'[phase 13] {name}: train_model {n} steps at batch '
        f'{DENSITY_BATCH}, launches {launches}; loss {gm["loss"][0]:.6f} -> '
        f'{gm["loss"][-1]:.6f} (plain {rm["loss"][-1]:.6f}), params within '
        f'{worst:.3e} lr a step of the plain version')


def relu_density_models(outputs):
    """The BNN drivers' two networks (``bnn_regression.build_models``) with
    relu in place of hhSinLU, which the fused MLP takes."""
    return [('GaussianDN', density_network_mlp(
                1, outputs, hids=(200, 200), dropout=0.1, activation='relu')),
            ('GaussianMDN', mixture_density_network_mlp(
                1, outputs, nc=5, hids=(200, 200), dropout=0.1,
                activation='relu'))]


def phase_density(card):
    """Phase 13: the conditional density networks. ``train_model`` with
    ``density_network_mlp`` (GaussianDN) and ``mixture_density_network_mlp``
    (GaussianMDN, 5 components) at relu [200, 200] on each BNN regression
    dataset, held against the unfused MLP (``density_case``); then both
    drivers' ``main`` at BNN_ITERS steps a model, whose hhSinLU MLPs the
    gate keeps off the kernels: no launch, their NLL and ms a step."""
    for data, D in ((bnn.make_dataset, 1), (bnn2.make_dataset, 2)):
        X, Y = data(device='cuda')
        for name, model in relu_density_models(D):
            density_case(f'{name} relu, {D}-D data', model, X, Y, card)
    for driver, D in ((bnn, 1), (bnn2, 2)):
        models = bnn.build_models(D)
        takes = [m.mlp._kernel_takes_it() for _, m in models]
        log(f'[phase 13] {driver.__name__.rsplit(".", 1)[1]}: activation '
            f'{models[0][1].mlp.nonlin[0]!r}; the fused MLP takes it: {takes}'
            ' (the unfused path)')
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = driver.main(iters=BNN_ITERS, plot=False, device='cuda')
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        if any(takes) or launches != expect():
            raise AssertionError(f'launches {launches}: the hhSinLU MLPs '
                                 'reached a kernel')
        nll = {k: v[3] for k, v in results.items()}
        if not all(np.isfinite(v) for v in nll.values()):
            raise AssertionError(f'non-finite NLL {nll}')
        log(f'[phase 13] {driver.__name__.rsplit(".", 1)[1]}: '
            f'{BNN_ITERS} steps a model, NLL '
            + ', '.join(f'{k} {v:.4f}' for k, v in nll.items())
            + f'; {1e3 * wall / (len(results) * BNN_ITERS):.4f} ms a step '
            f'(host clock, {wall:.3f} s); fused-MLP launches {launches}; '
            f'{card}')


# ---------------------------------------------------------------------------
# phase 14: the sequence-model driver, model ensembles and the optimisers
# ---------------------------------------------------------------------------

TM_ARGV = ['--seed', str(SEED), '--ps_iters', '1', '--dyn_opt_iters', '100',
           '--pol_opt_iters', '20']
TM_PROFILED = 3  # policy steps under torch.profiler
ENS_K = 5  # members: PETS's ensemble size (Chua et al. 2018)
ENS_B = 100
ENS_STEPS = 50
OPT_STEPS = 20  # train_regressor steps with each optimiser
OPT_LR = 1e-4  # the ensemble's Adam, the fit's default
SDLBFGS_TOL = 1e-3  # |a - r| / |r - p0| of SdLBFGS's params


def random_episodes(env):
    """Two 40-step episodes of uniformly random actions on ``env``, seeded
    with SEED."""
    env.seed(SEED)
    rnd = np.random.RandomState(SEED)
    exp = ExperienceDataset()
    for _ in range(2):
        exp.append_episode(*apply_controller(
            env, lambda x, t=0: rnd.uniform(env.action_space.low,
                                            env.action_space.high), 40))
    return exp


def tm_setup(trained):
    """The transformer_models driver's models at its widths on Cartpole
    (D = 5, U = 1; a transformer of 64 wide, 4 layers of 4 heads; the
    [64, 64] policy; a flow of 4 blocks x 64) with the params and the last
    iteration's scaling of ``trained`` (the (params, history) of a
    ``transformer_models.main`` run); a dynamics batch from the windows of
    ``random_episodes``, their x0s, and 25 x0s drawn from the flow."""
    args = tmd.get_parser().parse_args(TM_ARGV)
    env = envs.make('Cartpole', device='cuda')
    m = tmd.build(env, args, 'cuda')
    params, scaling = trained[0], trained[1][-1]['scaling']
    exp = random_episodes(env)
    S, A, NS, R, DN, L = (torch.as_tensor(v, device='cuda') for v in
                          tmd.sliding_windows(exp, args.window))
    gen = seeded_generator('cuda', SEED, 14)
    idx = torch.randint(0, S.shape[0], (tmd.DYN_BATCH,), generator=gen,
                        device='cuda')
    batch = [v[idx] for v in (S, A, NS, R, DN, L)]
    x0s = torch.tensor(np.stack([np.asarray(ep[0]) for ep in exp.states]),
                       dtype=torch.float32, device='cuda')
    x0 = m['flow'].sample(params['flow'], gen, tmd.N_X0).detach()
    return env, args, m, params, scaling, batch, x0s, x0, gen


def check_tm_steps(setup, card, tag='phase 14a', dump=None):
    """On ``tm_setup``'s models (trained ones: an unfitted transformer's
    rollouts amplify float32 rounding ~1000-fold, so Adam's first step
    turns more near-zero gradient entries into +-lr steps of opposite
    signs): one policy step through the kernels (exactly pred_H fused-MLP
    forward and backward launches) against the same step with the policy
    unfused on the same draws: loss by ``hold_value``, the gradient the
    step used by ``hold_moments``, params by ``hold_lr``; then one dynamics
    step and one flow step against the same steps on CPU tensors (TF32
    off), held the same way, but for the gradient: a float32 transformer
    on the CPU and on the card round differently, by up to 1.6e-4 of a
    leaf's max after a short fit, so the card's gradient is held against
    the step in float64 on the CPU, within 3 times the CPU float32 step's
    own distance from it (the key bias's exact gradient is 0, the
    attention's softmax being blind to it, so Adam moves its entries by
    +-lr on rounding noise: ``hold_lr`` allows one entry in ADAM_EDGE).
    Logs the policy step's device-busy share under torch.profiler over
    TM_PROFILED steps.; ``dump``: a path to
    which the dynamics step's inputs are saved (``torch.save``) for
    ``tools/torch_transformer_precision.py --inputs``"""
    env, args, m, params, scaling, batch, x0s, x0, gen = setup
    D, U, T = env.observation_size, env.action_size, args.pred_H
    dyn, pol_spec = m['dyn'], m['pol_spec']
    draws = tmd.draw_rollout_noise(gen, dyn, pol_spec, tmd.N_X0, T, 'cuda')
    low, high = (torch.tensor(np.asarray(b, np.float32), device='cuda')
                 for b in (env.action_space.low, env.action_space.high))
    pspec_u, papply_u = tmd.make_policy(D, U, (low, high), fused=False)

    def pol(fused=True, scale=1.0):
        step = m['pol_step'] if fused else tmd.make_pol_step(
            dyn, pspec_u, papply_u, Adam(1e-3), T)
        p = clone_tree(params['pol'])
        out, state, loss = step(p, Adam(1e-3).init(p), params['dyn'],
                                scaling, x0 * scale, draws=draws)
        return flat(out), state, float(loss)

    reset_counts()
    torch.cuda.synchronize()
    got, gs, gl = pol()
    torch.cuda.synchronize()
    launches = counts()
    want = expect(fused_mlp_fwd=T, fused_mlp_bwd=T)
    if launches != want:
        raise AssertionError(f'[{tag}] pol step launches {launches}, '
                             f'expected {want}')
    (ref, rs, rl), (moved, vs, ml) = pol(False), pol(False, 1 + 1e-6)
    if counts() != want:
        raise AssertionError(f'[{tag}] the unfused policy launched a kernel')
    lerr = hold_value('pol step loss', gl, rl, ml, tag)
    gerr = hold_moments('pol step', gs, rs, vs, tag)
    worst = hold_lr('pol step params', got, ref, moved, 1, 1e-3, tag=tag)
    log(f'[{tag}] pol step (B={tmd.N_X0}, T={T}): launches {launches}; '
        f'loss {gl:.7g} (plain {rl:.7g}, err {lerr:.3e}); gradient within '
        f'{gerr:.3e} of each leaf\'s max|plain|; params within {worst:.3e} '
        'lr of the plain version')

    def dyn_step(dev, scale=1.0, dtype=torch.float32):
        mv = (lambda t: t.to(dev, dtype) if t.is_floating_point()
              else t.to(dev))
        p = tree_map(mv, params['dyn'])
        noise = tree_map(mv, hnoise)
        b = [mv(v) for v in batch]
        b[0] = b[0] * scale
        out, state, loss, e = m['dyn_step'](p, Adam(3e-4).init(p),
                                            tree_map(mv, scaling), *b,
                                            noise=noise)
        return flat(out).cpu(), state, float(loss), float(e)

    hnoise = dyn.sample_noise(gen, (tmd.DYN_BATCH, 1), device='cuda')
    if dump:  # the step's inputs, for tools/torch_transformer_precision.py
        torch.save(tree_map(lambda t: t.cpu(), dict(
            params=params['dyn'], scaling=scaling, noise=hnoise,
            batch=dict(zip(('s', 'a', 'ns', 'r', 'd', 'lens'), batch)))),
            dump)
    got, gs, gl, ge = dyn_step('cuda')
    (ref, rs, rl, re), (moved, vs, ml, me) = (dyn_step('cpu'),
                                              dyn_step('cpu', 1 + 1e-6))
    lerr = hold_value('dyn step loss', gl, rl, ml, tag)
    hold_value('dyn step E_lml', ge, re, me, tag)
    gerr = hold_moments('dyn step', gs, dyn_step('cpu', 1.0, torch.float64)[1],
                        rs, tag)
    worst = hold_lr('dyn step params', got, ref, moved, 1, 3e-4, tag=tag)
    log(f'[{tag}] dyn step (B={tmd.DYN_BATCH}, window {args.window}): loss '
        f'{gl:.7g} (CPU {rl:.7g}, err {lerr:.3e}), E_lml {ge:.7g}; gradient '
        f'within {gerr:.3e} of each leaf\'s max|float64|; params within '
        f'{worst:.3e} lr of the CPU step')

    jitter = torch.randn(x0s.shape, generator=gen, device='cuda')

    def flow_step(dev, scale=1.0, dtype=torch.float32):
        p = tree_map(lambda t: t.to(dev, dtype), params['flow'])
        out, state, loss = m['flow_step'](p, Adam(1e-3).init(p),
                                          x0s.to(dev, dtype) * scale,
                                          jitter=jitter.to(dev, dtype))
        return flat(out).cpu(), state, float(loss)

    (got, gs, gl), (ref, rs, rl), (moved, vs, ml) = (
        flow_step('cuda'), flow_step('cpu'), flow_step('cpu', 1 + 1e-6))
    lerr = hold_value('flow step loss', gl, rl, ml, tag)
    gerr = hold_moments('flow step', gs,
                        flow_step('cpu', 1.0, torch.float64)[1], rs, tag)
    worst = hold_lr('flow step params', got, ref, moved, 1, 1e-3, tag=tag)
    log(f'[{tag}] flow step ({x0s.shape[0]} x0s): loss {gl:.7g} (CPU '
        f'{rl:.7g}, err {lerr:.3e}); gradient within {gerr:.3e} of each '
        f'leaf\'s max|float64|; params within {worst:.3e} lr of the CPU step; '
        f'{card}')

    def pol_steps():
        p, s = params['pol'], Adam(1e-3).init(params['pol'])
        for _ in range(TM_PROFILED):
            p, s, _ = m['pol_step'](p, s, params['dyn'], scaling, x0,
                                    generator=gen)

    pol_steps()  # warm
    device_profile(tag, 'pol step', pol_steps, TM_PROFILED)


def phase_tm_episode(card, tag='phase 14b', argv=TM_ARGV):
    """One episode of ``transformer_models.main`` (TM_ARGV: 100 dynamics
    steps, 200 flow steps, 20 policy steps of 16 imagined steps, 40 control
    steps): launches exact (fused-MLP forward 20 x 16 + the control steps,
    backward 20 x 16), every value finite, E_lml rising
    over the fit; ms a dyn, flow and pol step (host clock). Returns the
    launch counts and ``main``'s (params, history)."""
    args = tmd.get_parser().parse_args(argv)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, history = tmd.main(argv, device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    steps = sum(r['control_steps'] for r in history)
    pol = args.ps_iters * args.pol_opt_iters * args.pred_H
    want = expect(fused_mlp_fwd=pol + steps, fused_mlp_bwd=pol)
    if launches != want:
        raise AssertionError(f'[{tag}] launches {launches}, expected {want}')
    for r in history:
        for k in ('E_lml', 'loss', 'flow_loss', 'pol_loss'):
            if not np.all(np.isfinite(r[k])):
                raise AssertionError(f'[{tag}] non-finite {k}')
        e, q = r['E_lml'], max(1, len(r['E_lml']) // 8)
        if not e[-q:].mean() > e[:q].mean():
            raise AssertionError(f'[{tag}] E_lml did not rise: {e[:q]} -> '
                                 f'{e[-q:]}')
    if not (all(torch.isfinite(x).all() for x in tree_leaves(params))
            and np.isfinite(history[-1]['real_return'])):
        raise AssertionError(f'[{tag}] non-finite params or return')
    r = history[-1]
    log(f'[{tag}] transformer_models episode in {wall:.3f} s (host clock): '
        f'E_lml {r["E_lml"][:q].mean():.4f} -> {r["E_lml"][-q:].mean():.4f} '
        f'(first and last eighth of {len(r["E_lml"])} steps), flow loss '
        f'{r["flow_loss"][0]:.4f} -> {r["flow_loss"][-1]:.4f}, pol loss '
        f'{r["pol_loss"][0]:.4f} -> {r["pol_loss"][-1]:.4f}, real return '
        f'{r["real_return"]:.6f}; launches {launches} (expected {want})')
    log(f'[{tag}] ms a dyn step {1e3 * r["dyn_s"] / args.dyn_opt_iters:.4f}'
        f', a flow step {1e3 * r["flow_s"] / tmd.FLOW_STEPS:.4f}, a pol step '
        f'{1e3 * r["pol_s"] / args.pol_opt_iters:.4f} (host clock, a sync '
        f'at the end of each fit); {card}')
    return launches, (params, history)


def dyn_regressor(mlp_cls=None, fused=None):
    """The main path's dynamics regressor (Cartpole, 6 -> [200, 200] -> 10,
    concrete dropout 0.1, diagonal-Gaussian head); ``mlp_cls`` wraps its
    MLP (``RandomPriorMLP``)."""
    mlp = MLPSpec(6, 10, (200, 200), dropout=cdropout(0.1), fused=fused)
    return Regressor(mlp if mlp_cls is None else mlp_cls(mlp),
                     DiagGaussianDensity(5))


def fit_data():
    """The whitened dynamics dataset of ``random_episodes`` on Cartpole on
    the card: (Xn, Yn)."""
    exp = random_episodes(envs.make('Cartpole', device='cuda'))
    X, Y = (torch.as_tensor(a, device='cuda')
            for a in exp.get_dynmodel_dataset(deltas=True))
    return normalize_dataset(dyn_regressor().fit_stats(X, Y), X, Y)


def check_ensemble(card, tag='phase 14c', steps=ENS_STEPS):
    """``make_ensemble_train_fn`` at ENS_K members of the main path's
    dynamics, batch ENS_B, bootstrap masks, ``steps`` Adam steps through
    the kernels (exactly ENS_K x steps launches each way) against the
    unfused members on the same draws (loss and E_lml of each step by
    ``hold_value``, Adam's first moment, a running mean of the gradients,
    by ``hold_moments``, params by ``hold_lr``); then one
    ``train_regressor`` step of a ``RandomPriorMLP``-backed regressor (2
    forward launches, 1 backward), held the same way."""
    Xn, Yn = fit_data()
    n = Xn.shape[0]
    gen = seeded_generator('cuda', SEED, 141)
    ens, ens_u = (ModelEnsemble(dyn_regressor(fused=f), ENS_K)
                  for f in (None, False))
    params = ens.init(gen, device='cuda')
    masks = bootstrap_masks(gen, ENS_K, n, device='cuda')
    idx = torch.randint(0, n, (steps, ENS_B), generator=gen, device='cuda')
    noise = ens.sample_noise(gen, (steps, ENS_B), device='cuda')
    noise = tree_map(lambda t: t.transpose(0, 1).contiguous(), noise)

    def run(e, scale=1.0):
        train = make_ensemble_train_fn(e, Adam(OPT_LR), batchsize=ENS_B)
        p = clone_tree(params)
        out, state, met = train(p, Adam(OPT_LR).init(p), Xn * scale, Yn,
                                masks, steps, idx=idx, noise=noise)
        return flat(out), state, met

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, gs, gm = run(ens)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    launches = counts()
    want = expect(fused_mlp_fwd=ENS_K * steps, fused_mlp_bwd=ENS_K * steps)
    if launches != want:
        raise AssertionError(f'[{tag}] ensemble launches {launches}, '
                             f'expected {want}')
    (ref, rs, rm), (moved, vs, mm) = run(ens_u), run(ens_u, 1 + 1e-6)
    if counts() != want:
        raise AssertionError(f'[{tag}] the unfused members launched a '
                             'kernel')
    errs = [hold_value(f'ensemble {k}', gm[k], rm[k], mm[k], tag)
            for k in ('loss', 'E_lml')]
    gerr = hold_moments('ensemble', gs, rs, vs, tag)
    worst = hold_lr('ensemble params', got, ref, moved, steps, OPT_LR,
                    tag=tag)
    log(f'[{tag}] ensemble of {ENS_K} (6 -> [200, 200] -> 10), {steps} '
        f'steps at batch {ENS_B}: launches {launches}; E_lml '
        f'{gm["E_lml"][0]:.4f} -> {gm["E_lml"][-1]:.4f} (plain '
        f'{rm["E_lml"][-1]:.4f}; loss err {errs[0]:.3e}, E_lml err '
        f'{errs[1]:.3e}); first moment within {gerr:.3e} of each leaf\'s '
        f'max|plain|; params within {worst:.3e} lr a step of the plain '
        f'version; {ms:.4f} ms a step (host clock); {card}')

    reg, reg_u = (dyn_regressor(RandomPriorMLP, f) for f in (None, False))
    p0 = reg.init(gen, device='cuda')
    b = idx[0]
    rnoise = reg.sample_noise(gen, (ENS_B,), device='cuda')
    ones = torch.ones((ENS_B,), device='cuda')

    def prior_step(r, scale=1.0):
        train = make_train_fn(r, Adam(OPT_LR), ENS_B)
        p = clone_tree(p0)
        out, state, _, _, loss, _ = train.train_step(
            p, Adam(OPT_LR).init(p), Xn[b] * scale, Yn[b], rnoise, ones, n)
        return out, state, float(loss)

    reset_counts()
    out, gs, gl = prior_step(reg)
    torch.cuda.synchronize()
    launches = counts()
    want = expect(fused_mlp_fwd=2, fused_mlp_bwd=1)
    if launches != want:
        raise AssertionError(f'[{tag}] RandomPriorMLP step launches '
                             f'{launches}, expected {want}')
    (ref, rs, rl), (moved, vs, ml) = (prior_step(reg_u),
                                      prior_step(reg_u, 1 + 1e-6))
    lerr = hold_value('RandomPriorMLP loss', gl, rl, ml, tag)
    gerr = hold_moments('RandomPriorMLP', gs, rs, vs, tag)
    worst = hold_lr('RandomPriorMLP params', flat(out), flat(ref),
                    flat(moved), 1, OPT_LR, tag=tag)
    if not torch.equal(flat(out['mlp']['prior']), flat(p0['mlp']['prior'])):
        raise AssertionError(f'[{tag}] the prior moved')
    log(f'[{tag}] RandomPriorMLP regressor, one train_regressor step: '
        f'launches {launches}; loss {gl:.7g} (plain {rl:.7g}, err '
        f'{lerr:.3e}); gradient within {gerr:.3e} of each leaf\'s '
        f'max|plain|; params within {worst:.3e} lr of the plain version, '
        'the prior unmoved')


def check_optimisers(card, tag='phase 14d', steps=OPT_STEPS):
    """``train_regressor``'s steps (``make_train_fn``) on the main path's
    dynamics with ``RAdam`` and then ``SdLBFGS`` at their defaults, ``steps``
    steps each through the kernels (one forward and one backward launch a
    step) against the unfused MLP on the same draws: losses by
    ``hold_value``; RAdam's first moment by ``hold_moments`` and params by
    ``hold_lr``, SdLBFGS's (a step of
    lr / sqrt(k) along a unit direction) within SDLBFGS_TOL of their move
    or 3 times the plain path's sensitivity, in norm. Logs ms a step."""
    Xn, Yn = fit_data()
    n = Xn.shape[0]
    gen = seeded_generator('cuda', SEED, 142)
    reg, reg_u = dyn_regressor(), dyn_regressor(fused=False)
    p0 = reg.init(gen, device='cuda')
    idx = torch.randint(0, n, (steps, ENS_B), generator=gen, device='cuda')
    noise = [reg.sample_noise(gen, (ENS_B,), device='cuda')
             for _ in range(steps)]
    ones = torch.ones((ENS_B,), device='cuda')
    for name, make in (('RAdam', RAdam), ('SdLBFGS', SdLBFGS)):
        def run(r, scale=1.0):
            opt = make()
            train = make_train_fn(r, opt, ENS_B)
            p, s = clone_tree(p0), opt.init(p0)
            losses = []
            for i in range(steps):
                p, s, _, _, loss, _ = train.train_step(
                    p, s, Xn[idx[i]] * scale, Yn[idx[i]], noise[i], ones, n)
                losses.append(loss)
            return flat(p), s, torch.stack(losses).cpu().numpy()

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, gs, gl = run(reg)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        launches = counts()
        want = expect(fused_mlp_fwd=steps, fused_mlp_bwd=steps)
        if launches != want:
            raise AssertionError(f'[{tag}] {name} launches {launches}, '
                                 f'expected {want}')
        (ref, rs, rl), (moved, vs, ml) = run(reg_u), run(reg_u, 1 + 1e-6)
        lerr = hold_value(f'{name} losses', gl, rl, ml, tag)
        if name == 'RAdam':
            gerr = hold_moments(name, gs, rs, vs, tag)
            worst = hold_lr(f'{name} params', got, ref, moved, steps, 1e-3,
                            tag=tag)
            held = (f'first moment within {gerr:.3e} of each leaf\'s '
                    f'max|plain|, params within {worst:.3e} lr a step of the '
                    'plain version')
        else:
            start = flat(p0)
            err = float(torch.linalg.norm(got - ref))
            tol = max(SDLBFGS_TOL * float(torch.linalg.norm(ref - start)),
                      3 * float(torch.linalg.norm(moved - ref)))
            if not (torch.isfinite(got).all() and err <= tol):
                raise AssertionError(f'[{tag}] {name} params {err:.3e} from '
                                     f'the plain version (tolerance '
                                     f'{tol:.3e})')
            held = (f'params |a - r| {err:.3e} (tolerance {tol:.3e}, a move '
                    f'of {float(torch.linalg.norm(ref - start)):.4f})')
        log(f'[{tag}] train_regressor with {name}, {steps} steps at batch '
            f'{ENS_B}: launches {launches}; loss {gl[0]:.6f} -> {gl[-1]:.6f}'
            f' (plain {rl[-1]:.6f}, err {lerr:.3e}); {held}; {ms:.4f} ms a '
            f'step (host clock); {card}')


def phase_transformer(card):
    """Phase 14: one episode of the sequence-model driver (14b), then its
    steps on the trained models (14a), model ensembles and randomized priors
    (14c), RAdam and SdLBFGS (14d). Returns 14b's launch counts."""
    launches, trained = phase_tm_episode(card)
    check_tm_steps(tm_setup(trained), card)
    check_ensemble(card)
    check_optimisers(card)
    return launches


def start(name):
    """Phases 0 and 1: the card's name and power limit, TF32 off, the
    kernels built. Returns the ``nvidia-smi`` line, or None without CUDA."""
    if not torch.cuda.is_available():
        print(f'{name}: no CUDA device (torch.cuda.is_available() is False)',
              file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f'[phase 0] {card}; torch {torch.__version__} cuda '
        f'{torch.version.cuda}; TF32 off')

    t = time.perf_counter()
    logs = build.build(['fused_mlp', 'fused_step', 'fused_rollout',
                        'fused_step_wide', 'fused_rollout_wide'])
    log(f'[phase 1] built {list(logs)} in {time.perf_counter() - t:.1f} s')
    t = time.perf_counter()
    lib = native.build_library()
    native.load_library()
    log(f'[phase 1] built and loaded the native sum tree ({lib.name}, g++) '
        f'in {time.perf_counter() - t:.1f} s')
    for name, text in logs.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                log(f'[phase 1]   {name}: ' + line.strip())
    return card


def lap(what, since):
    """Log the host-clock seconds since ``since``; returns now."""
    now = time.perf_counter()
    log(f'[time] {what} in {now - since:.1f} s (host clock)')
    return now


def main():
    card = start('chip_smoke')
    if card is None:
        return 1

    t = time.perf_counter()
    rows = {**phase_mlp_kernels(), **phase_step_kernels(),
            **phase_rollout_kernels(), **phase_grid_kernels()}
    t = lap('phase 2', t)
    rows.update(phase_bf16_mlp(rows, card))
    t = lap('phase 2h', t)
    phase_grouped_kernels(rows, card)
    t = lap('phase 2g', t)
    critic_rows = phase_critic_kernels()
    t = lap('phase 2c', t)
    env_rows = phase_env_kernels(rows, card)
    t = lap('phase 2b', t)
    phase_mixture_kernels(rows, card)
    t = lap('phase 2m', t)
    phase_option_kernels(rows, card)
    t = lap('phase 2o', t)
    phase_head_kernels(rows, env_rows, card)
    t = lap('phase 2p', t)
    rows.update(phase_wide_kernels(env_rows, card))
    t = lap('phase 2w', t)
    rows.update(phase_wide_critic_kernels(critic_rows, card))
    t = lap('phase 2cw', t)
    # each kernel's launches come from the run of the route that carries it:
    # rows 1-2 the episode's (phase 8)
    T = MAIN_T
    phase_mc_pilco(ROUTE_ITERS, False, 'phase 3', expect(
        fused_mlp_fwd=2 * T * ROUTE_ITERS, fused_mlp_bwd=2 * T * ROUTE_ITERS),
        None)
    # phase 3h: the same route with fused=True bf16 MLPs, the bf16
    # instances' launches for the kernels line; then a bf16 fit
    bf16_route = phase_mc_pilco(
        BF16_ROUTE_ITERS, False, 'phase 3h', expect(
            fused_mlp_fwd_bf16=2 * T * BF16_ROUTE_ITERS,
            fused_mlp_bwd_bf16=2 * T * BF16_ROUTE_ITERS), None,
        model_options=('bf16',))
    log(f'[phase 3h] {ITER_MS["phase 3h"]:.3f} ms an iteration on fused bf16 '
        f'MLPs beside phase 3\'s {ITER_MS["phase 3"]:.3f} (host clock, this '
        f'call); {card}')
    phase_bf16_fit(card)
    t = lap('phases 3 and 3h', t)
    phase_variants()
    step = phase_loop(STEP_ITERS, 'step', 'phase 4', expect(
        fused_step_fwd=T * STEP_ITERS, fused_step_bwd=T * STEP_ITERS))
    # the step tier as mc_pilco takes it: a batch one particle beyond what
    # the card holds at once, so the gate names 'step'
    dyn, pol = build_models(5, 1, (10.0,), envs.cartpole_reward())
    capacity = fr.rollout_capacity(dyn, pol, 'cuda')
    big_b = capacity + 1
    log(f'[phase 4b] the card holds {capacity} particles of the '
        f'whole-rollout kernel at once ({fr.max_clusters(0)} clusters of 8 '
        f'CTAs): B={big_b} takes the step tier')
    phase_mc_pilco(STEP_ROUTE_ITERS, None, 'phase 4b', expect(
        fused_step_fwd=T * STEP_ROUTE_ITERS,
        fused_step_bwd=T * STEP_ROUTE_ITERS), 'step', B=big_b)
    main_path = phase_mc_pilco(ITERS, None, 'phase 5',
                               expect(fused_rollout_vg=ITERS), 'full')
    # phase 5m: the main path with --dyn_components 2, the same one launch
    # an iteration and nothing else
    phase_mc_pilco(ITERS, None, 'phase 5m', expect(fused_rollout_vg=ITERS),
                   'full', components=2)
    log(f'[phase 5m] {ITER_MS["phase 5m"]:.3f} ms an iteration with the '
        f'mixture head (K=2, a head of 23) beside phase 5\'s '
        f'{ITER_MS["phase 5"]:.3f} ms (host clock, this call)')
    # and with --dyn_components MANY_K: still one launch an iteration and
    # nothing else
    tag = f'phase 5m K={MANY_K}'
    phase_mc_pilco(ITERS, None, tag, expect(fused_rollout_vg=ITERS), 'full',
                   components=MANY_K)
    log(f'[phase 5m] {ITER_MS[tag]:.3f} ms an iteration with the mixture '
        f'head (K={MANY_K}, a head of {11 * MANY_K + 1}) beside K=2\'s '
        f'{ITER_MS["phase 5m"]:.3f} ms and phase 5\'s '
        f'{ITER_MS["phase 5"]:.3f} ms (host clock, this call); {card}')
    # phase 5o: the main path with the model options B1-B3, the same one
    # launch an iteration and nothing else
    phase_mc_pilco(OPTION_ITERS, None, 'phase 5o',
                   expect(fused_rollout_vg=OPTION_ITERS), 'full',
                   model_options=ALL_OPTIONS)
    log(f'[phase 5o] {ITER_MS["phase 5o"]:.3f} ms an iteration with B1-B3 '
        f'beside phase 5\'s {ITER_MS["phase 5"]:.3f} ms (host clock, this '
        f'call); {card}')
    # phase 5p: the main path with the tanh-squashed policy head, the same
    # one launch an iteration and nothing else
    phase_mc_pilco(HEAD_ITERS, None, 'phase 5p',
                   expect(fused_rollout_vg=HEAD_ITERS), 'full',
                   model_options=('tanh',))
    log(f'[phase 5p] {ITER_MS["phase 5p"]:.3f} ms an iteration with the '
        f'TanhSquashedDensity head beside phase 5\'s {ITER_MS["phase 5"]:.3f} '
        f'ms (host clock, this call); {card}')
    phase_grouped_paths(capacity)
    loss_route = phase_loop(LOSS_ITERS, 'loss', 'phase 6', expect(
        fused_rollout_fwd=LOSS_ITERS, fused_rollout_bwd=LOSS_ITERS))
    phase_value_path()
    phase_critic_options(critic_rows, card)
    log(f'[phase 7o] {ITER_MS["phase 7o"]:.3f} ms an iteration with the '
        f'critic\'s options beside phase 7\'s {ITER_MS["phase 7"]:.3f} ms '
        f'(host clock, median of 30, this call); {card}')
    fixed_critic = phase_fixed_critic()
    t = lap('phases 3-7', t)
    wide_runs = phase_wide_path(card)
    t = lap('phase 5w', t)
    wide_critic_runs = phase_wide_value_path(card)
    t = lap('phase 7w', t)
    episode = phase_episode()
    t = lap('phase 8', t)
    phase_env_episodes()
    t = lap('phase 9', t)
    phase_value_episode()
    t = lap('phase 10', t)
    phase_sharded(card, capacity)
    t = lap('phase 11', t)
    phase_ddpg(card)
    t = lap('phase 12', t)
    phase_density(card)
    t = lap('phase 13', t)
    phase_transformer(card)
    lap('phase 14', t)
    # the wide kernels' launches from phase 5w's runs, each under its name,
    # and those with the critic from phase 7w's (its only launches were the
    # critic instances', counted under the row's name + '_wide')
    runs = {**wide_critic_runs, **wide_runs,
            'fused_mlp_fwd_bf16': bf16_route, 'fused_mlp_bwd_bf16': bf16_route,
            'fused_mlp': episode, 'fused_step': step, 'fused_rollout_vg':
            main_path, 'fused_rollout_fwd': loss_route,
            'fused_rollout_bwd': loss_route, 'fused_grid': fixed_critic}
    launches = {n: next(v for k, v in runs.items() if n.startswith(k))[
        n.removesuffix('_critic')] for n in REPLACES}

    kernels = [dict(name=name, route='cuda', source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=rows[name]['max_abs_err'],
                    ms=rows[name]['ms'], plain_ms=rows[name]['plain_ms'],
                    bound_ms=rows[name]['bound_ms'],
                    bound_by=rows[name]['bound_by'],
                    library_ms=rows[name]['library_ms'])
               for name in REPLACES]
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
