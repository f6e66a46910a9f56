"""Drive the PyTorch/CUDA port (ab_opt_tpu_torch) on one NVIDIA GPU.

Phases, each fatal on failure:
  1. device: require CUDA, print the card's name and power limit, turn
     TF32 off;
  2. build: compile every kernel source in ab_opt_tpu_torch/csrc (the
     GABlock kernel K1, the IPA attention kernels K2/K3/K4, the chained
     encoder kernel K5, the attention variants S1-S3; S4 lives in K1's
     source; K1's tiles, in csrc/k1_tiles.cuh, also run K5, K4 and S1), one
     nvcc per source, all started together;
  3. K1 vs plain: the GABlock kernel against its plain PyTorch version
     at the sampler's widths (F=128, Cz=64, H=12), bf16, atol/rtol 0.05
     on valid rows, cases (Nc=1, reps=32), (Nc=2, reps=4, 8 padded rows)
     and (Nc=1, reps=256) at L=128, then (Nc=2, reps=3, 5 padded rows) at
     L=48, (Nc=1, reps=4) at L=256 and (Nc=2, reps=1, 3 padded rows), each
     launched twice with bitwise-equal outputs; per-layer times of both at
     reps 32 and 256; K1 against its plain version at reps 256, reps 32 and
     L=256 (reps 64), each warmed, the median of 4 order-alternated rounds
     of chained layers, K1 / plain at most K1_PLAIN_RATIO at reps 256 (K1's
     tiles live in csrc/k1_tiles.cuh, shared with K5, K4, K2, S1, S3 and
     S4); one K1 layer's launches under
     torch.profiler beside each launch's floor; K1's attention launch alone
     against its plain version and against scaled_dot_product_attention on
     the same operands (reps 256, L=128);
  4. K2/K3 vs plain: the wrapper's plan (attention_plan) against the
     source's at L=16..512; the attention forward (out, alphas) and
     backward (dqa, dka, dvvp, dbias) against their plain versions at
     ATTN_CASES, each case's route and launches printed: bf16 on the tile
     route (K2 on K1's attention tile, K3 one launch of a cluster) at the
     training slice's shapes (N=16, L=128, H=12) and at L=16, 48, 128 and
     256 with padded key columns, bf16 at L=512 and f32 on the CUDA cores;
     bf16 within 1e-2 relative plus 1e-3 of each tensor's largest value,
     f32 at atol/rtol 1e-3; each kernel launched twice, bitwise equal, and
     on the tile route K2's out and alphas bitwise equal to S1 v1's; then
     at the slice's shapes K2 and K3 against the CUDA-core kernels (their
     first design) on the same operands, medians of 4 order-alternated
     rounds of ATTN_ITERS calls each way: eager calls through the
     wrappers, as the training step pays them (the kernels line's ms),
     and device time from CUDA graphs of the same calls (its device_ms),
     the plain times and the bounds; one K3 call under torch.profiler, in
     a child process, is exactly one kernel;
  5. the sampling slice: DiffAb (bf16, seeded random weights) on a
     synthetic complex at L=128 answers three BatchedSampler requests
     (fan-out 32, 32, 256; 100 steps each). Each must give finite outputs,
     leave the context residues unchanged, launch K1 exactly 100 x 6 times
     and call its plain version 0 times. Before that, one denoiser
     evaluation of the same model with the encoder through the kernel is
     held against the same evaluation through the plain version;
  6. the training slice: a Trainer on the card with the DiffAb train step
     of bench.py (bf16, 6 layers, batch 16 of the synthetic complex at
     L=128, Adam 1e-4, clip 100). One step's losses and gradients through
     K2/K3 are held against the same step through the plain versions (same
     parameters, batch, t and draws); then 1 warm-up and 10 timed steps
     through Trainer.train, whose finite-loss guard raises on any step
     with a non-finite loss, with exactly 60 K2 and 60 K3 launches (6 a
     step, on the tile route) and no plain call; then the checkpoint it
     saved is resumed by a fresh Trainer, which takes one more finite
     step;
  7. K4 vs plain: the wrapper's launch plan against the source's (the
     tile route at L=16..256, the CUDA-core route to L=512); the attention
     forward with the pair aggregation (out, p2n) against its plain version
     at P2N_CASES: bf16 on K1's attention tile at (N=256, reps=256, L=128),
     L=144 (a ragged query tile), L=256 (reps 2), reps 3 (blocks of one
     replica) and reps 4 (L=48), padded key columns, each tensor within
     1e-2 of |plain| plus 1e-3 of its largest value, o bitwise equal to
     K1's attention launch and p2n to K1's p2n launch on the same operands;
     f32 on the CUDA cores at (N=4, reps=2, L=128) and (N=3, reps=3, L=48),
     atol/rtol 1e-3, and bf16 at (N=4, reps=2, L=128, H=6, Cz=32), a shape
     the tile does not take, under the bf16 gate; every case launched
     twice, bitwise equal, its route
     and launches printed; then at the first case K4 against K1's two
     launches (the same composition) and S3 (v4, K4's function in one
     cluster launch), medians of 4 order-alternated rounds, the plain time
     and the bound;
  8. the rest of BatchedSampler, on phase 5's model and complex: one
     denoiser evaluation of the ipa_impl='pallas' model (the eager encoder
     over K4) against the same evaluation through K4's plain version, then
     four requests: ipa_impl='pallas' at fan-out 256 (exactly 100 x 6 K4
     launches, no K1 launch; K4's share of the request priced at phase 7's
     time), opt_step=64 at fan-out 16 (64 x 6 K1
     launches), stride=5 at fan-out 256 (20 x 6 K1 launches) and
     sample_structure=False at fan-out 32 (100 x 6 K1 launches, the native
     frames and CA positions unchanged); each with finite outputs, the
     context residues unchanged and no plain call;
  9. K5 vs plain: the chained whole-encoder kernel (one persistent launch
     over K1's tiles) against its plain version (atol/rtol 0.05) and six K1
     launches (within 0.005, bitwise equality printed) on the same inputs
     (six layers with distinct seeded weights, bf16, valid rows), each
     launched twice with bitwise-equal outputs, cases (Nc=1, reps=256),
     (Nc=1, reps=32), (Nc=2, reps=4, 8 padded rows) at L=128 and (Nc=1,
     reps=3, 5 padded rows) at L=256; K5 against six K1 at reps 256 and 32
     (medians of 4 order-alternated rounds, their ratio), the plain time
     and the bound; one pass under torch.profiler is exactly one kernel;
 10. the chained route (AB_OPT_FUSED_CHAIN=1, set for these calls only),
     on phase 5's model and complex: one denoiser evaluation through K5
     against the same evaluation through the plain chain, the host time of
     K5's work list at each fan-out, then BatchedSampler at fan-out 256,
     256, 32 and 32 (100 steps each; the first of each builds K5's work
     list and workspace), each with exactly 100 K5 launches, no K1 launch
     and no plain call, finite outputs and the context residues unchanged;
     samples/s beside phase 5's K1-route numbers;
 11. the attention variants (S1 as v1 and v3 on K1's attention tile, S2 as
     v2, the TMA-fed wgmma head loop, S3 as v4, K4's function in one
     cluster launch) vs their plain versions (K2's and K4's) at (N=256,
     reps=256, L=128), (N=3, reps=3, L=48, 5 padded key columns) and the
     cap L=256 (N=8, reps=4, 3 padded key columns), bf16, each tensor
     within K2's bf16 gate, v3's o bitwise equal to v1's, v2 and v4 each
     called twice with bitwise-equal outputs, v4's o and p2n bitwise equal
     to K4's (its tile route) and v2's max |d| against v1 printed; the
     wrappers' S2 and S3 plans against the source's; one v4 and one v2
     call under torch.profiler in a child process (one kernel each); then
     the variants' own path, the timing harness (utils/micro_attention.py)
     at the first case with the counts zeroed before it: exactly one
     warm-up and VARIANT_ITERS timed launches of each variant; the plain
     versions' times, the bounds, and the library yardstick for v3
     (scaled_dot_product_attention); then v3 and v1 against K1's attention
     launch and SDPA, v4 against K4, and v2 against v1 and K2, on the same
     operands (medians of 4 alternated rounds each);
 12. the fused-GABlock variants (S4: K1's own launches in csrc/gablock.cu,
     with an ablation mask or the attention's replica group rt): at
     (Nc=1, reps=256), the harness's shape, and (Nc=2, reps=4, 8 padded
     rows), L=128, v3 at rt 1, 2, 4 and 8 (those dividing reps) and the abl
     baseline (mask 0) bitwise equal to K1 and under K1's gate (atol/rtol
     0.05 on valid rows) against K1's plain version, and each ablation mask
     (each flag with a counterpart, the floor) under the gate against the
     plain version with the same flags; then the variants' own path, the
     harness (utils/micro_fused.py) at the first case with the counts
     zeroed before it: exactly one warm-up and FUSED_ROUNDS x FUSED_ITERS
     chained layers of K1, v3 (rt 4), the abl baseline, each flag
     and the floor, and no plain call; each flag's saving beside phase 3's
     profiled time of the K1 launches it touches; the plain time, K1's
     bound (the same work); then K1 against v3 at each rt, medians of
     alternated rounds.
 13. the design runner, PDB to PDB (runners/design.py): the DockQ contact
     kernel (tools/dockq/fnat_kernel.cc, built with g++) must load and
     count every contact set of the in-process requests' scores; a
     synthetic Chothia complex is written with the port's save_pdb (heavy
     H 1-113, CDR-H3 95-102; light L 1-107; a 170-residue antigen A, its
     nearest residues 6.8 A from CDR-H3's CA atoms); then four requests
     through design_for_pdb, the model's weights drawn from the seed:
     configs/test/codesign_single.yml (float32, as the port's load_config
     reads it) at 256 samples in one sampler call on K1 (crop L=256), the
     same on K5 (AB_OPT_FUSED_CHAIN=1), abopt_singlecdr at 16 samples
     (five opt steps), and dock_cdr at 16 samples (crop L=32) through
     python -m ab_opt_tpu_torch.runners.design_cli in a child process
     (renumbering on: the passthrough check). Each must write the file
     tree of tests/test_runner.py for every variant, finite scores in
     results.csv, every sample's context residues equal to the native
     patch REF1.pdb at the PDB's 3 decimals, and per sampler call K1 at
     6 x steps launches (K5 at steps on the chained request, no other
     encoder kernel), as the runner's log lines record them. The model,
     crop and fan-out of the K1 request's sampler call go through one
     denoiser evaluation at that fan-out (256 x L=256) through K1 and
     through K5, each against the same route's plain version (bf16
     operands) within DENOISER_TOL. The four stage times (sample,
     paste_io, dockq, rank) and the in-process requests' samples/s are
     printed with the card's name and power limit (the CLI's sample stage
     is its process's first sampler call, start-up included: no rate).
 14. the training CLI (runners/train_cli.py), SAbDab to checkpoints: a
     mini-SAbDab of CLI_COMPLEXES synthetic complexes
     (utils/bench_fixture.py::write_mini_sabdab: two of a test antigen,
     one dock-test code, 20 val, the rest train) written under a
     temporary directory and preprocessed (timed); then
     configs/train/codesign_single.yml at its own model and batch
     (float32, 6 layers, 100 steps, batch 16; K2/K3 on their CUDA-core
     route) with CLI_ITERS steps, val every CLI_VAL_FREQ and a sampling
     eval of 4 items x 2 samples, through train_cli.main with the launch
     counts zeroed just before it: every loss finite, K2 and K3 one
     launch a layer every step, K1 one launch a layer every step of every
     sampling-eval chunk, no K4, K5 or plain call, the checkpoints, the
     best_rmsd checkpoint and sampling_eval/it*/results.csv written; the
     median s/step after CLI_WARMUP warm-up steps (each step timed with
     the card synchronised at both ends) and each sampling eval's wall and
     samples/s; the CLI's first batch through one step against the plain
     K2/K3 route (phase 6's gate); --resume of the last checkpoint (its
     steps start at the saved iteration) and --finetune of it
     (CLI_FINETUNE iterations). Last, a crop past 256 residues
     (codesign_fv's val crop, 347 residues, L=384): the float32 model's
     'auto' sampler takes K4's route (encoder_route), a request at fan-out
     CLI_CROP_REPS makes one K4 launch a layer a step and no K1 or K5
     launch, and one denoiser evaluation is within CLI_CROP_TOL of K4's
     plain version.
 15. the test-set runner (runners/testset.py): a mini-SAbDab of
     TESTSET_COMPLEXES synthetic complexes (entries 0-1 the test split,
     entry 2 the dock-test split) under a temporary directory,
     preprocessed (timed); design_for_testset with
     configs/test/codesign_single.yml as written (float32, 6 layers, 100
     steps, crop L=256) on the test split at TESTSET_SAMPLES samples a
     complex in one sampler call, DockQ on and relax=True (the relax
     backends are absent, so the runner logs their skip once a complex),
     then seq_design_dock_testset.yml on the dock-test split, the launch
     counts zeroed just before: every sampler call at fan-out
     TESTSET_SAMPLES with one K1 launch a layer a step and no K4, K5 or
     plain call; each complex's tree (results.csv, aa.csv, metadata.json,
     REF1.pdb, every sample) and finite testset_results.csv and
     testset_summary.csv; then evaluate_directory over one complex, a
     finite rmsd and seqid a sample. The first sampler call of each model
     at each crop and fan-out (L=256 x 32 on the test split, L=32 x 32 on
     the dock-test split) then goes through one denoiser evaluation on
     its own model and crop at its fan-out, K1 against its plain version
     (bf16 operands) within DENOISER_TOL. Walls and the four stage times
     are printed with the card's name and power limit;
 16. the 3-stage optimization pipeline (runners/optimize.py): OPT_POSES
     poses of a dock_cdr request on the synthetic complex, then
     optimize_antibody with configs/test/seq_design.yml and dock_cdr.yml as
     written, OPT_MAX_POSES poses x OPT_DESIGNS designs, each re-docked at
     OPT_NUMS poses, OPT_BATCH trajectories a call, the launch counts
     zeroed just before: stage 1 OPT_MAX_POSES sampler calls and stage 2
     one a design, each with one K1 launch a layer a step and no K4, K5 or
     plain call; screening_summary.csv with a finite DockQ_avg and
     prmsd_avg for every candidate; each stage's wall and crop bucket L
     (the pose's heavy chain labelled as CDR); then one denoiser
     evaluation of each stage's model on its first call's crop at its
     fan-out (L=32 x OPT_DESIGNS, L=32 x OPT_NUMS), K1 against its plain
     version within DENOISER_TOL. design-dock is not run: the card's
     machine has no hdock binary.
 17. the graph model (diff_gnn, models/diff_gnn.py over nn/egnn.py; JAX
     has no Pallas kernel on this path, so it runs as PyTorch ops and
     launches no hand-written kernel): the training CLI on
     configs/train/aa_label.yml as written (hotspot, hydropathy and charge
     labels, bb_pos weighted, dropout 0.1, float32, batch 16, 500 steps)
     over a mini-SAbDab of CLI_COMPLEXES synthetic complexes, GNN_ITERS
     steps with validation and one sampling eval (GNN_EVAL) at the last,
     the launch counts zeroed just before: every loss finite, no K1-K5
     launch and no plain call, the checkpoint, the best_rmsd checkpoint and
     the eval's results.csv written; the median s/step after CLI_WARMUP
     warm-up steps, the eval's wall and samples/s and the peak memory
     allocated. Then design_for_pdb from the checkpoint it wrote on a
     mini-SAbDab complex with configs/test/codesign_single.yml,
     GNN_SAMPLES samples in one sampler call: the file tree, finite
     scores (the graph model has no pRMSD or perplexity head), the context
     residues equal to REF1.pdb, no kernel launch; the four stage times,
     ms per reverse step and the peak memory. Last, one denoiser
     evaluation (aa logits and z) of that model on the request's crop at
     fan-out GNN_CPU_REPS on the card against a copy on the CPU, within
     GNN_CPU_TOL.
 18. data parallelism (parallel/, the training CLI's --num_devices): parts
     a and d run in one spawn of two gloo ranks sharing the card
     (parallel/launch.py, parallel/rehearse.py), b in one NCCL rank, c in
     the CLI's own ranks: a. DiffAb at
     full width (bf16, 6 layers), global batch TRAIN_BATCH at L=128 (row i
     generating L/4 + 4 + i residues, so the two shards' counts differ),
     DP_STEPS steps on two gloo ranks sharing the card (rank r's rows, the
     global batch's draws) against the one-process Trainer step on the
     same batch and draws: every loss within LOSS_RTOL, the first step's
     gradient cosine and global norm within the training gate; the first
     step against the two halves' gradients accumulated in one process
     (each rounded to bf16 before the float32 sum, as a rank's is) within
     DP_ACC_RTOL and DP_ACC_COS, the cosines of both with the one-process
     step printed; the ranks' losses equal, assert_replicated_params_equal after the steps, one K2
     and one K3 launch a layer a step in each rank and no plain call; b.
     the same step in one NCCL rank through sharded_train_step, against
     the one-process step (bitwise equality printed, the training gate
     enforced), and the all-reduce of the gradients timed; c. the
     training CLI's main (ab_opt_tpu_torch.runners.train_cli) with
     configs/train/codesign_single.yml (float32) on a mini-SAbDab of
     DP_CLI_COMPLEXES, --num_devices 2 --dist_backend gloo against
     --num_devices 1 for DP_CLI_ITERS steps and one val pass: the losses
     of every step and the val loss, as the runs return them, within
     DP_CLI_RTOL, one val line in the log (rank 0's), one checkpoint,
     which resumes in one process; d. a fan-out of 2 x DP_FANOUT of one
     complex (L=128, bf16, 100 steps) through sharded_sample_fn on two gloo ranks: each rank's
     rows against a one-process sample of them with that rank's seed
     (within TOL; bitwise equality printed), the ranks' rows differ, 600
     K1 launches a rank and no plain call. Two ranks share one card here:
     a rehearsal of the wiring, not a speed-up.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors, times and bounds (K1, K2, K3
and K4 also their launches in phase 14, ``train_cli_launches``: the main
CLI run's, and the crop past 256's for K4; K1 also ``testset_launches``
and ``optimize_launches``, phases 15 and 16; K1, K2 and K3 also
``dp_launches``, phase 18's by rank: K1 in part d, K2 and K3 in part a).

Run from the repository root: python3 chip_smoke.py
"""
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

L = 128
FANOUTS = (32, 32, 256)
TOL = 0.05
DENOISER_TOL = 0.03
# K2/K3 vs plain. Both compute in f32 and round each output once, so in
# bf16 they differ by at most about one bf16 ulp (2^-7 relative): each
# tensor within ATTN_BF16_RTOL of |plain| plus ATTN_BF16_ATOL_FRAC of its
# largest value. In f32, atol/rtol ATTN_F32_TOL.
ATTN_BF16_RTOL = 1e-2
ATTN_BF16_ATOL_FRAC = 1e-3
ATTN_F32_TOL = 1e-3
TRAIN_BATCH = 16
# K2/K3 vs plain: (N, L, reps, dtype name, padded key columns). The first
# is the training slice's shape and is timed against the CUDA-core
# kernels (ATTN_ROUNDS alternated rounds of ATTN_ITERS calls); then bf16 on
# the tile route at L=16, 48 (a ragged 64-row tile), 128 and 256, bf16 past
# it on the CUDA cores (L=512), and float32 on the CUDA cores.
ATTN_CASES = ((TRAIN_BATCH, L, 1, 'bfloat16', 0), (2, 16, 1, 'bfloat16', 0),
              (4, 48, 2, 'bfloat16', 5), (4, L, 2, 'bfloat16', 5),
              (4, 256, 2, 'bfloat16', 3), (2, 512, 1, 'bfloat16', 5),
              (4, L, 2, 'float32', 5), (2, 48, 2, 'float32', 5))
ATTN_ROUNDS = 4
ATTN_ITERS = 50
P2N_FANOUT = 256          # K4's timed case and the ipa_impl='pallas' request
# K4 vs plain: (N, L, reps, dtype name, padded key columns[, H, Cz]; H=12
# and Cz=64 where not given). The first is the sampler's shape and is timed
# (P2N_ROUNDS alternated rounds of P2N_ITERS calls); then bf16 on the tile
# route at a ragged query tile (L=144), L=256 (reps 2), reps 3 (blocks of
# one replica) and reps 4, and on the CUDA cores float32 and bf16 at H=6,
# Cz=32 (a shape the tile does not take).
P2N_CASES = ((P2N_FANOUT, L, P2N_FANOUT, 'bfloat16', 0),
             (8, 144, 4, 'bfloat16', 5), (4, 256, 2, 'bfloat16', 3),
             (6, L, 3, 'bfloat16', 5), (8, 48, 4, 'bfloat16', 5),
             (4, L, 2, 'float32', 5), (3, 48, 3, 'float32', 0),
             (4, L, 2, 'bfloat16', 5, 6, 32))
P2N_ROUNDS = 4
P2N_ITERS = 20
TIMED_STEPS = 10
LAYERS = 6                # the encoder depth of DiffAbConfig
# The chained requests: each fan-out twice, the first with K5's per-shape
# set-up (its work list and workspace), the second without.
CHAIN_FANOUTS = (256, 256, 32, 32)
# K5 vs plain and six K1: (Nc, reps, padded rows, L); Nc=1 at L=128 is
# timed against six K1 (CHAIN_ROUNDS alternated rounds of CHAIN_ITERS
# passes). K5 runs K1's tiles, so against six K1 it is held to
# CHAIN_K1_TOL (it has been bitwise equal).
CHAIN_CASES = ((1, 256, 0, L), (1, 32, 0, L), (2, 4, 8, L), (1, 3, 5, 256))
CHAIN_ROUNDS = 4
CHAIN_ITERS = 10
CHAIN_K1_TOL = 0.005
# K1 / its plain version at reps 256, both timed in the same alternated
# rounds of chained layers: the first such run on an H100 80GB HBM3 at
# 700 W gave 0.1082, and the limit is that ratio plus 10%.
K1_PLAIN_RATIO = 0.119
# S1-S3 vs plain: (N, reps, L, padded key columns); the first is the
# script's shape and is timed. L=48 shows a row-stride fault that L=128
# hides; L=256 is every variant's cap (4 replicas of a complex, 3 padded key
# columns). The first shape also times v3 and v1 against K1's attention
# launch and SDPA, v4 against K4, and v2 against v1 and K2, each in
# VARIANT_ROUNDS alternated rounds.
VARIANT_CASES = ((256, 256, L, 0), (3, 3, 48, 5), (8, 4, 256, 3))
VARIANT_ITERS = 20
VARIANT_ROUNDS = 4
# S4: (Nc, reps, padded rows); the first is the script's point and is
# timed (v3 at the harness's rt, utils/micro_fused.py's RT), the second
# masks padded rows. Both hold v3 at each rt of micro_fused's RTS that
# divides reps and every ablation mask; the first times K1 against v3 at
# each of them.
FUSED_CASES = ((1, 256, 0), (2, 4, 8))
FUSED_ITERS = 30
FUSED_ROUNDS = 4
# K1 vs plain: (Nc, reps, padded rows, L). The first three are the sampler's
# shapes (reps 32 and 256 timed); then ragged query tiles (L=48) with
# padded rows at reps 3 (rt 1), L=256 at reps 4, and reps 1.
K1_CASES = ((1, 32, 0, L), (2, 4, 8, L), (1, 256, 0, L), (2, 3, 5, 48),
            (1, 4, 0, 256), (2, 1, 3, L))
# K1 against its plain version: (reps, L), median of K1_ROUNDS rounds.
K1_TIMED = ((256, L), (32, L), (64, 256))
K1_ROUNDS = 4
K1_ITERS = 20
# Kernel vs plain training step. First measured on an H100 (bf16, the
# slice's step): losses within 5.7e-5 relative, gradient cosine 0.99975,
# global norms within 9.6e-4; the bounds keep a 10-20x margin.
LOSS_RTOL = 1e-3          # each loss, relative
GRAD_COS = 0.999          # cosine of the flattened gradients
GRAD_NORM_RTOL = 0.01     # global gradient norms, relative
# The design phase: the repo's own test configs through the design runner
# on a synthetic Chothia complex (heavy H, light L, antigen A; the crop of
# codesign_single fills the 256 bucket, dock_cdr's the 32 one). Outputs go
# under the gitignored results/ of the checkout.
DESIGN_SAMPLES = 256      # codesign_single, K1 and K5 requests, one call
DESIGN_SMALL = 16         # abopt_singlecdr and dock_cdr (the CLI)
DESIGN_OUT = Path(__file__).resolve().parent / 'results' / 'chip_smoke'
# The training CLI phase: a mini-SAbDab of CLI_COMPLEXES synthetic complexes
# (2 test, 1 dock-test, 20 val, the rest train) under a temporary
# directory; configs/train/codesign_single.yml at its own model and batch
# (float32, 6 layers, batch 16) with CLI_ITERS steps, val every
# CLI_VAL_FREQ and the sampling eval of CLI_EVAL; then a resume to
# CLI_RESUME_TO and a finetune of CLI_FINETUNE iterations. The crop past
# 256 residues is codesign_fv's val crop (the whole Fv plus 128 antigen
# residues), sampled at fan-out CLI_CROP_REPS and held against plain
# within CLI_CROP_TOL.
CLI_COMPLEXES = 44
CLI_ITERS = 20
CLI_VAL_FREQ = 8
CLI_EVAL = {'enabled': True, 'num_items': 4, 'num_samples': 2}
CLI_RESUME_TO = CLI_ITERS + 4
CLI_FINETUNE = 2
CLI_WARMUP = 2
CLI_CROP_REPS = 4
CLI_CROP_TOL = 0.01
# The test-set phase: a mini-SAbDab of TESTSET_COMPLEXES synthetic complexes
# (entries 0-1 the test split, entry 2 the dock-test split), the runner at
# TESTSET_SAMPLES samples a complex in one sampler call. The optimize
# phase: OPT_POSES poses of a dock_cdr request; OPT_MAX_POSES of them
# through stage 1 at OPT_DESIGNS designs each, every design re-docked in
# stage 2 at OPT_NUMS poses, OPT_BATCH trajectories a sampler call.
TESTSET_COMPLEXES = 3
TESTSET_SAMPLES = 32
OPT_POSES = 8
OPT_MAX_POSES = 2
OPT_DESIGNS = 4
OPT_NUMS = 16
OPT_BATCH = 16
# The graph-model phase: configs/train/aa_label.yml as written (diff_gnn,
# float32, batch 16, 500 steps) on a mini-SAbDab of CLI_COMPLEXES synthetic
# complexes for GNN_ITERS steps, validation and one sampling eval of
# GNN_EVAL at the last; then a design request from the checkpoint it wrote
# (configs/test/codesign_single.yml, GNN_SAMPLES samples in one sampler
# call); then one denoiser evaluation of that model on the request's crop at
# fan-out GNN_CPU_REPS, on the card against the CPU within GNN_CPU_TOL.
GNN_ITERS = 10
GNN_EVAL = {'enabled': True, 'num_items': 2, 'num_samples': 4}
GNN_SAMPLES = 16
GNN_CPU_REPS = 2
GNN_CPU_TOL = 1e-3
# Phase 18, data parallelism: DP_STEPS steps of two gloo ranks sharing the
# card; DP_ALL_REDUCES timed all-reduces of the gradients at world size 1
# (NCCL); the CLI at 2 ranks against 1 for DP_CLI_ITERS float32 steps on a
# mini-SAbDab of DP_CLI_COMPLEXES (20 val, 3 train), losses within
# DP_CLI_RTOL (only the order of the sums differs); sharded
# sampling of DP_FANOUT rows a rank from seeds DP_SEED + rank.
DP_STEPS = 3
# The step against its halves accumulated in one process: only the order
# of float32 sums may differ.
DP_ACC_COS = 0.99999
DP_ACC_RTOL = 1e-5
DP_ALL_REDUCES = 20
DP_CLI_COMPLEXES = 26
DP_CLI_ITERS = 4
DP_CLI_RTOL = 1e-4
DP_FANOUT = 128
DP_SEED = 31
DP_WALL_S = 300           # each spawn of ranks, and the CLI's process
# H100 SXM peaks (NVIDIA data sheet): the bf16 dense tensor-core rate (the
# kernels' inputs are bf16 on the timed paths) and the HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def _cuda_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _layer_case(Nc, reps, n_pad, seed, device, Ln=L):
    """Seeded GABlock weights and inputs at the sampler's widths."""
    import torch
    from ab_opt_tpu_torch.geometry import quaternion_to_rotation_matrix
    from ab_opt_tpu_torch.nn.ipa import GABlock, precompute_pair_bias
    from ab_opt_tpu_torch.ops.gablock import build_gablock_weights
    torch.manual_seed(seed)
    block = GABlock(128, 64).to(device)
    N = Nc * reps
    x = torch.randn(N, Ln, 128)
    R9 = quaternion_to_rotation_matrix(torch.randn(N, Ln, 4)).reshape(N, Ln, 9)
    t = torch.randn(N, Ln, 3)
    z = torch.randn(Nc, Ln, Ln, 64)
    mask_c = torch.ones(Nc, Ln)
    if n_pad:
        mask_c[:, Ln - n_pad:] = 0.0
    mask = mask_c.repeat_interleave(reps, 0)
    to = lambda a: a.to(device).contiguous()
    zb = to(z).to(torch.bfloat16)
    bias = precompute_pair_bias(zb, block.proj_pair_bias.weight.t(),
                                to(mask_c), torch.bfloat16)
    wb = build_gablock_weights(block, torch.bfloat16)
    return (to(x), to(R9), to(t), zb, bias, to(mask), wb, reps)


def _nbytes(*tensors):
    return sum(a.numel() * a.element_size() for a in tensors)


def _bound(flops, nbytes):
    """The least time the card could take for bf16 work: the larger of the
    operations over the peak rate and the bytes over the memory rate.
    Returns (ms, 'operations' or 'bytes')."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def _gablock_flops(x, z, wb):
    """The GEMMs and attention products of one GABlock layer at their
    unpadded widths (projections; logits over QK + 3P + 2 terms a pair: the
    query-key product, the point distances and the two rank-1 norm terms;
    alpha times V + 3PV values; p2n over Cz)."""
    H, QK, V, P, PV = wb['dims']
    N, Ln, F = x.shape
    M, Cz, ko = N * Ln, z.shape[-1], wb['w_out'].shape[-2]
    proj = H * (2 * QK + V) + 3 * H * (2 * P + PV)
    per_pair = (QK + 3 * P + 2) + (V + 3 * PV) + Cz
    return (2 * M * F * proj + 2 * N * H * Ln * Ln * per_pair
            + 2 * M * ko * F + 3 * 2 * M * F * F)


def _gablock_bound(args):
    """K1's bound for one layer on these inputs: its operations, each input
    (weights included) read once and the output written once."""
    x, R9, t, z, bias, mask, wb, reps = args
    weights = [v for v in wb.values() if hasattr(v, 'numel')]
    return _bound(_gablock_flops(x, z, wb),
                  _nbytes(x, R9, t, z, bias, mask, *weights, x))


def _chain_bound(args):
    """K5's bound on these inputs: the operations of every layer, and x in
    and out, R9, t, mask, z, every layer's bias and weights each counted
    once."""
    stacked, layers, R9, t, x, z, biases, mask, reps = args
    weights = [v for v in stacked.values() if hasattr(v, 'numel')]
    return _bound(layers * _gablock_flops(x, z, stacked),
                  _nbytes(x, R9, t, mask, z, biases, *weights, x))


def _k1_gate(got, ref, valid):
    """K1's gate on valid rows: finite, and within TOL of the reference
    plus TOL of its magnitude. Returns (max_abs_err, ok)."""
    import torch
    err = (got[valid] - ref[valid]).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= TOL + TOL * ref[valid].abs()).all())
    return float(err.max()), ok


def phase_kernel(device):
    """Kernel vs plain version at the sampler's shapes and K1_CASES, each
    launched twice (the two outputs bitwise equal), then their times, K1
    against its plain version in alternated rounds, its launches and its
    attention against SDPA. Returns (max_abs_err, {reps: (kernel_ms,
    plain_ms)}, {reps: (bound_ms, bound_by)}, one K1 layer's launches at
    reps 256 as utils/micro_fused.py's profile_layer gives them)."""
    import torch
    from ab_opt_tpu_torch.ops.gablock import (attention_replicas,
                                              gablock_layer,
                                              gablock_layer_reference)
    torch.set_grad_enabled(False)
    worst, times, bounds = 0.0, {}, {}
    for Nc, reps, n_pad, Ln in K1_CASES:
        args = _layer_case(Nc, reps, n_pad, seed=Nc + reps + Ln - L,
                           device=device, Ln=Ln)
        got = gablock_layer(*args)
        again = gablock_layer(*args)
        torch.cuda.synchronize()
        ref = gablock_layer_reference(*args)
        max_err, ok = _k1_gate(got, ref, args[5] > 0)
        same = torch.equal(got, again)
        print(f'kernel vs plain (Nc={Nc}, reps={reps}, rt='
              f'{attention_replicas(reps)}, L={Ln}, padded rows={n_pad}): '
              f'max_abs_err={max_err:.6f} ok={ok}, second launch bitwise '
              f'equal={same}')
        if not (ok and same):
            raise SystemExit('GABlock kernel disagrees with its plain version'
                             ' or with itself')
        worst = max(worst, max_err)
        if Nc == 1 and Ln == L and reps in (32, 256):
            k_ms = _cuda_ms(lambda: gablock_layer(*args), 20)
            p_ms = _cuda_ms(lambda: gablock_layer_reference(*args), 5)
            k_ms2 = _cuda_ms(lambda: gablock_layer(*args), 20)
            times[reps] = (min(k_ms, k_ms2), p_ms)
            bounds[reps] = _gablock_bound(args)
            print(f'per-layer ms at reps={reps} (N={reps}, L={L}): '
                  f'kernel {k_ms:.4f} / {k_ms2:.4f}, plain {p_ms:.4f}, '
                  f'bound {bounds[reps][0]:.4f} ({bounds[reps][1]})')
    _k1_against_plain(device)
    rows = _k1_profile(device)
    _k1_attention_vs_sdpa(device)
    return worst, times, bounds, rows


def _k1_against_plain(device):
    """K1 against its plain version at K1_TIMED: each warmed first, then
    K1_ROUNDS rounds of K1_ITERS chained layers of each, the order
    alternated; the medians, and K1 / plain at most K1_PLAIN_RATIO at
    reps 256."""
    from ab_opt_tpu_torch.ops import gablock as gb
    from ab_opt_tpu_torch.utils import micro_fused as mf
    layers = {'K1': gb.gablock_layer, 'plain': gb.gablock_layer_reference}
    for reps, Ln in K1_TIMED:
        args = _layer_case(1, reps, 0, seed=reps + Ln, device=device, Ln=Ln)
        ms = mf.time_variants(args, layers, iters=K1_ITERS, rounds=K1_ROUNDS)
        med = mf.medians(ms)
        ratio = med['K1'] / med['plain']
        print(f'K1 against plain at reps={reps}, L={Ln} (median of '
              f'{K1_ROUNDS} alternated rounds of {K1_ITERS} chained layers): '
              + ', '.join(f'{n} {med[n]:.4f} ms (rounds '
                          f'{min(ms[n]):.4f}-{max(ms[n]):.4f})' for n in ms)
              + f'; K1 / plain {ratio:.4f}')
        if (reps, Ln) == (256, L) and ratio > K1_PLAIN_RATIO:
            raise SystemExit(f'K1 / plain {ratio:.4f} at reps 256 is above '
                             f'{K1_PLAIN_RATIO}')


def _k1_launch_floors(args):
    """{launch name fragment: (floor ms, 'bytes' or 'operations')} of each
    of K1's launches on these inputs: its operations over the bf16 peak,
    its inputs read once and outputs written once over the memory rate.
    The GEMM entries cover both launches of their epilogue (LN: out_transform
    + LN1 and MLP3 + LN2; ReLU: MLP1 and MLP2), as the profile sums them."""
    x, R9, t, z, bias, mask, wb, reps = args
    H = wb['dims'][0]
    N, Ln, F = x.shape
    M, pw, ko = N * Ln, wb['w_proj'].shape[1], wb['w_out'].shape[0]
    HD = H * 64
    alpha = N * H * Ln * Ln * 2
    return {
        'k1_proj_kernel': _bound(2 * M * F * pw, M * F * 4 + pw * F * 2
                                 + M * pw * 2),
        'assemble_kernel': _bound(0, M * pw * 2 + M * 12 * 4 + 3 * M * HD * 2),
        'k1_attn_kernel': _bound(4 * N * H * Ln * Ln * 64, 3 * M * HD * 2
                                 + _nbytes(bias) + M * HD * 2 + alpha),
        'p2n_kernel': _bound(2 * N * H * Ln * Ln * 64,
                             alpha + _nbytes(z) + M * H * 64 * 2),
        'feat_kernel': _bound(0, M * HD * 2 + M * 12 * 4
                              + M * (ko - H * 64) * 2),
        'k1_gemm_kernel<1,': _bound(2 * M * ko * F + 2 * M * F * F,
                                    M * ko * 2 + ko * F * 2 + 2 * M * F * 4
                                    + M * F * 2 + M * F * 2 + F * F * 2
                                    + 2 * M * F * 4),
        'k1_gemm_kernel<0,': _bound(2 * 2 * M * F * F,
                                    2 * (M * F * 2 + F * F * 2 + M * F * 2)),
    }


def _k1_profile(device):
    """One K1 layer at reps 256 under torch.profiler: each launch's device
    time beside its floor (the two LN GEMMs and the two ReLU GEMMs summed).
    Returns the profile's rows, one a launch."""
    from ab_opt_tpu_torch.utils import micro_fused as mf
    args = _layer_case(1, 256, 0, seed=7, device=device)
    rows = mf.profile_layer(args)
    total = sum(us for _, us in rows)
    floors = _k1_launch_floors(args)
    print(f'K1 per launch at reps=256, L={L} (torch.profiler): {total:.1f} us '
          'of device time')
    if mf.launch_us(rows) is None:
        print(f'  (not K1\'s nine launches in order: '
              f'{[name[:40] for name, _ in rows]})')
    for key, us, n in mf.by_kernel(rows):
        floor = next((f for frag, f in floors.items() if frag in key), None)
        fl = (f', floor {floor[0] * 1e3:.1f} us ({floor[1]}, {us / 1e3 / floor[0]:.1f}x)'
              if floor and floor[0] > 0 else '')
        print(f'  {us:9.1f} us {us / total:6.1%} x{n}{fl}  {key[:80]}')
    return rows


def _k1_attention_vs_sdpa(device):
    """K1's attention launch alone against scaled_dot_product_attention on
    the same operands (the same o: scale 1.0, the bias as an additive mask)
    at reps 256, L=128, H=12."""
    import torch
    from ab_opt_tpu_torch.ops import gablock as gb
    from ab_opt_tpu_torch.utils import micro_attention as mh
    H = 12
    qa, ka, vv, bias, _ = mh.make_operands(256, 256, L, H, 64, device,
                                           seed=11)
    o, alpha = gb.gablock_attention(qa, ka, vv, bias, 256)
    torch.cuda.synchronize()
    ref_o, ref_a = gb.gablock_attention_reference(qa, ka, vv, bias, 256)
    # alpha: K2's bf16 gate (both round the same f32 softmax once). o: an
    # alpha one ulp apart moves o by up to 2^-8 of |vv|, so o's atol is
    # ATTN_BF16_RTOL of the largest |vv| (the card tests' gate).
    err_o = (o.float() - ref_o.float()).abs()
    ok_o = bool(torch.isfinite(o).all()) and bool((
        err_o <= ATTN_BF16_RTOL * (float(vv.float().abs().max())
                                   + ref_o.float().abs())).all())
    errs = [(float(err_o.max()), None, ok_o), _bf16_gate(alpha, ref_a)]
    sdpa, layout = mh.sdpa_call(qa, ka, vv, bias, 256)
    sdpa_err = float((layout(sdpa()).float() - ref_o.float()).abs().max())
    ms = _cuda_ms(lambda: gb.gablock_attention(qa, ka, vv, bias, 256), 20)
    lib_ms = _cuda_ms(sdpa, 20)
    ms2 = _cuda_ms(lambda: gb.gablock_attention(qa, ka, vv, bias, 256), 20)
    N = 256
    bound = _bound(4 * N * H * L * L * 64,
                   _nbytes(qa, ka, vv, bias, o, alpha))
    print(f'K1 attention alone at N=256, reps=256, L={L}, H={H}: '
          f'{ms:.4f} / {ms2:.4f} ms (o {errs[0][0]:.6f}, alpha '
          f'{errs[1][0]:.6f} from plain), bound {bound[0]:.4f} '
          f'({bound[1]}); scaled_dot_product_attention (o only) '
          f'{lib_ms:.4f} ms (max |d o| {sdpa_err:.6f})')
    if not (errs[0][2] and errs[1][2]):
        raise SystemExit('K1 attention disagrees with its plain version')


def _attention_case(N, Ln, reps, dtype, n_pad, seed, device, H=12):
    """Seeded K2/K3 operands: qa, ka, vvp, bias, dout, dalphas."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g,
                                          device=device) * scale
    HD = H * 64
    qa, ka = r(N, Ln, HD, scale=0.5), r(N, Ln, HD, scale=0.5)
    vvp, dout = r(N, Ln, HD), r(N, Ln, HD)
    bias = r(N // reps, H, Ln, Ln)
    if n_pad:
        bias[..., Ln - n_pad:] -= 1e5
    dalphas = r(N, H, Ln, Ln, scale=0.1)
    return [a.to(dtype).contiguous()
            for a in (qa, ka, vvp, bias, dout, dalphas)]


def _attention_plan_check():
    """The wrapper's K2/K3 plan against the source's at L=16..512, both
    types, a few heads and replica counts."""
    import torch
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    for dtype in (torch.float32, torch.bfloat16):
        for Ln in range(16, ia.MAX_L + 1, 16):
            for H, reps in ((12, 1), (6, 3), (20, 4), (12, 256)):
                N = 4 * reps
                want = ia.plan_launches(ia.attention_plan(dtype, N, Ln, H, reps))
                got = ia.source_attention_plan(N, Ln, H, reps, dtype)
                if got != want:
                    raise SystemExit(f'K2/K3: the wrapper plans L={Ln}, H={H}, '
                                     f'reps={reps}, {dtype} unlike the source '
                                     f'({want} against {got})')
    print('K2/K3 plan: the wrapper\'s plan is the source\'s at L=16..512, '
          'float32 and bf16, (H, reps) (12, 1), (6, 3), (20, 4), (12, 256)')


def phase_attention(device):
    """K2/K3 vs their plain versions on both routes (see the module
    docstring, phase 4), then their times at the training slice's shapes
    against the CUDA-core kernels. Returns {'fwd': {...}, 'bwd': {...}}
    with max_abs_err, ms (eager, per call through the wrapper), device_ms
    (CUDA graphs), plain_ms, bound_ms and bound_by."""
    import torch
    from ab_opt_tpu_torch.ops import attention_variants as av
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    _attention_plan_check()
    res = {k: {'max_abs_err': 0.0} for k in ('fwd', 'bwd')}
    names = ('out', 'alphas', 'dqa', 'dka', 'dvvp', 'dbias')
    timed = None
    for N, Ln, reps, dname, n_pad in ATTN_CASES:
        dtype = getattr(torch, dname)
        qa, ka, vvp, bias, dout, dalphas = _attention_case(
            N, Ln, reps, dtype, n_pad, seed=N + Ln, device=device)
        H = bias.shape[1]
        plan = ia.attention_plan(dtype, N, Ln, H, reps)
        got = ia.ipa_attention_fwd(qa, ka, vvp, bias, reps)
        alphas = got[1]
        got_b = ia.ipa_attention_bwd(qa, ka, vvp, alphas, dout, dalphas)
        again = (ia.ipa_attention_fwd(qa, ka, vvp, bias, reps)
                 + ia.ipa_attention_bwd(qa, ka, vvp, alphas, dout, dalphas))
        torch.cuda.synchronize()
        ref = ia.ipa_attention_fwd_reference(qa, ka, vvp, bias, reps)
        ref_b = ia.ipa_attention_bwd_reference(qa, ka, vvp, alphas, dout,
                                               dalphas)
        errs = []
        for i, (name, a, b) in enumerate(zip(names, got + got_b,
                                             ref + ref_b)):
            err, atol, ok = _k4_gate(a, b, dtype)
            errs.append(f'{name} {err:.6f} (atol {atol:.2e})')
            key = 'fwd' if i < 2 else 'bwd'
            res[key]['max_abs_err'] = max(res[key]['max_abs_err'], err)
            if not ok:
                raise SystemExit(f'ipa_attention {name} disagrees with its '
                                 f'plain version (N={N}, L={Ln}, {dtype})')
        same = all(torch.equal(a, b) for a, b in zip(got + got_b, again))
        routes = '; '.join(
            f'{k} {plan[k]["route"]}: ' + ', '.join(
                f'{la["name"]} grid {la["grid"]} x {la["threads"]}, cluster '
                f'{la["cluster"]}, {la["smem"]} B' for la in plan[k]['launches'])
            for k in ('fwd', 'bwd'))
        rtol = (ATTN_BF16_RTOL if dtype == torch.bfloat16 else ATTN_F32_TOL)
        print(f'K2/K3 vs plain (N={N}, reps={reps}, L={Ln}, padded key '
              f'columns={n_pad}, {dname}, rtol {rtol}; {routes}): '
              f'max_abs_err ' + ', '.join(errs)
              + f'; two launches of each bitwise equal: {same}')
        if not same:
            raise SystemExit(f'two K2/K3 launches differ (N={N}, L={Ln})')
        if plan['fwd']['route'] != 'tile':
            continue
        v1 = av.attention_v1(qa, ka, vvp, bias, reps)
        torch.cuda.synchronize()
        s1_eq = all(torch.equal(a, b) for a, b in zip(got, v1))
        print(f'  K2 out and alphas bitwise equal to S1 v1: {s1_eq}')
        if not s1_eq:
            raise SystemExit(f'K2 disagrees with S1 v1 (N={N}, L={Ln})')
        if timed is None:
            timed = (N, Ln, reps, H, plan, qa, ka, vvp, bias, dout, dalphas,
                     got, got_b)

    # The tile route against the CUDA-core kernels on the same bf16
    # operands: eager calls (the tile through the wrapper, as the training
    # step calls it) and CUDA graphs of the same calls (device time alone:
    # an eager call of a kernel shorter than its host cost is host-paced).
    N, Ln, reps, H, plan, qa, ka, vvp, bias, dout, dalphas, got, got_b = timed
    alphas = got[1]
    cores = ia.attention_plan(torch.float32, N, Ln, H, reps)
    pairs = N * H * Ln * Ln
    bounds = {
        'fwd': _bound(4 * pairs * 64, _nbytes(qa, ka, vvp, bias, *got)),
        'bwd': _bound(8 * pairs * 64,
                      _nbytes(qa, ka, vvp, alphas, dout, dalphas, *got_b))}
    variants = {
        'fwd': {'tile': lambda: ia.ipa_attention_fwd(qa, ka, vvp, bias, reps),
                'CUDA cores': lambda: ia.fwd_on_route(qa, ka, vvp, bias, reps,
                                                      cores['fwd'])},
        'bwd': {'tile (one launch)': lambda: ia.ipa_attention_bwd(
                    qa, ka, vvp, alphas, dout, dalphas),
                'CUDA cores (two launches)': lambda: ia.bwd_on_route(
                    qa, ka, vvp, alphas, dout, dalphas, cores['bwd'])}}
    eager = {k: _rounds(v, ATTN_ROUNDS, ATTN_ITERS)
             for k, v in variants.items()}
    graph = {k: _graph_rounds(v, ATTN_ROUNDS, ATTN_ITERS)
             for k, v in variants.items()}
    plain = {'fwd': lambda: ia.ipa_attention_fwd_reference(qa, ka, vvp, bias,
                                                           reps),
             'bwd': lambda: ia.ipa_attention_bwd_reference(
                 qa, ka, vvp, alphas, dout, dalphas)}
    for key, k in (('fwd', 2), ('bwd', 3)):
        p_ms = _cuda_ms(plain[key], 10)
        name = next(iter(variants[key]))
        res[key].update(ms=eager[key][name], device_ms=graph[key][name],
                        plain_ms=p_ms, bound_ms=bounds[key][0],
                        bound_by=bounds[key][1])
        show = lambda t: ', '.join(f'{n} {v:.4f}' for n, v in t.items())
        print(f'K{k} ms at N={N}, L={Ln}, H={H}, bf16 (medians of '
              f'{ATTN_ROUNDS} alternated rounds of {ATTN_ITERS} calls): '
              f'eager per call {show(eager[key])}; device time (CUDA graphs) '
              f'{show(graph[key])}; plain {p_ms:.4f}, bound '
              f'{bounds[key][0]:.4f} ({bounds[key][1]})')
    # One K3 call on the tile route is one kernel: in a process of its own
    # (phase 3's profiler session leaves later ones here without device
    # events).
    child = subprocess.run(
        [sys.executable, '-m', 'ab_opt_tpu_torch.utils.profile_train',
         '--k3-launches'], capture_output=True, text=True, check=True)
    launched = json.loads(child.stdout.strip().splitlines()[-1])
    print(f'K3 one call on the tile route (N={TRAIN_BATCH}, L={L}, H=12, '
          f'bf16) under torch.profiler: {launched}')
    if sum(n for _, n in launched) != 1 or 'k3_tile_kernel' not in launched[0][0]:
        raise SystemExit('a K3 call on the tile route is not exactly one '
                         'device kernel')
    print(f'phase 4: {time.perf_counter() - t0:.2f} s')
    return res


def _denoiser_check(model, batch, plain, reps=4, remove=(True, True)):
    """One denoiser evaluation of the slice's model at full width, with the
    encoder through the kernel and through the plain version (``plain``:
    the keyword of ``DiffAb.prepare_denoiser`` that swaps the route's
    kernel wrapper for its plain version): same weights, same inputs, the
    context encoded with ``remove`` (remove_structure, remove_sequence).
    Returns (max |d eps_pos|, max |d R_next|, max |d c|)."""
    import torch
    from ab_opt_tpu_torch.geometry import rotation_to_so3vec
    with torch.no_grad():
        res_feat, pair_feat, R0, p0 = model.encode(batch, *remove)
        rep = lambda a: a.repeat_interleave(reps, 0)
        res_feat, R0, p0, gen, mres, aa = map(rep, (
            res_feat, R0, p0, batch['generate_flag'], batch['mask'],
            batch['aa']))
        v, p = rotation_to_so3vec(R0), model.normalize_position(p0)
        beta = torch.full((aa.shape[0],), 0.05, device=aa.device)
        outs = []
        for kw in ({}, plain):
            enc, hw = model.prepare_denoiser(pair_feat, mres, reps, **kw)
            outs.append(model.eps_net(v, p, aa, res_feat, pair_feat, beta,
                                      gen, mres, reps=reps, encoder_fn=enc,
                                      head_weights=hw))
    d = lambda i: float((outs[0][i].float() - outs[1][i].float()).abs().max())
    return d(2), d(1), d(3)


def phase_slice(device):
    """Three sampling requests; returns the kernel launches they made, the
    model, the complex and each request's (fan-out, samples/s)."""
    import numpy as np
    import torch
    from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig
    from ab_opt_tpu_torch.ops import gablock
    from ab_opt_tpu_torch.runners.design import BatchedSampler
    from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch

    torch.manual_seed(0)
    cfg = DiffAbConfig(dtype='bfloat16')
    model = DiffAb(cfg).to(device)
    batch = synthetic_batch(np.random.default_rng(0), N=1, L=L,
                            n_ab=int(L * 0.7), gen_lo=L // 4,
                            gen_hi=L // 4 + 8, device=device)
    d_pos, d_rot, d_seq = _denoiser_check(
        model, batch, {'layer': gablock.gablock_layer_reference})
    print(f'denoiser step, kernel vs plain encoder (reps=4): '
          f'max |d eps_pos|={d_pos:.5f}, max |d R_next|={d_rot:.5f}, '
          f'max |d seq probs|={d_seq:.5f}')
    if not (d_pos < DENOISER_TOL and d_rot < DENOISER_TOL
            and d_seq < DENOISER_TOL):
        raise SystemExit('denoiser through the kernel disagrees with the '
                         'plain path')

    sampler = BatchedSampler(model)
    expected = cfg.num_steps * cfg.num_layers
    ctx = ~batch['generate_flag'][0].cpu().numpy()
    pos_ctx = batch['pos_heavyatom'][0].cpu().numpy()[ctx]
    aa_ctx = batch['aa'][0].cpu().numpy()[ctx]
    gablock.reset_counts()
    total, rates = 0, []
    for i, reps in enumerate(FANOUTS):
        before = gablock.gablock_layer.launches
        plain_before = gablock.gablock_layer_reference.calls
        t0 = time.perf_counter()
        out = sampler(batch, seed=100 + i, num_replicas=reps)
        dt = time.perf_counter() - t0
        launches = gablock.gablock_layer.launches - before
        plain = gablock.gablock_layer_reference.calls - plain_before
        total += launches
        finite = all(np.isfinite(out[k]).all()
                     for k in ('v', 'p', 'pos_atom_new', 'prmsd',
                               'perplexity'))
        shapes_ok = (out['p'].shape == (reps, L, 3)
                     and out['pos_atom_new'].shape == (reps, L, 15, 3))
        ctx_same = ((out['pos_atom_new'][:, ctx] == pos_ctx).all()
                    and (out['s'][:, ctx] == aa_ctx).all())
        print(f'request {i + 1}: fan-out {reps}, {cfg.num_steps} steps: '
              f'{dt:.3f} s, {reps / dt:.3f} samples/s, '
              f'{dt * 1000.0 / cfg.num_steps:.3f} ms/step, '
              f'kernel launches {launches}, plain calls {plain}, '
              f'finite={finite}, shapes_ok={shapes_ok}, '
              f'context_unchanged={ctx_same}')
        if not (finite and shapes_ok and ctx_same and launches == expected
                and plain == 0):
            raise SystemExit(f'sampling request {i + 1} failed its checks')
        rates.append((reps, reps / dt))
    return total, model, batch, rates


def _train_draws(N, Ln, device, seed, num_steps=100):
    """t and every noise draw of one DiffAb.loss call, from one generator."""
    import torch
    from ab_opt_tpu_torch.models.losses import loss_draws
    g = torch.Generator(device=device).manual_seed(seed)
    return loss_draws(N, Ln, num_steps, g, device)


def _step_vs_plain(trainer, batch):
    """One training step's losses and gradients through K2/K3 and through
    their plain versions: same parameters, batch, t and draws."""
    import torch
    from ab_opt_tpu_torch.ops.ipa_attention import ipa_attention_plain
    t, draws = _train_draws(*batch['aa'].shape, trainer.device, seed=5,
                            num_steps=trainer.model.cfg.num_steps)
    out = []
    for attention in (None, ipa_attention_plain):
        losses = trainer.loss_and_grads(batch, t=t, draws=draws,
                                        attention=attention)
        grads = torch.cat([p.grad.float().reshape(-1)
                           for p in trainer.model.parameters()
                           if p.grad is not None])
        out.append(({k: float(v) for k, v in losses.items()}, grads))
    trainer.optimizer.zero_grad(set_to_none=True)
    (lk, gk), (lp, gp) = out
    rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lk}
    cos = float(torch.nn.functional.cosine_similarity(gk, gp, dim=0))
    nk, npl = float(gk.norm()), float(gp.norm())
    finite = all(map(math.isfinite, list(lk.values()) + list(lp.values())))
    print('train step, kernel vs plain attention: losses ' + ', '.join(
        f'{k} {lk[k]:.6f}/{lp[k]:.6f} (rel {rel[k]:.2e})' for k in lk))
    print(f'train step, kernel vs plain attention: gradient cosine '
          f'{cos:.6f}, global norms {nk:.6f} / {npl:.6f} '
          f'(rel {abs(nk / npl - 1):.2e}), {gk.numel()} entries')
    if not (finite and max(rel.values()) <= LOSS_RTOL and cos >= GRAD_COS
            and abs(nk / npl - 1) <= GRAD_NORM_RTOL):
        raise SystemExit('training step through K2/K3 disagrees with the '
                         'plain path')


def phase_train(device):
    """The training slice (see the module docstring, phase 6). Returns the
    K2 and K3 launches of the timed run."""
    import itertools

    import numpy as np
    import torch
    from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig
    from ab_opt_tpu_torch.ops import build
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.train import DIFFAB_TRAIN_CONFIG, Trainer
    from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch

    torch.set_grad_enabled(True)
    torch.manual_seed(2)
    cfg = DiffAbConfig(dtype='bfloat16')
    full = {'model': dataclasses.asdict(cfg), 'train': DIFFAB_TRAIN_CONFIG}
    log_dir = build.BUILD_DIR / 'chip_smoke_train'
    shutil.rmtree(log_dir, ignore_errors=True)
    trainer = Trainer(DiffAb(cfg), DIFFAB_TRAIN_CONFIG, log_dir=str(log_dir),
                      full_config=full)
    assert trainer.device.type == 'cuda'
    batch = synthetic_batch(np.random.default_rng(1), N=TRAIN_BATCH, L=L,
                            n_ab=int(L * 0.7), gen_lo=L // 4,
                            gen_hi=L // 4 + 8, device=trainer.device)
    _step_vs_plain(trainer, batch)

    # One warm-up step, then the timed run through Trainer.train.
    gen = torch.Generator(device=trainer.device).manual_seed(4)
    trainer.train_step(batch, generator=gen)
    torch.cuda.synchronize()
    first = trainer.iteration
    ia.reset_counts()
    t0 = time.perf_counter()
    # Trainer.train raises FloatingPointError on a non-finite loss at any
    # step; it ends by reading the last step's finite flag and saving a
    # checkpoint, so the time below covers all queued work and one save.
    trainer.train(itertools.repeat(batch), max_iters=first + TIMED_STEPS,
                  seed=3, log_every=TIMED_STEPS)
    seconds = time.perf_counter() - t0
    launches = (ia.ipa_attention_fwd.launches, ia.ipa_attention_bwd.launches)
    plain = (ia.ipa_attention_fwd_reference.calls,
             ia.ipa_attention_bwd_reference.calls)
    steps = trainer.iteration - first
    t1 = time.perf_counter()
    trainer.save()
    save_s = time.perf_counter() - t1
    step_s = (seconds - save_s) / steps
    layers = cfg.num_layers
    print(f'train: {steps} timed steps at batch {TRAIN_BATCH}, L={L}, bf16, '
          f'{layers} layers through Trainer.train: {seconds:.3f} s with the '
          f'final save, one save alone {save_s:.3f} s; without it '
          f'{step_s * 1e3:.3f} ms/step, {TRAIN_BATCH / step_s:.3f} samples/s')
    routes = ia.attention_plan(torch.bfloat16, TRAIN_BATCH, L, 12)
    print(f'train: K2 launches {launches[0]} ({routes["fwd"]["route"]} '
          f'route), K3 launches {launches[1]} ({routes["bwd"]["route"]} '
          f'route), plain calls {plain[0]} + {plain[1]}')
    if not (steps == TIMED_STEPS
            and launches == (layers * steps, layers * steps)
            and plain == (0, 0)):
        raise SystemExit('training steps failed their checks')

    # The checkpoint Trainer.train saved, resumed by a fresh trainer.
    path = log_dir / 'checkpoints' / f'{trainer.iteration}.ckpt'
    fresh = Trainer(DiffAb(cfg), DIFFAB_TRAIN_CONFIG, full_config=full)
    fresh.resume(str(path))
    same = all(torch.equal(a, b) for a, b in zip(
        trainer.model.state_dict().values(),
        fresh.model.state_dict().values()))
    losses = fresh.train_step(batch, generator=gen)
    finite = all(math.isfinite(float(v)) for v in losses.values())
    print(f'checkpoint {path.name}: restored iteration {fresh.iteration - 1}, '
          f'weights equal={same}; one more step: finite={finite}, overall '
          f'{float(losses["overall"]):.4f}')
    shutil.rmtree(log_dir, ignore_errors=True)
    if not (same and finite and fresh.iteration == trainer.iteration + 1):
        raise SystemExit('checkpoint round trip failed')
    return launches


def _rounds(calls, rounds, iters):
    """Median ms per call of each entry of ``calls`` ({name: fn}) over
    ``rounds`` rounds of ``iters`` calls, every entry warmed first and the
    order reversed every other round."""
    import statistics
    for fn in calls.values():
        fn()
    times = {k: [] for k in calls}
    order = list(calls)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(_cuda_ms(calls[k], iters))
    return {k: statistics.median(v) for k, v in times.items()}


def _graph_rounds(calls, rounds, iters):
    """Median device ms per call of each entry of ``calls`` ({name: fn}):
    each fn is warmed on a side stream, then captured ``iters`` times into
    one CUDA graph, and the graphs are replayed in ``rounds`` rounds, the
    order reversed every other round. The host's cost of a call (checks,
    allocation, the launch) drops out, which paces eager calls of kernels
    shorter than it."""
    import statistics
    import torch
    graphs = {}
    side = torch.cuda.Stream()
    for name, fn in calls.items():
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graphs[name] = graph
    times = {k: [] for k in calls}
    order = list(calls)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(_cuda_ms(graphs[k].replay, 1) / iters)
    return {k: statistics.median(v) for k, v in times.items()}


def _k4_gate(a, b, dtype):
    """K2's, K3's and K4's gates: bf16 within ATTN_BF16_RTOL of |plain| plus
    ATTN_BF16_ATOL_FRAC of the plain tensor's largest value, f32 within
    ATTN_F32_TOL. Returns (max_abs_err, atol, ok)."""
    import torch
    if dtype == torch.bfloat16:
        return _bf16_gate(a, b)
    b = b.float()
    err = (a.float() - b).abs()
    ok = bool(torch.isfinite(a).all()) and bool(
        (err <= ATTN_F32_TOL + ATTN_F32_TOL * b.abs()).all())
    return float(err.max()), ATTN_F32_TOL, ok


def phase_p2n(device):
    """K4 vs its plain version, K1's launches and its earlier design, then
    the times at the sampler's fan-out (see the module docstring, phase 7).
    Returns max_abs_err, ms, plain_ms, bound_ms and bound_by."""
    import torch
    from ab_opt_tpu_torch.ops import attention_variants as av
    from ab_opt_tpu_torch.ops import gablock as gb
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    res = {'max_abs_err': 0.0}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for Ln in range(16, 257, 16):
        plan = ia.fwd_p2n_plan(bf16, 8, Ln, 12, 64, 4)
        want = ([launch['smem'] for launch in plan['launches']]
                + [plan['query_rows'], plan['p2n_stages']])
        if ia.source_plan(Ln) != want:
            raise SystemExit(f'K4: the wrapper plans L={Ln} unlike the source '
                             f'({want} against {ia.source_plan(Ln)})')
    lib = ia._library()
    for Ln in range(16, ia.MAX_L + 1, 16):
        for dname, code in (('float32', 0), ('bfloat16', 1)):
            if Ln <= ia.TILE_MAX_L and code:
                continue
            plan = ia.fwd_p2n_plan(getattr(torch, dname), 8, Ln, 12, 64, 4)
            if lib.ipa_attention_fwd_p2n_tile(Ln, 12, code) != plan[
                    'query_rows']:
                raise SystemExit(f'K4: the wrapper plans the CUDA-core '
                                 f'route unlike the source at L={Ln}, {dname}')
    print('K4 plan: the wrapper\'s plan is the source\'s at L=16..256 (tile '
          'route) and L=16..512 (CUDA-core route)')
    timed = None
    for N, Ln, reps, dname, n_pad, *heads_cz in P2N_CASES:
        dtype = getattr(torch, dname)
        H, Cz = heads_cz or (12, 64)
        qa, ka, vvp, bias, _, _ = _attention_case(
            N, Ln, reps, dtype, n_pad, seed=N + Ln + 1, device=device, H=H)
        g = torch.Generator(device=device).manual_seed(N + Ln)
        z = torch.randn(N // reps, Ln, Ln, Cz, generator=g,
                        device=device).to(dtype).contiguous()
        plan = ia.fwd_p2n_plan(dtype, N, Ln, H, Cz, reps, sms)
        got = ia.ipa_attention_fwd_p2n(qa, ka, vvp, bias, z, reps)
        again = ia.ipa_attention_fwd_p2n(qa, ka, vvp, bias, z, reps)
        torch.cuda.synchronize()
        ref = ia.ipa_attention_fwd_p2n_reference(qa, ka, vvp, bias, z, reps)
        errs = []
        for name, a, b in zip(('out', 'p2n'), got, ref):
            err, atol, ok = _k4_gate(a, b, dtype)
            errs.append(f'{name} {err:.6f} (atol {atol:.2e})')
            res['max_abs_err'] = max(res['max_abs_err'], err)
            if not ok:
                raise SystemExit(f'ipa_attention_fwd_p2n {name} disagrees with '
                                 f'its plain version (N={N}, L={Ln}, {dtype})')
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        route = plan['route'] + (
            f' (rt {plan["rt"]}, p2n {plan["p2n_rows"]} query rows a block)'
            if plan['route'] == 'tile'
            else f' ({plan["query_rows"]} query rows a block)')
        grids = ', '.join(f'{la["name"]} grid {la["grid"]} x {la["threads"]}'
                          f', {la["smem"]} B' for la in plan['launches'])
        print(f'K4 vs plain (N={N}, reps={reps}, L={Ln}, H={H}, Cz={Cz}, '
              f'padded key columns={n_pad}, {str(dtype)[6:]}, route {route}: '
              f'{grids}): '
              f'max_abs_err ' + ', '.join(errs) + f'; two launches bitwise '
              f'equal: {same}')
        if not same:
            raise SystemExit(f'two K4 launches differ (N={N}, L={Ln})')
        if plan['route'] != 'tile':
            continue
        # The tile route runs K1's attention tile and K5's p2n: o is K1's
        # attention launch's bit for bit, p2n K1's p2n launch's on K1's
        # alpha.
        o_k1, alpha_k1 = gb.gablock_attention(qa, ka, vvp, bias, reps)
        p2n_k1 = gb.gablock_p2n(alpha_k1, z, reps)
        torch.cuda.synchronize()
        o_eq, p_eq = torch.equal(got[0], o_k1), torch.equal(got[1], p2n_k1)
        print(f'  o bitwise equal to K1\'s attention launch: {o_eq}; p2n to '
              f'K1\'s p2n launch: {p_eq}')
        if not (o_eq and p_eq):
            raise SystemExit(f'K4 disagrees with K1\'s launches (N={N}, '
                             f'L={Ln}, reps={reps})')
        if timed is None:
            timed = (N, Ln, reps, H, qa, ka, vvp, bias, z, got)

    N, Ln, reps, H, qa, ka, vvp, bias, z, got = timed
    ms = _rounds({
        'K4': lambda: ia.ipa_attention_fwd_p2n(qa, ka, vvp, bias, z, reps),
        'K1 attention + K1 p2n': lambda: gb.gablock_p2n(
            gb.gablock_attention(qa, ka, vvp, bias, reps)[1], z, reps),
        'S3 (v4)': lambda: av.attention_v4(qa, ka, vvp, bias, z, reps)},
        P2N_ROUNDS, P2N_ITERS)
    p_ms = _cuda_ms(lambda: ia.ipa_attention_fwd_p2n_reference(
        qa, ka, vvp, bias, z, reps), 5)
    bound = _bound(2 * N * H * Ln * Ln * (64 + 64 + 64),
                   _nbytes(qa, ka, vvp, bias, z, *got))
    res.update(ms=ms['K4'], plain_ms=p_ms, bound_ms=bound[0],
               bound_by=bound[1])
    print(f'K4 ms at N={N}, reps={reps}, L={Ln}, H={H}, Cz=64, bf16 '
          f'(medians of {P2N_ROUNDS} alternated rounds of {P2N_ITERS}): '
          + ', '.join(f'{k} {v:.4f}' for k, v in ms.items())
          + f'; plain {p_ms:.4f}, bound {bound[0]:.4f} ({bound[1]})')
    print(f'phase 7: {time.perf_counter() - t0:.2f} s')
    return res


def phase_paths(model, batch, k4_ms):
    """The rest of BatchedSampler (see the module docstring, phase 8);
    ``k4_ms``, K4's time at the request's shape (phase 7), prices K4's share
    of the ``'pallas'`` request. Returns K4's launches in the four
    requests."""
    import numpy as np
    import torch
    from ab_opt_tpu_torch.geometry import (construct_3d_basis,
                                           rotation_to_so3vec)
    from ab_opt_tpu_torch.models import DiffAb
    from ab_opt_tpu_torch.ops import gablock
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.runners.design import BatchedSampler

    cfg = model.cfg
    pallas = DiffAb(dataclasses.replace(cfg, ipa_impl='pallas'))
    pallas.load_state_dict(model.state_dict())
    pallas.to(batch['aa'].device)
    d_pos, d_rot, d_seq = _denoiser_check(
        pallas, batch, {'attention': ia.ipa_attention_fwd_p2n_reference})
    print(f"denoiser step, ipa_impl='pallas', K4 vs plain attention (reps=4):"
          f' max |d eps_pos|={d_pos:.5f}, max |d R_next|={d_rot:.5f}, '
          f'max |d seq probs|={d_seq:.5f}')
    if not (d_pos < DENOISER_TOL and d_rot < DENOISER_TOL
            and d_seq < DENOISER_TOL):
        raise SystemExit('denoiser through K4 disagrees with the plain path')

    T, layers = cfg.num_steps, cfg.num_layers
    requests = (   # (name, sampler, fan-out, K1 launches, K4 launches)
        ("ipa_impl='pallas'", BatchedSampler(pallas), P2N_FANOUT, 0,
         T * layers),
        ('opt_step=64', BatchedSampler(model, opt_step=64), 16, 64 * layers,
         0),
        ('stride=5', BatchedSampler(model, stride=5), 256,
         len(range(T, 0, -5)) * layers, 0),
        ('sample_structure=False', BatchedSampler(model,
                                                  sample_structure=False),
         32, T * layers, 0))
    ctx = ~batch['generate_flag'][0].cpu().numpy()
    pos = batch['pos_heavyatom'][0]
    pos_ctx = pos.cpu().numpy()[ctx]
    aa_ctx = batch['aa'][0].cpu().numpy()[ctx]
    native_v = rotation_to_so3vec(construct_3d_basis(
        pos[None, :, 1], pos[None, :, 2], pos[None, :, 0]))[0].cpu().numpy()
    native_ca = pos[:, 1].cpu().numpy()
    plain_calls = lambda: (gablock.gablock_layer_reference.calls
                           + ia.ipa_attention_fwd_reference.calls
                           + ia.ipa_attention_fwd_p2n_reference.calls)
    gablock.reset_counts()
    ia.reset_counts()
    for i, (name, sampler, reps, want_k1, want_k4) in enumerate(requests):
        k1 = gablock.gablock_layer.launches
        k4 = ia.ipa_attention_fwd_p2n.launches
        plain = plain_calls()
        t0 = time.perf_counter()
        out = sampler(batch, seed=200 + i, num_replicas=reps)
        dt = time.perf_counter() - t0
        k1 = gablock.gablock_layer.launches - k1
        k4 = ia.ipa_attention_fwd_p2n.launches - k4
        plain = plain_calls() - plain
        finite = all(np.isfinite(out[k]).all()
                     for k in ('v', 'p', 'pos_atom_new', 'prmsd',
                               'perplexity'))
        shapes_ok = (out['p'].shape == (reps, L, 3)
                     and out['pos_atom_new'].shape == (reps, L, 15, 3))
        ctx_same = bool((out['pos_atom_new'][:, ctx] == pos_ctx).all()
                        and (out['s'][:, ctx] == aa_ctx).all())
        frozen = ''
        frozen_ok = True
        if not sampler.sample_structure:
            d_p = float(np.abs(out['p'] - native_ca).max())
            d_v = float(np.abs(out['v'] - native_v).max())
            frozen_ok = d_p <= 1e-3 and d_v <= 1e-5
            frozen = (f', structure frozen: max |d p|={d_p:.2e} A, '
                      f'max |d v|={d_v:.2e}')
        share = (f', K4 {k4} x {k4_ms:.4f} ms = {k4 * k4_ms / 1e3:.3f} s '
                 f'({100 * k4 * k4_ms / 1e3 / dt:.1f}% of the request)'
                 if k4 else '')
        print(f'request {i + 1} ({name}): fan-out {reps}: {dt:.3f} s, '
              f'{reps / dt:.3f} samples/s, K1 launches {k1}, K4 launches '
              f'{k4}, plain calls {plain}, finite={finite}, '
              f'shapes_ok={shapes_ok}, context_unchanged={ctx_same}{frozen}'
              f'{share}')
        if not (finite and shapes_ok and ctx_same and frozen_ok
                and (k1, k4, plain) == (want_k1, want_k4, 0)):
            raise SystemExit(f'request {i + 1} ({name}) failed its checks')
    return ia.ipa_attention_fwd_p2n.launches


def phase_chain_kernel(device):
    """K5 vs its plain version and six K1 launches, then the times of all
    three (see the module docstring, phase 9). Returns max_abs_err (vs
    plain), ms, plain_ms, bound_ms and bound_by at reps 256."""
    import statistics
    import torch
    from ab_opt_tpu_torch.ops import gablock
    from ab_opt_tpu_torch.utils.bench_fixture import encoder_case
    from ab_opt_tpu_torch.utils.profile_chain import k5_and_six_k1
    torch.set_grad_enabled(False)
    for Ln in (L, 256):
        shape = gablock.chain_launch_shape(Ln, 12)
        print(f'K5 launch at L={Ln}, H=12: {shape["grid"]} blocks x '
              f'{shape["threads"]} threads, {shape["smem_bytes"]} bytes of '
              'shared memory a block')
    res = {'max_abs_err': 0.0}
    for Nc, reps, n_pad, Ln in CHAIN_CASES:
        args, bundles, biases = encoder_case(Ln, Nc, reps, LAYERS, n_pad,
                                             device, seed=10 + Nc + reps)
        _, _, R9, t, x, z, _, mask, _ = args

        def six_k1():
            y = x
            for wb, bias in zip(bundles, biases):
                y = gablock.gablock_layer(y, R9, t, z, bias, mask, wb, reps)
            return y

        kern = lambda: gablock.fused_encoder_chained(*args)
        plain = lambda: gablock.fused_encoder_chained_reference(*args)
        got, again, k1 = kern(), kern(), six_k1()
        torch.cuda.synchronize()
        ref = plain()
        valid = mask > 0
        err, ok = _k1_gate(got, ref, valid)
        err_k1 = float((got[valid] - k1[valid]).abs().max())
        same = torch.equal(got, again)
        ok = ok and same and err_k1 <= CHAIN_K1_TOL
        print(f'K5 vs plain, vs six K1 launches (Nc={Nc}, reps={reps}, '
              f'L={Ln}, padded rows={n_pad}, {LAYERS} layers): max_abs_err '
              f'{err:.6f}, {err_k1:.6f} (bitwise equal to six K1: '
              f'{torch.equal(got[valid], k1[valid])}), second launch bitwise '
              f'equal={same}, ok={ok}')
        if not ok:
            raise SystemExit('K5 disagrees with its plain version, with K1 or '
                             'with itself')
        res['max_abs_err'] = max(res['max_abs_err'], err)
        if (Nc, Ln) != (1, L):
            continue
        bound = _chain_bound(args)
        ms = k5_and_six_k1(args, bundles, biases, CHAIN_ROUNDS, CHAIN_ITERS)
        med = {n: statistics.median(v) for n, v in ms.items()}
        p_ms = _cuda_ms(plain, 3)
        print(f'K5 ms per encoder pass at reps={reps} (N={reps}, L={L}, '
              f'{LAYERS} layers; medians of {CHAIN_ROUNDS} alternated rounds '
              f'of {CHAIN_ITERS}): kernel {med["K5"]:.4f} (rounds '
              f'{min(ms["K5"]):.4f}-{max(ms["K5"]):.4f}), six K1 launches '
              f'{med["six K1"]:.4f} ({min(ms["six K1"]):.4f}-'
              f'{max(ms["six K1"]):.4f}), K5 / six K1 '
              f'{med["K5"] / med["six K1"]:.3f}, plain {p_ms:.4f}, bound '
              f'{bound[0]:.4f} ({bound[1]})')
        if reps == 256:
            res.update(ms=med['K5'], plain_ms=p_ms, bound_ms=bound[0],
                       bound_by=bound[1])
            # In a process of its own: phase 3's profiler session leaves
            # later ones in this process without device events.
            child = subprocess.run(
                [sys.executable, '-m', 'ab_opt_tpu_torch.utils.profile_chain',
                 '--launches'], capture_output=True, text=True, check=True)
            launched = json.loads(child.stdout.strip().splitlines()[-1])
            print(f'K5 one pass at reps=256 under torch.profiler: {launched}')
            if sum(n for _, n in launched) != 1:
                raise SystemExit('a K5 pass is not exactly one device kernel')
    return res


def phase_chain(model, batch, k1_rates):
    """The chained route (see the module docstring, phase 10). Returns
    K5's launches in the two requests."""
    import numpy as np
    from ab_opt_tpu_torch.ops import gablock
    from ab_opt_tpu_torch.runners.design import BatchedSampler
    saved = os.environ.get('AB_OPT_FUSED_CHAIN')
    os.environ['AB_OPT_FUSED_CHAIN'] = '1'
    try:
        d_pos, d_rot, d_seq = _denoiser_check(
            model, batch, {'chain': gablock.fused_encoder_chained_reference})
        print(f'denoiser step, AB_OPT_FUSED_CHAIN=1, K5 vs plain chain '
              f'(reps=4): max |d eps_pos|={d_pos:.5f}, max |d R_next|='
              f'{d_rot:.5f}, max |d seq probs|={d_seq:.5f}')
        if not (d_pos < DENOISER_TOL and d_rot < DENOISER_TOL
                and d_seq < DENOISER_TOL):
            raise SystemExit('denoiser through K5 disagrees with the plain '
                             'chain')
        sampler = BatchedSampler(model)
        T = model.cfg.num_steps
        import torch
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for reps in sorted(set(CHAIN_FANOUTS)):
            t0 = time.perf_counter()
            plan = gablock.chain_plan(reps, L, 12, reps, model.cfg.num_layers,
                                      sms)
            print(f'K5 work list at fan-out {reps}: {plan["items"].shape[0]} '
                  f'items, {plan["waits"].numel()} waits, built in '
                  f'{time.perf_counter() - t0:.3f} s on the host')
        ctx = ~batch['generate_flag'][0].cpu().numpy()
        pos_ctx = batch['pos_heavyatom'][0].cpu().numpy()[ctx]
        aa_ctx = batch['aa'][0].cpu().numpy()[ctx]
        plain_calls = lambda: (gablock.gablock_layer_reference.calls
                               + gablock.fused_encoder_chained_reference.calls)
        gablock.reset_counts()
        for i, reps in enumerate(CHAIN_FANOUTS):
            k5 = gablock.fused_encoder_chained.launches
            k1 = gablock.gablock_layer.launches
            plain = plain_calls()
            t0 = time.perf_counter()
            out = sampler(batch, seed=300 + i, num_replicas=reps)
            dt = time.perf_counter() - t0
            k5 = gablock.fused_encoder_chained.launches - k5
            k1 = gablock.gablock_layer.launches - k1
            plain = plain_calls() - plain
            finite = all(np.isfinite(out[k]).all()
                         for k in ('v', 'p', 'pos_atom_new', 'prmsd',
                                   'perplexity'))
            shapes_ok = (out['p'].shape == (reps, L, 3)
                         and out['pos_atom_new'].shape == (reps, L, 15, 3))
            ctx_same = bool((out['pos_atom_new'][:, ctx] == pos_ctx).all()
                            and (out['s'][:, ctx] == aa_ctx).all())
            k1_route = ', '.join(f'{r:.3f}' for n, r in k1_rates if n == reps)
            first = CHAIN_FANOUTS.index(reps) == i
            print(f'chained request {i + 1}: fan-out {reps}, {T} steps'
                  f'{" (K5 set-up included)" if first else ""}: '
                  f'{dt:.3f} s, {reps / dt:.3f} samples/s (K1 route, phase '
                  f'5: {k1_route}), {dt * 1000.0 / T:.3f} ms/step, K5 '
                  f'launches {k5}, K1 launches {k1}, plain calls {plain}, '
                  f'finite={finite}, shapes_ok={shapes_ok}, '
                  f'context_unchanged={ctx_same}')
            if not (finite and shapes_ok and ctx_same
                    and (k5, k1, plain) == (T, 0, 0)):
                raise SystemExit(f'chained request {i + 1} failed its checks')
    finally:
        if saved is None:
            del os.environ['AB_OPT_FUSED_CHAIN']
        else:
            os.environ['AB_OPT_FUSED_CHAIN'] = saved
    return gablock.fused_encoder_chained.launches


def _bf16_gate(a, b):
    """A bf16 kernel output against its plain version: finite, and each
    element within ATTN_BF16_RTOL of |plain| plus ATTN_BF16_ATOL_FRAC of the
    plain tensor's largest value. Returns (max_abs_err, atol, ok)."""
    import torch
    b = b.float()
    err = (a.float() - b).abs()
    atol = ATTN_BF16_ATOL_FRAC * float(b.abs().max())
    ok = bool(torch.isfinite(a).all()) and bool(
        (err <= atol + ATTN_BF16_RTOL * b.abs()).all())
    return float(err.max()), atol, ok


def phase_variants(device):
    """S1-S3 vs their plain versions, then the harness's run and the times
    (see the module docstring, phase 11). Returns {variant: row} with
    launches, max_abs_err, ms, plain_ms, bound_ms, bound_by and
    library_ms."""
    import torch
    from ab_opt_tpu_torch.ops import attention_variants as av
    from ab_opt_tpu_torch.ops import gablock as gb
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.utils import micro_attention as mh
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    H, Cz = 12, 64
    lib = av._library()
    for Ln in (16, 48, 128, 144, 256):
        if lib.attention_tile_smem(Ln) != av.tile_smem(Ln):
            raise SystemExit('the S1 wrapper plans shared memory unlike the '
                             'kernel')
        for N, reps in ((256, 256), (3, 3), (8, 4), (2, 1)):
            if (av.source_v4_plan(N, Ln, H, Cz, reps)
                    != av.v4_plan(N, Ln, H, Cz, reps)
                    or av.source_v2_plan(N, Ln, H, reps)
                    != av.v2_plan(N, Ln, H, reps)):
                raise SystemExit(f'the S2 or S3 wrapper plans unlike the '
                                 f'kernel (N={N}, L={Ln})')
    print(f'S1 block (K1\'s attention tile) at L={L}: '
          f'{lib.attention_tile_smem(L)} bytes; cap L=256 '
          f'({lib.attention_tile_smem(256)} bytes)')
    for Ln in (L, 256):
        print(f'S3 plan at N=256, reps=256, L={Ln}, H={H}, Cz={Cz}: '
              f'{av.v4_plan(256, Ln, H, Cz, 256)}; S2 plan: '
              f'{av.v2_plan(256, Ln, H, 256)} (the source\'s)')
    res = {k: {'max_abs_err': 0.0} for k in ('v1', 'v3', 'v2', 'v4')}
    timed = None
    for N, reps, Ln, n_pad in VARIANT_CASES:
        ops = mh.make_operands(N, reps, Ln, H, Cz, device, seed=N + Ln + 2,
                               n_pad=n_pad)
        qa, ka, vvp, bias, z = ops
        k2 = lambda: ia.ipa_attention_fwd_reference(qa, ka, vvp, bias, reps)
        k4 = lambda: ia.ipa_attention_fwd_p2n_reference(qa, ka, vvp, bias, z,
                                                        reps)
        cases = (   # (variant, kernel, plain, output names)
            ('v1', lambda: av.attention_v1(qa, ka, vvp, bias, reps), k2,
             ('out', 'alphas')),
            ('v3', lambda: (av.attention_v1(qa, ka, vvp, bias, reps,
                                            store_alphas=False),),
             lambda: k2()[:1], ('out',)),
            ('v2', lambda: av.attention_v2(qa, ka, vvp, bias, reps), k2,
             ('out', 'alphas')),
            ('v4', lambda: av.attention_v4(qa, ka, vvp, bias, z, reps), k4,
             ('out', 'p2n')))
        outputs = {}
        for name, kern, plain, names in cases:
            got = kern()
            torch.cuda.synchronize()
            errs = []
            for what, a, b in zip(names, got, plain()):
                err, atol, ok = _bf16_gate(a, b)
                errs.append(f'{what} {err:.6f} (atol {atol:.2e})')
                res[name]['max_abs_err'] = max(res[name]['max_abs_err'], err)
                if not ok:
                    raise SystemExit(f'attention {name} {what} disagrees with '
                                     f'its plain version (N={N}, L={Ln})')
            if name in ('v2', 'v4'):
                again = kern()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise SystemExit(f'two {name} calls differ (N={N}, '
                                     f'L={Ln})')
            outputs[name] = got
            print(f'{name} vs plain (N={N}, reps={reps}, L={Ln}, padded key '
                  f'columns={n_pad}, bf16, rtol {ATTN_BF16_RTOL}): '
                  f'max_abs_err ' + ', '.join(errs)
                  + ('; two calls bitwise equal' if name in ('v2', 'v4')
                     else ''))
        # v3 is v1 with the alpha stores compiled away: the same o.
        if not torch.equal(outputs['v3'][0], outputs['v1'][0]):
            raise SystemExit(f'v3 o differs from v1 o (N={N}, L={Ln})')
        # v4 runs K4's attention tile and p2n products: K4's bits.
        k4_got = ia.ipa_attention_fwd_p2n(qa, ka, vvp, bias, z, reps)
        if not all(torch.equal(a, b) for a, b in zip(outputs['v4'], k4_got)):
            raise SystemExit(f'v4 differs from K4 (N={N}, L={Ln})')
        d_v1 = [float((a.float() - b.float()).abs().max())
                for a, b in zip(outputs['v2'], outputs['v1'])]
        print(f'v3 o bitwise equal to v1 o; v4 o and p2n bitwise equal to '
              f'K4\'s (N={N}, reps={reps}, L={Ln}); v2 vs v1 max |d| out '
              f'{d_v1[0]:.6f}, alphas {d_v1[1]:.6f}')
        if timed is None:
            timed = (N, reps, Ln, ops, outputs, k2, k4)

    # One call of each of S3 and S2 is one kernel: each in a process of its
    # own (a profiler session after another in one process may record no
    # device events).
    for name, kernel in (('v4', 's3_kernel'), ('v2', 's2_kernel')):
        child = subprocess.run(
            [sys.executable, '-m', 'ab_opt_tpu_torch.utils.micro_attention',
             '--launches', name], capture_output=True, text=True, check=True)
        kernels = json.loads(child.stdout.strip().splitlines()[-1])
        print(f'one {name} call under torch.profiler (N=256, L={L}, H={H}): '
              f'{kernels}')
        if sum(n for _, n in kernels) != 1 or kernel not in kernels[0][0]:
            raise SystemExit(f'a {name} call is not exactly one device '
                             'kernel')

    # The variants' own path: the harness, counts zeroed just before it.
    N, reps, Ln, ops, outputs, k2, k4 = timed
    qa, ka, vvp, bias, z = ops
    av.reset_counts()
    ms = mh.time_variants(*ops, reps, iters=VARIANT_ITERS)
    counts = dict(av.launches)
    plain_k2, plain_k4 = _cuda_ms(k2, 5), _cuda_ms(k4, 5)
    sdpa, layout = mh.sdpa_call(qa, ka, vvp, bias, reps)
    sdpa_err = float((layout(sdpa()).float() - k2()[0].float()).abs().max())
    pairs = N * H * Ln * Ln
    inputs = _nbytes(qa, ka, vvp, bias)
    for name in res:
        got = outputs[name]
        flops = 4 * pairs * 64 + (2 * pairs * Cz if name == 'v4' else 0)
        nbytes = inputs + _nbytes(*got) + (_nbytes(z) if name == 'v4' else 0)
        bound = _bound(flops, nbytes)
        res[name].update(
            launches=counts[name], ms=ms[name],
            plain_ms=plain_k4 if name == 'v4' else plain_k2,
            bound_ms=bound[0], bound_by=bound[1],
            library_ms=ms['sdpa'] if name == 'v3' else None)
        print(f'{name} ms at N={N}, reps={reps}, L={Ln}, H={H}, bf16: kernel '
              f'{ms[name]:.4f}, plain {res[name]["plain_ms"]:.4f}, bound '
              f'{bound[0]:.4f} ({bound[1]}, {nbytes / 1e6:.1f} MB, '
              f'{flops / 1e9:.2f} GFLOP), harness launches {counts[name]}')
    print(f'same shape: v0 (K2) {ms["v0"]:.4f} ms, K4 {ms["k4"]:.4f} ms, p2n '
          f'einsum over K2 alphas {ms["p2n_einsum"]:.4f} ms, '
          f'scaled_dot_product_attention (v3 out) {ms["sdpa"]:.4f} ms '
          f'(max |d out| vs plain {sdpa_err:.6f})')
    if any(n != VARIANT_ITERS + 1 for n in counts.values()):
        raise SystemExit(f'the harness launched the variants {counts} times, '
                         f'not {VARIANT_ITERS + 1} each')
    # Each redesign against the kernels that compute its function, on the
    # same operands: S1 against K1's attention launch (the same tile with
    # alpha in K1's layout) and the library, S3 against K4, S2 against S1
    # v1 and K2.
    show = lambda t: ', '.join(f'{k} {v:.4f} ms' for k, v in t.items())
    where = (f'N={N}, reps={reps}, L={Ln}, H={H} (medians of '
             f'{VARIANT_ROUNDS} alternated rounds of {VARIANT_ITERS})')
    s1 = _rounds({
        'v3': lambda: av.attention_v1(qa, ka, vvp, bias, reps,
                                      store_alphas=False),
        'v1': lambda: av.attention_v1(qa, ka, vvp, bias, reps),
        'K1 attention': lambda: gb.gablock_attention(qa, ka, vvp, bias, reps),
        'sdpa': sdpa}, VARIANT_ROUNDS, VARIANT_ITERS)
    print(f'S1 at {where}: {show(s1)}; v3 / sdpa '
          f'{s1["v3"] / s1["sdpa"]:.3f}, v3 / K1 attention '
          f'{s1["v3"] / s1["K1 attention"]:.3f}, v1 / K1 attention '
          f'{s1["v1"] / s1["K1 attention"]:.3f}')
    s3 = _rounds({
        'v4': lambda: av.attention_v4(qa, ka, vvp, bias, z, reps),
        'K4': lambda: ia.ipa_attention_fwd_p2n(qa, ka, vvp, bias, z, reps)},
        VARIANT_ROUNDS, VARIANT_ITERS)
    print(f'S3 at {where}: {show(s3)}; v4 / K4 {s3["v4"] / s3["K4"]:.3f}')
    s2 = _rounds({
        'v2': lambda: av.attention_v2(qa, ka, vvp, bias, reps),
        'v1': lambda: av.attention_v1(qa, ka, vvp, bias, reps),
        'v0 (K2)': lambda: ia.ipa_attention_fwd(qa, ka, vvp, bias, reps)},
        VARIANT_ROUNDS, VARIANT_ITERS)
    print(f'S2 at {where}: {show(s2)}; v2 / v1 {s2["v2"] / s2["v1"]:.3f}, '
          f'v2 / v0 {s2["v2"] / s2["v0 (K2)"]:.3f}, v2 / bound '
          f'{s2["v2"] / res["v2"]["bound_ms"]:.3f}')
    print(f'phase 11: {time.perf_counter() - t0:.2f} s')
    return res


def phase_fused_variants(device, k1_rows):
    """S4 vs K1 and its plain versions, then the harness's run and the
    times (see the module docstring, phase 12); k1_rows: phase 3's profile
    of one K1 layer at the harness's shape. Returns {'v3': row, 'abl': row}
    with launches, max_abs_err, ms, plain_ms, bound_ms, bound_by and
    library_ms."""
    import torch
    from ab_opt_tpu_torch.ops import gablock as gb
    from ab_opt_tpu_torch.ops import gablock_variants as gv
    from ab_opt_tpu_torch.utils import micro_fused as mf
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()

    def gate(got, ref, valid, what, k1=None):
        err, ok = _k1_gate(got, ref, valid)
        same = k1 is None or torch.equal(got, k1)
        print(f'{what}: max_abs_err={err:.6f} ok={ok}'
              + ('' if k1 is None else f', bitwise K1={same}'))
        if not (ok and same):
            raise SystemExit(f'{what} disagrees with its plain version or '
                             'with K1')
        return err

    res = {k: {'max_abs_err': 0.0} for k in ('v3', 'abl')}
    cases = {}
    for Nc, reps, n_pad in FUSED_CASES:
        args = mf.make_case(Nc, reps, L, device, n_pad, seed=20 + Nc + reps)
        cases[(Nc, reps)] = args
        valid = args[5] > 0
        where = f'(Nc={Nc}, reps={reps}, padded rows={n_pad})'
        ref = gb.gablock_layer_reference(*args)
        k1 = gb.gablock_layer(*args)
        for rt in mf.RTS:
            if reps % rt == 0:
                got = gv.gablock_layer_v3(*args, rt=rt)
                torch.cuda.synchronize()
                res['v3']['max_abs_err'] = max(res['v3']['max_abs_err'], gate(
                    got, ref, valid, f'v3 rt={rt} vs plain {where}', k1))
        res['abl']['max_abs_err'] = max(res['abl']['max_abs_err'], gate(
            gv.gablock_layer_abl(*args), ref, valid,
            f'abl baseline (mask 0) vs plain {where}', k1))
        for flags in gv.ABLATIONS:
            name = 'floor' if flags == gv.FLOOR else flags[0]
            got = gv.gablock_layer_abl(*args, flags=flags)
            torch.cuda.synchronize()
            ref_f = gv.gablock_layer_abl_reference(*args, flags=flags)
            res['abl']['max_abs_err'] = max(res['abl']['max_abs_err'], gate(
                got, ref_f, valid,
                f'abl {name} (mask {gv.abl_mask(flags)}) vs plain {where}'))

    # The variants' own path: the harness, counts zeroed just before it.
    Nc, reps, _ = FUSED_CASES[0]
    rt = mf.RT
    args = cases[(Nc, reps)]
    gv.reset_counts()
    gb.reset_counts()
    rounds = mf.time_variants(args, mf.variants(rt), iters=FUSED_ITERS,
                              rounds=FUSED_ROUNDS)
    counts = dict(gv.launches)
    k1, plain = gb.gablock_layer.launches, (
        gb.gablock_layer_reference.calls
        + gv.gablock_layer_abl_reference.calls)
    n = FUSED_ROUNDS * FUSED_ITERS + 1
    print(f'harness at Nc={Nc}, reps={reps}, rt={rt}, L={L}: launches v3 '
          f'{counts["v3"]}, abl {counts["abl"]}, K1 {k1}, plain calls {plain}')
    print('each flag\'s K1 launches: device time from phase 3\'s profile of '
          'one K1 layer at this shape')
    mf.report(rounds, k1_rows)
    ms = mf.medians(rounds)
    if (counts, k1, plain) != ({'v3': n, 'abl': n * (len(gv.ABLATIONS) + 1)},
                               n, 0):
        raise SystemExit('the S4 harness launched the variants '
                         f'{counts}, K1 {k1} and the plain versions {plain} '
                         f'times, not {n} a variant')
    plain_ms = _cuda_ms(lambda: gb.gablock_layer_reference(*args), 3)
    bound = _gablock_bound(args)
    for key, name in (('v3', f'v3 rt={rt}'), ('abl', 'abl baseline')):
        res[key].update(launches=counts[key], ms=ms[name], plain_ms=plain_ms,
                        bound_ms=bound[0], bound_by=bound[1], library_ms=None)
    print(f'S4 ms per layer at reps={reps}: K1 {ms["K1"]:.4f}, v3 '
          f'{ms[f"v3 rt={rt}"]:.4f} ({ms[f"v3 rt={rt}"] / ms["K1"]:.3f}x K1), '
          f'abl baseline {ms["abl baseline"]:.4f} '
          f'({ms["abl baseline"] / ms["K1"]:.3f}x K1), plain {plain_ms:.4f}, '
          f'bound {bound[0]:.4f} ({bound[1]})')
    mf.report_rts(mf.time_variants(args, mf.rt_layers(reps),
                                   iters=FUSED_ITERS, rounds=FUSED_ROUNDS))
    print(f'phase 12: {time.perf_counter() - t0:.2f} s')
    return res


_STAGE_LOG = re.compile(
    r'variant (\S+) timing \((\d+) samples\): sample=([\d.]+)s '
    r'paste\+io=([\d.]+)s dockq=([\d.]+)s rank=([\d.]+)s total=([\d.]+)s')
_LAUNCH_LOG = re.compile(r'variant (\S+) kernel launches: (.*)')


def _stages_from_log(text):
    """design_for_structure's per-variant log lines as {tag: {'sample',
    'paste_io', 'dockq', 'rank', 'total', 'samples', 'launches'}}."""
    stage = {}
    for m in _STAGE_LOG.finditer(text):
        keys = ('sample', 'paste_io', 'dockq', 'rank', 'total')
        stage[m.group(1)] = dict(zip(keys, map(float, m.groups()[2:])),
                                 samples=int(m.group(2)))
    for m in _LAUNCH_LOG.finditer(text):
        stage[m.group(1)]['launches'] = {
            k: int(v) for k, v in (kv.split('=') for kv in m.group(2).split())}
    return stage


def _stage_text(t, cold):
    """One request's four stage times; ``cold``: its sample stage is a
    fresh process's first sampler call (start-up included), so no rate."""
    rate = ('the child\'s first sampler call, start-up included' if cold
            else f'{t["samples"] / t["sample"]:.3f} samples/s')
    return (f'sample {t["sample"]:.3f} s ({rate}), paste_io '
            f'{t["paste_io"]:.3f} s, dockq {t["dockq"]:.3f} s, rank '
            f'{t["rank"]:.3f} s')


def _check_design(name, out_dir, stage, launches_of, steps_of, cold=False,
                  unscored=()):
    """The file tree of tests/test_runner.py for every variant, every score
    of results.csv finite (but the columns of the scores in ``unscored``,
    which the model has no head for), every sample's context residues (all
    but the generated ones) equal to the native patch REF1.pdb at the PDB's
    3 decimals, and each variant's kernel launches (one sampler call a
    variant) equal to ``launches_of(variant)``."""
    import csv
    import numpy as np
    from ab_opt_tpu_torch.data import parse_pdb
    meta = json.loads((out_dir / 'metadata.json').read_text())
    problems = []
    if sorted(stage) != sorted(it['tag'] for it in meta['items']):
        raise SystemExit(f'design request {name}: the log timed variants '
                         f'{sorted(stage)}, metadata.json lists '
                         f'{[it["tag"] for it in meta["items"]]}')
    for item in meta['items']:
        tag, st = item['tag'], stage[item['tag']]
        vdir = out_dir / tag
        samples = sorted(vdir.glob('[0-9][0-9][0-9][0-9].pdb'))
        if len(samples) != st['samples'] or not (vdir / 'REF1.pdb').exists():
            problems.append(f'{tag}: {len(samples)} sample PDBs')
        ref, _ = parse_pdb(str(vdir / 'REF1.pdb'))
        first, last = item['residue_first'], item['residue_last']
        gen = np.array([c == first[0] and first[1] <= r <= last[1]
                        for c, r in zip(ref['chain_id'], ref['resseq'])])
        ctx = ~gen
        for f in samples:
            got, _ = parse_pdb(str(f))
            same = (got['chain_id'] == ref['chain_id']
                    and np.array_equal(got['resseq'], ref['resseq'])
                    and np.array_equal(got['aa'][ctx], ref['aa'][ctx])
                    and np.array_equal(got['mask_heavyatom'][ctx],
                                       ref['mask_heavyatom'][ctx])
                    and np.array_equal(got['pos_heavyatom'][ctx],
                                       ref['pos_heavyatom'][ctx]))
            if not same:
                problems.append(f'{tag}/{f.name}: context differs from REF1')
        want = launches_of(item)
        if st['launches'] != want:
            problems.append(f'{tag}: launches {st["launches"]}, want {want}')
    rows = list(csv.reader((out_dir / 'results.csv').open()))
    keep = [i for i, col in enumerate(rows[0])
            if i > 0 and col.split('_')[0] not in unscored]
    cells = [r[i] for r in rows[1:] for i in keep]
    bad = [c for c in cells if not math.isfinite(float(c or 'nan'))]
    if bad or len(rows) != len(meta['items']) + 1:
        problems.append(f'results.csv: {len(rows) - 1} rows, non-finite {bad}')
    for f in ('aa.csv', 'traj.pdb'):
        if not (out_dir / f).exists():
            problems.append(f'{f} missing')
    models = (out_dir / 'traj.pdb').read_text().count('MODEL ')
    if models != steps_of(meta['items'][-1]):
        problems.append(f'traj.pdb: {models} models')
    total = {k: sum(v[k] for v in stage.values())
             for k in ('sample', 'paste_io', 'dockq', 'rank', 'samples')}
    print(f'design request {name}: {len(meta["items"])} variant(s), '
          f'{total["samples"]} samples: stages {_stage_text(total, cold)}; '
          f'launches {[v["launches"] for v in stage.values()]}; '
          f'{"checks passed" if not problems else problems[:5]}')
    if problems:
        raise SystemExit(f'design request {name} failed its checks')
    return total


def _route_counts():
    """The kernels' launches (K1-K5) and their plain versions' calls."""
    from ab_opt_tpu_torch.ops import gablock
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    return {'K1': gablock.gablock_layer.launches,
            'K5': gablock.fused_encoder_chained.launches,
            'K2': ia.ipa_attention_fwd.launches,
            'K3': ia.ipa_attention_bwd.launches,
            'K4': ia.ipa_attention_fwd_p2n.launches,
            'plain': (gablock.gablock_layer_reference.calls
                      + gablock.fused_encoder_chained_reference.calls
                      + ia.ipa_attention_fwd_reference.calls
                      + ia.ipa_attention_bwd_reference.calls
                      + ia.ipa_attention_fwd_p2n_reference.calls)}


def _sampler_recorder(calls, sampled):
    """BatchedSampler.__call__ and a wrapper of it that appends, for each
    sampler call, its crop bucket L, fan-out, wall (the samples copied to
    the host) and the launches and plain calls it made to ``calls``, and
    keeps in ``sampled``, for the first call of each model at each crop
    bucket and fan-out, that call's (model, collated batch, fan-out,
    (remove_structure, remove_sequence)) for _check_sampled."""
    from ab_opt_tpu_torch.runners import design as D
    original = D.BatchedSampler.__call__

    def recording_call(self, batch, seed, num_replicas=1):
        key = (id(self.model), int(batch['aa'].shape[1]), num_replicas)
        sampled.setdefault(key, (self.model, batch, num_replicas,
                                 (self.sample_structure,
                                  self.sample_sequence)))
        before = _route_counts()
        t = time.perf_counter()
        out = original(self, batch, seed, num_replicas)
        after = _route_counts()
        calls.append(dict({k: after[k] - before[k] for k in after},
                          L=int(batch['aa'].shape[1]), reps=num_replicas,
                          s=time.perf_counter() - t))
        return out
    return original, recording_call


def _runner_log():
    """A handler on the runners' logger that keeps their INFO lines (the
    design runner's stage and launch lines, the test-set runner's relax
    skip) in a buffer; returns (buffer, detach)."""
    import io
    import logging
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    log = logging.getLogger('ab_opt_tpu_torch.runners')
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)

    def detach():
        log.removeHandler(handler)
        log.setLevel(level)
    return buf, detach


def _check_sampled(name, sampled, device, routes=('K1',)):
    """One denoiser evaluation of each model, crop and fan-out in
    ``sampled`` (see _sampler_recorder), at that fan-out, through each of
    ``routes`` (K1, K5) against the same route's plain version (bf16
    operands) within DENOISER_TOL. Run after a phase has read its launch
    counts: these launches are the comparison's, not the main path's."""
    from ab_opt_tpu_torch.data.collate import to_device_batch
    from ab_opt_tpu_torch.ops import gablock
    plains = {'K1': {'layer': gablock.gablock_layer_reference},
              'K5': {'chain': gablock.fused_encoder_chained_reference}}
    for model, single, reps, remove in sampled.values():
        batch = to_device_batch(single, device)
        Lc, n_res = batch['aa'].shape[1], int(batch['mask'].sum())
        for route in routes:
            if route == 'K5':
                os.environ['AB_OPT_FUSED_CHAIN'] = '1'
            d = _denoiser_check(model, batch, plains[route], reps=reps,
                                remove=remove)
            os.environ.pop('AB_OPT_FUSED_CHAIN', None)
            print(f'{name}: denoiser step, {model.cfg.dtype} model on its '
                  f'sampled crop (L={Lc}, {n_res} residues, reps={reps}, '
                  f'remove structure/sequence {remove}), {route} vs plain '
                  f'(bf16 operands): max |d eps_pos|='
                  f'{d[0]:.5f}, max |d R_next|={d[1]:.5f}, max |d seq '
                  f'probs|={d[2]:.5f}')
            if not max(d) < DENOISER_TOL:
                raise SystemExit(f'{name}: the denoiser through {route} '
                                 'disagrees with the plain route')


def phase_design(device, smi):
    """The design runner (see the module docstring, phase 13)."""
    from ab_opt_tpu_torch.ops import gablock
    from ab_opt_tpu_torch.runners import design as D
    from ab_opt_tpu_torch.tools.dockq import dockq as Q
    from ab_opt_tpu_torch.utils.bench_fixture import write_synthetic_complex
    from ab_opt_tpu_torch.utils.config import load_config
    t0 = time.perf_counter()
    if Q.native_library() is None:
        raise SystemExit('the DockQ contact kernel (tools/dockq/'
                         'fnat_kernel.cc) did not build or load')
    print(f'DockQ contact kernel: {Q.library_path().name} loaded')
    shutil.rmtree(DESIGN_OUT, ignore_errors=True)
    DESIGN_OUT.mkdir(parents=True)
    pdb = write_synthetic_complex(str(DESIGN_OUT / 'cx.pdb'))
    repo = Path(__file__).resolve().parent
    cfg = lambda name: dict(load_config(str(repo / 'configs' / 'test' /
                                            f'{name}.yml'))[0])
    codesign = cfg('codesign_single')
    T = codesign['model']['diffusion']['num_steps']
    NL = codesign['model']['diffusion']['eps_net_opt']['num_layers']
    k1 = lambda steps: {'K1': NL * steps, 'K5': 0, 'K4': 0}
    k5 = lambda steps: {'K1': 0, 'K5': steps, 'K4': 0}
    requests = (
        ('codesign_single, K1', 'codesign_single', DESIGN_SAMPLES, None,
         lambda it: k1(T), lambda it: T),
        ('codesign_single, K5', 'codesign_single', DESIGN_SAMPLES, '1',
         lambda it: k5(T), lambda it: T),
        ('abopt_singlecdr', 'abopt_singlecdr', DESIGN_SMALL, None,
         lambda it: k1(it['opt_step']), lambda it: it['opt_step']))
    # The in-process requests' stage and launch records: the runner's own
    # log lines, read as the CLI child's stderr is.
    log, detach = _runner_log()
    # The K1 request's sampler call: its model, crop and fan-out.
    calls, sampled = [], {}
    sampler_call, recording_call = _sampler_recorder(calls, sampled)
    saved = os.environ.pop('AB_OPT_FUSED_CHAIN', None)
    try:
        gablock.reset_counts()
        contacts = Q._contacts.native_calls
        totals = {}
        for i, (name, conf, n, chain, launches_of, steps_of) in enumerate(
                requests):
            if chain:
                os.environ['AB_OPT_FUSED_CHAIN'] = chain
            if i == 0:
                D.BatchedSampler.__call__ = recording_call
            log.seek(0)
            log.truncate()
            t1 = time.perf_counter()
            D.design_for_pdb(D.DesignArgs(
                pdb_path=pdb, config=cfg(conf), num_samples=n, batch_size=n,
                topk=4, seed=i, out_root=str(DESIGN_OUT / f'r{i + 1}')))
            wall = time.perf_counter() - t1
            D.BatchedSampler.__call__ = sampler_call
            os.environ.pop('AB_OPT_FUSED_CHAIN', None)
            totals[name] = _check_design(
                name, DESIGN_OUT / f'r{i + 1}' / 'cx.pdb',
                _stages_from_log(log.getvalue()), launches_of, steps_of)
            print(f'  wall {wall:.3f} s ({smi})')
        # calc_dockq counts contacts three times a sample (5 A on the model
        # and the native, 10 A on the native), all through the kernel.
        contacts = Q._contacts.native_calls - contacts
        scored = sum(t['samples'] for t in totals.values())
        print(f'DockQ contact kernel calls: {contacts} for {scored} samples')
        if contacts != 3 * scored:
            raise SystemExit('DockQ did not count every contact set with '
                             'the native kernel')
        if len(calls) != 1:
            raise SystemExit(f'the K1 request made {len(calls)} sampler '
                             'calls, not one')
        model, _, reps, _ = next(iter(sampled.values()))
        if model.cfg.dtype != 'float32' or reps != DESIGN_SAMPLES:
            raise SystemExit(f'the K1 request sampled a {model.cfg.dtype} '
                             f'model at fan-out {reps}')
        _check_sampled('the K1 design request', sampled, device,
                       ('K1', 'K5'))

        # dock_cdr through the CLI, as a user runs it (renumbering on).
        env = {k: v for k, v in os.environ.items()
               if k != 'AB_OPT_FUSED_CHAIN'}
        t1 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, '-m', 'ab_opt_tpu_torch.runners.design_cli',
             '--pdb_path', pdb, '-c', str(repo / 'configs' / 'test' /
                                          'dock_cdr.yml'),
             '-n', str(DESIGN_SMALL), '-b', str(DESIGN_SMALL), '--topk', '4',
             '-o', str(DESIGN_OUT / 'r4')], cwd=str(repo), env=env,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t1
        if child.returncode != 0:
            print(child.stderr[-4000:])
            raise SystemExit(f'design_cli exited {child.returncode}')
        totals['dock_cdr (CLI)'] = _check_design(
            'dock_cdr (CLI)', DESIGN_OUT / 'r4' / 'cx.pdb',
            _stages_from_log(child.stderr), lambda it: k1(T),
            lambda it: T, cold=True)
        print(f'  wall {wall:.3f} s, the child process included ({smi})')
    finally:
        D.BatchedSampler.__call__ = sampler_call
        detach()
        os.environ.pop('AB_OPT_FUSED_CHAIN', None)
        if saved is not None:
            os.environ['AB_OPT_FUSED_CHAIN'] = saved
    print(f'design stages ({smi}): ' + '; '.join(
        f'{name}: {_stage_text(t, name.endswith("(CLI)"))}'
        for name, t in totals.items()))
    print(f'phase 13: {time.perf_counter() - t0:.2f} s')


def _cli_recorders(steps, evals):
    """Wrappers of Trainer.train_step and sampling_eval.evaluate_samples that
    record, per step, its iteration, its time (the device synchronised at
    both ends), its losses and its K2/K3 launches, and per sampling eval
    its time, samples and K1 launches."""
    import torch
    from ab_opt_tpu_torch.ops import gablock
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.train import sampling_eval as se
    from ab_opt_tpu_torch.train import trainer as tr
    step, evaluate = tr.Trainer.train_step, se.evaluate_samples

    def timed_step(self, batch, *args, **kw):
        torch.cuda.synchronize()
        k2, k3 = ia.ipa_attention_fwd.launches, ia.ipa_attention_bwd.launches
        t1 = time.perf_counter()
        losses = step(self, batch, *args, **kw)
        torch.cuda.synchronize()
        steps.append({'it': self.iteration - 1, 's': time.perf_counter() - t1,
                      'losses': {k: float(v) for k, v in losses.items()},
                      'k2': ia.ipa_attention_fwd.launches - k2,
                      'k3': ia.ipa_attention_bwd.launches - k3,
                      'batch': batch if not steps else None})
        return losses

    def timed_eval(model, items, seed, num_samples=1, batch_size=8,
                   out_dir=None, device=None):
        torch.cuda.synchronize()
        k1 = gablock.gablock_layer.launches
        t1 = time.perf_counter()
        out = evaluate(model, items, seed, num_samples, batch_size, out_dir,
                       device)
        torch.cuda.synchronize()
        evals.append({'s': time.perf_counter() - t1,
                      'samples': len(items) * max(num_samples, 1),
                      'chunks': -(-len(items) // batch_size),
                      'k1': gablock.gablock_layer.launches - k1})
        return out

    return (tr.Trainer, 'train_step', step, timed_step), \
        (se, 'evaluate_samples', evaluate, timed_eval)


def _root_log_restorer():
    """The root logger's handlers and level now, and a function that puts
    them back (train_cli.main installs its own handlers), closing the
    handlers added since."""
    import logging
    root_log = logging.getLogger()
    handlers, level = root_log.handlers[:], root_log.level

    def restore():
        for h in root_log.handlers[:]:
            if h not in handlers:
                root_log.removeHandler(h)
                h.close()
        for h in handlers:
            if h not in root_log.handlers:
                root_log.addHandler(h)
        root_log.setLevel(level)
    return restore


def _check_cli_run(name, trainer, steps, first_it, last_it, device):
    """Every step of a CLI run finite, at the iterations first_it ..
    last_it - 1 in order, on ``device``, each with one K2 and one K3
    launch a layer."""
    layers = trainer.model.cfg.num_layers
    its = [st['it'] for st in steps]
    finite = all(math.isfinite(v) for st in steps
                 for v in st['losses'].values())
    per_step = {(st['k2'], st['k3']) for st in steps}
    print(f'train CLI {name}: iterations {its[0] if its else None}..'
          f'{its[-1] if its else None} ({len(its)} steps), finite={finite}, '
          f'K2/K3 launches a step {sorted(per_step)}')
    if not (its == list(range(first_it, last_it)) and finite
            and per_step == {(layers, layers)}
            and trainer.iteration == last_it
            and trainer.device.type == device.type):
        raise SystemExit(f'train CLI {name} failed its checks')


def phase_train_cli(device, smi):
    """The training CLI (see the module docstring, phase 14). Returns the
    launches of its main run (K1, K2, K3) and of the crop past 256 (K4)."""
    import statistics
    import tempfile

    import numpy as np
    import torch
    import yaml
    from ab_opt_tpu_torch.data import PaddingCollate, get_dataset
    from ab_opt_tpu_torch.data.collate import to_device_batch
    from ab_opt_tpu_torch.data.sabdab import SAbDabDataset
    from ab_opt_tpu_torch.models.diffab import encoder_route
    from ab_opt_tpu_torch.ops import gablock
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.runners import train_cli
    from ab_opt_tpu_torch.runners.design import BatchedSampler, random_model
    from ab_opt_tpu_torch.utils.bench_fixture import write_mini_sabdab
    from ab_opt_tpu_torch.utils.config import load_config
    t0 = time.perf_counter()
    torch.set_grad_enabled(True)
    repo = Path(__file__).resolve().parent
    steps, evals = [], []
    patches = _cli_recorders(steps, evals)
    restore_log = _root_log_restorer()
    saved_env = os.environ.pop('AB_OPT_FUSED_CHAIN', None)
    try:
        for owner, attr, _, wrapper in patches:
            setattr(owner, attr, wrapper)
        with tempfile.TemporaryDirectory(prefix='chip_smoke_cli_') as tmp:
            tmp = Path(tmp)
            paths = write_mini_sabdab(str(tmp), n=CLI_COMPLEXES)
            t1 = time.perf_counter()
            SAbDabDataset(summary_path=paths['summary_path'],
                          chothia_dir=paths['chothia_dir'],
                          processed_dir=paths['processed_dir'])
            prep_s = time.perf_counter() - t1
            print(f'train CLI: mini-SAbDab of {CLI_COMPLEXES} synthetic '
                  f'complexes preprocessed in {prep_s:.3f} s (parse, CDR '
                  f'labels, pickles, clusters; host) ({smi})')
            cfg = yaml.safe_load((repo / 'configs' / 'train' /
                                  'codesign_single.yml').read_text())
            for split in ('train', 'val'):
                cfg['dataset'][split].update(paths)
            cfg['train'].update(max_iters=CLI_ITERS, val_freq=CLI_VAL_FREQ,
                                sampling_eval=dict(CLI_EVAL))
            yml = tmp / 'codesign_single.yml'
            yml.write_text(yaml.safe_dump(cfg))
            batch_size = cfg['train']['batch_size']

            # The main run, its counts zeroed just before and read after.
            gablock.reset_counts()
            ia.reset_counts()
            t1 = time.perf_counter()
            trainer = train_cli.main(['--config', str(yml), '--logdir',
                                      str(tmp / 'logs')]).trainer
            wall = time.perf_counter() - t1
            run = _route_counts()
            _check_cli_run('run', trainer, steps, 0, CLI_ITERS, device)
            layers = trainer.model.cfg.num_layers
            T = trainer.model.cfg.num_steps
            first = steps[0]['batch']
            Lb = first['aa'].shape[1]
            routes = ia.attention_plan(torch.float32, batch_size, Lb, 12)
            step_s = statistics.median(st['s'] for st in steps[CLI_WARMUP:])
            in_steps = sum(st['k2'] for st in steps)
            print(f'train CLI: codesign_single ({trainer.model.cfg.dtype} '
                  f'config, batch {batch_size}, crop bucket L={Lb}, '
                  f'{layers} layers): K2 {routes["fwd"]["route"]} route, K3 '
                  f'{routes["bwd"]["route"]} route; median '
                  f'{step_s:.4f} s/step over steps {CLI_WARMUP + 1}-'
                  f'{len(steps)} (after {CLI_WARMUP} warm-up steps; '
                  f'min {min(st["s"] for st in steps[CLI_WARMUP:]):.4f}, '
                  f'max {max(st["s"] for st in steps[CLI_WARMUP:]):.4f}), '
                  f'first step {steps[0]["s"]:.4f} s; CLI wall {wall:.3f} s '
                  f'({smi})')
            print(f'train CLI: launches K1 {run["K1"]}, K2 {run["K2"]} '
                  f'({in_steps} in steps, {run["K2"] - in_steps} in val '
                  f'losses), K3 {run["K3"]}, K4 {run["K4"]}, K5 {run["K5"]}, '
                  f'plain calls {run["plain"]}')
            for i, ev in enumerate(evals):
                print(f'train CLI: sampling eval {i + 1}: {ev["samples"]} '
                      f'samples ({ev["chunks"]} chunk(s), {T} steps) in '
                      f'{ev["s"]:.3f} s, {ev["samples"] / ev["s"]:.3f} '
                      f'samples/s, K1 launches {ev["k1"]} ({smi})')
            n_evals = CLI_ITERS // CLI_VAL_FREQ
            log_dir = Path(trainer.log_dir)
            want = [log_dir / 'checkpoints' / f'{it}.ckpt' for it in
                    range(CLI_VAL_FREQ, CLI_ITERS + 1, CLI_VAL_FREQ)]
            want += [log_dir / 'sampling_eval' / f'it{it}' / 'results.csv'
                     for it in range(CLI_VAL_FREQ, CLI_ITERS + 1,
                                     CLI_VAL_FREQ)]
            missing = [str(f.relative_to(log_dir)) for f in want
                       if not f.exists()]
            best = sorted(p.name for p in
                          (log_dir / 'checkpoints').glob('best_rmsd_*.ckpt'))
            files = sorted(str(f.relative_to(log_dir))
                           for f in log_dir.rglob('*')
                           if f.is_file() and f.suffix != '.pdb')
            print(f'train CLI: log dir files {files}')
            if not (len(evals) == n_evals
                    and all(ev['k1'] == layers * T * ev['chunks']
                            for ev in evals)
                    and run['K1'] == sum(ev['k1'] for ev in evals)
                    and run['K4'] == run['K5'] == run['plain'] == 0
                    and run['K3'] == in_steps == layers * CLI_ITERS
                    and not missing and len(best) == 1):
                raise SystemExit(f'train CLI run failed its checks (missing '
                                 f'{missing}, best {best})')
            _step_vs_plain(trainer, first)

            # Resume from the last checkpoint, then finetune from it.
            last = want[n_evals - 1]
            steps.clear()
            resumed = train_cli.main(['--config', str(yml), '--resume',
                                      str(last), '--max_iters',
                                      str(CLI_ITERS)]).trainer
            _check_cli_run(f'resume from {last.name}', resumed, steps,
                           int(last.stem), CLI_ITERS, device)
            steps.clear()
            tuned = train_cli.main(['--config', str(yml), '--logdir',
                                    str(tmp / 'finetune'), '--finetune',
                                    str(last), '--finetune_iters',
                                    str(CLI_FINETUNE)]).trainer
            _check_cli_run(f'finetune from {last.name}', tuned, steps, 0,
                           CLI_FINETUNE, device)

            # A crop past 256 residues: codesign_fv's val crop, 'auto' on
            # the card takes K4's route.
            fv, _ = load_config(str(repo / 'configs' / 'train' /
                                    'codesign_fv.yml'))
            ds = get_dataset(dict(fv['dataset']['val'], **paths))
            crop = ds[0]
            batch = PaddingCollate()([crop])
            Lc = batch['aa'].shape[1]
            model = random_model(fv['model'], 5)
            route = encoder_route(model.cfg.ipa_impl, True, Lc, False)
            gablock.reset_counts()
            ia.reset_counts()
            t1 = time.perf_counter()
            out = BatchedSampler(model)(batch, seed=6,
                                        num_replicas=CLI_CROP_REPS)
            crop_s = time.perf_counter() - t1
            crop_run = _route_counts()
            finite = all(np.isfinite(out[k]).all()
                         for k in ('v', 'p', 'pos_atom_new', 'prmsd'))
            d = _denoiser_check(model, to_device_batch(batch, device),
                                {'attention':
                                 ia.ipa_attention_fwd_p2n_reference},
                                reps=CLI_CROP_REPS)
            print(f'crop past 256: codesign_fv val crop of '
                  f'{crop["aa"].shape[0]} residues (bucket L={Lc}), '
                  f'{model.cfg.dtype} model, ipa_impl={model.cfg.ipa_impl}: '
                  f'route {route}; fan-out {CLI_CROP_REPS}, {T} steps in '
                  f'{crop_s:.3f} s, launches K4 {crop_run["K4"]}, K1 '
                  f'{crop_run["K1"]}, K5 {crop_run["K5"]}, plain calls '
                  f'{crop_run["plain"]}, finite={finite}; denoiser step, K4 '
                  f'vs plain: max |d eps_pos|={d[0]:.6f}, max |d R_next|='
                  f'{d[1]:.6f}, max |d seq probs|={d[2]:.6f} ({smi})')
            if not (Lc > 256 and route == 'k4' and finite
                    and crop_run['K4'] == (model.cfg.num_layers
                                           * model.cfg.num_steps)
                    and crop_run['K1'] == crop_run['K5'] == 0
                    and crop_run['plain'] == 0
                    and gablock.gablock_layer.launches == 0
                    and max(d) < CLI_CROP_TOL):
                raise SystemExit('the crop past 256 failed its checks')
    finally:
        for owner, attr, original, _ in patches:
            setattr(owner, attr, original)
        restore_log()
        if saved_env is not None:
            os.environ['AB_OPT_FUSED_CHAIN'] = saved_env
    print(f'train CLI stages ({smi}): preprocess {prep_s:.3f} s, median '
          f'{step_s:.4f} s/step, sampling eval '
          + ', '.join(f'{ev["s"]:.3f} s ({ev["samples"] / ev["s"]:.3f} '
                      f'samples/s)' for ev in evals))
    print(f'phase 14: {time.perf_counter() - t0:.2f} s')
    return ({'K1': run['K1'], 'K2': run['K2'], 'K3': run['K3'],
             'K4': crop_run['K4']})


def _check_calls(name, calls, n_calls, layers, steps, reps):
    """``n_calls`` sampler calls, each at fan-out ``reps`` with one K1
    launch a layer a step and no K4, K5 or plain call."""
    per_call = sorted({(c['K1'], c['K4'], c['K5'], c['plain'])
                       for c in calls})
    print(f'{name}: {len(calls)} sampler calls, fan-out '
          f'{sorted({c["reps"] for c in calls})}, crop buckets L='
          f'{sorted({c["L"] for c in calls})}, (K1, K4, K5, plain) a call '
          f'{per_call}, sampler walls '
          f'{[round(c["s"], 3) for c in calls]} s')
    if not (len(calls) == n_calls and all(c['reps'] == reps for c in calls)
            and per_call == [(layers * steps, 0, 0, 0)]):
        raise SystemExit(f'{name}: the sampler calls failed their checks')


def _finite_csv(path, rows):
    """A CSV of ``rows`` data rows whose numeric cells are all finite."""
    import numpy as np
    import pandas as pd
    df = pd.read_csv(path)
    num = df.select_dtypes('number').to_numpy(float)
    return len(df) == rows and num.size > 0 and bool(np.isfinite(num).all())


def phase_testset(device, smi):
    """The test-set runner (see the module docstring, phase 15). Returns
    K1's launches in its runs."""
    import tempfile

    import numpy as np
    import yaml
    from ab_opt_tpu_torch.data.sabdab import SAbDabDataset
    from ab_opt_tpu_torch.ops import gablock
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.runners import design as D
    from ab_opt_tpu_torch.runners import testset
    from ab_opt_tpu_torch.tools.eval import evaluate_directory
    from ab_opt_tpu_torch.tools.relax import available_backends
    from ab_opt_tpu_torch.utils.bench_fixture import write_mini_sabdab
    t0 = time.perf_counter()
    repo = Path(__file__).resolve().parent
    out_root = DESIGN_OUT / 'testset'
    shutil.rmtree(out_root, ignore_errors=True)
    calls, sampled = [], {}
    original, recording_call = _sampler_recorder(calls, sampled)
    buf, detach = _runner_log()
    saved_env = os.environ.pop('AB_OPT_FUSED_CHAIN', None)
    runs = (('codesign_single', 'test', 2, True),
            ('seq_design_dock_testset', 'dock_test', 1, False))
    try:
        with tempfile.TemporaryDirectory(prefix='chip_smoke_testset_') as tmp:
            paths = write_mini_sabdab(tmp, n=TESTSET_COMPLEXES)
            t1 = time.perf_counter()
            SAbDabDataset(summary_path=paths['summary_path'],
                          chothia_dir=paths['chothia_dir'],
                          processed_dir=paths['processed_dir'])
            print(f'testset: mini-SAbDab of {TESTSET_COMPLEXES} synthetic '
                  f'complexes preprocessed in {time.perf_counter() - t1:.3f}'
                  f' s (host)')
            D.BatchedSampler.__call__ = recording_call
            gablock.reset_counts()
            ia.reset_counts()
            totals = {}
            for name, split, n, relax in runs:
                cfg = yaml.safe_load((repo / 'configs' / 'test' /
                                      f'{name}.yml').read_text())
                cfg['dataset']['test'].update(paths)
                model = cfg['model']
                layers = model['diffusion']['eps_net_opt']['num_layers']
                steps = model['diffusion']['num_steps']
                buf.seek(0)
                buf.truncate()
                calls.clear()
                t1 = time.perf_counter()
                summary = testset.design_for_testset(
                    cfg, out_root=str(out_root / split),
                    num_samples=TESTSET_SAMPLES, batch_size=TESTSET_SAMPLES,
                    seed=0, run_dockq=True, relax=relax)
                wall = time.perf_counter() - t1
                text = buf.getvalue()
                # One variant a complex, each with its stage line.
                found = [dict(zip(('sample', 'paste_io', 'dockq', 'rank'),
                                  map(float, m.groups()[2:6])),
                              samples=int(m.group(2)))
                         for m in _STAGE_LOG.finditer(text)]
                _check_calls(f'testset {name} on {split}', calls, n, layers,
                             steps, TESTSET_SAMPLES)
                ids = sorted(p.name for p in (out_root / split).iterdir()
                             if p.is_dir())
                trees = all(
                    (out_root / split / sid / f).exists() for sid in ids
                    for f in ('results.csv', 'aa.csv', 'metadata.json',
                              'H_CDR3/REF1.pdb',
                              f'H_CDR3/{TESTSET_SAMPLES - 1:04d}.pdb'))
                skips = text.count('[relax] skipped for')
                ok = (len(ids) == n and trees
                      and _finite_csv(out_root / split /
                                      'testset_results.csv', n)
                      and _finite_csv(out_root / split /
                                      'testset_summary.csv', 1)
                      and all(math.isfinite(v) for v in summary.values())
                      and skips == (n if relax else 0)
                      and len(found) == n)
                total = {k: sum(f[k] for f in found) for k in found[0]}
                totals[name] = total
                print(f'testset {name} on {split} ({n} complexes x '
                      f'{TESTSET_SAMPLES} samples, float32 config, '
                      f'{layers} layers, {steps} steps): wall {wall:.3f} s; '
                      f'stages {_stage_text(total, False)}; DockQ_mean '
                      f'{summary.get("DockQ_mean")}, AAR_mean '
                      f'{summary.get("AAR_mean")}; relax skips {skips} '
                      f'(backends {available_backends()}); '
                      f'{"checks passed" if ok else "FAILED"} ({smi})')
                if not ok:
                    raise SystemExit(f'testset {name} failed its checks')
            launches = _route_counts()
            D.BatchedSampler.__call__ = original
            _check_sampled('testset', sampled, device)
            # The evaluation pipeline over one complex's samples.
            sid = sorted(p for p in (out_root / 'test').iterdir()
                         if p.is_dir())[0]
            t1 = time.perf_counter()
            df = evaluate_directory(str(sid))
            eval_s = time.perf_counter() - t1
            finite = bool(np.isfinite(df[['rmsd', 'seqid']].to_numpy()).all())
            print(f'testset eval of {sid.name}: {len(df)} rows in '
                  f'{eval_s:.3f} s (host), rmsd mean {df["rmsd"].mean():.4f},'
                  f' seqid mean {df["seqid"].mean():.4f}, finite={finite}')
            if not (len(df) == TESTSET_SAMPLES and finite):
                raise SystemExit('evaluate_directory failed its checks')
    finally:
        D.BatchedSampler.__call__ = original
        detach()
        if saved_env is not None:
            os.environ['AB_OPT_FUSED_CHAIN'] = saved_env
    print(f'testset stages ({smi}): ' + '; '.join(
        f'{name}: {_stage_text(t, False)}' for name, t in totals.items()))
    print(f'phase 15: {time.perf_counter() - t0:.2f} s')
    return launches['K1']


def phase_optimize(device, smi):
    """The 3-stage optimization pipeline (see the module docstring, phase
    16). design-dock is not run: it needs the hdock binary, which the
    card's machine does not have. Returns K1's launches in stages 1-2."""
    from ab_opt_tpu_torch.ops import gablock
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.runners import design as D
    from ab_opt_tpu_torch.runners import optimize as O
    from ab_opt_tpu_torch.utils.bench_fixture import write_synthetic_complex
    from ab_opt_tpu_torch.utils.config import load_config
    t0 = time.perf_counter()
    repo = Path(__file__).resolve().parent
    root = DESIGN_OUT / 'optimize'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = lambda name: dict(load_config(str(repo / 'configs' / 'test' /
                                            f'{name}.yml'))[0])
    seq, dock = cfg('seq_design'), cfg('dock_cdr')
    calls, sampled = [], {}
    original, recording_call = _sampler_recorder(calls, sampled)
    stage_s = {}
    stages = {'stage 1 (seq design)': 'seq_design_batch',
              'stage 2 (re-dock)': 'dock_seqs'}
    saved = {attr: getattr(O, attr) for attr in stages.values()}

    def timed(name, fn):
        def run(*args):
            n0 = len(calls)
            t = time.perf_counter()
            out = fn(*args)
            stage_s[name] = (time.perf_counter() - t, calls[n0:])
            return out
        return run

    saved_env = os.environ.pop('AB_OPT_FUSED_CHAIN', None)
    try:
        # The poses: one dock_cdr request on the synthetic complex.
        pdb = write_synthetic_complex(str(root / 'cx.pdb'))
        t1 = time.perf_counter()
        D.design_for_pdb(D.DesignArgs(
            pdb_path=pdb, config=dock, num_samples=OPT_POSES,
            batch_size=OPT_POSES, keep_traj=False, run_dockq=False, seed=0,
            id='cx', out_root=str(root / 'poses')))
        pose_dir = root / 'poses' / 'cx' / 'H_CDR3'
        print(f'optimize: {len(O.scan_poses(str(pose_dir)))} poses from a '
              f'dock_cdr request in {time.perf_counter() - t1:.3f} s')

        for name, attr in stages.items():
            setattr(O, attr, timed(name, saved[attr]))
        D.BatchedSampler.__call__ = recording_call
        gablock.reset_counts()
        ia.reset_counts()
        t1 = time.perf_counter()
        df = O.optimize_antibody(O.OptimizeArgs(
            docked_pose_dir=str(pose_dir),
            seq_design_dir=str(root / 'seq_design'),
            screen_dir=str(root / 'screen'), design_config=seq,
            dock_config=dock, heavy_chain_id='H', nums=OPT_NUMS,
            num_designs=OPT_DESIGNS, max_poses=OPT_MAX_POSES, seed=0,
            batch_size=OPT_BATCH))
        wall = time.perf_counter() - t1
        launches = _route_counts()
    finally:
        D.BatchedSampler.__call__ = original
        for attr, fn in saved.items():
            setattr(O, attr, fn)
        if saved_env is not None:
            os.environ['AB_OPT_FUSED_CHAIN'] = saved_env
    layers = seq['model']['diffusion']['eps_net_opt']['num_layers']
    steps = seq['model']['diffusion']['num_steps']
    n_cand = OPT_MAX_POSES * OPT_DESIGNS
    for (name, (s, stage_calls)), n, reps in zip(
            stage_s.items(), (OPT_MAX_POSES, n_cand),
            (OPT_DESIGNS, OPT_NUMS)):
        _check_calls(f'optimize {name}', stage_calls, n, layers, steps, reps)
        sampler_s = sum(c['s'] for c in stage_calls)
        print(f'optimize {name}: wall {s:.3f} s, sampler calls '
              f'{sampler_s:.3f} s ({smi})')
    summary = root / 'screen' / 'screening_summary.csv'
    finite = _finite_csv(summary, n_cand) and bool(
        df[['DockQ_avg', 'prmsd_avg']].notna().all().all())
    print(f'optimize: {len(df)} candidates, DockQ_avg '
          f'{df["DockQ_avg"].round(4).tolist()}, prmsd_avg '
          f'{df["prmsd_avg"].round(4).tolist()}, selected '
          f'{int(df["selected"].sum())}, confident '
          f'{int(df["confident"].sum())}; wall {wall:.3f} s; launches K1 '
          f'{launches["K1"]}, K4 '
          f'{launches["K4"]}, K5 {launches["K5"]}, plain calls '
          f'{launches["plain"]} ({smi})')
    if not (len(df) == n_cand and finite
            and launches['K1'] == layers * steps * (OPT_MAX_POSES + n_cand)
            and launches['K4'] == launches['K5'] == launches['plain'] == 0):
        raise SystemExit('the optimize pipeline failed its checks')
    _check_sampled('optimize', sampled, device)
    print(f'phase 16: {time.perf_counter() - t0:.2f} s')
    return launches['K1']


def _gnn_cpu_check(model, single, reps, remove, device):
    """One denoiser evaluation of the graph model on the card and of a copy
    on the CPU (same weights, the same crop at fan-out ``reps``, the same
    noisy state at t = T / 2): (max |d aa logits|, max |d z|)."""
    import copy

    import torch
    from ab_opt_tpu_torch.data.collate import to_device_batch
    from ab_opt_tpu_torch.geometry import random_uniform_so3
    cpu = torch.device('cpu')
    outs = []
    for m, dev in ((model, device), (copy.deepcopy(model).to(cpu), cpu)):
        b = to_device_batch(single, dev)
        with torch.no_grad():
            prep = m._prepare(b, *remove).repeat(reps)
            gen, v0, p0 = prep.gen, prep.v_0, prep.p_0
            g = torch.Generator().manual_seed(0)
            v = torch.where(gen[..., None], random_uniform_so3(
                gen.shape, g).to(dev), v0)
            p = torch.where(gen[..., None], torch.randn(
                p0.shape, generator=g).to(dev), p0)
            aa, z, _, _ = m._denoiser((v, p, m.cfg.num_steps // 2), prep)
        outs.append((aa.float().cpu(), z.float().cpu()))
    return tuple(float((a - b).abs().max()) for a, b in zip(*outs))


def phase_gnn(device, smi):
    """The graph model through the training CLI and the design runner (see
    the module docstring, phase 17)."""
    import statistics
    import tempfile

    import torch
    import yaml
    from ab_opt_tpu_torch.models import DiffGNN
    from ab_opt_tpu_torch.ops import gablock
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.runners import design as D
    from ab_opt_tpu_torch.runners import train_cli
    from ab_opt_tpu_torch.utils.bench_fixture import write_mini_sabdab
    from ab_opt_tpu_torch.utils.config import load_config
    t0 = time.perf_counter()
    torch.set_grad_enabled(True)
    repo = Path(__file__).resolve().parent
    gib = lambda n: n / 2 ** 30
    steps, evals = [], []
    patches = _cli_recorders(steps, evals)
    calls, sampled = [], {}
    sampler_call, recording_call = _sampler_recorder(calls, sampled)
    restore_log = _root_log_restorer()
    saved_env = os.environ.pop('AB_OPT_FUSED_CHAIN', None)
    log, detach = _runner_log()
    try:
        for owner, attr, _, wrapper in patches:
            setattr(owner, attr, wrapper)
        with tempfile.TemporaryDirectory(prefix='chip_smoke_gnn_') as tmp:
            tmp = Path(tmp)
            paths = write_mini_sabdab(str(tmp), n=CLI_COMPLEXES)
            cfg = yaml.safe_load((repo / 'configs' / 'train' /
                                  'aa_label.yml').read_text())
            for split in ('train', 'val'):
                cfg['dataset'][split].update(paths)
            cfg['train'].update(max_iters=GNN_ITERS, val_freq=GNN_ITERS,
                                sampling_eval=dict(GNN_EVAL))
            yml = tmp / 'aa_label.yml'
            yml.write_text(yaml.safe_dump(cfg))

            # The training run, its counts zeroed just before and read after.
            gablock.reset_counts()
            ia.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            trainer = train_cli.main(['--config', str(yml), '--logdir',
                                      str(tmp / 'logs')]).trainer
            wall = time.perf_counter() - t1
            train_peak = torch.cuda.max_memory_allocated()
            run = _route_counts()
            model = trainer.model
            T = model.cfg.num_steps
            Lb = steps[0]['batch']['aa'].shape[1] if steps else None
            step_s = statistics.median(st['s'] for st in steps[CLI_WARMUP:])
            finite = all(math.isfinite(v) for st in steps
                         for v in st['losses'].values())
            print(f'GNN train CLI: aa_label ({type(model).__name__}, '
                  f'{model.cfg.dtype}, hidden {model.cfg.hidden_size}, '
                  f'{model.cfg.n_layers} layers, hotspot '
                  f'{model.cfg.hotspot}, batch {cfg["train"]["batch_size"]},'
                  f' crop bucket L={Lb}): {len(steps)} steps, finite='
                  f'{finite}, median {step_s:.4f} s/step over steps '
                  f'{CLI_WARMUP + 1}-{len(steps)} (min '
                  f'{min(st["s"] for st in steps[CLI_WARMUP:]):.4f}, max '
                  f'{max(st["s"] for st in steps[CLI_WARMUP:]):.4f}), first '
                  f'step {steps[0]["s"]:.4f} s; CLI wall {wall:.3f} s '
                  f'(preprocessing included); peak memory allocated '
                  f'{gib(train_peak):.2f} GiB ({smi})')
            for ev in evals:
                print(f'GNN train CLI: sampling eval: {ev["samples"]} '
                      f'samples ({ev["chunks"]} chunk(s), {T} steps) in '
                      f'{ev["s"]:.3f} s, {ev["samples"] / ev["s"]:.3f} '
                      f'samples/s ({smi})')
            print(f'GNN train CLI: launches {run}')
            log_dir = Path(trainer.log_dir)
            ckpt = log_dir / 'checkpoints' / f'{GNN_ITERS}.ckpt'
            best = list((log_dir / 'checkpoints').glob('best_rmsd_*.ckpt'))
            results = (log_dir / 'sampling_eval' / f'it{GNN_ITERS}' /
                       'results.csv')
            if not (isinstance(model, DiffGNN) and finite
                    and [st['it'] for st in steps] == list(range(GNN_ITERS))
                    and all(st['k2'] == st['k3'] == 0 for st in steps)
                    and trainer.device.type == device.type
                    and len(evals) == 1 and evals[0]['k1'] == 0
                    and not any(run.values()) and ckpt.exists()
                    and len(best) == 1 and results.exists()):
                raise SystemExit('the GNN training CLI failed its checks')

            # A design request from the checkpoint that run wrote.
            design_cfg = dict(load_config(str(repo / 'configs' / 'test' /
                                              'codesign_single.yml'))[0])
            pdb = Path(paths['chothia_dir']) / '1xa0.pdb'
            out_root = DESIGN_OUT / 'gnn'
            shutil.rmtree(out_root, ignore_errors=True)
            D.BatchedSampler.__call__ = recording_call
            log.seek(0)
            log.truncate()
            gablock.reset_counts()
            ia.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            D.design_for_pdb(D.DesignArgs(
                pdb_path=str(pdb), ckpt=str(ckpt), config=design_cfg,
                num_samples=GNN_SAMPLES, batch_size=GNN_SAMPLES, topk=4,
                seed=17, out_root=str(out_root)))
            dwall = time.perf_counter() - t1
            design_peak = torch.cuda.max_memory_allocated()
            D.BatchedSampler.__call__ = sampler_call
            drun = _route_counts()
            stage = _stages_from_log(log.getvalue())
            total = _check_design(
                'GNN checkpoint, codesign_single', out_root / pdb.name,
                stage, lambda it: {'K1': 0, 'K5': 0, 'K4': 0}, lambda it: T,
                unscored=('prmsd', 'PPL'))
            (dmodel, single, reps, remove), = sampled.values()
            Lc = single['aa'].shape[1]
            print(f'GNN design request: {GNN_SAMPLES} samples, crop bucket '
                  f'L={Lc}, {T} steps: wall {dwall:.3f} s; stages '
                  f'{_stage_text(total, False)}; '
                  f'{1e3 * total["sample"] / T:.2f} ms per reverse step '
                  f'(the sample stage over {T} steps); peak memory allocated '
                  f'{gib(design_peak):.2f} GiB; sampler calls {len(calls)}, '
                  f'launches {drun} ({smi})')
            if not (isinstance(dmodel, DiffGNN) and len(calls) == 1
                    and reps == GNN_SAMPLES and not any(drun.values())):
                raise SystemExit('the GNN design request failed its checks')
            d = _gnn_cpu_check(dmodel, single, GNN_CPU_REPS, remove, device)
            print(f'GNN denoiser on the card vs the CPU (its crop, fan-out '
                  f'{GNN_CPU_REPS}, t={T // 2}, TF32 off): max |d aa '
                  f'logits|={d[0]:.2e}, max |d z|={d[1]:.2e}')
            if not max(d) < GNN_CPU_TOL:
                raise SystemExit('the GNN denoiser on the card disagrees '
                                 'with the CPU')
    finally:
        D.BatchedSampler.__call__ = sampler_call
        detach()
        for owner, attr, original, _ in patches:
            setattr(owner, attr, original)
        restore_log()
        if saved_env is not None:
            os.environ['AB_OPT_FUSED_CHAIN'] = saved_env
    print(f'phase 17: {time.perf_counter() - t0:.2f} s')


def _dp_batch(N, Ln, seed):
    """The training slice's synthetic complex (phase 6), N rows, row i
    generating L/4 + 4 + i residues: the ranks' shards differ in their
    generated-residue counts, as real CDR batches do."""
    import numpy as np
    from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch
    batch = {k: v.numpy() for k, v in synthetic_batch(
        np.random.default_rng(seed), N=N, L=Ln, n_ab=int(Ln * 0.7),
        gen_lo=Ln // 4, gen_hi=Ln // 4 + 8).items()}
    gen = np.zeros_like(batch['generate_flag'])
    for i in range(N):
        gen[i, Ln // 4:Ln // 4 + 4 + i] = True
    batch['generate_flag'] = gen
    return batch


def _dp_gate(name, got, want, grads=None):
    """The training gate (phase 6's): every loss of every step within
    LOSS_RTOL relative; with ``grads`` (got, want) the first step's
    gradient cosine and global norms."""
    import torch
    rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
              for g, w in zip(got, want) for k in w)
    finite = all(math.isfinite(v) for g in got for v in g.values())
    ok = finite and rel <= LOSS_RTOL and len(got) == len(want)
    text = f'{name}: {len(got)} steps, max loss rel {rel:.3e}'
    if grads is not None:
        a, b = (g.double() for g in grads)
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        na, nb = float(a.norm()), float(b.norm())
        ok = ok and cos >= GRAD_COS and abs(na / nb - 1) <= GRAD_NORM_RTOL
        text += (f', first step gradient cosine {cos:.8f}, norms {na:.6f} / '
                 f'{nb:.6f}, max |d| {float((a - b).abs().max()):.3e} of '
                 f'max |g| {float(b.abs().max()):.3e}, bitwise '
                 f'{torch.equal(a, b)}')
    print(text)
    if not ok:
        raise SystemExit(f'{name} fails the training gate')


def _dp_accumulated(name, dp, one, acc):
    """The first step of a data-parallel run ``dp`` against the halves
    accumulated in one process ``acc`` (rehearse.accumulate): every loss
    within DP_ACC_RTOL, the gradients' cosine at least DP_ACC_COS and
    their norms within DP_ACC_RTOL; the cosines of both with the
    one-process step ``one`` printed beside."""
    import torch
    cos = lambda a, b: float(torch.nn.functional.cosine_similarity(
        a.double(), b.double(), dim=0))
    a, b, w = dp['grads'], acc['grads'], one['grads']
    rel = max(abs(dp['losses'][0][k] - acc['losses'][k])
              / max(abs(acc['losses'][k]), 1e-12) for k in acc['losses'])
    norms = float(a.double().norm()) / float(b.double().norm())
    print(f'{name} vs the halves accumulated in one process: max loss rel '
          f'{rel:.3e}, gradient cosine {cos(a, b):.8f}, norm ratio '
          f'{norms:.8f}, bitwise {torch.equal(a, b)}; cosine with the '
          f'one-process step: ranks {cos(a, w):.8f}, accumulated '
          f'{cos(b, w):.8f}')
    if not (rel <= DP_ACC_RTOL and cos(a, b) >= DP_ACC_COS
            and abs(norms - 1) <= DP_ACC_RTOL):
        raise SystemExit(f'{name} disagrees with the accumulated halves')


def phase_dp(device, smi):
    """Data-parallel training and sharded sampling (see the module
    docstring, phase 18). Returns each kernel's launches in the phase, a
    list by rank (K2/K3 of part a, K1 of part d)."""
    from ab_opt_tpu_torch.parallel import launch, rehearse
    t0 = time.perf_counter()
    train_job, sample_job = _dp_jobs()
    t1 = time.perf_counter()
    ranks = launch.spawn(rehearse.run_jobs, 2, 'gloo', device.type,
                         args=([('train', train_job),
                                ('sample', sample_job)],), threads=2,
                         wall_s=DP_WALL_S)
    print(f'dp: parts a and d in one spawn of 2 gloo ranks on {device}: '
          f'{time.perf_counter() - t1:.3f} s from spawn to exit')
    k2, k3 = _dp_steps(device, smi, [r['train'] for r in ranks], train_job)
    k1 = _dp_sampling(device, smi, [r['sample'] for r in ranks], sample_job)
    _dp_cli(device, smi)
    print(f'phase 18: {time.perf_counter() - t0:.2f} s')
    return {'K1': k1, 'K2': k2, 'K3': k3}


def _dp_jobs():
    """Part a's training job (DiffAb at full width, bf16, DP_STEPS steps on
    one global batch with the global batch's draws) and part d's sampling
    job (a fan-out of 2 x DP_FANOUT of one complex), for
    ``parallel/rehearse.py``."""
    import numpy as np
    import torch
    from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig
    from ab_opt_tpu_torch.train import DIFFAB_TRAIN_CONFIG
    cfg = DiffAbConfig(dtype='bfloat16')
    torch.manual_seed(2)
    model = DiffAb(cfg)
    gdraws = torch.Generator().manual_seed(7)
    draws = []
    for _ in range(DP_STEPS):
        t, d = model.loss_draws(TRAIN_BATCH, L, gdraws)
        draws.append((t.numpy(), {k: v.numpy() for k, v in d.items()}))
    train_job = dict(
        model=('diffab', dataclasses.asdict(cfg), model.state_dict()),
        train_cfg=DIFFAB_TRAIN_CONFIG,
        batches=[_dp_batch(TRAIN_BATCH, L, seed=1)] * DP_STEPS, draws=draws,
        grads=True)
    torch.manual_seed(0)
    sampler = DiffAb(cfg)
    one_row = _dp_batch(1, L, seed=0)
    sample_job = dict(
        model=('diffab', dataclasses.asdict(cfg), sampler.state_dict()),
        batch={k: np.repeat(v, 2 * DP_FANOUT, 0) for k, v in one_row.items()},
        seed=DP_SEED, fanout=True)
    return train_job, sample_job


def _dp_steps(device, smi, dp, job):
    """Phase 18 a (the ranks' results ``dp``) and b; returns the K2 and K3
    launches of part a by rank."""
    import torch
    from ab_opt_tpu_torch.parallel import launch, rehearse
    torch.set_grad_enabled(True)
    layers = job['model'][1]['num_layers']
    counts = job['batches'][0]['generate_flag'].sum(1)
    half = TRAIN_BATCH // 2
    one = rehearse.run_jobs([('train', job)])['train']
    print(f'dp step: 2 gloo ranks, global batch {TRAIN_BATCH} at L={L}, bf16, '
          f'{layers} layers; generated residues {counts[:half].sum()} / '
          f'{counts[half:].sum()} by rank')
    _dp_gate('dp step, 2 ranks vs one process', dp[0]['losses'],
             one['losses'], (dp[0]['grads'], one['grads']))
    # The step's own reference: the two halves' gradients accumulated in
    # one process, each rounded to bf16 before the sum as a rank's is.
    acc = rehearse.accumulate(job['model'], job['train_cfg'],
                              job['batches'][0], job['draws'][0])
    _dp_accumulated('dp step', dp[0], one, acc)
    per_step = {(r, (c['K2'], c['K3'], c['plain']))
                for r, d in enumerate(dp) for c in d['launches']}
    print(f'dp step: (rank, (K2, K3, plain) a step) {sorted(per_step)}; '
          f'ranks agree on the losses {dp[0]["losses"] == dp[1]["losses"]}; '
          'assert_replicated_params_equal passed in both ranks')
    for r, d in enumerate(dp):
        print(f'dp step: rank {r} s/step '
              + ', '.join(f'{s:.4f}' for s in d['seconds'])
              + '; one process s/step '
              + ', '.join(f'{s:.4f}' for s in one['seconds']) + f' ({smi})')
    if per_step != {(r, (layers, layers, 0)) for r in range(2)} \
            or dp[0]['losses'] != dp[1]['losses']:
        raise SystemExit('dp step: launches or rank agreement failed')

    # b. One NCCL rank: the same step through init_process_group('nccl')
    # and sharded_train_step, against the one-process step.
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    t1 = time.perf_counter()
    nccl = launch.spawn(rehearse.run_jobs, 1, backend, device.type, args=(
        [('train', dict(job, via='step', time_all_reduce=DP_ALL_REDUCES))],),
        threads=2, wall_s=DP_WALL_S)[0]['train']
    ar = sorted(nccl['all_reduce_ms'])
    print(f'dp {backend}: world size 1 ({time.perf_counter() - t1:.3f} s '
          f'from spawn to exit); all-reduce of the '
          f'{nccl["all_reduce_floats"]} float32 gradients: median '
          f'{ar[len(ar) // 2]:.4f} ms, min {ar[0]:.4f} ms over {len(ar)} '
          f'({smi})')
    _dp_gate(f'dp {backend} vs one process', nccl['losses'], one['losses'],
             (nccl['grads'], one['grads']))
    return ([sum(c['K2'] for c in d['launches']) for d in dp],
            [sum(c['K3'] for c in d['launches']) for d in dp])


def _dp_sampling(device, smi, ranks, job):
    """Phase 18 d: the ranks' rows of the fan-out against one process;
    returns K1's launches by rank."""
    import torch
    from ab_opt_tpu_torch.data.collate import to_device_batch
    from ab_opt_tpu_torch.parallel.rehearse import build_model
    torch.set_grad_enabled(False)
    out = ranks[0]['out']
    m = build_model(job['model'], device)
    single = to_device_batch({k: v[:1] for k, v in job['batch'].items()},
                             device)
    worst, bitwise = 0.0, True
    for r in range(2):
        gen = torch.Generator(device=device).manual_seed(DP_SEED + r)
        t1 = time.perf_counter()
        want = m.sample(single, generator=gen, num_replicas=DP_FANOUT)
        if device.type == 'cuda':
            torch.cuda.synchronize()
        one_s = time.perf_counter() - t1
        rows = slice(r * DP_FANOUT, (r + 1) * DP_FANOUT)
        for k in ('v', 'p'):
            a, b = out[k][rows].float(), want[k].float().cpu()
            bitwise &= torch.equal(a, b)
            worst = max(worst, float((a - b).abs().max()))
        bitwise &= torch.equal(out['s'][rows], want['s'].cpu())
        print(f'dp sampling: rank {r}: {DP_FANOUT} rows in '
              f'{ranks[r]["seconds"]:.3f} s, K1 launches '
              f'{ranks[r]["launches"]["K1"]}, plain calls '
              f'{ranks[r]["launches"]["plain"]}; one process {one_s:.3f} s '
              f'for the same rows ({smi})')
    gen_mask = torch.as_tensor(job['batch']['generate_flag'][0])
    differ = not torch.allclose(out['p'][0][gen_mask],
                                out['p'][DP_FANOUT][gen_mask])
    k1 = [r['launches']['K1'] for r in ranks]
    cfg = m.cfg
    print(f'dp sampling: fan-out {2 * DP_FANOUT} over 2 ranks, L={L}, '
          f'{cfg.num_steps} steps: rows equal to one process bitwise '
          f'{bitwise}, max |d| {worst:.3e}; rows differ across ranks {differ}')
    if not (worst <= TOL and differ
            and k1 == [cfg.num_steps * cfg.num_layers] * 2
            and all(r['launches']['plain'] == 0 for r in ranks)
            and out['p'].shape[0] == 2 * DP_FANOUT
            and torch.isfinite(out['p']).all()):
        raise SystemExit('sharded sampling failed its checks')
    return k1


def _dp_cli(device, smi):
    """Phase 18 c: the CLI's main at 2 ranks against 1, float32 (the
    CUDA-core K2/K3 route), each run's returned losses; then its checkpoint
    resumed in this process."""
    import tempfile

    import torch
    import yaml
    from ab_opt_tpu_torch.runners import train_cli
    from ab_opt_tpu_torch.utils.bench_fixture import write_mini_sabdab
    torch.set_grad_enabled(True)
    repo = Path(__file__).resolve().parent
    restore_log = _root_log_restorer()
    try:
        with tempfile.TemporaryDirectory(prefix='chip_smoke_dp_') as tmp:
            tmp = Path(tmp)
            paths = write_mini_sabdab(str(tmp), n=DP_CLI_COMPLEXES)
            ycfg = yaml.safe_load((repo / 'configs' / 'train' /
                                   'codesign_single.yml').read_text())
            for split in ('train', 'val'):
                ycfg['dataset'][split].update(paths)
            ycfg['train'].update(max_iters=DP_CLI_ITERS,
                                 val_freq=DP_CLI_ITERS,
                                 sampling_eval={'enabled': False})
            yml = tmp / 'codesign_single.yml'
            yml.write_text(yaml.safe_dump(ycfg))
            common = ['--config', str(yml), '--seed', '7',
                      '--device', device.type]
            t1 = time.perf_counter()
            one = train_cli.main(common + ['--logdir', str(tmp / 'one')])
            one_wall = time.perf_counter() - t1
            t1 = time.perf_counter()
            dp = train_cli.main(common + ['--logdir', str(tmp / 'dp'),
                                          '--num_devices', '2',
                                          '--dist_backend', 'gloo'])
            dp_wall = time.perf_counter() - t1
            pairs = [(g, w) for k, ws in one.losses.items()
                     for g, w in zip(dp.losses.get(k, []), ws)]
            pairs += [(dp.val_losses.get(it, math.nan), w)
                      for it, w in one.val_losses.items()]
            rel = max(abs(g - w) / max(abs(w), 1e-12) for g, w in pairs)
            steps = {k: len(v) for k, v in dp.losses.items()}
            text = (Path(dp.log_dir) / 'train.log').read_text()
            ckpts = sorted(p.name for p in
                           (Path(dp.log_dir) / 'checkpoints').iterdir())
            print(f'dp CLI: --num_devices 2 --dist_backend gloo '
                  f'({dp_wall:.3f} s, spawn included) vs 1 '
                  f'({one_wall:.3f} s), float32 codesign_single.yml, '
                  f'{DP_CLI_ITERS} steps and one val pass: ranks '
                  f'{dp.ranks}, steps by loss {steps}, val iterations '
                  f'{sorted(dp.val_losses)}, max loss rel {rel:.3e}; '
                  f'checkpoints {ckpts} ({smi})')
            if not (dp.ranks == 2 and dp.iteration == DP_CLI_ITERS
                    and sorted(dp.losses) == sorted(one.losses)
                    and set(steps.values()) == {DP_CLI_ITERS}
                    and sorted(dp.val_losses) == sorted(one.val_losses)
                    == [DP_CLI_ITERS]
                    and rel <= DP_CLI_RTOL
                    and 'data-parallel: 2 ranks, gloo backend' in text
                    and text.count(f'trainer: val it {DP_CLI_ITERS} | ') == 1
                    and ckpts == [f'{DP_CLI_ITERS}.ckpt']):
                raise SystemExit('dp CLI failed its checks')
            resumed = train_cli.main(common + [
                '--resume', str(Path(dp.log_dir) / 'checkpoints' /
                                f'{DP_CLI_ITERS}.ckpt'),
                '--max_iters', str(DP_CLI_ITERS + 1)])
            last = {k: v for k, v in resumed.losses.items()}
            print(f'dp CLI: its checkpoint resumed in one process: iteration '
                  f'{resumed.iteration}, losses {last}')
            if not (resumed.iteration == DP_CLI_ITERS + 1
                    and all(len(v) == 1 and math.isfinite(v[0])
                            for v in last.values())):
                raise SystemExit('dp CLI checkpoint does not resume')
    finally:
        restore_log()


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is false')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f'torch {torch.__version__}, cuda {torch.version.cuda}, '
          f'python {sys.version.split()[0]}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda:0')

    from ab_opt_tpu_torch.ops import build
    t0 = time.perf_counter()
    for src, res in build.build_all().items():
        print(f'build: {Path(src).name} {res["seconds"]:.2f} s -> {res["path"]}')
        for line in res['log'].splitlines():
            spills = 'spill' in line and ' 0 bytes spill stores' not in line
            if 'registers' in line or 'Compiling' in line or spills:
                print(f'  {line.strip()}')
    print(f'build: {time.perf_counter() - t0:.2f} s for all sources')

    max_err, times, bounds, k1_rows = phase_kernel(device)
    attn = phase_attention(device)
    launches, model, batch, k1_rates = phase_slice(device)
    k2, k3 = phase_train(device)
    p2n = phase_p2n(device)
    k4 = phase_paths(model, batch, p2n['ms'])
    chain = phase_chain_kernel(device)
    k5 = phase_chain(model, batch, k1_rates)
    variants = phase_variants(device)
    fused = phase_fused_variants(device, k1_rows)
    phase_design(device, smi.stdout.strip())
    cli = phase_train_cli(device, smi.stdout.strip())
    testset_k1 = phase_testset(device, smi.stdout.strip())
    optimize_k1 = phase_optimize(device, smi.stdout.strip())
    phase_gnn(device, smi.stdout.strip())
    dp = phase_dp(device, smi.stdout.strip())

    kernels = [dict(
        name='gablock', route='cuda', source='ab_opt_tpu_torch/csrc/gablock.cu',
        replaces='ab_opt_tpu/ops/gablock_pallas.py:390', launches=launches,
        max_abs_err=max_err, ms=times[256][0], plain_ms=times[256][1],
        bound_ms=bounds[256][0], bound_by=bounds[256][1], library_ms=None,
        train_cli_launches=cli['K1'], testset_launches=testset_k1,
        optimize_launches=optimize_k1, dp_launches=dp['K1'])]
    for key, name, line, n in (('fwd', 'ipa_attention_fwd', 101, k2),
                               ('bwd', 'ipa_attention_bwd', 183, k3)):
        kernels.append(dict(
            name=name, route='cuda',
            source='ab_opt_tpu_torch/csrc/ipa_attention.cu',
            replaces=f'ab_opt_tpu/ops/ipa_pallas.py:{line}', launches=n,
            **attn[key], library_ms=None,
            train_cli_launches=cli['K2' if key == 'fwd' else 'K3'],
            dp_launches=dp['K2' if key == 'fwd' else 'K3']))
    kernels.append(dict(
        name='ipa_attention_fwd_p2n', route='cuda',
        source='ab_opt_tpu_torch/csrc/ipa_attention.cu',
        replaces='ab_opt_tpu/ops/ipa_pallas.py:142', launches=k4, **p2n,
        library_ms=None, train_cli_launches=cli['K4']))
    kernels.append(dict(
        name='gablock_chain', route='cuda',
        source='ab_opt_tpu_torch/csrc/gablock_chain.cu',
        replaces='ab_opt_tpu/ops/gablock_pallas.py:409', launches=k5,
        **chain, library_ms=None))
    for name, line in (('v1', 45), ('v3', 45), ('v2', 98), ('v4', 137)):
        kernels.append(dict(
            name=f'attention_{name}', route='cuda',
            source='ab_opt_tpu_torch/csrc/attention_variants.cu',
            replaces=f'scripts/micro_kernel_variants.py:{line}',
            **variants[name]))
    for key, line in (('v3', 48), ('abl', 264)):
        kernels.append(dict(
            name=f'gablock_{key}', route='cuda',
            source='ab_opt_tpu_torch/csrc/gablock.cu',
            replaces=f'scripts/micro_fused_variants.py:{line}', **fused[key]))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
