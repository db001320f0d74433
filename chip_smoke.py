#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):

  1. device   — require CUDA; print the card's name and
                ``nvidia-smi --query-gpu=name,power.limit``.
  2. build    — compile every kernel from ``src/repro_torch/kernels/csrc``
                with nvcc (all sources at once), print the build seconds
                and each kernel's ptxas registers, spills and static shared
                memory (marked cached when no build ran), and fail unless
                the SASS of the stepped SYRK and of the fused kernels
                (``cuobjdump -sass``) holds DMMA, the FP64 tensor-core
                instruction, and every f32 instance (the stepped TRSM's,
                the stepped SYRK's and the fused kernels', dense and
                packed, every chunk depth) holds TF32 HMMA, the 3xTF32
                product of the TRSM core and the SYRK tile; print the f32
                fused instances' registers and resident blocks a SM (the
                persistent grid their launcher takes) at bs = 128 and 16.
  3. kernels  — on a real full-size feti-heat-2d factor (S=64, n=4225 ->
                n_pad=4352, m=258 -> m_pad=384, bs=bm=128, f64) and its
                packed form in the fill-mask layout, each of the five
                kernels against its plain torch version (max relative
                difference <= 1e-11), against its unfused or dense twin
                (the packed TRSM against the dense one; a fused kernel
                against TRSM then SYRK; <= 1e-11) and against the library
                calls of kernels/ref.py (one full triangular solve on the
                dense factor, one batched product; <= 1e-9). Each is
                timed with CUDA events (median) beside its plain version,
                its library call(s) and the card's bound, with its useful
                TFLOP/s and share of the bound; each fused kernel also
                beside its unfused pair run back to back (B1 then B2, B3
                then B2) and with the count of SYRK items its list holds
                (groups of 64 / bm stripes when bm < 64). Then the f32
                kernels (all five at f32) on the
                same operands rounded to f32 (diagonal blocks inverted at
                f32), each against its f32 plain version and against the
                f64 kernel on the same f32 operands (<= 1e-4 relative;
                <= 1e-6 for the TRSM kernels B1 and B3, F32_TRSM_TWIN_TOL,
                and the stepped SYRK B2 within F32_SYRK_TWIN_TOL, at every
                f32 phase) and the f32 library call (<= 1e-3),
                timed beside their bound at
                4-byte words and the least time of their operations over
                FFMA (67 TFLOP/s) and 3xTF32 (three TF32 products each at
                494.7 TFLOP/s; both printed, the share uses the least, the
                3xTF32 one) (the f32 fused kernels also beside their unfused
                f32 pair). TF32 is off for every torch product (printed):
                the kernels' 3xTF32 keeps f32 accuracy, a torch TF32 matmul
                would not.
     large blocks — the same factor and right-hand side at bs = bm = 256
                (WIDE_BS, the largest block the reference's planner offers;
                n_pad = 4352 = 17 x 256, m_pad = 512; the stepped metadata
                rebuilt at that size, the factor packed in its nonzero
                256 x 256 blocks): the four TRSM kernels (B1, B3, B4, B5),
                whose core takes such a block in two 128-row passes, and
                the stepped SYRK (B2), at f64 and at f32, against their
                plain versions (1e-11, 1e-4), their twins (B1 and B3 f32
                within F32_TRSM_TWIN_TOL of the f64 kernel, B2 f32 within
                F32_SYRK_TWIN_TOL) and the library calls, with times.
     small blocks — the same at bs = bm = 16 (SMALL_BS, the factor packed
                in its nonzero 16 x 16 blocks): all five kernels at f64 and
                at f32. One checker serves all four phases.
  4. dirichlet — the same five checks and timings on the Dirichlet stage's
                operands of the full-size feti-heat-3d configuration (S=64
                subdomains of 16^3 elements: the interior factor, n_i=3375
                -> 3456, dense and packed in the interior fill-mask layout;
                the right-hand side K_ib, n_b=1538 -> 1664 columns in
                stepped order, padded columns exact zeros), and S_b =
                K_bb - K_bi K_ii^-1 K_ib from the stage's assembler through
                the kernels (unfused and fused) against the plain variants
                (<= 1e-11); then the five kernels at f32 on these operands,
                as in the kernels phase.
  5. main     — ``repro_torch.launch.solve_feti.main``, each run with
                ``--validate``: feti-heat-2d at full size four times
                (``--kernels``, ``--storage packed --kernels``, ``--fused``,
                ``--storage packed --fused``), then six Dirichlet and
                elasticity runs: feti-elasticity-2d ``--kernels --precond
                dirichlet`` and ``--storage packed --fused --precond
                dirichlet``, feti-elasticity-3d ``--storage packed --kernels
                --precond dirichlet``, ``--fused --precond dirichlet`` and
                ``--kernels`` (lumped), and feti-heat-3d ``--kernels
                --precond dirichlet`` at a cut depth (HEAT3D_SUB_GRID,
                registered as the architecture HEAT3D_CUT: the scipy oracle
                of --validate decides the depth; run last, its oracle
                solved on the host in a process of its own from the
                script's start, the same solve). Each must exit 0
                (converged, within 1e-6 of the global sparse solve) and
                launch exactly the kernels its path runs, as often as it
                runs them: once per kernel and stage, so twice on a
                Dirichlet path. Every launch is held, right after it
                returns, against the kernel's plain version on the very
                operands the path handed it (<= 1e-11; an F kernel's upper
                tiles exact zeros), so each kernel is checked at every
                shape its paths give it; the checks' seconds are reported
                apart and taken out of the preprocess time, and the path's
                peak device memory excludes them. Per configuration and
                preconditioner, every
                path takes a PCPG iteration count within one of the first;
                the packed heat-2d ``--kernels`` run's peak device memory
                must be at most half of the dense run's; Dirichlet must take
                fewer iterations than lumped on feti-elasticity-3d. Then the
                smoke configurations (bs = bm = 8) of feti-heat-2d,
                feti-elasticity-2d and feti-elasticity-3d ``--kernels``, and
                the mixed-precision paths: feti-heat-2d ``--kernels --dtype
                f32`` and ``--fused --dtype f32``, dense and packed
                (defect-correction outers), and ``--mode implicit --dtype
                f32`` (refined implicit, no assembly kernel), each within
                1e-8 of the oracle; feti-elasticity-3d ``--kernels`` and
                ``--fused --precond dirichlet --dtype f32`` within 1e-6
                (printed); feti-heat-2d ``--smoke --kernels`` and
                ``--fused --dtype bf16 --tol 1e-6`` within 1e-2 (their
                outers stop short of the launcher's own bar, so their exit
                code is not held). Each launches exactly the f32 kernels its
                flags name, every launch held against its f32 plain version
                (1e-4), its PCPG iterations summed over the outers are held
                to a bar (ITER_BAR), the f32 factor and F stacks must take
                exactly half of the f64 runs' bytes, and the f32 dense
                ``--kernels`` peak must stay within 10% of F32_PEAK's. Last,
                the multi-RHS paths (``--n-rhs 8``, a load sweep through
                ``FetiSolver.solve_many``): feti-heat-2d ``--kernels`` at
                f64, every column within 1e-6 of its oracle, and
                ``--storage packed --fused --dtype f32`` (block
                defect-correction outers), every column within 1e-8 (each
                column's error over its own oracle's largest entry); their
                per-column iterations held to ITER_BAR. Each
                configuration's scipy oracle is solved once and reused
                across its paths (a sweep's columns are multiples of it).

  6. telemetry — feti-heat-2d at full width (dense, lumped, bs 128, f64)
                twice through the launcher with ``--validate``: explicit
                ``--kernels --trace build/chip_smoke/heat2d_trace.json
                --report``, then ``--mode implicit``. Fails unless
                ``repro_torch.obs.validate`` accepts the trace, each run's
                span tree is the reference's (TELEMETRY_SPANS) with every
                child within its parent, the ``pcpg`` span's
                ``iterations`` are the solution's, the report's device-byte
                total is the launcher's printout, the explicit run
                launches B1 and B2 once each and the implicit one nothing,
                and the explicit solver's ``amortization_report`` (the
                implicit run's ``pcpg`` span over its iterations passed as
                its per-iteration time) gives a finite, positive
                ``amortization_iterations``. Prints both span trees'
                durations, the break-even count, ``assembly_s`` (the
                ``stage:dual`` span: the factorization plus the dual
                assembly) and both per-iteration times.
  7. autotune — in a fresh ``REPRO_TORCH_PLAN_CACHE_DIR``: the launch
                overhead through a kernel wrapper (the median
                host-to-completion time of a small launch: the H100
                device model's ``overhead_s``), then three main paths
                with ``--autotune`` (``schur="auto"``, ``measure="auto"``),
                each launching exactly the kernels its joint plan names
                (every such launch held against its plain version), the
                planner's own timing launches counted apart and left
                unchecked: full-size feti-heat-2d (at least one kernel
                launch from planning; 154 iterations ± 1 of the
                hand-picked paths; within 1e-8 of scipy; the launcher
                holds F̃ within 1e-8 of the dense baseline), the same again
                (its plan must come from the cache: one
                ``plan_cache.graph.hit``, no planning launch) and
                feti-elasticity-3d ``--precond dirichlet`` (both stages
                planned jointly; fewer iterations than lumped). Every
                measured plan must be no slower than its measured dense
                baseline, or be it. Last, each plan is timed beside the
                hand-picked bs = 128 ``--kernels`` and ``--fused``
                configurations by the planner's own timer
                (``autotune.measure_configs``): printed, not held.
  8. sharded  — the subdomain-sharded pipeline through the launcher's
                ``--devices N --backend gloo --validate``, the ranks (one
                process each) sharing the one card: full-size feti-heat-2d
                ``--kernels`` on 2 ranks (32 subdomains each) and
                feti-elasticity-3d ``--storage packed --kernels --precond
                dirichlet`` on 3 (slices of 3, 3 and 2 subdomains, both
                stages). Fails unless every rank launches exactly its
                path's kernels once per stage (B1 and B2 on heat-2d; B3 ×2
                and B2 ×2 on elasticity-3d; each rank's own counts, set to
                0 just before its solve), every rank returns the same
                solution, the launcher's single-device run of the same
                solve (here) takes the same iteration count and lies within
                1e-9 of the sharded u, and the ranks' stack bytes sum to
                the single device's. Prints each rank's preprocess and
                solve seconds, peak device bytes and all-reduces (their
                count and host seconds; PCPG's per iteration). Two ranks
                sharing one card measure no scaling.
  9. lm       — the LM serving path (``repro_torch.models``,
                ``repro_torch.train``), after the FETI phases' solvers and
                device caches are freed. LM_RUNS at full width and depth,
                bf16, weights from the model's own seeded initialization:
                granite-3-8b (40 layers, d_model 4096; 512-token prompts),
                recurrentgemma-2b (2304-token prompts: a ring-buffer
                prefill past its 2048-token window and a wrapping decode)
                and rwkv6-1.6b (512), then the MoE models at full width and
                a cut depth (their full configs' weights do not fit one
                card): deepseek-v2-236b (MLA, 160 routed experts top-6
                and 2 shared; 4 of its 60 layers: the dense first layer
                and 3 MoE layers) and grok-1-314b (8 experts top-2; 2 of
                64), 512-token prompts; each LM_BATCH prompts and LM_STEPS
                greedy tokens through ``greedy_generate`` after a short
                warm-up. Each must generate finite logits of the expected
                shape, and one uncached ``forward`` over prompt and
                generated tokens must give logits within the run's bar
                (relative L2 over every decoded position) of the cached
                decode's. A MoE run whose capacity can drop entries (the
                uncached forward over more tokens has more capacity and
                drops others) is held instead by its prefill: the first
                generated token's logits against one uncached forward over
                the prompt alone (the same length, capacity and drop rule;
                for deepseek MLA's absorbed mode against its expanded
                one). Each is repeated at f32 with LM_F32_LAYERS layers
                (the MoE models LM_F32_MOE: fewer layers, batch 2, and a
                copy of the config whose capacity_factor is E / top_k, so
                that nothing drops at any length and the decode is held to
                the full forward) at full width (bar LM_F32_BAR). Then
                deepseek-v2-236b's smoke config with ``moe_impl="sort"`` on
                the card against the port on the CPU (LM_SORT_TOL, greedy
                tokens equal), and every smoke config of
                ``tests/data/torch_lm_golden.npz`` (the reference's CPU
                logits) at f32 on the seeded numpy weights the reference
                ran: forward, prefill and decode logits within
                LM_GOLDEN_TOL, the greedy tokens equal. Prints, beside the
                card's name and power limit, each run's prefill ms, decode
                ms a step and tok/s, peak device bytes and weight bytes
                against ``param_count()`` × 2, and the bounds from
                ``repro_torch.launch.analytic.lm_cell_counts`` on the run's
                own batch, prompt and depth (prefill: its compute term,
                attention included, at 989 TFLOP/s bf16 or 67 f32; a decode
                step: its weight and cache stream at 3.35 TB/s). The path
                runs no hand kernel
                (the reference's LM modules reach no ``pl.pallas_call``):
                the phase fails if one was launched.
 10. train    — the LM training path (``make_train_step``: AdamW, the LM
                loss, gradient accumulation, remat), after the lm phase's
                models are freed. TRAIN_RUNS at full width, bf16, the
                model's own seeded initialization and
                ``synthetic_batch(seed=17)``, the reference's settings for
                each size (f32 moments below 100 B parameters; bf16
                moments and accumulator above): granite-3-8b at 16 of 40
                layers (seq 4096, batch 4, grad_accum 4, 3 steps),
                deepseek-v2-236b at 2 of 60 (MLA, GShard and the router's
                aux loss in backward, the bf16 accumulator, the sliced
                update of 1.26 G-element expert stacks; seq 1024, batch 8,
                grad_accum 8, 3 steps), rwkv6-1.6b and recurrentgemma-2b
                at full depth (seq 4096, past recurrentgemma's window;
                batch 4; 3 steps). Prints each step's loss (and its parts
                where the step returns them: without accumulation), lr
                and gradient norm, ``loss_fn``'s parts at the start
                weights, the step ms (host clock, device synchronized, the
                first step apart), tok/s, peak device bytes beside the
                analytic residency, the step's bound (``lm_cell_counts``'
                executed FLOPs, (3 + 1 with remat) forward passes, at 989
                TFLOP/s bf16; its attention and WKV part at 67 TFLOP/s
                beside it) and the model-FLOPs share (``model_flops``,
                6 · N_active · tokens, over step seconds x 989 TFLOP/s);
                fails on a
                non-finite loss or gradient norm, or a MoE run without an
                aux loss. Then TRAIN_CHECK at f32 (TF32 off): grad_accum 2
                against 1, remat against none, the bf16 first loss
                against the f32 one; and every entry of
                ``tests/data/torch_train_golden.npz`` (the reference's
                three f32 steps of each smoke config) through the port
                within TRAIN_GOLDEN_TOL. Fails if the path launched a hand
                kernel.
 11. placed   — placed LM training over ``torch.distributed``: two gloo
                ranks share the card (``spawn_ranks``, one group for every
                run), each running
                ``distributed.sharding.placed_train_step`` on each entry
                of PLACED_RUNS: granite-3-8b at full width and 2 of 40
                layers, f32 (TF32 off), remat, lr TRAIN_CHECK_LR, three
                steps on the rank's rows of a global batch of 4 x 512, on
                a (data=2, model=1) ``DeviceMesh`` (FSDP: each layer's
                weights gathered before its forward and again in its
                recomputation, the gradients summed over the ranks and cut
                to the shards) and on a (data=1, model=2) one (tensor
                and sequence parallelism: each rank computes its half of
                the heads and of the FFN and holds half the positions
                between blocks, each part's input all-gathered along the
                sequence and its sum reduce-scattered back; granite's
                vocab, which does not divide, looked up and projected
                whole by every rank on every position), and on (1, 2) again
                at 4 x 511, which does not divide 'model': the path
                without sequence parallelism (all-reduces).
                Each rank first runs one process's three steps on the
                whole batches from the same weights and holds its losses,
                gradient norms and final parameter shards (PLACED_TOL) and
                every step's shard gradients (PLACED_GRAD_TOL, relative
                L2) to their slices of that run. Prints each rank's step
                ms, peak device bytes and the c10d collectives it recorded
                each step (``record_collectives``) beside
                ``analytic.lm_collectives`` for the cell, its reduce-scatters
                and peak beside PLACED_BEFORE_SP's; fails unless they are
                equal, bytes and counts by operation, and if a (1, 2) run
                gathers anything but the residual stream along the
                sequence (rows, S, d), the weights the plan computes whole
                (recurrentgemma's replicated ``wk`` and ``wv``) and each
                split RG-LRU's conv output: no logits (the split vocab's
                loss is vocab-parallel). Two more (1, 2) runs:
                recurrentgemma-2b at 3 of 26 layers (one ``(rglru, rglru,
                attn)`` period: RG-LRU by width) and rwkv6-1.6b at 2 of 24
                (RWKV-6 by heads). In the same group,
                PLACED_SERVE: placed serving (``placed_serve``: a prefill
                of 4 x 512 tokens and one decode step, bf16, full width)
                on (1, 2) of deepseek-v2-236b at 2 of 60 layers (MLA by
                heads, 80 of 160 experts a rank, the shared expert by
                columns), grok-1-314b at 1 of 64 (4 of 8 experts a
                rank), recurrentgemma-2b at 5 of 26 (RG-LRU 1,280 of
                2,560 channels a rank) and rwkv6-1.6b at 12 of 24 (16 of
                32 heads a rank), each step's logits held to one
                process's on the card (run before the ranks, from the
                same seeded weights)
                within the run's bar, its collectives to
                ``lm_collectives``, its all-gathers to the split head's
                last-position logits, each split RG-LRU's conv output and
                the weights the plan computes whole (MLA's latent
                projections, the router, a replicated KV head's ``wk`` and
                ``wv``), in the sequence-parallel prefill each layer's
                two part inputs and each rank's last position, and in
                decode each slot group's queries: no split head weight,
                expert, RG-LRU channel, RWKV-6 head or cache. The cache
                holds S + 1 slots rounded up to 2 (514): deepseek's MLA
                cache and recurrentgemma's ring (its KV head replicated)
                half the slots a rank, decode merging the two halves'
                partial softmaxes. Each run prints the parameters a rank
                holds and those it computes with, its attention cache's
                bytes a rank beside the whole cache's, and its peaks
                beside PLACED_SERVE_BEFORE_SP's. Then PLACED_FORWARD, the
                ``cuda`` case of ``tests/test_torch_lm_distributed.py``:
                the smoke models'
                f32 forwards on (1, 2) within PLACED_FORWARD_TOL of one
                process's, sequence-parallel (each layer's input the
                rank's half of the positions).
 12. dryrun   — ``repro_torch.launch.dryrun --arch all --shape all`` on the
                reference's two meshes (16x16, 2x16x16; host arithmetic)
                into a temporary file: prints the census and holds every
                full-size FETI row to ``tests/data/torch_dryrun_golden.json``
                (the reference's ``feti_cell_counts``, exactly), and every
                row to carry its collective schedule (a finite
                ``collective_s`` at ``HW["net_bw"]``; the totals by mesh
                are printed, and the decode_32k all-gather bytes a rank of
                deepseek-v2-236b, rwkv6-1.6b and recurrentgemma-2b beside
                the schedule's before their parts split, and each LM
                row's train_4k and prefill_32k collective bytes a rank
                beside DRYRUN_BEFORE_SP's). Then
                DRYRUN_RUNS at ``--devices 1 --run`` on the card at full
                width: feti-heat-2d x assembly (S 64, n 4225, bs 128, f32:
                the block Cholesky, then B1 f32 and B2 f32 through
                ``use_kernels=True``, each launched exactly once a step),
                feti-heat-3d x dirichlet (S 64, n_i 3375, n_b 1538, bs 128,
                f32: the interior block Cholesky, the Dirichlet stage's B1
                f32 and B2 f32 once a step each, ``restrict_own_boundary``),
                granite-3-8b x decode_32k (40 layers, the global batch cut
                to the largest whose analytic residency fits
                ``dryrun.FIT_FRACTION`` of the card; decode steps at
                cache_index 32767 on a cache filled from a seeded
                generator) and recurrentgemma-2b x long_500k (batch 1, full
                depth). Prints each row's measured_s, peak device bytes
                beside its analytic residency and ``finalize.fraction``
                (and floor / measured_s), and ``report.dryrun_table`` of
                the four. Fails on a row whose status is not ``ok``, a
                peak at or above the card's 80 GB, a FETI row off the
                golden file, a row without collectives or a launch count
                off.

Then one JSON line with the kernels' numbers, one row per kernel and
dtype (the f32 ones named ``*_f32``; each row: the heat-2d phase's,
``launches`` summed over the main paths (the telemetry, autotune and
sharded ones included; a sharded path's over its ranks) beside
``launches_per_path``, the planner's launches per autotune path under
``planning_launches``, the main paths' checks under ``path_checks`` (the
sharded paths' launches, made in the ranks' processes, are counted and
not checked there), the Dirichlet phase's under ``dirichlet_heat_3d``, the
small-block phase's under ``bs16`` and the large-block phase's under
``bs256``) and, last, the device line.
The port imports no JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCH = "feti-heat-2d"
REL_TOL = 1e-11  # kernel vs plain version or twin, f64: sums in another order
LIB_TOL = 1e-9  # kernel vs the library call: another algorithm (full TRSM)
# f32 kernel (3xTF32 TRSM core and SYRK tile) vs its f32 plain version
# (cuBLAS SGEMM, TF32 off) or the f64 kernel on the same f32 operands: f32
# sums in another order
F32_TOL = 1e-4
F32_LIB_TOL = 1e-3  # f32 kernel vs the f32 library call (a full TRSM)
# the f32 TRSM kernels (B1, B3: the TRSM core alone) vs the f64 kernel on
# the same f32 operands, tighter than F32_TOL: on the NVIDIA H100 the 3xTF32
# core, each k8 step summed with round-to-nearest adds, reads <= 3.7e-7 at
# every f32 phase, and the same products summed by the tensor cores'
# truncating accumulation 1.1e-6 to 3.1e-6.
F32_TRSM_TWIN_TOL = 1e-6
F32_TRSM = ("stepped_trsm", "stepped_trsm_packed")
# the f32 stepped SYRK (B2: the SYRK tile alone) vs the f64 kernel on the
# same f32 operands, per kernel phase (heat-2d, bs = 16, the Dirichlet
# stage; bs = 256), tighter than F32_TOL: on the NVIDIA H100 (700 W) the
# 3xTF32 tile, each k8 step summed with round-to-nearest adds, reads
# 1.813e-7 / 2.142e-7 / 5.351e-7 here (1.871e-7 at bs = 256); the same
# products summed by the tensor cores' truncating accumulation 2.37e-6 /
# 2.35e-6 / 7.90e-6 (the chain_acc
# variant of tests/torch_trsm_variants.py, on the plain TRSM's Y), and the
# FFMA tile before it (equal to the f32 plain version) 5.364e-7 / 4.447e-7
# / 1.741e-6. The fused kernels carry both halves' distances and stay at
# F32_TOL.
F32_SYRK_TWIN_TOL = {"heat-2d dual": 4e-7, "heat-2d dual bs=16": 4e-7,
                     "heat-2d dual bs=256": 4e-7, "heat-3d dirichlet": 1.2e-6}
# The card's peaks are repro_torch.launch.roofline.HW's (NVIDIA H100 SXM
# data sheet, dense, at the 700 W power limit): FP64 through the tensor
# cores (DMMA; plain FP64 FMA peaks at half of it); FP32 outside the tensor
# cores (FFMA) at the same 67 TFLOP/s; TF32 on the tensor cores at 494.7
# (the sheet's 989.4 is with 2:4 sparsity), of which an f32-exact 3xTF32
# product (every f32 product of the port's kernels) takes three; bf16 at
# 989; HBM at 3.35 TB/s.
REPS = 5
SMALL_BS = 16  # the small-block phase's bs = bm
WIDE_BS = 256  # the large-block phase's bs = bm: two passes of the core
# the kernels of the large-block phase: every one whose TRSM core takes a
# block in passes, and the stepped SYRK at bm = 256 (one stripe cut into
# four 128 x 128 sub-tiles), which the planner offers too
WIDE_NAMES = ("stepped_trsm", "stepped_syrk", "stepped_trsm_packed",
              "stepped_trsm_syrk", "stepped_trsm_syrk_packed")

# feti-heat-3d's validated depth (full: 4,4,4), registered under its own
# architecture name: the width stays the configuration's
HEAT3D_SUB_GRID = (3, 3, 3)
HEAT3D_CUT = "feti-heat-3d-cut"
N_RHS = 8  # load cases of the multi-RHS main paths

KERNEL_NAMES = ("stepped_trsm", "stepped_syrk", "stepped_trsm_packed",
                "stepped_trsm_syrk", "stepped_trsm_syrk_packed")
# every kernel is built at f32 too
F32_NAMES = KERNEL_NAMES


def kernel_key(name, dtype):
    """A kernel's name in the launch counts and the JSON rows: the f64
    kernel under its own name, the f32 one with ``_f32``."""
    return name if dtype == "f64" else f"{name}_{dtype}"


KERNEL_KEYS = KERNEL_NAMES + tuple(kernel_key(n, "f32") for n in F32_NAMES)

# (name, arch, launcher flags, the launches its path must make: every
# kernel not named must not launch)
MAIN_RUNS = (
    ("heat-2d dense --kernels", ARCH, ["--kernels"],
     dict(stepped_trsm=1, stepped_syrk=1)),
    ("heat-2d packed --kernels", ARCH, ["--storage", "packed", "--kernels"],
     dict(stepped_trsm_packed=1, stepped_syrk=1)),
    ("heat-2d dense --fused", ARCH, ["--fused"], dict(stepped_trsm_syrk=1)),
    ("heat-2d packed --fused", ARCH, ["--storage", "packed", "--fused"],
     dict(stepped_trsm_syrk_packed=1)),
    ("elasticity-2d dense --kernels dirichlet", "feti-elasticity-2d",
     ["--kernels", "--precond", "dirichlet"],
     dict(stepped_trsm=2, stepped_syrk=2)),
    ("elasticity-2d packed --fused dirichlet", "feti-elasticity-2d",
     ["--storage", "packed", "--fused", "--precond", "dirichlet"],
     dict(stepped_trsm_syrk_packed=2)),
    ("elasticity-3d packed --kernels dirichlet", "feti-elasticity-3d",
     ["--storage", "packed", "--kernels", "--precond", "dirichlet"],
     dict(stepped_trsm_packed=2, stepped_syrk=2)),
    ("elasticity-3d dense --fused dirichlet", "feti-elasticity-3d",
     ["--fused", "--precond", "dirichlet"], dict(stepped_trsm_syrk=2)),
    ("elasticity-3d dense --kernels lumped", "feti-elasticity-3d",
     ["--kernels"], dict(stepped_trsm=1, stepped_syrk=1)),
    # the smoke configurations' bs = bm = 8 through the f64 kernels
    ("heat-2d smoke --kernels", ARCH, ["--smoke", "--kernels"],
     dict(stepped_trsm=1, stepped_syrk=1)),
    ("elasticity-2d smoke --kernels", "feti-elasticity-2d",
     ["--smoke", "--kernels"], dict(stepped_trsm=1, stepped_syrk=1)),
    ("elasticity-3d smoke --kernels", "feti-elasticity-3d",
     ["--smoke", "--kernels"], dict(stepped_trsm=1, stepped_syrk=1)),
    # mixed precision: f32 stacks through the f32 kernels, f64 accuracy by
    # refinement (explicit: defect-correction outers); bf16 storage at bs 8
    ("heat-2d dense --kernels f32", ARCH, ["--kernels", "--dtype", "f32"],
     dict(stepped_trsm_f32=1, stepped_syrk_f32=1)),
    ("heat-2d packed --kernels f32", ARCH,
     ["--storage", "packed", "--kernels", "--dtype", "f32"],
     dict(stepped_trsm_packed_f32=1, stepped_syrk_f32=1)),
    ("heat-2d implicit f32", ARCH, ["--mode", "implicit", "--dtype", "f32"],
     dict()),
    ("elasticity-3d dense --kernels dirichlet f32", "feti-elasticity-3d",
     ["--kernels", "--precond", "dirichlet", "--dtype", "f32"],
     dict(stepped_trsm_f32=2, stepped_syrk_f32=2)),
    ("heat-2d smoke --kernels bf16", ARCH,
     ["--smoke", "--kernels", "--dtype", "bf16", "--tol", "1e-6"],
     dict(stepped_trsm_f32=1, stepped_syrk_f32=1)),
    # the f32 fused kernels on their main paths (bf16 storage runs them
    # from its f32 compute stacks)
    ("heat-2d dense --fused f32", ARCH, ["--fused", "--dtype", "f32"],
     dict(stepped_trsm_syrk_f32=1)),
    ("heat-2d packed --fused f32", ARCH,
     ["--storage", "packed", "--fused", "--dtype", "f32"],
     dict(stepped_trsm_syrk_packed_f32=1)),
    ("elasticity-3d dense --fused dirichlet f32", "feti-elasticity-3d",
     ["--fused", "--precond", "dirichlet", "--dtype", "f32"],
     dict(stepped_trsm_syrk_f32=2)),
    ("heat-2d smoke --fused bf16", ARCH,
     ["--smoke", "--fused", "--dtype", "bf16", "--tol", "1e-6"],
     dict(stepped_trsm_syrk_f32=1)),
    # multi-RHS: a load sweep of 8 cases through solve_many
    ("heat-2d dense --kernels --n-rhs 8", ARCH,
     ["--kernels", "--n-rhs", str(N_RHS)],
     dict(stepped_trsm=1, stepped_syrk=1)),
    ("heat-2d packed --fused --n-rhs 8 f32", ARCH,
     ["--storage", "packed", "--fused", "--n-rhs", str(N_RHS), "--dtype",
      "f32"], dict(stepped_trsm_syrk_packed_f32=1)),
    # last: its scipy oracle (a few minutes of host time) is solved in a
    # process of its own from the script's start (start_oracle)
    ("heat-3d dense --kernels dirichlet", HEAT3D_CUT,
     ["--kernels", "--precond", "dirichlet"],
     dict(stepped_trsm=2, stepped_syrk=2)),
)
# each run's bar on the relative error of u against the scipy oracle (the
# launcher's 1e-6 where not named); the bf16 run is held to its own bar
# only (its outers stop short of the launcher's, as the reference's do)
ERR_BAR = {
    "heat-2d dense --kernels f32": 1e-8,
    "heat-2d packed --kernels f32": 1e-8,
    "heat-2d implicit f32": 1e-8,
    "elasticity-3d dense --kernels dirichlet f32": 1e-6,
    "heat-2d smoke --kernels bf16": 1e-2,
    "heat-2d dense --fused f32": 1e-8,
    "heat-2d packed --fused f32": 1e-8,
    "elasticity-3d dense --fused dirichlet f32": 1e-6,
    "heat-2d smoke --fused bf16": 1e-2,
    "heat-2d packed --fused --n-rhs 8 f32": 1e-8,
}
LOOSE = ("heat-2d smoke --kernels bf16", "heat-2d smoke --fused bf16")
# the autotune phase (schur="auto", measure="auto", a fresh plan cache):
# (name, arch, launcher flags); each path's launches are the ones its plan
# names, counted apart from the planner's timing launches
AUTO_HEAT = "heat-2d --autotune"
AUTO_HEAT_CACHED = "heat-2d --autotune (cached plan)"
AUTO_ELA = "elasticity-3d --autotune dirichlet"
AUTO_RUNS = (
    (AUTO_HEAT, ARCH, ["--autotune"]),
    (AUTO_HEAT_CACHED, ARCH, ["--autotune"]),
    (AUTO_ELA, "feti-elasticity-3d", ["--autotune", "--precond", "dirichlet"]),
)
ERR_BAR.update({AUTO_HEAT: 1e-8, AUTO_HEAT_CACHED: 1e-8})
# the hand-picked configurations the plans are timed beside: the
# architectures' own bs = bm = 128 through the kernels (--kernels; the
# launcher's config, prune as it sets it) and through the fused kernel
# (--fused)
HAND_PICKED = {
    "--kernels bs 128": dict(trsm_variant="factor_split",
                             syrk_variant="input_split", block_size=128,
                             use_kernels=True),
    "--fused bs 128": dict(block_size=128, use_kernels=True, fused=True),
}
LAUNCH_OVERHEAD_REPS = 200  # small launches timed for the launch overhead
# the telemetry phase: feti-heat-2d at full width (dense, lumped, bs 128,
# f64), explicit through the kernels with --trace and --report, then
# implicit on the same problem: (name, launcher flags, launches)
TELEMETRY_RUNS = (
    ("telemetry heat-2d --kernels", ["--kernels"],
     dict(stepped_trsm=1, stepped_syrk=1)),
    ("telemetry heat-2d --mode implicit", ["--mode", "implicit"], dict()),
)
# the reference's span tree of these solves (explicit and implicit alike:
# tests/test_torch_telemetry.py holds the port's equal to it on the CPU)
TELEMETRY_SPANS = [
    ("preprocess", [("init", []), ("prep", [("stage:dual", [])]),
                    ("pack", [])]),
    ("solve", [("rhs_setup", []), ("pcpg", []), ("recover", [])]),
]
# the sharded phase: (name, arch, launcher flags, each rank's launches,
# ranks); --validate is added
SHARDED_RUNS = (
    ("heat-2d --kernels 2 ranks", ARCH,
     ["--kernels", "--devices", "2", "--backend", "gloo"],
     dict(stepped_trsm=1, stepped_syrk=1), 2),
    ("elasticity-3d packed --kernels dirichlet 3 ranks",
     "feti-elasticity-3d",
     ["--storage", "packed", "--kernels", "--precond", "dirichlet",
      "--devices", "3", "--backend", "gloo"],
     dict(stepped_trsm_packed=2, stepped_syrk=2), 3),
)
SHARDED_DU = 1e-9  # max|u_sharded - u_single|: only G t's sums reorder
# the lm phase: (arch, prompt tokens, bar on the relative L2 distance of
# the cached decode's logits from one uncached forward's, bf16). Served at
# full width and depth, LM_BATCH prompts, LM_STEPS greedy steps. The bars
# are twice the distances measured on the card (NVIDIA H100 80GB HBM3,
# 700 W) or 5e-2, whichever is less, but rwkv6-1.6b's: its bf16 stack
# amplifies rounding, 9.554e-2 at full depth, so twice that (the
# reference's own path shows as much: tests/torch_lm_bf16_drift.py gives
# 3.895e-2 for it and 3.893e-2 for the port at 24 layers of width 256 on
# the CPU); the f32 check holds its cache path to 1e-4. Each entry: arch,
# prompt tokens, bar, the changes to its full config (a depth cut). The
# MoE models' bars hold their prefill against the prompt's forward
LM_RUNS = (
    ("granite-3-8b", 512, 3.7e-2, {}),  # measured 1.852e-2
    # 2304 > the 2048-token window: ring-buffer prefill, a wrapping decode
    ("recurrentgemma-2b", 2304, 5e-2, {}),  # measured 2.986e-2
    ("rwkv6-1.6b", 512, 0.19, {}),  # measured 9.554e-2
    # 4 of 60 layers: the dense first layer and 3 MoE layers (13.30 B
    # parameters, 26.6 GB); the full config holds 471 GB of bf16 weights.
    # Measured 3.796e-2 (MLA absorbed against expanded, then routing among
    # 160 experts; tests/torch_lm_bf16_drift.py: the reference 5.312e-2,
    # the port 1.740e-2 at 4 layers of width 256 on the CPU)
    ("deepseek-v2-236b", 512, 5e-2, dict(num_layers=4)),
    # 2 of 64 layers (11.45 B parameters, 22.9 GB; the full config 633 GB)
    ("grok-1-314b", 512, 1.5e-2, dict(num_layers=2)),  # measured 7.591e-3
)
LM_BATCH, LM_STEPS = 8, 32
# each LM_RUNS arch again at f32, full width, LM_F32_LAYERS layers: the
# cached logits within LM_F32_BAR of the uncached forward's (TF32 off).
# The MoE models at f32 hold (layers, batch) of LM_F32_MOE, their
# capacity raised so that nothing drops: deepseek's dense and first MoE
# layer (21.4 GB of f32 weights), grok's first layer (26.1 GB)
LM_F32_LAYERS, LM_F32_BAR = 4, 1e-4
LM_F32_MOE = {"deepseek-v2-236b": (2, 2), "grok-1-314b": (1, 2)}
# deepseek-v2-236b's smoke config with sort dispatch: the card against the
# port on the CPU (max relative), the greedy tokens equal
LM_SORT_ARCH, LM_SORT_TOL = "deepseek-v2-236b", 1e-4
LM_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_lm_golden.npz")
LM_GOLDEN_TOL = 1e-4  # the reference's smoke logits (CPU) against the card
# The train phase: each entry trains through make_train_step at
# full width, bf16, remat on, the reference's settings for its size
# (src/repro/launch/dryrun.py _train_settings: f32 moments below 100 B
# parameters, bf16 moments and accumulator at 100 B or more): arch, layers
# (None: full depth), seq, batch, grad_accum, moment and accumulator
# dtype, steps. granite-3-8b at full depth holds 98 GB of weights,
# gradients and f32 moments: 16 of 40 layers (3.39 B parameters, 40.7 GB,
# plus the 13.6 GB f32 accumulator); deepseek-v2-236b at 2 of 60 layers
# (the dense layer 0 and one MoE layer, 5.36 B parameters, 53.6 GB).
# Microbatches of one row keep the f32 attention chunks that one block's
# recompute saves for backward to ~9 GB at seq 4096 (granite) and
# recurrentgemma's f32 logits (256,000 columns) to 4.2 GB
TRAIN_RUNS = (
    ("granite-3-8b", 16, 4096, 4, 4, "float32", 3),
    ("deepseek-v2-236b", 2, 1024, 8, 8, "bfloat16", 3),
    ("rwkv6-1.6b", None, 4096, 4, 1, "float32", 3),
    # 4096 tokens: past its 2048-token local window
    ("recurrentgemma-2b", None, 4096, 4, 4, "float32", 3),
)
TRAIN_LR = 1e-3  # the training launcher's default
# the internal checks at f32, TF32 off: arch, layers, batch, seq. One step
# with grad_accum 2 against one with grad_accum 1: the gradients' norm and
# the updated parameters (max relative per tensor) within TRAIN_ACCUM_TOL,
# the gradients (caught by grad_transform; relative L2 per tensor) within
# TRAIN_GRADS_TOL, twice the measured 9.340e-6: a key projection's
# gradient passes the softmax's derivative, which cancels at init (near
# uniform attention), so its summation order shows at 1e-5; remat against
# none within TRAIN_REMAT_TOL; the bf16 model of the same weights: its
# first loss within TRAIN_BF16_BAR (relative) of the f32 one.
# TRAIN_CHECK_LR: AdamW's first step moves each element by about
# ±lr whatever its gradient's size, so an element whose gradient is at
# the two runs' rounding level can move 2·lr apart; 1e-7 keeps that below
# 1e-5 of the smallest tensor maximum (granite's mlp wo, ~0.045). At lr
# 1e-5 the parameters measured 2.026e-5 apart (NVIDIA H100 80GB HBM3,
# 700.00 W), the gradients 9.850e-6 (max relative per tensor), their
# norm 7.391e-8; at lr 1e-7 the parameters
# 2.061e-7, the gradients 9.340e-6 (relative L2); remat 0.0; the bf16
# first loss 7.367e-7 from the f32 one: the bar is twice that
TRAIN_CHECK = ("granite-3-8b", 2, 4, 1024)
TRAIN_CHECK_LR = 1e-7
TRAIN_ACCUM_TOL, TRAIN_GRADS_TOL = 1e-5, 2e-5
TRAIN_REMAT_TOL, TRAIN_BF16_BAR = 1e-6, 1.5e-6
# tests/data/torch_train_golden.npz (the reference's three f32 steps of
# every smoke config, CPU) against the card, max relative
TRAIN_GOLDEN_TOL = 1e-4
# the dryrun phase: the cells run on the card at --devices 1 (each FETI
# one's launches a step, exactly); the reference's full-size FETI counts
# are tests/data/torch_dryrun_golden.json (tests/torch_dryrun_golden.py)
DRYRUN_RUNS = (("feti-heat-2d", "assembly"), ("feti-heat-3d", "dirichlet"),
               ("granite-3-8b", "decode_32k"),
               ("recurrentgemma-2b", "long_500k"))
# deepseek-v2-236b's decode_32k all-gather bytes a rank on each mesh with
# its MLA heads and experts gathered whole along 'model' (the schedule
# before they split), printed beside the schedule's figure
DRYRUN_DEEPSEEK_DECODE_WHOLE = {"16x16": 498_566_594_560,
                                "2x16x16": 498_565_775_360}
# the same of rwkv6-1.6b and recurrentgemma-2b with their RWKV-6 and
# RG-LRU blocks gathered whole along 'model'
DRYRUN_RECURRENT_DECODE_WHOLE = {
    "rwkv6-1.6b": {"16x16": 2_815_426_560, "2x16x16": 2_814_902_272},
    "recurrentgemma-2b": {"16x16": 1_776_189_440,
                          "2x16x16": 1_774_141_440}}
# the LM rows' collective bytes a rank (all operations) of train_4k and
# prefill_32k on each mesh in the schedule before sequence parallelism
# and the vocab-parallel loss (the port at 5322958), printed beside the
# schedule's
DRYRUN_BEFORE_SP = {
    "16x16": {
        "deepseek-v2-236b": (962_786_148_140, 112_154_624_000),
        "granite-3-8b": (134_656_745_496, 45_019_586_560),
        "grok-1-314b": (1_314_675_396_712, 145_056_333_824),
        "hubert-xlarge": (48_678_087_708, 16_226_672_640),
        "mistral-large-123b": (1_331_273_334_888, 304_833_757_184),
        "nemotron-4-340b": (2_704_560_914_536, 519_772_807_168),
        "qwen1.5-32b": (189_975_103_512, 61_444_540_416),
        "qwen2-vl-2b": (38_395_283_480, 6_340_421_120),
        "recurrentgemma-2b": (98_102_871_060, 21_732_761_600),
        "rwkv6-1.6b": (61_238_616_084, 19_793_182_720),
    },
    "2x16x16": {
        "deepseek-v2-236b": (1_082_191_871_564, 71_553_556_480),
        "granite-3-8b": (71_631_724_580, 23_544_750_080),
        "grok-1-314b": (1_467_243_372_744, 93_113_810_944),
        "hubert-xlarge": (24_640_092_200, 8_173_608_960),
        "mistral-large-123b": (1_024_956_170_440, 162_294_464_512),
        "nemotron-4-340b": (2_330_662_076_616, 286_636_101_632),
        "qwen1.5-32b": (119_314_714_660, 39_633_855_488),
        "qwen2-vl-2b": (19_974_090_788, 3_420_881_664),
        "recurrentgemma-2b": (50_147_072_032, 11_162_603_520),
        "rwkv6-1.6b": (31_109_922_848, 9_995_157_504),
    },
}
DRYRUN_LAUNCHES = {arch: {"stepped_trsm": {"f32": 1},
                          "stepped_syrk": {"f32": 1}}
                   for arch in ("feti-heat-2d", "feti-heat-3d")}
# the placed phase's runs: arch, layers, mesh (data, model), global batch,
# seq, steps; f32, remat, lr TRAIN_CHECK_LR. (2, 1): FSDP and data
# parallelism; (1, 2): tensor parallelism over 'model' (granite's
# attention and MLPs split, its vocab of 49,155 stays whole, so nothing is
# gathered); recurrentgemma-2b at one (rglru, rglru, attn) period (RG-LRU
# by width; its one KV head replicated) and rwkv6-1.6b at 2 layers (RWKV-6
# by heads). The bars are the accumulation check's (a placed step sums
# its gradients over the ranks in another order): losses, gradient norms
# and parameters within PLACED_TOL (relative), the shard gradients within
# PLACED_GRAD_TOL (relative L2). The final parameters of recurrentgemma
# and rwkv6 are held to PLACED_PARAM_TOL instead: their zero-initialized
# tensors (RG-LRU's conv_b, RWKV-6's u, the layernorm biases) hold at most
# ~3 lr after three steps, so an element whose gradient sits at f32's
# rounding level moves a visible fraction of that maximum, as
# TRAIN_CHECK_LR's note says. On the card (NVIDIA H100 80GB HBM3, 700.00
# W; tests/torch_placed_drift.py --layers 3 / 2 --seq 512 --device cuda
# --train --remat) the split's parameters lie 3.427e-3 (recurrentgemma,
# conv_b) and 3.062e-3 (rwkv6, u) from one process's, while one process's
# own f32 parameters lie 5.779e-3 and 3.628e-3 from the same weights at
# f64 and the split's 6.359e-3 and 3.710e-3: twice the distance measured
PLACED_RUNS = (("granite-3-8b", 2, (2, 1), 4, 512, 3),
               ("granite-3-8b", 2, (1, 2), 4, 512, 3),
               ("granite-3-8b", 2, (1, 2), 4, 511, 3),  # no SP at 511
               ("recurrentgemma-2b", 3, (1, 2), 4, 512, 3),
               ("rwkv6-1.6b", 2, (1, 2), 4, 512, 3))
PLACED_TOL, PLACED_GRAD_TOL = TRAIN_ACCUM_TOL, TRAIN_GRADS_TOL
# the 4 x 512 PLACED_RUNS entries' collective bytes a rank a step and peak
# device bytes a rank before sequence parallelism and the vocab-parallel
# loss: the port at 5322958, its schedule, and its placed phase on NVIDIA
# H100 80GB HBM3, 700.00 W with the earlier runs' garbage collected before
# each run (PERF.md §5), printed beside this run's
PLACED_BEFORE_SP = {("granite-3-8b", (2, 1)): (6_392_299_536, 7_399_307_264),
                    ("granite-3-8b", (1, 2)): (402_653_188, 8_355_587_072),
                    ("recurrentgemma-2b", (1, 2)): (2_658_263_044,
                                                    16_156_037_120),
                    ("rwkv6-1.6b", (1, 2)): (840_024_068, 5_120_829_440)}
PLACED_PARAM_TOL = {"recurrentgemma-2b": 6.9e-3, "rwkv6-1.6b": 6.2e-3}
# placed serving in the same group of ranks, on (data=1, model=2), at full
# width and bf16, the model's own seeded initialization: arch, layers,
# global batch, prompt, the bar on the prefill's and the decode step's
# logits against one process's (max relative). deepseek-v2-236b at 2 of 60
# layers (the dense layer 0, then MLA by heads and 80 of 160 experts a
# rank; 5.36 B parameters), grok-1-314b at 1 of 64 (its heads, and 4 of 8
# experts a rank; 6.53 B). The bars are twice the distances measured on
# the card (NVIDIA H100 80GB HBM3, 700 W; the larger of prefill and
# decode), at most the lm phase's bf16 bar of 5e-2
PLACED_SERVE = (("deepseek-v2-236b", 2, 4, 512, 2.1e-2),  # 1.008e-2
                ("grok-1-314b", 1, 4, 512, 1.9e-2),  # measured 9.259e-3
                # RG-LRU by width, RWKV-6 by heads, at the depth whose
                # distance doubled stays within the lm phase's bars (5e-2,
                # 0.19): at full depth they measured 4.497e-2 / 5.016e-2
                # (prefill / decode, 26 layers) and 1.557e-1 / 1.420e-1
                # (24), and at 3 and 6 layers recurrentgemma's decode step
                # took another greedy token than one process's
                ("recurrentgemma-2b", 5, 4, 512, 3.9e-2),  # 1.923e-2
                ("rwkv6-1.6b", 12, 4, 512, 0.13))  # measured 6.332e-2
# PLACED_SERVE's peak device bytes a rank (prefill, decode) before
# sequence parallelism (the port at 5322958 on the same card, garbage
# collected before each run, as PLACED_BEFORE_SP), printed beside this
# run's
PLACED_SERVE_BEFORE_SP = {"deepseek-v2-236b": (7_420_365_824, 5_469_224_448),
                          "grok-1-314b": (7_412_400_128, 6_607_908_864),
                          "recurrentgemma-2b": (1_298_183_680,
                                                1_172_562_432),
                          "rwkv6-1.6b": (1_137_633_280, 1_010_473_472)}
# the `cuda` case of tests/test_torch_lm_distributed.py in the same group:
# these smoke models' f32 forwards on (1, 2) within PLACED_FORWARD_TOL of
# one process's on the card
PLACED_FORWARD = ("granite-3-8b", "deepseek-v2-236b", "grok-1-314b",
                  "recurrentgemma-2b", "rwkv6-1.6b")
PLACED_FORWARD_TOL = 1e-6
# each mixed-precision run's bar on its PCPG iterations summed over the
# defect-correction outers (a multi-RHS run: its most iterated column): the
# counts measured on the card (NVIDIA H100 80GB HBM3, 700 W) with a small
# margin. The explicit f32 heat-2d runs took 2,174 while the f32 factor
# stalled an outer (ROADMAP C6); with the factor at the reference's accuracy
# they take 194 in one outer
ITER_BAR = {
    "heat-2d dense --kernels f32": 215,
    "heat-2d packed --kernels f32": 215,
    "heat-2d implicit f32": 160,
    "elasticity-3d dense --kernels dirichlet f32": 340,
    "heat-2d smoke --kernels bf16": 32,
    "heat-2d dense --fused f32": 215,
    "heat-2d packed --fused f32": 215,
    "elasticity-3d dense --fused dirichlet f32": 340,
    "heat-2d smoke --fused bf16": 32,
    "heat-2d dense --kernels --n-rhs 8": 160,
    "heat-2d packed --fused --n-rhs 8 f32": 215,
}
# the f32 dense --kernels run's peak device bytes may exceed its peak before
# the f32 factorization took its steps at f64 (measured on the card, NVIDIA
# H100 80GB HBM3, 700 W) by at most 10%: those steps take only (S, bs, bs)
# transients
F32_PEAK = ("heat-2d dense --kernels f32", 13_074_707_968, 1.10)
# (f32 run, its f64 twin): the f32 factor and F stacks take exactly half
# the twin's bytes
HALF_BYTES = (("heat-2d dense --kernels f32", "heat-2d dense --kernels"),
              ("heat-2d packed --kernels f32", "heat-2d packed --kernels"),
              ("heat-2d dense --fused f32", "heat-2d dense --fused"),
              ("heat-2d packed --fused f32", "heat-2d packed --fused"))
# runs whose iteration counts must agree within one: the same
# configuration and preconditioner
SAME_SOLVE = (
    ("heat-2d dense --kernels", "heat-2d packed --kernels",
     "heat-2d dense --fused", "heat-2d packed --fused"),
    ("elasticity-2d dense --kernels dirichlet",
     "elasticity-2d packed --fused dirichlet"),
    ("elasticity-3d packed --kernels dirichlet",
     "elasticity-3d dense --fused dirichlet"),
)
F_KERNELS = ("stepped_syrk", "stepped_trsm_syrk", "stepped_trsm_syrk_packed")
FUSED = F_KERNELS[1:]  # timed beside their unfused pair at their dtype
# the TRSM core's kernels: (name, library, factor accessor's mangled name)
TRSM_CORE = (("stepped_trsm", "stepped_trsm", "11DenseFactor"),
             ("stepped_trsm_packed", "stepped_trsm", "12PackedFactor"),
             ("stepped_trsm_syrk", "stepped_trsm_syrk", "11DenseFactor"),
             ("stepped_trsm_syrk_packed", "stepped_trsm_syrk",
              "12PackedFactor"))


def core_instances(kc, passes):
    """{kernel key: (library, a substring of the mangled kernel name)} of
    the TRSM core's instances <T, KC, PASSES, Factor>; ``kc`` maps the
    dtype to KC."""
    return {
        kernel_key(name, dtype): (
            lib, f"I{t}Li{kc(dtype)}ELi{passes}EN7stepped{factor}I{t}EE")
        for dtype, t in (("f64", "d"), ("f32", "f"))
        for name, lib, factor in TRSM_CORE}


def row_kc(dtype):
    """The row-split core's deepest chunks (ROW_KC): 16 at f64, 32 at f32."""
    return 16 if dtype == "f64" else 32


def cluster_instance(passes):
    """(library, mangled-name substring) of the packed f32 TRSM's own core
    above bs 16 (csrc/stepped_trsm_cluster.cuh), 32-deep chunks, in
    ``passes`` passes."""
    return ("stepped_trsm", f"stepped_trsm_cluster_kernelIfLi32ELi{passes}E")


# (library, a substring of the mangled kernel name) of each kernel: the
# row-split core's one-pass instances with its deepest chunks, which every
# bs the full-size main paths use (the packed f32 TRSM: its cluster core),
# and the stepped SYRK's one instance a dtype
INSTANCES = {**core_instances(row_kc, 1),
             "stepped_trsm_packed_f32": cluster_instance(1),
             "stepped_syrk": ("stepped_syrk", "stepped_syrk_kernelIdE"),
             "stepped_syrk_f32": ("stepped_syrk", "stepped_syrk_kernelIfE")}
# the small-block instances (the panel core on the dense factor, the
# k-split core on the packed one; bs <= 16: the bs = 16 phase and the smoke
# configurations' bs = 8)
SMALL_INSTANCES = core_instances(lambda dtype: 0, 1)
# the two-pass instances (128 < bs <= 256: the large-block phase)
WIDE_INSTANCES = {**core_instances(row_kc, 2),
                  "stepped_trsm_packed_f32": cluster_instance(2)}
# the libraries whose SASS must run on the FP64 tensor cores
DMMA_LIBS = ("stepped_syrk", "stepped_trsm_syrk")
# the libraries whose f32 products must run 3xTF32 on the tensor cores
TF32_LIBS = ("stepped_trsm", "stepped_syrk", "stepped_trsm_syrk")
SOURCES = {
    "stepped_trsm": ("src/repro_torch/kernels/csrc/stepped_trsm.cu",
                     "src/repro/kernels/stepped_trsm.py:66"),
    "stepped_syrk": ("src/repro_torch/kernels/csrc/stepped_syrk.cu",
                     "src/repro/kernels/stepped_syrk.py:60"),
    "stepped_trsm_packed": ("src/repro_torch/kernels/csrc/stepped_trsm.cu",
                            "src/repro/kernels/stepped_trsm.py:136"),
    "stepped_trsm_syrk": ("src/repro_torch/kernels/csrc/stepped_trsm_syrk.cu",
                          "src/repro/kernels/stepped_trsm_syrk.py:145"),
    "stepped_trsm_syrk_packed": (
        "src/repro_torch/kernels/csrc/stepped_trsm_syrk.cu",
        "src/repro/kernels/stepped_trsm_syrk.py:186"),
}
SOURCES.update({kernel_key(n, "f32"): SOURCES[n] for n in F32_NAMES})


def phase(name):
    print(f"[chip_smoke] --- {name}", flush=True)
    return time.perf_counter()


def done(name, t0):
    print(f"[chip_smoke] {name}: {time.perf_counter() - t0:.1f}s", flush=True)


def cuda_ms(fn, reps=REPS):
    """Median over ``reps`` runs of ``fn`` (after one warm-up), each timed
    with CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(got, want):
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return diff, diff / max(scale, 1e-300)


def stepped_inputs(S, env, L, packed, B, device):
    """The kernels' operands as the assembler hands them over: the padded
    dense factor ``L`` (S, n, n) and its diagonal inverses, its ``packed``
    form, the right-hand side ``B`` (S, n, m) already in stepped column
    order padded to block multiples (padded entries exact zeros), the
    start blocks and both fused item lists."""
    import torch

    from repro_torch.kernels import ops

    bs, bm = env.block_size, env.rhs_block_size
    n_pad, m_pad = -(-env.n // bs) * bs, -(-env.m // bm) * bm
    Lp = ops.pad_factor(L, n_pad)
    Bp = ops._pad_to(B, n_pad, m_pad)
    starts_np = ops._start_blocks(env, bm, bs, m_pad, n_pad)
    orders = (ops._fused_order(env, S, device),
              ops._fused_order(env, S, device, packed.index))
    torch.cuda.synchronize()
    return dict(S=S, env=env, bs=bs, bm=bm, n_pad=n_pad, m_pad=m_pad,
                Lp=Lp, Bp=Bp, Linv=ops.invert_diag_blocks(Lp, bs),
                packed=packed, packed_ops=ops._packed_operands(packed, env),
                starts=torch.as_tensor(starts_np, device=device),
                starts_np=starts_np, orders=orders)


def kernel_inputs(device):
    """The dual stage's stepped operands the feti-heat-2d main paths build,
    from a real full-size factorization (implicit mode: no assembly, no
    kernel), and the same factor packed in the fill-mask layout."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiConfig, preprocess_cluster
    from repro_torch.sparse import pack_factor

    fc = get_config(ARCH)
    t0 = time.perf_counter()
    prob = decompose_problem(fc.problem, fc.dim, fc.sub_grid, fc.elems_per_sub)
    t1 = time.perf_counter()
    cfg = SchurAssemblyConfig(block_size=fc.block_size,
                              rhs_block_size=fc.rhs_block_size)
    st = preprocess_cluster(prob, FetiConfig(schur=cfg, mode="implicit",
                                             device=device))
    torch.cuda.synchronize()
    print(f"[chip_smoke] host decomposition {t1 - t0:.2f}s; preprocessing "
          f"without assembly (upload, symbolic, factorization) "
          f"{time.perf_counter() - t1:.2f}s", flush=True)
    packed = pack_factor(st.L, st.index)
    Bpp = torch.gather(st.Btp, 2, st.col_perm[:, None, :].expand_as(st.Btp))
    S, env, L, Btp = st.S, st.env, st.L, st.Btp
    patterns = [sd.Bt[st.node_perm] != 0 for sd in prob.subdomains]
    del st
    x = stepped_inputs(S, env, L, packed, Bpp, device)
    x.update(Btp=Btp, patterns=patterns)
    return x


def reblocked_inputs(x, device, bs):
    """The heat-2d phase's operands at bs = bm = ``bs``: the same factor
    and right-hand side, the stepped metadata rebuilt at that block size
    (each subdomain's column order, their envelope) and the factor packed
    in the layout of its nonzero blocks at that size."""
    import numpy as np
    import torch

    from repro_torch.core import build_stepped_meta, shared_envelope
    from repro_torch.kernels import ops
    from repro_torch.sparse import PackedBlockIndex, pack_factor

    metas = [build_stepped_meta(p, block_size=bs, rhs_block_size=bs)
             for p in x["patterns"]]
    env = shared_envelope(metas)
    cp = torch.as_tensor(np.stack([me.perm for me in metas]), device=device)
    Btp = x["Btp"]
    B = torch.gather(Btp, 2, cp[:, None, :].expand_as(Btp))
    S, n = x["S"], env.n
    L = x["Lp"][:, :n, :n]
    nb = -(-n // bs)
    Lb = ops.pad_factor(L, nb * bs).view(S, nb, bs, nb, bs)
    mask = (Lb != 0).any(dim=4).any(dim=2).any(dim=0).cpu().numpy()
    del Lb
    packed = pack_factor(L, PackedBlockIndex.from_mask(mask, n, bs))
    return stepped_inputs(S, env, L, packed, B, device)


def dirichlet_inputs(device):
    """The Dirichlet stage's stepped operands of the full-size feti-heat-3d
    configuration, cut from each subdomain's K as the preprocessor cuts
    them (``DirichletBlocks``): the interior factor from the stage's own
    block Cholesky (dense, and packed in the interior fill-mask layout),
    K_ib in stepped column order, and K_bb. Also returns what the S_b
    check needs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import dirichlet as dirlib
    from repro_torch.sparse import PackedBlockIndex, block_cholesky, pack_factor

    fc = get_config("feti-heat-3d")
    bs, bm = fc.block_size, fc.rhs_block_size
    t0 = time.perf_counter()
    prob = decompose_problem(fc.problem, fc.dim, fc.sub_grid, fc.elems_per_sub)
    t1 = time.perf_counter()
    split = dirlib.boundary_interior_split(prob)
    meta, mask = dirlib.dirichlet_symbolic(prob, split, bs, bm)
    S, n = prob.n_subdomains, split.n
    n_lambda, m_max = prob.n_lambda, prob.m_max
    blocks = dirlib.DirichletBlocks(split, S, device, interior=True
                                    ).upload(prob)
    del prob
    L = block_cholesky(blocks.Kii, bs, mask=mask)
    torch.cuda.synchronize()
    print(f"[chip_smoke] feti-heat-3d {fc.sub_grid} x {fc.elems_per_sub}: "
          f"host decomposition {t1 - t0:.2f}s; split, K upload and interior "
          f"factorization {time.perf_counter() - t1:.2f}s; S={S} n={n} "
          f"n_lambda={n_lambda} m_max={m_max} "
          f"n_i={split.n_i} n_b={split.n_b} interior blocks "
          f"{int(mask.sum())}/{mask.shape[0] * (mask.shape[0] + 1) // 2}",
          flush=True)
    packed = pack_factor(L, PackedBlockIndex.from_mask(mask, split.n_i, bs))
    B = blocks.Kib[:, :, torch.as_tensor(meta.perm, device=device)]
    x = stepped_inputs(S, meta, L, packed, B, device)
    del B
    del L
    x.update(split=split, mask=mask, Kib=blocks.Kib, Kbb=blocks.Kbb)
    return x


def _packed_walk(x, word=8):
    """FLOPs and factor bytes of the packed TRSM's walk on this run's
    data: per stripe, rows k >= start, the stored off-diagonal slots with
    block column >= start (2 r_k r_j w each) and the diagonal triangular
    solve (r_k^2 w); w is the stripe's real column count, r_k a block's
    real row count. The factor bytes count every slot some stripe walks,
    once, at ``word`` bytes an element."""
    env, index = x["env"], x["packed"].index
    bs, n = x["bs"], env.n
    rows = [min(bs, n - k * bs) for k in range(index.nb)]
    flops = 0
    walked = set()
    for c, start in enumerate(int(s) for s in x["starts_np"]):
        c0, c1 = env.col_block(c) if c < env.num_col_blocks else (0, 0)
        w = c1 - c0
        for k in range(start, index.nb):
            flops += rows[k] * rows[k] * w
            for j, t in index.row_slots(k):
                if j >= start:
                    flops += 2 * rows[k] * rows[j] * w
                    walked.add(t)
    return x["S"] * flops, word * x["S"] * len(walked) * bs * bs


def chunk_bytes(x, cluster, word=4):
    """(factor, Linv, Y) bytes the packed TRSM's column tiles copy from L2
    into shared memory on this run's data, as ``_packed_walk`` walks it:
    each 32-column tile takes its stripe's rows from the start, for every
    stored slot right of the start a box of min(bs, 128) rows by bs and the
    slot's Y rows a pass (two passes above bs 128), and the row's Linv block
    (above bs 128: 128 x 128, then 128 x bs); a cluster of ``cluster`` tiles
    copies each factor and Linv box once, each tile its own Y."""
    from repro_torch.kernels._launch import TILE

    index, bs, bm = x["packed"].index, x["bs"], x["bm"]
    passes = -(-bs // 128)
    box = min(bs, 128) * bs * passes
    linv = bs * bs if passes == 1 else 128 * 128 + 128 * bs
    factor = linv_n = slots = 0
    for t in range(-(-x["m_pad"] // TILE)):
        start = min(int(x["starts_np"][t * TILE // bm]), index.nb)
        for k in range(start, index.nb):
            walked = sum(1 for j, _ in index.row_slots(k) if j >= start)
            factor += walked * box
            slots += walked
            linv_n += linv
    S = x["S"]
    return (word * S * factor // cluster, word * S * linv_n // cluster,
            word * S * slots * bs * TILE * passes)


def cluster_check(build, bs, bm):
    """The packed f32 TRSM's cluster at (bs, bm): the column tiles its C
    launcher puts in one cluster, and the clusters of it the card holds at
    once."""
    import ctypes

    lib = build.load("stepped_trsm")
    lib.stepped_trsm_cluster_tiles.argtypes = [ctypes.c_int]
    lib.stepped_trsm_cluster_tiles.restype = ctypes.c_int
    fn = lib.stepped_trsm_cluster_resident
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    c = lib.stepped_trsm_cluster_tiles(bm)
    n = ctypes.c_int(0)
    err = fn(bs, c, ctypes.byref(n))
    if err or n.value < 1:
        raise SystemExit(f"no cluster of {c} fits at bs {bs}: CUDA error "
                         f"{err}")
    return c, n.value


def ptxas_report(build, built, instances=INSTANCES):
    """{kernel: {registers, spill_stores, spill_loads, static_smem,
    ptxas_cached}} of each of ``instances`` from the nvcc logs (``-Xptxas
    -v``); ``ptxas_cached`` when the library was not in ``built``, the
    builds of this run, so its log is an earlier build's."""
    per_lib = {}
    for lib in {lib for lib, _ in instances.values()}:
        log = build._library_path(lib).with_suffix(".log")
        per_lib[lib] = re.split(r"Compiling entry function",
                                log.read_text())[1:]
    out = {}
    for name, (lib, tag) in instances.items():
        block = next(b for b in per_lib[lib] if tag in b.split("'")[1])
        regs = re.search(r"Used (\d+) registers", block)
        # one line per function: the kernel and any function it calls
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        out[name] = dict(registers=int(regs.group(1)),
                         spill_stores=sum(int(a) for a, _ in spills),
                         spill_loads=sum(int(b) for _, b in spills),
                         static_smem=int(smem.group(1)) if smem else 0,
                         ptxas_cached=lib not in built)
    return out


def sass_functions(build, lib):
    """{mangled function name: its SASS} of one kernel library
    (``cuobjdump -sass``)."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(build._library_path(lib))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    parts = re.split(r"Function : (\S+)", sass)
    return dict(zip(parts[1::2], parts[2::2]))


def dmma_counts(build):
    """DMMA instructions in the SASS of each library of DMMA_LIBS."""
    return {lib: sum(len(re.findall(r"\bDMMA\b", code))
                     for code in sass_functions(build, lib).values())
            for lib in DMMA_LIBS}


def hmma_counts(build):
    """TF32 HMMA instructions (``HMMA.1688.F32.TF32``, the m16n8k8 TF32
    product) in each f32 kernel instance, by library and mangled kernel
    name, and the distinct HMMA forms found there."""
    counts, forms = {}, set()
    for lib in TF32_LIBS:
        for name, code in sass_functions(build, lib).items():
            if re.search(r"stepped_(trsm|syrk|trsm_syrk|trsm_cluster)"
                         r"_kernelIf", name):
                counts[f"{lib}:{name}"] = len(
                    re.findall(r"\bHMMA\.1688\.F32\.TF32\b", code))
                forms.update(re.findall(r"\bHMMA\.\S+", code))
    return counts, sorted(forms)


def fused_residency(build, ptxas, ptxas_small):
    """{f32 fused instance and bs: registers (ptxas) and resident blocks a
    SM (the persistent grid the launcher takes,
    ``stepped_trsm_syrk_grid_f32``, over the card's SMs)} at bs = 128 and
    bs = SMALL_BS."""
    import ctypes

    import torch

    fn = build.load("stepped_trsm_syrk").stepped_trsm_syrk_grid_f32
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for key, packed in (("stepped_trsm_syrk_f32", 0),
                        ("stepped_trsm_syrk_packed_f32", 1)):
        for bs, regs in ((128, ptxas), (SMALL_BS, ptxas_small)):
            blocks = ctypes.c_int(0)
            err = fn(bs, packed, ctypes.byref(blocks))
            if err:
                raise SystemExit(f"stepped_trsm_syrk_grid_f32 at bs {bs}: "
                                 f"CUDA error {err}")
            out[f"{key} bs={bs}"] = dict(registers=regs[key]["registers"],
                                         blocks_per_sm=blocks.value / sms)
    return out


def op_routes(flops, f32):
    """{route: ms} the card needs for ``flops`` operations at f64 (the FP64
    tensor cores) or at f32 accuracy (FFMA, or 3xTF32: three TF32 tensor-core
    products for each)."""
    from repro_torch.launch.roofline import HW

    if not f32:
        return {"fp64 tensor cores": flops / HW["peak_flops_f64"] * 1e3}
    return {"ffma": flops / HW["peak_flops_f32"] * 1e3,
            "3xtf32": 3 * flops / HW["peak_flops_tf32"] * 1e3}


def bounds(x, f32=False):
    """Least card time (ms) of each kernel's work on this run's inputs: the
    larger of its operations' least time over the routes of their type
    (:func:`op_routes`: at f32 the 3xTF32 one) and the bytes it must move
    (each input read once, each output written once, 8 or, at f32, 4 bytes
    an element) over the memory rate. Operations come from the repo's FLOP
    model of the schedule, or, for the packed TRSM, from the stored slots it
    walks. A fused kernel need not move Y: its bytes are factor + Linv + B +
    F."""
    from repro_torch.launch.roofline import HW

    S, bs, bm, n_pad, m_pad = x["S"], x["bs"], x["bm"], x["n_pad"], x["m_pad"]
    env, starts = x["env"], [int(s) for s in x["starts_np"]]
    word = 4 if f32 else 8
    nb = n_pad // bs
    rows_from = nb - min(starts)
    dense_L = word * S * bs * bs * rows_from * (rows_from + 1) // 2
    linv = word * S * bs * bs * rows_from
    B = word * S * sum((nb - s) * bs * bm for s in starts)
    Y = word * S * n_pad * m_pad
    F = word * S * m_pad * m_pad
    trsm = S * env.flops_trsm_rhs_split()
    syrk = S * env.flops_syrk_output_split()
    packed_flops, packed_L = _packed_walk(x, word)
    work = {
        "stepped_trsm": (trsm, dense_L + linv + B + Y),
        "stepped_syrk": (syrk, B + F),  # Y below each start, read once
        "stepped_trsm_packed": (packed_flops, packed_L + linv + B + Y),
        "stepped_trsm_syrk": (trsm + syrk, dense_L + linv + B + F),
        "stepped_trsm_syrk_packed": (packed_flops + syrk,
                                     packed_L + linv + B + F),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        routes = op_routes(flops, f32)
        route = min(routes, key=routes.get)
        t_ops = routes[route]
        t_bytes = nbytes / HW["hbm_bw"] * 1e3
        out[name] = dict(flops=flops, bytes=nbytes, ops_ms=routes,
                         ops_route=route, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes")
    return out


def upper_tiles_zero(F, bm, m_pad):
    return all(bool((F[:, i * bm:(i + 1) * bm, (i + 1) * bm:] == 0).all())
               for i in range(m_pad // bm))


def check_kernels(x, names, dtype, label, ptxas=None, plain_reps=REPS):
    """Hold each named kernel at ``dtype`` on ``x``'s operands (for "f32"
    rounded to f32, the diagonal blocks inverted at f32 as the f32 pipeline
    does) against its plain version at that dtype, its twin and the library
    call(s), then time it beside them and its bound. An f64 kernel's twin
    is its dense or unfused counterpart (the packed TRSM against the dense
    one; a fused kernel against TRSM then SYRK, which is also timed as its
    yardstick); an f32 kernel's, the f64 kernel on the same f32 operands.
    Returns the JSON rows (without launches), with ``ptxas``'s figures
    where given."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels import ops
    from repro_torch.kernels._launch import TILE
    from repro_torch.kernels.ref import syrk_ref, trsm_ref
    from repro_torch.launch.roofline import HW

    f32 = dtype == "f32"
    t = torch.float32 if f32 else torch.float64
    bs, bm, n_pad, m_pad = x["bs"], x["bm"], x["n_pad"], x["m_pad"]
    Lp = x["Lp"].to(t)
    dense = (ops.invert_diag_blocks(Lp, bs), Lp) if f32 else (x["Linv"], Lp)
    packed = (ops._packed_operands(x["packed"].to(t), x["env"]) if f32
              else x["packed_ops"])
    Bp, starts = x["Bp"].to(t), x["starts"]
    order, packed_order = x["orders"]
    # the SYRK items of each fused launch's list (after its TRSM items)
    trsm_items = x["S"] * -(-m_pad // TILE)
    syrk_items = {"stepped_trsm_syrk": order.numel() - trsm_items,
                  "stepped_trsm_syrk_packed": packed_order.numel() - trsm_items}
    tol, lib_tol = (F32_TOL, F32_LIB_TOL) if f32 else (REL_TOL, LIB_TOL)
    bnd = bounds(x, f32)
    index = x["packed"].index
    print(f"[chip_smoke] {label} {dtype} shapes: S={x['S']} n={x['env'].n} "
          f"n_pad={n_pad} m={x['env'].m} m_pad={m_pad} "
          f"bs={bs} bm={bm} start_block={x['starts_np'].tolist()} packed "
          f"blocks={index.n_blocks}/{index.nb * (index.nb + 1) // 2}",
          flush=True)

    def trsm():
        return K.stepped_trsm_kernel(*dense, Bp, starts, bs, bm)

    def trsm_packed():
        return K.stepped_trsm_packed_kernel(*packed, Bp, starts, bs, bm)

    def syrk(Z):
        return K.stepped_syrk_kernel(Z, starts, bs, bm)

    def wide(operands):  # the same values at f64
        return [a.double() if a.is_floating_point() else a for a in operands]

    Y = trsm()
    torch.cuda.synchronize()
    # name: (kernel, plain version, library call, twin); the library
    # yardsticks are one full triangular solve on the dense (= the
    # unpacked) factor and one batched product
    runs = {
        "stepped_trsm": (
            trsm, lambda: K.stepped_trsm_plain(*dense, Bp, starts, bs, bm),
            lambda: trsm_ref(Lp, Bp),
            (lambda: K.stepped_trsm_kernel(*wide(dense), Bp.double(), starts,
                                           bs, bm)) if f32 else None),
        "stepped_syrk": (
            lambda: syrk(Y), lambda: K.stepped_syrk_plain(Y, starts, bs, bm),
            lambda: syrk_ref(Y),
            (lambda: syrk(Y.double())) if f32 else None),
        "stepped_trsm_packed": (
            trsm_packed,
            lambda: K.stepped_trsm_packed_plain(*packed, Bp, starts, bs, bm),
            lambda: trsm_ref(Lp, Bp),
            (lambda: K.stepped_trsm_packed_kernel(*wide(packed), Bp.double(),
                                                  starts, bs, bm))
            if f32 else (lambda: Y)),
        "stepped_trsm_syrk": (
            lambda: K.stepped_trsm_syrk_kernel(*dense, Bp, starts, bs, bm,
                                               order=order),
            lambda: K.stepped_trsm_syrk_plain(*dense, Bp, starts, bs, bm),
            lambda: syrk_ref(trsm_ref(Lp, Bp)),
            (lambda: K.stepped_trsm_syrk_kernel(*wide(dense), Bp.double(),
                                                starts, bs, bm, order=order))
            if f32 else (lambda: syrk(trsm()))),
        "stepped_trsm_syrk_packed": (
            lambda: K.stepped_trsm_syrk_packed_kernel(
                *packed, Bp, starts, bs, bm, order=packed_order),
            lambda: K.stepped_trsm_syrk_packed_plain(*packed, Bp, starts, bs,
                                                     bm),
            lambda: syrk_ref(trsm_ref(Lp, Bp)),
            (lambda: K.stepped_trsm_syrk_packed_kernel(
                *wide(packed), Bp.double(), starts, bs, bm,
                order=packed_order))
            if f32 else (lambda: syrk(trsm_packed()))),
    }
    # the fused kernels' yardstick: their unfused pair at their dtype, run
    # back to back
    pairs = {"stepped_trsm_syrk": lambda: syrk(trsm()),
             "stepped_trsm_syrk_packed": lambda: syrk(trsm_packed())}
    twin_names = {
        "stepped_trsm_packed": "the dense TRSM kernel",
        "stepped_trsm_syrk": "the TRSM then SYRK kernels",
        "stepped_trsm_syrk_packed": "the packed TRSM then SYRK kernels",
    }
    lib_names = {
        "stepped_trsm": "torch.linalg.solve_triangular (full padded)",
        "stepped_syrk": "bmm-based Y^T Y",
        "stepped_trsm_packed": "torch.linalg.solve_triangular on the dense "
                               "factor (the unpacked one)",
        "stepped_trsm_syrk": "solve_triangular then Y^T Y",
        "stepped_trsm_syrk_packed": "solve_triangular on the dense factor "
                                    "then Y^T Y",
    }
    rows = []
    for name in names:
        kernel, plain, lib, twin = runs[name]
        key = kernel_key(name, dtype)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        abs_err, rel_err = compare(got, want)
        ref = twin() if twin else None
        twin_err = compare(got.to(torch.float64), ref)[1] if twin else 0.0
        # an f32 kernel's yardstick: its plain version's own distance from
        # the f64 kernel
        plain_twin_err = (compare(want.to(torch.float64), ref)[1] if f32
                          else None)
        del want, ref
        is_F = name in F_KERNELS
        full = ops._mirror_lower(got, bm, m_pad, m_pad) if is_F else got
        lib_err = compare(full, lib())[1]
        zero_ok = upper_tiles_zero(got, bm, m_pad) if is_F else True
        print(f"[chip_smoke] {label} {key}: "
              f"max|out|={got.abs().max().item():.3e} "
              f"max|kernel-plain|={abs_err:.3e} rel={rel_err:.3e} rel vs "
              f"twin={twin_err:.3e} rel vs library={lib_err:.3e}"
              + (f" (plain vs twin {plain_twin_err:.3e})" if f32 else "")
              + (f" upper tiles zero={zero_ok}" if is_F else ""), flush=True)
        twin_tol = (F32_TRSM_TWIN_TOL if f32 and name in F32_TRSM
                    else F32_SYRK_TWIN_TOL[label]
                    if f32 and name == "stepped_syrk" else tol)
        if not (rel_err <= tol and twin_err <= twin_tol
                and lib_err <= lib_tol and zero_ok
                and bool(torch.isfinite(got).all())):
            raise SystemExit(f"{label} {key} disagrees: rel {rel_err:.3e} to "
                             f"its plain version, {twin_err:.3e} to its twin "
                             f"(bar {twin_tol:g}), "
                             f"{lib_err:.3e} to the library, upper tiles "
                             f"zero={zero_ok}")
        del got, full
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, reps=plain_reps)
        library_ms = cuda_ms(lib)
        pair_ms = cuda_ms(pairs[name]) if name in FUSED else None
        source, replaces = SOURCES[name]
        b = bnd[name]
        tflops = b["flops"] / ms / 1e9
        rows.append(dict(
            name=key, route="cuda", source=source, replaces=replaces,
            max_abs_err=abs_err, max_rel_err=rel_err, twin_rel_err=twin_err,
            plain_twin_rel_err=plain_twin_err,
            twin=("the f64 kernel on the same f32 operands" if f32
                  else twin_names.get(name)),
            library_rel_err=lib_err, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, library_call=lib_names[name],
            bound_ms=b["bound_ms"], bound_by=b["bound_by"],
            bound_ops_ms=b["ops_ms"], bound_ops_route=b["ops_route"],
            tflops=tflops,
            bound_share=b["bound_ms"] / ms, unfused_pair_ms=pair_ms,
            syrk_items=syrk_items.get(name), bs=bs, bm=bm,
            **(ptxas or {}).get(key, {})))
        if key == "stepped_trsm_packed_f32" and bs > 16:
            from repro_torch.kernels import build as kbuild

            c, resident = cluster_check(kbuild, bs, bm)
            tile_f, tile_l, ybytes = chunk_bytes(x, 1)
            clu_f, clu_l, _ = chunk_bytes(x, c)
            rows[-1].update(cluster=c, resident_clusters=resident)
            print(f"[chip_smoke] {label} {key}: clusters of {c} column tiles "
                  f"({resident} resident); chunk bytes reckoned from the "
                  f"slot walk, not counted: factor {clu_f:,} B + Linv "
                  f"{clu_l:,} B (a tile each: {tile_f:,} + {tile_l:,}), Y "
                  f"{ybytes:,} B", flush=True)
        routes = ", ".join(f"{r} {t:.3f} ms" for r, t in b["ops_ms"].items())
        print(f"[chip_smoke] {label} {key}: {ms:.3f} ms (plain "
              f"{plain_ms:.3f}, library {library_ms:.3f}, bound "
              f"{b['bound_ms']:.3f} by {b['bound_by']}: {b['flops']:.4e} "
              f"{dtype} flop ({routes}; the bound takes {b['ops_route']}), "
              f"{b['bytes']:.4e} B at {HW['hbm_bw'] / 1e12:g} TB/s)",
              flush=True)
        print(f"[chip_smoke] {label} {key}: {tflops:.2f} useful TFLOP/s, "
              f"{100 * b['bound_ms'] / ms:.1f}% of the bound, "
              f"{library_ms / ms:.2f}x the library call's speed"
              + (f"; unfused pair back to back {pair_ms:.3f} ms "
                 f"({pair_ms / ms:.2f}x the fused time); "
                 f"{syrk_items[name]} SYRK items ({trsm_items} TRSM items)"
                 if pair_ms is not None else ""), flush=True)
    return rows


def check_dirichlet_sb(x):
    """S_b = K_bb - K_bi K_ii^-1 K_ib of the full-size feti-heat-3d stage,
    from the stage's assembler given the interior factor: through the
    kernels (B1+B2, B4; B3+B2, B5) against the plain variants (the
    factor-split TRSM and input-split SYRK in torch ops)."""
    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.feti import dirichlet as dirlib

    env = x["env"]
    dense = x["Lp"][:, :env.n, :env.n]

    def sb(storage, **kw):
        cfg = SchurAssemblyConfig(block_size=x["bs"], rhs_block_size=x["bm"],
                                  storage=storage, **kw)
        assemble = dirlib.make_dirichlet_assembler(
            x["split"], env, x["mask"], cfg, shared=True)
        factor = x["packed"] if storage == "packed" else dense
        return assemble(factor, x["Kib"], x["Kbb"])

    want = sb("dense")
    errs = {}
    for label, storage, kw in (
            ("dense, B1 then B2", "dense", dict(use_kernels=True)),
            ("dense, fused B4", "dense", dict(use_kernels=True, fused=True)),
            ("packed, B3 then B2", "packed", dict(use_kernels=True)),
            ("packed, fused B5", "packed", dict(use_kernels=True, fused=True))):
        errs[label] = compare(sb(storage, **kw), want)[1]
    print(f"[chip_smoke] dirichlet S_b ({want.shape[1]} x {want.shape[2]} "
          f"per subdomain, max|S_b|={want.abs().max().item():.3e}) rel to "
          f"the plain variants: {errs}", flush=True)
    bad = {k: v for k, v in errs.items() if not v <= REL_TOL}
    if bad:
        raise SystemExit(f"dirichlet S_b disagrees with the plain variants: "
                         f"{bad}")


def oracle_key(prob):
    """What decides a problem's scipy oracle."""
    return (prob.problem, prob.dim, tuple(prob.sub_grid),
            tuple(prob.elems_per_sub), repr(sorted(prob.params.items())))


def heat3d_oracle(src, out):
    """HEAT3D_CUT's scipy oracle (the global sparse solve its main path's
    ``--validate`` asks for), solved in a process of its own: puts
    ``(oracle_key, u)`` on the queue ``out``."""
    sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.fem import decompose_problem

    fc = get_config("feti-heat-3d")
    prob = decompose_problem(fc.problem, fc.dim, HEAT3D_SUB_GRID,
                             fc.elems_per_sub)
    out.put((oracle_key(prob), prob.reference_solution()))


def start_oracle(src):
    """Start :func:`heat3d_oracle` in a daemon process (spawned, so that
    it shares no CUDA state; ended with the script if it is still
    running): ``(process, queue)``."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=heat3d_oracle, args=(src, out), daemon=True)
    proc.start()
    return proc, out


def cache_oracles(ahead=None):
    """Solve each configuration's scipy oracle once: the launcher's
    ``--validate`` asks for it on every path, and the paths of one
    configuration share the problem. A load sweep's oracles (each case a
    multiple of the problem's own load, as ``--n-rhs`` makes them) are
    built from it: the solution of s·f is s times f's. ``ahead``: a
    :func:`start_oracle` whose oracle is taken when its configuration's
    first path asks (waiting for it if need be)."""
    import numpy as np

    from repro_torch.fem.decomposition import FetiProblem

    solve = FetiProblem.reference_solution
    solve_all = FetiProblem.reference_solutions
    cache = {}
    pending = {(HEAT3D_SUB_GRID, "heat", 3): ahead} if ahead else {}

    def cached(self, loads=None):
        if loads is not None:
            return solve(self, loads)
        key = oracle_key(self)
        run = pending.pop((tuple(self.sub_grid), self.problem, self.dim),
                          None)
        if run is not None:
            proc, out = run
            t0 = time.perf_counter()
            got, u = out.get()
            proc.join()
            print(f"[chip_smoke] the {key[:4]} oracle came from its own "
                  f"process (waited {time.perf_counter() - t0:.1f} s)",
                  flush=True)
            if got != key:
                raise SystemExit(f"the prefetched oracle is {got}, the "
                                 f"path's problem {key}")
            cache[key] = u
        if key not in cache:
            cache[key] = solve(self)
        return cache[key].copy()

    def cached_all(self, cases):
        base = self.load_stack()
        top = np.argmax(np.abs(base))
        scales = [c.flat[top] / base.flat[top] for c in cases]
        if not all(np.allclose(c, s * base, rtol=1e-15, atol=0)
                   for c, s in zip(cases, scales)):
            return solve_all(self, cases)
        return np.stack([s * cached(self) for s in scales])

    FetiProblem.reference_solution = cached
    FetiProblem.reference_solutions = cached_all


def _counters():
    from repro_torch import kernels

    return {name: getattr(kernels, f"{name}_kernel") for name in KERNEL_NAMES}


def reset_counts():
    from repro_torch.kernels._launch import reset_launches

    for fn in _counters().values():
        reset_launches(fn)


def launch_counts():
    """{kernel key: launches} since the last :func:`reset_counts`, one key
    per kernel and dtype (KERNEL_KEYS)."""
    out = {}
    for name, fn in _counters().items():
        for dtype, count in fn.launches_by_dtype.items():
            if kernel_key(name, dtype) in KERNEL_KEYS:
                out[kernel_key(name, dtype)] = count
    return out


@contextlib.contextmanager
def checked_launches():
    """Within the block, every wrapper ``ops`` calls launches its kernel as
    before and then, once the launch has finished, its output is held
    against the kernel's plain version on the very same operands (the
    plain versions launch nothing, so the counts stay the path's own), at
    REL_TOL for an f64 launch and F32_TOL for an f32 one.
    Yields a dict: ``records``, one per launch (kernel key, padded shape
    (S, n_pad, m_pad), errors, pass); ``check_s``, the checks' own
    seconds; ``peak``, the device peak outside the checks (each check
    resets the peak counter once its operands are freed); ``paused``,
    set while the planner times candidates (their launches go unchecked:
    a plain version at bs 8 takes seconds)."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import ops

    state = dict(records=[], check_s=0.0, peak=0, paused=False)

    def wrap(name, kernel, plain):
        def checked(*args, order=None, **kw):
            out = (kernel(*args, **kw) if order is None
                   else kernel(*args, order=order, **kw))
            if state["paused"]:
                return out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state["peak"] = max(state["peak"], torch.cuda.max_memory_allocated())
            want = plain(*args, **kw)
            abs_err, rel_err = compare(out, want)
            del want
            B = args[-2]  # the right-hand side (or Y): (S, n_pad, m_pad)
            zero_ok = (upper_tiles_zero(out, kw["bm"], B.shape[2])
                       if name in F_KERNELS else True)
            f32 = out.dtype == torch.float32
            ok = (rel_err <= (F32_TOL if f32 else REL_TOL) and zero_ok
                  and bool(torch.isfinite(out).all()))
            state["records"].append(dict(
                kernel=kernel_key(name, "f32" if f32 else "f64"),
                shape=list(B.shape), max_abs_err=abs_err,
                max_rel_err=rel_err, ok=ok))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state["check_s"] += time.perf_counter() - t0
            return out
        return checked

    saved = {name: getattr(ops, f"{name}_kernel") for name in KERNEL_NAMES}
    for name, kernel in saved.items():
        setattr(ops, f"{name}_kernel",
                wrap(name, kernel, getattr(kernels, f"{name}_plain")))
    try:
        yield state
    finally:
        for name, kernel in saved.items():
            setattr(ops, f"{name}_kernel", kernel)
        state["peak"] = max(state["peak"], torch.cuda.max_memory_allocated())


@contextlib.contextmanager
def planning_probe(checks):
    """Within the block, every joint planning (``StageGraph.plan``) pauses
    the launch checks and is recorded: its kernel launches per key, its
    seconds, the graph and its plan (the last one planned)."""
    import torch

    from repro_torch.core import stages

    plan = stages.StageGraph.plan
    rec = dict(launches=dict.fromkeys(KERNEL_KEYS, 0), seconds=0.0,
               graph=None, gplan=None)

    def probed(self, **kw):
        before = launch_counts()
        checks["paused"] = True
        t0 = time.perf_counter()
        try:
            gplan = plan(self, **kw)
            torch.cuda.synchronize()
        finally:
            checks["paused"] = False
        rec["seconds"] += time.perf_counter() - t0
        for k, v in launch_counts().items():
            rec["launches"][k] += v - before[k]
        rec["graph"], rec["gplan"] = self, gplan
        return gplan

    stages.StageGraph.plan = probed
    try:
        yield rec
    finally:
        stages.StageGraph.plan = plan


def plan_launches(gplan):
    """{kernel key: launches} an explicit preprocess runs under a joint
    plan: one per kernel its stage configs name, at the kernels' dtype."""
    out = {}
    for p in gplan.plans.values():
        cfg, packed = p.cfg, p.cfg.storage == "packed"
        if cfg.fused:
            names = ["stepped_trsm_syrk_packed" if packed
                     else "stepped_trsm_syrk"]
        elif cfg.use_kernels:
            names = ([("stepped_trsm_packed" if packed else "stepped_trsm")]
                     if cfg.trsm_variant != "dense" else [])
            names += ["stepped_syrk"] if cfg.syrk_variant != "dense" else []
        else:
            names = []
        dtype = "f64" if p.dtype == "f64" else "f32"  # bf16 runs at f32
        for k in names:
            out[kernel_key(k, dtype)] = out.get(kernel_key(k, dtype), 0) + 1
    return out


def run_main_path(name, arch, flags, expected):
    """Drive the launcher with ``--validate``, every kernel launch checked
    against its plain version (:func:`checked_launches`); returns this
    run's launch counts (per kernel and dtype), checks, iteration count,
    relative error, stack bytes, peak device memory and sharing decision.
    A run in LOOSE is held to its ERR_BAR only (the launcher's exit code
    also reflects its 1e-6 bar and convergence). An ``--autotune`` run
    (``expected`` None) must launch what its joint plan names; the
    planner's own launches are counted apart (``planning``)."""
    import torch

    from repro_torch.launch import solve_feti

    argv = ["--arch", arch, *flags, "--validate"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    buf = io.StringIO()
    auto = "--autotune" in flags
    t0 = time.perf_counter()
    with checked_launches() as checks, contextlib.ExitStack() as stack:
        planned = stack.enter_context(planning_probe(checks)) if auto else None
        stack.enter_context(contextlib.redirect_stdout(buf))
        rc = solve_feti.main(argv)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    if auto:
        if planned["gplan"] is None:
            raise SystemExit(f"{name}: the launcher planned nothing")
        launches = {k: v - planned["launches"][k] for k, v in launches.items()}
        expected = plan_launches(planned["gplan"])
    peak = checks["peak"]
    out = buf.getvalue()
    print(out, end="", flush=True)
    for r in checks["records"]:
        print(f"[chip_smoke] main path {name} launch check {r['kernel']} at "
              f"(S, n_pad, m_pad)={tuple(r['shape'])}: max|kernel-plain|="
              f"{r['max_abs_err']:.3e} rel={r['max_rel_err']:.3e}"
              + ("" if r["ok"] else " FAILED"), flush=True)
    loose = name in LOOSE
    if rc != 0 and not loose:
        raise SystemExit(f"solve_feti {' '.join(argv)} exited {rc}")
    bad = [r for r in checks["records"] if not r["ok"]]
    if bad:
        raise SystemExit(f"{name}: kernel launches disagree with their plain "
                         f"versions (rel > {REL_TOL:g}, nonzero upper tiles "
                         f"or non-finite): {bad}")
    # a multi-RHS run prints every column's iterations, the most iterated
    # column's count is held to the bar, and its error is the worst column's
    m_iters = (re.search(r"iters=\[([\d ]+)\] block_iters=\d+ "
                         r"residual=(\S+) converged=(\w+)", out)
               or re.search(r"iters=(\d+) residual=(\S+) converged=(\w+)",
                            out))
    m_err = re.search(r"rel err vs global solves?: (\S+)", out)
    m_time = re.search(r"preprocess=(\S+)s solve(?:_many)?=(\S+)s", out)
    m_shared = re.search(r"shared_factor=(\w+)", out)
    m_dtype = re.search(r"dtype: storage=(\w+) compute=(\w+) solve=(\w+) "
                        r"refine=(\d+) refine_outer=(\d+)", out)
    m_bytes = re.search(r"device bytes: L=(\S+) K=(\S+) Btp=(\S+) F=(\S+) "
                        r"Kreg=(\S+) ", out)
    if not (m_iters and m_err and m_time and m_dtype and m_bytes) or (
            m_iters.group(3) != "True" and not loose):
        raise SystemExit(f"{name}: solve_feti did not report a converged, "
                         f"validated solve")
    err = float(m_err.group(1))
    bar = ERR_BAR.get(name, 1e-6)
    if not err <= bar:
        raise SystemExit(f"{name}: relative error {err:.3e} > {bar:g}")
    columns = [int(i) for i in m_iters.group(1).split()]
    iterations = max(columns)
    if not iterations <= ITER_BAR.get(name, iterations):
        raise SystemExit(f"{name}: {iterations} PCPG iterations > "
                         f"{ITER_BAR[name]}")
    want = {k: expected.get(k, 0) for k in KERNEL_KEYS}
    if launches != want:
        raise SystemExit(f"{name}: launched {launches}, the path must "
                         f"launch {want}")
    checked = {}
    for r in checks["records"]:
        checked[r["kernel"]] = checked.get(r["kernel"], 0) + 1
    if checked != {k: v for k, v in want.items() if v}:
        raise SystemExit(f"{name}: checked {checked}, launched {launches}")
    shared = m_shared.group(1) if m_shared else "n/a (lumped)"
    # the launcher's preprocess seconds include the launch checks
    prep = float(m_time.group(1)) - checks["check_s"]
    stack = dict(zip(("L", "K", "Btp", "F", "Kreg"),
                     (int(v.replace(",", "")) for v in m_bytes.groups())))
    dtypes = dict(zip(("storage", "compute", "solve", "refine",
                       "refine_outer"), m_dtype.groups()))
    print(f"[chip_smoke] main path {name}: iterations={iterations} "
          + (f"(per column {columns}) " if len(columns) > 1 else "")
          + f"(bar {ITER_BAR.get(name, 'none')}) "
          f"converged={m_iters.group(3)} rel_err={err:.3e} (bar {bar:g}) "
          f"dtypes={dtypes} "
          f"preprocess_s={prep:.2f} (launcher {m_time.group(1)} less "
          f"{checks['check_s']:.2f} of launch checks) "
          f"solve_s={m_time.group(2)} "
          f"peak_device_bytes={peak:,} stack_bytes={stack} "
          f"shared_factor={shared} "
          f"launches={ {k: v for k, v in launches.items() if v} } "
          f"run_s={seconds:.1f}", flush=True)
    if auto:
        gplan = planned["gplan"]
        print(f"[chip_smoke] main path {name} planning: "
              f"{planned['seconds']:.2f}s (in preprocess_s), joint key "
              f"{gplan.key[:12]} cached={gplan.from_cache}, launches "
              f"{ {k: v for k, v in planned['launches'].items() if v} }",
              flush=True)
        for stage, p in gplan.plans.items():
            c = p.cfg
            print(f"[chip_smoke] main path {name} plan [{stage}]: "
                  f"trsm={c.trsm_variant} syrk={c.syrk_variant} "
                  f"bs={c.block_size} bm={c.rhs_bs} kernels={c.use_kernels} "
                  f"fused={c.fused} storage={c.storage}; {p.candidates} "
                  f"candidates scored, none left out, {p.timed} timed; "
                  f"measured {p.measured_s} s against the dense baseline's "
                  f"{p.baseline_measured_s} s", flush=True)
    return dict(launches=launches, iterations=iterations, columns=columns,
                peak=peak, checks=checks["records"], err=err, bytes=stack,
                dtypes=dtypes, planning=planned)


def kernel_rows(rows, d_rows, small, wide, runs):
    """Complete the heat-2d phase's rows for the JSON line, in place: each
    row's launches summed over the main paths (and per path), the main
    paths' launch checks, the Dirichlet phase's numbers, the small-block
    phase's and the large-block phase's."""
    keep = ("ms", "plain_ms", "library_ms", "library_call", "bound_ms",
            "bound_by", "bound_ops_ms", "bound_ops_route", "tflops",
            "bound_share", "max_abs_err", "max_rel_err", "twin_rel_err",
            "plain_twin_rel_err", "twin", "library_rel_err",
            "unfused_pair_ms", "syrk_items")
    if [r["name"] for r in rows] != [d["name"] for d in d_rows]:
        raise SystemExit("the kernel and Dirichlet phases checked different "
                         "kernels")
    for r, d in zip(rows, d_rows):
        per_path = {name: run["launches"][r["name"]]
                    for name, run in runs.items() if run["launches"][r["name"]]}
        r["launches"] = sum(per_path.values())
        r["launches_per_path"] = per_path
        r["path_checks"] = {
            name: [dict(shape=c["shape"], max_abs_err=c["max_abs_err"],
                        max_rel_err=c["max_rel_err"])
                   for c in run["checks"] if c["kernel"] == r["name"]]
            for name, run in runs.items() if name in per_path}
        r["dirichlet_heat_3d"] = {k: d[k] for k in keep}
        for key, phase_rows in ((f"bs{SMALL_BS}", small),
                                (f"bs{WIDE_BS}", wide)):
            r[key] = next(
                ({k: q[k] for k in keep + ("bs", "bm", "registers",
                                            "spill_stores", "spill_loads")}
                 for q in phase_rows if q["name"] == r["name"]), None)


def launch_overhead(device):
    """Median host-to-completion seconds of one small launch through a
    kernel wrapper: the stepped SYRK on one 8 x 8 tile, each call followed
    by a device synchronize (the device model's ``overhead_s``)."""
    import torch

    from repro_torch import kernels

    Y = torch.randn(1, 8, 8, dtype=torch.float64, device=device)
    starts = torch.zeros(1, dtype=torch.int32, device=device)

    def once():
        t0 = time.perf_counter()
        kernels.stepped_syrk_kernel(Y, starts, 8, 8)
        torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    for _ in range(20):
        once()
    return statistics.median(once() for _ in range(LAUNCH_OVERHEAD_REPS))


def autotune_phase(device, runs):
    """The autotune paths (AUTO_RUNS) in a fresh plan cache, their checks
    and the plans' times beside the hand-picked configurations'; returns
    the paths' results."""
    import shutil
    import tempfile

    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.core.autotune import measure_configs
    from repro_torch.launch.roofline import detect_device
    from repro_torch.obs import metrics

    model = detect_device(device)
    overhead = launch_overhead(device)
    print(f"[chip_smoke] launch overhead: median host-to-completion "
          f"{overhead * 1e6:.2f} us over {LAUNCH_OVERHEAD_REPS} launches of "
          f"stepped_syrk_kernel (one 8 x 8 tile); device model "
          f"{model.kind} overhead_s {model.overhead_s * 1e6:.2f} us",
          flush=True)
    root = tempfile.mkdtemp(prefix="repro_torch_plans-")
    saved = os.environ.get("REPRO_TORCH_PLAN_CACHE_DIR")
    os.environ["REPRO_TORCH_PLAN_CACHE_DIR"] = root
    auto = {}
    try:
        for name, arch, flags in AUTO_RUNS:
            metrics.reset()
            auto[name] = run_main_path(name, arch, flags, None)
            auto[name]["graph_hits"] = metrics.get(
                "plan_cache.graph.hit",
                key=auto[name]["planning"]["gplan"].key[:12])
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if saved is None:
            os.environ.pop("REPRO_TORCH_PLAN_CACHE_DIR", None)
        else:
            os.environ["REPRO_TORCH_PLAN_CACHE_DIR"] = saved

    heat, cached, ela = (auto[n] for n in (AUTO_HEAT, AUTO_HEAT_CACHED,
                                           AUTO_ELA))
    planned = {k: v for k, v in heat["planning"]["launches"].items() if v}
    print(f"[chip_smoke] {AUTO_HEAT}: kernel launches during planning "
          f"{planned}", flush=True)
    if not planned:
        raise SystemExit(f"{AUTO_HEAT}: planning launched no kernel")
    want = runs["heat-2d dense --kernels"]["iterations"]
    if abs(heat["iterations"] - want) > 1:
        raise SystemExit(f"{AUTO_HEAT}: {heat['iterations']} iterations, "
                         f"the hand-picked paths {want}")
    for name in (AUTO_HEAT, AUTO_ELA):
        for stage, p in auto[name]["planning"]["gplan"].plans.items():
            if p.measured_s is None:
                raise SystemExit(f"{name} [{stage}]: the plan was not measured")
            if not (p.measured_s <= p.baseline_measured_s
                    or p.cfg.is_dense_baseline):
                raise SystemExit(f"{name} [{stage}]: plan measured "
                                 f"{p.measured_s} s, slower than its dense "
                                 f"baseline {p.baseline_measured_s} s")
    first, again = heat["planning"]["gplan"], cached["planning"]["gplan"]
    relaunched = sum(cached["planning"]["launches"].values())
    print(f"[chip_smoke] {AUTO_HEAT_CACHED}: plan_cache.graph.hit="
          f"{cached['graph_hits']:g} from_cache={again.from_cache} "
          f"planning launches {relaunched} planning "
          f"{cached['planning']['seconds']:.3f}s", flush=True)
    if not (cached["graph_hits"] == 1 and again.from_cache
            and again.key == first.key and relaunched == 0
            and {k: p.cfg for k, p in again.plans.items()}
            == {k: p.cfg for k, p in first.plans.items()}):
        raise SystemExit(f"{AUTO_HEAT_CACHED}: the second preprocess did "
                         "not reuse the cached plan without timing")
    lumped = runs["elasticity-3d dense --kernels lumped"]["iterations"]
    stages = set(ela["planning"]["gplan"].plans)
    print(f"[chip_smoke] {AUTO_ELA}: stages {sorted(stages)}, iterations "
          f"{ela['iterations']} (lumped {lumped})", flush=True)
    if stages != {"dual", "dirichlet"} or not ela["iterations"] < lumped:
        raise SystemExit(f"{AUTO_ELA}: expected both stages planned and "
                         f"fewer iterations than lumped ({lumped})")

    # the plans beside the hand-picked configurations, timed by the
    # planner's own timer on its probes (min of 5 after 2 warmups; the
    # dense baseline's time is the planner's yardstick)
    for name, stage in ((AUTO_HEAT, "dual"), (AUTO_ELA, "dual"),
                        (AUTO_ELA, "dirichlet")):
        spec = auto[name]["planning"]["graph"][stage]
        p = auto[name]["planning"]["gplan"][stage]
        cfgs = [p.cfg] + [SchurAssemblyConfig(**kw)
                          for kw in HAND_PICKED.values()]
        times, base = measure_configs(spec.builder, cfgs, dtype=spec.dtype,
                                      batch=spec.batch, torch_device=device)
        hand = ", ".join(f"{h} {t * 1e3:.3f} ms"
                         for h, t in zip(HAND_PICKED, times[1:]))
        print(f"[chip_smoke] {name} [{stage}] planner's timer: plan "
              f"{times[0] * 1e3:.3f} ms (when planned: "
              f"{p.measured_s * 1e3:.3f}), {hand}, dense baseline "
              f"{base * 1e3:.3f} ms", flush=True)
    return auto


@contextlib.contextmanager
def solver_probe():
    """Within the block, every ``FetiSolver.solve`` records its solver (the
    launcher builds its own), so its telemetry can be read after the
    launcher returns."""
    from repro_torch.feti import solver as solver_mod

    cls = solver_mod.FetiSolver
    solve = cls.solve
    seen = []

    def probed(self, *args, **kw):
        seen.append(self)
        return solve(self, *args, **kw)

    cls.solve = probed
    try:
        yield seen
    finally:
        cls.solve = solve


def span_names(tree):
    """A span tree's names and nesting: [(name, [children...]), ...]."""
    return [(node["name"], span_names(node["children"])) for node in tree]


def print_spans(label, tree, depth=0):
    """Each span's duration, indented by its depth; fails unless every
    child's duration is at most its parent's."""
    for node in tree:
        attrs = {k: v for k, v in node["attrs"].items()
                 if k != "residual_history"}
        print(f"[chip_smoke] {label} span {'  ' * depth}{node['name']} "
              f"{node['duration_s'] * 1e3:.3f} ms {attrs if attrs else ''}",
              flush=True)
        for child in node["children"]:
            if not child["duration_s"] <= node["duration_s"]:
                raise SystemExit(f"{label}: span {child['name']} "
                                 f"({child['duration_s']} s) outlasts its "
                                 f"parent {node['name']} "
                                 f"({node['duration_s']} s)")
        print_spans(label, node["children"], depth + 1)


def telemetry_run(name, flags, expected):
    """One feti-heat-2d solve through the launcher with ``--validate`` and
    the kernel counts set to 0 just before; returns the solver, its
    ``report()``, the launcher's output and its iterations. Fails unless the
    launcher exits 0, launches exactly ``expected``, the span tree is the
    reference's (TELEMETRY_SPANS) with every child within its parent, the
    ``pcpg`` span's ``iterations`` are the solution's and the report's
    device-byte total is the launcher's printout."""
    import torch

    from repro_torch.launch import solve_feti
    from repro_torch.obs import metrics

    gc.collect()
    torch.cuda.empty_cache()
    metrics.reset()
    reset_counts()
    buf = io.StringIO()
    argv = ["--arch", ARCH, *flags, "--validate"]
    with solver_probe() as seen, contextlib.redirect_stdout(buf):
        rc = solve_feti.main(argv)
    launches = launch_counts()
    out = buf.getvalue()
    for line in out.splitlines():
        if line.startswith("[feti]"):
            print(line, flush=True)
    if rc != 0 or len(seen) != 1:
        raise SystemExit(f"{name}: solve_feti {' '.join(argv)} exited {rc}")
    want = {k: expected.get(k, 0) for k in KERNEL_KEYS}
    if launches != want:
        raise SystemExit(f"{name}: launched {launches}, the path must "
                         f"launch {want}")
    solver = seen[0]
    rep = solver.report()
    print_spans(name, rep["spans"])
    if span_names(rep["spans"]) != TELEMETRY_SPANS:
        raise SystemExit(f"{name}: span tree {span_names(rep['spans'])}, "
                         f"the reference's is {TELEMETRY_SPANS}")
    iterations = int(re.search(r"iters=(\d+) ", out).group(1))
    pcpg = rep["spans"][1]["children"][1]
    total = int(re.search(r" total=(\S+)", out).group(1).replace(",", ""))
    print(f"[chip_smoke] {name}: pcpg span iterations "
          f"{pcpg['attrs']['iterations']}, the solution's {iterations}; "
          f"report device_bytes total {rep['device_bytes']['total']:,}, "
          f"the launcher's {total:,}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if not (pcpg["attrs"]["iterations"] == iterations
            and rep["device_bytes"]["total"] == total):
        raise SystemExit(f"{name}: the pcpg span or the report's device "
                         f"bytes disagree with the launcher")
    return dict(solver=solver, report=rep, out=out, iterations=iterations,
                launches=launches, checks=[], total=total)


def telemetry_phase():
    """feti-heat-2d at full width through the launcher twice: explicit
    ``--kernels --trace OUT --report`` and ``--mode implicit`` on the same
    problem (TELEMETRY_RUNS). Validates the trace with
    ``repro_torch.obs.validate``, holds the printed report to the
    launcher's device bytes, and takes the explicit solver's
    ``amortization_report`` with the implicit run's per-iteration time
    (its ``pcpg`` span over its iterations). Returns the runs and the
    amortization."""
    import math

    from repro_torch.obs import validate

    trace = os.path.join(ROOT, "build", "chip_smoke", "heat2d_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    (exp_name, exp_flags, exp_launches), (imp_name, imp_flags,
                                          imp_launches) = TELEMETRY_RUNS
    exp = telemetry_run(exp_name, [*exp_flags, "--trace", trace, "--report"],
                        exp_launches)
    start = exp["out"].index("\n{") + 1
    printed = json.JSONDecoder().raw_decode(exp["out"][start:])[0]
    errors = validate.validate(trace)
    print(f"[chip_smoke] {exp_name}: repro_torch.obs.validate {trace}: "
          f"{errors or 'OK'}; the printed report's device_bytes total "
          f"{printed['device_bytes']['total']:,}", flush=True)
    if errors or validate.main([trace]) != 0:
        raise SystemExit(f"{exp_name}: the trace does not validate: {errors}")
    if printed["device_bytes"]["total"] != exp["total"]:
        raise SystemExit(f"{exp_name}: --report's device bytes "
                         f"{printed['device_bytes']['total']} are not the "
                         f"launcher's {exp['total']}")
    imp = telemetry_run(imp_name, imp_flags, imp_launches)
    if abs(imp["iterations"] - exp["iterations"]) > 1:
        raise SystemExit(f"{imp_name}: {imp['iterations']} iterations, the "
                         f"explicit solve {exp['iterations']}")
    pcpg = imp["solver"].telemetry.tracer.last("pcpg")
    implicit_iter_s = pcpg.duration / pcpg.attrs["iterations"]
    am = exp["solver"].amortization_report(t_implicit_iter_s=implicit_iter_s)
    tr = exp["solver"].telemetry.tracer
    print(f"[chip_smoke] telemetry amortization_iterations "
          f"{am['amortization_iterations']!r}: assembly_s "
          f"{am['assembly_s']!r} (stage:dual: the factorization plus the "
          f"dual assembly, as in the reference; preprocess "
          f"{tr.last('preprocess').duration!r} s, prep "
          f"{tr.last('prep').duration!r} s), explicit_iter_s "
          f"{am['explicit_iter_s']!r} ({exp['iterations']} iterations), "
          f"implicit_iter_s {am['implicit_iter_s']!r} "
          f"({imp['iterations']} iterations); measured_from "
          f"{am['measured_from']}; solve_iter_counts "
          f"{am['solve_iter_counts']}", flush=True)
    if not (math.isfinite(am["amortization_iterations"])
            and am["amortization_iterations"] > 0):
        raise SystemExit(f"amortization_iterations "
                         f"{am['amortization_iterations']} is not finite "
                         f"and positive")
    summary = dict(
        amortization_iterations=am["amortization_iterations"],
        assembly_s=am["assembly_s"], explicit_iter_s=am["explicit_iter_s"],
        implicit_iter_s=am["implicit_iter_s"],
        explicit_iterations=exp["iterations"],
        implicit_iterations=imp["iterations"],
        spans={exp_name: span_durations(exp["report"]["spans"]),
               imp_name: span_durations(imp["report"]["spans"])})
    print(f"[chip_smoke] telemetry {json.dumps(summary)}", flush=True)
    return {exp_name: exp, imp_name: imp}, summary


def sharded_run(name, arch, flags, expected, world, cpu=False):
    """One ``--devices`` solve through the launcher with ``--validate``;
    returns the ranks' results and the launches summed over them. Fails
    unless every rank launches exactly ``expected`` (``cpu``: none; a CPU
    rehearsal with ``--smoke --device cpu`` in ``flags``), the ranks agree,
    the single-device run takes the same iterations within SHARDED_DU and
    the stack bytes sum to the single device's."""
    from repro_torch.launch import solve_feti

    if not cpu:
        import torch

        gc.collect()
        torch.cuda.empty_cache()
    reset_counts()
    buf = io.StringIO()
    argv = ["--arch", arch, *flags, "--validate"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = solve_feti.main(argv)
    seconds = time.perf_counter() - t0
    single = launch_counts()  # the launcher's single-device run's
    out = buf.getvalue()
    for line in out.splitlines():
        if line.startswith(("[feti]", "[autotune]")):
            print(line, flush=True)
    ranks = [json.loads(m.group(1)) for m in
             re.finditer(r"^\[feti\] rank \d+/\d+ (\{.*\})$", out, re.M)]
    m_du = re.search(r"sharded vs single-device: max\|Δu\|=(\S+) iters "
                     r"(\S+) vs (\S+)", out)
    m_bytes = re.search(r"stack bytes sum to the single device's: (\w+)",
                        out)
    if rc != 0 or len(ranks) != world or not (m_du and m_bytes):
        raise SystemExit(f"{name}: solve_feti {' '.join(argv)} exited {rc} "
                         f"with {len(ranks)} rank lines")
    want = {k: 0 if cpu else expected.get(k, 0) for k in KERNEL_KEYS}
    launches = dict.fromkeys(KERNEL_KEYS, 0)
    for rank, r in enumerate(ranks):
        got = dict.fromkeys(KERNEL_KEYS, 0)
        for kernel, by_dtype in r["launches"].items():
            for dtype, count in by_dtype.items():
                got[kernel_key(kernel, dtype)] += count
        pcpg = r["pcpg_all_reduces"]
        print(f"[chip_smoke] {name} rank {rank}: subdomains "
              f"{r['subdomains']} on {r['device']}, preprocess_s "
              f"{r['preprocess_s']!r} solve_s {r['solve_s']!r} "
              f"peak_device_bytes {r['peak_device_bytes']} all_reduces "
              f"{r['all_reduces']} in {r['all_reduce_s']!r} s (PCPG {pcpg}: "
              f"{pcpg / (r['iterations'] + 1):g} an iteration with its "
              f"start) launches { {k: v for k, v in got.items() if v} }",
              flush=True)
        if got != want:
            raise SystemExit(f"{name}: rank {rank} launched {got}, the path "
                             f"must launch {want} on every rank")
        for k, v in got.items():
            launches[k] += v
    du = float(m_du.group(1))
    iters = (m_du.group(2), m_du.group(3))
    print(f"[chip_smoke] {name}: max|Δu| {du:.3e} (bar {SHARDED_DU:g}), "
          f"iterations {iters[0]} sharded, {iters[1]} on one device; stack "
          f"bytes sum to the single device's: {m_bytes.group(1)}; the "
          f"single-device run launched "
          f"{ {k: v for k, v in single.items() if v} }; run_s "
          f"{seconds:.1f}", flush=True)
    if not (du <= SHARDED_DU and iters[0] == iters[1]
            and m_bytes.group(1) == "True"):
        raise SystemExit(f"{name}: the sharded solve is not the single-"
                         "device one")
    if single != want:
        raise SystemExit(f"{name}: the single-device run launched {single}, "
                         f"not {want}")
    return dict(launches=launches, checks=[], ranks=ranks, du=du,
                iterations=int(iters[0]), seconds=seconds)


def sharded_phase(cpu=False):
    """SHARDED_RUNS (with ``cpu``, rehearsed at the smoke sizes on the CPU,
    no launches expected); returns the runs."""
    runs = {}
    for name, arch, flags, expected, world in SHARDED_RUNS:
        if cpu:
            flags = [*flags, "--smoke", "--device", "cpu"]
        runs[name] = sharded_run(name, arch, flags, expected, world, cpu)
    summary = {name: dict(
        iterations=run["iterations"], max_abs_du=run["du"],
        ranks=[{k: r[k] for k in ("subdomains", "preprocess_s", "solve_s",
                                  "peak_device_bytes", "all_reduces",
                                  "all_reduce_s", "pcpg_all_reduces")}
               for r in run["ranks"]]) for name, run in runs.items()}
    print(f"[chip_smoke] sharded {json.dumps(summary)}", flush=True)
    return runs


def span_durations(tree):
    """A span tree as [[name, seconds, children], ...]."""
    return [[node["name"], node["duration_s"],
             span_durations(node["children"])] for node in tree]


def rel_l2(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def lm_counts(cfg, kind, seq, batch, grad_accum=1, remat=False,
              moment_bytes=4, accum_bytes=4):
    """``lm_cell_counts`` of one of this script's LM runs on the one card:
    its own batch, sequence (a decode run: the cache's length) and depth,
    and the port's attention chunks (512 x 512; no causal block
    skipping)."""
    from repro_torch.launch.analytic import lm_cell_counts
    from repro_torch.launch.shapes import ShapeCase

    return lm_cell_counts(cfg, ShapeCase(kind, seq, batch, kind), chips=1,
                          tp=1, grad_accum=grad_accum, remat=remat,
                          moment_bytes=moment_bytes, accum_bytes=accum_bytes,
                          q_chunk=512, kv_chunk=512)


def lm_bounds(cfg, batch, prompt_len, steps):
    """(prefill, decode step) lower bounds in ms from ``lm_cell_counts``:
    the prefill's compute term (every executed product, attention
    included) at the tensor cores' bf16 rate (f32: FFMA, TF32 being off),
    and a decode step's weight and cache stream (every expert's weights:
    ``param_count``) at the memory rate."""
    from repro_torch.launch.roofline import HW

    pre = lm_counts(cfg, "prefill", prompt_len, batch)
    dec = lm_counts(cfg, "decode", prompt_len + steps, batch)
    rate = (HW["peak_flops"] if cfg.dtype == "bfloat16"
            else HW["peak_flops_f32"])
    stream = dec.notes["weight_stream_dev"] + dec.notes["cache_stream_dev"]
    return pre.flops_per_dev / rate * 1e3, stream / HW["hbm_bw"] * 1e3


def lm_serve(cfg, prompt_len, bar, device, smi, batch=LM_BATCH,
             steps=LM_STEPS, of_layers=None):
    """Serve ``cfg`` from the model's own seeded initialization on
    ``device``: ``batch`` random prompts of ``prompt_len`` tokens, ``steps``
    greedy tokens through ``greedy_generate`` (after a short warm-up), then
    one uncached ``forward`` over prompt and generated tokens, whose logits
    at every decoded position must lie within ``bar`` (relative L2) of the
    cached steps'. A MoE config whose capacity can drop entries at these
    lengths is held by its prefill instead: the first generated token's
    logits against one uncached forward over the prompt alone.
    ``of_layers``: the full config's depth, for the row. Returns the row
    printed."""
    import torch

    from repro_torch.models import LanguageModel, forward
    from repro_torch.models.moe import moe_capacity
    from repro_torch.train import greedy_generate

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device=device, generator=gen)
    sync()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in model.state_dict().values())
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=device, dtype=torch.int32)
    greedy_generate(model, prompt[:, :16], 2)  # warm-up: library handles
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    times = {}
    out, steps_logits = greedy_generate(model, prompt, steps,
                                        all_logits=True, timings=times)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    # an uncached forward over all prompt_len + steps - 1 tokens takes
    # another capacity than the prefill: held by the prefill alone
    prefill_only = cfg.is_moe and any(
        moe_capacity(cfg, n) < n for n in (prompt_len,
                                           prompt_len + steps - 1))
    with torch.inference_mode():
        if prefill_only:
            got = steps_logits[:, 0]
            want = forward(model, {"tokens": prompt}, last_only=True)[0][:, -1]
        else:
            got = steps_logits
            full, _ = forward(model, {"tokens": torch.cat(
                [prompt, out[:, :-1]], dim=1)})
            want = full[:, prompt_len - 1:]
    held = ("prefill logits from the uncached forward over the prompt"
            if prefill_only else "cached logits from the uncached forward")
    dist = rel_l2(got, want)
    finite = bool(torch.isfinite(steps_logits).all()
                  and torch.isfinite(want).all())
    n_dec = steps - 1
    prefill_bound, decode_bound = lm_bounds(cfg, batch, prompt_len, steps)
    of_layers = of_layers or cfg.num_layers
    row = dict(
        arch=cfg.name, layers=cfg.num_layers, of_layers=of_layers,
        d_model=cfg.d_model,
        dtype=cfg.dtype, batch=batch, prompt=prompt_len, steps=steps,
        init_s=init_s, prefill_ms=times["prefill_s"] * 1e3,
        decode_ms_per_step=times["decode_s"] * 1e3 / n_dec,
        tok_per_s=batch * n_dec / times["decode_s"],
        prefill_bound_ms=prefill_bound, decode_bound_ms=decode_bound,
        peak_device_bytes=peak, weight_bytes=weight_bytes,
        param_count_x2=cfg.param_count() * 2, cache_rel_l2=dist, bar=bar,
        held=held, first_row=out[0, :8].tolist())
    if cfg.is_moe:
        row.update(capacity_factor=cfg.capacity_factor,
                   capacity_prefill=moe_capacity(cfg, prompt_len),
                   moe_impl=cfg.moe_impl)
    print(f"[chip_smoke] lm {cfg.name} (layers {cfg.num_layers} of "
          f"{of_layers}, d_model {cfg.d_model}, {cfg.dtype}) on {smi}: "
          f"batch {batch}, prompt "
          f"{prompt_len}: prefill {row['prefill_ms']:.3f} ms (bound "
          f"{prefill_bound:.3f}); decode {row['decode_ms_per_step']:.3f} ms "
          f"a step over {n_dec} steps (bound {decode_bound:.3f}; "
          f"{row['tok_per_s']:,.1f} tok/s); peak device bytes {peak:,}; "
          f"weight bytes {weight_bytes:,} (param_count() x 2 = "
          f"{row['param_count_x2']:,}); init {init_s:.2f} s; {held} "
          f"{dist:.3e} (relative L2, bar {bar:g})"
          + (f"; capacity {row['capacity_prefill']} a prefill expert "
             f"(capacity_factor {cfg.capacity_factor:g}, {cfg.moe_impl})"
             if cfg.is_moe else "")
          + f"; first row {row['first_row']}"
          if cuda else f"[chip_smoke] lm {cfg.name}: {row}", flush=True)
    if not finite or out.shape != (batch, steps):
        raise SystemExit(f"lm {cfg.name}: generated {tuple(out.shape)}, "
                         f"finite logits: {finite}")
    if not dist <= bar:
        raise SystemExit(f"lm {cfg.name}: {held} {dist:.3e} (bar {bar:g})")
    return row


def lm_sort_check(device, path=LM_GOLDEN, arch=LM_SORT_ARCH,
                  tol=LM_SORT_TOL):
    """``arch``'s smoke config with ``moe_impl="sort"`` at f32 on the
    golden file's prompt and the seeded numpy weights: forward and greedy
    logits on ``device`` within ``tol`` (max relative) of the port's on the
    CPU, the greedy tokens equal. Returns the worst distance."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import random_lm_state
    from repro_torch.models import LanguageModel, forward
    from repro_torch.train import greedy_generate

    cfg = dataclasses.replace(get_smoke_config(arch), moe_impl="sort")
    state = {k: torch.from_numpy(v) for k, v in random_lm_state(cfg).items()}
    with np.load(path) as f:
        prompt = torch.from_numpy(f[f"{arch}/prompt"])
    outs = {}
    for dev in (device, torch.device("cpu")):
        model = LanguageModel(cfg, device=dev)
        model.load_state_dict(state)
        with torch.inference_mode():
            logits = forward(model, {"tokens": prompt.to(dev)})[0]
        toks, steps = greedy_generate(model, prompt, 4, all_logits=True)
        outs[dev.type] = (logits.cpu(), steps.cpu(), toks.cpu())
    got, want = outs[device.type], outs["cpu"]
    worst = max(compare(got[i].double(), want[i].double())[1]
                for i in (0, 1))
    same = torch.equal(got[2], want[2])
    print(f"[chip_smoke] lm sort dispatch {cfg.name} on {device.type} "
          f"against the CPU: forward and greedy logits {worst:.3e} (max "
          f"relative, bar {tol:g}); greedy tokens equal: {same}",
          flush=True)
    if not (worst <= tol and same):
        raise SystemExit(f"lm sort dispatch {cfg.name}: the card is not the "
                         "CPU's")
    return worst


def lm_golden(device, path=LM_GOLDEN, tol=LM_GOLDEN_TOL):
    """Every smoke config of the golden file at f32 on ``device``, on the
    seeded numpy weights the reference ran (``random_lm_state``): forward,
    prefill and decode logits within ``tol`` (max relative) of the
    reference's, the greedy tokens equal. Returns {arch: worst}."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import random_lm_state
    from repro_torch.models import LanguageModel, forward
    from repro_torch.models.layers import DTYPES
    from repro_torch.train import greedy_generate

    with np.load(path) as f:
        gold = {k: f[k] for k in f.files}
    archs = sorted({k.split("/")[0] for k in gold})
    worst = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        model = LanguageModel(cfg, device=device)
        dtype = DTYPES[cfg.param_dtype]
        model.load_state_dict({k: torch.from_numpy(v).to(dtype) for k, v in
                               random_lm_state(cfg).items()})
        prompt = torch.from_numpy(gold[f"{arch}/prompt"]).to(device)
        errs = {}

        def check(name, got):
            want = torch.from_numpy(gold[f"{arch}/{name}"]).to(device)
            errs[name] = compare(got.float(), want)[1]

        with torch.inference_mode():
            check("forward", forward(model, {"tokens": prompt})[0])
        if f"{arch}/decode" in gold:
            n = gold[f"{arch}/decode"].shape[1]
            toks, logits = greedy_generate(model, prompt, n + 1,
                                           all_logits=True)
            check("prefill", logits[:, 0])
            check("decode", logits[:, 1:])
            same = np.array_equal(toks.cpu().numpy(), gold[f"{arch}/tokens"])
        else:
            same = True
        worst[arch] = max(errs.values())
        print(f"[chip_smoke] lm golden {arch}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items())
            + f" (max relative, bar {tol:g}); greedy tokens equal: {same}",
            flush=True)
        if worst[arch] > tol or not same:
            raise SystemExit(f"lm golden {arch}: the port is not the "
                             "reference's on the card")
    return worst


def lm_f32(cfg, steps, prompt_len):
    """(the f32 repeat of ``cfg``, its batch or None): LM_F32_LAYERS
    layers; a MoE config at LM_F32_MOE's depth and batch with
    capacity_factor E / top_k, checked to leave every entry its slot at
    every length the run takes."""
    from repro_torch.models.moe import moe_capacity

    f32 = dict(dtype="float32", param_dtype="float32")
    if not cfg.is_moe:
        return dataclasses.replace(cfg, num_layers=LM_F32_LAYERS, **f32), None
    layers, batch = LM_F32_MOE[cfg.name.removesuffix("-smoke")]
    raised = dataclasses.replace(
        cfg, num_layers=layers, capacity_factor=cfg.num_experts / cfg.top_k,
        **f32)
    short = [n for n in range(1, prompt_len + steps)
             if moe_capacity(raised, n) < n]
    if short:
        raise SystemExit(f"{cfg.name}: capacity_factor "
                         f"{raised.capacity_factor} leaves lengths "
                         f"{short[:5]} short of a slot per token")
    print(f"[chip_smoke] lm {cfg.name} f32 repeat: capacity raised for this "
          f"check only (capacity_factor {cfg.capacity_factor:g} -> "
          f"{raised.capacity_factor:g} = num_experts / top_k: capacity >= S "
          f"at every length, no entry dropped), layers {layers}, batch "
          f"{batch}", flush=True)
    return raised, batch


def lm_phase(device, smi, cpu=False):
    """LM_RUNS at full width on the card (with ``cpu``: their smoke configs
    on the CPU, prompts past the window, a rehearsal), each again at f32
    (``lm_f32``; bar LM_F32_BAR), then the sort-dispatch check and the
    golden file. Fails if the path launched a hand kernel. Returns the
    rows."""
    from repro_torch.configs import get_config, get_smoke_config

    sizes = dict(batch=2, steps=6) if cpu else {}
    steps = sizes.get("steps", LM_STEPS)
    runs = []
    for arch, n, bar, changes in LM_RUNS:
        full = (get_smoke_config if cpu else get_config)(arch)
        runs.append((dataclasses.replace(full, **changes), 24 if cpu else n,
                     bar, full.num_layers, {}))
    for cfg, n, _, of, _ in list(runs):
        f32, batch = lm_f32(cfg, steps, n)
        runs.append((f32, n, LM_F32_BAR, of,
                     {} if batch is None or cpu else dict(batch=batch)))
    reset_counts()
    rows = []
    for cfg, prompt_len, bar, of_layers, kw in runs:
        rows.append(lm_serve(cfg, prompt_len, bar, device, smi,
                             of_layers=of_layers, **sizes, **kw))
        free()
    sort = lm_sort_check(device)
    golden = lm_golden(device)
    launched = {k: v for k, v in launch_counts().items() if v}
    if launched:
        raise SystemExit(f"the LM path launched hand kernels: {launched}")
    summary = dict(runs=rows, sort=sort, golden=golden)
    print(f"[chip_smoke] lm {json.dumps(summary)}", flush=True)
    return rows


# ------------------------------------------------------------ train ----
def train_config(steps, moments, accum_dtype="float32", grad_accum=1,
                 remat=True, lr=TRAIN_LR, grad_transform=None):
    """The launcher's settings: warm-up ``max(steps // 20, 1)``, a cosine
    to ``steps``."""
    from repro_torch.train import OptimizerConfig, TrainConfig

    return TrainConfig(
        optimizer=OptimizerConfig(learning_rate=lr,
                                  warmup_steps=max(steps // 20, 1),
                                  total_steps=steps, moment_dtype=moments),
        remat=remat, grad_accum=grad_accum, accum_dtype=accum_dtype,
        grad_transform=grad_transform)


def to_device(batch, device):
    return {k: v.to(device) for k, v in batch.items()}


def train_run(cfg, of_layers, seq, batch, grad_accum, moments, steps,
              device, smi):
    """``steps`` steps of ``make_train_step`` on ``cfg`` (bf16, the model's
    own seeded initialization, ``synthetic_batch(seed=17)``), remat on,
    moments and the accumulator at ``moments``. Before the first step,
    ``loss_fn``'s parts on the first microbatch (no grad). Returns the
    run's row; fails on a non-finite loss or gradient norm."""
    import torch

    from repro_torch.data import synthetic_batch
    from repro_torch.models import LanguageModel
    from repro_torch.train import adamw_init, loss_fn, make_train_step

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    tcfg = train_config(steps, moments, moments, grad_accum)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device=device, generator=gen)
    opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batches = [to_device(synthetic_batch(cfg, batch, seq, seed=17, step=i),
                         device) for i in range(steps)]
    with torch.no_grad():
        micro = {k: v[:batch // grad_accum] for k, v in batches[0].items()}
        _, parts = loss_fn(model, micro, tcfg)
        parts = {k: float(v) for k, v in parts.items()}
    step_fn = make_train_step(cfg, tcfg)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    metrics, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        model, opt, m = step_fn(model, opt, batches[i])
        sync()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        print(f"[chip_smoke] train {cfg.name} step {i}: "
              + ", ".join(f"{k} {v:.6g}" for k, v in metrics[-1].items())
              + f"; {times[-1] * 1e3:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    later = times[1:] or times
    step_s = statistics.mean(later)
    from repro_torch.launch.roofline import HW

    width = 2 if moments == "bfloat16" else 4
    counts = lm_counts(cfg, "train", seq, batch, grad_accum, tcfg.remat,
                       moment_bytes=width, accum_bytes=width)
    passes = counts.notes["fwd_passes"]
    f32 = counts.notes["attention"] + counts.notes["rwkv"]
    bound_ms = counts.flops_per_dev / HW["peak_flops"] * 1e3
    f32_ms = passes * f32 / HW["peak_flops_f32"] * 1e3
    active = cfg.active_param_count()
    mfu = counts.model_flops / (step_s * HW["peak_flops"])
    row = dict(arch=cfg.name, layers=cfg.num_layers, of_layers=of_layers,
               d_model=cfg.d_model, seq=seq, batch=batch,
               grad_accum=grad_accum, moments=moments, remat=tcfg.remat,
               steps=steps, params=n_params, active_params=active,
               init_s=init_s, first_step_ms=times[0] * 1e3,
               step_ms=step_s * 1e3, tok_per_s=batch * seq / step_s,
               peak_device_bytes=peak,
               analytic_resident_bytes=int(counts.hbm_resident_per_dev),
               bound_ms=bound_ms,
               f32_products_ms=f32_ms, model_flops_share=mfu,
               first_parts=parts, metrics=metrics)
    print(f"[chip_smoke] train {cfg.name} (layers {cfg.num_layers} of "
          f"{of_layers}, d_model {cfg.d_model}, {cfg.dtype}, {n_params:,} "
          f"parameters) on {smi}: batch {batch} x seq {seq}, grad_accum "
          f"{grad_accum}, {moments} moments and accumulator, remat: first "
          f"step {row['first_step_ms']:.1f} ms, then {row['step_ms']:.1f} ms "
          f"a step ({row['tok_per_s']:,.1f} tok/s); bound {bound_ms:.1f} ms "
          f"({counts.flops_per_dev:.4g} executed FLOPs, {passes:g} forward "
          f"passes, at 989 TFLOP/s bf16), of it attention and WKV "
          f"{f32_ms:.1f} ms at 67 TFLOP/s ({passes:g} x {f32:.4g}); "
          f"model-FLOPs share {mfu:.4f} ({counts.model_flops:.4g} = 6 x "
          f"{active:,} x {batch * seq} tokens); peak device bytes {peak:,} "
          f"(analytic residency {row['analytic_resident_bytes']:,}); init "
          f"{init_s:.2f} s; "
          f"loss_fn parts at the start weights {parts}"
          if cuda else f"[chip_smoke] train {cfg.name}: {row}", flush=True)
    bad = [m for m in metrics if not (math.isfinite(m["loss"])
                                      and math.isfinite(m["grad_norm"]))]
    if bad or not all(math.isfinite(v) for v in parts.values()):
        raise SystemExit(f"train {cfg.name}: non-finite loss or gradient "
                         f"norm {bad or parts}")
    if cfg.is_moe and not parts["moe_aux"] > 0:
        raise SystemExit(f"train {cfg.name}: no router aux loss {parts}")
    return row


def train_golden(device, tol=TRAIN_GOLDEN_TOL):
    """Every entry of the golden training file (the reference's three
    f32 steps of each smoke config on the CPU) through the port on
    ``device``: losses, gradient norms and final parameters within ``tol``
    (max relative). Returns {entry: worst}."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_train_golden as golden

    worst = {}
    for name, errs in golden.distances(device).items():
        worst[name] = max(errs.values())
        print(f"[chip_smoke] train golden {name}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items())
            + f" (max relative, bar {tol:g})", flush=True)
    bad = {k: v for k, v in worst.items() if v > tol}
    if bad:
        raise SystemExit(f"train golden {bad}: the port is not the "
                         "reference's on the card")
    return worst


def train_checks(device, cfg, batch, seq, bf16_bar=TRAIN_BF16_BAR):
    """At f32 (TF32 off) on ``cfg``'s model from its seeded init and one
    batch, lr TRAIN_CHECK_LR: a step with grad_accum 2 against grad_accum
    1 (the gradients caught by ``grad_transform`` within TRAIN_GRADS_TOL,
    their norm and the updated parameters within TRAIN_ACCUM_TOL), remat
    against none
    (TRAIN_REMAT_TOL), then the same weights rounded to bf16: the first
    loss within ``bf16_bar`` (relative) of the f32 one (None: printed,
    not held). Returns the distances."""
    import torch

    from repro_torch.data import synthetic_batch
    from repro_torch.models import LanguageModel
    from repro_torch.train import adamw_init, loss_fn, make_train_step

    f32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    data = to_device(synthetic_batch(f32, batch, seq, seed=17), device)

    def run(accum, remat):
        caught = {}

        def catch(grads):
            caught.update({n: g.detach().clone() for n, g in grads.items()})
            return grads

        tcfg = train_config(1, "float32", grad_accum=accum, remat=remat,
                            lr=TRAIN_CHECK_LR, grad_transform=catch)
        gen = torch.Generator(device=device).manual_seed(0)
        model = LanguageModel(f32, device=device, generator=gen)
        opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
        model, _, m = make_train_step(f32, tcfg)(model, opt, data)
        params = {n: p.detach() for n, p in model.named_parameters()}
        return dict(grads=caught, params=params, loss=float(m["loss"]),
                    grad_norm=float(m["grad_norm"]))

    def dist(a, b):
        """Held: the gradients' relative L2, their norm, the parameters'
        max relative (each the worst tensor); printed: the gradients' max
        relative and the worst tensors."""
        held, seen = {}, {}
        for key, how in (("grads", "l2"), ("params", "max")):
            worst = (0.0, "")
            for n in b[key]:
                got, want = a[key][n].double(), b[key][n].double()
                d = (rel_l2(got, want) if how == "l2"
                     else compare(got, want)[1])
                worst = max(worst, (d, n))
            held[key], seen[key] = worst
        seen["grads_max"] = max(compare(a["grads"][n].double(),
                                        b["grads"][n].double())[1]
                                for n in b["grads"])
        held["grad_norm"] = abs(a["grad_norm"] - b["grad_norm"]) / abs(
            b["grad_norm"])
        held["loss"] = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        return held, seen

    base = run(1, False)
    accum, accum_seen = dist(run(2, False), base)
    free()
    remat, remat_seen = dist(run(1, True), base)
    free()
    # the bf16 model draws the f32 model's numbers and rounds them
    losses = {}
    for dt in ("float32", "bfloat16"):
        gen = torch.Generator(device=device).manual_seed(0)
        model = LanguageModel(dataclasses.replace(cfg, dtype=dt,
                                                  param_dtype=dt),
                              device=device, generator=gen)
        with torch.no_grad():
            losses[dt] = float(loss_fn(model, data,
                                       train_config(1, "float32"))[0])
        del model
    loss16, loss32 = losses["bfloat16"], losses["float32"]
    bf16_dist = abs(loss16 - loss32) / abs(loss32)
    out = dict(accum=accum, accum_seen=accum_seen, remat=remat,
               remat_seen=remat_seen, bf16_loss=loss16, f32_loss=loss32,
               bf16_rel=bf16_dist, lr=TRAIN_CHECK_LR)
    print(f"[chip_smoke] train checks {cfg.name} (layers {cfg.num_layers}, "
          f"f32, TF32 off, batch {batch} x seq {seq}, lr "
          f"{TRAIN_CHECK_LR:g}): grad_accum 2 against 1 {accum} (bars "
          f"{TRAIN_GRADS_TOL:g} gradients, {TRAIN_ACCUM_TOL:g} the rest; "
          f"worst tensors and the gradients' max relative {accum_seen}); "
          f"remat against none {remat} (bar "
          f"{TRAIN_REMAT_TOL:g}; {remat_seen}); bf16 first loss {loss16:.6g} "
          f"against f32 {loss32:.6g}: {bf16_dist:.3e} relative (bar "
          f"{bf16_bar})", flush=True)
    if (accum["grads"] > TRAIN_GRADS_TOL
            or max(accum[k] for k in ("params", "grad_norm", "loss"))
            > TRAIN_ACCUM_TOL):
        raise SystemExit(f"train: grad_accum 2 is not grad_accum 1 {accum}")
    if max(remat.values()) > TRAIN_REMAT_TOL:
        raise SystemExit(f"train: remat is not the plain step {remat}")
    if bf16_bar is not None and not bf16_dist <= bf16_bar:
        raise SystemExit(f"train: the bf16 loss is {bf16_dist:.3e} from "
                         "the f32 one")
    return out


def train_phase(device, smi, cpu=False):
    """TRAIN_RUNS at full width and cut depths on the card (with ``cpu``:
    their smoke configs on the CPU, a rehearsal), the internal checks
    (TRAIN_CHECK), then the golden file. Fails if the path launched a hand
    kernel. Returns the rows."""
    from repro_torch.configs import get_config, get_smoke_config

    reset_counts()
    rows = []
    for arch, layers, seq, batch, accum, moments, steps in TRAIN_RUNS:
        full = (get_smoke_config if cpu else get_config)(arch)
        cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
        if cpu:
            seq, batch = 16, 2 * accum if accum > 1 else 2
        rows.append(train_run(cfg, full.num_layers, seq, batch, accum,
                              moments, steps, device, smi))
        free()
    arch, layers, batch, seq = TRAIN_CHECK
    full = (get_smoke_config if cpu else get_config)(arch)
    # the card's bf16 bar is the card's measurement's
    checks = train_checks(device, dataclasses.replace(full, num_layers=layers),
                          batch, 16 if cpu else seq,
                          None if cpu else TRAIN_BF16_BAR)
    free()
    golden = train_golden(device)
    launched = {k: v for k, v in launch_counts().items() if v}
    if launched:
        raise SystemExit(f"the training path launched hand kernels: "
                         f"{launched}")
    summary = dict(runs=[{k: v for k, v in r.items() if k != "metrics"}
                         for r in rows], checks=checks, golden=golden)
    print(f"[chip_smoke] train {json.dumps(summary)}", flush=True)
    return rows


# ------------------------------------------------------------ placed ----
def placed_phase(device, smi, cpu=False):
    """PLACED_RUNS on two gloo ranks sharing the card (with ``cpu``: the
    smoke config at seq 16 on CPU ranks, a rehearsal): each rank's placed
    steps held to one process's, and its recorded collectives to
    ``lm_collectives``; a run on a (1, model) mesh records no all-gather.
    Then, in the same group, PLACED_SERVE's serving runs and
    PLACED_FORWARD's forwards, each held to one process's. Returns the
    ranks' rows, a list a run."""
    import numpy as np

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.distributed.sharding import (placed_forward,
                                                  placed_serve,
                                                  placed_train_step)
    from repro_torch.launch.analytic import lm_collectives
    from repro_torch.launch.mesh import MeshShape, run_each, spawn_ranks
    from repro_torch.launch.shapes import ShapeCase

    runs, calls = [], []
    for arch, layers, mesh, batch, seq, steps in PLACED_RUNS:
        full = (get_smoke_config if cpu else get_config)(arch)
        cfg = dataclasses.replace(full, num_layers=layers, dtype="float32",
                                  param_dtype="float32")
        seq = 16 - seq % 2 if cpu else seq
        tcfg = train_config(steps, "float32", remat=True, lr=TRAIN_CHECK_LR)
        batches = [synthetic_batch(cfg, batch, seq, seed=17, step=i)
                   for i in range(steps)]
        want = lm_collectives(cfg, ShapeCase("placed", seq, batch, "train"),
                              MeshShape({"data": mesh[0], "model": mesh[1]}),
                              tcfg)
        held, used, total = placed_parameters(cfg, mesh)
        print(f"[chip_smoke] placed {cfg.name} on {mesh}: "
              f"{held:,} of {total:,} parameters a rank, computing with "
              f"{used:,}", flush=True)
        runs.append((cfg, full, mesh, batch, seq, want))
        calls.append((placed_train_step, (cfg, mesh, batches, tcfg)))
    world = {m[0] * m[1] for _, _, m, *_ in PLACED_RUNS}
    assert len(world) == 1, "the placed runs share one group of ranks"
    serving = placed_serving_runs(device, smi, cpu)
    calls += [(placed_serve, (cfg, (1, 2), tokens))
              for cfg, tokens, *_ in serving]
    forwards = placed_forward_runs(device, cpu)
    calls += [(placed_forward, (get_smoke_config(arch), (1, 2), tokens))
              for arch, tokens, _ in forwards]
    t0 = time.perf_counter()
    ranks = spawn_ranks(run_each, world.pop(),
                        backend="gloo", device="cpu" if cpu else "cuda",
                        args=(calls,), timeout=300)
    wall = time.perf_counter() - t0
    bad = []
    for j, (cfg, full, mesh, batch, seq, want) in enumerate(runs):
        whole, lru, whole_bytes = model_axis_gathers(cfg, mesh[1])
        before = (PLACED_BEFORE_SP.get((full.name, mesh), (None, None))
                  if seq % 2 == 0 else ("not measured",) * 2)
        bar = PLACED_PARAM_TOL.get(full.name.removesuffix("-smoke"),
                                   PLACED_TOL)
        for i, r in enumerate(rk[j] for rk in ranks):
            d = r["distances"]
            print(f"[chip_smoke] placed {cfg.name} (layers {cfg.num_layers} "
                  f"of {full.num_layers}, d_model {cfg.d_model}, f32, remat) "
                  f"rank {i} {r['coords']} of mesh (data, model) {mesh} on "
                  f"{'cpu' if cpu else smi}: global batch {batch} x seq "
                  f"{seq}; set-up {r['setup_s']:.3f} s, one process "
                  f"{r['reference_s']:.3f} s, gradient checks "
                  f"{r['check_s']:.3f} s; step ms "
                  f"{[round(t * 1e3, 3) for t in r['step_s']]}; peak device "
                  f"bytes a step {r['peak_device_bytes']}; against one "
                  f"process (bars {PLACED_TOL:g}, parameters {bar:g}, "
                  f"gradients {PLACED_GRAD_TOL:g}): {d}; losses "
                  f"{[m['loss'] for m in r['metrics']]}, gradient norms "
                  f"{[m['grad_norm'] for m in r['metrics']]}", flush=True)
            rs = (want.count_by_op.get("reduce-scatter", 0),
                  want.bytes_by_op.get("reduce-scatter", 0))
            peak = max(p or 0 for p in r["peak_device_bytes"])
            print(f"[chip_smoke] placed {cfg.name} on {mesh} rank {i}: "
                  f"reduce-scatters a step {rs[0]} ({rs[1]:,} B) of "
                  f"{want.total_bytes:,} B collectives (lm_collectives; "
                  f"before sequence parallelism {before[0]} B); peak "
                  f"device bytes {peak:,} (before {before[1]}; held on "
                  f"entry {r['held_on_entry']}); layer inputs "
                  f"{r['block_inputs'][0]}", flush=True)
            for step, got in enumerate(r["collectives"]):
                print(f"[chip_smoke] placed {mesh} rank {i} step {step} "
                      f"collectives recorded {got} / lm_collectives {want}",
                      flush=True)
                if got != want:
                    bad.append(f"{mesh} rank {i} step {step}: collectives "
                               f"{got} are not the schedule {want}")
                # (1, model), sequence-parallel: no split weight and no
                # logits are gathered; in each pass (remat: two) the
                # weights computed whole and each split RG-LRU's conv
                # output; the rest (rows, S, d) along the sequence
                hidden = batch // mesh[0] * seq * cfg.d_model * 4
                lru_b = batch // mesh[0] * seq * cfg.lru_width * 4
                n_seq = got.count_by_op.get("all-gather", 0) - 2 * (
                    len(whole) + lru)
                if mesh[0] == 1 and (n_seq < 0 or got.bytes_by_op.get(
                        "all-gather", 0) != n_seq * hidden + 2 * (
                        whole_bytes + lru * lru_b)):
                    bad.append(f"{mesh} rank {i} step {step}: a "
                               f"tensor-parallel step gathered {got}: "
                               f"want the sequence's, {lru} RG-LRU "
                               f"outputs and {whole} a pass")
            want_in = (batch // mesh[0],
                       seq if seq % mesh[1] else seq // mesh[1], cfg.d_model)
            if r["block_inputs"] != [want_in] * cfg.num_layers:
                bad.append(f"{mesh} rank {i}: layer inputs "
                           f"{r['block_inputs']}, want {want_in}")
            if (d["metrics"][0] > PLACED_TOL or d["params"][0] > bar
                    or d["grads"][0] > PLACED_GRAD_TOL):
                bad.append(f"{mesh} rank {i}: {d}")
    j = len(runs)
    bad += check_placed_serving(serving, [rk[j:j + len(serving)]
                                          for rk in ranks], smi, cpu)
    j += len(serving)
    for k, (arch, _, want) in enumerate(forwards):
        for i, rk in enumerate(ranks):
            got = rk[j + k]["logits"]
            err = float(np.abs(got - want).max() / np.abs(want).max())
            print(f"[chip_smoke] placed forward {arch} smoke f32 rank {i} "
                  f"on (1, 2): max relative distance from one process "
                  f"{err:.3e} (bar {PLACED_FORWARD_TOL:g})", flush=True)
            if not err <= PLACED_FORWARD_TOL:
                bad.append(f"forward {arch} rank {i}: {err:.3e}")
    print(f"[chip_smoke] placed: {len(ranks)} ranks, {len(runs)} runs, "
          f"{len(serving)} serving runs and {len(forwards)} forwards in "
          f"{wall:.1f}s (spawn, every run, the checks)", flush=True)
    if bad:
        raise SystemExit(f"placed: {bad}")
    return [[rk[j] for rk in ranks] for j in range(len(runs))]


def model_axis_gathers(cfg, tp):
    """What one forward of ``cfg`` placed on (1, ``tp``) all-gathers along
    'model' besides the residual stream and a split head's logits: the
    weights the split plan computes whole although their specs cut them
    there (names), the number of split RG-LRU layers (each gathers its
    conv output) and those weights' bytes."""
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.distributed.tensor_parallel import split_plan
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import LanguageModel

    meta = dict(LanguageModel(cfg, device="meta").named_parameters())
    specs = param_shardings(MeshShape({"data": 1, "model": tp}), meta)
    plan = split_plan(cfg, tp)
    whole = [n for n, spec in specs.items()
             if "model" in spec and plan.mode(n) != "shard"]
    return (whole, len(plan.rglru),
            sum(meta[n].numel() * meta[n].element_size() for n in whole))


def placed_parameters(cfg, mesh):
    """``(held, used, total)``: the parameters one rank of ``cfg`` placed
    on the (data, model) ``mesh`` holds (its shards), those it computes
    with (its 'model' shard of a split part's weights, its channels or KV
    head of a narrowed one, every other tensor whole) and the model's."""
    from repro_torch.distributed.sharding import local_shape, param_shardings
    from repro_torch.distributed.tensor_parallel import split_plan
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import LanguageModel

    shape = MeshShape({"data": mesh[0], "model": mesh[1]})
    meta = dict(LanguageModel(cfg, device="meta").named_parameters())
    specs = param_shardings(shape, meta)
    plan = split_plan(cfg, mesh[1])
    held = used = 0
    for n, p in meta.items():
        held += math.prod(local_shape(shape, specs[n], tuple(p.shape)))
        mode = plan.mode(n)
        if mode == "shard":
            model_only = tuple(a if a == "model" else None
                               for a in specs[n])
            used += math.prod(local_shape(shape, model_only,
                                          tuple(p.shape)))
        elif mode == "channels":
            used += p.numel() // mesh[1]
        elif mode == "head":
            used += p.numel() // p.shape[-1] * cfg.head_dim
        else:
            used += p.numel()
    return held, used, sum(p.numel() for p in meta.values())


def serve_one_process(cfg, tokens, device):
    """One process's prefill of ``tokens`` and one greedy decode step on
    ``device``, from the model's own seeded initialization (the weights
    each rank of ``placed_serve`` builds): both steps' logits (numpy,
    f32) and host ms."""
    import torch

    from repro_torch.models import LanguageModel, init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    model = LanguageModel(cfg, device=device)
    B, S = tokens.shape
    cache = init_cache(cfg, B, S + 1, device)
    out = {}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    sync()
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(model)(
        {"tokens": torch.as_tensor(tokens, device=device)}, cache)
    sync()
    t1 = time.perf_counter()
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    step, cache = make_decode_step(model)(tok, cache, S)
    sync()
    out["ms"] = {"prefill": (t1 - t0) * 1e3,
                 "decode": (time.perf_counter() - t1) * 1e3}
    out["prefill"] = logits.float().cpu().numpy()
    out["decode"] = step.float().cpu().numpy()
    del model, cache, logits, step
    free()
    return out


def placed_serving_runs(device, smi, cpu):
    """PLACED_SERVE's runs, each with one process's logits, computed before
    the ranks start (their models then free the card): ``(cfg, tokens,
    one process, bar, full depth)`` a run (with ``cpu``: the smoke configs
    at seq 16)."""
    import numpy as np

    from repro_torch.configs import get_config, get_smoke_config

    out = []
    for arch, layers, batch, seq, bar in PLACED_SERVE:
        full = (get_smoke_config if cpu else get_config)(arch)
        cfg = full if cpu else dataclasses.replace(full, num_layers=layers)
        seq = 16 if cpu else seq
        tokens = np.random.default_rng(5).integers(
            0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        t0 = time.perf_counter()
        one = serve_one_process(cfg, tokens, device)
        print(f"[chip_smoke] placed serving {cfg.name} ({cfg.num_layers} of "
              f"{full.num_layers} layers, {cfg.dtype}): one process on "
              f"{'cpu' if cpu else smi}: prefill {one['ms']['prefill']:.3f} "
              f"ms, decode step {one['ms']['decode']:.3f} ms (host clock, "
              f"first call), {time.perf_counter() - t0:.1f} s with the "
              f"model's set-up", flush=True)
        out.append((cfg, tokens, one, bar, full.num_layers))
    return out


def placed_forward_runs(device, cpu):
    """PLACED_FORWARD's smoke models: ``(arch, tokens, one process's
    logits)`` each, the forward of tests/test_torch_lm_distributed.py's
    ``cuda`` case."""
    import numpy as np

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LanguageModel, forward

    out = []
    for arch in PLACED_FORWARD:
        cfg = get_smoke_config(arch)
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 8)).astype(np.int32)
        model = LanguageModel(cfg, device=device)
        with torch.inference_mode():
            want = forward(model, {"tokens": torch.as_tensor(
                tokens, device=device)})[0].float().cpu().numpy()
        out.append((arch, tokens, want))
    return out


def check_placed_serving(serving, ranks, smi, cpu):
    """Each placed serving run's ranks against one process: the prefill's
    and the decode step's logits (max relative, over the largest), the
    collectives (``lm_collectives``, exactly) and the all-gathers (the
    split head's logits, each split RG-LRU's conv output and the weights
    the plan computes whole that the specs cut along 'model', nothing
    else). Returns the failures."""
    import numpy as np

    from repro_torch.distributed.sharding import (cache_shardings,
                                                  local_shape)
    from repro_torch.distributed.tensor_parallel import (split_plan,
                                                         vocab_splits)
    from repro_torch.launch.analytic import lm_collectives
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.shapes import ShapeCase
    from repro_torch.models import init_cache

    mesh = MeshShape({"data": 1, "model": 2})
    bad = []
    for k, (cfg, tokens, one, bar, of_layers) in enumerate(serving):
        whole, lru, _ = model_axis_gathers(cfg, 2)
        gathers = len(whole) + lru + (vocab_splits(cfg, 2)
                                      and cfg.has_lm_head)
        plan = split_plan(cfg, 2)
        # decode: each slot group whose ranks hold other query heads
        # gathers its queries, one all-gather an attention layer
        queries = len(plan.slots) if plan.attention or plan.mla else 0
        before = PLACED_SERVE_BEFORE_SP.get(cfg.name, (None, None))
        held, used, total = placed_parameters(cfg, (1, 2))
        print(f"[chip_smoke] placed serving {cfg.name} on (1, 2): "
              f"{held:,} of {total:,} parameters a rank, computing with "
              f"{used:,}", flush=True)
        B, S = tokens.shape
        for i, rk in enumerate(ranks):
            r = rk[k]
            # the whole cache, and the reference's share of its K / V
            # (or ckv / krope) a rank, which the dry-run prices
            cache = init_cache(cfg, B, r["cache_len"], "meta")
            specs = cache_shardings(mesh, cache)
            cache_bytes = share = held = 0
            for li, kind in enumerate(cfg.layer_kinds):
                for leaf, x in cache[li].items() if kind == "attn" else ():
                    cache_bytes += x.numel() * x.element_size()
                    if leaf != "pos":
                        share += math.prod(local_shape(
                            mesh, specs[li][leaf], tuple(x.shape))) \
                            * x.element_size()
                        held += math.prod(r["cache_shapes"][li][leaf]) \
                            * x.element_size()
            print(f"[chip_smoke] placed serving {cfg.name} rank {i}: "
                  f"attention cache of {r['cache_len']} slots "
                  f"{r['attention_cache_bytes']:,} B a rank (positions "
                  f"included; K / V or ckv / krope {held:,} B, the "
                  f"reference's share {share:,} B), the whole cache "
                  f"{cache_bytes:,} B (slot groups of {plan.slot_group}: "
                  f"{len(plan.slots)} layers); peak device bytes prefill "
                  f"{r['peak_device_bytes']['prefill']}, decode "
                  f"{r['peak_device_bytes']['decode']} (before sequence "
                  f"parallelism {before[0]}, {before[1]}; held on entry "
                  f"{r['held_on_entry']})", flush=True)
            if held != share:
                bad.append(f"serving {cfg.name} rank {i}: attention cache "
                           f"{held} B a rank, not the reference's share "
                           f"{share}")
            for key in ("prefill", "decode"):
                # a sequence-parallel prefill also gathers each layer's
                # two part inputs and each rank's last position
                sp = key == "prefill" and S % 2 == 0
                n = gathers + sp * (2 * cfg.num_layers + 1) + (
                    key == "decode") * queries
                want = lm_collectives(cfg, ShapeCase(
                    key, S if key == "prefill" else r["cache_len"], B, key),
                    mesh)
                got = r["collectives"][key]
                err = float(np.abs(r[key] - one[key]).max()
                            / np.abs(one[key]).max())
                print(f"[chip_smoke] placed serving {cfg.name} "
                      f"({cfg.num_layers} of {of_layers} layers, "
                      f"{cfg.dtype}, batch {B} x prompt {S}) rank {i} of "
                      f"(1, 2) on {'cpu' if cpu else smi}: {key} "
                      f"{r['step_s'][key] * 1e3:.3f} ms (host clock, first "
                      f"call), peak device bytes "
                      f"{r['peak_device_bytes'][key]}; max relative distance "
                      f"from one process {err:.3e} (bar {bar:g}); "
                      f"collectives recorded {got} / lm_collectives {want}",
                      flush=True)
                if not err <= bar:
                    bad.append(f"serving {cfg.name} rank {i} {key}: "
                               f"{err:.3e} > {bar:g}")
                if got != want:
                    bad.append(f"serving {cfg.name} rank {i} {key}: "
                               f"collectives {got} are not {want}")
                if got.count_by_op.get("all-gather", 0) != n:
                    bad.append(f"serving {cfg.name} rank {i} {key}: "
                               f"{got.count_by_op} gathers, want {n}: "
                               f"the logits, {lru} RG-LRU outputs, "
                               f"{whole}, the sequence's and the slot "
                               f"groups' queries")
        print(f"[chip_smoke] placed serving {cfg.name}: weights gathered "
              f"along 'model' (computed whole): {whole}", flush=True)
    return bad


# ------------------------------------------------------------ dryrun ----
def dryrun_phase(device, smi, cpu=False):
    """The dry-run on the reference's two meshes (its census; the full-size
    FETI rows against tests/data/torch_dryrun_golden.json), then DRYRUN_RUNS at --devices 1
    --run on the card (with ``cpu``: the smoke configs on the CPU, the LM
    cells' shapes cut to 64 positions and batch 2, no launches expected; a
    rehearsal). Returns the run rows."""
    import tempfile
    from unittest import mock

    from repro_torch.launch import dryrun, finalize, report
    from repro_torch.launch.roofline import HW

    with tempfile.TemporaryDirectory(prefix="repro_torch_dryrun-") as tmp:
        path = os.path.join(tmp, "dryrun.jsonl")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = dryrun.main(["--arch", "all", "--shape", "all", "--mesh",
                              "both", "--out", path])
        recs = report.load(path)
    status = {}
    for r in recs:
        status[r["status"]] = status.get(r["status"], 0) + 1
    print(f"[chip_smoke] dryrun census (16x16, 2x16x16): {status}; "
          f"{out.getvalue().strip().splitlines()[-1]}", flush=True)
    if rc != 0 or set(status) - {"ok", "skipped"}:
        raise SystemExit(f"dryrun: cells in error: {status}")
    ok = [r for r in recs if r["status"] == "ok"]
    bare = [f"{r['arch']}/{r['shape']}/{r['mesh']}" for r in ok
            if r["collectives"] is None
            or not math.isfinite(r["roofline"]["collective_s"])]
    for mesh in dryrun.MESHES:
        rows = [r for r in ok if r["mesh"] == mesh]
        dom = sorted(finalize.fraction(r) for r in rows
                     if r["roofline"]["dominant"] == "collective")
        ds = {r["shape"]: r["collectives"]["bytes"].get("all-gather", 0)
              for r in rows if r["arch"] == "deepseek-v2-236b"}
        print(f"[chip_smoke] dryrun {mesh} collectives (the port's "
              f"schedule, at {HW['net_bw']:g} B/s): "
              f"{sum(r['roofline']['coll_bytes_per_dev'] for r in rows):.6g} "
              f"B a device over {len(rows)} cells; collective-dominant "
              f"{len(dom)} of them, finalize.fraction {dom[0] if dom else 0:.4g}"
              f"-{dom[-1] if dom else 0:.4g} (median "
              f"{statistics.median(dom) if dom else 0:.4g}), of all cells "
              f"median {statistics.median(map(finalize.fraction, rows)):.4g}"
              f"; deepseek-v2-236b all-gather bytes a rank by shape {ds}"
              f" (decode_32k {ds.get('decode_32k', 0):,} B; with its MLA "
              f"heads and experts gathered whole "
              f"{DRYRUN_DEEPSEEK_DECODE_WHOLE.get(mesh, 0):,})", flush=True)
        for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
            old = DRYRUN_BEFORE_SP.get(mesh, {}).get(r["arch"])
            if old and r["shape"] in ("train_4k", "prefill_32k"):
                print(f"[chip_smoke] dryrun {mesh} {r['arch']} {r['shape']} "
                      f"collective bytes a rank "
                      f"{sum(r['collectives']['bytes'].values()):,} "
                      f"{r['collectives']['bytes']} (before sequence "
                      f"parallelism {old[r['shape'] == 'prefill_32k']:,})",
                      flush=True)
        for arch, old in DRYRUN_RECURRENT_DECODE_WHOLE.items():
            got = [r["collectives"]["bytes"].get("all-gather", 0)
                   for r in rows
                   if r["arch"] == arch and r["shape"] == "decode_32k"]
            print(f"[chip_smoke] dryrun {mesh} {arch} decode_32k all-gather "
                  f"bytes a rank {got[0] if got else None:,} (with its "
                  f"recurrent blocks gathered whole {old[mesh]:,})",
                  flush=True)
    if bare:
        raise SystemExit(f"dryrun: rows without collectives: {bare}")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_dryrun_golden

    golden = torch_dryrun_golden.load()
    off, held = [], 0
    for r in recs:
        key = f"{r['arch']}/{r['shape']}/{r.get('mesh')}"
        if key in golden:
            held += 1
            if torch_dryrun_golden.mismatches(r, golden[key]):
                off.append(key)
    print(f"[chip_smoke] dryrun FETI rows against the reference's "
          f"feti_cell_counts: {held} of {len(golden)} held, exactly equal: "
          f"{held - len(off)}", flush=True)
    if off or held != len(golden):
        raise SystemExit(f"dryrun: FETI rows off the golden file: {off}")

    cut = {}
    if cpu:
        cut = {name: dataclasses.replace(dryrun.SHAPES[name], seq_len=64,
                                         global_batch=2)
               for _, name in DRYRUN_RUNS if name in dryrun.SHAPES}
    rows = []
    for arch, shape in DRYRUN_RUNS:
        free()
        with mock.patch.dict(dryrun.SHAPES, cut):
            rec = dryrun.run_cell(arch, shape, dryrun.DEVICE_MESH, run=True,
                                  device=device, smoke=cpu)
        rows.append(rec)
        if rec["status"] != "ok":
            print(rec.get("traceback", ""), flush=True)
            raise SystemExit(f"dryrun {arch} x {shape}: {rec['status']}: "
                             f"{rec.get('error')}")
        rec.pop("traceback", None)
        peak = rec["peak_device_bytes"]
        frac = finalize.fraction(rec)
        meas = finalize.measured_fraction(rec)
        print(f"[chip_smoke] dryrun {arch} x {shape} on {smi}: global batch "
              f"{rec.get('global_batch', '-')}, layers "
              f"{rec.get('num_layers', '-')}, reduced {rec['reduced']}; "
              f"measured_s {rec['measured_s']:.6f} (first step "
              f"{rec['first_step_s']:.6f}, median of {rec['steps']} after "
              f"it); peak device bytes {peak} against the analytic "
              f"residency {rec['analytic_resident_bytes_per_dev']:,} "
              f"(fit budget {rec['fit_budget_bytes']:,}); "
              f"finalize.fraction {frac:.4f}, floor {finalize.floor_s(rec):.6g}"
              f" s / measured_s {meas:.6f}; {rec['note']}", flush=True)
        launches = rec.get("launches_per_step")
        if launches is not None:
            want = {} if cpu else DRYRUN_LAUNCHES[arch]
            print(f"[chip_smoke] dryrun {arch} x {shape} launches a step: "
                  f"{launches}", flush=True)
            if any(step != want for step in launches):
                raise SystemExit(f"dryrun {arch} x {shape}: launches "
                                 f"{launches}, want {want} every step")
        if peak is not None and not peak < HW["hbm_bytes"]:
            raise SystemExit(f"dryrun {arch} x {shape}: peak {peak} B")
    print(report.dryrun_table(rows), flush=True)
    free()
    return rows


def free():
    """Return the freed device memory to the card and restart its peak."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def register_heat3d_cut():
    """Register feti-heat-3d at the validated depth HEAT3D_SUB_GRID as the
    architecture HEAT3D_CUT (the width and every other field unchanged)."""
    from repro_torch.configs import get_config, register

    cut = dataclasses.replace(get_config("feti-heat-3d"), name=HEAT3D_CUT,
                              sub_grid=HEAT3D_SUB_GRID)
    register(HEAT3D_CUT, lambda: cut, lambda: cut)


def main() -> int:
    t_all = time.perf_counter()
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import torch

    t0 = phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}")
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    # the main phase's slowest oracle, solved on the host meanwhile
    oracle = start_oracle(src)
    done("device", t0)

    t0 = phase("build")
    from repro_torch.kernels import build

    secs = build.build(build.KERNELS)
    for name in build.KERNELS:
        log = build._library_path(name).with_suffix(".log")
        if log.exists():
            print(f"[chip_smoke] nvcc {name}:\n{log.read_text().strip()}")
    print(f"[chip_smoke] built {sorted(secs)} in "
          f"{max(secs.values(), default=0.0):.1f}s", flush=True)
    ptxas = ptxas_report(build, secs)
    ptxas_small = ptxas_report(build, secs, SMALL_INSTANCES)
    ptxas_wide = ptxas_report(build, secs, WIDE_INSTANCES)
    for name, r in [*ptxas.items(),
                    *((f"{k} (bs <= 16)", v) for k, v in ptxas_small.items()),
                    *((f"{k} (bs > 128: two passes)", v)
                      for k, v in ptxas_wide.items())]:
        print(f"[chip_smoke] ptxas {name}: {r['registers']} registers, "
              f"{r['spill_stores']} B spill stores, {r['spill_loads']} B "
              f"spill loads, {r['static_smem']} B static shared memory"
              + (" (cached: an earlier build's log)" if r["ptxas_cached"]
                 else ""), flush=True)
    dmma = dmma_counts(build)
    print(f"[chip_smoke] DMMA instructions in the SASS: {dmma}", flush=True)
    if not all(dmma.values()):
        raise SystemExit(f"no DMMA in the SASS of {dmma}")
    hmma, forms = hmma_counts(build)
    print(f"[chip_smoke] TF32 HMMA instructions in the SASS of the f32 "
          f"instances: {hmma} (HMMA forms there: {forms})", flush=True)
    for key in ("stepped_trsm_f32", "stepped_trsm_packed_f32",
                "stepped_syrk_f32", "stepped_trsm_syrk_f32"):
        lib, tag = INSTANCES[key]
        if not any(tag in name for name in hmma
                   if name.startswith(lib + ":")):
            raise SystemExit(f"{key}: no f32 instance {tag} in the SASS")
    if not hmma or not all(hmma.values()):
        raise SystemExit(f"an f32 instance issues no TF32 HMMA: {hmma}")
    for name, r in fused_residency(build, ptxas, ptxas_small).items():
        print(f"[chip_smoke] f32 fused {name}: {r['registers']} registers, "
              f"{r['blocks_per_sm']:g} resident blocks a SM", flush=True)
    done("build", t0)

    # every f32 product, the kernels' plain versions and the library
    # yardsticks included, in full f32 (TF32 keeps a 10-bit mantissa)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[chip_smoke] torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = phase("kernels")
    x = kernel_inputs(device)
    rows = check_kernels(x, KERNEL_NAMES, "f64", "heat-2d dual", ptxas)
    done("kernels f64", t0)
    t1 = time.perf_counter()
    rows += check_kernels(x, F32_NAMES, "f32", "heat-2d dual", ptxas)
    free()
    done("kernels f32", t1)

    t1 = phase("large blocks")
    x256 = reblocked_inputs(x, device, WIDE_BS)
    label = f"heat-2d dual bs={WIDE_BS}"
    # the stepped SYRK has one instance per dtype, for every bm
    ptxas_bs256 = {**ptxas, **ptxas_wide}
    wide = check_kernels(x256, WIDE_NAMES, "f64", label, ptxas_bs256)
    wide += check_kernels(x256, WIDE_NAMES, "f32", label, ptxas_bs256)
    del x256
    free()
    done("large blocks", t1)

    t1 = phase("small blocks")
    x16 = reblocked_inputs(x, device, SMALL_BS)
    del x
    free()
    label = f"heat-2d dual bs={SMALL_BS}"
    small_names = KERNEL_NAMES
    # the stepped SYRK has one instance per dtype, for every bm
    ptxas_bs16 = {**ptxas, **ptxas_small}
    small = check_kernels(x16, small_names, "f64", label, ptxas_bs16,
                          plain_reps=2)
    small += check_kernels(x16, small_names, "f32", label, ptxas_bs16,
                           plain_reps=2)
    del x16
    free()
    done("small blocks", t1)
    done("kernels", t0)

    t0 = phase("dirichlet")
    x = dirichlet_inputs(device)
    d_rows = check_kernels(x, KERNEL_NAMES, "f64", "heat-3d dirichlet")
    check_dirichlet_sb(x)
    d_rows += check_kernels(x, F32_NAMES, "f32", "heat-3d dirichlet")
    print(f"[chip_smoke] dirichlet phase peak device bytes "
          f"{torch.cuda.max_memory_allocated():,}", flush=True)
    del x
    free()
    done("dirichlet", t0)

    t0 = phase("main")
    register_heat3d_cut()
    cache_oracles(oracle)
    runs = {}
    for name, arch, flags, expected in MAIN_RUNS:
        runs[name] = run_main_path(name, arch, flags, expected)
    for group in SAME_SOLVE:
        its = {name: runs[name]["iterations"] for name in group}
        if max(its.values()) - min(its.values()) > 1:
            raise SystemExit(f"iteration counts more than one apart: {its}")
    base = runs["heat-2d dense --kernels"]
    packed = runs["heat-2d packed --kernels"]
    ratio = packed["peak"] / base["peak"]
    print(f"[chip_smoke] peak device memory, heat-2d packed / dense "
          f"--kernels: {packed['peak']:,} / {base['peak']:,} = {ratio:.3f}",
          flush=True)
    if ratio > 0.5:
        raise SystemExit("the packed run's peak device memory is above half "
                         "of the dense run's")
    lumped = runs["elasticity-3d dense --kernels lumped"]["iterations"]
    dirichlet = runs["elasticity-3d packed --kernels dirichlet"]["iterations"]
    print(f"[chip_smoke] feti-elasticity-3d iterations: dirichlet {dirichlet}, "
          f"lumped {lumped}", flush=True)
    if not dirichlet < lumped:
        raise SystemExit("Dirichlet took no fewer iterations than lumped on "
                         "feti-elasticity-3d")
    for f32_run, f64_run in HALF_BYTES:
        a, b = runs[f32_run]["bytes"], runs[f64_run]["bytes"]
        print(f"[chip_smoke] stack bytes {f32_run} / {f64_run}: L "
              f"{a['L']:,} / {b['L']:,}, F {a['F']:,} / {b['F']:,}, "
              f"K {a['K']:,} / {b['K']:,}, the f64 Kreg of refinement "
              f"{a['Kreg']:,}", flush=True)
        if not (2 * a["L"] == b["L"] and 2 * a["F"] == b["F"]):
            raise SystemExit(f"{f32_run}: the f32 factor and F stacks are "
                             f"not half of {f64_run}'s")
    name, before, most = F32_PEAK
    print(f"[chip_smoke] peak device bytes {name}: {runs[name]['peak']:,} "
          f"(before the f64 factorization steps: {before:,}; ratio "
          f"{runs[name]['peak'] / before:.4f})",
          flush=True)
    if runs[name]["peak"] > most * before:
        raise SystemExit(f"{name}: peak device bytes above {most:g} x "
                         f"{before:,}")
    print(f"[chip_smoke] feti-elasticity-3d f32 Dirichlet rel err "
          f"{runs['elasticity-3d dense --kernels dirichlet f32']['err']:.3e}"
          f" (f64: "
          f"{runs['elasticity-3d packed --kernels dirichlet']['err']:.3e})",
          flush=True)
    done("main", t0)

    t0 = phase("telemetry")
    telemetry, _ = telemetry_phase()
    for run in telemetry.values():
        # each solver holds its full-size heat-2d stacks (~11 GB); later
        # phases, the sharded ranks on this card among them, need them free
        del run["solver"]
    free()
    done("telemetry", t0)

    t0 = phase("autotune")
    auto = autotune_phase(device, runs)
    done("autotune", t0)

    t0 = phase("sharded")
    shard = sharded_phase()
    done("sharded", t0)

    kernel_rows(rows, d_rows, small, wide,
                {**runs, **telemetry, **auto, **shard})
    for r in rows:
        r["planning_launches"] = {
            name: run["planning"]["launches"][r["name"]]
            for name, run in auto.items()
            if run["planning"]["launches"][r["name"]]}

    t0 = phase("lm")
    # the FETI phases' solvers, plans and their device caches go first
    del runs, telemetry, auto, shard
    free()
    print(f"[chip_smoke] device bytes held before the lm phase "
          f"{torch.cuda.memory_allocated(device):,}", flush=True)
    lm_phase(device, smi)
    done("lm", t0)

    t0 = phase("train")
    free()
    print(f"[chip_smoke] device bytes held before the train phase "
          f"{torch.cuda.memory_allocated(device):,}", flush=True)
    train_phase(device, smi)
    done("train", t0)

    t0 = phase("placed")
    free()
    placed_phase(device, smi)
    done("placed", t0)

    t0 = phase("dryrun")
    dryrun_phase(device, smi)
    done("dryrun", t0)
    print(f"[chip_smoke] total {time.perf_counter() - t_all:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
