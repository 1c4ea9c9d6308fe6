#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Drives the port's serving path (``mvs_gaussian_splatting_tpu_torch``: PLY
load → measured eval raster layout → ``render``) on the retained 115,320-
Gaussian ``runs/specfinal`` model at its full 1237×822 resolution, on its 15
held-out test views, and holds the result against that run's ground truth
and against the JAX package's own renders of the same views; then its
training path in the default fast-math mode and in exact mode, the
padded-table backend, and the tools a user runs on a trained model
(render, metrics, full_eval, compression, the 2D toy, the native COLMAP
reader). Phases, one JSON line each:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: ``csrc/*.cu`` → ``build/torch_kernels/libgs_kernels.so`` with
   nvcc, and at the same time the section-clock library of
   ``profile_kernels.py`` (``-DGS_SECTION_CLOCKS``, a measuring build the
   port never runs); each kernel's ``-Xptxas -v`` register / shared-memory
   line (the one-part instantiation's, and the multi-part one's under
   ``<name>_parts``), and each kernel's registers and resident CTAs per SM
   at 16×16, 32×16 and the large tiles of phase 11
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` through the
   library's own launch configuration): B3b needs at least 32 resident
   warps per SM at 32×16 tiles and no spills, B2 and B5 no spills;
3. kernel vs plain version: ``stream_fwd`` (B1) against
   ``composite_stream_plain`` on one real view's stream and on a random
   stream made from ``--seed`` (the 32 heaviest tiles plus 32 drawn with a
   seeded RNG, through ``tile_ids``), max abs ≤ 2e-4 on both outputs;
4. the slice: every test view rendered under ``torch.no_grad()``,
   quantised as ``save_image`` does; PSNR against ground truth (mean within
   0.02 dB of results.json, each view within 0.05 dB of per_view.json) and
   against the JAX package's renders (≥ 45 dB each), zero capacity
   overflow, one kernel launch per view; render times and peak memory.
   This layout's 16M slot limit clips the model's widest splats, as the
   JAX package's run did, and counts them in overflow_tiles;
4b. the same views on the clip-free layout (the 16M slot limit lifted):
   zero tile and capacity overflow;
5. per view: stage times of the render path (CUDA events), the kernel's
   time over repeated launches, its plain version's time and the least
   time the card could take (bytes over 3.35 TB/s, operations over
   67 TFLOP/s f32);
6. bwd_vs_plain: the backward kernel (``csrc/stream_bwd.cu``, B2) against
   ``composite_stream_bwd_plain`` with a random ``g_out`` and a nonzero
   ``g_tfin`` made from ``--seed``, on one full test view at the reference
   layout, a 64-tile subset of it, and random streams on 16×16 and 32×16
   tiles: per attribute row max |kernel − plain| ≤ 2e-6 · max |plain|,
   exact zeros outside the segments and in rows 9..15, and two launches
   equal to the bit;
6b. fast_vs_plain: the fast-math kernels (B3f in ``csrc/stream_fwd.cu``,
   B3b ``csrc/stream_bwd_fast.cu``) against ``composite_stream_fast_plain``
   / ``composite_stream_bwd_fast_plain`` on the same four streams (the
   random ones with a fifth of their entries far-centred wide splats):
   image and final_T within 2e-3 max abs, each gradient row within 5e-3 of
   its largest magnitude (the JAX package's fast-mode contract), exact
   zeros outside the segments and in rows 9..15; the worst row reported;
6c. padded_vs_plain: B4 (``csrc/padded_fwd.cu``) and B5
   (``csrc/padded_bwd.cu``) against ``composite_padded_plain`` /
   ``composite_padded_bwd_plain`` on random tables at 16×16 and 32×16:
   within 2e-4 max abs and 2e-6 per plane, exact zeros in invalid and
   uncounted slots (B5 writes them itself), two B5 launches equal to the
   bit;
7. train_resume, the training path at the trained size: a COLMAP dataset
   of the 15 views (their ground-truth PNGs and poses, 13 train and 2 test
   under ``--eval``) and a checkpoint of the retained model at iteration
   25000 (115,320 alive rows, SH 3, zero Adam moments) are written to a
   temporary directory, and ``cli/train.py main([...])`` resumes it with
   the flagship's raster flags (32×16 tiles, 512 tiles per Gaussian, tiers
   (4, 12, 64) at (0.25, 0.1, 0.01)) for 200 steps in two arms from the
   same checkpoint and seed, each traced at its iterations 100-120: the
   default fast-math mode (B3f / B3b) and exact mode (``--no-fast_math``,
   B1 / B2). Checks per arm: finite losses, no non-finite gradient rows,
   train PSNR not below its start, test PSNR not more than 0.1 dB below
   its start unless the train PSNR gained more than the test PSNR lost (a
   deviation from PR 4's stated criterion, restated in ROADMAP.md section
   C), one backward launch per step of the arm's mode and none of the
   other's, evals through B1 only; across arms, final train PSNR (13
   views) and test PSNR (2 views) within 0.1 dB. Reported per arm: the
   median step time after the traced window and the traced window's host
   and device time per step in the step's forward, backward and update
   ranges; on 5 train views' streams of the exact arm's model, B2's, B3f's
   and B3b's times (each wrapper takes its own tile order), plain times,
   gaps and bounds, and B1's time and bound beside B3f's; B2's, B3f's and
   B3b's section splits. Then the exact resume at a tenth of every
   learning rate, measured only: its test and train PSNR trajectories;
8. train_init, the densification machinery in the default fast-math mode:
   54,000 points sampled from the retained model's means with N(0, 0.02)
   noise, colours from its SH DC term, 600 steps densifying every 100 from
   iteration 100. Checks: clone or split ran (each round's clone / split /
   prune counts are printed) and the alive count changed, the final loss
   EMA is below 0.8 × the first logged loss, the test PSNR rose over the
   iteration-1 render's, and every parameter is finite. Iterations 100-120
   are traced with ``--profile_dir``; the device time by kernel is
   printed;
9. padded, the ``--backend pallas`` path: the 3 test views whose widest
   splat spans the fewest tiles, rendered through ``render`` on padded
   tables whose flat per-Gaussian budget covers that splat and whose
   capacity covers the fullest tile (both overflow counters zero, the key
   count and peak memory printed), each image within 2e-4 max abs of the
   same view's stream render on the clip-free layout (zero overflow
   there too); B4's and B5's times, plain times, gaps, bounds and section
   splits on the first view's tables; then 20 training steps through
   ``cli/train.py``
   with ``--backend pallas`` from the same checkpoint: finite losses, one
   B4 and one B5 launch per step;
9b. padded_cli: ``cli/render.py --backend pallas`` on the retained model
   and the training dataset's 15 views, at the CLI's own measured layout
   and default tile capacity: one B4 launch per view and no other kernel;
   its overflow counters, PSNR against ground truth, time and peak memory
   are reported (its clipping is counted, not held);

10. sections: the time split of B1 (phase 5's 15 views), B3f, B3b and B2
   (phase 7's 5 training streams), B4 and B5 (phase 9's tables) by section
   from the section-clock build (``profile_kernels.kernel_split``), each
   kernel's time alone, their warp-step counts and
   last-wave drain, the SASS instructions per warp-step of the loop that
   holds the exp (``cuobjdump -sass``), the SM clock under load, the
   issue-rate floor those give, and a work bound (the bound's operations
   for the contributing pairs only, plus the cull's box test on each live
   warp-step) beside each kernel's bound;

11. large_tiles (run before phase 10's report), tiles of more than 1,024
   pixels (the kernels walk them in parts) and one with a side over 64
   (B3b's parts): every kernel against its plain version on a random
   stream and random tables at 64×32, 48×48 and 128×8 within the
   tolerances above, two launches of each equal to the bit, and B1 on a
   real view's 64×32 stream; then, counted as a main path, the 15 test
   views rendered clip-free at 16×16 and 64×32 on the stream backend
   (finite, no overflow; PSNR against ground truth and the gap between the
   two shapes reported, not held: the reference's image depends on the
   tile shape, as a splat reaches past 3 sigma within a larger tile,
   ``tests/test_torch_parts.py``), 3 of them at 64×32 on the padded
   backend within 2e-4 max abs of the stream's, and 5 training steps at
   64×32 from the checkpoint in fast, exact and ``--backend pallas`` mode
   (finite losses, no non-finite gradient rows, one backward launch per
   step); each kernel's time alone on the first test view at 16×16 and
   64×32, clip-free;

12. dataset: the flagship's dataset regenerated by the port's
   ``ref_scale_validation.write_dataset`` in a temporary directory (120
   views at 1237×822, 150,000 GT points, 54,000 init points, seed 0, the
   specular style, on the TPU run's operator: stream, exact, 32×16 tiles,
   1,024 slots a tile, 32 tiles per Gaussian): each of the 15 test views
   (0, 8, ..., 112) at least 45 dB against the retained ground truth
   (``runs/specfinal/model/test/ours_25000/gt``), every pose within 1e-9 of
   ``cameras.json``'s, one B1 launch per view; the per-view PSNRs and the
   time to write it are printed;
13. grow_resume, grow mode on that dataset (105 train views, 15 held
   out): the retained model as a checkpoint at iteration 14,600 (capacity
   262,144, 115,320 alive rows, zero moments; the grow checkpoint with
   uniform direction logits), inside the speculation window, three grow
   rounds before ``densify_until_iter``; resumed 300 steps in the default
   fast-math mode with ``--grow_dir --spec_capacity 4096 --growdirs_lr
   0.01`` and without (vanilla), each traced at its iterations 100-120, and
   20 exact grow steps (``--no-fast_math``: B2 takes the augmented set).
   Checks per arm: finite losses, no non-finite gradient rows, one forward
   and one backward launch of the arm's mode per step and none of the
   other mode's; for grow: every step renders ``n_render + 8192`` rows,
   every grow round grows Gaussians and resets the rows it selected to
   uniform, and the direction logits of rows it did not select have moved
   off uniform. Held-out test PSNR: the vanilla arm at most 0.1 dB below
   the checkpoint's at the run's end (PR 4's criterion); the grow arm,
   whose held-out PSNR dips while a model trained without speculative rows
   adapts to them (the JAX package's loop does the same), recovering (at
   the end above its value at the first round) and within 0.1 dB of the
   exact grow arm at iteration 14,620; its drop, its gap to the vanilla
   arm and the PSNR of each arm's state after the last round are printed,
   with the step medians, the traced device time a step, the alive counts
   and the peak memory of each arm;
14. eval_chain, the offline eval chain on the card: (a) the port's
   ``eval/metrics.evaluate`` over a temporary copy of the kept renders and
   ground truth (``runs/specfinal/model/test/ours_25000``): its mean PSNR
   within 1e-4 dB of ``results.json`` and its mean SSIM within 1e-5, each
   view's SSIM within 1e-5 of ``per_view.json``, each view's PSNR within
   1e-4 dB of an f64 PSNR of the same PNGs and within 1e-3 dB of
   ``per_view.json`` (whose f32 values, reduced on the TPU, sit up to
   6.6e-4 dB from the f64 ones), LPIPS null (no weights); (b)
   ``cli/render.py`` on the retained model and phase 12's dataset (the 15
   test views, one B1 launch each, no capacity overflow), scored by
   ``evaluate``: mean PSNR within 0.02 dB of ``results.json``; (c)
   ``cli/full_eval.py --scenes <phase 12's dataset> --iterations 1050``:
   training from its 54,000 points at the default flags (fast math: one
   B3f and one B3b launch a step, B1 for the evals and the render, no
   other kernel), then render and metrics; ``results.json`` and
   ``per_view.json`` written; each stage's wall time and the offline PSNR
   beside the loop's own test PSNR at 1,050 printed, with each surface's
   clipping: both size their layouts under the 16M slot limit, which this
   scene's widest splats exceed, and clip different rows (the JAX
   package's flagship run reads 0.079 dB apart for that reason,
   ``runs/specfinal/NOTE.md``). The one-operator invariant is held where
   it is defined: the saved model at 1,050 scored as the loop scores it
   and as the offline chain does (8-bit images), each with the slot limit
   lifted, within 0.02 dB;
15. compress: the retained model written as
   ``point_cloud/iteration_25000/point_cloud.ply`` in a temporary model
   directory, ``cli/compress.py`` at 256 codes over f_rest, scaling and
   rotation (50 k-means iterations on the card), then ``--decompress``:
   the size ratio at least 5x, untouched attributes bit-equal, every
   dequantized row its codebook's row; the card's mean |dequant − raw| per
   attribute within 2 % of a CPU run of the same draws; the dequantized
   model rendered on the 15 test views through B1 at its own measured
   eval layout (finite, no capacity overflow, one launch a view), its PSNR
   drop against phase 4's render printed;
16. tools: the 2D toy (``toy2d``) fits the first kept ground-truth view
   at 256 on its long side for 300 epochs on the card from 250 splats in
   1,250 slots (the loss falls, densification changes the alive count);
   the native COLMAP reader
   (``native/``) builds with ``g++``, and the readers of ``data/colmap.py``
   take it on phase 12's ``sparse/0/*.bin`` (one native parse each) and
   equal the Python parsers (every array, name and number);
17. parallel modes (``parallel/``): (a) the tile partition: on 3 test
   views at the flagship's 32×16 layout, ``tile_stream``'s per-rank body
   for every rank r < D on the one card, D in (2, 4), strips and
   round-robin, exact (B1/B2) and fast (B3f/B3b); the shards' tiles and
   summed packed gradients against the unsharded call (bit-equal, else
   within 1e-6 of scale) and each rank's kernel ms (max / mean); (b) at
   world size 1 through ``torch.distributed`` (a NCCL group of one): the
   ``--data_parallel 4`` first step's gradient against the mean of its
   four single-camera steps (fast within 1e-3 of scale, exact within
   1e-5), the ``--tile_parallel 1`` first step against
   ``make_train_step`` (exact, 1e-5; and ``make_train_step`` against
   itself: the gathers' scatter-add is atomic on the card), the
   Gaussian-sharded render's ``overflow_quota``, then ``cli/train.py``
   resumes: 120 fast steps of ``--data_parallel 4`` (traced at 100-120;
   the step per camera beside phase 7's single-camera step), 20 each of
   a single-camera resume (the control of the 20-step times),
   ``--tile_parallel 1``, ``--data_parallel 2 --tile_parallel 1`` and
   ``--gauss_parallel 1``, and
   from phase 13's grow checkpoint 20 of ``--grow_dir --data_parallel
   4``; every run's losses and gradients finite;
18. mvs, the MVS branch (``mvs/``) at the model's defaults (32 depths,
   features (16, 32, 32), 2 sources) on 640×480 synthetic groups (DTU's
   1600×1200 under the CLI's ``--max_dim 640``: 19,200 Gaussians a group,
   a [32, 32, 120, 160] cost volume a source): (a) one group's train-step
   loss and parameter gradients with weights from ``--seed``, through B1
   and B2, against the same computation on a CPU copy (the plain
   versions): the predicted Gaussians within 1e-5 and every gradient
   within 1e-4 of their leaf's largest magnitude (the CNNs' library sums
   differ by device), the image within 5e-4 max abs (the two devices
   preprocess in other roundings, and an entry's alpha crossing 1/255
   moves a pixel by up to T·|rgb|/255), and B1 on the card's projected
   Gaussians within 2e-4 of its plain version; the recipe's tile need and
   clipped tile slots printed; (b) ``cli/mvs_train.py
   --synthetic 16 --width 640 --height 480 --iterations 500 --eval_every
   250`` (500 of the recipe's 2,000 iterations) as written, then under a
   flat budget of 512 tiles a Gaussian with room for all (the JAX
   package's eval widening): one B2 launch a step, no fast-mode kernel and
   finite losses in both; the learning criteria (the last logged
   loss below 0.7 × the first, the JAX package's test's criterion; the
   last eval PSNR not below the first) and finite weights held on the
   second and reported on the first, where the recipe's budget clips most
   tiles, the scales run away and the model does not learn (ROADMAP C14);
   the step medians, launches and peak memory printed;
19. viewer, the network viewer (``viewer/``): (a) the port's server on a
   free loopback port, pumped as the loop pumps it, and a client thread
   asking for 5 orbit frames of the retained model at 1237×822: each
   frame's bytes equal to ``render_to_bytes`` of a direct render of the
   same camera, the verify string back; ms a frame beside the render's;
   (b) ``cli/train.py --ip 127.0.0.1 --port <free>`` for 20 steps from
   phase 7's checkpoint, a client asking for a frame with ``train=True``
   at each step: every step and every frame arrives;
20. tools, the benches, profile and entry points (``tools/``) through their
   entry points, at the widths of the JAX repository's benches: the 1080p
   forward+backward bench on 200,000 Gaussians in fast math, ``--exact``
   and ``--forward``; the train bench on fern (504×378, 250,000) and
   bicycle (1237×822, 500,000), 200 timed steps each; the 1080p step
   profile; the scaling bench and the sharded compress pipeline at world
   size 1 (the pipeline 150 of its 300 iterations, held to the JAX test's
   five criteria); ``graft_entry.entry()`` with B1 against its plain
   version on the same projected Gaussians (2e-4) and
   ``dryrun_multichip(1)``; every gradient finite, every overflow
   counted, a capacity overflow a fault;
21. experiments, the micro-experiments (``tools/exp_binning.py``,
   ``tools/exp_scatter.py``, ``tools/exp_perf.py``) through their ``run``
   at 1080p (1920×1088, 200,000 Gaussians) and bicycle (1237×822,
   500,000), one JSON line each: binning's stages A-F and their sum beside
   the whole call, every variant composed into a whole binning and held
   integer-equal to ``bin_instances_stream``; the row scatter's variants
   and its sweeps across 125,000-4,000,000 target rows and widths 8-16,
   each within 1e-6 of scale of its float64 sum (the cumsum-difference
   forms within ``exp_scatter.CUMSUM_REL``); the primitive rates beside
   their byte bounds, the four tier settings, B3f, B3f+B3b, B1 and B1+B2
   on each workload's stream, and the unsort candidates; every check a
   fault when false, and each of those four kernels launched;

then the ``kernels`` line (B1, B2, B3f, B3b, B4 and B5, with their launches
on the main paths: the render slice of phase 4, the two arms of phase 7
(not its control), phase 8, phase 9, phase 9b, phase 11's renders and
training, phase 12's dataset, phase 13's three arms, phase 14's render CLI
and full_eval, phase 15's render, phase 17 and phases 18, 19, 20 and 21, each
counted from zero)
and last ``{"ok": true, "device": {...}}``. A failed check raises after the
measurements and exits non-zero without printing those two lines; without a
card it exits non-zero before printing any result. It writes nothing into
the tree but the gitignored ``build/``; the training runs write into a
temporary directory that is deleted.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(ROOT, "runs", "specfinal", "model")
VIEWS = os.path.join(MODEL, "test", "ours_25000")
TOL = 2e-4                    # kernel vs plain version, max abs
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM, f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM, TF32 tensor cores, dense
FLOPS_PER_PAIR = 20           # per (entry, pixel) pair visited
# backward: the replay's 20, the gradient's 35 and 9 adds of the pixel sum
FLOPS_PER_PAIR_BWD = 64
# fast backward on the CUDA cores: the replay's 20, dpower and w 15; on the
# tensor cores: 4 m16n8k8 TF32 products (2,048 flops each) per 8 pixels x
# 8 entries (dpower and w, each as a hi and a lo part)
FLOPS_PER_PAIR_FAST_BWD = 35
MMA_FLOPS_PER_PAIR = 4 * 2048 / 64
# the work bound (phase 10): the operations above per contributing pair
# only, plus the cull's box test (six f32 operations) on each lane of each
# live warp-step
BOX_TEST_OPS = 6 * 32
# exact backward kernel vs plain, per row, relative: B2 and B5 do their
# plain versions' arithmetic but for the order of the sum over a tile's
# pixels (ROADMAP C13); measured up to 1.56e-6 on a full view (1e-5
# before, when B2 kept a running prefix that the plain version compensated)
BWD_REL = 2e-6
FAST_TOL = 2e-3               # fast kernels vs plain: the JAX package's
FAST_REL = 5e-3               # fast-mode contract (tests/test_fast_math.py)
ARM_PSNR = 0.1                # fast vs exact arm, final PSNR, dB
MIN_WARPS_B3B = 32            # B3b's resident warps per SM at 32×16 tiles
PKG = "mvs_gaussian_splatting_tpu_torch/csrc/"
JAX_PALLAS = "mvs_gaussian_splatting_tpu/ops/pallas/"
# name → (source, the TPU kernel it replaces)
KERNELS = {
    "stream_fwd": (PKG + "stream_fwd.cu", JAX_PALLAS + "stream.py:89"),
    "stream_bwd": (PKG + "stream_bwd.cu", JAX_PALLAS + "stream.py:219"),
    "stream_fwd_fast": (PKG + "stream_fwd.cu",
                        JAX_PALLAS + "composite.py:111"),
    "stream_bwd_fast": (PKG + "stream_bwd_fast.cu",
                        JAX_PALLAS + "stream.py:362"),
    "padded_fwd": (PKG + "padded_fwd.cu", JAX_PALLAS + "composite.py:188"),
    "padded_bwd": (PKG + "padded_bwd.cu", JAX_PALLAS + "composite.py:230"),
}
RESUME_ITER = 25000
RESUME_STEPS = 200
INIT_POINTS = 54_000
INIT_STEPS = 600
LOSS_DROP = 0.8               # train_init: final loss EMA < 0.8 × first
PADDED_VIEWS = 3
PADDED_STEPS = 20
# tiles of more than 1,024 pixels (walked in parts), one with B3b's side
# limit: 64 x 32 (2 parts), 48 x 48 (4, two cut at the edges), 128 x 8 (one
# part in the forwards, 4 in B3b)
LARGE_TILES = ((64, 32), (48, 48), (128, 8))
LARGE_STEPS = 5
# the flagship recipe's raster flags (runs/specfinal/NOTE.md,
# scripts/ref_scale_validation.py), in the default fast-math mode; the
# exact arm adds --no-fast_math
# phase 12: the flagship's dataset as scripts/ref_scale_validation.py
# writes it (runs/specfinal); its test views are every 8th (llffhold)
FLAGSHIP = dict(width=1237, height=822, n_views=120, n_gt=150_000,
                n_init=54_000, seed=0, style="specular")
LLFFHOLD = 8
POSE_TOL = 1e-9               # cameras.json vs the orbit, abs (relative fx)
# phase 13: grow mode resumed inside the speculation window, three grow
# rounds (14,700, 14,800, 14,900) before densify_until_iter
GROW_ITER = 14_600
GROW_CAPACITY = 262_144
GROW_SPEC = 4096              # --spec_capacity: 8,192 speculative rows
GROW_STEPS = 300
GROW_EXACT_STEPS = 20
GROW_PSNR_DROP = 0.1          # held-out test PSNR, dB over the run
# phase 14: the eval chain. The kept renders' metrics: mean PSNR (dB) and
# SSIM against results.json, each view's SSIM against per_view.json and
# its PSNR against an f64 PSNR of the same PNGs; the kept per-view PSNRs
# were reduced in f32 on the TPU and sit up to 6.6e-4 dB from that f64
# value, so a view's PSNR is held to per_view.json within 1e-3 dB
EVAL_PSNR_TOL = 1e-4
EVAL_SSIM_TOL = 1e-5
EVAL_VIEW_KEPT_TOL = 1e-3
# full_eval's iterations: it evaluates and saves at 525 and 1,050, where no
# densification round runs (every 100 from 500), so the saved model is the
# one the loop evaluated
EVAL_ITERS = 1050
# phase 15: 256 codes a compressed attribute, the size ratio held at 5x
# (the JAX pipeline reached 6.72x, runs/shardcompress/NOTE.md), the card's
# mean error per attribute within 2 % of a CPU run of the same draws
COMPRESS_CODES = 256
COMPRESS_RATIO = 5.0
COMPRESS_CPU_REL = 0.02
# phase 16: the 2D toy on one kept view at 256 on its long side, from 250
# splats in 1,250 slots (the toy's 1:4 split of initial and spare slots at
# a quarter of its default 1,000: the sum of 1,000 initial splats saturates
# every pixel, the clamp then passes no gradient, and neither package's
# toy learns, ROADMAP.md C10)
TOY_SIDE = 256
TOY_EPOCHS = 300
TOY_INIT = 250
TOY_CAPACITY = 1250
# phase 17: the multi-device modes (parallel/) on one card. (a) the tile
# partition: 3 test views at the flagship's 32x16 layout, D ranks' shards
# composited one after another on the card, strips and round-robin, exact
# and fast; their image and summed packed gradient held to the unsharded
# call (each instance slot belongs to one tile: bit-equality expected,
# else within PART_REL of scale). (b) world size 1 through the real
# distributed code: the camera batch's first step against the mean of its
# cameras' single steps, then the loop in every mode
PAR_VIEWS = 3
PAR_SHARDS = (2, 4)
PART_REL = 1e-6
PAR_BATCH = 4
PAR_BATCH_STEPS = 120         # the profiler traces iterations 100-120
PAR_STEPS = 20
PAR_FAST_REL = 1e-3           # the fast-mode contract
# exact mode, within what the CPU tests measured of one step (C11: the
# step 3-3.5e-6 of scale from the other package); a 1/B or W-fold error
# would be a factor of 2 or more. The card's exact step does not repeat to
# the bit (the gathers' index_add_ adds with atomics), so the exact
# comparisons run under torch.use_deterministic_algorithms, where one step
# run twice must agree to the bit
PAR_EXACT_REL = 3e-6
# phase 18: the MVS branch at the model's defaults (32 depths, features
# (16, 32, 32), 2 sources) on DTU's working size under the CLI's
# --max_dim 640; its train run cut to 500 of 2,000 iterations
MVS_SIZE = (640, 480)
MVS_GROUPS = 16
MVS_ITERS = 500
MVS_EVAL_EVERY = 250
MVS_IMG_TOL = 2e-4            # B1 vs plain on the same inputs, max abs
# card vs CPU copy end to end, image max abs: the two preprocess in other
# roundings, and an entry's alpha crossing 1/255 moves a pixel by up to
# T·|rgb|/255 (measured 2.9e-4, one pixel over 1e-4, on an NVIDIA H100
# 80GB HBM3 at 700 W)
MVS_IMG_E2E = 5e-4
MVS_OUT_REL = 1e-5            # predicted Gaussians, per output's largest
MVS_GRAD_REL = 1e-4           # card vs CPU copy, per leaf's largest |g|
MVS_LOSS_DROP = 0.7           # last logged loss < 0.7 × the first
# phase 19: the network viewer
VIEWER_FRAMES = 5
VIEWER_STEPS = 20
VIEWER_TRAIN_SIZE = (640, 426)  # the frames asked for while training
# phase 20: the tools (tools/), at the widths of the JAX repository's
# benches; the train benches cut to TOOLS_TRAIN_ITERS timed steps, the
# pipeline to TOOLS_PIPELINE_ITERS of its 300 iterations
TOOLS_BENCH_ITERS = 50            # the host-bound step varies between calls
TOOLS_TRAIN_ITERS = 200
TOOLS_PIPELINE_ITERS = 150
# phase 21: the experiments (tools/exp_*.py) at the JAX scripts' widths;
# the stream kernels its kernels section must launch
EXP_WORKLOADS = ("1080p", "bicycle")
EXP_KERNELS = ("stream_fwd", "stream_bwd", "stream_fwd_fast",
               "stream_bwd_fast")
TRAIN_FLAGS = ["--eval", "--resolution", "1",
               "--tile_w", "32", "--tile_h", "16",
               "--max_tiles_per_gaussian", "512",
               "--tier_budgets", "4", "12", "64",
               "--tier_fracs", "0.25", "0.1", "0.01",
               "--max_capacity", "1000000"]


@contextlib.contextmanager
def deterministic():
    """The block under ``torch.use_deterministic_algorithms`` (index_add_
    sorts its rows instead of adding with atomics): an op that has no
    deterministic version warns instead of raising, and the block yields
    the list of those warnings. Uninitialised memory is left as it is."""
    import torch
    import torch.utils.deterministic as tdet
    fill = tdet.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    tdet.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(False)
        tdet.fill_uninitialized_memory = fill


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] += v


def reset_launches():
    """Sets every kernel's launch count to 0."""
    from mvs_gaussian_splatting_tpu_torch.ops import composite, stream
    stream.launches = stream.bwd_launches = 0
    stream.fast_launches = stream.fast_bwd_launches = 0
    composite.launches = composite.bwd_launches = 0


def read_launches():
    """Every kernel's launch count since the last reset_launches()."""
    from mvs_gaussian_splatting_tpu_torch.ops import composite, stream
    return {"stream_fwd": stream.launches, "stream_bwd": stream.bwd_launches,
            "stream_fwd_fast": stream.fast_launches,
            "stream_bwd_fast": stream.fast_bwd_launches,
            "padded_fwd": composite.launches,
            "padded_bwd": composite.bwd_launches}


def cuda_ms(fn, reps=1):
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls, by
    CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def row_gaps(got, want):
    """Per row of ``want``: max |got − want| / max |want| (a zero row must
    match exactly)."""
    rel = []
    for r in range(want.shape[0]):
        scale = float(want[r].abs().max())
        err = float((got[r] - want[r]).abs().max())
        rel.append(err / scale if scale > 0 else (0.0 if err == 0
                                                  else float("inf")))
    return rel


def outside_segments(attrs, seg_start, counts):
    """Whether ``attrs`` is exactly zero outside the segments and in rows
    9..15."""
    import torch
    width = attrs.shape[1]
    delta = torch.zeros(width + 1, dtype=torch.int32, device=attrs.device)
    ends = (seg_start.long() + counts.long()).clamp(max=width)
    delta.index_add_(0, seg_start.long(), torch.ones_like(seg_start))
    delta.index_add_(0, ends, -torch.ones_like(seg_start))
    inside = torch.cumsum(delta[:-1], 0) > 0
    return bool((attrs[:, ~inside] == 0).all()) and bool(
        (attrs[9:] == 0).all())


def emit(obj):
    print(json.dumps(obj), flush=True)


def psnr(a: np.ndarray, b: np.ndarray):
    """PSNR of two uint8 images over all values, as eval/metrics computes
    it; None where they are identical."""
    mse = float(np.mean((a.astype(np.float64) / 255.0
                         - b.astype(np.float64) / 255.0) ** 2))
    return (20 * np.log10(1.0 / np.sqrt(mse)) if mse > 0 else None), mse


def load_png(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def bwd_check(args, out, tfin, g_out, g_tfin):
    """B2 on one stream against its plain version: (per-row relative gaps,
    max abs error, whether columns outside the segments and rows 9..15 are
    exactly zero, whether a second launch gives the same bits, the plain
    version's visited pairs)."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.ops import stream
    got, got_bg = stream.composite_stream_bwd(*args, out, tfin, g_out,
                                              g_tfin)
    again, _ = stream.composite_stream_bwd(*args, out, tfin, g_out, g_tfin)
    torch.cuda.synchronize()
    want, want_bg, visits = stream.composite_stream_bwd_plain(
        *args, out, tfin, g_out, g_tfin, count_visits=True)
    return {"rel_gap": row_gaps(got[:9], want[:9]),
            "max_abs_err": float((got - want).abs().max()),
            "g_bg_err": float((got_bg - want_bg).abs().max()),
            "zeros_outside": outside_segments(got, args[1], args[2]),
            "deterministic": bool(torch.equal(got, again)),
            "visits": visits}


def fast_check(args, g_out, g_tfin):
    """B3f and B3b on one stream against their plain versions, each
    backward replaying its own forward: (B3f's max abs gap on out and
    final_T, B3b's per-row relative gaps, its zeros outside the segments)."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.ops import stream
    out, tfin = stream.composite_stream(*args, fast=True)
    got, _ = stream.composite_stream_bwd(*args, out, tfin, g_out, g_tfin,
                                         fast=True)
    torch.cuda.synchronize()
    ref, rtfin = stream.composite_stream_fast_plain(*args)
    want, _ = stream.composite_stream_bwd_fast_plain(*args, ref, rtfin,
                                                     g_out, g_tfin)
    rel = row_gaps(got[:9], want[:9])
    return {"fwd_max_abs": max(float((out - ref).abs().max()),
                               float((tfin - rtfin).abs().max())),
            "bwd_rel_gap": rel, "worst_row": int(np.argmax(rel)),
            "bwd_max_abs": float((got - want).abs().max()),
            "zeros_outside": outside_segments(got, args[1], args[2])}


def cotangents(t, p, seed, dev):
    import torch
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(t, p, 3).astype(np.float32)).to(dev),
            torch.from_numpy(rng.randn(t, p).astype(np.float32)).to(dev))


def bwd_vs_plain(view_stream, cam, subset, tiles_x, cfg, seed, faults):
    """Phase 6: B2 against its plain version on real and random streams."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.ops import stream
    dev = torch.device("cuda")
    cases = {}
    bins, attrs = view_stream(cam)
    t = tiles_x * (-(-cam.height // cfg.tile_h))
    ids = torch.arange(t, dtype=torch.int32, device=dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    full = (attrs, bins.seg_start, bins.counts, bg, ids, tiles_x,
            cfg.tile_w, cfg.tile_h)
    out, tfin = stream.composite_stream(*full)
    cases["full_view_16x16"] = bwd_check(
        full, out, tfin, *cotangents(t, cfg.tile_w * cfg.tile_h, seed, dev))
    sel = torch.from_numpy(subset(bins.counts.cpu().numpy(),
                                  np.random.RandomState(seed + 1))).to(dev)
    sub = (attrs, bins.seg_start[sel].contiguous(),
           bins.counts[sel].contiguous(), bg, sel.to(torch.int32), tiles_x,
           cfg.tile_w, cfg.tile_h)
    out, tfin = stream.composite_stream(*sub)
    cases["view_64_tiles"] = bwd_check(
        sub, out, tfin, *cotangents(len(sel), cfg.tile_w * cfg.tile_h,
                                    seed + 2, dev))
    del bins, attrs, full, sub
    for tw, th in ((16, 16), (32, 16)):
        syn = stream.random_stream(seed, tiles_x=8, tiles_y=6, tile_w=tw,
                                   tile_h=th)
        a = tuple(torch.from_numpy(syn[k]).to(dev) for k in
                  ("attrs", "seg_start", "counts", "bg", "tile_ids")) + (
            syn["tiles_x"], tw, th)
        out, tfin = stream.composite_stream(*a)
        cases[f"random_{tw}x{th}"] = bwd_check(
            a, out, tfin, *cotangents(48, tw * th, seed + 3, dev))
    emit({"phase": "bwd_vs_plain", "tolerance_rel": BWD_REL,
          "max_rel_gap": max(max(c["rel_gap"]) for c in cases.values()),
          "cases": cases})
    for name, c in cases.items():
        if (max(c["rel_gap"]) > BWD_REL or not c["zeros_outside"]
                or not c["deterministic"]):
            faults.append(f"backward kernel vs plain, {name}: {c}")
    return {"max_abs_err": max(c["max_abs_err"] for c in cases.values())}


def fast_vs_plain(view_stream, cam, subset, tiles_x, cfg, seed, faults):
    """Phase 6b: B3f and B3b against their plain versions on a full view's
    stream, a 64-tile subset and random streams with far-centred splats."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.ops import stream
    dev = torch.device("cuda")
    cases = {}
    bins, attrs = view_stream(cam)
    t = tiles_x * (-(-cam.height // cfg.tile_h))
    p = cfg.tile_w * cfg.tile_h
    ids = torch.arange(t, dtype=torch.int32, device=dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    full = (attrs, bins.seg_start, bins.counts, bg, ids, tiles_x,
            cfg.tile_w, cfg.tile_h)
    cases["full_view_16x16"] = fast_check(full, *cotangents(t, p, seed, dev))
    sel = torch.from_numpy(subset(bins.counts.cpu().numpy(),
                                  np.random.RandomState(seed + 1))).to(dev)
    sub = (attrs, bins.seg_start[sel].contiguous(),
           bins.counts[sel].contiguous(), bg, sel.to(torch.int32), tiles_x,
           cfg.tile_w, cfg.tile_h)
    cases["view_64_tiles"] = fast_check(sub, *cotangents(len(sel), p,
                                                         seed + 2, dev))
    del bins, attrs, full, sub
    for tw, th in ((16, 16), (32, 16)):
        syn = stream.random_stream(seed, tiles_x=8, tiles_y=6, tile_w=tw,
                                   tile_h=th, far=0.2)
        a = tuple(torch.from_numpy(syn[k]).to(dev) for k in
                  ("attrs", "seg_start", "counts", "bg", "tile_ids")) + (
            syn["tiles_x"], tw, th)
        cases[f"random_far_{tw}x{th}"] = fast_check(
            a, *cotangents(48, tw * th, seed + 3, dev))
    worst = max(cases.items(), key=lambda kv: max(kv[1]["bwd_rel_gap"]))
    emit({"phase": "fast_vs_plain", "tolerance": FAST_TOL,
          "tolerance_rel": FAST_REL, "cases": cases,
          "worst": {"case": worst[0], "row": worst[1]["worst_row"],
                    "rel_gap": max(worst[1]["bwd_rel_gap"])}})
    for name, c in cases.items():
        if (c["fwd_max_abs"] > FAST_TOL or max(c["bwd_rel_gap"]) > FAST_REL
                or not c["zeros_outside"]):
            faults.append(f"fast kernels vs plain, {name}: {c}")
    return {"fwd_max_abs": max(c["fwd_max_abs"] for c in cases.values()),
            "bwd_rel": max(max(c["bwd_rel_gap"]) for c in cases.values())}


def padded_check(args, seed, timed=False):
    """B4 and B5 on one set of tables against their plain versions, B5 and
    its plain version given B4's outputs: (B4's max abs gap, B5's per-plane
    relative gaps over the 6 planes and 3 colours, whether every invalid or
    uncounted slot's gradient is exactly zero, whether a second B5 launch
    gives the same bits, the visited pairs; with ``timed``, kernel and plain
    times and bounds, and B4's and B5's launch arguments)."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.ops import composite
    planes, rgb, valid, counts = args[:4]
    t, k = valid.shape
    p = args[6] * args[7]
    out, tfin = composite._padded_fwd(*args)
    g_out, g_tfin = cotangents(t, p, seed, planes.device)
    gpl, grgb, _ = composite.composite_padded_bwd(*args, out, tfin, g_out,
                                                  g_tfin)
    again = composite.composite_padded_bwd(*args, out, tfin, g_out, g_tfin)
    torch.cuda.synchronize()
    ref, rtfin = composite.composite_padded_plain(*args)
    wpl, wrgb, _, visits = composite.composite_padded_bwd_plain(
        *args, out, tfin, g_out, g_tfin, count_visits=True)
    dead = (valid == 0) | (torch.arange(k, device=valid.device)[None, :]
                           >= counts.long()[:, None])
    res = {"fwd_max_abs": max(float((out - ref).abs().max()),
                              float((tfin - rtfin).abs().max())),
           "bwd_rel_gap": row_gaps(torch.cat([gpl, grgb.permute(2, 0, 1)]),
                                   torch.cat([wpl, wrgb.permute(2, 0, 1)])),
           "zeros_dead": bool((gpl[:, dead] == 0).all())
           and bool((grgb[dead] == 0).all()),
           "deterministic": bool(torch.equal(gpl, again[0]))
           and bool(torch.equal(grgb, again[1])),
           "dead_slots": int(dead.sum()), "visits": visits,
           "max_abs_err": max(float((gpl - wpl).abs().max()),
                              float((grgb - wrgb).abs().max()))}
    del ref, rtfin, wpl, wrgb, again
    if not timed:
        return res
    res["b4_ms"] = cuda_ms(lambda: composite._padded_fwd(*args), 5)
    res["b4_plain_ms"] = cuda_ms(lambda: composite.composite_padded_plain(
        *args))
    res["b5_ms"] = cuda_ms(lambda: composite.composite_padded_bwd(
        *args, out, tfin, g_out, g_tfin), 5)
    res["b5_plain_ms"] = cuda_ms(lambda: composite.composite_padded_bwd_plain(
        *args, out, tfin, g_out, g_tfin))
    # bytes of the slots the kernels walk, min(counts, K) per tile: 10
    # floats read per slot (6 planes, valid, rgb), B5 writing 9 gradients
    # per slot, as B2's bound counts its segments' entries only
    live = int(torch.clamp(counts, 0, k).sum())
    b4_bytes = 10 * 4 * live + 4 * t + 12 + 16 * t * p
    b5_bytes = 10 * 4 * live + 4 * t + 9 * 4 * live + 32 * t * p
    res["live_slots"] = live
    res["b4_bound"] = bound(b4_bytes, FLOPS_PER_PAIR * visits)
    res["b5_bound"] = bound(b5_bytes, FLOPS_PER_PAIR_BWD * visits)
    res["b4_bytes"], res["b5_bytes"] = b4_bytes, b5_bytes
    res["b5_inputs"] = (out, tfin, g_out, g_tfin)
    return res


def bound(nbytes, flops, mma_flops=0.0):
    """(least time in ms, what bounds it): bytes over the HBM rate against
    f32 operations over the f32 rate and tensor-core operations over the
    TF32 rate (separate pipes, so the larger of the two)."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = max(flops / F32_FLOPS_PER_S, mma_flops / TF32_FLOPS_PER_S) * 1e3
    return (max(b_ms, f_ms), "bytes" if b_ms >= f_ms else "operations")


def padded_vs_plain(seed, faults):
    """Phase 6c: B4 and B5 against their plain versions on random tables."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.ops.composite import random_tables
    dev = torch.device("cuda")
    cases = {}
    for tw in (16, 32):
        s = random_tables(seed, tiles_x=8, tiles_y=6, tile_w=tw)
        args = [torch.from_numpy(s[k]).to(dev) for k in
                ("planes", "rgb", "valid", "counts", "bg")] + [
            s["tiles_x"], tw, 16]
        cases[f"random_{tw}x16"] = padded_check(args, seed + 5)
    emit({"phase": "padded_vs_plain", "tolerance": TOL,
          "tolerance_rel": BWD_REL,
          "max_rel_gap": max(max(c["bwd_rel_gap"]) for c in cases.values()),
          "cases": cases})
    for name, c in cases.items():
        if (c["fwd_max_abs"] > TOL or max(c["bwd_rel_gap"]) > BWD_REL
                or not c["zeros_dead"] or not c["deterministic"]):
            faults.append(f"padded kernels vs plain, {name}: {c}")
    return {"fwd_max_abs": max(c["fwd_max_abs"] for c in cases.values()),
            "max_abs_err": max(c["max_abs_err"] for c in cases.values())}


def write_training_inputs(tmp, cams, test_cams, seed):
    """The dataset (15 GT views and 54,000 init points) and the iteration-
    25000 checkpoint of the retained model, under ``tmp``."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.data.colmap import \
        write_pinhole_scene
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        GaussianAux, params_from_numpy)
    from mvs_gaussian_splatting_tpu_torch.models.ply import load_gaussian_ply
    from mvs_gaussian_splatting_tpu_torch.train.checkpoint import \
        save_checkpoint
    from mvs_gaussian_splatting_tpu_torch.train.optim import adam_init
    from mvs_gaussian_splatting_tpu_torch.utils.sh import sh2rgb
    t0 = time.time()
    model = load_gaussian_ply(os.path.join(MODEL, "point_cloud_final.ply.gz"))
    n = model["xyz"].shape[0]
    # the flagship's init, from the retained model instead of its GT cloud
    # (scripts/ref_scale_validation.py:288-293)
    rng = np.random.RandomState(seed + 2)
    idx = rng.choice(n, INIT_POINTS, replace=False)
    pts = model["xyz"][idx] + rng.normal(0, 0.02, (INIT_POINTS, 3)).astype(
        np.float32)
    rgb = (np.clip(sh2rgb(model["f_dc"][idx, 0]), 0, 1) * 255).astype(
        np.uint8)
    images = [load_png(os.path.join(VIEWS, "gt", f"{k:05d}.png"))
              for k in range(len(test_cams))]
    dataset = os.path.join(tmp, "dataset")
    write_pinhole_scene(dataset, test_cams, images, pts, rgb)

    dev = torch.device("cuda")
    params = params_from_numpy(model, dev)
    z = torch.zeros(n, device=dev)
    aux = GaussianAux(alive=torch.ones(n, dtype=torch.bool, device=dev),
                      max_radii2d=z, xyz_grad_accum=z, denom=z)
    ckpt = os.path.join(tmp, "start", f"chkpnt{RESUME_ITER}.npz")
    save_checkpoint(ckpt, params, adam_init(params), aux, RESUME_ITER, 3)
    emit({"phase": "training_inputs", "views": len(images),
          "init_points": INIT_POINTS, "checkpoint_rows": n,
          "seconds": round(time.time() - t0, 2)})
    return {"dataset": dataset, "checkpoint": ckpt}


def evaluate(params, aux, cams, eval_cfg):
    """(mean L1, mean PSNR) of ``cams`` on the loop's clip-free eval
    layout."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.train.loop import (
        adaptive_eval_layout, evaluate_split)
    from mvs_gaussian_splatting_tpu_torch.train.step import make_eval_metrics
    dev = torch.device("cuda")
    n = params.xyz.shape[0]
    layout, cap = adaptive_eval_layout(params, aux, cams, eval_cfg, n)
    return evaluate_split(make_eval_metrics(eval_cfg), params, aux, cams,
                          torch.zeros(3, device=dev), 3, dev,
                          instance_cap=cap, tier_layout=layout)


def kernels_on_views(params, aux, cams, base_cfg, seed, libs):
    """The training kernels alone on each camera's stream, at the instance
    cap the loop settles on for that load: B2, and B3f and B3b (each fast
    backward given its own forward's outputs), each kernel's time over
    repeated launches, its plain version's time, its gap and its bound; and
    B1's time and bound on the same streams, beside B3f's. With ``libs`` =
    (the kernel library, its section-clock build): B2's, B3f's and B3b's
    section splits, and the SM clock while B3b runs on the first stream."""
    import torch

    from mvs_gaussian_splatting_tpu_torch import profile_kernels
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        activated, get_features)
    from mvs_gaussian_splatting_tpu_torch.ops import stream
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
        bin_and_pack_stream
    from mvs_gaussian_splatting_tpu_torch.ops.render import render
    from mvs_gaussian_splatting_tpu_torch.train.loop import _instance_bucket
    dev = torch.device("cuda")
    bg = torch.zeros(3, device=dev)
    rows, reps = [], 5
    for k, cam in enumerate(cams):
        view = cam.view(dev)
        w, h = cam.width, cam.height
        with torch.no_grad():
            probe = render(view, w, h, params, bg, sh_degree=3,
                           alive=aux.alive, raster_config=base_cfg)
            raster_cfg = base_cfg._replace(instance_cap=_instance_bucket(
                int(probe["instance_load"] + probe["overflow_capacity"]),
                params.xyz.shape[0], base_cfg))
            del probe
            tiles_x = -(-w // raster_cfg.tile_w)
            tiles_y = -(-h // raster_cfg.tile_h)
            t = tiles_x * tiles_y
            p = raster_cfg.tile_w * raster_cfg.tile_h
            s, r, o = activated(params)
            pre = preprocess(params.xyz, o, view, w, h, scales=s,
                             rotations=r, shs=get_features(params),
                             sh_degree=3, mask=aux.alive,
                             tile_w=raster_cfg.tile_w,
                             tile_h=raster_cfg.tile_h)
            bins, attrs = bin_and_pack_stream(pre, tiles_x, tiles_y,
                                              raster_cfg)
            overflow = int(bins.overflow_capacity)
            call = (attrs, bins.seg_start, bins.counts, bg,
                    torch.arange(t, dtype=torch.int32, device=dev), tiles_x,
                    raster_cfg.tile_w, raster_cfg.tile_h)
            g_out, g_tfin = cotangents(t, p, seed + 10 + k, dev)
            out, tfin = stream.composite_stream(*call)
            b1_ms = cuda_ms(lambda: stream.composite_stream(*call), reps)
            b2_ms = cuda_ms(lambda: stream.composite_stream_bwd(
                *call, out, tfin, g_out, g_tfin), reps)
            b2_plain_ms = cuda_ms(lambda: stream.composite_stream_bwd_plain(
                *call, out, tfin, g_out, g_tfin))
            chk = bwd_check(call, out, tfin, g_out, g_tfin)
            fout, ftfin = stream.composite_stream(*call, fast=True)
            b3f_ms = cuda_ms(lambda: stream.composite_stream(
                *call, fast=True), reps)
            ref, rtfin, fvisits = stream.composite_stream_fast_plain(
                *call, count_visits=True)
            b3f_plain_ms = cuda_ms(lambda: stream.composite_stream_fast_plain(
                *call))
            b3b_ms = cuda_ms(lambda: stream.composite_stream_bwd(
                *call, fout, ftfin, g_out, g_tfin, fast=True), reps)
            b3b_plain_ms = cuda_ms(
                lambda: stream.composite_stream_bwd_fast_plain(
                    *call, ref, rtfin, g_out, g_tfin))
            fchk = fast_check(call, g_out, g_tfin)
            splits = {
                "b2": profile_kernels.kernel_split(
                    *libs, "stream_bwd", call, (out, tfin, g_out, g_tfin)),
                "b3f": profile_kernels.kernel_split(*libs, "stream_fwd_fast",
                                                    call),
                "b3b": profile_kernels.kernel_split(
                    *libs, "stream_bwd_fast", call,
                    (fout, ftfin, g_out, g_tfin))}
            if k == 0:
                clock = profile_kernels.sm_clock_mhz(
                    lambda: profile_kernels.launch(
                        libs[0], "stream_bwd_fast", call,
                        (fout, ftfin, g_out, g_tfin)))
        entries = int(bins.counts.sum())
        bwd_bytes = (2 * 9 * 4 * entries + 3 * 4 * t
                     + (3 + 1 + 3 + 1) * 4 * t * p)
        fwd_bytes = 9 * 4 * entries + 3 * 4 * t + 3 * 4 + 16 * t * p
        b1_bound = bound(fwd_bytes, FLOPS_PER_PAIR * chk["visits"])
        b2_bound = bound(bwd_bytes, FLOPS_PER_PAIR_BWD * chk["visits"])
        b3f_bound = bound(fwd_bytes, FLOPS_PER_PAIR * fvisits)
        b3b_bound = bound(bwd_bytes, FLOPS_PER_PAIR_FAST_BWD * fvisits,
                          MMA_FLOPS_PER_PAIR * fvisits)
        rows.append({"view": cam.image_name,
                     "instance_cap": raster_cfg.instance_cap,
                     "overflow_capacity": overflow, "entries": entries,
                     "visits": chk["visits"], "fast_visits": fvisits,
                     "b1": {"ms": b1_ms, "bound_ms": b1_bound[0],
                            "bound_by": b1_bound[1]},
                     "b2": {"ms": b2_ms, "plain_ms": b2_plain_ms,
                            "bound_ms": b2_bound[0], "bound_by": b2_bound[1],
                            "bytes": bwd_bytes,
                            "rel_gap": chk["rel_gap"],
                            "max_abs_err": chk["max_abs_err"],
                            "zeros_outside": chk["zeros_outside"]},
                     "b3f": {"ms": b3f_ms, "plain_ms": b3f_plain_ms,
                             "bound_ms": b3f_bound[0],
                             "bound_by": b3f_bound[1],
                             "bytes": fwd_bytes,
                             "max_abs_err": fchk["fwd_max_abs"]},
                     "b3b": {"ms": b3b_ms, "plain_ms": b3b_plain_ms,
                             "bound_ms": b3b_bound[0],
                             "bound_by": b3b_bound[1],
                             "bytes": bwd_bytes,
                             "rel_gap": fchk["bwd_rel_gap"],
                             "max_abs_err": fchk["bwd_max_abs"],
                             "zeros_outside": fchk["zeros_outside"]},
                     "sections": splits})
        del bins, attrs, out, tfin, fout, ftfin, ref, rtfin, pre, call
    return rows, clock


def mean_kernel(rows, key):
    """A kernel's per-view numbers, averaged, in the ``kernels`` line's
    terms."""
    sub = [r[key] for r in rows]
    bound_ms = float(np.mean([v["bound_ms"] for v in sub]))
    return {"ms": float(np.mean([v["ms"] for v in sub])),
            "plain_ms": float(np.mean([v["plain_ms"] for v in sub])),
            "bound_ms": bound_ms,
            "bytes": float(np.mean([v["bytes"] for v in sub])),
            "bound_by": max(set(v["bound_by"] for v in sub),
                            key=[v["bound_by"] for v in sub].count)}


def resume_run(tmp, data, seed, name, flags=(), lr_scale=1.0,
               profile=False):
    """Resume the retained model's checkpoint through ``cli/train.py main``
    for RESUME_STEPS steps with ``flags`` after TRAIN_FLAGS and every
    learning rate scaled by ``lr_scale``; (params, aux, scene, history,
    launches counted from zero, seconds, peak memory)."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.cli.train import main as train_main
    from mvs_gaussian_splatting_tpu_torch.train.config import \
        OptimizationConfig
    opt = OptimizationConfig()
    lr_flags = []
    if lr_scale != 1.0:
        for flag in ("position_lr_init", "position_lr_final", "feature_lr",
                     "opacity_lr", "scaling_lr", "rotation_lr"):
            lr_flags += [f"--{flag}", repr(getattr(opt, flag) * lr_scale)]
    prof = (["--profile_dir", os.path.join(tmp, f"profile_{name}")]
            if profile else [])
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    params, aux, scene, hist = train_main(
        ["-s", data["dataset"], "-m", os.path.join(tmp, name),
         "--start_checkpoint", data["checkpoint"],
         "--iterations", str(RESUME_ITER + RESUME_STEPS),
         "--test_iterations", *(str(RESUME_ITER + k) for k in
                                (1, 10, 50, 100, RESUME_STEPS)),
         "--log_every", "1", "--seed", str(seed), *lr_flags, *prof,
         *TRAIN_FLAGS, *flags])
    torch.cuda.synchronize()
    return (params, aux, scene, hist, read_launches(), time.time() - t0,
            torch.cuda.max_memory_allocated())


def resume_arm(tmp, data, seed, name, flags, eval_cfg, before, faults):
    """One traced 200-step resume and its checks (fast or exact mode by
    ``flags``): (the phase's record, params, aux, the run's scene)."""
    params, aux, scene, hist, launches, train_s, peak = resume_run(
        tmp, data, seed, name, flags, profile=True)
    from mvs_gaussian_splatting_tpu_torch.train.loop import PROFILE_WINDOW
    trace = trace_summary(os.path.join(tmp, f"profile_{name}", "trace.json"))
    test, train = scene.get_test_cameras(), scene.get_train_cameras()
    after = {"test": evaluate(params, aux, test, eval_cfg),
             "train": evaluate(params, aux, train, eval_cfg)}
    losses = [v for _, v in hist["loss"]]
    bad_rows = sum(v for _, v in hist["nonfinite_grad_rows"])
    # step times after the traced window (the profiler slows its steps)
    untraced = [1e3 / r for i, r in hist["iter_time"]
                if i > RESUME_ITER + PROFILE_WINDOW[1]]
    rec = {"phase": name, "steps": RESUME_STEPS, "flags": list(flags),
           "gaussians": int(aux.alive.sum()), "test_views": len(test),
           "train_views": len(train), "psnr_before": before,
           "psnr_after": after,
           "loop_psnr": {"test": hist["psnr_test"],
                         "train_5_views": hist["psnr_train"]},
           "loss_first": losses[0], "loss_last": losses[-1],
           "nonfinite_grad_rows": bad_rows, "launches": launches,
           "step_ms_median_untraced": float(np.median(untraced)),
           "step_ms_quartiles_untraced": [
               float(np.percentile(untraced, 25)),
               float(np.percentile(untraced, 75))],
           "untraced_steps": len(untraced),
           "profile_iterations_100_120": trace,
           "train_seconds": round(train_s, 1), "peak_memory_bytes": peak}
    if not all(np.isfinite(losses)):
        faults.append(f"{name}: a non-finite loss")
    if bad_rows:
        faults.append(f"{name}: {bad_rows} non-finite gradient rows")
    # PR 4's criterion (test PSNR at most 0.1 dB below its start), restated
    # in ROADMAP.md section C: the 13 training views are views the flagship
    # never trained on, and 200 steps of its recipe fit them at the
    # held-out views' expense (PERF.md §6). A fault is a test drop over
    # 0.1 dB that the train gain does not exceed.
    gain = after["train"][1] - before["train"][1]
    drop = before["test"][1] - after["test"][1]
    if drop > 0.1 and drop > gain:
        faults.append(f"{name}: test PSNR {before['test'][1]} → "
                      f"{after['test'][1]} while train gained {gain}")
    if after["train"][1] < before["train"][1]:
        faults.append(f"{name}: train PSNR {before['train'][1]} → "
                      f"{after['train'][1]}")
    # one forward and one backward launch per step in the arm's mode, no
    # backward of the other mode; evals (exact) through B1 only
    if "--no-fast_math" in flags:
        want = {"stream_fwd_fast": 0, "stream_bwd_fast": 0,
                "stream_bwd": RESUME_STEPS}
    else:
        want = {"stream_fwd_fast": RESUME_STEPS,
                "stream_bwd_fast": RESUME_STEPS, "stream_bwd": 0}
    want.update(padded_fwd=0, padded_bwd=0)
    if any(launches[k] != v for k, v in want.items()) or not (
            launches["stream_fwd"] > 0):
        faults.append(f"{name}: launches {launches}, want {want} and "
                      "evals through stream_fwd")
    return rec, params, aux, scene


def train_resume(tmp, data, seed, faults, libs):
    """Phase 7: resume the retained model and train it 200 steps in the
    default fast-math mode and in exact mode, each traced at its
    iterations 100-120; the training kernels on 5 views' streams (``libs``:
    see kernels_on_views); then the exact resume at a tenth of every
    learning rate, measured only."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.data.scene import Scene
    from mvs_gaussian_splatting_tpu_torch.train.checkpoint import \
        load_checkpoint
    from mvs_gaussian_splatting_tpu_torch.train.config import (
        ModelConfig, PipelineConfig)
    from mvs_gaussian_splatting_tpu_torch.train.loop import (
        eval_config, raster_config_from_pipe)
    pipe = PipelineConfig(tile_w=32, tile_h=16, max_tiles_per_gaussian=512,
                          tier_budgets=(4, 12, 64),
                          tier_fracs=(0.25, 0.1, 0.01))
    raster_cfg = raster_config_from_pipe(pipe)._replace(fast_math=False)
    eval_cfg = eval_config(raster_cfg)
    dev = torch.device("cuda")
    # the views before training (their order does not matter here)
    scene = Scene(ModelConfig(source_path=data["dataset"], eval=True,
                              resolution=1), shuffle=False)
    test, train = scene.get_test_cameras(), scene.get_train_cameras()
    p0, _, aux0, _, _ = load_checkpoint(data["checkpoint"], dev)
    before = {"test": evaluate(p0, aux0, test, eval_cfg),
              "train": evaluate(p0, aux0, train, eval_cfg)}
    del p0, aux0

    fast_rec, _, _, _ = resume_arm(tmp, data, seed, "train_resume_fast",
                                   [], eval_cfg, before, faults)
    emit(fast_rec)
    exact_rec, params, aux, run_scene = resume_arm(
        tmp, data, seed, "train_resume", ["--no-fast_math"], eval_cfg,
        before, faults)
    arms = {"fast": fast_rec, "exact": exact_rec}
    gaps = {split: arms["fast"]["psnr_after"][split][1]
            - arms["exact"]["psnr_after"][split][1]
            for split in ("test", "train")}
    if max(abs(v) for v in gaps.values()) > ARM_PSNR:
        faults.append(f"fast vs exact arm: final PSNR gaps {gaps}")
    # the 5 views PR 4 timed B2 on: the first of the run's seeded order
    rows, clock = kernels_on_views(
        params, aux, run_scene.get_train_cameras()[:5], raster_cfg, seed,
        libs)
    result = {"launches": {k: v["launches"] for k, v in arms.items()},
              "step_ms_fast": fast_rec["step_ms_median_untraced"],
              "b2": mean_kernel(rows, "b2"), "b3f": mean_kernel(rows, "b3f"),
              "b3b": mean_kernel(rows, "b3b"), "clock": clock,
              "sections": {k: [r["sections"][k] for r in rows]
                           for k in ("b2", "b3f", "b3b")}}
    result["b2"]["max_abs_err"] = max(r["b2"]["max_abs_err"] for r in rows)
    result["b3f"]["max_abs_err"] = max(r["b3f"]["max_abs_err"] for r in rows)
    result["b3b"]["max_abs_err"] = max(r["b3b"]["max_abs_err"] for r in rows)
    exact_rec.update({"kernels_on_views": [
                          {k: v for k, v in r.items() if k != "sections"}
                          for r in rows],
                      "kernels": {k: result[k] for k in
                                  ("b2", "b3f", "b3b")},
                      "b1_ms_on_train_views": float(np.mean(
                          [r["b1"]["ms"] for r in rows])),
                      "b2_max_rel_gap": max(max(r["b2"]["rel_gap"])
                                            for r in rows),
                      "fast_minus_exact_psnr": gaps,
                      "step_ms_median_untraced_fast":
                          fast_rec["step_ms_median_untraced"]})
    emit(exact_rec)
    for r in rows:
        if max(r["b2"]["rel_gap"]) > BWD_REL or not r["b2"]["zeros_outside"]:
            faults.append(f"backward kernel vs plain on {r['view']}: "
                          f"{r['b2']['rel_gap']}")
        if (r["b3f"]["max_abs_err"] > FAST_TOL
                or max(r["b3b"]["rel_gap"]) > FAST_REL
                or not r["b3b"]["zeros_outside"]):
            faults.append(f"fast kernels vs plain on {r['view']}: "
                          f"{r['b3f']}, {r['b3b']}")
        if r["overflow_capacity"]:
            faults.append(f"training kernels on {r['view']}: capacity "
                          f"overflow {r['overflow_capacity']}")
    del params, aux

    # the control: the exact resume at a tenth of every learning rate
    params, aux, _, hist, _, train_s, _ = resume_run(
        tmp, data, seed, "resume_lr_tenth", ["--no-fast_math"], lr_scale=0.1)
    emit({"phase": "train_resume_lr_tenth", "steps": RESUME_STEPS,
          "psnr_after": {"test": evaluate(params, aux, test, eval_cfg),
                         "train": evaluate(params, aux, train, eval_cfg)},
          "loop_psnr": {"test": hist["psnr_test"],
                        "train_5_views": hist["psnr_train"]},
          "train_seconds": round(train_s, 1)})
    return result


def trace_summary(path, top=12):
    """Device time by kernel over a torch.profiler chrome trace: the busy
    share of the window (first kernel start to last kernel end), the
    kernels that took most of it, and per step the host time of each of
    train_step's profiler ranges and the device time of the work launched
    inside it (on any thread: the backward runs on autograd's)."""
    from mvs_gaussian_splatting_tpu_torch.tools.measure import (
        busy_window, trace_events)
    events, dev = trace_events(path)
    if not dev:
        return {"device_events": 0}
    window, busy = busy_window(dev)
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    phases = {}
    for span in (e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name", "").startswith("train_step/")):
        lo, hi = span["ts"], span["ts"] + span["dur"]
        ph = phases.setdefault(span["name"], {"steps": 0, "host_us": 0.0,
                                              "device_us": 0.0})
        ph["steps"] += 1
        ph["host_us"] += span["dur"]
        ph["device_us"] += sum(
            e["dur"] for e in dev
            if lo <= launched.get(e.get("args", {}).get("correlation"),
                                  -1.0) <= hi)
    phases = {name: {"steps": ph["steps"],
                     "host_ms_per_step": ph["host_us"] / ph["steps"] / 1e3,
                     "device_ms_per_step": ph["device_us"] / ph["steps"]
                     / 1e3}
              for name, ph in sorted(phases.items())}
    return {"device_events": len(dev), "window_ms": window / 1e3,
            "busy_ms": busy / 1e3, "busy_share": busy / window,
            "top_ms": [[name[:90], us / 1e3] for name, us in ranked],
            "train_step_phases": phases,
            "train_step_device_ms": sum(ph["device_ms_per_step"]
                                        for ph in phases.values())}


def train_init(tmp, data, seed, faults):
    """Phase 8: train from 54,000 points with densification, in the default
    fast-math mode."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.cli.train import main as train_main
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    params, aux, _, hist = train_main(
        ["-s", data["dataset"], "-m", os.path.join(tmp, "init"),
         "--iterations", str(INIT_STEPS), "--densify_from_iter", "100",
         "--densification_interval", "100", "--test_iterations", "1",
         str(INIT_STEPS), "--log_every", "10", "--seed", str(seed),
         "--profile_dir", os.path.join(tmp, "profile"), *TRAIN_FLAGS])
    torch.cuda.synchronize()
    launches = read_launches()
    losses = [v for _, v in hist["loss"]]
    ema = 0.0
    for v in losses:
        ema = 0.4 * v + 0.6 * ema
    dens = hist.get("densify", [])
    finite = all(bool(torch.isfinite(a).all()) for a in params
                 if a is not None)
    psnr = {int(k): v for k, v in hist["psnr_test"].items()}
    emit({"phase": "train_init", "steps": INIT_STEPS,
          "capacity": int(params.xyz.shape[0]),
          "alive_final": int(aux.alive.sum()), "densify": dens,
          "loss_first": losses[0], "loss_ema_final": ema,
          "psnr_test": psnr, "params_finite": finite, "launches": launches,
          "nonfinite_grad_rows": sum(v for _, v in
                                     hist["nonfinite_grad_rows"]),
          "step_ms_median": float(np.median([1e3 / r for _, r in
                                             hist["iter_time"]])),
          "seconds": round(time.time() - t0, 1),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "profile_iterations_100_120": trace_summary(
              os.path.join(tmp, "profile", "trace.json"))})
    if not any(d["n_cloned"] + d["n_split"] for d in dens):
        faults.append(f"train_init: densification never cloned or split "
                      f"{dens}")
    if not dens or dens[-1]["n_alive"] == INIT_POINTS:
        faults.append("train_init: the alive count never changed")
    if not ema < LOSS_DROP * losses[0]:
        faults.append(f"train_init: loss EMA {ema} vs first {losses[0]}")
    if not psnr[INIT_STEPS] > psnr[1]:
        faults.append(f"train_init: test PSNR {psnr}")
    if not finite:
        faults.append("train_init: non-finite parameters")
    if (launches["stream_bwd_fast"] != INIT_STEPS
            or launches["stream_fwd_fast"] != INIT_STEPS
            or launches["stream_bwd"]):
        faults.append(f"train_init: launches {launches}, want one fast "
                      "forward and backward per step and no exact backward")
    return {"launches": launches}


def padded_tables(params, cam, cfg):
    """(planes, rgb, valid, counts) of one view on the padded layout
    ``cfg``, as ``rasterize`` builds them for B4, and the bins."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        activated, get_features)
    from mvs_gaussian_splatting_tpu_torch.ops.binning import bin_gaussians
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import gather_tables
    dev = params.xyz.device
    with torch.no_grad():
        s, r, o = activated(params)
        pre = preprocess(params.xyz, o, cam.view(dev), cam.width, cam.height,
                         scales=s, rotations=r, shs=get_features(params),
                         sh_degree=3, tile_w=cfg.tile_w, tile_h=cfg.tile_h)
        tiles_x = -(-cam.width // cfg.tile_w)
        tiles_y = -(-cam.height // cfg.tile_h)
        bins = bin_gaussians(pre, tiles_x, tiles_y,
                             cfg.max_tiles_per_gaussian, cfg.tile_capacity,
                             tile_w=cfg.tile_w, tile_h=cfg.tile_h)
        cols = gather_tables(pre, bins)
        return (cols[:6], cols[6:9].permute(1, 2, 0).contiguous(),
                bins.valid.to(torch.float32), bins.counts, tiles_x), bins


def padded_phase(params, test_cams, free_cfg, data, tmp, seed, faults,
                 libs):
    """Phase 9: the padded backend (B4 / B5) renders test views on a
    layout without overflow, against the stream render, then trains.
    ``libs``: see kernels_on_views (B4's and B5's section splits)."""
    import torch

    from mvs_gaussian_splatting_tpu_torch import profile_kernels
    from mvs_gaussian_splatting_tpu_torch.cli.render import \
        measure_tile_needs
    from mvs_gaussian_splatting_tpu_torch.cli.train import main as train_main
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        activated, get_features)
    from mvs_gaussian_splatting_tpu_torch.ops.binning import ENUM_BLOCK
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
        bin_and_pack_stream
    from mvs_gaussian_splatting_tpu_torch.ops.render import render
    dev = torch.device("cuda")
    n = int(params.xyz.shape[0])
    tw, th = free_cfg.tile_w, free_cfg.tile_h
    # the views whose widest splat spans the fewest tiles: bin_gaussians
    # enumerates N × (that span) instance keys
    need = [int(measure_tile_needs(params, [c], tw, th).max())
            for c in test_cams]
    pick = [int(i) for i in np.argsort(need, kind="stable")[:PADDED_VIEWS]]
    views = [test_cams[i] for i in pick]
    d = max(need[i] for i in pick)
    bg = torch.zeros(3, device=dev)
    stream_imgs, stream_rows, k_need, load = [], [], 0, 0
    with torch.no_grad():
        s, r, o = activated(params)
        for cam in views:
            out = render(cam.view(dev), cam.width, cam.height, params, bg,
                         sh_degree=3, raster_config=free_cfg)
            stream_imgs.append(out["render"])
            stream_rows.append({
                "overflow_tiles": int(out["overflow_tiles"]),
                "overflow_capacity": int(out["overflow_capacity"])})
            load = max(load, int(out["instance_load"]))
            pre = preprocess(params.xyz, o, cam.view(dev), cam.width,
                             cam.height, scales=s, rotations=r,
                             shs=get_features(params), sh_degree=3,
                             tile_w=tw, tile_h=th)
            bins, attrs = bin_and_pack_stream(pre, -(-cam.width // tw),
                                              -(-cam.height // th), free_cfg)
            k_need = max(k_need, int(bins.counts_raw.max()))
            del pre, bins, attrs
    k = k_need + (-k_need) % 32
    cfg = free_cfg._replace(backend="pallas", max_tiles_per_gaussian=d,
                            tile_capacity=k)
    keys = n * d
    # bin_gaussians enumerates the N x d instances in blocks of ENUM_BLOCK,
    # about 64 bytes of temporaries each, and sorts the valid ones (as many
    # as the clip-free stream's instances): int64 keys, their sorted copy
    # and its int64 indices
    reckoned = min(keys, ENUM_BLOCK) * 64 + load * (8 + 8 + 8)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    rows = []
    with torch.no_grad():
        for cam, ref, srow in zip(views, stream_imgs, stream_rows):
            t0 = time.perf_counter()
            out = render(cam.view(dev), cam.width, cam.height, params, bg,
                         sh_degree=3, raster_config=cfg)
            torch.cuda.synchronize()
            rows.append({"view": cam.image_name,
                         "render_ms": (time.perf_counter() - t0) * 1e3,
                         "max_abs_vs_stream": float(
                             (out["render"] - ref).abs().max()),
                         "overflow_tiles": int(out["overflow_tiles"]),
                         "overflow_capacity": int(out["overflow_capacity"]),
                         "stream": srow})
    render_launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    args, bins = padded_tables(params, views[0], cfg)
    args = list(args[:4]) + [bg, args[4], tw, th]
    chk = padded_check(args, seed + 7, timed=True)
    splits = {"b4": profile_kernels.kernel_split(*libs, "padded_fwd", args),
              "b5": profile_kernels.kernel_split(*libs, "padded_bwd", args,
                                                 chk.pop("b5_inputs"))}
    slots = int(bins.valid.numel())
    del args, bins

    reset_launches()
    t0 = time.time()
    _, _, _, hist = train_main(
        ["-s", data["dataset"], "-m", os.path.join(tmp, "padded"),
         "--start_checkpoint", data["checkpoint"],
         "--iterations", str(RESUME_ITER + PADDED_STEPS), "--log_every", "1",
         "--seed", str(seed), *TRAIN_FLAGS, "--backend", "pallas"])
    torch.cuda.synchronize()
    train_launches = read_launches()
    losses = [v for _, v in hist["loss"]]
    launches = {key: render_launches[key] + train_launches[key]
                for key in render_launches}
    emit({"phase": "padded", "views": rows, "max_tiles_per_gaussian": d,
          "tile_capacity": k, "enumerated_instances": keys,
          "valid_instances": load, "reckoned_bytes": reckoned,
          "peak_memory_bytes": peak, "held_before_bytes": held,
          "table_slots": slots, "tables_check": {
              key: v for key, v in chk.items()
              if not key.endswith(("_ms", "_bound", "_bytes"))},
          "b4": {"ms": chk["b4_ms"], "plain_ms": chk["b4_plain_ms"],
                 "bound_ms": chk["b4_bound"][0],
                 "bound_by": chk["b4_bound"][1]},
          "b5": {"ms": chk["b5_ms"], "plain_ms": chk["b5_plain_ms"],
                 "bound_ms": chk["b5_bound"][0],
                 "bound_by": chk["b5_bound"][1]},
          "train_steps": PADDED_STEPS, "train_losses": losses,
          "train_seconds": round(time.time() - t0, 1),
          "launches": {"render": render_launches, "train": train_launches}})
    for row in rows:
        if (row["max_abs_vs_stream"] > TOL or row["overflow_tiles"]
                or row["overflow_capacity"] or any(row["stream"].values())):
            faults.append(f"padded render of {row['view']}: {row}")
    if (chk["fwd_max_abs"] > TOL or max(chk["bwd_rel_gap"]) > BWD_REL
            or not chk["zeros_dead"] or not chk["deterministic"]):
        faults.append(f"padded kernels vs plain on {views[0].image_name}: "
                      f"{chk}")
    if len(losses) != PADDED_STEPS or not all(np.isfinite(losses)):
        faults.append(f"padded training losses {losses}")
    if (render_launches["padded_fwd"] != len(views)
            or train_launches["padded_fwd"] != PADDED_STEPS
            or train_launches["padded_bwd"] != PADDED_STEPS):
        faults.append(f"padded launches: render {render_launches}, train "
                      f"{train_launches}")
    return {"launches": launches, "sections": splits,
            "b4": {"ms": chk["b4_ms"], "plain_ms": chk["b4_plain_ms"],
                   "bound_ms": chk["b4_bound"][0],
                   "bound_by": chk["b4_bound"][1],
                   "bytes": chk["b4_bytes"],
                   "max_abs_err": chk["fwd_max_abs"]},
            "b5": {"ms": chk["b5_ms"], "plain_ms": chk["b5_plain_ms"],
                   "bound_ms": chk["b5_bound"][0],
                   "bound_by": chk["b5_bound"][1],
                   "bytes": chk["b5_bytes"],
                   "max_abs_err": chk["max_abs_err"]}}


def padded_cli(tmp, data, faults):
    """Phase 9b: ``cli/render.py --backend pallas`` as a user runs it on the
    retained model, on the 15 views of the training dataset (13 train, 2
    test) at the CLI's own measured layout and default tile capacity:
    its clipping is counted, not held. Checks one B4 launch per view and no
    other kernel."""
    import contextlib
    import io

    import torch

    from mvs_gaussian_splatting_tpu_torch.cli.render import \
        main as render_main
    model = os.path.join(tmp, "cli_model")
    os.makedirs(model)
    os.symlink(os.path.join(MODEL, "point_cloud_final.ply.gz"),
               os.path.join(model, "point_cloud_final.ply.gz"))
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    log = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(log):
        overflow = render_main(["-m", model, "-s", data["dataset"], "--eval",
                                "--backend", "pallas"])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = read_launches()
    psnrs = {}
    for split, ov in overflow.items():
        out = os.path.join(model, split, "ours_final")
        psnrs[split] = [psnr(load_png(os.path.join(out, "renders", name)),
                             load_png(os.path.join(out, "gt", name)))[0]
                        for name in (f"{i:05d}.png"
                                     for i in range(ov["views"]))]
    views = sum(ov["views"] for ov in overflow.values())
    emit({"phase": "padded_cli", "log": log.getvalue().splitlines(),
          "overflow": overflow, "psnr_gt": psnrs, "launches": launches,
          "seconds": round(seconds, 2),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "held_before_bytes": held})
    want = dict.fromkeys(KERNELS, 0)
    want["padded_fwd"] = views
    if views != 15 or launches != want:
        faults.append(f"padded CLI render: {views} views, launches "
                      f"{launches}, want {want}")
    if not all(p is not None and np.isfinite(p) for v in psnrs.values()
               for p in v):
        faults.append(f"padded CLI render: PSNR {psnrs}")
    return {"launches": launches}


def large_kernel_check(tw, th, seed):
    """All six kernels at ``tw`` × ``th`` tiles on a random stream (a fifth
    of its entries far-centred wide splats) and random tables, against their
    plain versions (each backward given its own forward's outputs), and two
    launches of each compared to the bit."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.ops import composite, stream
    dev = torch.device("cuda")
    syn = stream.random_stream(seed, tiles_x=4, tiles_y=3, tile_w=tw,
                               tile_h=th, far=0.2)
    a = tuple(torch.from_numpy(syn[k]).to(dev) for k in
              ("attrs", "seg_start", "counts", "bg", "tile_ids")) + (
        syn["tiles_x"], tw, th)
    t, p = a[1].shape[0], tw * th
    g_out, g_tfin = cotangents(t, p, seed + 20, dev)
    res = {"parts": stream.tile_parts(tw, th),
           "parts_b3b": stream.tile_parts(tw, th, stream.FAST_BWD_SIDE)}
    out, tfin = stream.composite_stream(*a)
    again = stream.composite_stream(*a)
    ref, rtfin = stream.composite_stream_plain(*a)
    res["b1"] = {"max_abs": max(float((out - ref).abs().max()),
                                float((tfin - rtfin).abs().max())),
                 "deterministic": bool(torch.equal(out, again[0])
                                       and torch.equal(tfin, again[1]))}
    res["b2"] = bwd_check(a, out, tfin, g_out, g_tfin)
    fout, ftfin = stream.composite_stream(*a, fast=True)
    fagain = stream.composite_stream(*a, fast=True)
    gf = stream.composite_stream_bwd(*a, fout, ftfin, g_out, g_tfin,
                                     fast=True)[0]
    gf2 = stream.composite_stream_bwd(*a, fout, ftfin, g_out, g_tfin,
                                      fast=True)[0]
    chk = fast_check(a, g_out, g_tfin)
    res["b3f"] = {"max_abs": chk["fwd_max_abs"],
                  "deterministic": bool(torch.equal(fout, fagain[0])
                                        and torch.equal(ftfin, fagain[1]))}
    res["b3b"] = {"rel_gap": chk["bwd_rel_gap"],
                  "zeros_outside": chk["zeros_outside"],
                  "deterministic": bool(torch.equal(gf, gf2))}
    tab = composite.random_tables(seed, tiles_x=4, tiles_y=3, tile_w=tw,
                                  tile_h=th, k=384)
    args = [torch.from_numpy(tab[k]).to(dev) for k in
            ("planes", "rgb", "valid", "counts", "bg")] + [4, tw, th]
    pchk = padded_check(args, seed + 21)
    b4 = composite._padded_fwd(*args)
    b4_again = composite._padded_fwd(*args)
    torch.cuda.synchronize()
    res["b4"] = {"max_abs": pchk["fwd_max_abs"],
                 "deterministic": bool(torch.equal(b4[0], b4_again[0])
                                       and torch.equal(b4[1], b4_again[1]))}
    res["b5"] = {"rel_gap": pchk["bwd_rel_gap"],
                 "zeros_dead": pchk["zeros_dead"],
                 "deterministic": pchk["deterministic"]}
    faults = []
    if res["b1"]["max_abs"] > TOL or res["b4"]["max_abs"] > TOL:
        faults.append("B1/B4 vs plain")
    if res["b3f"]["max_abs"] > FAST_TOL:
        faults.append("B3f vs plain")
    if (max(res["b2"]["rel_gap"]) > BWD_REL or not res["b2"]["zeros_outside"]
            or max(res["b5"]["rel_gap"]) > BWD_REL
            or not res["b5"]["zeros_dead"]):
        faults.append("B2/B5 vs plain")
    if (max(res["b3b"]["rel_gap"]) > FAST_REL
            or not res["b3b"]["zeros_outside"]):
        faults.append("B3b vs plain")
    if not all(res[k]["deterministic"] for k in
               ("b1", "b2", "b3f", "b3b", "b4", "b5")):
        faults.append("two launches differ")
    return res, faults


def clip_free_layout(params, cams, cfg_base, tw, th):
    """The offline eval layout at ``tw`` × ``th`` tiles with the 16M slot
    limit lifted (clip-free), as phase 4b makes it at 16×16."""
    from mvs_gaussian_splatting_tpu_torch.cli.render import (
        adaptive_eval_config, measure_tile_needs)
    base = cfg_base._replace(tile_w=tw, tile_h=th)
    return adaptive_eval_config(base, measure_tile_needs(params, cams, tw, th),
                                log=lambda *_: None, slot_limit=1 << 28)


def large_tiles(params, cams, test_cams, cfg_base, data, tmp, seed, faults,
                lib):
    """Phase 11: tiles of more than 1,024 pixels. Every kernel against its
    plain version at LARGE_TILES, and B1 on a real view's 64×32 stream;
    then, counted as a main path: the test views rendered clip-free at
    64×32 on the stream backend (finite, no overflow; PSNR against ground
    truth and the gap to the 16×16 render reported: the reference's image
    depends on the tile shape, as splats reach past 3 sigma in a larger
    tile) and 3 of them on the padded backend, within 2e-4 max abs of the
    stream's, and LARGE_STEPS training steps at 64×32 in fast, exact and
    ``--backend pallas`` mode; then each kernel's time on the first test
    view at 16×16 and 64×32, clip-free."""
    import torch

    from mvs_gaussian_splatting_tpu_torch import profile_kernels
    from mvs_gaussian_splatting_tpu_torch.cli.render import (
        measure_tile_needs, quantize_image)
    from mvs_gaussian_splatting_tpu_torch.cli.train import main as train_main
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        activated, get_features)
    from mvs_gaussian_splatting_tpu_torch.ops import stream
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
        bin_and_pack_stream
    from mvs_gaussian_splatting_tpu_torch.ops.render import render
    dev = torch.device("cuda")
    t0 = time.time()
    checks = {}
    for tw, th in LARGE_TILES:
        res, bad = large_kernel_check(tw, th, seed)
        checks[f"{tw}x{th}"] = res
        faults += [f"large tiles {tw}x{th}: {b}: {res}" for b in bad]
    bg = torch.zeros(3, device=dev)
    free16 = clip_free_layout(params, cams, cfg_base, 16, 16)
    free64 = clip_free_layout(params, cams, cfg_base, 64, 32)
    # the padded views: those whose widest splat spans the fewest 64 x 32
    # tiles (bin_gaussians enumerates N x that span keys), K their fullest
    # tile
    need = [int(measure_tile_needs(params, [c], 64, 32).max())
            for c in test_cams]
    pick = [int(i) for i in np.argsort(need, kind="stable")[:PADDED_VIEWS]]
    k_need = 0
    with torch.no_grad():
        s, r, o = activated(params)
        for i in pick:
            cam = test_cams[i]
            tx, ty = -(-cam.width // 64), -(-cam.height // 32)
            pre = preprocess(params.xyz, o, cam.view(dev), cam.width,
                             cam.height, scales=s, rotations=r,
                             shs=get_features(params), sh_degree=3,
                             tile_w=64, tile_h=32)
            bins, attrs = bin_and_pack_stream(pre, tx, ty, free64)
            k_need = max(k_need, int(bins.counts_raw.max()))
            if i == pick[0]:      # B1 against its plain version, real view
                call = (attrs, bins.seg_start, bins.counts, bg,
                        torch.arange(tx * ty, dtype=torch.int32,
                                     device=dev), tx, 64, 32)
                got = stream.composite_stream(*call)
                want = stream.composite_stream_plain(*call)
                checks["real_view_64x32_b1_max_abs"] = max(
                    float((a - b).abs().max()) for a, b in zip(got, want))
                del call, got, want
            del pre, bins, attrs
    if checks["real_view_64x32_b1_max_abs"] > TOL:
        faults.append(f"large tiles, B1 on a real view: "
                      f"{checks['real_view_64x32_b1_max_abs']}")
    pad64 = free64._replace(backend="pallas",
                            max_tiles_per_gaussian=max(need[i] for i in pick),
                            tile_capacity=k_need + (-k_need) % 32)
    reset_launches()
    rows = []
    with torch.no_grad():
        for k, cam in enumerate(test_cams):
            gt = load_png(os.path.join(VIEWS, "gt", f"{k:05d}.png"))
            imgs, row = {}, {"view": cam.image_name}
            cfgs = {"stream_16x16": free16, "stream_64x32": free64}
            if k in pick:
                cfgs["padded_64x32"] = pad64
            for name, cfg in cfgs.items():
                out = render(cam.view(dev), cam.width, cam.height, params, bg,
                             sh_degree=3, raster_config=cfg)
                imgs[name] = out["render"]
                row[name] = {
                    "psnr_gt": psnr(quantize_image(out["render"]), gt)[0],
                    "overflow": int(out["overflow_tiles"])
                    + int(out["overflow_capacity"]),
                    "finite": bool(torch.isfinite(out["render"]).all())}
            row["max_abs_64x32_vs_16x16"] = float(
                (imgs["stream_64x32"] - imgs["stream_16x16"]).abs().max())
            if k in pick:
                row["max_abs_padded_vs_stream_64x32"] = float(
                    (imgs["padded_64x32"] - imgs["stream_64x32"]).abs().max())
            rows.append(row)
            del imgs, out
    render_launches = read_launches()
    runs = {}
    for name, flags in (("fast", []), ("exact", ["--no-fast_math"]),
                        ("pallas", ["--backend", "pallas"])):
        reset_launches()
        _, _, _, hist = train_main(
            ["-s", data["dataset"], "-m", os.path.join(tmp, f"large_{name}"),
             "--start_checkpoint", data["checkpoint"],
             "--iterations", str(RESUME_ITER + LARGE_STEPS),
             "--log_every", "1", "--seed", str(seed), *TRAIN_FLAGS,
             "--tile_w", "64", "--tile_h", "32", *flags])
        torch.cuda.synchronize()
        runs[name] = {"losses": [v for _, v in hist["loss"]],
                      "nonfinite_grad_rows": sum(
                          v for _, v in hist["nonfinite_grad_rows"]),
                      "launches": read_launches()}
    launches = {key: render_launches[key]
                + sum(r["launches"][key] for r in runs.values())
                for key in render_launches}
    # each kernel alone on the first test view, clip-free, at both shapes
    times = {}
    with torch.no_grad():
        cam = test_cams[0]
        for tw, th, cfg in ((16, 16, free16), (64, 32, free64)):
            tx, ty = -(-cam.width // tw), -(-cam.height // th)
            pre = preprocess(params.xyz, o, cam.view(dev), cam.width,
                             cam.height, scales=s, rotations=r,
                             shs=get_features(params), sh_degree=3,
                             tile_w=tw, tile_h=th)
            bins, attrs = bin_and_pack_stream(pre, tx, ty, cfg)
            call = (attrs, bins.seg_start, bins.counts, bg,
                    torch.arange(tx * ty, dtype=torch.int32, device=dev),
                    tx, tw, th)
            tables = profile_kernels.tables_from_stream(call)
            b = {"stream_bwd": profile_kernels.backward_inputs(
                     lib, call, seed, "stream_fwd"),
                 "stream_bwd_fast": profile_kernels.backward_inputs(
                     lib, call, seed),
                 "padded_bwd": profile_kernels.backward_inputs(
                     lib, tables, seed, "padded_fwd")}
            times[f"{tw}x{th}"] = {
                "entries": int(bins.counts.sum()),
                "table_slots": int(tables[2].numel()),
                **{key: profile_kernels.kernel_split(
                       lib, None, key,
                       tables if key.startswith("padded") else call,
                       b.get(key))["ms"] for key in KERNELS}}
            del pre, bins, attrs, call, tables, b
    emit({"phase": "large_tiles", "kernels_vs_plain": checks,
          "tolerances": {"tol": TOL, "bwd_rel": BWD_REL,
                         "fast_tol": FAST_TOL, "fast_rel": FAST_REL},
          "renders": rows, "padded_views": pick,
          "padded_64x32": {"max_tiles_per_gaussian":
                           pad64.max_tiles_per_gaussian,
                           "tile_capacity": pad64.tile_capacity},
          "train": runs, "launches": launches, "kernel_ms_alone": times,
          "seconds": round(time.time() - t0, 1)})
    for row in rows:
        if (any(v["overflow"] or not v["finite"]
                for k, v in row.items() if k.startswith(("stream", "padded")))
                or row.get("max_abs_padded_vs_stream_64x32", 0.0) > TOL):
            faults.append(f"large tiles, render of {row['view']}: {row}")
    want = {"fast": ("stream_fwd_fast", "stream_bwd_fast"),
            "exact": ("stream_fwd", "stream_bwd"),
            "pallas": ("padded_fwd", "padded_bwd")}
    for name, run in runs.items():
        if (len(run["losses"]) != LARGE_STEPS
                or not all(np.isfinite(run["losses"]))
                or run["nonfinite_grad_rows"]
                or run["launches"][want[name][0]] < LARGE_STEPS
                or run["launches"][want[name][1]] != LARGE_STEPS):
            faults.append(f"large tiles, {name} training at 64x32: {run}")
    if render_launches["padded_fwd"] != len(pick) or render_launches[
            "stream_fwd"] != 2 * len(test_cams):
        faults.append(f"large tiles, render launches {render_launches}")
    return {"launches": launches}


def dataset_phase(tmp, faults):
    """Phase 12: the flagship's dataset regenerated by the port's
    ``ref_scale_validation.write_dataset`` (120 views at 1237×822, 150,000
    GT points, 54,000 init points, seed 0, the specular style, the TPU
    run's operator: stream, exact, 32×16 tiles): each of the 15 test views
    within 45 dB of the retained ground truth, every pose equal to
    ``cameras.json``'s."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.ref_scale_validation import (
        orbit_cameras, write_dataset)
    from mvs_gaussian_splatting_tpu_torch.utils.graphics import fov2focal
    out = os.path.join(tmp, "flagship")
    size = {k: FLAGSHIP[k] for k in ("width", "height", "n_views", "n_gt",
                                     "n_init", "seed", "style")}
    reset_launches()
    torch.cuda.synchronize()
    timing = write_dataset(out, **size, log=lambda s: None)
    launches = read_launches()
    views = []
    for k, i in enumerate(range(0, FLAGSHIP["n_views"], LLFFHOLD)):
        got = load_png(os.path.join(out, "images", f"view_{i:04d}.png"))
        p, mse = psnr(got, load_png(os.path.join(VIEWS, "gt",
                                                 f"{k:05d}.png")))
        views.append({"view": f"view_{i:04d}", "psnr_vs_kept_gt": p,
                      "mse": mse})
    # the poses: cameras.json holds each view's camera-to-world pose
    orbit = orbit_cameras(FLAGSHIP["n_views"], FLAGSHIP["width"],
                          FLAGSHIP["height"], 65.0, FLAGSHIP["seed"] + 1)
    with open(os.path.join(MODEL, "cameras.json")) as f:
        entries = json.load(f)
    pose_gap = 0.0
    for e in entries:
        R, t, fovx, fovy = orbit[int(e["img_name"][len("view_"):])]
        pose_gap = max(pose_gap,
                       float(np.abs(np.asarray(e["rotation"]) - R.T).max()),
                       float(np.abs(np.asarray(e["position"])
                                    + R.T @ t).max()),
                       abs(e["fx"] - fov2focal(fovx, e["width"])) / e["fx"],
                       abs(e["fy"] - fov2focal(fovy, e["height"])) / e["fy"])
    emit({"phase": "dataset", "size": size, "test_views": views,
          "min_psnr": min(v["psnr_vs_kept_gt"] or float("inf")
                          for v in views),
          "poses": len(entries), "pose_max_gap": pose_gap,
          "seconds": timing["seconds"],
          "render_seconds": timing["render_seconds"], "launches": launches})
    for v in views:
        if v["psnr_vs_kept_gt"] is not None and v["psnr_vs_kept_gt"] < 45.0:
            faults.append(f"dataset: {v['view']} at {v['psnr_vs_kept_gt']} "
                          "dB against the kept ground truth")
    if len(entries) != FLAGSHIP["n_views"] or pose_gap > POSE_TOL:
        faults.append(f"dataset: {len(entries)} poses, max gap {pose_gap}")
    if launches["stream_fwd"] != FLAGSHIP["n_views"]:
        faults.append(f"dataset: launches {launches}")
    return {"dataset": out, "launches": launches}


def grow_checkpoints(tmp):
    """The retained model at iteration GROW_ITER, capacity GROW_CAPACITY,
    zero Adam moments, SH 3: a vanilla checkpoint and one with uniform
    direction logits (grow_dir)."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        _empty_aux, pad_capacity, params_from_numpy)
    from mvs_gaussian_splatting_tpu_torch.models.ply import load_gaussian_ply
    from mvs_gaussian_splatting_tpu_torch.train.checkpoint import \
        save_checkpoint
    from mvs_gaussian_splatting_tpu_torch.train.optim import adam_init
    dev = torch.device("cuda")
    model = load_gaussian_ply(os.path.join(MODEL, "point_cloud_final.ply.gz"))
    n = model["xyz"].shape[0]
    paths = {}
    for name in ("vanilla", "grow"):
        if name == "grow":
            model["dirs_prob"] = np.full((n, 128), 1.0 / 128, np.float32)
        aux = _empty_aux(n, dev)
        aux.alive[:] = True
        params, aux = pad_capacity(params_from_numpy(model, dev), aux,
                                   GROW_CAPACITY)
        paths[name] = os.path.join(tmp, f"start_{name}",
                                   f"chkpnt{GROW_ITER}.npz")
        save_checkpoint(paths[name], params, adam_init(params), aux,
                        GROW_ITER, 3)
        del params, aux
    return paths, n


def grow_arm(tmp, dataset, ckpt, seed, name, flags, steps, profile):
    """One resume of ``ckpt`` on the flagship dataset through ``cli/train.py
    main`` for ``steps`` steps, with the loop's grow rounds and the
    speculative step's render sets recorded: (params, aux, history,
    launches counted from zero, seconds, peak memory, rounds, render
    sets)."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.cli.train import main as train_main
    from mvs_gaussian_splatting_tpu_torch.models.densify import \
        densification_grads
    from mvs_gaussian_splatting_tpu_torch.train import grow_step, loop
    rounds, render_sets = [], []
    real_round = loop.densify_and_prune_grow
    real_make = loop.make_spec_train_step
    real_pre = grow_step.preprocess

    def round_(params, mu, nu, aux, *args, **kwargs):
        thr = args[2].grad_threshold
        uniform = 1.0 / 128
        sel = aux.alive & (densification_grads(aux) >= thr)
        moved = aux.alive & (params.dirs_prob != uniform).any(1)
        out = real_round(params, mu, nu, aux, *args, **kwargs)
        rounds.append(dict(
            out[4], selected=int(sel.sum()),
            selected_reset=bool((out[0].dirs_prob[sel] == uniform).all()),
            moved_before=int(moved.sum()),
            moved_not_selected=int((moved & ~sel).sum())))
        return out

    def make(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def counted(params, *a, **kw):
            render_sets.append([kw.get("render_n") or params.xyz.shape[0],
                                None])
            return step(params, *a, **kw)
        return counted

    def pre(xyz, *a, **kw):
        render_sets[-1][1] = int(xyz.shape[0])
        return real_pre(xyz, *a, **kw)

    loop.densify_and_prune_grow = round_
    loop.make_spec_train_step = make
    grow_step.preprocess = pre
    prof = (["--profile_dir", os.path.join(tmp, f"profile_{name}")]
            if profile else [])
    # the traced arms evaluate the held-out views in the loop (after the
    # exact arm's length, at the first round and at the end); the exact arm
    # is evaluated after its run
    evals = (["--test_iterations",
              *(str(GROW_ITER + k) for k in (GROW_EXACT_STEPS, 100, steps))]
             if profile else ["--test_iterations", "0"])
    try:
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        params, aux, _, hist = train_main(
            ["-s", dataset, "-m", os.path.join(tmp, name),
             "--start_checkpoint", ckpt,
             "--iterations", str(GROW_ITER + steps), *evals,
             "--log_every", "1", "--seed", str(seed), *prof, *TRAIN_FLAGS,
             *flags])
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        loop.densify_and_prune_grow = real_round
        loop.make_spec_train_step = real_make
        grow_step.preprocess = real_pre
    return (params, aux, hist, launches, time.time() - t0,
            torch.cuda.max_memory_allocated(), rounds, render_sets)


def grow_resume(tmp, data, seed, faults):
    """Phase 13: grow mode at the flagship's width on its regenerated
    dataset (105 train views, 15 held out): the retained model resumed at
    iteration GROW_ITER, inside the speculation window with three grow
    rounds before densify_until_iter, GROW_STEPS steps in the default
    fast-math mode with ``--grow_dir`` and without (traced at their
    iterations 100-120), then GROW_EXACT_STEPS exact grow steps, so that B2
    takes the augmented set."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.data.scene import Scene
    from mvs_gaussian_splatting_tpu_torch.train.checkpoint import \
        load_checkpoint
    from mvs_gaussian_splatting_tpu_torch.train.config import (
        ModelConfig, PipelineConfig)
    from mvs_gaussian_splatting_tpu_torch.train.loop import (
        PROFILE_WINDOW, eval_config, raster_config_from_pipe)
    t_phase = time.time()
    ckpts, n = grow_checkpoints(tmp)
    pipe = PipelineConfig(tile_w=32, tile_h=16, max_tiles_per_gaussian=512,
                          tier_budgets=(4, 12, 64),
                          tier_fracs=(0.25, 0.1, 0.01))
    eval_cfg = eval_config(raster_config_from_pipe(pipe))
    dev = torch.device("cuda")
    scene = Scene(ModelConfig(source_path=data["dataset"], eval=True,
                              resolution=1), shuffle=False)
    test = scene.get_test_cameras()
    p0, _, aux0, _, _ = load_checkpoint(ckpts["vanilla"], dev)
    before = evaluate(p0, aux0, test, eval_cfg)
    del p0, aux0
    grow_flags = ["--grow_dir", "--spec_capacity", str(GROW_SPEC),
                  "--growdirs_lr", "0.01"]
    arms = {"grow": (ckpts["grow"], grow_flags, GROW_STEPS, True),
            "vanilla": (ckpts["vanilla"], [], GROW_STEPS, True),
            "grow_exact": (ckpts["grow"], grow_flags + ["--no-fast_math"],
                           GROW_EXACT_STEPS, False)}
    recs = {}
    for name, (ckpt, flags, steps, traced) in arms.items():
        (params, aux, hist, launches, seconds, peak, rounds,
         render_sets) = grow_arm(tmp, data["dataset"], ckpt, seed,
                                 f"grow_resume_{name}", flags, steps, traced)
        losses = [v for _, v in hist["loss"]]
        # the returned state: after the last grow round when one runs
        committed = evaluate(params, aux, test, eval_cfg)[1]
        if traced:
            loop_psnr = {int(k): v for k, v in hist["psnr_test"].items()}
            after = loop_psnr[GROW_ITER + steps]
            trace = trace_summary(os.path.join(
                tmp, f"profile_grow_resume_{name}", "trace.json"))
            timed = [1e3 / r for i, r in hist["iter_time"]
                     if i > GROW_ITER + PROFILE_WINDOW[1]]
        else:
            after = committed
            loop_psnr = {GROW_ITER + steps: committed}
            trace = None
            timed = [1e3 / r for _, r in hist["iter_time"]]
        moved_now = (int((aux.alive & (params.dirs_prob != 1.0 / 128)
                          .any(1)).sum())
                     if params.dirs_prob is not None else None)
        rec = {"phase": f"grow_resume_{name}", "steps": steps,
               "flags": flags, "start_alive": n,
               "capacity": int(params.xyz.shape[0]),
               "alive_final": int(aux.alive.sum()),
               "densify": hist.get("densify", []), "grow_rounds": rounds,
               "render_sets": sorted({tuple(r) for r in render_sets}),
               "spec_steps": len(render_sets),
               "psnr_test_before": before[1], "psnr_test_after": after,
               "psnr_test_loop": loop_psnr,
               "psnr_test_committed": committed,
               "loss_first": losses[0], "loss_last": losses[-1],
               "nonfinite_grad_rows": sum(v for _, v in
                                          hist["nonfinite_grad_rows"]),
               "launches": launches,
               "step_ms_median": float(np.median(timed)),
               "step_ms_quartiles": [float(np.percentile(timed, 25)),
                                     float(np.percentile(timed, 75))],
               "timed_steps": len(timed),
               "alive_moved_off_uniform_final": moved_now,
               "profile_iterations_100_120": trace,
               "seconds": round(seconds, 1), "peak_memory_bytes": peak}
        emit(rec)
        recs[name] = rec
        del params, aux
        # per arm: finite, no scrubbed rows, one forward and one backward of
        # the arm's mode per step and none of the other mode's
        if not all(np.isfinite(losses)) or len(losses) != steps:
            faults.append(f"{rec['phase']}: losses {losses[:3]}...")
        if rec["nonfinite_grad_rows"]:
            faults.append(f"{rec['phase']}: {rec['nonfinite_grad_rows']} "
                          "non-finite gradient rows")
        if "--no-fast_math" in flags:
            want = {"stream_fwd": steps, "stream_bwd": steps,
                    "stream_fwd_fast": 0, "stream_bwd_fast": 0}
        else:
            want = {"stream_fwd_fast": steps, "stream_bwd_fast": steps,
                    "stream_bwd": 0}
        want.update(padded_fwd=0, padded_bwd=0)
        if any(launches[k] != v for k, v in want.items()):
            faults.append(f"{rec['phase']}: launches {launches}, want {want}")
        if "--grow_dir" in flags:
            n_rounds = (GROW_STEPS // 100) if steps == GROW_STEPS else 0
            if (len(render_sets) != steps
                    or any(rows != r + 2 * GROW_SPEC
                           for r, rows in render_sets)):
                faults.append(f"{rec['phase']}: render sets "
                              f"{rec['render_sets']} over "
                              f"{len(render_sets)} steps")
            if len(rounds) != n_rounds or not all(
                    r["n_cloned"] > 0 and r["selected_reset"]
                    for r in rounds):
                faults.append(f"{rec['phase']}: grow rounds {rounds}")
            if rounds and not sum(r["moved_not_selected"] for r in rounds):
                faults.append(f"{rec['phase']}: no unselected row's "
                              "direction logits moved off uniform")
    # The held-out PSNR over the run. The vanilla arm: at most 0.1 dB down
    # (PR 4's criterion). The grow arm starts speculating on a model trained
    # without speculative rows, and its held-out PSNR (live rows only) dips
    # while the model adapts to them, then recovers; both packages do so
    # (PERF.md section 6, PR 9). It is held to recover (its PSNR at the end
    # above its PSNR at the first round) and to agree with the exact arm at
    # the exact arm's length (fast and exact grow steps, within 0.1 dB); its
    # drop, its gap to the vanilla arm and its committed state's PSNR are
    # reported.
    drops = {k: r["psnr_test_before"] - r["psnr_test_after"]
             for k, r in recs.items()}
    if drops["vanilla"] > GROW_PSNR_DROP:
        faults.append(f"grow_resume_vanilla: test PSNR fell "
                      f"{drops['vanilla']} dB")
    grow_loop = recs["grow"]["psnr_test_loop"]
    if not grow_loop[GROW_ITER + GROW_STEPS] > grow_loop[GROW_ITER + 100]:
        faults.append(f"grow_resume_grow: test PSNR did not recover from "
                      f"the first round {grow_loop}")
    exact_gap = (recs["grow_exact"]["psnr_test_after"]
                 - grow_loop[GROW_ITER + GROW_EXACT_STEPS])
    if abs(exact_gap) > ARM_PSNR:
        faults.append(f"grow_resume: exact vs fast grow arm at "
                      f"{GROW_ITER + GROW_EXACT_STEPS}: {exact_gap} dB")
    emit({"phase": "grow_resume", "psnr_test_drop": drops,
          "grow_minus_vanilla_final": recs["grow"]["psnr_test_after"]
          - recs["vanilla"]["psnr_test_after"],
          "grow_exact_minus_fast": exact_gap,
          "psnr_test_committed": {k: r["psnr_test_committed"]
                                  for k, r in recs.items()},
          "step_ms_median": {k: r["step_ms_median"] for k, r in recs.items()},
          "step_device_ms": {k: (r["profile_iterations_100_120"] or {}).get(
              "train_step_device_ms") for k, r in recs.items()},
          "alive_final": {k: r["alive_final"] for k, r in recs.items()},
          "peak_memory_bytes": {k: r["peak_memory_bytes"]
                                for k, r in recs.items()},
          "seconds": round(time.time() - t_phase, 1)})
    return {k: r["launches"] for k, r in recs.items()}


def eval_chain(tmp, data, faults):
    """Phase 14: the offline eval chain on the card. (a) The port's
    ``eval/metrics.evaluate`` over a copy of the kept renders and ground
    truth of ``runs/specfinal``; (b) ``cli/render.py`` on the retained model
    and phase 12's dataset (test views), scored by ``evaluate``; (c)
    ``cli/full_eval.py`` on phase 12's dataset, EVAL_ITERS iterations from
    its 54,000 points: train, render, score, the offline PSNR against the
    loop's own at the last iteration."""
    import contextlib
    import io

    import torch

    from mvs_gaussian_splatting_tpu_torch.cli import full_eval
    from mvs_gaussian_splatting_tpu_torch.cli.render import \
        main as render_main
    from mvs_gaussian_splatting_tpu_torch.eval import metrics
    t_phase = time.time()
    # (a) the kept renders, copied: nothing is written under runs/
    kept = os.path.join(tmp, "kept_eval")
    for sub in ("renders", "gt"):
        shutil.copytree(os.path.join(VIEWS, sub),
                        os.path.join(kept, "test", "ours_25000", sub))
    t0 = time.time()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        metrics.evaluate([kept])
    torch.cuda.synchronize()
    seconds_a = time.time() - t0
    with open(os.path.join(kept, "results.json")) as f:
        got = json.load(f)["ours_25000"]
    with open(os.path.join(kept, "per_view.json")) as f:
        got_view = json.load(f)["ours_25000"]
    with open(os.path.join(MODEL, "results.json")) as f:
        want = json.load(f)["ours_25000"]
    with open(os.path.join(MODEL, "per_view.json")) as f:
        want_view = json.load(f)["ours_25000"]
    exact = {}
    for name in want_view["PSNR"]:
        a = load_png(os.path.join(VIEWS, "renders", name)) / 255.0
        b = load_png(os.path.join(VIEWS, "gt", name)) / 255.0
        exact[name] = 20 * np.log10(1.0 / np.sqrt(np.mean((a - b) ** 2)))
    kept_rec = {
        "seconds": seconds_a, "results": got,
        "mean_psnr_gap": got["PSNR"] - want["PSNR"],
        "mean_ssim_gap": got["SSIM"] - want["SSIM"],
        "view_ssim_gap_max": max(abs(got_view["SSIM"][n]
                                     - want_view["SSIM"][n])
                                 for n in want_view["SSIM"]),
        "view_psnr_gap_f64_max": max(abs(got_view["PSNR"][n] - exact[n])
                                     for n in exact),
        "view_psnr_gap_kept_max": max(abs(got_view["PSNR"][n]
                                          - want_view["PSNR"][n])
                                      for n in exact),
        "lpips": got["LPIPS"]}
    if (sorted(got_view["PSNR"]) != sorted(want_view["PSNR"])
            or abs(kept_rec["mean_psnr_gap"]) > EVAL_PSNR_TOL
            or abs(kept_rec["mean_ssim_gap"]) > EVAL_SSIM_TOL
            or kept_rec["view_ssim_gap_max"] > EVAL_SSIM_TOL
            or kept_rec["view_psnr_gap_f64_max"] > EVAL_PSNR_TOL
            or kept_rec["view_psnr_gap_kept_max"] > EVAL_VIEW_KEPT_TOL):
        faults.append(f"eval_chain kept renders: {kept_rec}")

    # (b) cli/render.py on the retained model, then evaluate
    model = os.path.join(tmp, "render_cli_model")
    os.makedirs(model)
    os.symlink(os.path.join(MODEL, "point_cloud_final.ply.gz"),
               os.path.join(model, "point_cloud_final.ply.gz"))
    reset_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(log):
        overflow = render_main(["-m", model, "-s", data["dataset"], "--eval",
                                "--skip_train"])
        torch.cuda.synchronize()
        seconds_render = time.time() - t0
        render_launches = read_launches()
        t0 = time.time()
        metrics.evaluate([model])
    seconds_metrics = time.time() - t0
    with open(os.path.join(model, "results.json")) as f:
        cli = json.load(f)["ours_final"]
    render_rec = {"overflow": overflow, "results": cli,
                  "mean_psnr_gap": cli["PSNR"] - want["PSNR"],
                  "render_seconds": seconds_render,
                  "metrics_seconds": seconds_metrics,
                  "launches": render_launches}
    want_launches = dict.fromkeys(KERNELS, 0)
    want_launches["stream_fwd"] = 15
    if (abs(render_rec["mean_psnr_gap"]) > 0.02
            or render_launches != want_launches
            or overflow["test"]["overflow_capacity"]):
        faults.append(f"eval_chain render CLI: {render_rec}")

    # (c) full_eval: train, render, score
    out = os.path.join(tmp, "full_eval")
    fe_log = io.StringIO()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with contextlib.redirect_stdout(fe_log):
        res = full_eval.main(["--output_path", out, "--scenes",
                              data["dataset"], "--iterations",
                              str(EVAL_ITERS)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    fe_launches = read_launches()
    fe_model = res["model_paths"][0]
    with open(os.path.join(fe_model, "history.json")) as f:
        hist = json.load(f)
    with open(os.path.join(fe_model, "results.json")) as f:
        fe = json.load(f)
    have_pv = os.path.exists(os.path.join(fe_model, "per_view.json"))
    loop = hist["psnr_test"][str(EVAL_ITERS)]
    offline = fe[f"ours_{EVAL_ITERS}"]["PSNR"]
    fe_peak = torch.cuda.max_memory_allocated()
    invariant = clip_free_invariant(fe_model, data["dataset"])
    fe_rec = {"iterations": EVAL_ITERS, "stage_seconds": res["seconds"],
              "wall_seconds": wall, "results": fe,
              "psnr_test_loop": hist["psnr_test"],
              "offline_minus_loop": offline - loop,
              # both surfaces size their layout under the 16M slot limit
              # and clip this scene's widest splats, each its own set
              "clipping": [line for line in fe_log.getvalue().splitlines()
                           if "slot limit" in line or "overflow" in line],
              "clip_free": invariant,
              "alive": hist["n_alive"],
              "per_view_json": have_pv, "launches": fe_launches,
              "peak_memory_bytes": fe_peak}
    if (abs(invariant["offline_minus_loop"]) > 0.02 or not have_pv
            or fe_launches["stream_fwd_fast"] != EVAL_ITERS
            or fe_launches["stream_bwd_fast"] != EVAL_ITERS
            or fe_launches["stream_fwd"] == 0
            or fe_launches["stream_bwd"] or fe_launches["padded_fwd"]
            or fe_launches["padded_bwd"]):
        faults.append(f"eval_chain full_eval: {fe_rec}")
    emit({"phase": "eval_chain", "kept_renders": kept_rec,
          "render_cli": render_rec, "full_eval": fe_rec,
          "tolerances": {"psnr_db": EVAL_PSNR_TOL, "ssim": EVAL_SSIM_TOL,
                         "view_psnr_vs_kept_db": EVAL_VIEW_KEPT_TOL,
                         "render_cli_db": 0.02, "offline_vs_loop_db": 0.02},
          "seconds": round(time.time() - t_phase, 1)})
    return {"render_cli": render_launches, "full_eval": fe_launches}


def clip_free_invariant(model, dataset):
    """The one-operator invariant where it is defined, on the saved model
    of ``model`` at EVAL_ITERS: its test views scored as the loop scores
    them (``train/loop.evaluate_split``, float images) and as the offline
    chain does (``cli/render.py``'s operator, 8-bit images), each on its
    measured layout with the slot limit lifted, so that neither clips."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.cli.render import (
        adaptive_eval_config, eval_raster_config, measure_tile_needs,
        params_from_ply, quantize_image)
    from mvs_gaussian_splatting_tpu_torch.data.scene import Scene
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import GaussianAux
    from mvs_gaussian_splatting_tpu_torch.ops.binning import (
        adaptive_tier_layout, stream_instance_bound)
    from mvs_gaussian_splatting_tpu_torch.ops.render import render
    from mvs_gaussian_splatting_tpu_torch.train.config import (
        ModelConfig, PipelineConfig)
    from mvs_gaussian_splatting_tpu_torch.train.loop import (
        eval_config, evaluate_split, raster_config_from_pipe)
    from mvs_gaussian_splatting_tpu_torch.train.step import make_eval_metrics
    dev = torch.device("cuda")
    params = params_from_ply(os.path.join(
        model, "point_cloud", f"iteration_{EVAL_ITERS}", "point_cloud.ply"),
        3, device=dev)
    n = int(params.xyz.shape[0])
    z = torch.zeros(n, device=dev)
    aux = GaussianAux(alive=torch.ones(n, dtype=torch.bool, device=dev),
                      max_radii2d=z, xyz_grad_accum=z, denom=z)
    test = Scene(ModelConfig(source_path=dataset, eval=True),
                 shuffle=False).get_test_cameras()
    pipe = PipelineConfig()
    loop_cfg = eval_config(raster_config_from_pipe(pipe))
    needs = measure_tile_needs(params, test, loop_cfg.tile_w, loop_cfg.tile_h)
    d, budgets, fracs, clipped = adaptive_tier_layout(
        needs, loop_cfg.max_tiles_per_gaussian, loop_cfg.tier_budgets,
        loop_cfg.tier_fracs, quantize=True, slot_limit=1 << 28)
    bound = stream_instance_bound(n, d, budgets, fracs)
    bg = torch.zeros(3, device=dev)
    _, loop_psnr = evaluate_split(
        make_eval_metrics(loop_cfg), params, aux, test, bg, 3, dev,
        instance_cap=bound + (-bound) % 128,
        tier_layout=(d, tuple(budgets), tuple(fracs)))
    cfg = adaptive_eval_config(eval_raster_config(pipe, n_gaussians=n),
                               needs, log=lambda s: None,
                               slot_limit=1 << 28)
    offline, over = [], 0
    for cam in test:
        with torch.no_grad():
            out = render(cam.view(dev), cam.width, cam.height, params, bg,
                         sh_degree=3, raster_config=cfg)
        over += int(out["overflow_tiles"]) + int(out["overflow_capacity"])
        offline.append(psnr(quantize_image(out["render"]), quantize_image(
            torch.from_numpy(cam.image)))[0])
    return {"loop_psnr": loop_psnr, "offline_psnr": float(np.mean(offline)),
            "offline_minus_loop": float(np.mean(offline)) - loop_psnr,
            "loop_clipped_rows": clipped, "offline_overflow": over,
            "gaussians": n}


def compress_phase(tmp, test_cams, cfg_base, cams, before_psnr, faults):
    """Phase 15: ``cli/compress.py`` on the retained model (256 codes over
    f_rest, scaling and rotation, 50 k-means iterations on the card), then
    ``--decompress``; the dequantized model rendered on the 15 test views
    through B1 at its own measured eval layout; the same draws on the CPU
    for comparison."""
    import contextlib
    import io

    import torch

    from mvs_gaussian_splatting_tpu_torch.cli import compress as ccli
    from mvs_gaussian_splatting_tpu_torch.cli.render import (
        adaptive_eval_config, measure_tile_needs, params_from_ply,
        quantize_image)
    from mvs_gaussian_splatting_tpu_torch.models.ply import (
        load_gaussian_ply, save_gaussian_ply)
    from mvs_gaussian_splatting_tpu_torch.models.quantize import \
        compress_gaussians
    from mvs_gaussian_splatting_tpu_torch.ops.render import render
    t_phase = time.time()
    dev = torch.device("cuda")
    raw = load_gaussian_ply(os.path.join(MODEL, "point_cloud_final.ply.gz"))
    model = os.path.join(tmp, "compress_model")
    ply = os.path.join(model, "point_cloud", f"iteration_{RESUME_ITER}",
                       "point_cloud.ply")
    save_gaussian_ply(ply, raw)
    log = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.time()
    with contextlib.redirect_stdout(log):
        npz = ccli.main(["-m", model, "--num_codes", str(COMPRESS_CODES)])
    torch.cuda.synchronize()
    seconds_compress = time.time() - t0
    with contextlib.redirect_stdout(log):
        dq_path = ccli.main(["-m", model, "--decompress"])
    ratio = os.path.getsize(ply) / os.path.getsize(npz)
    data = np.load(npz)
    dq = load_gaussian_ply(dq_path)
    attrs = ("f_rest", "scaling", "rotation")
    untouched_equal = all(np.array_equal(dq[k], raw[k])
                          for k in raw if k not in attrs)
    rows_are_codes = all(np.array_equal(
        dq[a], data[f"codebooks/{a}"][data[f"codes/{a}"].astype(np.int64)]
        .reshape(raw[a].shape)) for a in attrs)
    card_err = {a: float(np.mean(np.abs(dq[a].astype(np.float64)
                                        - raw[a]))) for a in attrs}
    # the same draws (one seeded CPU generator) on the CPU
    t0 = time.time()
    cpu = compress_gaussians(raw, num_codes=COMPRESS_CODES, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    seconds_cpu = time.time() - t0
    cpu_err = {a: float(np.mean(np.abs(cpu["dequantized"][a].numpy()
                                       .astype(np.float64) - raw[a])))
               for a in attrs}
    err_gap = {a: abs(card_err[a] - cpu_err[a]) / cpu_err[a] for a in attrs}
    # the dequantized model through B1 at its own eval layout
    params = params_from_ply(dq_path, 3, device=dev)
    needs = measure_tile_needs(params, cams, cfg_base.tile_w,
                               cfg_base.tile_h)
    layout = []
    cfg = adaptive_eval_config(cfg_base, needs, log=layout.append)
    bg = torch.zeros(3, device=dev)
    reset_launches()
    psnrs, finite, over = [], True, 0
    t0 = time.time()
    for k, cam in enumerate(test_cams):
        with torch.no_grad():
            out = render(cam.view(dev), cam.width, cam.height, params, bg,
                         sh_degree=3, raster_config=cfg)
        finite &= bool(torch.isfinite(out["render"]).all())
        over += int(out["overflow_capacity"])
        psnrs.append(psnr(quantize_image(out["render"]), load_png(
            os.path.join(VIEWS, "gt", f"{k:05d}.png")))[0])
    torch.cuda.synchronize()
    seconds_render = time.time() - t0
    launches = read_launches()
    rec = {"phase": "compress", "num_codes": COMPRESS_CODES,
           "gaussians": int(raw["xyz"].shape[0]),
           "ply_bytes": os.path.getsize(ply),
           "npz_bytes": os.path.getsize(npz), "ratio": ratio,
           "mean_abs_err_card": card_err, "mean_abs_err_cpu": cpu_err,
           "card_vs_cpu_rel": err_gap,
           "untouched_bit_equal": untouched_equal,
           "rows_are_codebook_rows": rows_are_codes,
           "compress_seconds": seconds_compress, "cpu_seconds": seconds_cpu,
           "layout": layout, "psnr_gt": psnrs,
           "mean_psnr_gt": float(np.mean(psnrs)),
           "mean_psnr_gt_uncompressed": before_psnr,
           "psnr_drop": before_psnr - float(np.mean(psnrs)),
           "render_seconds": seconds_render, "finite": finite,
           "overflow_capacity": over, "launches": launches,
           "log": log.getvalue().splitlines()[-8:],
           "seconds": round(time.time() - t_phase, 1)}
    emit(rec)
    want = dict.fromkeys(KERNELS, 0)
    want["stream_fwd"] = len(test_cams)
    if (ratio < COMPRESS_RATIO or not untouched_equal or not rows_are_codes
            or max(err_gap.values()) > COMPRESS_CPU_REL or not finite
            or over or launches != want):
        faults.append(f"compress: ratio {ratio}, untouched "
                      f"{untouched_equal}, rows {rows_are_codes}, card vs "
                      f"cpu {err_gap}, finite {finite}, overflow {over}, "
                      f"launches {launches}")
    return {"launches": launches}


def tools_phase(tmp, data, faults):
    """Phase 16: the 2D toy on the card (one kept ground-truth view at 256
    on its long side, TOY_EPOCHS epochs) and the native COLMAP reader on
    phase 12's sparse model against the Python parsers."""
    from unittest import mock

    import torch
    from PIL import Image

    from mvs_gaussian_splatting_tpu_torch import native
    from mvs_gaussian_splatting_tpu_torch.data import colmap
    from mvs_gaussian_splatting_tpu_torch.toy2d import fit_image
    t_phase = time.time()
    img = Image.open(os.path.join(VIEWS, "gt", "00000.png")).convert("RGB")
    w, h = img.size
    size = (TOY_SIDE, round(h * TOY_SIDE / w)) if w >= h else (
        round(w * TOY_SIDE / h), TOY_SIDE)
    target = np.asarray(img.resize(size), np.float32).transpose(2, 0, 1) / 255
    torch.cuda.synchronize()
    t0 = time.time()
    params, alive, hist = fit_image(target, capacity=TOY_CAPACITY,
                                    n_init=TOY_INIT, epochs=TOY_EPOCHS,
                                    seed=0)
    torch.cuda.synchronize()
    toy = {"size": list(size), "epochs": TOY_EPOCHS, "n_init": TOY_INIT,
           "capacity": TOY_CAPACITY,
           "seconds": time.time() - t0, "loss": hist["loss"],
           "n_alive": hist["n_alive"], "device": str(params.xy.device),
           "finite": all(bool(torch.isfinite(p).all()) for p in params)}
    if not (hist["loss"][-1] < hist["loss"][0] and toy["finite"]
            and len(set(hist["n_alive"])) > 1
            and params.xy.device.type == "cuda"):
        faults.append(f"tools toy2d: {toy}")
    # the native reader: built with g++ (timed into the temporary
    # directory; the readers load the build directory's copy, made when
    # an earlier phase first read a COLMAP dataset), the path they take
    t0 = time.time()
    built = native.build(native.SOURCE, os.path.join(tmp, "libgsio.so"))
    build_seconds = time.time() - t0
    lib = native.load()
    sparse = os.path.join(data["dataset"], "sparse", "0")
    readers = {"cameras": colmap.read_cameras_binary,
               "images": colmap.read_images_binary,
               "points3D": colmap.read_points3d_binary}
    parses, same, timing = {}, {}, {}
    for name, reader in readers.items():
        path = os.path.join(sparse, f"{name}.bin")
        before = native.parses
        t0 = time.perf_counter()
        got = reader(path)
        t_native = time.perf_counter() - t0
        parses[name] = native.parses - before
        with mock.patch.object(native, "load", lambda: None):
            t0 = time.perf_counter()
            want = reader(path)           # the Python parser
            timing[name] = {"native_s": t_native,
                            "python_s": time.perf_counter() - t0}
        same[name] = parses_equal(got, want)
    rec = {"library": os.path.relpath(native.library_path(), ROOT),
           "built": built, "loaded": lib is not None,
           "build_seconds": build_seconds,
           "native_parses": parses, "equal_to_python": same,
           "timing": timing}
    emit({"phase": "tools", "toy2d": toy, "native": rec,
          "seconds": round(time.time() - t_phase, 1)})
    if not built or lib is None or any(v != 1 for v in parses.values()) \
            or not all(same.values()):
        faults.append(f"tools native reader: {rec}")


def parses_equal(a, b) -> bool:
    """Two COLMAP parses equal: every array, every name and number."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(parses_equal(a[k], b[k])
                                              for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(parses_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b

def tile_partition(params, test_cams, seed, faults):
    """Phase 17 (a): tile_stream's per-rank body for every rank r < D on
    the one card, D in PAR_SHARDS, strips and round-robin, exact (B1/B2)
    and fast (B3f/B3b): the shards' tiles reassembled and their packed
    gradients summed, against the unsharded call on the same cotangents;
    then each rank's kernel ms (the partition's load imbalance). Returns
    (rows, summary, launches): the launches of the ranks' calls alone, not
    of the unsharded reference or of the timing."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        activated, get_features)
    from mvs_gaussian_splatting_tpu_torch.ops import stream
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import (
        RasterConfig, bin_and_pack_stream)
    from mvs_gaussian_splatting_tpu_torch.parallel.tile_stream import (
        shard_tiles, tile_layout, unshard_order)
    dev = torch.device("cuda")
    tw, th = 32, 16
    cfg = RasterConfig(tile_w=tw, tile_h=th, max_tiles_per_gaussian=512,
                       tier_budgets=(4, 12, 64),
                       tier_fracs=(0.25, 0.1, 0.01))
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    rows = []
    launches = dict.fromkeys(KERNELS, 0)
    for cam in test_cams[:PAR_VIEWS]:
        tiles_x = -(-cam.width // tw)
        t = tiles_x * -(-cam.height // th)
        with torch.no_grad():
            sc, ro, op = activated(params)
            p = preprocess(params.xyz, op, cam.view(dev), cam.width,
                           cam.height, scales=sc, rotations=ro,
                           shs=get_features(params), sh_degree=3,
                           tile_w=tw, tile_h=th)
            bins, attrs = bin_and_pack_stream(p, tiles_x, -(-cam.height // th),
                                              cfg)
        ids = torch.arange(t, dtype=torch.int32, device=dev)
        g_out, g_tfin = cotangents(t, tw * th, seed, dev)
        for fast in (False, True):
            full = stream.composite_stream(attrs, bins.seg_start,
                                           bins.counts, bg, ids, tiles_x, tw,
                                           th, fast)
            g_full, _ = stream.composite_stream_bwd(
                attrs, bins.seg_start, bins.counts, bg, ids, tiles_x, tw, th,
                *full, g_out, g_tfin, fast=fast)
            for d in PAR_SHARDS:
                pad = tile_layout(t, d)[0] - t
                go = torch.cat([g_out, g_out.new_zeros((pad,) + g_out.shape[1:])])
                gt = torch.cat([g_tfin, g_tfin.new_zeros((pad, tw * th))])
                for rr in (False, True):
                    outs, tfins, calls, entries = [], [], [], []
                    g_sum = torch.zeros_like(attrs)
                    reset_launches()
                    for r in range(d):
                        seg, cnt, sid = shard_tiles(bins, d, r, t, rr)
                        call = (attrs, seg, cnt, bg, sid, tiles_x, tw, th,
                                fast)
                        o, tf = stream.composite_stream(*call)
                        sel = sid.long()
                        bcall = (*call[:8], o, tf, go[sel].contiguous(),
                                 gt[sel].contiguous())
                        g_r, _ = stream.composite_stream_bwd(*bcall,
                                                             fast=fast)
                        g_sum += g_r
                        outs.append(o)
                        tfins.append(tf)
                        calls.append((call, bcall))
                        entries.append(int(cnt.sum()))
                    add_launches(launches, read_launches())
                    fwd_ms = [cuda_ms(lambda: stream.composite_stream(*c), 3)
                              for c, _ in calls]
                    bwd_ms = [cuda_ms(lambda: stream.composite_stream_bwd(
                        *bc, fast=fast), 3) for _, bc in calls]
                    order = unshard_order(t, d, rr, dev)
                    got = (torch.cat(outs)[order], torch.cat(tfins)[order])
                    img_err = max(float((got[k] - full[k]).abs().max())
                                  for k in range(2))
                    grad_gaps = row_gaps(g_sum[:9], g_full[:9])
                    bit = (all(torch.equal(got[k], full[k]) for k in range(2))
                           and torch.equal(g_sum, g_full))
                    rec = {"view": cam.image_name, "fast": fast, "shards": d,
                           "round_robin": rr, "bit_equal": bit,
                           "image_max_abs": img_err,
                           "gattrs_rel_gap": max(grad_gaps),
                           "entries_per_rank": entries,
                           "fwd_ms_per_rank": fwd_ms,
                           "bwd_ms_per_rank": bwd_ms,
                           "fwd_ms_max_over_mean": max(fwd_ms)
                           / float(np.mean(fwd_ms)),
                           "bwd_ms_max_over_mean": max(bwd_ms)
                           / float(np.mean(bwd_ms))}
                    rows.append(rec)
                    if not bit and (img_err > PART_REL
                                    or max(grad_gaps) > PART_REL):
                        faults.append(f"tile partition: {rec}")
        del bins, attrs, p
    summary = {}
    for rr in (False, True):
        for d in PAR_SHARDS:
            sel = [r for r in rows if r["round_robin"] == rr
                   and r["shards"] == d]
            summary[f"{'rr' if rr else 'strips'}_{d}"] = {
                k: float(np.mean([r[k] for r in sel]))
                for k in ("fwd_ms_max_over_mean", "bwd_ms_max_over_mean")}
    return rows, summary, launches


def _leaf_gap(got, want):
    """Max over the parameter leaves of max |got − want| / max |want|."""
    gaps = {}
    for k, w in want._asdict().items():
        if w is None:
            continue
        g = getattr(got, k)
        scale = float(w.abs().max())
        gaps[k] = float((g - w).abs().max()) / scale if scale else float(
            g.abs().max())
    return gaps


def first_steps(data, faults):
    """Phase 17 (b), the first steps at world size 1: the camera batch
    (PAR_BATCH cameras, fast and exact) against the mean of its cameras'
    single steps, and the tile-parallel step against make_train_step
    (exact), from the phase 7 checkpoint (zero moments: mu = 0.1·g). The
    exact comparisons run under :func:`deterministic`, and the single step
    is run twice there and without it. Returns (record, the launches of
    the batched and tile-parallel steps alone)."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.data.scene import Scene
    from mvs_gaussian_splatting_tpu_torch.parallel.data_parallel import \
        make_batch_train_step
    from mvs_gaussian_splatting_tpu_torch.parallel.mesh import make_mesh
    from mvs_gaussian_splatting_tpu_torch.parallel.tile_train import \
        make_tile_train_step
    from mvs_gaussian_splatting_tpu_torch.train.checkpoint import \
        load_checkpoint
    from mvs_gaussian_splatting_tpu_torch.train.config import (
        ModelConfig, OptimizationConfig, PipelineConfig)
    from mvs_gaussian_splatting_tpu_torch.train.loop import \
        raster_config_from_pipe
    from mvs_gaussian_splatting_tpu_torch.train.step import make_train_step
    dev = torch.device("cuda")
    scene = Scene(ModelConfig(source_path=data["dataset"], eval=True,
                              resolution=1), shuffle=False)
    cams = scene.get_train_cameras()[:PAR_BATCH]
    views = [c.view(dev) for c in cams]
    gts = torch.stack([c.device_image(dev) for c in cams])
    params, adam, aux, it, sh = load_checkpoint(data["checkpoint"], dev)
    opt = OptimizationConfig()
    extent = float(scene.cameras_extent)
    pipe = PipelineConfig(tile_w=32, tile_h=16, max_tiles_per_gaussian=512,
                          tier_budgets=(4, 12, 64),
                          tier_fracs=(0.25, 0.1, 0.01))
    bg = torch.zeros(3, device=dev)
    kw = dict(width=cams[0].image.shape[2], height=cams[0].image.shape[1],
              sh_degree=sh)
    args = (params, adam, aux)
    rec = {}
    launches = dict.fromkeys(KERNELS, 0)

    def counted(fn, *a):
        reset_launches()
        out = fn(*a, it + 1, True, **kw)
        add_launches(launches, read_launches())
        return out

    for fast in (True, False):
        rc = raster_config_from_pipe(pipe)._replace(fast_math=fast)
        batch = make_batch_train_step(opt, rc, extent, make_mesh(1))
        single = make_train_step(opt, rc, extent)
        name = "fast" if fast else "exact"
        with (contextlib.nullcontext([]) if fast else deterministic()) as \
                alerts:
            _, b_adam, _, m = counted(batch, *args, views, gts, bg)
            mus = [single(*args, v, g, bg, it + 1, True, **kw)[1].mu
                   for v, g in zip(views, gts)]
            mean = type(mus[0])(*[
                None if a is None else
                torch.stack([getattr(u, f) for u in mus]).mean(0)
                for f, a in zip(mus[0]._fields, mus[0])])
            gaps = _leaf_gap(b_adam.mu, mean)
            bound = PAR_FAST_REL if fast else PAR_EXACT_REL
            rec[f"batch_vs_mean_of_singles_{name}"] = {
                "rel_gap": gaps, "bound": bound, "loss": float(m.loss),
                "nonfinite_grad_rows": int(m.nonfinite_grad_rows),
                "deterministic": not fast}
            if max(gaps.values()) > bound or int(m.nonfinite_grad_rows):
                faults.append(f"data_parallel first step ({name}): {gaps}")
            if not fast:
                tile = make_tile_train_step(opt, rc, extent,
                                            make_mesh(1, axes=("tile",)))
                tp, ta, _, _ = counted(tile, *args, views[0], gts[0], bg)
                sp, sa, _, _ = single(*args, views[0], gts[0], bg, it + 1,
                                      True, **kw)
                gaps = _leaf_gap(ta.mu, sa.mu)
                bit = all(torch.equal(getattr(tp, f), getattr(sp, f))
                          for f in tp._fields if getattr(tp, f) is not None)
                again = single(*args, views[0], gts[0], bg, it + 1, True,
                               **kw)[1].mu
                self_gap = _leaf_gap(again, sa.mu)
                rec["tile_vs_train_step_exact"] = {
                    "rel_gap": gaps, "bound": PAR_EXACT_REL,
                    "bit_equal": bit, "deterministic": True,
                    "train_step_vs_itself_rel_gap": self_gap}
                if max(gaps.values()) > PAR_EXACT_REL:
                    faults.append(f"tile_parallel first step: {gaps}")
                if max(self_gap.values()) > 0:
                    faults.append("exact train step not repeatable under "
                                  f"deterministic algorithms: {self_gap}")
        if not fast:
            rec["deterministic_alerts"] = sorted(
                {str(w.message).split("\n")[0][:160] for w in alerts})
            # the same step twice as the loop runs it: the atomics' order
            # changes from run to run
            twice = [single(*args, views[0], gts[0], bg, it + 1, True,
                            **kw)[1].mu for _ in range(2)]
            rec["train_step_vs_itself_rel_gap_atomics"] = _leaf_gap(*twice)
    del params, adam, aux
    return rec, launches


def parallel_loop(tmp, dataset, ckpt, start_iter, name, flags, steps, seed,
                  profile=False):
    """One ``cli/train.py`` resume in a multi-device mode: (record, its
    launches)."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.cli.train import main as train_main
    prof = (["--profile_dir", os.path.join(tmp, f"profile_{name}")]
            if profile else [])
    reset_launches()
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    params, aux, _, hist = train_main(
        ["-s", dataset, "-m", os.path.join(tmp, name),
         "--start_checkpoint", ckpt,
         "--iterations", str(start_iter + steps), "--test_iterations", "0",
         "--log_every", "1", "--seed", str(seed), *prof, *TRAIN_FLAGS,
         *flags])
    torch.cuda.synchronize()
    launches = read_launches()
    losses = [v for _, v in hist["loss"]]
    # past the first steps' warm-up, before the traced window
    ms = [1e3 / r for i, r in hist["iter_time"]
          if start_iter + min(10, steps // 2) < i
          <= start_iter + min(steps, 100)]
    rec = {"phase": f"parallel_{name}", "flags": flags, "steps": steps,
           "loss_first": losses[0], "loss_last": losses[-1],
           "finite": bool(np.isfinite(losses).all()) and all(
               bool(torch.isfinite(a).all()) for a in params
               if a is not None),
           "nonfinite_grad_rows": sum(v for _, v in
                                      hist["nonfinite_grad_rows"]),
           "step_ms_median": float(np.median(ms)),
           "step_ms_quartiles": [float(np.percentile(ms, 25)),
                                 float(np.percentile(ms, 75))],
           "launches": launches, "seconds": round(time.time() - t0, 1),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if profile:
        rec["trace_100_120"] = trace_summary(
            os.path.join(tmp, f"profile_{name}", "trace.json"))
    del params, aux
    return rec, launches


def parallel_modes(tmp, data, flagship, params, test_cams, single_ms, smi,
                   seed, faults):
    """Phase 17: the multi-device modes on the one card, (a) the tile
    partition and (b) world size 1 through ``torch.distributed`` (a NCCL
    group of one): the first steps, then the loop in every mode. Returns
    the phase's launches, counted from zero."""
    import torch
    import torch.distributed as dist

    from mvs_gaussian_splatting_tpu_torch.parallel.gauss_stream import \
        make_gauss_sharded_stream
    from mvs_gaussian_splatting_tpu_torch.parallel.mesh import make_mesh
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        activated, get_features)
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
    t_phase = time.time()
    total = dict.fromkeys(KERNELS, 0)

    rows, summary, launches = tile_partition(params, test_cams, seed, faults)
    add_launches(total, launches)
    emit({"phase": "parallel_tile_partition", "card": smi,
          "max_over_mean": summary, "partitions": rows})

    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(tmp, "pg_store"),
        rank=0, world_size=1)
    try:
        first, launches = first_steps(data, faults)
        add_launches(total, launches)
        # the exchange's quota shortfall on one test view (one shard)
        dev = torch.device("cuda")
        cam = test_cams[0]
        rc = RasterConfig(tile_w=32, tile_h=16, max_tiles_per_gaussian=512,
                          tier_budgets=(4, 12, 64),
                          tier_fracs=(0.25, 0.1, 0.01))
        reset_launches()
        with torch.no_grad():
            sc, ro, op = activated(params)
            p = preprocess(params.xyz, op, cam.view(dev), cam.width,
                           cam.height, scales=sc, rotations=ro,
                           shs=get_features(params), sh_degree=3,
                           tile_w=32, tile_h=16)
            img, gaux = make_gauss_sharded_stream(
                make_mesh(1, axes=("gauss",)), "gauss", cam.width,
                cam.height, rc)(p, torch.zeros(3, device=dev))
        add_launches(total, read_launches())
        first["gauss_render_view0"] = {
            k: int(gaux[k]) for k in ("overflow_quota", "overflow_capacity",
                                      "overflow_tiles", "instance_load")}
        del p, img
        emit({"phase": "parallel_first_steps", "card": smi,
              "world_size": dist.get_world_size(),
              "backend": dist.get_backend(), **first})
        ckpt, it = data["checkpoint"], RESUME_ITER
        grow_ckpt = os.path.join(tmp, "start_grow", f"chkpnt{GROW_ITER}.npz")
        # the single-camera loop over the same window, as the control of
        # the 20-step runs' step times
        runs = [("single_camera", data["dataset"], ckpt, it, [], PAR_STEPS,
                 False),
                ("data_parallel_4", data["dataset"], ckpt, it,
                 ["--data_parallel", str(PAR_BATCH)], PAR_BATCH_STEPS, True),
                ("tile_parallel_1", data["dataset"], ckpt, it,
                 ["--tile_parallel", "1"], PAR_STEPS, False),
                ("grid_2x1", data["dataset"], ckpt, it,
                 ["--data_parallel", "2", "--tile_parallel", "1"],
                 PAR_STEPS, False),
                ("gauss_parallel_1", data["dataset"], ckpt, it,
                 ["--gauss_parallel", "1"], PAR_STEPS, False),
                ("grow_data_parallel_4", flagship["dataset"], grow_ckpt,
                 GROW_ITER, ["--grow_dir", "--spec_capacity", str(GROW_SPEC),
                             "--growdirs_lr", "0.01", "--data_parallel",
                             str(PAR_BATCH)], PAR_STEPS, False)]
        recs = {}
        for name, dataset, start, at, flags, steps, prof in runs:
            rec, launches = parallel_loop(tmp, dataset, start, at, name,
                                          flags, steps, seed, prof)
            add_launches(total, launches)
            recs[name] = rec
            rec["card"] = smi
            if name.startswith(("data", "grow")):
                rec["step_ms_per_camera"] = rec["step_ms_median"] / PAR_BATCH
            elif name.startswith("grid"):
                rec["step_ms_per_camera"] = rec["step_ms_median"] / 2
            rec["single_camera_step_ms_phase7"] = single_ms
            emit(rec)
            if not rec["finite"] or rec["nonfinite_grad_rows"]:
                faults.append(f"{rec['phase']}: not finite ({rec})")
            if launches["stream_fwd_fast"] < steps or launches[
                    "stream_bwd_fast"] < steps:
                faults.append(f"{rec['phase']}: launches {launches}")
    finally:
        dist.destroy_process_group()
    emit({"phase": "parallel_modes", "launches": total,
          "seconds": round(time.time() - t_phase, 1)})
    for k in ("stream_fwd", "stream_bwd", "stream_fwd_fast",
              "stream_bwd_fast"):
        if total[k] == 0:
            faults.append(f"parallel modes: {k} never launched")
    return total



def mvs_phase(tmp, seed, faults):
    """Phase 18: the MVS branch at the model's defaults on 640×480 groups.
    (a) one group's train step through B1 and B2 against the same
    computation on a CPU copy (the plain versions), and B1 against its
    plain version on the card's projected Gaussians; (b) ``cli/mvs_train.py``
    for MVS_ITERS iterations as the JAX recipe has it (its learning
    criteria reported: ROADMAP C14) and under a flat budget of 512 tiles a
    Gaussian (held). Returns the phase's launches, counted from zero (the
    CPU copy and the comparison's launch not counted)."""
    import copy

    import torch

    from mvs_gaussian_splatting_tpu_torch.cli.mvs_train import \
        main as mvs_main
    from mvs_gaussian_splatting_tpu_torch.mvs import train as mt
    from mvs_gaussian_splatting_tpu_torch.mvs.dataset import \
        make_synthetic_groups
    from mvs_gaussian_splatting_tpu_torch.mvs.model import MVSGaussianModel
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import rasterize
    from mvs_gaussian_splatting_tpu_torch.utils.losses import l1_loss, ssim
    t0 = time.time()
    reset_launches()
    width, height = MVS_SIZE
    group = make_synthetic_groups(n_groups=1, width=width, height=height,
                                  seed=seed, device="cuda")[0]
    model = MVSGaussianModel(seed=seed).cuda()
    cpu_model = copy.deepcopy(model).cpu()
    cfg = mt.MVSConfig()
    recipe = mt.raster_config("cuda")

    def forward_backward(m, device):
        """The train step's loss on the group: (loss, image, parameter
        gradients, overflow counters, the predicted Gaussians)."""
        batch = mt.group_to_batch(group, device)
        m.zero_grad(set_to_none=True)
        out = mt.apply_model(m, batch)
        img, aux = mt.render_predicted(out, batch, width, height,
                                       mt.raster_config(device, "stream"))
        loss = ((1.0 - cfg.lambda_dssim) * l1_loss(img, batch.target_image)
                + cfg.lambda_dssim * (1.0 - ssim(img, batch.target_image)))
        loss.backward()
        return (float(loss), img.detach().cpu(),
                {k: p.grad.detach().cpu() for k, p in m.named_parameters()},
                {k: int(aux[k]) for k in ("overflow_tiles",
                                          "overflow_capacity")},
                {k: v.detach().cpu() for k, v in out.items()})

    before = read_launches()
    t1 = time.time()
    loss_g, img_g, grads_g, overflow, out_g = forward_backward(model, "cuda")
    torch.cuda.synchronize()
    card_s = time.time() - t1
    one = {k: v - before[k] for k, v in read_launches().items()}
    t1 = time.time()
    loss_c, img_c, grads_c, _, out_c = forward_backward(cpu_model, "cpu")
    cpu_s = time.time() - t1
    # the composite on the same inputs: the card's projected Gaussians
    # through B1 and through its plain version
    before_cmp = read_launches()
    with torch.no_grad():
        batch = mt.group_to_batch(group, "cuda")
        xyz_w, rot_w = mt.gaussians_to_world(
            {k: v.cuda() for k, v in out_g.items()}, batch.w2c_ref)
        p = preprocess(xyz_w, torch.sigmoid(out_g["opacity_logit"][:, 0]
                                            .cuda()),
                       batch.target_cam, width, height,
                       scales=torch.exp(out_g["log_scaling"].cuda()),
                       rotations=rot_w, colors_precomp=out_g["colors"].cuda(),
                       tile_w=recipe.tile_w, tile_h=recipe.tile_h)
        need = int(((p.rect_max - p.rect_min).clamp_min(0).prod(-1)
                    * p.mask).sum())
        img_k, _ = rasterize(p, width, height, torch.zeros(3, device="cuda"),
                             recipe)
        img_p, _ = rasterize(type(p)(*[a.cpu() for a in p]), width, height,
                             torch.zeros(3), mt.raster_config("cpu", "stream"))
    compared = {k: v - before_cmp[k] for k, v in read_launches().items()}
    grad_gaps = {k: float((grads_g[k] - grads_c[k]).abs().max())
                 / max(float(grads_c[k].abs().max()), 1e-30)
                 for k in grads_c}
    out_gaps = {k: float((out_g[k] - out_c[k]).abs().max())
                / max(float(out_c[k].abs().max()), 1e-30) for k in out_c}
    img_e2e = float((img_g - img_c).abs().max())
    img_gap = float((img_k.cpu() - img_p).abs().max())
    rec_a = {"gaussians": out_g["xyz_cam"].shape[0], "size": [width, height],
             "loss": loss_g, "loss_cpu": loss_c,
             "image_max_abs": img_e2e, "image_tolerance": MVS_IMG_E2E,
             "image_pixels_over_1e-4": int(((img_g - img_c).abs() > 1e-4)
                                           .sum()),
             "composite_max_abs": img_gap,
             "composite_tolerance": MVS_IMG_TOL,
             "gaussians_rel_max": max(out_gaps.values()),
             "gaussians_tolerance": MVS_OUT_REL, "gaussians_rel": out_gaps,
             "grad_rel_max": max(grad_gaps.values()),
             "grad_rel_worst": max(grad_gaps, key=grad_gaps.get),
             "grad_tolerance": MVS_GRAD_REL, "grad_rel": grad_gaps,
             "tile_need": need, "overflow": overflow, "launches": one,
             "card_seconds": round(card_s, 2),
             "cpu_seconds": round(cpu_s, 2)}
    if (img_e2e > MVS_IMG_E2E or img_gap > MVS_IMG_TOL
            or max(out_gaps.values()) > MVS_OUT_REL
            or max(grad_gaps.values()) > MVS_GRAD_REL
            or not np.isfinite(loss_g) or one["stream_fwd"] != 1
            or one["stream_bwd"] != 1 or one["stream_fwd_fast"]
            or one["stream_bwd_fast"]):
        faults.append(f"mvs one group, card vs CPU: {rec_a}")
    del model, cpu_model, grads_g, grads_c

    def train_cli(name, budget=None):
        """``cli/mvs_train.py`` on MVS_GROUPS synthetic groups, under the
        recipe's raster configuration or ``budget``."""
        from unittest import mock
        torch.cuda.reset_peak_memory_stats()
        before = read_launches()
        t1 = time.time()
        argv = ["--synthetic", str(MVS_GROUPS), "--width", str(width),
                "--height", str(height), "--iterations", str(MVS_ITERS),
                "--eval_every", str(MVS_EVAL_EVERY), "--seed", str(seed),
                "--model_path", os.path.join(tmp, name)]
        with contextlib.ExitStack() as stack:
            if budget is not None:
                stack.enter_context(mock.patch.object(
                    mt, "raster_config", lambda *a, **k: budget))
            _, hist = mvs_main(argv)
        torch.cuda.synchronize()
        seconds = time.time() - t1
        losses = [v for _, v in hist["loss"]]
        evals = hist["psnr_eval"]
        times = dict(hist["time"])
        # 10-step windows with no eval in them
        ms = [(times[i] - times[i - 10]) * 100.0 for i in sorted(times)
              if i - 10 in times and not any(i - 10 < e <= i for e in evals)]
        saved = mt.load_mvs_checkpoint(
            os.path.join(tmp, name, "mvs_model.pt"), "cpu")
        weights_finite = all(bool(torch.isfinite(v).all())
                             for v in saved.state_dict().values())
        ratio = losses[-1] / losses[0]
        return {"iterations": MVS_ITERS, "groups": MVS_GROUPS,
                "loss_first": losses[0], "loss_last": losses[-1],
                "loss_ratio": ratio, "psnr_eval": evals,
                "losses_finite": bool(np.isfinite(losses).all()),
                "weights_finite": weights_finite,
                "criteria": {
                    f"loss_ratio_below_{MVS_LOSS_DROP}": ratio < MVS_LOSS_DROP,
                    "last_psnr_not_below_first":
                        evals[max(evals)] >= evals[min(evals)],
                    "weights_finite": weights_finite},
                "step_ms_median": float(np.median(ms)),
                "step_ms_quartiles": [float(np.percentile(ms, 25)),
                                      float(np.percentile(ms, 75))],
                "launches": {k: v - before[k]
                             for k, v in read_launches().items()},
                "seconds": round(seconds, 1),
                "peak_memory_bytes": torch.cuda.max_memory_allocated()}

    def runs_its_kernels(rec):
        run = rec["launches"]
        return (rec["losses_finite"] and run["stream_bwd"] == MVS_ITERS
                and run["stream_fwd"] >= MVS_ITERS
                and not run["stream_fwd_fast"] and not run["stream_bwd_fast"])

    # (b) the recipe as written: its tile budget clips most of the
    # predicted Gaussians' tiles at this size, their scales run away and
    # the model does not learn, its weights often overflowing to NaN
    # (ROADMAP C14), so the learning criteria are reported, not held. The
    # same CLI under the JAX package's eval budget (512 tiles a Gaussian,
    # flat) holds them.
    as_written = train_cli("mvs")
    tiles = min(512, -(-width // recipe.tile_w) * -(-height // recipe.tile_h))
    n = rec_a["gaussians"] * tiles
    unclipped = train_cli("mvs_512", recipe._replace(
        max_tiles_per_gaussian=tiles, tier_budgets=(), tier_fracs=(),
        instance_cap=n + (-n) % 128))
    if not runs_its_kernels(as_written):
        faults.append(f"mvs training as written: {as_written}")
    if not (runs_its_kernels(unclipped) and all(unclipped["criteria"]
                                                .values())):
        faults.append(f"mvs training, 512 tiles a Gaussian: {unclipped}")
    launches = {k: v - compared[k] for k, v in read_launches().items()}
    emit({"phase": "mvs", "one_group": rec_a, "train_as_written": as_written,
          "train_512_tiles": unclipped, "launches": launches,
          "seconds": round(time.time() - t0, 1)})
    return launches


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def viewer_phase(tmp, data, params, test_cams, seed, faults):
    """Phase 19: the network viewer. (a) the port's server on loopback, a
    client thread asking for VIEWER_FRAMES orbit frames of the retained
    model at its full size, each frame's bytes held equal to a direct
    render's; (b) ``cli/train.py --ip`` for VIEWER_STEPS steps from phase
    7's checkpoint, a client asking for a frame with ``train=True`` at each
    step. Returns the phase's launches, counted from zero."""
    import math
    import threading

    import torch

    from mvs_gaussian_splatting_tpu_torch.cli.train import main as train_main
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import GaussianAux
    from mvs_gaussian_splatting_tpu_torch.ops.render import render
    from mvs_gaussian_splatting_tpu_torch.train.config import (
        ModelConfig, PipelineConfig)
    from mvs_gaussian_splatting_tpu_torch.train.loop import (
        _gui_pump, eval_config, eval_instance_cap, raster_config_from_pipe)
    from mvs_gaussian_splatting_tpu_torch.utils import graphics
    from mvs_gaussian_splatting_tpu_torch.viewer import network_gui
    from mvs_gaussian_splatting_tpu_torch.viewer.client import (ViewerClient,
                                                                orbit_camera)
    t0 = time.time()
    dev = torch.device("cuda")
    reset_launches()
    n = params.xyz.shape[0]
    z = torch.zeros(n, device=dev)
    aux = GaussianAux(alive=torch.ones(n, dtype=torch.bool, device=dev),
                      max_radii2d=z, xyz_grad_accum=z, denom=z)
    w, h = test_cams[0].width, test_cams[0].height
    fovx, fovy = float(test_cams[0].fovx), float(test_cams[0].fovy)
    centre = test_cams[0].camera_center.astype(np.float64)
    target = params.xyz.median(0).values.cpu().numpy().astype(np.float64)
    radius = float(np.linalg.norm((centre - target)[[0, 2]]))
    height = float(centre[1] - target[1])
    poses = [orbit_camera(2 * math.pi * i / VIEWER_FRAMES, radius, height,
                          target) for i in range(VIEWER_FRAMES)]
    eval_cfg = eval_config(raster_config_from_pipe(PipelineConfig()))
    rc = eval_cfg._replace(instance_cap=eval_instance_cap(n, eval_cfg))
    bg = torch.zeros(3, device=dev)
    model_cfg = ModelConfig(source_path=MODEL)

    def client(run, result):
        try:
            run(result)
        except Exception as e:   # noqa: BLE001 - a fault below
            result["error"] = repr(e)

    # (a) the server pumped as the loop pumps it, until the client is done
    network_gui.init("127.0.0.1", 0)
    port = network_gui.listener.getsockname()[1]

    def ask(result):
        with ViewerClient("127.0.0.1", port, timeout=120.0) as c:
            result["frames"] = []
            for R, T in poses:
                t1 = time.perf_counter()
                rgb, verify = c.request(w, h, R, T, fovx, fovy, train=False)
                result["frames"].append(
                    (rgb, verify, (time.perf_counter() - t1) * 1e3))

    result = {}
    th = threading.Thread(target=client, args=(ask, result), daemon=True)
    th.start()
    deadline = time.monotonic() + 300.0
    while th.is_alive() and time.monotonic() < deadline:
        _gui_pump(model_cfg, params, aux, eval_cfg, 3, 0, 1)
        time.sleep(0.001)
    th.join(timeout=60.0)
    network_gui.close()
    frames = result.get("frames", [])
    rows = []
    for (R, T), (rgb, verify, ms) in zip(poses, frames):
        # the camera the server builds from the request, unflipped: the
        # matrices in float64, as they come out of the JSON, so that its
        # campos is numpy's float64 inverse of the same array
        w2v = graphics.world_to_view(R, T).astype(np.float64)
        proj = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
        view = network_gui.MiniCam(w, h, fovy, fovx, 0.01, 100.0,
                                   np.ascontiguousarray(w2v.T),
                                   np.ascontiguousarray((proj @ w2v).T)
                                   ).view(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            img = render(view, w, h, params, bg, sh_degree=3,
                         alive=aux.alive, raster_config=rc)["render"]
        want = np.asarray(network_gui.render_to_bytes(img)).reshape(h, w, 3)
        render_ms = (time.perf_counter() - t1) * 1e3
        rows.append({"frame_ms": ms, "render_ms": render_ms,
                     "bytes_equal": bool(np.array_equal(rgb, want)),
                     "max": int(rgb.max()), "verify": verify})
    rec_a = {"size": [w, h], "frames": rows, "error": result.get("error"),
             "frame_ms_mean": float(np.mean([r["frame_ms"] for r in rows]))
             if rows else None,
             "render_ms_mean": float(np.mean([r["render_ms"]
                                              for r in rows]))
             if rows else None}
    if (len(rows) != VIEWER_FRAMES or th.is_alive() or any(
            not r["bytes_equal"] or r["max"] <= 10 or r["verify"] != MODEL
            for r in rows)):
        faults.append(f"viewer frames: {rec_a}")

    # (b) training while serving: cli/train.py --ip, one frame a step
    port = free_port()
    dataset = data["dataset"]

    def watch(result):
        sock_deadline = time.monotonic() + 300.0
        while True:
            try:
                c = ViewerClient("127.0.0.1", port, timeout=120.0)
                break
            except OSError:
                if time.monotonic() > sock_deadline:
                    raise
                time.sleep(0.02)
        with c:
            result["frames"] = []
            for i in range(VIEWER_STEPS):
                R, T = poses[i % len(poses)]
                rgb, verify = c.request(*VIEWER_TRAIN_SIZE, R, T, fovx,
                                        fovx, train=True)
                result["frames"].append((rgb.shape, int(rgb.max()), verify))

    result = {}
    th = threading.Thread(target=client, args=(watch, result), daemon=True)
    th.start()
    t1 = time.time()
    before_train = read_launches()
    _, _, _, hist = train_main(
        ["-s", dataset, "-m", os.path.join(tmp, "viewer_train"),
         "--start_checkpoint", data["checkpoint"],
         "--iterations", str(RESUME_ITER + VIEWER_STEPS),
         "--test_iterations", "0", "--log_every", "1", "--seed", str(seed),
         *TRAIN_FLAGS, "--ip", "127.0.0.1", "--port", str(port)])
    torch.cuda.synchronize()
    th.join(timeout=60.0)
    losses = [v for _, v in hist["loss"]]
    got = result.get("frames", [])
    rec_b = {"steps": len(losses), "frames": len(got),
             "finite": bool(np.isfinite(losses).all()),
             "error": result.get("error"),
             "launches": {k: v - before_train[k]
                          for k, v in read_launches().items()},
             "seconds": round(time.time() - t1, 1)}
    if (len(losses) != VIEWER_STEPS or len(got) != VIEWER_STEPS
            or th.is_alive() or not rec_b["finite"] or any(
                shape != VIEWER_TRAIN_SIZE[::-1] + (3,) or mx <= 10
                or verify not in (dataset, os.path.abspath(dataset))
                for shape, mx, verify in got)):
        faults.append(f"viewer while training: {rec_b}")
    launches = read_launches()
    emit({"phase": "viewer", "orbit": rec_a, "train_ip": rec_b,
          "launches": launches, "seconds": round(time.time() - t0, 1)})
    return launches


def tools_bench_phase(tmp, faults):
    """Phase 20: the tools (``tools/``) on the card through their entry
    points: the 1080p bench fast, ``--exact`` and ``--forward``; the train
    bench on fern and bicycle; the step profile; the scaling bench and the
    sharded compress pipeline at world size 1, the pipeline held to the
    JAX test's five criteria; ``graft_entry``'s ``entry()`` render against
    its plain version on the same projected Gaussians, and its
    ``dryrun_multichip(1)``. Every gradient finite and every overflow
    counted; a capacity overflow is a fault. Returns the launches."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.ops import stream
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
        bin_and_pack_stream
    from mvs_gaussian_splatting_tpu_torch.ops.render import render
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        activated, get_features)
    from mvs_gaussian_splatting_tpu_torch.tools import (
        bench, graft_entry, profile_step, scaling_bench,
        sharded_compress_pipeline, train_bench)
    t_phase = time.time()
    launches = {k: 0 for k in KERNELS}

    def counted(name, fn, check=None):
        """fn()'s result, emitted with its launches and seconds; with
        ``check``, check(result) in its place, run after the launches are
        read, so that a comparison's own launches are not the path's."""
        reset_launches()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        got = read_launches()
        add_launches(launches, got)
        seconds = round(time.time() - t0, 1)
        if check is not None:
            res = check(res)
        emit({"phase": f"tools_{name}", "result": res, "launches": got,
              "seconds": seconds})
        return res

    for name, kw in (("bench_fast", {}), ("bench_exact", {"fast": False}),
                     ("bench_forward", {"forward": True})):
        res = counted(name, lambda: bench.run(iters=TOOLS_BENCH_ITERS, **kw))
        extra = res["extra"]
        if not extra["finite"] or extra["tile_capacity_overflow_entries"] \
                or extra["overflow_visible"]:
            faults.append(f"tools {name}: {extra}")
    for wl in ("fern", "bicycle"):
        res = counted(f"train_bench_{wl}", lambda: train_bench.run(
            wl, iters=TOOLS_TRAIN_ITERS))
        extra = res["extra"]
        if not extra["finite"] or extra["nonfinite_grad_rows"] \
                or extra["overflow_capacity"] or extra["overflow_visible"] \
                or not extra["loss_last"] < extra["loss_first"]:
            faults.append(f"tools train_bench {wl}: {extra}")
    res = counted("profile_step", lambda: profile_step.run(iters=5))
    if res["overflow_capacity"]:
        faults.append(f"tools profile_step: {res['overflow_capacity']}")
    res = counted("scaling_bench", lambda: scaling_bench.run(1, "cuda"))
    for leg, rec in res["legs"].items():
        entry = rec["by_devices"]["1"]
        if entry["overflow"].get("capacity") or not np.isfinite(
                entry.get("loss", 0.0)):
            faults.append(f"tools scaling_bench {leg}: {entry}")
    res = counted("sharded_compress_pipeline",
                  lambda: sharded_compress_pipeline.run(
                      os.path.join(tmp, "shardcompress"), n_dev=1,
                      iters=TOOLS_PIPELINE_ITERS, device="cuda",
                      log=lambda *_: None))
    if not (res["psnr_trained_loop_eval"] > res["psnr_init"] + 0.5
            and abs(res["psnr_offline_raw_ply"]
                    - res["psnr_trained_loop_eval"]) < 0.2
            and res["compressed_npz_bytes"] < res["raw_ply_bytes"]
            and res["compression_delta_db"] < 3.0
            and res["psnr_offline_compressed"] > res["psnr_init"]
            and res["train_overflow_capacity"] == 0):
        faults.append(f"tools sharded_compress_pipeline: {res}")

    fn, (params, alive, cam, bg) = graft_entry.entry("cuda")

    def entry_path():
        return {"img": fn(params, alive, cam, bg),
                "dryrun_losses": graft_entry.dryrun_multichip(1, "cuda")}

    def entry_check(res):
        """B1 against its plain version on the card's own projected
        Gaussians (entry()'s layout, render()'s front half), and the
        image against render()'s."""
        img = res["img"]
        cfg = graft_entry.ENTRY_CONFIG
        size = graft_entry.ENTRY_SIZE
        tx = -(-size // cfg.tile_w)
        with torch.no_grad():
            s, r, o = activated(params)
            p = preprocess(params.xyz, o, cam, size, size, scales=s,
                           rotations=r, shs=get_features(params),
                           sh_degree=3, mask=alive, tile_w=cfg.tile_w,
                           tile_h=cfg.tile_h)
            bins, attrs = bin_and_pack_stream(p, tx, tx, cfg)
            ids = torch.arange(tx * tx, dtype=torch.int32, device="cuda")
            args = (attrs, bins.seg_start, bins.counts, bg, ids, tx,
                    cfg.tile_w, cfg.tile_h)
            out, tfin = stream.composite_stream(*args)
            ref, rtfin = stream.composite_stream_plain(*args)
            full = render(cam, size, size, params, bg, sh_degree=3,
                          alive=alive, raster_config=cfg)
        return {"shape": list(img.shape), "mean": float(img.mean()),
                "finite": bool(torch.isfinite(img).all()),
                "kernel_vs_plain_max_abs": max(
                    float((out - ref).abs().max()),
                    float((tfin - rtfin).abs().max())),
                "image_vs_render_max_abs": float(
                    (img - full["render"]).abs().max()),
                "overflow_capacity": int(bins.overflow_capacity),
                "dryrun_losses": res["dryrun_losses"]}

    res = counted("entry", entry_path, entry_check)
    if not (res["finite"] and res["kernel_vs_plain_max_abs"] <= TOL
            and res["image_vs_render_max_abs"] == 0.0
            and res["overflow_capacity"] == 0
            and all(np.isfinite(v) for v in res["dryrun_losses"].values())):
        faults.append(f"tools entry: {res}")
    emit({"phase": "tools_bench", "launches": launches,
          "seconds": round(time.time() - t_phase, 1)})
    return launches


def experiments_phase(faults):
    """Phase 21: the experiments (``tools/exp_binning.py``,
    ``tools/exp_scatter.py``, ``tools/exp_perf.py``) through their
    ``run`` at 1080p (200,000 Gaussians) and bicycle (500,000), one JSON
    line each; every check they hold (each binning variant integer-equal
    to ``bin_instances_stream``, each scatter within its tolerance of the
    float64 sum, ...) is a fault here when false, and so is a stream kernel
    that the kernels section did not launch. Returns the launches."""
    import torch

    from mvs_gaussian_splatting_tpu_torch.tools import (
        exp_binning, exp_perf, exp_scatter)
    t_phase = time.time()
    launches = {k: 0 for k in KERNELS}
    for mod in (exp_binning, exp_scatter, exp_perf):
        for wl in EXP_WORKLOADS:
            reset_launches()
            t0 = time.time()
            res = mod.run(wl, device="cuda")
            torch.cuda.synchronize()
            got = read_launches()
            add_launches(launches, got)
            name = res["experiment"]
            emit({"phase": f"experiments_{name}_{wl}", "result": res,
                  "launches": got, "seconds": round(time.time() - t0, 1)})
            failed = [k for k, ok in res["checks"].items() if not ok]
            if failed:
                faults.append(f"experiments {name} {wl}: {failed}")
    missing = [k for k in EXP_KERNELS if not launches[k]]
    if missing:
        faults.append(f"experiments: {missing} never launched")
    emit({"phase": "experiments", "launches": launches,
          "seconds": round(time.time() - t_phase, 1)})
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random stream and tile subsets")
    args = ap.parse_args(argv)
    t_start = time.time()

    # 1. card
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; "
                 "this check needs a CUDA card")
    from mvs_gaussian_splatting_tpu_torch.tools.measure import card
    smi = card()
    if smi is None:
        sys.exit("chip_smoke: nvidia-smi gave no card name and power limit")
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from mvs_gaussian_splatting_tpu_torch import kernels, profile_kernels
    from mvs_gaussian_splatting_tpu_torch.cli.render import (
        adaptive_eval_config, eval_raster_config, measure_tile_needs,
        params_from_ply, quantize_image)
    from mvs_gaussian_splatting_tpu_torch.data.cameras import camera_from_json
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        activated, get_features)
    from mvs_gaussian_splatting_tpu_torch.ops import stream
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import (
        assemble_stream_output, bin_and_pack_stream)
    from mvs_gaussian_splatting_tpu_torch.ops.render import render
    from mvs_gaussian_splatting_tpu_torch.train.config import PipelineConfig
    dev = torch.device("cuda")

    # 2. build: the kernel library and its section-clock build at once
    t0 = time.time()
    sec_path = kernels.BUILD_DIR / "libgs_kernels_sections.so"
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(kernels.build, True),
                    pool.submit(kernels.build, True, library=sec_path,
                                defines=profile_kernels.DEFINES)]:
            job.result()
    lib = kernels.library()
    libs = (lib, kernels.load(sec_path))
    ptxas = profile_kernels.ptxas(kernels.BUILD_LOG)
    occupancy = {f"{tw}x{th}": profile_kernels.occupancy(lib, tw, th)
                 for tw, th in ((16, 16), (32, 16), *LARGE_TILES)}
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "library": os.path.relpath(kernels.LIBRARY, ROOT),
          "ptxas": ptxas, "occupancy": occupancy})
    b3b_warps = occupancy["32x16"]["stream_bwd_fast"]["warps_per_sm"]
    spills = {name: [line for line in ptxas[name] if any(
        int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                   line))]
              for name in ("stream_bwd_fast", "stream_bwd", "padded_bwd")}

    # the model, its cameras and the measured eval layout
    t0 = time.time()
    with open(os.path.join(MODEL, "results.json")) as f:
        want_mean = json.load(f)["ours_25000"]["PSNR"]
    with open(os.path.join(MODEL, "per_view.json")) as f:
        want_view = json.load(f)["ours_25000"]["PSNR"]
    with open(os.path.join(MODEL, "cameras.json")) as f:
        cams = sorted((camera_from_json(e) for e in json.load(f)),
                      key=lambda c: c.image_name)
    test_cams = [c for i, c in enumerate(cams) if i % 8 == 0]  # llffhold 8
    params = params_from_ply(os.path.join(MODEL, "point_cloud_final.ply.gz"),
                             3, device=dev)
    n = int(params.xyz.shape[0])
    cfg_base = eval_raster_config(PipelineConfig(), n_gaussians=n)
    # the offline render measured needs over train and test views alike
    needs = measure_tile_needs(params, cams, cfg_base.tile_w, cfg_base.tile_h)
    layout = []
    cfg = adaptive_eval_config(cfg_base, needs, log=layout.append)
    bg = torch.zeros(3, device=dev)
    w, h = test_cams[0].width, test_cams[0].height
    tiles_x, tiles_y = -(-w // cfg.tile_w), -(-h // cfg.tile_h)
    emit({"phase": "setup", "gaussians": n, "cameras": len(cams),
          "test_views": [c.image_name for c in test_cams],
          "width": w, "height": h, "layout": layout,
          "max_tiles_per_gaussian": cfg.max_tiles_per_gaussian,
          "tier_budgets": list(cfg.tier_budgets),
          "tier_fracs": list(cfg.tier_fracs),
          "instance_cap": cfg.instance_cap,
          "seconds": round(time.time() - t0, 2)})

    def view_stream(cam):
        """(bins, attrs) of one view: render()'s front half."""
        with torch.no_grad():
            s, r, o = activated(params)
            p = preprocess(params.xyz, o, cam.view(dev), cam.width,
                           cam.height, scales=s, rotations=r,
                           shs=get_features(params), sh_degree=3,
                           tile_w=cfg.tile_w, tile_h=cfg.tile_h)
            return bin_and_pack_stream(p, tiles_x, tiles_y, cfg)

    def subset(counts_np, rng, k=32):
        heavy = np.argsort(-counts_np, kind="stable")[:k]
        rest = np.setdiff1d(np.arange(len(counts_np)), heavy)
        return np.concatenate([heavy, rng.choice(rest, min(k, len(rest)),
                                                 replace=False)])

    def kernel_vs_plain(attrs, seg_start, counts, bg_t, tile_ids, tx):
        out, tfin = stream.composite_stream(attrs, seg_start, counts, bg_t,
                                            tile_ids, tx, cfg.tile_w,
                                            cfg.tile_h)
        torch.cuda.synchronize()
        ref, rtfin = stream.composite_stream_plain(
            attrs, seg_start, counts, bg_t, tile_ids, tx, cfg.tile_w,
            cfg.tile_h)
        return (float((out - ref).abs().max()),
                float((tfin - rtfin).abs().max()))

    # 3. kernel vs plain version
    rng = np.random.RandomState(args.seed)
    bins, attrs = view_stream(test_cams[0])
    sel = subset(bins.counts.cpu().numpy(), rng)
    ids = torch.tensor(sel, dtype=torch.int32, device=dev)
    real = kernel_vs_plain(attrs, bins.seg_start[ids.long()].contiguous(),
                           bins.counts[ids.long()].contiguous(), bg, ids,
                           tiles_x)
    real_entries = int(bins.counts[ids.long()].sum())
    del bins, attrs
    syn = stream.random_stream(args.seed)
    sel = subset(syn["counts"], rng)
    gpu = {k: torch.from_numpy(syn[k]).to(dev)
           for k in ("attrs", "seg_start", "counts", "bg")}
    idx = torch.from_numpy(sel).to(dev)
    synthetic = kernel_vs_plain(
        gpu["attrs"], gpu["seg_start"][idx].contiguous(),
        gpu["counts"][idx].contiguous(), gpu["bg"],
        idx.to(torch.int32), syn["tiles_x"])
    gaps = {"real_view_out": real[0], "real_view_final_T": real[1],
            "synthetic_out": synthetic[0], "synthetic_final_T": synthetic[1]}
    emit({"phase": "kernel_vs_plain", "tolerance": TOL, "max_abs": gaps,
          "real_view": test_cams[0].image_name, "real_tiles": len(sel),
          "real_entries": real_entries,
          "synthetic_counts": {"empty": int((syn["counts"] == 0).sum()),
                               "one": int((syn["counts"] == 1).sum()),
                               "over_10_batches": int(
                                   (syn["counts"] > 2560).sum())}})
    # checks are collected and raised after the last measurement
    faults = []
    if b3b_warps < MIN_WARPS_B3B:
        faults.append(f"B3b at 32x16: {b3b_warps} resident warps per SM "
                      f"(want >= {MIN_WARPS_B3B})")
    if any(spills.values()):
        faults.append(f"register spills: {spills}")
    if max(gaps.values()) > TOL:
        faults.append(f"kernel disagrees with its plain version: {gaps}")

    # 4. the slice: the main path, counted from zero
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with torch.no_grad():                      # warm-up view
        render(test_cams[0].view(dev), w, h, params, bg, sh_degree=3,
               raster_config=cfg)
    torch.cuda.synchronize()
    rows = []
    for k, cam in enumerate(test_cams):
        before = stream.launches
        t0 = time.perf_counter()
        with torch.no_grad():
            out = render(cam.view(dev), cam.width, cam.height, params, bg,
                         sh_degree=3, raster_config=cfg)
        img = out["render"]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        q = quantize_image(img)
        name = f"{k:05d}.png"
        p_gt, _ = psnr(q, load_png(os.path.join(VIEWS, "gt", name)))
        p_jax, mse_jax = psnr(q, load_png(os.path.join(VIEWS, "renders",
                                                       name)))
        rows.append({"view": name, "ms": round(ms, 3), "psnr_gt": p_gt,
                     "psnr_gt_want": want_view[name], "psnr_vs_jax": p_jax,
                     "mse_vs_jax": mse_jax,
                     "launches": stream.launches - before,
                     "overflow_tiles": int(out["overflow_tiles"]),
                     "overflow_capacity": int(out["overflow_capacity"]),
                     "instance_load": int(out["instance_load"]),
                     "finite": bool(torch.isfinite(img).all())})
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    mean_gt = float(np.mean([r["psnr_gt"] for r in rows]))
    emit({"phase": "slice", "views": rows, "mean_psnr_gt": mean_gt,
          "mean_psnr_gt_want": want_mean, "launches": launches,
          "render_ms_mean": float(np.mean([r["ms"] for r in rows])),
          "peak_memory_bytes": peak})
    if abs(mean_gt - want_mean) > 0.02:
        faults.append(f"mean PSNR {mean_gt} vs {want_mean}")
    for r in rows:
        if abs(r["psnr_gt"] - r["psnr_gt_want"]) > 0.05:
            faults.append(f"{r['view']}: PSNR {r['psnr_gt']} vs "
                          f"{r['psnr_gt_want']}")
        if r["psnr_vs_jax"] is not None and r["psnr_vs_jax"] < 45.0:
            faults.append(f"{r['view']}: {r['psnr_vs_jax']} dB vs JAX render")
        # The reference layout's 16M-slot limit clips this model's widest
        # splats on purpose (runs/specfinal/NOTE.md), counted in
        # overflow_tiles; zero tile overflow is held on the clip-free
        # layout below.
        if r["overflow_capacity"]:
            faults.append(f"{r['view']}: capacity overflow "
                          f"{r['overflow_capacity']}")
        if r["launches"] != 1 or not r["finite"]:
            faults.append(f"{r['view']}: {r['launches']} kernel launches, "
                          f"finite {r['finite']}")

    # 4b. the same views on the clip-free layout (slot limit lifted)
    free_log = []
    free = adaptive_eval_config(cfg_base, needs, log=free_log.append,
                                slot_limit=1 << 28)   # memory guard only
    torch.cuda.reset_peak_memory_stats()
    free_rows = []
    for k, cam in enumerate(test_cams):
        before = stream.launches
        with torch.no_grad():
            out = render(cam.view(dev), cam.width, cam.height, params, bg,
                         sh_degree=3, raster_config=free)
        q = quantize_image(out["render"])
        p_gt, _ = psnr(q, load_png(os.path.join(VIEWS, "gt", f"{k:05d}.png")))
        free_rows.append({
            "psnr_gt": p_gt, "launches": stream.launches - before,
            "overflow_tiles": int(out["overflow_tiles"]),
            "overflow_capacity": int(out["overflow_capacity"]),
            "instance_load": int(out["instance_load"]),
            "finite": bool(torch.isfinite(out["render"]).all())})
    emit({"phase": "clip_free", "layout": free_log,
          "instance_cap": free.instance_cap, "views": free_rows,
          "mean_psnr_gt": float(np.mean([r["psnr_gt"] for r in free_rows])),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    for k, r in enumerate(free_rows):
        if (r["overflow_tiles"] or r["overflow_capacity"]
                or r["launches"] != 1 or not r["finite"]):
            faults.append(f"clip-free view {k}: {r}")

    # 5. stage times, kernel time, plain time and bound per view
    per_view, b1_splits = [], []
    reps = 5
    tile_ids = torch.arange(tiles_x * tiles_y, dtype=torch.int32, device=dev)
    for cam in test_cams:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        with torch.no_grad():
            ev[0].record()
            s, r, o = activated(params)
            p = preprocess(params.xyz, o, cam.view(dev), cam.width,
                           cam.height, scales=s, rotations=r,
                           shs=get_features(params), sh_degree=3,
                           tile_w=cfg.tile_w, tile_h=cfg.tile_h)
            ev[1].record()
            bins, attrs = bin_and_pack_stream(p, tiles_x, tiles_y, cfg)
            ev[2].record()
            call = (attrs, bins.seg_start, bins.counts, bg, tile_ids,
                    tiles_x, cfg.tile_w, cfg.tile_h)
            out, tfin = stream.composite_stream(*call)
            ev[3].record()
            assemble_stream_output(out, tfin, bins, p, tiles_x, tiles_y,
                                   cfg.tile_w, cfg.tile_h, cam.width,
                                   cam.height)
            ev[4].record()
        torch.cuda.synchronize()
        stages = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
                  enumerate(("preprocess", "bin_and_pack", "composite",
                             "assemble"))}
        k_ms = cuda_ms(lambda: stream.composite_stream(*call), reps)
        b1_splits.append(profile_kernels.kernel_split(*libs, "stream_fwd",
                                                      call))
        plain = []
        p_ms = cuda_ms(lambda: plain.append(stream.composite_stream_plain(
            *call, count_visits=True)))
        ref, rtfin, visits = plain[0]
        err = max(float((out - ref).abs().max()),
                  float((tfin - rtfin).abs().max()))
        t = tiles_x * tiles_y
        entries = int(bins.counts.sum())
        nbytes = 9 * 4 * entries + 3 * 4 * t + 3 * 4 + 16 * t * cfg.tile_w \
            * cfg.tile_h
        flops = FLOPS_PER_PAIR * visits
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / F32_FLOPS_PER_S * 1e3
        per_view.append({"stages_ms": stages, "ms": k_ms, "plain_ms": p_ms,
                         "err": err,
                         "bytes": nbytes, "flops": flops, "bytes_ms": b_ms,
                         "flops_ms": f_ms, "entries": entries,
                         "visits": visits})
        del bins, attrs, out, tfin, ref, rtfin, p, call, plain
    full_err = max(v["err"] for v in per_view)
    emit({"phase": "timing", "reps": reps, "views": per_view,
          "seconds_total": round(time.time() - t_start, 1)})
    if full_err > TOL:
        faults.append(f"kernel vs plain on full views: {full_err}")
    # 6. backward kernel vs plain version
    bwd_gap = bwd_vs_plain(view_stream, test_cams[0], subset, tiles_x,
                           cfg, args.seed, faults)
    # 6b-6c. the fast-math and padded kernels vs their plain versions
    fast_gap = fast_vs_plain(view_stream, test_cams[0], subset, tiles_x,
                             cfg, args.seed, faults)
    padded_gap = padded_vs_plain(args.seed, faults)

    # 7-9. the training paths and the padded backend, in a temporary
    # directory
    tmp = tempfile.mkdtemp(prefix="gs_chip_smoke_")
    try:
        data = write_training_inputs(tmp, cams, test_cams, args.seed)
        resume = train_resume(tmp, data, args.seed, faults, libs)
        init = train_init(tmp, data, args.seed, faults)
        padded = padded_phase(params, test_cams, free, data, tmp, args.seed,
                              faults, libs)
        cli = padded_cli(tmp, data, faults)
        large = large_tiles(params, cams, test_cams, cfg_base, data, tmp,
                            args.seed, faults, lib)
        flagship = dataset_phase(tmp, faults)
        grow = grow_resume(tmp, flagship, args.seed, faults)
        chain = eval_chain(tmp, flagship, faults)
        compressed = compress_phase(tmp, test_cams, cfg_base, cams, mean_gt,
                                    faults)
        tools_phase(tmp, flagship, faults)
        parallel = parallel_modes(tmp, data, flagship, params, test_cams,
                                  resume["step_ms_fast"], smi, args.seed,
                                  faults)
        mvs = mvs_phase(tmp, args.seed, faults)
        viewer = viewer_phase(tmp, data, params, test_cams, args.seed,
                              faults)
        tools = tools_bench_phase(tmp, faults)
        experiments = experiments_phase(faults)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # 10. sections: the split, the SASS loop and the issue-rate floor
    sass = profile_kernels.sass_loops(kernels.LIBRARY)
    mhz = resume["clock"]["sm_mhz"]
    bounds = {"stream_fwd": float(np.mean([max(v["bytes_ms"], v["flops_ms"])
                                           for v in per_view])),
              "stream_fwd_fast": resume["b3f"]["bound_ms"],
              "stream_bwd_fast": resume["b3b"]["bound_ms"],
              "stream_bwd": resume["b2"]["bound_ms"],
              "padded_fwd": padded["b4"]["bound_ms"],
              "padded_bwd": padded["b5"]["bound_ms"]}
    split_rows = {"stream_fwd": b1_splits,
                  "stream_fwd_fast": resume["sections"]["b3f"],
                  "stream_bwd_fast": resume["sections"]["b3b"],
                  "stream_bwd": resume["sections"]["b2"],
                  "padded_fwd": [padded["sections"]["b4"]],
                  "padded_bwd": [padded["sections"]["b5"]]}
    # phase 9's padded tables are on the clip-free eval layout
    layout = {"stream_fwd": "16x16", "stream_fwd_fast": "32x16",
              "stream_bwd_fast": "32x16", "stream_bwd": "32x16",
              "padded_fwd": f"{free.tile_w}x{free.tile_h}",
              "padded_bwd": f"{free.tile_w}x{free.tile_h}"}
    nbytes = {"stream_fwd": float(np.mean([v["bytes"] for v in per_view])),
              "stream_fwd_fast": resume["b3f"]["bytes"],
              "stream_bwd_fast": resume["b3b"]["bytes"],
              "stream_bwd": resume["b2"]["bytes"],
              "padded_fwd": padded["b4"]["bytes"],
              "padded_bwd": padded["b5"]["bytes"]}
    pair_ops = {"stream_fwd": (FLOPS_PER_PAIR, 0.0),
                "stream_fwd_fast": (FLOPS_PER_PAIR, 0.0),
                "stream_bwd_fast": (FLOPS_PER_PAIR_FAST_BWD,
                                    MMA_FLOPS_PER_PAIR),
                "stream_bwd": (FLOPS_PER_PAIR_BWD, 0.0),
                "padded_fwd": (FLOPS_PER_PAIR, 0.0),
                "padded_bwd": (FLOPS_PER_PAIR_BWD, 0.0)}
    sections = {}
    for name, rows in split_rows.items():
        agg = profile_kernels.aggregate(rows, sass.get(name), mhz)
        c = agg["counts"]
        # the bound on the work this run's data needs: contributing pairs
        # and the box test of each live warp-step, not every visited pair
        work = bound(nbytes[name],
                     pair_ops[name][0] * c["pairs_contributing"]
                     + BOX_TEST_OPS * c["warp_steps"],
                     pair_ops[name][1] * c["pairs_contributing"])
        sections[name] = dict(agg, bound_ms=bounds[name],
                              work_bound_ms=work[0], work_bound_by=work[1],
                              layout=layout[name],
                              **occupancy.get(layout[name], {}).get(name,
                                                                    {}))
    emit({"phase": "sections", "card": smi, "clock": resume["clock"],
          "kernels": sections})
    paths = {"render_slice": launches,
             "train_resume_fast": resume["launches"]["fast"],
             "train_resume_exact": resume["launches"]["exact"],
             "train_init": init["launches"], "padded": padded["launches"],
             "padded_cli": cli["launches"], "large_tiles": large["launches"],
             "dataset": flagship["launches"],
             **{f"grow_resume_{k}": v for k, v in grow.items()},
             **chain, "compress_render": compressed["launches"],
             "parallel_modes": parallel, "mvs": mvs, "viewer": viewer,
             "tools": tools, "experiments": experiments}
    totals = {k: sum(p[k] for p in paths.values()) for k in KERNELS}
    emit({"phase": "main_path_launches", "paths": paths, "totals": totals,
          "seconds_total": round(time.time() - t_start, 1)})
    for name, total in totals.items():
        if total == 0:
            faults.append(f"{name} never launched on the main paths {paths}")
    if faults:
        raise AssertionError("chip smoke failed: " + "; ".join(faults))
    mean = {k: float(np.mean([v[k] for v in per_view]))
            for k in ("ms", "plain_ms", "bytes_ms", "flops_ms")}
    measured = {
        "stream_fwd": {
            "max_abs_err": max(max(gaps.values()), full_err),
            "ms": mean["ms"], "plain_ms": mean["plain_ms"],
            "bound_ms": float(np.mean([max(v["bytes_ms"], v["flops_ms"])
                                       for v in per_view])),
            "bound_by": ("bytes" if mean["bytes_ms"] >= mean["flops_ms"]
                         else "operations")},
        "stream_bwd": dict(resume["b2"], max_abs_err=max(
            bwd_gap["max_abs_err"], resume["b2"]["max_abs_err"])),
        "stream_fwd_fast": dict(resume["b3f"], max_abs_err=max(
            fast_gap["fwd_max_abs"], resume["b3f"]["max_abs_err"])),
        "stream_bwd_fast": resume["b3b"],
        "padded_fwd": dict(padded["b4"], max_abs_err=max(
            padded_gap["fwd_max_abs"], padded["b4"]["max_abs_err"])),
        "padded_bwd": dict(padded["b5"], max_abs_err=max(
            padded_gap["max_abs_err"], padded["b5"]["max_abs_err"])),
    }
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": totals[name],
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None}
        for name, m in measured.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
