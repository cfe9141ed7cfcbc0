#!/usr/bin/env python3
"""Drive the sfmx_torch query-localization, map-scale serving, map-build
front-end and reconstruction paths (secondary components, the checkpointed
final BA, the merge of two sessions and self-calibration included), the
command line end to end, streaming, oriented and SIFT extraction, and the
multi-device paths (routed map shards, map-sharded localization, the
point-sharded BA and the dry run, on one card), the port of bench.py
(``sfmx_torch.bench``), the evaluation configs (``sfmx_torch.run_configs``,
the port of bench/run_configs.py) and ``serve`` started as its own process,
once on one CUDA card; or (``--cards 4``) the multi-device paths on four
cards, with ``serve --shards 4``, 5-serve and config 4 across them and two
ranks started apart over ``tcp://``.

Run from the repository root:  python3 chip_smoke.py [--profile]
                               python3 chip_smoke.py --cards 4 [--share-card]
(``python3 chip_smoke.py --tune`` runs instead the sweeps behind K1's tile
and fused-step constants, K2's tile, K3's keypoints per block, K4's landmark
tile, ring depth and splits, K5's pairs per block and ring depth, K6's slot
groups, K7's slot groups, and K8's slot groups and camera-table staging,
and prints no result lines.)

Phases (each asserts; any failure exits non-zero):
  1. device     — needs torch.cuda; prints the card and its power limit
  2. build      — compiles the CUDA kernels K1-K10 and the fixed-order
                  segment sum from sfmx_torch/csrc,
                  one nvcc per source, and native/tracks.cpp with g++, all
                  started together
  3. kernels    — K1-K3 against their plain PyTorch versions at the gather
                  path's shapes (B=16, 480x640 and 240x320, L=5, K=1024/512),
                  max abs error beside the stated tolerance, CUDA-event times;
                  again at the serving run's batches (B=32 and the B=2 tail)
                  after phase 8, and the B=32 numbers go in the kernels line
                  (with --profile K3's device time per call by torch.profiler)
  4. map        — renders 24 keyframes of the textured room (640x480,
                  f=560), extracts them on the card, back-projects every
                  valid keypoint onto the room box at the true pose, and
                  builds a VLAD localization map (with majority-vote bits)
  5. queries    — 16 held-out frames through ``localize_images`` with the
                  default PipelineConfig (gather path; kernel launch counts
                  are taken around it), the 0.2 m median-error gate; then 4
                  of them on the card against the plain path on the CPU with
                  the same RANSAC noise (bench.py's tripwire runs in phase 41)
  6. rate       — steady-state gather-path frames/s (extraction + localize)
  7. tracking, p3p, binary — the 16 frames through ``localize_sequence``
                  (most must be tracked), with ``pnp_solver="p3p"`` and with
                  Hamming matching on the map's bits, each under the gate
  8. map-scale  — the 24 keyframes merged to one landmark per surface cell,
                  plus distractor rooms (other textures, translated away) up
                  to >= 131,072 landmarks, so ``streaming="auto"`` picks K4
  9. K4         — match_top2 against its plain version on the first serving
                  batch's query descriptors (32x1024 rows) and on the burst
                  tail's (2x1024 rows, where the kernel splits the landmark
                  loop and a second launch merges) vs the whole pool, each
                  with its own bound; split and unsplit results bit-equal;
                  with --profile what ``match_float_streaming`` adds around
                  the kernel (device ms, host us)
 10. serve      — 8 bursts, one after another, of 66 concurrent image
                  requests through ``LocalizationService`` (max_batch 32,
                  window 5 ms) under asyncio.gather, a quarter with a beacon
                  prior, two with their own intrinsics; gates over all 528:
                  streaming chosen, median center error < 0.2 m, >= 75 %
                  localized, batches < requests, each batch one streaming
                  localize call, K4 launches == the sum over those calls of
                  what the wrapper says their query rows take (2 where it
                  splits); p50/p95/p99 latency over all requests, mean
                  batch, requests/s
 11. streaming  — one B=32 batch through ``localize_batch_streaming`` on the
                  card and on the CPU's plain path with the same RANSAC
                  noise (centers within 3 cm), and steady-state frames/s of
                  extraction + streaming localize at B=32
 12. profile    — only with --profile: device time per batch of each stage
                  of both paths under torch.profiler, the device's busy
                  share of the wall time, the top device ops; the tables go
                  to chiprun_out/profile_*.txt
 13. front end  — renders a 256-frame VGA walk across the room and back and
                  runs ``build_front_end`` (extract, pairs, match, verify,
                  tracks; ``PipelineConfig()`` defaults: 1024 keypoints,
                  ratio 0.85, cross-check, 256 E-RANSAC hypotheses, 16
                  inliers per kept pair) three times, launch counts set to 0
                  before each: its first 96 frames exhaustively (4,560 pairs
                  on K5), all 256 by retrieval pairs (window 8, k 8) in band
                  tiles (K9, leftovers K5), and the 96 frames' window pairs
                  with binary descriptors (plain Hamming).  Stage walls,
                  pairs/s, tracks.  Gates: the plain matcher never runs on
                  the card; >= 95 % of verified matches join keypoints whose
                  raycast surface points lie within max(3 cm, the keypoint's
                  scale at its depth); >= 85 % of track observations that
                  close to their track's median point, and the track table
                  equal to the numpy union-find's; every adjacent-frame pair
                  keeps >= 16 inliers; a loop closure across the two passes
                  survives verification
 14. pair kernels — K5 and K9 against the plain matcher on the card at the
                  4,560 exhaustive pairs and at the band list (score within
                  1e-5, valid and accepted idx equal outside near-ties), K9
                  equal to K5 in every field; K10 (K5's raw mode, one
                  launch) on 512 pairs as its own path, against its plain
                  version; times
 15. front crosscheck — 16 adjacent pairs: the card's match and verify
                  stages against the plain CPU path with the same Gumbel
                  noise (valid equal outside near-ties; per pair, inlier
                  counts within 1 %, inlier masks equal but for matches near
                  the threshold and that slack); with --profile, device ms
                  and busy share per stage
 16. counters   — launches of the gather path's run against the count it
                  implies, of the serving run (K1-K4 all > 0), and of each
                  front-end build (K1-K3 per extraction call, K1 one per
                  chunk of fused FED steps, K2 one; K5 and K9 two per
                  wrapper call, K10 one)
 17. BA kernels — a random bundle-adjustment problem of 512 cameras, 20,000
                  points and 200,000 observations (tp = 32 slots per point,
                  30 CG steps): K7, K6 and K8 against their plain versions
                  (errors relative to the largest entry, K7's b_c, b_p and
                  cost to their rounding scale, beside the stated
                  tolerances), CUDA-event times, with --profile K6's and
                  K8's device time per call by torch.profiler (phase 18
                  repeats this at the build's own shapes, whose numbers go
                  into the kernels line), LM iterations/s of
                  ``ba_solve(dense_cg=True)`` beside the planes path, and
                  the same dense solve and the same planes solve twice
                  (each bit-identical, asserted); with
                  --profile the solve's device ms and busy share; then the
                  fixed-order segment sum (``kernels/segment_sum``) on the
                  problem's camera (O,36) and point (O,9) sums and on one
                  segment of all O rows (the joint intrinsics' group sum,
                  two launches) against its plain version (1e-5 of the
                  largest sum), two calls and a table shuffled within its
                  segments' order bit-equal, beside ``index_add_``
 18. build_map  — the 96-frame exhaustive build again, now through
                  ``build_map`` to a ``Scene`` (default ``PipelineConfig``,
                  the default ``ReconConfig``: the component loop is entered
                  and skipped), launch counts set to 0 before it.
                  Gates: 96/96 registered, median reprojection < 1 px, ATE
                  of the camera centers against the rendered poses < 0.1 m
                  after a similarity alignment, the final BA on the dense
                  path, K6/K7/K8 launched with K6 = (cg_iters + 2) x K7 and
                  K8 = K7 / 2 + dense BA calls (K7 is two launches a call,
                  K8 one, once per LM iteration and once per solve); then
                  K6-K8 against their plain versions on the final BA's
                  table
 19. loop       — ``save_scene``, ``load_scene_np``,
                  ``build_localization_map`` from the built scene, and 16
                  held-out frames localized against it: median center error
                  < 0.2 m after the same similarity, >= 12/16 localized
 20. BA crosscheck — one 8-camera ``ba_solve`` on the card (K6-K8) against
                  the plain path on the CPU
 21. ckpt       — the 96-frame build's final-BA table on the dense path (tp
                  covering its longest track, so no overflow): 25 LM
                  iterations checkpointed every 10 beside one uninterrupted
                  solve, five times in turn (the overhead's spread), and 10
                  iterations resumed from their file to 25 by a new call;
                  gate: all bit-identical; K6-K8 launches per chunk; then
                  ``build_map`` with ``recon.final_ba_ckpt`` under the build
                  gates.  The path's launches: the first checkpointed solve,
                  the resumed one and that build
 22. components — the reference's stalling scene (two camera arcs around two
                  clusters joined by a small boundary cloud) at the build's
                  size: 2 x 48 cameras, 3,000 points a cluster, 40 shared,
                  K=1024 noise-free keypoints; 4,560 pairs on K5, tracks,
                  ``reconstruct`` with 25 resection/init inliers; gates: one
                  component leaves an arc unregistered, the default
                  registers all 96 through a verified component 1 (>= 8
                  inliers), ATE < 0.1, < 1 px, the fusion BA's three anneal
                  solves (8x, 2x, 1x Huber) dense with K6-K8 launched in
                  each; K6-K8 against their plain versions on the 8x table
                  with 2 % of its observations moved 40-400 px (past the 8x
                  knee)
 23. merge      — two sessions of the 96 frames (0-59, 36-95) through
                  ``build_map`` and ``merge_scenes``; gates: the edge
                  verified, the joint BA's cost falls (planes path, as the
                  reference's), ATE of the 120 merged centers < 0.1 m; the
                  path's launches are merge_scenes' (the segment sums of
                  its joint BA)
 24. selfcal    — self-calibration from a focal 5 % high with
                  ``refine_intrinsics=("f",)``: the 96 frames through
                  ``build_map`` (gates: 96/96, ATE < 0.1 m, median
                  reprojection < 1 px under the refined intrinsics, the
                  joint LM's cost not raised; the focal is printed, not
                  gated: its seed pair decides it, S3 in ROADMAP.md; the
                  reconstruct inputs go to .chip_scratch/selfcal_walk.npz
                  for tests/selfcal_walk.py), and one
                  arc of 48 cameras of phase 22's world (the reference
                  test's recipe; gates: focal within 3 %, 48/48, ATE < 0.1,
                  < 1 px); with --profile the device time and busy share of
                  phase 22's first fusion solve and of the walk's joint
                  solve
 25. cli        — the CLI at full width (``PipelineConfig()`` defaults, VGA),
                  every command through ``sfmx_torch.cli.main.main([...])``
                  with ``--device cuda``; the 96 frames written as 8-bit
                  PNGs that the command line decodes (PIL): build-map
                  (96/96, < 1 px, ATE < 0.1 m, stage walls), localize of
                  16 held-out frames (median < 0.2 m, >= 12 localized),
                  evaluate against the true centers (ATE
                  < 0.1 m), export (vertices = alive points + 5 per camera),
                  georeference on 4 control cameras (control_rmse < 0.1),
                  merge of two build-map stores (frames 0-59, 36-95: ATE
                  < 0.1 m), bundle / unbundle byte-equal
 26. streaming  — ``extract_features_streaming`` of the 96 files in chunks of
                  16 against eager extraction of the decoded frames (bit for
                  bit, else within 1e-4 and why), both walls, the busy share;
                  ``build-map --stream`` (96/96)
 27. oriented   — ``oriented=True`` on a B=16 VGA batch, card against this
                  machine's CPU (>= 95 % of keypoints within 0.01 px and
                  1e-3 rad, descriptors within 1e-3), device ms beside the
                  upright batch's; tests/test_features.py's 25-degree rotated
                  pair gates on the card
 28. sift       — ``extractor=sift`` card against CPU (4 VGA frames, as 27);
                  tests/test_sift.py's gates at its sizes on the card; the 96
                  frames through ``build_map`` with SIFT, printed, ungated
 29. determinism — build-map of the 96 frames a second time with the same
                  seed: stats (timings aside) and every scene and feature
                  array bit-identical with phase 25's (asserted; where not,
                  which differ and by how much is logged first); both under
                  the build gates
 30. serve shards — phase 10's 8 bursts of 66 image requests through
                  ``LocalizationService.load_map(shards=2)``: the map-scale
                  map split into two shards, both on cuda:0, each batch's
                  queries routed by retrieval and localized per shard group
                  on the gather path; requests/s, latency percentiles, the
                  serve gates (median < 0.2 m, >= 75 % localized, each
                  own-intrinsics request < 0.2 m); K1-K3 launched
 31. sharded    — one B=32 VGA batch (32,768 query rows) against the
                  map-scale map split into 2 and into 4 landmark shards on
                  cuda:0: each shard's K4 and the merge in shard order equal
                  to the unsplit K4 in every field, the poses equal to
                  ``localize_batch_streaming``'s with the same noise; K4's
                  device ms per shard launch
 32. block BA   — bench/run_configs.py's config 4 (2,048 cameras, 200,000
                  points, 798,720 observations, 8 LM iterations x 25 CG
                  steps) through ``ba_solve_blocked`` on one NCCL rank
                  beside the planes ``ba_solve`` (final costs within 5 %);
                  the joint-intrinsics block solve; the checkpointed block
                  solve resumed after its first chunk, bit-identical to the
                  uninterrupted one
 33. dry run    — ``sfmx_torch.dist.dryrun`` in one spawned NCCL rank and in
                  two gloo ranks sharing cuda:0: every multi-device path,
                  each result finite; K1-K5 launched in the NCCL run
 41. bench      — ``sfmx_torch.bench.main`` in this process (bench.py's
                  functions at bench.py's shapes, the tripwire first; its
                  two JSON lines, then the bench line again prefixed
                  ``bench``): every rate finite and > 0, the map build's
                  registration gate (>= 90 %, raised inside), each
                  function's launches (counted from 0 for it): K4 in the
                  tripwire and the streaming bench, K1-K3 in the headline,
                  extract and build, K5 in both matching benches and the
                  build, K6-K8 in the BA bench; then K4 at the streaming
                  bench's 8,192 query rows x 100,352 landmarks and K5 at the
                  matching bench's 512 random pairs (K = 512) against their
                  plain versions on those inputs (phases 9 and 14's
                  tolerances)
 42. configs    — ``sfmx_torch.run_configs`` in this process, each config's
                  JSON line logged with the card: 1 (the demo), 2 (32 room
                  frames built, each localized), 3 (global BA at 512 /
                  20,000 / 200,000 on the planes path), 4 (the 2,048-camera
                  corridor's block BA on one spawned NCCL rank), 5 (three
                  synthetic sessions merged), 2+ at 128 room frames (the
                  streaming CLI build of PNG files), 5-serve at 48 frames
                  a session (4 shards on cuda:0, the queries POSTed as PNGs
                  to the HTTP app) and 4-build at
                  256 corridor frames (one NCCL rank).  Gates: every
                  ``pass`` the reference computes (1, 2+, 5-serve, 4-build),
                  ATE < 0.1 m (2, 5), finite costs (3, 4); each config's
                  launches counted from 0: K1-K3 and K5 in the builds, the
                  segment sum in 3, 4, 5, 5-serve and 4-build's rank, K6-K8
                  exactly where a reconstruction took the dense BA path
 44. serve process — the README's deployment: ``python -m
                  sfmx_torch.cli.main serve --map demo=<phase 25's map>
                  --port P`` started with ``subprocess.Popen`` (its own
                  process, its output in files under .chip_scratch/cli/),
                  4 bursts of 16 concurrent PNG POSTs of phase 25's
                  held-out frames over 127.0.0.1, /maps and /stats, then
                  SIGINT.  Gates: ready within 300 s, phase 10's (median
                  center error < 0.2 m after the map's similarity, >= 75 %
                  localized), /stats counting every request in fewer
                  batches, each answer within 5 cm of the in-process
                  ``make_service``'s for the same image (at most a tenth of
                  the queries localized by one only), exit code 0 within
                  30 s of SIGINT, K1-K3 in the server's launches during the
                  traffic (its shutdown line less its loaded line, both
                  printed by ``serve``); p50/p95/p99 at the client,
                  requests/s, the card's busy share (nvidia-smi)

With ``--cards 4`` the device check, the build, the map-scale map, phases
3, 9 and 13-18 (every kernel against its plain version, the front end and
the 96-frame build: the run's kernels line), then phases 34-40, 43 and 45-48
run.  It needs four visible cards of one name and power limit
(fewer raise, with the count), spawns worlds of 4, 2 and 1 ranks, each
rank on its own card under NCCL (``sfmx_torch.dist.worlds``: the parent
writes each phase's inputs once under .chip_scratch/multicard/, every rank
writes its results there), and holds them against one card in the parent.
``--share-card`` rehearses the same on one card, every rank a gloo rank on
cuda:0 (routed shards on cuda:0).
 34. cards and links — each card's name and power limit, peer access, the
                  NCCL version; all_reduce and all_gather_into_tensor at 1
                  and 64 MB at world size 4 (exact sums, the seeded sum and
                  gather on every rank): ms and bus bandwidth, the
                  yardstick of phases 36, 38 and 39
 35. dp extraction — the walk's first 64 VGA frames through
                  ``dryrun.extract_data_parallel`` (16 a card): every rank's
                  gathered features equal, and equal to one card's of all
                  64; each card's quarter bit-equal to cuda:0's extraction
                  of its 16 frames; K1-K3 on every rank; frames/s at world
                  sizes 1 and 4
 36. map-sharded — phase 31's batch through ``localize_batch_sharded`` on 4
                  (then 2) landmark shards, one a card, the noise drawn on
                  the CPU from a seed: every rank's merged (s1, global
                  index, s2) equal to the unsplit K4, the poses to
                  ``localize_batch_streaming``'s (n_inliers equal, centers
                  within 1e-5 m), median error < 0.2 m, K4 on every rank;
                  K4's device ms a card, the all-gather and the all-reduce
                  against phase 34
 37. serve cards — phase 10's bursts through ``load_map(shards=4)`` (shard
                  i on cuda:i) under phase 30's gates, and the same four
                  shards all on cuda:0, in turns (cards, cuda:0, cuda:0,
                  cards); then the same with traffic spread over the
                  building (4 held-out frames of each of its 8 rooms, every
                  shard gets queries: median < 0.2 m, >= 75 % localized);
                  requests/s, p50/p95/p99, each card's busy share over two
                  profiled bursts and the time two or more cards were busy
                  at once
 38. block cards — config 4 through ``ba_solve_blocked`` at world sizes 1,
                  2, 4: final cost within 5 % of the planes ``ba_solve`` on
                  one card and falling, R, t, X, costs bit-identical on
                  every rank, the joint focal within 5 px, the checkpointed
                  solve resumed after its first chunk bit-identical, the
                  same solve twice bit-identical; LM iterations/s, the
                  layout's host time and stats, a CG step's collectives
                  against phase 34, the segment sum's device time on a
                  rank's block
 39. obs cards  — ``dist_ba.make_ba_step`` on ba-512 (10 LM x 30 CG) at
                  world sizes 1, 2, 4: ranks bit-identical, final cost
                  within 5 % of the planes ``ba_solve``; LM iterations/s, a
                  CG step's two all-reduces against phase 34
 40. dry run    — ``dryrun.dryrun`` at world size 4 on the cards (every
                  rank's results equal, K1-K5 on each) beside
                  ``python -m sfmx_torch.dist.dryrun --world-size 4
                  --device cpu``: BA costs and the map-sharded t within
                  1e-4
 43. real scene — config 4-build across cards: 256 corridor frames built
                  through ``run_configs.config2_scale`` on cuda:0, then
                  ``run_configs.block_ba_real_scene`` on that scene at world
                  sizes 4 and 1, a card a rank: every rank's R, t, X and
                  costs bit-identical, the cost monotone, world 4's final
                  cost within 5 % of world 1's, the segment sum on every rank
 45. serve process on cards — phase 44 with ``--shards 4``: phase 25's map
                  built again by build-map on cuda:0, the server's shard i on
                  cuda:i (from its loaded line), each card's busy share
                  sampled from nvidia-smi over the traffic
 46. 5-serve on cards — ``run_configs.config5_serve`` at 48 frames a
                  session, its four shards on cuda:0-3 (``load_map``'s
                  placement, recorded), 5-serve's own gates
 47. config 4 on cards — ``run_configs.config4`` (the harness) at world
                  sizes 4 and 1 in this call: every rank's R, t, X, costs
                  bit-identical, each cost trace monotone, world 4's final
                  cost within 5 % of world 1's; LM iterations/s at both
 48. ranks apart — two NCCL ranks on cuda:0 and cuda:1, each its own
                  ``subprocess.Popen`` of ``python -m sfmx_torch.dist.mesh
                  sfmx_torch.dist.worlds:world`` joined over
                  ``tcp://127.0.0.1:<free port>`` (no spawn, no file://
                  store), running phase 39's ba-512 step at world 2:
                  bit-equal to phase 39's spawned world 2
That mode's last lines are a ``multicard`` JSON (each phase's numbers,
each rank's launches by world and phase, the serving runs'), the cards'
nvidia-smi lines, the kernels JSON (as the default run's, launches summed
over every rank, the server process and the one-card paths) and the device
JSON.

The default run's last two lines are the kernel JSON and the device JSON.
K4's entry holds the serving batch's shape and, as ``tail_ms``, ``tail_bound_ms`` and
``splits``, the burst tail's; ``ms`` times the wrapper on f32 descriptors
(its casts to bf16 included, as the main path calls it), ``launch_ms`` the
launches alone on bf16 inputs.  Every kernel
carries ``bound_ms``: the larger of its necessary bytes (inputs read once,
outputs written once) at 3.35 TB/s and its operations at the card's peak
for their type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32), from this
run's shapes; ``library_ms`` is null for K1-K10: no single PyTorch call
computes any of these functions (the matchers' plain versions are a matmul
plus top-k, mask and gather calls; the BA kernels' several gathers and
block products); the segment sum's is ``index_add_``'s (float atomics: the
same sums, not the same bits from run to run).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
W_IMG, H_IMG, FOCAL = 640, 480, 560.0
N_KEYFRAMES, N_QUERIES = 24, 16
INTR = np.array([FOCAL, FOCAL, W_IMG / 2, H_IMG / 2, 0.0, 0.0, 0.0], np.float32)
MEDIAN_GATE_M = 0.2
MAP_SCALE_LANDMARKS = 131072   # >= 2x LocalizeConfig.streaming_min_landmarks
N_SERVE, SERVE_BATCH, SERVE_WINDOW_MS = 64, 32, 5.0
N_BURSTS = 8                   # serving bursts, one after another, on one service
N_TAIL = 2                     # images in a burst's last batch (66 = 32 + 32 + 2)
FOCAL_OWN = 600.0              # the two requests that carry their own intrinsics
RENDER_WORKERS = 8
N_BUILD, N_BAND = 96, 256      # exhaustive build (4,560 pairs); the band build's loop walk
N_K10_PAIRS, N_XCHECK_PAIRS = 512, 16
XCHECK_SLACK = 0.01            # card vs CPU verify: 1% of a pair's inliers (at least 2)
TRUTH_M, TRUTH_SHARE = 0.03, 0.95   # true match: surface points within 3 cm (or sigma)
TRACK_OBS_SHARE = 0.85         # true track observations (the reference's builder: 0.88-0.95)
NEAR_TIE = 1e-5                # score gap under which summation order may flip a winner

BA_SHAPE = dict(C=512, P=20000, O=200000, tp=32, cg_iters=30, lm_iters=10)
CKPT_ITERS, CKPT_EVERY, CKPT_REPS = 25, 10, 5    # phase B: the checkpointed final BA
N_ARC, N_CLUSTER, N_SHARED = 48, 3000, 40       # phase C: the two-cluster world
FUSE_OUTLIERS = 0.02                            # phase C: observations moved for the K6-K8 check
MERGE_SESSIONS = ((0, 60), (36, 96))            # phase D: two sessions of the 96 frames
FOCAL_GUESS = 1.05                              # phase E: the focal guess, x the true one
N_LOOP_QUERIES, N_LOOP_MIN = 16, 12
ATE_GATE_M, REPROJ_GATE_PX = 0.1, 1.0
HBM_BYTES_S, PEAK_OPS_S = 3.35e12, {"bf16": 989e12, "f32": 67e12}

SERVE_KERNELS = ("diffuse_segment", "response_levels", "describe_upright", "match_top2")
# kernel name -> (source, TPU kernel it replaces, stated tolerance on max abs error)
KERNELS = {
    "diffuse_segment": ("sfmx_torch/csrc/scale_space.cu",
                        "sfmx/kernels/pallas_scale_space.py:89", 1e-4),
    "response_levels": ("sfmx_torch/csrc/scale_space.cu",
                        "sfmx/kernels/pallas_scale_space.py:141", 1e-6),
    "describe_upright": ("sfmx_torch/csrc/describe.cu",
                         "sfmx/kernels/pallas_describe.py:172", 1e-5),
    "match_top2": ("sfmx_torch/csrc/match_top2.cu",
                   "sfmx/kernels/pallas_match.py:100", 1e-5),
    "match_pairs_fused": ("sfmx_torch/csrc/match_pairs.cu",
                          "sfmx/kernels/pallas_pairs.py:253", NEAR_TIE),
    "match_pairs_tiled": ("sfmx_torch/csrc/match_pairs.cu",
                          "sfmx/kernels/pallas_tiles.py:214", NEAR_TIE),
    "match_pairs_top2": ("sfmx_torch/csrc/match_pairs.cu",
                         "sfmx/kernels/pallas_pairs.py:127", NEAR_TIE),
    "schur_cross_matvec": ("sfmx_torch/csrc/ba.cu", "sfmx/kernels/segsum.py:302", 1e-4),
    "ba_assemble_fused": ("sfmx_torch/csrc/ba.cu", "sfmx/kernels/segsum.py:516", 1e-4),
    "ba_cost_fused": ("sfmx_torch/csrc/ba.cu", "sfmx/kernels/segsum.py:587", 1e-4),
    # not a Pallas kernel: the reference's jax.ops.segment_sum (XLA's scatter-add)
    "segment_sum": ("sfmx_torch/csrc/segment_sum.cu", "sfmx/solvers/schur.py:76", 1e-5),
}
# Tolerances: K1 — the kernel contracts multiply-adds into FMAs and the
# Perona-Malik steps amplify last-bit differences (levels lie in [0,1]);
# K2 — responses peak near 1e-2, so 1e-6 is 1e-4 relative; K3 — cell means
# of [0,1] samples, summed in another order than the plain version; K4, K5,
# K9, K10 — scores of unit vectors in [-1,1]: the bf16 products are exact in
# f32 and only the order of the 128-term sums differs, so winners are
# compared outside near-ties (a gap below NEAR_TIE); K6-K8 — errors relative
# to the output's largest entry: the reprojection residual is a difference
# of pixel coordinates ~300 that leaves ~0.3, so an FMA contracted otherwise
# moves it by ~3e-5 relative, a Huber weight delta/|r| repeats that, and the
# sums over a point's or a camera's observations run in another order.  K7's
# b_c, b_p and cost are sums of weighted residuals, which near an optimum are
# rounding of that difference: their errors are taken over their rounding
# scale (``rounding_scales``), where f32 against f64 of the plain version
# gives 3e-10 to 3e-8 on random problems (at the optimum, started off it,
# with 2 % of the observations 40-400 px out), so ROUND_TOL leaves 300x.
# The segment sum: errors over the largest sum; f32 sums of up to 200,000
# terms of unit normals in two orders differ by ~1e-6 of it.
ROUND_TOL = 1e-5


def bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """The least time the card could take: necessary bytes at the memory
    rate against necessary operations at the peak rate of their type."""
    t_b, t_o = n_bytes / HBM_BYTES_S * 1e3, n_ops / PEAK_OPS_S[kind] * 1e3
    return {"bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": None}


def log(msg: str) -> None:
    print(msg, flush=True)


def render(tex, poses) -> np.ndarray:
    from tests import smoke_scenes

    return smoke_scenes.render(tex, poses, W_IMG, H_IMG, FOCAL)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int = 7, warm: int = 2) -> float:
    """Median device time of fn() in ms, one CUDA-event pair per run."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_per_call(fn, n: int = 20, reps: int = 5) -> float:
    """Median over reps of the CUDA-event time of n calls back to back, per
    call: past the first call the host's path overlaps the device's work,
    so a short kernel's time is not its wrapper's."""
    return cuda_ms(lambda: [fn() for _ in range(n)], reps=reps, warm=1) / n


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from sfmx_torch.kernels import _build
    from sfmx_torch.recon import _native_tracks

    t0 = time.perf_counter()
    libs = ("scale_space", "describe", "match_top2", "match_pairs", "ba", "segment_sum")
    # one nvcc per source and the track builder's g++, all together, so no
    # build lands in a measured stage
    with ThreadPoolExecutor(len(libs) + 1) as ex:
        futures = [ex.submit(_build.load, lib) for lib in libs]
        futures.append(ex.submit(_native_tracks._lib))
        for f in futures:
            f.result()
    log(f"[build] {time.perf_counter() - t0:.2f} s (nvcc per library: "
        f"{json.dumps({k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()})}; "
        f"native/tracks.cpp with g++ beside them)")


def k3_read_bytes(levels, kp) -> int:
    """The level bytes K3 must read for these keypoints: the union over the
    batch's unmasked keypoints of the 2x2 neighbourhoods of their 24x24
    samples, inside the level (the zero padding is not read).  The sampling
    is separable, so a keypoint touches the outer product of its 48 sampled
    rows and 48 sampled columns."""
    import torch

    from sfmx_torch.kernels import describe as dsc

    B, L, H, W = levels.shape
    K = kp.uv.shape[1]
    Hp, Wp = dsc.padded_size(H, W)
    y0, x0, fy, fx, sp = dsc._window_params(kp.uv, kp.sigma, Hp, Wp)
    off = (torch.arange(24, dtype=torch.float32, device=levels.device) - 11.5) * sp[..., None]
    xs = torch.clamp(x0.float()[..., None] + fx[..., None] + off, 0.0, Wp - 1.001)
    ys = torch.clamp(y0.float()[..., None] + fy[..., None] + off, 0.0, Hp - 1.001)
    cols = torch.stack([torch.floor(xs), torch.floor(xs) + 1], -1).long().reshape(B, K, 48)
    rows = torch.stack([torch.floor(ys), torch.floor(ys) + 1], -1).long().reshape(B, K, 48)
    plane = (torch.arange(B, device=levels.device)[:, None] * L + kp.level.long())   # (B,K)
    idx = ((plane[..., None] * H + rows)[..., :, None] * W + cols[..., None, :])
    ok = (kp.mask[..., None, None] & (rows < H)[..., :, None] & (cols < W)[..., None, :])
    seen = torch.zeros(B * L * H * W, dtype=torch.bool, device=levels.device)
    seen[idx[ok]] = True
    return int(seen.sum()) * 4


def phase_kernels(images, dev, profile: bool = False) -> dict:
    """K1-K3 vs their plain versions on a batch of the main path's inputs
    (both octaves); returns octave 0's times and the larger error.  With
    ``profile`` also K3's device time per call by torch.profiler."""
    import torch

    from sfmx_torch.kernels import describe as dsc
    from sfmx_torch.kernels import features as F
    from sfmx_torch.kernels import scale_space as ss

    cfg = F.ScaleSpaceConfig()
    K0 = 1024
    out = {}
    img = torch.as_tensor(images, device=dev)
    for octave in (0, 1):
        if octave:
            img = F._downsample2(img)
        K = max(64, K0 >> octave)
        B, H, W = img.shape
        L0 = F.gaussian_blur(img, float(cfg.sigmas[0])).contiguous()
        k2 = F.contrast_k2(L0).reshape(-1).contiguous()
        segs = F.level_taus(cfg)
        # K1: every segment from the same input on both paths
        plain_levels = [L0]
        for taus in segs:
            plain_levels.append(ss.diffuse_segment_plain(plain_levels[-1], k2, taus))
        err1 = max(float((ss.diffuse_segment(plain_levels[i], k2, taus)
                          - plain_levels[i + 1]).abs().max()) for i, taus in enumerate(segs))
        levels = torch.stack(plain_levels, dim=1).contiguous()
        # K2
        resp = ss.response_levels(levels, cfg.sigma_levels)
        resp_p = ss.response_levels_plain(levels, cfg.sigma_levels)
        err2 = float((resp - resp_p).abs().max())
        # K3 on the keypoints the path detects
        kp = F.detect(levels, resp_p, cfg, max_keypoints=K, threshold=1e-7,
                     with_orientation=False)
        args = (levels, kp.uv, kp.level, kp.sigma, kp.mask)
        err3 = float((dsc.describe_upright(*args) - dsc.describe_upright_reference(*args))
                     .abs().max())
        torch.cuda.synchronize()

        def k1():
            L = L0
            for taus in segs:
                L = ss.diffuse_segment(L, k2, taus)

        def k1_plain():
            L = L0
            for taus in segs:
                L = ss.diffuse_segment_plain(L, k2, taus)

        times = {
            "diffuse_segment": (cuda_ms(k1), cuda_ms(k1_plain)),
            "response_levels": (cuda_ms(lambda: ss.response_levels(levels, cfg.sigma_levels)),
                                cuda_ms(lambda: ss.response_levels_plain(levels, cfg.sigma_levels))),
            "describe_upright": (cuda_ms(lambda: dsc.describe_upright(*args)),
                                 cuda_ms(lambda: dsc.describe_upright_reference(*args))),
        }
        errs = {"diffuse_segment": err1, "response_levels": err2, "describe_upright": err3}
        b2b3 = cuda_ms_per_call(lambda: dsc.describe_upright(*args))
        dev3 = ""
        if profile:
            ms_dev, note = launch_device_ms(lambda: dsc.describe_upright(*args), 10)
            dev3 = f", device {ms_dev:.4f} ms per call by torch.profiler ({note})"
        log(f"[kernels] describe_upright B={B} {H}x{W} K={K}: {b2b3:.4f} ms per call by CUDA events "
            f"around 20 calls back to back{dev3}")
        shape = f"B={B} {H}x{W} L={cfg.n_levels} K={K}"
        # necessary work: K1 reads and writes one level per segment and does
        # ~30 FLOP per pixel and FED step (4 differences, 4 conductivities
        # with a division each, the flux sum, the update); K2 reads the
        # levels and writes one response each (~15 FLOP per pixel: three
        # second differences and the determinant); K3 reads the level pixels
        # its keypoints' 24x24 bilinear samples touch (each once) plus 5
        # keypoint fields, does ~12 FLOP a sample, and writes 128 floats per
        # keypoint
        px, nl = B * H * W, levels.shape[1]
        n_kp = int(kp.mask.sum())
        bounds = {
            "diffuse_segment": bound(len(segs) * 2 * px * 4, 30.0 * px * sum(map(len, segs)), "f32"),
            "response_levels": bound(2 * nl * px * 4, 15.0 * nl * px, "f32"),
            "describe_upright": bound(k3_read_bytes(levels, kp) + B * K * (128 + 5) * 4,
                                      12.0 * 576 * n_kp, "f32"),
        }
        for name, err in errs.items():
            tol = KERNELS[name][2]
            ms, pms = times[name]
            log(f"[kernels] {name:17s} {shape}: max_abs_err {err:.3e} (tol {tol:.0e}); "
                f"kernel {ms:.3f} ms, plain {pms:.3f} ms"
                + (" (all 4 segments)" if name == "diffuse_segment" else ""))
            assert err <= tol, f"{name} at {shape}: max_abs_err {err} > {tol}"
            if octave == 0:
                out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms, **bounds[name]}
            else:
                out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    return out


def phase_map(tex, dev):
    from examples import room

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.localize.localize import build_localization_map
    from tests import smoke_scenes

    poses = room.walk_poses(N_KEYFRAMES)
    t0 = time.perf_counter()
    frames = render(tex, poses)
    t_render = time.perf_counter() - t0
    cfg = PipelineConfig()
    feats = extract_features(frames, cfg, dev)
    uv = feats.kp.uv.cpu().numpy()
    mask = feats.kp.mask.cpu().numpy()
    desc = feats.desc.cpu().numpy()
    scene, obs_feat = smoke_scenes.room_scene(poses, uv, mask, INTR, room.ROOM)
    lmap = build_localization_map(scene, desc, obs_feat, dev, kp_mask=mask, n_words=64,
                                  seed=0, feat_bits=feats.desc_bits.cpu().numpy())
    P = lmap.X.shape[0]
    assert lmap.vocab is not None, "map has no VLAD vocabulary"
    assert lmap.lm_bits is not None, "map has no landmark bits"
    assert P < cfg.localize.streaming_min_landmarks, f"{P} landmarks would need streaming"
    log(f"[map] {N_KEYFRAMES} keyframes rendered in {t_render:.1f} s; "
        f"{int(mask.sum())} keypoints -> {P} landmarks, vocab {tuple(lmap.vocab.shape)}")
    return lmap, (poses, desc, uv, mask)


def query_poses():
    """Held-out frames at the midpoints between keyframe poses."""
    from examples import room

    mids = room.walk_poses(2 * N_KEYFRAMES - 1)[1::2]          # 23 midpoints
    pick = np.round(np.linspace(0, len(mids) - 1, N_QUERIES)).astype(int)
    return [mids[i] for i in pick]


def phase_queries(tex, lmap, dev):
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.main import localize_images
    from sfmx_torch.kernels import _build

    poses = query_poses()
    frames = render(tex, poses)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    t0 = time.perf_counter()
    results = localize_images(frames, INTR, lmap, PipelineConfig(), generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES.counts)
    errs = []
    for i, (res, (_R, _t, eye)) in enumerate(zip(results, poses)):
        c = np.asarray(res["center"])
        assert np.isfinite(c).all() and np.isfinite(np.asarray(res["R"])).all(), \
            f"query {i}: non-finite pose"
        errs.append(float(np.linalg.norm(c - eye)))
        log(f"[queries] {i:2d}: center error {errs[-1]:.4f} m, "
            f"{res['n_inliers']} inliers, confidence {res['confidence']:.3f}")
    med = float(np.median(errs))
    n_conf = sum(r["confidence"] > 0 for r in results)
    log(f"[queries] median center error {med:.4f} m (gate < {MEDIAN_GATE_M}); "
        f"{n_conf}/{N_QUERIES} with confidence > 0; first main-path run {wall:.2f} s")
    assert len(results) == N_QUERIES
    assert med < MEDIAN_GATE_M, f"median center error {med} m"
    assert n_conf >= 12, f"only {n_conf} queries localized with confidence > 0"
    return frames, launches


def phase_crosscheck(frames, lmap, dev, n: int = 4):
    """The card's path against the plain path (CPU tensors, no kernels) on
    the first n queries, with the same RANSAC noise: centers within 3 cm and
    inlier counts within 3% (the tolerance tests/test_torch_slice.py states
    for last-bit differences in the levels)."""
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.main import localize_images
    from sfmx_torch.localize.localize import LocalizationMap
    from sfmx_torch.solvers.ransac import gumbel_noise

    cfg = PipelineConfig()
    shape = (n, cfg.localize.k_hypotheses, cfg.features.max_keypoints)
    g = gumbel_noise(shape, device="cpu", generator=torch.Generator().manual_seed(3))
    on_card = localize_images(frames[:n], INTR, lmap, cfg, gumbel=[g.to(dev)])
    cpu_map = LocalizationMap(*(None if x is None else x.cpu() for x in lmap))
    plain = localize_images(frames[:n], INTR, cpu_map, cfg, gumbel=[g])
    for i, (a, b) in enumerate(zip(on_card, plain)):
        dc = float(np.linalg.norm(np.asarray(a["center"]) - np.asarray(b["center"])))
        log(f"[crosscheck] query {i}: card vs plain center {dc:.2e} m, "
            f"inliers {a['n_inliers']} vs {b['n_inliers']}")
        assert dc < 0.03, f"query {i}: card and plain centers {dc} m apart"
        assert abs(a["n_inliers"] - b["n_inliers"]) <= max(2, 0.03 * b["n_inliers"])


def query_path(frames, lmap, dev):
    """The query path on one device-resident batch, as two closures:
    extraction, then ``localize_batch`` on its features."""
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.localize.localize import localize_batch

    cfg = PipelineConfig()
    lc = cfg.localize
    imgs = torch.as_tensor(frames, device=dev)
    intr = torch.as_tensor(INTR, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    state = {}

    def extract():
        state["f"] = extract_features(imgs, cfg, dev)

    def localize():
        f = state["f"]
        localize_batch(lmap, f.desc, f.kp.uv, f.kp.mask, intr, generator=gen,
                       top_k_kf=lc.top_k_kf, m_cap=lc.m_cap, k_hypotheses=lc.k_hypotheses,
                       px_thresh=lc.px_thresh, sim_thresh=lc.sim_thresh,
                       min_inliers=lc.min_inliers)

    extract()
    return extract, localize


def phase_rate(extract, localize, n_frames: int, smi: str, reps: int = 5,
               label: str = "query path") -> float:
    """Steady-state frames/s on the device: extraction + localize.
    Returns the median wall time of one batch in seconds."""
    import torch

    ms_extract = cuda_ms(extract, reps=reps)
    ms_localize = cuda_ms(localize, reps=reps)
    for _ in range(2):
        extract()
        localize()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        extract()
        localize()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    log(f"[rate] {label} B={n_frames} {H_IMG}x{W_IMG}: {n_frames / wall:.2f} frames/s "
        f"(median {wall * 1e3:.2f} ms per batch of {reps}; extraction {ms_extract:.2f} ms, "
        f"localization {ms_localize:.2f} ms by CUDA events) on {smi}")
    return wall


def device_ms_per_run(fn, reps: int, counts: dict | None = None):
    """Run fn() reps times under torch.profiler.  Returns the device time per
    run in ms (the summed durations of every kernel, copy and fill the trace
    holds; the path runs on one stream, so they do not overlap; fn must not
    open a record_function range, whose device-side annotation would count
    as well), the device
    time per run of each kernel name, and the profiler's table; ``counts``,
    where given, receives the number of traced events of each name.  A trace
    without any device event is taken again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # now and then a trace comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, float] = {}
        seen: dict[str, int] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
                seen[e.name] = seen.get(e.name, 0) + 1
        if by_name:
            break
    if counts is not None:
        counts.update(seen)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    return sum(by_name.values()), by_name, table


def launch_device_ms(fn, reps: int, keep=None, per: dict | None = None) -> tuple[float, str]:
    """Device time per call of a wrapper: the mean traced duration of each of
    its kernels (those whose name ``keep`` accepts; all by default) times its
    launches a call, summed over its kernels (a trace that lost launches still
    times those it holds; the launches a call are the traced count over reps,
    at least 1, right where the trace kept them all), and a note of each
    kernel's mean and how many of its launches the trace holds.  ``per``,
    where given, receives per kernel its mean ms, traced count and launches a
    call."""
    counts: dict[str, int] = {}
    _ms, by_name, _table = device_ms_per_run(fn, reps, counts)
    means = {k.replace("(anonymous namespace)::", "").split("(")[0]:
             {"ms": t * reps / counts[k], "traced": counts[k],
              "per_call": max(1, round(counts[k] / reps))}
             for k, t in by_name.items() if keep is None or keep(k)}
    if not means:
        raise RuntimeError("the profiler recorded none of the wrapper's kernels")
    if per is not None:
        per.update(means)
    note = ", ".join(f"{m['ms']:.4f} {k} ({m['traced']} of {reps * m['per_call']} traced)"
                     for k, m in means.items())
    return sum(m["ms"] * m["per_call"] for m in means.values()), note


def phase_profile(stages: dict, wall: float, smi: str, tag: str, n_frames: int,
                  reps: int = 3):
    """Device time of each stage and of the whole path under torch.profiler,
    and the device's busy share of the unprofiled wall time per batch.  The
    full table goes to chiprun_out/profile_<tag>.txt."""
    def path():
        for fn in stages.values():
            fn()

    ms = {k: device_ms_per_run(fn, reps)[0] for k, fn in stages.items()}
    ms_p, by_name, table = device_ms_per_run(path, reps)
    assert ms_p > 0, "the profiler recorded no device time"
    log(f"[profile] {tag} B={n_frames}: device time per batch (torch.profiler, {reps} "
        f"batches each): " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + f", whole path {ms_p:.3f} ms; wall per batch without the profiler "
        f"{wall * 1e3:.2f} ms; device busy {ms_p / (wall * 1e3):.3f} of it, on {smi}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {t:8.3f} ms  {name[:100]}")
    out = ROOT / "chiprun_out" / f"profile_{tag}.txt"
    out.parent.mkdir(exist_ok=True)
    out.write_text(f"{smi}\n{tag} path, whole path, {reps} batches\n{table}\n")


# ---------------------------------------------------------------------------
# Tracking, P3P and binary matching on the 24-keyframe map
# ---------------------------------------------------------------------------


def _gate(tag: str, results, poses, min_localized: int) -> float:
    errs = [float(np.linalg.norm(np.asarray(r["center"]) - eye))
            for r, (_R, _t, eye) in zip(results, poses)]
    assert all(np.isfinite(errs)), f"{tag}: non-finite pose"
    med = float(np.median(errs))
    n_conf = sum(r["confidence"] > 0 for r in results)
    log(f"[{tag}] median center error {med:.4f} m (gate < {MEDIAN_GATE_M}); "
        f"{n_conf}/{len(results)} with confidence > 0 (gate >= {min_localized})")
    assert med < MEDIAN_GATE_M, f"{tag}: median center error {med} m"
    assert n_conf >= min_localized, f"{tag}: only {n_conf} localized"
    return med


def phase_tracking(frames, lmap, dev):
    """The 16 held-out frames, in walk order, as one tracked sequence."""
    import dataclasses

    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.main import localize_images, localize_sequence_images

    poses = query_poses()
    t0 = time.perf_counter()
    out = localize_sequence_images(frames, INTR, lmap, PipelineConfig(),
                                   generator=torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    n_tracked = sum(f["tracked"] for f in out["frames"])
    log(f"[tracking] {len(frames)} frames in {time.perf_counter() - t0:.2f} s: "
        f"stats {json.dumps(out['stats'])}, {n_tracked} tracked (gate >= {len(frames) - 4})")
    assert n_tracked >= len(frames) - 4, f"only {n_tracked} frames tracked"
    _gate("tracking", out["frames"], poses, len(frames) - 4)

    cfg = PipelineConfig()
    for tag, lc in (("p3p", dataclasses.replace(cfg.localize, pnp_solver="p3p")),
                    ("binary", dataclasses.replace(cfg.localize, binary=True))):
        res = localize_images(frames, INTR, lmap, dataclasses.replace(cfg, localize=lc),
                              generator=torch.Generator(device=dev).manual_seed(6))
        _gate(tag, res, poses, 12)


# ---------------------------------------------------------------------------
# Map-scale serving on K4
# ---------------------------------------------------------------------------


def phase_map_scale(kf, dev):
    """The query room's 24 keyframes merged to one landmark per surface
    cell, plus distractor rooms (other RoomTexture seeds, 24 keyframes
    each, one landmark per keypoint, translated 20 m apart along x) until
    the map holds >= MAP_SCALE_LANDMARKS landmarks."""
    from examples import room

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.localize.localize import build_localization_map, use_streaming
    from tests import smoke_scenes

    t0 = time.perf_counter()
    poses, desc, uv, mask = kf
    cfg = PipelineConfig()
    scene, obs_feat = smoke_scenes.merged_room_scene(poses, uv, mask, INTR, room.ROOM)
    n_query_room = len(scene["X"])
    parts, descs, masks = [(scene, obs_feat, np.zeros(3))], [desc], [mask]
    P, t_render, room_id = n_query_room, 0.0, 0
    while P < MAP_SCALE_LANDMARKS:
        room_id += 1
        t1 = time.perf_counter()
        frames = smoke_scenes.render_parallel(1000 + room_id, poses, W_IMG, H_IMG, FOCAL,
                                              RENDER_WORKERS)
        t_render += time.perf_counter() - t1
        f = extract_features(frames, cfg, dev)
        m = f.kp.mask.cpu().numpy()
        sc, of = smoke_scenes.room_scene(poses, f.kp.uv.cpu().numpy(), m, INTR, room.ROOM)
        parts.append((sc, of, np.array([20.0 * room_id, 0.0, 0.0])))
        descs.append(f.desc.cpu().numpy())
        masks.append(m)
        P += len(sc["X"])
    cols, obs = smoke_scenes.combine_scenes(parts)
    lmap = build_localization_map(cols, np.concatenate(descs), obs, dev,
                                  kp_mask=np.concatenate(masks), n_words=64, seed=0)
    P = lmap.X.shape[0]
    assert P >= MAP_SCALE_LANDMARKS and use_streaming(cfg.localize, lmap, binary=False), P
    log(f"[map-scale] query room {N_KEYFRAMES} keyframes -> {n_query_room} merged landmarks "
        f"(1.5 cm cells); {room_id} distractor rooms x {N_KEYFRAMES} keyframes rendered in "
        f"{t_render:.1f} s ({RENDER_WORKERS} processes); map {P} landmarks, "
        f"{lmap.kf_gdesc.shape[0]} keyframes, streaming=auto picks K4; "
        f"phase {time.perf_counter() - t0:.1f} s")
    return lmap


def serve_poses():
    """Held-out poses of the query room, none equal to a keyframe pose."""
    from examples import room

    return room.walk_poses(2 * N_SERVE + 1)[1::2]


def phase_k4(lmap, frames, dev, smi: str, profile: bool) -> dict:
    """K4 against its plain version at the serving run's two shapes: the
    first batch's query descriptors (32 x 1024 rows) and the burst's tail (2
    x 1024 rows, where the kernel splits the landmark loop), each against
    the whole pool, padded and masked as ``match_float_streaming`` does.  At
    the tail the split result must equal the unsplit one bit for bit.  With
    ``profile`` also what the streaming matcher adds around the kernel."""
    import torch
    import torch.nn.functional as TF

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.core.masking import round_up
    from sfmx_torch.kernels import match as mt

    f = extract_features(frames[:SERVE_BATCH], PipelineConfig(), dev)
    B, K, D = f.desc.shape
    a_all = torch.where(f.kp.mask.reshape(-1)[:, None], f.desc.reshape(B * K, D), 0.0)
    b = torch.where(lmap.lm_alive[:, None], lmap.lm_desc, 0.0)
    b = TF.pad(b, (0, 0, 0, round_up(b.shape[0], 2048) - b.shape[0]))
    tol = KERNELS["match_top2"][2]
    out = {}
    for tag, n_img in (("batch", SERVE_BATCH), ("tail", N_TAIL)):
        a = a_all[:n_img * K]
        a = TF.pad(a, (0, 0, 0, round_up(a.shape[0], 256) - a.shape[0]))
        Ka, Kb = a.shape[0], b.shape[0]
        splits = mt.split_plan(Ka, Kb)[0]
        got = mt.match_top2(a, b)
        ref = mt.match_top2_plain(a, b)
        torch.cuda.synchronize()
        err = max(float((got[0] - ref[0]).abs().max()), float((got[2] - ref[2]).abs().max()))
        clear = (ref[0] - ref[2]) > tol
        bad = int((got[1] != ref[1])[clear].sum())
        near = int((got[1] != ref[1])[~clear].sum())
        other = mt.match_top2(a, b, splits=1 if splits > 1 else 8)
        same = all(torch.equal(x, y) for x, y in zip(got, other))
        ms = cuda_ms(lambda: mt.match_top2(a, b))
        # the launches alone: the wrapper's casts of both sides to bf16 done before
        a16, b16 = a.to(torch.bfloat16).contiguous(), b.to(torch.bfloat16).contiguous()
        lms = cuda_ms(lambda: mt._match_top2_cuda(a16, b16))
        pms = cuda_ms(lambda: mt.match_top2_plain(a, b), reps=3, warm=1)
        flop = 2.0 * Ka * Kb * 128
        bnd = bound((Ka + Kb) * 128 * 2 + Ka * 12, flop, "bf16")
        log(f"[K4] match_top2 {tag} {tuple(a.shape)} x {tuple(b.shape)} bf16, {splits} split(s), "
            f"{mt.match_top2_launches(Ka, Kb)} launch(es): max_abs_err {err:.3e} (tol {tol:.0e}); "
            f"index mismatches {bad} outside near-ties ({int(clear.sum())} rows), {near} among "
            f"{int((~clear).sum())} near-tie rows; equal to the "
            f"{'unsplit' if splits > 1 else '8-split'} result bit for bit: {same}; kernel "
            f"{ms:.3f} ms with the wrapper's bf16 casts, {lms:.3f} ms on bf16 inputs "
            f"({flop / lms / 1e9:.1f} TFLOP/s), bound {bnd['bound_ms']:.3f} ms by "
            f"{bnd['bound_by']}, plain {pms:.3f} ms; on {smi}")
        assert err <= tol, f"match_top2 {tag}: max_abs_err {err} > {tol}"
        assert bad == 0, f"match_top2 {tag}: {bad} index mismatches outside near-ties"
        assert same, f"match_top2 {tag}: split and unsplit results differ"
        out[tag] = {"max_abs_err": err, "ms": ms, "plain_ms": pms, "splits": splits,
                    "launch_ms": lms, **bnd}
    assert out["tail"]["splits"] > 1 and out["batch"]["splits"] == 1, out
    if profile:
        phase_k4_wrapper(f.desc.reshape(B * K, D), f.kp.mask.reshape(-1), lmap, smi)
    tail = out["tail"]
    return {**out["batch"], "max_abs_err": max(out["batch"]["max_abs_err"], tail["max_abs_err"]),
            "splits": tail["splits"], "tail_ms": tail["ms"], "tail_bound_ms": tail["bound_ms"],
            "tail_plain_ms": tail["plain_ms"], "tail_launch_ms": tail["launch_ms"]}


def phase_k4_wrapper(desc, mask, lmap, smi: str, reps: int = 5) -> None:
    """What ``match_float_streaming`` adds around K4 on one serving batch:
    it masks, pads and casts the queries and the whole pool on every call.
    Device ms by torch.profiler (the kernel's own beside everything else) and
    the host's median time to enqueue one call on an idle card."""
    import torch

    from sfmx_torch.kernels import match as mt

    def call():
        mt.match_float_streaming(desc, lmap.lm_desc, mask, lmap.lm_alive, ratio=0.85)

    ms_all, by_name, _table = device_ms_per_run(call, reps)
    ms_k4 = sum(t for name, t in by_name.items() if "match_top2" in name or "merge_splits" in name)
    torch.cuda.synchronize()
    host = []
    for _ in range(4 * reps):
        t0 = time.perf_counter()
        call()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()      # so that no call waits for room in the launch queue
    host_us = float(np.median(host)) * 1e6
    top = sorted(((t, k) for k, t in by_name.items() if "match_top2" not in k), reverse=True)[:4]
    log(f"[profile] match_float_streaming {tuple(desc.shape)} x {tuple(lmap.lm_desc.shape)}: "
        f"device {ms_all:.3f} ms per call, of it K4 {ms_k4:.3f} ms and the wrapper's masking, "
        f"padding and casts {ms_all - ms_k4:.3f} ms in {len(by_name) - 1} other device ops ("
        + "; ".join(f"{t:.3f} ms {k[:50]}" for t, k in top)
        + f"); host {host_us:.1f} us per call; on {smi}")


def phase_serve(lmap, frames, own_frames, dev, smi: str, shards: int = 1, devices=None,
                busy: bool = False) -> dict:
    """Concurrent image requests through the service on the map-scale map
    (phase 10), or (phases 30 and 37, ``shards`` > 1) on the same map split
    into that many shards, each on its card (the visible cards, round-robin:
    cuda:0 alone on one card) or, with ``devices``, every shard on those
    (the router built directly), each batch's queries routed by retrieval
    and localized per shard group on the gather path.  ``busy``: then two
    more bursts under torch.profiler for each card's busy share
    (``card_busy``).  Returns the kernel launches of the serving run and
    its numbers."""
    import asyncio

    import torch

    import sfmx_torch.serve.server as server
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.core.masking import round_up
    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels import match as mt
    from sfmx_torch.localize.fusion import BeaconPrior
    from sfmx_torch.localize.localize import use_streaming

    cfg = PipelineConfig()
    svc = server.LocalizationService(batch_window_ms=SERVE_WINDOW_MS, max_batch=SERVE_BATCH)
    tag = "[serve]" if shards == 1 else "[serve-shards]" if devices is None else \
        f"[serve-shards on {','.join(str(d) for d in devices)}]"
    svc.load_map("building", lmap, INTR, cfg=cfg, shards=shards)
    if devices is not None:
        _obj, intr0, cfg0 = svc.maps["building"]
        svc.maps["building"] = (server.MapShardRouter.build(
            server.split_localization_map(lmap, shards), devices), intr0, cfg0)
    t0 = time.perf_counter()
    svc.warmup("building")
    log(f"{tag} warmup (one batch of {SERVE_BATCH} blank images) {time.perf_counter() - t0:.2f} s")
    if shards == 1:
        # every batch is one (map, K, non-binary) group on the streaming
        # path, so each batch is one streaming localize call
        assert use_streaming(cfg.localize, lmap, binary=False)
    else:
        router = svc.maps["building"][0]
        assert isinstance(router, server.MapShardRouter) and len(router.shards) == shards
        log(f"{tag} {shards} shards of {[int(s.X.shape[0]) for s in router.shards]} landmarks "
            f"and {[int(s.kf_gdesc.shape[0]) for s in router.shards]} keyframes on "
            f"{[str(d) for d in router.devices]}")
    poses = serve_poses()
    own_intr = np.array([FOCAL_OWN, FOCAL_OWN, W_IMG / 2, H_IMG / 2, 0, 0, 0], np.float32)
    rng = np.random.default_rng(11)
    reqs = []
    for i, (_R, _t, eye) in enumerate(poses):
        prior = None
        if i % 4 == 1:      # a quarter carry a beacon prior ~0.5 m off
            off = rng.normal(size=3)
            prior = BeaconPrior(torch.tensor(eye + 0.5 * off / np.linalg.norm(off),
                                             dtype=torch.float32), 5.0, 0.5)
        reqs.append(dict(image=frames[i], prior=prior))
    reqs += [dict(image=img, intr=own_intr) for img in own_frames]
    eyes = [eye for _R, _t, eye in poses] + [eye for _R, _t, eye in serve_poses()[:len(own_frames)]]

    async def run(bursts: int = N_BURSTS):
        await svc.start()
        try:
            outs, walls = [], []
            for _ in range(bursts):
                t0 = time.perf_counter()
                outs += await asyncio.gather(*[svc.localize("building", **r) for r in reqs])
                walls.append(time.perf_counter() - t0)
            return outs, walls
        finally:
            await svc.stop()

    # the query rows of every streaming call the service makes, so that the
    # K4 launches can be held against what the wrapper says each call takes
    streaming, k4_rows = server.localize_batch_streaming, []

    def recording(lmap_, q_desc, *args, **kw):
        k4_rows.append(q_desc.shape[0] * q_desc.shape[1])
        return streaming(lmap_, q_desc, *args, **kw)

    server.localize_batch_streaming = recording
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    try:
        outs, walls = asyncio.run(run())
    finally:
        server.localize_batch_streaming = streaming
    launches = dict(_build.LAUNCHES.counts)
    Kb = round_up(lmap.lm_desc.shape[0], 2048)
    k4_expected = sum(mt.match_top2_launches(round_up(max(r, 256), 256), Kb) for r in k4_rows)

    n = len(outs)
    eyes, reqs_all = eyes * N_BURSTS, reqs * N_BURSTS
    errs = np.array([np.linalg.norm(np.asarray(o["center"]) - e) for o, e in zip(outs, eyes)])
    # localized = the vision pose passed (n_inliers >= min_inliers, i.e. its
    # confidence > 0); the returned confidence is the beacon-fused one
    n_loc = sum(o["n_inliers"] >= cfg.localize.min_inliers for o in outs)
    st = svc.stats.snapshot()
    for i in range(0, len(reqs), 8):
        log(f"{tag} {i:2d}: center error {errs[i]:.4f} m, {outs[i]['n_inliers']} inliers, "
            f"confidence {outs[i]['confidence']:.3f}, source {outs[i]['source']}")
    own = np.concatenate([errs[b * len(reqs) + N_SERVE:(b + 1) * len(reqs)]
                          for b in range(N_BURSTS)])
    log(f"{tag} {N_BURSTS} bursts of {len(reqs)} requests "
        f"({sum(r.get('prior') is not None for r in reqs)} with a beacon prior, "
        f"{len(own_frames)} with own intrinsics f={FOCAL_OWN:g}: max error {own.max():.4f} m); "
        f"burst walls {', '.join(f'{w:.3f}' for w in walls)} s; {n} requests in "
        f"{sum(walls):.3f} s = {n / sum(walls):.2f} requests/s; {st['batches']} batches, "
        f"mean batch {st['mean_batch_size']:.2f}; latency over all {n} requests p50 "
        f"{st['p50_latency_ms']:.1f} ms, p95 {st['p95_latency_ms']:.1f} ms, p99 "
        f"{st['p99_latency_ms']:.1f} ms; median center error {np.median(errs):.4f} m "
        f"(gate < {MEDIAN_GATE_M}); {n_loc}/{n} localized by vision; on {smi}")
    log(f"{tag} launches {json.dumps(launches)}; {len(k4_rows)} streaming calls with query rows "
        f"{json.dumps({str(r): k4_rows.count(r) for r in sorted(set(k4_rows))})}, which take "
        f"{k4_expected} K4 launches (a call that splits the landmark loop takes 2)")
    assert np.isfinite(errs).all(), "serve: non-finite pose"
    assert np.median(errs) < MEDIAN_GATE_M, f"serve: median center error {np.median(errs)}"
    assert n_loc >= 0.75 * n, f"serve: only {n_loc}/{n} localized"
    assert st["requests"] == n and st["batches"] < n, st
    if shards == 1:
        assert len(k4_rows) == st["batches"], (k4_rows, st)
        assert launches.get("match_top2", 0) == k4_expected, (launches, k4_expected)
    else:
        assert not k4_rows and all(launches.get(k, 0) > 0 for k in SERVE_KERNELS[:3]), launches
    # the requests with their own intrinsics (routed per request on phase 30's path)
    assert np.all(own < MEDIAN_GATE_M), f"serve: own-intrinsics requests off by {own}"
    assert all((o["source"] == 0) == (r.get("prior") is None)
               for o, r in zip(outs, reqs_all)), "serve: unexpected fusion sources"
    numbers = {"requests_per_s": n / sum(walls), "p50_ms": st["p50_latency_ms"],
               "p95_ms": st["p95_latency_ms"], "p99_ms": st["p99_latency_ms"],
               "median_err_m": float(np.median(errs)), "localized": n_loc / n,
               "batches": st["batches"]}
    if busy:
        numbers.update(card_busy(lambda: asyncio.run(run(2)), tag, smi))
    return launches, numbers


def streaming_path(frames, lmap, dev):
    """Extraction + ``localize_batch_streaming`` on one device-resident
    B=32 batch, as two closures (the serving path without the queue)."""
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.localize.localize import localize_batch_streaming

    cfg = PipelineConfig()
    lc = cfg.localize
    imgs = torch.as_tensor(frames[:SERVE_BATCH], device=dev)
    intr = torch.as_tensor(INTR, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    state = {}

    def extract():
        state["f"] = extract_features(imgs, cfg, dev)

    def localize():
        f = state["f"]
        localize_batch_streaming(lmap, f.desc, f.kp.uv, f.kp.mask, intr, generator=gen,
                                 k_hypotheses=lc.k_hypotheses, px_thresh=lc.px_thresh,
                                 sim_thresh=lc.sim_thresh, min_inliers=lc.min_inliers)

    extract()
    return extract, localize, state


def phase_streaming_crosscheck(lmap, state, dev):
    """One B=32 streaming batch on the card and on the CPU's plain path
    (plain K4 included) with the same features and RANSAC noise: centers
    within 3 cm, as phase 5 states for the gather path."""
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.localize.localize import LocalizationMap, localize_batch_streaming
    from sfmx_torch.solvers.ransac import gumbel_noise

    lc = PipelineConfig().localize
    f = state["f"]
    B, K, _ = f.desc.shape
    g = gumbel_noise((B, lc.k_hypotheses, K), device="cpu",
                     generator=torch.Generator().manual_seed(4))
    kw = dict(k_hypotheses=lc.k_hypotheses, px_thresh=lc.px_thresh,
              sim_thresh=lc.sim_thresh, min_inliers=lc.min_inliers)
    card = localize_batch_streaming(lmap, f.desc, f.kp.uv, f.kp.mask,
                                    torch.as_tensor(INTR, device=dev), gumbel=g.to(dev), **kw)
    t0 = time.perf_counter()
    cpu_map = LocalizationMap(*(None if x is None else x.cpu() for x in lmap))
    plain = localize_batch_streaming(cpu_map, f.desc.cpu(), f.kp.uv.cpu(), f.kp.mask.cpu(),
                                     torch.as_tensor(INTR), gumbel=g, **kw)
    t_cpu = time.perf_counter() - t0
    dc = torch.linalg.vector_norm(card.center.cpu() - plain.center, dim=-1)
    dn = (card.n_inliers.cpu() - plain.n_inliers).abs()
    log(f"[streaming] B={B} card vs plain CPU path ({t_cpu:.1f} s on the CPU): centers "
        f"max {float(dc.max()):.2e} m apart (gate < 0.03), inliers max |diff| {int(dn.max())} "
        f"of {int(plain.n_inliers.min())}..{int(plain.n_inliers.max())}")
    assert float(dc.max()) < 0.03, f"streaming card vs plain centers {float(dc.max())} m apart"


# ---------------------------------------------------------------------------
# Map-build front end on K5, K9 and K10
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_matcher_calls():
    """Record the device of every call of the plain pair matcher (in each
    module that holds a reference to it) while the block runs."""
    from sfmx_torch.kernels import matching, pairs, tiles

    calls: list[str] = []
    orig = matching.match_pairs_float

    def counted(descs, *args, **kw):
        calls.append(descs.device.type)
        return orig(descs, *args, **kw)

    mods = (matching, pairs, tiles)
    for m in mods:
        m.match_pairs_float = counted
    try:
        yield calls
    finally:
        for m in mods:
            m.match_pairs_float = orig


def run_front_end(tag: str, images, cfg, dev, feats=None):
    """One build through ``build_front_end`` (extract, pairs, match, verify,
    tracks), the launch counts set to 0 just before it and read just after.
    Gates: the plain matcher never ran on the card.  Returns
    ((feats, pairs, verified MatchResult, inlier counts, TrackTable),
    launches, the stage records)."""
    import io

    import torch

    from sfmx_torch.cli.pipeline import build_front_end
    from sfmx_torch.kernels import _build
    from sfmx_torch.utils.logging import LOGGER

    n = len(images) if images is not None else feats.desc.shape[0]
    buf, old = io.StringIO(), LOGGER._stream
    LOGGER._stream = buf
    try:
        with plain_matcher_calls() as plain:
            torch.cuda.synchronize()
            _build.LAUNCHES.reset()
            t0 = time.perf_counter()
            out = build_front_end(images, INTR[None], np.zeros(n, np.int32), cfg, dev,
                                  feats=feats, generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES.counts)
    finally:
        LOGGER._stream = old
    stages = {r["stage"]: r for r in map(json.loads, buf.getvalue().splitlines())}
    pairs = out[1]
    m, v = stages["match"], stages["geometric_verify"]
    log(f"[{tag}] {n} frames, {len(pairs)} pairs ({cfg.match.pair_mode}, kernel "
        f"{'hamming' if cfg.match.binary else cfg.match.kernel}): stage wall "
        + ", ".join(f"{k} {r['wall_s']:.3f} s" for k, r in stages.items())
        + f"; whole {wall:.3f} s; matching {len(pairs) / m['wall_s']:.1f} pairs/s, "
        f"verification {len(pairs) / v['wall_s']:.1f} pairs/s; {m['matches']} matches -> "
        f"{v['inliers']} inliers, {v['pairs_kept']} pairs kept, {stages['tracks']['tracks']} "
        f"tracks; launches {json.dumps(launches)}; plain matcher calls {plain}")
    assert "cuda" not in plain, f"{tag}: the plain matcher ran on the card"
    return out, launches, stages


def truth_gates(tag: str, poses, front, min_inliers: int) -> None:
    """The verified matches and tracks against the raycast truth: every
    keypoint's surface point on the room box at its frame's true pose.

    A keypoint is located to a fraction of its scale sigma (2-12 px at full
    resolution), and at the room's 8-9 m one pixel spans ~1.5 cm, so two
    views of one surface point can sit a few cm apart.  The tolerance of a
    keypoint is therefore the larger of TRUTH_M and its footprint, sigma
    projected to its surface point's depth.  A match is true when its two
    surface points lie within the larger tolerance of its two keypoints; a
    track observation is true when it lies within its own tolerance of the
    track's median point, and a track pure when all of its observations
    are.  Gates: true matches >= TRUTH_SHARE, true track observations >=
    TRACK_OBS_SHARE, and the track table equal to the numpy union-find's
    on the same matches.  The conflict-aware union-find chains tracks
    through dense match graphs (the reference's builder gives the same
    table), so one stray observation makes a long track impure: the share
    of pure tracks is printed, with the shares within TRUTH_M alone."""
    from examples import room
    from sfmx_torch.recon.tracks import build_tracks
    from tests.smoke_scenes import raycast_room

    feats, pairs, res, cnt, tt = front
    uv = feats.kp.uv.cpu().numpy().astype(np.float64)
    X = np.stack([raycast_room(R, eye, uv[c], INTR, room.ROOM)
                  for c, (R, _t, eye) in enumerate(poses)])            # (C,K,3)
    eyes = np.stack([eye for _R, _t, eye in poses])
    foot = feats.kp.sigma.cpu().numpy() * np.linalg.norm(X - eyes[:, None], axis=-1) / FOCAL
    tol = np.maximum(TRUTH_M, foot)                                    # (C,K)
    idx, valid = res.idx.cpu().numpy(), res.valid.cpu().numpy()
    p, r = np.nonzero(valid)
    a, b, j = pairs[p, 0], pairs[p, 1], idx[p, r]
    dist = np.linalg.norm(X[a, r] - X[b, j], axis=1)
    match_ok = float((dist < np.maximum(tol[a, r], tol[b, j])).mean())
    Xo, to = X[tt.obs_cam, tt.obs_feat], tol[tt.obs_cam, tt.obs_feat]
    starts, ends = tt.track_slices()
    dev_m = np.empty(len(Xo))
    for s, e in zip(starts, ends):
        dev_m[s:e] = np.linalg.norm(Xo[s:e] - np.median(Xo[s:e], axis=0), axis=1)
    obs_ok = dev_m < to
    n_t = max(tt.n_tracks, 1)
    pure = np.logical_and.reduceat(obs_ok, starts).sum() if tt.n_tracks else 0
    pure_cm = np.logical_and.reduceat(dev_m < TRUTH_M, starts).sum() if tt.n_tracks else 0
    adj = pairs[:, 1] == pairs[:, 0] + 1
    cnt = cnt.cpu().numpy()
    log(f"[{tag}] truth: {match_ok:.4f} of {len(dist)} verified matches true (gate >= "
        f"{TRUTH_SHARE}; {float((dist < TRUTH_M).mean()):.4f} within {TRUTH_M * 100:.0f} cm, "
        f"{float((dist > 0.3).mean()):.4f} over 30 cm); {float(obs_ok.mean()):.4f} of "
        f"{len(obs_ok)} track observations true (gate >= {TRACK_OBS_SHARE}); {pure}/{tt.n_tracks} "
        f"tracks pure = {pure / n_t:.4f} ({pure_cm / n_t:.4f} within {TRUTH_M * 100:.0f} cm); "
        f"mean track length {np.mean(ends - starts):.2f}; adjacent-frame pairs: min "
        f"{int(cnt[adj].min())} inliers (gate >= {min_inliers}) over {int(adj.sum())}")
    assert len(dist) > 0 and match_ok >= TRUTH_SHARE, f"{tag}: {match_ok} of matches true"
    assert tt.n_tracks > 0 and obs_ok.mean() >= TRACK_OBS_SHARE, \
        f"{tag}: {obs_ok.mean()} of track observations true"
    t0 = time.perf_counter()
    oracle = build_tracks(pairs, idx, valid, len(poses), idx.shape[1], impl="numpy")
    same = all(np.array_equal(x, y) for x, y in zip(oracle[:3], tt[:3]))
    log(f"[{tag}] tracks equal to the numpy union-find's on the same matches: {same} "
        f"({time.perf_counter() - t0:.1f} s)")
    assert same and oracle.n_tracks == tt.n_tracks, f"{tag}: native and numpy tracks differ"
    assert int(cnt[adj].min()) >= min_inliers, f"{tag}: an adjacent pair lost its inliers"


def check_matcher(tag: str, got, ref, near, tol: float = NEAR_TIE) -> float:
    """Kernel against plain on the same pairs: score within tol everywhere,
    valid equal and idx equal on accepted rows outside near-ties."""
    err = float((got.score - ref.score).abs().max())
    clear = ~near
    bad_v = int((got.valid != ref.valid)[clear].sum())
    bad_i = int((got.idx != ref.idx)[clear & ref.valid].sum())
    log(f"[{tag}] max_abs_err {err:.3e} (tol {tol:.0e}); valid mismatches {bad_v}, idx "
        f"mismatches {bad_i} outside near-ties; {int(near.sum())} near-tie rows of "
        f"{near.numel()}; {int(ref.valid.sum())} accepted by the plain version")
    assert err <= tol and bad_v == 0 and bad_i == 0, f"{tag} disagrees with its plain version"
    return err


def phase_pair_kernels(feats, pairs, band_feats, band_pairs, ratio: float, smi: str) -> dict:
    """K5 and K9 against the plain matcher at the exhaustive build's 4,560
    pairs, K9 against K5 (exactly) and the plain matcher on the band build's
    list, each kernel's time beside the plain version's."""
    import torch

    from sfmx_torch.kernels.matching import match_pairs_float
    from sfmx_torch.kernels.pairs import match_pairs_fused
    from sfmx_torch.kernels.tiles import match_pairs_float_tiled
    from tests.smoke_scenes import pair_near_ties

    out = {}
    errs9 = []
    for tag, f, p in (("exhaustive", feats, pairs), ("band", band_feats, band_pairs)):
        d, m = f.desc, f.kp.mask
        k5 = match_pairs_fused(d, m, p, ratio=ratio)
        k9 = match_pairs_float_tiled(d, m, p, ratio=ratio)
        ref = match_pairs_float(d, m, p, ratio=ratio)
        near = pair_near_ties(d, m, p, ratio, NEAR_TIE)
        err5 = check_matcher(f"K5 {tag} {len(p)} pairs", k5, ref, near)
        errs9.append(check_matcher(f"K9 {tag} {len(p)} pairs", k9, ref, near))
        same = all(torch.equal(x, y) for x, y in zip(k9, k5))
        log(f"[K9 {tag}] equal to K5 in every field: {same}")
        assert same, f"K9 and K5 differ on the {tag} pairs"
        w5 = cuda_ms(lambda: match_pairs_fused(d, m, p, ratio=ratio))
        w9 = cuda_ms(lambda: match_pairs_float_tiled(d, m, p, ratio=ratio))
        ms5 = kernel_ms(lambda: match_pairs_fused(d, m, p, ratio=ratio))
        ms9 = kernel_ms(lambda: match_pairs_float_tiled(d, m, p, ratio=ratio))
        pms = cuda_ms(lambda: match_pairs_float(d, m, p, ratio=ratio), reps=3, warm=1)
        K = d.shape[1]
        flop = 2.0 * len(p) * K * K * 128
        log(f"[pair kernels] {tag} {len(p)} pairs K={K}: kernels' device time K5 {ms5:.3f} ms "
            f"({len(p) / ms5 * 1e3:.0f} pairs/s, {flop / ms5 / 1e9:.1f} TFLOP/s), K9 {ms9:.3f} ms "
            f"({len(p) / ms9 * 1e3:.0f} pairs/s); whole wrapper call K5 {w5:.3f} ms, K9 {w9:.3f} ms "
            f"(host tile packing included); plain {pms:.3f} ms ({len(p) / pms * 1e3:.0f} "
            f"pairs/s) on {smi}")
        # necessary work: every image's descriptors read once (bf16), one
        # (idx, valid, score) row per pair and keypoint written
        bnd = bound(d.shape[0] * K * 128 * 2 + len(p) * K * 9, flop, "bf16")
        if tag == "exhaustive":
            out["match_pairs_fused"] = {"max_abs_err": err5, "ms": ms5, "plain_ms": pms, **bnd}
        else:
            out["match_pairs_tiled"] = {"max_abs_err": max(errs9), "ms": ms9, "plain_ms": pms,
                                        **bnd}
    return out


def kernel_ms(fn, reps: int = 5) -> float:
    """Device time per call of match_pairs.cu's kernels (the pair kernel,
    which runs the listed and the swapped pairs, and in match mode its
    finish) under torch.profiler, without the wrapper's host work and its
    small device ops.  Fails if the trace holds none of them (a renamed
    kernel would read 0 ms)."""
    _, by_name, _ = device_ms_per_run(fn, reps)
    ours = {k: t for k, t in by_name.items() if "pairs_kernel" in k or "finish_kernel" in k}
    assert ours, f"no match_pairs.cu kernel in the trace: {sorted(by_name)}"
    return sum(ours.values())


def phase_k10(feats, pairs, dev, smi: str) -> dict:
    """K10 (K5's raw mode) on the first N_K10_PAIRS exhaustive pairs, masked
    rows zeroed as its callers do: its own path (the raw per-pair top-2
    entry, launch counts set to 0 before it and read after), then against
    its plain version: s1/s2 within the tolerance, i1 equal where the row's
    best two columns differ by more than it, j1 where the column's best two
    rows do."""
    import torch

    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels.matching import _bf16_sim
    from sfmx_torch.kernels.pairs import match_pairs_top2, match_pairs_top2_plain

    d = torch.where(feats.kp.mask[..., None], feats.desc, 0.0)
    p = pairs[:N_K10_PAIRS]
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    s1, i1, s2, j1 = match_pairs_top2(d, p)
    torch.cuda.synchronize()
    check_launches("K10 path", dict(_build.LAUNCHES.counts), {"match_pairs_top2": 1})
    launches = _build.LAUNCHES.get("match_pairs_top2")
    r1, ri, r2, rj = match_pairs_top2_plain(d, p)
    pt = torch.as_tensor(p, device=dev).long()
    gaps = []                                  # each column's best two rows, 64 pairs at a time
    for s in range(0, len(pt), 64):
        v = torch.topk(_bf16_sim(d[pt[s:s + 64, 0]], d[pt[s:s + 64, 1]]), 2, dim=-2).values
        gaps.append(v[:, 0] - v[:, 1])
    col_gap = torch.cat(gaps)
    tol = KERNELS["match_pairs_top2"][2]
    err = max(float((s1 - r1).abs().max()), float((s2 - r2).abs().max()))
    row_clear, col_clear = (r1 - r2) > tol, col_gap > tol
    bad_i = int((i1 != ri)[row_clear].sum())
    bad_j = int((j1 != rj)[col_clear].sum())
    ms = kernel_ms(lambda: match_pairs_top2(d, p))
    pms = cuda_ms(lambda: match_pairs_top2_plain(d, p), reps=3, warm=1)
    log(f"[K10] match_pairs_top2 {len(p)} pairs K={d.shape[1]}: max_abs_err {err:.3e} (tol {tol:.0e}); i1 mismatches {bad_i} outside "
        f"{int((~row_clear).sum())} near-tie rows, j1 mismatches {bad_j} outside "
        f"{int((~col_clear).sum())} near-tie columns; kernel {ms:.3f} ms, plain {pms:.3f} ms "
        f"on {smi}")
    assert err <= tol and bad_i == 0 and bad_j == 0, "K10 disagrees with its plain version"
    K = d.shape[1]
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, "launches": launches,
            **bound(d.shape[0] * K * 128 * 2 + len(p) * K * 16, 2.0 * len(p) * K * K * 128, "bf16")}


def phase_front_crosscheck(feats, pairs, cfg, dev) -> None:
    """N_XCHECK_PAIRS adjacent-frame pairs: the card's match and verify
    stage outputs against the plain path on the CPU (the card's features
    copied over), with the same injected Gumbel noise.  Match: valid equal
    outside near-ties.  Verify (both fed the card's matches): f32 sums in
    another order (the 8-point batch, the 3x3 SVD) can change which of two
    hypotheses with near-equal counts wins, or whether the refit beats the
    raw winner, and so swap a pair's kept model for one of the same quality;
    a match whose squared Sampson error lies near the threshold may flip
    under any model.  So per pair: inlier counts within XCHECK_SLACK, and
    the inlier masks differ in no more matches than lie within 1% of the
    threshold on either side plus XCHECK_SLACK."""
    import torch

    from sfmx_torch.cli.pipeline import match_images, verify_matches
    from sfmx_torch.core import cameras
    from sfmx_torch.kernels import matching
    from sfmx_torch.kernels.features import Features
    from sfmx_torch.solvers.ransac import gumbel_noise
    from tests.smoke_scenes import pair_near_ties

    sel = pairs[pairs[:, 1] == pairs[:, 0] + 1][:N_XCHECK_PAIRS]
    fc = Features.from_numpy(feats.to_numpy(), "cpu")
    card = match_images(feats, sel, cfg)
    plain = match_images(fc, sel, cfg)
    near = pair_near_ties(fc.desc, fc.kp.mask, sel, cfg.match.ratio, NEAR_TIE)
    bad_v = int((card.valid.cpu() != plain.valid)[~near].sum())
    K, H = feats.desc.shape[1], cfg.match.gv_hypotheses
    g = gumbel_noise((len(sel), H, K), device="cpu", generator=torch.Generator().manual_seed(8))
    cam_k = np.zeros(len(fc.desc), np.int32)
    vc, cc = verify_matches(feats, sel, card, INTR[None], cam_k, cfg, gumbel=g)
    card_cpu = matching.MatchResult(*(x.cpu() for x in card))
    vp, cp = verify_matches(fc, sel, card_cpu, INTR[None], cam_k, cfg, gumbel=g)
    thr = (cfg.match.gv_px_thresh / FOCAL) ** 2
    errs = []
    for f, m, gg in ((fc, card_cpu, g), (feats, card, g.to(dev))):
        xn = cameras.pixel_to_normalized(torch.as_tensor(INTR, device=f.kp.uv.device)[None],
                                         f.kp.uv)
        errs.append(matching.geometric_verify_errors(gg, xn, f.kp.mask, sel, m,
                                                     threshold=thr)[0].cpu() / thr)
    band = ((errs[0] - 1.0).abs() < 0.01) | ((errs[1] - 1.0).abs() < 0.01)
    diff = (vc.valid.cpu() != vp.valid).sum(dim=1)
    dcnt = (cc.cpu() - cp).abs()
    slack = torch.clamp(XCHECK_SLACK * cp, min=2.0)
    fin = torch.isfinite(errs[0]) & torch.isfinite(errs[1]) & card_cpu.valid
    rel = (errs[1] - errs[0]).abs()[fin]
    log(f"[front crosscheck] {len(sel)} adjacent pairs, card vs plain CPU path: match valid "
        f"mismatches {bad_v} outside {int(near.sum())} near-tie rows; verified inlier mask "
        f"differences per pair {diff.tolist()} against {band.sum(dim=1).tolist()} matches within "
        f"1% of the threshold on either side; inlier counts {cp.tolist()} (CPU), max |diff| "
        f"{int(dcnt.max())}; |err card - err cpu| / threshold: median {float(rel.median()):.2e}")
    assert bad_v == 0, "front end: card and CPU matches differ outside near-ties"
    assert bool((dcnt <= slack).all()), "front end: card and CPU inlier counts differ"
    assert bool((diff <= band.sum(dim=1) + slack).all()), "front end: inlier masks differ"


def phase_front_profile(images, feats, pairs, stages: dict, cfg, dev, smi: str) -> None:
    """Device time of the exhaustive build's stages under torch.profiler
    (5 runs each: a window of one ~10 ms match run came back with no device
    events) against their wall times in the unprofiled build.  Each
    stage runs as its body, outside the log scope (a record_function range)
    that build_front_end puts around it."""
    from sfmx_torch.cli.pipeline import extract_features, verify_matches
    from sfmx_torch.kernels.matching import match_pairs_float_auto

    mc = cfg.match
    res = match_pairs_float_auto(feats.desc, feats.kp.mask, pairs, ratio=mc.ratio,
                                 cross_check=mc.cross_check, kernel=mc.kernel)
    n = feats.desc.shape[0]
    runs = {"extract": lambda: extract_features(images, cfg, dev),
            "match": lambda: match_pairs_float_auto(
                feats.desc, feats.kp.mask, pairs, ratio=mc.ratio,
                cross_check=mc.cross_check, kernel=mc.kernel),
            "geometric_verify": lambda: verify_matches(
                feats, pairs, res, INTR[None], np.zeros(n, np.int32), cfg)}
    parts = []
    for stage, fn in runs.items():
        ms, by_name, table = device_ms_per_run(fn, 5)
        assert ms > 0, f"front end {stage}: the profiler recorded no device time"
        wall_ms = stages[stage]["wall_s"] * 1e3
        parts.append(f"{stage} {ms:.3f} ms of {wall_ms:.1f} ms wall (busy {ms / wall_ms:.3f})")
        out = ROOT / "chiprun_out" / f"profile_front_{stage}.txt"
        out.parent.mkdir(exist_ok=True)
        out.write_text(f"{smi}\nexhaustive build, {stage}, 5 runs\n{table}\n")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        log(f"[profile] front end {stage}: " + "; ".join(f"{t:.3f} ms {k[:60]}" for k, t in top))
    log(f"[profile] front end B={n}, {len(pairs)} pairs, device time per stage "
        f"(torch.profiler) against the build's stage wall: " + ", ".join(parts)
        + f"; tracks is host work; on {smi}")


def extraction_launches() -> dict:
    """Launches of one extraction call (a chunk of 16 queries, or a whole
    build) through 2 octaves: per octave, K1 one per chunk of fused FED
    steps of its 4 level segments, K2 one (all levels), K3 one."""
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.kernels import features as F
    from sfmx_torch.kernels import scale_space as ss

    fcfg = PipelineConfig().features
    n_oct = fcfg.n_octaves
    n_k1 = sum(len(ss.fused_chunks(taus)) for taus in F.level_taus(
        F.ScaleSpaceConfig(sigma_levels=tuple(fcfg.sigma_levels))))
    return {"diffuse_segment": n_k1 * n_oct, "response_levels": n_oct,
            "describe_upright": n_oct}


def check_launches(tag: str, got: dict, expected: dict) -> None:
    expected = {k: n for k, n in expected.items() if n}
    log(f"[counters] {tag} launches {json.dumps(got)}; expected {json.dumps(expected)}")
    assert got == expected, f"{tag}: launches {got}, expected {expected}"


def phase_front_end(dev, smi: str, profile: bool):
    """Phases 13-15 on a walk across the room and back: its first N_BUILD
    frames exhaustively (K5), all N_BAND frames by retrieval pairs in band
    tiles (K9, the leftovers K5), the first N_BUILD frames' window pairs
    with binary descriptors (plain Hamming matching); then the pair kernels
    against their plain versions and the card against the CPU.  Returns
    (kernel stats, the launches of each kernel's path, the N_BUILD frames
    and their poses)."""
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.kernels.tiles import pack_tiles
    from tests import smoke_scenes

    t0 = time.perf_counter()
    poses = smoke_scenes.loop_walk_poses(N_BAND)
    frames = smoke_scenes.render_parallel(0, poses, W_IMG, H_IMG, FOCAL, RENDER_WORKERS)
    log(f"[front] {N_BAND} frames of a walk across the room and back rendered in "
        f"{time.perf_counter() - t0:.1f} s ({RENDER_WORKERS} processes)")
    cfg = PipelineConfig()
    mc = cfg.match
    exh, exh_launches, exh_stages = run_front_end("exhaustive", frames[:N_BUILD], cfg, dev)
    assert len(exh[1]) == N_BUILD * (N_BUILD - 1) // 2
    truth_gates("exhaustive", poses[:N_BUILD], exh, mc.gv_min_inliers)

    band_cfg = dataclasses.replace(cfg, match=dataclasses.replace(
        mc, pair_mode="retrieval", window=8, retrieval_k=8, kernel="tiles"))
    band, band_launches, _ = run_front_end("band", frames, band_cfg, dev)
    truth_gates("band", poses, band, mc.gv_min_inliers)
    bp, bcnt = band[1], band[3].cpu().numpy()
    half = N_BAND // 2
    loops = (bp[:, 0] < half) & (bp[:, 1] >= half) & (bp[:, 1] - bp[:, 0] > band_cfg.match.window)
    n_loop_kept = int((bcnt[loops] >= mc.gv_min_inliers).sum())
    _meta, _pos, _dense, rest_idx, n_tiles = pack_tiles(bp, N_BAND)
    log(f"[band] {int(loops.sum())} loop-closure pairs proposed across the two passes, "
        f"{n_loop_kept} kept by verification; {n_tiles} tiles through K9, "
        f"{len(rest_idx)} leftover pairs through K5")
    assert n_loop_kept > 0, "band: no loop closure survived verification"

    bin_cfg = dataclasses.replace(cfg, match=dataclasses.replace(
        mc, pair_mode="window", binary=True))
    binr, bin_launches, _ = run_front_end("binary", None, bin_cfg, dev, feats=exh[0])
    truth_gates("binary", poses[:N_BUILD], binr, mc.gv_min_inliers)

    # K5 and K9 launch twice per wrapper call (the pair kernel with the
    # swapped list in it, then finish)
    ext = extraction_launches()
    check_launches("exhaustive build", exh_launches, {**ext, "match_pairs_fused": 2})
    check_launches("band build", band_launches,
                   {**ext, "match_pairs_tiled": 2 * (n_tiles > 0),
                    "match_pairs_fused": 2 * (len(rest_idx) > 0)})
    check_launches("binary build", bin_launches, {})

    stats = phase_pair_kernels(exh[0], exh[1], band[0], bp, mc.ratio, smi)
    k10 = phase_k10(exh[0], exh[1], dev, smi)
    stats["match_pairs_top2"] = {k: v for k, v in k10.items() if k != "launches"}
    phase_front_crosscheck(exh[0], exh[1], cfg, dev)
    if profile:
        phase_front_profile(frames[:N_BUILD], exh[0], exh[1], exh_stages, cfg, dev, smi)
    return stats, {"match_pairs_fused": exh_launches.get("match_pairs_fused", 0),
                   "match_pairs_tiled": band_launches.get("match_pairs_tiled", 0),
                   "match_pairs_top2": k10["launches"]}, frames[:N_BUILD], poses[:N_BUILD]


# ---------------------------------------------------------------------------
# Reconstruction: bundle adjustment on K6-K8, build_map, the closed loop
# ---------------------------------------------------------------------------


def rel_err(got, ref) -> float:
    """Largest absolute difference over the reference's largest entry."""
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-30))


def rounding_scales(cam19, camp, uvw, x3, delta):
    """What f32 rounding of K7's b_c (C,6), b_p (3,P) and cost is relative
    to: the sums of the absolute values of their terms, each residual taken
    at the size of the pixel coordinates it is the difference of, so that
    the scale stays that of the inputs at a zero-residual optimum (plain
    torch on the plain version's formulas)."""
    import torch

    from sfmx_torch.kernels import segsum as sg

    tp, P = camp.shape
    g = list(cam19[:, camp.long()])
    uvw = uvw.reshape(tp, 3, P)
    u, v, wv = uvw[:, 0], uvw[:, 1], uvw[:, 2]
    ru, rv, aux = sg._proj_math(g, x3[0], x3[1], x3[2], u, v)
    rho, wh = sg._huber_rows(ru, rv, delta)
    fm = aux[2]
    mu = (u.abs() + g[14].abs()) / fm + ru.abs()
    mv = (v.abs() + g[15].abs()) / fm + rv.abs()
    wh = wh * wv
    Ju, Jv, Pu, Pv = sg._jac_rows(g, aux)
    sc = torch.stack([wh * (Ju[a].abs() * mu + Jv[a].abs() * mv) for a in range(6)], dim=-1)
    s_bc = torch.zeros((cam19.shape[1], 6), dtype=sc.dtype, device=sc.device).index_add_(
        0, camp.reshape(-1).long(), sc.reshape(tp * P, 6))
    s_bp = torch.stack([torch.sum(wh * (Pu[k].abs() * mu + Pv[k].abs() * mv), dim=0)
                        for k in range(3)])
    s_cost = torch.sum(0.5 * rho * wv + wh * (ru.abs() * mu + rv.abs() * mv))
    return s_bc, s_bp, s_cost


def ba_kernel_checks(tag: str, prob: dict, tp: int, delta: float, smi: str,
                     profile: bool = False) -> dict:
    """K7, K6 and K8 against their plain versions on the dense layout of one
    problem (tensors on the card under ``ba_solve``'s argument names), with
    their times and bounds; with ``profile`` also K6's and K8's device time
    per call apart from their call times.  Observations past slot tp of a
    point are left out of the layout on both sides."""
    import torch

    from sfmx_torch.kernels import segsum as sg
    from sfmx_torch.solvers import schur

    dev = prob["X"].device
    C, P = prob["R"].shape[0], prob["X"].shape[0]
    dense = sg.build_dense_obs(prob["pt_id"], prob["cam_id"], P, C, tp)
    uvw = sg.pack_rows(dense, torch.cat([prob["uv"], prob["w_valid"][:, None]], 1))
    cam19 = sg.build_cam_table(prob["intr"], prob["k_idx"], prob["R"], prob["t"])
    x3 = prob["X"].T.contiguous()
    n_dense = int(dense.cnt.sum())
    out = {}

    # K7, bound to the layout once, as ba_solve binds it
    asm = sg.AssembleFused(dense, uvw)
    U, bc, v13, Wp = asm(cam19, x3, delta)
    rU, rbc, rv13, rWp = sg.ba_assemble_fused_plain(cam19, dense.camp, uvw, x3, delta)
    s_bc, s_bp, s_cost = rounding_scales(cam19, dense.camp, uvw, x3, delta)
    torch.cuda.synchronize()
    d_cost = abs(float(v13[12].sum()) - float(rv13[12].sum()))
    e7 = {"U": rel_err(U, rU), "V9": rel_err(v13[:9], rv13[:9]), "Wp": rel_err(Wp, rWp),
          "b_c": float((bc - rbc).abs().max() / s_bc.max()),
          "b_p": float((v13[9:12] - rv13[9:12]).abs().max() / s_bp.max()),
          "cost": d_cost / float(s_cost)}
    # printed beside: the same errors over the largest entry, which near an
    # optimum (b and the cost rounding themselves) say nothing
    by_entry = {"b_c": rel_err(bc, rbc), "b_p": rel_err(v13[9:12], rv13[9:12]),
                "cost": d_cost / float(rv13[12].sum())}
    abs7 = max(float((U - rU).abs().max()), float((Wp - rWp).abs().max()),
               float((v13 - rv13).abs().max()), float((bc - rbc).abs().max()))
    tol7 = KERNELS["ba_assemble_fused"][2]
    ms7 = cuda_ms(lambda: asm(cam19, x3, delta), reps=21, warm=3)
    # the one-shot wrapper (binds on every call): how K7 was timed before it
    # was bound once per solve
    once7 = cuda_ms(lambda: sg.ba_assemble_fused(cam19, dense, uvw, x3, delta), reps=21, warm=3)
    b2b7 = cuda_ms_per_call(lambda: asm(cam19, x3, delta))
    # the mean traced launch of each of its two kernels: an event pair around
    # so short a call times the wrapper's host path
    dev7, note7 = launch_device_ms(lambda: asm(cam19, x3, delta), 20)
    p7 = cuda_ms(lambda: sg.ba_assemble_fused_plain(cam19, dense.camp, uvw, x3, delta), reps=3, warm=1)
    same7 = all(torch.equal(a, b) for a, b in zip((U, bc, v13, Wp), asm(cam19, x3, delta)))
    log(f"[BA kernels] {tag}: K7 ba_assemble_fused C={C} P={P} O={n_dense} tp={tp} "
        f"({sg.assemble_slot_groups(tp, P)} slot groups): relative errors "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in e7.items()})} (U, V9, Wp over their "
        f"largest entry, tol {tol7:.0e}; b_c, b_p, cost over their rounding scale, tol "
        f"{ROUND_TOL:.0e}; over the largest "
        f"entry {json.dumps({k: float(f'{v:.3e}') for k, v in by_entry.items()})}); max abs "
        f"{abs7:.3e}; kernel "
        f"{ms7:.4f} ms by CUDA events around one call bound to the layout ({once7:.4f} through "
        f"the one-shot wrapper), {b2b7:.4f} ms per call "
        f"over 20 back to back, device {dev7:.4f} ms per call by torch.profiler ({note7}); plain "
        f"{p7:.3f} ms; two calls bit-equal {same7}; on {smi}")
    assert max(e7["U"], e7["V9"], e7["Wp"]) <= tol7, f"K7 errors {e7}"
    assert max(e7["b_c"], e7["b_p"], e7["cost"]) <= ROUND_TOL, f"K7 errors {e7}"
    assert same7, "K7: two calls gave different bits"
    # necessary work: uvw, camp, X and the camera table read, W, the point
    # rows and the camera blocks written; ~350 FLOP per observation
    out["ba_assemble_fused"] = {
        "max_abs_err": abs7, "max_rel_err": max(e7.values()), "ms": ms7, "oneshot_ms": once7,
        "b2b_ms": b2b7, "device_ms": dev7, "plain_ms": p7,
        **bound(n_dense * (12 + 4 + 72) + P * (12 + 52) + C * (76 + 168), 350.0 * n_dense, "f32")}

    # K6 on the system K7 assembled, bound once as the PCG loop binds it
    vinv = schur._damp_inv3_rows(v13[:9], 1e-4).contiguous()
    xv = torch.randn((6, C), generator=torch.Generator().manual_seed(1)).to(dev)
    cross = sg.SchurMatvec(Wp, dense, vinv)
    z, vy = cross(xv)
    rz, rvy = sg.schur_cross_matvec_plain(Wp, dense.camp, vinv, xv)
    torch.cuda.synchronize()
    e6 = max(rel_err(z, rz), rel_err(vy, rvy))
    abs6 = max(float((z - rz).abs().max()), float((vy - rvy).abs().max()))
    tol6 = KERNELS["schur_cross_matvec"][2]
    ms6 = cuda_ms(lambda: cross(xv), reps=21, warm=3)
    ms6_once = cuda_ms(lambda: sg.schur_cross_matvec(Wp, dense, vinv, xv), reps=21, warm=3)
    p6 = cuda_ms(lambda: sg.schur_cross_matvec_plain(Wp, dense.camp, vinv, xv), reps=3, warm=1)
    dev6 = ""
    if profile:
        # the event pair around one call times the wrapper's host gaps too
        ms_dev, note = launch_device_ms(lambda: cross(xv), 20)
        dev6 = f"; device {ms_dev:.4f} ms per call by torch.profiler ({note})"
    log(f"[BA kernels] {tag}: K6 schur_cross_matvec: relative error {e6:.3e} (tol {tol6:.0e}), max abs "
        f"{abs6:.3e}; kernel {ms6:.4f} ms by CUDA events around one call of the bound system "
        f"({n_dense * 72 / ms6 / 1e6:.1f} GB/s of W; {ms6_once:.4f} ms through the one-shot wrapper, "
        f"which checks the system each time){dev6}; plain {p6:.3f} ms on {smi}")
    assert e6 <= tol6, f"K6 relative error {e6}"
    # necessary work: W and camp of the real observations, the point rows
    # (Vinv in, vy out), x and z; 72 FLOP per observation
    out["schur_cross_matvec"] = {
        "max_abs_err": abs6, "max_rel_err": e6, "ms": ms6, "plain_ms": p6,
        **bound(n_dense * (72 + 4) + P * (36 + 12) + C * 48, 72.0 * n_dense, "f32")}

    # K8, the four trial steps of an LM iteration
    nc = 4
    cams = torch.cat([sg.build_cam_table(prob["intr"], prob["k_idx"], prob["R"],
                                         prob["t"] + 0.01 * c) for c in range(nc)], 0)
    xs = torch.cat([(prob["X"] + 0.005 * c).T for c in range(nc)], 0).contiguous()
    # bound to the layout once, as ba_solve binds it
    cost = sg.CostFused(dense, uvw)
    got = cost(cams, xs, delta, nc)
    ref = sg.ba_cost_fused_plain(cams, dense.camp, uvw, xs, delta, nc)
    torch.cuda.synchronize()
    e8 = float(((got - ref).abs() / ref).max())
    abs8 = float((got - ref).abs().max())
    tol8 = KERNELS["ba_cost_fused"][2]
    ms8 = cuda_ms(lambda: cost(cams, xs, delta, nc), reps=21, warm=3)
    b2b8 = cuda_ms_per_call(lambda: cost(cams, xs, delta, nc))
    ms8_once = cuda_ms(lambda: sg.ba_cost_fused(cams, dense, uvw, xs, delta, nc=nc), reps=21, warm=3)
    p8 = cuda_ms(lambda: sg.ba_cost_fused_plain(cams, dense.camp, uvw, xs, delta, nc), reps=3, warm=1)
    # the LM loop's invariants: the same bits from a second call, and a
    # candidate's cost the same from an nc = 1 launch as from its place here
    again = sg.ba_cost_fused(cams, dense, uvw, xs, delta, nc=nc)
    alone = [cost(cams[19 * c:19 * c + 19], xs[3 * c:3 * c + 3], delta, 1) for c in range(nc)]
    same8 = torch.equal(got, again) and all(torch.equal(got[c:c + 1], a) for c, a in enumerate(alone))
    dev8 = ""
    if profile:
        ms_dev, note = launch_device_ms(lambda: cost(cams, xs, delta, nc), 20)
        dev8 = f"; device {ms_dev:.4f} ms per call by torch.profiler ({note})"
    log(f"[BA kernels] {tag}: K8 ba_cost_fused nc={nc} ({sg.cost_slot_groups(tp, P)} slot groups): "
        f"relative error {e8:.3e} (tol {tol8:.0e}), max abs {abs8:.3e} of costs "
        f"{[float(f'{c:.4f}') for c in ref.tolist()]}; kernel {ms8:.4f} ms by CUDA events around "
        f"one call bound to the layout ({ms8_once:.4f} ms through the one-shot wrapper, {b2b8:.4f} "
        f"ms per call over 20 back to back){dev8}; "
        f"plain {p8:.3f} ms; two calls and each candidate alone bit-equal {same8}; on {smi}")
    assert e8 <= tol8, f"K8 relative error {e8}"
    assert same8, "K8: a candidate's cost changed between calls or with nc and its place"
    out["ba_cost_fused"] = {
        "max_abs_err": abs8, "max_rel_err": e8, "ms": ms8, "plain_ms": p8,
        **bound(n_dense * (12 + 4) + nc * (P * 12 + C * 76 + 4), 60.0 * nc * n_dense, "f32")}

    return out


def phase_ba_kernels(dev, smi: str, profile: bool) -> None:
    """K7, K6 and K8 against their plain versions on a random problem of
    BA_SHAPE (camera-local visibility, tracks of ~10 views), their times,
    the LM rate of the dense solve beside the planes path, and the same
    dense solve twice."""
    import torch

    from sfmx_torch.kernels import _build
    from sfmx_torch.solvers import lm
    from tests.smoke_scenes import ba_problem

    C, P, O, tp = (BA_SHAPE[k] for k in ("C", "P", "O", "tp"))
    cg, iters = BA_SHAPE["cg_iters"], BA_SHAPE["lm_iters"]
    prob = {k: torch.as_tensor(v, device=dev)
            for k, v in ba_problem(C, P, O, seed=0, window=16, perturb=0.03).items()}
    lens = np.bincount(prob["pt_id"].cpu().numpy(), minlength=P)
    assert lens.max() <= tp, f"tracks up to {lens.max()} views do not fit tp={tp}"
    ba_kernel_checks("512 cameras", prob, tp, 4.0 / 500.0, smi, profile)

    # the LM rate of both paths, and the dense solve twice
    def solve(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lm.ba_solve(*prob.values(), iters=iters, cg_iters=cg, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    dkw = dict(tp_cap=tp, dense_cg=True)
    solve(**dkw)                                   # warm
    _build.LAUNCHES.reset()
    d1, wall_d = solve(**dkw)
    counts = dict(_build.LAUNCHES.counts)
    d2, _ = solve(**dkw)
    solve()
    pl, wall_p = solve()
    pl2, _ = solve()
    same = all(torch.equal(a, b) for a, b in zip(d1, d2))
    diff = max(float((a - b).abs().max()) for a, b in zip(d1, d2))
    same_p = all(torch.equal(a, b) for a, b in zip(pl, pl2))
    diff_p = max(float((a - b).abs().max()) for a, b in zip(pl, pl2))
    log(f"[BA solve] {iters} LM iterations x {cg} CG steps, C={C} P={P} O={O}: dense path "
        f"(K6-K8) {iters / wall_d:.2f} LM iterations/s ({wall_d * 1e3:.1f} ms), planes path "
        f"{iters / wall_p:.2f}/s ({wall_p * 1e3:.1f} ms); cost {float(d1[3][0]):.5f} -> "
        f"{float(d1[3][-1]):.5f} (dense), -> {float(pl[3][-1]):.5f} (planes); launches "
        f"{json.dumps(counts)}; on {smi}")
    log(f"[BA solve] the same dense solve twice: bit-identical {same}, largest difference "
        f"{diff:.3e}; the same planes solve twice (fixed-order segment sums): bit-identical "
        f"{same_p}, largest difference {diff_p:.3e}")
    assert same and same_p, "a BA solve repeated on one input gave other bits"
    check_launches("BA solve", counts, {"ba_assemble_fused": 2 * iters,
                                        "schur_cross_matvec": 2 * iters * (cg + 2),
                                        "ba_cost_fused": iters + 1})
    assert float(d1[3][-1]) < 0.5 * float(d1[3][0]), "the dense solve did not converge"
    assert abs(float(d1[3][-1]) - float(pl[3][-1])) <= 0.02 * float(pl[3][-1]), \
        "dense and planes solves end at different costs"
    if profile:
        ms_d, by_name, _table = device_ms_per_run(
            lambda: lm.ba_solve(*prob.values(), iters=iters, cg_iters=cg, **dkw), 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"[profile] BA dense solve: device {ms_d:.2f} ms of {wall_d * 1e3:.1f} ms wall (busy "
            f"{ms_d / (wall_d * 1e3):.3f}); " + "; ".join(f"{t:.3f} ms {k[:50]}" for k, t in top)
            + f"; on {smi}")


def phase_segment_sum(dev, smi: str) -> dict:
    """The fixed-order segment sum against its plain version at BA_SHAPE:
    the camera sum of an (O,36) block (the planes path's U), the point sum
    of an (O,9) block (V) and one segment of every row (the joint
    intrinsics' group sum: pieces, then a second launch); two calls, and the
    table shuffled with each segment's order kept, bit-equal; the kernel
    beside the plain version and ``index_add_``.  The camera sum's numbers
    go into the kernels line."""
    import torch

    from sfmx_torch.kernels import segment_sum as ss
    from tests.smoke_scenes import ba_problem

    C, P, O = (BA_SHAPE[k] for k in ("C", "P", "O"))
    prob = ba_problem(C, P, O, seed=0, window=16, perturb=0.03)
    cam = torch.as_tensor(prob["cam_id"], device=dev).long()
    pt = torch.as_tensor(prob["pt_id"], device=dev).long()
    g = torch.Generator(device=dev).manual_seed(3)
    tol = KERNELS["segment_sum"][2]
    out = {}
    for tag, ids, n, k in (("camera", cam, C, 36), ("point", pt, P, 9),
                           ("one group", torch.zeros_like(cam), 1, 4)):
        x = torch.randn((ids.shape[0], k), generator=g, device=dev)
        plan = ss.segment_plan(ids, n)
        got, ref = ss.segment_sum(x, plan), ss.segment_sum_plain(x, plan)
        again = ss.segment_sum(x, ss.segment_plan(ids, n))
        # rows of different segments interleaved otherwise, each segment's order kept
        key = torch.randperm(n, generator=g, device=dev)[ids] * ids.shape[0] + \
            torch.arange(ids.shape[0], device=dev)
        sh = torch.argsort(key)
        moved = ss.segment_sum(x[sh], ss.segment_plan(ids[sh], n))
        lib = torch.zeros((n, k), device=dev).index_add_(0, ids, x)
        torch.cuda.synchronize()
        abs_err = float((got - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        same = torch.equal(got, again) and torch.equal(got, moved)
        ms = cuda_ms(lambda: ss.segment_sum(x, plan), reps=21, warm=3)
        b2b = cuda_ms_per_call(lambda: ss.segment_sum(x, plan))
        p_ms = cuda_ms(lambda: ss.segment_sum_plain(x, plan), reps=21, warm=3)
        lib_ms = cuda_ms(lambda: torch.zeros((n, k), device=dev).index_add_(0, ids, x), reps=21,
                         warm=3)
        pieces = plan.piece_off.shape[0] - 1
        log(f"[segment sum] {tag} sum of ({ids.shape[0]},{k}) into {n} segments ({pieces} pieces"
            f"{', two launches' if plan.seg_piece is not None else ''}): error {rel:.3e} of the "
            f"largest sum (tol {tol:.0e}), max abs {abs_err:.3e}; index_add_ differs by "
            f"{float((lib - ref).abs().max()):.3e}; two calls and the shuffled table bit-equal "
            f"{same}; kernel {ms:.4f} ms by CUDA events around one call, {b2b:.4f} ms per call "
            f"over 20 back to back; plain (segment_reduce) {p_ms:.4f} ms; index_add_ {lib_ms:.4f} "
            f"ms; on {smi}")
        assert rel <= tol, f"segment sum ({tag}): error {rel} over the largest sum"
        assert same, f"segment sum ({tag}): the same sums gave other bits"
        if tag == "camera":
            # necessary work: x, the permutation and the offsets read, the
            # sums written; one f32 add per term
            out = {"max_abs_err": abs_err, "max_rel_err": rel, "ms": ms, "b2b_ms": b2b,
                   "plain_ms": p_ms,
                   **bound(ids.shape[0] * (4 * k + 4) + (n + 1) * 4 + n * k * 4,
                           float(ids.shape[0] * k), "f32"),
                   "library_ms": lib_ms}
    return out


def phase_build_map(frames, poses, dev, smi: str, profile: bool):
    """The N_BUILD-frame exhaustive build through ``build_map``, then K6-K8
    against their plain versions on the final BA's table (the built scene's
    alive observations at the tp the build chose); returns (scene, feats,
    tt, the similarity to the rendered world, launches, kernel stats)."""
    import io

    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import build_map
    from sfmx_torch.kernels import _build
    from sfmx_torch.solvers import umeyama
    from sfmx_torch.utils.logging import LOGGER

    cfg = PipelineConfig()     # the default ReconConfig: components on (max_components=3)
    n = len(frames)
    buf, old = io.StringIO(), LOGGER._stream
    LOGGER._stream = buf
    try:
        with plain_matcher_calls() as plain:
            torch.cuda.synchronize()
            _build.LAUNCHES.reset()
            t0 = time.perf_counter()
            scene, feats, tt, stats = build_map(
                frames, INTR[None], np.zeros(n, np.int32), cfg, dev,
                generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES.counts)
    finally:
        LOGGER._stream = old
    stages = {r["stage"]: r for r in map(json.loads, buf.getvalue().splitlines())}
    eyes = torch.as_tensor(np.stack([eye for _R, _t, eye in poses]), dtype=torch.float32,
                           device=dev)
    ate, sim = umeyama.ate_rmse(scene.centers, eyes, scene.cam_alive)
    ate = float(ate)
    n_reg, n_pts, n_obs = scene.counts()
    log(f"[build_map] {n} frames: stage wall "
        + ", ".join(f"{k} {r['wall_s']:.3f} s" for k, r in stages.items())
        + f"; whole {wall:.3f} s; {n_reg}/{n} registered (gate {n}), {n_pts} points, {n_obs} "
        f"alive observations of {tt.n_tracks} tracks; median reprojection "
        f"{stats['final_med_px']:.4f} px (gate < {REPROJ_GATE_PX}); ATE {ate:.4f} m (gate < "
        f"{ATE_GATE_M}; map scale {float(sim[0]):.4f} m per unit); seed pair {stats['init_pair']} "
        f"at {stats['init_med_px']} px; {stats['n_rounds']} rounds; on {smi}")
    log(f"[build_map] reconstruct phases {json.dumps(stats['phase_s'])}; BA calls by path "
        f"{json.dumps(stats['ba_calls'])}, final {json.dumps(stats['ba_path'])}; "
        f"{stats['ba_total_iters']} LM iterations in {stats['ba_total_s']} s = "
        f"{stats['ba_iters_per_s']} iterations/s; calls [obs, iters, s] "
        f"{json.dumps(stats['ba_call_s'])}; launches {json.dumps(launches)}; plain matcher "
        f"calls {plain}")
    log(f"[build_map] components {json.dumps(stats['components'])} (the loop entered and "
        f"skipped: {n_reg}/{n} registered is over coverage_target "
        f"{cfg.recon.coverage_target}); component loop {json.dumps(stats['component_loop_s'])} s")
    assert "cuda" not in plain, "build_map: the plain matcher ran on the card"
    assert stats["components"] == [{"component": 0, "registered": n}], stats["components"]
    assert n_reg == n, f"build_map: {n_reg}/{n} cameras registered"
    assert stats["final_med_px"] < REPROJ_GATE_PX, f"build_map: {stats['final_med_px']} px"
    assert np.isfinite(ate) and ate < ATE_GATE_M, f"build_map: ATE {ate} m"
    assert stats["ba_path"]["mode"] == "dense", f"final BA on {stats['ba_path']}"
    k6, k7, k8 = (launches.get(k, 0) for k in
                  ("schur_cross_matvec", "ba_assemble_fused", "ba_cost_fused"))
    assert k6 > 0 and k7 > 0 and k8 > 0, f"build_map: BA kernel launches {launches}"
    assert k6 == (cfg.recon.cg_iters + 2) * k7, f"build_map: K6 {k6} vs K7 {k7}"
    assert k8 == k7 // 2 + stats["ba_calls"]["dense"], f"build_map: K8 {k8} vs K7 {k7}"
    ext = extraction_launches()
    assert all(launches.get(k, 0) == v for k, v in ext.items()), launches
    assert launches.get("match_pairs_fused", 0) == 2, launches
    if profile:
        log(f"[profile] build_map: reconstruct {stages['reconstruct']['wall_s']:.2f} s of "
            f"{wall:.2f} s, of which BA {stats['phase_s']['ba']} s; BA's device share is "
            "profiled on the BA solve phase")
    alive = scene.obs_alive
    prob = dict(intr=scene.intr, k_idx=scene.cam_k, R=scene.cam_R, t=scene.cam_t, X=scene.X,
                cam_id=scene.obs_cam[alive], pt_id=scene.obs_pt[alive], uv=scene.obs_uv[alive],
                w_valid=torch.ones(int(alive.sum()), device=dev))
    kstats = ba_kernel_checks(f"{n}-frame build", prob, stats["ba_path"]["tp"],
                              cfg.recon.huber_px / FOCAL, smi, profile)
    return scene, feats, tt, sim, launches, kstats, stats


def phase_loop(tex, scene, feats, tt, sim, dev) -> None:
    """The built map saved, loaded and served by the port's query side:
    N_LOOP_QUERIES held-out frames (midpoints between build frames)
    localized against it, their centers mapped to the rendered world by the
    build's similarity."""
    import tempfile

    import torch

    from examples import room
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.main import localize_images
    from sfmx_torch.localize.localize import build_localization_map
    from sfmx_torch.mapstore.scene import load_scene_np, save_scene
    from sfmx_torch.solvers import umeyama

    with tempfile.TemporaryDirectory() as tmp:
        save_scene(Path(tmp) / "map", scene, extra={"source": "chip_smoke build_map"})
        cols = {k: np.array(v) for k, v in load_scene_np(Path(tmp) / "map").items()}
    for k, v in scene.to_numpy().items():
        assert np.array_equal(cols[k], v), f"scene store round trip changed {k}"
    lmap = build_localization_map(cols, feats.desc.cpu().numpy(), tt.obs_feat, dev,
                                  kp_mask=feats.kp.mask.cpu().numpy(), n_words=64, seed=0)
    mids = room.walk_poses(N_BAND - 1)[1::2]            # between the first pass's frames
    pick = np.round(np.linspace(0, N_BUILD - 2, N_LOOP_QUERIES)).astype(int)
    qposes = [mids[i] for i in pick]
    frames = render(tex, qposes)
    results = localize_images(frames, INTR, lmap, PipelineConfig(),
                              generator=torch.Generator(device=dev).manual_seed(9))
    centers = torch.as_tensor(np.stack([np.asarray(r["center"]) for r in results]),
                              dtype=torch.float32, device=dev)
    world = umeyama.apply_sim3(*sim, centers).cpu().numpy()
    errs = np.array([np.linalg.norm(w - eye) for w, (_R, _t, eye) in zip(world, qposes)])
    n_conf = sum(r["confidence"] > 0 for r in results)
    log(f"[loop] map saved, loaded and served: {lmap.X.shape[0]} landmarks "
        f"({int(lmap.lm_alive.sum())} alive), {lmap.kf_gdesc.shape[0]} keyframes; "
        f"{N_LOOP_QUERIES} held-out frames: center errors "
        f"{[float(f'{e:.4f}') for e in errs]} m, median {np.median(errs):.4f} m (gate < "
        f"{MEDIAN_GATE_M}); {n_conf}/{N_LOOP_QUERIES} localized (gate >= {N_LOOP_MIN})")
    assert np.isfinite(errs).all(), "loop: non-finite pose"
    assert np.median(errs) < MEDIAN_GATE_M, f"loop: median center error {np.median(errs)} m"
    assert n_conf >= N_LOOP_MIN, f"loop: only {n_conf} queries localized"


def phase_ba_crosscheck(dev) -> None:
    """One 8-camera dense ``ba_solve`` on the card (K6-K8, with overflow
    observations chained in) against the plain path on the CPU: first cost
    rtol 1e-4 (the residual's f32 cancellation), final cost within 2 %, R, t
    and X within 2e-2 of a scene 25 units deep (LM amplifies rounding along
    the free scale gauge)."""
    import torch

    from sfmx_torch.solvers import lm
    from tests.smoke_scenes import ba_problem

    prob = ba_problem(8, 300, 2000, seed=5, window=4, long_tracks=6, perturb=0.03)
    lens = np.bincount(prob["pt_id"], minlength=300)
    kw = dict(iters=8, cg_iters=25, tp_cap=8, dense_cg=True,
              ov_cap=int(np.maximum(lens - 8, 0).sum()))
    card = lm.ba_solve(*(torch.as_tensor(v, device=dev) for v in prob.values()), **kw)
    cpu = lm.ba_solve(*(torch.as_tensor(v) for v in prob.values()), **kw)
    c0, c1 = card[3].cpu(), cpu[3]
    dmax = max(float((a.cpu() - b).abs().max()) for a, b in zip(card[:3], cpu[:3]))
    log(f"[BA crosscheck] 8 cameras, {len(prob['pt_id'])} observations ({kw['ov_cap']} overflow): "
        f"cost {float(c0[0]):.6f} -> {float(c0[-1]):.6f} on the card, {float(c1[0]):.6f} -> "
        f"{float(c1[-1]):.6f} on the CPU; R, t, X max |diff| {dmax:.2e} (gate < 2e-2)")
    assert abs(float(c0[0]) - float(c1[0])) <= 1e-4 * float(c1[0])
    assert abs(float(c0[-1]) - float(c1[-1])) <= 0.02 * float(c1[-1])
    assert float(c0[-1]) < 0.5 * float(c0[0]) and dmax < 2e-2


# ---------------------------------------------------------------------------
# The rest of reconstruction: the checkpointed final BA, secondary
# components, the merge of two sessions, self-calibration
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recorded(mod, name: str):
    """Wrap ``mod.name`` while the block runs: every call's arguments, its
    host wall (the card synchronized on both sides) and the kernel launches
    made inside it."""
    import torch

    from sfmx_torch.kernels import _build

    calls: list[dict] = []
    orig = getattr(mod, name)

    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES.counts)
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = dict(_build.LAUNCHES.counts)
        calls.append({"args": args, "kw": kw, "wall": wall,
                      "launches": {k: v - before.get(k, 0) for k, v in after.items()
                                   if v != before.get(k, 0)}})
        return out

    setattr(mod, name, wrapper)
    try:
        yield calls
    finally:
        setattr(mod, name, orig)


def synced(fn):
    """(fn(), host wall in s) with the card synchronized on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def add_launches(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def run_build(tag: str, frames, poses, cfg, dev, intr=None):
    """``build_map`` on the card (launch counts left as they are); returns
    (scene, feats, tt, stats, wall s, ATE m of the camera centers against
    the rendered eyes after a similarity alignment)."""
    import io

    import torch

    from sfmx_torch.cli.pipeline import build_map
    from sfmx_torch.solvers import umeyama
    from sfmx_torch.utils.logging import LOGGER

    n = len(frames)
    intr = INTR if intr is None else intr
    buf, old = io.StringIO(), LOGGER._stream
    LOGGER._stream = buf
    try:
        (scene, feats, tt, stats), wall = synced(lambda: build_map(
            frames, intr[None], np.zeros(n, np.int32), cfg, dev,
            generator=torch.Generator(device=dev).manual_seed(0)))
    finally:
        LOGGER._stream = old
    eyes = torch.as_tensor(np.stack([eye for _R, _t, eye in poses]), dtype=torch.float32,
                           device=dev)
    ate = float(umeyama.ate_rmse(scene.centers, eyes, scene.cam_alive)[0])
    log(f"[{tag}] {n} frames through build_map in {wall:.3f} s: "
        f"{int(scene.cam_alive.sum())}/{n} registered, {int(scene.X_alive.sum())} points, median "
        f"reprojection {stats['final_med_px']} px, ATE {ate:.4f} m; final BA "
        f"{json.dumps(stats['ba_path'])}; BA calls {json.dumps(stats['ba_calls'])}, "
        f"{stats['ba_iters_per_s']} LM iterations/s; components {json.dumps(stats['components'])}")
    return scene, feats, tt, stats, wall, ate


def phase_ckpt(frames, poses, scene, dev, smi: str) -> dict:
    """Phase B.  The 96-frame build's final-BA table (its alive
    observations, the built poses, the points moved by 2 mm of seeded noise)
    on the dense path with tp covering the longest track, so that no
    observation rides the overflow chain (whose ``index_add_`` sums in no
    fixed order): ``ba_solve_checkpointed(CKPT_ITERS, CKPT_EVERY)`` beside
    one uninterrupted ``ba_solve(CKPT_ITERS)``, CKPT_REPS times in turn for
    the overhead, and a solve of CKPT_EVERY iterations resumed from its file
    to CKPT_ITERS by a new call that gets only the initial inputs and the
    file.  Gate: all of them bit-identical.  K6-K8 launches per chunk
    against the LM loop's count.  Then ``build_map`` with
    ``recon.final_ba_ckpt`` under the build gates.  Returns the launches of
    the path: the first checkpointed solve, the resumed one and the
    ``build_map``, each counted from 0 (not the uninterrupted solves they
    are held against, nor the solve that writes the file to resume from)."""
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.kernels import _build
    from sfmx_torch.solvers import ba_ckpt, lm

    rc = PipelineConfig().recon
    alive = scene.obs_alive
    pt = scene.obs_pt[alive]
    longest = int(torch.bincount(pt.long()).max())
    assert longest <= 128, f"a track of {longest} views: no overflow-free layout"
    tp = next(c for c in (8, 16, 32, 64, 128) if c >= longest)
    fixed = ~scene.cam_alive
    fixed[torch.nonzero(scene.cam_alive)[0, 0]] = True
    noise = torch.randn(scene.X.shape, generator=torch.Generator().manual_seed(3))
    args = (scene.intr, scene.cam_k, scene.cam_R, scene.cam_t, scene.X + 0.002 * noise.to(dev),
            scene.obs_cam[alive], pt, scene.obs_uv[alive],
            torch.ones(len(pt), dtype=torch.float32, device=dev), fixed)
    kw = dict(cg_iters=rc.cg_iters, huber_px=rc.huber_px, tp_cap=tp, dense_cg=True)
    lm.ba_solve(*args, iters=1, **kw)                       # warm
    scratch = ROOT / ".chip_scratch"
    scratch.mkdir(exist_ok=True)
    p_whole, p_resume = scratch / "ckpt_whole.npz", scratch / "ckpt_resume.npz"
    p_resume.unlink(missing_ok=True)
    record: list = [None]          # where the next chunk's launches go, if anywhere
    orig_save = ba_ckpt.save_ckpt

    def save_and_count(*a, **k):
        orig_save(*a, **k)
        if record[0] is not None:
            record[0].append(dict(_build.LAUNCHES.counts))
        _build.LAUNCHES.reset()

    def checkpointed(path, total_iters, chunks_out):
        record[0] = chunks_out
        _build.LAUNCHES.reset()
        return synced(lambda: ba_ckpt.ba_solve_checkpointed(
            *args, total_iters=total_iters, ckpt_every=CKPT_EVERY, ckpt_path=path, **kw))

    per_chunk: list[dict] = []
    resume_chunks: list[dict] = []
    walls_u, walls_c, runs = [], [], []
    ba_ckpt.save_ckpt = save_and_count
    try:
        for rep in range(CKPT_REPS):
            uninterrupted, wall_u = synced(lambda: lm.ba_solve(*args, iters=CKPT_ITERS, **kw))
            p_whole.unlink(missing_ok=True)
            (*ckpt_out, ran_c), wall_c = checkpointed(p_whole, CKPT_ITERS,
                                                      per_chunk if rep == 0 else None)
            walls_u.append(wall_u)
            walls_c.append(wall_c)
            runs += [uninterrupted, ckpt_out]
        checkpointed(p_resume, CKPT_EVERY, None)
        # the process state of that solve is gone: the next call has the
        # initial inputs and the file
        (*resumed, ran_r), wall_r = checkpointed(p_resume, CKPT_ITERS, resume_chunks)
    finally:
        ba_ckpt.save_ckpt = orig_save
        record[0] = None
    costs_u = runs[0][3]
    runs.append(resumed)
    diffs = {k: max(float((r[i] - runs[0][i]).abs().max()) for r in runs[1:])
             for i, k in enumerate("RtX")}
    same = all(torch.equal(r[i], runs[0][i]) for r in runs[1:] for i in range(3))
    chunks = [min(CKPT_EVERY, CKPT_ITERS - i) for i in range(0, CKPT_ITERS, CKPT_EVERY)]
    expect = lambda ns: [{"ba_assemble_fused": 2 * n, "schur_cross_matvec": 2 * n * (rc.cg_iters + 2),
                          "ba_cost_fused": n + 1} for n in ns]
    over = sorted(c / u - 1.0 for c, u in zip(walls_c, walls_u))
    log(f"[ckpt] final-BA table of the {len(frames)}-frame build: {int(scene.cam_alive.sum())} "
        f"cameras, {int(scene.X_alive.sum())} points, {len(pt)} observations, tp={tp} (longest "
        f"track {longest}, no overflow); {CKPT_ITERS} LM iterations x {rc.cg_iters} CG steps, "
        f"{CKPT_REPS} times in turn: uninterrupted {[round(w * 1e3, 1) for w in walls_u]} ms, "
        f"checkpointed every {CKPT_EVERY} {[round(w * 1e3, 1) for w in walls_c]} ms; overhead "
        f"{[round(o, 3) for o in over]}, median {over[len(over) // 2]:+.3f} ({len(chunks)} "
        f"chunks, {len(chunks) - 1} extra initial costs, {len(chunks)} npz writes); resumed from "
        f"iteration {CKPT_EVERY} ({ran_r} iterations) {wall_r * 1e3:.1f} ms; cost "
        f"{float(costs_u[0]):.6f} -> {float(costs_u[-1]):.6f} (uninterrupted), -> "
        f"{float(runs[1][3][-1]):.6f} (checkpointed), -> {float(resumed[3][-1]):.6f} (resumed); "
        f"largest |difference| to the first uninterrupted solve over the other "
        f"{len(runs) - 1} {json.dumps(diffs)}; bit-identical {same}; launches per chunk "
        f"{json.dumps(per_chunk)}, resumed {json.dumps(resume_chunks)}; on {smi}")
    assert ran_c == CKPT_ITERS and ran_r == CKPT_ITERS - CKPT_EVERY, (ran_c, ran_r)
    assert same, f"checkpointed / resumed solves differ from the uninterrupted one: {diffs}"
    assert per_chunk == expect(chunks), f"launches per chunk {per_chunk}"
    assert resume_chunks == expect(chunks[1:]), f"launches per resumed chunk {resume_chunks}"
    assert float(costs_u[-1]) < float(costs_u[0]), "the final-BA table's solve did not descend"
    total: dict = {}
    for got in per_chunk + resume_chunks:
        add_launches(total, got)

    # build_map with the checkpointed final BA
    p_final = scratch / "final_ba.npz"
    p_final.unlink(missing_ok=True)
    cfg = PipelineConfig()
    cfg = dataclasses.replace(cfg, recon=dataclasses.replace(cfg.recon,
                                                              final_ba_ckpt=str(p_final)))
    _build.LAUNCHES.reset()
    sc2, _f, _tt, st2, _wall, ate = run_build("ckpt build_map", frames, poses, cfg, dev)
    launches = dict(_build.LAUNCHES.counts)
    add_launches(total, launches)
    with np.load(p_final) as z:
        it = int(z["it"])
    n = len(frames)
    n_reg = int(sc2.cam_alive.sum())
    k6, k7, k8 = (launches.get(k, 0) for k in
                  ("schur_cross_matvec", "ba_assemble_fused", "ba_cost_fused"))
    extra = len(chunks) - 1 if st2["ba_path"]["mode"] == "dense" else 0
    log(f"[ckpt] build_map with recon.final_ba_ckpt: checkpoint at iteration {it}; launches "
        f"{json.dumps(launches)} (K8 = K7 / 2 + dense BA calls + {extra} chunk restarts)")
    assert it == rc.final_ba_iters, f"final BA checkpoint at iteration {it}"
    assert n_reg == n, f"ckpt build_map: {n_reg}/{n} cameras registered"
    assert st2["final_med_px"] < REPROJ_GATE_PX, f"ckpt build_map: {st2['final_med_px']} px"
    assert np.isfinite(ate) and ate < ATE_GATE_M, f"ckpt build_map: ATE {ate} m"
    assert k6 == (rc.cg_iters + 2) * k7 and k8 == k7 // 2 + st2["ba_calls"]["dense"] + extra, \
        launches
    return total


def phase_components(dev, smi: str, profile: bool) -> tuple[dict, dict]:
    """Phase C.  The reference's stalling scene at the build's size
    (``smoke_scenes.two_cluster_world``: two arcs of N_ARC cameras around
    clusters of N_CLUSTER points joined by N_SHARED boundary points, K=1024
    noise-free keypoints with 128-float descriptors): the 4,560 pairs
    matched on the card (K5), tracks, and ``reconstruct`` with the
    reference test's overrides
    (25 resection and init inliers), once with ``max_components=1`` and
    once on the default.  Gates: one arc stays unregistered with one
    component; with components all cameras register, component 1 verified
    with >= 8 inliers, ATE < 0.1 and median reprojection < 1 px, the fusion
    BA's three anneal solves on the dense path with K6-K8 launched in each.
    Then K6-K8 against their plain versions on the fusion BA's table at the
    first stage's Huber (8 x huber_px), with FUSE_OUTLIERS of its
    observations moved 40-400 px so that the Huber tail past the 8x knee is
    exercised.  Returns (the launches of the components run, the fusion
    solves' calls)."""
    import io

    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import match_images
    from sfmx_torch.core import cameras
    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels.features import N_WORDS, Features, Keypoints
    from sfmx_torch.recon import incremental, tracks
    from sfmx_torch.solvers import lm, umeyama
    from sfmx_torch.utils.logging import LOGGER
    from tests import smoke_scenes

    uv, desc, mask, intr, centers, feat_pt = smoke_scenes.two_cluster_world(
        N_ARC, N_CLUSTER, N_SHARED, K=1024, seed=0)
    C, K = mask.shape
    shared_kp = ((feat_pt >= N_CLUSTER) & (feat_pt < N_CLUSTER + N_SHARED)).sum(1)
    z = torch.zeros((C, K), device=dev)
    feats = Features(Keypoints(torch.as_tensor(uv, device=dev), z.long(), z + 1, z, z,
                               torch.as_tensor(mask, device=dev)),
                     torch.as_tensor(desc, device=dev),
                     torch.zeros((C, K, N_WORDS), dtype=torch.int32, device=dev))
    pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, C)], np.int32)
    rcfg = dataclasses.replace(PipelineConfig().recon, min_resection_inliers=25,
                               min_init_inliers=25)
    pcfg = PipelineConfig()

    def build(cfg):
        buf, old = io.StringIO(), LOGGER._stream
        LOGGER._stream = buf          # match_images' stage record
        try:
            res = match_images(feats, pairs, pcfg)
        finally:
            LOGGER._stream = old
        tt = tracks.build_tracks(pairs, res.idx.cpu().numpy(), res.valid.cpu().numpy(), C, K)
        out = incremental.reconstruct(uv, mask, tt, intr[None], np.zeros(C, np.int32), cfg,
                                      pair_counts=(pairs, res.valid.sum(dim=1).cpu().numpy()),
                                      device=dev)
        return out + (tt,)

    (scene1, stats1, _), wall1 = synced(lambda: build(dataclasses.replace(rcfg,
                                                                          max_components=1)))
    arcs1 = [int(scene1.cam_alive[:N_ARC].sum()), int(scene1.cam_alive[N_ARC:].sum())]
    log(f"[components] two-cluster world: {C} cameras in two arcs of {N_ARC}, {N_CLUSTER} "
        f"points a cluster, {N_SHARED} shared boundary points ({int(shared_kp.max())} keypoints "
        f"on them in a camera at most, mean {shared_kp.mean():.1f}; the resection gate is 25); "
        f"with max_components=1: {stats1['n_registered']}/{C} registered (per arc {arcs1}) in "
        f"{wall1:.3f} s")
    assert min(arcs1) == 0, f"one component registered cameras of both arcs: {arcs1}"

    _build.LAUNCHES.reset()
    with recorded(lm, "ba_solve") as solves:
        (scene, stats, tt), wall = synced(lambda: build(rcfg))
    launches = dict(_build.LAUNCHES.counts)
    h = rcfg.huber_px
    fuse = [i for i in range(len(solves) - 2)
            if [solves[i + j]["kw"]["huber_px"] for j in range(3)] == [8 * h, 2 * h, h]]
    assert fuse, "no fusion BA (huber 8x, 2x, 1x) ran"
    fz = solves[fuse[0]:fuse[0] + 3]
    eyes = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    ate = float(umeyama.ate_rmse(scene.centers, eyes, scene.cam_alive)[0])
    comp1 = stats["components"][1] if len(stats["components"]) > 1 else {}
    fz_wall = sum(c["wall"] for c in fz)
    fz_iters = sum(c["kw"]["iters"] for c in fz)
    log(f"[components] default ReconConfig: {stats['n_registered']}/{C} registered, "
        f"{stats['n_points']} points of {tt.n_tracks} tracks, median reprojection "
        f"{stats['final_med_px']} px, ATE {ate:.4f} (gate < {ATE_GATE_M}); whole {wall:.3f} s "
        f"(match, tracks, reconstruct), reconstruct phases {json.dumps(stats['phase_s'])}; "
        f"component loop {stats['component_loop_s']['wall']} s, of it BA "
        f"{stats['component_loop_s']['ba']} s; components {json.dumps(stats['components'])}")
    log(f"[components] fusion BA: " + "; ".join(
        f"huber {c['kw']['huber_px']:g} px, {c['kw']['iters']} iterations, "
        f"{'dense tp=%d ov_cap=%d' % (c['kw']['tp_cap'], c['kw']['ov_cap']) if c['kw'].get('dense_cg') else 'planes'}"
        f", {len(c['args'][5])} observations, {c['wall'] * 1e3:.1f} ms, launches "
        f"{json.dumps(c['launches'])}" for c in fz)
        + f"; {fz_iters / fz_wall:.2f} LM iterations/s; final BA {json.dumps(stats['ba_path'])}; "
        f"BA calls {json.dumps(stats['ba_calls'])}; launches {json.dumps(launches)}; on {smi}")
    assert stats["n_registered"] == C, f"components: {stats['n_registered']}/{C} registered"
    assert comp1 and "fail" not in comp1, f"component 1: {comp1}"
    assert comp1["reg_inliers"] >= 8, f"component 1: {comp1}"
    assert np.isfinite(ate) and ate < ATE_GATE_M, f"components: ATE {ate}"
    assert stats["final_med_px"] < REPROJ_GATE_PX, f"components: {stats['final_med_px']} px"
    for c in fz:
        assert c["kw"].get("dense_cg"), f"a fusion solve on the planes path: {c['kw']}"
        assert all(c["launches"].get(k, 0) > 0 for k in
                   ("schur_cross_matvec", "ba_assemble_fused", "ba_cost_fused")), c["launches"]
    assert launches.get("match_pairs_fused", 0) == 2, launches

    names = ("intr", "k_idx", "R", "t", "X", "cam_id", "pt_id", "uv", "w_valid")
    prob = dict(zip(names, fz[0]["args"][:9]))
    ci = prob["cam_id"].long()

    def errs(uv_):
        return torch.linalg.vector_norm(cameras.reprojection_residual(
            prob["intr"][prob["k_idx"].long()[ci]], prob["R"][ci], prob["t"][ci],
            prob["X"][prob["pt_id"].long()], uv_), dim=-1)

    def table(err):
        return (f"reprojection median {float(err.median()):.4f} px, max {float(err.max()):.2f} px, "
                f"{float((err > h).float().mean()):.4f} of them past the 1x Huber knee ({h:g} px), "
                f"{float((err > 8 * h).float().mean()):.4f} past the 8x ({8 * h:g} px)")

    # gross outliers planted: the Huber tail the first anneal stage runs on
    gen = torch.Generator().manual_seed(11)
    n = len(ci)
    k = int(FUSE_OUTLIERS * n)
    idx = torch.randperm(n, generator=gen)[:k].to(dev)
    ang = (2 * np.pi * torch.rand(k, generator=gen)).to(dev)
    mag = (40.0 + 360.0 * torch.rand(k, generator=gen)).to(dev)
    uv_out = prob["uv"].clone()
    uv_out[idx] += torch.stack([mag * torch.cos(ang), mag * torch.sin(ang)], dim=1)
    log(f"[components] the fusion BA's table as fused: {n} observations, "
        f"{table(errs(prob['uv']))}; with {k} of them moved 40-400 px: {table(errs(uv_out))}")
    ba_kernel_checks("fusion BA (8x Huber, planted outliers)", {**prob, "uv": uv_out},
                     fz[0]["kw"]["tp_cap"], 8 * h / float(intr[0]), smi)
    if profile:
        first = fz[0]
        ms_d, by_name, _table = device_ms_per_run(lambda: lm.ba_solve(*first["args"],
                                                                      **first["kw"]), 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"[profile] fusion BA, first stage: device {ms_d:.2f} ms of {first['wall'] * 1e3:.1f} "
            f"ms wall (busy {ms_d / (first['wall'] * 1e3):.3f}); "
            + "; ".join(f"{t:.3f} ms {k[:50]}" for k, t in top) + f"; on {smi}")
    return launches, fz


def phase_merge(frames, poses, dev, smi: str) -> dict:
    """Phase D.  Two sessions of the 96-frame walk (frames MERGE_SESSIONS,
    overlapping by 24) through ``build_map`` on the card, then
    ``merge_scenes`` on their scenes, descriptors and obs_feat.  Gates: the
    session edge verified, the joint BA's cost falls, ATE of all merged
    camera centers against the rendered eyes < 0.1 m; the joint BA on the
    planes path, as in the reference (no K6-K8 launch inside the merge;
    its sums launch the segment sum).
    Returns the launches of ``merge_scenes`` alone, counted from 0: the
    session builds are ``build_map`` runs."""
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.kernels import _build
    from sfmx_torch.recon.merge import merge_scenes
    from sfmx_torch.solvers import umeyama

    cfg = PipelineConfig()
    sessions, walls, eyes = [], [], []
    for i, (lo, hi) in enumerate(MERGE_SESSIONS):
        scene, feats, tt, stats, wall, ate = run_build(f"merge session {i}", frames[lo:hi],
                                                        poses[lo:hi], cfg, dev)
        assert int(scene.cam_alive.sum()) == hi - lo and ate < ATE_GATE_M, \
            f"session {i}: {int(scene.cam_alive.sum())}/{hi - lo}, ATE {ate}"
        sessions.append((scene, feats.desc, feats.kp.uv, feats.kp.mask, tt.obs_feat))
        walls.append(wall)
        eyes += [eye for _R, _t, eye in poses[lo:hi]]
    _build.LAUNCHES.reset()
    (merged, mstats), wall_m = synced(lambda: merge_scenes(sessions))
    in_merge = {k: v for k, v in _build.LAUNCHES.counts.items() if v}
    ate = float(umeyama.ate_rmse(merged.centers, torch.as_tensor(
        np.stack(eyes), dtype=torch.float32, device=dev), merged.cam_alive)[0])
    c0, c1 = mstats["joint_ba_cost"]
    log(f"[merge] sessions {MERGE_SESSIONS} built in {walls[0]:.3f} s and {walls[1]:.3f} s; "
        f"merge_scenes {wall_m:.3f} s: edges {json.dumps(mstats['edges'])}, failed "
        f"{len(mstats['failed_edges'])}, pair inliers {mstats['pair_inliers']}, tree "
        f"{mstats['tree']}; {mstats['n_cameras']} cameras, {mstats['n_points']} points, "
        f"{len(merged.obs_cam)} observations; joint BA (planes path) cost {c0:.6f} -> {c1:.6f}; "
        f"ATE of the {len(eyes)} merged centers {ate:.4f} m (gate < {ATE_GATE_M}); launches "
        f"inside merge_scenes {json.dumps(in_merge)}; on {smi}")
    assert not mstats["failed_edges"] and len(mstats["edges"]) == 1, mstats["failed_edges"]
    assert mstats["n_cameras"] == len(eyes), mstats["n_cameras"]
    assert c1 < c0, f"merge: joint BA cost {c0} -> {c1}"
    assert np.isfinite(ate) and ate < ATE_GATE_M, f"merge: ATE {ate} m"
    assert not any(k in in_merge for k in
                   ("schur_cross_matvec", "ba_assemble_fused", "ba_cost_fused")), in_merge
    return in_merge


def reproj_median_px(scene) -> float:
    """Median pixel reprojection error of the alive observations under the
    scene's own intrinsics."""
    import torch

    from sfmx_torch.core import cameras

    a = scene.obs_alive
    ci, pi = scene.obs_cam[a].long(), scene.obs_pt[a].long()
    r = cameras.reprojection_residual(scene.intr[scene.cam_k.long()[ci]], scene.cam_R[ci],
                                      scene.cam_t[ci], scene.X[pi], scene.obs_uv[a])
    return float(torch.median(torch.linalg.vector_norm(r, dim=-1)))


def joint_solve_log(j: dict) -> str:
    it = j["kw"]["iters"]
    return (f"joint pose+point+intrinsics LM: {it} iterations x {j['kw']['cg_iters']} CG steps "
            f"on {len(j['args'][5])} observations in {j['wall'] * 1e3:.1f} ms = "
            f"{it / j['wall']:.2f} LM iterations/s")


def phase_selfcal(frames, poses, dev, smi: str, profile: bool) -> dict:
    """Phase E.  Self-calibration from a focal guess FOCAL_GUESS x the true
    one with ``recon.refine_intrinsics=("f",)``, on two scenes:
    (1) the 96 frames through ``build_map``.  Gates: 96/96 registered, ATE
    < 0.1 m, median reprojection < 1 px under the refined intrinsics, the
    joint LM's cost not raised; the refined focal printed, not gated: on
    this walk both packages refine it to within 1.8 % on the CPU over every
    seed tried, but the card's seed 0 draws the seed pair (6, 93), whose map
    leaves it at +1.8 to +4.7 % (S3 in ROADMAP.md).  Its reconstruct inputs
    go to .chip_scratch/selfcal_walk.npz for tests/selfcal_walk.py.
    (2) the reference test's recipe at the build's size: one arc of N_ARC
    cameras of ``smoke_scenes.two_cluster_world`` (+-35 deg around its
    cluster), K5 matching, tracks, ``reconstruct``.  Gates: the refined focal
    within 3 % of the true one (the reference test's gate), all cameras
    registered, ATE < 0.1, median reprojection < 1 px under the refined
    intrinsics.  Returns the launches of (1) and (2)."""
    import io

    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import match_images
    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels.features import N_WORDS, Features, Keypoints
    from sfmx_torch.recon import incremental, tracks
    from sfmx_torch.solvers import lm, umeyama
    from sfmx_torch.utils.logging import LOGGER
    from tests import smoke_scenes

    cfg = PipelineConfig()
    cfg = dataclasses.replace(cfg, recon=dataclasses.replace(cfg.recon,
                                                              refine_intrinsics=("f",)))
    guess = INTR.copy()
    guess[:2] *= FOCAL_GUESS
    _build.LAUNCHES.reset()
    with recorded(lm, "ba_solve_intrinsics") as joint:
        with recorded(incremental, "reconstruct") as rec:
            scene, _f, _tt, stats, wall, ate = run_build("self-calibration", frames, poses, cfg,
                                                         dev, intr=guess)
        launches = dict(_build.LAUNCHES.counts)
        # the walk's reconstruct inputs, for holding the reference's refined
        # focal beside the port's on the same table (tests/selfcal_walk.py)
        (kp_uv, kp_mask, tt, intr_in, cam_k), rkw = rec[0]["args"][:5], rec[0]["kw"]
        f_est = float(scene.intr[0, 0])
        pairs_w, counts_w = (np.asarray(a) for a in rkw["pair_counts"])
        np.savez(ROOT / ".chip_scratch" / "selfcal_walk.npz", kp_uv=kp_uv, kp_mask=kp_mask,
                 obs_cam=tt.obs_cam, obs_feat=tt.obs_feat, obs_track=tt.obs_track,
                 n_tracks=tt.n_tracks, intr=intr_in, cam_k=cam_k, pairs=pairs_w,
                 pair_counts=counts_w, focal=FOCAL, f_card=f_est)
        med = reproj_median_px(scene)
        n, n_reg = len(frames), int(scene.cam_alive.sum())
        c0, c1 = stats["intrinsics_ba_costs"]
        log(f"[selfcal] walk: focal guess {guess[0]:.1f} px ({FOCAL_GUESS:g} x {FOCAL:g}): "
            f"refined {f_est:.3f} px ({f_est / FOCAL - 1:+.5f}), {n_reg}/{n} registered, ATE "
            f"{ate:.4f} m, median reprojection under the refined intrinsics {med:.4f} px (gate < "
            f"{REPROJ_GATE_PX}); {joint_solve_log(joint[0])}, cost {c0:.6f} -> {c1:.6f}; build "
            f"{wall:.3f} s; launches {json.dumps(launches)}; on {smi}")
        assert n_reg == n, f"selfcal walk: {n_reg}/{n} registered"
        assert np.isfinite(ate) and ate < ATE_GATE_M, f"selfcal walk: ATE {ate} m"
        assert med < REPROJ_GATE_PX, f"selfcal walk: median reprojection {med} px"
        assert c1 <= c0, f"selfcal walk: the joint LM raised its cost {c0} -> {c1}"

        # (2) the arc: the reference test's recipe, where rotation fixes the focal
        uv, desc, mask, intr, centers, _fp = smoke_scenes.two_cluster_world(
            N_ARC, N_CLUSTER, N_SHARED, K=1024, seed=0)
        uv, desc, mask, centers = uv[:N_ARC], desc[:N_ARC], mask[:N_ARC], centers[:N_ARC]
        C, K = mask.shape
        z = torch.zeros((C, K), device=dev)
        feats = Features(Keypoints(torch.as_tensor(uv, device=dev), z.long(), z + 1, z, z,
                                   torch.as_tensor(mask, device=dev)),
                         torch.as_tensor(desc, device=dev),
                         torch.zeros((C, K, N_WORDS), dtype=torch.int32, device=dev))
        pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, C)], np.int32)
        aguess = intr.copy()
        aguess[:2] *= FOCAL_GUESS

        def build_arc():
            buf, old = io.StringIO(), LOGGER._stream
            LOGGER._stream = buf
            try:
                res = match_images(feats, pairs, cfg)
            finally:
                LOGGER._stream = old
            tt = tracks.build_tracks(pairs, res.idx.cpu().numpy(), res.valid.cpu().numpy(), C, K)
            return incremental.reconstruct(
                uv, mask, tt, aguess[None], np.zeros(C, np.int32), cfg.recon,
                pair_counts=(pairs, res.valid.sum(dim=1).cpu().numpy()), device=dev)

        before = dict(_build.LAUNCHES.counts)
        (ascene, astats), awall = synced(build_arc)
    after = dict(_build.LAUNCHES.counts)
    arc_launches = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    af = float(ascene.intr[0, 0])
    amed = reproj_median_px(ascene)
    aate = float(umeyama.ate_rmse(ascene.centers, torch.as_tensor(
        centers, dtype=torch.float32, device=dev), ascene.cam_alive)[0])
    an = int(ascene.cam_alive.sum())
    log(f"[selfcal] arc of {C} cameras around {N_CLUSTER} points: focal guess {aguess[0]:.1f} px "
        f"({FOCAL_GUESS:g} x {intr[0]:g}): refined {af:.3f} px ({af / intr[0] - 1:+.6f}; gate 3 %), "
        f"{an}/{C} registered, ATE {aate:.6f} (gate < {ATE_GATE_M}), median reprojection under "
        f"the refined intrinsics {amed:.4f} px; {joint_solve_log(joint[1])}, cost "
        f"{json.dumps(astats['intrinsics_ba_costs'])}; match, tracks, reconstruct {awall:.3f} s; "
        f"launches {json.dumps(arc_launches)}; on {smi}")
    assert abs(af / float(intr[0]) - 1.0) < 0.03, f"selfcal arc: focal {af}"
    assert an == C, f"selfcal arc: {an}/{C} registered"
    assert np.isfinite(aate) and aate < ATE_GATE_M, f"selfcal arc: ATE {aate}"
    assert amed < REPROJ_GATE_PX, f"selfcal arc: median reprojection {amed} px"
    if profile:
        j = joint[0]
        ms_d, by_name, _table = device_ms_per_run(
            lambda: lm.ba_solve_intrinsics(*j["args"], **j["kw"]), 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"[profile] joint intrinsics BA (walk): device {ms_d:.2f} ms of "
            f"{j['wall'] * 1e3:.1f} ms wall (busy {ms_d / (j['wall'] * 1e3):.3f}); "
            + "; ".join(f"{t:.3f} ms {k[:50]}" for k, t in top) + f"; on {smi}")
    return after


# ---------------------------------------------------------------------------
# The single-device rest: the CLI end to end, streaming extraction, oriented
# and SIFT extraction, determinism (phases 25-29)
# ---------------------------------------------------------------------------

CLI_ROOT = ROOT / ".chip_scratch" / "cli"
STREAM_CHUNK = 16                  # phase 26: decoded frames per chunk
ORIENT_BATCH, SIFT_XCHECK = 16, 4  # phases 27, 28: VGA frames checked card against CPU
# Card against CPU (phases 27-28): K1 differs from its plain version by up to
# 1e-5 and the card's blur from the CPU's by an ulp or two, which moves a few
# keypoints' NMS or subpixel fit; of those that agree (within 0.01 px and
# 1e-3 rad) a 1e-3 rad turn of a 20-sigma patch (up to 240 px across in
# octave 1) moves its corner samples by up to 0.12 px, a unit descriptor by
# up to ~1e-3 (1.06e-3 measured at B=16 VGA on an H100): hence 2e-3.
AGREE_SHARE, AGREE_PX, AGREE_RAD, AGREE_DESC = 0.95, 0.01, 1e-3, 2e-3
CLI_TIMING_KEYS = {"phase_s", "ba_total_s", "ba_iters_per_s", "ba_call_s",
                   "component_loop_s"}


def CLI_GEOMETRY() -> list[str]:
    """The CLI's image size and focal (f = 0.875 x 640 = FOCAL) as -D flags."""
    return ["-D", f"resize_to={W_IMG},{H_IMG}", "-D", f"focal_factor={FOCAL / W_IMG}"]


def run_cli(argv: list[str]):
    """``sfmx_torch.cli.main.main(argv)`` with its standard output and stage
    log captured: (the output, stage records by name, host wall s, the card
    synchronized on both sides)."""
    import io

    from sfmx_torch.cli.main import main as cli_main
    from sfmx_torch.utils.logging import LOGGER

    out, buf, old = io.StringIO(), io.StringIO(), LOGGER._stream
    LOGGER._stream = buf
    try:
        with contextlib.redirect_stdout(out):
            _, wall = synced(lambda: cli_main(argv))
    finally:
        LOGGER._stream = old
    stages = {}
    for r in map(json.loads, buf.getvalue().splitlines()):
        stages.setdefault(r["stage"], r)
    return out.getvalue(), stages, wall


def store_ate(path, eyes, dev) -> tuple[float, tuple]:
    """ATE (m) of a scene store's alive camera centers against the rendered
    eyes after a similarity alignment, and that similarity."""
    import torch

    from sfmx_torch.mapstore.scene import load_scene
    from sfmx_torch.solvers import umeyama

    scene = load_scene(path, dev)
    ate, sim = umeyama.ate_rmse(scene.centers, torch.as_tensor(
        np.asarray(eyes), dtype=torch.float32, device=dev), scene.cam_alive)
    return float(ate), sim


def stage_walls(stages: dict) -> str:
    return ", ".join(f"{k} {r['wall_s']:.3f} s" for k, r in stages.items())


def write_cli_frames(frames, tex) -> tuple[list, list, np.ndarray]:
    """The walk's frames as 8-bit PNG files under CLI_ROOT/walk and
    N_LOOP_QUERIES held-out frames (midway between the walk's poses) under
    CLI_ROOT/queries.  Returns (the frame files, the query files, the
    queries' true centers)."""
    from examples import room
    from sfmx_torch.run_configs import write_png_frames

    paths = write_png_frames(CLI_ROOT / "walk", frames)
    mids = room.walk_poses(N_BAND - 1)[1::2]
    qposes = [mids[i] for i in np.round(np.linspace(0, N_BUILD - 2, N_LOOP_QUERIES)).astype(int)]
    queries = write_png_frames(CLI_ROOT / "queries", render(tex, qposes))
    return paths, queries, np.stack([e for _R, _t, e in qposes])


def phase_cli(frames, poses, tex, dev, smi: str, ate18: float) -> tuple[dict, dict]:
    """Phase 25.  The CLI at full width (``PipelineConfig()`` defaults, 1024
    keypoints, VGA), every command through ``main([...]) --device cuda``,
    the 8-bit frames decoded by the ingest seam: build-map of the 96 frames
    (gates: 96/96, < 1 px, ATE < 0.1 m; stage walls), localize of
    N_LOOP_QUERIES held-out frames (median < 0.2 m, >= 12 localized),
    evaluate against a text file of the true centers (ATE < 0.1 m), export
    (vertices = alive points + 5 per alive camera), georeference on 4
    control cameras (control_rmse < 0.1), merge of two build-map stores
    (frames 0-59 and 36-95: ATE < 0.1 m over the 120 centers), and a
    bundle / unbundle round trip with byte-equal files.  Returns (the
    launches of the phase's commands, counted from 0, and the build's
    record)."""
    import filecmp
    import os
    import shutil

    import torch

    from sfmx_torch.kernels import _build
    from sfmx_torch.mapstore.scene import load_manifest
    from sfmx_torch.solvers import umeyama

    if CLI_ROOT.exists():
        shutil.rmtree(CLI_ROOT)
    walk = CLI_ROOT / "walk"
    paths, queries, q_eyes = write_cli_frames(frames, tex)
    eyes = np.stack([eye for _R, _t, eye in poses])
    dv = ["--device", str(dev)]
    focal = CLI_GEOMETRY()
    store = str(CLI_ROOT / "map")
    cmds = {}
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    out, stages, wall = run_cli(["build-map", str(walk), "-o", store, *focal, *dv])
    rec = json.loads(out.strip().splitlines()[-1])
    cmds["build-map"] = wall
    st = load_manifest(store)["extra"]["stats"]
    ate, sim = store_ate(store, eyes, dev)
    log(f"[cli] build-map of {len(paths)} frames in {wall:.3f} s: {json.dumps(rec)}; "
        f"stage walls {stage_walls(stages)}; median reprojection {st['final_med_px']:.4f} px, "
        f"ATE {ate:.4f} m (phase 18 on the float frames: {ate18:.4f}); seed pairs "
        f"{st.get('init_pairs')}; on {smi}")
    assert rec["registered"] == len(paths), f"cli build-map: {rec}"
    assert st["final_med_px"] < REPROJ_GATE_PX, f"cli build-map: {st['final_med_px']} px"
    assert np.isfinite(ate) and ate < ATE_GATE_M, f"cli build-map: ATE {ate}"

    out, _, wall = run_cli(["localize", store, str(CLI_ROOT / "queries"), *focal, *dv])
    cmds["localize"] = wall
    res = json.loads(out)
    centers = torch.as_tensor([r["center"] for r in res], dtype=torch.float32, device=dev)
    world = umeyama.apply_sim3(*sim, centers).cpu().numpy()
    errs = np.linalg.norm(world - q_eyes, axis=1)
    n_loc = sum(r["confidence"] > 0 for r in res)
    log(f"[cli] localize of {len(res)} held-out frames in {wall:.3f} s: center errors "
        f"median {np.median(errs):.4f} m (gate < {MEDIAN_GATE_M}), max {errs.max():.4f}; "
        f"{n_loc}/{len(res)} localized (gate >= {N_LOOP_MIN})")
    assert np.median(errs) < MEDIAN_GATE_M and n_loc >= N_LOOP_MIN, (errs, n_loc)

    ref_txt = CLI_ROOT / "centers.txt"
    np.savetxt(ref_txt, eyes)
    out, _, cmds["evaluate"] = run_cli(["evaluate", store, "--reference", str(ref_txt), *dv])
    report = json.loads(out)
    log(f"[cli] evaluate: {json.dumps(report)}")
    assert report["trajectory"]["ate_rmse"] < ATE_GATE_M, report
    assert report["scene"]["reproj_rmse_px"] < 2 * REPROJ_GATE_PX, report

    out, _, cmds["export"] = run_cli(["export", store, "-o", str(CLI_ROOT / "map.ply"), *dv])
    ply = json.loads(out)
    n_pts, n_cams = report["scene"]["n_points"], report["scene"]["n_cameras"]
    log(f"[cli] export: {json.dumps(ply)} ({n_pts} points + 5 x {n_cams} frustum vertices)")
    assert ply["vertices"] == n_pts + 5 * n_cams, ply

    ctrl = CLI_ROOT / "control.json"
    pick = np.round(np.linspace(0, len(eyes) - 1, 4)).astype(int)   # 4 control cameras
    ctrl.write_text(json.dumps([[int(i), *eyes[i].tolist()] for i in pick]))
    out, _, cmds["georeference"] = run_cli(["georeference", store, str(ctrl), "-o",
                                            str(CLI_ROOT / "map_geo"), *dv])
    geo = json.loads(out)
    log(f"[cli] georeference on 4 control cameras: {json.dumps(geo)}")
    assert geo["control_rmse"] < 0.1, geo

    sessions, s_eyes = [], []
    for i, (lo, hi) in enumerate(MERGE_SESSIONS):
        d = CLI_ROOT / f"session{i}"
        d.mkdir()
        for p in paths[lo:hi]:
            os.link(p, d / p.name)
        sessions.append(str(CLI_ROOT / f"session{i}_map"))
        out, _, cmds[f"build-map session {i}"] = run_cli(
            ["build-map", str(d), "-o", sessions[-1], *focal, *dv])
        assert json.loads(out.strip().splitlines()[-1])["registered"] == hi - lo, out
        s_eyes.append(eyes[lo:hi])
    merged = str(CLI_ROOT / "merged")
    out, _, cmds["merge"] = run_cli(["merge", *sessions, "-o", merged, *dv])
    mrec = json.loads(out)
    m_ate, _ = store_ate(merged, np.concatenate(s_eyes), dev)
    log(f"[cli] merge of sessions {MERGE_SESSIONS}: {mrec['n_cameras']} cameras, "
        f"{mrec['n_points']} points, edges {json.dumps(mrec['edges'])}, failed "
        f"{len(mrec['failed_edges'])}; ATE of the {mrec['n_cameras']} centers {m_ate:.4f} m "
        f"(gate < {ATE_GATE_M})")
    assert not mrec["failed_edges"] and np.isfinite(m_ate) and m_ate < ATE_GATE_M, mrec

    bundle = str(CLI_ROOT / "deploy.tar.gz")
    out, _, cmds["bundle"] = run_cli(["bundle", store, "-o", bundle, *dv])
    brec = json.loads(out)
    out, _, cmds["unbundle"] = run_cli(["unbundle", bundle, "-d", str(CLI_ROOT / "deployed"),
                                        *dv])
    urec = json.loads(out)
    got = Path(urec["maps"][0])
    same = [filecmp.dircmp(store + sfx, str(got) + sfx) for sfx in ("", ".lmap")]
    equal = all(not (c.diff_files or c.left_only or c.right_only or c.funny_files)
                and filecmp.cmpfiles(c.left, c.right, c.common_files, shallow=False)[1] == []
                for c in same)
    equal &= filecmp.cmp(store + ".feats.npz", str(got) + ".feats.npz", shallow=False)
    log(f"[cli] bundle {json.dumps(brec)}; unbundle {json.dumps(urec)}; files byte-equal "
        f"{equal}")
    assert brec["map_artifacts"] == 3 and equal, (brec, urec)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.counts.items() if v}
    log(f"[cli] command walls (s, the card synchronized) "
        f"{json.dumps({k: round(v, 3) for k, v in cmds.items()})}; launches "
        f"{json.dumps(launches)}")
    return launches, {"store": store, "stats": st, "ate": ate, "queries": queries,
                      "q_eyes": q_eyes}


def phase_streaming(frames, dev, smi: str) -> dict:
    """Phase 26.  ``extract_features_streaming`` of the 96 PNG frames in
    chunks of STREAM_CHUNK on the card against eager ``extract_features`` of
    the same decoded frames (bit for bit, else within K1's 1e-4 and why);
    the streaming wall beside the eager one (decode everything, then
    extract) three times in turn, and the device's busy share of the
    streaming wall (torch.profiler); then ``build-map --stream`` through the
    CLI (gate: 96/96).  Returns the launches of the streaming run and of
    that build, counted from 0."""
    import torch

    from sfmx_torch.cli import ingest
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features, extract_features_streaming
    from sfmx_torch.kernels import _build

    cfg = PipelineConfig()
    paths = ingest.list_images(CLI_ROOT / "walk")
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    (feats, sizes), _ = synced(lambda: extract_features_streaming(
        paths, cfg, dev, chunk=STREAM_CHUNK, resize_to=(W_IMG, H_IMG)))
    launches = {k: v for k, v in _build.LAUNCHES.counts.items() if v}
    ws = ingest.load_directory(CLI_ROOT / "walk", resize_to=(W_IMG, H_IMG))
    eager = extract_features(ws.images, cfg, dev)
    fields = ("uv", "level", "sigma", "angle", "response", "mask", "desc", "desc_bits")
    got = dict(zip(fields, (*feats.kp, feats.desc, feats.desc_bits)))
    ref = dict(zip(fields, (*eager.kp, eager.desc, eager.desc_bits)))
    diff = {k: float((got[k].double() - ref[k].double()).abs().max()) for k in fields}
    bit_equal = all(torch.equal(got[k], ref[k]) for k in fields)
    m = ref["mask"]
    mask_share = float((got["mask"] == m).double().mean())
    desc_err = float((got["desc"][m] - ref["desc"][m]).abs().max())

    def eager_run():
        return extract_features(ingest.load_directory(
            CLI_ROOT / "walk", resize_to=(W_IMG, H_IMG)).images, cfg, dev)

    def stream_run():
        return extract_features_streaming(paths, cfg, dev, chunk=STREAM_CHUNK,
                                          resize_to=(W_IMG, H_IMG))

    walls = {"eager": [], "streaming": []}
    for _ in range(3):
        walls["eager"].append(synced(eager_run)[1])
        walls["streaming"].append(synced(stream_run)[1])
    _ms, by, _t = device_ms_per_run(stream_run, reps=1)
    # the stage log's record_function range has a device-side span too
    dev_ms = sum(t for k, t in by.items() if k != "extract_stream")
    s_wall = float(np.median(walls["streaming"]))
    log(f"[stream] {len(paths)} frames in chunks of {STREAM_CHUNK}: bit-equal to eager "
        f"extraction {bit_equal}; largest field differences {json.dumps(diff)}; masks equal in "
        f"{mask_share:.5f} of the slots, descriptors of the eager valid slots within "
        f"{desc_err:.3g}; walls (s, decode included) eager "
        f"{[round(w, 3) for w in walls['eager']]}, streaming "
        f"{[round(w, 3) for w in walls['streaming']]}; streaming device time "
        f"{dev_ms:.2f} ms, busy {dev_ms / (s_wall * 1e3):.3f} of its median wall; launches "
        f"{json.dumps(launches)}; on {smi}")
    assert sizes.shape == (len(paths), 2) and feats.desc.shape[0] == len(paths)
    assert bit_equal or (mask_share == 1.0 and desc_err <= 1e-4), (diff, mask_share)
    ext = extraction_launches()
    n_chunks = -(-len(paths) // STREAM_CHUNK)
    check_launches("streaming extraction", launches, {k: v * n_chunks for k, v in ext.items()})

    _build.LAUNCHES.reset()
    out, stages, wall = run_cli(["build-map", str(CLI_ROOT / "walk"), "-o",
                                 str(CLI_ROOT / "map_stream"), "--stream", "--chunk",
                                 str(STREAM_CHUNK), *CLI_GEOMETRY(), "--device", str(dev)])
    b_launches = {k: v for k, v in _build.LAUNCHES.counts.items() if v}
    rec = json.loads(out.strip().splitlines()[-1])
    log(f"[stream] build-map --stream in {wall:.3f} s: {json.dumps(rec)}; stage walls "
        f"{stage_walls(stages)}; launches {json.dumps(b_launches)}")
    assert rec["registered"] == len(paths), rec
    add_launches(launches, b_launches)
    return launches


def agreeing_share(got, ref, tol_px: float = AGREE_PX, tol_rad: float = AGREE_RAD):
    """Per image, the share of the reference's valid keypoints that have a
    keypoint of ``got`` within tol_px whose angle is within tol_rad (mod
    2 pi); the smallest share and the largest descriptor difference over
    the agreeing keypoints."""
    import torch

    shares, worst = [], 0.0
    for b in range(ref.kp.mask.shape[0]):
        rm, gm = ref.kp.mask[b], got.kp.mask[b].cpu()
        d = torch.cdist(ref.kp.uv[b][rm].double(), got.kp.uv[b].cpu()[gm].double())
        dmin, j = d.min(dim=1)
        da = torch.remainder(ref.kp.angle[b][rm] - got.kp.angle[b].cpu()[gm][j] + np.pi,
                             2 * np.pi) - np.pi
        good = (dmin < tol_px) & (da.abs() < tol_rad)
        shares.append(float(good.double().mean()))
        dd = (ref.desc[b][rm] - got.desc[b].cpu()[gm][j]).abs().amax(dim=1)[good]
        worst = max(worst, float(dd.max()) if len(dd) else 0.0)
    return min(shares), worst


def phase_oriented(frames, dev, smi: str) -> dict:
    """Phase 27.  ``oriented=True`` extraction (K1/K2, then the gradient-
    centroid angle and the rotated-patch gathers in plain torch) of an
    ORIENT_BATCH-frame VGA batch at the cli's widths (1024 keypoints, 2
    octaves): on the card against the port on this machine's CPU
    (>= AGREE_SHARE of the CPU's keypoints within AGREE_PX px and AGREE_RAD
    rad, their descriptors within AGREE_DESC), device ms per batch beside
    the upright batch's (torch.profiler); then the reference test's
    rotation gates on the card: the 25-degree rotated pair at 160x160
    (tests/test_features.py).  Returns the oriented batch's launches."""
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels import features as F
    from sfmx_torch.kernels import matching
    from tests import smoke_scenes

    fc = PipelineConfig().features
    kw = dict(max_keypoints=fc.max_keypoints, threshold=fc.threshold, n_octaves=fc.n_octaves)
    imgs = torch.as_tensor(frames[:ORIENT_BATCH], dtype=torch.float32)
    gi = imgs.to(dev)
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    got, wall = synced(lambda: F.detect_and_describe(gi, oriented=True, **kw))
    launches = {k: v for k, v in _build.LAUNCHES.counts.items() if v}
    t0 = time.perf_counter()
    ref = F.detect_and_describe(imgs, oriented=True, **kw)
    cpu_s = time.perf_counter() - t0
    share, worst = agreeing_share(got, ref)
    ms_o, by_o, _ = device_ms_per_run(lambda: F.detect_and_describe(gi, oriented=True, **kw), 3)
    ms_u, _, _ = device_ms_per_run(lambda: F.detect_and_describe(gi, **kw), 3)
    top = sorted(by_o.items(), key=lambda kv: -kv[1])[:4]
    log(f"[oriented] B={ORIENT_BATCH} VGA, {kw}: card against the CPU: {share:.4f} of the "
        f"CPU's keypoints agree (gate >= {AGREE_SHARE}), descriptors within {worst:.3g} (gate "
        f"< {AGREE_DESC}); {int(ref.kp.mask.sum())} CPU keypoints; CPU {cpu_s:.2f} s; first "
        f"card call {wall * 1e3:.1f} ms; device time per batch {ms_o:.3f} ms oriented, "
        f"{ms_u:.3f} ms upright (torch.profiler, 3 batches; largest oriented ops "
        + ", ".join(f"{n[:40]} {t:.3f}" for n, t in top) + f"); launches {json.dumps(launches)}; "
        f"on {smi}")
    assert share >= AGREE_SHARE and worst < AGREE_DESC, (share, worst)
    ext = extraction_launches()
    check_launches("oriented extraction", launches, {**ext, "describe_upright": 0})

    pair, M = smoke_scenes.rotated_pair()
    f = F.detect_and_describe(torch.as_tensor(pair, device=dev), max_keypoints=200,
                              threshold=1e-7, oriented=True)
    m = f.kp.mask.cpu()
    n0, n1 = int(m[0].sum()), int(m[1].sum())
    uv0, uv1 = f.kp.uv[0].cpu().numpy(), f.kp.uv[1].cpu().numpy()
    proj = np.hstack([uv0[m[0]], np.ones((n0, 1))]) @ M.T
    H_, W_ = pair.shape[1:]
    inside = (proj[:, 0] > 12) & (proj[:, 0] < W_ - 12) & (proj[:, 1] > 12) & (proj[:, 1] < H_ - 12)
    dmin = np.linalg.norm(proj[inside][:, None] - uv1[m[1]][None], axis=2).min(axis=1)
    repeat = float((dmin < 3.0).mean())
    res = matching.match_float(f.desc[0], f.desc[1], f.kp.mask[0], f.kp.mask[1], ratio=0.85)
    idx, valid = res.idx.cpu().numpy(), res.valid.cpu().numpy()
    pall = np.hstack([uv0, np.ones((len(uv0), 1))]) @ M.T
    err = np.linalg.norm(pall[valid] - uv1[idx[valid]], axis=1)
    prec = float((err < 4.0).mean()) if len(err) else 0.0
    resh = matching.match_hamming(f.desc_bits[0], f.desc_bits[1], f.kp.mask[0], f.kp.mask[1],
                                  ratio=0.85)
    both = (resh.valid & res.valid).cpu().numpy()
    agree = float((resh.idx.cpu().numpy()[both] == idx[both]).mean()) if both.any() else 0.0
    log(f"[oriented] 25-degree rotated pair at 160x160 on the card: {n0}/{n1} keypoints (gate "
        f"> 30), repeatability {repeat:.3f} (gate > 0.5), {int(valid.sum())} float matches "
        f"(gate >= 15) of precision {prec:.3f} (gate > 0.7), binary agrees on {agree:.3f} of "
        f"{int(both.sum())} shared matches (gate > 0.8 where > 5)")
    assert n0 > 30 and n1 > 30 and repeat > 0.5 and valid.sum() >= 15 and prec > 0.7
    assert both.sum() <= 5 or agree > 0.8
    return launches


def phase_sift(frames, poses, dev, smi: str) -> dict:
    """Phase 28.  The SIFT extractor (plain torch on the card: the blur
    through cuDNN): SIFT_XCHECK VGA frames at the cli's widths
    (``extractor=sift``: threshold 0.015, 1024 keypoints, 2 octaves) on the
    card against this machine's CPU (as phase 27); tests/test_sift.py's
    gates at its sizes on the card (> 50 keypoints, > 30 coherent two-view
    matches, >= 5 of 6 registered with > 50 points, >= 8 good matches
    across a 4.4x scale change, the downscale in numpy); then the 96 frames
    through ``build_map`` with ``extractor=sift``: registered, px, ATE and
    stage walls printed, ungated.  Returns the launches of that build and
    of the 6-frame build, counted from 0."""
    import torch

    from examples import room
    from sfmx_torch.cli.config import load_config
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels import features as F
    from sfmx_torch.kernels import matching, sift
    from tests import smoke_scenes

    cfg = load_config(overrides=["features.extractor=sift"])
    imgs = frames[:SIFT_XCHECK]
    got, wall = synced(lambda: extract_features(imgs, cfg, dev))
    t0 = time.perf_counter()
    ref = extract_features(imgs, cfg, "cpu")
    cpu_s = time.perf_counter() - t0
    share, worst = agreeing_share(got, ref)
    ms, _, _ = device_ms_per_run(lambda: extract_features(imgs, cfg, dev), 3)
    log(f"[sift] B={SIFT_XCHECK} VGA, extractor=sift at the cli's widths: card against the "
        f"CPU: {share:.4f} agree (gate >= {AGREE_SHARE}), descriptors within {worst:.3g} "
        f"(gate < {AGREE_DESC}); {int(ref.kp.mask.sum())} CPU keypoints; CPU {cpu_s:.2f} s, "
        f"first card call {wall * 1e3:.1f} ms, device time per batch {ms:.3f} ms; on {smi}")
    assert share >= AGREE_SHARE and worst < AGREE_DESC, (share, worst)

    tex = room.RoomTexture(seed=3)
    views = smoke_scenes.render(tex, room.walk_poses(10)[:6], 320, 240, 280.0)
    f1 = sift.detect_and_describe_sift(torch.as_tensor(views[:1], device=dev), max_keypoints=256)
    n1 = int(f1.kp.mask.sum())
    f2 = sift.detect_and_describe_sift(torch.as_tensor(views[:2], device=dev), max_keypoints=384)
    m = matching.match_float(f2.desc[0], f2.desc[1], f2.kp.mask[0], f2.kp.mask[1], ratio=0.9)
    valid = m.valid.cpu().numpy()
    disp = f2.kp.uv[1].cpu().numpy()[m.idx.cpu().numpy()[valid]] - f2.kp.uv[0].cpu().numpy()[valid]
    coherent = float((np.linalg.norm(disp - np.median(disp, axis=0), axis=1) < 30.0).mean())
    c6 = load_config(overrides=["features.extractor=sift", "features.max_keypoints=384",
                                "match.ratio=0.9"])
    _build.LAUNCHES.reset()
    scene6, _f, _tt, st6, w6, _ = run_build("sift 6 views", views, room.walk_poses(10)[:6], c6,
                                            dev, intr=np.array([280.0, 280.0, 160.0, 120.0, 0, 0,
                                                                0], np.float32))
    launches = {k: v for k, v in _build.LAUNCHES.counts.items() if v}
    rng = np.random.default_rng(5)
    img = F.gaussian_blur(torch.as_tensor(rng.random((1, 240, 320)), dtype=torch.float32,
                                          device=dev), 3.0)[0].cpu().numpy()
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    small = smoke_scenes.resize_bilinear(img, (72, 54))
    g1 = sift.detect_and_describe_sift(torch.as_tensor(img[None], device=dev),
                                       max_keypoints=512, n_octaves=3)
    g2 = sift.detect_and_describe_sift(torch.as_tensor(small[None], device=dev),
                                       max_keypoints=512)
    res = matching.match_pairs_float_auto(torch.cat([g1.desc, g2.desc]),
                                          torch.cat([g1.kp.mask, g2.kp.mask]),
                                          np.asarray([[0, 1]], np.int32))
    idx, val = res.idx[0].cpu().numpy(), res.valid[0].cpu().numpy()
    err = np.linalg.norm(g1.kp.uv[0].cpu().numpy() / (320.0 / 72.0)
                         - g2.kp.uv[0].cpu().numpy()[idx], axis=1)
    n_good = int((val & (err < 3.0)).sum())
    log(f"[sift] tests/test_sift.py's gates on the card: {n1} keypoints (gate > 50); "
        f"{int(valid.sum())} two-view matches (gate > 30), {coherent:.3f} coherent (gate > 0.5); "
        f"6 views: {st6['n_registered']} registered (gate >= 5), {st6['n_points']} points "
        f"(gate > 50); {n_good} good matches across the 4.4x scale change (gate >= 8)")
    assert n1 > 50 and valid.sum() > 30 and coherent > 0.5, (n1, valid.sum(), coherent)
    assert st6["n_registered"] >= 5 and st6["n_points"] > 50, st6
    assert n_good >= 8, n_good

    cfg96 = load_config(overrides=["features.extractor=sift"])
    _build.LAUNCHES.reset()
    import io

    from sfmx_torch.utils.logging import LOGGER

    buf, old = io.StringIO(), LOGGER._stream
    LOGGER._stream = buf
    try:
        from sfmx_torch.cli.pipeline import build_map

        (scene, _f, _tt, stats), wall = synced(lambda: build_map(
            frames, INTR[None], np.zeros(len(frames), np.int32), cfg96, dev,
            generator=torch.Generator(device=dev).manual_seed(0)))
    finally:
        LOGGER._stream = old
    stages = {r["stage"]: r for r in map(json.loads, buf.getvalue().splitlines())}
    from sfmx_torch.solvers import umeyama

    ate = float(umeyama.ate_rmse(scene.centers, torch.as_tensor(
        np.stack([e for _R, _t, e in poses]), dtype=torch.float32, device=dev),
        scene.cam_alive)[0])
    add_launches(launches, {k: v for k, v in _build.LAUNCHES.counts.items() if v})
    log(f"[sift] {len(frames)} frames through build_map with extractor=sift in {wall:.3f} s "
        f"(ungated): {stats['n_registered']}/{len(frames)} registered, {stats['n_points']} "
        f"points, median reprojection {stats['final_med_px']} px, ATE {ate:.4f} m; stage walls "
        f"{stage_walls(stages)}; launches of both builds {json.dumps(launches)}; on {smi}")
    return launches


def phase_determinism(cli: dict, dev, smi: str) -> dict:
    """Phase 29.  build-map of the 96 frames a second time through the CLI
    with the same seed, beside phase 25's: whether ``stats`` (timings aside)
    and every scene array and feature array are bit-identical, and, where
    not, which differ and by how much and whether the seed pair moved; both
    builds held to the map-quality gates.  Returns the second build's
    launches, counted from 0."""
    import torch

    from sfmx_torch.kernels import _build
    from sfmx_torch.mapstore.scene import SCENE_FIELDS, load_manifest, load_scene_np

    store2 = str(CLI_ROOT / "map_again")
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    out, _, wall = run_cli(["build-map", str(CLI_ROOT / "walk"), "-o", store2,
                            *CLI_GEOMETRY(), "--device", str(dev)])
    launches = {k: v for k, v in _build.LAUNCHES.counts.items() if v}
    st1 = cli["stats"]
    st2 = load_manifest(store2)["extra"]["stats"]
    s1 = {k: v for k, v in st1.items() if k not in CLI_TIMING_KEYS}
    s2 = {k: v for k, v in st2.items() if k not in CLI_TIMING_KEYS}
    a, b = load_scene_np(cli["store"]), load_scene_np(store2)
    fa, fb = np.load(cli["store"] + ".feats.npz"), np.load(store2 + ".feats.npz")
    # where not equal: alive flags by the entries that flip, values over the
    # entries alive in both builds, the rest by their largest difference
    both = {"cam_R": a["cam_alive"] & b["cam_alive"], "cam_t": a["cam_alive"] & b["cam_alive"],
            "X": a["X_alive"] & b["X_alive"]}
    diffs = {}
    for name, x, y in ([(k, a[k], b[k]) for k in SCENE_FIELDS]
                       + [(f"feats.{k}", fa[k], fb[k]) for k in fa.files]):
        if x.shape != y.shape:
            diffs[name] = f"shape {x.shape} vs {y.shape}"
        elif np.array_equal(x, y):
            continue
        elif x.dtype == bool:
            diffs[name] = f"{int((x != y).sum())} of {x.size} flip"
        else:
            sel = both.get(name, np.ones(len(x), bool))
            diffs[name] = float(np.abs(x[sel].astype(np.float64)
                                       - y[sel].astype(np.float64)).max())
    stats_equal = s1 == s2
    ate2, _ = store_ate(store2, np.loadtxt(CLI_ROOT / "centers.txt"), dev)
    log(f"[determinism] build-map of the {N_BUILD} frames twice (phase 25's and one more in "
        f"{wall:.3f} s), the same seed: stats equal (timings aside) {stats_equal}"
        + ("" if stats_equal else "; differing stats "
           + json.dumps({k: [s1.get(k), s2.get(k)] for k in s1.keys() | s2.keys()
                         if s1.get(k) != s2.get(k)})[:600])
        + f"; every scene and feature array bit-identical {not diffs}"
        + (f"; differing arrays (largest difference over the entries alive in both) "
           f"{json.dumps(diffs)}" if diffs else "")
        + f"; seed pairs {st1.get('init_pairs')} and {st2.get('init_pairs')}; second build "
        f"{json.loads(out.strip().splitlines()[-1])}, median reprojection "
        f"{st2['final_med_px']:.4f} px, ATE {ate2:.4f} m; on {smi}")
    assert st2["n_registered"] == N_BUILD, st2["n_registered"]
    assert st2["final_med_px"] < REPROJ_GATE_PX and ate2 < ATE_GATE_M, (st2["final_med_px"], ate2)
    assert stats_equal and not diffs, "two builds with one seed differ"
    return launches


# ---------------------------------------------------------------------------
# Multi-device paths on one card (phases 30-33)
# ---------------------------------------------------------------------------

SHARD_SPLITS = (2, 4)          # phase 31: landmark shards of the map-scale map on cuda:0
# phases 32 and 38: config 4 (``sfmx_torch.run_configs``: its corridor problem,
# 8 LM iterations x 25 CG steps) and, beside it, the joint-intrinsics solve's
# iterations and the checkpointed solve's chunk
BLOCK_K_ITERS, BLOCK_CKPT_EVERY = 2, 4
BLOCK_RTOL = 0.05              # blocked vs single-device final cost (tests/test_torch_block_ba.py)


def phase_sharded(lmap, frames, dev, smi: str) -> tuple[dict, dict]:
    """Phase 31.  One B=32 VGA batch (its 32,768 query rows) against the
    map-scale map split into 2 and into 4 landmark shards on cuda:0: each
    shard's K4 (``sharded.local_top2``) and the merge in shard order
    (``sharded.merge_shards``) equal to the unsplit K4 in every field, and
    the poses (``sharded.pose_from_top2`` on the winners' positions from
    their shards) equal to ``localize_batch_streaming``'s with the same
    noise.  Returns (the launches of the split runs, counted from 0; K4's
    device ms per shard launch by split count)."""
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.kernels import _build
    from sfmx_torch.localize import sharded as sh
    from sfmx_torch.localize.localize import localize_batch_streaming
    from sfmx_torch.solvers.ransac import gumbel_noise

    cfg = PipelineConfig()
    lc = cfg.localize
    f = extract_features(frames[:SERVE_BATCH], cfg, dev)
    B, K, D = f.desc.shape
    q = torch.where(f.kp.mask[..., None], f.desc, 0.0).reshape(B * K, D)
    pool_of = lambda m: torch.where(m.lm_alive[:, None], m.lm_desc, 0.0)
    intr = torch.as_tensor(INTR, device=dev)
    g = gumbel_noise((B, lc.k_hypotheses, K), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(5))
    kw = dict(k_hypotheses=lc.k_hypotheses, px_thresh=lc.px_thresh, sim_thresh=lc.sim_thresh,
              min_inliers=lc.min_inliers)
    # the comparators, outside the counted runs: the unsplit K4, the streaming path
    ref = sh.local_top2(q, pool_of(lmap))
    st = localize_batch_streaming(lmap, f.desc, f.kp.uv, f.kp.mask, intr, gumbel=g, **kw)
    launches, ms = {}, {}
    for n in SHARD_SPLITS:
        shards = [sh.shard_localization_map(lmap, r, n, dev) for r in range(n)]
        pools = [pool_of(m) for m in shards]
        pl = shards[0].X.shape[0]
        Xs, alives = torch.stack([m.X for m in shards]), torch.stack([m.lm_alive for m in shards])

        def run():
            parts = [sh.local_top2(q, pool) for pool in pools]
            s1, i1, s2 = (torch.stack([pt[j] for pt in parts]) for j in range(3))
            s1g, ig, s2g = sh.merge_shards(s1, i1, s2, pl)
            own, row = ig // pl, ig % pl
            res = sh.pose_from_top2(s1g, s2g, Xs[own, row].reshape(B, K, 3),
                                    alives[own, row].reshape(B, K), f.kp.uv, f.kp.mask, intr,
                                    gumbel=g, **kw)
            return (s1g, ig, s2g), res

        torch.cuda.synchronize()
        _build.LAUNCHES.reset()
        t0 = time.perf_counter()
        top, res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in _build.LAUNCHES.counts.items() if v}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        fields = {name: bool(torch.equal(a, b.to(a.dtype)))
                  for name, a, b in zip(("s1", "i1", "s2"), top, ref)}
        dc = float(torch.linalg.vector_norm(res.center - st.center, dim=-1).max())
        same_inl = bool(torch.equal(res.n_inliers, st.n_inliers))
        per: dict = {}
        dev_ms, note = launch_device_ms(lambda: sh.local_top2(q, pools[0]), 5,
                                        keep=lambda k: "match_top2" in k or "merge_splits" in k,
                                        per=per)
        ms[n] = dev_ms
        P = lmap.X.shape[0]
        log(f"[sharded] B={B} ({B * K} query rows) against {P} landmarks in {n} shards of {pl} on "
            f"{dev}: {n} shard K4 calls + merge + pose in {wall * 1e3:.1f} ms; launches "
            f"{json.dumps(got)}; merged fields equal to the unsplit K4 {json.dumps(fields)}; "
            f"poses against localize_batch_streaming with the same noise: n_inliers equal "
            f"{same_inl}, centers max {dc:.2e} m apart; K4 device time per shard call "
            f"{dev_ms:.4f} ms ({note}); on {smi}")
        assert all(fields.values()), f"sharded K4 + merge differs from the unsplit K4: {fields}"
        assert same_inl and dc <= 1e-5, f"sharded poses differ from streaming: {dc}"
        assert got.get("match_top2", 0) >= n, got
    errs = torch.linalg.vector_norm(res.center.cpu() - torch.as_tensor(
        np.stack([e for _R, _t, e in serve_poses()[:B]]), dtype=torch.float32), dim=-1)
    log(f"[sharded] median center error {float(errs.median()):.4f} m over {B} queries")
    assert float(errs.median()) < MEDIAN_GATE_M, float(errs.median())
    return launches, ms


def phase_block_ba(dev, smi: str) -> None:
    """Phase 32.  Config 4's problem (2,048 cameras, 200,000 points, 798,720
    observations; 8 LM iterations x 25 CG steps) through ``ba_solve_blocked``
    on one NCCL rank beside the single-device ``ba_solve`` (planes path) on
    the same problem, final costs within BLOCK_RTOL; the joint-intrinsics
    block solve (k_iters iterations); and the checkpointed blocked solve
    stopped after its first chunk and resumed, bit-identical to the
    uninterrupted chunked one."""
    import tempfile

    import torch
    import torch.distributed as dist

    from sfmx_torch.dist import block_ba, mesh
    from sfmx_torch.dist.worlds import digest
    from sfmx_torch.run_configs import CONFIG4, config4_problem
    from sfmx_torch.solvers import lm

    prob = config4_problem(np.random.default_rng(1))
    C, P, O = prob[2].shape[0], prob[4].shape[0], prob[5].shape[0]
    log(f"[block BA] config 4's problem (sfmx_torch.run_configs.config4_problem): digest "
        f"{digest(*prob)}")
    it, cg = CONFIG4["iters"], CONFIG4["cg_iters"]
    (ROOT / ".chip_scratch").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / ".chip_scratch")
    mesh.init_group("nccl", 0, 1, f"file://{tmp}/store", timeout=300, device=dev)
    try:
        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        T = [torch.as_tensor(a, device=dev) for a in prob]
        (_, _, _, costs_p), wall_p = timed(lambda: lm.ba_solve(*T, iters=it, cg_iters=cg))
        costs_p = costs_p.cpu().numpy()
        (_, _, _, costs_b, stats), wall_b = timed(
            lambda: block_ba.ba_solve_blocked(*prob, device=dev, iters=it, cg_iters=cg))
        rel = abs(float(costs_b[-1]) - float(costs_p[-1])) / float(costs_p[-1])
        log(f"[block BA] config 4: C={C} P={P} O={O}, {it} LM iterations x {cg} CG steps on one "
            f"NCCL rank: ba_solve_blocked {it / wall_b:.2f} LM iterations/s ({wall_b:.3f} s), "
            f"cost {float(costs_b[0]):.4f} -> {float(costs_b[-1]):.6f}; single-device planes "
            f"ba_solve {it / wall_p:.2f}/s ({wall_p:.3f} s) -> {float(costs_p[-1]):.6f}; "
            f"relative difference {rel:.2e} (gate {BLOCK_RTOL}); layout {json.dumps(stats)}; "
            f"on {smi}")
        # config 4 starts at the truth with 0.5 px of noise: the cost falls a little
        assert np.isfinite(costs_b).all() and costs_b[-1] <= costs_b[0], costs_b
        assert rel <= BLOCK_RTOL, f"blocked and planes costs differ by {rel}"

        (_, _, _, intr_k, costs_k, _), wall_k = timed(lambda: block_ba.ba_solve_blocked_intrinsics(
            *prob, device=dev, params=("f",), iters=BLOCK_K_ITERS, cg_iters=cg))
        log(f"[block BA] joint intrinsics (f), {BLOCK_K_ITERS} LM iterations in "
            f"{wall_k:.3f} s: cost {float(costs_k[0]):.4f} -> {float(costs_k[-1]):.6f}, focal "
            f"{float(intr_k[0, 0]):.3f} (truth 500)")
        assert np.isfinite(costs_k).all() and costs_k[-1] <= costs_k[0], costs_k
        assert abs(float(intr_k[0, 0]) - 500.0) < 5.0, float(intr_k[0, 0])

        ck = dict(device=dev, cg_iters=cg, ckpt_every=BLOCK_CKPT_EVERY)
        (Ra, ta, Xa, ca, _), wall_a = timed(lambda: block_ba.ba_solve_blocked(
            *prob, iters=it, ckpt_path=f"{tmp}/a.ckpt.npz", **ck))
        block_ba.ba_solve_blocked(*prob, iters=BLOCK_CKPT_EVERY,
                                  ckpt_path=f"{tmp}/b.ckpt.npz", **ck)
        Rb, tb, Xb, cb, _ = block_ba.ba_solve_blocked(*prob, iters=it,
                                                      ckpt_path=f"{tmp}/b.ckpt.npz", **ck)
        same = all(torch.equal(x, y) for x, y in ((Ra, Rb), (ta, tb), (Xa, Xb))) \
            and ca[-1] == cb[-1]
        log(f"[block BA] checkpointed every {BLOCK_CKPT_EVERY} ({wall_a:.3f} s, costs "
            f"{len(ca)}); stopped after its first chunk and resumed ({len(cb)} costs): "
            f"bit-identical to the uninterrupted run {same}; uninterrupted unchunked final cost "
            f"{float(costs_b[-1]):.6f}, chunked {float(ca[-1]):.6f}")
        assert same and len(ca) == it + 1 and len(cb) == it - BLOCK_CKPT_EVERY + 1
    finally:
        dist.destroy_process_group()


# phase 41: the kernels each bench function must launch (counted from 0 for it)
BENCH_NEEDS = {
    "accuracy_tripwire": ("match_top2",),
    "tpu_frames_per_s": ("diffuse_segment", "response_levels", "describe_upright"),
    "extract_stream_fps": ("diffuse_segment", "response_levels", "describe_upright"),
    "map_build_fps": ("diffuse_segment", "response_levels", "describe_upright",
                      "match_pairs_fused"),
    "matching_throughput": ("match_pairs_fused",),
    "matching_throughput_band": ("match_pairs_fused",),
    "ba_throughput": ("schur_cross_matvec", "ba_assemble_fused", "ba_cost_fused"),
    "streaming_localize_fps": ("match_top2",),
}
BENCH_RATES = ("value", "compile_s", "peak_bf16_tflops", "hbm_gbps", "matching_pairs_per_s",
               "matching_mfu", "matching_band_pairs_per_s", "matching_band_mfu",
               "ba_lm_iters_per_s", "ba_hbm_roofline_frac", "streaming_localize_fps",
               "tracking_fps", "geometric_verify_pairs_per_s", "extract_fps", "serving_p95_ms",
               "map_build_fps")


def phase_bench(dev, smi: str) -> dict:
    """Phase 41.  ``sfmx_torch.bench.main`` (the port of bench.py) in this
    process on the card: its tripwire, every rate finite and > 0, the map
    build's registration gate (it raises below 90 %), the kernels each
    function must launch; then K4 at the streaming bench's 8,192 query rows
    x 100,352 landmarks and K5 at the matching bench's 512 random pairs
    (K = 512) against their plain versions on the bench's own inputs, with
    the tolerances of phases 9 and 14.  Returns the bench's launches, summed
    over its functions."""
    import torch
    import torch.nn.functional as TF

    from sfmx_torch import bench
    from sfmx_torch.core.masking import round_up
    from sfmx_torch.kernels import match as mt
    from sfmx_torch.kernels.matching import match_pairs_float
    from sfmx_torch.kernels.pairs import match_pairs_fused
    from tests.smoke_scenes import pair_near_ties

    t0 = time.perf_counter()
    line, launches = bench.main(dev)
    wall = time.perf_counter() - t0
    log(f"bench {json.dumps(line)}")
    log(f"[bench] {wall:.1f} s in all; launches per function {json.dumps(launches)}; on {smi}")
    bad = [k for k in BENCH_RATES if not (np.isfinite(line[k]) and line[k] > 0)]
    assert not bad, f"bench: rates not finite and positive: {bad}"
    assert line["device"]["count"] == torch.cuda.device_count(), line["device"]
    for fn, need in BENCH_NEEDS.items():
        got = launches[fn]
        assert all(got.get(k, 0) > 0 for k in need), f"bench {fn}: launches {got}, needs {need}"

    # K4 on the streaming bench's inputs, padded and masked as the wrapper does
    lmap, q_desc, _uv, q_mask = bench.streaming_inputs(dev)
    a = torch.where(q_mask.reshape(-1)[:, None], q_desc.reshape(-1, q_desc.shape[-1]), 0.0)
    a = TF.pad(a, (0, 0, 0, round_up(a.shape[0], 256) - a.shape[0]))
    b = torch.where(lmap.lm_alive[:, None], lmap.lm_desc, 0.0)
    b = TF.pad(b, (0, 0, 0, round_up(b.shape[0], 2048) - b.shape[0]))
    got, ref = mt.match_top2(a, b), mt.match_top2_plain(a, b)
    torch.cuda.synchronize()
    tol = KERNELS["match_top2"][2]
    err = max(float((got[0] - ref[0]).abs().max()), float((got[2] - ref[2]).abs().max()))
    clear = (ref[0] - ref[2]) > tol
    n_bad = int((got[1] != ref[1])[clear].sum())
    log(f"[bench K4] match_top2 {tuple(a.shape)} x {tuple(b.shape)}, "
        f"{mt.split_plan(a.shape[0], b.shape[0])[0]} split(s): max_abs_err {err:.3e} (tol "
        f"{tol:.0e}); index mismatches {n_bad} outside near-ties ({int(clear.sum())} rows), "
        f"{int((got[1] != ref[1])[~clear].sum())} among {int((~clear).sum())} near-tie rows")
    assert err <= tol and n_bad == 0, "K4 disagrees with its plain version at bench.py's inputs"

    # K5 on the matching bench's inputs (match_pairs_float_auto's ratio, 0.8)
    descs, masks, pairs = bench.matching_inputs(dev)
    near = pair_near_ties(descs, masks, pairs.cpu().numpy(), 0.8, NEAR_TIE)
    check_matcher(f"bench K5 {len(pairs)} pairs K={descs.shape[1]}",
                  match_pairs_fused(descs, masks, pairs), match_pairs_float(descs, masks, pairs),
                  near)
    total = {}
    for got in launches.values():
        add_launches(total, got)
    return total


# phase 42: the evaluation configs (sfmx_torch.run_configs) in this process.
# Frame counts are the README's cut to fit the run (widths never): 2+ at 128
# room frames (README: 512), 5-serve at 48 frames a session (128), 4-build at
# 256 corridor frames on one rank (1,024 on four cards)
CONFIGS_SCALE_FRAMES, CONFIGS_SERVE_FPS, CONFIGS_BUILD_FRAMES = 128, 48, 256
BA_KERNELS = ("schur_cross_matvec", "ba_assemble_fused", "ba_cost_fused")


def config_run(tag: str, fn, dev, smi: str, *args, **kw):
    """``fn(*args, **kw)`` with this process's launches counted from 0 and
    every ``reconstruct`` in it watched; logs its JSON line with ``device``
    added.  Returns (the line, the launches, every spawned rank's digest
    and launches, whether a reconstruction here took the dense BA path)."""
    import torch

    from sfmx_torch.bench import device_info
    from sfmx_torch.kernels import _build
    from sfmx_torch.recon import incremental

    dense_calls = []
    orig = incremental.reconstruct

    def watched(*a, **k):
        scene, stats = orig(*a, **k)
        dense_calls.append(stats["ba_calls"]["dense"])
        return scene, stats

    incremental.reconstruct = watched
    try:
        torch.cuda.synchronize()
        _build.LAUNCHES.reset()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        incremental.reconstruct = orig
    launches = {k: v for k, v in _build.LAUNCHES.counts.items() if v}
    line, ranks = out if isinstance(out, tuple) else (out, [])
    line["device"] = device_info(dev)
    dense = any(n > 0 for n in dense_calls)
    log(f"config {json.dumps(line)}")
    log(f"[configs] {tag}: {wall:.1f} s; launches {json.dumps(launches)}"
        + (f"; ranks' launches {json.dumps([r['launches'] for r in ranks])}" if ranks else "")
        + f"; dense BA calls per reconstruction {dense_calls}; on {smi}")
    return line, launches, ranks, dense


def check_config(tag: str, launches: dict, dense: bool, need) -> None:
    """``need`` launched, and K6-K8 exactly where a build took the dense path."""
    assert all(launches.get(k, 0) > 0 for k in need), f"{tag}: launches {launches}, needs {need}"
    ba = [launches.get(k, 0) > 0 for k in BA_KERNELS]
    assert all(ba) if dense else not any(ba), f"{tag}: dense {dense}, launches {launches}"


def phase_configs(dev, smi: str) -> dict:
    """Phase 42.  The evaluation configs (``sfmx_torch.run_configs``, the port
    of bench/run_configs.py) on the card, each line logged with the card:
    1 (the demo's PASS), 2 (32 frames, ATE < 0.1 m), 3 (ba-512's config-3
    problem on the planes path), 4 (the corridor's block BA, one NCCL rank),
    5 (three synthetic sessions merged, ATE < 0.1 m), 2+ at
    CONFIGS_SCALE_FRAMES room frames, 5-serve at CONFIGS_SERVE_FPS frames a
    session (4 shards on cuda:0, its queries over HTTP) and 4-build at
    CONFIGS_BUILD_FRAMES corridor frames (one NCCL rank); 2+ and 4-build
    write PNG frame files in a temporary directory.  Gates:
    every ``pass`` the reference computes; each config's launches counted
    from 0: K1-K3 and K5 in the builds, the segment sum in configs 3, 4,
    5, 5-serve (the merges' planes BA) and 4-build's ranks, K6-K8 exactly
    where a build took the dense path.  Returns the launches, summed over
    the configs and their ranks."""
    import tempfile

    from sfmx_torch import run_configs as rc

    ext = ("diffuse_segment", "response_levels", "describe_upright")
    t0 = time.perf_counter()
    total: dict = {}

    line, got, _, dense = config_run("config 1", rc.config1, dev, smi, dev)
    assert line["pass"], "config 1: the demo failed"
    check_config("config 1", got, dense, ext + ("match_pairs_fused",))
    add_launches(total, got)

    line, got, _, dense = config_run("config 2", rc.config2, dev, smi, dev)
    assert line["ate_m"] < ATE_GATE_M, line
    check_config("config 2", got, dense, ext + ("match_pairs_fused",))
    add_launches(total, got)

    line, got, _, _ = config_run("config 3", rc.config3, dev, smi, dev)
    assert np.isfinite(line["final_cost"]) and line["lm_iters_per_s"] > 0, line
    check_config("config 3", got, False, ("segment_sum",))
    add_launches(total, got)

    ranks_on = "cuda" if dev.type == "cuda" else str(dev)     # one NCCL rank on a card
    line, got, ranks, _ = config_run("config 4", rc.config4, dev, smi, ranks_on, world_size=1)
    assert np.isfinite(line["final_cost"]) and line["n_blocks"] == 1, line
    check_config("config 4 rank", ranks[0]["launches"], False, ("segment_sum",))
    add_launches(total, ranks[0]["launches"])

    line, got, _, dense = config_run("config 5", rc.config5, dev, smi, dev)
    assert line["ate_m"] < ATE_GATE_M, line
    check_config("config 5", got, dense, ("match_pairs_fused", "segment_sum"))
    add_launches(total, got)

    with tempfile.TemporaryDirectory(prefix="sfmx_c2_") as root:
        line, got, _, dense = config_run(f"config 2+ ({CONFIGS_SCALE_FRAMES} frames)",
                                         rc.config2_scale, dev, smi, dev, root,
                                         frames=CONFIGS_SCALE_FRAMES)
    assert line["pass"], "config 2+ failed its gates"
    check_config("config 2+", got, dense, ext + ("match_pairs_fused",))
    add_launches(total, got)

    line, got, _, dense = config_run(f"config 5-serve ({CONFIGS_SERVE_FPS} frames a session)",
                                     rc.config5_serve, dev, smi, dev, fps=CONFIGS_SERVE_FPS)
    assert line["pass"], "config 5-serve failed its gates"
    check_config("config 5-serve", got, dense, ext + ("match_pairs_fused", "segment_sum"))
    add_launches(total, got)

    with tempfile.TemporaryDirectory(prefix="sfmx_c4b_") as root:
        line, got, ranks, dense = config_run(
            f"config 4-build ({CONFIGS_BUILD_FRAMES} corridor frames)", rc.config4_build, dev,
            smi, ranks_on, root, frames=CONFIGS_BUILD_FRAMES, scene="corridor", world_size=1)
    assert line["pass"], "config 4-build failed its gates"
    check_config("config 4-build", got, dense, ext + ("match_pairs_fused",))
    check_config("config 4-build rank", ranks[0]["launches"], False, ("segment_sum",))
    add_launches(total, got)
    add_launches(total, ranks[0]["launches"])
    log(f"[configs] phase 42 in {time.perf_counter() - t0:.1f} s; launches {json.dumps(total)}")
    return total


def phase_dryrun(dev, smi: str) -> dict:
    """Phase 33.  ``sfmx_torch.dist.dryrun`` (every multi-device path once:
    block BA, joint-intrinsics block BA, the observation-sharded step,
    data-parallel extraction + matching, map-sharded localization) in a
    spawned world of one NCCL rank on cuda:0, then of two gloo ranks sharing
    cuda:0 (this card's gloo takes CUDA tensors for the collectives the port
    uses: ``chip_experiments/f10_sites.py``).  Returns the NCCL run's
    launches (rank 0's, counted from 0)."""
    from sfmx_torch.dist import dryrun, mesh

    out = {}
    for tag, n, kw in (("nccl", 1, dict(device="cuda")),
                       ("gloo on cuda:0", 2, dict(device="cuda:0", backend="gloo"))):
        path = ROOT / ".chip_scratch" / f"dryrun_{n}.json"
        t0 = time.perf_counter()
        mesh.spawn(dryrun.dryrun, n, str(path), timeout=120, join_timeout=600, **kw)
        res = json.loads(path.read_text())
        log(f"[dryrun] {n} {tag} rank(s): {time.perf_counter() - t0:.1f} s (processes included); "
            f"block BA costs {res['block_ba']['costs']}, joint {res['block_ba_k']['costs']} "
            f"(focal {res['block_ba_k']['focal']:.3f}), obs-sharded {res['obs_ba']['costs']}, "
            f"DP {json.dumps(res['dp'])}, map-sharded t finite; rank 0 launches "
            f"{json.dumps(res['launches'])}; on {smi}")
        out[tag] = res
    return out["nccl"]["launches"]


# ---------------------------------------------------------------------------
# Deployments started as processes (phases 44-48): ``serve`` as its own
# process (44; 45 with four shards on four cards), and on four cards the
# harness's 5-serve (46) and config 4 (47), and ranks started apart (48)
# ---------------------------------------------------------------------------

SERVE_PROC_BURSTS, SERVE_PROC_CONCURRENT = 4, 16   # phases 44-45: bursts of concurrent POSTs
SERVE_PROC_START_S = 300        # the server's imports, map load and warm-up
SERVE_PROC_STOP_S = 30          # SIGINT to exit
SERVE_PROC_REQUEST_S = 120      # one request's answer
# A served answer against the in-process service's for the same image: the
# two draw their RANSAC noise from one seed but in batches the arrivals
# decide, so a query's hypotheses differ; after the Gauss-Newton refine on
# its inliers a localized query's center moves by millimetres.  5 cm is a
# quarter of the query gate (MEDIAN_GATE_M); both answers of a query must
# agree on whether it localized, but for SERVE_PROC_FLIPS of them (a query
# at the inlier gate localizes under one draw and not another).
SERVE_PROC_TOL_M = 0.05
SERVE_PROC_FLIPS = 0.1


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def json_lines(path) -> list[dict]:
    out = []
    for line in Path(path).read_text().splitlines():
        with contextlib.suppress(ValueError):
            rec = json.loads(line)
            if isinstance(rec, dict):
                out.append(rec)
    return out


def get_json(url: str, timeout: float = 5.0) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


class Sampler:
    """Each card's ``utilization.gpu`` (nvidia-smi: the share of its sample
    period in which a kernel ran), sampled in a thread while the block runs;
    ``share`` is each card's mean over the samples."""

    def __init__(self, period_s: float = 0.1):
        import threading

        self.period_s, self.samples, self._stop = period_s, [], threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._error = None

    def _run(self):
        try:
            while not self._stop.is_set():
                out = subprocess.run(["nvidia-smi", "--query-gpu=index,utilization.gpu",
                                      "--format=csv,noheader,nounits"], capture_output=True,
                                     text=True, timeout=10, check=True)
                self.samples.append({int(i): float(u) / 100 for i, u in
                                     (ln.split(",") for ln in out.stdout.strip().splitlines())})
                self._stop.wait(self.period_s)
        except Exception as e:          # raised again in the caller's thread
            self._error = e

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        if self._error is not None and exc[0] is None:
            raise self._error

    def share(self) -> dict:
        cards = sorted({k for s in self.samples for k in s})
        return {f"cuda:{c}": float(np.mean([s[c] for s in self.samples if c in s]))
                for c in cards}


def start_server(argv: list[str], tag: str, port: int, map_id: str):
    """``python -m sfmx_torch.cli.main serve ...`` as its own process, its
    output in files under CLI_ROOT; waits until GET /maps lists ``map_id``.
    Returns (the process, its stdout path, its stderr path, seconds to
    ready).  Raises (after killing it) if it exits or misses
    SERVE_PROC_START_S."""
    import os

    CLI_ROOT.mkdir(parents=True, exist_ok=True)
    out_p, err_p = CLI_ROOT / f"{tag}.out", CLI_ROOT / f"{tag}.err"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    with open(out_p, "w") as fo, open(err_p, "w") as fe:
        proc = subprocess.Popen([sys.executable, "-m", "sfmx_torch.cli.main", "serve", *argv],
                                cwd=ROOT, env=env, stdout=fo, stderr=fe)
    try:
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"{tag}: the server exited {proc.returncode} before it "
                                   f"answered:\n{err_p.read_text()[-4000:]}")
            with contextlib.suppress(OSError, ValueError):
                if map_id in get_json(f"http://127.0.0.1:{port}/maps", 2.0)["maps"]:
                    return proc, out_p, err_p, time.perf_counter() - t0
            if time.perf_counter() - t0 > SERVE_PROC_START_S:
                raise TimeoutError(f"{tag}: no answer on port {port} in {SERVE_PROC_START_S} s")
            time.sleep(0.5)
    except BaseException:
        proc.kill()
        proc.wait()
        raise


def stop_server(proc, tag: str, err_p) -> tuple[int, float]:
    """SIGINT, then wait SERVE_PROC_STOP_S for its exit; returns (exit code,
    seconds).  Past the wait the process is killed and this raises."""
    import signal

    t0 = time.perf_counter()
    proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(timeout=SERVE_PROC_STOP_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise TimeoutError(f"{tag}: still running {SERVE_PROC_STOP_S} s after SIGINT:\n"
                           f"{Path(err_p).read_text()[-4000:]}")
    return rc, time.perf_counter() - t0


def phase_serve_process(store: str, queries: list, q_eyes, map_eyes, dev, smi: str,
                        shards: int = 1, share: bool = False,
                        geometry: list[str] | None = None) -> tuple[dict, dict]:
    """Phase 44 (45: ``shards`` 4, one a card).  The README's deployment:
    ``python -m sfmx_torch.cli.main serve --map demo=<store> --port P
    [--shards 4]`` started as its own process on the map phase 25's
    build-map wrote, ``queries`` (PNG files of held-out frames) POSTed over
    127.0.0.1 in SERVE_PROC_BURSTS bursts of SERVE_PROC_CONCURRENT
    concurrent requests, /maps and /stats read, then SIGINT.  Gates: the
    server ready within SERVE_PROC_START_S, every answer 200, phase 10's
    (median center error < 0.2 m after the map's similarity to the truth,
    >= 75 % localized), /stats counting every request in fewer batches,
    each answer within SERVE_PROC_TOL_M of the in-process service's
    (``make_service`` on the same store, the same bursts) with at most
    SERVE_PROC_FLIPS of the queries localized by one and not the other,
    the server's K1-K3 launches during the traffic (its shutdown line less
    its loaded line) > 0, exit code 0 within SERVE_PROC_STOP_S of SIGINT,
    and the shards on cuda:0..3 (phase 45; ``share``: the one-card
    rehearsal, all on cuda:0).  Each card's busy share over the traffic is
    sampled from nvidia-smi.  Returns (the traffic's launches, the phase's
    numbers)."""
    import asyncio
    import base64

    import aiohttp
    import torch

    from sfmx_torch.cli.config import load_config
    from sfmx_torch.cli.main import make_service
    from sfmx_torch.serve.server import decode_image_payload
    from sfmx_torch.solvers import umeyama

    geometry = CLI_GEOMETRY() if geometry is None else geometry
    tag = "serve-process" if shards == 1 else f"serve-process-{shards}"
    cfg = load_config(None, geometry[1::2])
    pngs = [Path(q).read_bytes() for q in queries][:SERVE_PROC_CONCURRENT]
    payloads = [base64.b64encode(b).decode() for b in pngs]
    q_eyes = np.asarray(q_eyes)[:len(pngs)]
    port = free_port()
    argv = ["--map", f"demo={store}", "--port", str(port), *geometry, "--device", dev.type]
    if shards > 1:
        argv += ["--shards", str(shards)]
    proc, out_p, err_p, ready_s = start_server(argv, tag, port, "demo")
    try:
        loaded = next(r for r in json_lines(out_p) if r.get("serve") == "loaded")
        base = f"http://127.0.0.1:{port}"

        sampler = Sampler() if dev.type == "cuda" else contextlib.nullcontext()

        async def traffic():
            timeout = aiohttp.ClientTimeout(total=SERVE_PROC_REQUEST_S)
            async with aiohttp.ClientSession(timeout=timeout) as session:
                async def post(i):
                    async with session.post(f"{base}/localize",
                                            json={"map_id": "demo", "image": payloads[i]}) as r:
                        return r.status, await r.json()
                outs, lat, walls = [], [], []
                for _ in range(SERVE_PROC_BURSTS):
                    t0 = time.perf_counter()

                    async def one(i):
                        t1 = time.perf_counter()
                        o = await post(i)
                        lat.append((time.perf_counter() - t1) * 1e3)
                        return o
                    outs += await asyncio.gather(*[one(i) for i in range(len(payloads))])
                    walls.append(time.perf_counter() - t0)
                return outs, lat, walls

        with sampler:
            answers, lat, walls = asyncio.run(traffic())
        maps = get_json(f"{base}/maps")
        stats = get_json(f"{base}/stats")
    finally:
        if proc.poll() is None:
            rc, stop_s = stop_server(proc, tag, err_p)
        else:
            rc, stop_s = proc.returncode, 0.0
    stopped = [r for r in json_lines(out_p) if r.get("serve") == "stopped"]
    assert rc == 0 and stopped, (f"{tag}: exit code {rc}, shutdown line {bool(stopped)}:\n"
                                 f"{err_p.read_text()[-4000:]}")
    launches = {k: v - loaded["launches"].get(k, 0) for k, v in stopped[0]["launches"].items()
                if v - loaded["launches"].get(k, 0)}
    assert all(st == 200 for st, _ in answers), [st for st, _ in answers]
    outs = [o for _, o in answers]

    # the same bursts through the in-process service on the same store
    svc = make_service([f"demo={store}"], cfg, dev, shards=shards)
    imgs = [decode_image_payload(b, resize_to=cfg.resize_to) for b in pngs]

    async def in_process():
        await svc.start()
        try:
            res = []
            for _ in range(SERVE_PROC_BURSTS):
                res += await asyncio.gather(*[svc.localize("demo", image=im) for im in imgs])
            return res
        finally:
            await svc.stop()

    local = asyncio.run(in_process())
    _ate, sim = store_ate(store, map_eyes, dev)
    world = lambda os_: umeyama.apply_sim3(*sim, torch.as_tensor(
        [o["center"] for o in os_], dtype=torch.float32, device=dev)).cpu().numpy()
    eyes = np.tile(q_eyes, (SERVE_PROC_BURSTS, 1))
    errs = np.linalg.norm(world(outs) - eyes, axis=1)
    min_inl = cfg.localize.min_inliers
    loc = np.array([o["n_inliers"] >= min_inl for o in outs])
    loc_in = np.array([o["n_inliers"] >= min_inl for o in local])
    both = loc & loc_in
    diff = np.linalg.norm(world(outs) - world(local), axis=1)
    flips = int((loc != loc_in).sum())
    n = len(outs)
    placement = loaded["maps"]["demo"]
    numbers = {"ready_s": ready_s, "stop_s": stop_s, "requests_per_s": n / sum(walls),
               "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
               "p99_ms": float(np.percentile(lat, 99)), "server_stats": stats,
               "median_err_m": float(np.median(errs)), "localized": float(loc.mean()),
               "max_diff_m": float(diff[both].max()) if both.any() else None, "flips": flips,
               "placement": placement}
    if dev.type == "cuda":
        numbers["busy_share"] = sampler.share()
    log(f"[{tag}] serve {' '.join(argv)}: ready in {ready_s:.1f} s, shards "
        f"{json.dumps(placement)}; /maps {json.dumps(maps)}; {SERVE_PROC_BURSTS} bursts of "
        f"{len(payloads)} concurrent PNG POSTs over 127.0.0.1: burst walls "
        f"{', '.join(f'{w:.3f}' for w in walls)} s, {numbers['requests_per_s']:.2f} requests/s, "
        f"client latency p50 {numbers['p50_ms']:.1f} ms, p95 {numbers['p95_ms']:.1f} ms, p99 "
        f"{numbers['p99_ms']:.1f} ms; /stats {json.dumps(stats)}; median center error "
        f"{numbers['median_err_m']:.4f} m (gate < {MEDIAN_GATE_M}), {int(loc.sum())}/{n} "
        f"localized; against the in-process service: {int(both.sum())} localized by both, "
        f"centers at most {numbers['max_diff_m']} m apart (tolerance {SERVE_PROC_TOL_M}), "
        f"{flips} localized by one only; SIGINT -> exit {rc} in {stop_s:.2f} s; the traffic's "
        f"launches {json.dumps(launches)}"
        + (f"; busy share (nvidia-smi utilization.gpu, {len(sampler.samples)} samples) "
           f"{json.dumps({k: round(v, 3) for k, v in numbers['busy_share'].items()})}"
           if dev.type == "cuda" else "") + f"; on {smi}")
    assert np.isfinite(errs).all() and np.median(errs) < MEDIAN_GATE_M, errs
    assert loc.mean() >= 0.75, f"{tag}: only {int(loc.sum())}/{n} localized"
    assert stats["requests"] == n and stats["image_requests"] == n and stats["batches"] < n, stats
    assert both.any() and diff[both].max() <= SERVE_PROC_TOL_M, diff[both]
    assert flips <= SERVE_PROC_FLIPS * n, flips
    if dev.type == "cuda":
        assert all(launches.get(k, 0) > 0 for k in EXTRACT_KERNELS), launches
        want = [f"cuda:{0 if share else i}" for i in range(shards)]
        assert [p["device"] for p in placement] == want, placement
    return launches, numbers


def cli_map(frames, poses, tex, dev, smi: str) -> dict:
    """``--cards 4``'s own copy of phase 25's map: the walk's first N_BUILD
    frames as PNG files under CLI_ROOT, ``build-map`` on cuda:0 (gates:
    every frame registered, ATE < 0.1 m) and phase 25's held-out query
    PNGs.  Returns what ``phase_serve_process`` takes."""
    import shutil

    if CLI_ROOT.exists():
        shutil.rmtree(CLI_ROOT)
    paths, queries, q_eyes = write_cli_frames(frames, tex)
    store = str(CLI_ROOT / "map")
    out, stages, wall = run_cli(["build-map", str(CLI_ROOT / "walk"), "-o", store,
                                 *CLI_GEOMETRY(), "--device", str(dev)])
    rec = json.loads(out.strip().splitlines()[-1])
    eyes = np.stack([eye for _R, _t, eye in poses])
    ate, _ = store_ate(store, eyes, dev)
    log(f"[cli-map] build-map of {len(paths)} frames in {wall:.3f} s: {json.dumps(rec)}, ATE "
        f"{ate:.4f} m; on {smi}")
    assert rec["registered"] == len(paths) and ate < ATE_GATE_M, (rec, ate)
    return {"store": store, "queries": queries, "q_eyes": q_eyes, "eyes": eyes}


def phase_serve_config_cards(n: int, share: bool, dev, smi: str) -> dict:
    """Phase 46: ``run_configs.config5_serve`` at CONFIGS_SERVE_FPS frames a
    session with its four shards on the visible cards (``load_map``'s
    placement, recorded: shard i on cuda:i; ``share``: all on cuda:0),
    under 5-serve's own gates.  Returns (its numbers, its launches)."""
    from sfmx_torch import run_configs as rc
    from sfmx_torch.serve.server import LocalizationService, MapShardRouter

    placed, load_map = [], LocalizationService.load_map

    def recording(self, map_id, lmap, intr, cfg=None, *, shards: int = 1):
        load_map(self, map_id, lmap, intr, cfg, shards=shards)
        obj = self.maps[map_id][0]
        placed.append([str(d) for d in obj.devices] if isinstance(obj, MapShardRouter)
                      else [str(obj.X.device)])

    LocalizationService.load_map = recording
    try:
        line, got, _, dense = config_run(f"config 5-serve on {n} cards", rc.config5_serve, dev,
                                         smi, dev, fps=CONFIGS_SERVE_FPS)
    finally:
        LocalizationService.load_map = load_map
    log(f"[serve-config-cards] 5-serve's shards on {placed}")
    assert line["pass"], "config 5-serve failed its gates"
    assert placed == [["cuda:0"] * 4 if share else [f"cuda:{i}" for i in range(4)]], placed
    check_config("config 5-serve on the cards", got, dense,
                 EXTRACT_KERNELS + ("match_pairs_fused", "segment_sum"))
    keys = ("merged_ate_m", "queries_ok", "query_err_median_m", "recall_at_8",
            "latency_p95_ms", "build_s", "pass")
    return {**{k: line[k] for k in keys}, "shards_on": placed[0]}, got


def phase_config4_cards(n: int, device: str, backend, dev, smi: str) -> tuple[dict, dict]:
    """Phase 47: ``run_configs.config4`` (the harness's config 4: the
    2,048-camera corridor's block BA, 8 LM x 25 CG) at world sizes ``n`` and
    1 in this call, a card a rank under NCCL (``device`` "cuda", ``backend``
    None; the one-card rehearsal: gloo ranks on cuda:0).  Gates: every rank's R, t, X and costs bit-identical, each
    world's cost monotone, world ``n``'s final cost within BLOCK_RTOL
    (phase 38's) of world 1's, the segment sum on every rank; LM
    iterations/s at both sizes.  Returns (the numbers, each world's ranks'
    launches)."""
    from sfmx_torch import run_configs as rc
    from sfmx_torch.dist import mesh

    out, launches = {}, {}
    for w in (n, 1):
        line, _got, ranks, _ = config_run(f"config 4 at world {w}", rc.config4, dev, smi, device,
                                          world_size=w, backend=backend)
        launches[str(w)] = check_launched(f"config 4, world of {w}",
                                          [r["launches"] for r in ranks], ("segment_sum",))
        costs = ranks[0]["costs"]
        log(f"[config4-cards] world of {w} ({backend or mesh.default_backend(device)} on "
            f"{device}): "
            f"{line['lm_iters_per_s']:.2f} LM iterations/s, cost {costs[0]:.6f} -> "
            f"{costs[-1]:.6f}; rank digests {[r['digest'][:12] for r in ranks]}; on {smi}")
        assert len({r["digest"] for r in ranks}) == 1, f"world of {w}: ranks differ"
        assert line["devices"] == w and np.isfinite(costs).all(), line
        assert all(b <= a for a, b in zip(costs, costs[1:])), f"world of {w}: costs {costs}"
        out[str(w)] = {"lm_iters_per_s": line["lm_iters_per_s"], "final_cost": line["final_cost"],
                       "halo_fraction": line.get("halo_fraction")}
    rel = abs(out[str(n)]["final_cost"] - out["1"]["final_cost"]) / out["1"]["final_cost"]
    log(f"[config4-cards] final cost world {n} {out[str(n)]['final_cost']:.6f}, world 1 "
        f"{out['1']['final_cost']:.6f}: relative difference {rel:.2e} (gate {BLOCK_RTOL}); LM "
        f"iterations/s {out[str(n)]['lm_iters_per_s']:.2f} at world {n}, "
        f"{out['1']['lm_iters_per_s']:.2f} at world 1")
    assert rel <= BLOCK_RTOL, f"world {n} and world 1 costs differ by {rel}"
    out["rel_cost"] = rel
    return out, launches


APART_TIMEOUT_S = 600           # phase 48: each rank process


def phase_apart_cards(res, device: str, backend, smi: str) -> tuple[dict, list]:
    """Phase 48: two ranks started apart, each its own ``subprocess.Popen``
    of ``python -m sfmx_torch.dist.mesh sfmx_torch.dist.worlds:world``
    against ``tcp://127.0.0.1:<free port>`` (``device`` "cuda", ``backend``
    None: NCCL, rank r on cuda:r; the rehearsal: gloo on cuda:0), running phase 39's observation-sharded
    ba-512 step at world 2 on phase 39's inputs.  Gates: each process exits
    0 within APART_TIMEOUT_S (else it is killed), both ranks' R, t, X and
    costs bit-equal to phase 39's spawned world 2, the segment sum on each
    rank.  Returns (the numbers, each rank's launches)."""
    import os
    import shutil

    from sfmx_torch.dist import mesh, worlds

    d = MC_DIR / "apart"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shutil.copy(MC_DIR / "obs_ba.npz", d / "obs_ba.npz")
    init = f"tcp://127.0.0.1:{free_port()}"
    backend = backend or mesh.default_backend(device)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    procs, logs = [], []
    try:
        for r in range(2):
            logs.append(d / f"rank{r}.log")
            with open(logs[-1], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "sfmx_torch.dist.mesh", "sfmx_torch.dist.worlds:world",
                     "--rank", str(r), "--world-size", "2", "--init-method", init, "--device",
                     device, "--backend", backend, "--timeout", "120",
                     "--args", json.dumps([str(d), ["obs_ba"]])],
                    cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=APART_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    assert rcs == [0, 0], f"ranks exited {rcs}:\n" + "\n".join(
        p.read_text()[-3000:] for p in logs)
    apart = worlds.load_results(d, "obs_ba", 2)
    spawned = res[2]["obs_ba"]
    keys = ("R", "t", "X", "costs")
    equal = [worlds.digest(*(o[k] for k in keys)) == worlds.digest(*(spawned[0][k] for k in keys))
             for o in apart]
    launches = check_kernels("ranks started apart", apart, ("segment_sum",))
    it = BA_SHAPE["lm_iters"]
    log(f"[apart-cards] 2 ranks started apart ({backend} on {device}) over {init}: "
        f"{wall:.1f} s (processes included), {it / float(apart[0]['wall_s']):.2f} LM "
        f"iterations/s (phase 39's spawned world 2: "
        f"{it / float(spawned[0]['wall_s']):.2f}); cost {float(apart[0]['costs'][-1]):.6f}; "
        f"bit-equal to the spawned world 2 {equal}; launches rank 0 {json.dumps(launches[0])}; "
        f"on {smi}")
    assert all(equal), "ranks started apart differ from the spawned world"
    return {"iters_per_s": it / float(apart[0]["wall_s"]), "wall_s": wall,
            "bit_equal": all(equal)}, launches


# ---------------------------------------------------------------------------
# Four cards (phases 34-40): python3 chip_smoke.py --cards 4
# ---------------------------------------------------------------------------

MC_DIR = ROOT / ".chip_scratch" / "multicard"
COLLECTIVE_MB, COLLECTIVE_REPS = (1, 64), 20   # phase 34: the yardstick sizes
N_DP_FRAMES, DP_REPS = 64, 5    # phase 35: the walk's first frames, 16 a card on 4
NOISE_SEED = 5                  # phase 36: the batch's RANSAC noise, drawn on the CPU
SHARD_WORLDS, BA_WORLDS = (4, 2), (1, 2, 4)     # phases 36; 38-39
OBS_RTOL = 0.05                 # phase 39 against the planes ba_solve (tests/test_torch_dist.py)
DRYRUN_RTOL = 1e-4              # phase 40: the card's world against the CPU's
EXTRACT_KERNELS = ("diffuse_segment", "response_levels", "describe_upright")


def phase_cards(n: int, share: bool) -> dict:
    """Phase 34 (the cards): ``n`` visible cards of one name and power
    limit (``share``: the rehearsal on one card, every rank on cuda:0);
    each card's name and limit, peer access between each pair, NCCL's
    version."""
    import torch

    count = torch.cuda.device_count()
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()
    if share:
        log(f"[cards] rehearsal: every rank on cuda:0 under gloo; {count} visible: {lines}")
        return {"cards": lines[:1], "count": count, "peer": [], "nccl": None}
    if count < n or len(lines) < n:
        raise RuntimeError(f"--cards {n} needs {n} cards: torch.cuda.device_count() is {count}, "
                           f"nvidia-smi lists {len(lines)}")
    if len(set(lines[:n])) != 1:
        raise RuntimeError(f"--cards {n} needs {n} cards of one name and power limit: {lines[:n]}")
    peer = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n)]
            for i in range(n)]
    nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
    for i in range(n):
        log(f"[cards] cuda:{i} {torch.cuda.get_device_name(i)}; {lines[i]}; peer access "
            f"{[j for j in range(n) if peer[i][j] and j != i]}")
    log(f"[cards] {count} visible, NCCL {nccl}")
    return {"cards": lines[:n], "count": count, "peer": peer, "nccl": nccl}


def write_multicard_inputs(big, serve_frames, walk, dev) -> dict:
    """The inputs of phases 34-39, each built once and written to
    ``MC_DIR/<phase>.npz`` for every world's ranks.  Returns what the
    parent's comparators need."""
    import shutil

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.dist.worlds import BA_NAMES, digest
    from sfmx_torch.run_configs import CONFIG4, config4_problem
    from tests import smoke_scenes

    shutil.rmtree(MC_DIR, ignore_errors=True)      # no checkpoint of an earlier run
    MC_DIR.mkdir(parents=True)
    cfg = PipelineConfig()
    fc, lc = cfg.features, cfg.localize
    save = lambda name, **z: np.savez(MC_DIR / f"{name}.npz", **z)
    save("collectives", sizes_mb=np.asarray(COLLECTIVE_MB, np.float64), reps=COLLECTIVE_REPS,
         x=np.random.default_rng(3).standard_normal((4, 4096)).astype(np.float32))
    save("extract", frames=walk, reps=DP_REPS, sigma=np.asarray(fc.sigma_levels, np.int64),
         max_keypoints=fc.max_keypoints, threshold=fc.threshold, n_octaves=fc.n_octaves)
    f = extract_features(serve_frames[:SERVE_BATCH], cfg, dev)
    q = dict(q_desc=f.desc.cpu().numpy(), q_uv=f.kp.uv.cpu().numpy(),
             q_mask=f.kp.mask.cpu().numpy(), intr=INTR, k_hyp=lc.k_hypotheses,
             noise_seed=NOISE_SEED, px_thresh=lc.px_thresh, sim_thresh=lc.sim_thresh,
             min_inliers=lc.min_inliers)
    save("sharded", **{f"map_{k}": v for k, v in big.to_numpy().items()}, **q)
    prob4 = dict(zip(BA_NAMES, config4_problem(np.random.default_rng(1))))
    log(f"[inputs] config 4's problem (sfmx_torch.run_configs.config4_problem): digest "
        f"{digest(*prob4.values())}")
    save("block_ba", **prob4, iters=CONFIG4["iters"], cg_iters=CONFIG4["cg_iters"], twice=True,
         k_iters=BLOCK_K_ITERS, ckpt_every=BLOCK_CKPT_EVERY,
         ckpt_dir=str(MC_DIR / "ckpt"))
    p = smoke_scenes.ba_problem(BA_SHAPE["C"], BA_SHAPE["P"], BA_SHAPE["O"], seed=0, window=16,
                                perturb=0.03)
    ba512 = dict(zip(BA_NAMES, (p[k] for k in ("intr", "k_idx", "R", "t", "X", "cam_id", "pt_id",
                                               "uv", "w_valid", "fixed_cam_mask"))))
    save("obs_ba", **ba512, iters=BA_SHAPE["lm_iters"], cg_iters=BA_SHAPE["cg_iters"])
    return {"q": q, "block": prob4, "ba512": ba512}


def run_worlds(n: int, device: str, backend) -> dict:
    """One spawned world of each size, each running its phases; returns
    {world size: {phase: every rank's results}}."""
    from sfmx_torch.dist import mesh, worlds

    plan = {n: ("collectives", "extract", "sharded", "block_ba", "obs_ba", "dryrun"),
            2: ("sharded", "block_ba", "obs_ba"), 1: ("extract", "block_ba", "obs_ba")}
    out = {}
    for w, phases in plan.items():
        t0 = time.perf_counter()
        mesh.spawn(worlds.world, w, str(MC_DIR), phases, device=device, backend=backend,
                   timeout=120, join_timeout=600)
        out[w] = {p: worlds.load_results(MC_DIR, p, w) for p in phases}
        log(f"[worlds] world of {w} ({backend or 'nccl'} on {device}): {', '.join(phases)} in "
            f"{time.perf_counter() - t0:.1f} s (processes included)")
    return out


def rank_launches(outs) -> list[dict]:
    return [json.loads(str(o["launches"])) for o in outs]


def check_launched(tag: str, per_rank: list[dict], kernels) -> list[dict]:
    """Every rank launched each of ``kernels`` at least once."""
    for r, g in enumerate(per_rank):
        assert all(g.get(k, 0) > 0 for k in kernels), f"{tag}: rank {r} launches {g}"
    return per_rank


def check_kernels(tag: str, outs, kernels) -> list[dict]:
    return check_launched(tag, rank_launches(outs), kernels)


def same_bits(outs, keys) -> bool:
    from sfmx_torch.dist.worlds import digest

    return len({digest(*(o[k] for k in keys)) for o in outs}) == 1


def busbw(links: dict, op: str) -> float:
    """Phase 34's bus bandwidth of ``op`` ("ar", "ag") at its largest size,
    in bytes/s."""
    return links[f"{op}_{COLLECTIVE_MB[-1]}mb"]["busbw_gb_s"] * 1e9


def phase_links(res, smi: str) -> dict:
    """Phase 34 (the links): all_reduce and all_gather_into_tensor at 1 MB
    and 64 MB at world size 4: every rank's sums exact, its seeded sum
    equal on every rank and within 1e-5 of numpy's, its gather the rows in
    rank order; ms and bus bandwidth by rank 0's CUDA events."""
    x = np.random.default_rng(3).standard_normal((len(res), 4096)).astype(np.float32)
    for r, o in enumerate(res):
        assert all(bool(o[f"ar_exact_{mb:g}"]) for mb in COLLECTIVE_MB), r
        np.testing.assert_allclose(o["sum"], x.sum(0), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(o["gather"], x.reshape(-1))
    assert same_bits(res, ("sum",)), "the ranks' all_reduce results differ"
    o = res[0]
    out = {f"{op}_{mb}mb": {"ms": float(o[f"{op}_ms_{mb:g}"]),
                            "busbw_gb_s": float(o[f"{op}_busbw_{mb:g}"])}
           for op in ("ar", "ag") for mb in COLLECTIVE_MB}
    log(f"[links] world of {len(res)}: " + "; ".join(
        f"{'all_reduce' if k.startswith('ar') else 'all_gather'} {k[3:]} {v['ms']:.4f} ms, "
        f"bus {v['busbw_gb_s']:.1f} GB/s" for k, v in out.items()) + f"; on {smi}")
    return out


def phase_dp_extract(res, walk, dev, smi: str) -> dict:
    """Phase 35: the walk's 64 frames through ``extract_data_parallel``
    (16 a card at world size 4): every rank's gathered features equal, the
    world of one's too; each card's quarter bit-equal to this card's
    ``extract_features`` of the same 16 frames (``PipelineConfig()``, the
    ranks' settings); K1-K3 on every rank; frames/s at world sizes 1 and
    4."""
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.dist.worlds import digest

    w4, w1 = res[4]["extract"], res[1]["extract"]
    n, m = len(w4), N_DP_FRAMES // len(w4)
    quarters = []
    for r in range(n):
        f = extract_features(walk[r * m:(r + 1) * m], PipelineConfig(), dev)
        quarters.append(digest(f.desc, f.kp.uv, f.kp.mask) == str(w4[r]["own_digest"]))
        if not quarters[-1]:
            log(f"[dp] quarter {r}: max |desc - one card's| "
                f"{np.abs(w4[0]['desc'][r * m:(r + 1) * m] - f.desc.cpu().numpy()).max():.3e}")
    launches = check_kernels("dp extraction", w4, EXTRACT_KERNELS)
    check_kernels("dp extraction, world of 1", w1, EXTRACT_KERNELS)
    rate = {w: N_DP_FRAMES / float(res[w]["extract"][0]["wall_s"]) for w in (1, n)}
    log(f"[dp] {N_DP_FRAMES} VGA frames, {m} a card: every rank's gathered features equal "
        f"{same_bits(w4, ('digest',))}, equal to one card's extraction of all "
        f"{N_DP_FRAMES} {str(w1[0]['digest']) == str(w4[0]['digest'])}; each quarter bit-equal "
        f"to this card's extraction of its {m} frames {quarters}; {rate[1]:.1f} frames/s on one "
        f"card, "
        f"{rate[n]:.1f} on {n} ({rate[n] / rate[1]:.2f}x; median of {DP_REPS}, gathers "
        f"included); launches per rank {json.dumps(launches)}; on {smi}")
    assert same_bits(w4, ("digest",)), "the ranks' gathered features differ"
    assert str(w1[0]["digest"]) == str(w4[0]["digest"]), "world 4 differs from world 1"
    assert all(quarters), f"a card's quarter differs from the one-card extraction: {quarters}"
    return {"frames_per_s": {str(w): v for w, v in rate.items()}, "quarters_equal": quarters}


def phase_map_sharded(res, big, q, links: dict, dev, smi: str) -> dict:
    """Phase 36: one B=32 VGA batch (32,768 query rows) through
    ``localize_batch_sharded`` against the map-scale map in 4 (then 2)
    landmark shards, one a card, the RANSAC noise drawn on the CPU: every
    rank's merged (s1, global index, s2) equal to the unsplit K4 on one
    card, the poses to ``localize_batch_streaming``'s with the same noise
    (n_inliers equal, centers within 1e-5 m), median center error < 0.2 m,
    K4 on every rank; K4's device ms on each card, the all-gather and the
    all-reduce of a batch against phase 34's bandwidth."""
    import torch

    from sfmx_torch.dist.worlds import query_noise
    from sfmx_torch.localize import sharded as sh
    from sfmx_torch.localize.localize import localize_batch_streaming

    T = lambda k: torch.as_tensor(q[k], device=dev)
    B, K, D = q["q_desc"].shape
    qf = torch.where(T("q_mask")[..., None], T("q_desc"), 0.0).reshape(B * K, D)
    ref = [x.cpu().numpy() for x in
           sh.local_top2(qf, torch.where(big.lm_alive[:, None], big.lm_desc, 0.0))]
    kw = dict(k_hypotheses=int(q["k_hyp"]), px_thresh=float(q["px_thresh"]),
              sim_thresh=float(q["sim_thresh"]), min_inliers=int(q["min_inliers"]))
    st = localize_batch_streaming(big, T("q_desc"), T("q_uv"), T("q_mask"), T("intr"),
                                  gumbel=query_noise(q, dev), **kw)
    st_c, st_n = st.center.cpu().numpy(), st.n_inliers.cpu().numpy()
    eyes = np.stack([e for _R, _t, e in serve_poses()[:B]])
    out = {}
    for n in SHARD_WORLDS:
        outs = res[n]["sharded"]
        fields = [{name: bool(np.array_equal(o[key], r.astype(o[key].dtype)))
                   for name, key, r in zip(("s1", "i1", "s2"), ("s1", "ig", "s2"), ref)}
                  for o in outs]
        dc = max(float(np.linalg.norm(o["res_center"] - st_c, axis=-1).max()) for o in outs)
        inl = all(np.array_equal(o["res_n_inliers"], st_n) for o in outs)
        err = float(np.median(np.linalg.norm(outs[0]["res_center"] - eyes, axis=-1)))
        launches = check_kernels(f"sharded, world of {n}", outs, ("match_top2",))
        k4 = [float(o["k4_ms"]) for o in outs]
        o = outs[0]
        ag_bw = float(o["ag_bytes"]) * (n - 1) / n / busbw(links, "ag") * 1e3
        ar_bw = float(o["ar_bytes"]) * 2 * (n - 1) / n / busbw(links, "ar") \
            * 1e3
        log(f"[map-sharded] world of {n}: {int(o['p_local'])} landmarks a card; merged fields "
            f"equal to the unsplit K4 {json.dumps(fields)}; n_inliers equal to streaming {inl}, "
            f"centers max {dc:.2e} m apart, median error {err:.4f} m; batch "
            f"{float(o['wall_s']) * 1e3:.2f} ms; K4 device ms a card "
            f"{', '.join(f'{v:.4f}' for v in k4)}; all-gather {int(o['ag_bytes'])} B "
            f"{float(o['ag_ms']):.4f} ms (at phase 34's {COLLECTIVE_MB[-1]} MB bus rate "
            f"{ag_bw:.4f}), all-reduce "
            f"{int(o['ar_bytes'])} B {float(o['ar_ms']):.4f} ms ({ar_bw:.4f}); launches "
            f"{json.dumps(launches)}; on {smi}")
        assert all(all(f.values()) for f in fields), f"sharded top-2 differs: {fields}"
        assert inl and dc <= 1e-5, f"sharded poses differ from streaming: {dc}"
        assert same_bits(outs, ("res_R", "res_t", "res_n_inliers", "idx")), "ranks differ"
        assert err < MEDIAN_GATE_M, err
        out[str(n)] = {"batch_ms": float(o["wall_s"]) * 1e3, "k4_device_ms": k4,
                       "allgather_ms": float(o["ag_ms"]), "allgather_bytes": int(o["ag_bytes"]),
                       "allreduce_ms": float(o["ar_ms"]), "allreduce_bytes": int(o["ar_bytes"]),
                       "median_err_m": err}
    return out


def card_busy(run, tag: str, smi: str) -> dict:
    """``run()`` (two serving bursts) under torch.profiler: each card's busy
    share of the wall (its kernels' and copies' merged intervals), and the
    time two or more cards were busy at once (the sum of the cards' busy
    time less their union)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def merged(iv):
        total, end = 0.0, -np.inf
        for a, b in sorted(iv):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    iv: dict[int, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            iv.setdefault(e.device_index, []).append((e.time_range.start, e.time_range.end))
    assert iv, "the profiler recorded no device time"
    busy = {d: merged(v) for d, v in sorted(iv.items())}
    overlap = sum(busy.values()) - merged([x for v in iv.values() for x in v])
    share = {f"cuda:{d}": b / wall_us for d, b in busy.items()}
    log(f"{tag} profiled 2 bursts in {wall_us / 1e6:.3f} s: busy share "
        f"{json.dumps({k: round(v, 4) for k, v in share.items()})}; two or more cards busy at "
        f"once {overlap / 1e3:.2f} ms ({overlap / wall_us:.4f} of the wall); on {smi}")
    return {"busy_share": share, "overlap_ms": overlap / 1e3}


SPREAD_PER_ROOM = 4             # phase 37: held-out frames of each room of the map-scale map


def spread_frames(n_rooms: int):
    """SPREAD_PER_ROOM held-out VGA frames of each room of the map-scale map
    (the query room and its distractors, as ``phase_map_scale`` renders
    them) and their true camera centers in the map's frame."""
    from tests import smoke_scenes

    frames, eyes = [], []
    for r in range(n_rooms):
        poses = serve_poses()[r::n_rooms][:SPREAD_PER_ROOM]
        frames.append(smoke_scenes.render_parallel(0 if r == 0 else 1000 + r, poses, W_IMG,
                                                   H_IMG, FOCAL, RENDER_WORKERS))
        eyes += [eye + np.array([20.0 * r, 0.0, 0.0]) for _R, _t, eye in poses]
    return np.concatenate(frames), np.stack(eyes)


def serve_spread(big, frames, eyes, n: int, dev, smi: str, devices=None) -> dict:
    """Traffic spread over the building: 8 bursts of the rooms' frames as
    concurrent image requests through ``load_map(shards=n)`` (or, with
    ``devices``, the router built directly on those), the queries each
    shard received, the serve gates (median < 0.2 m, >= 75 % localized),
    requests/s, p50/p99 and each card's busy share over two profiled
    bursts."""
    import asyncio

    import sfmx_torch.serve.server as server
    from sfmx_torch.cli.config import PipelineConfig

    svc = server.LocalizationService(batch_window_ms=SERVE_WINDOW_MS, max_batch=SERVE_BATCH)
    svc.load_map("building", big, INTR, cfg=PipelineConfig(), shards=n)
    if devices is not None:
        _obj, intr0, cfg0 = svc.maps["building"]
        svc.maps["building"] = (server.MapShardRouter.build(
            server.split_localization_map(big, n), devices), intr0, cfg0)
    router = svc.maps["building"][0]
    routed, route = [], router.route

    def recording(q_desc, q_mask):
        shard_of = route(q_desc, q_mask)
        routed.append(shard_of)
        return shard_of

    router.route = recording
    svc.warmup("building")

    async def run(bursts: int):
        await svc.start()
        try:
            outs, walls = [], []
            for _ in range(bursts):
                t0 = time.perf_counter()
                outs += await asyncio.gather(*[svc.localize("building", image=f) for f in frames])
                walls.append(time.perf_counter() - t0)
            return outs, walls
        finally:
            await svc.stop()

    routed.clear()
    outs, walls = asyncio.run(run(N_BURSTS))
    st = svc.stats.snapshot()
    errs = np.array([np.linalg.norm(np.asarray(o["center"]) - e)
                     for o, e in zip(outs, np.tile(eyes, (N_BURSTS, 1)))])
    n_loc = sum(o["n_inliers"] >= PipelineConfig().localize.min_inliers for o in outs)
    per_shard = np.bincount(np.concatenate(routed), minlength=n).tolist()
    tag = "[serve-spread]" if devices is None else \
        f"[serve-spread on {','.join(str(d) for d in devices)}]"
    out = {"requests_per_s": len(outs) / sum(walls), "p50_ms": st["p50_latency_ms"],
           "p99_ms": st["p99_latency_ms"], "median_err_m": float(np.median(errs)),
           "localized": n_loc / len(outs), "per_shard": per_shard,
           **card_busy(lambda: asyncio.run(run(2)), tag, smi)}
    log(f"{tag} {N_BURSTS} bursts of {len(frames)} requests spread over the rooms, shards on "
        f"{[str(d) for d in router.devices]}: queries a shard {per_shard}; "
        f"{out['requests_per_s']:.2f} requests/s, p50 {out['p50_ms']:.1f} ms, p99 "
        f"{out['p99_ms']:.1f} ms; median center error {out['median_err_m']:.4f} m; {n_loc}/"
        f"{len(outs)} localized; on {smi}")
    assert out["median_err_m"] < MEDIAN_GATE_M, out
    assert n_loc >= 0.75 * len(outs), (n_loc, len(outs))
    assert all(c > 0 for c in per_shard), f"a shard received no query: {per_shard}"
    return out


def phase_serve_cards(big, serve_frames, own_frames, n: int, dev, smi: str) -> tuple:
    """Phase 37: phase 10's bursts through ``load_map(shards=4)``, shard i on
    cuda:i, under phase 30's gates, and the same four shards all on cuda:0
    (the router built directly), in turns (cards, cuda:0, cuda:0, cards);
    then traffic spread over the building's rooms (``serve_spread``) the
    same way.  Requests/s, latency percentiles, each card's busy share and
    the time two or more cards were busy at once, for each run.  Returns
    the first run's launches and the runs' numbers."""
    turns = ("cards", "cuda0", "cuda0", "cards")
    where = lambda tag: [dev] if tag == "cuda0" else None
    runs = {"phase10": {"cards": [], "cuda0": []}, "spread": {"cards": [], "cuda0": []}}
    launches = None
    for tag in turns:
        got, numbers = phase_serve(big, serve_frames, own_frames, dev, smi, shards=n, busy=True,
                                   devices=where(tag))
        launches = launches or got
        runs["phase10"][tag].append(numbers)
    frames, eyes = spread_frames(big.kf_gdesc.shape[0] // N_KEYFRAMES)
    for tag in turns:
        runs["spread"][tag].append(serve_spread(big, frames, eyes, n, dev, smi,
                                                devices=where(tag)))
    for traffic, r in runs.items():
        pick = lambda tag, key: " / ".join(f"{x[key]:.2f}" for x in r[tag])
        log(f"[serve-cards] {traffic} traffic, {n} shards on {n} cards "
            f"{pick('cards', 'requests_per_s')} requests/s (p50 {pick('cards', 'p50_ms')} ms) "
            f"against {pick('cuda0', 'requests_per_s')} (p50 {pick('cuda0', 'p50_ms')} ms) with "
            f"all {n} on cuda:0, in turns (cards, cuda:0, cuda:0, cards); on {smi}")
    for k in EXTRACT_KERNELS:
        assert launches.get(k, 0) > 0, launches
    return launches, runs


def phase_block_cards(res, prob: dict, links: dict, dev, smi: str) -> dict:
    """Phase 38: config 4 through ``ba_solve_blocked`` at world sizes 1, 2
    and 4, a card a rank: final cost within BLOCK_RTOL of the planes
    ``ba_solve`` on one card, the cost falls, R, t, X and costs
    bit-identical on every rank, the segment-sum kernel on every rank; at
    every size the joint focal within 5 px of 500 and the checkpointed
    solve resumed after its first chunk bit-identical to the uninterrupted
    one; the same solve twice bit-identical.  LM iterations/s, the
    layout's host time and stats, a CG step's reduce-scatter and all-gather
    against phase 34, the segment sum's device time on a rank's block."""
    import torch

    from sfmx_torch.dist.worlds import BA_NAMES
    from sfmx_torch.run_configs import CONFIG4
    from sfmx_torch.solvers import lm

    it, cg = CONFIG4["iters"], CONFIG4["cg_iters"]
    T = [torch.as_tensor(prob[k], device=dev) for k in BA_NAMES]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    *_, costs_p = lm.ba_solve(*T, iters=it, cg_iters=cg)
    costs_p = costs_p.cpu().numpy()
    wall_p = time.perf_counter() - t0
    log(f"[block-cards] config 4 planes ba_solve on cuda:0: {it / wall_p:.2f} LM iterations/s, "
        f"cost -> {float(costs_p[-1]):.6f}")
    out = {"planes_iters_per_s": it / wall_p}
    for n in BA_WORLDS:
        outs = res[n]["block_ba"]
        o = outs[0]
        c = o["costs"]
        rel = abs(float(c[-1]) - float(costs_p[-1])) / float(costs_p[-1])
        launches = check_kernels(f"block BA, world of {n}", outs, ("segment_sum",))
        stats = json.loads(str(o["stats"]))
        cg_bytes = int(o["rs_bytes"]) + int(o["ag_bytes"])
        bw_ms = cg_bytes * (n - 1) / n / busbw(links, "ag") * 1e3
        row = {"iters_per_s": it / float(o["wall_s"]), "rel_cost": rel,
               "layout_s": float(o["layout_s"]), "stats": stats,
               "repeat_bit_identical": bool(o["repeat_equal"]), "focal": float(o["k_intr"][0, 0]),
               "cg_step": {"rs_bytes": int(o["rs_bytes"]), "ag_bytes": int(o["ag_bytes"]),
                           "rs_ms": float(o["rs_ms"]), "ag_ms": float(o["ag_ms"]),
                           "dots_ms": float(o["dots_ms"])},
               "segsum_ms": {"cam": float(o["segsum_cam_ms"]), "pt": float(o["segsum_pt_ms"]),
                             "obs_block": int(o["obs_block"])}}
        out[str(n)] = row
        log(f"[block-cards] world of {n}: {row['iters_per_s']:.2f} LM iterations/s "
            f"({float(o['wall_s']):.3f} s for {it}), cost {float(c[0]):.4f} -> "
            f"{float(c[-1]):.6f} ({rel:.2e} from planes); layout {row['layout_s']:.2f} s on the "
            f"host of every rank, {json.dumps(stats)}; same solve twice bit-identical "
            f"{row['repeat_bit_identical']}; joint focal {row['focal']:.3f} in "
            f"{float(o['k_wall_s']):.3f} s; checkpoint resume bit-identical "
            f"{bool(o['ck_equal'])}; a CG step: reduce-scatter {int(o['rs_bytes'])} B "
            f"{float(o['rs_ms']):.4f} ms, all-gather {int(o['ag_bytes'])} B "
            f"{float(o['ag_ms']):.4f} ms (both at phase 34's {COLLECTIVE_MB[-1]} MB bus rate "
            f"{bw_ms:.4f} ms), "
            f"three dots {float(o['dots_ms']):.4f} ms; segment sum on a block of "
            f"{int(o['obs_block'])} observations: cameras (x36) {float(o['segsum_cam_ms']):.4f} "
            f"ms, points (x12) {float(o['segsum_pt_ms']):.4f} ms device; launches rank 0 "
            f"{json.dumps(launches[0])}; on {smi}")
        assert same_bits(outs, ("R", "t", "X", "costs")), f"world of {n}: ranks differ"
        assert same_bits(outs, ("k_intr", "k_costs", "ck_costs", "ck_resumed_costs"))
        assert all(bool(o["repeat_equal"]) for o in outs), f"world of {n}: a rerun differs"
        assert np.isfinite(c).all() and c[-1] <= c[0], c
        assert rel <= BLOCK_RTOL, f"world of {n}: blocked and planes costs differ by {rel}"
        assert abs(row["focal"] - 500.0) < 5.0, row["focal"]
        assert bool(o["ck_equal"]) and len(o["ck_costs"]) == it + 1 \
            and len(o["ck_resumed_costs"]) == it - BLOCK_CKPT_EVERY + 1
    return out


def phase_obs_cards(res, prob: dict, links: dict, dev, smi: str) -> dict:
    """Phase 39: ``dist_ba.make_ba_step`` on the ba-512 problem (10 LM x 30
    CG) at world sizes 1, 2 and 4: ranks bit-identical, the final cost
    within OBS_RTOL of the planes ``ba_solve`` on one card, the segment-sum
    kernel on every rank; LM iterations/s and a CG step's two all-reduces
    against phase 34."""
    import torch

    from sfmx_torch.dist.worlds import BA_NAMES
    from sfmx_torch.solvers import lm

    it, cg = BA_SHAPE["lm_iters"], BA_SHAPE["cg_iters"]
    T = [torch.as_tensor(prob[k], device=dev) for k in BA_NAMES]
    *_, costs_p = lm.ba_solve(*T, iters=it, cg_iters=cg)
    costs_p = costs_p.cpu().numpy()
    out = {}
    for n in BA_WORLDS:
        outs = res[n]["obs_ba"]
        o = outs[0]
        c = o["costs"]
        rel = abs(float(c[-1]) - float(costs_p[-1])) / float(costs_p[-1])
        launches = check_kernels(f"obs BA, world of {n}", outs, ("segment_sum",))
        bw_ms = int(o["ar_bytes"]) * 2 * (n - 1) / n / busbw(links, "ar") * 1e3
        out[str(n)] = {"iters_per_s": it / float(o["wall_s"]), "rel_cost": rel,
                       "allreduce_bytes": int(o["ar_bytes"]), "allreduce_ms": float(o["ar_ms"])}
        log(f"[obs-cards] world of {n}: {it / float(o['wall_s']):.2f} LM iterations/s, cost "
            f"{float(c[0]):.4f} -> {float(c[-1]):.6f} ({rel:.2e} from the planes ba_solve's "
            f"{float(costs_p[-1]):.6f}); a CG step's two all-reduces {int(o['ar_bytes'])} B "
            f"{float(o['ar_ms']):.4f} ms (at phase 34's {COLLECTIVE_MB[-1]} MB bus rate "
            f"{bw_ms:.4f} ms); launches "
            f"rank 0 {json.dumps(launches[0])}; on {smi}")
        assert same_bits(outs, ("R", "t", "X", "costs")), f"world of {n}: ranks differ"
        assert np.isfinite(c).all() and rel <= OBS_RTOL, (c, rel)
    return out


def phase_dryrun_cards(res, smi: str) -> dict:
    """Phase 40: the dry run at world size 4 under NCCL (every rank's
    results equal, K1-K5 launched on each) beside
    ``python -m sfmx_torch.dist.dryrun --world-size 4 --device cpu``
    (gloo): each BA's costs within DRYRUN_RTOL relative, the map-sharded
    t within DRYRUN_RTOL."""
    outs = [json.loads(str(o["json"])) for o in res]
    assert all(o == outs[0] for o in outs[1:]), "the dry run's ranks differ"
    check_launched("dry run", [o["launches"] for o in outs],
                   EXTRACT_KERNELS + ("match_top2", "match_pairs_fused"))
    path = MC_DIR / "dryrun_cpu.json"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "sfmx_torch.dist.dryrun", "--world-size",
                    str(len(outs)), "--device", "cpu", "--out", str(path)], cwd=ROOT,
                   check=True, timeout=900)
    cpu = json.loads(path.read_text())
    card = outs[0]
    rel = {k: float(np.max(np.abs(np.subtract(card[k]["costs"], cpu[k]["costs"]))
                           / np.abs(cpu[k]["costs"])))
           for k in ("block_ba", "block_ba_k", "obs_ba")}
    dt = float(np.abs(np.subtract(card["sharded"]["t"], cpu["sharded"]["t"])).max())
    log(f"[dryrun-cards] world of {len(outs)} on the cards: ranks equal; CPU world (gloo) "
        f"{time.perf_counter() - t0:.1f} s; costs card vs CPU, largest relative difference "
        f"{json.dumps(rel)}; map-sharded t {dt:.2e} apart; launches rank 0 "
        f"{json.dumps(card['launches'])}; on {smi}")
    assert all(v <= DRYRUN_RTOL for v in rel.values()), rel
    assert dt <= DRYRUN_RTOL, dt
    return {"cost_rel": rel, "t_diff": dt}


def phase_real_scene_cards(n: int, share: bool, smi: str) -> tuple[dict, dict]:
    """Phase 43 (the cards): config 4-build's block BA across cards.  The
    4-build's scene (CONFIGS_BUILD_FRAMES corridor frames through
    ``run_configs.config2_scale`` on cuda:0, PNG frame files), then
    ``run_configs.block_ba_real_scene`` on it at world sizes ``n`` and 1, a
    card a rank under NCCL (``share``: gloo ranks on cuda:0).  Gates: the
    build's own; every rank's R, t, X and costs bit-identical;
    ``cost_monotone_ok``; world ``n``'s final cost within BLOCK_RTOL of
    world 1's; the segment sum on every rank.  Returns (the phase's
    numbers, each world's ranks' launches)."""
    import tempfile

    from sfmx_torch import run_configs as rc

    with tempfile.TemporaryDirectory(prefix="sfmx_c4b_") as root:
        t0 = time.perf_counter()
        rep = rc.config2_scale("cuda:0", root, frames=CONFIGS_BUILD_FRAMES, scene="corridor")
        log(f"[real-scene-cards] the 4-build's scene: {CONFIGS_BUILD_FRAMES} corridor frames, "
            f"{rep['n_registered']} registered, ATE {rep['ate_m']:.4f} m (gate "
            f"{rep['ate_gate_m']:.3f}), {time.perf_counter() - t0:.1f} s; on {smi}")
        assert rep["pass"], "the 4-build's scene failed its gates"
        device, backend = ("cuda:0", "gloo") if share else ("cuda", None)
        out, launches = {}, {}
        for w in (n, 1):
            t0 = time.perf_counter()
            bb, ranks = rc.block_ba_real_scene(rep["map_path"], device, world_size=w,
                                               backend=backend)
            launches[str(w)] = check_launched(f"real scene, world of {w}",
                                              [r["launches"] for r in ranks], ("segment_sum",))
            log(f"block_ba_real_scene {json.dumps(bb)}")
            log(f"[real-scene-cards] world of {w} ({backend or 'nccl'} on {device}): "
                f"{time.perf_counter() - t0:.1f} s (processes included); rank digests "
                f"{[r['digest'][:12] for r in ranks]}; launches rank 0 "
                f"{json.dumps(ranks[0]['launches'])}")
            assert len({r["digest"] for r in ranks}) == 1, f"world of {w}: ranks differ"
            assert bb["cost_monotone_ok"] and bb["n_blocks"] == w, bb
            out[str(w)] = bb
        rel = abs(out[str(n)]["cost_final"] - out["1"]["cost_final"]) / out["1"]["cost_final"]
        log(f"[real-scene-cards] final cost world {n} {out[str(n)]['cost_final']:.6f}, world 1 "
            f"{out['1']['cost_final']:.6f}: relative difference {rel:.2e} (gate {BLOCK_RTOL})")
        assert rel <= BLOCK_RTOL, f"world {n} and world 1 costs differ by {rel}"
        return {"scene": {k: rep[k] for k in ("n_frames", "n_registered", "ate_m", "wall_s")},
                "worlds": out, "rel_cost": rel}, launches


def main_cards(n: int, share: bool) -> int:
    """``--cards n``: phases 34-40, 43 and 45-48 after the device check and
    the build."""
    import torch

    name, smi = phase_device()
    sys.path.insert(0, str(ROOT))
    import sfmx_torch  # noqa: F401  (sets the TF32 flags)
    from examples import room
    from tests import smoke_scenes

    if n != 4:
        raise ValueError(f"--cards takes 4 (the worlds of 4, 2 and 1), not {n}")
    cards = phase_cards(n, share)
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    phase_build()
    tex = room.RoomTexture(seed=0)
    _lmap, kf = phase_map(tex, dev)
    big = phase_map_scale(kf, dev)
    t0 = time.perf_counter()
    serve_frames = smoke_scenes.render_parallel(0, serve_poses(), W_IMG, H_IMG, FOCAL,
                                                RENDER_WORKERS)
    own_frames = smoke_scenes.render_parallel(0, serve_poses()[:2], W_IMG, H_IMG, FOCAL_OWN,
                                              RENDER_WORKERS)
    log(f"[inputs] serve frames rendered in {time.perf_counter() - t0:.1f} s")
    # every kernel against its plain version on cuda:0 at the default run's
    # shapes (phases 3, 9, 14, 17), and the one-card paths that launch K5-K10
    # (phases 13 and 18): this run's kernels line
    kstats = phase_kernels(serve_frames[:SERVE_BATCH], dev)
    kstats["match_top2"] = phase_k4(big, serve_frames, dev, smi, False)
    front_stats, front_launches, build_frames, build_poses = phase_front_end(dev, smi, False)
    kstats.update(front_stats)
    phase_ba_kernels(dev, smi, False)
    kstats["segment_sum"] = phase_segment_sum(dev, smi)
    *_, map_launches, ba_stats, _map_stats = phase_build_map(build_frames, build_poses, dev, smi,
                                                             False)
    kstats.update(ba_stats)
    t0 = time.perf_counter()
    walk = build_frames[:N_DP_FRAMES]
    inputs = write_multicard_inputs(big, serve_frames, walk, dev)
    log(f"[inputs] phase inputs written in {time.perf_counter() - t0:.1f} s")
    rank_dev, backend = ("cuda:0", "gloo") if share else ("cuda", None)
    res = run_worlds(n, rank_dev, backend)
    phases = {"34": {**cards, "links": phase_links(res[n]["collectives"], smi)}}
    links = phases["34"]["links"]
    phases["35"] = phase_dp_extract(res, walk, dev, smi)
    phases["36"] = phase_map_sharded(res, big, inputs["q"], links, dev, smi)
    serve_launches, phases["37"] = phase_serve_cards(big, serve_frames, own_frames, n, dev, smi)
    phases["38"] = phase_block_cards(res, inputs["block"], links, dev, smi)
    phases["39"] = phase_obs_cards(res, inputs["ba512"], links, dev, smi)
    phases["40"] = phase_dryrun_cards(res[n]["dryrun"], smi)
    phases["43"], real_scene_launches = phase_real_scene_cards(n, share, smi)
    # the deployments started as processes, on the cards (phases 45-48)
    cmap = cli_map(build_frames, build_poses, tex, dev, smi)
    serve_proc_launches, phases["45"] = phase_serve_process(
        cmap["store"], cmap["queries"], cmap["q_eyes"], cmap["eyes"], dev, smi, shards=n,
        share=share)
    phases["46"], serve_config_launches = phase_serve_config_cards(n, share, dev, smi)
    phases["47"], config4_launches = phase_config4_cards(n, rank_dev, backend, dev, smi)
    phases["48"], apart_launches = phase_apart_cards(res, rank_dev, backend, smi)
    launches = {f"world{w}": {p: ([json.loads(str(o["json"]))["launches"] for o in outs]
                                  if p == "dryrun" else rank_launches(outs))
                              for p, outs in by_phase.items() if p != "collectives"}
                for w, by_phase in res.items()}
    launches["serve"] = serve_launches
    launches["real_scene"] = real_scene_launches
    launches["serve_process"] = serve_proc_launches
    launches["serve_config"] = serve_config_launches
    launches["config4"] = config4_launches
    launches["apart"] = apart_launches
    # each kernel's launches on this run's paths: every rank, the server
    # process, the one-card paths above
    path_launches = {k: 0 for k in KERNELS}

    def add(got):
        if isinstance(got, dict) and not any(isinstance(v, (dict, list)) for v in got.values()):
            for k, v in got.items():
                if k in path_launches:
                    path_launches[k] += v
        else:
            for g in (got.values() if isinstance(got, dict) else got):
                add(g)

    add([front_launches, map_launches, launches])
    log(f"[counters] the four-card run's launches by kernel {json.dumps(path_launches)}")
    assert all(v > 0 for v in path_launches.values()), path_launches
    kernels = [{"name": k, "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
                "launches": path_launches[k], **kstats[k]} for k in KERNELS]
    log(f"[done] {time.perf_counter() - t_start:.1f} s after the device check")
    print(json.dumps({"multicard": {"phases": phases, "launches": launches}}))
    for line in cards["cards"]:
        print(line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def phase_tune(dev, smi: str) -> None:
    """The sweeps behind the kernels' constants.  K1: the four segments of
    the default config on a 32-image VGA batch and on its half-size octave,
    for tiles and fused-step limits that fit the block's shared memory.  K2:
    tiles and threads a block on the same two shapes.  K4: the landmark tile
    (64 or 128 rows), the depth of the ring and the number of splits, at the
    serving batch's 32,768 query rows and at the burst tail's 2,048 against
    133,120 landmarks of random unit descriptors, by CUDA events around the
    launch and, for the tail, by torch.profiler (an event pair also times
    the wrapper's host path).  K5: pairs of one row image a block and ring
    depth at the exhaustive build's 4,560 pairs of random descriptors, by
    torch.profiler.  K3: keypoints (warps) per block on both
    octaves of a 32-image VGA batch of random levels, 1,024 and 512
    keypoints an image at the octave's sigmas.  K6: slot groups per point on
    the 512-camera problem and on one of the 96-frame build's size (tp =
    64), call time by CUDA events and device time by torch.profiler; K8 on
    the same two problems (four candidates, as an LM iteration calls it):
    slot groups, with the camera tables staged in shared memory and read
    through the cache; K7 on the same two problems: slot groups; then the host's time per call of K6's wrapper and of
    its parts beside two small PyTorch ops."""
    import torch

    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels import describe as dsc
    from sfmx_torch.kernels import features as F
    from sfmx_torch.kernels import match as mt
    from sfmx_torch.kernels import scale_space as ss
    from sfmx_torch.kernels import segsum as sg
    from sfmx_torch.solvers import schur
    from tests.smoke_scenes import ba_problem

    cfg = F.ScaleSpaceConfig()
    segs = F.level_taus(cfg)
    g = torch.Generator().manual_seed(0)
    for shape in ((SERVE_BATCH, H_IMG, W_IMG), (SERVE_BATCH, H_IMG // 2, W_IMG // 2)):
        L0 = F.gaussian_blur(torch.rand(shape, generator=g).to(dev), 2.0).contiguous()
        k2 = F.contrast_k2(L0).reshape(-1).contiguous()
        rows = []
        for tile in ((96, 128), (80, 160), (120, 128), (96, 160), (64, 128), (60, 160), (48, 128),
                     (96, 96), (64, 64)):
            for mf in range(1, 9):
                longest = max(len(c) for t in segs for c in ss.fused_chunks(t, mf))
                if ss._plane_bytes(longest, *tile) > ss.SMEM_BYTES:
                    continue

                def run(tile=tile, mf=mf):
                    L = L0
                    for taus in segs:
                        for chunk in ss.fused_chunks(taus, mf):
                            L = ss._diffuse_fused(L, k2, chunk, *tile)

                n = sum(len(ss.fused_chunks(t, mf)) for t in segs)
                rows.append((cuda_ms(run, reps=5, warm=1), tile, mf, n))
        rows.sort()
        log(f"[tune] K1 B={shape[0]} {shape[1]}x{shape[2]}, all 4 segments, ms by (tile, most "
            f"fused steps, launches), best first: "
            + "; ".join(f"{ms:.3f} {t[0]}x{t[1]} {mf} {n}" for ms, t, mf, n in rows) + f"; on {smi}")

    for shape in ((SERVE_BATCH, H_IMG, W_IMG), (SERVE_BATCH, H_IMG // 2, W_IMG // 2)):
        levels = torch.rand((shape[0], cfg.n_levels, *shape[1:]), generator=g).to(dev)
        rows = []
        for tile in ((48, 128), (32, 128), (64, 128), (40, 128), (56, 128), (24, 128), (48, 96),
                     (48, 160), (32, 64), (96, 128)):
            if ss._response_bytes(max(cfg.sigma_levels), *tile) > ss.SMEM_BYTES:
                continue
            for threads in (128, 256, 512, 1024):
                ms = cuda_ms(lambda: ss._response_fused(levels, cfg.sigma_levels, *tile, threads),
                             reps=5, warm=1)
                rows.append((ms, tile, threads))
        rows.sort()
        log(f"[tune] K2 B={shape[0]} {shape[1]}x{shape[2]}, {cfg.n_levels} levels, ms by (tile, "
            f"threads), best first: "
            + "; ".join(f"{ms:.3f} {t[0]}x{t[1]} {th}" for ms, t, th in rows) + f"; on {smi}")

    for shape, K in (((SERVE_BATCH, H_IMG, W_IMG), 1024), ((SERVE_BATCH, H_IMG // 2, W_IMG // 2), 512)):
        B, H, W = shape
        levels = torch.rand((B, cfg.n_levels, H, W), generator=g).to(dev)
        lvl = torch.randint(0, cfg.n_levels, (B, K), generator=g)
        uv = (torch.rand((B, K, 2), generator=g) * torch.tensor([W - 1.0, H - 1.0])).to(dev)
        sigma = torch.as_tensor(cfg.sigmas)[lvl].to(dev)
        mask = torch.ones((B, K), dtype=torch.bool, device=dev)
        args = (levels, uv, lvl.to(dev), sigma, mask)
        rows = []
        for kpb in (1, 2, 4, 6, 8, 12, 16):
            ms = cuda_ms_per_call(lambda: dsc.describe_upright(*args, keypoints_per_block=kpb))
            ms_dev = device_ms_per_run(lambda: dsc.describe_upright(*args, keypoints_per_block=kpb),
                                       5)[0]
            rows.append((ms, ms_dev, kpb))
        rows.sort()
        log(f"[tune] K3 B={B} {H}x{W} K={K}, ms per call by CUDA events around 20 calls back to "
            f"back (device ms by torch.profiler) by keypoints per block, best first: "
            + "; ".join(f"{ms:.4f} ({md:.4f}) {kpb}" for ms, md, kpb in rows) + f"; on {smi}")

    def unit_bf16(n):
        x = torch.randn((n, 128), generator=g)
        return (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(dev).bfloat16().contiguous()

    Kb = 133120
    pool = unit_bf16(Kb)
    for Ka, split_set in ((SERVE_BATCH * 1024, (1, 2)), (N_TAIL * 1024, (1, 2, 4, 8, 12, 16, 24, 32, 64))):
        q = unit_bf16(Ka)
        rows = []
        for tile_rows in (64, 128):
            for stages in (2, 3, 4, 5, 6, 8):
                if stages * tile_rows * 256 + 1024 > ss.SMEM_BYTES:
                    continue
                for splits in split_set:
                    def run(tile_rows=tile_rows, stages=stages, splits=splits):
                        mt._match_top2_cuda(q, pool, splits, tile_rows, stages)

                    ms = cuda_ms(run, reps=5, warm=1)
                    ms_dev = device_ms_per_run(run, 5)[0] if Ka < 4096 else float("nan")
                    rows.append((ms, ms_dev, tile_rows, stages, splits))
        rows.sort()
        flop = 2.0 * Ka * Kb * 128
        log(f"[tune] K4 {Ka} x {Kb} x 128 bf16 ({flop / rows[0][0] / 1e9:.1f} TFLOP/s at the best), "
            f"ms by CUDA events (device ms by torch.profiler) for (tile rows, stages, splits), "
            f"best first: " + "; ".join(f"{ms:.3f} ({md:.3f}) {t} {st} {sp}"
                                        for ms, md, t, st, sp in rows) + f"; on {smi}")

    # K5: pairs of one row image a block and ring depth, on the exhaustive
    # build's shape (96 images x 1024 random unit descriptors, ~90 % valid)
    from sfmx_torch.kernels import pairs as mp

    x = torch.randn((N_BUILD, 1024, 128), generator=g)
    d5 = (x / torch.linalg.vector_norm(x, dim=2, keepdim=True)).to(dev)
    m5 = (torch.rand((N_BUILD, 1024), generator=g) < 0.9).to(dev)
    p5 = np.array([(a, b) for a in range(N_BUILD) for b in range(a + 1, N_BUILD)], np.int32)
    out5 = (torch.empty((len(p5), 1024), dtype=torch.float32, device=dev),
            torch.empty((len(p5), 1024), dtype=torch.int32, device=dev),
            torch.empty((len(p5), 1024), dtype=torch.bool, device=dev))
    rows = []
    for per_block in (1, 2, 4, 8, 16, 32):
        for stages in (2, 3, 4, 5, 6):
            def k5(per_block=per_block, stages=stages):
                mp.launch(d5, m5, p5, out=out5, ratio=0.85, name="tune", pairs_per_block=per_block,
                          stages=stages)

            rows.append((kernel_ms(k5), per_block, stages))
    rows.sort()
    flop = 2.0 * len(p5) * 1024 * 1024 * 128
    log(f"[tune] K5 {len(p5)} pairs x 1024 x 1024 x 128 bf16 (both directions: "
        f"{2 * flop / rows[0][0] / 1e9:.1f} TFLOP/s of products at the best, "
        f"{flop / rows[0][0] / 1e9:.1f} of the function), device ms by torch.profiler for "
        f"(pairs per block, stages), best first: "
        + "; ".join(f"{ms:.3f} {pb} {st}" for ms, pb, st in rows) + f"; on {smi}")
    del d5, m5, out5

    for tag, (C, P, O, tp, window, longs) in {"512 cameras": (512, 20000, 200000, 32, 16, 0),
                                              "build-sized": (96, 2267, 36000, 64, 24, 100)}.items():
        prob = {k: torch.as_tensor(v, device=dev) for k, v in
                ba_problem(C, P, O, seed=0, window=window, perturb=0.03, long_tracks=longs).items()}
        dense = sg.build_dense_obs(prob["pt_id"], prob["cam_id"], P, C, tp)
        uvw = sg.pack_rows(dense, torch.cat([prob["uv"], prob["w_valid"][:, None]], 1))
        cam19 = sg.build_cam_table(prob["intr"], prob["k_idx"], prob["R"], prob["t"])
        x3 = prob["X"].T.contiguous()
        asm = sg.AssembleFused(dense, uvw)
        _U, _bc, v13, Wp = asm(cam19, x3, 0.008)
        rows = []
        for groups in (1, 2, 4, 8, 16):
            def k7(groups=groups):
                asm(cam19, x3, 0.008, groups=groups)

            rows.append((launch_device_ms(k7, 20)[0], cuda_ms(k7, reps=21, warm=3), groups))
        rows.sort()
        log(f"[tune] K7 {tag} C={C} P={P} O={int(dense.cnt.sum())} tp={tp}, device ms (mean "
            f"traced launches) [call ms by CUDA events] by slot groups, best first: "
            + "; ".join(f"{md:.4f} [{ms:.4f}] {gr}" for md, ms, gr in rows) + f"; on {smi}")
        cross = sg.SchurMatvec(Wp, dense, schur._damp_inv3_rows(v13[:9], 1e-4).contiguous())
        xv = torch.randn((6, C), generator=g).to(dev)
        parts = []
        for groups in (1, 2, 4, 8, 16, 32):
            ms = cuda_ms(lambda: cross(xv, groups=groups), reps=21, warm=3)
            ms_dev, by_name, _t = device_ms_per_run(lambda: cross(xv, groups=groups), 20)
            parts.append(f"{groups}: {ms:.4f} call, {ms_dev:.4f} device ("
                         + " + ".join(f"{t:.4f}" for t in by_name.values()) + ")")
        log(f"[tune] K6 {tag} C={C} P={P} O={int(dense.cnt.sum())} tp={tp} (longest track "
            f"{int(dense.cnt.max())}), ms by slot groups: " + "; ".join(parts) + f"; on {smi}")
        nc = 4
        cams = torch.cat([sg.build_cam_table(prob["intr"], prob["k_idx"], prob["R"],
                                             prob["t"] + 0.01 * c) for c in range(nc)], 0)
        xs = torch.cat([(prob["X"] + 0.005 * c).T for c in range(nc)], 0).contiguous()
        cost8 = sg.CostFused(dense, uvw)
        rows = []
        for groups in (1, 2, 4, 8, 16):
            for stage in (True, False):
                def k8(groups=groups, stage=stage):
                    cost8(cams, xs, 0.008, nc, groups=groups, stage=stage)

                rows.append((device_ms_per_run(k8, 20)[0], cuda_ms(k8, reps=21, warm=3), groups, stage))
        rows.sort()
        log(f"[tune] K8 {tag} nc={nc} (camera tables {19 * nc * C * 4 / 1024:.1f} KB), device ms by "
            f"torch.profiler [call ms by CUDA events] by (slot groups, "
            f"tables staged), best first: "
            + "; ".join(f"{md:.4f} [{ms:.4f}] {gr} {st}" for md, ms, gr, st in rows) + f"; on {smi}")

    # where a call's host time goes (the last system above): the CUDA-event
    # time of one K6 call is the host's path to its second launch
    def host_us(fn, n: int = 2000) -> float:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    a, b = torch.randn((C, 6), generator=g).to(dev), torch.randn((C, 6), generator=g).to(dev)
    f32 = torch.float32
    probes = {
        "bound K6 call": lambda: cross(xv),
        "one-shot K6 wrapper": lambda: sg.schur_cross_matvec(Wp, dense, cross.Vinv9, xv),
        "one-shot K8 wrapper, nc=4": lambda: sg.ba_cost_fused(cams, dense, uvw, xs, 0.008, nc=nc),
        "bound K8 call, nc=4": lambda: cost8(cams, xs, 0.008, nc),
        "two torch.empty": lambda: (torch.empty((3, P), dtype=f32, device=dev),
                                    torch.empty((6, C), dtype=f32, device=dev)),
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_build.stream_ptr": lambda: _build.stream_ptr(dev),
        "a + b on (C,6)": lambda: a + b,
        "torch.sum(a * b)": lambda: torch.sum(a * b),
    }
    log("[tune] host us per call, back to back without a sync: "
        + "; ".join(f"{k} {host_us(fn):.2f}" for k, fn in probes.items()) + f"; on {smi}")


def main() -> int:
    import torch

    if "--cards" in sys.argv[1:]:
        return main_cards(int(sys.argv[sys.argv.index("--cards") + 1]),
                          "--share-card" in sys.argv[1:])
    name, smi = phase_device()
    sys.path.insert(0, str(ROOT))
    import sfmx_torch  # noqa: F401  (sets the TF32 flags)
    from examples import room
    from sfmx_torch.solvers import umeyama
    from tests import smoke_scenes

    t_start = time.perf_counter()
    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    phase_build()
    if "--tune" in sys.argv[1:]:
        phase_tune(dev, smi)
        return 0
    tex = room.RoomTexture(seed=0)
    probe = render(tex, query_poses())
    phase_kernels(probe, dev)
    lmap, kf = phase_map(tex, dev)
    frames, launches = phase_queries(tex, lmap, dev)
    phase_crosscheck(frames, lmap, dev)
    extract, localize = query_path(frames, lmap, dev)
    wall = phase_rate(extract, localize, len(frames), smi)
    if profile:
        phase_profile({"extraction": extract, "localization": localize}, wall, smi,
                      "query", len(frames))
    phase_tracking(frames, lmap, dev)

    big = phase_map_scale(kf, dev)
    t0 = time.perf_counter()
    serve_frames = smoke_scenes.render_parallel(0, serve_poses(), W_IMG, H_IMG, FOCAL,
                                                RENDER_WORKERS)
    own_frames = smoke_scenes.render_parallel(0, serve_poses()[:2], W_IMG, H_IMG, FOCAL_OWN,
                                              RENDER_WORKERS)
    log(f"[serve] {len(serve_frames) + len(own_frames)} held-out frames rendered in "
        f"{time.perf_counter() - t0:.1f} s")
    # K1-K3 again at the serving run's batch shapes: a full batch of 32 (its
    # errors and times go into the kernels line beside the serving-run
    # launches) and the tail batch of the two own-intrinsics requests
    kstats = phase_kernels(serve_frames[:SERVE_BATCH], dev, profile)
    phase_kernels(own_frames, dev, profile)
    kstats["match_top2"] = phase_k4(big, serve_frames, dev, smi, profile)
    serve_launches, _ = phase_serve(big, serve_frames, own_frames, dev, smi)
    s_extract, s_localize, s_state = streaming_path(serve_frames, big, dev)
    phase_streaming_crosscheck(big, s_state, dev)
    s_wall = phase_rate(s_extract, s_localize, SERVE_BATCH, smi, label="streaming path")
    if profile:
        phase_profile({"extraction": s_extract, "streaming localization": s_localize},
                      s_wall, smi, "streaming", SERVE_BATCH)

    front_stats, front_launches, build_frames, build_poses = phase_front_end(dev, smi, profile)
    kstats.update(front_stats)

    phase_ba_kernels(dev, smi, profile)
    kstats["segment_sum"] = phase_segment_sum(dev, smi)
    scene, b_feats, b_tt, sim, map_launches, ba_stats, map_stats = phase_build_map(
        build_frames, build_poses, dev, smi, profile)
    kstats.update(ba_stats)
    phase_loop(tex, scene, b_feats, b_tt, sim, dev)
    phase_ba_crosscheck(dev)

    # the rest of reconstruction: each path's launches counted from 0
    new_paths = {"checkpointed final BA": phase_ckpt(build_frames, build_poses, scene, dev, smi)}
    new_paths["components"], _fusion = phase_components(dev, smi, profile)
    new_paths["merge"] = phase_merge(build_frames, build_poses, dev, smi)
    new_paths["self-calibration"] = phase_selfcal(build_frames, build_poses, dev, smi, profile)
    # the single-device rest (phases 25-29): each path's launches counted from 0
    eyes = torch.as_tensor(np.stack([e for _R, _t, e in build_poses]), dtype=torch.float32,
                           device=dev)
    ate18 = float(umeyama.ate_rmse(scene.centers, eyes, scene.cam_alive)[0])
    rest_paths = {}
    rest_paths["cli"], cli = phase_cli(build_frames, build_poses, tex, dev, smi, ate18)
    rest_paths["streaming"] = phase_streaming(build_frames, dev, smi)
    rest_paths["oriented"] = phase_oriented(build_frames, dev, smi)
    rest_paths["sift"] = phase_sift(build_frames, build_poses, dev, smi)
    rest_paths["determinism"] = phase_determinism(cli, dev, smi)
    # the multi-device paths on one card (phases 30-33): each counted from 0
    rest_paths["serve shards"], _ = phase_serve(big, serve_frames, own_frames, dev, smi,
                                                shards=2)
    rest_paths["sharded"], k4_shard_ms = phase_sharded(big, serve_frames, dev, smi)
    phase_block_ba(dev, smi)
    rest_paths["dryrun"] = phase_dryrun(dev, smi)
    # bench.py's functions on the port (phase 41): each counted from 0
    rest_paths["bench"] = phase_bench(dev, smi)
    # the evaluation configs (phase 42): each counted from 0
    rest_paths["configs"] = phase_configs(dev, smi)
    # serve as its own process on phase 25's map (phase 44): the server's
    # launches during the traffic, read from its own lines
    rest_paths["serve process"], _ = phase_serve_process(
        cli["store"], cli["queries"], cli["q_eyes"], np.stack([e for _R, _t, e in build_poses]),
        dev, smi)
    kstats["match_top2"]["shard_ms"] = {str(n): v for n, v in k4_shard_ms.items()}
    ext = ("diffuse_segment", "response_levels", "describe_upright")
    ba = ("match_pairs_fused", "schur_cross_matvec", "ba_assemble_fused", "ba_cost_fused")
    rest_need = {"cli": ext + ba, "streaming": ext + ba, "oriented": ext[:2], "sift": ba,
                 "determinism": ext + ba, "serve shards": ext, "sharded": ("match_top2",),
                 "dryrun": ext + ("match_top2", "match_pairs_fused"),
                 "bench": ext + ("match_top2",) + ba,
                 "configs": ext + ("match_pairs_fused", "segment_sum"), "serve process": ext}
    for tag, got in rest_paths.items():
        log(f"[counters] {tag} launches {json.dumps(got)}")
        assert all(got.get(k, 0) > 0 for k in rest_need[tag]), f"{tag}: launches {got}"
    for tag, got in new_paths.items():
        log(f"[counters] {tag} launches {json.dumps(got)}")
        # every path but the merge runs K5 (the checkpointed path in its
        # build_map) and its BA on K6-K8; merge_scenes registers on the
        # host and takes the planes path, as the reference's does
        need = () if tag == "merge" else ("match_pairs_fused", "schur_cross_matvec",
                                          "ba_assemble_fused", "ba_cost_fused")
        if tag in ("merge", "self-calibration"):
            # the joint BA's planes path, the joint intrinsics system: their
            # sums are the fixed-order segment sum's
            need += ("segment_sum",)
        assert all(got.get(k, 0) > 0 for k in need), f"{tag}: launches {got}"

    check_launches("gather path", launches, extraction_launches())
    log(f"[counters] serving-run launches {json.dumps(serve_launches)}")
    for k in SERVE_KERNELS:
        assert serve_launches.get(k, 0) > 0, f"{k} was not launched in the serving run"
    log(f"[done] {time.perf_counter() - t_start:.1f} s after the device check")

    log(f"[counters] build_map launches {json.dumps(map_launches)}")
    # K5-K8 add the launches of the new paths (phases 21-24) to their own:
    # each path's runs counted from 0, not the solves they are compared with
    path_launches = {**{k: serve_launches[k] for k in SERVE_KERNELS}, **front_launches,
                     **{k: map_launches.get(k, 0) for k in ("schur_cross_matvec",
                                                            "ba_assemble_fused", "ba_cost_fused",
                                                            "segment_sum")}}
    for got in new_paths.values():
        for k in ("match_pairs_fused", "schur_cross_matvec", "ba_assemble_fused",
                  "ba_cost_fused", "segment_sum"):
            path_launches[k] += got.get(k, 0)
    # and every kernel the launches of phases 25-29's paths
    for got in rest_paths.values():
        for k in KERNELS:
            path_launches[k] += got.get(k, 0)
    kernels = [{"name": k, "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
                "launches": path_launches[k], **kstats[k]} for k in KERNELS]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
