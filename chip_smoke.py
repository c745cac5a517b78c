#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on an NVIDIA GPU.

    python3 chip_smoke.py                   # every phase, one card
    python3 chip_smoke.py --mesh-cards 4    # [mesh] alone, a card a rank

Phases, each printing one line; any failure raises and the script exits
non-zero:

1. device  — require CUDA; print the card's name and power limit as
             nvidia-smi gives them, on a line of their own
2. build   — compile the kernels (slam_tpu_torch/csrc, one nvcc per
             source, in parallel) and link them, timed
3. K1      — fused ICP kernel vs its plain PyTorch version at the main
             path's shapes (B=1024, S=384, C=512), with degenerate robots
             below the ok gates, and on fleets (S=384 and S=2048) with
             robots whose GA or NGA class is off, a robot without a scene,
             and equal model points of one class with other-class points
             between them
4. K4      — nearest-neighbour kernel vs its plain version, idx equal on
             every query and dist equal in bits: the main path's shapes
             (B=1024, S=384, C=512) through nearest_neighbor (the model a
             view of (B, C, 3)) and nearest_neighbor_planes (class -1
             pads), exact duplicate model points, robots with a class
             nearly empty, empty or without a model, unconstrained classes,
             the model walked in tiles
5. guard   — K1 vs icp_fit (which runs on K4), as bench.py's kernel guard
6. K5      — particle-scoring kernel vs its plain version at config 5's
             shapes (B=1024, N=96 of a 384-point scan read at stride 4,
             and all 384 at stride 1; P=128 and P=1; G=192), for one
             shared table and for per-robot tables, with robots that have
             no valid point, particles off the grid, points on cell edges,
             NaN counts, resolution 0.3 and a 100 x 100 grid: fractions
             must be equal, and the bit tables equal their plain version
7. K3      — tiled fused ICP kernel vs its plain version at the reference
             scale's shapes (B=16, S=4096, C=40960): a full problem, and
             the main path's occupancy (70 scene and 140 model points, in
             the first slots and scattered over all of them, with a robot
             without a scene and robots with one class off); on a problem
             whose exact duplicate model points sit in different model
             splits; vs K1's plain version on a problem both take (S=512,
             C=4096); repeated calls must give the same bits; and K2 on
             packed problems above RESIDENT_TILE_LIMIT (B=16, S=C=2048),
             which it sends to K3, vs its plain version
8. main    — config 1: slam2d.rollout at sim2d_config for a fleet of 1024
             robots, 40 ticks with the default "fused" matcher (K1), and a
             fresh fleet for 8 ticks with the "points" matcher (K4), after
             a warm-up macro, and K4 held to its plain version on one more
             macro's calls; kernel launch counts, median per-robot ATE,
             robot-steps/s, ms/tick of both
9. K2      — register_scan_to_scan (matcher "fused": K2, the packed adapter
             onto K1's kernel) on the fleet's last two scenes, vs its plain
             version
10. pf     — config 5: parallel.shared_map.fleet_rollout_shared, particle
             matcher (K5) against one shared map, B=1024, 10 macros of 4
             ticks after a warm-up macro; ms/tick, robot-steps/s, median
             per-robot ATE, K5 launches (two scorings and one bit table a
             tick)
11. 3d     — config 2: slam3d.rollout_3d at sim3d_config, B=128, 40 ticks
             with the "fused" matcher (K1) after a warm-up macro; ms/tick,
             robot-steps/s, K1 launches, median per-robot ATE, mean |z error|
12. ref    — config 2 at ref_scale_config (20,480-ray scans, scene 4096,
             map 40,960: the "fused" matcher takes K3), B=16, 16 ticks after
             a warm-up macro; ms/tick, robot-steps/s, K3 launches, ATE, z
             error and the share of ticks whose registration succeeded
13. graph  — config 4: slam2d.rollout_with_graph at sim2d_graph_config
             (bench.py's config 4 shapes: 32 keyframes of 384 points, 128
             edges, "grid" regeneration on 256 x 256 cells), B=256, a
             warm-up macro on another fleet, then 12 macros of 8 ticks and
             a graph tick: ms/tick, robot-steps/s, the graph tick's ms, K1 /
             K2 / K4 launches, median per-robot ATE (gate), every robot >= 2
             keyframes and >= 1 edge, finite poses; K2 against its plain
             version on one recorded graph tick's (B*4, 384, 384) edge
             problems at 50 iterations, timed with its bound; an eviction
             run (0.5 m keyframe gate, 40 macros: every graph fills and
             evicts; finite, full; edges_dropped printed); host syncs one
             graph_update makes under torch.cuda.set_sync_debug_mode
14. mls    — config 3: MLS mapping with FFT relocalization at
             sim2d_reloc_config (bench.py's bench_mls_reloc shapes: a 192 x
             192 search raster, 32 rotations), B=128, a warm-up macro on
             another fleet, then 8 macros of 4 fused ticks (K1), each
             folding the last scene into the robots' MLS grids and
             relocalizing the lost robots; robot 0's belief is kidnapped
             by (8 m, -5 m, 1.2 rad) and flagged lost at macro 4, and one
             more macro runs without a kidnap: ms/tick, the ms of a
             macro that relocalizes and of one that does not, host syncs a
             macro, robot 0's distance to its true pose before and after
             (gate), the robots not lost untouched bit for bit (gate), the
             healthy robots' median ATE (gate), drivable cells on every
             robot and a finite grid (gate); K4 held to its plain version
             on the polish's calls, the FFT search on the card against its
             plain CPU path on robot 0's problem
15. regen  — config 4 at sim2d_graph_config with the "voxel" and then the
             "mls" regeneration, B=256, 8 macros each after a warm-up
             macro (robots drive ~0.1 m a tick, and a second keyframe
             needs 5 m): ms/tick, graph tick ms, device ops and host syncs
             of a graph tick (gate 0), median ATE, finite target, >= 2
             keyframes (gates); after the voxel run one
             apply_relocalization_graph on robot 0 kidnapped as in [mls]
             (its edge injected, poses finite)
16. graph3d — config 4 in 3D at the reference's working point:
             slam3d.rollout_3d_with_graph at ref_scale_graph_config (the
             long mission's budgets: 64 keyframes of 2,048 points, 320
             edges, edge_min_corr 30; engine "se2z" over planar edges),
             B=16, a warm-up macro on another fleet, then 12 macros of 8
             ticks (K3 on every tick: S x C = 4096 x 40960) and a graph
             tick (K2's 2,048 x 2,048 edge problems go to K3): ms/tick,
             graph tick ms, host syncs of one graph tick and its
             ground-map offset (gate 0 with icp.loop "scan" and "while":
             the tick runs no loop fit), median ATE and mean |z error|,
             >= 2 keyframes and >= 1 edge a robot, finite poses, graph and
             ground map (gates); K3 on the recorded edge problems against
             its plain version under [graph]'s near-tie rule, timed with
             its bound; K4 on that tick's edge information equal to plain
17. se3    — config 4 in 3D with the 6-DoF chain at sim3d_se3_config
             (engine "se3", 3D ICP edges in plain PyTorch, 6 x 6 LUM
             information, optimize_native), B=128, 6 macros of 8 ticks
             (K1) after a warm-up macro, then 4 macros of engine "se3"
             over planar edges (K2, K4), each with icp.loop "scan":
             ms/tick, graph tick ms, host syncs (gate 0); the 3D-edge run
             again with "while" (ms/tick, graph tick ms, at most
             edge_icp_max_iter + 1 host syncs a graph tick, all
             icp3d_fit's), slam_tpu's own test bounds (median ATE <
             0.6 m, the 0.99 quantile robot's nodes within 0.8 m of its
             true path, mean |z error| < 0.15 m), node_rp finite; K1 on
             the last tick's registration, K2 on the planar edge problems
             (512 of 1,024 x 1,024) of the graph tick with the most points
             against their plain versions under [graph]'s near-tie rule,
             K4 on that tick's edge information equal to plain; a 6-DoF
             relocalization edge injected on a kidnapped robot and
             optimize_native after it, finite; the Kabsch rotation
             (Jacobi SVD in tensor ops) on the card against the f64 SVD,
             with 0 host syncs
18. refgrid — config 2 at the reference's working point with the "grid"
             matcher (bench.py's bench_ref_scale configuration:
             ref_scale_config, 20,480-ray scans, a scene of 4,096, a 384 x
             384 map grid at 0.5 m, height source "grid"), B=16, 16 ticks
             after a warm-up macro: ms/tick, robot-steps/s, device ops a
             tick and a field build, median raw and aligned ATE, mean |z
             error|, the share of ticks that registered; gates: ATE, z,
             every robot registered on its last tick, no K1 / K3 / K4
             launch, no host sync in one macro with icp.loop "scan"; the
             same run with "while" (ms/tick, ATE and z, at most
             max_iterations + 1 host reads a fit); the last macro's field on
             the card equal to the CPU path's from the same grid (valid and
             n_class exact, px / py within 1e-5 m but at near-ties, which
             are counted), icp_fit_grid on the last tick's scenes within
             1e-3 of the CPU run with ok equal
19. grid2d — config 1 with the "grid" matcher (examples/run_fleet.py
             --matcher grid) at sim2d_config, B=1024, 40 ticks after a
             warm-up macro, with icp.loop "scan" and "while": ms/tick,
             median ATE (gate), no K1 or K4 launch, in one macro no host
             sync ("scan") or at most max_iterations + 1 a fit ("while");
             build_scene_planes on the card:
             the fleet's last scans through the "incidence" and "grid"
             builders, and 16 robots' 8,192-beam scans through "auto"
             (grid) and "incidence" (compacted into 4,096 slots), each
             robot with the same centroids and GA flags from both
20. div    — cell indices of t / python_float against a true division by
             a 0-dim tensor on the card at each site that divides by a
             configured width (ground sector and range bin at sim3d and the
             reference scale, occupancy at 0.2 m), counted on random values
             and on values at cell edges; the port's binning
             (ops/ground.polar_bins, mapping/occupancy.cells_of and a whole
             add_to_occupancy_xy at 0.2 m) must equal the CPU's
21. time   — K1, K2, K3, K4 and K5 timed alone against their plain
             versions at their main path's shapes (K3 on the full and on
             the sparse problem), beside the least time the card could take
             for the same work; K4 and K5 (P=128 and P=1) both as the
             wrapper's call and as the C entry point alone (device time,
             launches queued back to back), and K5's bit
             table alone; K1 against K3 on problems both take around
             RESIDENT_TILE_LIMIT; the device operations one
             nearest_neighbor, score_particles and pf_match call runs
             (counted right after [pf], before any large profiler session)
22. live   — the live-frame path (slam_tpu_torch.live, examples/run_live.py
             's counterpart), run within [time], after its device ops a
             call and before its large profiler sessions: sim2d_config, one
             robot, 200 frames of synth_frames written to a replay file,
             replayed by the native ScanLoader into a FrameRing and
             consumed on the card by live.GraphedStep (every stage but K4
             replayed from CUDA graphs, K4 through its wrapper) after
             live.warm_up: paced at 100 Hz into 32 slots (0 dropped, gate)
             and unpaced (frames/s); ms/frame, median position error
             against the true poses (gate), the graphed step's poses
             against consume's (gate), consume's own ms/frame and device
             ops a frame (frames 16-19, before any graph exists; its
             canaries must show, as every count's: device_ops), K4 launches
             and K4 held to its plain version on every recorded call
             (its arguments cloned at the call), host syncs a frame and
             their sites
23. entry  — the user entry points' run() on the card at full width (after
             [time]'s device-op counts, before [fiducial]):
             run_fleet (B=1024, 40 steps twice, the second timed: "fused",
             "points", "grid", --shared-map "fused" and "particle"),
             run_sim2d (200 steps, with and without --graph), run_sim3d
             (sim3d, --ref-scale), run_reloc (--graph --save-pcd, then
             --prior-pcd), eviction_study (--max-nodes 16 and 64, 128
             macros), make_replay (100 frames, equal to synth_frames' bit
             for bit, replayed by the native loader into live.consume);
             gates: PERF.md's accuracy bounds for each configuration
             (at the reference scale z to sim3d's 0.4 m: its 0.1 m fails
             over 60 steps in slam_tpu too, tests/test_torch_ref_height.py),
             every robot registered after both shared-map runs, each
             path's kernels launched; K1, K2, K4 and K5 held to their
             plain versions on recorded calls (arguments cloned)
24. fiducial — the camera periphery at the reference zoom camera's
             resolution (3,876 x 2,541 px): 8 frames of 4-6 tag36h11 tags
             (150-300 px) with clutter, an illumination ramp and noise,
             through detect_tags with both segmenters at decimate 1 and 2,
             ms a frame; gates: every tag decodes with its id and
             Hamming 0 but the misses pinned per run (FID_MISSES, with
             slam_tpu's witness where a crop shows one), corners within
             1.5 px ("gradient"; one pinned to slam_tpu's own) or the
             pixel-pick bound ("cc"), no false detection; then the chain
             (detected centre -> calib.pixel_to_global -> a 400 x 400
             sample map -> extract_samples) puts a sample within 0.8 m of
             every ground point but those of the tags all four runs may
             miss, and none farther; peak device memory, host syncs a
             frame
25. mesh   — the multi-device layer (parallel/mesh.py, multihost.py,
             make_shared_map_merger, mesh_scaling), its ranks spawned
             children meeting through a file store (the kernels built
             before): NCCL with two ranks on the one card is refused on
             both; two ranks share the card through gloo (NCCL needs a
             card a rank): config 1 ("fused", K1) and config 5
             ("particle", K5, P=128, the shared grid merged by one dp
             all-reduce a macro) at B=1024, 512 robots a rank, each rank
             drawing from its own generator seeded from (seed, rank), 40
             ticks and 10 macros of 4 after a warm-up macro, certified
             against this process running the two shards in turn (poses
             within 1e-3 m, config 5's counts equal), the shared grid
             bit-identical on both ranks, ATE gates of [main] and [pf], K1
             and K5 on rank 0's recorded calls equal to their plain
             versions; ms/tick, robot-steps/s, launches a rank, each
             macro's all-reduce ms; one rank on NCCL (world 1): the same
             fleets whole on one rank, config 5's all-reduce through NCCL,
             beside [main] and [pf], and make_shared_map_merger on 1,024
             grids, equal in bits to merge_maps, NaN counts for a moved
             grid; mesh_scaling at B = 16, 32, 64 on world 1 (NCCL) and
             world 2 (gloo, one card: sharing, not scaling): finite poses
             and each world-2 rank's peak memory below world 1's (no
             throughput gate); the sp axis: dp1 x sp2 on the one card
             (gloo; --mesh-cards 4: dp2 x sp2 and dp1 x sp4 on NCCL),
             configs 1 and 5 at B=1024 with every robot's grids split by
             rows (the fleet placed from the host by shard_fleet), each
             rank against one process running its dp shard on whole grids
             from the same draws (poses within 1e-3 m, grid counts and
             flags equal, sums within 1e-4; gather_grids equal), the
             replicated state's print equal in each sp group after every
             macro and its final bits equal, the shared grid
             bit-identical on every rank, ATE gates, resident grid bytes
             a rank 1/sp of whole, host syncs of a macro (config 1) and a
             tick (config 5) no more than whole grids' (gloo's staging
             copies aside); ms/tick a rank, robot-steps/s, the
             exchanges' ms a macro, peak memory a rank; K1 and K5 held to
             plain on rank 0's last calls
Every kernel launch count is set to 0 just before a main path (8-19,
22, 23, and in each rank of 25) runs and read just after it; the JSON
record's launches add up every path's. The last two lines are the
kernels' JSON record and the device JSON. Imports torch and the port
only: no jax, no slam_tpu package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

POSE_TOL = 1e-3       # max |pose| error, kernel vs plain and K1 vs icp_fit
NCORR_TOL = 2         # max |num_corr| difference, K1 (and K2) vs plain
ATE_LIMIT = 0.1       # m, config 1: median per-robot ATE over ticks >= 10
PF_ATE_LIMIT = 0.5    # m, config 5: median per-robot ATE over ticks >= 8
FLEET = 1024
TICKS = 40
POINTS_TICKS = 8
PF_MACROS = 10        # config 5: macros of 4 ticks, after a warm-up macro
PF_SCORED = 96        # config 5: 384 scene points at score_stride 4
PF_G = 192            # config 5: shared grid cells a side (0.5 m)
ATE_3D_LIMIT = 0.5    # m, config 2 sim3d: median per-robot ATE, ticks >= 10
Z_3D_LIMIT = 0.4      # m, config 2 sim3d: mean |z error|, ticks >= 15
FLEET_3D = 128
TICKS_3D = 40
ATE_REF_LIMIT = 0.2   # m, config 2 ref scale: median ATE, ticks >= 4
Z_REF_LIMIT = 0.1     # m, config 2 ref scale: mean |z error|, ticks >= 4
OK_REF_SHARE = 0.9    # ref scale: share of ticks whose registration succeeded
FLEET_REF = 16
TICKS_REF = 16
REF_S, REF_C = 4096, 40960   # ref_scale_config's scene and map capacities
REF_SCENE, REF_TARGET = 70, 140   # valid points a robot holds on [ref]'s path
CROSSOVER_C = (256, 512, 2048)    # K1 vs K3 at B=16, S=4096: S*C = 1M, 2M, 8M
GRAPH_FLEET = 256     # config 4: robots
GRAPH_EVERY = 8       # config 4: scan ticks per graph tick
GRAPH_MACROS = 12     # config 4: timed macros, after a warm-up macro
GRAPH_ATE_LIMIT = 0.5   # m, config 4: median per-robot ATE over ticks >= 8
EVICT_MACROS = 40     # config 4 with a 0.5 m keyframe gate: graphs fill, evict
MLS_FLEET = 128       # config 3: robots (bench.py's bench_mls_reloc)
MLS_MACROS = 8        # config 3: timed macros of 4 ticks, after a warm-up macro
MLS_KIDNAP_AT = 4     # config 3: the timed macro that kidnaps robot 0
RELOC_LIMIT = 0.8     # m, robot 0's distance to its true pose after relocalizing
MLS_ATE_LIMIT = 0.1   # m, config 3: median ATE of the healthy robots, ticks >= 10
SEARCH_SCORE_TOL = 1e-4   # FFT search on the card vs the plain CPU path: score
TIE_LEAD = 0.5        # counts: a best (rotation, lag) this far ahead is unique
TIE_TOL = 1e-3        # counts: a lag this close to the best is a tie
REGEN_MACROS = 8      # config 4, "voxel" and "mls": timed macros after a warm-up
                      # (~6.4 m of driving: a second keyframe at the 5 m gate)
DIV_SAMPLES = 1 << 22   # [div]: random values a site divides
TIE_GAP = 1e-5        # m^2: a correspondence this close to a tie (or to the
                      # inlier gate) can flip between two roundings
TIE_POSE_TOL = 0.05   # m: bound on problems with such a near-tie
BIG_D2 = 1e30         # other-class pairs in tie_margin
GRAPH3D_FLEET = 16    # config 4 in 3D at the reference's working point
GRAPH3D_MACROS = 12   # its timed macros of 8 ticks, after a warm-up macro
SE3_FLEET = 128       # config 4 in 3D, the 6-DoF chain at sim3d
SE3_MACROS = 6        # its timed macros of 8 ticks, after a warm-up macro
SE3_2D_MACROS = 4     # then engine "se3" over planar edges (a 2nd keyframe)
SE3_ATE_LIMIT = 0.6   # m, median ATE over ticks >= 8 (slam_tpu's own tests'
SE3_NODE_LIMIT = 0.8  # m, a robot's farthest node from its true path
                      #    (bounds, tests/test_pipeline3d_graph.py and
SE3_Z_LIMIT = 0.15    # m, mean |z error|     tests/test_graph_se3_edges.py)
SE3_NODE_QUANTILE = 0.99  # the robot held to SE3_NODE_LIMIT: a 3D ICP edge
                      # can settle in a wrong minimum that slam_tpu's gates
                      # accept, as slam_tpu's own fit does on the same inputs
GRID_ATE_LIMIT = 0.3  # m, config 1 with matcher "grid": median ATE over
                      # ticks >= 10 (tests/test_grid_icp.py's bound)
FIELD_TOL = 1e-5      # m: the field's px / py, card vs the CPU path
FIELD_TIE = 1e-6      # m^2: two picks this close from a cell centre are a tie
WIDE_BEAMS = 8192     # [grid2d]: beams of the scans "auto" sends to the grid
WIDE_ROBOTS = 16      #           builder, robots, and the scene capacity
WIDE_CAPACITY = 4096  #           that holds their cells
ENTRY_STEPS = 40      # [entry]: run_fleet's --steps (its default), B = FLEET
ENTRY_SIM2D_STEPS = 200   # run_sim2d's default --steps
ENTRY_SIM3D_STEPS = 60    # run_sim3d's default --steps
ENTRY_RELOC_STEPS = 80    # run_reloc's default --steps
ENTRY_EVICT_MACROS = 128  # eviction_study's default --macros
ENTRY_EVICT_NODES = (16, 64)   # the --max-nodes its docstring runs
ENTRY_FRAMES = 100    # make_replay's frames, fed to live.consume
LIVE_FRAMES = 200     # [live]: frames of the replayed feed
LIVE_RATE_HZ = 100.0  # [live]: the paced feed, ten times the lidar's 10 Hz
LIVE_SLOTS = 32       # [live]: ring slots of the paced run
                      # (examples/run_live.py)
LIVE_ERR_LIMIT = 0.1  # m, config 1's bound: median position error, frames
                      # >= 10
LIVE_GRAPH_TOL = 1e-3 # m: the graphed step's poses against consume's (the map
                      # fold's float atomics add in another order each run)
FID_FRAMES = 8        # [fiducial]: frames, each 4-6 tag36h11 tags
FID_H, FID_W = 2541, 3876   # twice the reference zoom camera's principal
                            # point (calib.REFERENCE_CAMERA)
FID_TAG_PX = (150, 300)     # tag sides
FID_CORNER_TOL = 1.5  # px: the gradient segmenter's corners (line
                      # intersections) against the rendered ones
# The tags each run may miss, (frame, id) of tag_frames' layout (seed 10);
# every other tag must decode. "crop": slam_tpu misses it too on a 576 px
# crop of the same frame (tests/test_torch_fiducial_frames.py); "frame":
# both packages decode that crop, so the miss comes from the whole frame
# (no slam_tpu witness at full size; the gradient segmenter keeps an
# image's 64 largest edge components and 32 longest segments, and a frame
# holds 12 clutter blocks besides its 4-6 tags)
FID_MISSES = {
    ("cc", 1): {(0, 197): "crop", (2, 384): "crop"},
    ("cc", 2): {(0, 197): "crop", (2, 384): "crop", (3, 461): "crop"},
    ("gradient", 1): {(0, 197): "crop", (6, 0): "crop", (1, 58): "frame",
                      (2, 384): "frame"},
    ("gradient", 2): {(1, 290): "crop", (0, 197): "frame", (1, 58): "frame",
                      (2, 384): "frame"},
}
# gradient corners held to slam_tpu's own worst corner on the same crop
# (px, within FID_PINNED_TOL) instead of FID_CORNER_TOL:
# (segmenter, decimate, frame, id)
FID_CORNER_PINNED = {("gradient", 2, 1, 243): 6.54}
FID_PINNED_TOL = 0.05
FID_CHAIN_LIMIT = 0.8 # m: extracted sample to its ground point
                      # (tests/test_scan_to_scan_periphery.py's bound)
FID_GROUND = -1.3     # m: the ground plane in the lidar frame
FID_BLOB = (2.0, 0.3) # a detection's evidence, added 3 times (as
                      # tests/test_scan_to_scan_periphery.py does):
                      # amplitude, sigma [m]. Centred anywhere in a 0.5 m
                      # cell, its peak passes the map's pixel_prob_threshold
                      # without saturating a plateau, and tags 1 m apart
                      # stay separate peaks
# ground points (depth, lateral) the tags are placed at, in the lidar
# frame: three image rows, two columns, every pair >= 1 m apart
FID_SLOTS = ((8.0, 0.9), (8.0, -0.9), (5.6, 0.6), (5.6, -0.6), (4.0, 0.47),
             (4.0, -0.53))
MESH_FLEET = 1024     # [mesh]: robots of configs 1 and 5, split over the ranks
MESH_WORLD = 2        # [mesh]: ranks sharing the one card (gloo)
MESH_TICKS = 40       # [mesh] config 1: timed ticks after a warm-up macro
MESH_PF_MACROS = 10   # [mesh] config 5: timed macros of 4 ticks
MESH_MERGE_GRIDS = 1024   # [mesh]: grids make_shared_map_merger folds (NCCL)
MESH_BATCHES = (16, 32, 64)   # [mesh]: mesh_scaling's batches, world 1 and 2
MESH_SEED = 0         # [mesh]: rank r draws from rank_generator(seed, r)
MESH_POSE_TOL = 1e-3  # m: a rank's poses against one process that runs the
                      # same shards in turn (the card's atomic scatters add in
                      # another order on each run)
MESH_LIMIT_S = 300    # s: a group of ranks that has not ended by then fails
MESH_SP = ((1, 2),)   # [mesh]: (dp, sp) layouts whose grids split by rows,
                      # gloo ranks on the one card
MESH_SP_CARDS = ((2, 2), (1, 4))   # --mesh-cards 4: the layouts on NCCL
MESH_SUM_TOL = 1e-4   # the sp ranks' grid sums against one process on
                      # whole grids

# One H100 SXM (NVIDIA's data sheet): device memory rate and the f32 rate
# outside the tensor cores, for the least time a kernel's work could take.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# mangled-name fragment -> the name [build] prints
KERNEL_NAMES = {"icp_fused_planes_kernelILi1E": "icp_fused_planes_kernel<1>",
                "icp_fused_planes_kernelILi2E": "icp_fused_planes_kernel<2>",
                "k3_setup": "k3_setup", "k3_match": "k3_match",
                "nn_kernel": "nn_kernel",
                "pf_pack_kernel": "pf_pack_kernel",
                "pf_score_kernel": "pf_score_kernel",
                "pf_score_warp_kernel": "pf_score_warp_kernel"}


def ptxas_summary(path) -> list:
    """'kernel: registers, spills' for each kernel in the build's ptxas -v
    report."""
    out, name = [], "?"
    for ln in open(path).read().splitlines():
        if "entry function" in ln:
            name = next((v for k, v in KERNEL_NAMES.items() if k in ln), ln)
        elif "Used" in ln or "spill" in ln:
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def registration_problem(B, S=384, C=512, seed=0, device="cuda", span=20.0,
                         dup_stride=0, max_rot=0.05, special=False):
    """B scan-to-map problems with a known answer: each scene is a noisy,
    shifted and rotated (by up to max_rot rad) subset of its model (points
    uniform in +-span m).
    Robot 0's scene has fewer valid points than min_scene_points, robot 1's
    model fewer than 5. dup_stride > 0 copies model point i to i +
    dup_stride (exact duplicates, so nearest-point ties). With `special`
    (B >= 5) robot 2 has no valid scene point, robot 3's model holds 3 GA
    points (GA off, NGA on), robot 4's 3 NGA points (NGA off, GA on), and
    every robot's model points 8k and 8k + 3 are equal and of one class,
    with two points of the other class between them."""
    rng = np.random.default_rng(seed)
    mx = rng.uniform(-span, span, (B, C)).astype(np.float32)
    my = rng.uniform(-span, span, (B, C)).astype(np.float32)
    if dup_stride:
        mx[:, dup_stride:] = mx[:, :C - dup_stride]
        my[:, dup_stride:] = my[:, :C - dup_stride]
    mga = rng.random((B, C)) < 0.4
    mval = rng.random((B, C)) < 0.95
    if special:
        n = len(mx[0, 3::8])
        mx[:, 3::8], my[:, 3::8] = mx[:, ::8][:, :n], my[:, ::8][:, :n]
        mga[:, 3::8], mval[:, 3::8] = mga[:, ::8][:, :n], mval[:, ::8][:, :n]
        mga[:, 1::8] = ~mga[:, ::8][:, :len(mga[0, 1::8])]
        mga[:, 2::8] = ~mga[:, ::8][:, :len(mga[0, 2::8])]
        mval[3, np.flatnonzero(mval[3] & mga[3])[3:]] = False
        mval[4, np.flatnonzero(mval[4] & ~mga[4])[3:]] = False
    idx = rng.integers(0, C, (B, S))
    sx0 = np.take_along_axis(mx, idx, 1) + rng.normal(0, 0.03, (B, S))
    sy0 = np.take_along_axis(my, idx, 1) + rng.normal(0, 0.03, (B, S))
    th = rng.uniform(-max_rot, max_rot, (B, 1))
    off = rng.uniform(-0.3, 0.3, (B, 2, 1))
    sx = np.cos(th) * (sx0 + off[:, 0]) + np.sin(th) * (sy0 + off[:, 1])
    sy = -np.sin(th) * (sx0 + off[:, 0]) + np.cos(th) * (sy0 + off[:, 1])
    sga = np.take_along_axis(mga, idx, 1)
    sval = rng.random((B, S)) < 0.97
    if B >= 2:
        sval[0] = False
        sval[0, :3] = True
        mval[1] = False
        mval[1, :4] = True
    if special:
        sval[2] = False

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return dict(sx=t(sx), sy=t(sy), s_valid=t(sval, torch.bool),
                s_ga=t(sga, torch.bool), mx=t(mx), my=t(my),
                m_valid=t(mval, torch.bool), m_ga=t(mga, torch.bool),
                init=torch.zeros(B, 3, device=device))


def sparse_problem(B, S, C, n_scene, n_model, scattered, seed=0,
                   device="cuda"):
    """A registration_problem(special) of n_scene scene and n_model model
    points (+-20 m) in S scene and C model slots, the other slots invalid:
    the occupancy of the reference scale's scenes and targets. The points
    fill the first slots, or with `scattered` random slots over the whole
    range, in their order."""
    p = registration_problem(B, n_scene, n_model, seed=seed, device=device,
                             max_rot=0.01, special=True)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)

    def slots(n, N):
        if not scattered:
            return torch.arange(n).expand(B, n).to(device)
        return torch.stack([torch.randperm(N, generator=gen)[:n].sort().values
                            for _ in range(B)]).to(device)
    s_at, m_at = slots(n_scene, S), slots(n_model, C)

    def spread(v, at, N):
        return torch.zeros((B, N), dtype=v.dtype, device=device).scatter_(
            1, at, v)
    return dict(
        sx=spread(p["sx"], s_at, S), sy=spread(p["sy"], s_at, S),
        s_valid=spread(p["s_valid"], s_at, S),
        s_ga=spread(p["s_ga"], s_at, S), mx=spread(p["mx"], m_at, C),
        my=spread(p["my"], m_at, C), m_valid=spread(p["m_valid"], m_at, C),
        m_ga=spread(p["m_ga"], m_at, C), init=p["init"])


def fused_operands(p):
    from slam_tpu_torch.ops.icp_fused import (encode_model_class,
                                              encode_scene_class)
    return (p["sx"], p["sy"],
            encode_scene_class(p["s_valid"], p["s_ga"]).contiguous(),
            p["mx"], p["my"],
            encode_model_class(p["m_valid"], p["m_ga"]).contiguous(),
            p["init"])


def cuda_ms(fn, reps=5) -> float:
    """Mean milliseconds per call, CUDA events around `reps` calls after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_ms(fn, reps=20) -> float:
    """Mean device milliseconds per launch of `fn` (a C entry point called
    with fixed arguments): the launches are queued behind a sleep kernel,
    so they run back to back and the host's cost of issuing them (ctypes,
    tens of microseconds) is not in the time."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def agreement(name, got, ref, not_ok=(0, 1)) -> dict:
    """A fused-ICP kernel's result against a plain version's: pose within
    POSE_TOL, ok equal, num_corr within NCORR_TOL; the robots `not_ok` are
    refused and every other one is accepted."""
    torch.cuda.synchronize()
    err = float((got.pose - ref.pose).abs().max())
    ok_mism = int((got.ok != ref.ok).sum())
    dcorr = int((got.num_corr - ref.num_corr).abs().max())
    want_ok = torch.ones_like(got.ok)
    want_ok[list(not_ok)] = False
    if not bool((got.ok == want_ok).all()):
        raise RuntimeError(f"{name}: ok gates wrong: {got.ok.tolist()}")
    if not bool(torch.isfinite(got.pose).all()):
        raise RuntimeError(f"{name} returned non-finite poses")
    if err > POSE_TOL or ok_mism or dcorr > NCORR_TOL:
        raise RuntimeError(f"{name} disagrees with its plain version: pose "
                           f"err {err}, ok mismatches {ok_mism}, "
                           f"|d num_corr| {dcorr}")
    return dict(pose_err=err, ok_mismatch=ok_mism, dcorr=dcorr)


def check_k1(cfg, B=FLEET, seed=0) -> dict:
    """K1 vs its plain version at the main path's shapes, on a fleet of 64
    with the special robots of registration_problem (classes off, no
    scene, separated duplicates), and the same at S=2048, where the kernel
    keeps two scene points a thread; the largest disagreement."""
    from slam_tpu_torch.ops import icp_fused
    out = []
    for b, S, special, not_ok in ((B, 384, False, (0, 1)),
                                  (64, 384, True, (0, 1, 2)),
                                  (16, 2048, True, (0, 1, 2))):
        ops = fused_operands(registration_problem(b, S, seed=seed,
                                                  special=special))
        out.append(agreement(
            "K1", icp_fused.icp_fused_planes(*ops, cfg),
            icp_fused.icp_fused_planes_reference(*ops, cfg), not_ok))
    return {k: max(r[k] for r in out) for k in out[0]}


def replay(lib, name, call):
    """Run `call` once, recording the arguments it passes to the C entry
    point `name` of `lib`; return (its result, a function that launches
    that entry point alone with the same arguments). The result holds the
    outputs the arguments point to, so keep it while replaying."""
    fn, rec = getattr(lib, name), []
    setattr(lib, name, lambda *a: rec.append(a) or fn(*a))
    try:
        out = call()
    finally:
        setattr(lib, name, fn)
    args = rec[-1]
    return out, lambda: fn(*args)


def same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def nn_plain(q, m, m_valid, q_class=None, m_class=None):
    """nearest_neighbor's plain version on the card: the planes it builds
    for the CPU, through nearest_neighbor_reference."""
    from slam_tpu_torch.ops import nn
    if q_class is None or m_class is None:
        qc = torch.zeros(q.shape[:-1], device=q.device)
        mc = torch.zeros(m.shape[:-1], device=m.device)
    else:
        qc, mc = q_class.float(), m_class.float()
    return nn.nearest_neighbor_reference(
        q[..., 0], q[..., 1], qc, m[..., 0], m[..., 1],
        torch.where(m_valid, mc, 2.0))


def nn_inputs(p):
    """nearest_neighbor's operands on a registration_problem, as the
    "points" matcher passes them: queries (B, S, 2), the model a view of
    (B, C, 3), bool valid and GA masks."""
    m3 = torch.stack([p["mx"], p["my"], torch.zeros_like(p["mx"])], -1)
    return (torch.stack([p["sx"], p["sy"]], -1), m3[..., :2], p["m_valid"],
            p["s_ga"], p["m_ga"])


def check_k4(B=FLEET, seed=1) -> dict:
    """K4 against its plain version, idx equal on every query and dist
    equal in bits: the main path's shapes through nearest_neighbor (model
    strided from (B, C, 3)) and through nearest_neighbor_planes (with
    class -1 pads); exact duplicate model points (ties); the special robots
    (a class nearly empty, no scene, no model, the GA class empty);
    unconstrained classes; the model
    walked in tiles of 100 points."""
    from slam_tpu_torch.ops import nn
    main = registration_problem(B, seed=seed)
    small = registration_problem(64, seed=seed + 1)
    special = registration_problem(64, seed=seed + 3, special=True)
    special["m_valid"][5] = False                  # no model point
    special["m_valid"][6] &= ~special["m_ga"][6]   # no GA model point
    cases = {
        "main": (nn.nearest_neighbor, nn_plain, nn_inputs(main)),
        "planes": (nn.nearest_neighbor_planes, nn.nearest_neighbor_reference,
                   fused_operands(main)[:6]),
        "ties": (nn.nearest_neighbor, nn_plain, nn_inputs(
            registration_problem(256, seed=seed + 2, dup_stride=7))),
        "special": (nn.nearest_neighbor, nn_plain, nn_inputs(special)),
        "unconstrained": (nn.nearest_neighbor, nn_plain,
                          nn_inputs(main)[:3]),
    }
    cases["tiles of 100"] = (
        lambda q, m, mv, qg, mg: nn._launch(q[..., 0], q[..., 1], qg,
                                            m[..., 0], m[..., 1], mv, mg,
                                            tile=100),
        nn_plain, nn_inputs(small))
    out = {}
    for label, (fn, plain, args) in cases.items():
        idx, dist = fn(*args)
        ridx, rdist = plain(*args)
        torch.cuda.synchronize()
        mism = int((idx != ridx).sum())
        if mism or not same_bits(dist, rdist):
            raise RuntimeError(f"K4 ({label}) disagrees with its plain "
                               f"version: {mism} idx mismatches, "
                               f"{int((dist != rdist).sum())} dist")
        out[label] = float((dist - rdist).abs().max())
    return dict(max_abs_err=max(out.values()), idx_mismatch=0, cases=out)


def kernel_guard(cfg_mod) -> float:
    """bench.py's kernel guard problem: K1 against icp_fit (on K4)."""
    from slam_tpu_torch.ops import icp_fused
    from slam_tpu_torch.ops.icp import icp_fit
    cfg = cfg_mod.IcpConfig(max_iterations=10, inlier_dist=2.0,
                            min_delta=1e-6)
    rng = np.random.RandomState(7)
    C, S = 768, 384
    mx = rng.uniform(-20, 20, C).astype(np.float32)
    my = rng.uniform(-20, 20, C).astype(np.float32)
    mga = rng.rand(C) < 0.4
    mvalid = rng.rand(C) < 0.95
    idx = rng.choice(C, S)
    th = 0.04
    c0, s0 = np.cos(th), np.sin(th)
    sx0 = mx[idx] + rng.normal(0, 0.03, S).astype(np.float32)
    sy0 = my[idx] + rng.normal(0, 0.03, S).astype(np.float32)
    sx = (c0 * (sx0 - 0.2) + s0 * (sy0 + 0.1)).astype(np.float32)
    sy = (-s0 * (sx0 - 0.2) + c0 * (sy0 + 0.1)).astype(np.float32)
    svalid = rng.rand(S) < 0.97

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a[None], dtype=dtype, device="cuda")
    init = torch.zeros(1, 3, device="cuda")
    ref = icp_fit(torch.stack([t(sx), t(sy)], -1), t(svalid, torch.bool),
                  t(mga[idx], torch.bool), torch.stack([t(mx), t(my)], -1),
                  t(mvalid, torch.bool), t(mga, torch.bool), init, cfg)
    got = icp_fused.icp_fused_planes(
        t(sx), t(sy), icp_fused.encode_scene_class(
            t(svalid, torch.bool), t(mga[idx], torch.bool)).contiguous(),
        t(mx), t(my), icp_fused.encode_model_class(
            t(mvalid, torch.bool), t(mga, torch.bool)).contiguous(),
        init, cfg)
    err = float((got.pose - ref.pose).abs().max())
    if err > POSE_TOL or not bool(got.ok[0] & ref.ok[0]):
        raise RuntimeError(f"K1 disagrees with icp_fit: max pose err {err}")
    return err


def bound(moved: float, ops: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time for moving `moved` bytes through
    device memory or doing `ops` f32 operations, whichever is longer."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def icp_bytes(planes, init) -> int:
    """Bytes K1 / K3 must move on this data: both class planes whole (they
    say which slots count), x and y at the valid slots only (padding is
    never needed), init, and the (B, 8) output slab."""
    sc, mc = planes[2], planes[5]
    valid = int((sc >= 0).sum()) + int((mc < 2).sum())
    return nbytes(sc, mc, init) + 8 * valid + sc.shape[0] * 8 * 4


def same_class_pairs(sc, mc) -> torch.Tensor:
    """(B,) scene x model point pairs of one class (both valid)."""
    return ((sc == 0).sum(-1) * (mc == 0).sum(-1) +
            (sc == 1).sum(-1) * (mc == 1).sum(-1)).double()


def icp_ops(planes, init, cfg) -> float:
    """K1 / K2: at least one squared distance (5 operations) per same-class
    pair in every fit iteration each robot runs."""
    from slam_tpu_torch.ops.icp_fused import fit_iterations
    iters = fit_iterations(*planes, init, cfg).double()
    return 5.0 * float((iters * same_class_pairs(planes[2], planes[5])).sum())


def pf_problem(B=FLEET, N=PF_SCORED, P=128, G=PF_G, seed=5, device="cuda",
               stride=4):
    """Config 5's scoring problem: each robot's scan of stride * N points
    (B, stride * N, 3), scored at `stride` as pf_match reads it, holds world
    points seen from its true pose; its P particles scatter around that
    pose. Robots 0-7 have no valid point (the denominator of 1); particle
    1 of every robot is off the grid; robots 8-15 put particle 2 at the
    origin and their scan points on cell edges. Returns a dict: the shared
    grid, per-robot grids ("own"), the scan "xyz" (B, stride * N, 3) and
    "mask" (B, stride * N), the scored views "scan" (B, N, 2) and "valid"
    (B, N), and "parts" (B, P, 3)."""
    from slam_tpu_torch.mapping.point_map import (init_point_map,
                                                  update_point_map_xy)
    rng = np.random.default_rng(seed)
    n = stride * N
    world = rng.uniform(-40, 40, (4000, 2)).astype(np.float32)
    true = np.stack([rng.uniform(-10, 10, B), rng.uniform(-10, 10, B),
                     rng.uniform(-np.pi, np.pi, B)], -1).astype(np.float32)
    pick = world[rng.integers(0, len(world), (B, n))]          # (B, n, 2)
    c, s = np.cos(true[:, 2:3]), np.sin(true[:, 2:3])
    d = pick - true[:, None, :2]
    xyz = np.stack([c * d[..., 0] + s * d[..., 1],
                    -s * d[..., 0] + c * d[..., 1],
                    rng.normal(0, 1, (B, n))], -1)
    xyz[8:16, :, :2] = rng.integers(-60, 60, (8, n, 2)) * 0.5
    mask = rng.random((B, n)) < 0.9
    mask[:8] = False
    parts = true[:, None] + rng.normal(0, 1, (B, P, 3)) * [0.3, 0.3, 0.05]
    parts[:, 0] = true
    parts[:, 1, :2] += 60.0
    parts[8:16, 2] = 0.0

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    shared = init_point_map(1, G, 0.5, device=device)
    shared = update_point_map_xy(shared, t(world[None, :, 0]),
                                 t(world[None, :, 1]), None,
                                 torch.ones(1, len(world), dtype=torch.bool,
                                            device=device))
    keep = t(rng.random((B, G, G)) < 0.7)
    own = shared.replace(count=shared.count * keep,
                         sum_x=shared.sum_x.expand(B, -1, -1),
                         sum_y=shared.sum_y.expand(B, -1, -1),
                         sum_z=shared.sum_z.expand(B, -1, -1),
                         center=t(rng.uniform(-1, 1, (B, 2))))
    xyz, mask = t(xyz), t(mask, torch.bool)
    return dict(shared=shared, own=own, xyz=xyz, mask=mask,
                scan=xyz[:, ::stride, :2], valid=mask[:, ::stride],
                parts=t(parts))


def pf_bound(grid, scan_xy, valid, parts):
    """K5: read the scored scan points, masks, particles and the count grid
    once, write one fraction per particle; 12 f32 operations per
    (particle, valid point) pair (rotate and translate: 4 products, 4 sums;
    centre: 2 differences; 2 products by the scale)."""
    B, P, _ = parts.shape
    moved = nbytes(scan_xy, valid, parts, grid.count, grid.center) + B * P * 4
    return bound(moved, 12.0 * P * float(valid.sum()))


def check_k5(pf) -> dict:
    """K5 against its plain version, fractions exactly equal: shared and
    per-robot tables, P = 128 and P = 1, the scan read at stride 4 and 1
    from (B, 384, 3), a count grid with NaN counts, resolution 0.5 and 0.3
    (not a power of two), and a 100 x 100 grid; the bit tables equal to
    occupancy_bits_reference."""
    from slam_tpu_torch.config import PfConfig
    from slam_tpu_torch.mapping.point_map import init_point_map
    from slam_tpu_torch.ops import particle
    cfg = PfConfig()
    shared, own, parts = pf["shared"], pf["own"], pf["parts"]
    nan = shared.replace(count=shared.count.clone())
    occ = torch.nonzero(nan.count[0] > 0)[::3]
    nan.count[0, occ[:, 0], occ[:, 1]] = float("nan")
    small = init_point_map(1, 100, 0.5, device="cuda")
    small = small.replace(count=(torch.rand(1, 100, 100, device="cuda",
                                            generator=torch.Generator(
                                                "cuda").manual_seed(9))
                                 < 0.3).float())
    views = {4: (pf["scan"], pf["valid"]),
             1: (pf["xyz"][..., :2], pf["mask"])}
    cases = [(f"{name} P={P} stride {st}", grid, P, st, 0.5)
             for name, grid in (("shared", shared), ("per-robot", own))
             for P in (parts.shape[1], 1) for st in (4, 1)]
    cases += [("NaN counts P=128", nan, 128, 4, 0.5),
              ("res 0.3 P=128", shared, 128, 4, 0.3),
              ("res 0.3 P=1", shared, 1, 4, 0.3),
              ("G=100 P=128", small, 128, 4, 0.5)]
    out = {}
    for label, grid, P, st, res in cases:
        scan, valid = views[st]
        p = parts[:, :P]
        got = particle.score_particles(grid, scan, valid, p, res, cfg)
        ref = particle.score_particles_reference(grid, scan, valid, p, res)
        torch.cuda.synchronize()
        if not same_bits(got, ref):
            raise RuntimeError(f"K5 ({label}) disagrees with its plain "
                               f"version: {int((got != ref).sum())} "
                               f"mismatched fractions")
        out[label] = float((got - ref).abs().max())
    bits_err = {}   # words of each bit table unequal to the plain version's
    for label, grid in (("shared", shared), ("per-robot", own),
                        ("NaN", nan), ("G=100", small)):
        words = particle.occupancy_bits(grid)
        ref = particle.occupancy_bits_reference(grid.count)
        bits_err[label] = int((words != ref).sum()) if \
            words.shape == ref.shape else ref.numel()
        if bits_err[label]:
            raise RuntimeError(f"K5's bit table ({label}) differs from "
                               f"occupancy_bits_reference in "
                               f"{bits_err[label]} words")
    if not bool((got[:8] == 0).all()):
        raise RuntimeError("K5 scored robots without valid points")
    return dict(max_abs_err=max(out.values()), mismatches=0,
                cases=len(cases), bits_err=max(bits_err.values()))


def time_k4(p, reps=20) -> dict:
    """K4 on a registration_problem as the "points" matcher calls it
    (nearest_neighbor, model strided from (B, C, 3)): ms of the call and
    of its C entry point alone, the plain version's ms and the bound (the
    operands read once, idx and dist written, 5 operations a same-class
    pair)."""
    from slam_tpu_torch import cuda_build
    from slam_tpu_torch.ops import nn
    from slam_tpu_torch.ops.icp_fused import encode_model_class
    args = nn_inputs(p)
    out, alone = replay(cuda_build.library(), "slam_nn",
                        lambda: nn.nearest_neighbor(*args))
    q, m, mv, qg, mg = args
    B, S, _ = q.shape
    return dict(
        call=cuda_ms(lambda: nn.nearest_neighbor(*args), reps),
        alone=kernel_ms(alone, reps), plain=cuda_ms(lambda: nn_plain(*args)),
        bound=bound(nbytes(q, mv, qg, mg) + m.numel() * 4 + B * S * 8,
                    5.0 * float(same_class_pairs(
                        qg.float(), encode_model_class(mv, mg)).sum())))


def time_k5(pf, P, cfg, reps=20) -> dict:
    """K5 on pf_problem's shared table, scan read at stride 4, P particles:
    ms of a score_particles call and of its scoring entry point alone,
    the plain version's ms and the bound."""
    from slam_tpu_torch import cuda_build
    from slam_tpu_torch.ops import particle
    grid, scan, valid = pf["shared"], pf["scan"], pf["valid"]
    parts = pf["parts"][:, :P]

    def call():
        return particle.score_particles(grid, scan, valid, parts, 0.5, cfg)
    out, alone = replay(cuda_build.library(), "slam_pf_score", call)
    return dict(call=cuda_ms(call, reps), alone=kernel_ms(alone, reps),
                plain=cuda_ms(lambda: particle.score_particles_reference(
                    grid, scan, valid, parts, 0.5)),
                bound=pf_bound(grid, scan, valid, parts))


def device_ops(fn, required=False) -> dict:
    """Device operations (kernels, copies, fills) that one call of `fn`
    runs, by torch.profiler, after a warm-up call: their total and their
    names. A K4 launch on a one-point problem before and after the call
    is the canary: after a session that records some 15,000 or more
    device operations, later sessions in the process can lose device
    operations, the ctypes-launched kernels first (PERF.md, open
    questions). A session that misses a canary gives n None ("not
    measured"), or raises if the count is `required`."""
    from slam_tpu_torch.ops import nn
    one = torch.zeros(1, 1, 2, device="cuda")
    valid = torch.ones(1, 1, dtype=torch.bool, device="cuda")

    def canary():
        before = nn.launches
        nn.nearest_neighbor(one, one, valid)
        nn.launches = before

    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        canary()
        fn()
        canary()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    if len(ev) < 2 or not all("nn_kernel" in e.name for e in
                              (ev[0], ev[-1])):
        if required:
            raise RuntimeError("torch.profiler missed the K4 canaries")
        return dict(n=None, names=[])
    names = [e.name for e in ev[1:-1]]
    return dict(n=len(names), names=names)


def ops_text(n, per=1) -> str:
    """A device_ops count (over `per` calls) for a printed line."""
    if n is None:
        return "not measured (the profiler missed its canaries)"
    return f"{n / per:.1f}" if per != 1 else str(n)


def call_ops(pf, cfg) -> dict:
    """device_ops of one nearest_neighbor call (the main path's shapes),
    one score_particles call and one pf_match (config 5's shapes)."""
    from slam_tpu_torch.ops import nn, particle
    from slam_tpu_torch.types import PointCloud
    args = nn_inputs(registration_problem(FLEET, seed=3))
    scan = PointCloud(xyz=pf["xyz"], valid=pf["mask"],
                      flags=torch.zeros_like(pf["mask"], dtype=torch.int32))
    pred = pf["parts"][:, 0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"nearest_neighbor": device_ops(
               lambda: nn.nearest_neighbor(*args), required=True),
           "score_particles": device_ops(lambda: particle.score_particles(
               pf["shared"], pf["scan"], pf["valid"], pf["parts"], 0.5,
               cfg), required=True),
           "pf_match": device_ops(lambda: particle.pf_match(
               pf["shared"], scan, pred, 0.5, cfg, generator=gen),
               required=True)}
    out["pf_match"]["K5"] = sum("pf_" in n for n in out["pf_match"]["names"])
    return out


def check_k3(cfg) -> dict:
    """K3 vs its plain version at the reference scale's shapes (ref_scale's
    IcpConfig): a full problem (model points spread over +-100 m as a
    40,960-point map around a robot) and the main path's sparse occupancy,
    in the first slots and scattered; vs its plain version where exact
    duplicate model points lie 12,000 slots apart (so in different model
    splits); vs K1's plain version on a problem both kernels take. Every
    case runs twice and must give the same bits."""
    from slam_tpu_torch.ops import icp_fused
    tiled = icp_fused.icp_fused_planes_tiled_reference

    def dense(B, S, C, span, dup, rot):
        return registration_problem(B, S, C, seed=11, span=span,
                                    dup_stride=dup, max_rot=rot)

    def sparse(scattered):
        return sparse_problem(FLEET_REF, REF_S, REF_C, REF_SCENE, REF_TARGET,
                              scattered, seed=21)
    cases = (("ref", dense(FLEET_REF, REF_S, REF_C, 100.0, 0, 0.01), tiled,
              (0, 1)),
             ("sparse", sparse(False), tiled, (0, 1, 2)),
             ("scattered", sparse(True), tiled, (0, 1, 2)),
             ("ties", dense(8, 700, 24000, 20.0, 12000, 0.05), tiled, (0, 1)),
             ("vs K1", dense(8, 512, 4096, 20.0, 0, 0.05),
              icp_fused.icp_fused_planes_reference, (0, 1)))
    out = {}
    for name, problem, plain, not_ok in cases:
        ops = fused_operands(problem)
        got = icp_fused.icp_fused_planes_tiled(*ops, cfg)
        out[name] = agreement(f"K3 ({name})", got, plain(*ops, cfg), not_ok)
        again = icp_fused.icp_fused_planes_tiled(*ops, cfg)
        if not (torch.equal(got.pose, again.pose) and
                torch.equal(got.num_corr, again.num_corr)):
            raise RuntimeError(f"K3 ({name}): two calls on the same inputs "
                               f"differ")
    return out


def check_k2_tiled(cfg, B=16, P=2048, seed=12) -> dict:
    """K2 on packed problems above RESIDENT_TILE_LIMIT (P x P points, the
    reference scale's keyframe edges), which it sends to K3, against its
    plain version (K3's plain version behind the adapter): one K3 launch,
    counted as K2's and K3's."""
    from slam_tpu_torch.ops import icp_fused
    p = registration_problem(B, P, P, seed=seed)
    args = (torch.stack([p["sx"], p["sy"]], -1), p["s_valid"], p["s_ga"],
            torch.stack([p["mx"], p["my"]], -1), p["m_valid"], p["m_ga"],
            p["init"], cfg)
    before = (icp_fused.packed_launches, icp_fused.tiled_launches,
              icp_fused.launches)
    got = icp_fused.icp_fused(*args)
    after = (icp_fused.packed_launches, icp_fused.tiled_launches,
             icp_fused.launches)
    if [a - b for a, b in zip(after, before)] != [1, 1, 0]:
        raise RuntimeError(f"K2 above RESIDENT_TILE_LIMIT: launches (K2, K3,"
                           f" K1) went {before} -> {after}")
    return agreement("K2 on K3", got, icp_fused.icp_fused_reference(*args))


def event_timed(fn, events):
    """fn, recording a pair of CUDA events around each call into
    `events` (neither waits for the card)."""
    def timed(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fn(*a, **k)
        ev[1].record()
        events.append(ev)
        return out
    return timed


def kept(fn, calls, copy=False, last=False):
    """fn, keeping each call's arguments in `calls`: the tensors themselves,
    or with `copy` their values at the call (clones, for a caller that
    overwrites its arguments in place, as live.GraphedStep's replays do);
    with `last` only the latest call's."""
    def value(x):
        return x.clone() if copy and isinstance(x, torch.Tensor) else x

    def keep(*a, **k):
        call = (tuple(map(value, a)), {n: value(v) for n, v in k.items()})
        if last:
            calls.clear()
        calls.append(call)
        return fn(*a, **k)
    return keep


def reset_counts(*modules) -> None:
    for m in modules:
        for attr in ("launches", "packed_launches", "tiled_launches",
                     "pack_launches"):
            if hasattr(m, attr):
                setattr(m, attr, 0)


def scan_to_scan_phase(state, world, cfg, gen):
    """[K2]: register_scan_to_scan (matcher "fused") on the fleet's last
    two scenes, one more tick apart, against its plain version. Returns
    (result dict with the K2 operands under "args", K2 launches)."""
    from slam_tpu_torch.geometry import se2_apply_xy
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.pipeline import slam2d
    prev = state
    cur = slam2d.slam_step(prev, world, cfg, gen)
    torch.cuda.synchronize()
    reset_counts(icp_fused, nn, particle)
    s2s = slam2d.register_scan_to_scan(cur.prev_scene, prev.prev_scene,
                                       prev.pose, prev.pose[:, :3], cfg)
    torch.cuda.synchronize()
    launches = icp_fused.packed_launches
    tx, ty = se2_apply_xy(prev.pose[:, :3], prev.prev_scene.xyz[..., 0],
                          prev.prev_scene.xyz[..., 1])
    args = (cur.prev_scene.xyz[..., :2], cur.prev_scene.valid,
            cur.prev_scene.is_ga(), torch.stack([tx, ty], -1),
            prev.prev_scene.valid, prev.prev_scene.is_ga(),
            prev.pose[:, :3], cfg.icp)
    ref = icp_fused.icp_fused_reference(*args)
    torch.cuda.synchronize()
    err = float((s2s.pose - ref.pose).abs().max())
    ok_mism = int((s2s.ok != ref.ok).sum())
    dcorr = int((s2s.num_corr - ref.num_corr).abs().max())
    ok_share = float(s2s.ok.float().mean())
    track = float((s2s.pose[:, :2] - cur.pose[:, :2]).norm(dim=-1).median())
    if launches < 1:
        raise RuntimeError("register_scan_to_scan did not launch K2")
    if err > POSE_TOL or ok_mism or dcorr > NCORR_TOL:
        raise RuntimeError(f"K2 disagrees with its plain version: pose err "
                           f"{err}, ok mismatches {ok_mism}, |d num_corr| "
                           f"{dcorr}")
    if not ok_share > 0.9 or not track < 0.1:
        raise RuntimeError(f"scan-to-scan registration fails: ok share "
                           f"{ok_share}, median distance to the tick's pose "
                           f"{track} m")
    B = s2s.pose.shape[0]
    print(f"[K2] register_scan_to_scan vs plain at B={B} S=C=384: max "
          f"pose err {err:.3g} (bound {POSE_TOL}), ok mismatches {ok_mism}, "
          f"max |d num_corr| {dcorr}; ok share {ok_share:.4f}, median "
          f"distance to the tick's pose {track:.4f} m; K2 launches "
          f"{launches}", flush=True)
    return dict(pose_err=err, args=args), launches


def particle_config(cfg):
    """Config 5: the particle matcher, scoring every 4th scan point."""
    return dataclasses.replace(
        cfg, icp=dataclasses.replace(cfg.icp, matcher="particle"),
        pf=dataclasses.replace(cfg.pf, score_stride=4))


def shared_fleet_phase(world, cfg, gen, card, fleet_size=FLEET,
                       macros=PF_MACROS):
    """[pf]: config 5, fleet_rollout_shared with the particle matcher (K5)
    against one shared map, after a warm-up macro on another fleet.
    Returns (the config, K5 launches)."""
    from slam_tpu_torch.mapping.point_map import init_point_map
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.parallel.shared_map import fleet_rollout_shared
    from slam_tpu_torch.pipeline import slam2d
    dev = world.centers.device
    fcfg = particle_config(cfg)
    res = fcfg.icp.voxel_leaf_obs[0]
    warm = slam2d.init_state(fcfg, fleet_size, device=dev,
                             generator=gen.manual_seed(3))
    fleet_rollout_shared(warm, init_point_map(1, fcfg.mls.size_x, res,
                                              device=dev),
                         world, fcfg, 1, generator=gen)
    del warm
    fleet = slam2d.init_state(fcfg, fleet_size, device=dev,
                              generator=gen.manual_seed(4))
    shared = init_point_map(1, fcfg.mls.size_x, res, device=dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    reset_counts(icp_fused, nn, particle)
    e0.record()
    fleet, shared, (est, true) = fleet_rollout_shared(
        fleet, shared, world, fcfg, macros, generator=gen)
    e1.record()
    torch.cuda.synchronize()
    launches = particle.launches
    packs = particle.pack_launches
    ticks = 4 * macros
    ms = e0.elapsed_time(e1) / ticks
    if est.shape != (fleet_size, ticks, 3) or fleet.map_grid is not None:
        raise RuntimeError(f"config 5 trajectory shape {tuple(est.shape)}")
    if not bool(torch.isfinite(est).all() &
                torch.isfinite(shared.count).all()):
        raise RuntimeError("non-finite values in the config 5 fleet")
    ate = slam2d.ate(est[:, 8:], true[:, 8:])
    med = float(ate.median())
    ok_share = float(fleet.scan_reg_ok.float().mean())
    if launches < 2 * ticks or packs < ticks:
        raise RuntimeError(f"K5 launched {launches} times and packed "
                           f"{packs} tables in {ticks} ticks (want 2 and 1 "
                           f"a tick)")
    if not med < PF_ATE_LIMIT:
        raise RuntimeError(f"config 5 median ATE {med} m not below "
                           f"{PF_ATE_LIMIT} m")
    if float(shared.count.sum()) < fleet_size * macros:
        raise RuntimeError("the shared map did not receive the fleet's scans")
    print(f"[pf] config 5 B={fleet_size} {macros} macros x 4 ticks: "
          f"{ms:.3f} ms/tick, {fleet_size * 1000.0 / ms:.1f} robot-steps/s, "
          f"median ATE {med:.4f} m (ticks>=8, {float(ate.max()):.4f} max), "
          f"ok share {ok_share:.4f}, shared cells "
          f"{int((shared.count > 0).sum())}; K5 launches {launches}, bit "
          f"tables {packs} | {card}", flush=True)
    return fcfg, launches, packs


def rollout_3d_phase(cfg, fleet, ticks, gen, card, label, kernel, skip,
                     ate_limit, z_skip, z_limit, ok_share_min=None):
    """[3d] / [ref]: config 2's rollout_3d on a fleet of `fleet` robots,
    `ticks` ticks after a warm-up macro of the same fleet (which builds the
    first registration target: the first macro registers against an empty
    map). Gates: median
    per-robot xy ATE over ticks >= skip, mean |z error| over ticks >=
    z_skip, the fused matcher's kernel launched every tick, and (ref) the
    share of (robot, tick) registrations that succeeded. Returns the
    kernel's launch count."""
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.pipeline import slam2d, slam3d
    from slam_tpu_torch.sim import world3d
    dev = torch.device("cuda")
    world = world3d.make_world(gen.manual_seed(42), cfg.sim, device=dev)
    state = slam3d.init_state_3d(cfg, fleet, world, device=dev,
                                 generator=gen.manual_seed(0))
    state, gm, _ = slam3d.rollout_3d(
        state, world, slam3d.init_ground_map(cfg, fleet, dev), cfg, 4, gen)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    reset_counts(icp_fused, nn, particle)
    e0.record()
    state, gm, (est, true, reg_ok) = slam3d.rollout_3d(state, world, gm, cfg,
                                                       ticks, gen)
    e1.record()
    torch.cuda.synchronize()
    counts = {"K1": icp_fused.launches, "K3": icp_fused.tiled_launches,
              "K4": nn.launches}
    ms = e0.elapsed_time(e1) / ticks
    if est.shape != (fleet, ticks, 4):
        raise RuntimeError(f"{label} trajectory shape {tuple(est.shape)}")
    for what, x in (("est", est), ("map", state.map_grid.count),
                    ("ground map", gm.grid.count),
                    ("occupancy", state.local_map.counts)):
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{label}: non-finite values in {what}")
    ate = slam2d.ate(est[:, skip:], true[:, skip:])
    med = float(ate.median())
    z_err = float((est[:, z_skip:, 3] - true[:, z_skip:, 3]).abs().mean())
    ok_share = float(reg_ok.float().mean())
    scene_pts = float(state.prev_scene.valid.sum(-1).float().mean())
    map_pts = float(state.map_cloud.valid.sum(-1).float().mean())
    if counts[kernel] < ticks:
        raise RuntimeError(f"{label}: {kernel} launched {counts[kernel]} "
                           f"times in {ticks} ticks ({counts})")
    if not med < ate_limit or not z_err < z_limit:
        raise RuntimeError(f"{label}: median ATE {med} m (limit {ate_limit}),"
                           f" mean |z error| {z_err} m (limit {z_limit})")
    if ok_share_min is not None and not ok_share >= ok_share_min:
        raise RuntimeError(f"{label}: registration succeeded in a share "
                           f"{ok_share} of ticks (want >= {ok_share_min})")
    if int((gm.grid.count > 0).sum()) < fleet * 100:
        raise RuntimeError(f"{label}: the ground maps stayed empty")
    print(f"[{label}] config 2 B={fleet} {ticks} ticks: {ms:.3f} ms/tick, "
          f"{fleet * 1000.0 / ms:.1f} robot-steps/s, median ATE {med:.4f} m "
          f"(ticks>={skip}, {float(ate.max()):.4f} max), mean |z error| "
          f"{z_err:.4f} m (ticks>={z_skip}), registration ok share "
          f"{ok_share:.4f}, last scene {scene_pts:.1f} of "
          f"{state.prev_scene.capacity} points and target {map_pts:.1f} of "
          f"{state.map_cloud.capacity} (robot mean); launches {counts} | "
          f"{card}", flush=True)
    return counts[kernel]


def count_syncs(fn):
    """(fn's result, the host syncs it made) under
    torch.cuda.set_sync_debug_mode("warn"), each as the source line that
    made it."""
    import os
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]


def sync_sites(syncs) -> str:
    """'site xN, ...' of count_syncs' list."""
    import collections
    return ", ".join(f"{k} x{v}" for k, v in
                     collections.Counter(syncs).most_common())


def loop_forms(cfg) -> dict:
    """cfg with icp.loop "scan" (every fit runs max_iterations steps, no
    host read) and "while" (a fit stops once every robot has converged,
    reading the converged flags each iteration)."""
    return {loop: cfg.replace(icp=dataclasses.replace(cfg.icp, loop=loop))
            for loop in ("scan", "while")}


def while_sync_gate(label, syncs, fits, max_iterations, source) -> int:
    """The "while" form's host reads: at most max_iterations + 1 for each
    of `fits` fits, every one in the fit's module `source`. Raises with
    `label` otherwise; returns the bound."""
    most = fits * (max_iterations + 1)
    stray = [x for x in syncs if not x.startswith(source + ":")]
    if len(syncs) > most or stray:
        raise RuntimeError(f"{label} with icp.loop while: {len(syncs)} host "
                           f"syncs (bound {most}, all in {source}): "
                           f"{sync_sites(syncs)}")
    return most


def search_fracs(scene, map_cloud, prior, gcfg):
    """global_match's coarse search planes for one robot, on the operands'
    device: the (K, (2G)^2) correlation over each rotation's occupied scene
    cells."""
    from slam_tpu_torch.geometry import rot2
    from slam_tpu_torch.ops import fft_match as fm
    K, G = gcfg.num_rotations, gcfg.grid_size
    dev = prior.device
    angles = torch.arange(K, device=dev).to(torch.float32) * (2 * np.pi / K)
    map_img = fm.dilate(fm.rasterize(map_cloud.xyz[..., :2], map_cloud.valid,
                                     prior, gcfg), gcfg.smooth_radius)
    xy = scene.xyz[:, None, :, :2] @ rot2(angles).mT
    imgs = fm.rasterize(xy, scene.valid[:, None], torch.zeros_like(prior)[
        :, None], gcfg)[0]
    corr = fm.fft_correlate(map_img[0], imgs).flatten(-2)
    return corr / torch.clamp(imgs.sum((-2, -1)), min=1.0)[:, None], \
        torch.clamp(imgs.sum((-2, -1)), min=1.0)


def search_agreement(state, gcfg) -> dict:
    """global_match's coarse search for robot 0 on the card against the same
    search through the plain CPU path: scores within SEARCH_SCORE_TOL; the
    poses equal where the CPU's best (rotation, lag) leads every other by
    TIE_LEAD counts, else the card's lag within TIE_TOL counts of that
    best (the FFTs round differently, and lags tie on whole counts)."""
    from slam_tpu_torch.ops.fft_match import global_match

    def robot0(c, dev):
        return c.replace(xyz=c.xyz[:1].to(dev), valid=c.valid[:1].to(dev),
                         flags=c.flags[:1].to(dev))
    args = {dev: (robot0(state.prev_scene, dev), robot0(state.map_cloud, dev),
                  state.pose[:1, :2].to(dev)) for dev in ("cuda", "cpu")}
    card = global_match(*args["cuda"], gcfg)
    plain = global_match(*args["cpu"], gcfg)
    frac, cells = search_fracs(*args["cpu"], gcfg)
    err = abs(float(card.score[0]) - float(plain.score[0]))
    flat = frac.flatten()
    top2 = torch.topk(flat, 2).values
    kb = int(flat.argmax()) // frac.shape[1]
    lead = float((top2[0] - top2[1]) * cells[kb])
    P = 2 * gcfg.grid_size
    pose, prior = card.pose[0].cpu(), args["cpu"][2][0]
    k = int(round(float(pose[2]) / (2 * np.pi / gcfg.num_rotations))
            ) % gcfg.num_rotations
    dx, dy = (int(round(float(v))) for v in
              (pose[:2] - prior) / gcfg.grid_resolution)
    behind = float((top2[0] - frac[k, (dx % P) * P + (dy % P)]) * cells[k])
    same = bool(torch.equal(pose, plain.pose[0]))
    if err > SEARCH_SCORE_TOL or (lead >= TIE_LEAD and not same) or \
            (lead < TIE_LEAD and behind > TIE_TOL):
        raise RuntimeError(f"the FFT search on the card disagrees with its "
                           f"plain CPU path on robot 0: score err {err}, "
                           f"best leads by {lead} counts, the card's lag is "
                           f"{behind} counts behind, poses equal {same}")
    return dict(score_err=err, lead=lead, behind=behind, same=same,
                score=float(card.score[0]))


def mls_phase(world, gen, card) -> dict:
    """[mls]: config 3 at sim2d_reloc_config (bench.py's shapes) for
    MLS_FLEET robots: a warm-up macro on another fleet, MLS_MACROS timed
    macros with robot 0 kidnapped at MLS_KIDNAP_AT, then one macro without
    a kidnap. Gates: robot 0 back within RELOC_LIMIT of its true
    pose, the robots that were not lost bit for bit as the gate was given
    them, the healthy robots' median ATE, drivable cells on every robot,
    a finite grid, K4 equal to its plain version on the polish's calls, the
    FFT search on the card against its plain CPU path. Returns the
    launches, the times and the syncs."""
    from slam_tpu_torch.config import sim2d_reloc_config
    from slam_tpu_torch.mapping.mls import init_mls
    from slam_tpu_torch.ops import icp as icp_mod
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.pipeline import slam2d
    from slam_tpu_torch.pipeline.relocalize import fleet_relocalize_if_lost
    from slam_tpu_torch.profile_tick import KIDNAP, mls_macro
    cfg = sim2d_reloc_config()
    dev = world.centers.device
    B = MLS_FLEET
    warm = slam2d.init_state(cfg, B, device=dev, generator=gen.manual_seed(11))
    mls_macro(warm, init_mls(cfg.mls, B, device=dev), world, cfg, gen,
              kidnap_robot0=True)
    del warm
    state = slam2d.init_state(cfg, B, device=dev,
                              generator=gen.manual_seed(12))
    grid = init_mls(cfg.mls, B, device=dev)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(MLS_MACROS)]
    est, true, losts = [], [], []
    torch.cuda.synchronize()
    reset_counts(icp_fused, nn, particle)
    for m in range(MLS_MACROS):
        events[m][0].record()
        state, grid, (e, t), pre, lost = mls_macro(
            state, grid, world, cfg, gen, kidnap_robot0=m == MLS_KIDNAP_AT)
        events[m][1].record()
        est.append(e)
        true.append(t)
        losts.append(lost)
        if m == MLS_KIDNAP_AT:
            kid_pre, kid_post, kid_lost = pre, state, lost
    torch.cuda.synchronize()
    launches = {"K1": icp_fused.launches, "K4": nn.launches}
    macro_ms = [a.elapsed_time(b) for a, b in events]
    fired = [bool(x.any()) for x in losts]
    ms = sum(macro_ms) / (4 * MLS_MACROS)
    quiet = [t for t, f in zip(macro_ms, fired) if not f]
    est, true = torch.cat(est, 1), torch.cat(true, 1)
    if est.shape != (B, 4 * MLS_MACROS, 3):
        raise RuntimeError(f"config 3 trajectory shape {tuple(est.shape)}")

    def dist0(s):
        return float(torch.linalg.vector_norm(s.ekf.mu[0, :2] -
                                              s.true_pose[0, :2]))
    before, after, end = dist0(kid_pre), dist0(kid_post), dist0(state)
    keep = ~kid_lost
    nolost = fleet_relocalize_if_lost(kid_pre, cfg,
                                      lost=torch.zeros_like(kid_lost))
    untouched = all(torch.equal(getattr(a, f)[keep], getattr(b, f)[keep])
                    for a, b in ((kid_post.ekf, nolost.ekf),
                                 (kid_post.ekf, kid_pre.ekf))
                    for f in ("mu", "sigma")) and \
        torch.equal(kid_post.pose[keep], nolost.pose[keep])
    ate = slam2d.ate(est[1:, 10:], true[1:, 10:])
    med = float(ate.median())
    drivable = (grid.drivable == 1).sum((1, 2))
    finite = bool(torch.isfinite(grid.mean).all() &
                  torch.isfinite(grid.var_z).all() &
                  torch.isfinite(est).all())
    if launches["K1"] < 4 * MLS_MACROS or launches["K4"] < 1:
        raise RuntimeError(f"config 3 launches {launches} in "
                           f"{4 * MLS_MACROS} ticks")
    if not after < RELOC_LIMIT:
        raise RuntimeError(f"config 3: robot 0 {after} m from its true pose "
                           f"after relocalizing (kidnapped {before} m)")
    if not untouched:
        raise RuntimeError("config 3: the gate changed robots that were not "
                           "lost")
    if not med < MLS_ATE_LIMIT:
        raise RuntimeError(f"config 3 median ATE of the healthy robots {med} "
                           f"m not below {MLS_ATE_LIMIT} m")
    if not finite or int(drivable.min()) < 1:
        raise RuntimeError(f"config 3 MLS grids: finite {finite}, drivable "
                           f"cells >= {int(drivable.min())}")

    # one more macro with no kidnap, its host syncs counted: with no robot
    # lost the gate must hand its input back untouched
    (state, grid, _, pre, lost), healthy_syncs = count_syncs(
        lambda: mls_macro(state, grid, world, cfg, gen))
    n_lost = int(lost.sum())
    if n_lost == 0 and state is not pre or not torch.equal(
            state.ekf.mu[~lost], pre.ekf.mu[~lost]):
        raise RuntimeError(f"config 3's last macro ({n_lost} robots lost) "
                           f"changed robots that were not lost")
    # the kidnap macro's gate again: its syncs, and K4 on the polish's calls
    seen, nn_call = [], icp_mod.nearest_neighbor

    def keep_call(*a, **k):
        seen.append((a, k))
        return nn_call(*a, **k)
    icp_mod.nearest_neighbor = keep_call
    try:
        _, gate_syncs = count_syncs(lambda: fleet_relocalize_if_lost(
            kid_pre, cfg, lost=kid_lost))
    finally:
        icp_mod.nearest_neighbor = nn_call
    k4_err = 0.0
    for a, k in seen:
        args = (*a, k["q_class"], k["m_class"])
        (idx, d), (ridx, rd) = nn.nearest_neighbor(*args), nn_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ridx) and same_bits(d, rd)):
            raise RuntimeError(f"K4 disagrees with its plain version on the "
                               f"relocalization polish: "
                               f"{int((idx != ridx).sum())} idx mismatches")
        k4_err = max(k4_err, float((d - rd).abs().max()))
    search = search_agreement(kid_pre, cfg.global_match)
    print(f"[mls] config 3 B={B} {MLS_MACROS} macros x 4 ticks, robot 0 "
          f"kidnapped by {KIDNAP} at macro {MLS_KIDNAP_AT}: {ms:.3f} ms/tick, "
          f"{B * 1000.0 / ms:.1f} robot-steps/s; a macro that relocalizes "
          f"{macro_ms[MLS_KIDNAP_AT]:.3f} ms, one that does not "
          f"{sum(quiet) / max(len(quiet), 1):.3f} ms (mean of {len(quiet)}; "
          f"{sum(fired)} macros relocalized); host syncs (icp.loop while: "
          f"the polish's icp_fit reads its converged flags each iteration): "
          f"a macro with "
          f"{n_lost} robots lost {len(healthy_syncs)} "
          f"({sync_sites(healthy_syncs)}), the "
          f"relocalizing gate {len(gate_syncs)} ({sync_sites(gate_syncs)}); "
          f"robot 0 {before:.3f} m from its true pose before, {after:.4f} m "
          f"after (bound {RELOC_LIMIT}), {end:.4f} m at the block's end; "
          f"robots not lost unchanged bit for bit; median ATE of the healthy "
          f"robots {med:.4f} m (ticks>=10, {float(ate.max()):.4f} max); "
          f"drivable cells >= {int(drivable.min())} a robot; launches "
          f"{launches}; K4 equal to its plain version on the polish's "
          f"{len(seen)} calls; robot 0's FFT search on the card vs the CPU: "
          f"score {search['score']:.6f}, err {search['score_err']:.3g} (bound "
          f"{SEARCH_SCORE_TOL}), best lead {search['lead']:.4f} counts, "
          f"card's lag {search['behind']:.3g} counts behind, poses equal "
          f"{search['same']} | {card}", flush=True)
    return dict(launches=launches, k4_err=k4_err, ms=ms, macro_ms=macro_ms,
                syncs=(healthy_syncs, gate_syncs), polish_calls=seen)


def regen_phase(world, gen, card) -> dict:
    """[regen]: config 4 at sim2d_graph_config with map_regen "voxel" and
    then "mls": REGEN_MACROS macros each after a warm-up macro on another
    fleet; ms/tick, graph tick ms, device ops and host syncs of one graph
    tick; gates: median ATE, a finite target, >= 2 keyframes a robot, no
    host sync. After the voxel run, apply_relocalization_graph on robot 0
    kidnapped by KIDNAP: its edge must be injected, every pose finite."""
    from slam_tpu_torch.config import sim2d_graph_config
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.pipeline import relocalize, slam2d
    from slam_tpu_torch.profile_tick import KIDNAP, kidnap
    base = sim2d_graph_config()
    dev = world.centers.device
    B = GRAPH_FLEET
    out = {"launches": {"K1": 0, "K2": 0, "K4": 0}}
    lines = []
    for regen in ("voxel", "mls"):
        cfg = base.replace(graph=dataclasses.replace(base.graph,
                                                     map_regen=regen))
        warm = slam2d.init_state(cfg, B, device=dev,
                                 generator=gen.manual_seed(13),
                                 with_graph=True)
        slam2d.rollout_with_graph(warm, world, cfg, 1, gen, GRAPH_EVERY)
        del warm
        state = slam2d.init_state(cfg, B, device=dev,
                                  generator=gen.manual_seed(14),
                                  with_graph=True)
        tick_events, update = [], slam2d.graph_update
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        reset_counts(icp_fused, nn, particle)
        slam2d.graph_update = event_timed(update, tick_events)
        try:
            e0.record()
            state, (est, true) = slam2d.rollout_with_graph(
                state, world, cfg, REGEN_MACROS, gen, GRAPH_EVERY)
            e1.record()
            torch.cuda.synchronize()
        finally:
            slam2d.graph_update = update
        launches = {"K1": icp_fused.launches, "K2": icp_fused.packed_launches,
                    "K4": nn.launches}
        for k, v in launches.items():
            out["launches"][k] += v
        ticks = REGEN_MACROS * GRAPH_EVERY
        ms = e0.elapsed_time(e1) / ticks
        graph_ms = [a.elapsed_time(b) for a, b in tick_events]
        _, syncs = count_syncs(lambda: slam2d.graph_update(state, cfg))
        g = state.graph
        ate = slam2d.ate(est[:, 8:], true[:, 8:])
        med = float(ate.median())
        target = state.map_cloud.valid.sum(-1)
        nodes = int(g.num_nodes.min())
        if not bool(torch.isfinite(state.map_cloud.xyz).all() &
                    torch.isfinite(g.node_pose).all() &
                    torch.isfinite(est).all()):
            raise RuntimeError(f"config 4 ({regen}): non-finite poses or "
                               f"target")
        if not med < GRAPH_ATE_LIMIT or nodes < 2 or syncs or \
                launches["K1"] < ticks or launches["K2"] < REGEN_MACROS:
            raise RuntimeError(f"config 4 ({regen}): median ATE {med} m, >= "
                               f"{nodes} keyframes, host syncs {syncs}, "
                               f"launches {launches}")
        line = (f"{regen}: {ms:.3f} ms/tick, {B * 1000.0 / ms:.1f} "
                f"robot-steps/s, graph tick mean "
                f"{sum(graph_ms) / len(graph_ms):.3f} ms (max "
                f"{max(graph_ms):.3f}), host syncs 0 (icp.loop "
                f"{cfg.icp.loop}; a graph tick runs no loop fit), median ATE "
                f"{med:.4f} m (ticks>=8, "
                f"{float(ate.max()):.4f} max), keyframes >= {nodes}, target "
                f"points {int(target.min())}-{int(target.max())} a robot, "
                f"launches {launches}")
        if regen == "voxel":
            kid = kidnap(state)
            match = relocalize.relocalize(kid, kid.prev_scene, cfg)
            only0 = torch.zeros_like(match.ok)
            only0[0] = True
            fixed = relocalize.apply_relocalization_graph(
                kid, match._replace(ok=match.ok & only0), cfg)
            added = fixed.graph.num_edges - kid.graph.num_edges
            d0 = float(torch.linalg.vector_norm(fixed.ekf.mu[0, :2] -
                                                fixed.true_pose[0, :2]))
            if not bool(match.ok[0]) or int(added[0]) != 1 or \
                    int(added[1:].abs().sum()) or not bool(
                        torch.isfinite(fixed.graph.node_pose).all() &
                        torch.isfinite(fixed.pose).all() &
                        torch.isfinite(fixed.map_cloud.xyz).all()):
                raise RuntimeError(f"config 4 relocalization: match ok "
                                   f"{bool(match.ok[0])} (score "
                                   f"{float(match.score[0])}), edges added "
                                   f"{int(added[0])} on robot 0, "
                                   f"{int(added[1:].abs().sum())} elsewhere")
            line += (f"; apply_relocalization_graph on robot 0 kidnapped by "
                     f"{KIDNAP}: match score {float(match.score[0]):.4f}, "
                     f"edge injected, poses finite, {d0:.4f} m from its "
                     f"true pose")
        lines.append(line)
        # its device ops are counted at the end of the run: profiling a
        # graph tick this long leaves the next few profiler runs without
        # device events
        out[regen] = dict(ms=ms, graph_ms=graph_ms, ate=med,
                          tick=lambda s=state, c=cfg: slam2d.graph_update(
                              s, c))
    print(f"[regen] config 4 B={B} {REGEN_MACROS} macros x {GRAPH_EVERY} "
          f"ticks + a graph tick, each regeneration after a warm-up macro: "
          + "; ".join(lines) + f" | {card}", flush=True)
    return out


def division_phase(card) -> dict:
    """[div]: how many cell indices differ between `t / python_float`
    (which the card computes as t times the f32 reciprocal) and a true
    division by a 0-dim tensor on the card, at each site that divides by a
    configured width: ground sectors and range bins at sim3d and at the
    reference scale, occupancy cells at MLS's 0.2 m. Counted on
    DIV_SAMPLES random values and on every cell edge k * width (an f32
    product) with its two f32 neighbours. Then the port's own binning
    (ops/ground.polar_bins, mapping/occupancy.cells_of, a whole
    add_to_occupancy_xy of 64 robots at 0.2 m) must give the CPU's cells
    on the same values. Returns {site: (random, edges) disagreements}."""
    from slam_tpu_torch import true_div
    from slam_tpu_torch.config import MlsConfig, ref_scale_config, sim3d_config
    from slam_tpu_torch.mapping.occupancy import (add_to_occupancy_xy,
                                                  cells_of, init_occupancy)
    from slam_tpu_torch.ops.ground import polar_bins
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def values(width, lo, hi):
        k = torch.arange(int(lo / width) - 1, int(hi / width) + 2, device=dev,
                         dtype=torch.float32)
        edge = k * width
        edges = torch.cat([edge, torch.nextafter(edge, edge + 1.0),
                           torch.nextafter(edge, edge - 1.0)])
        rand = lo + (hi - lo) * torch.rand(DIV_SAMPLES, device=dev,
                                           generator=gen)
        return rand, edges.clamp(lo, hi)

    mls = MlsConfig()
    sites = {}
    for name, g in (("sim3d", sim3d_config().ground),
                    ("ref", ref_scale_config().ground)):
        sites[f"ground sector {name} ({360.0 / g.num_sectors:g} deg)"] = (
            values(360.0 / g.num_sectors, 0.0, 360.0), 360.0 / g.num_sectors,
            lambda t, g=g: polar_bins(t, torch.zeros_like(t), g)[0],
            lambda t: t.to(torch.int32))
        sites[f"ground range bin {name} ({g.r_max / g.num_range_bins:g} "
              f"m)"] = (
            values(g.r_max / g.num_range_bins, 0.0, g.r_max),
            g.r_max / g.num_range_bins,
            lambda t, g=g: polar_bins(torch.zeros_like(t), t, g)[1],
            lambda t: t.to(torch.int32))
    sites[f"occupancy ({mls.resolution:g} m)"] = (
        values(mls.resolution, -mls.max_range, mls.max_range),
        mls.resolution, lambda t: cells_of(t, t, mls)[0],
        lambda t: torch.floor(t).to(torch.int32))
    out = {}
    for site, ((rand, edges), width, port_bins, to_cell) in sites.items():
        counts = []
        for t in (rand, edges):
            naive = to_cell(t / width)
            true = to_cell(true_div(t, width))
            counts.append(int((naive != true).sum()))
            got, cpu = port_bins(t), port_bins(t.cpu())
            if not torch.equal(got.cpu(), cpu):
                raise RuntimeError(f"[div] {site}: the port's cells differ "
                                   f"from the CPU's on "
                                   f"{int((got.cpu() != cpu).sum())} values")
        out[site] = tuple(counts)
    # a whole occupancy update at 0.2 m: 64 robots, points on cell edges
    # and at random, counts equal to the CPU's
    _, edges = sites[f"occupancy ({mls.resolution:g} m)"][0]
    pick = torch.randint(0, edges.numel(), (2, 64, 4096), device=dev,
                         generator=gen)
    lx, ly = edges[pick[0]], edges[pick[1]]
    valid = torch.rand(64, 4096, device=dev, generator=gen) < 0.9
    card_grid = add_to_occupancy_xy(init_occupancy(mls, 64, dev), lx, ly,
                                    valid, mls)
    cpu_grid = add_to_occupancy_xy(init_occupancy(mls, 64, "cpu"), lx.cpu(),
                                   ly.cpu(), valid.cpu(), mls)
    if not (torch.equal(card_grid.counts.cpu(), cpu_grid.counts) and
            torch.equal(card_grid.drivable.cpu(), cpu_grid.drivable)):
        raise RuntimeError("[div] add_to_occupancy_xy at 0.2 m: the card's "
                           "grid differs from the CPU's")
    print("[div] cells where t / float (the card's reciprocal) and a true "
          f"division differ, of {DIV_SAMPLES} random values / of the cell "
          "edges and their f32 neighbours: " + "; ".join(
              f"{k} {r} / {e} of {sites[k][0][1].numel()}"
              for k, (r, e) in out.items()) +
          "; the port's binning equals the CPU's at every site and in a "
          "64-robot occupancy update at 0.2 m", flush=True)
    return out


def tie_margin(planes, init, pose, inlier_dist):
    """(n,) least margin of a near-tie in each fused-ICP problem at `pose`
    (n, 3): over its valid scene points whose class the model holds, the
    gap between the nearest and the second-nearest same-class model point
    (squared metres), or the nearest one's distance from the inlier gate.
    Below TIE_GAP, which correspondence (or the average of tied ones) a
    point takes is decided by rounding: the fit can settle a few mm apart
    on two roundings of the same arithmetic. Also returns (n,) the widest
    separation (m) of the two nearest model points over the points whose
    gap is below TIE_GAP (0 where none)."""
    sx, sy, sc, mx, my, mc = planes
    c, s = torch.cos(pose[:, 2:3]), torch.sin(pose[:, 2:3])
    qx = c * sx - s * sy + pose[:, 0:1]
    qy = s * sx + c * sy + pose[:, 1:2]
    d2 = (qx[:, :, None] - mx[:, None, :]) ** 2 + \
        (qy[:, :, None] - my[:, None, :]) ** 2
    d2 = torch.where(sc[:, :, None] == mc[:, None, :], d2, BIG_D2)
    two, at = torch.topk(d2, 2, dim=-1, largest=False)
    del d2
    counts = (sc >= 0) & (two[..., 0] < BIG_D2)
    margin = torch.minimum(two[..., 1] - two[..., 0],
                           (two[..., 0] - inlier_dist).abs())
    sep = torch.hypot(
        torch.gather(mx, 1, at[..., 0]) - torch.gather(mx, 1, at[..., 1]),
        torch.gather(my, 1, at[..., 0]) - torch.gather(my, 1, at[..., 1]))
    gap_tied = counts & (two[..., 1] - two[..., 0] < TIE_GAP)
    return (torch.where(counts, margin, float("inf")).amin(-1),
            torch.where(gap_tied, sep, 0.0).amax(-1))


def near_tie_agreement(label, got, ref, planes, init, cfg, max_excused,
                       min_ok) -> dict:
    """A fused-ICP kernel's result `got` (K1, K2 or K3) against its plain
    version's `ref` on the same n problems of a path's own data: pose
    within POSE_TOL on the problems without a near-tie (tie_margin below
    TIE_GAP at either pose), within TIE_POSE_TOL on all, ok equal, num_corr
    within NCORR_TOL, at most max_excused problems that need the near-tie
    bound (a near-tie and a pose error above POSE_TOL) and at least min_ok
    accepted problems. Raises with `label` when it disagrees. A near-tie
    alone excuses nothing: between near-duplicate model points (the 3D
    keyframes' voxels stacked within 1 cm of each other in xy) they are
    common and do not move the fit."""
    (m_got, sep_got), (m_ref, sep_ref) = (
        tie_margin(planes, init, r.pose, cfg.inlier_dist) for r in (got, ref))
    tied = torch.minimum(m_got, m_ref) < TIE_GAP
    torch.cuda.synchronize()
    errs = (got.pose - ref.pose).abs().amax(-1)
    a = dict(err=float(errs.max()),
             tie_sep=float(torch.maximum(sep_got, sep_ref).max()),
             err_untied=float(torch.where(tied, 0.0, errs).max()),
             n_tied=int(tied.sum()), n_excused=int((errs > POSE_TOL).sum()),
             ok_mism=int((got.ok != ref.ok).sum()),
             dcorr=int((got.num_corr - ref.num_corr).abs().max()),
             n_ok=int(ref.ok.sum()), n=int(ref.ok.numel()))
    if a["err_untied"] > POSE_TOL or a["ok_mism"] or a["dcorr"] > NCORR_TOL \
            or a["err"] > TIE_POSE_TOL or a["n_excused"] > max_excused or \
            a["n_ok"] < min_ok:
        raise RuntimeError(
            f"{label} disagrees with its plain version: pose err "
            f"{a['err_untied']} (bound {POSE_TOL}) without a near-tie, "
            f"{a['err']} (bound {TIE_POSE_TOL}) with the {a['n_tied']} "
            f"near-ties, {a['n_excused']} of them above {POSE_TOL} (at most "
            f"{max_excused}), ok mismatches {a['ok_mism']}, |d num_corr| "
            f"{a['dcorr']}, {a['n_ok']} of {a['n']} accepted (at least "
            f"{min_ok})")
    return a


def agreement_text(a) -> str:
    """near_tie_agreement's result as printed."""
    return (f"max pose err {a['err_untied']:.3g} (bound {POSE_TOL}) without "
            f"a near-tie, {a['n_tied']} with one (a correspondence within "
            f"{TIE_GAP} m^2 of a tie or of the inlier gate; tied model "
            f"points at most {a['tie_sep']:.3g} m apart) {a['err']:.3g} "
            f"(bound {TIE_POSE_TOL}; {a['n_excused']} above {POSE_TOL}), ok "
            f"mismatches {a['ok_mism']}, max |d num_corr| {a['dcorr']}, "
            f"{a['n_ok']} of {a['n']} accepted")


def nn_equal(label, call) -> None:
    """K4 on a recorded nearest_neighbor call (args, kwargs) against its
    plain version: idx equal, dist equal in bits."""
    from slam_tpu_torch.ops import nn
    a, k = call
    args = (*a, k.get("q_class"), k.get("m_class"))
    (idx, dist), (ridx, rdist) = nn.nearest_neighbor(*args), nn_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(idx, ridx) and same_bits(dist, rdist)):
        raise RuntimeError(f"K4 on {label} disagrees with its plain version: "
                           f"{int((idx != ridx).sum())} idx mismatches")


def graph_phase(world, gen, card) -> dict:
    """[graph]: config 4, rollout_with_graph at sim2d_graph_config for
    GRAPH_FLEET robots, GRAPH_MACROS macros after a warm-up macro on
    another fleet; K2 against its plain version on the edge problems of the
    graph tick that measured the most; an eviction run; host syncs of one
    graph_update. Returns the launches, K2's agreement and times."""
    import warnings

    from slam_tpu_torch.config import sim2d_graph_config
    from slam_tpu_torch.graph import pose_graph as pg
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.pipeline import slam2d
    cfg = sim2d_graph_config()
    dev = world.centers.device
    B = GRAPH_FLEET
    warm = slam2d.init_state(cfg, B, device=dev, generator=gen.manual_seed(5),
                             with_graph=True)
    slam2d.rollout_with_graph(warm, world, cfg, 1, gen, GRAPH_EVERY)
    del warm
    state = slam2d.init_state(cfg, B, device=dev,
                              generator=gen.manual_seed(6), with_graph=True)

    # record each graph tick's K2 operands and time the graph ticks with
    # events (neither waits for the card nor launches anything)
    k2_calls, tick_events = [], []
    k2, update = pg.icp_fused, slam2d.graph_update
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    est, true = [], []
    torch.cuda.synchronize()
    reset_counts(icp_fused, nn, particle)
    pg.icp_fused = kept(k2, k2_calls)
    slam2d.graph_update = event_timed(update, tick_events)
    try:
        e0.record()
        for _ in range(GRAPH_MACROS):
            state, (e, t) = slam2d.rollout_with_graph(state, world, cfg, 1,
                                                      gen, GRAPH_EVERY)
            est.append(e)
            true.append(t)
        e1.record()
        torch.cuda.synchronize()
    finally:
        pg.icp_fused, slam2d.graph_update = k2, update
    launches = {"K1": icp_fused.launches, "K2": icp_fused.packed_launches,
                "K4": nn.launches}
    ticks = GRAPH_MACROS * GRAPH_EVERY
    ms = e0.elapsed_time(e1) / ticks
    graph_ms = [a.elapsed_time(b) for a, b in tick_events]
    est, true = torch.cat(est, 1), torch.cat(true, 1)
    g = state.graph
    if est.shape != (B, ticks, 3):
        raise RuntimeError(f"config 4 trajectory shape {tuple(est.shape)}")
    if not bool(torch.isfinite(est).all() & torch.isfinite(g.node_pose).all()
                & torch.isfinite(state.map_cloud.xyz).all()):
        raise RuntimeError("config 4: non-finite poses, nodes or target")
    ate = slam2d.ate(est[:, 8:], true[:, 8:])
    med = float(ate.median())
    aligned = float(slam2d.ate_aligned(est[:, 8:], true[:, 8:]).median())
    nodes, edges = int(g.num_nodes.min()), int(g.num_edges.min())
    if launches["K1"] < ticks or launches["K2"] < GRAPH_MACROS or \
            launches["K4"] < GRAPH_MACROS:
        raise RuntimeError(f"config 4 launches {launches} in {ticks} ticks "
                           f"and {GRAPH_MACROS} graph ticks")
    if not med < GRAPH_ATE_LIMIT:
        raise RuntimeError(f"config 4 median ATE {med} m not below "
                           f"{GRAPH_ATE_LIMIT} m")
    if nodes < 2 or edges < 1:
        raise RuntimeError(f"config 4 graphs did not grow: min {nodes} "
                           f"keyframes, {edges} edges")

    # K2 against its plain version on the graph tick with the most valid
    # points in its edge problems (a tick that inserted keyframes)
    args = max((a for a, _ in k2_calls),
               key=lambda a: int(a[1].sum() + a[4].sum()))
    del k2_calls
    planes = icp_fused.packed_planes(*args[:6])
    n = args[0].shape[0]
    k2a = near_tie_agreement(
        "K2 on config 4's edges", icp_fused.icp_fused(*args),
        icp_fused.icp_fused_reference(*args), planes, args[6], args[7],
        n // 100, B // 2)
    k2_ms = cuda_ms(lambda: icp_fused.icp_fused(*args))
    k2_plain_ms = cuda_ms(lambda: icp_fused.icp_fused_reference(*args),
                          reps=1)
    k2_bound = bound(nbytes(*args[:7]) + n * (3 * 4 + 1 + 3 * 4),
                     icp_ops(planes, args[6], args[7]))
    iters = float(icp_fused.fit_iterations(*planes, args[6], args[7]).mean())

    # host syncs of one graph tick
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            slam2d.graph_update(state, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing" in str(w.message)]
    torch.cuda.synchronize()

    # eviction: a keyframe every graph tick fills every graph and evicts
    ecfg = cfg.replace(graph=dataclasses.replace(cfg.graph,
                                                 knn_dist_thresh=0.5))
    ev = slam2d.init_state(ecfg, B, device=dev, generator=gen.manual_seed(7),
                           with_graph=True)
    ev, (ee, _) = slam2d.rollout_with_graph(ev, world, ecfg, EVICT_MACROS,
                                            gen, GRAPH_EVERY)
    eg = ev.graph
    inserted = int(eg.node_stamp.amax(-1).min()) + 1
    if not bool(torch.isfinite(ee).all() & torch.isfinite(eg.node_pose).all()):
        raise RuntimeError("config 4 eviction run: non-finite poses")
    if not bool((eg.num_nodes == ecfg.graph.max_nodes).all() &
                ev.graph_full.all()) or inserted <= ecfg.graph.max_nodes:
        raise RuntimeError(f"config 4 eviction run: graphs not full or no "
                           f"eviction (min {int(eg.num_nodes.min())} nodes, "
                           f"{inserted} keyframes inserted)")
    print(f"[graph] config 4 B={B} {GRAPH_MACROS} macros x {GRAPH_EVERY} "
          f"ticks + a graph tick: {ms:.3f} ms/tick, {B * 1000.0 / ms:.1f} "
          f"robot-steps/s (graph ticks included), graph tick mean "
          f"{sum(graph_ms) / len(graph_ms):.3f} ms (max {max(graph_ms):.3f}),"
          f" median ATE {med:.4f} m (ticks>=8, {float(ate.max()):.4f} max; "
          f"aligned {aligned:.4f}), keyframes >= {nodes}, edges >= {edges}, "
          f"launches {launches}; K2 on {n} edge problems S=C=384 at "
          f"{args[7].max_iterations} iterations ({iters:.2f} run on "
          f"average) vs plain: {agreement_text(k2a)}; K2 {k2_ms:.4f} ms, "
          f"plain {k2_plain_ms:.4f} ms, bound "
          f"{k2_bound[0]:.6f} ms ({k2_bound[1]}); host syncs in one "
          f"graph_update (icp.loop {cfg.icp.loop}; a graph tick runs no "
          f"loop fit): {len(syncs)}{': ' + ' | '.join(syncs) if syncs else ''}"
          f"; eviction run ({EVICT_MACROS} macros, 0.5 m gate): all "
          f"{ecfg.graph.max_nodes} slots full, >= {inserted} keyframes "
          f"inserted, edges_dropped total {int(eg.edges_dropped.sum())} "
          f"(max {int(eg.edges_dropped.max())}) | {card}", flush=True)
    return dict(launches=launches, k2_err=k2a["err"], k2_ms=k2_ms,
                k2_plain_ms=k2_plain_ms, k2_bound=k2_bound, syncs=syncs)


def kabsch_on_card(n=4096, seed=31) -> dict:
    """ops/align.rigid_transform_3d on the card (n problems of 200 points:
    scatters, walls and flat patches, any rotation) against the f64 SVD
    Kabsch on the host: the largest rotation error, and the host syncs
    the card's call makes (the 3x3 SVD is Jacobi sweeps in tensor ops)."""
    from slam_tpu_torch.ops.align import rigid_transform_3d
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(n, 200, 3, generator=g, dtype=torch.float64) * \
        torch.tensor([8.0, 8.0, 0.8], dtype=torch.float64)
    a[0::3, :, 0] = 3.0                      # walls: H of rank 2
    a[1::3, :, 2] = 0.0                      # flat patches
    ang = (torch.rand(n, 3, generator=g, dtype=torch.float64) - 0.5) * 6.0
    from slam_tpu_torch.geometry import rot3_from_rpy
    R0 = rot3_from_rpy(ang[:, 0], ang[:, 1], ang[:, 2])
    b = a @ R0.mT + torch.randn(n, 1, 3, generator=g, dtype=torch.float64) \
        + 0.02 * torch.randn(a.shape, generator=g, dtype=torch.float64)
    w = (torch.rand(n, 200, generator=g) < 0.8).double()
    ca = (w[..., None] * a).sum(1) / w.sum(1, keepdim=True)
    cb = (w[..., None] * b).sum(1) / w.sum(1, keepdim=True)
    H = ((a - ca[:, None]) * w[..., None]).mT @ (b - cb[:, None])
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.mT @ U.mT))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                      d], -1))
    want = Vt.mT @ D @ U.mT
    args = [x.float().cuda() for x in (a, b, w)]
    got, syncs = count_syncs(lambda: rigid_transform_3d(*args))
    err = float((got.R.double().cpu() - want).abs().max())
    if err > 1e-4 or syncs:
        raise RuntimeError(f"rigid_transform_3d on the card: rotation err "
                           f"{err} against f64 SVD, host syncs {syncs}")
    return dict(err=err, syncs=len(syncs), n=n)


def graph3d_phase(gen, card) -> dict:
    """[graph3d]: config 4 in 3D at the reference's working point,
    slam3d.rollout_3d_with_graph at ref_scale_graph_config (engine "se2z",
    planar edges) for GRAPH3D_FLEET robots, GRAPH3D_MACROS macros of
    GRAPH_EVERY ticks after a warm-up macro on another fleet. Gates: K3
    every tick, K2's packed 2048 x 2048 edge problems of the graph tick
    that measured the most (they run on K3) against the plain version
    under [graph]'s near-tie rule, K4 on that tick's edge information
    equal to its plain version, >= 2 keyframes and >= 1 edge a robot,
    finite poses, graph and ground map, median ATE and mean |z error|, no
    host sync in one graph tick with its ground-map offset."""
    from slam_tpu_torch.config import ref_scale_graph_config
    from slam_tpu_torch.graph import pose_graph as pg
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.pipeline import slam2d, slam3d
    from slam_tpu_torch.sim import world3d
    cfg = ref_scale_graph_config()
    dev = torch.device("cuda")
    B = GRAPH3D_FLEET
    world = world3d.make_world(gen.manual_seed(42), cfg.sim, device=dev)
    warm = slam3d.init_state_3d(cfg, B, world, device=dev,
                                generator=gen.manual_seed(15),
                                with_graph=True)
    slam3d.rollout_3d_with_graph(warm, world, slam3d.init_ground_map(
        cfg, B, dev), cfg, 1, gen, GRAPH_EVERY)
    del warm
    state = slam3d.init_state_3d(cfg, B, world, device=dev,
                                 generator=gen.manual_seed(16),
                                 with_graph=True)
    gm = slam3d.init_ground_map(cfg, B, dev)

    k2_calls, nn_calls, tick_events = [], [], []
    k2, nn_fn, update = pg.icp_fused, pg.nearest_neighbor, \
        slam3d.graph_update_delta
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    est, true = [], []
    torch.cuda.synchronize()
    reset_counts(icp_fused, nn, particle)
    pg.icp_fused, pg.nearest_neighbor = kept(k2, k2_calls), kept(nn_fn,
                                                                  nn_calls)
    slam3d.graph_update_delta = event_timed(update, tick_events)
    try:
        e0.record()
        for _ in range(GRAPH3D_MACROS):
            state, gm, (e, t) = slam3d.rollout_3d_with_graph(
                state, world, gm, cfg, 1, gen, GRAPH_EVERY)
            est.append(e)
            true.append(t)
        e1.record()
        torch.cuda.synchronize()
    finally:
        pg.icp_fused, pg.nearest_neighbor = k2, nn_fn
        slam3d.graph_update_delta = update
    launches = {"K1": icp_fused.launches, "K2": icp_fused.packed_launches,
                "K3": icp_fused.tiled_launches, "K4": nn.launches}
    ticks = GRAPH3D_MACROS * GRAPH_EVERY
    ms = e0.elapsed_time(e1) / ticks
    graph_ms = [a.elapsed_time(b) for a, b in tick_events]
    est, true = torch.cat(est, 1), torch.cat(true, 1)
    g = state.graph
    if est.shape != (B, ticks, 4):
        raise RuntimeError(f"[graph3d] trajectory shape {tuple(est.shape)}")
    for what, x in (("est", est), ("nodes", g.node_pose),
                    ("target", state.map_cloud.xyz),
                    ("ground map", gm.grid.sum_z), ("edges", g.edge_rel)):
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"[graph3d]: non-finite values in {what}")
    ate = slam2d.ate(est[:, 8:], true[:, 8:])
    med = float(ate.median())
    z_err = float((est[:, 8:, 3] - true[:, 8:, 3]).abs().mean())
    nodes, edges = int(g.num_nodes.min()), int(g.num_edges.min())
    # K3 launches: one a tick (registration, S x C = 4096 x 40960) and one
    # a graph tick (the edges, 2048 x 2048 > RESIDENT_TILE_LIMIT)
    if launches["K3"] < ticks + GRAPH3D_MACROS or \
            launches["K2"] < GRAPH3D_MACROS or \
            launches["K4"] < GRAPH3D_MACROS:
        raise RuntimeError(f"[graph3d] launches {launches} in {ticks} ticks "
                           f"and {GRAPH3D_MACROS} graph ticks")
    if not med < GRAPH_ATE_LIMIT or not z_err < Z_3D_LIMIT:
        raise RuntimeError(f"[graph3d] median ATE {med} m (limit "
                           f"{GRAPH_ATE_LIMIT}), mean |z error| {z_err} m "
                           f"(limit {Z_3D_LIMIT})")
    if nodes < 2 or edges < 1:
        raise RuntimeError(f"[graph3d] graphs did not grow: min {nodes} "
                           f"keyframes, {edges} edges")

    # K2 (on K3) against its plain version on the edge problems of the
    # graph tick with the most valid points
    pick = max(range(len(k2_calls)), key=lambda i: int(
        k2_calls[i][0][1].sum() + k2_calls[i][0][4].sum()))
    args = k2_calls[pick][0]
    del k2_calls
    n, S = args[0].shape[:2]
    C = args[3].shape[1]
    if S * C <= icp_fused.RESIDENT_TILE_LIMIT:
        raise RuntimeError(f"[graph3d] edge problems {S} x {C} fit K1")
    planes = icp_fused.packed_planes(*args[:6])
    k3a = near_tie_agreement(
        "K3 on [graph3d]'s edges", icp_fused.icp_fused(*args),
        icp_fused.icp_fused_reference(*args), planes, args[6], args[7],
        max(1, n // 20), 1)
    k3_ms = cuda_ms(lambda: icp_fused.icp_fused(*args))
    k3_plain_ms = cuda_ms(lambda: icp_fused.icp_fused_reference(*args),
                          reps=1)
    k3_bound = bound(nbytes(*args[:7]) + n * (3 * 4 + 1 + 3 * 4),
                     icp_ops(planes, args[6], args[7]))
    iters = float(icp_fused.fit_iterations(*planes, args[6], args[7]).mean())
    # K4 on that graph tick's edge information, equal to its plain version
    nn_equal("[graph3d]'s edge information", nn_calls[pick])
    del nn_calls

    # its graph tick runs no loop fit (the edges run on K3): no host sync
    # in either icp.loop form
    for loop, fcfg in loop_forms(cfg).items():
        def tick(s=state, m=gm, c=fcfg):
            s2, d = slam3d.graph_update_delta(s, c)
            return s2, slam3d.apply_graph_offset(m, d)
        _, syncs = count_syncs(tick)
        if syncs:
            raise RuntimeError(f"[graph3d] graph tick host syncs with "
                               f"icp.loop {loop}: {sync_sites(syncs)}")
    print(f"[graph3d] config 4 in 3D at ref_scale_graph_config B={B} "
          f"{GRAPH3D_MACROS} macros x {GRAPH_EVERY} ticks + a graph tick, "
          f"after a warm-up macro: {ms:.3f} ms/tick, {B * 1000.0 / ms:.1f} "
          f"robot-steps/s (graph ticks included), graph tick mean "
          f"{sum(graph_ms) / len(graph_ms):.3f} ms (max {max(graph_ms):.3f})"
          f", host syncs in one graph tick and its ground-map offset 0 "
          f"with icp.loop scan and with while (no loop fit there), "
          f"median ATE {med:.4f} m (ticks>=8, {float(ate.max()):.4f} max), "
          f"mean |z error| {z_err:.4f} m, keyframes >= {nodes}, edges >= "
          f"{edges}, launches {launches}; K2 on {n} edge problems "
          f"S={S} C={C} at {args[7].max_iterations} iterations ({iters:.2f} "
          f"run on average) on K3 vs plain: {agreement_text(k3a)}; "
          f"{k3_ms:.4f} ms, plain "
          f"{k3_plain_ms:.4f} ms, bound {k3_bound[0]:.6f} ms ({k3_bound[1]})"
          f"; K4 on its edge information equal to plain | {card}",
          flush=True)
    return dict(launches=launches, ms=ms, graph_ms=graph_ms, k3_err=k3a["err"],
                k3_ms=k3_ms, k3_plain_ms=k3_plain_ms, k3_bound=k3_bound,
                tick=tick)


def se3_while_run(cfg, world, B, macros, update, gen) -> dict:
    """[se3]'s 3D-edge run with icp.loop "while" on a fresh fleet of the
    same seed: ms/tick, the graph ticks' ms and host syncs (gate: at most
    edge_icp_max_iter + 1 a graph tick, all in icp3d_fit), median ATE
    (gate SE3_ATE_LIMIT)."""
    from slam_tpu_torch.pipeline import slam2d, slam3d
    dev = torch.device("cuda")
    state = slam3d.init_state_3d(cfg, B, world, device=dev,
                                 generator=gen.manual_seed(18),
                                 with_graph=True)
    gm = slam3d.init_ground_map(cfg, B, dev)
    syncs, events = [], []

    def counted(s, c):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out, sy = count_syncs(lambda: update(s, c))
        ev[1].record()
        syncs.extend(sy)
        events.append(ev)
        return out
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    slam3d.graph_update_delta = counted
    try:
        e0.record()
        state, gm, (est, true) = slam3d.rollout_3d_with_graph(
            state, world, gm, cfg, macros, gen, GRAPH_EVERY)
        e1.record()
        torch.cuda.synchronize()
    finally:
        slam3d.graph_update_delta = update
    graph_ms = [a.elapsed_time(b) for a, b in events]
    med = float(slam2d.ate(est[:, 8:], true[:, 8:]).median())
    if not med < SE3_ATE_LIMIT:
        raise RuntimeError(f"[se3] icp.loop while: median ATE {med} m (limit "
                           f"{SE3_ATE_LIMIT})")
    most = while_sync_gate("[se3] (3d edges)", syncs, macros,
                           cfg.graph.edge_icp_max_iter, "icp3d.py")
    return dict(ms=e0.elapsed_time(e1) / (macros * GRAPH_EVERY),
                graph_ms=sum(graph_ms) / len(graph_ms),
                graph_max=max(graph_ms), syncs=syncs, most=most, med=med)


def se3_phase(gen, card) -> dict:
    """[se3]: config 4 in 3D with the 6-DoF chain at sim3d_se3_config
    (engine "se3", 3D ICP edges, 6 x 6 LUM information) for SE3_FLEET
    robots, SE3_MACROS macros of GRAPH_EVERY ticks after a warm-up macro
    on another fleet; then SE3_2D_MACROS macros of engine "se3" over
    planar edges. Gates: K1 every tick, node_rp finite, slam_tpu's own
    test bounds (median ATE, the SE3_NODE_QUANTILE robot's nodes near the
    true path, mean |z error|), no host sync in one graph tick with
    icp.loop "scan" (the runs' form); the 3D-edge run again with "while"
    (se3_while_run: at most edge_icp_max_iter + 1 host reads a graph
    tick, all in icp3d_fit; planar edges run no loop fit: none); K1 on the
    3D-edge run's last tick, K2 on the planar-edge run's edge problems of
    the graph tick with the most points against their plain versions
    (near_tie_agreement), K4 on that tick's edge information equal to its
    plain version; one 6-DoF relocalization edge on a kidnapped robot (the
    match its true pose) and optimize_native after it leave every pose
    finite."""
    from slam_tpu_torch.config import sim3d_se3_config
    from slam_tpu_torch.graph import pose_graph as pg
    from slam_tpu_torch.graph import pose_graph3d as pg3
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.pipeline import slam2d, slam3d
    from slam_tpu_torch.profile_tick import kidnap
    from slam_tpu_torch.sim import world3d
    cfg = sim3d_se3_config()
    dev = torch.device("cuda")
    B = SE3_FLEET
    world = world3d.make_world(gen.manual_seed(42), cfg.sim, device=dev)
    out = {"launches": {"K1": 0, "K2": 0, "K4": 0}}
    lines = []
    for edges, macros in (("3d", SE3_MACROS), ("2d", SE3_2D_MACROS)):
        forms = loop_forms(cfg.replace(graph=dataclasses.replace(
            cfg.graph, edge_registration=edges)))
        c = forms["scan"]
        warm = slam3d.init_state_3d(c, B, world, device=dev,
                                    generator=gen.manual_seed(17),
                                    with_graph=True)
        slam3d.rollout_3d_with_graph(warm, world, slam3d.init_ground_map(
            c, B, dev), c, 1, gen, GRAPH_EVERY)
        del warm
        state = slam3d.init_state_3d(c, B, world, device=dev,
                                     generator=gen.manual_seed(18),
                                     with_graph=True)
        gm = slam3d.init_ground_map(c, B, dev)
        tick_events, update = [], slam3d.graph_update_delta
        # record the kernels' operands: K1's on the ticks (3D edges), K2's
        # and K4's on the graph ticks (planar edges)
        k1_calls, k2_calls, nn_calls = [], [], []
        k1, k2, nn_fn = icp_fused.icp_fused_planes, pg.icp_fused, \
            pg.nearest_neighbor
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        reset_counts(icp_fused, nn, particle)
        slam3d.graph_update_delta = event_timed(update, tick_events)
        if edges == "3d":
            icp_fused.icp_fused_planes = kept(k1, k1_calls)
        else:
            pg.icp_fused, pg.nearest_neighbor = kept(k2, k2_calls), kept(
                nn_fn, nn_calls)
        try:
            e0.record()
            state, gm, (est, true) = slam3d.rollout_3d_with_graph(
                state, world, gm, c, macros, gen, GRAPH_EVERY)
            e1.record()
            torch.cuda.synchronize()
        finally:
            slam3d.graph_update_delta = update
            icp_fused.icp_fused_planes, pg.icp_fused, pg.nearest_neighbor = \
                k1, k2, nn_fn
        launches = {"K1": icp_fused.launches,
                    "K2": icp_fused.packed_launches, "K4": nn.launches}
        for k, v in launches.items():
            out["launches"][k] += v
        ticks = macros * GRAPH_EVERY
        ms = e0.elapsed_time(e1) / ticks
        graph_ms = [a.elapsed_time(b) for a, b in tick_events]
        g = state.graph
        finite = [torch.isfinite(x).all() for x in (
            est, g.node_pose, state.map_cloud.xyz, gm.grid.sum_z)]
        if edges == "3d":
            finite.append(torch.isfinite(g.node_rp).all())
        if not bool(torch.stack(finite).all()):
            raise RuntimeError(f"[se3] ({edges} edges): non-finite poses, "
                               f"attitudes, target or ground map")
        ate = slam2d.ate(est[:, 8:], true[:, 8:])
        med = float(ate.median())
        z_err = float((est[:, 8:, 3] - true[:, 8:, 3]).abs().mean())
        nodes = int(g.num_nodes.min())
        # each robot's farthest valid node from its true path; slam_tpu's
        # test holds one robot's, the fleet is held at its 0.99 quantile
        d = torch.cdist(g.node_pose[..., :2], true[..., :2]).amin(-1)
        node_off = torch.where(g.node_valid, d, 0.0).amax(-1)
        node_q = float(torch.quantile(node_off, SE3_NODE_QUANTILE))
        node_far = int((node_off >= SE3_NODE_LIMIT).sum())
        _, syncs = count_syncs(lambda s=state, cc=c: update(s, cc))
        if launches["K1"] < ticks or nodes < 2 or syncs or \
                not med < SE3_ATE_LIMIT or not z_err < SE3_Z_LIMIT or \
                not node_q < SE3_NODE_LIMIT:
            raise RuntimeError(
                f"[se3] ({edges} edges): launches {launches} in {ticks} "
                f"ticks, >= {nodes} keyframes, median ATE {med} m (limit "
                f"{SE3_ATE_LIMIT}; max {float(ate.max())}), mean |z error| "
                f"{z_err} m (limit {SE3_Z_LIMIT}), the {SE3_NODE_QUANTILE} "
                f"quantile robot's nodes {node_q} m off its true path (limit "
                f"{SE3_NODE_LIMIT}; max {float(node_off.max())}, {node_far} "
                f"robots at or beyond the limit), host syncs "
                f"{sync_sites(syncs)}")
        if edges == "3d":
            # K1 on the last tick's registration (against the regenerated
            # keyframe map)
            args = k1_calls[-1][0]
            del k1_calls
            held = near_tie_agreement(
                "K1 on [se3]'s last tick", icp_fused.icp_fused_planes(*args),
                icp_fused.icp_fused_planes_reference(*args), args[:6],
                args[6], args[7], max(1, B // 20), 1)
            held_text = (f"K1 on the last tick's (B={B}, S="
                         f"{args[0].shape[1]}, C={args[3].shape[1]}) "
                         f"registration vs plain: {agreement_text(held)}")
        else:
            # K2 on the planar edge problems of the graph tick with the most
            # valid points, K4 on that tick's edge information
            if len(k2_calls) != macros or len(nn_calls) != macros:
                raise RuntimeError(f"[se3] recorded {len(k2_calls)} K2 and "
                                   f"{len(nn_calls)} K4 calls in {macros} "
                                   f"graph ticks")
            pick = max(range(macros), key=lambda i: int(
                k2_calls[i][0][1].sum() + k2_calls[i][0][4].sum()))
            args = k2_calls[pick][0]
            del k2_calls
            n, S = args[0].shape[:2]
            held = near_tie_agreement(
                "K2 on [se3]'s planar edges", icp_fused.icp_fused(*args),
                icp_fused.icp_fused_reference(*args),
                icp_fused.packed_planes(*args[:6]), args[6], args[7],
                max(1, n // 20), 1)
            nn_equal("[se3]'s planar edge information", nn_calls[pick])
            held_text = (f"K2 on the {n} edge problems of S=C={S} of the "
                         f"graph tick with the most points vs plain: "
                         f"{agreement_text(held)}; K4 on their information "
                         f"equal to plain")
            del nn_calls
        out["k1_err" if edges == "3d" else "k2_err"] = held["err"]
        w = se3_while_run(forms["while"], world, B, macros, update, gen) \
            if edges == "3d" else None
        if w is None:       # planar edges: no loop fit in the graph tick
            _, w_syncs = count_syncs(lambda s=state, cc=forms["while"]:
                                     update(s, cc))
            while_sync_gate(f"[se3] ({edges} edges)", w_syncs, 0, 0,
                            "icp3d.py")
            w_text = "host syncs 0 with while too"
        else:
            w_text = (f"icp.loop while (a fresh fleet, the same seed): "
                      f"{w['ms']:.3f} ms/tick, graph tick mean "
                      f"{w['graph_ms']:.3f} ms (max {w['graph_max']:.3f}), "
                      f"host syncs {len(w['syncs'])} in {macros} graph ticks "
                      f"(bound {w['most']}; "
                      f"{sync_sites(w['syncs']) or 'none'}), median ATE "
                      f"{w['med']:.4f} m")
        line = (f"{edges} edges, {macros} macros, icp.loop scan: {ms:.3f} "
                f"ms/tick, {B * 1000.0 / ms:.1f} robot-steps/s, graph tick "
                f"mean {sum(graph_ms) / len(graph_ms):.3f} ms (max "
                f"{max(graph_ms):.3f}), host syncs 0; {w_text}; "
                f"median ATE {med:.4f} m"
                f" (ticks>=8, {float(ate.max()):.4f} max), mean |z error| "
                f"{z_err:.4f} m, nodes off the true path: median robot "
                f"{float(node_off.median()):.4f} m, {SE3_NODE_QUANTILE} "
                f"quantile {node_q:.4f} m (limit {SE3_NODE_LIMIT}), worst "
                f"{float(node_off.max()):.4f} m ({node_far} robots at or "
                f"beyond the limit), "
                f"keyframes >= {nodes}, edges >= {int(g.num_edges.min())}, "
                f"launches {launches}; {held_text}")
        if edges == "3d":
            kid = kidnap(state)
            only0 = torch.zeros(B, dtype=torch.bool, device=dev)
            only0[0] = True
            g2, injected = pg.relocalization_edge(
                kid.graph, kid.pose, kid.true_pose[:, :3], only0, c.graph)
            g2, _ = pg3.optimize_native(g2, c.graph)
            if not bool(injected[0]) or int(injected.sum()) != 1 or \
                    not bool(torch.isfinite(g2.node_pose).all() &
                             torch.isfinite(g2.node_rp).all()):
                raise RuntimeError(f"[se3] 6-DoF relocalization edge: "
                                   f"injected {injected.tolist()[:4]}..., "
                                   f"poses finite "
                                   f"{bool(torch.isfinite(g2.node_pose).all())}")
            line += ("; a 6-DoF relocalization edge on robot 0 kidnapped by "
                     "(8 m, -5 m, 1.2 rad), the match its true pose: "
                     "injected, poses and attitudes finite after "
                     "optimize_native")
            out["tick"] = lambda s=state, cc=c: update(s, cc)
            out["ms"], out["graph_ms"] = ms, graph_ms
        lines.append(line)
    k = kabsch_on_card()
    print(f"[se3] config 4 in 3D at sim3d_se3_config B={B}, each engine "
          f"after a warm-up macro: " + "; ".join(lines) + f"; "
          f"rigid_transform_3d on {k['n']} problems on the card: max "
          f"rotation err {k['err']:.3g} against the f64 SVD, host syncs "
          f"{k['syncs']} | {card}", flush=True)
    return out


def host_grid(grid):
    """A point-map grid's copy on the host."""
    return grid.replace(**{n: getattr(grid, n).cpu() for n in (
        "count", "sum_x", "sum_y", "sum_z", "center")})


def field_agreement(label, grid) -> dict:
    """The nearest-centroid field of `grid` built on the card against the
    field the CPU path builds from the same grid copied to the host:
    valid and n_class equal, px / py within FIELD_TOL except in cells
    where the two packages' picks lie within FIELD_TIE of each other from
    the cell centre (a near-tie, which the visiting order decides on
    roundings of equal distances)."""
    from slam_tpu_torch.ops.grid_icp import nearest_point_field
    host = host_grid(grid)
    card = nearest_point_field(grid, grid.resolution)
    plain = nearest_point_field(host, grid.resolution)
    G = plain.px.shape[-1]
    base = (torch.arange(G) - G // 2 + 0.5) * grid.resolution
    ccx = (base[None, :] + host.center[:, 0:1])[:, None, :, None]
    ccy = (base[None, :] + host.center[:, 1:2])[:, None, None, :]
    cx, cy = card.px.cpu(), card.py.cpu()
    off = torch.maximum((cx - plain.px).abs(), (cy - plain.py).abs())
    off = torch.where(plain.valid, off, 0.0)
    gap = ((cx - ccx) ** 2 + (cy - ccy) ** 2 -
           (plain.px - ccx) ** 2 - (plain.py - ccy) ** 2).abs()
    apart = off > FIELD_TOL
    tied = apart & (gap <= FIELD_TIE)
    a = dict(valid_mism=int((card.valid.cpu() != plain.valid).sum()),
             n_class_mism=int((card.n_class.cpu() != plain.n_class).sum()),
             max_off=float(off.max()), n_apart=int(apart.sum()),
             n_tied=int(tied.sum()), cells=int(plain.valid.sum()))
    if a["valid_mism"] or a["n_class_mism"] or a["n_apart"] > a["n_tied"]:
        raise RuntimeError(f"{label}: the card's field disagrees with the "
                           f"CPU path's: {a}")
    return a


def field_text(a) -> str:
    return (f"field on the card vs the CPU path on the same grid: valid and "
            f"n_class equal over {a['cells']} valid cells, px/py max diff "
            f"{a['max_off']:.3g} m, {a['n_apart']} cells beyond {FIELD_TOL} "
            f"m, all near-ties (picks within {FIELD_TIE} m^2 of each other "
            f"from the cell centre: {a['n_tied']})")


def refgrid_phase(gen, card) -> None:
    """[refgrid]: bench.py's bench_ref_scale configuration on the card,
    slam3d.rollout_3d at ref_scale_config with icp.matcher "grid" (20,480-
    ray scans, a scene of 4,096, a 384 x 384 map grid at 0.5 m, height
    source "grid") for FLEET_REF robots, TICKS_REF ticks after a warm-up
    macro. Gates (tests/test_scale_rollout.py's): median ATE, mean |z
    error|, every robot registered on its last tick; no K1, K3 or K4
    launch; with icp.loop "scan" no host sync in one macro (its field
    build, shifts and 4 ticks); the last macro's field on the card against
    the CPU path's (field_agreement), and icp_fit_grid on the last tick's
    scenes against the CPU run (pose within POSE_TOL, ok equal). Then the
    same run with icp.loop "while" (slam_tpu's default): ms/tick, the ATE
    and z gates, and at most max_iterations + 1 host reads a fit, all in
    icp_fit_grid, in one macro."""
    from slam_tpu_torch.config import ref_scale_config
    from slam_tpu_torch.ops import grid_icp, icp_fused, nn, particle
    from slam_tpu_torch.pipeline import slam2d, slam3d
    from slam_tpu_torch.sim import world3d
    cfg = ref_scale_config()
    forms = loop_forms(cfg.replace(icp=dataclasses.replace(cfg.icp,
                                                           matcher="grid")))
    cfg = forms["scan"]
    dev = torch.device("cuda")
    B, ticks = FLEET_REF, TICKS_REF
    world = world3d.make_world(gen.manual_seed(42), cfg.sim, device=dev)
    state = slam3d.init_state_3d(cfg, B, world, device=dev,
                                 generator=gen.manual_seed(0))
    gm = slam3d.init_ground_map(cfg, B, dev)
    state, gm, _ = slam3d.rollout_3d(state, world, gm, cfg, 4, gen)
    grids, fits = [], []
    build, fit = slam3d.nearest_point_field, slam3d.icp_fit_grid
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    reset_counts(icp_fused, nn, particle)
    slam3d.nearest_point_field = kept(build, grids)
    slam3d.icp_fit_grid = kept(fit, fits)
    try:
        e0.record()
        state, gm, (est, true, reg_ok) = slam3d.rollout_3d(
            state, world, gm, cfg, ticks, gen)
        e1.record()
        torch.cuda.synchronize()
    finally:
        slam3d.nearest_point_field, slam3d.icp_fit_grid = build, fit
    launches = {"K1": icp_fused.launches, "K3": icp_fused.tiled_launches,
                "K4": nn.launches}
    ms = e0.elapsed_time(e1) / ticks
    if est.shape != (B, ticks, 4) or len(grids) != ticks // 4 or \
            len(fits) != ticks:
        raise RuntimeError(f"[refgrid] trajectory {tuple(est.shape)}, "
                           f"{len(grids)} field builds, {len(fits)} fits")
    for what, x in (("est", est), ("map", state.map_grid.count),
                    ("ground map", gm.grid.sum_z)):
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"[refgrid]: non-finite values in {what}")
    ate = slam2d.ate(est[:, 4:], true[:, 4:])
    ate_al = slam2d.ate_aligned(est[:, 4:], true[:, 4:])
    med, med_al = float(ate.median()), float(ate_al.median())
    z_err = float((est[:, 4:, 3] - true[:, 4:, 3]).abs().mean())
    ok_share = float(reg_ok.float().mean())
    if any(launches.values()):
        raise RuntimeError(f"[refgrid] the grid path launched {launches}")
    if not med < ATE_REF_LIMIT or not z_err < Z_REF_LIMIT:
        raise RuntimeError(f"[refgrid] median ATE {med} m (limit "
                           f"{ATE_REF_LIMIT}), mean |z error| {z_err} m "
                           f"(limit {Z_REF_LIMIT})")
    if not bool(state.scan_reg_ok.all()):
        raise RuntimeError(f"[refgrid] {int((~state.scan_reg_ok).sum())} "
                           f"robots did not register on the last tick")

    last_grid = grids[-1][0][0]
    fa = field_agreement("[refgrid]", last_grid)
    (sx, sv, sga, field, pred, icfg), _ = fits[-1]
    got = fit(sx, sv, sga, field, pred, icfg)
    hfield = grid_icp.nearest_point_field(host_grid(last_grid),
                                          field.resolution,
                                          icfg.ga_threshold)
    ref = fit(sx.cpu(), sv.cpu(), sga.cpu(), hfield, pred.cpu(), icfg)
    fit_err = float((got.pose.cpu() - ref.pose).abs().max())
    fit_ok_mism = int((got.ok.cpu() != ref.ok).sum())
    if fit_err > POSE_TOL or fit_ok_mism:
        raise RuntimeError(f"[refgrid] icp_fit_grid on the card vs the CPU: "
                           f"pose err {fit_err}, ok mismatches {fit_ok_mism}")
    del grids, fits

    def tick(s=state, m=gm, f=field):
        return slam3d.slam_step_3d(s, world, m, cfg, gen, refresh_map=False,
                                   shift_maps=False, field=f)
    tick_ops = device_ops(tick)["n"]
    field_ops = device_ops(lambda: grid_icp.nearest_point_field(
        state.map_grid, field.resolution, icfg.ga_threshold))["n"]
    _, syncs = count_syncs(lambda: slam3d.rollout_3d(state, world, gm, cfg,
                                                     4, gen))
    if syncs:
        raise RuntimeError(f"[refgrid] host syncs in one macro: "
                           f"{sync_sites(syncs)}")
    del state, gm

    # icp.loop "while": the same run, early exits read on the host
    wcfg = forms["while"]
    ws = slam3d.init_state_3d(wcfg, B, world, device=dev,
                              generator=gen.manual_seed(0))
    wgm = slam3d.init_ground_map(wcfg, B, dev)
    ws, wgm, _ = slam3d.rollout_3d(ws, world, wgm, wcfg, 4, gen)
    torch.cuda.synchronize()
    e0.record()
    ws, wgm, (west, wtrue, _) = slam3d.rollout_3d(ws, world, wgm, wcfg,
                                                  ticks, gen)
    e1.record()
    torch.cuda.synchronize()
    w_ms = e0.elapsed_time(e1) / ticks
    w_med = float(slam2d.ate(west[:, 4:], wtrue[:, 4:]).median())
    w_z = float((west[:, 4:, 3] - wtrue[:, 4:, 3]).abs().mean())
    if not w_med < ATE_REF_LIMIT or not w_z < Z_REF_LIMIT:
        raise RuntimeError(f"[refgrid] icp.loop while: median ATE {w_med} m "
                           f"(limit {ATE_REF_LIMIT}), mean |z error| {w_z} m "
                           f"(limit {Z_REF_LIMIT})")
    _, w_syncs = count_syncs(lambda: slam3d.rollout_3d(ws, world, wgm, wcfg,
                                                       4, gen))
    w_most = while_sync_gate("[refgrid]", w_syncs, 4,
                             wcfg.icp.max_iterations, "grid_icp.py")
    print(f"[refgrid] config 2 at ref_scale_config with matcher grid "
          f"(bench.py's bench_ref_scale) B={B} {ticks} ticks after a warm-up "
          f"macro, icp.loop scan: {ms:.3f} ms/tick, "
          f"{B * 1000.0 / ms:.1f} robot-steps/s, "
          f"device ops a tick {ops_text(tick_ops)} and a field build "
          f"{ops_text(field_ops)} (one "
          f"a macro of 4 ticks), median ATE {med:.4f} m raw, {med_al:.4f} m "
          f"aligned (ticks>=4, {float(ate.max()):.4f} max raw), mean |z "
          f"error| {z_err:.4f} m, registration ok share {ok_share:.4f}, "
          f"every robot registered on the last tick, host syncs in one "
          f"macro 0, launches {launches}; {field_text(fa)}; icp_fit_grid on "
          f"the last tick's scenes vs the CPU: max pose err {fit_err:.3g} "
          f"(bound {POSE_TOL}), ok mismatches 0; icp.loop while: "
          f"{w_ms:.3f} ms/tick, median ATE {w_med:.4f} m, mean |z error| "
          f"{w_z:.4f} m, host syncs in one macro {len(w_syncs)} (bound "
          f"{w_most}; {sync_sites(w_syncs) or 'none'}) | {card}", flush=True)


def centroid_sets(sx, sy, ga, keep) -> list:
    """Each robot's scene as tests/test_scale.py's _centroid_set rounds it:
    sorted (x, y, ga) with x and y rounded to 4 decimals."""
    sx, sy, ga, keep = (t.cpu().numpy() for t in (sx, sy, ga, keep))
    return [sorted((round(float(x), 4), round(float(y), 4), bool(g))
                   for x, y, g in zip(sx[b][keep[b]], sy[b][keep[b]],
                                      ga[b][keep[b]]))
            for b in range(sx.shape[0])]


def same_centroids(label, a, b) -> int:
    """Robots whose centroid sets a and b (centroid_sets) are equal, or
    differ only where one centroid rounds to either side of a 1e-4 step
    (the two builders sum a cell's points in other orders: ulps apart).
    Returns the number of such rounding straddles; raises otherwise."""
    straddles = 0
    for r, (sa, sb) in enumerate(zip(a, b)):
        if sa == sb:
            continue
        ra, rb = sorted(set(sa) - set(sb)), sorted(set(sb) - set(sa))
        ok = len(sa) == len(sb) and len(ra) == len(rb) and all(
            p[2] == q[2] and abs(p[0] - q[0]) <= 1.5e-4 and
            abs(p[1] - q[1]) <= 1.5e-4 for p, q in zip(ra, rb))
        if not ok:
            raise RuntimeError(f"{label}: robot {r}'s centroid sets differ: "
                               f"{ra[:4]} vs {rb[:4]}")
        straddles += len(ra)
    return straddles


def grid2d_phase(world, gen, card) -> None:
    """[grid2d]: config 1 with matcher "grid" (examples/run_fleet.py
    --matcher grid): slam2d.rollout at sim2d_config for FLEET robots,
    TICKS ticks after a warm-up macro, in both icp.loop forms. Gates:
    median ATE below GRID_ATE_LIMIT (tests/test_grid_icp.py's), no K1 or
    K4 launch; in one macro no host sync with "scan", and with "while" at
    most max_iterations + 1 a fit, all in icp_fit_grid. Then
    build_scene_planes on the card: the fleet's
    last scans through the "incidence" and "grid" builders, and
    WIDE_ROBOTS robots' WIDE_BEAMS-beam scans that "auto" routes to the
    grid builder against "incidence" (compacted into WIDE_CAPACITY slots,
    which hold their cells), must give each robot the same centroids and
    GA flags (same_centroids); both builders on ga_num_bins cells, so that
    their extents agree."""
    from slam_tpu_torch.config import sim2d_config
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.pipeline import slam2d
    from slam_tpu_torch.sim import world2d
    forms = loop_forms(dataclasses.replace(
        sim2d_config(), icp=dataclasses.replace(sim2d_config().icp,
                                                matcher="grid")))
    dev = torch.device("cuda")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    runs = {}
    for loop, cfg in forms.items():
        state = slam2d.init_state(cfg, FLEET, device=dev,
                                  generator=gen.manual_seed(6))
        state, _ = slam2d.rollout(state, world, cfg, 4, gen)
        torch.cuda.synchronize()
        reset_counts(icp_fused, nn, particle)
        e0.record()
        state, (est, true) = slam2d.rollout(state, world, cfg, TICKS, gen)
        e1.record()
        torch.cuda.synchronize()
        launches = {"K1": icp_fused.launches, "K4": nn.launches}
        ms = e0.elapsed_time(e1) / TICKS
        if est.shape != (FLEET, TICKS, 3) or not bool(
                torch.isfinite(est).all()):
            raise RuntimeError(f"[grid2d] trajectory {tuple(est.shape)}, or "
                               f"not finite")
        ate = slam2d.ate(est[:, 10:], true[:, 10:])
        med = float(ate.median())
        if any(launches.values()):
            raise RuntimeError(f"[grid2d] the grid path launched {launches}")
        if not med < GRID_ATE_LIMIT:
            raise RuntimeError(f"[grid2d] icp.loop {loop}: median ATE {med} "
                               f"m not below {GRID_ATE_LIMIT} m")
        _, syncs = count_syncs(lambda: slam2d.rollout(state, world, cfg, 4,
                                                      gen))
        if loop == "scan" and syncs:
            raise RuntimeError(f"[grid2d] host syncs in one macro: "
                               f"{sync_sites(syncs)}")
        most = while_sync_gate("[grid2d]", syncs, 4, cfg.icp.max_iterations,
                               "grid_icp.py") if loop == "while" else 0
        runs[loop] = dict(ms=ms, med=med, ate_max=float(ate.max()),
                          ok_share=float(state.scan_reg_ok.float().mean()),
                          syncs=syncs, most=most)
        if loop == "scan":
            del state
    form_text = "; ".join(
        f"icp.loop {loop}: {r['ms']:.3f} ms/tick, "
        f"{FLEET * 1000.0 / r['ms']:.1f} robot-steps/s, median ATE "
        f"{r['med']:.4f} m (ticks>=10, {r['ate_max']:.4f} max), ok share on "
        f"the last tick {r['ok_share']:.4f}, host syncs in one macro "
        f"{len(r['syncs'])}" + (f" (bound {r['most']}; "
                                f"{sync_sites(r['syncs']) or 'none'})"
                                if loop == "while" else "")
        for loop, r in runs.items())
    cfg = forms["scan"]

    # the scene builders on the card
    G = cfg.icp.ga_num_bins
    same = dataclasses.replace(cfg, icp=dataclasses.replace(
        cfg.icp, scan_grid_bins=G))
    inc = dataclasses.replace(same, cloud=dataclasses.replace(
        same.cloud, scene_builder="incidence"))
    grd = dataclasses.replace(same, cloud=dataclasses.replace(
        same.cloud, scene_builder="grid"))
    ranges, hit = world2d.raycast(world, state.true_pose[:, :3], cfg.sim,
                                  generator=gen)
    x, y, h = world2d.scan_to_planes(ranges, hit)
    fleet_a = centroid_sets(*slam2d.build_scene_planes(x, y, h, inc))
    fleet_b = centroid_sets(*slam2d.build_scene_planes(x, y, h, grd))
    fleet_straddles = same_centroids("[grid2d] fleet scans", fleet_a,
                                     fleet_b)
    wide_sim = dataclasses.replace(cfg.sim, num_beams=WIDE_BEAMS)
    wide = dataclasses.replace(same, cloud=dataclasses.replace(
        same.cloud, scene_capacity=WIDE_CAPACITY, scene_builder="auto"))
    ranges, hit = world2d.raycast(world, state.true_pose[:WIDE_ROBOTS, :3],
                                  wide_sim, generator=gen)
    x, y, h = world2d.scan_to_planes(ranges, hit)
    auto = slam2d.build_scene_planes(x, y, h, wide)
    cells = int(auto[3].sum(-1).max())
    if cells >= WIDE_CAPACITY:
        raise RuntimeError(f"[grid2d] {cells} cells of a {WIDE_BEAMS}-beam "
                           f"scan fill scene_capacity {WIDE_CAPACITY}")
    wide_inc = dataclasses.replace(wide, cloud=dataclasses.replace(
        wide.cloud, scene_builder="incidence"))
    wide_straddles = same_centroids(
        "[grid2d] wide scans", centroid_sets(*auto), centroid_sets(
            *slam2d.build_scene_planes(x, y, h, wide_inc)))
    print(f"[grid2d] config 1 with matcher grid (examples/run_fleet.py "
          f"--matcher grid) B={FLEET} {TICKS} ticks after a warm-up macro, "
          f"{form_text}, launches {launches}; build_scene_planes on the card, "
          f"incidence vs grid on {G} x {G} cells: the fleet's last scans "
          f"({FLEET} robots, {sum(map(len, fleet_a))} centroids) and "
          f"{WIDE_ROBOTS} robots' {WIDE_BEAMS}-beam scans (auto -> grid vs "
          f"incidence compacted into {WIDE_CAPACITY} slots, up to {cells} "
          f"cells) give the same centroid sets and GA flags (rounded to 4 "
          f"decimals; {fleet_straddles} + {wide_straddles} centroids "
          f"straddle a rounding step) | {card}", flush=True)


def need_launches(label, got, *kernels) -> None:
    """Raise unless each of `kernels` launched in `got` (kernel: count)."""
    for k in kernels:
        if not got.get(k):
            raise RuntimeError(f"[entry] {label}: {k} never launched ({got})")


def entry_phase(card) -> dict:
    """[entry]: the user entry points (python3 -m slam_tpu_torch.<name>)
    through their run() on the card at full width, each world and state
    from generators seeded 42 and 0 as their main() makes them:
    run_fleet at B = FLEET, ENTRY_STEPS steps (run twice, the second
    timed) with "fused" (K1), "points" (K4) and "grid", then --shared-map
    with "fused" and with "particle" (config 5, K5); run_sim2d with and
    without --graph (K1; K2 and K4 on the edges); run_sim3d at sim3d (K1)
    and --ref-scale ("grid"); run_reloc --graph --save-pcd (K1, K2, K4 in
    the polish), then --prior-pcd on the saved map; eviction_study at
    --max-nodes 16 and 64; make_replay's file, equal bit for bit to
    synth_frames', replayed by the native loader into live.consume.
    Gates (PERF.md section 2): the fleet's median ATE over ticks >= 10 of
    the mission (both runs) below 0.1 m ("fused", "points", shared
    "fused"), 0.3 m ("grid"), 0.5 m ("particle"), every robot registered
    at the end of both shared-map runs (the printed median xy error at
    the end is reported); ATE below ATE_LIMIT for run_sim2d (config 1's),
    GRAPH_ATE_LIMIT with --graph (config 4's); xy ATE and mean |z error|
    below 0.5 / 0.4 m at sim3d and 0.2 / 0.4 m at the reference scale
    (its 16-tick z bound, 0.1 m, fails over 60 steps on this world in
    slam_tpu too: tests/test_torch_ref_height.py);
    the relocalized belief within RELOC_LIMIT, the edge injected with
    --graph; the replay's frames consumed, median position error below
    LIVE_ERR_LIMIT; each kernel of a run launched. K1 on the "fused"
    fleet's last tick, K2 on run_sim2d --graph's edges (its graph tick
    with the most points) and K5 on the particle fleet's last scoring are
    held to their plain versions, K4 equal on the "points" fleet's and the
    polish's last calls, each call's arguments cloned at the call.
    Every count is set to 0 just before each run and read after it;
    returns the sums and the kernels' errors."""
    from slam_tpu_torch import (eviction_study, live, make_replay, run_fleet,
                                run_reloc, run_sim2d, run_sim3d)
    from slam_tpu_torch.config import sim2d_config
    from slam_tpu_torch.graph import pose_graph as pg
    from slam_tpu_torch.ops import icp as icp_mod
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.pipeline import slam2d, slam3d
    from slam_tpu_torch.runtime import native
    from slam_tpu_torch.sim import replay, world2d, world3d
    dev = torch.device("cuda")
    total = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K5 table"), 0)
    out = {"k1_err": 0.0, "k2_err": 0.0}

    def say(text):
        print(f"[entry] {text} | {card}", flush=True)

    def seeded():
        return (torch.Generator(dev).manual_seed(42),
                torch.Generator(dev).manual_seed(0))

    def counted(fn):
        """fn() between a reset of every count and their reading."""
        torch.cuda.synchronize()
        reset_counts(icp_fused, nn, particle)
        r = fn()
        torch.cuda.synchronize()
        got = {"K1": icp_fused.launches, "K2": icp_fused.packed_launches,
               "K3": icp_fused.tiled_launches, "K4": nn.launches,
               "K5": particle.launches, "K5 table": particle.pack_launches}
        for k, v in got.items():
            total[k] += v
        return r, {k: v for k, v in got.items() if v}

    # run_fleet, B = FLEET
    base = sim2d_config()
    for matcher, shared, limit in (("fused", False, ATE_LIMIT),
                                   ("points", False, ATE_LIMIT),
                                   ("grid", False, GRID_ATE_LIMIT),
                                   ("fused", True, ATE_LIMIT),
                                   ("particle", True, PF_ATE_LIMIT)):
        cfg = dataclasses.replace(base, icp=dataclasses.replace(
            base.icp, matcher=matcher))
        g42, g0 = seeded()
        world = world2d.make_world(g42, cfg.sim, device=dev)
        states = slam2d.init_state(cfg, FLEET, device=dev, generator=g0)
        label = f"run_fleet --matcher {matcher}" + (
            " --shared-map" if shared else "")
        calls, patched = [], None
        if matcher == "fused" and not shared:
            patched = (icp_fused, "icp_fused_planes")
        elif matcher == "points":
            patched = (icp_mod, "nearest_neighbor")
        elif matcher == "particle":
            patched = (particle, "_score_kernel")
        if patched:
            fn = getattr(*patched)
            setattr(*patched, kept(fn, calls, copy=True, last=True))
        try:
            r, got = counted(lambda: run_fleet.run(
                cfg, world, states, ENTRY_STEPS, g0, shared_map=shared))
        finally:
            if patched:
                setattr(*patched, fn)
        del states
        # PERF.md section 2's bound: the median per-robot ATE over ticks
        # >= 10 of the mission (both runs)
        med = float(slam2d.ate(r["est"][:, 10:], r["true"][:, 10:]).median())
        if not med < limit or (shared and r["icp_ok"] != FLEET):
            raise RuntimeError(f"[entry] {label}: median ATE {med} m (limit "
                               f"{limit}), icp ok {r['icp_ok']}/{FLEET}, "
                               f"fleet median xy error at the end "
                               f"{r['median_err']} m")
        need_launches(label, got, *{
            "fused": ("K1",), "points": ("K4",), "grid": (),
            "particle": ("K5", "K5 table")}[matcher])
        if matcher == "grid" and got:
            raise RuntimeError(f"[entry] {label} launched {got}")
        held = ""
        if matcher == "fused" and not shared:
            args = calls[0][0]
            a = near_tie_agreement(
                "K1 on [entry]'s fused fleet", icp_fused.icp_fused_planes(
                    *args), icp_fused.icp_fused_planes_reference(*args),
                args[:6], args[6], args[7], max(1, FLEET // 20), 1)
            out["k1_err"] = a["err"]
            held = f"; K1 on its last tick vs plain: {agreement_text(a)}"
        elif matcher == "points":
            nn_equal("[entry]'s points fleet", calls[0])
            held = "; K4 on its last call equal to plain"
        elif matcher == "particle":
            bits, grid, scan_xy, valid, parts, res = calls[0][0]
            frac = particle._score_kernel(bits, grid, scan_xy, valid, parts,
                                          res)
            ref = particle.score_particles_reference(grid, scan_xy, valid,
                                                     parts, res)
            torch.cuda.synchronize()
            if not same_bits(frac, ref) or not torch.equal(
                    bits, particle.occupancy_bits_reference(grid.count)):
                raise RuntimeError("[entry] K5 on the particle fleet's last "
                                   "scoring disagrees with its plain version")
            held = "; K5 and its bit table on its last scoring equal to plain"
        del calls
        say(f"{label}: {r['rate']:,.0f} robot-steps/s, median ATE "
            f"{med:.4f} m (ticks>=10 of {r['est'].shape[1]}, limit "
            f"{limit}), fleet median xy error at the end "
            f"{r['median_err']:.4f} m, icp ok {r['icp_ok']}/{FLEET}"
            f", launches {got}{held}")
        del r

    # run_sim2d, one robot
    for graph in (False, True):
        cfg = sim2d_config()
        g42, g0 = seeded()
        world = world2d.make_world(g42, cfg.sim, device=dev)
        state = slam2d.init_state(cfg, 1, device=dev, generator=g0,
                                  with_graph=graph)
        calls, k2 = [], pg.icp_fused
        pg.icp_fused = kept(k2, calls, copy=True)
        try:
            r, got = counted(lambda: run_sim2d.run(
                cfg, world, state, ENTRY_SIM2D_STEPS, g0, graph=graph))
        finally:
            pg.icp_fused = k2
        label = "run_sim2d" + (" --graph" if graph else "")
        # config 1's bound, and config 4's with the pose graph
        limit = GRAPH_ATE_LIMIT if graph else ATE_LIMIT
        if not r["ate"] < limit:
            raise RuntimeError(f"[entry] {label}: ATE {r['ate']} m (limit "
                               f"{limit})")
        need_launches(label, got, "K1", *(("K2", "K4") if graph else ()))
        held, extra = "", ""
        if graph:
            if r["edges"] < 1:
                raise RuntimeError(f"[entry] {label}: no edge in "
                                   f"{r['keyframes']} keyframes")
            args = max(calls, key=lambda c: int(
                c[0][1].sum() + c[0][4].sum()))[0]
            a = near_tie_agreement(
                "K2 on [entry]'s run_sim2d --graph edges",
                icp_fused.icp_fused(*args), icp_fused.icp_fused_reference(
                    *args), icp_fused.packed_planes(*args[:6]), args[6],
                args[7], max(1, args[0].shape[0] // 20), 1)
            out["k2_err"] = a["err"]
            extra = f", keyframes {r['keyframes']}, edges {r['edges']}"
            held = (f"; K2 on the {args[0].shape[0]} edge problems of its "
                    f"graph tick with the most points vs plain: "
                    f"{agreement_text(a)}")
        say(f"{label} --steps {ENTRY_SIM2D_STEPS}: ATE "
            f"{r['ate']:.4f} m (limit {limit}), map points "
            f"{r['map_points']}{extra}"
            f", launches {got}{held}")
        del calls

    # run_sim3d, one robot. At the reference scale its z is held to
    # sim3d's bound: on this world both packages read the wheel-contact
    # height a sensor height low on some ticks (tests/test_torch_ref_height
    # .py), past Z_REF_LIMIT's 16-tick bound over 60 steps
    for ref_scale, xy_limit, z_limit in ((False, ATE_3D_LIMIT, Z_3D_LIMIT),
                                         (True, ATE_REF_LIMIT, Z_3D_LIMIT)):
        cfg = run_sim3d.config(ref_scale)
        g42, g0 = seeded()
        world = world3d.make_world(g42, cfg.sim, device=dev)
        st = slam3d.init_state_3d(cfg, 1, world, device=dev, generator=g0)
        gm = slam3d.init_ground_map(cfg, 1, dev)
        r, got = counted(lambda: run_sim3d.run(cfg, world, st, gm,
                                               ENTRY_SIM3D_STEPS, g0))
        label = "run_sim3d" + (" --ref-scale" if ref_scale else "")
        if not r["xy_ate"] < xy_limit or not r["z_err"] < z_limit:
            raise RuntimeError(f"[entry] {label}: xy ATE {r['xy_ate']} m "
                               f"(limit {xy_limit}), mean |z error| "
                               f"{r['z_err']} m (limit {z_limit})")
        if ref_scale and got:
            raise RuntimeError(f"[entry] {label} (grid) launched {got}")
        if not ref_scale:
            need_launches(label, got, "K1")
        say(f"{label} --steps {ENTRY_SIM3D_STEPS}: xy ATE "
            f"{r['xy_ate']:.4f} m (limit {xy_limit}), mean |z "
            f"error| {r['z_err']:.4f} m (limit {z_limit}), icp ok "
            f"{r['icp_ok']}, launches {got}")

    # run_reloc: --graph --save-pcd, then --prior-pcd on that map
    native.build()
    pcd = native.BUILD_DIR / "entry_map.pcd"
    reloc = []
    for graph, save, prior in ((True, str(pcd), None),
                               (False, None, str(pcd))):
        cfg = run_reloc.config()
        g42, g0 = seeded()
        world = world2d.make_world(g42, cfg.sim, device=dev)
        st = slam2d.init_state(cfg, 1, device=dev, generator=g0,
                               with_graph=graph)
        calls, nn_fn = [], icp_mod.nearest_neighbor
        icp_mod.nearest_neighbor = kept(nn_fn, calls, copy=True, last=True)
        try:
            r, got = counted(lambda: run_reloc.run(
                cfg, world, st, ENTRY_RELOC_STEPS, g0, graph=graph,
                save_pcd=save, prior_pcd=prior))
        finally:
            icp_mod.nearest_neighbor = nn_fn
        label = "run_reloc" + (" --graph --save-pcd" if graph else
                               " --prior-pcd")
        if not r["ok"] or not r["err1"] < RELOC_LIMIT or (
                graph and not r["injected"]):
            raise RuntimeError(f"[entry] {label}: match ok {r['ok']} (score "
                               f"{r['score']}), belief {r.get('err1')} m from "
                               f"the truth (limit {RELOC_LIMIT}), edge "
                               f"injected {r.get('injected')}")
        need_launches(label, got, "K1", "K4", *(("K2",) if graph else ()))
        nn_equal(f"[entry]'s {label} polish", calls[0])
        reloc.append(r)
        say(
            f"{label}: mapped {ENTRY_RELOC_STEPS} steps, ATE "
            f"{r['map_ate']:.4f} m, " + (
                f"{r['saved_points']} map points saved, " if graph else
                f"{r['prior_points']} prior points, ") +
            f"kidnapped {r['err0']:.3f} m -> {r['err1']:.4f} m, score "
            f"{r['score']:.3f}" + (f", edge injected ({r['edges_after']} "
                                   f"edges)" if graph else "") +
            f", launches {got}; K4 on the polish's last call equal to plain")
    if reloc[1]["prior_points"] != reloc[0]["saved_points"]:
        raise RuntimeError(f"[entry] run_reloc's pcd round trip: "
                           f"{reloc[0]['saved_points']} points saved, "
                           f"{reloc[1]['prior_points']} read back")

    # eviction_study, one robot
    for nodes in ENTRY_EVICT_NODES:
        cfg = eviction_study.config(nodes)
        g42, g0 = seeded()
        world = world2d.make_world(g42, cfg.sim, device=dev)
        st = slam2d.init_state(cfg, 1, device=dev, generator=g0,
                               with_graph=True)
        r, got = counted(lambda: eviction_study.run(
            cfg, world, st, ENTRY_EVICT_MACROS, g0))
        label = f"eviction_study --max-nodes {nodes}"
        if not np.isfinite(r["overall"]) or r["nodes"] < 2:
            raise RuntimeError(f"[entry] {label}: overall ATE "
                               f"{r['overall']}, {r['nodes']} nodes")
        need_launches(label, got, "K1", "K2", "K4")
        say(
            f"{label} --macros {ENTRY_EVICT_MACROS}: nodes {r['nodes']}, "
            f"edges {r['edges']}, edges_dropped {r['edges_dropped']}, full "
            f"{r['full']}, ATE by quarter [cm] " + " ".join(
                f"{q * 100:.2f}" for q in r["quarters"]) +
            f", overall {r['overall'] * 100:.2f}, launches {got}")

    # make_replay's file through the native loader into live.consume
    cfg = sim2d_config()
    g42, _ = seeded()
    world = world2d.make_world(g42, cfg.sim, device=dev)
    n = ENTRY_FRAMES
    path = native.BUILD_DIR / "entry_scans.bin"
    r = make_replay.run(cfg, world, n, str(path), seed=0)
    frames = replay.synth_frames(world, cfg.sim, n, seed=0)
    if path.read_bytes() != frames.tobytes() or r["nbytes"] != frames.nbytes:
        raise RuntimeError("[entry] make_replay's file differs from "
                           "synth_frames' frames")
    floats = replay.frame_floats(cfg.sim)

    def consume_file():
        ring = native.FrameRing(n + 8, (floats,))
        loader = native.ScanLoader(ring, path=str(path), rate_hz=0.0,
                                   loop=False)
        step = live.EagerStep(live.init_carry(cfg, dev), cfg)
        loader.start()
        try:
            poses, done = live.drain(ring, step, n, native.Profiler(),
                                     live.Staging(floats, dev),
                                     feed_alive=lambda: loader.produced < n)
        finally:
            loader.stop()
        return poses, done, ring.dropped, loader.error
    (poses, done, dropped, error), got = counted(consume_file)
    _, truth = replay.drive_poses(n, cfg.sim.dt, dev)
    med = float((poses[10:, :2] - truth[10:done, :2]).norm(dim=-1).median()) \
        if done == n else float("nan")
    if done != n or dropped or error or not med < LIVE_ERR_LIMIT:
        raise RuntimeError(f"[entry] make_replay -> live.consume: {done} of "
                           f"{n} frames, {dropped} dropped, loader error "
                           f"{error}, median position error {med} m")
    need_launches("live.consume", got, "K4")
    say(f"make_replay --frames {n}: {r['nbytes']} bytes, equal to "
        f"synth_frames' bit for bit, replayed by the native loader "
        f"into live.consume: {done} frames, median position error "
        f"{med:.4f} m (frames>=10), launches {got}")
    if total["K3"]:
        raise RuntimeError(f"[entry] K3 launched {total['K3']} times")
    say(f"launches in all {total}")
    out["launches"] = total
    return out


def live_phase(card) -> dict:
    """[live]: the live-frame path (slam_tpu_torch.live, examples/run_live.py
    's counterpart) at sim2d_config for one robot. synth_frames writes
    LIVE_FRAMES frames to a replay file under the build directory; the
    native ScanLoader replays it into a FrameRing and live.drain consumes
    it on the card (pinned double-buffered copies, live.GraphedStep:
    the stages around icp_fit replayed from CUDA graphs, icp_fit on K4
    between them), after live.warm_up. First paced at LIVE_RATE_HZ into
    LIVE_SLOTS slots (gate:
    0 dropped, every frame consumed), with K4's launches counted and its
    calls recorded; then unpaced into a ring that holds the whole feed, for
    the frames a second the consumer sustains. Gates: median position error
    against the drive loop's true poses below LIVE_ERR_LIMIT (frames >=
    10), K4 equal to its plain version on the recorded calls (idx, dist in
    bits), the graphed step's poses within LIVE_GRAPH_TOL of consume's on
    the same frames. Host syncs a frame and their sites from 20 frames of
    the graphed step under set_sync_debug_mode."""
    from slam_tpu_torch import live
    from slam_tpu_torch.config import sim2d_config
    from slam_tpu_torch.ops import icp as icp_mod
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.runtime import native
    from slam_tpu_torch.sim import replay, world2d
    cfg = sim2d_config()
    dev = torch.device("cuda")
    world = world2d.make_world(torch.Generator(dev).manual_seed(42),
                               cfg.sim, device=dev)
    n = LIVE_FRAMES
    frames = replay.synth_frames(world, cfg.sim, n, seed=0)
    native.build()
    path = native.BUILD_DIR / "live_replay.bin"
    path.write_bytes(frames.tobytes())
    _, truth = replay.drive_poses(n, cfg.sim.dt, dev)
    floats = replay.frame_floats(cfg.sim)
    B = cfg.sim.num_beams
    live.warm_up(frames, cfg, dev)
    frame0 = torch.from_numpy(frames[0]).to(dev)
    on_card = torch.from_numpy(frames).to(dev)

    def direct(carry, k=n):
        out = []
        for fr in on_card[:k]:
            carry, f = live.consume(carry, *live.split_frame(fr, B), cfg)
            out.append(f[0])
        return torch.stack(out)
    carry0 = live.init_carry(cfg, dev)
    # consume's device ops on frames 16-19 (a map to register against),
    # counted before any GraphedStep exists
    carry16 = carry0
    for fr in on_card[:16]:
        carry16, _ = live.consume(carry16, *live.split_frame(fr, B), cfg)

    def frames16():
        c = carry16
        for fr in on_card[16:20]:
            c, _ = live.consume(c, *live.split_frame(fr, B), cfg)
    eager_ops = device_ops(frames16)["n"]

    def run(slots, rate):
        ring = native.FrameRing(slots, (floats,))
        loader = native.ScanLoader(ring, path=str(path), rate_hz=rate,
                                   loop=False)
        prof = native.Profiler()
        staging = live.Staging(floats, dev)
        step = live.make_step(cfg, dev, frame0)
        t0 = time.perf_counter()
        loader.start()
        try:
            poses, done = live.drain(
                ring, step, n, prof, staging,
                feed_alive=lambda: loader.produced < n, timeout=120.0)
            torch.cuda.synchronize()
        finally:
            loader.stop()
        secs = time.perf_counter() - t0
        step = prof.stats("device_step")
        out = dict(poses=poses, secs=secs, dropped=ring.dropped, done=done,
                   ms=step["total_us"] / max(step["calls"], 1) / 1000.0,
                   max_ms=step["max_us"] / 1000.0, waits=staging.waits)
        if loader.error or done != n or ring.dropped:
            raise RuntimeError(f"[live] {slots} slots at {rate:g} Hz: "
                               f"consumed {done} of {n} frames, dropped "
                               f"{ring.dropped}, {out['ms']:.3f} ms/frame "
                               f"(max {out['max_ms']:.3f}), loader error "
                               f"{loader.error}")
        return out

    calls = []
    reset_counts(icp_fused, nn, particle)
    icp_mod.nearest_neighbor = kept(nn.nearest_neighbor, calls, copy=True)
    try:
        paced = run(LIVE_SLOTS, LIVE_RATE_HZ)
    finally:
        icp_mod.nearest_neighbor = nn.nearest_neighbor
    launches = nn.launches
    if launches < n or icp_fused.launches:
        raise RuntimeError(f"[live] K4 launched {launches} times in {n} "
                           f"frames, K1 {icp_fused.launches}")
    err = (paced["poses"][:, :2] - truth[:, :2]).norm(dim=-1)
    med = float(err[10:].median())
    if not med < LIVE_ERR_LIMIT:
        raise RuntimeError(f"[live] median position error {med} m not below "
                           f"{LIVE_ERR_LIMIT} m")
    for c in calls:
        nn_equal("[live]'s recorded calls", c)
    # the recorded values are each call's own: consecutive calls that
    # placed the scene differently
    distinct = 1 + sum(not torch.equal(c[0][0], b[0][0])
                       for b, c in zip(calls, calls[1:]))
    unpaced = run(n + 8, 0.0)
    fps = n / unpaced["secs"]

    # the graphed step against consume itself on the same frames, and the
    # host syncs of the graphed step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = direct(carry0)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1000.0 / n
    graph_err = float((eager - paced["poses"]).abs().max())
    if not graph_err <= LIVE_GRAPH_TOL:
        raise RuntimeError(f"[live] the graphed step is {graph_err} from "
                           f"consume (bound {LIVE_GRAPH_TOL})")
    k, step = 20, live.make_step(cfg, dev, frame0)

    def stepped():
        for fr in on_card[:k]:
            step(fr)
    _, syncs = count_syncs(stepped)
    print(f"[live] sim2d_config, one robot, {n} replayed frames through "
          f"ScanLoader -> FrameRing -> live.GraphedStep: paced at "
          f"{LIVE_RATE_HZ:g} Hz into {LIVE_SLOTS} slots (GraphedStep: "
          f"{graph_err:.2e} from consume's poses): consumed {n}, "
          f"dropped {paced['dropped']}, {paced['ms']:.3f} ms/frame "
          f"(device_step, K4's arguments cloned; max "
          f"{paced['max_ms']:.3f}), median position error {med:.4f} m "
          f"(frames>=10, "
          f"{float(err.max()):.4f} max), staging waits {paced['waits']}; "
          f"K4 launches {launches} ({launches / n:.2f} a frame), equal to "
          f"its plain version on all {len(calls)} recorded calls (their "
          f"arguments cloned at the call; {distinct} differ from the call "
          f"before); unpaced: "
          f"{fps:.1f} frames/s, {unpaced['ms']:.3f} ms/frame (device_step), "
          f"dropped {unpaced['dropped']}; consume without graphs "
          f"{eager_ms:.3f} ms/frame, {ops_text(eager_ops, 4)} device ops "
          f"a frame (frames 16-19); host syncs a frame (GraphedStep's fit "
          f"loop, icp_fit's while form) "
          f"{len(syncs) / k:.2f} ({sync_sites(syncs)}) | {card}", flush=True)
    return dict(launches=launches, ms=paced["ms"], fps=fps)


def tag_frames(cam, codebook, seed, dev):
    """FID_FRAMES frames (FID_FRAMES, FID_H, FID_W) in [0, 1]: 4-6
    tag36h11 tags each, rendered by render_tag (sides FID_TAG_PX, rotated,
    corners jittered by 4%) centred on the pixels of ground points (a
    subset of FID_SLOTS, jittered 2.5 cm); dark clutter blocks clear of the
    tags' quiet zones, an illumination ramp (x0.6 to x1.0) and noise
    (sigma 0.02), all drawn from numpy.random.default_rng(seed), so the
    frames are the same on every device (up to the rounding of the
    rendering).
    Returns (frames, per frame a list of (id, corners (4, 2), lidar-frame
    ground point (3,)), robot poses (FID_FRAMES, 4))."""
    from slam_tpu_torch import calib
    from slam_tpu_torch.ops import fiducial

    rng = np.random.default_rng(seed)
    frames, truth = [], []
    ramp = (0.6 + 0.25 * torch.arange(FID_W, device=dev)[None] / FID_W
            + 0.15 * torch.arange(FID_H, device=dev)[:, None] / FID_H)
    for f in range(FID_FRAMES):
        img = torch.full((FID_H, FID_W), 0.9, device=dev)
        k = 4 + f % 3
        slots = rng.permutation(len(FID_SLOTS))[:k].tolist()
        ids = rng.permutation(len(codebook))[:k].tolist()
        tags, boxes = [], []
        for slot, code in zip(slots, ids):
            depth, lat = FID_SLOTS[slot]
            g = torch.tensor([depth, lat, FID_GROUND], device=dev)
            g[:2] += torch.from_numpy((rng.random(2) - 0.5) * 0.05).to(dev)
            uv = calib.camera_to_pixel(cam, calib.lidar_to_camera(cam, g))
            side = FID_TAG_PX[0] + rng.random() * (FID_TAG_PX[1]
                                                   - FID_TAG_PX[0])
            ang = rng.random() - 0.5
            c, s = np.cos(ang), np.sin(ang)
            jitter = (rng.random((4, 2)) - 0.5) * 0.08 * side
            base = np.float32([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * side / 2
            corners = torch.from_numpy((base @ np.float32([[c, -s], [s, c]]).T
                                        + jitter).astype(np.float32)).to(dev)
            corners = corners + uv
            x0, y0 = corners.min(0).values.floor().int().tolist()
            x1, y1 = corners.max(0).values.ceil().int().tolist()
            if x0 < 40 or y0 < 40 or x1 > FID_W - 40 or y1 > FID_H - 40:
                raise RuntimeError(f"[fiducial] a tag at {uv.tolist()} "
                                   f"leaves the frame")
            off = torch.tensor([x0 - 2, y0 - 2], dtype=torch.float32,
                               device=dev)
            t = fiducial.render_tag(codebook[code], corners - off,
                                    y1 - y0 + 5, x1 - x0 + 5, bg=-1.0)
            sub = img[y0 - 2:y1 + 3, x0 - 2:x1 + 3]
            sub.copy_(torch.where(t >= 0, t, sub))
            m = int(0.3 * (x1 - x0))
            boxes.append((x0 - m, y0 - m, x1 + m, y1 + m))
            tags.append((code, corners, g))
        placed = 0
        while placed < 12:
            w, h = (20 + rng.random(2) * 130).astype(int).tolist()
            x = int(rng.random() * (FID_W - w))
            y = int(rng.random() * (FID_H - h))
            if any(x < bx1 and x + w > bx0 and y < by1 and y + h > by0
                   for bx0, by0, bx1, by1 in boxes):
                continue
            img[y:y + h, x:x + w] = 0.1
            placed += 1
        noise = rng.standard_normal((FID_H, FID_W), dtype=np.float32)
        img = img * ramp + 0.02 * torch.from_numpy(noise).to(dev)
        frames.append(img.clamp(0.0, 1.0))
        truth.append(tags)
    th = 2 * np.pi * np.arange(FID_FRAMES) / FID_FRAMES
    poses = torch.tensor(np.stack([60 * np.cos(th), 60 * np.sin(th),
                                   th + 1.0, np.full(FID_FRAMES, 1.3)], -1),
                         dtype=torch.float32, device=dev)
    return torch.stack(frames), truth, poses


def fiducial_phase(card) -> None:
    """[fiducial]: the camera periphery at the reference zoom camera's
    resolution (FID_W x FID_H, twice its principal point): tag_frames'
    FID_FRAMES frames through detect_tags with both segmenters at decimate
    1 and 2, timed (CUDA events, ms a frame of the batch of 8). Gates: the
    gradient segmenter's corners within FID_CORNER_TOL px, the
    dark-component ("cc") one's
    corners within (1 + open_radius) sqrt(2) d px (pixel picks of an opened
    mask on a 1/d grid), but for the corners in FID_CORNER_PINNED, held to
    slam_tpu's own; every tag decodes with its id and Hamming 0 but for
    the run's FID_MISSES, and no false or repeated detection. Then the
    chain: each tag's centre (from the first run that decoded it; every
    tag but those all four runs may miss) through calib.pixel_to_global
    at its frame's robot pose into one 400 x 400 sample map (FID_BLOB's
    blobs); extract_samples must put a sample within FID_CHAIN_LIMIT of
    every ground point and none farther from all of them. Peak device
    memory and
    host syncs a frame are printed."""
    from slam_tpu_torch import calib
    from slam_tpu_torch.config import SampleMapConfig
    from slam_tpu_torch.mapping import sample_map
    from slam_tpu_torch.ops import fiducial
    dev = torch.device("cuda")
    cam = calib.REFERENCE_CAMERA
    codebook = torch.from_numpy(fiducial.tag36h11()).to(dev)
    frames, truth, poses = tag_frames(cam, codebook, 10, dev)
    n_tags = sum(len(t) for t in truth)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, lines, failures = {}, [], []
    for seg in ("cc", "gradient"):
        for d in (1, 2):
            cfg = fiducial.FiducialConfig(segmenter=seg, decimate=d)
            fiducial.detect_tags(frames, codebook, cfg)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            det, syncs = count_syncs(
                lambda: fiducial.detect_tags(frames, codebook, cfg))
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / FID_FRAMES
            tol = FID_CORNER_TOL if seg == "gradient" else \
                (1 + cfg.open_radius) * np.sqrt(2) * d
            found, worst, pinned = 0, 0.0, []
            for f, tags in enumerate(truth):
                valid = det.valid[f].tolist()
                got = [q for q in range(len(valid)) if valid[q]]
                ids = [int(det.tag_id[f, q]) for q in got]
                want = {code: corners for code, corners, _ in tags}
                if len(set(ids)) != len(ids) or set(ids) - set(want):
                    raise RuntimeError(
                        f"[fiducial] {seg} d={d} frame {f}: detections "
                        f"{ids}, tags {sorted(want)}")
                for q, code in zip(got, ids):
                    if int(det.hamming[f, q]) != 0:
                        raise RuntimeError(f"[fiducial] {seg} d={d}: tag "
                                           f"{code} at Hamming "
                                           f"{int(det.hamming[f, q])}")
                    dist = float((det.corners[f, q][:, None]
                                  - want[code][None]).norm(dim=-1)
                                 .min(1).values.max())
                    held = FID_CORNER_PINNED.get((seg, d, f, code))
                    if held is None:
                        worst = max(worst, dist)
                        continue
                    pinned.append((f, code, round(dist, 3), held))
                    if abs(dist - held) > FID_PINNED_TOL:
                        failures.append(f"{seg} d={d}: tag {code} of frame "
                                        f"{f} has a corner {dist:.3f} px "
                                        f"off, slam_tpu's {held}")
                found += len(ids)
            if worst > tol:
                failures.append(f"{seg} d={d}: a corner {worst:.3f} px from "
                                f"the rendered one (bound {tol:.3f})")
            missed = [(f, code, round(float((c[1] - c[0]).norm())))
                      for f, tags in enumerate(truth) for code, c, _ in tags
                      if code not in det.tag_id[f][det.valid[f]].tolist()]
            beyond = [(f, code) for f, code, _ in missed
                      if (f, code) not in FID_MISSES[(seg, d)]]
            if beyond:
                failures.append(f"{seg} d={d} missed {beyond}, beyond its "
                                f"pinned misses")
            results[(seg, d)] = det
            lines.append(f"{seg} d={d} {found}/{n_tags} decoded (missed "
                         f"(frame, id, side px) {missed}; not pinned "
                         f"{beyond}), worst "
                         f"corner {worst:.3f} px (bound {tol:.2f}; pinned "
                         f"(frame, id, px, slam_tpu's px) {pinned}), "
                         f"{ms:.2f} ms/frame, host syncs a frame "
                         f"{len(syncs) / FID_FRAMES:.2f}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[fiducial] {FID_FRAMES} frames of {FID_W} x {FID_H} px, "
          f"{n_tags} tag36h11 tags of {FID_TAG_PX[0]}-{FID_TAG_PX[1]} px with "
          f"clutter, an illumination ramp and noise: " + "; ".join(lines) +
          f"; peak device memory {peak:.2f} GiB | {card}", flush=True)
    if failures:
        raise RuntimeError("[fiducial] " + "; ".join(failures))

    # the chain: detected centre -> ground point -> sample map
    scfg = SampleMapConfig()
    m = sample_map.init_sample_map(scfg, 1, device=dev)
    truth_xy = []
    # the tags every run may miss: their ground points cannot be reached
    unreachable = set.intersection(*(set(m) for m in FID_MISSES.values()))
    for f, tags in enumerate(truth):
        pose = poses[f]
        c, s = torch.cos(pose[2]), torch.sin(pose[2])
        for code, _, g in tags:
            # the tag's centre from the first run that decoded it, the
            # sub-pixel gradient one first
            centre = next((det.center[f, q] for det in (
                results[k] for k in (("gradient", 1), ("cc", 1),
                                     ("gradient", 2), ("cc", 2)))
                for q in range(det.valid.shape[1])
                if bool(det.valid[f, q]) and int(det.tag_id[f, q]) == code),
                None)
            if centre is None:
                if (f, code) not in unreachable:
                    raise RuntimeError(f"[fiducial] chain: tag {code} of "
                                       f"frame {f} decoded by no run")
                continue
            truth_xy.append(torch.stack([c * g[0] - s * g[1] + pose[0],
                                         s * g[0] + c * g[1] + pose[1]]))
            gxy = calib.pixel_to_global(cam, centre, pose, FID_GROUND)[:2]
            for _ in range(3):
                m = sample_map.add_sample(
                    m, gxy[None], torch.full((1,), FID_BLOB[0], device=dev),
                    torch.full((1,), FID_BLOB[1], device=dev), scfg)
    peaks = sample_map.extract_samples(m, scfg, max_samples=64)
    found = peaks.xy[0][peaks.valid[0]]
    truth_xy = torch.stack(truth_xy)
    dmat = (truth_xy[:, None] - found[None]).norm(dim=-1)
    miss = float(dmat.min(1).values.max())
    stray = float(dmat.min(0).values.max())
    if not (miss <= FID_CHAIN_LIMIT and stray <= FID_CHAIN_LIMIT):
        raise RuntimeError(f"[fiducial] chain: a ground point {miss:.3f} m "
                           f"from its nearest sample, a sample {stray:.3f} "
                           f"m from every ground point (bound "
                           f"{FID_CHAIN_LIMIT})")
    print(f"[fiducial] chain (gradient d=1 centres -> pixel_to_global -> "
          f"400 x 400 sample map): "
          f"{len(found)} samples for the {len(truth_xy)} ground points of "
          f"the tags some run decoded (of {n_tags}), worst "
          f"{miss:.3f} m, farthest sample {stray:.3f} m (bound "
          f"{FID_CHAIN_LIMIT}) | {card}", flush=True)


def mesh_k1_check(icp_fused, calls) -> dict:
    """K1 on a rank's recorded last call against its plain version (the
    near-tie rule of [graph])."""
    args = calls[0][0]
    return near_tie_agreement(
        "K1 on a [mesh] rank's last tick", icp_fused.icp_fused_planes(*args),
        icp_fused.icp_fused_planes_reference(*args), args[:6], args[6],
        args[7], max(1, args[0].shape[0] // 20), 1)


def mesh_k5_check(particle, calls) -> None:
    """K5 and its bit table on a rank's recorded last scoring against their
    plain versions: fractions and bits equal."""
    bits, grid, scan_xy, valid, parts, res = calls[0][0]
    frac = particle._score_kernel(bits, grid, scan_xy, valid, parts, res)
    ref = particle.score_particles_reference(grid, scan_xy, valid, parts, res)
    torch.cuda.synchronize()
    if not same_bits(frac, ref) or not torch.equal(
            bits, particle.occupancy_bits_reference(grid.count)):
        raise RuntimeError("K5 on a [mesh] rank's last scoring disagrees "
                           "with its plain version")


def mesh_worlds(dev):
    """Config 1's and config 5's configs and the seed-42 world, on `dev`."""
    from slam_tpu_torch.config import sim2d_config
    from slam_tpu_torch.sim import world2d
    cfg = sim2d_config()
    return cfg, particle_config(cfg), world2d.make_world(
        torch.Generator(dev).manual_seed(42), cfg.sim, device=dev)


def mesh_shared_grid(fcfg, dev):
    from slam_tpu_torch.mapping.point_map import init_point_map
    return init_point_map(1, fcfg.mls.size_x, fcfg.icp.voxel_leaf_obs[0],
                          device=dev)


def mesh_fleets(me) -> dict:
    """[mesh], one rank of its group (by default MESH_WORLD ranks sharing
    the one card through gloo): mesh_scaling's batches; config 1 ("fused",
    K1) and config 5 ("particle", K5, its shared grid merged by the dp
    all-reduce) on this rank's share of
    MESH_FLEET robots, each after a warm-up macro on another fleet, drawn
    from rank_generator(MESH_SEED (+2 for config 5), rank); the launches
    of the timed runs; on rank 0 K1 and K5 held to their plain versions on
    one more macro's recorded calls (arguments cloned)."""
    import torch.distributed as dist
    from slam_tpu_torch import mesh_scaling
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.parallel import multihost
    from slam_tpu_torch.parallel.mesh import gather_fleet
    from slam_tpu_torch.parallel.shared_map import fleet_rollout_shared
    from slam_tpu_torch.pipeline import slam2d
    dev = multihost.rank_device()
    out = {"scaling": mesh_scaling.run(MESH_BATCHES)}
    mesh = multihost.make_fleet_mesh()
    local = multihost.host_local_batch(MESH_FLEET)
    cfg, fcfg, world = mesh_worlds(dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)

    def timed(fn):
        torch.cuda.synchronize()
        dist.barrier()
        reset_counts(icp_fused, nn, particle)
        e0.record()
        r = fn()
        e1.record()
        torch.cuda.synchronize()
        return r, e0.elapsed_time(e1)

    # config 1
    warm = multihost.rank_generator(MESH_SEED + 1, dev)
    slam2d.rollout(slam2d.init_state(cfg, local, device=dev, generator=warm),
                   world, cfg, 4, warm)
    gen = multihost.rank_generator(MESH_SEED, dev)
    state = slam2d.init_state(cfg, local, device=dev, generator=gen)
    (state, (est, true)), ms = timed(
        lambda: slam2d.rollout(state, world, cfg, MESH_TICKS, gen))
    out["config1"] = dict(
        ms_tick=ms / MESH_TICKS, k1=icp_fused.launches,
        est=est.cpu(), true=true.cpu(),
        gathered=gather_fleet(mesh, est).cpu() if me == 0 else None)
    if me == 0:
        calls, k1 = [], icp_fused.icp_fused_planes
        icp_fused.icp_fused_planes = kept(k1, calls, copy=True, last=True)
        try:
            slam2d.rollout(state, world, cfg, 4, gen)
        finally:
            icp_fused.icp_fused_planes = k1
        out["config1"]["k1_check"] = mesh_k1_check(icp_fused, calls)
    else:
        gather_fleet(mesh, est)
    del state

    # config 5, every macro's all-reduce timed
    warm = multihost.rank_generator(MESH_SEED + 3, dev)
    fleet_rollout_shared(
        slam2d.init_state(fcfg, local, device=dev, generator=warm),
        mesh_shared_grid(fcfg, dev), world, fcfg, 1, generator=warm,
        mesh=mesh)
    gen = multihost.rank_generator(MESH_SEED + 2, dev)
    fleet = slam2d.init_state(fcfg, local, device=dev, generator=gen)
    events, all_reduce = [], dist.all_reduce
    dist.all_reduce = event_timed(all_reduce, events)
    try:
        (fleet, shared, (est, true)), ms = timed(lambda: fleet_rollout_shared(
            fleet, mesh_shared_grid(fcfg, dev), world, fcfg, MESH_PF_MACROS,
            generator=gen, mesh=mesh))
    finally:
        dist.all_reduce = all_reduce
    out["config5"] = dict(
        ms_tick=ms / (4 * MESH_PF_MACROS), k5=particle.launches,
        packs=particle.pack_launches, est=est.cpu(), true=true.cpu(),
        ok=fleet.scan_reg_ok.cpu(),
        shared={n: getattr(shared, n).cpu()
                for n in ("count", "sum_x", "sum_y", "sum_z", "center")},
        all_reduce_ms=sum(a.elapsed_time(b) for a, b in events) / len(events),
        gathered=gather_fleet(mesh, est).cpu() if me == 0 else None)
    if me == 0:
        calls, k5 = [], particle._score_kernel
        particle._score_kernel = kept(k5, calls, copy=True, last=True)
        try:       # one more macro on this rank alone, for its calls
            fleet_rollout_shared(fleet, shared, world, fcfg, 1, generator=gen)
        finally:
            particle._score_kernel = k5
        mesh_k5_check(particle, calls)
    else:
        gather_fleet(mesh, est)
    return out


def mesh_nccl() -> dict:
    """[mesh], one rank on NCCL, the production backend: mesh_fleets at
    world 1 (the whole fleet on this rank, config 5's all-reduce through
    NCCL); make_shared_map_merger on MESH_MERGE_GRIDS grids against
    merge_maps, and with one grid moved."""
    from slam_tpu_torch.config import sim2d_config
    from slam_tpu_torch.mapping.point_map import PointMapGrid
    from slam_tpu_torch.parallel import multihost
    from slam_tpu_torch.parallel.shared_map import (make_shared_map_merger,
                                                    merge_maps)
    out = mesh_fleets(0)
    dev = multihost.rank_device()
    G = sim2d_config().mls.size_x
    g = torch.Generator(dev).manual_seed(5)
    shape = (MESH_MERGE_GRIDS, G, G)
    grids = PointMapGrid(
        count=torch.randint(0, 4, shape, generator=g, device=dev).float(),
        sum_x=0.1 * torch.randn(shape, generator=g, device=dev),
        sum_y=0.1 * torch.randn(shape, generator=g, device=dev),
        sum_z=0.1 * torch.randn(shape, generator=g, device=dev),
        center=torch.tensor([1.5, -2.0], device=dev).repeat(
            MESH_MERGE_GRIDS, 1), resolution=0.5)
    merge = make_shared_map_merger(multihost.make_fleet_mesh())
    merged = merge(grids)
    out["merge_ms"] = cuda_ms(lambda: merge(grids))
    plain = merge_maps(grids)
    out["merge_equal"] = all(
        same_bits(getattr(merged, n), getattr(plain, n))
        for n in ("count", "sum_x", "sum_y", "sum_z", "center"))
    center = grids.center.clone()
    center[7] += 0.5
    out["moved_nan"] = bool(torch.isnan(merge(grids.replace(
        center=center)).count).all())
    return out


def sp_fleet(cfg, dp, seed):
    """MESH_FLEET robots' state on the host, grids whole, dp shard i drawn
    from a host generator seeded from (seed, i): what the sp ranks place
    with shard_fleet (no card holds a whole robot grid of the sp run) and
    what the whole-grid reference runs."""
    from slam_tpu_torch.parallel.mesh import tree_map
    from slam_tpu_torch.pipeline import slam2d
    parts = [slam2d.init_state(
        cfg, MESH_FLEET // dp, device="cpu",
        generator=torch.Generator().manual_seed(seed * 65536 + i))
        for i in range(dp)]
    return tree_map(lambda *ts: torch.cat(ts), *parts)


def replicated(state) -> tuple:
    """The per-robot state outside the grids, which the ranks of an sp
    group must hold bit for bit alike."""
    return (state.pose, state.ekf.mu, state.ekf.sigma, state.scan_reg_pose,
            state.map_cloud.xyz, state.map_cloud.valid,
            state.map_cloud.flags, state.prev_scene.xyz)


def as_words(tensors) -> torch.Tensor:
    """The tensors' bits as one int32 vector (floats bitcast)."""
    return torch.cat([(t.contiguous().view(torch.int32)
                       if t.dtype == torch.float32 else t.to(torch.int32))
                      .reshape(-1) for t in tensors])


def fingerprint(tensors) -> torch.Tensor:
    """A 0-dim int64 of the tensors' bits, on the card, no host read: each
    word times an odd weight of its position, summed with wrap-around.
    Equal bits give equal prints; a differing bit changes the print."""
    w = as_words(tensors).to(torch.int64)
    k = torch.arange(w.numel(), device=w.device, dtype=torch.int64)
    return (w * (k * 2654435762 + 1)).sum()


def grid_bytes(*grids) -> int:
    """Bytes of the grid containers' (B, H, W, ...) leaves."""
    return sum(t.nbytes for g in grids for f in dataclasses.fields(g)
               for t in [getattr(g, f.name)]
               if isinstance(t, torch.Tensor) and t.dim() >= 3)


class scenes_deterministic:
    """Whole-grid runs build their scenes with the deterministic scatter,
    as robots whose grids are split by rows do (slam2d.process_frame_planes):
    the reference the sp ranks are held to."""

    def __enter__(self):
        from slam_tpu_torch.pipeline import slam2d
        self.build = build = slam2d.build_scene_planes
        slam2d.build_scene_planes = lambda *a, **k: build(
            *a, **{**k, "deterministic": True})

    def __exit__(self, *exc):
        from slam_tpu_torch.pipeline import slam2d
        slam2d.build_scene_planes = self.build


def sp_replicas(comm, prints, state, extra=()) -> bool:
    """Every macro's print and the final bits of `state`'s replicated
    tensors (and `extra`) equal on every rank of the sp group."""
    got = comm.all_gather(torch.stack(prints))
    fin = comm.all_gather(as_words(replicated(state) + tuple(extra)))
    return all(torch.equal(g, got[0]) for g in got) and all(
        torch.equal(f, fin[0]) for f in fin)


def sp_grids(slab, whole, j, channels, sums) -> dict:
    """A rank's slab of grids against rows j*h:(j+1)*h of the whole-grid
    reference's: cells whose `channels` differ (exact) and the largest
    difference of `sums`."""
    h = getattr(slab, channels[0]).shape[1]
    rows = slice(j * h, (j + 1) * h)
    off = sum(int((getattr(slab, n) != getattr(whole, n)[:, rows]).sum())
              for n in channels)
    err = max([0.0] + [float((getattr(slab, n) - getattr(whole, n)[:, rows])
                             .abs().max()) for n in sums])
    return {"cells_off": off, "sum_err": err}


def sp_config1(me, mesh, dev, cfg, world) -> dict:
    """[mesh] sp, config 1 on this rank: warm-up macro, MESH_TICKS ticks
    macro by macro with the replicated state's print after each, timed;
    one more macro counting host syncs (rank 0 keeps K1's last call); then
    this rank's dp shard on whole grids from the same generator (the
    reference), and the comparisons."""
    import torch.distributed as dist
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.parallel.mesh import (gather_grids, shard_fleet,
                                              tree_map)
    from slam_tpu_torch.pipeline import slam2d
    i, j = mesh.coords()
    dp = mesh.ranks.shape[0]
    local = MESH_FLEET // dp
    macros = MESH_TICKS // 4
    fleet = sp_fleet(cfg, dp, MESH_SEED)
    slam2d.rollout(shard_fleet(mesh, fleet, device=dev), world, cfg, 4,
                   torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state = shard_fleet(mesh, fleet, device=dev)
    resident = grid_bytes(state.local_map, state.map_grid)
    whole_bytes = grid_bytes(fleet.local_map, fleet.map_grid) // dp
    comm = state.local_map.rows.comm
    events, ring, gather = [], comm.ring, comm.all_gather
    comm.ring = event_timed(ring, events)
    comm.all_gather = event_timed(gather, events)
    gen = torch.Generator(dev).manual_seed(MESH_SEED * 65536 + i)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    prints, est, true = [], [], []
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts(icp_fused, nn, particle)
    copies = comm.host_copies
    e0.record()
    for _ in range(macros):
        state, (e, t) = slam2d.rollout(state, world, cfg, 4, gen)
        prints.append(fingerprint(replicated(state)))
        est.append(e)
        true.append(t)
    e1.record()
    torch.cuda.synchronize()
    out = dict(ms_tick=e0.elapsed_time(e1) / MESH_TICKS,
               k1=icp_fused.launches,
               exchange_ms=sum(a.elapsed_time(b) for a, b in events) / macros,
               exchanges=len(events) // macros,
               copies=(comm.host_copies - copies) // macros,
               peak_mb=torch.cuda.max_memory_allocated(dev) / 1e6,
               resident=resident, whole_bytes=whole_bytes,
               est=torch.cat(est, 1).cpu(), true=torch.cat(true, 1).cpu())
    comm.ring, comm.all_gather = ring, gather
    out["replicas"] = sp_replicas(comm, prints, state)
    calls, k1_fn = [], icp_fused.icp_fused_planes
    if me == 0:
        icp_fused.icp_fused_planes = kept(k1_fn, calls, copy=True, last=True)
    copies = comm.host_copies
    try:
        (state, _), syncs = count_syncs(
            lambda: slam2d.rollout(state, world, cfg, 4, gen))
    finally:
        icp_fused.icp_fused_planes = k1_fn
    out["syncs"] = (len(syncs), comm.host_copies - copies, sync_sites(syncs))
    if me == 0:
        out["k1_check"] = mesh_k1_check(icp_fused, calls)
    k = min(8, local)       # robots of each dp row gather_grids joins
    first = gather_grids(mesh, state.local_map.replace(**{
        n: getattr(state.local_map, n)[:k] for n in
        ("counts", "drivable", "origin", "center")}))

    # the reference: this dp shard on whole grids, the same draws
    ref = tree_map(lambda t: t[i * local:(i + 1) * local].to(dev), fleet)
    gen = torch.Generator(dev).manual_seed(MESH_SEED * 65536 + i)
    rest = []
    with scenes_deterministic():
        for _ in range(macros):
            ref, (e, _) = slam2d.rollout(ref, world, cfg, 4, gen)
            rest.append(e)
        (ref, _), ref_syncs = count_syncs(
            lambda: slam2d.rollout(ref, world, cfg, 4, gen))
    out["ref_syncs"] = (len(ref_syncs), sync_sites(ref_syncs))
    out["pose_err"] = float((out["est"] - torch.cat(rest, 1).cpu()).abs()
                            .max())
    out["grids"] = [
        sp_grids(state.local_map, ref.local_map, j, ("counts", "drivable"),
                 ()),
        sp_grids(state.map_grid, ref.map_grid, j, ("count",),
                 ("sum_x", "sum_y", "sum_z"))]
    out["gathered_equal"] = bool(
        torch.equal(first.counts[k * i:k * (i + 1)], ref.local_map.counts[:k])
        and torch.equal(first.drivable[k * i:k * (i + 1)],
                        ref.local_map.drivable[:k]))
    return out


def sp_config5(me, mesh, dev, fcfg, world) -> dict:
    """[mesh] sp, config 5 on this rank: fleet_rollout_shared macro by
    macro (the robots' local_map split, the shared grid whole), the
    all-reduce timed; one tick's host syncs; rank 0 holds K5 to its plain
    version on one more macro alone; then every dp shard on whole grids in
    turn (the reference), and the comparisons."""
    import torch.distributed as dist
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.parallel.mesh import shard_fleet, tree_map
    from slam_tpu_torch.parallel.shared_map import (add_grids,
                                                    fleet_rollout_shared,
                                                    shared_macro)
    from slam_tpu_torch.pipeline import slam2d
    i, j = mesh.coords()
    dp = mesh.ranks.shape[0]
    local = MESH_FLEET // dp
    fleet = sp_fleet(fcfg, dp, MESH_SEED + 2).replace(map_grid=None)
    fleet_rollout_shared(shard_fleet(mesh, fleet, device=dev),
                         mesh_shared_grid(fcfg, dev), world, fcfg, 1,
                         generator=torch.Generator(dev).manual_seed(3),
                         mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state = shard_fleet(mesh, fleet, device=dev)
    shared = mesh_shared_grid(fcfg, dev)
    comm = state.local_map.rows.comm
    gen = torch.Generator(dev).manual_seed((MESH_SEED + 2) * 65536 + i)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    events, all_reduce = [], dist.all_reduce
    prints, est, true = [], [], []
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts(icp_fused, nn, particle)
    dist.all_reduce = event_timed(all_reduce, events)
    try:
        e0.record()
        for _ in range(MESH_PF_MACROS):
            state, shared, (e, t) = fleet_rollout_shared(
                state, shared, world, fcfg, 1, generator=gen, mesh=mesh)
            prints.append(fingerprint(replicated(state)))
            est.append(e)
            true.append(t)
        e1.record()
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = all_reduce
    ticks = 4 * MESH_PF_MACROS
    out = dict(ms_tick=e0.elapsed_time(e1) / ticks, k5=particle.launches,
               packs=particle.pack_launches,
               all_reduce_ms=sum(a.elapsed_time(b) for a, b in events)
               / len(events),
               peak_mb=torch.cuda.max_memory_allocated(dev) / 1e6,
               est=torch.cat(est, 1).cpu(), true=torch.cat(true, 1).cpu(),
               shared_print=int(fingerprint(
                   [getattr(shared, n) for n in ("count", "sum_x", "sum_y",
                                                 "sum_z")])))
    out["replicas"] = sp_replicas(comm, prints, state)
    _, syncs = count_syncs(lambda: slam2d.slam_step(
        state, world, fcfg, torch.Generator(dev).manual_seed(9),
        incremental_map=False, refresh_map=False, shift_maps=False,
        pf_target=shared))
    out["syncs"] = (len(syncs), 0, sync_sites(syncs))

    # the reference: every dp shard on whole grids in turn, the same draws,
    # the macro's deltas summed as the all-reduce sums them
    fleets = [tree_map(lambda t: t[k * local:(k + 1) * local].to(dev),
                       fleet) for k in range(dp)]
    gens = [torch.Generator(dev).manual_seed((MESH_SEED + 2) * 65536 + k)
            for k in range(dp)]
    ref_shared = mesh_shared_grid(fcfg, dev)
    rest = []
    with scenes_deterministic():
        for m in range(MESH_PF_MACROS):
            delta = None
            for k in range(dp):
                fleets[k], d, (e, _) = shared_macro(
                    fleets[k], ref_shared, world, fcfg, 4, gens[k], 4 * m)
                delta = d if delta is None else add_grids(delta, d)
                if k == i:
                    rest.append(e)
            ref_shared = add_grids(ref_shared, delta)
        _, ref_syncs = count_syncs(lambda: slam2d.slam_step(
            fleets[i], world, fcfg, torch.Generator(dev).manual_seed(9),
            incremental_map=False, refresh_map=False, shift_maps=False,
            pf_target=ref_shared))
    out["ref_syncs"] = (len(ref_syncs), sync_sites(ref_syncs))
    out["pose_err"] = float((out["est"] - torch.cat(rest, 1).cpu()).abs()
                            .max())
    out["grids"] = [sp_grids(state.local_map, fleets[i].local_map, j,
                             ("counts", "drivable"), ())]
    # the shared grid is whole: its counts equal, its sums (one scatter of
    # the fleet's 1.5M points a macro, in the order of the card's atomic
    # adds on each side) reported
    out["shared_vs_whole"] = sp_grids(shared, ref_shared, 0, ("count",),
                                      ("sum_x", "sum_y", "sum_z"))
    out["shared_cells"] = int((shared.count > 0).sum())
    if me == 0:
        calls, k5 = [], particle._score_kernel
        particle._score_kernel = kept(k5, calls, copy=True, last=True)
        try:       # one more macro on this rank alone, for its calls
            fleet_rollout_shared(state, shared, world, fcfg, 1,
                                 generator=gen)
        finally:
            particle._score_kernel = k5
        mesh_k5_check(particle, calls)
    return out


def mesh_sp(me, layouts) -> dict:
    """[mesh]'s sp ranks: config 1 and config 5 on each (dp, sp) layout of
    this world, every robot's grids split by rows over the sp ranks of its
    dp row."""
    from slam_tpu_torch.parallel import multihost
    dev = multihost.rank_device()
    cfg, fcfg, world = mesh_worlds(dev)
    out = {}
    for dp, sp in layouts:
        mesh = multihost.make_fleet_mesh(sp)
        out[(dp, sp)] = dict(coords=mesh.coords(),
                             config1=sp_config1(me, mesh, dev, cfg, world),
                             config5=sp_config5(me, mesh, dev, fcfg, world))
        torch.cuda.empty_cache()
    return out


def sp_layouts(world, backend) -> tuple:
    """The (dp, sp) layouts [mesh] runs on `world` ranks: on the one card
    (gloo) MESH_SP, a card a rank MESH_SP_CARDS."""
    return tuple(x for x in (MESH_SP if backend == "gloo" else MESH_SP_CARDS)
                 if x[0] * x[1] == world)


def sp_report(say, results, how) -> dict:
    """Gate and print [mesh]'s sp runs (each rank's mesh_sp result);
    returns their launches."""
    from slam_tpu_torch.pipeline import slam2d
    got = {"K1": 0, "K5": 0, "K5 table": 0, "k1_err": 0.0}
    for (dp, sp) in results[0]:
        ranks = [r[(dp, sp)] for r in results]
        where = f"dp{dp} x sp{sp} ({how})"
        for key, limit, skip, label in (
                ("config1", ATE_LIMIT, 10, 'config 1 ("fused", K1)'),
                ("config5", PF_ATE_LIMIT, 8,
                 'config 5 ("particle", K5, P=128)')):
            runs = [r[key] for r in ranks]
            firsts = sorted((r["coords"], r[key]) for r in ranks
                            if r["coords"][1] == 0)
            est = torch.cat([x["est"] for _, x in firsts])
            true = torch.cat([x["true"] for _, x in firsts])
            fail = []
            if not bool(torch.isfinite(est).all()):
                fail.append("non-finite poses")
            med = float(slam2d.ate(est[:, skip:], true[:, skip:]).median())
            if not med < limit:
                fail.append(f"median ATE {med} m (limit {limit})")
            err = max(x["pose_err"] for x in runs)
            if err > MESH_POSE_TOL:
                fail.append(f"max pose err {err} m against whole grids")
            grids = [g for x in runs for g in x["grids"]]
            off = sum(g["cells_off"] for g in grids)
            serr = max(g["sum_err"] for g in grids)
            if off or serr > MESH_SUM_TOL:
                fail.append(f"{off} grid cells differ from whole grids, sums "
                            f"within {serr}")
            if not all(x["replicas"] for x in runs):
                fail.append("replicated state differs within an sp group")
            over = [x["syncs"][0] - x["syncs"][1] - x["ref_syncs"][0]
                    for x in runs]
            if max(over) > 0:
                fail.append(f"host syncs beyond whole grids' {over}: " +
                            "; ".join(f"{x['syncs'][2]} vs "
                                      f"{x['ref_syncs'][1]}" for x in runs))
            if key == "config1":
                need = {"K1": MESH_TICKS}
                have = {"K1": [x["k1"] for x in runs]}
                if not all(x["gathered_equal"] for x in runs):
                    fail.append("gather_grids differs from whole grids")
                bad = [(x["resident"], x["whole_bytes"]) for x in runs
                       if x["resident"] * sp != x["whole_bytes"]]
                if bad:
                    fail.append(f"resident grid bytes not 1/{sp} of whole: "
                                f"{bad}")
                got["k1_err"] = max(got["k1_err"],
                                    runs[0]["k1_check"]["err"])
            else:
                need = {"K5": 8 * MESH_PF_MACROS,
                        "K5 table": 4 * MESH_PF_MACROS}
                have = {"K5": [x["k5"] for x in runs],
                        "K5 table": [x["packs"] for x in runs]}
                if len({x["shared_print"] for x in runs}) != 1:
                    fail.append("the shared grid differs between ranks")
                if any(x["shared_vs_whole"]["cells_off"] for x in runs):
                    fail.append("the shared grid's counts differ from one "
                                "process's")
            for k, v in have.items():
                got[k] += sum(v)
                if min(v) < need[k]:
                    fail.append(f"{k} launches a rank {v}, want {need[k]}")
            if fail:
                raise RuntimeError(f"[mesh] {where} {key}: " +
                                   "; ".join(fail))
            ms = max(x["ms_tick"] for x in runs)
            if key == "config1":
                moved = (
                    "exchanges " + ", ".join(
                        f"{x['exchange_ms']:.3f}" for x in runs) +
                    f" ms a macro a rank ({runs[0]['exchanges']} calls, "
                    f"{runs[0]['copies']} host copies a macro); resident "
                    f"grid bytes a rank {runs[0]['resident']} = 1/{sp} of "
                    f"{runs[0]['whole_bytes']}; gather_grids equal")
            else:
                moved = ("all-reduce " + ", ".join(
                    f"{x['all_reduce_ms']:.4f}" for x in runs) +
                    f" ms a macro a rank; shared grid bit-identical on the "
                    f"{len(runs)} ranks ({runs[0]['shared_cells']} cells), "
                    f"its counts equal to one process's, sums within "
                    f"{max(x['shared_vs_whole']['sum_err'] for x in runs):.3g}"
                    f" (atomic order); "
                    "K5 and its bit table on rank 0's last scoring equal "
                    "to plain")
            say(f"sp {where} {label}, B={MESH_FLEET} ({MESH_FLEET // dp} "
                f"robots a dp row, 1/{sp} of their rows a rank): " +
                ", ".join(f"{x['ms_tick']:.3f}" for x in runs) +
                f" ms/tick a rank, {MESH_FLEET * 1000.0 / ms:.1f} "
                f"robot-steps/s aggregate, median ATE {med:.4f} m "
                f"(ticks>={skip}); max pose err {err:.3g} m against one "
                f"process on whole grids, 0 grid cells differ, sums within "
                f"{serr:.3g}; replicated state bit-identical in each sp "
                f"group at every macro; launches a rank {have}; {moved}; "
                f"peak " + ", ".join(f"{x['peak_mb']:.1f}" for x in runs) +
                " MB a rank; host syncs (sp - staging copies / whole) " +
                ", ".join(f"{x['syncs'][0] - x['syncs'][1]}/"
                          f"{x['ref_syncs'][0]}" for x in runs) +
                (f"; K1 on rank 0's last tick vs plain: "
                 f"{agreement_text(runs[0]['k1_check'])}"
                 if key == "config1" else ""))
    return got
def mesh_rank(task, me, world, backend, work) -> None:
    """[mesh]'s child process: rank `me` of `world` joins through a file
    store in `work` and runs `task` ("refuse": NCCL on a card that another
    rank holds, which must raise naming gloo; "fleets": mesh_fleets;
    "nccl": mesh_nccl; "sp": mesh_sp on this world's sp_layouts), writing
    its result to work/rank<me>.pt."""
    import os
    import torch.distributed as dist
    from slam_tpu_torch.parallel import multihost
    store = "file://" + os.path.join(work, "store")
    path = os.path.join(work, f"rank{me}.pt")
    if task == "refuse":
        try:
            multihost.init_distributed(store, world, me, backend="nccl")
        except ValueError as e:
            if 'backend="gloo"' not in str(e):
                raise
            torch.save({"refused": str(e)}, path)
            return
        raise RuntimeError("two NCCL ranks on one card were not refused")
    multihost.init_distributed(store, world, me, backend=backend)
    try:
        torch.save(mesh_fleets(me) if task == "fleets" else
                   mesh_sp(me, sp_layouts(world, backend)) if task == "sp"
                   else mesh_nccl(), path)
    finally:
        dist.destroy_process_group()


def spawn_ranks(task, world, backend, work) -> list:
    """Run mesh_rank's `task` on `world` spawned ranks (fork would inherit
    this process's CUDA context); fail when any rank fails or the group
    outlives MESH_LIMIT_S, stopping every rank. Returns each rank's
    result."""
    import multiprocessing
    import os
    ctx = multiprocessing.get_context("spawn")
    work = os.path.join(work, task)
    os.makedirs(work)
    procs = [ctx.Process(target=mesh_rank, args=(task, r, world, backend,
                                                 work)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        end = time.monotonic() + MESH_LIMIT_S
        while time.monotonic() < end and any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    if codes != [0] * world:
        raise RuntimeError(f"[mesh] {task} ranks ended with {codes} (None: "
                           f"still running after {MESH_LIMIT_S} s)")
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def mesh_phase(card, world=MESH_WORLD, backend="gloo") -> dict:
    """[mesh]: the multi-device layer. Ranks are spawned children meeting
    through a file store in a temporary directory; the kernels are built
    already, so no two ranks race the build. (1) With gloo, NCCL with two
    ranks on the one card is refused on both. (2) `world` ranks, by
    default two sharing the card through gloo (NCCL needs a card a rank;
    with backend "nccl" a card a rank): mesh_fleets' config 1 and config
    5 at MESH_FLEET robots, certified against this process running the
    same shards in turn from the same generators (poses within
    MESH_POSE_TOL; config 5's macros fold the shards' deltas into the
    shared grid as the all-reduce does, and its counts must equal the
    ranks'), the shared grid bit-identical on every rank, the ATE gates of
    [main] and [pf]. (3) One rank on NCCL: mesh_nccl, the same fleets
    with the whole fleet on one rank (beside [main] and [pf]) and the
    merger on MESH_MERGE_GRIDS grids. (4) mesh_scaling at
    MESH_BATCHES on world 1 (NCCL) and on `world` ranks (on the shared
    card: sharing, not scaling; gated on finite poses and on each rank's
    peak memory below world 1's at the same B, never on throughput). (5)
    The sp axis: `world` ranks on each of sp_layouts(world, backend)
    (dp1 x sp2 on the one card through gloo; dp2 x sp2 and dp1 x sp4 a
    card a rank through NCCL), every robot's grids split by rows over the
    sp ranks of its dp row: mesh_sp's config 1 and config 5, gated by
    sp_report. Returns the ranks' launches and K1's error."""
    import tempfile
    from slam_tpu_torch.parallel import multihost
    from slam_tpu_torch.parallel.shared_map import add_grids, shared_macro
    from slam_tpu_torch.pipeline import slam2d
    from slam_tpu_torch.mesh_scaling import line

    def say(text):
        print(f"[mesh] {text} | {card}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        if backend == "gloo":
            refused = spawn_ranks("refuse", MESH_WORLD, "nccl", work)
            say(f"NCCL with {MESH_WORLD} ranks on the one card refused on "
                f"every rank: {refused[0]['refused'][:96]}...")
        ranks = spawn_ranks("fleets", world, backend, work)
        nccl = spawn_ranks("nccl", 1, "nccl", work)[0]
        split = spawn_ranks("sp", world, backend, work) \
            if sp_layouts(world, backend) else []
    secs = time.perf_counter() - t0
    shards = ("gloo, the ranks on one card" if backend == "gloo" else
              f"{backend}, a card a rank")

    # this process runs the ranks' shards in turn, from the same generators
    dev = torch.device("cuda")
    local = MESH_FLEET // world
    cfg, fcfg, world2 = mesh_worlds(dev)
    ref1, ref5, fleets, gens = [], [], [], []
    for r in range(world):
        gen = multihost.rank_generator(MESH_SEED, dev, r)
        st = slam2d.init_state(cfg, local, device=dev, generator=gen)
        ref1.append(slam2d.rollout(st, world2, cfg, MESH_TICKS, gen)[1][0])
        gens.append(multihost.rank_generator(MESH_SEED + 2, dev, r))
        fleets.append(slam2d.init_state(fcfg, local, device=dev,
                                        generator=gens[-1]).replace(
            map_grid=None))
        ref5.append([])
    shared = mesh_shared_grid(fcfg, dev)
    for m in range(MESH_PF_MACROS):
        delta = None
        for r in range(world):
            fleets[r], d, (e, _) = shared_macro(fleets[r], shared, world2,
                                                fcfg, 4, gens[r], 4 * m)
            delta = d if delta is None else add_grids(delta, d)
            ref5[r].append(e)
        shared = add_grids(shared, delta)
    del fleets
    ref1 = torch.cat(ref1).cpu()
    ref5 = torch.cat([torch.cat(e, 1) for e in ref5]).cpu()

    out = {"K1": 0, "K5": 0, "K5 table": 0, "k1_err": 0.0}
    refs = {"config1": ref1, "config5": ref5}
    for w, group, how in ((world, ranks, shards), (1, [nccl], "NCCL")):
        for key, limit, skip, label in (
                ("config1", ATE_LIMIT, 10, 'config 1 ("fused", K1)'),
                ("config5", PF_ATE_LIMIT, 8,
                 'config 5 ("particle", K5, P=128)')):
            runs = [rk[key] for rk in group]
            est = torch.cat([x["est"] for x in runs])
            true = torch.cat([x["true"] for x in runs])
            if not torch.equal(runs[0]["gathered"], est):
                raise RuntimeError(f"[mesh] world {w} {key}: gather_fleet "
                                   "differs from the ranks' trajectories")
            if not bool(torch.isfinite(est).all()):
                raise RuntimeError(f"[mesh] world {w} {key}: non-finite "
                                   "poses")
            med = float(slam2d.ate(est[:, skip:], true[:, skip:]).median())
            if not med < limit:
                raise RuntimeError(f"[mesh] world {w} {key}: median ATE "
                                   f"{med} m (limit {limit})")
            if key == "config1":
                got = {"K1": [x["k1"] for x in runs]}
                need = {"K1": MESH_TICKS}
                out["k1_err"] = max(out["k1_err"],
                                    runs[0]["k1_check"]["err"])
                held = (f"K1 on rank 0's last tick vs plain: "
                        f"{agreement_text(runs[0]['k1_check'])}")
            else:
                ticks = 4 * MESH_PF_MACROS
                got = {"K5": [x["k5"] for x in runs],
                       "K5 table": [x["packs"] for x in runs]}
                need = {"K5": 2 * ticks, "K5 table": ticks}
                held = ("all-reduce a macro " + ", ".join(
                    f"{x['all_reduce_ms']:.4f}" for x in runs) + " ms a rank "
                    "(events around the call); K5 and its bit table on rank "
                    "0's last scoring equal to plain")
            for k, v in got.items():
                out[k] += sum(v)
                if min(v) < need[k]:
                    raise RuntimeError(f"[mesh] world {w} {key}: {k} "
                                       f"launches a rank {v}, want at least "
                                       f"{need[k]}")
            if w > 1:
                # against this process running the shards in turn
                err = float((est - refs[key]).abs().max())
                if err > MESH_POSE_TOL:
                    n_off = int(((est - refs[key]).abs().amax((1, 2)) >
                                 MESH_POSE_TOL).sum())
                    raise RuntimeError(
                        f"[mesh] {key}: max pose err {err} m against one "
                        f"process running the shards in turn (bound "
                        f"{MESH_POSE_TOL}; {n_off} robots off)")
                held = (f"max pose err {err:.3g} m against one process "
                        f"running the shards in turn; " + held)
            if w > 1 and key == "config5":
                grids = [x["shared"] for x in runs]
                same = all(same_bits(grids[0][n], g[n]) for g in grids[1:]
                           for n in grids[0])
                off = int((grids[0]["count"] != shared.count.cpu()).sum())
                if not same or off:
                    raise RuntimeError(
                        f"[mesh] config 5's shared grid: bit-identical on "
                        f"the ranks {same}, {off} cells' counts differ from "
                        f"one process's")
                held = (f"shared grid bit-identical on the {w} ranks, counts "
                        f"equal to one process's ("
                        f"{int((shared.count > 0).sum())} cells, "
                        f"{float(shared.count.sum()):.0f} points); " + held)
            ms = max(x["ms_tick"] for x in runs)
            say(f"world {w} ({how}) {label}, B={MESH_FLEET} "
                f"({MESH_FLEET // w} a rank): " + ", ".join(
                    f"{x['ms_tick']:.3f}" for x in runs) + " ms/tick a rank, "
                f"{MESH_FLEET * 1000.0 / ms:.1f} robot-steps/s aggregate, "
                f"median ATE {med:.4f} m (ticks>={skip}); launches a rank "
                f"{got}; {held}")
    if not (nccl["merge_equal"] and nccl["moved_nan"]):
        raise RuntimeError(f"[mesh] make_shared_map_merger on NCCL: equal "
                           f"to merge_maps {nccl['merge_equal']}, a moved "
                           f"grid NaN {nccl['moved_nan']}")
    say(f"world 1 (NCCL): make_shared_map_merger on {MESH_MERGE_GRIDS} grids "
        f"{nccl['merge_ms']:.3f} ms, equal to merge_maps in bits, a moved "
        f"grid gives NaN counts")

    one = nccl["scaling"]
    two = ranks[0]["scaling"]
    for w, rows, how in ((1, one, "NCCL"), (world, two, shards)):
        for row in rows:
            say("mesh_scaling " + line(row, f"world {w}, {how}"))
    for a, b in zip(one, two):
        if not (a["finite"] and b["finite"]) or not max(b["peak_mb"]) < \
                a["peak_mb"][0]:
            raise RuntimeError(f"[mesh] mesh_scaling at B={a['batch']}: "
                               f"finite {a['finite']} / {b['finite']}, peak "
                               f"MB world 1 {a['peak_mb']}, world "
                               f"{world} {b['peak_mb']}")
    if split:
        sp = sp_report(say, split, shards)
        for k in ("K1", "K5", "K5 table"):
            out[k] += sp[k]
        out["k1_err"] = max(out["k1_err"], sp["k1_err"])
    say(f"mesh_scaling: every world-{world} rank's peak memory below world "
        f"1's at each B; aggregate robot-steps/s world {world} / world 1 " +
        ", ".join(f"B={a['batch']} {b['rate'] / a['rate']:.3f}"
                  for a, b in zip(one, two)) +
        (f" ({world} ranks on one card measure its sharing, not scaling; "
         "no throughput gate)" if backend == "gloo" else
         " (no throughput gate)") + f"; [mesh]'s ranks ran {secs:.1f} s")
    return out


def device_json(name) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}})


def mesh_cards(card, name, n) -> int:
    """--mesh-cards N: the kernels' build and [mesh] alone, its ranks a
    card each through NCCL (the four-card measurement of the dp split,
    against one rank on NCCL and one process running the shards in
    turn)."""
    from slam_tpu_torch import cuda_build
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"--mesh-cards {n}: {torch.cuda.device_count()} "
                           "cards visible")
    cuda_build.build()
    mesh_phase(card, n, "nccl")
    print(device_json(name))
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on the card.")
    ap.add_argument("--mesh-cards", type=int, default=0, metavar="N",
                    help="run only the kernels' build and [mesh], its "
                         "ranks on N cards through NCCL")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"[device] {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}", flush=True)
    if args.mesh_cards:
        return mesh_cards(card, name, args.mesh_cards)

    from slam_tpu_torch import config as cfg_mod
    from slam_tpu_torch import cuda_build
    from slam_tpu_torch.ops import icp as icp_mod
    from slam_tpu_torch.ops import icp_fused, nn, particle
    from slam_tpu_torch.pipeline import slam2d
    from slam_tpu_torch.sim import world2d
    kernel_modules = (icp_fused, nn, particle)

    t0 = time.perf_counter()
    lib = cuda_build.build()
    cuda_build.library()
    secs = time.perf_counter() - t0
    print(f"[build] {lib.name} in {secs:.2f} s; ptxas: "
          f"{' | '.join(ptxas_summary(f'{lib}.ptxas.txt'))}", flush=True)

    cfg = cfg_mod.sim2d_config()
    k1 = check_k1(cfg.icp)
    print(f"[K1] vs plain at B={FLEET} S=384 C=512 and, with classes off, "
          f"an empty scene and separated duplicates, at B=64 S=384 and B=16 "
          f"S=2048: max pose err {k1['pose_err']:.3g} (bound {POSE_TOL}), ok "
          f"mismatches {k1['ok_mismatch']}, max |d num_corr| {k1['dcorr']}",
          flush=True)
    k4 = check_k4()
    print(f"[K4] vs plain, idx equal on every query and dist equal in bits: "
          f"{', '.join(k4['cases'])} (B={FLEET} S=384 C=512 and smaller "
          f"fleets; model strided from (B, C, 3))", flush=True)
    guard = kernel_guard(cfg_mod)
    print(f"[guard] K1 vs icp_fit (K4): max pose err {guard:.3g} "
          f"(bound {POSE_TOL})", flush=True)
    pf = pf_problem()
    k5 = check_k5(pf)
    print(f"[K5] vs plain at B={FLEET} N={PF_SCORED} of 384 (stride 4) and "
          f"384 (stride 1), P=128 and P=1, G={PF_G}, shared and per-robot "
          f"tables, NaN counts, resolution 0.5 and 0.3, G=100: "
          f"{k5['cases']} cases, fraction mismatches {k5['mismatches']}; "
          f"bit tables equal to occupancy_bits_reference", flush=True)
    ref_cfg = cfg_mod.ref_scale_config()
    k3 = check_k3(ref_cfg.icp)
    print("[K3] vs plain: " + "; ".join(
        f"{k} max pose err {v['pose_err']:.3g}, ok mismatches "
        f"{v['ok_mismatch']}, max |d num_corr| {v['dcorr']}"
        for k, v in k3.items()) + f" (bounds {POSE_TOL}, 0, {NCORR_TOL}; "
        f"ref, sparse and scattered B={FLEET_REF} S={REF_S} C={REF_C}, the "
        f"sparse ones with {REF_SCENE} scene and {REF_TARGET} model points, "
        f"ties across model splits S=700 C=24000, vs K1's plain version "
        f"S=512 C=4096; every case twice with equal bits)", flush=True)

    k2t = check_k2_tiled(ref_cfg.icp)
    print(f"[K2 on K3] packed B=16 S=C=2048 (above RESIDENT_TILE_LIMIT) vs "
          f"plain: max pose err {k2t['pose_err']:.3g}, ok mismatches "
          f"{k2t['ok_mismatch']}, max |d num_corr| {k2t['dcorr']}",
          flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    world = world2d.make_world(gen.manual_seed(42), cfg.sim, device=dev)
    field_every = 4
    warm = slam2d.init_state(cfg, FLEET, device=dev,
                             generator=gen.manual_seed(1))
    slam2d.rollout(warm, world, cfg, field_every, gen)
    del warm
    state = slam2d.init_state(cfg, FLEET, device=dev,
                              generator=gen.manual_seed(0))
    torch.cuda.synchronize()

    reset_counts(*kernel_modules)
    est, true = [], []
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for m in range(TICKS // field_every):
        before = icp_fused.launches
        state, (e, t) = slam2d.rollout(state, world, cfg, field_every, gen)
        if icp_fused.launches - before < field_every:
            raise RuntimeError(f"macro {m}: K1 launched "
                               f"{icp_fused.launches - before} times in "
                               f"{field_every} ticks")
        est.append(e)
        true.append(t)
    e1.record()
    torch.cuda.synchronize()
    ms_tick = e0.elapsed_time(e1) / TICKS
    pcfg = dataclasses.replace(
        cfg, icp=dataclasses.replace(cfg.icp, matcher="points"))
    pstate = slam2d.init_state(cfg, FLEET, device=dev,
                               generator=gen.manual_seed(2))
    # rollout runs whole macros: a warm-up macro, the timed ticks, and one
    # more macro whose nearest_neighbor calls are recorded
    pstate, _ = slam2d.rollout(pstate, world, pcfg, field_every, gen)
    torch.cuda.synchronize()
    e0.record()
    pstate, (pe, pt) = slam2d.rollout(pstate, world, pcfg, POINTS_TICKS, gen)
    e1.record()
    torch.cuda.synchronize()
    points_ms = e0.elapsed_time(e1) / POINTS_TICKS
    seen = []
    nn_call = icp_mod.nearest_neighbor

    def keep(*a, **k):
        seen.append((a, k))
        return nn_call(*a, **k)
    icp_mod.nearest_neighbor = keep
    try:
        pstate, _ = slam2d.rollout(pstate, world, pcfg, field_every, gen)
    finally:
        icp_mod.nearest_neighbor = nn_call
    launches = {"K1": icp_fused.launches, "K4": nn.launches}

    est = torch.cat(est, 1)
    true = torch.cat(true, 1)
    if est.shape != (FLEET, TICKS, 3) or pe.shape != (FLEET, POINTS_TICKS, 3):
        raise RuntimeError(f"trajectory shapes {tuple(est.shape)}, "
                           f"{tuple(pe.shape)}")
    for what, x in (("est", est), ("points est", pe),
                    ("map", state.map_grid.count),
                    ("occupancy", pstate.local_map.counts)):
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"non-finite values in {what}")
    ate = slam2d.ate(est[:, 10:], true[:, 10:])
    med = float(ate.median())
    p_ate = float(slam2d.ate(pe, pt).median())
    if launches["K1"] < TICKS or launches["K4"] < POINTS_TICKS:
        raise RuntimeError(f"main path kernel launches {launches}")
    if not med < ATE_LIMIT or not p_ate < ATE_LIMIT:
        raise RuntimeError(f"median ATE {med} m (fused), {p_ate} m (points)"
                           f" not below {ATE_LIMIT} m")
    path_k4 = []
    for a, k in seen:
        args = (*a, k["q_class"], k["m_class"])
        (idx, dist), ((ridx, rdist)) = nn.nearest_neighbor(*args), nn_plain(
            *args)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ridx) and same_bits(dist, rdist)):
            raise RuntimeError(f"K4 disagrees with its plain version on the "
                               f"points run's data: "
                               f"{int((idx != ridx).sum())} idx mismatches")
        path_k4.append(args)
    print(f"[main] B={FLEET} fused {TICKS} ticks: {ms_tick:.3f} ms/tick, "
          f"{FLEET * 1000.0 / ms_tick:.1f} robot-steps/s, median ATE "
          f"{med:.4f} m (ticks>=10, {float(ate.max()):.4f} max); points "
          f"{POINTS_TICKS} ticks after a warm-up macro: {points_ms:.3f} "
          f"ms/tick, median ATE {p_ate:.4f} m, K4 equal to its plain "
          f"version on one more macro's {len(path_k4)} calls; launches "
          f"{launches} | {card}", flush=True)

    k2, launches["K2"] = scan_to_scan_phase(state, world, cfg, gen)
    k2_args = k2["args"]
    del state, pstate
    fcfg, launches["K5"], launches["K5 table"] = shared_fleet_phase(
        world, cfg, gen, card)
    # [time]'s required device-op counts, before any large profiler
    # session can leave torch.profiler blind (device_ops)
    ops_a_call = call_ops(pf, fcfg.pf)
    launches["K1 (config 2)"] = rollout_3d_phase(
        cfg_mod.sim3d_config(), FLEET_3D, TICKS_3D, gen, card, "3d", "K1",
        10, ATE_3D_LIMIT, 15, Z_3D_LIMIT)
    launches["K3"] = rollout_3d_phase(
        ref_cfg, FLEET_REF, TICKS_REF, gen, card, "ref", "K3", 4,
        ATE_REF_LIMIT, 4, Z_REF_LIMIT, OK_REF_SHARE)
    graph = graph_phase(world, gen, card)
    launches["K2"] += graph["launches"]["K2"]
    launches["K4"] += graph["launches"]["K4"]
    launches["K1 (config 4)"] = graph["launches"]["K1"]
    mls = mls_phase(world, gen, card)
    regen = regen_phase(world, gen, card)
    launches["K1 (config 3)"] = mls["launches"]["K1"]
    launches["K1 (config 4, voxel and mls)"] = regen["launches"]["K1"]
    launches["K2"] += regen["launches"]["K2"]
    launches["K4"] += mls["launches"]["K4"] + regen["launches"]["K4"]
    graph3d = graph3d_phase(gen, card)
    for k in ("K2", "K3", "K4"):
        launches[k] += graph3d["launches"][k]
    se3 = se3_phase(gen, card)
    launches["K1 (config 4 in 3D, se3)"] = se3["launches"]["K1"]
    launches["K2"] += se3["launches"]["K2"]
    launches["K4"] += se3["launches"]["K4"]
    refgrid_phase(gen, card)
    grid2d_phase(world, gen, card)
    division_phase(card)

    # kernels alone, at their main path's shapes
    ops = fused_operands(registration_problem(FLEET, seed=3))
    k1_ms = cuda_ms(lambda: icp_fused.icp_fused_planes(*ops, cfg.icp))
    k1_plain_ms = cuda_ms(
        lambda: icp_fused.icp_fused_planes_reference(*ops, cfg.icp), reps=3)
    k1_bound = bound(icp_bytes(ops[:6], ops[6]),
                     icp_ops(ops[:6], ops[6], cfg.icp))
    t4 = time_k4(registration_problem(FLEET, seed=3))
    k4_path_out, k4_path_alone = replay(cuda_build.library(), "slam_nn",
                                        lambda: nn.nearest_neighbor(
                                            *path_k4[-1]))
    t4["path"] = kernel_ms(k4_path_alone)
    k2_ms = cuda_ms(lambda: icp_fused.icp_fused(*k2_args))
    k2_err = k2["pose_err"]
    k2_plain_ms = cuda_ms(lambda: icp_fused.icp_fused_reference(*k2_args),
                          reps=3)
    # K2 reads packed points, masks and init once and writes pose, ok,
    # num_corr, delta and mean residual
    k2_bound = bound(nbytes(*k2_args[:7]) + FLEET * (3 * 4 + 1 + 3 * 4),
                     icp_ops(icp_fused.packed_planes(*k2_args[:6]),
                             k2_args[6], cfg.icp))
    t5 = time_k5(pf, 128, fcfg.pf)
    t51 = time_k5(pf, 1, fcfg.pf)
    count5 = pf["shared"].count
    bits5, pack_alone = replay(cuda_build.library(), "slam_pf_pack",
                               lambda: particle.occupancy_bits(pf["shared"]))
    pack = dict(alone=kernel_ms(pack_alone),
                plain=cuda_ms(lambda: particle.occupancy_bits_reference(
                    count5)), bound=bound(nbytes(count5, bits5), 0.0))
    nn_ops = ops_a_call["nearest_neighbor"]["n"]
    k5_ops = ops_a_call["score_particles"]["n"]
    if nn_ops != 1 or k5_ops != 2 or ops_a_call["pf_match"]["K5"] != 3:
        raise RuntimeError(f"device ops a call: nearest_neighbor {nn_ops}, "
                           f"score_particles {k5_ops}, K5 in pf_match "
                           f"{ops_a_call['pf_match']['K5']} (want 1, 2, 3)")
    # the live path before the large profiler sessions below (device_ops)
    live = live_phase(card)
    launches["K4"] += live["launches"]
    # the larger counts last: a session of some 15,000 device operations
    # or more can leave the later ones blind (device_ops)
    g3_ops = device_ops(graph3d.pop("tick"))["n"]
    regen_ops = {r: device_ops(regen[r].pop("tick"))["n"]
                 for r in ("voxel", "mls")}
    se3_ops = device_ops(se3.pop("tick"))["n"]
    print(f"[regen] device ops a graph tick (config 4, B={GRAPH_FLEET}): "
          f"voxel {ops_text(regen_ops['voxel'])}, mls "
          f"{ops_text(regen_ops['mls'])} | {card}", flush=True)
    print(f"[graph3d] device ops a graph tick and its ground-map offset "
          f"(B={GRAPH3D_FLEET}): {ops_text(g3_ops)}; [se3] device ops a "
          f"6-DoF graph tick (B={SE3_FLEET}): {ops_text(se3_ops)} | {card}",
          flush=True)
    # K3 at the reference scale's shapes, on the [K3] phase's problem
    ops3 = fused_operands(registration_problem(FLEET_REF, REF_S, REF_C,
                                               seed=11, span=100.0,
                                               max_rot=0.01))
    k3_ms = cuda_ms(lambda: icp_fused.icp_fused_planes_tiled(*ops3,
                                                             ref_cfg.icp))
    k3_plain_ms = cuda_ms(lambda: icp_fused.icp_fused_planes_tiled_reference(
        *ops3, ref_cfg.icp), reps=2)
    k3_bound = bound(icp_bytes(ops3[:6], ops3[6]),
                     icp_ops(ops3[:6], ops3[6], ref_cfg.icp))
    # K3 at the main path's occupancy, and K1 against K3 around the limit
    sp3 = fused_operands(sparse_problem(FLEET_REF, REF_S, REF_C, REF_SCENE,
                                        REF_TARGET, True, seed=21))
    k3s_ms = cuda_ms(lambda: icp_fused.icp_fused_planes_tiled(*sp3,
                                                              ref_cfg.icp),
                     reps=20)
    k3s_plain_ms = cuda_ms(
        lambda: icp_fused.icp_fused_planes_tiled_reference(*sp3, ref_cfg.icp),
        reps=2)
    k3s_bound = bound(icp_bytes(sp3[:6], sp3[6]),
                      icp_ops(sp3[:6], sp3[6], ref_cfg.icp))
    crossover = []
    for C in CROSSOVER_C:
        o = fused_operands(registration_problem(FLEET_REF, REF_S, C, seed=13))
        i4 = icp_fused._pack_init4(o[6])
        # the kernels alone, K1 past fused_register's limit too
        crossover.append((C, cuda_ms(lambda: icp_fused._kernel_slab(
            *o[:6], i4, cfg.icp, False), reps=10), cuda_ms(
            lambda: icp_fused._tiled_kernel_slab(*o[:6], i4, cfg.icp),
            reps=10)))
    print(f"[time] B={FLEET} S=384 C=512: K1 {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.4f} ms, bound {k1_bound[0]:.6f} ms "
          f"({k1_bound[1]}); K4 call {t4['call']:.4f} ms, kernel alone "
          f"{t4['alone']:.4f} ms (on the points path's last call "
          f"{t4['path']:.4f} ms), plain {t4['plain']:.4f} ms, bound "
          f"{t4['bound'][0]:.6f} ms ({t4['bound'][1]}); S=C=384: K2 "
          f"{k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, bound "
          f"{k2_bound[0]:.6f} ms ({k2_bound[1]}); N={PF_SCORED} of 384 "
          f"G={PF_G} shared: K5 P=128 call (table and scores) "
          f"{t5['call']:.4f} ms, scoring kernel alone {t5['alone']:.4f} ms, "
          f"plain {t5['plain']:.4f} ms, bound {t5['bound'][0]:.6f} ms "
          f"({t5['bound'][1]}); K5 P=1 call {t51['call']:.4f} ms, kernel "
          f"alone {t51['alone']:.4f} ms, plain {t51['plain']:.4f} ms, bound "
          f"{t51['bound'][0]:.6f} ms ({t51['bound'][1]}); bit table alone "
          f"{pack['alone']:.4f} ms, plain {pack['plain']:.4f} ms, bound "
          f"{pack['bound'][0]:.6f} ms; device ops a call: nearest_neighbor "
          f"{nn_ops}, score_particles {k5_ops}, pf_match "
          f"{ops_a_call['pf_match']['n']} (K5 "
          f"{ops_a_call['pf_match']['K5']}); B={FLEET_REF} "
          f"S={REF_S} C={REF_C}: K3 {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} "
          f"ms, bound {k3_bound[0]:.6f} ms ({k3_bound[1]}); the same slots "
          f"with {REF_SCENE} scene and {REF_TARGET} model points scattered: "
          f"K3 {k3s_ms:.4f} ms, plain {k3s_plain_ms:.4f} ms, bound "
          f"{k3s_bound[0]:.6f} ms ({k3s_bound[1]}); kernels alone at "
          f"B={FLEET_REF} S={REF_S}, K1 / K3 ms: " + ", ".join(
              f"C={C} {a:.4f} / {b:.4f}" for C, a, b in crossover) +
          f" | {card}", flush=True)

    # the entry points after every device-op count: torch.profiler missed
    # [time]'s required K4 canaries when they ran before it
    entry = entry_phase(card)
    launches["K1 (entry)"] = entry["launches"]["K1"]
    for k in ("K2", "K4", "K5", "K5 table"):
        launches[k] += entry["launches"][k]
    fiducial_phase(card)
    mesh = mesh_phase(card)
    launches["K1 (mesh ranks)"] = mesh["K1"]
    launches["K5"] += mesh["K5"]
    launches["K5 table"] += mesh["K5 table"]

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "slam_tpu"
                    or m.startswith("slam_tpu."))
    if leaked:
        raise RuntimeError(f"imported modules of jax / slam_tpu: {leaked}")

    launches["K1, every path"] = sum(v for k, v in launches.items()
                                     if k.startswith("K1"))

    def record(label, source, replaces, key, err, ms, plain_ms, bnd):
        return {"name": label, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    print(json.dumps({"kernels": [
        record("icp_fused_planes (K1)", "slam_tpu_torch/csrc/icp_fused.cu",
               "slam_tpu/ops/icp_pallas.py:59", "K1, every path",
               max(k1["pose_err"], se3["k1_err"], entry["k1_err"],
                   mesh["k1_err"]), k1_ms,
               k1_plain_ms, k1_bound),
        record("icp_fused (K2, packed adapter onto K1's kernel)",
               "slam_tpu_torch/csrc/icp_fused.cu",
               "slam_tpu/ops/icp_pallas.py:39", "K2",
               max(graph["k2_err"], se3["k2_err"], entry["k2_err"]),
               graph["k2_ms"], graph["k2_plain_ms"], graph["k2_bound"]),
        record("icp_fused_planes_tiled (K3)",
               "slam_tpu_torch/csrc/icp_tiled.cu",
               "slam_tpu/ops/icp_pallas.py:271", "K3",
               max(k3["ref"]["pose_err"], graph3d["k3_err"]), k3_ms,
               k3_plain_ms, k3_bound),
        record("nearest_neighbor (K4)", "slam_tpu_torch/csrc/nn.cu",
               "slam_tpu/ops/nn_pallas.py:38", "K4", k4["max_abs_err"],
               t4["call"], t4["plain"], t4["bound"]),
        record("score_particles (K5)", "slam_tpu_torch/csrc/particle.cu",
               "slam_tpu/ops/particle.py:160", "K5", k5["max_abs_err"],
               t5["call"], t5["plain"], t5["bound"]),
        record("occupancy_bits (K5's bit table)",
               "slam_tpu_torch/csrc/particle.cu",
               "slam_tpu/ops/particle.py:160", "K5 table", k5["bits_err"],
               pack["alone"], pack["plain"], pack["bound"]),
    ]}))
    print(device_json(name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
