"""Relocalization — counterpart of slam_tpu/pipeline/relocalize.py
(`relocalize`, `relocalize_with_fallback`, `apply_relocalization`,
`apply_relocalization_graph`, `fleet_relocalize_if_lost`), batched over
robots.

A lost robot's scene is matched against its map around its belief by the
exhaustive FFT search and ICP polish (`ops/fft_match.global_match`); an
accepted match shifts the EKF belief by the recovered pose delta. Graph
robots also get the match as an edge from node 0 and re-optimise.

Relocalization is a recovery path: `fleet_relocalize_if_lost` reads one
flag from the card ("is any robot lost") and runs the search for the
whole batch only when one is, as slam_tpu's batch-level `lax.cond` does;
healthy robots pass through bit for bit.

On grids split by rows (parallel/rows.py) relocalization reads only the
replicated map_cloud and EKF state, so every rank of an sp group takes
the same branch and finds the same match; the EKF shift that follows
moves the grids at the next re-centring, by a slab or more through the
roll's ring. The search raster and the polish are transients, built
whole and alike on every rank.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.geometry import subtract_yaw
from slam_tpu_torch.graph import pose_graph as pg
from slam_tpu_torch.models import ekf as ekf_mod
from slam_tpu_torch.ops.fft_match import MatchResult, global_match
from slam_tpu_torch.types import PointCloud, SlamState, select_cloud
from slam_tpu_torch.utils import profiling


def relocalize(state: SlamState, scene: PointCloud, cfg) -> MatchResult:
    """Match each robot's (robot-frame) scene against its map_cloud around
    its current belief. It reads no grid: on grids split by rows every
    rank of the sp group searches the same replicated map_cloud alike."""
    return global_match(scene, state.map_cloud, state.pose[:, :2],
                        cfg.global_match, cfg.icp)


def relocalize_with_fallback(state: SlamState, scene: PointCloud, cfg,
                             failures: torch.Tensor):
    """relocalize, and after global_match.max_failures consecutive
    rejections publish the prior belief as an accepted match of score 0, so
    that consumers stop waiting on a robot that will not match. failures:
    (B,) int32 consecutive rejections, carried by the caller (reset on a
    success or a fallback). Returns (match, new failures)."""
    match = relocalize(state, scene, cfg)
    failures = torch.where(match.ok, 0, failures + 1)
    give_up = failures >= cfg.global_match.max_failures
    out = MatchResult(
        pose=torch.where(give_up[:, None], state.pose[:, :3], match.pose),
        score=torch.where(give_up, 0.0, match.score),
        ok=give_up | match.ok)
    return out, torch.where(give_up, 0, failures).to(torch.int32)


def apply_relocalization(state: SlamState, match: MatchResult) -> SlamState:
    """Where a match is accepted, shift the EKF belief by its pose delta
    (x, y added, yaw wrapped) and take its pose; elsewhere keep the state's
    own values."""
    mu = state.ekf.mu
    delta = torch.stack([match.pose[:, 0] - mu[:, 0],
                         match.pose[:, 1] - mu[:, 1],
                         subtract_yaw(match.pose[:, 2], mu[:, 6])], -1)
    shifted = ekf_mod.global_offset(state.ekf, delta)
    ok = match.ok[:, None]
    return state.replace(
        ekf=state.ekf.replace(mu=torch.where(ok, shifted.mu, mu)),
        pose=torch.where(ok, torch.cat([match.pose, state.pose[:, 3:4]], -1),
                         state.pose))


def apply_relocalization_graph(state: SlamState, match: MatchResult,
                               cfg) -> SlamState:
    """Relocalization for graph robots: shift the EKF belief, add the match
    as an edge from node 0 to the newest keyframe (a genuine match only:
    the give-up fallback's score-0 prior is never an edge), re-optimise the
    graphs that took the edge and regenerate their target (voxel merge).
    Every robot runs every stage and torch.where keeps what its edge
    selects, so nothing waits for the card."""
    belief = state.pose
    state = apply_relocalization(state, match)
    genuine = match.ok & (match.score > 0.0)
    graph, injected = pg.relocalization_edge(state.graph, belief, match.pose,
                                             genuine, cfg.graph)
    optimized, _ = pg.optimize(graph, cfg.graph,
                               state.local_map.rows is not None)
    graph = graph.replace(node_pose=torch.where(
        injected[:, None, None], optimized.node_pose, graph.node_pose))
    regen = pg.regenerate_map(graph, state.map_cloud.capacity,
                              cfg.icp.voxel_leaf_obs)
    return state.replace(graph=graph,
                         map_cloud=select_cloud(injected, regen,
                                                state.map_cloud))


def fleet_relocalize_if_lost(states: SlamState, cfg,
                             lost: torch.Tensor | None = None) -> SlamState:
    """Relocalize the lost robots of a fleet: when any robot is lost (one
    read of a flag from the card), search for the whole batch and apply the
    match to the lost robots only; otherwise return the states as they
    are. lost: (B,) bool, by default the last tick's failed registrations
    (~scan_reg_ok)."""
    if lost is None:
        lost = ~states.scan_reg_ok
    with profiling.stage("reloc.gate"):
        profiling.count("host_syncs")
        if not bool(lost.any()):
            return states
    with profiling.stage("reloc.search"):
        m = relocalize(states, states.prev_scene, cfg)
    with profiling.stage("reloc.apply"):
        return apply_relocalization(states, m._replace(ok=m.ok & lost))
