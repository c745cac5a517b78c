"""Rendering — counterpart of slam_tpu/utils/viz.py (the rviz analogue).

Headless: trajectories, occupancy / drivability grids and MLS cluster
markers to PNG through matplotlib when it can be imported (lazily, at the
first render), else raw .npy / .npz dumps. Inputs are numpy arrays or
tensors (moved to the host); the port's MLS grids are batched over robots,
so `mls_markers` takes one robot's (`robot`).
"""

from __future__ import annotations

import numpy as np
import torch


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x if x is None else np.asarray(x)


def render_trajectory(path: str, est, true=None, world_pts=None) -> None:
    """Trajectory overlay (the ekf_path_viz topic analogue)."""
    est, true, world_pts = _host(est), _host(true), _host(world_pts)
    try:
        plt = _plt()
    except Exception:
        np.save(path + ".npy", est)
        return
    fig, ax = plt.subplots(figsize=(7, 7))
    if world_pts is not None and len(world_pts):
        ax.scatter(world_pts[:, 0], world_pts[:, 1], s=2, c="#999", label="map")
    if true is not None:
        ax.plot(true[:, 0], true[:, 1], "g-", lw=2, label="true")
    ax.plot(est[:, 0], est[:, 1], "b--", lw=1.5, label="estimate")
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def mls_markers(grid, cfg, robot: int = 0) -> dict:
    """Per-cluster Gaussian markers — MLS::visualize (mls.cpp:558-679).

    One sphere marker per live cluster: position = cell center (rolling
    branch) at the cluster's mean z; z-scale = sigma * cluster_sigma_factor
    (0.1 for singletons); alpha 0.1 for uninitialized clusters else 0.6;
    color green for the ground cluster of a drivable cell, blue for elevated
    clusters, red for non-drivable cells (mls.cpp:640-667; the reference's
    `if(cell->drivable)` treats unknown (-1) as truthy, matched here).

    grid: a port MlsGrid (B, H, W, K, ...); robot `robot`'s layers.
    Returns {"pos": (M, 3), "scale": (M, 3), "rgba": (M, 4)} numpy arrays
    for the M live clusters, robot/world frame per the grid's own frame.
    """
    mean = _host(grid.mean[robot])
    var_z = _host(grid.var_z[robot])
    num = _host(grid.num_pts[robot])
    drv = _host(grid.drivable[robot])
    H, W, K = num.shape
    res = cfg.resolution

    ii, jj, kk = np.meshgrid(np.arange(H), np.arange(W), np.arange(K),
                             indexing="ij")
    live = num > 0
    x = (ii - H // 2) * res
    y = (jj - W // 2) * res
    z = mean[..., 2]
    pos = np.stack([x, y, z], -1)[live]

    singleton = (num == 1)
    sz = np.sqrt(np.maximum(var_z, 0.0)) * cfg.cluster_sigma_factor
    scale = np.stack([np.where(singleton, 0.1, res),
                      np.where(singleton, 0.1, res),
                      np.where(singleton, 0.1, sz)], -1)[live]

    initialized = num >= cfg.min_cluster_points
    has_g = initialized.any(-1)
    gidx = np.argmax(initialized, -1)
    is_ground = (kk == gidx[..., None]) & has_g[..., None] \
        | (~has_g[..., None]) & (kk == 0)
    drivable_cell = (drv != 0)[..., None]          # -1 unknown is truthy
    r = np.where(drivable_cell, 0.0, 1.0)
    g = np.where(drivable_cell & is_ground, 1.0, 0.0)
    b = np.where(drivable_cell & ~is_ground, 1.0, 0.0)
    a = np.where(initialized, 0.6, 0.1)
    rgba = np.stack([np.broadcast_to(r, num.shape),
                     np.broadcast_to(g, num.shape),
                     np.broadcast_to(b, num.shape), a], -1)[live]
    return {"pos": pos, "scale": scale, "rgba": rgba}


def render_mls_markers(path: str, markers: dict, title="MLS clusters") -> None:
    """Top-down render of mls_markers output (the rviz MarkerArray view)."""
    try:
        plt = _plt()
    except Exception:
        np.savez(path + ".npz", **markers)
        return
    pos, scale, rgba = markers["pos"], markers["scale"], markers["rgba"]
    fig, ax = plt.subplots(figsize=(7, 7))
    if len(pos):
        order = np.argsort(pos[:, 2])          # paint low clusters first
        s = (scale[order, 0] * 40) ** 2
        ax.scatter(pos[order, 0], pos[order, 1], s=s, c=rgba[order],
                   edgecolors="none")
    ax.set_aspect("equal")
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def render_grid(path: str, grid, center=None, title="") -> None:
    """Drivability / occupancy grid image (H, W) (the OccupancyGrid topic
    analogue): -1 unknown (gray), 0 occupied (black), 1 drivable (white)."""
    grid = _host(grid)
    try:
        plt = _plt()
    except Exception:
        np.save(path + ".npy", grid)
        return
    img = np.full(grid.shape + (3,), 0.5)
    img[grid == 0] = (0.05, 0.05, 0.05)
    img[grid == 1] = (1.0, 1.0, 1.0)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.swapaxes(img, 0, 1), origin="lower")
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
