"""Sample-probability grid — counterpart of slam_tpu/mapping/sample_map.py
(`SampleMap`, `init_sample_map`, `add_sample`, `remove_cone`,
`SamplePeaks`, `extract_samples`), batched over robots.

Additive Gaussian evidence blobs clamped to [prob_min, prob_max], camera
cone decay, and candidate samples as thresholded local maxima with one
peak per plateau. The ranking is a stable descending sort: equal values
(saturated plateaus at prob_max are the rule) go to the lower flat cell
index, jax.lax.top_k's order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from slam_tpu_torch import default_device, true_div
from slam_tpu_torch.types import Replaceable


@dataclasses.dataclass
class SampleMap(Replaceable):
    prob: torch.Tensor   # (B, H, W) evidence in [prob_min, prob_max]


def init_sample_map(cfg, batch: int = 1, device=None) -> SampleMap:
    """Maps at the evidence floor, on the card unless `device` says
    otherwise."""
    device = default_device(device)
    return SampleMap(prob=torch.full((batch, cfg.size_x, cfg.size_y),
                                     cfg.prob_min, device=device))


def _cell_centers(cfg, device):
    H, W = cfg.size_x, cfg.size_y
    xs = (torch.arange(H, device=device) - H // 2 + 0.5) * cfg.resolution
    ys = (torch.arange(W, device=device) - W // 2 + 0.5) * cfg.resolution
    return xs[None, :, None], ys[None, None, :]


def add_sample(m: SampleMap, xy: torch.Tensor, amplitude: torch.Tensor,
               sigma: torch.Tensor, cfg) -> SampleMap:
    """A Gaussian evidence blob at global xy (B, 2) of amplitude and sigma
    (B,) each, cut at 3 sigma."""
    xs, ys = _cell_centers(cfg, m.prob.device)
    d2 = (xs - xy[:, 0, None, None]) ** 2 + (ys - xy[:, 1, None, None]) ** 2
    sig = sigma[:, None, None]
    blob = amplitude[:, None, None] * torch.exp(-d2 / (2.0 * sig * sig))
    blob = torch.where(d2 <= (3.0 * sig) ** 2, blob, 0.0)
    return SampleMap(prob=torch.clamp(m.prob + blob, cfg.prob_min,
                                      cfg.prob_max))


def remove_cone(m: SampleMap, xy: torch.Tensor, theta: torch.Tensor,
                dec_value: torch.Tensor, cfg) -> SampleMap:
    """Decay evidence in each robot's camera cone: cells with r in
    (r_min, r_max) and |angle - theta| < fov_cone / 2 lose dec_value.
    xy (B, 2); theta, dec_value (B,)."""
    xs, ys = _cell_centers(cfg, m.prob.device)
    qx = xs - xy[:, 0, None, None]
    qy = ys - xy[:, 1, None, None]
    r = torch.sqrt(qx * qx + qy * qy)
    dang = torch.atan2(qy, qx) - theta[:, None, None]
    dang = torch.atan2(torch.sin(dang), torch.cos(dang))
    in_cone = (r > cfg.r_min) & (r < cfg.r_max) & \
        (torch.abs(dang) < cfg.fov_cone / 2.0)
    dec = torch.where(in_cone, dec_value[:, None, None], 0.0)
    return SampleMap(prob=torch.clamp(m.prob - dec, cfg.prob_min,
                                      cfg.prob_max))


class SamplePeaks(NamedTuple):
    xy: torch.Tensor     # (B, K, 2) global candidate locations
    value: torch.Tensor  # (B, K) normalized probability
    valid: torch.Tensor  # (B, K)


def extract_samples(m: SampleMap, cfg, max_samples: int = 16) -> SamplePeaks:
    """Candidate samples: local maxima of the normalised probability above
    pixel_prob_threshold, one per plateau (a candidate with an equal-valued
    candidate among its up-left / up / up-right / left neighbours is
    dropped), the max_samples highest."""
    B, H, W = m.prob.shape
    norm = true_div(m.prob, cfg.prob_max)
    p = F.pad(norm, (1, 1, 1, 1), value=-1.0)
    neigh = torch.stack([p[:, i:i + H, j:j + W]
                         for i in range(3) for j in range(3)
                         if not (i == 1 and j == 1)]).amax(0)
    cand = (norm > cfg.pixel_prob_threshold) & (norm >= neigh)
    pc = F.pad(cand, (1, 1, 1, 1), value=False)
    tied_smaller = torch.zeros_like(cand)
    for i, j in ((0, 0), (0, 1), (0, 2), (1, 0)):   # NW, N, NE, W
        tied_smaller |= pc[:, i:i + H, j:j + W] & (p[:, i:i + H, j:j + W]
                                                   >= norm)
    is_peak = cand & ~tied_smaller
    score = torch.where(is_peak, norm, -1.0).reshape(B, -1)
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :max_samples], idx[:, :max_samples]
    x = (idx // W - H // 2 + 0.5) * cfg.resolution
    y = (idx % W - W // 2 + 0.5) * cfg.resolution
    return SamplePeaks(xy=torch.stack([x, y], -1), value=vals,
                       valid=vals > 0)
