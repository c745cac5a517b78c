"""Batched fiducial (AprilTag-equivalent) detection — counterpart of
slam_tpu/ops/fiducial.py (`FiducialConfig`, `Detections`, `tag36h11`,
`tag36h10`, `make_codebook`, `connected_components`, `detect_tags` with
both segmenters, `homography_from_corners`, `_decode_quad`,
`detect_tags_gradient`, `render_tag`).

The stages are slam_tpu's: adaptive box-mean threshold (or gradient edge
segments), min-label connected components with pointer jumping, the exact
top-T components by size, moments and corner picks by per-slot scatter
max / min, the unit-square DLT homography, payload sampling with a linear
gray model, and the codebook match under four rotations. Here every stage
runs over a leading image dim N (slam_tpu vmaps one image): images are
(N, H, W) in [0, 1] and every Detections field has leading dims (N, Q).

Differences of idiom, each keeping slam_tpu's values:
- ranking (top components, top quads, top segments) is a stable
  descending sort: equal scores go to the lower index, which is
  jax.lax.top_k's order; torch.topk leaves it undefined, and ties are the
  rule here (identical tags have equal areas);
- per-slot sums, maxima and minima are scatters into a buffer with one
  slot for each pixel that belongs to no component, so those pixels never
  meet on one address (the card serializes atomics on one address); a
  float sum over a component is atomic on the card, so its order, and the
  last ulps of a centroid, change from run to run;
- the 8 x 8 DLT and 3 x 3 gray-model solves are `torch.linalg.solve_ex`,
  which checks nothing on the host, so a detection makes no host sync;
- the box mean divides by the window through `true_div` (a true division
  on the card too).
Nothing here needs a kernel of its own: slam_tpu reaches no Pallas kernel
in this module.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from slam_tpu_torch import true_div


class FiducialConfig(NamedTuple):
    grid_dim: int = 8            # cells incl. 1-cell black border (6x6 payload)
    cc_iters: int = 16           # label sweeps (logarithmic via pointer jump)
    max_detections: int = 8      # per image
    min_area: int = 64           # component pixel-area gates
    max_area: int = 100000
    thresh_margin: float = 0.08  # adaptive threshold margin
    box: int = 15                # adaptive threshold window (odd)
    max_hamming: int = 2         # decode acceptance (AprilTag default)
    blur_sigma: float = 0.0      # optional pre-blur (seg_sigma)
    open_radius: int = 1         # morphological opening of the dark mask
    decimate: int = 1            # segmentation decimation (quad_decimate)
    segmenter: str = "cc"        # "cc" | "gradient"
    grad_mag_thresh: float = 0.12
    grad_angle_tol: float = 0.3
    grad_coherence: float = 0.8
    min_seg_pixels: int = 8
    min_seg_len: float = 8.0
    quad_join_dist: float = 14.0
    collinear_join_dist: float = 26.0


class Detections(NamedTuple):
    tag_id: torch.Tensor     # (N, Q) int32, -1 if invalid
    corners: torch.Tensor    # (N, Q, 4, 2) pixel coords (x=col, y=row)
    center: torch.Tensor     # (N, Q, 2)
    hamming: torch.Tensor    # (N, Q) int32
    valid: torch.Tensor      # (N, Q) bool


# ---------- codebooks ----------

def tag36h11() -> np.ndarray:
    """The published tag36h11 family (587, 36) bool."""
    from slam_tpu_torch.data.tag_families import tag36h11_codebook
    return tag36h11_codebook()


def tag36h10() -> np.ndarray:
    """The published tag36h10 family (2320, 36) bool."""
    from slam_tpu_torch.data.tag_families import tag36h10_codebook
    return tag36h10_codebook()


def make_codebook(seed: int, num_codes: int, bits: int = 36,
                  min_hamming: int = 10) -> np.ndarray:
    """A synthetic tag family (K, bits) bool with pairwise Hamming
    separation >= min_hamming under all 4 rotations; numpy, the same draws
    as slam_tpu's."""
    side = int(np.sqrt(bits))
    if side * side != bits:
        raise ValueError(f"bits must be a square, got {bits}")
    rng = np.random.default_rng(seed)
    codes = []

    def rots(c):
        g = c.reshape(side, side)
        return [np.rot90(g, k).reshape(-1) for k in range(4)]

    while len(codes) < num_codes:
        cand = rng.random(bits) > 0.5
        ok = True
        for c in codes:
            for r in rots(cand):
                if np.sum(c != r) < min_hamming:
                    ok = False
                    break
            if not ok:
                break
        for r in rots(cand)[1:]:
            if np.sum(cand != r) < min_hamming:
                ok = False
        if ok:
            codes.append(cand)
    return np.stack(codes)


def _topk_stable(x: torch.Tensor, k: int):
    """jax.lax.top_k over the last dim: the k largest, equal values in
    index order."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


# ---------- stage 1-2: threshold + connected components ----------

def _box_mean(img: torch.Tensor, k: int) -> torch.Tensor:
    """Separable box filter of (N, H, W) via cumulative sums."""
    pad = k // 2

    def blur1d(a, dim):
        n = a.shape[dim]
        pads = (pad + 1, pad) if dim == 2 else (0, 0, pad + 1, pad)
        csum = torch.cumsum(F.pad(a, pads), dim=dim)
        return true_div(csum.narrow(dim, k, n) - csum.narrow(dim, 0, n), k)

    return blur1d(blur1d(img, 1), 2)


def _gauss5(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable 5-tap Gaussian of (N, H, W), edge-padded."""
    N, H, W = img.shape
    t = torch.exp(-0.5 * (torch.arange(-2.0, 3.0, device=img.device)
                          / sigma) ** 2)
    t = t / t.sum()
    pad = F.pad(img[:, None], (2, 2, 2, 2), mode="replicate")[:, 0]
    out = 0
    for i in range(5):
        out = out + t[i] * pad[:, i:i + H, 2:2 + W]
    outp = F.pad(out[:, None], (2, 2, 0, 0), mode="replicate")[:, 0]
    res = 0
    for i in range(5):
        res = res + t[i] * outp[:, :, i:i + W]
    return res


def _shifted(p: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """The (H, W) window of a 1-padded (N, H + 2, W + 2) array moved by
    (di, dj)."""
    return p[:, 1 + di:p.shape[1] - 1 + di, 1 + dj:p.shape[2] - 1 + dj]


def _morph(mask: torch.Tensor, r: int, erode: bool) -> torch.Tensor:
    """r iterations of 3x3 binary erosion (or dilation), False outside."""
    for _ in range(r):
        p = F.pad(mask, (1, 1, 1, 1), value=False)
        m = p[:, 1:-1, 1:-1]
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if di == 0 and dj == 0:
                    continue
                s = _shifted(p, di, dj)
                m = (m & s) if erode else (m | s)
        mask = m
    return mask


def _jump(new: torch.Tensor, mask: torch.Tensor, sentinel: int):
    """Two pointer jumps: each label becomes the label at the pixel it
    names, when that is smaller."""
    N, H, W = new.shape
    pad = new.new_full((N, 1), sentinel)
    for _ in range(2):
        flat = torch.cat([new.reshape(N, -1), pad], 1)
        jumped = torch.gather(flat, 1, new.reshape(N, -1)).view(N, H, W)
        new = torch.where(mask, torch.minimum(new, jumped), sentinel)
    return new


def connected_components(mask: torch.Tensor, iters: int) -> torch.Tensor:
    """Min-label propagation with pointer jumping over (N, H, W) masks:
    labels (N, H, W) int64, each the smallest flat pixel index its sweeps
    reached; background -1. Each sweep takes the 4-neighbour minimum, then
    jumps twice."""
    N, H, W = mask.shape
    sentinel = H * W
    idx = torch.arange(H * W, device=mask.device).view(1, H, W)
    lab = torch.where(mask, idx, sentinel)
    for _ in range(iters):
        p = F.pad(lab, (1, 1, 1, 1), value=sentinel)
        neigh = torch.minimum(torch.minimum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]),
                              torch.minimum(p[:, 1:-1, :-2], p[:, 1:-1, 2:]))
        new = torch.where(mask, torch.minimum(lab, neigh), sentinel)
        lab = _jump(new, mask, sentinel)
    return torch.where(mask, lab, -1)


def _component_slots_topk(labels: torch.Tensor, K: int):
    """Exact top-K-by-size component slots of (N, H, W) labels. Returns
    (per-pixel slot (N, H*W) in [0, K], K = none; slot counts (N, K))."""
    N = labels.shape[0]
    HW = labels.shape[1] * labels.shape[2]
    flat = labels.reshape(N, HW)
    fg = flat >= 0
    pix = torch.arange(HW, device=labels.device).expand(N, HW)
    # a background pixel adds 0 at its own index, which labels no
    # component (a label is a pixel of its component)
    counts = torch.zeros(N, HW + 1, device=labels.device).scatter_add_(
        1, torch.where(fg, flat, pix), fg.to(torch.float32))
    top_c, top_lab = _topk_stable(counts[:, :HW], K)
    slot_of = torch.full((N, HW + 1), K, dtype=torch.int64,
                         device=labels.device).scatter_(
        1, top_lab, torch.arange(K, device=labels.device).expand(N, K))
    slot = torch.gather(slot_of, 1, torch.where(fg, flat, HW))
    live = torch.gather(top_c, 1, slot.clamp(max=K - 1)) > 0
    return torch.where(fg & live, slot, K), top_c


class _Slots:
    """Per-slot reductions over the pixels of (N, H*W) slot maps (slot T =
    no slot). A pixel without a slot reduces into a spare entry of its own
    (T + its index), so those pixels never share an address."""

    def __init__(self, slot_pp: torch.Tensor, T: int):
        N, HW = slot_pp.shape
        self.T, self.HW = T, HW
        self.has = slot_pp < T
        pix = torch.arange(HW, device=slot_pp.device)
        self.index = torch.where(self.has, slot_pp, T + pix)
        self.slot_c = slot_pp.clamp(max=T - 1)
        self.pix = pix.expand(N, HW)

    def _buf(self, fill, dtype=torch.float32):
        return torch.full((self.has.shape[0], self.T + self.HW), fill,
                          dtype=dtype, device=self.has.device)

    def add(self, v: torch.Tensor) -> torch.Tensor:
        return self._buf(0.0).scatter_add_(1, self.index, v)[:, :self.T]

    def at(self, per_slot: torch.Tensor) -> torch.Tensor:
        """Each pixel's value of a (N, T) per-slot quantity (its clamped
        slot's)."""
        return torch.gather(per_slot, 1, self.slot_c)

    def argmax(self, value: torch.Tensor, xx, yy):
        """Exact per-slot argmax pixel: the smallest index among pixels
        within 1e-5 of the slot's maximum. Returns (found, x, y) (N, T)."""
        best = self._buf(-float("inf")).scatter_reduce_(
            1, self.index, torch.where(self.has, value, -float("inf")),
            "amax")
        best = torch.gather(best, 1, self.index)
        hit = self.has & (value >= best - 1e-5)
        pick = self._buf(self.HW, torch.int64).scatter_reduce_(
            1, self.index, torch.where(hit, self.pix, self.HW),
            "amin")[:, :self.T]
        safe = pick.clamp(max=self.HW - 1)
        return (pick < self.HW, torch.gather(xx, 1, safe),
                torch.gather(yy, 1, safe))


def _pixel_coords(N: int, H: int, W: int, device):
    """Row-major (N, H*W) x (column) and y (row) coordinates as f32."""
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None] \
        .expand(H, W).reshape(1, -1).expand(N, -1)
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :] \
        .expand(H, W).reshape(1, -1).expand(N, -1)
    return xx, yy


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[n, idx[n, ...]] for (N, T, ...) a and (N, ...) idx."""
    flat = idx.reshape(idx.shape[0], -1)
    tail = a.shape[2:]
    g = torch.gather(a, 1, flat.view(*flat.shape, *([1] * len(tail)))
                     .expand(*flat.shape, *tail))
    return g.view(*idx.shape, *tail)


# ---------- stage 3-4: components, moments, corners ----------

def detect_tags(img: torch.Tensor, codebook: torch.Tensor,
                cfg: FiducialConfig = FiducialConfig()) -> Detections:
    """Detect tags in grayscale images (N, H, W) in [0, 1] against a
    codebook (K, 36) bool. cfg.segmenter selects the engine: "cc" (dark
    components, below) or "gradient" (detect_tags_gradient)."""
    if cfg.segmenter == "gradient":
        return detect_tags_gradient(img, codebook, cfg)
    if cfg.segmenter != "cc":
        raise ValueError(f"unknown segmenter {cfg.segmenter!r}")
    N = img.shape[0]
    Q = cfg.max_detections
    T = 4 * Q

    img_s = _gauss5(img, cfg.blur_sigma) if cfg.blur_sigma > 0 else img
    d = max(1, cfg.decimate)
    seg_img = img_s[:, ::d, ::d] if d > 1 else img_s
    H, W = seg_img.shape[1:]
    area_scale = float(d * d)

    mean = _box_mean(seg_img, cfg.box)
    dark = seg_img < (mean - cfg.thresh_margin)
    if cfg.open_radius > 0:
        dark = _morph(_morph(dark, cfg.open_radius, True), cfg.open_radius,
                      False)
    labels = connected_components(dark, cfg.cc_iters)
    slot_pp, _ = _component_slots_topk(labels, T)
    s = _Slots(slot_pp, T)

    xx, yy = _pixel_coords(N, H, W, img.device)
    w = s.has.to(torch.float32)
    area = s.add(w)
    cx = s.add(w * xx) / torch.clamp(area, min=1.0)
    cy = s.add(w * yy) / torch.clamp(area, min=1.0)

    # convex-quad corners: c0 farthest from the centroid, c2 farthest from
    # c0, c1 / c3 the extreme signed-cross points either side of c0 -> c2
    dx0 = xx - s.at(cx)
    dy0 = yy - s.at(cy)
    ok0, c0x, c0y = s.argmax(dx0 * dx0 + dy0 * dy0, xx, yy)
    d0x = xx - s.at(c0x)
    d0y = yy - s.at(c0y)
    ok2, c2x, c2y = s.argmax(d0x * d0x + d0y * d0y, xx, yy)
    ex = s.at(c2x - c0x)
    ey = s.at(c2y - c0y)
    cross = ex * d0y - ey * d0x
    # negative-cross side first: the homography's unit-square winding
    ok1, c1x, c1y = s.argmax(-cross, xx, yy)
    ok3, c3x, c3y = s.argmax(cross, xx, yy)
    corner_ok = ok0 & ok1 & ok2 & ok3
    corners = torch.stack([
        torch.stack([c0x, c0y], -1), torch.stack([c1x, c1y], -1),
        torch.stack([c2x, c2y], -1), torch.stack([c3x, c3y], -1)], 2)

    diag2 = (c2x - c0x) ** 2 + (c2y - c0y) ** 2
    off1 = torch.abs((c2x - c0x) * (c1y - c0y) - (c2y - c0y) * (c1x - c0x))
    off3 = torch.abs((c2x - c0x) * (c3y - c0y) - (c2y - c0y) * (c3x - c0x))
    not_flat = (off1 > 0.1 * diag2) & (off3 > 0.1 * diag2)

    good = (area >= cfg.min_area / area_scale) & \
        (area <= cfg.max_area / area_scale) & corner_ok & not_flat

    top_area, top_idx = _topk_stable(torch.where(good, area, -1.0), Q)
    sel_ok = top_area > 0
    sel_corners = _take(corners, top_idx) * d                  # (N, Q, 4, 2)
    sel_center = _take(torch.stack([cx, cy], -1), top_idx) * d

    tag_id, hamming, dec_ok = _decode_quad(img, sel_corners, codebook, cfg)
    valid = sel_ok & dec_ok
    return Detections(tag_id=torch.where(valid, tag_id, -1),
                      corners=sel_corners, center=sel_center,
                      hamming=hamming, valid=valid)


# ---------- stage 5-6: homography + decode ----------

def homography_from_corners(corners: torch.Tensor) -> torch.Tensor:
    """DLT homography (..., 3, 3) mapping the unit square (0,0), (1,0),
    (1,1), (0,1) onto corners (..., 4, 2)."""
    u, v = corners[..., 0], corners[..., 1]                      # (..., 4)
    z = torch.zeros_like(u[..., 0])
    o = torch.ones_like(z)
    rows = []
    for i, (x, y) in enumerate(((0.0, 0.0), (1.0, 0.0), (1.0, 1.0),
                                (0.0, 1.0))):
        ui, vi = u[..., i], v[..., i]
        rows.append(torch.stack([z + x, z + y, o, z, z, z,
                                 -ui * x, -ui * y], -1))
        rows.append(torch.stack([z, z, z, z + x, z + y, o,
                                 -vi * x, -vi * y], -1))
    A = torch.stack(rows, -2)                                   # (..., 8, 8)
    b = torch.stack([u[..., 0], v[..., 0], u[..., 1], v[..., 1],
                     u[..., 2], v[..., 2], u[..., 3], v[..., 3]], -1)
    eye = torch.eye(8, dtype=A.dtype, device=A.device)
    sol = torch.linalg.solve_ex(A + 1e-9 * eye, b)[0]
    return torch.cat([sol, o[..., None]], -1).reshape(*sol.shape[:-1], 3, 3)


def _bilinear(img: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """Four-tap bilinear samples of images (N, H, W) at (N, ...) points,
    clipped to [0, W - 1.001] x [0, H - 1.001]."""
    N, H, W = img.shape
    shape = x.shape
    x = torch.clamp(x, 0.0, W - 1.001).reshape(N, -1)
    y = torch.clamp(y, 0.0, H - 1.001).reshape(N, -1)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx, fy = x - x0, y - y0
    flat = img.reshape(N, -1)

    def at(r, c):
        return torch.gather(flat, 1, r * W + c)

    v00, v01 = at(y0, x0), at(y0, x0 + 1)
    v10, v11 = at(y0 + 1, x0), at(y0 + 1, x0 + 1)
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    return out.view(shape)


def _decode_quad(img: torch.Tensor, corners: torch.Tensor,
                 codebook: torch.Tensor, cfg: FiducialConfig):
    """Sample every quad's tag grid through its homography and match the
    codebook under 4 rotations. img (N, H, W), corners (N, Q, 4, 2) ->
    (tag_id, hamming, ok), each (N, Q)."""
    D = cfg.grid_dim
    side = D - 2
    dev = img.device
    Hm = homography_from_corners(corners)                      # (N, Q, 3, 3)

    def project(u, v):
        p = Hm @ torch.stack([u, v, torch.ones_like(u)])        # (N, Q, 3, M)
        return p[..., 0, :] / p[..., 2, :], p[..., 1, :] / p[..., 2, :]

    ii = (torch.arange(side, device=dev) + 1.5) / D
    vv, uu = torch.meshgrid(ii, ii, indexing="ij")
    uu, vv = uu.reshape(-1), vv.reshape(-1)
    px, py = project(uu, vv)
    vals = _bilinear(img, px, py)

    # black reference: border cell centres; white: just outside. Linear
    # gray models over each set move the per-cell threshold with an
    # illumination gradient.
    jb = (torch.arange(D, device=dev) + 0.5) / D
    lo = torch.full((D,), 0.5 / D, device=dev)
    hi = torch.full((D,), 1 - 0.5 / D, device=dev)
    bu = torch.cat([jb, jb, lo, hi])
    bv = torch.cat([lo, hi, jb, jb])
    black_vals = _bilinear(img, *project(bu, bv))
    wu, wv = bu * 1.25 - 0.125, bv * 1.25 - 0.125
    white_vals = _bilinear(img, *project(wu, wv))

    def fit_plane(u, v, w):
        A = torch.stack([u, v, torch.ones_like(u)], -1)          # (M, 3)
        AtA = A.T @ A + 1e-6 * torch.eye(3, device=dev)
        rhs = w @ A                                             # (N, Q, 3)
        return torch.linalg.solve_ex(AtA.expand(*rhs.shape, 3), rhs)[0]

    cb = fit_plane(bu, bv, black_vals)
    cw = fit_plane(wu, wv, white_vals)
    uv1 = torch.stack([uu, vv, torch.ones_like(uu)], -1)        # (cells, 3)
    black_c = cb @ uv1.T
    white_c = cw @ uv1.T
    thresh = 0.5 * (black_c + white_c)
    black = black_vals.mean(-1)
    white = white_vals.mean(-1)
    grid = (vals > thresh).view(*vals.shape[:-1], side, side)

    best_id = torch.full(vals.shape[:-1], -1, dtype=torch.int64, device=dev)
    best_ham = torch.full(vals.shape[:-1], 99, dtype=torch.int64, device=dev)
    for k in range(4):
        g = torch.rot90(grid, k, dims=(-2, -1)).reshape(*grid.shape[:-2], -1)
        ham = (g[..., None, :] != codebook).sum(-1)              # (N, Q, K)
        h, i = torch.min(ham, -1)
        take = h < best_ham
        best_id = torch.where(take, i, best_id)
        best_ham = torch.where(take, h, best_ham)
    ok = (best_ham <= cfg.max_hamming) & ((white - black) > 0.15)
    return best_id.to(torch.int32), best_ham.to(torch.int32), ok


# ---------- gradient segmentation + quad search ----------

def _grad(img: torch.Tensor):
    """Central-difference gradients (gx toward +x, gy toward +y) of
    (N, H, W), zero on the border rows / columns."""
    gy = torch.zeros_like(img)
    gy[:, 1:-1, :] = 0.5 * (img[:, 2:, :] - img[:, :-2, :])
    gx = torch.zeros_like(img)
    gx[:, :, 1:-1] = 0.5 * (img[:, :, 2:] - img[:, :, :-2])
    return gx, gy


def connected_components_directed(mask: torch.Tensor, theta: torch.Tensor,
                                  iters: int,
                                  tol_cos: torch.Tensor) -> torch.Tensor:
    """Min-label propagation where 4-neighbours join only when their
    gradient directions agree: cos(theta_a - theta_b) > tol_cos."""
    N, H, W = mask.shape
    sentinel = H * W
    idx = torch.arange(H * W, device=mask.device).view(1, H, W)
    lab = torch.where(mask, idx, sentinel)
    pt = F.pad(theta, (1, 1, 1, 1))
    pm = F.pad(mask, (1, 1, 1, 1), value=False)
    nbrs = ((-1, 0), (1, 0), (0, -1), (0, 1))
    conns = [mask & _shifted(pm, di, dj)
             & (torch.cos(theta - _shifted(pt, di, dj)) > tol_cos)
             for di, dj in nbrs]
    for _ in range(iters):
        p = F.pad(lab, (1, 1, 1, 1), value=sentinel)
        new = lab
        for (di, dj), ok in zip(nbrs, conns):
            new = torch.minimum(new, torch.where(ok, _shifted(p, di, dj),
                                                 sentinel))
        new = torch.where(mask, new, sentinel)
        lab = _jump(new, mask, sentinel)
    return torch.where(mask, lab, -1)


def _line_intersect(p0, d0, p1, d1):
    """Intersection of lines p0 + t d0 and p1 + s d1 (batched over leading
    dims); parallel pairs fall back to the endpoint midpoint."""
    det = d0[..., 0] * (-d1[..., 1]) - (-d1[..., 0]) * d0[..., 1]
    rhs = p1 - p0
    par = torch.abs(det) < 1e-6
    t = (rhs[..., 0] * (-d1[..., 1]) - (-d1[..., 0]) * rhs[..., 1]) / \
        torch.where(par, 1.0, det)
    inter = p0 + t[..., None] * d0
    return torch.where(par[..., None], 0.5 * (p0 + p1), inter)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def detect_tags_gradient(img: torch.Tensor, codebook: torch.Tensor,
                         cfg: FiducialConfig = FiducialConfig()) -> Detections:
    """Gradient-segmentation detector over (N, H, W): edge pixels clustered
    by gradient direction into segments, weighted line fits with extremal
    endpoints, collinear merge, endpoint chaining with left turns, 4-cycles
    of the chaining graph as quads, corners at consecutive line
    intersections; decode as in detect_tags."""
    N, H0, W0 = img.shape
    Q = cfg.max_detections
    T = 64   # exact top-T components by size
    K = 32   # strongest segments kept for the quad search
    dev = img.device

    d = max(1, cfg.decimate)
    seg_img = img[:, ::d, ::d] if d > 1 else img
    H, W = seg_img.shape[1:]

    seg_img = _gauss5(seg_img, max(cfg.blur_sigma, 0.8))
    gx, gy = _grad(seg_img)
    mag2 = gx * gx + gy * gy
    edge = mag2 > (cfg.grad_mag_thresh ** 2)
    theta = torch.atan2(gy, gx)

    # cut corner pixels (low 5x5 direction coherence) so adjacent sides
    # cannot chain into one component
    ux = torch.where(edge, torch.cos(theta), 0.0)
    uy = torch.where(edge, torch.sin(theta), 0.0)

    def box5(a):
        p = F.pad(a, (2, 2, 2, 2))
        out = torch.zeros_like(a)
        for di in range(5):
            for dj in range(5):
                out = out + p[:, di:di + H, dj:dj + W]
        return out

    sx_ = box5(ux)
    sy_ = box5(uy)
    cnt5 = torch.clamp(box5(edge.to(torch.float32)), min=1.0)
    coh = (sx_ * sx_ + sy_ * sy_) / (cnt5 * cnt5)
    edge = edge & (coh > cfg.grad_coherence)

    tol_cos = torch.full((), cfg.grad_angle_tol, device=dev).cos()
    labels = connected_components_directed(edge, theta, cfg.cc_iters,
                                           tol_cos)
    slot_pp, _ = _component_slots_topk(labels, T)
    s = _Slots(slot_pp, T)

    xx, yy = _pixel_coords(N, H, W, dev)
    segw = s.has.to(torch.float32)
    w = torch.where(s.has, torch.sqrt(mag2).reshape(N, -1), 0.0)
    wsum = torch.clamp(s.add(w), min=1e-6)
    cx = s.add(w * xx) / wsum
    cy = s.add(w * yy) / wsum
    npix = s.add(segw)
    rx = xx - s.at(cx)
    ry = yy - s.at(cy)
    sxx = s.add(w * rx * rx)
    sxy = s.add(w * rx * ry)
    syy = s.add(w * ry * ry)
    ang = 0.5 * torch.atan2(2.0 * sxy, sxx - syy)
    dirx = torch.cos(ang)
    diry = torch.sin(ang)

    # orient travel so the mean gradient points left of travel (y down)
    mgx = s.add(w * torch.cos(theta).reshape(N, -1) * segw)
    mgy = s.add(w * torch.sin(theta).reshape(N, -1) * segw)
    flip = (diry * mgx - dirx * mgy) < 0.0
    dirx = torch.where(flip, -dirx, dirx)
    diry = torch.where(flip, -diry, diry)

    t_along = s.at(dirx) * rx + s.at(diry) * ry
    _, e1x, e1y = s.argmax(t_along, xx, yy)       # forward end
    _, e0x, e0y = s.argmax(-t_along, xx, yy)      # start
    length = torch.sqrt((e1x - e0x) ** 2 + (e1y - e0y) ** 2)
    seg_ok = (npix >= cfg.min_seg_pixels) & (length >= cfg.min_seg_len)

    # the K longest valid segments
    klen, kidx = _topk_stable(torch.where(seg_ok, length, -1.0), K)
    seg_ok = klen > 0
    length = torch.clamp(klen, min=0.0)

    def pick(a):
        return torch.gather(a, 1, kidx)

    cx, cy = pick(cx), pick(cy)
    p0 = torch.stack([pick(e0x), pick(e0y)], -1)               # (N, K, 2)
    p1 = torch.stack([pick(e1x), pick(e1y)], -1)
    dvec = torch.stack([pick(dirx), pick(diry)], -1)
    T = K
    eye = torch.eye(T, dtype=torch.bool, device=dev)

    # collinear merge: j extends i when i's end meets j's start with
    # matching direction, a small lateral offset and forward progress
    dd = (dvec[:, :, None, :] * dvec[:, None, :, :]).sum(-1)   # (N, T, T)
    gvec = p0[:, None, :, :] - p1[:, :, None, :]
    gap = _norm(gvec)
    lateral = torch.abs(dvec[:, :, None, 0] * gvec[..., 1]
                        - dvec[:, :, None, 1] * gvec[..., 0])
    colin = seg_ok[:, :, None] & seg_ok[:, None, :] & (dd > 0.95) & \
        (gap < cfg.collinear_join_dist) & (lateral < 3.0) & ~eye
    progress = (dvec[:, :, None, :]
                * (p1[:, None, :, :] - p1[:, :, None, :])).sum(-1)
    colin = colin & (progress > 0.0)
    # follow each segment's nearest collinear successor to the chain's end
    has_next = colin.any(2)
    nxt = torch.where(has_next,
                      torch.argmin(torch.where(colin, gap, float("inf")), 2),
                      torch.arange(T, device=dev))
    f = nxt
    for _ in range(max(1, T.bit_length())):
        f = torch.gather(f, 1, f)
    p1 = _take(p1, f)
    seg_ok = seg_ok & ~colin.any(1)
    length = _norm(p1 - p0)

    # endpoint chaining with a left turn; the gap budget grows with length
    gap2 = _norm(p0[:, None, :, :] - p1[:, :, None, :])
    join_ij = cfg.quad_join_dist + 0.35 * (length[:, :, None]
                                           + length[:, None, :])
    crossd = dvec[:, :, None, 0] * dvec[:, None, :, 1] - \
        dvec[:, :, None, 1] * dvec[:, None, :, 0]
    connect = seg_ok[:, :, None] & seg_ok[:, None, :] & (gap2 < join_ij) & \
        (crossd > 0.05) & ~eye

    # 4-cycles i -> j -> k -> l -> i with i the smallest index
    c2 = connect[:, :, :, None] & connect[:, None, :, :]
    cand = c2[..., None] & connect[:, None, None, :, :]
    cyc = cand & connect.transpose(1, 2)[:, :, None, None, :]
    ii = torch.arange(T, device=dev)
    least = (ii[:, None, None, None] < ii[None, :, None, None]) & \
        (ii[:, None, None, None] < ii[None, None, :, None]) & \
        (ii[:, None, None, None] < ii[None, None, None, :])
    cyc = cyc & least
    L = length
    score_len = (L[:, :, None, None, None] + L[:, None, :, None, None]
                 + L[:, None, None, :, None] + L[:, None, None, None, :])
    qscore = torch.where(cyc, score_len, -1.0).reshape(N, -1)
    top_s, top_i = _topk_stable(qscore, Q)
    sel_ok = top_s > 0
    i0 = top_i // (T * T * T)
    i1 = (top_i // (T * T)) % T
    i2 = (top_i // T) % T
    i3 = top_i % T

    cxy = torch.stack([cx, cy], -1)

    def corner(a, b):
        return _line_intersect(_take(cxy, a), _take(dvec, a),
                               _take(cxy, b), _take(dvec, b))

    corners = torch.stack([corner(i3, i0), corner(i0, i1), corner(i1, i2),
                           corner(i2, i3)], 2) * d             # (N, Q, 4, 2)
    center = corners.mean(2)

    finite = torch.isfinite(corners).all(-1).all(-1)
    cxs, cys = corners[..., 0], corners[..., 1]
    inb = ((cxs >= -4) & (cxs <= W0 + 4) & (cys >= -4)
           & (cys <= H0 + 4)).all(-1)
    e1 = corners[:, :, 1] - corners[:, :, 0]
    e2 = corners[:, :, 2] - corners[:, :, 0]
    area2 = torch.abs(e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0])
    sel_ok = sel_ok & finite & inb & (area2 * 0.5 >= cfg.min_area / 2)

    tag_id, hamming, dec_ok = _decode_quad(img, corners, codebook, cfg)
    valid = sel_ok & dec_ok
    return Detections(tag_id=torch.where(valid, tag_id, -1),
                      corners=corners, center=center,
                      hamming=hamming, valid=valid)


# ---------- test-support renderer ----------

def render_tag(code: torch.Tensor, corners: torch.Tensor, H: int, W: int,
               grid_dim: int = 8, bg: float = 0.9) -> torch.Tensor:
    """Render one tag (H, W): black border, payload cells (white 0.95,
    black 0.05) whose outer border corners are `corners` (4, 2), `bg`
    elsewhere, by inverse-homography lookup per pixel."""
    side = grid_dim - 2
    dev = corners.device
    Hi = torch.linalg.inv_ex(homography_from_corners(corners))[0]
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None] \
        .expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :] \
        .expand(H, W)
    p = torch.einsum("ij,jhw->ihw", Hi, torch.stack([xx, yy,
                                                     torch.ones_like(xx)]))
    u = p[0] / p[2]
    v = p[1] / p[2]
    inside = (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    cu = torch.clamp((u * grid_dim).to(torch.int64), 0, grid_dim - 1)
    cv = torch.clamp((v * grid_dim).to(torch.int64), 0, grid_dim - 1)
    border = (cu == 0) | (cv == 0) | (cu == grid_dim - 1) | \
        (cv == grid_dim - 1)
    pu = torch.clamp(cu - 1, 0, side - 1)
    pv = torch.clamp(cv - 1, 0, side - 1)
    cell = code.reshape(side, side)[pv, pu]
    color = torch.where(border, 0.05, torch.where(cell, 0.95, 0.05))
    return torch.where(inside, color, bg)
