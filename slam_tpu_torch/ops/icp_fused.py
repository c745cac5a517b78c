"""Fused class-constrained ICP — counterpart of slam_tpu/ops/icp_pallas.py,
with kernels K1 (`csrc/icp_fused.cu`, replacing `_icp_kernel_planes` ->
`_icp_core`) and K3 (`csrc/icp_tiled.cu`, replacing `_icp_kernel_tiled`).

One call runs the whole fit loop for every robot. Nearest points are
averaged over ties (`d2 <= rowmin`), unlike icp_fit's first hit; both keep
their own rule. `icp_fused_planes` launches K1 for CUDA tensors and runs
`icp_fused_planes_reference`, the plain PyTorch version, for CPU tensors.
K1 holds a robot's scene and model in one block's shared memory, so it
takes problems up to RESIDENT_TILE_LIMIT scene x model points;
`icp_fused_planes_tiled` (K3, plain version `icp_fused_planes_tiled_
reference`) takes any size. `fused_register` picks between them by that
limit, as slam_tpu does.

Both kernels first group a robot's points by class, stably
(`group_by_class` is that step in plain PyTorch): a scene point then walks
only its own class's model points, its minimum starting at inlier_dist.
K3 keeps a robot whose grouped points are few in one block and cuts the
others' model segments into splits of K3_SPLIT_LEN points that separate
blocks take, merged per scene point in split order;
`_grouped_split_slab` is that algorithm in plain PyTorch, which the tests
hold equal to the plain versions.

`icp_fused` is K2's counterpart (`_icp_kernel`, behind `make_icp_fused` and
`_icp_batched`): the same `_icp_core` on packed (N, 2) points with valid
and GA masks, which the TPU packed only to save a relayout. Here it splits
the columns, encodes the classes as `_pack3` does and launches K1's kernel
on the planes; `icp_fused_reference` is the same adapter on K1's plain
version. slam_tpu's K2 takes any size; K1 holds at most
RESIDENT_TILE_LIMIT scene x model points, so packed problems above it go
to K3 (and to K3's plain version), the route by size fused_register
takes (the reference scale's 2,048-point keyframe edges).
"""

from __future__ import annotations

import torch

from slam_tpu_torch import cuda_build
from slam_tpu_torch.ops.icp import IcpResult
from slam_tpu_torch.utils import profiling

BIG = 1e30

# scene x model points above which fused_register takes the streaming
# kernel K3 instead of the resident K1 (slam_tpu's rule and limit)
RESIDENT_TILE_LIMIT = 2 << 20

# model points per block of the tiled plain version (slam_tpu's c_blk cap)
TILE_C = 2048

# K3's scratch (csrc/icp_tiled.cu's kState and kPlan): floats of per-robot
# state and ints of per-robot plan; and kSplit, the model points of one
# class that one match block walks (the kernel cuts a class's segment into
# ceil(points / K3_SPLIT_LEN) even splits). k3_scratch_shapes sizes by them.
_K3_STATE = 8
_K3_PLAN = 12
K3_SPLIT_LEN = 2048

# K1 stages S + C packed (x, y) points in dynamic shared memory; 4 KB stay
# for its static part (warp counts, reduction slots, the carry)
_MAX_SMEM = cuda_build.MAX_SMEM - 4096


def encode_scene_class(valid, ga):
    """Scene class plane: -1 pad/invalid, 0 NGA, 1 GA (f32)."""
    return torch.where(valid, ga.to(torch.float32), -1.0)


def encode_model_class(valid, ga):
    """Model class plane: 0 NGA, 1 GA, 2 invalid (f32)."""
    return torch.where(valid, ga.to(torch.float32), 2.0)


def _pack_init4(init):
    """(B, 3) [x, y, yaw] -> (B, 4) [x, y, cos, sin]."""
    return torch.stack([init[:, 0], init[:, 1], torch.cos(init[:, 2]),
                        torch.sin(init[:, 2])], -1).contiguous()


def _decode(out) -> IcpResult:
    """(B, 8) [tx, ty, cos, sin, ok, num_corr, mean_res, delta] slab."""
    pose = torch.stack([out[:, 0], out[:, 1],
                        torch.atan2(out[:, 3], out[:, 2])], -1)
    return IcpResult(pose=pose, ok=(out[:, 4] > 0.5) & (out[:, 5] > 0),
                     num_corr=out[:, 5].to(torch.int32), delta=out[:, 7],
                     mean_residual=out[:, 6])


def _fit_loop(sc, mc, init4, cfg, moments):
    """_icp_core's fit loop in plain PyTorch around `moments(tx, ty, cth,
    sth, ga_on, nga_on)`, which returns the ten Kabsch moment sums (W,
    sum qx, sum qy, sum ux, sum uy, sum qx ux, sum qx uy, sum qy ux,
    sum qy uy, sum w rowmin), each (B,). Returns the (B, 8) slab and the
    number of fit iterations each robot ran."""
    m_ga = (mc == 1.0).to(torch.float32).sum(-1)
    m_nga = (mc == 0.0).to(torch.float32).sum(-1)
    n_scene = (sc >= 0.0).to(torch.float32).sum(-1)
    ok = (n_scene >= cfg.min_scene_points) & (m_ga + m_nga >= 5.0)
    ga_on, nga_on = m_ga > 3.0, m_nga > 3.0

    tx, ty, cth, sth = (init4[:, k].clone() for k in range(4))
    converged = ~ok
    ncorr = torch.zeros_like(tx)
    mres = torch.zeros_like(tx)
    delta = torch.full_like(tx, float("inf"))
    iters = torch.zeros_like(tx)
    for _ in range(cfg.max_iterations):
        if bool(converged.all()):
            break
        (W, Swqx, Swqy, Sux, Suy, A00, A01, A10, A11, Sres) = moments(
            tx, ty, cth, sth, ga_on, nga_on)
        Ws = torch.clamp(W, min=1e-12)
        mqx = Swqx / Ws
        mqy = Swqy / Ws
        mmx = Sux / Ws
        mmy = Suy / Ws
        H00 = A00 - W * mqx * mmx
        H01 = A01 - W * mqx * mmy
        H10 = A10 - W * mqy * mmx
        H11 = A11 - W * mqy * mmy
        a = H00 + H11
        b = H01 - H10
        rn = torch.rsqrt(torch.clamp(a * a + b * b, min=1e-24))
        c_ = a * rn
        s_ = b * rn
        t_x = mmx - (c_ * mqx - s_ * mqy)
        t_y = mmy - (s_ * mqx + c_ * mqy)

        ntx = c_ * tx - s_ * ty + t_x
        nty = s_ * tx + c_ * ty + t_y
        ncth = c_ * cth - s_ * sth
        nsth = s_ * cth + c_ * sth
        rnorm = torch.rsqrt(torch.clamp(ncth * ncth + nsth * nsth, min=1e-24))
        ncth = ncth * rnorm
        nsth = nsth * rnorm
        frob = torch.sqrt(torch.clamp(4.0 - 4.0 * c_, min=0.0))
        d = torch.maximum(frob, torch.sqrt(t_x * t_x + t_y * t_y))
        has_corr = W > 0.0
        d = torch.where(has_corr, d, -1.0)

        upd = ~converged
        iters = iters + upd.to(torch.float32)
        go = upd & has_corr
        tx = torch.where(go, ntx, tx)
        ty = torch.where(go, nty, ty)
        cth = torch.where(go, ncth, cth)
        sth = torch.where(go, nsth, sth)
        ncorr = torch.where(upd, W, ncorr)
        mres = torch.where(upd, Sres / Ws, mres)
        delta = torch.where(upd, d, delta)
        converged = converged | (d < cfg.min_delta)

    pose = [torch.where(ok, v, init4[:, k])
            for k, v in enumerate((tx, ty, cth, sth))]
    return torch.stack(pose + [ok.to(torch.float32), ncorr, mres, delta],
                       -1), iters


def _transform(sx, sy, tx, ty, cth, sth):
    """Scene planes (B, S, 1) under the carried poses (B,)."""
    def col(v):
        return v[:, None, None]
    return (col(cth) * sx - col(sth) * sy + col(tx),
            col(sth) * sx + col(cth) * sy + col(ty))


def _participation(sc, ga_on, nga_on):
    """(B, S, 1) f32: valid scene points whose class the model holds > 3
    points of."""
    class_on = torch.where(sc == 1.0, ga_on[:, None, None],
                           nga_on[:, None, None])
    return ((sc >= 0.0) & class_on).to(torch.float32)


def _moment_terms(w, qx, qy, ux, uy, rowmin):
    """Each scene point's share of the ten Kabsch moments."""
    return (w, w * qx, w * qy, ux, uy, qx * ux, qx * uy, qy * ux, qy * uy,
            w * rowmin)


def _moment_sums(w, qx, qy, ux, uy, rowmin):
    return tuple(v.sum((1, 2)) for v in _moment_terms(w, qx, qy, ux, uy,
                                                      rowmin))


def _reference_slab(sx, sy, sc, mx, my, mc, init4, cfg):
    """_icp_core in plain PyTorch over an explicit (B, S, C) tile. Returns
    the (B, 8) slab and the number of fit iterations each robot ran."""
    sx, sy, sc3 = sx[:, :, None], sy[:, :, None], sc[:, :, None]
    mx3, my3, mc3 = mx[:, None, :], my[:, None, :], mc[:, None, :]
    pair_ok = (sc3 == mc3).to(torch.float32) * (mc3 < 2.0).to(torch.float32)
    penalty = (1.0 - pair_ok) * BIG                               # (B, S, C)

    def moments(tx, ty, cth, sth, ga_on, nga_on):
        qx, qy = _transform(sx, sy, tx, ty, cth, sth)             # (B, S, 1)
        dx = qx - mx3
        dy = qy - my3
        d2 = dx * dx + dy * dy + penalty
        rowmin = d2.amin(-1, keepdim=True)
        w = _participation(sc3, ga_on, nga_on) * \
            (rowmin < cfg.inlier_dist).to(torch.float32)
        sel = (d2 <= rowmin).to(torch.float32) * w
        inv_nt = 1.0 / torch.clamp(sel.sum(-1, keepdim=True), min=1.0)
        ux = (sel * mx3).sum(-1, keepdim=True) * inv_nt
        uy = (sel * my3).sum(-1, keepdim=True) * inv_nt
        return _moment_sums(w, qx, qy, ux, uy, rowmin)

    return _fit_loop(sc, mc, init4, cfg, moments)


def _tiled_reference_slab(sx, sy, sc, mx, my, mc, init4, cfg,
                          c_blk=TILE_C):
    """_icp_kernel_tiled in plain PyTorch: each fit iteration streams the
    model through blocks of c_blk points, penalises other-class pairs by
    BIG (sc - mc)^2 and merges each block's (row minimum, tie sums, tie
    count) into running ones: a strictly smaller minimum replaces them, an
    equal one adds. Memory is O(B S c_blk), never (B, S, C). Returns the
    (B, 8) slab and the fit iterations each robot ran."""
    sx, sy, sc3 = sx[:, :, None], sy[:, :, None], sc[:, :, None]
    C = mx.shape[-1]

    def moments(tx, ty, cth, sth, ga_on, nga_on):
        qx, qy = _transform(sx, sy, tx, ty, cth, sth)             # (B, S, 1)
        rowmin = torch.full_like(qx, BIG)
        sxa = torch.zeros_like(qx)
        sya = torch.zeros_like(qx)
        nt = torch.zeros_like(qx)
        for c0 in range(0, C, c_blk):
            mxc = mx[:, None, c0:c0 + c_blk]
            myc = my[:, None, c0:c0 + c_blk]
            pc = sc3 - mc[:, None, c0:c0 + c_blk]
            dx = qx - mxc
            dy = qy - myc
            d2 = dx * dx + dy * dy + BIG * (pc * pc)
            m = d2.amin(-1, keepdim=True)
            sel = (d2 <= m).to(torch.float32)
            sxc = (sel * mxc).sum(-1, keepdim=True)
            syc = (sel * myc).sum(-1, keepdim=True)
            nc = sel.sum(-1, keepdim=True)
            better = m < rowmin
            equal = (m == rowmin).to(torch.float32)
            sxa = torch.where(better, sxc, sxa + equal * sxc)
            sya = torch.where(better, syc, sya + equal * syc)
            nt = torch.where(better, nc, nt + equal * nc)
            rowmin = torch.minimum(rowmin, m)
        w = _participation(sc3, ga_on, nga_on) * \
            (rowmin < cfg.inlier_dist).to(torch.float32)
        inv_nt = 1.0 / torch.clamp(nt, min=1.0)
        return _moment_sums(w, qx, qy, w * sxa * inv_nt, w * sya * inv_nt,
                            rowmin)

    return _fit_loop(sc, mc, init4, cfg, moments)


def group_by_class(x, y, cls):
    """Stable grouping of (B, N) planes by class, the kernels' first step in
    plain PyTorch: each robot's class-1 points first, then its class-0
    points, then the rest, each group in the input's order. Returns the
    permuted (x, y, cls) and the (B,) counts of class 1 and class 0."""
    one, zero = cls == 1.0, cls == 0.0
    key = torch.where(one, 0, torch.where(zero, 1, 2))
    order = torch.sort(key, dim=-1, stable=True).indices
    return (torch.gather(x, -1, order), torch.gather(y, -1, order),
            torch.gather(cls, -1, order), one.sum(-1), zero.sum(-1))


def split_bounds(n, split_len):
    """The kernels' even cut of n points into ceil(n / split_len) splits:
    [(begin, end), ...]."""
    k = -(-n // split_len)
    return [(s * n // k, (s + 1) * n // k) for s in range(k)]


def _grouped_split_slab(sx, sy, sc, mx, my, mc, init4, cfg, split_len):
    """The kernels' algorithm in plain PyTorch, robot by robot: group scene
    and model by class; a scene point of a class that is on walks only that
    class's model segment, split by split, its (minimum, tie sums, tie
    count) starting at (inlier_dist, 0, 0, 0); the splits' results merge in
    split order: a strictly smaller minimum replaces, an equal one adds.
    Returns the (B, 8) slab and the fit iterations each robot ran."""
    gsx, gsy, _, n1, n0 = group_by_class(sx, sy, sc)
    gmx, gmy, _, m1, m0 = group_by_class(mx, my, mc)
    B = sx.shape[0]
    n1, n0, m1, m0 = (v.tolist() for v in (n1, n0, m1, m0))
    inlier = cfg.inlier_dist

    def moments(tx, ty, cth, sth, ga_on, nga_on):
        out = sx.new_zeros((10, B))
        for b in range(B):
            for on, r0, nr, c0, nm in (
                    (ga_on[b], 0, n1[b], 0, m1[b]),
                    (nga_on[b], n1[b], n0[b], m1[b], m0[b])):
                if not bool(on) or nr == 0:
                    continue
                px, py = gsx[b, r0:r0 + nr, None], gsy[b, r0:r0 + nr, None]
                qx = cth[b] * px - sth[b] * py + tx[b]
                qy = sth[b] * px + cth[b] * py + ty[b]
                rowmin = torch.full_like(qx, inlier)
                sxa = torch.zeros_like(qx)
                sya = torch.zeros_like(qx)
                nt = torch.zeros_like(qx)
                for a, e in split_bounds(nm, split_len):
                    mxc = gmx[b, None, c0 + a:c0 + e]
                    myc = gmy[b, None, c0 + a:c0 + e]
                    dx = qx - mxc
                    dy = qy - myc
                    d2 = dx * dx + dy * dy
                    m = d2.amin(-1, keepdim=True).clamp(max=inlier)
                    sel = (d2 <= m).to(torch.float32)
                    sxc = (sel * mxc).sum(-1, keepdim=True)
                    syc = (sel * myc).sum(-1, keepdim=True)
                    nc = sel.sum(-1, keepdim=True)
                    better = m < rowmin
                    equal = (m == rowmin).to(torch.float32)
                    sxa = torch.where(better, sxc, sxa + equal * sxc)
                    sya = torch.where(better, syc, sya + equal * syc)
                    nt = torch.where(better, nc, nt + equal * nc)
                    rowmin = torch.minimum(rowmin, m)
                w = (rowmin < inlier).to(torch.float32)
                inv_nt = 1.0 / torch.clamp(nt, min=1.0)
                out[:, b] += torch.stack([v.sum() for v in _moment_terms(
                    w, qx, qy, w * sxa * inv_nt, w * sya * inv_nt, rowmin)])
        return tuple(out)

    return _fit_loop(sc, mc, init4, cfg, moments)


def k1_shared_bytes(S, C):
    """Dynamic shared memory of one K1 block: S + C packed (x, y) points."""
    return 8 * (S + C)


def k3_scratch_shapes(B, S, C):
    """Shapes of K3's scratch: per-robot state (f32) and plan (i32), the
    grouped model and scene points (f32 pairs), and every scene point's
    (minimum, tie sums, tie count) for each of the most splits one class's
    model segment can have (f32)."""
    return {"state": (B, _K3_STATE), "plan": (B, _K3_PLAN),
            "grouped": (B, S + C, 2),
            "partial": (B, -(-C // K3_SPLIT_LEN), S, 4)}


def _fit_counter(kernel: str, B: int, dev):
    """The address K1 / K3 add their robots' fit iterations to (the device
    counter `<kernel>.fit_iterations`, `<kernel>.fit_problems` counting
    the B robots) while a profiler records; None otherwise."""
    return profiling.recorded_counter(f"{kernel}.fit_iterations",
                                      f"{kernel}.fit_problems", B, dev)


def _kernel_slab(sx, sy, sc, mx, my, mc, init4, cfg, packed):
    """Launch K1; `packed` counts the launch as K2's (icp_fused), whose
    fit iterations are not counted. Launches count in the registry
    (utils/profiling.py) as `k1.launches` / `k2.launches`: the card path
    only."""
    dev = sx.device
    B, S = sx.shape
    C = mx.shape[1]
    cuda_build.check_operands("K1", (sx, sy, sc, mx, my, mc, init4),
                              [(B, S)] * 3 + [(B, C)] * 3 + [(B, 4)])
    if k1_shared_bytes(S, C) > _MAX_SMEM:
        raise ValueError(f"K1 holds S + C packed points in shared memory: "
                         f"S={S}, C={C} exceeds {_MAX_SMEM} bytes")
    out = torch.empty((B, 8), dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    err = lib.slam_icp_fused_planes(
        sx.data_ptr(), sy.data_ptr(), sc.data_ptr(), mx.data_ptr(),
        my.data_ptr(), mc.data_ptr(), init4.data_ptr(), out.data_ptr(),
        None if packed else _fit_counter("k1", B, dev),
        B, S, C, cfg.max_iterations, cfg.inlier_dist, cfg.min_delta,
        cfg.min_scene_points, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "slam_icp_fused_planes")
    profiling.count("k2.launches" if packed else "k1.launches")
    return out


def _check_resident(S, C):
    if S * C > RESIDENT_TILE_LIMIT:
        raise ValueError(
            f"S*C = {S * C} exceeds RESIDENT_TILE_LIMIT "
            f"({RESIDENT_TILE_LIMIT}): use icp_fused_planes_tiled (K3), "
            "which fused_register takes above the limit")


def icp_fused_planes_reference(sx, sy, sc, mx, my, mc, init, cfg) -> IcpResult:
    """Plain PyTorch version of K1, on any device. Planes (B, S) / (B, C)
    f32 with classes from encode_{scene,model}_class; init (B, 3)."""
    _check_resident(sx.shape[-1], mx.shape[-1])
    return _decode(_reference_slab(sx, sy, sc, mx, my, mc, _pack_init4(init),
                                   cfg)[0])


def fit_iterations(sx, sy, sc, mx, my, mc, init, cfg) -> torch.Tensor:
    """(B,) fit iterations each robot runs (the plain version's count; the
    kernels converge on the same ones): what the kernels' work depends on.
    Streams the model as K3's plain version does, so it takes any size."""
    return _tiled_reference_slab(sx, sy, sc, mx, my, mc, _pack_init4(init),
                                 cfg)[1]


def _slab(sx, sy, sc, mx, my, mc, init, cfg, packed=False):
    """The (B, 8) slab: the kernel for CUDA tensors, the plain version for
    CPU tensors. K1 (`packed` False) takes problems up to
    RESIDENT_TILE_LIMIT; K2 (`packed`) sends larger ones to K3, which
    counts as a launch of both."""
    tiled = sx.shape[-1] * mx.shape[-1] > RESIDENT_TILE_LIMIT
    if not packed:
        _check_resident(sx.shape[-1], mx.shape[-1])
    init4 = _pack_init4(init)
    dev = sx.device
    if dev.type == "cpu":
        slab = _tiled_reference_slab if tiled else _reference_slab
        return slab(sx, sy, sc, mx, my, mc, init4, cfg)[0]
    if dev.type != "cuda":
        raise ValueError(f"fused ICP: unsupported device {dev}")
    if not tiled:
        return _kernel_slab(sx, sy, sc, mx, my, mc, init4, cfg, packed)
    out = _tiled_kernel_slab(sx, sy, sc, mx, my, mc, init4, cfg)
    profiling.count("k2.launches")
    return out


def icp_fused_planes(sx, sy, sc, mx, my, mc, init, cfg) -> IcpResult:
    """Fused ICP over a robot batch: K1 for CUDA tensors, its plain version
    for CPU tensors. Same contract as icp_fused_planes_reference."""
    return _decode(_slab(sx, sy, sc, mx, my, mc, init, cfg))


def icp_fused_planes_tiled_reference(sx, sy, sc, mx, my, mc, init,
                                     cfg) -> IcpResult:
    """Plain PyTorch version of K3, on any device; same contract as
    icp_fused_planes_reference, any S and C."""
    return _decode(_tiled_reference_slab(sx, sy, sc, mx, my, mc,
                                         _pack_init4(init), cfg)[0])


def _tiled_kernel_slab(sx, sy, sc, mx, my, mc, init4, cfg):
    """Launch K3: one call queues its set-up kernel and max_iterations
    match kernels on the current stream, no host sync; it counts as one
    `k3.launches`."""
    dev = sx.device
    B, S = sx.shape
    C = mx.shape[1]
    cuda_build.check_operands("K3", (sx, sy, sc, mx, my, mc, init4),
                              [(B, S)] * 3 + [(B, C)] * 3 + [(B, 4)])
    if B > 65535:
        raise ValueError(f"K3 takes one grid row a robot: B={B} exceeds "
                         "65535")
    out = torch.empty((B, 8), dtype=torch.float32, device=dev)
    scratch = {k: torch.empty(shape, device=dev, dtype=torch.int32
                              if k == "plan" else torch.float32)
               for k, shape in k3_scratch_shapes(B, S, C).items()}
    err = cuda_build.library().slam_icp_tiled_planes(
        sx.data_ptr(), sy.data_ptr(), sc.data_ptr(), mx.data_ptr(),
        my.data_ptr(), mc.data_ptr(), init4.data_ptr(), out.data_ptr(),
        scratch["state"].data_ptr(), scratch["plan"].data_ptr(),
        scratch["grouped"].data_ptr(), scratch["partial"].data_ptr(),
        _fit_counter("k3", B, dev),
        B, S, C, cfg.max_iterations, cfg.inlier_dist, cfg.min_delta,
        cfg.min_scene_points, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "slam_icp_tiled_planes")
    profiling.count("k3.launches")
    return out


def icp_fused_planes_tiled(sx, sy, sc, mx, my, mc, init, cfg) -> IcpResult:
    """Fused ICP of any size: K3 for CUDA tensors, its plain version for
    CPU tensors. Same contract as icp_fused_planes_reference."""
    init4 = _pack_init4(init)
    dev = sx.device
    if dev.type == "cpu":
        return _decode(_tiled_reference_slab(sx, sy, sc, mx, my, mc, init4,
                                             cfg)[0])
    if dev.type == "cuda":
        return _decode(_tiled_kernel_slab(sx, sy, sc, mx, my, mc, init4,
                                          cfg))
    raise ValueError(f"fused ICP: unsupported device {dev}")


def packed_planes(scene_xy, scene_valid, scene_ga, model_xy, model_valid,
                  model_ga):
    """Packed points and masks -> the six K1 planes, classes encoded as
    `_pack3` encodes them (scene -1 pad; model 2 invalid)."""
    return (scene_xy[..., 0].contiguous(), scene_xy[..., 1].contiguous(),
            encode_scene_class(scene_valid, scene_ga).contiguous(),
            model_xy[..., 0].contiguous(), model_xy[..., 1].contiguous(),
            encode_model_class(model_valid, model_ga).contiguous())


def icp_fused_reference(scene_xy, scene_valid, scene_ga, model_xy,
                        model_valid, model_ga, init, cfg) -> IcpResult:
    """Plain PyTorch version of K2, on any device: K1's plain version
    behind the packed adapter, K3's above RESIDENT_TILE_LIMIT."""
    fit = (icp_fused_planes_tiled_reference
           if scene_xy.shape[-2] * model_xy.shape[-2] > RESIDENT_TILE_LIMIT
           else icp_fused_planes_reference)
    return fit(*packed_planes(scene_xy, scene_valid, scene_ga, model_xy,
                              model_valid, model_ga), init, cfg)


def icp_fused(scene_xy, scene_valid, scene_ga, model_xy, model_valid,
              model_ga, init, cfg) -> IcpResult:
    """K2: fused ICP on packed points. scene_xy (B, S, 2), model_xy
    (B, C, 2), masks (B, S) / (B, C) bool, init (B, 3). Launches K1's kernel
    for CUDA tensors (K3 above RESIDENT_TILE_LIMIT scene x model points),
    its plain version for CPU tensors."""
    return _decode(_slab(*packed_planes(scene_xy, scene_valid, scene_ga,
                                        model_xy, model_valid, model_ga),
                         init, cfg, packed=True))


def fused_register(sx, sy, s_valid, s_ga, target_planes, map_cloud, pred,
                   cfg) -> IcpResult:
    """Fused scan-to-map registration: take the target planes (or the map
    cloud's columns), mask the +-crop_dist box around the prediction and
    run the fused fit: K1 up to RESIDENT_TILE_LIMIT scene x model points,
    K3 above it. pred: (B, 3)."""
    if target_planes is None:
        mpx = map_cloud.xyz[..., 0]
        mpy = map_cloud.xyz[..., 1]
        mga = map_cloud.is_ga()
        mvalid = map_cloud.valid
    else:
        mpx, mpy, mga, mvalid = target_planes
    d = cfg.crop_dist
    inb = mvalid & ((mpx - pred[:, :1]).abs() <= d) & \
        ((mpy - pred[:, 1:2]).abs() <= d)
    fit = (icp_fused_planes_tiled
           if sx.shape[-1] * mpx.shape[-1] > RESIDENT_TILE_LIMIT
           else icp_fused_planes)
    return fit(sx.contiguous(), sy.contiguous(),
               encode_scene_class(s_valid, s_ga).contiguous(),
               mpx.contiguous(), mpy.contiguous(),
               encode_model_class(inb, mga).contiguous(), pred, cfg)
