"""Kernels K1, K2, K3, K4 and K5 against their plain PyTorch versions on a
CUDA card (the port's counterpart of tests/test_icp_fused_tpu.py). Without
a card every test skips; with one, they run chip_smoke.py's kernel phases:

    python -m pytest tests/test_torch_kernels_cuda.py -q

(The tests directory's conftest imports jax; on a machine without jax run
`python3 chip_smoke.py`, which holds the same checks.)"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    from slam_tpu_torch import cuda_build
    cuda_build.library()
    return chip_smoke


def test_k1_matches_plain(card):
    from slam_tpu_torch.config import sim2d_config
    r = card.check_k1(sim2d_config().icp)
    assert r["pose_err"] <= card.POSE_TOL and r["ok_mismatch"] == 0


def test_k4_matches_plain(card):
    """idx equal on every query and dist equal in bits: the main path's
    shapes (model strided from (B, C, 3)), the planes form with class -1
    pads, ties, special robots (a class nearly empty, empty, no model),
    unconstrained classes, model tiles."""
    r = card.check_k4()
    assert r["idx_mismatch"] == 0 and r["max_abs_err"] == 0.0
    assert set(r["cases"]) == {"main", "planes", "ties", "special",
                               "unconstrained", "tiles of 100"}
    assert card.counter("k4.launches") >= len(r["cases"])


def test_k1_matches_icp_fit_on_k4(card):
    from slam_tpu_torch import config
    assert card.kernel_guard(config) <= card.POSE_TOL


@pytest.mark.parametrize("table", ["shared", "per_robot"])
def test_k5_matches_plain(card, table):
    from slam_tpu_torch.config import PfConfig
    from slam_tpu_torch.ops import particle
    pf = card.pf_problem(B=256)
    grid = pf["shared"] if table == "shared" else pf["own"]
    for P in (128, 1):
        parts = pf["parts"][:, :P]
        got = particle.score_particles(grid, pf["scan"], pf["valid"], parts,
                                       0.5, PfConfig())
        want = particle.score_particles_reference(grid, pf["scan"],
                                                  pf["valid"], parts, 0.5)
        assert card.same_bits(got, want)
    assert card.counter("k5.launches") > 0
    assert card.counter("k5.pack_launches") > 0


def test_k5_cases_match_plain(card):
    """Strides 4 and 1 from a (B, 384, 3) scan, NaN counts, resolution 0.3,
    a 100 x 100 grid; the bit tables equal their plain version."""
    r = card.check_k5(card.pf_problem(B=256))
    assert r["mismatches"] == 0 and r["cases"] == 12


def test_call_device_ops(card):
    """One nearest_neighbor call is one launch, one score_particles call
    two (table and scores), and pf_match launches K5 three times."""
    from slam_tpu_torch.config import PfConfig
    ops = card.call_ops(card.pf_problem(B=256), PfConfig(score_stride=4))
    assert ops["nearest_neighbor"]["n"] == 1
    assert ops["score_particles"]["n"] == 2
    assert ops["pf_match"]["K5"] == 3


def test_k2_matches_plain(card):
    from slam_tpu_torch.config import sim2d_config
    from slam_tpu_torch.ops import icp_fused
    p = card.registration_problem(64, seed=4)
    args = (torch.stack([p["sx"], p["sy"]], -1), p["s_valid"], p["s_ga"],
            torch.stack([p["mx"], p["my"]], -1), p["m_valid"], p["m_ga"],
            p["init"], sim2d_config().icp)
    got = icp_fused.icp_fused(*args)
    want = icp_fused.icp_fused_reference(*args)
    assert float((got.pose - want.pose).abs().max()) <= card.POSE_TOL
    assert torch.equal(got.ok, want.ok)
    assert int((got.num_corr - want.num_corr).abs().max()) <= card.NCORR_TOL
    assert card.counter("k2.launches") > 0


def test_k3_matches_plain_and_k1(card):
    """The reference scale's shapes (full, and the main path's sparse
    occupancy in the first slots and scattered), ties across model splits,
    and K3 vs K1's plain version: pose <= POSE_TOL, ok exact, num_corr
    +-NCORR_TOL; check_k3 also holds two calls to the same bits."""
    from slam_tpu_torch.config import ref_scale_config
    r = card.check_k3(ref_scale_config().icp)
    assert set(r) == {"ref", "sparse", "scattered", "ties", "vs K1"}
    for v in r.values():
        assert v["pose_err"] <= card.POSE_TOL and v["ok_mismatch"] == 0
        assert v["dcorr"] <= card.NCORR_TOL
    assert card.counter("k3.launches") >= 10


@pytest.mark.parametrize("B,S", [(64, 384), (16, 2048)])
def test_k1_special_robots_match_plain(card, B, S):
    """Robots with the GA or the NGA class off, a robot without a scene and
    equal model points of one class with other-class points between them,
    at one and at two scene points a thread."""
    from slam_tpu_torch.config import sim2d_config
    from slam_tpu_torch.ops import icp_fused
    cfg = sim2d_config().icp
    ops = card.fused_operands(card.registration_problem(B, S, 512, seed=8,
                                                        special=True))
    r = card.agreement("K1", icp_fused.icp_fused_planes(*ops, cfg),
                       icp_fused.icp_fused_planes_reference(*ops, cfg),
                       (0, 1, 2))
    assert r["pose_err"] <= card.POSE_TOL and r["dcorr"] <= card.NCORR_TOL


@pytest.mark.parametrize("scattered", [False, True])
def test_k3_resident_branch_matches_streaming_plain(card, scattered):
    """A sparse problem in large slot arrays (K3 keeps it in one block)
    against the streaming plain version."""
    from slam_tpu_torch.config import ref_scale_config
    from slam_tpu_torch.ops import icp_fused
    cfg = ref_scale_config().icp
    ops = card.fused_operands(card.sparse_problem(8, 2048, 8192, 200, 900,
                                                  scattered, seed=5))
    r = card.agreement("K3", icp_fused.icp_fused_planes_tiled(*ops, cfg),
                       icp_fused.icp_fused_planes_tiled_reference(*ops, cfg),
                       (0, 1, 2))
    assert r["pose_err"] <= card.POSE_TOL and r["dcorr"] <= card.NCORR_TOL


def test_k2_above_the_resident_limit_runs_k3(card):
    """Packed problems of 2,048 x 2,048 points (the reference scale's
    keyframe edges): K2 sends them to K3, one launch counted as both,
    against the plain version."""
    from slam_tpu_torch.config import ref_scale_config
    r = card.check_k2_tiled(ref_scale_config().icp)
    assert r["pose_err"] <= card.POSE_TOL and r["ok_mismatch"] == 0


def test_kabsch_on_the_card_needs_no_host_sync(card):
    """ops/align's 3x3 SVD (Jacobi sweeps in tensor ops) on the card:
    rotations within 1e-4 of the f64 SVD Kabsch, 0 host syncs."""
    r = card.kabsch_on_card()
    assert r["err"] <= 1e-4 and r["syncs"] == 0


def test_fit_counters_count_each_robots_iterations(card):
    """K1 and K3 with their fit-iteration counter set and null give the
    same bits, and count each robot's own fit iterations on the kernel
    table's shapes."""
    r = card.check_fit_counters()
    assert set(r) == {"K1", "K3 full", "K3 sparse"}
    for v in r.values():
        assert v["same_bits"] and v["counted"] == v["own"] > 0
