"""Ground segmentation's GP sector kernel (slam_tpu_torch/csrc/ground_gp.cu)
against its plain version (ops/ground.py `gp_sectors_reference`) on a CUDA
card. Without a card every test skips (the kernel has no CPU mode; its
block's algorithm is emulated on the CPU in
tests/test_torch_ground_gp_emulation.py); with one, they run chip_smoke.py's
[ground] checks:

    python -m pytest tests/test_torch_ground_gp_cuda.py -q

(The tests directory's conftest imports jax; on a machine without jax run
`python3 chip_smoke.py`, which holds the same checks.)"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import chip_smoke
    from slam_tpu_torch import cuda_build
    cuda_build.library()
    return chip_smoke


@pytest.mark.parametrize("case", ["hdl32e", "sim3d"])
def test_ground_gp_matches_plain_on_scans(card, case):
    """B = 8 HDL-32E scans (72 x 200 bins, C = 64) and B = 16 sim3d scans
    (16 x 32, C = 32): no slot or bin differs off a near-tie of an inlier
    gate, f_s within GP_F_TOL, one counted launch a call, the kernel's
    counted sweeps those the plain version needs."""
    from slam_tpu_torch.config import ref_scale_config, sim3d_config
    if case == "hdl32e":
        sim, gcfg, B = card.hdl32e_sim(), ref_scale_config().ground, 8
    else:
        sim, gcfg, B = sim3d_config().sim, sim3d_config().ground, 16
    xyz, valid = card.ground_scans(sim, B, 60)
    a = card.gp_agreement(card.ground_operands(xyz, valid, gcfg), gcfg)
    assert card.gp_ok(a), {k: v for k, v in a.items() if k != "plain"}
    assert a["launches"] == 1


@pytest.mark.parametrize("C", [32, 64, 128])
def test_ground_gp_matches_plain_on_ramps(card, C):
    """Ramp clouds whose sectors adopt over several sweeps, at sim3d's grid
    (C = 32) and the reference grid (C = 64 and the kernel's widest, 128)."""
    from slam_tpu_torch.config import ref_scale_config, sim3d_config
    base = (sim3d_config() if C == 32 else ref_scale_config()).ground
    gcfg = dataclasses.replace(base, signal_capacity=C)
    xyz, valid = card.ramp_scans(gcfg, 4, 70 + C)
    a = card.gp_agreement(card.ground_operands(xyz, valid, gcfg), gcfg)
    assert card.gp_ok(a), {k: v for k, v in a.items() if k != "plain"}
    assert a["sweeps_max"] >= 3


def test_ground_gp_refuses_wide_signal(card):
    """A signal wider than the block holds raises before any launch."""
    from slam_tpu_torch.config import ref_scale_config
    from slam_tpu_torch.ops import ground
    gcfg = dataclasses.replace(ref_scale_config().ground,
                               signal_capacity=ground.GP_MAX_SLOTS + 1)
    xyz, valid = card.ramp_scans(gcfg, 1, 9)
    before = card.counter("ground.launches")
    with pytest.raises(ValueError, match="signal slots"):
        card.ground_operands(xyz, valid, gcfg)
    assert card.counter("ground.launches") == before
