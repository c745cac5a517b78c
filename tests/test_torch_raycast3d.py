"""The 3D raycast kernel (slam_tpu_torch/csrc/raycast3d.cu, behind
world3d.raycast on the card) against its plain version, raycast_reference,
on a CUDA card. Without a card every test skips; with one they run
chip_smoke.py's [raycast3d] checks:

    python -m pytest tests/test_torch_raycast3d.py -q

(The tests directory's conftest imports jax; on a machine without jax run
`python3 chip_smoke.py`, whose [raycast3d] phase holds the same checks.)

Hit flags equal on every ray but grazing ones (a march sample's height
margin within 1e-5 m of 0, or the discriminant of a circle whose wall the
ray meets within its height within 1e-5 of 0), which are at most 1e-4 of
the rays; points within 1e-4 m elsewhere; one counted launch a call."""

import pytest
import torch

pytestmark = pytest.mark.cuda

SHAPES = {"hdl32e": 8, "sim3d": 128}     # robots of each scan's case


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the raycast kernel has no CPU mode")
    import chip_smoke
    from slam_tpu_torch import cuda_build
    cuda_build.library()
    return chip_smoke


@pytest.mark.parametrize("noise", [True, False], ids=["noise", "exact"])
@pytest.mark.parametrize("tilt", [True, False], ids=["tilted", "level"])
@pytest.mark.parametrize("scan", sorted(SHAPES))
def test_raycast3d_matches_plain(card, scan, tilt, noise):
    """The HDL-32E's 69,440-ray scan on 8 robots and sim3d_config's 2,048
    on 128, with and without the terrain's tilt and range noise."""
    from slam_tpu_torch.config import sim3d_config
    sim = card.hdl32e_sim() if scan == "hdl32e" else sim3d_config().sim
    r = card.check_raycast3d(sim, SHAPES[scan], 40, tilt, noise)
    assert r["hit_mismatch"] == 0, r
    assert r["grazing"] <= card.GRAZE_SHARE * r["rays"], r
    assert r["range_err"] <= card.RANGE_TOL and r["finite"], r
    assert r["launches"] == 1, r
