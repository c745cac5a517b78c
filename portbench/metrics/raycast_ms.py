"""raycast_ms: the simulator's raycast (sim/world2d.py, sim/world3d.py
raycast), kernel ms a tick."""

from portbench.harness.layers import stage_ms

STAGES = {"raycast_ms": [
    "slam_tpu_torch.sim.world2d:raycast",
    "slam_tpu_torch.sim.world3d:raycast",
]}


def read(data):
    return stage_ms(data, "raycast_ms")
