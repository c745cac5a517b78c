"""The 3D fleet's faults on the CPU (one or two robots, with scans of 32 x
640 rays in place of the sensor's 32 x 2,170 so that a run takes a
minute or two): a sound run correct; a step that returns its state,
half the fleet left out, an answer altered, and the control, not."""

import copy

import pytest

from portbench.harness import checks, core

NAME = "hdl32e.fused.b64"
SMALL = dict(warmup_macros=1, check_before=1, check_macros=1)
RAYS = dict(sim=dict(num_azimuth=640),
            cloud=dict(scan_capacity=20480, ground_capacity=20480,
                       min_scan_points=5856))


def cell(robots=1):
    c = core.Cell(NAME)
    c.traffic = dict(c.traffic, **SMALL, robots=robots)
    c.config = copy.deepcopy(c.config)
    for group, values in RAYS.items():
        c.config["config"][group].update(values)
    return c


def run(robots=1):
    return core.run_cell(cell(robots), 2 ** 36 + 1, 0.1, False, "cpu")


def test_sound_run_is_correct():
    assert run()["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(monkeypatch, fault):
    from portbench.tests.test_portbench_faults import mix
    from slam_tpu_torch.pipeline import slam3d
    orig = slam3d.slam_step_3d

    def broken(s, world, gm, *a, **k):
        if fault == "unchanged":
            return s, gm
        out, g = orig(s, world, gm, *a, **k)
        if fault == "half":
            k2 = s.pose.shape[0] // 2
            return mix(out, s, k2), mix(g, gm, k2)
        pose = out.pose.clone()
        pose[0, 3] += 0.05
        return out.replace(pose=pose), g
    monkeypatch.setattr(slam3d, "slam_step_3d", broken)
    assert run(2 if fault == "half" else 1)["correct"] is False


def test_control_fails():
    c = cell()
    ctx = core.Context(c, 2 ** 33 + 13, 0.1, False, "cpu", 0.0)
    numbers = c.driver().control(ctx, 1)
    assert checks.judge(numbers, c.limits)["correct"] is False
