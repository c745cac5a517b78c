"""A run with the timed path broken underneath comes out not correct: the
harness driven on the CPU at a few robots (without its look for a card),
once for each fault a cell can have, and the control (the reference in
TF32 in the program's place) fails the limits too. A sound run passes."""

import dataclasses

import pytest
import torch

from portbench.harness import core

FLEET = dict(robots=4, check_before=3)


def fleet_cell():
    cell = core.Cell("sim2d.fused.b4096")
    cell.traffic = dict(cell.traffic, **FLEET)
    return cell


def live_cell():
    return core.Cell("sim2d.live.10hz")


def run(cell, seconds=0.5):
    return core.run_cell(cell, 2 ** 35 + 11, seconds, False, "cpu")


def mix(new, old, k):
    """new's robots < k, old's from k: every batched tensor of a state."""
    if isinstance(new, torch.Tensor):
        return torch.cat([new[:k], old[k:]]) if new.dim() and \
            new.shape[0] == old.shape[0] else new
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: mix(getattr(new, f.name), getattr(old, f.name), k)
            for f in dataclasses.fields(new)
            if isinstance(getattr(new, f.name), torch.Tensor)
            or dataclasses.is_dataclass(getattr(new, f.name))})
    return new


def test_sound_fleet_run_is_correct():
    r = run(fleet_cell())
    assert r["correct"] is True and r["failed"] == 0


def test_sound_live_run_is_correct():
    assert run(live_cell(), 1.5)["correct"] is True


def test_fleet_step_returning_its_state(monkeypatch):
    from slam_tpu_torch.pipeline import slam2d
    monkeypatch.setattr(slam2d, "slam_step",
                        lambda s, *a, **k: s)
    assert run(fleet_cell())["correct"] is False


def test_fleet_half_the_batch_left_out(monkeypatch):
    from slam_tpu_torch.pipeline import slam2d
    orig = slam2d.slam_step

    def half(s, *a, **k):
        return mix(orig(s, *a, **k), s, s.pose.shape[0] // 2)
    monkeypatch.setattr(slam2d, "slam_step", half)
    assert run(fleet_cell())["correct"] is False


def test_fleet_answer_altered(monkeypatch):
    from slam_tpu_torch.pipeline import slam2d
    orig = slam2d.slam_step

    def altered(s, *a, **k):
        out = orig(s, *a, **k)
        pose = out.pose.clone()
        pose[0, 0] += 0.05
        return out.replace(pose=pose)
    monkeypatch.setattr(slam2d, "slam_step", altered)
    assert run(fleet_cell())["correct"] is False


def test_live_step_returning_its_carry(monkeypatch):
    from slam_tpu_torch import live
    monkeypatch.setattr(live, "consume", lambda carry, r, g, c, cfg: (
        carry, live.ekf_mod.pose_xyyaw(carry[0])))
    assert run(live_cell(), 1.5)["correct"] is False


def test_live_answer_altered(monkeypatch):
    from slam_tpu_torch import live
    orig = live.consume

    def altered(*a, **k):
        carry, fused = orig(*a, **k)
        return carry, fused + torch.tensor([[0.05, 0.0, 0.0]])
    monkeypatch.setattr(live, "consume", altered)
    assert run(live_cell(), 1.5)["correct"] is False


@pytest.mark.parametrize("name,length", [("sim2d.fused.b4096", 2),
                                         ("sim2d.live.10hz", 30)])
def test_control_fails(name, length):
    """The control's readings (portbench/calibrate.py runs it on the card
    at the cell's size) exceed the cell's limits at a CPU size too."""
    cell = fleet_cell() if name.startswith("sim2d.fused") else live_cell()
    ctx = core.Context(cell, 2 ** 33 + 5, 1.0, False, "cpu", 0.0)
    numbers = cell.driver().control(ctx, length)
    from portbench.harness import checks
    assert checks.judge(numbers, {k: v for k, v in cell.limits.items()
                                  if k in numbers})["correct"] is False
