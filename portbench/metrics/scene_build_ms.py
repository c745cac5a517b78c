"""scene_build_ms: the scene build (slam2d.build_scene_planes,
slam3d.build_scene_3d_planes: ops/voxel.py, ops/scene_grid.py), kernel
ms a tick."""

from portbench.harness.layers import stage_ms

STAGES = {"scene_build_ms": [
    "slam_tpu_torch.pipeline.slam2d:build_scene_planes",
    "slam_tpu_torch.pipeline.slam3d:build_scene_3d_planes",
]}


def read(data):
    return stage_ms(data, "scene_build_ms")
