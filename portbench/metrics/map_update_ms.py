"""map_update_ms: the maps' every-tick upkeep (mapping/point_map.py
update_point_map_xy, mapping/occupancy.py add_to_occupancy_xy /
add_to_occupancy_xy2), kernel ms a tick."""

from portbench.harness.layers import stage_ms

STAGES = {"map_update_ms": [
    "slam_tpu_torch.pipeline.slam2d:update_point_map_xy",
    "slam_tpu_torch.pipeline.slam2d:add_to_occupancy_xy",
    "slam_tpu_torch.pipeline.slam3d:update_point_map_xy",
    "slam_tpu_torch.pipeline.slam3d:add_to_occupancy_xy2",
]}


def read(data):
    return stage_ms(data, "map_update_ms")
