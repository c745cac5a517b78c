"""map_macro_ms: the maps' once-a-macro upkeep (the target's export,
the point-map and occupancy shifts, shared_map.fold_scans), kernel ms a
tick."""

from portbench.harness.layers import stage_ms

STAGES = {"map_macro_ms": [
    "slam_tpu_torch.pipeline.slam2d:export_point_planes",
    "slam_tpu_torch.pipeline.slam2d:shift_point_map",
    "slam_tpu_torch.pipeline.slam2d:shift_origin",
    "slam_tpu_torch.pipeline.slam3d:export_point_planes",
    "slam_tpu_torch.pipeline.slam3d:shift_point_map",
    "slam_tpu_torch.pipeline.slam3d:shift_origin",
    "slam_tpu_torch.parallel.shared_map:fold_scans",
]}


def read(data):
    return stage_ms(data, "map_macro_ms")
