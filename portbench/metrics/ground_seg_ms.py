"""ground_seg_ms: ground segmentation (ops/ground.py through
slam3d.segment_ground), kernel ms a tick."""

from portbench.harness.layers import stage_ms

STAGES = {"ground_seg_ms": [
    "slam_tpu_torch.pipeline.slam3d:segment_ground",
]}


def read(data):
    return stage_ms(data, "ground_seg_ms")
