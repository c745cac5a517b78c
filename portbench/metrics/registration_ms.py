"""registration_ms: registration (ops/icp_fused.py to K1 / K3 through
fused_register, ops/particle.py to K5 through pf_match), kernel ms a
tick."""

from portbench.harness.layers import stage_ms

STAGES = {"registration_ms": [
    "slam_tpu_torch.pipeline.slam2d:fused_register",
    "slam_tpu_torch.pipeline.slam2d:pf_match",
    "slam_tpu_torch.pipeline.slam3d:fused_register",
]}


def read(data):
    return stage_ms(data, "registration_ms")
