"""Port parity, the camera periphery: calibration geometry (with the
reference's extrinsics.yaml text inline), the sample-probability map and
the detection -> ground point -> sample chain (slam_tpu_torch vs slam_tpu,
CPU).

Tolerances:
- calib: camera-frame points, rays and ground points to 1e-5 relative
  (+1e-5 m), pixels to 1e-3 px at ~10^4 px of focal length: f32 matrix
  inverses and products in both packages, LAPACK blocked differently;
- sample map: probabilities to 1e-6 (exp ulps), peaks, their values and
  validity exact on a saturated plateau (clipped to prob_max in both, so
  the plateau's ties rank by flat index in both);
- the chain: the port's sample within 1e-4 m of slam_tpu's, both within
  0.8 m of the true ground point (the bound of
  tests/test_scan_to_scan_periphery.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import calib as jc
from slam_tpu.config import SampleMapConfig
from slam_tpu.mapping import sample_map as jsm
from slam_tpu.ops import fiducial as jf
from slam_tpu_torch import calib as tc
from slam_tpu_torch import interop
from slam_tpu_torch.config import SampleMapConfig as TSampleMapConfig
from slam_tpu_torch.mapping import sample_map as tsm
from slam_tpu_torch.ops import fiducial as tf
from tests.torch_parity import assert_close, assert_equal

torch.set_num_threads(1)

# the reference's calibration/calibration/extrinsics.yaml, one camera, and
# a second (stereo-right-like) camera with a skew and a fourth column
YAML = """\
- camera_name: zoom
  projection_matrix: [11162.85801, 0.0, 1938.03850, 0.0, 0.0, 11109.93803, 1270.60007, 0.0, 0.0, 0.0, 1.0, 0.0]
  extrinsics: [0.0607901, -0.205867, 0.97669, 0.313862, -0.99711, 0.0321484, 0.0688373, -0.302954, -0.0455703, -0.978052, -0.203318, -0.291717, 0.0, 0.0, 0.0, 1.0]
- camera_name: right
  projection_matrix: [900.0, 2.5, 640.0, -90.0, 0.0, 905.0, 360.0, 1.5, 0.0, 0.0, 1.0, 0.02]
  extrinsics: [0.0, 0.0, 1.0, 0.2, -1.0, 0.0, 0.0, -0.1, 0.0, -1.0, 0.0, -0.3, 0.0, 0.0, 0.0, 1.0]
"""

SCFG = SampleMapConfig(size_x=128, size_y=128, resolution=0.5)
CHAIN_CB = jf.make_codebook(seed=0, num_codes=8)
_jax_detect = jax.jit(lambda im: jf.detect_tags(
    im, jnp.asarray(CHAIN_CB), jf.FiducialConfig(min_area=100)))
TSCFG = TSampleMapConfig(size_x=128, size_y=128, resolution=0.5)


def test_yaml_and_reference_camera():
    jcams = jc.load_extrinsics_yaml(YAML)
    tcams = tc.load_extrinsics_yaml(YAML)
    assert len(tcams) == 2
    for a, b in zip(tcams, jcams):
        assert a.projection == b.projection and a.extrinsics == b.extrinsics
    assert tcams[0] == tc.CameraParams(*dataclasses.astuple(
        jc.REFERENCE_CAMERA))
    assert tc.REFERENCE_CAMERA == tcams[0]
    assert_equal(tcams[0].P(), np.asarray(jcams[0].P()))
    assert_equal(tcams[0].T(), np.asarray(jcams[0].T()))
    with pytest.raises(ValueError, match="extrinsics"):
        tc.load_extrinsics_yaml("- projection_matrix: [1.0]\n")


@pytest.mark.parametrize("cam_idx", [0, 1])
def test_projection_chain_matches_jax(cam_idx):
    jcam = jc.load_extrinsics_yaml(YAML)[cam_idx]
    tcam = tc.load_extrinsics_yaml(YAML)[cam_idx]
    rng = np.random.default_rng(cam_idx)
    pts = np.stack([rng.uniform(4, 11, 16), rng.uniform(-1.5, 1.5, 16),
                    np.full(16, -1.3)], -1).astype(np.float32)
    jcxyz = jc.lidar_to_camera(jcam, jnp.asarray(pts))
    tcxyz = tc.lidar_to_camera(tcam, torch.from_numpy(pts))
    assert_close(tcxyz, jcxyz, atol=1e-5, rtol=1e-5)
    juv = jc.camera_to_pixel(jcam, jcxyz)
    tuv = tc.camera_to_pixel(tcam, tcxyz)
    assert_close(tuv, juv, atol=1e-3)
    assert_close(tc.camera_center(tcam), jc.camera_center(jcam), atol=1e-5)
    uv = np.asarray(juv)
    jray = jc.pixel_to_ray(jcam, jnp.asarray(uv))
    tray = tc.pixel_to_ray(tcam, torch.from_numpy(uv))
    assert_close(tray, jray, atol=1e-5, rtol=1e-5)
    jg = jc.ray_to_flat_ground(jcam, jray, -1.3)
    tg = tc.ray_to_flat_ground(tcam, tray, -1.3)
    assert_equal(torch.isnan(tg).any(-1), np.isnan(np.asarray(jg)).any(-1))
    ok = ~np.isnan(np.asarray(jg)).any(-1)
    assert ok.any()
    assert_close(tg.numpy()[ok], np.asarray(jg)[ok], atol=1e-4, rtol=1e-5)
    pose = np.float32([3.0, -2.0, 0.7, 1.3])
    assert_close(tc.pixel_to_global(tcam, torch.from_numpy(uv),
                                    torch.from_numpy(pose), -1.3).numpy()[ok],
                 np.asarray(jc.pixel_to_global(jcam, jnp.asarray(uv),
                                               jnp.asarray(pose), -1.3))[ok],
                 atol=1e-4, rtol=1e-5)


def test_ray_above_the_horizon_is_nan():
    cam = tc.REFERENCE_CAMERA
    up = torch.tensor([[1938.0, -5000.0]])       # far above the horizon
    assert torch.isnan(tc.ray_to_flat_ground(
        cam, tc.pixel_to_ray(cam, up), -1.3)).all()


def _maps(ops):
    """The same add / remove sequence in both packages: a saturated
    plateau at (5, 0), a weaker sample at (-10, -10), a cone decay."""
    jm = jsm.init_sample_map(SCFG)
    tm = tsm.init_sample_map(TSCFG, 1, device="cpu")
    for op, xy, a, b in ops:
        f32 = np.float32
        if op == "add":
            jm = jsm.add_sample(jm, jnp.asarray(xy, jnp.float32),
                                jnp.float32(a), jnp.float32(b), SCFG)
            tm = tsm.add_sample(tm, torch.tensor([xy], dtype=torch.float32),
                                torch.tensor([f32(a)]),
                                torch.tensor([f32(b)]), TSCFG)
        else:
            jm = jsm.remove_cone(jm, jnp.asarray(xy, jnp.float32),
                                 jnp.float32(a), jnp.float32(b), SCFG)
            tm = tsm.remove_cone(tm, torch.tensor([xy], dtype=torch.float32),
                                 torch.tensor([f32(a)]),
                                 torch.tensor([f32(b)]), TSCFG)
    return jm, tm


def test_sample_map_with_a_saturated_plateau_matches_jax():
    ops = [("add", [5.0, 0.0], 1.5, 1.0)] * 8 + \
        [("add", [-10.0, -10.0], 1.5, 1.0)] * 2 + \
        [("cone", [0.0, -12.0], 2.4, 0.3)] + \
        [("add", [12.0, 7.5], 3.0, 0.6)]
    jm, tm = _maps(ops)
    assert_close(tm.prob[0], jm.prob, atol=1e-6)
    assert (tm.prob == TSCFG.prob_max).sum() > 4            # a plateau
    jp = jsm.extract_samples(jm, SCFG, max_samples=8)
    tp = tsm.extract_samples(tm, TSCFG, max_samples=8)
    assert_equal(tp.valid[0], jp.valid)
    assert_equal(tp.xy[0], jp.xy)
    assert_equal(tp.value[0], jp.value)
    assert int(tp.valid.sum()) == 3
    # carried across: slam_tpu's map gives the port's peaks
    tp2 = tsm.extract_samples(interop.sample_map_from_numpy(
        jsm.SampleMap(prob=np.asarray(jm.prob)), "cpu"), TSCFG, 8)
    assert_equal(tp2.xy, tp.xy)


def test_detection_to_sample_chain_matches_jax():
    """A tag rendered at the (scaled) pixel of a ground point, detected,
    taken to the ground and added to the map three times, in both."""
    cb = CHAIN_CB
    h = -1.3
    sample = np.float32([7.0, 0.8, h])
    jcam, tcam = jc.REFERENCE_CAMERA, tc.REFERENCE_CAMERA
    uv_true = np.asarray(jc.camera_to_pixel(jcam, jc.lidar_to_camera(
        jcam, jnp.asarray(sample))))
    c = uv_true / 32.0
    corners = (np.float32([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * 20
               + c).astype(np.float32)
    img = np.asarray(jf.render_tag(jnp.asarray(cb[3]), jnp.asarray(corners),
                                   160, 160)) * np.float32(0.83) + 0.06
    cfg = jf.FiducialConfig(min_area=100)
    jd = _jax_detect(jnp.asarray(img))
    td = tf.detect_tags(torch.from_numpy(img)[None],
                        interop.codebook_from_numpy(cb, "cpu"),
                        tf.FiducialConfig(*cfg))
    k = int(np.argmax(np.asarray(jd.valid)))
    assert bool(td.valid[0, k]) and int(td.tag_id[0, k]) == 3
    pose = np.float32([3.0, -2.0, 0.7, 1.3])
    jg = jc.pixel_to_global(jcam, jd.center[k] * 32.0, jnp.asarray(pose), h)
    tg = tc.pixel_to_global(tcam, td.center[0, k] * 32.0,
                            torch.from_numpy(pose), h)
    assert_close(tg, jg, atol=1e-4)
    jm = jsm.init_sample_map(SCFG)
    tm = tsm.init_sample_map(TSCFG, 1, device="cpu")
    for _ in range(3):
        jm = jsm.add_sample(jm, jg[:2], jnp.float32(1.2), jnp.float32(0.8),
                            SCFG)
        tm = tsm.add_sample(tm, tg[None, :2], torch.tensor([1.2]),
                            torch.tensor([0.8]), TSCFG)
    jp, tp = jsm.extract_samples(jm, SCFG), tsm.extract_samples(tm, TSCFG)
    assert_equal(tp.xy[0], jp.xy)
    truth = np.asarray(jc.pixel_to_global(jcam, jnp.asarray(uv_true),
                                          jnp.asarray(pose), h))[:2]
    assert bool(tp.valid[0, 0])
    assert np.linalg.norm(tp.xy[0, 0].numpy() - truth) <= 0.8
