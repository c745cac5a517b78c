"""Port parity on chip_smoke.py [fiducial]'s own frames (slam_tpu_torch vs
slam_tpu, CPU): the witness for the tags the card's runs miss and for the
corner they hold to slam_tpu's.

tag_frames draws every layout, clutter and noise value from one numpy seed,
so the CPU rebuilds the card's 3,876 x 2,541 px frames (up to the rounding
of the rendering). A full frame is too large for a CPU test; each tag of
chip_smoke.FID_MISSES and FID_CORNER_PINNED is cut out with the 576 x 576 px
around it (an even offset, so decimation samples the frame's own grid) and
run through both packages' detect_tags at every configuration the card
runs. Held here:
- both packages agree on every crop: validity and ids exact, Hamming
  distances of valid detections exact, corners and centres within 1e-4 px
  (pixel picks in "cc", line intersections of scatter-summed fits in
  "gradient");
- a miss marked "crop" is a miss of slam_tpu's on its crop, and one marked
  "frame" is not (slam_tpu decodes the crop: that miss comes from the whole
  frame, for which there is no slam_tpu witness here);
- a pinned corner is slam_tpu's worst corner on its crop, to 0.05 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from slam_tpu.ops import fiducial as jf
from slam_tpu_torch import calib
from slam_tpu_torch.ops import fiducial as tf
from tests.torch_parity import assert_close, assert_equal

torch.set_num_threads(1)

CB = jf.tag36h11()
CROP = 576
RUNS = sorted(cs.FID_MISSES)
# one compiled slam_tpu detector per configuration
_JAX = {(seg, d): jax.jit(jax.vmap(lambda im, c=jf.FiducialConfig(
    segmenter=seg, decimate=d): jf.detect_tags(im, jnp.asarray(CB), c)))
    for seg, d in RUNS}
TAGS = sorted({t for m in cs.FID_MISSES.values() for t in m}
              | {(f, code) for _, _, f, code in cs.FID_CORNER_PINNED})


@pytest.fixture(scope="module")
def crops():
    """(crops (n, CROP, CROP), the rendered corners in crop pixels (n, 4,
    2)) for TAGS, cut from the frames tag_frames makes on the card."""
    frames, truth, _ = cs.tag_frames(calib.REFERENCE_CAMERA,
                                     torch.from_numpy(CB), 10,
                                     torch.device("cpu"))
    out, corners = [], []
    for f, code in TAGS:
        c = next(c for k, c, _ in truth[f] if k == code).numpy()
        cx, cy = c.mean(0)
        x0 = int(np.clip(cx - CROP / 2, 0, cs.FID_W - CROP)) // 2 * 2
        y0 = int(np.clip(cy - CROP / 2, 0, cs.FID_H - CROP)) // 2 * 2
        out.append(frames[f, y0:y0 + CROP, x0:x0 + CROP].numpy())
        corners.append(c - np.float32([x0, y0]))
    return np.stack(out), np.stack(corners)


def _worst_corner(det, i, code, corners):
    """The worst corner's distance (px) of tag `code` in crop i, or None
    when it is not decoded there."""
    valid, ids = np.asarray(det.valid[i]), np.asarray(det.tag_id[i])
    q = [k for k in range(len(valid)) if valid[k] and ids[k] == code]
    if not q:
        return None
    got = np.asarray(det.corners[i, q[0]])
    return float(np.linalg.norm(got[:, None] - corners[None], axis=-1)
                 .min(1).max())


@pytest.mark.parametrize("seg,d", RUNS)
def test_card_misses_and_pinned_corners_are_slam_tpus(crops, seg, d):
    imgs, corners = crops
    want = _JAX[(seg, d)](jnp.asarray(imgs))
    got = tf.detect_tags(torch.from_numpy(imgs),
                         torch.from_numpy(CB),
                         tf.FiducialConfig(segmenter=seg, decimate=d))
    assert_equal(got.valid, want.valid)
    assert_equal(got.tag_id, want.tag_id)
    v = np.asarray(want.valid)
    assert_equal(np.asarray(got.hamming)[v], np.asarray(want.hamming)[v])
    assert_close(np.asarray(got.corners)[v], np.asarray(want.corners)[v],
                 atol=1e-4)
    assert_close(np.asarray(got.center)[v], np.asarray(want.center)[v],
                 atol=1e-4)
    for i, (f, code) in enumerate(TAGS):
        worst = _worst_corner(want, i, code, corners[i])
        kind = cs.FID_MISSES[(seg, d)].get((f, code))
        if kind == "crop":
            assert worst is None, (f, code)
        elif kind == "frame":
            assert worst is not None, (f, code)
        held = cs.FID_CORNER_PINNED.get((seg, d, f, code))
        if held is not None:
            assert worst is not None and abs(worst - held) <= 0.05, worst
