"""Render a binary replay file of simulated sensor frames, the port's
"rosbag" — counterpart of tools/make_replay.py.

Frame layout (little-endian float32): [ranges(num_beams), gyro, cmd(3)],
the layout the native replay loader reads (runtime/native.py
`ScanLoader`) and slam_tpu_torch.live consumes.

    python3 -m slam_tpu_torch.make_replay [--frames 500]
        [--out /tmp/scans.bin] [--seed 0] [--device cpu]

The world is sim2d_config's from the seed-42 generator; the frames'
range noise comes from numpy's generator seeded --seed, as slam_tpu's
does. The raycast runs on the card unless given --device cpu; it raises
without one.
"""

from __future__ import annotations

import argparse

import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.config import sim2d_config
from slam_tpu_torch.sim import world2d
from slam_tpu_torch.sim.replay import synth_frames


def run(cfg, world, frames: int, out: str, seed: int = 0) -> dict:
    """Write `frames` frames along the standard drive loop through `world`
    to the file `out`. Returns frames, floats (a frame) and nbytes."""
    data = synth_frames(world, cfg.sim, frames, seed=seed)
    with open(out, "wb") as f:
        f.write(data.tobytes())
    return dict(frames=data.shape[0], floats=data.shape[1],
                nbytes=data.nbytes)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--out", default="/tmp/scans.bin")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = sim2d_config()
    world = world2d.make_world(torch.Generator(device).manual_seed(42),
                               cfg.sim, device=device)
    r = run(cfg, world, args.frames, args.out, args.seed)
    print(f"wrote {r['frames']} frames x {r['floats']} floats to "
          f"{args.out} ({r['nbytes']} bytes)")


if __name__ == "__main__":
    main()
