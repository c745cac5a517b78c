"""Whether torch.profiler still records the device's work after a large
profiling session in the same process, on the card.

Each scenario runs in a process of its own: one session of a probe (one
K4 launch through `nearest_neighbor` at B=1024 S=384 C=512, then one
PyTorch kernel, `torch.cuda._sleep`), a "load" session, then three probe
sessions. It prints what each probe session recorded (K4 launches and
PyTorch kernels, of 1 each) and the load session's device operations.
The loads: 2,000 K4 launches and 20,000 PyTorch kernels; 30,000 PyTorch
kernels; 3,000 K4 launches; 3,000 of each, interleaved; 20 frames of
live.consume (icp_fit's host reads among them). chip_smoke.py's
device_ops brackets every count with K4 launches that must show.

    python3 -m slam_tpu_torch.profiler_probe
"""

from __future__ import annotations

import subprocess
import sys

import torch

LOADS = ("k4_2000+torch_20000", "torch_30000", "k4_3000", "mixed_3000",
         "consume_20")


def _session(fn):
    """The device operations' names of one profiled call of fn."""
    act = torch.profiler.ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _problem(B, S=384, C=512):
    g = torch.Generator("cuda").manual_seed(0)
    return (torch.rand(B, S, 2, generator=g, device="cuda") * 20,
            torch.rand(B, C, 2, generator=g, device="cuda") * 20,
            torch.ones(B, C, dtype=torch.bool, device="cuda"))


def _consume_load(k: int):
    from slam_tpu_torch import live
    from slam_tpu_torch.config import sim2d_config
    from slam_tpu_torch.sim import replay, world2d
    cfg = sim2d_config()
    world = world2d.make_world(torch.Generator("cuda").manual_seed(42),
                               cfg.sim, device="cuda")
    frames = torch.from_numpy(replay.synth_frames(world, cfg.sim, k,
                                                  seed=0)).cuda()
    carry0 = live.init_carry(cfg, "cuda")

    def run():
        carry = carry0
        for fr in frames:
            carry, _ = live.consume(carry, *live.split_frame(
                fr, cfg.sim.num_beams), cfg)
    return run


def scenario(load: str) -> None:
    from slam_tpu_torch.ops import nn
    big, one = _problem(1024), _problem(1)
    x = torch.ones(16, device="cuda")

    def probe():
        nn.nearest_neighbor(*big)
        torch.cuda._sleep(1000)

    def report(tag, names):
        print(f"  {tag}: K4 {sum('nn_kernel' in n for n in names)}, "
              f"PyTorch {sum('spin' in n for n in names)}", flush=True)

    report("probe before", _session(probe))
    if load == "consume_20":
        fn = _consume_load(20)
    else:
        counts = dict(part.split("_") for part in load.split("+"))

        def fn():
            if "mixed" in counts:
                for _ in range(int(counts["mixed"])):
                    x.add_(1.0)
                    nn.nearest_neighbor(*one)
            for _ in range(int(counts.get("k4", 0))):
                nn.nearest_neighbor(*one)
            for _ in range(int(counts.get("torch", 0))):
                x.add_(1.0)
    print(f"  load: {len(_session(fn))} device operations", flush=True)
    for i in range(3):
        report(f"probe after {i + 1}", _session(probe))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        scenario(argv[0])
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("profiler_probe needs a CUDA device")
    from slam_tpu_torch import cuda_build
    cuda_build.library()
    for load in LOADS:
        r = subprocess.run([sys.executable, "-m",
                            "slam_tpu_torch.profiler_probe", load],
                           capture_output=True, text=True)
        print(load, flush=True)
        print(r.stdout.rstrip() or r.stderr[-2000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
