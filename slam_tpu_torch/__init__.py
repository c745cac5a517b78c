"""slam_tpu_torch: the PyTorch + CUDA port of slam_tpu.

The package mirrors `slam_tpu/`'s module names so that every function has
an obvious counterpart. Idiom differs where PyTorch wants it to:

- state is dataclasses of tensors with an explicit leading robot-batch dim
  `B` (the JAX package vmaps single-robot functions instead);
- every allocation names its `device`; the entry points default to the
  CUDA card and raise without one (`default_device`);
- randomness comes from an explicit `torch.Generator` (JAX threads
  `jax.random` keys, whose streams torch cannot reproduce);
- the TPU kernels are hand-written CUDA under `csrc/`, each beside a plain
  PyTorch version that CPU tensors run through.

The package imports torch and never jax.
"""

import functools as _functools

import torch as _torch

# Geometry needs exact f32 products: TF32 keeps ~3 decimal digits, which is
# metres of error at lidar range (slam_tpu/__init__.py pins JAX the same way).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


@_functools.lru_cache(maxsize=None)
def _divisor(d: float, dtype: _torch.dtype, device: _torch.device):
    return _torch.full((), d, dtype=dtype, device=device)


def true_div(x: _torch.Tensor, d: float) -> _torch.Tensor:
    """x / d rounded as one true division on every device.

    On a CUDA tensor PyTorch computes `x / python_float` as x times the f32
    reciprocal of d, whose rounding differs from a division: floor() of the
    quotient can then land in the neighbouring cell on the card but not on
    the CPU (or in JAX). Dividing by a 0-dim tensor on x's own device
    reaches the true-division kernel on both. Use it wherever a quotient
    feeds floor, round or an integer cast and d need not be a power of
    two. The divisor tensor is made once per (d, dtype, device): a fill,
    no copy from the host."""
    return x / _divisor(float(d), x.dtype, x.device)


def default_device(device=None) -> _torch.device:
    """`device`, or the CUDA card when it is None. The entry points run on
    the card unless the caller asks for the CPU (`device="cpu"`); without a
    card they raise rather than fall back to the CPU."""
    if device is not None:
        return _torch.device(device)
    if not _torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass device='cpu' to "
                           "run on the CPU")
    return _torch.device("cuda")
