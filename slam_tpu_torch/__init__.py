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

import torch as _torch

# Geometry needs exact f32 products: TF32 keeps ~3 decimal digits, which is
# metres of error at lidar range (slam_tpu/__init__.py pins JAX the same way).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


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
