"""PyTorch and CUDA port of ``distributeddeeplearning_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's name and place (``models/``, ``ops/``, ``serve/``,
``obs/``).  The port imports ``torch`` and numpy only — never ``jax`` and
nothing of the JAX package.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.  On the card float32 stays
full float32: :func:`resolve_device` turns TF32 off for matmuls and cuDNN,
because the port is held to the reference in f32.

The two TPU kernels of the serving path are hand-written CUDA C++ for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first use
(:mod:`.ops._build`).
"""

from distributeddeeplearning_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
