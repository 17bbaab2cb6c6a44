"""Device resolution and the float32 precision the port is held to."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when the answer is a CUDA device and no card is present — the
    port never drops to the CPU on its own; a caller that wants the CPU
    passes ``device="cpu"``.

    On CUDA it also pins float32 to full precision:
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``.  TF32 keeps about three
    decimal digits, and the port's parity contract with the JAX reference
    is f32.  For bf16 it sets
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
    False``: cuBLAS may otherwise reduce split-K partial sums of a bf16
    GEMM in bf16, where XLA accumulates bf16 dots in f32 and rounds once.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
