"""The card's peak rates, for MFU and roofline accounting — the port of
``utils/hardware.py``.

:data:`PEAKS` holds, for each card the port knows, keyed by the name
``torch.cuda.get_device_name()`` reports: dense bf16 (tensor cores, no
sparsity), dense TF32 (tensor cores, no sparsity), f32 on the CUDA cores,
all in FLOP/s, and HBM bandwidth in GB/s, each from NVIDIA's data sheet
for that part (the rates at the card's full power limit).  A card set
below its limit runs slower under load: state a share of these peaks
beside the card's ``nvidia-smi`` power limit.

Every lookup returns None, and never raises, off the card or for a card
the table does not know: callers then omit MFU rather than report a
made-up number (the reference's contract).  ``device`` is None (this
process's card), a device index or ``torch.device``, or a card's name as
``torch.cuda.get_device_name()`` gives it (a string that is not a device
spec such as ``"cuda:0"``).

:func:`step_flops` counts the model FLOPs of one train step.  The
reference reads XLA's cost model of the lowered step
(``cost_analysis``); eager PyTorch has none, and the port's kernels are
``ctypes`` calls that ``torch.utils.flop_counter`` cannot see.  So the
count is ``torch.utils.flop_counter.FlopCounterMode`` over one eval-mode
forward of the state's model on ``meta`` copies of its params and batch
(no memory, no arithmetic: shapes only), where the attention wrappers
take their plain path, times three (the backward's two products a
forward product: the 6NT convention of model FLOPs).  It is independent
of which kernels run the step, and it counts matrix products and
convolutions only, not the elementwise work XLA's cost model adds.
``enable_compilation_cache`` reads XLA's persistent cache and has no
eager counterpart.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional

import torch

_H100_SXM = "NVIDIA H100 SXM5 data sheet"
_H100_PCIE = "NVIDIA H100 PCIe data sheet"
_H100_NVL = "NVIDIA H100 NVL data sheet"

#: card name -> peak rates (module docstring); FLOP/s and GB/s
PEAKS: Dict[str, Dict[str, Any]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989.4e12, "tf32_flops": 494.7e12, "f32_flops": 67e12,
        "hbm_gbps": 3350.0, "source": _H100_SXM},
    "NVIDIA H100 PCIe": {
        "bf16_flops": 756.5e12, "tf32_flops": 378.0e12, "f32_flops": 51e12,
        "hbm_gbps": 2000.0, "source": _H100_PCIE},
    "NVIDIA H100 NVL": {
        "bf16_flops": 835.5e12, "tf32_flops": 417.5e12, "f32_flops": 60.0e12,
        "hbm_gbps": 3900.0, "source": _H100_NVL},
}


def device_name(device=None) -> Optional[str]:
    """The card's name (module docstring for ``device``); None off the
    card or where the name cannot be read."""
    try:
        if isinstance(device, str) and not device.split(":")[0] in (
                "cuda", "cpu", "meta"):
            return device
        if device is not None and not isinstance(device, int):
            device = torch.device(device)
            if device.type != "cuda":
                return None
        if not torch.cuda.is_available():
            return None
        return torch.cuda.get_device_name(device)
    except Exception:  # noqa: BLE001 — no card, no name: MFU omitted
        return None


def peaks(device=None) -> Optional[Dict[str, Any]]:
    """The :data:`PEAKS` entry of the card (None where it is not known)."""
    name = device_name(device)
    return None if name is None else PEAKS.get(name)


def _peak(key: str, device) -> Optional[float]:
    entry = peaks(device)
    return None if entry is None else float(entry[key])


def peak_bf16_flops(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the card (None, never an exception, off
    the card or for an unknown card)."""
    return _peak("bf16_flops", device)


def peak_hbm_gbps(device=None) -> Optional[float]:
    """Peak HBM bandwidth of the card in GB/s (as :func:`peak_bf16_flops`)."""
    return _peak("hbm_gbps", device)


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def mfu(flops_per_step: float, steps: int, wall_s: float, *, device=None,
        n_chips: Optional[int] = None) -> Optional[float]:
    """Model FLOPs utilization, as the reference computes it::

        MFU = (flops_per_step x steps / wall_s) / (peak_bf16_flops x n_chips)

    ``flops_per_step`` is the model FLOPs of one train step (of the
    global batch: :func:`step_flops`, or an analytic count), ``wall_s``
    the whole window scored, ``n_chips`` the cards (default: the
    ``torch.distributed`` world, one process a card; 1 without one).
    None where the card's peak is unknown or the inputs are degenerate."""
    if flops_per_step <= 0 or steps <= 0 or wall_s <= 0:
        return None
    peak = peak_bf16_flops(device)
    if peak is None:
        return None
    n_chips = _world() if n_chips is None else n_chips
    if n_chips <= 0:
        return None
    return (flops_per_step * steps / wall_s) / (peak * n_chips)


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta")
    return tree


def step_flops(state, batch, *, compute_dtype: Optional[torch.dtype] = None) -> Optional[float]:
    """Model FLOPs of one train step of ``state``'s model on ``batch``
    (this process's rows): three times one eval-mode forward's matrix
    products and convolutions, counted on ``meta`` copies (module
    docstring).  None where the count fails (a forward that runs
    collectives over model axes cannot run on ``meta``) or finds none."""
    from torch.utils.flop_counter import FlopCounterMode

    from distributeddeeplearning_tpu_torch.train import step as tstep

    try:
        inputs = batch.get("image", batch.get("input"))
        inputs = torch.as_tensor(inputs)
        if inputs.dim() >= 3 and not inputs.is_floating_point():
            inputs = inputs.float()  # uint8 images the step's transform normalizes
        if inputs.is_floating_point() and compute_dtype is not None:
            inputs = inputs.to(compute_dtype)
        extras = {k: torch.as_tensor(batch[k]).to("meta")
                  for k in tstep.EXTRA_INPUT_KEYS if k in batch}
        # what train.step._forward reads of a state, on meta
        meta = SimpleNamespace(apply_fn=state.apply_fn, params=_meta(state.params),
                               batch_stats=_meta(state.batch_stats))
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            tstep._forward(meta, meta.params, inputs.to("meta"), train=False,
                           generator=None, extras=extras)
    except Exception:  # noqa: BLE001 — MFU is an optional column
        return None
    forward = float(counter.get_total_flops())
    return 3.0 * forward if forward > 0 else None
