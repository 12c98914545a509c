"""Device selection: the port runs on the card unless the caller asks for
the CPU (as the tests do)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

# the JAX reference's real-mode server reports 8 SMs (its CPU interpret
# device); on the CPU the port keeps that figure so that the profiler's
# candidate configs equal the reference's
CPU_SM_COUNT = 8


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` by default; raises when no GPU is present unless the caller
    passes ``"cpu"``. Never falls back silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev


def device_attributes(device: torch.device) -> Dict[str, Any]:
    """What a client may ask the server about its device."""
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return {"name": props.name,
                "sm_count": props.multi_processor_count,
                "max_threads_per_block": 1024}
    return {"name": "torch-cpu", "sm_count": CPU_SM_COUNT,
            "max_threads_per_block": 1024}


def synchronize(device: torch.device) -> None:
    """Wait for the device: CUDA launches return before the kernel ends."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
