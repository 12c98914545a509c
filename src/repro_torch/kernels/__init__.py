"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions."""
from repro_torch.kernels.flash_attention import FLASH
from repro_torch.kernels.mamba2_scan import SSD
from repro_torch.kernels.matmul import MATMUL

# every kernel family of the real-mode path
FAMILIES = (MATMUL, FLASH, SSD)


def build_all() -> list:
    """Build (in parallel) and load every family's library; returns the
    names compiled by this call."""
    from repro_torch.kernels import _build
    built = _build.build_all(f.lib for f in FAMILIES)
    for f in FAMILIES:
        f.library()
    return built
