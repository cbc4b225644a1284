"""The card's published peaks (NVIDIA H100 SXM data sheet, dense rates,
at the full 700 W power limit) and the power limit the card is set to."""

from __future__ import annotations

import shutil
import subprocess

#: TF32 tensor cores, dense: the fastest rate at which the card multiplies
#: float32 inputs, so no float32 implementation can read above it
F32_PEAK_FLOPS = 495e12
#: HBM3 bandwidth
HBM_PEAK_BYTES = 3.35e12


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at :data:`F32_PEAK_FLOPS` and the bytes at :data:`HBM_PEAK_BYTES`."""
    return max(flops / F32_PEAK_FLOPS, nbytes / HBM_PEAK_BYTES)


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or what kept it
    from reading them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())
