"""What a measurement ran on: JAX's device record and the card's name and
power limit as ``nvidia-smi`` reports them."""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional


def device_record() -> dict:
    """{"platform", "kind", "count"} of the devices JAX sees."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` output (one line per
    card), from a child process that never touches JAX; None without
    nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        return None
    return out.stdout.strip()
