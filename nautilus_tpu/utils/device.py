"""The GPU a measurement runs on, or an error when there is none.

Every timing this project reports names its device: JAX's platform,
device kind and count, and the card's name and power limit as nvidia-smi
gives them (a card set below its maximum power runs slower under load).
There is no CPU fallback: a measurement path that finds no GPU fails.
"""

from __future__ import annotations

import subprocess


class NoGPUError(RuntimeError):
    pass


def require_gpu() -> dict:
    """{"platform", "kind", "count", "nvidia_smi": [name, power.limit per
    card]} of the visible devices; raises NoGPUError without a GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoGPUError(f"JAX found no GPU (platform {devs[0].platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi}
