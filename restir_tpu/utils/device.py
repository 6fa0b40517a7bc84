"""The accelerator a measurement runs on.

Every timing this repo reports names its device. A measurement path
that finds no GPU fails; it never falls back to the CPU.
"""

from __future__ import annotations

import shutil
import subprocess


def require_gpu():
    """The first JAX device, which must be a GPU; raises RuntimeError
    otherwise (e.g. in a CPU-only process)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this measurement needs a GPU"
        )
    return dev


def device_info(dev) -> dict:
    """platform / kind / count as JAX reports them."""
    import jax

    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def nvidia_smi_name_power() -> str:
    """`name, power.limit` of the cards as nvidia-smi reports them (one
    line per card). The query runs in a child process that stays off
    JAX."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
