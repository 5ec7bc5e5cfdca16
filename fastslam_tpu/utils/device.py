"""What the measurement entry points run on, and a refusal of anything else.

``bench.py`` and ``chip_smoke.py`` time and check the filter on NVIDIA GPUs;
on any other backend they stop with a message naming the missing GPU rather
than measure the CPU under a device metric's name.
"""

from __future__ import annotations

import subprocess


def require_gpu(count: int = 1) -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices; raises
    ``SystemExit`` unless JAX sees at least ``count`` GPUs."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU: JAX found no GPU (platform "
            f"'{d.platform}', {d.device_kind})")
    if len(devs) < count:
        raise SystemExit(f"needs {count} GPUs: JAX found {len(devs)}")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def nvidia_smi(query: str = "name,power.limit") -> list[str]:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` lines, one
    per card, read by a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
