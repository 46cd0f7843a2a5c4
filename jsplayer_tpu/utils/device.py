"""What the scripts that measure or smoke-test the card print about it.

Only a GPU run produces device numbers: :func:`require_gpu` exits the
process when JAX's first device is anything else, so a machine without a
card never prints a record.
"""

from __future__ import annotations

import subprocess
import sys


def require_gpu():
    """→ jax.devices() when device 0 is a GPU; otherwise exit with code 2."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX's device 0 is {devs[0].platform!r} "
              f"({devs[0].device_kind})", file=sys.stderr)
        raise SystemExit(2)
    return devs


def nvidia_smi_name_power() -> str:
    """The card's name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (a child process that never imports JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def device_record(devs) -> dict:
    """platform / device_kind / count as JAX reports them."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
