"""The device a run is on, as every measurement line names it."""

from __future__ import annotations

import subprocess


def describe() -> dict:
    """Platform, device kind and device count as JAX reports them."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def card_info() -> list[str]:
    """One 'name, power limit' line per card, as nvidia-smi prints them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi not available ({type(e).__name__})"]
    return [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]


def require_gpu(what: str) -> dict:
    """describe(), or SystemExit when JAX finds no GPU (no CPU fallback)."""
    dev = describe()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"{what}: no GPU found; JAX reports platform "
            f"'{dev['platform']}' ({dev['kind']}), and there is no CPU "
            "fallback"
        )
    return dev
