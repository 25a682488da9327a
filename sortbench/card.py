"""The card a run used: its nvidia-smi readings and its published peak.

A card may be set below its 700 W maximum and then runs slower under load,
so every run prints the card's name, SM clock, power draw, power limit and
temperature before and after the window, and every roofline share is
stated against the published peak with that power limit beside it.
"""

from __future__ import annotations

import subprocess

# Published HBM bandwidth, bytes a second, by the name
# torch.cuda.get_device_name() gives (NVIDIA H100 data sheet, SXM part).
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

_FIELDS = ("name", "clocks.sm", "power.draw", "power.limit",
           "temperature.gpu")


def sample() -> dict | None:
    """The first card's readings, or None where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(_FIELDS)}",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    if not lines:
        return None
    return dict(zip(_FIELDS, (v.strip() for v in lines[0].split(","))))
