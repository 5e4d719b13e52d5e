"""The card's name and power limit, as ``nvidia-smi`` reads them: every
number measured on a card is reported beside them."""

from __future__ import annotations

import subprocess


def card_line(index: int = 0) -> str | None:
    """``name, power.limit`` of card ``index`` (for example ``NVIDIA H100
    80GB HBM3, 700.00 W``); None where ``nvidia-smi`` is missing or
    fails."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0 or not proc.stdout.strip():
        return None
    return proc.stdout.strip().splitlines()[0]
