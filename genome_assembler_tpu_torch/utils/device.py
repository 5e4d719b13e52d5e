"""Explicit device resolution.

Every entry point of the port takes a ``device`` argument. Asking for
CUDA on a machine without it is an error: the port never falls back to
the CPU behind the caller's back, so a run that was meant for the GPU
cannot silently measure the CPU instead.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> ``torch.device``.

    Raises RuntimeError for a CUDA device when CUDA is unavailable (or
    the index is out of range); never substitutes the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available "
                "on this machine (no fallback to the CPU)"
            )
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line(device: torch.device) -> str | None:
    """``nvidia-smi``'s name and power limit of a CUDA device, as
    ``--query-gpu=name,power.limit --format=csv,noheader`` prints them
    (for example ``NVIDIA H100 80GB HBM3, 700.00 W``); None for the CPU.
    Every number measured on a card is reported beside this line. Raises
    RuntimeError when ``nvidia-smi`` fails."""
    if device.type != "cuda":
        return None
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={0 if device.index is None else device.index}"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]
