"""The host's and the card's state beside a window: the 1-minute load
average and, on a card, ``nvidia-smi``'s SM clock, power draw, power
limit and temperature. Printed on lines before the result, never in it."""

import os
import shutil
import subprocess

import torch

QUERY = "name,clocks.sm,power.draw,power.limit,temperature.gpu"


def smi() -> dict:
    """{field: text} of the first card, or {} where ``nvidia-smi`` is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return {}
    try:
        line = subprocess.run([exe, f"--query-gpu={QUERY}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    values = [v.strip() for v in line.splitlines()[0].split(",")] if line.strip() else []
    return dict(zip(QUERY.split(","), values))


def sample(device) -> dict:
    state = {"loadavg_1m": os.getloadavg()[0]}
    if torch.device(device).type == "cuda":
        state.update(smi())
    return state
