"""The platform a run reports (counterpart of
``spfft_tpu.utils.platform``).

Only :func:`platform_summary` has a counterpart here: the card a run
used, by name and power limit, so that every number a benchmark prints
names its card. The JAX module's persistent compilation cache and its
virtual multi-device CPU platform have none: the port's kernels are
built once per source digest by ``ops._build`` (no XLA cache), and its
distributed plan holds S shards on one device, so no virtual devices
are needed.
"""

from __future__ import annotations

import subprocess

import torch


def power_limit() -> str | None:
    """The first card's ``name, power.limit`` line as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints it, split:
    its power limit (``"700.00 W"``), or None where ``nvidia-smi`` is
    missing or fails."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        return None
    return lines[0].rsplit(",", 1)[-1].strip()


def platform_summary(device=None) -> dict:
    """What a run on ``device`` (a CUDA device by default, where there is
    one) ran on: ``backend`` (``"cuda"`` or ``"cpu"``), ``device_count``
    (the visible cards; 1 on the CPU), ``device_kind``
    (``torch.cuda.get_device_name``; ``"cpu"``) and ``power_limit``
    (:func:`power_limit`; None on the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {"backend": "cpu", "device_count": 1, "device_kind": "cpu",
                "power_limit": None}
    return {"backend": "cuda", "device_count": torch.cuda.device_count(),
            "device_kind": torch.cuda.get_device_name(device),
            "power_limit": power_limit()}
