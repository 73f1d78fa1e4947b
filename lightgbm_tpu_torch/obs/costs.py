"""Device-family vocabulary of the histogram tune tables.

Counterpart of lightgbm_tpu/obs/costs.py ``normalize_device_kind``, cut to
what a table's ``device_family`` needs on the port: the H100 family. A
table measured on one family never routes another, and a card of no known
family routes by no foreign table.
"""
from __future__ import annotations

from typing import Optional


def normalize_device_kind(device_kind: Optional[str]) -> Optional[str]:
    """Map a card's name onto a family label ("NVIDIA H100 80GB HBM3" ->
    "h100"), or None when unknown."""
    return "h100" if "h100" in (device_kind or "").lower() else None
