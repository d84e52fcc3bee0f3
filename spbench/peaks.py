"""Data-sheet peaks of the cards the benchmark knows (SXM parts, dense,
float32 outside the tensor cores): a fragment of
``torch.cuda.get_device_name()`` -> (device-memory bytes/s, FLOP/s).
They assume the card's full power limit, which every run prints."""

from __future__ import annotations

PEAKS = {
    "h100 80gb hbm3": (3.35e12, 67e12),
    "h100 sxm": (3.35e12, 67e12),
}


def peaks(card_name: str):
    """(bytes/s, FLOP/s) of the card, or None for one not in the table."""
    for key, value in PEAKS.items():
        if key in card_name.lower():
            return value
    return None
