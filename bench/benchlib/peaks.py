"""Published peaks of the cards the benchmark runs on, keyed by the name
`torch.cuda.get_device_name()` gives.  The rates assume the card's full
power limit; the traced run records the limit it ran under."""

#: NVIDIA H100 data sheet, SXM part: 80 GB of HBM3 at 3.35 TB/s, 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "power_limit_w": 700.0},
}


def hbm_bytes_per_s(kind: str | None) -> float | None:
    """The card's published memory rate, None for a card not in the table."""
    entry = PEAKS.get(kind or "")
    return entry["hbm_bytes_per_s"] if entry else None
