"""The yardstick of the kernels' roofline: the card's published memory rate and the
fewest bytes a CG iteration has to move a grid point.

The bytes are the benchmark's count, not the program's: a traffic file gives, for its
operator, the fewest words that any loop the program has moves a point an iteration
(``value_words``, each of the state's dtype) and the index bytes beside them
(``index_bytes``), with their derivation.  So a loop that moves fewer bytes raises the
share, and no loop can push it over 100% on a stale count.
"""

from __future__ import annotations

# device name as torch.cuda.get_device_name gives it -> HBM bytes a second (NVIDIA's data
# sheet, H100 SXM5: 3.35 TB/s at its 700 W limit).  A card missing here gets no share.
PEAK_BYTES_S = {
    "NVIDIA H100 80GB HBM3": 3350e9,
}


def bytes_per_point(traffic: dict, itemsize: int) -> int:
    """The fewest bytes one CG iteration moves a grid point for this traffic's operator."""
    model = traffic["roofline"]
    return model["value_words"] * itemsize + model["index_bytes"]


def least_s(traffic: dict, itemsize: int, points: int, iterations: int,
            kind: str) -> float | None:
    """The least time the card ``kind`` could take for ``iterations`` CG iterations over
    ``points`` grid points: the bytes over the published rate; None for a card without
    one."""
    peak = PEAK_BYTES_S.get(kind)
    if peak is None:
        return None
    return bytes_per_point(traffic, itemsize) * points * iterations / peak
