"""The bytes the core-maintenance kernels must move, and the card's peak.

A frozen copy of the byte formulas that ``chip_smoke.py`` uses to bound
``kernels/coremaint.py``'s kernels (``_stat_bytes``, ``_wsum_bytes``: 1 B
of ``valid`` per window slot, ``src`` / ``dst`` only for live slots).
Work is counted once per call of an entry point of ``kernels/coremaint.py``
(``coo_stat``, ``fused_removal_round``, ``fused_promotion_stats``), never
once per CUDA launch, so a later kernel that fuses launches is held to the
same work.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12

# columns of each packed statistic, and which read the k-order label or a
# per-vertex mask (as in kernels/coremaint.py when this copy was made)
STAT_COLUMNS = {"mcd_hi_dout": 3, "hi_dout": 2, "mcd": 1, "din": 1,
                "same_in": 1}
LABEL_STATS = ("mcd_hi_dout", "hi_dout", "din")
MASK_STATS = ("din", "same_in")


def stat_bytes(e: int, e_valid: int, n: int, stat: str) -> int:
    """Bytes a stat pass must move: the window's valid mask (1 B a slot),
    src and dst of the live slots only; core, label (when a predicate
    reads it) and the mask (when it reads one) once; the packed int32
    output once."""
    if stat == "wsum":
        # src, dst and w of the live slots; core, thresholds, output
        return e + 12 * e_valid + 12 * n
    reads_label = stat in LABEL_STATS
    reads_aux = stat in MASK_STATS
    return (e + 8 * e_valid + 4 * n + 8 * n * reads_label + n * reads_aux
            + 4 * n * STAT_COLUMNS[stat])


def call_bytes(entry: str, stat: str, e: int, e_valid: int, n: int) -> int:
    """Bytes one entry-point call must move over a window of ``e`` slots
    holding ``e_valid`` live edges."""
    if entry == "fused_removal_round":
        # mcd_hi_dout, then new_core (4 B) and drop (1 B) per vertex
        return stat_bytes(e, e_valid, n, "mcd_hi_dout") + 5 * n
    if entry == "fused_promotion_stats":
        # hi_dout, then the violator mask (1 B) per vertex
        return stat_bytes(e, e_valid, n, "hi_dout") + n
    return stat_bytes(e, e_valid, n, stat)


def share(total_bytes: int, kernel_s: float) -> float:
    """Percent of the HBM roofline: the least time the bytes need over the
    kernels' device time."""
    return 100.0 * total_bytes / HBM_BYTES_PER_S / kernel_s
