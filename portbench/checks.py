"""The numbers that decide `correct`, and their limits.

Each number is "lower is better" and is held to the limit of its cell in
`portbench/limits/<cell>.json`; the readings each limit was set from are
kept in the same file and in PERF.md.
"""

from __future__ import annotations

import json
from pathlib import Path

LIMITS_DIR = Path(__file__).resolve().parent / "limits"

# A pixel has diverged where a channel departs from the reference by more
# than this share of the reference's value, plus DIVERGED_FLOOR.
DIVERGED_SHARE = 1e-2
DIVERGED_FLOOR = 1e-3
# The denominator's floor of a pixel's relative gap.
GAP_FLOOR = 1e-3


def frame_numbers(torch, result, expected) -> dict:
    """The frame's numbers at the check pixels (a value that is not a
    number counts as an infinite gap):

    - diverged_share: the share of pixels with a channel beyond
      DIVERGED_SHARE * |reference| + DIVERGED_FLOOR (another path, a wrong
      hit or a wrong light, a pixel left out);
    - median_gap: the median over pixels of the largest channel gap as a
      share of |reference| + GAP_FLOOR (the rounding of the rest)."""
    gap = torch.nan_to_num((result - expected).abs(), nan=float("inf"))
    diverged = (gap > DIVERGED_SHARE * expected.abs()
                + DIVERGED_FLOOR).any(dim=-1)
    rel = (gap / (expected.abs() + GAP_FLOOR)).max(dim=-1).values
    return {"diverged_share": float(diverged.float().mean()),
            "median_gap": float(rel.median())}


def accum_gap(torch, result, before, after, index: int) -> float:
    """The largest gap of the accumulation image after the frame from
    (result + index * before) / (index + 1), worked out again from the
    copies, as a share of that value (plus 1e-6)."""
    idx = float(index)
    merged = (result + idx * before) / (idx + 1.0)
    return float(torch.nan_to_num((after - merged).abs()
                                  / (merged.abs() + 1e-6),
                                  nan=float("inf")).max())


def limits(cell: str) -> dict:
    return json.loads((LIMITS_DIR / f"{cell}.json").read_text())["limits"]


def verdict(numbers: dict, cell_limits: dict) -> bool:
    """Correct when every number is finite and at most its limit; a number
    without a limit fails."""
    return all(name in cell_limits and value == value
               and value <= cell_limits[name]
               for name, value in numbers.items())
