"""Maidenhead grid / report packing (counterpart of
``orion_sdr_tpu/message/grid.py``; behavioral spec: message/grid.rs).

The extra field is represented as a plain string: "FN31", "R FN31", "+07",
"R-12", "RRR", "RR73", "73", or "" — pack/unpack are inverses on this form.
"""

from __future__ import annotations

from typing import Tuple

MAXGRID4 = 32_400


def packgrid(extra: str) -> Tuple[int, bool]:
    """extra string → (15-bit igrid4, ir flag)."""
    if not extra:
        return MAXGRID4 + 1, False
    if extra == "RRR":
        return MAXGRID4 + 2, False
    if extra == "RR73":
        return MAXGRID4 + 3, False
    if extra == "73":
        return MAXGRID4 + 4, False
    s, ir = (extra[2:], True) if extra.startswith("R ") else (extra, False)
    if (len(s) == 4 and "A" <= s[0] <= "R" and "A" <= s[1] <= "R"
            and s[2].isdigit() and s[3].isdigit()):
        igrid4 = ((ord(s[0]) - 65) * 1800 + (ord(s[1]) - 65) * 100
                  + int(s[2]) * 10 + int(s[3]))
        return igrid4, ir
    # signal report, optional 'R' prefix
    s, ir = (extra[1:], True) if extra.startswith("R") and not extra.startswith("R ") \
        else (extra, False)
    try:
        dd = int(s)
    except ValueError:
        dd = 0
    return MAXGRID4 + 35 + dd, ir


def unpackgrid(igrid4: int, ir: bool) -> str:
    """(igrid4, ir) → extra string (ref unpackgrid)."""
    if igrid4 <= MAXGRID4:
        n = igrid4
        d3 = n % 10; n //= 10
        d2 = n % 10; n //= 10
        c1 = n % 18; n //= 18
        c0 = n % 18
        grid = f"{chr(65 + c0)}{chr(65 + c1)}{d2}{d3}"
        return f"R {grid}" if ir else grid
    irpt = igrid4 - MAXGRID4
    if irpt == 1:
        return ""
    if irpt == 2:
        return "RRR"
    if irpt == 3:
        return "RR73"
    if irpt == 4:
        return "73"
    dd = irpt - 35
    return f"R{dd:+03d}" if ir else f"{dd:+03d}"
