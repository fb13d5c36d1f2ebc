"""Carrier plans & grids — OFDM numerology as index arrays (counterpart of
``orion_sdr_tpu/multicarrier/plan.py``).

Unity forward FFT / 1/N inverse; natural bin order internally, signed indices
at the API (bin = idx mod n_fft); DC is null unless opted in.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence, Tuple

import numpy as np
import torch


class CarrierPlanError(ValueError):
    pass


@dataclass(frozen=True)
class CarrierPlan:
    """Resource-grid description. Signed carrier indices: bin 0 = DC,
    negatives count down."""

    n_fft: int
    cp_len: int
    data_carriers: Tuple[int, ...] = ()
    pilot_carriers: Tuple[Tuple[int, complex], ...] = ()
    window_roll_off: int = 0

    def with_data_carriers(self, carriers: Sequence[int]) -> "CarrierPlan":
        return replace(self, data_carriers=self.data_carriers
                       + tuple(int(c) for c in carriers))

    def with_pilot_carriers(self, carriers) -> "CarrierPlan":
        new = tuple((int(i), complex(v)) for i, v in carriers)
        return replace(self, pilot_carriers=self.pilot_carriers + new)

    def with_window_roll_off(self, roll_off: int) -> "CarrierPlan":
        return replace(self, window_roll_off=int(roll_off))

    def with_contiguous_data(self, edge_guard: int = 0,
                             include_dc: bool = False) -> "CarrierPlan":
        """Contiguous data span leaving ``edge_guard`` nulls per edge."""
        lo, hi = self.index_bounds()
        g = int(edge_guard)
        pilots = {i for i, _ in self.pilot_carriers}
        span = [i for i in range(lo + 1 + g, hi - g + 1)
                if not (i == 0 and not include_dc) and i not in pilots]
        return replace(self, data_carriers=self.data_carriers + tuple(span))

    def index_bounds(self) -> Tuple[int, int]:
        n = self.n_fft
        return (-(n // 2), (n - 1) // 2)

    def occupied_half_carriers(self) -> int:
        idx = [abs(i) for i in self.data_carriers] + \
            [abs(i) for i, _ in self.pilot_carriers]
        return max(idx) if idx else 0

    def num_data_carriers(self) -> int:
        return len(self.data_carriers)

    def validate(self) -> None:
        if not self.data_carriers:
            raise CarrierPlanError("no data carriers specified")
        lo, hi = self.index_bounds()
        seen = set()
        for idx in list(self.data_carriers) + [i for i, _ in self.pilot_carriers]:
            if not (lo <= idx <= hi):
                raise CarrierPlanError(
                    f"carrier index {idx} out of range for n_fft={self.n_fft} "
                    f"(valid: {lo}..={hi})")
            if idx in seen:
                raise CarrierPlanError(
                    f"carrier index {idx} assigned more than one role")
            seen.add(idx)

    def validate_edge_guard(self, edge_guard: int) -> None:
        """:meth:`validate`, and no carrier within ``edge_guard`` carriers
        of either end of the FFT's index range."""
        self.validate()
        lo, hi = self.index_bounds()
        g = int(edge_guard)
        for idx in list(self.data_carriers) + \
                [i for i, _ in self.pilot_carriers]:
            if idx < lo + g or idx > hi - g:
                raise CarrierPlanError(
                    f"carrier index {idx} intrudes into the {edge_guard}-"
                    "carrier edge guard")


class CarrierGrid:
    """Signed-index → FFT-bin resolution, done once; raises CarrierPlanError
    on an invalid plan. Holds numpy index arrays plus their per-device
    tensor copies."""

    def __init__(self, plan: CarrierPlan):
        plan.validate()
        self.plan = plan
        self.n_fft = plan.n_fft
        self.cp_len = plan.cp_len
        self.data_bins = np.array(
            [i % self.n_fft for i in plan.data_carriers], dtype=np.int32)
        self.pilot_bins = np.array(
            [i % self.n_fft for i, _ in plan.pilot_carriers], dtype=np.int32)
        self.pilot_values = np.array(
            [v for _, v in plan.pilot_carriers], dtype=np.complex64)
        self._on_device = {}

    @property
    def num_data_carriers(self) -> int:
        return len(self.data_bins)

    def symbol_len(self) -> int:
        return self.n_fft + self.cp_len

    def tensor(self, name: str, device) -> torch.Tensor:
        """``data_bins`` / ``pilot_bins`` (int64) or ``pilot_values``
        (complex64) as a tensor on ``device``, cached."""
        key = (name, str(device))
        if key not in self._on_device:
            a = getattr(self, name)
            dtype = torch.complex64 if a.dtype == np.complex64 else torch.int64
            self._on_device[key] = torch.as_tensor(a, dtype=dtype,
                                                   device=device)
        return self._on_device[key]
