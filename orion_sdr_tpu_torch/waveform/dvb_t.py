"""DVB-T 2K waveform definitions (counterpart of
``orion_sdr_tpu/waveform/dvb_t.py``; parameters from ETSI EN 300 744).

Tables (energy-dispersal PRBS, Figure-9a axes, pilot and TPS carriers, the
four scattered-pilot phases) are host numpy built once; mapping, soft
demapping and the rotating-grid scatter/gather run on the device of the
tensors they are given, whole frames at a time. The COFDM presets
``dvb_t_config`` and ``dvb_t_scattered_config`` give the 2K grid as an
``OfdmConfig`` for the generic links.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..dsp.device import takes_host_data
from ..multicarrier import CarrierPlan

# ── energy dispersal (EN 300 744 §4.3.1) ─────────────────────────────────────

# PRBS 1 + X^14 + X^15, init 100101010000000, output = feedback bit; the
# first 8 output bits pack to 0x03
DVB_T_PRBS_INIT = 0b100101010000000


@lru_cache(maxsize=32)
def dvb_t_prbs_bits(n_bits: int, init: int = DVB_T_PRBS_INIT) -> np.ndarray:
    """First ``n_bits`` of the energy-dispersal PRBS as uint8 bits."""
    reg = init
    out = np.empty(n_bits, np.uint8)
    for i in range(n_bits):
        fb = ((reg >> 1) ^ reg) & 1
        out[i] = fb
        reg = (reg >> 1) | (fb << 14)
    return out


@lru_cache(maxsize=32)
def dvb_t_prbs_bytes(n_bytes: int, init: int = DVB_T_PRBS_INIT) -> np.ndarray:
    return np.packbits(dvb_t_prbs_bits(n_bytes * 8, init))


def energy_disperse(data, skip_first: int = 0) -> np.ndarray:
    """XOR the dispersal PRBS over ``data`` bytes (self-inverse);
    ``skip_first`` clocks the PRBS over that many leading bytes first."""
    d = np.asarray(data, np.uint8)
    pn = dvb_t_prbs_bytes(skip_first + d.shape[-1])
    return d ^ pn[skip_first:]


# ── Figure-9a constellation (EN 300 744 §4.3.5) ──────────────────────────────

# per-axis levels, index = axis bits MSB-first (even y-bits → I, odd → Q)
DVB_T_AXIS = {
    2: np.array([1, -1], np.float32),
    4: np.array([3, 1, -3, -1], np.float32),
    6: np.array([7, 5, 1, 3, -7, -5, -1, -3], np.float32),
}
_DVB_ORDERS = {"qpsk": 2, "qam16": 4, "qam64": 6}
# non-uniform (hierarchical) grids shift every level outward by α − 1
DVB_T_ALPHAS = (1, 2, 4)


def dvb_t_axis(v: int, alpha: int = 1) -> np.ndarray:
    """Per-axis level table: sign(u)·(|u| + α − 1)."""
    if alpha not in DVB_T_ALPHAS:
        raise ValueError(f"alpha must be one of {DVB_T_ALPHAS}, got {alpha}")
    if alpha != 1 and v == 2:
        raise ValueError("hierarchical alpha applies to 16-/64-QAM only")
    u = DVB_T_AXIS[v]
    return (np.sign(u) * (np.abs(u) + (alpha - 1))).astype(np.float32)


def axis_scale(v: int, alpha: int = 1) -> float:
    """1/√(2·E[axis²]): unit mean symbol energy."""
    if alpha == 1:
        m = 1 << (v // 2)
        return 1.0 / np.sqrt(2.0 * (m * m - 1) / 3.0)
    mags = np.abs(dvb_t_axis(v, alpha)).astype(np.float64)
    return float(1.0 / np.sqrt(2.0 * np.mean(mags * mags)))


def is_dvb_t_constellation(order: str) -> bool:
    return order in _DVB_ORDERS


@lru_cache(maxsize=8)
def _point_table(v: int, alpha: int = 1) -> np.ndarray:
    """(2^v,) complex64: the point of each v-bit label y0..y(v−1)."""
    table = dvb_t_axis(v, alpha)
    scale = axis_scale(v, alpha)
    labels = np.arange(1 << v)
    i_idx = np.zeros(1 << v, np.int64)
    q_idx = np.zeros(1 << v, np.int64)
    for j in range(v // 2):
        i_idx = (i_idx << 1) | ((labels >> (v - 1 - 2 * j)) & 1)
        q_idx = (q_idx << 1) | ((labels >> (v - 2 - 2 * j)) & 1)
    return ((table[i_idx] + 1j * table[q_idx]) * scale).astype(np.complex64)


@takes_host_data("bits")
def dvb_t_map_symbols(bits: torch.Tensor, v: int, alpha: int = 1
                      ) -> torch.Tensor:
    """(..., n·v) bits → (..., n) complex64 points. Each axis is
    sign(MSB)·(M−1 − 2·gray_decode(rest) + α−1)·scale, in bit arithmetic."""
    b = bits.to(torch.int32) & 1
    g = b.reshape(b.shape[:-1] + (-1, v))
    k = v // 2
    m = 1 << k
    scale = axis_scale(v, alpha)
    shifts = torch.arange(k - 1, -1, -1, dtype=torch.int32, device=b.device)

    def axis_val(ab):
        idx = torch.sum(ab << shifts, dim=-1, dtype=torch.int32)
        sign = 1 - 2 * (idx >> (k - 1))
        low = idx & ((1 << max(k - 1, 0)) - 1)
        gd = low ^ (low >> 1)
        gd = gd ^ (gd >> 2)
        return (sign * (m - 1 - 2 * gd + (alpha - 1))).to(torch.float32) \
            * scale

    return torch.complex(axis_val(g[..., 0::2]), axis_val(g[..., 1::2]))


def dvb_t_map_symbol(bits):
    """One symbol's v bits → its complex point (a Python complex), or None
    when v is not a DVB-T order."""
    b = np.asarray(bits.cpu() if isinstance(bits, torch.Tensor) else bits)
    if len(b) not in DVB_T_AXIS:
        return None
    return complex(dvb_t_map_symbols(torch.as_tensor(b), len(b))[0])


@takes_host_data("syms")
def dvb_t_demap_symbols(syms: torch.Tensor, v: int, alpha: int = 1
                        ) -> torch.Tensor:
    """Hard nearest-point inverse → (..., n·v) uint8 bits."""
    table = torch.as_tensor(dvb_t_axis(v, alpha) * axis_scale(v, alpha),
                            dtype=torch.float32, device=syms.device)
    k = v // 2
    i_idx = torch.argmin((syms.real[..., None] - table).abs(), dim=-1)
    q_idx = torch.argmin((syms.imag[..., None] - table).abs(), dim=-1)
    shifts = torch.arange(k - 1, -1, -1, device=syms.device)
    ib = (i_idx[..., None] >> shifts) & 1
    qb = (q_idx[..., None] >> shifts) & 1
    return torch.stack([ib, qb], dim=-1).reshape(syms.shape[:-1] + (-1,)) \
        .to(torch.uint8)


@takes_host_data("syms")
def dvb_t_soft_llrs(syms: torch.Tensor, v: int, alpha: int = 1
                    ) -> torch.Tensor:
    """Max-log LLRs in y0..y(v−1) order, positive ⇒ bit 0: (..., n) →
    (..., n·v) float32."""
    table = torch.as_tensor(dvb_t_axis(v, alpha) * axis_scale(v, alpha),
                            dtype=torch.float32, device=syms.device)
    k = v // 2
    idx = np.arange(len(DVB_T_AXIS[v]))
    inf = torch.tensor(float("inf"), device=syms.device)

    def axis_llrs(coord):
        d2 = (coord[..., None] - table) ** 2
        outs = []
        for b in range(k):
            bit1 = torch.as_tensor(((idx >> (k - 1 - b)) & 1) == 1,
                                   device=syms.device)
            d0 = torch.where(~bit1, d2, inf).amin(-1)
            d1 = torch.where(bit1, d2, inf).amin(-1)
            outs.append(d1 - d0)
        return outs

    il = axis_llrs(syms.real)
    ql = axis_llrs(syms.imag)
    inter = []
    for j in range(k):
        inter += [il[j], ql[j]]
    return torch.stack(inter, dim=-1).reshape(syms.shape[:-1] + (-1,)) \
        .to(torch.float32)


# ── 2K numerology (EN 300 744 §4.4-4.5) ──────────────────────────────────────

DVB_T_N_FFT = 2048
DVB_T_KMAX = 1704
DVB_T_ACTIVE_CARRIERS = DVB_T_KMAX + 1          # 1705
DVB_T_DATA_CARRIERS = 1512
_CENTER = DVB_T_KMAX // 2                        # 852

# Table 7 (2K): the 45 continual-pilot active-carrier indices
DVB_T_CONTINUAL_PILOTS_2K = np.array([
    0, 48, 54, 87, 141, 156, 192, 201, 255, 279, 282, 333, 432, 450, 483,
    525, 531, 618, 636, 714, 759, 765, 780, 804, 873, 888, 918, 939, 942,
    969, 984, 1050, 1101, 1107, 1110, 1137, 1140, 1146, 1206, 1269, 1323,
    1377, 1491, 1683, 1704], np.int64)

# Table 8 (2K): the 17 TPS carrier indices
DVB_T_TPS_CARRIERS_2K = np.array([
    34, 50, 209, 346, 413, 569, 595, 688, 790, 901, 1073, 1219, 1262, 1286,
    1469, 1594, 1687], np.int64)

DVB_T_SCATTERED_PHASES = 4
DVB_T_SCATTERED_PILOT_SPACING = 12
DVB_T_MAX_RX_WINDOW_BACKOFF = DVB_T_N_FFT // (2 * DVB_T_SCATTERED_PILOT_SPACING)

GUARD_INTERVALS = {"1/32": 64, "1/16": 128, "1/8": 256, "1/4": 512}


def guard_cp_len_2k(guard: str) -> int:
    return GUARD_INTERVALS[guard]


def guard_from_cp_len_2k(cp_len: int):
    for g, c in GUARD_INTERVALS.items():
        if c == cp_len:
            return g
    return None


def active_to_signed(a) -> np.ndarray:
    """Active index (0..=1704) → DC-centred signed carrier (a − 852)."""
    return np.asarray(a, np.int64) - _CENTER


def active_to_bin(a) -> np.ndarray:
    """Active index → FFT bin (a − 852) mod 2048."""
    return active_to_signed(a) % DVB_T_N_FFT


@lru_cache(maxsize=4)
def wk_prbs(length: int = DVB_T_ACTIVE_CARRIERS) -> np.ndarray:
    """Reference PRBS w_k (§4.5.2): X^11 + X^2 + 1, all-ones init."""
    reg = 0x7FF
    out = np.empty(length, np.uint8)
    for i in range(length):
        out[i] = (reg >> 10) & 1
        fb = ((reg >> 10) ^ (reg >> 1)) & 1
        reg = ((reg << 1) | fb) & 0x7FF
    return out


def boosted_pilot_value(wk) -> np.ndarray:
    """±4/3 real pilot: 4/3·2·(1/2 − w_k)."""
    return ((4.0 / 3.0) * 2.0 * (0.5 - np.asarray(wk, np.float32))
            ).astype(np.complex64)


def scattered_pilot_indices(phase: int) -> np.ndarray:
    """Active indices with k mod 12 == 3·(phase mod 4)."""
    start = 3 * (phase % DVB_T_SCATTERED_PHASES)
    return np.arange(start, DVB_T_KMAX + 1, DVB_T_SCATTERED_PILOT_SPACING,
                     dtype=np.int64)


def tps_carrier_bins() -> np.ndarray:
    return active_to_bin(DVB_T_TPS_CARRIERS_2K)


def continual_pilot_bins() -> np.ndarray:
    return active_to_bin(DVB_T_CONTINUAL_PILOTS_2K)


def dvb_t_2k_plan(guard: str) -> CarrierPlan:
    """Continual pilots only; every other active carrier carries data."""
    wk = wk_prbs()
    pilots = [(int(active_to_signed(a)), complex(boosted_pilot_value(wk[a])))
              for a in DVB_T_CONTINUAL_PILOTS_2K]
    pset = set(DVB_T_CONTINUAL_PILOTS_2K.tolist())
    data = [int(active_to_signed(a)) for a in range(DVB_T_KMAX + 1)
            if a not in pset]
    return CarrierPlan(DVB_T_N_FFT, guard_cp_len_2k(guard)) \
        .with_data_carriers(data).with_pilot_carriers(pilots)


@dataclass(frozen=True)
class ScatteredGrid:
    """Per-phase arrays of the rotating grid: data_bins (4, 1512); per
    phase the pilot bins (continual + scattered + TPS) with their values,
    and the channel references (TPS excluded: the modulator overwrites TPS
    bins with data-power DBPSK)."""
    data_bins: np.ndarray
    pilot_bins: tuple
    pilot_vals: tuple
    ref_bins: tuple
    ref_vals: tuple


@lru_cache(maxsize=2)
def scattered_grid() -> ScatteredGrid:
    wk = wk_prbs()
    tps_set = set(DVB_T_TPS_CARRIERS_2K.tolist())
    data_bins, pilot_bins, pilot_vals, ref_bins, ref_vals = [], [], [], [], []
    for phase in range(DVB_T_SCATTERED_PHASES):
        reserved = np.array(sorted(
            set(DVB_T_CONTINUAL_PILOTS_2K.tolist())
            | set(scattered_pilot_indices(phase).tolist()) | tps_set),
            np.int64)
        rset = set(reserved.tolist())
        data = np.array([a for a in range(DVB_T_KMAX + 1) if a not in rset],
                        np.int64)
        if len(data) != DVB_T_DATA_CARRIERS:
            raise AssertionError((phase, len(data)))
        data_bins.append(active_to_bin(data))
        pilot_bins.append(active_to_bin(reserved))
        pilot_vals.append(boosted_pilot_value(wk[reserved]))
        refs = np.array([a for a in reserved if a not in tps_set], np.int64)
        ref_bins.append(active_to_bin(refs))
        ref_vals.append(boosted_pilot_value(wk[refs]))
    return ScatteredGrid(np.stack(data_bins), tuple(pilot_bins),
                         tuple(pilot_vals), tuple(ref_bins), tuple(ref_vals))


def dvb_t_2k_plans(guard: str):
    """The four symbol-phase plans; each carries exactly 1512 data."""
    g = scattered_grid()
    plans = []
    for phase in range(DVB_T_SCATTERED_PHASES):
        signed_data = ((g.data_bins[phase] + _CENTER) % DVB_T_N_FFT) - _CENTER
        signed_pilot = ((np.asarray(g.pilot_bins[phase]) + _CENTER)
                        % DVB_T_N_FFT) - _CENTER
        plans.append(
            CarrierPlan(DVB_T_N_FFT, guard_cp_len_2k(guard))
            .with_data_carriers(signed_data.tolist())
            .with_pilot_carriers(list(zip(signed_pilot.tolist(),
                                          np.asarray(g.pilot_vals[phase])))))
    return plans


def _phase_symbols(n_sym: int, first_phase: int, phase: int) -> np.ndarray:
    s = np.arange(n_sym)
    return s[(s + first_phase) % DVB_T_SCATTERED_PHASES == phase]


@takes_host_data("data_syms")
def scattered_map_frame(data_syms: torch.Tensor, first_phase: int = 0
                        ) -> torch.Tensor:
    """TX: (..., n_sym, 1512) data points → (..., n_sym, 2048) frequency
    grids with the phase-rotating pilots inserted."""
    g = scattered_grid()
    d = data_syms.to(torch.complex64)
    dev = d.device
    freq = d.new_zeros(d.shape[:-1] + (DVB_T_N_FFT,))
    for phase in range(DVB_T_SCATTERED_PHASES):
        syms = _phase_symbols(d.shape[-2], first_phase, phase)
        if len(syms) == 0:
            continue
        s = torch.as_tensor(syms, device=dev)
        sub = d.new_zeros(d.shape[:-2] + (len(syms), DVB_T_N_FFT))
        sub[..., torch.as_tensor(g.data_bins[phase], device=dev)] = d[..., s, :]
        sub[..., torch.as_tensor(g.pilot_bins[phase], device=dev)] = \
            torch.as_tensor(g.pilot_vals[phase], device=dev)
        freq[..., s, :] = sub
    return freq


@takes_host_data("freq")
def scattered_extract_frame(freq: torch.Tensor, first_phase: int = 0
                            ) -> torch.Tensor:
    """RX: (..., n_sym, 2048) equalised grids → (..., n_sym, 1512) data."""
    g = scattered_grid()
    dev = freq.device
    out = freq.new_zeros(freq.shape[:-1] + (DVB_T_DATA_CARRIERS,))
    for phase in range(DVB_T_SCATTERED_PHASES):
        syms = _phase_symbols(freq.shape[-2], first_phase, phase)
        if len(syms) == 0:
            continue
        s = torch.as_tensor(syms, device=dev)
        out[..., s, :] = freq[..., s, :][
            ..., torch.as_tensor(g.data_bins[phase], device=dev)]
    return out


# ── bandwidth / sample-rate scaling (NB-DVB-T) ───────────────────────────────


def dvb_t_fs_for_bandwidth(occupied_hz: float) -> float:
    """fs = occupied bandwidth · 2048/1705."""
    return occupied_hz * DVB_T_N_FFT / DVB_T_ACTIVE_CARRIERS


def dvb_t_occupied_bw(fs: float) -> float:
    return fs * DVB_T_ACTIVE_CARRIERS / DVB_T_N_FFT


NB_BANDWIDTHS = {"333k": 333_000.0, "1m": 1_000_000.0, "2m": 2_000_000.0}
DVB_T_FS_333KHZ = dvb_t_fs_for_bandwidth(333_000.0)
DVB_T_FS_1MHZ = dvb_t_fs_for_bandwidth(1_000_000.0)
DVB_T_FS_2MHZ = dvb_t_fs_for_bandwidth(2_000_000.0)


# ── link assembly ────────────────────────────────────────────────────────────


def dvb_t_mcs_table():
    """QPSK r1/2, QPSK r2/3, 16-QAM r3/4, all with the RS(204,188) outer
    code."""
    from ..frame.types import Mcs, McsTable, OuterFec, InnerFec
    rs = OuterFec.reed_solomon(204, 16)
    return McsTable([Mcs("qpsk", InnerFec.convolutional("1/2", "dvb_k7"), rs),
                     Mcs("qpsk", InnerFec.convolutional("2/3", "dvb_k7"), rs),
                     Mcs("qam16", InnerFec.convolutional("3/4", "dvb_k7"),
                         rs)])


def dvb_t_config(guard: str, occupied_hz: float):
    """Continual-pilot DVB-T link config for the COFDM frame layer."""
    return _config_with_plan(dvb_t_2k_plan(guard), occupied_hz)


def dvb_t_scattered_config(guard: str, occupied_hz: float):
    """Conformant scattered-pilot link config (phase-0 representative
    plan)."""
    return _config_with_plan(dvb_t_2k_plans(guard)[0], occupied_hz) \
        .with_dvb_t_scattered(True)


def _config_with_plan(plan: CarrierPlan, occupied_hz: float):
    from ..ofdm import OfdmConfig
    from ..frame.types import (InterleaverKind, ScramblerKind,
                               SCRAMBLER_BEFORE_OUTER)
    return OfdmConfig(plan, fs=dvb_t_fs_for_bandwidth(occupied_hz),
                      constellation="qpsk") \
        .with_scrambler(ScramblerKind.dvb_t_energy_dispersal()) \
        .with_scrambler_pos(SCRAMBLER_BEFORE_OUTER) \
        .with_outer_interleaver(InterleaverKind.convolutional(12, 17))


def dvb_t_frame_outer():
    from ..frame.types import OuterFec
    return OuterFec.reed_solomon(204, 16)


def dvb_t_frame_outer_il():
    from ..frame.types import InterleaverKind
    return InterleaverKind.convolutional(12, 17)


@dataclass(frozen=True)
class DvbTLinkParams:
    """Guard, constellation, inner code rate: constant across a link."""
    guard: str = "1/32"
    constellation: str = "qpsk"
    code_rate: str = "1/2"


@dataclass(frozen=True)
class DvbTFrameParams:
    """One conformant frame's transmission parameters."""
    link: DvbTLinkParams
    frame_number: int = 0
    cell_id: int = 0

    def inner(self):
        from ..frame.types import InnerFec
        return InnerFec.convolutional(self.link.code_rate, "dvb_k7")

    def tps_word(self):
        from .dvb_t_tps import TpsWord
        return TpsWord(frame_number=self.frame_number,
                       constellation=self.link.constellation,
                       code_rate_hp=self.link.code_rate,
                       guard=self.link.guard, cell_id=self.cell_id)

    def config(self):
        from ..ofdm import OfdmConfig
        plan0 = dvb_t_2k_plans(self.link.guard)[0]
        return OfdmConfig(plan0, fs=dvb_t_fs_for_bandwidth(1_000_000.0),
                          constellation=self.link.constellation) \
            .with_dvb_t_scattered(True)


@dataclass(frozen=True)
class DvbTHierLinkParams:
    """Hierarchical link constants (EN 300 744 §4.3.5/§5.1): non-uniform
    16-/64-QAM carrying two independently coded transport streams, HP on the
    2 quadrant MSBs (an embedded QPSK) and LP on the remaining v−2 bits.
    ``alpha`` ∈ {1, 2, 4} sets the quadrant separation (1 = uniform grid,
    hierarchy by multiplexing only)."""
    guard: str = "1/32"
    constellation: str = "qam16"     # qam16 | qam64
    alpha: int = 2
    code_rate_hp: str = "1/2"
    code_rate_lp: str = "3/4"

    def validate(self) -> None:
        if self.constellation not in ("qam16", "qam64"):
            raise ValueError("hierarchical DVB-T requires 16- or 64-QAM")
        if self.alpha not in DVB_T_ALPHAS:
            raise ValueError(f"alpha must be one of {DVB_T_ALPHAS}")


@dataclass(frozen=True)
class DvbTHierFrameParams:
    """One hierarchical frame's transmission parameters."""
    link: DvbTHierLinkParams
    frame_number: int = 0
    cell_id: int = 0

    def inner_hp(self):
        from ..frame.types import InnerFec
        return InnerFec.convolutional(self.link.code_rate_hp, "dvb_k7")

    def inner_lp(self):
        from ..frame.types import InnerFec
        return InnerFec.convolutional(self.link.code_rate_lp, "dvb_k7")

    def tps_word(self):
        from .dvb_t_tps import TpsWord
        return TpsWord(frame_number=self.frame_number,
                       constellation=self.link.constellation,
                       code_rate_hp=self.link.code_rate_hp,
                       guard=self.link.guard, cell_id=self.cell_id,
                       hierarchy=self.link.alpha,
                       code_rate_lp=self.link.code_rate_lp)


DVB_T_FRAMES_PER_SUPER_FRAME = 4


@dataclass(frozen=True)
class DvbTSuperFrameParams:
    """Link parameters and the full 16-bit cell id: b15..b8 ride frames 1
    and 3 (frame numbers 0 and 2), b7..b0 frames 2 and 4."""
    link: DvbTLinkParams
    cell_id: int = 0

    def frame(self, frame_number: int) -> DvbTFrameParams:
        cell_byte = (self.cell_id >> 8) & 0xFF if frame_number % 2 == 0 \
            else self.cell_id & 0xFF
        return DvbTFrameParams(link=self.link, frame_number=frame_number,
                               cell_id=cell_byte)
