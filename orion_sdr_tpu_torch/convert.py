"""Build the port's graph, config and state objects from plain fields, such
as ``dataclasses.asdict`` gives for the JAX package's objects or a JAX
state NamedTuple with its leaves as numpy arrays (numpy arrays, nested
dicts or NamedTuples; nothing of that package is imported here). With the
state converters a capture begun in one package finishes in the other
with the same output."""

from __future__ import annotations

import numpy as np
import torch

from .fec.ldpc import LdpcGraph
from .message import CallsignHashTable, hash22
from .frame.types import (InnerFec, InterleaverKind, Mcs, McsTable, OuterFec,
                          ScramblerKind)
from .multicarrier import CarrierPlan, TxLowpass
from .ofdm import OfdmConfig
from .sync.ofdm_sync import OfdmPreamble, TrainingSymbol
from .waveform.dvb_t import DvbTFrameParams, DvbTLinkParams
from .codec.psk31 import StreamingViterbi
from .codec.psk31_stream import Psk31Stream
from .demodulate.afsk import Afsk1200Stream
from .demodulate.analog import QuadDemodState, SsbDemodState
from .dsp.channelizer import Channelizer
from .dsp.iir import BiquadState, LpDcState
from .modulate.analog import CwState, FmState, SsbState
from . import blocks as _blocks


def ldpc_graph_from_fields(d: dict) -> LdpcGraph:
    m, D = int(d["m"]), int(d["max_deg"])
    return LdpcGraph(
        name=str(d["name"]), n=int(d["n"]), k=int(d["k"]), m=m,
        A=np.asarray(d["A"], np.uint8),
        check_bits=np.asarray(d["check_bits"], np.int32).reshape(m, D),
        check_mask=np.asarray(d["check_mask"], bool).reshape(m, D),
        max_deg=D)


def callsign_hash_table_from_fields(entries) -> CallsignHashTable:
    """A JAX ``CallsignHashTable``'s entries (its ``n22 → call`` mapping)
    → the port's table with the same entries, so a stream decoder's hashed
    calls move from one package to the other. Raises ValueError for an
    entry whose call does not hash to its key."""
    ht = CallsignHashTable()
    for n22, call in dict(entries).items():
        if hash22(str(call)) != int(n22):
            raise ValueError(f"call {call!r} does not hash to {int(n22)}")
        ht.save(str(call))
    return ht


def carrier_plan_from_fields(d: dict) -> CarrierPlan:
    return CarrierPlan(
        n_fft=int(d["n_fft"]), cp_len=int(d["cp_len"]),
        data_carriers=tuple(int(i) for i in d["data_carriers"]),
        pilot_carriers=tuple((int(i), complex(v))
                             for i, v in d["pilot_carriers"]),
        window_roll_off=int(d["window_roll_off"]))


def ofdm_config_from_fields(d: dict) -> OfdmConfig:
    fields = dict(d)
    fields["carrier_plan"] = carrier_plan_from_fields(d["carrier_plan"])
    if d.get("tx_lowpass") is not None:
        fields["tx_lowpass"] = TxLowpass(**d["tx_lowpass"])
    for name, cls in (("outer_fec", OuterFec), ("inner_fec", InnerFec),
                      ("outer_interleaver", InterleaverKind),
                      ("inner_interleaver", InterleaverKind),
                      ("scrambler", ScramblerKind)):
        if fields.get(name) is not None:
            fields[name] = cls(**fields[name])
    return OfdmConfig(**fields)


def mcs_table_from_fields(d: dict) -> McsTable:
    return McsTable([Mcs(e["constellation"], InnerFec(**e["inner_fec"]),
                         OuterFec(**e["outer_fec"])) for e in d["entries"]])


def preamble_from_fields(d: dict) -> OfdmPreamble:
    t = d.get("training_symbol")
    return OfdmPreamble(int(d["num_repeats"]), int(d["repeat_len"]),
                        TrainingSymbol(**t) if t is not None else None)


def dvb_t_link_params_from_fields(d: dict) -> DvbTLinkParams:
    return DvbTLinkParams(guard=str(d["guard"]),
                          constellation=str(d["constellation"]),
                          code_rate=str(d["code_rate"]))


def dvb_t_frame_params_from_fields(d: dict) -> DvbTFrameParams:
    return DvbTFrameParams(link=dvb_t_link_params_from_fields(d["link"]),
                           frame_number=int(d["frame_number"]),
                           cell_id=int(d["cell_id"]))


# ── DSP / analog states (JAX state NamedTuples with numpy leaves) ────────────


def _fields(obj) -> dict:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _t(v, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(v), dtype=dtype, device=device)


def biquad_state_from_fields(d, device="cuda") -> BiquadState:
    d = _fields(d)
    x_tail = np.asarray(d["x_tail"])
    return BiquadState(sp=_t(d["sp"], device, torch.complex64),
                       x_tail=_t(x_tail, device, torch.complex64
                                 if np.iscomplexobj(x_tail)
                                 else torch.float32))


def _biquad_pair(pair, device) -> tuple:
    return tuple(biquad_state_from_fields(b, device) for b in pair)


def lp_dc_state_from_fields(d, device="cuda") -> LpDcState:
    d = _fields(d)
    return LpDcState(bq=_biquad_pair(d["bq"], device),
                     dc=_t(d["dc"], device, torch.float32))


def quad_demod_state_from_fields(d, device="cuda") -> QuadDemodState:
    """``fm_demod`` / ``pm_demod`` state."""
    d = _fields(d)
    return QuadDemodState(prev=_t(d["prev"], device, torch.complex64),
                          lp=_biquad_pair(d["lp"], device),
                          xlate_phase=_t(d["xlate_phase"], device,
                                         torch.float32))


def ssb_demod_state_from_fields(d, device="cuda") -> SsbDemodState:
    d = _fields(d)
    return SsbDemodState(filt=lp_dc_state_from_fields(d["filt"], device),
                         bfo_phase=_t(d["bfo_phase"], device, torch.float32))


def ssb_state_from_fields(d, device="cuda") -> SsbState:
    """``ssb_mod`` state."""
    d = _fields(d)
    return SsbState(lp_i=_biquad_pair(d["lp_i"], device),
                    lp_q=_biquad_pair(d["lp_q"], device),
                    aud_phase=_t(d["aud_phase"], device, torch.float32),
                    rf_phase=_t(d["rf_phase"], device, torch.float32))


def cw_state_from_fields(d, device="cuda") -> CwState:
    d = _fields(d)
    return CwState(env=_t(d["env"], device, torch.float32),
                   phase=_t(d["phase"], device, torch.float32))


def fm_state_from_fields(d, device="cuda") -> FmState:
    d = _fields(d)
    return FmState(phase=_t(d["phase"], device, torch.float32),
                   rf_phase=_t(d["rf_phase"], device, torch.float32))


def psk31_stream_from_fields(d: dict, device="cuda") -> Psk31Stream:
    """A JAX ``Psk31Stream``'s attributes (``vars(stream)``, with ``vdec``
    and ``viterbi`` given as their own ``vars``, or ``viterbi`` None) → the
    port's stream in the same state: the buffered samples, the down-mix
    phase (samples mixed so far), the PLL carry (previous symbol, phase
    accumulator), the varicode decoder and the QPSK Viterbi's metrics and
    path memory."""
    st = Psk31Stream(float(d["fs"]), float(d["carrier_hz"]),
                     float(d["gain"]), qpsk=bool(d["qpsk"]), device=device)
    st._buf = np.asarray(d["_buf"], np.complex64).copy()
    st._fed_up_to = int(d["_fed_up_to"])
    st._n_mixed = int(d["_n_mixed"])
    st._prev_sym = complex(d["_prev_sym"])
    st._phase_acc = float(d["_phase_acc"])
    v = dict(d["vdec"])
    st.vdec.shift, st.vdec.len = int(v["shift"]), int(v["len"])
    st.vdec.prev_zero = bool(v["prev_zero"])
    st.vdec.chars.extend(int(c) for c in v["chars"])
    if d.get("viterbi") is not None:
        w = dict(d["viterbi"])
        sv = StreamingViterbi(np.asarray(w["_exp"], np.complex64))
        sv.pm = np.asarray(w["pm"], np.float32).copy()
        sv.history = np.asarray(w["history"], np.int32).copy()
        sv.ptr, sv.count = int(w["ptr"]), int(w["count"])
        st.viterbi = sv
    return st


def channelizer_from_jax(d: dict, device="cuda") -> Channelizer:
    """The port's :class:`Channelizer` on ``device`` from a JAX package's
    ``Channelizer``'s fields (``vars(ch)``): its rates, centers and taps,
    carried mixer phases, FIR tails and input remainder, so a stream that
    the JAX channelizer began continues in the port to the same output."""
    ch = Channelizer(float(d["fs_wide"]), float(d["fs_out"]),
                     np.asarray(d["centers_hz"], np.float32), device=device)
    ch.taps = np.asarray(d["taps"], np.float32).copy()
    ch._phase = _t(d["_phase"], device, torch.float32)
    ch._state = _t(d["_state"], device, torch.complex64)
    ch._rem = _t(d["_rem"], device, torch.complex64)
    return ch


def afsk1200_stream_from_jax(d: dict, device="cuda") -> Afsk1200Stream:
    """The port's :class:`Afsk1200Stream` on ``device`` from a JAX package's
    ``Afsk1200Stream``'s fields (``vars(stream)``): its rate, the buffered
    audio, the absolute bit index of the buffer's start and the bit index
    committed so far, so a stream the JAX TNC began continues in the port
    and gives each frame once."""
    st = Afsk1200Stream(float(d["fs"]), device=device)
    st._buf = np.asarray(d["_buf"], np.float32).copy()
    st._base_bits = int(d["_base_bits"])
    st._emitted_to = int(d["_emitted_to"])
    return st


# ── the drop-in blocks (``blocks.py``) ──────────────────────────────────────


def _psk31_demod(block, d: dict) -> None:
    block._leftover = np.asarray(d["_leftover"], np.complex64).copy()
    block._n_mixed = int(d["_n_mixed"])
    block._prev_sym = complex(np.asarray(d["_prev_sym"]).reshape(()))
    block._phase_acc = float(np.asarray(d["_phase_acc"]).reshape(()))


def bpsk31_demod_from_jax(d: dict, device="cuda") -> "_blocks.Bpsk31Demod":
    """The port's :class:`~orion_sdr_tpu_torch.blocks.Bpsk31Demod` on
    ``device`` from a JAX ``Bpsk31Demod``'s fields (``vars(block)``): the
    leftover samples, the samples mixed so far (the down-mix phase), the
    previous symbol and the phase accumulator of the PLL."""
    b = _blocks.Bpsk31Demod(float(d["fs"]), float(d["rf_hz"]),
                            float(d["gain"]), device=device)
    _psk31_demod(b, d)
    return b


def qpsk31_demod_from_jax(d: dict, device="cuda") -> "_blocks.Qpsk31Demod":
    """:func:`bpsk31_demod_from_jax` for ``Qpsk31Demod``, with the
    differential pairs buffered for ``flush``'s Viterbi."""
    b = _blocks.Qpsk31Demod(float(d["fs"]), float(d["rf_hz"]),
                            float(d["gain"]), device=device)
    _psk31_demod(b, d)
    b._pairs = [np.asarray(p, np.float32).copy() for p in d["_pairs"]]
    return b


def _or_none(conv, state, device):
    return None if state is None else conv(state, device)


def fm_quadrature_demod_from_jax(d: dict, device="cuda"
                                 ) -> "_blocks.FmQuadratureDemod":
    """The port's ``FmQuadratureDemod`` from a JAX one's fields, its
    ``QuadDemodState`` (previous sample, LP cascade, translate phase)
    carried over."""
    b = _blocks.FmQuadratureDemod(float(d["fs"]), float(d["dev_hz"]),
                                  float(d["audio_bw_hz"]), device=device)
    b._state = _or_none(quad_demod_state_from_fields, d["_state"], device)
    return b


def pm_quadrature_demod_from_jax(d: dict, device="cuda"
                                 ) -> "_blocks.PmQuadratureDemod":
    """The port's ``PmQuadratureDemod`` from a JAX one's fields."""
    b = _blocks.PmQuadratureDemod(float(d["fs"]), float(d["k"]),
                                  float(d["audio_bw_hz"]), device=device)
    b._state = _or_none(quad_demod_state_from_fields, d["_state"], device)
    return b


def ssb_product_demod_from_jax(d: dict, device="cuda"
                               ) -> "_blocks.SsbProductDemod":
    """The port's ``SsbProductDemod`` from a JAX one's fields, its
    ``SsbDemodState`` (LP + DC filter, BFO phase) carried over."""
    b = _blocks.SsbProductDemod(float(d["fs"]), float(d["bfo_hz"]),
                                float(d["audio_bw_hz"]), device=device)
    b._state = _or_none(ssb_demod_state_from_fields, d["_state"], device)
    return b


def am_envelope_demod_from_jax(d: dict, device="cuda"
                               ) -> "_blocks.AmEnvelopeDemod":
    """The port's ``AmEnvelopeDemod`` from a JAX one's fields, its LP + DC
    ``LpDcState`` carried over."""
    b = _blocks.AmEnvelopeDemod(float(d["fs"]), float(d["audio_bw_hz"]),
                                d["method"] == "abs_approx", device=device)
    b._state = _or_none(lp_dc_state_from_fields, d["_state"], device)
    return b


def cw_envelope_demod_from_jax(d: dict, device="cuda"
                               ) -> "_blocks.CwEnvelopeDemod":
    """The port's ``CwEnvelopeDemod`` from a JAX one's fields: the gain and
    the envelope lowpass's carried output."""
    b = _blocks.CwEnvelopeDemod(float(d["fs"]), float(d["tone_hz"]),
                                float(d["env_bw_hz"]), device=device)
    b.gain = float(d["gain"])
    b._y = _t(d["_y"], device, torch.float32)
    return b
