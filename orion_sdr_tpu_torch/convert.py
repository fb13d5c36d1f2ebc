"""Build the port's graph and config objects from plain field dicts, such as
``dataclasses.asdict`` gives for the JAX package's objects (numpy arrays and
nested dicts; nothing of that package is imported here)."""

from __future__ import annotations

import numpy as np

from .fec.ldpc import LdpcGraph
from .message import CallsignHashTable, hash22
from .frame.types import (InnerFec, InterleaverKind, Mcs, McsTable, OuterFec,
                          ScramblerKind)
from .multicarrier import CarrierPlan, TxLowpass
from .ofdm import OfdmConfig
from .sync.ofdm_sync import OfdmPreamble, TrainingSymbol
from .waveform.dvb_t import DvbTFrameParams, DvbTLinkParams


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
