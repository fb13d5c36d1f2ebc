"""Torch port, FT8/FT4 host layers against the JAX package: the Gray maps,
CRC-14 (single frames on the host and the batched check on the device),
and 77-bit message packing (pack77/unpack77 over the cases of
tests/test_message_matrix.py and tests/test_ft8.py, hashed calls through a
CallsignHashTable, the ft8_pack_*/ft8_unpack wrappers), plus the hash table
carried across by ``convert.callsign_hash_table_from_fields``. Tolerance:
exact everywhere (bits, bytes and strings)."""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu import message as JM
from orion_sdr_tpu.codec import ft8_crc as jcrc, gray as jgray
from orion_sdr_tpu.message import callsign as jcs

from orion_sdr_tpu_torch import convert, message as TM
from orion_sdr_tpu_torch.codec import ft8_crc as tcrc, gray as tgray
from orion_sdr_tpu_torch.message import callsign as tcs

torch.set_num_threads(1)


def _fields(msg):
    """A decoded message as (type name, fields) with arrays as bytes."""
    d = dataclasses.asdict(msg)
    return type(msg).__name__, {k: bytes(np.asarray(v, np.uint8))
                                if isinstance(v, (np.ndarray, bytes))
                                else v for k, v in d.items()}


def test_gray_maps_equal():
    for name in ("FT8_GRAY", "FT4_GRAY", "FT8_GRAY_INV", "FT4_GRAY_INV"):
        assert np.array_equal(getattr(tgray, name), getattr(jgray, name))
    for i in range(8):
        assert tgray.gray8_encode(i) == jgray.gray8_encode(i)
        assert tgray.gray8_decode(i) == jgray.gray8_decode(i)
    for i in range(4):
        assert tgray.gray4_encode(i) == jgray.gray4_encode(i)
        assert tgray.gray4_decode(i) == jgray.gray4_decode(i)


def _payloads(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, (n, 10)).astype(np.uint8)
    p[:, 9] &= 0xF8
    p[0] = 0xFF
    p[1] = 0
    return p


def test_crc14_single_frames_equal():
    for p in _payloads(40, 1):
        a91 = tcrc.ft8_add_crc(p)
        assert np.array_equal(a91, jcrc.ft8_add_crc(p))
        assert tcrc.ft8_crc14(a91, 82) == jcrc.ft8_crc14(a91, 82)
        assert tcrc.ft8_extract_crc(a91) == jcrc.ft8_extract_crc(a91)
        assert tcrc.ft8_check_crc(a91) and jcrc.ft8_check_crc(a91)
        bad = a91.copy()
        bad[3] ^= 0x10
        assert tcrc.ft8_check_crc(bad) == jcrc.ft8_check_crc(bad) is False


def test_crc14_batched_check_equals_the_single_check():
    rng = np.random.default_rng(2)
    a91 = np.stack([jcrc.ft8_add_crc(p) for p in _payloads(200, 3)])
    bits = np.unpackbits(a91, axis=1)[:, :91]
    # one flipped bit anywhere in 0..90 (payload or CRC) on every other row,
    # two on every fifth
    for r in range(0, 200, 2):
        bits[r, rng.integers(0, 91)] ^= 1
    for r in range(0, 200, 5):
        bits[r, rng.choice(91, 2, replace=False)] ^= 1
    got = tcrc.ft8_check_crc_batch(torch.as_tensor(bits))
    assert got.dtype == torch.bool and got.shape == (200,)
    want = [jcrc.ft8_check_crc(np.packbits(np.concatenate(
        [b, np.zeros(5, np.uint8)]))) for b in bits]
    assert got.tolist() == want
    assert 0 < sum(want) < 200


def test_crc14_check_matrix_is_the_crc():
    h = tcrc.crc14_check_matrix()
    assert h.shape == (91, 14)
    for p in _payloads(20, 4):
        bits = np.unpackbits(jcrc.ft8_add_crc(p))[:91]
        assert not ((bits.astype(np.int64) @ h) & 1).any()


STANDARD = [
    ("CQ", "KA1ABC", "FN42"), ("KA1ABC", "W9XYZ", "-12"),
    ("W9XYZ", "KA1ABC", "R+03"), ("KA1ABC", "W9XYZ", "RR73"),
    ("K1ABC/R", "W9XYZ/R", "FN42"), ("CQ TEST", "K1ABC", "FN42"),
    ("CQ 013", "K1ABC", ""), ("K1ABC/P", "W9XYZ", "73"),
    ("DE", "G4AAA", "RRR"), ("QRZ", "9H1A", "JN58"),
    ("VK9ABC", "K1A", "R-07"), ("KA1ABC", "W9XYZ", "+03"),
    ("KA1ABC", "W9XYZ", "-15"), ("KA1ABC", "W9XYZ", "R+12"),
    ("3DA0XY", "3XA1BC", "AA00"), ("KA1ABC", "PJ4/K1ABC", "RR99"),
]


@pytest.mark.parametrize("fields", STANDARD)
def test_pack77_unpack77_standard(fields):
    jht, tht = JM.CallsignHashTable(), TM.CallsignHashTable()
    jp = JM.pack77(JM.Standard(*fields), jht)
    tp = TM.pack77(TM.Standard(*fields), tht)
    assert (jp is None) == (tp is None)
    if jp is not None:
        assert np.array_equal(tp, jp)
        assert _fields(TM.unpack77(tp, tht)) == _fields(JM.unpack77(jp, jht))
        # and across: a payload packed by either unpacks in the other
        assert _fields(TM.unpack77(jp, TM.CallsignHashTable())) == \
            _fields(JM.unpack77(tp, JM.CallsignHashTable()))
    assert tht._inner == jht._inner


OTHERS = [
    ("FreeText", ("TNX BOB 73 GL",)), ("FreeText", ("TNX 73",)),
    ("FreeText", ("R 579 MA",)), ("FreeText", ("A/B.C?1+2-3",)),
    ("FreeText", ("hello world this is too long",)),
    ("NonStd", ("CQ", "PJ4/K1ABC")), ("NonStd", ("W9XYZ", "PJ4/K1ABC",
                                                 "RR73")),
    ("NonStd", ("PJ4/KA1ABC", "W9XYZ", "")),
    ("Telemetry", (bytes.fromhex("123456789abcdef012"),)),
    ("Telemetry", (bytes(9),)), ("Telemetry", (bytes([0xFF] * 9),)),
]


@pytest.mark.parametrize("kind,args", OTHERS)
def test_pack77_unpack77_other_types(kind, args):
    jht, tht = JM.CallsignHashTable(), TM.CallsignHashTable()
    jp = JM.pack77(getattr(JM, kind)(*args), jht)
    tp = TM.pack77(getattr(TM, kind)(*args), tht)
    assert (jp is None) == (tp is None)
    if jp is not None:
        assert np.array_equal(tp, jp)
        assert _fields(TM.unpack77(tp, tht)) == _fields(JM.unpack77(jp, jht))
    assert tht._inner == jht._inner


def test_hashed_call_resolves_through_the_table():
    # the receiver resolves a hashed call only once it heard it in full
    payload = TM.pack77(TM.NonStd("PJ4/KA1ABC", "W9XYZ", ""),
                        TM.CallsignHashTable())
    jrx, trx = JM.CallsignHashTable(), TM.CallsignHashTable()
    assert _fields(TM.unpack77(payload, trx)) == \
        _fields(JM.unpack77(payload, jrx))
    assert "<" in TM.unpack77(payload, trx).call_to
    jrx.save("PJ4/KA1ABC")
    trx.save("PJ4/KA1ABC")
    warm = TM.unpack77(payload, trx)
    assert warm.call_to == "<PJ4/KA1ABC>" and warm.call_de == "W9XYZ"
    assert _fields(warm) == _fields(JM.unpack77(payload, jrx))
    jrx.save("K1ABC")
    for n12 in (0, 123, 4095, trx.save("K1ABC")[1],
                trx.save("PJ4/KA1ABC")[1]):
        assert trx.lookup_n12(n12) == jrx.lookup_n12(n12)


@pytest.mark.parametrize("call", ["K1A", "KA1ABC", "W9XYZ", "VK9ABC",
                                  "G4AAA", "9H1A", "CQ", "DE", "QRZ",
                                  "PJ4/K1ABC", "CQ DX", "CQ 123", "A"])
def test_callsign_packing_equal(call):
    jht, tht = JM.CallsignHashTable(), TM.CallsignHashTable()
    assert tcs.pack28(call, tht) == jcs.pack28(call, jht)
    assert tcs.pack_basecall(call) == jcs.pack_basecall(call)
    assert tcs.hash22(call) == jcs.hash22(call)
    assert tcs.pack58(call, tht) == jcs.pack58(call, jht)
    n28 = jcs.pack28(call, jht)
    if n28 is not None:
        assert tcs.unpack28(n28[0], n28[1], 1, tht) == \
            jcs.unpack28(n28[0], n28[1], 1, jht)
    assert tht._inner == jht._inner


def test_grid_and_free_text_equal():
    for extra in ["FN31", "AA00", "RR99", "+07", "-24", "R-12", "RRR",
                  "RR73", "73", "", "R FN31", "JN58"]:
        assert TM.packgrid(extra) == JM.packgrid(extra)
        assert TM.unpackgrid(*JM.packgrid(extra)) == \
            JM.unpackgrid(*JM.packgrid(extra))
    for text in ["TNX 73", "CQ DX", "A/B.C?1+2-3", "x", "TOO LONG TEXT X"]:
        a, b = TM.encode_free_text(text), JM.encode_free_text(text)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)
            assert TM.decode_free_text(a) == JM.decode_free_text(b)


def test_drop_in_wrappers_equal():
    assert TM.ft8_pack_standard("CQ", "KA1ABC", "FN42") == \
        JM.ft8_pack_standard("CQ", "KA1ABC", "FN42")
    assert TM.ft8_pack_free_text("TNX 73") == JM.ft8_pack_free_text("TNX 73")
    data = bytes.fromhex("123456789abcdef012")
    assert TM.ft8_pack_telemetry(data) == JM.ft8_pack_telemetry(data)
    for p in (JM.ft8_pack_standard("KA1ABC", "W9XYZ", "-12"),
              JM.ft8_pack_free_text("TNX 73"), JM.ft8_pack_telemetry(data),
              bytes(10)):
        assert TM.ft8_unpack(p) == JM.ft8_unpack(p)
    for bad in (lambda M: M.ft8_pack_free_text("X" * 14),
                lambda M: M.ft8_pack_telemetry(bytes(8)),
                lambda M: M.ft8_unpack(bytes(9))):
        for M in (TM, JM):
            with pytest.raises(ValueError):
                bad(M)


def test_callsign_hash_table_carried_across():
    jht = JM.CallsignHashTable()
    for call in ("PJ4/K1ABC", "KA1ABC", "W9XYZ/P", "3DA0XY"):
        jht.save(call)
    tht = convert.callsign_hash_table_from_fields(jht._inner)
    assert isinstance(tht, TM.CallsignHashTable)
    assert tht._inner == jht._inner
    payload = JM.pack77(JM.NonStd("PJ4/K1ABC", "W9XYZ"),
                        JM.CallsignHashTable())
    assert _fields(TM.unpack77(payload, tht)) == \
        _fields(JM.unpack77(payload, jht))
    assert TM.unpack77(payload, tht).call_to == "<PJ4/K1ABC>"
    with pytest.raises(ValueError):
        convert.callsign_hash_table_from_fields({1: "KA1ABC"})
