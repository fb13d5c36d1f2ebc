"""FT8/FT4 77-bit message packing: the port's own copy of the pure-Python
``orion_sdr_tpu/message`` package (host code, bit-exact with it; the JAX
package's ``__init__`` imports JAX, so nothing of it is imported here)."""

from .tables import nchar, charn
from .callsign import (
    CallsignHashTable, hash22, pack_basecall, pack28, unpack28,
    pack58, unpack58, NTOKENS, MAX22,
)
from .grid import packgrid, unpackgrid, MAXGRID4
from .free_text import encode_free_text, decode_free_text
from .message import (
    Ft8Message, Standard, FreeText, NonStd, Telemetry, Unknown,
    pack77, unpack77,
    ft8_pack_standard, ft8_pack_free_text, ft8_pack_telemetry, ft8_unpack,
)
