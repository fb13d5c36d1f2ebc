"""FT8 character tables (counterpart of ``orion_sdr_tpu/message/tables.py``;
behavioral spec: message/tables.rs; alphabets from
the public FT8 protocol / ft8_lib ft8_char_table_e)."""

FULL = "full"                       # 42: " 0-9A-Z+-./?"
ALNUM_SPACE_SLASH = "alnum_space_slash"  # 38: " 0-9A-Z/"
ALNUM_SPACE = "alnum_space"         # 37: " 0-9A-Z"
LETTERS_SPACE = "letters_space"     # 27: " A-Z"
ALNUM = "alnum"                     # 36: "0-9A-Z"
NUMERIC = "numeric"                 # 10: "0-9"

_DIGITS = "0123456789"
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"

_ALPHABETS = {
    FULL: " " + _DIGITS + _LETTERS + "+-./?",
    ALNUM_SPACE_SLASH: " " + _DIGITS + _LETTERS + "/",
    ALNUM_SPACE: " " + _DIGITS + _LETTERS,
    LETTERS_SPACE: " " + _LETTERS,
    ALNUM: _DIGITS + _LETTERS,
    NUMERIC: _DIGITS,
}


def nchar(c: str, table: str):
    """Index of character ``c`` in ``table``, or None."""
    i = _ALPHABETS[table].find(c)
    return None if i < 0 else i


def charn(n: int, table: str) -> str:
    """Character at index ``n`` in ``table``."""
    a = _ALPHABETS[table]
    return a[n] if 0 <= n < len(a) else "?"


def table_size(table: str) -> int:
    return len(_ALPHABETS[table])
