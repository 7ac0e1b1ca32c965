"""kua_roofline: the fine operator's K.u (`ops/structured.matvec`, kernel K2)
timed cold after the window, as a share of its least time on the card: the
larger of 2 x ndof x 8 bytes (u read once, K.u written once) over 3.35 TB/s
and its operations over the FP64 peak (`harness/roofline.py`) (%)."""


def read(record):
    k = record.get("kua")
    return 100.0 * k["bound_ms"] / k["cold_ms"] if k else None
