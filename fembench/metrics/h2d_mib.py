"""h2d_mib: the bytes that the program places on the card from host data
per deck (MiB/deck): its `h2d_bytes` counter over the run."""
from fembench.harness.spans import counter_per_deck


def read(record):
    v = counter_per_deck(record, "h2d_bytes")
    return None if v is None else v / 2 ** 20
