"""device_idle: 1 minus the union of the card's activity over the host's
wall, in the profiled decks of a traced run (%)."""


def read(record):
    p = record.get("profile")
    if not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
