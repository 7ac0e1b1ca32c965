"""host_setup_ms: the program's `setup` phase plus what `stepper.run` spends
outside its timed phases (structure detection before `setup` opens, the
copies to the host after the last phase), per deck (ms/deck)."""


def read(record):
    decks = [d for d in record["decks"] if "timers" in d and "run" in d["spans"]]
    if not decks:
        return None
    return 1e3 * sum(d["timers"].get("setup", 0.0) + d["spans"]["run"]
                     - sum(d["timers"].values()) for d in decks) / len(decks)
