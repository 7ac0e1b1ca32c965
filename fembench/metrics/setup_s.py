"""setup_s: from the start of the process to the end of the warm-up deck:
imports, the kernel library, the inputs and one deck of the cell's shapes
(s)."""


def read(record):
    return record["setup_s"]
