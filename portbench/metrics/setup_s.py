"""setup_s: seconds from the start of the process to the opening of the
window (weights and adapters made, executor built, warm-up done)."""


def read(rec):
    return rec["setup_s"]
