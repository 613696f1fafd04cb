"""service_ms_per_ktok.backlog: host milliseconds inside the executor's
``prefill_request`` calls (each ends in its host sync) per 1000 prompt
tokens, over the requests a backlog answered."""
from portbench.stats import done


def read(rec):
    d = done(rec)
    return 1e6 * sum(r["end"] - r["start"] for r in d) / sum(
        r["tokens"] for r in d)
