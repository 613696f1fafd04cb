"""prefill_tokens_per_s: prompt tokens of the requests answered in the
window, over the window's seconds (a backlog's window closes when the last
request started has answered)."""
from portbench.stats import done


def read(rec):
    return sum(r["tokens"] for r in done(rec)) / rec["window_s"]
