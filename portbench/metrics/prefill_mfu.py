"""prefill_mfu: the flops the answered prompts need (``flops.py``: the
linear layers with only the chosen experts, the adapters and the router,
causal attention, one position's unembedding) over the window's seconds
times the card's bf16 peak, in percent."""
from portbench.stats import done


def read(rec):
    if rec["trace"] is None:
        return None
    need = sum(r["flops"] for r in done(rec))
    return 100.0 * need / (rec["window_s"] * rec["peak_flops"])
