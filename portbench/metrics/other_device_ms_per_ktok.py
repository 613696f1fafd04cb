"""other_device_ms_per_ktok: device milliseconds of every other kernel,
copy and set (softmax, masks, casts, norms, rope, routing, copies) in the
traced window, per 1000 prompt tokens answered in it."""
from portbench.stats import done


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    return 1e6 * tr["other_s"] / sum(r["tokens"] for r in done(rec))
