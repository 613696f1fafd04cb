"""gemm_device_ms_per_ktok: device milliseconds of kernels whose names
carry a GEMM word (``devtrace.GEMM_WORDS``) in the traced window, per
1000 prompt tokens answered in it."""
from portbench.stats import done


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    return 1e6 * tr["gemm_s"] / sum(r["tokens"] for r in done(rec))
