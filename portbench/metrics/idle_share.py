"""idle_share: the share of the traced window, in percent, in which no
kernel, copy or set ran on the device (1 less the union of their
intervals over the window)."""


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
