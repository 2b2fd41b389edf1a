"""device_idle_pct (%; the device, device trace): 100 x (1 - the union of
the device's busy intervals / the traced window), the window being whole
jobs in steady state, timed on the host between two synchronizes."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr.summary["device_events"] == 0 or tr.span_s <= 0:
        return None
    return 100.0 * (1.0 - tr.summary["busy_s"] / tr.span_s)
