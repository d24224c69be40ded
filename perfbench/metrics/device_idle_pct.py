"""``device_idle_pct``: the share of the traced window in which no
kernel, copy or fill ran on the card (the union of the device trace's
intervals), in percent."""
from perfbench import tracing


def read(rec):
    if not rec["events"] or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tracing.busy_s(rec) / rec["window_s"])
