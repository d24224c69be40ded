"""``step_mfu_pct``: the window's model FLOPs (``counts.model_flops``:
6 N T and the attention's products, nothing recomputed) a second, over
the card's dense bf16 peak, in percent."""
from perfbench import counts


def read(rec):
    steps = len(rec["steps"])
    if not steps or rec["window_s"] <= 0:
        return None
    t = rec["traffic"]
    flops = counts.model_flops(rec["config"], t["batch"], t["seq"]) * steps
    return 100.0 * flops / rec["window_s"] / counts.PEAK_BF16_FLOPS
