"""``taco_kernel_roofline_pct``: the least time the window's codec work
needs (``counts.codec_least_s``: each hop's compress and decompress,
counted from its shape and the plan) over the TACO kernels' device time,
in percent.  Nothing where no TACO kernel ran."""
from perfbench import counts, tracing


def read(rec):
    s = tracing.kind_seconds(rec, "taco")
    if s <= 0 or not rec["steps"]:
        return None
    least = counts.codec_least_s(rec["config"], rec["traffic"])
    return 100.0 * least * len(rec["steps"]) / s
