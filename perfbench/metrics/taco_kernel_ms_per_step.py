"""``taco_kernel_ms_per_step``: device ms a step of the TACO kernels
(K1-K7, by their ``__global__`` names).  Nothing where none ran."""
from perfbench import tracing


def read(rec):
    s = tracing.kind_seconds(rec, "taco")
    if s <= 0 or not rec["steps"]:
        return None
    return 1e3 * s / len(rec["steps"])
