"""``elementwise_ms_per_step``: device ms a step of every kernel that is
neither a GEMM nor a TACO kernel (attention's softmax scan, the SSM scan,
norms, the loss, AdamW, casts); copies and fills are left out."""
from perfbench import tracing


def read(rec):
    if not rec["events"] or not rec["steps"]:
        return None
    return 1e3 * tracing.kind_seconds(rec, "elementwise") / len(rec["steps"])
