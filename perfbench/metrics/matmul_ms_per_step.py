"""``matmul_ms_per_step``: device ms a step of the GEMM kernels
(``tracing.GEMM``'s name marks)."""
from perfbench import tracing


def read(rec):
    if not rec["events"] or not rec["steps"]:
        return None
    return 1e3 * tracing.kind_seconds(rec, "gemm") / len(rec["steps"])
