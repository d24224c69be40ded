"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 perfbench/run.py --workload gpt-2.7b.train.taco --seed 7 \
        --seconds 50 --trace 0

One run of one cell of ``BENCHMARK.json`` (``perfbench/harness.py``):
the kernels' libraries built once into ``build/kernels/`` of the
checkout, the weights and batches drawn from ``--seed`` on the card, the
checked steps as set-up, whole training steps for ``--seconds``, the
reference's comparison, and one JSON line last on standard output (with
``--trace 1`` the per-layer metrics of a device-traced window of at most
``harness.TRACE_SECONDS``).  The
numbers compared are printed last on standard error as well.

It runs on a CUDA card only: without one, or with fewer cards than the
cell asks for, it exits with 1 and prints no result.  It exits with 1,
naming them, if the JAX package or JAX itself is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the run inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from perfbench import harness
    cell = harness.load_cell(args.workload, ROOT)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found {found}",
              file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    result, lines = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded modules of JAX or the JAX package: {loaded}",
              file=sys.stderr)
        return 1
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
