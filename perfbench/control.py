"""The check's control and its planted faults, at a cell's own size.

    python3 perfbench/control.py --workload gpt-2.7b.train.taco \
        --seeds 11 12 13 --out chiprun_out/control.jsonl
    python3 perfbench/control.py --workload gpt-2.7b.train.taco \
        --program-seeds 21 22 23 --out chiprun_out/program.jsonl

``--program-seeds``: the program's own readings first, a sound run of
each seed in this process (the cell's set-up, a window of one step, the
check), every number beside its limit; they give each limit its lower
reading.  Then, for each of ``--seeds``, the reference's readings of the
checked steps, then those of each variant put in the program's place,
each variant judged against the reference's by the cell's limits
(``check.judge``), its numbers beside them:

- ``fp8``: the control, the reference computed one precision below the
  configuration's bf16: every matrix product's operands, and every
  activation and cotangent a hop carries, rounded to e4m3;
- ``half``: half of each batch left out, the mean taken over the rest;
- ``nohop``: the TP hops' codec left out (the reference under the
  identity codec), a fault of a cell whose hops run TACO;
- ``frozen``: a step that returns its state unchanged (learning rate 0);
  it reads 1 on ``change_gap`` by the measure itself, and its run gives
  the other numbers;
- ``stale``: every step run on the weights as they started while AdamW
  moves the master weights (a working copy never refreshed).

The benchmark's own runs never run this; it needs the card, like them.
"""
import argparse
import json
import math
import re
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
VARIANTS = ("fp8", "half", "nohop", "frozen", "stale")


def readings(cell, seed, device, variant=None) -> dict:
    from perfbench import harness
    traffic = cell["traffic"]
    if variant == "nohop":
        traffic = dict(traffic, hop_codec={"kind": "identity"})
    if variant == "frozen":
        traffic = dict(traffic, optimizer=dict(traffic["optimizer"], lr=0.0))
    return harness.reference(cell["config"], traffic, seed, device,
                             prec="fp8" if variant == "fp8" else "f32",
                             rows=traffic["batch"] // 2
                             if variant == "half" else None,
                             stale=variant == "stale")


def _emit(row, out) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def program(cell, seeds, device, out=None, smoke=False) -> list:
    """The program's readings, a row a seed: ``correct`` by the cell's
    limits and every number read, with its limit (None where the cell has
    none).  ``smoke`` as ``harness.run_cell`` takes it."""
    from perfbench import check, harness
    names = [k for k in check.NUMBERS if k != "hop_gap" or
             cell["traffic"]["hop_codec"]["kind"] != "identity"]
    every = dict(cell, limits={k: math.inf for k in names})
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        result, lines = harness.run_cell(every, seed, 0.0, False, t, device,
                                         smoke)
        where = dict(re.match(r"check (\w+): .*worst at (.*)\)$", x).groups()
                     for x in lines if x.startswith("check "))
        numbers = {k: dict(v, limit=cell["limits"].get(k), where=where[k])
                   for k, v in result["check"].items()}
        row = {"workload": cell["name"], "seed": seed, "variant": "program",
               "correct": result["correct"] and all(
                   v["value"] <= v["limit"] for v in numbers.values()
                   if v["limit"] is not None),
               "numbers": numbers, "seconds": time.perf_counter() - t}
        rows.append(row)
        _emit(row, out)
    return rows


def run(cell, seeds, variants, device, out=None) -> list:
    """Each variant judged against the reference, a row a seed and
    variant: ``correct`` and every number read, with its limit (None
    where the cell compares it with none)."""
    from perfbench import check
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        ref = readings(cell, seed, device)
        for v in variants:
            if v == "nohop" and cell["traffic"]["hop_codec"]["kind"] == \
                    "identity":
                continue
            got = readings(cell, seed, device, v)
            ok, compared, read = check.judge(
                got, ref, cell["limits"], cell["traffic"]["hop_codec"])
            numbers = {k: {"value": val, "where": w, "limit": None}
                       for k, (val, w) in read.items()}
            numbers.update(compared)
            row = {"workload": cell["name"], "seed": seed, "variant": v,
                   "correct": ok, "numbers": numbers,
                   "seconds": time.perf_counter() - t}
            rows.append(row)
            _emit(row, out)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload, ROOT)
    if cell["traffic"]["hop_codec"]["kind"] != "identity":
        from repro_torch.kernels import build
        build.build_all()
    program(cell, args.program_seeds, "cuda", args.out)
    run(cell, args.seeds, args.variants, "cuda", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
