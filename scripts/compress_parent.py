"""K1 (``compress_blocks``) and K2 (``compress_wire``) beside another
checkout's K1 and K2, on one card.

    python3 scripts/compress_parent.py --parent CHECKOUT [--out FILE]

Builds ``src/repro_torch/kernels/csrc/ash_compress.cu`` of this checkout and
of CHECKOUT (each with its own ``ash_common.cuh``), one ``nvcc`` each with
the flags of ``kernels/build.py``, started together, and prints ptxas's
registers and spills for both.  Both libraries have the C interface of
``kernels/ash_compress.py``, so each runs through that module's wrappers
(``ash_compress._lib`` pointed at it).  Then, with ``chip_smoke.tp_like``
data in bf16 under ``taco`` (e4m3, one group a row, dual metadata):

* K1 at the training hop (n = 7,340,032) and K2 at the large shape (one
  slot of 4096 x 896), each version held against the plain version on the
  card (``ref.compress_blocks_ref`` / ``compress_wire_ref``: codes apart,
  their largest distance, metadata bytes apart) and timed, device time a
  launch from the profiler (``chip_smoke.kernel_ms``), in the order
  parent, this, this, parent;
* rows with a rotated group planted at 0 (``chip_smoke.planted``, f32, 256
  rows) at e5m2 g8 and int8 g1: each version's codes apart from the plain
  version's.

Prints the card's name and power limit first and last; writes every number
to ``--out`` (JSON).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def build_libs(parent: pathlib.Path) -> dict:
    """name -> (loaded library, ptxas output), built together."""
    from repro_torch.kernels import ash_compress, build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, csrc in (("this", build.CSRC),
                       ("parent", parent / "src/repro_torch/kernels/csrc")):
        src = csrc / "ash_compress.cu"
        digest = hashlib.sha256(src.read_bytes() + (
            csrc / "ash_common.cuh").read_bytes()).hexdigest()[:12]
        out = build.BUILD_DIR / f"libk1k2_{name}-{digest}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = (ash_compress.bind(ctypes.CDLL(str(out))), log)
    return libs


@contextlib.contextmanager
def using(lib):
    """The wrappers of ``ash_compress`` launch ``lib``'s kernels."""
    from repro_torch.kernels import ash_compress
    old = ash_compress._lib
    ash_compress._lib = lambda: lib
    try:
        yield
    finally:
        ash_compress._lib = old


def apart(got: torch.Tensor, want: torch.Tensor, n: int, cfg) -> dict:
    """Wire rows against the plain version's: codes apart, their largest
    distance, metadata bytes apart."""
    from repro_torch.kernels import ref
    got, want = got.cpu(), want.cpu()
    dq = (ref.payload_codes(got[..., :n], cfg)
          - ref.payload_codes(want[..., :n], cfg)).abs()
    return {"codes_apart": int((dq != 0).sum()), "codes": dq.numel(),
            "max_distance": int(dq.max()),
            "meta_bytes_apart": int((got[..., n:] != want[..., n:]).sum())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "results" / "compress_parent.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compress_parent: no CUDA device")
    import chip_smoke as cs
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ash_compress, ref
    card = smi("name,power.limit")
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    libs = build_libs(args.parent)
    res = {"card": card, "registers": {}, "shapes": {}, "planted": {}}
    for name, (_, log) in libs.items():
        res["registers"][name] = {k: list(v) for k, v in
                                  cs.ptxas_registers(log).items()}
        for fn, (regs, spill) in sorted(res["registers"][name].items()):
            if "compress" in fn and ("Li8ELb0E" in fn):   # B = 256, f32
                print(f"  {name:6s} {fn[:60]:60s} registers {regs} "
                      f"spilled {spill}")

    def wire_of(blocks_out, cfg, slots, n):
        return ref.blocks_to_wire(*blocks_out, cfg, slots, n)

    cfg = codec_from_spec("taco").cfg
    gen = np.random.default_rng(1)
    train = cs.tp_like(gen, (1, cs.TRAIN_N)).to("cuda", torch.bfloat16)
    blocks = train.reshape(-1, cfg.block_size)
    large = cs.tp_like(np.random.default_rng(0), (1, cs.LARGE_N)).to(
        "cuda", torch.bfloat16)
    shapes = {
        "K1 train": ("compress_blocks_kernel", cs.TRAIN_N,
                     lambda: ash_compress.compress_blocks(blocks, cfg),
                     lambda out: wire_of(out, cfg, 1, cs.TRAIN_N),
                     ref.blocks_to_wire(*ref.compress_blocks_ref(blocks, cfg),
                                        cfg, 1, cs.TRAIN_N),
                     cs.bound(2 * cs.TRAIN_N + cs.TRAIN_N
                              + 8 * blocks.shape[0], 16.0 * cs.TRAIN_N)[0]),
        "K2 large": ("compress_wire_kernel", cs.LARGE_N,
                     lambda: ash_compress.compress_wire(large, cfg),
                     lambda out: out, ref.compress_wire_ref(large, cfg),
                     cs.bound(2 * cs.LARGE_N + ash_compress.wire_geometry(
                         cfg, cs.LARGE_N)[-1], 16.0 * cs.LARGE_N)[0])}
    for label, (kernel, n, fn, as_wire, want, bound_ms) in shapes.items():
        row = {"n": n, "bound_ms": bound_ms}
        for name in libs:
            row[f"{name}_ms"] = []
            with using(libs[name][0]):
                row[f"{name}_held"] = apart(as_wire(fn()), want, n, cfg)
        for name in ("parent", "this", "this", "parent"):
            with using(libs[name][0]):
                row[f"{name}_ms"].append(cs.kernel_ms(fn, kernel)[0])
        p = float(np.mean(row["parent_ms"]))
        print(f"{label} n={n}: parent {row['parent_ms'][0]:.7f} / "
              f"{row['parent_ms'][1]:.7f} ms; bound {bound_ms:.7f} ms; "
              f"parent against the plain version {row['parent_held']}")
        t = float(np.mean(row["this_ms"]))
        row["ratio"] = t / p
        print(f"  this {row['this_ms'][0]:.7f} / {row['this_ms'][1]:.7f} "
              f"ms; / parent {t / p:.4f}; against the plain version "
              f"{row['this_held']}")
        res["shapes"][label] = row
    del train, blocks, large
    pgen = np.random.default_rng(31)
    for spec in ("taco:e5m2:g8", "taco:e5m2:g8:folded", "taco:int8:g1"):
        pcfg = codec_from_spec(spec).cfg
        x = cs.planted(pgen, 256, 256).to("cuda").reshape(4, -1)
        n = x.shape[1]
        want = ref.compress_wire_ref(x, pcfg)
        row = {}
        for name in libs:
            with using(libs[name][0]):
                row[name] = {
                    "K2": apart(ash_compress.compress_wire(x, pcfg), want, n,
                                pcfg),
                    "K1": apart(ref.blocks_to_wire(
                        *ash_compress.compress_blocks(x.reshape(-1, 256),
                                                      pcfg), pcfg, 4, n),
                        want, n, pcfg)}
        print(f"planted {spec}: " + "; ".join(
            f"{name} {k} {r[k]['codes_apart']} of {r[k]['codes']} codes "
            f"apart (max {r[k]['max_distance']})"
            for name, r in row.items() for k in r))
        res["planted"][spec] = row
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1, default=str))
    print(f"wrote {args.out}")
    print(card)


if __name__ == "__main__":
    main()
