"""K1 (``compress_blocks``) and K2 (``compress_wire``) beside another
checkout's K1 and K2, and by launch geometry, on one card.

    python3 scripts/compress_parent.py --parent CHECKOUT [--sweep] [--out FILE]

Builds ``src/repro_torch/kernels/csrc/ash_compress.cu`` of this checkout
and of CHECKOUT (each with its own ``ash_common.cuh``) and, with
``--sweep``, this source again with ``-DTACO_K1_SWEEP`` (every E of 8, 16
and 32 elements a lane that gives 1 .. 32 lanes a row, at an f32 compute
dtype): one ``nvcc`` each with the flags of ``kernels/build.py``, started
together.  Prints ptxas's registers and spills of the B = 256 kernels of
each.  Both libraries run through this checkout's
``ash_compress.launch_blocks`` / ``launch_wire`` with its launch geometry
(``ash_compress.geometry``), so the parent must be a checkout whose K1 /
K2 have this C interface (several rows a warp, the geometry from Python).
With ``chip_smoke.tp_like`` data in bf16 under ``taco`` (e4m3, one group a
row, dual metadata; ``taco:folded`` for the sp hop):

* K1 at every training hop of ``chip_smoke.py`` phase 1b (train, pipe
  hop, sp ulysses in, grok, hymba, rwkv and whisper train) and K2 at the
  large shape (one slot of 4096 x 896) and at every decode hop of phase 1
  (serve, grok, hymba, rwkv, whisper decode): each version held against
  the plain version on the card (codes apart, their largest distance,
  metadata bytes apart) and timed, device time a launch from the profiler
  (``chip_smoke.kernel_ms``), in the order parent, this, this, parent;
* rows with a rotated group planted at 0 (``chip_smoke.planted``, f32, 256
  rows) at e5m2 g8 (dual and folded) and int8 g1: each version's codes
  apart from the plain version's;
* with ``--sweep``: K1 at the training hop's n at every B = 32 .. 512, and
  K2 at the large shape and the serve hop (B = 256), by E and by blocks a
  multiprocessor of the persistent grid (1, 2, 4, 8, 16, or one pass),
  each variant held to the plain version's bits and timed in the order
  variants, variants reversed; and the SASS of each bf16 / f32-compute
  instantiation of K1's row loop (``k7_sweep.sass_counts``: the
  instructions between the loop's backward branch and its target, every
  branch of the loop counted once, by opcode) per element, with the issue
  bound they imply at the card's SM count and ``clocks.max.sm``;
* rows holding NaN or inf (``ref.plant_nonfinite``, f32, 64 rows) under
  ``taco``, ``taco:int8:g8:folded`` and ``taco:e5m2:g8``: each version's
  K1 and K2 values apart from the plain version's on the planted rows;
* the SASS of K1's and K2's row loops as each library launches them (bf16
  in, f32 compute, at ``KEPT_E`` and ``LATENCY_E`` of every B), parent
  beside this, per element.

Prints the card's name and power limit first and last; writes every number
to ``--out`` (JSON).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: blocks a multiprocessor in the sweep's persistent grids; None: one pass
GRIDS = (1, 2, 4, 8, 16, None)
E_SWEEP = (8, 16, 32)
#: the mangled instantiation <Tin, B, E, BF> of a compress kernel
MANGLED = re.compile(r"compress_(blocks|wire)_kernelI(13__nv_bfloat16|f)"
                     r"Li(\d+)ELi(\d+)ELb([01])E")


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def build_libs(parent: pathlib.Path, sweep: bool) -> dict:
    """name -> (library path, ptxas output), built together."""
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = {"this": (build.CSRC, []),
            "parent": (parent / "src/repro_torch/kernels/csrc", [])}
    if sweep:
        srcs["sweep"] = (build.CSRC, ["-DTACO_K1_SWEEP"])
    procs = {}
    for name, (csrc, extra) in srcs.items():
        src = csrc / "ash_compress.cu"
        digest = hashlib.sha256(src.read_bytes() + (
            csrc / "ash_common.cuh").read_bytes()
            + " ".join(extra).encode()).hexdigest()[:12]
        out = build.BUILD_DIR / f"libk1k2_{name}-{digest}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, *extra, "-o", str(out),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = (out, log)
    return libs


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


def registers(log: str, cs) -> dict:
    """ptxas (registers, spilled bytes) by (form, tin, B, E, BF)."""
    out = {}
    for fn, v in cs.ptxas_registers(log).items():
        m = MANGLED.search(fn)
        if m:
            form, tin, b, e, bf = m.groups()
            out[(form, "bf16" if tin != "f" else "f32", int(b), int(e),
                 int(bf))] = v
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--sweep", action="store_true",
                    help="also build every E and time it by grid")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "results" / "compress_parent.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compress_parent: no CUDA device")
    import chip_smoke as cs
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ash_compress as ac
    from repro_torch.kernels import ref
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = ac.sms(torch.cuda.current_device())
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          f"{sms} SMs, clocks.max.sm {clock_mhz} MHz")
    libs = build_libs(args.parent, args.sweep)
    loaded = {name: ac.bind(ctypes.CDLL(str(libs[name][0])))
              for name in ("this", "parent")}
    res = {"card": card, "sms": sms, "clock_mhz": clock_mhz,
           "registers": {}, "shapes": {}, "planted": {}}
    for name, (_, log) in libs.items():
        regs = registers(log, cs)
        res["registers"][name] = {"/".join(map(str, k)): list(v)
                                  for k, v in regs.items()}
        for k, (r, sp) in sorted(regs.items()):
            if k[2] == 256 and (name != "sweep" or k[4] == 0):
                print(f"  {name:6s} {k[0]:6s} in={k[1]} B=256 E={k[3]} "
                      f"bf16_compute={k[4]}: registers {r} spilled {sp}")

    def ours(name, geo_of):
        lib = loaded[name]
        return {
            "blocks": lambda x, cfg: ac.launch_blocks(
                lib, x, cfg, geo_of(cfg.block_size, x.dtype, x.shape[0])),
            "wire": lambda x, cfg: ac.launch_wire(
                lib, x, cfg, geo_of(cfg.block_size, x.dtype,
                                    x.shape[0] * (x.shape[1]
                                                  // cfg.block_size)))}

    def kept_geo(b, dtype, rows):
        return ac.geometry(b, dtype, rows, sms)
    fns = {name: ours(name, kept_geo) for name in ("this", "parent")}

    gen = np.random.default_rng(1)
    sp_n = math.prod(cs.SP_HOPS[0][1])
    k1_shapes = (("train", "taco", cs.TRAIN_N),
                 ("pipe hop", "taco", cs.PIPE_N),
                 ("sp ulysses in", "taco:folded", sp_n),
                 ("grok train", "taco", cs.MOE_TRAIN_N),
                 ("hymba train", "taco", cs.HYMBA_TRAIN_N),
                 ("rwkv train", "taco", cs.RWKV_TRAIN_N),
                 ("whisper train", "taco", cs.WHISPER_TRAIN_N))
    k2_shapes = (("large", "taco", cs.LARGE_N),
                 ("serve", "taco", cs.SERVE_N),
                 ("grok decode", "taco", cs.MOE_SERVE_N),
                 ("hymba decode", "taco", cs.HYMBA_SERVE_N),
                 ("rwkv decode", "taco", cs.RWKV_SERVE_N),
                 ("whisper decode", "taco", cs.WHISPER_SERVE_N))
    for form, shapes in (("blocks", k1_shapes), ("wire", k2_shapes)):
        kernel = f"compress_{form}_kernel"
        for label, spec, n in shapes:
            cfg = codec_from_spec(spec).cfg
            x = cs.tp_like(gen, (1, n)).to("cuda", torch.bfloat16)
            if form == "blocks":
                x = x.reshape(-1, cfg.block_size)
                rows = x.shape[0]
                nbytes = 2 * n + n + 4 * rows * ac.groups(cfg) + 4 * rows
                want = ref.blocks_to_wire(*ref.compress_blocks_ref(x, cfg),
                                          cfg, 1, n)

                def as_wire(out, cfg=cfg, n=n):
                    return ref.blocks_to_wire(*out, cfg, 1, n)
            else:
                rows = n // cfg.block_size
                nbytes = 2 * n + ac.wire_geometry(cfg, n)[-1]
                want = ref.compress_wire_ref(x, cfg)

                def as_wire(out):
                    return out
            bound_ms = cs.bound(nbytes, 16.0 * n)[0]
            geo = kept_geo(cfg.block_size, x.dtype, rows)
            k = ("blocks" if form == "blocks" else "wire", "bf16",
                 cfg.block_size, geo.e, 0)
            row = {"n": n, "rows": rows, "bound_ms": bound_ms,
                   "geometry": geo._asdict(),
                   "registers": res["registers"]["this"].get(
                       "/".join(map(str, k)))}
            for name in fns:
                row[f"{name}_held"] = apart(as_wire(fns[name][form](x, cfg)),
                                            want, n, cfg)
                row[f"{name}_ms"] = []
            for name in ("parent", "this", "this", "parent"):
                row[f"{name}_ms"].append(cs.kernel_ms(
                    lambda: fns[name][form](x, cfg), kernel)[0])
            p, t = float(np.mean(row["parent_ms"])), \
                float(np.mean(row["this_ms"]))
            row.update(ratio=t / p, share=bound_ms / t,
                       parent_share=bound_ms / p)
            print(f"K{1 if form == 'blocks' else 2} {label:14s} n={n:9d} "
                  f"parent {row['parent_ms'][0]:.7f} / "
                  f"{row['parent_ms'][1]:.7f} ms, this "
                  f"{row['this_ms'][0]:.7f} / {row['this_ms'][1]:.7f} ms; "
                  f"this / parent {t / p:.4f}; bound {bound_ms:.7f} ms "
                  f"(share this {bound_ms / t:.3f}, parent "
                  f"{bound_ms / p:.3f}); E={geo.e} L={geo.lanes} "
                  f"R={geo.rows_per_warp} grid={geo.grid} registers "
                  f"{row['registers']}")
            print(f"    against the plain version: parent "
                  f"{row['parent_held']}; this {row['this_held']}")
            res["shapes"][f"K{1 if form == 'blocks' else 2} {label}"] = row
            del x, want
        torch.cuda.empty_cache()
    pgen = np.random.default_rng(31)
    for spec in ("taco:e5m2:g8", "taco:e5m2:g8:folded", "taco:int8:g1"):
        pcfg = codec_from_spec(spec).cfg
        x = cs.planted(pgen, 256, 256).to("cuda").reshape(4, -1)
        n = x.shape[1]
        want = ref.compress_wire_ref(x, pcfg)
        row = {}
        for name, f in fns.items():
            row[name] = {
                "K2": apart(f["wire"](x, pcfg), want, n, pcfg),
                "K1": apart(ref.blocks_to_wire(
                    *f["blocks"](x.reshape(-1, 256), pcfg), pcfg, 4, n),
                    want, n, pcfg)}
        print(f"planted {spec}: " + "; ".join(
            f"{name} {k} {r[k]['codes_apart']} of {r[k]['codes']} codes "
            f"apart (max {r[k]['max_distance']})"
            for name, r in row.items() for k in r))
        res["planted"][spec] = row
    res["nonfinite"] = nonfinite(fns, cs, ref, codec_from_spec)
    res["sass_launched"] = launched_sass(libs, cs, ac)
    if args.sweep:
        res["sweep"] = sweep(libs["sweep"], cs, ac, ref, codec_from_spec,
                             sms, clock_mhz)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1, default=str))
    print(f"wrote {args.out}")
    print(card)


def nonfinite(fns, cs, ref, codec_from_spec) -> dict:
    """Each version's K1 and K2 on 64 f32 rows of 256 with
    ``ref.NONFINITE_KINDS`` planted (``ref.plant_nonfinite``): the values
    of the planted rows apart from the plain version's under
    ``ref.NONFINITE_RULE``, and the NaN row's first scale and codes."""
    gen = np.random.default_rng(32)
    out = {}
    for spec in ("taco", "taco:int8:g8:folded", "taco:e5m2:g8"):
        cfg = codec_from_spec(spec).cfg
        x, rows = ref.plant_nonfinite(cs.tp_like(gen, (64, 256)), gen)
        x = x.to("cuda")
        n = 32 * 256
        want = ref.compress_blocks_ref(x, cfg)
        wire = ref.wire_fields(ref.compress_wire_ref(x.reshape(2, n), cfg),
                               n, cfg)
        row = {}
        for name, f in fns.items():
            got = f["blocks"](x, cfg)
            k2 = ref.wire_fields(f["wire"](x.reshape(2, n), cfg), n, cfg)
            row[name] = {
                "K1": int(ref.nonfinite_apart(got, want, cfg.format_spec)[
                    rows].sum()),
                "K2": int(ref.nonfinite_apart(k2, wire, cfg.format_spec)[
                    rows].sum()),
                "nan_row_s": float(got[2][rows[0], 0]),
                "nan_row_codes": got[0][rows[0], :4].view(
                    torch.uint8).tolist()}
        print(f"non-finite {spec} (planted rows {rows}): " + "; ".join(
            f"{name} K1 {r['K1']} K2 {r['K2']} values apart, the NaN row's "
            f"s {r['nan_row_s']:g} and first bytes {r['nan_row_codes']}"
            for name, r in row.items())
            + f"; plain s {float(want[2][rows[0], 0]):g}, bytes "
            f"{want[0][rows[0], :4].view(torch.uint8).tolist()}")
        out[spec] = row
    return out


def launched_sass(libs, cs, ac) -> dict:
    """SASS instructions an element of the row loop of every K1 / K2
    instantiation the wrappers launch for bf16 input at an f32 compute
    dtype (``KEPT_E`` and ``LATENCY_E`` of each B), parent beside this
    (``k7_sweep.sass_counts``: every branch of the loop once)."""
    import scripts.k7_sweep as k7
    launched = {(b, e) for b in ac.BLOCK_SIZES
                for e in (ac.KEPT_E[b], ac.LATENCY_E[b])}
    out = {}
    for name in ("parent", "this"):
        for fn, c in k7.sass_counts(libs[name][0]).items():
            m = MANGLED.search(fn)
            if m and m.group(2) != "f" and m.group(5) == "0" and \
                    (int(m.group(3)), int(m.group(4))) in launched:
                key = f"K{1 if m.group(1) == 'blocks' else 2} " \
                      f"B={m.group(3)} E={m.group(4)}"
                out.setdefault(key, {})[name] = c["loop"] / int(m.group(4))
    print("SASS of the launched row loops (bf16 in, f32 compute), "
          "instructions an element: parent, this, this - parent")
    for key, v in sorted(out.items()):
        v["delta"] = v["this"] - v["parent"]
        print(f"  {key:14s} {v['parent']:.3f} {v['this']:.3f} "
              f"{v['delta']:+.3f}")
    return out


def sweep(built, cs, ac, ref, codec_from_spec, sms, clock_mhz) -> dict:
    """Every (E, blocks a multiprocessor) of the sweep library: K1 at the
    training hop's n at every B, K2 at the large and serve shapes at B =
    256; held to the plain version's bits, timed there and back; then the
    loop's SASS by opcode."""
    import scripts.k7_sweep as k7
    path, _ = built
    lib = ac.bind(ctypes.CDLL(str(path)))
    out = {"timings": {}, "sass": {}}
    gen = np.random.default_rng(2)
    cases = [("blocks", f"taco:b{b}", cs.TRAIN_N, f"K1 train B={b}")
             for b in ac.BLOCK_SIZES]
    cases += [("wire", "taco", cs.LARGE_N, "K2 large B=256"),
              ("wire", "taco", cs.SERVE_N, "K2 serve B=256")]
    for form, spec, n, label in cases:
        cfg = codec_from_spec(spec).cfg
        b = cfg.block_size
        x = cs.tp_like(gen, (1, n)).to("cuda", torch.bfloat16)
        if form == "blocks":
            x = x.reshape(-1, b)
            rows = x.shape[0]
            want = ref.compress_blocks_ref(x, cfg)
            nbytes = 3 * n + 8 * rows
        else:
            rows = n // b
            want = ref.compress_wire_ref(x, cfg)
            nbytes = 2 * n + ac.wire_geometry(cfg, n)[-1]
        bound_ms = cs.bound(nbytes, 16.0 * n)[0]
        launch = ac.launch_blocks if form == "blocks" else ac.launch_wire
        variants = {}
        for e in E_SWEEP:
            if not 1 <= b // e <= 32:
                continue
            for per_sm in GRIDS:
                geo = ac.geometry(b, x.dtype, rows, sms, e=e,
                                  blocks_per_sm=per_sm or 1 << 30)
                variants[f"E={e} grid={per_sm or 'pass'}"] = (
                    geo, lambda g=geo: launch(lib, x, cfg, g))
        row = {"rows": rows, "bound_ms": bound_ms, "variants": {}}
        for key, (geo, fn) in variants.items():
            got = fn()
            same = (all(torch.equal(g, w) for g, w in zip(got, want))
                    if form == "blocks" else torch.equal(got, want))
            if not same:
                raise AssertionError(f"{label} {key}: not the plain "
                                     "version's bits")
            row["variants"][key] = {"geometry": geo._asdict(), "ms": []}
        order = list(variants)
        for key in order + order[::-1]:
            row["variants"][key]["ms"].append(cs.kernel_ms(
                variants[key][1], f"compress_{form}_kernel")[0])
        print(f"sweep {label} rows={rows} bound {bound_ms:.7f} ms (every "
              "variant the plain version's bits)")
        for key, v in sorted(row["variants"].items(),
                             key=lambda kv: np.mean(kv[1]["ms"])):
            ms = float(np.mean(v["ms"]))
            v["mean_ms"], v["share"] = ms, bound_ms / ms
            print(f"  {key:15s} {v['ms'][0]:.7f} / {v['ms'][1]:.7f} ms  "
                  f"share {bound_ms / ms:.3f}")
        out["timings"][label] = row
        del x, want
        torch.cuda.empty_cache()
    print("SASS of K1's row loop (bf16 in, f32 compute; every branch of the"
          " loop once): instructions an element, the issue bound, and the "
          "loop's opcodes an element")
    for fn, c in sorted(k7.sass_counts(path).items()):
        m = MANGLED.search(fn)
        if not m or m.group(1) != "blocks" or m.group(2) == "f" or \
                m.group(5) != "0":
            continue
        b, e = int(m.group(3)), int(m.group(4))
        per = c["loop"] / e
        issue_ms = cs.TRAIN_N * per / 32 / (4 * sms * clock_mhz * 1e6) * 1e3
        ops = {k: round(v / e, 3) for k, v in c["loop_ops"].items()}
        out["sass"][f"B={b} E={e}"] = dict(c, per_element=per,
                                           issue_bound_ms=issue_ms,
                                           ops_per_element=ops)
        print(f"  B={b:3d} E={e:2d} loop {c['loop']:5d} ({per:.2f} an "
              f"element, issue bound {issue_ms:.7f} ms at the train hop): "
              + ", ".join(f"{k} {v}" for k, v in list(ops.items())[:14]))
    return out


if __name__ == "__main__":
    main()
