"""K7 (``compress_blocks_butterfly``) by launch geometry, beside another
checkout's K7 and a device copy, on one card.

    python3 scripts/k7_sweep.py [--parent CHECKOUT] [--out FILE]

Builds ``src/repro_torch/kernels/csrc/fwht_butterfly.cu`` with
``-DTACO_K7_SWEEP`` (every E of 8, 16 and 32 elements a lane that gives 1 ..
32 lanes a row) and, with ``--parent``, the K7 source of another checkout
(with this C interface: the launch geometry from Python; the parent runs
at its kept E and grid, ``fwht_butterfly.geometry``), each by one
``nvcc`` with the flags of ``kernels/build.py``, and prints ptxas's
registers and spills for every instantiation.  Then at the training hop's
n = 7,340,032 (bf16 in, e4m3, ``chip_smoke.tp_like`` data from seed 2) and
every B = 32 .. 512: holds each variant (E, and blocks a multiprocessor
in the persistent grid, or one pass) against the plain version under the
parity rule of ``repro_torch.kernels.ref``, and times it (device time a
launch from the profiler, ``chip_smoke.kernel_ms``) in the order parent,
variants, variants reversed, parent.  A bf16 ``copy_`` of n elements is
timed first and last: the rate this card reaches at this size.  Counts the
SASS instructions of each bf16 / e4m3 instantiation's row-group loop
(``cuobjdump -sass``: the instructions between the loop's backward branch
and its target) and of the parent's, and prints each per element
with the issue bound they imply at the card's SM count and the clock
``nvidia-smi`` reports as ``clocks.max.sm``.  Prints the card's name and
power limit first; writes every number to ``--out`` (JSON).  With
``--parent``, also holds both versions on 64 rows holding NaN or inf
(``ref.plant_nonfinite``) and prints their values apart.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: blocks a multiprocessor in the persistent grid; None: one pass (a group
#: a warp)
GRIDS = (1, 2, 4, 8, 16, None)
E_SWEEP = (8, 16, 32)
#: the mangled instantiation <Tin, B, E, FMT> of the kernel
MANGLED = re.compile(r"compress_blocks_butterfly_kernelI(13__nv_bfloat16|f)"
                     r"Li(\d+)ELi(\d+)ELi(\d+)E")


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def build_libs(parent: pathlib.Path | None) -> dict:
    """name -> (library path, ptxas output), built together."""
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = {"sweep": (build.CSRC / "fwht_butterfly.cu", ["-DTACO_K7_SWEEP"])}
    if parent is not None:
        srcs["parent"] = (parent / "src/repro_torch/kernels/csrc"
                          / "fwht_butterfly.cu", [])
    procs = {}
    for name, (src, extra) in srcs.items():
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(extra).encode()).hexdigest()[:12]
        out = build.BUILD_DIR / f"libk7_{name}-{digest}.so"
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


def sass_counts(lib: pathlib.Path) -> dict:
    """mangled function -> {"main": instructions before the body's closing
    self-branch (the subroutines, such as the division's slow path, come
    after it), "loop": instructions between the widest backward branch and
    its target (0: no loop), "loop_ops": the loop's (or, with no loop, the
    main body's) instructions by opcode}."""
    from repro_torch.kernels import build
    tool = pathlib.Path(build.nvcc()).with_name("cuobjdump")
    txt = subprocess.run([str(tool), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    out, name, ins = {}, None, []

    def close():
        if name is None:
            return
        addrs = [a for a, _ in ins]
        loop, span, end = 0, (0, -1), addrs[-1] if addrs else 0
        for a, text in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if not m:
                continue
            t = int(m.group(1), 16)
            if t == a:
                end = min(end, a)
            elif t < a:
                k = sum(1 for b in addrs if t <= b <= a)
                if k > loop:
                    loop, span = k, (t, a)
        if not loop:  # no loop: the body before the closing self-branch
            span = (0, end - 1)
        ops: dict = {}
        for a, text in ins:
            if span[0] <= a <= span[1]:
                op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
                op = op.split(".")[0]
                ops[op] = ops.get(op, 0) + 1
        out[name] = {"main": sum(1 for a, t in ins if a < end and
                                 not re.match(r"\s*NOP\b", t)),
                     "loop": loop,
                     "loop_ops": dict(sorted(ops.items(),
                                             key=lambda kv: -kv[1]))}
    for line in txt.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name, ins = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name is not None:
            ins.append((int(m.group(1), 16), m.group(2)))
    close()
    return out


def held(out, want, cfg, n) -> dict:
    from repro_torch.kernels import ref
    return ref.check_wire_parity(ref.blocks_to_wire(*out, cfg, 1, n),
                                 ref.blocks_to_wire(*want, cfg, 1, n), n, cfg)


def nonfinite(parent, sweep, sms, cs, fb, ref, config) -> dict:
    """The parent's K7 and this K7 (kept E and grid) on 64 f32 rows with
    ``ref.NONFINITE_KINDS`` planted, at B = 256 and every format: values
    of the planted rows apart from the plain version's under
    ``ref.NONFINITE_RULE``."""
    gen = np.random.default_rng(33)
    x, rows = ref.plant_nonfinite(cs.tp_like(gen, (64, 256)), gen)
    x = x.to("cuda")
    geo = fb.geometry(256, x.dtype, 64, sms)
    out = {}
    for fmt in ("e4m3", "e5m2", "int8"):
        cfg = config(fmt=fmt)
        want = ref.compress_blocks_butterfly_ref(x, cfg)
        out[fmt] = {name: int(ref.nonfinite_apart(
            fb.launch(lib, x, cfg, geo), want, cfg.format_spec)[rows].sum())
            for name, lib in (("parent", parent), ("this", sweep))}
        print(f"non-finite rows {rows}, {fmt}: values apart from the plain "
              f"version: parent {out[fmt]['parent']}, this "
              f"{out[fmt]['this']}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "results" / "k7_sweep.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k7_sweep: no CUDA device")
    import chip_smoke as cs
    from repro_torch.core.taco import TacoConfig
    from repro_torch.kernels import fwht_butterfly as fb
    from repro_torch.kernels import ref
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          f"{sms} SMs, clocks.max.sm {clock_mhz} MHz")
    libs = build_libs(args.parent)
    regs, sass = {}, {}
    for name, (path, log) in libs.items():
        regs[name] = cs.ptxas_registers(log)
        sass[name] = sass_counts(path)
    sweep = fb.bind(ctypes.CDLL(str(libs["sweep"][0])))
    parent = None
    if "parent" in libs:
        parent = fb.bind(ctypes.CDLL(str(libs["parent"][0])))

    n = cs.TRAIN_N
    res = {"card": card, "sms": sms, "clock_mhz": clock_mhz, "n": n,
           "registers": {k: {e: list(v) for e, v in r.items()}
                         for k, r in regs.items()},
           "sass": sass, "by_b": {}}
    src = torch.empty(n, dtype=torch.bfloat16, device="cuda").normal_()
    dst = torch.empty_like(src)
    res["copy_ms_first"] = cs.device_ms(lambda: dst.copy_(src))
    print(f"copy_ bf16 n={n}: {res['copy_ms_first']:.7f} ms")
    gen = np.random.default_rng(2)
    for b in fb.BLOCK_SIZES:
        cfg = TacoConfig(block_size=b)
        x = cs.tp_like(gen, (1, n)).to("cuda", torch.bfloat16).reshape(-1, b)
        m = x.shape[0]
        want = ref.compress_blocks_butterfly_ref(x, cfg)
        variants = {}
        for e in E_SWEEP:
            if not 1 <= b // e <= 32:
                continue
            for per_sm in GRIDS:
                geo = fb.geometry(b, x.dtype, m, sms, e=e,
                                  blocks_per_sm=per_sm or 1 << 30)
                key = f"E={e} grid={per_sm or 'pass'}"
                variants[key] = (geo, (lambda g=geo: fb.launch(sweep, x, cfg,
                                                                g)))
        row = {"rows": m, "variants": {}}
        bound_ms, _ = cs.bound(2 * n + n + 8 * m, (9.0 + np.log2(b)) * n)
        row["bound_ms"] = bound_ms
        for key, (geo, fn) in variants.items():
            stats = held(fn(), want, cfg, n)
            torch.cuda.synchronize()
            row["variants"][key] = {"geometry": geo._asdict(),
                                    "flipped": stats["flipped"],
                                    "meta_rel_err": stats["meta_rel_err"],
                                    "ms": []}
        if parent is not None:
            kept = fb.geometry(b, x.dtype, m, sms)

            def parent_call():
                return fb.launch(parent, x, cfg, kept)
            stats = held(parent_call(), want, cfg, n)
            row["parent"] = {"flipped": stats["flipped"],
                             "meta_rel_err": stats["meta_rel_err"], "ms": []}
            row["parent"]["ms"].append(cs.kernel_ms(
                parent_call, "compress_blocks_butterfly_kernel")[0])
        order = list(variants)
        for key in order + order[::-1]:
            row["variants"][key]["ms"].append(cs.kernel_ms(
                variants[key][1], "compress_blocks_butterfly_kernel")[0])
        if parent is not None:
            row["parent"]["ms"].append(cs.kernel_ms(
                parent_call, "compress_blocks_butterfly_kernel")[0])
        nbytes = 3 * n + 8 * m
        print(f"B={b} rows={m} bound {bound_ms:.7f} ms")
        if parent is not None:
            pm = row["parent"]["ms"]
            print(f"  parent          {pm[0]:.7f} / {pm[1]:.7f} ms  "
                  f"share {bound_ms / np.mean(pm):.3f}  flipped "
                  f"{row['parent']['flipped']}")
        for key, v in sorted(row["variants"].items(),
                             key=lambda kv: np.mean(kv[1]["ms"])):
            ms = np.mean(v["ms"])
            print(f"  {key:15s} {v['ms'][0]:.7f} / {v['ms'][1]:.7f} ms  "
                  f"share {bound_ms / ms:.3f}  {nbytes / ms / 1e9:.4f} TB/s"
                  f"  flipped {v['flipped']} meta_rel "
                  f"{v['meta_rel_err']:.2e}")
        kept = row["variants"][f"E={fb.KEPT_E[b]} grid={fb.BLOCKS_PER_SM}"]
        ms = float(np.mean(kept["ms"]))
        row["kept"] = {"e": fb.KEPT_E[b], "blocks_per_sm": fb.BLOCKS_PER_SM,
                       "ms": ms, "share": bound_ms / ms,
                       "tb_s": nbytes / ms / 1e9}
        if parent is not None:
            row["kept"]["parent_ms"] = float(np.mean(row["parent"]["ms"]))
            row["kept"]["speedup"] = row["kept"]["parent_ms"] / ms
        print(f"  kept E={fb.KEPT_E[b]} grid={fb.BLOCKS_PER_SM}: {ms:.7f} ms,"
              f" share {bound_ms / ms:.3f}, {nbytes / ms / 1e9:.4f} TB/s"
              + (f", parent {row['kept']['parent_ms']:.7f} ms, "
                 f"{row['kept']['speedup']:.2f}x" if parent else ""))
        res["by_b"][b] = row
        del x, want
        torch.cuda.empty_cache()
    if parent is not None:
        res["nonfinite"] = nonfinite(parent, sweep, sms, cs, fb, ref,
                                     TacoConfig)
    res["copy_ms_last"] = cs.device_ms(lambda: dst.copy_(src))
    copy_ms = (res["copy_ms_first"] + res["copy_ms_last"]) / 2
    print(f"copy_ bf16 n={n}: {res['copy_ms_last']:.7f} ms; "
          f"{4 * n / copy_ms / 1e9:.4f} TB/s (read + write)")
    # SASS a row-group loop (bf16, e4m3) per element and the issue bound:
    # warp instructions n / (32 E) * loop over 4 schedulers x SMs x clock
    print("SASS (bf16, e4m3): loop instructions, per element, issue bound")
    for name, counts in sass.items():
        for fn_name, c in sorted(counts.items()):
            m = MANGLED.search(fn_name)
            if not m or m.group(1) == "f" or m.group(4) != "0":
                continue
            b, e = int(m.group(2)), int(m.group(3))
            per = c["loop"] / e
            issue_ms = n * per / 32 / (4 * sms * clock_mhz * 1e6) * 1e3
            c.update(b=b, e=e, per_element=per, issue_bound_ms=issue_ms)
            print(f"  {name:6s} B={b:3d} E={e:2d} loop {c['loop']:4d} main "
                  f"{c['main']:4d}  {per:.2f} an element  issue bound "
                  f"{issue_ms:.7f} ms")
            if e == fb.KEPT_E[b]:
                print(f"    {name} at the kept E, the loop's "
                      "instructions by opcode: "
                      + ", ".join(f"{k} {v}" for k, v in
                                  list(c["loop_ops"].items())[:12]))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1, default=str))
    print(f"wrote {args.out}")
    print(card)


if __name__ == "__main__":
    main()
