"""On-card smoke check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, from the repo root

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, started together), then:

  1. kernels: holds the three TACO wire kernels against their plain
     PyTorch versions on the card (the parity rule of
     ``repro_torch.kernels.ref``) at the serve shape (slots=1, n=3584 =
     4 x 896), dual and folded, P in {1, 4}, the other payload formats,
     and one larger shape (n = 4096 x 896); times each (device time from
     the profiler, and per-call time with CUDA events) beside its bound
     and the plain version's time;
  2. serving: drives the port's serve launcher (``repro_torch.launch.
     serve``) on full-width qwen2-0.5b (24 layers, d 896, vocab 151936,
     bf16, weights from --seed) under ``baseline`` and then ``taco``;
     every decode tick under ``taco`` must launch exactly 98 compress, 49
     decompress-reduce and 49 decompress kernels (two per hop, 49 hops),
     and none under ``baseline``; one full-table decode tick is profiled
     (wall, device busy time, idle share);
  3. reference: the smoke-size taco decode on the card must agree with the
     plain versions on the CPU.

Nothing is caught: any failure exits non-zero.  The line before the last
is the kernel table as JSON; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

B_PER_S = 3.35e12          # H100 SXM HBM3 bytes/s (data sheet)
F32_OP_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
SERVE_N = 4 * 896          # one decode hop of qwen2-0.5b at max-batch 4
LARGE_N = 4096 * 896


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
    fail(f"no port sources under {SRC}: run from a checkout of the repo")
sys.path.insert(0, str(SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def call_ms(fn, iters: int = 50) -> float:
    """Mean CUDA-event time per call of ``fn`` over ``iters`` calls in a
    row, after a warm-up.  At small shapes the host's launch path, not the
    device, sets this pace."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 20) -> dict:
    """Mean device time per call of ``fn`` by activity name (kernels,
    copies, fills), in ms, from the profiler's trace.  Raises if the trace
    holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / iters / 1e3
    if sum(by_name.values()) <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return by_name


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time per call of ``fn`` (all its device activity)."""
    return sum(device_profile(fn, iters).values())


def profile_tick(eng, calls: int = 5) -> dict:
    """Where one full-table decode tick's time goes: host wall per call,
    device busy time per call (profiler), the idle share, and the TACO
    wire kernels' device time."""
    from repro_torch.serve import serve_step as ss
    tok = torch.ones((eng.max_batch, 1), dtype=torch.long, device="cuda")
    pos = torch.arange(eng.max_batch, device="cuda")

    def fn():
        return ss.decode_forward(eng.params, tok, eng.cache, pos, eng.model,
                                 eng.ctx)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / calls * 1e3
    prof = device_profile(fn, calls)
    busy = sum(prof.values())
    wire = sum(v for k, v in prof.items() if "compress" in k)
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall,
            "taco_kernels_ms": wire,
            "top": [(k[:60], round(v, 5)) for k, v in top]}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms for ``nbytes`` moved and ``ops`` f32 operations."""
    tb, to = nbytes / B_PER_S * 1e3, ops / F32_OP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def tp_like(gen, shape, scale=0.02, tail=2.0, frac=0.002):
    """TP-intermediate-like tensor: dense near-zero body + long tail."""
    x = gen.normal(0.0, scale, size=shape).astype(np.float32)
    flat = x.reshape(-1)
    k = max(1, int(flat.size * frac))
    idx = gen.choice(flat.size, size=k, replace=False)
    flat[idx] = gen.normal(0.0, tail, size=k).astype(np.float32)
    return torch.from_numpy(x)


def phase_kernels() -> dict:
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ref
    from repro_torch.kernels.ash_compress import compress_wire, wire_geometry
    from repro_torch.kernels.ash_decompress import (decompress_reduce_wire,
                                                    decompress_wire)
    gen = np.random.default_rng(0)
    dev = torch.device("cuda")
    rows = {}

    def case(spec, n, in_dtype, peers, timed=False, label=""):
        cfg = codec_from_spec(spec).cfg
        x = tp_like(gen, (peers, n)).to(dev, in_dtype)
        w_k = compress_wire(x, cfg)
        w_p = ref.compress_wire_ref(x, cfg)
        torch.cuda.synchronize()
        stats = ref.check_wire_parity(w_k, w_p, n, cfg)
        dec_k = ref.decompress_wire_ref(w_k, n, cfg)
        dec_p = ref.decompress_wire_ref(w_p, n, cfg)
        if stats["flipped"] == 0:      # a flipped code moves its whole block
            ref.check_decoded_close(dec_k, dec_p)
        err_c = float((dec_k - dec_p).abs().max())
        d_k = decompress_wire(w_p, n, cfg)
        err_d = ref.check_decoded_close(d_k, ref.decompress_wire_ref(w_p, n,
                                                                     cfg))
        r_k = decompress_reduce_wire(w_p, n, cfg)
        err_r = ref.check_decoded_close(
            r_k, ref.decompress_reduce_wire_ref(w_p, n, cfg))
        print(f"  {label:6s} {spec:16s} n={n:8d} P={peers} "
              f"in={str(in_dtype)[6:]:8s} flipped={stats['flipped']} "
              f"meta_rel={stats['meta_rel_err']:.2e} "
              f"err compress={err_c:.2e} decompress={err_d:.2e} "
              f"reduce={err_r:.2e}")
        if not timed:
            return
        _, _, _, _, total = wire_geometry(cfg, n)
        isz = x.element_size()
        x1 = x[:1].contiguous()
        w1 = w_p[:1].contiguous()
        work = {
            "compress_wire": (
                lambda: compress_wire(x1, cfg),
                lambda: ref.compress_wire_ref(x1, cfg),
                n * isz + total, 16.0 * n, err_c),
            "decompress_wire": (
                lambda: decompress_wire(w1, n, cfg),
                lambda: ref.decompress_wire_ref(w1, n, cfg),
                total + 4 * n, 11.0 * n, err_d),
            "decompress_reduce_wire": (
                lambda: decompress_reduce_wire(w_p, n, cfg),
                lambda: ref.decompress_reduce_wire_ref(w_p, n, cfg),
                peers * total + 4 * n, (2.0 * peers + 9) * n, err_r),
        }
        for name, (kern, plain, nbytes, ops, err) in work.items():
            ms, plain_ms = device_ms(kern), device_ms(plain)
            per_call, plain_call = call_ms(kern), call_ms(plain)
            b_ms, b_by = bound(nbytes, ops)
            print(f"    {name:24s} {label:6s} device: kernel {ms:.6f} ms  "
                  f"plain {plain_ms:.6f} ms  bound {b_ms:.6f} ms ({b_by}); "
                  f"per call: kernel {per_call:.6f} ms  plain "
                  f"{plain_call:.6f} ms")
            rows.setdefault(name, {})[label] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "max_abs_err": err, "call_ms": per_call,
                "plain_call_ms": plain_call}

    print("phase 1: kernels vs plain versions; tolerance: at most "
          f"{ref.PAYLOAD_FLIP_FRACTION} of payload bytes "
          f"differ, by one code; metadata rtol {ref.META_RTOL}; decoded "
          f"rtol {ref.DECODE_RTOL} atol {ref.DECODE_ATOL}")
    case("taco", SERVE_N, torch.bfloat16, 1, timed=True, label="serve")
    case("taco:folded", SERVE_N, torch.bfloat16, 1)
    case("taco", SERVE_N, torch.bfloat16, 4)
    case("taco:folded", SERVE_N, torch.float32, 4)
    case("taco:e5m2", SERVE_N, torch.bfloat16, 1)
    case("taco:int8", SERVE_N, torch.float32, 1)
    case("taco:g64", SERVE_N, torch.bfloat16, 4)
    case("taco:folded:g32", SERVE_N, torch.bfloat16, 1)
    case("taco", LARGE_N, torch.bfloat16, 4, timed=True, label="large")
    case("taco:seps1e-20", 1024, torch.float32, 1)
    z = torch.zeros((1, 1024), device=dev)       # all-zero blocks: s floor
    cfg = codec_from_spec("taco").cfg
    ref.check_wire_parity(compress_wire(z, cfg), ref.compress_wire_ref(z, cfg),
                          1024, cfg)
    return rows


def phase_serve(kernels) -> dict:
    from repro_torch.launch import serve
    counters = [kernels["compress_wire"], kernels["decompress_reduce_wire"],
                kernels["decompress_wire"]]
    want_tick = [98, 49, 49]     # 24 layers x 2 + 1 hops, 2 compressions each
    out = {}
    for spec in ("baseline", "taco"):
        args = serve.parse_args([
            "--arch", "qwen2-0.5b", "--no-smoke", "--comm-spec", spec,
            "--max-batch", "4", "--requests", "6", "--prompt-len", "16",
            "--gen", "16", "--qps", "16", "--seed", "0"])
        eng, cfg = serve.build_engine(args)
        ticks = []
        inner = eng._decode_tick

        def counted_tick(now, inner=inner, ticks=ticks):
            before = [c.launches for c in counters]
            inner(now)
            ticks.append([c.launches - b for c, b in zip(counters, before)])
        eng._decode_tick = counted_tick
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        s, wall = serve.drive(eng, args, cfg)
        launches = [c.launches for c in counters]
        done = eng.sched.done
        if len(done) != 6 or any(len(r.tokens) != 16 for r in done):
            raise AssertionError(f"{spec}: not every request finished")
        if any(not 0 <= t < cfg.vocab_size for r in done for t in r.tokens):
            raise AssertionError(f"{spec}: token id out of range")
        per_tick = want_tick if spec == "taco" else [0, 0, 0]
        if any(t != per_tick for t in ticks):
            raise AssertionError(f"{spec}: per-tick launches {ticks}, want "
                                 f"{per_tick} every tick")
        calls = s["decode_steps"] + s["prefill_steps"]
        if launches != [k * calls for k in per_tick]:
            raise AssertionError(f"{spec}: launches {launches} over {calls} "
                                 f"forward calls")
        toks = s["total_new_tokens"]
        print(f"  {spec:8s} requests={s['requests']} tokens={toks} "
              f"wall={wall:.3f}s tok/s={toks / wall:.2f} "
              f"p50={s['decode_ms_per_tok_p50']:.3f} "
              f"p99={s['decode_ms_per_tok_p99']:.3f} ms/tok "
              f"ttft p50={s['ttft_ms_p50']:.3f} p99={s['ttft_ms_p99']:.3f} "
              f"ms decode_ticks={s['decode_steps']} "
              f"prefill_calls={s['prefill_steps']} "
              f"launches[compress,reduce,decompress]={launches} "
              f"per_tick={ticks[0]} "
              f"max_mem={torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        prof = profile_tick(eng)
        print(f"    one decode tick: wall {prof['wall_ms']:.3f} ms, device "
              f"busy {prof['device_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.3f}, taco kernels "
              f"{prof['taco_kernels_ms']:.4f} ms; top {prof['top']}")
        out[spec] = dict(s, wall_s=wall, launches=launches, tick=prof)
        eng._decode_tick = inner = None   # break the engine's self-cycle
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_reference() -> float:
    """Smoke-size qwen2-0.5b, taco: teacher-forced decode logits on the
    card (kernels) against the CPU run (plain versions), same weights."""
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model
    from repro_torch.serve import serve_step as ss
    cfg = smoke_config(get_config("qwen2-0.5b"))
    plan = make_plan(cfg, 1, 1, remat=False)
    ctx = ParallelCtx(plan=from_spec("taco"))
    cpu, gpu = Model(cfg, plan, device="cpu"), Model(cfg, plan)
    p_cpu = cpu.init(0)
    p_gpu = tree_map(lambda a: a.to(gpu.device), p_cpu)
    c_cpu, c_gpu = ss.init_cache(cpu, 4, 32), ss.init_cache(gpu, 4, 32)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8)))
    worst = 0.0
    for t in range(8):
        _, lc = ss.decode_forward(p_cpu, toks[:, t:t + 1], c_cpu, t, cpu,
                                  ctx, return_logits=True)
        _, lg = ss.decode_forward(p_gpu, toks[:, t:t + 1].cuda(), c_gpu, t,
                                  gpu, ctx, return_logits=True)
        lg = lg.cpu()
        if not torch.isfinite(lg).all():
            raise AssertionError("non-finite logits on the card")
        rel = float((lg - lc).norm() / lc.norm())
        worst = max(worst, rel)
    # bf16 matmuls round differently on the card and the CPU; the taco
    # hop then re-quantizes slightly different inputs (see
    # tests/test_torch_model.py for the same bound against JAX)
    if worst > 5e-2:
        raise AssertionError(f"card vs CPU logits rel err {worst}")
    print(f"  smoke qwen2-0.5b taco: card vs CPU logits rel err {worst:.3e}")
    return worst


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    from repro_torch.kernels import ash_compress, ash_decompress, build
    t0 = time.monotonic()
    logs = build.build_all()
    print(f"kernels built in {time.monotonic() - t0:.1f}s")
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log.strip()}")
    kernels = {"compress_wire": ash_compress.compress_wire,
               "decompress_wire": ash_decompress.decompress_wire,
               "decompress_reduce_wire": ash_decompress.decompress_reduce_wire}
    rows = phase_kernels()
    print("phase 2: serving full-width qwen2-0.5b")
    served = phase_serve(kernels)
    print("phase 3: reference check at smoke size")
    phase_reference()
    meta = {
        "compress_wire": ("src/repro_torch/kernels/csrc/ash_compress.cu",
                          "src/repro/kernels/ash_compress.py:199"),
        "decompress_wire": ("src/repro_torch/kernels/csrc/ash_decompress.cu",
                            "src/repro/kernels/ash_decompress.py:171"),
        "decompress_reduce_wire": (
            "src/repro_torch/kernels/csrc/ash_decompress.cu",
            "src/repro/kernels/ash_decompress.py:231"),
    }
    launches = dict(zip(("compress_wire", "decompress_reduce_wire",
                         "decompress_wire"), served["taco"]["launches"]))
    table = []
    for name, (source, replaces) in meta.items():
        r = rows[name]["serve"]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"],
            "large": rows[name]["large"]})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
