"""K5's and K6's warp bodies at the serve shape with R rows (warps) per
thread block.

    python3 scripts/serve_rows_per_block.py [--other CHECKOUT]  # on a card

At the serve shape (one slot of n = 3584 = 14 rows of B = 256) the
decompress kernels are bound by latency, not bytes.  This builds the
shared bodies ``decompress_row`` (K5) and ``reduce_row`` (K6, one peer) of
``src/repro_torch/kernels/csrc`` into kernels whose block takes R rows, for
R = 1, 2, 4, 8 (K5 and K6 take 8; the format and the group count stay
run-time arguments, as in K5 and K6), and times each (device time from
the profiler, as ``chip_smoke.py``) under dual and folded metadata, after
checking that it gives K5's or K6's bits.  With ``--other`` it also times
the ``decompress_wire`` and ``decompress_reduce_wire`` kernels of another
checkout (built there by its own ``kernels/build.py``) on the same wire.
Prints the card's name and power limit first.

    python3 scripts/serve_rows_per_block.py --reduce-variants  # on a card

times instead K4's and K6's peer sum at the shapes where it carries bytes
("train": taco, n = 7,340,032, P = 1; "tp4 hop": n = 1,835,008, P = 4;
"large": K6's wire of n = 4096 * 896, P = 4), built four ways: with the
one-scale register when a group spans the lane (``PeerLane<E, 1>``) or
with the generic E-slot form alone (``PeerLane<E, E>``), each with
``__launch_bounds__(256, 4)`` (the 64-register cap) or ``(256)`` alone.
Prints each variant's registers and spills as ptxas reports them, holds
each bit for bit against the kernel it copies, and times the kernel
beside them, in the order kernel, variants, variants reversed.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

KERNEL = r"""
#include "ash_common.cuh"
namespace taco {
template <int E>
__global__ void __launch_bounds__(256)
rows_per_block_kernel(const uint8_t* __restrict__ wire,
                      float* __restrict__ out, int n, long long total,
                      int fmt, int groups, int folded, float inv_sqrt_b) {
  constexpr int B = 32 * E;
  const int mb = n / B;
  const int blk = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (blk >= mb) return;
  const size_t b = static_cast<size_t>(blk);
  const uint8_t* meta = wire + n;
  decompress_row<E, false>(
      wire + b * B, meta + 4 * b * groups,
      folded ? nullptr : meta + 4 * (static_cast<size_t>(mb) * groups + b),
      out + b * B, fmt, groups, inv_sqrt_b);
}
template <int E>
__global__ void __launch_bounds__(256, 4)   // K6's register cap at E = 8
reduce_rows_per_block_kernel(const uint8_t* __restrict__ wire,
                             float* __restrict__ out, int n,
                             long long total, int fmt, int groups,
                             int folded, float inv_sqrt_b) {
  constexpr int B = 32 * E;
  const int mb = n / B;
  const int blk = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (blk >= mb) return;
  const size_t b = static_cast<size_t>(blk);
  const size_t stride = static_cast<size_t>(total);
  const uint8_t* meta = wire + n;
  reduce_row<E, false>(
      1, wire + b * B, stride, meta + 4 * b * groups, stride,
      folded ? nullptr : meta + 4 * (static_cast<size_t>(mb) * groups + b),
      stride, out + b * B, fmt, groups, inv_sqrt_b);
}
}  // namespace taco
extern "C" int rows_per_block(const void* wire, void* out, int n,
                              long long total, int rows_per_block,
                              int folded, float inv_sqrt_b, int reduce,
                              void* stream) {
  const int mb = n / 256;
  const int grid = (mb + rows_per_block - 1) / rows_per_block;
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const uint8_t*>(wire);
  auto o = static_cast<float*>(out);
  if (reduce)
    taco::reduce_rows_per_block_kernel<8><<<grid, rows_per_block * 32, 0, s>>>(
        w, o, n, total, taco::kE4M3, 1, folded, inv_sqrt_b);
  else
    taco::rows_per_block_kernel<8><<<grid, rows_per_block * 32, 0, s>>>(
        w, o, n, total, taco::kE4M3, 1, folded, inv_sqrt_b);
  return static_cast<int>(cudaGetLastError());
}
"""


def _build(name: str, text: str, resources: bool = False) -> ctypes.CDLL:
    """``text`` compiled against ``src/repro_torch/kernels/csrc`` into
    ``build/kernels/lib<name>.so``, loaded.  ``resources`` prints what
    ptxas reports of each kernel: registers a thread and bytes spilled."""
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"{name}.cu"
    src.write_text(text)
    lib_path = build.BUILD_DIR / f"lib{name}.so"
    done = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, *["-Xptxas", "-v"] * resources,
         "-I", str(build.CSRC), "-o", str(lib_path), str(src)], check=True,
        capture_output=True, text=True)
    kernel = ""
    for line in done.stderr.splitlines() if resources else ():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill" in line or "Used" in line:
            print(f"ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
    return ctypes.CDLL(str(lib_path))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--other", type=pathlib.Path, default=None,
                    help="another checkout whose decompress_wire to time")
    ap.add_argument("--reduce-variants", action="store_true",
                    help="time K4's and K6's peer sum variants instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("serve_rows_per_block: no CUDA device")
    import chip_smoke as cs
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ash_compress, ash_decompress, build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.reduce_variants:
        reduce_variants(cs, codec_from_spec, ash_compress, ash_decompress)
        return
    lib = _build("rows_per_block", KERNEL)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rows_per_block.argtypes = [p, p, i, ctypes.c_longlong, i, i, f, i,
                                   p]
    other = None
    if args.other is not None:
        subprocess.run([sys.executable, "-c", "from repro_torch.kernels "
                        "import build; build.build_all(('ash_decompress',))"],
                       cwd=args.other,
                       env=dict(os.environ, PYTHONPATH="src"), check=True,
                       capture_output=True)
        other = ctypes.CDLL(str(next((args.other / "build" / "kernels")
                                     .glob("libash_decompress-*.so"))))
        for fn in ("taco_decompress_wire", "taco_decompress_reduce_wire"):
            getattr(other, fn).argtypes = [p, p, i, i, ctypes.c_longlong, i,
                                           i, i, i, i, f, p]
    n = 3584
    gen = torch.Generator().manual_seed(0)
    for spec in ("taco", "taco:folded"):
        cfg = codec_from_spec(spec).cfg
        x = (torch.randn((1, n), generator=gen) * 0.02).cuda()
        wire = ash_compress.compress_wire(x.to(torch.bfloat16), cfg)
        total, folded = wire.shape[1], int(cfg.metadata == "folded")
        out = torch.empty((1, n), dtype=torch.float32, device="cuda")

        def stream():
            return torch.cuda.current_stream().cuda_stream
        bodies = (("decompress_row", "decompress_wire", 0,
                   ash_decompress.decompress_wire(wire, n, cfg)),
                  ("reduce_row", "decompress_reduce_wire", 1,
                   ash_decompress.decompress_reduce_wire(wire, n, cfg)
                   .reshape(1, n)))
        for body, wrapper, reduce, want in bodies:
            if other is not None:
                def theirs(fn=getattr(other, f"taco_{wrapper}")):
                    fn(wire.data_ptr(), out.data_ptr(), 1, n, total, 256, 0,
                       0, 1, folded, 1 / 16, stream())
                ms, _ = cs.kernel_ms(theirs, f"{wrapper}_kernel")
                print(f"{spec:12s} {str(args.other)}: {wrapper} "
                      f"{ms:.7f} ms")
            for rpb in (1, 2, 4, 8):
                def fn(rpb=rpb, reduce=reduce):
                    if lib.rows_per_block(wire.data_ptr(), out.data_ptr(), n,
                                          total, rpb, folded, 1 / 16, reduce,
                                          stream()):
                        raise RuntimeError("launch failed")
                fn()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    bad = int((out != want).sum())
                    raise AssertionError(
                        f"{spec}: {body}, {rpb} rows per block, differs "
                        f"from {wrapper} in {bad} of {n} values")
                name = ("reduce_" if reduce else "") + "rows_per_block_kernel"
                ms, _ = cs.kernel_ms(fn, name)
                print(f"{spec:12s} {body}, {rpb} rows per block: "
                      f"{ms:.7f} ms")


# K4's and K6's peer sum as reduce_row had it when this script was written,
# copied here so that a later change of ash_common.cuh leaves the variants
# as they were: ONE picks the one-scale register (PeerLane<E, 1>) when a
# group spans the lane, MINB is the second __launch_bounds__ argument.
VARIANTS = r"""
#include "ash_common.cuh"
namespace taco {
template <int E, int S>
struct VarPeer {
  uint32_t w[(E + 3) / 4];
  float s[S];
  float a;
};
template <int E, int S>
__device__ __forceinline__ void var_load(VarPeer<E, S>& pl, const uint8_t* q,
                                         const uint8_t* scale,
                                         const uint8_t* alpha, int lane,
                                         int gs, int gshift) {
  load_codes<E>(q + lane * E, pl.w);
#pragma unroll
  for (int j = 0; j < S; ++j)
    if ((j & (gs - 1)) == 0)
      pl.s[j] = load_f32(scale + 4 * ((lane * E + j) >> gshift));
  pl.a = alpha == nullptr ? 1.f : load_f32(alpha);
}
template <int E, int S>
__device__ __forceinline__ void var_add(float (&acc)[E],
                                        const VarPeer<E, S>& pl, bool dual,
                                        int fmt, int gs) {
  const float a = pl.a;
  float f = 0.f;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (j < S && (j & (gs - 1)) == 0) {
      f = pl.s[j < S ? j : 0];
      if (dual) f = f / a;
    }
    acc[j] = __fmaf_rn(decode_code(code_byte(pl.w, j), fmt), f, acc[j]);
  }
}
template <int E, int S>
__device__ __forceinline__ void var_sum(float (&acc)[E], int peers,
                                        const uint8_t* q, size_t qs,
                                        const uint8_t* scale, size_t ss,
                                        const uint8_t* alpha, size_t as,
                                        int fmt, int lane, int gs,
                                        int gshift) {
  const bool dual = alpha != nullptr;
  VarPeer<E, S> x, y;
  for (int p = 0; p < peers; p += 2) {
    const size_t p0 = p, p1 = p + 1;
    var_load<E, S>(x, q + p0 * qs, scale + p0 * ss,
                   dual ? alpha + p0 * as : nullptr, lane, gs, gshift);
    if (p + 1 < peers)
      var_load<E, S>(y, q + p1 * qs, scale + p1 * ss,
                     dual ? alpha + p1 * as : nullptr, lane, gs, gshift);
    var_add<E, S>(acc, x, dual, fmt, gs);
    if (p + 1 < peers) var_add<E, S>(acc, y, dual, fmt, gs);
  }
}
// f32 compute, B = 256; row r's codes, scales and alpha at q + 256 r,
// scale + 4 G r and alpha + 4 r, peer p's one stride further on per peer
template <bool ONE, int MINB>
__global__ void __launch_bounds__(256, MINB)
reduce_variant_kernel(const uint8_t* __restrict__ q, size_t q_stride,
                      const uint8_t* __restrict__ scale, size_t scale_stride,
                      const uint8_t* __restrict__ alpha, size_t alpha_stride,
                      float* __restrict__ out, int peers, long long rows,
                      int fmt, int groups, float inv_sqrt_b) {
  constexpr int E = 8, B = 256;
  const long long row = blockIdx.x * 8LL + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t r = static_cast<size_t>(row);
  const int lane = threadIdx.x & 31;
  const int gs = B / groups;
  const int gshift = __ffs(gs) - 1;
  const uint8_t* qr = q + r * B;
  const uint8_t* sr = scale + 4 * r * groups;
  const uint8_t* ar = alpha == nullptr ? nullptr : alpha + 4 * r;
  float acc[E];
#pragma unroll
  for (int j = 0; j < E; ++j) acc[j] = 0.f;
  if (ONE && gs >= E)
    var_sum<E, 1>(acc, peers, qr, q_stride, sr, scale_stride, ar,
                  alpha_stride, fmt, lane, gs, gshift);
  else
    var_sum<E, E>(acc, peers, qr, q_stride, sr, scale_stride, ar,
                  alpha_stride, fmt, lane, gs, gshift);
  rotate_row<E>(acc, lane);
#pragma unroll
  for (int j = 0; j < E; ++j) acc[j] *= inv_sqrt_b;
  store_out<E>(out + r * B + lane * E, acc);
}
}  // namespace taco
extern "C" int reduce_variant(const void* q, long long q_stride,
                              const void* scale, long long scale_stride,
                              const void* alpha, long long alpha_stride,
                              void* out, int peers, long long rows, int fmt,
                              int groups, float inv_sqrt_b, int one,
                              int capped, void* stream) {
  const dim3 grid(static_cast<unsigned>((rows + 7) / 8));
  auto s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) {
    kernel<<<grid, 256, 0, s>>>(
        static_cast<const uint8_t*>(q), q_stride,
        static_cast<const uint8_t*>(scale), scale_stride,
        static_cast<const uint8_t*>(alpha), alpha_stride,
        static_cast<float*>(out), peers, rows, fmt, groups, inv_sqrt_b);
    return static_cast<int>(cudaGetLastError());
  };
  if (one)
    return capped ? go(taco::reduce_variant_kernel<true, 4>)
                  : go(taco::reduce_variant_kernel<true, 1>);
  return capped ? go(taco::reduce_variant_kernel<false, 4>)
                : go(taco::reduce_variant_kernel<false, 1>);
}
"""


def reduce_variants(cs, codec_from_spec, ash_compress, ash_decompress):
    """Time the four builds of VARIANTS against K4 (block form) and K6
    (wire form) at the shapes where their peer sum carries bytes, after
    holding each bit for bit against the kernel."""
    lib = _build("reduce_variants", VARIANTS, resources=True)
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.reduce_variant.argtypes = [p, ll, p, ll, p, ll, p, i, ll, i, i, f,
                                   i, i, p]
    kern = ash_decompress._lib()
    cfg = codec_from_spec("taco").cfg
    b, _, inv = ash_compress.kernel_args(cfg)
    fmt, groups = ash_compress.FMT_CODE[cfg.fmt], ash_compress.groups(cfg)
    names = {(1, 1): "one scale, cap 4", (0, 1): "E slots, cap 4",
             (1, 0): "one scale, no cap", (0, 0): "E slots, no cap"}
    gen = torch.Generator().manual_seed(0)

    def stream():
        return torch.cuda.current_stream().cuda_stream
    for label, n, peers, wire_form in (
            ("train", cs.TRAIN_N, 1, False),
            ("tp4 hop", cs.TRAIN_N // 4, 4, False),
            ("large", cs.LARGE_N, 4, True)):
        x = (torch.randn((peers, n), generator=gen) * 0.02).cuda()
        m = n // b
        out = torch.empty((m, b), dtype=torch.float32, device="cuda")
        if wire_form:
            wire = ash_compress.compress_wire(x.to(torch.bfloat16), cfg)
            total = wire.shape[1]
            q, s, a = wire, wire[0, n:], wire[0, n + 4 * m * groups:]
            strides = (total, total, total)

            def theirs():
                kern.taco_decompress_reduce_wire(
                    wire.data_ptr(), out.data_ptr(), peers, n, total, b, 0,
                    fmt, groups, 0, inv, stream())
            kname = "decompress_reduce_wire_kernel"
        else:
            q, a, s = ash_compress.compress_blocks(
                x.to(torch.bfloat16).reshape(peers * m, b), cfg)
            strides = (m * b, 4 * m * groups, 4 * m)

            def theirs():
                kern.taco_decompress_reduce(
                    q.data_ptr(), s.data_ptr(), a.data_ptr(), out.data_ptr(),
                    peers, m, b, 0, fmt, groups, inv, stream())
            kname = "decompress_reduce_kernel"
        theirs()
        torch.cuda.synchronize()
        want = out.clone()
        fns = {}
        for key, name in names.items():
            def fn(one=key[0], capped=key[1]):
                if lib.reduce_variant(q.data_ptr(), strides[0], s.data_ptr(),
                                      strides[1], a.data_ptr(), strides[2],
                                      out.data_ptr(), peers, m, fmt, groups,
                                      inv, one, capped, stream()):
                    raise RuntimeError("launch failed")
            out.zero_()
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{label}: {name} differs from {kname} "
                                     f"in {int((out != want).sum())} values")
            fns[name] = fn
        ms, _ = cs.kernel_ms(theirs, kname)
        print(f"{label:8s} P={peers} {kname}: {ms:.7f} ms")
        for name in [*fns, *reversed(fns)]:
            ms, _ = cs.kernel_ms(fns[name], "reduce_variant_kernel")
            print(f"{label:8s} P={peers} {name}: {ms:.7f} ms")


if __name__ == "__main__":
    main()
