"""K5's warp body at the serve shape with R rows (warps) per thread block.

    python3 scripts/serve_rows_per_block.py [--other CHECKOUT]  # on a card

At the serve shape (one slot of n = 3584 = 14 rows of B = 256) the
decompress kernels are bound by latency, not bytes.  This builds the
shared body ``decompress_row`` of ``src/repro_torch/kernels/csrc`` into a
kernel whose block takes R rows, for R = 1, 2, 4, 8 (K5 takes 8; the
format and the group count stay run-time arguments, as in K5), and
times each (device time from the profiler, as ``chip_smoke.py``) under
dual and folded metadata, after checking that it gives K5's bits.  With
``--other`` it also times the ``decompress_wire`` kernel of another
checkout (built there by its own ``kernels/build.py``) on the same wire.
Prints the card's name and power limit first.
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
}  // namespace taco
extern "C" int rows_per_block(const void* wire, void* out, int n,
                              long long total, int rows_per_block,
                              int folded, float inv_sqrt_b, void* stream) {
  const int mb = n / 256;
  taco::rows_per_block_kernel<8>
      <<<(mb + rows_per_block - 1) / rows_per_block, rows_per_block * 32, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(wire), static_cast<float*>(out), n,
          total, taco::kE4M3, 1, folded, inv_sqrt_b);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--other", type=pathlib.Path, default=None,
                    help="another checkout whose decompress_wire to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("serve_rows_per_block: no CUDA device")
    import chip_smoke as cs
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ash_compress, ash_decompress, build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "rows_per_block.cu"
    src.write_text(KERNEL)
    lib_path = build.BUILD_DIR / "librows_per_block.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib_path), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rows_per_block.argtypes = [p, p, i, ctypes.c_longlong, i, i, f, p]
    other = None
    if args.other is not None:
        subprocess.run([sys.executable, "-c", "from repro_torch.kernels "
                        "import build; build.build_all(('ash_decompress',))"],
                       cwd=args.other,
                       env=dict(os.environ, PYTHONPATH="src"), check=True,
                       capture_output=True)
        other = ctypes.CDLL(str(next((args.other / "build" / "kernels")
                                     .glob("libash_decompress-*.so"))))
        other.taco_decompress_wire.argtypes = [p, p, i, i, ctypes.c_longlong,
                                               i, i, i, i, i, f, p]
    n = 3584
    gen = torch.Generator().manual_seed(0)
    for spec in ("taco", "taco:folded"):
        cfg = codec_from_spec(spec).cfg
        x = (torch.randn((1, n), generator=gen) * 0.02).cuda()
        wire = ash_compress.compress_wire(x.to(torch.bfloat16), cfg)
        total, folded = wire.shape[1], int(cfg.metadata == "folded")
        want = ash_decompress.decompress_wire(wire, n, cfg)
        out = torch.empty_like(want)

        def stream():
            return torch.cuda.current_stream().cuda_stream
        if other is not None:
            ms, _ = cs.kernel_ms(lambda: other.taco_decompress_wire(
                wire.data_ptr(), out.data_ptr(), 1, n, total, 256, 0, 0, 1,
                folded, 1 / 16, stream()), "decompress_wire_kernel")
            print(f"{spec:12s} {str(args.other)}: decompress_wire "
                  f"{ms:.7f} ms")
        for rpb in (1, 2, 4, 8):
            def fn(rpb=rpb):
                if lib.rows_per_block(wire.data_ptr(), out.data_ptr(), n,
                                      total, rpb, folded, 1 / 16, stream()):
                    raise RuntimeError("launch failed")
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                bad = int((out != want).sum())
                raise AssertionError(f"{spec}: {rpb} rows per block differs "
                                     f"from K5 in {bad} of {n} values")
            ms, _ = cs.kernel_ms(fn, "rows_per_block_kernel")
            print(f"{spec:12s} decompress_row, {rpb} rows per block: "
                  f"{ms:.7f} ms")


if __name__ == "__main__":
    main()
