// Fused ASH compress (paper §4.4.1), in its two forms:
//
//   * compress_blocks_kernel (K1): (M, 256) block rows -> q (M, 256) payload
//     codes, alpha (M,) f32 and s (M, G) f32 in three arrays.  Replaces the
//     TPU kernel src/repro/kernels/ash_compress.py compress_blocks_pallas
//     (pallas_call at line 99, body _compress_kernel, row math
//     _block_compress at line 34).  The training hops take this form: their
//     slots are above the wire budget of repro_torch.kernels.ops.
//   * compress_wire_kernel (K2): the same row math written straight into the
//     packed TACO wire row.  Replaces compress_wire_pallas (pallas_call at
//     line 218, body _compress_wire_kernel at line 171).  The row is written
//     at the static wire_layout(n) offsets of one uint8 row per slot:
//     payload bytes [0, n), f32 scales (s, or s/alpha when folded) at
//     [n, n + 4 mb G), f32 alpha at [n + 4 mb G, total) when dual.
//
// Both call compress_elem (ash_common.cuh), so pack_wire of K1's output is
// K2's output byte for byte.
//
// Bound on the H100: bytes.  Per element it reads 2 (bf16) or 4 (f32) bytes
// and writes ~1; the arithmetic (~16 f32 operations, 8 of them butterfly
// adds) is far below the f32 rate per byte moved.  The design therefore reads
// each input element once into a register, keeps the block row in registers
// and one 1 KB shared buffer through both reductions and the rotation, and
// writes each output byte once, coalesced.  It is the simple first form: one
// 256-thread block per row, no vector loads, so small serve-shape calls are
// bounded by launch latency rather than by the bytes.
#include "ash_common.cuh"

namespace taco {

template <typename Tin>
__global__ void __launch_bounds__(kBlock)
compress_blocks_kernel(const Tin* __restrict__ x, uint8_t* __restrict__ q,
                       float* __restrict__ alpha, float* __restrict__ scale,
                       int fmt, int groups, float tau, float eps,
                       float scale_eps, float qmax) {
  __shared__ float sh[kBlock];
  __shared__ float red[kWarps];
  const int t = threadIdx.x;
  const size_t row = blockIdx.x;
  float s, a;
  const uint8_t code = compress_elem(to_f32(x[row * kBlock + t]), fmt, groups,
                                     tau, eps, scale_eps, qmax, sh, red, &s,
                                     &a);
  q[row * kBlock + t] = code;
  const int gs = kBlock / groups;
  if (t % gs == 0) scale[row * groups + t / gs] = s;
  if (t == 0) alpha[row] = a;
}

template <typename Tin>
__global__ void __launch_bounds__(kBlock)
compress_wire_kernel(const Tin* __restrict__ x, uint8_t* __restrict__ wire,
                     int n, long long total, int fmt, int groups, int folded,
                     float tau, float eps, float scale_eps, float qmax) {
  __shared__ float sh[kBlock];
  __shared__ float red[kWarps];
  const int t = threadIdx.x;
  const int blk = blockIdx.x;
  const int mb = n / kBlock;
  const Tin* xr = x + static_cast<size_t>(blockIdx.y) * n
                    + static_cast<size_t>(blk) * kBlock;
  uint8_t* wr = wire + static_cast<size_t>(blockIdx.y) * total;
  float s, alpha;
  const uint8_t code = compress_elem(to_f32(xr[t]), fmt, groups, tau, eps,
                                     scale_eps, qmax, sh, red, &s, &alpha);
  wr[static_cast<size_t>(blk) * kBlock + t] = code;
  const int gs = kBlock / groups;
  if (t % gs == 0) {
    float* sc = reinterpret_cast<float*>(wr + n);
    sc[blk * groups + t / gs] = folded ? s / alpha : s;
  }
  if (!folded && t == 0) {
    float* al = reinterpret_cast<float*>(wr + n + 4LL * mb * groups);
    al[blk] = alpha;
  }
}

}  // namespace taco

// x: (rows, 256) bf16 (in_bf16 != 0) or f32, contiguous; q: (rows, 256)
// payload bytes; alpha: (rows,) f32; scale: (rows, groups) f32.  One block
// per row on grid.x.  Returns cudaGetLastError() after the launch.
extern "C" int taco_compress_blocks(const void* x, void* q, void* alpha,
                                    void* scale, int in_bf16, long long rows,
                                    int fmt, int groups, float tau, float eps,
                                    float scale_eps, float qmax,
                                    void* stream) {
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* qb = static_cast<uint8_t*>(q);
  float* a = static_cast<float*>(alpha);
  float* s = static_cast<float*>(scale);
  if (in_bf16) {
    taco::compress_blocks_kernel<__nv_bfloat16><<<grid, taco::kBlock, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), qb, a, s, fmt, groups, tau, eps,
        scale_eps, qmax);
  } else {
    taco::compress_blocks_kernel<float><<<grid, taco::kBlock, 0, st>>>(
        static_cast<const float*>(x), qb, a, s, fmt, groups, tau, eps,
        scale_eps, qmax);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (slots, n) bf16 (in_bf16 != 0) or f32, contiguous; wire: (slots, total)
// uint8.  Returns cudaGetLastError() after the launch.
extern "C" int taco_compress_wire(const void* x, void* wire, int in_bf16,
                                  int slots, int n, long long total, int fmt,
                                  int groups, int folded, float tau, float eps,
                                  float scale_eps, float qmax, void* stream) {
  const dim3 grid(n / taco::kBlock, slots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* w = static_cast<uint8_t*>(wire);
  if (in_bf16) {
    taco::compress_wire_kernel<__nv_bfloat16><<<grid, taco::kBlock, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w, n, total, fmt, groups, folded,
        tau, eps, scale_eps, qmax);
  } else {
    taco::compress_wire_kernel<float><<<grid, taco::kBlock, 0, st>>>(
        static_cast<const float*>(x), w, n, total, fmt, groups, folded, tau,
        eps, scale_eps, qmax);
  }
  return static_cast<int>(cudaGetLastError());
}
