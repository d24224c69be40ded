// Fused ASH compress (paper §4.4.1), in its two forms:
//
//   * compress_blocks_kernel (K1): (M, B) block rows -> q (M, B) payload
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
// Both call compress_row (ash_common.cuh) and differ only in the pointers
// they hand it, so pack_wire of K1's output is K2's output byte for byte.
// At an f32 compute dtype compress_row rounds each step once in the order of
// repro_torch.kernels.ref.compress_blocks_ref, so both give its bits.
// Both are built for B = 32 .. 512 (E = B / 32 elements per lane) and for
// an f32 or a bf16 compute dtype (with_shape).
//
// Bound on the H100: bytes.  Per element it reads 2 (bf16) or 4 (f32) bytes
// and writes 1 (plus 4 G + 4 bytes of metadata per row); its ~17 f32
// operations per element (8 of them butterfly adds) are far below the f32
// rate per byte moved.  So the design keeps loads in flight and spends
// nothing on synchronisation: ONE WARP PER ROW, 8 rows per 256-thread
// block.  Lane l reads its 8 consecutive elements with one 16-byte load
// (bf16) or two (f32), keeps the row in registers through both reductions
// (inside the lane, then by xor shuffles) and the rotation (3 butterfly
// stages in the lane, 5 across lanes by __shfl_xor_sync), and writes its 8
// payload bytes with one 8-byte store, so a warp reads and writes its row as
// one coalesced span.  No shared memory and no __syncthreads: a warp past the
// last row returns at once.  Loads and stores fall back to narrower widths
// where an address is not aligned (an offset view; a wire row at slot *
// total with total = 4 mod 8), chosen per address in the kernel.
#include "ash_common.cuh"

namespace taco {

template <int E, bool BF, typename Tin>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
compress_blocks_kernel(const Tin* __restrict__ x, uint8_t* __restrict__ q,
                       float* __restrict__ alpha, float* __restrict__ scale,
                       long long rows, int fmt, int groups, float tau,
                       float eps, float scale_eps, float qmax,
                       float inv_sqrt_b) {
  constexpr int B = 32 * E;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock
                        + (threadIdx.x >> 5);
  if (row >= rows) return;                 // whole warps only
  const size_t r = static_cast<size_t>(row);
  compress_row<E, BF>(x + r * B, q + r * B, scale + r * groups, alpha + r,
                      false, fmt, groups, tau, eps, scale_eps, qmax,
                      inv_sqrt_b);
}

template <int E, bool BF, typename Tin>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
compress_wire_kernel(const Tin* __restrict__ x, uint8_t* __restrict__ wire,
                     int n, long long total, int fmt, int groups, int folded,
                     float tau, float eps, float scale_eps, float qmax,
                     float inv_sqrt_b) {
  constexpr int B = 32 * E;
  const int mb = n / B;
  const int blk = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (blk >= mb) return;                   // whole warps only
  const size_t slot = blockIdx.y;
  uint8_t* wr = wire + slot * static_cast<size_t>(total);
  float* sc = reinterpret_cast<float*>(wr + n);
  float* al = folded ? nullptr
                     : reinterpret_cast<float*>(wr + n + 4LL * mb * groups);
  compress_row<E, BF>(x + slot * n + static_cast<size_t>(blk) * B,
                      wr + static_cast<size_t>(blk) * B,
                      sc + static_cast<size_t>(blk) * groups,
                      al == nullptr ? nullptr : al + blk, folded != 0, fmt,
                      groups, tau, eps, scale_eps, qmax, inv_sqrt_b);
}

}  // namespace taco

// x: (rows, block) bf16 (in_bf16 != 0) or f32, contiguous; q: (rows, block)
// payload bytes; alpha: (rows,) f32; scale: (rows, groups) f32.  One warp
// per row, 8 rows per block on grid.x; bf16_compute selects the bf16
// rounding of the plain version; inv_sqrt_b is its 1/sqrt(block) in the
// compute dtype.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a block size outside 32 .. 512).
extern "C" int taco_compress_blocks(const void* x, void* q, void* alpha,
                                    void* scale, int in_bf16, long long rows,
                                    int block, int bf16_compute, int fmt,
                                    int groups, float tau, float eps,
                                    float scale_eps, float qmax,
                                    float inv_sqrt_b, void* stream) {
  using namespace taco;
  const dim3 grid(static_cast<unsigned>(
      (rows + kRowsPerBlock - 1) / kRowsPerBlock));
  const dim3 block_dim(kRowsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* qb = static_cast<uint8_t*>(q);
  float* a = static_cast<float*>(alpha);
  float* s = static_cast<float*>(scale);
  return with_shape(block, bf16_compute, [&](auto shape) {
    using S = decltype(shape);
    if (in_bf16) {
      compress_blocks_kernel<S::B / 32, S::BF><<<grid, block_dim, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), qb, a, s, rows, fmt, groups,
          tau, eps, scale_eps, qmax, inv_sqrt_b);
    } else {
      compress_blocks_kernel<S::B / 32, S::BF><<<grid, block_dim, 0, st>>>(
          static_cast<const float*>(x), qb, a, s, rows, fmt, groups, tau,
          eps, scale_eps, qmax, inv_sqrt_b);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// x: (slots, n) bf16 (in_bf16 != 0) or f32, contiguous; wire: (slots, total)
// uint8.  One warp per block row, 8 rows per block on grid.x, one slot per
// grid.y; the other arguments as for taco_compress_blocks.
extern "C" int taco_compress_wire(const void* x, void* wire, int in_bf16,
                                  int slots, int n, long long total,
                                  int block, int bf16_compute, int fmt,
                                  int groups, int folded, float tau,
                                  float eps, float scale_eps, float qmax,
                                  float inv_sqrt_b, void* stream) {
  using namespace taco;
  const int mb = n / block;
  const dim3 grid((mb + kRowsPerBlock - 1) / kRowsPerBlock, slots);
  const dim3 block_dim(kRowsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* w = static_cast<uint8_t*>(wire);
  return with_shape(block, bf16_compute, [&](auto shape) {
    using S = decltype(shape);
    if (in_bf16) {
      compress_wire_kernel<S::B / 32, S::BF><<<grid, block_dim, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), w, n, total, fmt, groups,
          folded, tau, eps, scale_eps, qmax, inv_sqrt_b);
    } else {
      compress_wire_kernel<S::B / 32, S::BF><<<grid, block_dim, 0, st>>>(
          static_cast<const float*>(x), w, n, total, fmt, groups, folded,
          tau, eps, scale_eps, qmax, inv_sqrt_b);
    }
    return static_cast<int>(cudaGetLastError());
  });
}
