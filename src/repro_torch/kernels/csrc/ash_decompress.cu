// Fused ASH decompress (paper §4.1 "fused_ash_decompress"), in block form
// and in wire form.  Replaces four TPU kernels of
// src/repro/kernels/ash_decompress.py:
//   * decompress_blocks_pallas (K3; pallas_call at line 68, body
//     _decompress_kernel): the all-gather receiver on block arrays,
//     g = (q s) H / 16, then g / alpha when the metadata is dual;
//   * decompress_reduce_pallas (K4; pallas_call at line 111, body
//     _decompress_reduce_kernel at line 84): the reduce-scatter receiver on a
//     peer stack, sum_p q_p (s_p / alpha_p) over the P peers in peer-index
//     order in the rotated domain, then ONE rotation (H is linear);
//   * decompress_wire_pallas (K5; pallas_call at line 193) and
//     decompress_reduce_wire_pallas (K6; pallas_call at line 255): the same
//     two operators reading the wire fields at the static wire_layout(n)
//     offsets that ash_compress.cu writes (the JAX package's _wire_fields
//     bitcasts).
// Each block form and its wire form call one shared body (decompress_row,
// reduce_elem in ash_common.cuh), so K3 on unpack_wire(w) equals K5 on w, and
// K4 equals K6, bit for bit.  All four are built for B = 32 .. 512 and for an
// f32 or a bf16 compute dtype (with_shape); they write f32.
//
// Bound on the H100: bytes.  Each output element costs ~1 payload byte per
// peer read and 4 bytes written, against ~11 f32 operations (+2 per extra
// peer), far below the f32 rate per byte moved.  So the design keeps loads in
// flight and spends nothing on synchronisation.
//   * K3 and K5: ONE WARP PER ROW, 8 rows per 256-thread block, as K1 and K2.
//     Lane l reads its E = B/32 codes with the widest load the address allows
//     (one 8-byte load at B = 256), its group's scale (E/gs scales when a
//     group is smaller than E) and the row's alpha, rotates in registers by
//     rotate_row (log2(E) stages in the lane, 5 across lanes by
//     __shfl_xor_sync; compress_row's butterfly, with wht's stage order and
//     pairing, so K3 on one peer equals K4 bit for bit under folded f32
//     metadata), and writes
//     its E f32 outputs with 16-byte stores: a warp reads and writes its row
//     as one coalesced span.  No shared memory and no __syncthreads: a warp
//     past the last row returns at once.  A wire view may start at any byte:
//     the f32 fields are read bytewise where they are not 4-byte aligned.
//   * K4 and K6: one B-thread block per row, one element per thread, the
//     shared-memory butterfly wht; the peer loop accumulates in a register so
//     P peers cost one rotation.  K6 reads its f32 fields with 4-byte loads,
//     so its wrapper refuses a wire that is not 4-byte aligned.
#include "ash_common.cuh"

namespace taco {

template <int E, bool BF>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
decompress_blocks_kernel(const uint8_t* __restrict__ q,
                         const float* __restrict__ scale,
                         const float* __restrict__ alpha,
                         float* __restrict__ out, long long rows, int fmt,
                         int groups, float inv_sqrt_b) {
  constexpr int B = 32 * E;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock
                        + (threadIdx.x >> 5);
  if (row >= rows) return;                 // whole warps only
  const size_t r = static_cast<size_t>(row);
  decompress_row<E, BF>(
      q + r * B, reinterpret_cast<const uint8_t*>(scale + r * groups),
      alpha == nullptr ? nullptr
                       : reinterpret_cast<const uint8_t*>(alpha + r),
      out + r * B, fmt, groups, inv_sqrt_b);
}

template <int B, bool BF>
__global__ void __launch_bounds__(B)
decompress_reduce_kernel(const uint8_t* __restrict__ q,
                         const float* __restrict__ scale,
                         const float* __restrict__ alpha,
                         float* __restrict__ out, int peers, long long rows,
                         int fmt, int groups, float inv_sqrt_b) {
  __shared__ float sh[B];
  const int t = threadIdx.x;
  const size_t row = blockIdx.x;
  const size_t m = static_cast<size_t>(rows);
  out[row * B + t] = reduce_elem<B, BF>(
      peers, q + row * B + t, m * B,
      scale + row * groups + t / (B / groups), m * groups,
      alpha == nullptr ? nullptr : alpha + row, m, fmt, inv_sqrt_b, sh);
}

template <int E, bool BF>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
decompress_wire_kernel(const uint8_t* __restrict__ wire,
                       float* __restrict__ out, int n, long long total,
                       int fmt, int groups, int folded, float inv_sqrt_b) {
  constexpr int B = 32 * E;
  const int mb = n / B;
  const int blk = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (blk >= mb) return;                   // whole warps only
  const size_t slot = blockIdx.y;
  const size_t b = static_cast<size_t>(blk);
  // payload [0, n), f32 scales [n, n + 4 mb G), f32 alpha after them (dual)
  const uint8_t* wr = wire + slot * static_cast<size_t>(total);
  const uint8_t* meta = wr + n;
  decompress_row<E, BF>(
      wr + b * B, meta + 4 * b * groups,
      folded ? nullptr : meta + 4 * (static_cast<size_t>(mb) * groups + b),
      out + slot * n + b * B, fmt, groups, inv_sqrt_b);
}

template <int B, bool BF>
__global__ void __launch_bounds__(B)
decompress_reduce_wire_kernel(const uint8_t* __restrict__ wire,
                              float* __restrict__ out, int peers, int n,
                              long long total, int fmt, int groups,
                              int folded, float inv_sqrt_b) {
  __shared__ float sh[B];
  const int t = threadIdx.x;
  const int blk = blockIdx.x;
  const int mb = n / B;
  // wire rows are 4-byte multiples (n is a multiple of B >= 32), so each
  // peer's f32 fields sit total / 4 floats after the previous peer's
  const size_t fstride = static_cast<size_t>(total) / 4;
  const float* scale = reinterpret_cast<const float*>(wire + n)
                       + blk * groups + t / (B / groups);
  const float* al =
      folded ? nullptr
             : reinterpret_cast<const float*>(wire + n + 4LL * mb * groups)
                   + blk;
  out[static_cast<size_t>(blk) * B + t] = reduce_elem<B, BF>(
      peers, wire + static_cast<size_t>(blk) * B + t,
      static_cast<size_t>(total), scale, fstride, al, fstride, fmt,
      inv_sqrt_b, sh);
}

}  // namespace taco

// Common arguments: block is the block size B, bf16_compute selects the
// bf16 rounding of the plain version, inv_sqrt_b is its 1/sqrt(B) in the
// compute dtype.  Each returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a block size outside 32 .. 512).

// q: (rows, B) payload bytes; scale: (rows, groups) f32; alpha: (rows,) f32
// or null (folded); out: (rows, B) f32.  One warp per row, 8 rows per block
// on grid.x.
extern "C" int taco_decompress_blocks(const void* q, const void* scale,
                                      const void* alpha, void* out,
                                      long long rows, int block,
                                      int bf16_compute, int fmt, int groups,
                                      float inv_sqrt_b, void* stream) {
  using namespace taco;
  const dim3 grid(static_cast<unsigned>(
      (rows + kRowsPerBlock - 1) / kRowsPerBlock));
  return with_shape(block, bf16_compute, [&](auto shape) {
    using S = decltype(shape);
    decompress_blocks_kernel<S::B / 32, S::BF>
        <<<grid, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
            static_cast<const float*>(alpha), static_cast<float*>(out), rows,
            fmt, groups, inv_sqrt_b);
    return static_cast<int>(cudaGetLastError());
  });
}

// q: (peers, rows, B) payload bytes; scale: (peers, rows, groups) f32;
// alpha: (peers, rows) f32 or null (folded); out: (rows, B) f32.  One
// B-thread block per row on grid.x.
extern "C" int taco_decompress_reduce(const void* q, const void* scale,
                                      const void* alpha, void* out, int peers,
                                      long long rows, int block,
                                      int bf16_compute, int fmt, int groups,
                                      float inv_sqrt_b, void* stream) {
  return taco::with_shape(block, bf16_compute, [&](auto shape) {
    using S = decltype(shape);
    taco::decompress_reduce_kernel<S::B, S::BF>
        <<<static_cast<unsigned>(rows), S::B, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
            static_cast<const float*>(alpha), static_cast<float*>(out), peers,
            rows, fmt, groups, inv_sqrt_b);
    return static_cast<int>(cudaGetLastError());
  });
}

// wire: (slots, total) uint8 at any byte address; out: (slots, n) f32.  One
// warp per block row, 8 rows per block on grid.x, one slot per grid.y.
extern "C" int taco_decompress_wire(const void* wire, void* out, int slots,
                                    int n, long long total, int block,
                                    int bf16_compute, int fmt, int groups,
                                    int folded, float inv_sqrt_b,
                                    void* stream) {
  using namespace taco;
  const int mb = n / block;
  const dim3 grid((mb + kRowsPerBlock - 1) / kRowsPerBlock, slots);
  return with_shape(block, bf16_compute, [&](auto shape) {
    using S = decltype(shape);
    decompress_wire_kernel<S::B / 32, S::BF>
        <<<grid, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(wire), static_cast<float*>(out), n,
            total, fmt, groups, folded, inv_sqrt_b);
    return static_cast<int>(cudaGetLastError());
  });
}

// wire: (peers, total) uint8, 4-byte aligned; out: (n / B, B) f32.  One
// B-thread block per row on grid.x.
extern "C" int taco_decompress_reduce_wire(const void* wire, void* out,
                                           int peers, int n, long long total,
                                           int block, int bf16_compute,
                                           int fmt, int groups, int folded,
                                           float inv_sqrt_b, void* stream) {
  return taco::with_shape(block, bf16_compute, [&](auto shape) {
    using S = decltype(shape);
    taco::decompress_reduce_wire_kernel<S::B, S::BF>
        <<<n / S::B, S::B, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(wire), static_cast<float*>(out),
            peers, n, total, fmt, groups, folded, inv_sqrt_b);
    return static_cast<int>(cudaGetLastError());
  });
}
