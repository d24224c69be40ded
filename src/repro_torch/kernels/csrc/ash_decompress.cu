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
// reduce_row in ash_common.cuh), so K3 on unpack_wire(w) equals K5 on w, and
// K4 equals K6, bit for bit.  All four are built for B = 32 .. 512 and for an
// f32 or a bf16 compute dtype (with_shape); they write f32.
//
// Bound on the H100: bytes.  Each output element costs ~1 payload byte per
// peer read and 4 bytes written, against ~11 f32 operations (+2 per extra
// peer), far below the f32 rate per byte moved.  So the design keeps loads in
// flight and spends nothing on synchronisation.  All four take ONE WARP PER
// ROW, 8 rows per 256-thread block, as K1 and K2: no shared memory and no
// __syncthreads, and a warp past the last row returns at once.  Lane l
// reads its E = B/32 codes with the widest load the address allows (one
// 8-byte load at B = 256), its group's scale (E/gs scales when a group is
// smaller than E) and the row's alpha, rotates in registers by rotate_row
// (log2(E) stages in the lane, 5 across lanes by __shfl_xor_sync;
// compress_row's butterfly), and writes its E f32 outputs with 16-byte
// stores: a warp reads and writes its row as one coalesced span.  A wire
// view may start at any byte: the f32 fields are read bytewise where they
// are not 4-byte aligned.
//   * K3 and K5 (decompress_row): q s per element, the rotation, then the
//     division by alpha when the metadata is dual.
//   * K4 and K6 (reduce_row): the P peers summed in a register per element
//     in the rotated domain, so P peers cost one rotation; two peers' loads
//     start before either is added, their codes kept as loaded words
//     until then.  Under folded f32 metadata K4 on one peer equals K3 bit
//     for bit.
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

// K4 and K6 keep at most 64 registers a thread up to E = 8 (B = 256), so
// that 4 blocks (32 warps) share an SM and keep more rows' loads in
// flight: left to itself ptxas gave them 72-116 registers (2-3 blocks an
// SM) and they ran slower at the training shapes; the cap spills 20-64
// bytes (PERF.md, section 6).
constexpr int reduce_min_blocks(int e) { return e <= 8 ? 4 : 1; }

template <int E, bool BF>
__global__ void __launch_bounds__(kRowsPerBlock * 32, reduce_min_blocks(E))
decompress_reduce_kernel(const uint8_t* __restrict__ q,
                         const float* __restrict__ scale,
                         const float* __restrict__ alpha,
                         float* __restrict__ out, int peers, long long rows,
                         int fmt, int groups, float inv_sqrt_b) {
  constexpr int B = 32 * E;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock
                        + (threadIdx.x >> 5);
  if (row >= rows) return;                 // whole warps only
  const size_t r = static_cast<size_t>(row);
  const size_t m = static_cast<size_t>(rows);
  // peer p's row r sits one (rows, .) array further on per peer
  reduce_row<E, BF>(
      peers, q + r * B, m * B,
      reinterpret_cast<const uint8_t*>(scale + r * groups), 4 * m * groups,
      alpha == nullptr ? nullptr
                       : reinterpret_cast<const uint8_t*>(alpha + r),
      4 * m, out + r * B, fmt, groups, inv_sqrt_b);
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

template <int E, bool BF>
__global__ void __launch_bounds__(kRowsPerBlock * 32, reduce_min_blocks(E))
decompress_reduce_wire_kernel(const uint8_t* __restrict__ wire,
                              float* __restrict__ out, int peers, int n,
                              long long total, int fmt, int groups,
                              int folded, float inv_sqrt_b) {
  constexpr int B = 32 * E;
  const int mb = n / B;
  const int blk = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (blk >= mb) return;                   // whole warps only
  const size_t b = static_cast<size_t>(blk);
  const size_t stride = static_cast<size_t>(total);   // one peer's wire row
  // payload [0, n), f32 scales [n, n + 4 mb G), f32 alpha after them (dual)
  const uint8_t* meta = wire + n;
  reduce_row<E, BF>(
      peers, wire + b * B, stride, meta + 4 * b * groups, stride,
      folded ? nullptr : meta + 4 * (static_cast<size_t>(mb) * groups + b),
      stride, out + b * B, fmt, groups, inv_sqrt_b);
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
// alpha: (peers, rows) f32 or null (folded); out: (rows, B) f32.  One warp
// per row, 8 rows per block on grid.x.
extern "C" int taco_decompress_reduce(const void* q, const void* scale,
                                      const void* alpha, void* out, int peers,
                                      long long rows, int block,
                                      int bf16_compute, int fmt, int groups,
                                      float inv_sqrt_b, void* stream) {
  using namespace taco;
  const dim3 grid(static_cast<unsigned>(
      (rows + kRowsPerBlock - 1) / kRowsPerBlock));
  return with_shape(block, bf16_compute, [&](auto shape) {
    using S = decltype(shape);
    decompress_reduce_kernel<S::B / 32, S::BF>
        <<<grid, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
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

// wire: (peers, total) uint8 at any byte address; out: (n / B, B) f32.
// One warp per block row, 8 rows per block on grid.x.
extern "C" int taco_decompress_reduce_wire(const void* wire, void* out,
                                           int peers, int n, long long total,
                                           int block, int bf16_compute,
                                           int fmt, int groups, int folded,
                                           float inv_sqrt_b, void* stream) {
  using namespace taco;
  const int mb = n / block;
  const dim3 grid((mb + kRowsPerBlock - 1) / kRowsPerBlock);
  return with_shape(block, bf16_compute, [&](auto shape) {
    using S = decltype(shape);
    decompress_reduce_wire_kernel<S::B / 32, S::BF>
        <<<grid, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(wire), static_cast<float*>(out),
            peers, n, total, fmt, groups, folded, inv_sqrt_b);
    return static_cast<int>(cudaGetLastError());
  });
}
