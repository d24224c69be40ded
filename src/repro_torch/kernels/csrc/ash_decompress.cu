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
// Each block form and its wire form call one shared body (decompress_elem,
// reduce_elem in ash_common.cuh), so K3 on unpack_wire(w) equals K5 on w, and
// K4 equals K6, bit for bit.  All four are built for B = 32 .. 512 and for an
// f32 or a bf16 compute dtype (with_shape); they write f32.
//
// Bound on the H100: bytes.  Each output element costs ~1 payload byte per
// peer read and 4 bytes written, against ~11 f32 operations (+2 per extra
// peer).  The design reads every input byte once, keeps the block row in
// registers and one 4 B-byte shared buffer for the butterfly, and writes
// each f32 output once, coalesced; the peer loop accumulates in a register so P peers
// cost one rotation.  One B-thread block per row.
#include "ash_common.cuh"

namespace taco {

template <int B, bool BF>
__global__ void __launch_bounds__(B)
decompress_blocks_kernel(const uint8_t* __restrict__ q,
                         const float* __restrict__ scale,
                         const float* __restrict__ alpha,
                         float* __restrict__ out, int fmt, int groups,
                         float inv_sqrt_b) {
  __shared__ float sh[B];
  const int t = threadIdx.x;
  const size_t row = blockIdx.x;
  const float s = scale[row * groups + t / (B / groups)];
  out[row * B + t] = decompress_elem<B, BF>(
      q[row * B + t], s, alpha == nullptr ? nullptr : alpha + row, fmt,
      inv_sqrt_b, sh);
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

template <int B, bool BF>
__global__ void __launch_bounds__(B)
decompress_wire_kernel(const uint8_t* __restrict__ wire,
                       float* __restrict__ out, int n, long long total,
                       int fmt, int groups, int folded, float inv_sqrt_b) {
  __shared__ float sh[B];
  const int t = threadIdx.x;
  const int blk = blockIdx.x;
  const int mb = n / B;
  const uint8_t* wr = wire + static_cast<size_t>(blockIdx.y) * total;
  const float* scale = reinterpret_cast<const float*>(wr + n);
  const float* al =
      folded ? nullptr
             : reinterpret_cast<const float*>(wr + n + 4LL * mb * groups) + blk;
  out[static_cast<size_t>(blockIdx.y) * n + static_cast<size_t>(blk) * B
      + t] = decompress_elem<B, BF>(wr[static_cast<size_t>(blk) * B + t],
                                    scale[blk * groups + t / (B / groups)],
                                    al, fmt, inv_sqrt_b, sh);
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

// Common arguments: block is the block size B (one B-thread block per row),
// bf16_compute selects the bf16 rounding of the plain version, inv_sqrt_b is
// its 1/sqrt(B) in the compute dtype.  Each returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a block size outside 32 .. 512).

// q: (rows, B) payload bytes; scale: (rows, groups) f32; alpha: (rows,) f32
// or null (folded); out: (rows, B) f32.  One block per row on grid.x.
extern "C" int taco_decompress_blocks(const void* q, const void* scale,
                                      const void* alpha, void* out,
                                      long long rows, int block,
                                      int bf16_compute, int fmt, int groups,
                                      float inv_sqrt_b, void* stream) {
  return taco::with_shape(block, bf16_compute, [&](auto shape) {
    using S = decltype(shape);
    taco::decompress_blocks_kernel<S::B, S::BF>
        <<<static_cast<unsigned>(rows), S::B, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
            static_cast<const float*>(alpha), static_cast<float*>(out), fmt,
            groups, inv_sqrt_b);
    return static_cast<int>(cudaGetLastError());
  });
}

// q: (peers, rows, B) payload bytes; scale: (peers, rows, groups) f32;
// alpha: (peers, rows) f32 or null (folded); out: (rows, B) f32.
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

// wire: (slots, total) uint8; out: (slots, n) f32.
extern "C" int taco_decompress_wire(const void* wire, void* out, int slots,
                                    int n, long long total, int block,
                                    int bf16_compute, int fmt, int groups,
                                    int folded, float inv_sqrt_b,
                                    void* stream) {
  return taco::with_shape(block, bf16_compute, [&](auto shape) {
    using S = decltype(shape);
    taco::decompress_wire_kernel<S::B, S::BF>
        <<<dim3(n / S::B, slots), S::B, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(wire), static_cast<float*>(out), n,
            total, fmt, groups, folded, inv_sqrt_b);
    return static_cast<int>(cudaGetLastError());
  });
}

// wire: (peers, total) uint8; out: (n / B, B) f32.
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
