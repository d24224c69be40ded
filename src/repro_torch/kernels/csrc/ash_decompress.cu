// Fused ASH decompress read straight out of packed TACO wire rows (paper
// §4.1 "fused_ash_decompress").
//
// Replaces two TPU kernels of src/repro/kernels/ash_decompress.py:
//   * decompress_wire_pallas (pallas_call at line 193, body
//     _decompress_wire_kernel at line 151): the all-gather receiver,
//     g = (q s) H / 16, then g / alpha when the metadata is dual;
//   * decompress_reduce_wire_pallas (pallas_call at line 255, body
//     _decompress_reduce_wire_kernel at line 206): the reduce-scatter
//     receiver, sum_p q_p (s_p / alpha_p) over the P peer rows in peer-index
//     order in the rotated domain, then ONE rotation (H is linear).
// Both read the wire fields at the static wire_layout(n) offsets that
// ash_compress.cu writes (the JAX package's _wire_fields bitcasts).
//
// Bound on the H100: bytes.  Each output element costs ~1 wire byte per peer
// read and 4 bytes written, against ~11 f32 operations (+2 per extra peer).
// The design reads every wire byte once, keeps the block row in registers
// and one 1 KB shared buffer for the butterfly, and writes each f32 output
// once, coalesced; the peer loop accumulates in a register so P peers cost
// one rotation.  One 256-thread block per row, as the compress kernel.
#include "ash_common.cuh"

namespace taco {

__global__ void __launch_bounds__(kBlock)
decompress_wire_kernel(const uint8_t* __restrict__ wire,
                       float* __restrict__ out, int n, long long total,
                       int fmt, int groups, int folded) {
  __shared__ float sh[kBlock];
  const int t = threadIdx.x;
  const int blk = blockIdx.x;
  const int mb = n / kBlock;
  const uint8_t* wr = wire + static_cast<size_t>(blockIdx.y) * total;
  const float* scale = reinterpret_cast<const float*>(wr + n);
  const float q = decode_code(wr[static_cast<size_t>(blk) * kBlock + t], fmt);
  const float s = scale[blk * groups + t / (kBlock / groups)];
  float g = wht256(q * s, sh) * 0.0625f;
  if (!folded) {
    const float* al = reinterpret_cast<const float*>(wr + n + 4LL * mb * groups);
    g = g / al[blk];
  }
  out[static_cast<size_t>(blockIdx.y) * n + static_cast<size_t>(blk) * kBlock
      + t] = g;
}

__global__ void __launch_bounds__(kBlock)
decompress_reduce_wire_kernel(const uint8_t* __restrict__ wire,
                              float* __restrict__ out, int peers, int n,
                              long long total, int fmt, int groups,
                              int folded) {
  __shared__ float sh[kBlock];
  const int t = threadIdx.x;
  const int blk = blockIdx.x;
  const int mb = n / kBlock;
  const int sidx = blk * groups + t / (kBlock / groups);
  float acc = 0.f;
  for (int p = 0; p < peers; ++p) {
    const uint8_t* wr = wire + static_cast<size_t>(p) * total;
    const float* scale = reinterpret_cast<const float*>(wr + n);
    float f = scale[sidx];
    if (!folded) {
      f = f / reinterpret_cast<const float*>(wr + n + 4LL * mb * groups)[blk];
    }
    acc += decode_code(wr[static_cast<size_t>(blk) * kBlock + t], fmt) * f;
  }
  out[static_cast<size_t>(blk) * kBlock + t] = wht256(acc, sh) * 0.0625f;
}

}  // namespace taco

// wire: (slots, total) uint8; out: (slots, n) f32.
extern "C" int taco_decompress_wire(const void* wire, void* out, int slots,
                                    int n, long long total, int fmt,
                                    int groups, int folded, void* stream) {
  const dim3 grid(n / taco::kBlock, slots);
  taco::decompress_wire_kernel<<<grid, taco::kBlock, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wire), static_cast<float*>(out), n, total,
      fmt, groups, folded);
  return static_cast<int>(cudaGetLastError());
}

// wire: (peers, total) uint8; out: (n / 256, 256) f32.
extern "C" int taco_decompress_reduce_wire(const void* wire, void* out,
                                           int peers, int n, long long total,
                                           int fmt, int groups, int folded,
                                           void* stream) {
  taco::decompress_reduce_wire_kernel<<<n / taco::kBlock, taco::kBlock, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wire), static_cast<float*>(out), peers, n,
      total, fmt, groups, folded);
  return static_cast<int>(cudaGetLastError());
}
