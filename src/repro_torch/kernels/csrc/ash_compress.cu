// Fused ASH compress straight into the packed TACO wire row (paper §4.4.1).
//
// Replaces the TPU kernel src/repro/kernels/ash_compress.py
// compress_wire_pallas (pallas_call at line 218, body _compress_wire_kernel
// at line 171, row math _block_compress at line 34).
//
// Per 256-element block row: sigma = sqrt(mean g^2 + eps), alpha = tau/sigma,
// z = (alpha g) H / 16, s = max|z|/qmax per quantization group floored at
// scale_eps, q = saturating cast of clip(z/s, +-qmax).  The row is written at
// the static wire_layout(n) offsets of one uint8 row per slot: payload bytes
// [0, n), f32 scales (s, or s/alpha when folded) at [n, n + 4 mb G), f32
// alpha at [n + 4 mb G, total) when dual.
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

  // reduction 1: block RMS energy -> adaptive rescale
  const float g = to_f32(xr[t]);
  const float sigma = sqrtf(block_sum(g * g, red) / kBlock + eps);
  const float alpha = tau / sigma;
  // rotation: H/sqrt(B) with B = 256 is the butterfly scaled by 1/16 (exact)
  const float z = wht256(alpha * g, sh) * 0.0625f;
  // reduction 2: per-group max magnitude -> dual scale
  const int gs = kBlock / groups;
  const float s = fmaxf(group_max(fabsf(z), gs, red) / qmax, scale_eps);
  const float v = fminf(fmaxf(z / s, -qmax), qmax);
  uint8_t code;
  if (fmt == kInt8) {
    code = static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(v)));
  } else {
    code = static_cast<uint8_t>(__nv_cvt_float_to_fp8(
        v, __NV_SATFINITE, fmt == kE4M3 ? __NV_E4M3 : __NV_E5M2));
  }
  wr[static_cast<size_t>(blk) * kBlock + t] = code;
  if (t % gs == 0) {
    float* scale = reinterpret_cast<float*>(wr + n);
    scale[blk * groups + t / gs] = folded ? s / alpha : s;
  }
  if (!folded && t == 0) {
    float* al = reinterpret_cast<float*>(wr + n + 4LL * mb * groups);
    al[blk] = alpha;
  }
}

}  // namespace taco

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
