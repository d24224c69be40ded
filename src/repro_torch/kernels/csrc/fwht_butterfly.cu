// ASH compress with a warp-level butterfly rotation (K7):
//
//   compress_blocks_butterfly_kernel: (M, B) block rows -> q (M, B) payload
//   codes, alpha (M,) f32 and s (M, 1) f32, for B in {32, 64, 128, 256,
//   512}.
//   Replaces the TPU kernel src/repro/kernels/fwht_butterfly.py
//   compress_blocks_butterfly (pallas_call at line 65, body _compress_kernel
//   at line 38): per row, sigma = sqrt(mean g^2 + eps), alpha = tau/sigma,
//   z = fwht(alpha g) * (1/sqrt(B)), ONE block-level scale
//   s = max(max|z| / qmax, 1e-30) (the reference's fixed floor, not
//   cfg.scale_eps), and the payload clip(z/s, +-qmax) cast to fp8 or
//   rounded half to even to int8.
//
// Bound on the H100: bytes.  Per element it reads 2 (bf16) or 4 (f32) bytes
// and writes 1; its 2 log2(B) butterfly adds and ~10 other f32 operations
// per element are far below the f32 rate per byte moved.
//
// Design, the counterpoint to K1 (one 256-thread block per row, an 8-stage
// shared-memory butterfly and nine pairs of __syncthreads): ONE WARP PER
// ROW.  Lane l holds the E = B/32 consecutive elements [l E, l E + E) in
// registers, read with 16-byte vector loads where E allows (8-byte loads of
// bf16 at E = 4; scalar ones at E = 1 and 2), so a warp reads its row as
// one contiguous, coalesced span.  The first log2(E) butterfly stages pair
// elements inside a lane's registers (none at B = 32, where E = 1); the
// last 5 pair lanes by __shfl_xor_sync.  The stage order and the (a+b, a-b) pairing are those of
// repro_torch.core.ash.fwht, so the rotation is bit for bit the reference's.
// Both reductions (sum of squares, max magnitude) are per-lane loops and
// then warp shuffles.  No shared memory, no barriers; a block of 8 warps
// takes 8 rows.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace taco {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
// payload formats (FMT_CODE in the Python wrappers): 0 e4m3, 1 e5m2, 2 int8
constexpr int kE4M3 = 0;
constexpr int kInt8 = 2;

// E consecutive inputs of one lane, as f32.  Vector loads of 16 bytes where
// the lane's span is a multiple of 16 bytes, of 8 where it is 8 bytes (rows
// are 16-byte aligned: the wrapper checks the base pointer, and B *
// sizeof(T) is a multiple of 64).
template <int E>
__device__ __forceinline__ void load_lane(const float* p, float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int j = 0; j < E; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      v[j] = f.x; v[j + 1] = f.y; v[j + 2] = f.z; v[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = p[j];
  }
}

template <int E>
__device__ __forceinline__ void load_lane(const __nv_bfloat16* p,
                                          float (&v)[E]) {
  if constexpr (E == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (E % 8 == 0) {
#pragma unroll
    for (int j = 0; j < E; j += 8) {
      // each 32-bit word holds two bf16 values, the lower address in the
      // low half; a bf16 is the top half of its f32 (exact widening)
      const uint4 u = *reinterpret_cast<const uint4*>(p + j);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[j + 2 * k] = __uint_as_float(w[k] << 16);
        v[j + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = __bfloat162float(p[j]);
  }
}

// E payload bytes of one lane: packed into 32-bit words and written with
// one 4-, 8- or 16-byte store where E is 4, 8 or 16.
template <int E>
__device__ __forceinline__ void store_lane(uint8_t* p, const uint8_t (&c)[E]) {
  if constexpr (E == 4) {
    *reinterpret_cast<uint32_t*>(p) =
        static_cast<uint32_t>(c[0]) | (static_cast<uint32_t>(c[1]) << 8) |
        (static_cast<uint32_t>(c[2]) << 16) |
        (static_cast<uint32_t>(c[3]) << 24);
  } else if constexpr (E % 8 == 0) {
    uint32_t w[E / 4];
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      w[k] = static_cast<uint32_t>(c[4 * k]) |
             (static_cast<uint32_t>(c[4 * k + 1]) << 8) |
             (static_cast<uint32_t>(c[4 * k + 2]) << 16) |
             (static_cast<uint32_t>(c[4 * k + 3]) << 24);
    }
    if constexpr (E == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) p[j] = c[j];
  }
}

template <typename Tin, int E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
compress_blocks_butterfly_kernel(const Tin* __restrict__ x,
                                 uint8_t* __restrict__ q,
                                 float* __restrict__ alpha,
                                 float* __restrict__ scale, long long rows,
                                 int fmt, float tau, float eps, float qmax,
                                 float inv_sqrt_b) {
  constexpr int B = 32 * E;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;                 // whole warps only
  const size_t base = static_cast<size_t>(row) * B + lane * E;

  float v[E];
  load_lane<E>(x + base, v);

  // reduction 1: block RMS energy -> adaptive rescale (alpha before the
  // rotation, as the reference)
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < E; ++j) ss += v[j] * v[j];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
  const float sigma = sqrtf(ss / B + eps);
  const float a = tau / sigma;
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = a * v[j];

  // rotation: log2(E) stages inside the lane, then 5 across lanes
#pragma unroll
  for (int h = 1; h < E; h <<= 1) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if ((j & h) == 0) {
        const float p = v[j], r = v[j + h];
        v[j] = p + r;
        v[j + h] = p - r;
      }
    }
  }
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float o = __shfl_xor_sync(kFull, v[j], m);
      v[j] = (lane & m) ? (o - v[j]) : (v[j] + o);
    }
  }

  // reduction 2: the block's max magnitude -> one scale
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    v[j] = v[j] * inv_sqrt_b;
    mx = fmaxf(mx, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  const float s = fmaxf(mx / qmax, 1e-30f);

  uint8_t c[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const float t = fminf(fmaxf(v[j] / s, -qmax), qmax);
    if (fmt == kInt8) {
      c[j] = static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(t)));
    } else {
      c[j] = static_cast<uint8_t>(__nv_cvt_float_to_fp8(
          t, __NV_SATFINITE, fmt == kE4M3 ? __NV_E4M3 : __NV_E5M2));
    }
  }
  store_lane<E>(q + base, c);
  if (lane == 0) {
    alpha[row] = a;
    scale[row] = s;
  }
}

template <typename Tin>
int launch_butterfly(const Tin* x, uint8_t* q, float* alpha, float* scale,
                     int b, long long rows, int fmt, float tau, float eps,
                     float qmax, float inv_sqrt_b, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(
      (rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  switch (b) {
    case 32:
      compress_blocks_butterfly_kernel<Tin, 1><<<grid, block, 0, st>>>(
          x, q, alpha, scale, rows, fmt, tau, eps, qmax, inv_sqrt_b);
      break;
    case 64:
      compress_blocks_butterfly_kernel<Tin, 2><<<grid, block, 0, st>>>(
          x, q, alpha, scale, rows, fmt, tau, eps, qmax, inv_sqrt_b);
      break;
    case 128:
      compress_blocks_butterfly_kernel<Tin, 4><<<grid, block, 0, st>>>(
          x, q, alpha, scale, rows, fmt, tau, eps, qmax, inv_sqrt_b);
      break;
    case 256:
      compress_blocks_butterfly_kernel<Tin, 8><<<grid, block, 0, st>>>(
          x, q, alpha, scale, rows, fmt, tau, eps, qmax, inv_sqrt_b);
      break;
    case 512:
      compress_blocks_butterfly_kernel<Tin, 16><<<grid, block, 0, st>>>(
          x, q, alpha, scale, rows, fmt, tau, eps, qmax, inv_sqrt_b);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace taco

// x: (rows, b) bf16 (in_bf16 != 0) or f32, contiguous, 16-byte aligned;
// q: (rows, b) payload bytes; alpha, scale: (rows,) f32.  b is 32, 64,
// 128, 256 or 512.  Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for another b).
extern "C" int taco_compress_blocks_butterfly(const void* x, void* q,
                                              void* alpha, void* scale,
                                              int in_bf16, int b,
                                              long long rows, int fmt,
                                              float tau, float eps, float qmax,
                                              float inv_sqrt_b, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* qb = static_cast<uint8_t*>(q);
  float* a = static_cast<float*>(alpha);
  float* s = static_cast<float*>(scale);
  if (in_bf16) {
    return taco::launch_butterfly(static_cast<const __nv_bfloat16*>(x), qb, a,
                                  s, b, rows, fmt, tau, eps, qmax, inv_sqrt_b,
                                  st);
  }
  return taco::launch_butterfly(static_cast<const float*>(x), qb, a, s, b,
                                rows, fmt, tau, eps, qmax, inv_sqrt_b, st);
}
