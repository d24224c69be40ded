// ASH compress with a butterfly rotation (K7):
//
//   compress_blocks_butterfly_kernel: (M, B) block rows -> q (M, B) payload
//   codes, alpha (M,) f32 and s (M, 1) f32, for B in {32, 64, 128, 256,
//   512} and bf16 or f32 input.
//   Replaces the TPU kernel src/repro/kernels/fwht_butterfly.py
//   compress_blocks_butterfly (pallas_call at line 65, body _compress_kernel
//   at line 38): per row, sigma = sqrt(mean g^2 + eps), alpha = tau/sigma,
//   z = fwht(alpha g) * (1/sqrt(B)), ONE block-level scale
//   s = max(max|z| / qmax, 1e-30) (the reference's fixed floor, not
//   cfg.scale_eps), and the payload clip(z/s, +-qmax) cast to fp8 or
//   rounded half to even to int8.
//
// Bound on the H100: bytes and the issue rate alike.  Per element it reads
// 2 (bf16) or 4 (f32) bytes and writes 1, and it issues some 30-40
// instructions (the unpack, the squares and their pairwise sum, the
// scale by alpha, log2(B) butterfly adds or shuffles, the scale by
// 1/sqrt(B), the max, the IEEE division z/s, the cast): at four warp
// instructions a clock on each of 132 SMs that takes about as long as
// the bytes at B = 32 and longer above it (scripts/k7_sweep.py counts the
// loop's SASS).  The first design (one warp per row, B/32 elements a
// lane) lost on both: each warp-wide shuffle served one row (5 per element
// for the rotation plus 10 a row for the two reductions), a lane loaded
// as little as 2 bytes and then exited, and each element took its own
// fp8 convert.
//
// Design: SEVERAL ROWS A WARP, E ELEMENTS A LANE.  A lane holds E (a
// template parameter, chosen per B by the wrapper's launch geometry)
// consecutive elements of a row, read as whole 16-byte words; L = B/E lanes
// hold a row and a warp takes R = 32/L rows, so a warp reads one contiguous
// span of 32 E elements.  The first log2(E) butterfly stages pair elements
// inside a lane's registers, the last log2(L) pair lanes by
// __shfl_xor_sync with masks < L (inside the row's segment of L lanes);
// both reductions shuffle inside the segment too, so one warp-wide shuffle
// serves R rows.  The stage order (h = 1, 2, 4, ...) and the (a+b, a-b)
// pairing are repro_torch.core.ash.fwht's, so the rotation is bit for bit
// the reference's for any E; a cross-lane stage is one fma with +-1
// (fma(1, v, o) = v + o and fma(-1, v, o) = o - v, each rounded once).
// Every other product and sum is rounded on its own (no contraction), the
// sum of squares is ref.pairwise_sum's tree and both divisions are IEEE
// divisions, so the kernel gives the plain version's bits.  Codes are
// converted two at a time (cvt ... e4m3x2 / e5m2x2, the same bits as two
// single converts) and the format is a template parameter.  The grid is
// persistent (a few blocks on each SM, from the wrapper): a block walks
// over block steps with a stride of the grid, its warp w taking row group
// t W + w in step t, and loads the next step's words before it computes
// the current one, so a lane keeps a load in flight while it computes.
// The loop's bounds are the same on every thread of a block, so the
// compiler sees the shuffles in converged code (a loop over a per-warp
// index made it wrap each shuffle in WARPSYNC / ENDCOLLECTIVE code).  A
// ragged group loads zeros for its missing rows, computes them (every
// lane reaches every full-mask shuffle) and skips their stores.  No
// shared memory, no barriers.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace taco {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
// payload formats (FMT_CODE in the Python wrappers): 0 e4m3, 1 e5m2, 2 int8
constexpr int kE4M3 = 0;
constexpr int kE5M2 = 1;
constexpr int kInt8 = 2;
// elements a lane built for each B = 32, 64, 128, 256, 512 (the wrapper's
// fwht_butterfly.KEPT_E); a build with -DTACO_K7_SWEEP takes every E of
// 8, 16 and 32 that gives 1 .. 32 lanes a row
constexpr int kKeptE[5] = {32, 32, 32, 32, 32};

constexpr int kept_e(int b) {
  return b == 32 ? kKeptE[0] : b == 64 ? kKeptE[1] : b == 128 ? kKeptE[2]
       : b == 256 ? kKeptE[3] : kKeptE[4];
}

constexpr bool built_for(int b, int e) {
#ifdef TACO_K7_SWEEP
  return (e == 8 || e == 16 || e == 32) && b / e >= 1 && b / e <= 32;
#else
  return e == kept_e(b);
#endif
}

// The E inputs of one lane as 16-byte words.
template <typename Tin, int E>
struct Words {
  static constexpr int kN = E * static_cast<int>(sizeof(Tin)) / 16;
  uint4 w[kN];
};

template <typename Tin, int E>
__device__ __forceinline__ void load_words(const Tin* p, Words<Tin, E>& r) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < Words<Tin, E>::kN; ++k) r.w[k] = __ldg(s + k);
}

template <typename Tin, int E>
__device__ __forceinline__ void zero_words(Words<Tin, E>& r) {
#pragma unroll
  for (int k = 0; k < Words<Tin, E>::kN; ++k) r.w[k] = make_uint4(0, 0, 0, 0);
}

template <int E>
__device__ __forceinline__ void unpack(const Words<float, E>& r,
                                       float (&v)[E]) {
#pragma unroll
  for (int k = 0; k < E / 4; ++k) {
    v[4 * k] = __uint_as_float(r.w[k].x);
    v[4 * k + 1] = __uint_as_float(r.w[k].y);
    v[4 * k + 2] = __uint_as_float(r.w[k].z);
    v[4 * k + 3] = __uint_as_float(r.w[k].w);
  }
}

template <int E>
__device__ __forceinline__ void unpack(const Words<__nv_bfloat16, E>& r,
                                       float (&v)[E]) {
  // each 32-bit word holds two bf16 values, the lower address in the low
  // half; a bf16 is the top half of its f32 (exact widening)
#pragma unroll
  for (int k = 0; k < E / 8; ++k) {
    const uint32_t w[4] = {r.w[k].x, r.w[k].y, r.w[k].z, r.w[k].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[8 * k + 2 * i] = __uint_as_float(w[i] << 16);
      v[8 * k + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// The larger and the smaller of a and b, NaN where either is NaN (PTX
// max.NaN / min.NaN: one FMNMX.NAN), as the plain version's torch.amax,
// clamp_min and clamp; ash_common.cuh has the same two.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Two codes, the first in the low byte.
template <int FMT>
__device__ __forceinline__ uint32_t cast2(float a, float b) {
  if constexpr (FMT == kInt8) {
    return (static_cast<uint32_t>(__float2int_rn(a)) & 0xffu) |
           ((static_cast<uint32_t>(__float2int_rn(b)) & 0xffu) << 8);
  } else {
    return static_cast<uint32_t>(__nv_cvt_float2_to_fp8x2(
        make_float2(a, b), __NV_SATFINITE,
        FMT == kE4M3 ? __NV_E4M3 : __NV_E5M2));
  }
}

// One row segment: L lanes of one warp hold the row's B = L E elements in
// v (lane sl of the segment: elements [sl E, sl E + E)).  Leaves the codes
// as E/4 packed words and returns alpha and s.  Every product and sum is
// rounded on its own (__fmul_rn / __fadd_rn: no contraction into an fma),
// in the plain version's order, so the row's bits are its bits.
template <int B, int E, int FMT>
__device__ __forceinline__ void compress_segment(float (&v)[E], int lane,
                                                 float tau, float eps,
                                                 float qmax, float inv_sqrt_b,
                                                 uint32_t (&c)[E / 4],
                                                 float& alpha, float& s) {
  constexpr int L = B / E;
  // reduction 1: block RMS energy -> adaptive rescale (alpha before the
  // rotation, as the reference).  The sum of squares is the pairwise tree
  // of ref.compress_blocks_butterfly_ref: adjacent pairs inside the lane,
  // then lanes l and l ^ o for o = 1, 2, .. (both lanes of a pair get the
  // same bits: the sum commutes)
  float sq[E];
#pragma unroll
  for (int j = 0; j < E; ++j) sq[j] = __fmul_rn(v[j], v[j]);
#pragma unroll
  for (int h = 1; h < E; h <<= 1) {
#pragma unroll
    for (int j = 0; j < E; j += 2 * h) sq[j] = __fadd_rn(sq[j], sq[j + h]);
  }
  float ss = sq[0];
#pragma unroll
  for (int o = 1; o < L; o <<= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, o));
  // mean = ss / B (exact: B is a power of two), then + eps, sqrt and
  // tau / sigma each rounded once, as the plain version
  const float sigma = sqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / B), eps));
  const float a = tau / sigma;
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = __fmul_rn(a, v[j]);

  // rotation: log2(E) stages inside the lane, then log2(L) across lanes
#pragma unroll
  for (int h = 1; h < E; h <<= 1) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if ((j & h) == 0) {
        const float p = v[j], r = v[j + h];
        v[j] = __fadd_rn(p, r);
        v[j + h] = __fsub_rn(p, r);
      }
    }
  }
#pragma unroll
  for (int m = 1; m < L; m <<= 1) {
    const float sg = (lane & m) ? -1.f : 1.f;
#pragma unroll
    for (int j = 0; j < E; ++j)
      v[j] = fmaf(sg, v[j], __shfl_xor_sync(kFull, v[j], m));
  }

  // reduction 2: the block's max magnitude -> one scale; the maxima and
  // the floor keep NaN, as the plain version's (a row holding a NaN or an
  // inf rotates to NaN everywhere: s NaN, fp8 codes NaN, int8 codes 0)
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    v[j] = __fmul_rn(v[j], inv_sqrt_b);
    mx = fmax_nan(mx, fabsf(v[j]));
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    mx = fmax_nan(mx, __shfl_xor_sync(kFull, mx, o));
  s = fmax_nan(mx / qmax, 1e-30f);
  alpha = a;

  // z / s is an IEEE division, as the reference's.  The fp8 casts saturate
  // to the format's largest finite value, which is its qmax, so clipping
  // first gives the same codes for finite z; int8 is clipped, NaN kept
  // (__float2int_rn then gives 0)
#pragma unroll
  for (int k = 0; k < E / 4; ++k) {
    float t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t[i] = v[4 * k + i] / s;
      if constexpr (FMT == kInt8)
        t[i] = fmin_nan(fmax_nan(t[i], -qmax), qmax);
    }
    c[k] = cast2<FMT>(t[0], t[1]) | (cast2<FMT>(t[2], t[3]) << 16);
  }
}

template <int E>
__device__ __forceinline__ void store_codes(uint8_t* p,
                                            const uint32_t (&c)[E / 4]) {
  if constexpr (E == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(c[0], c[1]);
  } else {
#pragma unroll
    for (int k = 0; k < E / 16; ++k)
      reinterpret_cast<uint4*>(p)[k] =
          make_uint4(c[4 * k], c[4 * k + 1], c[4 * k + 2], c[4 * k + 3]);
  }
}

template <typename Tin, int B, int E, int FMT>
__global__ void __launch_bounds__(kMaxThreads)
compress_blocks_butterfly_kernel(const Tin* __restrict__ x,
                                 uint8_t* __restrict__ q,
                                 float* __restrict__ alpha,
                                 float* __restrict__ scale, long long rows,
                                 float tau, float eps, float qmax,
                                 float inv_sqrt_b) {
  constexpr int L = B / E;  // lanes a row
  constexpr int R = 32 / L;  // rows a warp (a row group)
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  // block steps: in step t the block's warp w takes row group t W + w.
  // The loop runs over the block's steps t = blockIdx.x, + gridDim.x, ..:
  // its bounds are the same on every thread of the block, so the compiler
  // sees every shuffle in converged code.  A ragged group (or a warp past
  // the last group) loads zeros for its missing rows, computes them and
  // skips their stores.
  const long long per_step = static_cast<long long>(warps) * R;
  const long long steps = (rows + per_step - 1) / per_step;
  long long t = blockIdx.x;
  if (t >= steps) return;
  Words<Tin, E> cur, nxt;
  // group g's lane span starts at element g 32 E + lane E
  long long g = t * warps + warp;
  long long row = g * R + lane / L;
  if (row < rows)
    load_words<Tin, E>(x + (static_cast<size_t>(g) * 32 + lane) * E, cur);
  else
    zero_words<Tin, E>(cur);
  for (;;) {
    const long long tn = t + gridDim.x;
    const long long gn = tn * warps + warp;
    const long long row_n = gn * R + lane / L;
    if (tn < steps) {  // the next step's words, in flight while this one
      if (row_n < rows)  // computes
        load_words<Tin, E>(x + (static_cast<size_t>(gn) * 32 + lane) * E,
                           nxt);
      else
        zero_words<Tin, E>(nxt);
    }
    float v[E];
    unpack<E>(cur, v);
    uint32_t c[E / 4];
    float a, s;
    compress_segment<B, E, FMT>(v, lane, tau, eps, qmax, inv_sqrt_b, c, a,
                                s);
    if (row < rows) {
      store_codes<E>(q + (static_cast<size_t>(g) * 32 + lane) * E, c);
      if ((lane & (L - 1)) == 0) {
        alpha[row] = a;
        scale[row] = s;
      }
    }
    if (tn >= steps) break;
    t = tn;
    g = gn;
    row = row_n;
    cur = nxt;
  }
}

struct Args {
  const void* x;
  uint8_t* q;
  float* alpha;
  float* scale;
  long long rows;
  int fmt;
  float tau, eps, qmax, inv_sqrt_b;
  dim3 grid, block;
  cudaStream_t st;
};

template <typename Tin, int B, int E>
int launch_e(const Args& a) {
  if constexpr (!built_for(B, E)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const Tin* x = static_cast<const Tin*>(a.x);
    switch (a.fmt) {
      case kE4M3:
        compress_blocks_butterfly_kernel<Tin, B, E, kE4M3>
            <<<a.grid, a.block, 0, a.st>>>(x, a.q, a.alpha, a.scale, a.rows,
                                           a.tau, a.eps, a.qmax,
                                           a.inv_sqrt_b);
        break;
      case kE5M2:
        compress_blocks_butterfly_kernel<Tin, B, E, kE5M2>
            <<<a.grid, a.block, 0, a.st>>>(x, a.q, a.alpha, a.scale, a.rows,
                                           a.tau, a.eps, a.qmax,
                                           a.inv_sqrt_b);
        break;
      case kInt8:
        compress_blocks_butterfly_kernel<Tin, B, E, kInt8>
            <<<a.grid, a.block, 0, a.st>>>(x, a.q, a.alpha, a.scale, a.rows,
                                           a.tau, a.eps, a.qmax,
                                           a.inv_sqrt_b);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename Tin, int B>
int launch_b(const Args& a, int e) {
  switch (e) {
    case 8: return launch_e<Tin, B, 8>(a);
    case 16: return launch_e<Tin, B, 16>(a);
    case 32: return launch_e<Tin, B, 32>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Tin>
int launch(const Args& a, int b, int e) {
  switch (b) {
    case 32: return launch_b<Tin, 32>(a, e);
    case 64: return launch_b<Tin, 64>(a, e);
    case 128: return launch_b<Tin, 128>(a, e);
    case 256: return launch_b<Tin, 256>(a, e);
    case 512: return launch_b<Tin, 512>(a, e);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace taco

// x: (rows, b) bf16 (in_bf16 != 0) or f32, contiguous, 16-byte aligned;
// q: (rows, b) payload bytes; alpha, scale: (rows,) f32.  b is 32, 64,
// 128, 256 or 512; e the elements a lane (the wrapper's launch geometry);
// grid blocks of threads threads (a multiple of 32, at most 256).
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// a (b, e), a format or a block the library was not built for.
extern "C" int taco_compress_blocks_butterfly(
    const void* x, void* q, void* alpha, void* scale, int in_bf16, int b,
    int e, long long rows, int fmt, float tau, float eps, float qmax,
    float inv_sqrt_b, int grid, int threads, void* stream) {
  if (grid < 1 || threads < 32 || threads > taco::kMaxThreads ||
      threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const taco::Args a{x, static_cast<uint8_t*>(q),
                     static_cast<float*>(alpha), static_cast<float*>(scale),
                     rows, fmt, tau, eps, qmax, inv_sqrt_b,
                     dim3(static_cast<unsigned>(grid)),
                     dim3(static_cast<unsigned>(threads)),
                     static_cast<cudaStream_t>(stream)};
  return in_bf16 ? taco::launch<__nv_bfloat16>(a, b, e)
                 : taco::launch<float>(a, b, e);
}
