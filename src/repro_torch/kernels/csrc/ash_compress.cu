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
// Both run compress_rows over the rows with the row body compress_segment
// (ash_common.cuh) and differ only in where a row's outputs go, so
// pack_wire of K1's output is K2's output byte for byte.  At an f32 compute
// dtype the body rounds each step once in the order of
// repro_torch.kernels.ref.compress_blocks_ref (its rotation in f64), so
// both give its bits.  Both are built for B = 32 .. 512 and for an f32 or a
// bf16 compute dtype (with_shape), each B at the elements a lane of kKeptE.
//
// Bound on the H100: bytes (2 or 4 read and 1 written an element, plus 4 G
// + 4 bytes of metadata a row), and nearly as much the issue rate and three
// narrow pipes: at an f32 compute dtype the rotation is log2(B) f64 adds an
// element (the FP64 pipe, half the f32 rate), two f64 conversions (16 a
// clock on a multiprocessor), and on each cross-lane stage two 32-bit
// shuffles a value (32 a clock); then z/s and the cast.  The previous
// design (one warp per row, B/32 elements a lane) spent 10 shuffles an
// element on the f64 rotation at B = 256 and 10 a row on the reductions,
// an IEEE division an element (a reciprocal on the conversion pipe, five
// fmas, a range check and a branch), and loaded as little as 16 bytes a
// lane before it exited.
//
// Design: K7's (fwht_butterfly.cu) with K1's arithmetic.  SEVERAL ROWS A
// WARP, E ELEMENTS A LANE: a lane holds E consecutive elements of a row (E
// = 8, 16 or 32, a template parameter chosen per B and row count by the
// wrapper's launch geometry: kKeptE for many rows, kLatencyE, the fewest,
// where the rows would not fill the card and a warp's serial work sets the
// time), read as whole 16-byte words where the address allows; L = B/E
// lanes hold a row and a warp takes R = 32/L rows, so a warp reads one
// contiguous span of 32 E elements.  The first log2(E) butterfly stages
// pair registers of a lane, the last log2(L) pair lanes by shuffles with
// masks below L, and both reductions shuffle inside the segment too, so
// one warp-wide shuffle serves R rows (none at L = 1).  With one scale a
// lane (groups of E or more elements) z/s is no division: the reciprocal
// of s once, then three fma-pipe operations an element that round as the
// IEEE division (compress_segment, divide_by).  Codes are cast two at a
// time and written with the widest store the address allows (a wire row
// may start at 4 mod 8).  The grid is persistent (a few blocks a
// multiprocessor, from the wrapper; small blocks, so that the last blocks'
// steps spread evenly): a block walks over block steps with a stride of the
// grid, its warp w taking row group t W + w in step t, and loads the next
// step's words before it computes the current one.  The loop's bounds are
// the same on every thread of a block, so the compiler sees every shuffle
// in converged code.  A ragged group computes zeros for its missing rows up
// to their last shuffle and writes nothing for them.
#include <cmath>
#include <type_traits>

#include "ash_common.cuh"

namespace taco {

constexpr int kMaxThreads = 256;
// elements a lane built for each B = 32, 64, 128, 256, 512 (the wrapper's
// ash_compress.KEPT_E and LATENCY_E): kKeptE for many rows of bf16 input
// at an f32 compute dtype (every training hop), kLatencyE for few rows (a
// warp's serial work grows with E) and for every other input and compute
// dtype (their kernels at kKeptE would double the library's build time);
// a build with -DTACO_K1_SWEEP also takes, at an f32 compute dtype, every E
// of 8, 16 and 32 that gives 1 .. 32 lanes a row
constexpr int kKeptE[5] = {16, 32, 32, 32, 32};
constexpr int kLatencyE[5] = {8, 8, 8, 8, 16};

constexpr int b_index(int b) {
  return b == 32 ? 0 : b == 64 ? 1 : b == 128 ? 2 : b == 256 ? 3 : 4;
}

template <typename Tin>
constexpr bool built_for(int b, int e, bool bf) {
#ifdef TACO_K1_SWEEP
  if (!bf && (e == 8 || e == 16 || e == 32) && b / e >= 1 && b / e <= 32)
    return true;
#endif
  return e == kLatencyE[b_index(b)] ||
         (e == kKeptE[b_index(b)] && !bf &&
          std::is_same_v<Tin, __nv_bfloat16>);
}

// K1's outputs: row r's payload, scales and alpha in three arrays.
struct BlockForm {
  uint8_t* q;
  float* scale;
  float* alpha;
  int groups;
  template <int B>
  __device__ __forceinline__ RowOut row(long long r) const {
    const size_t i = static_cast<size_t>(r);
    return {q + i * B, scale + i * groups, alpha + i};
  }
};

// K2's outputs: row r is block r % mb of slot r / mb, written at the wire
// row's static offsets.
struct WireForm {
  uint8_t* wire;
  long long total;
  int n, mb, groups;
  bool folded;
  template <int B>
  __device__ __forceinline__ RowOut row(long long r) const {
    // rows < 2^31 (the launcher's check): a 32-bit division
    const unsigned slot = static_cast<unsigned>(r) / static_cast<unsigned>(mb);
    const size_t blk = static_cast<size_t>(r - static_cast<long long>(slot)
                                               * mb);
    uint8_t* wr = wire + static_cast<size_t>(slot) * total;
    float* sc = reinterpret_cast<float*>(wr + n);
    float* al = folded ? nullptr
                       : reinterpret_cast<float*>(
                             wr + n + 4 * static_cast<size_t>(mb) * groups);
    return {wr + blk * B, sc + blk * groups, al == nullptr ? nullptr : al + blk};
  }
};

// The rows [0, rows) of x (contiguous, B elements a row) through
// compress_segment, outputs where ``form`` puts them.  Block steps: in step
// t < steps (= rows / (W R), rounded up, from the launcher) the block's
// warp w takes row group g = t W + w, rows [g R, g R + R), lane l row
// g R + l / L, elements [(l % L) E, (l % L) E + E) of it.
template <typename Tin, int B, int E, bool BF, typename Form>
__device__ __forceinline__ void compress_rows(const Tin* __restrict__ x,
                                              long long rows,
                                              long long steps,
                                              const Form& form, bool fold,
                                              const CompressArgs& p) {
  constexpr int L = B / E;   // lanes a row
  constexpr int R = 32 / L;  // rows a warp (a row group)
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  long long t = blockIdx.x;
  if (t >= steps) return;
  LaneWords<Tin, E> cur, nxt;
  // group g's lane span starts at element (g 32 + lane) E
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
    const bool live = row < rows;
    compress_segment<B, E, BF>(v, lane, live,
                               form.template row<B>(live ? row : 0), fold, p);
    if (tn >= steps) break;
    t = tn;
    g = gn;
    row = row_n;
    cur = nxt;
  }
}

template <typename Tin, int B, int E, bool BF>
__global__ void __launch_bounds__(kMaxThreads)
compress_blocks_kernel(const Tin* __restrict__ x, BlockForm form,
                       long long rows, long long steps, CompressArgs p) {
  compress_rows<Tin, B, E, BF>(x, rows, steps, form, false, p);
}

template <typename Tin, int B, int E, bool BF>
__global__ void __launch_bounds__(kMaxThreads)
compress_wire_kernel(const Tin* __restrict__ x, WireForm form,
                     long long rows, long long steps, CompressArgs p) {
  compress_rows<Tin, B, E, BF>(x, rows, steps, form, form.folded, p);
}

template <typename T>
struct Type {
  using type = T;
};

struct Launch {
  const void* x;
  int in_bf16;
  long long rows;
  dim3 grid, block;
  cudaStream_t st;
};

// kernel<Tin, B, E, BF> for the runtime input dtype and E, or
// cudaErrorInvalidValue for one the library is not built for.
template <int B, bool BF, typename Form, typename K>
int launch_e(const Launch& l, int e, const Form& form, const CompressArgs& p,
             K kernel) {
  auto go = [&](auto ec, auto tin) -> int {
    constexpr int E = decltype(ec)::value;
    using Tin = typename decltype(tin)::type;
    if constexpr (!built_for<Tin>(B, E, BF)) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      const long long per_step = (l.block.x / 32) * (32 / (B / E));
      const long long steps = (l.rows + per_step - 1) / per_step;
      kernel.template operator()<Tin, B, E, BF>(l, steps, form, p);
      return static_cast<int>(cudaGetLastError());
    }
  };
  auto go_e = [&](auto tin) -> int {
    switch (e) {
      case 8: return go(std::integral_constant<int, 8>{}, tin);
      case 16: return go(std::integral_constant<int, 16>{}, tin);
      case 32: return go(std::integral_constant<int, 32>{}, tin);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  return l.in_bf16 ? go_e(Type<__nv_bfloat16>{}) : go_e(Type<float>{});
}

struct LaunchBlocks {
  template <typename Tin, int B, int E, bool BF>
  void operator()(const Launch& l, long long steps, const BlockForm& form,
                  const CompressArgs& p) const {
    compress_blocks_kernel<Tin, B, E, BF><<<l.grid, l.block, 0, l.st>>>(
        static_cast<const Tin*>(l.x), form, l.rows, steps, p);
  }
};

struct LaunchWire {
  template <typename Tin, int B, int E, bool BF>
  void operator()(const Launch& l, long long steps, const WireForm& form,
                  const CompressArgs& p) const {
    compress_wire_kernel<Tin, B, E, BF><<<l.grid, l.block, 0, l.st>>>(
        static_cast<const Tin*>(l.x), form, l.rows, steps, p);
  }
};

inline bool bad_launch(int grid, int threads) {
  return grid < 1 || threads < 32 || threads > kMaxThreads || threads % 32;
}

inline CompressArgs args(int block, int fmt, int groups, float tau,
                         float eps, float scale_eps, float qmax,
                         float inv_sqrt_b) {
  // the plain version's f64 1/sqrt(B): sqrt and division correctly rounded
  return {fmt, groups, tau, eps, scale_eps, qmax, inv_sqrt_b,
          1.0 / std::sqrt(static_cast<double>(block))};
}

}  // namespace taco

// x: (rows, block) bf16 (in_bf16 != 0) or f32, contiguous, any alignment;
// q: (rows, block) payload bytes; alpha: (rows,) f32; scale: (rows, groups)
// f32.  e elements a lane, grid blocks of threads threads (a multiple of
// 32, at most 256): the wrapper's launch geometry.  bf16_compute selects
// the bf16 rounding of the plain version; inv_sqrt_b is its 1/sqrt(block)
// in the compute dtype.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a block size outside 32 .. 512, an e the
// library is not built for, or a bad grid).
extern "C" int taco_compress_blocks(const void* x, void* q, void* alpha,
                                    void* scale, int in_bf16, long long rows,
                                    int block, int e, int bf16_compute,
                                    int fmt, int groups, float tau, float eps,
                                    float scale_eps, float qmax,
                                    float inv_sqrt_b, int grid, int threads,
                                    void* stream) {
  using namespace taco;
  if (bad_launch(grid, threads)) return static_cast<int>(cudaErrorInvalidValue);
  const Launch l{x, in_bf16, rows, dim3(static_cast<unsigned>(grid)),
                 dim3(static_cast<unsigned>(threads)),
                 static_cast<cudaStream_t>(stream)};
  const BlockForm form{static_cast<uint8_t*>(q), static_cast<float*>(scale),
                       static_cast<float*>(alpha), groups};
  const CompressArgs p =
      args(block, fmt, groups, tau, eps, scale_eps, qmax, inv_sqrt_b);
  return with_shape(block, bf16_compute, [&](auto shape) {
    using S = decltype(shape);
    return launch_e<S::B, S::BF>(l, e, form, p, LaunchBlocks{});
  });
}

// x: (slots, n) bf16 (in_bf16 != 0) or f32, contiguous, any alignment;
// wire: (slots, total) uint8.  The slots' slots * n / block rows (at least
// 1, below 2^31) in one launch of the geometry (e, grid, threads); the
// other arguments as for taco_compress_blocks.
extern "C" int taco_compress_wire(const void* x, void* wire, int in_bf16,
                                  int slots, int n, long long total,
                                  int block, int e, int bf16_compute, int fmt,
                                  int groups, int folded, float tau,
                                  float eps, float scale_eps, float qmax,
                                  float inv_sqrt_b, int grid, int threads,
                                  void* stream) {
  using namespace taco;
  if (bad_launch(grid, threads) || block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mb = n / block;
  const long long rows = static_cast<long long>(slots) * mb;
  if (mb < 1 || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l{x, in_bf16, rows, dim3(static_cast<unsigned>(grid)),
                 dim3(static_cast<unsigned>(threads)),
                 static_cast<cudaStream_t>(stream)};
  const WireForm form{static_cast<uint8_t*>(wire), total, n, mb, groups,
                      folded != 0};
  const CompressArgs p =
      args(block, fmt, groups, tau, eps, scale_eps, qmax, inv_sqrt_b);
  return with_shape(block, bf16_compute, [&](auto shape) {
    using S = decltype(shape);
    return launch_e<S::B, S::BF>(l, e, form, p, LaunchWire{});
  });
}
