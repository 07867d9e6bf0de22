// Batched per-group min-plus contraction on the CUDA cores of an H100.
//
//   batched_minplus:   out[g, b, r] = min(INF, min_s gath[g, b, s] + w[g, s, r])
//                      gath [G, B, S], w [G, S, R], out [G, B, R]
//   batched_minplus_t: out[g, r, b] = min(INF, min_s gath[g, s, b] + w[g, s, r])
//                      gath [G, S, B], w [G, S, R], out [G, R, B]
//
// int32, INF = 2^30 - 1. Replaces: openr_tpu/ops/pallas_grouped.py::
// batched_minplus (_kernel) and ::batched_minplus_t (_kernel_t), the
// contraction of openr_tpu/ops/spf_grouped.py::_contract, which relaxes one
// bipartite segment of the grouped route sweep: G groups of R nodes sharing
// S sources.
//
// What bounds it: bytes. One relax step of the 10 000-node fat-tree's
// grouped sweep at B = 1024 destinations (segments G x S x R = 624 x 4 x 12,
// 624 x 12 x 4, 4 x 4 x 624, 4 x 624 x 4) reads 51 MB of gath and writes
// 51 MB of output against 82 M int32 add-min operations: about 31 us of
// memory traffic against about 1 us of arithmetic. Tensor cores have no
// (min, +) mode, so this is integer work on the CUDA cores. The update is
// Hopper's DPX __viaddmin_s32(x, y, acc) = min(x + y, acc), one
// instruction. No overflow: gath, w <= INF, so x + y <= 2^31 - 2; INF
// padding (weights) never wins a min.
//
// batched_minplus: one thread per output element, in the output's own
// order, so the stores of a warp are contiguous; a grid-stride loop covers
// any G * B * R. Each thread walks all S itself with the running min in a
// register: the Pallas kernel's s-chunking by 8 and its revisit grid past
// _S_CAP = 512 have no counterpart. The threads of a warp share a few
// (g, b) rows of gath (broadcast loads) and read neighbouring r of w.
//
// batched_minplus_t: one thread per (g, b) column and an R-tile of RT
// accumulators in registers, so each gath element is read once per R-tile
// (once in all when R <= 16) where a thread per output read it R times.
// Neighbouring lanes take neighbouring b: each gath load of a warp is one
// 128-byte transaction per s. The block stages its w[g, s, r-tile] in
// shared memory (kPieceS rows of s at a time, INF past R) and every thread
// reads it as a broadcast. Grid: x = (g, b-block), y = R-tile, z = S-split.
// When that grid is thin (the 4 x 624 x 4 segment has 4096 columns and one
// R-tile), S is split over z: each split writes its partial min to a
// scratch [splits, G, R, B] that the wrapper allocates, and a second small
// kernel min-reduces the splits into out; integer min does not depend on
// order, so the result is exact and the same on every run. The plan (RT,
// threads a block, S chunk, splits) is ops/grouped_minplus.py::
// minplus_t_plan; the wrapper checks every operand holds < 2^31 elements,
// so indices are 32-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = (1 << 30) - 1;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;
constexpr int kColThreads = 128;  // most threads (b columns) a _t block has
constexpr int kPieceS = 128;      // s rows of the staged w tile
constexpr unsigned kReduceBlocks = 4096;

__device__ __forceinline__ int32_t add_min(int32_t x, int32_t y, int32_t acc) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900)
  return __viaddmin_s32(x, y, acc);
#else
  return min(x + y, acc);
#endif
}

// gath [G, B, S] -> out [G, B, R]; w is [G, S, R].
__global__ void __launch_bounds__(kThreads)
batched_minplus_kernel(const int32_t* __restrict__ gath,
                       const int32_t* __restrict__ w,
                       int32_t* __restrict__ out, int G, int B, int S, int R) {
  const long long total = (long long)G * B * R;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const int r = (int)(idx % R);
    const int b = (int)((idx / R) % B);
    const long long g = idx / ((long long)B * R);
    const int32_t* a = gath + (g * B + b) * S;
    const int32_t* wp = w + g * S * R + r;
    int32_t acc = kInf;
    for (int s = 0; s < S; ++s) {
      acc = add_min(a[s], wp[(long long)s * R], acc);
    }
    out[idx] = min(acc, kInf);
  }
}

// gath [G, S, B], w [G, S, R] -> dst[z] [G, R, B]: split z's partial min
// over s in [z * s_chunk, (z + 1) * s_chunk), or the output when z is the
// only split.
template <int RT>
__global__ void __launch_bounds__(kColThreads)
batched_minplus_t_cols(const int32_t* __restrict__ gath,
                       const int32_t* __restrict__ w,
                       int32_t* __restrict__ dst, int G, int B, int S, int R,
                       int b_blocks, int s_chunk) {
  __shared__ __align__(16) int32_t ws[kPieceS * RT];
  const int g = blockIdx.x / b_blocks;
  const int b = (blockIdx.x - g * b_blocks) * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.y * RT;
  const int s0 = blockIdx.z * s_chunk;
  const int s1 = min(S, s0 + s_chunk);
  const bool live = b < B;
  const int32_t* col = gath + g * S * B + b;
  const int32_t* wg = w + g * S * R + r0;
  int32_t acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = kInf;
  for (int p0 = s0; p0 < s1; p0 += kPieceS) {
    const int np = min(kPieceS, s1 - p0);
    __syncthreads();  // every thread is done with the previous piece
    for (int i = threadIdx.x; i < np * RT; i += blockDim.x) {
      const int s = i / RT, r = i % RT;
      ws[i] = r0 + r < R ? __ldg(wg + (p0 + s) * R + r) : kInf;
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int s = 0; s < np; ++s) {
        const int32_t x = __ldg(col + (p0 + s) * B);
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = add_min(x, ws[s * RT + r], acc[r]);
      }
    }
  }
  if (!live) return;
  int32_t* o = dst + (blockIdx.z * G + g) * R * B + b;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r0 + r < R) o[(r0 + r) * B] = acc[r];
  }
}

// out[i] = min over the splits of part[z, i], i < n (= G * R * B).
__global__ void __launch_bounds__(kThreads)
batched_minplus_t_reduce(const int32_t* __restrict__ part,
                         int32_t* __restrict__ out, unsigned n, int splits) {
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    int32_t m = kInf;
    for (int z = 0; z < splits; ++z) m = min(m, __ldg(part + z * n + i));
    out[i] = m;
  }
}

}  // namespace

extern "C" int openr_batched_minplus(const void* gath, const void* w,
                                     void* out, int G, int B, int S, int R,
                                     void* stream) {
  const long long total = (long long)G * B * R;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  batched_minplus_kernel<<<(unsigned)blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gath), static_cast<const int32_t*>(w),
      static_cast<int32_t*>(out), G, B, S, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int openr_batched_minplus_t(const void* gath_t, const void* w,
                                       void* out, void* scratch, int G, int B,
                                       int S, int R, int r_tile, int threads,
                                       int s_chunk, int splits, void* stream) {
  if ((long long)G * B * R == 0) return 0;
  if (threads < 32 || threads > kColThreads || threads % 32 != 0 ||
      s_chunk < 1 || splits < 1 || (splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* g_ = static_cast<const int32_t*>(gath_t);
  const int32_t* w_ = static_cast<const int32_t*>(w);
  int32_t* out_ = static_cast<int32_t*>(out);
  int32_t* dst = splits > 1 ? static_cast<int32_t*>(scratch) : out_;
  const int b_blocks = (B + threads - 1) / threads;
  const dim3 grid((unsigned)(G * b_blocks), (unsigned)((R + r_tile - 1) / r_tile),
                  (unsigned)splits);
#define OPENR_MINPLUS_T(RT)                                           \
  batched_minplus_t_cols<RT><<<grid, threads, 0, st>>>(               \
      g_, w_, dst, G, B, S, R, b_blocks, s_chunk)
  switch (r_tile) {
    case 1: OPENR_MINPLUS_T(1); break;
    case 2: OPENR_MINPLUS_T(2); break;
    case 4: OPENR_MINPLUS_T(4); break;
    case 8: OPENR_MINPLUS_T(8); break;
    case 16: OPENR_MINPLUS_T(16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef OPENR_MINPLUS_T
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || splits == 1) return static_cast<int>(rc);
  const unsigned n = (unsigned)(G * R * B);
  unsigned blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kReduceBlocks) blocks = kReduceBlocks;
  batched_minplus_t_reduce<<<blocks, kThreads, 0, st>>>(dst, out_, n, splits);
  return static_cast<int>(cudaGetLastError());
}
