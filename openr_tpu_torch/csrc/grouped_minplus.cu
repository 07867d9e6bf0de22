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
// batched_minplus: two bodies, both with 32-bit indices on a 3-D grid that
// maps blocks straight to their tiles (no per-element division), both able
// to split S over blockIdx.z when the grid is thin. The launch plan
// (ops/grouped_minplus.py::minplus_plan) picks the body, its tile and the
// splits.
// - rows (R <= 16; the 624 x 4 x 12 and 624 x 12 x 4 segments, and the thin
//   4 x 624 x 4 one): one thread per (g, b) row with its R accumulators
//   in registers (RT = R rounded up to a power of two), so each gath
//   element is read once (a thread per output read it R times). The block
//   stages w[g, s-piece, :] in shared memory, read as a broadcast. A warp's 32 rows are one
//   contiguous [32, S] block of gath and [32, R] block of out: where S
//   (and the split's S range) is a multiple of 4 a thread reads its row as
//   int4 vectors, and where R is, writes it so. Grid: x = (g, b-block),
//   z = S-split.
// - cols (R > 16; the 4 x 4 x 624 segment): neighbouring lanes take
//   neighbouring r, so a warp's stores of out[g, b, r] are contiguous.
//   Each thread holds a piece of its w[g, :, r] column (4 rows of s) in
//   registers and walks a run of up to kRunB b rows with an accumulator
//   each; the gath[g, b, s-piece] reads are the same address across the
//   warp (broadcasts, int4 where S allows), and all of a piece's loads
//   issue before its add-mins. Grid: x = (g, r-block), y = b-run,
//   z = S-split.
// A split writes its partial min into a scratch [splits, G, B, R] that the
// wrapper allocates, and batched_minplus_t_reduce (an elementwise min over
// the splits, whatever the layout) min-reduces it into out; integer min
// does not depend on order, so the result is exact and the same on every
// run. The 4 x 624 x 4 segment (4096 rows) splits S 16 ways.
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
constexpr int kColThreads = 128;  // most threads (b columns) a _t block has
constexpr int kPieceS = 128;      // s rows of the staged w tile
constexpr unsigned kReduceBlocks = 4096;
constexpr int kRunB = 8;          // most b rows a cols thread walks
constexpr int kVecS = 1;          // flag: gath rows read as int4
constexpr int kVecR = 2;          // flag: out rows written as int4

__device__ __forceinline__ int32_t add_min(int32_t x, int32_t y, int32_t acc) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900)
  return __viaddmin_s32(x, y, acc);
#else
  return min(x + y, acc);
#endif
}

// gath [G, B, S], w [G, S, R] -> dst[z] [G, B, R]: split z's partial min
// over s in [z * s_chunk, (z + 1) * s_chunk), or the output when z is the
// only split. One thread per (g, b) row, RT >= R accumulators.
template <int RT>
__global__ void __launch_bounds__(kColThreads)
batched_minplus_rows(const int32_t* __restrict__ gath,
                     const int32_t* __restrict__ w,
                     int32_t* __restrict__ dst, int G, int B, int S, int R,
                     int b_blocks, int s_chunk, int flags) {
  __shared__ __align__(16) int32_t ws[kPieceS * RT];
  const int g = blockIdx.x / b_blocks;
  const int b = (blockIdx.x - g * b_blocks) * blockDim.x + threadIdx.x;
  const int s0 = blockIdx.z * s_chunk;
  const int s1 = min(S, s0 + s_chunk);
  const bool live = b < B;
  const int row = g * B + b;  // < G * B when live
  const int32_t* a = gath + (live ? row * S : 0);
  const int32_t* wg = w + g * S * R;
  int32_t acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = kInf;
  for (int p0 = s0; p0 < s1; p0 += kPieceS) {
    const int np = min(kPieceS, s1 - p0);
    __syncthreads();  // every thread is done with the previous piece
    for (int i = threadIdx.x; i < np * RT; i += blockDim.x) {
      const int s = i / RT, r = i % RT;
      ws[i] = r < R ? __ldg(wg + (p0 + s) * R + r) : kInf;
    }
    __syncthreads();
    if (!live) continue;
    if (flags & kVecS) {  // S and the split's range are multiples of 4
#pragma unroll 2
      for (int s = 0; s < np; s += 4) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(a + p0 + s));
        const int32_t* wp = ws + s * RT;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          acc[r] = add_min(x.x, wp[r], acc[r]);
          acc[r] = add_min(x.y, wp[RT + r], acc[r]);
          acc[r] = add_min(x.z, wp[2 * RT + r], acc[r]);
          acc[r] = add_min(x.w, wp[3 * RT + r], acc[r]);
        }
      }
    } else {
#pragma unroll 4
      for (int s = 0; s < np; ++s) {
        const int32_t x = __ldg(a + p0 + s);
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = add_min(x, ws[s * RT + r], acc[r]);
      }
    }
  }
  if (!live) return;
  int32_t* o = dst + (blockIdx.z * G * B + row) * R;
  if (RT >= 4 && (flags & kVecR)) {  // R is a multiple of 4
#pragma unroll
    for (int q = 0; q < RT / 4; ++q) {
      if (4 * q < R) {
        reinterpret_cast<int4*>(o)[q] =
            make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r < R) o[r] = acc[r];
    }
  }
}

// The same contraction, one thread per (g, r) column walking a run of
// `chunk` (<= kRunB) b rows.
__global__ void __launch_bounds__(kColThreads)
batched_minplus_cols(const int32_t* __restrict__ gath,
                     const int32_t* __restrict__ w,
                     int32_t* __restrict__ dst, int G, int B, int S, int R,
                     int r_blocks, int chunk, int s_chunk, int flags) {
  const int g = blockIdx.x / r_blocks;
  const int r = (blockIdx.x - g * r_blocks) * blockDim.x + threadIdx.x;
  if (r >= R) return;  // nothing below synchronises the block
  const int b0 = blockIdx.y * chunk;
  const int nb = min(chunk, B - b0);
  const int s0 = blockIdx.z * s_chunk;
  const int s1 = min(S, s0 + s_chunk);
  const int32_t* wc = w + g * S * R + r;
  const int32_t* a = gath + (g * B + b0) * S;
  int32_t acc[kRunB];
#pragma unroll
  for (int i = 0; i < kRunB; ++i) acc[i] = kInf;
  // pieces of 4 s: all of a piece's w and gath loads issue before its
  // add-mins, so a short S costs one memory round trip
  for (int p0 = s0; p0 < s1; p0 += 4) {
    const int np = min(4, s1 - p0);
    int32_t wr[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) wr[s] = s < np ? __ldg(wc + (p0 + s) * R) : kInf;
    int4 x[kRunB];
#pragma unroll
    for (int i = 0; i < kRunB; ++i) {
      const int32_t* ai = a + i * S + p0;
      if (i >= nb) {
        x[i] = make_int4(0, 0, 0, 0);
      } else if (flags & kVecS) {  // np == 4
        x[i] = __ldg(reinterpret_cast<const int4*>(ai));
      } else {  // an INF weight pads each s past np
        x[i] = make_int4(__ldg(ai), np > 1 ? __ldg(ai + 1) : 0,
                         np > 2 ? __ldg(ai + 2) : 0, np > 3 ? __ldg(ai + 3) : 0);
      }
    }
#pragma unroll
    for (int i = 0; i < kRunB; ++i) {
      acc[i] = add_min(x[i].x, wr[0], acc[i]);
      acc[i] = add_min(x[i].y, wr[1], acc[i]);
      acc[i] = add_min(x[i].z, wr[2], acc[i]);
      acc[i] = add_min(x[i].w, wr[3], acc[i]);
    }
  }
  int32_t* o = dst + (blockIdx.z * G * B + g * B + b0) * R + r;
#pragma unroll
  for (int i = 0; i < kRunB; ++i) {
    if (i < nb) o[i * R] = acc[i];
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

// body 0: rows (r_tile >= R accumulators a thread, `threads` b rows a
// block);
// body 1: cols (`threads` r columns a block, runs of `chunk` b rows). S is
// split `splits` ways in ranges of s_chunk; a split writes its partial
// mins into scratch [splits, G, B, R] and a second kernel reduces them.
extern "C" int openr_batched_minplus(const void* gath, const void* w,
                                     void* out, void* scratch, int G, int B,
                                     int S, int R, int body, int r_tile,
                                     int threads, int chunk, int s_chunk,
                                     int splits, void* stream) {
  if ((long long)G * B * R == 0) return 0;
  if (threads < 32 || threads > kColThreads || threads % 32 != 0 ||
      s_chunk < 1 || splits < 1 || (splits > 1 && scratch == nullptr) ||
      (body == 1 && (chunk < 1 || chunk > kRunB))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* g_ = static_cast<const int32_t*>(gath);
  const int32_t* w_ = static_cast<const int32_t*>(w);
  int32_t* out_ = static_cast<int32_t*>(out);
  int32_t* dst = splits > 1 ? static_cast<int32_t*>(scratch) : out_;
  const bool aligned_g = (reinterpret_cast<uintptr_t>(gath) & 15) == 0;
  const bool aligned_d = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  int flags = 0;
  if (S % 4 == 0 && (splits == 1 || s_chunk % 4 == 0) && aligned_g) flags |= kVecS;
  if (body == 0) {
    if (r_tile < R) return static_cast<int>(cudaErrorInvalidValue);
    if (R % 4 == 0 && aligned_d) flags |= kVecR;
    const int b_blocks = (B + threads - 1) / threads;
    const dim3 grid((unsigned)(G * b_blocks), 1, (unsigned)splits);
#define OPENR_MINPLUS_ROWS(RT)                                        \
  batched_minplus_rows<RT><<<grid, threads, 0, st>>>(                 \
      g_, w_, dst, G, B, S, R, b_blocks, s_chunk, flags)
    switch (r_tile) {
      case 1: OPENR_MINPLUS_ROWS(1); break;
      case 2: OPENR_MINPLUS_ROWS(2); break;
      case 4: OPENR_MINPLUS_ROWS(4); break;
      case 8: OPENR_MINPLUS_ROWS(8); break;
      case 16: OPENR_MINPLUS_ROWS(16); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef OPENR_MINPLUS_ROWS
  } else if (body == 1) {
    const int r_blocks = (R + threads - 1) / threads;
    const dim3 grid((unsigned)(G * r_blocks), (unsigned)((B + chunk - 1) / chunk),
                    (unsigned)splits);
    batched_minplus_cols<<<grid, threads, 0, st>>>(
        g_, w_, dst, G, B, S, R, r_blocks, chunk, s_chunk, flags);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || splits == 1) return static_cast<int>(rc);
  const unsigned n = (unsigned)(G * B * R);
  unsigned blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kReduceBlocks) blocks = kReduceBlocks;
  batched_minplus_t_reduce<<<blocks, kThreads, 0, st>>>(dst, out_, n, splits);
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
