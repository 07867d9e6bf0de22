// Min-plus (tropical) product on the CUDA cores of an H100.
//
//   out[s, j] = min(INF, min_k a[s, k] + b[k, j])      int32, INF = 2^30 - 1
//
// Replaces: openr_tpu/ops/pallas_minplus.py::minplus (_minplus_kernel), the
// relaxation step of the dense batched SPF (openr_tpu/ops/spf.py _minplus).
//
// What bounds it: on the main path a is one batch of distance rows [8, n_pad]
// (8 to 64 rows: the root and its neighbours, padded to a power of two) and
// b the transit-masked metric matrix [n_pad, n_pad]; every output needs a
// whole column of b, so the least traffic is one read of b (4 MiB at n_pad =
// 1024): bytes, not operations (8.4 M add-min pairs at S = 8). Tensor cores
// have no (min, +) mode, so wgmma does not apply; this is integer work on
// the CUDA cores. A thread per output walking all of K is one dependent
// chain of K add-mins (the first port's design, latency-bound at about 23x
// its bound), so the design is about independent work in flight:
//
// - Register tiles. A thread owns kRows = 8 rows x 4 adjacent columns: 32
//   independent accumulators. It reads its 4 columns of a b row as one int4
//   (16-byte aligned b and N % 4 == 0; a scalar path masks ragged N) and
//   uses each element 8 times; the a values come from a [k][8] slice staged
//   in shared memory, read as int4 broadcasts. kUnroll b rows are loaded
//   before their add-mins. (16 rows a thread took 121 registers and
//   measured slower on an H100 at every S from 16 to 1024.)
// - K split over the warps of a block. A block is 32 columns (kGroups = 8
//   column groups of 4) x 4 * warps K lanes, up to 4 warps; a warp is 4 K
//   lanes x 32 columns, so its b loads are four whole 128-byte rows. Lane
//   kl takes k = kl, kl + lanes, ... of the block's K range. Shuffles join
//   a warp's 4 K lanes and shared memory joins the warps.
// - K split over blocks. Where the grid of (column tiles x S-tiles) is
//   still thin (32 blocks at [8, 1024] x [1024, 1024] on 132 SMs), grid.z
//   splits K too: each split writes its partial mins into a scratch
//   [splits, S, N] allocated by the wrapper, and minplus_split_reduce takes
//   their min (exact in any order).
// - S-tiles on grid.y, walked with a stride of gridDim.y, so any S runs.
// The launch plan (ops/minplus.py::minplus_plan) picks the warps over K
// and the splits. The update is Hopper's DPX
// __viaddmin_s32(x, y, acc) = min(x + y, acc), one instruction. No
// overflow: every operand is <= INF, so x + y <= 2^31 - 2; acc starts at
// INF and only falls, so the output saturates at INF.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = (1 << 30) - 1;
constexpr int kRows = 8;              // output rows a thread (an S-tile)
constexpr int kGroups = 8;            // column groups of 4 a block
constexpr int kCols = 4 * kGroups;    // output columns a block: 32
constexpr int kMaxWarps = 4;          // warps over K a block
constexpr int kPiece = 128;           // k of a staged a slice
constexpr int kUnroll = 4;            // b rows a thread loads ahead
constexpr int kReduceThreads = 256;

__device__ __forceinline__ int32_t add_min(int32_t x, int32_t y, int32_t acc) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900)
  return __viaddmin_s32(x, y, acc);
#else
  return min(x + y, acc);
#endif
}

// columns col .. col + 3 of b row k; INF past N
template <bool kVec>
__device__ __forceinline__ int4 load_b(const int32_t* __restrict__ b, int k,
                                       int col, int N) {
  const int32_t* row = b + (size_t)k * N;
  if (kVec) {
    if (col < N) return __ldg(reinterpret_cast<const int4*>(row + col));
    return make_int4(kInf, kInf, kInf, kInf);
  }
  return make_int4(col < N ? __ldg(row + col) : kInf,
                   col + 1 < N ? __ldg(row + col + 1) : kInf,
                   col + 2 < N ? __ldg(row + col + 2) : kInf,
                   col + 3 < N ? __ldg(row + col + 3) : kInf);
}

// acc[r][c] = min(acc[r][c], a[r] + b[c]) over a kRows x 4 tile, a[r]
// from the staged slice (kRows consecutive ints of one k)
__device__ __forceinline__ void tile_step(int32_t (&acc)[kRows][4],
                                          const int32_t* a_k, int4 bv) {
#pragma unroll
  for (int i = 0; i < kRows / 4; ++i) {
    const int4 av = reinterpret_cast<const int4*>(a_k)[i];
    const int32_t ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int32_t* row = acc[4 * i + q];
      row[0] = add_min(ar[q], bv.x, row[0]);
      row[1] = add_min(ar[q], bv.y, row[1]);
      row[2] = add_min(ar[q], bv.z, row[2]);
      row[3] = add_min(ar[q], bv.w, row[3]);
    }
  }
}

// grid (column tiles, S-tiles (strided), K splits); block 32 x warps
// threads. dst is the output, or the scratch [splits, S, N] when split.
template <bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
minplus_tile(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
             int32_t* __restrict__ dst, int S, int K, int N, int k_chunk) {
  __shared__ __align__(16) int32_t a_s[kPiece * kRows];  // [k][kRows]
  __shared__ __align__(16) int32_t part[kMaxWarps][kRows * kCols];
  const int t = threadIdx.x;
  const int warps = blockDim.x >> 5;
  const int lanes = blockDim.x / kGroups;  // K lanes of the block
  const int g = t % kGroups;
  const int kl = t / kGroups;
  const int col0 = blockIdx.x * kCols;
  const int col = col0 + 4 * g;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  int32_t* out = dst + (size_t)blockIdx.z * S * N;
  const int s_tiles = (S + kRows - 1) / kRows;
  for (int st = blockIdx.y; st < s_tiles; st += gridDim.y) {
    const int row0 = st * kRows;
    int32_t acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = kInf;
    }
    for (int k0 = k_begin; k0 < k_end; k0 += kPiece) {
      const int len = min(kPiece, k_end - k0);
      __syncthreads();  // every thread is done with the previous slice
      // a rows are read along k (coalesced) and stored k-major
      for (int e = t; e < len * kRows; e += blockDim.x) {
        const int r = e / len, kk = e % len;
        a_s[kk * kRows + r] =
            row0 + r < S ? __ldg(a + (size_t)(row0 + r) * K + k0 + kk) : kInf;
      }
      __syncthreads();
      int kk = kl;
      for (; kk + (kUnroll - 1) * lanes < len; kk += kUnroll * lanes) {
        int4 bv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          bv[u] = load_b<kVec>(b, k0 + kk + u * lanes, col, N);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          tile_step(acc, a_s + (kk + u * lanes) * kRows, bv[u]);
        }
      }
      for (; kk < len; kk += lanes) {
        tile_step(acc, a_s + kk * kRows, load_b<kVec>(b, k0 + kk, col, N));
      }
    }
    // join the warp's 4 K lanes of each column group (lanes g, g + 8,
    // g + 16, g + 24), then the warps through shared memory
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int32_t v = acc[r][c];
        v = min(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = min(v, __shfl_xor_sync(0xffffffffu, v, 16));
        acc[r][c] = v;
      }
    }
    const int warp = t >> 5;
    if ((t & 31) < kGroups) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        *reinterpret_cast<int4*>(&part[warp][r * kCols + 4 * g]) =
            make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    __syncthreads();
    for (int e = t; e < kRows * kCols; e += blockDim.x) {
      const int r = e / kCols, c = col0 + e % kCols;
      int32_t m = part[0][e];
      for (int w = 1; w < warps; ++w) m = min(m, part[w][e]);
      if (row0 + r < S && c < N) out[(size_t)(row0 + r) * N + c] = m;
    }
    __syncthreads();  // part is read before the next S-tile writes it
  }
}

// out[i] = min over the splits of part[z, i], i < n (= S * N).
__global__ void __launch_bounds__(kReduceThreads)
minplus_split_reduce(const int32_t* __restrict__ part,
                     int32_t* __restrict__ out, size_t n, int splits) {
  for (size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kReduceThreads) {
    int32_t m = kInf;
    for (int z = 0; z < splits; ++z) m = min(m, __ldg(part + z * n + i));
    out[i] = m;
  }
}

}  // namespace

// k_warps: 1, 2 or 4 warps over K a block; K is split `splits` ways in
// ranges of k_chunk; a split writes its partial mins into scratch
// [splits, S, N] and a second kernel reduces them into out.
extern "C" int openr_minplus(const void* a, const void* b, void* out,
                             void* scratch, int S, int K, int N, int k_warps,
                             int k_chunk, int splits, void* stream) {
  if ((long long)S * N == 0) return 0;
  if ((k_warps != 1 && k_warps != 2 && k_warps != 4) ||
      splits < 1 || splits > 65535 || k_chunk < 0 ||
      (long long)k_chunk * splits < K || (splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* a_ = static_cast<const int32_t*>(a);
  const int32_t* b_ = static_cast<const int32_t*>(b);
  int32_t* out_ = static_cast<int32_t*>(out);
  int32_t* dst = splits > 1 ? static_cast<int32_t*>(scratch) : out_;
  const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const int s_tiles = (S + kRows - 1) / kRows;
  const dim3 grid((N + kCols - 1) / kCols, s_tiles < 65535 ? s_tiles : 65535,
                  splits);
  const int threads = 32 * k_warps;
  if (vec) {
    minplus_tile<true><<<grid, threads, 0, st>>>(a_, b_, dst, S, K, N, k_chunk);
  } else {
    minplus_tile<false><<<grid, threads, 0, st>>>(a_, b_, dst, S, K, N, k_chunk);
  }
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || splits == 1) return static_cast<int>(rc);
  const size_t n = (size_t)S * N;
  size_t blocks = (n + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  minplus_split_reduce<<<(unsigned)blocks, kReduceThreads, 0, st>>>(
      dst, out_, n, splits);
  return static_cast<int>(cudaGetLastError());
}
