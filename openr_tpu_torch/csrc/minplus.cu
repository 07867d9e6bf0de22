// Min-plus (tropical) product on the CUDA cores of an H100.
//
//   out[s, j] = min(INF, min_k a[s, k] + b[k, j])      int32, INF = 2^30 - 1
//
// Replaces: openr_tpu/ops/pallas_minplus.py::minplus (_minplus_kernel), the
// relaxation step of the dense batched SPF (openr_tpu/ops/spf.py _minplus).
//
// What bounds it: on the main path a is one batch of distance rows [8, n_pad]
// and b the transit-masked metric matrix [n_pad, n_pad]; every output needs a
// whole column of b, so the least traffic is one read of b (4 MiB at n_pad =
// 1024): bytes, not operations (16.8 M add-min pairs). Tensor cores have no
// (min, +) mode, so wgmma does not apply; this is integer work on the CUDA
// cores.
//
// Design: a block computes a TS x TN output tile with one thread per output
// and walks K in TK-wide chunks staged in shared memory (an a-tile and a
// b-tile); each thread keeps one int32 running min in a register. A warp is
// 32 neighbouring columns of one row, so the a-tile read is a broadcast and the
// b-tile read is conflict-free. With TS = 8 a block covers the whole 8-row
// batch and reads each b element from device memory once. Ragged edges are
// masked: padding loads are INF (a + INF never wins), so any S, K, N works.
// The update is Hopper's DPX __viaddmin_s32(x, y, acc) = min(x + y, acc), one
// instruction. No overflow: every operand is <= INF, so x + y <= 2^31 - 2,
// which fits in int32; the final min(acc, INF) restores the saturation.
// Not done here (work for a later, faster version): double-buffered
// cp.async/TMA staging, register micro-tiles, split-K for the 8-block grid
// that an 8 x 1024 product gives.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = (1 << 30) - 1;
constexpr int TS = 8;    // output rows per block
constexpr int TN = 32;   // output columns per block (one warp)
constexpr int TK = 128;  // K chunk staged in shared memory

__device__ __forceinline__ int32_t add_min(int32_t x, int32_t y, int32_t acc) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900)
  return __viaddmin_s32(x, y, acc);
#else
  return min(x + y, acc);
#endif
}

__global__ void __launch_bounds__(TS * TN)
minplus_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int32_t* __restrict__ out, int S, int K, int N) {
  __shared__ int32_t a_tile[TS][TK];
  __shared__ int32_t b_tile[TK][TN];

  const int tx = threadIdx.x;  // column within the tile
  const int ty = threadIdx.y;  // row within the tile
  const int tid = ty * TN + tx;
  const int row0 = blockIdx.y * TS;
  const int col0 = blockIdx.x * TN;
  const int row = row0 + ty;
  const int col = col0 + tx;

  int32_t acc = kInf;
  for (int k0 = 0; k0 < K; k0 += TK) {
    // a-tile: TS x TK, threads stride over it
    for (int e = tid; e < TS * TK; e += TS * TN) {
      const int r = e / TK, kk = e % TK;
      const int gr = row0 + r, gk = k0 + kk;
      a_tile[r][kk] = (gr < S && gk < K) ? a[(size_t)gr * K + gk] : kInf;
    }
    // b-tile: TK x TN, a warp loads 32 neighbouring columns of one row
    for (int e = tid; e < TK * TN; e += TS * TN) {
      const int kk = e / TN, c = e % TN;
      const int gk = k0 + kk, gc = col0 + c;
      b_tile[kk][c] = (gk < K && gc < N) ? b[(size_t)gk * N + gc] : kInf;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < TK; ++kk) {
      acc = add_min(a_tile[ty][kk], b_tile[kk][tx], acc);
    }
    __syncthreads();
  }
  if (row < S && col < N) {
    out[(size_t)row * N + col] = min(acc, kInf);
  }
}

}  // namespace

extern "C" int openr_minplus(const void* a, const void* b, void* out, int S,
                             int K, int N, void* stream) {
  const dim3 block(TN, TS);
  const dim3 grid((N + TN - 1) / TN, (S + TS - 1) / TS);
  minplus_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), S, K, N);
  return static_cast<int>(cudaGetLastError());
}
