// One band of the sliced-ELL relaxation on an H100.
//
//   out[s, pos + j] = min(d[s, pos + j],
//                         min_slot min(d[s, src[j, slot]] + w_eff[j, slot], INF))
//   w_eff = INF where overloaded[src[j, slot]], else w[j, slot]
//
// int32, INF = 2^30 - 1. Replaces: openr_tpu/ops/pallas_ell.py::ell_band_relax
// (_relax_kernel), the band body of openr_tpu/ops/spf_sparse.py::_ell_relax,
// the relaxation step of every sparse (> 4096-node) SPF view solve.
//
// What bounds it: bytes. Each band row reads its k (src, w) slots (8 bytes a
// slot) and gathers k distances per batch row; there is one add-min per
// gathered distance, far below the card's integer rate. At 10 000 nodes the
// three bands hold about 116 K slots (0.9 MiB) and the [8, 10112] distance
// block is 0.3 MiB, so a relax step is a few microseconds of traffic at best
// and the launch itself is of the same order. What is left is latency: each
// slot is a chain of dependent loads (src, then overloaded[src] and
// d[s, src]), so the time of a row is its slot count over the loads a
// thread keeps in flight.
//
// Two bodies; the launch plan (ops/ell_relax.py::launch_plan) picks one per
// band, and its threads a row. Grid: (band-row tiles, batch rows s).
// - narrow bands (k <= 32; a 10 000-node fat-tree's 7488 x 8 and 2496 x 16
//   rack and fabric bands): one thread per (s, j) row, kThreads rows a
//   block. A row's few slots are one short chain, and the band has
//   thousands of rows: the grid is full.
// - wide bands (k >= 33; the 16 x 1024 spine band of that fabric): a row
//   would be one thread walking 1024 chains while the card idles, so a row
//   gets 32 to 256 threads of a kWideThreads block (the plan grows them
//   until the grid holds enough warps or a thread has about 4 slots). Each
//   thread min-reduces the slots tid, tid + T, ... (a warp's src and w
//   loads are contiguous), four at a time with their loads issued before
//   their uses; __reduce_min_sync joins a warp's lanes and shared memory
//   the warps of a row.
// The bodies step each operand by a per-world stride over blockIdx.z; the
// entry point launches one world. (The tenant plane's world axis has a
// kernel of its own, designed for its uniform blocks: ell_relax_worlds.cu.)
// Either body writes straight into column pos + j of an output shaped like
// d: every band of the port's _ell_relax writes its own column slice of one
// [S, n_pad] output, which replaces the JAX concatenate of band parts. The
// gathered distance row of one batch row is n_pad int32 (40 KB at 10 k
// nodes) and stays in L1/L2, so the gathers are cache hits. No overflow:
// d, w <= INF, so d + w <= 2^31 - 2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = (1 << 30) - 1;
constexpr int kThreads = 128;      // narrow: band rows a block
constexpr int kWideThreads = 256;  // wide: threads a block, 1 to 8 rows
constexpr int kUnroll = 4;         // slots a wide thread has in flight

__device__ __forceinline__ int32_t add_min(int32_t x, int32_t y, int32_t acc) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900)
  return __viaddmin_s32(x, y, acc);
#else
  return min(x + y, acc);
#endif
}

template <typename Ov>
__global__ void __launch_bounds__(kThreads)
ell_band_relax_narrow(const int32_t* __restrict__ d, int n_pad,
                      const int32_t* __restrict__ src,
                      const int32_t* __restrict__ w, int rows, int k,
                      const Ov* __restrict__ overloaded, int pos,
                      int32_t* __restrict__ out, size_t d_world,
                      size_t sw_world, size_t ov_world) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int s = blockIdx.y;
  if (j >= rows) return;
  const size_t b = blockIdx.z;
  d += b * d_world;
  out += b * d_world;
  src += b * sw_world;
  w += b * sw_world;
  overloaded += b * ov_world;
  const int32_t* drow = d + (size_t)s * n_pad;
  const int32_t* srow = src + (size_t)j * k;
  const int32_t* wrow = w + (size_t)j * k;
  int32_t best = drow[pos + j];
  for (int slot = 0; slot < k; ++slot) {
    const int32_t from = srow[slot];
    const int32_t ww = overloaded[from] != 0 ? kInf : wrow[slot];
    best = min(best, min(drow[from] + ww, kInf));
  }
  out[(size_t)s * n_pad + pos + j] = best;
}

// A row of 2^shift (32..256) threads; kWideThreads >> shift rows a block.
template <typename Ov>
__global__ void __launch_bounds__(kWideThreads)
ell_band_relax_wide(const int32_t* __restrict__ d, int n_pad,
                    const int32_t* __restrict__ src,
                    const int32_t* __restrict__ w, int rows, int k,
                    const Ov* __restrict__ overloaded, int pos, int shift,
                    int32_t* __restrict__ out, size_t d_world,
                    size_t sw_world, size_t ov_world) {
  __shared__ int32_t part[kWideThreads / 32];
  const size_t b = blockIdx.z;
  d += b * d_world;
  out += b * d_world;
  src += b * sw_world;
  w += b * sw_world;
  overloaded += b * ov_world;
  const int step = 1 << shift;
  const int lane = threadIdx.x & (step - 1);
  const int j = blockIdx.x * (kWideThreads >> shift) + (threadIdx.x >> shift);
  const int s = blockIdx.y;
  const bool live = j < rows;
  const int32_t* drow = d + (size_t)s * n_pad;
  int32_t best = kInf;
  if (live) {
    const int32_t* srow = src + (size_t)j * k;
    const int32_t* wrow = w + (size_t)j * k;
    int slot = lane;
    for (; slot + (kUnroll - 1) * step < k; slot += kUnroll * step) {
      int32_t from[kUnroll], ww[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        from[u] = __ldg(srow + slot + u * step);
        ww[u] = __ldg(wrow + slot + u * step);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int32_t wu = __ldg(overloaded + from[u]) != 0 ? kInf : ww[u];
        best = add_min(__ldg(drow + from[u]), wu, best);
      }
    }
    for (; slot < k; slot += step) {
      const int32_t from = __ldg(srow + slot);
      const int32_t wu = __ldg(overloaded + from) != 0 ? kInf : __ldg(wrow + slot);
      best = add_min(__ldg(drow + from), wu, best);
    }
  }
  // a warp lies inside one row (step >= 32): join its lanes, then the
  // row's warps through shared memory
  best = __reduce_min_sync(0xffffffffu, best);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = best;
  __syncthreads();
  if (live && lane == 0) {
    for (int i = 1; i < (step >> 5); ++i) best = min(best, part[warp + i]);
    out[(size_t)s * n_pad + pos + j] = min(best, __ldg(drow + pos + j));
  }
}

// B worlds on grid.z; a world's d and out step by S * n_pad, its src and w
// by rows * k and its overloaded by n_pad (all unused when B = 1).
template <typename Ov>
cudaError_t launch(const int32_t* d, int B, int S, int n_pad,
                   const int32_t* src, const int32_t* w, int rows, int k,
                   const Ov* ov, int pos, int row_threads, int32_t* out,
                   cudaStream_t st) {
  const size_t d_world = (size_t)S * n_pad;
  const size_t sw_world = (size_t)rows * k;
  const size_t ov_world = (size_t)n_pad;
  if (B < 1 || B > 65535) return cudaErrorInvalidValue;
  if (row_threads == 1) {
    const dim3 grid((rows + kThreads - 1) / kThreads, S, B);
    ell_band_relax_narrow<Ov><<<grid, kThreads, 0, st>>>(
        d, n_pad, src, w, rows, k, ov, pos, out, d_world, sw_world, ov_world);
    return cudaGetLastError();
  }
  int shift = 5;
  while ((1 << shift) < row_threads) ++shift;
  if ((1 << shift) != row_threads || row_threads > kWideThreads) {
    return cudaErrorInvalidValue;
  }
  const int per_block = kWideThreads >> shift;
  const dim3 grid((rows + per_block - 1) / per_block, S, B);
  ell_band_relax_wide<Ov><<<grid, kWideThreads, 0, st>>>(
      d, n_pad, src, w, rows, k, ov, pos, shift, out, d_world, sw_world,
      ov_world);
  return cudaGetLastError();
}

}  // namespace

// row_threads: 1 for the narrow body, else the threads of a wide row
// (32, 64, 128 or 256), as the launch plan says.
extern "C" int openr_ell_band_relax(const void* d, int S, int n_pad,
                                    const void* src, const void* w, int rows,
                                    int k, const void* overloaded,
                                    int ov_is_int32, int pos, int row_threads,
                                    void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* d_ = static_cast<const int32_t*>(d);
  const int32_t* src_ = static_cast<const int32_t*>(src);
  const int32_t* w_ = static_cast<const int32_t*>(w);
  int32_t* out_ = static_cast<int32_t*>(out);
  cudaError_t rc;
  if (ov_is_int32) {
    rc = launch(d_, 1, S, n_pad, src_, w_, rows, k,
                static_cast<const int32_t*>(overloaded), pos, row_threads,
                out_, st);
  } else {
    rc = launch(d_, 1, S, n_pad, src_, w_, rows, k,
                static_cast<const uint8_t*>(overloaded), pos, row_threads,
                out_, st);
  }
  return static_cast<int>(rc);
}
