// One band of the per-batch-masked sliced-ELL relaxation on an H100: the
// KSP2 second-path solve, one masked graph per batch row.
//
//   out[s, pos + j] = min(d[s, pos + j],
//                         min_slot min(d[s, src[j, slot]] + w_eff, INF))
//   w_eff = INF where mask[s, j, slot] or overloaded[src[j, slot]],
//           else w[j, slot]
//
// int32, INF = 2^30 - 1. Row s of d is the distance row of one masked graph
// (one KSP2 destination's "graph minus its first-path links"); mask is bool
// [S, rows, k], read as bytes, True where that destination excludes the edge.
// Replaces: openr_tpu/ops/pallas_ell.py::ell_band_relax_masked
// (_masked_relax_kernel), the band body of
// openr_tpu/ops/spf_sparse.py::_ell_relax_masked.
//
// What bounds it: bytes, and the mask is the largest stream. One step at
// 1008 nodes (S = 1024 destinations, 10 944 slots) reads an 11.2 MB mask
// beside the 4.2 MB distance block and the same again written; at 10 000
// nodes (S = 256, 116 224 slots) the mask is 29.8 MB. There is one add-min
// per slot and batch row, far below the card's integer rate.
//
// Design, two shapes of one body, the layout of rev_relax.cu:
// - narrow bands (k < kWideK): one thread per (s, j) band row, blockIdx.y = s,
//   threads over j. A thread's mask slots are k contiguous bytes and the
//   neighbouring lanes hold the neighbouring rows, so a warp reads one
//   contiguous 32 * k byte span of the mask; where k is a multiple of 8 and
//   the mask 8-byte aligned, each thread loads its bytes 8 at a time. The
//   band's (src, w) slots are shared by every s and stay in L1/L2, and one
//   d row (the block's s) serves the whole block.
// - wide bands (k >= kWideK, the 16 spine rows of a fat-tree, k = 64 at
//   1008 nodes and 1024 at 10 000): one warp per (s, j); lane l takes slots
//   l, l + 32, ..., so a warp's src, w and mask loads are contiguous, and a
//   warp min-reduction (__reduce_min_sync) joins the lanes. A thread per row
//   would leave 16 threads of a batch row walking 1024 slots alone.
// Either shape writes straight into column pos + j of an output shaped like
// d, so every band of the port's _ell_relax_masked writes its column slice of
// one output. No overflow: d, w <= INF, so d + w <= 2^31 - 2; a masked or
// overloaded slot adds INF to d and clamps to INF like any other.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = (1 << 30) - 1;
constexpr int kThreads = 128;  // narrow: band rows per block
constexpr int kWarps = 8;      // wide: band rows (one per warp) per block
constexpr int kWideK = 64;

template <typename Ov>
__device__ __forceinline__ int32_t relax_slot(const int32_t* __restrict__ drow,
                                              const Ov* __restrict__ ov,
                                              int32_t from, int32_t w,
                                              bool excluded) {
  const int32_t ww = (excluded || ov[from] != 0) ? kInf : w;
  return min(drow[from] + ww, kInf);
}

template <typename Ov, bool kVec8>
__global__ void __launch_bounds__(kThreads)
masked_relax_narrow(const int32_t* __restrict__ d, int n_pad,
                    const int32_t* __restrict__ src,
                    const int32_t* __restrict__ w,
                    const uint8_t* __restrict__ mask, int rows, int k,
                    const Ov* __restrict__ ov, int pos,
                    int32_t* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int s = blockIdx.y;
  if (j >= rows) return;
  const int32_t* drow = d + (size_t)s * n_pad;
  const int32_t* srow = src + (size_t)j * k;
  const int32_t* wrow = w + (size_t)j * k;
  const uint8_t* mrow = mask + ((size_t)s * rows + j) * k;
  int32_t best = kInf;
  if (kVec8) {
    for (int base = 0; base < k; base += 8) {
      const uint2 m8 = *reinterpret_cast<const uint2*>(mrow + base);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const uint32_t word = t < 4 ? m8.x : m8.y;
        const bool excluded = ((word >> (8 * (t & 3))) & 0xffu) != 0;
        best = min(best, relax_slot(drow, ov, srow[base + t], wrow[base + t],
                                    excluded));
      }
    }
  } else {
    for (int slot = 0; slot < k; ++slot) {
      best = min(best,
                 relax_slot(drow, ov, srow[slot], wrow[slot], mrow[slot] != 0));
    }
  }
  out[(size_t)s * n_pad + pos + j] = min(best, drow[pos + j]);
}

template <typename Ov>
__global__ void __launch_bounds__(kWarps * 32)
masked_relax_wide(const int32_t* __restrict__ d, int n_pad,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ w,
                  const uint8_t* __restrict__ mask, int rows, int k,
                  const Ov* __restrict__ ov, int pos,
                  int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int s = blockIdx.y;
  if (j >= rows) return;  // the whole warp shares j: it leaves together
  const int32_t* drow = d + (size_t)s * n_pad;
  const int32_t* srow = src + (size_t)j * k;
  const int32_t* wrow = w + (size_t)j * k;
  const uint8_t* mrow = mask + ((size_t)s * rows + j) * k;
  int32_t best = kInf;
  for (int slot = lane; slot < k; slot += 32) {
    best = min(best,
               relax_slot(drow, ov, srow[slot], wrow[slot], mrow[slot] != 0));
  }
  best = __reduce_min_sync(0xffffffffu, best);
  if (lane == 0) {
    out[(size_t)s * n_pad + pos + j] = min(best, drow[pos + j]);
  }
}

template <typename Ov>
cudaError_t launch(const int32_t* d, int S, int n_pad, const int32_t* src,
                   const int32_t* w, const uint8_t* mask, int rows, int k,
                   const Ov* ov, int pos, int32_t* out, cudaStream_t st) {
  if (k >= kWideK) {
    const dim3 grid((rows + kWarps - 1) / kWarps, S);
    masked_relax_wide<Ov><<<grid, kWarps * 32, 0, st>>>(
        d, n_pad, src, w, mask, rows, k, ov, pos, out);
  } else {
    const dim3 grid((rows + kThreads - 1) / kThreads, S);
    const bool vec8 =
        k % 8 == 0 && reinterpret_cast<uintptr_t>(mask) % 8 == 0;
    if (vec8) {
      masked_relax_narrow<Ov, true><<<grid, kThreads, 0, st>>>(
          d, n_pad, src, w, mask, rows, k, ov, pos, out);
    } else {
      masked_relax_narrow<Ov, false><<<grid, kThreads, 0, st>>>(
          d, n_pad, src, w, mask, rows, k, ov, pos, out);
    }
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int openr_ell_band_relax_masked(const void* d, int S, int n_pad,
                                           const void* src, const void* w,
                                           const void* mask, int rows, int k,
                                           const void* overloaded,
                                           int ov_is_int32, int pos, void* out,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* d_ = static_cast<const int32_t*>(d);
  const int32_t* src_ = static_cast<const int32_t*>(src);
  const int32_t* w_ = static_cast<const int32_t*>(w);
  const uint8_t* m_ = static_cast<const uint8_t*>(mask);
  int32_t* out_ = static_cast<int32_t*>(out);
  cudaError_t rc;
  if (ov_is_int32) {
    rc = launch(d_, S, n_pad, src_, w_, m_, rows, k,
                static_cast<const int32_t*>(overloaded), pos, out_, st);
  } else {
    rc = launch(d_, S, n_pad, src_, w_, m_, rows, k,
                static_cast<const uint8_t*>(overloaded), pos, out_, st);
  }
  return static_cast<int>(rc);
}
