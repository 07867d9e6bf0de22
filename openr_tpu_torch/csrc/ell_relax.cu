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
// and the launch itself is of the same order.
//
// Design: one thread per (s, j) band row: blockIdx.y = s, threads over j.
// Each thread loops over its row's k slots, gathers d[s, src], applies the
// overload mask and the INF clamp, and writes straight into column pos + j of
// an output shaped like d. Every band of the port's _ell_relax writes its own
// column slice of one [S, n_pad] output, which replaces the JAX concatenate of
// band parts. The gathered distance row of one batch row is n_pad int32 (40 KB at 10 k nodes) and stays in L1/L2, so the
// gathers are cache hits. No overflow: d, w <= INF, so d + w <= 2^31 - 2.
// Known weak spot, left for a later version: the single 16-row, k = 1024 band
// of a 10 k fat-tree (its spine switches) gives 16 threads a batch row that
// each loop 1024 times while the rest of the card idles; a warp-per-row
// reduction over the slots would spread it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = (1 << 30) - 1;
constexpr int kThreads = 128;

template <typename Ov>
__global__ void __launch_bounds__(kThreads)
ell_band_relax_kernel(const int32_t* __restrict__ d, int n_pad,
                      const int32_t* __restrict__ src,
                      const int32_t* __restrict__ w, int rows, int k,
                      const Ov* __restrict__ overloaded, int pos,
                      int32_t* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int s = blockIdx.y;
  if (j >= rows) return;
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

}  // namespace

extern "C" int openr_ell_band_relax(const void* d, int S, int n_pad,
                                    const void* src, const void* w, int rows,
                                    int k, const void* overloaded,
                                    int ov_is_int32, int pos, void* out,
                                    void* stream) {
  const dim3 grid((rows + kThreads - 1) / kThreads, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* d_ = static_cast<const int32_t*>(d);
  const int32_t* src_ = static_cast<const int32_t*>(src);
  const int32_t* w_ = static_cast<const int32_t*>(w);
  int32_t* out_ = static_cast<int32_t*>(out);
  if (ov_is_int32) {
    ell_band_relax_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        d_, n_pad, src_, w_, rows, k,
        static_cast<const int32_t*>(overloaded), pos, out_);
  } else {
    ell_band_relax_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        d_, n_pad, src_, w_, rows, k,
        static_cast<const uint8_t*>(overloaded), pos, out_);
  }
  return static_cast<int>(cudaGetLastError());
}
