// One band of the reversed-graph (destination-major) relaxation on an H100.
//
//   out[b, pos + j] = min(dr[b, pos + j],
//                         min_slot min(dr[b, v[j, slot]] + w_eff, INF))
//   w_eff = INF where overloaded[v[j, slot]] and v[j, slot] != t_ids[b],
//           else w[j, slot]
//
// int32, INF = 2^30 - 1. Row b of dr is destination t_ids[b]: dr[b, s] is
// the distance s -> t. Band row j is node pos + j with its out-edges
// (v, w(j -> v)); an edge may extend a v ~> t path unless v is an
// overloaded transit node (v != t). Replaces:
// openr_tpu/ops/pallas_ell.py::rev_band_relax (_rev_relax_kernel), the band
// body of openr_tpu/ops/route_sweep.py::_rev_relax, the relaxation step of
// the all-sources route sweep.
//
// What bounds it: bytes. One step over a 1024-destination block at 10 000
// nodes reads the [1024, 10112] distance block (41 MB) and writes the band
// columns (41 MB); the band slots (v, w: 0.9 MB) and the overload mask are
// small. There is one add-min per gathered distance, far below the card's
// integer rate.
//
// Design, two shapes, each block walking a run of `chunk` destination rows
// (the launch plan, ops/rev_relax.py::launch_plan, picks the run so the
// grid still fills the card; grid = (band-row tiles, destination runs)):
// - narrow bands (k <= 32): one thread per band row j, kThreads rows a
//   block. The thread loads its row's k slots ONCE into registers (slot
//   count rounded up to KMAX = 8, 16 or 32), with the overload bit of
//   each slot's node folded into the sign of the staged id, then walks the
//   run: per destination b one broadcast t_ids[b], one coalesced dr[b,
//   pos + j], k gathers dr[b, v] through the read-only path (a fat tree's
//   band rows are pod-local: a tile's gathers hit a few L1 lines), and one
//   coalesced store. So the slot traffic, which a block per destination
//   reloaded B times from L2 (strided by k ints a lane), falls by the run
//   length; the v == t exception depends on b and stays in the loop.
// - wide bands (k >= kWideK = 33, e.g. the 16 spine rows with k = 1024 of
//   a 10 000-node fat-tree, and the 1008-node one's with k = 64): one warp
//   per (b, j); lane l takes slots l, l+32, ..., so the v/w slot loads of a
//   warp are 128 contiguous bytes, and a warp min-reduction
//   (__reduce_min_sync) joins the lanes. Its plan keeps runs of one
//   destination (longer runs measured slower: fewer warps in flight).
//   kWideK = 33 because 64 slots staged a thread spill (872 bytes of
//   stack in ptxas's report).
// Either shape writes straight into column pos + j of an output shaped like
// dr: every band of the port's _rev_relax writes its own column slice of
// one [B, n_pad] output, which replaces the JAX concatenate of band parts.
// No overflow: dr, w <= INF, so dr + w <= 2^31 - 2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = (1 << 30) - 1;
constexpr int kThreads = 128;  // narrow: band rows per block
constexpr int kWarps = 8;      // wide: band rows (one per warp) per block
constexpr int kWideK = 33;
// set in a staged slot id whose node is overloaded (ids are < 2^31)
constexpr int32_t kOvBit = INT32_MIN;

__device__ __forceinline__ int32_t add_min(int32_t x, int32_t y, int32_t acc) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900)
  return __viaddmin_s32(x, y, acc);
#else
  return min(x + y, acc);
#endif
}

template <int KMAX, typename Ov>
__global__ void __launch_bounds__(kThreads)
rev_band_relax_narrow(const int32_t* __restrict__ dr, int B, int n_pad,
                      const int32_t* __restrict__ v,
                      const int32_t* __restrict__ w, int rows, int k,
                      const int32_t* __restrict__ t_ids,
                      const Ov* __restrict__ ov, int pos, int chunk,
                      int32_t* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= rows) return;
  const int32_t* vrow = v + (size_t)j * k;
  const int32_t* wrow = w + (size_t)j * k;
  int32_t sv[KMAX], sw[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    sv[s] = 0;
    sw[s] = kInf;
    if (s < k) {
      const int32_t to = __ldg(vrow + s);
      sv[s] = __ldg(ov + to) != 0 ? (to | kOvBit) : to;
      sw[s] = __ldg(wrow + s);
    }
  }
  const int b0 = blockIdx.y * chunk;
  const int b1 = min(B, b0 + chunk);
#pragma unroll 2
  for (int b = b0; b < b1; ++b) {
    const int32_t t = __ldg(t_ids + b);
    const int32_t* drow = dr + (size_t)b * n_pad;
    int32_t best = __ldg(drow + pos + j);
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s < k) {
        const int32_t to = sv[s] & ~kOvBit;
        const int32_t ww = (sv[s] < 0 && to != t) ? kInf : sw[s];
        best = add_min(__ldg(drow + to), ww, best);
      }
    }
    out[(size_t)b * n_pad + pos + j] = min(best, kInf);
  }
}

template <typename Ov>
__device__ __forceinline__ int32_t relax_slot(const int32_t* __restrict__ drow,
                                              const Ov* __restrict__ ov,
                                              int32_t to, int32_t w,
                                              int32_t t) {
  const int32_t ww = (ov[to] != 0 && to != t) ? kInf : w;
  return min(drow[to] + ww, kInf);
}

template <typename Ov>
__global__ void __launch_bounds__(kWarps * 32)
rev_band_relax_wide(const int32_t* __restrict__ dr, int B, int n_pad,
                    const int32_t* __restrict__ v,
                    const int32_t* __restrict__ w, int rows, int k,
                    const int32_t* __restrict__ t_ids,
                    const Ov* __restrict__ ov, int pos, int chunk,
                    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= rows) return;  // the whole warp shares j: it leaves together
  const int32_t* vrow = v + (size_t)j * k;
  const int32_t* wrow = w + (size_t)j * k;
  const int b0 = blockIdx.y * chunk;
  const int b1 = min(B, b0 + chunk);
  for (int b = b0; b < b1; ++b) {
    const int32_t* drow = dr + (size_t)b * n_pad;
    const int32_t t = t_ids[b];
    int32_t best = kInf;
    for (int slot = lane; slot < k; slot += 32) {
      best = min(best, relax_slot(drow, ov, vrow[slot], wrow[slot], t));
    }
    best = __reduce_min_sync(0xffffffffu, best);
    if (lane == 0) {
      out[(size_t)b * n_pad + pos + j] = min(best, drow[pos + j]);
    }
  }
}

template <typename Ov>
cudaError_t launch(const int32_t* dr, int B, int n_pad, const int32_t* v,
                   const int32_t* w, int rows, int k, const int32_t* t_ids,
                   const Ov* ov, int pos, int chunk, int32_t* out,
                   cudaStream_t st) {
  if (chunk < 1) return cudaErrorInvalidValue;
  const unsigned runs = (unsigned)((B + chunk - 1) / chunk);
  if (k >= kWideK) {
    const dim3 grid((rows + kWarps - 1) / kWarps, runs);
    rev_band_relax_wide<Ov><<<grid, kWarps * 32, 0, st>>>(
        dr, B, n_pad, v, w, rows, k, t_ids, ov, pos, chunk, out);
    return cudaGetLastError();
  }
  const dim3 grid((rows + kThreads - 1) / kThreads, runs);
#define OPENR_REV_NARROW(KMAX)                                             \
  rev_band_relax_narrow<KMAX, Ov><<<grid, kThreads, 0, st>>>(              \
      dr, B, n_pad, v, w, rows, k, t_ids, ov, pos, chunk, out)
  if (k <= 8) {
    OPENR_REV_NARROW(8);
  } else if (k <= 16) {
    OPENR_REV_NARROW(16);
  } else {
    OPENR_REV_NARROW(32);
  }
#undef OPENR_REV_NARROW
  return cudaGetLastError();
}

}  // namespace

extern "C" int openr_rev_band_relax(const void* dr, int B, int n_pad,
                                    const void* v, const void* w, int rows,
                                    int k, const void* t_ids,
                                    const void* overloaded, int ov_is_int32,
                                    int pos, int chunk, void* out,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* dr_ = static_cast<const int32_t*>(dr);
  const int32_t* v_ = static_cast<const int32_t*>(v);
  const int32_t* w_ = static_cast<const int32_t*>(w);
  const int32_t* t_ = static_cast<const int32_t*>(t_ids);
  int32_t* out_ = static_cast<int32_t*>(out);
  cudaError_t rc;
  if (ov_is_int32) {
    rc = launch(dr_, B, n_pad, v_, w_, rows, k, t_,
                static_cast<const int32_t*>(overloaded), pos, chunk, out_, st);
  } else {
    rc = launch(dr_, B, n_pad, v_, w_, rows, k, t_,
                static_cast<const uint8_t*>(overloaded), pos, chunk, out_, st);
  }
  return static_cast<int>(rc);
}
