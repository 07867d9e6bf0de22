// One band of the per-batch-masked sliced-ELL relaxation on an H100: the
// KSP2 second-path solve, one masked graph per batch row.
//
//   out[s, pos + j] = min(d[s, pos + j],
//                         min_slot min(d[s, src[j, slot]] + w_eff, INF))
//   w_eff = INF where bit (j, slot) of row s of the mask is set or
//           overloaded[src[j, slot]], else w[j, slot]
//
// int32, INF = 2^30 - 1. Row s of d is the distance row of one masked graph
// (one KSP2 destination's "graph minus its first-path links"). The mask is
// bit-packed: int32 words [S, ceil(rows * k / 32)], and the bit of (j, slot)
// in row s is bit (j * k + slot) & 31 of word (j * k + slot) >> 5
// (ops/ell_relax.py::pack_edge_mask). Replaces:
// openr_tpu/ops/pallas_ell.py::ell_band_relax_masked (_masked_relax_kernel),
// the band body of openr_tpu/ops/spf_sparse.py::_ell_relax_masked.
//
// What bounds it: bytes. One step at 1008 nodes (S = 1024 destinations,
// 10 944 slots) reads the 4.2 MB distance block, writes the same again and
// reads a 1.4 MB packed mask (a byte mask was 11.2 MB); at 10 000 nodes
// (S = 256, 116 224 slots) the packed mask is 3.7 MB (byte mask 29.8 MB).
// There is one add-min per slot and batch row, far below the card's integer
// rate. The band's slots (src, w: 8 bytes a slot) are the same for every
// batch row: a thread per (s, j) re-read them, with the overload gather,
// for each of the S rows (90 MB of L2 traffic a step at 1008 nodes).
// Measured on an H100 (PERF.md), the step is 7x its bytes bound at 1008
// nodes and 6x at 10 000: what holds it is the latency of the gathers
// d[s, src], one a live slot and batch row, not the mask.
//
// Design: the slots are loaded once and reused across a run of batch rows
// (the launch plan, ops/ell_relax.py::masked_plan, picks the body, KMAX,
// the group G, the run length and the threads a row; grid = (band-row
// tiles, runs), runs walked with a stride of gridDim.y so any S runs):
// - narrow bands (k <= 32; the rack and fabric bands): one thread per band
//   row j, kThreads rows a block, as rev_relax.cu. The thread loads its k
//   slots ONCE into registers (KMAX = 8, 16 or 32), then walks its run of
//   batch rows G at a time (the G rows' mask words, own distances and
//   gathers all issued before their add-mins): per row the one word (two
//   where the row's bits straddle a word) holding its k bits, the gathers
//   d[s, src] and one coalesced store. A warp's bits are 32 * k
//   consecutive bits of a row.
// - wide bands (k >= 33; the 16 spine rows of a fat-tree, k = 64 at 1008
//   nodes and 1024 at 10 000): a row gets 32 to 256 threads of a
//   kWideThreads block, as ell_relax.cu's wide body, lane l taking slots
//   l, l + threads, .... Each thread loads a slot (id, weight, overload
//   bit) once a run and keeps one running min for each batch row of the
//   run (RUN <= 8 in registers): per slot, RUN gathers in flight.
//   __reduce_min_sync joins a warp's lanes and shared memory the warps of
//   a row. (Staging the slots in shared memory, a piece at a time,
//   measured slower on an H100 at both spine bands.)
// A slot that can never lower a row (its node overloaded, or an INF weight:
// the self-loop padding of a short row, half of a fat-tree rack row's
// slots) is inert and skipped: no gather and no mask bit for it. The
// narrow body marks it in the sign of its staged id.
// The overload mask differs per launch (the init relax passes zeros), so
// the inert marks are made in each launch. Either body writes straight
// into column pos + j of an output shaped like d, so every band of the
// port's _ell_relax_masked writes its column slice of one output. No
// overflow:
// d, w <= INF, so d + w <= 2^31 - 2; a masked or overloaded slot adds INF
// to d and loses to the row's own d[s, pos + j] <= INF.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = (1 << 30) - 1;
constexpr int kThreads = 128;      // narrow: band rows a block
constexpr int kWideThreads = 256;  // wide: threads a block, 1 to 8 rows
constexpr int kWideRun = 8;        // wide: most batch rows a block walks
// set in a staged slot id that can never lower a row: its node is
// overloaded or its weight is INF (ids are < 2^31)
constexpr int32_t kInertBit = INT32_MIN;

__device__ __forceinline__ int32_t add_min(int32_t x, int32_t y, int32_t acc) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900)
  return __viaddmin_s32(x, y, acc);
#else
  return min(x + y, acc);
#endif
}

// Batch rows are taken G at a time: the G rows' mask words, own distances
// and G * k gathers are all issued before their add-mins.
template <int KMAX, int G, typename Ov>
__global__ void __launch_bounds__(kThreads)
masked_relax_narrow(const int32_t* __restrict__ d, int S, int n_pad,
                    const int32_t* __restrict__ src,
                    const int32_t* __restrict__ w,
                    const uint32_t* __restrict__ mask, int words, int rows,
                    int k, const Ov* __restrict__ ov, int pos, int chunk,
                    int32_t* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= rows) return;
  const int32_t* srow = src + (size_t)j * k;
  const int32_t* wrow = w + (size_t)j * k;
  int32_t sv[KMAX], sw[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    sv[t] = kInertBit;
    sw[t] = kInf;
    if (t < k) {
      const int32_t from = __ldg(srow + t);
      sw[t] = __ldg(wrow + t);
      sv[t] = (__ldg(ov + from) != 0 || sw[t] >= kInf) ? (from | kInertBit) : from;
    }
  }
  const size_t bit0 = (size_t)j * k;
  const size_t word0 = bit0 >> 5;
  const int off = (int)(bit0 & 31);
  const bool two = off + k > 32;  // the row's bits straddle two words
  for (int s0 = blockIdx.y * chunk; s0 < S; s0 += gridDim.y * chunk) {
    const int s1 = min(S, s0 + chunk);
    for (int sg = s0; sg < s1; sg += G) {
      uint64_t bits[G];
      int32_t best[G];
      int32_t x[G][KMAX];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const size_t s = (size_t)min(sg + g, s1 - 1);  // past s1: row s1 - 1
        const uint32_t* mrow = mask + s * words + word0;
        bits[g] = 0;
        if (k > 0) {
          bits[g] = __ldg(mrow);
          if (two) bits[g] |= (uint64_t)__ldg(mrow + 1) << 32;
        }
        best[g] = __ldg(d + s * n_pad + pos + j);
#pragma unroll
        for (int t = 0; t < KMAX; ++t) {
          if (sv[t] >= 0) x[g][t] = __ldg(d + s * n_pad + sv[t]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint64_t b = bits[g] >> off;
#pragma unroll
        for (int t = 0; t < KMAX; ++t) {
          if (sv[t] >= 0) {
            const int32_t ww = ((b >> t) & 1u) != 0 ? kInf : sw[t];
            best[g] = add_min(x[g][t], ww, best[g]);
          }
        }
        if (sg + g < s1) out[(size_t)(sg + g) * n_pad + pos + j] = best[g];
      }
    }
  }
}

// A row of 2^shift (32..256) threads; kWideThreads >> shift rows a block;
// runs of `chunk` <= RUN batch rows. A thread loads each of its slots
// once a run and uses it for every batch row of the run.
template <int RUN, typename Ov>
__global__ void __launch_bounds__(kWideThreads)
masked_relax_wide(const int32_t* __restrict__ d, int S, int n_pad,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ w,
                  const uint32_t* __restrict__ mask, int words, int rows,
                  int k, const Ov* __restrict__ ov, int pos, int shift,
                  int chunk, int32_t* __restrict__ out) {
  __shared__ int32_t part[kWideThreads / 32][RUN];
  const int step = 1 << shift;
  const int per = kWideThreads >> shift;  // rows a block
  const int lane = threadIdx.x & (step - 1);
  const int j = blockIdx.x * per + (threadIdx.x >> shift);
  const bool live = j < rows;
  const int warp = threadIdx.x >> 5;
  const size_t bit0 = (size_t)j * k;
  for (int s0 = blockIdx.y * chunk; s0 < S; s0 += gridDim.y * chunk) {
    const int run = min(chunk, S - s0);
    int32_t acc[RUN];
#pragma unroll
    for (int r = 0; r < RUN; ++r) acc[r] = kInf;
    if (live) {
#pragma unroll 2
      for (int i = lane; i < k; i += step) {
        const int32_t from = __ldg(src + bit0 + i);
        const int32_t w0 = __ldg(w + bit0 + i);
        if (w0 >= kInf || __ldg(ov + from) != 0) continue;  // inert
        const uint32_t* mcol = mask + ((bit0 + i) >> 5);
        const int b = (int)((bit0 + i) & 31);
#pragma unroll
        for (int r = 0; r < RUN; ++r) {
          if (r < run) {
            const size_t s = (size_t)(s0 + r);
            const uint32_t word = __ldg(mcol + s * words);
            const int32_t ww = ((word >> b) & 1u) != 0 ? kInf : w0;
            acc[r] = add_min(__ldg(d + s * n_pad + from), ww, acc[r]);
          }
        }
      }
    }
    // a warp lies inside one row (step >= 32): join its lanes, then the
    // row's warps through shared memory
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      acc[r] = __reduce_min_sync(0xffffffffu, acc[r]);
    }
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int r = 0; r < RUN; ++r) part[warp][r] = acc[r];
    }
    __syncthreads();
    if (live && lane < run) {  // lane < 8: in the row's first warp
      int32_t m = kInf;
      for (int i = 0; i < (step >> 5); ++i) m = min(m, part[warp + i][lane]);
      const size_t at = (size_t)(s0 + lane) * n_pad + pos + j;
      out[at] = min(m, __ldg(d + at));
    }
    __syncthreads();  // part is read before the next run writes it
  }
}

template <typename Ov>
cudaError_t launch(const int32_t* d, int S, int n_pad, const int32_t* src,
                   const int32_t* w, const uint32_t* mask, int rows, int k,
                   const Ov* ov, int pos, int kmax, int group, int row_threads,
                   int chunk, int32_t* out, cudaStream_t st) {
  const int words = (int)(((long long)rows * k + 31) / 32);
  const long long runs = (S + (long long)chunk - 1) / chunk;
  const unsigned gy = (unsigned)(runs < 65535 ? runs : 65535);
  if (row_threads == 1) {
    if (k > kmax) return cudaErrorInvalidValue;
    const dim3 grid((rows + kThreads - 1) / kThreads, gy);
#define OPENR_MASKED_NARROW(KMAX, G)                                       \
  masked_relax_narrow<KMAX, G, Ov><<<grid, kThreads, 0, st>>>(             \
      d, S, n_pad, src, w, mask, words, rows, k, ov, pos, chunk, out)
    if (kmax == 8 && group == 4) {
      OPENR_MASKED_NARROW(8, 4);
    } else if (kmax == 16 && group == 4) {
      OPENR_MASKED_NARROW(16, 4);
    } else if (kmax == 32 && group == 2) {
      OPENR_MASKED_NARROW(32, 2);
    } else {
      return cudaErrorInvalidValue;
    }
#undef OPENR_MASKED_NARROW
    return cudaGetLastError();
  }
  int shift = 5;
  while ((1 << shift) < row_threads) ++shift;
  if ((1 << shift) != row_threads || row_threads > kWideThreads ||
      chunk > kWideRun) {
    return cudaErrorInvalidValue;
  }
  const int per = kWideThreads >> shift;
  const dim3 grid((rows + per - 1) / per, gy);
#define OPENR_MASKED_WIDE(RUN)                                             \
  masked_relax_wide<RUN, Ov><<<grid, kWideThreads, 0, st>>>(               \
      d, S, n_pad, src, w, mask, words, rows, k, ov, pos, shift, chunk, out)
  if (chunk == 1) {
    OPENR_MASKED_WIDE(1);
  } else if (chunk == 2) {
    OPENR_MASKED_WIDE(2);
  } else if (chunk <= 4) {
    OPENR_MASKED_WIDE(4);
  } else {
    OPENR_MASKED_WIDE(8);
  }
#undef OPENR_MASKED_WIDE
  return cudaGetLastError();
}

}  // namespace

// row_threads: 1 for the narrow body (kmax slots staged a thread: 8, 16 or
// 32; batch rows taken `group` at a time: 4, or 2 for kmax 32), else the
// threads of a wide row (32, 64, 128 or 256); chunk: batch rows a block
// walks (at most 8 for the wide body), as the launch plan says. mask:
// int32 words [S, ceil(rows * k / 32)].
extern "C" int openr_ell_band_relax_masked(
    const void* d, int S, int n_pad, const void* src, const void* w,
    const void* mask, int rows, int k, const void* overloaded, int ov_is_int32,
    int pos, int kmax, int group, int row_threads, int chunk, void* out,
    void* stream) {
  if (S < 1 || rows < 1 || k < 0 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* d_ = static_cast<const int32_t*>(d);
  const int32_t* src_ = static_cast<const int32_t*>(src);
  const int32_t* w_ = static_cast<const int32_t*>(w);
  const uint32_t* m_ = static_cast<const uint32_t*>(mask);
  int32_t* out_ = static_cast<int32_t*>(out);
  cudaError_t rc;
  if (ov_is_int32) {
    rc = launch(d_, S, n_pad, src_, w_, m_, rows, k,
                static_cast<const int32_t*>(overloaded), pos, kmax, group,
                row_threads, chunk, out_, st);
  } else {
    rc = launch(d_, S, n_pad, src_, w_, m_, rows, k,
                static_cast<const uint8_t*>(overloaded), pos, kmax, group,
                row_threads, chunk, out_, st);
  }
  return static_cast<int>(rc);
}

