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
// What bounds it: bytes. At the 10 000-node fat-tree's largest segment
// (G = 624, S = 4, R = 12, B = 1024 destinations) one call reads 10 MB of
// gath and writes 31 MB of output against 61 M int32 add-min operations:
// about 12 us of memory traffic against under 1 us of arithmetic. Tensor
// cores have no (min, +) mode, so this is integer work on the CUDA cores.
//
// Design: one thread per output element, in the output's own order, so the
// stores of a warp are contiguous; a grid-stride loop covers any G * B * R.
// Each thread walks all S itself with the running min in a register, so any
// S works: the Pallas kernel's s-chunking by 8 and its revisit grid past
// _S_CAP = 512 have no counterpart (CUDA blocks run unordered, and a whole S
// row in one thread needs no carry between blocks). In the plain layout the
// threads of a warp share a few (g, b) rows of gath (broadcast loads) and
// read neighbouring r of w; in the transposed layout a warp reads 32
// neighbouring b of one gath row (one 128-byte load per s) and broadcasts
// one w element. The update is Hopper's DPX __viaddmin_s32(x, y, acc) =
// min(x + y, acc), one instruction. No overflow: gath, w <= INF, so
// x + y <= 2^31 - 2; INF padding (weights) never wins a min.
// Not done here: staging w or gath tiles in shared memory, or several
// outputs per thread to reuse each gath load across r.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = (1 << 30) - 1;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ int32_t add_min(int32_t x, int32_t y, int32_t acc) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900)
  return __viaddmin_s32(x, y, acc);
#else
  return min(x + y, acc);
#endif
}

// kT = false: gath [G, B, S] -> out [G, B, R]; kT = true: gath [G, S, B]
// -> out [G, R, B]. w is [G, S, R] in both.
template <bool kT>
__global__ void __launch_bounds__(kThreads)
batched_minplus_kernel(const int32_t* __restrict__ gath,
                       const int32_t* __restrict__ w,
                       int32_t* __restrict__ out, int G, int B, int S, int R) {
  const long long total = (long long)G * B * R;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    long long g;
    int b, r;
    if (kT) {
      b = (int)(idx % B);
      r = (int)((idx / B) % R);
      g = idx / ((long long)B * R);
    } else {
      r = (int)(idx % R);
      b = (int)((idx / R) % B);
      g = idx / ((long long)B * R);
    }
    const int32_t* a;
    long long a_step;
    if (kT) {
      a = gath + g * S * B + b;
      a_step = B;
    } else {
      a = gath + (g * B + b) * S;
      a_step = 1;
    }
    const int32_t* wp = w + g * S * R + r;
    int32_t acc = kInf;
    for (int s = 0; s < S; ++s) {
      acc = add_min(a[s * a_step], wp[(long long)s * R], acc);
    }
    out[idx] = min(acc, kInf);
  }
}

template <bool kT>
int launch(const void* gath, const void* w, void* out, int G, int B, int S,
           int R, void* stream) {
  const long long total = (long long)G * B * R;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  batched_minplus_kernel<kT>
      <<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(gath), static_cast<const int32_t*>(w),
          static_cast<int32_t*>(out), G, B, S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int openr_batched_minplus(const void* gath, const void* w,
                                     void* out, int G, int B, int S, int R,
                                     void* stream) {
  return launch<false>(gath, w, out, G, B, S, R, stream);
}

extern "C" int openr_batched_minplus_t(const void* gath_t, const void* w,
                                       void* out, int G, int B, int S, int R,
                                       void* stream) {
  return launch<true>(gath_t, w, out, G, B, S, R, stream);
}
