// The tenant plane's relax step on an H100: B worlds, each one uniform
// sliced-ELL block covering all its rows, relaxed over its own distance rows.
//
//   out[b, s, j] = min(d[b, s, j], min_{slot < live[b, j]}
//                      min(d[b, s, src[b, j, slot]] + w_eff, INF))
//   w_eff = INF where overloaded[b, src[b, j, slot]], else w[b, j, slot]
//
// int32, INF = 2^30 - 1; d [B, S, n], src / w [B, n, k], overloaded [B, n]
// (bytes, 0 or not), live [B, n]. Replaces:
// openr_tpu/ops/pallas_ell.py::ell_band_relax batched over a tenant axis by
// pallas_call's vmap rule (the reference's spf_sparse._uniform_relax under
// vmap), the relaxation step of every tenant-plane view solve.
//
// live[b, j] is one past the last slot of row j whose w < INF
// (ell_live_slot_counts below). A slot at or past it has w = INF and can
// never lower a distance: 0 <= d <= INF, so d + INF >= INF >= d[b, s, j].
// Stopping there is exact for any block, INF holes inside a row's prefix
// included (they are skipped one by one, for the same reason).
//
// What bounds it: bytes. The uniform blocks are mostly padding (83 % of the
// slot bytes of 64 worlds of a 1008-node fat tree at k = 64, 99 % of 4
// worlds of a 10 000-node one at [16384, 1024]), so a kernel that reads
// only live slots moves the distance rows (in and out) and little else:
// about 32 MB a step at [64, 64, 1024], 2 MB at [4, 8, 16384]. There is one
// add-min per live slot and batch row, far below the card's integer rate.
// The gathers d[b, s, src] are the latency to hide: from L2 they are 32-byte
// sectors for 4 bytes each.
//
// Design (the launch plan, ops/ell_relax.py::worlds_plan, is a function of
// the shapes alone, so a captured CUDA graph replays the same launch):
// - grid = (row tiles, runs of batch rows, worlds); a block of kThreads
//   threads relaxes rows [j0, j0 + tile_rows) of world b for the batch rows
//   [s0, s0 + run).
// - the run's distance rows d[b, s0:s0 + run, :] (the slab: 16 rows of 4 KB
//   at n = 1024, 3 rows of 64 KB at n = 16384) are copied into shared memory
//   by one cp.async.bulk per 32 KB, with the world's overload bits (one byte
//   a node), completing on an mbarrier while the threads list the tile's
//   wide rows; every gather then reads shared memory. Where a slab
//   row does not fit (n above about 50 000) the plan gathers from device
//   memory (kSlab false).
// - a row with at most kWideLive live slots (a fat tree's rack and fabric
//   rows) is one thread's: it reads the row's live slots once, 16 bytes at
//   a time, folds the overload bit into each weight and relaxes all the
//   run's batch rows with it (RUN running minima in registers), then writes
//   the run's outputs of the row, coalesced along j. A row with more live
//   slots (the spine rows: 64 at 1008 nodes, 1024 at 10 000) goes to a list
//   in shared memory that the block's warps share, one row a warp: the
//   lanes take slots lane, lane + 32, ..., and __reduce_min_sync joins them
//   for each batch row. Rows with few slots, or none, never wait on them;
//   an all-padding row (live 0) copies d.
// Per-world strides are size_t (B * S * n outgrows an int). No overflow:
// d, w <= INF, so d + w <= 2^31 - 2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = (1 << 30) - 1;
constexpr int kThreads = 512;       // relax: threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kWideLive = 32;       // more live slots: a warp's row
constexpr int kLiveThreads = 256;   // live pass: a warp a row
constexpr unsigned kBulkChunk = 32768;
// dynamic shared memory a relax block may take (of the 227 KB a block can
// have, beside its static barrier and counter)
constexpr size_t kSmemMax = 227 * 1024 - 1024;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ constexpr size_t smem_bytes(bool slab, int run, int n,
                                                int tile_rows) {
  return (slab ? align16(static_cast<size_t>(run) * n * 4) + align16(n) : 0) +
         static_cast<size_t>(tile_rows) * 4;
}

__device__ __forceinline__ int32_t add_min(int32_t x, int32_t y, int32_t acc) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900)
  return __viaddmin_s32(x, y, acc);
#else
  return min(x + y, acc);
#endif
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes (a multiple of 16, both ends on 16 bytes) from device memory into
// shared memory, in kBulkChunk pieces completing on `bar`
__device__ __forceinline__ void bulk_to_smem(void* dst, const void* src, unsigned bytes,
                                             uint64_t* bar) {
  for (unsigned off = 0; off < bytes; off += kBulkChunk) {
    const unsigned len = min(kBulkChunk, bytes - off);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(static_cast<unsigned char*>(dst) + off)),
        "l"(static_cast<const unsigned char*>(src) + off), "r"(len), "r"(smem_u32(bar))
        : "memory");
  }
}

template <bool kSlab>
__device__ __forceinline__ int32_t gather(const int32_t* p) {
  if constexpr (kSlab) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// One warp a row of w [rows, k]: each lane keeps one past its last slot with
// w < INF (16-byte loads where the rows allow), a max-reduction joins them.
__global__ void __launch_bounds__(kLiveThreads)
ell_live_slot_counts(const int32_t* __restrict__ w, int rows, int k,
                     int32_t* __restrict__ live) {
  const int row = blockIdx.x * (kLiveThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int32_t* wr = w + static_cast<size_t>(row) * k;
  int last = 0;
  if ((k & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    const int4* w4 = reinterpret_cast<const int4*>(wr);
#pragma unroll 4
    for (int q = lane; q < (k >> 2); q += 32) {
      const int4 v = __ldg(w4 + q);
      if (v.x < kInf) last = 4 * q + 1;
      if (v.y < kInf) last = 4 * q + 2;
      if (v.z < kInf) last = 4 * q + 3;
      if (v.w < kInf) last = 4 * q + 4;
    }
  } else {
#pragma unroll 4
    for (int slot = lane; slot < k; slot += 32) {
      if (__ldg(wr + slot) < kInf) last = slot + 1;
    }
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) live[row] = last;
}

template <int RUN, bool kSlab>
__global__ void __launch_bounds__(kThreads)
ell_band_relax_worlds_rows(const int32_t* __restrict__ d, int S, int n,
                           const int32_t* __restrict__ src,
                           const int32_t* __restrict__ w, int k,
                           const uint8_t* __restrict__ overloaded,
                           const int32_t* __restrict__ live, int run,
                           int tile_rows, int32_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int n_wide;

  const size_t b = blockIdx.z;
  const int s0 = blockIdx.y * run;
  const int rr = min(run, S - s0);  // batch rows of this run (<= RUN)
  const int j0 = blockIdx.x * tile_rows;
  const int j1 = min(n, j0 + tile_rows);
  const size_t at = (b * S + s0) * static_cast<size_t>(n);
  const int32_t* dg = d + at;
  int32_t* og = out + at;
  const size_t sw = b * static_cast<size_t>(n) * k;
  src += sw;
  w += sw;
  overloaded += b * n;
  live += b * n;

  int32_t* slab = reinterpret_cast<int32_t*>(smem);
  const size_t slab_bytes = kSlab ? align16(static_cast<size_t>(run) * n * 4) : 0;
  uint8_t* ov_s = smem + slab_bytes;
  int32_t* wide = reinterpret_cast<int32_t*>(smem + slab_bytes + (kSlab ? align16(n) : 0));
  const int32_t* dist = kSlab ? slab : dg;  // the run's rows, [rr, n]

  // the slab by bulk copies where its rows lie on 16 bytes (n % 4 == 0 and
  // an aligned d), else by the threads; the overload bits the same way
  // where they lie on 16 bytes, else by the threads
  const bool bulk = kSlab && (n & 3) == 0 && (reinterpret_cast<uintptr_t>(d) & 15) == 0;
  const bool ov_bulk = bulk && (n & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(overloaded) & 15) == 0;
  const unsigned bytes = static_cast<unsigned>(rr) * n * 4;
  if (threadIdx.x == 0) {
    n_wide = 0;
    if (bulk) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bar))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  if (bulk && threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_u32(&bar)),
                 "r"(bytes + (ov_bulk ? n : 0))
                 : "memory");
    bulk_to_smem(slab, dg, bytes, &bar);
    if (ov_bulk) bulk_to_smem(ov_s, overloaded, n, &bar);
  }
  if (kSlab && !bulk) {
    for (int i = threadIdx.x; i < rr * n; i += kThreads) slab[i] = __ldg(dg + i);
  }
  if (kSlab && !ov_bulk) {
    for (int i = threadIdx.x; i < n; i += kThreads) ov_s[i] = overloaded[i];
  }
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
    if (__ldg(live + j) > kWideLive) wide[atomicAdd(&n_wide, 1)] = j;
  }
  __syncthreads();
  if (bulk) {
    const uint32_t a = smem_u32(&bar);
    const uint32_t parity = 0;  // the barrier's first phase
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
    }
  }

  auto inert = [&](int32_t from) -> bool {
    if constexpr (kSlab) {
      return ov_s[from] != 0;
    } else {
      return __ldg(overloaded + from) != 0;
    }
  };

  // narrow rows: a thread a row, its live slots read once for the run
  const bool vec = (k & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
    const int lv = __ldg(live + j);
    if (lv > kWideLive) continue;
    int32_t best[RUN];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      if (r < rr) best[r] = gather<kSlab>(dist + static_cast<size_t>(r) * n + j);
    }
    const int32_t* srow = src + static_cast<size_t>(j) * k;
    const int32_t* wrow = w + static_cast<size_t>(j) * k;
    for (int base = 0; base < lv; base += 4) {
      int32_t f[4], c[4];
      if (vec) {  // base + 3 < k: k % 4 == 0 and base < lv <= k
        const int4 s4 = __ldg(reinterpret_cast<const int4*>(srow + base));
        const int4 w4 = __ldg(reinterpret_cast<const int4*>(wrow + base));
        f[0] = s4.x; f[1] = s4.y; f[2] = s4.z; f[3] = s4.w;
        c[0] = w4.x; c[1] = w4.y; c[2] = w4.z; c[3] = w4.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = base + u < lv;
          f[u] = in ? __ldg(srow + base + u) : 0;
          c[u] = in ? __ldg(wrow + base + u) : kInf;
        }
      }
      // an inert slot (past the count, an INF weight, an overloaded
      // source) gathers the row's own distance and adds INF: it changes
      // nothing, and the four gathers of a batch row issue together
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (base + u >= lv || c[u] >= kInf || inert(f[u])) {
          f[u] = j;
          c[u] = kInf;
        }
      }
#pragma unroll
      for (int r = 0; r < RUN; ++r) {
        if (r < rr) {
          const int32_t* row = dist + static_cast<size_t>(r) * n;
          int32_t m = add_min(gather<kSlab>(row + f[0]), c[0], best[r]);
          m = add_min(gather<kSlab>(row + f[1]), c[1], m);
          m = add_min(gather<kSlab>(row + f[2]), c[2], m);
          best[r] = add_min(gather<kSlab>(row + f[3]), c[3], m);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      if (r < rr) og[static_cast<size_t>(r) * n + j] = best[r];
    }
  }

  // wide rows: a warp a row, lanes over its live slots
  const int lane = threadIdx.x & 31;
  const int nw = n_wide;
  for (int i = threadIdx.x >> 5; i < nw; i += kWarps) {
    const int j = wide[i];
    const int lv = __ldg(live + j);
    const int32_t* srow = src + static_cast<size_t>(j) * k;
    const int32_t* wrow = w + static_cast<size_t>(j) * k;
    int32_t acc[RUN];
#pragma unroll
    for (int r = 0; r < RUN; ++r) acc[r] = kInf;
    // four slots a lane at a time, their loads issued together; inert
    // ones as in the narrow rows
    for (int base = lane; base < lv; base += 4 * 32) {
      int32_t f[4], c[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int slot = base + 32 * u;
        f[u] = slot < lv ? __ldg(srow + slot) : j;
        c[u] = slot < lv ? __ldg(wrow + slot) : kInf;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c[u] >= kInf || inert(f[u])) {
          f[u] = j;
          c[u] = kInf;
        }
      }
#pragma unroll
      for (int r = 0; r < RUN; ++r) {
        if (r < rr) {
          const int32_t* row = dist + static_cast<size_t>(r) * n;
          int32_t m = add_min(gather<kSlab>(row + f[0]), c[0], acc[r]);
          m = add_min(gather<kSlab>(row + f[1]), c[1], m);
          m = add_min(gather<kSlab>(row + f[2]), c[2], m);
          acc[r] = add_min(gather<kSlab>(row + f[3]), c[3], m);
        }
      }
    }
    int32_t mine = kInf;
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      if (r < rr) {  // rr is the same for every lane
        const int32_t m = __reduce_min_sync(0xffffffffu, acc[r]);
        if (lane == r) mine = m;
      }
    }
    if (lane < rr) {
      const size_t o = static_cast<size_t>(lane) * n + j;
      og[o] = min(mine, gather<kSlab>(dist + o));
    }
  }
}

template <int RUN, bool kSlab>
cudaError_t launch(const int32_t* d, int B, int S, int n, const int32_t* src,
                   const int32_t* w, int k, const uint8_t* ov, const int32_t* live,
                   int run, int tile_rows, int32_t* out, cudaStream_t st) {
  const size_t smem = smem_bytes(kSlab, run, n, tile_rows);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const dim3 grid((n + tile_rows - 1) / tile_rows, (S + run - 1) / run, B);
  ell_band_relax_worlds_rows<RUN, kSlab><<<grid, kThreads, smem, st>>>(
      d, S, n, src, w, k, ov, live, run, tile_rows, out);
  return cudaGetLastError();
}

template <bool kSlab>
cudaError_t launch_run(const int32_t* d, int B, int S, int n, const int32_t* src,
                       const int32_t* w, int k, const uint8_t* ov, const int32_t* live,
                       int run, int tile_rows, int32_t* out, cudaStream_t st) {
#define OPENR_WORLDS_RUN(R)                                                     \
  if (run <= R)                                                               \
    return launch<R, kSlab>(d, B, S, n, src, w, k, ov, live, run, tile_rows, \
                            out, st);
  OPENR_WORLDS_RUN(1)
  OPENR_WORLDS_RUN(2)
  OPENR_WORLDS_RUN(4)
  OPENR_WORLDS_RUN(8)
  OPENR_WORLDS_RUN(16)
#undef OPENR_WORLDS_RUN
  return cudaErrorInvalidValue;
}

template <bool kSlab>
cudaError_t allow_smem() {
  const int bytes = static_cast<int>(kSmemMax);
  cudaError_t rc = cudaSuccess;
#define OPENR_WORLDS_ALLOW(R)                                                 \
  if (rc == cudaSuccess)                                                    \
    rc = cudaFuncSetAttribute(ell_band_relax_worlds_rows<R, kSlab>,         \
                              cudaFuncAttributeMaxDynamicSharedMemorySize, \
                              bytes);
  OPENR_WORLDS_ALLOW(1)
  OPENR_WORLDS_ALLOW(2)
  OPENR_WORLDS_ALLOW(4)
  OPENR_WORLDS_ALLOW(8)
  OPENR_WORLDS_ALLOW(16)
#undef OPENR_WORLDS_ALLOW
  return rc;
}

}  // namespace

// Lets the relax kernels take their shared memory (above the 48 KB a launch
// gets unasked) on device `device`: once a device, before any launch there
// and outside any stream capture.
extern "C" int openr_ell_relax_worlds_init(int device) {
  int prev = 0;
  cudaError_t rc = cudaGetDevice(&prev);
  if (rc == cudaSuccess && prev != device) rc = cudaSetDevice(device);
  if (rc == cudaSuccess) rc = allow_smem<true>();
  if (rc == cudaSuccess) rc = allow_smem<false>();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (rc == cudaSuccess) rc = back;
  }
  return static_cast<int>(rc);
}

// live [rows] from w [rows, k]: rows = B * n of the world blocks.
extern "C" int openr_ell_live_slots(const void* w, int rows, int k, void* live,
                                    void* stream) {
  if (rows < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per = kLiveThreads / 32;
  ell_live_slot_counts<<<(rows + per - 1) / per, kLiveThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(w), rows, k, static_cast<int32_t*>(live));
  return static_cast<int>(cudaGetLastError());
}

// d, out [B, S, n]; src, w [B, n, k]; overloaded [B, n] bytes; live [B, n]; run,
// tile_rows and slab as ops/ell_relax.py::worlds_plan says.
extern "C" int openr_ell_band_relax_worlds(const void* d, int B, int S, int n,
                                           const void* src, const void* w,
                                           int k, const void* overloaded,
                                           const void* live,
                                           int run, int tile_rows, int slab,
                                           void* out, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || n < 1 || k < 0 || run < 1 ||
      tile_rows < 1 || (S + run - 1) / run > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* d_ = static_cast<const int32_t*>(d);
  const int32_t* src_ = static_cast<const int32_t*>(src);
  const int32_t* w_ = static_cast<const int32_t*>(w);
  const int32_t* live_ = static_cast<const int32_t*>(live);
  int32_t* out_ = static_cast<int32_t*>(out);
  const uint8_t* ov = static_cast<const uint8_t*>(overloaded);
  const cudaError_t rc =
      slab ? launch_run<true>(d_, B, S, n, src_, w_, k, ov, live_, run, tile_rows, out_, st)
           : launch_run<false>(d_, B, S, n, src_, w_, k, ov, live_, run, tile_rows, out_, st);
  return static_cast<int>(rc);
}
