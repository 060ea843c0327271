// K4: the work-queue walk — K1's function with a few visits of one tile as
// the unit of work.
//
// Replaces raytracing_tpu/kernels/traverse.py:_wq_kernel (launched by
// _launch_wq from _walk_wq). A work item is `u` consecutive visits of one
// tile's list. The TPU runs its grid of items in order on one core and
// keeps a tile's accumulator resident across the tile's consecutive items
// ("flat-acc"), writing it back once.
//
// What bounds it on this card: scheduler slots, one per machine op of the
// (ray, triangle) tests (walk_core.cuh: ~60 a test under -fmad=false, which
// bit-equality needs). So the levers are to make fewer tests and to keep
// every scheduler issuing them. The design:
//
//   1. Only real items. One small launch (wq_plan_kernel) fills the merge
//      state and, in its block 0, scans ceil(min(cnt, width) / u) over the
//      tiles into `first` [nt + 1]: item i belongs to the tile t with
//      first[t] <= i < first[t + 1]. No host sync: a persistent grid (the
//      blocks one multiprocessor holds x the multiprocessors) reads the
//      item count on the device. A tile with no visits has no item and
//      keeps the filled miss.
//   2. Runs in registers. A warp keeps its rays' best (t, slot) across a
//      run of one tile's consecutive items and merges once a run: the key
//      merge of walk_core.cuh (atomicMin on (bits(t) << 32) | slot,
//      occlusion on bits(t)), so the result does not depend on how the
//      items fall. Only a ray with a hit reaches the atomic.
//   3. A per-warp cull. A warp holds 128 consecutive lanes of a tile
//      (common.cuh's ray_index). Before a visit's triangles it slab-tests
//      the cluster's box against its alive rays (walk_core.cuh's
//      lanes_enter: the TPU's lane_cull_cond, IEEE division, inflated) and
//      skips a cluster none of them enters. The inflation covers the
//      rounding of both tests, so no alive lane's result changes; a dead
//      lane's result is meaningless (as in K1/K2). The refined lists hold
//      what some ray of the tile enters; a 128-lane warp enters fewer.
//   4. Warps decoupled (wq_warp_kernel). The unit of work is one item of
//      one 128-lane warp of a tile, numbered tile by tile, warp by warp,
//      item by item; every warp of the grid takes kRun consecutive units
//      from a counter beside the queue, so a warp's work does not wait for
//      the other warps of a tile, and the card's warps share the work as
//      they free up. A warp stages only the clusters it enters, into its
//      own two slots of dynamic shared memory, with one TMA bulk copy each
//      (cp.async.bulk from one lane: a cluster's geometry rows are
//      contiguous and 16-byte aligned) completing the slot's mbarrier by
//      bytes; the next copy is in flight while the last one is
//      intersected. No block barrier is left after the setup.
//
// A ring of stages shared by a tile's warps in one block, each stage with
// its full and empty barrier, was measured against this design on the
// H100 and lost to it: the block still ends with its busiest warp, and
// every warp stages every listed cluster. The lists are as wide as the
// table, so the TPU's residual launch for cut lists has no counterpart.
#include <mutex>
#include <vector>

#include "walk_core.cuh"

namespace rt {
namespace {

// Lanes of a warp's share of a tile (common.cuh's ray_index).
constexpr int kWarpLanes = kRaysPerThread * kRayStride;
// Work units a warp takes from the counter at a time (and merges once):
// on 3a's wavefront of chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W) 1 and
// 2 read alike, 4 1.1x.
constexpr int kRun = 2;
// Cycles a warp waits for a slot's copy before it traps (a lost copy would
// otherwise hang the card): far above any copy's few microseconds.
constexpr long long kStallCycles = 1ll << 36;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(1)
               : "memory");
}

// Arrive on a full barrier, expecting `bytes` of copies to complete it.
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar,
                                              unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `bar` with this parity to complete.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kStallCycles) __trap();
  }
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// This warp's rays: lanes base + lane + 32 r of the pack (base = tile *
// ray_tile + 128 w for warp w of a tile, as common.cuh's ray_index lays a
// block's tile out), their limits, and an empty result.
template <int R>
__device__ __forceinline__ void load_warp_rays(
    const float* __restrict__ rays, long long np,
    const float* __restrict__ tmax_row, float t_max, long long base,
    float (&o)[R][3], float (&d)[R][3], bool (&alive)[R], float (&t_lim)[R],
    float (&best_t)[R], int (&best_s)[R]) {
  const long long i0 = base + (threadIdx.x & 31);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = i0 + r * kRayStride;
    t_lim[r] = tmax_row != nullptr ? tmax_row[i] : t_max;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[r][k] = rays[k * np + i];
      d[r][k] = rays[(4 + k) * np + i];
    }
    alive[r] = rays[7 * np + i] != 0.0f;
    best_t[r] = inf();
    best_s[r] = kBigId;
  }
}

// Merge this warp's rays at `base` (walk_core.cuh's key merge).
template <int R, bool NEAREST>
__device__ __forceinline__ void merge_warp_rays(long long base,
                                                const float (&best_t)[R],
                                                const int (&best_s)[R],
                                                unsigned long long* keys,
                                                float* out_t) {
  const long long i0 = base + (threadIdx.x & 31);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    merge_result(i0 + r * kRayStride, NEAREST, best_t[r], best_s[r], keys,
                 out_t);
  }
}

// The tile of `item`: the last t with first[t] <= item.
__device__ __forceinline__ int wq_tile_of(const int* __restrict__ first,
                                          int nt, long long item) {
  int lo = 0;
  int hi = nt;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (first[mid] <= item) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Fill the merge state of every ray; block 0 also writes the item queue:
// first[t] = the items of tiles before t, first[nt] = all items.
constexpr int kPlanThreads = 1024;
constexpr int kScanPer = 4;  // tiles a thread scans per pass

__global__ void __launch_bounds__(kPlanThreads)
wq_plan_kernel(long long np, int nearest, unsigned long long* __restrict__ keys,
               float* __restrict__ out_t, const int* __restrict__ cnt, int nt,
               int width, int u, int* __restrict__ first) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i < np) fill_merge(i, nearest != 0, keys, out_t);
  if (blockIdx.x != 0) return;
  __shared__ int warp_sums[kPlanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nt; base += kPlanThreads * kScanPer) {
    const int t0 = base + threadIdx.x * kScanPer;
    int before[kScanPer];
    int sum = 0;
#pragma unroll
    for (int p = 0; p < kScanPer; ++p) {
      before[p] = sum;
      const int t = t0 + p;
      sum += t < nt ? (max(0, min(cnt[t], width)) + u - 1) / u : 0;
    }
    int x = sum;  // inclusive scan of the warp's sums
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int start = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - sum;
#pragma unroll
    for (int p = 0; p < kScanPer; ++p) {
      if (t0 + p < nt) first[t0 + p] = start + before[p];
    }
    __syncthreads();
    if (threadIdx.x == kPlanThreads - 1) carry = start + sum;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    first[nt] = carry;
    first[nt + 1] = 0;  // the walk's counter of units taken
  }
}

// Start the copy of cluster c's rows into this warp's slot (lane 0;
// the warp is done reading the slot: its last reader was this warp).
template <int F>
__device__ __forceinline__ void warp_stage(float4* slot,
                                           unsigned long long* bar,
                                           const float* __restrict__ geo,
                                           long long geo_stride, int cs,
                                           int c) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    const unsigned bytes = family_rows(F) * cs * 4;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive_expect(bar, bytes);
    bulk_copy(slot, geo + static_cast<long long>(c) * geo_stride, bytes, bar);
  }
}

// The walk: every warp of the persistent grid takes chunks of kRun work
// units from the queue's counter (first[nt + 1]); a unit is one item of
// one 128-lane warp of a tile (subtile), numbered tile by tile, subtile by
// subtile, item by item, so a chunk is a run of one subtile's consecutive
// items. The warp culls each visit with its rays, stages the entered ones
// into its own two slots (the next copy in flight while the last lands
// and is intersected) and merges its rays once a run.
template <int F, bool NEAREST, bool CAPPED>
__global__ void __launch_bounds__(kThreads)
wq_warp_kernel(const float* __restrict__ rays, long long np, int ray_tile,
               const float* __restrict__ tmax_row,
               const int* __restrict__ ids, const int* __restrict__ cnt,
               int* first, int nt, int width, int u,
               const float* __restrict__ geo, long long geo_stride, int cs,
               float eps, float t_max, const float* __restrict__ lcb,
               unsigned long long* keys, float* out_t) {
  extern __shared__ float4 wq_smem[];
  __shared__ unsigned long long bars[kThreads / 32][2];
  constexpr int R = kRaysPerThread;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot_f4 = family_rows(F) * cs / 4;
  float4* const slots = wq_smem + warp * 2 * slot_f4;
  unsigned long long* const bar = bars[warp];
  if (lane == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  const int subtiles = ray_tile / kWarpLanes;
  const long long units = static_cast<long long>(first[nt]) * subtiles;

  float o[R][3];
  float d[R][3];
  float best_t[R];
  int best_s[R];
  bool alive[R];
  float t_lim[R];
  long long held = -1;  // the first lane of the unit whose rays are held
  int pend = -1;        // the cluster staged in slot `fill ^ 1`, if any
  int fill = 0;         // the slot the next copy takes
  unsigned phase = 0;   // bit s: the parity slot s waits for next
  // Intersect the staged cluster `pend` once its copy has landed.
  auto walk_pending = [&]() {
    const int slot = fill ^ 1;
    mbar_wait(bar + slot, (phase >> slot) & 1);
    phase ^= 1u << slot;
    walk_cluster<R, F, NEAREST, CAPPED>(slots + slot * slot_f4, pend * cs,
                                        cs, o, d, eps, t_max, t_lim, best_t,
                                        best_s);
  };
  for (;;) {
    long long x = 0;
    if (lane == 0) x = atomicAdd(first + nt + 1, kRun);
    x = __shfl_sync(0xffffffffu, x, 0);
    if (x >= units) break;
    const long long x_end = min(x + kRun, units);
    int tile = wq_tile_of(first, nt, x / subtiles);
    int items = first[tile + 1] - first[tile];
    const long long y = x - static_cast<long long>(first[tile]) * subtiles;
    int w = static_cast<int>(y / items);
    int k = static_cast<int>(y % items);
    for (;;) {
      const long long base = static_cast<long long>(tile) * ray_tile
                             + w * kWarpLanes;
      if (base != held) {  // a new run: merge the last one's rays
        if (pend >= 0) walk_pending();
        pend = -1;
        if (held >= 0) {
          merge_warp_rays<R, NEAREST>(held, best_t, best_s, keys, out_t);
        }
        load_warp_rays(rays, np, tmax_row, t_max, base, o, d, alive, t_lim,
                       best_t, best_s);
        held = base;
      }
      const int* row = ids + static_cast<long long>(tile) * width;
      const int j1 = min(k * u + u, min(cnt[tile], width));
      for (int j = k * u; j < j1; ++j) {
        const int c = row[j];
        if (!__any_sync(0xffffffffu,
                        lanes_enter(o, d, alive, lcb + 6LL * c))) {
          continue;
        }
        warp_stage<F>(slots + fill * slot_f4, bar + fill, geo, geo_stride, cs,
                      c);
        if (pend >= 0) walk_pending();  // while this one lands
        pend = c;
        fill ^= 1;
      }
      if (++x == x_end) break;
      if (++k == items) {  // the next unit: the next subtile, or tile
        k = 0;
        if (++w == subtiles) {
          w = 0;
          do {
            ++tile;
          } while (first[tile + 1] == first[tile]);
          items = first[tile + 1] - first[tile];
        }
      }
    }
  }
  if (pend >= 0) walk_pending();
  if (held >= 0) merge_warp_rays<R, NEAREST>(held, best_t, best_s, keys, out_t);
}

__global__ void wq_finish_kernel(long long np, int nearest,
                                 const unsigned long long* __restrict__ keys,
                                 const float* __restrict__ attr,
                                 long long attr_stride, int n_attrs, int cs,
                                 float* __restrict__ out_t,
                                 int* __restrict__ out_s,
                                 float* __restrict__ out_a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= np) return;
  if (nearest) {
    const unsigned long long key = keys[i];
    store_result(i, np, key_t(key), key_slot(key), true, attr, attr_stride,
                 n_attrs, cs, out_t, out_s, out_a);
  } else {
    out_s[i] = out_t[i] < inf() ? 1 : 0;
  }
}

using WqKernel = decltype(&wq_warp_kernel<kPmt, true, false>);

// The instance of family f: pmt, pmto or mt.
template <bool NEAREST, bool CAPPED>
WqKernel wq_instance(int f) {
  switch (f) {
    case kPmto: return wq_warp_kernel<kPmto, NEAREST, CAPPED>;
    case kMt: return wq_warp_kernel<kMt, NEAREST, CAPPED>;
    default: return wq_warp_kernel<kPmt, NEAREST, CAPPED>;
  }
}

WqKernel wq_instance(int f, bool nearest, bool capped) {
  return !nearest ? wq_instance<false, false>(f)
         : capped ? wq_instance<true, true>(f)
                  : wq_instance<true, false>(f);
}

// Dynamic shared memory: two one-cluster slots a warp.
inline int wq_warp_bytes(int rows, int cs) {
  return kThreads / 32 * 2 * rows * cs * 4;
}

// Resident blocks of `kern` (an instance of a family of `rows` geometry
// rows) at cluster size cs. Its dynamic shared memory limit is set for
// the largest cluster size, so a launch at any cs fits whatever limit an
// earlier query set.
cudaError_t wq_blocks(WqKernel kern, int rows, int cs, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wq_warp_bytes(rows, kMaxClusterSize));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, kThreads, wq_warp_bytes(rows, cs));
}

// The persistent grid of `kern` at cluster size cs: its resident blocks x
// the multiprocessors, worked out once a device, instance and cs (the
// queries cost host time, and a frame launches K4 a hundred times and
// more).
cudaError_t wq_grid(WqKernel kern, int rows, int cs, unsigned* grid) {
  struct Known {
    int dev;
    WqKernel kern;
    int cs;
    unsigned grid;
  };
  static std::mutex mu;
  static std::vector<Known> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Known& k : known) {
    if (k.dev == dev && k.kern == kern && k.cs == cs) {
      *grid = k.grid;
      return cudaSuccess;
    }
  }
  int per_sm = 0;
  int sms = 0;
  err = wq_blocks(kern, rows, cs, &per_sm);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return err;
  *grid = static_cast<unsigned>(per_sm * sms);
  known.push_back({dev, kern, cs, *grid});
  return cudaSuccess;
}

}  // namespace
}  // namespace rt

// rays [8, np] in tiles of ray_tile (common.cuh's ray_tile_ok), nt =
// np / ray_tile; tmax_row [np] or null; ids [nt, width] i32 with cnt [nt]
// listed clusters per tile (every one of the first min(cnt, width) is
// walked for the warps whose rays enter it); u visits per work item; geo,
// attr and t_max as rt_walk takes them, family 0 (pmt), 1 (pmto) or 2
// (mt); lane_bounds [C, 6] (min | max, indexed like geo): the per-warp
// cull's boxes. Scratch the launch fills: first [nt + 2] i32 (the item
// queue and the units' counter) and keys, np 8-byte words, 8-byte aligned
// (nearest only; may be null for occlusion). Outputs t [np], slot or hit
// flag [np] i32, attrs [n_attrs, np], defined on alive lanes. Three
// launches on the stream: plan, walk, finish.
extern "C" int rt_walk_wq(const float* rays, long long np, int ray_tile,
                          const float* tmax_row, const int* ids,
                          const int* cnt, int width, int u, const float* geo,
                          long long geo_stride, const float* attr,
                          long long attr_stride, int n_attrs, int cs,
                          float eps, float t_max, int nearest, int family,
                          const float* lane_bounds, int* first,
                          unsigned long long* keys, float* out_t, int* out_s,
                          float* out_a, void* stream) {
  if (!rt::ray_tile_ok(np, ray_tile) || width <= 0 || u <= 0
      || first == nullptr || lane_bounds == nullptr
      || !rt::walk_tables_ok(geo, geo_stride, cs, family)
      || family == rt::kWoop
      || (nearest && (keys == nullptr
                      || reinterpret_cast<unsigned long long>(keys) % 8))) {
    return cudaErrorInvalidValue;
  }
  const long long nt = np / ray_tile;
  const long long subtiles = ray_tile / rt::kWarpLanes;
  if (nt * ((width + u - 1) / u) * subtiles > (1ll << 30)) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned plan = static_cast<unsigned>(
      (np + rt::kPlanThreads - 1) / rt::kPlanThreads);
  rt::wq_plan_kernel<<<plan, rt::kPlanThreads, 0, s>>>(
      np, nearest, keys, out_t, cnt, static_cast<int>(nt), width, u, first);
  auto kern = rt::wq_instance(family, nearest != 0, rt::is_capped(t_max));
  const int rows = rt::family_rows(family);
  const int smem = rt::wq_warp_bytes(rows, cs);
  unsigned grid = 0;
  const cudaError_t err = rt::wq_grid(kern, rows, cs, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, rt::kThreads, smem, s>>>(
      rays, np, ray_tile, tmax_row, ids, cnt, first, static_cast<int>(nt),
      width, u, geo, geo_stride, cs, eps, t_max, lane_bounds, keys, out_t);
  const unsigned flat = static_cast<unsigned>((np + rt::kThreads - 1)
                                              / rt::kThreads);
  rt::wq_finish_kernel<<<flat, rt::kThreads, 0, s>>>(
      np, nearest, keys, attr, attr_stride, n_attrs, cs, out_t, out_s,
      out_a);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a multiprocessor holds of the warp walk rt_walk_wq
// launches for (family, nearest, capped) over a table of cluster size cs
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, blocks of 256 threads);
// the walk's grid is this times the multiprocessors.
extern "C" int rt_wq_occupancy(int family, int nearest, int capped, int cs,
                               int* blocks) {
  if (cs <= 0 || cs > rt::kMaxClusterSize || cs % 4 || family < 0
      || family >= rt::kWoop) {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(rt::wq_blocks(
      rt::wq_instance(family, nearest != 0, capped != 0),
      rt::family_rows(family), cs, blocks));
}
