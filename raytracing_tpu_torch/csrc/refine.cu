// K5, dense form: per (ray tile, cluster) "entered" bits.
//
// Replaces raytracing_tpu/kernels/traverse.py:_refine_kernel as launched by
// _refine_dense (every cluster of a table of at most 512, one shared AABB
// table, dead tiles skipped on a prefetched alive flag). Bit (tile, c) is 1
// iff some alive lane of the tile enters cluster c's AABB. The slab test
// follows traverse.py:526-546 exactly: reciprocal first, degenerate axes
// unbounded, the interval inflated by 2e-6*|t| + 1e-7, '<=' and '>=' as
// written. (The TPU kernel's t_cap serves the two-phase capped query, which
// is not ported.)
//
// Bound on the card: arithmetic, ~30 operations per (ray, cluster), with a
// block-wide OR per cluster. The AABB table sits in shared memory; each
// thread keeps its 4 rays' origins and reciprocal directions in registers.
//
// K5, gathered form (refine_lists_kernel): the same bit for each tile's
// LISTED candidates, for tables of more than 512 clusters. Replaces the
// same _refine_kernel as launched by _lane_refine_lists, which first
// gathers every listed cluster's AABB into a [nt, 8, W] candidate tensor
// (jnp.take); here the kernel reads the boxes through the id list itself,
// so that tensor has no counterpart. The tile's rays (origin, reciprocal
// direction, flags) sit in shared memory; each warp takes every 8th
// candidate and sweeps the 1024 rays 32 at a time, stopping at the first
// sweep in which some alive lane enters — an entered candidate, the common
// case in a refined list's input, costs one sweep. Bound: arithmetic, at
// most ~30 operations per (ray, candidate).
#include "common.cuh"

namespace rt {
namespace {

// traverse.py:526-546 for one ray and one box: reciprocal first,
// degenerate axes unbounded, the interval inflated by 2e-6*|t| + 1e-7.
__device__ __forceinline__ bool slab_enters(const float o[3],
                                            const float inv[3],
                                            const bool deg[3],
                                            const float* __restrict__ lo,
                                            const float* __restrict__ hi) {
  float tn = 0.0f;
  float tf = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = (lo[k] - o[k]) * inv[k];
    const float t2 = (hi[k] - o[k]) * inv[k];
    const float a = deg[k] ? -inf() : fminf(t1, t2);
    const float b = deg[k] ? inf() : fmaxf(t1, t2);
    tn = k == 0 ? a : fmaxf(tn, a);
    tf = k == 0 ? b : fminf(tf, b);
  }
  const float rel = static_cast<float>(2e-6);
  const float abs_ = static_cast<float>(1e-7);
  tf = tf + (fabsf(tf) * rel + abs_);
  tn = tn - (fabsf(tn) * rel + abs_);
  return tn <= tf && tf >= 0.0f;
}

__global__ void __launch_bounds__(kThreads)
refine_kernel(const float* __restrict__ rays, long long np,
              const float* __restrict__ cmin, const float* __restrict__ cmax,
              int n_clusters, const int* __restrict__ tile_alive,
              int* __restrict__ out) {
  __shared__ float box_lo[3 * kMaxRefineClusters];
  __shared__ float box_hi[3 * kMaxRefineClusters];
  int* row = out + static_cast<long long>(blockIdx.x) * n_clusters;
  if (tile_alive[blockIdx.x] == 0) {
    for (int c = threadIdx.x; c < n_clusters; c += kThreads) row[c] = 0;
    return;
  }
  for (int e = threadIdx.x; e < 3 * n_clusters; e += kThreads) {
    box_lo[e] = cmin[e];
    box_hi[e] = cmax[e];
  }
  float o[kRaysPerThread][3];
  float inv[kRaysPerThread][3];
  bool deg[kRaysPerThread][3];
  bool alive[kRaysPerThread];
#pragma unroll
  for (int r = 0; r < kRaysPerThread; ++r) {
    const long long i = ray_index(r);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d = rays[(4 + k) * np + i];
      o[r][k] = rays[k * np + i];
      deg[r][k] = fabsf(d) < tiny();
      inv[r][k] = 1.0f / (deg[r][k] ? tiny() : d);
    }
    alive[r] = rays[7 * np + i] != 0.0f;
  }
  __syncthreads();
  for (int c = 0; c < n_clusters; ++c) {
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRaysPerThread; ++r) {
      // Evaluated for every ray, not behind `any ||`: a short-circuit
      // here makes the warp's lanes diverge and costs about a fifth more.
      const bool enters = slab_enters(o[r], inv[r], deg[r], box_lo + 3 * c,
                                      box_hi + 3 * c);
      any = any || (alive[r] && enters);
    }
    const int bit = __syncthreads_or(any);
    if (threadIdx.x == 0) row[c] = bit ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
refine_lists_kernel(const float* __restrict__ rays, long long np,
                    const int* __restrict__ ids, const int* __restrict__ cnt,
                    int width, const float* __restrict__ cmin,
                    const float* __restrict__ cmax, int* __restrict__ out) {
  __shared__ float s_o[3][kRayTile];
  __shared__ float s_inv[3][kRayTile];
  __shared__ unsigned char s_flag[kRayTile];  // bit k: axis k degenerate;
                                              // bit 3: alive
  const long long list = static_cast<long long>(blockIdx.x) * width;
  const int n = min(cnt[blockIdx.x], width);
  for (int j = max(n, 0) + threadIdx.x; j < width; j += kThreads) {
    out[list + j] = 0;
  }
  if (n <= 0) return;
#pragma unroll
  for (int r = 0; r < kRaysPerThread; ++r) {
    const long long i = ray_index(r);
    const int l = threadIdx.x + r * kThreads;
    unsigned char flag = rays[7 * np + i] != 0.0f ? 8 : 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d = rays[(4 + k) * np + i];
      const bool deg = fabsf(d) < tiny();
      s_o[k][l] = rays[k * np + i];
      s_inv[k][l] = 1.0f / (deg ? tiny() : d);
      if (deg) flag |= 1 << k;
    }
    s_flag[l] = flag;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int j = threadIdx.x / 32; j < n; j += kThreads / 32) {
    const int c = ids[list + j];
    float lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = cmin[3LL * c + k];
      hi[k] = cmax[3LL * c + k];
    }
    bool any = false;
    for (int base = 0; base < kRayTile && !any; base += 32) {
      const int l = base + lane;
      const unsigned char flag = s_flag[l];
      const float o[3] = {s_o[0][l], s_o[1][l], s_o[2][l]};
      const float inv[3] = {s_inv[0][l], s_inv[1][l], s_inv[2][l]};
      const bool deg[3] = {(flag & 1) != 0, (flag & 2) != 0, (flag & 4) != 0};
      const bool enters = (flag & 8) != 0 && slab_enters(o, inv, deg, lo, hi);
      any = __any_sync(0xffffffffu, enters) != 0;
    }
    if (lane == 0) out[list + j] = any ? 1 : 0;
  }
}

}  // namespace
}  // namespace rt

// rays [8, np]; cmin, cmax [C, 3]; tile_alive [np / 1024] i32;
// out [np / 1024, C] i32.
extern "C" int rt_refine_dense(const float* rays, long long np,
                               const float* cmin, const float* cmax,
                               int n_clusters, const int* tile_alive,
                               int* out, void* stream) {
  if (np <= 0 || np % rt::kRayTile != 0 || n_clusters <= 0
      || n_clusters > rt::kMaxRefineClusters) {
    return cudaErrorInvalidValue;
  }
  const unsigned nt = static_cast<unsigned>(np / rt::kRayTile);
  rt::refine_kernel<<<nt, rt::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rays, np, cmin, cmax, n_clusters, tile_alive, out);
  return static_cast<int>(cudaGetLastError());
}

// rays [8, np]; ids [np / 1024, width] i32 with cnt [np / 1024] listed
// candidates per tile; cmin, cmax [C, 3]; out [np / 1024, width] i32:
// 1 iff position j < min(cnt, width) and some alive lane of the tile
// enters cluster ids[tile, j]'s box.
extern "C" int rt_refine_lists(const float* rays, long long np, const int* ids,
                               const int* cnt, int width, const float* cmin,
                               const float* cmax, int* out, void* stream) {
  if (np <= 0 || np % rt::kRayTile != 0 || width <= 0) {
    return cudaErrorInvalidValue;
  }
  const unsigned nt = static_cast<unsigned>(np / rt::kRayTile);
  rt::refine_lists_kernel<<<nt, rt::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      rays, np, ids, cnt, width, cmin, cmax, out);
  return static_cast<int>(cudaGetLastError());
}
