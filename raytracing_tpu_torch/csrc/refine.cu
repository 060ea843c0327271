// K5: per (ray tile, cluster) "entered" bits, in two forms.
//
// Replaces raytracing_tpu/kernels/traverse.py:_refine_kernel, launched by
// _refine_dense (every cluster of a table of at most 512) and by
// _lane_refine_lists (each tile's listed candidates, for bigger tables;
// there it first gathers every listed cluster's AABB into a [nt, 8, W]
// candidate tensor, which has no counterpart here: the kernel reads the
// boxes through the id list). Bit (tile, c) is 1 iff some alive lane of
// the tile enters cluster c's AABB. The slab test gives the bits of
// traverse.py:526-546: reciprocal first, degenerate axes unbounded, the
// interval inflated by 2e-6*|t| + 1e-7, '<=' and '>=' as written. A
// two-phase capped query's first phase gives a cap: tf is clipped to it
// after the inflation (traverse.py:539-543), a box entered only beyond it
// is not entered. The capped forms are their own instances, so the
// uncapped test keeps its operation count.
//
// Bound on the card: issue slots. A candidate that no lane enters needs
// every alive lane tested (9 in 10 of a refined list's input at 404k and
// 1.6M triangles, 4 in 5 of the dense table's), so the design makes each
// (ray, box) test cheap and keeps every warp busy:
//  - a thread holds its 4 lanes of the tile in registers (origin and
//    reciprocal direction; a block of ray_tile / 4 threads holds the
//    tile, each warp 128 consecutive lanes of it: common.cuh's
//    ray_index); a degenerate axis gets a NaN reciprocal: its
//    slab bounds are NaN, which fminf / fmaxf drop, so the axis bounds
//    nothing, as the plain version's -inf / +inf do, with no flag or
//    select per test;
//  - every warp tests every candidate of its block against its 128 lanes,
//    starting at its own offset into the candidates; the first warp with a
//    witness marks the candidate in shared memory, and a warp that comes
//    to a marked candidate skips it;
//  - the candidates' boxes are read into shared memory before the tests
//    (coalesced through the id list), and the bits go out in one pass.
// An OR over the alive lanes does not depend on which warp finds a
// witness, so every bit is the plain version's and each is written by
// exactly one block: no merge, no atomic, the same bits at every launch.
// (Staging only the alive lanes in shared memory, compacted, with one warp
// sweeping them per candidate up to its first witness, measured 13-20%
// slower: binned bounce tiles are full, so compaction saves nothing, and
// the shared-memory loads cost a third more instructions per test.)
//
// Dense form (refine_kernel): one block per tile, every cluster of the
// table, the boxes in dynamic shared memory. The same launch reduces the
// tile's extents (K6's contract, traverse.py:_extents_kernel: the masked
// min and max of the 8 rows over alive lanes) from the rays it reads
// anyway, and takes its tile-alive flag from them (hi[7] > 0) unless flags
// are given: the dense refined-list query is one launch where it was K6, a
// comparison, a cast and K5.
//
// Gathered form (refine_lists_kernel): the unit of work is a run of `run`
// list positions of one tile. A tile's runs are dealt to up to
// `tile_blocks` blocks (block b takes runs b, b + tile_blocks, ...), so a
// tile whose frustum lists thousands of candidates runs on many blocks
// while a short list takes one; the grid is segment-major, block b of
// every tile before block b + 1 of any. Positions past min(cnt, width)
// are written 0 by the block that owns them; a block that owns no listed
// position reads no ray.
#include <limits>

#include "common.cuh"

namespace rt {
namespace {

// Most warps a block holds (a tile of kRayTile rays); a smaller tile's
// block holds ray_tile / 128.
constexpr int kMaxWarps = kThreads / 32;

// A thread's 4 lanes of the tile: origin and reciprocal direction (NaN on
// a degenerate axis), alive flag.
struct Lanes {
  float o[kRaysPerThread][3];
  float inv[kRaysPerThread][3];
  bool alive[kRaysPerThread];
};

// traverse.py:526-546 for one ray and one box (lo, hi): the slab bounds of
// each axis folded from -inf / +inf (a NaN bound, a degenerate axis, is
// dropped), the interval inflated by 2e-6*|t| + 1e-7.
template <bool CAPPED>
__device__ __forceinline__ bool slab_enters(const float o[3],
                                            const float inv[3],
                                            const float lo[3],
                                            const float hi[3], float cap) {
  float tn = -inf();
  float tf = inf();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = (lo[k] - o[k]) * inv[k];
    const float t2 = (hi[k] - o[k]) * inv[k];
    tn = fmaxf(tn, fminf(t1, t2));
    tf = fminf(tf, fmaxf(t1, t2));
  }
  const float rel = static_cast<float>(2e-6);
  const float abs_ = static_cast<float>(1e-7);
  tf = tf + (fabsf(tf) * rel + abs_);
  tn = tn - (fabsf(tn) * rel + abs_);
  if (CAPPED) tf = fminf(tf, cap);
  return tn <= tf && tf >= 0.0f;
}


// Row `row` of lane r: an origin, or a reciprocal direction (1 / d as the
// plain version takes it where |d| >= tiny; NaN on a degenerate axis).
__device__ __forceinline__ void keep_row(int row, float v, int r, Lanes& L) {
  if (row < 3) {
    L.o[r][row] = v;
  } else if (row >= 4 && row < 7) {
    L.inv[r][row - 4] = fabsf(v) < tiny() ? __int_as_float(0x7fc00000)
                                          : 1.0f / v;
  }
}

// Candidates [0, m), boxes in s_box (6 floats each: lo, hi), against the
// block's lanes: every warp takes every candidate, from its own offset
// on, and skips one another warp has marked entered. s_bit (zeroed
// before) gets the marks. A warp with no alive lane tests nothing.
template <bool CAPPED>
__device__ __forceinline__ void test_candidates(const Lanes& L, int m,
                                                const float* s_box,
                                                int* s_bit, float cap) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  bool mine = false;
#pragma unroll
  for (int r = 0; r < kRaysPerThread; ++r) mine = mine | L.alive[r];
  if (!__any_sync(0xffffffffu, mine)) return;
  volatile int* mark = s_bit;
  int j = warp * m / static_cast<int>(blockDim.x / 32);
  for (int i = 0; i < m; ++i, j = j + 1 == m ? 0 : j + 1) {
    if (__any_sync(0xffffffffu, mark[j] != 0)) continue;
    const float lo[3] = {s_box[6 * j], s_box[6 * j + 1], s_box[6 * j + 2]};
    const float hi[3] = {s_box[6 * j + 3], s_box[6 * j + 4],
                         s_box[6 * j + 5]};
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRaysPerThread; ++r) {
      // Every lane's test evaluated, not behind `any ||`: a short-circuit
      // makes the warp's lanes diverge.
      const bool enters = slab_enters<CAPPED>(L.o[r], L.inv[r], lo, hi,
                                              cap);
      any = any | (L.alive[r] & enters);
    }
    if (__any_sync(0xffffffffu, any) && lane == 0) mark[j] = 1;
  }
}

// Dynamic shared memory: 6 floats (lo | hi) and one mark per cluster.
template <bool CAPPED>
__global__ void __launch_bounds__(kThreads)
refine_kernel(const float* __restrict__ rays, long long np,
              const float* __restrict__ cmin, const float* __restrict__ cmax,
              int n_clusters, float cap, const int* __restrict__ tile_alive,
              float* __restrict__ lo, float* __restrict__ hi,
              int* __restrict__ out) {
  __shared__ float s_lo[kMaxWarps][8];
  __shared__ float s_hi[kMaxWarps][8];
  __shared__ int s_live;
  extern __shared__ float s_box[];
  int* s_bit = reinterpret_cast<int*>(s_box + 6 * n_clusters);
  const int tile = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  // Every row read once: the extents reduced from it (as extents.cu does,
  // dead lanes out), the lanes' origins and directions kept.
  Lanes L;
  float v[kRaysPerThread];
#pragma unroll
  for (int r = 0; r < kRaysPerThread; ++r) {
    v[r] = rays[7 * np + ray_index(tile, r)];
    L.alive[r] = v[r] != 0.0f;
  }
#pragma unroll
  for (int row = 7; row >= 0; --row) {
    if (row != 7) {
#pragma unroll
      for (int r = 0; r < kRaysPerThread; ++r) {
        v[r] = rays[row * np + ray_index(tile, r)];
      }
    }
    float m_lo = big();
    float m_hi = -big();
#pragma unroll
    for (int r = 0; r < kRaysPerThread; ++r) {
      if (L.alive[r]) {
        m_lo = fminf(m_lo, v[r]);
        m_hi = fmaxf(m_hi, v[r]);
      }
      keep_row(row, v[r], r, L);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m_lo = fminf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
    }
    if (lane == 0) {
      s_lo[warp][row] = m_lo;
      s_hi[warp][row] = m_hi;
    }
  }
  for (int e = threadIdx.x; e < 3 * n_clusters; e += blockDim.x) {
    const int c = e / 3;
    const int k = e % 3;
    s_box[6 * c + k] = cmin[e];
    s_box[6 * c + 3 + k] = cmax[e];
  }
  for (int c = threadIdx.x; c < n_clusters; c += blockDim.x) s_bit[c] = 0;
  __syncthreads();
  if (threadIdx.x < 8) {
    const int row = threadIdx.x;
    float m_lo = s_lo[0][row];
    float m_hi = s_hi[0][row];
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) {
      m_lo = fminf(m_lo, s_lo[w][row]);
      m_hi = fmaxf(m_hi, s_hi[w][row]);
    }
    if (lo != nullptr) {
      lo[tile * 8LL + row] = m_lo;
      hi[tile * 8LL + row] = m_hi;
    }
    if (row == 7) {
      s_live = tile_alive != nullptr ? tile_alive[tile] != 0 : m_hi > 0.0f;
    }
  }
  __syncthreads();
  if (s_live) test_candidates<CAPPED>(L, n_clusters, s_box, s_bit, cap);
  __syncthreads();
  int* row_out = out + static_cast<long long>(tile) * n_clusters;
  for (int c = threadIdx.x; c < n_clusters; c += blockDim.x) {
    row_out[c] = s_bit[c];
  }
}

// Dynamic shared memory: 6 floats and one mark per position of a run.
template <bool CAPPED>
__global__ void __launch_bounds__(kThreads)
refine_lists_kernel(const float* __restrict__ rays, long long np,
                    const int* __restrict__ ids, const int* __restrict__ cnt,
                    int width, int run, int tile_blocks,
                    const float* __restrict__ cmin,
                    const float* __restrict__ cmax, float cap,
                    int* __restrict__ out) {
  extern __shared__ float s_box[];
  int* s_bit = reinterpret_cast<int*>(s_box + 6 * run);
  const int nt = gridDim.x / tile_blocks;
  const int tile = blockIdx.x % nt;
  const int b = blockIdx.x / nt;
  const long long list = static_cast<long long>(tile) * width;
  const int n = max(0, min(cnt[tile], width));
  const int stride = tile_blocks * run;
  if (b * run >= n) {  // no listed position: its runs read 0
    for (int p0 = b * run; p0 < width; p0 += stride) {
      for (int j = threadIdx.x; j < run && p0 + j < width; j += blockDim.x) {
        out[list + p0 + j] = 0;
      }
    }
    return;
  }
  Lanes L;
#pragma unroll
  for (int r = 0; r < kRaysPerThread; ++r) {
    const long long i = ray_index(tile, r);
    L.alive[r] = rays[7 * np + i] != 0.0f;
#pragma unroll
    for (int row = 0; row < 7; ++row) {
      if (row == 3) continue;
      keep_row(row, L.alive[r] ? rays[row * np + i] : 0.0f, r, L);
    }
  }
  for (int p0 = b * run; p0 < width; p0 += stride) {
    const int listed = max(0, min(run, n - p0));  // positions to test
    const int owned = min(run, width - p0);
    for (int j = threadIdx.x; j < listed; j += blockDim.x) {
      const int c = ids[list + p0 + j];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s_box[6 * j + k] = cmin[3LL * c + k];
        s_box[6 * j + 3 + k] = cmax[3LL * c + k];
      }
      s_bit[j] = 0;
    }
    __syncthreads();
    test_candidates<CAPPED>(L, listed, s_box, s_bit, cap);
    __syncthreads();
    for (int j = threadIdx.x; j < owned; j += blockDim.x) {
      out[list + p0 + j] = j < listed ? s_bit[j] : 0;
    }
    __syncthreads();
  }
}

// A finite cap takes the capped instances.
bool capped(float cap) { return cap < std::numeric_limits<float>::infinity(); }

int launch_dense(const float* rays, long long np, int ray_tile,
                 const float* cmin, const float* cmax, int n_clusters,
                 float cap, const int* tile_alive, float* lo, float* hi,
                 int* out, void* stream) {
  if (!ray_tile_ok(np, ray_tile) || n_clusters <= 0
      || n_clusters > kMaxRefineClusters) {
    return cudaErrorInvalidValue;
  }
  auto kern = capped(cap) ? refine_kernel<true> : refine_kernel<false>;
  kern<<<static_cast<unsigned>(np / ray_tile), tile_threads(ray_tile),
         n_clusters * 7 * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      rays, np, cmin, cmax, n_clusters, cap, tile_alive, lo, hi, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace rt

// rays [8, np] in tiles of ray_tile (common.cuh's ray_tile_ok); cmin,
// cmax [C, 3]; cap: +inf, or the cap of a two-phase query's first phase;
// tile_alive [nt] i32; out [nt, C] i32, nt = np / ray_tile.
extern "C" int rt_refine_dense(const float* rays, long long np, int ray_tile,
                               const float* cmin, const float* cmax,
                               int n_clusters, float cap,
                               const int* tile_alive, int* out,
                               void* stream) {
  if (tile_alive == nullptr) return cudaErrorInvalidValue;
  return rt::launch_dense(rays, np, ray_tile, cmin, cmax, n_clusters, cap,
                          tile_alive, nullptr, nullptr, out, stream);
}

// The dense refined-list query in one launch: lo, hi [nt, 8] f32 as
// rt_tile_extents writes them, and out [nt, C] i32 as rt_refine_dense with
// tile-alive flags hi[:, 7] > 0.
extern "C" int rt_refine_dense_extents(const float* rays, long long np,
                                       int ray_tile, const float* cmin,
                                       const float* cmax, int n_clusters,
                                       float cap, float* lo, float* hi,
                                       int* out, void* stream) {
  if (lo == nullptr || hi == nullptr) return cudaErrorInvalidValue;
  return rt::launch_dense(rays, np, ray_tile, cmin, cmax, n_clusters, cap,
                          nullptr, lo, hi, out, stream);
}

// rays [8, np] in tiles of ray_tile; ids [nt, width] i32 with cnt [nt]
// listed candidates per tile; cmin, cmax [C, 3]; cap as rt_refine_dense
// takes it; out [nt, width] i32: 1 iff position j < min(cnt, width) and
// some alive lane of the tile enters cluster ids[tile, j]'s box. Each
// tile's positions in runs of `run`, dealt to `tile_blocks` blocks.
extern "C" int rt_refine_lists(const float* rays, long long np, int ray_tile,
                               const int* ids, const int* cnt, int width,
                               int run, int tile_blocks, const float* cmin,
                               const float* cmax, float cap, int* out,
                               void* stream) {
  if (!rt::ray_tile_ok(np, ray_tile) || width <= 0 || run <= 0
      || run > rt::kMaxRefineClusters || tile_blocks <= 0) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = np / ray_tile * tile_blocks;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  auto kern = rt::capped(cap) ? rt::refine_lists_kernel<true>
                              : rt::refine_lists_kernel<false>;
  kern<<<static_cast<unsigned>(blocks), rt::tile_threads(ray_tile),
         run * 7 * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      rays, np, ids, cnt, width, run, tile_blocks, cmin, cmax, cap, out);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a multiprocessor holds of the dense (lists 0) or
// gathered (lists 1) form, capped or not, at `threads` a block and `smem`
// bytes of dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int rt_refine_occupancy(int lists, int capped, int threads,
                                   int smem, int* blocks) {
  auto dense = capped ? rt::refine_kernel<true> : rt::refine_kernel<false>;
  auto gathered = capped ? rt::refine_lists_kernel<true>
                         : rt::refine_lists_kernel<false>;
  return static_cast<int>(
      lists ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  blocks, gathered, threads, smem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  blocks, dense, threads, smem));
}
