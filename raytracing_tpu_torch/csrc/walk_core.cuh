// The visit-list walk shared by walk.cu and wq.cu (rays read from a pack),
// gstream.cu (the same over groups of the table) and camera.cu (rays
// derived from the pinhole camera): a block walks consecutive positions of
// one tile's front-to-back list of clusters, each thread holding R rays in
// registers, and every thread intersects its rays with all the triangles
// of every listed cluster (broadcast reads from shared memory).
//
// This loop is the inner loop of the TPU package's _walk_kernel,
// _dma_walk_kernel, _gstream_kernel and _wq_kernel
// (raytracing_tpu/kernels/traverse.py), which stream a visit's block into
// VMEM by BlockSpec or by make_async_copy with two buffers.
//
// What bounds it on this card: scheduler slots, one per machine op of a
// warp. The build keeps every multiply and add apart (-fmad=false) and every
// division IEEE, so that the results are the plain version's bits; a (ray,
// triangle) test is then 44 to 61 machine ops (~40 counted floating-point
// operations; tools/sass_count.py), and 128 triangles x 4 rays keep a warp
// busy for ~30,000 of them. Device memory sees 6 KB per 128 triangles per
// tile. So the loop must not add waiting to that arithmetic:
//   - visits are staged ahead of use: a ring of kStages buffers in shared
//     memory, filled with 16-byte cp.async copies (L2 to shared memory, no
//     registers), stage s + kStages - 1 in flight while stage s is
//     intersected, and ONE barrier per stage (it carries the early-exit
//     vote too). TMA would save nothing here: a stage is at most 6 KB in up
//     to 32 pieces addressed through an id list, and starting the copies
//     costs a thread two machine ops per stage;
//   - a stage holds kMaxClusterSize / CS clusters, not one, so a table of
//     16-triangle clusters pays a barrier per 128 triangles as a table of
//     128-triangle clusters does;
//   - a row of the stage is read as float4: 12 shared-memory reads serve 4
//     triangles x R rays (woop reads float2s: 2 triangles, family_column).
//
// Four intersector families (the template parameter F of walk_list), op
// for op with the TPU package's; each stages its own rows per triangle:
//   pmt  (traverse.py:_pmt_tile, 12 rows)   t = (d0 - n·o) / den, u and v
//        from the hit point. The TPU's "pmtt" (_pmt_t_tile) is the same
//        arithmetic on a transposed table: the card walks this one;
//   pmto (traverse.py:_pmt_o_tile, 12 rows) every ray leaves one point and
//        that origin is folded into d0, u0, v0c before the launch:
//        t = d0 / den, u = u0 + t (U·d), v = v0c + t (V·d). The origin rows
//        are never read;
//   mt   (traverse.py:_mt_tile, 9 rows: v0 | e1 | e2) Möller–Trumbore:
//        p = d x e2, det = e1·p, inv = 1 / det, s = o - v0, u = (s·p) inv,
//        q = s x e1, v = (d·q) inv, t = (e2·q) inv; accepted on
//        |det| >= eps (padding has e1 = e2 = 0: det 0);
//   woop (traverse.py:_woop_tile_t, 12 rows: the 3x3 M by rows | const)
//        oL = M o + const, dL = M d as explicit multiplies and adds in a
//        fixed order (the TPU's one f32 matmul at HIGHEST precision),
//        rcp = 1 / dLz (|dLz| < 1e-20 taken as 1e-20), t = -oLz rcp,
//        u = oLx + t dLx, v = oLy + t dLy; accepted on |dLz| >= 1e-20.
// Nearest keeps a flat (best_t, best_slot) per ray: min t, then min slot,
// and an infinite t never ties; a capped instance (CAPPED: the first phase
// of a two-phase query, traverse.py:1896-1900) accepts only t < t_cap. The
// cap is a template parameter so that the uncapped walks, the main path,
// spend no issue slot on it.
// Occlusion keeps min t under each ray's own limit (a scalar t_max, or one
// entry of a per-ray row).
//
// The lane-cull pre-test (LC, traverse.py:lane_cull_cond): before a
// visit's triangles, each thread slab-tests its alive rays against the
// cluster's box (6 floats, lcb[6 c..6 c + 5] = min | max, read through L1:
// a warp reads one address), with the TPU's inflation tf += |tf| 2e-6 +
// 1e-7, tn -= |tn| 2e-6 + 1e-7, entered when tn <= tf and tf >= 0; a warp
// none of whose alive rays enters skips the visit (__any_sync: no
// barrier, finer than the TPU's per-tile vote). The inflation covers the
// rounding of both tests, so no result changes.
// Early exit, at a stage's end once ee_batch visits were made since the
// last vote: a block vote on "every alive lane's min(best_t, scene-exit t)
// is below the next entry's lower bound" — exact, so results do not depend
// on it.
//
// The order-free merge of the split walks' segments and wq.cu's work items
// is here too: one 64-bit key (bits(t) << 32) | slot per ray, merged with
// atomicMin, and with it the machinery every walk split over blocks shares
// (fill, key sharing, segment loop, finish).
#pragma once

#include "common.cuh"

namespace rt {

// Stage buffers of the ring, and the most clusters one stage holds (the
// cluster size is a multiple of 4, so at least 4).
constexpr int kStages = 3;
constexpr int kMaxStageClusters = kMaxClusterSize / 4;

// The intersector families, as the entries take them (an int: 0 and 1 are
// the pmto flag the entries took before the families), and the geometry
// rows each stages per triangle.
enum Family : int { kPmt = 0, kPmto = 1, kMt = 2, kWoop = 3 };
constexpr int kFamilies = 4;
__host__ __device__ constexpr int family_rows(int f) {
  return f == kMt ? 9 : 12;
}
// Triangles a thread reads from each staged row per step: 4 (one float4),
// woop's 2 (one float2). woop's transform keeps six values per (ray,
// triangle) live beside its 12 rows, and a column of 4 spilled at the
// 128-register cap (K3's nearest instance, NVIDIA H100 80GB HBM3).
__host__ __device__ constexpr int family_column(int f) {
  return f == kWoop ? 2 : 4;
}

// Column k of a staged row (row: the row's float4s), kC triangles wide.
template <int kC>
__device__ __forceinline__ void load_column(const float4* row, int k,
                                            float (&out)[kC]) {
  if constexpr (kC == 4) {
    const float4 v = row[k];
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    const float2 v = reinterpret_cast<const float2*>(row)[k];
    out[0] = v.x;
    out[1] = v.y;
  }
}

// A block's staging ring. A stage holds up to kMaxClusterSize triangles as
// [clusters][rows][CS] floats (12 rows, or mt's 9; float4: 16-byte copies
// and reads) and the
// ids of its clusters. With it, what the whole walk reads of its list's
// table besides the blocks: the union box of the early exit, and the first
// cluster of the list's part of the table (K3's group; 0 elsewhere). Held
// here, they cost no register through the loop (as pointers and offsets
// made from the block index did: K3's nearest kernels spilled).
struct WalkRing {
  float4 blk[kStages][3 * kMaxClusterSize];
  int ids[kStages][kMaxStageClusters];
  float box[6];
  int id_base;
};

// Set the ring's box (from bbox [6], where the walk votes on the exit) and
// id base before a block's first walk_list.
__device__ __forceinline__ void ring_setup(WalkRing& ring,
                                           const float* __restrict__ bbox,
                                           int id_base) {
  if (bbox != nullptr && threadIdx.x < 6) {
    ring.box[threadIdx.x] = bbox[threadIdx.x];
  }
  if (threadIdx.x == 0) ring.id_base = id_base;
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(__cvta_generic_to_global(gmem))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The merge key of a (t, slot) pair. An accepted t is > eps > 0, so its bit
// pattern orders as an unsigned integer and +inf is the largest: the key's
// order is exactly the lexicographic (min t, then min slot) rule, and
// atomicMin merges in any order. A key is written by one 8-byte atomic on an
// aligned word, so a reader never sees a torn one.
constexpr unsigned long long kEmptyKey =
    (0x7f800000ull << 32) | static_cast<unsigned long long>(kBigId);

__device__ __forceinline__ unsigned long long pack_key(float t, int slot) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32)
         | static_cast<unsigned>(slot);
}
__device__ __forceinline__ float key_t(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}
__device__ __forceinline__ int key_slot(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffull);
}

// What ray i's merge state holds before any block runs: the empty key
// (nearest), or +inf in the t output, which occlusion merges in place.
__device__ __forceinline__ void fill_merge(long long i, bool nearest,
                                           unsigned long long* keys,
                                           float* out_t) {
  if (nearest) {
    keys[i] = kEmptyKey;
  } else {
    out_t[i] = inf();
  }
}

// Merge one block's result for ray i. Only an accepted hit (t > eps, so its
// bits order as an unsigned integer) reaches the atomic.
__device__ __forceinline__ void merge_result(long long i, bool nearest,
                                             float best_t, int best_s,
                                             unsigned long long* keys,
                                             float* out_t) {
  if (!(best_t < inf())) return;
  if (nearest) {
    atomicMin(keys + i, pack_key(best_t, best_s));
  } else {
    atomicMin(reinterpret_cast<unsigned*>(out_t) + i, __float_as_uint(best_t));
  }
}

// A walk that shares nothing with other blocks while it runs.
struct NoShare {
  template <int R>
  __device__ __forceinline__ void operator()(float (&)[R], int (&)[R]) const {}
};

// ---------------------------------------------------------------------------
// A tile's list split over blocks (walk.cu, camera.cu, gstream.cu).
//
// The unit of work is a segment: `seg` consecutive positions of one list.
// A tile's list is dealt to at most `tile_blocks` blocks, block b taking
// segments b, b + tile_blocks, ...; blocks merge per ray through the key
// above, in any order. A nearest walk with the front-to-back exit keeps it
// exact by sharing: before a segment and at each vote a block publishes the
// hits it holds that the card does not, and folds in the better ones the
// card holds (KeyShare), so it votes on, and culls against, every hit any
// block has published. A key written by another block is a real hit of
// that ray, so whether the read is fresh or stale only changes how many
// visits are skipped. The keys are read with __ldcg (L2, where the atomics
// resolve; never a stale L1 line). The tile's last block to finish unpacks
// the keys (finish_tile). What differs per entry is only the indexing:
// which tile, pass, group and segment a block takes, and where its rays
// come from.
// ---------------------------------------------------------------------------

namespace {

// Fills what a split walk's blocks merge into and count with: every ray's
// merge state (fill_merge), the n_fin finish counters, and the n_vis visit
// counts where visits is not null.
__global__ void walk_fill_kernel(long long np, int nearest,
                                 unsigned long long* __restrict__ keys,
                                 float* __restrict__ out_t, long long n_fin,
                                 int* __restrict__ finished, long long n_vis,
                                 int* __restrict__ visits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i < np) fill_merge(i, nearest != 0, keys, out_t);
  if (i < n_fin) finished[i] = 0;
  if (visits != nullptr && i < n_vis) visits[i] = 0;
}

}  // namespace

// The fill launch on `stream`, before a split walk's blocks.
inline void launch_walk_fill(long long np, bool nearest,
                             unsigned long long* keys, float* out_t,
                             long long n_fin, int* finished, long long n_vis,
                             int* visits, cudaStream_t stream) {
  const long long n = np > n_fin ? (np > n_vis ? np : n_vis)
                                 : (n_fin > n_vis ? n_fin : n_vis);
  walk_fill_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                     kThreads, 0, stream>>>(np, nearest ? 1 : 0, keys, out_t,
                                            n_fin, finished, n_vis, visits);
}

// Segments of a list of `listed` positions (0 for an empty list).
__device__ __forceinline__ int list_parts(int listed, int seg) {
  return (listed + seg - 1) / seg;
}

// Publish this thread's hits into its rays' keys and fold the card's better
// ones in. keys: ray 0 of this thread (null: the walk shares nothing); ray
// r is keys + r * kThreads, and exists where threadIdx.x + r * kThreads <
// lanes (a camera pass may hold fewer rays than its threads' lanes).
struct KeyShare {
  unsigned long long* keys;
  int lanes;
  template <int R>
  __device__ __forceinline__ void operator()(float (&best_t)[R],
                                             int (&best_s)[R]) const {
    if (keys == nullptr) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (threadIdx.x + r * kThreads >= lanes) continue;
      const unsigned long long mine = pack_key(best_t[r], best_s[r]);
      const unsigned long long seen = __ldcg(keys + r * kThreads);
      if (mine < seen) {
        atomicMin(keys + r * kThreads, mine);
      } else {
        best_t[r] = key_t(seen);
        best_s[r] = key_slot(seen);
      }
    }
  }
};

// This thread's R pack rays of `tile` (ray r is lane threadIdx.x +
// r * kThreads of the tile: neighbouring threads read neighbouring rays),
// their limits, and an empty result.
template <int R>
__device__ __forceinline__ void load_pack_rays(
    const float* __restrict__ rays, long long np,
    const float* __restrict__ tmax_row, float t_max, long long tile,
    float (&o)[R][3], float (&d)[R][3], bool (&alive)[R], float (&t_lim)[R],
    float (&best_t)[R], int (&best_s)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = tile * kRayTile + threadIdx.x + r * kThreads;
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

// Upper bound on the t of any hit inside the walked clusters' union box
// (traverse.py:_scene_exit_row): the ray's exit parameter from the box,
// inflated a few ulp; a ray that misses the box gets -inf. Feeds only the
// early-exit vote.
__device__ __forceinline__ float scene_exit(const float o[3], const float d[3],
                                            const float* __restrict__ bbox) {
  float tmin = 0.0f;
  float tmax = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool deg = fabsf(d[k]) < tiny();
    const float dk = deg ? tiny() : d[k];
    const float t1 = (bbox[k] - o[k]) / dk;
    const float t2 = (bbox[3 + k] - o[k]) / dk;
    const float lo = deg ? -inf() : fminf(t1, t2);
    const float hi = deg ? inf() : fmaxf(t1, t2);
    tmin = k == 0 ? lo : fmaxf(tmin, lo);
    tmax = k == 0 ? hi : fminf(tmax, hi);
  }
  const float exit_t = tmax * static_cast<float>(1.0 + 1e-5)
                       + static_cast<float>(1e-6);
  return (tmin <= exit_t && exit_t >= 0.0f) ? exit_t : -inf();
}

// This thread's vote on the early exit: every alive lane's nearest hit, or
// its exit from the scene box, lies before the next entry's lower bound.
// The exit parameter is reckoned here, for the lanes whose hit does not
// settle them, rather than held in registers through the walk.
template <int R>
__device__ __forceinline__ bool lanes_settled(const bool (&alive)[R],
                                              const float (&best_t)[R],
                                              const float (&o)[R][3],
                                              const float (&d)[R][3],
                                              const float* __restrict__ bbox,
                                              float next_tnear) {
  bool settled = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (alive[r] && !(best_t[r] < next_tnear)
        && !(scene_exit(o[r], d[r], bbox) < next_tnear)) {
      settled = false;
    }
  }
  return settled;
}

// This thread's vote on a visit of the lane-cull pre-test: some alive ray
// of it enters the box (min | max, 6 floats), by the TPU's slab test
// (traverse.py:lane_cull_cond: IEEE division, a degenerate axis
// unbounded, the interval inflated).
template <int R>
__device__ __forceinline__ bool lanes_enter(const float (&o)[R][3],
                                            const float (&d)[R][3],
                                            const bool (&alive)[R],
                                            const float* __restrict__ box) {
  float lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = __ldg(box + k);
    hi[k] = __ldg(box + 3 + k);
  }
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float tn = 0.0f;
    float tf = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool deg = fabsf(d[r][k]) < tiny();
      const float dk = deg ? tiny() : d[r][k];
      const float t1 = (lo[k] - o[r][k]) / dk;
      const float t2 = (hi[k] - o[r][k]) / dk;
      const float a = deg ? -inf() : fminf(t1, t2);
      const float b = deg ? inf() : fmaxf(t1, t2);
      tn = k == 0 ? a : fmaxf(tn, a);
      tf = k == 0 ? b : fminf(tf, b);
    }
    const float rel = static_cast<float>(2e-6);
    const float abs_ = static_cast<float>(1e-7);
    tf = tf + (fabsf(tf) * rel + abs_);
    tn = tn - (fabsf(tn) * rel + abs_);
    // Every ray's test evaluated, not behind `any ||`: no divergence.
    any = any | (alive[r] & (tn <= tf) & (tf >= 0.0f));
  }
  return any;
}

// Start the copies of list positions [j0, j0 + nin) into stage buffer b and
// commit them as one group (an empty group when nin <= 0, so that every
// thread's group count advances alike). Positions past the list's end are
// not staged. A listed id plus the ring's id base indexes geo, whose first
// `rows` rows of each cluster are staged.
__device__ __forceinline__ void stage_start(
    WalkRing& ring, int b, const int* __restrict__ tile_ids, int j0, int nin,
    const float* __restrict__ geo, long long geo_stride, int cs, int rows) {
  const int per = rows * cs / 4;  // 16-byte pieces of one cluster's rows
  for (int e = threadIdx.x; e < nin * per; e += kThreads) {
    const int i = e / per;
    const int w = e - i * per;
    const int c = tile_ids[j0 + i] + ring.id_base;
    if (w == 0) ring.ids[b][i] = c;
    cp_async16(&ring.blk[b][e],
               geo + static_cast<long long>(c) * geo_stride + 4 * w);
  }
  cp_async_commit();
}

// One (ray, triangle) test of family F: triangle kk of the staged rows
// tri (a column of family_column(F) triangles), ray o, d. t is
// meaningless where valid is false.
template <int F>
__device__ __forceinline__ void intersect(
    const float (&tri)[family_rows(F)][family_column(F)], int kk,
    const float (&o)[3], const float (&d)[3], float eps, float& t,
    bool& valid) {
  if constexpr (F == kMt) {
    const float v0x = tri[0][kk], v0y = tri[1][kk], v0z = tri[2][kk];
    const float e1x = tri[3][kk], e1y = tri[4][kk], e1z = tri[5][kk];
    const float e2x = tri[6][kk], e2y = tri[7][kk], e2z = tri[8][kk];
    const float px = d[1] * e2z - d[2] * e2y;
    const float py = d[2] * e2x - d[0] * e2z;
    const float pz = d[0] * e2y - d[1] * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const float inv = 1.0f / det;
    const float sx = o[0] - v0x, sy = o[1] - v0y, sz = o[2] - v0z;
    const float u = (sx * px + sy * py + sz * pz) * inv;
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv;
    t = (e2x * qx + e2y * qy + e2z * qz) * inv;
    valid = fabsf(det) >= eps && u >= 0.0f && v >= 0.0f && u + v <= 1.0f
            && t > eps;
  } else if constexpr (F == kWoop) {
    // Rows: M's row 0 (x, y, z coefficients), row 1, row 2, const.
    const float olx = ((tri[0][kk] * o[0] + tri[1][kk] * o[1])
                       + tri[2][kk] * o[2]) + tri[9][kk];
    const float oly = ((tri[3][kk] * o[0] + tri[4][kk] * o[1])
                       + tri[5][kk] * o[2]) + tri[10][kk];
    const float olz = ((tri[6][kk] * o[0] + tri[7][kk] * o[1])
                       + tri[8][kk] * o[2]) + tri[11][kk];
    const float dlx = (tri[0][kk] * d[0] + tri[1][kk] * d[1])
                      + tri[2][kk] * d[2];
    const float dly = (tri[3][kk] * d[0] + tri[4][kk] * d[1])
                      + tri[5][kk] * d[2];
    const float dlz = (tri[6][kk] * d[0] + tri[7][kk] * d[1])
                      + tri[8][kk] * d[2];
    const bool flat = fabsf(dlz) < tiny();
    const float rcp = 1.0f / (flat ? tiny() : dlz);
    t = -olz * rcp;
    const float u = olx + t * dlx;
    const float v = oly + t * dly;
    valid = !flat && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > eps;
  } else {
    const float nx = tri[0][kk], ny = tri[1][kk], nz = tri[2][kk];
    const float d0 = tri[3][kk];
    const float ux = tri[4][kk], uy = tri[5][kk];
    const float uz = tri[6][kk], u0 = tri[7][kk];
    const float vx = tri[8][kk], vy = tri[9][kk];
    const float vz = tri[10][kk], v0c = tri[11][kk];
    const float den = nx * d[0] + ny * d[1] + nz * d[2];
    float u, v;
    if constexpr (F == kPmto) {
      t = d0 / den;
      u = u0 + t * (ux * d[0] + uy * d[1] + uz * d[2]);
      v = v0c + t * (vx * d[0] + vy * d[1] + vz * d[2]);
    } else {
      t = (d0 - (nx * o[0] + ny * o[1] + nz * o[2])) / den;
      const float px = o[0] + t * d[0];
      const float py = o[1] + t * d[1];
      const float pz = o[2] + t * d[2];
      u = ux * px + uy * py + uz * pz + u0;
      v = vx * px + vy * py + vz * pz + v0c;
    }
    valid = fabsf(den) >= eps && u >= 0.0f && v >= 0.0f && u + v <= 1.0f
            && t > eps;
  }
}

// Walk `trips` listed clusters for this thread's R rays. `ring` is the
// block's staging ring; every thread of the block must call this with the
// same list (it synchronises), and no copy is in flight when it returns.
// Lanes with alive == false take no part in the early-exit vote; their
// results are meaningless. best_t / best_s come in as +inf / kBigId, or as
// the result of an earlier walk for the same rays (another list, another
// part of the table, another block's published key): the (min t, min slot)
// rule does not depend on the order of the visits, and a hit found earlier
// is a real hit, so the vote stays exact. `share` is called with
// (best_t, best_s) just before each vote: a walk split over blocks
// publishes and folds in the other blocks' hits there. The block has set
// the ring's box and id base (ring_setup): a listed id plus the id base
// indexes `geo`, whose rows must be 16-byte aligned (cs a multiple of 4),
// and a triangle's slot is (id + id base) * cs + lane. F is the intersector
// family (the rows of geo it reads). Nearest accepts t < t_cap only where
// CAPPED.
// Occlusion (NEAREST false) accepts t < t_lim[r] and never exits early.
// With LC, a warp skips a visit none of its alive rays enters (lanes_enter
// on lcb, the [C, 6] boxes indexed like geo). Returns the number of
// clusters visited (trips, or fewer after an early exit).
template <int R, int F, bool NEAREST, bool LC, bool CAPPED, class Share>
__device__ __forceinline__ int walk_list(
    WalkRing& ring, const float (&o)[R][3], const float (&d)[R][3],
    const bool (&alive)[R], const int* __restrict__ tile_ids,
    const float* __restrict__ tile_tnear, int trips,
    const float* __restrict__ geo, long long geo_stride, int cs, float eps,
    float t_cap, const float (&t_lim)[R], const float* __restrict__ lcb,
    bool use_exit, int ee_batch, float (&best_t)[R], int (&best_s)[R],
    Share share) {
  constexpr int kRows = family_rows(F);
  constexpr int kCol = family_column(F);
  const int cps = kMaxClusterSize / cs;  // clusters per stage
  const int q4 = cs / 4;                 // float4 per row
  const int per = kRows * q4;            // float4 per staged cluster
  const int n_stages = trips > 0 ? (trips + cps - 1) / cps : 0;
  // A first vote on what the rays bring with them: a list that starts
  // beyond every lane's hit is not walked at all. Behind its barrier an
  // earlier walk's reads of the ring are done too.
  bool settled = use_exit && trips > 0
                 && lanes_settled(alive, best_t, o, d, ring.box,
                                  tile_tnear[0]);
  if (__syncthreads_and(settled)) return 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    stage_start(ring, s, tile_ids, s * cps, min(cps, trips - s * cps), geo,
                geo_stride, cs, kRows);
  }
  int done = 0;
  int voted = 0;
  settled = false;
  for (int s = 0; s < n_stages; ++s) {
    // This thread's copies of stage s have landed; behind the barrier
    // everyone's have, and everyone is done with stage s - 1, whose buffer
    // the next copies take. The barrier carries the vote cast after
    // stage s - 1: every thread takes the same exit.
    cp_async_wait<kStages - 2>();
    if (__syncthreads_and(settled)) break;
    const int ahead = s + kStages - 1;
    stage_start(ring, ahead % kStages, tile_ids, ahead * cps,
                min(cps, trips - ahead * cps), geo, geo_stride, cs, kRows);
    const int b = s % kStages;
    const int nin = min(cps, trips - s * cps);
    for (int i = 0; i < nin; ++i) {
      if (LC && !__any_sync(0xffffffffu,
                            lanes_enter(o, d, alive,
                                        lcb + 6LL * ring.ids[b][i]))) {
        continue;
      }
      const int slot0 = ring.ids[b][i] * cs;
      const float4* g = ring.blk[b] + i * per;
      for (int k = 0; k < cs / kCol; ++k) {
        float tri[kRows][kCol];
#pragma unroll
        for (int q = 0; q < kRows; ++q) load_column(g + q * q4, k, tri[q]);
#pragma unroll
        for (int kk = 0; kk < kCol; ++kk) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float t;
            bool valid;
            intersect<F>(tri, kk, o[r], d[r], eps, t, valid);
            if (NEAREST) {
              const int slot = slot0 + kCol * k + kk;
              if (valid && (!CAPPED || t < t_cap)
                  && (t < best_t[r]
                      || (t == best_t[r] && t < inf() && slot < best_s[r]))) {
                best_t[r] = t;
                best_s[r] = slot;
              }
            } else if (valid && t < t_lim[r] && t < best_t[r]) {
              best_t[r] = t;
            }
          }
        }
      }
    }
    done = s * cps + nin;
    settled = false;
    if (use_exit && done < trips && done - voted >= ee_batch) {
      voted = done;
      share(best_t, best_s);
      settled = lanes_settled(alive, best_t, o, d, ring.box,
                              tile_tnear[done]);
    }
  }
  cp_async_wait<0>();  // an early exit leaves copies in flight: drain them
  return done;
}

// One block's share of a split list: segments first, first + tile_blocks,
// ... of the n_parts segments of `seg` positions that cover the `listed`
// positions of tile_ids (and tile_tnear), walked with walk_list and shared
// through `share` before each. A segment that settles (fewer visits made
// than listed) ends the block's walk of THIS list: the list is front to
// back, so its later segments lie farther still. (The lists of other groups
// of the table are no such thing; gstream.cu gives each group its own
// blocks.) Returns the clusters visited.
template <int R, int F, bool NEAREST, bool LC, bool CAPPED>
__device__ __forceinline__ int walk_segments(
    WalkRing& ring, const float (&o)[R][3], const float (&d)[R][3],
    const bool (&alive)[R], const int* __restrict__ tile_ids,
    const float* __restrict__ tile_tnear, int listed, int first, int n_parts,
    int tile_blocks, int seg, const float* __restrict__ geo,
    long long geo_stride, int cs, float eps, float t_cap,
    const float (&t_lim)[R], const float* __restrict__ lcb, bool use_exit,
    int ee_batch, float (&best_t)[R], int (&best_s)[R],
    const KeyShare& share) {
  int visited = 0;
  for (int part = first; part < n_parts; part += tile_blocks) {
    const int j0 = part * seg;
    const int trips = min(seg, listed - j0);
    share(best_t, best_s);  // what the tile's other blocks have found
    const int made = walk_list<R, F, NEAREST, LC, CAPPED>(
        ring, o, d, alive, tile_ids + j0,
        tile_tnear ? tile_tnear + j0 : nullptr, trips, geo, geo_stride, cs,
        eps, t_cap, t_lim, lcb, use_exit, ee_batch, best_t, best_s, share);
    visited += made;
    if (made < trips) break;  // settled
  }
  return visited;
}

// Write ray i's result: t, then the slot (nearest) or hit flag (occlusion),
// then the winner's n_attrs attribute rows (0 on a miss), read once here
// rather than carried through the loop.
__device__ __forceinline__ void store_result(
    long long i, long long np, float best_t, int best_s, bool nearest,
    const float* __restrict__ attr, long long attr_stride, int n_attrs,
    int cs, float* __restrict__ out_t, int* __restrict__ out_s,
    float* __restrict__ out_a) {
  out_t[i] = best_t;
  if (!nearest) {
    out_s[i] = best_t < inf() ? 1 : 0;
    return;
  }
  out_s[i] = best_s;
  if (n_attrs > 0) {
    const bool hit = best_s != kBigId;
    const int s = hit ? best_s : 0;
    const float* a = attr + static_cast<long long>(s / cs) * attr_stride
                     + s % cs;
    for (int q = 0; q < n_attrs; ++q) {
      out_a[q * np + i] = hit ? a[q * cs] : 0.0f;
    }
  }
}

// The end of one block of a split walk, for the rays it holds: ray r of
// this thread is i0 + r * kThreads, where threadIdx.x + r * kThreads <
// lanes. A tile (or camera pass) that one block walks (`split` false)
// writes its results directly. Otherwise the block merges the hits it holds
// that the keys do not (one it only folded in is there already) and counts
// itself in the tile's counter *finished; the tile's `parts`-th block to
// get there sees every other block's merges, unpacks the keys and reads
// the winners' attribute rows once (a gather is cheap on this card; the TPU
// kernels carried them through the loop because their gathers are serial).
template <int R, bool NEAREST>
__device__ __forceinline__ void finish_tile(
    bool split, long long i0, int lanes, long long np,
    const float (&best_t)[R], const int (&best_s)[R],
    unsigned long long* keys, int* finished, int parts,
    const float* __restrict__ attr, long long attr_stride, int n_attrs,
    int cs, float* out_t, int* __restrict__ out_s, float* __restrict__ out_a) {
  __shared__ bool last;
  if (!split) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (threadIdx.x + r * kThreads < lanes) {
        store_result(i0 + r * kThreads, np, best_t[r], best_s[r], NEAREST,
                     attr, attr_stride, n_attrs, cs, out_t, out_s, out_a);
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = i0 + r * kThreads;
    if (threadIdx.x + r * kThreads >= lanes
        || (NEAREST && !(pack_key(best_t[r], best_s[r]) < __ldcg(keys + i)))) {
      continue;
    }
    merge_result(i, NEAREST, best_t[r], best_s[r], keys, out_t);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(finished, 1) == parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (threadIdx.x + r * kThreads >= lanes) continue;
    const long long i = i0 + r * kThreads;
    if (NEAREST) {
      const unsigned long long key = __ldcg(keys + i);
      store_result(i, np, key_t(key), key_slot(key), true, attr, attr_stride,
                   n_attrs, cs, out_t, out_s, out_a);
    } else {
      out_s[i] = __ldcg(out_t + i) < inf() ? 1 : 0;
    }
  }
}

// Whether a nearest walk's t_max is a cap (finite): the capped instances.
inline bool is_capped(float t_max) {
  return t_max < __builtin_huge_valf();
}

// What every walk entry refuses: a cluster size the ring cannot stage, a
// table whose rows the 16-byte copies cannot address, or an unknown
// intersector family.
inline bool walk_tables_ok(const float* geo, long long geo_stride, int cs,
                           int family) {
  return cs > 0 && cs <= kMaxClusterSize && cs % 4 == 0
         && geo_stride % 4 == 0 && family >= 0 && family < kFamilies
         && geo_stride >= static_cast<long long>(family_rows(family)) * cs
         && reinterpret_cast<unsigned long long>(geo) % 16 == 0;
}

}  // namespace rt
