// A tile's masked extents (K6's reduction), shared by extents.cu and
// lists.cu: the min and max of the 8 rows of the SoA pack [8, np] (rows ox
// oy oz 1 dx dy dz ALIVE) over the tile's alive lanes (row 7 != 0); dead
// lanes count as +/-3e38, so hi[7] > 0 is the tile-alive flag.
//
// Latency, not bandwidth, bounds a tile at the shapes the main path
// launches (64 tiles of a 65,536-ray chunk on 132 multiprocessors): each
// thread takes 4 consecutive lanes with one 16-byte load a row and issues
// all 8 rows' loads before it combines any, and the warps fold the 16
// running values (8 min, 8 max) in one interleaved shuffle chain. Min and
// max do not depend on lane order, so the lanes need not follow
// common.cuh's ray_index.
#pragma once

#include "common.cuh"

namespace rt {

// Values a thread folds: lo of the 8 rows, then hi.
constexpr int kExtVals = 16;

// Fold the lanes of tile `tile` (ray_tile lanes from tile * ray_tile) that
// this thread owns (4-lane groups threadIdx.x, + blockDim.x, ...) into
// v[0..7] (min) and v[8..15] (max). The pack is 16-byte aligned and np a
// multiple of 4.
__device__ __forceinline__ void extents_fold_lanes(
    const float* __restrict__ rays, long long np, int ray_tile,
    long long tile, float v[kExtVals]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    v[r] = big();
    v[8 + r] = -big();
  }
  for (int q = threadIdx.x; q < ray_tile / 4; q += blockDim.x) {
    const long long col = tile * ray_tile + 4LL * q;
    float4 x[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      x[r] = __ldg(reinterpret_cast<const float4*>(rays + r * np + col));
    }
    const bool a0 = x[7].x != 0.0f, a1 = x[7].y != 0.0f;
    const bool a2 = x[7].z != 0.0f, a3 = x[7].w != 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (a0) { v[r] = fminf(v[r], x[r].x); v[8 + r] = fmaxf(v[8 + r], x[r].x); }
      if (a1) { v[r] = fminf(v[r], x[r].y); v[8 + r] = fmaxf(v[8 + r], x[r].y); }
      if (a2) { v[r] = fminf(v[r], x[r].z); v[8 + r] = fmaxf(v[8 + r], x[r].z); }
      if (a3) { v[r] = fminf(v[r], x[r].w); v[8 + r] = fmaxf(v[8 + r], x[r].w); }
    }
  }
}

// The block's extents: every thread folds its lanes, the warps fold theirs
// by shuffles, and threads 0-15 fold the warps': thread i < 8 returns lo[i],
// 8 <= i < 16 hi[i - 8] (other threads: unspecified). s_red holds
// [blockDim.x / 32][16] floats. Ends after a __syncthreads.
__device__ __forceinline__ float block_tile_extents(
    const float* __restrict__ rays, long long np, int ray_tile,
    long long tile, float (*s_red)[kExtVals]) {
  float v[kExtVals];
  extents_fold_lanes(rays, np, ray_tile, tile, v);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kExtVals; ++i) {
      const float o = __shfl_xor_sync(0xffffffffu, v[i], off);
      v[i] = i < 8 ? fminf(v[i], o) : fmaxf(v[i], o);
    }
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kExtVals; ++i) s_red[warp][i] = v[i];
  }
  __syncthreads();
  float out = 0.0f;
  if (threadIdx.x < kExtVals) {
    const int i = threadIdx.x;
    out = s_red[0][i];
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) {
      out = i < 8 ? fminf(out, s_red[w][i]) : fmaxf(out, s_red[w][i]);
    }
  }
  return out;
}

}  // namespace rt
