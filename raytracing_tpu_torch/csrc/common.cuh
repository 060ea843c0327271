// Shared constants of the traversal kernels (walk.cu, refine.cu,
// extents.cu). Compiled with -fmad=false and without --use_fast_math, so
// every a*b+c rounds twice and every '/' is correctly rounded: the kernels
// then give the same bits as their plain PyTorch versions, op for op.
#pragma once

#include <cuda_runtime.h>

namespace rt {

// Rays per culling tile; one thread block walks one tile, each thread
// holding kRaysPerThread of its rays. The pack entries (extents.cu,
// refine.cu, walk.cu, gstream.cu, wq.cu) take the tile at run time
// (ray_tile_ok) and launch ray_tile / kRaysPerThread threads a block: 256
// for the default kRayTile, 64 for a tile of 256. camera.cu keeps blocks of
// kThreads and walks its tiles in passes of at most kRayTile rays.
constexpr int kRayTile = 1024;
constexpr int kThreads = 256;
constexpr int kRaysPerThread = kRayTile / kThreads;
// Largest cluster size the walk stages in shared memory.
constexpr int kMaxClusterSize = 128;
// Slot id of a ray that hit nothing.
constexpr int kBigId = 1 << 30;
// Largest cluster count of the dense refinement (its AABB table is staged
// in shared memory).
constexpr int kMaxRefineClusters = 512;

// The tiles the pack entries take: whole warps of kRaysPerThread-ray
// threads that divide kRayTile (the port pads a pack to whole kRayTile
// tiles), so 128, 256, 512 or 1024 rays; np must be a positive multiple.
inline bool ray_tile_ok(long long np, int ray_tile) {
  return (ray_tile == 128 || ray_tile == 256 || ray_tile == 512
          || ray_tile == kRayTile)
         && np > 0 && np % ray_tile == 0;
}

// Threads of a block that walks a tile of ray_tile rays.
inline int tile_threads(int ray_tile) { return ray_tile / kRaysPerThread; }

// Rays of this block's tile.
__device__ __forceinline__ int block_tile() {
  return kRaysPerThread * static_cast<int>(blockDim.x);
}

// Constants rounded from their double values, as the Python side rounds
// them (a float literal would round the decimal directly).
__device__ __forceinline__ float tiny() { return static_cast<float>(1e-20); }
__device__ __forceinline__ float big() { return static_cast<float>(3e38); }
__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// Lanes between a thread's rays in a tile.
constexpr int kRayStride = 32;

// Global index of ray r of this thread in tile `tile`: warp w of the block
// takes the kRaysPerThread * 32 consecutive lanes from
// kRaysPerThread * 32 * w, its ray r the 32 from there + 32 r, so a warp's
// row loads are coalesced and a thread's rays lie compile-time offsets
// apart whatever the tile (no register holds a stride read from blockDim:
// in the walks that spilled at the 128-register cap, and it made K6 8%
// slower at 1,024). Signed arithmetic: in unsigned, K3's pmto nearest
// instance spilled.
__device__ __forceinline__ long long ray_index(long long tile, int r) {
  const int t = threadIdx.x;
  return tile * block_tile() + (t & ~31) * kRaysPerThread + (t & 31)
         + r * kRayStride;
}

}  // namespace rt
