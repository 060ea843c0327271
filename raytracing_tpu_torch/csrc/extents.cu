// K6: per-tile masked ray extents, the frustum inputs of phase 1.
//
// Replaces raytracing_tpu/kernels/traverse.py:_extents_kernel (reached
// through _tile_extents_pallas). For each ray_tile-ray tile of the SoA pack
// [8, N] (rows ox oy oz 1 dx dy dz ALIVE) it writes the min and max of the
// 8 rows over alive lanes (row 7 != 0); dead lanes count as +/-3e38, so
// hi[:, 7] > 0 is the tile-alive flag.
//
// The query paths build their lists with lists.cu, which folds this
// reduction into the list build; this entry serves the tiles a wrapper
// composes from launch tiles (traverse._split_tile) and the streamed-groups
// lists. Bound on the card: device-memory reads, 32 bytes per ray and
// nothing reused; at the launches it gets (tens of tiles) the latency of a
// block's loads and shuffles instead, which tile_extents.cuh's reduction
// overlaps. One block per tile of ray_tile / 4 threads, 4 lanes a thread.
#include "tile_extents.cuh"

namespace rt {
namespace {

__global__ void __launch_bounds__(kThreads)
extents_kernel(const float* __restrict__ rays, long long np, int ray_tile,
               float* __restrict__ lo, float* __restrict__ hi) {
  __shared__ float s_red[kThreads / 32][kExtVals];
  const float v = block_tile_extents(rays, np, ray_tile, blockIdx.x, s_red);
  if (threadIdx.x < 8) {
    lo[blockIdx.x * 8LL + threadIdx.x] = v;
  } else if (threadIdx.x < kExtVals) {
    hi[blockIdx.x * 8LL + threadIdx.x - 8] = v;
  }
}

}  // namespace
}  // namespace rt

// rays [8, np] f32 in tiles of ray_tile (common.cuh's ray_tile_ok), 16-byte
// aligned -> lo, hi [np / ray_tile, 8] f32.
extern "C" int rt_tile_extents(const float* rays, long long np, int ray_tile,
                               float* lo, float* hi, void* stream) {
  if (!rt::ray_tile_ok(np, ray_tile)
      || reinterpret_cast<unsigned long long>(rays) % 16) {
    return cudaErrorInvalidValue;
  }
  const unsigned nt = static_cast<unsigned>(np / ray_tile);
  rt::extents_kernel<<<nt, rt::tile_threads(ray_tile), 0,
                       static_cast<cudaStream_t>(stream)>>>(rays, np,
                                                            ray_tile, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a multiprocessor holds of the kernel at `threads` a
// block (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int rt_extents_occupancy(int threads, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rt::extents_kernel, threads, 0));
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
