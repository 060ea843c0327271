// K6: per-tile masked ray extents, the frustum inputs of phase 1.
//
// Replaces raytracing_tpu/kernels/traverse.py:_extents_kernel (reached
// through _tile_extents_pallas). For each ray_tile-ray tile of the SoA pack
// [8, N] (rows ox oy oz 1 dx dy dz ALIVE) it writes the min and max of the
// 8 rows over alive lanes (row 7 != 0); dead lanes count as +/-3e38, so
// hi[:, 7] > 0 is the tile-alive flag.
//
// Bound on the card: device-memory reads, 32 bytes per ray and nothing
// reused. One block per tile of ray_tile / 4 threads; each thread reduces
// its 4 rays per row (common.cuh's ray_index), warps combine by shuffles
// and 8 threads combine the block's warps.
#include "common.cuh"

namespace rt {
namespace {

__global__ void __launch_bounds__(kThreads)
extents_kernel(const float* __restrict__ rays, long long np,
               float* __restrict__ lo, float* __restrict__ hi) {
  __shared__ float s_lo[kThreads / 32][8];
  __shared__ float s_hi[kThreads / 32][8];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  bool alive[kRaysPerThread];
#pragma unroll
  for (int r = 0; r < kRaysPerThread; ++r) {
    alive[r] = rays[7 * np + ray_index(blockIdx.x, r)] != 0.0f;
  }
  for (int row = 0; row < 8; ++row) {
    float m_lo = big();
    float m_hi = -big();
#pragma unroll
    for (int r = 0; r < kRaysPerThread; ++r) {
      const float v = rays[row * np + ray_index(blockIdx.x, r)];
      if (alive[r]) {
        m_lo = fminf(m_lo, v);
        m_hi = fmaxf(m_hi, v);
      }
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
  __syncthreads();
  if (threadIdx.x < 8) {
    const int row = threadIdx.x;
    float m_lo = s_lo[0][row];
    float m_hi = s_hi[0][row];
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) {
      m_lo = fminf(m_lo, s_lo[w][row]);
      m_hi = fmaxf(m_hi, s_hi[w][row]);
    }
    lo[blockIdx.x * 8LL + row] = m_lo;
    hi[blockIdx.x * 8LL + row] = m_hi;
  }
}

}  // namespace
}  // namespace rt

// rays [8, np] f32 in tiles of ray_tile (common.cuh's ray_tile_ok) -> lo,
// hi [np / ray_tile, 8] f32.
extern "C" int rt_tile_extents(const float* rays, long long np, int ray_tile,
                               float* lo, float* hi, void* stream) {
  if (!rt::ray_tile_ok(np, ray_tile)) return cudaErrorInvalidValue;
  const unsigned nt = static_cast<unsigned>(np / ray_tile);
  rt::extents_kernel<<<nt, rt::tile_threads(ray_tile), 0,
                       static_cast<cudaStream_t>(stream)>>>(rays, np, lo, hi);
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
