// K1 + K2: the visit-list walk — nearest hit with shading attributes, or
// occlusion — over a ray tile's front-to-back list of clusters.
//
// Replaces raytracing_tpu/kernels/traverse.py:_walk_kernel (K1, launched
// by _launch_single from _walk_groups) and :_dma_walk_kernel (K2, from
// _walk_dma). The two TPU kernels compute the same function; they differ
// in how a visit's block reaches VMEM. Here both entries launch this one
// kernel: K1 passes the [C, 12, CS] Baldwin–Weber table and a separate
// [C, A, CS] attribute table, K2 one combined [C, 12 + A, CS] table whose
// attribute rows follow the geometry rows (the strides say which).
//
// One block per 1024-ray tile; each of 256 threads owns 4 rays. The loop
// over the list, the two intersectors (pmt, and pmto for a pack whose rays
// share one origin that the caller folded into the table) and the early
// exit are walk_core.cuh's. The winner's attribute rows are read once
// after the loop (a gather is cheap on this card; the TPU kernel carried
// them through the loop because its gathers are serial). Lists are as wide
// as the cluster table, so the TPU's overflow rescan has no counterpart.
//
// Bound on the card: arithmetic, ~40 operations per (ray, triangle) from
// registers and shared memory (~30 with pmto); device memory sees each
// visit's block once per tile. Double-buffering the visit blocks with
// cp.async is later work.
#include "walk_core.cuh"

namespace rt {
namespace {

template <bool PMTO>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const float* __restrict__ rays, long long np,
            const float* __restrict__ tmax_row,
            const int* __restrict__ ids, const int* __restrict__ cnt,
            const float* __restrict__ tnear, int width,
            const float* __restrict__ bbox,
            const float* __restrict__ geo, long long geo_stride,
            const float* __restrict__ attr, long long attr_stride,
            int n_attrs, int cs, float eps, float t_max,
            int nearest, int early, int ee_batch,
            float* __restrict__ out_t, int* __restrict__ out_s,
            float* __restrict__ out_a, int* __restrict__ visits) {
  __shared__ float blk[12 * kMaxClusterSize];
  const int tile = blockIdx.x;

  float o[kRaysPerThread][3];
  float d[kRaysPerThread][3];
  float best_t[kRaysPerThread];
  int best_s[kRaysPerThread];
  bool alive[kRaysPerThread];
  float t_lim[kRaysPerThread];
#pragma unroll
  for (int r = 0; r < kRaysPerThread; ++r) {
    const long long i = ray_index(r);
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

  const long long row = static_cast<long long>(tile) * width;
  const int visited = walk_list<kRaysPerThread, PMTO>(
      blk, o, d, alive, ids + row, tnear ? tnear + row : nullptr, cnt[tile],
      bbox, geo, geo_stride, 0, cs, eps, t_lim, nearest != 0,
      early && nearest, ee_batch, best_t, best_s);
  if (visits != nullptr && threadIdx.x == 0) visits[tile] = visited;

#pragma unroll
  for (int r = 0; r < kRaysPerThread; ++r) {
    store_result(ray_index(r), np, best_t[r], best_s[r], nearest != 0, attr,
                 attr_stride, n_attrs, cs, out_t, out_s, out_a);
  }
}

}  // namespace
}  // namespace rt

// rays [8, np]; tmax_row [np] or null: each ray's own occlusion limit in
// place of the scalar t_max; ids [nt, width] i32 with cnt [nt] <= width
// listed clusters per tile; tnear [nt, width] and bbox [6] (only read when
// early != 0); geo: cluster c's 12 geometry rows at geo + c * geo_stride,
// each cs floats; attr likewise with attr_stride
// (n_attrs rows; unused for occlusion). pmto != 0 selects the origin-folded
// intersector (the caller folded the shared origin into geo). Outputs
// t [np], slot or hit flag [np] i32, attrs [n_attrs, np], and, where
// visits is not null, the clusters each tile visited [nt] i32.
extern "C" int rt_walk(const float* rays, long long np,
                       const float* tmax_row, const int* ids,
                       const int* cnt, const float* tnear, int width,
                       const float* bbox, const float* geo,
                       long long geo_stride, const float* attr,
                       long long attr_stride, int n_attrs, int cs,
                       float eps, float t_max, int nearest, int early,
                       int ee_batch, int pmto, float* out_t, int* out_s,
                       float* out_a, int* visits, void* stream) {
  if (np <= 0 || np % rt::kRayTile != 0 || cs <= 0
      || cs > rt::kMaxClusterSize || width <= 0 || ee_batch <= 0) {
    return cudaErrorInvalidValue;
  }
  const unsigned nt = static_cast<unsigned>(np / rt::kRayTile);
  auto kern = pmto ? rt::walk_kernel<true> : rt::walk_kernel<false>;
  kern<<<nt, rt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, np, tmax_row, ids, cnt, tnear, width, bbox, geo, geo_stride, attr,
      attr_stride, n_attrs, cs, eps, t_max, nearest, early,
      ee_batch, out_t, out_s, out_a, visits);
  return static_cast<int>(cudaGetLastError());
}
