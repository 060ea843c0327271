// K3: the streamed-groups walk — K1's function over a cluster table cut
// into G groups of gsz clusters, in one launch.
//
// Replaces raytracing_tpu/kernels/traverse.py:_gstream_kernel (launched by
// _launch_gstream from _walk_groups_streamed). On the TPU the group axis
// streams a table that does not fit on chip. Here its use is the L2: every
// block walks group 0, then group 1, ..., so the blocks resident at one
// time read the same slice of the table (a group is sized to stay in the
// card's L2 beside the rays and lists), instead of each tile pulling its
// own front-to-back run of clusters from all over device memory.
//
// One block per 1024-ray tile, 4 rays per thread, the rays and their
// (best_t, best_slot) in registers across the groups. For group g the
// block walks list row (g, tile), whose ids are group-local, against
// geo + g * gsz * geo_stride with slot base g * gsz * cs; the loop, both
// intersectors, the tie rule and the vote are walk_core.cuh's, the code K1
// runs. Visits are group-major, not globally front to back: the result
// equals K1's only because (min t, then min slot, +inf never ties) does not
// depend on the order of the visits. The early exit is per group, with that
// group's entry bounds and union box; a best_t found in an earlier group is
// a real hit, so the vote stays exact. The winner's attribute rows are read
// once after the last group, from the global slot. The last group may be
// padded with zero blocks: they are never listed, and a zero block fails
// |den| >= eps if it ever is.
//
// Bound on the card: scheduler slots, as K1 (walk_core.cuh, whose staged loop
// this runs); device memory sees each group's slice once if it stays in
// L2. A group whose first entry lies beyond every lane's carried hit is
// skipped by the loop's first vote.
#include "walk_core.cuh"

namespace rt {
namespace {

template <bool PMTO, bool NEAREST>
__global__ void __launch_bounds__(kThreads)
gstream_kernel(const float* __restrict__ rays, long long np,
               const float* __restrict__ tmax_row,
               const int* __restrict__ ids, const int* __restrict__ cnt,
               const float* __restrict__ tnear, int width, int n_groups,
               int gsz, const float* __restrict__ bbox,
               const float* __restrict__ geo, long long geo_stride,
               const float* __restrict__ attr, long long attr_stride,
               int n_attrs, int cs, float eps, float t_max, int early,
               int ee_batch, float* __restrict__ out_t,
               int* __restrict__ out_s, float* __restrict__ out_a,
               int* __restrict__ visits) {
  __shared__ WalkRing ring;
  const long long tile = blockIdx.x;
  const long long nt = gridDim.x;

  float o[kRaysPerThread][3];
  float d[kRaysPerThread][3];
  float best_t[kRaysPerThread];
  int best_s[kRaysPerThread];
  bool alive[kRaysPerThread];
  float t_lim[kRaysPerThread];
  load_pack_rays(rays, np, tmax_row, t_max, tile, o, d, alive, t_lim, best_t,
                 best_s);

  for (int g = 0; g < n_groups; ++g) {
    const long long gt = g * nt + tile;
    const long long row = gt * width;
    const int visited = walk_list<kRaysPerThread, PMTO, NEAREST>(
        ring, o, d, alive, ids + row, tnear ? tnear + row : nullptr, cnt[gt],
        bbox ? bbox + 6 * g : nullptr,
        geo + static_cast<long long>(g) * gsz * geo_stride, geo_stride,
        g * gsz * cs, cs, eps, t_lim, early && NEAREST, ee_batch, best_t,
        best_s, NoShare{});
    if (visits != nullptr && threadIdx.x == 0) visits[gt] = visited;
  }

#pragma unroll
  for (int r = 0; r < kRaysPerThread; ++r) {
    store_result(ray_index(r), np, best_t[r], best_s[r], NEAREST, attr,
                 attr_stride, n_attrs, cs, out_t, out_s, out_a);
  }
}

}  // namespace
}  // namespace rt

// rays [8, np]; tmax_row [np] or null; ids [G, nt, width] i32 group-local
// with cnt [G, nt] listed clusters per (group, tile); tnear [G, nt, width]
// and bbox [G, 6] (each group's union-box min | max; only read when
// early != 0); geo and attr hold G * gsz clusters as rt_walk takes them
// (the last group padded). Outputs t [np], global slot or hit flag [np]
// i32, attrs [n_attrs, np], and, where visits is not null, the clusters
// each (group, tile) visited [G, nt] i32. Slots must fit below 2^30.
extern "C" int rt_walk_gstream(const float* rays, long long np,
                               const float* tmax_row, const int* ids,
                               const int* cnt, const float* tnear, int width,
                               int n_groups, int gsz, const float* bbox,
                               const float* geo, long long geo_stride,
                               const float* attr, long long attr_stride,
                               int n_attrs, int cs, float eps, float t_max,
                               int nearest, int early, int ee_batch, int pmto,
                               float* out_t, int* out_s, float* out_a,
                               int* visits, void* stream) {
  if (np <= 0 || np % rt::kRayTile != 0 || width <= 0 || ee_batch <= 0
      || !rt::walk_tables_ok(geo, geo_stride, cs) || n_groups <= 0 || gsz <= 0
      || static_cast<long long>(n_groups) * gsz * cs >= rt::kBigId) {
    return cudaErrorInvalidValue;
  }
  const unsigned nt = static_cast<unsigned>(np / rt::kRayTile);
  auto kern = nearest ? (pmto ? rt::gstream_kernel<true, true>
                                : rt::gstream_kernel<false, true>)
                      : (pmto ? rt::gstream_kernel<true, false>
                                : rt::gstream_kernel<false, false>);
  kern<<<nt, rt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, np, tmax_row, ids, cnt, tnear, width, n_groups, gsz, bbox, geo,
      geo_stride, attr, attr_stride, n_attrs, cs, eps, t_max, early, ee_batch,
      out_t, out_s, out_a, visits);
  return static_cast<int>(cudaGetLastError());
}
