// K4: the work-queue walk — K1's function with the visit index as the unit
// of work.
//
// Replaces raytracing_tpu/kernels/traverse.py:_wq_kernel (launched by
// _launch_wq from _walk_wq). A work item is `u` consecutive visits of one
// tile's list; the grid holds ceil(width / u) items per tile, and an item
// whose first visit lies past the tile's count returns at once. A long list
// is spread over many blocks, which run on different SMs at the same time.
// There is no early exit: every listed visit is walked. (walk.cu splits its
// lists the same way and keeps the exit; this kernel stays as the
// counterpart of the TPU's, three plain launches and no sharing between
// running blocks.)
//
// So the merge of a tile's items must not depend on their order: it is the
// key merge of walk_core.cuh, one atomicMin per ray and item on
// (bits(t) << 32) | slot, or for occlusion on bits(t) in the t output. The
// key starts empty and only accepted hits reach the atomic, so an infinite
// t never replaces anything and a tile with no visits reads miss. The
// split walks' fill launch (walk_core.cuh) empties the keys first; a second
// small kernel unpacks t and slot and reads the winner's attribute rows
// once.
//
// An item stages its visits' blocks and intersects them with
// walk_core.cuh's loop (pmt, pmto or mt: the families the TPU's K4 takes):
// the code K1 runs. Each item reads its tile's 1024 rays again (32 KB).
#include "walk_core.cuh"

namespace rt {
namespace {

// blockIdx.x = tile * steps + the item's step within its tile: a tile's
// items are neighbours in launch order, so its rays stay in L2, and the
// number of tiles is held only by the x axis's 2^31 - 1 blocks.
template <int F, bool NEAREST, bool CAPPED>
__global__ void __launch_bounds__(kThreads)
wq_items_kernel(const float* __restrict__ rays, long long np,
                const float* __restrict__ tmax_row,
                const int* __restrict__ ids, const int* __restrict__ cnt,
                int width, int u, const float* __restrict__ geo,
                long long geo_stride, int cs, float eps, float t_max,
                unsigned steps,
                unsigned long long* __restrict__ keys,
                float* __restrict__ out_t) {
  __shared__ WalkRing ring;
  const long long tile = blockIdx.x / steps;
  const int j0 = (blockIdx.x % steps) * u;
  const int listed = min(cnt[tile], width);
  if (j0 >= listed) return;  // the whole block: no barrier is skipped

  float o[kRaysPerThread][3];
  float d[kRaysPerThread][3];
  float best_t[kRaysPerThread];
  int best_s[kRaysPerThread];
  bool alive[kRaysPerThread];  // no vote here: a dead lane is walked too
  float t_lim[kRaysPerThread];
  load_pack_rays(rays, np, tmax_row, t_max, tile, o, d, alive, t_lim, best_t,
                 best_s);

  ring_setup(ring, nullptr, 0);
  walk_list<kRaysPerThread, F, NEAREST, false, CAPPED>(
      ring, o, d, alive, ids + tile * width + j0, nullptr,
      min(u, listed - j0), geo, geo_stride, cs, eps, t_max, t_lim, nullptr,
      false, 1, best_t, best_s, NoShare{});

#pragma unroll
  for (int r = 0; r < kRaysPerThread; ++r) {
    merge_result(tile * kRayTile + threadIdx.x + r * kThreads, NEAREST,
                 best_t[r], best_s[r], keys, out_t);
  }
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

using WqKernel = decltype(&wq_items_kernel<kPmt, true, false>);

// The instance of family f: pmt, pmto or mt.
template <bool NEAREST, bool CAPPED>
WqKernel wq_instance(int f) {
  switch (f) {
    case kPmto: return wq_items_kernel<kPmto, NEAREST, CAPPED>;
    case kMt: return wq_items_kernel<kMt, NEAREST, CAPPED>;
    default: return wq_items_kernel<kPmt, NEAREST, CAPPED>;
  }
}

}  // namespace
}  // namespace rt

// rays [8, np]; tmax_row [np] or null; ids [nt, width] i32 with cnt [nt]
// listed clusters per tile (every one of the first min(cnt, width) is
// walked); u visits per work item; geo, attr and t_max as rt_walk takes
// them, family 0 (pmt), 1 (pmto) or 2 (mt);
// keys: np 8-byte words of scratch, 8-byte aligned (nearest only; may be
// null for occlusion). Outputs t [np], slot or hit flag [np] i32, attrs
// [n_attrs, np]. Three launches on the stream: fill, items, finish.
extern "C" int rt_walk_wq(const float* rays, long long np,
                          const float* tmax_row, const int* ids,
                          const int* cnt, int width, int u, const float* geo,
                          long long geo_stride, const float* attr,
                          long long attr_stride, int n_attrs, int cs,
                          float eps, float t_max, int nearest, int family,
                          unsigned long long* keys, float* out_t, int* out_s,
                          float* out_a, void* stream) {
  const long long nt = np / rt::kRayTile;
  if (np <= 0 || np % rt::kRayTile != 0 || width <= 0 || u <= 0
      || !rt::walk_tables_ok(geo, geo_stride, cs, family)
      || family == rt::kWoop
      || (nearest && (keys == nullptr
                      || reinterpret_cast<unsigned long long>(keys) % 8))) {
    return cudaErrorInvalidValue;
  }
  const unsigned steps = static_cast<unsigned>((width + u - 1) / u);
  if (nt * steps > 2147483647ll) return cudaErrorInvalidValue;
  const unsigned flat = static_cast<unsigned>((np + rt::kThreads - 1)
                                              / rt::kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  rt::launch_walk_fill(np, nearest != 0, keys, out_t, 0, nullptr, 0,
                       nullptr, s);
  auto kern = !nearest ? rt::wq_instance<false, false>(family)
              : rt::is_capped(t_max) ? rt::wq_instance<true, true>(family)
                                     : rt::wq_instance<true, false>(family);
  kern<<<static_cast<unsigned>(nt * steps), rt::kThreads, 0, s>>>(
      rays, np, tmax_row, ids, cnt, width, u, geo, geo_stride, cs, eps,
      t_max, steps, keys, out_t);
  rt::wq_finish_kernel<<<flat, rt::kThreads, 0, s>>>(
      np, nearest, keys, attr, attr_stride, n_attrs, cs, out_t, out_s,
      out_a);
  return static_cast<int>(cudaGetLastError());
}
