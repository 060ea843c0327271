// K4: the work-queue walk — K1's function with the visit index as the unit
// of work.
//
// Replaces raytracing_tpu/kernels/traverse.py:_wq_kernel (launched by
// _launch_wq from _walk_wq). A work item is `u` consecutive visits of one
// tile's list; the grid holds ceil(width / u) items per tile, and an item
// whose first visit lies past the tile's count returns at once. K1 and K2
// give a tile one block however long its list is; here a long list is
// spread over many blocks, which run on different SMs at the same time.
// There is no early exit: every listed visit is walked.
//
// So the merge of a tile's items must not depend on their order. Per ray
// one 64-bit key (bits(t) << 32) | slot is merged with atomicMin: an
// accepted t is > eps > 0, so its bit pattern orders as an unsigned
// integer, +inf is the largest, and the key's order is exactly the
// lexicographic (min t, then min slot) rule of walk_core.cuh. The key
// starts as (bits(+inf), kBigId) and only accepted hits reach the atomic,
// so an infinite t never replaces anything and a tile with no visits reads
// miss. Occlusion merges bits(t) alone with a 32-bit atomicMin in the t
// output, under each ray's own limit. A second small kernel unpacks t and
// slot and reads the winner's attribute rows once.
//
// An item stages its visits' blocks and intersects them with
// walk_core.cuh's loop (pmt or pmto): the code K1 runs. Each item reads
// its tile's 1024 rays again (32 KB).
#include "walk_core.cuh"

namespace rt {
namespace {

constexpr unsigned long long kEmptyKey =
    (0x7f800000ull << 32) | static_cast<unsigned long long>(kBigId);

__global__ void wq_init_kernel(long long np, int nearest,
                               unsigned long long* __restrict__ keys,
                               float* __restrict__ out_t) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= np) return;
  if (nearest) {
    keys[i] = kEmptyKey;
  } else {
    out_t[i] = inf();
  }
}

// blockIdx.x = tile * steps + the item's step within its tile: a tile's
// items are neighbours in launch order, so its rays stay in L2, and the
// number of tiles is held only by the x axis's 2^31 - 1 blocks.
template <bool PMTO>
__global__ void __launch_bounds__(kThreads)
wq_items_kernel(const float* __restrict__ rays, long long np,
                const float* __restrict__ tmax_row,
                const int* __restrict__ ids, const int* __restrict__ cnt,
                int width, int u, const float* __restrict__ geo,
                long long geo_stride, int cs, float eps, float t_max,
                int nearest, unsigned steps,
                unsigned long long* __restrict__ keys,
                float* __restrict__ out_t) {
  __shared__ float blk[12 * kMaxClusterSize];
  const int tile = blockIdx.x / steps;
  const int j0 = (blockIdx.x % steps) * u;
  const int listed = min(cnt[tile], width);
  if (j0 >= listed) return;  // the whole block: no barrier is skipped

  float o[kRaysPerThread][3];
  float d[kRaysPerThread][3];
  float best_t[kRaysPerThread];
  int best_s[kRaysPerThread];
  bool alive[kRaysPerThread];
  float t_lim[kRaysPerThread];
#pragma unroll
  for (int r = 0; r < kRaysPerThread; ++r) {
    const long long i = static_cast<long long>(tile) * kRayTile + threadIdx.x
                        + r * kThreads;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[r][k] = rays[k * np + i];
      d[r][k] = rays[(4 + k) * np + i];
    }
    alive[r] = true;  // no vote here; a dead lane is walked as K1 walks it
    t_lim[r] = tmax_row != nullptr ? tmax_row[i] : t_max;
    best_t[r] = inf();
    best_s[r] = kBigId;
  }

  walk_list<kRaysPerThread, PMTO>(
      blk, o, d, alive, ids + static_cast<long long>(tile) * width + j0,
      nullptr, min(u, listed - j0), nullptr, geo, geo_stride, 0, cs, eps,
      t_lim, nearest != 0, false, 1, best_t, best_s);

#pragma unroll
  for (int r = 0; r < kRaysPerThread; ++r) {
    // Only an accepted hit (t > eps, so its bits order as an unsigned
    // integer) reaches the atomic.
    if (!(best_t[r] < inf())) continue;
    const long long i = static_cast<long long>(tile) * kRayTile + threadIdx.x
                        + r * kThreads;
    const unsigned bits = __float_as_uint(best_t[r]);
    if (nearest) {
      atomicMin(keys + i, (static_cast<unsigned long long>(bits) << 32)
                              | static_cast<unsigned>(best_s[r]));
    } else {
      atomicMin(reinterpret_cast<unsigned*>(out_t) + i, bits);
    }
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
    store_result(i, np, __uint_as_float(static_cast<unsigned>(key >> 32)),
                 static_cast<int>(key & 0xffffffffull), true, attr,
                 attr_stride, n_attrs, cs, out_t, out_s, out_a);
  } else {
    out_s[i] = out_t[i] < inf() ? 1 : 0;
  }
}

}  // namespace
}  // namespace rt

// rays [8, np]; tmax_row [np] or null; ids [nt, width] i32 with cnt [nt]
// listed clusters per tile (every one of the first min(cnt, width) is
// walked); u visits per work item; geo and attr as rt_walk takes them;
// keys: np 8-byte words of scratch, 8-byte aligned (nearest only; may be
// null for occlusion). Outputs t [np], slot or hit flag [np] i32, attrs
// [n_attrs, np]. Three launches on the stream: fill, items, finish.
extern "C" int rt_walk_wq(const float* rays, long long np,
                          const float* tmax_row, const int* ids,
                          const int* cnt, int width, int u, const float* geo,
                          long long geo_stride, const float* attr,
                          long long attr_stride, int n_attrs, int cs,
                          float eps, float t_max, int nearest, int pmto,
                          unsigned long long* keys, float* out_t, int* out_s,
                          float* out_a, void* stream) {
  const long long nt = np / rt::kRayTile;
  if (np <= 0 || np % rt::kRayTile != 0 || cs <= 0
      || cs > rt::kMaxClusterSize || width <= 0 || u <= 0
      || (nearest && (keys == nullptr
                      || reinterpret_cast<unsigned long long>(keys) % 8))) {
    return cudaErrorInvalidValue;
  }
  const unsigned steps = static_cast<unsigned>((width + u - 1) / u);
  if (nt * steps > 2147483647ll) return cudaErrorInvalidValue;
  const unsigned flat = static_cast<unsigned>((np + rt::kThreads - 1)
                                              / rt::kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  rt::wq_init_kernel<<<flat, rt::kThreads, 0, s>>>(np, nearest, keys, out_t);
  auto kern = pmto ? rt::wq_items_kernel<true> : rt::wq_items_kernel<false>;
  kern<<<static_cast<unsigned>(nt * steps), rt::kThreads, 0, s>>>(
      rays, np, tmax_row, ids, cnt, width, u, geo, geo_stride, cs, eps,
      t_max, nearest, steps, keys, out_t);
  rt::wq_finish_kernel<<<flat, rt::kThreads, 0, s>>>(
      np, nearest, keys, attr, attr_stride, n_attrs, cs, out_t, out_s,
      out_a);
  return static_cast<int>(cudaGetLastError());
}
