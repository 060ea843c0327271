// K3: the streamed-groups walk — K1's function over a cluster table cut
// into G groups of gsz clusters, in one launch.
//
// Replaces raytracing_tpu/kernels/traverse.py:_gstream_kernel (launched by
// _launch_gstream from _walk_groups_streamed). On the TPU the group axis
// streams a table that does not fit on chip; each (group, tile) pair has
// its own list, front to back within the group, with ids local to the
// group, and the walk of group g reads geo + g * gsz * geo_stride with slot
// base g * gsz * cs. The loop, the four intersector families (pmt, pmto,
// mt, woop, as the TPU's K3 runs them), the tie rule and the vote are
// walk_core.cuh's, the code K1 runs; a group's ids are offset by its
// first cluster where the loop stages them. The result equals K1's over the
// whole table because (min t, then min slot, +inf never ties) does not
// depend on the order of the visits. The last group may be padded with
// zero blocks: they are never listed, and a zero block fails |den| >= eps
// if it ever is.
//
// What bounds it on this card: scheduler slots, as K1 (walk.cu), and so
// K1's design: the unit of work is (tile, group, segment of that group's
// list); each (group, tile) list is dealt to up to `tile_blocks` blocks.
// One block per tile walking the groups one after the other waited on the
// longest lists and ran the 1.6M Whitted frame's 64-tile chunks on 64 of
// 132 SMs. The grid is group-outer and segment-major within a group: group
// 0's blocks come first, every tile's block 0 before any block 1, then
// group 1's. The blocks running at one time walk one group's part of the
// table, and a group's later segments skip on the hits its earlier ones and
// the earlier groups have published (2,560,000 primaries at 1.6M / 6.4M
// triangles, NVIDIA H100 80GB HBM3, 700 W, tools/kernel_ab.py against a
// segment-outer grid, every group's block 0 first: 12,924 / 35,556 visits
// and 3.60-3.65 / 11.09-11.49 ms against 13,819 / 51,720 and 3.95 /
// 14.72-14.82).
//
// All the blocks of a tile, in every group, merge per ray through one set
// of walk_core.cuh's keys and share them for the early exit, which stays
// exact: a block votes with its own group's entry bounds and union box, and
// a hit it folded in from another group is a real hit of that ray. A block
// that settles leaves only its own group's list: the lists are front to
// back within a group, not across groups, so the tile's other groups are
// walked by their own blocks whatever this one found. The tile's counter
// counts its blocks over every group, and the last one unpacks the keys and
// reads the winner's attribute rows once, from the global slot. A tile that
// lists nothing in any group runs one block (group 0's), which reads miss /
// not occluded; a tile whose lists all fit one block writes directly.
#include "walk_core.cuh"

namespace rt {
namespace {

// blockIdx.x = (group * tile_blocks + the block's index within its
// (group, tile) list) * nt + tile.
template <int F, bool NEAREST, bool CAPPED>
__global__ void __launch_bounds__(kThreads)
gstream_kernel(const float* __restrict__ rays, long long np, unsigned nt,
               const float* __restrict__ tmax_row,
               const int* __restrict__ ids, const int* __restrict__ cnt,
               const float* __restrict__ tnear, int width, int seg,
               int tile_blocks, int n_groups, int gsz,
               const float* __restrict__ bbox,
               const float* __restrict__ geo, long long geo_stride,
               const float* __restrict__ attr, long long attr_stride,
               int n_attrs, int cs, float eps, float t_max, int early,
               int ee_batch, unsigned long long* keys,
               int* __restrict__ finished, float* out_t,
               int* __restrict__ out_s, float* __restrict__ out_a,
               int* __restrict__ visits) {
  __shared__ WalkRing ring;
  // nt = np / ray_tile tiles: a parameter, so that no register holds it
  // through the walk (K3's pmto nearest instance spilled).
  const int tile_rays = block_tile();
  const long long tile = blockIdx.x % nt;
  const unsigned rest = blockIdx.x / nt;
  const int g = rest / tile_blocks;
  const int first = rest % tile_blocks;  // this block's first segment
  const long long gt = g * nt + tile;
  const int listed = min(cnt[gt], width);
  int n_parts = list_parts(listed, seg);
  // Most blocks of the grid find no segment of their list: they leave
  // before reading the tile's other lists. Group 0's block 0 stays for a
  // tile that may list nothing at all.
  if (first >= min(n_parts, tile_blocks) && (first > 0 || g > 0)) return;
  int parts = 0;  // the tile's blocks over every group's list
  for (int k = 0; k < n_groups; ++k) {
    parts += min(list_parts(min(cnt[k * nt + tile], width), seg),
                 tile_blocks);
  }
  if (parts == 0) {  // nothing listed: this block reads miss
    parts = n_parts = 1;
  } else if (first >= min(n_parts, tile_blocks)) {
    return;  // the whole block
  }
  const bool split = parts > 1;
  const bool use_exit = early && NEAREST;

  float o[kRaysPerThread][3];
  float d[kRaysPerThread][3];
  float best_t[kRaysPerThread];
  int best_s[kRaysPerThread];
  bool alive[kRaysPerThread];
  float t_lim[kRaysPerThread];
  load_pack_rays(rays, np, tmax_row, t_max, tile, o, d, alive, t_lim, best_t,
                 best_s);
  const long long i0 = ray_index(tile, 0);
  const KeyShare<kPackStride> share{split && use_exit ? keys + i0 : nullptr,
                                    tile_rays};
  const long long row = gt * width;
  // The group's box and first cluster: its ids are local to it.
  ring_setup(ring, use_exit ? bbox + 6 * g : nullptr, g * gsz);
  const int visited = walk_segments<kRaysPerThread, F, NEAREST, false,
                                    CAPPED>(
      ring, o, d, alive, ids + row, tnear ? tnear + row : nullptr, listed,
      first, n_parts, tile_blocks, seg, geo, geo_stride, cs, eps, t_max,
      t_lim, nullptr, use_exit, ee_batch, best_t, best_s, share);
  if (visits != nullptr && threadIdx.x == 0) {  // the group read back
    atomicAdd(visits + (ring.id_base / gsz) * nt + tile, visited);
  }
  finish_tile<kRaysPerThread, NEAREST, kPackStride>(
      split, i0, tile_rays, np, best_t, best_s, keys, finished + tile, parts,
      attr, attr_stride, n_attrs, cs, out_t, out_s, out_a);
}

using GstreamKernel = decltype(&gstream_kernel<kPmt, true, false>);

// The instance of family f (walk_core.cuh's Family).
template <bool NEAREST, bool CAPPED>
GstreamKernel gstream_instance(int f) {
  switch (f) {
    case kPmto: return gstream_kernel<kPmto, NEAREST, CAPPED>;
    case kMt: return gstream_kernel<kMt, NEAREST, CAPPED>;
    case kWoop: return gstream_kernel<kWoop, NEAREST, CAPPED>;
    default: return gstream_kernel<kPmt, NEAREST, CAPPED>;
  }
}

}  // namespace
}  // namespace rt

// rays [8, np] in tiles of ray_tile (common.cuh's ray_tile_ok), nt =
// np / ray_tile; tmax_row [np] or null; ids [G, nt, width] i32 group-local
// with cnt [G, nt] listed clusters per (group, tile), each list in segments
// of `seg` dealt to `tile_blocks` blocks; tnear [G, nt, width] and bbox
// [G, 6] (each group's union-box min | max; only read when early != 0); geo
// and attr hold G * gsz clusters as rt_walk takes them (the last group
// padded); family and t_max as rt_walk takes them. Scratch the launch
// fills: keys, np 8-byte words, 8-byte aligned (nearest only; may be null
// for occlusion), and finished [nt] i32. Outputs
// t [np], global slot or hit flag [np] i32, attrs [n_attrs, np], and, where
// visits is not null, the clusters each (group, tile) visited [G, nt] i32
// (they differ from run to run under the early exit). Slots must fit below
// 2^30. Two launches on the stream: fill, blocks.
extern "C" int rt_walk_gstream(const float* rays, long long np,
                               int ray_tile, const float* tmax_row,
                               const int* ids, const int* cnt,
                               const float* tnear, int width,
                               int seg, int tile_blocks, int n_groups,
                               int gsz, const float* bbox, const float* geo,
                               long long geo_stride, const float* attr,
                               long long attr_stride, int n_attrs, int cs,
                               float eps, float t_max, int nearest, int early,
                               int ee_batch, int family,
                               unsigned long long* keys, int* finished,
                               float* out_t, int* out_s, float* out_a,
                               int* visits, void* stream) {
  if (!rt::ray_tile_ok(np, ray_tile) || width <= 0 || ee_batch <= 0
      || seg <= 0 || tile_blocks <= 0 || finished == nullptr
      || !rt::walk_tables_ok(geo, geo_stride, cs, family) || n_groups <= 0
      || gsz <= 0
      || static_cast<long long>(n_groups) * gsz * cs >= rt::kBigId
      || (nearest && (keys == nullptr
                      || reinterpret_cast<unsigned long long>(keys) % 8))) {
    return cudaErrorInvalidValue;
  }
  const long long nt = np / ray_tile;
  if (nt * n_groups * tile_blocks > 2147483647ll) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  rt::launch_walk_fill(np, nearest != 0, keys, out_t, nt, finished,
                       nt * n_groups, visits, s);
  auto kern = !nearest ? rt::gstream_instance<false, false>(family)
              : rt::is_capped(t_max) ? rt::gstream_instance<true, true>(family)
                                     : rt::gstream_instance<true, false>(family);
  kern<<<static_cast<unsigned>(nt * n_groups * tile_blocks),
         rt::tile_threads(ray_tile), 0, s>>>(
      rays, np, static_cast<unsigned>(nt), tmax_row, ids, cnt, tnear,
      width, seg, tile_blocks, n_groups, gsz, bbox, geo, geo_stride, attr,
      attr_stride, n_attrs, cs, eps, t_max, early, ee_batch, keys, finished,
      out_t, out_s, out_a, visits);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a multiprocessor holds of the instance rt_walk_gstream
// launches for (family, nearest, capped) at `threads` a block
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int rt_gstream_occupancy(int family, int nearest, int capped,
                                    int threads, int* blocks) {
  auto kern = !nearest ? rt::gstream_instance<false, false>(family)
              : capped ? rt::gstream_instance<true, true>(family)
                       : rt::gstream_instance<true, false>(family);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, threads, 0));
}
