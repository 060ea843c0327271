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
// What bounds it on this card: scheduler slots (walk_core.cuh), so the card
// must be kept full of that arithmetic. The TPU walks a tile's list on one
// core, in order; a block per tile here leaves the card to wait for the
// longest lists (0 to 100 clusters in a bounce level), and a query with few
// tiles and long lists (an area light's shadow rays: 64 tiles of ~200
// clusters) uses half of the 132 multiprocessors.
//
// So a tile's list is split over blocks. The unit of work is a segment:
// `seg` consecutive list positions of one tile. The grid holds `tile_blocks`
// blocks per tile, at most one per segment of the widest list the table
// allows; block b of a tile walks segments b, b + tile_blocks, ... of its
// list, and a block whose first segment lies past the tile's count returns
// at once, so the host never has to know the counts. The grid is
// segment-major: every tile's block 0 comes before any tile's block 1. A
// launch of many tiles then reaches a tile's later segments when its
// earlier ones have published their hits, and the early exit below skips
// them; tile-major order starts a tile's segments together and they skip
// nothing (2,560,000 coherent rays over a 12,640 x 128 table, NVIDIA H100
// 80GB HBM3, 700 W, tools/kernel_ab.py: 30,361 of 30,703 listed visits and
// 7.40 ms tile-major, 11,208 and 3.24 ms segment-major). A tile holds
// ray_tile rays (the caller's culling tile, common.cuh's ray_tile_ok; 1024
// by default, smaller for bounce levels whose 1024-ray frustums balloon):
// each of ray_tile / 4 threads owns 4 rays, so a smaller tile is one
// instance with fewer threads a block. The staged loop, the four intersector families
// (pmt, pmto, mt, woop: one instance each), the lane-cull pre-test and the
// cap of a two-phase query (instances of their own) are walk_core.cuh's. K1 runs every family; the TPU's K2 takes pmt, pmto and
// mt, whose combined table then holds 9 geometry rows before the
// attribute rows. The lane cull is the TPU's K1 option (lane_bounds not
// null), for nearest and occlusion queries alike.
//
// Segments merge per ray through the order-free key of walk_core.cuh
// (atomicMin on (bits(t) << 32) | slot; for occlusion a 32-bit atomicMin on
// bits(t) in the t output), so the result does not depend on the order in
// which they run. The front-to-back early exit stays, and stays exact: a
// segment of a nearest query with the exit publishes its hits and folds in
// the ones the tile's other segments have published before it starts and
// at each vote. The visits made may differ from run to run; the result
// does not. The fill launch, the key sharing, the segment loop and the
// tile's last block's finish are walk_core.cuh's, shared with camera.cu
// and gstream.cu. A tile whose list fits one segment skips keys and
// counter and writes its result directly. Lists are as wide as the cluster
// table, so the TPU's overflow rescan has no counterpart.
#include "walk_core.cuh"

namespace rt {
namespace {

// blockIdx.x = the block's index within its tile * nt + tile.
template <int F, bool NEAREST, bool LC, bool CAPPED>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const float* __restrict__ rays, long long np, unsigned nt,
            const float* __restrict__ tmax_row,
            const int* __restrict__ ids, const int* __restrict__ cnt,
            const float* __restrict__ tnear, int width, int seg,
            int tile_blocks, const float* __restrict__ bbox,
            const float* __restrict__ geo, long long geo_stride,
            const float* __restrict__ attr, long long attr_stride,
            int n_attrs, int cs, float eps, float t_max, int early,
            int ee_batch, const float* __restrict__ lcb,
            unsigned long long* keys, int* __restrict__ finished,
            float* out_t, int* __restrict__ out_s,
            float* __restrict__ out_a, int* __restrict__ visits) {
  __shared__ WalkRing ring;
  // nt = np / ray_tile tiles: a parameter, so that no register holds it
  // through the walk (K3's pmto nearest instance spilled).
  const int tile_rays = block_tile();
  const long long tile = blockIdx.x % nt;
  const int first = blockIdx.x / nt;  // this block's first segment
  const int listed = min(cnt[tile], width);
  // A tile's segment 0 always runs (a tile with no visits still reads
  // miss); a later one only if the list reaches it.
  const int n_parts = max(1, list_parts(listed, seg));
  const int parts = min(n_parts, tile_blocks);  // the tile's blocks that run
  if (first >= parts) return;  // the whole block: no barrier is skipped
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
  const long long row = tile * width;
  ring_setup(ring, use_exit ? bbox : nullptr, 0);
  const int visited = walk_segments<kRaysPerThread, F, NEAREST, LC, CAPPED>(
      ring, o, d, alive, ids + row, tnear ? tnear + row : nullptr, listed,
      first, n_parts, tile_blocks, seg, geo, geo_stride, cs, eps, t_max,
      t_lim, lcb, use_exit, ee_batch, best_t, best_s, share);
  if (visits != nullptr && threadIdx.x == 0) atomicAdd(visits + tile, visited);
  finish_tile<kRaysPerThread, NEAREST, kPackStride>(
      split, i0, tile_rays, np, best_t, best_s, keys, finished + tile, parts,
      attr, attr_stride, n_attrs, cs, out_t, out_s, out_a);
}

using WalkKernel = decltype(&walk_kernel<kPmt, true, false, false>);

// The instance of family f (walk_core.cuh's Family).
template <bool NEAREST, bool LC, bool CAPPED>
WalkKernel walk_instance(int f) {
  switch (f) {
    case kPmto: return walk_kernel<kPmto, NEAREST, LC, CAPPED>;
    case kMt: return walk_kernel<kMt, NEAREST, LC, CAPPED>;
    case kWoop: return walk_kernel<kWoop, NEAREST, LC, CAPPED>;
    default: return walk_kernel<kPmt, NEAREST, LC, CAPPED>;
  }
}

// The instance for a launch: nearest (capped where t_max is finite) or
// occlusion, with or without the lane cull.
WalkKernel walk_instance(int f, bool nearest, bool lc, bool capped) {
  if (!nearest) {
    return lc ? walk_instance<false, true, false>(f)
              : walk_instance<false, false, false>(f);
  }
  if (capped) {
    return lc ? walk_instance<true, true, true>(f)
              : walk_instance<true, false, true>(f);
  }
  return lc ? walk_instance<true, true, false>(f)
            : walk_instance<true, false, false>(f);
}

}  // namespace
}  // namespace rt

// rays [8, np] in tiles of ray_tile (common.cuh's ray_tile_ok), nt =
// np / ray_tile; tmax_row [np] or null: each ray's own occlusion limit in
// place of the scalar t_max; ids [nt, width] i32 with cnt [nt] listed
// clusters per tile (the first min(cnt, width) are walked), in segments of
// `seg`, each tile's segments dealt to `tile_blocks` blocks; tnear
// [nt, width] and bbox [6] (only read when early != 0); geo: cluster c's
// geometry rows of the family at geo + c * geo_stride (12 rows, mt's 9),
// each cs floats, 16-byte aligned; attr likewise with attr_stride (n_attrs
// rows; unused for occlusion). family: 0 pmt, 1 pmto (the caller folded
// the shared origin into geo), 2 mt, 3 woop (walk_core.cuh). t_max: a
// nearest query accepts only t < t_max (+inf: every hit), an occlusion
// query without tmax_row only t < t_max. lane_bounds [C, 6] (min | max of
// each cluster's box, indexed like geo) or null: the lane-cull pre-test.
// Scratch the launch fills: keys, np 8-byte words, 8-byte aligned (nearest
// only; may be null for occlusion), and finished [nt] i32. Outputs t [np],
// slot or hit flag [np] i32, attrs [n_attrs, np], and, where visits is not
// null, the clusters each tile visited [nt] i32 (they differ from run to
// run under the early exit). Two launches on the stream: fill, blocks.
extern "C" int rt_walk(const float* rays, long long np, int ray_tile,
                       const float* tmax_row, const int* ids,
                       const int* cnt, const float* tnear, int width, int seg,
                       int tile_blocks, const float* bbox, const float* geo,
                       long long geo_stride, const float* attr,
                       long long attr_stride, int n_attrs, int cs,
                       float eps, float t_max, int nearest, int early,
                       int ee_batch, int family, const float* lane_bounds,
                       unsigned long long* keys, int* finished, float* out_t,
                       int* out_s, float* out_a, int* visits, void* stream) {
  if (!rt::ray_tile_ok(np, ray_tile) || width <= 0 || ee_batch <= 0
      || seg <= 0 || tile_blocks <= 0 || finished == nullptr
      || !rt::walk_tables_ok(geo, geo_stride, cs, family)
      || (nearest && (keys == nullptr
                      || reinterpret_cast<unsigned long long>(keys) % 8))) {
    return cudaErrorInvalidValue;
  }
  const long long nt = np / ray_tile;
  if (nt * tile_blocks > 2147483647ll) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  rt::launch_walk_fill(np, nearest != 0, keys, out_t, nt, finished, nt,
                       visits, s);
  auto kern = rt::walk_instance(family, nearest != 0, lane_bounds != nullptr,
                                rt::is_capped(t_max));
  kern<<<static_cast<unsigned>(nt * tile_blocks), rt::tile_threads(ray_tile),
         0, s>>>(
      rays, np, static_cast<unsigned>(nt), tmax_row, ids, cnt, tnear,
      width, seg, tile_blocks, bbox, geo, geo_stride, attr, attr_stride,
      n_attrs, cs, eps, t_max, early, ee_batch, lane_bounds, keys, finished,
      out_t, out_s, out_a, visits);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a multiprocessor holds of the instance rt_walk launches
// for (family, nearest, lane cull, capped) at `threads` a block
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; the ring is static shared
// memory).
extern "C" int rt_walk_occupancy(int family, int nearest, int lane_cull,
                                 int capped, int threads, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rt::walk_instance(family, nearest != 0, lane_cull != 0,
                                capped != 0),
      threads, 0));
}
