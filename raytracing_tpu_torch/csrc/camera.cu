// K1 camera + K2 camera: the primary-ray walk with the rays derived in the
// kernel from the pinhole camera, so no ray pack is read from device
// memory (or ever written).
//
// Replaces raytracing_tpu/kernels/traverse.py:_walk_kernel and
// :_dma_walk_kernel as launched with camera= by _launch_camera, with
// :_camera_dirs. The two TPU kernels compute the same function; here both
// entries launch this one kernel: K1 camera passes the origin-folded
// [C, 12, CS] table and a separate [C, A, CS] attribute table, K2 camera
// one combined [C, 12 + A, CS] table (the strides say which).
//
// A tile = one bh x bw pixel block x spp samples, rt = spp*bh*bw rays, a
// run-time value: lane l is sample l / (bh*bw) of pixel
// divmod(l % (bh*bw), bw) of block divmod(tile, W/bw), and
// tile = min(local + tile_base, blocks - 1) for launch-local tile `local`,
// so a chunk that overruns the frame repeats the last block. The direction
// is camera_dir.cuh's (shared with rest.cu), bit-equal to the materialised
// pack. offs [spp, 2] is read from device memory at every launch. The origin is 0 and every lane
// is alive; the intersector is walk_core.cuh's pmto (the only family the
// TPU's camera walks run). With lane_bounds, the lane-cull pre-test of
// walk_core.cuh skips a visit no ray of a warp enters (the TPU's K1 camera
// option, traverse.py:3673).
//
// Each of 256 threads owns R rays, R = ceil(rt / 256) between 2 and 4
// (tiles of at most 256 rays take R = 2 with dead lanes: R = 1 spilled); a
// tile of more than 1024 rays is walked in passes of 1024, each pass with
// its own rays and its own walk of the tile's list (results are per ray,
// so that is exact).
//
// What bounds it on this card: scheduler slots, as the pack walk (walk.cu),
// and so the same design: the unit of work is (tile, pass, segment of the
// tile's list), a pass's segments dealt to up to `tile_blocks` blocks on a
// segment-major grid (every pass's block 0 before any pass's block 1), the
// blocks merged per ray through walk_core.cuh's keys with the exact racing
// exit, the pass's last block unpacking the keys. One block per tile left
// the card waiting on the longest lists (pooled lists up to 353 wide at
// 1.6M triangles) and ran a chunk of 64 tiles on 64 of 132 SMs. Every
// block derives its rays from the camera formula, so a split reads no
// extra rays.
#include "camera_dir.cuh"
#include "walk_core.cuh"

namespace rt {
namespace {

// blockIdx.x = the block's index within its pass * n_tiles * passes
// + local * passes + pass.
template <int R, bool LC>
__global__ void __launch_bounds__(kThreads)
camera_walk_kernel(const float* __restrict__ offs, int tile_base, int w, int h,
                   int bh, int bw, float aspect, float scale, int rt_rays,
                   int n_tiles, const int* __restrict__ ids,
                   const int* __restrict__ cnt,
                   const float* __restrict__ tnear, int width, int seg,
                   int tile_blocks, const float* __restrict__ bbox,
                   const float* __restrict__ geo, long long geo_stride,
                   const float* __restrict__ attr, long long attr_stride,
                   int n_attrs, int cs, float eps, int early, int ee_batch,
                   const float* __restrict__ lcb,
                   unsigned long long* keys, int* __restrict__ finished,
                   float* out_t, int* __restrict__ out_s,
                   float* __restrict__ out_a, int* __restrict__ visits) {
  __shared__ WalkRing ring;
  const int passes = (rt_rays + R * kThreads - 1) / (R * kThreads);
  const unsigned n_sub = static_cast<unsigned>(n_tiles) * passes;
  const unsigned sub = blockIdx.x % n_sub;  // (launch-local tile, pass)
  const int first = blockIdx.x / n_sub;     // this block's first segment
  const int local = sub / passes;
  const int base = (sub % passes) * R * kThreads;  // the pass's first lane
  const int listed = min(cnt[local], width);
  const int n_parts = max(1, list_parts(listed, seg));
  const int parts = min(n_parts, tile_blocks);
  if (first >= parts) return;  // the whole block: no barrier is skipped
  const bool split = parts > 1;

  const int nbx = w / bw;
  const int tile = min(local + tile_base, nbx * (h / bh) - 1);
  const int br = tile / nbx;
  const int bc = tile % nbx;
  const float wf = static_cast<float>(w);
  const float hf = static_cast<float>(h);
  float o[R][3];
  float d[R][3];
  float best_t[R];
  int best_s[R];
  bool alive[R];
  float t_lim[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int l = base + threadIdx.x + r * kThreads;
    alive[r] = l < rt_rays;
    t_lim[r] = inf();
    camera_dir(offs, br, bc, alive[r] ? l : rt_rays - 1, bh, bw, wf, hf,
               aspect, scale, d[r]);
    o[r][0] = o[r][1] = o[r][2] = 0.0f;
    best_t[r] = inf();
    best_s[r] = kBigId;
  }
  const long long np = static_cast<long long>(n_tiles) * rt_rays;
  const long long i0 = static_cast<long long>(local) * rt_rays + base
                       + threadIdx.x;
  const int lanes = rt_rays - base;  // the pass's rays
  const bool use_exit = early != 0;
  const KeyShare<kThreads> share{split && use_exit ? keys + i0 : nullptr,
                                 lanes};
  const long long row = static_cast<long long>(local) * width;
  ring_setup(ring, use_exit ? bbox : nullptr, 0);
  const int visited = walk_segments<R, kPmto, true, LC, false>(
      ring, o, d, alive, ids + row, tnear ? tnear + row : nullptr, listed,
      first, n_parts, tile_blocks, seg, geo, geo_stride, cs, eps, inf(),
      t_lim, lcb, use_exit, ee_batch, best_t, best_s, share);
  if (visits != nullptr && threadIdx.x == 0) atomicAdd(visits + local, visited);
  finish_tile<R, true, kThreads>(split, i0, lanes, np, best_t, best_s,
                                 keys, finished + sub, parts, attr,
                                 attr_stride, n_attrs, cs, out_t, out_s,
                                 out_a);
}

using CameraKernel = decltype(&camera_walk_kernel<4, false>);

// The instance of R rays a thread, with or without the lane cull.
template <bool LC>
CameraKernel camera_instance(int per_thread) {
  if (per_thread <= 2) return camera_walk_kernel<2, LC>;
  if (per_thread == 3) return camera_walk_kernel<3, LC>;
  return camera_walk_kernel<4, LC>;
}

}  // namespace
}  // namespace rt

// offs [spp, 2] f32; the frame is w x h pixels in bh x bw blocks, spp
// samples each; this launch covers blocks [tile_base, tile_base + n_tiles)
// (clamped to the last block). ids [n_tiles, width] i32, cnt [n_tiles],
// each tile's list in segments of `seg` dealt to `tile_blocks` blocks;
// tnear [n_tiles, width] and bbox [6] (only read when early != 0); geo and
// attr as rt_walk takes them, geo origin-folded; lane_bounds [C, 6] or null
// as rt_walk takes it (the boxes of the unfolded geometry: the origin is
// 0). Scratch the launch fills:
// keys, np 8-byte words, 8-byte aligned, and finished [n_tiles * passes]
// i32, passes = ceil(spp * bh * bw / 1024). Outputs in block order: t [np],
// slot [np] i32, attrs [n_attrs, np], np = n_tiles * spp * bh * bw, and,
// where visits is not null, the clusters each tile visited [n_tiles] i32
// (summed over its passes and blocks; they differ from run to run under the
// early exit). Two launches on the stream: fill, blocks.
extern "C" int rt_walk_camera(const float* offs, int tile_base, int n_tiles,
                              int w, int h, int spp, int bh, int bw,
                              float aspect, float scale, const int* ids,
                              const int* cnt, const float* tnear, int width,
                              int seg, int tile_blocks, const float* bbox,
                              const float* geo, long long geo_stride,
                              const float* attr, long long attr_stride,
                              int n_attrs, int cs, float eps, int early,
                              int ee_batch, const float* lane_bounds,
                              unsigned long long* keys,
                              int* finished, float* out_t, int* out_s,
                              float* out_a, int* visits, void* stream) {
  if (n_tiles <= 0 || spp <= 0 || bh <= 0 || bw <= 0 || w % bw != 0
      || h % bh != 0 || !rt::walk_tables_ok(geo, geo_stride, cs, rt::kPmto)
      || width <= 0
      || ee_batch <= 0 || tile_base < 0 || seg <= 0 || tile_blocks <= 0
      || finished == nullptr || keys == nullptr
      || reinterpret_cast<unsigned long long>(keys) % 8) {
    return cudaErrorInvalidValue;
  }
  const int rt_rays = spp * bh * bw;
  const long long np = static_cast<long long>(n_tiles) * rt_rays;
  const int per_thread = (rt_rays + rt::kThreads - 1) / rt::kThreads;
  const int passes = (rt_rays + rt::kRayTile - 1) / rt::kRayTile;
  const long long n_sub = static_cast<long long>(n_tiles) * passes;
  if (n_sub * tile_blocks > 2147483647ll) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  rt::launch_walk_fill(np, true, keys, out_t, n_sub, finished, n_tiles,
                       visits, s);
  auto kern = lane_bounds != nullptr ? rt::camera_instance<true>(per_thread)
                                     : rt::camera_instance<false>(per_thread);
  kern<<<static_cast<unsigned>(n_sub * tile_blocks), rt::kThreads, 0, s>>>(
      offs, tile_base, w, h, bh, bw, aspect, scale, rt_rays, n_tiles, ids,
      cnt, tnear, width, seg, tile_blocks, bbox, geo, geo_stride, attr,
      attr_stride, n_attrs, cs, eps, early, ee_batch, lane_bounds, keys,
      finished, out_t, out_s, out_a, visits);
  return static_cast<int>(cudaGetLastError());
}
