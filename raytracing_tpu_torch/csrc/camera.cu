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
// One block per tile = one bh x bw pixel block x spp samples, rt =
// spp*bh*bw rays, a run-time value: lane l is sample l / (bh*bw) of pixel
// divmod(l % (bh*bw), bw) of block divmod(tile, W/bw), and
// tile = min(blockIdx + tile_base, blocks - 1), so a chunk that overruns
// the frame repeats the last block. The direction is
// ((2 (x + ox) / W - 1) aspect scale, (1 - 2 (y + oy) / H) scale, 1) in
// the f32 op order of traverse.py:_camera_dirs (two separate multiplies,
// IEEE division), bit-equal to the materialised pack. offs [spp, 2] is
// read from device memory at every launch. The origin is 0 and every lane
// is alive; the intersector is walk_core.cuh's pmto.
//
// Each of 256 threads owns R = ceil(rt / 256) rays, at most 4; a tile of
// more than 1024 rays is walked in passes of 1024 (each pass walks the
// list again; results are per ray, so that is exact).
//
// Bound on the card: scheduler slots, ~30 counted operations per (ray,
// triangle); the staged loop is walk_core.cuh's.
#include "walk_core.cuh"

namespace rt {
namespace {

template <int R>
__global__ void __launch_bounds__(kThreads)
camera_walk_kernel(const float* __restrict__ offs, int tile_base, int w, int h,
                   int bh, int bw, float aspect, float scale, int rt_rays,
                   long long np, const int* __restrict__ ids,
                   const int* __restrict__ cnt,
                   const float* __restrict__ tnear, int width,
                   const float* __restrict__ bbox,
                   const float* __restrict__ geo, long long geo_stride,
                   const float* __restrict__ attr, long long attr_stride,
                   int n_attrs, int cs, float eps, int early, int ee_batch,
                   float* __restrict__ out_t, int* __restrict__ out_s,
                   float* __restrict__ out_a, int* __restrict__ visits) {
  __shared__ WalkRing ring;
  const int local = blockIdx.x;
  const int nbx = w / bw;
  const int tile = min(local + tile_base, nbx * (h / bh) - 1);
  const int br = tile / nbx;
  const int bc = tile % nbx;
  const int p2 = bh * bw;
  const float wf = static_cast<float>(w);
  const float hf = static_cast<float>(h);
  const long long row = static_cast<long long>(local) * width;
  const int trips = cnt[local];
  int visited = 0;

  for (int base = 0; base < rt_rays; base += R * kThreads) {
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
      const int ll = alive[r] ? l : rt_rays - 1;
      const int s = ll / p2;
      const int p = ll % p2;
      const float xi = static_cast<float>(bc * bw + p % bw);
      const float yi = static_cast<float>(br * bh + p / bw);
      const float ox = offs[2 * s];
      const float oy = offs[2 * s + 1];
      d[r][0] = (2.0f * (xi + ox) / wf - 1.0f) * aspect * scale;
      d[r][1] = (1.0f - 2.0f * (yi + oy) / hf) * scale;
      d[r][2] = 1.0f;
      o[r][0] = o[r][1] = o[r][2] = 0.0f;
      best_t[r] = inf();
      best_s[r] = kBigId;
    }
    visited += walk_list<R, true, true>(
        ring, o, d, alive, ids + row, tnear ? tnear + row : nullptr, trips,
        bbox, geo, geo_stride, 0, cs, eps, t_lim, early != 0, ee_batch,
        best_t, best_s, NoShare{});
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int l = base + threadIdx.x + r * kThreads;
      if (l < rt_rays) {
        store_result(static_cast<long long>(local) * rt_rays + l, np,
                     best_t[r], best_s[r], true, attr, attr_stride, n_attrs,
                     cs, out_t, out_s, out_a);
      }
    }
  }
  if (visits != nullptr && threadIdx.x == 0) visits[local] = visited;
}

}  // namespace
}  // namespace rt

// offs [spp, 2] f32; the frame is w x h pixels in bh x bw blocks, spp
// samples each; this launch covers blocks [tile_base, tile_base + n_tiles)
// (clamped to the last block). ids [n_tiles, width] i32, cnt [n_tiles],
// tnear [n_tiles, width] and bbox [6] (only read when early != 0); geo and
// attr as rt_walk takes them, geo origin-folded. Outputs in block order:
// t [np], slot [np] i32, attrs [n_attrs, np], np = n_tiles * spp * bh * bw,
// and, where visits is not null, the clusters each tile visited [n_tiles]
// i32 (summed over its passes).
extern "C" int rt_walk_camera(const float* offs, int tile_base, int n_tiles,
                              int w, int h, int spp, int bh, int bw,
                              float aspect, float scale, const int* ids,
                              const int* cnt, const float* tnear, int width,
                              const float* bbox, const float* geo,
                              long long geo_stride, const float* attr,
                              long long attr_stride, int n_attrs, int cs,
                              float eps, int early, int ee_batch, float* out_t,
                              int* out_s, float* out_a, int* visits,
                              void* stream) {
  if (n_tiles <= 0 || spp <= 0 || bh <= 0 || bw <= 0 || w % bw != 0
      || h % bh != 0 || !rt::walk_tables_ok(geo, geo_stride, cs) || width <= 0
      || ee_batch <= 0 || tile_base < 0) {
    return cudaErrorInvalidValue;
  }
  const int rt_rays = spp * bh * bw;
  const long long np = static_cast<long long>(n_tiles) * rt_rays;
  const int per_thread = (rt_rays + rt::kThreads - 1) / rt::kThreads;
  auto kern = rt::camera_walk_kernel<4>;
  if (per_thread == 1) kern = rt::camera_walk_kernel<1>;
  else if (per_thread == 2) kern = rt::camera_walk_kernel<2>;
  else if (per_thread == 3) kern = rt::camera_walk_kernel<3>;
  kern<<<static_cast<unsigned>(n_tiles), rt::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
      offs, tile_base, w, h, bh, bw, aspect, scale, rt_rays, np, ids, cnt,
      tnear, width, bbox, geo, geo_stride, attr, attr_stride, n_attrs, cs,
      eps, early, ee_batch, out_t, out_s, out_a, visits);
  return static_cast<int>(cudaGetLastError());
}
