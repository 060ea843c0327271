// The rest-set merge: every ray of a query against the rest set (the
// triangles of objects too small to fill a cluster, kept out of the walks:
// the ground plane's two in the default scene), folded into the walk's
// results in place, in one launch.
//
// Replaces the plain PyTorch merge of kernels/traverse.py (_rest_t_rows
// under _merge_rest_nearest_rows or _merge_rest_occlusion, camera mode's
// directions from _camera_dir_rows): 60 to 105 elementwise launches a
// query over [Rr, N] rows. The JAX package leaves this merge to XLA, which
// fuses it; it has no pallas_call.
//
// Bit-equal to the plain version, op for op (-fmad=false, IEEE division):
// inv = 1 / (|det| >= eps ? det : 1), the u, v and t dot products summed
// left to right, then u >= 0, v >= 0, u + v <= 1, t > eps and t < t_limit
// (+inf where none is given: the same outcome as no test); a rejected
// triangle reads +inf, and an infinite t occludes nothing. Nearest: the
// least t over the rest set, the lowest rest index among equal ones,
// replacing the walk's (t, slot, attrs) only where strictly nearer, so the
// walk keeps a tie. Occlusion: a finite t sets occ. Every lane is computed,
// dead lanes too, as the plain version computes them.
//
// Rays: the SoA pack [8, np] (rows 0-2 origin, 4-6 direction), or camera
// mode: each lane's direction derived from (offs, frame, block) by
// camera_dir.cuh as the camera walks derive it, the origin 0 (s = 0 - v0,
// as the plain version subtracts).
//
// What bounds it: device memory, 28 bytes read a pack ray (its 6 rows and
// t) and at most 8 written (t and slot where the rest set is nearer), 4 and
// 8 a camera ray; the tests are ~40 operations a (ray, rest triangle). Each
// thread takes V = 4 consecutive lanes with one 16-byte load a row where np
// is a multiple of 4 and the rows are 16-byte aligned, else V = 1. The rest
// set's rows are staged in shared memory, kRestRows at a time, and read by
// every thread as broadcasts; a winner's attribute rows (at most a few KB)
// are read through the read-only cache.
#include "camera_dir.cuh"

namespace rt {
namespace {

constexpr int kRestThreads = 256;
// Rest rows staged at a time (the accel's default rest_max: one stage).
constexpr int kRestRows = 64;

struct RestParams {
  const float* rays;  // pack [8, np], or null: camera mode
  long long np;
  const float* offs;  // camera mode: [spp, 2], frame w x h in bh x bw blocks
  int tile_base, w, h, bh, bw, rt_rays;
  float aspect, scale;
  const float* rest;  // [rr, 9]: v0 | e1 | e2
  int rr;
  const float* tbl0;  // [rr, a0] then [rr, a1]: a winner's attribute rows
  int a0;
  const float* tbl1;
  int a1;
  int slot_base;  // a winner's slot: slot_base + its rest index
  float eps;
  float t_lim;            // occlusion: one limit for every ray, or
  const float* tmax_row;  // each ray's [np]
  float* t;               // nearest, in place: [np], [np], [a0 + a1, np]
  int* slot;
  float* attrs;
  unsigned char* occ;  // occlusion, in place: [np] bool
};

// t of a ray against rest row r (v0 | e1 | e2), +inf where rejected:
// _rest_t_rows' operations in its order.
__device__ __forceinline__ float rest_t(const float o[3], const float d[3],
                                        const float* r, float eps,
                                        float t_limit) {
  const float px = d[1] * r[8] - d[2] * r[7];
  const float py = d[2] * r[6] - d[0] * r[8];
  const float pz = d[0] * r[7] - d[1] * r[6];
  const float det = r[3] * px + r[4] * py + r[5] * pz;
  const bool ok_det = fabsf(det) >= eps;
  const float inv = 1.0f / (ok_det ? det : 1.0f);
  const float sx = o[0] - r[0];
  const float sy = o[1] - r[1];
  const float sz = o[2] - r[2];
  const float u = (sx * px + sy * py + sz * pz) * inv;
  const float qx = sy * r[5] - sz * r[4];
  const float qy = sz * r[3] - sx * r[5];
  const float qz = sx * r[4] - sy * r[3];
  const float v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv;
  const float t = (r[6] * qx + r[7] * qy + r[8] * qz) * inv;
  const bool valid = ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f
                     && t > eps && t < t_limit;
  return valid ? t : inf();
}

// V consecutive floats of a row from lane i (16-byte aligned for V = 4).
template <int V>
__device__ __forceinline__ void load_lanes(const float* row, long long i,
                                           float x[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(row + i);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    x[0] = row[i];
  }
}

// Thread g takes lanes [V g, V g + V); np is a multiple of V.
template <int V, bool kCam, bool kOcc>
__global__ void __launch_bounds__(kRestThreads)
rest_merge_kernel(const RestParams p) {
  __shared__ float s_rest[kRestRows * 9];
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kRestThreads + threadIdx.x) * V;
  const bool live = i0 < p.np;
  float o[V][3];
  float d[V][3];
  float lim[V];
  if (live) {
    if constexpr (kCam) {
      const int nbx = p.w / p.bw;
      const int last = nbx * (p.h / p.bh) - 1;
      const float wf = static_cast<float>(p.w);
      const float hf = static_cast<float>(p.h);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = static_cast<int>(i0) + v;
        const int local = i / p.rt_rays;
        const int tile = min(p.tile_base + local, last);
        camera_dir(p.offs, tile / nbx, tile % nbx, i - local * p.rt_rays,
                   p.bh, p.bw, wf, hf, p.aspect, p.scale, d[v]);
        o[v][0] = o[v][1] = o[v][2] = 0.0f;
      }
    } else {
      float x[V];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        load_lanes<V>(p.rays + k * p.np, i0, x);
#pragma unroll
        for (int v = 0; v < V; ++v) o[v][k] = x[v];
        load_lanes<V>(p.rays + (4 + k) * p.np, i0, x);
#pragma unroll
        for (int v = 0; v < V; ++v) d[v][k] = x[v];
      }
    }
    if (kOcc && p.tmax_row != nullptr) {
      load_lanes<V>(p.tmax_row, i0, lim);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) lim[v] = kOcc ? p.t_lim : inf();
    }
  }
  float best[V];
  int arg[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    best[v] = inf();
    arg[v] = 0;
  }
  for (int c0 = 0; c0 < p.rr; c0 += kRestRows) {
    const int m = min(kRestRows, p.rr - c0);
    __syncthreads();  // the previous stage is read
    for (int k = threadIdx.x; k < 9 * m; k += kRestThreads) {
      s_rest[k] = __ldg(p.rest + 9LL * c0 + k);
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < m; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float t = rest_t(o[v], d[v], s_rest + 9 * j, p.eps, lim[v]);
        if (t < best[v]) {  // strict: the lowest rest index keeps a tie
          best[v] = t;
          arg[v] = c0 + j;
        }
      }
    }
  }
  if (!live) return;
  if constexpr (kOcc) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (best[v] != inf()) p.occ[i0 + v] = 1;
    }
  } else {
    float t_walk[V];
    load_lanes<V>(p.t, i0, t_walk);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!(best[v] < t_walk[v])) continue;  // the walk keeps a tie
      const long long i = i0 + v;
      p.t[i] = best[v];
      p.slot[i] = p.slot_base + arg[v];
      for (int k = 0; k < p.a0; ++k) {
        p.attrs[k * p.np + i] = __ldg(p.tbl0 + arg[v] * p.a0 + k);
      }
      for (int k = 0; k < p.a1; ++k) {
        p.attrs[(p.a0 + k) * p.np + i] = __ldg(p.tbl1 + arg[v] * p.a1 + k);
      }
    }
  }
}

using RestKernel = decltype(&rest_merge_kernel<1, false, false>);

template <int V>
RestKernel rest_instance(bool camera, bool occlusion) {
  if (camera) return rest_merge_kernel<V, true, false>;
  return occlusion ? rest_merge_kernel<V, false, true>
                   : rest_merge_kernel<V, false, false>;
}

bool aligned16(const void* q) {
  return reinterpret_cast<unsigned long long>(q) % 16 == 0;
}

}  // namespace
}  // namespace rt

// One launch of the merge over np rays, in place. Rays: rays [8, np] f32,
// or (rays null) camera mode: offs [spp, 2] f32, a frame w x h in bh x bw
// blocks, lanes from block tile_base on in block ray order (np a multiple
// of spp * bh * bw; a block past the frame's last repeats it). rest
// [rr, 9] f32 (v0 | e1 | e2), rr >= 1. occlusion == 0, the nearest merge:
// t [np] f32 and slot [np] i32 in place, and where a0 + a1 > 0 attrs
// [a0 + a1, np] f32 in place from tbl0 [rr, a0] and tbl1 [rr, a1] (tbl1
// null for a1 = 0); a winning rest triangle j writes slot slot_base + j.
// occlusion != 0 (pack only): occ [np] bool set where a rest triangle lies
// in (eps, limit), the limit tmax_row [np] f32 or, where that is null,
// t_lim. Every array contiguous.
extern "C" int rt_rest_merge(const float* rays, long long np,
                             const float* offs, int tile_base, int w, int h,
                             int spp, int bh, int bw, float aspect,
                             float scale, const float* rest, int rr,
                             const float* tbl0, int a0, const float* tbl1,
                             int a1, int slot_base, float eps, int occlusion,
                             float t_lim, const float* tmax_row, float* t,
                             int* slot, float* attrs, unsigned char* occ,
                             void* stream) {
  const bool camera = rays == nullptr;
  const bool occl = occlusion != 0;
  const int rt_rays = camera ? spp * bh * bw : 0;
  if (np <= 0 || rest == nullptr || rr <= 0 || a0 < 0 || a1 < 0
      || (a0 > 0) != (tbl0 != nullptr) || (a1 > 0) != (tbl1 != nullptr)
      || (a0 + a1 > 0) != (attrs != nullptr)
      || (occl ? (occ == nullptr || camera || a0 + a1 > 0)
               : (t == nullptr || slot == nullptr || tmax_row != nullptr))
      || (camera && (offs == nullptr || spp <= 0 || bh <= 0 || bw <= 0
                     || w % bw != 0 || h % bh != 0 || tile_base < 0
                     || np > 2147483647ll || np % rt_rays != 0))) {
    return cudaErrorInvalidValue;
  }
  const bool v4 = np % 4 == 0 && (camera || rt::aligned16(rays))
                  && (occl || rt::aligned16(t))
                  && (tmax_row == nullptr || rt::aligned16(tmax_row));
  rt::RestParams p{rays, np, offs, tile_base, w, h, bh, bw, rt_rays,
                   aspect, scale, rest, rr, tbl0, a0, tbl1, a1, slot_base,
                   eps, t_lim, tmax_row, t, slot, attrs, occ};
  const int v = v4 ? 4 : 1;
  const long long threads = (np + v - 1) / v;
  const long long blocks = (threads + rt::kRestThreads - 1) / rt::kRestThreads;
  if (blocks > 2147483647ll) return cudaErrorInvalidValue;
  auto kern = v4 ? rt::rest_instance<4>(camera, occl)
                 : rt::rest_instance<1>(camera, occl);
  kern<<<static_cast<unsigned>(blocks), rt::kRestThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
