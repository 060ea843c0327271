// The visit-list walk shared by walk.cu (rays read from a pack) and
// camera.cu (rays derived from the pinhole camera): one block walks one
// tile's front-to-back list of clusters, each thread holding R rays in
// registers. Per visit the cluster's 12 x CS Baldwin–Weber rows are staged
// into shared memory and every thread intersects its rays with all CS
// triangles (broadcast reads).
//
// Two intersectors, op for op with the TPU package's:
//   pmt  (traverse.py:_pmt_tile)   t = (d0 - n·o) / den, u and v from the
//        hit point;
//   pmto (traverse.py:_pmt_o_tile) every ray leaves one point and that
//        origin is folded into d0, u0, v0c before the launch:
//        t = d0 / den, u = u0 + t (U·d), v = v0c + t (V·d). The origin rows
//        are never read.
// Nearest keeps a flat (best_t, best_slot) per ray: min t, then min slot,
// and an infinite t never ties. Occlusion keeps min t under each ray's own
// limit (a scalar t_max, or one entry of a per-ray row).
// Early exit, every ee_batch visits: a block vote on "every alive lane's
// min(best_t, scene-exit t) is below the next entry's lower bound" —
// exact, so results do not depend on it.
#pragma once

#include "common.cuh"

namespace rt {

// Upper bound on the t of any hit inside the walked clusters' union box
// (traverse.py:_scene_exit_row): the ray's exit parameter from the box,
// inflated a few ulp; a ray that misses the box gets -inf. Feeds only the
// early-exit vote.
__device__ __forceinline__ float scene_exit(const float o[3], const float d[3],
                                            const float* __restrict__ bbox) {
  float tmin = 0.0f;
  float tmax = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool deg = fabsf(d[k]) < tiny();
    const float dk = deg ? tiny() : d[k];
    const float t1 = (bbox[k] - o[k]) / dk;
    const float t2 = (bbox[3 + k] - o[k]) / dk;
    const float lo = deg ? -inf() : fminf(t1, t2);
    const float hi = deg ? inf() : fmaxf(t1, t2);
    tmin = k == 0 ? lo : fmaxf(tmin, lo);
    tmax = k == 0 ? hi : fminf(tmax, hi);
  }
  const float exit_t = tmax * static_cast<float>(1.0 + 1e-5)
                       + static_cast<float>(1e-6);
  return (tmin <= exit_t && exit_t >= 0.0f) ? exit_t : -inf();
}

// Walk `trips` listed clusters for this thread's R rays. `blk` is the
// block's shared staging buffer of 12 * kMaxClusterSize floats; every
// thread of the block must call this with the same list (it synchronises).
// Lanes with alive == false take no part in the early-exit vote; their
// results are meaningless. best_t / best_s come in as +inf / kBigId, or as
// the result of an earlier call for the same rays (another list, another
// part of the table): the (min t, min slot) rule does not depend on the
// order of the visits, and a hit found earlier is a real hit, so the vote
// stays exact. Listed ids index `geo`; a triangle's slot is
// slot_base + id * cs + lane. Occlusion accepts t < t_lim[r]. Returns the
// number of clusters visited (trips, or fewer after an early exit).
template <int R, bool PMTO>
__device__ __forceinline__ int walk_list(
    float* blk, const float (&o)[R][3], const float (&d)[R][3],
    const bool (&alive)[R], const int* __restrict__ tile_ids,
    const float* __restrict__ tile_tnear, int trips,
    const float* __restrict__ bbox, const float* __restrict__ geo,
    long long geo_stride, int slot_base, int cs, float eps,
    const float (&t_lim)[R], bool nearest, bool use_exit, int ee_batch,
    float (&best_t)[R], int (&best_s)[R]) {
  float exit_t[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    exit_t[r] = use_exit ? scene_exit(o[r], d[r], bbox) : 0.0f;
  }
  for (int j = 0; j < trips; ++j) {
    const int c = tile_ids[j];
    const float* g = geo + static_cast<long long>(c) * geo_stride;
    __syncthreads();  // the previous visit's reads of blk are done
    for (int e = threadIdx.x; e < 12 * cs; e += blockDim.x) blk[e] = g[e];
    __syncthreads();
    const int slot0 = slot_base + c * cs;
    for (int k = 0; k < cs; ++k) {
      const float nx = blk[k], ny = blk[cs + k], nz = blk[2 * cs + k];
      const float d0 = blk[3 * cs + k];
      const float ux = blk[4 * cs + k], uy = blk[5 * cs + k];
      const float uz = blk[6 * cs + k], u0 = blk[7 * cs + k];
      const float vx = blk[8 * cs + k], vy = blk[9 * cs + k];
      const float vz = blk[10 * cs + k], v0c = blk[11 * cs + k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float den = nx * d[r][0] + ny * d[r][1] + nz * d[r][2];
        float t, u, v;
        if (PMTO) {
          t = d0 / den;
          u = u0 + t * (ux * d[r][0] + uy * d[r][1] + uz * d[r][2]);
          v = v0c + t * (vx * d[r][0] + vy * d[r][1] + vz * d[r][2]);
        } else {
          t = (d0 - (nx * o[r][0] + ny * o[r][1] + nz * o[r][2])) / den;
          const float px = o[r][0] + t * d[r][0];
          const float py = o[r][1] + t * d[r][1];
          const float pz = o[r][2] + t * d[r][2];
          u = ux * px + uy * py + uz * pz + u0;
          v = vx * px + vy * py + vz * pz + v0c;
        }
        const bool valid = fabsf(den) >= eps && u >= 0.0f && v >= 0.0f
                           && u + v <= 1.0f && t > eps;
        if (nearest) {
          const int slot = slot0 + k;
          if (valid && (t < best_t[r]
                        || (t == best_t[r] && t < inf() && slot < best_s[r]))) {
            best_t[r] = t;
            best_s[r] = slot;
          }
        } else if (valid && t < t_lim[r] && t < best_t[r]) {
          best_t[r] = t;
        }
      }
    }
    if (use_exit && (j + 1) % ee_batch == 0 && j + 1 < trips) {
      const float nxt = tile_tnear[j + 1];
      bool settled = true;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (alive[r] && !(fminf(best_t[r], exit_t[r]) < nxt)) settled = false;
      }
      if (__syncthreads_and(settled)) return j + 1;
    }
  }
  return trips > 0 ? trips : 0;
}

// Write ray i's result: t, then the slot (nearest) or hit flag (occlusion),
// then the winner's n_attrs attribute rows (0 on a miss), read once here
// rather than carried through the loop.
__device__ __forceinline__ void store_result(
    long long i, long long np, float best_t, int best_s, bool nearest,
    const float* __restrict__ attr, long long attr_stride, int n_attrs,
    int cs, float* __restrict__ out_t, int* __restrict__ out_s,
    float* __restrict__ out_a) {
  out_t[i] = best_t;
  if (!nearest) {
    out_s[i] = best_t < inf() ? 1 : 0;
    return;
  }
  out_s[i] = best_s;
  if (n_attrs > 0) {
    const bool hit = best_s != kBigId;
    const int s = hit ? best_s : 0;
    const float* a = attr + static_cast<long long>(s / cs) * attr_stride
                     + s % cs;
    for (int q = 0; q < n_attrs; ++q) {
      out_a[q * np + i] = hit ? a[q * cs] : 0.0f;
    }
  }
}

}  // namespace rt
