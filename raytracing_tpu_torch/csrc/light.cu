// The area lights' per-sample glue (models/whitted.py: area_light_term):
// one launch prepares a light sample's shadow rays, one folds its
// visibility into the light's estimate, and the fold of a light's last
// sample adds the light's term to the level's total.
//
// Replaces the plain PyTorch chain of light_cone, light_shadow_rays
// (ops/sampling.sample_cone with tangent_frame, ops/intersect.ray_sphere)
// and the estimator: about 100 elementwise launches a sample, each over the
// whole level, alive lanes or not. The JAX package leaves this glue to XLA,
// which fuses it; it has no pallas_call.
//
// Bit-equal to the plain version on the card, op for op (-fmad=false, IEEE
// division and square root, sinf / cosf as PyTorch's sin and cos call
// them): Python constants rounded to float32 as PyTorch rounds a scalar
// (2 pi, 1 - 1e-4, 1e-6, 1e-8, 1e-20), and dot products summed left to
// right, as ops.linalg.dot sums them. A division by the sample count is a
// multiplication by its float32 reciprocal, as PyTorch's CUDA division by
// a Python number is. Every lane is computed and written, dead lanes too,
// as the plain version computes them.
//
// What bounds it: device memory. The sample kernel reads 41 bytes a lane
// (position, normal, hit, its two uniforms and its row) and writes 21
// (direction, n.l, alive, t_max); the fold reads 10 and writes 4, and a
// light's last fold reads 40 more and writes 12. One thread a lane, 256 a
// block; [N, 3] rows are read with their strides, so a warp's three loads
// of a row-major array cover its 384 bytes.
#include "common.cuh"

namespace rt {
namespace {

constexpr int kLightThreads = 256;

// Python's float constants as PyTorch rounds them to float32.
__device__ __forceinline__ float two_pi() {
  return static_cast<float>(2.0 * 3.141592653589793);
}
__device__ __forceinline__ float stop_short() {
  return static_cast<float>(1.0 - 1e-4);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// ops.linalg.sqrt0: sqrt(x) where x > 0, else 0.
__device__ __forceinline__ float sqrt0(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

// torch.clamp_min / torch.clamp with scalar bounds (NaN passes).
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

// ops.linalg.normalize(a, eps=1e-20), in place.
__device__ __forceinline__ void normalize(float a[3]) {
  const float r = sqrtf(clamp_min(dot3(a, a), tiny()));
  a[0] = a[0] / r;
  a[1] = a[1] / r;
  a[2] = a[2] / r;
}

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// The cone light li subtends from p: whitted.light_cone.
struct Cone {
  float dist;
  float cos_max;
  float axis[3];
};

__device__ __forceinline__ Cone light_cone(const float p[3], const float* c,
                                           float rad) {
  float to_c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) to_c[k] = c[k] - p[k];
  Cone k;
  k.dist = sqrtf(dot3(to_c, to_c));
  const float safe = clamp_min(k.dist, tiny());
  const float sin_max = clamp01(rad / safe);
  k.cos_max = sqrt0(1.0f - sin_max * sin_max);
#pragma unroll
  for (int j = 0; j < 3; ++j) k.axis[j] = to_c[j] / safe;
  return k;
}

// Element k of row i of an [N, 3] array with strides (s0, s1).
__device__ __forceinline__ void load3(const float* a, long long s0,
                                      long long s1, long long i, float x[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) x[k] = a[i * s0 + k * s1];
}

struct SampleParams {
  long long n;
  const float* pos;  // [n, 3], strides (ps0, ps1)
  long long ps0, ps1;
  const float* nrm;  // [n, 3], strides (ns0, ns1)
  long long ns0, ns1;
  const bool* hit;  // [n]
  const float* u;   // the sample's draw [m, 2], strides (us0, us1)
  long long us0, us1;
  const long long* rows;  // [n] rows of the draw in [0, m), or null: i
  const float* center;    // [3] of the light
  const float* radius_p;  // [] of the light
  float* w_dir;  // [n, 3] out
  float* ndl;    // [n] out
  bool* alive;   // [n] out
  float* t_max;  // [n] out
};

// light_shadow_rays(light_cone(...), pos, n, hit, u[rows]) for one lane a
// thread: sample_cone with tangent_frame, n.w, ray_sphere, t_stop.
__global__ void __launch_bounds__(kLightThreads)
light_sample_kernel(const SampleParams p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kLightThreads + threadIdx.x;
  if (i >= p.n) return;
  float pos[3], nrm[3];
  load3(p.pos, p.ps0, p.ps1, i, pos);
  load3(p.nrm, p.ns0, p.ns1, i, nrm);
  const long long row = p.rows == nullptr ? i : p.rows[i];
  const float u0 = p.u[row * p.us0];
  const float u1 = p.u[row * p.us0 + p.us1];
  const float rad = *p.radius_p;
  const Cone k = light_cone(pos, p.center, rad);

  // sample_cone(u, axis, cos_max)
  const float cos_t = 1.0f - u0 * (1.0f - k.cos_max);
  const float sin_t = sqrt0(1.0f - cos_t * cos_t);
  const float psi = two_pi() * u1;
  const bool z_small = fabsf(k.axis[2]) < static_cast<float>(1e-6);
  const float arb[3] = {z_small ? 0.0f : 1.0f, 0.0f, z_small ? 1.0f : 0.0f};
  float t1[3], t2[3];
  cross(k.axis, arb, t1);
  normalize(t1);
  cross(k.axis, t1, t2);
  normalize(t2);
  const float a = sin_t * cosf(psi);
  const float b = sin_t * sinf(psi);
  float w[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) w[j] = (a * t1[j] + b * t2[j]) + cos_t * k.axis[j];
  normalize(w);
  const float ndl = dot3(nrm, w);

  // ray_sphere(pos, w, center, radius, inf), eps 1e-8: the near root.
  const float eps = static_cast<float>(1e-8);
  float oc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) oc[j] = pos[j] - p.center[j];
  const float qa = dot3(w, w);
  const float half_b = dot3(oc, w);
  const float qc = dot3(oc, oc) - rad * rad;
  const float disc = half_b * half_b - qa * qc;
  const float t = (-half_b - sqrt0(disc)) / (fabsf(qa) >= eps ? qa : 1.0f);
  const bool l_hit = disc > 0.0f && t > eps && t < inf();

#pragma unroll
  for (int j = 0; j < 3; ++j) p.w_dir[3 * i + j] = w[j];
  p.ndl[i] = ndl;
  p.alive[i] = p.hit[i] && ndl > 0.0f;
  p.t_max[i] = (l_hit ? t : k.dist) * stop_short();
}

struct FoldParams {
  long long n;
  bool first, last;  // the light's first and last sample
  bool first_light, last_light;
  float inv_ns;  // 1 / samples in float32
  const bool* alive;
  const bool* occ;
  const float* ndl;
  float* acc;  // [n] the light's sum over its samples, in place
  // A light's last sample only:
  const float* pos;  // [n, 3], strides (ps0, ps1)
  long long ps0, ps1;
  const float* center;    // [3]
  const float* radius_p;  // []
  const float* emission;  // [3]
  const float* albedo;    // [n], stride as0
  long long as0;
  const float* color;  // [n, 3], strides (cs0, cs1)
  long long cs0, cs1;
  float* total;  // [n, 3] the lights' sum, in place; after the last light,
                 // the term
};

// acc += vis ? max(ndl, 0) : 0; after the light's last sample, total +=
// (acc / ns * omega) emission, and after the last light total *= albedo/pi
// color: the estimator of area_light_term.
__global__ void __launch_bounds__(kLightThreads)
light_fold_kernel(const FoldParams p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kLightThreads + threadIdx.x;
  if (i >= p.n) return;
  const float nd = p.ndl[i];
  const float v = p.alive[i] && !p.occ[i] ? clamp_min(nd, 0.0f) : 0.0f;
  const float acc = (p.first ? 0.0f : p.acc[i]) + v;
  if (!p.last) {
    p.acc[i] = acc;
    return;
  }
  float pos[3];
  load3(p.pos, p.ps0, p.ps1, i, pos);
  const Cone k = light_cone(pos, p.center, *p.radius_p);
  const float omega = two_pi() * (1.0f - k.cos_max);
  const float s = acc * p.inv_ns * omega;
  const float alb = p.albedo[i * p.as0];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float tot = (p.first_light ? 0.0f : p.total[3 * i + j]) + s * p.emission[j];
    if (p.last_light) tot = tot * alb * p.color[i * p.cs0 + j * p.cs1];
    p.total[3 * i + j] = tot;
  }
}

bool launchable(long long n, long long* blocks) {
  *blocks = (n + kLightThreads - 1) / kLightThreads;
  return n > 0 && *blocks <= 2147483647ll;
}

}  // namespace
}  // namespace rt

// One light sample's shadow rays over n lanes: pos, nrm [n, 3] f32 with
// strides (ps0, ps1), (ns0, ns1) in elements; hit [n] bool; the draw u
// [m, 2] f32 with strides (us0, us1), lane i taking row rows[i] (rows [n]
// i64, each in [0, m) and not checked here: the bin sort's permutation)
// or, where rows is null, row i; the light's centre [3] and radius [] f32.
// Writes w_dir [n, 3], ndl [n], alive [n] bool and t_max [n], every array
// contiguous.
extern "C" int rt_light_sample(long long n, const float* pos, long long ps0,
                               long long ps1, const float* nrm,
                               long long ns0, long long ns1, const bool* hit,
                               const float* u, long long us0, long long us1,
                               const long long* rows, const float* center,
                               const float* radius, float* w_dir, float* ndl, bool* alive,
                               float* t_max, void* stream) {
  long long blocks;
  if (!rt::launchable(n, &blocks) || pos == nullptr || nrm == nullptr
      || hit == nullptr || u == nullptr || center == nullptr
      || radius == nullptr || w_dir == nullptr || ndl == nullptr
      || alive == nullptr || t_max == nullptr) {
    return cudaErrorInvalidValue;
  }
  rt::SampleParams p{n, pos, ps0, ps1, nrm, ns0, ns1, hit, u, us0, us1, rows,
                     center, radius, w_dir, ndl, alive, t_max};
  rt::light_sample_kernel<<<static_cast<unsigned>(blocks), rt::kLightThreads,
                            0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Fold sample s of ns of light li of nl over n lanes: acc [n] f32 in place
// (read unless s == 0) from alive, occ [n] bool and ndl [n] f32. At the
// light's last sample, total [n, 3] f32 in place (read unless li == 0)
// gains the light's term from pos [n, 3] (strides (ps0, ps1)), its
// centre [3], radius [] and emission [3]; after the
// last light, total is multiplied by albedo [n] (stride as0) and color
// [n, 3] (strides (cs0, cs1)). acc, total and the masks contiguous.
extern "C" int rt_light_fold(long long n, int s, int ns, int li, int nl,
                             const bool* alive, const bool* occ,
                             const float* ndl, float* acc, const float* pos,
                             long long ps0, long long ps1,
                             const float* center, const float* radius,
                             const float* emission, const float* albedo,
                             long long as0, const float* color,
                             long long cs0, long long cs1, float* total,
                             void* stream) {
  long long blocks;
  const bool last = s == ns - 1;
  if (!rt::launchable(n, &blocks) || ns <= 0 || s < 0 || s >= ns || nl <= 0
      || li < 0 || li >= nl || alive == nullptr || occ == nullptr
      || ndl == nullptr || acc == nullptr
      || (last && (pos == nullptr || center == nullptr || radius == nullptr
                   || emission == nullptr || albedo == nullptr
                   || color == nullptr || total == nullptr))) {
    return cudaErrorInvalidValue;
  }
  rt::FoldParams p{n, s == 0, last, li == 0, li == nl - 1,
                   1.0f / static_cast<float>(ns), alive, occ, ndl, acc, pos,
                   ps0, ps1, center, radius, emission,
                   albedo, as0, color, cs0, cs1, total};
  rt::light_fold_kernel<<<static_cast<unsigned>(blocks), rt::kLightThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
