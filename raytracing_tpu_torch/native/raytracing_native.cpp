// Host library of the PyTorch port (raytracing_tpu_torch): OBJ parsing,
// midpoint subdivision, the Morton and SAH cluster orders and the kernel
// data blocks of the accel build. The port's own copy of the JAX package's
// host library, with the same entry points and the same output bit for
// bit; the port never loads the JAX package's build of it.
//
// Exposed as a plain C ABI consumed via ctypes
// (raytracing_tpu_torch/geometry/native.py, which compiles this file with
// g++ into raytracing_tpu_torch/_build/ at first use). Every entry point
// has a numpy version in the port, so the library is an accelerator, not
// a dependency.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <utility>
#include <vector>

namespace {

struct ObjCounts {
  long n_verts = 0;
  long n_tris = 0;
};

// Read a whole file into a buffer; returns empty on failure.
std::vector<char> read_file(const char* path) {
  std::vector<char> buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(size) + 1);
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf.resize(got);
  buf.push_back('\0');
  return buf;
}

inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

inline const char* next_line(const char* p) {
  while (*p && *p != '\n') ++p;
  return *p ? p + 1 : p;
}

// Parse a face vertex token "i", "i/j", "i//k", "i/j/k"; 1-based, negative
// indices count from the end. Returns 0-based index or -1.
inline long parse_face_index(const char*& p, long n_verts) {
  char* end = nullptr;
  long v = std::strtol(p, &end, 10);
  if (end == p) return -1;
  p = end;
  // skip /vt/vn suffix
  while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
  if (v > 0) return v - 1;
  if (v < 0) return n_verts + v;
  return -1;
}

// Shared parse walk: counts, or fills when out pointers are non-null.
int parse_obj(const char* path, float* verts, long verts_cap, int* tris,
              long tris_cap, ObjCounts* counts) {
  std::vector<char> buf = read_file(path);
  if (buf.empty()) return 1;
  long nv = 0, nt = 0;
  const char* p = buf.data();
  while (*p) {
    p = skip_ws(p);
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      const char* q = p + 2;
      char* end = nullptr;
      float x = std::strtof(q, &end);
      float y = std::strtof(end, &end);
      float z = std::strtof(end, &end);
      if (verts) {
        if (nv >= verts_cap) return 2;
        verts[nv * 3 + 0] = x;
        verts[nv * 3 + 1] = y;
        verts[nv * 3 + 2] = z;
      }
      ++nv;
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      const char* q = p + 2;
      long idx[64];
      int n = 0;
      while (n < 64) {
        q = skip_ws(q);
        if (*q == '\n' || *q == '\0') break;
        long v = parse_face_index(q, nv);
        if (v < 0) break;
        idx[n++] = v;
      }
      // fan-triangulate polygons, matching the numpy fallback
      for (int k = 1; k + 1 < n; ++k) {
        if (tris) {
          if (nt >= tris_cap) return 2;
          tris[nt * 3 + 0] = static_cast<int>(idx[0]);
          tris[nt * 3 + 1] = static_cast<int>(idx[k]);
          tris[nt * 3 + 2] = static_cast<int>(idx[k + 1]);
        }
        ++nt;
      }
    }
    p = next_line(p);
  }
  if (counts) {
    counts->n_verts = nv;
    counts->n_tris = nt;
  }
  return 0;
}

inline uint32_t expand_bits10(uint32_t v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

}  // namespace

extern "C" {

int rt_parse_obj_count(const char* path, long* n_verts, long* n_tris) {
  ObjCounts c;
  int rc = parse_obj(path, nullptr, 0, nullptr, 0, &c);
  if (rc) return rc;
  *n_verts = c.n_verts;
  *n_tris = c.n_tris;
  return 0;
}

int rt_parse_obj_fill(const char* path, float* verts, long n_verts, int* tris,
                      long n_tris) {
  return parse_obj(path, verts, n_verts, tris, n_tris, nullptr);
}

// Stable Morton-order (Z-curve, 30-bit) of 3D points: writes the argsort
// permutation into `order`. Matches the numpy path in accel/packets.py
// (_morton_codes).
int rt_morton_order(const float* centroids, long n, int* order) {
  if (n <= 0) return 0;
  float lo[3] = {centroids[0], centroids[1], centroids[2]};
  float hi[3] = {centroids[0], centroids[1], centroids[2]};
  for (long i = 1; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      float v = centroids[i * 3 + k];
      lo[k] = std::min(lo[k], v);
      hi[k] = std::max(hi[k], v);
    }
  }
  float scale[3];
  for (int k = 0; k < 3; ++k) {
    float ext = hi[k] - lo[k];
    scale[k] = 1023.0f / (ext > 1e-20f ? ext : 1e-20f);
  }
  std::vector<std::pair<uint32_t, int>> keyed(static_cast<size_t>(n));
  for (long i = 0; i < n; ++i) {
    uint32_t q[3];
    for (int k = 0; k < 3; ++k) {
      float f = (centroids[i * 3 + k] - lo[k]) * scale[k];
      long qi = static_cast<long>(f);
      q[k] = static_cast<uint32_t>(std::min(std::max(qi, 0L), 1023L));
    }
    uint32_t code = (expand_bits10(q[0]) << 2) | (expand_bits10(q[1]) << 1) |
                    expand_bits10(q[2]);
    keyed[static_cast<size_t>(i)] = {code, static_cast<int>(i)};
  }
  std::stable_sort(keyed.begin(), keyed.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });
  for (long i = 0; i < n; ++i) order[i] = keyed[static_cast<size_t>(i)].second;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Exact-sweep SAH cluster order — native twin of accel/packets.py
// _sah_sweep_order (same objective, candidate set, f32 rounding and tie
// rules, so the two produce IDENTICAL orderings).
// Depth-first with 3 stably-maintained per-axis lists; the numpy version
// is level-synchronous for vectorization, which a scalar loop doesn't
// need. O(n log n); ~45 s of numpy at 1.6 M triangles runs in seconds.
// ---------------------------------------------------------------------------

namespace {

struct SahScratch {
  std::vector<int64_t> ids[3];   // per-axis triangle lists (n each)
  std::vector<uint8_t> in_left;  // per-triangle membership flag (n)
  std::vector<int64_t> tmp;      // stable-partition buffer (n)
  // per-node block boxes / prefix / suffix (max_blocks each, xyz lo+hi)
  std::vector<float> blo_b, bhi_b, lo_pre, hi_pre, lo_suf, hi_suf;
  std::vector<double> cost3;  // [3, max_blocks] per-axis candidate costs
};

inline float sa_f32(const float* lo, const float* hi) {
  float e0 = hi[0] - lo[0];
  float e1 = hi[1] - lo[1];
  float e2 = hi[2] - lo[2];
  e0 = e0 > 0.0f ? e0 : 0.0f;
  e1 = e1 > 0.0f ? e1 : 0.0f;
  e2 = e2 > 0.0f ? e2 : 0.0f;
  // match numpy's evaluation order: (e0*e1 + e1*e2) + e2*e0, all f32
  return (e0 * e1 + e1 * e2) + e2 * e0;
}

}  // namespace

extern "C" {

// cent/blo/bhi: [n, 3] f32 (triangle centroids and AABBs); writes the
// cluster-coherent permutation into order[n]. Returns 0 on success.
int rt_sah_sweep_order(const float* cent, const float* blo, const float* bhi,
                       long n, long cs, long long* order) {
  if (n <= 0 || cs <= 0) return 1;
  if (n <= cs) {
    for (long i = 0; i < n; ++i) order[i] = i;
    return 0;
  }
  SahScratch s;
  for (int a = 0; a < 3; ++a) {
    s.ids[a].resize(static_cast<size_t>(n));
    for (long i = 0; i < n; ++i) s.ids[a][static_cast<size_t>(i)] = i;
    const float* c = cent;
    // stable sort by centroid component a (ties keep index order, matching
    // np.argsort(kind="stable"))
    std::stable_sort(s.ids[a].begin(), s.ids[a].end(),
                     [c, a](int64_t x, int64_t y) {
                       return c[x * 3 + a] < c[y * 3 + a];
                     });
  }
  s.in_left.assign(static_cast<size_t>(n), 0);
  s.tmp.resize(static_cast<size_t>(n));
  long max_blocks = (n + cs - 1) / cs;
  s.blo_b.resize(static_cast<size_t>(max_blocks) * 3);
  s.bhi_b.resize(static_cast<size_t>(max_blocks) * 3);
  s.lo_pre.resize(static_cast<size_t>(max_blocks) * 3);
  s.hi_pre.resize(static_cast<size_t>(max_blocks) * 3);
  s.lo_suf.resize(static_cast<size_t>(max_blocks) * 3);
  s.hi_suf.resize(static_cast<size_t>(max_blocks) * 3);
  s.cost3.resize(static_cast<size_t>(max_blocks) * 3);

  std::vector<std::pair<long, long>> stack;
  stack.emplace_back(0, n);
  const float kBig = 1e30f;

  while (!stack.empty()) {
    auto seg = stack.back();
    stack.pop_back();
    long lo = seg.first, len = seg.second;
    if (len <= cs) continue;
    long nb = (len + cs - 1) / cs;

    // Stage 1: per-axis candidate costs into cost3[a][kb]. Stage 2
    // combines them kb-OUTER / axis-INNER with strict <, which is
    // numpy's tie rule (per kb the lowest axis among strict
    // improvements, then the smallest kb among cost minima — see
    // _sah_sweep_order). An axis-outer scan would lock a lower axis in
    // at a LARGER kb on equal costs and diverge on tie-heavy meshes.
    for (int a = 0; a < 3; ++a) {
      // block-reduce boxes of the current axis-a ordering
      for (long b = 0; b < nb; ++b) {
        float* bl = &s.blo_b[static_cast<size_t>(b) * 3];
        float* bh = &s.bhi_b[static_cast<size_t>(b) * 3];
        bl[0] = bl[1] = bl[2] = kBig;
        bh[0] = bh[1] = bh[2] = -kBig;
        long e = std::min(len, (b + 1) * cs);
        for (long i = b * cs; i < e; ++i) {
          int64_t t = s.ids[a][static_cast<size_t>(lo + i)];
          for (int k = 0; k < 3; ++k) {
            bl[k] = std::min(bl[k], blo[t * 3 + k]);
            bh[k] = std::max(bh[k], bhi[t * 3 + k]);
          }
        }
      }
      // prefix / suffix mins and maxes over blocks (f32, like numpy)
      for (int k = 0; k < 3; ++k) {
        s.lo_pre[k] = s.blo_b[k];
        s.hi_pre[k] = s.bhi_b[k];
      }
      for (long b = 1; b < nb; ++b)
        for (int k = 0; k < 3; ++k) {
          size_t i = static_cast<size_t>(b) * 3 + k;
          size_t p = static_cast<size_t>(b - 1) * 3 + k;
          s.lo_pre[i] = std::min(s.blo_b[i], s.lo_pre[p]);
          s.hi_pre[i] = std::max(s.bhi_b[i], s.hi_pre[p]);
        }
      for (int k = 0; k < 3; ++k) {
        size_t i = static_cast<size_t>(nb - 1) * 3 + k;
        s.lo_suf[i] = s.blo_b[i];
        s.hi_suf[i] = s.bhi_b[i];
      }
      for (long b = nb - 2; b >= 0; --b)
        for (int k = 0; k < 3; ++k) {
          size_t i = static_cast<size_t>(b) * 3 + k;
          size_t q = static_cast<size_t>(b + 1) * 3 + k;
          s.lo_suf[i] = std::min(s.blo_b[i], s.lo_suf[q]);
          s.hi_suf[i] = std::max(s.bhi_b[i], s.hi_suf[q]);
        }
      for (long kb = 1; kb < nb; ++kb) {
        long n_left = kb * cs;
        long n_right = len - n_left;
        float a_l = sa_f32(&s.lo_pre[static_cast<size_t>(kb - 1) * 3],
                           &s.hi_pre[static_cast<size_t>(kb - 1) * 3]);
        float a_r = sa_f32(&s.lo_suf[static_cast<size_t>(kb) * 3],
                           &s.hi_suf[static_cast<size_t>(kb) * 3]);
        s.cost3[static_cast<size_t>(a) * max_blocks + kb] =
            static_cast<double>(a_l) * static_cast<double>(n_left) +
            static_cast<double>(a_r) * static_cast<double>(n_right);
      }
    }
    double best_cost = std::numeric_limits<double>::infinity();
    int best_axis = 0;
    long best_kb = 1;
    for (long kb = 1; kb < nb; ++kb)
      for (int a = 0; a < 3; ++a) {
        double c = s.cost3[static_cast<size_t>(a) * max_blocks + kb];
        if (c < best_cost) {
          best_cost = c;
          best_axis = a;
          best_kb = kb;
        }
      }

    long k = best_kb * cs;
    // mark left membership from the winning axis ordering
    for (long i = 0; i < k; ++i)
      s.in_left[static_cast<size_t>(
          s.ids[best_axis][static_cast<size_t>(lo + i)])] = 1;
    // stable partition each axis list by membership
    for (int a = 0; a < 3; ++a) {
      int64_t* seg_ids = s.ids[a].data() + lo;
      long nl = 0, nr = 0;
      for (long i = 0; i < len; ++i) {
        int64_t t = seg_ids[i];
        if (s.in_left[static_cast<size_t>(t)])
          seg_ids[nl++] = t;
        else
          s.tmp[static_cast<size_t>(nr++)] = t;
      }
      std::memcpy(seg_ids + nl, s.tmp.data(),
                  static_cast<size_t>(nr) * sizeof(int64_t));
    }
    // clear flags for reuse
    for (long i = 0; i < k; ++i)
      s.in_left[static_cast<size_t>(
          s.ids[best_axis][static_cast<size_t>(lo + i)])] = 0;
    stack.emplace_back(lo, k);
    stack.emplace_back(lo + k, len - k);
  }

  std::memcpy(order, s.ids[0].data(), static_cast<size_t>(n) * sizeof(int64_t));
  return 0;
}

// Kernel data blocks — native twin of accel/packets.py
// _kernel_blocks_host (same f32 op order; build with -ffp-contract=off so
// no auto-FMA perturbs the rounding).
//   tri_verts [S, 3, 3] f32 (S = C*CS padded slots), valid [S] u8.
//   tri_blocks [C, 9, CS]   v0|e1|e2 rows, triangles on lanes
//   pmt_blocks [C, 12, CS]  Baldwin-Weber n|k|U|ku|V|kv rows
//   woop_blocks [C, 8, 6*CS] unit-triangle affine, matmul layout
//                            (pass nullptr to skip)
int rt_kernel_blocks(const float* tri_verts, const unsigned char* valid,
                     long c, long cs, float* tri_blocks, float* pmt_blocks,
                     float* woop_blocks) {
  long s_total = c * cs;
  for (long s = 0; s < s_total; ++s) {
    const float* tv = tri_verts + s * 9;
    float m = valid[s] ? 1.0f : 0.0f;
    float v0[3], e1[3], e2[3];
    for (int k = 0; k < 3; ++k) {
      v0[k] = tv[k];
      e1[k] = (tv[3 + k] - tv[k]) * m;
      e2[k] = (tv[6 + k] - tv[k]) * m;
    }
    long ci = s / cs, li = s % cs;
    float* tb = tri_blocks + (ci * 9) * cs + li;
    for (int k = 0; k < 3; ++k) {
      tb[k * cs] = v0[k];
      tb[(3 + k) * cs] = e1[k];
      tb[(6 + k) * cs] = e2[k];
    }
    // Baldwin-Weber rows (f32 throughout, matching numpy)
    float nbw[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                    e1[2] * e2[0] - e1[0] * e2[2],
                    e1[0] * e2[1] - e1[1] * e2[0]};
    float n2 = nbw[0] * nbw[0] + nbw[1] * nbw[1] + nbw[2] * nbw[2];
    float inv_n2 = n2 > 0.0f ? 1.0f / n2 : 0.0f;
    float U[3] = {(e2[1] * nbw[2] - e2[2] * nbw[1]) * inv_n2,
                  (e2[2] * nbw[0] - e2[0] * nbw[2]) * inv_n2,
                  (e2[0] * nbw[1] - e2[1] * nbw[0]) * inv_n2};
    float V[3] = {(nbw[1] * e1[2] - nbw[2] * e1[1]) * inv_n2,
                  (nbw[2] * e1[0] - nbw[0] * e1[2]) * inv_n2,
                  (nbw[0] * e1[1] - nbw[1] * e1[0]) * inv_n2};
    float kn = nbw[0] * v0[0] + nbw[1] * v0[1] + nbw[2] * v0[2];
    float ku = -(U[0] * v0[0] + U[1] * v0[1] + U[2] * v0[2]);
    float kv = -(V[0] * v0[0] + V[1] * v0[1] + V[2] * v0[2]);
    float* pb = pmt_blocks + (ci * 12) * cs + li;
    for (int k = 0; k < 3; ++k) {
      pb[k * cs] = nbw[k];
      pb[(4 + k) * cs] = U[k];
      pb[(8 + k) * cs] = V[k];
    }
    pb[3 * cs] = kn;
    pb[7 * cs] = ku;
    pb[11 * cs] = kv;
    if (woop_blocks) {
      // M = [e1|e2|n]^-1 rows via cross products; det = e1 . (e2 x n)
      float cn[3] = {nbw[0], nbw[1], nbw[2]};
      float c23[3] = {e2[1] * cn[2] - e2[2] * cn[1],
                      e2[2] * cn[0] - e2[0] * cn[2],
                      e2[0] * cn[1] - e2[1] * cn[0]};
      float c31[3] = {cn[1] * e1[2] - cn[2] * e1[1],
                      cn[2] * e1[0] - cn[0] * e1[2],
                      cn[0] * e1[1] - cn[1] * e1[0]};
      float det = e1[0] * c23[0] + e1[1] * c23[1] + e1[2] * c23[2];
      float inv_det = (det > 1e-20f || det < -1e-20f) ? 1.0f / det : 0.0f;
      float mr[3][3];  // m_rows [row][xyz]
      for (int k = 0; k < 3; ++k) {
        mr[0][k] = c23[k] * inv_det;
        mr[1][k] = c31[k] * inv_det;
        mr[2][k] = cn[k] * inv_det;
      }
      float cst[3];
      for (int q = 0; q < 3; ++q)
        cst[q] = -(mr[q][0] * v0[0] + mr[q][1] * v0[1] + mr[q][2] * v0[2]);
      // w [8 rows, 6 cols] -> layout [C, 8, 6*CS]: col-major per quantity
      // (row r, col q) lands at woop[(ci*8 + r) * 6*cs + q*cs + li]
      float* wb = woop_blocks + (ci * 8) * (6 * cs) + li;
      for (int r = 0; r < 8; ++r)
        for (int q = 0; q < 6; ++q) wb[r * 6 * cs + q * cs] = 0.0f;
      // w[:, 0:3, 0:3] = m_rows^T  (w[row k][col q] = mr[q][k])
      for (int k = 0; k < 3; ++k)
        for (int q = 0; q < 3; ++q) {
          wb[k * 6 * cs + q * cs] = mr[q][k];
          wb[(4 + k) * 6 * cs + (3 + q) * cs] = mr[q][k];
        }
      for (int q = 0; q < 3; ++q) wb[3 * 6 * cs + q * cs] = cst[q];
    }
  }
  return 0;
}

// One midpoint (1:4) subdivision level — native twin of
// geometry/subdivide.py::subdivide_arrays. Midpoint vertices dedup through
// canonical (lo, hi) edge keys; NEW VERTEX ORDER matches the numpy
// version's np.unique (edge keys ascending), so outputs are identical.
//   verts [nv, 3] f32, tris [nt, 3] i32.
//   out_verts capacity nv + 3*nt rows; out_tris capacity 4*nt rows.
// Writes the new vertex count to *out_nv (triangle count is always 4*nt).
int rt_subdivide_level(const float* verts, long nv, const int* tris, long nt,
                       float* out_verts, int* out_tris, long long* out_nv) {
  if (nv <= 0 || nt <= 0) return 1;
  long ne = 3 * nt;
  std::vector<int64_t> keys(static_cast<size_t>(ne));
  for (long t = 0; t < nt; ++t) {
    int a = tris[t * 3 + 0], b = tris[t * 3 + 1], c = tris[t * 3 + 2];
    int e0[3] = {a, b, c}, e1[3] = {b, c, a};
    for (int k = 0; k < 3; ++k) {
      int64_t l = std::min(e0[k], e1[k]);
      int64_t h = std::max(e0[k], e1[k]);
      keys[static_cast<size_t>(k) * nt + t] = l * nv + h;
    }
  }
  // unique keys ascending + inverse indices (np.unique semantics)
  std::vector<int64_t> sorted_keys(keys);
  std::sort(sorted_keys.begin(), sorted_keys.end());
  sorted_keys.erase(std::unique(sorted_keys.begin(), sorted_keys.end()),
                    sorted_keys.end());
  long nu = static_cast<long>(sorted_keys.size());
  // midpoint vertices, in unique-key order
  std::memcpy(out_verts, verts, static_cast<size_t>(nv) * 3 * sizeof(float));
  for (long u = 0; u < nu; ++u) {
    int64_t key = sorted_keys[static_cast<size_t>(u)];
    int64_t l = key / nv;
    int64_t h = key - l * nv;
    for (int k = 0; k < 3; ++k)
      out_verts[(nv + u) * 3 + k] =
          (verts[l * 3 + k] + verts[h * 3 + k]) * 0.5f;
  }
  // triangles: [a,mab,mca] x nt | [mab,b,mbc] x nt | [mca,mbc,c] x nt |
  // [mab,mbc,mca] x nt — the numpy concatenation order
  for (long t = 0; t < nt; ++t) {
    int a = tris[t * 3 + 0], b = tris[t * 3 + 1], c = tris[t * 3 + 2];
    auto inv = [&](long e) {
      return static_cast<int>(
          nv + (std::lower_bound(sorted_keys.begin(), sorted_keys.end(),
                                 keys[static_cast<size_t>(e)]) -
                sorted_keys.begin()));
    };
    int mab = inv(0 * nt + t), mbc = inv(1 * nt + t), mca = inv(2 * nt + t);
    int* o0 = out_tris + t * 3;
    int* o1 = out_tris + (nt + t) * 3;
    int* o2 = out_tris + (2 * nt + t) * 3;
    int* o3 = out_tris + (3 * nt + t) * 3;
    o0[0] = a;   o0[1] = mab; o0[2] = mca;
    o1[0] = mab; o1[1] = b;   o1[2] = mbc;
    o2[0] = mca; o2[1] = mbc; o2[2] = c;
    o3[0] = mab; o3[1] = mbc; o3[2] = mca;
  }
  *out_nv = nv + nu;
  return 0;
}

}  // extern "C"
