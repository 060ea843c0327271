// Phases 1 and 2 of a kernel query in one launch: a tile's frustum (K6's
// extents, or camera mode's closed form), its interval slab test against
// the cluster boxes, and the front-to-back compaction of the boxes it may
// enter.
//
// Replaces, on the card, the plain compositions in
// raytracing_tpu_torch/kernels/traverse.py (`tile_extents` or
// `_camera_tile_extents`, then `_frustum_slabs` and `_compact_lists`:
// about a hundred PyTorch launches a list build). The JAX package builds
// the same lists in XLA (raytracing_tpu/kernels/traverse.py:
// _visit_lists_single, :325-380, after _extents_kernel :163).
//
// Four entries:
//   rt_tile_lists          rays [8, N] in tiles of ray_tile -> lo, hi
//                          [nt, 8] and the lists over C boxes; a dead tile
//                          (hi[7] <= 0) lists nothing (cnt 0);
//   rt_lists_from_extents  the extents given (K5's dense query, a composed
//                          tile) over G runs of W boxes (K3's groups; G = 1
//                          elsewhere), with an optional mask ANDed into the
//                          flags and an optional tile-alive value (cnt 0
//                          where it is <= 0);
//   rt_camera_lists        camera mode's frustums in closed form from the
//                          camera itself, a row per frame block or per
//                          supertile of blocks (the min/max of its blocks'
//                          frustums: the pooled lists' first stage);
//   rt_camera_member_lists the pooled lists' second stage: a row per frame
//                          block, its own frustum against its supertile's
//                          candidates (gathered by id, those past the
//                          supertile's count unflagged), ids mapped back
//                          to boxes.
// A list row holds (ids [W] i32, tnear [W] f32, cnt): the boxes whose key
// (the entry-t lower bound where flagged, else +inf) is below +inf sorted
// by (key, index), then the others by index with tnear +inf: the order of a
// stable sort by key. cnt counts the flagged boxes.
//
// Bit-equality with the plain version: the slab test runs op for op as
// _frustum_slabs does, with -fmad=false, 1/d correctly rounded, and no
// -ftz (a dead tile's +/-3e38 extents give denormal reciprocals that must
// stay nonzero); fminf/fmaxf are what torch.minimum/maximum compute on
// the card. The camera frustums follow _camera_tile_extents' f32 op order
// (IEEE division, two separate multiplies). The sort is exact: each key
// becomes a 64-bit word (its order bits, then its index), unique within a
// row, so any sorting network gives the stable order. +0.0 and -0.0 tie
// (they are equal under torch.sort); the word keeps a -0.0's sign in its
// lowest bit, below the index, so tnear comes back with the bits the plain
// version returns.
//
// Bound on the card: at the main path's shapes (64 tiles x 790 boxes, 704
// tiles x 100, 2,500 camera blocks x 790) neither bytes (32 a ray in, 8 a
// list position out) nor the ~40 operations of a (tile, box) test: the
// latency of one block a list row. So a block takes a row, the extents
// fold their loads as K6 does (tile_extents.cuh) or come from the camera
// in registers, the boxes are staged in shared memory a chunk at a time,
// warps rank the listed boxes by ballots, and a row of up to kSortCap
// listed boxes sorts in shared memory (bitonic); a wider row sorts
// kSortCap-word chunks there and merges them through device-memory
// scratch by rank (each word's position in the other run by binary
// search), so no width the plain version takes is refused.
#include <limits>

#include "tile_extents.cuh"

namespace rt {
namespace {

typedef unsigned long long u64;

constexpr int kListsMaxThreads = 1024;
// Words a block sorts in shared memory (128 KiB).
constexpr int kSortCap = 16384;

struct ListsParams {
  // rt_tile_lists: the pack, its tile, and the extents it writes.
  const float* rays;
  long long np;
  int ray_tile;
  float* lo_out;
  float* hi_out;
  // rt_lists_from_extents: [nt, 3] extents at a row stride, and an
  // optional tile-alive value a tile.
  const float* o_lo;
  const float* o_hi;
  const float* d_lo;
  const float* d_hi;
  long long ext_stride;
  const float* alive;
  long long alive_stride;
  // Boxes [G * W, 3]; list row r = g * nt + t.
  const float* bmin;
  const float* bmax;
  int n_tiles;
  int width;
  float t_cap;  // +inf: no cap
  // Optional u8 mask: box j of group g on tile t at
  // t * mask_tile_stride + g * W + j.
  const unsigned char* mask;
  long long mask_tile_stride;
  // Outputs [G, nt, W] and [G, nt].
  int* ids;
  float* tnear;
  int* cnt;
  // Rows above kSortCap: [G * nt, 2, W] words and [G * nt, ceil(W / 32)]
  // bits of device memory.
  u64* scratch;
  unsigned* infbits;
  // Words of the dynamic shared-memory sort buffer; the row's +inf bits
  // follow it there when W <= kSortCap.
  int sort_words;
  // rt_camera_lists / rt_camera_member_lists: offs [spp, 2]; the frame of
  // cam_w x cam_h pixels in bh x bw blocks; row r frames block
  // min(tile0 + r, last) (gy = gx = 1) or supertile r of gy x gx blocks on
  // the block grid shifted by (py, px).
  const float* offs;
  int spp;
  int cam_w;
  int cam_h;
  int bh;
  int bw;
  float aspect;
  float scale;
  long long tile0;
  int gy;
  int gx;
  int py;
  int px;
  // Member rows: supertile s's candidate box ids at s * cand_stride, the
  // first cand_cnt[s] of them listed.
  const int* cand;
  long long cand_stride;
  const int* cand_cnt;
};

// Where a list row's frustum comes from.
enum ListsFrom { kFromPack, kFromExtents, kFromCamera, kFromMembers };

__device__ __forceinline__ u64 encode(float key, int j) {
  unsigned u = __float_as_uint(key);
  unsigned neg_zero = 0u;
  if (u == 0x80000000u) {
    u = 0u;
    neg_zero = 1u;
  }
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(ord) << 32) | (static_cast<u64>(j) << 1)
         | neg_zero;
}

__device__ __forceinline__ void decode(u64 w, int* id, float* t) {
  const unsigned ord = static_cast<unsigned>(w >> 32);
  unsigned u = (ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord;
  if (w & 1ull) u = 0x80000000u;
  *id = static_cast<int>((w & 0xffffffffull) >> 1);
  *t = __uint_as_float(u);
}

// Position i of a list row from its word: the box (a member row's
// candidate at the word's index) and its tnear.
template <ListsFrom kFrom>
__device__ __forceinline__ void put_listed(int* ids, float* tnear, int i,
                                           u64 w, const int* cand) {
  int j;
  decode(w, &j, tnear + i);
  ids[i] = kFrom == kFromMembers ? cand[j] : j;
}

// This thread's place among the block's threads whose `pred` holds (in
// thread order), and their count in *total. s_w: 32 ints no thread reads
// from an earlier call that no __syncthreads separates (alternate two).
__device__ __forceinline__ int block_rank(bool pred, int* s_w, int* total) {
  const unsigned b = __ballot_sync(0xffffffffu, pred);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_w[warp] = __popc(b);
  __syncthreads();
  int before = 0;
  int all = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int c = s_w[w];
    before += w < warp ? c : 0;
    all += c;
  }
  *total = all;
  return before + __popc(b & ((1u << lane) - 1u));
}

__device__ __forceinline__ int block_sum(int v, int* s_w) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) s_w[threadIdx.x >> 5] = v;
  __syncthreads();
  int all = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) all += s_w[w];
  return all;
}

// Ascending bitonic sort of s[0, n), n a power of two. Call after a
// __syncthreads that publishes s; returns after one.
__device__ void bitonic_sort(u64* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (j - 1));
        const int hi = lo + j;
        const u64 a = s[lo];
        const u64 b = s[hi];
        if ((a > b) == ((lo & k) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Words of a[0, n) (ascending, unique) below x.
__device__ __forceinline__ int count_less(const u64* a, int n, u64 x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Frame block (br, bc)'s closed-form direction extents (xx_lo, xx_hi,
// yy_lo, yy_hi) in _camera_tile_extents' f32 op order: the pinhole formula
// (camera_dir.cuh's) at the block's extreme pixel + offset, off holding
// the offsets' (x min, x max, y min, y max). yy decreases in y.
__device__ __forceinline__ void camera_block_dirs(const ListsParams& p,
                                                  int br, int bc,
                                                  const float off[4],
                                                  float d[4]) {
  const float wf = static_cast<float>(p.cam_w);
  const float hf = static_cast<float>(p.cam_h);
  const float x_lo = static_cast<float>(bc * p.bw) + off[0];
  const float x_hi = static_cast<float>(bc * p.bw + (p.bw - 1)) + off[1];
  const float y_lo = static_cast<float>(br * p.bh) + off[2];
  const float y_hi = static_cast<float>(br * p.bh + (p.bh - 1)) + off[3];
  d[0] = (2.0f * x_lo / wf - 1.0f) * p.aspect * p.scale;
  d[1] = (2.0f * x_hi / wf - 1.0f) * p.aspect * p.scale;
  d[2] = (1.0f - 2.0f * y_hi / hf) * p.scale;
  d[3] = (1.0f - 2.0f * y_lo / hf) * p.scale;
}

// v[0], v[2] folded by min and v[1], v[3] by max over the warp, into
// every lane.
__device__ __forceinline__ void warp_minmax(float v[4]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = __shfl_xor_sync(0xffffffffu, v[i], o);
      v[i] = (i & 1) ? fmaxf(v[i], x) : fminf(v[i], x);
    }
  }
}

// Warp 0: the frustum of frame blocks [br0, br0 + my) x [bc0, bc0 + mx)
// (those inside the frame: a supertile's padding never widens it) into
// s_ext as the extents rows lay it out: origin 0, directions the min / max
// of the blocks' closed forms (z 1), alive. Lanes take offsets and blocks,
// then fold by shuffles.
__device__ __forceinline__ void camera_frustum(const ListsParams& p,
                                               int br0, int bc0, int my,
                                               int mx, float* s_ext) {
  const int lane = threadIdx.x;
  float off[4] = {inf(), -inf(), inf(), -inf()};
  for (int s = lane; s < p.spp; s += 32) {
    const float ox = p.offs[2 * s];
    const float oy = p.offs[2 * s + 1];
    off[0] = fminf(off[0], ox);
    off[1] = fmaxf(off[1], ox);
    off[2] = fminf(off[2], oy);
    off[3] = fmaxf(off[3], oy);
  }
  const int nby = p.cam_h / p.bh;
  const int nbx = p.cam_w / p.bw;
  float v[4] = {inf(), -inf(), inf(), -inf()};
  warp_minmax(off);  // every lane derives blocks from all the offsets
  for (int m = lane; m < my * mx; m += 32) {
    const int br = br0 + m / mx;
    const int bc = bc0 + m % mx;
    if (br < 0 || br >= nby || bc < 0 || bc >= nbx) continue;
    float d[4];
    camera_block_dirs(p, br, bc, off, d);
    v[0] = fminf(v[0], d[0]);
    v[1] = fmaxf(v[1], d[1]);
    v[2] = fminf(v[2], d[2]);
    v[3] = fmaxf(v[3], d[3]);
  }
  warp_minmax(v);
  if (lane < 13) {
    // o_lo[3] o_hi[3] (0), d_lo = (xx_lo, yy_lo, 1), d_hi, alive (1).
    float e = 0.0f;
    if (lane == 6) e = v[0];
    else if (lane == 7) e = v[2];
    else if (lane == 9) e = v[1];
    else if (lane == 10) e = v[3];
    else if (lane == 8 || lane == 11 || lane == 12) e = 1.0f;
    s_ext[lane] = e;
  }
}

// A list row of a launch: its frustum from kFrom's source, then the slab
// test, ranking and sort every entry shares.
template <ListsFrom kFrom>
__device__ __forceinline__ void lists_row(const ListsParams& p) {
  extern __shared__ u64 s_sort[];
  __shared__ float s_red[kListsMaxThreads / 32][kExtVals];
  __shared__ float s_bmin[3 * kListsMaxThreads];
  __shared__ float s_bmax[3 * kListsMaxThreads];
  // o_lo[3] o_hi[3] d_lo[3] d_hi[3] alive
  __shared__ float s_ext[13];
  __shared__ int s_w[2][32];

  const long long row = blockIdx.x;
  const int t = static_cast<int>(row % p.n_tiles);
  const long long g = row / p.n_tiles;
  const int w_row = p.width;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  // Member rows: the supertile's candidates and how many it listed.
  const int* cand = nullptr;
  int cand_n = 0;

  if constexpr (kFrom == kFromCamera) {
    if (tid < 32) {
      // Direct rows: gy = gx = 1 and py = px = 0, so the grid is the frame.
      const int nbx2 = (p.px + p.cam_w / p.bw + p.gx - 1) / p.gx;
      const int nby2 = (p.py + p.cam_h / p.bh + p.gy - 1) / p.gy;
      const long long q = min(p.tile0 + row,
                              static_cast<long long>(nby2) * nbx2 - 1);
      camera_frustum(p, static_cast<int>(q / nbx2) * p.gy - p.py,
                     static_cast<int>(q % nbx2) * p.gx - p.px, p.gy, p.gx,
                     s_ext);
    }
  } else if constexpr (kFrom == kFromMembers) {
    const int nbx = p.cam_w / p.bw;
    const int br = t / nbx;
    const int bc = t % nbx;
    if (tid < 32) camera_frustum(p, br, bc, 1, 1, s_ext);
    const int nbx2 = (p.px + nbx + p.gx - 1) / p.gx;
    const long long s = static_cast<long long>((br + p.py) / p.gy) * nbx2
                        + (bc + p.px) / p.gx;
    cand = p.cand + s * p.cand_stride;
    cand_n = p.cand_cnt[s];
  } else if constexpr (kFrom == kFromPack) {
    const float v = block_tile_extents(p.rays, p.np, p.ray_tile, t, s_red);
    if (tid < 8) {
      p.lo_out[t * 8LL + tid] = v;
      if (tid < 3) s_ext[tid] = v;
      else if (tid >= 4 && tid < 7) s_ext[6 + tid - 4] = v;
    } else if (tid < kExtVals) {
      p.hi_out[t * 8LL + tid - 8] = v;
      if (tid < 11) s_ext[3 + tid - 8] = v;
      else if (tid >= 12 && tid < 15) s_ext[9 + tid - 12] = v;
      else if (tid == 15) s_ext[12] = v;
    }
  } else if (tid < 13) {
    const long long e = t * p.ext_stride + tid % 3;
    float v;
    switch (tid / 3) {
      case 0: v = p.o_lo[e]; break;
      case 1: v = p.o_hi[e]; break;
      case 2: v = p.d_lo[e]; break;
      case 3: v = p.d_hi[e]; break;
      default: v = p.alive ? p.alive[t * p.alive_stride] : 1.0f;
    }
    s_ext[tid] = v;
  }
  __syncthreads();

  // The frustum's per-axis terms (_frustum_slabs' op order).
  float olo[3], ohi[3], ilo[3], ihi[3];
  bool unb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    olo[k] = s_ext[k];
    ohi[k] = s_ext[3 + k];
    const float dlo = s_ext[6 + k];
    const float dhi = s_ext[9 + k];
    unb[k] = (dlo <= 0.0f) && (dhi >= 0.0f);
    const float dl = fabsf(dlo) < tiny() ? tiny() : dlo;
    const float dh = fabsf(dhi) < tiny() ? tiny() : dhi;
    ilo[k] = 1.0f / dh;
    ihi[k] = 1.0f / dl;
  }
  const bool tile_alive = s_ext[12] > 0.0f;

  const bool in_shared = w_row <= kSortCap;
  const long long box0 = g * w_row;
  u64* listed_words = in_shared ? s_sort : p.scratch + row * 2LL * w_row;
  unsigned* inf_bits = in_shared
      ? reinterpret_cast<unsigned*>(s_sort + p.sort_words)
      : p.infbits + row * ((w_row + 31) / 32);

  // Pass 1: key every box, rank the listed ones (key < +inf) into
  // listed_words in index order, mark the others in inf_bits.
  int m = 0;
  int flagged = 0;
  int par = 0;
  for (int c0 = 0; c0 < w_row; c0 += nthr) {
    const int n = min(nthr, w_row - c0);
    if constexpr (kFrom == kFromMembers) {
      for (int q = tid; q < n; q += nthr) {
        const long long b = cand[c0 + q];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          s_bmin[3 * q + k] = p.bmin[b * 3 + k];
          s_bmax[3 * q + k] = p.bmax[b * 3 + k];
        }
      }
    } else {
      for (int i = tid; i < 3 * n; i += nthr) {
        s_bmin[i] = p.bmin[(box0 + c0) * 3 + i];
        s_bmax[i] = p.bmax[(box0 + c0) * 3 + i];
      }
    }
    __syncthreads();
    const int j = c0 + tid;
    float key = inf();
    bool flag = false;
    if (tid < n) {
      float tn = 0.0f;
      float tf = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float e_lo = s_bmin[3 * tid + k] - ohi[k];
        const float e_hi = s_bmax[3 * tid + k] - olo[k];
        const float p1 = e_lo * ilo[k];
        const float p2 = e_lo * ihi[k];
        const float p3 = e_hi * ilo[k];
        const float p4 = e_hi * ihi[k];
        float mn = fminf(fminf(p1, p2), fminf(p3, p4));
        float mx = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
        if (unb[k]) {
          mn = -inf();
          mx = inf();
        }
        tn = k == 0 ? mn : fmaxf(tn, mn);
        tf = k == 0 ? mx : fminf(tf, mx);
      }
      tf = fminf(tf, p.t_cap);
      flag = (tn <= tf) && (tf >= 0.0f);
      if constexpr (kFrom == kFromMembers) {
        flag = flag && j < cand_n;
      } else if (p.mask != nullptr) {
        flag = flag && p.mask[t * p.mask_tile_stride + box0 + j] != 0;
      }
      key = flag ? tn : inf();
    }
    flagged += flag ? 1 : 0;
    const bool listed = key < inf();
    int total;
    const int r = block_rank(listed, s_w[par], &total);
    if (listed) listed_words[m + r] = encode(key, j);
    const unsigned tail = __ballot_sync(0xffffffffu, tid < n && !listed);
    const int word0 = c0 + (tid & ~31);
    if ((tid & 31) == 0 && word0 < w_row) inf_bits[word0 >> 5] = tail;
    m += total;
    par ^= 1;
  }
  flagged = block_sum(flagged, s_w[par]);
  if (tid == 0) p.cnt[row] = tile_alive ? flagged : 0;

  int* ids = p.ids + row * w_row;
  float* tnear = p.tnear + row * w_row;
  if (in_shared) {
    const int n2 = pow2_at_least(m);
    for (int i = m + tid; i < n2; i += nthr) s_sort[i] = ~0ull;
    __syncthreads();
    bitonic_sort(s_sort, n2);
    for (int i = tid; i < m; i += nthr) {
      put_listed<kFrom>(ids, tnear, i, s_sort[i], cand);
    }
  } else {
    __syncthreads();
    u64* a = listed_words;
    u64* b = listed_words + w_row;
    for (int c = 0; c < m; c += kSortCap) {
      const int n = min(kSortCap, m - c);
      const int n2 = pow2_at_least(n);
      for (int i = tid; i < n2; i += nthr) s_sort[i] = i < n ? a[c + i] : ~0ull;
      __syncthreads();
      bitonic_sort(s_sort, n2);
      for (int i = tid; i < n; i += nthr) a[c + i] = s_sort[i];
      __syncthreads();
    }
    for (long long run = kSortCap; run < m; run <<= 1) {
      for (int i = tid; i < m; i += nthr) {
        const int start = static_cast<int>((i / (2 * run)) * (2 * run));
        const int mid = static_cast<int>(min(start + run, (long long)m));
        const int end = static_cast<int>(min(start + 2 * run, (long long)m));
        const u64 x = a[i];
        const int pos = i < mid
            ? i + count_less(a + mid, end - mid, x)
            : start + (i - mid) + count_less(a + start, mid - start, x);
        b[pos] = x;
      }
      __syncthreads();
      u64* s = a;
      a = b;
      b = s;
    }
    for (int i = tid; i < m; i += nthr) {
      put_listed<kFrom>(ids, tnear, i, a[i], cand);
    }
  }
  __syncthreads();

  // Pass 3: the +inf boxes after the listed ones, by index.
  int done = m;
  for (int c0 = 0; c0 < w_row; c0 += nthr) {
    const int j = c0 + tid;
    const bool tail = j < w_row && ((inf_bits[j >> 5] >> (j & 31)) & 1u);
    int total;
    const int r = block_rank(tail, s_w[par], &total);
    if (tail) {
      ids[done + r] = kFrom == kFromMembers ? cand[j] : j;
      tnear[done + r] = inf();
    }
    done += total;
    par ^= 1;
  }
}

template <bool kFromRays>
__global__ void __launch_bounds__(kListsMaxThreads)
lists_kernel(const ListsParams p) {
  lists_row<kFromRays ? kFromPack : kFromExtents>(p);
}

// Camera mode's rows: a frame block's or a supertile's frustum in closed
// form (kMembers false), or a member block's re-test of its supertile's
// candidates (true).
template <bool kMembers>
__global__ void __launch_bounds__(kListsMaxThreads)
camera_lists_kernel(const ListsParams p) {
  lists_row<kMembers ? kFromMembers : kFromCamera>(p);
}

typedef void (*ListsKernel)(ListsParams);

// Threads and dynamic shared memory of a launch over rows of W boxes.
void lists_shape(int width, int* threads, int* sort_words, size_t* smem) {
  const int capped = width <= kSortCap ? width : kSortCap;
  int p2 = 1;
  while (p2 < capped) p2 <<= 1;
  *threads = p2 / 2 < 128 ? 128 : (p2 / 2 > kListsMaxThreads
                                   ? kListsMaxThreads : p2 / 2);
  *sort_words = p2;
  *smem = sizeof(u64) * p2
          + (width <= kSortCap ? sizeof(unsigned) * ((width + 31) / 32) : 0);
}

int lists_launch(ListsKernel kernel, ListsParams p, long long rows,
                 void* stream) {
  if (rows <= 0 || rows >= (1LL << 31) || p.width <= 0 || p.n_tiles <= 0
      || (p.width > kSortCap && (p.scratch == nullptr
                                 || p.infbits == nullptr))) {
    return cudaErrorInvalidValue;
  }
  int threads;
  size_t smem;
  lists_shape(p.width, &threads, &p.sort_words, &smem);
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<static_cast<unsigned>(rows), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace rt

// rays [8, np] f32 in tiles of ray_tile (16-byte aligned), boxes [c, 3],
// t_cap (+inf: none) -> lo, hi [nt, 8], ids [nt, c] i32, tnear [nt, c],
// cnt [nt] i32; scratch [nt, 2, c] u64 and infbits [nt, ceil(c / 32)] when
// c is above 16,384 (else may be null).
extern "C" int rt_tile_lists(const float* rays, long long np, int ray_tile,
                             const float* bmin, const float* bmax, int c,
                             float t_cap, float* lo, float* hi, int* ids,
                             float* tnear, int* cnt, void* scratch,
                             void* infbits, void* stream) {
  if (!rt::ray_tile_ok(np, ray_tile)
      || reinterpret_cast<unsigned long long>(rays) % 16) {
    return cudaErrorInvalidValue;
  }
  rt::ListsParams p{};
  p.rays = rays;
  p.np = np;
  p.ray_tile = ray_tile;
  p.lo_out = lo;
  p.hi_out = hi;
  p.bmin = bmin;
  p.bmax = bmax;
  p.n_tiles = static_cast<int>(np / ray_tile);
  p.width = c;
  p.t_cap = t_cap;
  p.ids = ids;
  p.tnear = tnear;
  p.cnt = cnt;
  p.scratch = static_cast<rt::u64*>(scratch);
  p.infbits = static_cast<unsigned*>(infbits);
  return rt::lists_launch(rt::lists_kernel<true>, p, p.n_tiles, stream);
}

// Extents o_lo, o_hi, d_lo, d_hi: [n_tiles, 3] rows ext_stride floats
// apart; alive: null or [n_tiles] at alive_stride; boxes [groups * width,
// 3]; mask: null or u8 as ListsParams says -> ids [groups, n_tiles, width]
// i32, tnear, cnt [groups, n_tiles] i32; scratch and infbits as
// rt_tile_lists' over groups * n_tiles rows.
extern "C" int rt_lists_from_extents(
    const float* o_lo, const float* o_hi, const float* d_lo,
    const float* d_hi, long long ext_stride, const float* alive,
    long long alive_stride, int n_tiles, const float* bmin,
    const float* bmax, int groups, int width, float t_cap,
    const unsigned char* mask, long long mask_tile_stride, int* ids,
    float* tnear, int* cnt, void* scratch, void* infbits, void* stream) {
  if (groups <= 0) return cudaErrorInvalidValue;
  rt::ListsParams p{};
  p.o_lo = o_lo;
  p.o_hi = o_hi;
  p.d_lo = d_lo;
  p.d_hi = d_hi;
  p.ext_stride = ext_stride;
  p.alive = alive;
  p.alive_stride = alive_stride;
  p.bmin = bmin;
  p.bmax = bmax;
  p.n_tiles = n_tiles;
  p.width = width;
  p.t_cap = t_cap;
  p.mask = mask;
  p.mask_tile_stride = mask_tile_stride;
  p.ids = ids;
  p.tnear = tnear;
  p.cnt = cnt;
  p.scratch = static_cast<rt::u64*>(scratch);
  p.infbits = static_cast<unsigned*>(infbits);
  return rt::lists_launch(rt::lists_kernel<false>, p,
                          static_cast<long long>(groups) * n_tiles, stream);
}

namespace rt {
namespace {

// The camera fields of ListsParams; false unless the frame is whole blocks
// of a positive size, spp is positive and the supertile grid's shift lies
// inside a supertile.
bool camera_params(ListsParams* p, const float* offs, int spp, int width,
                   int height, int bh, int bw, float aspect, float scale,
                   int gy, int gx, int py, int px) {
  if (offs == nullptr || spp <= 0 || bh <= 0 || bw <= 0 || width <= 0
      || height <= 0 || width % bw || height % bh || gy <= 0 || gx <= 0
      || py < 0 || py >= gy || px < 0 || px >= gx) {
    return false;
  }
  p->offs = offs;
  p->spp = spp;
  p->cam_w = width;
  p->cam_h = height;
  p->bh = bh;
  p->bw = bw;
  p->aspect = aspect;
  p->scale = scale;
  p->gy = gy;
  p->gx = gx;
  p->py = py;
  p->px = px;
  return true;
}

}  // namespace
}  // namespace rt

// Camera mode's lists from the camera itself: offs [spp, 2] f32, the
// frame of width x height pixels in bh x bw blocks, aspect and scale as
// the camera walk takes them. With gy = gx = 1 (py = px = 0) row r lists
// frame block min(tile0 + r, last block); else row r lists supertile r of
// gy x gx blocks on the block grid shifted by (py, px) (tile0 0), over
// the min / max of its blocks' frustums. Boxes [c, 3] -> ids [rows, c]
// i32, tnear, cnt [rows] i32; scratch and infbits as rt_tile_lists' over
// `rows` rows.
extern "C" int rt_camera_lists(const float* offs, int spp, int width,
                               int height, int bh, int bw, float aspect,
                               float scale, long long tile0, int rows,
                               int gy, int gx, int py, int px,
                               const float* bmin, const float* bmax, int c,
                               int* ids, float* tnear, int* cnt,
                               void* scratch, void* infbits, void* stream) {
  rt::ListsParams p{};
  if (!rt::camera_params(&p, offs, spp, width, height, bh, bw, aspect,
                         scale, gy, gx, py, px)
      || tile0 < 0 || (gy * gx > 1 && tile0 != 0)) {
    return cudaErrorInvalidValue;
  }
  p.tile0 = tile0;
  p.bmin = bmin;
  p.bmax = bmax;
  p.n_tiles = rows;
  p.width = c;
  p.t_cap = std::numeric_limits<float>::infinity();
  p.ids = ids;
  p.tnear = tnear;
  p.cnt = cnt;
  p.scratch = static_cast<rt::u64*>(scratch);
  p.infbits = static_cast<unsigned*>(infbits);
  return rt::lists_launch(rt::camera_lists_kernel<false>, p, rows, stream);
}

// The pooled camera lists' second stage: a row per frame block (block
// order), its own closed-form frustum against its supertile s's
// candidates: box ids cand[s * cand_stride + j] for j < width, those at
// j >= cand_cnt[s] unflagged (supertiles and their grid as
// rt_camera_lists' rows). -> ids [blocks, width] (box ids), tnear, cnt
// [blocks]; scratch and infbits over the blocks' rows.
extern "C" int rt_camera_member_lists(
    const float* offs, int spp, int width, int height, int bh, int bw,
    float aspect, float scale, int gy, int gx, int py, int px,
    const int* cand, long long cand_stride, const int* cand_cnt,
    int list_width, const float* bmin, const float* bmax, int* ids,
    float* tnear, int* cnt, void* scratch, void* infbits, void* stream) {
  rt::ListsParams p{};
  if (!rt::camera_params(&p, offs, spp, width, height, bh, bw, aspect,
                         scale, gy, gx, py, px)
      || cand == nullptr || cand_cnt == nullptr
      || cand_stride < list_width) {
    return cudaErrorInvalidValue;
  }
  const long long rows = static_cast<long long>(height / bh) * (width / bw);
  p.cand = cand;
  p.cand_stride = cand_stride;
  p.cand_cnt = cand_cnt;
  p.bmin = bmin;
  p.bmax = bmax;
  p.n_tiles = static_cast<int>(rows);
  p.width = list_width;
  p.t_cap = std::numeric_limits<float>::infinity();
  p.ids = ids;
  p.tnear = tnear;
  p.cnt = cnt;
  p.scratch = static_cast<rt::u64*>(scratch);
  p.infbits = static_cast<unsigned*>(infbits);
  return rt::lists_launch(rt::camera_lists_kernel<true>, p, rows, stream);
}

// Resident blocks a multiprocessor holds of an instance over rows of
// `width` boxes, at the threads and shared memory a launch takes: `from`
// 1 the pack's, 0 the extents', 2 the camera's, 3 the camera's member
// rows; *threads gets those threads.
extern "C" int rt_lists_occupancy(int from, int width, int* threads,
                                  int* blocks) {
  static const rt::ListsKernel kernels[] = {
      rt::lists_kernel<false>, rt::lists_kernel<true>,
      rt::camera_lists_kernel<false>, rt::camera_lists_kernel<true>};
  if (from < 0 || from > 3) return cudaErrorInvalidValue;
  int sort_words;
  size_t smem;
  rt::lists_shape(width, threads, &sort_words, &smem);
  const rt::ListsKernel fn = kernels[from];
  cudaError_t rc = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, *threads, smem));
}
