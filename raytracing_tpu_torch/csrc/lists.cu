// Phases 1 and 2 of a kernel query in one launch: a tile's frustum (K6's
// extents), its interval slab test against the cluster boxes, and the
// front-to-back compaction of the boxes it may enter.
//
// Replaces, on the card, the plain composition in
// raytracing_tpu_torch/kernels/traverse.py (`tile_extents`, then
// `_frustum_slabs` and `_compact_lists`: about a hundred PyTorch launches a
// list build). The JAX package builds the same lists in XLA
// (raytracing_tpu/kernels/traverse.py:_visit_lists_single, :325-380,
// after _extents_kernel :163).
//
// Two entries:
//   rt_tile_lists          rays [8, N] in tiles of ray_tile -> lo, hi
//                          [nt, 8] and the lists over C boxes; a dead tile
//                          (hi[7] <= 0) lists nothing (cnt 0);
//   rt_lists_from_extents  the extents given (K5's dense query, camera
//                          mode's closed form, the pooled supertiles, a
//                          composed tile) over G runs of W boxes (K3's
//                          groups; G = 1 elsewhere), with an optional mask
//                          ANDed into the flags and an optional tile-alive
//                          value (cnt 0 where it is <= 0).
// A list row holds (ids [W] i32, tnear [W] f32, cnt): the boxes whose key
// (the entry-t lower bound where flagged, else +inf) is below +inf sorted
// by (key, index), then the others by index with tnear +inf: the order of a
// stable sort by key. cnt counts the flagged boxes.
//
// Bit-equality with the plain version: the slab test runs op for op as
// _frustum_slabs does, with -fmad=false, 1/d correctly rounded, and no
// -ftz (a dead tile's +/-3e38 extents give denormal reciprocals that must
// stay nonzero); fminf/fmaxf are what torch.minimum/maximum compute on
// the card. The sort is exact: each key becomes a 64-bit word (its order
// bits, then its index), unique within a row, so any sorting network
// gives the stable order. +0.0 and -0.0 tie (they are equal under
// torch.sort); the word keeps a -0.0's sign in its lowest bit, below the
// index, so tnear comes back with the bits the plain version returns.
//
// Bound on the card: at the main path's shapes (64 tiles x 790 boxes, 704
// tiles x 100) neither bytes (32 a ray in, 8 a list position out) nor the
// ~40 operations of a (tile, box) test: the latency of one block a list
// row. So a block takes a row, the extents fold their loads as K6 does
// (tile_extents.cuh), the boxes are staged in shared memory a chunk at a
// time, warps rank the listed boxes by ballots, and a row of up to
// kSortCap listed boxes sorts in shared memory (bitonic); a wider row
// sorts kSortCap-word chunks there and merges them through device-memory
// scratch by rank (each word's position in the other run by binary
// search), so no width the plain version takes is refused.
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
};

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

template <bool kFromRays>
__global__ void __launch_bounds__(kListsMaxThreads)
lists_kernel(const ListsParams p) {
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

  if (kFromRays) {
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
    for (int i = tid; i < 3 * n; i += nthr) {
      s_bmin[i] = p.bmin[(box0 + c0) * 3 + i];
      s_bmax[i] = p.bmax[(box0 + c0) * 3 + i];
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
      if (p.mask != nullptr) {
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
    for (int i = tid; i < m; i += nthr) decode(s_sort[i], ids + i, tnear + i);
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
    for (int i = tid; i < m; i += nthr) decode(a[i], ids + i, tnear + i);
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
      ids[done + r] = j;
      tnear[done + r] = inf();
    }
    done += total;
    par ^= 1;
  }
}

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

template <bool kFromRays>
int lists_launch(ListsParams p, long long rows, void* stream) {
  if (rows <= 0 || rows >= (1LL << 31) || p.width <= 0 || p.n_tiles <= 0
      || (p.width > kSortCap && (p.scratch == nullptr
                                 || p.infbits == nullptr))) {
    return cudaErrorInvalidValue;
  }
  int threads;
  size_t smem;
  lists_shape(p.width, &threads, &p.sort_words, &smem);
  const cudaError_t set = cudaFuncSetAttribute(
      lists_kernel<kFromRays>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  lists_kernel<kFromRays><<<static_cast<unsigned>(rows), threads, smem,
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
  return rt::lists_launch<true>(p, p.n_tiles, stream);
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
  return rt::lists_launch<false>(
      p, static_cast<long long>(groups) * n_tiles, stream);
}

// Resident blocks a multiprocessor holds of the rays (from_rays 1) or
// extents (0) instance over rows of `width` boxes, at the threads and
// shared memory a launch takes; *threads gets those threads.
extern "C" int rt_lists_occupancy(int from_rays, int width, int* threads,
                                  int* blocks) {
  int sort_words;
  size_t smem;
  rt::lists_shape(width, threads, &sort_words, &smem);
  auto fn = from_rays ? &rt::lists_kernel<true> : &rt::lists_kernel<false>;
  cudaError_t rc = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, *threads, smem));
}
