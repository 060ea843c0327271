// The backward's segment scatter-add (ops/scatter.segment_scatter_add):
// out[idx[i], :] += vals[i, :] for every lane i whose index lies in
// [0, rows), into out [rows, K] f32, K <= 9.
//
// Replaces PyTorch's index_add_ into rows + 1 rows, where every dead or
// missed lane of a differentiated walk pointed at the extra "drop bucket"
// row: in an inverse-fit step ~92% of the lanes, whose atomics all landed
// on the same K floats and serialised in the L2. Here a lane whose index
// is out of range returns before it reads its values or issues an atomic.
// The JAX package computes this sum with a sort and a cumulative sum above
// 32,768 rows (its TPU runs a scatter-add serially); that form is not
// ported.
//
// A live lane adds its K values with one atomicAdd per column; in the fit
// the live lanes spread over tens of thousands of rows, and aggregating a
// warp's lanes of one row first (__match_any_sync and shuffles) measured no
// faster on the card. Sums stay float32; only the order of the additions
// differs from index_add_'s, and that order is not fixed under atomics
// either.
//
// Under torch.use_deterministic_algorithms(True) the caller sorts idx
// (stably) and passes the permutation: then the first lane of each row in
// sorted order sums that row's lanes in lane order and adds the sums once,
// with no atomic on the table, so a sum has the same bits in every run.
//
// What bounds it: device memory and the live lanes' atomics. A lane reads
// its index (4 or 8 bytes) and, if live, its K values; one thread a lane,
// 256 a block.
#include "common.cuh"

namespace rt {
namespace {

constexpr int kScatterThreads = 256;
constexpr int kMaxScatterCols = 9;

template <typename Idx>
struct ScatterParams {
  long long n;               // lanes
  long long rows;            // rows of out; an index outside [0, rows) drops
  int k;                     // columns, 1 to kMaxScatterCols
  const Idx* idx;            // [n]; sorted where order is not null
  const float* vals;         // [n, K], row i at vals + i * vs0
  long long vs0;
  float* out;                // [rows, K] contiguous
  unsigned long long* added; // the lanes in range are added here; or null
  const long long* order;    // [n]: the lane at each sorted place; or null
};

__device__ __forceinline__ bool in_range(long long row, long long rows) {
  return static_cast<unsigned long long>(row)
         < static_cast<unsigned long long>(rows);
}

// Every thread of the block calls it: one atomic a block for the count.
__device__ __forceinline__ void count_live(bool live,
                                           unsigned long long* added) {
  if (added == nullptr) return;
  const int n_live = __syncthreads_count(live);
  if (threadIdx.x == 0 && n_live) {
    atomicAdd(added, static_cast<unsigned long long>(n_live));
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kScatterThreads)
scatter_add_kernel(const ScatterParams<Idx> p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScatterThreads + threadIdx.x;
  const long long row = i < p.n ? static_cast<long long>(p.idx[i]) : -1;
  const bool live = in_range(row, p.rows);
  count_live(live, p.added);
  if (!live) return;
  const float* src = p.vals + i * p.vs0;
  float* dst = p.out + row * p.k;
#pragma unroll
  for (int c = 0; c < kMaxScatterCols; ++c) {
    if (c < p.k) atomicAdd(dst + c, src[c]);
  }
}

// The deterministic form: idx sorted, place j holding lane order[j].
template <typename Idx>
__global__ void __launch_bounds__(kScatterThreads)
scatter_sorted_kernel(const ScatterParams<Idx> p) {
  const long long j =
      static_cast<long long>(blockIdx.x) * kScatterThreads + threadIdx.x;
  const long long row = j < p.n ? static_cast<long long>(p.idx[j]) : -1;
  const bool live = in_range(row, p.rows);
  count_live(live, p.added);
  if (!live || (j > 0 && static_cast<long long>(p.idx[j - 1]) == row)) {
    return;
  }
  float v[kMaxScatterCols] = {};
  for (long long m = j; m < p.n && static_cast<long long>(p.idx[m]) == row;
       ++m) {
    const float* src = p.vals + p.order[m] * p.vs0;
#pragma unroll
    for (int c = 0; c < kMaxScatterCols; ++c) {
      if (c < p.k) v[c] += src[c];
    }
  }
  float* dst = p.out + row * p.k;
#pragma unroll
  for (int c = 0; c < kMaxScatterCols; ++c) {
    if (c < p.k) dst[c] += v[c];
  }
}

template <typename Idx>
int launch(const ScatterParams<Idx>& p, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(
      (p.n + kScatterThreads - 1) / kScatterThreads);
  if (p.order != nullptr) {
    scatter_sorted_kernel<Idx><<<grid, kScatterThreads, 0, stream>>>(p);
  } else {
    scatter_add_kernel<Idx><<<grid, kScatterThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace rt

// out [rows, k] f32 (contiguous, zeroed or accumulated by the caller) +=
// vals [n, k] f32 (row i at vals + i * vs0, its k values contiguous) at
// rows idx [n] (int32 where idx_bytes is 4, int64 where 8); a lane whose
// index is outside [0, rows) is skipped. Where `order` is not null, idx is
// sorted (stably) and order [n] int64 holds the lane of each place: each
// row is then summed in lane order, without atomics. Where `added` is not
// null, the count of lanes in range is added to it (an int64 on the card).
extern "C" int rt_segment_scatter_add(const void* idx, int idx_bytes,
                                      long long n, long long rows, int k,
                                      const float* vals, long long vs0,
                                      float* out, unsigned long long* added,
                                      const long long* order, void* stream) {
  const long long blocks =
      (n + rt::kScatterThreads - 1) / rt::kScatterThreads;
  if (n <= 0 || blocks > 2147483647ll || rows <= 0 || k < 1
      || k > rt::kMaxScatterCols || vs0 < k || idx == nullptr
      || vals == nullptr || out == nullptr
      || (idx_bytes != 4 && idx_bytes != 8)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) {
    return rt::launch(rt::ScatterParams<int>{n, rows, k,
                                             static_cast<const int*>(idx),
                                             vals, vs0, out, added, order},
                      s);
  }
  return rt::launch(
      rt::ScatterParams<long long>{n, rows, k,
                                   static_cast<const long long*>(idx), vals,
                                   vs0, out, added, order},
      s);
}
