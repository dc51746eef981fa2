// Flat (brute-force) exact kNN for the port's flat route.
//
// Replaces: src/repro/kernels/knn/kernel.py:knn_pallas (body _knn_kernel),
// the TPU kernel that tiles |q|^2 - 2 q.p + |p|^2 through the MXU and keeps
// a running top-k in VMEM scratch.
//
// What bounds it on an H100: with D <= 3 there is no matrix product worth
// a tensor core; each (query, valid slot) pair costs D subtractions, D
// multiplies and D-1 adds in fp32 plus a compare, so the work is bound by
// fp32 issue on the CUDA cores, and the bytes (Q*D + N*D floats, N flags,
// Q*k outputs) are tiny. At the flat phase's shape (4096 queries, 20,480
// slots of which 2,048 valid) that work is under a microsecond of the
// card: what a kernel can lose is parallelism and latency. One thread a
// query over all slots gives 32 CTAs of 4 warps for 132 SMs, three
// quarters of the card idle and nothing to hide a load behind.
//
// What the design does about it: two launches.
//   knn_flat_split_kernel -- a grid of query tiles x slot splits, sized
//       by the wrapper to at least ~4 CTAs an SM. One thread a query keeps
//       its query in registers and its top-k of the split's slots: in
//       registers for k <= 16 (a branch-free shift network over a list
//       right-aligned in 16 entries), else in shared memory (one warp a
//       CTA, entry i of thread t at list[i * 32 + t]). The CTA stages 256
//       slots at a time: warp ballots over the validity flags compact the
//       valid slots, in slot order, into shared memory, coordinates
//       fetched for those only, so every thread scans only valid points
//       (one shared-memory broadcast a point). A point costs one compare
//       against the thread's k-th best; 32 points are scored into a
//       candidate mask before the thread inserts its own candidates, so a
//       warp waits for its busiest thread's inserts, not for every point
//       some thread takes.
//   knn_flat_merge_kernel -- one warp a query, one split's sorted list a
//       lane (so at most 32 splits): k rounds of a warp minimum of the
//       lists' heads by (d2, slot index) emit the results in order.
// Ties keep lax.top_k's order (ascending distance, then slot index): a
// split scans its slots in index order and a candidate enters only when
// strictly below the k-th, after entries of equal distance, so each list
// is sorted by (d2, slot); the merge takes the smallest 64-bit key (d2's
// bits over the slot; d2 >= 0, so bit order is float order). Distances
// are the direct sum over d = 0..D-1 of (q_d - p_d)^2 with
// round-to-nearest intrinsics (and -fmad=false), so the result equals the
// plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr float kBig = 3.4e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 256;          // slots a CTA stages at a time
constexpr int kChunks = kTile / 32;
constexpr int kRegK = 16;           // the largest k kept in registers
constexpr int kSmemThreads = 32;    // threads a CTA above kRegK
constexpr unsigned kNoId = 0xffffffffu;
constexpr int kMaxSplits = 32;      // one split a lane of the merge

template <int D>
__device__ __forceinline__ float direct_d2(const float* q, const float* p) {
  float acc = __fmul_rn(__fsub_rn(q[0], p[0]), __fsub_rn(q[0], p[0]));
#pragma unroll
  for (int d = 1; d < D; ++d) {
    const float df = __fsub_rn(q[d], p[d]);
    acc = __fadd_rn(acc, __fmul_rn(df, df));
  }
  return acc;
}

__device__ __forceinline__ u64 key_of(float d, unsigned id) {
  return static_cast<u64>(__float_as_uint(d)) << 32 | id;
}

// A thread's running top-k, ascending by (d2, id); every new candidate's
// id exceeds the ids held, so only d2 is compared and it goes after equal
// distances. In registers: right-aligned in kRegK entries (entries below
// kRegK - k hold -1, below any d2), so the k-th is always the last entry.
struct RegTopK {
  float d[kRegK];
  unsigned p[kRegK];
  __device__ __forceinline__ void init(int k, u64*, int, int) {
#pragma unroll
    for (int i = 0; i < kRegK; ++i) {
      d[i] = i < kRegK - k ? -1.f : kBig;
      p[i] = kNoId;
    }
  }
  __device__ __forceinline__ float kth() const { return d[kRegK - 1]; }
  __device__ __forceinline__ float insert(float x, unsigned id, int) {
    // entry i takes entry i-1 if x sorts before it, else x if x sorts
    // before entry i, else keeps its own
#pragma unroll
    for (int i = kRegK - 1; i > 0; --i) {
      const bool up = x < d[i - 1];
      const bool here = x < d[i];
      p[i] = up ? p[i - 1] : (here ? id : p[i]);
      d[i] = up ? d[i - 1] : (here ? x : d[i]);
    }
    if (x < d[0]) {
      d[0] = x;
      p[0] = id;
    }
    return d[kRegK - 1];
  }
  __device__ __forceinline__ u64 entry(int i, int k) const {
    u64 out = 0;
#pragma unroll
    for (int j = 0; j < kRegK; ++j)
      if (j == kRegK - k + i) out = key_of(d[j], p[j]);
    return out;
  }
};

// In shared memory for larger k: entry i of thread t at list[i * T + t],
// an insertion sort from the back.
struct SmemTopK {
  u64* list;
  int t, T;
  float kd;
  __device__ __forceinline__ void init(int k, u64* smem, int tid, int n) {
    list = smem;
    t = tid;
    T = n;
    for (int i = 0; i < k; ++i) list[i * T + t] = key_of(kBig, kNoId);
    kd = kBig;
  }
  __device__ __forceinline__ float kth() const { return kd; }
  __device__ __forceinline__ float insert(float x, unsigned id, int k) {
    const u64 key = key_of(x, id);
    int at = k - 1;
    while (at > 0) {
      const u64 prev = list[(at - 1) * T + t];
      if (prev < key) break;
      list[at * T + t] = prev;
      --at;
    }
    list[at * T + t] = key;
    kd = __uint_as_float(static_cast<unsigned>(list[(k - 1) * T + t] >> 32));
    return kd;
  }
  __device__ __forceinline__ u64 entry(int i, int) const {
    return list[i * T + t];
  }
};

template <class TopK>
constexpr bool kInSmem = false;
template <>
constexpr bool kInSmem<SmemTopK> = true;

template <int D, class TopK>
__global__ void knn_flat_split_kernel(const float* __restrict__ q,
                                      const float* __restrict__ p,
                                      const unsigned char* __restrict__ ok,
                                      int Q, int N, int k, int per,
                                      u64* __restrict__ part) {
  extern __shared__ u64 smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int nw = T / 32;
  u64* lists = smem;
  float* sp = reinterpret_cast<float*>(smem + (kInSmem<TopK> ? k * T : 0));
  unsigned* sid = reinterpret_cast<unsigned*>(sp + kTile * D);
  unsigned* mask = sid + kTile;
  const unsigned below = (1u << lane) - 1u;

  const long long qi = static_cast<long long>(blockIdx.x) * T + t;
  const bool live = qi < Q;
  float qv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qv[d] = live ? q[qi * D + d] : 0.f;
  TopK top;
  top.init(k, lists, t, T);
  float kth = top.kth();

  const int s0 = blockIdx.y * per;
  const int s1 = min(s0 + per, N);
  for (int base = s0; base < s1; base += kTile) {
    const int n = min(kTile, s1 - base);
    __syncthreads();   // the tile before is consumed
    for (int c = warp; c < kChunks; c += nw) {
      const int o = c * 32 + lane;
      const unsigned m = __ballot_sync(kFull, o < n && ok[base + o]);
      if (lane == 0) mask[c] = m;
    }
    __syncthreads();
    int nv = 0;
    for (int c = 0; c < kChunks; ++c) {
      const unsigned m = mask[c];
      if (c % nw == warp && ((m >> lane) & 1u)) {
        const int at = nv + __popc(m & below);
        const long long j = base + c * 32 + lane;
#pragma unroll
        for (int d = 0; d < D; ++d) sp[at * D + d] = p[j * D + d];
        sid[at] = static_cast<unsigned>(j);
      }
      nv += __popc(m);
    }
    __syncthreads();
    if (!live) continue;
    // score 32 points into a candidate mask, then insert the thread's own
    // candidates in slot order (each checked again against the k-th it
    // has reached): the warp waits for its busiest thread's inserts, not
    // for every point some thread takes
    for (int o0 = 0; o0 < nv; o0 += 32) {
      const int cnt = min(32, nv - o0);
      unsigned cand = 0;
#pragma unroll 8
      for (int u = 0; u < cnt; ++u)
        cand |= static_cast<unsigned>(
                    direct_d2<D>(qv, sp + (o0 + u) * D) < kth) << u;
      while (cand) {
        const int u = __ffs(cand) - 1;
        cand &= cand - 1;
        const float d2 = direct_d2<D>(qv, sp + (o0 + u) * D);
        if (d2 < kth) kth = top.insert(d2, sid[o0 + u], k);
      }
    }
  }
  if (!live) return;
  u64* out = part + (static_cast<long long>(blockIdx.y) * Q + qi) * k;
  for (int i = 0; i < k; ++i) out[i] = top.entry(i, k);
}

// One warp a query: lane s walks split s's sorted list (a head and the
// entry after it in registers), and k rounds of a warp minimum over the
// heads' (d2, id) keys emit the query's results in order; the winning
// lane steps on. Keys of real entries are unique (ids are); once the
// minimum is an empty entry every head is one.
__global__ void knn_flat_merge_kernel(const u64* __restrict__ part, int Q,
                                      int S, int k,
                                      float* __restrict__ out_d,
                                      int* __restrict__ out_i) {
  const int lane = threadIdx.x % 32;
  const long long qi =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  if (qi >= Q) return;   // the whole warp
  constexpr u64 kNone = ~0ull;
  const u64* list = part + (static_cast<long long>(lane) * Q + qi) * k;
  const bool mine = lane < S;
  u64 head = mine ? list[0] : kNone;
  u64 next = mine && k > 1 ? list[1] : kNone;
  int at = 0;
  for (int i = 0; i < k; ++i) {
    u64 m = head;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const u64 x = __shfl_xor_sync(kFull, m, o);
      m = x < m ? x : m;
    }
    if (lane == 0) {
      const float d = __uint_as_float(static_cast<unsigned>(m >> 32));
      out_d[qi * k + i] = d;
      out_i[qi * k + i] = d >= kBig ? -1 : static_cast<int>(m);
    }
    if (head == m) {
      ++at;
      head = next;
      next = mine && at + 1 < k ? list[at + 1] : kNone;
    }
  }
}

template <int D, class TopK>
int launch(const float* q, const float* p, const unsigned char* ok, int Q,
           int N, int k, int threads, int splits, int per, u64* part,
           float* out_d, int* out_i, cudaStream_t stream) {
  const size_t lists = kInSmem<TopK> ? sizeof(u64) * k * threads : 0;
  const size_t split_smem = lists + sizeof(float) * kTile * D +
                            sizeof(unsigned) * (kTile + kChunks);
  const int q_tiles = (Q + threads - 1) / threads;
  if (q_tiles == 0) return static_cast<int>(cudaGetLastError());
  knn_flat_split_kernel<D, TopK>
      <<<dim3(q_tiles, splits), threads, split_smem, stream>>>(
          q, p, ok, Q, N, k, per, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kMergeThreads = 128;   // four queries a CTA
  const long long lanes = 32ll * Q;
  knn_flat_merge_kernel<<<static_cast<int>((lanes + kMergeThreads - 1) /
                                           kMergeThreads),
                          kMergeThreads, 0, stream>>>(part, Q, splits, k,
                                                      out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries (Q, D) f32, points (N, D) f32, ok (N,) bool as bytes, all
// contiguous on the device; the split plan from the wrapper: `threads` a
// CTA (128 for k <= 16, else 32), `splits` slot ranges of `per` slots
// (the last may be shorter), part (splits, Q, k) u64 scratch. Writes d2
// (Q, k) ascending and ids (Q, k), -1 where fewer than k points are valid.
// Two launches; returns cudaGetLastError().
extern "C" int knn_flat_launch(const float* q, const float* p,
                               const unsigned char* ok, int Q, int N, int D,
                               int k, int threads, int splits, int per,
                               unsigned long long* part, float* out_d,
                               int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool reg = k <= kRegK;
  if ((reg && threads % 32 != 0) || (!reg && threads != kSmemThreads) ||
      splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
#define FLAT_CASE(DD)                                                      \
  case DD:                                                                 \
    return reg ? launch<DD, RegTopK>(q, p, ok, Q, N, k, threads, splits,   \
                                     per, part, out_d, out_i, s)           \
               : launch<DD, SmemTopK>(q, p, ok, Q, N, k, threads, splits,  \
                                      per, part, out_d, out_i, s);
  switch (D) {
    FLAT_CASE(1)
    FLAT_CASE(2)
    FLAT_CASE(3)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLAT_CASE
}
