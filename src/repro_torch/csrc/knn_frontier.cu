// Fused frontier kNN for the port's auto route above R*C = 2^15.
//
// Replaces: src/repro/kernels/frontier/kernel.py:knn_frontier_pallas (body
// _frontier_kernel), the TPU kernel that runs a sequential
// (query_blocks, groups) grid, fetches each group tile through a
// scalar-prefetched index map, scores it with the centered MXU identity and
// predicates a whole step away once the group's lower bound passes the
// block's worst k-th best distance.
//
// What bounds it on an H100: on spac-h (main) the scored pairs' CUDA-core
// operations: a visited group holds ~256 live points of its 512 slots, and
// every live point costs D subtractions, D multiplies, D - 1 adds and a
// compare for each of the block's 32 queries (D <= 3: no tensor-core
// product is worth forming). On porth and zd a row holds ~1.5 points of 64,
// so a group holds ~12 live points and the groups' bytes (512 validity
// bytes each, plus the live points' coordinates) bound it instead. In both
// cases the length of the walk is what the data sets: the slowest query
// block walks 5-6x the mean.
//
// What the design does about it:
// - The walk of one query block is split across many warps on many SMs.
//   The grid is nqb x S CTAs of kWarps warps ("walkers"), split-major so
//   that the first wave covers every query block. Each walker claims the
//   block's next group from a cursor in device memory (atomicAdd), so the
//   walk keeps its ascending lower-bound order with no fixed partition,
//   and the CTAs launched after the first wave join whichever walks are
//   still going (light blocks' late CTAs exit at their first claim).
// - The bound stays conservative. A walker keeps its own top-k of the
//   block's queries, one lane a query, and publishes each lane's k-th best
//   with atomicMax on the inverted float bits (d2 >= 0, so float order is
//   integer order; 0 means "none yet"). Any partial list's k-th is an upper
//   bound on the true k-th, so a claim whose lower bound is strictly above
//   the block's worst published k-th cannot hold a result, and neither can
//   any later group: the walker stops. Every group the plain walk scores
//   that can hold a result is scored.
// - A group (at most 512 slots) is staged without a CTA barrier: the warp
//   reads its validity bytes as one 16-byte load a lane (fetched while the
//   group before is scored; byte loads where C is not a multiple of 16 or
//   the flags are unaligned), compacts the live slots (valid & active) in slot
//   order with a prefix count, and copies only their coordinates into the
//   warp's own shared memory with 4-byte cp.async, lanes on consecutive
//   live slots. Only live points are scored, so porth's and zd's ~12 live
//   points of 512 cost ~12 scores, not 512. The claim after next, the
//   next group's bound, order and flags and the block's published k-th
//   bests travel while a group is staged and scored. (Claiming two groups
//   ahead was tried and was slower: 94 registers, fewer warps an SM.)
// - Divergent inserts were the cost of a first version (each lane's top-k
//   in shared memory, inserted at once): while a walker's list is loose,
//   some lane inserts at nearly every point, and the warp waits for a
//   whole shift each time. Now a lane's top-k sits in registers for
//   k <= 12 (a branch-free shift network), points are scored 32 at a time
//   into a candidate mask before the lane inserts its own candidates (the
//   warp waits for its busiest lane, not for every point some lane
//   takes), and a candidate must also be at most the block's published
//   k-th: above it, k other points already beat it.
// - Candidates carry the key (d2, pos), pos = j * P + slot (j the visit
//   position), packed in 64 bits. A walker's claims rise, so a new
//   candidate's pos exceeds every pos in its list: it enters only when its
//   d2 is strictly below the k-th, and goes after equal entries. A second
//   launch merges the walkers' lists of each query by key in fixed order
//   and maps pos back to the id order[b][pos / P] * P + pos % P. That is
//   lax.top_k's order over the visit sequence, so the rows equal the plain
//   walk's bit for bit, and two runs give the same bits.
// Distances are the direct sum over d = 0..D-1 of (q_d - p_d)^2 with
// round-to-nearest intrinsics (and -fmad=false): no centered copy of the
// points is needed, and the result equals the plain PyTorch walk bit for
// bit.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

using u64 = unsigned long long;

constexpr float kBig = 3.4e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;          // walkers a CTA
constexpr int kSeg = 16;           // slots a lane stages: one 16-byte load
constexpr int kPass = 32 * kSeg;   // slots a group may hold (P <= kPass)
constexpr int kWaves = 16;         // CTAs launched per resident CTA slot
constexpr int kMaxWalkers = 256;   // walkers a query block: 8 lists a lane
constexpr int kMaxListEntries = 4096;  // walkers x k, the partials' size
constexpr int kMaxK = 128;         // the largest k a launch takes
constexpr int kListsPerLane = kMaxWalkers / 32;
constexpr int kMergeThreads = 128;
constexpr unsigned kNoPos = 0x7fffffffu;

__device__ __forceinline__ u64 empty_key() {
  return (static_cast<u64>(__float_as_uint(kBig)) << 32) | kNoPos;
}

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

// A lane's running top-k, ascending by (d2, pos). A new candidate's pos
// exceeds every pos already held (a walker's claims rise, and slots are
// scanned in order), so it goes after equal distances: only d2 is compared.
//
// In registers for k <= KR: the list is right-aligned in KR entries
// (entries below KR - k hold -1, below any d2), so the k-th is always
// entry KR - 1, and an insert is a branch-free shift network.
template <int KR>
struct RegTopK {
  float d[KR];
  int p[KR];
  __device__ __forceinline__ void init(int k, u64*, int) {
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      d[i] = i < KR - k ? -1.f : kBig;
      p[i] = static_cast<int>(kNoPos);
    }
  }
  __device__ __forceinline__ float kth(int) const { return d[KR - 1]; }
  __device__ __forceinline__ float insert(float x, int pos, int) {
    // entry i takes entry i-1 if x sorts before it, else x if x sorts
    // before entry i, else keeps its own
#pragma unroll
    for (int i = KR - 1; i > 0; --i) {
      const bool up = x < d[i - 1];
      const bool here = x < d[i];
      p[i] = up ? p[i - 1] : (here ? pos : p[i]);
      d[i] = up ? d[i - 1] : (here ? x : d[i]);
    }
    if (x < d[0]) {
      d[0] = x;
      p[0] = pos;
    }
    return d[KR - 1];
  }
  __device__ __forceinline__ void store(int k, u64* out, int stride) const {
#pragma unroll
    for (int i = 0; i < KR; ++i)
      if (i >= KR - k)
        out[static_cast<long long>(i - (KR - k)) * stride] =
            static_cast<u64>(__float_as_uint(d[i])) << 32 |
            static_cast<unsigned>(p[i]);
  }
};

// In the warp's shared memory for larger k: entry i of lane l at
// list[i * 32 + l] (no bank conflicts), an insertion sort from the back.
struct SmemTopK {
  u64* list;
  int lane;
  float kd;
  __device__ __forceinline__ void init(int k, u64* smem, int l) {
    list = smem;
    lane = l;
    for (int i = 0; i < k; ++i) list[i * 32 + lane] = empty_key();
    kd = kBig;
  }
  __device__ __forceinline__ float kth(int) const { return kd; }
  __device__ __forceinline__ float insert(float x, int pos, int k) {
    const u64 key = static_cast<u64>(__float_as_uint(x)) << 32 |
                    static_cast<unsigned>(pos);
    int at = k - 1;
    while (at > 0) {
      const u64 prev = list[(at - 1) * 32 + lane];
      if (prev < key) break;
      list[at * 32 + lane] = prev;
      --at;
    }
    list[at * 32 + lane] = key;
    kd = __uint_as_float(
        static_cast<unsigned>(list[(k - 1) * 32 + lane] >> 32));
    return kd;
  }
  __device__ __forceinline__ void store(int k, u64* out, int stride) const {
    for (int i = 0; i < k; ++i)
      out[static_cast<long long>(i) * stride] = list[i * 32 + lane];
  }
};

constexpr int kRegK = 12;   // the largest k kept in registers

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four flag bytes (any nonzero byte is set) -> four bits, byte i at bit i.
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ unsigned flag_bits(uint4 f) {
  return nibble(f.x) | nibble(f.y) << 4 | nibble(f.z) << 8 |
         nibble(f.w) << 12;
}

template <int D>
__device__ __forceinline__ void load_point(const float* sp, int o,
                                           float (&p)[D]) {
  if constexpr (D == 2) {
    const float2 v = reinterpret_cast<const float2*>(sp)[o];
    p[0] = v.x;
    p[1] = v.y;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) p[d] = sp[o * D + d];
  }
}

template <int D>
__device__ __forceinline__ float score(const float (&q)[D], const float* sp,
                                       int o) {
  float p[D];
  load_point<D>(sp, o, p);
  return direct_d2<D>(q, p);
}

template <int KR, int D>
__host__ __device__ constexpr size_t warp_smem(int k) {
  return (KR ? 0 : static_cast<size_t>(k) * 32 * sizeof(u64)) +
         static_cast<size_t>(kPass) * (D + 1) * 4;
}

template <int KR>
using TopK = std::conditional_t<KR == 0, SmemTopK, RegTopK<KR>>;

// One walker a warp. Scratch: cursor (nqb) and kth (nqb x 32) zeroed by
// the caller; wcount (nqb x walkers) and part (nqb, walkers, k, bq)
// written here.
template <typename PT, int D, int KR>
__global__ void __launch_bounds__(kWarps * 32)
frontier_walk(const float* __restrict__ qs, const PT* __restrict__ pts,
              const unsigned char* __restrict__ valid,
              const unsigned char* __restrict__ active,
              const int* __restrict__ order, const float* __restrict__ glb,
              int R, int C, int G, int block_r, int bq, int k, int nqb,
              int vec, int* __restrict__ cursor,
              unsigned* __restrict__ kth_inv, int* __restrict__ wcount,
              u64* __restrict__ part) {
  extern __shared__ u64 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x % nqb;
  const int walkers = gridDim.x / nqb * kWarps;
  const int w = blockIdx.x / nqb * kWarps + warp;
  const int P = block_r * C;
  const size_t list_words = KR ? 0 : static_cast<size_t>(k) * 32;
  float* sp = reinterpret_cast<float*>(smem + kWarps * list_words) +
              warp * kPass * (D + 1);
  int* ss = reinterpret_cast<int*>(sp + kPass * D);
  TopK<KR> top;
  top.init(k, smem + warp * list_words, lane);

  // lanes past block_q repeat the block's last query: same answers
  const long long qrow = static_cast<long long>(b) * bq + min(lane, bq - 1);
  float qv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qv[d] = qs[qrow * D + d];
  const int* order_b = order + static_cast<long long>(b) * G;
  const float* glb_b = glb + static_cast<long long>(b) * G;
  unsigned* kth_b = kth_inv + b * 32;
  int* cur_b = cursor + b;
  const int s_lane = lane * kSeg;   // this lane's 16 slots of the group
  const int r_lane = s_lane / C;
  int scored = 0;

  // Entering an iteration the walker holds group j (its bound gl, its id
  // g, its 16-byte flags f/a where vec), the next claim jn, and a read of
  // the block's published k-th bests (seen).
  auto flags = [&](int grp, int jj, uint4& ff, unsigned char& aa) {
    ff = make_uint4(0, 0, 0, 0);
    aa = 0;
    if (!vec || jj >= G || s_lane >= P) return;
    const long long row = static_cast<long long>(grp) * block_r + r_lane;
    if (row < R) {
      ff = *reinterpret_cast<const uint4*>(
          valid + static_cast<long long>(grp) * P + s_lane);
      aa = active[row];
    }
  };
  int j = G, jn = G;
  if (lane == 0) {
    j = atomicAdd(cur_b, 1);
    jn = atomicAdd(cur_b, 1);
  }
  j = __shfl_sync(kFull, j, 0);
  jn = __shfl_sync(kFull, jn, 0);
  float gl = j < G ? glb_b[j] : 0.f;
  int g = j < G ? order_b[j] : 0;
  uint4 f;
  unsigned char a;
  flags(g, j, f, a);
  unsigned seen = __ldcg(kth_b + lane);
  while (j < G) {
    // the lane's bound: the block's published k-th or its own, the lower
    const unsigned own = __float_as_uint(top.kth(k));
    const unsigned bound = __reduce_max_sync(kFull, min(~seen, own));
    if (__float_as_uint(gl) > bound) break;   // gl >= 0: bit order
    // a candidate above the block's published k-th cannot be a result
    // (k keys below it are held); at equal distance its pos may be lower
    const float pub_up = seen ? __uint_as_float(~seen + 1u)
                               : __uint_as_float(0x7f800000u);
    // the next group's bound and order, the claim after it and the next
    // check's read travel while this group is staged and scored
    const unsigned seen_n = __ldcg(kth_b + lane);
    const float gl_n = jn < G ? glb_b[jn] : 0.f;
    const int g_n = jn < G ? order_b[jn] : 0;
    int jnn = G;
    if (lane == 0 && jn < G) jnn = atomicAdd(cur_b, 1);
    uint4 f_n = make_uint4(0, 0, 0, 0);
    unsigned char a_n = 0;

    const long long first = static_cast<long long>(g) * P;
    const unsigned pos0 = static_cast<unsigned>(j) * P;
    unsigned m = 0;   // live slots s_lane + i of the group, at bit i
    if (vec) {        // C % 16 == 0: a lane's 16 slots share one row
      m = a ? flag_bits(f) : 0u;
    } else {
      for (int i = 0; i < kSeg && s_lane + i < P; ++i) {
        const long long flat = first + s_lane + i;
        const long long row = flat / C;
        if (row < R && valid[flat] && active[row]) m |= 1u << i;
      }
    }
    // compact the live slots in slot order, then copy their points with
    // lanes on consecutive live slots
    const int cnt = __popc(m);
    int pre = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, pre, o);
      if (lane >= o) pre += t;
    }
    const int n = __shfl_sync(kFull, pre, 31);
    pre -= cnt;
    for (unsigned mm = m; mm; mm &= mm - 1) ss[pre++] = s_lane + __ffs(mm) - 1;
    __syncwarp();
    for (int o = lane; o < n; o += 32) {
      const PT* src = pts + (first + ss[o]) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) cp_async4(smem_u32(sp + o * D + d), src + d);
    }
    flags(g_n, jn, f_n, a_n);   // the next group's flags
    cp_async_wait_all();
    if constexpr (std::is_same_v<PT, int>) {   // int32 -> f32 in place
      const int* raw = reinterpret_cast<const int*>(sp);
      for (int o = lane; o < n; o += 32)
#pragma unroll
        for (int d = 0; d < D; ++d)
          sp[o * D + d] = __int2float_rn(raw[o * D + d]);
    }
    __syncwarp();
    // score 32 points at a time into a candidate mask, then insert the
    // lane's candidates: the warp waits for the busiest lane's inserts,
    // not for every point some lane inserts at
    float lim = fminf(top.kth(k), pub_up);
    for (int c0 = 0; c0 < n; c0 += 32) {
      const int mc = min(32, n - c0);
      unsigned cand = 0;
      if (mc == 32) {   // a full chunk: each bit one predicated op
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (score<D>(qv, sp, c0 + i) < lim) cand |= 1u << i;
      } else {
        // eight points a step with no branch: reads past n stay below
        // c0 + 32 <= kPass, inside the warp's stage, and are masked off
        for (int i0 = 0; i0 < mc; i0 += 8) {
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const bool hit = score<D>(qv, sp, c0 + i0 + u) < lim;
            cand |= static_cast<unsigned>(hit && i0 + u < mc) << (i0 + u);
          }
        }
      }
      for (; cand; cand &= cand - 1) {
        const int o = c0 + __ffs(cand) - 1;
        const float d2 = score<D>(qv, sp, o);
        if (d2 < lim)
          lim = fminf(top.insert(d2, static_cast<int>(pos0) + ss[o], k),
                      pub_up);
      }
    }
    __syncwarp();   // the next group overwrites the stage
    ++scored;
    const unsigned mine = ~__float_as_uint(top.kth(k));
    if (mine > seen) atomicMax(kth_b + lane, mine);
    seen = max(seen_n, mine);
    j = jn;
    gl = gl_n;
    g = g_n;
    f = f_n;
    a = a_n;
    jn = __shfl_sync(kFull, jnn, 0);
  }
  const long long wi = static_cast<long long>(b) * walkers + w;
  if (lane == 0) wcount[wi] = scored;
  if (scored > 0 && lane < bq) top.store(k, part + wi * k * bq + lane, bq);
}

// One warp a query row: the k smallest keys over the walkers' lists, in
// walker order on equal keys (only empty entries can be equal). Also
// writes steps[b] = the walk's reach, min(cursor[b], G).
__global__ void __launch_bounds__(kMergeThreads)
frontier_merge(const u64* __restrict__ part, const int* __restrict__ wcount,
               const int* __restrict__ order, const int* __restrict__ cursor,
               int nqb, int walkers, int bq, int k, int G, int P,
               float* __restrict__ out_d, int* __restrict__ out_i,
               int* __restrict__ steps) {
  const int lane = threadIdx.x & 31;
  const long long qi =
      (static_cast<long long>(blockIdx.x) * kMergeThreads + threadIdx.x) / 32;
  if (qi >= static_cast<long long>(nqb) * bq) return;   // whole warps
  const int b = static_cast<int>(qi / bq);
  const int q = static_cast<int>(qi % bq);
  if (q == 0 && lane == 0) steps[b] = min(cursor[b], G);
  const u64* pb = part + static_cast<long long>(b) * walkers * k * bq + q;
  const int* wc = wcount + static_cast<long long>(b) * walkers;
  u64 head[kListsPerLane];
  int at[kListsPerLane];
#pragma unroll
  for (int t = 0; t < kListsPerLane; ++t) {
    const int w = lane + 32 * t;
    at[t] = 0;
    head[t] = w < walkers && wc[w] > 0
                  ? pb[static_cast<long long>(w) * k * bq] : ~0ull;
  }
  for (int r = 0; r < k; ++r) {
    u64 best = ~0ull;
    int bt = 0;
#pragma unroll
    for (int t = 0; t < kListsPerLane; ++t)
      if (head[t] < best) {
        best = head[t];
        bt = t;
      }
    u64 low = best;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const u64 other = __shfl_xor_sync(kFull, low, o);
      low = other < low ? other : low;
    }
    const int winner = __ffs(__ballot_sync(kFull, best == low)) - 1;
    if (lane != winner) continue;
    const long long o = qi * k + r;
    const float d = __uint_as_float(static_cast<unsigned>(low >> 32));
    if (low == ~0ull || d >= kBig) {
      out_d[o] = kBig;
      out_i[o] = -1;
    } else {
      const unsigned pos = static_cast<unsigned>(low);
      out_d[o] = d;
      out_i[o] = order[static_cast<long long>(b) * G + pos / P] * P +
                 static_cast<int>(pos % P);
    }
    if (low == ~0ull) continue;
#pragma unroll
    for (int t = 0; t < kListsPerLane; ++t)
      if (t == bt) {
        const int w = lane + 32 * t;
        ++at[t];
        head[t] = at[t] < k
                      ? pb[(static_cast<long long>(w) * k + at[t]) * bq]
                      : ~0ull;
      }
  }
}

// Also lets the walk take the shared memory of the largest k its
// instance serves, so a launch at any k <= kMaxK needs no attribute call.
template <typename PT, int D, int KR>
int plan(int k, int nqb, int* walkers) {
  auto kern = frontier_walk<PT, D, KR>;
  const size_t smem = kWarps * warp_smem<KR, D>(k);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWarps * warp_smem<KR, D>(kMaxK)));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kWarps * 32, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int want = (kWaves * per_sm * sms + nqb - 1) / nqb;
  const int cap = max(1, min(kMaxWalkers, kMaxListEntries / k) / kWarps);
  *walkers = max(1, min(want, cap)) * kWarps;
  return 0;
}

template <typename PT, int D, int KR>
int launch(const float* qs, const void* pts, const unsigned char* valid,
           const unsigned char* active, const int* order, const float* glb,
           int R, int C, int G, int block_r, int nqb, int bq, int k,
           int walkers, int* scratch, int* wcount, u64* part, float* out_d,
           int* out_i, cudaStream_t stream) {
  const size_t smem = kWarps * warp_smem<KR, D>(k);
  auto kern = frontier_walk<PT, D, KR>;
  const int vec = C % kSeg == 0 &&
                  reinterpret_cast<unsigned long long>(valid) % 16 == 0;
  int* cursor = scratch;
  int* steps = scratch + nqb;
  unsigned* kth = reinterpret_cast<unsigned*>(scratch + 2 * nqb);
  const int splits = walkers / kWarps;
  kern<<<nqb * splits, kWarps * 32, smem, stream>>>(
      qs, static_cast<const PT*>(pts), valid, active, order, glb, R, C, G,
      block_r, bq, k, nqb, vec, cursor, kth, wcount, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = static_cast<long long>(nqb) * bq;
  const int grid =
      static_cast<int>((rows * 32 + kMergeThreads - 1) / kMergeThreads);
  frontier_merge<<<grid, kMergeThreads, 0, stream>>>(
      part, wcount, order, cursor, nqb, walkers, bq, k, G, block_r * C,
      out_d, out_i, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The top-k's home: registers for k <= kRegK (main's k = 10), shared
// memory above (fig4's k = 100).
#define KNN_FRONTIER_BY_K(CALL, PT, DD) \
  (k <= kRegK ? CALL(PT, DD, kRegK) : CALL(PT, DD, 0))

// points' type x D x the top-k's home
#define KNN_FRONTIER_DISPATCH(CALL)                                         \
  switch (pts_float * 4 + D) {                                              \
    case 1: return KNN_FRONTIER_BY_K(CALL, int, 1);                         \
    case 2: return KNN_FRONTIER_BY_K(CALL, int, 2);                         \
    case 3: return KNN_FRONTIER_BY_K(CALL, int, 3);                         \
    case 5: return KNN_FRONTIER_BY_K(CALL, float, 1);                       \
    case 6: return KNN_FRONTIER_BY_K(CALL, float, 2);                       \
    case 7: return KNN_FRONTIER_BY_K(CALL, float, 3);                       \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }

// The number of walkers a query block gets (a multiple of the CTA's warps)
// for points of type int32 (pts_float == 0) or f32, D dimensions, k
// results and nqb query blocks: enough CTAs for kWaves full waves of the
// card, at most 256 walkers and 4096 list entries (walkers x k) a block.
// The caller allocates the partial lists from it, and calls this once
// on each device before the first launch of an instance (points' type x D
// x the top-k's home). Returns a CUDA error.
extern "C" int knn_frontier_plan(int pts_float, int D, int k, int nqb,
                                 int* walkers) {
  if (k < 1 || k > kMaxK || nqb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define KNN_FRONTIER_PLAN(PT, DD, KR) plan<PT, DD, KR>(k, nqb, walkers)
  KNN_FRONTIER_DISPATCH(KNN_FRONTIER_PLAN)
#undef KNN_FRONTIER_PLAN
}

// qs (nqb*bq, D) f32 sorted queries, bq <= 32, block_r * C <= 512;
// pts (R, C, D) int32
// (pts_float == 0) or f32 (pts_float == 1); valid (R, C) and active (R,)
// bool as bytes; order (nqb, G) i32 and glb (nqb, G) f32 per query block;
// scratch (nqb * 34,) int32 zeroed (cursor, steps, k-th bests); wcount
// (nqb * walkers,) int32 and part (nqb * walkers * k * bq,) int64 scratch,
// walkers from knn_frontier_plan (called before on this device with the
// same pts_float, D and k's home); all contiguous on the device. Writes
// d2 / ids (nqb*bq, k) and steps (scratch[nqb:2*nqb]) = the groups each
// block's walk claimed. Two launches; returns the first cudaGetLastError()
// that is not cudaSuccess.
extern "C" int knn_frontier_launch(const float* qs, const void* pts,
                                   int pts_float, const unsigned char* valid,
                                   const unsigned char* active,
                                   const int* order, const float* glb, int R,
                                   int C, int D, int G, int block_r, int nqb,
                                   int bq, int k, int walkers, int* scratch,
                                   int* wcount, void* part, float* out_d,
                                   int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nqb < 1 || bq < 1 || bq > 32 || block_r * C > kPass ||
      walkers < kWarps || walkers % kWarps != 0 ||
      walkers > kMaxWalkers || k < 1 || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  u64* pt = static_cast<u64*>(part);
#define KNN_FRONTIER_LAUNCH(PT, DD, KR)                                     \
  launch<PT, DD, KR>(qs, pts, valid, active, order, glb, R, C, G, block_r,  \
                     nqb, bq, k, walkers, scratch, wcount, pt, out_d, out_i, \
                     s)
  KNN_FRONTIER_DISPATCH(KNN_FRONTIER_LAUNCH)
#undef KNN_FRONTIER_LAUNCH
}
