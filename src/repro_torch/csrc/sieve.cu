// The sieve round: lambda-level bucket by midpoint compares and a stable
// counting sort by bucket inside every segment of active points.
//
// Replaces: src/repro/kernels/sieve/kernel.py:sieve_histogram_pallas (body
// _sieve_kernel) and the jnp scan + scatter of
// src/repro/kernels/sieve/ops.py:sieve_partition. The TPU kernel computes
// one (2^(lam*D),) histogram per fixed block of block_n points with a
// one-hot matmul; the offsets and the within-block rank were jnp (an
// argsort) on top of it. The P-Orth build runs one such sort per sieve
// round inside every splitting group ("segment"), with the group order
// kept and every other point left in place.
//
// What bounds it on an H100: bytes. A point is read (coordinates and its
// cell bounds, 3 * D words, plus its segment start and active flag) and
// costs lam * D compares; its destination, bucket and child cell (2 + 2 * D
// words) are written. At the 10^7-point build's first round that is ~0.16
// ms at 3.35 TB/s. Everything else must scale with the chunks in use, not
// with the most a round could need: the round cannot read how many chunks
// it has without a host sync, so a design sized to the worst case (n /
// block_n + n / (phi + 1) chunks, 312,796 at 10^7 points) pays for all of
// them every round, even a round with no active point.
//
// What the design does about it: five launches behind one C call, each
// sized to the points or to the chunks in use, which stay in device
// memory.
//
//   sieve_chunks_kernel  -- one pass over the points in tiles of 4096, its
//       loads issued in batches before any flag is formed. An inactive
//       point gets its outputs at once (dest = i, bucket 0, its own cell). A segment's last point writes the segment's length at
//       seglen[start]. A chunk starts where an active point lies a multiple
//       of block_n past its segment start; a segment of at most block_n
//       points is one "single" chunk, a longer one is cut into "multi"
//       chunks. The tile counts its chunk starts of each kind with warp
//       ballots, takes its offset by a decoupled look-back over the tiles
//       before it (tiles are numbered by a ticket, so the look-back only
//       waits on tiles already running), and writes both lists in point
//       order. The last tile leaves the two counts in device memory.
//   sieve_single_kernel  -- persistent, one warp per single segment: the
//       bucket of each point (kept in shared memory), the K bucket counts
//       (__match_any_sync: one shared-memory add per distinct bucket of 32
//       points), their exclusive scan, and the stable rank of each point
//       in its bucket by the same lane order. One read of the segment, no
//       histogram in device memory. Every round-4 segment (~40 points)
//       takes this path.
//   sieve_hist_kernel    -- persistent, one CTA per multi chunk: its K
//       bucket counts, bucket-major (hist[b][m]).
//   sieve_scan_kernel    -- one CTA per bucket: the exclusive scan of
//       hist[b][0..n_multi) over the chunks in use (pre[b][m], with the
//       total at pre[b][n_multi]). A segment's chunks are consecutive, so
//       the bucket's count in a segment's earlier chunks, and the
//       segment's bucket total, are differences of two entries.
//   sieve_rank_kernel    -- persistent, one CTA per multi chunk: the
//       segment's bucket totals (pre at its last chunk + 1 minus pre at its
//       first), their exclusive scan over the buckets, and each point's
//       stable rank in the chunk: eight warps take eight consecutive runs,
//       a per-warp, per-bucket count and a scan over the warps give each
//       run its base, and __match_any_sync / __popc over the lanes below
//       rank 32 points at a time in input order.
//
// Persistent grids are the card's resident CTAs (an occupancy query, made
// once), not the chunk count, so a round with no active point costs the
// chunk pass (which must still write every point's outputs) plus four
// launches that find no work. Loading several points a lane ahead of use
// made the rank kernel slower on an H100, so a lane loads one point at a
// time.
//
// Midpoints follow the reference exactly: integers as lo + floor((hi -
// lo) / 2) with int32 wrap-around (computed in unsigned arithmetic),
// floats as lo + (hi - lo) * 0.5 with round-to-nearest intrinsics and no
// fused multiply-add (-fmad=false).

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kItems = 16;                    // points a thread of a tile
constexpr int kTile = kThreads * kItems;      // points a tile
constexpr int kScanItems = 8;                 // entries a thread of a scan
// A tile's look-back word: a 2-bit state over two 31-bit counts (multi
// starts above single starts). Counts stay below 2^31 (n < 2^31), so the
// packed words of two tiles add field by field.
constexpr u64 kAggregate = 1ull << 62;
constexpr u64 kInclusive = 2ull << 62;
constexpr u64 kCountMask = kAggregate - 1;
constexpr long long kMaxSpins = 1ll << 24;    // a look-back that waits
                                              // longer traps, never hangs

__device__ __forceinline__ int midpoint(int lo, int hi) {
  const int diff = static_cast<int>(static_cast<unsigned>(hi) -
                                    static_cast<unsigned>(lo));
  return static_cast<int>(static_cast<unsigned>(lo) +
                          static_cast<unsigned>(diff >> 1));
}

__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), 0.5f));
}

// A point and its cell; after bucket() the cell is the bucket's.
template <typename T, int D>
struct Point {
  T x[D], l[D], h[D];
  __device__ __forceinline__ void load(const T* __restrict__ p,
                                       const T* __restrict__ lo,
                                       const T* __restrict__ hi,
                                       long long i) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = p[i * D + d];
      l[d] = lo[i * D + d];
      h[d] = hi[i * D + d];
    }
  }
  // The lambda-level bucket: lam rounds of D midpoint compares, dimension
  // 0 in the high bit.
  __device__ __forceinline__ int bucket(int lam) {
    int b = 0;
    for (int lev = 0; lev < lam; ++lev) {
      int bits = 0;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const T m = midpoint(l[d], h[d]);
        const bool gt = x[d] >= m;
        bits |= static_cast<int>(gt) << (D - 1 - d);
        if (gt) l[d] = m; else h[d] = m;
      }
      b = (b << D) | bits;
    }
    return b;
  }
};

template <typename T, int D>
__device__ __forceinline__ void put_cell(T* __restrict__ clo,
                                         T* __restrict__ chi, long long i,
                                         const Point<T, D>& pt) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    clo[i * D + d] = pt.l[d];
    chi[i * D + d] = pt.h[d];
  }
}

// Exclusive scan of a[0..K) in shared memory by one warp, plus base.
__device__ __forceinline__ void warp_exclusive_scan(int* a, int K, int base,
                                                    int lane) {
  const int per = (K + 31) / 32;
  const int b0 = min(lane * per, K), b1 = min(b0 + per, K);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += a[b];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  int acc = base + incl - sum;
  for (int b = b0; b < b1; ++b) {
    const int v = a[b];
    a[b] = acc;
    acc += v;
  }
}

// Exclusive scan of a[0..K) in shared memory by the whole CTA; tmp holds
// kWarps ints. Ends with a __syncthreads().
__device__ __forceinline__ void block_exclusive_scan(int* a, int K,
                                                     int* tmp) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int per = (K + kThreads - 1) / kThreads;
  const int b0 = min(t * per, K), b1 = min(b0 + per, K);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += a[b];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += tmp[w];
  int acc = before + incl - sum;
  for (int b = b0; b < b1; ++b) {
    const int v = a[b];
    a[b] = acc;
    acc += v;
  }
  __syncthreads();
}

__device__ __forceinline__ u64 load_volatile(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

// ------------------------------------------------------------ chunk pass

__global__ void __launch_bounds__(kThreads) sieve_chunks_kernel(
    const int* __restrict__ seg, const unsigned char* __restrict__ act,
    int n, int block_n, int D, const int* __restrict__ lo,
    const int* __restrict__ hi, int* __restrict__ dest,
    int* __restrict__ bucket, int* __restrict__ clo, int* __restrict__ chi,
    int* __restrict__ seglen, int* __restrict__ single,
    int* __restrict__ multi, int mcap, u64* __restrict__ status,
    int* __restrict__ ctl, int n_tiles) {
  __shared__ int tile_id;
  __shared__ unsigned ball[2][kItems * kWarps];
  __shared__ int off[2][kItems * kWarps];
  __shared__ int tile_base[2];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) tile_id = atomicAdd(&ctl[0], 1);
  __syncthreads();
  const int t = tile_id;
  const long long base = static_cast<long long>(t) * kTile;

  // the tile's loads are issued in three batches before the flags are
  // formed: the activity bytes; the inactive points' identity outputs;
  // the segment starts (each point's and the next one's) of the rows
  // that hold an active point
  const long long i0 = base + threadIdx.x;
  bool on[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long i = i0 + r * kThreads;
    on[r] = i < n && act[i];
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long i = i0 + r * kThreads;
    if (i < n && !on[r]) {
      dest[i] = static_cast<int>(i);
      bucket[i] = 0;
      for (int d = 0; d < D; ++d) {
        clo[i * D + d] = lo[i * D + d];
        chi[i * D + d] = hi[i * D + d];
      }
    }
  }
  int sg[kItems], nx[kItems];   // each point's segment start, the next's
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long i = i0 + r * kThreads;
    sg[r] = nx[r] = -1;
    if (__any_sync(kFull, on[r]) && i < n) {
      sg[r] = seg[i];
      if (i + 1 < n) nx[r] = seg[i + 1];
    }
  }

  unsigned fs = 0, fm = 0;   // bit r: this thread's item r starts a chunk
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long i = i0 + r * kThreads;
    bool is_s = false, is_m = false;
    if (on[r]) {
      const int s = sg[r];
      const int o = static_cast<int>(i) - s;
      if (nx[r] != s) seglen[s] = o + 1;
      if (o % block_n == 0) {
        const long long ahead = i + block_n;
        is_m = o >= block_n || (ahead < n && seg[ahead] == s);
        is_s = !is_m;
      }
    }
    const unsigned bs = __ballot_sync(kFull, is_s);
    const unsigned bm = __ballot_sync(kFull, is_m);
    if (lane == 0) {
      ball[0][r * kWarps + warp] = bs;
      ball[1][r * kWarps + warp] = bm;
    }
    fs |= static_cast<unsigned>(is_s) << r;
    fm |= static_cast<unsigned>(is_m) << r;
  }
  __syncthreads();

  if (warp == 0) {
    // offsets inside the tile, in point order: (item, warp) entries
    constexpr int kPer = kItems * kWarps / 32;
    int cnt[2] = {0, 0};
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      cnt[0] += __popc(ball[0][lane * kPer + q]);
      cnt[1] += __popc(ball[1][lane * kPer + q]);
    }
    int incl[2] = {cnt[0], cnt[1]};
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int v = __shfl_up_sync(kFull, incl[k], o);
        if (lane >= o) incl[k] += v;
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      int acc = incl[k] - cnt[k];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        off[k][lane * kPer + q] = acc;
        acc += __popc(ball[k][lane * kPer + q]);
      }
    }
    const u64 agg =
        static_cast<u64>(__shfl_sync(kFull, incl[1], 31)) << 31 |
        static_cast<u64>(__shfl_sync(kFull, incl[0], 31));
    // the tiles before: decoupled look-back, 32 tiles a step
    u64 excl = 0;
    if (t == 0) {
      if (lane == 0) atomicExch(&status[0], kInclusive | agg);
    } else {
      if (lane == 0) atomicExch(&status[t], kAggregate | agg);
      int top = t - 1;
      while (true) {
        const int k = top - lane;
        u64 w = kInclusive;   // before tile 0: an inclusive zero
        if (k >= 0) {
          w = load_volatile(&status[k]);
          long long spins = 0;
          while ((w & ~kCountMask) == 0) {
            __nanosleep(32);
            w = load_volatile(&status[k]);
            if (++spins > kMaxSpins) __trap();
          }
        }
        const unsigned inc = __ballot_sync(kFull, (w & ~kCountMask) ==
                                                      kInclusive);
        const int stop = inc ? __ffs(inc) - 1 : 31;
        u64 v = lane <= stop ? (w & kCountMask) : 0;
#pragma unroll
        for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        excl += v;
        if (inc) break;
        top -= 32;
      }
      if (lane == 0) atomicExch(&status[t], kInclusive | (excl + agg));
    }
    if (lane == 0) {
      tile_base[0] = static_cast<int>(excl & 0x7fffffffu);
      tile_base[1] = static_cast<int>(excl >> 31);
      if (t == n_tiles - 1) {
        const u64 total = excl + agg;
        ctl[1] = static_cast<int>(total & 0x7fffffffu);
        ctl[2] = static_cast<int>(total >> 31);
      }
    }
  }
  __syncthreads();

  const unsigned below = (1u << lane) - 1u;
  for (int r = 0; r < kItems; ++r) {
    const int e = r * kWarps + warp;
    const int i = static_cast<int>(base + r * kThreads + threadIdx.x);
    if ((fs >> r) & 1u)
      single[tile_base[0] + off[0][e] + __popc(ball[0][e] & below)] = i;
    if ((fm >> r) & 1u) {
      const int at = tile_base[1] + off[1][e] + __popc(ball[1][e] & below);
      if (at < mcap) multi[at] = i;
    }
  }
}

// --------------------------------------------------------- single pass

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) sieve_single_kernel(
    const T* __restrict__ p, const T* __restrict__ lo,
    const T* __restrict__ hi, int lam, int K, int block_n,
    const int* __restrict__ single, const int* __restrict__ seglen,
    const int* __restrict__ ctl, int* __restrict__ dest,
    int* __restrict__ bucket, T* __restrict__ clo, T* __restrict__ chi) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int* cnt = smem + warp * (K + block_n);   // [K]: counts, then offsets
  int* bkt = cnt + K;                       // [block_n]: each bucket
  const unsigned below = (1u << lane) - 1u;
  const int ns = ctl[1];
  for (int w = blockIdx.x * kWarps + warp; w < ns;
       w += gridDim.x * kWarps) {
    const int s = single[w];
    const int L = seglen[s];
    for (int b = lane; b < K; b += 32) cnt[b] = 0;
    __syncwarp();
    for (int o = 0; o < L; o += 32) {
      const int j = o + lane;
      const bool live = j < L;
      int b = -1;
      if (live) {
        Point<T, D> pt;
        pt.load(p, lo, hi, s + j);
        b = pt.bucket(lam);
        bkt[j] = b;
        put_cell<T, D>(clo, chi, s + j, pt);
      }
      const unsigned peers = __match_any_sync(kFull, b);
      if (live && (peers & below) == 0) cnt[b] += __popc(peers);
      __syncwarp();
    }
    warp_exclusive_scan(cnt, K, s, lane);
    __syncwarp();
    for (int o = 0; o < L; o += 32) {
      const int j = o + lane;
      const bool live = j < L;
      const int b = live ? bkt[j] : -1;
      const unsigned peers = __match_any_sync(kFull, b);
      if (live) {
        dest[s + j] = cnt[b] + __popc(peers & below);
        bucket[s + j] = b;
      }
      __syncwarp();
      if (live && (peers & below) == 0) cnt[b] += __popc(peers);
      __syncwarp();
    }
  }
}

// ------------------------------------------------- multi-chunk segments

// A multi chunk: its start, its segment's start and length, its length.
__device__ __forceinline__ void chunk_of(int m, const int* multi,
                                         const int* seg, const int* seglen,
                                         const int* clen, int block_n,
                                         int& start, int& s, int& L,
                                         int& len) {
  start = multi[m];
  if (clen) {   // explicit chunks (the reference-shaped histogram)
    s = start;
    len = L = clen[m];
    return;
  }
  s = seg[start];
  L = seglen[s];
  len = min(block_n, s + L - start);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) sieve_hist_kernel(
    const T* __restrict__ p, const T* __restrict__ lo,
    const T* __restrict__ hi, int lam, int K, int block_n,
    const int* __restrict__ multi, const int* __restrict__ seg,
    const int* __restrict__ seglen, const int* __restrict__ clen,
    const int* __restrict__ count, int* __restrict__ hist, int ld) {
  extern __shared__ int counts[];
  const int nm = *count;
  for (int m = blockIdx.x; m < nm; m += gridDim.x) {
    int start, s, L, len;
    chunk_of(m, multi, seg, seglen, clen, block_n, start, s, L, len);
    for (int b = threadIdx.x; b < K; b += kThreads) counts[b] = 0;
    __syncthreads();
    for (int o = threadIdx.x; o < len; o += kThreads) {
      Point<T, D> pt;
      pt.load(p, lo, hi, start + o);
      atomicAdd(&counts[pt.bucket(lam)], 1);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < K; b += kThreads)
      hist[static_cast<long long>(b) * ld + m] = counts[b];
    __syncthreads();
  }
}

// CTA b: pre[b][m] = sum of hist[b][0..m) for m in [0, n_multi].
__global__ void __launch_bounds__(kThreads) sieve_scan_kernel(
    const int* __restrict__ hist, int ld, const int* __restrict__ count,
    int* __restrict__ pre) {
  __shared__ int tmp[kWarps];
  const int nm = *count;
  const int* h = hist + static_cast<long long>(blockIdx.x) * ld;
  int* out = pre + static_cast<long long>(blockIdx.x) * (ld + 1);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int carry = 0;
  for (int b0 = 0; b0 <= nm; b0 += kThreads * kScanItems) {
    const int first = b0 + threadIdx.x * kScanItems;
    int v[kScanItems];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      v[q] = first + q < nm ? h[first + q] : 0;
      sum += v[q];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) tmp[warp] = incl;
    __syncthreads();
    int before = carry, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += tmp[w];
      total += tmp[w];
    }
    int acc = before + incl - sum;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      if (first + q <= nm) out[first + q] = acc;
      acc += v[q];
    }
    carry += total;
    __syncthreads();
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) sieve_rank_kernel(
    const T* __restrict__ p, const T* __restrict__ lo,
    const T* __restrict__ hi, int lam, int K, int block_n,
    const int* __restrict__ multi, const int* __restrict__ seg,
    const int* __restrict__ seglen, const int* __restrict__ ctl,
    const int* __restrict__ pre, int ld, int* __restrict__ dest,
    int* __restrict__ bucket, T* __restrict__ clo, T* __restrict__ chi) {
  extern __shared__ int smem[];
  __shared__ int tmp[kWarps];
  int* base = smem;                  // [kWarps][K]: per-warp counts, bases
  int* off = smem + kWarps * K;      // [K]: the chunk's first destinations
  int* bkt = off + K;                // [block_n]: each point's bucket
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const int nm = ctl[2];
  for (int m = blockIdx.x; m < nm; m += gridDim.x) {
    int start, s, L, len;
    chunk_of(m, multi, seg, seglen, nullptr, block_n, start, s, L, len);
    const int m0 = m - (start - s) / block_n;     // the segment's chunks
    const int m1 = m0 + (L + block_n - 1) / block_n;
    for (int b = threadIdx.x; b < K; b += kThreads) {
      const int* col = pre + static_cast<long long>(b) * (ld + 1);
      off[b] = col[m1] - col[m0];                 // the segment's total
    }
    for (int i = threadIdx.x; i < kWarps * K; i += kThreads) base[i] = 0;
    __syncthreads();
    block_exclusive_scan(off, K, tmp);
    for (int b = threadIdx.x; b < K; b += kThreads) {
      const int* col = pre + static_cast<long long>(b) * (ld + 1);
      off[b] += s + col[m] - col[m0];
    }
    // warp w ranks the consecutive run [w * run, (w + 1) * run)
    const int run = (len + kThreads - 1) / kThreads * 32;
    const int a = min(warp * run, len);
    const int e = min(a + run, len);
    int* mine = base + warp * K;
    for (int o = a; o < e; o += 32) {
      const int j = o + lane;
      const bool live = j < e;
      int b = -1;
      if (live) {
        Point<T, D> pt;
        pt.load(p, lo, hi, start + j);
        b = pt.bucket(lam);
        bkt[j] = b;
        put_cell<T, D>(clo, chi, start + j, pt);
      }
      const unsigned peers = __match_any_sync(kFull, b);
      if (live && (peers & below) == 0) mine[b] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // exclusive scan over the warps, per bucket, from the chunk's offset
    for (int b = threadIdx.x; b < K; b += kThreads) {
      int acc = off[b];
      for (int w = 0; w < kWarps; ++w) {
        const int c = base[w * K + b];
        base[w * K + b] = acc;
        acc += c;
      }
    }
    __syncthreads();
    for (int o = a; o < e; o += 32) {
      const int j = o + lane;
      const bool live = j < e;
      const int b = live ? bkt[j] : -1;
      const unsigned peers = __match_any_sync(kFull, b);
      if (live) {
        dest[start + j] = mine[b] + __popc(peers & below);
        bucket[start + j] = b;
      }
      __syncwarp();
      if (live && (peers & below) == 0) mine[b] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- launching

// The resident CTAs of `kernel` on the current device: a persistent grid.
// The occupancy query runs once per (kernel, shared memory, device).
template <typename F>
int resident_grid(F kernel, size_t smem, int* err) {
  struct Entry {
    const void* fn;
    size_t smem;
    int dev, grid;
  };
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == fn && cache[i].smem == smem && cache[i].dev == dev)
      return cache[i].grid;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) *err = static_cast<int>(e);
  }
  int sms = 0, per = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, kernel, kThreads, smem);
  if (e != cudaSuccess) *err = static_cast<int>(e);
  const int grid = sms * max(per, 1);
  if (*err == 0 && used < 64) cache[used++] = {fn, smem, dev, grid};
  return grid;
}

struct Args {
  const void *p, *lo, *hi;
  int lam, K, block_n;
  const int *single, *multi, *seg, *seglen, *clen, *ctl, *count, *pre;
  int* hist;
  int ld;
  int *dest, *bucket;
  void *clo, *chi;
  cudaStream_t stream;
};

template <typename T, int D>
int run_single(const Args& a) {
  const size_t smem = static_cast<size_t>(kWarps) * (a.K + a.block_n) *
                      sizeof(int);
  int err = 0;
  const int grid = resident_grid(sieve_single_kernel<T, D>, smem, &err);
  if (err) return err;
  sieve_single_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.p), static_cast<const T*>(a.lo),
      static_cast<const T*>(a.hi), a.lam, a.K, a.block_n, a.single,
      a.seglen, a.ctl, a.dest, a.bucket, static_cast<T*>(a.clo),
      static_cast<T*>(a.chi));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run_hist(const Args& a) {
  const size_t smem = static_cast<size_t>(a.K) * sizeof(int);
  int err = 0;
  const int grid = resident_grid(sieve_hist_kernel<T, D>, smem, &err);
  if (err) return err;
  sieve_hist_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.p), static_cast<const T*>(a.lo),
      static_cast<const T*>(a.hi), a.lam, a.K, a.block_n, a.multi, a.seg,
      a.seglen, a.clen, a.count, a.hist, a.ld);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run_rank(const Args& a) {
  const size_t smem = (static_cast<size_t>(kWarps + 1) * a.K + a.block_n) *
                      sizeof(int);
  int err = 0;
  const int grid = resident_grid(sieve_rank_kernel<T, D>, smem, &err);
  if (err) return err;
  sieve_rank_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.p), static_cast<const T*>(a.lo),
      static_cast<const T*>(a.hi), a.lam, a.K, a.block_n, a.multi, a.seg,
      a.seglen, a.ctl, a.pre, a.ld, a.dest, a.bucket,
      static_cast<T*>(a.clo), static_cast<T*>(a.chi));
  return static_cast<int>(cudaGetLastError());
}

// op: 0 single, 1 hist, 2 rank; the point type and D picked at run time
template <typename T>
int dispatch_d(int op, int D, const Args& a) {
#define SIEVE_OPS(DD)                                   \
  case DD:                                              \
    return op == 0   ? run_single<T, DD>(a)             \
           : op == 1 ? run_hist<T, DD>(a)               \
                     : run_rank<T, DD>(a);
  switch (D) {
    SIEVE_OPS(1)
    SIEVE_OPS(2)
    SIEVE_OPS(3)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIEVE_OPS
}

int dispatch(int op, int is_float, int D, const Args& a) {
  return is_float ? dispatch_d<float>(op, D, a) : dispatch_d<int>(op, D, a);
}

}  // namespace

// One sieve round: five launches on `stream`. pts, lo, hi (N, D) int32
// (is_float = 0) or float32 (is_float = 1), contiguous; seg (N,) int32:
// each point's segment start (segments contiguous); act (N,) bool bytes,
// constant on a segment. Writes dest, bucket (N,) int32 and clo, chi (N,
// D): every point's destination, bucket and cell (its own, bucket 0 and
// dest = i off act). work: 2 N + mcap (2 K + 1) + K int32, mcap = 2 (N /
// block_n) + 1, K = 2^(lam D): the segment lengths (at segment starts),
// the single segments' starts, the multi chunks' starts, hist (K, mcap)
// and pre (K, mcap + 1). scratch: ceil(N / 4096) + 2 int64, zero: the
// tiles' look-back words, then ctl = (ticket, n_single, n_multi) as int32.
// Returns the first launch's error (cudaGetLastError()), or 0.
extern "C" int sieve_round_launch(const void* p, const void* lo,
                                  const void* hi, int is_float, int D,
                                  int lam, int block_n, const int* seg,
                                  const unsigned char* act, int n,
                                  int* dest, int* bucket, void* clo,
                                  void* chi, int* work, int mcap,
                                  unsigned long long* scratch,
                                  void* stream) {
  const int K = 1 << (lam * D);
  const int n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* seglen = work;
  int* single = work + n;
  int* multi = single + n;
  int* hist = multi + mcap;
  int* pre = hist + static_cast<long long>(K) * mcap;
  int* ctl = reinterpret_cast<int*>(scratch + n_tiles);
  sieve_chunks_kernel<<<n_tiles, kThreads, 0, s>>>(
      seg, act, n, block_n, D, static_cast<const int*>(lo),
      static_cast<const int*>(hi), dest, bucket, static_cast<int*>(clo),
      static_cast<int*>(chi), seglen, single, multi, mcap, scratch, ctl,
      n_tiles);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  Args a{};
  a.p = p; a.lo = lo; a.hi = hi; a.lam = lam; a.K = K;
  a.block_n = block_n; a.single = single; a.multi = multi; a.seg = seg;
  a.seglen = seglen; a.ctl = ctl; a.count = ctl + 2; a.pre = pre;
  a.hist = hist; a.ld = mcap; a.dest = dest; a.bucket = bucket;
  a.clo = clo; a.chi = chi; a.stream = s;
  if ((err = dispatch(0, is_float, D, a))) return err;
  if ((err = dispatch(1, is_float, D, a))) return err;
  sieve_scan_kernel<<<K, kThreads, 0, s>>>(hist, mcap, ctl + 2, pre);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  return dispatch(2, is_float, D, a);
}

// The bucket counts of `count` explicit chunks (start chunk_start[m],
// length chunk_len[m]) into hist[b * ld + m]; count_dev holds count.
extern "C" int sieve_hist_launch(const void* p, const void* lo,
                                 const void* hi, int is_float, int D,
                                 int lam, const int* chunk_start,
                                 const int* chunk_len, const int* count_dev,
                                 int* hist, int ld, void* stream) {
  Args a{};
  a.p = p; a.lo = lo; a.hi = hi; a.lam = lam; a.K = 1 << (lam * D);
  a.block_n = 1; a.multi = chunk_start; a.clen = chunk_len;
  a.count = count_dev; a.hist = hist; a.ld = ld;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(1, is_float, D, a);
}
