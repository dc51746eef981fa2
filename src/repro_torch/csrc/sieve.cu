// The sieve: lambda-level bucket by midpoint compares, per-chunk bucket
// histograms, and the stable counting-sort destination of every point.
//
// Replaces: src/repro/kernels/sieve/kernel.py:sieve_histogram_pallas (body
// _sieve_kernel) and the jnp scan + scatter of
// src/repro/kernels/sieve/ops.py:sieve_partition. The TPU kernel computes
// one (2^(lam*D),) histogram per fixed block of block_n points with a
// one-hot matmul; the offsets and the within-block rank were jnp (an
// argsort) on top of it.
//
// The port generalises the block to a *chunk*: a run of at most block_n
// consecutive points that lie in one segment. Fixed blocks over the whole
// array are one chunking (the TPU kernel's); the P-Orth build gives each
// sieve round the chunks of its splitting groups, so one round is one
// stable counting sort by bucket inside every group, with the group order
// kept. Two launches per round:
//
//   sieve_hist_kernel  -- one CUDA block per chunk: the bucket of each
//                         point, counted in shared memory; writes the
//                         chunk's (K,) histogram (zeros for empty chunks).
//   sieve_rank_kernel  -- one CUDA block per chunk: the destination of
//                         each point, offset[chunk, bucket] (an exclusive
//                         scan of the histograms, computed by the wrapper)
//                         plus the point's stable rank among the chunk's
//                         points of its bucket; and the bucket's cell,
//                         the bounds the midpoint compares end on, which
//                         the P-Orth round gives the point next.
//
// What bounds it on an H100: bytes. A point is read (coordinates and its
// cell bounds, 3 * D words) once by each pass and costs lam * D compares;
// the rank pass writes its destination, bucket and child cell (2 + 2 * D
// words); at 64 buckets the histograms are 1/16 of the point bytes. The design
// keeps every count in shared memory and ranks 32 points at a time with
// __match_any_sync / __popc over the lanes below, so the order inside a
// bucket is the input order (the counting sort is stable) without an
// argsort. Eight warps split a chunk into eight consecutive runs; a
// per-warp, per-bucket count and an exclusive scan over the warps give
// each run its base.
//
// Midpoints follow the reference exactly: integers as lo + floor((hi -
// lo) / 2) with int32 wrap-around (computed in unsigned arithmetic),
// floats as lo + (hi - lo) * 0.5 with round-to-nearest intrinsics and no
// fused multiply-add (-fmad=false).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int midpoint(int lo, int hi) {
  const int diff = static_cast<int>(static_cast<unsigned>(hi) -
                                    static_cast<unsigned>(lo));
  return static_cast<int>(static_cast<unsigned>(lo) +
                          static_cast<unsigned>(diff >> 1));
}

__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), 0.5f));
}

// The lambda-level bucket of point i; l and h end as the bucket's cell.
template <typename T, int D>
__device__ __forceinline__ int bucket_of(const T* __restrict__ p,
                                         const T* __restrict__ lo,
                                         const T* __restrict__ hi,
                                         long long i, int lam, T (&l)[D],
                                         T (&h)[D]) {
  T x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x[d] = p[i * D + d];
    l[d] = lo[i * D + d];
    h[d] = hi[i * D + d];
  }
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

template <typename T, int D>
__global__ void sieve_hist_kernel(const T* __restrict__ p,
                                  const T* __restrict__ lo,
                                  const T* __restrict__ hi, int lam, int K,
                                  const int* __restrict__ chunk_start,
                                  const int* __restrict__ chunk_len,
                                  int* __restrict__ hist) {
  extern __shared__ int counts[];
  const int c = blockIdx.x;
  for (int b = threadIdx.x; b < K; b += blockDim.x) counts[b] = 0;
  __syncthreads();
  const long long s = chunk_start[c];
  const int len = chunk_len[c];
  for (int o = threadIdx.x; o < len; o += blockDim.x) {
    T l[D], h[D];
    atomicAdd(&counts[bucket_of<T, D>(p, lo, hi, s + o, lam, l, h)], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < K; b += blockDim.x)
    hist[static_cast<long long>(c) * K + b] = counts[b];
}

template <typename T, int D>
__global__ void sieve_rank_kernel(const T* __restrict__ p,
                                  const T* __restrict__ lo,
                                  const T* __restrict__ hi, int lam, int K,
                                  const int* __restrict__ chunk_start,
                                  const int* __restrict__ chunk_len,
                                  const int* __restrict__ offset,
                                  int* __restrict__ dest,
                                  int* __restrict__ bucket,
                                  T* __restrict__ child_lo,
                                  T* __restrict__ child_hi) {
  const int c = blockIdx.x;
  const int len = chunk_len[c];
  if (len == 0) return;
  extern __shared__ int smem[];
  int* base = smem;              // [kWarps][K]: per-warp counts, then bases
  int* bkt = smem + kWarps * K;  // [len]: the bucket of each point
  const long long s = chunk_start[c];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  // warp w ranks the consecutive run [w * run, (w + 1) * run) of the chunk
  const int run = (len + kThreads - 1) / kThreads * 32;
  const int a = min(warp * run, len);
  const int e = min(a + run, len);

  for (int i = threadIdx.x; i < kWarps * K; i += blockDim.x) base[i] = 0;
  __syncthreads();
  int* mine = base + warp * K;
  for (int o = a; o < e; o += 32) {
    const int j = o + lane;
    const bool live = j < e;
    int b = -1;
    if (live) {
      T l[D], h[D];
      b = bucket_of<T, D>(p, lo, hi, s + j, lam, l, h);
      bkt[j] = b;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        child_lo[(s + j) * D + d] = l[d];
        child_hi[(s + j) * D + d] = h[d];
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (live && (peers & below) == 0) mine[b] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // exclusive scan over the warps, per bucket
  for (int b = threadIdx.x; b < K; b += blockDim.x) {
    int acc = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = base[w * K + b];
      base[w * K + b] = acc;
      acc += t;
    }
  }
  __syncthreads();
  const int* off = offset + static_cast<long long>(c) * K;
  for (int o = a; o < e; o += 32) {
    const int j = o + lane;
    const bool live = j < e;
    const int b = live ? bkt[j] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (live) {
      const int r = mine[b] + __popc(peers & below);
      dest[s + j] = off[b] + r;
      bucket[s + j] = b;
    }
    __syncwarp();
    if (live && (peers & below) == 0) mine[b] += __popc(peers);
    __syncwarp();
  }
}

template <typename T, int D>
int launch_hist(const void* p, const void* lo, const void* hi, int lam,
                const int* cs, const int* cl, int n_chunks, int* hist,
                cudaStream_t stream) {
  const int K = 1 << (lam * D);
  if (n_chunks > 0)
    sieve_hist_kernel<T, D><<<n_chunks, kThreads, K * sizeof(int),
                              stream>>>(
        static_cast<const T*>(p), static_cast<const T*>(lo),
        static_cast<const T*>(hi), lam, K, cs, cl, hist);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_rank(const void* p, const void* lo, const void* hi, int lam,
                const int* cs, const int* cl, int n_chunks, int block_n,
                const int* offset, int* dest, int* bucket, void* child_lo,
                void* child_hi, cudaStream_t stream) {
  const int K = 1 << (lam * D);
  const size_t smem = (static_cast<size_t>(kWarps) * K + block_n) *
                      sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sieve_rank_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_chunks > 0)
    sieve_rank_kernel<T, D><<<n_chunks, kThreads, smem, stream>>>(
        static_cast<const T*>(p), static_cast<const T*>(lo),
        static_cast<const T*>(hi), lam, K, cs, cl, offset, dest, bucket,
        static_cast<T*>(child_lo), static_cast<T*>(child_hi));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hist(int D, const void* p, const void* lo, const void* hi,
                  int lam, const int* cs, const int* cl, int n_chunks,
                  int* hist, cudaStream_t s) {
  switch (D) {
    case 1: return launch_hist<T, 1>(p, lo, hi, lam, cs, cl, n_chunks,
                                     hist, s);
    case 2: return launch_hist<T, 2>(p, lo, hi, lam, cs, cl, n_chunks,
                                     hist, s);
    case 3: return launch_hist<T, 3>(p, lo, hi, lam, cs, cl, n_chunks,
                                     hist, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_rank(int D, const void* p, const void* lo, const void* hi,
                  int lam, const int* cs, const int* cl, int n_chunks,
                  int block_n, const int* offset, int* dest, int* bucket,
                  void* clo, void* chi, cudaStream_t s) {
  switch (D) {
    case 1: return launch_rank<T, 1>(p, lo, hi, lam, cs, cl, n_chunks,
                                     block_n, offset, dest, bucket, clo, chi,
                                     s);
    case 2: return launch_rank<T, 2>(p, lo, hi, lam, cs, cl, n_chunks,
                                     block_n, offset, dest, bucket, clo, chi,
                                     s);
    case 3: return launch_rank<T, 3>(p, lo, hi, lam, cs, cl, n_chunks,
                                     block_n, offset, dest, bucket, clo, chi,
                                     s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// pts, lo, hi: (N, D) int32 (is_float = 0) or float32 (is_float = 1),
// contiguous; chunk_start, chunk_len: (n_chunks,) int32, every chunk
// [start, start + len) inside [0, N) with len <= block_n. Writes hist
// (n_chunks, 2^(lam*D)) int32. Returns cudaGetLastError().
extern "C" int sieve_hist_launch(const void* p, const void* lo,
                                 const void* hi, int is_float, int D,
                                 int lam, const int* chunk_start,
                                 const int* chunk_len, int n_chunks,
                                 int* hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_float ? dispatch_hist<float>(D, p, lo, hi, lam, chunk_start,
                                         chunk_len, n_chunks, hist, s)
                  : dispatch_hist<int>(D, p, lo, hi, lam, chunk_start,
                                       chunk_len, n_chunks, hist, s);
}

// Same operands plus offset (n_chunks, 2^(lam*D)) int32: the destination
// of the first point of each (chunk, bucket). Writes dest and bucket, and
// child_lo / child_hi ((N, D), the points' type: the bucket's cell), of
// every point inside a chunk; other entries are left as they are.
extern "C" int sieve_rank_launch(const void* p, const void* lo,
                                 const void* hi, int is_float, int D,
                                 int lam, const int* chunk_start,
                                 const int* chunk_len, int n_chunks,
                                 int block_n, const int* offset, int* dest,
                                 int* bucket, void* child_lo, void* child_hi,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_float
             ? dispatch_rank<float>(D, p, lo, hi, lam, chunk_start,
                                    chunk_len, n_chunks, block_n, offset,
                                    dest, bucket, child_lo, child_hi, s)
             : dispatch_rank<int>(D, p, lo, hi, lam, chunk_start, chunk_len,
                                  n_chunks, block_n, offset, dest, bucket,
                                  child_lo, child_hi, s);
}
