// Fused frontier kNN for the port's auto route above R*C = 2^15.
//
// Replaces: src/repro/kernels/frontier/kernel.py:knn_frontier_pallas (body
// _frontier_kernel), the TPU kernel that runs a sequential
// (query_blocks, groups) grid, fetches each group tile through a
// scalar-prefetched index map, scores it with the centered MXU identity and
// predicates a whole step away once the group's lower bound passes the
// block's worst k-th best distance.
//
// What bounds it on an H100: the groups a query block must visit. Each
// visited group is block_r leaf rows of C points (D int32 coordinates plus
// a validity byte) read from the tree's own (R, C, D) arrays, and every
// point costs D subtractions, D multiplies, D-1 adds and a compare per
// query of the block on the CUDA cores (D <= 3: no tensor-core product is
// worth forming). Over a whole batch the group reads approach one pass over
// the tree, so the floor is the tree's bytes over device bandwidth; the
// pair work per block is what the early exit cuts.
//
// What the design does about it: the TPU's sequential grid axis becomes a
// loop inside one CUDA block per query block, so the early exit is a
// `break` (the TPU had to predicate every remaining step). The block loads
// its own row of the visit order and lower bounds, stages each group's
// points through shared memory once (each point is read from device memory
// once per block and converted int32 -> f32 on the way), and every thread
// scores them against its own query held in registers, keeping its running
// top-k in shared memory. The block's worst k-th best is an atomicMax over
// the threads' k-th bests (all non-negative, so float order is integer
// order). Distances are the direct sum over d = 0..D-1 of (q_d - p_d)^2 with
// round-to-nearest intrinsics (and -fmad=false): no centered copy of the
// points is needed, and the result equals the plain PyTorch walk bit for
// bit. Ties keep lax.top_k's order over [running, tile]: a candidate enters
// only when strictly below the k-th entry and is placed after equal
// entries, and each group's slots are scanned in id order.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kTile = 256;

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

__device__ __forceinline__ void insert_sorted(float* bd, int* bi, int T,
                                              int t, int k, float d,
                                              int id) {
  int pos = k - 1;
  while (pos > 0) {
    const float prev = bd[(pos - 1) * T + t];
    if (prev <= d) break;
    bd[pos * T + t] = prev;
    bi[pos * T + t] = bi[(pos - 1) * T + t];
    --pos;
  }
  bd[pos * T + t] = d;
  bi[pos * T + t] = id;
}

__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename PT, int D>
__global__ void knn_frontier_kernel(const float* __restrict__ qs,
                                    const PT* __restrict__ pts,
                                    const unsigned char* __restrict__ valid,
                                    const unsigned char* __restrict__ active,
                                    const int* __restrict__ order,
                                    const float* __restrict__ glb,
                                    int R, int C, int G, int block_r, int k,
                                    float* __restrict__ out_d,
                                    int* __restrict__ out_i,
                                    int* __restrict__ steps) {
  extern __shared__ unsigned char smem[];
  __shared__ unsigned int s_worst;
  const int T = blockDim.x;  // == block_q: one thread per query
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  float* bd = reinterpret_cast<float*>(smem);
  int* bi = reinterpret_cast<int*>(bd + k * T);
  float* tp = reinterpret_cast<float*>(bi + k * T);
  unsigned char* tok = reinterpret_cast<unsigned char*>(tp + kTile * D);

  const long long qi = static_cast<long long>(b) * T + t;
  float qv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qv[d] = qs[qi * D + d];
  for (int j = 0; j < k; ++j) {
    bd[j * T + t] = kBig;
    bi[j * T + t] = -1;
  }
  float kth = kBig;
  const long long P = static_cast<long long>(block_r) * C;
  const int* order_b = order + static_cast<long long>(b) * G;
  const float* glb_b = glb + static_cast<long long>(b) * G;

  int j = 0;
  for (; j < G; ++j) {
    if (t == 0) s_worst = 0u;
    __syncthreads();
    atomicMax(&s_worst, __float_as_uint(kth));
    __syncthreads();
    // uniform across the block: every thread reads the same two values
    if (glb_b[j] > __uint_as_float(s_worst)) break;
    const long long g = order_b[j];
    const long long row0 = g * block_r;
    for (long long base = 0; base < P; base += kTile) {
      const int n = static_cast<int>(min(static_cast<long long>(kTile),
                                         P - base));
      __syncthreads();  // the previous tile (and s_worst) are consumed
      for (int o = t; o < n; o += T) {
        const long long slot = base + o;
        const long long row = row0 + slot / C;
        const long long flat = row * C + slot % C;
        unsigned char okv = 0;
        if (row < R) {
          okv = valid[flat] && active[row];
#pragma unroll
          for (int d = 0; d < D; ++d) tp[o * D + d] = to_f32(pts[flat * D + d]);
        }
        tok[o] = okv;
      }
      __syncthreads();
      for (int o = 0; o < n; ++o) {
        if (!tok[o]) continue;
        const float d2 = direct_d2<D>(qv, tp + o * D);
        if (d2 < kth) {
          insert_sorted(bd, bi, T, t, k, d2,
                        static_cast<int>(row0 * C + base + o));
          kth = bd[(k - 1) * T + t];
        }
      }
    }
  }
  if (t == 0) steps[b] = j;
  for (int jj = 0; jj < k; ++jj) {
    const float d = bd[jj * T + t];
    out_d[qi * k + jj] = d;
    out_i[qi * k + jj] = d >= kBig ? -1 : bi[jj * T + t];
  }
}

template <typename PT, int D>
int launch(const float* qs, const void* pts, const unsigned char* valid,
           const unsigned char* active, const int* order, const float* glb,
           int R, int C, int G, int block_r, int nqb, int bq, int k,
           float* out_d, int* out_i, int* steps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2) * k * bq * 4 +
                      static_cast<size_t>(kTile) * D * 4 + kTile;
  auto kern = knn_frontier_kernel<PT, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (nqb > 0)
    kern<<<nqb, bq, smem, stream>>>(qs, static_cast<const PT*>(pts), valid,
                                    active, order, glb, R, C, G, block_r, k,
                                    out_d, out_i, steps);
  return static_cast<int>(cudaGetLastError());
}

template <typename PT>
int launch_d(int D, const float* qs, const void* pts,
             const unsigned char* valid, const unsigned char* active,
             const int* order, const float* glb, int R, int C, int G,
             int block_r, int nqb, int bq, int k, float* out_d, int* out_i,
             int* steps, cudaStream_t s) {
  switch (D) {
    case 1: return launch<PT, 1>(qs, pts, valid, active, order, glb, R, C, G,
                                 block_r, nqb, bq, k, out_d, out_i, steps, s);
    case 2: return launch<PT, 2>(qs, pts, valid, active, order, glb, R, C, G,
                                 block_r, nqb, bq, k, out_d, out_i, steps, s);
    case 3: return launch<PT, 3>(qs, pts, valid, active, order, glb, R, C, G,
                                 block_r, nqb, bq, k, out_d, out_i, steps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// qs (nqb*bq, D) f32 sorted queries; pts (R, C, D) int32 (pts_float == 0)
// or f32 (pts_float == 1); valid (R, C) and active (R,) bool as bytes;
// order (nqb, G) i32 and glb (nqb, G) f32 per query block; all contiguous
// on the device. Writes d2 / ids (nqb*bq, k) and steps (nqb,) = groups
// visited per block. Returns cudaGetLastError().
extern "C" int knn_frontier_launch(const float* qs, const void* pts,
                                   int pts_float, const unsigned char* valid,
                                   const unsigned char* active,
                                   const int* order, const float* glb, int R,
                                   int C, int D, int G, int block_r, int nqb,
                                   int bq, int k, float* out_d, int* out_i,
                                   int* steps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pts_float)
    return launch_d<float>(D, qs, pts, valid, active, order, glb, R, C, G,
                           block_r, nqb, bq, k, out_d, out_i, steps, s);
  return launch_d<int>(D, qs, pts, valid, active, order, glb, R, C, G,
                       block_r, nqb, bq, k, out_d, out_i, steps, s);
}
