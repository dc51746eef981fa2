// Morton (Z-curve) codes of integer points: quantize each coordinate
// (a logical right shift as uint32), then interleave the bits of the D
// coordinates into one code, coordinate 0 giving the most significant bit
// of each group.
//
// Replaces: src/repro/kernels/morton/kernel.py:morton_encode_pallas (body
// _morton_kernel), the TPU kernel that fuses the quantization and the
// magic-mask interleave in one VMEM pass over tiles of coordinates. It
// computes the function of the reference core's twin,
// src/repro/core/sfc.py:morton_encode(points.astype(uint32) >> shift,
// bits): in 2D the spread keeps 16 bits of each coordinate, in 3D 10 bits,
// whatever `bits` is (the same masks, so a coordinate at or above
// 2^bits after the shift lands above bit bits * D exactly as there). Other
// dimensions take the reference's plain loop over `bits` bit levels. The
// code is written as int64 (the port carries codes in int64; every code
// here has at most 32 bits).
//
// What bounds it on an H100: bytes. Each point reads D int32 words and
// writes one int64 code; the spread is about fifteen integer operations a
// coordinate, far below the card's rate. The design is one thread a point
// over a grid-stride loop, so neighbouring threads read neighbouring
// points and write neighbouring codes (coalesced); a 2D point whose row is
// 8-byte aligned is read with one 8-byte load.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

__device__ __forceinline__ uint32_t quantize(int32_t v, int shift) {
  // the reference's astype(uint32) >> shift; a shift of 32 or more
  // empties a 32-bit word
  return shift >= 32 ? 0u : static_cast<uint32_t>(v) >> shift;
}

__device__ __forceinline__ uint32_t spread2(uint32_t x) {
  x &= 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

__device__ __forceinline__ uint32_t spread3(uint32_t x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

template <bool kVec>
__global__ void morton2_kernel(const int32_t* __restrict__ p, long long n,
                               int shift, long long* __restrict__ out) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    int32_t x, y;
    if (kVec) {
      const int2 v = reinterpret_cast<const int2*>(p)[i];
      x = v.x;
      y = v.y;
    } else {
      x = p[2 * i];
      y = p[2 * i + 1];
    }
    const uint32_t code = (spread2(quantize(x, shift)) << 1) |
                          spread2(quantize(y, shift));
    out[i] = static_cast<long long>(code);
  }
}

__global__ void morton3_kernel(const int32_t* __restrict__ p, long long n,
                               int shift, long long* __restrict__ out) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const uint32_t code = (spread3(quantize(p[3 * i], shift)) << 2) |
                          (spread3(quantize(p[3 * i + 1], shift)) << 1) |
                          spread3(quantize(p[3 * i + 2], shift));
    out[i] = static_cast<long long>(code);
  }
}

// Any other D: bit b of coordinate c lands at b * D + (D - 1 - c), for
// the `bits` low bits of each coordinate (bits * D <= 32).
__global__ void morton_generic_kernel(const int32_t* __restrict__ p,
                                      long long n, int dim, int bits,
                                      int shift,
                                      long long* __restrict__ out) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    unsigned long long code = 0;
    for (int c = 0; c < dim; ++c) {
      const uint32_t q = quantize(p[i * dim + c], shift);
      for (int b = 0; b < bits; ++b) {
        code |= static_cast<unsigned long long>((q >> b) & 1u)
                << (b * dim + (dim - 1 - c));
      }
    }
    out[i] = static_cast<long long>(code);
  }
}

}  // namespace

// p: (n, dim) int32, contiguous; out: (n,) int64. Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int morton_encode_launch(const void* p, long long n, int dim,
                                    int bits, int shift, void* out,
                                    void* stream) {
  if (n <= 0) return 0;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* pts = static_cast<const int32_t*>(p);
  long long* codes = static_cast<long long*>(out);
  if (dim == 2) {
    if (reinterpret_cast<uintptr_t>(p) % 8 == 0) {
      morton2_kernel<true><<<blocks, kThreads, 0, s>>>(pts, n, shift, codes);
    } else {
      morton2_kernel<false><<<blocks, kThreads, 0, s>>>(pts, n, shift, codes);
    }
  } else if (dim == 3) {
    morton3_kernel<<<blocks, kThreads, 0, s>>>(pts, n, shift, codes);
  } else {
    morton_generic_kernel<<<blocks, kThreads, 0, s>>>(pts, n, dim, bits,
                                                      shift, codes);
  }
  return static_cast<int>(cudaGetLastError());
}
