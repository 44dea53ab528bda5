// Gear-hash CDC boundary scan for Hopper (sm_90a).
//
// Computes what src/repro/kernels/gear_cdc.py:_gear_cdc_kernel computes on
// the TPU: for every byte i of a uint8 stream the rolling gear hash
//     h_i = sum_{j<32} 2^j * G[b_{i-j}]   (mod 2^32),  zero before the start,
// with G the 256-entry table of repro_torch.core.cdc.gear_table().
//
// Design.  The TPU kernel turns the table lookup into a one-hot matmul and
// the serial recurrence into 32 shifted adds because a TPU gathers slowly.
// On Hopper the 1 KiB table sits in shared memory, so each lookup is direct,
// and each thread runs h = (h << 1) + G[b] serially over its own contiguous
// span of kSpan bytes.  A warm-up over the 32 bytes before the span is exact,
// because a byte's term leaves the register after 32 shifts: about two
// operations per byte instead of 32.  Each block stages its tile and the
// 32-byte halo before it into shared memory with 16-byte coalesced loads.
// kSpan is 31 words, an odd word stride, so the 32 lanes of a warp read 32
// different shared-memory banks.
//
// Bound.  The scan reads each input byte once from HBM and does about six
// integer operations per byte (byte extract, shift, add, mask, test, count).
// On an H100 (3.35 TB/s of HBM; 64 INT32 lanes on each of 132 SMs at
// 1.98 GHz) the two bounds lie close, the operations' slightly above the
// bytes'; candidate mode walks every byte twice, once to count and once to
// emit, so it does twice the operations the function needs.
// Candidate mode writes only the sorted positions where h & mask == 0 (8
// bytes each, about 2 MB per GiB at 4 KiB chunks) instead of a hash per byte:
// a count pass, an exclusive scan of the per-block counts, and an emit pass
// that recomputes the hashes and writes each block's positions in order.
//
// Plain C interface for ctypes; every launcher returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 124;                  // bytes per thread: 31 words
constexpr int kWords = kSpan / 4;
constexpr int kTile = kThreads * kSpan;     // 31744 bytes per block
constexpr int kHalo = 32;                   // GEAR_WINDOW bytes before a tile
constexpr int kScanThreads = 1024;

static_assert(kSpan % 4 == 0 && kWords % 2 == 1,
              "an odd word stride keeps a warp's shared reads conflict-free");
static_assert(kTile % 16 == 0, "tiles are staged in 16-byte loads");
static_assert(kSpan <= 128, "emit keeps a thread's candidates in 4 words");

struct __align__(16) Tile {
  uint32_t table[256];
  uint8_t bytes[kHalo + kTile];             // stream bytes [base-32, base+kTile)
};

// Stage the gear table and the block's bytes (halo included) into shared
// memory.  Bytes outside [0, n) are staged as 0; the walk gives positions
// before the stream's start no term, and positions past n are never output.
__device__ __forceinline__ void stage(Tile& s, const uint8_t* __restrict__ data,
                                      long long n, long long base,
                                      const uint32_t* __restrict__ table) {
  for (int i = threadIdx.x; i < 256; i += kThreads) s.table[i] = table[i];
  const bool aligned = (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  const long long start = base - kHalo;
  constexpr int kVecs = (kHalo + kTile) / 16;
  uint4* dst = reinterpret_cast<uint4*>(s.bytes);
  for (int v = threadIdx.x; v < kVecs; v += kThreads) {
    const long long p = start + 16LL * v;
    uint4 val;
    if (aligned && p >= 0 && p + 16 <= n) {
      val = __ldg(reinterpret_cast<const uint4*>(data + p));
    } else {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t x = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const long long q = p + 4 * k + b;
          if (q >= 0 && q < n) x |= uint32_t(data[q]) << (8 * b);
        }
        w[k] = x;
      }
      val = make_uint4(w[0], w[1], w[2], w[3]);
    }
    dst[v] = val;
  }
  __syncthreads();
}

// Run the gear register over this thread's span; visit(k, h) sees the hash
// of span byte k (0 <= k < kSpan).  k is a constant after unrolling.
template <class Visit>
__device__ __forceinline__ void walk(const Tile& s, long long base, Visit visit) {
  const int off = threadIdx.x * kSpan;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(s.bytes);
  const long long first = base + off - kHalo;   // stream position of warm-up byte 0
  uint32_t h = 0;
#pragma unroll
  for (int k = 0; k < kHalo / 4; ++k) {
    const uint32_t w = words[off / 4 + k];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t g = (first + 4 * k + b >= 0) ? s.table[(w >> (8 * b)) & 0xff] : 0u;
      h = (h << 1) + g;
    }
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t w = words[(kHalo + off) / 4 + k];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      h = (h << 1) + s.table[(w >> (8 * b)) & 0xff];
      visit(4 * k + b, h);
    }
  }
}

// Exclusive prefix sum over the block's threads, in thread order.
template <typename T, int kBlock>
__device__ __forceinline__ T block_exclusive_scan(T x) {
  static_assert(kBlock % 32 == 0 && kBlock <= 1024, "whole warps, one scan warp");
  __shared__ T warp_base[kBlock / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_base[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T v = lane < kBlock / 32 ? warp_base[lane] : T(0);
    T vi = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, vi, d);
      if (lane >= d) vi += y;
    }
    if (lane < kBlock / 32) warp_base[lane] = vi - v;
  }
  __syncthreads();
  return warp_base[warp] + incl - x;
}

__global__ void __launch_bounds__(kThreads)
gear_hash_kernel(const uint8_t* __restrict__ data, long long n,
                 const uint32_t* __restrict__ table, uint32_t* __restrict__ out) {
  __shared__ Tile s;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  stage(s, data, n, base, table);
  const long long pos0 = base + threadIdx.x * kSpan;
  uint32_t q[4];
  walk(s, base, [&](int k, uint32_t h) {
    q[k & 3] = h;
    if ((k & 3) == 3) {
      const long long p = pos0 + k - 3;     // multiple of 4: out + p is 16-byte aligned
      if (p + 4 <= n) {
        *reinterpret_cast<uint4*>(out + p) = make_uint4(q[0], q[1], q[2], q[3]);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (p + b < n) out[p + b] = q[b];
      }
    }
  });
}

__global__ void __launch_bounds__(kThreads)
gear_count_kernel(const uint8_t* __restrict__ data, long long n,
                  const uint32_t* __restrict__ table, uint32_t mask,
                  int* __restrict__ counts) {
  __shared__ Tile s;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  stage(s, data, n, base, table);
  const long long pos0 = base + threadIdx.x * kSpan;
  int c = 0;
  walk(s, base, [&](int k, uint32_t h) {
    c += ((h & mask) == 0u) && (pos0 + k < n);
  });
  const int before = block_exclusive_scan<int, kThreads>(c);
  if (threadIdx.x == kThreads - 1) counts[blockIdx.x] = before + c;
}

// offsets[i] = sum of counts[0..i); offsets[nb] = the total.  One block.
__global__ void __launch_bounds__(kScanThreads)
block_offsets_kernel(const int* __restrict__ counts, int nb,
                     long long* __restrict__ offsets) {
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int lo = min(nb, static_cast<int>(threadIdx.x) * per);
  const int hi = min(nb, lo + per);
  long long sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  long long run = block_exclusive_scan<long long, kScanThreads>(sum);
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == kScanThreads - 1) offsets[nb] = run;
}

__global__ void __launch_bounds__(kThreads)
gear_emit_kernel(const uint8_t* __restrict__ data, long long n,
                 const uint32_t* __restrict__ table, uint32_t mask,
                 const long long* __restrict__ offsets,
                 long long* __restrict__ out) {
  __shared__ Tile s;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  stage(s, data, n, base, table);
  const long long pos0 = base + threadIdx.x * kSpan;
  uint32_t bits[4] = {0u, 0u, 0u, 0u};
  walk(s, base, [&](int k, uint32_t h) {
    if (((h & mask) == 0u) && (pos0 + k < n)) bits[k >> 5] |= 1u << (k & 31);
  });
  const int c = __popc(bits[0]) + __popc(bits[1]) + __popc(bits[2]) + __popc(bits[3]);
  long long at = offsets[blockIdx.x] + block_exclusive_scan<int, kThreads>(c);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t b = bits[w];
    while (b) {
      out[at++] = pos0 + 32 * w + (__ffs(b) - 1);
      b &= b - 1;
    }
  }
}

long long num_tiles(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" {

long long gear_tile_bytes() { return kTile; }

// uint8 (n,) -> uint32 (n,) hashes.
int gear_hash_launch(const void* data, long long n, const void* table, void* out,
                     void* stream) {
  if (n <= 0) return 0;
  gear_hash_kernel<<<static_cast<unsigned>(num_tiles(n)), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, static_cast<const uint32_t*>(table),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Per-tile candidate counts (int32, one per tile) and their exclusive
// offsets (int64, one per tile plus the total at the end).
int gear_count_launch(const void* data, long long n, const void* table,
                      unsigned mask, void* counts, void* offsets, void* stream) {
  if (n <= 0) return 0;
  const long long nb = num_tiles(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gear_count_kernel<<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(data), n, static_cast<const uint32_t*>(table),
      mask, static_cast<int*>(counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  block_offsets_kernel<<<1, kScanThreads, 0, st>>>(
      static_cast<const int*>(counts), static_cast<int>(nb),
      static_cast<long long*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// Sorted candidate positions (int64) at the offsets from gear_count_launch.
int gear_emit_launch(const void* data, long long n, const void* table,
                     unsigned mask, const void* offsets, void* out, void* stream) {
  if (n <= 0) return 0;
  gear_emit_kernel<<<static_cast<unsigned>(num_tiles(n)), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, static_cast<const uint32_t*>(table),
      mask, static_cast<const long long*>(offsets), static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
