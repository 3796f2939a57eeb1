// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper.
//
// Replaces the TPU Pallas kernel of src/repro/kernels/rglru_scan.py:
//   rglru_scan_kernel (:63, body _body :30) -> rglru_scan_launch
//
// What it computes, for every batch row b and channel w, in float32:
//   h_{-1} = h0[b, w] (0 when no h0 is given)
//   h_t    = a[b, t, w] * h_{t-1} + b[b, t, w]      for t = 0 .. S-1
// and writes h (B, S, W) and h_last = h_{S-1} (B, W). The reference's ops
// wrapper folds h0 into b[:, 0] before a zero-state kernel; taking h0
// directly is the same recurrence with one rounding fewer.
//
// Bound on this card: bytes. Each element is read twice (a, b) and
// written once, at one fused multiply-add: 12 bytes per 2 flops. At the
// recurrentgemma-9b prefill step (B 2, S 2048, W 4096) that is 201 MB,
// about 0.06 ms at 3.35 TB/s.
//
// Design: one thread per (b, w) channel runs sequentially over S, so the
// carry never leaves a register and no cross-thread combine is needed
// (the TPU kernel's doubling scan exists for its vector unit). Threads
// of a warp hold neighbouring channels, so every load and store of a
// time step is coalesced across w. Each thread loads kUnroll time steps
// of a and b ahead of the dependent FMA chain to keep loads in flight.
// The B * W threads (8192 at the step above) are few for a 132-SM card:
// the kernel relies on those loads in flight, not on occupancy; a
// chunked two-pass scan over S is later work.
//
// C interface (loaded with ctypes): pointers and the stream as void*, and
// the entry returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int B, int64_t S, int64_t W) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const int64_t base = static_cast<int64_t>(bi) * S * W + w;
  float carry = h0 != nullptr ? h0[static_cast<int64_t>(bi) * W + w] : 0.f;
  int64_t t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = a[base + (t + u) * W];
      bv[u] = b[base + (t + u) * W];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = fmaf(av[u], carry, bv[u]);
      h[base + (t + u) * W] = carry;
    }
  }
  for (; t < S; ++t) {
    carry = fmaf(a[base + t * W], carry, b[base + t * W]);
    h[base + t * W] = carry;
  }
  h_last[static_cast<int64_t>(bi) * W + w] = carry;
}

}  // namespace

extern "C" {

// h (B, S, W) and h_last (B, W), float32; h0 (B, W) or null for zeros.
int rglru_scan_launch(const void* a, const void* b, const void* h0, void* h,
                      void* h_last, int B, int64_t S, int64_t W,
                      void* stream) {
  if (B < 1 || B > 65535 || S < 1 || W < 1) return cudaErrorInvalidValue;
  const int64_t bx = (W + kThreads - 1) / kThreads;
  if (bx > 2147483647) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(bx), B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), B, S, W);
  return static_cast<int>(cudaGetLastError());
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
