// Fused coded-gradient decode-combine (+ ADMM eq. 5a x-update) for Hopper.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/coded_combine.py:
//   coded_combine_kernel     (:57, body _combine_body :50)  -> coded_combine_launch
//   coded_admm_update_kernel (:104, body _admm_body :86)    -> coded_admm_update_launch
//
// What it computes, for every run r of a leading runs axis (the reference
// gets that axis from jax.vmap):
//   G[r]  = sum_j coeffs[r, j] * where(mask[r, j] > 0, msgs[r, j], 0)
//   x+[r] = (tau[r] x[r] + rho[r] z[r] + y[r] - G[r]) / (rho[r] + tau[r])
// Dead rows are dropped by a select before the reduction (never loaded),
// so NaN/Inf garbage in a never-arrived message cannot reach the output.
// Accumulation is in promote(T, float32): float for bf16/f32 messages,
// double for f64. The combine returns the accumulation type, the update
// returns the message type (= x's type). Coefficients, alive mask, tau
// and rho come in the accumulation type.
//
// Bound on this card: memory. Per call the kernel must read
// R * (J + 3) * n message/x/y/z elements plus R * (2J + 2) scalars and
// write R * n elements, at two flops per message element, far below the
// H100's flop:byte balance. The least time is bytes / 3.35 TB/s.
//
// Design: a 2-D grid, x over column tiles of n, y over runs (looping
// when R exceeds the grid's y limit). A block stages its run's J
// coefficients and alive flags in shared memory once; each thread owns
// one column (grid-stride over n), walks the J <= 16 message rows with
// a compile-time-bounded, runtime-trip-count loop, and masks the ragged
// edge of n itself, so callers never pad. Neighbouring threads read
// neighbouring addresses in every row, so loads coalesce. Vectorised
// loads, TMA staging and packing several tiny-n runs per block are left
// for later work.
//
// C interface (loaded with ctypes): pointers and the stream as void*,
// every entry returns cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxJ = 16;          // ECNs per agent the kernel accepts
constexpr int kMaxGridY = 65535;   // CUDA's limit on gridDim.y
constexpr int kMaxThreads = 256;

enum DType : int { kF32 = 0, kF64 = 1, kBF16 = 2 };

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as astype does
}

// kUpdate = false: out (R, n) of Acc<T> = G.
// kUpdate = true:  out (R, n) of T      = x+.
template <typename T, bool kUpdate>
__global__ void coded_kernel(const T* __restrict__ msgs,
                             const typename Acc<T>::type* __restrict__ coeffs,
                             const typename Acc<T>::type* __restrict__ mask,
                             const T* __restrict__ x, const T* __restrict__ y,
                             const T* __restrict__ z,
                             const typename Acc<T>::type* __restrict__ tau,
                             const typename Acc<T>::type* __restrict__ rho,
                             void* __restrict__ out, int R, int J,
                             int64_t n) {
  using C = typename Acc<T>::type;
  using Out = typename std::conditional<kUpdate, T, C>::type;
  __shared__ C s_coef[kMaxJ];
  __shared__ bool s_alive[kMaxJ];

  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    __syncthreads();  // the previous run's readers are done with s_*
    if (threadIdx.x < J) {
      const int64_t o = static_cast<int64_t>(r) * J + threadIdx.x;
      s_coef[threadIdx.x] = coeffs[o];
      s_alive[threadIdx.x] = mask[o] > C(0);
    }
    __syncthreads();
    C t = C(0), p = C(0);
    if constexpr (kUpdate) {
      t = tau[r];
      p = rho[r];
    }
    const T* m = msgs + static_cast<int64_t>(r) * J * n;
    Out* o_row = static_cast<Out*>(out) + static_cast<int64_t>(r) * n;
    for (int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         col < n; col += static_cast<int64_t>(gridDim.x) * blockDim.x) {
      C g = C(0);
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        if (j < J) {
          const C v = s_alive[j] ? to_acc(m[j * n + col]) : C(0);
          g += v * s_coef[j];
        }
      }
      if constexpr (kUpdate) {
        const int64_t e = static_cast<int64_t>(r) * n + col;
        const C num = t * to_acc(x[e]) + p * to_acc(z[e]) + to_acc(y[e]) - g;
        store(o_row + col, num / (p + t));
      } else {
        store(o_row + col, g);
      }
    }
  }
}

template <typename T, bool kUpdate>
int launch(const void* msgs, const void* coeffs, const void* mask,
           const void* x, const void* y, const void* z, const void* tau,
           const void* rho, void* out, int R, int J, int64_t n,
           void* stream) {
  using C = typename Acc<T>::type;
  if (R < 1 || J < 1 || J > kMaxJ || n < 1) return cudaErrorInvalidValue;
  // One warp at least, 256 threads at most: a tiny n (3 floats for the
  // paper's synthetic set) should not idle 253 threads of a block.
  const int64_t warps = (n + 31) / 32;
  const int threads =
      static_cast<int>(warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads);
  const int64_t bx = (n + threads - 1) / threads;
  const dim3 grid(static_cast<unsigned>(bx < 2147483647 ? bx : 2147483647),
                  static_cast<unsigned>(R < kMaxGridY ? R : kMaxGridY));
  coded_kernel<T, kUpdate><<<grid, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(msgs), static_cast<const C*>(coeffs),
      static_cast<const C*>(mask), static_cast<const T*>(x),
      static_cast<const T*>(y), static_cast<const T*>(z),
      static_cast<const C*>(tau), static_cast<const C*>(rho), out, R, J, n);
  return static_cast<int>(cudaGetLastError());
}

template <bool kUpdate>
int dispatch(int dtype, const void* msgs, const void* coeffs,
             const void* mask, const void* x, const void* y, const void* z,
             const void* tau, const void* rho, void* out, int R, int J,
             int64_t n, void* stream) {
  switch (dtype) {
    case kF32:
      return launch<float, kUpdate>(msgs, coeffs, mask, x, y, z, tau, rho,
                                    out, R, J, n, stream);
    case kF64:
      return launch<double, kUpdate>(msgs, coeffs, mask, x, y, z, tau, rho,
                                     out, R, J, n, stream);
    case kBF16:
      return launch<__nv_bfloat16, kUpdate>(msgs, coeffs, mask, x, y, z, tau,
                                            rho, out, R, J, n, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (R, n) in the accumulation type = sum_j coeffs * [mask > 0] * msgs.
int coded_combine_launch(int dtype, const void* msgs, const void* coeffs,
                         const void* mask, void* out, int R, int J, int64_t n,
                         void* stream) {
  return dispatch<false>(dtype, msgs, coeffs, mask, nullptr, nullptr, nullptr,
                         nullptr, nullptr, out, R, J, n, stream);
}

// out (R, n) in the message type = eq. (5a) x-update of every run.
int coded_admm_update_launch(int dtype, const void* msgs, const void* coeffs,
                             const void* mask, const void* x, const void* y,
                             const void* z, const void* tau, const void* rho,
                             void* out, int R, int J, int64_t n,
                             void* stream) {
  return dispatch<true>(dtype, msgs, coeffs, mask, x, y, z, tau, rho, out, R,
                        J, n, stream);
}

const char* coded_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
