// Fused coded-gradient decode-combine (+ ADMM eq. 5a x-update) for Hopper.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/coded_combine.py:
//   coded_combine_kernel     (:57, pl.pallas_call :70, body _combine_body :50)
//     -> coded_combine_launch
//   coded_admm_update_kernel (:104, pl.pallas_call :132, body _admm_body :86)
//     -> coded_admm_update_launch
//
// What it computes, for every run r of a leading runs axis (the reference
// gets that axis from jax.vmap):
//   G[r]  = sum_j coeffs[r, j] * where(mask[r, j] > 0, msgs[r, j], 0)
//   x+[r] = (tau[r] x[r] + rho[r] z[r] + y[r] - G[r]) / (rho[r] + tau[r])
// Dead rows are dropped by a select before the reduction (never loaded),
// so NaN/Inf garbage in a never-arrived message cannot reach the output.
// The sum runs over j in ascending order. Accumulation is in
// promote(T, float32): float for bf16/f32 messages, double for f64. The
// combine returns the accumulation type, the update returns the message
// type (= x's type). Coefficients, alive mask, tau and rho come in the
// accumulation type, as runtime data.
//
// Bound on this card: memory. Per call the kernel must read the alive
// message rows and R * 3 * n x/y/z elements plus R * (2J + 2) scalars and
// write R * n elements, at two flops per message element, far below the
// H100's flop:byte balance. The least time is bytes / 3.35 TB/s.
//
// What held the first design back (35% of the bytes bound at the fleet
// step, R 4096, J 16, n 2560): each thread owned one column and made one
// 4-byte (2-byte in bf16) load per row behind a branch on the alive flag,
// and every block first staged the coefficients and flags in shared memory
// between two __syncthreads() before it issued a message load: 40,960
// short blocks of 256 threads, each with few bytes in flight.
//
// Design: each thread owns one 16-byte vector of columns (4 f32, 8 bf16,
// 2 f64). Lane j < J of each warp reads row j's alive flag and coefficient
// of the run straight into a register (no shared memory, no barrier); a
// ballot gives every lane the run's alive bits and a shuffle hands it
// coefficient j at its FMA. The thread then issues the loads of every
// alive row (predicated on the bits, the same for the whole run, so
// nothing diverges) and of x/y/z before the first FMA, and sums in
// ascending j as before, row by row, so f64 results are bit-identical to
// the first design's. The next run's flags and coefficients are loaded while
// this run's messages are in flight, so no run waits on its flags. Blocks
// of 128 threads (four blocks an SM; three for bf16's 8 columns) stride
// over the column vectors and over the runs, one wave of as many blocks
// as fit the SMs at once, so their set-up is amortised. Rows whose start
// is not 16-byte aligned take the scalar instance of the same body (one
// element a thread): n not a multiple of the vector width (fig5's n = 3,
// ijcnn1's n = 22) or a misaligned base pointer; only alignment selects
// it. The ragged edge of n is masked here, so callers never pad.
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
constexpr int kThreads = 128;
constexpr int kVecBytes = 16;

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

// kV elements of T, loaded and stored in 16-byte accesses when kV > 1.
template <typename T, int kV>
struct alignas(sizeof(T) * kV < kVecBytes ? sizeof(T) * kV : kVecBytes) Pack {
  T v[kV];
};

// Blocks an SM each instance is compiled for: four (at most 128 registers a
// thread) keep 16 rows of 16-byte loads in flight for 512 threads; the
// bf16 vector instance converts 8 columns a row and needs more (three
// blocks, at most 168 registers) to hold its loads without spilling.
template <typename T, int kV>
constexpr int min_blocks() {
  return sizeof(T) == 2 && kV > 1 ? 3 : 4;
}

// kUpdate = false: out (R, n) of Acc<T> = G.
// kUpdate = true:  out (R, n) of T      = x+.
// Thread (blockIdx.x, threadIdx.x) owns column vector c of every run
// r = blockIdx.y, blockIdx.y + gridDim.y, ...; kV = 1 is the scalar
// instance for rows that are not 16-byte aligned.
template <typename T, bool kUpdate, int kV>
__global__ void __launch_bounds__(kThreads, min_blocks<T, kV>())
coded_kernel(const T* __restrict__ msgs,
             const typename Acc<T>::type* __restrict__ coeffs,
             const typename Acc<T>::type* __restrict__ mask,
             const T* __restrict__ x, const T* __restrict__ y,
             const T* __restrict__ z,
             const typename Acc<T>::type* __restrict__ tau,
             const typename Acc<T>::type* __restrict__ rho,
             void* __restrict__ out, int R, int J, int64_t n) {
  using C = typename Acc<T>::type;
  using Out = typename std::conditional<kUpdate, T, C>::type;
  using In = Pack<T, kV>;
  const int64_t nv = n / kV;  // column vectors per row (kV divides n)
  const int lane = threadIdx.x % 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // Column vectors of this thread's warp: the loop runs while any lane of
  // the warp has one, so every lane takes part in the shuffles.
  const int64_t c_first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;

  C mk = C(0), cf = C(0);  // lane j: the current run's mask and coefficient
  if (lane < J && blockIdx.y < R) {
    mk = mask[static_cast<int64_t>(blockIdx.y) * J + lane];
    cf = coeffs[static_cast<int64_t>(blockIdx.y) * J + lane];
  }
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    const int64_t run = static_cast<int64_t>(r);
    const unsigned alive = __ballot_sync(0xffffffffu, mk > C(0));
    const C coef = cf;
    mk = cf = C(0);
    if (lane < J && r + gridDim.y < R) {
      mk = mask[(run + gridDim.y) * J + lane];
      cf = coeffs[(run + gridDim.y) * J + lane];
    }
    C t = C(0), p = C(0);
    if constexpr (kUpdate) {
      t = tau[r];
      p = rho[r];
    }
    const In* m = reinterpret_cast<const In*>(msgs + run * J * n);
    for (int64_t c = c_first; c - lane < nv; c += stride) {
      const bool mine = c < nv;
      // Every alive row's load (and x, y, z) in flight before any FMA;
      // the alive bits are the same for the whole run, so the predicated
      // loads do not diverge.
      In v[kMaxJ];
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        if (mine && (alive >> j & 1u)) v[j] = m[j * nv + c];
      }
      In xv, yv, zv;
      if constexpr (kUpdate) {
        if (mine) {
          const int64_t e = run * nv + c;
          xv = reinterpret_cast<const In*>(x)[e];
          yv = reinterpret_cast<const In*>(y)[e];
          zv = reinterpret_cast<const In*>(z)[e];
        }
      }
      // G in ascending j, row by row (a row's registers die after it).
      C g[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) g[e] = C(0);
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        if (j < J) {
          const C cj = __shfl_sync(0xffffffffu, coef, j);
          const bool a = alive >> j & 1u;
#pragma unroll
          for (int e = 0; e < kV; ++e) {
            const C w = a ? to_acc(v[j].v[e]) : C(0);
            g[e] += w * cj;
          }
        }
      }
      if (!mine) continue;
      Pack<Out, kV> res;
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        if constexpr (kUpdate) {
          const C num = t * to_acc(xv.v[e]) + p * to_acc(zv.v[e]) +
                        to_acc(yv.v[e]) - g[e];
          store(&res.v[e], num / (p + t));
        } else {
          store(&res.v[e], g[e]);
        }
      }
      reinterpret_cast<Pack<Out, kV>*>(out)[run * nv + c] = res;
    }
  }
}

// Blocks of one instance that fit an SM at once, times the SMs: the grid
// is one wave, and each block strides over what is left.
template <typename T, bool kUpdate, int kV>
int64_t resident_blocks() {
  static const int64_t blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, coded_kernel<T, kUpdate, kV>, kThreads, 0) != cudaSuccess)
      return static_cast<int64_t>(132 * 4);  // an H100 SXM, 4 blocks an SM
    return static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  }();
  return blocks;
}

template <typename T, bool kUpdate, int kV>
int launch_body(const void* msgs, const void* coeffs, const void* mask,
                const void* x, const void* y, const void* z, const void* tau,
                const void* rho, void* out, int R, int J, int64_t n,
                void* stream) {
  using C = typename Acc<T>::type;
  const int64_t nv = n / kV;
  const int64_t bx_need = (nv + kThreads - 1) / kThreads;
  const int64_t target = resident_blocks<T, kUpdate, kV>();
  const int64_t bx = bx_need < target ? bx_need : target;
  int64_t by = target / bx;  // rounded down: the grid stays one wave
  if (by < 1) by = 1;
  if (by > R) by = R;
  if (by > kMaxGridY) by = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  coded_kernel<T, kUpdate, kV><<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(msgs), static_cast<const C*>(coeffs),
      static_cast<const C*>(mask), static_cast<const T*>(x),
      static_cast<const T*>(y), static_cast<const T*>(z),
      static_cast<const C*>(tau), static_cast<const C*>(rho), out, R, J, n);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0;
}

template <typename T, bool kUpdate>
int launch(const void* msgs, const void* coeffs, const void* mask,
           const void* x, const void* y, const void* z, const void* tau,
           const void* rho, void* out, int R, int J, int64_t n,
           void* stream) {
  if (R < 1 || J < 1 || J > kMaxJ || n < 1) return cudaErrorInvalidValue;
  // Vectors of the message type; the combine's output (Acc<T>) is as wide
  // or wider, so its rows are 16-byte aligned whenever the inputs' are.
  constexpr int kV = kVecBytes / sizeof(T);
  bool vec = n % kV == 0 && aligned(msgs) && aligned(out);
  if (kUpdate) vec = vec && aligned(x) && aligned(y) && aligned(z);
  return vec ? launch_body<T, kUpdate, kV>(msgs, coeffs, mask, x, y, z, tau,
                                           rho, out, R, J, n, stream)
             : launch_body<T, kUpdate, 1>(msgs, coeffs, mask, x, y, z, tau,
                                          rho, out, R, J, n, stream);
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
