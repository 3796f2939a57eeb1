// Causal depthwise convolution + SiLU of the Mamba-2 mixer, forward and
// backward, for Hopper.
//
// Replaces no TPU kernel: the JAX package computes the mixer's pre-scan
// convolution as jnp code (src/repro/models/mamba2.py _causal_conv :176,
// then jax.nn.silu :204), which XLA fuses. The port's plain form of the
// same function, F.silu(models.layers.causal_conv(x, w, b)), is about 13
// PyTorch launches a forward and 40 a backward, each a float32 pass over
// (B, S, C); here each direction is one pass (the backward adds a small
// fixed-order reduction of the weights' partial sums).
//
// What it computes, for batch row b, position t and channel c, with taps
// j = 0 .. W-1 (1 <= W <= 4) and x_t = 0 for t < 0, in the accumulation
// type A = promote(T, float32) (float for bf16 and f32, double for f64):
//   conv_t = x_{t-W+1} w_0 + x_{t-W+2} w_1 + ... + x_t w_{W-1}
//   pre_t  = T(conv_t + b)                           (rounded to T)
//   out_t  = T(pre_t / (1 + exp(-pre_t)))            (SiLU in A, rounded)
// Bit for bit the plain form's: the taps in its order, each product and
// each sum rounded on its own as PyTorch's separate kernels round them
// (__fmul_rn / __fadd_rn: no fused multiply-add), the bias last, the
// rounding to T, and SiLU as PyTorch's CUDA kernel writes it.
//
// Backward (causal_conv_silu_bwd_launch), from x, w, b and the output's
// gradient g: pre is recomputed in registers, then
//   dpre_t = T(g_t s (1 + pre_t (1 - s))),  s = 1 / (1 + exp(-pre_t))
// rounded to T where autograd's SiluBackward rounds it, and
//   dx_t = T(sum_j w_j dpre_{t+W-1-j})     (dpre_t = 0 for t >= S)
//   dw_j = T(sum_{b,t} dpre_t x_{t-W+1+j}),  db = T(sum_{b,t} dpre_t).
// dw and db are float (double for f64) partial sums per block in one
// workspace, summed by a second kernel over the blocks in a fixed order:
// no atomics, so every run gives the same bits.
//
// Bound on this card: bytes. The forward reads x once and writes the
// output once, 4 bytes an element in bf16: at the mamba2 and granite
// cells' call (B S = 16,384, C = 4,352) 285 MB, 0.085 ms at 3.35 TB/s.
// The backward reads x and g and writes dx, 6 bytes an element, 0.13 ms.
//
// Design: a thread owns V adjacent channels (16-byte loads in the
// forward, 8-byte in the backward, where it holds more in registers) and
// walks a run of positions, keeping the last W inputs (the backward also
// the last W dpre) in registers, so each input is read once plus a W - 1
// halo a run. Loads go kU positions ahead of the arithmetic. x is read
// through its batch and row strides (the column slice of the
// in-projection's output, with no copy); the outputs are contiguous. A
// block is kCX channel vectors by kTY runs; in the backward it sums its
// runs' partial dw, db in shared memory, in order, and writes one row of
// the workspace. Where a pointer, a stride or C does not allow vectors,
// the same kernels run with V = 1.
//
// C interface (loaded with ctypes): pointers and the stream as void*; each
// entry returns the first CUDA error of its launches (0 when all went).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <initializer_list>

namespace {

constexpr int kMaxWidth = 4;
constexpr int kCX = 32;       // channel vectors a block
constexpr int kTY = 4;        // position runs a block
constexpr int kRun = 16;      // positions a thread walks, forward
constexpr int kBwdRun = 32;   // positions a thread walks, backward
constexpr int kU = 4;         // positions loaded ahead
constexpr int kFwdBytes = 16;
constexpr int kBwdBytes = 8;
constexpr int kReduceThreads = 256;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// The integer type of a vector's bytes: loads and stores move it whole.
template <int N> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T> __device__ __forceinline__ T from_acc(typename Acc<T>::type v);
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_acc<float>(float v) { return v; }
template <> __device__ __forceinline__ double from_acc<double>(double v) { return v; }

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float exp_acc(float v) { return expf(v); }
__device__ __forceinline__ double exp_acc(double v) { return exp(v); }

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_or_zero(const T* __restrict__ p, bool in) {
  using R = typename Raw<sizeof(Vec<T, V>)>::type;
  Vec<T, V> r;
  if (in) {
    const R bits = __ldg(reinterpret_cast<const R*>(p));
    memcpy(&r, &bits, sizeof(r));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r.v[i] = from_acc<T>(0);
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Vec<T, V>& v) {
  using R = typename Raw<sizeof(Vec<T, V>)>::type;
  R bits;
  memcpy(&bits, &v, sizeof(bits));
  *reinterpret_cast<R*>(p) = bits;
}

template <typename T, int V>
__device__ __forceinline__ void widen(const Vec<T, V>& r, typename Acc<T>::type (&out)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_acc(r.v[i]);
}

// The W taps and the bias of V channels, widened to A.
template <typename T, int V, int W>
__device__ __forceinline__ void load_taps(const T* __restrict__ w, const T* __restrict__ b,
                                          int64_t C, int64_t c0,
                                          typename Acc<T>::type (&wr)[W][V],
                                          typename Acc<T>::type (&br)[V]) {
#pragma unroll
  for (int j = 0; j < W; ++j) widen<T, V>(load_or_zero<T, V>(w + j * C + c0, true), wr[j]);
  widen<T, V>(load_or_zero<T, V>(b + c0, true), br);
}

// pre = T(conv + b) of channel i from the window xw (xw[W-1] the current
// position), rounded as the plain form rounds it.
template <typename T, int V, int W>
__device__ __forceinline__ typename Acc<T>::type pre_act(
    const typename Acc<T>::type (&xw)[W][V], const typename Acc<T>::type (&wr)[W][V],
    const typename Acc<T>::type (&br)[V], int i) {
  typename Acc<T>::type acc = mul_rn(xw[0][i], wr[0][i]);
#pragma unroll
  for (int j = 1; j < W; ++j) acc = add_rn(acc, mul_rn(xw[j][i], wr[j][i]));
  return to_acc(from_acc<T>(add_rn(acc, br[i])));
}

template <typename T, int V, int W>
__global__ void __launch_bounds__(kCX * kTY)
causal_conv_silu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ b, T* __restrict__ out, int64_t S, int64_t C,
                        int64_t sxb, int64_t sxs) {
  using A = typename Acc<T>::type;
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kCX + threadIdx.x) * V;
  const int64_t t0 = (static_cast<int64_t>(blockIdx.y) * kTY + threadIdx.y) * kRun;
  if (c0 >= C || t0 >= S) return;
  A wr[W][V], br[V];
  load_taps<T, V, W>(w, b, C, c0, wr, br);
  const T* xp = x + static_cast<int64_t>(blockIdx.z) * sxb + c0;
  T* op = out + static_cast<int64_t>(blockIdx.z) * S * C + c0;
  A xw[W][V];  // x_{t-W+1} .. x_t
#pragma unroll
  for (int j = 0; j < W - 1; ++j) {
    const int64_t t = t0 - (W - 1) + j;
    widen<T, V>(load_or_zero<T, V>(xp + t * sxs, t >= 0), xw[j]);
  }
#pragma unroll 1
  for (int k0 = 0; k0 < kRun; k0 += kU) {
    Vec<T, V> raw[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t t = t0 + k0 + u;
      raw[u] = load_or_zero<T, V>(xp + t * sxs, t < S);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t t = t0 + k0 + u;
      widen<T, V>(raw[u], xw[W - 1]);
      Vec<T, V> o;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const A pre = pre_act<T, V, W>(xw, wr, br, i);
        o.v[i] = from_acc<T>(pre / (A(1) + exp_acc(-pre)));
      }
      if (t < S) store<T, V>(op + t * C, o);
#pragma unroll
      for (int j = 0; j < W - 1; ++j) {
#pragma unroll
        for (int i = 0; i < V; ++i) xw[j][i] = xw[j + 1][i];
      }
    }
  }
}

template <typename T, int V, int W>
__global__ void __launch_bounds__(kCX * kTY)
causal_conv_silu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ b, const T* __restrict__ g,
                            T* __restrict__ dx, typename Acc<T>::type* __restrict__ part,
                            int64_t S, int64_t C, int64_t sxb, int64_t sxs) {
  using A = typename Acc<T>::type;
  __shared__ A red[kTY][W + 1][V][kCX];
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kCX + threadIdx.x) * V;
  const int64_t t0 = (static_cast<int64_t>(blockIdx.y) * kTY + threadIdx.y) * kBwdRun;
  A dwp[W][V], dbp[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    dbp[i] = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) dwp[j][i] = 0;
  }
  if (c0 < C && t0 < S) {
    A wr[W][V], br[V];
    load_taps<T, V, W>(w, b, C, c0, wr, br);
    const T* xp = x + static_cast<int64_t>(blockIdx.z) * sxb + c0;
    const T* gp = g + static_cast<int64_t>(blockIdx.z) * S * C + c0;
    T* dp = dx + static_cast<int64_t>(blockIdx.z) * S * C + c0;
    A xw[W][V];  // x_{p-W+1} .. x_p
    A dq[W][V];  // dpre_{p-W+1} .. dpre_p; 0 before t0 (never read there)
#pragma unroll
    for (int j = 0; j < W; ++j) {
#pragma unroll
      for (int i = 0; i < V; ++i) dq[j][i] = 0;
    }
#pragma unroll
    for (int j = 0; j < W - 1; ++j) {
      const int64_t t = t0 - (W - 1) + j;
      widen<T, V>(load_or_zero<T, V>(xp + t * sxs, t >= 0), xw[j]);
    }
    // Positions p = t0 + k, k < kBwdRun + W - 1: dpre of the run and of
    // the W - 1 after it (the halo dx needs); dx_t at p = t + W - 1.
#pragma unroll 1
    for (int k0 = 0; k0 < kBwdRun + W - 1; k0 += kU) {
      Vec<T, V> rx[kU], rg[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int64_t p = t0 + k0 + u;
        rx[u] = load_or_zero<T, V>(xp + p * sxs, p < S);
        rg[u] = load_or_zero<T, V>(gp + p * C, p < S);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u;
        const int64_t p = t0 + k;
        A gv[V];
        widen<T, V>(rx[u], xw[W - 1]);
        widen<T, V>(rg[u], gv);
        const bool own = k < kBwdRun && p < S;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const A pre = pre_act<T, V, W>(xw, wr, br, i);
          const A s = A(1) / (A(1) + exp_acc(-pre));
          const A d = p < S ? to_acc(from_acc<T>(gv[i] * s * (A(1) + pre * (A(1) - s)))) : A(0);
          dq[W - 1][i] = d;
          if (own) {
            dbp[i] += d;
#pragma unroll
            for (int j = 0; j < W; ++j) dwp[j][i] += d * xw[j][i];
          }
        }
        const int64_t t = p - (W - 1);
        if (k >= W - 1 && k - (W - 1) < kBwdRun && t < S) {
          Vec<T, V> o;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            A acc = wr[0][i] * dq[W - 1][i];
#pragma unroll
            for (int j = 1; j < W; ++j) acc += wr[j][i] * dq[W - 1 - j][i];
            o.v[i] = from_acc<T>(acc);
          }
          store<T, V>(dp + t * C, o);
        }
#pragma unroll
        for (int j = 0; j < W - 1; ++j) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            xw[j][i] = xw[j + 1][i];
            dq[j][i] = dq[j + 1][i];
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int j = 0; j < W; ++j) red[threadIdx.y][j][i][threadIdx.x] = dwp[j][i];
    red[threadIdx.y][W][i][threadIdx.x] = dbp[i];
  }
  __syncthreads();
  if (threadIdx.y != 0 || c0 >= C) return;
  const int64_t row = static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
#pragma unroll
  for (int j = 0; j <= W; ++j) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      A s = red[0][j][i][threadIdx.x];
#pragma unroll
      for (int y = 1; y < kTY; ++y) s += red[y][j][i][threadIdx.x];
      part[(row * (W + 1) + j) * C + c0 + i] = s;
    }
  }
}

// dw (W, C) and db (C,) from the workspace's rows of partial sums
// (rows, W + 1, C): each (j, c) summed over the rows in order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
causal_conv_silu_bwd_reduce_kernel(const typename Acc<T>::type* __restrict__ part,
                                   T* __restrict__ dw, T* __restrict__ db, int64_t rows,
                                   int64_t C, int W) {
  using A = typename Acc<T>::type;
  const int64_t n = (W + 1) * C;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (idx >= n) return;
  A s = 0;
  for (int64_t r = 0; r < rows; ++r) s += part[r * n + idx];
  if (idx < W * C) {
    dw[idx] = from_acc<T>(s);
  } else {
    db[idx - W * C] = from_acc<T>(s);
  }
}

struct Shape {
  int B;
  int64_t S, C, sxb, sxs;
  int W;
};

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Whether V = bytes / sizeof(T) channel vectors fit: every pointer on a
// boundary of ``bytes``, and C and x's strides multiples of V.
template <typename T>
bool vectors_fit(const Shape& sh, int bytes, std::initializer_list<const void*> ptrs) {
  const int64_t v = bytes / static_cast<int64_t>(sizeof(T));
  for (const void* p : ptrs) {
    if (!aligned(p, bytes)) return false;
  }
  return sh.C % v == 0 && sh.sxb % v == 0 && sh.sxs % v == 0;
}

inline dim3 grid_of(const Shape& sh, int V, int run) {
  const int64_t gx = (sh.C / V + kCX - 1) / kCX;
  const int64_t gy = (sh.S + static_cast<int64_t>(kTY) * run - 1) / (static_cast<int64_t>(kTY) * run);
  return dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), static_cast<unsigned>(sh.B));
}

inline bool grid_fits(const Shape& sh, int V, int run) {
  const int64_t gy = (sh.S + static_cast<int64_t>(kTY) * run - 1) / (static_cast<int64_t>(kTY) * run);
  return sh.B >= 1 && sh.B <= 65535 && sh.S >= 1 && sh.C >= 1 && gy <= 65535 &&
         (sh.C / V + kCX - 1) / kCX <= 2147483647LL && sh.W >= 1 && sh.W <= kMaxWidth;
}

template <typename T, int V>
int fwd_v(const Shape& sh, const void* x, const void* w, const void* b, void* out,
          cudaStream_t s) {
  if (!grid_fits(sh, V, kRun)) return cudaErrorInvalidValue;
  const dim3 grid = grid_of(sh, V, kRun), block(kCX, kTY);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                  static_cast<const T*>(b), static_cast<T*>(out), sh.S, sh.C,
                                  sh.sxb, sh.sxs);
  };
  switch (sh.W) {
    case 1: args(causal_conv_silu_kernel<T, V, 1>); break;
    case 2: args(causal_conv_silu_kernel<T, V, 2>); break;
    case 3: args(causal_conv_silu_kernel<T, V, 3>); break;
    default: args(causal_conv_silu_kernel<T, V, 4>); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd(const Shape& sh, const void* x, const void* w, const void* b, void* out,
        cudaStream_t s) {
  constexpr int V = kFwdBytes / static_cast<int>(sizeof(T));
  if (vectors_fit<T>(sh, kFwdBytes, {x, w, b, out})) return fwd_v<T, V>(sh, x, w, b, out, s);
  return fwd_v<T, 1>(sh, x, w, b, out, s);
}

inline int64_t bwd_rows(const Shape& sh) {
  return static_cast<int64_t>(sh.B) *
         ((sh.S + static_cast<int64_t>(kTY) * kBwdRun - 1) / (static_cast<int64_t>(kTY) * kBwdRun));
}

template <typename T, int V>
int bwd_v(const Shape& sh, const void* x, const void* w, const void* b, const void* g,
          void* dx, void* dw, void* db, void* work, cudaStream_t s) {
  using A = typename Acc<T>::type;
  if (!grid_fits(sh, V, kBwdRun)) return cudaErrorInvalidValue;
  const dim3 grid = grid_of(sh, V, kBwdRun), block(kCX, kTY);
  A* part = static_cast<A*>(work);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                  static_cast<const T*>(b), static_cast<const T*>(g),
                                  static_cast<T*>(dx), part, sh.S, sh.C, sh.sxb, sh.sxs);
  };
  switch (sh.W) {
    case 1: args(causal_conv_silu_bwd_kernel<T, V, 1>); break;
    case 2: args(causal_conv_silu_bwd_kernel<T, V, 2>); break;
    case 3: args(causal_conv_silu_bwd_kernel<T, V, 3>); break;
    default: args(causal_conv_silu_bwd_kernel<T, V, 4>); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = (sh.W + 1) * sh.C;
  causal_conv_silu_bwd_reduce_kernel<T>
      <<<static_cast<unsigned>((n + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0, s>>>(
          part, static_cast<T*>(dw), static_cast<T*>(db), bwd_rows(sh), sh.C, sh.W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const Shape& sh, const void* x, const void* w, const void* b, const void* g, void* dx,
        void* dw, void* db, void* work, cudaStream_t s) {
  constexpr int V = kBwdBytes / static_cast<int>(sizeof(T));
  if (V > 1 && vectors_fit<T>(sh, kBwdBytes, {x, w, b, g, dx})) {
    return bwd_v<T, V>(sh, x, w, b, g, dx, dw, db, work, s);
  }
  return bwd_v<T, 1>(sh, x, w, b, g, dx, dw, db, work, s);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64, 2 bfloat16 (x, w, b and the outputs alike).
// x (B, S, C) with channel stride 1, batch stride sxb and row stride sxs
// (elements); w (W, C) and b (C,) contiguous; out (B, S, C) contiguous.
int causal_conv_silu_launch(int dtype, const void* x, const void* w, const void* b, void* out,
                            int B, int64_t S, int64_t C, int W, int64_t sxb, int64_t sxs,
                            void* stream) {
  const Shape sh{B, S, C, sxb, sxs, W};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return fwd<float>(sh, x, w, b, out, s);
    case 1: return fwd<double>(sh, x, w, b, out, s);
    case 2: return fwd<__nv_bfloat16>(sh, x, w, b, out, s);
    default: return cudaErrorInvalidValue;
  }
}

// Bytes of the backward's workspace: rows x (W + 1) x C partial sums of
// the accumulation type.
int64_t causal_conv_silu_bwd_workspace_bytes(int dtype, int B, int64_t S, int64_t C, int W) {
  const Shape sh{B, S, C, 0, 0, W};
  const int64_t acc = dtype == 1 ? 8 : 4;
  return bwd_rows(sh) * (W + 1) * C * acc;
}

// The gradient of causal_conv_silu_launch's function: dx (B, S, C)
// contiguous, dw (W, C), db (C,), from x, w, b as there and g (B, S, C)
// contiguous; work: causal_conv_silu_bwd_workspace_bytes, any contents.
int causal_conv_silu_bwd_launch(int dtype, const void* x, const void* w, const void* b,
                                const void* g, void* dx, void* dw, void* db, void* work, int B,
                                int64_t S, int64_t C, int W, int64_t sxb, int64_t sxs,
                                void* stream) {
  const Shape sh{B, S, C, sxb, sxs, W};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return bwd<float>(sh, x, w, b, g, dx, dw, db, work, s);
    case 1: return bwd<double>(sh, x, w, b, g, dx, dw, db, work, s);
    case 2: return bwd<__nv_bfloat16>(sh, x, w, b, g, dx, dw, db, work, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* causal_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
