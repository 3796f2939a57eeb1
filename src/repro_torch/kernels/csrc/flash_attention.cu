// Flash attention (online softmax): causal, sliding window, GQA, for Hopper.
//
// Replaces the TPU Pallas kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_kernel (:98, body _body :33) -> flash_attention_launch
//
// What it computes, for every batch b, query head h and query row i, with
// qpos = i + q_offset and kv head g = h * KV / H (GQA: the K/V heads are
// read in place, never expanded to H):
//   s_j   = (q_i . k_j) / sqrt(hd)   where the key j is live, else -1e30;
//           live = j < Skv, (!causal or j <= qpos), (!window or j > qpos - window)
//   out_i = sum_j softmax(s)_j v_j, returned in q's dtype.
// Scores, the running max m, the running denominator l and the output
// accumulator are float32 whatever the input dtype; the output is
// acc / max(l, 1e-30). A row with no live key is outside the contract
// (the reference's oracle and its Pallas kernel disagree there).
//
// Layout: the model's own, q (B, Sq, H, hd), k/v (B, Skv, KV, hd), out
// (B, Sq, H, hd), all contiguous, so the caller transposes nothing.
//
// Bound on this card: operations. The band needs 4 * hd flops per live
// (query, key) pair: at the qwen3-0.6b prefill step (B 4, S 2048, H 16,
// hd 128, causal) about 69 GFLOP against about 100 MB of q/k/v/out, far
// above the H100's flop:byte balance. This first kernel runs on the CUDA
// cores in float32 (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s
// bf16): wgmma/TMA are later work.
//
// Design: one block of 256 threads per (b, h, 64-row query tile). The
// query tile (pre-scaled, float32) stays in shared memory; 64-row key and
// value tiles stream through one shared buffer, converted to float32 on
// the way in. Only the key tiles that meet the causal/window band of the
// query tile are visited; the band's edge is masked per element. Thread
// (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i (i < 4): for
// the scores, key columns tx + 16 j (j < 4), reading q and k four floats
// at a time; for the output, columns 4 tx + 64 c. A row's 64 scores live
// in one half-warp, so its max and sum are shuffle reductions; the
// probabilities pass through shared memory to the P.V product. The ragged
// edges of Sq and Skv are masked here, so callers never pad.
//
// C interface (loaded with ctypes): pointers and the stream as void*, and
// the entry returns cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per streamed tile
constexpr int kThreads = 256;
constexpr int kPad = 4;       // row padding (floats): keeps float4 loads
                              // aligned and conflict-free
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile copies kBQ rows for both tiles");

enum DType : int { kF32 = 0, kBF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int HD>
constexpr size_t smem_bytes() {
  // query tile + one key/value tile + probabilities, all float32
  return sizeof(float) *
         (2 * kBQ * (HD + kPad) + kBQ * (kBK + kPad));
}

// Copy rows [row0, row0 + 64) of a slab whose rows lie `row_stride`
// elements apart into a padded float32 tile, scaled; rows past `n_rows`
// become zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t row0, int64_t n_rows,
                                          int64_t row_stride, float scale) {
  for (int e = threadIdx.x; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int64_t row = row0 + r;
    float v = 0.f;
    if (row < n_rows) v = to_f32(src[row * row_stride + d]) * scale;
    dst[r * (HD + kPad) + d] = v;
  }
}

// Two blocks an SM fit the shared memory up to hd 128; hd 256 takes one.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int B,
                       int H, int KV, int64_t Sq, int64_t Skv, int causal,
                       int64_t window, int64_t q_offset, float sm_scale) {
  constexpr int kLd = HD + kPad;
  constexpr int kNC = HD / 64;  // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + kBQ * kLd;
  float* Ps = KVs + kBK * kLd;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t q_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = static_cast<int>(static_cast<int64_t>(h) * KV / H);

  const int64_t q_row0 = q_tile * kBQ;
  const T* q_base = q + (static_cast<int64_t>(b) * Sq * H + h) * HD;
  const T* k_base = k + (static_cast<int64_t>(b) * Skv * KV + g) * HD;
  const T* v_base = v + (static_cast<int64_t>(b) * Skv * KV + g) * HD;

  // Keys that meet the band of this query tile.
  const int64_t q_lo = q_row0 + q_offset;
  const int64_t q_last = (q_row0 + kBQ < Sq ? q_row0 + kBQ : Sq) - 1;
  const int64_t q_hi = q_last + q_offset;
  int64_t k_min = 0, k_max = Skv - 1;
  if (causal && q_hi < k_max) k_max = q_hi;
  if (window > 0 && q_lo - window + 1 > k_min) k_min = q_lo - window + 1;

  load_tile<T, HD>(Qs, q_base, q_row0, Sq, static_cast<int64_t>(H) * HD,
                   sm_scale);

  float m[4], l[4], acc[4][kNC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  const int64_t t_first = k_min / kBK;
  const int64_t t_last = k_max >= k_min ? k_max / kBK : t_first - 1;
  for (int64_t t = t_first; t <= t_last; ++t) {
    const int64_t k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done with KVs, Ps
    load_tile<T, HD>(KVs, k_base, k0, Skv, static_cast<int64_t>(KV) * HD, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * kLd + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * kLd + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // Mask, then the online-softmax update of each of this thread's rows.
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q_row0 + ty + 16 * i + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = k0 + tx + 16 * j;
        bool live = kpos < Skv;
        if (causal) live = live && kpos <= qpos;
        if (window > 0) live = live && kpos > qpos - window;
        if (!live) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * (kBK + kPad) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }

    __syncthreads();  // Ps written, every read of the key tile done
    load_tile<T, HD>(KVs, v_base, k0, Skv, static_cast<int64_t>(KV) * HD, 1.f);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha[i];
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            &Ps[(ty + 16 * i) * (kBK + kPad) + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &KVs[(j + jj) * kLd + 4 * tx + 64 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0   ? p4[i].x
                            : jj == 1 ? p4[i].y
                            : jj == 2 ? p4[i].z
                                      : p4[i].w;
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q_row0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<int64_t>(b) * Sq + row) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(o + 4 * tx + 64 * c + e, acc[i][c][e] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int64_t Sq, int64_t Skv, int causal, int64_t window,
           int64_t q_offset, void* stream) {
  constexpr size_t kSmem = smem_bytes<HD>();
  // Above 48 KB of dynamic shared memory needs an opt-in (per device, so
  // it is set on every launch rather than once per process).
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t n_tiles = (Sq + kBQ - 1) / kBQ;
  if (n_tiles > 2147483647 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n_tiles), H, B);
  const float sm_scale = 1.f / sqrtf(static_cast<float>(HD));
  flash_attention_kernel<T, HD><<<grid, kThreads, kSmem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), B, H, KV, Sq, Skv,
      causal, window, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int B, int H, int KV, int64_t Sq, int64_t Skv,
                int causal, int64_t window, int64_t q_offset, void* stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, KV, Sq, Skv, causal, window,
                           q_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, KV, Sq, Skv, causal, window,
                            q_offset, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, H, KV, Sq, Skv, causal, window,
                            q_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (B, Sq, H, hd) in q's dtype. window <= 0 means no window.
int flash_attention_launch(int dtype, int hd, const void* q, const void* k,
                           const void* v, void* out, int B, int H, int KV,
                           int64_t Sq, int64_t Skv, int causal,
                           int64_t window, int64_t q_offset, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return dispatch_hd<float>(hd, q, k, v, out, B, H, KV, Sq, Skv, causal,
                                window, q_offset, stream);
    case kBF16:
      return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, H, KV, Sq, Skv,
                                        causal, window, q_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
