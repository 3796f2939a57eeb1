// Flash attention (online softmax): causal, sliding window, GQA, for Hopper.
//
// Replaces the TPU Pallas kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_kernel (:98, pl.pallas_call :130, body _body :33)
//     -> flash_attention_launch
//
// What it computes, for every batch b, query head h and query row i, with
// qpos = i + q_offset and kv head g = h * KV / H (GQA: the K/V heads are
// read in place, never expanded to H):
//   s_j   = (q_i . k_j) / sqrt(hd)   where the key j is live, else masked;
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
// above the H100's flop:byte balance, so the tensor cores' 989 TFLOP/s
// (bf16) set the bound: 0.07 ms.
//
// Two bodies, chosen by dtype alone (no fallback from one to the other):
//
// * bfloat16 -> flash_attention_tc_kernel, on the tensor cores (hd 64,
//   128, 256). The first design ran both products as float32
//   FMAs on the CUDA cores (67 TFLOP/s peak), converted every K/V element
//   to float32 on a synchronous load into one buffer shared by K and V
//   (four __syncthreads() per key tile, no load overlapping any math),
//   passed the probabilities through shared memory and pre-scaled q in
//   float32: 23 TFLOP/s, 20x slower than SDPA at the qwen3 step. This one:
//   - one CTA per (b, h, 128-query tile); the CTAs of
//     the late (heavy, under causal masking) query tiles launch first;
//   - two warpgroups of 64 query rows each and no producer warp: ptxas
//     (CUDA 12.9) sizes a wgmma kernel's registers for whole warpgroups and
//     held a CTA with a producer (384 or 288 threads) to 168 registers a
//     thread whatever setmaxnreg asked, which spilled the pipelined
//     consumers (O, S and two sets of P: about 200 at hd 128). At 256
//     threads each may take 255. The consumers issue the loads: thread 0
//     loads q and fills the ring, and whichever warpgroup is done with a
//     stage second refills it (a per-stage count of releases, odd =
//     second), so neither waits for the other;
//   - q (once) and K/V tiles (128 keys; 64 at hd 256) arrive by TMA from
//     4-d tensor maps (hd, heads, S, B) with 128-byte swizzle, into a
//     ring of three stages (two at hd 256, for shared memory) whose
//     arrival is awaited on mbarriers; keys past Skv (and
//     query rows past Sq) are zero-filled by the hardware, never read
//     from the next batch;
//   - S = Q K^T by wgmma (bf16 in, f32 accumulate) from shared memory,
//     both operands K-major as they lie, one m64n128k16 a k-step for
//     128-key tiles (two n64 products would read A from shared memory
//     twice: at N = 64 the reads alone take the SM's shared-memory rate);
//     1/sqrt(hd) (with log2 e, for ex2) is applied to the f32 scores in
//     the FMA that feeds ex2, never to q before rounding;
//   - the mask is applied only on key tiles that cross the band's or the
//     ragged edge; interior tiles skip the compares;
//   - the online softmax stays in registers: a row lives in the four
//     lanes of a quad of wgmma's accumulator layout, so its max is two
//     shuffles and its sum is reduced once, at the end;
//   - O += P V by wgmma (m64n128k16 a key slice per 128 columns of O)
//     with P rounded to bf16 in registers as the A operand (the
//     accumulator layout maps onto it) and V read from shared memory
//     N-major with the transpose bit, never transposed in memory. Rounding P to bf16 costs about 2e-3 normwise, within the
//     2e-2 bf16 tolerance;
//   - each consumer pipelines across key tiles, as FA3 does: it issues
//     S = Q K^T of tile i and O += P V of tile i - 1 together, and runs
//     the softmax of tile i on the CUDA cores while the P V product runs
//     on the tensor cores (P of tiles i - 1 and i in two register sets);
//     the two consumer warpgroups interleave on their own;
//   - the epilogue divides by l and stores bf16 pairs of the valid rows.
// * float32 -> flash_attention_kernel, the first design's CUDA-core body,
//   unchanged: it beats SDPA in float32 (2.9 against 6.5 ms at the qwen3
//   step), and the tensor cores would need TF32, which cannot meet the
//   float32 tolerance of 1e-5. One block of 256 threads per (b, h, 64-row
//   query tile); the query tile (pre-scaled, float32) stays in shared
//   memory; 64-row key and value tiles stream through one shared buffer,
//   converted to float32 on the way in. Thread (ty, tx) = (tid / 16,
//   tid % 16) owns query rows ty + 16 i (i < 4): for the scores, key
//   columns tx + 16 j (j < 4); for the output, columns 4 tx + 64 c. A
//   row's 64 scores live in one half-warp, so its max and sum are shuffle
//   reductions; the probabilities pass through shared memory to the P.V
//   product.
//
// Both bodies visit only the key tiles that meet the causal/window band
// of the query tile, and mask the ragged edges of Sq and Skv themselves,
// so callers never pad.
//
// C interface (loaded with ctypes): pointers and the stream as void*, and
// the entry returns cudaGetLastError() right after the launch (or an
// error code of its own when a tensor map cannot be encoded). The tensor
// maps are encoded per call on the host by cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library does not link
// libcuda.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int B, int H, int KV,
                       int64_t Sq, int64_t Skv, int causal, int64_t window,
                       int64_t q_offset, float sm_scale) {
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
    // The row's log-sum-exp of the scaled scores (q was pre-scaled), for
    // the backward pass; the 16 threads of the row hold the same m and l.
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + row] = m[i] + logf(l[i]);
    T* o = out + ((static_cast<int64_t>(b) * Sq + row) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(o + 4 * tx + 64 * c + e, acc[i][c][e] * inv);
  }
}

// ---- bfloat16: the tensor-core body ---------------------------------------

namespace tc {

constexpr int kBQ = 128;           // query rows per CTA
constexpr int kThreads = 256;      // two warpgroups of 64 query rows each
constexpr int kBoxCols = 64;       // bf16 columns per TMA box: 128 bytes
constexpr int kRowBytes = 128;     // one box row, one swizzle row
constexpr int kAtomBytes = 1024;   // 8 rows x 128 bytes: one swizzle atom

template <int HD>
struct Cfg {
  static constexpr int kBK = HD <= 128 ? 128 : 64;  // keys per tile
  static constexpr int kStages = HD <= 128 ? 3 : 2;  // K/V ring depth
  static constexpr int kChunks = HD / kBoxCols;     // boxes across hd
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kTileBytes = kBK * HD * 2;   // one K (or V) tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // + kAtomBytes: slack to align the ring on a swizzle atom
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + kAtomBytes;
  static_assert(kSmem + 64 <= 232448, "shared memory of one CTA (+ barriers)");
};

// Row-major bf16 pair (low half = lower column), the A-fragment packing.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ int clamp_i32(int64_t v) {
  return static_cast<int>(v < -(1LL << 30) ? -(1LL << 30)
                          : v > (1LL << 30) ? (1LL << 30) : v);
}

// Grid: one CTA per (query tile, b, h), 1-d, the last query tiles first.
// Shared memory: Q as kChunks boxes of [128 rows][64 cols], then per stage
// K and V as kChunks boxes of [kBK rows][64 cols] each, every box 128-byte
// swizzled by TMA and starting on a 1024-byte boundary.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int B, int H, int KV,
                          int64_t Sq, int64_t Skv, int causal,
                          int64_t window, int64_t q_offset, int n_qtiles,
                          float scale_log2) {
  using C = Cfg<HD>;
  constexpr int kBK = C::kBK;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, bar_full[kStages];
  __shared__ unsigned released[kStages];  // warpgroups done with a stage, ever

  const uint32_t raw = sm90::smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((kAtomBytes - raw % kAtomBytes) % kAtomBytes);
  uint8_t* Qs = base;
  uint8_t* ring = base + C::kQBytes;

  const int bh = blockIdx.x % (B * H);
  const int q_tile = n_qtiles - 1 - blockIdx.x / (B * H);
  const int h = bh % H, b = bh / H;
  const int g = static_cast<int>(static_cast<int64_t>(h) * KV / H);
  const int64_t q_row0 = static_cast<int64_t>(q_tile) * kBQ;

  // Key tiles that meet the band of this query tile (its valid rows).
  const int64_t q_lo = q_row0 + q_offset;
  const int64_t q_hi = (q_row0 + kBQ < Sq ? q_row0 + kBQ : Sq) - 1 + q_offset;
  int64_t k_min = 0, k_max = Skv - 1;
  if (causal && q_hi < k_max) k_max = q_hi;
  if (window > 0 && q_lo - window + 1 > k_min) k_min = q_lo - window + 1;
  const int t_first = static_cast<int>(k_min / kBK);
  const int t_last = k_max >= k_min ? static_cast<int>(k_max / kBK) : t_first - 1;

  const int n_tiles = t_last - t_first + 1;
  // Loads tile i (key tile t_first + i) into stage i % kStages by TMA.
  auto load_tile = [&](int i) {
    const int s = i % kStages;
    uint8_t* Ks = ring + s * C::kStageBytes;
    uint8_t* Vs = Ks + C::kTileBytes;
    const int row = (t_first + i) * kBK;
    sm90::mbar_arrive_expect_tx(&bar_full[s], C::kStageBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      sm90::tma_load_4d(Ks + c * kBK * kRowBytes, &tk, &bar_full[s],
                        c * kBoxCols, g, row, b);
      sm90::tma_load_4d(Vs + c * kBK * kRowBytes, &tv, &bar_full[s],
                        c * kBoxCols, g, row, b);
    }
  };
  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&bar_full[s], 1);
      released[s] = 0;
    }
    sm90::fence_barrier_init();
    // Q, and the first tiles into the empty ring.
    sm90::mbar_arrive_expect_tx(&bar_q, C::kQBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      sm90::tma_load_4d(Qs + c * kBQ * kRowBytes, &tq, &bar_q, c * kBoxCols,
                        h, static_cast<int>(q_row0), b);
    for (int i = 0; i < kStages && i < n_tiles; ++i) load_tile(i);
  }
  __syncthreads();

  // ---- warpgroup cw owns query rows 64 cw .. 64 cw + 63 -----------------
  const int cw = threadIdx.x / 128;
  // The stage of tile i_prev is free once both warpgroups are past their
  // P V product on it: whichever gets there second refills it with tile
  // i_prev + kStages, so neither waits for the other.
  auto release = [&](int i_prev) {
    sm90::named_barrier_sync(1 + cw, 128);  // every warp of this warpgroup
    if (threadIdx.x % 128 == 0 &&
        (atomicAdd(&released[i_prev % kStages], 1u) & 1u) &&
        i_prev + kStages < n_tiles)
      load_tile(i_prev + kStages);
  };
  const int lane = threadIdx.x % 32;
  const int r0 = 64 * cw + 16 * ((threadIdx.x / 32) % 4) + lane / 4;  // and r0 + 8
  const int c0 = 2 * (lane % 4);  // first of this thread's column pairs

  // O in pieces of kON columns, one P V wgmma each per key slice; o[p][i]
  // is row r0 + 8 ((i / 2) % 2), column kON p + 8 (i / 4) + c0 + i % 2.
  constexpr int kON = HD < 128 ? HD : 128;
  float o[HD / kON][kON / 2];
#pragma unroll
  for (int p = 0; p < HD / kON; ++p)
#pragma unroll
    for (int i = 0; i < kON / 2; ++i) o[p][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const uint32_t q_addr = sm90::smem_u32(Qs) + 64 * cw * kRowBytes;
  const uint32_t ring_addr = sm90::smem_u32(ring);
  const int64_t qpos0 = q_row0 + q_offset + r0;  // row r0; r0 + 8 adds 8
  const int win = window > 0 ? clamp_i32(window) : 0;

  // S = Q K^T of the tile in stage s: hd / 16 steps of k16, each one wgmma
  // over all kBK keys (issued, not waited for). sc[i] is row r0 + 8 ((i / 2)
  // % 2), key column 8 (i / 4) + c0 + i % 2 of the tile.
  float sc[kBK / 2];
  // Descriptors: one per operand base, advanced by compile-time offsets
  // (in 16-byte units, the address field's own).
  const uint64_t q_desc = sm90::desc_b128(q_addr, 16, kAtomBytes);
  auto issue_qk = [&](int s) {
    const uint64_t k_desc =
        sm90::desc_b128(ring_addr + s * C::kStageBytes, 16, kAtomBytes);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk % 4) * 32;  // bytes into the 128-byte row
      const uint64_t da = q_desc + (((kk / 4) * kBQ * kRowBytes + off) >> 4);
      const uint64_t db = k_desc + (((kk / 4) * kBK * kRowBytes + off) >> 4);
      if constexpr (kBK == 128)
        sm90::wgmma_m64n128k16_ss(sc, da, db, kk > 0);
      else
        sm90::wgmma_m64n64k16_ss(sc, da, db, kk > 0);
    }
  };
  // O += P V of the tile in stage s, P from registers (issued, not waited).
  auto issue_pv = [&](int s, const uint32_t (&pa)[kBK / 16][4]) {
    // V is N-major: SBO is the stride between 8-key groups (one atom; 16
    // keys = two atoms down the tile) and LBO the stride between 64-column
    // atoms (one TMA box; a piece of 128 columns spans two). The other
    // reading of the two fields faults on the card.
    const uint64_t v_desc = sm90::desc_b128(
        ring_addr + s * C::kStageBytes + C::kTileBytes, kBK * kRowBytes,
        kAtomBytes);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < HD / kON; ++p) {
        const uint64_t db = v_desc + (((kON / 64) * p * kBK * kRowBytes +
                                       kk * 16 * kRowBytes) >> 4);
        if constexpr (kON == 128)
          sm90::wgmma_m64n128k16_rs_tb(o[p], pa[kk], db);
        else
          sm90::wgmma_m64n64k16_rs_tb(o[p], pa[kk], db);
      }
  };
  // The online softmax of the scores in sc (key tile t), in the log2
  // domain: masked only where the tile crosses an edge; m (scaled) and l
  // advance; alpha rescales what O held; P = 2^(s scale - m) in one FMA and
  // one ex2, rounded to bf16 as wgmma's A fragments, key slice by key
  // slice (l sums the unrounded p, each thread over its own columns).
  auto softmax = [&](int t, uint32_t (&pa)[kBK / 16][4], float (&alpha)[2]) {
    const int64_t k0 = static_cast<int64_t>(t) * kBK;
    const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > q_lo) ||
                      (win > 0 && k0 <= q_hi - win);
    if (edge) {
      const int d0 = clamp_i32(qpos0 - k0);     // qpos - kpos at (r0, col 0)
      const int kv_left = clamp_i32(Skv - k0);  // live columns: col < kv_left
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        const int col = 8 * (e / 4) + c0 + (e % 2);
        const int d = d0 + 8 * ((e / 2) % 2) - col;
        const bool live = col < kv_left && (!causal || d >= 0) &&
                          (win == 0 || d < win);
        if (!live) sc[e] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e)
      mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], sc[e]);
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing live yet
      alpha[r] = sm90::exp2_ftz(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 8 * kk + 2 * j;  // pair (e, e + 1): keys 16 kk + ...
        const int r = j % 2;
        const float p0 = sm90::exp2_ftz(fmaf(sc[e], scale_log2, -mu[r]));
        const float p1 = sm90::exp2_ftz(fmaf(sc[e + 1], scale_log2, -mu[r]));
        l[r] += p0 + p1;
        pa[kk][j] = pack_bf16(p0, p1);
      }
  };
  // Compiler fences on the registers a wgmma reads or writes (no code):
  // only around the waits and issues of the wgmmas that use them.
  auto fence_s = [&] { sm90::fence_regs(sc); };
  auto fence_pv = [&](uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
    for (int p = 0; p < HD / kON; ++p) sm90::fence_regs(o[p]);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) sm90::fence_regs(pa[kk]);
  };

  // Software pipeline across key tiles: while the softmax of tile i runs
  // on the CUDA cores, O += P V of tile i - 1 runs on the tensor cores.
  uint32_t pa[kBK / 16][4], pn[kBK / 16][4];  // P of tile i - 1 and of tile i
  float alpha[2];
  sm90::mbar_wait(&bar_q, 0);
  if (n_tiles > 0) {
    sm90::mbar_wait(&bar_full[0], 0);
    fence_s();
    sm90::wgmma_fence();
    issue_qk(0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_s();
    softmax(t_first, pa, alpha);  // O is still zero: alpha is moot
  }
  for (int i = 1; i < n_tiles; ++i) {
    const int s = i % kStages, s_prev = (i - 1) % kStages;
    sm90::mbar_wait(&bar_full[s], (i / kStages) & 1);
    fence_s();
    fence_pv(pa);
    sm90::wgmma_fence();
    issue_qk(s);
    sm90::wgmma_commit();
    issue_pv(s_prev, pa);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // S of tile i is in; P V of tile i - 1 runs on
    fence_s();
    softmax(t_first + i, pn, alpha);
    sm90::wgmma_wait<0>();
    fence_pv(pa);
    release(i - 1);  // K and V of tile i - 1 are done with
#pragma unroll
    for (int p = 0; p < HD / kON; ++p)
#pragma unroll
      for (int e = 0; e < kON / 2; ++e) o[p][e] *= alpha[(e / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pn[kk][j];
  }
  if (n_tiles > 0) {
    const int s_last = (n_tiles - 1) % kStages;
    fence_pv(pa);
    sm90::wgmma_fence();
    issue_pv(s_last, pa);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_pv(pa);
  }

  // Epilogue: out = O / max(l, 1e-30) in bf16, valid rows only.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = q_row0 + r0 + 8 * r;
    const float l_row = quad_sum(l[r]);
    const float inv = 1.f / fmaxf(l_row, 1e-30f);
    if (row >= Sq) continue;
    // The row's log-sum-exp in natural units: m is the scaled (log2) max.
    if (lse != nullptr && lane % 4 == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + row] =
          (m[r] + log2f(l_row)) * 0.6931471805599453f;
    __nv_bfloat16* o_row =
        out + ((static_cast<int64_t>(b) * Sq + row) * H + h) * HD;
#pragma unroll
    for (int p = 0; p < HD / kON; ++p)
#pragma unroll
      for (int e = 2 * r; e < kON / 2; e += 4) {  // pairs (e, e + 1) of row r
        const int col = kON * p + 8 * (e / 4) + c0;
        *reinterpret_cast<uint32_t*>(o_row + col) =
            pack_bf16(o[p][e] * inv, o[p][e + 1] * inv);
      }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that nothing links
// libcuda; the driver's own signature.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (B, S, heads, hd) tensor as the 4-d map (hd, heads, S, B) with
// boxes of 64 columns x `rows` rows of one head, 128-byte swizzled; rows
// past S read as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int hd, int heads,
                int64_t S, int B, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(heads) * hd * 2,
                                 static_cast<cuuint64_t>(S) * heads * hd * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc


// ---- backward: the CUDA-core body -----------------------------------------
//
// The gradient of the attention above for query positions from 0 (training
// never offsets them), from the forward's output O and its rows'
// log-sum-exp L (the forward writes L when asked):
//   D_i  = rowsum(dO_i o O_i)                      (prep kernel)
//   P    = exp(S - L) inside the band, 0 outside, S = Q K^T / sqrt(hd)
//   dV  += P^T dO,   dS = P o (dO V^T - D),   dK += dS^T Q / sqrt(hd)
//   dQ  += dS K / sqrt(hd)                         (main kernel)
// then dQ, dK, dV cast to the input type (finish kernel). Everything is
// float32 on the CUDA cores, for both input types: a simple body first;
// the tensor cores are later work (ROADMAP Queue 2).
//
// Bound on this card: operations, 10 hd flops per live (query, key) pair
// (five products; 2.5 times the forward's): at the qwen3-0.6b training
// step (B 4, S 2048, H 16, hd 128, causal) about 172 GFLOP, 0.17 ms at the
// bf16 tensor-core peak, 2.6 ms at the float32 CUDA-core peak.
//
// Design:
// - one block of 256 threads per (key tile of kBK keys, kv head g, batch
//   b, head split): K and V of the tile stay in shared memory (float32)
//   while the block walks the query tiles of kBQ rows that meet the
//   tile's causal/window band, for each query head that reads g (all
//   q_per_kv of them, or 1/split of them: MQA leaves one kv head, and
//   recurrentgemma's B 1 x 128 key tiles would not fill 132 SMs, so the
//   wrapper splits the heads until the grid does);
// - dK and dV accumulate in registers over every query row the block
//   visits and are written once, as float32 partials per head split,
//   which the finish kernel sums;
// - dQ of a (query tile, key tile) pair is added by float32 atomics into
//   a zeroed float32 buffer: one pass over the band. The other choice, a
//   second pass per query tile, would recompute S, P and dP (three of the
//   five products) to save the atomics, which cost 4 bytes a dQ element
//   per visiting key tile in L2 and leave dQ's summation order to the
//   hardware (run-to-run differences at float32 round-off);
// - a thread (tm, tn) = (tid / 16, tid % 16) owns query rows tm + 16 i and
//   key columns tn + 16 j of S, dP; keys tm + 16 i and columns tn + 16 j of
//   dK, dV; rows tm + 16 i and columns tn + 16 j of dQ. Shared rows are
//   padded to an odd length, so the column-strided reads hit 16 banks;
// - tiles: 64 keys x 64 query rows for hd <= 128, 32 x 32 at hd 256 (K, V,
//   Q, dO, P, dS and the rows' L and D in float32: 166 KB at hd 128,
//   140 KB at hd 256; one block an SM);
// - the key tiles nearest the start (the longest bands under causal
//   masking) launch first.

namespace bwd {

constexpr int kThreads = 256;

template <int HD>
struct Cfg {
  static constexpr int kBQ = HD <= 128 ? 64 : 32;  // query rows a step
  static constexpr int kBK = HD <= 128 ? 64 : 32;  // keys a block
  static constexpr int kLd = HD + 1;               // odd row pitch (floats)
  static constexpr int kLdp = kBK + 1;
  static constexpr int kSM = kBQ / 16, kSN = kBK / 16;  // S, dP per thread
  static constexpr int kKM = kBK / 16, kKN = HD / 16;   // dK, dV per thread
  static constexpr int kQM = kBQ / 16, kQN = HD / 16;   // dQ per thread
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kBK * kLd + 2 * kBQ * kLd + 2 * kBQ * kLdp + 2 * kBQ);
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// Rows [row0, row0 + ROWS) of a slab whose rows lie `stride` elements
// apart, as float32 into a tile of pitch `ld`; rows past `n_rows` are 0.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* __restrict__ src,
                                          int64_t row0, int64_t n_rows,
                                          int64_t stride) {
  for (int e = threadIdx.x; e < ROWS * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int64_t row = row0 + r;
    dst[r * ld + d] = row < n_rows ? to_f32(src[row * stride + d]) : 0.f;
  }
}

// D (B, H, Sq) = rowsum(dO o O) in float32, and dq_acc zeroed; one warp a
// (b, i, h) row, rows in memory order.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_attention_bwd_prep_kernel(const T* __restrict__ out,
                                const T* __restrict__ dout,
                                float* __restrict__ delta,
                                float* __restrict__ dq_acc, int B, int H,
                                int64_t Sq) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(B) * Sq * H) return;
  float acc = 0.f;
  for (int c = lane; c < HD; c += 32) {
    acc = fmaf(to_f32(out[row * HD + c]), to_f32(dout[row * HD + c]), acc);
    dq_acc[row * HD + c] = 0.f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const int64_t bi = row / H;
    delta[(bi / Sq * H + h) * Sq + bi % Sq] = acc;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq_acc,
                           float* __restrict__ dk_part,
                           float* __restrict__ dv_part, int B, int H, int KV,
                           int64_t Sq, int64_t Skv, int causal,
                           int64_t window, int split, float scale) {
  using C = Cfg<HD>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kLd = C::kLd, kLdp = C::kLdp;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBK * kLd;
  float* Qs = Vs + kBK * kLd;
  float* dOs = Qs + kBQ * kLd;
  float* Ps = dOs + kBQ * kLd;
  float* dSs = Ps + kBQ * kLdp;
  float* Ls = dSs + kBQ * kLdp;
  float* Ds = Ls + kBQ;

  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  // Block -> (key tile, head split, b, g), key tiles slowest.
  const int per_tile = split * B * KV;
  const int64_t kt = blockIdx.x / per_tile;
  int rem = static_cast<int>(blockIdx.x % per_tile);
  const int g = rem % KV;
  rem /= KV;
  const int b = rem % B;
  const int hs = rem / B;
  const int qpk = H / KV, hper = qpk / split;
  const int64_t k0 = kt * kBK;
  const int64_t k_last = (k0 + kBK < Skv ? k0 + kBK : Skv) - 1;

  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const int64_t kv_off = (static_cast<int64_t>(b) * Skv * KV + g) * HD;
  load_rows<T, HD, kBK>(Ks, kLd, k + kv_off, k0, Skv, kv_stride);
  load_rows<T, HD, kBK>(Vs, kLd, v + kv_off, k0, Skv, kv_stride);

  // Query rows that meet the band of this key tile.
  int64_t q_min = 0, q_max = Sq - 1;
  if (causal) q_min = k0;
  if (window > 0 && k_last + window - 1 < q_max) q_max = k_last + window - 1;

  float dk[C::kKM][C::kKN], dv[C::kKM][C::kKN];
#pragma unroll
  for (int i = 0; i < C::kKM; ++i)
#pragma unroll
    for (int j = 0; j < C::kKN; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  for (int hh = 0; hh < hper; ++hh) {
    const int h = g * qpk + hs * hper + hh;
    const int64_t q_off = (static_cast<int64_t>(b) * Sq * H + h) * HD;
    const float* lse_h = lse + (static_cast<int64_t>(b) * H + h) * Sq;
    const float* delta_h = delta + (static_cast<int64_t>(b) * H + h) * Sq;
    for (int64_t q0 = (q_min / kBQ) * kBQ; q0 <= q_max; q0 += kBQ) {
      __syncthreads();  // the last step's readers are done with the tiles
      load_rows<T, HD, kBQ>(Qs, kLd, q + q_off, q0, Sq, q_stride);
      load_rows<T, HD, kBQ>(dOs, kLd, dout + q_off, q0, Sq, q_stride);
      for (int r = tid; r < kBQ; r += kThreads) {
        const bool in = q0 + r < Sq;
        Ls[r] = in ? lse_h[q0 + r] : 0.f;
        Ds[r] = in ? delta_h[q0 + r] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T: rows tm + 16 i, keys tn + 16 j.
      float sc[C::kSM][C::kSN], dp[C::kSM][C::kSN];
#pragma unroll
      for (int i = 0; i < C::kSM; ++i)
#pragma unroll
        for (int j = 0; j < C::kSN; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qa[C::kSM], oa[C::kSM], kb[C::kSN], vb[C::kSN];
#pragma unroll
        for (int i = 0; i < C::kSM; ++i) {
          qa[i] = Qs[(tm + 16 * i) * kLd + d];
          oa[i] = dOs[(tm + 16 * i) * kLd + d];
        }
#pragma unroll
        for (int j = 0; j < C::kSN; ++j) {
          kb[j] = Ks[(tn + 16 * j) * kLd + d];
          vb[j] = Vs[(tn + 16 * j) * kLd + d];
        }
#pragma unroll
        for (int i = 0; i < C::kSM; ++i)
#pragma unroll
          for (int j = 0; j < C::kSN; ++j) {
            sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
            dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
          }
      }
      // P = exp(S scale - L) on the band, dS = P (dP - D).
#pragma unroll
      for (int i = 0; i < C::kSM; ++i) {
        const int r = tm + 16 * i;
        const int64_t row = q0 + r;
#pragma unroll
        for (int j = 0; j < C::kSN; ++j) {
          const int c = tn + 16 * j;
          const int64_t key = k0 + c;
          bool live = row < Sq && key < Skv;
          if (causal) live = live && key <= row;
          if (window > 0) live = live && key > row - window;
          const float p = live ? expf(fmaf(sc[i][j], scale, -Ls[r])) : 0.f;
          Ps[r * kLdp + c] = p;
          dSs[r * kLdp + c] = p * (dp[i][j] - Ds[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: keys tm + 16 i, columns tn + 16 j.
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pa[C::kKM], sa[C::kKM], ob[C::kKN], qb[C::kKN];
#pragma unroll
        for (int i = 0; i < C::kKM; ++i) {
          pa[i] = Ps[r * kLdp + tm + 16 * i];
          sa[i] = dSs[r * kLdp + tm + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < C::kKN; ++j) {
          ob[j] = dOs[r * kLd + tn + 16 * j];
          qb[j] = Qs[r * kLd + tn + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < C::kKM; ++i)
#pragma unroll
          for (int j = 0; j < C::kKN; ++j) {
            dv[i][j] = fmaf(pa[i], ob[j], dv[i][j]);
            dk[i][j] = fmaf(sa[i], qb[j], dk[i][j]);
          }
      }

      // dQ += scale dS K: rows tm + 16 i, columns tn + 16 j, by atomics.
      float dq[C::kQM][C::kQN];
#pragma unroll
      for (int i = 0; i < C::kQM; ++i)
#pragma unroll
        for (int j = 0; j < C::kQN; ++j) dq[i][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < kBK; ++c) {
        float sa[C::kQM], kb[C::kQN];
#pragma unroll
        for (int i = 0; i < C::kQM; ++i) sa[i] = dSs[(tm + 16 * i) * kLdp + c];
#pragma unroll
        for (int j = 0; j < C::kQN; ++j) kb[j] = Ks[c * kLd + tn + 16 * j];
#pragma unroll
        for (int i = 0; i < C::kQM; ++i)
#pragma unroll
          for (int j = 0; j < C::kQN; ++j) dq[i][j] = fmaf(sa[i], kb[j], dq[i][j]);
      }
#pragma unroll
      for (int i = 0; i < C::kQM; ++i) {
        const int64_t row = q0 + tm + 16 * i;
        if (row >= Sq) continue;
        float* dst = dq_acc + ((static_cast<int64_t>(b) * Sq + row) * H + h) * HD;
#pragma unroll
        for (int j = 0; j < C::kQN; ++j) atomicAdd(dst + tn + 16 * j, scale * dq[i][j]);
      }
    }
  }

  // This head split's dK (scaled) and dV, float32, laid out (split, B,
  // Skv, KV, hd).
#pragma unroll
  for (int i = 0; i < C::kKM; ++i) {
    const int64_t key = k0 + tm + 16 * i;
    if (key >= Skv) continue;
    const int64_t base =
        (((static_cast<int64_t>(hs) * B + b) * Skv + key) * KV + g) * HD;
#pragma unroll
    for (int j = 0; j < C::kKN; ++j) {
      dk_part[base + tn + 16 * j] = scale * dk[i][j];
      dv_part[base + tn + 16 * j] = dv[i][j];
    }
  }
}

// dq = dq_acc and dk, dv = the sum of the split partials, in T.
template <typename T>
__global__ void __launch_bounds__(256)
flash_attention_bwd_finish_kernel(const float* __restrict__ dq_acc,
                                  const float* __restrict__ dk_part,
                                  const float* __restrict__ dv_part,
                                  T* __restrict__ dq, T* __restrict__ dk,
                                  T* __restrict__ dv, int64_t n_q,
                                  int64_t n_kv, int split) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_q + n_kv; i += stride) {
    if (i < n_q) {
      store(dq + i, dq_acc[i]);
    } else {
      const int64_t j = i - n_q;
      float sk = 0.f, sv = 0.f;
      for (int s = 0; s < split; ++s) {
        sk += dk_part[s * n_kv + j];
        sv += dv_part[s * n_kv + j];
      }
      store(dk + j, sk);
      store(dv + j, sv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, void* dq_acc, void* dk_part, void* dv_part, int B,
           int H, int KV, int64_t Sq, int64_t Skv, int causal, int64_t window,
           int split, void* stream) {
  using C = Cfg<HD>;
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t rows = static_cast<int64_t>(B) * Sq * H;
  const int64_t n_ktiles = (Skv + C::kBK - 1) / C::kBK;
  const int64_t blocks = n_ktiles * split * B * KV;
  if ((rows + 7) / 8 > 2147483647 || blocks > 2147483647) return cudaErrorInvalidValue;
  flash_attention_bwd_prep_kernel<T, HD>
      <<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
          static_cast<const T*>(out), static_cast<const T*>(dout),
          static_cast<float*>(delta), static_cast<float*>(dq_acc), B, H, Sq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attention_bwd_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_kernel<T, HD>
      <<<static_cast<unsigned>(blocks), kThreads, C::kSmem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<float*>(dq_acc), static_cast<float*>(dk_part),
          static_cast<float*>(dv_part), B, H, KV, Sq, Skv, causal, window,
          split, 1.f / sqrtf(static_cast<float>(HD)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_q = rows * HD;
  const int64_t n_kv = static_cast<int64_t>(B) * Skv * KV * HD;
  const int64_t want = (n_q + n_kv + 255) / 256;
  flash_attention_bwd_finish_kernel<T>
      <<<static_cast<unsigned>(want < 4096 ? want : 4096), 256, 0, s>>>(
          static_cast<const float*>(dq_acc), static_cast<const float*>(dk_part),
          static_cast<const float*>(dv_part), static_cast<T*>(dq),
          static_cast<T*>(dk), static_cast<T*>(dv), n_q, n_kv, split);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 const void* out, const void* dout, const void* lse, void* dq,
                 void* dk, void* dv, void* delta, void* dq_acc, void* dk_part,
                 void* dv_part, int B, int H, int KV, int64_t Sq, int64_t Skv,
                 int causal, int64_t window, int split, void* stream) {
  switch (dtype) {
    case kF32:
      return launch<float, HD>(q, k, v, out, dout, lse, dq, dk, dv, delta,
                               dq_acc, dk_part, dv_part, B, H, KV, Sq, Skv,
                               causal, window, split, stream);
    case kBF16:
      return launch<__nv_bfloat16, HD>(q, k, v, out, dout, lse, dq, dk, dv,
                                       delta, dq_acc, dk_part, dv_part, B, H,
                                       KV, Sq, Skv, causal, window, split,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bwd

// Error codes of this library beyond cudaError_t's range.
constexpr int kErrTensorMap = 100000;

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int H, int KV, int64_t Sq, int64_t Skv,
              int causal, int64_t window, int64_t q_offset, void* stream) {
  using C = tc::Cfg<HD>;
  CUtensorMap tq, tk, tv;
  if (!tc::encode_map(&tq, q, HD, H, Sq, B, tc::kBQ) ||
      !tc::encode_map(&tk, k, HD, KV, Skv, B, C::kBK) ||
      !tc::encode_map(&tv, v, HD, KV, Skv, B, C::kBK))
    return kErrTensorMap;
  const cudaError_t attr = cudaFuncSetAttribute(
      tc::flash_attention_tc_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t n_qtiles = (Sq + tc::kBQ - 1) / tc::kBQ;
  const int64_t n_ctas = n_qtiles * B * H;
  if (n_ctas > 2147483647 || Sq > (1LL << 30) || Skv > (1LL << 30))
    return cudaErrorInvalidValue;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  tc::flash_attention_tc_kernel<HD><<<static_cast<unsigned>(n_ctas),
                                      tc::kThreads, C::kSmem,
                                      static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, B, H, KV, Sq, Skv,
      causal, window, q_offset, static_cast<int>(n_qtiles), scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---- float32: launch of the CUDA-core body --------------------------------

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int KV, int64_t Sq, int64_t Skv,
               int causal, int64_t window, int64_t q_offset, void* stream) {
  constexpr size_t kSmem = smem_bytes<HD>();
  // Above 48 KB of dynamic shared memory needs an opt-in (per device, so
  // it is set on every launch rather than once per process).
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<float, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t n_tiles = (Sq + kBQ - 1) / kBQ;
  if (n_tiles > 2147483647 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n_tiles), H, B);
  const float sm_scale = 1.f / sqrtf(static_cast<float>(HD));
  flash_attention_kernel<float, HD><<<grid, kThreads, kSmem,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, B, H, KV,
      Sq, Skv, causal, window, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int KV, int64_t Sq, int64_t Skv,
           int causal, int64_t window, int64_t q_offset, void* stream) {
  switch (dtype) {
    case kF32:
      return launch_f32<HD>(q, k, v, out, lse, B, H, KV, Sq, Skv, causal,
                            window, q_offset, stream);
    case kBF16:
      return launch_tc<HD>(q, k, v, out, lse, B, H, KV, Sq, Skv, causal,
                           window, q_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (B, Sq, H, hd) in q's dtype; lse (B, H, Sq) float32, the rows'
// log-sum-exp of the scaled scores, or null (serving) to skip it. window
// <= 0 means no window.
int flash_attention_launch(int dtype, int hd, const void* q, const void* k,
                           const void* v, void* out, void* lse, int B, int H,
                           int KV, int64_t Sq, int64_t Skv, int causal,
                           int64_t window, int64_t q_offset, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1)
    return cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 64:
      return launch<64>(dtype, q, k, v, out, l, B, H, KV, Sq, Skv, causal,
                        window, q_offset, stream);
    case 128:
      return launch<128>(dtype, q, k, v, out, l, B, H, KV, Sq, Skv, causal,
                         window, q_offset, stream);
    case 256:
      return launch<256>(dtype, q, k, v, out, l, B, H, KV, Sq, Skv, causal,
                         window, q_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Gradient of the attention (query positions from 0): dq (B, Sq, H, hd),
// dk, dv (B, Skv, KV, hd) in the input dtype, from q, k, v, the forward's
// out and lse and dout. Scratch (float32, any contents): delta (B, H, Sq),
// dq_acc (B, Sq, H, hd), dk_part and dv_part (split, B, Skv, KV, hd);
// split divides H / KV.
int flash_attention_bwd_launch(int dtype, int hd, const void* q,
                               const void* k, const void* v, const void* out,
                               const void* dout, const void* lse, void* dq,
                               void* dk, void* dv, void* delta, void* dq_acc,
                               void* dk_part, void* dv_part, int B, int H,
                               int KV, int64_t Sq, int64_t Skv, int causal,
                               int64_t window, int split, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 ||
      split < 1 || (H / KV) % split != 0)
    return cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return bwd::launch_dtype<64>(dtype, q, k, v, out, dout, lse, dq, dk, dv,
                                   delta, dq_acc, dk_part, dv_part, B, H, KV,
                                   Sq, Skv, causal, window, split, stream);
    case 128:
      return bwd::launch_dtype<128>(dtype, q, k, v, out, dout, lse, dq, dk,
                                    dv, delta, dq_acc, dk_part, dv_part, B, H,
                                    KV, Sq, Skv, causal, window, split, stream);
    case 256:
      return bwd::launch_dtype<256>(dtype, q, k, v, out, dout, lse, dq, dk,
                                    dv, delta, dq_acc, dk_part, dv_part, B, H,
                                    KV, Sq, Skv, causal, window, split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  if (err == kErrTensorMap)
    return "cuTensorMapEncodeTiled failed or is unavailable (bf16 q, k or v: "
           "base 16-byte aligned, hd in {64, 128, 256})";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
