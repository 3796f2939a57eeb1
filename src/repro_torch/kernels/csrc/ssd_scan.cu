// Chunked Mamba-2 SSD scan (state-space duality) for Hopper.
//
// Replaces the TPU Pallas kernel of src/repro/kernels/ssd_scan.py:
//   ssd_scan_kernel (:79, body _body :43, _segsum :33) -> ssd_scan_launch
//
// What it computes, per batch row b and head h, from a zero state, with
// a_t = dt_t * A_h, x, B, C read in their storage type and everything
// else in float32 (the TPU kernel's algebra):
//   h_t = exp(a_t) h_{t-1} + (dt_t x_t) B_t^T      (P, N) state
//   y_t = h_t C_t                                   (P,)
// in the chunked form over chunks of Q steps, cum = cumsum(a) inside a
// chunk:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//         + exp(cum_i) h_in C_i                                     (inter)
//   h_out = exp(cum_last) h_in + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// y (B, S, H, P) and h_fin (B, H, P, N) are float32. A ragged S is masked
// here: the last chunk's missing steps are the reference's dt = 0 padding
// (identities on the state), so cum_last is taken at the last valid step
// and h_fin is the state at S - 1. Nothing is copied to pad.
//
// Bound on this card. At the mamba2-1.3b training step (B 2, S 4096,
// H 64, P 64, N 128, Q 256, bf16 x/B/C) the function must read x (67 MB),
// B, C, dt and write y in float32 (134 MB) and h_fin: 0.21 GB, 0.063 ms at
// 3.35 TB/s. Its causal work is 2 (N + P) per live (i, j) pair of a chunk
// plus 4 N P per step (chunk state and inter-chunk term): 43 GFLOP, 0.044
// ms at the bf16 tensor-core rate. So bytes bound it in bf16; in float32
// the operations do (0.64 ms at 67 TFLOP/s).
//
// Two bodies, each with its own entry and Python wrapper; the caller
// names one (never the other after a failure):
//
// * bfloat16 with P = 64, N = 128 and a chunk of 64, 128 or 256
//   (mamba2-1.3b's heads) -> ssd_scan_tc_launch, on the tensor cores.
//   bf16 training runs it (ops.ssd_body picks it from the inputs), and its
//   gradient is the backward kernel below.
//   The CUDA-core body below ran every product as float32 FMAs (43 GFLOP
//   at the training step: 0.64 ms even at the 67 TFLOP/s peak), formed
//   the C B^T scores per head though they depend on (b, chunk) only, and
//   moved 0.27 GB of chunk states between its passes. This one:
//   - ssd_scores_kernel: the scores C_i . B_j of each (b, chunk), once,
//     by wgmma from the exact bf16 values (lower 64 x 64 tiles only),
//     into a (B, nc, Q, Q) float32 scratch (8.4 MB at the training step)
//     that every head then reads;
//   - ssd_scan_tc_kernel: one block per (b, h) walks its chunks in order,
//     the TPU kernel's innermost chunk axis; B H = 128 blocks at the
//     training step, one wave. The (P x N) state never leaves registers
//     (the wgmma accumulator of h^T, split across the two warpgroups), so
//     no chunk state is written at all: the layout moves about 0.22 GB
//     of device memory (x, y, h_fin, the scores once) plus L2 reads of
//     the shared scores, B and C. (The other layout, chunk-parallel
//     passes with a state pass, would move the 0.27 GB of states on top:
//     not built.) x and B of the next chunk arrive by cp.async while this
//     one is computed;
//   - every product is a bf16 wgmma with float32 accumulation. One
//     operand of each is exact bf16 (C and B for the scores, x for the
//     intra-chunk and state products, C for the inter-chunk term); the
//     other is float32 and goes in as three bf16 parts, p0 = bf16(v),
//     p1 = bf16(v - p0), p2 = bf16(v - p0 - p1): three wgmmas into one
//     accumulator. The float sides: the masked, decayed, dt-scaled
//     scores (register fragments), w B for the state (from the B tile by
//     ldmatrix.trans) and h_in for the inter-chunk term (written to
//     shared memory from the accumulator);
//   - precision against the exact answer at the training step: one bf16
//     rounding of the float side would give 2.3e-3 (the CPU emulation in
//     tests/test_torch_kernels.py), two parts 4.6e-6 on the card. Three
//     parts in this order still left 4e-7, biased toward zero: wgmma's
//     float32 accumulation truncates. So the parts are issued smallest
//     first (each truncation happens while the accumulator is small) and
//     the scores pass sums its k-steps on the CUDA cores: 1.5e-7 from the
//     exact answer (chip_smoke.py), about ssd_chunked's own distance, with
//     a bias of -5e-8 of the mean output (tools/k4_precision.py);
//   - a group's loads are issued before any is used, and the next
//     group's while the current group's wgmmas run (the first designs,
//     loads inside a per-k-step branch, took 0.42-0.46 ms, most of it in
//     the intra-chunk term waiting on L2).
// * every dtype and shape (the model's kernel path) -> ssd_scan_launch,
//   the CUDA-core body: float32 FMAs. A TPU grid step carries the state
//   from chunk to chunk in VMEM; here blocks run in parallel, so the
//   scan is split in three launches:
//   1. chunk_state: one block per (b, h, chunk): the chunk's own state
//      contribution sum_j exp(cum_last - cum_j) dt_j x_j B_j^T (P x N,
//      a (P x Q)(Q x N) product in 64-step tiles) and its decay
//      exp(cum_last). 2048 blocks at the training step.
//   2. state_pass: one thread per (b, h, n, p) state element walks the
//      chunks in order: h_in(c) = h_in(c-1) exp(cum_last) + contribution,
//      written in place of the contribution; the last one is h_fin.
//   3. chunk_output: one block per (b, h, chunk, 64-row tile): the
//      masked (64 x 64) score tiles C_i B_j^T exp(cum_i - cum_j) times
//      the dt-scaled x tile, for the j tiles at or below the diagonal,
//      plus exp(cum_i) C_i h_in^T. 8192 blocks at the training step.
// A (P, N) state of 32 KB and a whole 256-step chunk in float32 (320 KB)
// would not fit a block's shared memory; 64-row tiles do (105 KB, two
// blocks an SM). Each tile product runs 256 threads over 4x4 register
// tiles with 16-byte shared-memory reads; rows past S or the chunk, and
// columns past P or N, are zero-filled, so P <= 64, N <= 128 and any
// chunk up to 1024 share one code path. cumsum is recomputed per block
// (a block-wide scan of Q values) rather than stored.
//
// Precision. Every decay factor exp(sum_{j < t <= i} a_t) is summed over
// its own segment (CUDA cores: reverse cumsums for the chunk state, 4-step
// block sums for the score tiles; tensor cores: the sums within 16-step
// blocks and over the whole blocks between, each factor a product of
// their exponentials), not taken as cum_i - cum_j as the TPU kernel and
// the reference's segsum do: the a_t are all <= 0, so a direct sum is
// accurate to its own size, while the difference loses eps |cum|, and
// |cum| reaches thousands within a 256-step chunk of mamba2-1.3b (A down
// to -16): a float32 error of about 1e-4 in every factor near the
// diagonal. The port's plain ``ssd_chunked`` sums segments directly too.
//
// The backward of the tensor-core body (ssd_scan_bwd_tc_launch) replaces
// no TPU kernel: the JAX package differentiates its jnp path (autograd of
// the port's plain ssd_chunked did the same here, about 300 launches and
// 35 ms a call at the training step). Same domain as the body. Its bound
// at the benchmark cells' call (B 8, S 2048, H 64, P 64, N 128, Q 256,
// bf16): twice the forward's operations, 172 GFLOP, 0.174 ms at the bf16
// tensor-core rate (the bytes, 0.17 GB, take 0.05 ms). Its layout, in
// nine launches (namespace bwd):
// - the scores pass of the forward, and a tables pass writing each (b, h,
//   chunk)'s decay factors once (direct segment sums, as the forward's);
// - the chunk-entry states h_in recomputed (per (b, h), chunks in order,
//   the forward's state update) and the state gradients dh_out (per
//   (b, h), chunks last first): both stored in three bf16 parts, 48 KB a
//   (b, h, chunk), 201 MB each at the cells' call, one layer at a time;
// - per (b, h, chunk): dx and the terms of ddt that need one head;
// - per (b, chunk, 64-row tile), the 64 heads in order: the head-summed
//   score gradient dS with each head's intra-chunk log-decay sums, then
//   dC and dB (the inter-chunk and state terms summed head by head, then
//   dS's products with B and C);
// - the log-decay gradient per (b, h, chunk) and dA.
// Every product is a bf16 wgmma with float32 accumulation: x, B and C go
// in as they are, every float32 operand (gy, the masked decayed scores,
// the states, dS) as three bf16 parts (six products where both sides are
// float32, the parts whose sum is kept to about 2^-24). Cross-head and
// cross-step sums run in a fixed order (no atomics): two runs give the
// same bits. The workspace is one buffer (0.66 GB at the cells' call,
// against about 4 GB held by the autograd graph it replaces). The
// gradients as returned are as close to float64 as autograd of float32
// ssd_chunked's (tests/test_torch_kernels_gpu.py, chip_smoke.py); beneath
// their bf16 rounding, the float32 sums of dx read up to 2.5 x float32
// ssd_chunked's largest gap at the cells' call (1.7e-6 against 6.9e-7).
//
// C interface (loaded with ctypes): pointers and the stream as void*; the
// entry returns the first CUDA error of its launches (0 when all went).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows (steps) per tile
constexpr int kMaxP = 64;          // head dim the tiles cover
constexpr int kMaxN = 128;         // state dim the tiles cover
constexpr int kMaxChunk = 1024;
constexpr int kLd = kTile + 4;     // padded row of a [k][64] tile
constexpr int kLdN = kMaxN + 4;    // padded row of a [64][128] tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Inclusive cumsum of a_t = dt[t] * A over t in [0, n), with a_t = 0 for
// t >= n_valid (the reference's dt = 0 padding), into cum[0, n); with
// ``reverse`` the steps are taken last first (cum[u] = sum of the last
// u + 1 valid steps). dt is this (b, chunk, h)'s column: element t at
// dt[t * H]. Block-wide: each thread sums a run of consecutive steps, then
// the runs are offset by a scan of their totals (warp shuffles, then
// across the 8 warps). All a_t <= 0, so every partial sum is accurate to
// its own size (no cancellation).
__device__ void chunk_cumsum(const float* __restrict__ dt, int64_t H, float A,
                             int n, int n_valid, bool reverse, float* cum,
                             float* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int t0 = tid * per;
  float run = 0.f;
  for (int e = 0; e < per; ++e) {
    const int t = t0 + e;
    if (t < n) {
      run += t < n_valid ? dt[(reverse ? n_valid - 1 - t : t) * H] * A : 0.f;
      cum[t] = run;
    }
  }
  float v = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kThreads / 32 ? warp_tot[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    if (lane < kThreads / 32) warp_tot[lane] = w;
  }
  __syncthreads();
  const float offset = (v - run) + (warp > 0 ? warp_tot[warp - 1] : 0.f);
  for (int e = 0; e < per; ++e) {
    const int t = t0 + e;
    if (t < n) cum[t] += offset;
  }
  __syncthreads();
}

// ---- pass 1: each chunk's own state contribution and its decay ----------
//
// st[b, h, c, n, p] = sum_j exp(cum_last - cum_j) dt_j x_j[p] B_j[n]
// decay[b, h, c]    = exp(cum_last)
// cum_last - cum_j = sum_{t > j} a_t is read from a reverse cumsum, never
// formed as a difference.
template <typename In>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const In* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const In* __restrict__ Bm,
                   float* __restrict__ st, float* __restrict__ decay, int H,
                   int64_t S, int P, int N, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* xw = smem;                    // [64][kLd]  xw[j][p]
  float* bs = xw + kTile * kLd;        // [64][kLdN] bs[j][n]
  float* rcum = bs + kTile * kLdN;     // [Q] rcum[u]: the last u + 1 steps
  float* warp_tot = rcum + Q;          // [8]

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t start = static_cast<int64_t>(c) * Q;
  const int qc = static_cast<int>(S - start < Q ? S - start : Q);
  const int64_t row0 = static_cast<int64_t>(b) * S + start;  // (b, start)
  chunk_cumsum(dt + row0 * H + h, H, A[h], qc, qc, true, rcum, warp_tot);

  // Thread tile: p in [4 ty, 4 ty + 4), n in [4 tx, +4) and [64 + 4 tx, +4).
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;

  for (int j0 = 0; j0 < qc; j0 += kTile) {
    for (int e = tid; e < kTile * kMaxP; e += kThreads) {
      const int j = e / kMaxP, p = e % kMaxP;
      float v = 0.f;
      if (j0 + j < qc && p < P) {
        const int64_t row = row0 + j0 + j;
        const int jj = j0 + j;  // sum_{t > jj} a_t = rcum[qc - 2 - jj]
        const float w = dt[row * H + h] * (jj == qc - 1 ? 1.f : expf(rcum[qc - 2 - jj]));
        v = to_f32(x[(row * H + h) * P + p]) * w;
      }
      xw[j * kLd + p] = v;
    }
    for (int e = tid; e < kTile * kMaxN; e += kThreads) {
      const int j = e / kMaxN, n = e % kMaxN;
      bs[j * kLdN + n] =
          (j0 + j < qc && n < N) ? to_f32(Bm[(row0 + j0 + j) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&xw[j * kLd + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[j * kLdN + 4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[j * kLdN + 64 + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }

  float* out = st + ((static_cast<int64_t>(b) * H + h) * nc + c) * N * P;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int n = (q < 4 ? 4 * tx : 64 + 4 * tx) + (q & 3);
    if (n >= N) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = 4 * ty + r;
      if (p < P) out[static_cast<int64_t>(n) * P + p] = acc[r][q];
    }
  }
  if (tid == 0) decay[(static_cast<int64_t>(b) * H + h) * nc + c] = expf(rcum[qc - 1]);
}

// ---- pass 2: carry the state across chunks ------------------------------
//
// In place: st[b, h, c] becomes the state entering chunk c (0 for c = 0);
// h_fin[b, h, p, n] is the state after the last chunk.
__global__ void __launch_bounds__(kThreads)
state_pass_kernel(float* __restrict__ st, const float* __restrict__ decay,
                  float* __restrict__ h_fin, int H, int P, int N, int nc) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t NP = static_cast<int64_t>(N) * P;
  if (e >= NP) return;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  float* s = st + bh * nc * NP + e;
  const float* d = decay + bh * nc;
  float state = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float contrib = s[c * NP];
    s[c * NP] = state;
    state = state * d[c] + contrib;
  }
  const int64_t n = e / P, p = e % P;
  h_fin[(bh * P + p) * N + n] = state;
}

// ---- pass 3: the outputs of one 64-row tile of a chunk ------------------
template <typename In>
__global__ void __launch_bounds__(kThreads)
chunk_output_kernel(const In* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const In* __restrict__ Bm,
                    const In* __restrict__ Cm, const float* __restrict__ st,
                    float* __restrict__ y, int H, int64_t S, int P, int N,
                    int Q, int nc, int tiles) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                   // [128][kLd]  ct[n][i] = C_i[n]
  float* bt = ct + kMaxN * kLd;       // [128][kLd]  bt[n][j] = B_j[n]; then h_in^T
  float* xs = bt + kMaxN * kLd;       // [64][kLd]   xs[j][p] = dt_j x_j[p]
  float* sc = xs + kTile * kLd;       // [64][kLd]   sc[j][i] = masked scores
  float* cum = sc + kTile * kLd;      // [Q] chunk prefix sums
  float* a_s = cum + Q;               // [Q] a_t
  float* q4 = a_s + Q;                // [Q / 4] sums of a over 4-step blocks
  float* warp_tot = q4 + Q / 4 + 1;   // [8]

  const int h = blockIdx.x, b = blockIdx.z;
  const int c = blockIdx.y / tiles, it = blockIdx.y % tiles;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t start = static_cast<int64_t>(c) * Q;
  const int qc = static_cast<int>(S - start < Q ? S - start : Q);
  const int i0 = it * kTile;  // first row of the tile, chunk-local
  if (i0 >= qc) return;       // the ragged last chunk's empty tiles
  const int64_t row0 = static_cast<int64_t>(b) * S + start;
  const int n_cum = min(Q, i0 + kTile);
  chunk_cumsum(dt + row0 * H + h, H, A[h], n_cum, qc, false, cum, warp_tot);
  const float Ah = A[h];
  for (int t = tid; t < n_cum; t += kThreads)
    a_s[t] = t < qc ? dt[(row0 + t) * H + h] * Ah : 0.f;
  __syncthreads();
  for (int k = tid; 4 * k < n_cum; k += kThreads) {
    float v = 0.f;
    for (int t = 4 * k; t < min(4 * k + 4, n_cum); ++t) v += a_s[t];
    q4[k] = v;
  }

  for (int e = tid; e < kTile * kMaxN; e += kThreads) {
    const int i = e / kMaxN, n = e % kMaxN;
    ct[n * kLd + i] =
        (i0 + i < qc && n < N) ? to_f32(Cm[(row0 + i0 + i) * N + n]) : 0.f;
  }
  const int nk = min(kMaxN, (N + 3) & ~3);  // product depth over n

  // Thread tile: rows i in [4 ty, 4 ty + 4), columns in [4 tx, 4 tx + 4).
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  for (int j0 = 0; j0 <= i0; j0 += kTile) {
    for (int e = tid; e < kTile * kMaxN; e += kThreads) {
      const int j = e / kMaxN, n = e % kMaxN;
      bt[n * kLd + j] =
          (j0 + j < qc && n < N) ? to_f32(Bm[(row0 + j0 + j) * N + n]) : 0.f;
    }
    for (int e = tid; e < kTile * kMaxP; e += kThreads) {
      const int j = e / kMaxP, p = e % kMaxP;
      float v = 0.f;
      if (j0 + j < qc && p < P) {
        const int64_t row = row0 + j0 + j;
        v = to_f32(x[(row * H + h) * P + p]) * dt[row * H + h];
      }
      xs[j * kLd + p] = v;
    }
    __syncthreads();
    // scores s[i][j] = C_i . B_j over this 64 x 64 tile
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
#pragma unroll 4
    for (int k = 0; k < nk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&ct[k * kLd + 4 * ty]);
      const float4 bb = *reinterpret_cast<const float4*>(&bt[k * kLd + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[r][q] = fmaf(av[r], bv[q], s[r][q]);
    }
    // decay mask L[i][j] = exp(sum_{j < t <= i} a_t) for j <= i, else 0,
    // each segment summed directly (not cum_i - cum_j): the part after j
    // in j's 4-step block, the whole blocks between, the part of i's block
    // up to i; all terms <= 0, so no cancellation.
    const int I0 = i0 + 4 * ty, J0 = j0 + 4 * tx;
    float seg[4][4];
    const bool rows_in = I0 < n_cum;  // else every row is past the chunk
    if (rows_in && J0 < I0) {
      float mid = 0.f;
      for (int k = J0 / 4 + 1; k < I0 / 4; ++k) mid += q4[k];
      float after_j[4], upto_i[4];
      after_j[3] = 0.f;
      for (int q = 2; q >= 0; --q) after_j[q] = after_j[q + 1] + a_s[J0 + q + 1];
      upto_i[0] = a_s[I0];
      for (int r = 1; r < 4; ++r) upto_i[r] = upto_i[r - 1] + a_s[I0 + r];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) seg[r][q] = after_j[q] + mid + upto_i[r];
    } else if (rows_in && J0 == I0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v = 0.f;
          for (int t = I0 + q + 1; t <= I0 + r; ++t) v += a_s[t];
          seg[r][q] = v;
        }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = J0 + q;
      float v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = I0 + r;
        v[r] = (rows_in && j <= i && i < qc) ? s[r][q] * expf(seg[r][q]) : 0.f;
      }
      *reinterpret_cast<float4*>(&sc[(4 * tx + q) * kLd + 4 * ty]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    // acc[i][p] += sum_j sc[j][i] xs[j][p]
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&sc[j * kLd + 4 * ty]);
      const float4 bb = *reinterpret_cast<const float4*>(&xs[j * kLd + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }

  if (c > 0) {  // the carried-in state: exp(cum_i) C_i h_in^T
    const float* hin = st + ((static_cast<int64_t>(b) * H + h) * nc + c) * N * P;
    for (int e = tid; e < kMaxN * kMaxP; e += kThreads) {
      const int n = e / kMaxP, p = e % kMaxP;
      bt[n * kLd + p] = (n < N && p < P) ? hin[static_cast<int64_t>(n) * P + p] : 0.f;
    }
    __syncthreads();
    float inter[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) inter[r][q] = 0.f;
#pragma unroll 4
    for (int k = 0; k < nk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&ct[k * kLd + 4 * ty]);
      const float4 bb = *reinterpret_cast<const float4*>(&bt[k * kLd + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) inter[r][q] = fmaf(av[r], bv[q], inter[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * ty + r;
      const float g = i < qc ? expf(cum[i]) : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] += inter[r][q] * g;
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= qc) continue;
    float* yrow = y + ((row0 + i) * H + h) * P;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = 4 * tx + q;
      if (p < P) yrow[p] = acc[r][q];
    }
  }
}

constexpr size_t state_smem(int Q) {
  return (static_cast<size_t>(kTile) * kLd + static_cast<size_t>(kTile) * kLdN + Q + 8) *
         sizeof(float);
}
constexpr size_t output_smem(int Q) {
  return (2 * static_cast<size_t>(kMaxN) * kLd + 2 * static_cast<size_t>(kTile) * kLd + 2 * Q +
          Q / 4 + 1 + 8) *
         sizeof(float);
}

template <typename In>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* h_fin, void* st, void* decay, int B,
           int64_t S, int H, int P, int N, int Q, cudaStream_t stream) {
  const int64_t nc64 = (S + Q - 1) / Q;
  const int tiles = (Q + kTile - 1) / kTile;
  if (nc64 * tiles > 65535) return cudaErrorInvalidValue;
  const int nc = static_cast<int>(nc64);
  const auto* xi = static_cast<const In*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bi = static_cast<const In*>(Bm);
  const auto* Ci = static_cast<const In*>(Cm);
  auto* stf = static_cast<float*>(st);
  auto* dec = static_cast<float*>(decay);

  const size_t s1 = state_smem(Q), s3 = output_smem(Q);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_state_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(chunk_output_kernel<In>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s3));
  if (err != cudaSuccess) return err;

  chunk_state_kernel<In><<<dim3(H, nc, B), kThreads, s1, stream>>>(
      xi, dtf, Af, Bi, stf, dec, H, S, P, N, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t NP = static_cast<int64_t>(N) * P;
  state_pass_kernel<<<dim3(static_cast<unsigned>((NP + kThreads - 1) / kThreads), H, B),
                      kThreads, 0, stream>>>(stf, dec, static_cast<float*>(h_fin), H, P, N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_output_kernel<In><<<dim3(H, nc * tiles, B), kThreads, s3, stream>>>(
      xi, dtf, Af, Bi, Ci, stf, static_cast<float*>(y), H, S, P, N, Q, nc, tiles);
  return cudaGetLastError();
}

// ---- bfloat16, P 64, N 128: the tensor-core body --------------------------

namespace tc {

constexpr int kP = 64, kN = 128;
constexpr int kThreads = 256;       // two warpgroups
constexpr int kRowBytes = 128;      // one swizzled row: 64 bf16
constexpr int kAtomBytes = 1024;    // 8 rows x 128 bytes
constexpr int kBLd = kN * 2 + 16;   // padded row of the B tile (bytes)
constexpr int kHBytes = kN * kRowBytes;  // one bf16 part of h^T: [n][64 p]
// bf16 parts of a float32 operand: v = p0 + p1 + p2 to about 2^-26
// relative, pi = bf16(v - p0 - ... - p(i-1)) (see the note at the top).
constexpr int kParts = 3;

// (v0, v1) as kParts bf16 pairs: part i rounds what the parts before it
// left (each subtraction is exact in float32).
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t (&out)[kParts]) {
#pragma unroll
  for (int i = 0; i < kParts; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h);
    out[i] = *reinterpret_cast<const uint32_t*>(&h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The A fragments (registers) of four k-steps, kParts bf16 parts each:
// a[u][q][i] is register q of k-step u, part i.
struct Frags {
  uint32_t a[4][4][kParts];
};

__device__ __forceinline__ void fence_frags(Frags& f) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q) sm90::fence_regs(f.a[u][q]);
}

// The four A registers of part i of k-step u.
__device__ __forceinline__ void part_regs(const Frags& f, int u, int i, uint32_t (&r)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) r[q] = f.a[u][q][i];
}

// acc += the products of n_groups groups of four k-steps. A group's
// operands come in two steps: load(k0, raw) issues its loads into `raw`
// (registers), make(k0, raw, frags) turns them into bf16-part fragments;
// the caller has issued group 0's loads. While one group's wgmmas run,
// the next group's loads are in flight.
template <class Raw, class Load, class Make, class Issue>
__device__ __forceinline__ void pipeline(int n_groups, float (&acc)[32], Raw& raw, Load load,
                                         Make make, Issue issue) {
  Frags f;
#pragma unroll 1
  for (int grp = 0; grp < n_groups; ++grp) {
    make(4 * grp, raw, f);
    sm90::wgmma_fence();
    issue(acc, 4 * grp, f);
    sm90::wgmma_commit();
    if (grp + 1 < n_groups) load(4 * (grp + 1), raw);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    fence_frags(f);
  }
}

// ---- pass 1: the scores C_i . B_j of one (b, chunk), shared by the heads --
//
// One warpgroup per lower-triangular 64 x 64 tile (i tile >= j tile) of
// the chunk's Q x Q scores: C rows and B rows are copied into shared
// memory K-major and 128-byte swizzled (two 64-column boxes across N), and
// one wgmma m64n64k16 a k-step forms the tile in float32 from the exact
// bf16 values. Rows past S read as zeros. scores (B, nc, Q, Q) float32;
// the upper tiles are never written (nor read).
template <int Q>
__global__ void __launch_bounds__(128)
ssd_scores_kernel(const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
                  float* __restrict__ scores, int64_t S, int nc) {
  constexpr int kBox = 64 * kRowBytes;  // one [64 rows][64 cols] box
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  uint8_t* Cs = smem_raw + ((kAtomBytes - raw % kAtomBytes) % kAtomBytes);
  uint8_t* Bs = Cs + 2 * kBox;

  int ti = 0, rem = blockIdx.x;  // lower-triangular tile (ti, tj), tj <= ti
  while (rem > ti) rem -= ++ti;
  const int tj = rem;
  const int c = blockIdx.y, b = blockIdx.z;
  const int64_t row0 = static_cast<int64_t>(b) * S;
  const int64_t start = static_cast<int64_t>(c) * Q;
  for (int e = threadIdx.x; e < 2 * 64 * 16; e += 128) {
    const int which = e / (64 * 16), r = (e / 16) % 64, piece = e % 16;
    const int64_t t = start + (which ? tj : ti) * 64 + r;
    const __nv_bfloat16* src = (which ? Bm : Cm) + (row0 + (t < S ? t : 0)) * kN + piece * 8;
    uint8_t* dst = (which ? Bs : Cs) + (piece / 8) * kBox + sm90::swz128(r, piece % 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < S) v = *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(dst) = v;
  }
  sm90::fence_proxy_async();
  __syncthreads();

  // Each k-step into a fresh accumulator, the eight summed on the CUDA
  // cores: wgmma's float32 accumulation truncates, and eight truncations
  // into one accumulator bias the scores toward zero (measured on the
  // card: the output's mean signed error halved with unbiased scores).
  float acc[32], part[2][32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  const uint64_t dc = sm90::desc_b128(sm90::smem_u32(Cs), 16, kAtomBytes);
  const uint64_t db = sm90::desc_b128(sm90::smem_u32(Bs), 16, kAtomBytes);
#pragma unroll
  for (int kk = 0; kk < kN / 16; kk += 2) {
    sm90::wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = (((kk + h) / 4) * kBox + ((kk + h) % 4) * 32) >> 4;
      sm90::wgmma_ss_t<64, 0, 0>(part[h], dc + off, db + off, 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(part[0]);
    sm90::fence_regs(part[1]);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += part[0][e] + part[1][e];
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* out = scores + ((static_cast<int64_t>(b) * nc + c) * Q + ti * 64) * Q + tj * 64;
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
    const int col = 8 * (e / 4) + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(r) * Q + col) =
        make_float2(acc[e], acc[e + 1]);
  }
}

// ---- pass 2: one (b, h) walks its chunks in order -----------------------
//
// The state h (P x N) stays in registers as the accumulator of
// h^T = sum_j (w_j B_j)^T x_j: warpgroup g holds rows n in [64 g, 64 g + 64)
// (m64n64, 32 floats a thread). Per chunk:
//   tables  a_t = dt_t A; 16-step block sums; each decay factor as a
//           product of exponentials of direct segment sums (never a
//           difference of cumulative sums; every term <= 0);
//   h_in    written to shared memory in bf16 parts (N-major, swizzled);
//   y       per 64-row tile: inter C_i h_in^T (C fragments from global,
//           exact; a wgmma for each part of h_in), rows scaled by
//           exp(cum_i); then intra sum_j (C_i . B_j) L_ij dt_j x_j with
//           the score side in registers as bf16-part fragments and x from
//           shared memory (exact); stored as float32;
//   state   h^T = exp(cum_last) h^T + (w B)^T x, the A fragments of
//           (w B)^T from the chunk's B tile by ldmatrix.trans, scaled by
//           w_j = dt_j exp(sum_{t > j} a_t) and split into parts.
// x (by chunk, double-buffered) and B arrive by cp.async, prefetched a
// chunk ahead; rows past S are zero-filled, and dt = 0 there, so a ragged
// chunk is the reference's dt = 0 padding.
template <int Q>
struct Smem {
  static constexpr int kNb = Q / 16;  // 16-step blocks per chunk
  static constexpr int kX = Q * kRowBytes;
  static constexpr int kOffX0 = 0, kOffX1 = kX, kOffH = 2 * kX;  // h_in: kParts tiles
  static constexpr int kOffB = kOffH + kParts * kHBytes;
  static constexpr int kOffTab = kOffB + Q * kBLd;
  // tables: a, dts, ei, ej, g, w (Q each), blk (16), em (16 x 16), ED (Q x 16)
  static constexpr int kTabFloats = 6 * Q + 16 + 256 + 16 * Q;
  static constexpr int kBytes = kOffTab + kTabFloats * 4 + kAtomBytes;
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

template <int Q>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                   const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ scores,
                   float* __restrict__ y, float* __restrict__ h_fin, int H, int64_t S, int nc) {
  using L = Smem<Q>;
  constexpr int kNb = L::kNb;
  constexpr int kT = Q / 64;  // 64-row tiles per chunk
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((kAtomBytes - raw % kAtomBytes) % kAtomBytes);
  uint8_t* Bs = base + L::kOffB;
  float* tab = reinterpret_cast<float*>(base + L::kOffTab);
  float* a_s = tab;             // a_t (0 past S)
  float* dts = a_s + Q;         // dt_t (0 past S)
  float* ei = dts + Q;          // exp(sum of a from i's block start to i)
  float* ej = ei + Q;           // dt_j exp(sum of a after j to j's block end)
  float* gi = ej + Q;           // exp(cum_i), cum from the chunk start
  float* wst = gi + Q;          // dt_j exp(sum of a after j to the chunk end)
  float* blk = wst + Q;         // [16] block sums
  float* em = blk + 16;         // [16][16] exp(sum of the blocks strictly between)
  float* ED = em + 256;         // [Q][16] dt_j exp(sum_{j < t <= i}) in i's block

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid / 32) % 4, g = tid / 128;
  const float Ah = A[h];
  const int64_t row0 = static_cast<int64_t>(b) * S;  // (b, 0)

  // Loads chunk cx's x (rows of this head) into buffer cx % 2 and chunk
  // cb's B rows into the B tile (-1: none), as one cp.async group.
  auto load = [&](int cx, int cb) {
    if (cx >= 0) {
      const int64_t start = static_cast<int64_t>(cx) * Q;
      uint8_t* xs = base + (cx % 2 ? L::kOffX1 : L::kOffX0);
      for (int e = tid; e < Q * 8; e += kThreads) {
        const int r = e / 8, piece = e % 8;
        const int64_t t = start + r;
        const bool ok = t < S;
        sm90::cp_async_16(xs + sm90::swz128(r, piece),
                          x + ((row0 + (ok ? t : 0)) * H + h) * kP + piece * 8, ok);
      }
    }
    if (cb >= 0) {
      const int64_t start = static_cast<int64_t>(cb) * Q;
      for (int e = tid; e < Q * 16; e += kThreads) {
        const int r = e / 16, piece = e % 16;
        const int64_t t = start + r;
        const bool ok = t < S;
        sm90::cp_async_16(Bs + r * kBLd + piece * 16,
                          Bm + (row0 + (ok ? t : 0)) * kN + piece * 8, ok);
      }
    }
    sm90::cp_async_commit();
  };
  load(0, 0);
  load(nc > 1 ? 1 : -1, -1);

  float st[32];  // h^T rows n = 64 g + 16 warp + lane / 4 (+ 8), columns p
#pragma unroll
  for (int e = 0; e < 32; ++e) st[e] = 0.f;
  auto dt_at = [&](int cc) {
    const int64_t t = static_cast<int64_t>(cc) * Q + tid;
    return tid < Q && t < S ? dt[(row0 + t) * H + h] : 0.f;
  };
  float dt_next = dt_at(0);
  // The parts of h_in as N-major B operands (one 64-column atom: the
  // leading byte offset is not used), kHBytes apart.
  const uint64_t h_desc = sm90::desc_b128(sm90::smem_u32(base + L::kOffH), kHBytes, kAtomBytes);
  const int rq = lane / 4, cq = 2 * (lane % 4);  // fragment row / column offsets

  for (int c = 0; c < nc; ++c) {
    const int64_t start = static_cast<int64_t>(c) * Q;
    const int qc = static_cast<int>(S - start < Q ? S - start : Q);
    const float dt_cur = dt_next;
    if (c + 1 < nc) dt_next = dt_at(c + 1);

    // ---- tables -------------------------------------------------------
    if (tid < Q) {
      a_s[tid] = dt_cur * Ah;
      dts[tid] = dt_cur;
    }
    __syncthreads();
    float pin = 0.f, suf = 0.f;
    if (tid < Q) {
      const int lo = tid & ~15, jj_i = tid & 15;
      for (int t = lo; t <= tid; ++t) pin += a_s[t];
      for (int t = tid + 1; t < lo + 16; ++t) suf += a_s[t];
      float seg = 0.f;
      float* ed = ED + tid * 16;
      ed[jj_i] = dts[tid];
      for (int jj = jj_i - 1; jj >= 0; --jj) {
        seg += a_s[lo + jj + 1];
        ed[jj] = expf(seg) * dts[lo + jj];
      }
      for (int jj = jj_i + 1; jj < 16; ++jj) ed[jj] = 0.f;
      if (tid < kNb) {
        float v = 0.f;
        for (int t = 16 * tid; t < 16 * tid + 16; ++t) v += a_s[t];
        blk[tid] = v;
      }
    }
    __syncthreads();
    float total = 0.f;  // sum of the chunk's a: log of its decay
    for (int k = 0; k < kNb; ++k) total += blk[k];
    if (tid < Q) {
      const int ki = tid >> 4;
      float pre = 0.f, post = 0.f;
      for (int k = 0; k < ki; ++k) pre += blk[k];
      for (int k = ki + 1; k < kNb; ++k) post += blk[k];
      ei[tid] = expf(pin);
      gi[tid] = expf(pin + pre);
      ej[tid] = expf(suf) * dts[tid];
      wst[tid] = dts[tid] * expf(suf + post);
    }
    if (tid < kNb * kNb) {
      const int kb = tid / kNb, kj = tid % kNb;
      float v = 0.f;
      for (int k = kb + 1; k < kj; ++k) v += blk[k];
      em[kb * 16 + kj] = kb < kj ? expf(v) : 0.f;
    }
    // h_in in bf16 parts, N-major ([n][p], swizzled): the B operand of
    // the inter-chunk product.
    if (c > 0) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int n = 64 * g + 16 * warp + rq + 8 * ((e / 2) % 2);
        const int p = 8 * (e / 4) + cq;
        uint32_t parts[kParts];
        split_pair(st[e], st[e + 1], parts);
        const uint32_t off = sm90::swz128(n, p / 8) + (p % 8) * 2;
#pragma unroll
        for (int i = 0; i < kParts; ++i)
          *reinterpret_cast<uint32_t*>(base + L::kOffH + i * kHBytes + off) = parts[i];
      }
    }
    sm90::cp_async_wait<1>();  // x of chunk c
    sm90::fence_proxy_async();
    __syncthreads();

    // ---- y: this warpgroup's 64-row tiles ------------------------------
    const uint32_t xs_addr = sm90::smem_u32(base + (c % 2 ? L::kOffX1 : L::kOffX0));
    const uint64_t x_desc = sm90::desc_b128(xs_addr, Q * kRowBytes, kAtomBytes);
    const float* sc_base = scores + (static_cast<int64_t>(b) * nc + c) * Q * Q;
    // acc += F . x over the k-steps (16-step blocks) k0 .. k0 + 3, F the
    // fragments' bf16 parts: x is the N-major B operand.
    auto issue_x = [&](float (&acc)[32], int k0, Frags& f) {
#pragma unroll
      for (int i = kParts - 1; i >= 0; --i)  // the smallest parts first
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t r[4];
          part_regs(f, u, i, r);
          sm90::wgmma_m64n64k16_rs_tb(acc, r, x_desc + (((k0 + u) * 16 * kRowBytes) >> 4));
        }
    };
#pragma unroll 1
    for (int r = 0; r < kT; ++r) {
      const int owner = kT == 4 ? ((r == 0 || r == 3) ? 0 : 1) : r;
      if (owner != g || 64 * r >= qc) continue;
      const int i0 = 64 * r + 16 * warp + rq;  // this thread's rows i0, i0 + 8
      const int ki = 4 * r + warp;             // their 16-step block
      const float ei0 = ei[i0], ei1 = ei[i0 + 8];
      // The intra-chunk A fragments of the k-steps k0 .. k0 + 3: scores
      // (C_i . B_j) L_ij dt_j for j <= i, in parts. The loads of a group
      // are all issued before any is used; a block above the diagonal
      // (kb > ki, inside the diagonal tile: written, finite) is zeroed.
      struct ScoreRaw {
        float2 s[4][2][2];  // [k-step][row i0 / i0 + 8][columns j.. / j + 8..]
      } sraw;
      auto load_intra = [&](int k0, ScoreRaw& raw) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float* srow = sc_base + static_cast<int64_t>(i0 + 8 * rr) * Q + 16 * (k0 + u) + cq;
            raw.s[u][rr][0] = *reinterpret_cast<const float2*>(srow);
            raw.s[u][rr][1] = *reinterpret_cast<const float2*>(srow + 8);
          }
      };
      auto make_intra = [&](int k0, ScoreRaw& raw, Frags& f) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kb = k0 + u;
          const int j = 16 * kb + cq;
          float v[2][4];  // [row i0 / i0 + 8][columns j, j + 1, j + 8, j + 9]
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            v[rr][0] = raw.s[u][rr][0].x; v[rr][1] = raw.s[u][rr][0].y;
            v[rr][2] = raw.s[u][rr][1].x; v[rr][3] = raw.s[u][rr][1].y;
          }
          if (kb < ki) {
            const float m = em[kb * 16 + ki];
            const float e0 = ej[j], e1 = ej[j + 1], e8 = ej[j + 8], e9 = ej[j + 9];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const float fr = (rr ? ei1 : ei0) * m;
              v[rr][0] *= fr * e0; v[rr][1] *= fr * e1; v[rr][2] *= fr * e8; v[rr][3] *= fr * e9;
            }
          } else if (kb == ki) {
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const float* ed = ED + (i0 + 8 * rr) * 16;
              v[rr][0] *= ed[cq]; v[rr][1] *= ed[cq + 1];
              v[rr][2] *= ed[cq + 8]; v[rr][3] *= ed[cq + 9];
            }
          } else {
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
#pragma unroll
              for (int q = 0; q < 4; ++q) v[rr][q] = 0.f;
          }
          // a[0] row i0 cols j..; a[1] row i0 + 8; a[2], a[3] cols j + 8..
          split_pair(v[0][0], v[0][1], f.a[u][0]);
          split_pair(v[1][0], v[1][1], f.a[u][1]);
          split_pair(v[0][2], v[0][3], f.a[u][2]);
          split_pair(v[1][2], v[1][3], f.a[u][3]);
        }
      };

      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      uint32_t ca[kN / 16][4];
      if (c > 0) {  // inter: C_i h_in^T, C exact, issued first
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + 8 * (q % 2);
            const int n = 16 * kk + cq + 8 * (q / 2);
            ca[kk][q] = i < qc ? *reinterpret_cast<const uint32_t*>(Cm + (row0 + start + i) * kN + n)
                               : 0u;
          }
        sm90::wgmma_fence();
#pragma unroll
        for (int i = kParts - 1; i >= 0; --i)  // the smallest parts first
#pragma unroll
          for (int kk = 0; kk < kN / 16; ++kk)
            sm90::wgmma_m64n64k16_rs_tb(acc, ca[kk],
                                        h_desc + ((kk * 16 * kRowBytes + i * kHBytes) >> 4));
        sm90::wgmma_commit();
      }
      load_intra(0, sraw);  // in flight while the inter term runs
      if (c > 0) {
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) sm90::fence_regs(ca[kk]);
        const float g0 = gi[i0], g1 = gi[i0 + 8];
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] *= ((e / 2) % 2) ? g1 : g0;
      }
      pipeline(r + 1, acc, sraw, load_intra, make_intra, issue_x);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = i0 + 8 * rr;
        if (i >= qc) continue;
        float* yrow = y + ((row0 + start + i) * H + h) * kP;
#pragma unroll
        for (int e = 2 * rr; e < 32; e += 4)
          *reinterpret_cast<float2*>(yrow + 8 * (e / 4) + cq) = make_float2(acc[e], acc[e + 1]);
      }
    }

    // ---- state: h^T = exp(total) h^T + (w B)^T x ------------------------
    sm90::cp_async_wait<0>();  // B of chunk c
    __syncthreads();
    const float decay = expf(total);
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] *= decay;
    const int n0 = 64 * g + 16 * warp;
    const int mrow = lane % 8, mat = lane / 8;
    const uint8_t* lrow = Bs + (mrow + 8 * (mat / 2)) * kBLd + (n0 + 8 * (mat % 2)) * 2;
    // The A fragments of (w B)^T for the k-steps k0 .. k0 + 3, in parts.
    struct BRaw {
      uint32_t bt[4][4];  // [k-step][ldmatrix.trans registers]
    } braw;
    auto load_state = [&](int k0, BRaw& raw) {
#pragma unroll
      for (int u = 0; u < 4; ++u) sm90::ldmatrix_x4_trans(raw.bt[u], lrow + 16 * (k0 + u) * kBLd);
    };
    auto make_state = [&](int k0, BRaw& raw, Frags& f) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 16 * (k0 + u) + cq;
        const float w0 = wst[j], w1 = wst[j + 1], w8 = wst[j + 8], w9 = wst[j + 9];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = unpack_bf16(raw.bt[u][q]);
          const bool hi_cols = q >= 2;
          split_pair(v.x * (hi_cols ? w8 : w0), v.y * (hi_cols ? w9 : w1), f.a[u][q]);
        }
      }
    };
    load_state(0, braw);
    pipeline(Q / 64, st, braw, load_state, make_state, issue_x);
    __syncthreads();  // x buffer c % 2, the B tile and h_in are free
    load(c + 2 < nc ? c + 2 : -1, c + 1 < nc ? c + 1 : -1);
  }

  // h_fin (B, H, P, N): element (n, p) of h^T.
  float* hf = h_fin + static_cast<int64_t>(bh) * kP * kN;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int n = 64 * g + 16 * warp + rq + 8 * ((e / 2) % 2);
    const int p = 8 * (e / 4) + cq + e % 2;
    hf[p * kN + n] = st[e];
  }
}

template <int Q>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* h_fin, void* scores, int B, int64_t S, int H, cudaStream_t stream) {
  const int64_t nc64 = (S + Q - 1) / Q;
  if (nc64 > 65535 || static_cast<int64_t>(B) * H > 2147483647) return cudaErrorInvalidValue;
  const int nc = static_cast<int>(nc64);
  constexpr int kScoresSmem = 4 * 64 * kRowBytes + kAtomBytes;
  constexpr int kTiles = (Q / 64) * (Q / 64 + 1) / 2;
  cudaError_t err = cudaFuncSetAttribute(ssd_scores_kernel<Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kScoresSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_scan_tc_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<Q>::kBytes);
  if (err != cudaSuccess) return err;
  const auto* Bi = static_cast<const __nv_bfloat16*>(Bm);
  const auto* Ci = static_cast<const __nv_bfloat16*>(Cm);
  ssd_scores_kernel<Q><<<dim3(kTiles, nc, B), 128, kScoresSmem, stream>>>(
      Bi, Ci, static_cast<float*>(scores), S, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_scan_tc_kernel<Q><<<B * H, kThreads, Smem<Q>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), Bi, Ci, static_cast<const float*>(scores),
      static_cast<float*>(y), static_cast<float*>(h_fin), H, S, nc);
  return cudaGetLastError();
}

}  // namespace tc

// ---- the backward of the tensor-core body ---------------------------------
//
// The gradient of ssd_scan_tc_launch's function (the algebra is written
// out plainly in ref.py::ssd_scan_bwd_ref), in nine launches:
//   scores   tc::ssd_scores_kernel, s_ij = C_i . B_j per (b, chunk);
//   tables   per (b, h, chunk): the decay factors (direct segment sums),
//            g_i = exp(cum_i), e_j = exp(sum_{t > j} a_t), D;
//   states   per (b, h), chunks in order: h_in of each chunk (kParts bf16
//            parts, the [n][p] swizzled tile);
//   dstates  per (b, h), chunks last first: dh_out of each chunk, and
//            Zd = D <dh_out, h_in>;
//   dx       per (b, h, chunk): dx, x . dx / dt and the state term W_j;
//   ds       per (b, chunk, 64-row tile), the heads in order: the
//            head-summed dS and each head's intra-chunk log-decay sums;
//   dbc      per (b, chunk, 64-row tile), the heads in order: dC and dB
//            (the inter-chunk and state terms, then the dS products) and
//            the inter term Z_i;
//   da       per (b, h, chunk): da_t, ddt, and dt . da per (b, chunk, h);
//   dA       per head, the (b, chunk) partials in order.
// Every cross-head and cross-step sum runs in a fixed order (no atomics),
// so two runs give the same bits.
namespace bwd {

using tc::Frags;
using tc::kAtomBytes;
using tc::kBLd;
using tc::kHBytes;
using tc::kN;
using tc::kP;
using tc::kParts;
using tc::kRowBytes;
constexpr int kThreads = 256;
constexpr int kStateBytes = kParts * kHBytes;  // one (b, h, chunk) state in parts
// The order of the products of a float32 A (kParts parts) and a float32 B
// (kParts parts) whose sum is kept: parts ia + ib <= 2, the smallest first.
// (Functions, not arrays, so that an unrolled index folds to a constant and
// the fragment registers are never indexed at run time.)
constexpr int kPairs = 6;
__device__ __forceinline__ constexpr int pair_a(int pr) {
  return pr == 0 ? 2 : (pr == 1 || pr == 3) ? 1 : 0;
}
__device__ __forceinline__ constexpr int pair_b(int pr) {
  return pr == 2 ? 2 : (pr == 1 || pr == 4) ? 1 : 0;
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = sm90::smem_u32(raw);
  return raw + ((kAtomBytes - a % kAtomBytes) % kAtomBytes);
}

__device__ __forceinline__ uint32_t pack_bf16(float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Sum over the four lanes of a quad (the threads that share a fragment row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- decay tables of one (b, h, chunk) ------------------------------------
//
// Written once per (b, h, chunk) by the tables pass, every factor the
// exponential of a direct sum of a_t = dt_t A_h (all <= 0), dt = 0 from the
// chunk's qc valid steps on; a record of kRecFloats<Q> floats:
//   ei[i]  from i's 16-step block start to i;  ejn[j] after j to j's block end;
//   dts[t] = dt_t;
//   em[kb * 16 + ki] the blocks strictly between kb < ki (else 0);
//   EDn[i * 16 + jj] sum_{16 kb + jj < t <= i} within i's block kb (0 for
//   jj > i % 16);
// so L_ij = exp(sum_{j < t <= i} a_t) is decay_at(i, j).
template <int Q>
constexpr int kRecFloats = 3 * Q + 256 + 16 * Q;
struct Tables {
  const float *ei, *ejn, *dts, *em, *EDn;
};
template <int Q>
__device__ __forceinline__ Tables record_tables(const float* p) {
  return Tables{p, p + Q, p + 2 * Q, p + 3 * Q, p + 3 * Q + 256};
}

// L_ij = exp(sum_{j < t <= i} a_t) for j <= i, 0 for j > i.
__device__ __forceinline__ float decay_at(const Tables& T, int i, int j) {
  const int ki = i >> 4, kb = j >> 4;
  if (kb < ki) return T.ei[i] * T.em[kb * 16 + ki] * T.ejn[j];
  return kb == ki ? T.EDn[i * 16 + (j & 15)] : 0.f;
}

// One block per (b, h, chunk): the record, and g_i = exp(cum_i),
// e_j = exp(sum_{t > j} a_t) into (B, H, S) and D = exp(sum a) into
// (B, H, nc).
template <int Q>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_tables_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                      float* __restrict__ rec, float* __restrict__ GI, float* __restrict__ EJ,
                      float* __restrict__ Dc, int H, int64_t S, int nc) {
  constexpr int kNb = Q / 16;
  __shared__ float a_s[Q], blk[16];
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int64_t start = static_cast<int64_t>(c) * Q;
  const int qc = static_cast<int>(S - start < Q ? S - start : Q);
  const int64_t row = static_cast<int64_t>(b) * S + start, hrow = static_cast<int64_t>(bh) * S + start;
  float* R = rec + static_cast<int64_t>(blockIdx.x) * kRecFloats<Q>;
  float *ei = R, *ejn = R + Q, *dts = R + 2 * Q, *em = R + 3 * Q, *EDn = em + 256;
  if (tid < Q) {
    const float d = tid < qc ? dt[(row + tid) * H + h] : 0.f;
    a_s[tid] = d * A[h];
    dts[tid] = d;
  }
  __syncthreads();
  if (tid < kNb) {
    float v = 0.f;
    for (int t = 16 * tid; t < 16 * tid + 16; ++t) v += a_s[t];
    blk[tid] = v;
  }
  __syncthreads();
  if (tid < Q) {
    const int lo = tid & ~15, jj_i = tid & 15, ki = tid >> 4;
    float pin = 0.f, suf = 0.f, pre = 0.f, post = 0.f;
    for (int t = lo; t <= tid; ++t) pin += a_s[t];
    for (int t = tid + 1; t < lo + 16; ++t) suf += a_s[t];
    for (int k = 0; k < ki; ++k) pre += blk[k];
    for (int k = ki + 1; k < kNb; ++k) post += blk[k];
    ei[tid] = expf(pin);
    ejn[tid] = expf(suf);
    float* ed = EDn + tid * 16;
    ed[jj_i] = 1.f;
    float seg = 0.f;
    for (int jj = jj_i - 1; jj >= 0; --jj) {
      seg += a_s[lo + jj + 1];
      ed[jj] = expf(seg);
    }
    for (int jj = jj_i + 1; jj < 16; ++jj) ed[jj] = 0.f;
    if (tid < qc) {
      GI[hrow + tid] = expf(pin + pre);
      EJ[hrow + tid] = expf(suf + post);
    }
  }
  {
    const int kb = tid / 16, ki = tid % 16;  // kThreads == 256 entries
    const bool live = kb < ki && ki < kNb;
    float v = 0.f;
    if (live)
      for (int k = kb + 1; k < ki; ++k) v += blk[k];
    em[tid] = live ? expf(v) : 0.f;
  }
  if (tid == 0) {
    float total = 0.f;
    for (int k = 0; k < kNb; ++k) total += blk[k];
    Dc[static_cast<int64_t>(bh) * nc + c] = expf(total);
  }
}

// ---- moving tiles ---------------------------------------------------------

// The (P x N) state held as an h^T accumulator (rows n = 64 g + 16 warp +
// lane / 4 (+ 8), columns p) as kParts bf16 parts of the [n][p] swizzled
// tile at dst (global memory, kStateBytes): the layout the consumers copy
// into shared memory as it is.
__device__ __forceinline__ void store_state(const float (&st)[32], uint8_t* dst, int g, int warp,
                                            int lane) {
  const int rq = lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int n = 64 * g + 16 * warp + rq + 8 * ((e / 2) % 2);
    const int p = 8 * (e / 4) + cq;
    uint32_t parts[kParts];
    tc::split_pair(st[e], st[e + 1], parts);
    const uint32_t off = sm90::swz128(n, p / 8) + (p % 8) * 2;
#pragma unroll
    for (int i = 0; i < kParts; ++i)
      *reinterpret_cast<uint32_t*>(dst + i * kHBytes + off) = parts[i];
  }
}

// Copies one stored state (kStateBytes) into shared memory by cp.async
// (not committed).
__device__ __forceinline__ void copy_state(uint8_t* dst, const uint8_t* src) {
  for (int e = threadIdx.x; e < kStateBytes / 16; e += kThreads)
    sm90::cp_async_16(dst + 16 * e, src + 16 * e, true);
}

// Rows 0 .. Q - 1 of the chunk of gy (float32) for head h, each scaled by
// scale[r] (nullptr: 1), as kParts bf16 tiles [r][p] (swizzled), Q *
// kRowBytes apart, at dst (shared memory). Rows from qc on are zeros.
template <int Q>
__device__ void gy_parts(uint8_t* dst, const float* __restrict__ gy, int64_t row, int64_t H,
                         int h, int qc, const float* scale) {
  constexpr int kIters = Q * 8 / kThreads, kBatch = kIters < 4 ? kIters : 4;
#pragma unroll
  for (int it0 = 0; it0 < kIters; it0 += kBatch) {
    float4 raw[kBatch][2];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {  // every load of the batch in flight at once
      const int e = threadIdx.x + (it0 + u) * kThreads;
      const int r = e / 8, piece = e % 8;
      raw[u][0] = raw[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < qc) {
        const float4* src =
            reinterpret_cast<const float4*>(gy + ((row + r) * H + h) * kP + piece * 8);
        raw[u][0] = src[0];
        raw[u][1] = src[1];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = threadIdx.x + (it0 + u) * kThreads;
      const int r = e / 8, piece = e % 8;
      const float sc = scale && r < qc ? scale[r] : 1.f;
      const float v[8] = {raw[u][0].x * sc, raw[u][0].y * sc, raw[u][0].z * sc, raw[u][0].w * sc,
                          raw[u][1].x * sc, raw[u][1].y * sc, raw[u][1].z * sc, raw[u][1].w * sc};
      uint32_t w[kParts][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t parts[kParts];
        tc::split_pair(v[2 * q], v[2 * q + 1], parts);
#pragma unroll
        for (int i = 0; i < kParts; ++i) w[i][q] = parts[i];
      }
#pragma unroll
      for (int i = 0; i < kParts; ++i)
        *reinterpret_cast<uint4*>(dst + i * Q * kRowBytes + sm90::swz128(r, piece)) =
            make_uint4(w[i][0], w[i][1], w[i][2], w[i][3]);
    }
  }
}

// The 64-row tiles of a chunk a warpgroup takes (the forward's split: the
// first and last of four to warpgroup 0).
template <int Q>
__device__ __forceinline__ int tile_owner(int r) {
  constexpr int kT = Q / 64;
  return kT == 4 ? ((r == 0 || r == 3) ? 0 : 1) : r % 2;
}

// ---- states: the chunk-entry states, forward ------------------------------
//
// One block per (b, h) walks the chunks in order, as the forward's scan:
// the state h^T stays in registers (split across the two warpgroups) and is
// written, before each chunk's update, as h_in of that chunk (kParts
// bf16 parts, 48 KB a (b, h, chunk): 201 MB at the training step, B 8,
// S 2048, H 64; one layer's at a time, since remat recomputes the forward
// right before the backward). The update's weights dt_j e_j and decay D
// come from the tables pass.
template <int Q>
struct StatesSmem {
  static constexpr int kX = Q * kRowBytes;
  static constexpr int kOffX0 = 0, kOffX1 = kX, kOffB = 2 * kX;
  static constexpr int kOffTab = kOffB + Q * kBLd;  // wst [Q]
  static constexpr int kBytes = kOffTab + Q * 4 + kAtomBytes;
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

template <int Q>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_states_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                      const __nv_bfloat16* __restrict__ Bm, const float* __restrict__ EJ,
                      const float* __restrict__ Dc, uint8_t* __restrict__ Hs, int H, int64_t S,
                      int nc) {
  using L = StatesSmem<Q>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  uint8_t* Bs = base + L::kOffB;
  float* wst = reinterpret_cast<float*>(base + L::kOffTab);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid / 32) % 4, g = tid / 128;
  const int64_t row0 = static_cast<int64_t>(b) * S;

  auto load = [&](int cx, int cb) {  // the forward's: x of chunk cx, B of chunk cb
    if (cx >= 0) {
      const int64_t start = static_cast<int64_t>(cx) * Q;
      uint8_t* xs = base + (cx % 2 ? L::kOffX1 : L::kOffX0);
      for (int e = tid; e < Q * 8; e += kThreads) {
        const int r = e / 8, piece = e % 8;
        const int64_t t = start + r;
        const bool ok = t < S;
        sm90::cp_async_16(xs + sm90::swz128(r, piece),
                          x + ((row0 + (ok ? t : 0)) * H + h) * kP + piece * 8, ok);
      }
    }
    if (cb >= 0) {
      const int64_t start = static_cast<int64_t>(cb) * Q;
      for (int e = tid; e < Q * 16; e += kThreads) {
        const int r = e / 16, piece = e % 16;
        const int64_t t = start + r;
        const bool ok = t < S;
        sm90::cp_async_16(Bs + r * kBLd + piece * 16, Bm + (row0 + (ok ? t : 0)) * kN + piece * 8,
                          ok);
      }
    }
    sm90::cp_async_commit();
  };
  load(0, 0);
  load(nc > 1 ? 1 : -1, -1);

  float st[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) st[e] = 0.f;
  const int cq = 2 * (lane % 4);

  for (int c = 0; c < nc; ++c) {
    const int64_t start = static_cast<int64_t>(c) * Q;
    const int qc = static_cast<int>(S - start < Q ? S - start : Q);
    store_state(st, Hs + (static_cast<int64_t>(bh) * nc + c) * kStateBytes, g, warp, lane);
    if (tid < Q)
      wst[tid] = tid < qc ? dt[(row0 + start + tid) * H + h] *
                                EJ[static_cast<int64_t>(bh) * S + start + tid]
                          : 0.f;
    const float decay = Dc[static_cast<int64_t>(bh) * nc + c];
    sm90::cp_async_wait<0>();  // x and B of chunk c (and x of c + 1)
    sm90::fence_proxy_async();
    __syncthreads();

    // h^T = D h^T + (w B)^T x, as the forward.
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] *= decay;
    const uint32_t xs_addr = sm90::smem_u32(base + (c % 2 ? L::kOffX1 : L::kOffX0));
    const uint64_t x_desc = sm90::desc_b128(xs_addr, Q * kRowBytes, kAtomBytes);
    auto issue_x = [&](float (&acc)[32], int k0, Frags& f) {
#pragma unroll
      for (int i = kParts - 1; i >= 0; --i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t r[4];
          tc::part_regs(f, u, i, r);
          sm90::wgmma_m64n64k16_rs_tb(acc, r, x_desc + (((k0 + u) * 16 * kRowBytes) >> 4));
        }
    };
    const int n0 = 64 * g + 16 * warp;
    const int mrow = lane % 8, mat = lane / 8;
    const uint8_t* lrow = Bs + (mrow + 8 * (mat / 2)) * kBLd + (n0 + 8 * (mat % 2)) * 2;
    struct BRaw {
      uint32_t bt[4][4];
    } braw;
    auto load_state = [&](int k0, BRaw& raw) {
#pragma unroll
      for (int u = 0; u < 4; ++u) sm90::ldmatrix_x4_trans(raw.bt[u], lrow + 16 * (k0 + u) * kBLd);
    };
    auto make_state = [&](int k0, BRaw& raw, Frags& f) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 16 * (k0 + u) + cq;
        const float w0 = wst[j], w1 = wst[j + 1], w8 = wst[j + 8], w9 = wst[j + 9];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = tc::unpack_bf16(raw.bt[u][q]);
          const bool hi_cols = q >= 2;
          tc::split_pair(v.x * (hi_cols ? w8 : w0), v.y * (hi_cols ? w9 : w1), f.a[u][q]);
        }
      }
    };
    load_state(0, braw);
    tc::pipeline(Q / 64, st, braw, load_state, make_state, issue_x);
    __syncthreads();  // x buffer c % 2 and the B tile are free
    load(c + 2 < nc ? c + 2 : -1, c + 1 < nc ? c + 1 : -1);
  }
}

// ---- dstates: the state gradients, backward -------------------------------
//
// One block per (b, h) walks the chunks last first with dh^T in registers:
// dh_out(last) = gh, and at chunk c, after storing dh_out(c) (parts) and
// Zd = D <dh_out, h_in>, dh^T = D dh^T + sum_i C_i^T (g_i gy_i): A = C^T
// (exact bf16, ldmatrix.trans of the C tile), B = g gy in parts.
template <int Q>
struct DstatesSmem {
  static constexpr int kOffG = 0;                       // g gy: kParts x [Q][64]
  static constexpr int kOffC = kParts * Q * kRowBytes;  // C rows [Q][kBLd]
  static constexpr int kOffTab = kOffC + Q * kBLd;      // g [Q], warp sums [8]
  static constexpr int kBytes = kOffTab + (Q + 8) * 4 + kAtomBytes;
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

template <int Q>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dstates_kernel(const float* __restrict__ gy, const __nv_bfloat16* __restrict__ Cm,
                       const float* __restrict__ gh, const float* __restrict__ GI,
                       const float* __restrict__ Dc, const uint8_t* __restrict__ Hs,
                       uint8_t* __restrict__ dHs, float* __restrict__ ZD, int H, int64_t S,
                       int nc) {
  using L = DstatesSmem<Q>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  uint8_t* Cs = base + L::kOffC;
  float* gi = reinterpret_cast<float*>(base + L::kOffTab);
  float* red = gi + Q;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid / 32) % 4, g = tid / 128;
  const int64_t row0 = static_cast<int64_t>(b) * S;
  const int rq = lane / 4, cq = 2 * (lane % 4);

  float st[32];  // dh^T: rows n = 64 g + 16 warp + rq (+ 8), columns p
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int n = 64 * g + 16 * warp + rq + 8 * ((e / 2) % 2);
    const int p = 8 * (e / 4) + cq + e % 2;
    st[e] = gh ? gh[(static_cast<int64_t>(bh) * kP + p) * kN + n] : 0.f;
  }
  const uint64_t g_desc = sm90::desc_b128(sm90::smem_u32(base + L::kOffG), Q * kRowBytes,
                                          kAtomBytes);
  const int n0 = 64 * g + 16 * warp;
  const int mrow = lane % 8, mat = lane / 8;
  const uint8_t* lrow = Cs + (mrow + 8 * (mat / 2)) * kBLd + (n0 + 8 * (mat % 2)) * 2;

  for (int c = nc - 1; c >= 0; --c) {
    const int64_t start = static_cast<int64_t>(c) * Q;
    const int qc = static_cast<int>(S - start < Q ? S - start : Q);
    const int64_t sidx = (static_cast<int64_t>(bh) * nc + c) * kStateBytes;
    for (int e = tid; e < Q * 16; e += kThreads) {
      const int r = e / 16, piece = e % 16;
      const bool ok = r < qc;
      sm90::cp_async_16(Cs + r * kBLd + piece * 16,
                        Cm + (row0 + (ok ? start + r : 0)) * kN + piece * 8, ok);
    }
    sm90::cp_async_commit();
    store_state(st, dHs + sidx, g, warp, lane);
    // Zd: D <dh_out, h_in>, h_in from its parts at the same places.
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int n = 64 * g + 16 * warp + rq + 8 * ((e / 2) % 2);
      const int p = 8 * (e / 4) + cq;
      const uint32_t off = sm90::swz128(n, p / 8) + (p % 8) * 2;
      float2 v = make_float2(0.f, 0.f);
#pragma unroll
      for (int i = kParts - 1; i >= 0; --i) {
        const float2 part = tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(Hs + sidx + i * kHBytes + off));
        v.x += part.x;
        v.y += part.y;
      }
      dot += st[e] * v.x + st[e + 1] * v.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) red[tid / 32] = dot;
    if (tid < Q) gi[tid] = tid < qc ? GI[static_cast<int64_t>(bh) * S + start + tid] : 0.f;
    __syncthreads();
    const float D = Dc[static_cast<int64_t>(bh) * nc + c];
    if (tid == 0) {
      float v = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) v += red[w];
      ZD[static_cast<int64_t>(bh) * nc + c] = D * v;
    }
    gy_parts<Q>(base + L::kOffG, gy, row0 + start, H, h, qc, gi);
    sm90::cp_async_wait<0>();
    sm90::fence_proxy_async();
    __syncthreads();

#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] *= D;
#pragma unroll 1
    for (int k0 = 0; k0 < Q / 16; k0 += 4) {
      uint32_t ct[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) sm90::ldmatrix_x4_trans(ct[u], lrow + 16 * (k0 + u) * kBLd);
      sm90::wgmma_fence();
#pragma unroll
      for (int i = kParts - 1; i >= 0; --i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sm90::wgmma_m64n64k16_rs_tb(
              st, ct[u], g_desc + ((i * Q * kRowBytes + (k0 + u) * 16 * kRowBytes) >> 4));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
#pragma unroll
      for (int u = 0; u < 4; ++u) sm90::fence_regs(ct[u]);
    }
    __syncthreads();  // the C tile and the g gy parts are free
  }
}

// ---- dx: one (b, h, chunk) ------------------------------------------------
//
// Per 64-row tile of steps j (the warpgroups split the tiles):
//   q_j = dh_out B_j: A = B rows (exact), B = dh_out^T [n][p] in parts;
//   W_j = dt_j e_j x_j . q_j (the state term of the log-decay gradient);
//   dxhat_j = e_j q_j + sum_{i >= j} s_ij L_ij gy_i: A = (s L)^T in parts
//   (the scores read down their columns), B = gy [i][p] in parts, the six
//   products of parts that matter;
//   dx_j = dt_j dxhat_j (bf16, or float32 with out_f32), x_j . dxhat_j
//   (ddt's direct term).
template <int Q>
struct DxSmem {
  static constexpr int kOffG = 0;                       // gy: kParts x [Q][64]
  static constexpr int kOffH = kParts * Q * kRowBytes;  // dh_out: kParts x [128][64]
  static constexpr int kOffTab = kOffH + kStateBytes;   // the tables record, then e [Q]
  static constexpr int kBytes = kOffTab + (kRecFloats<Q> + Q) * 4 + kAtomBytes;
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

template <int Q>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dx_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ Bm,
                  const float* __restrict__ gy, const float* __restrict__ scores,
                  const float* __restrict__ rec, const float* __restrict__ EJ,
                  const uint8_t* __restrict__ dHs, void* __restrict__ dx,
                  float* __restrict__ DDT, float* __restrict__ Wo, int out_f32, int H,
                  int64_t S, int nc) {
  using L = DxSmem<Q>;
  constexpr int kT = Q / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  float* tab = reinterpret_cast<float*>(base + L::kOffTab);
  const Tables T = record_tables<Q>(tab);
  float* ej = tab + kRecFloats<Q>;

  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid / 32) % 4, g = tid / 128;
  const int rq = lane / 4, cq = 2 * (lane % 4);
  const int64_t start = static_cast<int64_t>(c) * Q;
  const int qc = static_cast<int>(S - start < Q ? S - start : Q);
  const int64_t row = static_cast<int64_t>(b) * S + start;  // (b, start)
  const int64_t jrow = static_cast<int64_t>(bh) * S + start;  // (b, h, start) in (B, H, S)

  copy_state(base + L::kOffH, dHs + (static_cast<int64_t>(bh) * nc + c) * kStateBytes);
  const float* R = rec + static_cast<int64_t>(blockIdx.x) * kRecFloats<Q>;
  for (int e = tid; e < kRecFloats<Q> / 4; e += kThreads)
    sm90::cp_async_16(tab + 4 * e, R + 4 * e, true);
  sm90::cp_async_commit();
  if (tid < Q) ej[tid] = tid < qc ? EJ[jrow + tid] : 0.f;
  gy_parts<Q>(base + L::kOffG, gy, row, H, h, qc, nullptr);
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  __syncthreads();

  const float* sc = scores + (static_cast<int64_t>(b) * nc + c) * Q * Q;
  const uint64_t h_desc = sm90::desc_b128(sm90::smem_u32(base + L::kOffH), kHBytes, kAtomBytes);
  const uint64_t g_desc = sm90::desc_b128(sm90::smem_u32(base + L::kOffG), Q * kRowBytes,
                                          kAtomBytes);
#pragma unroll 1
  for (int r = 0; r < kT; ++r) {
    if (tile_owner<Q>(r) != g || 64 * r >= qc) continue;
    const int j0 = 64 * r + 16 * warp + rq;  // this thread's rows j0, j0 + 8

    // q = dh_out B_j
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    uint32_t ba[kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + 8 * (q % 2);
        const int n = 16 * kk + cq + 8 * (q / 2);
        ba[kk][q] = j < qc ? *reinterpret_cast<const uint32_t*>(Bm + (row + j) * kN + n) : 0u;
      }
    sm90::wgmma_fence();
#pragma unroll
    for (int i = kParts - 1; i >= 0; --i)
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        sm90::wgmma_m64n64k16_rs_tb(acc, ba[kk],
                                    h_desc + ((kk * 16 * kRowBytes + i * kHBytes) >> 4));
    sm90::wgmma_commit();
    uint32_t xr[2][8];  // x_j, rows j0 / j0 + 8, columns 8 k + cq (pairs)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = j0 + 8 * rr;
        xr[rr][k] = j < qc ? *reinterpret_cast<const uint32_t*>(x + ((row + j) * H + h) * kP + 8 * k + cq)
                           : 0u;
      }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) sm90::fence_regs(ba[kk]);

    // W_j = dt_j e_j x_j . q_j; then acc = e_j q_j
    float xq[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int rr = (e / 2) % 2;
      const float2 xv = tc::unpack_bf16(xr[rr][e / 4]);
      xq[rr] += acc[e] * xv.x + acc[e + 1] * xv.y;
    }
    const float e0 = ej[j0], e1 = ej[j0 + 8];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float v = quad_sum(xq[rr]);
      const int j = j0 + 8 * rr;
      if (lane % 4 == 0 && j < qc) Wo[jrow + j] = T.dts[j] * (rr ? e1 : e0) * v;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] *= ((e / 2) % 2) ? e1 : e0;

    // + sum_{i >= j} s_ij L_ij gy_i, the k-steps (16-step blocks of i) from
    // this tile's first on.
    struct ScoreRaw {
      float s[4][2][4];  // [k-step][row j0 / j0 + 8][columns i: cq, +1, +8, +9]
    } sraw;
    auto load_intra = [&](int k0, ScoreRaw& raw) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 16 * (4 * r + k0 + u) + cq + (q & 1) + 8 * (q >> 1);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) raw.s[u][rr][q] = sc[static_cast<int64_t>(i) * Q + j0 + 8 * rr];
        }
    };
    auto make_intra = [&](int k0, ScoreRaw& raw, Frags& f) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 16 * (4 * r + k0 + u) + cq + (q & 1) + 8 * (q >> 1);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) v[rr][q] = raw.s[u][rr][q] * decay_at(T, i, j0 + 8 * rr);
        }
        tc::split_pair(v[0][0], v[0][1], f.a[u][0]);
        tc::split_pair(v[1][0], v[1][1], f.a[u][1]);
        tc::split_pair(v[0][2], v[0][3], f.a[u][2]);
        tc::split_pair(v[1][2], v[1][3], f.a[u][3]);
      }
    };
    auto issue_intra = [&](float (&d)[32], int k0, Frags& f) {
#pragma unroll
      for (int pr = 0; pr < kPairs; ++pr)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t a[4];
          tc::part_regs(f, u, pair_a(pr), a);
          sm90::wgmma_m64n64k16_rs_tb(
              d, a, g_desc + ((pair_b(pr) * Q * kRowBytes + (4 * r + k0 + u) * 16 * kRowBytes) >> 4));
        }
    };
    load_intra(0, sraw);
    tc::pipeline(kT - r, acc, sraw, load_intra, make_intra, issue_intra);

    // dx = dt_j dxhat (bf16) and x_j . dxhat
    float xd[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int rr = (e / 2) % 2;
      const float2 xv = tc::unpack_bf16(xr[rr][e / 4]);
      xd[rr] += acc[e] * xv.x + acc[e + 1] * xv.y;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float v = quad_sum(xd[rr]);
      const int j = j0 + 8 * rr;
      if (j >= qc) continue;
      if (lane % 4 == 0) DDT[jrow + j] = v;
      const float d = T.dts[j];
      const int64_t at = ((row + j) * H + h) * kP + cq;
#pragma unroll
      for (int e = 2 * rr; e < 32; e += 4) {
        if (out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(dx) + at + 8 * (e / 4)) =
              make_float2(d * acc[e], d * acc[e + 1]);
        else
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dx) + at + 8 * (e / 4)) =
              pack_bf16(d * acc[e], d * acc[e + 1]);
      }
    }
  }
}

// ---- ds: the head-summed dS and the intra-chunk log-decay sums ------------
//
// One block per (b, chunk, 64-row tile T of steps i), the heads in order.
// Per head: G_ij = gy_i . x_j for the tiles J <= T (A = gy rows in parts,
// B = x rows K-major, exact; the warpgroups split the J tiles), then
// F = L dt_j, dS += F G (registers, across heads), M = s F G, and the
// block's share of the intra-chunk log-decay gradient,
//   sum_{i in T, i >= t} sum_{j < t} M_ij   for t < 64 (T + 1),
// every sum direct:
//   t before T:  sum_{j < t} colsum(j), colsum(j) = sum_{i in T} M_ij
//                (column sums by shuffles, then one warp's running sum);
//   t in T:      sum_{i >= t} R_i + D(t), R_i = M's row sums over the tiles
//                before T, D(t) = sum_{i >= t} sum_{j < t} M_ij inside the
//                diagonal tile (that tile alone goes to shared memory: each
//                row's running sums, then column sums).
// Written per (b, chunk, T, head) for the da pass. The next head's x and gy
// rows and decay factors (all double-buffered) arrive by cp.async while
// this head's are used.
template <int Q>
struct DsSmem {
  static constexpr int kT = Q / 64, kSlots = (kT + 1) / 2;  // J tiles a warpgroup holds
  // decay factors of the block's rows and the chunk: ei [64], ejn [Q],
  // dts [Q], em [256], EDn [64][16]
  static constexpr int kFac = 64 + 2 * Q + 256 + 64 * 16;
  static constexpr int kOffX = 0;                           // x rows [2][Q][64], K-major
  static constexpr int kOffGy = 2 * Q * kRowBytes;          // gy rows [2][64][64] float32
  static constexpr int kOffFac = kOffGy + 2 * 64 * kP * 4;  // [2][kFac]
  static constexpr int kOffS = kOffFac + 2 * kFac * 4;      // each thread's scores
  static constexpr int kOffD = kOffS + kSlots * 32 * kThreads * 4;  // diagonal tile [64][65]
  static constexpr int kOffCol = kOffD + 64 * 65 * 4;       // column sums by warp [4][Q]
  static constexpr int kOffRow = kOffCol + 4 * Q * 4;       // row sums by warpgroup [2][64]
  static constexpr int kOffPre = kOffRow + 2 * 64 * 4;      // sum_{j < t} colsum [Q]
  static constexpr int kOffSuf = kOffPre + Q * 4;           // sum_{i >= t} R_i [64]
  static constexpr int kBytes = kOffSuf + 64 * 4 + kAtomBytes;
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

template <int Q>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_ds_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gy,
                  const float* __restrict__ scores, const float* __restrict__ rec,
                  float* __restrict__ dS, float* __restrict__ DAp, int H, int64_t S, int nc) {
  using L = DsSmem<Q>;
  constexpr int kT = L::kT, kSlots = L::kSlots, kFac = L::kFac;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  float* s_sm = reinterpret_cast<float*>(base + L::kOffS);
  float* Dsm = reinterpret_cast<float*>(base + L::kOffD);
  float* colp = reinterpret_cast<float*>(base + L::kOffCol);
  float* rowp = reinterpret_cast<float*>(base + L::kOffRow);
  float* colpre = reinterpret_cast<float*>(base + L::kOffPre);
  float* rsuf = reinterpret_cast<float*>(base + L::kOffSuf);

  const int T = kT - 1 - blockIdx.x % kT;  // the longest rows first
  const int bc = blockIdx.x / kT;
  const int c = bc % nc, b = bc / nc;
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid / 32) % 4, g = tid / 128;
  const int rq = lane / 4, cq = 2 * (lane % 4);
  const int64_t start = static_cast<int64_t>(c) * Q;
  const int qc = static_cast<int>(S - start < Q ? S - start : Q);
  const int64_t row = static_cast<int64_t>(b) * S + start;
  const int ncols = 64 * (T + 1);
  const int i0 = 64 * T + 16 * warp + rq;  // this thread's rows i0, i0 + 8
  const int ki = i0 >> 4;                  // their 16-step block

  // x rows 0 .. ncols - 1 (K-major), the tile's gy rows and the decay
  // factors of head hh, into buffer hh % 2.
  auto load_head = [&](int hh) {
    uint8_t* xs = base + L::kOffX + (hh % 2) * Q * kRowBytes;
    for (int e = tid; e < ncols * 8; e += kThreads) {
      const int r = e / 8, piece = e % 8;
      const bool ok = r < qc;
      sm90::cp_async_16(xs + sm90::swz128(r, piece),
                        x + ((ok ? row + r : row) * H + hh) * kP + piece * 8, ok);
    }
    float* gys = reinterpret_cast<float*>(base + L::kOffGy) + (hh % 2) * 64 * kP;
    for (int e = tid; e < 64 * 16; e += kThreads) {
      const int r = e / 16, piece = e % 16;
      const int i = 64 * T + r;
      const bool ok = i < qc;
      sm90::cp_async_16(gys + r * kP + piece * 4,
                        gy + ((ok ? row + i : row) * H + hh) * kP + piece * 4, ok);
    }
    float* fac = reinterpret_cast<float*>(base + L::kOffFac) + (hh % 2) * kFac;
    const float* R = rec + ((static_cast<int64_t>(b) * H + hh) * nc + c) * kRecFloats<Q>;
    for (int e = tid; e < kFac / 4; e += kThreads) {
      const int f = 4 * e;  // the record's element for smem element f
      const int src = f < 64 ? 64 * T + f                                  // ei
                    : f < 64 + 2 * Q ? Q + (f - 64)                        // ejn, dts
                    : f < 64 + 2 * Q + 256 ? 3 * Q + (f - 64 - 2 * Q)      // em
                    : 3 * Q + 256 + 64 * T * 16 + (f - 64 - 2 * Q - 256);  // EDn rows
      sm90::cp_async_16(fac + f, R + src, true);
    }
    sm90::cp_async_commit();
  };
  load_head(0);
  const float* sc = scores + (static_cast<int64_t>(b) * nc + c) * Q * Q;
  for (int J = g; J <= T; J += 2)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int i = i0 + 8 * ((e / 2) % 2);
      const int j = 64 * J + 8 * (e / 4) + cq;
      const float2 v = *reinterpret_cast<const float2*>(sc + static_cast<int64_t>(i) * Q + j);
      s_sm[((J / 2) * 32 + e) * kThreads + tid] = v.x;
      s_sm[((J / 2) * 32 + e + 1) * kThreads + tid] = v.y;
    }
  float dsr[kSlots][32];
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
#pragma unroll
    for (int e = 0; e < 32; ++e) dsr[k][e] = 0.f;

#pragma unroll 1
  for (int hh = 0; hh < H; ++hh) {
    sm90::cp_async_wait<0>();  // x, gy and factors of head hh
    sm90::fence_proxy_async();
    __syncthreads();
    if (hh + 1 < H) load_head(hh + 1);  // buffer (hh + 1) % 2: head hh - 1's, done
    const uint64_t xd0 = sm90::desc_b128(
        sm90::smem_u32(base + L::kOffX + (hh % 2) * Q * kRowBytes), 16, kAtomBytes);
    const float* gys = reinterpret_cast<const float*>(base + L::kOffGy) + (hh % 2) * 64 * kP;
    const float* fac = reinterpret_cast<const float*>(base + L::kOffFac) + (hh % 2) * kFac;
    const float *ei = fac, *ejn = fac + 64, *dts = fac + 64 + Q, *em = fac + 64 + 2 * Q;
    const float* ED = em + 256;
    Frags f;  // gy rows i0, i0 + 8 over the 64 columns p, in parts
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = i0 - 64 * T + 8 * (q % 2);
        const float2 v = *reinterpret_cast<const float2*>(gys + r * kP + 16 * u + cq + 8 * (q / 2));
        tc::split_pair(v.x, v.y, f.a[u][q]);
      }
    const float ei0 = ei[i0 - 64 * T], ei1 = ei[i0 - 64 * T + 8];
    float rsum[2] = {0.f, 0.f};  // this thread's part of R_i (rows i0, i0 + 8)
#pragma unroll
    for (int slot = 0; slot < kSlots; ++slot) {
      const int J = g + 2 * slot;
      if (J > T) break;
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      const uint64_t xd = xd0 + ((J * 64 * kRowBytes) >> 4);
      sm90::wgmma_fence();
#pragma unroll
      for (int i = kParts - 1; i >= 0; --i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t a[4];
          tc::part_regs(f, u, i, a);
          sm90::wgmma_m64n64k16_rs(acc, a, xd + ((u * 32) >> 4));
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      tc::fence_frags(f);
      // F_ij = L_ij dt_j column group by column group (8 columns, one
      // 16-step block kb), the factors of a column shared by both rows.
      float colv[16];  // this thread's two rows summed, column by column
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int kb = 4 * J + k / 2;
        const int j = 64 * J + 8 * k + cq;
        float F[2][2];  // [row][column j, j + 1]
        if (kb < ki) {
          const float m = em[kb * 16 + ki];
          const float w0 = ejn[j] * dts[j] * m, w1 = ejn[j + 1] * dts[j + 1] * m;
          F[0][0] = ei0 * w0; F[0][1] = ei0 * w1; F[1][0] = ei1 * w0; F[1][1] = ei1 * w1;
        } else if (kb == ki) {
          const float* ed0 = ED + (i0 - 64 * T) * 16 + (j & 15);
          const float* ed1 = ed0 + 8 * 16;
          F[0][0] = ed0[0] * dts[j]; F[0][1] = ed0[1] * dts[j + 1];
          F[1][0] = ed1[0] * dts[j]; F[1][1] = ed1[1] * dts[j + 1];
        } else {
          F[0][0] = F[0][1] = F[1][0] = F[1][1] = 0.f;
        }
        float m[2][2];
#pragma unroll
        for (int h2 = 0; h2 < 4; ++h2) {
          const int e = 4 * k + h2, rr = h2 / 2, cc = h2 % 2;
          const float fg = F[rr][cc] * acc[e];
          dsr[slot][e] += fg;
          m[rr][cc] = s_sm[(slot * 32 + e) * kThreads + tid] * fg;
        }
        if (J < T) {
          rsum[0] += m[0][0] + m[0][1];
          rsum[1] += m[1][0] + m[1][1];
          colv[2 * k] = m[0][0] + m[1][0];
          colv[2 * k + 1] = m[0][1] + m[1][1];
        } else {
#pragma unroll
          for (int h2 = 0; h2 < 4; ++h2)
            Dsm[(i0 - 64 * T + 8 * (h2 / 2)) * 65 + (j & 63) + h2 % 2] = m[h2 / 2][h2 % 2];
        }
      }
      if (J < T) {  // the column sums over this warp's 16 rows, then by warp
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          colv[q] += __shfl_xor_sync(0xffffffffu, colv[q], 4);
          colv[q] += __shfl_xor_sync(0xffffffffu, colv[q], 8);
          colv[q] += __shfl_xor_sync(0xffffffffu, colv[q], 16);
        }
        if (lane < 4)
#pragma unroll
          for (int q = 0; q < 16; ++q) colp[warp * Q + 64 * J + 8 * (q / 2) + cq + q % 2] = colv[q];
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float v = quad_sum(rsum[rr]);
      if (lane % 4 == 0) rowp[g * 64 + 16 * warp + rq + 8 * rr] = v;
    }
    __syncthreads();  // M's sums and diagonal tile are whole
    if (tid < 64) {  // each row of the diagonal tile: its sums before t
      float* mr = Dsm + tid * 65;
      float run = 0.f;
#pragma unroll 8
      for (int k = 0; k < 64; ++k) {
        const float v = mr[k];
        mr[k] = run;
        run += v;
      }
    } else if (tid < 96) {  // sum_{j < t} colsum(j) for t < 64 T: one warp
      const int n = 64 * T, per = n / 32;  // 0, 2, 4 or 6 columns a lane
      float loc[6], tot = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        loc[k] = 0.f;
        if (k < per) {
          const int j = lane * per + k;
          loc[k] = (colp[j] + colp[Q + j]) + (colp[2 * Q + j] + colp[3 * Q + j]);
          tot += loc[k];
        }
      }
      float incl = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += u;
      }
      float run = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) run = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        if (k < per) {
          colpre[lane * per + k] = run;
          run += loc[k];
        }
    } else if (tid < 128) {  // sum_{i >= t} R_i over the tile's 64 rows: one warp
      const int r = 62 - 2 * lane;  // lane 0 takes the last two rows
      const float v1 = rowp[r + 1] + rowp[64 + r + 1], v0 = rowp[r] + rowp[64 + r];
      const float tot = v0 + v1;
      float incl = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += u;
      }
      float after = __shfl_up_sync(0xffffffffu, incl, 1);  // the rows after r + 1
      if (lane == 0) after = 0.f;
      rsuf[r + 1] = after + v1;
      rsuf[r] = (after + v1) + v0;
    }
    __syncthreads();
    float* dap = DAp + ((static_cast<int64_t>(bc) * kT + T) * H + hh) * Q;
    if (tid < 64) {  // t in T: D(t) + sum_{i >= t} R_i
      float v4[4] = {0.f, 0.f, 0.f, 0.f};
      int r = tid;
      for (; r + 4 <= 64; r += 4)
#pragma unroll
        for (int q = 0; q < 4; ++q) v4[q] += Dsm[(r + q) * 65 + tid];
      for (; r < 64; ++r) v4[0] += Dsm[r * 65 + tid];
      dap[64 * T + tid] = ((v4[0] + v4[1]) + (v4[2] + v4[3])) + rsuf[tid];
    } else if (tid >= 128) {
      for (int t = tid - 128; t < 64 * T; t += 128) dap[t] = colpre[t];
    }
  }

  float* out = dS + (static_cast<int64_t>(b) * nc + c) * Q * Q;
#pragma unroll
  for (int slot = 0; slot < kSlots; ++slot) {
    const int J = g + 2 * slot;
    if (J > T) break;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int i = i0 + 8 * ((e / 2) % 2);
      const int j = 64 * J + 8 * (e / 4) + cq;
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(i) * Q + j) =
          make_float2(dsr[slot][e], dsr[slot][e + 1]);
    }
  }
}

// ---- dbc: dC and dB of one (b, chunk, 64-row tile), the heads in order ----
//
// Warpgroup 0 takes rows i (dC), warpgroup 1 rows j (dB) of the tile T.
// Per head (h_in and dh_out parts arrive by cp.async, a head ahead):
//   wg 0: v_i = h_in^T gy_i (A = gy rows in parts, B = h_in [n][p]
//         K-major in parts, six products), Z_i = g_i C_i . v_i, dC += g_i v_i;
//   wg 1: r_j = dh_out^T x_j (A = x rows, exact, B = dh_out [n][p] in
//         parts), dB += dt_j e_j r_j.
// Then the dS products: dC_i += sum_{j <= i} dS_ij B_j and dB_j +=
// sum_{i >= j} dS_ij C_i (A = dS or its transpose in parts, B = the B or
// C rows N-major, exact), and dC, dB are written in bf16.
template <int Q>
struct DbcSmem {
  static constexpr int kBuf = 2 * kStateBytes;  // h_in, then dh_out parts
  static constexpr int kOffC = 2 * kBuf;        // C rows of the tile [64][256 bytes]
  static constexpr int kTileBytes = 64 * kN * 2;  // a 64-row B or C tile, two 64-column atoms
  static constexpr int kBytes = kOffC + kTileBytes + kAtomBytes;
  static_assert(2 * (Q / 64) * kTileBytes <= 2 * kBuf, "the dS phase's tiles fit the buffers");
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

template <int Q>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dbc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                   const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
                   const float* __restrict__ gy, const float* __restrict__ GI,
                   const float* __restrict__ EJ, const uint8_t* __restrict__ Hs,
                   const uint8_t* __restrict__ dHs, const float* __restrict__ dS,
                   void* __restrict__ dBo, void* __restrict__ dCo, float* __restrict__ Zo,
                   int out_f32, int H, int64_t S, int nc) {
  using L = DbcSmem<Q>;
  constexpr int kT = Q / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  uint8_t* Csm = base + L::kOffC;

  const int T = blockIdx.x % kT;
  const int bc = blockIdx.x / kT;
  const int c = bc % nc, b = bc / nc;
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid / 32) % 4, g = tid / 128;
  const int rq = lane / 4, cq = 2 * (lane % 4);
  const int64_t start = static_cast<int64_t>(c) * Q;
  const int qc = static_cast<int>(S - start < Q ? S - start : Q);
  const int64_t row = static_cast<int64_t>(b) * S + start;
  const int r0 = 64 * T + 16 * warp + rq;  // this thread's rows r0, r0 + 8

  auto load_heads = [&](int hh) {
    uint8_t* dst = base + (hh % 2) * L::kBuf;
    const int64_t sidx = ((static_cast<int64_t>(b) * H + hh) * nc + c) * kStateBytes;
    copy_state(dst, Hs + sidx);
    copy_state(dst + kStateBytes, dHs + sidx);
    sm90::cp_async_commit();
  };
  // A head's A operand (wg 0: gy rows, float32; wg 1: x rows, bf16 pairs)
  // and row scales (wg 0: g_i; wg 1: dt_j e_j), loaded a head ahead.
  struct Rows {
    float2 a[4][4];
    float s0, s1;
  };
  auto load_rows = [&](int hh, Rows& out) {
    const int64_t hrow = (static_cast<int64_t>(b) * H + hh) * S + start;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = r0 + 8 * (q % 2);
        const int p = 16 * u + cq + 8 * (q / 2);
        out.a[u][q] = make_float2(0.f, 0.f);
        if (i < qc) {
          if (g == 0)
            out.a[u][q] = *reinterpret_cast<const float2*>(gy + ((row + i) * H + hh) * kP + p);
          else
            out.a[u][q].x = __uint_as_float(
                *reinterpret_cast<const uint32_t*>(x + ((row + i) * H + hh) * kP + p));
        }
      }
    out.s0 = out.s1 = 0.f;
    if (r0 < qc) out.s0 = g == 0 ? GI[hrow + r0] : dt[(row + r0) * H + hh] * EJ[hrow + r0];
    if (r0 + 8 < qc)
      out.s1 = g == 0 ? GI[hrow + r0 + 8] : dt[(row + r0 + 8) * H + hh] * EJ[hrow + r0 + 8];
  };
  load_heads(0);
  Rows nxt;
  load_rows(0, nxt);
  for (int e = tid; e < 64 * 16; e += kThreads) {
    const int r = e / 16, piece = e % 16;
    const int t = 64 * T + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < qc) v = *reinterpret_cast<const uint4*>(Cm + (row + t) * kN + piece * 8);
    *reinterpret_cast<uint4*>(Csm + r * kN * 2 + piece * 16) = v;
  }

  float acc[64];  // dC (wg 0) or dB (wg 1): rows r0, r0 + 8, columns n
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

#pragma unroll 1
  for (int hh = 0; hh < H; ++hh) {
    if (hh + 1 < H) load_heads(hh + 1);
    const int64_t hrow = (static_cast<int64_t>(b) * H + hh) * S + start;  // (b, hh, start)
    Frags f;  // wg 0: gy rows in parts; wg 1: x rows (part 0 only)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (g == 0)
          tc::split_pair(nxt.a[u][q].x, nxt.a[u][q].y, f.a[u][q]);
        else
          f.a[u][q][0] = __float_as_uint(nxt.a[u][q].x);
      }
    const float sc0 = nxt.s0, sc1 = nxt.s1;
    if (hh + 1 < H) load_rows(hh + 1, nxt);  // in flight during this head
    if (hh + 1 < H)
      sm90::cp_async_wait<1>();
    else
      sm90::cp_async_wait<0>();
    sm90::fence_proxy_async();
    __syncthreads();
    const uint32_t buf = sm90::smem_u32(base + (hh % 2) * L::kBuf);
    float v[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) v[e] = 0.f;
    sm90::wgmma_fence();
    if (g == 0) {
      const uint64_t hd = sm90::desc_b128(buf, 16, kAtomBytes);
#pragma unroll
      for (int pr = 0; pr < kPairs; ++pr)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t a[4];
          tc::part_regs(f, u, pair_a(pr), a);
          sm90::wgmma_m64n128k16_rs(v, a, hd + ((pair_b(pr) * kHBytes + u * 32) >> 4));
        }
    } else {
      const uint64_t dd = sm90::desc_b128(buf + kStateBytes, 16, kAtomBytes);
#pragma unroll
      for (int i = kParts - 1; i >= 0; --i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t a[4];
          tc::part_regs(f, u, 0, a);
          sm90::wgmma_m64n128k16_rs(v, a, dd + ((i * kHBytes + u * 32) >> 4));
        }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(v);
    tc::fence_frags(f);
    if (g == 0) {  // Z_i = g_i C_i . v_i
      float zc[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 64; e += 2) {
        const int rr = (e / 2) % 2;
        const int n = 8 * (e / 4) + cq;
        const float2 cv = tc::unpack_bf16(
            *reinterpret_cast<const uint32_t*>(Csm + (r0 - 64 * T + 8 * rr) * kN * 2 + n * 2));
        zc[rr] += v[e] * cv.x + v[e + 1] * cv.y;
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float z = quad_sum(zc[rr]);
        const int i = r0 + 8 * rr;
        if (lane % 4 == 0 && i < qc) Zo[hrow + i] = (rr ? sc1 : sc0) * z;
      }
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += (((e / 2) % 2) ? sc1 : sc0) * v[e];
    __syncthreads();  // buffer hh % 2 is free
  }

  // The dS products. Tiles of B (wg 0: J = 0 .. T) and C (wg 1: I = T ..
  // kT - 1) rows as N-major operands [k][128] in two 64-column atoms.
  auto tile_at = [&](int slot) { return base + slot * L::kTileBytes; };
  for (int e = tid; e < (kT + 1) * 64 * 16; e += kThreads) {
    const int slot = e / (64 * 16), r = (e / 16) % 64, piece = e % 16;
    // slots 0 .. T: B tiles J = slot; slots T + 1 .. kT: C tiles I = slot - 1
    const bool is_b = slot <= T;
    const int t = 64 * (is_b ? slot : slot - 1) + r;
    const bool ok = t < qc;
    sm90::cp_async_16(tile_at(slot) + (piece / 8) * (64 * kRowBytes) + sm90::swz128(r, piece % 8),
                      (is_b ? Bm : Cm) + (ok ? row + t : row) * kN + piece * 8, ok);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  __syncthreads();
  const float* ds = dS + (static_cast<int64_t>(b) * nc + c) * Q * Q;
  // wg 0: k-tiles J = 0 .. T (slot J); wg 1: I = T .. kT - 1 (slot I + 1)
  const int k_first = g == 0 ? 0 : T, k_last = g == 0 ? T : kT - 1;
#pragma unroll 1
  for (int K = k_first; K <= k_last; ++K) {
    Frags f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = q % 2;
        const int k = 64 * K + 16 * u + cq + 8 * (q / 2);  // columns k, k + 1
        float v0, v1;
        if (g == 0) {  // dS[i][k]
          const float2 v = *reinterpret_cast<const float2*>(ds + static_cast<int64_t>(r0 + 8 * rr) * Q + k);
          v0 = v.x;
          v1 = v.y;
        } else {  // dS[k][j]
          v0 = ds[static_cast<int64_t>(k) * Q + r0 + 8 * rr];
          v1 = ds[static_cast<int64_t>(k + 1) * Q + r0 + 8 * rr];
        }
        tc::split_pair(v0, v1, f.a[u][q]);
      }
    const uint64_t td = sm90::desc_b128(sm90::smem_u32(tile_at(g == 0 ? K : K + 1)),
                                        64 * kRowBytes, kAtomBytes);
    sm90::wgmma_fence();
#pragma unroll
    for (int i = kParts - 1; i >= 0; --i)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t a[4];
        tc::part_regs(f, u, i, a);
        sm90::wgmma_m64n128k16_rs_tb(acc, a, td + ((u * 16 * kRowBytes) >> 4));
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    tc::fence_frags(f);
  }
  void* out = g == 0 ? dCo : dBo;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int t = r0 + 8 * rr;
    if (t >= qc) continue;
    const int64_t at = (row + t) * kN + cq;
#pragma unroll
    for (int e = 2 * rr; e < 64; e += 4) {
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + at + 8 * (e / 4)) =
            make_float2(acc[e], acc[e + 1]);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + at + 8 * (e / 4)) =
            pack_bf16(acc[e], acc[e + 1]);
    }
  }
}

// ---- da: the log-decay gradient of one (b, h, chunk) ----------------------
//
// da_t = sum over the tiles T >= t's of the ds pass's sums + sum_{i >= t} Z_i
// + sum_{j < t} W_j + Zd; ddt_t = A_h da_t + x_t . dxhat_t; and
// sum_t dt_t da_t into (B, nc, H) for dA. Scans and sums in a fixed order.
__device__ float block_inclusive_scan(float v, float* warp_tot) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  float pre = 0.f;
  for (int w = 0; w < warp; ++w) pre += warp_tot[w];
  __syncthreads();
  return v + pre;
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_da_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ DAp, const float* __restrict__ Zo,
                  const float* __restrict__ Wo, const float* __restrict__ DDT,
                  const float* __restrict__ ZD, float* __restrict__ ddt,
                  float* __restrict__ dApart, int H, int64_t S, int nc) {
  constexpr int kT = Q / 64;
  __shared__ float zs[kThreads], ws[kThreads], warp_tot[kThreads / 32];
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H;
  const int t = threadIdx.x;
  const int64_t start = static_cast<int64_t>(c) * Q;
  const int qc = static_cast<int>(S - start < Q ? S - start : Q);
  const int64_t hrow = static_cast<int64_t>(bh) * S + start;
  // The suffix sums of Z (thread t scans step Q - 1 - t) and the prefix sums of W.
  const int tr = Q - 1 - t;
  const float zsuf = block_inclusive_scan(t < Q && tr < qc ? Zo[hrow + tr] : 0.f, warp_tot);
  const float wpre = block_inclusive_scan(t < qc ? Wo[hrow + t] : 0.f, warp_tot);
  if (t < Q) {
    zs[tr] = zsuf;
    ws[t] = wpre;
  }
  __syncthreads();
  float contrib = 0.f;
  if (t < qc) {
    float da = 0.f;
    for (int T = t / 64; T < kT; ++T)
      da += DAp[((static_cast<int64_t>(b * nc + c) * kT + T) * H + h) * Q + t];
    da += zs[t] + (t > 0 ? ws[t - 1] : 0.f) + ZD[static_cast<int64_t>(bh) * nc + c];
    const int64_t s_idx = (static_cast<int64_t>(b) * S + start + t) * H + h;
    ddt[s_idx] = A[h] * da + DDT[hrow + t];
    contrib = dt[s_idx] * da;
  }
  const float tot = block_inclusive_scan(contrib, warp_tot);
  if (t == kThreads - 1) dApart[static_cast<int64_t>(b * nc + c) * H + h] = tot;
}

// dA[h] = sum over (b, chunk) of the partials, in order.
__global__ void ssd_bwd_dA_kernel(const float* __restrict__ dApart, float* __restrict__ dA,
                                  int H, int n_bc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float v = 0.f;
  for (int k = 0; k < n_bc; ++k) v += dApart[static_cast<int64_t>(k) * H + h];
  dA[h] = v;
}

// The workspace of one call, carved from one buffer: offsets in bytes,
// each region 256-byte aligned.
struct Work {
  size_t scores, rec, hs, dhs, gi, ej, dc, zd, ds, dap, zo, wo, ddt, dapart, total;
};
inline Work layout(int B, int64_t S, int H, int Q) {
  const int64_t nc = (S + Q - 1) / Q, kT = Q / 64;
  Work w{};
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t off = at;
    at += (bytes + 255) / 256 * 256;
    return off;
  };
  const size_t bnc = static_cast<size_t>(B) * nc, bhs = static_cast<size_t>(B) * H * S;
  w.scores = take(bnc * Q * Q * 4);
  w.rec = take(bnc * H * (19 * static_cast<size_t>(Q) + 256) * 4);  // kRecFloats<Q>
  w.hs = take(bnc * H * kStateBytes);
  w.dhs = take(bnc * H * kStateBytes);
  w.gi = take(bhs * 4);
  w.ej = take(bhs * 4);
  w.dc = take(bnc * H * 4);
  w.zd = take(bnc * H * 4);
  w.ds = take(bnc * Q * Q * 4);
  w.dap = take(bnc * kT * H * Q * 4);
  w.zo = take(bhs * 4);
  w.wo = take(bhs * 4);
  w.ddt = take(bhs * 4);
  w.dapart = take(bnc * H * 4);
  w.total = at;
  return w;
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int Q>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* gy, const void* gh, void* dx, void* ddt, void* dA, void* dBm, void* dCm,
           int out_f32, void* work, int B, int64_t S, int H, cudaStream_t stream) {
  static_assert(kRecFloats<Q> == 19 * Q + 256, "the record size of layout()");
  const int64_t nc64 = (S + Q - 1) / Q;
  constexpr int kT = Q / 64;
  if (nc64 > 65535 || static_cast<int64_t>(B) * H * nc64 > 2147483647) return cudaErrorInvalidValue;
  const int nc = static_cast<int>(nc64);
  const Work w = layout(B, S, H, Q);
  auto* ws = static_cast<uint8_t*>(work);
  auto F = [&](size_t off) { return reinterpret_cast<float*>(ws + off); };
  const auto* xi = static_cast<const __nv_bfloat16*>(x);
  const auto* Bi = static_cast<const __nv_bfloat16*>(Bm);
  const auto* Ci = static_cast<const __nv_bfloat16*>(Cm);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* gyf = static_cast<const float*>(gy);

  constexpr int kScoresSmem = 4 * 64 * kRowBytes + kAtomBytes;
  constexpr int kTiles = kT * (kT + 1) / 2;
  cudaError_t err;
  if ((err = allow_smem(tc::ssd_scores_kernel<Q>, kScoresSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_states_kernel<Q>, StatesSmem<Q>::kBytes)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_dstates_kernel<Q>, DstatesSmem<Q>::kBytes)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_dx_kernel<Q>, DxSmem<Q>::kBytes)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_ds_kernel<Q>, DsSmem<Q>::kBytes)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_dbc_kernel<Q>, DbcSmem<Q>::kBytes)) != cudaSuccess) return err;

  tc::ssd_scores_kernel<Q><<<dim3(kTiles, nc, B), 128, kScoresSmem, stream>>>(Bi, Ci, F(w.scores), S, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_tables_kernel<Q><<<B * H * nc, kThreads, 0, stream>>>(dtf, Af, F(w.rec), F(w.gi),
                                                                F(w.ej), F(w.dc), H, S, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_states_kernel<Q><<<B * H, kThreads, StatesSmem<Q>::kBytes, stream>>>(
      xi, dtf, Bi, F(w.ej), F(w.dc), ws + w.hs, H, S, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dstates_kernel<Q><<<B * H, kThreads, DstatesSmem<Q>::kBytes, stream>>>(
      gyf, Ci, static_cast<const float*>(gh), F(w.gi), F(w.dc), ws + w.hs, ws + w.dhs, F(w.zd), H,
      S, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dx_kernel<Q><<<B * H * nc, kThreads, DxSmem<Q>::kBytes, stream>>>(
      xi, Bi, gyf, F(w.scores), F(w.rec), F(w.ej), ws + w.dhs, dx, F(w.ddt), F(w.wo), out_f32, H,
      S, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_ds_kernel<Q><<<B * nc * kT, kThreads, DsSmem<Q>::kBytes, stream>>>(
      xi, gyf, F(w.scores), F(w.rec), F(w.ds), F(w.dap), H, S, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dbc_kernel<Q><<<B * nc * kT, kThreads, DbcSmem<Q>::kBytes, stream>>>(
      xi, dtf, Bi, Ci, gyf, F(w.gi), F(w.ej), ws + w.hs, ws + w.dhs, F(w.ds), dBm, dCm, F(w.zo),
      out_f32, H, S, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_da_kernel<Q><<<B * H * nc, kThreads, 0, stream>>>(
      dtf, Af, F(w.dap), F(w.zo), F(w.wo), F(w.ddt), F(w.zd), static_cast<float*>(ddt),
      F(w.dapart), H, S, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dA_kernel<<<(H + 255) / 256, 256, 0, stream>>>(F(w.dapart), static_cast<float*>(dA), H,
                                                         B * nc);
  return cudaGetLastError();
}

}  // namespace bwd

}  // namespace

extern "C" {

// dtype: 0 float32, 2 bfloat16 (x, Bm, Cm); dt (B, S, H) and A (H,) float32.
// y (B, S, H, P) and h_fin (B, H, P, N) float32. Scratch: st (B, H, nc, N,
// P) and decay (B, H, nc) float32, nc = ceil(S / chunk).
int ssd_scan_launch(int dtype, const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* h_fin,
                    void* st, void* decay, int B, int64_t S, int H, int P,
                    int N, int chunk, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || P < 1 ||
      P > kMaxP || N < 1 || N > kMaxN || chunk < 1 || chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, h_fin, st, decay, B, S, H, P, N, chunk, s);
  if (dtype == 2)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h_fin, st, decay, B, S, H, P, N,
                                 chunk, s);
  return cudaErrorInvalidValue;
}

// The tensor-core body: bf16 x/Bm/Cm with P = 64, N = 128 and chunk 64,
// 128 or 256; dt (B, S, H), A (H,) float32; y (B, S, H, P) and h_fin
// (B, H, P, N) float32. Scratch: scores (B, nc, chunk, chunk) float32,
// nc = ceil(S / chunk).
int ssd_scan_tc_launch(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, void* y, void* h_fin, void* scores, int B,
                       int64_t S, int H, int chunk, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 64: return tc::launch<64>(x, dt, A, Bm, Cm, y, h_fin, scores, B, S, H, s);
    case 128: return tc::launch<128>(x, dt, A, Bm, Cm, y, h_fin, scores, B, S, H, s);
    case 256: return tc::launch<256>(x, dt, A, Bm, Cm, y, h_fin, scores, B, S, H, s);
    default: return cudaErrorInvalidValue;
  }
}

// Bytes of the workspace ssd_scan_bwd_tc_launch takes for these shapes.
size_t ssd_scan_bwd_tc_workspace(int B, int64_t S, int H, int chunk) {
  return bwd::layout(B, S, H, chunk).total;
}

// The gradient of ssd_scan_tc_launch's function: bf16 x/Bm/Cm with P = 64,
// N = 128 and chunk 64, 128 or 256; dt (B, S, H), A (H,), gy (B, S, H, P)
// and gh (B, H, P, N) float32 (gh null: zeros). Writes dx (B, S, H, P) and
// dBm, dCm (B, S, N) in bf16 (float32 where out_f32 is not 0), ddt (B, S,
// H) and dA (H,) in float32.
// work: ssd_scan_bwd_tc_workspace(B, S, H, chunk) bytes, 256-byte aligned.
int ssd_scan_bwd_tc_launch(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, const void* gy, const void* gh, void* dx, void* ddt,
                           void* dA, void* dBm, void* dCm, int out_f32, void* work, int B,
                           int64_t S, int H, int chunk, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 64:
      return bwd::launch<64>(x, dt, A, Bm, Cm, gy, gh, dx, ddt, dA, dBm, dCm, out_f32, work, B,
                              S, H, s);
    case 128:
      return bwd::launch<128>(x, dt, A, Bm, Cm, gy, gh, dx, ddt, dA, dBm, dCm, out_f32, work, B,
                              S, H, s);
    case 256:
      return bwd::launch<256>(x, dt, A, Bm, Cm, gy, gh, dx, ddt, dA, dBm, dCm, out_f32, work, B,
                              S, H, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
