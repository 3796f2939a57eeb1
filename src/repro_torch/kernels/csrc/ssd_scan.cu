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
//   Training does not take it yet: chip_smoke.py's bf16 training
//   comparison passes only a forward that rounds as the plain
//   ssd_chunked does, which this one (like the exact answer) does not
//   (ROADMAP.md, Queue 3).
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

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
