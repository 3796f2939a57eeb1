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
// Design (CUDA cores, float32 products; no wgmma/TMA yet). A TPU grid
// step carries the state from chunk to chunk in VMEM; here blocks run in
// parallel, so the scan is split in three launches:
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
// its own segment (reverse cumsums for the chunk state, 4-step block sums
// for the score tiles), not taken as cum_i - cum_j as the TPU kernel and
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

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
