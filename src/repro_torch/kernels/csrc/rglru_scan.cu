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
// Design: a chained scan over S that reads a and b once. The first
// design ran one thread per (b, w) channel over all of S: 8192 threads at
// the step above, 64 blocks on a 132-SM card, 0.84 TB/s. Here S is cut
// into chunks of kChunk steps and W into tiles of kThreads channels; one
// block per (chunk, b, tile), 4096 blocks at the step above:
//   1. the block loads its chunk of a and b into registers (all loads
//      issued before the first use) and reduces it, channel by channel,
//      to the pair (prod a, local h from 0): the reference's composition
//      (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2)
//      (src/repro/kernels/rglru_scan.py:41-52);
//   2. it publishes that aggregate, then looks back over the chunks
//      before it (decoupled look-back): an earlier chunk's inclusive
//      state ends the walk, its aggregate is composed in and the walk
//      goes on. Chunk 0 starts from h0 and publishes its inclusive state
//      at once, so every walk ends;
//   3. it publishes its own inclusive state and runs the recurrence over
//      the chunk from the carried-in state, out of registers, writing h.
// Blocks take their (chunk, b, tile) from an atomic ticket, chunk
// slowest, so a block only ever waits on blocks that already run: no
// deadlock whatever order the hardware starts them in. A reset kernel
// zeroes the ticket and the flags first (the scratch is the caller's).
// A ragged last chunk (S not a multiple of kChunk) and a ragged channel
// tile are masked: missing steps are identities (a = 1, b = 0).
//
// Backward (rglru_scan_bwd_launch): the gradient of the recurrence, the
// reverse recurrence
//   g_{S-1} = dh_{S-1} + dh_last,   g_t = dh_t + a_{t+1} g_{t+1}
//   db_t = g_t,   da_t = g_t h_{t-1} (h_{-1} = h0),   dh0 = a_0 g_0,
// from a, the forward's saved h and h0, in float32. The TPU kernel has no
// backward (the reference differentiates its jnp scan); this one is the
// forward's chained scan run from the end: the same chunks and tiles, the
// pair of a chunk composed from its last step to its first (its
// coefficient at step t is a_{t+1}, and 1 at t = S - 1, where dh_last
// enters as the state after the sequence), chunks ticketed from the last,
// the look-back walking towards the end. It reads a, dh and h once and
// writes da and db: 20 bytes an element (0.34 GB, 0.10 ms at the
// recurrentgemma-9b training step B 1, S 4096, W 4096). Bound: bytes.
//
// C interface (loaded with ctypes): pointers and the stream as void*, and
// the entry returns the first CUDA error of its launches (0 when all went).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 32;     // steps per block

// Scratch layout: ints [ticket, flags...], then float2 aggregates and float
// inclusive states, one per (chunk, b, w).
struct Scratch {
  int* ints;
  float2* agg;
  float* inc;
};

__host__ __device__ inline int64_t align16(int64_t n) { return (n + 15) & ~int64_t{15}; }

__host__ __device__ inline int64_t n_flags(int B, int64_t S, int64_t W) {
  return ((S + kChunk - 1) / kChunk) * B * ((W + kThreads - 1) / kThreads);
}

__host__ __device__ inline Scratch carve(void* p, int B, int64_t S, int64_t W) {
  char* base = static_cast<char*>(p);
  const int64_t slots = ((S + kChunk - 1) / kChunk) * B * W;
  const int64_t off_agg = align16((1 + n_flags(B, S, W)) * 4);
  return {reinterpret_cast<int*>(base), reinterpret_cast<float2*>(base + off_agg),
          reinterpret_cast<float*>(base + off_agg + slots * 8)};
}

int64_t scratch_bytes(int B, int64_t S, int64_t W) {
  const int64_t slots = ((S + kChunk - 1) / kChunk) * B * W;
  return align16((1 + n_flags(B, S, W)) * 4) + slots * 12;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Flag states of a (chunk, b, tile): 0 nothing yet, 1 aggregate, 2 inclusive.
__device__ __forceinline__ void publish(int* flag, int state) {
  __threadfence();  // each thread's values before the flag
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(flag, state);
}

__global__ void rglru_scan_reset_kernel(int* ints, int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    ints[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, void* scratch, int B, int64_t S,
                  int64_t W) {
  const Scratch sc = carve(scratch, B, S, W);
  const int nW = static_cast<int>((W + kThreads - 1) / kThreads);
  const int nS = static_cast<int>((S + kChunk - 1) / kChunk);
  const int per_chunk = B * nW;
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(sc.ints, 1);
  __syncthreads();
  const int ticket = s_ticket;
  const int k = ticket / per_chunk, rem = ticket % per_chunk;
  const int bi = rem / nW, wt = rem % nW;
  const int64_t w = static_cast<int64_t>(wt) * kThreads + threadIdx.x;
  const bool live = w < W;
  const int64_t t0 = static_cast<int64_t>(k) * kChunk;
  const int n = static_cast<int>(S - t0 < kChunk ? S - t0 : kChunk);
  const int64_t base = (static_cast<int64_t>(bi) * S + t0) * W + w;

  float av[kChunk], bv[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool in = live && u < n;
    av[u] = in ? a[base + u * W] : 1.f;
    bv[u] = in ? b[base + u * W] : 0.f;
  }
  float prod = 1.f, loc = 0.f;  // the chunk's pair (prod a, h from 0)
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    loc = fmaf(av[u], loc, bv[u]);
    prod *= av[u];
  }

  const int64_t slot = (static_cast<int64_t>(k) * B + bi) * W + w;
  int* flags = sc.ints + 1;
  const int fslot = k * per_chunk + bi * nW + wt;
  float carry = 0.f;
  if (k == 0) {
    if (live && h0 != nullptr) carry = h0[static_cast<int64_t>(bi) * W + w];
  } else {
    if (live) sc.agg[slot] = make_float2(prod, loc);
    publish(&flags[fslot], 1);
    // Look back: (pa, pb) composes chunks j + 1 .. k - 1, so that the state
    // entering chunk k is pa * h_j + pb for h_j the state after chunk j.
    float pa = 1.f, pb = 0.f;
    const long long start = clock64();
    for (int j = k - 1;; --j) {
      const int* f = &flags[j * per_chunk + bi * nW + wt];
      int state;
      while ((state = ld_acquire(f)) == 0) {
        if (clock64() - start > (1LL << 34)) __trap();  // a lost publish
        __nanosleep(32);
      }
      const int64_t js = (static_cast<int64_t>(j) * B + bi) * W + w;
      if (state == 2) {
        carry = live ? fmaf(pa, __ldcg(&sc.inc[js]), pb) : 0.f;
        break;
      }
      const float2 p = live ? __ldcg(&sc.agg[js]) : make_float2(1.f, 0.f);
      pb = fmaf(pa, p.y, pb);
      pa *= p.x;
    }
  }
  if (k + 1 < nS) {
    if (live) sc.inc[slot] = fmaf(prod, carry, loc);
    publish(&flags[fslot], 2);
  }

  if (!live) return;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    if (u < n) {
      carry = fmaf(av[u], carry, bv[u]);
      h[base + u * W] = carry;
    }
  }
  if (k == nS - 1) h_last[static_cast<int64_t>(bi) * W + w] = carry;
}


// The reverse scan. Chunk k covers steps t0 .. t0 + n - 1; its pair maps
// the state after the chunk (g_{t0 + n}, or dh_last after the last chunk)
// to g_{t0}: g_{t0} = prod * G + loc.
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ h0, const float* __restrict__ dh,
                      const float* __restrict__ dh_last, float* __restrict__ da,
                      float* __restrict__ db, float* __restrict__ dh0,
                      void* scratch, int B, int64_t S, int64_t W) {
  const Scratch sc = carve(scratch, B, S, W);
  const int nW = static_cast<int>((W + kThreads - 1) / kThreads);
  const int nS = static_cast<int>((S + kChunk - 1) / kChunk);
  const int per_chunk = B * nW;
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(sc.ints, 1);
  __syncthreads();
  const int ticket = s_ticket;
  const int k = nS - 1 - ticket / per_chunk, rem = ticket % per_chunk;
  const int bi = rem / nW, wt = rem % nW;
  const int64_t w = static_cast<int64_t>(wt) * kThreads + threadIdx.x;
  const bool live = w < W;
  const int64_t t0 = static_cast<int64_t>(k) * kChunk;
  const int n = static_cast<int>(S - t0 < kChunk ? S - t0 : kChunk);
  const int64_t base = (static_cast<int64_t>(bi) * S + t0) * W + w;

  // cv[u]: the coefficient of step t0 + u (a_{t+1}, 1 at the last step);
  // missing steps are identities (c = 1, dh = 0).
  float cv[kChunk], dv[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool in = live && u < n;
    cv[u] = in && t0 + u + 1 < S ? a[base + (u + 1) * W] : 1.f;
    dv[u] = in ? dh[base + u * W] : 0.f;
  }
  float prod = 1.f, loc = 0.f;
#pragma unroll
  for (int u = kChunk - 1; u >= 0; --u) {
    loc = fmaf(cv[u], loc, dv[u]);
    prod *= cv[u];
  }

  const int64_t slot = (static_cast<int64_t>(k) * B + bi) * W + w;
  int* flags = sc.ints + 1;
  const int fslot = k * per_chunk + bi * nW + wt;
  float carry = 0.f;
  if (k == nS - 1) {
    if (live && dh_last != nullptr) carry = dh_last[static_cast<int64_t>(bi) * W + w];
  } else {
    if (live) sc.agg[slot] = make_float2(prod, loc);
    publish(&flags[fslot], 1);
    // Look back towards the end: (pa, pb) composes chunks k + 1 .. j - 1.
    float pa = 1.f, pb = 0.f;
    const long long start = clock64();
    for (int j = k + 1;; ++j) {
      const int* f = &flags[j * per_chunk + bi * nW + wt];
      int state;
      while ((state = ld_acquire(f)) == 0) {
        if (clock64() - start > (1LL << 34)) __trap();  // a lost publish
        __nanosleep(32);
      }
      const int64_t js = (static_cast<int64_t>(j) * B + bi) * W + w;
      if (state == 2) {
        carry = live ? fmaf(pa, __ldcg(&sc.inc[js]), pb) : 0.f;
        break;
      }
      const float2 p = live ? __ldcg(&sc.agg[js]) : make_float2(1.f, 0.f);
      pb = fmaf(pa, p.y, pb);
      pa *= p.x;
    }
  }
  if (k > 0) {
    if (live) sc.inc[slot] = fmaf(prod, carry, loc);
    publish(&flags[fslot], 2);
  }

  if (!live) return;
#pragma unroll
  for (int u = kChunk - 1; u >= 0; --u) {
    if (u < n) {
      carry = fmaf(cv[u], carry, dv[u]);
      const int64_t t = t0 + u;
      const float prev = t > 0 ? h[base + (u - 1) * W]
                         : h0 != nullptr ? h0[static_cast<int64_t>(bi) * W + w]
                                         : 0.f;
      db[base + u * W] = carry;
      da[base + u * W] = carry * prev;
    }
  }
  if (k == 0 && dh0 != nullptr)
    dh0[static_cast<int64_t>(bi) * W + w] = a[base] * carry;
}

}  // namespace

extern "C" {

// Bytes of scratch rglru_scan_launch needs for (B, S, W).
int64_t rglru_scan_scratch_bytes(int B, int64_t S, int64_t W) {
  return scratch_bytes(B, S, W);
}

// h (B, S, W) and h_last (B, W), float32; h0 (B, W) or null for zeros;
// scratch: rglru_scan_scratch_bytes(B, S, W) bytes, 16-byte aligned, any
// contents (it is reset here).
int rglru_scan_launch(const void* a, const void* b, const void* h0, void* h,
                      void* h_last, void* scratch, int B, int64_t S, int64_t W,
                      void* stream) {
  if (B < 1 || B > 65535 || S < 1 || W < 1) return cudaErrorInvalidValue;
  const int64_t blocks = n_flags(B, S, W);
  if (blocks > 2147483647 || S > (1LL << 40)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t n_ints = 1 + blocks;
  const int64_t reset_blocks = (n_ints + 255) / 256 < 1024 ? (n_ints + 255) / 256 : 1024;
  rglru_scan_reset_kernel<<<static_cast<unsigned>(reset_blocks), 256, 0, s>>>(
      static_cast<int*>(scratch), n_ints);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), scratch, B, S, W);
  return static_cast<int>(cudaGetLastError());
}

// Gradient of rglru_scan_launch's recurrence: da, db (B, S, W) float32 and,
// when dh0 is not null, dh0 (B, W), from a, the forward's h (B, S, W), h0
// (B, W) or null for zeros, dh (B, S, W) and dh_last (B, W) or null for
// zeros. scratch: rglru_scan_scratch_bytes(B, S, W) bytes, as above.
int rglru_scan_bwd_launch(const void* a, const void* h, const void* h0,
                          const void* dh, const void* dh_last, void* da,
                          void* db, void* dh0, void* scratch, int B, int64_t S,
                          int64_t W, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || W < 1) return cudaErrorInvalidValue;
  const int64_t blocks = n_flags(B, S, W);
  if (blocks > 2147483647 || S > (1LL << 40)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t n_ints = 1 + blocks;
  const int64_t reset_blocks = (n_ints + 255) / 256 < 1024 ? (n_ints + 255) / 256 : 1024;
  rglru_scan_reset_kernel<<<static_cast<unsigned>(reset_blocks), 256, 0, s>>>(
      static_cast<int*>(scratch), n_ints);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_scan_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(dh),
      static_cast<const float*>(dh_last), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), scratch, B, S, W);
  return static_cast<int>(cudaGetLastError());
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
