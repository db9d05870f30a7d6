// The device body that the grouped (selective_scan_bwd.cu) and the
// batch-folded (selective_scan_folded_bwd.cu) selective-scan backwards
// share, written for sm_90a. The two differ only in where their operands
// lie, which each kernel describes to this body with a Group per 64-thread
// group; the design is that of selective_scan_bidir_bwd.cu (see the notes
// in both kernels' sources).
//
// Per direction and channel (raw = delta + delta_bias, dt = softplus(raw)
// or raw, a_t = exp(dt_t A)), walking the scan order in reverse:
//   e_t   = C_t g_t + a_next e_next                        (dL/dx_t)
//   dΔ_t  = (sum_n e a x_prev A + sum_n e B u) * sigmoid(raw_t)  (softplus)
//   du_t  = sum_n e B dt + D g
//   dB_t  = sum_d e dt u,   dC_t = sum_d x_t g
//   dA    = sum_t e a x_prev dt,  dD = sum_t g u,  dΔbias = sum_t dΔ
//
// A block is 128 threads: two groups of 16 channels, 4 lanes per channel
// (lane = 8 * q + c8 holds states 4q..4q+3 of channel c8 of its warp).
// The groups are either
//   * a pair (kPair): one direction each over the same channels of one data
//     stream, the second in reversed time; they walk data time in opposite
//     orders in lockstep and merge du (the first visitor of a chunk stores
//     its fp32 du, the second adds onto it, the middle chunk is summed in
//     shared memory); each writes its own dB/dC partial; or
//   * two halves of 32 channels of one sequence, both forward in time; du
//     is written straight and one dB/dC partial is written for the block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace scan_bwd {

constexpr int kN = 16;            // d_state
constexpr int kLanes = 4;         // lanes per channel
constexpr int kNS = kN / kLanes;  // states per lane
constexpr int kCh = 16;           // channels per group
constexpr int kGroup = kCh * kLanes;  // threads per group (64)
constexpr int kWarps = kGroup / 32;   // warps per group
constexpr int kThreads = 2 * kGroup;  // two groups per block
constexpr int kMinBlocks = 5;     // resident blocks per SM to fit registers to
constexpr int kChunk = 16;        // = the forward's state-saving chunk
constexpr int kHalf = kChunk / 2;  // steps whose states a thread holds
constexpr int kRows = kGroup / kCh;  // chunk rows one staging pass covers
constexpr int kElems = kChunk / kRows;  // per-channel values a thread stages
constexpr int kBC = kChunk * kN / kGroup;  // B (and C) values it stages
constexpr int kRed = kChunk * 2 * kN / kGroup;  // dB|dC sums a group writes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kChunk % kRows == 0 && (kChunk * kN) % kGroup == 0, "staging");
static_assert(kCh * kN / 4 == kGroup, "one 16-byte state copy per thread");

// Flags the launcher sets from the shapes and the pointers' alignment.
enum : int {
  kPairs = 1,  // u, delta, gy copied by 4-byte values (bf16: channel pairs)
  kBCVec = 2,  // B/C copied 16 bytes at a time (16-byte aligned)
  kCSVec = 4,  // entry-state rows copied 16 bytes (4 channels) at a time
};

inline bool aligned(const void* p, std::size_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

struct GroupSmem {
  float dt[kChunk][kCh];   // softplus(raw), by data-order slot
  float du[kChunk][kCh];   // dt * u
  float u[kChunk][kCh];
  float g[kChunk][kCh];    // the cotangent of y
  float sig[kChunk][kCh];  // sigmoid(raw), or 1 without softplus
  float B[kChunk][kN];
  float C[kChunk][kN];
  float ddt[kChunk][kCh];  // outputs of the chunk, by data-order slot
  float dub[kChunk][kCh];
  float red[kWarps][kChunk][2 * kN];  // per-warp dB|dC sums by slot
};

// One chunk's inputs as they lie in device memory, copied in while the
// previous chunk computes.
template <typename T>
struct alignas(16) RawSmem {
  T u[kChunk][kCh];
  T delta[kChunk][kCh];
  T g[kChunk][kCh];
  T B[kChunk][kN];
  T C[kChunk][kN];
  float cs[kN][kCh];  // the chunk's entry states, by state (the cs layout)
};
constexpr int kSmem =
    static_cast<int>(2 * sizeof(GroupSmem) + 2 * sizeof(RawSmem<float>));

// Where one group's operands lie. Each pointer is at the group's first
// channel (or its sequence's first step): per-channel values (t, c) at
// t * ts + c; B/C values (t, n) at t * kN + n; entry states (data chunk k,
// state n, channel c) at (k * kN + n) * cns + c; the dB/dC partial (t, n)
// at t * kN + n; A (c, n) at c * kN + n, and dA, g_last and dx_init
// likewise; D, bias, dD, dΔbias at c. g_last, the cotangent of the state
// after the last step, is null for none (zero); dx_init, the cotangent
// carried past the first step (that of an incoming state), is null when
// not wanted. The *_base pointers are the tensors' own, valid and
// aligned, read by no copy (the source of a zero-filling cp.async).
template <typename T, typename DuT>
struct Group {
  const T* u;
  const T* delta;
  const T* gy;
  const T* B;
  const T* C;
  const float* cs;
  DuT* du;
  T* ddelta;
  float* dB;
  float* dC;
  const float* A;
  const float* D;
  const float* bias;
  float* dA;
  float* dD;
  float* ddb;
  const float* g_last;
  float* dx_init;
  const T* u_base;
  const T* B_base;
  const float* cs_base;
  int ts, cns;
  int nvalid;  // channels of the group below dg (none when <= 0)
};

// cp.async of 4 or 16 bytes from device to shared memory; `bytes` = 0
// writes zeros (the source is not read).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 2^x by the SFU, flushing results below 2^-126 to zero: a gate that
// small scales the state to nothing either way, and the flush saves the
// subnormal fix-up around each exp2f
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// One level of the transposing warp sum over lane bit W: lanes with bit W
// set keep the upper W values and send the lower W; the partner does the
// opposite.
template <int W>
__device__ __forceinline__ void transpose_sum_level(float (&v)[2 * kNS],
                                                    int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// After this, v[0] of lane l is the sum of v[l & 7] over the 8 lanes that
// share l's state quarter (l >> 3), that is over the warp's 8 channels.
__device__ __forceinline__ float transpose_sum(float (&v)[2 * kNS],
                                               int lane) {
  transpose_sum_level<4>(v, lane);
  transpose_sum_level<2>(v, lane);
  transpose_sum_level<1>(v, lane);
  return v[0];
}

// The backward of this thread's group over the whole sequence; every
// thread of the block calls it (it has block barriers). `flags` are the
// launcher's (kPairs, kBCVec, kCSVec).
template <bool kPair, typename T, typename DuT>
__device__ __forceinline__ void group_bwd(const Group<T, DuT>& io, int L,
                                          bool apply_softplus, int flags,
                                          unsigned char* smem_raw) {
  GroupSmem* smem = reinterpret_cast<GroupSmem*>(smem_raw);
  const int r = threadIdx.x / kGroup;  // pair: 1 is the reversed direction
  const int gt = threadIdx.x % kGroup;
  const int lane = gt & 31;
  const int warp = gt >> 5;            // warp in the group
  const int q = lane >> 3;             // state quarter: states 4q..4q+3
  const int c8 = lane & 7;
  const int c = warp * 8 + c8;         // scanned channel in the group
  const bool active = c < io.nvalid;
  const int sc = gt % kCh;    // staged channel in the group
  const int row = gt / kCh;   // first staged chunk row
  const bool stage_active = sc < io.nvalid;
  const bool rev = kPair && r == 1;
  const int nc = (L + kChunk - 1) / kChunk;
  GroupSmem& sm = smem[r];
  RawSmem<T>& raw = reinterpret_cast<RawSmem<T>*>(
      smem_raw + 2 * sizeof(GroupSmem))[r];
  const bool pairs = flags & kPairs;

  // carry: the cotangent of the state after the step being reversed,
  // from the steps after it; it starts from g_last (null: zero), the null
  // test uniform per launch
  const bool adj_in = io.g_last != nullptr && active;
  float a2[kNS], carry[kNS], dA[kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    a2[j] = active ? io.A[c * kN + kNS * q + j] * kLog2e : 0.f;
    carry[j] = adj_in ? io.g_last[c * kN + kNS * q + j] : 0.f;
    dA[j] = 0.f;
  }
  float skip = 0.f, bias = 0.f;  // skip of the scanned, bias of the staged
  if (active) skip = io.D[c];
  if (stage_active) bias = io.bias[sc];
  float dD = 0.f, ddb = 0.f;

  // data start of the chunk this group computes at iteration i: the scan
  // order's chunks from the last
  auto chunk_t0 = [&](int i) { return (rev ? i : nc - 1 - i) * kChunk; };

  // start copying chunk i's inputs into `raw`
  auto stage = [&](int i) {
    const int t0 = chunk_t0(i);
    const int len = min(kChunk, L - t0);
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
      const int s = row + kRows * j;
      const bool ok = stage_active && s < len;
      const size_t off = (size_t)(t0 + s) * io.ts + sc;
      if (pairs) {  // bf16 by pairs of channels from an even one
        if (sizeof(T) == 4 || sc % 2 == 0) {
          cp_async_4(&raw.u[s][sc], ok ? io.u + off : io.u_base, ok ? 4 : 0);
          cp_async_4(&raw.delta[s][sc], ok ? io.delta + off : io.u_base,
                     ok ? 4 : 0);
          cp_async_4(&raw.g[s][sc], ok ? io.gy + off : io.u_base,
                     ok ? 4 : 0);
        }
      } else {  // bf16 at an odd channel offset: plain loads
        store(&raw.u[s][sc], ok ? load_f32(io.u + off) : 0.f);
        store(&raw.delta[s][sc], ok ? load_f32(io.delta + off) : 0.f);
        store(&raw.g[s][sc], ok ? load_f32(io.gy + off) : 0.f);
      }
    }
    if (flags & kBCVec) {  // the chunk's kChunk * kN values lie together
      constexpr int kPer = 16 / sizeof(T);
      for (int p = gt; p < kChunk * kN / kPer; p += kGroup) {
        const bool ok = p * kPer < len * kN;
        const size_t off = (size_t)t0 * kN + p * kPer;
        cp_async_16(&raw.B[0][0] + p * kPer, ok ? io.B + off : io.B_base,
                    ok ? 16 : 0);
        cp_async_16(&raw.C[0][0] + p * kPer, ok ? io.C + off : io.B_base,
                    ok ? 16 : 0);
      }
    } else {  // misaligned: one value per copy (bf16: plain loads)
#pragma unroll
      for (int j = 0; j < kBC; ++j) {
        const int e = gt + kGroup * j;
        const bool ok = e < len * kN;
        const size_t off = (size_t)t0 * kN + e;
        if (sizeof(T) == 4) {
          cp_async_4(&raw.B[0][0] + e, ok ? io.B + off : io.B_base,
                     ok ? 4 : 0);
          cp_async_4(&raw.C[0][0] + e, ok ? io.C + off : io.B_base,
                     ok ? 4 : 0);
        } else {
          store(&raw.B[0][0] + e, ok ? load_f32(io.B + off) : 0.f);
          store(&raw.C[0][0] + e, ok ? load_f32(io.C + off) : 0.f);
        }
      }
    }
    const float* cs_k = io.cs + (size_t)(t0 / kChunk) * kN * io.cns;
    if (flags & kCSVec) {  // row n: 16 channels, four 16-byte copies
      const int n = gt / 4;
      const int col = 4 * (gt % 4);
      const bool ok = col < io.nvalid;
      cp_async_16(&raw.cs[n][col], ok ? cs_k + (size_t)n * io.cns + col
                                      : io.cs_base, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < kCh * kN / kGroup; ++j) {
        const int e = gt + kGroup * j;
        const int n = e / kCh;
        const int col = e % kCh;
        const bool ok = col < io.nvalid;
        cp_async_4(&raw.cs[n][col], ok ? cs_k + (size_t)n * io.cns + col
                                       : io.cs_base, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // compute the staged chunk's per-(step, channel) terms once, into `sm`,
  // and this thread's entry state
  float xe[kNS];
  auto convert = [&](int i) {
    const int len = min(kChunk, L - chunk_t0(i));
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
      const int s = row + kRows * j;
      const bool ok = stage_active && s < len;
      const float uu = load_f32(&raw.u[s][sc]);  // zero where not ok
      const float rw = load_f32(&raw.delta[s][sc]) + bias;
      const float dt = ok ? (apply_softplus ? softplus(rw) : rw) : 0.f;
      sm.dt[s][sc] = dt;
      sm.du[s][sc] = dt * uu;
      sm.u[s][sc] = uu;
      sm.g[s][sc] = load_f32(&raw.g[s][sc]);
      sm.sig[s][sc] = ok ? (apply_softplus ? sigmoid(rw) : 1.f) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      const int e = gt + kGroup * j;
      (&sm.B[0][0])[e] = load_f32(&raw.B[0][0] + e);
      (&sm.C[0][0])[e] = load_f32(&raw.C[0][0] + e);
    }
#pragma unroll
    for (int j = 0; j < kNS; ++j) xe[j] = raw.cs[kNS * q + j][c];
  };

  stage(0);
  cp_async_wait_all();
  __syncthreads();
  convert(0);
  __syncthreads();

  for (int i = 0; i < nc; ++i) {
    const int t0 = chunk_t0(i);
    const int len = min(kChunk, L - t0);
    const int other = nc - 1 - i;  // iteration at which the other group
                                   // of a pair visits this group's chunk
    // pair: the other direction's du of a chunk it visited first, loaded
    // now so that the merge after the chunk does not wait on it
    float prev[kElems];
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
      const int s = row + kRows * j;
      prev[j] = (kPair && i > other && stage_active && s < len)
                    ? load_f32(io.du + (size_t)(t0 + s) * io.ts + sc)
                    : 0.f;
    }
    if (i + 1 < nc) stage(i + 1);  // in flight during this chunk

    // x_k = a_k x_{k-1} + dt_k u_k B_k at scan step k of the chunk
    auto advance = [&](int k, const float (&xp)[kNS], float (&xn)[kNS]) {
      const int s = rev ? len - 1 - k : k;
      const float dt = sm.dt[s][c];
      const float du = sm.du[s][c];
      const float4 bv = *reinterpret_cast<const float4*>(&sm.B[s][kNS * q]);
      xn[0] = exp2_ftz(dt * a2[0]) * xp[0] + du * bv.x;
      xn[1] = exp2_ftz(dt * a2[1]) * xp[1] + du * bv.y;
      xn[2] = exp2_ftz(dt * a2[2]) * xp[2] + du * bv.z;
      xn[3] = exp2_ftz(dt * a2[3]) * xp[3] + du * bv.w;
    };

    // one reverse step at scan step k, from x_{k-1} (xp) and x_k (xc)
    auto reverse = [&](int k, const float (&xp)[kNS], const float (&xc)[kNS]) {
      const int s = rev ? len - 1 - k : k;
      const float dt = sm.dt[s][c];
      const float du = sm.du[s][c];
      const float gg = sm.g[s][c];
      const float4 b4 = *reinterpret_cast<const float4*>(&sm.B[s][kNS * q]);
      const float4 c4 = *reinterpret_cast<const float4*>(&sm.C[s][kNS * q]);
      const float bv[kNS] = {b4.x, b4.y, b4.z, b4.w};
      const float cv[kNS] = {c4.x, c4.y, c4.z, c4.w};
      float v[2 * kNS];  // dB | dC contributions of this lane's states
      float dd_a = 0.f, ddu = 0.f;
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        const float a = exp2_ftz(dt * a2[j]);
        const float e = cv[j] * gg + carry[j];
        const float eax = e * a * xp[j];  // e a x_{t-1}
        dd_a += eax * a2[j];
        ddu += e * bv[j];
        dA[j] += eax * dt;
        v[j] = e * du;            // dB: e dt u
        v[kNS + j] = xc[j] * gg;  // dC: x_t g
        carry[j] = a * e;
      }
      dd_a += __shfl_xor_sync(0xffffffffu, dd_a, 8);
      ddu += __shfl_xor_sync(0xffffffffu, ddu, 8);
      dd_a += __shfl_xor_sync(0xffffffffu, dd_a, 16);
      ddu += __shfl_xor_sync(0xffffffffu, ddu, 16);
      const float uu = sm.u[s][c];
      const float ddt = (dd_a * kLn2 + ddu * uu) * sm.sig[s][c];
      dD += gg * uu;
      ddb += ddt;
      if (q == 0) {
        sm.ddt[s][c] = ddt;
        sm.dub[s][c] = ddu * dt + skip * gg;
      }
      const float sum = transpose_sum(v, lane);
      // lane (q, c8) holds value c8 of quarter q: dB (c8 < 4) or dC of
      // state 4q + (c8 & 3)
      sm.red[warp][s][(c8 < kNS ? 0 : kN) + kNS * q + (c8 & 3)] = sum;
    };

    // recompute the half's states from its entry state, then reverse it
    auto half = [&](int base, const float (&entry)[kNS]) {
      float xs[kHalf + 1][kNS];  // [0]: entry; [kk+1]: after step base+kk
#pragma unroll
      for (int j = 0; j < kNS; ++j) xs[0][j] = entry[j];
#pragma unroll
      for (int kk = 0; kk < kHalf; ++kk) {
        if (base + kk < len) advance(base + kk, xs[kk], xs[kk + 1]);
      }
#pragma unroll
      for (int kk = kHalf - 1; kk >= 0; --kk) {
        if (base + kk < len) reverse(base + kk, xs[kk], xs[kk + 1]);
      }
    };

    // the second half's entry state, then the halves in reverse order
    float xm[kNS] = {xe[0], xe[1], xe[2], xe[3]};
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      if (k < len) {
        float xn[kNS];
        advance(k, xm, xn);
#pragma unroll
        for (int j = 0; j < kNS; ++j) xm[j] = xn[j];
      }
    }
    half(kHalf, xm);
    half(0, xe);
    __syncthreads();  // both groups' outputs of this iteration are in smem

    // dΔ of this group
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
      const int s = row + kRows * j;
      if (stage_active && s < len) {
        store(io.ddelta + (size_t)(t0 + s) * io.ts + sc, sm.ddt[s][sc]);
      }
    }
    // du: straight, or for a pair first visitor stores, second adds,
    // middle sums both
    if (!kPair || i != other || r == 0) {
#pragma unroll
      for (int j = 0; j < kElems; ++j) {
        const int s = row + kRows * j;
        if (stage_active && s < len) {
          float v = sm.dub[s][sc];
          if (kPair && i == other) {
            v = smem[0].dub[s][sc] + smem[1].dub[s][sc];
          } else if (kPair && i > other) {
            v = prev[j] + v;
          }
          store(io.du + (size_t)(t0 + s) * io.ts + sc, v);
        }
      }
    }
    // dB/dC: a pair writes one partial per group (its 2 warps summed in
    // order), two halves one per block (its 4 warps summed in order)
    if (kPair) {
#pragma unroll
      for (int j = 0; j < kRed; ++j) {
        const int e = gt + kGroup * j;
        const int s = e / (2 * kN);
        const int k = e % (2 * kN);
        if (s < len) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) sum += sm.red[w][s][k];
          (k < kN ? io.dB : io.dC)[(size_t)(t0 + s) * kN + (k % kN)] = sum;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRed / 2; ++j) {
        const int e = threadIdx.x + kThreads * j;
        const int s = e / (2 * kN);
        const int k = e % (2 * kN);
        if (s < len) {
          float sum = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int w = 0; w < kWarps; ++w) sum += smem[h].red[w][s][k];
          }
          (k < kN ? io.dB : io.dC)[(size_t)(t0 + s) * kN + (k % kN)] = sum;
        }
      }
    }
    if (i + 1 < nc) {
      cp_async_wait_all();
      __syncthreads();  // every thread's copies of the next chunk landed
      convert(i + 1);
    }
    __syncthreads();
  }

  if (active) {
    *reinterpret_cast<float4*>(io.dA + c * kN + kNS * q) =
        make_float4(dA[0], dA[1], dA[2], dA[3]);
    // past step 0, carry = exp(dt_0 A) e_0: the incoming state's cotangent
    if (io.dx_init != nullptr) {
      *reinterpret_cast<float4*>(io.dx_init + c * kN + kNS * q) =
          make_float4(carry[0], carry[1], carry[2], carry[3]);
    }
    if (q == 0) {
      io.dD[c] = dD;
      io.ddb[c] = ddb;
    }
  }
}

// The launch configuration and occupancy of `kernel` launched as grid x
// kThreads with kSmem: out[0..8] = grid x, y, z, threads per block,
// registers per thread, static and dynamic shared memory per block
// (bytes), local memory per thread (bytes; spills), and the resident
// blocks per SM the occupancy calculator allows.
inline int occupancy(const void* kernel, dim3 grid, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[9] = {static_cast<int>(grid.x), static_cast<int>(grid.y),
                       static_cast<int>(grid.z), kThreads, fa.numRegs,
                       static_cast<int>(fa.sharedSizeBytes), kSmem,
                       static_cast<int>(fa.localSizeBytes), blocks};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace scan_bwd
