// Bidirectional selective-scan (S6) backward for SS2D, written for sm_90a.
//
// Replaces the Pallas TPU kernel
//   mamba_unet_tpu/ops/selective_scan_pallas.py::_bwd_kernel
// in bidir + merged-cotangent mode (_scan_bwd_impl(bidir=True,
// merged_gy=True), the VJP of selective_scan_pallas_bidir(merge_pairs=True)).
//
// Forward, per direction g in {0,1,2,3} (m = g % 2 the data stream, g >= 2
// in reversed time; see selective_scan_bidir_fwd.cu):
//   dt_t = softplus(raw_t),  raw_t = delta4[b,g,t,d] + delta_bias[g*dg+d]
//   a_t  = exp(dt_t * A[n]),  x_t = a_t x_{t-1} + dt_t B_t u_t
//   y_t  = <C_t, x_t> + D u_t,   out[b,m] = y_m + y_{m+2}
// so both directions of a pair receive the same cotangent g = gy[b,m,t,d].
// Backward, walking each direction in reverse scan order:
//   e_t   = C_t g_t + a_{t+1} e_{t+1}                     (dL/dx_t)
//   dΔ_t  = (sum_n e a x_{t-1} A + sum_n e B u) * sigmoid(raw_t)
//   du_t  = sum_n e B dt + D g    (stream m: directions m and m+2 summed)
//   dB_t  = sum_d e dt u,   dC_t = sum_d x_t g
//   dA    = sum_{b,t} e a x_{t-1} dt,  dD = sum_{b,t} g u,  dΔbias = sum dΔ
//
// Inputs: u2 (B,2,L,dg), delta4 (B,4,L,dg), B4/C4 (B,4,L,16) in T (fp32 or
// bf16); A (4*dg,16), D and delta_bias (4*dg) fp32; cs (B,4,nc,dg,16) fp32,
// the chunk-entry states the state-saving forward wrote (nc = ceil(L/16),
// chunks fixed in data time, indexed in each direction's scan order); gy
// (B,2,L,dg) fp32. Outputs: du2 (B,2,L,dg) fp32, ddelta4 (B,4,L,dg) in T,
// and fp32 partial sums that the caller reduces (deterministically, no
// atomics): dB/dC over 16-channel tiles (ntile,B,4,L,16), dA (B,4*dg,16), dD
// and dΔbias (B,4*dg) over the batch.
//
// What bounds it on an H100. At stage 0 of the trained model (bs24, L=3136,
// dg=192, fp32) one call reads u2, delta4, gy (0.06 + 0.23 + 0.12 GB), cs
// (0.23 GB) and B/C, and writes du2, ddelta4 and dB/dC (0.12 + 0.23 + 0.02
// GB): about 1.1 GB, 0.33 ms at 3.35 TB/s. The gradient needs one exp per
// state and step (a_t, about 0.9 G with softplus and sigmoid), under 0.3 ms
// on the SFUs, so the bound is the bytes. The design this one replaces
// (one thread per channel running both directions, 68 KB of recomputed
// states in shared memory) fitted 2 blocks of 2 warps per SM and took
// 11.1 ms per call.
//
// What the design does about it:
//   * States split over lanes: 4 lanes per channel, 4 states each (lane =
//     8 * q + c8). A quarter of the serial exp/FMA chain per thread; sums
//     over n (dΔ, du) are two shuffles.
//   * One direction per group of 64 threads (16 channels), both directions
//     of a pair in one block of 128: grid (ceil(dg/16), 2, B), 576 blocks
//     and 17.5 warps per SM at stage 0. Registers are capped so that 5
//     blocks fit per SM and stage 0 runs in one wave. Measured
//     (chip_smoke.py [kernel_occ], NVIDIA H100 80GB HBM3, 700 W): 96
//     registers, 32 bytes of local memory (spills), 38 KB of dynamic
//     shared memory, 5 blocks (20 warps) per SM, 0.87 waves at stage 0.
//   * The recomputed states live in registers, not shared memory: each
//     16-step chunk is recomputed from its saved entry state in two 8-step
//     halves (9 x 4 fp32 per thread): the first half's states are stepped
//     through once to reach the second half's entry, which is recomputed
//     and reversed, then the first half is recomputed again and reversed.
//     That is 2.5 exps per state and step (the reverse needs a_t again);
//     holding the chunk's 17 states or its 16 a_t as well would take
//     64 more registers and half the blocks per SM.
//   * du of stream m sums directions m and m+2 without atomics: the groups
//     walk data time in opposite orders in lockstep (chunk nc-1-i and chunk
//     i at iteration i), so the first visitor of a chunk stores its du and
//     the second adds onto it (read at the start of the iteration, so the
//     write-out does not wait on it); the middle chunk is summed in shared
//     memory. fp32 addition commutes: bitwise the same every run.
//   * The next chunk's u, delta, gy, B, C and entry states are copied into
//     shared memory with cp.async while the current chunk computes (bf16
//     by 4-byte channel pairs, which needs an even dg; an odd dg in bf16
//     loads them plainly). Then dt = softplus(raw), dt*u and sigmoid(raw)
//     are computed once per element; the four lanes of a channel read them
//     by broadcast.
//   * dB/dC need a sum over channels every step: a transposing butterfly
//     over the 8 channels of a warp (7 shuffles leave each lane one of its
//     8 dB|dC values summed over them), then the 2 warps of a group are
//     summed in shared memory at the chunk's end, in a fixed order; the sum
//     over channel tiles is left to the caller.
//   * dA/dD/dΔbias are per-thread register sums over time, written per
//     batch element; the caller sums over the batch.
//   * Masked threads (d >= dg) run with zero inputs: they reach every
//     barrier and shuffle and contribute exact zeros. Steps past a ragged
//     chunk are skipped by a predicate uniform over the block.
//   * Each gate exp(dt A) is one SFU ex2 with subnormal results flushed to
//     zero (exp2_ftz): exp2f's subnormal fix-up around every gate cost
//     about a tenth of the kernel's time on the card.
// Where the time goes now (scripts/scan_phases.py, stage 0): about
// 70 % in the recompute and reverse, a tenth each in the write-out and in
// staging. At 4 warps per scheduler the reverse step's shuffle chains
// (dΔ/du sums, the dB/dC butterfly) and exps are not hidden: it is latency
// bound, about 10x its byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kN = 16;            // d_state
constexpr int kLanes = 4;         // lanes per channel
constexpr int kNS = kN / kLanes;  // states per lane
constexpr int kCh = 16;           // channels per direction group
constexpr int kGroup = kCh * kLanes;  // threads per direction group (64)
constexpr int kWarps = kGroup / 32;   // warps per group
constexpr int kThreads = 2 * kGroup;  // a direction pair per block
constexpr int kMinBlocks = 5;     // resident blocks per SM to fit registers to
constexpr int kChunk = 16;        // = the forward's kStateChunk
constexpr int kHalf = kChunk / 2;  // steps whose states a thread holds
constexpr int kRows = kGroup / kCh;  // chunk rows one staging pass covers
constexpr int kElems = kChunk / kRows;     // per-channel values a thread stages
constexpr int kBC = kChunk * kN / kGroup;  // B (and C) values it stages
constexpr int kRed = kChunk * 2 * kN / kGroup;  // dB|dC sums it writes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kChunk % kRows == 0 && (kChunk * kN) % kGroup == 0, "staging");

struct GroupSmem {
  float dt[kChunk][kCh];   // softplus(raw), by data-order slot
  float du[kChunk][kCh];   // dt * u
  float u[kChunk][kCh];
  float g[kChunk][kCh];    // the pair-summed cotangent
  float sig[kChunk][kCh];  // sigmoid(raw)
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
  float g[kChunk][kCh];
  T B[kChunk][kN];
  T C[kChunk][kN];
  float cs[kCh][kN];  // the chunk's entry states
};
constexpr int kSmem =
    static_cast<int>(2 * sizeof(GroupSmem) + 2 * sizeof(RawSmem<float>));

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

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bidir_bwd_kernel(const T* __restrict__ u2, const T* __restrict__ delta4,
                 const T* __restrict__ B4, const T* __restrict__ C4,
                 const float* __restrict__ A, const float* __restrict__ D,
                 const float* __restrict__ delta_bias,
                 const float* __restrict__ cs, const float* __restrict__ gy,
                 float* __restrict__ du2, T* __restrict__ ddelta4,
                 float* __restrict__ dB_part, float* __restrict__ dC_part,
                 float* __restrict__ dA_part, float* __restrict__ dD_part,
                 float* __restrict__ ddb_part, int batch, int L, int dg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GroupSmem* smem = reinterpret_cast<GroupSmem*>(smem_raw);

  const int r = threadIdx.x / kGroup;  // 0: direction m; 1: m + 2, reversed
  const int gt = threadIdx.x % kGroup;
  const int lane = gt & 31;
  const int warp = gt >> 5;            // warp in the group
  const int q = lane >> 3;             // state quarter: states 4q..4q+3
  const int c8 = lane & 7;
  const int c = warp * 8 + c8;         // scanned channel in the tile
  const int tile = blockIdx.x;
  const int d0 = tile * kCh;
  const int d = d0 + c;
  const bool active = d < dg;
  const int sc = gt % kCh;    // staged channel in the tile
  const int row = gt / kCh;   // first staged chunk row
  const bool stage_active = d0 + sc < dg;
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  const int g = m + 2 * r;
  const int nc = (L + kChunk - 1) / kChunk;
  GroupSmem& sm = smem[r];

  const size_t stream = (size_t)(b * 2 + m) * L * dg;
  const T* u_s = u2 + stream;
  const float* g_s = gy + stream;
  float* du_s = du2 + stream;
  const size_t dir = (size_t)(b * 4 + g) * L;
  const T* delta_s = delta4 + dir * dg;
  T* ddelta_s = ddelta4 + dir * dg;
  const T* B_s = B4 + dir * kN;
  const T* C_s = C4 + dir * kN;
  const float* cs_g = cs + (size_t)(b * 4 + g) * nc * dg * kN;
  const size_t part = ((size_t)tile * batch * 4 + b * 4 + g) * L * kN;
  float* dB_s = dB_part + part;
  float* dC_s = dC_part + part;

  float a2[kNS], carry[kNS], dA[kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    a2[j] = active ? A[((size_t)g * dg + d) * kN + kNS * q + j] * kLog2e
                   : 0.f;
    carry[j] = 0.f;
    dA[j] = 0.f;
  }
  float skip = 0.f, bias = 0.f;  // skip of the scanned, bias of the staged
  if (active) skip = D[(size_t)g * dg + d];
  if (stage_active) bias = delta_bias[(size_t)g * dg + d0 + sc];
  float dD = 0.f, ddb = 0.f;

  RawSmem<T>& raw = reinterpret_cast<RawSmem<T>*>(
      smem_raw + 2 * sizeof(GroupSmem))[r];
  // bf16 rows are copied by 4-byte pairs of channels, which needs an even dg
  const bool pairs = sizeof(T) == 4 || dg % 2 == 0;
  // data start of the chunk this group computes at iteration i
  auto chunk_t0 = [&](int i) { return (r == 0 ? nc - 1 - i : i) * kChunk; };

  // start copying chunk i's inputs into `raw`
  auto stage = [&](int i) {
    const int t0 = chunk_t0(i);
    const int len = min(kChunk, L - t0);
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
      const int s = row + kRows * j;
      const bool ok = stage_active && s < len;
      const size_t off = (size_t)(t0 + s) * dg + d0 + sc;
      cp_async_4(&raw.g[s][sc], ok ? g_s + off : gy, ok ? 4 : 0);
      if (pairs) {
        if (sizeof(T) == 4 || sc % 2 == 0) {
          cp_async_4(&raw.u[s][sc], ok ? u_s + off : u2, ok ? 4 : 0);
          cp_async_4(&raw.delta[s][sc], ok ? delta_s + off : delta4,
                     ok ? 4 : 0);
        }
      } else {  // bf16 with an odd dg: plain loads
        store(&raw.u[s][sc], ok ? load_f32(u_s + off) : 0.f);
        store(&raw.delta[s][sc], ok ? load_f32(delta_s + off) : 0.f);
      }
    }
    constexpr int kPer = 16 / sizeof(T);  // B/C values per 16 bytes
    for (int p = gt; p < kChunk * kN / kPer; p += kGroup) {
      const bool ok = p * kPer < len * kN;
      const size_t off = (size_t)t0 * kN + p * kPer;
      cp_async_16(&raw.B[0][0] + p * kPer, ok ? B_s + off : B4, ok ? 16 : 0);
      cp_async_16(&raw.C[0][0] + p * kPer, ok ? C_s + off : C4, ok ? 16 : 0);
    }
    const int kc = nc - 1 - i;  // scan-order chunk index in cs
    for (int p = gt; p < kCh * kN / 4; p += kGroup) {
      const bool ok = d0 + p / (kN / 4) < dg;
      const float* src = cs_g + ((size_t)kc * dg + d0) * kN + p * 4;
      cp_async_16(&raw.cs[0][0] + p * 4, ok ? src : cs, ok ? 16 : 0);
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
      const float dt = ok ? softplus(rw) : 0.f;
      sm.dt[s][sc] = dt;
      sm.du[s][sc] = dt * uu;
      sm.u[s][sc] = uu;
      sm.g[s][sc] = raw.g[s][sc];
      sm.sig[s][sc] = ok ? sigmoid(rw) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      const int e = gt + kGroup * j;
      (&sm.B[0][0])[e] = load_f32(&raw.B[0][0] + e);
      (&sm.C[0][0])[e] = load_f32(&raw.C[0][0] + e);
    }
    const float4 e4 = *reinterpret_cast<const float4*>(&raw.cs[c][kNS * q]);
    xe[0] = e4.x;
    xe[1] = e4.y;
    xe[2] = e4.z;
    xe[3] = e4.w;
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
                                   // visits this group's chunk
    // the other direction's du of a chunk it visited first, loaded now so
    // that the merge after the chunk does not wait on it
    float prev[kElems];
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
      const int s = row + kRows * j;
      prev[j] = (i > other && stage_active && s < len)
                    ? du_s[(size_t)(t0 + s) * dg + d0 + sc] : 0.f;
    }
    if (i + 1 < nc) stage(i + 1);  // in flight during this chunk

    // x_k = a_k x_{k-1} + dt_k u_k B_k at scan step k of the chunk
    auto advance = [&](int k, const float (&xp)[kNS], float (&xn)[kNS]) {
      const int s = r == 0 ? k : len - 1 - k;
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
      const int s = r == 0 ? k : len - 1 - k;
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

    // dΔ of this direction
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
      const int s = row + kRows * j;
      if (stage_active && s < len) {
        store(ddelta_s + (size_t)(t0 + s) * dg + d0 + sc, sm.ddt[s][sc]);
      }
    }
    // du of the stream: first visitor stores, second adds, middle sums both
    if (i != other || r == 0) {
#pragma unroll
      for (int j = 0; j < kElems; ++j) {
        const int s = row + kRows * j;
        if (stage_active && s < len) {
          const size_t off = (size_t)(t0 + s) * dg + d0 + sc;
          float v = sm.dub[s][sc];
          if (i == other) v = smem[0].dub[s][sc] + smem[1].dub[s][sc];
          else if (i > other) v = prev[j] + v;
          du_s[off] = v;
        }
      }
    }
    // dB/dC of this tile: the group's warps summed in order
#pragma unroll
    for (int j = 0; j < kRed; ++j) {
      const int e = gt + kGroup * j;
      const int s = e / (2 * kN);
      const int k = e % (2 * kN);
      if (s < len) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += sm.red[w][s][k];
        (k < kN ? dB_s : dC_s)[(size_t)(t0 + s) * kN + (k % kN)] = sum;
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
    const size_t row = (size_t)b * 4 * dg + (size_t)g * dg + d;
    *reinterpret_cast<float4*>(dA_part + row * kN + kNS * q) =
        make_float4(dA[0], dA[1], dA[2], dA[3]);
    if (q == 0) {
      dD_part[row] = dD;
      ddb_part[row] = ddb;
    }
  }
}

const void* pick(int is_bf16) {
  return is_bf16 ? reinterpret_cast<const void*>(
                       bidir_bwd_kernel<__nv_bfloat16>)
                 : reinterpret_cast<const void*>(bidir_bwd_kernel<float>);
}


template <typename T>
cudaError_t launch(const void* u2, const void* delta4, const void* B4,
                   const void* C4, const void* A, const void* D,
                   const void* delta_bias, const void* cs, const void* gy,
                   void* du2, void* ddelta4, void* dB_part, void* dC_part,
                   void* dA_part, void* dD_part, void* ddb_part, int batch,
                   int L, int dg, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bidir_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((dg + kCh - 1) / kCh, 2, batch);
  bidir_bwd_kernel<T><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(u2), static_cast<const T*>(delta4),
      static_cast<const T*>(B4), static_cast<const T*>(C4),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(delta_bias), static_cast<const float*>(cs),
      static_cast<const float*>(gy), static_cast<float*>(du2),
      static_cast<T*>(ddelta4), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), static_cast<float*>(dA_part),
      static_cast<float*>(dD_part), static_cast<float*>(ddb_part), batch, L,
      dg);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
// Pointers are contiguous device buffers laid out as documented above.
extern "C" int selective_scan_bidir_bwd(
    const void* u2, const void* delta4, const void* B4, const void* C4,
    const void* A, const void* D, const void* delta_bias, const void* cs,
    const void* gy, void* du2, void* ddelta4, void* dB_part, void* dC_part,
    void* dA_part, void* dD_part, void* ddb_part, int batch, int L, int dg,
    int n, int is_bf16, void* stream) {
  if (n != kN || batch <= 0 || batch > 65535 || L <= 0 || dg <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16
          ? launch<__nv_bfloat16>(u2, delta4, B4, C4, A, D, delta_bias, cs,
                                  gy, du2, ddelta4, dB_part, dC_part, dA_part,
                                  dD_part, ddb_part, batch, L, dg, s)
          : launch<float>(u2, delta4, B4, C4, A, D, delta_bias, cs, gy, du2,
                          ddelta4, dB_part, dC_part, dA_part, dD_part,
                          ddb_part, batch, L, dg, s);
  return static_cast<int>(err);
}

// Reports the launch configuration and occupancy of the kernel that
// selective_scan_bidir_bwd launches for (batch, L, dg): out[0..8] = grid x,
// y, z, threads per block, registers per thread, static and dynamic shared
// memory per block (bytes), local memory per thread (bytes; spills), and
// the resident blocks per SM the occupancy calculator allows.
extern "C" int selective_scan_bidir_bwd_occupancy(int batch, int L, int dg,
                                                  int is_bf16, int* out) {
  (void)L;
  const void* kernel = pick(is_bf16);
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
  const int vals[9] = {(dg + kCh - 1) / kCh, 2, batch, kThreads,
                       fa.numRegs, static_cast<int>(fa.sharedSizeBytes),
                       kSmem, static_cast<int>(fa.localSizeBytes), blocks};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}
