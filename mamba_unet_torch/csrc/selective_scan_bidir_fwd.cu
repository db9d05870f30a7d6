// Bidirectional selective-scan (S6) forward for SS2D, written for sm_90a.
//
// Replaces two Pallas TPU kernels that compute this same function:
//   * mamba_unet_tpu/ops/selective_scan_persistent.py::_bidir_kernel
//     (through persistent_scan_bidir; the TPU's stage-0 serving scan), and
//   * mamba_unet_tpu/ops/selective_scan_pallas.py::_fwd_kernel in bidir mode
//     (through selective_scan_pallas_bidir(merge_pairs=True); stages 1-3),
//     y output, and
//   * the same _fwd_kernel's chunk-entry state output `cs` (save_cs), which
//     only the backward (selective_scan_bidir_bwd.cu) reads.
//
// Math, per direction g in {0,1,2,3}; m = g % 2 is the data stream and
// directions g >= 2 run over it in reversed time:
//   delta  = softplus(delta4[b,g,t,d] + delta_bias[g*dg+d])
//   x_t    = exp(delta*A[g*dg+d,:]) * x_{t-1} + delta*B4[b,g,t,:]*u2[b,m,t,d]
//   y_g[t] = <C4[b,g,t,:], x_t> + D[g*dg+d]*u2[b,m,t,d]
//   out[b,m,t,d] = y_m[t] + y_{m+2}[t]          (both in data order)
// The state x (N = 16) and all arithmetic are fp32; inputs are fp32 or bf16
// and the output is fp32.
//
// With a non-null `cs` (the training forward) the kernel also writes the
// fp32 state entering every 16-step chunk of data time, in each direction's
// scan order: cs[b, g, k, d, n] (n fastest) is the state with which
// direction g enters the k-th data chunk it scans: data steps [16k, 16k+16)
// for g < 2, data chunk ceil(L/16) - 1 - k (entered at its last step) for
// g >= 2; zero for k = 0. The serving call passes null and compiles without
// the stores (a template flag).
//
// What bounds it on an H100. At stage 0 of the served model (bs24, L=3136,
// dg=192, fp32) one call reads about 0.39 GB of distinct input (u2 0.12,
// delta4 0.23, B4+C4 0.04) and writes 0.12 GB of y (0.23 more of cs in
// training), and computes about 0.9 G exp: a floor of 0.25 ms (exps at the
// SFUs' rate; chip_smoke.py::scan_bound). The recurrence is sequential in
// t, so the parallelism is B * 4 * dg channel-directions. The design this
// one replaces ran one thread per channel and both directions of a pair in
// it: 144 blocks of 2 warps, 2.2 warps per SM at stage 0, 1.99 ms per
// call.
//
// What the design does about it:
//   * States split over lanes: 4 lanes per channel, 4 states each (lane =
//     8 * q + c8: states 4q..4q+3 of the warp's channel c8). y's sum over n
//     is two shuffles. 4x the threads, a quarter of the exp/FMA chain per
//     thread.
//   * One direction per group of 64 threads (16 channels), both directions
//     of a pair in one block of 128: grid (ceil(dg/16), 2, B). At stage 0
//     that is 576 blocks and 17.5 warps per SM, all resident at once.
//     Measured (chip_smoke.py [kernel_occ], NVIDIA H100 80GB HBM3, 700 W):
//     72 registers, 24 KB of static shared memory, no spills, 7 blocks (28
//     warps) per SM allowed, 0.62 waves at stage 0.
//   * The pair merge without atomics: the two groups walk data time in
//     opposite orders, one 32-step chunk per iteration in lockstep, so each
//     data chunk is visited by one group at iteration i and by the other at
//     iteration nch-1-i. The first visitor stores its y, the second (after
//     at least one barrier) adds its y onto it; at the middle iteration the
//     block sums both in shared memory. fp32 addition commutes, so the
//     result is y_m + y_{m+2}, bitwise the same on every run.
//   * Staging: each chunk's u, delta, B and C are loaded into registers one
//     iteration ahead (the loads fly while the current chunk scans), then
//     converted once per element into shared memory: dt = softplus(delta +
//     bias), dt*u and D*u. The scan loop reads only shared memory, and the
//     four lanes of a channel share one softplus.
//   * Masked channels (d >= dg) and the steps past a ragged chunk run with
//     zero inputs or not at all; every thread reaches every barrier and
//     shuffle.
//   * Each gate exp(dt A) is one SFU ex2 with subnormal results flushed to
//     zero (exp2_ftz): exp2f's subnormal fix-up around every gate cost
//     about a tenth of the kernel's time on the card.
// Where the time goes now (scripts/scan_phases.py, stage 0): about
// half in the scan loop, a quarter in the merged write-out (its second
// visitor waits on a read of the first visitor's y), the rest in the
// softplus conversion. No single resource is saturated at this occupancy:
// it is latency bound at about 4 warps per scheduler.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kN = 16;            // d_state
constexpr int kLanes = 4;         // lanes per channel
constexpr int kNS = kN / kLanes;  // states per lane
constexpr int kCh = 16;           // channels per direction group
constexpr int kGroup = kCh * kLanes;  // threads per direction group (64)
constexpr int kThreads = 2 * kGroup;  // a direction pair per block
constexpr int kChunk = 32;        // data steps staged per iteration
constexpr int kStateChunk = 16;   // data steps between saved states (= bwd)
constexpr int kRows = kGroup / kCh;    // chunk rows each staging pass covers
constexpr int kElems = kChunk / kRows;  // u/delta values a thread stages
constexpr int kBC = kChunk * kN / kGroup;  // B (and C) values it stages
static_assert(kChunk % kStateChunk == 0, "a state chunk is inside a chunk");
static_assert(kChunk % kRows == 0 && (kChunk * kN) % kGroup == 0, "staging");
constexpr float kLog2e = 1.4426950408889634f;

struct GroupSmem {
  float dt[kChunk][kCh];    // softplus(delta + bias), by data-order slot
  float du[kChunk][kCh];    // dt * u
  float skip[kChunk][kCh];  // D * u
  float y[kChunk][kCh];     // this direction's y, by data-order slot
  float B[kChunk][kN];
  float C[kChunk][kN];
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

// The values one thread stages for one chunk, loaded an iteration ahead.
struct Staged {
  float u[kElems], delta[kElems], B[kBC], C[kBC];
};

template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads)
bidir_fwd_kernel(const T* __restrict__ u2, const T* __restrict__ delta4,
                 const T* __restrict__ B4, const T* __restrict__ C4,
                 const float* __restrict__ A, const float* __restrict__ D,
                 const float* __restrict__ delta_bias,
                 float* __restrict__ out, float* __restrict__ cs, int L,
                 int dg) {
  __shared__ __align__(16) GroupSmem smem[2];

  const int r = threadIdx.x / kGroup;  // 0: direction m; 1: m + 2, reversed
  const int gt = threadIdx.x % kGroup;
  const int lane = gt & 31;
  const int q = lane >> 3;                    // states 4q..4q+3
  const int c = (gt >> 5) * 8 + (lane & 7);  // scanned channel in the tile
  const int sc = gt % kCh;                    // staged channel in the tile
  const int row = gt / kCh;                   // first staged chunk row
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + c;
  const bool active = d < dg;
  const bool stage_active = d0 + sc < dg;
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  const int g = m + 2 * r;
  const int nch = (L + kChunk - 1) / kChunk;
  const int n_states = (L + kStateChunk - 1) / kStateChunk;
  GroupSmem& sm = smem[r];

  const size_t stream = (size_t)(b * 2 + m) * L * dg;
  const T* u_s = u2 + stream;
  float* out_s = out + stream;
  const size_t dir = (size_t)(b * 4 + g) * L;
  const T* delta_s = delta4 + dir * dg;
  const T* B_s = B4 + dir * kN;
  const T* C_s = C4 + dir * kN;
  float* cs_g = kSave ? cs + (size_t)(b * 4 + g) * n_states * dg * kN : nullptr;

  float a2[kNS], x[kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    a2[j] = active ? A[((size_t)g * dg + d) * kN + kNS * q + j] * kLog2e
                   : 0.f;
    x[j] = 0.f;
  }
  float bias = 0.f, skip = 0.f;  // of the staged channel
  if (stage_active) {
    bias = delta_bias[(size_t)g * dg + d0 + sc];
    skip = D[(size_t)g * dg + d0 + sc];
  }

  // data chunk of this group at iteration i: direction m walks forward,
  // direction m + 2 backward
  auto chunk_of = [&](int i) { return r == 0 ? i : nch - 1 - i; };

  auto load = [&](Staged& st, int i) {
    const int t0 = chunk_of(i) * kChunk;
    const int len = min(kChunk, L - t0);
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
      const int s = row + kRows * j;
      const bool ok = stage_active && s < len;
      const size_t off = (size_t)(t0 + s) * dg + d0 + sc;
      st.u[j] = ok ? load_f32(u_s + off) : 0.f;
      st.delta[j] = ok ? load_f32(delta_s + off) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      const int e = gt + kGroup * j;
      const bool ok = (e / kN) < len;
      st.B[j] = ok ? load_f32(B_s + (size_t)t0 * kN + e) : 0.f;
      st.C[j] = ok ? load_f32(C_s + (size_t)t0 * kN + e) : 0.f;
    }
  };

  auto convert = [&](const Staged& st, int i) {
    const int len = min(kChunk, L - chunk_of(i) * kChunk);
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
      const int s = row + kRows * j;
      const float dt = (stage_active && s < len)
                           ? softplus(st.delta[j] + bias) : 0.f;
      sm.dt[s][sc] = dt;
      sm.du[s][sc] = dt * st.u[j];
      sm.skip[s][sc] = skip * st.u[j];
    }
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      const int e = gt + kGroup * j;
      (&sm.B[0][0])[e] = st.B[j];
      (&sm.C[0][0])[e] = st.C[j];
    }
  };

  Staged st;
  load(st, 0);
  convert(st, 0);
  __syncthreads();

  for (int i = 0; i < nch; ++i) {
    const int t0 = chunk_of(i) * kChunk;
    const int len = min(kChunk, L - t0);
    const int other = nch - 1 - i;  // iteration at which the other group
                                    // visits this group's chunk
    if (i + 1 < nch) load(st, i + 1);  // in flight during the scan

#pragma unroll 2
    for (int k = 0; k < len; ++k) {
      const int s = r == 0 ? k : len - 1 - k;  // data-order slot
      if (kSave && active) {
        const int t = t0 + s;
        const bool entry = r == 0 ? t % kStateChunk == 0
                                  : (t == L - 1 || (t + 1) % kStateChunk == 0);
        if (entry) {
          const int kc = r == 0 ? t / kStateChunk
                                : n_states - 1 - t / kStateChunk;
          *reinterpret_cast<float4*>(
              cs_g + ((size_t)kc * dg + d) * kN + kNS * q) =
              make_float4(x[0], x[1], x[2], x[3]);
        }
      }
      const float dt = sm.dt[s][c];
      const float du = sm.du[s][c];
      const float4 bv = *reinterpret_cast<const float4*>(&sm.B[s][kNS * q]);
      const float4 cv = *reinterpret_cast<const float4*>(&sm.C[s][kNS * q]);
      x[0] = exp2_ftz(dt * a2[0]) * x[0] + du * bv.x;
      x[1] = exp2_ftz(dt * a2[1]) * x[1] + du * bv.y;
      x[2] = exp2_ftz(dt * a2[2]) * x[2] + du * bv.z;
      x[3] = exp2_ftz(dt * a2[3]) * x[3] + du * bv.w;
      float y = cv.x * x[0] + cv.y * x[1] + cv.z * x[2] + cv.w * x[3];
      y += __shfl_xor_sync(0xffffffffu, y, 8);
      y += __shfl_xor_sync(0xffffffffu, y, 16);
      if (q == 0) sm.y[s][c] = y + sm.skip[s][c];
    }
    __syncthreads();  // both groups' y of this iteration are in smem


    // the pair merge: first visitor stores, second adds, middle sums both
    if (i != other || r == 0) {
#pragma unroll
      for (int j = 0; j < kElems; ++j) {
        const int s = row + kRows * j;
        if (stage_active && s < len) {
          const size_t off = (size_t)(t0 + s) * dg + d0 + sc;
          float v = sm.y[s][sc];
          if (i == other) v = smem[0].y[s][sc] + smem[1].y[s][sc];
          else if (i > other) v = out_s[off] + v;
          out_s[off] = v;
        }
      }
    }
    if (i + 1 < nch) convert(st, i + 1);
    __syncthreads();
  }
}

template <typename T, bool kSave>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(bidir_fwd_kernel<T, kSave>);
}

const void* pick(int is_bf16, bool save) {
  return is_bf16 ? (save ? kernel_ptr<__nv_bfloat16, true>()
                         : kernel_ptr<__nv_bfloat16, false>())
                 : (save ? kernel_ptr<float, true>()
                         : kernel_ptr<float, false>());
}

template <typename T>
cudaError_t launch(const void* u2, const void* delta4, const void* B4,
                   const void* C4, const void* A, const void* D,
                   const void* delta_bias, void* out, void* cs, int batch,
                   int L, int dg, cudaStream_t stream) {
  const dim3 grid((dg + kCh - 1) / kCh, 2, batch);
  auto kernel = cs ? bidir_fwd_kernel<T, true> : bidir_fwd_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u2), static_cast<const T*>(delta4),
      static_cast<const T*>(B4), static_cast<const T*>(C4),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(delta_bias), static_cast<float*>(out),
      static_cast<float*>(cs), L, dg);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are contiguous device buffers laid out as documented above; `cs`
// is null (serving) or (batch, 4, ceil(L / 16), dg, 16) fp32 (training).
extern "C" int selective_scan_bidir_fwd(const void* u2, const void* delta4,
                                        const void* B4, const void* C4,
                                        const void* A, const void* D,
                                        const void* delta_bias, void* out,
                                        void* cs, int batch, int L, int dg,
                                        int n, int is_bf16, void* stream) {
  if (n != kN || batch <= 0 || batch > 65535 || L <= 0 || dg <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(u2, delta4, B4, C4, A, D, delta_bias,
                                      out, cs, batch, L, dg, s)
              : launch<float>(u2, delta4, B4, C4, A, D, delta_bias, out, cs,
                              batch, L, dg, s);
  return static_cast<int>(err);
}

// Reports the launch configuration and occupancy of the kernel that
// selective_scan_bidir_fwd launches for (batch, L, dg): out[0..8] = grid x,
// y, z, threads per block, registers per thread, static and dynamic shared
// memory per block (bytes), local memory per thread (bytes; spills), and
// the resident blocks per SM the occupancy calculator allows.
extern "C" int selective_scan_bidir_fwd_occupancy(int batch, int L, int dg,
                                                  int is_bf16, int save,
                                                  int* out) {
  (void)L;
  const void* kernel = pick(is_bf16, save != 0);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[9] = {(dg + kCh - 1) / kCh, 2, batch, kThreads,
                       fa.numRegs, static_cast<int>(fa.sharedSizeBytes), 0,
                       static_cast<int>(fa.localSizeBytes), blocks};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}
