// Unidirectional grouped selective-scan (S6) forward, written for sm_90a.
//
// Replaces the Pallas TPU kernel
//   mamba_unet_tpu/ops/selective_scan_pallas.py::_fwd_kernel in its
//   unidirectional mode (bidir=False), reached through
//   _scan_core <- selective_scan_pallas_tm <- selective_scan_pallas, the
//   scan of every 1-D Mamba layer (nn/mamba1d.py) and of SS2D's time-major
//   branch (nn/ss2d.py, scan_impl="tm"): with save_cs=False (serving) and
//   with save_cs=True (_scan_core_fwd, the training forward, whose
//   chunk-entry states only the backward, selective_scan_bwd.cu, reads).
//
// Math, per batch b, group g and channel d of the group (dg channels):
//   delta = softplus(delta[b,g,t,d] + delta_bias[g*dg+d])  (softplus optional)
//   x_t   = exp(delta*A[g*dg+d,:]) * x_{t-1} + delta*B[b,g,t,:]*u[b,g,t,d]
//   y_t   = <C[b,g,t,:], x_t> + D[g*dg+d]*u[b,g,t,d]
// u, delta, y are (B, G, L, dg) and B, C are (B, G, L, N), fp32 or bf16; A
// is (G*dg, N), D and delta_bias are (G*dg,), fp32. The state x (N = 16) and
// all arithmetic are fp32; y is rounded to the input dtype once. With a
// non-null `last_state` the kernel also writes x_L as (B, G*dg, N) fp32: the
// decode cache a prefill hands to the single-token step.
//
// With a non-null `cs` (the training forward) each thread also writes its 16
// fp32 states at every kStateChunk-th step: cs[b, g, c, n, d] = the state
// entering step c * kStateChunk (zero for c = 0), nc = ceil(L / 16) chunks.
// The serving call passes null and compiles without the stores (a template
// flag), so serving runs the code it ran before the option existed.
//
// A sibling of selective_scan_bidir_fwd.cu, not a template mode of it: that
// kernel's block walks a pair of directions over one data stream and adds
// the second onto the first's fp32 output, while this one walks G groups of
// B/C once, writes y in the input dtype and may write the final state.
// Three flags through one body would make both harder to read, and the
// shipped bidirectional kernel stays as it was measured.
//
// What bounds it on an H100. At the Mamba-LM scoring shape (mamba-130m:
// batch 8, L = 1024, G*dg = 1536, fp32) one call moves about 0.15 GB (u,
// delta in, y out; B/C are 1 MB), 45 us at 3.35 TB/s, and computes about
// 2.0e8 exps (one per state and step, plus softplus), about 50 us at the
// SFU's rate: a floor near 0.05 ms, set by operations. The recurrence is
// sequential in t, and this design's parallelism is B*G*ceil(dg/64) blocks
// of 64 threads: at batch 1 only ceil(1536/64) = 24 blocks for 132 SMs,
// at batch 8 192 blocks of 2 warps. So it is latency bound, far above that
// floor. Splitting L with a carry pass, or the 16 states over lanes, is
// later work.
//
// What the design does about it:
//   * One thread per channel d keeps its 16 states and its A row (scaled by
//     log2(e), so each gate is one exp2f) in registers for the whole L.
//   * One block per (b, g, 64-channel tile).
//   * Per chunk of kChunk steps, the block stages the group's B/C (shared
//     by all its threads) and each thread's own u and delta in shared
//     memory, so the sequential loop reads no device memory. Neighbouring
//     threads load neighbouring channels of one step: coalesced.
//   * The ragged L and dg are masked; masked threads (d >= dg) still reach
//     every barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kN = 16;        // d_state
constexpr int kThreads = 64;  // channels per block, one thread each
constexpr int kChunk = 32;    // time steps staged in shared memory per pass
constexpr int kStateChunk = 16;  // steps between saved states (= bwd kChunk)
static_assert(kChunk % kStateChunk == 0, "a state chunk is inside a chunk");
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_io(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_io(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads)
grouped_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                   const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ D,
                   const float* __restrict__ delta_bias, T* __restrict__ y,
                   float* __restrict__ last_state, float* __restrict__ cs,
                   int G, int L, int dg, int apply_softplus) {
  __shared__ float s_u[kChunk][kThreads];
  __shared__ float s_delta[kChunk][kThreads];
  __shared__ float s_B[kChunk * kN];
  __shared__ float s_C[kChunk * kN];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const bool active = d < dg;

  const size_t seq = (size_t)(b * G + g) * L;  // first step of (b, g)
  const T* u_s = u + seq * dg;
  const T* delta_s = delta + seq * dg;
  const T* B_s = Bm + seq * kN;
  const T* C_s = Cm + seq * kN;
  T* y_s = y + seq * dg;
  const size_t row = (size_t)g * dg + d;  // channel among the G*dg
  float* cs_s =
      kSave ? cs + (size_t)(b * G + g) * ((L + kStateChunk - 1) / kStateChunk)
                       * kN * dg + d
            : nullptr;

  float a2[kN], x[kN];
  float skip = 0.f, bias = 0.f;
  if (active) {
#pragma unroll
    for (int n = 0; n < kN; ++n) a2[n] = A[row * kN + n] * kLog2e;
    skip = D[row];
    bias = delta_bias[row];
  } else {
#pragma unroll
    for (int n = 0; n < kN; ++n) a2[n] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) x[n] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int len = min(kChunk, L - t0);
    __syncthreads();  // the previous chunk is done with shared memory
    for (int i = tid; i < len * kN; i += kThreads) {
      const size_t off = (size_t)t0 * kN + i;
      s_B[i] = load_f32(B_s + off);
      s_C[i] = load_f32(C_s + off);
    }
    if (active) {
      for (int s = 0; s < len; ++s) {
        const size_t off = (size_t)(t0 + s) * dg + d;
        s_u[s][tid] = load_f32(u_s + off);
        s_delta[s][tid] = load_f32(delta_s + off);
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int s = 0; s < len; ++s) {
        if (kSave && s % kStateChunk == 0) {  // t0 is a multiple too
          float* dst = cs_s + (size_t)((t0 + s) / kStateChunk) * kN * dg;
#pragma unroll
          for (int n = 0; n < kN; ++n) dst[(size_t)n * dg] = x[n];
        }
        const float uu = s_u[s][tid];
        const float raw = s_delta[s][tid] + bias;
        const float dt = apply_softplus ? softplus(raw) : raw;
        const float du = dt * uu;
        float yv = 0.f;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          x[n] = exp2f(dt * a2[n]) * x[n] + du * s_B[s * kN + n];
          yv += s_C[s * kN + n] * x[n];
        }
        store_io(y_s + (size_t)(t0 + s) * dg + d, yv + skip * uu);
      }
    }
  }

  if (last_state != nullptr && active) {
    // (B, G*dg, N): the thread's 16 states are 64 contiguous, 64-byte
    // aligned bytes
    float4* dst = reinterpret_cast<float4*>(
        last_state + ((size_t)b * G * dg + row) * kN);
#pragma unroll
    for (int q = 0; q < kN / 4; ++q) {
      dst[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* Bm,
                   const void* Cm, const void* A, const void* D,
                   const void* delta_bias, void* y, void* last_state,
                   void* cs, int batch, int G, int L, int dg,
                   int apply_softplus, cudaStream_t stream) {
  const dim3 grid((dg + kThreads - 1) / kThreads, G, batch);
  auto kernel =
      cs ? grouped_fwd_kernel<T, true> : grouped_fwd_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(delta_bias), static_cast<T*>(y),
      static_cast<float*>(last_state), static_cast<float*>(cs), G, L, dg,
      apply_softplus);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are contiguous device buffers laid out as documented above;
// `last_state` is null (no final state) or (batch, G*dg, 16) fp32; `cs` is
// null (serving) or (batch, G, ceil(L / 16), 16, dg) fp32 (training).
extern "C" int selective_scan_fwd(const void* u, const void* delta,
                                  const void* Bm, const void* Cm,
                                  const void* A, const void* D,
                                  const void* delta_bias, void* y,
                                  void* last_state, void* cs, int batch,
                                  int G, int L, int dg, int n,
                                  int apply_softplus, int is_bf16,
                                  void* stream) {
  if (n != kN || batch <= 0 || batch > 65535 || G <= 0 || G > 65535 ||
      L <= 0 || dg <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(u, delta, Bm, Cm, A, D, delta_bias, y,
                                      last_state, cs, batch, G, L, dg,
                                      apply_softplus, s)
              : launch<float>(u, delta, Bm, Cm, A, D, delta_bias, y,
                              last_state, cs, batch, G, L, dg,
                              apply_softplus, s);
  return static_cast<int>(err);
}
