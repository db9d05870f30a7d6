// Batch-folded selective-scan (S6) forward, written for sm_90a.
//
// Replaces the Pallas TPU kernel
//   mamba_unet_tpu/ops/selective_scan_folded.py::_fwd_kernel_folded
// (_scan_fwd_folded, the call of selective_scan_folded_bidir and
// selective_scan_folded), the scan of SS2D's batch-folded branch
// (nn/ss2d.py, scan_impl="folded"): with save_cs=False (serving, under no
// grad) and save_cs=True (the training forward, whose chunk-entry states
// only the backward, selective_scan_folded_bwd.cu, reads).
//
// Layout. The batch is folded into the channel axis: lane l of the B*dg
// lanes is channel d = l % dg of batch b = l / dg. u is (S, L, B*dg): S = 2
// data streams (bidir) or one per direction; delta and y are (G, L, B*dg)
// and B, C are (G, L, N, B), fp32 or bf16; A is (G*dg, N), D and
// delta_bias are (G*dg,), fp32. Direction g reads stream g % 2 (bidir) or
// g; with bidir, directions g >= 2 scan their stream in reversed time.
// Math, per direction g and lane (b, d), in the direction's scan order:
//   delta = softplus(delta[g,t,l] + delta_bias[g*dg+d])  (softplus optional)
//   x_t   = exp(delta*A[g*dg+d,:]) * x_prev + delta*B[g,t,:,b]*u[s,t,l]
//   y_t   = <C[g,t,:,b], x_t> + D[g*dg+d]*u[s,t,l]
// y is written per direction in data order (not pair-summed), rounded to
// the input dtype once; the state (N = 16) and all arithmetic are fp32.
//
// With a non-null `cs` (the training forward) each thread also writes its
// 16 fp32 states entering every chunk of kChunk data steps in its scan
// order: cs[g, c, n, l] is the state before steps [16c, 16c + 16) are
// scanned - after the steps before 16c going forward, after the steps from
// 16c + 16 on going backward. The chunks are fixed in data time for both
// orders, as the TPU kernel's are. The serving call passes null and
// compiles without the stores (a template flag).
//
// What bounds it on an H100. At stage 0 of the Mamba-UNet trained with
// scan_impl="folded" (bs24, G=4, L=3136, dg=192, fp32) one call reads u (2
// streams, 0.12 GB), delta (0.23 GB) and B/C (0.04 GB), writes y (0.23 GB)
// and, training, cs (0.23 GB): 0.6-0.85 GB, 0.18-0.25 ms at 3.35 TB/s. It
// computes 16 exps per (direction, step, lane), 0.93 G plus softplus, about
// 0.23 ms at the SFU's rate. The recurrence is sequential in t; this
// design's parallelism is G * B * ceil(dg/64) blocks of 64 threads (288 at
// that shape), each walking all of L: latency bound, like the grouped
// forward (selective_scan_fwd.cu), whose work it does.
//
// What the design does about it:
//   * One thread per lane keeps its 16 states and its A row (scaled by
//     log2(e), so each gate is one exp2f) in registers for the whole L.
//   * One block per (direction g, batch b, tile of 64 channels of b): the
//     tile's lanes are contiguous in every (g, t) row, so u/delta/y loads
//     and stores coalesce, and the whole block shares one batch's B/C. A
//     tile never straddles two batches (at the model's widths dg is a
//     multiple of 64, so no lane idles; a ragged dg masks the last tile).
//     The TPU kernel folds the batch into its lane tile to fill 128-lane
//     vregs, and broadcasts per-batch B/C across lanes with a 0/1 matrix on
//     the MXU; here the broadcast is the index b = blockIdx.y.
//   * Per data chunk of kChunk steps, the block stages the batch's B/C and
//     each thread's own u and delta in shared memory; a reversed direction
//     walks the chunks, and the steps inside each, from the last.
//   * The ragged L and dg are masked; masked threads (d >= dg) still reach
//     every barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kN = 16;        // d_state
constexpr int kThreads = 64;  // channels of one batch per block, one each
constexpr int kChunk = 16;    // data steps staged per pass = between states
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
folded_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ D,
                  const float* __restrict__ delta_bias, T* __restrict__ y,
                  float* __restrict__ cs, int batch, int L, int dg, int bidir,
                  int apply_softplus) {
  __shared__ float s_u[kChunk][kThreads];
  __shared__ float s_delta[kChunk][kThreads];
  __shared__ float s_B[kChunk * kN];
  __shared__ float s_C[kChunk * kN];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  const bool active = d < dg;
  const bool rev = bidir && g >= 2;
  const int stream = bidir ? (g & 1) : g;
  const int nc = (L + kChunk - 1) / kChunk;

  const size_t BD = (size_t)batch * dg;  // lanes of one (g, t) row
  const size_t lane = (size_t)b * dg + d;
  const T* u_s = u + (size_t)stream * L * BD + lane;  // + t * BD
  const T* delta_s = delta + (size_t)g * L * BD + lane;
  T* y_s = y + (size_t)g * L * BD + lane;
  const T* B_s = Bm + (size_t)g * L * kN * batch + b;  // + (t*kN + n)*batch
  const T* C_s = Cm + (size_t)g * L * kN * batch + b;
  float* cs_s = kSave ? cs + (size_t)g * nc * kN * BD + lane : nullptr;
  const size_t row = (size_t)g * dg + d;  // channel among the G*dg

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

  for (int k = 0; k < nc; ++k) {
    const int c = rev ? nc - 1 - k : k;  // data chunk of scan chunk k
    const int t0 = c * kChunk;
    const int len = min(kChunk, L - t0);
    __syncthreads();  // the previous chunk is done with shared memory
    for (int i = tid; i < len * kN; i += kThreads) {  // i = s * kN + n
      const size_t off = ((size_t)t0 * kN + i) * batch;
      s_B[i] = load_f32(B_s + off);
      s_C[i] = load_f32(C_s + off);
    }
    if (active) {
      for (int s = 0; s < len; ++s) {
        const size_t off = (size_t)(t0 + s) * BD;
        s_u[s][tid] = load_f32(u_s + off);
        s_delta[s][tid] = load_f32(delta_s + off);
      }
    }
    __syncthreads();
    if (active) {
      if (kSave) {
        float* dst = cs_s + (size_t)c * kN * BD;
#pragma unroll
        for (int n = 0; n < kN; ++n) dst[(size_t)n * BD] = x[n];
      }
#pragma unroll 4
      for (int i = 0; i < len; ++i) {
        const int s = rev ? len - 1 - i : i;
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
        store_io(y_s + (size_t)(t0 + s) * BD, yv + skip * uu);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* Bm,
                   const void* Cm, const void* A, const void* D,
                   const void* delta_bias, void* y, void* cs, int batch,
                   int G, int L, int dg, int bidir, int apply_softplus,
                   cudaStream_t stream) {
  const dim3 grid((dg + kThreads - 1) / kThreads, batch, G);
  auto kernel = cs ? folded_fwd_kernel<T, true> : folded_fwd_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(delta_bias), static_cast<T*>(y),
      static_cast<float*>(cs), batch, L, dg, bidir, apply_softplus);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are contiguous device buffers laid out as documented above; `cs`
// is null (serving) or (G, ceil(L / 16), 16, batch*dg) fp32 (training).
// With bidir, G must be 4 and u holds 2 streams; without, u holds G.
extern "C" int selective_scan_folded_fwd(const void* u, const void* delta,
                                         const void* Bm, const void* Cm,
                                         const void* A, const void* D,
                                         const void* delta_bias, void* y,
                                         void* cs, int batch, int G, int L,
                                         int dg, int n, int bidir,
                                         int apply_softplus, int is_bf16,
                                         void* stream) {
  if (n != kN || batch <= 0 || batch > 65535 || G <= 0 || G > 65535 ||
      L <= 0 || dg <= 0 || (bidir && G != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(u, delta, Bm, Cm, A, D, delta_bias, y,
                                      cs, batch, G, L, dg, bidir,
                                      apply_softplus, s)
              : launch<float>(u, delta, Bm, Cm, A, D, delta_bias, y, cs,
                              batch, G, L, dg, bidir, apply_softplus, s);
  return static_cast<int>(err);
}
