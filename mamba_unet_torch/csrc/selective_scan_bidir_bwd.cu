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
// bf16); A (4*dg,16), D and delta_bias (4*dg) fp32; cs (B,4,nc,16,dg) fp32,
// the chunk-entry states the state-saving forward wrote (nc = ceil(L/16));
// gy (B,2,L,dg) fp32. Outputs: du2 (B,2,L,dg) fp32, ddelta4 (B,4,L,dg) in T,
// and fp32 partial sums that the caller reduces (deterministically, no
// atomics): dB/dC over channel tiles (ntile,B,4,L,16), dA (B,4*dg,16), dD and
// dΔbias (B,4*dg) over the batch.
//
// What bounds it on an H100. At stage 0 of the trained model (bs24, L=3136,
// dg=192, fp32) one call reads u2, delta4, gy (0.06 + 0.23 + 0.12 GB), cs
// (0.23 GB) and B/C, and writes du2, ddelta4 and the dB/dC partials (0.12 +
// 0.23 + 0.06 GB): about 1.1 GB, 0.33 ms at 3.35 TB/s. The gradient needs
// one exp per state and step (a_t, about 0.9 G with softplus and sigmoid),
// under 0.3 ms on the SFUs, so the bound is the bytes. This kernel computes
// a_t twice (recompute and reverse): about 1.8 G. Like the forward, it is
// latency bound: its parallelism is B*2*ceil(dg/64) blocks of 64 threads,
// each running two sequential passes over L.
//
// What the design does about it:
//   * One block per (b, m, 64-channel tile), one thread per channel, both
//     directions of the pair in the same thread (as the forward): du of
//     stream m sums onto addresses the thread owns, with no atomics.
//   * Per chunk of kChunk = 16 scan steps, walked from the last: the block
//     stages u, delta, gy and the shared B/C in shared memory, recomputes the
//     chunk's 16 states per step from the saved entry state into shared
//     memory (17 x 16 x 64 fp32 = 68 KB), then runs the reverse scan with
//     the carry a_{t+1} e_{t+1} in registers across chunks.
//   * dB/dC need a sum over channels every step: a transposing butterfly
//     over the warp (31 shuffles leave lane l with the warp's sum of value
//     l of the 32 dB|dC values) and one shared-memory add over the block's
//     two warps; the sum over channel tiles is left to the caller.
//   * dA/dD/dΔbias are per-thread register sums over time, written per
//     batch element; the caller sums over the batch.
//   * Masked threads (d >= dg) run with zero inputs: they reach every
//     barrier and shuffle and contribute exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kN = 16;        // d_state
constexpr int kThreads = 64;  // channels per block, one thread each
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;    // = the forward's kStateChunk
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Smem {
  float x[kChunk + 1][kN][kThreads];  // [0]: chunk entry; [i+1]: after step i
  float u[kChunk][kThreads];          // staged by data-order slot
  float delta[kChunk][kThreads];      // raw delta4, bias not yet added
  float g[kChunk][kThreads];
  float B[kChunk][kN];
  float C[kChunk][kN];
  float red[kWarps][kChunk][2 * kN];  // per-warp dB|dC sums by slot
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// One level of the transposing warp sum: lanes with bit W set keep the
// upper W values and send the lower W; the partner does the opposite.
template <int W>
__device__ __forceinline__ void transpose_sum_level(float (&v)[2 * kN],
                                                    int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// After this, v[0] of lane l is the sum over the warp's lanes of v[l].
__device__ __forceinline__ float transpose_sum(float (&v)[2 * kN], int lane) {
  transpose_sum_level<16>(v, lane);
  transpose_sum_level<8>(v, lane);
  transpose_sum_level<4>(v, lane);
  transpose_sum_level<2>(v, lane);
  transpose_sum_level<1>(v, lane);
  return v[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
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
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int d = tile * kThreads + tid;
  const int m = blockIdx.y;  // data stream: 0 = row-major, 1 = column-major
  const int b = blockIdx.z;
  const bool active = d < dg;
  const int nc = (L + kChunk - 1) / kChunk;

  const size_t stream = (size_t)(b * 2 + m) * L * dg;
  const T* u_s = u2 + stream;
  const float* g_s = gy + stream;
  float* du_s = du2 + stream;

  // r = 0: direction m (forward in time); r = 1: direction m + 2 (reversed)
  for (int r = 0; r < 2; ++r) {
    const int g = m + 2 * r;
    const size_t dir = (size_t)(b * 4 + g) * L;
    const T* delta_s = delta4 + dir * dg;
    T* ddelta_s = ddelta4 + dir * dg;
    const T* B_s = B4 + dir * kN;
    const T* C_s = C4 + dir * kN;
    const float* cs_g = cs + (size_t)(b * 4 + g) * nc * kN * dg + d;
    const size_t part = ((size_t)tile * batch * 4 + b * 4 + g) * L * kN;
    float* dB_s = dB_part + part;
    float* dC_s = dC_part + part;

    float a2[kN], carry[kN], dA[kN];
    float skip = 0.f, bias = 0.f;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      a2[n] = active ? A[((size_t)g * dg + d) * kN + n] * kLog2e : 0.f;
      carry[n] = 0.f;
      dA[n] = 0.f;
    }
    if (active) {
      skip = D[(size_t)g * dg + d];
      bias = delta_bias[(size_t)g * dg + d];
    }
    float dD = 0.f, ddb = 0.f;

    for (int c = nc - 1; c >= 0; --c) {
      const int c0 = c * kChunk;
      const int len = min(kChunk, L - c0);
      const int t0 = r == 0 ? c0 : L - c0 - len;  // first data-order step
      __syncthreads();  // the previous chunk is done with shared memory
      for (int i = tid; i < len * kN; i += kThreads) {
        const size_t off = (size_t)t0 * kN + i;
        (&sm.B[0][0])[i] = load_f32(B_s + off);
        (&sm.C[0][0])[i] = load_f32(C_s + off);
      }
      for (int s = 0; s < len; ++s) {
        float uu = 0.f, dl = 0.f, gg = 0.f;
        if (active) {
          const size_t off = (size_t)(t0 + s) * dg + d;
          uu = load_f32(u_s + off);
          dl = load_f32(delta_s + off);
          gg = g_s[off];
        }
        sm.u[s][tid] = uu;
        sm.delta[s][tid] = dl;
        sm.g[s][tid] = gg;
      }
      float x[kN];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        x[n] = active ? cs_g[((size_t)c * kN + n) * dg] : 0.f;
        sm.x[0][n][tid] = x[n];
      }
      __syncthreads();

      // recompute the chunk's states in scan order from its entry state
      for (int i = 0; i < len; ++i) {
        const int s = r == 0 ? i : len - 1 - i;
        const float dt = softplus(sm.delta[s][tid] + bias);
        const float du = dt * sm.u[s][tid];
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          x[n] = exp2f(dt * a2[n]) * x[n] + du * sm.B[s][n];
          sm.x[i + 1][n][tid] = x[n];
        }
      }

      // reverse scan over the chunk
      for (int i = len - 1; i >= 0; --i) {
        const int s = r == 0 ? i : len - 1 - i;
        const float uu = sm.u[s][tid];
        const float raw = sm.delta[s][tid] + bias;
        const float dt = softplus(raw);
        const float gg = sm.g[s][tid];
        float v[2 * kN];
        float dd_a = 0.f, ddu = 0.f;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float a = exp2f(dt * a2[n]);
          const float e = sm.C[s][n] * gg + carry[n];
          const float eax = e * a * sm.x[i][n][tid];  // e a x_{t-1}
          dd_a += eax * a2[n];
          ddu += e * sm.B[s][n];
          dA[n] += eax * dt;
          v[n] = e * dt * uu;                 // dB contribution
          v[kN + n] = sm.x[i + 1][n][tid] * gg;  // dC contribution
          carry[n] = a * e;
        }
        const float ddt = (dd_a * kLn2 + ddu * uu) * sigmoid(raw);
        dD += gg * uu;
        ddb += ddt;
        if (active) {
          const size_t off = (size_t)(t0 + s) * dg + d;
          store(ddelta_s + off, ddt);
          const float du = ddu * dt + skip * gg;
          du_s[off] = r == 0 ? du : du_s[off] + du;
        }
        sm.red[warp][s][lane] = transpose_sum(v, lane);
      }
      __syncthreads();
      for (int i = tid; i < len * 2 * kN; i += kThreads) {
        const int s = i / (2 * kN);
        const int k = i % (2 * kN);
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += sm.red[w][s][k];
        const size_t off = (size_t)(t0 + s) * kN + (k % kN);
        (k < kN ? dB_s : dC_s)[off] = sum;
      }
    }

    if (active) {
      const size_t row = (size_t)b * 4 * dg + (size_t)g * dg + d;
#pragma unroll
      for (int n = 0; n < kN; ++n) dA_part[row * kN + n] = dA[n];
      dD_part[row] = dD;
      ddb_part[row] = ddb;
    }
  }
}

template <typename T>
cudaError_t launch(const void* u2, const void* delta4, const void* B4,
                   const void* C4, const void* A, const void* D,
                   const void* delta_bias, const void* cs, const void* gy,
                   void* du2, void* ddelta4, void* dB_part, void* dC_part,
                   void* dA_part, void* dD_part, void* ddb_part, int batch,
                   int L, int dg, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      bidir_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((dg + kThreads - 1) / kThreads, 2, batch);
  bidir_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
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
