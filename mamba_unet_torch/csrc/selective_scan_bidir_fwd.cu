// Bidirectional selective-scan (S6) forward for SS2D, written for sm_90a.
//
// Replaces two Pallas TPU kernels that compute this same function:
//   * mamba_unet_tpu/ops/selective_scan_persistent.py::_bidir_kernel
//     (through persistent_scan_bidir; the TPU's stage-0 serving scan), and
//   * mamba_unet_tpu/ops/selective_scan_pallas.py::_fwd_kernel in bidir mode
//     (through selective_scan_pallas_bidir(merge_pairs=True); stages 1-3),
//     y output only. Its chunk-entry states feed only the backward.
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
// What bounds it on an H100. At stage 0 of the served model (bs24, L=3136,
// dg=192, fp32) one call reads about 0.39 GB of distinct input (u2 0.12,
// delta4 0.23, B4+C4 0.04), re-reads u2 and y in the reverse pass (0.23 GB),
// writes about 0.23 GB (y twice) and computes about 0.9 G exp. At 3.35 TB/s
// and the SFU's exp rate that is a floor near 0.25 ms. The recurrence is
// sequential in t, and this design's parallelism is only B*2*ceil(dg/64)
// blocks of 64 threads (144 blocks, about two warps per SM at stage 0), so
// it is latency bound, well above that floor.
//
// What the design does about it:
//   * One thread per channel d keeps its 16 states and its A row (scaled by
//     log2(e), so each gate is one exp2f) in registers for the whole L.
//   * One block per (b, m, 64-channel tile). Each thread runs direction m
//     forward and writes y, then runs direction m+2 backward and adds onto
//     the addresses it wrote itself. The pair merge therefore needs no
//     atomics and no ordering between blocks (the TPU kernel relied on grid
//     order for it; the GPU has none).
//   * Per chunk of kChunk steps, the block stages B/C (shared by all its
//     threads) and each thread's own u, delta and earlier y in shared memory,
//     so the sequential loop reads no device memory. Masked threads
//     (d >= dg) still reach every barrier.
// Raising the parallelism (states split over lanes, or L split with a carry
// pass) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kN = 16;        // d_state
constexpr int kThreads = 64;  // channels per block, one thread each
constexpr int kChunk = 32;    // time steps staged in shared memory per pass
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bidir_fwd_kernel(const T* __restrict__ u2, const T* __restrict__ delta4,
                 const T* __restrict__ B4, const T* __restrict__ C4,
                 const float* __restrict__ A, const float* __restrict__ D,
                 const float* __restrict__ delta_bias,
                 float* __restrict__ out, int L, int dg) {
  __shared__ float s_u[kChunk][kThreads];
  __shared__ float s_delta[kChunk][kThreads];
  __shared__ float s_y[kChunk][kThreads];
  __shared__ float s_B[kChunk * kN];
  __shared__ float s_C[kChunk * kN];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const int m = blockIdx.y;  // data stream: 0 = row-major, 1 = column-major
  const int b = blockIdx.z;
  const bool active = d < dg;

  const size_t stream = (size_t)(b * 2 + m) * L * dg;
  const T* u_s = u2 + stream;
  float* out_s = out + stream;

  // r = 0: direction m, forward in time; r = 1: direction m + 2, reversed.
  for (int r = 0; r < 2; ++r) {
    const int g = m + 2 * r;
    const size_t dir = (size_t)(b * 4 + g) * L;
    const T* delta_s = delta4 + dir * dg;
    const T* B_s = B4 + dir * kN;
    const T* C_s = C4 + dir * kN;

    float a2[kN], x[kN];
    float skip = 0.f, bias = 0.f;
    if (active) {
      const size_t row = (size_t)g * dg + d;
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

    for (int c0 = 0; c0 < L; c0 += kChunk) {
      const int len = min(kChunk, L - c0);
      const int t0 = r == 0 ? c0 : L - c0 - len;  // first data-order step
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
          if (r) s_y[s][tid] = out_s[off];
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll 4
        for (int i = 0; i < len; ++i) {
          const int s = r == 0 ? i : len - 1 - i;
          const float uu = s_u[s][tid];
          const float dt = softplus(s_delta[s][tid] + bias);
          const float du = dt * uu;
          float y = 0.f;
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            x[n] = exp2f(dt * a2[n]) * x[n] + du * s_B[s * kN + n];
            y += s_C[s * kN + n] * x[n];
          }
          y += skip * uu;
          if (r) y += s_y[s][tid];
          out_s[(size_t)(t0 + s) * dg + d] = y;
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* u2, const void* delta4, const void* B4,
                   const void* C4, const void* A, const void* D,
                   const void* delta_bias, void* out, int batch, int L,
                   int dg, cudaStream_t stream) {
  const dim3 grid((dg + kThreads - 1) / kThreads, 2, batch);
  bidir_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u2), static_cast<const T*>(delta4),
      static_cast<const T*>(B4), static_cast<const T*>(C4),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(delta_bias), static_cast<float*>(out), L, dg);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are contiguous device buffers laid out as documented above.
extern "C" int selective_scan_bidir_fwd(const void* u2, const void* delta4,
                                        const void* B4, const void* C4,
                                        const void* A, const void* D,
                                        const void* delta_bias, void* out,
                                        int batch, int L, int dg, int n,
                                        int is_bf16, void* stream) {
  if (n != kN || batch <= 0 || batch > 65535 || L <= 0 || dg <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(u2, delta4, B4, C4, A, D, delta_bias,
                                      out, batch, L, dg, s)
              : launch<float>(u2, delta4, B4, C4, A, D, delta_bias, out,
                              batch, L, dg, s);
  return static_cast<int>(err);
}
