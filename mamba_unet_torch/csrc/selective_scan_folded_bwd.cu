// Batch-folded selective-scan (S6) backward, written for sm_90a.
//
// Replaces the Pallas TPU kernel
//   mamba_unet_tpu/ops/selective_scan_folded.py::_bwd_kernel_folded
// (_scan_bwd_folded, the VJP of selective_scan_folded_bidir and
// selective_scan_folded), the backward of SS2D's batch-folded branch.
//
// Layout as in selective_scan_folded_fwd.cu: lane l of the B*dg lanes is
// channel d = l % dg of batch b = l / dg; u (S, L, B*dg) with S = 2 streams
// (bidir) or one per direction; delta, gy (G, L, B*dg) and B, C
// (G, L, N, B) in T (fp32 or bf16; gy in the I/O dtype, as the TPU kernel
// reads it); A (G*dg, 16), D and delta_bias (G*dg) fp32; cs (G, nc, 16,
// B*dg) fp32, the states entering each 16-step data chunk that the
// state-saving forward wrote. With bidir, direction g reads stream g % 2
// and g >= 2 runs in reversed time. Backward, per direction and lane,
// walking the direction's scan order in reverse (x_prev: the state before
// the step, a_t = exp(dt_t A)):
//   e_t   = C_t g_t + a_next e_next                        (dL/dx_t)
//   dΔ_t  = (sum_n e a x_prev A + sum_n e B u) * sigmoid(raw_t)  (softplus)
//   du_t  = sum_n e B dt + D g
//   dB_t  = sum_d e dt u,   dC_t = sum_d x_t g    (over the batch's dg)
//   dA    = sum_{b,t} e a x_prev dt,  dD = sum_{b,t} g u,  dΔbias = sum dΔ
// Outputs: ddelta in T; fp32 du per direction (G, L, B*dg), which the
// caller sums over each pair of directions reading one stream and rounds
// to T once; and fp32 partial sums that the caller reduces
// (deterministically, no atomics): dB/dC over channel tiles
// (ntile, G, B, L, 16), dA (B, G*dg, 16), dD and dΔbias (B, G*dg) over the
// batch. Every state and sum is fp32.
//
// What bounds it on an H100. At stage 0 of the Mamba-UNet trained with
// scan_impl="folded" (bs24, G=4, L=3136, dg=192, fp32) one call reads u
// (0.12 GB), delta, gy and cs (3 x 0.23 GB) and B/C (0.04 GB), and writes
// du (0.12 GB for the two streams), ddelta (0.23 GB) and dB/dC (0.04 GB):
// about 1.2 GB, 0.37 ms at 3.35 TB/s. It needs one exp per state and step
// plus softplus and sigmoid, about 1.2 G special-function results, 0.29
// ms, so the bound is the bytes. This kernel computes a_t twice (recompute
// and reverse), writes du per direction in fp32 (0.23 GB more) and runs
// G * B * ceil(dg/64) blocks of 64 threads (288 at that shape), each with
// two sequential passes over L: latency bound, like the grouped backward
// (selective_scan_bwd.cu), whose design and work it shares.
//
// What the design does about it:
//   * One block per (direction g, batch b, 64-channel tile of b), one
//     thread per lane: the block's lanes are contiguous and belong to one
//     batch, so the per-batch dB/dC sum over the batch's dg lanes is a sum
//     over the block (the TPU kernel reduces its lane tile with a 0/1
//     matrix on the MXU instead), and the sum over tiles is the caller's.
//   * Per data chunk of kChunk = 16 steps, walked in reverse scan order:
//     the block stages u, delta, gy and the batch's B/C in shared memory,
//     recomputes the chunk's 16 states per step from the saved entry state
//     into shared memory (17 x 16 x 64 fp32 = 68 KB, indexed by scan
//     position), then runs the reverse scan with the carry a e in
//     registers across chunks.
//   * dB/dC need a sum over channels every step: a transposing butterfly
//     over the warp (31 shuffles leave lane l with the warp's sum of value l
//     of the 32 dB|dC values) and one shared-memory add over the block's two
//     warps.
//   * dA/dD/dΔbias are per-thread register sums over time, written per
//     batch element; the caller sums over the batch.
//   * Masked threads (d >= dg) run with zero inputs: they reach every
//     barrier and shuffle and contribute exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kN = 16;        // d_state
constexpr int kThreads = 64;  // channels of one batch per block, one each
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;    // = the forward's kChunk (states every 16)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Smem {
  float x[kChunk + 1][kN][kThreads];  // [0]: chunk entry; [i+1]: after the
                                      // chunk's i-th step in scan order
  float u[kChunk][kThreads];          // by data step within the chunk
  float delta[kChunk][kThreads];      // raw delta, bias not yet added
  float g[kChunk][kThreads];
  float B[kChunk][kN];
  float C[kChunk][kN];
  float red[kWarps][kChunk][2 * kN];  // per-warp dB|dC sums by data step
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
folded_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ D,
                  const float* __restrict__ delta_bias,
                  const float* __restrict__ cs, const T* __restrict__ gy,
                  float* __restrict__ du_part, T* __restrict__ ddelta,
                  float* __restrict__ dB_part, float* __restrict__ dC_part,
                  float* __restrict__ dA_part, float* __restrict__ dD_part,
                  float* __restrict__ ddb_part, int batch, int G, int L,
                  int dg, int bidir, int apply_softplus) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane_w = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int d = tile * kThreads + tid;
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  const bool active = d < dg;
  const bool rev = bidir && g >= 2;
  const int stream = bidir ? (g & 1) : g;
  const int nc = (L + kChunk - 1) / kChunk;

  const size_t BD = (size_t)batch * dg;  // lanes of one (g, t) row
  const size_t lane = (size_t)b * dg + d;
  const T* u_s = u + (size_t)stream * L * BD + lane;  // + t * BD
  const size_t dir = (size_t)g * L * BD + lane;
  const T* delta_s = delta + dir;
  const T* g_s = gy + dir;
  float* du_s = du_part + dir;
  T* ddelta_s = ddelta + dir;
  const T* B_s = Bm + (size_t)g * L * kN * batch + b;  // + (t*kN + n)*batch
  const T* C_s = Cm + (size_t)g * L * kN * batch + b;
  const float* cs_s = cs + (size_t)g * nc * kN * BD + lane;
  const size_t part = (((size_t)tile * G + g) * batch + b) * L * kN;
  float* dB_s = dB_part + part;
  float* dC_s = dC_part + part;
  const size_t row = (size_t)g * dg + d;  // channel among the G*dg

  float a2[kN], carry[kN], dA[kN];
  float skip = 0.f, bias = 0.f;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a2[n] = active ? A[row * kN + n] * kLog2e : 0.f;
    carry[n] = 0.f;
    dA[n] = 0.f;
  }
  if (active) {
    skip = D[row];
    bias = delta_bias[row];
  }
  float dD = 0.f, ddb = 0.f;

  for (int k = nc - 1; k >= 0; --k) {  // scan chunks, the last first
    const int c = rev ? nc - 1 - k : k;  // its data chunk
    const int t0 = c * kChunk;
    const int len = min(kChunk, L - t0);
    __syncthreads();  // the previous chunk is done with shared memory
    for (int i = tid; i < len * kN; i += kThreads) {  // i = s * kN + n
      const size_t off = ((size_t)t0 * kN + i) * batch;
      (&sm.B[0][0])[i] = load_f32(B_s + off);
      (&sm.C[0][0])[i] = load_f32(C_s + off);
    }
    for (int s = 0; s < len; ++s) {
      float uu = 0.f, dl = 0.f, gg = 0.f;
      if (active) {
        const size_t off = (size_t)(t0 + s) * BD;
        uu = load_f32(u_s + off);
        dl = load_f32(delta_s + off);
        gg = load_f32(g_s + off);
      }
      sm.u[s][tid] = uu;
      sm.delta[s][tid] = dl;
      sm.g[s][tid] = gg;
    }
    float x[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      x[n] = active ? cs_s[((size_t)c * kN + n) * BD] : 0.f;
      sm.x[0][n][tid] = x[n];
    }
    __syncthreads();

    // recompute the chunk's states from its entry state, in scan order
    for (int i = 0; i < len; ++i) {
      const int s = rev ? len - 1 - i : i;
      const float raw = sm.delta[s][tid] + bias;
      const float dt = apply_softplus ? softplus(raw) : raw;
      const float du_in = dt * sm.u[s][tid];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        x[n] = exp2f(dt * a2[n]) * x[n] + du_in * sm.B[s][n];
        sm.x[i + 1][n][tid] = x[n];
      }
    }

    // reverse scan over the chunk
    for (int i = len - 1; i >= 0; --i) {
      const int s = rev ? len - 1 - i : i;
      const float uu = sm.u[s][tid];
      const float raw = sm.delta[s][tid] + bias;
      const float dt = apply_softplus ? softplus(raw) : raw;
      const float gg = sm.g[s][tid];
      float v[2 * kN];
      float dd_a = 0.f, ddu = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float a = exp2f(dt * a2[n]);
        const float e = sm.C[s][n] * gg + carry[n];
        const float eax = e * a * sm.x[i][n][tid];  // e a x_prev
        dd_a += eax * a2[n];
        ddu += e * sm.B[s][n];
        dA[n] += eax * dt;
        v[n] = e * dt * uu;                    // dB contribution
        v[kN + n] = sm.x[i + 1][n][tid] * gg;  // dC contribution
        carry[n] = a * e;
      }
      float ddt = dd_a * kLn2 + ddu * uu;
      if (apply_softplus) ddt *= sigmoid(raw);
      dD += gg * uu;
      ddb += ddt;
      if (active) {
        const size_t off = (size_t)(t0 + s) * BD;
        store(ddelta_s + off, ddt);
        du_s[off] = ddu * dt + skip * gg;
      }
      sm.red[warp][s][lane_w] = transpose_sum(v, lane_w);
    }
    __syncthreads();
    for (int i = tid; i < len * 2 * kN; i += kThreads) {
      const int s = i / (2 * kN);
      const int q = i % (2 * kN);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += sm.red[w][s][q];
      const size_t off = (size_t)(t0 + s) * kN + (q % kN);
      (q < kN ? dB_s : dC_s)[off] = sum;
    }
  }

  if (active) {
    const size_t out = (size_t)b * G * dg + row;
#pragma unroll
    for (int n = 0; n < kN; ++n) dA_part[out * kN + n] = dA[n];
    dD_part[out] = dD;
    ddb_part[out] = ddb;
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* Bm,
                   const void* Cm, const void* A, const void* D,
                   const void* delta_bias, const void* cs, const void* gy,
                   void* du_part, void* ddelta, void* dB_part, void* dC_part,
                   void* dA_part, void* dD_part, void* ddb_part, int batch,
                   int G, int L, int dg, int bidir, int apply_softplus,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      folded_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((dg + kThreads - 1) / kThreads, batch, G);
  folded_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(delta_bias), static_cast<const float*>(cs),
      static_cast<const T*>(gy), static_cast<float*>(du_part),
      static_cast<T*>(ddelta), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), static_cast<float*>(dA_part),
      static_cast<float*>(dD_part), static_cast<float*>(ddb_part), batch, G,
      L, dg, bidir, apply_softplus);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
// Pointers are contiguous device buffers laid out as documented above.
extern "C" int selective_scan_folded_bwd(
    const void* u, const void* delta, const void* Bm, const void* Cm,
    const void* A, const void* D, const void* delta_bias, const void* cs,
    const void* gy, void* du_part, void* ddelta, void* dB_part,
    void* dC_part, void* dA_part, void* dD_part, void* ddb_part, int batch,
    int G, int L, int dg, int n, int bidir, int apply_softplus, int is_bf16,
    void* stream) {
  if (n != kN || batch <= 0 || batch > 65535 || G <= 0 || G > 65535 ||
      L <= 0 || dg <= 0 || (bidir && G != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(u, delta, Bm, Cm, A, D, delta_bias, cs,
                                      gy, du_part, ddelta, dB_part, dC_part,
                                      dA_part, dD_part, ddb_part, batch, G, L,
                                      dg, bidir, apply_softplus, s)
              : launch<float>(u, delta, Bm, Cm, A, D, delta_bias, cs, gy,
                              du_part, ddelta, dB_part, dC_part, dA_part,
                              dD_part, ddb_part, batch, G, L, dg, bidir,
                              apply_softplus, s);
  return static_cast<int>(err);
}
