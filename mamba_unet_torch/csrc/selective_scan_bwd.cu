// Unidirectional grouped selective-scan (S6) backward, written for sm_90a.
//
// Replaces the Pallas TPU kernel
//   mamba_unet_tpu/ops/selective_scan_pallas.py::_bwd_kernel
// in its unidirectional mode (_scan_bwd_impl(bidir=False), through
// _scan_core_bwd: the VJP of selective_scan_pallas_tm), the backward of
// every 1-D Mamba layer and of SS2D's time-major branch.
//
// Forward (selective_scan_fwd.cu), per batch b, group g, channel d of the
// group: raw_t = delta[b,g,t,d] + delta_bias[g*dg+d], dt_t = softplus(raw_t)
// (or raw_t without softplus), a_t = exp(dt_t A), x_t = a_t x_{t-1} +
// dt_t B_t u_t, y_t = <C_t, x_t> + D u_t. Backward, walking t in reverse:
//   e_t   = C_t g_t + a_{t+1} e_{t+1}                     (dL/dx_t)
//   dΔ_t  = (sum_n e a x_{t-1} A + sum_n e B u) * sigmoid(raw_t)  (softplus)
//   du_t  = sum_n e B dt + D g
//   dB_t  = sum_d e dt u,   dC_t = sum_d x_t g      (over the group's dg)
//   dA    = sum_{b,t} e a x_{t-1} dt,  dD = sum_{b,t} g u,  dΔbias = sum dΔ
//
// Inputs: u, delta, gy (B,G,L,dg) and B, C (B,G,L,16) in T (fp32 or bf16;
// gy in the I/O dtype, as the TPU kernel reads it); A (G*dg,16), D and
// delta_bias (G*dg) fp32; cs (B,G,nc,16,dg) fp32, the chunk-entry states the
// state-saving forward wrote (nc = ceil(L/16)). Outputs: du, ddelta in T,
// and fp32 partial sums that the caller reduces (deterministically, no
// atomics): dB/dC over 32-channel tiles (ceil(dg/32),B,G,L,16), dA
// (B,G*dg,16), dD and dΔbias (B,G*dg) over the batch. Every state and sum
// is fp32.
//
// With a forward that started from an incoming state x_init (cs then holds
// it as chunk 0's entry state, so step 0's dΔ and dA see x_{-1} = x_init
// with no special case), and a forward whose last state x_{L-1} reaches
// the loss: a non-null `g_last` (B,G*dg,16) fp32 is the cotangent of that
// state, from which e_{L-1} starts (e_{L-1} = C g + g_last); a non-null
// `dx_init` (B,G*dg,16) fp32 receives a_0 e_0, the cotangent of x_init.
// Both are null for the plain scan (the folded backward passes null).
//
// What bounds it on an H100. At stage 0 of the trained Mamba-UNet with
// scan_impl="tm" (bs24, G=4, L=3136, dg=192, fp32) one call reads u, delta,
// gy (3 x 0.23 GB), cs (0.23 GB) and B/C (0.04 GB), and writes du and
// ddelta (0.46 GB) and the dB/dC partials: about 1.46 GB with the summed
// dB/dC, 0.44 ms at 3.35 TB/s. It needs one exp per state and step (a_t)
// plus softplus and sigmoid, about 1.2 G special-function results, under
// 0.3 ms, so the bound is the bytes. The design this one replaces (one
// thread per channel holding all 16 states, a chunk's 17 x 16 x 64
// recomputed states in 68 KB of shared memory, blocks of 64 threads, 2.2
// warps per SM in the grid at stage 0) took 10.07 ms per stage-0 call and
// 1.683 ms at the mamba-130m shape (8, 1, 1024, 1536) (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700 W).
//
// The design is that of selective_scan_bidir_bwd.cu, on the device body
// selective_scan_bwd_group.cuh shares with selective_scan_folded_bwd.cu:
//   * States split over lanes: 4 lanes per channel, 4 states each; sums
//     over n (dΔ, du) take two shuffles.
//   * A block is two 16-channel groups of the same (b, g), both walking
//     time backwards in lockstep: grid (ceil(dg/32), G, B), 576 blocks at
//     stage 0 of the tm branch and 384 at the mamba-130m shape. There is
//     no stream to merge: du is written straight in T.
//   * Each 16-step chunk is recomputed from its saved entry state in two
//     8-step halves with the states in registers (2.5 exps per state and
//     step); registers are capped so that 5 blocks fit per SM. Measured
//     (chip_smoke.py [kernel_occ], NVIDIA H100 80GB HBM3, 700 W): 96
//     registers, 16 bytes of local memory (spills), 38 KB of dynamic shared
//     memory, 5 blocks (20 warps) per SM; 17.5 warps per SM in the grid and
//     0.87 waves at stage 0, 0.58 waves at the mamba-130m shape.
//   * The next chunk's u, delta, gy, B, C and entry states are copied into
//     shared memory with cp.async while the current chunk computes: u,
//     delta and gy by 4-byte values (bf16 by channel pairs, which needs an
//     even dg: an odd dg in bf16 loads them plainly), B and C by 16-byte
//     copies, the entry states as 16 rows of 16 channels (four 16-byte copies
//     a row when dg is a multiple of 4, else 4-byte copies). dt =
//     softplus(raw), dt*u and sigmoid(raw) are computed once per element;
//     the four lanes of a channel read them by broadcast.
//   * Gates by one SFU ex2 with subnormals flushed to zero (exp2_ftz).
//   * dB/dC: a transposing butterfly over the 8 channels of a warp (7
//     shuffles), then the block's 4 warps summed in shared memory in a
//     fixed order and written as one partial per 32-channel tile: at stage
//     0 6 tiles, 0.23 GB of dB/dC partials written and re-read by the
//     wrapper's sum (16-channel tiles would double that).
//   * dA/dD/dΔbias are per-thread register sums over time, written per
//     batch element; the caller sums over the batch.
//   * Masked threads (d >= dg) run with zero inputs: they reach every
//     barrier and shuffle and contribute exact zeros. Steps past a ragged
//     last chunk are skipped by a predicate uniform over the block.
// Where the time goes now (chip_smoke.py and scripts/scan_phases.py, same
// card): 2.67 ms per stage-0 call with the wrapper's sums (6.1x its bound;
// 2.55 ms the kernel alone), 19.05 ms per tm step, 0.737 ms per mamba-130m
// call. Of the kernel's time at stage 0, 68 % is the recompute and
// reverse, 13 % waiting for the copies and converting, 11 % the write-out
// and 8 % issuing the next chunk's copies. All of stage 0's warps are
// resident, about 4 per scheduler, and they do not hide the reverse step's
// chains (shuffle sums, the dB/dC butterfly, the exps): latency bound, as
// the bidirectional backward is.

#include "selective_scan_bwd_group.cuh"

namespace {

using namespace scan_bwd;

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grouped_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                   const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ D,
                   const float* __restrict__ delta_bias,
                   const float* __restrict__ cs, const T* __restrict__ gy,
                   T* __restrict__ du, T* __restrict__ ddelta,
                   float* __restrict__ dB_part, float* __restrict__ dC_part,
                   float* __restrict__ dA_part, float* __restrict__ dD_part,
                   float* __restrict__ ddb_part,
                   const float* __restrict__ g_last,
                   float* __restrict__ dx_init, int batch, int G, int L,
                   int dg, int apply_softplus, int flags) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int d0 = (2 * tile + threadIdx.x / kGroup) * kCh;  // group's first
  const int nc = (L + kChunk - 1) / kChunk;
  const size_t seq = (size_t)(b * G + g) * L;  // first step of (b, g)
  const size_t part = (((size_t)tile * batch + b) * G + g) * L * kN;
  const size_t row = (size_t)g * dg + d0;      // channel among the G*dg
  const size_t out = (size_t)b * G * dg + row;

  Group<T, T> io;
  io.u = u + seq * dg + d0;
  io.delta = delta + seq * dg + d0;
  io.gy = gy + seq * dg + d0;
  io.B = Bm + seq * kN;
  io.C = Cm + seq * kN;
  io.cs = cs + (size_t)(b * G + g) * nc * kN * dg + d0;
  io.du = du + seq * dg + d0;
  io.ddelta = ddelta + seq * dg + d0;
  io.dB = dB_part + part;
  io.dC = dC_part + part;
  io.A = A + row * kN;
  io.D = D + row;
  io.bias = delta_bias + row;
  io.dA = dA_part + out * kN;
  io.dD = dD_part + out;
  io.ddb = ddb_part + out;
  io.g_last = g_last != nullptr ? g_last + out * kN : nullptr;
  io.dx_init = dx_init != nullptr ? dx_init + out * kN : nullptr;
  io.u_base = u;
  io.B_base = Bm;
  io.cs_base = cs;
  io.ts = dg;
  io.cns = dg;
  io.nvalid = min(kCh, dg - d0);
  group_bwd<false>(io, L, apply_softplus != 0, flags, smem_raw);
}

template <typename T>
const void* kernel_of() {
  return reinterpret_cast<const void*>(grouped_bwd_kernel<T>);
}

dim3 grid_of(int batch, int G, int dg) {
  return dim3((dg + 2 * kCh - 1) / (2 * kCh), G, batch);
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* Bm,
                   const void* Cm, const void* A, const void* D,
                   const void* delta_bias, const void* cs, const void* gy,
                   void* du, void* ddelta, void* dB_part, void* dC_part,
                   void* dA_part, void* dD_part, void* ddb_part,
                   const void* g_last, void* dx_init, int batch, int G,
                   int L, int dg, int apply_softplus, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      grouped_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  int flags = 0;
  if (sizeof(T) == 4 || (dg % 2 == 0 && aligned(u, 4) &&
                         aligned(delta, 4) && aligned(gy, 4))) {
    flags |= kPairs;
  }
  if (aligned(Bm, 16) && aligned(Cm, 16)) flags |= kBCVec;
  if (dg % 4 == 0 && aligned(cs, 16)) flags |= kCSVec;
  grouped_bwd_kernel<T><<<grid_of(batch, G, dg), kThreads, kSmem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(delta_bias), static_cast<const float*>(cs),
      static_cast<const T*>(gy), static_cast<T*>(du), static_cast<T*>(ddelta),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<float*>(dA_part), static_cast<float*>(dD_part),
      static_cast<float*>(ddb_part), static_cast<const float*>(g_last),
      static_cast<float*>(dx_init), batch, G, L, dg, apply_softplus, flags);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
// Pointers are contiguous device buffers laid out as documented above;
// `g_last` and `dx_init` may be null.
extern "C" int selective_scan_bwd(
    const void* u, const void* delta, const void* Bm, const void* Cm,
    const void* A, const void* D, const void* delta_bias, const void* cs,
    const void* gy, void* du, void* ddelta, void* dB_part, void* dC_part,
    void* dA_part, void* dD_part, void* ddb_part, const void* g_last,
    void* dx_init, int batch, int G, int L, int dg, int n,
    int apply_softplus, int is_bf16, void* stream) {
  if (n != kN || batch <= 0 || batch > 65535 || G <= 0 || G > 65535 ||
      L <= 0 || dg <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(u, delta, Bm, Cm, A, D, delta_bias, cs,
                                      gy, du, ddelta, dB_part, dC_part,
                                      dA_part, dD_part, ddb_part, g_last,
                                      dx_init, batch, G, L, dg,
                                      apply_softplus, s)
              : launch<float>(u, delta, Bm, Cm, A, D, delta_bias, cs, gy, du,
                              ddelta, dB_part, dC_part, dA_part, dD_part,
                              ddb_part, g_last, dx_init, batch, G, L, dg,
                              apply_softplus, s);
  return static_cast<int>(err);
}

// Reports the launch configuration and occupancy of the kernel that
// selective_scan_bwd launches for (batch, G, L, dg): out[0..8] = grid x, y,
// z, threads per block, registers per thread, static and dynamic shared
// memory per block (bytes), local memory per thread (bytes; spills), and
// the resident blocks per SM the occupancy calculator allows.
extern "C" int selective_scan_bwd_occupancy(int batch, int G, int L, int dg,
                                            int is_bf16, int* out) {
  (void)L;
  return occupancy(is_bf16 ? kernel_of<__nv_bfloat16>() : kernel_of<float>(),
                   grid_of(batch, G, dg), out);
}
