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
// decode cache a prefill hands to the single-token step. With a non-null
// `x_init`, (B, G*dg, N) fp32, the scan starts from it instead of zero
// (x_{-1} = x_init): the carry that a sequence-sharded scan
// (parallel/seq_scan.py) hands from the earlier shards, or any chunked
// carry over L; it replaces the XLA scan's `x_init`
// (mamba_unet_tpu/ops/selective_scan.py::selective_scan_xla), which the
// TPU kernel did not take.
//
// With a non-null `cs` (the training forward) the kernel also writes the
// fp32 state entering every 16-step chunk: cs[b, g, c, n, d] = the state
// entering step 16c (x_init, or zero, for c = 0), nc = ceil(L / 16)
// chunks. The serving
// call passes null and compiles without the stores (a template flag).
//
// What bounds it on an H100. At stage 0 of the Mamba-UNet trained with
// scan_impl="tm" (bs24, G=4, L=3136, dg=192, fp32) one state-saving call
// reads u, delta (2 x 0.23 GB) and B/C (0.04 GB) and writes y (0.23 GB)
// and cs (0.23 GB): about 0.96 GB, 0.29 ms at 3.35 TB/s; it needs 16 exps
// per (step, channel) plus the softplus, about 1.0 G special-function
// results, 0.25 ms. At the Mamba-LM scoring shape (mamba-130m: batch 8,
// L = 1024, G*dg = 1536, fp32) a serving call moves 0.15 GB and needs
// 2.0e8 exps: 0.054 ms, set by operations (chip_smoke.py::scan_bound).
// The recurrence is sequential in t, so the parallelism is the B * G * dg
// channels. The design this one replaces (one thread per channel holding
// all 16 states in one serial chain, blocks of 64 threads: 288 blocks, 4.4
// warps per SM at stage 0, 192 blocks, 2.9 warps per SM at the scoring
// shape) took 1.188 ms per stage-0 call (state-saving) and 0.2878 ms per
// scoring call (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): latency
// bound.
//
// The design is that of selective_scan_bidir_fwd.cu without its pair
// merge, on the device body selective_scan_fwd_group.cuh shares with
// selective_scan_folded_fwd.cu (see the notes there):
//   * States split over lanes: 4 lanes per channel, 4 states each; y's sum
//     over n is two shuffles. 4x the threads, a quarter of the exp/FMA
//     chain per thread.
//   * A block is two 16-channel groups of the same (b, g), sharing one
//     staging of its B/C: grid (ceil(dg/32), G, B), 576 blocks at stage 0
//     of the tm branch, 384 at the scoring shape, 48 for a batch-1 prefill
//     (splitting L for batch 1 is later work). Registers are capped so that
//     at least 5 blocks fit per SM: stage 0 is one wave. Measured
//     (chip_smoke.py [kernel_occ], NVIDIA H100 80GB HBM3, 700 W): 79
//     registers serving, 80 state-saving (78-79 bf16), no spills, 36 KB of
//     dynamic shared memory, 6 blocks (24 warps) per SM; 17.5 warps per SM
//     in the grid and 0.73 waves at stage 0, 11.6 and 0.48 at the scoring
//     shape.
//   * 32-step chunks staged with cp.async one chunk ahead (16-byte copies
//     where dg and the pointers allow), converted once per element into
//     shared memory (dt = softplus(delta + bias), dt*u, D*u); y and the
//     entry states leave through shared memory as rows of contiguous
//     channels.
//   * Each gate exp(dt A) is one SFU ex2 with subnormal results flushed to
//     zero (exp2_ftz).
//   * Masked channels (d >= dg) and the steps past a ragged chunk run with
//     zero inputs or not at all; every thread reaches every barrier and
//     shuffle.
// Where the time goes now (chip_smoke.py and scripts/scan_phases.py, same
// card, fp32): 0.653 ms per stage-0 state-saving call (2.3x its bound),
// 4.55 ms per tm step, 0.160 ms per mamba-130m state-saving call and
// 0.1475 ms per scoring call (2.7x its bound). Of the kernel's time, 59-62 %
// is the scan, 24-26 % converting (the softplus), 3-8 % the write-out and
// 7-8 % issuing the copies, which land before the barrier: latency bound at
// 3-6 warps per scheduler, as the bidirectional forward is.

#include "selective_scan_fwd_group.cuh"

namespace {

using namespace scan_fwd;

template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grouped_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                   const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ D,
                   const float* __restrict__ delta_bias,
                   const float* __restrict__ x_init, T* __restrict__ y,
                   float* __restrict__ last_state, float* __restrict__ cs,
                   int G, int L, int dg, int apply_softplus, int flags) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int d0 = (2 * blockIdx.x + threadIdx.x / kGroup) * kCh;  // group's
  const int nc = (L + kStateChunk - 1) / kStateChunk;
  const size_t seq = (size_t)(b * G + g) * L;  // first step of (b, g)
  const size_t row = (size_t)g * dg + d0;      // channel among the G*dg

  Group<T> io;
  io.u = u + seq * dg + d0;
  io.delta = delta + seq * dg + d0;
  io.B = Bm + seq * kN;
  io.C = Cm + seq * kN;
  io.A = A + row * kN;
  io.D = D + row;
  io.bias = delta_bias + row;
  io.y = y + seq * dg + d0;
  io.cs = kSave ? cs + (size_t)(b * G + g) * nc * kN * dg + d0 : nullptr;
  io.last = last_state != nullptr
                ? last_state + ((size_t)b * G * dg + row) * kN : nullptr;
  io.x_init = x_init != nullptr
                  ? x_init + ((size_t)b * G * dg + row) * kN : nullptr;
  io.u_base = u;
  io.B_base = Bm;
  io.ts = dg;
  io.cns = dg;
  io.nvalid = min(kCh, dg - d0);
  io.rev = false;
  group_fwd<kSave>(io, L, apply_softplus != 0, flags, smem_raw);
}

template <typename T>
const void* kernel_of(bool save) {
  return save ? reinterpret_cast<const void*>(grouped_fwd_kernel<T, true>)
              : reinterpret_cast<const void*>(grouped_fwd_kernel<T, false>);
}

dim3 grid_of(int batch, int G, int dg) {
  return dim3((dg + 2 * kCh - 1) / (2 * kCh), G, batch);
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* Bm,
                   const void* Cm, const void* A, const void* D,
                   const void* delta_bias, const void* x_init, void* y,
                   void* last_state, void* cs, int batch, int G, int L,
                   int dg, int apply_softplus, cudaStream_t stream) {
  const int flags = flags_for<T>(dg, u, delta, y, Bm, Cm, cs);
  auto kernel =
      cs ? grouped_fwd_kernel<T, true> : grouped_fwd_kernel<T, false>;
  kernel<<<grid_of(batch, G, dg), kThreads, kSmem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(delta_bias),
      static_cast<const float*>(x_init), static_cast<T*>(y),
      static_cast<float*>(last_state), static_cast<float*>(cs), G, L, dg,
      apply_softplus, flags);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are contiguous device buffers laid out as documented above;
// `x_init` is null (a zero incoming state) or (batch, G*dg, 16) fp32;
// `last_state` is null (no final state) or (batch, G*dg, 16) fp32; `cs` is
// null (serving) or (batch, G, ceil(L / 16), 16, dg) fp32 (training).
extern "C" int selective_scan_fwd(const void* u, const void* delta,
                                  const void* Bm, const void* Cm,
                                  const void* A, const void* D,
                                  const void* delta_bias, const void* x_init,
                                  void* y, void* last_state, void* cs,
                                  int batch,
                                  int G, int L, int dg, int n,
                                  int apply_softplus, int is_bf16,
                                  void* stream) {
  if (n != kN || batch <= 0 || batch > 65535 || G <= 0 || G > 65535 ||
      L <= 0 || dg <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(u, delta, Bm, Cm, A, D, delta_bias,
                                      x_init, y, last_state, cs, batch, G, L,
                                      dg, apply_softplus, s)
              : launch<float>(u, delta, Bm, Cm, A, D, delta_bias, x_init, y,
                              last_state, cs, batch, G, L, dg,
                              apply_softplus, s);
  return static_cast<int>(err);
}

// Reports the launch configuration and occupancy of the kernel that
// selective_scan_fwd launches for (batch, G, L, dg), serving (save = 0) or
// state-saving: out[0..8] = grid x, y, z, threads per block, registers per
// thread, static and dynamic shared memory per block (bytes), local memory
// per thread (bytes; spills), and the resident blocks per SM the occupancy
// calculator allows.
extern "C" int selective_scan_fwd_occupancy(int batch, int G, int L, int dg,
                                            int is_bf16, int save,
                                            int* out) {
  (void)L;
  return occupancy(is_bf16 ? kernel_of<__nv_bfloat16>(save != 0)
                           : kernel_of<float>(save != 0),
                   grid_of(batch, G, dg), out);
}
