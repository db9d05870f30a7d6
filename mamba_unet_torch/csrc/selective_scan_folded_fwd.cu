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
// data streams (bidir) or one per direction; delta and y are (G, L, B*dg),
// fp32 or bf16; B and C are batch-major, (G, B, L, N), in the same dtype:
// the wrapper moves the batch out of the innermost axis of the folded
// (G, L, N, B); A is (G*dg, N), D and delta_bias are (G*dg,), fp32.
// Direction g reads stream g % 2 (bidir) or g; with bidir, directions
// g >= 2 scan their stream in reversed time.
// Math, per direction g and lane (b, d), in the direction's scan order:
//   delta = softplus(delta[g,t,l] + delta_bias[g*dg+d])  (softplus optional)
//   x_t   = exp(delta*A[g*dg+d,:]) * x_prev + delta*B[g,b,t,:]*u[s,t,l]
//   y_t   = <C[g,b,t,:], x_t> + D[g*dg+d]*u[s,t,l]
// y is written per direction in data order (not pair-summed), rounded to
// the input dtype once; the state (N = 16) and all arithmetic are fp32.
//
// With a non-null `cs` (the training forward) the kernel also writes the 16
// fp32 states entering every 16-step chunk of data time in each direction's
// scan order: cs[g, c, n, l] is the state before steps [16c, 16c + 16) are
// scanned - after the steps before 16c going forward, after the steps from
// 16c + 16 on going backward. The chunks are fixed in data time for both
// orders, as the TPU kernel's are, and cs is indexed by data chunk in both.
// The serving call passes null and compiles without the stores (a template
// flag).
//
// What bounds it on an H100. At stage 0 of the Mamba-UNet trained with
// scan_impl="folded" (bs24, G=4, L=3136, dg=192, fp32) one call reads u (2
// streams, 0.12 GB), delta (0.23 GB) and B/C (0.04 GB), writes y (0.23 GB)
// and, training, cs (0.23 GB): 0.6-0.85 GB, 0.18-0.25 ms at 3.35 TB/s. It
// computes 16 exps per (direction, step, lane), 0.93 G plus softplus, about
// 0.25 ms at the SFU's rate (chip_smoke.py::scan_bound). The recurrence is
// sequential in t, so the parallelism is the 4 * B * dg lanes. The design
// this one replaces (one thread per lane holding all 16 states in one
// serial chain, blocks of 64 threads, 288 blocks and 4.4 warps per SM at
// stage 0, B/C read batch-innermost, each of a step's 32 values a separate
// 4-byte load strided by the batch) took 1.675 ms per stage-0 serving call
// and 1.754 state-saving (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W):
// latency bound.
//
// The design is that of selective_scan_bidir_fwd.cu without its pair
// merge, on the device body selective_scan_fwd_group.cuh shares with
// selective_scan_fwd.cu (see the notes there):
//   * States split over lanes: 4 lanes per channel, 4 states each; y's sum
//     over n is two shuffles.
//   * A block is two 16-channel groups of one direction g and batch b: the
//     groups' lanes are contiguous in every (g, t) row, so u/delta/y copies
//     coalesce, and they share one staging of the batch's B/C. Grid
//     (ceil(dg/32), G, B): 576 blocks at stage 0. Registers are capped so
//     that at least 5 blocks fit per SM: stage 0 is one wave. Measured
//     (chip_smoke.py [kernel_occ], NVIDIA H100 80GB HBM3, 700 W): 80
//     registers serving and 90 state-saving (fp32 and bf16), no spills,
//     36 KB of dynamic shared memory, 6 and 5 blocks (24 and 20 warps) per
//     SM; 17.5 warps per SM in the grid, 0.73 and 0.87 waves at stage 0.
//     The TPU kernel folds the batch into its lane tile to fill 128-lane
//     vregs, and broadcasts per-batch B/C across lanes with a 0/1 matrix on
//     the MXU; here the broadcast is the index b = blockIdx.z.
//   * B/C batch-major: a chunk's 32 x 16 values of one batch lie together
//     and are copied 16 bytes at a time, where the folded layout strides
//     every value by the batch (the backward measured the same trade:
//     3.47 -> 3.30 ms per stage-0 call, selective_scan_folded_bwd.cu).
//   * 32-step chunks staged with cp.async one chunk ahead, converted once
//     per element; a reversed direction walks the chunks, the 16-step state
//     chunks in each and the steps in each from the last, and its entry
//     state of data chunk c is the state before step min(16c + 15, L - 1).
//   * y and the entry states leave through shared memory as rows of
//     contiguous lanes. An odd dg at an odd batch puts a batch's first lane
//     at an odd offset, where bf16 cannot move by 4-byte pairs: the
//     launcher then picks plain loads and stores.
//   * Gates by one SFU ex2 with subnormals flushed to zero (exp2_ftz).
//   * Masked threads (d >= dg) run with zero inputs: they reach every
//     barrier and shuffle.
// Where the time goes now (chip_smoke.py and scripts/scan_phases.py, same
// card, fp32): 0.677 ms per stage-0 serving call (2.7x its bound) and
// 4.65 ms per forward, 0.738 ms state-saving (2.9x) and 5.15 ms per train
// step, the wrapper's B/C copies included. Of the kernel's time, 58-61 % is
// the scan, 23-26 % converting (the softplus), 3-9 % the write-out (cs
// doubles it) and 8 % issuing the copies: latency bound at 4-5 warps per
// scheduler.

#include "selective_scan_fwd_group.cuh"

namespace {

using namespace scan_fwd;

// grid (ceil(dg/32), G, B): group r of block (x, g, b) is channels
// 32x + 16r.. of direction g and batch b
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
folded_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ D,
                  const float* __restrict__ delta_bias, T* __restrict__ y,
                  float* __restrict__ cs, int batch, int L, int dg, int bidir,
                  int apply_softplus, int flags) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int d0 = (2 * blockIdx.x + threadIdx.x / kGroup) * kCh;  // group's
  const int stream = bidir ? (g & 1) : g;
  const int nc = (L + kStateChunk - 1) / kStateChunk;
  const size_t BD = (size_t)batch * dg;  // lanes of one (g, t) row
  const size_t lane = (size_t)b * dg + d0;
  const size_t dir = (size_t)g * L * BD + lane;
  const size_t row = (size_t)g * dg + d0;  // channel among the G*dg

  Group<T> io;
  io.u = u + (size_t)stream * L * BD + lane;
  io.delta = delta + dir;
  io.B = Bm + ((size_t)g * batch + b) * L * kN;
  io.C = Cm + ((size_t)g * batch + b) * L * kN;
  io.A = A + row * kN;
  io.D = D + row;
  io.bias = delta_bias + row;
  io.y = y + dir;
  io.cs = kSave ? cs + (size_t)g * nc * kN * BD + lane : nullptr;
  io.last = nullptr;
  io.x_init = nullptr;
  io.u_base = u;
  io.B_base = Bm;
  io.ts = static_cast<int>(BD);
  io.cns = static_cast<int>(BD);
  io.nvalid = min(kCh, dg - d0);
  io.rev = bidir && g >= 2;
  group_fwd<kSave>(io, L, apply_softplus != 0, flags, smem_raw);
}

template <typename T>
const void* kernel_of(bool save) {
  return save ? reinterpret_cast<const void*>(folded_fwd_kernel<T, true>)
              : reinterpret_cast<const void*>(folded_fwd_kernel<T, false>);
}

dim3 grid_of(int batch, int G, int dg) {
  return dim3((dg + 2 * kCh - 1) / (2 * kCh), G, batch);
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* Bm,
                   const void* Cm, const void* A, const void* D,
                   const void* delta_bias, void* y, void* cs, int batch,
                   int G, int L, int dg, int bidir, int apply_softplus,
                   cudaStream_t stream) {
  const int flags = flags_for<T>(dg, u, delta, y, Bm, Cm, cs);
  auto kernel = cs ? folded_fwd_kernel<T, true> : folded_fwd_kernel<T, false>;
  kernel<<<grid_of(batch, G, dg), kThreads, kSmem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(delta_bias), static_cast<T*>(y),
      static_cast<float*>(cs), batch, L, dg, bidir, apply_softplus, flags);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are contiguous device buffers laid out as documented above (B
// and C batch-major); `cs` is null (serving) or (G, ceil(L / 16), 16,
// batch*dg) fp32 (training). With bidir, G must be 4 and u holds 2 streams;
// without, u holds G.
extern "C" int selective_scan_folded_fwd(const void* u, const void* delta,
                                         const void* Bm, const void* Cm,
                                         const void* A, const void* D,
                                         const void* delta_bias, void* y,
                                         void* cs, int batch, int G, int L,
                                         int dg, int n, int bidir,
                                         int apply_softplus, int is_bf16,
                                         void* stream) {
  if (n != kN || batch <= 0 || batch > 65535 || G <= 0 || G > 65535 ||
      L <= 0 || dg <= 0 || (bidir && G != 4) ||
      (size_t)batch * dg > 0x7fffffff / kN) {
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

// Reports the launch configuration and occupancy of the kernel that
// selective_scan_folded_fwd launches for (batch, G, L, dg), serving
// (save = 0) or state-saving: out[0..8] = grid x, y, z, threads per block,
// registers per thread, static and dynamic shared memory per block
// (bytes), local memory per thread (bytes; spills), and the resident
// blocks per SM the occupancy calculator allows.
extern "C" int selective_scan_folded_fwd_occupancy(int batch, int G, int L,
                                                   int dg, int is_bf16,
                                                   int save, int* out) {
  (void)L;
  return occupancy(is_bf16 ? kernel_of<__nv_bfloat16>(save != 0)
                           : kernel_of<float>(save != 0),
                   grid_of(batch, G, dg), out);
}
