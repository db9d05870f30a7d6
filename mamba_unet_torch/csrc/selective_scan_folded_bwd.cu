// Batch-folded selective-scan (S6) backward, written for sm_90a.
//
// Replaces the Pallas TPU kernel
//   mamba_unet_tpu/ops/selective_scan_folded.py::_bwd_kernel_folded
// (_scan_bwd_folded, the VJP of selective_scan_folded_bidir and
// selective_scan_folded), the backward of SS2D's batch-folded branch.
//
// Layout as in selective_scan_folded_fwd.cu: lane l of the B*dg lanes is
// channel d = l % dg of batch b = l / dg; u (S, L, B*dg) with S = 2 streams
// (bidir) or one per direction; delta, gy (G, L, B*dg) in T (fp32 or bf16;
// gy in the I/O dtype, as the TPU kernel reads it); B, C in T, batch-major
// (G, B, L, N): the wrapper moves the batch out of the innermost axis of
// the folded (G, L, N, B); A (G*dg, 16), D and delta_bias (G*dg) fp32; cs
// (G, nc, 16, B*dg) fp32, the states entering each 16-step data chunk that
// the state-saving forward wrote. With bidir, direction g reads stream g % 2
// and g >= 2 runs in reversed time. Backward, per direction and lane,
// walking the direction's scan order in reverse (x_prev: the state before
// the step, a_t = exp(dt_t A)):
//   e_t   = C_t g_t + a_next e_next                        (dL/dx_t)
//   dΔ_t  = (sum_n e a x_prev A + sum_n e B u) * sigmoid(raw_t)  (softplus)
//   du_t  = sum_n e B dt + D g
//   dB_t  = sum_d e dt u,   dC_t = sum_d x_t g    (over the batch's dg)
//   dA    = sum_{b,t} e a x_prev dt,  dD = sum_{b,t} g u,  dΔbias = sum dΔ
// Outputs: ddelta in T; du in fp32 (S, L, B*dg), with bidir summed over the
// two directions that read each stream, which the caller rounds to T once;
// and fp32 partial sums that the caller reduces (deterministically, no
// atomics): dB/dC over channel tiles (ntile, G, B, L, 16), with 16-channel
// tiles (bidir) or 32-channel ones, dA (B, G*dg, 16), dD and dΔbias
// (B, G*dg) over the batch. Every state and sum is fp32.
//
// What bounds it on an H100. At stage 0 of the Mamba-UNet trained with
// scan_impl="folded" (bs24, G=4, L=3136, dg=192, fp32) one call reads u
// (0.12 GB), delta, gy and cs (3 x 0.23 GB) and B/C (0.04 GB), and writes
// du (0.12 GB for the two streams), ddelta (0.23 GB) and dB/dC: about 1.2
// GB with the summed dB/dC, 0.37 ms at 3.35 TB/s. It needs one exp per
// state and step plus softplus and sigmoid, about 1.2 G special-function
// results, 0.29 ms, so the bound is the bytes. The design this one
// replaces (one thread per lane holding all 16 states, a chunk's
// 17 x 16 x 64 recomputed states in 68 KB of shared memory, blocks of 64
// threads, du per direction in fp32 summed by the caller) took 10.20 ms per
// stage-0 call (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
//
// The design is that of selective_scan_bidir_bwd.cu, on the device body
// selective_scan_bwd_group.cuh shares with selective_scan_bwd.cu:
//   * States split over lanes: 4 lanes per channel, 4 states each; sums
//     over n (dΔ, du) take two shuffles.
//   * bidir: a block is the direction pair (m, m+2) that reads stream m,
//     one 16-channel group each over the same lanes of batch b: grid
//     (ceil(dg/16), 2, B), 576 blocks at stage 0. The groups walk data
//     time in opposite orders in lockstep, so the first visitor of a chunk
//     stores its fp32 du and the second adds onto it; the middle chunk is
//     summed in shared memory. du leaves the kernel pair-summed: the fp32
//     per-direction du (0.23 GB at stage 0) and the caller's pass that
//     summed it are gone.
//   * Without bidir: a block is two 16-channel groups of one direction
//     and batch, as the grouped backward's: grid (ceil(dg/32), G, B).
//   * A block's lanes belong to one batch, so the per-batch dB/dC sum over
//     the batch's dg lanes is a sum over blocks (the TPU kernel reduces its
//     lane tile with a 0/1 matrix on the MXU instead).
//   * Each 16-step chunk is recomputed from its saved entry state in two
//     8-step halves with the states in registers (2.5 exps per state and
//     step); registers are capped so that 5 blocks fit per SM. Measured
//     (chip_smoke.py [kernel_occ], NVIDIA H100 80GB HBM3, 700 W): 96
//     registers, 40 bytes of local memory (spills), 38 KB of dynamic shared
//     memory, 5 blocks (20 warps) per SM; 17.5 warps per SM in the grid and
//     0.87 waves at stage 0.
//   * The next chunk's u, delta, gy, B, C and entry states are copied into
//     shared memory with cp.async while the current chunk computes: u,
//     delta and gy by 4-byte values (bf16 by channel pairs, which needs an
//     even dg, since batch b's lanes start at b*dg: an odd dg in bf16 loads
//     them plainly), the entry states as 16 rows of 16 lanes (four 16-byte
//     copies a row when dg is a multiple of 4, else 4-byte copies), B and C
//     by 16-byte copies of a chunk's 16 x 16 values, which lie together in
//     the batch-major layout. In the folded (G, L, N, B) layout they are
//     strided by the batch: 512 scattered values per chunk and group,
//     copied one 4-byte cp.async each (fp32; bf16 would need plain loads,
//     since a copy moves at least 4 bytes and a bf16 value shares its word
//     with the next batch's), and staging every batch's values instead
//     would take B times the shared memory. That took 3.47 ms per stage-0
//     call against the batch-major layout's 3.30 ms (chip_smoke.py,
//     NVIDIA H100 80GB HBM3, 700 W), whose transposes cost the wrapper one
//     copy of B and of C (0.04 GB at stage 0 in fp32). dt = softplus(raw),
//     dt*u and sigmoid(raw) are computed once per element; the four lanes
//     of a channel read them by broadcast.
//   * Gates by one SFU ex2 with subnormals flushed to zero (exp2_ftz).
//   * dB/dC: a transposing butterfly over the 8 channels of a warp (7
//     shuffles), then a group's 2 warps (bidir: one partial per direction
//     and 16-channel tile) or a block's 4 (one per 32-channel tile) summed
//     in shared memory in a fixed order. At stage 0 with bidir, 12 tiles:
//     0.46 GB of dB/dC partials written and re-read by the wrapper's sum,
//     the bytes of the bidirectional backward's partials; without bidir,
//     half that per direction.
//   * dA/dD/dΔbias are per-thread register sums over time, written per
//     batch element; the caller sums over the batch.
//   * Masked threads (d >= dg) run with zero inputs: they reach every
//     barrier and shuffle and contribute exact zeros. Steps past a ragged
//     chunk are skipped by a predicate uniform over the group.
// Where the time goes now (chip_smoke.py and scripts/scan_phases.py, same
// card): 3.30 ms per stage-0 call with the wrapper's transposes and sums
// (9.0x its bound; 3.08 ms the kernel alone), 23.58 ms per folded step. Of
// the kernel's time at stage 0, 62 % is the recompute and reverse, 13 %
// issuing the next chunk's copies and reading the other direction's du,
// 13 % the write-out and 12 % waiting for the copies and converting. As
// in the bidirectional backward, about 4 warps per scheduler do not hide
// the reverse step's chains: latency bound.

#include "selective_scan_bwd_group.cuh"

namespace {

using namespace scan_bwd;

// bidir (kPair): grid (ceil(dg/16), 2, B), group r of block (x, m, b) is
// direction m + 2r over channels 16x.. of batch b; otherwise grid
// (ceil(dg/32), G, B), group r of block (x, g, b) is channels 32x + 16r..
// of direction g and batch b.
template <typename T, bool kPair>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
folded_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ D,
                  const float* __restrict__ delta_bias,
                  const float* __restrict__ cs, const T* __restrict__ gy,
                  float* __restrict__ du, T* __restrict__ ddelta,
                  float* __restrict__ dB_part, float* __restrict__ dC_part,
                  float* __restrict__ dA_part, float* __restrict__ dD_part,
                  float* __restrict__ ddb_part, int batch, int G, int L,
                  int dg, int apply_softplus, int flags) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r = threadIdx.x / kGroup;
  const int tile = blockIdx.x;
  const int b = blockIdx.z;
  const int g = kPair ? blockIdx.y + 2 * r : blockIdx.y;
  const int stream = kPair ? blockIdx.y : g;
  const int d0 = (kPair ? tile : 2 * tile + r) * kCh;  // group's first
  const int nc = (L + kChunk - 1) / kChunk;
  const size_t BD = (size_t)batch * dg;  // lanes of one (g, t) row
  const size_t lane = (size_t)b * dg + d0;
  const size_t dir = (size_t)g * L * BD + lane;
  const size_t part = (((size_t)tile * G + g) * batch + b) * L * kN;
  const size_t row = (size_t)g * dg + d0;  // channel among the G*dg
  const size_t out = (size_t)b * G * dg + row;

  Group<T, float> io;
  io.u = u + (size_t)stream * L * BD + lane;
  io.delta = delta + dir;
  io.gy = gy + dir;
  io.B = Bm + ((size_t)g * batch + b) * L * kN;
  io.C = Cm + ((size_t)g * batch + b) * L * kN;
  io.cs = cs + (size_t)g * nc * kN * BD + lane;
  io.du = du + (size_t)stream * L * BD + lane;
  io.ddelta = ddelta + dir;
  io.dB = dB_part + part;
  io.dC = dC_part + part;
  io.A = A + row * kN;
  io.D = D + row;
  io.bias = delta_bias + row;
  io.dA = dA_part + out * kN;
  io.dD = dD_part + out;
  io.ddb = ddb_part + out;
  io.g_last = nullptr;
  io.dx_init = nullptr;
  io.u_base = u;
  io.B_base = Bm;
  io.cs_base = cs;
  io.ts = static_cast<int>(BD);
  io.cns = static_cast<int>(BD);
  io.nvalid = min(kCh, dg - d0);
  group_bwd<kPair>(io, L, apply_softplus != 0, flags, smem_raw);
}

template <typename T>
const void* kernel_of(int bidir) {
  return bidir ? reinterpret_cast<const void*>(folded_bwd_kernel<T, true>)
               : reinterpret_cast<const void*>(folded_bwd_kernel<T, false>);
}

dim3 grid_of(int batch, int G, int dg, int bidir) {
  return bidir ? dim3((dg + kCh - 1) / kCh, 2, batch)
               : dim3((dg + 2 * kCh - 1) / (2 * kCh), G, batch);
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* Bm,
                   const void* Cm, const void* A, const void* D,
                   const void* delta_bias, const void* cs, const void* gy,
                   void* du, void* ddelta, void* dB_part, void* dC_part,
                   void* dA_part, void* dD_part, void* ddb_part, int batch,
                   int G, int L, int dg, int bidir, int apply_softplus,
                   cudaStream_t stream) {
  const void* kernel = kernel_of<T>(bidir);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int flags = 0;
  if (sizeof(T) == 4 || (dg % 2 == 0 && aligned(u, 4) &&
                         aligned(delta, 4) && aligned(gy, 4))) {
    flags |= kPairs;
  }
  if (aligned(Bm, 16) && aligned(Cm, 16)) flags |= kBCVec;
  if (dg % 4 == 0 && aligned(cs, 16)) flags |= kCSVec;
  auto* k = bidir ? folded_bwd_kernel<T, true> : folded_bwd_kernel<T, false>;
  k<<<grid_of(batch, G, dg, bidir), kThreads, kSmem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(delta_bias), static_cast<const float*>(cs),
      static_cast<const T*>(gy), static_cast<float*>(du),
      static_cast<T*>(ddelta), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), static_cast<float*>(dA_part),
      static_cast<float*>(dD_part), static_cast<float*>(ddb_part), batch, G,
      L, dg, apply_softplus, flags);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
// Pointers are contiguous device buffers laid out as documented above.
extern "C" int selective_scan_folded_bwd(
    const void* u, const void* delta, const void* Bm, const void* Cm,
    const void* A, const void* D, const void* delta_bias, const void* cs,
    const void* gy, void* du, void* ddelta, void* dB_part, void* dC_part,
    void* dA_part, void* dD_part, void* ddb_part, int batch, int G, int L,
    int dg, int n, int bidir, int apply_softplus, int is_bf16,
    void* stream) {
  if (n != kN || batch <= 0 || batch > 65535 || G <= 0 || G > 65535 ||
      L <= 0 || dg <= 0 || (bidir && G != 4) ||
      (size_t)batch * dg > 0x7fffffff / kN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(u, delta, Bm, Cm, A, D, delta_bias, cs,
                                      gy, du, ddelta, dB_part, dC_part,
                                      dA_part, dD_part, ddb_part, batch, G, L,
                                      dg, bidir, apply_softplus, s)
              : launch<float>(u, delta, Bm, Cm, A, D, delta_bias, cs, gy, du,
                              ddelta, dB_part, dC_part, dA_part, dD_part,
                              ddb_part, batch, G, L, dg, bidir,
                              apply_softplus, s);
  return static_cast<int>(err);
}

// Reports the launch configuration and occupancy of the kernel that
// selective_scan_folded_bwd launches for (batch, G, L, dg, bidir): out[0..8]
// = grid x, y, z, threads per block, registers per thread, static and
// dynamic shared memory per block (bytes), local memory per thread (bytes;
// spills), and the resident blocks per SM the occupancy calculator allows.
extern "C" int selective_scan_folded_bwd_occupancy(int batch, int G, int L,
                                                   int dg, int bidir,
                                                   int is_bf16, int* out) {
  (void)L;
  return occupancy(is_bf16 ? kernel_of<__nv_bfloat16>(bidir)
                           : kernel_of<float>(bidir),
                   grid_of(batch, G, dg, bidir), out);
}
