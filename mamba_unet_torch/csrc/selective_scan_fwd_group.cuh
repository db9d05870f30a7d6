// The device body that the grouped (selective_scan_fwd.cu) and the
// batch-folded (selective_scan_folded_fwd.cu) selective-scan forwards
// share, written for sm_90a. The two differ only in where their operands
// lie, which each kernel describes to this body with a Group per 64-thread
// group; the design is that of selective_scan_bidir_fwd.cu without its pair
// merge, staged as the backward body (selective_scan_bwd_group.cuh) stages.
//
// Per channel (raw = delta + delta_bias, dt = softplus(raw) or raw), in the
// group's scan order:
//   x_t = exp(dt_t A) x_prev + dt_t B_t u_t,   y_t = <C_t, x_t> + D u_t
// with the fp32 state x (N = 16); y is rounded to the I/O dtype once.
//
// A block is 128 threads: two groups of 16 channels of one sequence (the
// same B/C), both walking it in the same time order in lockstep. A group's
// channel holds its 16 states on 4 lanes (lane = 8 * q + c8 holds states
// 4q..4q+3 of channel c8 of its warp); y's sum over n is two shuffles.
//
// Per 32-step chunk:
//   * the next chunk's u, delta (the group's 16 channels) and B, C (the
//     block's, once for both groups) are copied into shared memory with
//     cp.async while the current chunk scans: 16-byte copies where the
//     shapes and pointers allow (kVec, kBCVec), else 4-byte copies (fp32
//     values, bf16 channel pairs: kPairs), else plain loads;
//   * each element is converted once: dt = softplus(delta + bias) (JAX's
//     threshold 20), dt * u and D * u; the 4 lanes of a channel read them
//     by broadcast;
//   * the chunk scans from shared memory only, in two 16-step state chunks;
//     at the start of each the group's 16 x 16 entry states go to shared
//     memory (state-saving variant), and each step's y goes to shared
//     memory;
//   * after one barrier, y is written as rows of 16 contiguous channels
//     (16-byte stores where kVec) and the entry states as rows of 16
//     channels of one state (16-byte stores of 4 channels where kCSVec),
//     the layout the backward body reads.
// A reversed group (rev) walks the chunks, the state chunks in each, and
// the steps in each, from the last; its entry state of data chunk k is the
// state before step min(16k + 15, L - 1).

#pragma once

#include "selective_scan_bwd_group.cuh"

namespace scan_fwd {

// the backward body's geometry and helpers: the same lanes, groups, blocks,
// copies and gates
using scan_bwd::aligned;
using scan_bwd::cp_async_16;
using scan_bwd::cp_async_4;
using scan_bwd::cp_async_commit;
using scan_bwd::cp_async_wait_all;
using scan_bwd::exp2_ftz;
using scan_bwd::kCh;
using scan_bwd::kGroup;
using scan_bwd::kLog2e;
using scan_bwd::kN;
using scan_bwd::kNS;
using scan_bwd::kThreads;
using scan_bwd::load_f32;
using scan_bwd::softplus;
using scan_bwd::store;

constexpr int kMinBlocks = 5;     // resident blocks per SM to fit registers to
constexpr int kChunk = 32;        // steps staged per iteration
constexpr int kStateChunk = 16;   // steps between saved states (= bwd kChunk)
constexpr int kHalves = kChunk / kStateChunk;
constexpr int kRows = kGroup / kCh;     // chunk rows one staging pass covers
constexpr int kElems = kChunk / kRows;  // per-channel values a thread stages
constexpr int kBC = kChunk * kN / kThreads;  // B (and C) values it converts
static_assert(kChunk % kStateChunk == 0, "a state chunk is inside a chunk");
static_assert(kStateChunk == scan_bwd::kChunk, "the backward's chunk");
static_assert(kChunk % kRows == 0 && (kChunk * kN) % kThreads == 0,
              "staging");
static_assert(kCh * kN / 4 == kGroup, "one 16-byte state row per thread");

// Flags the launcher sets from the shapes and the pointers' alignment.
enum : int {
  kPairs = scan_bwd::kPairs,  // u, delta copied by 4-byte values
  kBCVec = scan_bwd::kBCVec,  // B/C copied 16 bytes at a time
  kCSVec = scan_bwd::kCSVec,  // entry-state rows written 4 channels at a time
  kVec = 8,  // u, delta copied and y written 16 bytes at a time
};

struct GroupSmem {
  float dt[kChunk][kCh];    // softplus(raw), by data-order slot
  float du[kChunk][kCh];    // dt * u
  float skip[kChunk][kCh];  // D * u
  float y[kChunk][kCh];     // the chunk's y
  float cs[kHalves][kN][kCh];  // entry states of its state chunks
};
struct BlockSmem {
  float B[kChunk][kN];
  float C[kChunk][kN];
};
// One chunk's inputs as they lie in device memory, copied in while the
// previous chunk scans.
template <typename T>
struct alignas(16) RawGroup {
  T u[kChunk][kCh];
  T delta[kChunk][kCh];
};
template <typename T>
struct alignas(16) RawBlock {
  T B[kChunk][kN];
  T C[kChunk][kN];
};
constexpr int kRawOffset =
    static_cast<int>(2 * sizeof(GroupSmem) + sizeof(BlockSmem));
constexpr int kRawBlockOffset =
    kRawOffset + static_cast<int>(2 * sizeof(RawGroup<float>));
constexpr int kSmem = kRawBlockOffset + static_cast<int>(
                                            sizeof(RawBlock<float>));

// Where one group's operands lie. Each pointer is at the group's first
// channel (or its sequence's first step): per-channel values (t, c) at
// t * ts + c; B/C values (t, n) at t * kN + n (the block's sequence);
// entry states (data chunk k, state n, channel c) at (k * kN + n) * cns +
// c; the final state (c, n) at c * kN + n, and the incoming state x_init
// likewise; A (c, n) at c * kN + n; D and bias at c. cs and last are null
// when not written, x_init null for a zero incoming state. The *_base
// pointers
// are the tensors' own, valid and aligned, read by no copy (the source of
// a zero-filling cp.async).
template <typename T>
struct Group {
  const T* u;
  const T* delta;
  const T* B;
  const T* C;
  const float* A;
  const float* D;
  const float* bias;
  T* y;
  float* cs;
  float* last;
  const float* x_init;
  const T* u_base;
  const T* B_base;
  int ts, cns;
  int nvalid;  // channels of the group below dg (none when <= 0)
  bool rev;    // scans its sequence from the last step; uniform per block
};

// 16 bytes of y from shared memory: 4 fp32 or 8 bf16 values
__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst,
                                        const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(bf16_pair(a.x, a.y), bf16_pair(a.z, a.w),
                 bf16_pair(b.x, b.y), bf16_pair(b.z, b.w));
}

// The forward of this thread's group over the whole sequence; every
// thread of the block calls it (it has block barriers). `flags` are the
// launcher's (kPairs, kBCVec, kCSVec, kVec).
template <bool kSave, typename T>
__device__ __forceinline__ void group_fwd(const Group<T>& io, int L,
                                          bool apply_softplus, int flags,
                                          unsigned char* smem_raw) {
  const int r = threadIdx.x / kGroup;
  const int gt = threadIdx.x % kGroup;
  const int lane = gt & 31;
  const int q = lane >> 3;                   // states 4q..4q+3
  const int c = (gt >> 5) * 8 + (lane & 7);  // scanned channel in the group
  const bool active = c < io.nvalid;
  const int sc = gt % kCh;   // staged channel in the group
  const int row = gt / kCh;  // first staged chunk row
  const bool stage_active = sc < io.nvalid;
  const int nch = (L + kChunk - 1) / kChunk;
  GroupSmem& sm = reinterpret_cast<GroupSmem*>(smem_raw)[r];
  BlockSmem& bc =
      *reinterpret_cast<BlockSmem*>(smem_raw + 2 * sizeof(GroupSmem));
  RawGroup<T>& raw = reinterpret_cast<RawGroup<T>*>(smem_raw + kRawOffset)[r];
  RawBlock<T>& raw_bc =
      *reinterpret_cast<RawBlock<T>*>(smem_raw + kRawBlockOffset);
  constexpr int kPer = 16 / sizeof(T);  // values per 16-byte copy
  constexpr int kPerRow = kCh / kPer;   // 16-byte copies per row

  // the state before the first scanned step: x_init (a carry handed in
  // from an earlier part of the sequence) or zero; the null test is
  // uniform per launch. The state-saving variant writes it as the first
  // state chunk's entry state, as any other.
  const bool carry_in = io.x_init != nullptr && active;
  float a2[kNS], x[kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    a2[j] = active ? io.A[c * kN + kNS * q + j] * kLog2e : 0.f;
    x[j] = carry_in ? io.x_init[c * kN + kNS * q + j] : 0.f;
  }
  float bias = 0.f, skip = 0.f;  // of the staged channel
  if (stage_active) {
    bias = io.bias[sc];
    skip = io.D[sc];
  }

  // data start of the chunk the block scans at iteration i
  auto chunk_t0 = [&](int i) { return (io.rev ? nch - 1 - i : i) * kChunk; };

  // start copying chunk i's inputs into `raw` and `raw_bc`
  auto stage = [&](int i) {
    const int t0 = chunk_t0(i);
    const int len = min(kChunk, L - t0);
    if (flags & kVec) {  // rows of 16 channels by 16-byte copies
#pragma unroll
      for (int p = gt; p < kChunk * kPerRow; p += kGroup) {
        const int s = p / kPerRow;
        const int col = (p % kPerRow) * kPer;
        const bool ok = s < len && col < io.nvalid;
        const size_t off = (size_t)(t0 + s) * io.ts + col;
        cp_async_16(&raw.u[s][col], ok ? io.u + off : io.u_base,
                    ok ? 16 : 0);
        cp_async_16(&raw.delta[s][col], ok ? io.delta + off : io.u_base,
                    ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kElems; ++j) {
        const int s = row + kRows * j;
        const bool ok = stage_active && s < len;
        const size_t off = (size_t)(t0 + s) * io.ts + sc;
        if (flags & kPairs) {  // bf16 by pairs of channels from an even one
          if (sizeof(T) == 4 || sc % 2 == 0) {
            cp_async_4(&raw.u[s][sc], ok ? io.u + off : io.u_base,
                       ok ? 4 : 0);
            cp_async_4(&raw.delta[s][sc], ok ? io.delta + off : io.u_base,
                       ok ? 4 : 0);
          }
        } else {  // bf16 at an odd channel offset: plain loads
          store(&raw.u[s][sc], ok ? load_f32(io.u + off) : 0.f);
          store(&raw.delta[s][sc], ok ? load_f32(io.delta + off) : 0.f);
        }
      }
    }
    // the block's B/C, copied once for both groups
    if (flags & kBCVec) {  // the chunk's kChunk * kN values lie together
#pragma unroll
      for (int p = threadIdx.x; p < kChunk * kN / kPer; p += kThreads) {
        const bool ok = p * kPer < len * kN;
        const size_t off = (size_t)t0 * kN + p * kPer;
        cp_async_16(&raw_bc.B[0][0] + p * kPer, ok ? io.B + off : io.B_base,
                    ok ? 16 : 0);
        cp_async_16(&raw_bc.C[0][0] + p * kPer, ok ? io.C + off : io.B_base,
                    ok ? 16 : 0);
      }
    } else {  // misaligned: one value per copy (bf16: plain loads)
#pragma unroll
      for (int j = 0; j < kBC; ++j) {
        const int e = threadIdx.x + kThreads * j;
        const bool ok = e < len * kN;
        const size_t off = (size_t)t0 * kN + e;
        if (sizeof(T) == 4) {
          cp_async_4(&raw_bc.B[0][0] + e, ok ? io.B + off : io.B_base,
                     ok ? 4 : 0);
          cp_async_4(&raw_bc.C[0][0] + e, ok ? io.C + off : io.B_base,
                     ok ? 4 : 0);
        } else {
          store(&raw_bc.B[0][0] + e, ok ? load_f32(io.B + off) : 0.f);
          store(&raw_bc.C[0][0] + e, ok ? load_f32(io.C + off) : 0.f);
        }
      }
    }
    cp_async_commit();
  };

  // compute the staged chunk's per-(step, channel) terms once, into `sm`
  // and `bc`
  auto convert = [&](int i) {
    const int len = min(kChunk, L - chunk_t0(i));
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
      const int s = row + kRows * j;
      const bool ok = stage_active && s < len;
      const float uu = load_f32(&raw.u[s][sc]);  // zero where not ok
      const float rw = load_f32(&raw.delta[s][sc]) + bias;
      const float dt = ok ? (apply_softplus ? softplus(rw) : rw) : 0.f;
      sm.dt[s][sc] = dt;
      sm.du[s][sc] = dt * uu;
      sm.skip[s][sc] = skip * uu;
    }
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      const int e = threadIdx.x + kThreads * j;
      (&bc.B[0][0])[e] = load_f32(&raw_bc.B[0][0] + e);
      (&bc.C[0][0])[e] = load_f32(&raw_bc.C[0][0] + e);
    }
  };

  stage(0);
  cp_async_wait_all();
  __syncthreads();
  convert(0);
  __syncthreads();

  // one step at data-order slot s of the chunk: the state, then y by two
  // shuffles over the channel's 4 lanes
  auto step = [&](int s) {
    const float dt = sm.dt[s][c];
    const float du = sm.du[s][c];
    const float4 bv = *reinterpret_cast<const float4*>(&bc.B[s][kNS * q]);
    const float4 cv = *reinterpret_cast<const float4*>(&bc.C[s][kNS * q]);
    x[0] = fmaf(exp2_ftz(dt * a2[0]), x[0], du * bv.x);
    x[1] = fmaf(exp2_ftz(dt * a2[1]), x[1], du * bv.y);
    x[2] = fmaf(exp2_ftz(dt * a2[2]), x[2], du * bv.z);
    x[3] = fmaf(exp2_ftz(dt * a2[3]), x[3], du * bv.w);
    float y = fmaf(cv.w, x[3], fmaf(cv.z, x[2], fmaf(cv.y, x[1],
                                                     cv.x * x[0])));
    y += __shfl_xor_sync(0xffffffffu, y, 8);
    y += __shfl_xor_sync(0xffffffffu, y, 16);
    if (q == 0) sm.y[s][c] = y + sm.skip[s][c];
  };

  for (int i = 0; i < nch; ++i) {
    const int t0 = chunk_t0(i);
    const int len = min(kChunk, L - t0);
    const int nh = (len + kStateChunk - 1) / kStateChunk;
    if (i + 1 < nch) stage(i + 1);  // in flight during this chunk

    for (int hh = 0; hh < nh; ++hh) {
      const int h = io.rev ? nh - 1 - hh : hh;  // state chunk in the chunk
      const int lo = h * kStateChunk;
      const int n = min(kStateChunk, len - lo);
      if (kSave) {
#pragma unroll
        for (int j = 0; j < kNS; ++j) sm.cs[h][kNS * q + j][c] = x[j];
      }
      // a full state chunk runs unrolled without per-step predicates, so
      // that its steps' loads and gates interleave; a ragged one step by
      // step
      if (n == kStateChunk && !io.rev) {
#pragma unroll
        for (int k = 0; k < kStateChunk; ++k) step(lo + k);
      } else if (n == kStateChunk) {
#pragma unroll
        for (int k = 0; k < kStateChunk; ++k) step(lo + kStateChunk - 1 - k);
      } else {
#pragma unroll 1
        for (int k = 0; k < n; ++k) step(io.rev ? lo + n - 1 - k : lo + k);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // y, the entry states and the next chunk's copies

    // y, by rows of the group's channels
    if (flags & kVec) {
#pragma unroll
      for (int p = gt; p < kChunk * kPerRow; p += kGroup) {
        const int s = p / kPerRow;
        const int col = (p % kPerRow) * kPer;
        if (s < len && col < io.nvalid) {
          store16(io.y + (size_t)(t0 + s) * io.ts + col, &sm.y[s][col]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kElems; ++j) {
        const int s = row + kRows * j;
        if (stage_active && s < len) {
          store(io.y + (size_t)(t0 + s) * io.ts + sc, sm.y[s][sc]);
        }
      }
    }
    // the entry states of the chunk's state chunks, by rows of one state
    if (kSave) {
      for (int h = 0; h < nh; ++h) {
        float* dst = io.cs + (size_t)(t0 / kStateChunk + h) * kN * io.cns;
        if (flags & kCSVec) {
          const int n = gt / 4;
          const int col = 4 * (gt % 4);
          if (col < io.nvalid) {
            *reinterpret_cast<float4*>(dst + (size_t)n * io.cns + col) =
                *reinterpret_cast<const float4*>(&sm.cs[h][n][col]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < kCh * kN / kGroup; ++j) {
            const int e = gt + kGroup * j;
            const int n = e / kCh;
            const int col = e % kCh;
            if (col < io.nvalid) dst[(size_t)n * io.cns + col] = sm.cs[h][n][col];
          }
        }
      }
    }
    if (i + 1 < nch) convert(i + 1);
    __syncthreads();
  }

  if (io.last != nullptr && active) {
    *reinterpret_cast<float4*>(io.last + c * kN + kNS * q) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// The launch configuration and occupancy of `kernel` launched as grid x
// kThreads with kSmem: out[0..8] = grid x, y, z, threads per block,
// registers per thread, static and dynamic shared memory per block
// (bytes), local memory per thread (bytes; spills), and the resident
// blocks per SM the occupancy calculator allows.
inline int occupancy(const void* kernel, dim3 grid, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[9] = {static_cast<int>(grid.x), static_cast<int>(grid.y),
                       static_cast<int>(grid.z), kThreads, fa.numRegs,
                       static_cast<int>(fa.sharedSizeBytes), kSmem,
                       static_cast<int>(fa.localSizeBytes), blocks};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// The flags for a layout whose per-channel rows start at multiples of dg
// values, from the shapes and the pointers' alignment.
template <typename T>
int flags_for(int dg, const void* u, const void* delta, const void* y,
              const void* Bm, const void* Cm, const void* cs) {
  int flags = 0;
  if (dg % (16 / sizeof(T)) == 0 && aligned(u, 16) && aligned(delta, 16) &&
      aligned(y, 16)) {
    flags |= kVec;
  }
  if (sizeof(T) == 4 || (dg % 2 == 0 && aligned(u, 4) && aligned(delta, 4))) {
    flags |= kPairs;
  }
  if (aligned(Bm, 16) && aligned(Cm, 16)) flags |= kBCVec;
  if (dg % 4 == 0 && aligned(cs, 16)) flags |= kCSVec;
  return flags;
}

}  // namespace scan_fwd
