// Fused K-Means E-step + M-step partials (paper eqs. 8-9) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel kmeans_assign_pallas
// (src/repro/kernels/kmeans_assign/kernel.py:57) -> kmeans_assign (B4).
//
// For each worker w and sample i: idx[w, i] = argmin_k of
// -2 * <x_i, w_k> + ||w_k||^2 (||x_i||^2 is row-constant and dropped; ties go
// to the first k), then sums[w, k, :] = sum of the samples that chose k and
// counts[w, k] = how many did.  x is (M, D), shared by the W prototype sets
// (worker stride 0: the round simulator's eval subsample), or (W, M, D); w
// is (W, K, D); all f32.  The TPU kernel is the case W = 1.  Nothing is
// padded: the TPU's lane alignment of D to 128 and K to 8, with its sentinel
// prototypes, has no counterpart here.
//
// Bound: x is read once and idx written once (4 * M * (D + 1) bytes) against
// 2 * M * K * D operations of the E-step.  At the paper's K = D = 10 that is
// about 5 operations per byte, under the card's f32 ridge of ~20: bytes
// bound it.  At the reference's VMEM envelope (K = 1024, D = 128) it is
// ~500 operations per byte: f32 operations bound it.
//
// Two kernels; configure() picks one from (K, D) alone, before any launch.
//
// assign_stream_kernel, the small regime (D <= STREAM_MAX_D = 16 and
// K * D <= STREAM_MAX_KD = 1024: the BATCH iteration and the K-Means round at
// K = D = 10, Fig. 7's K <= 100 at D = 10).  The limit is measured: on an
// H100 at M = 10^7 it is faster than assign_partial_kernel at every D <= 16
// and K * D <= 1024 tried (0.17-0.98 of its time), but not at every K for
// D = 20 or 32, where rows whose size is a multiple of 32 bytes make its
// row reads conflict in shared-memory banks.  Bytes bound it, and at
// 3.35 TB/s the card has ~13 warp instructions a sample to spend.  What
// limits a kernel here is the shared-memory pipe (every byte a shared load
// or shuffle hands the registers, broadcast or not, and every byte the bulk
// copies write), then instruction throughput.  So:
//   - samples stream in by 1D bulk copy (cp.async.bulk, completing on an
//     mbarrier) into a ring of 2 to 4 tiles of TM = 512 rows, as they lie
//     in memory (no transposition: each thread reads its own rows; at D = 10
//     float2 reads of 40-byte rows are bank-conflict-free).  One producer
//     warp keeps the next tiles in flight; four consumer warps compute, each
//     releasing a stage on its own (no block barrier per tile).  A worker
//     whose rows are not 16-byte aligned (worker stride M * D * 4 not a
//     multiple of 16), and a last tile whose size is not, are copied by the
//     producer warp's threads instead;
//   - exactly K scores a sample: the prototypes, transposed, and their
//     norms are staged once per block.  Each thread scores ST_R = 4 samples
//     at once, so each prototype value read from shared memory serves four
//     samples; dot products in register blocks of 12 prototypes with a
//     compile-time tail of K % 12 (K = 10 costs 10, not 16);
//   - the M-step has one writer per entry and short chains: each warp has
//     G = 32 / D lane groups (one where K > 32) and ST_R accumulator sets;
//     set r of group g walks the samples 32 r + g, 32 r + g + G, ... of the
//     warp's 128 in order and adds x[i, d] into its own acc[r, g, idx[i],
//     d].  The four sets' read-add-write chains are independent, so they
//     overlap, and one 16-byte shared read gives a step its four k.  Every
//     F tiles (a chain of at most ST_CHAIN = 256 adds) the warp adds its sets
//     and groups in order into its running sums and zeroes them.  Counts
//     are integers (shared-memory integer atomics: exact in any order).  At
//     the end the block adds its warps in order into partials[w, block].
// Its times against assign_partial_kernel's, and where its time goes, are
// in PERF.md §6.
//
// assign_partial_kernel, every other shape (the reference's VMEM envelope):
//   - a fixed grid of blocks per worker (as many as fit on the card at
//     once), each striding over tiles of TM samples in a fixed order; a
//     tile of x is staged in shared memory, transposed (one row per
//     dimension, padded by one against bank conflicts), one thread per
//     sample;
//   - the prototypes are staged in chunks of KC, transposed, with their
//     squared norms; each thread keeps 8 dot products in registers per
//     pass over D (3 shared loads per 8 fused multiply-adds); a chunk that
//     holds every prototype is staged once per block;
//   - M-step: the threads of group g (one thread per dimension d) walk the
//     tile's samples g, g + G, g + 2G, ... and add x[i, d] into
//     acc[g, idx[i], d]; at the end the block adds its G groups in order.
//     The accumulators sit in shared memory when they fit (K = D = 10:
//     11 KB), else in block-private global scratch.
//
// Both: the E-step's dot products use explicit fused multiply-adds in
// ascending d (the library is built with -fmad=false) and a strict < in
// ascending k: they differ from the plain version's cuBLAS order in the
// last bits, which moves idx only where the two best scores nearly tie.
// Determinism without float atomics: the TPU grid runs in order and adds
// every tile into one accumulator.  Here each block adds its tiles into its
// own accumulators in a fixed order (each entry has one writer that adds in
// sample order), writes partials[w, block], and a second launch
// (finalize_kernel) adds the blocks in a fixed tree.  Counts are integers
// until the very end: an f32 sum of ones stops at 2^24, and a cluster of
// the paper's 10^8-sample run holds ~10^7; each count is converted once,
// correctly rounded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int MAX_D = 256;
constexpr int KB = 8;                    // prototypes per register block
constexpr int SMEM_ACC_BYTES = 32768;    // accumulators in shared memory
//                                          up to this size
constexpr int FIN_ENTRIES = 32;          // finalize: entries per block
constexpr int FIN_SLICES = 8;            //           block slices per entry

// assign_stream_kernel (the small regime)
constexpr int STREAM_MAX_D = 16;         // measured: see the note at the top
constexpr int STREAM_MAX_KD = 1024;
constexpr int ST_WARPS = 4;              // consumer warps; one more copies
constexpr int ST_R = 4;                  // samples per consumer thread (the
//                                          M-step reads their k as an int4)
constexpr int ST_CT = 32 * ST_WARPS;     // consumer threads
constexpr int ST_TM = ST_R * ST_CT;      // samples per tile, a multiple of 4
constexpr int ST_THREADS = ST_CT + 32;
constexpr int ST_KB = 12;                // prototypes per register block
constexpr int ST_RING_BYTES = 40960;     // the ring: 2 to 4 stages
constexpr int ST_ACC_BYTES = 65536;      // group accumulators of a block
constexpr int ST_CHAIN = 256;            // adds per accumulator between
//                                          flushes, at most
constexpr int ST_BAR_BYTES = 128;        // the stages' mbarriers

struct Plan {
  int stream;      // assign_stream_kernel (else assign_partial_kernel)
  int tm;          // samples per tile
  int threads;     // threads per block
  int kc;          // prototypes per staged chunk, a multiple of KB
  int groups;      // M-step groups G (stream: per warp)
  int smem_acc;    // accumulators in shared memory (else global scratch)
  int kp;          // stream: K rounded up to a multiple of 4
  int stages;      // stream: ring stages
  int flush;       // stream: tiles between flushes
  int nb;          // blocks per worker
  size_t smem;     // dynamic shared memory bytes
  long long scratch;  // floats of global scratch (0 with smem_acc)
};

__device__ __forceinline__ void load_chunk(const float* __restrict__ ww,
                                           float* wsT, float* norms, int k0,
                                           int K, int D, int kc) {
  const int t = threadIdx.x;
  for (int e = t; e < kc * D; e += blockDim.x) {
    const int kk = e / D;
    const int d = e - kk * D;
    wsT[d * kc + kk] =
        k0 + kk < K ? ww[static_cast<long long>(k0 + kk) * D + d] : 0.f;
  }
  __syncthreads();
  for (int kk = t; kk < kc; kk += blockDim.x) {
    float n = 0.f;
    for (int d = 0; d < D; ++d) {
      const float v = wsT[d * kc + kk];
      n += v * v;
    }
    norms[kk] = n;
  }
}

// Grid (nb, W), TM threads.  Shared memory (floats): wsT D*kc, norms kc,
// xs D*(TM+1), idx_s TM ints, then with SMEM_ACC the accumulators
// G*K*D floats and their counts G*K ints.
template <bool SMEM_ACC>
__global__ void assign_partial_kernel(
    const float* __restrict__ x, long long x_wstride,
    const float* __restrict__ w, int* __restrict__ idx,
    float* __restrict__ partials, int* __restrict__ pcounts,
    float* __restrict__ scratch, long long M, int K, int D, int kc,
    int groups) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int wi = blockIdx.y;
  const int b = blockIdx.x;
  const int nb = gridDim.x;
  const int tm = blockDim.x;
  const int t = threadIdx.x;
  const int kd = K * D;
  const long long tiles = (M + tm - 1) / tm;
  const float* xw = x + wi * x_wstride;
  const float* ww = w + static_cast<long long>(wi) * kd;
  int* idxw = idx + wi * M;

  float* wsT = sm;                                   // 16-byte aligned
  float* norms = wsT + D * kc;
  float* xs = norms + kc;
  const int xstride = tm + 1;
  int* idx_s = reinterpret_cast<int*>(xs + D * xstride);
  float* acc;
  if constexpr (SMEM_ACC)
    acc = reinterpret_cast<float*>(idx_s + tm);
  else
    acc = scratch + (static_cast<long long>(wi) * nb + b) * groups *
                        (kd + K);
  int* cnt = reinterpret_cast<int*>(acc + groups * kd);
  for (int e = t; e < groups * (kd + K); e += tm) acc[e] = 0.f;  // 0 bits

  const int nchunks = (K + kc - 1) / kc;
  if (nchunks == 1) load_chunk(ww, wsT, norms, 0, K, D, kc);
  __syncthreads();

  for (long long tile = b; tile < tiles; tile += nb) {
    const long long row0 = tile * tm;
    const int rows = static_cast<int>(min(static_cast<long long>(tm),
                                          M - row0));
    // stage the tile transposed: xs[d, i] = x[row0 + i, d]
    const float* base = xw + row0 * D;
    const int n = rows * D;
    if ((reinterpret_cast<uintptr_t>(base) & 15) == 0) {
      const float4* base4 = reinterpret_cast<const float4*>(base);
      for (int e4 = t; e4 < n / 4; e4 += tm) {
        const float4 v = base4[e4];
        int i = (4 * e4) / D;
        int d = 4 * e4 - i * D;
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xs[d * xstride + i] = vs[j];
          if (++d == D) { d = 0; ++i; }
        }
      }
      for (int e = (n / 4) * 4 + t; e < n; e += tm) {
        const int i = e / D;
        xs[(e - i * D) * xstride + i] = base[e];
      }
    } else {
      for (int e = t; e < n; e += tm) {
        const int i = e / D;
        xs[(e - i * D) * xstride + i] = base[e];
      }
    }
    __syncthreads();

    // E-step: one thread per sample, ascending k, strict < (first index
    // wins a tie, as torch.argmin and jnp.argmin)
    float best = INFINITY;
    int best_k = 0;
    for (int c = 0; c < nchunks; ++c) {
      const int k0 = c * kc;
      if (nchunks > 1) {
        __syncthreads();
        load_chunk(ww, wsT, norms, k0, K, D, kc);
        __syncthreads();
      }
      if (t < rows) {
        const int kn = min(kc, K - k0);
        for (int kb = 0; kb < kn; kb += KB) {
          float dot[KB];
#pragma unroll
          for (int j = 0; j < KB; ++j) dot[j] = 0.f;
          for (int d = 0; d < D; ++d) {
            const float xv = xs[d * xstride + t];
            const float4 a = *reinterpret_cast<const float4*>(
                wsT + d * kc + kb);
            const float4 e = *reinterpret_cast<const float4*>(
                wsT + d * kc + kb + 4);
            dot[0] = __fmaf_rn(xv, a.x, dot[0]);
            dot[1] = __fmaf_rn(xv, a.y, dot[1]);
            dot[2] = __fmaf_rn(xv, a.z, dot[2]);
            dot[3] = __fmaf_rn(xv, a.w, dot[3]);
            dot[4] = __fmaf_rn(xv, e.x, dot[4]);
            dot[5] = __fmaf_rn(xv, e.y, dot[5]);
            dot[6] = __fmaf_rn(xv, e.z, dot[6]);
            dot[7] = __fmaf_rn(xv, e.w, dot[7]);
          }
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            if (kb + j < kn) {
              const float s = -2.f * dot[j] + norms[kb + j];
              if (s < best) {
                best = s;
                best_k = k0 + kb + j;
              }
            }
          }
        }
      }
    }
    if (t < rows) {
      idxw[row0 + t] = best_k;
      idx_s[t] = best_k;
    }
    __syncthreads();

    // M-step partials: one writer per (group, k, d), samples in order
    if (D <= tm) {
      const int g = t / D;
      const int d = t - g * D;
      if (g < groups) {
        float* a = acc + g * kd + d;
        int* cn = cnt + g * K;
        for (int i = g; i < rows; i += groups) {
          const int k = idx_s[i];
          a[k * D] += xs[d * xstride + i];
          if (d == 0) cn[k] += 1;
        }
      }
    } else {                                   // groups == 1
      for (int d = t; d < D; d += tm) {
        for (int i = 0; i < rows; ++i) acc[idx_s[i] * D + d] +=
            xs[d * xstride + i];
      }
      if (t == 0)
        for (int i = 0; i < rows; ++i) cnt[idx_s[i]] += 1;
    }
    __syncthreads();          // xs and idx_s are the next tile's
  }

  // the block's groups in order -> partials[w, b]
  float* pw = partials + (static_cast<long long>(wi) * nb + b) * kd;
  for (int e = t; e < kd; e += tm) {
    float v = acc[e];
    for (int g = 1; g < groups; ++g) v += acc[g * kd + e];
    pw[e] = v;
  }
  int* pc = pcounts + (static_cast<long long>(wi) * nb + b) * K;
  for (int k = t; k < K; k += tm) {
    int c = cnt[k];
    for (int g = 1; g < groups; ++g) c += cnt[g * K + k];
    pc[k] = c;
  }
}

// Grid (ceil((K*D + K) / 32), W), block (32, 8).  Entry e < K*D is a sum,
// else a count.  Slice ty adds blocks ty, ty + 8, ... in order, then slice 0
// adds the 8 slices in order — a fixed tree.  Counts add as 64-bit integers
// and convert to f32 once (round to nearest).
__global__ void finalize_kernel(const float* __restrict__ partials,
                                const int* __restrict__ pcounts,
                                float* __restrict__ sums,
                                float* __restrict__ counts, int nb, int K,
                                int D) {
  const int kd = K * D;
  const int wi = blockIdx.y;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int e = blockIdx.x * FIN_ENTRIES + tx;
  __shared__ float fs[FIN_SLICES][FIN_ENTRIES];
  __shared__ long long cs[FIN_SLICES][FIN_ENTRIES];
  float v = 0.f;
  long long c = 0;
  if (e < kd) {
    for (int b = ty; b < nb; b += FIN_SLICES)
      v += partials[(static_cast<long long>(wi) * nb + b) * kd + e];
  } else if (e < kd + K) {
    for (int b = ty; b < nb; b += FIN_SLICES)
      c += pcounts[(static_cast<long long>(wi) * nb + b) * K + (e - kd)];
  }
  fs[ty][tx] = v;
  cs[ty][tx] = c;
  __syncthreads();
  if (ty == 0) {
    if (e < kd) {
      for (int j = 1; j < FIN_SLICES; ++j) v += fs[j][tx];
      sums[static_cast<long long>(wi) * kd + e] = v;
    } else if (e < kd + K) {
      for (int j = 1; j < FIN_SLICES; ++j) c += cs[j][tx];
      counts[static_cast<long long>(wi) * K + (e - kd)] =
          static_cast<float>(c);
    }
  }
}

// ---------------------------------------------------------------------------
// assign_stream_kernel: the small regime (see the note at the top)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// until the phase of parity `parity` has completed (acquire: what the
// arrivals and the bulk copy wrote is visible after it)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// 1D bulk copy global -> shared (TMA, no tensor map), completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// v[0..N) = p[0..N): 16-, 8- and 4-byte shared loads (p 16-byte aligned)
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&v)[N]) {
#pragma unroll
  for (int j = 0; j + 4 <= N; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + j);
    v[j] = q.x;
    v[j + 1] = q.y;
    v[j + 2] = q.z;
    v[j + 3] = q.w;
  }
  constexpr int r = N & ~3;
  if constexpr (N - r >= 2) {
    const float2 q = *reinterpret_cast<const float2*>(p + r);
    v[r] = q.x;
    v[r + 1] = q.y;
  }
  if constexpr (N & 1) v[N - 1] = p[N - 1];
}

// dot[r][0..N) += xv[r] * the N prototype values at wrow, for the thread's
// ST_R samples: each value read from shared memory serves ST_R samples
template <int N>
__device__ __forceinline__ void fma_col(const float (&xv)[ST_R],
                                        const float* wrow,
                                        float (&dot)[ST_R][N]) {
  float wv[N];
  load_row<N>(wrow, wv);
#pragma unroll
  for (int r = 0; r < ST_R; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) dot[r][j] = __fmaf_rn(xv[r], wv[j], dot[r][j]);
}

// Scores of prototypes k0 .. k0 + N against the thread's ST_R sample rows
// xr + r * 32 * D (ascending d, explicit fused multiply-adds), folded into
// (best[r], best_k[r]) in ascending k with a strict <.  The rows are read
// 16, 8 or 4 bytes at a time, the widest D allows: conflict-free at D % 8
// != 0 (D = 10: float2 reads of 40-byte rows).  -2 * dot is exact, so
// fma(-2, dot, norm) rounds as -2 * dot + norm does.
template <int N>
__device__ __forceinline__ void score_block(const float* xr, const float* wT,
                                            const float* norms, int D,
                                            int kp, int k0,
                                            float (&best)[ST_R],
                                            int (&best_k)[ST_R]) {
  float dot[ST_R][N];
#pragma unroll
  for (int r = 0; r < ST_R; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) dot[r][j] = 0.f;
  const float* wp = wT + k0;
  float xv[ST_R];
  if ((D & 3) == 0) {
    for (int d = 0; d < D; d += 4, wp += 4 * kp) {
      float4 q[ST_R];
#pragma unroll
      for (int r = 0; r < ST_R; ++r)
        q[r] = *reinterpret_cast<const float4*>(xr + r * 32 * D + d);
#pragma unroll
      for (int r = 0; r < ST_R; ++r) xv[r] = q[r].x;
      fma_col<N>(xv, wp, dot);
#pragma unroll
      for (int r = 0; r < ST_R; ++r) xv[r] = q[r].y;
      fma_col<N>(xv, wp + kp, dot);
#pragma unroll
      for (int r = 0; r < ST_R; ++r) xv[r] = q[r].z;
      fma_col<N>(xv, wp + 2 * kp, dot);
#pragma unroll
      for (int r = 0; r < ST_R; ++r) xv[r] = q[r].w;
      fma_col<N>(xv, wp + 3 * kp, dot);
    }
  } else if ((D & 1) == 0) {
    for (int d = 0; d < D; d += 2, wp += 2 * kp) {
      float2 q[ST_R];
#pragma unroll
      for (int r = 0; r < ST_R; ++r)
        q[r] = *reinterpret_cast<const float2*>(xr + r * 32 * D + d);
#pragma unroll
      for (int r = 0; r < ST_R; ++r) xv[r] = q[r].x;
      fma_col<N>(xv, wp, dot);
#pragma unroll
      for (int r = 0; r < ST_R; ++r) xv[r] = q[r].y;
      fma_col<N>(xv, wp + kp, dot);
    }
  } else {
    for (int d = 0; d < D; ++d, wp += kp) {
#pragma unroll
      for (int r = 0; r < ST_R; ++r) xv[r] = xr[r * 32 * D + d];
      fma_col<N>(xv, wp, dot);
    }
  }
  float nv[N];
  load_row<N>(norms + k0, nv);
#pragma unroll
  for (int r = 0; r < ST_R; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float sc = __fmaf_rn(-2.f, dot[r][j], nv[j]);
      if (sc < best[r]) {
        best[r] = sc;
        best_k[r] = k0 + j;
      }
    }
}

// argmin over all K for the thread's ST_R samples: blocks of ST_KB, then
// the tail K % ST_KB at its exact width
__device__ __forceinline__ void nearest(const float* xr, const float* wT,
                                        const float* norms, int K, int D,
                                        int kp, int (&best_k)[ST_R]) {
  float best[ST_R];
#pragma unroll
  for (int r = 0; r < ST_R; ++r) {
    best[r] = INFINITY;
    best_k[r] = 0;
  }
  int k0 = 0;
  for (; k0 + ST_KB <= K; k0 += ST_KB)
    score_block<ST_KB>(xr, wT, norms, D, kp, k0, best, best_k);
  switch (K - k0) {
#define KM_TAIL(n) \
  case n: score_block<n>(xr, wT, norms, D, kp, k0, best, best_k); break;
    KM_TAIL(1) KM_TAIL(2) KM_TAIL(3) KM_TAIL(4) KM_TAIL(5) KM_TAIL(6)
    KM_TAIL(7) KM_TAIL(8) KM_TAIL(9) KM_TAIL(10) KM_TAIL(11)
#undef KM_TAIL
    default: break;
  }
}

// the warp's accumulators (row sets r, then groups g, in order) into its
// running sums; zeroes them
__device__ __forceinline__ void flush_warp(float* a1, float* a2, int K,
                                           int D, int rs, int groups,
                                           int lane) {
  __syncwarp();
  for (int e = lane; e < K * D; e += 32) {
    const int k = e / D;
    float v = 0.f;
    for (int r = 0; r < ST_R; ++r) {
      float* a = a1 + (r * K + k) * rs + (e - k * D);
      for (int g = 0; g < groups; ++g) {
        v = r + g ? v + a[g * D] : a[0];
        a[g * D] = 0.f;
      }
    }
    a2[e] += v;
  }
  __syncwarp();
}

// Grid (nb, W), ST_THREADS threads: warps 0..ST_WARPS-1 compute, warp
// ST_WARPS copies.  Block b walks the tiles b, b + nb, ... of its worker;
// its j-th tile goes to stage j % stages.  Warp q of a tile owns its samples
// q * 32 * ST_R + r * 32 + lane (r < ST_R).  full[s] completes when stage s
// holds its tile (one arrival of the copying warp, plus the bulk copy's
// bytes); empty[s] when the ST_WARPS consumer warps have released it.
// Shared memory: the mbarriers (ST_BAR_BYTES), then in floats the ring
// stages * ST_TM * D, wT D * kp, norms kp, the warps' k as ST_WARPS * 32
// int4 (lane's four samples), the group accumulators
// ST_WARPS * ST_R * K * rs (a warp's set r, row k holds lane g * D + d's
// sum at g * D + d; rs = 32 with several groups, so the lanes of one add
// hit 32 distinct banks whatever their k, else rs = D), the warps' running
// sums ST_WARPS * K * D, and ST_WARPS * K int counts.
__global__ void __launch_bounds__(ST_THREADS) assign_stream_kernel(
    const float* __restrict__ x, long long x_wstride,
    const float* __restrict__ w, int* __restrict__ idx,
    float* __restrict__ partials, int* __restrict__ pcounts, long long M,
    int K, int D, int kp, int groups, int stages, int flush) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const int wi = blockIdx.y;
  const int b = blockIdx.x;
  const int nb = gridDim.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int kd = K * D;
  const int tile_n = ST_TM * D;
  const long long tiles = (M + ST_TM - 1) / ST_TM;
  const float* xw = x + wi * x_wstride;
  const float* ww = w + static_cast<long long>(wi) * kd;

  const uint32_t full = smem_addr(sb);      // full[s] at 8 s, empty[s] at
  const uint32_t empty = full + 8 * stages; //   8 (stages + s)
  float* ring = reinterpret_cast<float*>(sb + ST_BAR_BYTES);
  float* wT = ring + stages * tile_n;
  float* norms = wT + D * kp;
  int4* sk = reinterpret_cast<int4*>(norms + kp);
  float* acc1 = reinterpret_cast<float*>(sk + ST_WARPS * 32);
  const int rs = groups > 1 ? 32 : D;
  float* acc2 = acc1 + ST_WARPS * ST_R * K * rs;
  int* cnt = reinterpret_cast<int*>(acc2 + ST_WARPS * kd);

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, ST_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (warp == ST_WARPS) {
    // the copying warp: lane 0 waits for the stage to be free, then starts
    // the bulk copy, or all lanes copy and lane 0 arrives after them
    const bool bulk = (reinterpret_cast<uintptr_t>(xw) & 15) == 0;
    int s = 0;
    uint32_t phase = 0;
    for (long long tile = b, j = 0; tile < tiles; tile += nb, ++j) {
      if (j >= stages && lane == 0) mbar_wait(empty + 8 * s, phase ^ 1);
      __syncwarp();
      const long long row0 = tile * ST_TM;
      const int n = static_cast<int>(
          min(static_cast<long long>(ST_TM), M - row0)) * D;
      const float* src = xw + row0 * D;
      float* dst = ring + s * tile_n;
      if (bulk && (n & 3) == 0) {
        if (lane == 0) {
          mbar_arrive_tx(full + 8 * s, 4u * n);
          bulk_load(smem_addr(dst), src, 4u * n, full + 8 * s);
        }
      } else {                 // unaligned worker or ragged last tile
        fence_proxy_async();
        for (int e = lane; e < n; e += 32) dst[e] = src[e];
        __threadfence_block();
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + 8 * s);
      }
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
  } else {
    // stage the prototypes transposed and their norms (d ascending, as the
    // plain version's sum of squares); zero the accumulators
    for (int e = t; e < D * kp; e += ST_CT) {
      const int d = e / kp;
      const int k = e - d * kp;
      wT[e] = k < K ? ww[static_cast<long long>(k) * D + d] : 0.f;
    }
    for (int k = t; k < kp; k += ST_CT) {
      float n = 0.f;
      if (k < K)
        for (int d = 0; d < D; ++d) {
          const float v = ww[static_cast<long long>(k) * D + d];
          n += v * v;
        }
      norms[k] = n;
    }
    for (int e = t; e < ST_WARPS * (ST_R * K * rs + kd + K); e += ST_CT)
      acc1[e] = 0.f;          // acc1, acc2 and cnt: 0 bits
    asm volatile("bar.sync 1, %0;" ::"n"(ST_CT) : "memory");

    float* a1 = acc1 + warp * ST_R * K * rs;
    float* a2 = acc2 + warp * kd;
    int* cw = cnt + warp * K;
    int4* skw = sk + warp * 32;
    const int g = lane / D;                 // M-step: lane = (g, d)
    const int d = lane - g * D;
    const bool mlane = g < groups;
    int s = 0, since = 0;
    uint32_t phase = 0;
    for (long long tile = b; tile < tiles; tile += nb) {
      mbar_wait(full + 8 * s, phase);
      const float* xs = ring + s * tile_n + warp * 32 * ST_R * D;
      const long long row0 = tile * ST_TM + warp * 32 * ST_R;
      const int nw = static_cast<int>(
          max(0LL, min(static_cast<long long>(32 * ST_R), M - row0)));

      // E-step: lane = samples lane + 32 r
      int k[ST_R];
      nearest(xs + lane * D, wT, norms, K, D, kp, k);
#pragma unroll
      for (int r = 0; r < ST_R; ++r) {
        const int nv = min(32, max(0, nw - 32 * r));
        if (lane < nv) {
          idx[static_cast<long long>(wi) * M + row0 + 32 * r + lane] = k[r];
          atomicAdd(cw + k[r], 1);          // integers: any order is exact
        }
      }
      skw[lane] = make_int4(k[0], k[1], k[2], k[3]);
      // M-step: lane (g, d); set r adds the samples 32 r + g, 32 r + g + G,
      // ... in order.  The ST_R sets are independent, so their
      // read-add-write chains overlap; one 16-byte read gives their k.
      __syncwarp();
      const float* xp = xs + g * D + d;
      const int n0 = min(32, nw);
      for (int i0 = 0; i0 < n0; i0 += groups, xp += groups * D) {
        const int i = i0 + g;
        const bool in = mlane && i < 32;
        float v[ST_R], xv[ST_R];
        int at[ST_R];
        bool on[ST_R];
        const int4 kk = skw[in ? i : 0];
        const int kr[ST_R] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int r = 0; r < ST_R; ++r) {
          const int ki = kr[r];
          on[r] = in && 32 * r + i < nw;
          at[r] = (r * K + ki) * rs + lane;
          if (on[r]) {
            v[r] = a1[at[r]];
            xv[r] = xp[32 * r * D];
          }
        }
#pragma unroll
        for (int r = 0; r < ST_R; ++r)
          if (on[r]) a1[at[r]] = v[r] + xv[r];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (++since == flush) {
        flush_warp(a1, a2, K, D, rs, groups, lane);
        since = 0;
      }
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    if (since) flush_warp(a1, a2, K, D, rs, groups, lane);
  }
  __syncthreads();

  // the block's warps in order -> partials[w, b]
  float* pw = partials + (static_cast<long long>(wi) * nb + b) * kd;
  for (int e = t; e < kd; e += ST_THREADS) {
    float v = acc2[e];
    for (int q = 1; q < ST_WARPS; ++q) v += acc2[q * kd + e];
    pw[e] = v;
  }
  int* pc = pcounts + (static_cast<long long>(wi) * nb + b) * K;
  for (int k = t; k < K; k += ST_THREADS) {
    int c = cnt[k];
    for (int q = 1; q < ST_WARPS; ++q) c += cnt[q * K + k];
    pc[k] = c;
  }
}

// ---------------------------------------------------------------------------
// planning and launch
// ---------------------------------------------------------------------------

// The launch shape: pure arithmetic on (K, D), so every launch recomputes
// it; only the grid size nb needs the device (make_plan, once per shape).
int configure(int W, long long M, int K, int D, Plan* p) {
  if (W < 1 || M < 1 || K < 1 || D < 1 || D > MAX_D ||
      static_cast<long long>(K) * D > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  p->stream = D <= STREAM_MAX_D && K * D <= STREAM_MAX_KD;
  if (p->stream) {
    const int kd = K * D;
    p->tm = ST_TM;
    p->threads = ST_THREADS;
    p->kc = 0;
    p->kp = (K + 3) & ~3;
    p->groups = ST_WARPS * ST_R * K * 32 * 4 <= ST_ACC_BYTES ? 32 / D : 1;
    p->smem_acc = 1;
    const int stage_bytes = ST_TM * D * 4;
    p->stages = ST_RING_BYTES / stage_bytes;
    p->stages = p->stages < 2 ? 2 : (p->stages > 4 ? 4 : p->stages);
    const int steps = (32 + p->groups - 1) / p->groups;   // adds a tile
    p->flush = ST_CHAIN / steps < 1 ? 1 : ST_CHAIN / steps;
    p->smem = ST_BAR_BYTES + sizeof(float) *
        (static_cast<size_t>(p->stages) * ST_TM * D +
         static_cast<size_t>(D) * p->kp + p->kp +
         static_cast<size_t>(ST_WARPS) * ST_R * K *
             (p->groups > 1 ? 32 : D) +
         static_cast<size_t>(ST_WARPS) * kd +
         static_cast<size_t>(ST_WARPS) * K) +
      sizeof(int4) * ST_WARPS * 32;
    return 0;
  }
  p->tm = D <= 64 ? 256 : (D <= 128 ? 128 : 64);
  p->threads = p->tm;
  p->kc = K <= 8 ? 8 : (K <= 16 ? 16 : (D <= 128 ? 32 : 16));
  p->groups = D <= p->tm ? p->tm / D : 1;
  p->kp = p->stages = p->flush = 0;
  const size_t base = sizeof(float) *
      (static_cast<size_t>(D) * p->kc + p->kc +
       static_cast<size_t>(D) * (p->tm + 1) + p->tm);
  const size_t acc = sizeof(float) * static_cast<size_t>(p->groups) *
                     (static_cast<size_t>(K) * D + K);
  p->smem_acc = acc <= SMEM_ACC_BYTES;
  p->smem = base + (p->smem_acc ? acc : 0);
  return 0;
}

const void* partial_kernel(const Plan& p) {
  if (p.stream) return reinterpret_cast<const void*>(assign_stream_kernel);
  return p.smem_acc
      ? reinterpret_cast<const void*>(assign_partial_kernel<true>)
      : reinterpret_cast<const void*>(assign_partial_kernel<false>);
}

// nb: as many blocks as the card holds at once, spread over the W workers,
// at most one per tile; the partial kernels may take all the opt-in shared
// memory (set once, to the device maximum, so no later plan lowers it).
int make_plan(int W, long long M, int K, int D, Plan* p) {
  if (int rc = configure(W, M, K, D, p)) return rc;
  int occ = 0, dev = 0, sms = 0, optin = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) ||
      (e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return static_cast<int>(e);
  if (p->smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* fn :
       {reinterpret_cast<const void*>(assign_partial_kernel<true>),
        reinterpret_cast<const void*>(assign_partial_kernel<false>),
        reinterpret_cast<const void*>(assign_stream_kernel)})
    if ((e = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)))
      return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, partial_kernel(*p), p->threads, p->smem)))
    return static_cast<int>(e);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (M + p->tm - 1) / p->tm;
  long long nb = (static_cast<long long>(sms) * occ + W - 1) / W;
  nb = nb < tiles ? nb : tiles;
  p->nb = static_cast<int>(nb < 1 ? 1 : nb);
  p->scratch = p->smem_acc ? 0
      : static_cast<long long>(W) * p->nb * p->groups *
            (static_cast<long long>(K) * D + K);
  return 0;
}

}  // namespace

extern "C" {

const char* kmeans_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int kmeans_max_d() { return MAX_D; }

// out[0..1] = blocks per worker nb, floats of global scratch.  The caller
// allocates partials (W, nb, K, D) f32, pcounts (W, nb, K) int32 and the
// scratch.  Plans for the current device.
int kmeans_assign_plan(int W, long long M, int K, int D, long long* out) {
  Plan p;
  if (int rc = make_plan(W, M, K, D, &p)) return rc;
  out[0] = p.nb;
  out[1] = p.scratch;
  return 0;
}

// B4.  x (M, D) with x_wstride 0, or (W, M, D) with x_wstride M * D; w (W,
// K, D); idx (W, M) int32; sums (W, K, D) f32; counts (W, K) f32.  nb is
// kmeans_assign_plan's for this shape and device (called first: it also
// sets the kernels' shared-memory limit); the sums' order follows nb.
int kmeans_assign(const float* x, long long x_wstride, const float* w,
                  int* idx, float* sums, float* counts, float* partials,
                  int* pcounts, float* scratch, int W, long long M, int K,
                  int D, int nb, cudaStream_t stream) {
  Plan p;
  if (int rc = configure(W, M, K, D, &p)) return rc;
  p.nb = nb;
  if (nb < 1 || nb > (M + p.tm - 1) / p.tm ||
      (!p.smem_acc && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(p.nb), static_cast<unsigned>(W));
  if (p.stream)
    assign_stream_kernel<<<grid, p.threads, p.smem, stream>>>(
        x, x_wstride, w, idx, partials, pcounts, M, K, D, p.kp, p.groups,
        p.stages, p.flush);
  else if (p.smem_acc)
    assign_partial_kernel<true><<<grid, p.tm, p.smem, stream>>>(
        x, x_wstride, w, idx, partials, pcounts, scratch, M, K, D, p.kc,
        p.groups);
  else
    assign_partial_kernel<false><<<grid, p.tm, p.smem, stream>>>(
        x, x_wstride, w, idx, partials, pcounts, scratch, M, K, D, p.kc,
        p.groups);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const long long entries = static_cast<long long>(K) * D + K;
  const dim3 fgrid(
      static_cast<unsigned>((entries + FIN_ENTRIES - 1) / FIN_ENTRIES),
      static_cast<unsigned>(W));
  finalize_kernel<<<fgrid, dim3(FIN_ENTRIES, FIN_SLICES), 0, stream>>>(
      partials, pcounts, sums, counts, p.nb, K, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
