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
// ~500 operations per byte: f32 operations bound it.  Design:
//   - a fixed grid of blocks per worker (as many as fit on the card at
//     once), each striding over tiles of TM samples in a fixed order; a
//     tile of x is staged in shared memory, transposed (one row per
//     dimension, padded by one against bank conflicts), one thread per
//     sample;
//   - the prototypes are staged in chunks of KC, transposed, with their
//     squared norms; each thread keeps 8 dot products in registers per
//     pass over D (3 shared loads per 8 fused multiply-adds); a chunk that
//     holds every prototype is staged once per block;
//   - the E-step's dot products use explicit fused multiply-adds (the
//     library is built with -fmad=false): they differ from the plain
//     version's cuBLAS order in the last bits, which moves idx only where
//     the two best scores nearly tie.
//
// Determinism without float atomics: the TPU grid runs in order and adds
// every tile into one accumulator.  Here each block adds its tiles into its
// own accumulators, in fixed order: the threads of group g (one thread per
// dimension d) walk the tile's samples g, g + G, g + 2G, ... and add x[i, d]
// into acc[g, idx[i], d] — each (g, k, d) entry has one writer that adds in
// sample order.  At the end the block adds its G groups in order into
// partials[w, block], and a second launch adds the blocks in a fixed tree.
// The accumulators sit in shared memory when they fit (K = D = 10: 11 KB),
// else in block-private global scratch.  Counts are integers until the
// very end: an f32 sum of ones stops at 2^24, and a cluster of the paper's
// 10^8-sample run holds ~10^7; each count is converted once, correctly
// rounded.

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

struct Plan {
  int tm;          // samples per tile = threads per block
  int kc;          // prototypes per staged chunk, a multiple of KB
  int groups;      // M-step groups G
  int smem_acc;    // accumulators in shared memory (else global scratch)
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

// The launch shape: pure arithmetic on (K, D), so every launch recomputes
// it; only the grid size nb needs the device (make_plan, once per shape).
int configure(int W, long long M, int K, int D, Plan* p) {
  if (W < 1 || M < 1 || K < 1 || D < 1 || D > MAX_D ||
      static_cast<long long>(K) * D > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  p->tm = D <= 64 ? 256 : (D <= 128 ? 128 : 64);
  p->kc = K <= 8 ? 8 : (K <= 16 ? 16 : (D <= 128 ? 32 : 16));
  p->groups = D <= p->tm ? p->tm / D : 1;
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
        reinterpret_cast<const void*>(assign_partial_kernel<false>)})
    if ((e = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)))
      return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, partial_kernel(*p), p->tm, p->smem)))
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
  if (p.smem_acc)
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
