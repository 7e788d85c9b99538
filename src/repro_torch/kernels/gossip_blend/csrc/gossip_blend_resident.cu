// Packed-resident gossip blend (paper eqs. 4-6) for Hopper, sm_90a.
//
// Replaces the two Pallas TPU kernels of the reference's packed-resident
// engine, src/repro/kernels/gossip_blend/kernel.py:
//   gossip_reduce_w_resident_pallas  -> reduce_partial_kernel
//                                       + reduce_finalize_kernel
//   gossip_apply_w_resident_pallas   -> apply_kernel
//
// Layout: w, dw, out (W, R, LANE) f32; ext (W, P, R, LANE) f32, or int8
// with scales (W, P, R / block_rows) f32 — one scale per block_rows row
// tile per external (the int8 wire's quantization tile).  The exchanged
// partition is the row range [r0, r1), passed by value.
//
// Bound: both passes are memory-bound streams (a few flops per byte, far
// under the H100's ~20 flop/byte f32 ridge).  Every term of the reduce
// pass is zero outside [r0, r1), so it reads only those rows of w, dw and
// ext; the apply pass reads w and dw everywhere, ext only inside the
// range, and writes out everywhere.  At the main-path shape (W=4,
// R=262848, one quarter of the rows in range, int8 ext) that is ~1.35 GB
// for the reduce and ~6.6 GB for the apply, i.e. ~0.4 ms and ~2.0 ms at
// 3.35 TB/s.  Design against it: 16-byte float4 loads (4-byte char4 for
// int8), one block per tile of rows, no shared-memory staging.
//
// Determinism: the TPU kernel accumulates the (W, P, 3) sums across a
// sequential grid.  Hopper blocks run in no order, and the Parzen gate is
// a hard threshold on a difference of these sums, so there are no float
// atomics: each block writes its tile's partial sums (warp shuffles, then
// warps in fixed order) into partials[W, nblk, P, 3], and a second launch
// adds them in fixed order.  Built with -fmad=false, so every product and
// sum rounds on its own, as in the plain-torch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 512;
constexpr int LANE4 = LANE / 4;        // float4 per row
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int REDUCE_ROWS = 32;        // rows per reduce block
constexpr int APPLY_ROWS = 16;         // rows per apply block
constexpr int MAX_P = 8;               // externals per worker
constexpr int MAX_TERMS = 2 * MAX_P + 1;

template <bool INT8>
__device__ __forceinline__ float4 load_ext(const void* ext, long long i4,
                                           float scale) {
  if constexpr (INT8) {
    const char4 q = reinterpret_cast<const char4*>(ext)[i4];
    return make_float4(static_cast<float>(q.x) * scale,
                       static_cast<float>(q.y) * scale,
                       static_cast<float>(q.z) * scale,
                       static_cast<float>(q.w) * scale);
  } else {
    return reinterpret_cast<const float4*>(ext)[i4];
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// Pass 1a: grid (nblk, W).  Block b sums rows
// [r0 + b*REDUCE_ROWS, min(r0 + (b+1)*REDUCE_ROWS, r1)) of worker blockIdx.y
// into partials[w, b, p, :] = [<dw, w - ext_p>, ||ext_p||^2, ||dw||^2].
template <bool INT8>
__global__ void __launch_bounds__(THREADS)
reduce_partial_kernel(const float4* __restrict__ w,
                      const float4* __restrict__ dw,
                      const void* __restrict__ ext,
                      const float* __restrict__ scales,
                      float* __restrict__ partials, int P, long long R,
                      int r0, int r1, int block_rows, long long nb) {
  const int b = blockIdx.x;
  const int wi = blockIdx.y;
  const int nblk = gridDim.x;
  const int row_begin = r0 + b * REDUCE_ROWS;
  const int row_end = min(row_begin + REDUCE_ROWS, r1);
  const int n4 = (row_end - row_begin) * LANE4;

  // terms[p] = <dw, w - ext_p>, terms[MAX_P + p] = ||ext_p||^2,
  // terms[2 * MAX_P] = ||dw||^2 — fixed slots, so every index is a
  // compile-time constant after unrolling and the sums stay in registers
  float terms[MAX_TERMS];
#pragma unroll
  for (int k = 0; k < MAX_TERMS; ++k) terms[k] = 0.f;

  for (int i = threadIdx.x; i < n4; i += THREADS) {
    const int row = row_begin + i / LANE4;
    const int c4 = i % LANE4;
    const long long s4 = (static_cast<long long>(wi) * R + row) * LANE4 + c4;
    const float4 wv = w[s4];
    const float4 dv = dw[s4];
    terms[2 * MAX_P] += dot4(dv, dv);
#pragma unroll
    for (int p = 0; p < MAX_P; ++p) {
      if (p < P) {
        const long long wp = static_cast<long long>(wi) * P + p;
        const float scale = INT8 ? scales[wp * nb + row / block_rows] : 1.f;
        const float4 ev = load_ext<INT8>(ext, (wp * R + row) * LANE4 + c4,
                                         scale);
        terms[p] += dot4(dv, sub4(wv, ev));
        terms[MAX_P + p] += dot4(ev, ev);
      }
    }
  }

  // block reduction: shuffles inside each warp, then the warps' sums in
  // warp order — a fixed order, so the result is reproducible run to run
  __shared__ float warp_sums[WARPS][MAX_TERMS];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < MAX_TERMS; ++k) {
    float v = terms[k];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k < MAX_TERMS) {
    float v = 0.f;
    for (int j = 0; j < WARPS; ++j) v += warp_sums[j][k];
    float* blk = partials + (static_cast<long long>(wi) * nblk + b) * P * 3;
    if (k < P) {
      blk[k * 3 + 0] = v;
    } else if (k >= MAX_P && k < MAX_P + P) {
      blk[(k - MAX_P) * 3 + 1] = v;
    } else if (k == 2 * MAX_P) {
      for (int p = 0; p < P; ++p) blk[p * 3 + 2] = v;  // shared ||dw||^2
    }
  }
}

// Pass 1b: grid (W * P * 3).  acc[w, p, j] = sum over b of
// partials[w, b, p, j], strided per thread then a shared-memory tree —
// fixed order again.  nblk == 0 (an empty row range) gives zeros.
__global__ void __launch_bounds__(THREADS)
reduce_finalize_kernel(const float* __restrict__ partials,
                       float* __restrict__ acc, int P, int nblk) {
  const int t = blockIdx.x;           // (w * P + p) * 3 + j
  const int j = t % 3;
  const int wp = t / 3;
  const int wi = wp / P;
  const int p = wp % P;
  float v = 0.f;
  for (int b = threadIdx.x; b < nblk; b += THREADS)
    v += partials[((static_cast<long long>(wi) * nblk + b) * P + p) * 3 + j];
  __shared__ float s[THREADS];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) s[threadIdx.x] += s[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) acc[t] = s[0];
}

// Pass 2: grid (ceil(R / APPLY_ROWS), W).  Inside [r0, r1):
//   mean = inv_denom * (w + sum_p g_p ext_p),  att = w - mean
//   out  = w - lr * (att + dw)                 (paper, eq. 6 + eq. 1)
//   out  = (w - lr * dw) - alpha * att         (elastic variant)
// outside: out = w - lr * dw (the plain SGD step; ext is not read).
template <bool INT8>
__global__ void __launch_bounds__(THREADS)
apply_kernel(const float4* __restrict__ w, const float4* __restrict__ dw,
             const void* __restrict__ ext, const float* __restrict__ scales,
             const float* __restrict__ gates,
             const float* __restrict__ inv_denom,
             const float* __restrict__ lr_ptr, float4* __restrict__ out,
             int P, long long R, int r0, int r1, int block_rows, long long nb,
             int elastic, float alpha) {
  const int wi = blockIdx.y;
  const long long row_begin = static_cast<long long>(blockIdx.x) * APPLY_ROWS;
  const long long row_end = min(row_begin + APPLY_ROWS, R);
  const int n4 = static_cast<int>(row_end - row_begin) * LANE4;
  const float lr = *lr_ptr;
  const float inv = inv_denom[wi];
  float g[MAX_P];
#pragma unroll
  for (int p = 0; p < MAX_P; ++p)
    g[p] = p < P ? gates[static_cast<long long>(wi) * P + p] : 0.f;

  for (int i = threadIdx.x; i < n4; i += THREADS) {
    const long long row = row_begin + i / LANE4;
    const int c4 = i % LANE4;
    const long long s4 = (static_cast<long long>(wi) * R + row) * LANE4 + c4;
    const float4 wv = w[s4];
    const float4 dv = dw[s4];
    float4 o;
    if (row >= r0 && row < r1) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int p = 0; p < MAX_P; ++p) {
        if (p < P) {
          const long long wp = static_cast<long long>(wi) * P + p;
          const float scale =
              INT8 ? scales[wp * nb + row / block_rows] : 1.f;
          const float4 ev = load_ext<INT8>(ext, (wp * R + row) * LANE4 + c4,
                                           scale);
          const float4 ge = make_float4(g[p] * ev.x, g[p] * ev.y,
                                        g[p] * ev.z, g[p] * ev.w);
          sum = p == 0 ? ge
                       : make_float4(sum.x + ge.x, sum.y + ge.y,
                                     sum.z + ge.z, sum.w + ge.w);
        }
      }
      const float4 att = make_float4(
          wv.x - inv * (wv.x + sum.x), wv.y - inv * (wv.y + sum.y),
          wv.z - inv * (wv.z + sum.z), wv.w - inv * (wv.w + sum.w));
      if (elastic) {
        o = make_float4((wv.x - lr * dv.x) - alpha * att.x,
                        (wv.y - lr * dv.y) - alpha * att.y,
                        (wv.z - lr * dv.z) - alpha * att.z,
                        (wv.w - lr * dv.w) - alpha * att.w);
      } else {
        o = make_float4(wv.x - lr * (att.x + dv.x),
                        wv.y - lr * (att.y + dv.y),
                        wv.z - lr * (att.z + dv.z),
                        wv.w - lr * (att.w + dv.w));
      }
    } else {
      o = make_float4(wv.x - lr * dv.x, wv.y - lr * dv.y, wv.z - lr * dv.z,
                      wv.w - lr * dv.w);
    }
    out[s4] = o;
  }
}

int check_args(int P, int r0, int r1, long long R, int block_rows) {
  if (P < 1 || P > MAX_P || r0 < 0 || r1 < r0 || r1 > R || block_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

int gossip_reduce_rows_per_block() { return REDUCE_ROWS; }

int gossip_max_externals() { return MAX_P; }

const char* gossip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// partials: (W, nblk, P, 3) f32 scratch with
// nblk = ceil((r1 - r0) / gossip_reduce_rows_per_block()); acc: (W, P, 3).
int gossip_reduce_w_resident(const float* w, const float* dw, const void* ext,
                             const float* scales, float* partials,
                             float* acc, int W, int P, long long R, int r0,
                             int r1, int block_rows, int ext_int8,
                             cudaStream_t stream) {
  if (int rc = check_args(P, r0, r1, R, block_rows)) return rc;
  const int nblk = (r1 - r0 + REDUCE_ROWS - 1) / REDUCE_ROWS;
  const long long nb = R / block_rows;
  if (nblk > 0) {
    const dim3 grid(nblk, W);
    const auto* w4 = reinterpret_cast<const float4*>(w);
    const auto* dw4 = reinterpret_cast<const float4*>(dw);
    if (ext_int8)
      reduce_partial_kernel<true><<<grid, THREADS, 0, stream>>>(
          w4, dw4, ext, scales, partials, P, R, r0, r1, block_rows, nb);
    else
      reduce_partial_kernel<false><<<grid, THREADS, 0, stream>>>(
          w4, dw4, ext, scales, partials, P, R, r0, r1, block_rows, nb);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  reduce_finalize_kernel<<<W * P * 3, THREADS, 0, stream>>>(partials, acc, P,
                                                            nblk);
  return static_cast<int>(cudaGetLastError());
}

// gates: (W, P) f32; inv_denom: (W,) f32; lr: (1,) f32 — all on the device,
// so a per-round lr schedule never rebuilds or re-specializes the kernel.
int gossip_apply_w_resident(const float* w, const float* dw, const void* ext,
                            const float* scales, const float* gates,
                            const float* inv_denom, const float* lr,
                            float* out, int W, int P, long long R, int r0,
                            int r1, int block_rows, int ext_int8, int elastic,
                            float elastic_alpha, cudaStream_t stream) {
  if (int rc = check_args(P, r0, r1, R, block_rows)) return rc;
  const long long nb = R / block_rows;
  const dim3 grid(static_cast<unsigned>((R + APPLY_ROWS - 1) / APPLY_ROWS), W);
  const auto* w4 = reinterpret_cast<const float4*>(w);
  const auto* dw4 = reinterpret_cast<const float4*>(dw);
  auto* out4 = reinterpret_cast<float4*>(out);
  if (ext_int8)
    apply_kernel<true><<<grid, THREADS, 0, stream>>>(
        w4, dw4, ext, scales, gates, inv_denom, lr, out4, P, R, r0, r1,
        block_rows, nb, elastic, elastic_alpha);
  else
    apply_kernel<false><<<grid, THREADS, 0, stream>>>(
        w4, dw4, ext, scales, gates, inv_denom, lr, out4, P, R, r0, r1,
        block_rows, nb, elastic, elastic_alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
