// Gossip blend (paper eqs. 4-6) for Hopper, sm_90a.
//
// Replaces eight Pallas TPU kernels.  Six of src/repro/kernels/gossip_blend/
// kernel.py:
//   gossip_reduce_w_resident_pallas (:370) -> gossip_reduce_w_resident (B1r)
//   gossip_apply_w_resident_pallas  (:412) -> gossip_apply_w_resident  (B1a)
//   gossip_reduce_w_pallas          (:225) -> gossip_reduce_w          (B2r)
//   gossip_apply_w_pallas           (:259) -> gossip_apply_w           (B2a)
//   gossip_reduce_pallas            (:115) -> gossip_reduce            (B3r)
//   gossip_apply_pallas             (:141) -> gossip_apply             (B3a)
// and the P=1 pair of src/repro/kernels/parzen_blend/kernel.py:
//   parzen_reduce_pallas            (:65)  -> parzen_reduce            (B6r)
//   parzen_apply_pallas             (:85)  -> parzen_apply             (B6a)
// The eight entry points share one templated reduce body and one templated
// apply body.  Template flags: INT8, int8 externals with one scale per
// block_rows row tile (B1's wire); MASK, a worker-shared (R, LANE) 0/1
// partition mask (B2, the pytree engine's 'leaves' mode).  Every kernel
// also takes a row range [r0, r1): outside it every reduce term is 0 and
// the apply takes the plain step.  B1 passes its partition's rows; B2 and
// B3 pass [0, R).  B3 is W = 1 without a mask.  B6 is B3 at P = 1 with two
// differences, both flags: its accumulator is ordered [<dw, w - ext>,
// ||dw||^2, ||ext||^2] (the finalize's parzen_order), and its apply blends
// by the reference's formula w - eps * (gate * 0.5 * (w - ext) + dw), in
// that order of operations (the PARZEN template flag), which rounds
// otherwise than B3's w - (w + g * ext) / (g + 1).
//
// Layout: w, dw, out (W, R, LANE) f32; ext (W, P, R, LANE) f32, or int8
// with scales (W, P, R / block_rows) f32; mask (R, LANE) f32.
//
// Bound: both passes are memory-bound streams (a few flops per byte, far
// under the H100's ~20 flop/byte f32 ridge).  The reduce reads only what
// adds to a term: rows in [r0, r1), and with a mask the mask plus w, dw and
// ext where it is 1.  The apply reads w and dw everywhere and ext only where
// the attraction applies, and writes out everywhere.  Design against it:
//   - 16-byte float4 loads (4-byte char4 for int8), one block per tile of
//     rows, no shared-memory staging;
//   - a float4 of the mask that is all 0 skips the loads of w, dw and ext in
//     the reduce and of ext in the apply (for finite operands the skipped
//     terms are exactly 0 and the apply gives w - lr*dw either way);
//   - blocks are numbered worker-fastest, so the W blocks of one row tile
//     run together and read that tile of the mask from HBM once.
//
// Determinism: the TPU kernels accumulate the (W, P, 3) sums across a
// sequential grid.  Hopper blocks run in no order, and the Parzen gate is
// a hard threshold on a difference of these sums, so there are no float
// atomics: each block writes its tile's partial sums (warp shuffles, then
// warps in fixed order) into partials[W, nblk, P, 3], and a second launch
// adds them in fixed order.  Built with -fmad=false, so every product and
// sum rounds on its own, as in the plain-torch versions.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 512;
constexpr int LANE4 = LANE / 4;        // float4 per row
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int REDUCE_ROWS = 32;        // rows per reduce block
constexpr int APPLY_ROWS = 16;         // rows per apply block
constexpr int MAX_P = 8;               // externals: the paper's N buffers
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

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ bool zero4(float4 a) {
  return a.x == 0.f && a.y == 0.f && a.z == 0.f && a.w == 0.f;
}

// Operands of both passes: the pointers reach the kernels as __restrict__
// parameters (read-only loads), the sizes as one Shape.
struct Shape {
  int W, P;
  long long R, r0, r1;
  int block_rows;
  long long nb;            // scale tiles per state, R / block_rows
};

struct Operands {
  const float4* w;
  const float4* dw;
  const void* ext;
  const float* scales;     // INT8 only
  const float4* mask;      // MASK only
  Shape sh;
};

#define OPERAND_PARAMS                                                    \
  const float4* __restrict__ w, const float4* __restrict__ dw,            \
      const void* __restrict__ ext, const float* __restrict__ scales,     \
      const float4* __restrict__ mask, Shape op
#define OPERAND_ARGS(o) o.w, o.dw, o.ext, o.scales, o.mask, o.sh

// Pass 1a: grid (nblk * W), worker fastest.  Block (b, w) sums rows
// [r0 + b*REDUCE_ROWS, min(r0 + (b+1)*REDUCE_ROWS, r1)) of worker w into
// partials[w, b, p, :] = [<dw, w - ext_p>, ||ext_p||^2, ||dw||^2], with dw
// and ext_p multiplied by the mask first when MASK (m in {0, 1}, m^2 = m,
// so every term is restricted to the partition).
template <bool INT8, bool MASK>
__global__ void __launch_bounds__(THREADS)
reduce_partial_kernel(OPERAND_PARAMS, float* __restrict__ partials) {
  const int wi = blockIdx.x % op.W;
  const int b = blockIdx.x / op.W;
  const int nblk = gridDim.x / op.W;
  const int P = op.P;
  const long long row_begin = op.r0 + static_cast<long long>(b) * REDUCE_ROWS;
  const long long row_end = min(row_begin + REDUCE_ROWS, op.r1);
  const int n4 = static_cast<int>(row_end - row_begin) * LANE4;
  const long long state4 = op.R * LANE4;             // float4 per state

  // terms[p] = <dw, w - ext_p>, terms[MAX_P + p] = ||ext_p||^2,
  // terms[2 * MAX_P] = ||dw||^2 — fixed slots, so every index is a
  // compile-time constant after unrolling and the sums stay in registers
  float terms[MAX_TERMS];
#pragma unroll
  for (int k = 0; k < MAX_TERMS; ++k) terms[k] = 0.f;

  for (int i = threadIdx.x; i < n4; i += THREADS) {
    const long long r4 = row_begin * LANE4 + i;      // inside one state
    float4 mv;
    if constexpr (MASK) {
      mv = mask[r4];
      if (zero4(mv)) continue;                       // every term is 0 here
    }
    const long long s4 = wi * state4 + r4;
    const float4 wv = w[s4];
    float4 dv = dw[s4];
    if constexpr (MASK) dv = mul4(dv, mv);
    terms[2 * MAX_P] += dot4(dv, dv);
#pragma unroll
    for (int p = 0; p < MAX_P; ++p) {
      if (p < P) {
        const long long wp = static_cast<long long>(wi) * P + p;
        // rows fit an int: a 32-bit division, not a 64-bit one
        const float scale =
            INT8 ? scales[wp * op.nb + static_cast<int>(r4 / LANE4) /
                                           op.block_rows]
                 : 1.f;
        float4 ev = load_ext<INT8>(ext, wp * state4 + r4, scale);
        if constexpr (MASK) ev = mul4(ev, mv);
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
// fixed order again.  nblk == 0 (an empty row range) gives zeros.  With
// parzen_order (B6, P = 1) terms 1 and 2 trade places in acc.
__global__ void __launch_bounds__(THREADS)
reduce_finalize_kernel(const float* __restrict__ partials,
                       float* __restrict__ acc, int P, int nblk,
                       int parzen_order) {
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
  if (threadIdx.x == 0) acc[parzen_order && j ? t - j + 3 - j : t] = s[0];
}

// Pass 2: grid (ceil(R / APPLY_ROWS) * W), worker fastest.  Where the
// attraction applies (rows in [r0, r1), times the mask when MASK):
//   mean = inv_denom * (w + sum_p g_p ext_p),  att = w - mean
//   out  = w - lr * (att + dw)                 (paper, eq. 6 + eq. 1)
//   out  = (w - lr * dw) - alpha * att         (elastic variant)
// elsewhere out = w - lr * dw (the plain SGD step; ext is not read).  lr is
// read from device memory (B1: a schedule never rebuilds anything) or, when
// lr_ptr is null, is the static lr_value (B2, B3, B6: the TPU kernels' eps).
// PARZEN (B6: P = 1, no mask, no row range, not elastic):
//   att = (gate * 0.5) * (w - ext),  out = w - lr * (att + dw).
template <bool INT8, bool MASK, bool PARZEN = false>
__global__ void __launch_bounds__(THREADS)
apply_kernel(OPERAND_PARAMS, const float* __restrict__ gates,
             const float* __restrict__ inv_denom,
             const float* __restrict__ lr_ptr, float lr_value,
             float4* __restrict__ out, int elastic, float alpha) {
  const int wi = blockIdx.x % op.W;
  const long long row_begin =
      static_cast<long long>(blockIdx.x / op.W) * APPLY_ROWS;
  const long long row_end = min(row_begin + APPLY_ROWS, op.R);
  const int n4 = static_cast<int>(row_end - row_begin) * LANE4;
  const long long state4 = op.R * LANE4;
  const int P = op.P;
  const float lr = lr_ptr ? *lr_ptr : lr_value;
  const float inv = PARZEN ? 0.f : inv_denom[wi];
  float g[MAX_P];
#pragma unroll
  for (int p = 0; p < MAX_P; ++p)
    g[p] = p < P ? gates[static_cast<long long>(wi) * P + p] : 0.f;

  for (int i = threadIdx.x; i < n4; i += THREADS) {
    const long long r4 = row_begin * LANE4 + i;
    const int row = static_cast<int>(r4 / LANE4);
    const long long s4 = wi * state4 + r4;
    const float4 wv = w[s4];
    const float4 dv = dw[s4];
    bool blend = row >= op.r0 && row < op.r1;
    float4 mv;
    if constexpr (MASK) {
      if (blend) {
        mv = mask[r4];
        blend = !zero4(mv);
      }
    }
    float4 o;
    if constexpr (PARZEN) {
      const float4 ev = reinterpret_cast<const float4*>(ext)[s4];
      const float gh = g[0] * 0.5f;
      const float4 att = make_float4(gh * (wv.x - ev.x), gh * (wv.y - ev.y),
                                     gh * (wv.z - ev.z), gh * (wv.w - ev.w));
      o = make_float4(wv.x - lr * (att.x + dv.x), wv.y - lr * (att.y + dv.y),
                      wv.z - lr * (att.z + dv.z), wv.w - lr * (att.w + dv.w));
    } else if (blend) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int p = 0; p < MAX_P; ++p) {
        if (p < P) {
          const long long wp = static_cast<long long>(wi) * P + p;
          const float scale =
              INT8 ? scales[wp * op.nb + row / op.block_rows] : 1.f;
          const float4 ev = load_ext<INT8>(ext, wp * state4 + r4, scale);
          const float4 ge = make_float4(g[p] * ev.x, g[p] * ev.y,
                                        g[p] * ev.z, g[p] * ev.w);
          sum = p == 0 ? ge
                       : make_float4(sum.x + ge.x, sum.y + ge.y,
                                     sum.z + ge.z, sum.w + ge.w);
        }
      }
      float4 att = make_float4(
          wv.x - inv * (wv.x + sum.x), wv.y - inv * (wv.y + sum.y),
          wv.z - inv * (wv.z + sum.z), wv.w - inv * (wv.w + sum.w));
      if constexpr (MASK) att = mul4(att, mv);
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

Operands operands(const float* w, const float* dw, const void* ext,
                  const float* scales, const float* mask, int W, int P,
                  long long R, long long r0, long long r1, int block_rows) {
  return Operands{reinterpret_cast<const float4*>(w),
                  reinterpret_cast<const float4*>(dw), ext, scales,
                  reinterpret_cast<const float4*>(mask),
                  Shape{W, P, R, r0, r1, block_rows,
                        block_rows > 0 ? R / block_rows : 0}};
}

int check(const Operands& o) {
  const Shape& op = o.sh;
  if (op.W < 1 || op.P < 1 || op.P > MAX_P || op.R < 1 || op.R > INT_MAX ||
      op.r0 < 0 || op.r1 < op.r0 || op.r1 > op.R || op.block_rows < 1 ||
      (o.scales && o.mask))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// partials: (W, nblk, P, 3) f32 scratch with
// nblk = ceil((r1 - r0) / gossip_reduce_rows_per_block()); acc: (W, P, 3).
// scales non-null selects the int8 body, mask non-null the masked one.
int launch_reduce(const Operands& o, float* partials, float* acc,
                  cudaStream_t stream, int parzen_order = 0) {
  if (int rc = check(o)) return rc;
  const Shape& op = o.sh;
  const int nblk =
      static_cast<int>((op.r1 - op.r0 + REDUCE_ROWS - 1) / REDUCE_ROWS);
  if (nblk > 0) {
    const dim3 grid(static_cast<unsigned>(nblk) * op.W);
    if (o.scales)
      reduce_partial_kernel<true, false><<<grid, THREADS, 0, stream>>>(
          OPERAND_ARGS(o), partials);
    else if (o.mask)
      reduce_partial_kernel<false, true><<<grid, THREADS, 0, stream>>>(
          OPERAND_ARGS(o), partials);
    else
      reduce_partial_kernel<false, false><<<grid, THREADS, 0, stream>>>(
          OPERAND_ARGS(o), partials);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  reduce_finalize_kernel<<<op.W * op.P * 3, THREADS, 0, stream>>>(
      partials, acc, op.P, nblk, parzen_order);
  return static_cast<int>(cudaGetLastError());
}

int launch_apply(const Operands& o, const float* gates,
                 const float* inv_denom, const float* lr_ptr, float lr_value,
                 float* out, int elastic, float alpha, cudaStream_t stream,
                 bool parzen = false) {
  if (int rc = check(o)) return rc;
  const Shape& op = o.sh;
  const dim3 grid(
      static_cast<unsigned>((op.R + APPLY_ROWS - 1) / APPLY_ROWS) * op.W);
  auto* out4 = reinterpret_cast<float4*>(out);
  if (parzen)
    apply_kernel<false, false, true><<<grid, THREADS, 0, stream>>>(
        OPERAND_ARGS(o), gates, inv_denom, lr_ptr, lr_value, out4, 0, 0.f);
  else if (o.scales)
    apply_kernel<true, false><<<grid, THREADS, 0, stream>>>(
        OPERAND_ARGS(o), gates, inv_denom, lr_ptr, lr_value, out4, elastic,
        alpha);
  else if (o.mask)
    apply_kernel<false, true><<<grid, THREADS, 0, stream>>>(
        OPERAND_ARGS(o), gates, inv_denom, lr_ptr, lr_value, out4, elastic,
        alpha);
  else
    apply_kernel<false, false><<<grid, THREADS, 0, stream>>>(
        OPERAND_ARGS(o), gates, inv_denom, lr_ptr, lr_value, out4, elastic,
        alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gossip_reduce_rows_per_block() { return REDUCE_ROWS; }

int gossip_max_externals() { return MAX_P; }

const char* gossip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B1r.  w, dw (W, R, LANE); ext (W, P, R, LANE) f32, or int8 with scales
// (W, P, R / block_rows); the partition is rows [r0, r1).
int gossip_reduce_w_resident(const float* w, const float* dw, const void* ext,
                             const float* scales, float* partials,
                             float* acc, int W, int P, long long R, int r0,
                             int r1, int block_rows, int ext_int8,
                             cudaStream_t stream) {
  return launch_reduce(operands(w, dw, ext, ext_int8 ? scales : nullptr,
                                nullptr, W, P, R, r0, r1, block_rows),
                       partials, acc, stream);
}

// B1a.  gates (W, P), inv_denom (W,), lr (1,) f32 — all on the device.
int gossip_apply_w_resident(const float* w, const float* dw, const void* ext,
                            const float* scales, const float* gates,
                            const float* inv_denom, const float* lr,
                            float* out, int W, int P, long long R, int r0,
                            int r1, int block_rows, int ext_int8, int elastic,
                            float elastic_alpha, cudaStream_t stream) {
  return launch_apply(operands(w, dw, ext, ext_int8 ? scales : nullptr,
                               nullptr, W, P, R, r0, r1, block_rows),
                      gates, inv_denom, lr, 0.f, out, elastic, elastic_alpha,
                      stream);
}

// B2r.  w, dw (W, R, LANE); ext (W, P, R, LANE) f32; mask (R, LANE) or null.
int gossip_reduce_w(const float* w, const float* dw, const float* ext,
                    const float* mask, float* partials, float* acc, int W,
                    int P, long long R, cudaStream_t stream) {
  return launch_reduce(operands(w, dw, ext, nullptr, mask, W, P, R, 0, R, 1),
                       partials, acc, stream);
}

// B2a.  gates (W, P), inv_denom (W,) on the device; eps static.
int gossip_apply_w(const float* w, const float* dw, const float* ext,
                   const float* gates, const float* inv_denom,
                   const float* mask, float* out, int W, int P, long long R,
                   float eps, int elastic, float elastic_alpha,
                   cudaStream_t stream) {
  return launch_apply(operands(w, dw, ext, nullptr, mask, W, P, R, 0, R, 1),
                      gates, inv_denom, nullptr, eps, out, elastic,
                      elastic_alpha, stream);
}

// B3r.  w, dw (R, LANE); ext (P, R, LANE); acc (P, 3).
int gossip_reduce(const float* w, const float* dw, const float* ext,
                  float* partials, float* acc, int P, long long R,
                  cudaStream_t stream) {
  return launch_reduce(operands(w, dw, ext, nullptr, nullptr, 1, P, R, 0, R,
                                1),
                       partials, acc, stream);
}

// B3a.  gates (P,), inv_denom (1,) on the device; eps static.
int gossip_apply(const float* w, const float* dw, const float* ext,
                 const float* gates, const float* inv_denom, float* out,
                 int P, long long R, float eps, int elastic,
                 float elastic_alpha, cudaStream_t stream) {
  return launch_apply(operands(w, dw, ext, nullptr, nullptr, 1, P, R, 0, R,
                               1),
                      gates, inv_denom, nullptr, eps, out, elastic,
                      elastic_alpha, stream);
}

// B6r.  w, ext, dw (R, LANE); acc (3,) = [<dw, w - ext>, ||dw||^2,
// ||ext||^2], the TPU kernel's order.
int parzen_reduce(const float* w, const float* ext, const float* dw,
                  float* partials, float* acc, long long R,
                  cudaStream_t stream) {
  return launch_reduce(operands(w, dw, ext, nullptr, nullptr, 1, 1, R, 0, R,
                                1),
                       partials, acc, stream, 1);
}

// B6a.  gate (1,) on the device; eps static.
int parzen_apply(const float* w, const float* ext, const float* dw,
                 const float* gate, float* out, long long R, float eps,
                 cudaStream_t stream) {
  return launch_apply(operands(w, dw, ext, nullptr, nullptr, 1, 1, R, 0, R,
                               1),
                      gate, gate, nullptr, eps, out, 0, 0.f, stream, true);
}

}  // extern "C"
