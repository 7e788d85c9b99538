// Mamba-2 chunked SSD scan (state-space duality, arXiv:2405.21060) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel ssd_scan_pallas
// (src/repro/kernels/ssd_scan/kernel.py:85) -> ssd_scan (B5).
//
// For batch row b, head h and chunk c of Q steps, with L the cumulative
// log-decay L_i = sum_{j<=i} dt_j * A and xdt = x * dt:
//   y_i  = sum_{j<=i} (C_i . B_j) exp(L_i - L_j) xdt_j + exp(L_i) C_i . h
//   h   <- exp(L_Q) h + sum_j exp(L_Q - L_j) B_j (x) xdt_j
// with h (N, P) zero before the first chunk; every exponent is clipped to
// [-60, 0], as on the TPU.  Emits y and the final h.  Layout (the model's,
// no transposes): x, y (Bb, S, H, P); dt (Bb, S, H); A (Bb, H); B, C
// (Bb, S, N) read by every head of row b (head stride 0 — the reference's
// ops.py broadcasts them per head first); h (Bb, H, N, P); all f32.
// S % Q == 0 (ops.py pads with dt = 0 rows); Q <= 128, N <= 128, any P.
//
// Bound: per (b, h, chunk) the function needs about Q^2 N (C.B^T, lower
// triangle, once per b: the heads share it) + Q^2 P (the triangle times
// xdt) + 4 Q N P (C.h and the state update) operations against the bytes
// of x, y, dt, B, C once: at the mamba2-370m serve shape (Bb 4, S 2048,
// H 32, P 64, N 128, Q 128) 10.9 GFLOP against 0.148 GB, ~74 operations
// per byte, nearly four times the card's f32 ridge — f32 operations bound
// it.  Design:
//   - no sequential grid: the TPU carries h in VMEM across an ordered chunk
//     axis; here one block owns (b, h, P-tile) and walks the chunks in a
//     loop, h resident in shared memory;
//   - split over P: column p of y and h needs column p of x and h only, so
//     a grid of (Bb H) x (P / 64) blocks is exact.  The tile is 64 wide:
//     at P = 64 a narrower tile would recompute C.B^T per tile and, at one
//     block per SM (the shared memory below), run in two waves;
//   - shared memory (Q = N = 128, tile 64: 215,552 bytes of the 232,448 a
//     block may use): B^T and C^T (N x Q, rows padded to an odd stride
//     against bank conflicts), xdt (Q x 64), h (N x 64), and gamma tiled
//     by 32 rows (32 x Q) — the whole Q x Q gamma would not fit;
//   - the cumulative log-decay is a warp prefix sum (the TPU forms it as a
//     tril matmul): sums in another order, hence a tolerance, not bitwise;
//   - gamma skips the 32-column blocks above the diagonal;
//   - dot products use explicit fused multiply-adds (the library is built
//     with -fmad=false, so nothing else is contracted);
//   - every output has one writer, no atomics: bitwise repeatable.
// A SIMT kernel: tensor cores, cp.async/TMA staging and sharing C.B^T
// across the heads of a row are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 512;               // threads per block
constexpr int NWARP = NT / 32;        // 16
constexpr int MAX_Q = 128;            // chunk
constexpr int MAX_N = 128;            // state size
constexpr int PT = 64;                // P-tile width
constexpr int RB = 32;                // gamma rows per row block
constexpr int MI = RB / NWARP;        // rows per warp in a row block
constexpr int MP = PT / 32;           // P columns per lane
constexpr int MN = MAX_N / NWARP;     // state rows per warp
constexpr float CLIP = -60.f;

__device__ __forceinline__ float decay(float v) {
  return expf(fminf(fmaxf(v, CLIP), 0.f));
}

// Warp 0: L[i] = sum_{j<=i} dt_j * a (lane-serial runs, then a shuffle
// scan of the run totals), EL[i] = exp(clip(L_i)), WJ[j] = exp(clip(L_Q -
// L_j)).
__device__ void chunk_decay(const float* DT, float a, int Q, float* L,
                            float* EL, float* WJ) {
  const int lane = threadIdx.x & 31;
  const int per = (Q + 31) / 32;      // <= 4
  const int j0 = lane * per;
  float v[MAX_Q / 32];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k) {
    if (k < per && j0 + k < Q) run += DT[j0 + k] * a;
    v[k] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k)
    if (k < per && j0 + k < Q) L[j0 + k] = excl + v[k];
  __syncwarp();
  const float ltot = L[Q - 1];
  for (int j = lane; j < Q; j += 32) {
    EL[j] = decay(L[j]);
    WJ[j] = decay(ltot - L[j]);
  }
}

// gamma rows [i0, i0 + RB): G[i - i0][j] = (C_i . B_j) exp(L_i - L_j) for
// j <= i, else 0, for the KACT 32-column blocks left of the diagonal.
// Warp w owns rows i0 + w + NWARP r, lane l columns l + 32 k.
template <int KACT>
__device__ __forceinline__ void gamma_rows(const float* BT, const float* CT,
                                           const float* L, float* G, int i0,
                                           int Q, int QS, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ic[MI], jc[KACT];
  float acc[MI][KACT];
#pragma unroll
  for (int r = 0; r < MI; ++r) ic[r] = min(i0 + warp + NWARP * r, Q - 1);
#pragma unroll
  for (int k = 0; k < KACT; ++k) jc[k] = min(lane + 32 * k, Q - 1);
#pragma unroll
  for (int r = 0; r < MI; ++r)
#pragma unroll
    for (int k = 0; k < KACT; ++k) acc[r][k] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    const float* ct = CT + n * QS;
    const float* bt = BT + n * QS;
    float c[MI], b[KACT];
#pragma unroll
    for (int r = 0; r < MI; ++r) c[r] = ct[ic[r]];
#pragma unroll
    for (int k = 0; k < KACT; ++k) b[k] = bt[jc[k]];
#pragma unroll
    for (int r = 0; r < MI; ++r)
#pragma unroll
      for (int k = 0; k < KACT; ++k) acc[r][k] = fmaf(c[r], b[k], acc[r][k]);
  }
#pragma unroll
  for (int r = 0; r < MI; ++r) {
    const int i = i0 + warp + NWARP * r;
    if (i >= Q) continue;
#pragma unroll
    for (int k = 0; k < KACT; ++k) {
      const int j = lane + 32 * k;
      if (j < Q)
        G[(i - i0) * Q + j] = j <= i ? acc[r][k] * decay(L[i] - L[j]) : 0.f;
    }
  }
}

// y rows [i0, i0 + RB) of this P-tile: sum_{j<jmax} G[i][j] xdt[j][p] +
// EL[i] * sum_n C[i][n] h[n][p].  Warp w owns rows i0 + w + NWARP r, lane
// l columns l + 32 m.
__device__ __forceinline__ void y_rows(const float* G, const float* X,
                                       const float* CT, const float* Hs,
                                       const float* EL, float* __restrict__ y,
                                       long long row0, long long row_stride,
                                       int i0, int jmax, int Q, int QS, int N,
                                       int pw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int gr[MI], ic[MI], pc[MP];
  float intra[MI][MP], inter[MI][MP];
#pragma unroll
  for (int r = 0; r < MI; ++r) {
    gr[r] = (warp + NWARP * r) * Q;
    ic[r] = min(i0 + warp + NWARP * r, Q - 1);
  }
#pragma unroll
  for (int m = 0; m < MP; ++m) pc[m] = min(lane + 32 * m, pw - 1);
#pragma unroll
  for (int r = 0; r < MI; ++r)
#pragma unroll
    for (int m = 0; m < MP; ++m) intra[r][m] = inter[r][m] = 0.f;
#pragma unroll 4
  for (int j = 0; j < jmax; ++j) {
    float g[MI], xv[MP];
#pragma unroll
    for (int r = 0; r < MI; ++r) g[r] = G[gr[r] + j];
#pragma unroll
    for (int m = 0; m < MP; ++m) xv[m] = X[j * pw + pc[m]];
#pragma unroll
    for (int r = 0; r < MI; ++r)
#pragma unroll
      for (int m = 0; m < MP; ++m)
        intra[r][m] = fmaf(g[r], xv[m], intra[r][m]);
  }
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float c[MI], hv[MP];
#pragma unroll
    for (int r = 0; r < MI; ++r) c[r] = CT[n * QS + ic[r]];
#pragma unroll
    for (int m = 0; m < MP; ++m) hv[m] = Hs[n * pw + pc[m]];
#pragma unroll
    for (int r = 0; r < MI; ++r)
#pragma unroll
      for (int m = 0; m < MP; ++m)
        inter[r][m] = fmaf(c[r], hv[m], inter[r][m]);
  }
#pragma unroll
  for (int r = 0; r < MI; ++r) {
    const int i = i0 + warp + NWARP * r;
    if (i >= Q) continue;
#pragma unroll
    for (int m = 0; m < MP; ++m) {
      const int p = lane + 32 * m;
      if (p < pw)
        y[row0 + i * row_stride + p] = intra[r][m] + EL[i] * inter[r][m];
    }
  }
}

// h <- exp(clip(L_Q)) h + sum_j (B_j * WJ[j]) (x) xdt_j, in place: each
// (n, p) entry has one owner, which alone reads and writes it.  Warp w owns
// state rows w + NWARP k, lane l columns l + 32 m.
__device__ __forceinline__ void state_update(const float* BT, const float* X,
                                             const float* L, const float* WJ,
                                             float* Hs, int Q, int QS, int N,
                                             int pw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nc[MN], pc[MP];
  float acc[MN][MP];
#pragma unroll
  for (int k = 0; k < MN; ++k) nc[k] = min(warp + NWARP * k, N - 1) * QS;
#pragma unroll
  for (int m = 0; m < MP; ++m) pc[m] = min(lane + 32 * m, pw - 1);
#pragma unroll
  for (int k = 0; k < MN; ++k)
#pragma unroll
    for (int m = 0; m < MP; ++m) acc[k][m] = 0.f;
#pragma unroll 2
  for (int j = 0; j < Q; ++j) {
    const float wj = WJ[j];
    float xv[MP];
#pragma unroll
    for (int m = 0; m < MP; ++m) xv[m] = X[j * pw + pc[m]];
#pragma unroll
    for (int k = 0; k < MN; ++k) {
      const float b = BT[nc[k] + j] * wj;
#pragma unroll
      for (int m = 0; m < MP; ++m) acc[k][m] = fmaf(b, xv[m], acc[k][m]);
    }
  }
  const float etot = decay(L[Q - 1]);
#pragma unroll
  for (int k = 0; k < MN; ++k) {
    const int n = warp + NWARP * k;
    if (n >= N) continue;
#pragma unroll
    for (int m = 0; m < MP; ++m) {
      const int p = lane + 32 * m;
      if (p < pw) Hs[n * pw + p] = etot * Hs[n * pw + p] + acc[k][m];
    }
  }
}

size_t smem_bytes(int Q, int N) {
  const int QS = Q | 1;
  return sizeof(float) *
         (2 * static_cast<size_t>(N) * QS + static_cast<size_t>(Q) * PT +
          static_cast<size_t>(N) * PT + RB * Q + 4 * Q);
}

// Grid (Bb H, ceil(P / PT)), NT threads, smem_bytes(Q, N) of dynamic
// shared memory.
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ hout, int S, int H, int P, int N, int Q) {
  extern __shared__ float sm[];
  const int QS = Q | 1;               // odd row stride: no bank conflicts
  const int t = threadIdx.x, warp = t >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H, hh = bh - b * H;
  const int p0 = blockIdx.y * PT;
  const int pw = min(PT, P - p0);     // this tile's width

  float* BT = sm;                     // (N, QS): B^T of the chunk
  float* CT = BT + N * QS;            // (N, QS): C^T
  float* X = CT + N * QS;             // (Q, pw): xdt
  float* Hs = X + Q * PT;             // (N, pw): the state
  float* G = Hs + N * PT;             // (RB, Q): gamma rows
  float* L = G + RB * Q;              // (Q): cumulative log-decay
  float* EL = L + Q;                  // (Q): exp(clip(L_i))
  float* WJ = EL + Q;                 // (Q): exp(clip(L_Q - L_j))
  float* DT = WJ + Q;                 // (Q): dt of the chunk

  const float a = A[bh];
  for (int e = t; e < N * pw; e += NT) Hs[e] = 0.f;

  const long long xrow = static_cast<long long>(H) * P;   // x/y step stride
  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();                  // the last chunk's readers are done
    const long long srow = static_cast<long long>(b) * S + s0;
    for (int j = t; j < Q; j += NT) DT[j] = dt[(srow + j) * H + hh];
    const float* bg = Bm + srow * N;
    const float* cg = Cm + srow * N;
    for (int e = t; e < Q * N; e += NT) {
      const int j = e / N, n = e - j * N;
      BT[n * QS + j] = bg[e];
      CT[n * QS + j] = cg[e];
    }
    __syncthreads();
    const float* xg = x + srow * xrow + static_cast<long long>(hh) * P + p0;
    for (int e = t; e < Q * pw; e += NT) {
      const int j = e / pw, p = e - j * pw;
      X[e] = xg[j * xrow + p] * DT[j];
    }
    if (warp == 0) chunk_decay(DT, a, Q, L, EL, WJ);
    __syncthreads();

    const long long y0 = srow * xrow + static_cast<long long>(hh) * P + p0;
    for (int i0 = 0; i0 < Q; i0 += RB) {
      const int jmax = min(i0 + RB, Q);
      switch ((jmax + 31) / 32) {
        case 1: gamma_rows<1>(BT, CT, L, G, i0, Q, QS, N); break;
        case 2: gamma_rows<2>(BT, CT, L, G, i0, Q, QS, N); break;
        case 3: gamma_rows<3>(BT, CT, L, G, i0, Q, QS, N); break;
        default: gamma_rows<4>(BT, CT, L, G, i0, Q, QS, N); break;
      }
      __syncthreads();
      y_rows(G, X, CT, Hs, EL, y, y0, xrow, i0, jmax, Q, QS, N, pw);
      __syncthreads();                // G is rewritten by the next rows
    }
    state_update(BT, X, L, WJ, Hs, Q, QS, N, pw);
  }
  __syncthreads();
  float* hg = hout + static_cast<long long>(bh) * N * P + p0;
  for (int e = t; e < N * pw; e += NT) {
    const int n = e / pw, p = e - n * pw;
    hg[static_cast<long long>(n) * P + p] = Hs[e];
  }
}

}  // namespace

extern "C" {

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ssd_max_chunk() { return MAX_Q; }

int ssd_max_state() { return MAX_N; }

// B5.  x (Bb, S, H, P), dt (Bb, S, H), A (Bb, H), B and C (Bb, S, N) in;
// y (Bb, S, H, P), h (Bb, H, N, P) out; all f32, contiguous.  S % Q == 0,
// 1 <= Q <= ssd_max_chunk(), 1 <= N <= ssd_max_state().  Launches on
// ``stream``; returns the launch's cudaError_t.
int ssd_scan(const float* x, const float* dt, const float* A, const float* B,
             const float* C, float* y, float* h, int Bb, int S, int H, int P,
             int N, int Q, cudaStream_t stream) {
  if (Bb < 1 || H < 1 || P < 1 || N < 1 || N > MAX_N || Q < 1 ||
      Q > MAX_Q || S < Q || S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Q, N);
  cudaError_t rc = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(Bb * H, (P + PT - 1) / PT);
  ssd_scan_kernel<<<grid, NT, smem, stream>>>(x, dt, A, B, C, y, h, S, H, P,
                                              N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
