// Backward of the Mamba-2 chunked SSD scan (B5b) for Hopper, sm_90a: the
// gradients of B5 (ssd_scan.cu) in four launches of f32 SIMT arithmetic.
//
// The reference has no backward kernel: it trains by jax.grad of its jnp
// chunked form (src/repro/models/ssm.py:67 ssd_chunked).  This computes that
// gradient, in the stages of Mamba-2's own GPU backward (arXiv:2405.21060
// §7: a reverse state pass, then chunk-parallel products).  For batch row
// b, head h and chunk c of Q steps, with L the cumulative log-decay, xdt =
// x * dt, E(v) = exp(clip(v, -60, 0)) and dh_c the adjoint of the state
// after chunk c (dh of the last chunk: d h_final):
//   dh_{c-1} = E(L_Q) dh_c + sum_i E(L_i) C_i (x) dy_i
//   dxdt_j   = sum_{i>=j} (C_i.B_j) E(L_i - L_j) dy_i + E(L_Q - L_j) B_j.dh_c
//   dC_i     = sum_h [sum_{j<=i} E(L_i - L_j) (dy_i.xdt_j) B_j
//                     + E(L_i) h_prev dy_i]
//   dB_j     = sum_h [sum_{i>=j} E(L_i - L_j) (dy_i.xdt_j) C_i
//                     + E(L_Q - L_j) dh_c xdt_j]
// and every exponent's weight goes into dL, + at its row index and - at its
// column index, times E'(v): exp(v) strictly inside [-60, 0], 0 outside,
// half of exp(v) at exactly -60 or 0 (jax.grad splits a tie of jnp.clip's
// max and min; ref.py ddecay).  The diagonal exponents (L_i - L_i, L_Q -
// L_{Q-1}) are ties whose halves cancel and are left out.  Then dL runs
// backward through the in-chunk cumulative sum to d(dt A): ddt = dxdt.x +
// d(dt A) A, dA[b, h] = sum_s d(dt A) dt, dx = dxdt dt.
//
// Layout: B5's (x, dy, dx (Bb, S, H, P); dt, ddt (Bb, S, H); A, dA (Bb, H);
// B, C, dB, dC (Bb, S, N); dh_final (Bb, H, N, P)); x, B and C read at
// their row strides as B5 reads them, every output contiguous.  It reads
// what B5's forward left in its workspace: C.B^T (Bb, nc, Qp, Qp), L (Bb,
// nc, H, Qp) and h_prev (Bb, nc, H, N, P), Qp = Q rounded up to 32.
//
// Stages, one launch each:
//   1 walk   (b h, P-tile)       chunks in reverse, dh in registers: writes
//                                dh_c of every chunk and <dh_c, h_prev_c>
//                                (E(L_Q)'s weight) per P-tile
//   2 dx     (b nc H)            dxdt = (C.B^T o E o tril)^T dy + E(L_Q -
//                                L_j) B dh_c: dx and dxdt.x
//   3 bc     (b nc, 2 Qp / 32)   a 32-row band of dC (first half) or dB
//                                (second half), the heads walked in order:
//                                dy_i.xdt_j of the band, h_prev dy_i or dh_c
//                                xdt_j, their terms of dL, then the band's
//                                sum over the other rows
//   4 final  (b h)               dL per position from stage 1's and 3's
//                                terms, the reverse cumulative sum, ddt, dA
//
// Bound: per (b, c, h) the state walk, B.dh_c, dy_i.xdt_j over the triangle
// and its product with dy, h_prev dy and dh_c xdt; per (b, c) the two
// triangle sums over B and C.  At the mamba2-370m training shape (Bb 8, S
// 512, H 32, P 64, N 128, Q 128) that is 9.82 GFLOP against 0.118 GB of
// operands: 83 operations a byte, over the f32 ridge (67 TFLOP/s over 3.35
// TB/s: 20), so f32 SIMT bounds it at 0.147 ms (the bytes: 0.035 ms).
// This first version is SIMT register tiles staged through shared memory:
// it forms the triangle's dy_i.xdt_j twice (the dB band by columns, the dC
// band by rows), multiplies stage 2's masked upper half, and stages every
// head's operands once per band; tensor cores (split TF32, as B5) are the
// next step.  Products by explicit fmaf (the build's -fmad=false forbids
// only the compiler's own contraction).
//
// Reductions: every output has one writer; a sum across threads runs in a
// fixed tree (warp shuffles at fixed offsets, or one thread in order) and
// across blocks through ordered partials that stage 4 adds in order: no
// atomics, bitwise repeatable run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace {

constexpr int NT = 256;               // threads a block, 8 warps
constexpr int MAX_Q = 128;
constexpr int MAX_N = 128;
constexpr int PT = 64;                // P-tile of stages 1 and 2
constexpr int BAND = 32;              // rows of a stage-3 band
constexpr float CLIP = -60.f;

__host__ __device__ constexpr int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

__device__ __forceinline__ float decay(float v) {
  return expf(fminf(fmaxf(v, CLIP), 0.f));
}

// d decay(v) / dv as jax.grad takes it (see the head of this file).
__device__ __forceinline__ float ddecay(float v) {
  if (v > 0.f || v < CLIP) return 0.f;
  const float e = expf(v);
  return (v == 0.f || v == CLIP) ? 0.5f * e : e;
}

// Sum over the 2^k lanes that differ in the low k bits of the lane index,
// at fixed offsets: every such lane gets the same, reproducible sum.
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off >= 1; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Stage 1, grid (Bb H, ceil(P / PT)): one head and P-tile walks the chunks
// from the last, its adjoint dh (N x P-tile) in registers (thread: rows tn +
// 16 r, columns tp + 16 q).  Per chunk c: dh (= dh_c) to dH; <dh_c,
// h_prev_c> over the tile, a fixed tree, to q1[(b nc + c) H + h][tile];
// then dh <- E(L_Q) dh + sum_i (E(L_i) C_i) (x) dy_i.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
walk_bwd(const float* __restrict__ dy, const float* __restrict__ Cm,
         const float* __restrict__ Lg, const float* __restrict__ st,
         const float* __restrict__ dhf, float* __restrict__ dH,
         float* __restrict__ q1, int S, int H, int P, int N, int Q, int nc,
         long long bc_row) {
  extern __shared__ float sm[];
  const int Qp = round_up(Q, 32);
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int p0 = blockIdx.y * PT, pw = min(PT, P - p0);
  const int tn = threadIdx.x >> 4, tp = threadIdx.x & 15;
  float* Cs = sm;                     // (Q, N): E(L_i) C_i
  float* Ys = Cs + Q * N;             // (Q, PT): dy of the tile
  float* red = Ys + Q * PT;           // (NT / 32) warp sums
  float acc[8][4];
  const long long hoff = static_cast<long long>(bh) * N * P;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = tn + 16 * r, p = tp + 16 * q;
      acc[r][q] = (dhf && n < N && p < pw) ? dhf[hoff + n * P + p0 + p] : 0.f;
    }
  for (int c = nc - 1; c >= 0; --c) {
    const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
    const float* L = Lg + bch * Qp;
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = tn + 16 * r, p = tp + 16 * q;
        if (n < N && p < pw) {
          const long long o = bch * N * P + n * P + p0 + p;
          dH[o] = acc[r][q];
          part = fmaf(acc[r][q], st[o], part);
        }
      }
    part = group_sum<32>(part);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < NT / 32; ++w) s += red[w];
      q1[bch * gridDim.y + blockIdx.y] = s;
    }
    if (c == 0) break;                // dh before chunk 0 is not needed
    const long long row0 = static_cast<long long>(b) * S +
                           static_cast<long long>(c) * Q;
    for (int e = threadIdx.x; e < Q * N; e += NT) {
      const int i = e / N, n = e - i * N;
      Cs[e] = Cm[(row0 + i) * bc_row + n] * decay(L[i]);
    }
    for (int e = threadIdx.x; e < Q * PT; e += NT) {
      const int i = e / PT, p = e - i * PT;
      Ys[e] = p < pw ? dy[((row0 + i) * H + h) * P + p0 + p] : 0.f;
    }
    __syncthreads();
    const float dec = decay(L[Q - 1]);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] *= dec;
    for (int i = 0; i < Q; ++i) {
      float cv[8], yv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int n = tn + 16 * r;
        cv[r] = n < N ? Cs[i * N + n] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) yv[q] = Ys[i * PT + tp + 16 * q];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], yv[q], acc[r][q]);
    }
    __syncthreads();                  // Cs, Ys and red are refilled
  }
}

// ---------------------------------------------------------------------------
// Stage 2, grid (Bb nc H): dxdt of one (b, c, h), P-tile by P-tile (thread:
// rows j = tj + 16 r, columns tp + 16 q): Ws = C.B^T o E(L_i - L_j) o tril
// once, then dxdt = Ws^T dy; Bs, Ds <- B, dh_c; dxdt += E(L_Q - L_j) B dh_c.
// Writes dx = dxdt dt and ddt[j] = sum_p dxdt x (stage 4 adds the rest).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
dx_bwd(const float* __restrict__ x, const float* __restrict__ dt,
       const float* __restrict__ Bm, const float* __restrict__ cb,
       const float* __restrict__ Lg, const float* __restrict__ dH,
       const float* __restrict__ dy, float* __restrict__ dx,
       float* __restrict__ ddt, int S, int H, int P, int N, int Q, int nc,
       long long x_row, long long bc_row) {
  extern __shared__ float sm[];
  const int Qp = round_up(Q, 32);
  const long long bch = blockIdx.x;               // (b nc + c) H + h
  const int h = static_cast<int>(bch % H);
  const long long bc = bch / H;
  const int b = static_cast<int>(bc / nc), c = static_cast<int>(bc % nc);
  const long long row0 = static_cast<long long>(b) * S +
                         static_cast<long long>(c) * Q;
  const int tj = threadIdx.x >> 4, tp = threadIdx.x & 15;
  const int big = max(Q * Qp, Q * N);
  float* Ws = sm;                     // (Q, Qp) gamma, then (Q, N) B
  float* Ys = Ws + big;               // (Q, PT) dy, then (N, PT) dh_c
  float* Ls = Ys + max(Q, N) * PT;    // (Qp) L
  float* Dts = Ls + Qp;               // (Q) dt
  float* Xd = Dts + Q;                // (Q) sum_p dxdt x, over the tiles
  const float* L = Lg + bch * Qp;
  for (int j = threadIdx.x; j < Q; j += NT) {
    Ls[j] = L[j];
    Dts[j] = dt[(row0 + j) * H + h];
    Xd[j] = 0.f;
  }
  __syncthreads();
  const float* cbg = cb + bc * Qp * Qp;
  for (int e = threadIdx.x; e < Q * Qp; e += NT) {
    const int i = e / Qp, j = e - i * Qp;
    Ws[e] = (j <= i) ? cbg[i * Qp + j] * decay(Ls[i] - Ls[j]) : 0.f;
  }
  const float lq = Ls[Q - 1];
  for (int p0 = 0; p0 < P; p0 += PT) {
    const int pw = min(PT, P - p0);
    for (int e = threadIdx.x; e < Q * PT; e += NT) {
      const int i = e / PT, p = e - i * PT;
      Ys[e] = p < pw ? dy[((row0 + i) * H + h) * P + p0 + p] : 0.f;
    }
    __syncthreads();
    float acc[8][4] = {}, bd[8][4] = {};
    for (int i = 0; i < Q; ++i) {
      float wv[8], yv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = tj + 16 * r;
        wv[r] = j < Q ? Ws[i * Qp + j] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) yv[q] = Ys[i * PT + tp + 16 * q];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wv[r], yv[q], acc[r][q]);
    }
    __syncthreads();                  // Ws and Ys are refilled with B, dh_c
    float* Bs = Ws;                   // gamma is rebuilt for the next tile
    for (int e = threadIdx.x; e < Q * N; e += NT) {
      const int j = e / N, n = e - j * N;
      Bs[e] = Bm[(row0 + j) * bc_row + n];
    }
    for (int e = threadIdx.x; e < N * PT; e += NT) {
      const int n = e / PT, p = e - n * PT;
      Ys[e] = p < pw ? dH[bch * N * P + n * P + p0 + p] : 0.f;
    }
    __syncthreads();
    for (int n = 0; n < N; ++n) {
      float bv[8], hv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = tj + 16 * r;
        bv[r] = j < Q ? Bs[j * N + n] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) hv[q] = Ys[n * PT + tp + 16 * q];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) bd[r][q] = fmaf(bv[r], hv[q], bd[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = tj + 16 * r;
      float xs = 0.f;
      if (j < Q) {
        const float sd = decay(lq - Ls[j]), d = Dts[j];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tp + 16 * q;
          if (p < pw) {
            const float g = acc[r][q] + sd * bd[r][q];
            dx[((row0 + j) * H + h) * P + p0 + p] = g * d;
            xs = fmaf(g, x[(row0 + j) * x_row + h * P + p0 + p], xs);
          }
        }
      }
      // the 16 lanes of one row j sit in one half-warp
      xs = group_sum<16>(xs);
      if (tp == 0 && j < Q) Xd[j] += xs;
    }
    __syncthreads();
    if (p0 + PT < P) {                // restore gamma for the next tile
      for (int e = threadIdx.x; e < Q * Qp; e += NT) {
        const int i = e / Qp, j = e - i * Qp;
        Ws[e] = (j <= i) ? cbg[i * Qp + j] * decay(Ls[i] - Ls[j]) : 0.f;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < Q; j += NT) ddt[(row0 + j) * H + h] = Xd[j];
}

// ---------------------------------------------------------------------------
// Stage 3, grid (Bb nc, 2 Qp / 32).  Block z < Qp / 32 owns the dC rows i of
// band [32 z, +32); block z >= Qp / 32 the dB rows j of band z - Qp / 32.
// With "band" rows a and "other" rows o (o <= a for dC, o >= a for dB), per
// head in order:
//   G[a][o] = dy_i . xdt_j  (i, j the row and column of the pair)
//   Dcb[a][o] += E(L_i - L_j) G             (registers, summed over heads)
//   dv = (C.B^T)_ij G E'(L_i - L_j), i > j  its sum over o: + to dL_i (dC),
//                                           - to dL_j (dB)
//   U[a][n] = sum_p M[n][p] Z[a][p], M = h_prev (dC) or dh_c (dB), Z = dy
//   (dC) or xdt (dB); Acc[a][n] += s_a U with s_a = E(L_a) (dC) or E(L_Q -
//   L_a) (dB); g_a = K_a . U_a (K = C or B), weighted by E' of s_a's
//   exponent: + to dL_a (dC); for dB (a < Q - 1) - to dL_a and + to dL_{Q-1}
// Then out[a] = Acc[a] + sum_o Dcb[a][o] K'_o (K' = B for dC, C for dB).
// The band's dL terms go to T[(b nc + c) H + h][3][Qp]: row 0 the dC band's
// (+row sums + inter), row 1 the dB band's (-column sums - state), row 2 the
// state terms that stage 4 sums into dL_{Q-1}.
// Thread: band rows a = a0 + ta + 8 u (u < 4), other rows / state columns
// o = tl + 32 v (v < 4): ta the warp, tl the lane.
// ---------------------------------------------------------------------------
template <bool DB>
__device__ void bc_band(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ cb,
                        const float* __restrict__ Lg,
                        const float* __restrict__ st,
                        const float* __restrict__ dH,
                        const float* __restrict__ dy, float* __restrict__ out,
                        float* __restrict__ T, int S, int H, int P, int N,
                        int Q, int nc, long long x_row, long long bc_row,
                        int band) {
  extern __shared__ float sm[];
  const int Qp = round_up(Q, 32);
  const long long bc = blockIdx.x;                // b nc + c
  const int b = static_cast<int>(bc / nc), c = static_cast<int>(bc % nc);
  const long long row0 = static_cast<long long>(b) * S +
                         static_cast<long long>(c) * Q;
  const int a0 = BAND * band;
  if (a0 >= Q) return;
  // the other rows' range: [0, a0 + 32) for dC, [a0, Q) for dB
  const int o_lo = DB ? a0 : 0, o_hi = DB ? Q : min(Q, a0 + BAND);
  const int no = o_hi - o_lo;
  const int ta = threadIdx.x >> 5, tl = threadIdx.x & 31;
  const int ldo = no + 1, ldn = N + 1;
  float* Zb = sm;                     // (P, 33): band operand, transposed
  float* Zo = Zb + P * (BAND + 1);          // (P, no + 1): other operand, transp.
  float* Ms = Zo + P * ldo;           // (P, N + 1): state matrix, transp.
  float* Ks = Ms + P * ldn;           // (32, N): K rows of the band
  float* CBs = Ks + BAND * N;         // (32, no): C.B^T of the pairs
  float* Ls = CBs + BAND * no;        // (Qp): L of the head
  // after the head loop: Dcb (32, no) over Zb..., K' rows (no, N) over Ms
  const int kmax = MAX_Q / BAND;      // other-row tiles, at most 4
  float dcb[4][4] = {}, acc[4][4] = {};
  for (int e = threadIdx.x; e < BAND * N; e += NT) {
    const int a = e / N, n = e - a * N;
    Ks[e] = a0 + a < Q ? (DB ? Bm : Cm)[(row0 + a0 + a) * bc_row + n] : 0.f;
  }
  const float* cbg = cb + bc * Qp * Qp;
  for (int e = threadIdx.x; e < BAND * no; e += NT) {
    const int a = e / no, o = e - a * no;
    const int i = DB ? o_lo + o : a0 + a, j = DB ? a0 + a : o_lo + o;
    CBs[e] = (a0 + a < Q) ? cbg[i * Qp + j] : 0.f;
  }
  for (int h = 0; h < H; ++h) {
    const long long bch = bc * H + h;
    __syncthreads();                  // the previous head's tiles are read
    for (int e = threadIdx.x; e < Qp; e += NT) Ls[e] = Lg[bch * Qp + e];
    // Z rows r (r < 32 band, else other) of dy or xdt, transposed
    for (int e = threadIdx.x; e < (BAND + no) * P; e += NT) {
      const int rr = e / P, p = e - rr * P;
      const bool isb = rr < BAND;
      const int row = isb ? a0 + rr : o_lo + rr - BAND;
      float v = 0.f;
      if (row < Q) {
        const bool use_x = isb == DB;           // xdt: band of dB, other of dC
        v = use_x ? x[(row0 + row) * x_row + h * P + p] *
                        dt[(row0 + row) * H + h]
                  : dy[((row0 + row) * H + h) * P + p];
      }
      if (isb)
        Zb[p * (BAND + 1) + rr] = v;
      else
        Zo[p * ldo + rr - BAND] = v;
    }
    const float* Mg = (DB ? dH : st) + bch * N * P;
    for (int e = threadIdx.x; e < N * P; e += NT) {
      const int n = e / P, p = e - n * P;
      Ms[p * ldn + n] = Mg[e];
    }
    __syncthreads();
    float g[4][4] = {}, u[4][4] = {};
    for (int p = 0; p < P; ++p) {
      float zb[4], zo[4], ms[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) zb[k] = Zb[p * (BAND + 1) + ta + 8 * k];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int o = tl + 32 * v, n = tl + 32 * v;
        zo[v] = o < no ? Zo[p * ldo + o] : 0.f;
        ms[v] = n < N ? Ms[p * ldn + n] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          g[k][v] = fmaf(zb[k], zo[v], g[k][v]);
          u[k][v] = fmaf(zb[k], ms[v], u[k][v]);
        }
    }
    const float lq = Ls[Q - 1];
    float* Trow = T + bch * 3 * Qp;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int a = a0 + ta + 8 * k;
      const bool live = a < Q;
      const float la = live ? Ls[a] : 0.f;
      float dvs = 0.f;
#pragma unroll
      for (int v = 0; v < kmax; ++v) {
        const int o = tl + 32 * v, orow = o_lo + o;
        if (!live || o >= no) continue;
        const int i = DB ? orow : a, j = DB ? a : orow;
        if (i < j) continue;                        // outside the triangle
        const float vij = Ls[i] - Ls[j];
        dcb[k][v] = fmaf(decay(vij), g[k][v], dcb[k][v]);
        if (i > j)
          dvs = fmaf(CBs[(ta + 8 * k) * no + o] * g[k][v], ddecay(vij), dvs);
      }
      const float arg = DB ? lq - la : la;
      const float s = decay(arg);
      float gk = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int n = tl + 32 * v;
        if (!live || n >= N) continue;
        acc[k][v] = fmaf(s, u[k][v], acc[k][v]);
        gk = fmaf(Ks[(ta + 8 * k) * N + n], u[k][v], gk);
      }
      dvs = group_sum<32>(dvs);
      gk = group_sum<32>(gk);
      if (tl == 0 && live) {
        if (DB) {
          const float sj = a < Q - 1 ? ddecay(arg) * gk : 0.f;
          Trow[Qp + a] = -dvs - sj;
          Trow[2 * Qp + a] = sj;
        } else {
          Trow[a] = dvs + ddecay(arg) * gk;
        }
      }
    }
  }
  __syncthreads();                    // the head tiles are read: reuse them
  float* Dcb = Zb;                    // (32, no + 1)
  float* Kp = Ms;                     // (no, N): the other rows of K'
  // Dcb may run past Zb into Zo and Ms, which follow it; K' starts at the
  // later of Dcb's end and Ms
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int o = tl + 32 * v;
      if (o < no) Dcb[(ta + 8 * k) * ldo + o] = dcb[k][v];
    }
  __syncthreads();
  float* Kq = Dcb + BAND * ldo > Kp ? Dcb + BAND * ldo : Kp;
  for (int e = threadIdx.x; e < no * N; e += NT) {
    const int o = e / N, n = e - o * N;
    Kq[e] = (DB ? Cm : Bm)[(row0 + o_lo + o) * bc_row + n];
  }
  __syncthreads();
  for (int o = 0; o < no; ++o) {
    float dv[4], kv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) dv[k] = Dcb[(ta + 8 * k) * ldo + o];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = tl + 32 * v;
      kv[v] = n < N ? Kq[o * N + n] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[k][v] = fmaf(dv[k], kv[v], acc[k][v]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int a = a0 + ta + 8 * k;
    if (a >= Q) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = tl + 32 * v;
      if (n < N) out[(row0 + a) * N + n] = acc[k][v];
    }
  }
}

__global__ void __launch_bounds__(NT)
bc_bwd(const float* __restrict__ x, const float* __restrict__ dt,
       const float* __restrict__ Bm, const float* __restrict__ Cm,
       const float* __restrict__ cb, const float* __restrict__ Lg,
       const float* __restrict__ st, const float* __restrict__ dH,
       const float* __restrict__ dy, float* __restrict__ dB,
       float* __restrict__ dC, float* __restrict__ T, int S, int H, int P,
       int N, int Q, int nc, long long x_row, long long bc_row) {
  const int bands = round_up(Q, 32) / BAND;
  if (static_cast<int>(blockIdx.y) < bands)
    bc_band<false>(x, dt, Bm, Cm, cb, Lg, st, dH, dy, dC, T, S, H, P, N, Q,
                   nc, x_row, bc_row, blockIdx.y);
  else
    bc_band<true>(x, dt, Bm, Cm, cb, Lg, st, dH, dy, dB, T, S, H, P, N, Q,
                  nc, x_row, bc_row, blockIdx.y - bands);
}

// ---------------------------------------------------------------------------
// Stage 4, grid (Bb H): per chunk, dL_k = T0 + T1 (+ sum_{j<Q-1} T2_j +
// E'(L_Q) sum_tiles q1 at k = Q - 1), then in one thread, k from Q - 1
// down: d(dt A)_k = d(dt A)_{k+1} + dL_k, ddt_k += d(dt A)_k A, dA +=
// d(dt A)_k dt_k.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_Q)
final_bwd(const float* __restrict__ dt, const float* __restrict__ A,
          const float* __restrict__ Lg, const float* __restrict__ T,
          const float* __restrict__ q1, float* __restrict__ ddt,
          float* __restrict__ dA, int S, int H, int Q, int nc, int ptiles) {
  __shared__ float dL[MAX_Q], dts[MAX_Q], dd[MAX_Q];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int Qp = round_up(Q, 32);
  const float a = A[bh];
  float dA_acc = 0.f;
  for (int c = 0; c < nc; ++c) {
    const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
    const long long row0 = static_cast<long long>(b) * S +
                           static_cast<long long>(c) * Q;
    const float* Tr = T + bch * 3 * Qp;
    const int k = threadIdx.x;
    if (k < Q) {
      dL[k] = Tr[k] + Tr[Qp + k];
      dts[k] = dt[(row0 + k) * H + h];
      dd[k] = ddt[(row0 + k) * H + h];
    }
    __syncthreads();
    if (k == 0) {
      float s = 0.f;
      for (int j = 0; j < Q - 1; ++j) s += Tr[2 * Qp + j];
      float qs = 0.f;
      for (int t = 0; t < ptiles; ++t) qs += q1[bch * ptiles + t];
      dL[Q - 1] += s + ddecay(Lg[bch * Qp + Q - 1]) * qs;
      float run = 0.f;
      for (int j = Q - 1; j >= 0; --j) {
        run += dL[j];
        dd[j] = fmaf(run, a, dd[j]);
        dA_acc = fmaf(run, dts[j], dA_acc);
      }
    }
    __syncthreads();
    if (k < Q) ddt[(row0 + k) * H + h] = dd[k];
    __syncthreads();
  }
  if (threadIdx.x == 0) dA[bh] = dA_acc;
}

size_t smem_walk(int Q, int N) {
  return sizeof(float) * (static_cast<size_t>(Q) * N + Q * PT + NT / 32);
}

size_t smem_dx(int Q, int N) {
  const int Qp = round_up(Q, 32);
  const int big = Q * Qp > Q * N ? Q * Qp : Q * N, rows = Q > N ? Q : N;
  return sizeof(float) * (big + rows * PT + Qp + 2 * Q);
}

// stage 3's shared memory, at the widest band (dB's first: no = Q)
size_t smem_bc(int Q, int N, int P) {
  const int Qp = round_up(Q, 32), no = Q;
  const size_t heads = static_cast<size_t>(P) * (BAND + 1) +
                       static_cast<size_t>(P) * (no + 1) +
                       static_cast<size_t>(P) * (N + 1) + BAND * N +
                       BAND * no + Qp;
  // after the head loop: Dcb (32, no + 1) then K' (no, N) at the later of
  // Dcb's end and Ms
  const size_t ms = static_cast<size_t>(P) * (BAND + 1) +
                    static_cast<size_t>(P) * (no + 1);
  const size_t dcb_end = static_cast<size_t>(BAND) * (no + 1);
  const size_t tail = (dcb_end > ms ? dcb_end : ms) +
                      static_cast<size_t>(no) * N;
  return sizeof(float) * (heads > tail ? heads : tail);
}

}  // namespace

extern "C" {

const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Device launches of one ssd_scan_bwd call: the four stages.
int ssd_bwd_launches() { return 4; }

// Largest P the kernel takes (stage 3 stages a head's P columns whole).
int ssd_bwd_max_head_dim() { return 128; }

// Floats of ssd_scan_bwd's own workspace: dh_c of every chunk (Bb, nc, H,
// N, P), stage 3's dL terms (Bb, nc, H, 3, Qp) and stage 1's dot products
// (Bb, nc, H, ceil(P / 64)).
size_t ssd_bwd_workspace_floats(int Bb, int S, int H, int P, int N, int Q) {
  const size_t bnch = static_cast<size_t>(Bb) * (S / Q) * H;
  return bnch * (static_cast<size_t>(N) * P + 3 * round_up(Q, 32) +
                 (P + PT - 1) / PT);
}

// B5b.  x (Bb, S, H, P) at row stride x_row, dt (Bb, S, H), A (Bb, H), B
// and C (Bb, S, N) at row stride bc_row: the forward's operands; cb, L, st:
// the parts of the forward's workspace (ssd_workspace_parts); dy (Bb, S, H,
// P) and dhf (Bb, H, N, P, or null for zero) in; dx, ddt, dA, dB, dC out,
// contiguous, all f32; ``work`` holds ssd_bwd_workspace_floats(...) floats.
// S % Q == 0, 1 <= Q <= 128, 1 <= N <= 128, 1 <= P <= 128.  Launches the four
// stages on ``stream``; returns the first failed launch's cudaError_t, else 0.
int ssd_scan_bwd(const float* x, const float* dt, const float* A,
                 const float* B, const float* C, const float* cb,
                 const float* L, const float* st, const float* dy,
                 const float* dhf, float* dx, float* ddt, float* dA,
                 float* dB, float* dC, float* work, int Bb, int S, int H,
                 int P, int N, int Q, long long x_row, long long bc_row,
                 cudaStream_t stream) {
  if (Bb < 1 || H < 1 || P < 1 || P > 128 || N < 1 || N > MAX_N || Q < 1 ||
      Q > MAX_Q || S < Q || S % Q != 0 ||
      x_row < static_cast<long long>(H) * P || bc_row < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = S / Q, Qp = round_up(Q, 32), ptiles = (P + PT - 1) / PT;
  const long long bnch = static_cast<long long>(Bb) * nc * H;
  if (bnch > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  float* dH = work;
  float* T = dH + bnch * N * P;
  float* q1 = T + bnch * 3 * Qp;
  const size_t s1 = smem_walk(Q, N), s2 = smem_dx(Q, N),
               s3 = smem_bc(Q, N, P);
  cudaError_t rc;
  rc = cudaFuncSetAttribute(walk_bwd,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(s1));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(dx_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(s2));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(bc_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(s3));
  if (rc != cudaSuccess) return static_cast<int>(rc);

  walk_bwd<<<dim3(Bb * H, ptiles), NT, s1, stream>>>(
      dy, C, L, st, dhf, dH, q1, S, H, P, N, Q, nc, bc_row);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  dx_bwd<<<dim3(static_cast<unsigned>(bnch)), NT, s2, stream>>>(
      x, dt, B, cb, L, dH, dy, dx, ddt, S, H, P, N, Q, nc, x_row, bc_row);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  bc_bwd<<<dim3(static_cast<unsigned>(Bb * nc), 2 * (Qp / BAND)), NT, s3,
           stream>>>(x, dt, B, C, cb, L, st, dH, dy, dB, dC, T, S, H, P, N, Q,
                     nc, x_row, bc_row);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  final_bwd<<<dim3(Bb * H), MAX_Q, 0, stream>>>(dt, A, L, T, q1, ddt, dA, S,
                                                H, Q, nc, ptiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
