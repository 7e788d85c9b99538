// Backward of the Mamba-2 chunked SSD scan (B5b) for Hopper, sm_90a: the
// gradients of B5 (ssd_scan.cu) in four launches, the products of the two
// chunk-parallel stages on the tensor cores in split TF32, as B5's.
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
//   1 walk   (b h, P-tile)    chunks in reverse, dh in the warps' mma
//                             accumulators: writes dh_c of every chunk and
//                             <dh_c, h_prev_c> (E(L_Q)'s weight) per P-tile
//   2 head   (b nc, GH heads) per head in order, from one staging of its
//                             dy, xdt, dh_c and h_prev: G = dy xdt^T over
//                             the triangle once, with its dL terms and E o G
//                             added over the group; U_B = xdt dh_c^T and U_C
//                             = dy h_prev^T (Q x N) with their dL terms,
//                             E-scaled rows added over the group; dxdt =
//                             (C.B^T o E o tril)^T dy over the triangle + E
//                             B dh_c: dx and dxdt.x.  Writes the group's
//                             partial sums and each head's dL
//   3 finish (b nc, dB | dC, 64 columns of N)  the groups' partials added
//                             in order, then dC = Dcb B + U_C, dB = Dcb^T C
//                             + U_B over the triangle, once per (b, c)
//   4 final  (b h)            dL per position from stage 2's terms and
//                             stage 1's products, the reverse cumulative
//                             sum, ddt, dA
//
// Bound: per (b, c, h) the state walk, B.dh_c, dy_i.xdt_j over the triangle
// and its product with dy, h_prev dy and dh_c xdt; per (b, c) the two
// triangle sums over B and C.  At the mamba2-370m training shape (Bb 8, S
// 512, H 32, P 64, N 128, Q 128) that is 9.82 GFLOP against 0.118 GB of
// operands: 83 operations a byte, over the f32 ridge (67 TFLOP/s over 3.35
// TB/s: 20) and under the TF32 tensor cores' (148).  f32 SIMT would take
// 0.147 ms; the tensor cores in split TF32 (three TF32 products for each
// product) 0.0595 ms; the bytes 0.035 ms.
//
// Design:
//   - every product on mma.sync m16n8k8 in split TF32 (tf32_mma.cuh, B5's
//     helpers): f32 accuracy within ~2^-20 a product.  The exps, clips,
//     masks, dL's row and column sums, the reverse cumulative sum and dA's
//     sum stay f32 SIMT, in the fragment loads and the epilogues.  The
//     triangles are walked over their lower half only: G's 32 x 32 blocks
//     up to the diagonal (the diagonal block's upper 16 x 16 skipped),
//     dxdt's and stage 3's k-steps from or to each row tile's diagonal;
//   - stage 2 stages a head's four (Q or N) x P operands once into three
//     64-column slots (h_prev takes xdt's slot once G and U_B are done),
//     and B and C.B^T once per block; h_prev and the next head's dh_c land
//     while dxdt and U_C compute.  16 warps: each owns a 32 x 32 block of U,
//     a 32 x 16 block of dxdt (row tiles t and T - 1 - t) and a G unit (a
//     16-column half of a block below the diagonal, or a diagonal block);
//   - head groups: GH heads a block trade parallelism (Bb nc ceil(H / GH)
//     blocks, one an SM: 222 KB of shared memory) against the partials'
//     bytes ((2 Q N + Qp^2) floats a group, read back through L2 while the
//     group walks its heads, and once by stage 3).  At the training shape
//     GH 4 and 8 take the same time within the noise (GH 1: 15% more, its
//     stage 3 reading 8x the partials); 8 halves the partials to 25 MB;
//   - what bounds it, measured: stage 2's epilogues and staging, not the
//     tensor cores.  With every mma.sync replaced by an add, stage 2 takes
//     four fifths of its time; per head, each warp spends longer in G's,
//     U_B's and U_C's epilogues (the partials' read-add-write, C and x from
//     device memory, the exps and the dL sums) than in their products:
//     16 warps an SM (the shared memory holds one block) at the
//     128-register cap hide little latency, and all of them reach the same
//     phase together.  wgmma on pre-split operands in shared memory is the
//     route past it, as for B5;
//   - every output has one writer; a sum across threads runs in a fixed
//     tree (warp shuffles at fixed offsets, or one thread in order), a sum
//     across heads in head order, across groups in group order: no atomics,
//     bitwise repeatable run to run.  Products by explicit fmaf or mma (the
//     build's -fmad=false forbids only the compiler's own contraction).

#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace {

constexpr int NT = 512;               // threads a block, 16 warps
constexpr int NWARP = NT / 32;
constexpr int MAX_Q = 128;
constexpr int MAX_N = 128;
constexpr int PT = 64;                // P-tile of stages 1 and 2
constexpr int SLD = PT + 4;           // row stride of a stage-2 slot
constexpr int XLD = PT + 8;           // row stride of stage 1's dy tile
constexpr int SROWS = 128;            // rows of a slot: max(Q, N)
constexpr int GH = 8;                 // heads a stage-2 block walks
constexpr int FT = 64;                // N-columns of a stage-3 block
constexpr int KLD = FT + 8;           // row stride of stage 3's B or C
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

// Sum over the lanes that differ in the bits of the lane index from FIRST
// up to LAST (powers of two), at fixed offsets: every such lane gets the
// same, reproducible sum.
template <int FIRST, int LAST>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = LAST; off >= FIRST; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

#include "tf32_mma.cuh"

// One warp: acc[m][n] (16 x 8 tiles) += A[rows of tile m, k] . B[k, columns
// of tile n] over the k-steps [kb[m], ke[m]) of tile m and its column tiles
// n < nn[m]; split TF32 as warp_mma, whose fragment layout a(m, u, k) and
// b(k, c) follow (plain values).  The k-steps outside every tile's range
// are not visited.
template <int MT, int NB, class FA, class FB>
__device__ __forceinline__ void warp_mma_rng(float (&acc)[MT][NB][4],
                                             const FA& a, const FB& b,
                                             const int (&kb)[MT],
                                             const int (&ke)[MT],
                                             const int (&nn)[MT]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int k0 = kb[0], k1 = ke[0];
#pragma unroll
  for (int m = 1; m < MT; ++m) {
    k0 = min(k0, kb[m]);
    k1 = max(k1, ke[m]);
  }
#pragma unroll 2
  for (int ks = k0; ks < k1; ++ks) {
    const int k = 8 * ks + t;
    uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      split_tf32(b(k, 8 * n + g), bh[n][0], bl[n][0]);
      split_tf32(b(k + 4, 8 * n + g), bh[n][1], bl[n][1]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (ks < kb[m] || ks >= ke[m]) continue;
      uint32_t ah[4], al[4];
      split_tf32(a(m, 0, k), ah[0], al[0]);
      split_tf32(a(m, 1, k), ah[1], al[1]);
      split_tf32(a(m, 0, k + 4), ah[2], al[2]);
      split_tf32(a(m, 1, k + 4), ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (n >= nn[m]) continue;
        mma_tf32(acc[m][n], al, bh[n]);
        mma_tf32(acc[m][n], ah, bl[n]);
        mma_tf32(acc[m][n], ah, bh[n]);
      }
    }
  }
}

template <int MT, int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NB][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
}

// ---------------------------------------------------------------------------
// Stage 1, grid (Bb H, ceil(P / PT)), two blocks an SM: one head and P-tile
// walks the chunks from the last, its adjoint dh (N x P-tile) held in the
// warps' accumulators (warp w: state rows [32 (w / 4), +32), columns [16 (w
// % 4), +16)).  Per chunk c: dh (= dh_c) to dH; <dh_c, h_prev_c> over the
// tile, a fixed tree, to q1[(b nc + c) H + h][tile]; then C, dy and L of
// the chunk are staged and dh <- E(L_Q) dh + sum_i C_i (x) (E(L_i) dy_i) on
// the tensor cores (the mirror of B5's chunk_state).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT, 2)
walk_bwd(const float* __restrict__ dy, const float* __restrict__ Cm,
         const float* __restrict__ Lg, const float* __restrict__ st,
         const float* __restrict__ dhf, float* __restrict__ dH,
         float* __restrict__ q1, int S, int H, int P, int N, int Q, int nc,
         long long bc_row, bool vec_bc, bool vec_p) {
  extern __shared__ __align__(16) float sm[];
  const int Qp = round_up(Q, 32), Nm = round_up(N, 32), ld = Nm + 8;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int p0 = blockIdx.y * PT, pw = min(PT, P - p0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Cs = sm;                     // (Qp, ld): C rows of the chunk
  float* Ys = Cs + Qp * ld;           // (Qp, XLD): dy of the tile
  float* Ls = Ys + Qp * XLD;          // (Qp): L
  float* red = Ls + Qp;               // (NWARP) warp sums
  const int r0 = 32 * (warp >> 2), c0 = 16 * (warp & 3);
  const bool active = r0 < Nm && c0 < pw;
  const auto row_of = [&](int m, int u) { return r0 + 16 * m + 8 * u + g; };
  const long long hoff = static_cast<long long>(bh) * N * P + p0;
  float acc[2][2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = row_of(m, u), col = c0 + 8 * n + 2 * t + e;
          acc[m][n][2 * u + e] =
              dhf && active && i < N && col < pw ? dhf[hoff + i * P + col]
                                                 : 0.f;
        }
  zero_pad(Cs, ld, Q, N, Qp, Nm);
  zero_pad(Ys, XLD, Q, pw, Qp, PT);
  const int kend[2] = {Qp / 8, Qp / 8};
  for (int c = nc - 1; c >= 0; --c) {
    const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
    const long long off = bch * N * P + p0;
    float part = 0.f;
    if (active) {
      store_tiles(acc, row_of, dH + off, P, c0, N, pw, vec_p);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = row_of(m, u), col = c0 + 8 * n + 2 * t + e;
              if (i < N && col < pw)
                part = fmaf(acc[m][n][2 * u + e], st[off + i * P + col],
                            part);
            }
    }
    part = lane_sum<1, 16>(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < NWARP; ++w) s += red[w];
      q1[bch * gridDim.y + blockIdx.y] = s;
    }
    if (c == 0) break;                // dh before chunk 0 is not needed
    const long long row0 = static_cast<long long>(b) * S +
                           static_cast<long long>(c) * Q;
    stage_rows(Cs, ld, Cm + row0 * bc_row, bc_row, Q, N, vec_bc);
    stage_rows(Ys, XLD, dy + (row0 * H + h) * P + p0,
               static_cast<long long>(H) * P, Q, pw, vec_p);
    stage_rows(Ls, 0, Lg + bch * Qp, 0, 1, Qp, true);
    cp_async_wait_all();
    __syncthreads();
    if (active) {
      const float dec = decay(Ls[Q - 1]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][n][q] *= dec;
      const auto ca = [&](int m, int u, int k) {
        return Cs[k * ld + r0 + 16 * m + 8 * u + g];
      };
      warp_mma<false>(acc, a_split(ca),
                      [&](int k, int col) { return Ys[k * XLD + c0 + col]; },
                      [&](int k) { return decay_fast(Ls[k]); }, Qp / 8, kend);
    }
    __syncthreads();                  // Cs, Ys, Ls and red are refilled
  }
}

// Offset and row stride of C.B^T's 16-row tile r in stage 2's packed copy:
// columns up to the tile's diagonal, a stride of 8 mod 16 so the transposed
// fragment loads of dxdt are free of bank conflicts; Qp rows take
// cbt_off(Qp / 16) floats.
__host__ __device__ constexpr int cbt_ld(int r) { return 16 * r + 24; }
__host__ __device__ constexpr int cbt_off(int r) { return 128 * r * (r + 2); }

enum { OP_DY = 1, OP_X = 2, OP_DH = 3, OP_HP = 4 };   // a slot's operand

// G's unit u (u < g_units(nR), nR = Qp / 32 block rows of 32): the two
// 16-column halves of each 32 x 32 block below the diagonal, then the
// diagonal blocks whole.  Block (R, Cb); columns from 32 Cb + c0; n-tiles
// (8 wide) n < nn[m] of row tile m.
__host__ __device__ constexpr int g_units(int nR) { return nR * nR; }

__device__ __forceinline__ void g_unit(int u, int nR, int& R, int& Cb,
                                       int& c0, int (&nn)[2]) {
  const int noff = nR * (nR - 1) / 2;
  if (u < 2 * noff) {
    int k = u >> 1;
    R = 1;
    while (k >= R) k -= R++;
    Cb = k;
    c0 = 16 * (u & 1);
    nn[0] = nn[1] = 2;
  } else {
    R = Cb = u - 2 * noff;
    c0 = 0;
    nn[0] = 2;
    nn[1] = 4;
  }
}

// d decay(v) / dv from e = decay(v) (ddecay without a second exp).
__device__ __forceinline__ float ddecay_of(float v, float e) {
  if (v > 0.f || v < CLIP) return 0.f;
  return (v == 0.f || v == CLIP) ? 0.5f * e : e;
}

// ---------------------------------------------------------------------------
// Stage 2, grid (Bb nc ceil(H / GH)), head groups fastest: the heads [h0,
// h1) of one (b, c), in order.  B and C.B^T are staged once; per head, three
// slots of SROWS x 64 floats take dy (slot 0), xdt (slot 1; x landed, then
// scaled by dt in place) and dh_c (slot 2), later h_prev (slot 1), one
// 64-wide P-tile each (P > 64 restages per product).  Per head:
//   G    = dy xdt^T over the triangle (warp w: G's unit w, g_unit): E o G
//          to the group's partial Dcb, and the row sums (+) and column sums
//          (-) of C.B^T o G o E' below the diagonal to dL;
//   U_B  = xdt dh_c^T (warp: rows [32 (w / 4), +32), N-columns [32 (w % 4),
//          +32)): E(L_Q - L_j) U_B to the partial, -E'(L_Q - L_j) B_j.U_B,j
//          to dL_j (j < Q - 1; their sum to dL_{Q-1});
//   dxdt = E(L_Q - L_j) B dh_c + (C.B^T o E o tril)^T dy (warp: row tiles t,
//          T - 1 - t with t = w % 4, P-columns [16 (w / 4), +16)): dx =
//          dxdt dt, and sum_p dxdt x;
//   U_C  = dy h_prev^T (as U_B; none in chunk 0, where h_prev is zero):
//          E(L_i) U_C to the partial, E'(L_i) C_i.U_C,i to dL_i.
// A partial's element has one writer, which adds the group's heads in
// order (stores the first).  The warps' dL terms and sums over p land in
// shared rows of their own (by column block, or by G unit); at the head's
// end one thread a position adds them in a fixed order and writes dL's
// terms to T and sum_p dxdt x to ddt (stage 4 adds the rest).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT, 1)
head_bwd(const float* __restrict__ x, const float* __restrict__ dt,
         const float* __restrict__ Bm, const float* __restrict__ Cm,
         const float* __restrict__ cb, const float* __restrict__ Lg,
         const float* __restrict__ st, const float* __restrict__ dH,
         const float* __restrict__ dy, float* __restrict__ dx,
         float* __restrict__ ddt, float* __restrict__ T,
         float* __restrict__ Wd, float* __restrict__ Wc,
         float* __restrict__ Wb, int S, int H, int P, int N, int Q, int nc,
         long long x_row, long long bc_row, bool vec_x, bool vec_bc,
         bool vec_p, bool vec_st) {
  extern __shared__ __align__(16) float sm[];
  const int Qp = round_up(Q, 32), Np = round_up(N, 8), ldb = Np + 4;
  const int NG = (H + GH - 1) / GH, nP = (P + PT - 1) / PT;
  const long long bc = blockIdx.x / NG;           // b nc + c
  const int grp = static_cast<int>(blockIdx.x % NG);
  const int b = static_cast<int>(bc / nc), c = static_cast<int>(bc % nc);
  const long long row0 = static_cast<long long>(b) * S +
                         static_cast<long long>(c) * Q;
  const long long bcg = bc * NG + grp;
  const int h0 = grp * GH, h1 = min(H, h0 + GH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* const S0 = sm;                          // 3 x (SROWS, SLD) slots
  float* const S1 = S0 + SROWS * SLD;
  float* const S2 = S1 + SROWS * SLD;
  float* const Bs = S2 + SROWS * SLD;            // (Qp, ldb): B rows
  float* const CBs = Bs + Qp * ldb;              // C.B^T, packed
  float* const Ls = CBs + cbt_off(Qp / 16);      // (Qp): L of the head
  float* const Ds = Ls + Qp;                     // (Qp): dt of the head
  float* const urow = Ds + Qp;        // (4, Qp): U's dL terms, by column block
  float* const xdl = urow + 4 * Qp;   // (4, Qp): sum_p dxdt x, by P-quarter
  float* const gro = xdl + 4 * Qp;    // (NWARP, 32): G's row sums, by unit
  float* const gco = gro + NWARP * 32;   // (NWARP, 32): G's column sums
  float* const bsum = gco + NWARP * 32;  // (NWARP): U_B's terms summed
  const int nscr = 8 * Qp + 65 * NWARP;  // floats from urow on
  const auto cbrow = [&](int i) {
    return CBs + cbt_off(i >> 4) + (i & 15) * cbt_ld(i >> 4);
  };

  stage_rows(Bs, ldb, Bm + row0 * bc_row, bc_row, Q, N, vec_bc);
  zero_pad(Bs, ldb, Q, N, Qp, Np);
  const float* cbg = cb + bc * Qp * Qp;
  for (int r = 0; r < Qp / 16; ++r)
    stage_rows(CBs + cbt_off(r), cbt_ld(r), cbg + 16 * r * Qp, Qp, 16,
               16 * (r + 1), true);
  cp_async_commit();
  for (int e = threadIdx.x; e < nscr; e += NT) urow[e] = 0.f;

  // what each slot holds: key(head, operand, P-tile); pend: slots whose
  // copies may be in flight
  const auto key = [](int hh, int op, int pt) { return (hh * 8 + op) * 2 + pt; };
  int tag[3] = {-1, -1, -1}, pend = 0;
  const auto slot = [&](int s) { return S0 + s * SROWS * SLD; };
  const auto issue = [&](int s, int op, int hh, int pt) {
    float* dst = slot(s);
    const int p0 = pt * PT, pw = min(PT, P - p0);
    const long long bch = bc * H + hh;
    if (op == OP_DY)
      stage_rows(dst, SLD, dy + (row0 * H + hh) * P + p0,
                 static_cast<long long>(H) * P, Q, pw, vec_p);
    else if (op == OP_X)
      stage_rows(dst, SLD, x + row0 * x_row + hh * P + p0, x_row, Q, pw,
                 vec_x);
    else
      stage_rows(dst, SLD, (op == OP_DH ? dH : st) + bch * N * P + p0, P, N,
                 pw, op == OP_DH ? vec_p : vec_st);
    zero_pad(dst, SLD, op <= OP_X ? Q : N, pw, SROWS, PT);
    tag[s] = key(hh, op, pt);
  };
  // Slots s0 and s1 to hold op0 and op1 of head hh at P-tile pt: copies of
  // what they do not hold yet, after every warp is done with the slots;
  // then a wait if any of the two has copies in flight, and xdt = x dt in
  // place where x landed.
  const auto ensure = [&](int s0, int op0, int s1, int op1, int hh, int pt) {
    const bool n0 = tag[s0] != key(hh, op0, pt);
    const bool n1 = tag[s1] != key(hh, op1, pt);
    if (!n0 && !n1 && !((pend >> s0) & 1) && !((pend >> s1) & 1)) return;
    if (n0 || n1) {
      __syncthreads();
      if (n0) issue(s0, op0, hh, pt);
      if (n1) issue(s1, op1, hh, pt);
      cp_async_commit();
    }
    cp_async_wait(0);
    pend = 0;
    __syncthreads();
    const int sx = (n0 && op0 == OP_X) ? s0 : (n1 && op1 == OP_X) ? s1 : -1;
    if (sx >= 0) {
      float* X = slot(sx);
      for (int e = threadIdx.x; e < Q * PT; e += NT)
        X[(e / PT) * SLD + e % PT] *= Ds[e / PT];
      __syncthreads();
    }
  };
  // Slot s to take op of head hh at P-tile pt while the block computes
  // from the others.
  const auto prefetch = [&](int s, int op, int hh, int pt) {
    __syncthreads();
    issue(s, op, hh, pt);
    cp_async_commit();
    pend |= 1 << s;
  };

  const int nR = Qp / 32, T16 = Qp / 16;
  int gR = 0, gCb = 0, gc0 = 0, gnn[2] = {0, 0};
  const bool gact = warp < g_units(nR);
  if (gact) g_unit(warp, nR, gR, gCb, gc0, gnn);
  const int ur0 = 32 * (warp >> 2), uc0 = 32 * (warp & 3);   // U's block
  const bool uact = ur0 < Qp && uc0 < Np;
  const int dq = warp & 3, dc0 = 16 * (warp >> 2);           // dxdt's
  const int drt[2] = {dq, T16 - 1 - dq};
  const int nn4[2] = {4, 4}, kz[2] = {0, 0};

  // U = A' M^T over P (A' = xdt or dy in slot sa, M = dh_c or h_prev in
  // slot smat): the warp's 32 x 32 block in uacc
  float uacc[2][4][4];
  const auto u_product = [&](int sa, int opa, int smat, int opm, int hh) {
    zero_acc(uacc);
    for (int pt = 0; pt < nP; ++pt) {
      ensure(sa, opa, smat, opm, hh, pt);
      if (!uact) continue;
      const int kP = round_up(min(PT, P - pt * PT), 8) / 8;
      const int ke[2] = {kP, ur0 + 16 < Qp ? kP : 0};
      const float* A = slot(sa) + (ur0 + g) * SLD;
      const float* M = slot(smat) + uc0 * SLD;
      warp_mma_rng(
          uacc, [&](int m, int u, int k) { return A[(16 * m + 8 * u) * SLD + k]; },
          [&](int k, int col) { return M[col * SLD + k]; }, kz, ke, nn4);
    }
  };
  // The old partial values at the warp's U elements of row tile m (zero
  // for the group's first head), all loaded before any is stored back.
  const auto u_old = [&](float (&old)[2][4][2], const float* w, int m,
                         bool first) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = ur0 + 16 * m + 8 * u + g;
          const int col = uc0 + 8 * n + 2 * t + e;
          old[u][n][e] = !first && r < Q && col < N ? w[r * N + col] : 0.f;
        }
  };

  for (int h = h0; h < h1; ++h) {
    const long long bch = bc * H + h;
    const bool first = h == h0;
    for (int j = threadIdx.x; j < Qp; j += NT) {
      Ls[j] = Lg[bch * Qp + j];
      Ds[j] = j < Q ? dt[(row0 + j) * H + h] : 0.f;
    }
    __syncthreads();
    const float lq = Ls[Q - 1];

    // G = dy xdt^T over the triangle
    {
      float acc[2][4][4];
      zero_acc(acc);
      for (int pt = 0; pt < nP; ++pt) {
        ensure(0, OP_DY, 1, OP_X, h, pt);
        if (!gact) continue;
        const int kP = round_up(min(PT, P - pt * PT), 8) / 8;
        const int ke[2] = {kP, kP};
        const float* A = S0 + (32 * gR + g) * SLD;
        const float* X = S1 + (32 * gCb + gc0) * SLD;
        warp_mma_rng(
            acc, [&](int m, int u, int k) { return A[(16 * m + 8 * u) * SLD + k]; },
            [&](int k, int col) { return X[col * SLD + k]; }, kz, ke, gnn);
      }
      if (gact) {
        float2* wd = reinterpret_cast<float2*>(Wd + bcg * Qp * Qp +
                                                (32 * gR + g) * Qp +
                                                32 * gCb + gc0 + 2 * t);
        const auto wdo = [&](int m, int u, int n) {
          return (16 * m + 8 * u) * (Qp / 2) + 4 * n;
        };
        float csum[4][2] = {};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float2 old[2][4];           // loaded before any store
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              old[u][n] = (!first && n < gnn[m] &&
                           32 * gR + 16 * m + 8 * u + g < Q)
                              ? wd[wdo(m, u, n)]
                              : make_float2(0.f, 0.f);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = 32 * gR + 16 * m + 8 * u + g;
            const float li = Ls[i];
            const float* cbi = cbrow(i);
            float rsum = 0.f;
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              if (n >= gnn[m]) continue;
              const int j0 = 32 * gCb + gc0 + 8 * n + 2 * t;
              float o[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int j = j0 + e;
                const float gv = acc[m][n][2 * u + e];
                const bool live = i < Q && j <= i;
                const float v = li - Ls[j];
                const float ev = decay(v);
                o[e] = live ? ev * gv : 0.f;
                // cbi[j] is in bounds above the diagonal too
                const float dv = cbi[j] * gv * ddecay_of(v, ev);
                rsum += live && j < i ? dv : 0.f;
                csum[n][e] += live && j < i ? dv : 0.f;
              }
              if (i < Q)
                wd[wdo(m, u, n)] = make_float2(old[u][n].x + o[0],
                                               old[u][n].y + o[1]);
            }
            rsum = lane_sum<1, 2>(rsum);
            if (t == 0) gro[warp * 32 + 16 * m + 8 * u + g] += rsum;
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s = lane_sum<4, 16>(csum[n][e]);
            if (g == 0 && n < gnn[1])
              gco[warp * 32 + gc0 + 8 * n + 2 * t + e] += s;
          }
      }
    }

    // U_B = xdt dh_c^T
    u_product(1, OP_X, 2, OP_DH, h);
    if (uact) {
      float* wb = Wb + bcg * Q * N;
      float bs_all = 0.f;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float old[2][4][2];
        u_old(old, wb, m, first);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = ur0 + 16 * m + 8 * u + g;
          const float lj = j < Q ? Ls[j] : lq;
          const float v = lq - lj, sc = decay(v);
          float s = 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = uc0 + 8 * n + 2 * t + e;
              if (j < Q && col < N) {
                const float a = uacc[m][n][2 * u + e];
                s = fmaf(Bs[j * ldb + col], a, s);
                wb[j * N + col] = old[u][n][e] + sc * a;
              }
            }
          s = lane_sum<1, 2>(s);
          const float bs = j < Q - 1 ? ddecay_of(v, sc) * s : 0.f;
          if (t == 0 && j < Q) urow[(warp & 3) * Qp + j] -= bs;
          bs_all += t == 0 ? bs : 0.f;
        }
      }
      bs_all = lane_sum<4, 16>(bs_all);
      if (lane == 0) bsum[warp] += bs_all;
    }
    if (nP == 1 && c > 0) prefetch(1, OP_HP, h, 0);

    // dxdt = E(L_Q - L_j) B dh_c + (C.B^T o E o tril)^T dy, P-tile by P-tile
    for (int pt = 0; pt < nP; ++pt) {
      ensure(0, OP_DY, 2, OP_DH, h, pt);
      const int p0 = pt * PT, pw = min(PT, P - p0);
      if (!(dq < T16 / 2 && dc0 < pw)) continue;
      float acc[2][2][4];
      zero_acc(acc);
      int rows[2][2];
      float lj[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          rows[m][u] = 16 * drt[m] + 8 * u + g;
          lj[m][u] = Ls[rows[m][u]];
        }
      const int nn2[2] = {2, 2};
      {
        const int ke[2] = {Np / 8, Np / 8};
        warp_mma_rng(
            acc,
            [&](int m, int u, int k) { return Bs[rows[m][u] * ldb + k]; },
            [&](int k, int col) { return S2[k * SLD + dc0 + col]; }, kz, ke,
            nn2);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float sc = decay(lq - lj[m][u]);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            acc[m][n][2 * u] *= sc;
            acc[m][n][2 * u + 1] *= sc;
          }
        }
      {
        const int kb[2] = {2 * drt[0], 2 * drt[1]}, ke[2] = {Qp / 8, Qp / 8};
        warp_mma_rng(
            acc,
            [&](int m, int u, int k) {
              // in bounds for k < j too (row k's 16-row tile reaches
              // column j's): a select, not a branch
              const int j = rows[m][u];
              const float v = cbrow(k)[j] * decay_fast(Ls[k] - lj[m][u]);
              return k >= j ? v : 0.f;
            },
            [&](int k, int col) { return S0[k * SLD + dc0 + col]; }, kb, ke,
            nn2);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = rows[m][u];
          float xs = 0.f;
          if (j < Q) {
            const float d = Ds[j];
            const long long xo = (row0 + j) * x_row + h * P;
            const long long yo = ((row0 + j) * H + h) * P;
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int p = p0 + dc0 + 8 * n + 2 * t + e;
                if (p < P) {
                  const float gv = acc[m][n][2 * u + e];
                  dx[yo + p] = gv * d;
                  xs = fmaf(gv, x[xo + p], xs);
                }
              }
          }
          xs = lane_sum<1, 2>(xs);
          if (t == 0 && j < Q) xdl[(warp >> 2) * Qp + j] += xs;
        }
    }
    if (nP == 1 && h + 1 < h1) prefetch(2, OP_DH, h + 1, 0);

    // U_C = dy h_prev^T (h_prev of chunk 0 is zero)
    if (c > 0) {
      u_product(0, OP_DY, 1, OP_HP, h);
      if (uact) {
        float* wc = Wc + bcg * Q * N;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float old[2][4][2], cv[2][4][2];
          u_old(old, wc, m, first);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = ur0 + 16 * m + 8 * u + g;
                const int col = uc0 + 8 * n + 2 * t + e;
                cv[u][n][e] = i < Q && col < N
                                  ? Cm[(row0 + i) * bc_row + col] : 0.f;
              }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = ur0 + 16 * m + 8 * u + g;
            const float li = i < Q ? Ls[i] : 0.f;
            const float sc = decay(li);
            float s = 0.f;
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = uc0 + 8 * n + 2 * t + e;
                if (i < Q && col < N) {
                  const float a = uacc[m][n][2 * u + e];
                  s = fmaf(cv[u][n][e], a, s);
                  wc[i * N + col] = old[u][n][e] + sc * a;
                }
              }
            s = lane_sum<1, 2>(s);
            if (t == 0 && i < Q)
              urow[(warp & 3) * Qp + i] += ddecay_of(li, sc) * s;
          }
        }
      }
    }

    // the head's dL terms and sum_p dxdt x, added in a fixed order
    __syncthreads();
    for (int k = threadIdx.x; k < Q; k += NT) {
      float r = 0.f, xd = 0.f;
      for (int q = 0; q < 4; ++q) {
        r += urow[q * Qp + k];
        xd += xdl[q * Qp + k];
      }
      for (int u = 0; u < g_units(nR); ++u) {
        int R, Cb, c0, nn[2];
        g_unit(u, nR, R, Cb, c0, nn);
        if (R == k >> 5) r += gro[u * 32 + (k & 31)];
        if (Cb == k >> 5) r -= gco[u * 32 + (k & 31)];
      }
      if (k == Q - 1)
        for (int w = 0; w < NWARP; ++w) r += bsum[w];
      T[bch * Qp + k] = r;
      ddt[(row0 + k) * H + h] = xd;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nscr; e += NT) urow[e] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// Stage 3, grid (Bb nc, 2, ceil(N / FT)): y 0 dC, y 1 dB, on N-columns [FT
// z, +FT).  Dcb = sum over the groups, in order, of stage 2's partials (the
// lower triangle; zero above), and the rows of B (dC) or C (dB) are staged;
// each warp starts from the groups' U_C (dC; none in chunk 0) or U_B (dB)
// added in order, then adds Dcb B (rows i, k = j <= i) or Dcb^T C (rows j,
// k = i >= j) on the tensor cores: row tiles t, T - 1 - t with t = w % 4,
// columns [16 (w / 4), +16).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
bc_finish(const float* __restrict__ Bm, const float* __restrict__ Cm,
          const float* __restrict__ Wd, const float* __restrict__ Wc,
          const float* __restrict__ Wb, float* __restrict__ dB,
          float* __restrict__ dC, int S, int H, int N, int Q, int nc,
          long long bc_row, bool vec_bc) {
  extern __shared__ __align__(16) float sm[];
  const int Qp = round_up(Q, 32), NG = (H + GH - 1) / GH, T16 = Qp / 16;
  const long long bc = blockIdx.x;
  const int b = static_cast<int>(bc / nc), c = static_cast<int>(bc % nc);
  const long long row0 = static_cast<long long>(b) * S +
                         static_cast<long long>(c) * Q;
  const bool db = blockIdx.y == 1;
  const int n0 = blockIdx.z * FT, nw = min(FT, N - n0);
  const int ld = Qp + (db ? 8 : 4);   // conflict-free A loads either way
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Dcb = sm;                    // (Qp, ld)
  float* Ks = Dcb + Qp * ld;          // (Qp, KLD): B or C, columns n0...
  stage_rows(Ks, KLD, (db ? Cm : Bm) + row0 * bc_row + n0, bc_row, Q, nw,
             vec_bc);
  zero_pad(Ks, KLD, Q, nw, Qp, FT);
  cp_async_commit();
  const float* wd = Wd + bc * NG * Qp * Qp;
  for (int i = warp; i < Qp; i += NWARP)
    for (int j = lane; j < Qp; j += 32) {
      float s = 0.f;
      if (i < Q && j <= i)
        for (int gg = 0; gg < NG; ++gg) s += wd[(gg * Qp + i) * Qp + j];
      Dcb[i * ld + j] = s;
    }
  cp_async_wait_all();
  __syncthreads();

  const int q = warp & 3, c0 = 16 * (warp >> 2);
  if (!(q < T16 / 2 && c0 < nw)) return;
  const int rt[2] = {q, T16 - 1 - q};
  const float* wu = (db ? Wb : Wc) + bc * NG * Q * N;
  const bool has_u = db || c > 0;
  float acc[2][2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 16 * rt[m] + 8 * u + g;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + c0 + 8 * n + 2 * t + e;
          float s = 0.f;
          if (has_u && r < Q && col < N)
            for (int gg = 0; gg < NG; ++gg) s += wu[(gg * Q + r) * N + col];
          acc[m][n][2 * u + e] = s;
        }
    }
  const int nn[2] = {2, 2};
  const int kb[2] = {db ? 2 * rt[0] : 0, db ? 2 * rt[1] : 0};
  const int ke[2] = {db ? Qp / 8 : 2 * rt[0] + 2, db ? Qp / 8 : 2 * rt[1] + 2};
  const auto bk = [&](int k, int col) { return Ks[k * KLD + c0 + col]; };
  if (db)
    warp_mma_rng(
        acc,
        [&](int m, int u, int k) { return Dcb[k * ld + 16 * rt[m] + 8 * u + g]; },
        bk, kb, ke, nn);
  else
    warp_mma_rng(
        acc,
        [&](int m, int u, int k) { return Dcb[(16 * rt[m] + 8 * u + g) * ld + k]; },
        bk, kb, ke, nn);
  float* out = db ? dB : dC;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 16 * rt[m] + 8 * u + g;
      if (r >= Q) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + c0 + 8 * n + 2 * t + e;
          if (col < N) out[(row0 + r) * N + col] = acc[m][n][2 * u + e];
        }
    }
}

// ---------------------------------------------------------------------------
// Stage 4, grid (Bb H): per chunk, dL_k = stage 2's T (+ E'(L_Q) sum_tiles
// q1 at k = Q - 1), then in one thread, k from Q - 1 down: d(dt A)_k =
// d(dt A)_{k+1} + dL_k, ddt_k += d(dt A)_k A, dA += d(dt A)_k dt_k.
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
    const int k = threadIdx.x;
    if (k < Q) {
      dL[k] = T[bch * Qp + k];
      dts[k] = dt[(row0 + k) * H + h];
      dd[k] = ddt[(row0 + k) * H + h];
    }
    __syncthreads();
    if (k == 0) {
      float qs = 0.f;
      for (int t = 0; t < ptiles; ++t) qs += q1[bch * ptiles + t];
      dL[Q - 1] += ddecay(Lg[bch * Qp + Q - 1]) * qs;
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
  const int Qp = round_up(Q, 32), Nm = round_up(N, 32);
  return sizeof(float) * (Qp * (Nm + 8) + Qp * XLD + Qp + NWARP);
}

size_t smem_head(int Q, int N) {
  const int Qp = round_up(Q, 32), Np = round_up(N, 8);
  return sizeof(float) * (3 * SROWS * SLD + Qp * (Np + 4) +
                          cbt_off(Qp / 16) + 2 * Qp + 8 * Qp +
                          65 * NWARP);
}

size_t smem_finish(int Q) {
  const int Qp = round_up(Q, 32);
  return sizeof(float) * (Qp * (Qp + 8) + Qp * KLD);
}

// The parts of ssd_scan_bwd's own workspace, in floats, each a multiple of
// 4 (16-byte aligned): dh_c of every chunk (Bb, nc, H, N, P); stage 2's dL
// terms (Bb, nc, H, Qp); stage 1's dot products (Bb, nc, H, ceil(P / PT));
// the head groups' partials Dcb (Bb, nc, NG, Qp, Qp), U_C and U_B (Bb, nc,
// NG, Q, N each), NG = ceil(H / GH).
struct Work {
  size_t dH, T, q1, d, u;
};

Work work_parts(int Bb, int S, int H, int P, int N, int Q) {
  const size_t nc = S / Q, Qp = round_up(Q, 32);
  const size_t bnch = Bb * nc * H, bncg = Bb * nc * ((H + GH - 1) / GH);
  const auto r4 = [](size_t v) { return (v + 3) / 4 * 4; };
  return {r4(bnch * N * P), r4(bnch * Qp), r4(bnch * ((P + PT - 1) / PT)),
          bncg * Qp * Qp, r4(bncg * Q * N)};
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Device launches of one ssd_scan_bwd call: the four stages.
int ssd_bwd_launches() { return 4; }

// Largest P the kernel takes (stage 2's slots hold two P-tiles' keys).
int ssd_bwd_max_head_dim() { return 2 * PT; }

// Floats of ssd_scan_bwd's own workspace (work_parts).
size_t ssd_bwd_workspace_floats(int Bb, int S, int H, int P, int N, int Q) {
  const Work w = work_parts(Bb, S, H, P, N, Q);
  return w.dH + w.T + w.q1 + w.d + 2 * w.u;
}

// B5b.  x (Bb, S, H, P) at row stride x_row, dt (Bb, S, H), A (Bb, H), B
// and C (Bb, S, N) at row stride bc_row: the forward's operands; cb, L, st:
// the parts of the forward's workspace (ssd_workspace_parts); dy (Bb, S, H,
// P) and dhf (Bb, H, N, P, or null for zero) in; dx, ddt, dA, dB, dC out,
// contiguous, all f32; ``work`` holds ssd_bwd_workspace_floats(...) floats,
// 16-byte aligned.  S % Q == 0, 1 <= Q <= 128, 1 <= N <= 128, 1 <= P <=
// 128.  Launches the four stages on ``stream``; returns the first failed
// launch's cudaError_t, else 0.
int ssd_scan_bwd(const float* x, const float* dt, const float* A,
                 const float* B, const float* C, const float* cb,
                 const float* L, const float* st, const float* dy,
                 const float* dhf, float* dx, float* ddt, float* dA,
                 float* dB, float* dC, float* work, int Bb, int S, int H,
                 int P, int N, int Q, long long x_row, long long bc_row,
                 cudaStream_t stream) {
  if (Bb < 1 || H < 1 || P < 1 || P > 2 * PT || N < 1 || N > MAX_N ||
      Q < 1 || Q > MAX_Q || S < Q || S % Q != 0 ||
      x_row < static_cast<long long>(H) * P || bc_row < N ||
      !aligned16(work))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = S / Q, ptiles = (P + PT - 1) / PT;
  const long long bnch = static_cast<long long>(Bb) * nc * H;
  if (bnch > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Work w = work_parts(Bb, S, H, P, N, Q);
  float* dH = work;
  float* T = dH + w.dH;
  float* q1 = T + w.T;
  float* Wd = q1 + w.q1;
  float* Wc = Wd + w.d;
  float* Wb = Wc + w.u;
  const bool vec_x = aligned16(x) && x_row % 4 == 0 && P % 4 == 0;
  const bool vec_bc =
      aligned16(B) && aligned16(C) && bc_row % 4 == 0 && N % 4 == 0;
  const bool vec_p = aligned16(dy) && P % 4 == 0;
  const bool vec_st = aligned16(st) && P % 4 == 0;
  const unsigned groups =
      static_cast<unsigned>(static_cast<long long>(Bb) * nc *
                            ((H + GH - 1) / GH));
  const size_t s1 = smem_walk(Q, N), s2 = smem_head(Q, N),
               s3 = smem_finish(Q);
  cudaError_t rc;
  rc = cudaFuncSetAttribute(walk_bwd,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(s1));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(head_bwd,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(s2));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(bc_finish,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(s3));
  if (rc != cudaSuccess) return static_cast<int>(rc);

  walk_bwd<<<dim3(Bb * H, ptiles), NT, s1, stream>>>(
      dy, C, L, st, dhf, dH, q1, S, H, P, N, Q, nc, bc_row, vec_bc, vec_p);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  head_bwd<<<dim3(groups), NT, s2, stream>>>(
      x, dt, B, C, cb, L, st, dH, dy, dx, ddt, T, Wd, Wc, Wb, S, H, P, N, Q,
      nc, x_row, bc_row, vec_x, vec_bc, vec_p, vec_st);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  bc_finish<<<dim3(static_cast<unsigned>(Bb * nc), 2, (N + FT - 1) / FT), NT,
              s3, stream>>>(B, C, Wd, Wc, Wb, dB, dC, S, H, N, Q, nc, bc_row,
                            vec_bc);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  final_bwd<<<dim3(Bb * H), MAX_Q, 0, stream>>>(dt, A, L, T, q1, ddt, dA, S,
                                                H, Q, nc, ptiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
