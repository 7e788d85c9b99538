// Mamba-2 chunked SSD scan (state-space duality, arXiv:2405.21060) for
// Hopper, sm_90a: three chunk-parallel stages, every product on the tensor
// cores in split TF32 (three TF32 products for each).
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
// (Bb, S, N) read by every head of row b; h (Bb, H, N, P); all f32.  x, B
// and C are read at a row stride, so the model hands over its views of the
// conv output: x[b, s, h, p] at (b S + s) x_row + h P + p, B[b, s, n] and
// C[b, s, n] at (b S + s) bc_row + n.  S % Q == 0 (ops.py pads with dt = 0
// rows); Q <= 128, N <= 128, any P.
//
// Bound: per (b, c) C.B^T's lower triangle (Q^2 N multiply-adds) once for
// all the heads; per (b, c, h) the triangle times xdt (Q^2 P), C.h and the
// state update (Q N P each).  At the mamba2-370m serve shape (Bb 4, S 2048,
// H 32, P 64, N 128, Q 128) that is 10.9 GFLOP against 0.148 GB of
// operands: ~74 operations a byte, over the f32 ridge (67 TFLOP/s over
// 3.35 TB/s: 20) and under the TF32 tensor cores' (495 TFLOP/s: 148).
// f32 SIMT would take 0.163 ms; the tensor cores in split TF32 (three
// TF32 products for each product, below) 0.066 ms; the bytes 0.044 ms.
//
// Design:
//   - tensor cores in split TF32: every product runs on mma.sync m16n8k8
//     TF32, each operand split a = hi + lo (split_tf32) and accumulated in
//     f32 as lo.hi + hi.lo + hi.hi.  One TF32 pass keeps ~3 digits and
//     misses the 1e-4 gate where the sums cancel; the split comes within
//     ~6e-6 of the largest magnitude there, ~5x the error of f32 sums in
//     the plain order (each product ~2^-20, toward zero).  exp,
//     the clips, the cumulative sum and the masks stay f32 SIMT, folded
//     into the fragment loads (decay_fast);
//   - chunk-parallel stages (Mamba-2's own GPU split, arXiv:2405.21060 §7),
//     three launches:
//       A chunk_prep  (b, c, 32 rows)  L of every head; C.B^T once for all
//                                      heads, up to each row's diagonal
//                                      block;
//       B chunk_state (b, h, P-tile)   the state passing with the chunk
//                                      states fused in: h lives in the
//                                      accumulators, h <- exp(L_Q) h +
//                                      (B o exp(L_Q - L))^T xdt chunk by
//                                      chunk; writes h_prev of every chunk
//                                      and the final h;
//       D chunk_out   (b, c, 16 heads, P-tile)  y = exp(L) C h_prev +
//                                      (C.B^T o decay o tril) xdt.
//     Only B walks the chunks in order; its products are as parallel as
//     D's.  The price is h_prev's round trip through device memory:
//     (Bb, nc, H, N, P) f32, 67 MB at the serve shape, on top of the
//     function's own bytes;
//   - staging by cp.async (16-byte copies where a row allows, else 4-byte
//     ones), padded with zeros in shared memory only (Q to 32, N to 8 or
//     32), never in device memory.  B and D hold one block of 16 warps an
//     SM (215 and 223 KB of shared memory): the next chunk's (B) or head's
//     (D) operands land in a second buffer while this one computes; D
//     stages C and C.B^T once for its 16 heads, and pairs each warp's
//     16-row tiles (t, T - 1 - t) so every warp gets the same share of the
//     triangle;
//   - what bounds it, measured: the per-element fragment work around each
//     mma.sync (a shared load, the split, a scaling; an exp in D's
//     triangle), not the tensor cores — B and D take as long with every
//     mma.sync replaced by an add.  wgmma, whose operands come from shared
//     memory, is the route past it;
//   - the cumulative log-decay is a warp prefix sum (the TPU forms it as a
//     tril matmul): another order, hence a tolerance, not bitwise;
//   - every output has one writer, no atomics: bitwise repeatable.
// Why not the TPU kernel block by block: it walks the chunks of one (b, h)
// in order with h in VMEM across a sequential grid axis, and every head
// recomputes C.B^T, on SIMT lanes here.  A GPU has no sequential grid and
// its matrix units want many independent tiles: the walk is kept only for
// the state, where it is inherent, and every other product runs over all
// (b, c, h) at once.

#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace {

constexpr int NT = 512;               // threads per block, 16 warps
constexpr int NWARP = NT / 32;
constexpr int MAX_Q = 128;            // chunk
constexpr int MAX_N = 128;            // state size
constexpr int PT = 64;                // P-tile width of stages B and D
constexpr int XLD = PT + 8;           // row stride of an x or h tile
constexpr int GH = 16;                // heads a block of stage D walks
constexpr float CLIP = -60.f;

__host__ __device__ constexpr int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

__device__ __forceinline__ float decay(float v) {
  return expf(fminf(fmaxf(v, CLIP), 0.f));
}

// decay() by the SFU's ex2.approx (relative error ~2^-22 on top of the
// exponent's own rounding): the fragment loads take one per element.
__device__ __forceinline__ float decay_fast(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(r)
      : "f"(fminf(fmaxf(v, CLIP), 0.f) * 1.4426950408889634f));
  return r;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most ``pending`` of this thread's newest copy groups are
// in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait(0);
}

// The shared-memory loops below give a tile's rows to the warps and its
// columns to the lanes: no index division.

// Rows [0, rows) of ``width`` floats, row r from src + r * sld to dst + r *
// dld, by asynchronous copies: 16 bytes each when ``vec`` (src 16-byte
// aligned; width, sld and dld multiples of 4), else 4 bytes each.
__device__ __forceinline__ void stage_rows(float* dst, int dld,
                                           const float* src, long long sld,
                                           int rows, int width, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += NWARP) {
    if (vec) {
      for (int q = 4 * lane; q < width; q += 128)
        cp_async16(dst + r * dld + q, src + r * sld + q);
    } else {
      for (int q = lane; q < width; q += 32)
        cp_async4(dst + r * dld + q, src + r * sld + q);
    }
  }
}

// Zeros of a rows_p x width_p tile outside its staged [0, rows) x [0,
// width) corner.
__device__ __forceinline__ void zero_pad(float* dst, int dld, int rows,
                                         int width, int rows_p,
                                         int width_p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows_p; r += NWARP)
    for (int q = (r < rows ? width : 0) + lane; q < width_p; q += 32)
      dst[r * dld + q] = 0.f;
}

// a = hi + lo in TF32: hi is a truncated to TF32's 10 mantissa bits, lo =
// a - hi exactly (|lo| < 2^-10 |a|), handed over whole: the tensor cores
// read its TF32 bits, so |a - hi - tf32(lo)| < 2^-20 |a|, toward zero (f32
// rounding: 2^-24).  Two instructions.  Both halves rounded to nearest, as
// cvt.rna.tf32.f32 rounds, cost 10% more time at the serve shape and cut
// the error on cancelling sums only 1.4x: most of it is not the split's.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: acc[m][n] (16 x 8 tiles) += A[rows of tile m, k] . B[k, columns
// of tile n] over k < 8 ksteps, tile m stopping at k-step kend[m] (read
// only when TRI); split-TF32.  a(m, u, k, hi, lo) gives A at row g + 8 u
// of tile m, split (a_split wraps a plain value); b(k, c) bk(k) is B at
// column c of the warp's 8 NB columns (bk scales row k).  Fragments as the
// PTX ISA lays out m16n8k8 .tf32 (g = lane / 4, t = lane % 4): a = A(g, t),
// A(g + 8, t), A(g, t + 4), A(g + 8, t + 4); b = B(t, g), B(t + 4, g); d =
// D(g, 2t), D(g, 2t + 1), D(g + 8, 2t), D(g + 8, 2t + 1).  The callers'
// strides keep each fragment load free of bank conflicts: g ld + t with
// ld = 4 mod 8, t ld + g with ld = 8 mod 16.
template <bool TRI, int MT, int NB, class FA, class FB, class FK>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NB][4],
                                         const FA& a, const FB& b,
                                         const FK& bk, int ksteps,
                                         const int (&kend)[MT]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = 8 * ks + t;
    const float s0 = bk(k), s1 = bk(k + 4);
    uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      split_tf32(b(k, 8 * n + g) * s0, bh[n][0], bl[n][0]);
      split_tf32(b(k + 4, 8 * n + g) * s1, bh[n][1], bl[n][1]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (TRI && ks >= kend[m]) continue;
      uint32_t ah[4], al[4];
      a(m, 0, k, ah[0], al[0]);
      a(m, 1, k, ah[1], al[1]);
      a(m, 0, k + 4, ah[2], al[2]);
      a(m, 1, k + 4, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        mma_tf32(acc[m][n], al, bh[n]);
        mma_tf32(acc[m][n], ah, bl[n]);
        mma_tf32(acc[m][n], ah, bh[n]);
      }
    }
  }
}

// warp_mma's A from a functor f(m, u, k) of plain values.
template <class F>
__device__ __forceinline__ auto a_split(const F& f) {
  return [&f](int m, int u, int k, uint32_t& hi, uint32_t& lo) {
    split_tf32(f(m, u, k), hi, lo);
  };
}

// One warp's accumulator tiles (see warp_mma) to dst[row * dld + col] for
// rows row(m, u) < rows and columns c0 + 8 n + 2 t (+1) < cols: one 8-byte
// store a row pair when ``vec`` (dst, dld and cols even).
template <int MT, int NB, class FR>
__device__ __forceinline__ void store_tiles(const float (&acc)[MT][NB][4],
                                            const FR& row, float* dst,
                                            long long dld, int c0, int rows,
                                            int cols, bool vec) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = row(m, u);
      if (i >= rows) continue;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int col = c0 + 8 * n + 2 * t;
        float* o = dst + i * dld + col;
        if (vec) {
          if (col < cols)
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[m][n][2 * u], acc[m][n][2 * u + 1]);
        } else {
          if (col < cols) o[0] = acc[m][n][2 * u];
          if (col + 1 < cols) o[1] = acc[m][n][2 * u + 1];
        }
      }
    }
}

// One warp: L[j] = sum_{i<=j} dt[i * stride] * a for j < Q (lane-serial
// runs, then a shuffle scan of the run totals), L[j] = 0 for Q <= j < Qp.
__device__ __forceinline__ void chunk_cumsum(const float* dt, int stride,
                                             float a, int Q, float* L,
                                             int Qp) {
  const int lane = threadIdx.x & 31;
  const int per = (Q + 31) / 32;      // <= 4
  const int j0 = lane * per;
  float v[MAX_Q / 32];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k) {
    if (k < per && j0 + k < Q) run += dt[(j0 + k) * stride] * a;
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
  for (int j = Q + lane; j < Qp; j += 32) L[j] = 0.f;
}

// Stage A, grid (nc, Bb, Qp / 32): block z owns rows [32 z, 32 z + 32) of
// cb (Bb, nc, Qp, Qp) = C.B^T of the chunk, on the 32-column blocks up to
// its diagonal block (zero in the padding), and L (Bb, nc, H, Qp) of the
// heads h = z mod gridDim.z.  Warp w owns the 16 rows 16 (w % 2) and the
// 32 columns 32 (w / 2) when w / 2 <= z.
__global__ void __launch_bounds__(NT)
chunk_prep(const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           float* __restrict__ cb, float* __restrict__ Lg, int S, int H,
           int N, int Q, long long bc_row, bool vec_bc) {
  extern __shared__ __align__(16) float sm[];
  const int Qp = round_up(Q, 32), Np = round_up(N, 8), ld = Np + 4;
  const int c = blockIdx.x, b = blockIdx.y, z = blockIdx.z, nc = gridDim.x;
  const int i0 = 32 * z, jn = i0 + 32;   // rows [i0, i0 + 32), columns < jn
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long bc = static_cast<long long>(b) * nc + c;
  const long long row0 = static_cast<long long>(b) * S +
                         static_cast<long long>(c) * Q;
  float* Cs = sm;                     // (32, ld): C rows [i0, i0 + 32)
  float* Bs = Cs + 32 * ld;           // (jn, ld): B rows [0, jn)
  const int ci = max(0, min(32, Q - i0)), bj = min(jn, Q);
  stage_rows(Cs, ld, Cm + (row0 + i0) * bc_row, bc_row, ci, N, vec_bc);
  stage_rows(Bs, ld, Bm + row0 * bc_row, bc_row, bj, N, vec_bc);
  zero_pad(Cs, ld, ci, N, 32, Np);
  zero_pad(Bs, ld, bj, N, jn, Np);
  for (int h = z + gridDim.z * warp; h < H; h += gridDim.z * NWARP)
    chunk_cumsum(dt + row0 * H + h, H, A[b * H + h], Q,
                 Lg + (bc * H + h) * Qp, Qp);   // while the copies land
  cp_async_wait_all();
  __syncthreads();

  const int r0 = 16 * (warp & 1), c0 = 32 * (warp >> 1);
  if (c0 >= jn) return;
  const int g = lane >> 2, t = lane & 3;
  float acc[1][4][4] = {};
  const int kend[1] = {Np / 8};
  const float* crow = Cs + (r0 + g) * ld;
  const float* bcol = Bs + c0 * ld;
  const auto ca = [&](int, int u, int k) { return crow[8 * u * ld + k]; };
  warp_mma<false>(acc, a_split(ca),
           [&](int k, int col) { return bcol[col * ld + k]; },
           [](int) { return 1.f; }, Np / 8, kend);
  float* out = cb + (bc * Qp + i0 + r0 + g) * Qp + c0 + 2 * t;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<float2*>(out + 8 * n) =
        make_float2(acc[0][n][0], acc[0][n][1]);
    *reinterpret_cast<float2*>(out + 8 * Qp + 8 * n) =
        make_float2(acc[0][n][2], acc[0][n][3]);
  }
}

// Stage B, grid (Bb H, ceil(P / PT)): one head and P-tile walks the chunks
// in order, its state h (N x P-tile) held in the warps' accumulators:
// before chunk c it writes h (h_prev of chunk c) into st (Bb, nc, H, N,
// P), then h <- exp(clip(L_Q)) h + sum_j B[j, n] w_j xdt[j, p] with w_j =
// exp(clip(L_Q - L_j)), on the tensor cores; the final h goes to hout.
// Each chunk's B, x, L and dt land in one of two buffers while the chunk
// before computes; xdt w is formed in the fragment loads.  Warp w owns
// state rows [32 (w / 4), +32) and columns [16 (w % 4), +16).
__global__ void __launch_bounds__(NT, 1)
chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ Bm, const float* __restrict__ Lg,
            float* __restrict__ st, float* __restrict__ hout, int S, int H,
            int P, int N, int Q, int nc, long long x_row, long long bc_row,
            bool vec_x, bool vec_bc, bool vec_st) {
  extern __shared__ __align__(16) float sm[];
  const int Qp = round_up(Q, 32), Nm = round_up(N, 32), ld = Nm + 8;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int p0 = blockIdx.y * PT, pw = min(PT, P - p0);
  // buffer k of a chunk: (Qp, ld) B rows, (Qp, XLD) x, (Qp) L, (Qp) dt
  const int bsz = Qp * ld + Qp * XLD + 2 * Qp;
  const auto Bs = [&](int k) { return sm + k * bsz; };
  const auto Xs = [&](int k) { return sm + k * bsz + Qp * ld; };
  const auto Ls = [&](int k) { return Xs(k) + Qp * XLD; };
  const auto Ds = [&](int k) { return Ls(k) + Qp; };
  const auto load_chunk = [&](int c, int k) {
    const long long row0 = static_cast<long long>(b) * S +
                           static_cast<long long>(c) * Q;
    const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
    stage_rows(Bs(k), ld, Bm + row0 * bc_row, bc_row, Q, N, vec_bc);
    stage_rows(Xs(k), XLD, x + row0 * x_row + h * P + p0, x_row, Q, pw,
               vec_x);
    stage_rows(Ls(k), 0, Lg + bch * Qp, 0, 1, Qp, true);
    for (int j = threadIdx.x; j < Q; j += NT)
      cp_async4(Ds(k) + j, dt + (row0 + j) * H + h);
    cp_async_commit();
  };
  for (int k = 0; k < 2; ++k) {
    zero_pad(Bs(k), ld, Q, N, Qp, Nm);
    zero_pad(Xs(k), XLD, Q, pw, Qp, PT);
    for (int j = Q + threadIdx.x; j < Qp; j += NT) Ds(k)[j] = 0.f;
  }
  load_chunk(0, 0);

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = 32 * (warp >> 2), c0 = 16 * (warp & 3);
  const bool active = r0 < Nm && c0 < pw;
  const int kend[2] = {Qp / 8, Qp / 8};
  const auto row_of = [&](int m, int u) { return r0 + 16 * m + 8 * u + g; };
  float acc[2][2][4] = {};
  for (int c = 0; c < nc; ++c) {
    const int k = c & 1;
    const bool next = c + 1 < nc;
    if (next) load_chunk(c + 1, k ^ 1);
    cp_async_wait(next ? 1 : 0);
    __syncthreads();
    if (active) {
      const float* B = Bs(k);
      const float* X = Xs(k) + c0;
      const float* L = Ls(k);
      const float* D = Ds(k);
      const float ltot = L[Q - 1], dec = decay(ltot);
      const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
      store_tiles(acc, row_of, st + bch * N * P + p0, P, c0, N, pw, vec_st);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][n][q] *= dec;
      const auto ba = [&](int m, int u, int kk) {
        return B[kk * ld + r0 + 16 * m + 8 * u + g];
      };
      warp_mma<false>(
          acc, a_split(ba), [&](int kk, int col) { return X[kk * XLD + col]; },
          [&](int kk) { return D[kk] * decay_fast(ltot - L[kk]); }, Qp / 8,
          kend);
    }
    __syncthreads();                  // the buffer is refilled two chunks on
  }
  if (active)
    store_tiles(acc, row_of, hout + static_cast<long long>(bh) * N * P + p0, P,
                c0, N, pw, vec_st);
}

// Offset of C.B^T's block row rb (rows [32 rb, 32 rb + 32), columns up to
// its diagonal block, row stride 32 rb + 36) in stage D's packed copy; Qp
// rows take cb_off(Qp / 32) floats.
__host__ __device__ constexpr int cb_off(int rb) {
  return 32 * (16 * rb * rb + 20 * rb);
}

// Stage D, grid (ceil(H / GH) nc Bb, ceil(P / PT)), head groups fastest: y
// of one chunk for GH heads and one P-tile.  C.B^T's block rows (stage A's)
// and C are staged once; each head's x, L and dt land in one of two
// buffers, and its h_prev (stage C's) in one, while the head before
// computes.  Per head: acc = C h_prev, times exp(clip(L_i)) row by row,
// then acc += gamma xdt with gamma = C.B^T o exp(clip(L_i - L_j)) o tril
// formed in the fragment loads.  Warp w owns columns [16 (w % 4), +16) and
// the 16-row tiles mg and T - 1 - mg (mg = w / 4, T = Qp / 16), so every
// warp's share of the triangle is the same.
__global__ void __launch_bounds__(NT, 1)
chunk_out(const float* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ Cm, const float* __restrict__ cb,
          const float* __restrict__ Lg, const float* __restrict__ st,
          float* __restrict__ y, int S, int H, int P, int N, int Q, int nc,
          long long x_row, long long bc_row, bool vec_x, bool vec_bc,
          bool vec_st, bool vec_y) {
  extern __shared__ __align__(16) float sm[];
  const int Qp = round_up(Q, 32), Np = round_up(N, 8), lc = Np + 4;
  const int T = Qp / 16;
  const int HG = (H + GH - 1) / GH, hg = blockIdx.x % HG;
  const long long bc = blockIdx.x / HG;           // b nc + c
  const int b = static_cast<int>(bc / nc), c = static_cast<int>(bc % nc);
  const int p0 = blockIdx.y * PT, pw = min(PT, P - p0);
  const int h0 = hg * GH, h1 = min(H, h0 + GH);
  const long long row0 = static_cast<long long>(b) * S +
                         static_cast<long long>(c) * Q;
  float* CBs = sm;                    // C.B^T block rows, packed
  float* Cs = CBs + cb_off(Qp / 32);  // (Qp, lc): C rows of the chunk
  float* Xs = Cs + Qp * lc;           // 2 x (Qp, XLD): x of a head
  float* Hs = Xs + 2 * Qp * XLD;      // (Np, XLD): h_prev of a head
  float* Ls = Hs + Np * XLD;          // 2 x (Qp): L of a head
  float* Ds = Ls + 2 * Qp;            // 2 x (Qp): dt of a head
  auto load_x = [&](int hh, int buf) {
    stage_rows(Xs + buf * Qp * XLD, XLD, x + row0 * x_row + hh * P + p0,
               x_row, Q, pw, vec_x);
    stage_rows(Ls + buf * Qp, 0, Lg + (bc * H + hh) * Qp, 0, 1, Qp, true);
    for (int j = threadIdx.x; j < Q; j += NT)
      cp_async4(Ds + buf * Qp + j, dt + (row0 + j) * H + hh);
  };
  auto load_h = [&](int hh) {
    stage_rows(Hs, XLD, st + (bc * H + hh) * N * P + p0, P, N, pw, vec_st);
  };
  const float* cbg = cb + bc * Qp * Qp;
  for (int rb = 0; rb < Qp / 32; ++rb)
    stage_rows(CBs + cb_off(rb), 32 * rb + 36, cbg + 32 * rb * Qp, Qp, 32,
               32 * rb + 32, true);
  stage_rows(Cs, lc, Cm + row0 * bc_row, bc_row, Q, N, vec_bc);
  zero_pad(Cs, lc, Q, N, Qp, Np);
  zero_pad(Hs, XLD, N, pw, Np, PT);
  for (int buf = 0; buf < 2; ++buf) {
    zero_pad(Xs + buf * Qp * XLD, XLD, Q, pw, Qp, PT);
    for (int j = Q + threadIdx.x; j < Qp; j += NT) Ds[buf * Qp + j] = 0.f;
  }
  load_x(h0, 0);
  load_h(h0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int mg = warp >> 2, c0 = 16 * (warp & 3);
  const bool active = 2 * mg < T && c0 < pw;
  const int rt[2] = {mg, T - 1 - mg};
  const int kend[2] = {2 * rt[0] + 2, 2 * rt[1] + 2};   // to the diagonal
  const int kall[2] = {Np / 8, Np / 8};
  int row[2][2];
  const float* cbrow[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = 16 * rt[m] + 8 * u + g, rb = i / 32;
      row[m][u] = i;
      cbrow[m][u] = CBs + cb_off(rb) + (i - 32 * rb) * (32 * rb + 36);
    }
  const auto row_of = [&](int m, int u) { return row[m][u]; };
  const long long yrow = static_cast<long long>(H) * P;
  for (int hh = h0; hh < h1; ++hh) {
    const int buf = (hh - h0) & 1;
    const bool next = hh + 1 < h1;
    if (next) {
      load_x(hh + 1, buf ^ 1);
      cp_async_commit();
    }
    cp_async_wait(next ? 1 : 0);
    __syncthreads();
    const float* X = Xs + buf * Qp * XLD + c0;
    const float* L = Ls + buf * Qp;
    const float* D = Ds + buf * Qp;
    float acc[2][2][4] = {};
    if (active) {
      const auto ca = [&](int m, int u, int k) {
        return Cs[row[m][u] * lc + k];
      };
      warp_mma<false>(
          acc, a_split(ca),
          [&](int k, int col) { return Hs[k * XLD + c0 + col]; },
          [](int) { return 1.f; }, Np / 8, kall);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float el = decay(L[row[m][u]]);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            acc[m][n][2 * u] *= el;
            acc[m][n][2 * u + 1] *= el;
          }
        }
    }
    __syncthreads();                  // Hs is read: the next h_prev goes in
    if (next) {
      load_h(hh + 1);
      cp_async_commit();
    }
    if (active) {
      float li[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u) li[m][u] = L[row[m][u]];
      const auto ga = [&](int m, int u, int k) {
        const int i = row[m][u];
        return k <= i ? cbrow[m][u][k] * decay_fast(li[m][u] - L[k]) : 0.f;
      };
      warp_mma<true>(
          acc, a_split(ga),
          [&](int k, int col) { return X[k * XLD + col]; },
          [&](int k) { return D[k]; }, kend[1], kend);
      store_tiles(acc, row_of, y + row0 * yrow + hh * P + p0, yrow, c0, Q,
                  pw, vec_y);
    }
    __syncthreads();                  // the buffer is refilled two heads on
  }
}

struct Sizes {
  int Qp, nc;
  size_t cb, L, st;                   // workspace floats of each part
};

Sizes sizes(int Bb, int S, int H, int P, int N, int Q) {
  Sizes z;
  z.Qp = round_up(Q, 32);
  z.nc = S / Q;
  const size_t bnc = static_cast<size_t>(Bb) * z.nc;
  z.cb = bnc * z.Qp * z.Qp;
  z.L = bnc * H * z.Qp;
  z.st = bnc * H * static_cast<size_t>(N) * P;
  return z;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ssd_max_chunk() { return MAX_Q; }

int ssd_max_state() { return MAX_N; }

// Device launches of one ssd_scan call: the three stages.
int ssd_launches() { return 3; }

// Floats of the workspace ssd_scan needs: C.B^T (Bb, nc, Qp, Qp), L (Bb,
// nc, H, Qp) and h_prev (Bb, nc, H, N, P), Qp = Q rounded up to 32.
size_t ssd_workspace_floats(int Bb, int S, int H, int P, int N, int Q) {
  const Sizes z = sizes(Bb, S, H, P, N, Q);
  return z.cb + z.L + z.st;
}

// B5.  x (Bb, S, H, P) at row stride x_row, dt (Bb, S, H), A (Bb, H), B
// and C (Bb, S, N) at row stride bc_row in; y (Bb, S, H, P), h (Bb, H, N,
// P) out, contiguous; all f32; ``work`` holds ssd_workspace_floats(...)
// floats, 16-byte aligned.  S % Q == 0, 1 <= Q <= ssd_max_chunk(), 1 <= N
// <= ssd_max_state(), x_row >= H P, bc_row >= N.  Launches the three stages
// on ``stream``; returns the first failed launch's cudaError_t, else 0.
int ssd_scan(const float* x, const float* dt, const float* A, const float* B,
             const float* C, float* y, float* h, float* work, int Bb, int S,
             int H, int P, int N, int Q, long long x_row, long long bc_row,
             cudaStream_t stream) {
  if (Bb < 1 || H < 1 || P < 1 || N < 1 || N > MAX_N || Q < 1 ||
      Q > MAX_Q || S < Q || S % Q != 0 ||
      x_row < static_cast<long long>(H) * P || bc_row < N || !aligned16(work))
    return static_cast<int>(cudaErrorInvalidValue);
  const Sizes z = sizes(Bb, S, H, P, N, Q);
  float* cb = work;
  float* Lg = cb + z.cb;
  float* st = Lg + z.L;
  const int Qp = z.Qp, Np = round_up(N, 8), Nm = round_up(N, 32);
  const bool vec_x = aligned16(x) && x_row % 4 == 0 && P % 4 == 0;
  const bool vec_bc =
      aligned16(B) && aligned16(C) && bc_row % 4 == 0 && N % 4 == 0;
  const bool vec_st = P % 4 == 0;
  const int ptiles = (P + PT - 1) / PT;
  const long long units =
      static_cast<long long>((H + GH - 1) / GH) * z.nc * Bb;
  if (units > 0x7fffffffLL || static_cast<long long>(Bb) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  const size_t smem_a = sizeof(float) * (32 + Qp) * (Np + 4);
  const size_t smem_b =
      sizeof(float) * 2 * (Qp * (Nm + 8) + Qp * XLD + 2 * Qp);
  const size_t smem_d = sizeof(float) * (cb_off(Qp / 32) + Qp * (Np + 4) +
                                         2 * Qp * XLD + Np * XLD + 4 * Qp);
  cudaError_t rc;
  rc = cudaFuncSetAttribute(chunk_prep,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem_a));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(chunk_state,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem_b));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(chunk_out,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem_d));
  if (rc != cudaSuccess) return static_cast<int>(rc);

  chunk_prep<<<dim3(z.nc, Bb, Qp / 32), NT, smem_a, stream>>>(
      dt, A, B, C, cb, Lg, S, H, N, Q, bc_row, vec_bc);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  chunk_state<<<dim3(Bb * H, ptiles), NT, smem_b, stream>>>(
      x, dt, B, Lg, st, h, S, H, P, N, Q, z.nc, x_row, bc_row, vec_x, vec_bc,
      vec_st && aligned16(h));
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  chunk_out<<<dim3(static_cast<unsigned>(units), ptiles), NT, smem_d,
              stream>>>(x, dt, C, cb, Lg, st, y, S, H, P, N, Q, z.nc, x_row,
                        bc_row, vec_x, vec_bc, vec_st,
                        vec_st && aligned16(y));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
