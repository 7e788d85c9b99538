// Split-TF32 tensor-core products and cp.async staging for Hopper, sm_90a:
// the helpers of the SSD scan's forward (ssd_scan.cu, B5) and backward
// (ssd_scan_bwd.cu, B5b).
//
// Included inside each source's anonymous namespace, after that source
// declares NWARP (warps a block: the stride of stage_rows' and zero_pad's
// row loops) and CLIP (the decay exponent's lower clip), so each source
// keeps its own block size.

#pragma once

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
