// Shared pieces of the chunked scans K3 (wkv6.cu) and K4 (ssd.cu): f32
// products on the tensor cores as 3xTF32 `mma.sync`, 16-byte staging of
// chunk rows, and the cross-chunk carry kernel.
//
// 3xTF32: each f32 operand is split a = a_hi + a_lo, each part rounded to
// TF32 as cvt.rna.tf32.f32 rounds (a_hi keeps the top 19 bits, rounded half
// away from zero; a_lo the rounded rest), and d += a_lo b_hi + a_hi b_lo +
// a_hi b_hi
// through mma.sync.m16n8k8 with f32 accumulation.  The dropped a_lo b_lo
// term is ~2^-22 of the product, so the sum stays close to f32 accuracy
// (one TF32 pass keeps ~3 decimal digits).
#pragma once

#include "common.cuh"

namespace repro {

// x = hi + lo as two TF32 operands, each rounded as cvt.rna.tf32.f32
// rounds (the top 19 bits, half away from zero).  The rounding is done on
// the bit pattern: adding half a TF32 ulp (0x1000) to the magnitude bits
// carries into the kept bits exactly when rna rounds up.  mma reads only
// the top 19 bits of a TF32 register, so the low bits need no clearing
// except where hi is subtracted.  For finite x this equals two
// cvt.rna.tf32.f32, without the instruction's inf/nan guard (ptxas lowers
// it to a compare and a select around the same add).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// 2^min(x, 0): a decay factor in (0, 1] (one MUFU.EX2, ~2 ulp; results
// under 2^-126 flush to zero, where they multiply a contribution that is
// lost in f32 anyway)
__device__ __forceinline__ float decay2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(fminf(x, 0.f)));
  return y;
}

// A operand of one m16n8k8 (16 x 8, row-major) and B operand (8 x 8,
// column-major), each split into its hi and lo TF32 parts.  Lane (g, t) =
// (lane / 4, lane % 4) holds A(g, t), A(g + 8, t), A(g, t + 4),
// A(g + 8, t + 4) and B(t, g), B(t + 4, g); its C fragment is C(g, 2t),
// C(g, 2t + 1), C(g + 8, 2t), C(g + 8, 2t + 1).
struct FragA {
  unsigned hi[4], lo[4];
};
struct FragB {
  unsigned hi[2], lo[2];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand's (hi, lo) TF32 pair: split here, or read already split
// (an operand several warps or heads share is split once into shared
// memory, its hi and lo parts stored as their bit patterns).
__device__ __forceinline__ uint2 tf32_pair(float x) {
  uint2 p;
  split_tf32(x, p.x, p.y);
  return p;
}
__device__ __forceinline__ uint2 tf32_pair(uint2 p) { return p; }

// acc[j] += a b[j] for NT column tiles at near-f32 accuracy (the two
// small terms first), issued pass by pass so that NT independent mma
// stand between two that share an accumulator
template <int NT>
__device__ __forceinline__ void mma3_tiles(float (&acc)[NT][4],
                                           const FragA& a,
                                           const FragB (&b)[NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], a.lo, b[j].hi[0], b[j].hi[1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], a.hi, b[j].lo[0], b[j].lo[1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], a.hi, b[j].hi[0], b[j].hi[1]);
}

// acc (a 16 x 8*NT tile, C fragments) += A (16 x 8*k_steps) . B, where
// a_at(h, k) is A at row g + 8h of the tile and depth k, and b_at(k, c) is
// B at depth k and column c (0 <= c < 8*NT).  The accessors read shared
// memory and may scale what they read; each returns a float, split here,
// or a split pair (tf32_pair).
// ROW_K: the depth runs along shared-memory rows of both operands (their
// reads sit at t * stride + g); the mma's k = t, t + 4 then take depths
// 2t, 2t + 1 of each 8 (the same sum, in another order), which keeps
// those reads conflict-free at row strides of 4 mod 16 floats.
template <int NT, bool ROW_K = false, class FA, class FB>
__device__ __forceinline__ void mma3_rows(float (&acc)[NT][4], int k_steps,
                                          FA a_at, FB b_at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ka = ROW_K ? 2 * t : t, kb = ROW_K ? 2 * t + 1 : t + 4;
  for (int ks = 0; ks < k_steps; ++ks) {
    const int k0 = 8 * ks;
    FragA a;
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // (g, ka), (g + 8, ka), (g, kb), ...
      const uint2 v = tf32_pair(a_at(e & 1, k0 + (e < 2 ? ka : kb)));
      a.hi[e] = v.x;
      a.lo[e] = v.y;
    }
    FragB b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint2 v0 = tf32_pair(b_at(k0 + ka, 8 * j + g));
      const uint2 v1 = tf32_pair(b_at(k0 + kb, 8 * j + g));
      b[j].hi[0] = v0.x;
      b[j].lo[0] = v0.y;
      b[j].hi[1] = v1.x;
      b[j].lo[1] = v1.y;
    }
    mma3_tiles<NT>(acc, a, b);
  }
}

// Stage rows [0, rows) of `cols` f32 (cols % 4 == 0) from `src` (row r at
// src + r * src_stride, 16-byte aligned) into shared memory (row stride
// dst_stride) with 16-byte cp.async; rows >= n are zero-filled.
__device__ __forceinline__ void stage_rows(float* dst, int dst_stride,
                                           const float* src,
                                           long long src_stride, int rows,
                                           int n, int cols) {
  const int cpr = cols / 4;
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int r = e / cpr, q = e - r * cpr;
    const bool ok = r < n;
    cp_async16(dst + r * dst_stride + 4 * q,
               ok ? src + r * src_stride + 4 * q : src, ok);
  }
}

// Cross-chunk carry of a chunked scan.  `states` holds the chunk-local end
// states (B, nc, H, E) (E = rows * cols f32 per state); `decay` the
// whole-chunk decays, one per (b, c, h) (PER_ROW false) or one per state
// row (B, nc, H, rows).  Walking the chunks in order, each thread keeps
// four consecutive elements of one state:
//   start[c] = s;   s = decay[c] * s + local[c]
// start[c] overwrites local[c] in place; s starts from state_in (zeros
// when null) and ends in state_out (B, H, E).  The loads of kAhead chunks
// are issued together (they do not wait on the chain).  Grid
// (ceil(E / 4 / 256), B * H), 256 threads.
template <bool PER_ROW>
__global__ void __launch_bounds__(256) carry_kernel(
    float* __restrict__ states, const float* __restrict__ decay,
    const float* __restrict__ state_in, float* __restrict__ state_out,
    int nc, int n_heads, int rows, int cols) {
  constexpr int kAhead = 8;
  const int e4 = blockIdx.x * blockDim.x + threadIdx.x;
  const int n4 = rows * cols / 4;
  if (e4 >= n4) return;
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int row = 4 * e4 / cols;
  const long long E = (long long)rows * cols;
  float4 s = state_in ? reinterpret_cast<const float4*>(state_in + bh * E)[e4]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  auto at = [&](int c) {
    return reinterpret_cast<float4*>(
               states + (((long long)b * nc + c) * n_heads + h) * E) +
           e4;
  };
  auto dec = [&](int c) {
    const long long i = ((long long)b * nc + c) * n_heads + h;
    return PER_ROW ? decay[i * rows + row] : decay[i];
  };
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 loc[kAhead];
    float a[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 + i < nc) {
        loc[i] = *at(c0 + i);
        a[i] = dec(c0 + i);
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 + i < nc) {
        *at(c0 + i) = s;
        s = make_float4(fmaf(a[i], s.x, loc[i].x), fmaf(a[i], s.y, loc[i].y),
                        fmaf(a[i], s.z, loc[i].z), fmaf(a[i], s.w, loc[i].w));
      }
  }
  reinterpret_cast<float4*>(state_out + bh * E)[e4] = s;
}

template <bool PER_ROW>
int launch_carry(float* states, const float* decay, const float* state_in,
                 float* state_out, int n_rows, int nc, int n_heads, int rows,
                 int cols, cudaStream_t stream) {
  const int n4 = rows * cols / 4;
  const dim3 grid((n4 + 255) / 256, n_rows * n_heads);
  carry_kernel<PER_ROW><<<grid, 256, 0, stream>>>(
      states, decay, state_in, state_out, nc, n_heads, rows, cols);
  return (int)cudaGetLastError();
}

// Opt a kernel into `bytes` of dynamic shared memory (above the default
// 48 KB), once per kernel.
template <class K>
cudaError_t smem_opt_in(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

}  // namespace repro
