// K2 in bf16: prefill (flash) attention on the tensor cores.
//
// Replaces, for bf16 operands, the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:105
//   flash_attention_bhsd (pallas_call at :138), wrapper ops.py:53.
// The same function as csrc/flash_attention.cu, which keeps the f32 calls:
// causal prefill over aligned positions (queries at q_start + arange(Sq),
// keys at arange(Skv)), GQA by mapping head h to kv-head h / (H/Kv) with no
// K/V copy, a runtime `q_start` (chunked prefill), a sliding `window`,
// per-head ALiBi `slopes`, and the non-causal Sq != Skv, Dv != Dk case.
//
// What bounds it on the H100: operations.  A (64 x 64) tile pair does
// 2*64*64*(Dk+Dv) flops for 64*(Dk+Dv) loaded elements, so prefill at real
// lengths is bound by the bf16 tensor cores, which the CUDA-core kernel
// never touched.  This design is the FA2 shape with `mma.sync`:
// * Products on the tensor cores.  One block of 4 warps owns 64 query rows
//   of one (b, h); each warp owns 16 of them.  S = Q.K^T is
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate) with Q and K fragments
//   brought from shared memory by ldmatrix.  Masking and the f32 online
//   softmax run on the accumulator fragment in registers (row max and sum
//   across the 4 lanes that share a row).  P is rounded to bf16 in
//   registers and is the A operand of O += P.V, with V fragments from
//   ldmatrix.trans; O stays in registers until the epilogue.
// * Copies.  Q, K and V rows arrive by 16-byte cp.async straight into
//   shared rows padded to an odd number of 16-byte chunks, which makes every
//   ldmatrix bank-conflict free; K/V use a two-stage ring, so the next tile
//   loads while the current one computes.  Key tiles above the causal
//   diagonal and below the window are never loaded, and tiles that every
//   query row sees whole skip the mask arithmetic.
// * Scheduling.  Query tiles are scheduled longest-first (the last tile of a
//   causal prefill sees the most keys), so the causal tail does not leave
//   SMs idle at the end of the grid.
// This is the lesser of the two Hopper designs: the warpgroup `wgmma` form
// with TMA copies and warp specialisation (FA3) is the next step.
// Budget: at Dk = Dv = 224, 112 f32 O accumulators per thread, 32-key
// stages and 89,088 bytes of shared memory (two blocks per SM); at 64,
// 32 accumulators, 64-key stages and 46,080 bytes.  (Two 16-row tiles per
// warp, 128-key stages or a three-stage ring measured slower on the H100.)
// At Dk = Dv = 256 (gemma3) the O accumulators alone take 128 registers a
// thread; with 32-key stages the whole kernel fits in 239 registers and
// 101,376 bytes of shared memory without spilling (chip_smoke.py's build
// phase fails on a spilling instantiation).  MLA's unabsorbed prefill is
// the first Dk != Dv pair on the tensor cores, (192, 128): the Q.K^T
// ldmatrix walks Dk, the P.V one Dv, with separate row strides.
//
// Layout: q (B, Sq, H, Dk), k (B, Skv, Kv, Dk), v (B, Skv, Kv, Dv) read
// through their strides (the model's own layout, no transposes; rows
// 16-byte aligned); out (B, Sq, H, Dv) contiguous.  Grid (B*H, q-tiles).
#include "common.cuh"

using namespace repro;

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// cp.async a (rows x d) bf16 slab, rows r0 .. r0+rows of a strided source,
// into shared rows of `stride` 16-byte chunks; rows at or beyond `end` are
// zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(uint4* dst, int stride,
                                          const bf16* src,
                                          long long src_stride, int r0,
                                          int end, int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r0 + r < end;
    const bf16* s = src + (ok ? (long long)(r0 + r) * src_stride + c * 8 : 0);
    cp_async16(dst + r * stride + c, s, ok);
  }
}

// Query rows a block owns (4 warps x 16) and keys a K/V stage holds: 64,
// or 32 at head dims above 128, so that two blocks fit an SM there.
constexpr int kBQ = 64;
template <int DK, int DV>
__host__ __device__ constexpr int kv_tile() {
  return (DK > 128 || DV > 128) ? 32 : 64;
}

template <int DK, int DV>
constexpr size_t smem_bytes() {
  return 16 * ((size_t)kBQ * odd_stride(DK / 8) +
               2 * (size_t)kv_tile<DK, DV>() *
                   (odd_stride(DK / 8) + odd_stride(DV / 8)));
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads) flash_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ slopes,
    bf16* __restrict__ out, int seq_q, int seq_kv, int n_heads, int n_kv,
    long long sq_b, long long sq_s, long long sq_h, long long sk_b,
    long long sk_s, long long sk_h, long long sv_b, long long sv_s,
    long long sv_h, int window, int causal, int q_start, float scale) {
  constexpr int BKV = kv_tile<DK, DV>();
  constexpr int QST = odd_stride(DK / 8), KST = QST, VST = odd_stride(DV / 8);
  constexpr int kStage = BKV * (KST + VST);
  constexpr int NT = BKV / 8;  // score n-tiles of 8 keys
  constexpr int ND = DV / 8;   // output n-tiles of 8 columns
  extern __shared__ __align__(16) uint4 smem[];
  uint4* q_s = smem;
  uint4* stages = q_s + kBQ * QST;

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;

  // keys the block's queries can see: [kv_lo, kv_hi)
  int kv_lo = 0, kv_hi = seq_kv;
  if (causal) {
    kv_hi = min(seq_kv, q_start + min(q0 + kBQ, seq_q));
    kv_lo = max(0, q_start + q0 - window + 1);
  }
  const int kv_first = (kv_lo / BKV) * BKV;
  const int n_tiles =
      kv_hi > kv_first ? (kv_hi - kv_first + BKV - 1) / BKV : 0;
  const bf16* kb = k + b * sk_b + kvh * sk_h;
  const bf16* vb = v + b * sv_b + kvh * sv_h;

  load_rows<DK>(q_s, QST, q + b * sq_b + h * sq_h, sq_s, q0, seq_q, kBQ);
  if (n_tiles > 0) {
    load_rows<DK>(stages, KST, kb, sk_s, kv_first, seq_kv, BKV);
    load_rows<DV>(stages + BKV * KST, VST, vb, sv_s, kv_first, seq_kv, BKV);
  }
  cp_async_commit();

  const float slope = slopes ? slopes[h] : 0.f;
  const int qa0 = q_start + q0 + warp * 16 + g;  // rows qa0 and qa0 + 8
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = kv_first + it * BKV;
    if (it + 1 < n_tiles) {
      uint4* nxt = stages + ((it + 1) & 1) * kStage;
      load_rows<DK>(nxt, KST, kb, sk_s, kv0 + BKV, seq_kv, BKV);
      load_rows<DV>(nxt + BKV * KST, VST, vb, sv_s, kv0 + BKV, seq_kv, BKV);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint4* k_st = stages + (it & 1) * kStage;
    const uint4* v_st = k_st + BKV * KST;

    // S = Q K^T: 16 rows x BKV keys per warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      unsigned a[4];
      ldmatrix_x4(a, q_s + (warp * 16 + (lane & 15)) * QST + ks * 2 +
                         (lane >> 4));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bb[4];
        ldmatrix_x4(bb, k_st + (np * 16 + (lane & 7) + (lane >> 4) * 8) * KST +
                            ks * 2 + ((lane >> 3) & 1));
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // mask, scale, ALiBi; online softmax over the two rows of the thread.
    // A tile that every query row of the block sees whole needs no mask.
    const int qmin = q_start + q0;
    const bool full = kv0 + BKV <= seq_kv && !slopes &&
                      (!causal || (kv0 + BKV - 1 <= qmin &&
                                   qmin + kBQ - 1 - kv0 < window));
    unsigned ok_bits = full ? 0xffffffffu : 0u;  // NT * 4 <= 32 bits
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (full) {
          s[j][e] *= scale;
        } else {
          const int kp = kv0 + j * 8 + tig * 2 + (e & 1);
          const int diff = qa0 + (e >> 1) * 8 - kp;
          bool ok = kp < seq_kv;
          if (causal) ok = ok && diff >= 0 && diff < window;
          float val = s[j][e] * scale;
          if (slopes) val += slope * -fabsf((float)diff);
          s[j][e] = ok ? val : kNegInf;
          ok_bits |= (ok ? 1u : 0u) << (j * 4 + e);
        }
        if (e < 2) mx0 = fmaxf(mx0, s[j][e]);
        else mx1 = fmaxf(mx1, s[j][e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (ok_bits >> (j * 4 + e)) & 1u
                            ? __expf(s[j][e] - (e < 2 ? mn0 : mn1))
                            : 0.f;
        s[j][e] = p;
        if (e < 2) sum0 += p;
        else sum1 += p;
      }
    }
    l0 = l0 * c0 + sum0;  // partial over this thread's columns
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }

    // O += P V: P from the score registers (bf16), V by ldmatrix.trans
#pragma unroll
    for (int kt = 0; kt < BKV / 16; ++kt) {
      const unsigned pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                              pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                              pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        unsigned bb[4];
        ldmatrix_x4_trans(
            bb, v_st + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VST +
                    dp * 2 + (lane >> 4));
        mma_bf16(o[2 * dp], pa, bb[0], bb[1]);
        mma_bf16(o[2 * dp + 1], pa, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int sq = r0 + half * 8;
    if (sq >= seq_q) continue;
    const float den = half ? d1 : d0;
    unsigned* orow = reinterpret_cast<unsigned*>(
        out + (((long long)b * seq_q + sq) * n_heads + h) * DV + tig * 2);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      orow[j * 4] = pack_bf16(o[j][2 * half] / den, o[j][2 * half + 1] / den);
  }
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* slopes,
           void* out, int n_rows, int seq_q, int seq_kv, int n_heads,
           int n_kv, const long long* st, int window, int causal,
           int q_start, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK, DV>();
  auto kern = flash_tc_kernel<DK, DV>;
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  dim3 grid(n_rows * n_heads, (seq_q + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(slopes),
      static_cast<bf16*>(out), seq_q, seq_kv, n_heads, n_kv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], window, causal,
      q_start, scale);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_dv(int dv, const void* q, const void* k, const void* v,
              const void* slopes, void* out, int n_rows, int seq_q,
              int seq_kv, int n_heads, int n_kv, const long long* st,
              int window, int causal, int q_start, float scale,
              cudaStream_t stream) {
#define REPRO_DV(D)                                                        \
  case D:                                                                  \
    return launch<DK, D>(q, k, v, slopes, out, n_rows, seq_q, seq_kv,      \
                         n_heads, n_kv, st, window, causal, q_start, scale, \
                         stream);
  switch (dv) {
    REPRO_DV(16)
    REPRO_DV(32)
    REPRO_DV(64)
    REPRO_DV(128)
    default:
      return kUnsupportedShape;
  }
#undef REPRO_DV
}

}  // namespace

// bf16 only.  q (B, Sq, H, Dk), k (B, Skv, Kv, Dk), v (B, Skv, Kv, Dv) with
// element strides st = {q: b, s, h; k: b, s, h; v: b, s, h} (last dims
// contiguous, 16-byte aligned rows); slopes (H,) f32 or null; out
// (B, Sq, H, Dv) contiguous.  Dk, Dv in {16, 32, 64, 128}, or the pairs
// (224, 224), (256, 256) and (192, 128).  Returns cudaGetLastError() after
// the launch, or kUnsupportedShape.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, const void* slopes,
    void* out, int n_rows, int seq_q, int seq_kv, int n_heads, int n_kv,
    int dk, int dv, const long long* strides, int window, int causal,
    int q_start, float scale, void* stream) {
  if (n_rows * n_heads == 0 || seq_q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DK(D)                                                          \
  case D:                                                                    \
    return launch_dv<D>(dv, q, k, v, slopes, out, n_rows, seq_q, seq_kv,     \
                        n_heads, n_kv, strides, window, causal, q_start,     \
                        scale, s);
  switch (dk) {
    REPRO_DK(16)
    REPRO_DK(32)
    REPRO_DK(64)
    REPRO_DK(128)
    case 224:  // zamba2's shared attention: only the (224, 224) pair
      if (dv != 224) return kUnsupportedShape;
      return launch<224, 224>(q, k, v, slopes, out, n_rows, seq_q, seq_kv,
                              n_heads, n_kv, strides, window, causal,
                              q_start, scale, s);
    case 256:  // gemma3: only the (256, 256) pair
      if (dv != 256) return kUnsupportedShape;
      return launch<256, 256>(q, k, v, slopes, out, n_rows, seq_q, seq_kv,
                              n_heads, n_kv, strides, window, causal,
                              q_start, scale, s);
    case 192:  // MLA's unabsorbed prefill: only (nope + rope, nope)
      if (dv != 128) return kUnsupportedShape;
      return launch<192, 128>(q, k, v, slopes, out, n_rows, seq_q, seq_kv,
                              n_heads, n_kv, strides, window, causal,
                              q_start, scale, s);
    default:
      return kUnsupportedShape;
  }
#undef REPRO_DK
}
