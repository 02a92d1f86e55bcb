// K2: prefill (flash) attention with an online softmax over key tiles.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:105
//   flash_attention_bhsd (pallas_call at :138), wrapper ops.py:53.
// It computes causal prefill attention over aligned positions (queries at
// q_start + arange(Sq), keys at arange(Skv)), GQA by mapping head h to
// kv-head h / (H/Kv) with no K/V copy, a runtime `q_start` (chunked
// prefill: the chunk's queries over the cached prefix plus the chunk), a
// sliding `window`, per-head ALiBi `slopes`, and the non-causal Sq != Skv,
// Dv != Dk case.
//
// What bounds it on the H100: operations.  A tile pair does
// 2*BQ*BKV*(Dk+Dv) flops for (BQ+BKV)*D loads, so prefill at real lengths is
// compute bound.  This kernel serves the f32 calls only (the parity models,
// held to 1e-5: a TF32 tensor-core product would miss that); bf16 goes to
// the tensor-core kernel in flash_attention_sm90.cu.  It keeps q, K, V, P
// in shared memory in f32 and register-tiles the two products on the CUDA
// cores (each thread owns a 4x8 block of the score tile and a 4x(Dv/8)
// block of the output), with the f32 online softmax of the reference, so it
// is bound by the 67 TFLOP/s f32 rate.  Work above the causal diagonal and
// below the window is never loaded: the key loop runs only over tiles the
// block's queries can see, from `q_start` and `window`.  At Dk = Dv = 224
// (zamba2) the tiles take 189,440 bytes of shared memory (opted in at
// launch) and each thread holds 4 x 28 output accumulators.
//
// Layout: q (B, Sq, H, Dk), k (B, Skv, Kv, Dk), v (B, Skv, Kv, Dv) read
// through their strides (the model's own layout, no transposes); out
// (B, Sq, H, Dv) contiguous.  One 128-thread block per (b*H + h, q-tile).
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kThreads = 128;

template <int DK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (DK + 1) + (size_t)kBKV * (DK + 1) +
                          (size_t)kBKV * (DV + 1) + (size_t)kBQ * (kBKV + 1));
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ slopes,
    T* __restrict__ out, int seq_q, int seq_kv, int n_heads, int n_kv,
    long long sq_b, long long sq_s, long long sq_h, long long sk_b,
    long long sk_s, long long sk_h, long long sv_b, long long sv_s,
    long long sv_h, int window, int causal, int q_start, float scale) {
  constexpr int QP = DK + 1, KP = DK + 1, VP = DV + 1, PP = kBKV + 1;
  constexpr int NC = DV / 8;
  extern __shared__ float smem[];
  float* q_s = smem;            // kBQ * QP
  float* k_s = q_s + kBQ * QP;  // kBKV * KP
  float* v_s = k_s + kBKV * KP; // kBKV * VP
  float* p_s = v_s + kBKV * VP; // kBQ * PP

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = blockIdx.y * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = lane & 7;                    // 8 key / value columns
  const int r0 = (warp * 4 + (lane >> 3)) * 4;  // 4 query rows

  stage_tile<8>(q_s, QP, q + b * sq_b + h * sq_h + (long long)q0 * sq_s,
                sq_s, kBQ, min(kBQ, seq_q - q0), DK);
  const T* kb = k + b * sk_b + kvh * sk_h;
  const T* vb = v + b * sv_b + kvh * sv_h;
  const float slope = slopes ? slopes[h] : 0.f;

  // keys the block's queries can see: [kv_lo, kv_hi)
  int kv_lo = 0, kv_hi = seq_kv;
  if (causal) {
    kv_hi = min(seq_kv, q_start + min(q0 + kBQ, seq_q));
    kv_lo = max(0, q_start + q0 - window + 1);
  }

  float o[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }

  for (int kv0 = (kv_lo / kBKV) * kBKV; kv0 < kv_hi; kv0 += kBKV) {
    const int n = min(kBKV, seq_kv - kv0);
    __syncthreads();  // previous tile's readers are done
    stage_tile<8>(k_s, KP, kb + (long long)kv0 * sk_s, sk_s, kBKV, n, DK);
    stage_tile<8>(v_s, VP, vb + (long long)kv0 * sv_s, sv_s, kBKV, n, DV);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(r0 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = k_s[(tx + 8 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qa = q_start + q0 + r0 + i;
      unsigned ok_bits = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = kv0 + tx + 8 * j;
        const int diff = qa - kp;
        bool ok = kp < seq_kv;
        if (causal) ok = ok && diff >= 0 && diff < window;
        float val = s[i][j] * scale;
        if (slopes) val += slope * -fabsf((float)diff);
        s[i][j] = ok ? val : kNegInf;
        ok_bits |= (ok ? 1u : 0u) << j;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = (ok_bits >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        p_s[(r0 + i) * PP + tx + 8 * j] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(r0 + i) * PP + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = v_s[t * VP + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], vv, o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sq = q0 + r0 + i;
    if (sq >= seq_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + (((long long)b * seq_q + sq) * n_heads + h) * DV;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 8 * c] = from_f<T>(o[i][c] / denom);
  }
}

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* slopes,
           void* out, int n_rows, int seq_q, int seq_kv, int n_heads,
           int n_kv, const long long* st, int window, int causal,
           int q_start, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK, DV>();
  auto kern = flash_attention_kernel<T, DK, DV>;
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  dim3 grid(n_rows * n_heads, (seq_q + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(slopes),
      static_cast<T*>(out), seq_q, seq_kv, n_heads, n_kv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], window, causal,
      q_start, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DK>
int launch_dv(int dv, const void* q, const void* k, const void* v,
              const void* slopes, void* out, int n_rows, int seq_q,
              int seq_kv, int n_heads, int n_kv, const long long* st,
              int window, int causal, int q_start, float scale,
              cudaStream_t stream) {
#define REPRO_DV(D)                                                        \
  case D:                                                                  \
    return launch<T, DK, D>(q, k, v, slopes, out, n_rows, seq_q, seq_kv,   \
                            n_heads, n_kv, st, window, causal, q_start,    \
                            scale, stream);
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

template <typename T>
int launch_dk(int dk, int dv, const void* q, const void* k, const void* v,
              const void* slopes, void* out, int n_rows, int seq_q,
              int seq_kv, int n_heads, int n_kv, const long long* st,
              int window, int causal, int q_start, float scale,
              cudaStream_t stream) {
#define REPRO_DK(D)                                                          \
  case D:                                                                    \
    return launch_dv<T, D>(dv, q, k, v, slopes, out, n_rows, seq_q, seq_kv,  \
                           n_heads, n_kv, st, window, causal, q_start,       \
                           scale, stream);
  switch (dk) {
    REPRO_DK(16)
    REPRO_DK(32)
    REPRO_DK(64)
    REPRO_DK(128)
    case 224:  // zamba2's shared attention: only the (224, 224) pair
      if (dv != 224) return kUnsupportedShape;
      return launch<T, 224, 224>(q, k, v, slopes, out, n_rows, seq_q, seq_kv,
                                 n_heads, n_kv, st, window, causal, q_start,
                                 scale, stream);
    default:
      return kUnsupportedShape;
  }
#undef REPRO_DK
}

}  // namespace

// f32 only.  q (B, Sq, H, Dk), k (B, Skv, Kv, Dk), v (B, Skv, Kv, Dv) with
// element strides st = {q: b, s, h; k: b, s, h; v: b, s, h} (last dims
// contiguous); slopes (H,) f32 or null; out (B, Sq, H, Dv) contiguous.
// Dk, Dv in {16, 32, 64, 128}, or Dk = Dv = 224.  Returns
// cudaGetLastError() after the launch, or kUnsupportedShape.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* slopes,
    void* out, int n_rows, int seq_q, int seq_kv, int n_heads, int n_kv,
    int dk, int dv, const long long* strides, int window, int causal,
    int q_start, float scale, void* stream) {
  if (n_rows * n_heads == 0 || seq_q == 0) return 0;
  return launch_dk<float>(dk, dv, q, k, v, slopes, out, n_rows, seq_q,
                          seq_kv, n_heads, n_kv, strides, window, causal,
                          q_start, scale, static_cast<cudaStream_t>(stream));
}
