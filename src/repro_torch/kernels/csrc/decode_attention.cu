// K1: single-token decode attention over a pooled KV cache.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:111
//   decode_attention_bkv (pallas_call at :150), wrapper ops.py:45.
// It computes, for every (row b, kv-head) pair, the G = H/Kv query heads of
// the group against that head's cache, with the reference's masking:
// per-row `pos` and `kv_len`, a sliding `window` (causal only), ALiBi
// `slopes` (H,), a caller `scale`, and Dk != Dv.
//
// What bounds it on the H100: bytes.  Decode reads each cached K/V row once
// and does 2*G*(Dk+Dv) flops per row, far below the ~295 flop/byte ridge of
// the card.  The design therefore reads only what the mask can reach: the
// block computes the valid range [lo, hi) of its row from pos, window and
// kv_len and streams just those positions, so a decode step reads the
// written prefix of a max_seq_len row, not the whole row.  The K/V layout is
// the pool's own (B, T, Kv, D) with strides: no transposed copy of the cache
// is made per call.  Each tile of keys is staged in shared memory in f32
// with coalesced loads, issued in independent batches (`stage_tile`) so
// the block has many loads in flight.  Scores, the online softmax (f32,
// finite -1e30 with masked probabilities zeroed and the denominator
// floored at 1e-30, as the reference) and the P.V product run out of
// shared memory.
//
// Simple first design: one 128-thread block per (row, kv-head), CUDA cores,
// no split over the key axis.  At serving batch sizes B*Kv blocks leave most
// of the 132 SMs idle; split-KV (flash-decoding) is the follow-up.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ pos,
    const int* __restrict__ kv_len, const float* __restrict__ slopes,
    T* __restrict__ out, int t_len, int n_kv, int group, int dk, int dv,
    long long sk_b, long long sk_t, long long sk_h, long long sv_b,
    long long sv_t, long long sv_h, int window, int causal, float scale,
    int tile) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / n_kv;
  const int kvh = blockIdx.x % n_kv;
  const int n_heads = n_kv * group;
  const int dkp = dk + 1;  // padded row: conflict-free column reads
  float* q_s = smem;                  // group * dk
  float* k_s = q_s + group * dk;      // tile * (dk + 1)
  float* v_s = k_s + tile * dkp;      // tile * dv
  float* p_s = v_s + tile * dv;       // group * tile
  float* acc_s = p_s + group * tile;  // group * dv
  float* m_s = acc_s + group * dv;    // group
  float* l_s = m_s + group;           // group
  float* c_s = l_s + group;           // group

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // the positions the mask can reach: lo <= kv_pos < hi
  const int p = pos[b];
  const int kvl = kv_len ? kv_len[b] : t_len;
  int hi = min(kvl, t_len);
  int lo = 0;
  if (causal) {
    hi = min(hi, p + 1);
    lo = max(0, p - window + 1);
  }

  const T* qb = q + ((long long)b * n_heads + (long long)kvh * group) * dk;
  for (int i = tid; i < group * dk; i += blockDim.x) q_s[i] = to_f(qb[i]);
  for (int i = tid; i < group * dv; i += blockDim.x) acc_s[i] = 0.f;
  for (int i = tid; i < group; i += blockDim.x) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  const T* kb = k + b * sk_b + kvh * sk_h;
  const T* vb = v + b * sv_b + kvh * sv_h;
  __syncthreads();

  for (int t0 = (lo / tile) * tile; t0 < hi; t0 += tile) {
    const int n = min(tile, hi - t0);
    stage_tile<16>(k_s, dkp, kb + (long long)t0 * sk_t, sk_t, n, n, dk);
    stage_tile<16>(v_s, dv, vb + (long long)t0 * sv_t, sv_t, n, n, dv);
    __syncthreads();

    for (int i = tid; i < group * tile; i += blockDim.x) {
      const int g = i / tile, t = i - g * tile;
      const int kp = t0 + t;
      float s = kNegInf;
      if (t < n && kp >= lo) {
        const float* qr = q_s + g * dk;
        const float* kr = k_s + t * dkp;
        float dot = 0.f;
        for (int d = 0; d < dk; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        if (slopes) s += slopes[kvh * group + g] * -fabsf((float)(p - kp));
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < group; g += n_warps) {
      float* pr = p_s + g * tile;
      float mx = kNegInf;
      for (int t = lane; t < tile; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < tile; t += 32) {
        const bool ok = t < n && t0 + t >= lo;
        const float e = ok ? expf(pr[t] - m_new) : 0.f;
        pr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < group * dv; i += blockDim.x) {
      const int g = i / dv, c = i - g * dv;
      const float* pr = p_s + g * tile;
      float a = acc_s[i] * c_s[g];
      for (int t = 0; t < n; ++t) a = fmaf(pr[t], v_s[t * dv + c], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * n_heads + (long long)kvh * group) * dv;
  for (int i = tid; i < group * dv; i += blockDim.x) {
    const int g = i / dv;
    ob[i] = from_f<T>(acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

size_t smem_bytes(int group, int dk, int dv, int tile) {
  return sizeof(float) * ((size_t)group * dk + (size_t)tile * (dk + 1) +
                          (size_t)tile * dv + (size_t)group * tile +
                          (size_t)group * dv + 3 * (size_t)group);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* kv_len, const void* slopes, void* out, int n_rows,
           int t_len, int n_kv, int group, int dk, int dv, long long sk_b,
           long long sk_t, long long sk_h, long long sv_b, long long sv_t,
           long long sv_h, int window, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t kMaxSmem = 232448;  // 227 KB: the per-block opt-in limit
  int tile = 64;
  while (tile > 8 && smem_bytes(group, dk, dv, tile) > kMaxSmem) tile /= 2;
  const size_t smem = smem_bytes(group, dk, dv, tile);
  if (smem > kMaxSmem) return kUnsupportedShape;
  auto kern = decode_attention_kernel<T>;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = kMaxSmem;
  }
  kern<<<n_rows * n_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(kv_len), static_cast<const float*>(slopes),
      static_cast<T*>(out), t_len, n_kv, group, dk, dv, sk_b, sk_t, sk_h,
      sv_b, sv_t, sv_h, window, causal, scale, tile);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Dk) contiguous; k (B, T, Kv, Dk) and v (B, T, Kv, Dv) with the
// given element strides (last dim contiguous); pos, kv_len (B,) int32
// (kv_len may be null: T); slopes (H,) f32 or null; out (B, H, Dv)
// contiguous.  Returns cudaGetLastError() after the launch, or
// kUnsupportedShape.
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v, const void* pos,
    const void* kv_len, const void* slopes, void* out, int n_rows, int t_len,
    int n_kv, int group, int dk, int dv, long long sk_b, long long sk_t,
    long long sk_h, long long sv_b, long long sv_t, long long sv_h,
    int window, int causal, float scale, void* stream) {
  if (n_rows * n_kv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, pos, kv_len, slopes, out, n_rows, t_len,
                         n_kv, group, dk, dv, sk_b, sk_t, sk_h, sv_b, sv_t,
                         sv_h, window, causal, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, pos, kv_len, slopes, out, n_rows,
                                 t_len, n_kv, group, dk, dv, sk_b, sk_t, sk_h,
                                 sv_b, sv_t, sv_h, window, causal, scale, s);
  return kUnsupportedShape;
}
