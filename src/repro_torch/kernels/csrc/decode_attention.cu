// K1: single-token decode attention over a pooled KV cache, split over the
// key axis (flash-decoding) with a combine pass.
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
// the card, so the design is about reading only what the mask reaches and
// keeping enough bytes in flight to reach the memory rate:
// * Reach.  Each block intersects its slice of [0, T) with the row's valid
//   range [lo, hi) (from pos, window and kv_len, read on the device) and
//   streams only those positions of the pool's own (B, T, Kv, D) layout,
//   through strides: no transposed copy of the cache is made per call.
// * Parallelism.  The grid is (row * kv-head, split).  The wrapper picks the
//   number of splits from host-known sizes only (B, Kv, T and the tile;
//   ops.decode_plan), never from pos or kv_len: reading those on the host
//   would be a sync in every decode round.  A split that the row's range
//   does not meet writes an empty partial and exits at once.
// * Bytes in flight.  K/V tiles stay in shared memory in their storage type
//   (bf16 as bf16), brought by 16-byte cp.async copies in a two-stage ring:
//   tile i+1 loads while tile i is scored.  K rows are padded to an odd
//   number of 16-byte chunks, so a thread's 16-byte reads of its own key row
//   are bank-conflict free; V rows are read across threads by column.
// Scores, the online softmax (f32, finite -1e30 with masked probabilities
// zeroed and the denominator floored at 1e-30, as the reference) and the
// P.V product run on the CUDA cores in f32.  Each split writes an f32
// partial (m, l, acc[G, Dv]); `decode_combine_kernel` merges the splits of
// a (row, head) in a fixed order (rescale by exp(m_s - m*), sum, divide by
// max(l, 1e-30)), so the result does not change from run to run.  With one
// split the first kernel writes the output itself and no combine runs.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// (head, column pair) output items a thread may own: G * Dv / 2 <= 1024
constexpr int kItems = 8;

__device__ __forceinline__ void unpack(const uint4& raw, float* f, float) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* f,
                                       __nv_bfloat16) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Start the cp.async copies of one (tile x d) slab: rows t0 .. t0+tile of a
// strided source into shared rows of `stride` 16-byte chunks; rows at or
// beyond `end` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_slab(uint4* dst, int stride,
                                          const T* src, long long src_stride,
                                          int t0, int end, int tile,
                                          int chunks) {
  constexpr int kEpc = 16 / sizeof(T);
  for (int i = threadIdx.x; i < tile * chunks; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const bool ok = t0 + r < end;
    const T* s = src + (ok ? (long long)(t0 + r) * src_stride + c * kEpc : 0);
    cp_async16(dst + r * stride + c, s, ok);
  }
}

template <typename T, int GM>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ pos,
    const int* __restrict__ kv_len, const float* __restrict__ slopes,
    T* __restrict__ out, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int t_len,
    int n_kv, int group, int dk, int dv, long long sk_b, long long sk_t,
    long long sk_h, long long sv_b, long long sv_t, long long sv_h,
    int window, int causal, float scale, int tile, int chunk) {
  constexpr int kEpc = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int bk = blockIdx.x;  // b * n_kv + kvh
  const int b = bk / n_kv, kvh = bk - b * n_kv;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_pair = dv / 2, n_items = group * n_pair;
  const long long head0 = (long long)bk * group;  // b * H + kvh * G

  // the positions the mask can reach, within this split's slice
  const int p = pos[b];
  const int kvl = kv_len ? kv_len[b] : t_len;
  int hi = min(kvl, t_len), lo = 0;
  if (causal) {
    hi = min(hi, p + 1);
    lo = max(0, p - window + 1);
  }
  const int s0 = split * chunk;
  lo = max(lo, s0);
  hi = min(hi, s0 + chunk);

  if (lo >= hi) {  // empty: zeros, or an empty partial (m = -inf, l = 0)
    for (int j = 0; j < kItems; ++j) {
      const int i = tid + j * kThreads;
      if (i >= n_items) break;
      const int g = i / n_pair, c = 2 * (i - g * n_pair);
      if (n_split == 1) {
        T* o = out + (head0 + g) * dv + c;
        o[0] = from_f<T>(0.f);
        o[1] = from_f<T>(0.f);
      } else {
        float* a = part_acc + ((long long)split * gridDim.x * group + head0 +
                               g) * dv + c;
        a[0] = 0.f;
        a[1] = 0.f;
      }
    }
    if (n_split > 1 && tid < group) {
      const long long at = (long long)split * gridDim.x * group + head0 + tid;
      part_m[at] = kNegInf;
      part_l[at] = 0.f;
    }
    return;
  }

  const int ck = dk / kEpc, cv = dv / kEpc, kst = odd_stride(ck);
  const int stage_chunks = tile * (kst + cv);
  uint4* stages = reinterpret_cast<uint4*>(smem);
  float* q_s = reinterpret_cast<float*>(stages + 2 * stage_chunks);
  float* p_s = q_s + group * dk;          // group * tile
  float* red_max = p_s + group * tile;    // kWarps * GM
  float* red_sum = red_max + kWarps * GM; // kWarps * GM
  float* corr_s = red_sum + kWarps * GM;  // GM

  const T* kb = k + b * sk_b + kvh * sk_h;
  const T* vb = v + b * sv_b + kvh * sv_h;
  const int t_first = s0 + ((lo - s0) / tile) * tile;
  const int n_tiles = (hi - t_first + tile - 1) / tile;

  // prologue: tile 0 in flight while the query is staged
  load_slab(stages, kst, kb, sk_t, t_first, hi, tile, ck);
  load_slab(stages + tile * kst, cv, vb, sv_t, t_first, hi, tile, cv);
  cp_async_commit();
  const T* qb = q + head0 * dk;
  for (int i = tid; i < group * dk; i += kThreads) q_s[i] = to_f(qb[i]);

  const int tpk = kThreads / tile;  // threads sharing one key: 1, 2, 4, 8
  const int key = tid / tpk, part = tid - key * tpk;
  float slope[GM], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    slope[g] = (slopes && g < group) ? slopes[kvh * group + g] : 0.f;
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  float acc[kItems][2];
#pragma unroll
  for (int j = 0; j < kItems; ++j) acc[j][0] = acc[j][1] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_first + it * tile;
    if (it + 1 < n_tiles) {
      uint4* nxt = stages + ((it + 1) & 1) * stage_chunks;
      load_slab(nxt, kst, kb, sk_t, t0 + tile, hi, tile, ck);
      load_slab(nxt + tile * kst, cv, vb, sv_t, t0 + tile, hi, tile, cv);
    }
    cp_async_commit();  // (possibly empty) group: keeps the count uniform
    cp_async_wait<1>();
    __syncthreads();
    const uint4* k_st = stages + (it & 1) * stage_chunks;
    const T* v_st = reinterpret_cast<const T*>(k_st + tile * kst);
    const int n = min(tile, hi - t0);

    // scores: tpk threads per key, each over every tpk-th 16-byte chunk
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    const uint4* krow = k_st + key * kst;
    for (int c = part; c < ck; c += tpk) {
      float kf[kEpc];
      unpack(krow[c], kf, T());
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < group) {
          const float4* qv =
              reinterpret_cast<const float4*>(q_s + g * dk + c * kEpc);
#pragma unroll
          for (int e = 0; e < kEpc / 4; ++e) {
            const float4 qq = qv[e];
            s[g] = fmaf(qq.x, kf[4 * e], s[g]);
            s[g] = fmaf(qq.y, kf[4 * e + 1], s[g]);
            s[g] = fmaf(qq.z, kf[4 * e + 2], s[g]);
            s[g] = fmaf(qq.w, kf[4 * e + 3], s[g]);
          }
        }
      }
    }
    const int kp = t0 + key;
    const bool ok = key < n && kp >= lo;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      for (int o = 1; o < tpk; o <<= 1)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      float val = s[g] * scale;
      if (slopes) val += slope[g] * -fabsf((float)(p - kp));
      s[g] = ok ? val : kNegInf;
      const float mx = warp_max(s[g]);
      if (lane == 0) red_max[warp * GM + g] = mx;
    }
    __syncthreads();

    float corr[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = red_max[g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red_max[w * GM + g]);
      const float m_new = fmaxf(m[g], mx);
      corr[g] = expf(m[g] - m_new);
      m[g] = m_new;
      const float e = ok ? expf(s[g] - m_new) : 0.f;
      if (part == 0 && g < group) p_s[g * tile + key] = e;
      const float sum = warp_sum(part == 0 ? e : 0.f);
      if (lane == 0) red_sum[warp * GM + g] = sum;
      if (tid == 0) corr_s[g] = corr[g];
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red_sum[w * GM + g];
      l[g] = l[g] * corr[g] + sum;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = tid + j * kThreads;
      if (i < n_items) {
        const int g = i / n_pair, c = 2 * (i - g * n_pair);
        const float* pr = p_s + g * tile;
        const T* vc = v_st + c;
        // four independent partial sums: the loop is not one long chain
        float2 ps[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) ps[u] = make_float2(0.f, 0.f);
        int t = 0;
        for (; t + 4 <= n; t += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float pt = pr[t + u];
            const float2 vv = load_pair(vc + (t + u) * dv);
            ps[u].x = fmaf(pt, vv.x, ps[u].x);
            ps[u].y = fmaf(pt, vv.y, ps[u].y);
          }
        }
        for (; t < n; ++t) {
          const float pt = pr[t];
          const float2 vv = load_pair(vc + t * dv);
          ps[0].x = fmaf(pt, vv.x, ps[0].x);
          ps[0].y = fmaf(pt, vv.y, ps[0].y);
        }
        const float cr = corr_s[g];
        acc[j][0] = fmaf(acc[j][0], cr,
                         (ps[0].x + ps[1].x) + (ps[2].x + ps[3].x));
        acc[j][1] = fmaf(acc[j][1], cr,
                         (ps[0].y + ps[1].y) + (ps[2].y + ps[3].y));
      }
    }
    __syncthreads();  // this stage and p_s are free for the next tile
  }

  // epilogue: l and m are replicated in every thread; the items index the
  // head at run time, so pass them through shared memory
  float* l_s = red_max;  // GM
  float* m_s = red_sum;  // GM
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      l_s[g] = l[g];
      m_s[g] = m[g];
    }
  }
  __syncthreads();
  const long long row0 = (long long)split * gridDim.x * group + head0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = tid + j * kThreads;
    if (i >= n_items) continue;
    const int g = i / n_pair, c = 2 * (i - g * n_pair);
    if (n_split == 1) {
      const float den = fmaxf(l_s[g], 1e-30f);
      T* o = out + (head0 + g) * dv + c;
      o[0] = from_f<T>(acc[j][0] / den);
      o[1] = from_f<T>(acc[j][1] / den);
    } else {
      float* a = part_acc + (row0 + g) * dv + c;
      a[0] = acc[j][0];
      a[1] = acc[j][1];
    }
  }
  if (n_split > 1 && tid < group) {
    part_m[row0 + tid] = m_s[tid];
    part_l[row0 + tid] = l_s[tid];
  }
}

// One block per (row, head): merge the n_split partials in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ out, int n_heads_all,
    int n_split, int dv) {
  const int bh = blockIdx.x;
  float ms = kNegInf;
  for (int s = 0; s < n_split; ++s)
    ms = fmaxf(ms, part_m[(long long)s * n_heads_all + bh]);
  float den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const long long at = (long long)s * n_heads_all + bh;
    den += expf(part_m[at] - ms) * part_l[at];
  }
  den = fmaxf(den, 1e-30f);
  for (int c = threadIdx.x; c < dv; c += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long long at = (long long)s * n_heads_all + bh;
      a += expf(part_m[at] - ms) * part_acc[at * dv + c];
    }
    out[(long long)bh * dv + c] = from_f<T>(a / den);
  }
}

size_t smem_bytes(int group, int gm, int dk, int dv, int tile, int esize) {
  const int epc = 16 / esize;
  const size_t stage = (size_t)tile * (odd_stride(dk / epc) + dv / epc) * 16;
  return 2 * stage + sizeof(float) * ((size_t)group * dk +
                                      (size_t)group * tile +
                                      (size_t)(2 * kWarps + 1) * gm);
}

template <typename T, int GM>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* kv_len, const void* slopes, void* out, void* part_m,
           void* part_l, void* part_acc, int n_rows, int t_len, int n_kv,
           int group, int dk, int dv, const long long* st, int window,
           int causal, float scale, int tile, int chunk, int n_split,
           cudaStream_t stream) {
  constexpr size_t kMaxSmem = 232448;  // 227 KB: the per-block opt-in limit
  const size_t smem = smem_bytes(group, GM, dk, dv, tile, sizeof(T));
  if (smem > kMaxSmem) return kUnsupportedShape;
  auto kern = decode_split_kernel<T, GM>;
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  kern<<<dim3(n_rows * n_kv, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(kv_len), static_cast<const float*>(slopes),
      static_cast<T*>(out), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), t_len, n_kv,
      group, dk, dv, st[0], st[1], st[2], st[3], st[4], st[5], window, causal,
      scale, tile, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const int n_heads_all = n_rows * n_kv * group;
  decode_combine_kernel<T><<<n_heads_all, kThreads, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(out), n_heads_all,
      n_split, dv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_group(int group, const void* q, const void* k, const void* v,
                 const void* pos, const void* kv_len, const void* slopes,
                 void* out, void* part_m, void* part_l, void* part_acc,
                 int n_rows, int t_len, int n_kv, int dk, int dv,
                 const long long* st, int window, int causal, float scale,
                 int tile, int chunk, int n_split, cudaStream_t stream) {
  constexpr int kEpc = 16 / sizeof(T);
  if (dk % kEpc || dv % kEpc || dk <= 0 || dv <= 0 || tile < 16 ||
      tile > kThreads || kThreads % tile || chunk % tile ||
      group * dv / 2 > kItems * kThreads)
    return kUnsupportedShape;
#define REPRO_GM(N)                                                         \
  if (group <= N)                                                           \
    return launch<T, N>(q, k, v, pos, kv_len, slopes, out, part_m, part_l, \
                        part_acc, n_rows, t_len, n_kv, group, dk, dv, st,  \
                        window, causal, scale, tile, chunk, n_split, stream);
  REPRO_GM(1)
  REPRO_GM(2)
  REPRO_GM(4)
  REPRO_GM(8)
#undef REPRO_GM
  return kUnsupportedShape;
}

}  // namespace

// q (B, H, Dk) contiguous; k (B, T, Kv, Dk) and v (B, T, Kv, Dv) with
// element strides st = {k: b, t, h; v: b, t, h} (last dim contiguous, rows
// 16-byte aligned); pos, kv_len (B,) int32 (kv_len may be null: T); slopes
// (H,) f32 or null; out (B, H, Dv) contiguous.  The key axis is cut into
// n_split slices of `chunk` positions (a multiple of `tile`); with
// n_split > 1, part_m / part_l (n_split, B*H) and part_acc
// (n_split, B*H, Dv) are f32 scratch.  Returns cudaGetLastError() after the
// launches, or kUnsupportedShape.
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v, const void* pos,
    const void* kv_len, const void* slopes, void* out, void* part_m,
    void* part_l, void* part_acc, int n_rows, int t_len, int n_kv, int group,
    int dk, int dv, const long long* strides, int window, int causal,
    float scale, int tile, int chunk, int n_split, void* stream) {
  if (n_rows * n_kv == 0) return 0;
  if (n_split < 1 || (n_split > 1 && !(part_m && part_l && part_acc)))
    return kUnsupportedShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_group<float>(group, q, k, v, pos, kv_len, slopes, out,
                               part_m, part_l, part_acc, n_rows, t_len, n_kv,
                               dk, dv, strides, window, causal, scale, tile,
                               chunk, n_split, s);
  if (dtype == kBFloat16)
    return launch_group<__nv_bfloat16>(
        group, q, k, v, pos, kv_len, slopes, out, part_m, part_l, part_acc,
        n_rows, t_len, n_kv, dk, dv, strides, window, causal, scale, tile,
        chunk, n_split, s);
  return kUnsupportedShape;
}
