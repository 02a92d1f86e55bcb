// K3: the RWKV6 (Finch) WKV recurrence with carried state in and out.
//
// Replaces the TPU kernel
//   src/repro/kernels/wkv6/wkv6.py:70 wkv6_bh (pallas_call at :92),
//   wrapper ops.py:27.
// It computes, per (batch row b, head h), over exactly S tokens:
//   out_t = r_t . (S_{t-1} + u (*) k_t v_t^T)
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(lw_t)
// from a carried (hd, hd) f32 state (zeros when none is given), and writes
// the final state.  The TPU kernel pads S to its chunk with zeros, which
// leave the state unchanged; this kernel walks the S real steps and needs
// no padding.
//
// What bounds it on the H100: bytes at serving shapes.  Each token of a
// (b, h) pair reads 4*hd inputs and writes hd outputs (20*hd bytes) for
// ~4*hd^2 f32 flops, ~13 flop/byte at hd = 64: under the CUDA-core ridge
// (67 TFLOP/s over 3.35 TB/s = 20), so moving r/k/v/lw/out once is the
// floor.  The design keeps the state out of device memory for the whole
// sequence: one block of hd threads per (b, h); thread e owns column
// S[:, e] in registers.  A chunk of 32 tokens (16 at hd = 128) of r, k
// and w = exp(lw) is staged in shared memory with coalesced loads (thread
// e reads element e of each token), then every thread walks the chunk:
// all threads read the same r[d], k[d], w[d] (shared-memory broadcast),
// and each reads only its own v_t[e] from device memory.  The recurrence runs step by step; it
// equals the reference's chunked form in exact arithmetic.  A chunked
// tensor-core (wgmma) design is later work.
//
// Layout: r, k, v, lw (B, S, H, hd) f32 read through their (b, s, h)
// strides (the model's own layout, no transposes); u (H, hd); state_in /
// state_out (B, H, hd, hd) contiguous; out (B, S, H, hd) contiguous.
#include "common.cuh"

using namespace repro;

namespace {

struct SeqStrides {
  long long b[4], s[4], h[4];  // r, k, v, lw
};

template <int HD>
__global__ void __launch_bounds__(HD) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lw,
    const float* __restrict__ u, const float* __restrict__ state_in,
    float* __restrict__ out, float* __restrict__ state_out, int seq,
    int n_heads, SeqStrides st) {
  // tokens staged per pass: 3 * chunk * hd f32 of static shared memory,
  // which must stay under 48 KB
  constexpr int kChunk = HD <= 64 ? 32 : 16;
  __shared__ float r_s[kChunk][HD];
  __shared__ float k_s[kChunk][HD];
  __shared__ float w_s[kChunk][HD];
  __shared__ float u_s[HD];

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int e = threadIdx.x;
  const float* rb = r + b * st.b[0] + h * st.h[0];
  const float* kb = k + b * st.b[1] + h * st.h[1];
  const float* vb = v + b * st.b[2] + h * st.h[2];
  const float* lb = lw + b * st.b[3] + h * st.h[3];

  float S[HD];  // S[d] = state[d][e]
  const long long sbase = (long long)bh * HD * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d)
    S[d] = state_in ? state_in[sbase + d * HD + e] : 0.f;
  u_s[e] = u[h * HD + e];

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int n = min(kChunk, seq - t0);
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const long long t = t0 + i;
      r_s[i][e] = rb[t * st.s[0] + e];
      k_s[i][e] = kb[t * st.s[1] + e];
      w_s[i][e] = expf(lb[t * st.s[3] + e]);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const long long t = t0 + i;
      const float ve = vb[t * st.s[2] + e];
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        const float rd = r_s[i][d], kd = k_s[i][d];
        acc = fmaf(rd, S[d], acc);
        bonus = fmaf(rd * u_s[d], kd, bonus);
        S[d] = fmaf(w_s[i][d], S[d], kd * ve);
      }
      out[((long long)b * seq + t) * n_heads * HD + h * HD + e] =
          fmaf(bonus, ve, acc);
    }
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) state_out[sbase + d * HD + e] = S[d];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* state_in, float* out,
           float* state_out, int n_rows, int seq, int n_heads,
           const SeqStrides& st, cudaStream_t stream) {
  wkv6_kernel<HD><<<n_rows * n_heads, HD, 0, stream>>>(
      r, k, v, lw, u, state_in, out, state_out, seq, n_heads, st);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, lw (B, S, H, hd) f32 with element strides
// strides = {r: b, s, h; k: b, s, h; v: b, s, h; lw: b, s, h} (last dims
// contiguous); u (H, hd) f32; state_in (B, H, hd, hd) f32 or null (zeros);
// out (B, S, H, hd) and state_out (B, H, hd, hd) f32 contiguous.  hd in
// {16, 32, 64, 128}.  Returns cudaGetLastError() after the launch, or
// kUnsupportedShape.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* lw, const void* u,
                           const void* state_in, void* out, void* state_out,
                           int n_rows, int seq, int n_heads, int hd,
                           const long long* strides, void* stream) {
  if (n_rows * n_heads == 0) return 0;
  SeqStrides st;
  for (int i = 0; i < 4; ++i) {
    st.b[i] = strides[3 * i];
    st.s[i] = strides[3 * i + 1];
    st.h[i] = strides[3 * i + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
#define REPRO_HD(D)                                                         \
  case D:                                                                   \
    return launch<D>(f(r), f(k), f(v), f(lw), f(u), f(state_in),            \
                     static_cast<float*>(out),                              \
                     static_cast<float*>(state_out), n_rows, seq, n_heads,  \
                     st, s);
  switch (hd) {
    REPRO_HD(16)
    REPRO_HD(32)
    REPRO_HD(64)
    REPRO_HD(128)
    default:
      return kUnsupportedShape;
  }
#undef REPRO_HD
}
