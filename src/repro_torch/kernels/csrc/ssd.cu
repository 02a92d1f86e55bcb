// K4: the Mamba2 SSD scan with carried state in and out.
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd/ssd.py:76 ssd_bh (pallas_call at :100),
//   wrapper ops.py:27.
// It computes, per (batch row b, head h), over exactly S tokens:
//   s_t = exp(dt_t A_h) s_{t-1} + dt_t x_t B_t^T     (s: (p, n) f32)
//   y_t = s_t C_t + D_h x_t
// with B/C shared by all heads of a row (one group), from a carried state
// (zeros when none is given), and writes the final state.  The TPU kernel
// pads S to its chunk (dt = 0 leaves the state unchanged); this kernel
// walks the S real steps and needs no padding.
//
// What bounds it on the H100: operations at serving shapes.  Each token of
// a (b, h) pair does 4*p*n f32 flops (the state update and the C product)
// for ~8*p + 8*n/H bytes of traffic, ~31 flop/byte at p = n = 64: above
// the CUDA-core ridge (67 TFLOP/s over 3.35 TB/s = 20).  The design keeps
// the state out of device memory for the whole sequence and does each flop
// once: one block of p threads per (b, h); thread i owns row s[i, :] (n
// f32 values) in registers.  A chunk of 32 tokens of B, C (head-shared, so
// every head's block reads the same rows, from L2 after the first) and dt
// is staged in shared memory with coalesced loads; all threads then read
// the same B_t[j], C_t[j] (shared-memory broadcast) and their own x_t[i].
// The recurrence runs step by step; it equals the reference's chunked form
// in exact arithmetic.  A chunked tensor-core (wgmma) design is later work.
//
// Layout: x (B, S, H, p), Bm/Cm (B, S, n), dt (B, S, H), all f32 read
// through their strides (the model's own layout, no transposes); A, D (H,);
// state_in / state_out (B, H, p, n) contiguous; y (B, S, H, p) contiguous.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kChunk = 32;

struct ScanStrides {
  long long xb, xs, xh, bb, bs, cb, cs, db, ds, dh;
};

template <int N>
__global__ void ssd_kernel(const float* __restrict__ x,
                           const float* __restrict__ bm,
                           const float* __restrict__ cm,
                           const float* __restrict__ dt,
                           const float* __restrict__ a_rate,
                           const float* __restrict__ d_skip,
                           const float* __restrict__ state_in,
                           float* __restrict__ y,
                           float* __restrict__ state_out, int seq,
                           int n_heads, int p, ScanStrides st) {
  __shared__ float b_s[kChunk][N];
  __shared__ float c_s[kChunk][N];
  __shared__ float dt_s[kChunk];

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int i = threadIdx.x;
  const float a_h = a_rate[h], d_h = d_skip[h];
  const float* xb = x + b * st.xb + h * st.xh + i;
  const float* bb = bm + b * st.bb;
  const float* cb = cm + b * st.cb;
  const float* db = dt + b * st.db + h * st.dh;

  float S[N];  // S[j] = state[i][j]
  const long long sbase = ((long long)bh * p + i) * N;
#pragma unroll
  for (int j = 0; j < N; ++j) S[j] = state_in ? state_in[sbase + j] : 0.f;

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int n = min(kChunk, seq - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = i; e < n * N; e += blockDim.x) {
      const int row = e / N, col = e - row * N;
      const long long t = t0 + row;
      b_s[row][col] = bb[t * st.bs + col];
      c_s[row][col] = cb[t * st.cs + col];
    }
    for (int e = i; e < n; e += blockDim.x) dt_s[e] = db[(t0 + e) * st.ds];
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const long long t = t0 + r;
      const float dtr = dt_s[r];
      const float a = expf(dtr * a_h);
      const float xv = xb[t * st.xs];
      const float dx = dtr * xv;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        S[j] = fmaf(a, S[j], dx * b_s[r][j]);
        acc = fmaf(c_s[r][j], S[j], acc);
      }
      y[((long long)b * seq + t) * n_heads * p + (long long)h * p + i] =
          fmaf(d_h, xv, acc);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) state_out[sbase + j] = S[j];
}

template <int N>
int launch(const float* x, const float* bm, const float* cm, const float* dt,
           const float* A, const float* D, const float* state_in, float* y,
           float* state_out, int n_rows, int seq, int n_heads, int p,
           const ScanStrides& st, cudaStream_t stream) {
  ssd_kernel<N><<<n_rows * n_heads, p, 0, stream>>>(
      x, bm, cm, dt, A, D, state_in, y, state_out, seq, n_heads, p, st);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, S, H, p), Bm/Cm (B, S, n), dt (B, S, H), all f32, with element
// strides = {x: b, s, h; Bm: b, s; Cm: b, s; dt: b, s, h} (x, Bm, Cm last
// dims contiguous); A, D (H,) f32; state_in (B, H, p, n) f32 or null
// (zeros); y (B, S, H, p) and state_out (B, H, p, n) f32 contiguous.
// n in {16, 32, 64, 128}, p <= 1024.  Returns cudaGetLastError() after the
// launch, or kUnsupportedShape.
extern "C" int ssd_launch(const void* x, const void* bm, const void* cm,
                          const void* dt, const void* A, const void* D,
                          const void* state_in, void* y, void* state_out,
                          int n_rows, int seq, int n_heads, int p, int n,
                          const long long* strides, void* stream) {
  if (n_rows * n_heads == 0) return 0;
  if (p < 1 || p > 1024) return kUnsupportedShape;
  const ScanStrides st{strides[0], strides[1], strides[2], strides[3],
                       strides[4], strides[5], strides[6], strides[7],
                       strides[8], strides[9]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* q) { return static_cast<const float*>(q); };
#define REPRO_N(NN)                                                        \
  case NN:                                                                 \
    return launch<NN>(f(x), f(bm), f(cm), f(dt), f(A), f(D), f(state_in),  \
                      static_cast<float*>(y),                              \
                      static_cast<float*>(state_out), n_rows, seq,         \
                      n_heads, p, st, s);
  switch (n) {
    REPRO_N(16)
    REPRO_N(32)
    REPRO_N(64)
    REPRO_N(128)
    default:
      return kUnsupportedShape;
  }
#undef REPRO_N
}
