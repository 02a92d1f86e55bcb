// K4: the Mamba2 SSD scan with carried state in and out, as a chunked scan
// on the tensor cores.
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd/ssd.py:76 ssd_bh (pallas_call at :100),
//   wrapper ops.py:27.
// It computes, per (batch row b, head h), over exactly S tokens:
//   s_t = exp(dt_t A_h) s_{t-1} + dt_t x_t B_t^T     (s: (p, n) f32)
//   y_t = s_t C_t + D_h x_t
// with B/C shared by all heads of a row (one group), from a carried state
// (zeros when none is given), and writes the final state.
//
// What bounds it on the H100: bytes, at the card's peaks.  The chunked
// form (Dao & Gu 2024, the SSD algorithm; the reference kernel's own form,
// ssd.py:41-69) does ~2 Q p + 4 p n flops a token and head, which at the
// TF32 tensor-core peak (495 TFLOP/s) take less time than moving x and y
// (8 p bytes a token and head) at 3.35 TB/s.  A step-by-step walk instead
// is serial along S and issues one shared-memory load per f32 FMA on the
// CUDA cores.
//
// The design.  Chunks of Q = 128 tokens; seg = the inclusive cumsum of
// dt A_h in the chunk (kept in log2 units, so every decay is one exp2).
// Three phases, each a kernel over (group of heads, chunk, row):
//   local  (ssd_chunk_kernel<kLocal>):  s_local = (x dt exp(seg_end -
//          seg))^T B_c (p x Q . Q x n) and a_chunk = exp(seg_end) to f32
//          scratch;
//   carry  (carry_kernel, scan_tf32.cuh): start[c] = s, s = a_chunk[c] s +
//          s_local[c] over the chunks in order, from state_in, in place;
//          writes state_out;
//   output (ssd_chunk_kernel<kOutput>): G = C_c B_c^T once per block for
//          all of its heads (B/C are head-shared); per head
//          y = (G o exp(min(seg_t - seg_i, 0)), masked i <= t) . (dt x)
//              + exp(seg_t) C_c start[c]^T + D_h x.
// The output phase computes the whole of y, so y is written once and
// never read back.  A call of one chunk (S <= Q, the serving path's
// prefill) is one launch (ssd_chunk_kernel<kFused>): the output phase from
// start = state_in, then state_out = a_chunk state_in + s_local.
// Every product runs on the tensor cores as 3xTF32 mma.sync.m16n8k8
// (scan_tf32.cuh): the f32 parity paths take the kernel's output as
// exact.  Sixteen warps, two per 16-row tile of the chunk, each with half
// of p; G stays in the warps' registers as mma C fragments and feeds the
// intra-chunk product as its A operand directly (C fragment columns 2t,
// 2t+1 read as A's k = t, t + 4, with the B rows permuted to match).  Only
// the causal column tiles of G and only the chunk's S real rows are
// computed.  The s_local tiles go to the warps with the least product work
// (the early rows have the shortest causal span).  B_c, which every warp
// and head reads, is split into its TF32 parts once per block (n <= 64).
// x (and the carried start) of the next head streams in by cp.async while
// this head computes.
// Partial sums are merged in a fixed order (no atomics): bit-identical
// outputs from run to run.  On the H100 the 3xTF32 mma.sync issue rate
// bounds it (three HMMA.1688.F32.TF32 per product tile), then the bytes.
//
// Layout: x (B, S, H, p), Bm/Cm (B, S, n), dt (B, S, H), all f32 read
// through their strides (the model's own layout, no transposes; x, Bm, Cm
// rows 16-byte aligned); A, D (H,); state_in / state_out (B, H, p, n)
// contiguous; y (B, S, H, p) contiguous.
#include "scan_tf32.cuh"

using namespace repro;

namespace {

constexpr int kQ = 128;  // tokens per chunk
constexpr int kWarps = 16;  // two per 16-row tile, each with half of p
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeads = 14;  // heads per block
constexpr float kLog2e = 1.4426950408889634f;

enum Mode { kLocal = 0, kOutput = 1, kFused = 2 };

struct Strides {
  long long xb, xs, xh, bb, bs, cb, cs, db, ds, dh;
};

// shared memory (f32 offsets).  Row strides of 4 mod 32 floats make the
// fragment reads at g * stride + t conflict-free.  Where it fits (n <= 64)
// B_c is held split, its TF32 hi parts then its lo parts, because every
// warp and head reads it: C B^T and each head's s_local.
template <int P, int N, int MODE>
struct Layout {
  static constexpr bool kOut = MODE != kLocal;
  static constexpr bool kSplitB = N <= 64;
  static constexpr int BS = N + 4, XS = P + 4, SS = N + 4;
  static constexpr int kB = 0;
  static constexpr int kC = kB + (kSplitB ? 2 : 1) * kQ * BS;
  static constexpr int kX = kC + (kOut ? kQ * BS : 0);  // two buffers
  static constexpr int kStart = kX + 2 * kQ * XS;       // two buffers
  static constexpr int kDt = kStart + (kOut ? 2 * P * SS : 0);
  static constexpr int kSeg = kDt + kMaxHeads * kQ;
  static constexpr int kW = kSeg + kMaxHeads * kQ;
  static constexpr int kA = kW + kMaxHeads * kQ;
  static constexpr int kBytes = 4 * (kA + kMaxHeads);
  static_assert(kBytes <= 232448, "over the H100's shared memory a block");
};

// The s_local units (16 rows of p by 16 columns of n, numbered row-major)
// of warp `warp`, as a bit mask.  Each unit in turn goes to the warp with
// the least mma work so far, counted in k-steps of one 8-column tile; a
// warp starts with its share of the intra-chunk product (y_tiles column
// tiles over its causal k-steps), so the warps of the early rows, which
// have the shortest causal span, take the most units.
__device__ __forceinline__ unsigned state_units(int warp, int units,
                                                int y_tiles, int nv) {
  const int kv_steps = (nv + 7) / 8;
  int cost[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int rt = w >> 1;
    cost[w] = 16 * rt < nv ? min(2 * rt + 2, kv_steps) * y_tiles : 0;
  }
  unsigned mine = 0;
  for (int u = 0; u < units; ++u) {
    int best = 0, least = cost[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      if (cost[w] < least) {
        least = cost[w];
        best = w;
      }
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (w == best) cost[w] += 2 * kv_steps;
    if (best == warp) mine |= 1u << u;
  }
  return mine;
}

template <int P, int N, int MODE>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ dt,
    const float* __restrict__ a_rate, const float* __restrict__ d_skip,
    const float* __restrict__ start_src, float* __restrict__ y,
    float* __restrict__ state_dst, float* __restrict__ decay, int seq,
    int n_heads, int heads_per_block, int has_state, Strides st) {
  using L = Layout<P, N, MODE>;
  constexpr int BS = L::BS, XS = L::XS, SS = L::SS;
  constexpr int kPN = P * N;
  constexpr int NTY = P / 16;  // 8-column tiles of half of p
  constexpr int kUnits = (P / 16) * (N / 16);
  static_assert(kUnits <= 32, "s_local units in one mask");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* b_s = sm + L::kB;
  float* c_s = sm + L::kC;
  float* x_s = sm + L::kX;
  float* st_s = sm + L::kStart;
  float* dt_s = sm + L::kDt;
  float* seg_s = sm + L::kSeg;
  float* w_s = sm + L::kW;
  float* a_s = sm + L::kA;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h0 = blockIdx.x * heads_per_block;
  const int nh = min(heads_per_block, n_heads - h0);
  const int c = blockIdx.y, nc = gridDim.y, b = blockIdx.z;
  const int t0 = c * kQ, nv = min(kQ, seq - t0);
  // start state of the chunk: kFused reads state_in (B, H, P, N), kOutput
  // the carried starts (B, nc, H, P, N); chunk 0 has none without a state
  const bool has_start =
      MODE == kFused ? start_src != nullptr
                     : (MODE == kOutput && (c > 0 || has_state));
  auto start_of = [&](int j) {
    const long long bh = MODE == kFused
                             ? (long long)b * n_heads + h0 + j
                             : ((long long)b * nc + c) * n_heads + h0 + j;
    return start_src + bh * kPN;
  };
  auto issue_head = [&](int j) {  // x (and start) of head j, buffer j & 1
    stage_rows(x_s + (j & 1) * kQ * XS, XS,
               x + b * st.xb + t0 * st.xs + (h0 + j) * st.xh, st.xs, kQ, nv,
               P);
    if (L::kOut && has_start)
      stage_rows(st_s + (j & 1) * P * SS, SS, start_of(j), N, P, P, N);
  };

  // raw B_c lands where its lo parts go, and is split in place
  float* b_raw = L::kSplitB ? b_s + kQ * BS : b_s;
  stage_rows(b_raw, BS, bm + b * st.bb + t0 * st.bs, st.bs, kQ, nv, N);
  if (L::kOut) stage_rows(c_s, BS, cm + b * st.cb + t0 * st.cs, st.cs, kQ,
                          nv, N);
  issue_head(0);
  cp_async_commit();

  // dt of every head of the block; per head the cumsum seg of dt A log2(e)
  // (a warp scan over 4 tokens a lane), w = dt exp(seg_end - seg) and
  // a_chunk = exp(seg_end)
  for (int e = threadIdx.x; e < nh * kQ; e += kThreads) {
    const int j = e / kQ, tt = e - j * kQ;
    dt_s[e] = tt < nv ? dt[b * st.db + (t0 + tt) * st.ds + (h0 + j) * st.dh]
                      : 0.f;
  }
  __syncthreads();
  for (int j = warp; j < nh; j += kWarps) {
    const float la = a_rate[h0 + j] * kLog2e;
    const float* d = dt_s + j * kQ + 4 * lane;
    float v[4], run = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = run = fmaf(d[i], la, run);
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    float off = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) off = 0.f;
    const float end = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = off + v[i];
      seg_s[j * kQ + 4 * lane + i] = s;
      w_s[j * kQ + 4 * lane + i] = d[i] * decay2(end - s);
    }
    if (lane == 0) a_s[j] = decay2(end);
  }
  if (nh > 1) issue_head(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (L::kSplitB) {
    for (int e = threadIdx.x; e < kQ * BS; e += kThreads) {
      unsigned hi, lo;
      split_tf32(b_raw[e], hi, lo);
      b_s[e] = __uint_as_float(hi);
      b_raw[e] = __uint_as_float(lo);
    }
    __syncthreads();
  }
  // B_c at depth k (a token) and column j, as the product takes it
  auto b_pair = [&](int k, int j) {
    if constexpr (L::kSplitB)
      return make_uint2(__float_as_uint(b_s[k * BS + j]),
                        __float_as_uint(b_raw[k * BS + j]));
    else
      return b_s[k * BS + j];
  };

  const int rt = warp >> 1;  // this warp's 16-row tile of the chunk
  const int pc = (warp & 1) * (P / 2);  // and its half of p
  const int row0 = 16 * rt;
  const bool live = row0 < nv;  // the tile holds real tokens
  const int kv_steps = (nv + 7) / 8;  // k-steps over the chunk's real rows
  // column tiles of G the tile needs: causal (<= its last row) and real
  const int g_tiles = min(2 * rt + 2, kv_steps);
  float gacc[kQ / 8][4];
  if (L::kOut && live) {
    // G = C_c B_c^T for the tile's 16 rows, shared by every head
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[j][e] = 0.f;
    for (int ks = 0; ks < N / 8; ++ks) {
      const int k0 = 8 * ks;
      const float* cr = c_s + (row0 + g) * BS + k0 + t4;
      FragA fa;
      split_tf32(cr[0], fa.hi[0], fa.lo[0]);
      split_tf32(cr[8 * BS], fa.hi[1], fa.lo[1]);
      split_tf32(cr[4], fa.hi[2], fa.lo[2]);
      split_tf32(cr[8 * BS + 4], fa.hi[3], fa.lo[3]);
      // column tiles four at a time (the last group may run past the
      // causal span: G values no product reads)
#pragma unroll
      for (int j0 = 0; j0 < kQ / 8; j0 += 4) {
        if (j0 < g_tiles) {
          FragB fb[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int row = 8 * (j0 + j) + g;
            const uint2 v0 = tf32_pair(b_pair(row, k0 + t4));
            const uint2 v1 = tf32_pair(b_pair(row, k0 + t4 + 4));
            fb[j].hi[0] = v0.x;
            fb[j].lo[0] = v0.y;
            fb[j].hi[1] = v1.x;
            fb[j].lo[1] = v1.y;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_tf32(gacc[j0 + j], fa.lo, fb[j].hi[0], fb[j].hi[1]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_tf32(gacc[j0 + j], fa.hi, fb[j].lo[0], fb[j].lo[1]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_tf32(gacc[j0 + j], fa.hi, fb[j].hi[0], fb[j].hi[1]);
        }
      }
    }
  }
  const unsigned my_units =
      MODE == kOutput ? 0u
                      : state_units(warp, kUnits, MODE == kLocal ? 0 : NTY,
                                    nv);

  for (int j = 0; j < nh; ++j) {
    if (j > 0) {
      if (j + 1 < nh) issue_head(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }
    const int h = h0 + j;
    const float* xb = x_s + (j & 1) * kQ * XS;
    const float* sb = st_s + (j & 1) * P * SS;
    const float* seg = seg_s + j * kQ;
    const float* dtj = dt_s + j * kQ;

    if (L::kOut && live) {
      float yacc[NTY][4];
#pragma unroll
      for (int q = 0; q < NTY; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[q][e] = 0.f;
      const int r0 = row0 + g, r1 = r0 + 8;
      const float sr0 = seg[r0], sr1 = seg[r1];
      if (has_start) {
        // exp(seg_t) C_t start^T
        const float e0 = decay2(sr0), e1 = decay2(sr1);
        mma3_rows<NTY>(
            yacc, N / 8,
            [&](int hh, int k) {
              return c_s[(r0 + 8 * hh) * BS + k] * (hh ? e1 : e0);
            },
            [&](int k, int col) { return sb[(pc + col) * SS + k]; });
      }
      // intra-chunk: the masked, decayed G as the A operand straight from
      // its C fragments (columns i0 = 2t, i1 = 2t + 1 of each 8-column tile
      // are A's k = t, t + 4; B's rows follow)
#pragma unroll
      for (int kk = 0; kk < kQ / 8; ++kk) {
        if (kk < g_tiles) {
          const int i0 = 8 * kk + 2 * t4, i1 = i0 + 1;
          const float si0 = seg[i0], si1 = seg[i1];
          FragA fa;
          split_tf32(i0 <= r0 ? gacc[kk][0] * decay2(sr0 - si0) : 0.f,
                     fa.hi[0], fa.lo[0]);
          split_tf32(i0 <= r1 ? gacc[kk][2] * decay2(sr1 - si0) : 0.f,
                     fa.hi[1], fa.lo[1]);
          split_tf32(i1 <= r0 ? gacc[kk][1] * decay2(sr0 - si1) : 0.f,
                     fa.hi[2], fa.lo[2]);
          split_tf32(i1 <= r1 ? gacc[kk][3] * decay2(sr1 - si1) : 0.f,
                     fa.hi[3], fa.lo[3]);
          const float d0 = dtj[i0], d1 = dtj[i1];
          const float* x0 = xb + i0 * XS + pc + g;
          FragB fb[NTY];
#pragma unroll
          for (int q = 0; q < NTY; ++q) {
            split_tf32(x0[8 * q] * d0, fb[q].hi[0], fb[q].lo[0]);
            split_tf32(x0[XS + 8 * q] * d1, fb[q].hi[1], fb[q].lo[1]);
          }
          mma3_tiles<NTY>(yacc, fa, fb);
        }
      }
      // + D x, and out for the real rows
      const float dh = d_skip[h];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        if (r < nv) {
          float* yr = y + (((long long)b * seq + t0 + r) * n_heads + h) * P;
#pragma unroll
          for (int q = 0; q < NTY; ++q) {
            const int col = pc + 8 * q + 2 * t4;
            *reinterpret_cast<float2*>(yr + col) = make_float2(
                fmaf(dh, xb[r * XS + col], yacc[q][2 * hh]),
                fmaf(dh, xb[r * XS + col + 1], yacc[q][2 * hh + 1]));
          }
        }
      }
    }

    // s_local = (x dt exp(seg_end - seg))^T B_c over this warp's units,
    // then the chunk's end state (kFused: a_chunk start + s_local) or its
    // local state (kLocal)
    const float* wj = w_s + j * kQ;
    const float aj = a_s[j];
    const long long bh = MODE == kFused
                             ? (long long)b * n_heads + h
                             : ((long long)b * nc + c) * n_heads + h;
    for (unsigned m = my_units; m; m &= m - 1) {
      const int unit = __ffs(m) - 1;
      const int p0 = 16 * (unit / (N / 16)), n0 = 16 * (unit % (N / 16));
      float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      mma3_rows<2, true>(
          sacc, kv_steps,
          [&](int hh, int k) { return xb[k * XS + p0 + g + 8 * hh] * wj[k]; },
          [&](int k, int col) { return b_pair(k, n0 + col); });
      float* dst = state_dst + bh * kPN;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pi = p0 + g + 8 * hh;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int ni = n0 + 8 * q + 2 * t4;
          float2 v = make_float2(sacc[q][2 * hh], sacc[q][2 * hh + 1]);
          if (MODE == kFused && has_start) {
            v.x = fmaf(aj, sb[pi * SS + ni], v.x);
            v.y = fmaf(aj, sb[pi * SS + ni + 1], v.y);
          }
          *reinterpret_cast<float2*>(dst + pi * N + ni) = v;
        }
      }
    }
    if (MODE == kLocal && threadIdx.x == 0)
      decay[((long long)b * nc + c) * n_heads + h] = aj;
    __syncthreads();  // buffer j & 1 is free for head j + 2
  }
}

template <int P, int N, int MODE>
int launch_chunks(const float* x, const float* bm, const float* cm,
                  const float* dt, const float* A, const float* D,
                  const float* start_src, float* y, float* state_dst,
                  float* decay, int n_rows, int seq, int nc, int n_heads,
                  int heads_per_block, int has_state, const Strides& st,
                  cudaStream_t stream) {
  static bool opted_in = false;
  constexpr int bytes = Layout<P, N, MODE>::kBytes;
  cudaError_t err = smem_opt_in(ssd_chunk_kernel<P, N, MODE>, bytes,
                                opted_in);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_heads + heads_per_block - 1) / heads_per_block, nc,
                  n_rows);
  ssd_chunk_kernel<P, N, MODE><<<grid, kThreads, bytes, stream>>>(
      x, bm, cm, dt, A, D, start_src, y, state_dst, decay, seq, n_heads,
      heads_per_block, has_state, st);
  return (int)cudaGetLastError();
}

template <int P, int N>
int launch(const float* x, const float* bm, const float* cm, const float* dt,
           const float* A, const float* D, const float* state_in, float* y,
           float* state_out, float* states, float* decay, int n_rows,
           int seq, int n_heads, int heads_per_block, const Strides& st,
           cudaStream_t stream) {
  const int nc = (seq + kQ - 1) / kQ;
  if (nc == 1)
    return launch_chunks<P, N, kFused>(
        x, bm, cm, dt, A, D, state_in, y, state_out, nullptr, n_rows, seq,
        1, n_heads, heads_per_block, 0, st, stream);
  int err = launch_chunks<P, N, kLocal>(
      x, bm, cm, dt, A, D, nullptr, y, states, decay, n_rows, seq, nc,
      n_heads, heads_per_block, 0, st, stream);
  if (err) return err;
  err = launch_carry<false>(states, decay, state_in, state_out, n_rows, nc,
                            n_heads, P, N, stream);
  if (err) return err;
  return launch_chunks<P, N, kOutput>(
      x, bm, cm, dt, A, D, states, y, nullptr, nullptr, n_rows, seq, nc,
      n_heads, heads_per_block, state_in != nullptr, st, stream);
}

}  // namespace

// x (B, S, H, p), Bm/Cm (B, S, n), dt (B, S, H), all f32, with element
// strides = {x: b, s, h; Bm: b, s; Cm: b, s; dt: b, s, h} (x, Bm, Cm last
// dims contiguous, rows 16-byte aligned); A, D (H,) f32; state_in
// (B, H, p, n) f32 or null (zeros); y (B, S, H, p) and state_out
// (B, H, p, n) f32 contiguous.  S >= 1.  With more than one chunk of 128
// tokens, `states` (B, nc, H, p, n) and `decay` (B, nc, H) are f32 scratch
// (unused otherwise).  `heads_per_block` <= 14 heads share a block (and its
// C B^T).  (p, n) in {(16, 16), (32, 128), (64, 32), (64, 64)}.  Returns
// cudaGetLastError() after the launches, or kUnsupportedShape.
extern "C" int ssd_launch(const void* x, const void* bm, const void* cm,
                          const void* dt, const void* A, const void* D,
                          const void* state_in, void* y, void* state_out,
                          void* states, void* decay, int n_rows, int seq,
                          int n_heads, int p, int n, int heads_per_block,
                          const long long* strides, void* stream) {
  if (n_rows * n_heads == 0) return 0;
  if (seq < 1 || heads_per_block < 1 || heads_per_block > kMaxHeads)
    return kUnsupportedShape;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto w = [](void* q) { return static_cast<float*>(q); };
#define REPRO_PN(PP, NN)                                                    \
  if (p == PP && n == NN)                                                   \
    return launch<PP, NN>(f(x), f(bm), f(cm), f(dt), f(A), f(D),            \
                          f(state_in), w(y), w(state_out), w(states),       \
                          w(decay), n_rows, seq, n_heads, heads_per_block,  \
                          st, s);
  REPRO_PN(16, 16)
  REPRO_PN(32, 128)
  REPRO_PN(64, 32)
  REPRO_PN(64, 64)
#undef REPRO_PN
  return kUnsupportedShape;
}
