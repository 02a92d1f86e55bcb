// K3: the RWKV6 (Finch) WKV recurrence with carried state in and out, as a
// chunked scan on the tensor cores.
//
// Replaces the TPU kernel
//   src/repro/kernels/wkv6/wkv6.py:70 wkv6_bh (pallas_call at :92),
//   wrapper ops.py:27.
// It computes, per (batch row b, head h), over exactly S tokens:
//   out_t = r_t . (S_{t-1} + u (*) k_t v_t^T)
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(lw_t), lw_t <= 0
// from a carried (hd, hd) f32 state (zeros when none is given), and writes
// the final state.
//
// What bounds it on the H100: bytes, at the card's peaks.  Each token of
// a (b, h) pair reads r, k, v, lw and writes out (20 hd bytes); the
// chunked form does ~2 Q hd + 4 hd^2 flops for them, which at the TF32
// tensor-core peak take less time than the bytes at 3.35 TB/s.  A
// step-by-step walk instead is serial along S and issues one
// shared-memory load per f32 FMA.
//
// The design: gated linear attention with a per-channel decay in chunk
// form (Yang et al. 2024, two-level chunking; flash-linear-attention's
// chunk_rwkv6).  Chunks of Q = 64 tokens in sub-blocks of 16; seg = the
// inclusive cumsum of lw per channel in the chunk (log2 units, so each
// decay is one exp2), segx = seg - lw.  Per chunk, with the start state S:
//   out = A v + (r o exp(segx)) S, with the intra-chunk matrix
//         A[t, i] = sum_c r_tc k_ic exp(segx_tc - seg_ic)  (i < t),
//         A[t, t] = r_t . (u o k_t);
//   S  <- diag(exp(seg_end)) S + (k o exp(seg_end - seg))^T v.
// When there are at least as many (b, h) pairs as SMs (and always for
// one chunk), one block per (b, h) walks the chunks in order with S in
// shared memory (wkv6_chunk_kernel<kWalk>, one launch).  Otherwise the
// chunks run in parallel in three phases:
//   local  (<kLocal>): s_local = (k o exp(seg_end - seg))^T v and a_chunk =
//          exp(seg_end) (per channel) to f32 scratch;
//   carry  (carry_kernel, scan_tf32.cuh): start[c] = S, S = diag(a_chunk
//          [c]) S + s_local[c] over the chunks in order, from state_in, in
//          place; writes state_out;
//   output (<kOutput>): out from start[c].
// Decays are factored about rho_J = seg at the last token of sub-block J,
// per channel: r^_t = r_t o exp(segx_t - rho_{J(t)-1}) and k^_i = k_i o
// exp(rho_{I(i)} - seg_i) once per chunk, then
//   A_JI = (r^_J o exp(rho_{J-1} - rho_I)) k^_I^T   (sub-blocks I < J),
// a 16 x hd . hd x 16 product, the start product takes r^ o exp(rho_{J-1})
// and the state product k^ o exp(seg_end - rho_I).  Every factor is <= 1
// for any lw <= 0, so nothing overflows.  (One reference point for a whole
// chunk would put exp(+-|seg|) in the factors: f32 overflows at lw = -5
// over 16 tokens.)  The 16 x 16 diagonal sub-blocks take the exponent per
// pair, on the CUDA cores.  Every product (A_JI, A v, the start and state
// products) runs on the tensor cores as 3xTF32 mma.sync.m16n8k8
// (scan_tf32.cuh): the f32 parity paths take the kernel's output as
// exact.  Eight warps: two per sub-block of rows, each with half of the
// columns.  Rows past the S real tokens are skipped.  Partial sums are
// merged in a fixed order (no atomics): bit-identical outputs from run to
// run.  A walk stages the next chunk's lw and r while this chunk's
// products run (their buffers free up first); k and v, read until the
// state product, load when the chunk starts.  On the H100 the per-pair
// exponents (MUFU), the 3xTF32 mma.sync issue rate and the chunk loads
// bound it.
//
// Layout: r, k, v, lw (B, S, H, hd) f32 read through their (b, s, h)
// strides (the model's own layout, no transposes; rows 16-byte aligned);
// u (H, hd); state_in / state_out (B, H, hd, hd) contiguous; out
// (B, S, H, hd) contiguous.
#include "scan_tf32.cuh"

using namespace repro;

namespace {

constexpr int kQ = 64;  // tokens per chunk
constexpr int kSub = 16;  // tokens per sub-block
constexpr int kParts = kQ / kSub;
constexpr int kWarps = 8;  // two per sub-block of rows
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
// rows of the decay-factor table: the sub-block pairs J > I, then one row
// per sub-block for the start product and one for the state product, then
// the whole chunk's decay
constexpr int kPairs = kParts * (kParts - 1) / 2;
constexpr int kEndRow = kPairs + 2 * kParts;
constexpr int kFacRows = kEndRow + 1;

enum Mode { kLocal = 0, kOutput = 1, kWalk = 2 };

struct SeqStrides {
  long long b[4], s[4], h[4];  // r, k, v, lw
};

// shared memory (f32 offsets).  Row strides of 4 mod 32 floats make the
// fragment reads at g * stride + t conflict-free, of 8 mod 32 those at
// t * stride + g.  seg has Q + 1 rows: row 0 is zero, row i + 1 is seg_i,
// so row t is segx_t and row 16 J is rho_{J-1}, seg at the last token of
// sub-block J - 1 (zero for J = 0).  The factor table reuses the room of
// the cumsum's sub-block totals.
template <int HD, int MODE>
struct Layout {
  static constexpr bool kOut = MODE != kLocal;
  static constexpr int RS = HD + 4, VS = HD + 8, AS = kQ + 4, SS = HD + 8;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kQ * RS;
  static constexpr int kSeg = kV + kQ * VS;
  static constexpr int kFac = kSeg + (kQ + 1) * RS;
  static constexpr int kR = kFac + (kOut ? kFacRows : kParts) * HD;
  static constexpr int kA = kR + (kOut ? kQ * RS : 0);
  static constexpr int kStart = kA + (kOut ? kQ * AS : 0);
  static constexpr int kU = kStart + (kOut ? HD * SS : 0);
  static constexpr int kBytes = 4 * (kU + (kOut ? HD : 0));
  static_assert(kBytes <= 232448, "over the H100's shared memory a block");
};

template <int HD, int MODE>
__global__ void __launch_bounds__(kThreads, 2) wkv6_chunk_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lw,
    const float* __restrict__ u, const float* __restrict__ start_src,
    float* __restrict__ out, float* __restrict__ state_dst,
    float* __restrict__ decay, int seq, int n_heads, int has_state,
    SeqStrides st) {
  using L = Layout<HD, MODE>;
  constexpr int RS = L::RS, VS = L::VS, AS = L::AS, SS = L::SS;
  constexpr int kHH = HD * HD;
  constexpr int NTH = HD / 16;  // 8-column tiles of half of hd
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* k_s = sm + L::kK;
  float* v_s = sm + L::kV;
  float* seg_s = sm + L::kSeg;
  float* fac_s = sm + L::kFac;
  float* r_s = sm + L::kR;
  float* a_s = sm + L::kA;
  float* st_s = sm + L::kStart;
  float* u_s = sm + L::kU;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int J = warp >> 1, hh = warp & 1;  // sub-block of rows, half of hd
  const int tj = kSub * J, e0 = hh * (HD / 2);
  const int h = blockIdx.x, b = blockIdx.z;
  // kWalk: one block per (b, h) walks every chunk, its state in st_s;
  // kLocal / kOutput: one block per chunk, chunk states in scratch
  const int c_first = MODE == kWalk ? 0 : blockIdx.y;
  const int c_end = MODE == kWalk ? (seq + kQ - 1) / kQ : c_first + 1;
  const int nc = gridDim.y;
  const long long bh = (long long)b * n_heads + h;
  const float* seg_end = seg_s + kQ * RS;

  if (MODE == kWalk) {
    if (start_src)
      stage_rows(st_s, SS, start_src + bh * kHH, HD, HD, HD, HD);
    else
      for (int e = threadIdx.x; e < HD * SS; e += kThreads) st_s[e] = 0.f;
  }
  if (L::kOut)
    for (int e = threadIdx.x; e < HD; e += kThreads) u_s[e] = u[h * HD + e];

  for (int c = c_first; c < c_end; ++c) {
    const int t0 = c * kQ, nv = min(kQ, seq - t0);
    const int kv_steps = (nv + 7) / 8;
    const bool live = tj < nv;  // this warp's sub-block holds real tokens
    const bool has_start =
        MODE == kWalk ? (c > 0 || start_src != nullptr)
                      : (MODE == kOutput && (c > 0 || has_state));
    const long long bhc = ((long long)b * nc + c) * n_heads + h;
    if (c > c_first) __syncthreads();  // the previous chunk's readers
    auto rows_of = [&](const float* base, int i, int cc) {
      return base + b * st.b[i] + (long long)cc * kQ * st.s[i] + h * st.h[i];
    };
    // a walk stages the next chunk's lw and r while this one computes
    auto stage_lw = [&](int cc) {
      stage_rows(seg_s + RS, RS, rows_of(lw, 3, cc), st.s[3], kQ,
                 min(kQ, seq - cc * kQ), HD);
    };
    auto stage_r = [&](int cc) {
      stage_rows(r_s, RS, rows_of(r, 0, cc), st.s[0], kQ,
                 min(kQ, seq - cc * kQ), HD);
    };
    const bool prefetch = MODE == kWalk && c + 1 < c_end;
    stage_rows(k_s, RS, rows_of(k, 1, c), st.s[1], kQ, nv, HD);
    stage_rows(v_s, VS, rows_of(v, 2, c), st.s[2], kQ, nv, HD);
    if (c == c_first) {
      stage_lw(c);
      if (L::kOut) stage_r(c);
    }
    if (MODE == kOutput && has_start)
      stage_rows(st_s, SS, start_src + bhc * kHH, HD, HD, HD, HD);
    for (int e = threadIdx.x; e < HD; e += kThreads) seg_s[e] = 0.f;
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // seg in log2 units: each sub-block cumsums per channel, then adds the
    // sum of the sub-blocks before it (pre_p = pre_{p-1} + tot_{p-1}
    // equals seg at the last row of sub-block p - 1, so seg never rises)
    for (int e = threadIdx.x; e < kParts * HD; e += kThreads) {
      const int part = e / HD, ch = e - part * HD;
      float* col = seg_s + (1 + kSub * part) * RS + ch;
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < kSub; ++i)
        col[i * RS] = run = fmaf(col[i * RS], kLog2e, run);
      fac_s[part * HD + ch] = run;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < (kParts - 1) * HD; e += kThreads) {
      const int part = 1 + e / HD, ch = e % HD;
      float pre = 0.f;
      for (int q = 0; q < part; ++q) pre += fac_s[q * HD + ch];
      float* col = seg_s + (1 + kSub * part) * RS + ch;
#pragma unroll
      for (int i = 0; i < kSub; ++i) col[i * RS] += pre;
    }
    __syncthreads();

    if (L::kOut) {
      if (live) {
        // diagonal sub-block: the 120 pairs i < t by lane, the exponent per
        // pair, on the raw r and k
        for (int m = 0; m < 2; ++m) {
          const int e = 64 * hh + 32 * m + lane;
          if (e < 120) {
            int tl = (int)((1.f + sqrtf(1.f + 8.f * e)) * 0.5f);
            if (tl * (tl - 1) / 2 > e) --tl;
            if ((tl + 1) * tl / 2 <= e) ++tl;
            const int il = e - tl * (tl - 1) / 2;
            const int t = tj + tl, i = tj + il;
            const float4* rt = reinterpret_cast<const float4*>(r_s + t * RS);
            const float4* sx =
                reinterpret_cast<const float4*>(seg_s + t * RS);
            const float4* ki = reinterpret_cast<const float4*>(k_s + i * RS);
            const float4* si =
                reinterpret_cast<const float4*>(seg_s + (i + 1) * RS);
            float acc = 0.f;
#pragma unroll 4
            for (int q = 0; q < HD / 4; ++q) {
              const float4 a = rt[q], x = sx[q], kk = ki[q], s = si[q];
              acc = fmaf(a.x * kk.x, decay2(x.x - s.x), acc);
              acc = fmaf(a.y * kk.y, decay2(x.y - s.y), acc);
              acc = fmaf(a.z * kk.z, decay2(x.z - s.z), acc);
              acc = fmaf(a.w * kk.w, decay2(x.w - s.w), acc);
            }
            a_s[t * AS + i] = acc;
            a_s[i * AS + t] = 0.f;
          }
        }
        if (hh == 1 && lane < kSub) {  // the bonus r_t . (u o k_t)
          const int t = tj + lane;
          float acc = 0.f;
          for (int q = 0; q < HD; ++q)
            acc = fmaf(r_s[t * RS + q] * u_s[q], k_s[t * RS + q], acc);
          a_s[t * AS + t] = acc;
        }
      }
      __syncthreads();  // raw r and k no longer needed
      // factor every decay of the products about the sub-block ends rho:
      //   r^[t] = r_t o exp(segx_t - rho_{J-1}),  k^[i] = k_i o exp(rho_I -
      //   seg_i), and per channel exp(rho_{J-1} - rho_I) (pair J > I),
      //   exp(rho_{J-1}) (start), exp(seg_end - rho_I) (state)
      // so each factor is <= 1 and every operand is one exp per element
      for (int e = threadIdx.x; e < kQ * HD; e += kThreads) {
        const int t = e / HD, ch = e - t * HD;
        const int blk = kSub * (t / kSub);
        r_s[t * RS + ch] *= decay2(seg_s[t * RS + ch] - seg_s[blk * RS + ch]);
        k_s[t * RS + ch] *= decay2(seg_s[(blk + kSub) * RS + ch] -
                                   seg_s[(t + 1) * RS + ch]);
      }
      for (int e = threadIdx.x; e < kFacRows * HD; e += kThreads) {
        const int row = e / HD, ch = e - row * HD;
        float z;
        if (row < kPairs) {  // row = J (J - 1) / 2 + I
          int jb = 1;
          while ((jb + 1) * jb / 2 <= row) ++jb;
          const int ib = row - jb * (jb - 1) / 2;
          z = seg_s[kSub * jb * RS + ch] - seg_s[kSub * (ib + 1) * RS + ch];
        } else if (row < kPairs + kParts) {
          z = seg_s[kSub * (row - kPairs) * RS + ch];
        } else if (row < kEndRow) {
          z = seg_end[ch] - seg_s[kSub * (row - kPairs - kParts + 1) * RS + ch];
        } else {
          z = seg_end[ch];
        }
        fac_s[e] = decay2(z);
      }
      __syncthreads();  // seg is no longer read: the next lw may land
      if (prefetch) {
        stage_lw(c + 1);
        cp_async_commit();
      }
      // this warp's output tile starts with the start product
      // (r o exp(segx)) start = (r^ o exp(rho_{J-1})) start; the sub-block
      // pair tiles of A go two to each of the warps 0-3, whose causal A v
      // is the shortest, one to each of the others
      float oacc[NTH][4];
#pragma unroll
      for (int q = 0; q < NTH; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[q][e] = 0.f;
      if (live && has_start) {
        const float* f = fac_s + (kPairs + J) * HD;
        mma3_rows<NTH>(
            oacc, HD / 8,
            [&](int h2, int d) {
              return r_s[(tj + g + 8 * h2) * RS + d] * f[d];
            },
            [&](int d, int col) { return st_s[d * SS + e0 + col]; });
      }
      for (int job = warp; job < 2 * kPairs; job += kWarps) {
        // pair row J (J - 1) / 2 + I = job / 2, columns 8 (job % 2) of it:
        // A_JI = (r^_J o exp(rho_{J-1} - rho_I)) k^_I^T
        const int pair = job >> 1;
        int pj = 1;
        while ((pj + 1) * pj / 2 <= pair) ++pj;
        const int pi = pair - pj * (pj - 1) / 2;
        if (kSub * pj >= nv) continue;
        const float* f = fac_s + pair * HD;
        const int r0 = kSub * pj, i0 = kSub * pi + 8 * (job & 1);
        float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
        mma3_rows<1>(
            acc, HD / 8,
            [&](int h2, int ch) {
              return r_s[(r0 + g + 8 * h2) * RS + ch] * f[ch];
            },
            [&](int ch, int col) { return k_s[(i0 + col) * RS + ch]; });
        float* dst = a_s + (r0 + g) * AS + i0 + 2 * t4;
        *reinterpret_cast<float2*>(dst) = make_float2(acc[0][0], acc[0][1]);
        *reinterpret_cast<float2*>(dst + 8 * AS) =
            make_float2(acc[0][2], acc[0][3]);
      }
      __syncthreads();  // A complete; r is no longer read
      if (prefetch) {
        stage_r(c + 1);
        cp_async_commit();
      }
      if (live) {
        // + A v over the causal, real columns
        mma3_rows<NTH>(
            oacc, min(2 * J + 2, kv_steps),
            [&](int h2, int i) { return a_s[(tj + g + 8 * h2) * AS + i]; },
            [&](int i, int col) { return v_s[i * VS + e0 + col]; });
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int t = tj + g + 8 * h2;
          if (t < nv) {
            float* o = out + (((long long)b * seq + t0 + t) * n_heads + h) *
                                 HD + e0 + 2 * t4;
#pragma unroll
            for (int q = 0; q < NTH; ++q)
              *reinterpret_cast<float2*>(o + 8 * q) =
                  make_float2(oacc[q][2 * h2], oacc[q][2 * h2 + 1]);
          }
        }
      }
      if (MODE == kOutput) return;
      __syncthreads();  // the start product's readers are done
    } else {
      for (int e = threadIdx.x; e < kQ * HD; e += kThreads) {
        const int i = e / HD, ch = e - i * HD;
        k_s[i * RS + ch] *= decay2(seg_end[ch] - seg_s[(i + 1) * RS + ch]);
      }
      __syncthreads();
    }

    // the chunk's state: s_local = (k o exp(seg_end - seg))^T v, tiles of
    // 16 rows (d) by half of the columns (e); kWalk folds it into the
    // carried state, kLocal writes it to scratch
    for (int tile = warp; tile < 2 * (HD / 16); tile += kWarps) {
      const int d0 = 16 * (tile >> 1), c0 = (tile & 1) * (HD / 2);
      float sacc[NTH][4];
#pragma unroll
      for (int q = 0; q < NTH; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[q][e] = 0.f;
      if (MODE == kWalk)  // k^ o exp(seg_end - rho_I)
        mma3_rows<NTH>(
            sacc, kv_steps,
            [&](int h2, int i) {
              const int d = d0 + g + 8 * h2;
              return k_s[i * RS + d] *
                     fac_s[(kPairs + kParts + i / kSub) * HD + d];
            },
            [&](int i, int col) { return v_s[i * VS + c0 + col]; });
      else
        mma3_rows<NTH>(
            sacc, kv_steps,
            [&](int h2, int i) { return k_s[i * RS + d0 + g + 8 * h2]; },
            [&](int i, int col) { return v_s[i * VS + c0 + col]; });
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int d = d0 + g + 8 * h2;
        const float a = MODE == kWalk ? fac_s[kEndRow * HD + d]
                                      : decay2(seg_end[d]);
#pragma unroll
        for (int q = 0; q < NTH; ++q) {
          const int e = c0 + 8 * q + 2 * t4;
          if (MODE == kWalk) {
            float* sp = st_s + d * SS + e;
            sp[0] = has_start ? fmaf(a, sp[0], sacc[q][2 * h2])
                              : sacc[q][2 * h2];
            sp[1] = has_start ? fmaf(a, sp[1], sacc[q][2 * h2 + 1])
                              : sacc[q][2 * h2 + 1];
          } else {
            *reinterpret_cast<float2*>(state_dst + bhc * kHH + d * HD + e) =
                make_float2(sacc[q][2 * h2], sacc[q][2 * h2 + 1]);
          }
        }
      }
    }
    if (MODE == kLocal)
      for (int e = threadIdx.x; e < HD; e += kThreads)
        decay[bhc * HD + e] = decay2(seg_end[e]);
  }
  if (MODE == kWalk) {
    __syncthreads();
    for (int e = threadIdx.x; e < kHH / 4; e += kThreads) {
      const int d = 4 * e / HD, col = 4 * e - d * HD;
      reinterpret_cast<float4*>(state_dst + bh * kHH)[e] =
          *reinterpret_cast<const float4*>(st_s + d * SS + col);
    }
  }
}

template <int HD, int MODE>
int launch_chunks(const float* r, const float* k, const float* v,
                  const float* lw, const float* u, const float* start_src,
                  float* out, float* state_dst, float* decay, int n_rows,
                  int seq, int nc, int n_heads, int has_state,
                  const SeqStrides& st, cudaStream_t stream) {
  static bool opted_in = false;
  constexpr int bytes = Layout<HD, MODE>::kBytes;
  cudaError_t err = smem_opt_in(wkv6_chunk_kernel<HD, MODE>, bytes,
                                opted_in);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_heads, nc, n_rows);
  wkv6_chunk_kernel<HD, MODE><<<grid, kThreads, bytes, stream>>>(
      r, k, v, lw, u, start_src, out, state_dst, decay, seq, n_heads,
      has_state, st);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* state_in, float* out,
           float* state_out, float* states, float* decay, int n_rows,
           int seq, int n_heads, int walk, const SeqStrides& st,
           cudaStream_t stream) {
  const int nc = (seq + kQ - 1) / kQ;
  if (walk || nc == 1)
    return launch_chunks<HD, kWalk>(r, k, v, lw, u, state_in, out,
                                    state_out, nullptr, n_rows, seq, 1,
                                    n_heads, 0, st, stream);
  int err = launch_chunks<HD, kLocal>(r, k, v, lw, u, nullptr, out, states,
                                      decay, n_rows, seq, nc, n_heads, 0, st,
                                      stream);
  if (err) return err;
  err = launch_carry<true>(states, decay, state_in, state_out, n_rows, nc,
                           n_heads, HD, HD, stream);
  if (err) return err;
  return launch_chunks<HD, kOutput>(r, k, v, lw, u, states, out, nullptr,
                                    nullptr, n_rows, seq, nc, n_heads,
                                    state_in != nullptr, st, stream);
}

}  // namespace

// r, k, v, lw (B, S, H, hd) f32 with element strides
// strides = {r: b, s, h; k: b, s, h; v: b, s, h; lw: b, s, h} (last dims
// contiguous, rows 16-byte aligned); u (H, hd) f32; state_in
// (B, H, hd, hd) f32 or null (zeros); out (B, S, H, hd) and state_out
// (B, H, hd, hd) f32 contiguous.  S >= 1.  With more than one chunk of 64
// tokens, `states` (B, nc, H, hd, hd) and `decay` (B, nc, H, hd) are f32
// scratch (unused otherwise).  hd in {16, 32, 64, 128}.  Returns
// cudaGetLastError() after the launches, or kUnsupportedShape.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* lw, const void* u,
                           const void* state_in, void* out, void* state_out,
                           void* states, void* decay, int n_rows, int seq,
                           int n_heads, int hd, int walk,
                           const long long* strides, void* stream) {
  if (n_rows * n_heads == 0) return 0;
  if (seq < 1) return kUnsupportedShape;
  SeqStrides st;
  for (int i = 0; i < 4; ++i) {
    st.b[i] = strides[3 * i];
    st.s[i] = strides[3 * i + 1];
    st.h[i] = strides[3 * i + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
#define REPRO_HD(D)                                                          \
  case D:                                                                    \
    return launch<D>(f(r), f(k), f(v), f(lw), f(u), f(state_in), w(out),     \
                     w(state_out), w(states), w(decay), n_rows, seq,         \
                     n_heads, walk, st, s);
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
