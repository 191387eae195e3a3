// K2: forward of the Mamba2 SSD chunked scan, with an initial and a final
// state, for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py (ssd_tpu, body _kernel)
// and computes what the model path computes with it, ssd_chunked
// (src/repro/models/ssm.py): the same scan with an initial state, a ragged
// tail and the final state written out.  One group (B and C shared by all
// heads).  Head-major layout, as ssd_tpu has it:
//   x (b,H,T,P) and B, C (b,T,S) in f32 or bf16; dt (b,H,T), A (H,) and the
//   optional init_state (b,H,P,S) in f32.  Returns y like x and the f32
//   final_state (b,H,P,S).
// The chunk length is Q = min(chunk, T).  Per chunk, all in f32:
//   cum_q   = sum_{t<=q} dt_t A              (seg_end = cum_{Q-1})
//   y_q     = sum_{t<=q} (C_q . B_t) exp(cum_q - cum_t) dt_t x_t
//           + exp(cum_q) C_q . state                 (state before the chunk)
//   state'  = exp(seg_end) state + sum_t exp(seg_end - cum_t) dt_t x_t B_t^T
// Positions at or past T read as dt = 0, x = B = C = 0, which is the zero
// padding of ssd_chunked: such a position leaves the state as it is, and
// its y is not written.  Only y is rounded to x's type.
//
// Two designs behind one C entry point, chosen by dtype (no switch, no
// fallback: a bf16 input the tensor-core kernels cannot take is refused):
//   f32  -> ssd_fwd_kernel, f32 FMAs on the CUDA cores (exact enough to
//           hold f32 inputs at 1e-4);
//   bf16 -> three kernels, issued in order on the caller's stream:
//           ssd_chunk_state_kernel and ssd_output_kernel on the tensor
//           cores, and ssd_state_pass_kernel between them.
//
// Bound on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 dense).  At
// mamba2-780m's prefill shape b=1, H=48, T=512, P=64, S=128, bf16:
//   bytes = x 3.15 MB + y 3.15 MB + final state 1.57 MB + B, C 0.26 MB
//           + dt 0.10 MB = 8.23 MB -> 2.46 us;
//   FLOPs = C.B^T once per chunk (causal half) 4 MFLOP + intra-chunk 0.10
//           GFLOP + inter-chunk 0.35 (none in the first chunk, whose state
//           is zero) + state update 0.40 = 0.86 GFLOP -> 0.87 us on bf16
//           tensor cores.
// So the bound is memory, 2.5 us.  On the CUDA cores (67 TFLOP/s f32) the
// same FLOPs take 13 us at best, and the f32 design does more than them.
//
// The f32 design.  The TPU walks (b, head block, chunk) with the chunk
// axis sequential and the state in VMEM scratch.  Here the rows p of the
// state are independent, so one thread block owns one (b, h, 16-row tile
// of P) and a loop inside the block walks the chunks in order, keeping its
// 16 x S slice of the state in shared memory from the first chunk to the
// last.  Each chunk stages B, C (Q x S), the x tile (Q x 16) and dt in
// shared memory as f32, one warp takes the prefix sum of dt A with
// shuffles, and 256 threads form the Q x Q score tile (each a 4 x 4
// block, the C.B^T product as plain FMAs), then y (4 rows of one column
// each) and the state update (S/16 entries each).  Each block recomputes
// the C.B^T tile, and the chunks of a head run one after the other.
//
// The bf16 design is the chunked decomposition of the plain version
// (ssd_chunked), parallel over the chunks but for one short elementwise
// recurrence:
//   1. ssd_chunk_state_kernel, one block per (chunk, head, b): the warp
//      scan of dt A gives cum (written to scratch), w_t = exp(seg_end -
//      cum_t) dt_t, and the chunk's own state (x o w)^T . B (P x S) on
//      the tensor cores, each warp holding the A fragments of its 16 rows
//      of P, written to scratch (b, nc, H, P, S) in f32.
//   2. ssd_state_pass_kernel, one thread per (b, h, p, s):
//      state = exp(seg_end_c) state + own_c over the chunks, from
//      init_state or zero, the loads of eight chunks in flight at once; it
//      overwrites chunk c's scratch entry with the state before chunk c
//      and writes the final state.
//   3. ssd_output_kernel, one block per (chunk, head, b).  First each warp
//      takes 16 rows q: C . B^T on the tensor cores (only the t tiles at
//      or below its rows); scores = CB o exp(cum_q - cum_t) o dt_t, with
//      t > q selected to 0 before the exponential (exp(cum_q - cum_t)
//      overflows for t > q at the model's decay rates, and inf * 0 is
//      NaN), split hi + lo into shared memory.  Then each warp takes 16
//      columns p of every row: y_intra = scores . x and C . state^T on
//      the tensor cores, reading its 16 rows of the state before the
//      chunk once, into registers; y = y_intra + exp(cum_q) (C .
//      state^T), rounded once to bf16.
// (Walking the chunks in order inside one block per (16 rows of P, head),
// with the state in registers, saves the scratch round trip but measured
// slower on an H100: the serial chain of per-chunk work is longer than
// the pass.)
// Tiles are bf16 in shared memory with rows padded by 16 bytes (ldmatrix
// reads eight rows from eight bank groups), loaded by cp.async; a chunk
// shorter than 16 (T = 3) or than its tile is zero-padded in shared
// memory, not in a padded copy.  P and S are multiples of 16, P <= 64 and
// S <= 128 (each warp holds its rows of the state in registers).
// Where it rounds: x, B and C are bf16 inputs and enter the products as
// they are (their products are exact in f32); the f32-valued operands --
// x o w, the scores and the carried state -- enter as a two-term bf16
// split hi + lo (two mma.sync each), which carries ~16 bits of their
// mantissa: plain bf16 there (8 bits) misses the 5e-2 tolerance at the
// model's decay rates, TF32 would carry 11.  cum, the exponentials, the
// state recurrence and every accumulator are f32; exp(cum_q) multiplies
// C . state^T after the product; y is rounded once.  Scratch, allocated
// by the caller: cum (b,H,T) f32 and the chunk states (b,nc,H,P,S) f32,
// which the pass overwrites with the states before each chunk.
//
// C interface (built with nvcc into a shared library, loaded with ctypes):
// the kernels launch on the caller's stream, do not synchronise, and
// allocate nothing; the caller allocates y, final_state and the scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int QMAX = 64;   // longest chunk: the score tile is QMAX x QMAX
constexpr int PT = 16;     // state rows (entries of P) per block
constexpr int NT = 256;    // threads per block
constexpr size_t SMEM_MAX = 232448;  // a block's shared memory on sm_90

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

size_t smem_bytes(int Q, int S) {
  // B, C and the state padded to S + 1 floats a row (16 lanes reading 16
  // rows at one column hit 16 banks), the score tile to Q + 1
  return sizeof(float) * ((size_t)2 * Q * (S + 1) + (size_t)PT * (S + 1) +
                          (size_t)Q * PT + (size_t)Q * (Q + 1) + 3 * Q);
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ init,
               T* __restrict__ y, float* __restrict__ final_state, int H,
               int T_len, int P, int S, int Q) {
  extern __shared__ float smem[];
  const int LDB = S + 1;
  const int LDS = Q + 1;
  float* bs = smem;            // Q x LDB   B of the chunk
  float* cs = bs + Q * LDB;    // Q x LDB   C of the chunk
  float* st = cs + Q * LDB;    // PT x LDB  this block's rows of the state
  float* xs = st + PT * LDB;   // Q x PT    x tile of the chunk
  float* sc = xs + Q * PT;     // Q x LDS   scores
  float* cum = sc + Q * LDS;   // Q         prefix sum of dt A
  float* wgt = cum + Q;        // Q         exp(seg_end - cum_t) dt_t
  float* dts = wgt + Q;        // Q         dt

  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float a = A[h];
  const size_t bh = (size_t)b * H + h;
  const T* xg = x + bh * T_len * P + p0;       // row t at xg[t * P]
  const float* dtg = dt + bh * T_len;
  const T* bg = Bm + (size_t)b * T_len * S;
  const T* cg = Cm + (size_t)b * T_len * S;
  T* yg = y + bh * T_len * P + p0;
  const size_t so = (bh * P + p0) * S;        // state rows p0.. of (b, h)

  // thread e of the state owns entries e, e + NT, ...: (p, s) = (e / S, e % S)
  for (int e = tid; e < PT * S; e += NT)
    st[(e / S) * LDB + e % S] = init ? init[so + e] : 0.f;

  const int nchunks = (T_len + Q - 1) / Q;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * Q;
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < Q * S; e += NT) {
      const int t = e / S, s = e % S;
      const bool in = t0 + t < T_len;
      const size_t g = (size_t)(t0 + t) * S + s;
      bs[t * LDB + s] = in ? to_f32(bg[g]) : 0.f;
      cs[t * LDB + s] = in ? to_f32(cg[g]) : 0.f;
    }
    for (int e = tid; e < Q * PT; e += NT) {
      const int t = e / PT, p = e % PT;
      xs[e] = t0 + t < T_len ? to_f32(xg[(size_t)(t0 + t) * P + p]) : 0.f;
    }
    if (tid < 32) {
      // inclusive prefix sum of dt A over the chunk: lane l holds
      // positions 2l and 2l + 1, a shuffle scan carries the pair sums
      const int i0 = 2 * tid, i1 = 2 * tid + 1;
      const float d0 = i0 < Q && t0 + i0 < T_len ? dtg[t0 + i0] : 0.f;
      const float d1 = i1 < Q && t0 + i1 < T_len ? dtg[t0 + i1] : 0.f;
      const float a0 = d0 * a, a1 = d1 * a;
      float run = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += u;
      }
      float before = __shfl_up_sync(0xffffffffu, run, 1);
      if (tid == 0) before = 0.f;
      if (i0 < Q) {
        cum[i0] = before + a0;
        dts[i0] = d0;
      }
      if (i1 < Q) {
        cum[i1] = before + a0 + a1;
        dts[i1] = d1;
      }
    }
    __syncthreads();

    const float seg = cum[Q - 1];
    if (tid < Q) wgt[tid] = expf(seg - cum[tid]) * dts[tid];

    {
      // scores[q][t] = (C_q . B_t) exp(cum_q - cum_t) dt_t for t <= q;
      // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
      const int tx = tid & 15, ty = tid >> 4;
      int rq[4], rt[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rq[i] = min(ty + 16 * i, Q - 1) * LDB;
        rt[i] = min(tx + 16 * i, Q - 1) * LDB;
      }
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[rq[i] + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[rt[j] + s];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = tx + 16 * j;
          if (q < Q && t < Q)
            sc[q * LDS + t] =
                t <= q ? acc[i][j] * expf(cum[q] - cum[t]) * dts[t] : 0.f;
        }
      }
    }
    __syncthreads();

    {
      // y: thread (qg, p) owns rows qg + 16 i of column p of the tile
      const int p = tid & (PT - 1), qg = tid / PT;
      for (int q = qg; q < Q; q += NT / PT) {
        float intra = 0.f;
        for (int t = 0; t <= q; ++t)
          intra = fmaf(sc[q * LDS + t], xs[t * PT + p], intra);
        float inter = 0.f;
        for (int s = 0; s < S; ++s)
          inter = fmaf(cs[q * LDB + s], st[p * LDB + s], inter);
        if (t0 + q < T_len)
          yg[(size_t)(t0 + q) * P + p] =
              from_f32<T>(intra + inter * expf(cum[q]));
      }
    }
    __syncthreads();  // every reader of the old state is done

    const float g = expf(seg);
    for (int e = tid; e < PT * S; e += NT) {
      const int p = e / S, s = e % S;
      float upd = 0.f;
      for (int t = 0; t < Q; ++t)
        upd = fmaf(wgt[t] * xs[t * PT + p], bs[t * LDB + s], upd);
      st[p * LDB + s] = st[p * LDB + s] * g + upd;
    }
  }

  // each thread writes out the entries it updated itself
  for (int e = tid; e < PT * S; e += NT)
    final_state[so + e] = st[(e / S) * LDB + e % S];
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* init, void* y,
                   void* final_state, int b, int H, int T_len, int P, int S,
                   int Q, cudaStream_t stream) {
  auto kernel = ssd_fwd_kernel<T>;
  const size_t smem = smem_bytes(Q, S);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(P / PT, H, b);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(final_state), H, T_len, P, S,
      Q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: chunk states, state passing, output
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_WARPS = 4;
constexpr int TC_NT = 32 * TC_WARPS;
constexpr int TC_PAD = 8;      // bf16 of padding per smem row (16 bytes)
constexpr int TC_PMAX = 64;    // widest P: one 16-column stripe a warp
constexpr int TC_SMAX = 128;   // widest S: a warp holds its state rows
constexpr int PASS_NT = 256;   // threads per block of the state pass

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

size_t chunk_state_smem(int QP, int P, int S) {
  // B and x tiles, cum and w
  return sizeof(bf16) *
             ((size_t)QP * (S + TC_PAD) + (size_t)QP * (P + TC_PAD)) +
         sizeof(float) * 2 * QMAX;
}

size_t output_smem(int QP, int P, int S) {
  // C, B and x tiles, the scores hi and lo, cum and dt
  return sizeof(bf16) * (2 * (size_t)QP * (S + TC_PAD) +
                         (size_t)QP * (P + TC_PAD) +
                         2 * (size_t)QP * (QP + TC_PAD)) +
         sizeof(float) * 2 * QMAX;
}

// Copy rows [0, QP) of a (rows, W) bf16 tile into shared memory with row
// stride LD; rows at or past `valid` are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int QP,
                                          int W, int LD, int valid,
                                          int tid) {
  const int ch = W / 8;
  for (int i = tid; i < QP * ch; i += TC_NT) {
    const int r = i / ch, c = (i % ch) * 8;
    const bool in = r < valid;
    tc::cp_async16(dst + r * LD + c, src + (size_t)(in ? r : 0) * W + c, in);
  }
}

// Inclusive prefix sum of dt A over a chunk by one warp: lane l holds
// positions 2l and 2l + 1 (QMAX = 64), positions at or past `valid` read
// dt = 0.  Writes cum[0, QMAX) and dts[0, QMAX).
__device__ __forceinline__ void chunk_cumsum(const float* dtg, float a,
                                             int valid, int lane, float* cum,
                                             float* dts) {
  const int i0 = 2 * lane, i1 = 2 * lane + 1;
  const float d0 = i0 < valid ? dtg[i0] : 0.f;
  const float d1 = i1 < valid ? dtg[i1] : 0.f;
  const float a0 = d0 * a, a1 = d1 * a;
  float run = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += u;
  }
  float before = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) before = 0.f;
  cum[i0] = before + a0;
  cum[i1] = before + a0 + a1;
  dts[i0] = d0;
  dts[i1] = d1;
}

// 1. cum, and each chunk's own state (x o w)^T . B with
// w_t = exp(seg_end - cum_t) dt_t.  Grid (chunks, H, b).
__global__ void __launch_bounds__(TC_NT)
ssd_chunk_state_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Bm, float* __restrict__ cum_g,
                       float* __restrict__ states, int H, int T_len, int P,
                       int S, int Q) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * Q, valid = min(Q, T_len - t0), QP = round16(Q);
  const int LDB = S + TC_PAD, LDX = P + TC_PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);   // QP x LDB  B
  bf16* xs = bs + QP * LDB;                       // QP x LDX  x
  float* cum = reinterpret_cast<float*>(xs + QP * LDX);  // QMAX
  float* wt = cum + QMAX;                                // QMAX: dt, then w

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = (size_t)b * H + h;
  load_tile(bs, Bm + ((size_t)b * T_len + t0) * S, QP, S, LDB, valid, tid);
  load_tile(xs, x + (bh * T_len + t0) * P, QP, P, LDX, valid, tid);
  tc::cp_async_commit();
  if (warp == 0)
    chunk_cumsum(dt + bh * T_len + t0, A[h], valid, lane, cum, wt);
  __syncthreads();
  const float seg = cum[Q - 1];
  if (tid < valid) cum_g[bh * T_len + t0 + tid] = cum[tid];
  if (tid < QMAX) wt[tid] = expf(seg - cum[tid]) * wt[tid];
  tc::cp_async_wait<0>();
  __syncthreads();

  // Each warp owns one 16-row tile of P (with P < 64, several warps
  // share one and take turns over the s tiles) and builds the A
  // fragments of (x o w)^T in registers, split hi + lo; zero rows of x
  // give zero columns.
  const int npt = P / 16, wpp = TC_WARPS / npt;   // npt <= 4
  const int p0 = (warp / wpp) * 16, nk = QP / 16;
  if (p0 >= P) return;   // no barrier below
  uint32_t ah[QMAX / 16][4], al[QMAX / 16][4];
#pragma unroll
  for (int kk = 0; kk < QMAX / 16; ++kk) {
    if (kk >= nk) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a_i: row p0 + g (+ 8 for odd i), columns t, t + 1
      const int p = p0 + g + 8 * (i & 1);
      const int t = kk * 16 + 8 * (i >> 1) + 2 * t4;
      tc::split_bf16(__bfloat162float(xs[t * LDX + p]) * wt[t],
                     __bfloat162float(xs[(t + 1) * LDX + p]) * wt[t + 1],
                     ah[kk][i], al[kk][i]);
    }
  }
  float* sg = states + (((size_t)b * nc + c) * H + h) * P * S;
  for (int s0 = (warp % wpp) * 16; s0 < S; s0 += wpp * 16) {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < QMAX / 16; ++kk) {
      if (kk >= nk) continue;
      uint32_t bb[4];   // B rows t = kk*16 + 0..15, columns s0 + 0..15
      tc::ldsm_x4_trans(bb, bs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                  (lane & 7)) * LDB +
                                s0 + (lane >> 4) * 8);
      tc::mma_bf16(acc[0], ah[kk], bb[0], bb[1]);
      tc::mma_bf16(acc[0], al[kk], bb[0], bb[1]);
      tc::mma_bf16(acc[1], ah[kk], bb[2], bb[3]);
      tc::mma_bf16(acc[1], al[kk], bb[2], bb[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            sg + (size_t)(p0 + g + 8 * r) * S + s0 + 8 * n + 2 * t4) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// 2. The state recurrence over the chunks, one thread per (b, h, p, s).
// Overwrites each chunk's own state with the state before that chunk and
// writes the final state.  Grid (ceil(P S / PASS_NT), H, b).
__global__ void __launch_bounds__(PASS_NT)
ssd_state_pass_kernel(const float* __restrict__ cum_g,
                      const float* __restrict__ init,
                      float* __restrict__ states,
                      float* __restrict__ final_state, int H, int T_len,
                      int Q, int nc, int PS) {
  const int e = blockIdx.x * PASS_NT + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PS) return;
  const size_t bh = (size_t)b * H + h;
  float st = init ? init[bh * PS + e] : 0.f;
  const size_t stride = (size_t)H * PS;   // from one chunk to the next
  float* sp = states + ((size_t)b * nc * H + h) * PS + e;
  constexpr int U = 8;   // chunks whose loads are in flight at once
  for (int c0 = 0; c0 < nc; c0 += U) {
    float own[U], seg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      if (c >= nc) continue;
      own[u] = sp[c * stride];
      seg[u] = cum_g[bh * T_len + min(c * Q + Q - 1, T_len - 1)];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      if (c >= nc) continue;
      sp[c * stride] = st;
      st = st * expf(seg[u]) + own[u];
    }
  }
  final_state[bh * PS + e] = st;
}

// 3. y of each chunk.  Grid (chunks, H, b).  First warp w takes rows
// q = 16w .. 16w + 15: C . B^T on the tensor cores (only the t tiles at
// or below its rows), the scores, split hi + lo into shared memory.  Then
// warp w takes columns p = 16w .. 16w + 15 of every row: y_intra =
// scores . x, and C . state^T with the state before the chunk (read once
// from scratch into registers, split hi + lo), on the tensor cores.
__global__ void __launch_bounds__(TC_NT)
ssd_output_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                  const float* __restrict__ cum_g,
                  const float* __restrict__ prev, bf16* __restrict__ y,
                  int H, int T_len, int P, int S, int Q, int has_init) {
  constexpr int NQ = QMAX / 16;   // 16-row stripes of a chunk, at most
  constexpr int KS = TC_SMAX / 16;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * Q, valid = min(Q, T_len - t0), QP = round16(Q);
  const int nq = QP / 16, ns = S / 16;
  const int LDB = S + TC_PAD, LDX = P + TC_PAD, LDS = QP + TC_PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);   // QP x LDB  C
  bf16* bs = cs + QP * LDB;                       // QP x LDB  B
  bf16* xs = bs + QP * LDB;                       // QP x LDX  x
  bf16* sh = xs + QP * LDX;                       // QP x LDS  scores hi
  bf16* sl = sh + QP * LDS;                       // QP x LDS  scores lo
  float* cum = reinterpret_cast<float*>(sl + QP * LDS);   // QMAX
  float* dts = cum + QMAX;                                // QMAX

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = (size_t)b * H + h;
  const bool inter = c > 0 || has_init;   // else the state before is zero
  const int p0 = warp * 16;               // this warp's columns of y
  load_tile(cs, Cm + ((size_t)b * T_len + t0) * S, QP, S, LDB, valid, tid);
  load_tile(bs, Bm + ((size_t)b * T_len + t0) * S, QP, S, LDB, valid, tid);
  load_tile(xs, x + (bh * T_len + t0) * P, QP, P, LDX, valid, tid);
  tc::cp_async_commit();
  for (int i = tid; i < QMAX; i += TC_NT) {
    const bool in = i < valid;
    cum[i] = in ? cum_g[bh * T_len + t0 + i] : 0.f;
    dts[i] = in ? dt[bh * T_len + t0 + i] : 0.f;
  }
  // this warp's rows p of the state before the chunk, raw f32, as the B
  // fragments (k = s, n = p) of C . state^T; in flight during phase one
  float2 sv[KS][2][2];
  if (inter && p0 < P) {
    const float* sg = prev + (((size_t)b * nc + c) * H + h) * P * S;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk >= ns) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sv[kk][n][j] = *reinterpret_cast<const float2*>(
              sg + (size_t)(p0 + 8 * n + g) * S + kk * 16 + 8 * j + 2 * t4);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // phase one: rows 16 warp .. 16 warp + 15
  if (warp < nq) {
    const int r0 = warp * 16;
    float sc[2 * NQ][4];
#pragma unroll
    for (int j = 0; j < 2 * NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    for (int kk = 0; kk < ns; ++kk) {
      uint32_t a[4];
      tc::ldsm_x4(a,
                  cs + (r0 + (lane & 15)) * LDB + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NQ; ++np) {
        if (np > warp) continue;
        uint32_t bb[4];   // B rows t = np*16 + 0..7 and + 8..15, s kk*16..
        tc::ldsm_x4(bb, bs + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDB +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(sc[2 * np], a, bb[0], bb[1]);
        tc::mma_bf16(sc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    // t > q (and rows past the chunk) are selected to 0 before the
    // exponential is taken
    const int ra = r0 + g;
    const float cq[2] = {cum[ra], cum[ra + 8]};
#pragma unroll
    for (int j = 0; j < 2 * NQ; ++j) {
      if (j > 2 * warp + 1) continue;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = ra + 8 * rr, t = 8 * j + 2 * t4;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = t + e <= r && r < valid
                     ? sc[j][2 * rr + e] * expf(cq[rr] - cum[t + e]) *
                           dts[t + e]
                     : 0.f;
        uint32_t hi, lo;
        tc::split_bf16(v[0], v[1], hi, lo);
        *reinterpret_cast<uint32_t*>(sh + r * LDS + t) = hi;
        *reinterpret_cast<uint32_t*>(sl + r * LDS + t) = lo;
      }
    }
  }
  __syncthreads();
  if (p0 >= P) return;   // no barrier below

  // phase two: columns p0 .. p0 + 15 of every row
  float ya[NQ][2][4], yi[NQ][2][4];
#pragma unroll
  for (int qs = 0; qs < NQ; ++qs)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[qs][n][e] = yi[qs][n][e] = 0.f;
  if (inter) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk >= ns) continue;
      uint32_t bh4[2][2], bl4[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          tc::split_bf16(sv[kk][n][j].x, sv[kk][n][j].y, bh4[n][j],
                         bl4[n][j]);
#pragma unroll
      for (int qs = 0; qs < NQ; ++qs) {
        if (qs >= nq) continue;
        uint32_t a[4];
        tc::ldsm_x4(a, cs + (qs * 16 + (lane & 15)) * LDB + kk * 16 +
                           (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          tc::mma_bf16(yi[qs][n], a, bh4[n][0], bh4[n][1]);
          tc::mma_bf16(yi[qs][n], a, bl4[n][0], bl4[n][1]);
        }
      }
    }
  }
#pragma unroll
  for (int qs = 0; qs < NQ; ++qs) {
    if (qs >= nq) continue;
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      if (kk > qs) continue;
      uint32_t ah[4], al[4], bb[4];
      const int off =
          (qs * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
      tc::ldsm_x4(ah, sh + off);
      tc::ldsm_x4(al, sl + off);
      // x rows t = kk*16 + 0..15, columns p0 + 0..7 and + 8..15
      tc::ldsm_x4_trans(bb, xs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                  (lane & 7)) * LDX +
                                p0 + (lane >> 4) * 8);
      tc::mma_bf16(ya[qs][0], ah, bb[0], bb[1]);
      tc::mma_bf16(ya[qs][0], al, bb[0], bb[1]);
      tc::mma_bf16(ya[qs][1], ah, bb[2], bb[3]);
      tc::mma_bf16(ya[qs][1], al, bb[2], bb[3]);
    }
  }

  // y = y_intra + exp(cum_q) (C . state^T), rounded once
  bf16* yg = y + (bh * T_len + t0) * P + p0;
#pragma unroll
  for (int qs = 0; qs < NQ; ++qs) {
    if (qs >= nq) continue;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = qs * 16 + g + 8 * rr;
      if (r >= valid) continue;
      const float eq = expf(cum[r]);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        *reinterpret_cast<uint32_t*>(yg + (size_t)r * P + 8 * n + 2 * t4) =
            tc::pack_bf16(ya[qs][n][2 * rr] + eq * yi[qs][n][2 * rr],
                          ya[qs][n][2 * rr + 1] + eq * yi[qs][n][2 * rr + 1]);
    }
  }
}

cudaError_t launch_bf16(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, const void* init,
                        void* y, void* final_state, void* cum, void* states,
                        int b, int H, int T_len, int P, int S, int Q,
                        cudaStream_t stream) {
  if (P % 16 || P > TC_PMAX || S % 16 || S > TC_SMAX || !cum || !states)
    return cudaErrorInvalidValue;
  // cp.async and the vector accesses move 16-byte chunks
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
       reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(states)) % 16)
    return cudaErrorMisalignedAddress;
  const int QP = round16(Q), nc = (T_len + Q - 1) / Q;
  const size_t smem1 = chunk_state_smem(QP, P, S);
  const size_t smem2 = output_smem(QP, P, S);
  if (smem1 > SMEM_MAX || smem2 > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_output_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  ssd_chunk_state_kernel<<<dim3(nc, H, b), TC_NT, smem1, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(B),
      static_cast<float*>(cum), static_cast<float*>(states), H, T_len, P,
      S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_pass_kernel<<<dim3((P * S + PASS_NT - 1) / PASS_NT, H, b),
                          PASS_NT, 0, stream>>>(
      static_cast<const float*>(cum), static_cast<const float*>(init),
      static_cast<float*>(states), static_cast<float*>(final_state), H,
      T_len, Q, nc, P * S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_output_kernel<<<dim3(nc, H, b), TC_NT, smem2, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const bf16*>(B), static_cast<const bf16*>(C),
      static_cast<const float*>(cum), static_cast<const float*>(states),
      static_cast<bf16*>(y), H, T_len, P, S, Q, init != nullptr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (x, B, C and y;
// the tensor-core kernels, which need the f32 scratch cum (b,H,T) and
// states (b,nc,H,P,S), nc = ceil(T / Q), 16-byte aligned x, B, C, y and
// states, P <= 64 and S <= 128; the f32 kernel ignores the scratch).
// init may be null (a zero initial state).  Returns the first launch
// error, as a cudaError_t.
int repro_ssd_fwd(const void* x, const void* dt, const void* A,
                  const void* B, const void* C, const void* init, void* y,
                  void* final_state, void* cum, void* states, int b, int H,
                  int T_len, int P, int S, int Q, int dtype, void* stream) {
  if (b < 1 || H < 1 || T_len < 1 || P < PT || P % PT || S < 1 || Q < 1 ||
      Q > QMAX || Q > T_len || b > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (smem_bytes(Q, S) > SMEM_MAX) return cudaErrorInvalidValue;
    return launch<float>(x, dt, A, B, C, init, y, final_state, b, H, T_len,
                         P, S, Q, s);
  }
  if (dtype == 1)
    return launch_bf16(x, dt, A, B, C, init, y, final_state, cum, states, b,
                       H, T_len, P, S, Q, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
