// K1: forward of blocked online-softmax attention (causal / sliding window /
// GQA) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_tpu, body _kernel).  It computes the same function:
//   q (B,H,Tq,hd), k/v (B,K,Tk,hd), head h reads KV head h / (H/K);
//   scores (q * 1/sqrt(hd)) . k in f32; causal mask qpos >= kpos (aligned
//   at 0 even when Tq != Tk); window mask kpos >= qpos - window (keeps
//   window + 1 keys); tail mask kpos < Tk; masked scores are -1e30, not
//   -inf, so a tile fully masked for some row is wiped by the next `corr`
//   rescale exactly as on the TPU; m, l and the accumulator are f32; p is
//   rounded to v's type before the PV product; out = acc / max(l, 1e-30)
//   cast to q's type.
//
// Two kernels behind one C entry point, chosen by dtype (no switch, no
// fallback: a bf16 input the tensor-core kernel cannot take is refused):
//   bf16 -> flash_attention_bf16_kernel, on the tensor cores;
//   f32  -> flash_attention_fwd_kernel, f32 FMAs on the CUDA cores, exact
//           enough to hold f32 inputs at 2e-5.
// Both walk the same tiles: one thread block owns one (b, h, 64-row q
// tile) and a loop inside the block walks only the in-band 64-key tiles,
// from the window's first tile to the causal diagonal, which takes the
// place of the TPU's whole-block skip.  Ragged lengths are masked inside
// the tile, so any Tq and Tk work (the TPU shrinks its blocks to a
// divisor of T instead).
//
// Bound on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 dense).  At the
// serving path's prefill shape B=1, H=24, K=8, hd=128, T=512, bf16, causal:
//   bytes = q + k + v + out = 2 * (24 + 8 + 8 + 24) * 512 * 128 = 8.39 MB
//           -> 2.50 us;
//   FLOPs = 4 * hd * H * T(T+1)/2 = 1.61 GFLOP -> 1.63 us on tensor cores.
// So the bound is memory, 2.5 us, with the operations close behind.  On
// the CUDA cores (67 TFLOP/s f32) the same FLOPs take 24 us at best, so
// the f32 kernel is bound by its arithmetic; the bf16 kernel moves the
// products to the tensor cores and keeps the tiles bf16 in shared memory.
//
// The f32 design.  Q, K, V and P tiles sit in shared memory as f32; 256
// threads each own a 4 x 4 block of the score tile and 4 rows x
// ceil(hd/16) columns of the accumulator (at hd 120, h2o-danube-3-4b's
// 3840 / 32, the eighth column exists for half of the threads; at hd 120
// the tiles take 109 KB of shared memory), and both products are plain
// FMAs.
//
// The bf16 design.  Eight warps: four stripes of 16 of the block's 64 q
// rows, times two halves of each 64-key tile, so that the longest causal
// row walks its keys in half the steps.  Each warp keeps its own online
// softmax state for its rows and half; at the end the second half's warps
// hand m, l and the accumulator over through shared memory and the first
// half's warps merge them (one more corr step) and write the rows.
// The q tile and double-buffered 64-key K and V tiles stay bf16 in shared
// memory (rows padded by 16 bytes, so the eight rows an ldmatrix reads
// fall in eight different bank groups), filled by cp.async: the next key
// tile is in flight while the current one is used.  Each warp loads its
// q fragments once (ldmatrix) and keeps them in registers.  S = q . k^T
// runs on mma.sync.m16n8k16 (bf16 in, f32 out); the scale 1/sqrt(hd)
// (times log2 e, for exp2) is applied to S afterwards.  The mask, the
// running max (over the four lanes of a quad), corr and the exponentials
// run in registers; p is rounded to bf16 in pairs and used as it lies as
// the A fragment of P . V (mma.sync again, V through ldmatrix.trans).
// Each thread sums its own part of l and the quad adds them once at the
// end.  The grid is (H, q tiles, B) with the q tiles in reverse, so the
// heaviest causal tiles of every head start first on the 132 SMs.
// Head dims that are not a multiple of 16 (hd 120): mma.m16n8k16 takes
// 16 columns a k-step, so the q, K and V rows sit in shared memory padded
// to the next multiple of 16 (120 -> 128), and the pad is zeros: cp.async
// zero-fills the 16-byte chunks past hd instead of reading them, so the
// last k-step of q . k^T adds 0 . 0.  P . V's 8-wide n-tiles cover hd
// exactly (120 = 15 of them); the last 16-column ldmatrix of V feeds only
// its first n-tile, and only hd columns are stored.  Global rows stay
// 16-byte aligned (240 bytes = 15 chunks).
// Head dim 16 (every --smoke config: d_model 64 over 4 heads) is one
// k-step of q . k^T and two 8-wide n-tiles of P . V, with no padding.
// Where it rounds: q, k and v are bf16 inputs and their products are exact
// in f32; S, m, l and the accumulator are f32 sums; the scale is one f32
// multiply after the product (the TPU scales q before it, an f32
// rounding apart); p is bf16 in P . V (the reference's p.astype(v.dtype))
// and f32 in l; out is rounded once to bf16.
//
// C interface (built with nvcc into a shared library, loaded with ctypes):
// the kernels launch on the caller's stream, do not synchronise, and
// allocate nothing; the caller allocates `o`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int PLD = BK + 1;   // padded row stride of the P tile
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// max / sum over the 16 lanes that share one score row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K tiles padded to HD + 1 floats a row (no bank conflicts when
  // 16 lanes read 16 rows at one column), V unpadded, P padded
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * PLD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int H, int KH, int Tq, int Tk, int causal,
                           int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DC = (HD + 15) / 16;  // accumulator columns per thread
  // a thread's column tx + 16 c exists (always, when 16 divides HD)
  auto has_col = [](int tx, int c) {
    return HD % 16 == 0 || tx + 16 * c < HD;
  };
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x LD
  float* ks = qs + BQ * LD;    // BK x LD
  float* vs = ks + BK * LD;    // BK x HD
  float* ps = vs + BK * HD;    // BQ x PLD

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const T* qg = q + (size_t)(b * H + h) * Tq * HD;
  const T* kg = k + (size_t)(b * KH + kh) * Tk * HD;
  const T* vg = v + (size_t)(b * KH + kh) * Tk * HD;
  T* og = o + (size_t)(b * H + h) * Tq * HD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // score columns tx + 16 j, acc columns tx + 16 c
  const int ty = tid >> 4;   // rows ty + 16 i

  // q.astype(f32) * scale; rows past Tq are zero and never written out
  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const float x = q0 + r < Tq ? to_f32(qg[(size_t)(q0 + r) * HD + d]) : 0.f;
    qs[r * LD + d] = x * scale;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // in-band key tiles: from the window's first key to the causal diagonal
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_lo = window > 0 ? max(q0 - window, 0) : 0;
  const int k_hi = causal ? min(q_last + 1, Tk) : Tk;  // exclusive
  const int kt_begin = k_lo / BK;
  const int kt_end = (k_hi + BK - 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < Tk;
      const size_t g = (size_t)(k0 + r) * HD + d;
      ks[r * LD + d] = in ? to_f32(kg[g]) : 0.f;
      vs[r * HD + d] = in ? to_f32(vg[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool keep = kpos < Tk;
        if (causal) keep = keep && qpos >= kpos;
        if (window > 0) keep = keep && kpos >= qpos - window;
        if (!keep) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        // p.astype(v.dtype) before PV; the denominator keeps the f32 p
        ps[(ty + 16 * i) * PLD + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PLD + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = has_col(tx, c) ? vs[j * HD + tx + 16 * c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (has_col(tx, c))
        og[(size_t)r * HD + tx + 16 * c] = from_f32<T>(acc[i][c] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KH, int Tq, int Tk, int causal,
                   int window, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_fwd_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Tq, Tk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KH, int Tq, int Tk, int hd,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 16:  // every --smoke config with attention: d_model 64, 4 heads
      return launch<T, 16>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                           scale, stream);
    case 112:  // zamba2's shared attention block: 3584 / 32 heads
      return launch<T, 112>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                            scale, stream);
    case 120:  // h2o-danube-3-4b: 3840 / 32 heads
      return launch<T, 120>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                            scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 8;    // 4 row stripes x 2 key halves
constexpr int TC_NT = 32 * TC_WARPS;
constexpr int TC_PAD = 8;      // bf16 of padding per smem row
constexpr int STAGES = 2;      // K/V tile buffers: one in use, one loading
constexpr float LOG2E = 1.4426950408889634f;

// a tile row's columns in shared memory: hd padded to a whole k-step
template <int HD>
__host__ __device__ constexpr int tc_cols() {
  return (HD + 15) / 16 * 16;
}

template <int HD>
constexpr size_t tc_smem_bytes() {
  // q tile + STAGES K and V tiles, bf16, rows of tc_cols + TC_PAD; after
  // the loop the K tiles hold the second key half's m, l and accumulator
  constexpr int LD = tc_cols<HD>() + TC_PAD;
  static_assert(sizeof(float) * (BQ * HD + 2 * BQ) <=
                    sizeof(__nv_bfloat16) * STAGES * BK * LD,
                "the merge area must fit in the K tiles");
  return sizeof(__nv_bfloat16) * (BQ + 2 * STAGES * BK) * LD;
}

template <int HD>
__global__ void __launch_bounds__(TC_NT)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int H, int KH,
                            int Tq, int Tk, int causal, int window,
                            float scale_log2) {
  constexpr int HDP = tc_cols<HD>();  // row columns in smem, zero past HD
  constexpr int LD = HDP + TC_PAD;    // smem row stride (bf16)
  constexpr int CH = HDP / 8;         // 16-byte chunks per smem row
  constexpr int KS = HDP / 16;        // k-steps of q . k^T
  constexpr int ND = HD / 8;          // 8-wide n-tiles of the output
  constexpr int KW = BK / 2;          // keys of a tile per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * LD;            // [STAGES][BK][LD]
  __nv_bfloat16* vs = ks + STAGES * BK * LD;   // [STAGES][BK][LD]

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const __nv_bfloat16* qg = q + (size_t)(b * H + h) * Tq * HD;
  const __nv_bfloat16* kg = k + (size_t)(b * KH + kh) * Tk * HD;
  const __nv_bfloat16* vg = v + (size_t)(b * KH + kh) * Tk * HD;
  __nv_bfloat16* og = o + (size_t)(b * H + h) * Tq * HD;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wq = (warp & 3) * 16;   // this warp's first row in the tile
  const int half = warp >> 2;       // and its half of each key tile
  const int g = lane >> 2, t4 = lane & 3;

  // in-band key tiles, as in the f32 kernel
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_lo = window > 0 ? max(q0 - window, 0) : 0;
  const int k_hi = causal ? min(q_last + 1, Tk) : Tk;  // exclusive
  const int kt_begin = k_lo / BK;
  const int kt_end = (k_hi + BK - 1) / BK;

  // rows past Tq / Tk are zero-filled (a zero V row meets p = 0 there),
  // and so are the columns past HD
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    for (int i = tid; i < BK * CH; i += TC_NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = k0 + r < Tk && c < HD;
      const size_t src = in ? (size_t)(k0 + r) * HD + c : 0;
      const int dst = (buf * BK + r) * LD + c;
      tc::cp_async16(ks + dst, kg + src, in);
      tc::cp_async16(vs + dst, vg + src, in);
    }
  };
  if (kt_begin < kt_end) {
    for (int i = tid; i < BQ * CH; i += TC_NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = q0 + r < Tq && c < HD;
      tc::cp_async16(qs + r * LD + c,
                     qg + (in ? (size_t)(q0 + r) * HD + c : 0), in);
    }
  }
  const int nt = kt_end - kt_begin;
  // the first STAGES - 1 key tiles, one commit group each (the first
  // with q)
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nt) load_kv(kt_begin + i, i);
    tc::cp_async_commit();
  }

  uint32_t qf[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows wq + g (index 0) and wq + g + 8 (index 1); m in log2 units
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int qpos0 = q0 + wq + g;

  for (int j = 0; j < nt; ++j) {
    const int kt = kt_begin + j, buf = j % STAGES;
    const int ahead = j + STAGES - 1;   // refills the buffer read last step
    if (ahead < nt) load_kv(kt_begin + ahead, ahead % STAGES);
    tc::cp_async_commit();
    tc::cp_async_wait<STAGES - 1>();   // step j's tile has landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        tc::ldsm_x4(qf[kk],
                    qs + (wq + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    // this warp's 32 keys of the tile
    const __nv_bfloat16* kb = ks + (buf * BK + half * KW) * LD;
    const __nv_bfloat16* vb = vs + (buf * BK + half * KW) * LD;

    // S = q . k^T: 16 rows x 32 keys, four 8-key n-tiles
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int np = 0; np < 2; ++np) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bk[4];   // keys np*16 + 0..7 and + 8..15, d kk*16 + 0..15
        tc::ldsm_x4(bk, kb + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        tc::mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale, mask, online softmax
    const int k0 = kt * BK + half * KW;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qpos0 + 8 * (e >> 1);
        const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
        bool keep = kpos < Tk;
        if (causal) keep = keep && qpos >= kpos;
        if (window > 0) keep = keep && kpos >= qpos - window;
        const float x = keep ? s[j][e] * scale_log2 : NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_new[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new[r]);
      m[r] = m_new[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_new[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;   // the denominator keeps the f32 p
      }

    // acc += bf16(p) . v, 16 keys a k-step
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t pa[4] = {
          tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HDP / 16; ++dp) {
        uint32_t bv[4];   // keys kk*16 + 0..15, d dp*16 + 0..7 and + 8..15
        tc::ldsm_x4_trans(bv, vb + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        if (2 * dp + 1 < ND) tc::mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this tile's readers are done before it is refilled
  }

  // Merge the two key halves of each row, as one more online-softmax
  // step: the second half's warps leave m, l and the accumulator in the
  // K tiles (free after the loop's last barrier), the first half's warps
  // combine and write the row.
  float* mrg = reinterpret_cast<float*>(ks);   // BQ x HD accumulator
  float* mrg_m = mrg + BQ * HD;                // BQ
  float* mrg_l = mrg_m + BQ;                   // BQ
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq + g + 8 * r;
      if (t4 == 0) {
        mrg_m[row] = m[r];
        mrg_l[row] = l[r];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(mrg + row * HD + 8 * n + 2 * t4) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq + g + 8 * r;
    if (q0 + row >= Tq) continue;
    const float m1 = mrg_m[row];
    const float mm = fmaxf(m[r], m1);
    const float f0 = exp2f(m[r] - mm), f1 = exp2f(m1 - mm);
    const float den = fmaxf(l[r] * f0 + mrg_l[row] * f1, 1e-30f);
    uint32_t* dst = reinterpret_cast<uint32_t*>(og + (size_t)(q0 + row) * HD);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float2 a1 =
          *reinterpret_cast<const float2*>(mrg + row * HD + 8 * n + 2 * t4);
      dst[n * 4 + t4] =
          tc::pack_bf16((acc[n][2 * r] * f0 + a1.x * f1) / den,
                        (acc[n][2 * r + 1] * f0 + a1.y * f1) / den);
    }
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KH, int Tq, int Tk, int causal,
                        int window, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_bf16_kernel<HD>;
  const size_t smem = tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (Tq + BQ - 1) / BQ, B);
  kernel<<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, KH, Tq, Tk, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* o, int B, int H, int KH, int Tq, int Tk,
                          int hd, int causal, int window, float scale,
                          cudaStream_t stream) {
  // cp.async moves 16-byte chunks: every base address must be aligned
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return cudaErrorMisalignedAddress;
  if ((Tq + BQ - 1) / BQ > 65535) return cudaErrorInvalidValue;
  switch (hd) {
    case 16:  // one k-step of m16n8k16, two 8-wide n-tiles
      return launch_bf16<16>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                             scale, stream);
    case 32:
      return launch_bf16<32>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                             scale, stream);
    case 64:
      return launch_bf16<64>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                             scale, stream);
    case 112:
      return launch_bf16<112>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                              scale, stream);
    case 120:
      return launch_bf16<120>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                              scale, stream);
    case 128:
      return launch_bf16<128>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                              scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel; q, k, v and o 16-byte aligned).  Returns the launch's cudaError_t.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int KH, int Tq, int Tk,
                              int hd, int causal, int window, int dtype,
                              float scale, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH || Tq < 1 || Tk < 1 || window < 0 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, B, H, KH, Tq, Tk, hd, causal,
                              window, scale, s);
  if (dtype == 1)
    return dispatch_bf16(q, k, v, o, B, H, KH, Tq, Tk, hd, causal, window,
                         scale, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
