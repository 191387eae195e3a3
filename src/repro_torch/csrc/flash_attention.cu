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
// Design.  The TPU walks (b, h, q-block, k-block) with the k axis
// sequential and the softmax state in VMEM scratch.  Here one thread block
// owns one (b, h, 64-row q tile) and a loop inside the block walks only the
// in-band 64-key tiles: it starts at the window's first tile and stops at
// the causal diagonal, which takes the place of the TPU's whole-block
// skip.  Ragged lengths are masked inside the tile, so any Tq and Tk work
// (the TPU shrinks its blocks to a divisor of T instead).  Q, K, V and P
// tiles sit in shared memory as f32; 256 threads each own a 4 x 4 block of
// the score tile and 4 rows x hd/16 columns of the accumulator (hd is one
// of 32, 64, 112, 128; at 112 the tiles take 103 KB of shared memory), and
// the products are plain FMAs in f32 (exact enough to hold f32 inputs at
// 2e-5).
//
// Bound on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 dense).  At the
// serving path's prefill shape B=1, H=24, K=8, hd=128, T=512, bf16, causal:
//   bytes = q + k + v + out = 2 * (24 + 8 + 8 + 24) * 512 * 128 = 8.39 MB
//           -> 2.50 us;
//   FLOPs = 4 * hd * H * T(T+1)/2 = 1.61 GFLOP -> 1.63 us on tensor cores.
// So the bound is memory, 2.5 us.  This first version does its products on
// the CUDA cores in f32 (67 TFLOP/s peak), which puts it at ~24 us of
// arithmetic at best; what it does about the memory bound is read q once
// per block and each K/V tile once per q tile, never writing scores to
// device memory.  Tensor cores (wgmma fed by TMA) are the next step.
//
// C interface (built with nvcc into a shared library, loaded with ctypes):
// the kernel launches on the caller's stream, does not synchronise, and
// allocates nothing; the caller allocates `o`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype
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
  constexpr int DC = HD / 16;  // accumulator columns per thread
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
        const float vv = vs[j * HD + tx + 16 * c];
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
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                           scale, stream);
    case 112:  // zamba2's shared attention block: 3584 / 32 heads
      return launch<T, 112>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                            scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KH, Tq, Tk, causal, window,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
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
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, KH, Tq, Tk, hd,
                                      causal, window, scale, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
