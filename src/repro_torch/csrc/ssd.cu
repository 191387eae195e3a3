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
// Design.  The TPU walks (b, head block, chunk) with the chunk axis
// sequential and the state in VMEM scratch.  Here the rows p of the state
// are independent, so one thread block owns one (b, h, 16-row tile of P)
// and a loop inside the block walks the chunks in order, keeping its
// 16 x S slice of the state in shared memory from the first chunk to the
// last.  At the serving shape that is 48 heads x 4 tiles = 192 blocks on
// 132 SMs (two fit on one SM).  Each chunk stages B, C (Q x S), the x tile
// (Q x 16) and dt in shared memory as f32, one warp takes the prefix sum of
// dt A with shuffles, and 256 threads form the Q x Q score tile (each a
// 4 x 4 block, the C.B^T product as plain FMAs), then y (4 rows of one
// column each) and the state update (S/16 entries each).  The C.B^T tile is
// the same for every head and P tile, and is recomputed by every block.
//
// Bound on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 dense).  At
// mamba2-780m's prefill shape b=1, H=48, T=512, P=64, S=128, bf16:
//   bytes = x 3.15 MB + y 3.15 MB + final state 1.57 MB + B, C 0.26 MB
//           + dt 0.10 MB = 8.23 MB -> 2.46 us;
//   FLOPs = C.B^T once per chunk (causal half) 4 MFLOP + intra-chunk 0.10
//           GFLOP + inter-chunk 0.35 (none in the first chunk, whose state
//           is zero) + state update 0.40 = 0.86 GFLOP -> 0.87 us on bf16
//           tensor cores.
// So the bound is memory, 2.5 us.  This first version does its products
// on the CUDA cores in f32 (67 TFLOP/s peak), and each block recomputes
// C.B^T in full (about 1.6 GFLOP over the 192 blocks), which puts it near
// 40 us of arithmetic at best.  What it does about the memory bound: each
// x, dt and y element moves between device memory and the SM once, the
// state never leaves the SM between chunks, and B and C (the same for
// every head) are read from L2 after the first block.  Tensor cores and
// one C.B^T per chunk are the next step.
//
// C interface (built with nvcc into a shared library, loaded with ctypes):
// the kernel launches on the caller's stream, does not synchronise, and
// allocates nothing; the caller allocates y and final_state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int QMAX = 64;   // longest chunk: the score tile is QMAX x QMAX
constexpr int PT = 16;     // state rows (entries of P) per block
constexpr int NT = 256;    // threads per block
constexpr size_t SMEM_MAX = 232448;  // a block's shared memory on sm_90

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y).  init may be null (a
// zero initial state).  Returns the launch's cudaError_t.
int repro_ssd_fwd(const void* x, const void* dt, const void* A,
                  const void* B, const void* C, const void* init, void* y,
                  void* final_state, int b, int H, int T_len, int P, int S,
                  int Q, int dtype, void* stream) {
  if (b < 1 || H < 1 || T_len < 1 || P < PT || P % PT || S < 1 || Q < 1 ||
      Q > QMAX || Q > T_len || b > 65535 || H > 65535 ||
      smem_bytes(Q, S) > SMEM_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, B, C, init, y, final_state, b, H, T_len,
                         P, S, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, init, y, final_state, b, H,
                                 T_len, P, S, Q, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
