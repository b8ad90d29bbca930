// Flash attention (forward) for Hopper (sm_90a): causal or non-causal
// grouped-query attention over a full sequence, as a CUDA kernel with a
// plain C interface loaded from Python with ctypes
// (repro_torch/kernels/flash_attention.py).
//
// What it replaces: repro/kernels/flash_attention.py flash_attention_flat
// (body _attn_kernel): softmax(q k^T / sqrt(D)) v per query head, an
// online softmax in f32 carried across key tiles, whole key tiles above
// the causal diagonal skipped (the TPU kernel's pl.when(run)) and the
// diagonal tile masked element-wise.  The TPU kernel takes q, k, v
// transposed to (B*H, S, D) and padded to a multiple of 128; this one
// reads the model's layout (B, S, H, D) in place through strides and masks
// the ragged last tile itself, so nothing is copied or padded.
//
// What bounds it on an H100: operations.  Causal attention at qwen3-1.7b's
// shape (Hq 16, Hkv 8, D 128) does 2*S*D flops per query row per half of
// the keys, against 4*S*Hkv*D bytes of K/V per row of the batch: far above
// the ~295 flops a byte where the card stops being bound by memory.  The
// TPU kernel computes in f32 and this one keeps that: f32 FMAs on the CUDA
// cores (67 TFLOP/s, not the 989 of bf16 tensor cores), with every input
// converted to f32 as it is staged.
//
// The design.  One block per (batch row, kv head, tile of 64 query rows),
// where the query rows of a kv head are its (position, query head) pairs
// flattened position-major: row f is position f / G of query head
// h*G + f % G (G = Hq/Hkv).  So one block serves all G query heads of its
// kv head and every K/V tile it stages is used by G heads (the flash-decode
// kernel's grouping), and any G works, not only divisors of the tile.  The
// block loops over tiles of 64 keys: K is staged transposed in shared
// memory, each of the 256 threads computes a 4x4 patch of the 64x64 score
// tile, the row max and sum of the online softmax are reduced across the
// 16 threads of a row with warp shuffles, P goes to shared memory, V is
// staged in K's place, and each thread accumulates 4 rows x D/16 columns
// of the output in registers.  Shared-memory rows are padded by one float
// so the column reads do not collide in a bank.  D = 128 takes 81 KB of
// dynamic shared memory, two blocks an SM.  No tensor cores, no TMA, no
// overlap of loads with compute: a simple kernel that is right first.  At
// B = 1 and S <= 128 there are only Hkv*2 blocks and the card is mostly
// idle; that is noted, not fixed.
//
// Constants kept from the TPU kernel: NEG_INF = -1e30 for masked scores
// and the running max, the max(l, 1e-30) floor of the denominator, and
// scale = 1/sqrt(D) applied to q in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;      // flattened query rows per block
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx columns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// max / sum over the 16 lanes that share a row (lanes 0-15 or 16-31)
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

template <int D>
constexpr int smem_floats() {
  // Q tile [kRows][D+1] + K^T [D][kKeys+1] (V [kKeys][D] reuses it)
  // + P [kRows][kKeys+1]
  return kRows * (D + 1) + D * (kKeys + 1) + kRows * (kKeys + 1);
}

// q: (B, S, Hq, D) with strides (q_sb, q_ss, q_sh, 1); k, v: (B, S, Hkv, D)
// with strides (*_sb, *_ss, *_sh, 1); out: (B, S, Hq, D) contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int s_len, int group, int causal, long long q_sb,
                           long long q_ss, long long q_sh, long long k_sb,
                           long long k_ss, long long k_sh, long long v_sb,
                           long long v_ss, long long v_sh, float scale) {
  constexpr int QS = D + 1;      // row stride of the Q tile
  constexpr int KS = kKeys + 1;  // row stride of K^T and of P
  constexpr int DC = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // [kRows][QS]
  float* kv = qs + kRows * QS;   // K^T [D][KS], then V [kKeys][D]
  float* ps = kv + D * KS;       // [kRows][KS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.y;  // kv head
  const int b = blockIdx.z;  // batch row
  const long long n_rows = static_cast<long long>(s_len) * group;
  const long long f0 = static_cast<long long>(blockIdx.x) * kRows;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  // the block's query rows, scaled in f32; rows past the end are zeros
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const long long f = f0 + r;
    float x = 0.f;
    if (f < n_rows) {
      const long long pos = f / group;
      const int head = h * group + static_cast<int>(f % group);
      x = to_f32(q[b * q_sb + pos * q_ss + head * q_sh + d]) * scale;
    }
    qs[r * QS + d] = x;
  }

  int qpos[4];
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = static_cast<int>((f0 + ty + 16 * i) / group);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: the last tile any row of this block can see
  const long long f_last = (f0 + kRows < n_rows ? f0 + kRows : n_rows) - 1;
  const int last_pos = static_cast<int>(f_last / group);
  const int n_tiles = causal ? last_pos / kKeys + 1
                             : (s_len + kKeys - 1) / kKeys;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile's P.V is done with kv and ps
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D;
      const int d = i % D;
      const int pos = k0 + j;
      kv[d * KS + j] =
          pos < s_len ? to_f32(kb[static_cast<long long>(pos) * k_ss + d])
                      : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[4], kr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kr[j] = kv[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = k0 + tx + 16 * j;
        if (pos >= s_len || (causal && pos > qpos[i])) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * KS + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();  // K^T is read and P is complete

    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D;
      const int d = i % D;
      const int pos = k0 + j;
      kv[j * D + d] =
          pos < s_len ? to_f32(vb[static_cast<long long>(pos) * v_ss + d])
                      : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float pr[4], vr[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * KS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vr[c] = kv[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pr[i], vr[c], acc[i][c]);
    }
  }

  const int hq = gridDim.y * group;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = f0 + ty + 16 * i;
    if (f >= n_rows) continue;
    const long long pos = f / group;
    const int head = h * group + static_cast<int>(f % group);
    T* orow = out + ((static_cast<long long>(b) * s_len + pos) * hq + head) * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) store(orow + tx + 16 * c, acc[i][c] / den);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int b,
             int s_len, int hkv, int group, int causal,
             const long long* st, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_rows = static_cast<long long>(s_len) * group;
  const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows), hkv,
                  b);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s_len, group, causal,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out, int b,
             int s_len, int hkv, int group, int head_dim, int causal,
             const long long* st, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_d<T, 32>(q, k, v, out, b, s_len, hkv, group, causal, st,
                             scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, out, b, s_len, hkv, group, causal, st,
                             scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, out, b, s_len, hkv, group, causal,
                              st, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the CUDA error of the launch as an int (0 = launched).  dtype:
// 0 = float32, 1 = bfloat16.  strides (9 values, in elements): q_sb, q_ss,
// q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh.  The Python wrapper checks
// shapes, dtypes, unit-stride head dims, head_dim in {32, 64, 128} and
// b, s_len, hkv, group >= 1.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b,
                                      int s_len, int hkv, int group,
                                      int head_dim, int causal, int dtype,
                                      const long long* strides, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(q, k, v, out, b, s_len, hkv, group, head_dim,
                           causal, strides, scale, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, out, b, s_len, hkv, group,
                                   head_dim, causal, strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
