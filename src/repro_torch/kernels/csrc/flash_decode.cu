// Flash decode for Hopper (sm_90a): one-token grouped-query attention over
// a padded KV cache, with a per-row length, as a CUDA kernel with a plain
// C interface loaded from Python with ctypes
// (repro_torch/kernels/flash_decode.py).
//
// What it replaces: repro/kernels/flash_decode.py flash_decode_flat (body
// _decode_kernel): softmax(q k^T / sqrt(D)) v for one query token per
// (batch row, query head), keys at positions >= kv_len masked, online
// softmax in f32.  The TPU kernel takes one scalar kv_len and a cache
// transposed and padded to (B*Hkv, S, D) with S a multiple of 512; this
// one takes a (B,) kv_len and reads the cache in the model's own layout
// (B, S_max, Hkv, D) through strides, so nothing is copied or padded: the
// tail beyond kv_len[b] is simply never read.
//
// What bounds it on an H100: bytes.  Each (b, kv head) must read kv_len[b]
// rows of K and V (D values each) once; the arithmetic is 4*D flops per
// key per query head, far below the ~295 flops a byte the card needs
// before compute binds.  The design serves all group = Hq/Hkv query heads
// of a kv head from ONE block, so every K/V row is read once per group
// (not once per query head, as the flattened TPU grid did), and stops at
// kv_len.  One block per (b, kv head); its kWarps warps take the keys
// t = warp, warp + kWarps, ... in turn, each lane holding D/32 values of
// the row, a warp-shuffle sum per key and an f32 online softmax per
// warp; the warps' partial (m, l, acc) are merged through shared memory.
// No tensor cores and no TMA: a simple kernel that is right first.  With
// B*Hkv blocks (64 for qwen3-1.7b at 8 slots) it does not fill the card
// at long lengths; splitting the keys over more blocks is a later change.
//
// Constants kept from the TPU kernel: NEG_INF = -1e30 for the running max,
// the max(l, 1e-30) floor of the denominator, and scale = 1/sqrt(D)
// applied to q in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  a = t.x;
  b = t.y;
}

__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const float2 t =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = t.x;
  b = t.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// q: (B, Hq, D) with strides (q_sb, q_sh, 1); k, v: (B, S_max, Hkv, D)
// with strides (*_sb, *_ss, *_sh, 1); out: (B, Hq, D) contiguous.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_len, T* __restrict__ out,
                        int s_max, long long q_sb, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale) {
  constexpr int E = D / 32;  // values of a row held by each lane (2 or 4)
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // batch row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int len = kv_len[b];
  len = len < 0 ? 0 : (len > s_max ? s_max : len);

  float qv[G][E], acc[G][E], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qrow = q + b * q_sb + static_cast<long long>(h * G + g) * q_sh +
                    lane * E;
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      load2(qrow + e, qv[g][e], qv[g][e + 1]);
      qv[g][e] *= scale;
      qv[g][e + 1] *= scale;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const T* kbase = k + b * k_sb + h * k_sh + lane * E;
  const T* vbase = v + b * v_sb + h * v_sh + lane * E;
  for (int t = warp; t < len; t += kWarps) {
    float kr[E], vr[E];
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      load2(kbase + t * k_ss + e, kr[e], kr[e + 1]);
      load2(vbase + t * v_ss + e, vr[e], vr[e + 1]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s += qv[g][e] * kr[e];
      s = warp_sum(s);
      const float m_new = fmaxf(m[g], s);
      const float p = expf(s - m_new);
      const float alpha = expf(m[g] - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * alpha + p * vr[e];
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();

  // merge the warps' partial softmaxes: one thread per (g, d) output
  for (int i = threadIdx.x; i < G * D; i += kWarps * 32) {
    const int g = i / D;
    const int d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      den += sm_l[w][g] * c;
      num += sm_acc[w][g][d] * c;
    }
    store(out + (static_cast<long long>(b) * gridDim.x * G + h * G + g) * D +
              d,
          num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const int* kv_len,
             void* out, int b, int hkv, int group, int s_max,
             const long long* strides, float scale, cudaStream_t stream) {
  const dim3 grid(hkv, b);
  const dim3 block(kWarps * 32);
#define FD_CASE(G)                                                           \
  case G:                                                                    \
    flash_decode_kernel<T, D, G><<<grid, block, 0, stream>>>(                \
        static_cast<const T*>(q), static_cast<const T*>(k),                  \
        static_cast<const T*>(v), kv_len, static_cast<T*>(out), s_max,       \
        strides[0], strides[1], strides[2], strides[3], strides[4],          \
        strides[5], strides[6], strides[7], scale);                          \
    break;
  switch (group) {
    FD_CASE(1)
    FD_CASE(2)
    FD_CASE(3)
    FD_CASE(4)
    FD_CASE(5)
    FD_CASE(6)
    FD_CASE(7)
    FD_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FD_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() as an int (0 = launched).  dtype: 0 = float32,
// 1 = bfloat16.  strides (8 values, in elements): q_sb, q_sh, k_sb, k_ss,
// k_sh, v_sb, v_ss, v_sh.  The Python wrapper checks shapes, dtypes,
// alignment, head_dim in {64, 128}, group in [1, 8] and b, hkv >= 1.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const int* kv_len,
                                   void* out, int b, int hkv, int group,
                                   int s_max, int head_dim, int dtype,
                                   const long long* strides, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 128)
    return launch_d<float, 128>(q, k, v, kv_len, out, b, hkv, group, s_max,
                                strides, scale, s);
  if (dtype == 0 && head_dim == 64)
    return launch_d<float, 64>(q, k, v, kv_len, out, b, hkv, group, s_max,
                               strides, scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch_d<__nv_bfloat16, 128>(q, k, v, kv_len, out, b, hkv, group,
                                        s_max, strides, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_d<__nv_bfloat16, 64>(q, k, v, kv_len, out, b, hkv, group,
                                       s_max, strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
