// Block-scaled int8 quantize / dequantize for Hopper (sm_90a): the hot
// loop of the compressed gradient reduction, with a plain C interface
// loaded from Python with ctypes (repro_torch/kernels/quantize.py).
//
// What each kernel replaces:
//   quantize  <- repro/kernels/quantize.py quantize_pallas (body
//       _quant_kernel): per block of `block` elements,
//       scale = max(absmax, 1e-12) / 127 and q = clip(round(x / scale),
//       -127, 127) as int8, one float32 scale per block.
//   dequantize <- repro/kernels/quantize.py dequantize_pallas (body
//       _dequant_kernel): x = (float)q * scale of its block, cast to the
//       output dtype.
//
// `block` is any divisor of n: from a few hundred elements up to one
// worker's shard of a whole gradient bucket (176M elements for a stacked
// qwen3-1.7b MLP weight over two workers).  The TPU grid walked one block
// per step; here a block is cut into tiles of TILE elements that lie
// wholly inside it, and every tile is one thread block (CTA), so a
// 176M-element block spreads over ~43k CTAs on all 132 SMs.
//
//   * A block that fits one tile (block <= TILE) is done by one CTA in a
//     single fused kernel: reduce the absmax, compute the scale, write q
//     and the scale (the second read of the block hits L1/L2).
//   * A larger block takes two kernels: every tile reduces its absmax
//     (warp shuffles, then shared memory) and folds it into a per-block
//     scratch word with one atomicMax on the float's bits (for
//     non-negative floats the unsigned order is the float order; the
//     scratch starts at 0 = +0.0f); then every tile reads its block's
//     absmax and writes q, and tile 0 of each block writes the scale.
//
// What bounds them on an H100: bytes.  Quantize must read n inputs and
// write n int8 plus n / block scales; the two-kernel path reads the input
// twice (the second read mostly from device memory for large blocks), so
// it moves up to ~2x its bound.  Dequantize reads n int8 and writes n
// outputs.  No tensor-core work.
//
// Exactness: the results must equal the plain PyTorch version bit for
// bit.  Division is IEEE (`x / scale`, never a reciprocal or
// __fdividef; the build has no --use_fast_math), rounding is rintf
// (half to even, as jnp.round and torch.round), the clamp floor is the
// float32 value of 1e-12 and the scale is computed in float32 exactly as
// max(absmax, 1e-12f) / 127.0f.  The inputs are assumed finite.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr long long TILE = static_cast<long long>(THREADS) * PER_THREAD;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float scale_of(float absmax) {
  return fmaxf(absmax, static_cast<float>(1e-12)) / 127.0f;
}

__device__ __forceinline__ int8_t quant(float x, float scale) {
  float r = rintf(x / scale);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(r);
}

// Max of v over the CTA; every thread gets the result.
__device__ __forceinline__ float cta_max(float v) {
  __shared__ float warp_max[THREADS / 32];
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  v = lane < THREADS / 32 ? warp_max[lane] : 0.0f;
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The tile of this CTA: block b, elements [start, end).
struct Tile {
  long long b, t, start, end;
};

__device__ __forceinline__ Tile tile_of(long long block, long long tiles) {
  Tile tl;
  const long long idx = blockIdx.x;
  tl.b = idx / tiles;
  tl.t = idx - tl.b * tiles;
  tl.start = tl.b * block + tl.t * TILE;
  const long long block_end = (tl.b + 1) * block;
  tl.end = tl.start + TILE < block_end ? tl.start + TILE : block_end;
  return tl;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_fused_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scales, long long block) {
  const long long base = static_cast<long long>(blockIdx.x) * block;
  float m = 0.0f;
  for (long long i = threadIdx.x; i < block; i += THREADS)
    m = fmaxf(m, fabsf(to_f32(x[base + i])));
  const float scale = scale_of(cta_max(m));
  for (long long i = threadIdx.x; i < block; i += THREADS)
    q[base + i] = quant(to_f32(x[base + i]), scale);
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
absmax_kernel(const T* __restrict__ x, unsigned int* __restrict__ absmax,
              long long block, long long tiles) {
  const Tile tl = tile_of(block, tiles);
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long i = tl.start + k * THREADS + threadIdx.x;
    if (i < tl.end) m = fmaxf(m, fabsf(to_f32(x[i])));
  }
  m = cta_max(m);
  if (threadIdx.x == 0) atomicMax(absmax + tl.b, __float_as_uint(m));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_tiles_kernel(const T* __restrict__ x,
                      const unsigned int* __restrict__ absmax,
                      int8_t* __restrict__ q, float* __restrict__ scales,
                      long long block, long long tiles) {
  const Tile tl = tile_of(block, tiles);
  const float scale = scale_of(__uint_as_float(absmax[tl.b]));
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long i = tl.start + k * THREADS + threadIdx.x;
    if (i < tl.end) q[i] = quant(to_f32(x[i]), scale);
  }
  if (tl.t == 0 && threadIdx.x == 0) scales[tl.b] = scale;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, T* __restrict__ out,
                  long long block, long long tiles) {
  const Tile tl = tile_of(block, tiles);
  const float scale = scales[tl.b];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long i = tl.start + k * THREADS + threadIdx.x;
    if (i < tl.end)
      out[i] = from_f32<T>(static_cast<float>(q[i]) * scale);
  }
}

template <typename T>
cudaError_t quantize_typed(const void* x, void* q, void* scales,
                           void* scratch, long long n, long long block,
                           cudaStream_t stream) {
  const long long blocks = n / block;
  if (block <= TILE) {
    quantize_fused_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0,
                               stream>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), block);
    return cudaGetLastError();
  }
  const long long tiles = (block + TILE - 1) / TILE;
  const unsigned grid = static_cast<unsigned>(blocks * tiles);
  cudaError_t err = cudaMemsetAsync(scratch, 0, blocks * sizeof(unsigned int),
                                    stream);
  if (err != cudaSuccess) return err;
  absmax_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<unsigned int*>(scratch), block,
      tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantize_tiles_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned int*>(scratch),
      static_cast<int8_t*>(q), static_cast<float*>(scales), block, tiles);
  return cudaGetLastError();
}

}  // namespace

// x (n,) float32 (dtype 0) or bfloat16 (dtype 1) -> q (n,) int8 and
// scales (n / block,) float32.  `scratch` holds n / block uint32 words
// (used only when block > TILE; zeroed here on the stream).  The caller
// checks that block divides n and that the grid fits (the wrapper does).
// Returns the CUDA error of the launches (0 on success).
extern "C" int quantize_launch(const void* x, void* q, void* scales,
                               void* scratch, long long n, long long block,
                               int dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? quantize_typed<float>(x, q, scales, scratch, n, block, s)
                 : quantize_typed<__nv_bfloat16>(x, q, scales, scratch, n,
                                                 block, s);
  return static_cast<int>(err);
}

// q (n,) int8, scales (n / block,) float32 -> out (n,) float32 (dtype 0)
// or bfloat16 (dtype 1).  Returns the CUDA error of the launch.
extern "C" int dequantize_launch(const void* q, const void* scales, void* out,
                                 long long n, long long block, int dtype,
                                 void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (block + TILE - 1) / TILE;
  const unsigned grid = static_cast<unsigned>((n / block) * tiles);
  if (dtype == 0)
    dequantize_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<float*>(out), block, tiles);
  else
    dequantize_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<__nv_bfloat16*>(out), block, tiles);
  return static_cast<int>(cudaGetLastError());
}
