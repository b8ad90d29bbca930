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
// per step.  Here a thread takes groups of consecutive elements aligned
// to the start of the input (not to the blocks) and reads each with the
// widest loads it fills where x is 16-byte aligned (16 bytes for the 16
// elements of a tile's group: four loads of float32, two of bfloat16;
// one element at a time where x is not aligned, at the input's end, or
// where a block boundary cuts the group), and writes its q in one store.
//
//   * A block that fits one tile of TILE elements (block <= TILE) is
//     done by one CTA in a single fused kernel: reduce the absmax,
//     compute the scale, write q and the scale (the second read of the
//     block hits L1).  Its threads take groups of 2 to 16 elements, as
//     the block's size allows, so each divides about block / THREADS of
//     them: for the few CTAs of a small call the chain of divisions in a
//     thread is what sets the time.
//   * A larger block takes two passes over persistent CTAs.  CTA c owns
//     the contiguous span [c * span, (c + 1) * span) of the input (span a
//     multiple of TILE; the wrapper's `launch_geometry` picks the grid
//     from the card's SMs and occupancy, and the span).  Pass 1 reduces
//     the absmax of each block the span touches and writes it to the
//     partial slot c + b: walking the input, every CTA or block boundary
//     starts the next (CTA, block) piece, so the slots are distinct and
//     there are at most grid + blocks - 1 of them.  No atomics, no
//     memset: block b's pass-2 readers take exactly the slots c + b of
//     the CTAs c whose span meets b, each written by pass 1.  fmaxf is
//     exact, so the order of the partials does not matter.  Pass 2 walks
//     the span's tiles in reverse, so the last bytes pass 1 read (up to
//     the 50 MB L2 across all CTAs) are read again first, and writes q;
//     the CTA holding a block's first element writes its scale.  Block
//     boundaries are found by comparison, never by a division per
//     element: since block > TILE a tile meets at most one boundary, and
//     only such a tile compares element indices.
//   * Both passes run in one cooperative kernel with a grid barrier
//     between them (`cudaLaunchCooperativeKernel`, the grid sized to
//     what is co-resident).  As two kernels, one a pass, the same passes
//     took ~10 % more device time on the H100 (PERF.md).
//
// What bounds them on an H100: bytes.  Quantize must read n inputs and
// write n int8 plus n / block scales.  For block <= TILE the second read
// hits L1.  A larger block whose data does not fit the L2 must be read
// twice: its absmax is needed before its first q, so the floor is two
// reads of the input and one write of q (0.947 ms for the main path's
// 2 x 176M float32 shard, against the 0.526 ms bound that counts one
// read).  Dequantize reads n int8 and writes n outputs.  No tensor-core
// work.
//
// Exactness: the results must equal the plain PyTorch version bit for
// bit.  Division is IEEE (`x / scale`, never a reciprocal or
// __fdividef; the build has no --use_fast_math), rounding is rintf
// (half to even, as jnp.round and torch.round), the clamp floor is the
// float32 value of 1e-12 and the scale is computed in float32 exactly as
// max(absmax, 1e-12f) / 127.0f.  The inputs are assumed finite.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int GROUP = 16;                 // elements a thread takes a tile
constexpr long long TILE = static_cast<long long>(THREADS) * GROUP;
constexpr int PER_THREAD = 16;            // dequantize: elements a thread

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

// Max of v over the CTA; every thread gets the result.  Safe to call
// again right after (a pass meets several blocks).
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
  __syncthreads();
  return v;
}

// bfloat16 -> float32 of the two halves of a word, exactly
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The W words of a load as float32: one float each, or two bfloat16.
template <typename T, int W>
__device__ __forceinline__ void unpack(const uint32_t (&w)[W], float* v) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(w[i]);
    } else {
      v[2 * i] = bf16_lo(w[i]);
      v[2 * i + 1] = bf16_hi(w[i]);
    }
  }
}

// x[g0 + e] for e < E where g0 + e < end, else 0.  A whole group of E
// elements of an aligned x (VEC; g0 is a multiple of E) is read with the
// widest loads it fills: 16-byte ones (E sizeof(T) >= 16), else one 8- or
// 4-byte load; plain ones (LAST = false: pass 1, whose bytes pass 2 hopes
// to find in L2) or evict-first ones (LAST = true: the last read).
template <typename T, int E, bool VEC, bool LAST>
__device__ __forceinline__ void load_group(const T* __restrict__ x,
                                           long long g0, long long end,
                                           float (&v)[E]) {
  constexpr int BYTES = E * static_cast<int>(sizeof(T));
  if (VEC && g0 + E <= end) {
    if constexpr (BYTES >= 16) {
      const uint4* p = reinterpret_cast<const uint4*>(x + g0);
      uint4 a[BYTES / 16];
#pragma unroll
      for (int k = 0; k < BYTES / 16; ++k) a[k] = LAST ? __ldcs(p + k) : p[k];
#pragma unroll
      for (int k = 0; k < BYTES / 16; ++k) {
        const uint32_t w[4] = {a[k].x, a[k].y, a[k].z, a[k].w};
        unpack<T>(w, v + k * (16 / static_cast<int>(sizeof(T))));
      }
    } else if constexpr (BYTES == 8) {
      const uint2* p = reinterpret_cast<const uint2*>(x + g0);
      const uint2 a = LAST ? __ldcs(p) : *p;
      const uint32_t w[2] = {a.x, a.y};
      unpack<T>(w, v);
    } else {
      static_assert(BYTES == 4, "a group is 4, 8 or a multiple of 16 bytes");
      const unsigned int* p = reinterpret_cast<const unsigned int*>(x + g0);
      const uint32_t w[1] = {LAST ? __ldcs(p) : *p};
      unpack<T>(w, v);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[e] = g0 + e < end ? to_f32(x[g0 + e]) : 0.0f;
  }
}

// Four int8 as one little-endian word.
__device__ __forceinline__ uint32_t pack4(const int8_t* b) {
  return static_cast<uint32_t>(static_cast<uint8_t>(b[0])) |
         static_cast<uint32_t>(static_cast<uint8_t>(b[1])) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(b[2])) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(b[3])) << 24;
}

// q[g0 + e] = out[e] for begin <= g0 + e < end; a whole group as one
// evict-first store of E bytes (q is 16-byte aligned: the wrapper
// allocates it; g0 is a multiple of E).
template <int E>
__device__ __forceinline__ void store_group(int8_t* __restrict__ q,
                                            long long g0, long long begin,
                                            long long end,
                                            const int8_t (&out)[E]) {
  if (g0 >= begin && g0 + E <= end) {
    if constexpr (E == 16)
      __stcs(reinterpret_cast<uint4*>(q + g0),
             make_uint4(pack4(out), pack4(out + 4), pack4(out + 8),
                        pack4(out + 12)));
    else if constexpr (E == 8)
      __stcs(reinterpret_cast<uint2*>(q + g0),
             make_uint2(pack4(out), pack4(out + 4)));
    else if constexpr (E == 4)
      __stcs(reinterpret_cast<unsigned int*>(q + g0), pack4(out));
    else
      *reinterpret_cast<uint16_t*>(q + g0) = static_cast<uint16_t>(
          static_cast<uint8_t>(out[0]) | static_cast<uint8_t>(out[1]) << 8);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (g0 + e >= begin && g0 + e < end) q[g0 + e] = out[e];
  }
}

// One CTA of THREADS per block of at most TILE elements.  Thread t takes
// the groups of E consecutive elements (aligned to the input) first + E t,
// first + E (t + THREADS), ... that meet the block; the wrapper picks E
// (2 to 16, `fused_group`) so that every thread divides about
// block / THREADS elements: at this size the chain of IEEE divisions in
// a thread, not the bytes, sets the time.  The second read of the block
// hits L1.  A group a block boundary cuts is read and written one element
// at a time by each of its two CTAs.
template <typename T, int E, bool VEC>
__global__ void __launch_bounds__(THREADS)
quantize_fused_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scales, long long block) {
  const long long start = static_cast<long long>(blockIdx.x) * block;
  const long long end = start + block;
  const long long first = start / E * E;
  constexpr long long STEP = static_cast<long long>(THREADS) * E;
  float v[E];
  float m = 0.0f;
  for (long long g0 = first + threadIdx.x * E; g0 < end; g0 += STEP) {
    if (g0 >= start) {
      load_group<T, E, VEC, false>(x, g0, end, v);
    } else {                        // the group the block starts inside
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[e] = g0 + e >= start && g0 + e < end ? to_f32(x[g0 + e]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  const float scale = scale_of(cta_max(m));
  int8_t out[E];
  for (long long g0 = first + threadIdx.x * E; g0 < end; g0 += STEP) {
    if (g0 >= start) {
      load_group<T, E, VEC, true>(x, g0, end, v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[e] = g0 + e >= start && g0 + e < end ? to_f32(x[g0 + e]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = quant(v[e], scale);
    store_group<E>(q, g0, start, end, out);
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

// Pass 1 of a block > TILE: the absmax of every (CTA, block) piece of
// this CTA's span, into partials[c + b].
template <typename T, bool VEC>
__device__ __forceinline__ void absmax_pass(const T* __restrict__ x,
                                            float* partials, long long n,
                                            long long block, long long span) {
  const long long c = blockIdx.x;
  const long long lo = c * span;
  if (lo >= n) return;
  const long long hi = lo + span < n ? lo + span : n;
  long long b = lo / block;
  long long bend = (b + 1) * block;
  float v[GROUP];
  float m = 0.0f;
  for (long long ts = lo; ts < hi; ts += TILE) {
    const long long te = ts + TILE < hi ? ts + TILE : hi;
    const long long g0 = ts + threadIdx.x * GROUP;
    load_group<T, GROUP, VEC, false>(x, g0, te, v);
    if (te <= bend) {
#pragma unroll
      for (int e = 0; e < GROUP; ++e) m = fmaxf(m, fabsf(v[e]));
    } else {                        // block b ends inside this tile
      float m_next = 0.0f;
#pragma unroll
      for (int e = 0; e < GROUP; ++e) {
        if (g0 + e < bend) m = fmaxf(m, fabsf(v[e]));
        else m_next = fmaxf(m_next, fabsf(v[e]));
      }
      m = cta_max(m);
      if (threadIdx.x == 0) partials[c + b] = m;
      m = m_next;
      ++b;
      bend += block;
    }
  }
  m = cta_max(m);
  if (threadIdx.x == 0) partials[c + b] = m;
}

// The scale of block b from the partials of the CTAs whose spans meet
// it; written to scales[b] by the CTA that holds the block's first
// element.  The partials may have been written by this same kernel
// (cooperative launch), so they are read through L2 (__ldcg).
__device__ __forceinline__ float block_scale(const float* partials,
                                             float* scales, long long b,
                                             long long block,
                                             long long span) {
  const long long c0 = b * block / span;
  const long long c1 = ((b + 1) * block - 1) / span;
  float m = 0.0f;
  for (long long c = c0 + threadIdx.x; c <= c1; c += blockDim.x)
    m = fmaxf(m, __ldcg(partials + c + b));
  const float scale = scale_of(cta_max(m));
  if (threadIdx.x == 0 && c0 == blockIdx.x) scales[b] = scale;
  return scale;
}

// Pass 2 of a block > TILE: q of this CTA's span, its tiles in reverse.
template <typename T, bool VEC>
__device__ __forceinline__ void quantize_pass(const T* __restrict__ x,
                                              const float* partials,
                                              int8_t* __restrict__ q,
                                              float* scales, long long n,
                                              long long block,
                                              long long span) {
  const long long lo = static_cast<long long>(blockIdx.x) * span;
  if (lo >= n) return;
  const long long hi = lo + span < n ? lo + span : n;
  long long b = (hi - 1) / block;
  long long bstart = b * block;
  float scale = block_scale(partials, scales, b, block, span);
  float v[GROUP];
  int8_t out[GROUP];
  for (long long ts = lo + (hi - 1 - lo) / TILE * TILE; ts >= lo;
       ts -= TILE) {
    const long long te = ts + TILE < hi ? ts + TILE : hi;
    const long long g0 = ts + threadIdx.x * GROUP;
    load_group<T, GROUP, VEC, true>(x, g0, te, v);
    if (ts >= bstart) {
#pragma unroll
      for (int e = 0; e < GROUP; ++e) out[e] = quant(v[e], scale);
    } else {                        // block b starts inside this tile
      const float prev = block_scale(partials, scales, b - 1, block, span);
#pragma unroll
      for (int e = 0; e < GROUP; ++e)
        out[e] = quant(v[e], g0 + e >= bstart ? scale : prev);
      --b;
      bstart -= block;
      scale = prev;
    }
    store_group<GROUP>(q, g0, ts, te, out);
  }
}

// Both passes in one launch; every CTA must be resident (cooperative
// launch), and the grid barrier orders pass 1's partials before pass 2.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
quantize_cooperative_kernel(const T* __restrict__ x, float* partials,
                            int8_t* __restrict__ q, float* scales,
                            long long n, long long block, long long span) {
  absmax_pass<T, VEC>(x, partials, n, block, span);
  __threadfence();
  cg::this_grid().sync();
  quantize_pass<T, VEC>(x, partials, q, scales, n, block, span);
}

// The tile of this CTA for dequantize: block b, elements [start, end).
struct Tile {
  long long b, start, end;
};

__device__ __forceinline__ Tile tile_of(long long block, long long tiles) {
  Tile tl;
  const long long idx = blockIdx.x;
  tl.b = idx / tiles;
  const long long t = idx - tl.b * tiles;
  tl.start = tl.b * block + t * TILE;
  const long long block_end = (tl.b + 1) * block;
  tl.end = tl.start + TILE < block_end ? tl.start + TILE : block_end;
  return tl;
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

template <typename T, bool VEC>
cudaError_t quantize_typed(const void* xv, void* qv, void* sv, void* pv,
                           long long n, long long block, long long grid,
                           long long span, int group, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  int8_t* q = static_cast<int8_t*>(qv);
  float* scales = static_cast<float*>(sv);
  float* partials = static_cast<float*>(pv);
  if (block <= TILE) {
    const unsigned g = static_cast<unsigned>(grid);
    switch (group) {
      case 2:
        quantize_fused_kernel<T, 2, VEC><<<g, THREADS, 0, stream>>>(
            x, q, scales, block);
        break;
      case 4:
        quantize_fused_kernel<T, 4, VEC><<<g, THREADS, 0, stream>>>(
            x, q, scales, block);
        break;
      case 8:
        quantize_fused_kernel<T, 8, VEC><<<g, THREADS, 0, stream>>>(
            x, q, scales, block);
        break;
      case 16:
        quantize_fused_kernel<T, 16, VEC><<<g, THREADS, 0, stream>>>(
            x, q, scales, block);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
  void* args[] = {&x, &partials, &q, &scales, &n, &block, &span};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&quantize_cooperative_kernel<T, VEC>),
      dim3(static_cast<unsigned>(grid)), dim3(THREADS), args, 0, stream);
}

template <typename T, bool VEC>
cudaError_t max_grid_typed(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quantize_cooperative_kernel<T, VEC>, THREADS, 0);
  *out = per_sm * sms;
  return err;
}

}  // namespace

// x (n,) float32 (dtype 0) or bfloat16 (dtype 1) -> q (n,) int8 and
// scales (n / block,) float32, in the launch geometry the wrapper
// computed (`repro_torch.kernels.quantize.launch_geometry`): for
// block <= TILE the fused kernel, `grid` = n / block CTAs whose threads
// take `group` (2, 4, 8 or 16) elements at a time; else the
// cooperative kernel, `grid` CTAs over spans of `span` elements, with
// `partials` holding grid + n / block - 1 floats (written before they are
// read; no zeroing).  q must be 16-byte aligned; x is read 16 bytes at a
// time where it is.  Returns the CUDA error of the launch (0 on success;
// a cooperative grid larger than what is resident is refused, never run).
extern "C" int quantize_launch(const void* x, void* q, void* scales,
                               void* partials, long long n, long long block,
                               long long grid, long long span, int group,
                               int dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  cudaError_t err;
  if (dtype == 0)
    err = vec ? quantize_typed<float, true>(x, q, scales, partials, n, block,
                                            grid, span, group, s)
              : quantize_typed<float, false>(x, q, scales, partials, n,
                                             block, grid, span, group, s);
  else
    err = vec ? quantize_typed<__nv_bfloat16, true>(
                    x, q, scales, partials, n, block, grid, span, group, s)
              : quantize_typed<__nv_bfloat16, false>(
                    x, q, scales, partials, n, block, grid, span, group, s);
  return static_cast<int>(err);
}

// The most CTAs of the cooperative kernel resident at once on the
// current device (SMs x blocks per SM) for x's dtype and alignment, into
// *out.  Returns the CUDA error (0 on success).
extern "C" int quantize_max_grid(int dtype, int vec, int* out) {
  cudaError_t err;
  if (dtype == 0)
    err = vec ? max_grid_typed<float, true>(out)
              : max_grid_typed<float, false>(out);
  else
    err = vec ? max_grid_typed<__nv_bfloat16, true>(out)
              : max_grid_typed<__nv_bfloat16, false>(out);
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
