// Flash decode for Hopper (sm_90a): one-token grouped-query attention over
// a padded KV cache, with a per-row length, as CUDA kernels with a plain C
// interface loaded from Python with ctypes
// (repro_torch/kernels/flash_decode.py).
//
// What it replaces: repro/kernels/flash_decode.py flash_decode_flat (body
// _decode_kernel): softmax(q k^T / sqrt(D)) v for one query token per
// (batch row, query head), keys at positions >= kv_len masked, online
// softmax in f32.  The TPU kernel takes one scalar kv_len and a cache
// transposed and padded to (B*Hkv, S, D) with S a multiple of 512; this
// one takes a (B,) kv_len and reads the cache in the model's own layout
// (B, S_max, Hkv, D) through strides, so nothing is copied or padded: the
// tail beyond kv_len[b] is never read.
//
// What bounds it on an H100: bytes.  Each (b, kv head) must read kv_len[b]
// rows of K and V (D values each) once; the arithmetic is 4*D flops per
// key per query head, far below the ~295 flops a byte the card needs
// before compute binds.  So the design is about keeping enough bytes in
// flight on every SM, and reading each byte once:
//
// * The keys are split across blocks.  The grid is (chunk, kv head, row);
//   a chunk is `chunk` keys, its size and count chosen by the wrapper from
//   S_max alone (launch_geometry), so the lengths stay on the device and
//   the step needs no host sync.  A block whose chunk starts at or past
//   kv_len[b] exits at once.  Each block serves all G query heads of its
//   kv head, so a K/V row is read once per group, and writes a partial
//   (m, l, acc) per query head; flash_decode_merge_kernel combines the
//   partials, launched by the same call on the same stream.  Where there
//   is one chunk the split kernel writes the output itself and no merge
//   is launched.
// * K and V stream through shared memory in tiles of `tile` keys (64 for
//   rows of up to 256 bytes, 32 up to 512, else 16: at most 16 KB of K a
//   tile), copied by cp.async in 16-byte pieces into a ring of kStages
//   tiles, so the next tile's copy is in flight while this one is used.
//   A tile row's pitch is an odd number of 16-byte units, so lanes
//   reading one piece of different rows hit different banks.
// * Per tile, with kThreads threads: scores, key per thread (kThreads /
//   tile threads share a key's row, each a slice of its 8-element groups,
//   their partial dots added in shared memory); the online softmax, one
//   warp per query head (tile max, p = exp(s - m_new), l and the rescale
//   alpha); then P V, each thread holding 8 output columns of every query
//   head for a slice of the tile's keys, the slices summed once at the
//   end of the chunk.  No tensor cores: at G query heads a key the work
//   is 4*D*G flops per 2*D*esize bytes, memory bound at every supported G.
// * Sizes: 256 threads, two stages and chunks of 128 keys at the serve
//   cache's S_max = 2048, chosen by timing variants in turns on the card;
//   a deeper ring (3 or 4 stages), 128 threads or 256-key chunks were as
//   fast or slower.  What holds a block back is the latency of its chain
//   of tiles (three barriers a tile), not the copies in flight.

// Constants kept from the TPU kernel: NEG_INF = -1e30 for the running max,
// the max(l, 1e-30) floor of the denominator, and scale = 1/sqrt(D)
// applied to q in f32.  A row with kv_len 0 gives 0, as the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;
constexpr int kMaxHeadDim = 256;
constexpr int kStages = 2;  // K/V tiles a block has in shared memory
constexpr int kMaxChunks = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// 8 consecutive elements at a 16-byte aligned shared address, as f32
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x;
  o[1] = a.y;
  o[2] = a.z;
  o[3] = a.w;
  o[4] = b.x;
  o[5] = b.y;
  o[6] = b.z;
  o[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// q: (B, Hq, D) at strides (q_sb, q_sh, 1); k, v: (B, S_max, Hkv, D) at
// strides (*_sb, *_ss, *_sh, 1); out: (B, Hq, D) contiguous.  ws: the
// partials of the chunks, float32: acc (B, Hq, n_chunks, D), then m and l
// (B, Hq, n_chunks); null where n_chunks == 1.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  void* out;
  float* ws;
  int b, hkv, group, s_max, d, chunk, n_chunks, tile;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

// The split kernel's shared memory, in bytes: region 0 holds the kStages
// stages of K and V tiles and, after the last tile, the key slices'
// accumulators; then the partial scores, P, the scaled q and m, l, alpha.
struct Layout {
  int pitch;      // bytes between tile rows: an odd number of 16-byte units
  int slices;     // key slices of the P V step
  int region0, scores, probs, qs, stats, total;
};

__host__ __device__ inline Layout layout(int d, int esize, int group,
                                         int tile) {
  Layout s;
  s.pitch = 16 * ((d * esize / 16) | 1);
  const int n8 = d / 8;
  s.slices = kThreads / n8 < tile ? kThreads / n8 : tile;
  const int tiles = kStages * 2 * tile * s.pitch;
  const int red = s.slices * group * d * 4;
  s.region0 = tiles > red ? tiles : red;
  s.scores = s.region0;                          // [kThreads/tile][G][tile]
  s.probs = s.scores + kThreads * group * 4;     // [tile][G]
  s.qs = s.probs + tile * group * 4;             // [G][D]
  s.stats = s.qs + group * d * 4;                // m, l, alpha: [3][G]
  s.total = s.stats + 3 * group * 4;
  return s;
}

__device__ __forceinline__ int row_length(const Params& p, int b) {
  const int len = p.kv_len[b];
  return len < 0 ? 0 : (len > p.s_max ? p.s_max : len);
}

// grid (n_chunks, hkv, b), kThreads threads, layout(...).total bytes of
// dynamic shared memory
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    flash_decode_split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c_id = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = row_length(p, b);
  const int start = c_id * p.chunk;
  if (c_id > 0 && start >= len) return;  // chunk 0 runs even at length 0
  const int end = min(start + p.chunk, len);

  const int d = p.d, n8 = d / 8, tile = p.tile;
  const int hs = kThreads / tile;            // threads sharing a key's row
  const int n16 = d * int(sizeof(T)) / 16;   // 16-byte pieces a row
  const Layout L = layout(d, sizeof(T), G, tile);
  float* sp = reinterpret_cast<float*>(smem + L.scores);
  float* pm = reinterpret_cast<float*>(smem + L.probs);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n_tiles = (end - start + tile - 1) / tile;
  // tile kt's rows [start + kt tile, ...) of K and V, up to the end, into
  // stage kt % kStages, as one commit group (empty past the last tile, so
  // that the group count and the waits stay uniform); rows past the end
  // are not copied (and never used)
  auto load_tile = [&](int kt) {
    if (kt < n_tiles) {
      const int key0 = start + kt * tile;
      const int stage = kt % kStages;
      const int per = min(tile, end - key0) * n16;
      for (int i = tid; i < 2 * per; i += kThreads) {
        const int which = i >= per;  // 0: K, 1: V
        const int j = i - which * per;
        const int r = j / n16, c = j - r * n16;
        const T* src = (which ? vb + (key0 + r) * p.v_ss
                              : kb + (key0 + r) * p.k_ss) +
                       c * (16 / int(sizeof(T)));
        cp_async16(
            sbase + ((stage * 2 + which) * tile + r) * L.pitch + c * 16, src);
      }
    }
    cp_async_commit();
  };
  for (int kt = 0; kt < kStages - 1; ++kt) load_tile(kt);

  // q, scaled, while the first tiles are in flight
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb +
               static_cast<long long>(h) * G * p.q_sh;
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d;
    qs[i] = to_f32(q[g * p.q_sh + (i - g * d)]) * p.scale;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  const int t_s = tid % tile, h_s = tid / tile;      // score step
  const int c8 = tid % n8, ks = tid / n8;            // P V step
  const bool pv = ks < L.slices;

  for (int kt = 0; kt < n_tiles; ++kt) {
    // tile kt + kStages - 1 goes into the stage tile kt - 1 left; then
    // tile kt (kStages - 1 groups back) must have landed
    load_tile(kt + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int key0 = start + kt * tile;
    const int rows = min(tile, end - key0);
    const unsigned char* kt_s = smem + (kt % kStages) * 2 * tile * L.pitch;
    const unsigned char* vt_s = kt_s + tile * L.pitch;

    // scores: thread (t_s, h_s) takes 8-element groups h_s, h_s + hs, ...
    // of key t_s against every query head
    if (t_s < rows) {
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
      const T* krow = reinterpret_cast<const T*>(kt_s + t_s * L.pitch);
#pragma unroll 4
      for (int c = h_s; c < n8; c += hs) {
        float kv[8];
        load8(krow + c * 8, kv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float qv[8];
          load8(qs + g * d + c * 8, qv);
#pragma unroll
          for (int e = 0; e < 8; ++e) s[g] = fmaf(qv[e], kv[e], s[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) sp[(h_s * G + g) * tile + t_s] = s[g];
    }
    __syncthreads();

    // online softmax: warp w takes query heads w, w + kWarps, ...; lane
    // keys lane and lane + 32 (tile <= 64); keys past the end are masked
    for (int g = warp; g < G; g += kWarps) {
      float s0 = kNegInf, s1 = kNegInf;
      if (lane < rows) {
        s0 = 0.f;
        for (int j = 0; j < hs; ++j) s0 += sp[(j * G + g) * tile + lane];
      }
      if (lane + 32 < rows) {
        s1 = 0.f;
        for (int j = 0; j < hs; ++j) s1 += sp[(j * G + g) * tile + lane + 32];
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      if (lane < tile) pm[lane * G + g] = p0;
      if (lane + 32 < tile) pm[(lane + 32) * G + g] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // P V: thread (c8, ks) takes columns 8 c8 .. 8 c8 + 7 of every query
    // head over keys ks, ks + slices, ...
    if (pv) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float a = a_s[g];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= a;
      }
#pragma unroll 4
      for (int t = ks; t < rows; t += L.slices) {
        float vv[8];
        load8(reinterpret_cast<const T*>(vt_s + t * L.pitch) + c8 * 8, vv);
        const float* pt = pm + t * G;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pg = pt[g];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pg, vv[e], acc[g][e]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();  // the empty groups past the last tile

  // the key slices' sums, through region 0 (every copy has landed)
  float* red = reinterpret_cast<float*>(smem);
  if (pv) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red[(ks * G + g) * d + c8 * 8 + e] = acc[g][e];
  }
  __syncthreads();
  const long long row0 = (static_cast<long long>(b) * p.hkv + h) * G;
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, dd = i - g * d;
    float x = 0.f;
    for (int j = 0; j < L.slices; ++j) x += red[(j * G + g) * d + dd];
    if (p.n_chunks == 1)
      store(static_cast<T*>(p.out) + (row0 + g) * d + dd,
            x / fmaxf(l_s[g], 1e-30f));
    else
      p.ws[((row0 + g) * p.n_chunks + c_id) * d + dd] = x;
  }
  if (p.n_chunks > 1 && tid < G) {
    const long long rows_total =
        static_cast<long long>(p.b) * p.hkv * G * p.n_chunks;
    float* ws_m = p.ws + rows_total * d;
    ws_m[(row0 + tid) * p.n_chunks + c_id] = m_s[tid];
    ws_m[rows_total + (row0 + tid) * p.n_chunks + c_id] = l_s[tid];
  }
}

// grid (Hq, B), kThreads threads: out[b, hq] from the partials of the
// chunks that hold keys of row b (chunk 0 alone at length 0)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_merge_kernel(const Params p) {
  __shared__ float w_s[kMaxChunks];
  __shared__ float inv_s;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int len = row_length(p, b);
  const int nc = p.n_chunks, d = p.d;
  int live = (len + p.chunk - 1) / p.chunk;
  live = live < 1 ? 1 : (live > nc ? nc : live);
  const long long row = static_cast<long long>(b) * p.hkv * p.group + hq;
  const long long rows_total =
      static_cast<long long>(p.b) * p.hkv * p.group * nc;
  const float* acc = p.ws + row * nc * d;
  const float* m = p.ws + rows_total * d + row * nc;
  const float* l = m + rows_total;
  // warp 0: each chunk's weight exp(m_c - max m) and the denominator
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mc[kMaxChunks / 32], lc[kMaxChunks / 32];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kMaxChunks / 32; ++i) {
      const int c = lane + 32 * i;
      mc[i] = c < live ? m[c] : kNegInf;
      lc[i] = c < live ? l[c] : 0.f;
      mx = fmaxf(mx, mc[i]);
    }
    mx = warp_max(mx);
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxChunks / 32; ++i) {
      const float w = expf(mc[i] - mx);
      if (lane + 32 * i < live) w_s[lane + 32 * i] = w;
      den += lc[i] * w;
    }
    den = warp_sum(den);
    if (lane == 0) inv_s = 1.f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int dd = threadIdx.x; dd < d; dd += kThreads) {
    float num = 0.f;
    for (int c = 0; c < live; ++c) num += acc[c * d + dd] * w_s[c];
    store(static_cast<T*>(p.out) + row * d + dd, num * inv_s);
  }
}

template <typename T, int G>
int launch(const Params& p, cudaStream_t stream) {
  const Layout L = layout(p.d, sizeof(T), G, p.tile);
  // above 48 KB, raise this instance's dynamic shared memory limit (once
  // per device and size)
  static int allowed[64] = {0};
  cudaError_t e = cudaSuccess;
  if (L.total > 48 * 1024) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess && (dev >= 64 || allowed[dev] < L.total)) {
      e = cudaFuncSetAttribute(flash_decode_split_kernel<T, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L.total);
      if (e == cudaSuccess && dev < 64) allowed[dev] = L.total;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_decode_split_kernel<T, G>
      <<<dim3(p.n_chunks, p.hkv, p.b), kThreads, L.total, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.n_chunks == 1) return static_cast<int>(e);
  flash_decode_merge_kernel<T>
      <<<dim3(p.hkv * G, p.b), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_group(const Params& p, cudaStream_t stream) {
#define FD_CASE(G) \
  case G:          \
    return launch<T, G>(p, stream);
  switch (p.group) {
    FD_CASE(1)
    FD_CASE(2)
    FD_CASE(3)
    FD_CASE(4)
    FD_CASE(5)
    FD_CASE(6)
    FD_CASE(7)
    FD_CASE(8)
    FD_CASE(9)
    FD_CASE(10)
    FD_CASE(11)
    FD_CASE(12)
    FD_CASE(13)
    FD_CASE(14)
    FD_CASE(15)
    FD_CASE(16)
  }
#undef FD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the CUDA error of the launches as an int (0 = launched).  The
// arguments come packed in one array of int64 (one ctypes argument: the
// wrapper's launch path is the cost at the serve plane's lengths), as the
// wrapper's launch_args gives them: a[0..5] the q, k, v, kv_len, out and
// workspace pointers (the workspace 0 where n_chunks == 1), a[6] B, a[7]
// Hkv, a[8] group = Hq / Hkv, a[9] S_max, a[10] D, a[11] dtype (0 =
// float32, 1 = bfloat16), a[12] chunk, a[13] n_chunks, a[14] tile, a[15..22]
// the strides in elements q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
// a[23] the stream, a[24] scale (the bits of a double).  The wrapper checks
// shapes, dtypes, unit-stride head dims and the 16-byte alignment of the
// caches' rows; this checks the geometry.
extern "C" int flash_decode_launch(const long long* a) {
  double scale;
  memcpy(&scale, &a[24], sizeof scale);
  Params p{};
  p.q = reinterpret_cast<const void*>(a[0]);
  p.k = reinterpret_cast<const void*>(a[1]);
  p.v = reinterpret_cast<const void*>(a[2]);
  p.kv_len = reinterpret_cast<const int*>(a[3]);
  p.out = reinterpret_cast<void*>(a[4]);
  p.ws = reinterpret_cast<float*>(a[5]);
  p.b = static_cast<int>(a[6]);
  p.hkv = static_cast<int>(a[7]);
  p.group = static_cast<int>(a[8]);
  p.s_max = static_cast<int>(a[9]);
  p.d = static_cast<int>(a[10]);
  const int dtype = static_cast<int>(a[11]);
  p.chunk = static_cast<int>(a[12]);
  p.n_chunks = static_cast<int>(a[13]);
  p.tile = static_cast<int>(a[14]);
  p.q_sb = a[15];
  p.q_sh = a[16];
  p.k_sb = a[17];
  p.k_ss = a[18];
  p.k_sh = a[19];
  p.v_sb = a[20];
  p.v_ss = a[21];
  p.v_sh = a[22];
  p.scale = static_cast<float>(scale);
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[23]);
  if (p.b < 1 || p.b > 65535 || p.hkv < 1 || p.hkv > 65535 ||
      p.group < 1 || p.group > kMaxGroup || p.d < 8 || p.d > kMaxHeadDim ||
      p.d % 8 || p.s_max < 0 ||
      !(p.tile == 8 || p.tile == 16 || p.tile == 32 || p.tile == 64) ||
      p.chunk < p.tile || p.chunk % p.tile || p.n_chunks < 1 ||
      p.n_chunks > kMaxChunks ||
      static_cast<long long>(p.chunk) * p.n_chunks < p.s_max ||
      (p.n_chunks > 1 && p.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return by_group<float>(p, stream);
  if (dtype == 1) return by_group<bf16>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
