// Mamba2 SSD chunked scan for Hopper (sm_90a), as a CUDA kernel with a
// plain C interface loaded from Python with ctypes
// (repro_torch/kernels/ssd_scan.py).
//
// What it replaces: repro/kernels/ssd_scan.py ssd_scan_pallas (body
// _ssd_kernel).  Per (batch row b, head h) and chunk of L positions:
//   dt  = softplus(dt + dt_bias[h]),  da = dt * -exp(a_log[h]),
//   cs  = prefix sum of da over the chunk,
//   y_l = sum_{s<=l} (C_l . B_s) exp(cs_l - cs_s) (x_s dt_s)
//         + exp(cs_l) C_l . S_in + d_skip[h] x_l,
//   S_out = exp(cs_last) S_in + sum_s exp(cs_last - cs_s) (x_s dt_s) B_s^T,
// with the (P, N) state S carried from chunk to chunk and written out after
// the last one; head h reads B/C group h / (H/G).  The TPU kernel walks the
// chunks as the sequential third axis of its grid with the state in VMEM
// scratch; here one block per (h, b) loops over the chunks itself and keeps
// the state in shared memory, since blocks run in no order.
//
// What bounds it on an H100.  The work itself, at mamba2-2.7b's shape in
// bf16 (B 1, S 2048, H 80, G 1), is bound by bytes: x and y are 21 MB each,
// about 14 us at 3.35 TB/s, against 8 GFLOP of matrix work (the causal
// C B^T once per group, its product with x dt and the two state terms per
// head), about 8 us on the bf16 tensor cores.  Like the TPU kernel this one
// computes in f32, on the CUDA cores (67 TFLOP/s), and it recomputes C B^T
// for every head, so what bounds this design is operations.
//
// The design.  The chunk's B and C alone are 2*L*N f32 values (256 KB at
// mamba2-2.7b's L 256, N 128), above the 227 KB a block may hold, so the
// chunk is tiled into 64-row sub-tiles: for each tile of 64 output rows l
// the block stages C_l once, starts y from the inbound-state term, and then
// walks the tiles of source rows s <= l, staging B_s and x_s dt_s, forming
// the 64x64 decayed score tile in shared memory (pairs with s > l are set
// to 0, never exp'd, so no inf reaches a product) and accumulating
// y += scores . (x dt).  Then the state update walks the source tiles once
// more.  Each of the 256 threads owns a 4 x P/16 patch of y and a
// P/16 x N/16 patch of the state update, in registers.  The prefix sum is
// a warp-shuffle scan by warp 0.  Every exponent is of a difference of f32
// prefix sums that is <= 0 where it is used, as in the reference's
// exp(segsum).  Shared memory is about 131 KB at P 64, N 128 (one block an
// SM).  At B = 1 mamba2-2.7b has 80 heads, so 80 blocks on 132 SMs; the
// score tile C_l B_s^T is the same for every head of a group and is
// recomputed per head.  Sharing it, splitting P over blocks and tensor
// cores are later changes: a simple kernel that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // rows of an l or s sub-tile
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx columns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

template <int P, int N>
constexpr int smem_floats_fixed() {
  // state [P][N+1], C tile and B tile [kTile][N+1], (x dt) tile
  // [kTile][P], scores [kTile][kTile+1]
  return P * (N + 1) + 2 * kTile * (N + 1) + kTile * P +
         kTile * (kTile + 1);
}

// x: (B, S, H, P) strides (x_sb, x_ss, x_sh, 1); dt: f32 (B, S, H) strides
// (dt_sb, dt_ss, dt_sh); b, c: (B, S, G, N) strides (*_sb, *_ss, *_sg, 1);
// a_log, d_skip, dt_bias: f32 (H,); y: (B, S, H, P) contiguous; state:
// f32 (B, H, P, N) contiguous.  Dynamic shared memory:
// smem_floats_fixed<P, N>() + 2 * chunk floats.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_log,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const float* __restrict__ d_skip,
                    const float* __restrict__ dt_bias, T* __restrict__ y,
                    float* __restrict__ state_out, int s_len, int chunk,
                    int rep, long long x_sb, long long x_ss, long long x_sh,
                    long long dt_sb, long long dt_ss, long long dt_sh,
                    long long b_sb, long long b_ss, long long b_sg,
                    long long c_sb, long long c_ss, long long c_sg) {
  constexpr int NS = N + 1;      // row stride of state, C and B tiles
  constexpr int TS = kTile + 1;  // row stride of the score tile
  constexpr int PC = P / 16;     // p columns per thread
  constexpr int NC = N / 16;     // n columns per thread (state update)
  extern __shared__ float smem[];
  float* st = smem;                 // [P][NS]
  float* ct = st + P * NS;          // [kTile][NS]  C rows l
  float* bt = ct + kTile * NS;      // [kTile][NS]  B rows s
  float* xt = bt + kTile * NS;      // [kTile][P]   x dt rows s
  float* sc = xt + kTile * P;       // [kTile][TS]
  float* cs = sc + kTile * TS;      // [chunk]      prefix sums of da
  float* dts = cs + chunk;          // [chunk]      softplus(dt + bias)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_heads = gridDim.x;
  const int g = h / rep;
  const float a = -expf(a_log[h]);
  const float bias = dt_bias[h];
  const float skip = d_skip[h];
  const T* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* bb = bm + b * b_sb + g * b_sg;
  const T* cb = cm + b * c_sb + g * c_sg;
  T* yb = y + (static_cast<long long>(b) * s_len * n_heads + h) * P;

  for (int i = tid; i < P * NS; i += kThreads) st[i] = 0.f;

  const int n_tiles = (chunk + kTile - 1) / kTile;
  for (int c0 = 0; c0 < s_len; c0 += chunk) {
    for (int l = tid; l < chunk; l += kThreads) {
      const float d = softplus(dtb[static_cast<long long>(c0 + l) * dt_ss] +
                               bias);
      dts[l] = d;
      cs[l] = d * a;
    }
    __syncthreads();
    if (tid < 32) {  // inclusive prefix sum by warp 0, 32 values a pass
      float carry = 0.f;
      for (int base = 0; base < chunk; base += 32) {
        const int l = base + tid;
        float val = l < chunk ? cs[l] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, val, off);
          if (tid >= off) val += up;
        }
        val += carry;
        if (l < chunk) cs[l] = val;
        carry = __shfl_sync(0xffffffffu, val, 31);
      }
    }
    __syncthreads();

    // ---- outputs, one tile of 64 rows l at a time ----
    for (int lt = 0; lt < n_tiles; ++lt) {
      const int l0 = lt * kTile;
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N;
        const int n = i % N;
        const int l = l0 + r;
        ct[r * NS + n] =
            l < chunk ? to_f32(cb[static_cast<long long>(c0 + l) * c_ss + n])
                      : 0.f;
      }
      __syncthreads();

      // inbound state: exp(cs_l) * C_l . S_in[p, :]
      float yacc[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) yacc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cr[4], sr[PC];
#pragma unroll
        for (int i = 0; i < 4; ++i) cr[i] = ct[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < PC; ++j) sr[j] = st[(tx + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PC; ++j) yacc[i][j] = fmaf(cr[i], sr[j], yacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty + 16 * i;
        const float e = l < chunk ? expf(cs[l]) : 0.f;
#pragma unroll
        for (int j = 0; j < PC; ++j) yacc[i][j] *= e;
      }

      // intra-chunk: the source tiles s <= l
      for (int stl = 0; stl <= lt; ++stl) {
        const int s0 = stl * kTile;
        __syncthreads();  // the previous tile's bt, xt and sc are free
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int r = i / N;
          const int n = i % N;
          const int s = s0 + r;
          bt[r * NS + n] =
              s < chunk
                  ? to_f32(bb[static_cast<long long>(c0 + s) * b_ss + n])
                  : 0.f;
        }
        for (int i = tid; i < kTile * P; i += kThreads) {
          const int r = i / P;
          const int p = i % P;
          const int s = s0 + r;
          xt[i] = s < chunk
                      ? to_f32(xb[static_cast<long long>(c0 + s) * x_ss + p]) *
                            dts[s]
                      : 0.f;
        }
        __syncthreads();

        float sv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sv[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cr[4], br[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cr[i] = ct[(ty + 16 * i) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) br[j] = bt[(tx + 16 * j) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sv[i][j] = fmaf(cr[i], br[j], sv[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            const bool live = s <= l && l < chunk;
            sc[(ty + 16 * i) * TS + tx + 16 * j] =
                live ? sv[i][j] * expf(cs[l] - cs[s]) : 0.f;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int s = 0; s < kTile; ++s) {
          float sr[4], xr[PC];
#pragma unroll
          for (int i = 0; i < 4; ++i) sr[i] = sc[(ty + 16 * i) * TS + s];
#pragma unroll
          for (int j = 0; j < PC; ++j) xr[j] = xt[s * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PC; ++j) yacc[i][j] = fmaf(sr[i], xr[j], yacc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty + 16 * i;
        if (l >= chunk) continue;
        const T* xrow = xb + static_cast<long long>(c0 + l) * x_ss;
        T* yrow = yb + static_cast<long long>(c0 + l) * n_heads * P;
#pragma unroll
        for (int j = 0; j < PC; ++j) {
          const int p = tx + 16 * j;
          store(yrow + p, yacc[i][j] + skip * to_f32(xrow[p]));
        }
      }
      __syncthreads();  // ct is free for the next tile
    }

    // ---- state update: S = exp(cs_last) S + sum_s w_s (x dt)_s B_s^T ----
    const float cs_last = cs[chunk - 1];
    float sacc[PC][NC];
#pragma unroll
    for (int i = 0; i < PC; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j)
        sacc[i][j] = expf(cs_last) * st[(ty + 16 * i) * NS + tx + 16 * j];
    for (int stl = 0; stl < n_tiles; ++stl) {
      const int s0 = stl * kTile;
      __syncthreads();
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N;
        const int n = i % N;
        const int s = s0 + r;
        bt[r * NS + n] =
            s < chunk ? to_f32(bb[static_cast<long long>(c0 + s) * b_ss + n])
                      : 0.f;
      }
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int r = i / P;
        const int p = i % P;
        const int s = s0 + r;
        xt[i] = s < chunk
                    ? to_f32(xb[static_cast<long long>(c0 + s) * x_ss + p]) *
                          dts[s] * expf(cs_last - cs[s])
                    : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < kTile; ++s) {
        float xr[PC], br[NC];
#pragma unroll
        for (int i = 0; i < PC; ++i) xr[i] = xt[s * P + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NC; ++j) br[j] = bt[s * NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < PC; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) sacc[i][j] = fmaf(xr[i], br[j], sacc[i][j]);
      }
    }
    __syncthreads();  // every thread has read the old state
#pragma unroll
    for (int i = 0; i < PC; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j)
        st[(ty + 16 * i) * NS + tx + 16 * j] = sacc[i][j];
    __syncthreads();
  }

  float* sb = state_out + (static_cast<long long>(b) * n_heads + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads)
    sb[i] = st[(i / N) * NS + i % N];
}

template <typename T, int P, int N>
int launch_pn(const void* x, const float* dt, const float* a_log,
              const void* b, const void* c, const float* d_skip,
              const float* dt_bias, void* y, float* state, int bsz,
              int s_len, int heads, int groups, int chunk,
              const long long* st, cudaStream_t stream) {
  const int bytes = (smem_floats_fixed<P, N>() + 2 * chunk) *
                    static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, bsz);
  ssd_scan_kernel<T, P, N><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(b),
      static_cast<const T*>(c), d_skip, dt_bias, static_cast<T*>(y), state,
      s_len, chunk, heads / groups, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* x, const float* dt, const float* a_log,
             const void* b, const void* c, const float* d_skip,
             const float* dt_bias, void* y, float* state, int bsz, int s_len,
             int heads, int groups, int p, int n, int chunk,
             const long long* st, cudaStream_t stream) {
#define SSD_CASE(PP, NN)                                                     \
  if (p == PP && n == NN)                                                    \
    return launch_pn<T, PP, NN>(x, dt, a_log, b, c, d_skip, dt_bias, y,      \
                                state, bsz, s_len, heads, groups, chunk, st, \
                                stream);
  SSD_CASE(16, 16)
  SSD_CASE(32, 64)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the CUDA error of the launch as an int (0 = launched).  dtype
// (of x, b, c and y): 0 = float32, 1 = bfloat16; dt, a_log, d_skip and
// dt_bias are float32.  strides (12 values, in elements): x_sb, x_ss,
// x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg.  The
// Python wrapper checks shapes, dtypes, unit-stride last dims,
// (P, N) in {(16,16), (32,64), (64,128)}, chunk in [1, 4096]
// dividing s_len, and heads a multiple of groups.
extern "C" int ssd_scan_launch(const void* x, const float* dt,
                               const float* a_log, const void* b,
                               const void* c, const float* d_skip,
                               const float* dt_bias, void* y, float* state,
                               int bsz, int s_len, int heads, int groups,
                               int p, int n, int chunk, int dtype,
                               const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(x, dt, a_log, b, c, d_skip, dt_bias, y, state,
                           bsz, s_len, heads, groups, p, n, chunk, strides,
                           s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(x, dt, a_log, b, c, d_skip, dt_bias, y,
                                   state, bsz, s_len, heads, groups, p, n,
                                   chunk, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
