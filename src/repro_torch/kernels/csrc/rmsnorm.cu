// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w over the
// last dim, and the same with a fused residual add, as CUDA kernels with a
// plain C interface loaded from Python with ctypes
// (repro_torch/kernels/rmsnorm.py).
//
// What they replace: repro/kernels/rmsnorm.py rms_norm_pallas and
// rms_norm_residual_pallas (TPU): one row reduction in f32 and an
// elementwise pass, stored in x's dtype.  The residual form computes
// r = residual + x in f32, stores r in the input dtype as the new residual
// stream, and normalises the f32 r (not its rounded copy).
//
// What bounds them on an H100: bytes (each row read once and written once,
// 4-5 flops an element), and at the serve plane's shapes (128 rows of 128,
// the per-head q/k norms of one decode step; 8 rows of 2048, the hidden
// states) the host's launch path: the device work is about a microsecond.
// So each wrapper's path is one allocation and one ctypes call into
// rms_norm_launch / rms_norm_residual_launch, with the arguments packed
// into one array.
//
// The design.  A row is held by a team of `team` lanes (a power of two),
// sized by the row width so that one kernel serves many short rows and few
// long ones: a 128-wide bf16 row is 16 vectors of 16 bytes and takes a
// team of 16 lanes, 8 rows to a block of 128 threads; a 5120-wide row
// takes a block of 256 lanes holding up to 4 vectors each.  Each lane
// loads its vectors (16 bytes where the pointers and row strides allow,
// else single elements) into registers, the sum of squares is reduced in
// f32 with warp shuffles (and through shared memory across the warps of a
// team wider than a warp), and the scaled row is stored from the same
// registers: x (and the residual) are read from device memory once.
// Teams, vector width and vectors per lane are chosen by the wrapper
// (launch_geometry) and checked here.  rms_norm_kernel and
// rms_norm_residual_kernel share that body (rms_rows<..., RESIDUAL>); the
// residual one adds the residual row as it loads and stores the f32 sum
// in the input dtype from the same registers.  Same formula as the plain
// versions, r * (1 / sqrt(var + eps)) * w in f32, so only the summation
// order differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float& o, float x) { o = x; }
__device__ __forceinline__ void from_f32(bf16& o, float x) {
  o = __float2bfloat16(x);
}

// VEC consecutive elements at p (one 16-byte access when VEC > 1) as f32
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    o[0] = to_f32(*p);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vectors are 16 bytes");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = to_f32(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    from_f32(*p, x[0]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) from_f32(e[i], x[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// weights e0 .. e0 + VEC - 1; w_kind 0: x's dtype at a 16-byte aligned
// address (vector loads), 1: float32, 2: bfloat16 (element loads)
template <typename T, int VEC>
__device__ __forceinline__ void load_w(const void* w, int w_kind, int e0,
                                       float (&o)[VEC]) {
  if (w_kind == 0) {
    load<T, VEC>(static_cast<const T*>(w) + e0, o);
  } else if (w_kind == 1) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = static_cast<const float*>(w)[e0 + i];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      o[i] = __bfloat162float(static_cast<const bf16*>(w)[e0 + i]);
  }
}

// One launch's arguments.  x (and the residual): rows of width d at
// strides x_stride (r_stride); out (and new_res): rows at o_stride.
struct Args {
  const void* x;
  const void* res;  // the residual form only
  const void* w;
  void* out;
  void* new_res;  // the residual form only
  long long rows;
  int d;
  long long x_stride, r_stride, o_stride;
  float eps;
  int team, w_kind;
  cudaStream_t stream;
};

// A block of max(team, 128) threads holds blockDim.x / team rows; lane n
// of a team holds the row's vectors n, n + team, ..., n + (VPT - 1) team.
template <typename T, int VEC, int VPT, bool RESIDUAL>
__device__ __forceinline__ void rms_rows(const Args& a) {
  __shared__ float partial[32];
  const int d = a.d, team = a.team;
  const int n_vec = d / VEC;
  const int lane = threadIdx.x & (team - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / team) +
      threadIdx.x / team;
  const bool live = row < a.rows;
  const long long r0 = live ? row : 0;
  const T* xr = static_cast<const T*>(a.x) + r0 * a.x_stride;

  float v[VPT][VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int n = lane + i * team;
    if (live && n < n_vec) {
      load<T, VEC>(xr + n * VEC, v[i]);
      if constexpr (RESIDUAL) {  // r = residual + x, stored as it is
        float rv[VEC];
        load<T, VEC>(static_cast<const T*>(a.res) + r0 * a.r_stride +
                         n * VEC, rv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[i][e] = rv[e] + v[i][e];
        store<T, VEC>(static_cast<T*>(a.new_res) + r0 * a.o_stride + n * VEC,
                      v[i]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += v[i][e] * v[i][e];
  }

  if (team <= 32) {  // a team within a warp: every lane takes part
    for (int off = team / 2; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
  } else {  // one row per block, team == blockDim.x
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < team / 32; ++i) ss += partial[i];
  }
  if (!live) return;
  const float inv = 1.f / sqrtf(ss / d + a.eps);

  T* orow = static_cast<T*>(a.out) + row * a.o_stride;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int n = lane + i * team;
    if (n < n_vec) {
      float wv[VEC], y[VEC];
      load_w<T, VEC>(a.w, a.w_kind, n * VEC, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[e] = v[i][e] * inv * wv[e];
      store<T, VEC>(orow + n * VEC, y);
    }
  }
}

template <typename T, int VEC, int VPT>
__global__ void __launch_bounds__(1024) rms_norm_kernel(const Args a) {
  rms_rows<T, VEC, VPT, false>(a);
}

template <typename T, int VEC, int VPT>
__global__ void __launch_bounds__(1024)
    rms_norm_residual_kernel(const Args a) {
  rms_rows<T, VEC, VPT, true>(a);
}

template <typename T, int VEC, int VPT, bool RESIDUAL>
int launch(const Args& a) {
  const int threads = a.team > 32 ? a.team : 128;
  const long long per_block = threads / a.team;
  const long long blocks = (a.rows + per_block - 1) / per_block;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  if constexpr (RESIDUAL) {
    rms_norm_residual_kernel<T, VEC, VPT><<<grid, threads, 0, a.stream>>>(a);
  } else {
    rms_norm_kernel<T, VEC, VPT><<<grid, threads, 0, a.stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// VPT up to MAX_VPT (a row of at most 64 f32 values a lane)
template <typename T, int VEC, int MAX_VPT, bool RESIDUAL>
int by_vpt(int vpt, const Args& a) {
  switch (vpt) {
    case 1:
      return launch<T, VEC, 1, RESIDUAL>(a);
    case 2:
      return launch<T, VEC, 2, RESIDUAL>(a);
    case 4:
      return launch<T, VEC, 4, RESIDUAL>(a);
    case 8:
      return launch<T, VEC, 8, RESIDUAL>(a);
  }
  if constexpr (MAX_VPT >= 16)
    if (vpt == 16) return launch<T, VEC, 16, RESIDUAL>(a);
  if constexpr (MAX_VPT >= 64) {
    if (vpt == 32) return launch<T, VEC, 32, RESIDUAL>(a);
    if (vpt == 64) return launch<T, VEC, 64, RESIDUAL>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The geometry checks of both entry points; then the instance for dtype,
// vec and vpt.  cfg: dtype, w_kind, vec, vpt, team as in the wrapper's
// launch_args.
template <bool RESIDUAL>
int dispatch(const long long* cfg, Args& a) {
  const int dtype = static_cast<int>(cfg[0]);
  a.w_kind = static_cast<int>(cfg[1]);
  const int vec = static_cast<int>(cfg[2]);
  const int vpt = static_cast<int>(cfg[3]);
  a.team = static_cast<int>(cfg[4]);
  const int team = a.team, d = a.d;
  if (team < 1 || team > 1024 || (team & (team - 1)) || d < 1 || vec < 1 ||
      static_cast<long long>(team) * vpt * vec < d || d % vec ||
      a.rows < 1 || a.w_kind < 0 || a.w_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && vec == 1) return by_vpt<float, 1, 64, RESIDUAL>(vpt, a);
  if (dtype == 0 && vec == 4) return by_vpt<float, 4, 16, RESIDUAL>(vpt, a);
  if (dtype == 1 && vec == 1) return by_vpt<bf16, 1, 64, RESIDUAL>(vpt, a);
  if (dtype == 1 && vec == 8) return by_vpt<bf16, 8, 8, RESIDUAL>(vpt, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

float eps_of(const long long* slot) {
  double eps;
  memcpy(&eps, slot, sizeof eps);
  return static_cast<float>(eps);
}

}  // namespace

// Both return the CUDA error of the launch as an int (0 = launched).  The
// arguments come packed in one array (one ctypes argument instead of
// fourteen: the wrapper's launch path is the cost at the serve shapes).
// The wrappers check shapes, dtypes, a unit-stride last dim, and that vec
// divides d and the rows are 16-byte aligned when vec > 1.
//
// rms_norm_launch: a[0..2] the x, weight and out pointers, a[3] rows, a[4]
// d, a[5] and a[6] the row strides of x and out (elements), a[7] dtype
// (0 = float32, 1 = bfloat16, for x and out), a[8] w_kind as load_w, a[9]
// vec (1, or 16 bytes: 4 float32 / 8 bfloat16), a[10] vpt (vectors a lane
// holds), a[11] team (a power of two <= 1024 lanes a row), all from the
// wrapper's launch_args, a[12] the stream and a[13] eps, the bits of a
// double.
extern "C" int rms_norm_launch(const long long* a) {
  Args args{reinterpret_cast<const void*>(a[0]),
            nullptr,
            reinterpret_cast<const void*>(a[1]),
            reinterpret_cast<void*>(a[2]),
            nullptr,
            a[3],
            static_cast<int>(a[4]),
            a[5],
            0,
            a[6],
            eps_of(&a[13]),
            0,
            0,
            reinterpret_cast<cudaStream_t>(a[12])};
  return dispatch<false>(&a[7], args);
}

// rms_norm_residual_launch: a[0..4] the x, residual, weight, out and
// new-residual pointers, a[5] rows, a[6] d, a[7] and a[8] the row strides
// of x and the residual (out and new_res are contiguous rows of d), a[9]
// dtype, a[10] w_kind, a[11] vec, a[12] vpt, a[13] team (as above; vec > 1
// only where x, the residual and both outputs are 16-byte aligned), all
// from the wrapper's residual_launch_args, a[14] the stream and a[15] eps.
extern "C" int rms_norm_residual_launch(const long long* a) {
  Args args{reinterpret_cast<const void*>(a[0]),
            reinterpret_cast<const void*>(a[1]),
            reinterpret_cast<const void*>(a[2]),
            reinterpret_cast<void*>(a[3]),
            reinterpret_cast<void*>(a[4]),
            a[5],
            static_cast<int>(a[6]),
            a[7],
            a[8],
            a[6],
            eps_of(&a[15]),
            0,
            0,
            reinterpret_cast<cudaStream_t>(a[14])};
  return dispatch<true>(&a[9], args);
}
