// The register window that the single-application stencil kernels share:
// K1 (fdal_masked.cu), the patched K2 op (fdal_augmented.cu) and K6
// (fdal_stencil.cu), each compiled by its own nvcc process.
//
// A warp owns 32 neighbouring columns of an (ny, nx) lattice and walks down
// a run of rows; each lane holds a rolling window of its column (the rows
// above, at and below the output row) in registers.  The separable 9-point
// stencil K0(x)M1 + M0(x)K1 is folded into four weights (centre, vertical,
// horizontal, diagonal): a lane forms a = wc*z + wv*(zu + zd), its own
// column's share, and b = wh*z + wd*(zu + zd), what its column gives to each
// horizontal neighbour, and the output is a + b(left) + b(right) by one
// shuffle up and one down.  Lanes 0 and 31 are the halo: a warp writes
// KEEP = 30 columns of the 32 it loads.  A run is cut into chunks of U rows;
// a lane loads the U rows of the next chunk before it computes the current
// one.  There is no barrier and no shared memory.  The chunk and the run
// length of a launch come from the number of lattice points (size_plan).
//
// This header holds what the three kernels have in common: the block's shape,
// the plan, the folded stencil, the shuffles, K1's walk (which the patched
// op runs on the warps that miss the patch box) and the resources query.
// Everything has internal linkage: each source instantiates its own kernels.
//
// The FDAL_K1_* probes are K1's (see fdal_masked.cu); no other source
// defines them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // warps a block, side by side in columns
constexpr int NT = 32 * WARPS;
constexpr int KEEP = 30;  // columns a warp writes (32 less the halo)
constexpr int TILE_X = WARPS * KEEP;
// lattice points from which the middle and the large plan are taken
constexpr long long MIDDLE_POINTS = 1ll << 17;
constexpr long long LARGE_POINTS = 1ll << 22;

// U: rows of one chunk, loaded ahead and unrolled; run: rows of one lane's
// run, a multiple of U.
struct Plan {
  int unroll, run;
};

// The plan for a lattice of `points` values of `bytes` each, by what was
// fastest on the card (sweep_variants.py k1): from 2^22 points on (2049^2)
// chunks of 8 rows and runs of 32 bytes of column (8 rows in float32, 16 in
// bf16); from 2^17 points on (513^2, 1025^2) one chunk of 4 rows; below that
// one row a lane (three loads and one output row, every load issued at
// once), so that a coarse level, where the launch and the latency of one
// pass set the time, is not left to lanes walking rows in sequence.
inline Plan size_plan(long long points, int bytes) {
  if (points < MIDDLE_POINTS) return Plan{1, 1};
  if (points < LARGE_POINTS) return Plan{4, 4};
  return Plan{8, 32 / bytes};
}

// The 1D factors (off-diagonal, centre) and the four folded weights of
// K0(x)M1 + M0(x)K1: centre (= Kc), vertical, horizontal, diagonal.
struct Stencil {
  float k0o, k0c, m0o, m0c, k1o, k1c, m1o, m1c;
  float wc, wv, wh, wd;
};

// fac (host): k0o, k0c, m0o, m0c, k1o, k1c, m1o, m1c, kc.
inline Stencil make_stencil(const float* f) {
  const double k0o = f[0], k0c = f[1], m0o = f[2], m0c = f[3];
  const double k1o = f[4], k1c = f[5], m1o = f[6], m1c = f[7];
  return Stencil{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
                 f[8],  // the centre is Kc as given
                 (float)(k0o * m1c + m0o * k1c),
                 (float)(k0c * m1o + m0c * k1o),
                 (float)(k0o * m1o + m0o * k1o)};
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void zero(__nv_bfloat16& v) {
  v = __float2bfloat16_rn(0.f);
}

// v of the lane to the left (lane 0: its own) and to the right (lane 31:
// its own), in float32 and (K6's float64 form) float64.
__device__ __forceinline__ float from_left(float v) {
  return __shfl_up_sync(0xffffffffu, v, 1);
}
__device__ __forceinline__ float from_right(float v) {
  return __shfl_down_sync(0xffffffffu, v, 1);
}
__device__ __forceinline__ double from_left(double v) {
  return __shfl_up_sync(0xffffffffu, v, 1);
}
__device__ __forceinline__ double from_right(double v) {
  return __shfl_down_sync(0xffffffffu, v, 1);
}

// b of the left and of the right neighbour column, summed (k: the row of
// the chunk, which names the shared-memory probe's slot).
__device__ __forceinline__ float neighbours(float b, float* slots, int k,
                                            int lane) {
#if defined(FDAL_K1_NO_COMPUTE)
  return 0.f;
#elif defined(FDAL_K1_SMEM)
  float* slot = slots + k * 34;
  slot[lane + 1] = b;
  __syncwarp();
  const float sum = slot[lane] + slot[lane + 2];
  __syncwarp();
  return sum;
#else
  return from_left(b) + from_right(b);
#endif
}

// One lane's run of the masked stiffness m*K(m*u) + (1-m)*u: column c,
// output rows r0 .. r0 + nchunks*U - 1 (those inside the lattice).  EDGE:
// some loaded point lies outside the lattice interior, so loads, masks and
// stores are tested; else every test is a compile-time constant.  keep: the
// lane writes its column.  All 32 lanes of the warp run this together (the
// shuffles need them).
template <typename T, int U, bool EDGE>
__device__ __forceinline__ void walk(const T* __restrict__ u,
                                     T* __restrict__ out, int ny, int nx,
                                     const Stencil& st, int c, int r0,
                                     int nchunks, bool keep, float* slots,
                                     int lane) {
  const bool col_in = !EDGE || (c >= 0 && c < nx);
  const bool col_int = !EDGE || (c >= 1 && c <= nx - 2);
  // (r0, c); dereferenced only at points inside the lattice
  const long long base = (long long)r0 * nx + c;
  const T* pin = u + base;
  T* pout = out + base;
  // the value at row r0 + k (k from -1)
  auto load = [&](int k) -> T {
    T v;
#if defined(FDAL_K1_NO_LOADS)
    narrow(&v, (float)((r0 + k + c) & 255));
#else
    if (!EDGE || (col_in && r0 + k >= 0 && r0 + k < ny)) {
      v = __ldg(pin + k * nx);
    } else {
      zero(v);
    }
#endif
    return v;
  };
  auto interior = [&](int r) -> bool {
    return !EDGE || (col_int && r >= 1 && r <= ny - 2);
  };

  T vc = load(-1);
  float zu = interior(r0 - 1) ? widen(vc) : 0.f;
  vc = load(0);
  float zc = interior(r0) ? widen(vc) : 0.f;
  T nxt[U];
#pragma unroll
  for (int k = 0; k < U; ++k) nxt[k] = load(1 + k);

  for (int ch = 0; ch < nchunks; ++ch) {
    const int k0 = ch * U;  // this chunk's first row, from r0
    T cur[U];
#pragma unroll
    for (int k = 0; k < U; ++k) cur[k] = nxt[k];
    if (ch + 1 < nchunks) {
#pragma unroll
      for (int k = 0; k < U; ++k) nxt[k] = load(k0 + U + 1 + k);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int r = r0 + k0 + k;
      const float zd = interior(r + 1) ? widen(cur[k]) : 0.f;
      const float vs = zu + zd;
#if defined(FDAL_K1_NO_COMPUTE)
      const float a = zc + 0.f * vs, b = 0.f;
#elif defined(FDAL_K1_SEPARABLE)
      const float sk = st.k0o * vs + st.k0c * zc;
      const float sm = st.m0o * vs + st.m0c * zc;
      const float a = st.m1c * sk + st.k1c * sm;
      const float b = st.m1o * sk + st.k1o * sm;
#else
      const float a = st.wc * zc + st.wv * vs;
      const float b = st.wh * zc + st.wd * vs;
#endif
      const float acc = a + neighbours(b, slots, k, lane);
#if defined(FDAL_K1_NO_STORES)
      if (keep && acc == 12345.678f) {
#else
      if (keep && (!EDGE || r < ny)) {
#endif
        T* q = pout + (k0 + k) * nx;
        if (interior(r)) {
          narrow(q, acc);
        } else {
          *q = vc;  // a boundary point: the input, bit for bit
        }
      }
      zu = zc;
      zc = zd;
      vc = cur[k];
    }
  }
}

// The launch grid of a kernel whose blocks write TILE_X columns and `run`
// rows.
inline dim3 window_grid(int ny, int nx, int run) {
  const int warps_x = (nx + KEEP - 1) / KEEP;
  return dim3((warps_x + WARPS - 1) / WARPS, (ny + run - 1) / run);
}

// What a kernel of NT threads and no dynamic shared memory takes of the
// card, written to res[6]: registers a thread, local (spilled) bytes a
// thread, static shared bytes a block, resident blocks an SM, threads a
// block and columns a block writes.
template <typename Kernel>
cudaError_t window_resources(Kernel kernel, int* res) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NT, 0);
  if (err != cudaSuccess) return err;
  res[0] = fa.numRegs;
  res[1] = (int)fa.localSizeBytes;
  res[2] = (int)fa.sharedSizeBytes;
  res[3] = blocks;
  res[4] = NT;
  res[5] = TILE_X;
  return cudaSuccess;
}

}  // namespace
