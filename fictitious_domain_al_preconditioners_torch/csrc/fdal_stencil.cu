// Hand-written Hopper (sm_90a) kernel K6, the unconstrained Q1 stiffness
// stencil, with a plain C interface loaded through ctypes (see ops/kernels.py,
// which builds this file with nvcc beside the other sources and holds the
// plain PyTorch version).  K1, the masked stiffness stencil, is in
// fdal_masked.cu.
//
// K6  fdal_laplace_stencil_2d
//     Replaces fictitious_domain_al_preconditioners_tpu/ops/pallas_kernels.py
//     :31 _conv9_pallas together with the edge-row, edge-column and corner
//     corrections of SeparableStencil2D.__call__ (:118-146; entry
//     laplace_stencil_2d, :149).
//     out = (K0(x)M1 + M0(x)K1) u on an (ny, nx) lattice, each 1D factor
//     Toeplitz(off, centre, off) with its first and last diagonal entry
//     replaced by the boundary value (the Neumann-truncated edges of the
//     unconstrained stiffness).
//
// Bound: bytes.  One read and one write of the lattice per apply (8 B per
// point in f32, 16 B in f64) against 30 flops per point.
//
// Two forms of one body, templated on the element type: float32 (the
// V-cycles' levels) and float64 (fdal_laplace_stencil_2d_f64: the outer
// operator and the inner CGs of the elliptic interface problem, which run in
// float64).  The float64 form takes the float32 form's plan (chunk and run
// rows), so a lane's run of 8 rows is 64 B of its column.
//
// Design.  K1's register window (fdal_window.cuh: a warp owns 32 columns and
// keeps 30, each lane a 3-row window of its column, the neighbours' share by
// two shuffles, the next chunk of rows loaded before the current one is
// computed, no shared memory, no barrier).  The first kernel (one thread a
// point on 32 x 8 tiles, nine loads a point, each behind a four-compare test
// and a 64-bit index product) was held by instructions, as K1's was.
// Differences from K1: there is no mask; a point outside the lattice reads as
// 0 (no zero-padded copy, none of the TPU's 128-lane or 8-row padding); an
// edge row takes the boundary centre of the row factors (k0b, m0b) and an
// edge column that of the column factors (k1b, m1b), so the corrections cost
// no extra pass.  With sk = k0o*vsum + k0d*mid and sm = m0o*vsum + m0d*mid
// (mid the lane's value at the output row, vsum the sum of those above and
// below; k0d, m0d the row's centres, uniform over a row) a lane's own share is
// m1d*sk + k1d*sm (m1d, k1d its column's centres) and its gift to each
// neighbour m1o*sk + k1o*sm.  A warp whose output rows and kept columns hold
// no edge, and whose loaded points all lie in the lattice, runs the body
// folded into K1's four constants with no index test; the border warps run
// the body above.
//
// Probes for measurement (compile-time, see sweep_variants.py k6; none is
// defined in the library the package builds): FDAL_K6_UNROLL fixes the chunk
// for every lattice and FDAL_K6_RUN the run length with it;
// FDAL_K6_NO_COMPUTE stores the loaded value; FDAL_K6_ALL_EDGE runs the
// border body in every warp.

#include "fdal_window.cuh"

#if defined(FDAL_K6_RUN) && !defined(FDAL_K6_UNROLL)
#error "FDAL_K6_RUN needs FDAL_K6_UNROLL"
#endif

namespace {

// (off-diagonal, centre, boundary centre) of each 1D factor, and the four
// folded weights of the interior (centre, vertical, horizontal, diagonal).
template <typename T>
struct EdgeStencil {
  T k0o, k0c, k0b, m0o, m0c, m0b, k1o, k1c, k1b, m1o, m1c, m1b;
  T wc, wv, wh, wd;
};

// One lane's run: column c, output rows r0 .. r0 + nchunks*U - 1 (those
// inside the lattice).  EDGE: an output point lies on the lattice's edge or
// a loaded point outside the lattice, so loads and stores are tested and
// the centres chosen by row and column; else every test is a compile-time
// constant.  keep: the lane writes its column.  All 32 lanes of the warp run
// this together.
template <typename T, int U, bool EDGE>
__device__ __forceinline__ void stencil_walk(const T* __restrict__ u,
                                             T* __restrict__ out, int ny,
                                             int nx, const EdgeStencil<T>& st,
                                             int c, int r0, int nchunks,
                                             bool keep) {
  const bool col_in = !EDGE || (c >= 0 && c < nx);
  const bool col_edge = EDGE && (c == 0 || c == nx - 1);
  const T k1d = col_edge ? st.k1b : st.k1c;
  const T m1d = col_edge ? st.m1b : st.m1c;
  // (r0, c); dereferenced only at points inside the lattice
  const long long base = (long long)r0 * nx + c;
  const T* pin = u + base;
  T* pout = out + base;
  // the value at row r0 + k (k from -1), 0 outside the lattice
  auto load = [&](int k) -> T {
    if (!EDGE || (col_in && r0 + k >= 0 && r0 + k < ny)) {
      return __ldg(pin + k * nx);
    }
    return T(0);
  };

  T zu = load(-1);
  T zc = load(0);
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
      const T zd = cur[k];
      const T vs = zu + zd;
      T a, b;
#if defined(FDAL_K6_NO_COMPUTE)
      a = zc + T(0) * vs;
      b = T(0);
      const T acc = a;
#else
      if constexpr (EDGE) {
        const bool row_edge = r == 0 || r == ny - 1;
        const T sk = st.k0o * vs + (row_edge ? st.k0b : st.k0c) * zc;
        const T sm = st.m0o * vs + (row_edge ? st.m0b : st.m0c) * zc;
        a = m1d * sk + k1d * sm;
        b = st.m1o * sk + st.k1o * sm;
      } else {
        a = st.wc * zc + st.wv * vs;
        b = st.wh * zc + st.wd * vs;
      }
      const T acc = a + (from_left(b) + from_right(b));
#endif
      if (keep && (!EDGE || r < ny)) pout[(k0 + k) * nx] = acc;
      zu = zc;
      zc = zd;
    }
  }
}

template <typename T, int U>
__global__ void __launch_bounds__(NT)
laplace_stencil_kernel(const T* __restrict__ u, T* __restrict__ out, int ny,
                       int nx, int run, const EdgeStencil<T> st) {
  const int lane = threadIdx.x & 31;
  // the warp's first kept column; it loads cw - 1 .. cw + KEEP
  const int cw = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * KEEP;
  if (cw >= nx) return;  // the whole warp
  const int r0 = blockIdx.y * run;
  const int c = cw - 1 + lane;
  const bool inner = lane >= 1 && lane <= KEEP;
  // does the warp write an edge point or load a point outside the lattice?
  // (uniform)
#if defined(FDAL_K6_ALL_EDGE)
  const bool edge = true;
#else
  const bool edge = r0 < 1 || r0 + run > ny - 1 || cw < 1 ||
                    cw + KEEP > nx - 1;
#endif
  if (edge) {
    const int rows = min(run, ny - r0);
    stencil_walk<T, U, true>(u, out, ny, nx, st, c, r0, (rows + U - 1) / U,
                             inner && c < nx);
  } else {
    stencil_walk<T, U, false>(u, out, ny, nx, st, c, r0, run / U, inner);
  }
}

// The chunk and the run length for an (ny, nx) lattice (both forms: the
// float32 form's plan).
Plan choose_plan(int ny, int nx) {
#if defined(FDAL_K6_UNROLL)
#if defined(FDAL_K6_RUN)
  return Plan{FDAL_K6_UNROLL, FDAL_K6_RUN};
#else
  return Plan{FDAL_K6_UNROLL, FDAL_K6_UNROLL};
#endif
#else
  return size_plan((long long)ny * nx, (int)sizeof(float));
#endif
}

// fac (host): k0o, k0c, k0b, m0o, m0c, m0b, k1o, k1c, k1b, m1o, m1c, m1b.
// The folded weights are formed in double and rounded once to T.
template <typename T>
EdgeStencil<T> make_edge_stencil(const T* f) {
  const double k0o = f[0], k0c = f[1], m0o = f[3], m0c = f[4];
  const double k1o = f[6], k1c = f[7], m1o = f[9], m1c = f[10];
  return EdgeStencil<T>{f[0], f[1], f[2], f[3], f[4],  f[5],
                        f[6], f[7], f[8], f[9], f[10], f[11],
                        (T)(k0c * m1c + m0c * k1c),
                        (T)(k0o * m1c + m0o * k1c),
                        (T)(k0c * m1o + m0c * k1o),
                        (T)(k0o * m1o + m0o * k1o)};
}

template <typename T, int U>
cudaError_t launch_plan(const T* u, T* out, int ny, int nx, int run,
                        const EdgeStencil<T>& st, cudaStream_t stream) {
  if (run < U || run % U != 0) return cudaErrorInvalidValue;
  laplace_stencil_kernel<T, U><<<window_grid(ny, nx, run), NT, 0, stream>>>(
      u, out, ny, nx, run, st);
  return cudaGetLastError();
}

// The instantiation of element type T and chunk `unroll`: launch it
// (res == nullptr) or write its resources to res.
template <typename T>
cudaError_t dispatch(int unroll, const T* u, T* out, int ny, int nx, int run,
                     const EdgeStencil<T>& st, cudaStream_t stream, int* res) {
#define FDAL_K6_CASE(N)                                               \
  case N:                                                             \
    return res ? window_resources(laplace_stencil_kernel<T, N>, res)  \
               : launch_plan<T, N>(u, out, ny, nx, run, st, stream)
  switch (unroll) {
#if defined(FDAL_K6_UNROLL)
    FDAL_K6_CASE(FDAL_K6_UNROLL);
#else
    FDAL_K6_CASE(1);
    FDAL_K6_CASE(4);
    FDAL_K6_CASE(8);
#endif
    default:
      return cudaErrorInvalidValue;
  }
#undef FDAL_K6_CASE
}

}  // namespace

extern "C" {

// fac (host): k0o, k0c, k0b, m0o, m0c, m0b, k1o, k1c, k1b, m1o, m1c, m1b.
// u and out are distinct (ny, nx) row-major device arrays.
int fdal_laplace_stencil_2d(const float* u, float* out, int ny, int nx,
                            const float* fac, void* stream) {
  if (ny < 0 || nx < 0) return (int)cudaErrorInvalidValue;
  if (ny == 0 || nx == 0) return 0;
  const Plan plan = choose_plan(ny, nx);
  return (int)dispatch(plan.unroll, u, out, ny, nx, plan.run,
                       make_edge_stencil(fac), (cudaStream_t)stream, nullptr);
}

// The float64 form: the same arguments in double.
int fdal_laplace_stencil_2d_f64(const double* u, double* out, int ny, int nx,
                                const double* fac, void* stream) {
  if (ny < 0 || nx < 0) return (int)cudaErrorInvalidValue;
  if (ny == 0 || nx == 0) return 0;
  const Plan plan = choose_plan(ny, nx);
  return (int)dispatch(plan.unroll, u, out, ny, nx, plan.run,
                       make_edge_stencil(fac), (cudaStream_t)stream, nullptr);
}

// What the instantiation of chunk `unroll` (one of fdal_laplace_stencil_plan's)
// takes of the card, written to res[6]: registers a thread, local (spilled)
// bytes a thread, static shared bytes a block, resident blocks an SM,
// threads a block and columns a block writes.
int fdal_laplace_stencil_resources(int unroll, int* res) {
  return (int)dispatch<float>(unroll, nullptr, nullptr, 0, 0, 0,
                              EdgeStencil<float>{}, nullptr, res);
}

// The same for the float64 form.
int fdal_laplace_stencil_f64_resources(int unroll, int* res) {
  return (int)dispatch<double>(unroll, nullptr, nullptr, 0, 0, 0,
                               EdgeStencil<double>{}, nullptr, res);
}

// The plan of a launch on an (ny, nx) lattice, written to plan[2]: the chunk
// (rows loaded ahead and unrolled) and the rows of one lane's run, which is
// the height of a block's tile (its width is res[5] above).
int fdal_laplace_stencil_plan(int ny, int nx, int* plan) {
  const Plan p = choose_plan(ny, nx);
  plan[0] = p.unroll;
  plan[1] = p.run;
  return 0;
}

}  // extern "C"
