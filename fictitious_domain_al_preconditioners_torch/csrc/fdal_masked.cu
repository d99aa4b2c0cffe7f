// Hand-written Hopper (sm_90a) kernel K1, the Dirichlet-masked Q1 stiffness
// stencil, with a plain C interface loaded through ctypes (see ops/kernels.py,
// which builds this file with nvcc in a process of its own beside the other
// sources and holds the plain PyTorch version).  The register window, the
// plan and the walk below the kernel are in fdal_window.cuh, which the
// patched K2 op (fdal_augmented.cu) and K6 (fdal_stencil.cu) share.
//
// K1  fdal_masked_laplace_2d (float32), fdal_masked_laplace_2d_bf16
//     Replaces fictitious_domain_al_preconditioners_tpu/ops/pallas_kernels.py
//     :193 _masked_conv9_pallas (entry masked_laplace_2d, :319), in both of
//     the dtype forms the reference runs it in: float32, and bfloat16 storage
//     with float32 arithmetic and one rounding on the store (the bf16
//     V-cycle's level operator, :213-259).
//     out = m*(K0(x)M1 + M0(x)K1)(m*u) + (1-m)*u on an (ny, nx) lattice, m the
//     all-sides-Dirichlet interior mask.
//
// Bound: bytes.  One read and one write of the lattice per apply (8 B a point
// in float32, 4 B in bf16) against 30 flops a point: a streaming kernel whose
// ceiling is a device copy of the same lattice.
//
// Design.  The first kernel (one thread a point on 32 x 8 tiles, nine loads
// and eight four-compare mask tests a point, the reuse left to L1) was held
// by instructions and load issue, not by bytes: its bf16 form was no faster
// than its float32 form.  This one does per point one global load, two warp
// shuffles and seven float operations:
// - Reuse in registers.  A warp owns 32 neighbouring columns and walks down
//   a run of rows; each lane holds a rolling window of its column (the
//   masked values of the rows above, at and below the output row).  The
//   separable stencil is folded into four weights (centre, vertical,
//   horizontal, diagonal): a lane forms a = wc*z + wv*(zu + zd), its own
//   column's share, and b = wh*z + wd*(zu + zd), what its column gives to
//   each horizontal neighbour, and the output is a + b(left) + b(right) by
//   one shuffle up and one down.  Lanes 0 and 31 are the halo: a warp writes
//   KEEP = 30 columns of the 32 it loads.
// - Loads in flight.  A run is cut into chunks of U rows; a lane loads the U
//   rows of the next chunk before it computes the current one, so every warp
//   has U row segments outstanding, and there is no barrier and no shared
//   memory: warps stream independently, 9-12 blocks of 4 warps an SM.
// - Masks by warp, not by point.  A warp whose loaded rows and columns all
//   lie in the lattice interior (all but the border warps) runs a body with
//   no index test; the border warps run the masked body, which copies the
//   boundary points from the raw input value.
// - Alignment.  Rows are 2^k + 1 long, so no row but one in four (eight in
//   bf16) starts on a 16-byte boundary, and a 2D tensor-map or vector loads
//   are not to be had without a padded copy of the lattice.  The loads are
//   scalar and coalesced (a warp's row segment is 128 B in float32, 64 B in
//   bf16, and spans one sector more than an aligned one would); the
//   neighbouring warps of a block read the shared sectors from L1.
// - Small levels.  The chunk U and the run length are chosen at launch from
//   the number of lattice points (size_plan), by what was fastest on the
//   card (sweep_variants.py k1): from 2^22 points on (2049^2) chunks of 8
//   rows and runs of 32 bytes of column (8 rows in float32, 16 in bf16);
//   from 2^17 points on (513^2, 1025^2) one chunk of 4 rows; below that one
//   row a lane (three loads and one output row, every load issued at once),
//   so that a coarse level, where the launch and the latency of one pass
//   set the time, is not left to lanes walking rows in sequence.  Lattices
//   smaller than one run or one warp take the masked body.
// - bf16: the same body; a lane loads 2-byte values, widens them to float32,
//   and rounds the float32 result once on the store (__float2bfloat16_rn).
//
// Probes for measurement (compile-time, see sweep_variants.py k1; none is
// defined in the library the package builds): FDAL_K1_SEPARABLE evaluates in
// the TPU kernel's order (two vertical combinations sk, sm per column, then
// the row combination; 11 float operations); FDAL_K1_SMEM takes the
// neighbours' b through shared memory instead of shuffles; FDAL_K1_UNROLL
// fixes the chunk for every lattice and FDAL_K1_RUN the run length with it
// (a multiple of the chunk; the chunk itself if not given);
// FDAL_K1_MIN_BLOCKS caps the registers for that many blocks an SM;
// FDAL_K1_NO_COMPUTE stores the loaded value; FDAL_K1_NO_LOADS makes the
// values in registers; FDAL_K1_NO_STORES puts the stores behind a test that
// never holds.

#include "fdal_window.cuh"

#if defined(FDAL_K1_RUN) && !defined(FDAL_K1_UNROLL)
#error "FDAL_K1_RUN needs FDAL_K1_UNROLL"
#endif
#if defined(FDAL_K1_MIN_BLOCKS)
#define FDAL_K1_BOUNDS __launch_bounds__(NT, FDAL_K1_MIN_BLOCKS)
#else
#define FDAL_K1_BOUNDS __launch_bounds__(NT)
#endif

namespace {

template <typename T, int U>
__global__ void FDAL_K1_BOUNDS
masked_laplace_kernel(const T* __restrict__ u, T* __restrict__ out, int ny,
                      int nx, int run, const Stencil st) {
#if defined(FDAL_K1_SMEM)
  __shared__ float sb[WARPS][U][34];
  float* slots = &sb[threadIdx.x >> 5][0][0];
#else
  float* slots = nullptr;
#endif
  const int lane = threadIdx.x & 31;
  // the warp's first kept column; it loads cw - 1 .. cw + KEEP
  const int cw = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * KEEP;
  if (cw >= nx) return;  // the whole warp
  const int r0 = blockIdx.y * run;
  const int c = cw - 1 + lane;
  const bool inner = lane >= 1 && lane <= KEEP;
  // does the warp load a point outside the lattice interior?  (uniform)
  const bool edge = r0 < 2 || r0 + run > ny - 2 || cw < 2 ||
                    cw + KEEP > nx - 2;
  if (edge) {
    const int rows = min(run, ny - r0);
    walk<T, U, true>(u, out, ny, nx, st, c, r0, (rows + U - 1) / U,
                     inner && c < nx, slots, lane);
  } else {
    walk<T, U, false>(u, out, ny, nx, st, c, r0, run / U, inner, slots, lane);
  }
}

// The chunk and the run length for an (ny, nx) lattice of T.
template <typename T>
Plan choose_plan(int ny, int nx) {
#if defined(FDAL_K1_UNROLL)
#if defined(FDAL_K1_RUN)
  return Plan{FDAL_K1_UNROLL, FDAL_K1_RUN};
#else
  return Plan{FDAL_K1_UNROLL, FDAL_K1_UNROLL};
#endif
#else
  return size_plan((long long)ny * nx, (int)sizeof(T));
#endif
}

template <typename T, int U>
cudaError_t launch_plan(const T* u, T* out, int ny, int nx, int run,
                        const Stencil& st, cudaStream_t stream) {
  if (run < U || run % U != 0) return cudaErrorInvalidValue;
  masked_laplace_kernel<T, U><<<window_grid(ny, nx, run), NT, 0, stream>>>(
      u, out, ny, nx, run, st);
  return cudaGetLastError();
}

// The instantiation of chunk `unroll`: launch it (res == nullptr) or write
// its resources to res.
template <typename T>
cudaError_t dispatch(int unroll, const T* u, T* out, int ny, int nx, int run,
                     const Stencil& st, cudaStream_t stream, int* res) {
#define FDAL_K1_CASE(N)                                             \
  case N:                                                           \
    return res ? window_resources(masked_laplace_kernel<T, N>, res) \
               : launch_plan<T, N>(u, out, ny, nx, run, st, stream)
  switch (unroll) {
#if defined(FDAL_K1_UNROLL)
    FDAL_K1_CASE(FDAL_K1_UNROLL);
#else
    FDAL_K1_CASE(1);
    FDAL_K1_CASE(4);
    FDAL_K1_CASE(8);
#endif
    default:
      return cudaErrorInvalidValue;
  }
#undef FDAL_K1_CASE
}

template <typename T>
int launch_masked(const T* u, T* out, int ny, int nx, const float* fac,
                  void* stream) {
  if (ny < 0 || nx < 0) return (int)cudaErrorInvalidValue;
  if (ny == 0 || nx == 0) return 0;
  const Plan plan = choose_plan<T>(ny, nx);
  return (int)dispatch<T>(plan.unroll, u, out, ny, nx, plan.run,
                          make_stencil(fac), (cudaStream_t)stream, nullptr);
}

}  // namespace

extern "C" {

// fac (host): k0o, k0c, m0o, m0c, k1o, k1c, m1o, m1c, kc.  u and out are
// distinct (ny, nx) row-major device arrays.
int fdal_masked_laplace_2d(const float* u, float* out, int ny, int nx,
                           const float* fac, void* stream) {
  return launch_masked<float>(u, out, ny, nx, fac, stream);
}

// The same on bfloat16 storage (u and out); fac stays float32.
int fdal_masked_laplace_2d_bf16(const void* u, void* out, int ny, int nx,
                                const float* fac, void* stream) {
  return launch_masked<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(out),
      ny, nx, fac, stream);
}

// What one instantiation of the kernel takes of the card (bf16: the form;
// unroll: its chunk, one of fdal_masked_laplace_plan's), written to res[6]:
// registers a thread, local (spilled) bytes a thread, static shared bytes a
// block, resident blocks an SM, threads a block and columns a block writes.
int fdal_masked_laplace_resources(int bf16, int unroll, int* res) {
  const Stencil st{};
  return (int)(bf16 ? dispatch<__nv_bfloat16>(unroll, nullptr, nullptr, 0, 0,
                                              0, st, nullptr, res)
                    : dispatch<float>(unroll, nullptr, nullptr, 0, 0, 0, st,
                                      nullptr, res));
}

// The plan of a launch on an (ny, nx) lattice, written to plan[2]: the chunk
// (rows loaded ahead and unrolled) and the rows of one lane's run, which is
// the height of a block's tile (its width is res[5] above).
int fdal_masked_laplace_plan(int bf16, int ny, int nx, int* plan) {
  const Plan p = bf16 ? choose_plan<__nv_bfloat16>(ny, nx)
                      : choose_plan<float>(ny, nx);
  plan[0] = p.unroll;
  plan[1] = p.run;
  return 0;
}

}  // extern "C"
