// Hand-written Hopper (sm_90a) kernel for K2's mode op with the AL patch, the
// level operator of every patched multigrid level, with a plain C interface
// loaded through ctypes (see ops/kernels.py, which builds this file with nvcc
// in a process of its own beside the other sources and holds the plain
// PyTorch version).
//
// K2 op  fdal_augmented_op_2d
//     Replaces fictitious_domain_al_preconditioners_tpu/ops/pallas_kernels.py
//     :394 fused_chebyshev_2d with mode == "op" and patch planes (:467, :612).
//     out = m*(K + patch)(m*b) + (1-m)*b on an (ny, nx) lattice: K the Q1
//     stiffness as a 9-point stencil, m the all-sides-Dirichlet interior
//     mask, the Γ-band AL patch held as 5 symmetric planes on its box
//     (centre, (0,1), (1,0), (1,1), (1,-1)): plane e at point p weighs
//     z[p+e], and the mirrored offset -e weighs z[p-e] with plane_e[p-e]
//     (z = m*b; the planes are zero outside the box).
//
// Bound: bytes.  One read and one write of the lattice (8 B a point) and one
// read of the 5 planes inside the box (20 B a point there), against 30 flops
// a point and 18 more in the box.
//
// Design.  K1's register window (fdal_window.cuh), with one change.  The
// sweep kernel that served this mode before (fdal_sweep.cuh, built to run 4-5
// applications on one staged tile) staged all 5 planes of a block into 80 KB
// of shared memory behind a barrier, to read each value back once or twice;
// for one application that machinery is cost without use, since every plane
// value is needed by exactly two points, its own and its mirror:
// - A warp whose 32 columns and run of rows miss the patch box (grown by one
//   point) runs K1's walk and loads no plane byte; the test is warp-uniform.
// - A warp that meets the box runs patch_walk.  A lane loads the 5 plane
//   values of its point straight from device memory (coalesced rows of each
//   plane; every value is read once in the launch, apart from the two halo
//   lanes of a warp and the row above a run).  The direct terms w_e[p] z[p+e]
//   use the window and the neighbours' z, which come by two shuffles a row
//   (the stiffness part then needs no shuffle of its own: its horizontal and
//   diagonal terms are sums of the same values).  The mirrored terms
//   w_e[p-e] z[p-e] are formed by the lane that owns p-e: (0,1) comes from
//   the lane to the left by a shuffle; (1,0), (1,1), (1,-1) are formed while
//   the row above is the current one and carried down as one sum, the
//   diagonals through a shuffle each.  Five shuffles, about 20 float
//   instructions and six loads a point; no shared memory, no barrier, no
//   reciprocal (op has no use for D^-1).
// - The patched walk loads a chunk's b and plane values together at the
//   chunk's start, in chunks of at most PATCH_CHUNK = 4 rows (5 planes a row
//   in registers), and does not load ahead: the resident warps of an SM hide
//   the latency.  The chunk and the run length of a launch are K1's
//   (size_plan).
//
// Probes for measurement (compile-time, see sweep_variants.py op; none is
// defined in the library the package builds): FDAL_OP_UNROLL fixes the chunk
// for every lattice and FDAL_OP_RUN the run length with it; FDAL_OP_NO_COMPUTE
// stores the loaded value (plus 0 times the sum of what else was loaded);
// FDAL_OP_NO_PLANES makes the plane values in registers; FDAL_OP_ALL_PATCHED
// switches the box test off, so that every warp runs patch_walk (its plane
// loads stay behind the test of the point).

#include "fdal_window.cuh"

#if defined(FDAL_OP_RUN) && !defined(FDAL_OP_UNROLL)
#error "FDAL_OP_RUN needs FDAL_OP_UNROLL"
#endif

namespace {

constexpr int PATCH_CHUNK = 4;  // most rows of a chunk of the patched walk

struct Box {
  int r0, c0, pr, pc;
};

// One lane's run of the patched operator: column c, output rows r0 .. r0 +
// nchunks*U - 1 (those inside the lattice).  EDGE, keep: as in walk.  All 32
// lanes of the warp run this together.
template <int U, bool EDGE>
__device__ __forceinline__ void patch_walk(const float* __restrict__ b,
                                           const float* __restrict__ planes,
                                           float* __restrict__ out, int ny,
                                           int nx, const Stencil& st,
                                           const Box& box, int c, int r0,
                                           int nchunks, bool keep) {
  const bool col_in = !EDGE || (c >= 0 && c < nx);
  const bool col_int = !EDGE || (c >= 1 && c <= nx - 2);
  // (r0, c); dereferenced only at points inside the lattice
  const long long base = (long long)r0 * nx + c;
  const float* pin = b + base;
  float* pout = out + base;
  // the value at row r0 + k (k from -1)
  auto load = [&](int k) -> float {
    if (!EDGE || (col_in && r0 + k >= 0 && r0 + k < ny)) {
      return __ldg(pin + k * nx);
    }
    return 0.f;
  };
  auto interior = [&](int r) -> bool {
    return !EDGE || (col_int && r >= 1 && r <= ny - 2);
  };
  // plane e at (r0 + k, c), 0 outside the box; pw is dereferenced only
  // inside it
  const int bc = c - box.c0, br = r0 - box.r0;
  const bool col_box = bc >= 0 && bc < box.pc;
  const long long plane = (long long)box.pr * box.pc;
  const float* pw = planes + (long long)br * box.pc + bc;
  auto weight = [&](int e, int k) -> float {
    if (col_box && br + k >= 0 && br + k < box.pr) {
#if defined(FDAL_OP_NO_PLANES)
      return (float)((br + k + bc + e) & 7);
#else
      return __ldg(pw + e * plane + k * box.pc);
#endif
    }
    return 0.f;
  };

  float vc = load(-1);
  float mu = interior(r0 - 1) ? vc : 0.f;
  // the sum of its left and right neighbours, of the row above
  float hu = from_left(mu) + from_right(mu);
  // the mirrored terms of the row above: w_(1,0) at (r-1, c), w_(1,1) at
  // (r-1, c-1) and w_(1,-1) at (r-1, c+1), times z there
  float tu = weight(2, -1) * mu + from_left(weight(3, -1) * mu) +
             from_right(weight(4, -1) * mu);
  vc = load(0);
  float mc = interior(r0) ? vc : 0.f;
  float lc = from_left(mc), rc = from_right(mc);

  for (int ch = 0; ch < nchunks; ++ch) {
    const int k0 = ch * U;  // this chunk's first row, from r0
    float cur[U], w[5][U];
#pragma unroll
    for (int k = 0; k < U; ++k) cur[k] = load(k0 + 1 + k);
#pragma unroll
    for (int k = 0; k < U; ++k) {
#pragma unroll
      for (int e = 0; e < 5; ++e) w[e][k] = weight(e, k0 + k);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int r = r0 + k0 + k;
      const float md = interior(r + 1) ? cur[k] : 0.f;
#if defined(FDAL_OP_NO_COMPUTE)
      const float acc =
          mc + 0.f * (md + w[0][k] + w[1][k] + w[2][k] + w[3][k] + w[4][k]);
      const float ld = 0.f, rd = 0.f;
#else
      const float ld = from_left(md), rd = from_right(md);
      const float acc = st.wc * mc + st.wv * (mu + md) + st.wh * (lc + rc) +
                        st.wd * (hu + (ld + rd)) + w[0][k] * mc +
                        w[1][k] * rc + w[2][k] * md + w[3][k] * rd +
                        w[4][k] * ld + from_left(w[1][k] * mc) + tu;
      tu = w[2][k] * mc + from_left(w[3][k] * mc) + from_right(w[4][k] * mc);
#endif
      if (keep && (!EDGE || r < ny)) {
        // a boundary point: the input, bit for bit
        pout[(k0 + k) * nx] = interior(r) ? acc : vc;
      }
      mu = mc;
      hu = lc + rc;
      lc = ld;
      mc = md;
      rc = rd;
      vc = cur[k];
    }
  }
}

template <int U>
__global__ void __launch_bounds__(NT)
augmented_op_kernel(const float* __restrict__ b,
                    const float* __restrict__ planes,
                    float* __restrict__ out, int ny, int nx, int run,
                    const Stencil st, const Box box) {
  constexpr int UP = U < PATCH_CHUNK ? U : PATCH_CHUNK;
  static_assert(U % UP == 0, "a run is a multiple of both chunks");
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
  const int rows = min(run, ny - r0);
  // does the warp need a plane value?  Its outputs take those of rows r0 - 1
  // .. r0 + run - 1 and columns cw - 1 .. cw + KEEP.  (uniform)
#if defined(FDAL_OP_ALL_PATCHED)
  const bool hit = true;
#else
  const bool hit = r0 - 1 < box.r0 + box.pr && r0 + run > box.r0 &&
                   cw - 1 < box.c0 + box.pc && cw + KEEP + 1 > box.c0;
#endif
  if (hit) {
    if (edge) {
      patch_walk<UP, true>(b, planes, out, ny, nx, st, box, c, r0,
                           (rows + UP - 1) / UP, inner && c < nx);
    } else {
      patch_walk<UP, false>(b, planes, out, ny, nx, st, box, c, r0, run / UP,
                            inner);
    }
  } else if (edge) {
    walk<float, U, true>(b, out, ny, nx, st, c, r0, (rows + U - 1) / U,
                         inner && c < nx, nullptr, lane);
  } else {
    walk<float, U, false>(b, out, ny, nx, st, c, r0, run / U, inner, nullptr,
                          lane);
  }
}

// The chunk and the run length for an (ny, nx) lattice.
Plan choose_plan(int ny, int nx) {
#if defined(FDAL_OP_UNROLL)
#if defined(FDAL_OP_RUN)
  return Plan{FDAL_OP_UNROLL, FDAL_OP_RUN};
#else
  return Plan{FDAL_OP_UNROLL, FDAL_OP_UNROLL};
#endif
#else
  return size_plan((long long)ny * nx, (int)sizeof(float));
#endif
}

struct OpArgs {
  const float* b;
  const float* planes;
  float* out;
  int ny, nx, run;
  Stencil st;
  Box box;
};

template <int U>
cudaError_t launch_plan(const OpArgs& a, cudaStream_t stream) {
  if (a.run < U || a.run % U != 0) return cudaErrorInvalidValue;
  augmented_op_kernel<U><<<window_grid(a.ny, a.nx, a.run), NT, 0, stream>>>(
      a.b, a.planes, a.out, a.ny, a.nx, a.run, a.st, a.box);
  return cudaGetLastError();
}

// The instantiation of chunk `unroll`: launch it (res == nullptr) or write
// its resources to res.
cudaError_t dispatch(int unroll, const OpArgs& a, cudaStream_t stream,
                     int* res) {
#define FDAL_OP_CASE(N)                                             \
  case N:                                                           \
    return res ? window_resources(augmented_op_kernel<N>, res)      \
               : launch_plan<N>(a, stream)
  switch (unroll) {
#if defined(FDAL_OP_UNROLL)
    FDAL_OP_CASE(FDAL_OP_UNROLL);
#else
    FDAL_OP_CASE(1);
    FDAL_OP_CASE(4);
    FDAL_OP_CASE(8);
#endif
    default:
      return cudaErrorInvalidValue;
  }
#undef FDAL_OP_CASE
}

}  // namespace

extern "C" {

// b and out are distinct (ny, nx) row-major device arrays; planes a
// (5, pr, pc) device array on the box of origin (r0, c0), which lies inside
// the lattice.  fac (host): k0o, k0c, m0o, m0c, k1o, k1c, m1o, m1c, kc.
int fdal_augmented_op_2d(const float* b, const float* planes, float* out,
                         int ny, int nx, const float* fac, int r0, int c0,
                         int pr, int pc, void* stream) {
  if (ny < 0 || nx < 0 || planes == nullptr || pr <= 0 || pc <= 0 ||
      r0 < 0 || c0 < 0 || r0 + pr > ny || c0 + pc > nx) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan plan = choose_plan(ny, nx);
  const OpArgs a{b, planes, out, ny, nx, plan.run, make_stencil(fac),
                 Box{r0, c0, pr, pc}};
  return (int)dispatch(plan.unroll, a, (cudaStream_t)stream, nullptr);
}

// What the instantiation of chunk `unroll` (one of fdal_augmented_op_plan's)
// takes of the card, written to res[6]: registers a thread, local (spilled)
// bytes a thread, static shared bytes a block, resident blocks an SM,
// threads a block and columns a block writes.
int fdal_augmented_op_resources(int unroll, int* res) {
  return (int)dispatch(unroll, OpArgs{}, nullptr, res);
}

// The plan of a launch on an (ny, nx) lattice, written to plan[3]: the chunk
// of the warps that miss the box, the rows of one lane's run (the height of
// a block's tile; its width is res[5] above) and the chunk of the warps that
// meet the box.
int fdal_augmented_op_plan(int ny, int nx, int* plan) {
  const Plan p = choose_plan(ny, nx);
  plan[0] = p.unroll;
  plan[1] = p.run;
  plan[2] = p.unroll < PATCH_CHUNK ? p.unroll : PATCH_CHUNK;
  return 0;
}

}  // extern "C"
