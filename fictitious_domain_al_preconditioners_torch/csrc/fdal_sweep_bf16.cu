// Hand-written Hopper (sm_90a) kernel K2 in bf16 storage: the fused augmented
// operator and Chebyshev sweeps of the bf16 V-cycle's levels, with a plain C
// interface loaded through ctypes (see ops/kernels.py, which builds this file
// with nvcc in a process of its own beside the other sources and holds the
// plain PyTorch version).
//
// K2 bf16  fdal_fused_augmented_2d_bf16 (modes op, smooth, pre, post)
//     Replaces no TPU kernel: the reference has no bf16 form of
//     fictitious_domain_al_preconditioners_tpu/ops/pallas_kernels.py:394
//     fused_chebyshev_2d (:451-452), so its bf16 V-cycle smooths a level with
//     the unfused Chebyshev over K1 bf16 and the 9-weight patch.  On the
//     card that composition cost about 210 PyTorch launches a level visit
//     (each smoother step the operator's 9 patch products and 8 sums on
//     strided views, a zeroed lattice and a slice write, then 6 elementwise
//     passes), 70 of them full-lattice passes: ~121 ms of device and ~224 ms
//     of host time a solve at level 0 of the 4097^2 hierarchy, against two
//     launches of K2 pre/post a visit in float32.  This source gives the bf16
//     levels those two launches.
//     The same operator and modes as the float32 K2 (fdal_sweep.cuh), on
//     bf16 lattice arrays and planes: b, x0 and the 5 planes are loaded as
//     bf16 and widened, x and r rounded once on the store
//     (__float2bfloat16_rn); b, x and p in registers, the staged m*x and
//     planes in shared memory, D^-1 and every Chebyshev update are float32,
//     as in K1's bf16 form.  Plane 0 holds the patch's centre weight w_c
//     alone, rounded to bf16 as patch_al_lattice rounds its 9 weights; the
//     kernel adds Kc (float32, as in K1 bf16) when it stages the plane, so
//     Kc + w_c and its reciprocal are formed in float32 and Kc is never
//     rounded to bf16.
//
// Bound: bytes and operations alike.  At 4097^2 a pre or post call reads
// and writes 3 x 2 B a point and reads the 5 bf16 planes once on the box
// (about 2.69M points): about 128 MB, 0.038 ms at 3.35 TB/s.  Its float32
// operations, ~142 a point at degree 4 (4 stencil applications, 3 updates),
// need 0.036 ms at 67 TFLOP/s.  At bf16 storage the sweep sits almost on the
// ridge, so the design may add no operation to save a byte.
//
// Design: the float32 sweep's, instantiated on __nv_bfloat16 storage
// (sweep_kernel<MODE, DEG, PATCH, __nv_bfloat16>; the float32
// instantiations are those of the other sources).
// Halving the lattice bytes moves the float32 design from twice its byte
// bound to its operation bound, so it keeps what holds its operations down:
// the halo recompute of the 96 x 32 tile at the same halo (H = operator
// applications of the call, nothing widened: a wider halo adds stencil
// applications on points that are thrown away), the folded four-weight
// stencil on a 3-row register window, the masks folded away off the border
// tiles, and the unpatched body on tiles that miss the box.  The loads are
// 2-byte and coalesced (a warp's row segment is 64 B); widening is one
// instruction a load and rounding one a store.  Staging stays float32, so
// shared memory (80 KB a block) and registers (launch bounds: two 384-thread
// blocks an SM) are the float32 sweep's.
//
// Every mode runs the patched instantiation.  The form without planes (a
// sharded level's row block that holds no row of the patch) is the same
// launch with a box that no tile meets: every block takes the unpatched
// body and reads no plane, so no second set of instantiations is built.

#include "fdal_sweep.cuh"

#include <climits>

namespace {

using namespace fdal;

// A patch box that no extended tile meets (hit is false in every block).
constexpr Box NO_BOX{INT_MIN / 2, INT_MIN / 2, 0, 0};

template <int MODE>
cudaError_t run_patched(int degree, const SweepBf16* s, int* res,
                        cudaStream_t st) {
  switch (degree) {
    case 2: return run<MODE, 2, true>(s, res, st);
    case 3: return run<MODE, 3, true>(s, res, st);
    case 4: return run<MODE, 4, true>(s, res, st);
    case 5: return run<MODE, 5, true>(s, res, st);
    case 6: return run<MODE, 6, true>(s, res, st);
    default: return cudaErrorInvalidValue;
  }
}

// The mode's patched instantiations: launch (s != nullptr) or resources.
cudaError_t run_mode(int mode, int degree, const SweepBf16* s, int* res,
                     cudaStream_t st) {
  switch (mode) {
    case MODE_OP: return run<MODE_OP, 2, true>(s, res, st);
    case MODE_SMOOTH: return run_patched<MODE_SMOOTH>(degree, s, res, st);
    case MODE_PRE: return run_patched<MODE_PRE>(degree, s, res, st);
    case MODE_POST: return run_patched<MODE_POST>(degree, s, res, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// fdal_fused_augmented_2d's arguments with the lattice arrays and planes in
// bf16 (__nv_bfloat16): mode 0 op, 1 smooth, 2 pre, 3 post; planes (5, pr,
// pc), or null with pr = pc = 0 for the form without patch (every mode).
int fdal_fused_augmented_2d_bf16(int mode, int degree, const void* b,
                                 const void* x0, const void* planes,
                                 void* out, void* rout, int ny, int nx,
                                 const float* fac, int r0, int c0, int pr,
                                 int pc, const float* coef, void* stream) {
  SweepBf16 s{};
  s.b = static_cast<const __nv_bfloat16*>(b);
  s.x0 = static_cast<const __nv_bfloat16*>(x0);
  s.planes = static_cast<const __nv_bfloat16*>(planes);
  s.out = static_cast<__nv_bfloat16*>(out);
  s.rout = static_cast<__nv_bfloat16*>(rout);
  s.ny = ny;
  s.nx = nx;
  s.box = planes != nullptr ? Box{r0, c0, pr, pc} : NO_BOX;
  if (!set_weights(s, mode, degree, fac, coef)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)run_mode(mode, degree, &s, nullptr, (cudaStream_t)stream);
}

// Resources of the instantiation of mode and degree (op: degree unused),
// written to res[6] as fdal_fused_augmented_resources writes them.
int fdal_fused_augmented_bf16_resources(int mode, int degree, int* res) {
  if (mode != MODE_OP && (degree < 2 || degree > MAX_DEG)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)run_mode(mode, degree, nullptr, res, nullptr);
}

}  // extern "C"
