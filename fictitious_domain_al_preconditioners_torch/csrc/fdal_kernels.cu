// Hand-written Hopper (sm_90a) kernel K2 of the flagship AL solve, the fused
// augmented operator and Chebyshev smoother, with a plain C interface loaded
// through ctypes (see ops/kernels.py, which builds the sources with nvcc on
// first use and holds the plain PyTorch version).  K1, the masked stiffness
// stencil, lives in fdal_masked.cu and K6 in fdal_stencil.cu.
//
// K2  fdal_fused_augmented_2d (modes op without patch / smooth / pre / post)
//     Replaces fictitious_domain_al_preconditioners_tpu/ops/pallas_kernels.py
//     :394 fused_chebyshev_2d.  The kernel, what bounds it (bytes: b and x0
//     read, x and r written, the planes read once) and its design are in
//     fdal_sweep.cuh.  This file instantiates the mode smooth and the mode op
//     of the form without patch, and holds the C entry points; pre and post,
//     the V-cycle's sweeps, are instantiated in fdal_pre.cu and fdal_post.cu,
//     so that three nvcc processes share the build.  The mode op WITH the
//     patch, one application of the operator, has a kernel of its own in
//     fdal_augmented.cu (fdal_augmented_op_2d): this entry point refuses it.

#include "fdal_sweep.cuh"

namespace {

using namespace fdal;

// The mode's instantiations: launch (s != nullptr) or resources (res).
cudaError_t run_mode(int mode, int degree, bool patch, const Sweep* s,
                     int* res, cudaStream_t st) {
  if (mode == MODE_OP) {
    // with the patch: fdal_augmented.cu
    return patch ? cudaErrorInvalidValue : run<MODE_OP, 2, false>(s, res, st);
  }
  switch (mode) {
    case MODE_SMOOTH: return run_degree<MODE_SMOOTH>(degree, patch, s, res, st);
    case MODE_PRE: return run_pre(degree, patch, s, res, st);
    case MODE_POST: return run_post(degree, patch, s, res, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// mode: 0 op, 1 smooth, 2 pre, 3 post.  planes: (5, pr, pc) device array, or
// null with pr = pc = 0 for the form without patch (the only form of op).
// fac (host): k0o, k0c, m0o, m0c, k1o, k1c, m1o, m1c, kc.  coef (host):
// inv_theta, a_1..a_{deg-1}, c_1..c_{deg-1}.  x0 is read in post mode only,
// rout written in pre mode only.
int fdal_fused_augmented_2d(int mode, int degree, const float* b,
                            const float* x0, const float* planes, float* out,
                            float* rout, int ny, int nx, const float* fac,
                            int r0, int c0, int pr, int pc, const float* coef,
                            void* stream) {
  Sweep s{};
  s.b = b;
  s.x0 = x0;
  s.planes = planes;
  s.out = out;
  s.rout = rout;
  s.ny = ny;
  s.nx = nx;
  s.box = Box{r0, c0, pr, pc};
  if (!set_weights(s, mode, degree, fac, coef)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)run_mode(mode, degree, planes != nullptr, &s, nullptr,
                       (cudaStream_t)stream);
}

// Resources of one instantiation, written to res[6]: registers a thread,
// static shared bytes, dynamic shared bytes, local (spill) bytes a thread,
// resident blocks an SM, threads a block.
int fdal_fused_augmented_resources(int mode, int degree, int patch,
                                   int* res) {
  if (mode != MODE_OP && (degree < 2 || degree > MAX_DEG)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)run_mode(mode, degree, patch != 0, nullptr, res, nullptr);
}

}  // extern "C"
