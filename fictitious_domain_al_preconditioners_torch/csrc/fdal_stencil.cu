// Hand-written Hopper (sm_90a) kernel of the unconstrained Q1 stiffness
// apply, with a plain C interface loaded through ctypes (see ops/kernels.py,
// which builds this file with nvcc beside fdal_kernels.cu and holds the plain
// PyTorch version).
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
//     Bound: bytes.  One read and one write of the lattice per apply (8 B per
//     point in f32) against 30 flops per point.  Design: the K1 layout, one
//     thread per output point on 32x8 tiles with the 1-point halo read through
//     the L1 cache.  Points outside the lattice are read as 0 by a select (no
//     zero-padded copy, none of the TPU's 128-lane or 8-row padding); edge
//     rows and columns take the boundary diagonal of their 1D factor, so the
//     corrections cost no extra pass.

#include <cuda_runtime.h>

namespace {

// (off-diagonal, centre, boundary centre) of each 1D factor.
struct EdgeStencil {
  float k0o, k0c, k0b, m0o, m0c, m0b, k1o, k1c, k1b, m1o, m1c, m1b;
};

__global__ void __launch_bounds__(256)
laplace_stencil_kernel(const float* __restrict__ u, float* __restrict__ out,
                       int ny, int nx, EdgeStencil st) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= ny || c >= nx) return;
  auto at = [&](int rr, int cc) -> float {
    return (rr >= 0 && rr < ny && cc >= 0 && cc < nx)
               ? __ldg(u + (long long)rr * nx + cc) : 0.f;
  };
  const bool redge = r == 0 || r == ny - 1;
  const bool cedge = c == 0 || c == nx - 1;
  const float k0d = redge ? st.k0b : st.k0c;
  const float m0d = redge ? st.m0b : st.m0c;
  const float k1d = cedge ? st.k1b : st.k1c;
  const float m1d = cedge ? st.m1b : st.m1c;
  float sk[3], sm[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int cc = c + j - 1;
    const float mid = at(r, cc);
    const float vsum = at(r - 1, cc) + at(r + 1, cc);
    sk[j] = st.k0o * vsum + k0d * mid;
    sm[j] = st.m0o * vsum + m0d * mid;
  }
  out[(long long)r * nx + c] = m1d * sk[1] + st.m1o * (sk[0] + sk[2]) +
                               k1d * sm[1] + st.k1o * (sm[0] + sm[2]);
}

}  // namespace

extern "C" {

// fac (host): k0o, k0c, k0b, m0o, m0c, m0b, k1o, k1c, k1b, m1o, m1c, m1b.
int fdal_laplace_stencil_2d(const float* u, float* out, int ny, int nx,
                            const float* fac, void* stream) {
  const EdgeStencil st{fac[0], fac[1], fac[2],  fac[3], fac[4],  fac[5],
                       fac[6], fac[7], fac[8], fac[9], fac[10], fac[11]};
  dim3 block(32, 8);
  dim3 grid((nx + 31) / 32, (ny + 7) / 8);
  laplace_stencil_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, out, ny, nx, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
