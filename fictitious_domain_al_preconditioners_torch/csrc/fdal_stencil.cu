// Hand-written Hopper (sm_90a) kernels of the Q1 stiffness stencils, with a
// plain C interface loaded through ctypes (see ops/kernels.py, which builds
// this file with nvcc beside fdal_kernels.cu and holds the plain PyTorch
// versions).
//
// K1  fdal_masked_laplace_2d (float32), fdal_masked_laplace_2d_bf16
//     Replaces fictitious_domain_al_preconditioners_tpu/ops/pallas_kernels.py
//     :193 _masked_conv9_pallas (entry masked_laplace_2d, :319), in both of
//     the dtype forms the reference runs it in: float32, and bfloat16 storage
//     with float32 arithmetic (the bf16 V-cycle's level operator, :213-259).
//     out = m*(K0(x)M1 + M0(x)K1)(m*u) + (1-m)*u on an (ny, nx) lattice, m the
//     all-sides-Dirichlet interior mask.
//     Bound: bytes.  One read and one write of the lattice per apply (8 B per
//     point in float32, 4 B in bf16) against 30 flops per point.  Design: one
//     thread per output point on 32x8 tiles, the 1-point halo read straight
//     from global memory (the L1 cache serves the 9-fold reuse), so device
//     memory sees each value about once; the mask comes from the row and
//     column index.  The bf16 form loads each value with __ldg, widens it to
//     float32, does the stencil arithmetic of the float32 form and rounds
//     once on the store (__float2bfloat16_rn); boundary points are copied.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// (off-diagonal, centre) pairs of the 1D factors, plus the interior centre.
struct Stencil {
  float k0o, k0c, m0o, m0c, k1o, k1c, m1o, m1c, kc;
};

// (off-diagonal, centre, boundary centre) of each 1D factor.
struct EdgeStencil {
  float k0o, k0c, k0b, m0o, m0c, m0b, k1o, k1c, k1b, m1o, m1c, m1b;
};

__device__ __forceinline__ bool interior(int r, int c, int ny, int nx) {
  return r >= 1 && r <= ny - 2 && c >= 1 && c <= nx - 2;
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------- K1 ------

template <typename T>
__global__ void __launch_bounds__(256)
masked_laplace_kernel(const T* __restrict__ u, T* __restrict__ out, int ny,
                      int nx, Stencil st) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= ny || c >= nx) return;
  const long long i = (long long)r * nx + c;
  if (!interior(r, c, ny, nx)) {
    out[i] = u[i];
    return;
  }
  // masked input z = m*u: neighbours on the boundary read as 0
  auto z = [&](int rr, int cc) -> float {
    return interior(rr, cc, ny, nx) ? load(u + (long long)rr * nx + cc) : 0.f;
  };
  float sk[3], sm[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int cc = c + j - 1;
    const float mid = z(r, cc);
    const float vsum = z(r - 1, cc) + z(r + 1, cc);
    sk[j] = st.k0o * vsum + st.k0c * mid;
    sm[j] = st.m0o * vsum + st.m0c * mid;
  }
  store(out + i, st.m1c * sk[1] + st.m1o * (sk[0] + sk[2]) +
                     st.k1c * sm[1] + st.k1o * (sm[0] + sm[2]));
}

template <typename T>
int launch_masked(const T* u, T* out, int ny, int nx, const float* f,
                  void* stream) {
  const Stencil st{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
  dim3 block(32, 8);
  dim3 grid((nx + 31) / 32, (ny + 7) / 8);
  masked_laplace_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      u, out, ny, nx, st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K6 ------

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

// fac (host): k0o, k0c, m0o, m0c, k1o, k1c, m1o, m1c, kc.
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
