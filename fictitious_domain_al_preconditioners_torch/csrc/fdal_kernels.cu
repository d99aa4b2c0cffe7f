// Hand-written Hopper (sm_90a) kernel of the flagship AL solve's fused
// augmented operator and Chebyshev smoother, with a plain C interface loaded
// through ctypes (see ops/kernels.py, which builds this file with nvcc on first
// use and holds the plain PyTorch version).  K1, the masked stiffness stencil,
// lives in fdal_stencil.cu beside K6, which shares its design.
//
// K2  fdal_fused_augmented_2d (modes op / smooth / pre / post)
//     Replaces fictitious_domain_al_preconditioners_tpu/ops/pallas_kernels.py
//     :394 fused_chebyshev_2d.
//     The masked augmented operator A x = m*(K + patch)(m*x) + (1-m)*x, with the
//     Γ-band AL patch held as 5 symmetric planes on its box (centre, (0,1),
//     (1,0), (1,1), (1,-1)); the mirrored offsets are shifted reads
//     w_{-e}[p] = w_e[p-e].  Modes: op b -> A b; smooth b -> cheb_k(b);
//     pre b -> (x, b - A x); post (b, x0) -> x0 + cheb_k(b - A x0), with
//     D^-1 = 1/(Kc + w_c) formed in registers.
//     Bound: bytes.  Per call it reads b (and x0 in post), writes x (and r in
//     pre), and reads the planes only inside the patch box.  Design: each block
//     stages an extended tile of EY x EX points (output tile plus an H-point
//     halo, H = number of operator applications) in shared memory and runs the
//     whole Chebyshev recurrence on it, so the k applications of the sweep cost
//     one pass over device memory.  Validity shrinks by one point per
//     application in both axes; the halo pays for it.  A block whose extended
//     tile misses the patch box loads no plane bytes.

#include <cuda_runtime.h>

namespace {

constexpr int MODE_OP = 0;
constexpr int MODE_SMOOTH = 1;
constexpr int MODE_PRE = 2;
constexpr int MODE_POST = 3;

constexpr int MAX_DEG = 6;

// Extended tile of the fused kernel: EY rows x EX columns, NT threads; each
// thread owns PPT points of one column (rows ty0, ty0 + RS, ...).
constexpr int EX = 64;
constexpr int EY = 32;
constexpr int NT = 256;
constexpr int RS = NT / EX;
constexpr int PPT = EY / RS;

// 1D three-point factors of the tensor-product stencil K0(x)M1 + M0(x)K1:
// (off-diagonal, centre) pairs, plus the constant interior centre Kc.
struct Stencil {
  float k0o, k0c, m0o, m0c, k1o, k1c, m1o, m1c, kc;
};

struct Box {
  int r0, c0, pr, pc;
};

struct Cheb {
  float inv_theta;
  float a[MAX_DEG];
  float c[MAX_DEG];
};

__device__ __forceinline__ bool interior(int r, int c, int ny, int nx) {
  return r >= 1 && r <= ny - 2 && c >= 1 && c <= nx - 2;
}

// ---------------------------------------------------------------- K2 ------

template <int MODE, int DEG>
struct Halo {
  static constexpr int value =
      MODE == MODE_OP ? 1 : (DEG - 1) + (MODE == MODE_SMOOTH ? 0 : 1);
};

// One application of the masked augmented operator to the owned points.
// Z holds m*x on the extended tile; reads outside the tile are 0 (those
// results are invalid and fall in the shrinking halo).
template <bool PATCH>
__device__ __forceinline__ void apply_op(const float* __restrict__ Z,
                                         const float* __restrict__ P,
                                         const Stencil& st, int ex, int ty0,
                                         const bool (&inm)[PPT],
                                         const float (&x)[PPT],
                                         float (&ax)[PPT]) {
  auto zat = [&](int yy, int xx) -> float {
    return (yy >= 0 && yy < EY && xx >= 0 && xx < EX) ? Z[yy * EX + xx] : 0.f;
  };
  auto pat = [&](int k, int yy, int xx) -> float {
    return (yy >= 0 && yy < EY && xx >= 0 && xx < EX)
               ? P[(k * EY + yy) * EX + xx] : 0.f;
  };
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int ey = ty0 + k * RS;
    float sk[3], sm[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int xx = ex + j - 1;
      const float mid = zat(ey, xx);
      const float vsum = zat(ey - 1, xx) + zat(ey + 1, xx);
      sk[j] = st.k0o * vsum + st.k0c * mid;
      sm[j] = st.m0o * vsum + st.m0c * mid;
    }
    float acc = st.m1c * sk[1] + st.m1o * (sk[0] + sk[2]) +
                st.k1c * sm[1] + st.k1o * (sm[0] + sm[2]);
    if constexpr (PATCH) {
      const int dr[4] = {0, 1, 1, 1};
      const int dc[4] = {1, 0, 1, -1};
      float accw = pat(0, ey, ex) * zat(ey, ex);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accw += pat(e + 1, ey, ex) * zat(ey + dr[e], ex + dc[e]) +
                pat(e + 1, ey - dr[e], ex - dc[e]) *
                    zat(ey - dr[e], ex - dc[e]);
      }
      acc += accw;
    }
    ax[k] = inm[k] ? acc : x[k];
  }
}

// Z <- m*x for the owned points; the caller synchronises around it.
__device__ __forceinline__ void stage(float* __restrict__ Z, int ex, int ty0,
                                      const bool (&inm)[PPT],
                                      const float (&x)[PPT]) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    Z[(ty0 + k * RS) * EX + ex] = inm[k] ? x[k] : 0.f;
  }
}

template <bool PATCH>
__device__ __forceinline__ void op_tile(float* __restrict__ Z,
                                        const float* __restrict__ P,
                                        const Stencil& st, int ex, int ty0,
                                        const bool (&inm)[PPT],
                                        const float (&x)[PPT],
                                        float (&ax)[PPT]) {
  __syncthreads();  // previous readers of Z are done
  stage(Z, ex, ty0, inm, x);
  __syncthreads();
  apply_op<PATCH>(Z, P, st, ex, ty0, inm, x, ax);
}

template <int MODE, int DEG, bool PATCH>
__device__ __forceinline__ void fused_body(const float* __restrict__ b,
                           const float* __restrict__ x0,
                           float* __restrict__ out, float* __restrict__ rout,
                           int ny, int nx, const Stencil& st, const Cheb& ch,
                           float* Z, const float* P, const float (&wc)[PPT],
                           int gr0, int gc0, int ex, int ty0) {
  constexpr int H = Halo<MODE, DEG>::value;
  constexpr int TY = EY - 2 * H;
  constexpr int TX = EX - 2 * H;
  bool inm[PPT], inl[PPT];
  float bv[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int gr = gr0 + ty0 + k * RS, gc = gc0 + ex;
    inl[k] = gr >= 0 && gr < ny && gc >= 0 && gc < nx;
    inm[k] = interior(gr, gc, ny, nx);
    // points outside the lattice are set to 0 (a select, never a product)
    bv[k] = inl[k] ? b[(long long)gr * nx + gc] : 0.f;
  }
  float x[PPT], ax[PPT];
  if constexpr (MODE == MODE_OP) {
    op_tile<PATCH>(Z, P, st, ex, ty0, inm, bv, x);
  } else {
    float dinv[PPT], rhs[PPT], p[PPT], xin[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      dinv[k] = inm[k] ? 1.f / (st.kc + wc[k]) : 1.f;
    }
    if constexpr (MODE == MODE_POST) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int gr = gr0 + ty0 + k * RS, gc = gc0 + ex;
        xin[k] = inl[k] ? x0[(long long)gr * nx + gc] : 0.f;
      }
      op_tile<PATCH>(Z, P, st, ex, ty0, inm, xin, ax);
#pragma unroll
      for (int k = 0; k < PPT; ++k) rhs[k] = bv[k] - ax[k];
    } else {
#pragma unroll
      for (int k = 0; k < PPT; ++k) rhs[k] = bv[k];
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      x[k] = dinv[k] * rhs[k] * ch.inv_theta;
      p[k] = x[k];
    }
#pragma unroll
    for (int j = 0; j < DEG - 1; ++j) {
      op_tile<PATCH>(Z, P, st, ex, ty0, inm, x, ax);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        p[k] = ch.a[j] * p[k] + ch.c[j] * (dinv[k] * (rhs[k] - ax[k]));
        x[k] = x[k] + p[k];
      }
    }
    if constexpr (MODE == MODE_POST) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) x[k] = xin[k] + x[k];
    }
    if constexpr (MODE == MODE_PRE) {
      op_tile<PATCH>(Z, P, st, ex, ty0, inm, x, ax);
    }
  }
  // write the TY x TX interior of the extended tile
  if (ex < H || ex >= H + TX) return;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int ey = ty0 + k * RS;
    if (ey < H || ey >= H + TY || !inl[k]) continue;
    const long long i = (long long)(gr0 + ey) * nx + (gc0 + ex);
    out[i] = x[k];
    if constexpr (MODE == MODE_PRE) rout[i] = bv[k] - ax[k];
  }
}

template <int MODE, int DEG>
__global__ void __launch_bounds__(NT)
fused_augmented_kernel(const float* __restrict__ b,
                       const float* __restrict__ x0,
                       const float* __restrict__ planes,
                       float* __restrict__ out, float* __restrict__ rout,
                       int ny, int nx, Stencil st, Box box, Cheb ch) {
  constexpr int H = Halo<MODE, DEG>::value;
  constexpr int TY = EY - 2 * H;
  constexpr int TX = EX - 2 * H;
  static_assert(TY > 0 && TX > 0, "halo too large for the tile");
  extern __shared__ float smem[];
  float* Z = smem;             // EY x EX: masked iterate
  float* P = smem + EY * EX;   // 5 x EY x EX: patch planes (when hit)

  const int gr0 = blockIdx.y * TY - H;
  const int gc0 = blockIdx.x * TX - H;
  const int ex = threadIdx.x % EX;
  const int ty0 = threadIdx.x / EX;

  // does the extended tile meet the patch box?  (block-uniform)
  const bool hit = box.pr > 0 && box.pc > 0 &&
                   gr0 < box.r0 + box.pr && gr0 + EY > box.r0 &&
                   gc0 < box.c0 + box.pc && gc0 + EX > box.c0;
  float wc[PPT];
  if (hit) {
    const long long plane = (long long)box.pr * box.pc;
    for (int t = threadIdx.x; t < 5 * EY * EX; t += NT) {
      const int k = t / (EY * EX);
      const int yy = (t / EX) % EY;
      const int xx = t % EX;
      const int pr = gr0 + yy - box.r0, pc = gc0 + xx - box.c0;
      P[t] = (pr >= 0 && pr < box.pr && pc >= 0 && pc < box.pc)
                 ? planes[k * plane + (long long)pr * box.pc + pc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PPT; ++k) wc[k] = P[(ty0 + k * RS) * EX + ex];
    fused_body<MODE, DEG, true>(b, x0, out, rout, ny, nx, st, ch, Z, P, wc,
                                gr0, gc0, ex, ty0);
  } else {
#pragma unroll
    for (int k = 0; k < PPT; ++k) wc[k] = 0.f;
    fused_body<MODE, DEG, false>(b, x0, out, rout, ny, nx, st, ch, Z, P, wc,
                                 gr0, gc0, ex, ty0);
  }
}

template <int MODE, int DEG>
cudaError_t launch_fused(const float* b, const float* x0, const float* planes,
                         float* out, float* rout, int ny, int nx,
                         const Stencil& st, const Box& box, const Cheb& ch,
                         cudaStream_t stream) {
  constexpr int H = Halo<MODE, DEG>::value;
  constexpr int TY = EY - 2 * H;
  constexpr int TX = EX - 2 * H;
  const size_t shmem = sizeof(float) * 6 * EY * EX;
  cudaError_t err = cudaFuncSetAttribute(
      fused_augmented_kernel<MODE, DEG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return err;
  dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY);
  fused_augmented_kernel<MODE, DEG><<<grid, NT, shmem, stream>>>(
      b, x0, planes, out, rout, ny, nx, st, box, ch);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_degree(int degree, const float* b, const float* x0,
                            const float* planes, float* out, float* rout,
                            int ny, int nx, const Stencil& st, const Box& box,
                            const Cheb& ch, cudaStream_t s) {
  switch (degree) {
    case 2: return launch_fused<MODE, 2>(b, x0, planes, out, rout, ny, nx, st, box, ch, s);
    case 3: return launch_fused<MODE, 3>(b, x0, planes, out, rout, ny, nx, st, box, ch, s);
    case 4: return launch_fused<MODE, 4>(b, x0, planes, out, rout, ny, nx, st, box, ch, s);
    case 5: return launch_fused<MODE, 5>(b, x0, planes, out, rout, ny, nx, st, box, ch, s);
    case 6: return launch_fused<MODE, 6>(b, x0, planes, out, rout, ny, nx, st, box, ch, s);
    default: return cudaErrorInvalidValue;
  }
}

Stencil make_stencil(const float* f) {
  return Stencil{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
}

}  // namespace

extern "C" {

// mode: 0 op, 1 smooth, 2 pre, 3 post.  planes: (5, pr, pc) device array or
// null with pr = pc = 0.  coef (host): inv_theta, a_1..a_{deg-1},
// c_1..c_{deg-1}.  x0 is read in post mode only, rout written in pre mode only.
int fdal_fused_augmented_2d(int mode, int degree, const float* b,
                            const float* x0, const float* planes, float* out,
                            float* rout, int ny, int nx, const float* fac,
                            int r0, int c0, int pr, int pc, const float* coef,
                            void* stream) {
  const Stencil st = make_stencil(fac);
  const Box box{r0, c0, pr, pc};
  Cheb ch{};
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == MODE_OP) {
    return (int)launch_fused<MODE_OP, 2>(b, x0, planes, out, rout, ny, nx,
                                         st, box, ch, s);
  }
  if (degree < 2 || degree > MAX_DEG) return (int)cudaErrorInvalidValue;
  ch.inv_theta = coef[0];
  for (int j = 0; j < degree - 1; ++j) {
    ch.a[j] = coef[1 + j];
    ch.c[j] = coef[degree + j];
  }
  switch (mode) {
    case MODE_SMOOTH:
      return (int)dispatch_degree<MODE_SMOOTH>(degree, b, x0, planes, out, rout, ny, nx, st, box, ch, s);
    case MODE_PRE:
      return (int)dispatch_degree<MODE_PRE>(degree, b, x0, planes, out, rout, ny, nx, st, box, ch, s);
    case MODE_POST:
      return (int)dispatch_degree<MODE_POST>(degree, b, x0, planes, out, rout, ny, nx, st, box, ch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
