// K2, the fused augmented operator and Chebyshev sweeps, shared by the four
// sources that instantiate it: fdal_kernels.cu (mode smooth, mode op of the
// form without patch, and the C entry points), fdal_pre.cu (mode pre) and
// fdal_post.cu (mode post), each compiled by its own nvcc process, in
// float32 storage; fdal_sweep_bf16.cu every mode in bf16 storage.  The mode
// op with the patch in float32 is not instantiated from here: one
// application of the patched operator has a kernel of its own,
// fdal_augmented.cu.
//
// Replaces fictitious_domain_al_preconditioners_tpu/ops/pallas_kernels.py
// :394 fused_chebyshev_2d.  The masked augmented operator
//     A x = m*(K + patch)(m*x) + (1-m)*x
// on an (ny, nx) lattice, K the Q1 stiffness as a 9-point stencil, the
// Γ-band AL patch held as 5 symmetric planes on its box (centre, (0,1),
// (1,0), (1,1), (1,-1)); the mirrored offsets are shifted reads
// w_{-e}[p] = w_e[p-e].  Modes: op b -> A b; smooth b -> cheb_k(b);
// pre b -> (x, b - A x); post (b, x0) -> x0 + cheb_k(b - A x0), with
// D^-1 = 1/(Kc + w_c) on interior points and 1 on the boundary.
//
// Bound: bytes.  A call reads b (and x0 in post) and writes x (and r in
// pre) once, and reads the planes once inside the patch box: 12 B a point
// for pre and post, against about 150 flops a point at degree 4.
//
// Design.  A block stages an extended tile of EY x EX points (the output
// tile plus an H-point halo, H = operator applications of the call) and runs
// the whole recurrence on it, so the k applications cost one pass over
// device memory; validity shrinks by one point per application.  What held
// the first design (64 x 32 tile, 8 rows a thread 4 apart, 155 registers,
// one block an SM, 9-18 bounds-checked shared loads a point) and what this
// one does about it:
// - Occupancy: the patched and unpatched forms are separate instantiations
//   (PATCH), so the unpatched sweeps of K^-1 carry no patch registers;
//   __launch_bounds__(NT, MIN_BLOCKS) holds both at 80 registers a thread
//   and two 384-thread blocks an SM (24 warps), with no spills (shared
//   memory: 13 KB a block without patch, 80 KB with it).
// - Reuse: a thread owns a contiguous run of RUN rows of one column and
//   holds b, x and p for it in registers.  One application stages m*x in
//   shared memory (one store a point), then slides a 3-row window down the
//   run: its own column comes from registers, the two horizontal
//   neighbours from shared memory (two conflict-free loads a point), and
//   the separable stencil is folded into four weights (centre, vertical,
//   horizontal, diagonal) applied to the window's row sums.  The patch
//   reads the 5 planes at the point and the 3 mirrored values of the
//   neighbouring columns from shared memory; the mirrored terms of the row
//   above are carried from the previous step as one sum.
// - Masks: a tile that lies inside the lattice interior (all but the
//   border tiles) runs a body whose masks are constants, so its selects
//   fold away; the border tiles run the masked body.
// - Halo: the tile is 96 x 32 with a zero-padded border, so no read is
//   bounds-checked; at degree 4 88 x 24 of its points are kept (69%; 66%
//   for the first design).  A taller tile needs more rows a thread or more
//   threads, and either costs the second block an SM: the 128 x 64 tile at
//   one block an SM measured no faster, and 128-wide tiles at 64
//   registers spilled in the patched body.
// - A block whose extended tile misses the patch box runs the unpatched
//   body and loads no plane bytes.  Patched blocks hold the whole centre
//   weight Kc + w_c in plane 0 and form D^-1 from it with a correctly
//   rounded reciprocal (rcp_rn), as no register is left to keep it.
// - Storage: the lattice arrays and the planes are float or __nv_bfloat16
//   (sweep_kernel's T; bf16 in fdal_sweep_bf16.cu), one body for both:
//   loads widen to float32 and stores round once (__float2bfloat16_rn);
//   the registers, the shared staging and every update are float32.
// The dynamic shared memory attribute is set once per instantiation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fdal {

constexpr int MODE_OP = 0;
constexpr int MODE_SMOOTH = 1;
constexpr int MODE_PRE = 2;
constexpr int MODE_POST = 3;

constexpr int MAX_DEG = 6;

// Extended tile: EX columns (one thread each) by EY rows (TROWS threads a
// column, each owning RUN consecutive rows); shared arrays are padded by one
// zero point on every side, ZW x ZH.
constexpr int EX = 96;
constexpr int TROWS = 4;
constexpr int RUN = 8;
constexpr int EY = TROWS * RUN;
constexpr int NT = EX * TROWS;
constexpr int MIN_BLOCKS = 2;
constexpr int ZW = EX + 2;
constexpr int ZH = EY + 2;
constexpr int ZN = ZW * ZH;
static_assert(RUN <= 32, "the row masks are 32-bit");

// The 9-point stiffness stencil K0(x)M1 + M0(x)K1 as four weights: centre
// (= Kc), vertical (r+-1, c), horizontal (r, c+-1) and diagonal neighbours.
struct Weights {
  float c, v, h, d;
};

struct Box {
  int r0, c0, pr, pc;
};

struct Cheb {
  float inv_theta;
  float a[MAX_DEG];
  float c[MAX_DEG];
};

// The arguments of one call, the lattice arrays and planes in storage T.
template <typename T>
struct SweepOf {
  const T* b;
  const T* x0;
  const T* planes;
  T* out;
  T* rout;
  int ny, nx;
  Weights w;
  Box box;
  Cheb ch;
};
using Sweep = SweepOf<float>;
using SweepBf16 = SweepOf<__nv_bfloat16>;

// fac (host): k0o, k0c, m0o, m0c, k1o, k1c, m1o, m1c, kc; the 9-point
// weights of K0(x)M1 + M0(x)K1, the centre Kc as given.  coef (host):
// inv_theta, a_1..a_{deg-1}, c_1..c_{deg-1}, read outside mode op.  False
// for a degree out of range.
template <typename T>
inline bool set_weights(SweepOf<T>& s, int mode, int degree, const float* fac,
                        const float* coef) {
  const double k0o = fac[0], k0c = fac[1], m0o = fac[2], m0c = fac[3];
  const double k1o = fac[4], k1c = fac[5], m1o = fac[6], m1c = fac[7];
  s.w = Weights{fac[8], (float)(k0o * m1c + m0o * k1c),
                (float)(k0c * m1o + m0c * k1o), (float)(k0o * m1o + m0o * k1o)};
  if (mode == MODE_OP) return true;
  if (degree < 2 || degree > MAX_DEG) return false;
  s.ch.inv_theta = coef[0];
  for (int j = 0; j < degree - 1; ++j) {
    s.ch.a[j] = coef[1 + j];
    s.ch.c[j] = coef[degree + j];
  }
  return true;
}

// Internal linkage for the templates: each source instantiates its own
// modes, and the per-instantiation statics of run() stay inside the
// library that holds them.
namespace {

// Operator applications of one call: the halo of the extended tile.
template <int MODE, int DEG>
__host__ __device__ constexpr int halo() {
  return MODE == MODE_OP ? 1 : (DEG - 1) + (MODE == MODE_SMOOTH ? 0 : 1);
}

// Z, and with patch the 5 planes after it.
template <bool PATCH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ZN * (PATCH ? 6 : 1);
}

// p with its provenance hidden from the compiler, so that the addresses of
// one pass over a lattice array are not kept live (in registers) for the
// next pass over the same array.
template <typename T>
__device__ __forceinline__ const T* opaque(const T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// A stored value in float32, and a float32 value stored (rounded once).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 1/d correctly rounded for a positive normal d (Kc + w_c, w_c >= 0): the
// reciprocal approximation and one FMA correction (Markstein), without the
// branch to a slow path for special values that 1.f / d carries.
__device__ __forceinline__ float rcp_rn(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return fmaf(fmaf(-d, r, 1.f), r, r);
}

// One application of the unpatched operator to the thread's run v (rows of
// its column), handed to emit(k, (A v)_k, D^-1_k) row by row.  zcol points
// at the run's first row in the staged m*v; inm has bit k set for interior
// rows; dint = 1/Kc.  emit(k) may overwrite v[k]: row k's own value is read
// before it.
template <typename Emit>
__device__ __forceinline__ void apply_plain(const float* __restrict__ zcol,
                                            const Weights& w, float dint,
                                            unsigned inm,
                                            const float (&v)[RUN], Emit emit) {
  float mu = zcol[-ZW];
  float hu = zcol[-ZW - 1] + zcol[-ZW + 1];
  float mc = (inm & 1u) ? v[0] : 0.f;
  float hc = zcol[-1] + zcol[1];
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    const float* q = zcol + (k + 1) * ZW;
    const float md = k + 1 < RUN ? (((inm >> (k + 1)) & 1u) ? v[k + 1] : 0.f)
                                 : q[0];
    const float hd = q[-1] + q[1];
    const float acc = w.c * mc + w.v * (mu + md) + w.h * hc + w.d * (hu + hd);
    const bool in = (inm >> k) & 1u;
    emit(k, in ? acc : v[k], in ? dint : 1.f);
    mu = mc;
    mc = md;
    hu = hc;
    hc = hd;
  }
}

// The same with the patch; pcol points at the run's first row in plane 0,
// which holds the whole centre weight Kc + w_c, plane e at pcol + e*ZN; the
// D^-1 handed to emit is 1/(Kc + w_c), correctly rounded.  The mirrored
// terms of the row above, w_e[p-e] z[p-e] for e = (1,0), (1,1), (1,-1),
// are formed while that row is the current one and carried as one sum.
template <typename Emit>
__device__ __forceinline__ void apply_patch(const float* __restrict__ zcol,
                                            const float* __restrict__ pcol,
                                            const Weights& w, unsigned inm,
                                            const float (&v)[RUN], Emit emit) {
  float mu = zcol[-ZW], hu = zcol[-ZW - 1] + zcol[-ZW + 1];
  float lc = zcol[-1], mc = (inm & 1u) ? v[0] : 0.f, rc = zcol[1];
  // w_(1,0) at (r-1, c), w_(1,1) at (r-1, c-1), w_(1,-1) at (r-1, c+1),
  // times z there
  float tu = pcol[2 * ZN - ZW] * mu + pcol[3 * ZN - ZW - 1] * zcol[-ZW - 1] +
             pcol[4 * ZN - ZW + 1] * zcol[-ZW + 1];
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    const float* q = zcol + (k + 1) * ZW;
    const float* pk = pcol + k * ZW;
    const float md = k + 1 < RUN ? (((inm >> (k + 1)) & 1u) ? v[k + 1] : 0.f)
                                 : q[0];
    const float ld = q[-1], rd = q[1];
    const float w0 = pk[0];
    const float acc = w0 * mc + w.v * (mu + md) + w.h * (lc + rc) +
                      w.d * (hu + (ld + rd));
    const float accw = pk[ZN] * rc + pk[2 * ZN] * md + pk[3 * ZN] * rd +
                       pk[4 * ZN] * ld + pk[ZN - 1] * lc + tu;
    const bool in = (inm >> k) & 1u;
    emit(k, in ? acc + accw : v[k], in ? rcp_rn(w0) : 1.f);
    tu = pk[2 * ZN] * mc + pk[3 * ZN - 1] * lc + pk[4 * ZN + 1] * rc;
    mu = mc; hu = lc + rc;
    lc = ld; mc = md; rc = rd;
  }
}

// The recurrence of one block on its extended tile; HIT: the tile meets the
// patch box and the planes are staged at P; EDGE: the tile holds points
// outside the lattice interior, so the masks inm (interior) and inl (in the
// lattice) are read, else they are all ones at compile time and every
// select folds away.
template <int MODE, int DEG, bool HIT, bool EDGE, typename T>
__device__ __forceinline__ void sweep_body(const SweepOf<T>& s, float* zcol,
                                           const float* pcol, unsigned inm,
                                           unsigned inl, int gr, int gc,
                                           bool keep_col, int keep_lo,
                                           int keep_hi) {
  if constexpr (!EDGE) {
    inm = ~0u;
    inl = ~0u;
  }
  const long long base = (long long)gr * s.nx + gc;
  const int nx = s.nx;
  float rhs[RUN], x[RUN];
  const T* b = s.b + base;
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    // points outside the lattice are 0 (a select, never a product)
    rhs[k] = ((inl >> k) & 1u) ? widen(b[k * nx]) : 0.f;
  }
  const float dint = 1.f / s.w.c;
  // the kept rows of the run (the tile less its halo, inside the lattice)
  auto store = [&](T* dst, const float (&v)[RUN]) {
    if (!keep_col) return;
    dst += base;
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      if (k >= keep_lo && k < keep_hi && ((inl >> k) & 1u)) {
        put(dst + k * nx, v[k]);
      }
    }
  };
  auto apply = [&](const float (&v)[RUN], auto emit) {
    __syncthreads();  // the previous application's readers are done
#pragma unroll
    for (int k = 0; k < RUN; ++k) zcol[k * ZW] = ((inm >> k) & 1u) ? v[k] : 0.f;
    __syncthreads();
    if constexpr (HIT) {
      apply_patch(zcol, pcol, s.w, inm, v, emit);
    } else {
      apply_plain(zcol, s.w, dint, inm, v, emit);
    }
  };
  if constexpr (MODE == MODE_OP) {
    apply(rhs, [&](int k, float av, float) { x[k] = av; });
  } else {
    if constexpr (MODE == MODE_POST) {
      const T* x0 = opaque(s.x0 + base);
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        x[k] = ((inl >> k) & 1u) ? widen(x0[k * nx]) : 0.f;
      }
      apply(x, [&](int k, float av, float) { rhs[k] -= av; });
    }
    float p[RUN];
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      float d = ((inm >> k) & 1u) ? dint : 1.f;
      if constexpr (HIT) {
        if ((inm >> k) & 1u) d = rcp_rn(pcol[k * ZW]);
      }
      x[k] = d * rhs[k] * s.ch.inv_theta;
      p[k] = x[k];
    }
#pragma unroll
    for (int j = 0; j < DEG - 1; ++j) {
      const float a = s.ch.a[j], c = s.ch.c[j];
      apply(x, [&](int k, float av, float d) {
        p[k] = a * p[k] + c * (d * (rhs[k] - av));
        x[k] += p[k];
      });
    }
    if constexpr (MODE == MODE_POST) {
      // x0 again: this block read it a few microseconds ago, from L2 now
      const T* x0 = opaque(s.x0 + base);
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        if ((inl >> k) & 1u) x[k] += widen(x0[k * nx]);
      }
    }
    if constexpr (MODE == MODE_PRE) {
      // x is final: its stores overlap the residual's application
      store(s.out, x);
      apply(x, [&](int k, float av, float) { rhs[k] -= av; });  // b - A x
      store(s.rout, rhs);
      return;
    }
  }
  store(s.out, x);
}

template <int MODE, int DEG, bool HIT, typename T>
__device__ __forceinline__ void body(bool edge, const SweepOf<T>& s,
                                     float* zcol, const float* pcol,
                                     unsigned inm, unsigned inl, int gr,
                                     int gc, bool keep_col, int keep_lo,
                                     int keep_hi) {
  if (edge) {
    sweep_body<MODE, DEG, HIT, true>(s, zcol, pcol, inm, inl, gr, gc,
                                     keep_col, keep_lo, keep_hi);
  } else {
    sweep_body<MODE, DEG, HIT, false>(s, zcol, pcol, inm, inl, gr, gc,
                                      keep_col, keep_lo, keep_hi);
  }
}

template <int MODE, int DEG, bool PATCH, typename T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
sweep_kernel(const SweepOf<T> s) {
  constexpr int H = halo<MODE, DEG>();
  constexpr int TY = EY - 2 * H;
  constexpr int TX = EX - 2 * H;
  static_assert(TY > 0 && TX > 0, "halo too large for the tile");
  extern __shared__ float smem[];
  float* Z = smem;       // ZH x ZW: m*x, zero border
  float* P = smem + ZN;  // 5 x ZH x ZW: patch planes (PATCH, when hit)

  const int tx = threadIdx.x % EX;
  const int y0 = (threadIdx.x / EX) * RUN;
  const int gr0 = blockIdx.y * TY - H;
  const int gc0 = blockIdx.x * TX - H;
  const int gr = gr0 + y0, gc = gc0 + tx;

  for (int t = threadIdx.x; t < 2 * ZW + 2 * EY; t += NT) {
    const int i = t < 2 * ZW ? (t < ZW ? t : (ZH - 1) * ZW + t - ZW)
                             : (1 + (t - 2 * ZW) / 2) * ZW +
                                   ((t - 2 * ZW) % 2) * (ZW - 1);
    Z[i] = 0.f;
  }
  unsigned inm = 0, inl = 0;
  const bool col_in = gc >= 0 && gc < s.nx;
  const bool col_int = gc >= 1 && gc <= s.nx - 2;
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    const int r = gr + k;
    inl |= (unsigned)(col_in && r >= 0 && r < s.ny) << k;
    inm |= (unsigned)(col_int && r >= 1 && r <= s.ny - 2) << k;
  }
  float* zcol = Z + (y0 + 1) * ZW + tx + 1;
  const float* pcol = P + (y0 + 1) * ZW + tx + 1;
  // does the extended tile hold a point outside the interior?  (uniform)
  const bool edge = gr0 < 1 || gr0 + EY > s.ny - 1 || gc0 < 1 ||
                    gc0 + EX > s.nx - 1;
  const bool keep_col = tx >= H && tx < H + TX;
  const int keep_lo = H - y0, keep_hi = H + TY - y0;

  if constexpr (PATCH) {
    const Box& box = s.box;
    // does the extended tile meet the patch box?  (block-uniform)
    const bool hit = gr0 < box.r0 + box.pr && gr0 + EY > box.r0 &&
                     gc0 < box.c0 + box.pc && gc0 + EX > box.c0;
    if (hit) {
      const long long plane = (long long)box.pr * box.pc;
      for (int t = threadIdx.x; t < 5 * ZN; t += NT) {
        const int e = t / ZN, yy = (t % ZN) / ZW, xx = t % ZW;
        const int pr = gr0 + yy - 1 - box.r0, pc = gc0 + xx - 1 - box.c0;
        const float v = (pr >= 0 && pr < box.pr && pc >= 0 && pc < box.pc)
            ? widen(s.planes[e * plane + (long long)pr * box.pc + pc]) : 0.f;
        P[t] = e == 0 ? s.w.c + v : v;  // plane 0: the centre weight
      }
      __syncthreads();
      body<MODE, DEG, true>(edge, s, zcol, pcol, inm, inl, gr, gc, keep_col,
                            keep_lo, keep_hi);
      return;
    }
  }
  body<MODE, DEG, false>(edge, s, zcol, pcol, inm, inl, gr, gc, keep_col,
                         keep_lo, keep_hi);
}

// One instantiation: launch it on s (s != nullptr), or write its resources
// to res (registers a thread, static and dynamic shared bytes, local bytes
// a thread, resident blocks an SM, threads a block).  The dynamic shared
// memory attribute is set on the first use.
template <int MODE, int DEG, bool PATCH, typename T>
cudaError_t run(const SweepOf<T>* s, int* res, cudaStream_t stream) {
  constexpr int H = halo<MODE, DEG>();
  constexpr size_t shmem = smem_bytes<PATCH>();
  auto kernel = sweep_kernel<MODE, DEG, PATCH, T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (attr != cudaSuccess) return attr;
  if (s == nullptr) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NT,
                                                        shmem);
    if (err != cudaSuccess) return err;
    res[0] = fa.numRegs;
    res[1] = (int)fa.sharedSizeBytes;
    res[2] = (int)shmem;
    res[3] = (int)fa.localSizeBytes;
    res[4] = blocks;
    res[5] = NT;
    return cudaSuccess;
  }
  dim3 grid((s->nx + EX - 2 * H - 1) / (EX - 2 * H),
            (s->ny + EY - 2 * H - 1) / (EY - 2 * H));
  kernel<<<grid, NT, shmem, stream>>>(*s);
  return cudaGetLastError();
}

template <int MODE, int DEG>
cudaError_t run_form(bool patch, const Sweep* s, int* res, cudaStream_t st) {
  return patch ? run<MODE, DEG, true>(s, res, st)
               : run<MODE, DEG, false>(s, res, st);
}

template <int MODE>
cudaError_t run_degree(int degree, bool patch, const Sweep* s, int* res,
                       cudaStream_t st) {
  switch (degree) {
    case 2: return run_form<MODE, 2>(patch, s, res, st);
    case 3: return run_form<MODE, 3>(patch, s, res, st);
    case 4: return run_form<MODE, 4>(patch, s, res, st);
    case 5: return run_form<MODE, 5>(patch, s, res, st);
    case 6: return run_form<MODE, 6>(patch, s, res, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Defined in fdal_pre.cu and fdal_post.cu.
cudaError_t run_pre(int degree, bool patch, const Sweep* s, int* res,
                    cudaStream_t st);
cudaError_t run_post(int degree, bool patch, const Sweep* s, int* res,
                     cudaStream_t st);

}  // namespace fdal
