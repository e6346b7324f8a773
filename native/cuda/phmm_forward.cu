// PairHMM f32 forward pass for NVIDIA Hopper, called from JAX through the
// XLA foreign function interface (ops/phmm_cuda.py builds and loads it).
//
// One warp owns one testcase.  The read rows are cut into stripes of 32;
// lane l of the warp holds row 32*s + l + 1 of stripe s and walks the
// columns with a one-step lag per lane, so at step t the warp covers one
// anti-diagonal of the stripe:
//
//   lane l, step t  ->  cell (r = 32*s + l + 1, c = t - l + 1)
//
// The values a cell needs from the row above arrive from lane l-1 through
// __shfl_up_sync; lane 0 reads them from the previous stripe's last row,
// which lane 31 wrote to a column-indexed ring in shared memory.  Lane 0
// reads column t+1 at step t while lane 31 writes column t-30, so one
// buffer serves every stripe.  Only ceil(rslen/32) stripes and haplen + 31
// steps per stripe run: padding costs nothing.
//
// Arithmetic follows ops/phmm.py phmm_forward operation by operation
// (avx-pairhmm-template.h:181-197 association) with explicit _rn
// intrinsics, so no multiply-add is contracted into an FMA and the results
// equal the plain scan's on the CPU bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarps = 4;  // testcases per block
constexpr int kAmbig = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
phmm_forward_kernel(const int8_t* __restrict__ rs_row,
                    const int8_t* __restrict__ qual,
                    const int8_t* __restrict__ ins_q,
                    const int8_t* __restrict__ del_q,
                    const int8_t* __restrict__ gcp_q,
                    const int8_t* __restrict__ hap,
                    const int32_t* __restrict__ rslen,
                    const int32_t* __restrict__ haplen,
                    const float* __restrict__ ph2pr_g,
                    const float* __restrict__ m2m,
                    float initial_constant, int n_cases, int rp, int hp,
                    float* __restrict__ res_m_out,
                    float* __restrict__ res_x_out) {
  extern __shared__ float smem[];
  float* ph2pr = smem;                     // [128]
  const int ring = hp + 2;                 // columns 0 .. hp + 1
  float* rings = ph2pr + 128;              // [kWarps][3][ring]
  int8_t* haps = reinterpret_cast<int8_t*>(rings + kWarps * 3 * ring);

  for (int k = threadIdx.x; k < 128; k += blockDim.x) ph2pr[k] = ph2pr_g[k];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= n_cases) return;

  const int n = rslen[b];
  const int m = haplen[b];
  float* bm = rings + warp * 3 * ring;
  float* bx = bm + ring;
  float* by = bx + ring;
  int8_t* hs = haps + warp * hp;
  for (int k = lane; k < hp; k += 32) hs[k] = hap[(size_t)b * hp + k];
  for (int k = lane; k < ring; k += 32) {
    bm[k] = 0.f;
    bx[k] = 0.f;
    by[k] = 0.f;
  }
  __syncwarp();

  const float init_y = __fdiv_rn(initial_constant, (float)m);
  float acc_m = 0.f, acc_x = 0.f;
  const int n_stripes = (n + 31) / 32;

  for (int s = 0; s < n_stripes; ++s) {
    const bool first = s == 0;
    const bool last = s == n_stripes - 1;
    const int r = 32 * s + lane + 1;
    // per-row transition probabilities (initializeVectors); rows past
    // rslen keep zeros and feed only rows below them, which are unused
    float p_mm = 0.f, p_gapm = 0.f, p_mx = 0.f, p_xx = 0.f, p_my = 0.f,
          p_yy = 0.f, one_m_distm = 0.f, distm3 = 0.f;
    int rb = -1;
    if (r <= n) {
      const size_t o = (size_t)b * rp + r;
      const int iq = ins_q[o] & 127, dq = del_q[o] & 127;
      const int cq = gcp_q[o] & 127, qq = qual[o] & 127;
      const int lo = min(iq, dq), hi = max(iq, dq);
      p_mm = __ldg(m2m + ((hi * (hi + 1)) >> 1) + lo);
      const float p_c = ph2pr[cq];
      p_gapm = __fsub_rn(1.f, p_c);
      p_mx = ph2pr[iq];
      p_xx = p_c;
      p_my = ph2pr[dq];
      p_yy = p_c;
      const float distm = ph2pr[qq];
      one_m_distm = __fsub_rn(1.f, distm);
      distm3 = __fdiv_rn(distm, 3.f);
      rb = rs_row[o];
    }

    // (r, c-1) of this lane, and (r-1, c-1) received one step ago;
    // the row-0 boundary is M = X = 0, Y = init_y at every column
    float m1 = 0.f, x1 = 0.f, y1 = 0.f;
    float um1 = 0.f, ux1 = 0.f, uy1 = (first && lane == 0) ? init_y : 0.f;
    const int steps = m + 31;
    for (int t = 0; t < steps; ++t) {
      const int c = t - lane + 1;
      // (r-1, c): the lane above computed it one step ago
      float um = __shfl_up_sync(kFull, m1, 1);
      float ux = __shfl_up_sync(kFull, x1, 1);
      float uy = __shfl_up_sync(kFull, y1, 1);
      if (lane == 0) {
        if (first) {
          um = 0.f;
          ux = 0.f;
          uy = init_y;
        } else {
          const int cc = min(c, hp + 1);
          um = bm[cc];
          ux = bx[cc];
          uy = by[cc];
        }
      }
      const int hb = hs[min(max(c - 1, 0), hp - 1)];
      const bool match = (rb == hb) | (rb == kAmbig) | (hb == kAmbig);
      const float prior = match ? one_m_distm : distm3;
      float mn = __fmul_rn(
          prior, __fadd_rn(__fadd_rn(__fmul_rn(um1, p_mm), __fmul_rn(ux1, p_gapm)),
                           __fmul_rn(uy1, p_gapm)));
      float xn = __fadd_rn(__fmul_rn(um, p_mx), __fmul_rn(ux, p_xx));
      float yn = __fadd_rn(__fmul_rn(m1, p_my), __fmul_rn(y1, p_yy));
      if (c < 1) {
        mn = 0.f;
        xn = 0.f;
        yn = 0.f;
      }
      const bool in_cols = c >= 1 && c <= m;
      if (r == n && in_cols) {
        acc_m = __fadd_rn(acc_m, mn);
        acc_x = __fadd_rn(acc_x, xn);
      }
      if (!last && lane == 31 && in_cols) {
        bm[c] = mn;
        bx[c] = xn;
        by[c] = yn;
      }
      m1 = mn;
      x1 = xn;
      y1 = yn;
      um1 = um;
      ux1 = ux;
      uy1 = uy;
    }
    __syncwarp();
  }
  // the lane that held row rslen owns the sums (lane 31 when rslen == 0)
  if (lane == (n + 31) % 32) {
    res_m_out[b] = acc_m;
    res_x_out[b] = acc_x;
  }
}

ffi::Error PhmmForwardImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> rs_row,
                           ffi::Buffer<ffi::S8> qual, ffi::Buffer<ffi::S8> ins_q,
                           ffi::Buffer<ffi::S8> del_q, ffi::Buffer<ffi::S8> gcp_q,
                           ffi::Buffer<ffi::S8> hap, ffi::Buffer<ffi::S32> rslen,
                           ffi::Buffer<ffi::S32> haplen,
                           ffi::Buffer<ffi::F32> ph2pr, ffi::Buffer<ffi::F32> m2m,
                           float initial_constant,
                           ffi::ResultBuffer<ffi::F32> res_m,
                           ffi::ResultBuffer<ffi::F32> res_x) {
  const auto rdims = rs_row.dimensions();
  const auto hdims = hap.dimensions();
  if (rdims.size() != 2 || hdims.size() != 2 || rdims[0] != hdims[0]) {
    return ffi::Error::InvalidArgument("rs_row [B, Rp] and hap [B, Hp] expected");
  }
  if (ph2pr.element_count() < 128 || m2m.element_count() < 128 * 129 / 2) {
    return ffi::Error::InvalidArgument("ph2pr[128] and m2m tables expected");
  }
  const int n_cases = static_cast<int>(rdims[0]);
  const int rp = static_cast<int>(rdims[1]);
  const int hp = static_cast<int>(hdims[1]);
  if (n_cases == 0) return ffi::Error::Success();
  const size_t smem = sizeof(float) * (128 + kWarps * 3 * (hp + 2)) +
                      static_cast<size_t>(kWarps) * hp;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(phmm_forward_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int blocks = (n_cases + kWarps - 1) / kWarps;
  phmm_forward_kernel<<<blocks, kWarps * 32, smem, stream>>>(
      rs_row.typed_data(), qual.typed_data(), ins_q.typed_data(),
      del_q.typed_data(), gcp_q.typed_data(), hap.typed_data(),
      rslen.typed_data(), haplen.typed_data(), ph2pr.typed_data(),
      m2m.typed_data(), initial_constant, n_cases, rp, hp,
      res_m->typed_data(), res_x->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PhmmForward, PhmmForwardImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()   // rs_row
                                  .Arg<ffi::Buffer<ffi::S8>>()   // q
                                  .Arg<ffi::Buffer<ffi::S8>>()   // i
                                  .Arg<ffi::Buffer<ffi::S8>>()   // d
                                  .Arg<ffi::Buffer<ffi::S8>>()   // c
                                  .Arg<ffi::Buffer<ffi::S8>>()   // hap
                                  .Arg<ffi::Buffer<ffi::S32>>()  // rslen
                                  .Arg<ffi::Buffer<ffi::S32>>()  // haplen
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ph2pr
                                  .Arg<ffi::Buffer<ffi::F32>>()  // m2m
                                  .Attr<float>("initial_constant")
                                  .Ret<ffi::Buffer<ffi::F32>>()  // res_m
                                  .Ret<ffi::Buffer<ffi::F32>>());  // res_x
