// Temporally blocked Horn-Schunck Jacobi sweeps for Hopper (sm_90a),
// called from JAX through the XLA FFI (tpuflow/kernels/hs_cuda.py).
//
// One sweep of the reference demo (HornSchunckOF/hornSchunck.cpp:43-75):
//
//   ub = box_{W x W}(u) / W^2, vb = box(v) / W^2   (BORDER_CONSTANT zeros)
//   upd = (gx*ub + gy*vb + gt) * inv,  inv = 1 / (alpha^2 + gx^2 + gy^2)
//   u = ub - gx*upd,  v = vb - gy*upd
//
// As one XLA program per sweep, every sweep streams u, v and the four
// read-only fields through device memory. Here one block loads a
// (TH + 2KR) x (TW + 2KR) halo tile of u and v into shared memory once,
// runs up to K sweeps there with a valid region that shrinks by R per
// sweep, and writes back the TH x TW core: u and v cross device memory
// once per K sweeps instead of once per sweep. The read-only fields are
// read through the read-only data cache (__ldg); each sweep reads each
// of them once per tile pixel, mostly out of L2.
//
// Pixels outside the frame hold zeros after every sweep, which is the
// reference's BORDER_CONSTANT box average; any tiling computes the same
// Jacobi iteration as the whole-frame sweep.

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

template <int R, int K, int TH, int TW>
struct Tile {
  static constexpr int kHalo = K * R;
  static constexpr int kEH = TH + 2 * kHalo;
  static constexpr int kEW = TW + 2 * kHalo;
  // u, v and their horizontal window sums.
  static constexpr size_t kSmemBytes = 4ull * kEH * kEW * sizeof(float);
};

template <int R, int K, int TH, int TW>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
hs_block_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                const float* __restrict__ gt, const float* __restrict__ inv,
                const float* __restrict__ u_in,
                const float* __restrict__ v_in, float* __restrict__ u_out,
                float* __restrict__ v_out, int h, int w, int n_sweeps) {
  using T = Tile<R, K, TH, TW>;
  constexpr int EH = T::kEH;
  constexpr int EW = T::kEW;
  constexpr float kInvArea = 1.0f / float((2 * R + 1) * (2 * R + 1));
  extern __shared__ float smem[];
  float* su = smem;
  float* sv = su + EH * EW;
  float* hu = sv + EH * EW;
  float* hv = hu + EH * EW;

  const int y0 = blockIdx.y * TH - T::kHalo;
  const int x0 = blockIdx.x * TW - T::kHalo;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  // u_in == nullptr is the zero initial flow of the first block.
  for (int i = ty; i < EH; i += kThreadsY) {
    const int gy_i = y0 + i;
    const bool row_in = gy_i >= 0 && gy_i < h;
    for (int j = tx; j < EW; j += kThreadsX) {
      const int gx_j = x0 + j;
      float a = 0.0f, b = 0.0f;
      if (u_in != nullptr && row_in && gx_j >= 0 && gx_j < w) {
        const size_t k = size_t(gy_i) * w + gx_j;
        a = u_in[k];
        b = v_in[k];
      }
      su[i * EW + j] = a;
      sv[i * EW + j] = b;
    }
  }
  __syncthreads();

  for (int s = 0; s < n_sweeps; ++s) {
    // Sweep s writes rows/cols [(s+1)R, E - (s+1)R); its vertical pass
    // reads horizontal sums of rows [sR, EH - sR).
    const int lo = (s + 1) * R;
    const int hi_y = EH - lo;
    const int hi_x = EW - lo;
    for (int i = s * R + ty; i < EH - s * R; i += kThreadsY) {
      for (int j = lo + tx; j < hi_x; j += kThreadsX) {
        float a = 0.0f, b = 0.0f;
#pragma unroll
        for (int d = -R; d <= R; ++d) {
          a += su[i * EW + j + d];
          b += sv[i * EW + j + d];
        }
        hu[i * EW + j] = a;
        hv[i * EW + j] = b;
      }
    }
    __syncthreads();
    for (int i = lo + ty; i < hi_y; i += kThreadsY) {
      const int gy_i = y0 + i;
      const bool row_in = gy_i >= 0 && gy_i < h;
      for (int j = lo + tx; j < hi_x; j += kThreadsX) {
        const int gx_j = x0 + j;
        float a = 0.0f, b = 0.0f;
#pragma unroll
        for (int d = -R; d <= R; ++d) {
          a += hu[(i + d) * EW + j];
          b += hv[(i + d) * EW + j];
        }
        float un = 0.0f, vn = 0.0f;
        if (row_in && gx_j >= 0 && gx_j < w) {
          const size_t k = size_t(gy_i) * w + gx_j;
          const float ub = a * kInvArea;
          const float vb = b * kInvArea;
          const float gxv = __ldg(gx + k);
          const float gyv = __ldg(gy + k);
          const float upd = (gxv * ub + gyv * vb + __ldg(gt + k)) * __ldg(inv + k);
          un = ub - gxv * upd;
          vn = vb - gyv * upd;
        }
        // In place: this pass reads only hu/hv, and the next sweep's
        // horizontal pass reads only cells written here.
        su[i * EW + j] = un;
        sv[i * EW + j] = vn;
      }
    }
    __syncthreads();
  }

  for (int i = ty; i < TH; i += kThreadsY) {
    const int gy_i = blockIdx.y * TH + i;
    if (gy_i >= h) break;
    for (int j = tx; j < TW; j += kThreadsX) {
      const int gx_j = blockIdx.x * TW + j;
      if (gx_j >= w) break;
      const size_t k = size_t(gy_i) * w + gx_j;
      const int c = (i + T::kHalo) * EW + j + T::kHalo;
      u_out[k] = su[c];
      v_out[k] = sv[c];
    }
  }
}

// Runs `iterations` sweeps as ceil(iterations / K) launches that
// ping-pong between (u_out, v_out) and the scratch pair, ordered so the
// last launch writes (u_out, v_out).
template <int R, int K, int TH, int TW>
cudaError_t run_sweeps(cudaStream_t stream, const float* gx, const float* gy,
                       const float* gt, const float* inv, float* u_out,
                       float* v_out, float* u_tmp, float* v_tmp, int h,
                       int w, int64_t iterations) {
  using T = Tile<R, K, TH, TW>;
  auto kernel = hs_block_kernel<R, K, TH, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(T::kSmemBytes));
  if (err != cudaSuccess) return err;
  const size_t plane = size_t(h) * w * sizeof(float);
  if (iterations <= 0) {
    cudaMemsetAsync(u_out, 0, plane, stream);
    return cudaMemsetAsync(v_out, 0, plane, stream);
  }
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  const int64_t n_launch = (iterations + K - 1) / K;
  const float* src_u = nullptr;
  const float* src_v = nullptr;
  for (int64_t b = 0; b < n_launch; ++b) {
    const bool to_out = ((n_launch - 1 - b) % 2) == 0;
    float* dst_u = to_out ? u_out : u_tmp;
    float* dst_v = to_out ? v_out : v_tmp;
    const int n_sweeps = int(b + 1 < n_launch ? K : iterations - b * K);
    kernel<<<grid, block, T::kSmemBytes, stream>>>(
        gx, gy, gt, inv, src_u, src_v, dst_u, dst_v, h, w, n_sweeps);
    src_u = dst_u;
    src_v = dst_v;
  }
  return cudaGetLastError();
}

using RunFn = cudaError_t (*)(cudaStream_t, const float*, const float*,
                              const float*, const float*, float*, float*,
                              float*, float*, int, int, int64_t);

// Sweeps per launch and tile: the fastest of the (K, TH x TW) sweep on an
// H100 at 1920x1080 and 3840x2160 (K in 2..8, tiles 32x64 .. 64x64;
// scripts/hs_blocking_sweep.py rebuilds the kernel with -D overrides of
// these and times each; results in PERF.md).
#ifndef HS_BLOCK_SWEEPS
#define HS_BLOCK_SWEEPS 4
#endif
#ifndef HS_TILE_H
#define HS_TILE_H 32
#endif
#ifndef HS_TILE_W
#define HS_TILE_W 64
#endif
constexpr int kBlockSweeps = HS_BLOCK_SWEEPS;
constexpr int kTileH = HS_TILE_H;
constexpr int kTileW = HS_TILE_W;

// Compiled window radii (windows 3, 5, 7). Keep in step with RADII in
// hs_cuda.py.
constexpr RunFn kByRadius[] = {
    nullptr,
    run_sweeps<1, kBlockSweeps, kTileH, kTileW>,
    run_sweeps<2, kBlockSweeps, kTileH, kTileW>,
    run_sweeps<3, kBlockSweeps, kTileH, kTileW>,
};

ffi::Error HsSweepsImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> gx,
                        ffi::Buffer<ffi::F32> gy, ffi::Buffer<ffi::F32> gt,
                        ffi::Buffer<ffi::F32> inv,
                        ffi::ResultBuffer<ffi::F32> u,
                        ffi::ResultBuffer<ffi::F32> v,
                        ffi::ResultBuffer<ffi::F32> scratch,
                        int64_t iterations, int64_t radius) {
  auto dims = gx.dimensions();
  if (dims.size() != 2) {
    return ffi::Error::InvalidArgument("hs_sweeps expects (H, W) fields");
  }
  if (radius < 1 || radius > 3) {
    return ffi::Error::InvalidArgument("hs_sweeps: window radius not 1-3");
  }
  const int h = int(dims[0]);
  const int w = int(dims[1]);
  float* tmp = scratch->typed_data();
  cudaError_t err = kByRadius[radius](
      stream, gx.typed_data(), gy.typed_data(), gt.typed_data(),
      inv.typed_data(), u->typed_data(), v->typed_data(), tmp,
      tmp + size_t(h) * w, h, w, iterations);
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    HsSweeps, HsSweepsImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Attr<int64_t>("iterations")
        .Attr<int64_t>("radius"));
