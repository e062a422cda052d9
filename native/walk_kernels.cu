// BSGS walk kernels for NVIDIA GPUs, called from JAX through the XLA
// foreign function interface (keyhuntm1cpu_tpu/curve/pwalk.py). The
// per-lane math lives in walk_math.h, shared with the host reference.
//
//   KeyhuntWalkBases:  (x, y, inf)[i] = P[i] + Q[i], one thread per lane,
//                      each with its own Fermat inversion.
//   KeyhuntWalkBlocks: x(base_b + u*S) for all bases b and offsets u;
//                      one thread per (u, chain of bases), one Montgomery
//                      chain and one inversion per thread.
//
// Build: make -C native libkeyhunt_walk.so (needs nvcc; done on first use).
#include <cuda_runtime.h>

#include "walk_math.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using khw::u32;

static const int kThreads = 128;
static const int kMaxChain = 64;

__global__ void bases_kernel(const u32* px, const u32* py, const u32* qx,
                             const u32* qy, u32* ox, u32* oy, uint8_t* inf,
                             long n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 a[8], b[8], c[8], d[8], x3[8], y3[8];
  khw::load(a, px, n, i);
  khw::load(b, py, n, i);
  khw::load(c, qx, n, i);
  khw::load(d, qy, n, i);
  bool at_inf = khw::add_full(x3, y3, a, b, c, d);
  khw::store(ox, n, i, x3);
  khw::store(oy, n, i, y3);
  inf[i] = at_inf ? 1 : 0;
}

__global__ void walk_kernel(const u32* bx, const u32* by, const u32* tx,
                            const u32* ty, u32* qlo, u32* qhi, uint8_t* deg,
                            long nb, long u, int chain, long lane_tiles) {
  long tile = blockIdx.x % lane_tiles;
  long group = blockIdx.x / lane_tiles;
  long lane = tile * blockDim.x + threadIdx.x;
  if (lane >= u) return;
  u32 pre[kMaxChain][8];
  u32 txl[8], tyl[8];
  khw::load(txl, tx, u, lane);
  khw::load(tyl, ty, u, lane);
  khw::walk_chain(bx, by, nb, txl, tyl, u, lane, group * chain, chain, pre,
                  qlo, qhi, deg);
}

static ffi::Error launch_status() {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

static ffi::Error WalkBasesImpl(cudaStream_t stream,
                                ffi::Buffer<ffi::U32> px,
                                ffi::Buffer<ffi::U32> py,
                                ffi::Buffer<ffi::U32> qx,
                                ffi::Buffer<ffi::U32> qy,
                                ffi::ResultBuffer<ffi::U32> ox,
                                ffi::ResultBuffer<ffi::U32> oy,
                                ffi::ResultBuffer<ffi::U8> inf) {
  auto dims = px.dimensions();
  if (dims.size() != 2 || dims[0] != 8)
    return ffi::Error::InvalidArgument("bases operands must be (8, n)");
  long n = dims[1];
  if (n == 0) return ffi::Error::Success();
  long blocks = (n + kThreads - 1) / kThreads;
  bases_kernel<<<blocks, kThreads, 0, stream>>>(
      px.typed_data(), py.typed_data(), qx.typed_data(), qy.typed_data(),
      ox->typed_data(), oy->typed_data(), inf->typed_data(), n);
  return launch_status();
}

static ffi::Error WalkBlocksImpl(cudaStream_t stream,
                                 ffi::Buffer<ffi::U32> bx,
                                 ffi::Buffer<ffi::U32> by,
                                 ffi::Buffer<ffi::U32> tx,
                                 ffi::Buffer<ffi::U32> ty,
                                 ffi::ResultBuffer<ffi::U32> qlo,
                                 ffi::ResultBuffer<ffi::U32> qhi,
                                 ffi::ResultBuffer<ffi::U8> deg,
                                 int64_t chain) {
  auto bd = bx.dimensions();
  auto td = tx.dimensions();
  if (bd.size() != 2 || bd[0] != 8 || td.size() != 2 || td[0] != 8)
    return ffi::Error::InvalidArgument("walk operands must be (8, n)");
  long nb = bd[1], u = td[1];
  if (chain < 1 || chain > kMaxChain || nb % chain != 0)
    return ffi::Error::InvalidArgument("chain must divide nb, 1..64");
  if (nb == 0 || u == 0) return ffi::Error::Success();
  long lane_tiles = (u + kThreads - 1) / kThreads;
  long blocks = lane_tiles * (nb / chain);
  walk_kernel<<<blocks, kThreads, 0, stream>>>(
      bx.typed_data(), by.typed_data(), tx.typed_data(), ty.typed_data(),
      qlo->typed_data(), qhi->typed_data(), deg->typed_data(), nb, u,
      (int)chain, lane_tiles);
  return launch_status();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(KeyhuntWalkBases, WalkBasesImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(KeyhuntWalkBlocks, WalkBlocksImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int64_t>("chain"));
