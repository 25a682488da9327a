// Receive-side masking of the distributed sort's exchange for Hopper
// (sm_90a).
//
// Replaces the computation of gpusorting_tpu/parallel/remote_exchange.py:
// _exchange_kernel (its masking, _mask_block).  The TPU kernel posted one
// remote DMA per destination and, as each source's block landed, overwrote
// the block's positions at or past the source's count with the operand's
// fill, while later sources' DMAs were still in flight.  On the card the
// transfer is torch.distributed's (NCCL or gloo,
// gpusorting_tpu_torch/parallel/remote_exchange.py); this kernel is the
// masking, launched on the stream
// as soon as a chunk (collective path) or one source's block (ring path)
// has landed.  Contract, for every operand plane o (1-4 int32 planes of D
// rows, row s holding positions col0 .. col0 + width - 1 of source s's
// cell, unit stride along the row, row stride stride[o]) and every source
// s in [src0, src0 + nsrc):
//   plane[o][s, j] = fill[o]   where col0 + j >= rc[s]
// in place.  rc stays on the device: a count above the cell (sender
// truncation) leaves the whole row valid.
//
// Bound: memory.  Only the tail is written and nothing is read but D
// counts, so the least time is 4 bytes x tail slots over the card's memory
// rate.  Design against that bound: the grid runs over (position tile,
// source, operand); a tile wholly below its source's count returns at
// once, a partial tile starts at the count, and the threads of a block
// store consecutive int32s, so every warp store is one 128-byte segment.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOps = 4;
constexpr int kThreads = 256;
constexpr int kTile = 4096;  // positions per block

struct MaskPlanes {
  int* ptr[kMaxOps];
  long long stride[kMaxOps];
  int fill[kMaxOps];
};

__global__ void __launch_bounds__(kThreads)
mask_tail(MaskPlanes p, const int* __restrict__ rc, int src0, long long width,
          long long col0) {
  const int s = src0 + blockIdx.y;
  const int o = blockIdx.z;
  const long long t0 = (long long)blockIdx.x * kTile;
  const long long t1 = min(t0 + kTile, width);
  // first masked index of the row: positions col0 + j >= rc[s]
  const long long first = (long long)__ldg(rc + s) - col0;
  if (first >= t1) return;  // the whole tile is valid
  // select by constant indices: a dynamic index into the parameter struct
  // would copy it to the stack
  int* base = p.ptr[0];
  long long stride = p.stride[0];
  int fill = p.fill[0];
#pragma unroll
  for (int i = 1; i < kMaxOps; ++i) {
    if (o == i) {
      base = p.ptr[i];
      stride = p.stride[i];
      fill = p.fill[i];
    }
  }
  int* row = base + (long long)s * stride;
  for (long long j = max(first, t0) + threadIdx.x; j < t1; j += kThreads) {
    row[j] = fill;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int gst_mask_arrivals(void* p0, void* p1, void* p2, void* p3,
                                 long long s0, long long s1, long long s2,
                                 long long s3, int f0, int f1, int f2, int f3,
                                 int num_ops, const void* rc, int src0,
                                 int nsrc, long long width, long long col0,
                                 void* stream) {
  if (num_ops < 1 || num_ops > kMaxOps || nsrc < 1 || nsrc > 65535 ||
      width < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (width + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  MaskPlanes planes = {
      {static_cast<int*>(p0), static_cast<int*>(p1), static_cast<int*>(p2),
       static_cast<int*>(p3)},
      {s0, s1, s2, s3},
      {f0, f1, f2, f3}};
  const dim3 grid((unsigned)tiles, (unsigned)nsrc, (unsigned)num_ops);
  mask_tail<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      planes, static_cast<const int*>(rc), src0, width, col0);
  return (int)cudaGetLastError();
}
