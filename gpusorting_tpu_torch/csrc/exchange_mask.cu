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
// rate.  What kept the kernel from it was the grid, not the bytes: a grid
// over the whole window (a block per 4096 positions, source and operand)
// scheduled 49,344 blocks at the distributed path's shape (one source, a
// 2^26 + 2^18-slot window with a 2^20-slot tail, 3 planes) to write 768
// blocks' worth of tail, and as many on every chunk with no tail at all.
// Design against that:
//   * the grid is sized to the card, not to the window: the blocks an SM
//     the occupancy query gives times the SMs, shared evenly among the
//     (source, operand) rows, every row at least one block and no row more
//     than it has 16-byte stores for a block's threads;
//   * each block reads its row's count once and computes the first masked
//     position, first = clamp(rc[s] - col0, 0, width); the row's blocks
//     share [first, width) evenly, striding over it together so that the
//     stores in flight form one front a row, and a row with no tail
//     returns after that one load;
//   * the stores are 16 bytes (int4), neighbouring threads on neighbouring
//     16 bytes, streaming (evict-first: the planes are far larger than the
//     L2, so the next pass finds none of the tail there anyway);
//   * rows may start at any 4-byte offset (odd col0 views, row strides,
//     chunk slices), and a count puts the tail's start anywhere, so the
//     row's first block writes a scalar head up to the first 128-byte line
//     at or past `first` (at most 31 slots) and the scalar end past the
//     last whole int4.  Then every warp's 512 bytes are 4 whole lines: with
//     the head only up to a 16-byte boundary each warp's stores straddled
//     5 lines, and D = 8 tails of about 2^24 slots took 0.709 ms against
//     0.530 when the counts sat on lines (probes/torch_mask_probe.py, H100).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxOps = 4;
constexpr int kThreads = 256;

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
  // first masked index of the row: positions col0 + j >= rc[s]
  const long long first =
      min(max((long long)__ldg(rc + s) - col0, 0LL), width);
  if (first == width) return;  // no tail in this row
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
  // [first, v0) scalars up to a 128-byte line, [v0, v1) whole int4s,
  // [v1, width) scalars
  const long long mis =
      (long long)((reinterpret_cast<uintptr_t>(row + first) >> 2) & 31);
  const long long v0 = min(first + ((32 - mis) & 31), width);
  const long long nvec = (width - v0) >> 2;
  const long long v1 = v0 + 4 * nvec;
  if (blockIdx.x == 0) {
    if (threadIdx.x < v0 - first) row[first + threadIdx.x] = fill;
    if (threadIdx.x < width - v1) row[v1 + threadIdx.x] = fill;
  }
  // the row's blocks stride over its int4s together, so the stores in
  // flight at any time form one contiguous front a row
  int4* vrow = reinterpret_cast<int4*>(row + v0);
  const int4 f4 = make_int4(fill, fill, fill, fill);
  const long long step = (long long)gridDim.x * kThreads;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x; k < nvec;
       k += step) {
    __stcs(&vrow[k], f4);
  }
}

// Blocks of mask_tail the card holds at once (SMs x blocks an SM), queried
// once per device.
int card_blocks() {
  constexpr int kMaxDevices = 64;
  static int blocks[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
  if (dev < kMaxDevices && blocks[dev] > 0) return blocks[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mask_tail,
                                                    kThreads, 0) !=
          cudaSuccess) {
    return 0;
  }
  const int total = sms * per_sm;
  if (dev < kMaxDevices) blocks[dev] = total;
  return total;
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
  const int total = card_blocks();
  if (total < 1) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const long long rows = (long long)nsrc * num_ops;
  // a block's threads store one int4 each a round: no row needs more
  // blocks than it has rounds
  const long long most = (width + 4LL * kThreads - 1) / (4LL * kThreads);
  const long long per_row = std::max(1LL, std::min(total / rows, most));
  MaskPlanes planes = {
      {static_cast<int*>(p0), static_cast<int*>(p1), static_cast<int*>(p2),
       static_cast<int*>(p3)},
      {s0, s1, s2, s3},
      {f0, f1, f2, f3}};
  const dim3 grid((unsigned)per_row, (unsigned)nsrc, (unsigned)num_ops);
  mask_tail<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      planes, static_cast<const int*>(rc), src0, width, col0);
  return (int)cudaGetLastError();
}
