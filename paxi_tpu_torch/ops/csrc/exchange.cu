// Lane-major message-exchange kernels for Hopper (sm_90a).
//
// Both kernels work on one message type's stacked timing wheel, an int32
// block (d, F, R, R, G) with the group axis G contiguous: plane 0 of the F
// axis is the validity mask (0/1), planes 1.. are the message fields.  The
// plain PyTorch versions are paxi_tpu_torch/sim/mailbox.py deliver_planes
// and insert_planes; paxi_tpu_torch/ops/exchange.py binds these entry
// points through ctypes and checks every argument before the launch.
//
// paxi_wheel_deliver replaces the TPU kernel paxi_tpu/ops/exchange.py
// wheel_deliver (body _deliver_kernel): pop slot 0 as the inbox, write the
// wheel rotated forward one slot with the last slot zeroed.
//
// paxi_wheel_insert replaces the TPU kernel paxi_tpu/ops/exchange.py
// wheel_insert (body _insert_kernel): for each wheel slot s,
//   put = eff & (delay == s+1 | dup & min(delay+1, d) == s+1)
//   valid[s] |= put;  field[s] = put ? outbox field : field[s]
// A new send overwrites an undelivered message in the same cell (the
// collision rule the sim counts as delay_collisions).  eff (the send is
// valid, the edge live and not dropped) is formed by the caller.  The
// output is a fresh wheel; the input wheel is not written.
//
// Bound on an H100 (3.35 TB/s): both kernels only move data.  deliver
// reads the d slots once and writes the inbox plus d slots; insert reads
// the d slots, the outbox and the three (R, R, G) fault planes and writes
// d slots.  One thread handles one int32 element of a slot (F, R, R, G)
// and loops over the d slots, so neighbouring threads touch neighbouring
// addresses and every byte is read or written once.  Speed is later work:
// one launch for all five message types, and 16-byte vector loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void deliver_kernel(const int32_t* __restrict__ wheel,
                               int32_t* __restrict__ inbox,
                               int32_t* __restrict__ rolled,
                               int64_t slot_elems, int d) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= slot_elems) return;
  inbox[i] = wheel[i];
  for (int s = 0; s + 1 < d; ++s) {
    rolled[s * slot_elems + i] = wheel[(s + 1) * slot_elems + i];
  }
  rolled[(int64_t)(d - 1) * slot_elems + i] = 0;
}

__global__ void insert_kernel(const int32_t* __restrict__ wheel,
                              const int32_t* __restrict__ outbox,
                              const bool* __restrict__ eff,
                              const int32_t* __restrict__ delay,
                              const bool* __restrict__ dup,
                              int32_t* __restrict__ out,
                              int64_t edge_elems, int n_planes, int d) {
  int64_t slot_elems = edge_elems * n_planes;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= slot_elems) return;
  int64_t e = i % edge_elems;          // the (src, dst, g) edge cell
  bool is_valid_plane = i < edge_elems;
  bool ef = eff[e];
  int dl = delay[e];
  bool dp = dup[e];
  int dup_delay = dl + 1 < d ? dl + 1 : d;
  int32_t sent = outbox[i];
  for (int s = 0; s < d; ++s) {
    bool put = ef && (dl == s + 1 || (dp && dup_delay == s + 1));
    int64_t k = s * slot_elems + i;
    int32_t w = wheel[k];
    if (is_valid_plane) {
      out[k] = (w != 0 || put) ? 1 : 0;
    } else {
      out[k] = put ? sent : w;
    }
  }
}

unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int paxi_wheel_deliver(const int32_t* wheel, int32_t* inbox,
                                  int32_t* rolled, int64_t slot_elems, int d,
                                  void* stream) {
  if (slot_elems > 0) {
    deliver_kernel<<<blocks_for(slot_elems), kThreads, 0,
                     (cudaStream_t)stream>>>(wheel, inbox, rolled,
                                             slot_elems, d);
  }
  return (int)cudaGetLastError();
}

extern "C" int paxi_wheel_insert(const int32_t* wheel, const int32_t* outbox,
                                 const bool* eff, const int32_t* delay,
                                 const bool* dup, int32_t* out,
                                 int64_t edge_elems, int n_planes, int d,
                                 void* stream) {
  int64_t slot_elems = edge_elems * n_planes;
  if (slot_elems > 0) {
    insert_kernel<<<blocks_for(slot_elems), kThreads, 0,
                    (cudaStream_t)stream>>>(wheel, outbox, eff, delay, dup,
                                            out, edge_elems, n_planes, d);
  }
  return (int)cudaGetLastError();
}
