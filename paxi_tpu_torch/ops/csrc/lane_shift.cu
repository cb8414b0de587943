// The ring shift between ranks for Hopper (sm_90a): every rank's whole
// shard moves to its right-hand neighbour (my + 1) % world, so rank r ends
// up holding rank (r - 1) % world's shard.
//
// paxi_lane_shift replaces the TPU kernel paxi_tpu/ops/exchange.py
// make_remote_lane_shift (inner _kernel): one async remote copy
// (pltpu.make_async_remote_copy) with a send and a receive DMA semaphore.
// Here each rank owns one cudaMalloc'd block holding its receive buffer
// and five 32-bit words:
//   flags[0]  "arrived": the epoch of the last shard the left neighbour
//             wrote into my buffer (the TPU kernel's receive semaphore);
//   flags[1]  "free": the epoch of my last shard the right neighbour has
//             copied out of its buffer (the send side: I may write the
//             next epoch only once the last one was consumed);
//   flags[2]  status: 0, or the code of a wait that timed out;
//   flags[3], flags[4]  the blocks done with this call's send and receive.
// The blocks are shared between the ranks' processes by CUDA IPC handles
// (cudaIpcGetMemHandle / cudaIpcOpenMemHandle with lazy peer access), so
// the copy stores straight into the neighbour's memory over NVLink/P2P.
// One call, epoch e, is two launches of one kernel on the caller's stream:
//   send: wait my.free >= e - 1, copy x -> right.recv, then the last
//         block to finish publishes right.arrived = e;
//   recv: wait my.arrived >= e, copy my.recv -> out, then the last block
//         publishes left.free = e.
// Every block's first thread waits (acquire at system scope) before its
// block copies its share with 16-byte loads and stores where aligned;
// each block then fences at system scope and counts itself done, and the
// last one resets the count and stores the flag with st.release.sys.  At
// world 1 the right and left neighbours are the rank itself and the same
// kernel copies through its own buffer (a process cannot open its own IPC
// handle, so the local pointer stands in), as the TPU kernel's one-device
// shift copies to itself.
//
// The waits spin with __nanosleep and a bound on %globaltimer; on timeout
// they write a code into the local status word and into a pinned host
// word the wrapper reads, and every later block returns at once, so a
// broken ring raises instead of hanging.  A device-side spin (not
// cuStreamWaitValue32) keeps the library on the runtime API alone; where
// several ranks share one card their contexts time-slice, a spinning
// block holds its context's slice until it is preempted, and a call costs
// context switches rather than bytes.
//
// Bound on an H100: bytes.  Each call reads the shard once and writes it
// once into the neighbour, then reads the buffer and writes the output:
// 2 x bytes over the 3.35 TB/s of device memory when the neighbour is on
// the same card; across cards the shard's bytes over one NVLink direction
// (450 GB/s).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One side of a call: wait until *wait_flag reaches want (epochs compared
// modulo 2^32), copy nbytes src -> dst, and let the last block to finish
// publish *signal_flag = value.
__global__ void shift_kernel(const unsigned* wait_flag, unsigned want,
                             const uint8_t* __restrict__ src,
                             uint8_t* __restrict__ dst, int64_t nbytes,
                             int vec, unsigned* done, unsigned* signal_flag,
                             unsigned value, unsigned* status, int* host_err,
                             int code, unsigned long long timeout_ns) {
  __shared__ unsigned stop;
  if (threadIdx.x == 0) {
    unsigned s = *(volatile unsigned*)status;
    unsigned long long t0 = global_ns();
    while (!s && (int)(ld_acquire_sys(wait_flag) - want) < 0) {
      if (global_ns() - t0 > timeout_ns) {
        atomicCAS(status, 0u, (unsigned)code);
        *(volatile int*)host_err = code;
        __threadfence_system();
        s = code;
        break;
      }
      __nanosleep(256);
      s = *(volatile unsigned*)status;
    }
    stop = s;
  }
  __syncthreads();
  if (stop) return;
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t head = 0;
  if (vec) {
    int64_t n16 = nbytes / 16;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int64_t i = tid; i < n16; i += stride) d4[i] = s4[i];
    head = n16 * 16;
  }
  for (int64_t i = head + tid; i < nbytes; i += stride) dst[i] = src[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    if (atomicAdd(done, 1u) == gridDim.x - 1) {
      atomicExch(done, 0u);
      __threadfence_system();
      st_release_sys(signal_flag, value);
    }
  }
}

int copy_grid(int64_t nbytes, int vec) {
  int64_t work = vec ? (nbytes + 15) / 16 : nbytes;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

// One rank's block: nbytes of receive buffer, then the five flag words at
// byte offset flags_off; zeroed.
int paxi_shift_alloc(int device, int64_t block_bytes, void** block) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaMalloc(block, (size_t)block_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(*block, 0, (size_t)block_bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

int paxi_shift_free(int device, void* block) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFree(block);
}

// handle: 64 bytes (cudaIpcMemHandle_t) written for the caller.
int paxi_shift_handle(int device, void* block, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaIpcGetMemHandle(
      reinterpret_cast<cudaIpcMemHandle_t*>(handle), block);
}

int paxi_shift_open(int device, const void* handle, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h,
                                   cudaIpcMemLazyEnablePeerAccess);
}

int paxi_shift_close(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaIpcCloseMemHandle(ptr);
}

// A pinned host word the device can write (the timeout report).
int paxi_shift_host_word(int device, int** host, int** dev) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaHostAlloc(reinterpret_cast<void**>(host), sizeof(int),
                    cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  **host = 0;
  return (int)cudaHostGetDevicePointer(reinterpret_cast<void**>(dev),
                                       *host, 0);
}

int paxi_shift_free_host_word(int* host) {
  return (int)cudaFreeHost(host);
}

// One ring-shift call of epoch `epoch` (>= 1).  `mine`, `right`, `left`
// are the blocks of this rank and of its neighbours (mapped into this
// process); `src` and `out` are nbytes each.  Launches only; returns the
// launch error, if any.
int paxi_lane_shift(int device, const void* src, void* out, void* mine,
                    void* right, void* left, int64_t nbytes,
                    int64_t flags_off, unsigned epoch, int* host_err,
                    unsigned long long timeout_ns, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  unsigned* my_flags =
      reinterpret_cast<unsigned*>(static_cast<uint8_t*>(mine) + flags_off);
  unsigned* right_flags =
      reinterpret_cast<unsigned*>(static_cast<uint8_t*>(right) + flags_off);
  unsigned* left_flags =
      reinterpret_cast<unsigned*>(static_cast<uint8_t*>(left) + flags_off);
  unsigned* status = my_flags + 2;
  int vec_send = ((uintptr_t)src % 16 == 0) ? 1 : 0;
  int vec_recv = ((uintptr_t)out % 16 == 0) ? 1 : 0;
  shift_kernel<<<copy_grid(nbytes, vec_send), kThreads, 0, stream>>>(
      my_flags + 1, epoch - 1, static_cast<const uint8_t*>(src),
      static_cast<uint8_t*>(right), nbytes, vec_send, my_flags + 3,
      right_flags + 0, epoch, status, host_err, 1, timeout_ns);
  shift_kernel<<<copy_grid(nbytes, vec_recv), kThreads, 0, stream>>>(
      my_flags + 0, epoch, static_cast<const uint8_t*>(mine),
      static_cast<uint8_t*>(out), nbytes, vec_recv, my_flags + 4,
      left_flags + 1, epoch, status, host_err, 2, timeout_ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
