// The ring shift between ranks for Hopper (sm_90a): every rank's whole
// shard moves to its right-hand neighbour (my + 1) % world, so rank r ends
// up holding rank (r - 1) % world's shard.  A call moves a whole state:
// up to kMaxSegments tensors ("segments") of any size and byte offset.
//
// paxi_lane_shift replaces the TPU kernel paxi_tpu/ops/exchange.py
// make_remote_lane_shift (inner _kernel): one async remote copy
// (pltpu.make_async_remote_copy) with a send and a receive DMA semaphore;
// on one device the TPU kernel copies the shard into its own output.
//
// Bound on an H100: bytes.  On one card (world 1) a call must read the
// shard once and write it once: 2 x bytes over the 3.35 TB/s of device
// memory.  Across cards the shard's bytes over one NVLink direction
// (450 GB/s).
//
// The copy.  The segments' bytes are cut into 16-byte units, numbered
// across the segments (the segment table carries each segment's first
// unit); every thread moves kUnroll units a turn, loading all of them
// before it stores any, so several 16-byte loads are in flight per thread,
// and the grid fills the card.  A turn that lies inside one aligned
// segment reads the table once; otherwise each unit finds its segment,
// and a unit whose source and destination are both 16-byte aligned and
// whole moves as one vector, any other (the last, short unit of an
// odd-sized bool plane, or a plane at an odd offset) byte by byte.  The
// table is a __grid_constant__ kernel parameter, read in place: nothing to
// upload.
//
// World 1 (paxi_lane_copy): the rank is its own neighbour, so one launch
// copies every segment straight into the caller's outputs, with no buffer,
// no flag and no fence: 2 x bytes, the bound.
//
// World > 1 (paxi_lane_shift).  Each rank owns one cudaMalloc'd block
// holding its receive buffer (every segment at a 256-byte aligned offset)
// and five 32-bit words:
//   flags[0]  "arrived": the epoch of the last state the left neighbour
//             wrote into my buffer (the TPU kernel's receive semaphore);
//   flags[1]  "free": the epoch of my last state the right neighbour has
//             copied out of its buffer (the send side: I may write the
//             next epoch only once the last one was consumed);
//   flags[2]  status: 0, or the code of a wait that timed out;
//   flags[3], flags[4]  the blocks done with this call's send and receive.
// The blocks are shared between the ranks' processes by CUDA IPC handles
// (cudaIpcGetMemHandle / cudaIpcOpenMemHandle with lazy peer access), so
// the copy stores straight into the neighbour's memory over NVLink/P2P.
// One call, epoch e, is two launches of one kernel on the caller's stream,
// whatever the number of segments:
//   send: wait my.free >= e - 1, copy every x -> right.recv, then the last
//         block to finish publishes right.arrived = e;
//   recv: wait my.arrived >= e, copy my.recv -> every out, then the last
//         block publishes left.free = e.
// Every block's first thread waits (acquire at system scope) before its
// block copies its share; each block then fences at system scope and
// counts itself done, and the last one resets the count and stores the flag
// with st.release.sys.  The receive side's copy-out moves 2 x the shard
// through device memory (3.35 TB/s) on top of the shard over NVLink: about
// 27% over the bound across cards.  Outputs that live in the IPC block
// would remove it.
//
// The waits spin with __nanosleep and a bound on %globaltimer; on timeout
// they write a code into the local status word and into a pinned host
// word the wrapper reads, and every later block returns at once, so a
// broken ring raises instead of hanging.  A device-side spin (not
// cuStreamWaitValue32) keeps the library on the runtime API alone; where
// several ranks share one card their contexts time-slice, and each call
// costs two waits a rank only another rank's context can end.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;                // 16-byte units a thread a turn
constexpr int kMaxSegments = 64;          // the table fits a kernel parameter
constexpr int kBlocksPerSm = 16;

struct Segments {
  const uint8_t* src[kMaxSegments];
  uint8_t* dst[kMaxSegments];
  int64_t nbytes[kMaxSegments];
  int64_t unit0[kMaxSegments + 1];        // first unit of each; then the total
  int n;
};

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

// The segment holding unit u (u < the total): the last with unit0 <= u.
__device__ __forceinline__ int find_segment(const Segments& t, int64_t u) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.unit0[mid] <= u) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Every unit of the table, grid-stride, kUnroll units a thread a turn.
__device__ __forceinline__ void copy_units(const Segments& t) {
  const int64_t total = t.unit0[t.n];
  const int64_t tile = (int64_t)kThreads * kUnroll;
  for (int64_t base = (int64_t)blockIdx.x * tile; base < total;
       base += (int64_t)gridDim.x * tile) {
    const int first = find_segment(t, base);     // the same for the block
    const int64_t rel = base - t.unit0[first];
    if (base + tile <= t.unit0[first + 1]
        && (rel + tile) * 16 <= t.nbytes[first]
        && (((uintptr_t)t.src[first] | (uintptr_t)t.dst[first]) & 15) == 0) {
      // the whole turn lies in one segment, every unit whole and aligned
      const uint4* s4 = reinterpret_cast<const uint4*>(t.src[first]) + rel;
      uint4* d4 = reinterpret_cast<uint4*>(t.dst[first]) + rel;
      uint4 v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) v[j] = s4[j * kThreads + threadIdx.x];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) d4[j * kThreads + threadIdx.x] = v[j];
      continue;
    }
    int seg[kUnroll];
    int64_t off[kUnroll];
    bool vec[kUnroll];
    uint4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t u = base + j * kThreads + threadIdx.x;
      seg[j] = -1;
      if (u >= total) continue;
      int s = first;
      while (u >= t.unit0[s + 1]) ++s;
      seg[j] = s;
      off[j] = (u - t.unit0[s]) * 16;
      vec[j] = off[j] + 16 <= t.nbytes[s] &&
               (((uintptr_t)t.src[s] | (uintptr_t)t.dst[s]) & 15) == 0;
      if (vec[j]) v[j] = *reinterpret_cast<const uint4*>(t.src[s] + off[j]);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int s = seg[j];
      if (s < 0) continue;
      if (vec[j]) {
        *reinterpret_cast<uint4*>(t.dst[s] + off[j]) = v[j];
      } else {
        const int64_t end = min(off[j] + 16, t.nbytes[s]);
        for (int64_t i = off[j]; i < end; ++i) t.dst[s][i] = t.src[s][i];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const __grid_constant__ Segments t) {
  copy_units(t);
}

// One side of a ring call: wait until *wait_flag reaches want (epochs
// compared modulo 2^32), copy every segment, and let the last block to
// finish publish *signal_flag = value.
__global__ void __launch_bounds__(kThreads)
shift_kernel(const __grid_constant__ Segments t, const unsigned* wait_flag,
             unsigned want, unsigned* done, unsigned* signal_flag,
             unsigned value, unsigned* status, int* host_err, int code,
             unsigned long long timeout_ns) {
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
  copy_units(t);
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

int copy_grid(int device, int64_t units) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (units + (int64_t)kThreads * kUnroll - 1)
                   / ((int64_t)kThreads * kUnroll);
  const int64_t most = (int64_t)sms * kBlocksPerSm;
  if (blocks > most) blocks = most;
  return blocks < 1 ? 1 : (int)blocks;
}

// The table of n segments: src[i] -> dst[i], nbytes[i] each, first units
// unit0[0..n] (unit0[n] the total).
int fill(Segments* t, int n, const void* const* src, void* const* dst,
         const int64_t* nbytes, const int64_t* unit0) {
  if (n < 1 || n > kMaxSegments) return (int)cudaErrorInvalidValue;
  memset(t, 0, sizeof(*t));
  t->n = n;
  for (int i = 0; i < n; ++i) {
    t->src[i] = static_cast<const uint8_t*>(src[i]);
    t->dst[i] = static_cast<uint8_t*>(dst[i]);
    t->nbytes[i] = nbytes[i];
  }
  for (int i = 0; i <= n; ++i) t->unit0[i] = unit0[i];
  return 0;
}

}  // namespace

extern "C" {

// One rank's block: the receive buffer, then the five flag words at byte
// offset flags_off; zeroed.
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

// World 1: one launch copies src[i] -> out[i] for the n segments.
int paxi_lane_copy(int device, int n, const void* const* src,
                   void* const* out, const int64_t* nbytes,
                   const int64_t* unit0, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Segments t;
  int err = fill(&t, n, src, out, nbytes, unit0);
  if (err) return err;
  copy_kernel<<<copy_grid(device, unit0[n]), kThreads, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

// One ring-shift call of epoch `epoch` (>= 1) over n segments.  `mine`,
// `right`, `left` are the blocks of this rank and of its neighbours
// (mapped into this process); segment i is src[i] -> out[i], nbytes[i],
// at byte offset offs[i] of the receive buffers.  Two launches (send,
// receive); returns the launch error, if any.
int paxi_lane_shift(int device, int n, const void* const* src,
                    void* const* out, const int64_t* nbytes,
                    const int64_t* offs, const int64_t* unit0, void* mine,
                    void* right, void* left, int64_t flags_off,
                    unsigned epoch, int* host_err,
                    unsigned long long timeout_ns, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || n > kMaxSegments) return (int)cudaErrorInvalidValue;
  uint8_t* my = static_cast<uint8_t*>(mine);
  uint8_t* rt = static_cast<uint8_t*>(right);
  unsigned* my_flags = reinterpret_cast<unsigned*>(my + flags_off);
  unsigned* right_flags = reinterpret_cast<unsigned*>(rt + flags_off);
  unsigned* left_flags = reinterpret_cast<unsigned*>(
      static_cast<uint8_t*>(left) + flags_off);
  unsigned* status = my_flags + 2;
  void* to_right[kMaxSegments];
  const void* from_mine[kMaxSegments];
  for (int i = 0; i < n; ++i) {
    to_right[i] = rt + offs[i];
    from_mine[i] = my + offs[i];
  }
  Segments send, recv;
  int err = fill(&send, n, src, to_right, nbytes, unit0);
  if (!err) err = fill(&recv, n, from_mine, out, nbytes, unit0);
  if (err) return err;
  const int grid = copy_grid(device, unit0[n]);
  shift_kernel<<<grid, kThreads, 0, stream>>>(
      send, my_flags + 1, epoch - 1, my_flags + 3, right_flags + 0, epoch,
      status, host_err, 1, timeout_ns);
  shift_kernel<<<grid, kThreads, 0, stream>>>(
      recv, my_flags + 0, epoch, my_flags + 4, left_flags + 1, epoch,
      status, host_err, 2, timeout_ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
