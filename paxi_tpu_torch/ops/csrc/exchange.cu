// Lane-major message-exchange kernels for Hopper (sm_90a): the two halves
// of a simulation step's message exchange, each one launch over every
// message type of the step.
//
// One message type's timing wheel (a "segment" of a launch) is a stacked
// int32 block (d, F, R, R, G) with the group axis G contiguous: plane 0 of
// the F axis is the validity mask (0/1), planes 1.. are the message fields;
// slot s holds the messages that arrive in s + 1 steps.  The plain PyTorch
// versions are paxi_tpu_torch/sim/mailbox.py wheel_deliver and
// wheel_insert (deliver_planes / insert_planes a type);
// paxi_tpu_torch/ops/exchange.py checks every argument, builds the tables
// below and binds these entry points through ctypes.
//
// paxi_exchange_deliver replaces the TPU kernel paxi_tpu/ops/exchange.py
// wheel_deliver (body _deliver_kernel): pop slot 0 of every type as the
// inbox -- its validity written as bool 0/1, its fields as one (F-1, R, R,
// G) int32 block -- and write each wheel rotated forward one slot, the
// last slot zeroed.
//
// paxi_exchange_insert replaces the TPU kernel paxi_tpu/ops/exchange.py
// wheel_insert (body _insert_kernel) together with the effective-send mask
// its caller formed (mailbox.live_mask and the drop plane): for each edge
// cell (src, dst, g)
//   eff = valid & src != dst & conn & !crashed[src] & !crashed[dst] & !drop
// and for each wheel slot s
//   put = eff & (delay == s+1 | dup & min(delay+1, d) == s+1)
//   valid[s] = valid[s] != 0 | put;  field[s] = put ? outbox field : field[s]
// A new send overwrites an undelivered message in the same cell (the
// collision rule the sim counts as delay_collisions).  The outbox planes
// are read where they lie: each has its own pointer and src and dst
// strides (protocols send ring.dst_major transposes and views broadcast
// over dst); the group axis has stride 1 (the wrapper raises otherwise).
// The fault planes, conn and crashed are contiguous.  The output is a
// fresh wheel; the input wheel is not written.
//
// Bound on an H100: bytes over 3.35 TB/s; both kernels only move data.
// Per type, with E = R*R*G, each input read once and each output written
// once:
//   deliver reads d*F*E*4 and writes E (valid) + (F-1)*E*4 + d*F*E*4;
//   insert reads d*F*E*4 + (F-1)*E*4 + E (valid) + E (drop) + E (dup)
//          + 4E (delay) and writes d*F*E*4,
// and insert reads conn (R*R*G) and crashed (R*G) once a step.
//
// The design.  The first version took a launch per type and per half and
// moved one int32 a thread; at a 3-replica mailbox (~35 MB a type) the
// launch, ramp-up and tail cost as much as the bytes, and torch passes
// around it formed eff and stacked the outbox.  Here:
//  - one launch a half for every type of a step: a segment table (at most
//    kMaxSegments types and kMaxPlanes outbox planes; the wrapper splits
//    more over launches) is a __grid_constant__ kernel parameter, read in
//    place.  Every segment's units start a new block, so a block finds its
//    segment with one uniform search and never straddles two;
//  - the work unit is 16 bytes: 4 consecutive groups of one int32 plane
//    row (deliver: 4 consecutive elements of a plane), loaded and stored as
//    one vector; a bool plane's 4 lanes move as one 4-byte word;
//  - an insert thread owns one unit of edge cells: it reads the fault
//    planes, conn, both crash words and the send's valid word once, forms
//    eff itself, then walks the F planes, reading each outbox plane once
//    for all d slots; the slot loads of a plane (kSlotChunk at a time) are
//    issued before their stores;
//  - no 64-bit division: a unit's plane, row and groups come from 32-bit
//    divisions by per-launch constants; element offsets are 64-bit (the
//    epaxos wheel at d = 3 is 2.67 GB at 100k groups);
//  - a segment whose pointers are not 16-byte aligned, or whose G (for
//    deliver, E) is not a multiple of 4, takes the scalar path on the same
//    units, element by element up to the ragged end; an outbox plane at an
//    odd offset or stride takes scalar accesses alone.  The wrapper decides
//    both (ops/exchange.py vector_ok).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // units a block (exchange.py BLOCK_UNITS)
constexpr int kMaxSegments = 16;    // message types a launch takes
constexpr int kMaxPlanes = 128;     // outbox planes an insert launch takes
constexpr int kSlotChunk = 4;       // slot loads issued before their stores

struct DeliverSeg {
  const int32_t* wheel;   // (d, F, E)
  uint8_t* valid;         // (E) bool: the inbox's validity
  int32_t* fields;        // (F - 1, E): the inbox's fields
  int32_t* rolled;        // (d, F, E)
  int64_t E;
  int32_t d, F, U, vec;   // U = ceil(E / 4) units a plane
};

struct DeliverTable {
  DeliverSeg seg[kMaxSegments];
  int32_t block0[kMaxSegments + 1];   // first block of each; then the grid
  int32_t n;
};

struct InsertSeg {
  const int32_t* wheel;   // (d, F, R, R, G)
  int32_t* out;           // (d, F, R, R, G)
  const uint8_t* drop;    // (R, R, G) bool
  const int32_t* delay;   // (R, R, G)
  const uint8_t* dup;     // (R, R, G) bool
  int32_t d, F, plane0, vec;   // plane0: the type's valid plane in `plane`
};

struct Plane {            // one outbox plane (src, dst, G), group stride 1
  const uint8_t* ptr;
  int32_t ss, sd;         // src and dst strides, in elements
};

struct InsertTable {
  InsertSeg seg[kMaxSegments];
  Plane plane[kMaxPlanes];              // each type's valid, then its fields
  uint32_t plane_vec[kMaxPlanes / 32];  // bit i: plane i takes 16-byte units
  int32_t block0[kMaxSegments + 1];
  const uint8_t* conn;                  // (R, R, G) bool
  const uint8_t* crashed;               // (R, G) bool
  int64_t E;                            // R * R * G
  int32_t R, G, G4, units, n;           // G4 = ceil(G / 4); units a type
};

struct alignas(16) Lanes {
  int32_t v[4];
};

// The segment of this block: the last whose first block is <= blockIdx.x.
__device__ __forceinline__ int block_segment(const int32_t* block0, int n) {
  int s = 0;
  while (s + 1 < n && (int)blockIdx.x >= block0[s + 1]) ++s;
  return s;
}

// 4 int32 lanes at p: one 16-byte access, or the first n one by one.
__device__ __forceinline__ Lanes ld4(const int32_t* p, bool vec, int n) {
  Lanes r;
  if (vec) {
    *reinterpret_cast<int4*>(r.v) = *reinterpret_cast<const int4*>(p);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) r.v[j] = j < n ? p[j] : 0;
  }
  return r;
}

__device__ __forceinline__ void st4(int32_t* p, const Lanes& r, bool vec,
                                    int n) {
  if (vec) {
    *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(r.v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) if (j < n) p[j] = r.v[j];
  }
}

// 4 bool lanes at p as one word, lane j in byte j.
__device__ __forceinline__ uint32_t ld4b(const uint8_t* p, bool vec, int n) {
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) if (j < n) w |= (uint32_t)p[j] << (8 * j);
  return w;
}

__device__ __forceinline__ void st4b(uint8_t* p, uint32_t w, bool vec,
                                     int n) {
  if (vec) {
    *reinterpret_cast<uint32_t*>(p) = w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) if (j < n) p[j] = (uint8_t)(w >> (8 * j));
  }
}

__global__ void __launch_bounds__(kThreads)
deliver_kernel(const __grid_constant__ DeliverTable t) {
  const int si = block_segment(t.block0, t.n);
  const DeliverSeg& sg = t.seg[si];
  const int k = ((int)blockIdx.x - t.block0[si]) * kThreads + (int)threadIdx.x;
  if (k >= sg.F * sg.U) return;
  const int p = k / sg.U;                           // the plane
  const int64_t e = (int64_t)(k - p * sg.U) * 4;    // its first element
  const int n = (int)min((int64_t)4, sg.E - e);
  const bool vec = sg.vec != 0;
  const int64_t slot = (int64_t)sg.F * sg.E;        // elements a slot
  const int64_t at = (int64_t)p * sg.E + e;
  for (int s0 = 0; s0 < sg.d; s0 += kSlotChunk) {
    Lanes w[kSlotChunk];
#pragma unroll
    for (int j = 0; j < kSlotChunk; ++j) {
      if (s0 + j < sg.d) w[j] = ld4(sg.wheel + (s0 + j) * slot + at, vec, n);
    }
#pragma unroll
    for (int j = 0; j < kSlotChunk; ++j) {
      const int s = s0 + j;
      if (s >= sg.d) break;
      if (s > 0) {
        st4(sg.rolled + (s - 1) * slot + at, w[j], vec, n);
      } else if (p > 0) {
        st4(sg.fields + (int64_t)(p - 1) * sg.E + e, w[j], vec, n);
      } else {
        uint32_t b = 0;
#pragma unroll
        for (int l = 0; l < 4; ++l) b |= (uint32_t)(w[j].v[l] != 0) << (8 * l);
        st4b(sg.valid + e, b, vec, n);
      }
    }
  }
  const Lanes zero = {{0, 0, 0, 0}};
  st4(sg.rolled + (sg.d - 1) * slot + at, zero, vec, n);
}

__device__ __forceinline__ bool plane_is_vec(const InsertTable& t, int i) {
  return (t.plane_vec[i >> 5] >> (i & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
insert_kernel(const __grid_constant__ InsertTable t) {
  const int si = block_segment(t.block0, t.n);
  const InsertSeg& sg = t.seg[si];
  const int k = ((int)blockIdx.x - t.block0[si]) * kThreads + (int)threadIdx.x;
  if (k >= t.units) return;
  const int row = k / t.G4;                         // src * R + dst
  const int g = (k - row * t.G4) * 4;               // the unit's first group
  const int src = row / t.R;
  const int dst = row - src * t.R;
  const int n = min(4, t.G - g);
  const bool vec = sg.vec != 0;
  const int64_t e = (int64_t)row * t.G + g;

  // eff, once a cell: the send is valid, the edge live, not dropped
  const Plane& pv = t.plane[sg.plane0];
  const uint32_t sent = ld4b(pv.ptr + (int64_t)src * pv.ss
                             + (int64_t)dst * pv.sd + g,
                             vec && plane_is_vec(t, sg.plane0), n);
  const uint32_t down = ld4b(sg.drop + e, vec, n)
      | ld4b(t.crashed + (int64_t)src * t.G + g, vec, n)
      | ld4b(t.crashed + (int64_t)dst * t.G + g, vec, n);
  const uint32_t eff = src == dst ? 0u
      : sent & ld4b(t.conn + e, vec, n) & ~down & 0x01010101u;
  const uint32_t dup = ld4b(sg.dup + e, vec, n);
  const Lanes delay = ld4(sg.delay + e, vec, n);
  // the slot (1-based; 0: none) each lane's send lands in, and its copy's
  int at1[4], at2[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const bool ef = (eff >> (8 * l)) & 1u;
    const bool du = (dup >> (8 * l)) & 1u;
    // min(delay + 1, d) with the int32 wrap of the plain version
    int dd = (int)((uint32_t)delay.v[l] + 1u);
    dd = dd < sg.d ? dd : sg.d;
    at1[l] = ef ? delay.v[l] : 0;
    at2[l] = ef && du ? dd : 0;
  }

  const int64_t slot = (int64_t)sg.F * t.E;
  for (int f = 0; f < sg.F; ++f) {
    Lanes o = {{0, 0, 0, 0}};
    if (f > 0) {
      const int pi = sg.plane0 + f;
      const Plane& pl = t.plane[pi];
      o = ld4(reinterpret_cast<const int32_t*>(pl.ptr)
                  + (int64_t)src * pl.ss + (int64_t)dst * pl.sd + g,
              vec && plane_is_vec(t, pi), n);
    }
    const int64_t at = (int64_t)f * t.E + e;
    for (int s0 = 0; s0 < sg.d; s0 += kSlotChunk) {
      Lanes w[kSlotChunk];
#pragma unroll
      for (int j = 0; j < kSlotChunk; ++j) {
        if (s0 + j < sg.d) {
          w[j] = ld4(sg.wheel + (s0 + j) * slot + at, vec, n);
        }
      }
#pragma unroll
      for (int j = 0; j < kSlotChunk; ++j) {
        const int s1 = s0 + j + 1;                  // the slot, 1-based
        if (s1 > sg.d) break;
        Lanes r;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const bool put = at1[l] == s1 || at2[l] == s1;
          r.v[l] = f == 0 ? (int32_t)(w[j].v[l] != 0 || put)
                          : (put ? o.v[l] : w[j].v[l]);
        }
        st4(sg.out + (s1 - 1) * slot + at, r, vec, n);
      }
    }
  }
}

// words: per segment wheel, valid, fields, rolled, E, d, F, vec, block0;
// then the grid.
int fill_deliver(DeliverTable* t, int n, const int64_t* words) {
  if (n < 1 || n > kMaxSegments) return (int)cudaErrorInvalidValue;
  t->n = n;
  for (int i = 0; i < n; ++i, words += 9) {
    DeliverSeg& s = t->seg[i];
    s.wheel = reinterpret_cast<const int32_t*>(words[0]);
    s.valid = reinterpret_cast<uint8_t*>(words[1]);
    s.fields = reinterpret_cast<int32_t*>(words[2]);
    s.rolled = reinterpret_cast<int32_t*>(words[3]);
    s.E = words[4];
    s.d = (int32_t)words[5];
    s.F = (int32_t)words[6];
    s.U = (int32_t)((s.E + 3) / 4);
    s.vec = (int32_t)words[7];
    t->block0[i] = (int32_t)words[8];
  }
  t->block0[n] = (int32_t)words[0];
  return 0;
}

// words: conn, crashed, R, G; per segment wheel, out, drop, delay, dup, d,
// F, vec, block0; the grid; per plane (every type's valid, then its
// fields, the types in order) ptr, src stride, dst stride, vec.
int fill_insert(InsertTable* t, int n, const int64_t* words) {
  if (n < 1 || n > kMaxSegments) return (int)cudaErrorInvalidValue;
  t->n = n;
  t->conn = reinterpret_cast<const uint8_t*>(words[0]);
  t->crashed = reinterpret_cast<const uint8_t*>(words[1]);
  t->R = (int32_t)words[2];
  t->G = (int32_t)words[3];
  t->G4 = (t->G + 3) / 4;
  t->E = (int64_t)t->R * t->R * t->G;
  t->units = t->R * t->R * t->G4;
  words += 4;
  int planes = 0;
  for (int i = 0; i < n; ++i, words += 9) {
    InsertSeg& s = t->seg[i];
    s.wheel = reinterpret_cast<const int32_t*>(words[0]);
    s.out = reinterpret_cast<int32_t*>(words[1]);
    s.drop = reinterpret_cast<const uint8_t*>(words[2]);
    s.delay = reinterpret_cast<const int32_t*>(words[3]);
    s.dup = reinterpret_cast<const uint8_t*>(words[4]);
    s.d = (int32_t)words[5];
    s.F = (int32_t)words[6];
    s.vec = (int32_t)words[7];
    s.plane0 = planes;
    t->block0[i] = (int32_t)words[8];
    planes += s.F;
  }
  if (planes > kMaxPlanes) return (int)cudaErrorInvalidValue;
  t->block0[n] = (int32_t)words[0];
  words += 1;
  for (int i = 0; i < kMaxPlanes / 32; ++i) t->plane_vec[i] = 0;
  for (int i = 0; i < planes; ++i, words += 4) {
    t->plane[i].ptr = reinterpret_cast<const uint8_t*>(words[0]);
    t->plane[i].ss = (int32_t)words[1];
    t->plane[i].sd = (int32_t)words[2];
    if (words[3]) t->plane_vec[i >> 5] |= 1u << (i & 31);
  }
  return 0;
}

}  // namespace

extern "C" {

// One launch: inbox and rolled wheel of the n types in `words`.
int paxi_exchange_deliver(int n, const int64_t* words, cudaStream_t stream) {
  DeliverTable t;
  int err = fill_deliver(&t, n, words);
  if (err) return err;
  if (t.block0[n] > 0) {
    deliver_kernel<<<t.block0[n], kThreads, 0, stream>>>(t);
  }
  return (int)cudaGetLastError();
}

// One launch: the new wheel of the n types in `words`.
int paxi_exchange_insert(int n, const int64_t* words, cudaStream_t stream) {
  InsertTable t;
  int err = fill_insert(&t, n, words);
  if (err) return err;
  if (t.block0[n] > 0) {
    insert_kernel<<<t.block0[n], kThreads, 0, stream>>>(t);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
