// K4: the all-gather of the sharded engines.
//
// Replaces round_tpu/parallel/ici.py::_ring_kernel (pl.pallas_call at
// ici.py:162, behind ring_exchange): on every one of p shards,
//     out[:, d*cols:(d+1)*cols] = shard d's x        (x is [rows, cols])
// for int32 codes or int8 bit-planes; any cols, any itemsize.
//
// The TPU kernel forwards chunks around a ring in p-1 dependent steps,
// because a TPU has only neighbour links.  A card reaches every peer of its
// host in one hop, so here each shard's chunk goes straight into slot `me`
// of every shard's out.  It is a copy, bound by bytes: each chunk is read
// once and written p times, the p + p^2 chunks the bound counts.  The work
// is cut into bands of whole rows of one shard's chunk; a band is
// contiguous in its source.  Two kernels, chosen by the ring's topology
// (parallel/ici.py::_launch_all, the plan from ici.py::_ring_plan):
//
// ring_gather_local serves a ring whose shards all lie on one device, in
// one launch for all of them.  The end of that launch orders every write
// before what follows on its stream, so it has no flags, no system fence
// and no spin, and its grid is sized for the work alone.  Its blocks walk
// the bands of all shards with a grid stride.  Where the rows and every
// pointer allow 16-byte bulk copies (the bulk path), one warp a block moves
// each band with the Tensor Memory Accelerator: one cp.async.bulk brings
// the band into shared memory, completed on an mbarrier, and one bulk store
// a row and destination writes it from there at the output's pitch p * row
// bytes.  Two band buffers: band k+1 loads while band k is stored.  Where a
// row or a slot offset breaks that alignment (int8 rows of 44 bytes, int32
// rows of 250 values, a row too long for a buffer), the same kernel takes
// the register path: 256 threads walk the band in 16-, 4- or 1-byte units,
// a power of two of lanes to a row, and each unit is read once and written
// to all p outputs.  Both paths index (row, column) with 32-bit arithmetic
// (the launcher refuses chunks whose offsets would not fit).
//
// ring_gather_peers serves shards on distinct cards, a launch per card
// (blockIdx.y is the shard among those of the card).  Its blocks take the
// register walk over a grid stride of their shard's bands, writing into
// the peers' memory, and signal arrival as the TPU kernel's semaphores do:
// after its writes a block fences at system scope and stores the call's
// epoch, with release, into flags[dest][me][block] of every destination;
// before it exits it polls, with acquire, flags[me][peer][block] of every
// peer until each holds the epoch.  So when a card's launch has ended,
// every block of every peer has written its share into that card's
// outputs.  Epochs only grow: no flag is reset, and a flag of an earlier
// call never passes for this one.  Blocks that spin on other blocks must
// all be resident, so the caller bounds the grid by a share of
// ring_exchange_max_blocks().  A block that waits longer than timeout_ns
// gives up and sets *status, so a peer that never launched ends in an
// error, not in a hung card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // a block of the register walk
constexpr int kBulkThreads = 32;    // a block of the bulk path: one warp
constexpr int kMaxShards = 64;      // parallel/ici.py::MAX_SHARDS
constexpr int kMaxBlocks = 64;      // parallel/ici.py::MAX_BLOCKS
constexpr int kMaxBandBytes = 16384;  // parallel/ici.py::_MAX_BAND_BYTES

struct RingArgs {
  char* outs[kMaxShards];       // [rows, p * row_bytes] of every shard
  const char* xs[kMaxShards];   // [rows, row_bytes] of every shard
  unsigned* flags[kMaxShards];  // peers: [p, kMaxBlocks] on each card
  int* status;                  // peers: 0, or 1 + the peer given up on
  long long timeout_ns;
  unsigned rows, row_bytes, pitch;  // pitch = p * row_bytes
  unsigned band_rows, bands;        // the bands of one shard's chunk
  unsigned unit_shift;              // register path: log2 of the unit
  unsigned lane_shift;              // register path: log2 of lanes a row
  int p, rank_base, bulk;
  unsigned epoch;
};

// ---- the bulk path: TMA bulk copies through an mbarrier -------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// bytes from global memory into shared memory, completed on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// bytes from shared memory into global memory, in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Band g of all shards' bands: shard g / bands, rows [r0, r0 + nr).
struct Band {
  unsigned me, r0, nr;
};

__device__ __forceinline__ Band band_of(const RingArgs& a, unsigned g) {
  Band b;
  b.me = g / a.bands;
  b.r0 = (g - b.me * a.bands) * a.band_rows;
  b.nr = min(a.band_rows, a.rows - b.r0);
  return b;
}

// One warp moves bands g = blockIdx.x, + gridDim.x, ... of all shards: the
// band in through one bulk load, out through a bulk store per row and
// destination, issued by the lanes in turn.  Two buffers of band_rows *
// row_bytes bytes in dynamic shared memory.
__device__ __forceinline__ void gather_bulk(const RingArgs& a) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) unsigned long long bar[2];
  const unsigned lane = threadIdx.x;
  const unsigned total = (unsigned)a.p * a.bands;
  const unsigned band_bytes = a.band_rows * a.row_bytes;
  const uint32_t bars = smem_addr(bar);
  const uint32_t bufs = smem_addr(buf);
  unsigned g = blockIdx.x;
  if (g >= total) return;
  if (lane == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init_fence();
    const Band b = band_of(a, g);
    mbar_expect_tx(bars, b.nr * a.row_bytes);
    bulk_load(bufs, a.xs[b.me] + b.r0 * a.row_bytes, b.nr * a.row_bytes,
              bars);
  }
  __syncwarp();
  for (unsigned k = 0; g < total; ++k, g += gridDim.x) {
    const unsigned s = k & 1;
    const unsigned next = g + gridDim.x;
    if (next < total) {
      // buffer s ^ 1 held band k - 1: its stores must have read it
      bulk_wait_read();
      __syncwarp();
      if (lane == 0) {
        const Band b = band_of(a, next);
        const uint32_t bar_n = bars + 8 * (s ^ 1);
        mbar_expect_tx(bar_n, b.nr * a.row_bytes);
        bulk_load(bufs + (s ^ 1) * band_bytes,
                  a.xs[b.me] + b.r0 * a.row_bytes, b.nr * a.row_bytes,
                  bar_n);
      }
    }
    const Band b = band_of(a, g);
    mbar_wait(bars + 8 * s, (k >> 1) & 1);
    const uint32_t src = bufs + s * band_bytes;
    const unsigned slot = b.me * a.row_bytes;
    for (unsigned i = lane; i < b.nr * (unsigned)a.p; i += kBulkThreads) {
      const unsigned d = i / b.nr;
      const unsigned r = i - d * b.nr;
      bulk_store(a.outs[d] + (b.r0 + r) * a.pitch + slot,
                 src + r * a.row_bytes, a.row_bytes);
    }
    bulk_commit();
  }
  bulk_wait_all();
}

// ---- the register path: each unit read once, written p times -------------

// Rows [r0, r0 + nr) of shard me's chunk into slot me of every output, in
// units of V: 1 << lane_shift lanes to a row, blockDim.x >> lane_shift rows
// at a time.  Destinations from the shard's own on, so the shards of a
// launch spread their writes over the outputs.
template <typename V>
__device__ __forceinline__ void walk_band(const RingArgs& a, unsigned me,
                                          unsigned r0, unsigned nr) {
  const unsigned per_row = a.row_bytes / (unsigned)sizeof(V);
  const unsigned lanes = 1u << a.lane_shift;
  const unsigned lane = threadIdx.x & (lanes - 1);
  const unsigned slot = me * a.row_bytes;
  for (unsigned r = threadIdx.x >> a.lane_shift; r < nr;
       r += blockDim.x >> a.lane_shift) {
    const V* src =
        reinterpret_cast<const V*>(a.xs[me] + (r0 + r) * a.row_bytes);
    const unsigned off = (r0 + r) * a.pitch + slot;
    for (unsigned c = lane; c < per_row; c += lanes) {
      const V v = src[c];
      int d = (int)me;
      for (int k = 0; k < a.p; ++k) {
        reinterpret_cast<V*>(a.outs[d] + off)[c] = v;
        d = d + 1 == a.p ? 0 : d + 1;
      }
    }
  }
}

__device__ __forceinline__ void walk(const RingArgs& a, unsigned me,
                                     unsigned r0, unsigned nr) {
  if (a.unit_shift == 4) {
    walk_band<uint4>(a, me, r0, nr);
  } else if (a.unit_shift == 2) {
    walk_band<uint32_t>(a, me, r0, nr);
  } else {
    walk_band<uint8_t>(a, me, r0, nr);
  }
}

// ---- the peers' arrival flags ----------------------------------------------

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---- the kernels -------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ring_gather_local(const RingArgs a) {
  if (a.bulk) {
    gather_bulk(a);
    return;
  }
  const unsigned total = (unsigned)a.p * a.bands;
  for (unsigned g = blockIdx.x; g < total; g += gridDim.x) {
    const Band b = band_of(a, g);
    walk(a, b.me, b.r0, b.nr);
  }
}

__global__ void __launch_bounds__(kThreads)
ring_gather_peers(const RingArgs a) {
  const int me = a.rank_base + (int)blockIdx.y;
  for (unsigned b = blockIdx.x; b < a.bands; b += gridDim.x) {
    const unsigned r0 = b * a.band_rows;
    walk(a, (unsigned)me, r0, min(a.band_rows, a.rows - r0));
  }
  // every thread's writes are ordered before the flags at system scope
  __threadfence_system();
  __syncthreads();
  const unsigned slot = (unsigned)me * kMaxBlocks + blockIdx.x;
  if ((int)threadIdx.x < a.p) {
    st_release_sys(a.flags[threadIdx.x] + slot, a.epoch);
  }
  // wait for the matching block of every peer (and of this shard itself)
  if ((int)threadIdx.x < a.p) {
    const unsigned* f =
        a.flags[me] + (unsigned)threadIdx.x * kMaxBlocks + blockIdx.x;
    const unsigned long long t0 = global_ns();
    while ((int)(ld_acquire_sys(f) - a.epoch) < 0) {
      __nanosleep(64);
      if ((long long)(global_ns() - t0) > a.timeout_ns) {
        atomicExch(a.status, 1 + (int)threadIdx.x);
        break;
      }
    }
  }
  __syncthreads();
}

// Make `device` current for a launch; *prev is the device to restore.
cudaError_t enter_device(int device, int* prev) {
  cudaError_t err = cudaGetDevice(prev);
  if (err == cudaSuccess && *prev != device) err = cudaSetDevice(device);
  return err;
}

cudaError_t leave_device(int device, int prev, cudaError_t err) {
  if (prev != device) cudaSetDevice(prev);
  return err;
}

int log2_exact(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return (1 << s) == v ? s : -1;
}

// Fill the fields both kernels share and check the plan against the
// pointers: 0, or cudaErrorInvalidValue.
int fill_args(RingArgs* a, void* const* outs, void* const* xs, int p,
              int rows, int row_bytes, int bulk, int unit, int band_rows,
              int lanes) {
  if (p < 1 || p > kMaxShards || rows <= 0 || row_bytes <= 0 ||
      band_rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  // every offset is an unsigned 32-bit product
  if ((long long)rows * p * row_bytes >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int unit_shift = log2_exact(bulk ? 16 : unit);
  const int lane_shift = log2_exact(lanes);
  if (unit_shift < 0 || unit_shift == 1 || unit_shift == 3 ||
      unit_shift > 4 || row_bytes % (1 << unit_shift) != 0 ||
      (!bulk && (lane_shift < 0 || lanes > kThreads)) ||
      (bulk && band_rows * row_bytes > kMaxBandBytes)) {
    return (int)cudaErrorInvalidValue;
  }
  uintptr_t align = 0;
  for (int r = 0; r < p; ++r) {
    a->outs[r] = (char*)outs[r];
    a->xs[r] = (const char*)xs[r];
    a->flags[r] = nullptr;
    align |= (uintptr_t)outs[r] | (uintptr_t)xs[r];
  }
  if ((align & ((1u << unit_shift) - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  a->status = nullptr;
  a->timeout_ns = 0;
  a->rows = (unsigned)rows;
  a->row_bytes = (unsigned)row_bytes;
  a->pitch = (unsigned)(p * row_bytes);
  a->band_rows = (unsigned)band_rows;
  a->bands = (unsigned)((rows + band_rows - 1) / band_rows);
  a->unit_shift = (unsigned)unit_shift;
  a->lane_shift = bulk ? 0u : (unsigned)lane_shift;
  a->p = p;
  a->rank_base = 0;
  a->bulk = bulk;
  a->epoch = 0;
  return 0;
}

}  // namespace

extern "C" {

// The blocks of the peers kernel one device keeps resident at once, or
// <= 0 when the query fails.
int ring_exchange_max_blocks(int device) {
  int prev = 0, per_sm = 0, sms = 0;
  cudaError_t err = enter_device(device, &prev);
  if (err != cudaSuccess) return -1;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_gather_peers, kThreads, 0);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  leave_device(device, prev, err);
  return err == cudaSuccess ? per_sm * sms : -1;
}

// Let kernels on `device` write into memory of `peer`.  Returns a CUDA
// error code; cudaErrorPeerAccessUnsupported when the cards cannot reach
// each other.
int ring_enable_peer(int device, int peer) {
  int can = 0, prev = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  if ((err = enter_device(device, &prev)) != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky code
    err = cudaSuccess;
  }
  return (int)leave_device(device, prev, err);
}

// ring_gather_local for all p shards, which lie on `device`, on `stream`.
// outs and xs are host arrays of p device pointers (by rank).  The plan
// (parallel/ici.py::_ring_plan): bulk or register path, the register
// path's unit (16, 4 or 1 bytes) and lanes to a row, rows to a band, and
// blocks.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan
// the pointers or the sizes do not allow.
int ring_gather_local_launch(void* const* outs, void* const* xs, int p,
                             int rows, int row_bytes, int bulk, int unit,
                             int lanes, int band_rows, int blocks,
                             int device, void* stream) {
  RingArgs a;
  int err = fill_args(&a, outs, xs, p, rows, row_bytes, bulk, unit,
                      band_rows, lanes);
  if (err != 0) return err;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t e = enter_device(device, &prev);
  if (e != cudaSuccess) return (int)e;
  if (bulk) {
    ring_gather_local<<<(unsigned)blocks, kBulkThreads,
                        2 * band_rows * row_bytes, (cudaStream_t)stream>>>(a);
  } else {
    ring_gather_local<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(a);
  }
  return (int)leave_device(device, prev, cudaGetLastError());
}

// ring_gather_peers for the n_local shards rank_base .. rank_base +
// n_local - 1, which lie on `device`, on `stream`, with nb blocks a shard
// (the register path of the plan).  flags is a host array of p device
// pointers, each shard's [p, kMaxBlocks] arrival flags on its card.
// Returns cudaGetLastError(), or cudaErrorInvalidValue.
int ring_gather_peers_launch(void* const* outs, void* const* xs,
                             void* const* flags, int* status, int p,
                             int rows, int row_bytes, int unit, int lanes,
                             int band_rows, int nb, int rank_base,
                             int n_local, unsigned epoch,
                             long long timeout_ns, int device, void* stream) {
  RingArgs a;
  int err = fill_args(&a, outs, xs, p, rows, row_bytes, 0, unit, band_rows,
                      lanes);
  if (err != 0) return err;
  if (nb < 1 || nb > kMaxBlocks || n_local < 1 || rank_base < 0 ||
      rank_base + n_local > p) {
    return (int)cudaErrorInvalidValue;
  }
  for (int r = 0; r < p; ++r) a.flags[r] = (unsigned*)flags[r];
  a.status = status;
  a.timeout_ns = timeout_ns;
  a.rank_base = rank_base;
  a.epoch = epoch;
  int prev = 0;
  cudaError_t e = enter_device(device, &prev);
  if (e != cudaSuccess) return (int)e;
  ring_gather_peers<<<dim3((unsigned)nb, (unsigned)n_local), kThreads, 0,
                      (cudaStream_t)stream>>>(a);
  return (int)leave_device(device, prev, cudaGetLastError());
}

}  // extern "C"
