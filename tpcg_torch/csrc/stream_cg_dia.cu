// Fixed-iteration block CG (real) or COCG (complex) on a banded matrix in
// row-DIA storage, whole solve in one persistent cooperative launch.
//
// Replaces two Pallas kernels of tpcg/ops/stream_cg_dia.py:
//   * _build_dia_batch (and its nb=1 form _build_dia): real CG on a DIA
//     band, state resident in VMEM, the value diagonals streamed from HBM
//     once per iteration and applied to up to 8 RHS per fetch;
//   * _build_dia_cplx: the complex (two float planes) COCG twin, 1 RHS.
// Here one template covers both, for 1..8 RHS per launch.
//
// What it computes, per RHS b of nb independent recurrences:
//   q = A d      q[i] = sum_k vals[k, i] * d[i + off_k]   (row-DIA: data[d, i]
//                = A[i, i + off]); complex: qr += vr*dr - vi*di,
//                qi += vr*di + vi*dr
//   alpha = delta / <d,q>, beta = delta' / delta (complex: Smith division)
//   done |= (delta == 0) | (<d,q> == 0)            real freeze guard
//   done |= (|delta|^2 == 0) | (|<d,q>|^2 == 0)    complex freeze guard
//   latched per RHS until the next multiple of kLatchIters = 256 iterations
//   (JAX's latch lasts one call of _CHUNK = 256 iterations); a frozen RHS
//   keeps alpha = beta = 0 and its delta, so its direction is r and it
//   resumes from d = r where <d,q> reached 0 with delta not 0;
//   hist[it+1] = sqrt(delta) (real), sqrt(sqrt(|delta|^2)) (complex)
// with unconjugated dots <u,v> = sum u*v.  A frozen RHS costs the same
// work as a live one: every iteration runs q = A d and every state pass.
//
// What bounds it on the H100.  Each iteration reads every value once (the
// m_t1 class: 101 diagonals x 97,578 rows x 4 B = 39.4 MB; the parabolic
// class: 7 x 525,625 x 4 B = 14.7 MB) from HBM, and q = A d needs, per RHS,
// the direction once per diagonal and row: 101 x 8 x 4 B a row at 8 RHS.
// Read from L2 that is 315 MB an iteration on m_t1, eight times the
// values, and L2-to-SM bandwidth would pace the kernel; read from shared
// memory, its 128 bytes a clock an SM (about 11 us an iteration at 8 RHS)
// and the values' stream from HBM (about 12 us) bound q = A d, and the two
// overlap only in part.  Three grid barriers per iteration (after q = A d
// and the <d,q> partials; after the x, r update and the <r,r> partials;
// after the d update, which other rows read) add a fixed latency of a few
// microseconds, which is what bounds small bands (helm_fem: 7 diagonals).
// On the H100 one grid barrier and the read of the blocks' partials through
// L2 cost 1.62-1.69 us however few the blocks (probes/stream_dia_window.py
// floor): helm_fem's phases took 3.38, 2.05 and 1.81 us.
//
// What the design does about it:
//   * a block owns one tile of consecutive rows (ops/stream_cg_dia.py::
//     dia_layout: n over the SM count rounded up to 32, at least 512 rows,
//     so at most one tile an SM) and its threads keep the same rows in
//     every phase; a thread takes kRows rows through each pass of the
//     taps;
//   * the window: at the start of q = A d, after the barrier that ends the
//     d update, the block copies its window of the direction, rows
//     [t0 - pad, t1 + pad) of every RHS and plane, from L2 into shared
//     memory (16-byte cp.async pieces), and the taps read it there, so the
//     direction crosses L2 once an iteration plus the halo (m_t1 at 8 RHS:
//     143 KB a block, 18 MB in all); the x, r and d updates read the
//     block's own d there too.  Where the window passes the block's shared
//     memory (very wide bands at many RHS), the launch reads d from L2
//     (template argument STAGED; the same values, so the choice changes no
//     bits);
//   * the values: each thread copies its rows' values kDepth diagonals
//     ahead into a ring of its own in shared memory (4-byte cp.async), so
//     no value load stalls a pass; the window's copies are in flight beside
//     the first diagonals';
//   * resident state: where a tile is one pass of the threads' rows (m_t1,
//     helm_fem), each thread keeps x, r and q of its rows in registers for
//     the whole solve and writes x once at the end; only d goes to memory,
//     for the next window;
//   * the matrix stays in its own row layout: across a warp, vals[k, i]
//     and d[i + off_k] are consecutive addresses, so every copy is
//     coalesced and the window's reads are free of bank conflicts; the
//     direction sits in a zero-bordered buffer of length n + 2 max|off|,
//     so no read needs a mask at the matrix's ends;
//   * each value is loaded once per iteration and applied to all nb RHS of
//     the launch (the nb-fold value amortisation of _build_dia_batch);
//   * the tap list lives in shared memory, loaded once per launch, so the
//     101 diagonals of the m_t1 class cost no parameter space;
//   * one launch for the whole solve, no host round trip for the scalars;
//   * the tile and the grid depend on n and the SM count only, so a RHS
//     gives the same bits whatever the launch's RHS count, and each row's
//     sum over the taps runs in ascending order;
//   * dot products reduce in a fixed order (thread, warp shuffle, shared
//     memory, then over blocks in block order, the same in every block,
//     from partials stored RHS by RHS so that one warp reads one RHS's in
//     a few coalesced loads), so every block derives bit-identical scalars
//     and reruns agree bit for bit.
// The direction, which other blocks write, is read through L2 alone
// (cp.async.cg, __ldcg) after a grid barrier; values, b and x0 may pass L1.
//
// Cluster mode (template argument CLUSTER).  Where a band is small enough
// that its tiles, their values and their windows fit the shared memory of
// at most kMaxCluster = 16 blocks, the launch is one thread-block cluster of
// C blocks on neighbouring SMs, and no grid barrier is left:
//   * what bounds it: three exchanges an iteration, each a one-way trip
//     over distributed shared memory (DSMEM) and an mbarrier wait.  A
//     cluster barrier with its release fence costs 0.75-0.82 us, and 1.24-
//     1.32 us with a read of the partials over DSMEM after it; a partial
//     pushed by st.async into a slot of every block, completing its bytes
//     on that block's mbarrier, costs 0.60-0.66 us with the block's own
//     reduction (the floor probe, C = 2..16);
//   * the exchanges, which replace the three grid barriers: after q = A d,
//     warp b of every block pushes its <d,q> partial of RHS b into slot
//     [b][block] of every block; after the x, r update the same for
//     <r,r>; after the d update, each thread pushes each of its rows of d
//     into the window of every other block whose window holds that row (a
//     tile's first and last max|off| rows, to one neighbour each where
//     max|off| <= the tile).  Each block waits on its own mbarrier of the
//     exchange for the bytes it expects (C x NB partials; its window's halo
//     rows inside the matrix), then reads locally.  Every push of a kind
//     lands before any block can send the next one of that kind (each
//     block sends it only after it has all of the exchange that follows),
//     so one slot and one mbarrier per kind suffice;
//   * the reduction order: each block sums the C partials of a RHS from
//     its slots in block order, by one warp (lane g holds block g's, then
//     the butterfly), the same in every block, so every block derives
//     bit-identical scalars and reruns agree bit for bit;
//   * the values stay in each block's shared memory for the whole solve,
//     loaded once before r0, and the window of the direction too: a
//     block's own rows are written there by the d update, the halo by the
//     other blocks' pushes; rows outside the matrix stay zero.  Tiles of
//     up to kClusterRows x kThreads rows keep x, r and q in registers;
//   * the fit rule (ops/stream_cg_dia.py::dia_layout): tiles of n over 16
//     blocks rounded up to 32 rows (at least the cooperative tile), with
//     their resident values and windows sized for kMaxRhs = 8 RHS, in a
//     block's shared memory; it never reads the launch's RHS count, so a
//     RHS's bits do not depend on the launch.  The host checks that the
//     card can hold such a cluster (cudaOccupancyMaxActiveClusters), and
//     else runs the cooperative launch;
//   * a batch of more RHS than one cluster takes runs as G clusters side by
//     side in one launch, a grid of (C, G) blocks: cluster y = blockIdx.y
//     owns RHS [y NB, y NB + NB) of the batch's nb_all.  The last cluster
//     may own fewer: its missing RHS read b and x0 as zeros, and their
//     state lands in x, r, q and hist laid out for G NB RHS, of which the
//     host keeps the first nb_all, so no pass of an iteration tests for
//     them (such tests cost 3-15% an iteration on the H100).  No cluster
//     reads another's memory or waits for it, so each RHS gives the bits
//     of its own 1-RHS launch.  The host takes the fewest RHS a cluster
//     whose G clusters the card holds at once (ops/stream_cg_dia.py::
//     cluster_split), so no cluster waits for a second wave.
// wgmma has no place here: there is no matrix product.  TMA bulk copies
// of the values, issued by one thread into a ring the block shares, were
// slower than the threads' own rings (the block waits at a barrier every
// few diagonals).
//
// Numerics: build without --use_fast_math (which would flush denormals to
// zero and move the freeze guards).  Plain C interface, loaded with ctypes
// (tpcg_torch/ops/_build.py); every entry point returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;  // rows a thread takes through one pass of the taps
constexpr int kDepth = 8;  // diagonals of values in flight (4 when complex)
// each thread's ring of values in shared memory: kDepth diagonals (real) or
// kDepth / 2 diagonals of two planes (complex) of its kRows rows
constexpr int kRingFloats = kDepth * kRows * kThreads;
constexpr int kMaxRhs = 8;
constexpr int kMaxDiags = 4096;
constexpr int kLatchIters = 256;  // tpcg/ops/stream_cg_dia.py::_CHUNK
// cluster mode: blocks of the one cluster, and rows a thread takes at once
constexpr int kMaxCluster = 16;
constexpr int kClusterRows = 3;
// cluster mode, ahead of the window: the slots of the partials pushed to a
// block (<d,q> and <r,r>, kMaxRhs RHS x kMaxCluster blocks at most) and its
// mbarriers (the window's halo, <d,q>, <r,r>, and one for alignment)
enum { kHaloBar, kDqBar, kRrBar, kBars = 4 };

struct Params {
  const float* vals;  // (P, ndiag, n)                      read-only
  const int* offs;    // (ndiag)                            read-only
  const float* b;     // (P, nb_all, n)                     read-only
  const float* x0;    // (P, nb_all, n)                     read-only
  float* x;           // (P, span, n)                       out
  float* hist;        // (n_iterations + 1, span)           out
  float* r;           // (P, span, n)                       scratch (null
  float* q;           // (P, span, n)                       where resident)
  float* dpad;        // (P, nb, n + 2 pad)                 scratch (not in
  float2* part_dq;    // (nb, gridDim.x) partials <d,q>     cluster mode)
  float2* part_rr;    // (nb, gridDim.x) partials <r,r>
  int n, ndiag, pad, n_iterations;
  int tile_rows;      // rows of a block's tile (the last tile may be shorter)
  // RHS of the batch in b and x0; x, r, q and hist hold span RHS, gridDim.y
  // nb in cluster mode, else nb = nb_all
  int nb_all;
};

// A block's RHS of the batch: cluster y = blockIdx.y owns RHS [base, base
// + NB) of the state's span = gridDim.y NB (x, r, q, hist), of which those
// below the batch's nb_all are in b and x0 (a short last cluster's missing
// RHS read zeros there).  Cooperative: the launch's NB RHS, constants.
template <int NB, bool CLUSTER>
struct Slice {
  int base, all, span;
  __device__ __forceinline__ explicit Slice(const Params& p)
      : base(CLUSTER ? static_cast<int>(blockIdx.y) * NB : 0),
        all(CLUSTER ? p.nb_all : NB),
        span(CLUSTER ? static_cast<int>(gridDim.y) * NB : NB) {}
  // element i of RHS b (of the slice), plane c, in x, r, q: (P, span, n)
  __device__ __forceinline__ size_t at(int c, int b, int i, int n) const {
    return static_cast<size_t>(c * span + base + b) * n + i;
  }
  // the same in b and x0, (P, all, n), where the RHS is in the batch
  __device__ __forceinline__ size_t at_in(int c, int b, int i, int n) const {
    return static_cast<size_t>(c * all + base + b) * n + i;
  }
  __device__ __forceinline__ bool has(int b) const {
    return !CLUSTER || base + b < all;
  }
};

// Floats a (plane, RHS) row of the window takes: the tile and pad rows each
// side, plus up to 3 floats before it so that its copy starts on 16 bytes,
// rounded up to 16 bytes.
__host__ __device__ __forceinline__ int window_stride(int tile_rows, int pad) {
  return (tile_rows + 2 * pad + 3 + 3) & ~3;
}

// Dynamic shared memory of a launch: the window (staged launches), the
// rings of values, then the tap list; in cluster mode the slots and
// mbarriers, the window, the tile's values, then the tap list.
size_t smem_bytes(int planes, int nb, int tile_rows, int pad, int ndiag,
                  bool staged, bool cluster) {
  const size_t win =
      staged || cluster
          ? static_cast<size_t>(planes) * nb * window_stride(tile_rows, pad)
          : 0;
  if (cluster)
    return 2 * nb * kMaxCluster * sizeof(float2) + kBars * sizeof(uint64_t) +
           (win + static_cast<size_t>(planes) * ndiag * tile_rows + ndiag) * 4;
  return (win + kRingFloats + ndiag) * 4;
}

__device__ __forceinline__ float2 warp_sum(float2 v) {
  // xor butterfly: every lane ends with the same sum
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address in block `rank` of the cluster of a shared-memory address of
// this block (the same variable there).
__device__ __forceinline__ uint32_t peer(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// Stores into another block's shared memory (addresses from peer()), each
// completing its bytes on that block's mbarrier `bar`.
__device__ __forceinline__ void push(uint32_t dst, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(dst),
      "f"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void push(uint32_t dst, float2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];" ::"r"(dst),
      "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Cluster mode: the end of an exchange.  Thread 0 arrives on the block's
// mbarrier of the exchange with the bytes the block expects from the
// pushes; every thread waits for the phase of the given parity to complete
// (trap after ~20 s: a push that never lands is a fault, not a hang), and,
// where block_sync, for the block's own stores too.  Cooperative mode: a
// grid barrier.
template <bool CLUSTER>
__device__ __forceinline__ void exchange(cg::grid_group& grid, uint64_t* bar,
                                         uint32_t bytes, uint32_t parity,
                                         bool block_sync) {
  if constexpr (CLUSTER) {
    const uint32_t a = smem_addr(bar);
    if (threadIdx.x == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(a),
          "r"(bytes)
          : "memory");
    if (!bar_try(a, parity)) {
      const long long t0 = clock64();
      while (!bar_try(a, parity))
        if (clock64() - t0 > (1ll << 35)) __trap();
    }
    if (block_sync) __syncthreads();
  } else {
    grid.sync();
  }
}

// Block-wide sums of acc[0..NB).  Cooperative: block partial of RHS b goes
// to part[b * gridDim.x + blockIdx.x], so that one RHS's partials are
// contiguous.  Cluster: warp b pushes it into slot part[b * kMaxCluster +
// blockIdx.x] of every block of the cluster, completing on its mbarrier
// `bar` (NB x gridDim.x x 8 bytes a block).
template <int NB, bool CLUSTER>
__device__ void block_partials(const float2 (&acc)[NB],
                               float2 (*red)[kMaxRhs], float2* part,
                               uint64_t* bar) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2 v[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) v[b] = warp_sum(acc[b]);
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b) red[warp][b] = v[b];
  }
  __syncthreads();
  if (warp < NB) {
    float2 w = lane < kWarps ? red[lane][warp] : make_float2(0.f, 0.f);
    w = warp_sum(w);
    if constexpr (CLUSTER) {
      if (lane < static_cast<int>(gridDim.x))
        push(peer(smem_addr(part + warp * kMaxCluster + blockIdx.x), lane), w,
             peer(smem_addr(bar), lane));
    } else if (lane == 0) {
      part[static_cast<size_t>(warp) * gridDim.x + blockIdx.x] = w;
    }
  }
  // (cluster mode: red is next written after a __syncthreads of the phase
  // that follows)
  if constexpr (!CLUSTER) __syncthreads();
}

// Sum over blocks of the partials of RHS rhs, by one warp, in a fixed
// order (each lane its blocks in ascending order, then the butterfly).
__device__ float2 grid_total(const float2* part, int nblocks, int rhs) {
  const int lane = threadIdx.x & 31;
  const float2* p = part + static_cast<size_t>(rhs) * nblocks;
  float2 v = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int g = lane; g < nblocks; g += 32) {
    const float2 u = __ldcg(p + g);
    v.x += u.x;
    v.y += u.y;
  }
  return warp_sum(v);
}

// Cluster mode: the sum of the partials of RHS rhs pushed into the block's
// slots, by one warp in block order (lane g holds block g's, then the
// butterfly), the same in every block.
__device__ __forceinline__ float2 cluster_total(const float2* part,
                                                int nblocks, int rhs) {
  const int lane = threadIdx.x & 31;
  return warp_sum(lane < nblocks ? part[rhs * kMaxCluster + lane]
                                 : make_float2(0.f, 0.f));
}

// Smith-scaled complex division a / b (tpcg/ops/stream_cg.py::_smith_cdiv).
__device__ __forceinline__ float2 cdiv_smith(float2 a, float2 b) {
  const float m = fmaxf(fabsf(b.x), fabsf(b.y));
  const float ms = m == 0.f ? 1.f : m;
  const float b0 = b.x / ms, b1 = b.y / ms;
  const float d = (b0 * b0 + b1 * b1) * ms;
  return make_float2((a.x * b0 + a.y * b1) / d, (a.y * b0 - a.x * b1) / d);
}

// The freeze test of one scalar: exact zero (real), |.|^2 == 0 (complex,
// tpcg/ops/stream_cg.py::_mag2_zero).
template <bool CPLX>
__device__ __forceinline__ bool is_zero(float2 v) {
  return CPLX ? v.x * v.x + v.y * v.y == 0.f : v.x == 0.f;
}

template <bool CPLX>
__device__ __forceinline__ float2 div_scalar(float2 a, float2 b) {
  return CPLX ? cdiv_smith(a, b) : make_float2(a.x / b.x, 0.f);
}

template <bool CPLX>
__device__ __forceinline__ float hist_of(float2 dl) {
  return CPLX ? sqrtf(sqrtf(dl.x * dl.x + dl.y * dl.y)) : sqrtf(dl.x);
}

// A direction value: from the block's window in shared memory, or from L2
// (other blocks wrote it before the last grid barrier).
template <bool STAGED>
__device__ __forceinline__ float dir(const float* p) {
  return STAGED ? *p : __ldcg(p);
}

// cp.async of 4 bytes into shared memory (the values, which nothing writes
// during the solve, so L1 may hold them).
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// cp.async of 16 bytes into shared memory through L2 alone (the direction,
// which other blocks wrote before the last grid barrier).
__device__ __forceinline__ void copy16_l2(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Where a block's rows sit: the window holds padded-buffer indices
// [cb pn + t0 - s, cb pn + t1 + 2 pad) of each (plane, RHS) cb from float
// cb ws of the window, s = (cb pn + t0) mod 4 floats early so that its copy
// starts on 16 bytes.  win_base(cb) + i is row i's index in the window.
//
// Cluster mode: no shift (nothing is copied), so row i of (plane, RHS) cb
// sits at float cb ws + pad + i - t0 in every block's window of row i.
struct Tile {
  int t0, t1;  // the block's rows [t0, t1)
  int ws;      // window_stride
  size_t pn;   // n + 2 pad
  int pad;
  bool shift;  // false in cluster mode
  __device__ __forceinline__ int win_base(int cb) const {
    return cb * ws + (shift ? static_cast<int>((cb * pn + t0) & 3) : 0) - t0 +
           pad;
  }
};

// Cluster mode: push row i of the block's tile, v[c][b] of each plane c and
// RHS b, into the window of every other block whose window holds row i
// (blocks lo..hi, tiles of T rows), completing on each one's halo mbarrier.
template <int P, int NB>
__device__ __forceinline__ void publish_row(const float* win, const Tile& t,
                                            int T, int nblocks, int i,
                                            const float (&v)[P][NB],
                                            uint64_t* bar) {
  const int lo = i >= t.pad ? (i - t.pad) / T : 0;
  const int hi = min(nblocks - 1, (i + t.pad) / T);
  if (lo == hi) return;  // no other block's window
  const uint32_t w = smem_addr(win), b = smem_addr(bar);
  for (int c = lo; c <= hi; ++c) {
    if (c == static_cast<int>(blockIdx.x)) continue;
    const uint32_t row = peer(w, c) + 4u * (i - c * T + t.pad);
    const uint32_t cbar = peer(b, c);
#pragma unroll
    for (int pc = 0; pc < P; ++pc) {
#pragma unroll
      for (int r = 0; r < NB; ++r)
        push(row + 4u * (pc * NB + r) * t.ws, v[pc][r], cbar);
    }
  }
}

// Issue the copies of the block's window of the direction, every RHS and
// plane: rows [t0 - pad, t1 + pad), padded-buffer indices [t0, t1 + 2 pad)
// (the zero border covers the matrix's ends), in aligned 16-byte pieces
// (dpad carries 4 floats of slack past its end).
template <int PNB>
__device__ __forceinline__ void issue_window(const float* dpad, const Tile& t,
                                             float* win) {
  const int len = t.t1 - t.t0 + 2 * t.pad;
#pragma unroll
  for (int cb = 0; cb < PNB; ++cb) {
    const size_t g0 = cb * t.pn + t.t0;
    const int s = static_cast<int>(g0 & 3);
    const float* src = dpad + (g0 - s);
    float* dst = win + cb * t.ws;
    for (int e = 4 * threadIdx.x; e < len + s; e += 4 * kThreads)
      copy16_l2(dst + e, src + e);
  }
}

// Issue the copies of diagonal k's values of rows i0 + j kThreads, j < nr,
// into slot k % D of the thread's ring, as one cp.async group (empty past
// the last diagonal).  Slot layout: (plane c, row j) at
// ring[(((k % D) * P + c) * kRows + j) * kThreads + threadIdx.x].
template <bool CPLX>
__device__ __forceinline__ void issue_values(const Params& p, float* ring,
                                             int i0, int nr, int k) {
  constexpr int P = CPLX ? 2 : 1;
  constexpr int D = kDepth / P;
  if (k < p.ndiag) {
    float* slot = ring + (k % D) * P * kRows * kThreads + threadIdx.x;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const float* v = p.vals + static_cast<size_t>(c * p.ndiag + k) * p.n + i0;
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (j < nr) copy4(slot + (c * kRows + j) * kThreads, v + j * kThreads);
    }
  }
  copy_commit();
}

// (A d) of rows i0 + j kThreads, j < nr <= R, for the NB RHS, each row's
// sum over the taps in ascending order.  w[cb] points at row i0 of (plane,
// RHS) cb of the direction, in the window (STAGED, CLUSTER) or in the
// padded buffer.  Cooperative: the values reach the thread's ring in
// shared memory D - 1 diagonals ahead of their use, by cp.async, so the
// loop waits on nothing but the oldest copy; primed: the first D - 1
// diagonals were issued already.  Cluster: vals points at row i0 of the
// tile's resident values (diagonal k of plane c T (c ndiag + k) floats on).
template <bool CPLX, int NB, bool STAGED, bool CLUSTER, int R>
__device__ __forceinline__ void apply_rows(const Params& p, const int* s_off,
                                           int i0, int nr, bool primed,
                                           const float* (&w)[NB * 2],
                                           float* ring, const float* vals,
                                           float (&qr)[R][NB],
                                           float (&qi)[R][NB]) {
  constexpr int P = CPLX ? 2 : 1;
  constexpr int D = kDepth / P;
  const int ndiag = p.ndiag;
  const int T = p.tile_rows;
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int b = 0; b < NB; ++b) qr[j][b] = qi[j][b] = 0.f;
  }
  if (!CLUSTER && !primed) {
#pragma unroll 1
    for (int k = 0; k < D - 1; ++k) issue_values<CPLX>(p, ring, i0, nr, k);
  }
  const float* mine = ring + threadIdx.x;
#pragma unroll 2
  for (int k = 0; k < ndiag; ++k) {
    if constexpr (!CLUSTER) {
      issue_values<CPLX>(p, ring, i0, nr, k + D - 1);
      copy_wait<D - 1>();
    }
    const int off = s_off[k];
    const float* slot = CLUSTER ? vals + static_cast<size_t>(k) * T
                                : mine + (k % D) * P * kRows * kThreads;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j < nr) {
        const int o = j * kThreads + off;
        const float vr = slot[j * kThreads];
        if (CPLX) {
          const float vi =
              CLUSTER ? slot[static_cast<size_t>(ndiag) * T + j * kThreads]
                      : slot[(kRows + j) * kThreads];
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const float wr = dir<STAGED || CLUSTER>(w[b] + o);
            const float wi = dir<STAGED || CLUSTER>(w[NB + b] + o);
            qr[j][b] = qr[j][b] + vr * wr - vi * wi;
            qi[j][b] = qi[j][b] + vr * wi + vi * wr;
          }
        } else {
#pragma unroll
          for (int b = 0; b < NB; ++b)
            qr[j][b] = qr[j][b] + vr * dir<STAGED || CLUSTER>(w[b] + o);
        }
      }
    }
  }
  if constexpr (!CLUSTER) copy_wait<0>();
}

// q = A d over the block's tile and the partials of <d, q> (STORE_Q) or
// r = b - A d and the partials of <r, r>; the direction in dpad, staged
// into the window first where STAGED, its copies in flight beside the
// first diagonals' values; in cluster mode already whole in the window.
// A missing RHS of the slice reads b as 0.
template <bool CPLX, int NB, bool STAGED, bool CLUSTER, int R, bool STORE_Q>
__device__ __forceinline__ void apply_tile(
    const Params& p, const int* s_off, float* win, float* ring,
    const float* vals, const Tile& t, bool resident,
    const Slice<NB, CLUSTER>& rhs,
    float (&rs)[R][CPLX ? 2 : 1][NB], float (&qs)[R][CPLX ? 2 : 1][NB],
    float2 (&acc)[NB]) {
  constexpr int P = CPLX ? 2 : 1;
  constexpr int D = kDepth / P;
  const int n = p.n;
  const int first = t.t0 + threadIdx.x;
  if constexpr (!CLUSTER) {
    const int nr0 =
        first < t.t1 ? min(kRows, (t.t1 - first + kThreads - 1) / kThreads)
                     : 0;
    if (STAGED) issue_window<P * NB>(p.dpad, t, win);
    copy_commit();
#pragma unroll 1
    for (int k = 0; k < D - 1; ++k)
      issue_values<CPLX>(p, ring, first, nr0, k);
    copy_wait<D - 1>();  // the window's group, the oldest
    __syncthreads();
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = make_float2(0.f, 0.f);
  for (int i0 = first; i0 < t.t1; i0 += R * kThreads) {
    const int nr = min(R, (t.t1 - i0 + kThreads - 1) / kThreads);
    const float* w[NB * 2];
#pragma unroll
    for (int cb = 0; cb < NB * 2; ++cb)
      w[cb] = cb >= P * NB        ? nullptr
              : STAGED || CLUSTER ? win + t.win_base(cb) + i0
                                  : p.dpad + cb * t.pn + t.pad + i0;
    float qr[R][NB], qi[R][NB];
    apply_rows<CPLX, NB, STAGED, CLUSTER, R>(p, s_off, i0, nr, i0 == first, w,
                                             ring, vals + (i0 - t.t0), qr,
                                             qi);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j < nr) {
        const int i = i0 + j * kThreads;
        const int o = j * kThreads;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const size_t ir = rhs.at(0, b, i, n);
          const size_t ii = rhs.at(1, b, i, n);
          if (STORE_Q) {
            const float dr = dir<STAGED || CLUSTER>(w[b] + o);
            qs[j][0][b] = qr[j][b];
            if (!resident) p.q[ir] = qr[j][b];
            if (CPLX) {
              const float di = dir<STAGED || CLUSTER>(w[NB + b] + o);
              qs[j][P - 1][b] = qi[j][b];
              if (!resident) p.q[ii] = qi[j][b];
              acc[b].x += dr * qr[j][b] - di * qi[j][b];
              acc[b].y += dr * qi[j][b] + di * qr[j][b];
            } else {
              acc[b].x += dr * qr[j][b];
            }
          } else {
            const bool in = rhs.has(b);
            const float rr =
                (in ? __ldg(p.b + rhs.at_in(0, b, i, n)) : 0.f) - qr[j][b];
            rs[j][0][b] = rr;
            if (!resident) p.r[ir] = rr;
            if (CPLX) {
              const float ri =
                  (in ? __ldg(p.b + rhs.at_in(1, b, i, n)) : 0.f) - qi[j][b];
              rs[j][P - 1][b] = ri;
              if (!resident) p.r[ii] = ri;
              acc[b].x += rr * rr - ri * ri;
              acc[b].y += rr * ri;
            } else {
              acc[b].x += rr * rr;
            }
          }
        }
      }
    }
  }
}

template <bool CPLX, int NB, bool STAGED, bool CLUSTER>
__global__ void __launch_bounds__(kThreads, 1) stream_dia_kernel(Params p) {
  constexpr int P = CPLX ? 2 : 1;
  // rows a thread takes through one pass of the taps
  constexpr int R = CLUSTER ? kClusterRows : kRows;
  // rows a thread loads at once in the x, r and d passes: its R rows of
  // q = A d, where their state fits the registers
  constexpr int G = P * NB * R <= 8 * kRows ? R : 1;
  cg::grid_group grid = cg::this_grid();  // (synced only when cooperative)
  // cooperative: the window (STAGED), the rings of values, the ndiag tap
  // offsets; cluster: the slots of the partials, the mbarriers, the
  // window, the tile's values, the tap offsets
  extern __shared__ __align__(16) float smem[];
  __shared__ float2 red[kWarps][kMaxRhs];
  __shared__ float2 s_delta[NB];
  __shared__ float2 s_alpha[NB];
  __shared__ float2 s_beta[NB];
  __shared__ int s_done[NB];

  const int n = p.n, pad = p.pad;
  const size_t pn = static_cast<size_t>(n) + 2 * pad;
  const int nblocks = gridDim.x;
  const Slice<NB, CLUSTER> rhs(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the block's tile of rows [t0, t1); its window rows [t0 - pad, t1 + pad)
  Tile tile;
  tile.t0 = blockIdx.x * p.tile_rows;
  tile.t1 = min(n, tile.t0 + p.tile_rows);
  tile.ws = window_stride(p.tile_rows, pad);
  tile.pn = pn;
  tile.pad = pad;
  tile.shift = !CLUSTER;
  const int t0 = tile.t0, t1 = tile.t1;
  float2* slot_dq = reinterpret_cast<float2*>(smem);
  float2* slot_rr = slot_dq + NB * kMaxCluster;
  uint64_t* bars = reinterpret_cast<uint64_t*>(slot_rr + NB * kMaxCluster);
  float* win = CLUSTER ? reinterpret_cast<float*>(bars + kBars) : smem;
  float* ring = smem + (STAGED ? P * NB * tile.ws : 0);
  float* vals = win + P * NB * tile.ws;
  int* s_off = reinterpret_cast<int*>(
      CLUSTER ? vals + static_cast<size_t>(P) * p.ndiag * p.tile_rows
              : ring + kRingFloats);
  // cluster mode: bytes each block expects from an exchange of partials and
  // of its window's halo rows inside the matrix
  const uint32_t part_bytes = NB * nblocks * sizeof(float2);
  const uint32_t halo_bytes =
      (min(pad, t0) + min(pad, n - t1)) * P * NB * sizeof(float);
  // element i of RHS b, plane c: in x, r, q and in dpad
  auto at = [&](int c, int b, int i) { return rhs.at(c, b, i, n); };
  auto pad_at = [&](int c, int b, int i) {
    return static_cast<size_t>(c * NB + b) * pn + pad + i;
  };
  // d of one of the block's rows: from the window (filled this iteration)
  // or from L2
  auto d_at = [&](int c, int b, int i) {
    return STAGED || CLUSTER ? win[tile.win_base(c * NB + b) + i]
                             : __ldcg(p.dpad + pad_at(c, b, i));
  };
  // a new direction (or x0) of one of the block's rows: to the padded
  // buffer, or (cluster mode) to the window, whence publish() pushes the
  // thread's rows into the other blocks' windows
  auto store_d = [&](int c, int b, int i, float v) {
    if (CLUSTER)
      win[tile.win_base(c * NB + b) + i] = v;
    else
      p.dpad[pad_at(c, b, i)] = v;
  };
  auto publish = [&](int i0, int nr) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < nr) {
        const int i = i0 + j * kThreads;
        float v[P][NB];
#pragma unroll
        for (int c = 0; c < P; ++c) {
#pragma unroll
          for (int b = 0; b < NB; ++b)
            v[c][b] = win[tile.win_base(c * NB + b) + i];
        }
        publish_row<P, NB>(win, tile, p.tile_rows, nblocks, i, v,
                           bars + kHaloBar);
      }
    }
  };
  // Resident: the tile is one pass of the threads' G = R rows, so each
  // thread keeps x, r and q of its rows in registers for the whole solve
  // (xs, rs, qs) and writes x once at the end; else they are the
  // registers of one pass, loaded and stored every phase.
  const bool resident = G == R && p.tile_rows <= R * kThreads;
  float xs[R][P][NB], rs[R][P][NB], qs[R][P][NB];
  const int first = t0 + threadIdx.x;
  auto rows_at = [&](int i0) {
    return min(G, (t1 - i0 + kThreads - 1) / kThreads);
  };

  // 1. taps to shared memory; zero the padded direction buffer, whose
  //    border stays zero for the whole solve.  Cluster: zero the window
  //    (its rows outside the matrix stay zero), load the tile's values and
  //    set up the mbarriers before any block pushes.
  for (int k = threadIdx.x; k < p.ndiag; k += kThreads) s_off[k] = p.offs[k];
  if (threadIdx.x < NB) s_done[threadIdx.x] = 0;
  if constexpr (CLUSTER) {
    const int T = p.tile_rows;
    for (int e = threadIdx.x; e < P * NB * tile.ws; e += kThreads)
      win[e] = 0.f;
    for (int e = threadIdx.x; e < P * p.ndiag * T; e += kThreads) {
      const int ck = e / T, i = t0 + e - ck * T;
      vals[e] = i < n ? __ldg(p.vals + static_cast<size_t>(ck) * n + i) : 0.f;
    }
    if (threadIdx.x == 0) {
      for (int k = 0; k < kBars; ++k)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         smem_addr(bars + k))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cg::this_cluster().sync();
  } else {
    for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
         e < static_cast<size_t>(P) * NB * pn;
         e += static_cast<size_t>(nblocks) * kThreads)
      p.dpad[e] = 0.f;
    cg::this_grid().sync();
  }

  // 2. x = x0, staged through the padded buffer (the windows) for A x0.
  for (int i0 = first; i0 < t1; i0 += G * kThreads) {
    const int nr = rows_at(i0);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < nr) {
        const int i = i0 + j * kThreads;
#pragma unroll
        for (int c = 0; c < P; ++c) {
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const float v =
                rhs.has(b) ? __ldg(p.x0 + rhs.at_in(c, b, i, n)) : 0.f;
            xs[j][c][b] = v;
            if (!resident) p.x[at(c, b, i)] = v;
            store_d(c, b, i, v);
          }
        }
      }
    }
    if constexpr (CLUSTER) publish(i0, nr);
  }
  exchange<CLUSTER>(grid, bars + kHaloBar, halo_bytes, 0, true);

  // 3. r0 = b - A x0 and the partials of <r0, r0>.
  {
    float2 acc[NB];
    apply_tile<CPLX, NB, STAGED, CLUSTER, R, false>(
        p, s_off, win, ring, vals, tile, resident, rhs, rs, qs, acc);
    block_partials<NB, CLUSTER>(acc, red, CLUSTER ? slot_rr : p.part_rr,
                                bars + kRrBar);
  }
  exchange<CLUSTER>(grid, bars + kRrBar, part_bytes, 0, false);

  // 4. delta0 and hist[0]; d0 = r0 (every block is past its reads of x0).
  if (warp < NB) {
    const float2 t = CLUSTER ? cluster_total(slot_rr, nblocks, warp)
                             : grid_total(p.part_rr, nblocks, warp);
    if (lane == 0) {
      const float2 dl = make_float2(t.x, CPLX ? 2.f * t.y : 0.f);
      s_delta[warp] = dl;
      if (blockIdx.x == 0) p.hist[rhs.base + warp] = hist_of<CPLX>(dl);
    }
  }
  for (int i0 = first; i0 < t1; i0 += G * kThreads) {
    const int nr = rows_at(i0);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < nr) {
        const int i = i0 + j * kThreads;
#pragma unroll
        for (int c = 0; c < P; ++c) {
#pragma unroll
          for (int b = 0; b < NB; ++b)
            store_d(c, b, i, resident ? rs[j][c][b] : p.r[at(c, b, i)]);
        }
      }
    }
    if constexpr (CLUSTER) publish(i0, nr);
  }
  exchange<CLUSTER>(grid, bars + kHaloBar, halo_bytes, 1, true);

  for (int it = 0; it < p.n_iterations; ++it) {
    // phase 1: the window of d, q = A d and the partials of <d, q>.
    {
      float2 acc[NB];
      apply_tile<CPLX, NB, STAGED, CLUSTER, R, true>(
          p, s_off, win, ring, vals, tile, resident, rhs, rs, qs, acc);
      block_partials<NB, CLUSTER>(acc, red, CLUSTER ? slot_dq : p.part_dq,
                                  bars + kDqBar);
    }
    exchange<CLUSTER>(grid, bars + kDqBar, part_bytes, it & 1, false);

    // phase 2: alpha (bit-identical in every block), x += alpha d,
    // r -= alpha q, and the partials of <r, r>.
    if (warp < NB) {
      const float2 dq = CLUSTER ? cluster_total(slot_dq, nblocks, warp)
                                : grid_total(p.part_dq, nblocks, warp);
      if (lane == 0) {
        const float2 dl = s_delta[warp];
        const int done = (s_done[warp] && it % kLatchIters != 0) ||
                         is_zero<CPLX>(dl) || is_zero<CPLX>(dq);
        s_done[warp] = done;
        s_alpha[warp] =
            done ? make_float2(0.f, 0.f) : div_scalar<CPLX>(dl, dq);
      }
    }
    __syncthreads();
    {
      float2 acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = make_float2(0.f, 0.f);
      for (int i0 = first; i0 < t1; i0 += G * kThreads) {
        // every load of the thread's G rows first: the stores below may
        // alias them for all the compiler knows, and would hold each RHS's
        // loads back
        const int nr = rows_at(i0);
        float dv[G][P][NB];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j < nr) {
            const int i = i0 + j * kThreads;
#pragma unroll
            for (int c = 0; c < P; ++c) {
#pragma unroll
              for (int b = 0; b < NB; ++b) {
                dv[j][c][b] = d_at(c, b, i);
                if (!resident) {
                  xs[j][c][b] = p.x[at(c, b, i)];
                  rs[j][c][b] = p.r[at(c, b, i)];
                  qs[j][c][b] = p.q[at(c, b, i)];
                }
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j < nr) {
            const int i = i0 + j * kThreads;
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              const float2 a = s_alpha[b];
              const float dr = dv[j][0][b];
              if (CPLX) {
                const float di = dv[j][P - 1][b];
                const float qr = qs[j][0][b], qi = qs[j][P - 1][b];
                const float xr = xs[j][0][b], xi = xs[j][P - 1][b];
                xs[j][0][b] = xr + a.x * dr - a.y * di;
                xs[j][P - 1][b] = xi + a.x * di + a.y * dr;
                const float rr = rs[j][0][b] - (a.x * qr - a.y * qi);
                const float ri = rs[j][P - 1][b] - (a.x * qi + a.y * qr);
                rs[j][0][b] = rr;
                rs[j][P - 1][b] = ri;
                acc[b].x += rr * rr - ri * ri;
                acc[b].y += rr * ri;
              } else {
                xs[j][0][b] = xs[j][0][b] + a.x * dr;
                const float rr = rs[j][0][b] - a.x * qs[j][0][b];
                rs[j][0][b] = rr;
                acc[b].x += rr * rr;
              }
              if (!resident) {
#pragma unroll
                for (int c = 0; c < P; ++c) {
                  p.x[at(c, b, i)] = xs[j][c][b];
                  p.r[at(c, b, i)] = rs[j][c][b];
                }
              }
            }
          }
        }
      }
      block_partials<NB, CLUSTER>(acc, red, CLUSTER ? slot_rr : p.part_rr,
                                  bars + kRrBar);
    }
    exchange<CLUSTER>(grid, bars + kRrBar, part_bytes, (it + 1) & 1, false);

    // phase 3: beta, delta (held while frozen), hist[it+1], d = r + beta d.
    if (warp < NB) {
      const float2 t = CLUSTER ? cluster_total(slot_rr, nblocks, warp)
                               : grid_total(p.part_rr, nblocks, warp);
      if (lane == 0) {
        const float2 dn = make_float2(t.x, CPLX ? 2.f * t.y : 0.f);
        const float2 dl = s_delta[warp];
        const int done = s_done[warp];
        s_beta[warp] = done ? make_float2(0.f, 0.f) : div_scalar<CPLX>(dn, dl);
        const float2 keep = done ? dl : dn;
        s_delta[warp] = keep;
        if (blockIdx.x == 0)
          p.hist[static_cast<size_t>(it + 1) * rhs.span + rhs.base + warp] =
              hist_of<CPLX>(keep);
      }
    }
    __syncthreads();
    for (int i0 = first; i0 < t1; i0 += G * kThreads) {
      const int nr = rows_at(i0);
      float dv[G][P][NB];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j < nr) {
          const int i = i0 + j * kThreads;
#pragma unroll
          for (int c = 0; c < P; ++c) {
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              dv[j][c][b] = d_at(c, b, i);
              if (!resident) rs[j][c][b] = p.r[at(c, b, i)];
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j < nr) {
          const int i = i0 + j * kThreads;
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const float2 be = s_beta[b];
            const float dr = dv[j][0][b];
            if (CPLX) {
              const float di = dv[j][P - 1][b];
              store_d(0, b, i, rs[j][0][b] + be.x * dr - be.y * di);
              store_d(P - 1, b, i, rs[j][P - 1][b] + be.x * di + be.y * dr);
            } else {
              store_d(0, b, i, rs[j][0][b] + be.x * dr);
            }
          }
        }
      }
      if constexpr (CLUSTER) publish(i0, nr);
    }
    exchange<CLUSTER>(grid, bars + kHaloBar, halo_bytes, it & 1, true);
  }

  // 5. x out, where it stayed in registers.
  if (resident && first < t1) {
    const int nr = rows_at(first);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < nr) {
#pragma unroll
        for (int c = 0; c < P; ++c) {
#pragma unroll
          for (int b = 0; b < NB; ++b)
            p.x[at(c, b, first + j * kThreads)] = xs[j][c][b];
        }
      }
    }
  }
  // cluster mode: no block leaves while another may still push to it
  if constexpr (CLUSTER) cg::this_cluster().sync();
}

using KernelFn = void (*)(Params);

template <bool CPLX, bool STAGED, bool CLUSTER>
KernelFn pick(int nb) {
  switch (nb) {
    case 1: return stream_dia_kernel<CPLX, 1, STAGED, CLUSTER>;
    case 2: return stream_dia_kernel<CPLX, 2, STAGED, CLUSTER>;
    case 3: return stream_dia_kernel<CPLX, 3, STAGED, CLUSTER>;
    case 4: return stream_dia_kernel<CPLX, 4, STAGED, CLUSTER>;
    case 5: return stream_dia_kernel<CPLX, 5, STAGED, CLUSTER>;
    case 6: return stream_dia_kernel<CPLX, 6, STAGED, CLUSTER>;
    case 7: return stream_dia_kernel<CPLX, 7, STAGED, CLUSTER>;
    case 8: return stream_dia_kernel<CPLX, 8, STAGED, CLUSTER>;
    default: return nullptr;
  }
}

// cluster mode has its window in shared memory always (no STAGED choice)
KernelFn kernel_for(int cplx, int nb, int staged, int cluster) {
  if (cluster)
    return cplx ? pick<true, false, true>(nb) : pick<false, false, true>(nb);
  if (cplx)
    return staged ? pick<true, true, false>(nb) : pick<true, false, false>(nb);
  return staged ? pick<false, true, false>(nb) : pick<false, false, false>(nb);
}

// The instance of a launch, with its dynamic shared memory allowed: null
// where the arguments are out of range or the memory passes the block's.
// cluster: blocks of the one cluster (the launch's tiles), or 0.
cudaError_t instance(int cplx, int nb, int n, int ndiag, int pad,
                     int tile_rows, int staged, int cluster, KernelFn* fn,
                     size_t* smem) {
  *fn = kernel_for(cplx, nb, staged, cluster);
  if (*fn == nullptr || n < 1 || ndiag < 1 || ndiag > kMaxDiags || pad < 0 ||
      tile_rows < 1 || cluster < 0 || cluster > kMaxCluster ||
      (cluster && (staged || cluster != (n + tile_rows - 1) / tile_rows)))
    return cudaErrorInvalidValue;
  *smem = smem_bytes(cplx ? 2 : 1, nb, tile_rows, pad, ndiag, staged != 0,
                     cluster != 0);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(*fn));
  if (err != cudaSuccess) return err;
  if (*smem + attr.sharedSizeBytes > static_cast<size_t>(optin))
    return cudaErrorInvalidValue;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(*fn),
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(*fn),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

// A cluster launch of `clusters` clusters of `cluster` blocks side by side.
cudaLaunchConfig_t cluster_config(int cluster, int clusters, size_t smem,
                                  void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Kernel limits: RHS per launch, diagonals per matrix.
int tpcg_stream_dia_limits(int* max_rhs, int* max_diags) {
  *max_rhs = kMaxRhs;
  *max_diags = kMaxDiags;
  return 0;
}

// Grid of a launch on the current device: one block per tile of tile_rows
// rows, every block co-resident (a larger cooperative launch is refused).
// staged: the window's shared memory must fit the block's, or the call
// returns cudaErrorInvalidValue.  cluster (the tiles' count, at most 16):
// the launch as clusters of that many blocks, whose shared memory must fit
// the same way; clusters_out: how many clusters of the nb-RHS instance the
// card holds at once (cudaOccupancyMaxActiveClusters), and grid 0 where it
// holds none, and the caller takes the cooperative layout.  (Cooperative:
// clusters_out 0.)
int tpcg_stream_dia_grid(int cplx, int nb, int n, int ndiag, int pad,
                         int tile_rows, int staged, int cluster,
                         int* grid_out, int* clusters_out) {
  KernelFn fn = nullptr;
  size_t smem = 0;
  cudaError_t err = instance(cplx, nb, n, ndiag, pad, tile_rows, staged,
                             cluster, &fn, &smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int g = (n + tile_rows - 1) / tile_rows;
  *clusters_out = 0;
  if (cluster) {
    int launch = 0, active = 0;
    err = cudaDeviceGetAttribute(&launch, cudaDevAttrClusterLaunch, dev);
    if (err != cudaSuccess) return err;
    if (launch) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = cluster_config(cluster, 1, smem, nullptr,
                                                    &attr);
      err = cudaOccupancyMaxActiveClusters(
          &active, reinterpret_cast<const void*>(fn), &cfg);
      if (err != cudaSuccess) return err;
    }
    *grid_out = active >= 1 ? g : 0;
    *clusters_out = active;
    return 0;
  }
  int sms = 0, coop = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || g > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  *grid_out = g;
  return 0;
}

// vals: (cplx ? 2 : 1, ndiag, n); offs: device array of ndiag ints with
// |offs[k]| <= pad; b, x0: (cplx ? 2 : 1, nb_all, n); x, r, q:
// (cplx ? 2 : 1, clusters nb, n); dpad: (cplx ? 2 : 1, nb, n + 2 pad) and
// 4 floats of slack; hist: (n_iterations + 1, clusters nb), of which the
// first nb_all RHS are the batch's; part_dq and part_rr: grid * nb * 2 floats
// each, 8-byte aligned (dpad, part_dq and part_rr unused, and may be null,
// in cluster mode; r and q too where every tile is resident).  tile_rows,
// staged, cluster: the layout of ops/stream_cg_dia.py::dia_layout; grid:
// from tpcg_stream_dia_grid with the same layout.  clusters: cluster mode's
// clusters side by side, nb RHS each (the last may have fewer), for the
// nb_all RHS of the batch, at most the count tpcg_stream_dia_grid gave;
// cooperative: 1, and nb_all = nb.
int tpcg_stream_dia(int cplx, const float* vals, const int* offs,
                    const float* b, const float* x0, float* x, float* hist,
                    float* r, float* q, float* dpad, float* part_dq,
                    float* part_rr, int n, int ndiag, int nb, int pad,
                    int n_iterations, int tile_rows, int staged, int cluster,
                    int grid, int clusters, int nb_all, void* stream) {
  KernelFn fn = nullptr;
  size_t smem = 0;
  cudaError_t err = instance(cplx, nb, n, ndiag, pad, tile_rows, staged,
                             cluster, &fn, &smem);
  if (err != cudaSuccess) return err;
  if (n_iterations < 0 || grid != (n + tile_rows - 1) / tile_rows ||
      clusters < 1 || nb_all <= (clusters - 1) * nb ||
      nb_all > clusters * nb ||
      (!cluster && (clusters != 1 || nb_all != nb)))
    return cudaErrorInvalidValue;
  Params p;
  p.vals = vals;
  p.offs = offs;
  p.b = b;
  p.x0 = x0;
  p.x = x;
  p.hist = hist;
  p.r = r;
  p.q = q;
  p.dpad = dpad;
  p.part_dq = reinterpret_cast<float2*>(part_dq);
  p.part_rr = reinterpret_cast<float2*>(part_rr);
  p.n = n;
  p.ndiag = ndiag;
  p.pad = pad;
  p.n_iterations = n_iterations;
  p.tile_rows = tile_rows;
  p.nb_all = nb_all;
  void* args[] = {&p};
  if (cluster) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(cluster, clusters, smem,
                                                  stream, &attr);
    err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(fn), args);
  } else {
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                      dim3(grid), dim3(kThreads), args, smem,
                                      static_cast<cudaStream_t>(stream));
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
