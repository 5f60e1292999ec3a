// EX: the local model's select, float32, for sm_90a.
//
// Replaces the reference's local-model extraction,
// tpu_icp_slam/mapping/voxel_map.py::extract_local (:204-253): d² of every
// map slot to the centre, lax.top_k(-d², size) (ties to the lower index),
// the validity and radius gate, the coverage radius, and the argsort of the
// kept rows back into map order (XLA ops, no Pallas kernel). The port's
// torch form of it (mapping/voxel_map.py::extract_local_ref) sorts all C
// d² and then the selection again: ~290 kernels every extracting frame.
//
// What bounds it on an H100: its bytes, then its launches. At C = 131,072
// slots and size = 16,384 it reads 1.7 MB (points and mask, and the
// selected rows' normals) and writes 0.4 MB: ~0.6 us at 3.35 TB/s, less
// than one launch; so it is four launches, each a pass over the slots.
//
// Design: a radix select of the size-th smallest d² on its bit pattern
// (d² >= 0, so the unsigned order of the bits is the float order; a slot
// off the mask is +inf, a NaN one canonical NaN above it), then one pass
// in map order.
//  - ex_keys_kernel: d² as the plain version and the reference's CPU sum
//    round it, (dx*dx + dy*dy) + dz*dz with diff = point - centre; the
//    keys, the count of the mask, and a histogram of key bits 30..20.
//  - ex_refine_kernel: the histogram of bits 19..9 among the keys in the
//    bucket that holds the size-th key.
//  - ex_count_kernel: each block's count below the 22-bit bucket, its
//    cumulative histogram of bits 8..0 inside it (and the histogram summed
//    over the blocks), its count and largest key at or under the gate
//    (finite, and <= radius² when radius > 0).
//  - Each of the three ends in the last block to finish (a ticket): it
//    picks the bucket (then the key T) that holds the size-th key, and the
//    third's also the rows each block keeps, their offsets in the output,
//    the ties at T each block may take (the first size - #(< T) in index
//    order), and r_cover. It clears what the next call counts into, so the
//    scratch stays ready and no memset is launched.
//  - ex_write_kernel: each block scans its slots in index order (a thread
//    four consecutive slots) and writes its kept rows at its offset; rows
//    from the count of kept rows to size are padding (PAD_COORD, 0,
//    false), which is where the torch version's second sort leaves them.
//  The kept rows are the selected rows with d² at or under the gate: the
//  rows of lax.top_k that the mask keeps, in map order, so pts, nrm, msk
//  and r_cover equal the torch version's bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                       // slots a thread
constexpr int kChunk = kThreads * kPer;       // slots a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kInfKey = 0x7f800000u;
constexpr unsigned kNanKey = 0x7fc00000u;
constexpr unsigned kMaxFinite = 0x7f7fffffu;
constexpr int kBins1 = 2048;  // key bits 30..20
constexpr int kBins2 = 2048;  // bits 19..9
constexpr int kBins3 = 512;   // bits 8..0
constexpr float kPad = 1e6f;  // mapping/voxel_map.py's PAD_COORD

// The state a call's launches hand on (unsigned words of the scratch).
enum State {
  kTicket1, kTicket2, kTicket3, kNMask, kBucket1, kRank1, kPrefix, kRank2,
  kT, kNKept, kStateWords
};

__device__ __forceinline__ unsigned ld(const unsigned* p) { return __ldcg(p); }

// Exclusive scan of v over the block; *total gets the block's sum.
__device__ unsigned block_scan(unsigned v, unsigned* total) {
  __shared__ unsigned warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < kWarps ? warp_sum[lane] : 0u;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sum[lane] = w;
  }
  __syncthreads();
  const unsigned before = warp ? warp_sum[warp - 1] : 0u;
  *total = warp_sum[kWarps - 1];
  __syncthreads();  // warp_sum is free for the next scan
  return before + x - v;
}

// True in the last block of the grid to get here (every block's writes
// before the call are visible to it).
__device__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// In the histogram h (bins, in shared memory), the bin that holds the
// rank-th key (rank >= 1) and the key's rank inside it; the whole block
// calls it.
__device__ void find_rank(const unsigned* h, int bins, unsigned rank,
                          unsigned* bin, unsigned* within) {
  const int per = bins / kThreads;
  unsigned sum = 0;
  for (int i = 0; i < per; ++i) sum += h[threadIdx.x * per + i];
  unsigned total;
  unsigned before = block_scan(sum, &total);
  if (before < rank && rank <= before + sum) {
    for (int i = 0; i < per; ++i) {
      const unsigned c = h[threadIdx.x * per + i];
      if (rank <= before + c) {
        *bin = threadIdx.x * per + i;
        *within = rank - before;
        break;
      }
      before += c;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned key_of(const float* p, bool on, float cx,
                                           float cy, float cz) {
  if (!on) return kInfKey;
  const float dx = __fsub_rn(p[0], cx), dy = __fsub_rn(p[1], cy),
              dz = __fsub_rn(p[2], cz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const unsigned k = __float_as_uint(d2);
  return k > kInfKey ? kNanKey : k;
}

__global__ void __launch_bounds__(kThreads)
ex_keys_kernel(const float* __restrict__ pts, const bool* __restrict__ mask,
               const float* __restrict__ centre, int centre_stride, int c,
               int size, unsigned* __restrict__ keys,
               unsigned* __restrict__ hist1, unsigned* __restrict__ state) {
  __shared__ unsigned h[kBins1];
  __shared__ unsigned n_on;
  for (int i = threadIdx.x; i < kBins1; i += kThreads) h[i] = 0u;
  if (threadIdx.x == 0) n_on = 0u;
  __syncthreads();
  const float cx = centre[0], cy = centre[centre_stride],
              cz = centre[2 * centre_stride];
  unsigned on_here = 0;
  for (int q = 0; q < kPer; ++q) {
    const int i = blockIdx.x * kChunk + q * kThreads + threadIdx.x;
    if (i >= c) break;
    const bool on = mask[i];
    const unsigned k = key_of(pts + 3 * (size_t)i, on, cx, cy, cz);
    keys[i] = k;
    on_here += on;
    atomicAdd(&h[k >> 20], 1u);
  }
  atomicAdd(&n_on, on_here);
  __syncthreads();
  for (int i = threadIdx.x; i < kBins1; i += kThreads)
    if (h[i]) atomicAdd(&hist1[i], h[i]);
  if (threadIdx.x == 0) atomicAdd(&state[kNMask], n_on);
  if (!last_block(&state[kTicket1])) return;
  __shared__ unsigned bin, within;
  for (int i = threadIdx.x; i < kBins1; i += kThreads) {
    h[i] = ld(&hist1[i]);
    hist1[i] = 0u;
  }
  __syncthreads();
  find_rank(h, kBins1, (unsigned)size, &bin, &within);
  if (threadIdx.x == 0) {
    state[kBucket1] = bin;
    state[kRank1] = within;
    state[kTicket1] = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
ex_refine_kernel(const unsigned* __restrict__ keys, int c,
                 unsigned* __restrict__ hist2, unsigned* __restrict__ state) {
  __shared__ unsigned h[kBins2];
  for (int i = threadIdx.x; i < kBins2; i += kThreads) h[i] = 0u;
  __syncthreads();
  const unsigned b1 = ld(&state[kBucket1]);
  for (int q = 0; q < kPer; ++q) {
    const int i = blockIdx.x * kChunk + q * kThreads + threadIdx.x;
    if (i >= c) break;
    const unsigned k = keys[i];
    if ((k >> 20) == b1) atomicAdd(&h[(k >> 9) & (kBins2 - 1)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins2; i += kThreads)
    if (h[i]) atomicAdd(&hist2[i], h[i]);
  if (!last_block(&state[kTicket2])) return;
  __shared__ unsigned bin, within;
  for (int i = threadIdx.x; i < kBins2; i += kThreads) {
    h[i] = ld(&hist2[i]);
    hist2[i] = 0u;
  }
  __syncthreads();
  find_rank(h, kBins2, ld(&state[kRank1]), &bin, &within);
  if (threadIdx.x == 0) {
    state[kPrefix] = (b1 << 11) | bin;
    state[kRank2] = within;
    state[kTicket2] = 0u;
  }
}

// Per block (blocks x ...): lt, le, mx, cum (kBins3 + 1 words, cum[v] =
// keys of the block in the 22-bit bucket with low bits < v), and the
// results take and off.
struct Blocks {
  unsigned *lt, *le, *mx, *cum, *take, *off;
};

__global__ void __launch_bounds__(kThreads)
ex_count_kernel(const unsigned* __restrict__ keys, int c, int size,
                unsigned gate, float radius, Blocks blk,
                unsigned* __restrict__ hist3, unsigned* __restrict__ state,
                float* __restrict__ r_cover) {
  __shared__ unsigned h[kBins3 + 1];
  __shared__ unsigned mx;
  for (int i = threadIdx.x; i <= kBins3; i += kThreads) h[i] = 0u;
  if (threadIdx.x == 0) mx = 0u;
  __syncthreads();
  const unsigned prefix = ld(&state[kPrefix]);
  unsigned lt = 0, le = 0, m_here = 0;
  for (int q = 0; q < kPer; ++q) {
    const int i = blockIdx.x * kChunk + q * kThreads + threadIdx.x;
    if (i >= c) break;
    const unsigned k = keys[i];
    lt += (k >> 9) < prefix;
    if ((k >> 9) == prefix) atomicAdd(&h[(k & (kBins3 - 1)) + 1], 1u);
    if (k <= gate) {
      ++le;
      m_here = max(m_here, k);
    }
  }
  atomicMax(&mx, m_here);
  unsigned total;
  block_scan(lt, &lt);
  block_scan(le, &le);
  for (int i = threadIdx.x; i < kBins3; i += kThreads)
    if (h[i + 1]) atomicAdd(&hist3[i], h[i + 1]);
  // cumulative histogram: h[v] = keys with low bits < v
  {
    const int per = (kBins3 + kThreads - 1) / kThreads;  // 2
    unsigned run[per];
    unsigned sum = 0;
    for (int j = 0; j < per; ++j) {
      run[j] = h[1 + threadIdx.x * per + j];
      sum += run[j];
    }
    unsigned before = block_scan(sum, &total);
    for (int j = 0; j < per; ++j) {
      before += run[j];
      h[1 + threadIdx.x * per + j] = before;
    }
    __syncthreads();
  }
  unsigned* cum = blk.cum + (size_t)blockIdx.x * (kBins3 + 1);
  for (int i = threadIdx.x; i <= kBins3; i += kThreads) cum[i] = h[i];
  if (threadIdx.x == 0) {
    blk.lt[blockIdx.x] = lt;
    blk.le[blockIdx.x] = le;
    blk.mx[blockIdx.x] = mx;
  }
  if (!last_block(&state[kTicket3])) return;

  // The last block: T's low bits from the blocks' summed histogram.
  const int nb = gridDim.x;
  __shared__ unsigned bin, within;
  for (int v = threadIdx.x; v < kBins3; v += kThreads) {
    h[v] = ld(&hist3[v]);
    hist3[v] = 0u;
  }
  __syncthreads();
  find_rank(h, kBins3, ld(&state[kRank2]), &bin, &within);
  const unsigned low = bin, need_eq = within;
  const unsigned t = (prefix << 9) | low;
  const bool t_kept = t <= gate;
  // Each thread a contiguous range of blocks: the ties at T each may take
  // (first need_eq in index order), then the rows each keeps and their
  // offsets.
  const int per = (nb + kThreads - 1) / kThreads;
  const int b0 = min(nb, (int)threadIdx.x * per), b1 = min(nb, b0 + per);
  unsigned eq_sum = 0;
  for (int b = b0; b < b1; ++b) {
    const unsigned* cb = blk.cum + (size_t)b * (kBins3 + 1);
    eq_sum += ld(&cb[low + 1]) - ld(&cb[low]);
  }
  unsigned eq_before = block_scan(eq_sum, &total);
  unsigned kept_sum = 0;
  for (int b = b0; b < b1; ++b) {
    const unsigned* cb = blk.cum + (size_t)b * (kBins3 + 1);
    const unsigned eq = ld(&cb[low + 1]) - ld(&cb[low]);
    const unsigned take =
        eq_before >= need_eq ? 0u : min(eq, need_eq - eq_before);
    eq_before += eq;
    blk.take[b] = take;
    kept_sum += t_kept ? ld(&blk.lt[b]) + ld(&cb[low]) + take : ld(&blk.le[b]);
  }
  unsigned off = block_scan(kept_sum, &total);
  for (int b = b0; b < b1; ++b) {
    const unsigned* cb = blk.cum + (size_t)b * (kBins3 + 1);
    blk.off[b] = off;
    off += t_kept ? ld(&blk.lt[b]) + ld(&cb[low]) + blk.take[b]
                  : ld(&blk.le[b]);
  }
  // the largest kept key: T if T passes the gate, else the largest key
  // under it (every such key lies below T)
  unsigned m_all = 0;
  for (int b = threadIdx.x; b < nb; b += kThreads)
    m_all = max(m_all, ld(&blk.mx[b]));
  __shared__ unsigned m_kept;
  if (threadIdx.x == 0) m_kept = 0u;
  __syncthreads();
  atomicMax(&m_kept, m_all);
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned top = t_kept ? t : m_kept;
    const bool full = ld(&state[kNMask]) > (unsigned)size;
    float r = full ? sqrtf(__uint_as_float(top)) : INFINITY;
    if (radius > 0.f) r = fminf(r, radius);
    r_cover[0] = r;
    state[kT] = t;
    state[kNKept] = total;
    state[kNMask] = 0u;
    state[kTicket3] = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
ex_write_kernel(const unsigned* __restrict__ keys,
                const float* __restrict__ pts, const float* __restrict__ nrm,
                int c, int size, unsigned gate, Blocks blk,
                const unsigned* __restrict__ state,
                float* __restrict__ out_pts, float* __restrict__ out_nrm,
                bool* __restrict__ out_msk) {
  const unsigned t = ld(&state[kT]);
  const unsigned n_kept = ld(&state[kNKept]);
  const int base = blockIdx.x * kChunk + threadIdx.x * kPer;
  unsigned k[kPer];
  unsigned eq = 0;
  for (int q = 0; q < kPer; ++q) {
    k[q] = base + q < c ? keys[base + q] : 0xffffffffu;
    eq += k[q] == t;
  }
  unsigned total;
  unsigned eq_rank = block_scan(eq, &total);
  const unsigned take = ld(&blk.take[blockIdx.x]);
  bool kept[kPer];
  unsigned n_here = 0;
  for (int q = 0; q < kPer; ++q) {
    bool sel = k[q] < t;
    if (k[q] == t) sel = eq_rank++ < take;
    kept[q] = sel && k[q] <= gate;
    n_here += kept[q];
  }
  unsigned pos = ld(&blk.off[blockIdx.x]) + block_scan(n_here, &total);
  for (int q = 0; q < kPer; ++q) {
    if (!kept[q]) continue;
    const size_t i = base + q;
    for (int d = 0; d < 3; ++d) {
      out_pts[3 * (size_t)pos + d] = pts[3 * i + d];
      out_nrm[3 * (size_t)pos + d] = nrm[3 * i + d];
    }
    out_msk[pos] = true;
    ++pos;
  }
  // the padding rows [n_kept, size)
  for (unsigned r = n_kept + blockIdx.x * kThreads + threadIdx.x;
       r < (unsigned)size; r += gridDim.x * kThreads) {
    for (int d = 0; d < 3; ++d) {
      out_pts[3 * (size_t)r + d] = kPad;
      out_nrm[3 * (size_t)r + d] = 0.f;
    }
    out_msk[r] = false;
  }
}

}  // namespace

// Unsigned words of EX's scratch for c slots: the state, three
// histograms, the keys, and per block (ceil(c / 1024) blocks) five counts
// and a cumulative histogram. The scratch must be zero before the first
// call; every call leaves it ready for the next.
extern "C" long long local_select_scratch_words(int c) {
  const long long nb = (c + kChunk - 1) / kChunk;
  return 32 + kBins1 + kBins2 + kBins3 + (long long)c +
         nb * (6 + kBins3 + 1);
}

// points, normals (c, 3) float32 and mask (c,) bool, contiguous; centre
// three float32 at centre_stride apart; 1 <= size <= c; gate the bit
// pattern of the largest d² kept (the largest finite float, or radius² as
// float32 when radius > 0); radius as float32 (0: none). Outputs pts, nrm
// (size, 3) float32, msk (size,) bool, r_cover (1,) float32.
extern "C" cudaError_t local_select_f32(
    const float* pts, const float* nrm, const bool* mask, const float* centre,
    int centre_stride, int c, int size, unsigned gate, float radius,
    unsigned* scratch, float* out_pts, float* out_nrm, bool* out_msk,
    float* r_cover, cudaStream_t stream) {
  if (c <= 0 || size <= 0 || size > c || gate > kMaxFinite)
    return cudaErrorInvalidValue;
  const int nb = (c + kChunk - 1) / kChunk;
  unsigned* state = scratch;
  unsigned* hist1 = scratch + 32;
  unsigned* hist2 = hist1 + kBins1;
  unsigned* hist3 = hist2 + kBins2;
  unsigned* keys = hist3 + kBins3;
  unsigned* per_block = keys + c;
  Blocks blk{per_block, per_block + nb, per_block + 2 * nb,
             per_block + 6 * (size_t)nb, per_block + 3 * nb,
             per_block + 4 * nb};
  ex_keys_kernel<<<nb, kThreads, 0, stream>>>(pts, mask, centre,
                                              centre_stride, c, size, keys,
                                              hist1, state);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ex_refine_kernel<<<nb, kThreads, 0, stream>>>(keys, c, hist2, state);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ex_count_kernel<<<nb, kThreads, 0, stream>>>(keys, c, size, gate, radius,
                                               blk, hist3, state, r_cover);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ex_write_kernel<<<nb, kThreads, 0, stream>>>(keys, pts, nrm, c, size, gate,
                                               blk, state, out_pts, out_nrm,
                                               out_msk);
  return cudaGetLastError();
}
