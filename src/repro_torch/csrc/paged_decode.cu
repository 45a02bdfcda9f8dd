// Batched ragged flash-decode over the paged KV pool, for Hopper (sm_90a): K2.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_flash_decode.py::
// paged_flash_decode_partial: one launch per instance per layer per decode
// iteration attends the instance's pool storage in place through
// per-request block tables and emits the UNNORMALIZED partial (o, m, l) that
// the multi-master combine LSE-merges across instances.
//
// What it computes: for request b and q head hh, over local tokens
// j < lengths[b] (slot = block_table[b, j / P] * P + j % P), the scores
// q . k[slot] * scale (tanh softcap), masked by
//     query_pos[b] - page_pos[slot] < window   (windowed configs only),
// folded into an online softmax with the reference's conventions (masked
// scores -1e30, m_safe = max(m, -1e29), m = -inf and l = 0 for an empty
// row: a zero-length request gives exactly the empty partial).
//
// Bound on this card: bytes.  Each valid slot is read once per KV head (2 *
// len * KVH * D * sizeof(kv) over the batch; the engine's pool mirror is
// f32) against 4 * q_per_kv * D FLOPs per slot and KV head, far below the
// ~295 FLOP/byte ridge.
//
// Design: the split-K core csrc/decode_splitk.cuh, with the block table as
// the row addressing.  A small batch (B x KVH below two CTAs per SM) has its
// requests' token ranges [0, lengths[b]) cut into splits so that every SM
// streams K/V; the unified step's batch of thousands of rows runs one split
// per row and writes (o, m, l) directly.  K/V rows are gathered slot by slot
// with 16-byte cp.async (at the engine's page size 1 every key is its own
// "page", so TMA, which has no gather, does not fit).  The block-table
// entries of a stage ride in the copy group two stages ahead of it (4-byte
// cp.async), so a table read never stalls the ring; under a window each
// key's page position rides along with its own copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_splitk.cuh"

namespace {

using repro::decode::Params;

// K2's addressing: local token j of request b lives in pool slot
// block_table[b, j / P] * P + j % P (the core reads the table, bringing each
// stage's entries in with the copies two stages ahead); the window is
// tested per slot against page_pos
struct PagedRows {
  static constexpr bool kTable = true;
  __device__ static void range(const Params& p, int b, int& lo, int& hi) {
    lo = 0;
    hi = min(p.lengths[b], p.max_pages * p.page_size);
  }
  __device__ static size_t base(const Params&, int) { return 0; }
};

}  // namespace

extern "C" {

// Pass 1.  q [b, h, d] (one query token per request), k_pages / v_pages
// [n_pages, page_size, kvh, d] contiguous and 16-byte aligned, block_table
// [b, max_pages], lengths [b], page_pos [n_pages * page_size] and query_pos
// [b] (int32; both may be null when window <= 0).  q_dtype / kv_dtype:
// 0 = float32, 1 = bfloat16.  Each request's tokens are cut into n_splits
// splits of `chunk` keys (a multiple of 64, n_splits * chunk >= max_pages *
// page_size), rows_per_cta (1 or 2) q heads per CTA.  With n_splits == 1
// it writes o [b, h, d], m and l [b, h] (float32); otherwise the per-split
// partials into ws [n_splits, b, h, d + 2] (o, then m, then l), which
// repro_paged_decode_merge folds.  Requires h % kvh == 0, h / kvh <= 64,
// d % 8 == 0, 8 <= d <= 256, b >= 1 and max_pages >= 1.  Returns the
// launch's cudaError_t.
int repro_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                       const int* block_table, const int* lengths,
                       const int* page_pos, const int* query_pos, float* o,
                       float* m, float* l, float* ws, int b, int h, int kvh,
                       int d, int page_size, int max_pages, int n_splits,
                       int chunk, int rows_per_cta, int q_dtype, int kv_dtype,
                       int window, float softcap, float scale, void* stream) {
  if (kvh < 1 || page_size < 1 || max_pages < 1 || q_dtype < 0 || q_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (window > 0 && (page_pos == nullptr || query_pos == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.lengths = lengths;
  p.table = block_table;
  p.page_pos = page_pos;
  p.query_pos = query_pos;
  p.o = o;
  p.m = m;
  p.l = l;
  p.ws = ws;
  p.b = b;
  p.h = h;
  p.kvh = kvh;
  p.d = d;
  p.qpk = h / kvh;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.window = window;
  p.chunk = chunk;
  p.n_splits = n_splits;
  p.q_bf16 = q_dtype;
  p.softcap = softcap;
  p.scale = scale;
  return repro::decode::launch<PagedRows>(p, kv_dtype, rows_per_cta,
                                          static_cast<cudaStream_t>(stream));
}

// Pass 2, for n_splits > 1: ws [n_splits, b, h, d + 2] -> o [b, h, d], m and
// l [b, h].  Returns the launch's cudaError_t.
int repro_paged_decode_merge(const float* ws, float* o, float* m, float* l,
                             int b, int h, int d, int n_splits, void* stream) {
  return repro::decode::launch_merge(ws, o, m, l, b, h, d, n_splits,
                                     static_cast<cudaStream_t>(stream));
}

const char* repro_paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
