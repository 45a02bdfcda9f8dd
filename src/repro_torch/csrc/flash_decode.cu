// Flash-decode partial over one dense KV shard, for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_partial (LoongServe's Flash-Decoding with the extra ESP
// parameters: the shard's global offset and each request's valid length).
// In the port it computes the history partial of every serial decode step
// (`DefaultAttnImpl.decode_attn`, the path of the moe and hybrid families):
// one launch per attention layer per request, B = 1.
//
// What it computes: for request b and q head hh, over the shard's keys j
// (global position kpos = k_pos_offset + j) with
//     kpos < lengths[b]   (&  kpos > lengths[b] - window,  windowed configs),
// the scores q . k[b, j] * scale (tanh softcap), folded into an online
// softmax with the reference's conventions (m_safe = max(m, -1e29); an empty
// row gives m = -inf, l = 0, o = 0).  The output is the UNNORMALIZED partial
// (o, m, l) in f32, merged with the new token's own partial by the caller.
//
// Bound on this card: bytes.  Each valid KV row is read once (2 * len * KVH
// * D * sizeof(kv)), against 4 * q_per_kv * D FLOPs per key and KV head —
// far below the ~295 FLOP/byte ridge.  At B = 1 a grid of one CTA per KV
// head (8 for mixtral, 32 for zamba2, on 132 SMs) cannot come near that
// bound, however fast each CTA streams.
//
// Design: the split-K core csrc/decode_splitk.cuh with identity addressing
// (key j of request b is row b * S + j of the shard).  The valid keys form
// one contiguous range, [max(0, len - window + 1 - offset), min(S, len -
// offset)), computed per row on the device; the host planner cuts it into
// splits of whole 64-key tiles so that B x KVH x n_splits CTAs cover the
// SMs, and a merge pass folds the splits' partials by log-sum-exp.  Nothing
// outside the range is read: not past lengths[b] - offset, not past S (a
// shard of a longer cache), and under a window only the window.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_splitk.cuh"

namespace {

using repro::decode::Params;

// K5's addressing: key j of request b is row b * S + j; the window narrows
// the range itself
struct DenseRows {
  static constexpr bool kTable = false;
  __device__ static void range(const Params& p, int b, int& lo, int& hi) {
    const long long len = p.lengths[b];
    hi = (int)max(0LL, min((long long)p.s, len - p.offset));
    lo = p.window > 0 ? (int)min((long long)hi, max(0LL, len - p.window + 1 - p.offset))
                      : 0;
  }
  __device__ static size_t base(const Params& p, int b) { return (size_t)b * p.s; }
};

}  // namespace

extern "C" {

// Pass 1.  q [b, h, d] (one query token per request), k / v [b, s, kvh, d]
// contiguous and 16-byte aligned, lengths [b] int32 (global valid cache
// length per request), offset = the global position of the shard's first
// key.  q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  Each row's valid
// keys are cut into n_splits splits of `chunk` keys (a multiple of 64,
// n_splits * chunk >= min(s, window - 1) when windowed, else >= s),
// rows_per_cta (1 or 2) q heads per CTA.  With n_splits == 1 it writes
// o [b, h, d], m and l [b, h] (float32); otherwise the per-split partials
// into ws [n_splits, b, h, d + 2] (o, then m, then l), which
// repro_flash_decode_merge folds.  window <= 0 and softcap <= 0 disable
// those masks.  Requires h % kvh == 0, h / kvh <= 64, d % 8 == 0,
// 8 <= d <= 256 and b, s >= 1.  Returns the launch's cudaError_t.
int repro_flash_decode(const void* q, const void* k, const void* v,
                       const int* lengths, float* o, float* m, float* l,
                       float* ws, int b, int s, int h, int kvh, int d,
                       int offset, int n_splits, int chunk, int rows_per_cta,
                       int q_dtype, int kv_dtype, int window, float softcap,
                       float scale, void* stream) {
  if (kvh < 1 || s < 1 || q_dtype < 0 || q_dtype > 1) return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.lengths = lengths;
  p.o = o;
  p.m = m;
  p.l = l;
  p.ws = ws;
  p.b = b;
  p.h = h;
  p.kvh = kvh;
  p.d = d;
  p.qpk = h / kvh;
  p.s = s;
  p.offset = offset;
  p.window = window;
  p.chunk = chunk;
  p.n_splits = n_splits;
  p.q_bf16 = q_dtype;
  p.softcap = softcap;
  p.scale = scale;
  return repro::decode::launch<DenseRows>(p, kv_dtype, rows_per_cta,
                                          static_cast<cudaStream_t>(stream));
}

// Pass 2, for n_splits > 1: ws [n_splits, b, h, d + 2] -> o [b, h, d], m and
// l [b, h].  Returns the launch's cudaError_t.
int repro_flash_decode_merge(const float* ws, float* o, float* m, float* l,
                             int b, int h, int d, int n_splits, void* stream) {
  return repro::decode::launch_merge(ws, o, m, l, b, h, d, n_splits,
                                     static_cast<cudaStream_t>(stream));
}

const char* repro_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
