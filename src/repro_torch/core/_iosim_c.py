"""Optional C accelerator for the Algorithm-1 I/O simulator and CR moves.

Compiled on first use with the system C compiler into a cache dir and loaded
via ctypes.  ``repro.core.iosim.simulate`` and ``repro.core.reorder`` use it
transparently when available; the pure-Python implementations remain the
reference oracles (cross-checked in tests/test_iosim.py).

Semantics mirrored exactly from the Python paths:
  * capacity = M - 1 neuron-value slots (one slot reserved for the streamed
    connection triple);
  * read-I/O per miss; write-I/O on evicting a dirty value that is needed
    again or belongs to an output neuron ("efficient eviction policy");
  * MIN = Belady via a lazy max-heap on next-use (computed internally),
    LRU via a lazy min-heap on stamps, RR via a slot ring;
  * propose = the paper's windowed left/right move (randomness stays in
    Python so both paths generate identical proposals).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_SRC = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define INF INT64_MAX

typedef struct { int64_t key; int64_t val; } heapent;

static void heap_push(heapent *h, int64_t *sz, int64_t key, int64_t val) {
    int64_t i = (*sz)++;
    h[i].key = key; h[i].val = val;
    while (i > 0) {
        int64_t p = (i - 1) >> 1;
        if (h[p].key <= h[i].key) break;
        heapent tmp = h[p]; h[p] = h[i]; h[i] = tmp;
        i = p;
    }
}

static heapent heap_pop(heapent *h, int64_t *sz) {
    heapent top = h[0];
    h[0] = h[--(*sz)];
    int64_t i = 0;
    for (;;) {
        int64_t l = 2 * i + 1, r = l + 1, m = i;
        if (l < *sz && h[l].key < h[m].key) m = l;
        if (r < *sz && h[r].key < h[m].key) m = r;
        if (m == i) break;
        heapent tmp = h[m]; h[m] = h[i]; h[i] = tmp;
        i = m;
    }
    return top;
}

/* policy: 0 = MIN, 1 = LRU, 2 = RR.  Returns 0 ok, -1 alloc failure.
   out[0] = reads (misses only), out[1] = writes (evictions + final flush). */
int simulate(const int64_t *trace, int64_t T, int64_t n, int64_t capacity,
             const uint8_t *is_output, int policy, int64_t *out)
{
    uint8_t *in_cache = calloc(n, 1);
    uint8_t *dirty = calloc(n, 1);
    int64_t *remaining = calloc(n, sizeof(int64_t));
    int64_t *aux = malloc(n * sizeof(int64_t));       /* cur_next_use / stamp */
    heapent *heap = malloc((2 * T + 16) * sizeof(heapent));
    int64_t *nxt = NULL, *slots = NULL, *slot_of = NULL, *last = NULL;
    if (!in_cache || !dirty || !remaining || !aux || !heap) goto fail;
    for (int64_t t = 0; t < T; t++) remaining[trace[t]]++;
    for (int64_t v = 0; v < n; v++) aux[v] = INF;

    if (policy == 0) {
        nxt = malloc(T * sizeof(int64_t));
        last = malloc(n * sizeof(int64_t));
        if (!nxt || !last) goto fail;
        for (int64_t v = 0; v < n; v++) last[v] = INF;
        for (int64_t t = T - 1; t >= 0; t--) {
            nxt[t] = last[trace[t]];
            last[trace[t]] = t;
        }
    }

    int64_t reads = 0, writes = 0, cached = 0, hsz = 0;
    int64_t clock = 0, rr_ptr = 0, next_free = 0;

    if (policy == 2) {
        slots = malloc(capacity * sizeof(int64_t));
        slot_of = malloc(n * sizeof(int64_t));
        if (!slots || !slot_of) goto fail;
        for (int64_t i = 0; i < capacity; i++) slots[i] = -1;
    }

    for (int64_t t = 0; t < T; t++) {
        int64_t v = trace[t];
        clock++;
        if (in_cache[v]) {
            if (policy == 0) { aux[v] = nxt[t]; heap_push(heap, &hsz, -nxt[t], v); }
            else if (policy == 1) { aux[v] = clock; heap_push(heap, &hsz, clock, v); }
        } else {
            if (cached >= capacity) {
                int64_t u = -1;
                if (policy == 0) {
                    for (;;) {
                        heapent e = heap_pop(heap, &hsz);
                        if (in_cache[e.val] && aux[e.val] == -e.key) { u = e.val; break; }
                    }
                } else if (policy == 1) {
                    for (;;) {
                        heapent e = heap_pop(heap, &hsz);
                        if (in_cache[e.val] && aux[e.val] == e.key) { u = e.val; break; }
                    }
                } else {
                    for (;;) {
                        int64_t cand = slots[rr_ptr];
                        int64_t ptr = rr_ptr;
                        rr_ptr = (rr_ptr + 1) % capacity;
                        if (cand >= 0 && in_cache[cand]) {
                            u = cand;
                            slots[ptr] = v; slot_of[v] = ptr;
                            break;
                        }
                    }
                }
                if (dirty[u] && (remaining[u] > 0 || is_output[u])) {
                    writes++; dirty[u] = 0;
                }
                in_cache[u] = 0; cached--;
            } else if (policy == 2) {
                int64_t s = next_free++;
                slots[s] = v; slot_of[v] = s;
            }
            reads++;
            in_cache[v] = 1; cached++;
            if (policy == 0) { aux[v] = nxt[t]; heap_push(heap, &hsz, -nxt[t], v); }
            else if (policy == 1) { aux[v] = clock; heap_push(heap, &hsz, clock, v); }
        }
        remaining[v]--;
        if (t & 1) dirty[v] = 1;
    }
    for (int64_t v = 0; v < n; v++)
        if (in_cache[v] && dirty[v] && is_output[v]) writes++;

    out[0] = reads; out[1] = writes;
    free(in_cache); free(dirty); free(remaining); free(aux); free(heap);
    free(nxt); free(last); free(slots); free(slot_of);
    return 0;
fail:
    free(in_cache); free(dirty); free(remaining); free(aux); free(heap);
    free(nxt); free(last); free(slots); free(slot_of);
    return -1;
}

/* MIN-policy segment executor for the incremental (windowed) evaluator.
   Runs Algorithm-1 accounting over trace_seg[0..L) with explicit per-access
   next-use keys nxt_seg[], starting from the given cache state; the state
   arrays (in_cache, dirty, remaining) are mutated in place so the caller can
   chain segments.  The Belady heap is rebuilt from (cached_ids, cached_nu) —
   decision-equivalent to a heap carried across the boundary, because
   decisions only ever depend on the valid entries.
   Records one (t_off, victim_key, runner_key, victim, runner) row per
   eviction into ev_out (caller allocates >= 5*L).
   out[0] += reads, out[1] += writes, out[2] = rows written.
   Returns 0 ok, -1 alloc failure. */
int resume_min_segment(const int64_t *trace_seg, const int64_t *nxt_seg,
                       int64_t L, int64_t n, int64_t capacity,
                       const uint8_t *is_output,
                       uint8_t *in_cache, uint8_t *dirty, int64_t *remaining,
                       const int64_t *cached_ids, const int64_t *cached_nu,
                       int64_t n_cached, int64_t *ev_out, int64_t *out)
{
    int64_t *aux = malloc(n * sizeof(int64_t));
    heapent *heap = malloc((L + n_cached + 16) * sizeof(heapent));
    if (!aux || !heap) { free(aux); free(heap); return -1; }
    for (int64_t v = 0; v < n; v++) aux[v] = INF;
    int64_t hsz = 0;
    int64_t cached = 0;
    for (int64_t i = 0; i < n_cached; i++) {
        int64_t v = cached_ids[i];
        aux[v] = cached_nu[i];
        heap_push(heap, &hsz, -cached_nu[i], v);
        cached++;
    }
    int64_t reads = 0, writes = 0, n_ev = 0;
    for (int64_t t = 0; t < L; t++) {
        int64_t v = trace_seg[t];
        int64_t nu = nxt_seg[t];
        if (in_cache[v]) {
            aux[v] = nu;
            heap_push(heap, &hsz, -nu, v);
        } else {
            if (cached >= capacity) {
                int64_t u;
                int64_t negnu;
                for (;;) {
                    heapent e = heap_pop(heap, &hsz);
                    if (in_cache[e.val] && aux[e.val] == -e.key) {
                        u = e.val; negnu = e.key; break;
                    }
                }
                if (dirty[u] && (remaining[u] > 0 || is_output[u])) {
                    writes++; dirty[u] = 0;
                }
                in_cache[u] = 0; cached--;
                while (hsz > 0 &&
                       !(in_cache[heap[0].val] && aux[heap[0].val] == -heap[0].key))
                    heap_pop(heap, &hsz);
                ev_out[5 * n_ev] = t;
                ev_out[5 * n_ev + 1] = -negnu;
                ev_out[5 * n_ev + 2] = hsz > 0 ? -heap[0].key : -1;
                ev_out[5 * n_ev + 3] = u;
                ev_out[5 * n_ev + 4] = hsz > 0 ? heap[0].val : -1;
                n_ev++;
            }
            reads++;
            in_cache[v] = 1; cached++;
            aux[v] = nu;
            heap_push(heap, &hsz, -nu, v);
        }
        remaining[v]--;
        if (t & 1) dirty[v] = 1;  /* caller aligns segments to even t */
    }
    out[0] += reads; out[1] += writes; out[2] = n_ev;
    free(aux); free(heap);
    return 0;
}

/* One windowed CR move (paper IV.A), in place on order[].
   dir: 0 = left, 1 = right.  Window = positions [i, min(i+w, W-1)].
   span > 0 caps how far any connection may travel: the anchor scan stops
   after span steps and inserts there.  Stopping the scan early is always
   topologically safe — the move crossed only conflict-free connections. */
void propose_move(int64_t *order, int64_t W, const int32_t *src,
                  const int32_t *dst, int64_t i, int64_t w, int dir,
                  int64_t span)
{
    int64_t j = i + w; if (j > W - 1) j = W - 1;
    if (dir == 0) {
        for (int64_t k = i; k <= j; k++) {
            int64_t e = order[k];
            int32_t a = src[e];
            int64_t p = k - 1;
            while (p >= 0 && (span <= 0 || k - p <= span)) {
                int64_t f = order[p];
                if (src[f] == a || dst[f] == a) break;
                p--;
            }
            if (p + 1 != k) {
                memmove(order + p + 2, order + p + 1, (k - p - 1) * sizeof(int64_t));
                order[p + 1] = e;
            }
        }
    } else {
        for (int64_t k = j; k >= i; k--) {
            int64_t e = order[k];
            int32_t b = dst[e];
            int64_t p = k + 1;
            while (p < W && (span <= 0 || p - k <= span)) {
                int64_t f = order[p];
                if (dst[f] == b || src[f] == b) break;
                p++;
            }
            if (p - 1 != k) {
                memmove(order + k, order + k + 1, (p - 1 - k) * sizeof(int64_t));
                order[p - 1] = e;
            }
        }
    }
}
"""

_lib: Optional[ctypes.CDLL] = None
_tried = False
_POLICY_ID = {"min": 0, "lru": 1, "rr": 2}


def _cache_dir() -> str:
    d = os.environ.get("REPRO_CACHE", os.path.join(tempfile.gettempdir(), "repro_cache"))
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> Optional[ctypes.CDLL]:
    tag = hashlib.sha256(_SRC.encode()).hexdigest()[:16]
    so = os.path.join(_cache_dir(), f"iosim_{tag}.so")
    if not os.path.exists(so):
        csrc = os.path.join(_cache_dir(), f"iosim_{tag}.c")
        with open(csrc, "w") as f:
            f.write(_SRC)
        cc = os.environ.get("CC", "cc")
        tmp = so + f".tmp{os.getpid()}"
        try:
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-o", tmp, csrc],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, so)  # atomic: concurrent builders race safely
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.simulate.restype = ctypes.c_int
    lib.simulate.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                             u8p, ctypes.c_int, i64p]
    lib.propose_move.restype = None
    lib.propose_move.argtypes = [i64p, ctypes.c_int64, i32p, i32p,
                                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_int64]
    lib.resume_min_segment.restype = ctypes.c_int
    lib.resume_min_segment.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p,
        u8p, u8p, i64p, i64p, i64p, ctypes.c_int64, i64p, i64p]
    return lib


def available() -> bool:
    global _lib, _tried
    if not _tried:
        _tried = True
        if os.environ.get("REPRO_NO_C_SIM"):
            _lib = None
        else:
            _lib = _build()
    return _lib is not None


def simulate_c(trace: np.ndarray, n: int, capacity: int,
               is_output: np.ndarray, policy: str):
    """Returns (miss_reads, evict_writes) or None if the accelerator is unavailable."""
    if not available():
        return None
    trace = np.ascontiguousarray(trace, dtype=np.int64)
    is_out = np.ascontiguousarray(is_output.astype(np.uint8))
    out = np.zeros(2, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = _lib.simulate(
        trace.ctypes.data_as(i64p), len(trace), n, capacity,
        is_out.ctypes.data_as(u8p), _POLICY_ID[policy],
        out.ctypes.data_as(i64p),
    )
    if rc != 0:
        return None
    return int(out[0]), int(out[1])


def resume_min_segment_c(trace_seg: np.ndarray, nxt_seg: np.ndarray,
                         n: int, capacity: int, is_output: np.ndarray,
                         in_cache: np.ndarray, dirty: np.ndarray,
                         remaining: np.ndarray, cached_ids: np.ndarray,
                         cached_nu: np.ndarray, ev_out: np.ndarray,
                         out: np.ndarray) -> bool:
    """Run one MIN segment in C; mutates state arrays in place.

    ``out`` is int64[3]: reads are ADDED to out[0], writes to out[1], and
    out[2] is set to the number of eviction rows written to ``ev_out``.
    Returns False if the accelerator is unavailable (caller falls back)."""
    if not available():
        return False
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = _lib.resume_min_segment(
        trace_seg.ctypes.data_as(i64p), nxt_seg.ctypes.data_as(i64p),
        len(trace_seg), n, capacity,
        is_output.ctypes.data_as(u8p),
        in_cache.ctypes.data_as(u8p), dirty.ctypes.data_as(u8p),
        remaining.ctypes.data_as(i64p),
        cached_ids.ctypes.data_as(i64p), cached_nu.ctypes.data_as(i64p),
        len(cached_ids), ev_out.ctypes.data_as(i64p),
        out.ctypes.data_as(i64p),
    )
    return rc == 0


def propose_move_c(order: np.ndarray, src: np.ndarray, dst: np.ndarray,
                   i: int, w: int, direction: int,
                   max_move_span: int = 0) -> bool:
    """In-place windowed move on ``order`` (int64).  Returns False if
    unavailable.  ``max_move_span`` > 0 caps the travel distance of each
    moved connection (0 = the paper's unbounded scan)."""
    if not available():
        return False
    assert order.dtype == np.int64 and order.flags.c_contiguous
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    _lib.propose_move(
        order.ctypes.data_as(i64p), len(order),
        np.ascontiguousarray(src, np.int32).ctypes.data_as(i32p),
        np.ascontiguousarray(dst, np.int32).ctypes.data_as(i32p),
        i, w, direction, max_move_span,
    )
    return True
