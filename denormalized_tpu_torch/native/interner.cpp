// interner — fixed-width-bytes string interning: values → dense int32 ids.
//
// Native hot path for group-key interning (the GroupValues-equivalent; see
// ops/interner.py).  Python converts an object column to a fixed-width
// numpy 'S' array (vectorized, ~10M rows/s) and hands the raw buffer here;
// we hash each width-w slot into an open-addressing table that persists
// across batches, so steady-state interning is one hash+memcmp per row with
// no Python object traffic at all.
//
// The table stores (offset into an append-only arena, id).  C ABI for
// ctypes.

#ifdef INTERN_HAVE_PYTHON
// must precede the standard headers per CPython's include rules
#include <Python.h>
#endif

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Interner {
  std::vector<uint8_t> arena;     // concatenated fixed-width keys (by id)
  std::vector<uint32_t> arena_w;  // width of each id's key
  // open addressing table of (id+1), 0 = empty
  std::vector<uint32_t> table;
  uint64_t mask = 0;
  uint64_t count = 0;

  void grow() {
    size_t ncap = table.empty() ? 1024 : table.size() * 2;
    std::vector<uint32_t> nt(ncap, 0);
    uint64_t nmask = ncap - 1;
    // rehash existing ids
    uint64_t off = 0;
    for (uint64_t id = 0; id < count; id++) {
      uint32_t w = arena_w[id];
      uint64_t h = hash(arena.data() + off, w);
      uint64_t slot = h & nmask;
      while (nt[slot]) slot = (slot + 1) & nmask;
      nt[slot] = (uint32_t)(id + 1);
      off += w;
    }
    table.swap(nt);
    mask = nmask;
  }

  static uint64_t hash(const uint8_t* p, uint32_t w) {
    // 8-byte-chunk multiply-mix (keys are fixed-width UTF-32 slots, often
    // 40+ bytes — per-byte FNV costs one multiply per byte; this costs one
    // per 8 bytes)
    uint64_t h = 1469598103934665603ull ^ w;
    while (w >= 8) {
      uint64_t k;
      memcpy(&k, p, 8);
      h = (h ^ k) * 0x9E3779B97F4A7C15ull;
      h ^= h >> 29;
      p += 8;
      w -= 8;
    }
    if (w) {
      uint64_t k = 0;
      memcpy(&k, p, w);
      h = (h ^ k) * 0x9E3779B97F4A7C15ull;
      h ^= h >> 29;
    }
    return h;
  }

};

}  // namespace

namespace {

// internal-linkage like everything else non-ABI here: the handle type
// crosses the C ABI only as void*, and keeping it in the anonymous
// namespace (its Interner field already is) avoids -Wsubobject-linkage
// in the single-TU sanitizer build
struct CInterner {
  Interner in;
  std::vector<uint64_t> offsets;  // arena offset per id
#ifdef INTERN_HAVE_PYTHON
  // pointer-identity lookaside: PyObject* → id.  Group keys repeat the
  // SAME string objects heavily (dictionary-style sources, reused pools),
  // and str is immutable — so a pointer hit skips the UTF-8 fetch, content
  // hash, and arena memcmp entirely.  Cached objects are INCREF-pinned so
  // the pointer can never be reused for a different string.
  std::vector<uint64_t> pkeys;  // ptr, 0 = empty
  std::vector<uint32_t> pids;   // id + 1
  uint64_t pmask = 0;
  uint64_t pcount = 0;
#endif
};

}  // namespace

extern "C" {

void* intern_create() {
  CInterner* c = new CInterner();
  c->in.grow();
  return c;
}

void intern_destroy(void* h) { delete static_cast<CInterner*>(h); }

uint64_t intern_count(void* h) { return static_cast<CInterner*>(h)->in.count; }

namespace {

// intern one key (len already padding-stripped) → dense id
inline int32_t intern_one(CInterner* c, const uint8_t* key, uint32_t len) {
  Interner& in = c->in;
  uint64_t hv = Interner::hash(key, len);
  uint64_t slot = hv & in.mask;
  for (;;) {
    uint32_t e = in.table[slot];
    if (!e) {
      // new key
      if ((in.count + 1) * 4 >= in.table.size() * 3) {
        in.grow();
        slot = hv & in.mask;
        while (in.table[slot]) slot = (slot + 1) & in.mask;
      }
      uint64_t off = in.arena.size();
      in.arena.insert(in.arena.end(), key, key + len);
      in.arena_w.push_back(len);
      c->offsets.push_back(off);
      in.table[slot] = (uint32_t)(in.count + 1);
      int32_t id = (int32_t)in.count;
      in.count++;
      return id;
    }
    uint64_t id = e - 1;
    uint32_t klen = in.arena_w[id];
    if (klen == len &&
        memcmp(in.arena.data() + c->offsets[id], key, len) == 0)
      return (int32_t)id;
    slot = (slot + 1) & in.mask;
  }
}

}  // namespace

// Intern n fixed-width keys (width w, buffer n*w bytes) → out_ids[n].
// Trailing bytes of shorter strings must be zero-padded (numpy 'S' does
// this).  Keys of DIFFERENT widths across calls are distinct unless their
// padded bytes match after width normalization — callers keep one interner
// per column and always pass the column's current max width; previously
// seen keys are re-looked-up by re-padding, so the arena stores the
// ORIGINAL width and comparison strips trailing zeros.
void intern_many(void* h, const uint8_t* data, uint64_t n, uint32_t w,
                 int32_t* out_ids) {
  CInterner* c = static_cast<CInterner*>(h);
  for (uint64_t i = 0; i < n; i++) {
    const uint8_t* key = data + i * w;
    // effective length: strip zero padding so width changes don't split keys
    uint32_t len = w;
    while (len > 0 && key[len - 1] == 0) len--;
    out_ids[i] = intern_one(c, key, len);
  }
}

// Intern n variable-length keys given as one contiguous UTF-8 buffer plus
// u64 offsets (n+1 entries) — the Arrow string-column layout, so a
// StringColumn interns straight off its own buffers with NO Python str
// materialization.  valid may be NULL (all valid); invalid slots intern
// the dedicated 0xFF NULL key (impossible in valid UTF-8 — same sentinel
// as the PyObject path's None handling, so mixed-lane columns agree).
// Trailing NULs strip like every other lane.
void intern_offsets(void* h, const uint8_t* bytes, const uint64_t* offsets,
                    const uint8_t* valid, uint64_t n, int32_t* out_ids) {
  CInterner* c = static_cast<CInterner*>(h);
  static const uint8_t kNullKey[1] = {0xFF};
  for (uint64_t i = 0; i < n; i++) {
    if (valid != nullptr && !valid[i]) {
      out_ids[i] = intern_one(c, kNullKey, 1);
      continue;
    }
    const uint8_t* key = bytes + offsets[i];
    uint32_t len = (uint32_t)(offsets[i + 1] - offsets[i]);
    while (len > 0 && key[len - 1] == 0) len--;
    out_ids[i] = intern_one(c, key, len);
  }
}

#ifdef INTERN_HAVE_PYTHON
// Direct PyObject path: hash each numpy-object-array slot's string content
// (CPython-cached UTF-8) with NO fixed-width conversion and NO new Python
// objects — the hot path for high-cardinality group keys.  Must be called
// through ctypes.PyDLL (the GIL stays held).  Keys stored as UTF-8, so a
// column interner must use EITHER this path or intern_many, never both.
namespace {

constexpr uint64_t kPtrCacheCap = 1u << 20;  // bound pinned objects

inline void pcache_grow(CInterner* c) {
  size_t ncap = c->pkeys.empty() ? 4096 : c->pkeys.size() * 2;
  std::vector<uint64_t> nk(ncap, 0);
  std::vector<uint32_t> ni(ncap, 0);
  uint64_t nmask = ncap - 1;
  for (size_t i = 0; i < c->pkeys.size(); i++) {
    if (!c->pkeys[i]) continue;
    uint64_t slot = (c->pkeys[i] * 0x9E3779B97F4A7C15ull >> 17) & nmask;
    while (nk[slot]) slot = (slot + 1) & nmask;
    nk[slot] = c->pkeys[i];
    ni[slot] = c->pids[i];
  }
  c->pkeys.swap(nk);
  c->pids.swap(ni);
  c->pmask = nmask;
}

}  // namespace

int intern_pyobjects(void* h, PyObject** objs, uint64_t n, int32_t* out_ids) {
  CInterner* c = static_cast<CInterner*>(h);
  if (c->pkeys.empty()) pcache_grow(c);
  for (uint64_t i = 0; i < n; i++) {
    PyObject* o = objs[i];
    // pointer lookaside first
    uint64_t ptr = (uint64_t)(uintptr_t)o;
    uint64_t slot = (ptr * 0x9E3779B97F4A7C15ull >> 17) & c->pmask;
    bool hit = false;
    while (c->pkeys[slot]) {
      if (c->pkeys[slot] == ptr) {
        out_ids[i] = (int32_t)(c->pids[slot] - 1);
        hit = true;
        break;
      }
      slot = (slot + 1) & c->pmask;
    }
    if (hit) continue;
    Py_ssize_t len = 0;
    const char* s = nullptr;
    PyObject* tmp = nullptr;
    if (o == Py_None) {
      // NULL keys get a dedicated 1-byte key (0xFF — impossible in valid
      // UTF-8), so null groups never collide with the string 'None' and
      // the reverse lookup can reconstruct real None
      static const char kNullKey[1] = {(char)0xFF};
      out_ids[i] = intern_one(c, (const uint8_t*)kNullKey, 1);
      continue;
    }
    if (PyUnicode_Check(o)) {
      s = PyUnicode_AsUTF8AndSize(o, &len);
      if (s == nullptr) {
        // lone surrogates etc.: match the engine-wide errors='replace'
        // policy instead of aborting the stream
        PyErr_Clear();
        tmp = PyUnicode_AsEncodedString(o, "utf-8", "replace");
        if (tmp) {
          char* bs = nullptr;
          if (PyBytes_AsStringAndSize(tmp, &bs, &len) == 0) s = bs;
        }
      }
    } else {
      // non-string key (None, numbers in an object column): match the
      // fallback path's str() normalization
      PyObject* as_str = PyObject_Str(o);
      if (as_str) {
        s = PyUnicode_AsUTF8AndSize(as_str, &len);
        tmp = as_str;
      }
    }
    if (s == nullptr) {
      Py_XDECREF(tmp);
      return -1;  // propagate: caller raises the pending Python error
    }
    uint32_t l = (uint32_t)len;
    while (l > 0 && s[l - 1] == 0) l--;  // same padding-strip semantics
    int32_t id = intern_one(c, (const uint8_t*)s, l);
    out_ids[i] = id;
    Py_XDECREF(tmp);
    // Cache only plain strs that show evidence of POOLING: a per-row str
    // freshly minted by a decoder is held by nothing but the batch array
    // (refcount 1 + the borrowed array slot), so pinning it would retain
    // dead objects forever for zero hits.  Reused/pooled keys (the case
    // the cache exists for) carry extra references.
    if (tmp == nullptr && Py_REFCNT(o) >= 2 && c->pcount < kPtrCacheCap) {
      if ((c->pcount + 1) * 4 >= c->pkeys.size() * 3) pcache_grow(c);
      uint64_t s2 = (ptr * 0x9E3779B97F4A7C15ull >> 17) & c->pmask;
      while (c->pkeys[s2]) s2 = (s2 + 1) & c->pmask;
      c->pkeys[s2] = ptr;
      c->pids[s2] = (uint32_t)(id + 1);
      c->pcount++;
      Py_INCREF(o);
    }
  }
  return 0;
}

// release the pointer cache's pins — MUST be called through ctypes.PyDLL
// (needs the GIL) before intern_destroy
void intern_py_release(void* h) {
  CInterner* c = static_cast<CInterner*>(h);
  for (size_t i = 0; i < c->pkeys.size(); i++)
    if (c->pkeys[i]) Py_DECREF((PyObject*)(uintptr_t)c->pkeys[i]);
  c->pkeys.clear();
  c->pids.clear();
  c->pmask = 0;
  c->pcount = 0;
}
#endif  // INTERN_HAVE_PYTHON

// bulk reverse lookup: copy the arena slice and offsets for ids in
// [start, end) — one call per batch instead of one per key
int64_t intern_keys_range(void* h, uint64_t start, uint64_t end,
                          uint8_t** bytes_out, uint64_t** offsets_out) {
  CInterner* c = static_cast<CInterner*>(h);
  if (start > end || end > c->in.count) return -1;
  uint64_t n = end - start;
  uint64_t base = c->offsets.empty() || start >= c->offsets.size()
                      ? c->in.arena.size()
                      : c->offsets[start];
  uint64_t total = (end == c->in.count ? c->in.arena.size()
                                       : c->offsets[end]) -
                   base;
  uint8_t* bytes = (uint8_t*)malloc(total ? total : 1);
  uint64_t* offs = (uint64_t*)malloc((n + 1) * sizeof(uint64_t));
  memcpy(bytes, c->in.arena.data() + base, total);
  for (uint64_t i = 0; i < n; i++) offs[i] = c->offsets[start + i] - base;
  offs[n] = total;
  *bytes_out = bytes;
  *offsets_out = offs;
  return (int64_t)n;
}

void intern_free(void* p) { free(p); }

// copy key bytes for one id (for reverse lookup); returns length
uint32_t intern_key(void* h, uint64_t id, uint8_t* out, uint32_t cap) {
  CInterner* c = static_cast<CInterner*>(h);
  if (id >= c->in.count) return 0;
  uint32_t w = c->in.arena_w[id];
  uint32_t n = w < cap ? w : cap;
  memcpy(out, c->in.arena.data() + c->offsets[id], n);
  return w;
}

}  // extern "C"
