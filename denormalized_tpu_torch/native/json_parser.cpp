// json_parser — one-pass JSON-objects → columnar buffers.
//
// Native ingest/decode path: the reference decodes Kafka JSON payloads by
// concatenating them into a JSON array and running arrow-json's reader
// (crates/core/src/formats/decoders/json.rs:11-49, native Rust/C via Arrow),
// which handles nested structs/lists natively.  Ours parses each payload
// directly into typed columnar buffers in a single pass — no intermediate
// DOM, no per-row Python objects — and SHREDS nested values the way a
// columnar format does:
//   - struct fields (any depth) become their leaf columns plus a per-row
//     presence byte per struct node;
//   - lists of scalars become Arrow-style (offsets, values, elem-validity)
//     triples;
//   - lists of structs / lists of lists are GENERIC list nodes: the list
//     stores per-row offsets and the single child node stores one entry
//     per ELEMENT (struct presence + descendant leaves, or another
//     (offsets, …) level for lists-of-lists) — recursion to any depth,
//     the same shredding arrow-json performs.
//
// C ABI for ctypes.  Node types: 0=int64, 1=float64, 2=bool, 3=string,
// 4=struct, 5=list-of-scalar, 6=list-of-node (child subtree per element).
// ``jp_create`` keeps the historical flat ABI (top-level scalar columns
// only); ``jp_create_tree`` takes the full schema tree.  Unknown keys are
// skipped (balanced for nested values); missing keys and JSON nulls set
// validity 0 (recursively for structs).

#include <algorithm>
#include <charconv>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <locale.h>
#include <string>
#include <vector>

#include "str_dict.hpp"

namespace {

// One schema-tree node.  Scalars store one value per ENTRY; struct nodes
// store a presence byte per entry in `valid` (1 = object present, 0 =
// null/missing) and their children hold the data; scalar-list nodes
// (type 5) store per-entry `list_offsets` with the elements packed into
// the node's own value vectors (`evalid` parallel to elements); generic
// list nodes (type 6) store per-entry `list_offsets` and their single
// child node holds one entry per element.  An "entry" is a row for
// top-level nodes and struct descendants, and an element for nodes under
// a generic list — every node appends exactly one `valid` byte per
// entry, so `valid.size()` is always a node's entry count.
struct Node {
  std::string name;
  int type;  // 0 i64 | 1 f64 | 2 bool | 3 str | 4 struct | 5 list | 6 list-of-node
  int elem_type = -1;  // type-5 list: scalar element type 0..3
  std::vector<int> kids;  // struct children / generic-list element node
  std::vector<int64_t> i64;
  std::vector<double> f64;
  std::vector<uint8_t> b;
  std::vector<uint8_t> str_bytes;
  std::vector<uint64_t> str_offsets;  // scalar: nrows+1; list str: nelems+1
  std::vector<uint8_t> valid;         // per row (leaf/struct/list)
  std::vector<uint64_t> list_offsets;  // list: nentries+1
  std::vector<uint8_t> evalid;         // type-5 list: per element
  StrDict dict;
};

// Adaptive row layout: streaming producers emit a fixed record shape, so
// after one general-path row parse we capture the exact inter-value byte
// runs — `{"key":`, `,"key2":`, …, the trailing `}` — including whatever
// fixed whitespace style the producer uses (serde_json compact,
// json.dumps `", "`/`": "`, …).  With nesting, the "values" are the
// LAYOUT UNITS: scalar leaves at any struct depth plus entire lists; the
// bytes of the nested structure itself (`{"gps":{"lat":`) land inside the
// inter-unit token runs, so a nested fixed-shape producer gets the same
// few-memcmp fast path as a flat one.  Any mismatch rolls the row back
// and reparses it on the general path (which re-learns the layout), so
// this is purely a fast path — semantics are identical.
struct Layout {
  bool valid = false;
  std::vector<std::string> tok;  // tok[i]: bytes preceding unit i
  std::vector<int> col;          // node index of unit i (-1: skip)
  std::vector<int> present;      // struct nodes present in this shape
  std::vector<int> missing;      // nodes nulled in this shape (subtree tops)
  std::string tail;              // bytes after the last unit
  int fail_streak = 0;
};

struct Parser {
  std::vector<Node> nodes;
  std::vector<int> top;  // top-level node indices, schema order
  uint64_t nrows = 0;
  std::string error;
  Layout layout;
  int adopt_cooldown = 0;  // >0: layout adoption suppressed (see jp_parse)
  // per-row discovery scratch (unit spans, node ids, shape sets), filled
  // by the general path so a successful row can become the new layout
  std::vector<size_t> d_vs, d_ve;
  std::vector<int> d_col;
  std::vector<int> d_present, d_missing;
  bool d_ok = false;
  // general-path per-row scratch, hoisted here so rows that stay on the
  // general path don't pay per-row heap allocations
  std::string g_key, g_sval;
  std::vector<uint8_t> g_seen;  // per NODE, cleared per row
};

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool fail = false;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      p++;
  }
  bool eat(char c) {
    ws();
    if (p < end && *p == (uint8_t)c) {
      p++;
      return true;
    }
    fail = true;
    return false;
  }
  bool peek(char c) {
    ws();
    return p < end && *p == (uint8_t)c;
  }
};

// parse a JSON string (after the opening quote) into out; handles escapes
bool parse_string(Cursor& c, std::string& out) {
  out.clear();
  while (c.p < c.end) {
    uint8_t ch = *c.p++;
    if (ch == '"') return true;
    if (ch != '\\') {
      out.push_back((char)ch);
      continue;
    }
    if (c.p >= c.end) break;
    uint8_t esc = *c.p++;
    switch (esc) {
      case '"': out.push_back('"'); break;
      case '\\': out.push_back('\\'); break;
      case '/': out.push_back('/'); break;
      case 'b': out.push_back('\b'); break;
      case 'f': out.push_back('\f'); break;
      case 'n': out.push_back('\n'); break;
      case 'r': out.push_back('\r'); break;
      case 't': out.push_back('\t'); break;
      case 'u': {
        auto hex4 = [&](unsigned& cp) -> bool {
          if (c.end - c.p < 4) return false;
          cp = 0;
          for (int i = 0; i < 4; i++) {
            uint8_t h = *c.p++;
            cp <<= 4;
            if (h >= '0' && h <= '9') cp |= h - '0';
            else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
            else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
            else return false;
          }
          return true;
        };
        unsigned cp;
        if (!hex4(cp)) return false;
        // surrogate pair → combined code point (json.dumps ensure_ascii
        // emits all non-BMP chars this way)
        if (cp >= 0xD800 && cp <= 0xDBFF && c.end - c.p >= 6 &&
            c.p[0] == '\\' && c.p[1] == 'u') {
          c.p += 2;
          unsigned lo;
          if (!hex4(lo)) return false;
          if (lo >= 0xDC00 && lo <= 0xDFFF) {
            cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
          } else {
            cp = 0xFFFD;  // lone high surrogate → replacement char
            unsigned cp2 = (lo >= 0xD800 && lo <= 0xDFFF) ? 0xFFFD : lo;
            auto emit = [&](unsigned x) {
              if (x < 0x80) out.push_back((char)x);
              else if (x < 0x800) {
                out.push_back((char)(0xC0 | (x >> 6)));
                out.push_back((char)(0x80 | (x & 0x3F)));
              } else if (x < 0x10000) {
                out.push_back((char)(0xE0 | (x >> 12)));
                out.push_back((char)(0x80 | ((x >> 6) & 0x3F)));
                out.push_back((char)(0x80 | (x & 0x3F)));
              } else {
                out.push_back((char)(0xF0 | (x >> 18)));
                out.push_back((char)(0x80 | ((x >> 12) & 0x3F)));
                out.push_back((char)(0x80 | ((x >> 6) & 0x3F)));
                out.push_back((char)(0x80 | (x & 0x3F)));
              }
            };
            emit(cp);
            emit(cp2);
            break;
          }
        } else if (cp >= 0xD800 && cp <= 0xDFFF) {
          cp = 0xFFFD;  // lone surrogate
        }
        if (cp < 0x80) out.push_back((char)cp);
        else if (cp < 0x800) {
          out.push_back((char)(0xC0 | (cp >> 6)));
          out.push_back((char)(0x80 | (cp & 0x3F)));
        } else if (cp < 0x10000) {
          out.push_back((char)(0xE0 | (cp >> 12)));
          out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
          out.push_back((char)(0x80 | (cp & 0x3F)));
        } else {
          out.push_back((char)(0xF0 | (cp >> 18)));
          out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
          out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
          out.push_back((char)(0x80 | (cp & 0x3F)));
        }
        break;
      }
      default: return false;
    }
  }
  return false;
}

// End of the numeric token starting at p (same charset the old
// strtol-based scanner used); std::from_chars then converts straight from
// the arena — no copy, no NUL termination needed, exactly-rounded doubles.
// The full token must be consumed or the row fails (so "1e5" on an int
// column cannot silently truncate to 1, and "inf"/"nan" — which
// from_chars would accept but JSON forbids — yield an empty token).
// The three literals json.loads DOES accept (NaN/Infinity/-Infinity;
// our own JsonRowEncoder emits Infinity for inf) are matched by spelling
// in parse_f64_at, keeping the native and Python decode paths identical.
inline const uint8_t* num_token_end(const uint8_t* p, const uint8_t* e) {
  while (p < e) {
    uint8_t ch = *p;
    if ((ch >= '0' && ch <= '9') || ch == '-' || ch == '+' || ch == '.' ||
        ch == 'e' || ch == 'E')
      p++;
    else
      break;
  }
  return p;
}

// out-of-range tokens keep the historical strtoll/strtod semantics
// (clamp to LLONG_MIN/MAX; overflow to ±inf, underflow to ±0) instead of
// failing the batch — json.loads accepts 1e999 and 20-digit ints, so the
// parser must too.  Cold path: copies the token for NUL termination.
bool num_range_fallback_i64(const uint8_t* q, const uint8_t* te, int64_t& v) {
  std::string tok((const char*)q, (const char*)te);
  char* endp = nullptr;
  long long r = strtoll(tok.c_str(), &endp, 10);
  if (endp != tok.c_str() + tok.size()) return false;
  v = r;
  return true;
}

bool num_range_fallback_f64(const uint8_t* q, const uint8_t* te, double& v) {
  // strtod_l against a cached C locale: plain strtod honors LC_NUMERIC,
  // so an embedding process that set a comma-decimal locale would reject
  // every '.'-pointed token this fallback exists to parse (from_chars is
  // locale-independent — the two branches must not diverge by locale)
  static locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  std::string tok((const char*)q, (const char*)te);
  char* endp = nullptr;
  double r = c_loc ? strtod_l(tok.c_str(), &endp, c_loc)
                   : strtod(tok.c_str(), &endp);
  if (endp != tok.c_str() + tok.size()) return false;
  v = r;
  return true;
}

// Clinger fast path: a token with <= 15 significant digits and a net
// decimal exponent within ±22 is EXACTLY m * 10^q with m < 2^53 and
// 10^|q| exactly representable — one multiply/divide, one rounding,
// bit-identical to a correctly-rounded strtod/from_chars.  Returns
// false (caller falls back to strtod) on long mantissas, big exponents,
// or malformed tails.  This is the hot conversion on toolchains whose
// libstdc++ lacks floating-point from_chars (gcc 10, this image): the
// sensor-style payloads the engine ingests are short decimals, so the
// slow path is essentially never taken.
inline bool fast_f64(const uint8_t* p, const uint8_t* e, double& v) {
  static const double P10[] = {1.0,   1e1,  1e2,  1e3,  1e4,  1e5,
                               1e6,   1e7,  1e8,  1e9,  1e10, 1e11,
                               1e12,  1e13, 1e14, 1e15, 1e16, 1e17,
                               1e18,  1e19, 1e20, 1e21, 1e22};
  bool neg = false;
  if (p < e && *p == '-') {
    neg = true;
    p++;
  }
  uint64_t m = 0;
  int ndig = 0, frac = 0;
  bool seen_dot = false, any = false;
  for (; p < e; p++) {
    uint8_t ch = *p;
    if (ch >= '0' && ch <= '9') {
      any = true;
      if (ndig < 19) m = m * 10 + (ch - '0');
      ndig++;
      if (seen_dot) frac++;
    } else if (ch == '.' && !seen_dot) {
      seen_dot = true;
    } else {
      break;
    }
  }
  if (!any) return false;
  int exp10 = 0;
  if (p < e && (*p == 'e' || *p == 'E')) {
    p++;
    bool eneg = false;
    if (p < e && (*p == '+' || *p == '-')) {
      eneg = (*p == '-');
      p++;
    }
    if (p >= e || *p < '0' || *p > '9') return false;
    int ev = 0;
    for (; p < e && *p >= '0' && *p <= '9'; p++)
      if (ev < 100000) ev = ev * 10 + (*p - '0');
    exp10 = eneg ? -ev : ev;
  }
  if (p != e) return false;
  if (ndig > 15) return false;  // double rounding possible: strtod decides
  int q10 = exp10 - frac;
  if (q10 < -22 || q10 > 22) return false;
  double dv = (double)m;
  dv = q10 >= 0 ? dv * P10[q10] : dv / P10[-q10];
  v = neg ? -dv : dv;
  return true;
}

inline bool parse_i64_at(const uint8_t*& q, const uint8_t* e, int64_t& v) {
  const uint8_t* te = num_token_end(q, e);
  if (te == q) return false;
  auto r = std::from_chars((const char*)q, (const char*)te, v, 10);
  if (r.ec == std::errc::result_out_of_range) {
    if (!num_range_fallback_i64(q, te, v)) return false;
  } else if (r.ec != std::errc() || r.ptr != (const char*)te) {
    return false;
  }
  q = te;
  return true;
}

inline bool parse_f64_at(const uint8_t*& q, const uint8_t* e, double& v) {
  // the exact (case-sensitive) non-finite literals json.loads accepts;
  // int columns stay strict — the Python path also rejects them there
  if (e - q >= 3 && memcmp(q, "NaN", 3) == 0) {
    v = std::numeric_limits<double>::quiet_NaN();
    q += 3;
    return true;
  }
  if (e - q >= 8 && memcmp(q, "Infinity", 8) == 0) {
    v = std::numeric_limits<double>::infinity();
    q += 8;
    return true;
  }
  if (e - q >= 9 && memcmp(q, "-Infinity", 9) == 0) {
    v = -std::numeric_limits<double>::infinity();
    q += 9;
    return true;
  }
  const uint8_t* te = num_token_end(q, e);
  if (te == q) return false;
#if defined(__cpp_lib_to_chars)
  auto r = std::from_chars((const char*)q, (const char*)te, v);
  if (r.ec == std::errc::result_out_of_range) {
    if (!num_range_fallback_f64(q, te, v)) return false;
  } else if (r.ec != std::errc() || r.ptr != (const char*)te) {
    return false;
  }
#else
  // libstdc++ < 11 ships integer from_chars only.  Clinger fast path
  // first (correctly rounded for short decimals — the hot shape), then
  // strtod on a bounded copy (the range-fallback conversion), keeping
  // the same full-token consumption rule; '+'-led tokens are rejected
  // explicitly to keep from_chars strictness (JSON forbids a leading
  // plus, strtod does not).
  if (*q == '+') return false;
  if (!fast_f64(q, te, v) && !num_range_fallback_f64(q, te, v))
    return false;
#endif
  q = te;
  return true;
}

// skip any JSON value (for unknown keys)
bool skip_value(Cursor& c) {
  c.ws();
  if (c.p >= c.end) return false;
  uint8_t ch = *c.p;
  if (ch == '"') {
    c.p++;
    std::string tmp;
    return parse_string(c, tmp);
  }
  if (ch == '{' || ch == '[') {
    uint8_t open = ch, close = (ch == '{') ? '}' : ']';
    int depth = 0;
    bool in_str = false;
    while (c.p < c.end) {
      uint8_t x = *c.p++;
      if (in_str) {
        if (x == '\\') { if (c.p < c.end) c.p++; }
        else if (x == '"') in_str = false;
      } else if (x == '"') in_str = true;
      else if (x == open) depth++;
      else if (x == close) {
        if (--depth == 0) return true;
      }
    }
    return false;
  }
  // number / true / false / null
  while (c.p < c.end && *c.p != ',' && *c.p != '}' && *c.p != ']' &&
         *c.p != ' ' && *c.p != '\n' && *c.p != '\t' && *c.p != '\r')
    c.p++;
  return true;
}

inline uint64_t list_elems(const Node& nd) {
  return nd.list_offsets.empty() ? 0 : nd.list_offsets.back();
}

// resize node ni and its whole subtree down to exactly `count` entries —
// cheap size bookkeeping, no reallocation.  Used by row rollback (count =
// committed rows for top-level nodes) and by duplicate-key subtree
// removal, where a generic-list child's entry count is whatever the
// trimmed parent's offsets say.
void trim_node(Parser* p, int ni, uint64_t count) {
  Node& nd = p->nodes[ni];
  nd.valid.resize(count);
  switch (nd.type) {
    case 0: nd.i64.resize(count); break;
    case 1: nd.f64.resize(count); break;
    case 2: nd.b.resize(count); break;
    case 3:
      nd.str_offsets.resize(count + 1);
      nd.str_bytes.resize(nd.str_offsets.back());
      break;
    case 4:
      for (int k : nd.kids) trim_node(p, k, count);
      break;
    case 5: {
      nd.list_offsets.resize(count + 1);
      uint64_t ne = nd.list_offsets.back();
      nd.evalid.resize(ne);
      switch (nd.elem_type) {
        case 0: nd.i64.resize(ne); break;
        case 1: nd.f64.resize(ne); break;
        case 2: nd.b.resize(ne); break;
        case 3:
          nd.str_offsets.resize(ne + 1);
          nd.str_bytes.resize(nd.str_offsets.back());
          break;
      }
      break;
    }
    case 6:
      nd.list_offsets.resize(count + 1);
      trim_node(p, nd.kids[0], nd.list_offsets.back());
      break;
  }
}

// drop every per-row append made by a partially parsed row, restoring all
// node vectors to exactly `nr` committed rows
void rollback_row(Parser* p, uint64_t nr) {
  for (int ni : p->top) trim_node(p, ni, nr);
}

void push_null_scalar(Node& nd) {
  nd.valid.push_back(0);
  switch (nd.type) {
    case 0: nd.i64.push_back(0); break;
    case 1: nd.f64.push_back(0.0); break;
    case 2: nd.b.push_back(0); break;
    case 3: nd.str_offsets.push_back(nd.str_bytes.size()); break;
  }
}

// append one null entry to node ni and (for structs) every descendant
// (a null list leaves its child untouched — zero elements)
void push_null_recursive(Parser* p, int ni) {
  Node& nd = p->nodes[ni];
  switch (nd.type) {
    case 4:
      nd.valid.push_back(0);
      for (int k : nd.kids) push_null_recursive(p, k);
      break;
    case 5:
    case 6:
      nd.valid.push_back(0);
      nd.list_offsets.push_back(list_elems(nd));
      break;
    default:
      push_null_scalar(nd);
  }
}

// zero the per-row duplicate-key marks for a whole subtree
void clear_seen(Parser* p, int ni) {
  p->g_seen[ni] = 0;
  for (int k : p->nodes[ni].kids) clear_seen(p, k);
}

// remove the last entry from node ni and every descendant (duplicate
// keys: json.loads is last-wins, so the earlier subtree's appends must
// go).  Also clears the per-row `seen` marks for the subtree so the
// replacement occurrence re-parses descendants as first sightings (the
// caller re-marks the subtree top itself).
void pop_row_subtree(Parser* p, int ni) {
  Node& nd = p->nodes[ni];
  p->g_seen[ni] = 0;
  nd.valid.pop_back();
  switch (nd.type) {
    case 0: nd.i64.pop_back(); break;
    case 1: nd.f64.pop_back(); break;
    case 2: nd.b.pop_back(); break;
    case 3:
      nd.str_offsets.pop_back();
      nd.str_bytes.resize(nd.str_offsets.back());
      break;
    case 4:
      for (int k : nd.kids) pop_row_subtree(p, k);
      break;
    case 5: {
      nd.list_offsets.pop_back();
      uint64_t ne = nd.list_offsets.back();
      nd.evalid.resize(ne);
      switch (nd.elem_type) {
        case 0: nd.i64.resize(ne); break;
        case 1: nd.f64.resize(ne); break;
        case 2: nd.b.resize(ne); break;
        case 3:
          nd.str_offsets.resize(ne + 1);
          nd.str_bytes.resize(nd.str_offsets.back());
          break;
      }
      break;
    }
    case 6:
      nd.list_offsets.pop_back();
      trim_node(p, nd.kids[0], nd.list_offsets.back());
      clear_seen(p, nd.kids[0]);
      break;
  }
}

// parse one scalar JSON value into nd (appends value + valid=1); the
// cursor sits at the first value byte (caller already handled "null")
bool parse_scalar_value(Parser* p, Node& nd, Cursor& c) {
  switch (nd.type) {
    case 0: {
      int64_t v;
      if (!parse_i64_at(c.p, c.end, v)) { c.fail = true; return false; }
      nd.i64.push_back(v);
      break;
    }
    case 1: {
      double v;
      if (!parse_f64_at(c.p, c.end, v)) { c.fail = true; return false; }
      nd.f64.push_back(v);
      break;
    }
    case 2: {
      if (c.end - c.p >= 4 && memcmp(c.p, "true", 4) == 0) {
        c.p += 4;
        nd.b.push_back(1);
      } else if (c.end - c.p >= 5 && memcmp(c.p, "false", 5) == 0) {
        c.p += 5;
        nd.b.push_back(0);
      } else {
        c.fail = true;
        return false;
      }
      break;
    }
    case 3: {
      if (!c.eat('"')) { c.fail = true; return false; }
      if (!parse_string(c, p->g_sval)) { c.fail = true; return false; }
      nd.str_bytes.insert(nd.str_bytes.end(), p->g_sval.begin(),
                          p->g_sval.end());
      nd.str_offsets.push_back(nd.str_bytes.size());
      break;
    }
    default:
      c.fail = true;
      return false;
  }
  nd.valid.push_back(1);
  return true;
}

// parse one scalar-list value (cursor at '['); appends elements + one
// list_offsets/valid row entry.  Shared by the general and fast paths —
// a list is a single layout unit, reparsed generically every row (its
// element count varies, so its bytes can't be layout tokens).
bool parse_list_value(Parser* /*p: callers pass it for symmetry with the
                                 other value parsers; lists need no
                                 parser-wide scratch*/,
                      Node& nd, Cursor& c, std::string& sval) {
  if (!c.eat('[')) return false;
  if (!c.peek(']')) {
    for (;;) {
      c.ws();
      if (c.end - c.p >= 4 && memcmp(c.p, "null", 4) == 0) {
        c.p += 4;
        nd.evalid.push_back(0);
        switch (nd.elem_type) {
          case 0: nd.i64.push_back(0); break;
          case 1: nd.f64.push_back(0.0); break;
          case 2: nd.b.push_back(0); break;
          case 3: nd.str_offsets.push_back(nd.str_bytes.size()); break;
        }
      } else {
        switch (nd.elem_type) {
          case 0: {
            int64_t v;
            if (!parse_i64_at(c.p, c.end, v)) return false;
            nd.i64.push_back(v);
            break;
          }
          case 1: {
            double v;
            if (!parse_f64_at(c.p, c.end, v)) return false;
            nd.f64.push_back(v);
            break;
          }
          case 2: {
            if (c.end - c.p >= 4 && memcmp(c.p, "true", 4) == 0) {
              c.p += 4;
              nd.b.push_back(1);
            } else if (c.end - c.p >= 5 && memcmp(c.p, "false", 5) == 0) {
              c.p += 5;
              nd.b.push_back(0);
            } else {
              return false;
            }
            break;
          }
          case 3: {
            if (!c.eat('"')) return false;
            if (!parse_string(c, sval)) return false;
            nd.str_bytes.insert(nd.str_bytes.end(), sval.begin(),
                                sval.end());
            nd.str_offsets.push_back(nd.str_bytes.size());
            break;
          }
        }
        nd.evalid.push_back(1);
      }
      if (c.peek(',')) { c.p++; continue; }
      break;
    }
  }
  if (!c.eat(']')) return false;
  nd.list_offsets.push_back(nd.evalid.size());
  nd.valid.push_back(1);
  return true;
}

bool parse_struct_body(Parser* p, int ni, Cursor& c, const uint8_t* b,
                       bool discover);
bool parse_value_node(Parser* p, int ni, Cursor& c);

// parse one generic-list value (type 6, cursor at '['): each element
// appends ONE entry to the child subtree — a struct element pushes its
// presence byte + descendant leaves, a list element pushes another
// offsets level, a null element pushes a recursive null — so the child's
// entry count IS the element count and the parent only records offsets.
bool parse_list_node(Parser* p, int ni, Cursor& c) {
  Node& nd = p->nodes[ni];
  const int kid = nd.kids[0];
  if (!c.eat('[')) return false;
  if (!c.peek(']')) {
    for (;;) {
      if (!parse_value_node(p, kid, c)) return false;
      if (c.peek(',')) { c.p++; continue; }
      break;
    }
  }
  if (!c.eat(']')) return false;
  nd.list_offsets.push_back(p->nodes[kid].valid.size());
  nd.valid.push_back(1);
  return true;
}

// parse any JSON value into node ni — the element parser for generic
// lists (no layout discovery: the enclosing list is already one opaque
// layout unit, reparsed generically every row)
bool parse_value_node(Parser* p, int ni, Cursor& c) {
  c.ws();
  if (c.end - c.p >= 4 && memcmp(c.p, "null", 4) == 0) {
    c.p += 4;
    push_null_recursive(p, ni);
    return true;
  }
  Node& nd = p->nodes[ni];
  switch (nd.type) {
    case 4:
      if (!parse_struct_body(p, ni, c, nullptr, false)) {
        c.fail = true;
        return false;
      }
      return true;
    case 5:
      return parse_list_value(p, nd, c, p->g_sval) && !c.fail;
    case 6:
      return parse_list_node(p, ni, c);
    default:
      return parse_scalar_value(p, nd, c);
  }
}

// layout-driven row parse; returns false on ANY deviation (caller rolls
// back and reparses on the general path).  Appends exactly one entry per
// schema node on success.
bool fast_row(Parser* p, const uint8_t* b, const uint8_t* e) {
  Layout& L = p->layout;
  const uint8_t* q = b;
  const size_t n = L.tok.size();
  for (size_t i = 0; i < n; i++) {
    const std::string& t = L.tok[i];
    if ((size_t)(e - q) < t.size() || memcmp(q, t.data(), t.size()) != 0)
      return false;
    q += t.size();
    const int ci = L.col[i];
    if (ci < 0) {
      Cursor c{q, e};
      if (!skip_value(c) || c.fail) return false;
      q = c.p;
      continue;
    }
    Node& nd = p->nodes[ci];
    if ((size_t)(e - q) >= 4 && memcmp(q, "null", 4) == 0) {
      q += 4;
      push_null_recursive(p, ci);
      continue;
    }
    switch (nd.type) {
      case 0: {
        int64_t v;
        if (!parse_i64_at(q, e, v)) return false;
        nd.i64.push_back(v);
        break;
      }
      case 1: {
        double v;
        if (!parse_f64_at(q, e, v)) return false;
        nd.f64.push_back(v);
        break;
      }
      case 2: {
        if ((size_t)(e - q) >= 4 && memcmp(q, "true", 4) == 0) {
          q += 4;
          nd.b.push_back(1);
        } else if ((size_t)(e - q) >= 5 && memcmp(q, "false", 5) == 0) {
          q += 5;
          nd.b.push_back(0);
        } else {
          return false;
        }
        break;
      }
      case 3: {
        if (q >= e || *q != '"') return false;
        const uint8_t* s = q + 1;
        const uint8_t* close = (const uint8_t*)memchr(s, '"', e - s);
        if (!close) return false;
        if (memchr(s, '\\', close - s) != nullptr) {
          // escape present: the first '"' may itself be escaped — use the
          // full unescaping parser for this value
          Cursor c{s, e};
          std::string sval;
          if (!parse_string(c, sval)) return false;
          nd.str_bytes.insert(nd.str_bytes.end(), sval.begin(),
                              sval.end());
          q = c.p;
        } else {
          nd.str_bytes.insert(nd.str_bytes.end(), s, close);
          q = close + 1;
        }
        nd.str_offsets.push_back(nd.str_bytes.size());
        break;
      }
      case 5: {
        Cursor c{q, e};
        if (!parse_list_value(p, nd, c, p->g_sval) || c.fail) return false;
        q = c.p;
        continue;  // parse_list_value pushed valid itself
      }
      case 6: {
        Cursor c{q, e};
        if (!parse_list_node(p, ci, c) || c.fail) return false;
        q = c.p;
        continue;  // parse_list_node pushed valid itself
      }
      default:
        return false;  // struct nodes are never layout units
    }
    nd.valid.push_back(1);
  }
  if ((size_t)(e - q) != L.tail.size() ||
      memcmp(q, L.tail.data(), L.tail.size()) != 0)
    return false;
  for (int ni : L.present) p->nodes[ni].valid.push_back(1);
  for (int ni : L.missing) push_null_recursive(p, ni);
  return true;
}

// capture the layout of a row the general path just parsed successfully
void adopt_layout(Parser* p, const uint8_t* b, const uint8_t* e) {
  Layout& L = p->layout;
  L.valid = false;
  if (!p->d_ok || p->d_vs.empty()) return;  // dup keys / no units
  const size_t n = p->d_vs.size();
  L.tok.resize(n);
  L.tok[0].assign((const char*)b, p->d_vs[0]);
  for (size_t i = 1; i < n; i++)
    L.tok[i].assign((const char*)b + p->d_ve[i - 1],
                    p->d_vs[i] - p->d_ve[i - 1]);
  L.tail.assign((const char*)b + p->d_ve[n - 1],
                (size_t)(e - b) - p->d_ve[n - 1]);
  L.col = p->d_col;
  L.present = p->d_present;
  L.missing = p->d_missing;
  L.valid = true;
  // NOTE: fail_streak is deliberately NOT reset here — it resets only on
  // a fast-row success.  Re-adopting after every general-path row would
  // otherwise zero the streak each time and the mixed-shape kill-switch
  // in jp_parse could never fire.
}

// general-path parse of one struct BODY (cursor at '{'); ni = -1 for the
// row root (children = p->top).  With ``discover`` set (row-scope
// structs) it fills the discovery scratch for adopt_layout: unit spans
// for scalar leaves + whole lists, present/missing node sets.  Struct
// values inside generic-list elements parse with discover=false — the
// enclosing list is already one opaque layout unit — and clear their
// direct kids' seen marks on entry, because the same schema node is
// instantiated once per ELEMENT within a single row.
bool parse_struct_body(Parser* p, int ni, Cursor& c, const uint8_t* b,
                       bool discover) {
  const std::vector<int>& kids = ni < 0 ? p->top : p->nodes[ni].kids;
  std::string& key = p->g_key;
  if (!c.eat('{')) return false;
  for (int k : kids) p->g_seen[k] = 0;
  if (ni >= 0) {
    p->nodes[ni].valid.push_back(1);
    if (discover) p->d_present.push_back(ni);
  }
  if (!c.peek('}')) {
    for (;;) {
      if (!c.eat('"')) return false;
      if (!parse_string(c, key)) { c.fail = true; return false; }
      if (!c.eat(':')) return false;
      int ci = -1;
      for (int k : kids)
        if (p->nodes[k].name == key) { ci = k; break; }
      c.ws();
      if (ci < 0) {
        // unknown key: skip — and record it as a col=-1 layout unit so a
        // producer whose undeclared field VARIES byte-to-byte (uuid,
        // trace id) still gets the fast path (fast_row re-skips the
        // value generically at that position instead of memcmp-failing)
        if (discover) {
          p->d_vs.push_back((size_t)(c.p - b));
          p->d_col.push_back(-1);
        }
        if (!skip_value(c)) { c.fail = true; return false; }
        if (discover) p->d_ve.push_back((size_t)(c.p - b));
      } else {
        Node& nd = p->nodes[ci];
        if (p->g_seen[ci]) {
          // duplicate key: last-wins (match json.loads dict semantics) —
          // drop the whole subtree stored for the earlier occurrence.
          // (Stale d_present/d_missing entries from it don't matter:
          // d_ok=false suppresses layout adoption for this row.)
          if (discover) p->d_ok = false;  // fast path can't reproduce dups
          pop_row_subtree(p, ci);
        }
        p->g_seen[ci] = 1;
        bool is_null = false;
        if (c.end - c.p >= 4 && memcmp(c.p, "null", 4) == 0) {
          c.p += 4;
          is_null = true;
        }
        if (is_null) {
          push_null_recursive(p, ci);
          if (discover) p->d_missing.push_back(ci);
        } else if (nd.type == 4) {
          if (!parse_struct_body(p, ci, c, b, discover)) {
            c.fail = true;
            return false;
          }
        } else if (nd.type == 5 || nd.type == 6) {
          if (discover) {
            p->d_vs.push_back((size_t)(c.p - b));
            p->d_col.push_back(ci);
          }
          bool ok = nd.type == 5
                        ? parse_list_value(p, nd, c, p->g_sval) && !c.fail
                        : parse_list_node(p, ci, c);
          if (!ok) {
            c.fail = true;
            return false;
          }
          if (discover) p->d_ve.push_back((size_t)(c.p - b));
        } else {
          if (discover) {
            p->d_vs.push_back((size_t)(c.p - b));
            p->d_col.push_back(ci);
          }
          if (!parse_scalar_value(p, nd, c)) return false;
          if (discover) p->d_ve.push_back((size_t)(c.p - b));
        }
      }
      c.ws();
      if (c.peek(',')) { c.p++; continue; }
      break;
    }
    if (!c.eat('}')) return false;
  } else {
    c.p++;  // consume '}'
  }
  // missing children → null (recursively)
  for (int k : kids)
    if (!p->g_seen[k]) {
      push_null_recursive(p, k);
      if (discover) p->d_missing.push_back(k);
    }
  return true;
}

// the general (any-shape) row parse
bool parse_row_general(Parser* p, const uint8_t* b, const uint8_t* e,
                       uint64_t r) {
  p->g_seen.assign(p->nodes.size(), 0);
  p->d_vs.clear();
  p->d_ve.clear();
  p->d_col.clear();
  p->d_present.clear();
  p->d_missing.clear();
  p->d_ok = true;

  Cursor probe{b, e};
  probe.ws();
  const bool is_object = probe.p < probe.end && *probe.p == '{';
  Cursor c{b, e};
  if (!parse_struct_body(p, -1, c, b, true)) {
    rollback_row(p, p->nrows);
    p->error = (is_object ? "malformed JSON at row "
                          : "expected '{' at row ") +
               std::to_string(r);
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

// flat ABI (top-level scalar columns only) — kept for the historical
// callers; a flat schema is just a tree whose nodes are all top-level
void* jp_create(int ncols, const char** names, const int* types) {
  Parser* p = new Parser();
  p->nodes.resize(ncols);
  for (int i = 0; i < ncols; i++) {
    p->nodes[i].name = names[i];
    p->nodes[i].type = types[i];
    p->nodes[i].str_offsets.push_back(0);
    p->top.push_back(i);
  }
  return p;
}

// full schema tree.  nodes come in any order with parent[i] either -1
// (top-level field, order significant) or the index of a struct node /
// a type-6 list node (whose single child is its element subtree).
// types: 0..3 scalar, 4 struct, 5 list-of-scalar with elem_types[i]
// 0..3, 6 generic list.
void* jp_create_tree(int nnodes, const char** names, const int* types,
                     const int* elem_types, const int* parents) {
  Parser* p = new Parser();
  p->nodes.resize(nnodes);
  for (int i = 0; i < nnodes; i++) {
    Node& nd = p->nodes[i];
    nd.name = names[i];
    nd.type = types[i];
    nd.elem_type = elem_types[i];
    nd.str_offsets.push_back(0);
    nd.list_offsets.assign((nd.type == 5 || nd.type == 6) ? 1 : 0, 0);
    if (parents[i] < 0)
      p->top.push_back(i);
    else
      p->nodes[parents[i]].kids.push_back(i);
  }
  return p;
}

void jp_clear(void* h) {
  Parser* p = static_cast<Parser*>(h);
  p->nrows = 0;
  p->error.clear();
  for (auto& nd : p->nodes) {
    nd.i64.clear();
    nd.f64.clear();
    nd.b.clear();
    nd.valid.clear();
    nd.str_bytes.clear();
    nd.str_offsets.assign(1, 0);
    nd.evalid.clear();
    if (nd.type == 5 || nd.type == 6) nd.list_offsets.assign(1, 0);
  }
}

// returns 0 on success, -1 on parse error (see jp_error)
int jp_parse(void* h, const uint8_t* data, const uint64_t* offsets,
             uint64_t nrows) {
  Parser* p = static_cast<Parser*>(h);
  for (auto& nd : p->nodes) {
    nd.valid.reserve(nd.valid.size() + nrows);
    switch (nd.type) {
      case 0: nd.i64.reserve(nd.i64.size() + nrows); break;
      case 1: nd.f64.reserve(nd.f64.size() + nrows); break;
      case 2: nd.b.reserve(nd.b.size() + nrows); break;
      case 3:
        nd.str_offsets.reserve(nd.str_offsets.size() + nrows);
        break;
      case 5:
      case 6:
        nd.list_offsets.reserve(nd.list_offsets.size() + nrows);
        break;
    }
  }
  for (uint64_t r = 0; r < nrows; r++) {
    const uint8_t* b = data + offsets[r];
    const uint8_t* e = data + offsets[r + 1];
    if (p->layout.valid) {
      if (fast_row(p, b, e)) {
        p->layout.fail_streak = 0;
        p->nrows++;
        continue;
      }
      rollback_row(p, p->nrows);
      // a producer whose shape keeps missing the layout (mixed styles,
      // varying key sets) must not pay fast-attempt + rollback + layout
      // re-adoption per row forever: after 8 straight misses, disable
      // the fast path and suppress re-adoption for a stretch of rows
      if (++p->layout.fail_streak >= 8) {
        p->layout.valid = false;
        p->layout.fail_streak = 0;
        p->adopt_cooldown = 256;
      }
    }
    if (!parse_row_general(p, b, e, r)) return -1;
    if (p->adopt_cooldown > 0)
      p->adopt_cooldown--;
    else
      adopt_layout(p, b, e);
    p->nrows++;
  }
  return 0;
}

const char* jp_error(void* h) {
  return static_cast<Parser*>(h)->error.c_str();
}

uint64_t jp_nrows(void* h) { return static_cast<Parser*>(h)->nrows; }

const int64_t* jp_col_i64(void* h, int col) {
  return static_cast<Parser*>(h)->nodes[col].i64.data();
}
const double* jp_col_f64(void* h, int col) {
  return static_cast<Parser*>(h)->nodes[col].f64.data();
}
const uint8_t* jp_col_bool(void* h, int col) {
  return static_cast<Parser*>(h)->nodes[col].b.data();
}
const uint8_t* jp_col_valid(void* h, int col) {
  return static_cast<Parser*>(h)->nodes[col].valid.data();
}
const uint8_t* jp_col_str_bytes(void* h, int col, uint64_t* nbytes) {
  Node& c = static_cast<Parser*>(h)->nodes[col];
  *nbytes = c.str_bytes.size();
  return c.str_bytes.data();
}
const uint64_t* jp_col_str_offsets(void* h, int col) {
  return static_cast<Parser*>(h)->nodes[col].str_offsets.data();
}
// list node accessors: per-row offsets (nrows+1), element validity, and
// element count; element VALUES come through the scalar getters above
// (a list node stores its elements in its own value vectors)
const uint64_t* jp_col_list_offsets(void* h, int col) {
  return static_cast<Parser*>(h)->nodes[col].list_offsets.data();
}
const uint8_t* jp_col_list_evalid(void* h, int col) {
  return static_cast<Parser*>(h)->nodes[col].evalid.data();
}
uint64_t jp_col_list_nelems(void* h, int col) {
  return list_elems(static_cast<Parser*>(h)->nodes[col]);
}
int64_t jp_col_str_dict(void* h, int col) {
  Parser* p = static_cast<Parser*>(h);
  Node& c = p->nodes[col];
  // entry count: packed scalar-list elements live in the list node's own
  // vectors; every other node (including string nodes under a generic
  // list) pushes one valid byte per entry
  uint64_t n = c.type == 5 ? list_elems(c) : c.valid.size();
  return build_str_dict(c.str_bytes, c.str_offsets, n, c.dict);
}
const int32_t* jp_col_str_dict_codes(void* h, int col) {
  return static_cast<Parser*>(h)->nodes[col].dict.codes.data();
}
const uint8_t* jp_col_str_dict_bytes(void* h, int col, uint64_t* nbytes) {
  StrDict& d = static_cast<Parser*>(h)->nodes[col].dict;
  *nbytes = d.bytes.size();
  return d.bytes.data();
}
const uint64_t* jp_col_str_dict_offsets(void* h, int col) {
  return static_cast<Parser*>(h)->nodes[col].dict.offsets.data();
}

void jp_destroy(void* h) { delete static_cast<Parser*>(h); }

}  // extern "C"
