// avro_parser — one-pass Avro-binary → columnar decoder.
//
// The reference's Avro decode is native (Rust apache-avro through
// DataFusion's avro_to_arrow, crates/core/src/formats/decoders/avro.rs:11-54);
// this is our native equivalent, built like json_parser.cpp: the caller
// hands an arena of concatenated record payloads + offsets (typically the
// Kafka fetch arena, zero-copy) and reads back columnar buffers.
//
// Avro records are positional — no key matching, just the schema's field
// order — so the schema TREE drives the byte walk directly: [nullable-union
// branch varint] then the value per the node type.  Node types:
//   0 = int/long/timestamp-millis (zigzag varint → i64)
//   1 = double (8B IEEE LE → f64)
//   2 = boolean (1 byte)
//   3 = string/bytes (length varint + raw)
//   4 = float (4B IEEE LE, widened to f64 storage)
//   5 = record (struct): presence byte per entry, children positional
//   6 = array (list): block-encoded per the spec (series of counts, 0
//       terminates, negative count + block byte size); the single child
//       node stores one entry per ELEMENT, so nested records and nested
//       arrays shred recursively — the same node layout json_parser.cpp
//       uses for its generic lists.
// Nullable nodes are the ["null", T] union (branch 0 = null, branch 1 =
// value) — the only union shape the native path admits; anything else
// (maps, enums, fixed, general unions) routes to the Python decoder.
//
// ``ap_create`` keeps the historical flat ABI (top-level scalar columns
// only); ``ap_create_tree`` takes the full schema tree.  C ABI for
// ctypes; one parser object per schema; not thread-safe.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include "str_dict.hpp"
#include <vector>

namespace {

// One schema-tree node.  An "entry" is a row for top-level nodes and
// record descendants, and an element for nodes under an array — every
// node appends exactly one `valid` byte per entry, so `valid.size()` is
// always a node's entry count (the invariant rollback relies on).
struct ANode {
  int type;      // 0 i64 | 1 f64 | 2 bool | 3 str | 4 f32 | 5 struct | 6 list
  int nullable;  // ["null", T] union branch varint precedes the value
  std::vector<int> kids;  // record children (field order) / array element
  std::vector<int64_t> i64;
  std::vector<double> f64;
  std::vector<uint8_t> b;
  std::vector<uint8_t> valid;
  std::vector<uint8_t> str_bytes;
  std::vector<uint64_t> str_offsets;   // nentries+1
  std::vector<uint64_t> list_offsets;  // list: nentries+1
  StrDict dict;
};

struct AvroParser {
  std::vector<ANode> nodes;
  std::vector<int> top;  // top-level field nodes, schema order
  std::string error;
  uint64_t nrows = 0;
  // cumulative array-element budget for the record being parsed: the
  // per-block cap below bounds one block against remaining BYTES, but
  // zero-byte items (empty-record elements, and nested arrays of them)
  // make unlimited blocks free — this caps total decoded elements per
  // record at a small multiple of its wire size (mirrored by the Python
  // decoder's _decode_blocks budget)
  uint64_t elem_budget = 0;
};

struct Cur {
  const uint8_t* p;
  const uint8_t* end;
  bool fail = false;
};

// Avro long: zigzag base-128 varint (spec "binary encoding")
int64_t read_varint(Cur& c) {
  uint64_t acc = 0;
  int shift = 0;
  while (c.p < c.end) {
    uint8_t b = *c.p++;
    acc |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80))
      return (int64_t)((acc >> 1) ^ (~(acc & 1) + 1));
    shift += 7;
    if (shift > 63) break;
  }
  c.fail = true;
  return 0;
}

inline uint64_t list_elems(const ANode& nd) {
  return nd.list_offsets.empty() ? 0 : nd.list_offsets.back();
}

void push_null_scalar(ANode& nd) {
  nd.valid.push_back(0);
  switch (nd.type) {
    case 0: nd.i64.push_back(0); break;
    case 1:
    case 4: nd.f64.push_back(0); break;  // float shares the f64 store
    case 2: nd.b.push_back(0); break;
    case 3: nd.str_offsets.push_back(nd.str_bytes.size()); break;
  }
}

// append one null entry to node ni and (for records) every descendant
// (a null array leaves its child untouched — zero elements)
void push_null_recursive(AvroParser* p, int ni) {
  ANode& nd = p->nodes[ni];
  switch (nd.type) {
    case 5:
      nd.valid.push_back(0);
      for (int k : nd.kids) push_null_recursive(p, k);
      break;
    case 6:
      nd.valid.push_back(0);
      nd.list_offsets.push_back(list_elems(nd));
      break;
    default:
      push_null_scalar(nd);
  }
}

// resize node ni and its whole subtree down to exactly `count` entries
// (row rollback: size bookkeeping only, no reallocation)
void trim_node(AvroParser* p, int ni, uint64_t count) {
  ANode& nd = p->nodes[ni];
  nd.valid.resize(count);
  switch (nd.type) {
    case 0: nd.i64.resize(count); break;
    case 1:
    case 4: nd.f64.resize(count); break;
    case 2: nd.b.resize(count); break;
    case 3:
      nd.str_offsets.resize(count + 1);
      nd.str_bytes.resize(nd.str_offsets.back());
      break;
    case 5:
      for (int k : nd.kids) trim_node(p, k, count);
      break;
    case 6:
      nd.list_offsets.resize(count + 1);
      trim_node(p, nd.kids[0], nd.list_offsets.back());
      break;
  }
}

bool parse_value(AvroParser* p, int ni, Cur& c);

// block-encoded array (spec §complex types): series of item counts until
// a 0 count; a negative count is followed by the block's byte size (we
// decode items either way).  Counts are capped against the bytes actually
// remaining — without the cap a 5-byte payload declaring 2^30 null items
// would allocate gigabytes off one malicious Kafka message (the same
// bound the Python decoder's _decode_blocks enforces).
bool parse_array(AvroParser* p, int ni, Cur& c) {
  ANode& nd = p->nodes[ni];
  const int kid = nd.kids[0];
  for (;;) {
    int64_t count = read_varint(c);
    if (c.fail) return false;
    if (count == 0) break;
    if (count < 0) {
      count = -count;
      read_varint(c);  // block byte size — items are decoded anyway
      if (c.fail) return false;
    }
    int64_t remaining = (int64_t)(c.end - c.p);
    int64_t cap = 2 * (remaining + 1);
    if (count > (cap > 65536 ? cap : 65536)) return false;
    if ((uint64_t)count > p->elem_budget) return false;  // cumulative bomb
    p->elem_budget -= (uint64_t)count;
    for (int64_t i = 0; i < count; i++)
      if (!parse_value(p, kid, c)) return false;
  }
  nd.list_offsets.push_back(p->nodes[kid].valid.size());
  nd.valid.push_back(1);
  return true;
}

// parse one value into node ni (appends exactly one entry to its subtree)
bool parse_value(AvroParser* p, int ni, Cur& c) {
  ANode& nd = p->nodes[ni];
  if (nd.nullable) {
    int64_t branch = read_varint(c);
    if (c.fail) return false;
    if (branch == 0) {
      push_null_recursive(p, ni);
      return true;
    }
    if (branch != 1) return false;  // only ["null", T]
  }
  switch (nd.type) {
    case 0: {
      int64_t v = read_varint(c);
      if (c.fail) return false;
      nd.i64.push_back(v);
      nd.valid.push_back(1);
      return true;
    }
    case 1: {  // double: 8-byte IEEE LE
      if (c.p + 8 > c.end) return false;
      double v;
      memcpy(&v, c.p, 8);
      c.p += 8;
      nd.f64.push_back(v);
      nd.valid.push_back(1);
      return true;
    }
    case 4: {  // float: 4-byte IEEE LE, widened to f64 storage
      if (c.p + 4 > c.end) return false;
      float v;
      memcpy(&v, c.p, 4);
      c.p += 4;
      nd.f64.push_back((double)v);
      nd.valid.push_back(1);
      return true;
    }
    case 2: {
      if (c.p >= c.end) return false;
      nd.b.push_back(*c.p++ ? 1 : 0);
      nd.valid.push_back(1);
      return true;
    }
    case 3: {
      int64_t n = read_varint(c);
      if (c.fail || n < 0 || c.p + n > c.end) return false;
      nd.str_bytes.insert(nd.str_bytes.end(), c.p, c.p + n);
      c.p += n;
      nd.str_offsets.push_back(nd.str_bytes.size());
      nd.valid.push_back(1);
      return true;
    }
    case 5: {  // record: children in declared order
      nd.valid.push_back(1);
      for (int k : nd.kids)
        if (!parse_value(p, k, c)) return false;
      return true;
    }
    case 6:
      return parse_array(p, ni, c);
    default:
      return false;
  }
}

bool parse_record_root(AvroParser* p, Cur& c) {
  for (int ni : p->top)
    if (!parse_value(p, ni, c)) return false;
  // trailing bytes after the last field = corrupt/mismatched schema
  return c.p == c.end;
}

void rollback_row(AvroParser* p, uint64_t nr) {
  for (int ni : p->top) trim_node(p, ni, nr);
}

}  // namespace

extern "C" {

// flat ABI (top-level scalar columns only) — kept for the historical
// callers; types[i]: 0 i64(varint) | 1 f64(8B) | 4 f32(4B stored as f64)
// | 2 bool | 3 string/bytes; nullables[i]: 1 = ["null", T] union-prefixed
void* ap_create(int ncols, const int* types, const int* nullables) {
  AvroParser* p = new AvroParser();
  p->nodes.resize(ncols);
  for (int i = 0; i < ncols; i++) {
    p->nodes[i].type = types[i];
    p->nodes[i].nullable = nullables[i];
    p->nodes[i].str_offsets.assign(1, 0);
    p->top.push_back(i);
  }
  return p;
}

// full schema tree.  nodes come in any order with parent[i] either -1
// (top-level field, order significant) or the index of a record node /
// an array node (whose single child is its element subtree).
void* ap_create_tree(int nnodes, const int* types, const int* nullables,
                     const int* parents) {
  AvroParser* p = new AvroParser();
  p->nodes.resize(nnodes);
  for (int i = 0; i < nnodes; i++) {
    ANode& nd = p->nodes[i];
    nd.type = types[i];
    nd.nullable = nullables[i];
    nd.str_offsets.assign(1, 0);
    nd.list_offsets.assign(nd.type == 6 ? 1 : 0, 0);
    if (parents[i] < 0)
      p->top.push_back(i);
    else
      p->nodes[parents[i]].kids.push_back(i);
  }
  return p;
}

void ap_destroy(void* h) { delete static_cast<AvroParser*>(h); }

void ap_clear(void* h) {
  AvroParser* p = static_cast<AvroParser*>(h);
  p->nrows = 0;
  p->error.clear();
  for (auto& nd : p->nodes) {
    nd.i64.clear();
    nd.f64.clear();
    nd.b.clear();
    nd.valid.clear();
    nd.str_bytes.clear();
    nd.str_offsets.assign(1, 0);
    if (nd.type == 6) nd.list_offsets.assign(1, 0);
  }
}

const char* ap_error(void* h) {
  return static_cast<AvroParser*>(h)->error.c_str();
}

uint64_t ap_nrows(void* h) { return static_cast<AvroParser*>(h)->nrows; }

// parse n records from the arena; offsets has n+1 entries
int ap_parse(void* h, const void* data, const uint64_t* offsets, uint64_t n) {
  AvroParser* p = static_cast<AvroParser*>(h);
  const uint8_t* base = (const uint8_t*)data;
  for (uint64_t i = 0; i < n; i++) {
    Cur c{base + offsets[i], base + offsets[i + 1]};
    uint64_t rec_len = offsets[i + 1] - offsets[i];
    uint64_t budget = 4 * rec_len;
    p->elem_budget = budget > 65536 ? budget : 65536;
    uint64_t row = p->nrows;
    if (!parse_record_root(p, c)) {
      rollback_row(p, row);
      char msg[96];
      snprintf(msg, sizeof msg,
               "malformed Avro record at index %llu (offset %llu)",
               (unsigned long long)i, (unsigned long long)offsets[i]);
      p->error = msg;
      return -1;
    }
    p->nrows++;
  }
  return 0;
}

const int64_t* ap_col_i64(void* h, int ci) {
  return static_cast<AvroParser*>(h)->nodes[ci].i64.data();
}
const double* ap_col_f64(void* h, int ci) {
  return static_cast<AvroParser*>(h)->nodes[ci].f64.data();
}
const uint8_t* ap_col_bool(void* h, int ci) {
  return static_cast<AvroParser*>(h)->nodes[ci].b.data();
}
const uint8_t* ap_col_valid(void* h, int ci) {
  return static_cast<AvroParser*>(h)->nodes[ci].valid.data();
}
const uint64_t* ap_col_str_offsets(void* h, int ci) {
  return static_cast<AvroParser*>(h)->nodes[ci].str_offsets.data();
}
const uint8_t* ap_col_str_bytes(void* h, int ci, uint64_t* nbytes) {
  ANode& c = static_cast<AvroParser*>(h)->nodes[ci];
  *nbytes = c.str_bytes.size();
  return c.str_bytes.data();
}
// list node accessors: per-entry offsets (nentries+1) and element count;
// element values live in the child node (one entry per element), reached
// through the scalar getters above with the child's node index.
// ap_col_list_evalid exists to satisfy the shared ctypes configuration —
// Avro lists are always child-node based (element validity is the
// child's own valid vector), so it returns that child vector.
const uint64_t* ap_col_list_offsets(void* h, int ci) {
  return static_cast<AvroParser*>(h)->nodes[ci].list_offsets.data();
}
const uint8_t* ap_col_list_evalid(void* h, int ci) {
  AvroParser* p = static_cast<AvroParser*>(h);
  ANode& nd = p->nodes[ci];
  if (nd.kids.empty()) return nullptr;
  return p->nodes[nd.kids[0]].valid.data();
}
uint64_t ap_col_list_nelems(void* h, int ci) {
  return list_elems(static_cast<AvroParser*>(h)->nodes[ci]);
}
int64_t ap_col_str_dict(void* h, int ci) {
  AvroParser* p = static_cast<AvroParser*>(h);
  ANode& c = p->nodes[ci];
  // entry count == valid.size() for every node (rows at top level,
  // elements under an array)
  return build_str_dict(c.str_bytes, c.str_offsets, c.valid.size(), c.dict);
}
const int32_t* ap_col_str_dict_codes(void* h, int ci) {
  return static_cast<AvroParser*>(h)->nodes[ci].dict.codes.data();
}
const uint8_t* ap_col_str_dict_bytes(void* h, int ci, uint64_t* nbytes) {
  StrDict& d = static_cast<AvroParser*>(h)->nodes[ci].dict;
  *nbytes = d.bytes.size();
  return d.bytes.data();
}
const uint64_t* ap_col_str_dict_offsets(void* h, int ci) {
  return static_cast<AvroParser*>(h)->nodes[ci].dict.offsets.data();
}

}  // extern "C"
