// Shared dictionary-encoding of a parsed string column, used by both
// columnar parsers (json_parser.cpp / avro_parser.cpp).  Python-side
// string materialization was a per-row slice+decode loop — the dominant
// host cost of the Kafka e2e ingest path at 1M+ rows/s; with dict codes
// the wrapper decodes each DISTINCT value once and fans out with one
// vectorized take (formats/_native_parser_base.py).
#pragma once
#include <cstdint>
#include <string_view>
#include <unordered_map>
#include <vector>

struct StrDict {
  std::vector<int32_t> codes;     // nrows
  std::vector<uint8_t> bytes;     // concatenated unique values
  std::vector<uint64_t> offsets;  // n_uniq + 1
};

// Build ``d`` from a column's (bytes, offsets) pair; returns the number
// of distinct values, or -1 when the column is effectively unique
// (distincts exceed half the rows) — dictionary encoding would then cost
// MORE than the caller's direct per-row decode (hash + byte copy + fanout
// on top of ~n decodes), so the caller falls back.  string_view keys
// alias str_bytes, which is stable for the duration of the call.
inline int64_t build_str_dict(const std::vector<uint8_t>& str_bytes,
                              const std::vector<uint64_t>& offs,
                              uint64_t nrows, StrDict& d) {
  d.codes.clear();
  d.bytes.clear();
  d.offsets.assign(1, 0);
  d.codes.reserve(nrows);
  const uint64_t max_uniq = nrows / 2 + 1;
  std::unordered_map<std::string_view, int32_t> m;
  const char* base = reinterpret_cast<const char*>(str_bytes.data());
  for (uint64_t i = 0; i < nrows; ++i) {
    std::string_view sv(base + offs[i],
                        static_cast<size_t>(offs[i + 1] - offs[i]));
    auto it = m.find(sv);
    int32_t code;
    if (it == m.end()) {
      if (m.size() >= max_uniq) return -1;  // high cardinality: bail
      code = static_cast<int32_t>(m.size());
      m.emplace(sv, code);
      d.bytes.insert(d.bytes.end(), sv.begin(), sv.end());
      d.offsets.push_back(d.bytes.size());
    } else {
      code = it->second;
    }
    d.codes.push_back(code);
  }
  return static_cast<int64_t>(d.offsets.size() - 1);
}
