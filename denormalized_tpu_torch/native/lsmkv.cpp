// lsmkv — log-structured KV store backing checkpoints.
//
// Native (C++) counterpart of the reference's SlateDB state backend
// (crates/core/src/state_backend/slatedb.rs:28-92: an LSM on object storage
// with async fire-and-forget put, awaited get, close) and the dormant
// RocksDB backend (state_backend/rocksdb_backend.rs).  Design:
//
//   - append-only segment files  seg-<n>.log  of records:
//       [u32 crc][u32 klen][u32 vlen][u8 tombstone][key][value]
//     crc32 covers klen..value.  Torn tails are truncated on recovery.
//   - in-memory index: key -> (segment, offset, vlen) built by replaying
//     segments in order on open.
//   - writes go to the active segment; fsync on flush()/close() (puts are
//     fire-and-forget at the API level, like the reference's spawned put).
//   - compact() rewrites live entries into a fresh segment and unlinks old
//     ones once the index is swapped.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).  All calls are
// thread-safe behind one mutex — the checkpoint path is not contended.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dirent.h>
#include <map>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};

uint32_t crc32(const uint8_t* data, size_t len, uint32_t crc = 0) {
  // C++11 magic static: thread-safe one-time init (plain `static bool`
  // guards race when two stores are used from different threads)
  static const Crc32Table table;
  crc = ~crc;
  for (size_t i = 0; i < len; i++)
    crc = table.t[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

struct Entry {
  uint32_t segment;
  uint64_t offset;  // offset of the value payload in the segment file
  uint32_t vlen;
};

struct Store {
  std::string dir;
  std::map<std::string, Entry> index;
  FILE* active = nullptr;
  uint32_t active_seg = 0;
  uint64_t active_size = 0;
  std::mutex mu;

  std::string seg_path(uint32_t n) const {
    char buf[32];
    snprintf(buf, sizeof buf, "/seg-%08u.log", n);
    return dir + buf;
  }
};

bool replay_segment(Store* s, uint32_t seg) {
  std::string path = s->seg_path(seg);
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  uint64_t off = 0;
  std::vector<uint8_t> buf;
  for (;;) {
    uint8_t hdr[13];
    if (fread(hdr, 1, 13, f) != 13) break;
    uint32_t crc, klen, vlen;
    memcpy(&crc, hdr, 4);
    memcpy(&klen, hdr + 4, 4);
    memcpy(&vlen, hdr + 8, 4);
    uint8_t tomb = hdr[12];
    if (klen > (1u << 24) || vlen > (1u << 30)) break;  // corrupt header
    buf.resize(9 + klen + vlen);
    memcpy(buf.data(), hdr + 4, 9);
    if (fread(buf.data() + 9, 1, klen + vlen, f) != klen + vlen) break;
    if (crc32(buf.data(), buf.size()) != crc) break;  // torn/corrupt tail
    std::string key(reinterpret_cast<char*>(buf.data() + 9), klen);
    if (tomb) {
      s->index.erase(key);
    } else {
      s->index[key] = Entry{seg, off + 13 + klen, vlen};
    }
    off += 13 + klen + vlen;
  }
  // a torn tail is simply ignored: writers always append to a FRESH segment
  // after recovery (lsm_open bumps active_seg), so the tail is never
  // extended and CRC replay keeps skipping it
  fclose(f);
  return true;
}

int append_record(Store* s, const std::string& key, const uint8_t* val,
                  uint32_t vlen, bool tombstone) {
  uint32_t klen = (uint32_t)key.size();
  std::vector<uint8_t> rec(13 + klen + vlen);
  memcpy(rec.data() + 4, &klen, 4);
  memcpy(rec.data() + 8, &vlen, 4);
  rec[12] = tombstone ? 1 : 0;
  memcpy(rec.data() + 13, key.data(), klen);
  if (vlen) memcpy(rec.data() + 13 + klen, val, vlen);
  uint32_t crc = crc32(rec.data() + 4, rec.size() - 4);
  memcpy(rec.data(), &crc, 4);
  if (fwrite(rec.data(), 1, rec.size(), s->active) != rec.size()) return -1;
  uint64_t payload_off = s->active_size + 13 + klen;
  if (tombstone) {
    s->index.erase(key);
  } else {
    s->index[key] = Entry{s->active_seg, payload_off, vlen};
  }
  s->active_size += rec.size();
  return 0;
}

}  // namespace

extern "C" {

void* lsm_open(const char* dir) {
  mkdir(dir, 0755);
  Store* s = new Store();
  s->dir = dir;
  // discover segments
  std::vector<uint32_t> segs;
  if (DIR* d = opendir(dir)) {
    while (dirent* e = readdir(d)) {
      unsigned n;
      if (sscanf(e->d_name, "seg-%08u.log", &n) == 1) segs.push_back(n);
    }
    closedir(d);
  }
  std::sort(segs.begin(), segs.end());
  s->active_seg = segs.empty() ? 0 : segs.back();
  for (uint32_t seg : segs) replay_segment(s, seg);
  // new writers append to a fresh segment to avoid truncation races
  s->active_seg = segs.empty() ? 0 : segs.back() + 1;
  s->active_size = 0;
  s->active = fopen(s->seg_path(s->active_seg).c_str(), "ab");
  if (!s->active) {
    delete s;
    return nullptr;
  }
  return s;
}

int lsm_put(void* h, const uint8_t* key, uint32_t klen, const uint8_t* val,
            uint32_t vlen) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return append_record(s, std::string((const char*)key, klen), val, vlen,
                       false);
}

int lsm_delete(void* h, const uint8_t* key, uint32_t klen) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return append_record(s, std::string((const char*)key, klen), nullptr, 0,
                       true);
}

// Returns vlen and writes a malloc'd buffer into *val (caller must
// lsm_free it); returns -1 if the key is absent.
int64_t lsm_get(void* h, const uint8_t* key, uint32_t klen, uint8_t** val) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->index.find(std::string((const char*)key, klen));
  if (it == s->index.end()) return -1;
  const Entry& e = it->second;
  uint8_t* out = (uint8_t*)malloc(e.vlen ? e.vlen : 1);
  if (e.segment == s->active_seg) fflush(s->active);
  FILE* f = fopen(s->seg_path(e.segment).c_str(), "rb");
  if (!f) {
    free(out);
    return -1;
  }
  fseeko(f, (off_t)e.offset, SEEK_SET);
  size_t got = fread(out, 1, e.vlen, f);
  fclose(f);
  if (got != e.vlen) {
    free(out);
    return -1;
  }
  *val = out;
  return (int64_t)e.vlen;
}

void lsm_free(uint8_t* p) { free(p); }

int lsm_flush(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (fflush(s->active) != 0) return -1;
  return fsync(fileno(s->active));
}

// number of live keys
uint64_t lsm_count(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->index.size();
}

// list keys as \n-joined buffer (malloc'd); for debugging/tests
int64_t lsm_keys(void* h, uint8_t** out) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::string all;
  for (auto& kv : s->index) {
    all += kv.first;
    all += '\n';
  }
  uint8_t* buf = (uint8_t*)malloc(all.size() ? all.size() : 1);
  memcpy(buf, all.data(), all.size());
  *out = buf;
  return (int64_t)all.size();
}

// rewrite live entries into a fresh segment, unlink old ones
int lsm_compact(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  fflush(s->active);
  uint32_t new_seg = s->active_seg + 1;
  FILE* nf = fopen(s->seg_path(new_seg).c_str(), "ab");
  if (!nf) return -1;
  std::map<std::string, Entry> new_index;
  uint64_t new_size = 0;
  for (auto& kv : s->index) {
    const Entry& e = kv.second;
    std::vector<uint8_t> val(e.vlen);
    FILE* f = fopen(s->seg_path(e.segment).c_str(), "rb");
    if (!f) continue;
    fseeko(f, (off_t)e.offset, SEEK_SET);
    size_t got = fread(val.data(), 1, e.vlen, f);
    fclose(f);
    if (got != e.vlen) continue;
    uint32_t klen = (uint32_t)kv.first.size();
    std::vector<uint8_t> rec(13 + klen + e.vlen);
    memcpy(rec.data() + 4, &klen, 4);
    memcpy(rec.data() + 8, &e.vlen, 4);
    rec[12] = 0;
    memcpy(rec.data() + 13, kv.first.data(), klen);
    memcpy(rec.data() + 13 + klen, val.data(), e.vlen);
    uint32_t crc = crc32(rec.data() + 4, rec.size() - 4);
    memcpy(rec.data(), &crc, 4);
    fwrite(rec.data(), 1, rec.size(), nf);
    new_index[kv.first] = Entry{new_seg, new_size + 13 + klen, e.vlen};
    new_size += rec.size();
  }
  fflush(nf);
  fsync(fileno(nf));
  // swap
  uint32_t old_active = s->active_seg;
  fclose(s->active);
  s->active = nf;
  s->active_seg = new_seg;
  s->active_size = new_size;
  s->index.swap(new_index);
  // unlink all older segments
  for (uint32_t seg = 0; seg <= old_active; seg++) {
    unlink(s->seg_path(seg).c_str());
  }
  return 0;
}

void lsm_close(void* h) {
  Store* s = static_cast<Store*>(h);
  {
    std::lock_guard<std::mutex> g(s->mu);
    if (s->active) {
      fflush(s->active);
      fsync(fileno(s->active));
      fclose(s->active);
    }
  }
  delete s;
}

}  // extern "C"
