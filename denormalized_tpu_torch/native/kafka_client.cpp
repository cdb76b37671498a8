// kafka_client — minimal native Kafka wire-protocol client.
//
// The reference's Kafka connectivity is librdkafka (native C) behind the
// rdkafka crate (kafka_config.rs make_consumer/make_producer).  This is our
// native equivalent, speaking the Kafka binary protocol directly over TCP:
//
//   ApiVersions v0 | Metadata v1 | ListOffsets v1 | Produce v3 | Fetch v4
//
// with modern magic-2 RecordBatches (varint records, CRC32C).  Scope mirrors
// what the reference engine actually uses: partition discovery
// (get_topic_partition_count, kafka_config.rs:325), earliest/latest offset
// lookup + seek (kafka_stream_read.rs:118-140), per-partition fetch loops
// (:165-296), and fire-and-forget produce (topic_writer.rs KafkaSink).
// Consumer-group coordination is intentionally absent — offsets are owned by
// the engine's checkpoint store, exactly like the reference persists
// BatchReadMetadata to SlateDB rather than committing to Kafka.
//
// C ABI for ctypes; one connection per client object; not thread-safe
// (callers hold one client per partition reader, mirroring rdkafka's
// per-consumer model).

#include <algorithm>
#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dlfcn.h>
#include <mutex>
#include <netdb.h>
#include <string>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>
#include <zlib.h>

namespace {

// ---- CRC32C (Castagnoli), table-driven ----------------------------------
struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
uint32_t crc32c(const uint8_t* d, size_t n) {
  static const Crc32cTable tab;
  uint32_t c = ~0u;
  for (size_t i = 0; i < n; i++) c = tab.t[(c ^ d[i]) & 0xFF] ^ (c >> 8);
  return ~c;
}

// ---- TLS via dlopen'd OpenSSL -------------------------------------------
// The image ships the OpenSSL 3 RUNTIME (libssl.so.3 / libcrypto.so.3) but
// not the dev headers, so the needed surface is declared here and resolved
// with dlopen/dlsym at first use.  This matches the capability the
// reference inherits from librdkafka's ssl support (kafka_config.rs:48-58
// passes security.protocol etc. straight through to rdkafka).  All OpenSSL
// object types are opaque pointers at this ABI level.
struct TlsApi {
  void* (*TLS_client_method)();
  void* (*SSL_CTX_new)(void*);
  void (*SSL_CTX_free)(void*);
  int (*SSL_CTX_load_verify_locations)(void*, const char*, const char*);
  int (*SSL_CTX_set_default_verify_paths)(void*);
  void (*SSL_CTX_set_verify)(void*, int, void*);
  void* (*SSL_new)(void*);
  void (*SSL_free)(void*);
  int (*SSL_set_fd)(void*, int);
  int (*SSL_connect)(void*);
  int (*SSL_read)(void*, void*, int);
  int (*SSL_write)(void*, const void*, int);
  int (*SSL_shutdown)(void*);
  long (*SSL_ctrl)(void*, int, long, void*);
  int (*SSL_set1_host)(void*, const char*);
  void* (*SSL_get0_param)(void*);
  int (*X509_VERIFY_PARAM_set1_ip_asc)(void*, const char*);
  unsigned long (*ERR_get_error)();
  void (*ERR_error_string_n)(unsigned long, char*, size_t);
  bool ok = false;
};

TlsApi* tls_api() {
  // std::call_once, not a hand-rolled "tried" flag: per-partition reader
  // threads connect concurrently, and two threads racing the dlopen/dlsym
  // fill would publish half-written function pointers (the data race the
  // TSan hammer in native_test.cpp pins)
  static TlsApi api;
  static std::once_flag once;
  std::call_once(once, [] {
    // libssl declares libcrypto as a dependency, but ERR_* symbols live in
    // libcrypto — resolve each from its own handle
    void* ssl = dlopen("libssl.so.3", RTLD_NOW | RTLD_LOCAL);
    if (!ssl) ssl = dlopen("libssl.so.1.1", RTLD_NOW | RTLD_LOCAL);
    if (!ssl) ssl = dlopen("libssl.so", RTLD_NOW | RTLD_LOCAL);
    void* cry = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_LOCAL);
    if (!cry) cry = dlopen("libcrypto.so.1.1", RTLD_NOW | RTLD_LOCAL);
    if (!cry) cry = dlopen("libcrypto.so", RTLD_NOW | RTLD_LOCAL);
    if (ssl && cry) {
      bool all = true;
      auto S = [&](const char* n) {
        void* p = dlsym(ssl, n);
        if (!p) all = false;
        return p;
      };
      auto C = [&](const char* n) {
        void* p = dlsym(cry, n);
        if (!p) all = false;
        return p;
      };
      api.TLS_client_method = (void* (*)())S("TLS_client_method");
      api.SSL_CTX_new = (void* (*)(void*))S("SSL_CTX_new");
      api.SSL_CTX_free = (void (*)(void*))S("SSL_CTX_free");
      api.SSL_CTX_load_verify_locations =
          (int (*)(void*, const char*, const char*))S(
              "SSL_CTX_load_verify_locations");
      api.SSL_CTX_set_default_verify_paths =
          (int (*)(void*))S("SSL_CTX_set_default_verify_paths");
      api.SSL_CTX_set_verify =
          (void (*)(void*, int, void*))S("SSL_CTX_set_verify");
      api.SSL_new = (void* (*)(void*))S("SSL_new");
      api.SSL_free = (void (*)(void*))S("SSL_free");
      api.SSL_set_fd = (int (*)(void*, int))S("SSL_set_fd");
      api.SSL_connect = (int (*)(void*))S("SSL_connect");
      api.SSL_read = (int (*)(void*, void*, int))S("SSL_read");
      api.SSL_write = (int (*)(void*, const void*, int))S("SSL_write");
      api.SSL_shutdown = (int (*)(void*))S("SSL_shutdown");
      api.SSL_ctrl = (long (*)(void*, int, long, void*))S("SSL_ctrl");
      api.SSL_set1_host = (int (*)(void*, const char*))S("SSL_set1_host");
      api.SSL_get0_param = (void* (*)(void*))S("SSL_get0_param");
      api.X509_VERIFY_PARAM_set1_ip_asc =
          (int (*)(void*, const char*))C("X509_VERIFY_PARAM_set1_ip_asc");
      api.ERR_get_error = (unsigned long (*)())C("ERR_get_error");
      api.ERR_error_string_n =
          (void (*)(unsigned long, char*, size_t))C("ERR_error_string_n");
      api.ok = all;
    }
  });
  return api.ok ? &api : nullptr;
}

std::string tls_err(TlsApi* api, const char* what) {
  char buf[256] = {0};
  unsigned long e = api->ERR_get_error();
  if (e)
    api->ERR_error_string_n(e, buf, sizeof buf);
  else
    snprintf(buf, sizeof buf, "%s", strerror(errno));
  return std::string(what) + ": " + buf;
}

// ---- byte buffer helpers ------------------------------------------------
struct Writer {
  std::vector<uint8_t> buf;
  void u8(uint8_t v) { buf.push_back(v); }
  void i8(int8_t v) { buf.push_back((uint8_t)v); }
  void i16(int16_t v) {
    uint16_t x = htons((uint16_t)v);
    append(&x, 2);
  }
  void i32(int32_t v) {
    uint32_t x = htonl((uint32_t)v);
    append(&x, 4);
  }
  void u32(uint32_t v) {
    uint32_t x = htonl(v);
    append(&x, 4);
  }
  void i64(int64_t v) {
    uint32_t hi = htonl((uint32_t)(((uint64_t)v) >> 32));
    uint32_t lo = htonl((uint32_t)(v & 0xFFFFFFFFu));
    append(&hi, 4);
    append(&lo, 4);
  }
  void str(const std::string& s) {
    i16((int16_t)s.size());
    append(s.data(), s.size());
  }
  void nullable_str() { i16(-1); }
  void bytes(const std::vector<uint8_t>& b) {
    i32((int32_t)b.size());
    append(b.data(), b.size());
  }
  void varint(int64_t v) {  // zigzag
    uint64_t z = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
    while (z >= 0x80) {
      buf.push_back((uint8_t)(z | 0x80));
      z >>= 7;
    }
    buf.push_back((uint8_t)z);
  }
  void append(const void* p, size_t n) {
    const uint8_t* b = (const uint8_t*)p;
    buf.insert(buf.end(), b, b + n);
  }
};

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool fail = false;
  bool need(size_t n) {
    if ((size_t)(end - p) < n) {
      fail = true;
      return false;
    }
    return true;
  }
  int8_t i8() {
    if (!need(1)) return 0;
    return (int8_t)*p++;
  }
  int16_t i16() {
    if (!need(2)) return 0;
    uint16_t x;
    memcpy(&x, p, 2);
    p += 2;
    return (int16_t)ntohs(x);
  }
  int32_t i32() {
    if (!need(4)) return 0;
    uint32_t x;
    memcpy(&x, p, 4);
    p += 4;
    return (int32_t)ntohl(x);
  }
  uint32_t u32() { return (uint32_t)i32(); }
  int64_t i64() {
    if (!need(8)) return 0;
    uint32_t hi, lo;
    memcpy(&hi, p, 4);
    memcpy(&lo, p + 4, 4);
    p += 8;
    return ((int64_t)ntohl(hi) << 32) | (uint32_t)ntohl(lo);
  }
  std::string str() {
    int16_t n = i16();
    if (n < 0) return "";
    if (!need((size_t)n)) return "";
    std::string s((const char*)p, n);
    p += n;
    return s;
  }
  void skip_bytes() {
    int32_t n = i32();
    if (n > 0 && need((size_t)n)) p += n;
  }
  int64_t varint() {
    uint64_t acc = 0;
    int shift = 0;
    while (need(1)) {
      uint8_t b = *p++;
      acc |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    return (int64_t)((acc >> 1) ^ (~(acc & 1) + 1));
  }
  void skip(size_t n) {
    if (need(n)) p += n;
  }
};

struct Client {
  int fd = -1;
  std::string error;
  int32_t corr = 0;
  // fetch results
  std::vector<uint8_t> rec_bytes;
  std::vector<uint64_t> rec_offsets;  // n+1
  std::vector<int64_t> rec_ts;
  std::vector<int64_t> rec_kafka_offsets;
  int64_t next_offset = 0;
  int64_t high_watermark = 0;
  // externally-decompressed codecs (e.g. zstd via the caller's Python
  // zstandard module): batches whose codec bit is set here are stashed in
  // `pending` for the caller to decompress and re-ingest, instead of
  // erroring.  Bit n = Kafka codec id n.
  uint32_t ext_codec_mask = 0;
  struct Pending {
    int64_t base_offset;
    int64_t first_ts;
    int64_t fetch_offset;
    int32_t nrec;
    int32_t last_offset_delta;
    int32_t codec;
    std::vector<uint8_t> data;  // compressed records section
  };
  std::vector<Pending> pending;

  // TLS state (null = plaintext).  All framing above this layer is
  // identical either way — rpc() and the record paths never know.
  void* ssl = nullptr;
  void* ssl_ctx = nullptr;

  bool send_all(const uint8_t* d, size_t n) {
    while (n) {
      ssize_t w;
      if (ssl) {
        w = tls_api()->SSL_write(ssl, d, (int)std::min(n, (size_t)1 << 30));
        if (w <= 0) {
          error = tls_err(tls_api(), "tls send");
          return false;
        }
      } else {
        w = ::send(fd, d, n, MSG_NOSIGNAL);
        if (w <= 0) {
          error = std::string("send: ") + strerror(errno);
          return false;
        }
      }
      d += w;
      n -= (size_t)w;
    }
    return true;
  }
  bool recv_all(uint8_t* d, size_t n) {
    while (n) {
      ssize_t r;
      if (ssl) {
        r = tls_api()->SSL_read(ssl, d, (int)std::min(n, (size_t)1 << 30));
        if (r <= 0) {
          error = tls_err(tls_api(), "tls recv");
          return false;
        }
      } else {
        r = ::recv(fd, d, n, 0);
        if (r <= 0) {
          error = std::string("recv: ") + strerror(errno);
          return false;
        }
      }
      d += r;
      n -= (size_t)r;
    }
    return true;
  }

  // frame + send a request, receive full response body (after corr id)
  bool rpc(int16_t api_key, int16_t api_version, const Writer& body,
           std::vector<uint8_t>& resp) {
    Writer req;
    req.i16(api_key);
    req.i16(api_version);
    req.i32(++corr);
    req.str("denormalized-tpu");
    req.append(body.buf.data(), body.buf.size());
    Writer framed;
    framed.i32((int32_t)req.buf.size());
    framed.append(req.buf.data(), req.buf.size());
    if (!send_all(framed.buf.data(), framed.buf.size())) return false;
    uint8_t szb[4];
    if (!recv_all(szb, 4)) return false;
    uint32_t sz = ntohl(*(uint32_t*)szb);
    if (sz < 4 || sz > (1u << 28)) {
      error = "bad response size";
      return false;
    }
    resp.resize(sz);
    if (!recv_all(resp.data(), sz)) return false;
    // strip correlation id
    resp.erase(resp.begin(), resp.begin() + 4);
    return true;
  }
};

// build a magic-2 RecordBatch from payloads
void build_record_batch(Writer& out, const uint8_t* data,
                        const uint64_t* offs, int n, int64_t now_ms) {
  Writer records;
  for (int i = 0; i < n; i++) {
    const uint8_t* v = data + offs[i];
    int64_t vlen = (int64_t)(offs[i + 1] - offs[i]);
    Writer rec;
    rec.i8(0);           // attributes
    rec.varint(0);       // timestampDelta
    rec.varint(i);       // offsetDelta
    rec.varint(-1);      // key length (null)
    rec.varint(vlen);    // value length
    rec.append(v, (size_t)vlen);
    rec.varint(0);       // headers
    records.varint((int64_t)rec.buf.size());
    records.append(rec.buf.data(), rec.buf.size());
  }
  // batch header
  Writer hdr;  // part covered by CRC starts at attributes
  hdr.i16(0);                    // attributes
  hdr.i32(n - 1);                // lastOffsetDelta
  hdr.i64(now_ms);               // firstTimestamp
  hdr.i64(now_ms);               // maxTimestamp
  hdr.i64(-1);                   // producerId
  hdr.i16(-1);                   // producerEpoch
  hdr.i32(-1);                   // baseSequence
  hdr.i32(n);                    // numRecords
  hdr.append(records.buf.data(), records.buf.size());
  uint32_t crc = crc32c(hdr.buf.data(), hdr.buf.size());

  Writer batch;
  batch.i64(0);                              // baseOffset
  batch.i32((int32_t)(hdr.buf.size() + 9));  // batchLength (from leaderEpoch)
  batch.i32(-1);                             // partitionLeaderEpoch
  batch.i8(2);                               // magic
  batch.u32(crc);
  batch.append(hdr.buf.data(), hdr.buf.size());
  out.bytes(batch.buf);
}

// inflate a gzip stream (Kafka codec 1) into out
bool gunzip(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  z_stream zs{};
  if (inflateInit2(&zs, 15 + 16) != Z_OK) return false;  // gzip wrapper
  out.clear();
  out.resize(n * 4 + 1024);
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = (uInt)n;
  size_t written = 0;
  int rc;
  do {
    if (written == out.size()) out.resize(out.size() * 2);
    zs.next_out = out.data() + written;
    zs.avail_out = (uInt)(out.size() - written);
    rc = inflate(&zs, Z_NO_FLUSH);
    written = out.size() - zs.avail_out;
    if (rc != Z_OK && rc != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
  } while (rc != Z_STREAM_END && zs.avail_in > 0);
  inflateEnd(&zs);
  out.resize(written);
  return rc == Z_STREAM_END;
}

// ---- snappy (Kafka codec 2) --------------------------------------------
// Raw snappy block format: uvarint uncompressed length, then a stream of
// literal/copy elements.  Kafka magic-2 batches carry raw snappy; legacy
// Java producers wrapped it in xerial framing (magic "\x82SNAPPY\x00"),
// which librdkafka also auto-detects — mirror that.

bool snappy_block(const uint8_t* p, const uint8_t* end,
                  std::vector<uint8_t>& out) {
  // uncompressed length: plain LE base-128 varint (not zigzag)
  uint64_t ulen = 0;
  int shift = 0;
  while (p < end) {
    uint8_t b = *p++;
    ulen |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
    if (shift > 35) return false;
  }
  if (ulen > (1u << 30)) return false;  // 1GB sanity cap
  size_t base = out.size();
  // reserve bounded by what the input could plausibly expand to, NOT the
  // corruption-controlled ulen alone — a crafted 10-byte stream declaring
  // ulen=1GB must not allocate a gigabyte before validation rejects it
  size_t n = (size_t)(end - p);
  out.reserve(base + (size_t)std::min<uint64_t>(ulen, n * 64 + 4096));
  while (p < end) {
    uint8_t tag = *p++;
    uint32_t type = tag & 3;
    if (type == 0) {  // literal
      uint32_t len = (tag >> 2) + 1;
      if (len > 60) {
        uint32_t nb = len - 60;
        if (p + nb > end) return false;
        len = 0;
        for (uint32_t i = 0; i < nb; i++) len |= (uint32_t)p[i] << (8 * i);
        p += nb;
        len += 1;
      }
      if (p + len > end) return false;
      out.insert(out.end(), p, p + len);
      p += len;
    } else {  // copy
      uint32_t len, off;
      if (type == 1) {
        if (p >= end) return false;
        len = ((tag >> 2) & 7) + 4;
        off = ((uint32_t)(tag >> 5) << 8) | *p++;
      } else if (type == 2) {
        if (p + 2 > end) return false;
        len = (tag >> 2) + 1;
        off = (uint32_t)p[0] | ((uint32_t)p[1] << 8);
        p += 2;
      } else {
        if (p + 4 > end) return false;
        len = (tag >> 2) + 1;
        off = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
              ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
        p += 4;
      }
      size_t produced = out.size() - base;
      if (off == 0 || off > produced) return false;
      // reject before copying: output past the declared length is invalid,
      // so a corrupt stream can never make us do unbounded copy work
      if (produced + len > ulen) return false;
      // byte-by-byte: copies may overlap their own output (RLE)
      size_t src = out.size() - off;
      for (uint32_t i = 0; i < len; i++) out.push_back(out[src + i]);
    }
  }
  return out.size() - base == ulen;
}

bool snappy_decompress(const uint8_t* src, size_t n,
                       std::vector<uint8_t>& out) {
  out.clear();
  static const uint8_t XERIAL[8] = {0x82, 'S', 'N', 'A', 'P', 'P', 'Y', 0};
  if (n > 16 && memcmp(src, XERIAL, 8) == 0) {
    // xerial frame: magic + version(4) + compat(4), then [len BE][block]*
    const uint8_t* p = src + 16;
    const uint8_t* end = src + n;
    while (p + 4 <= end) {
      uint32_t len = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                     ((uint32_t)p[2] << 8) | (uint32_t)p[3];
      p += 4;
      if (p + len > end) return false;
      if (!snappy_block(p, p + len, out)) return false;
      p += len;
    }
    return p == end;
  }
  return snappy_block(src, src + n, out);
}

// ---- lz4 (Kafka codec 3) -----------------------------------------------
// LZ4 Frame format (magic 0x184D2204) wrapping LZ4 block compression.
// Checksums (xxhash) are skipped, not validated — the transport is TCP and
// the decode itself bounds-checks every copy.

bool lz4_block(const uint8_t* p, const uint8_t* end, std::vector<uint8_t>& out,
               size_t base) {
  while (p < end) {
    uint8_t token = *p++;
    uint32_t litlen = token >> 4;
    if (litlen == 15) {
      uint8_t b;
      do {
        if (p >= end) return false;
        b = *p++;
        litlen += b;
      } while (b == 255);
    }
    if (p + litlen > end) return false;
    out.insert(out.end(), p, p + litlen);
    p += litlen;
    if (p >= end) break;  // last sequence: literals only
    if (p + 2 > end) return false;
    uint32_t off = (uint32_t)p[0] | ((uint32_t)p[1] << 8);
    p += 2;
    uint32_t mlen = token & 0xF;
    if (mlen == 15) {
      uint8_t b;
      do {
        if (p >= end) return false;
        b = *p++;
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    size_t produced = out.size() - base;
    if (off == 0 || off > produced) return false;
    // cap BEFORE the copy: a corrupt matchlength extension (runs of 0xFF)
    // can encode ~1e9 in a few input bytes — reject it in O(1) instead of
    // doing a gigabyte of copy work first
    if (out.size() + mlen > (1u << 30)) return false;
    size_t src = out.size() - off;
    for (uint32_t i = 0; i < mlen; i++) out.push_back(out[src + i]);
  }
  return true;
}

bool lz4f_decompress(const uint8_t* src, size_t n,
                     std::vector<uint8_t>& out) {
  out.clear();
  const uint8_t* p = src;
  const uint8_t* end = src + n;
  if (n < 7) return false;
  uint32_t magic = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                   ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  if (magic != 0x184D2204u) return false;
  p += 4;
  uint8_t flg = *p++;
  p++;  // BD (block max size) — we size dynamically
  if ((flg >> 6) != 1) return false;     // version
  bool content_size = flg & 0x08;
  bool block_checksum = flg & 0x10;
  bool content_checksum = flg & 0x04;
  bool dict_id = flg & 0x01;
  if (content_size) p += 8;
  if (dict_id) p += 4;
  p += 1;  // header checksum byte
  if (p > end) return false;
  while (p + 4 <= end) {
    uint32_t bsz = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                   ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
    p += 4;
    if (bsz == 0) {  // EndMark
      if (content_checksum) p += 4;
      return true;
    }
    bool stored = bsz & 0x80000000u;
    bsz &= 0x7FFFFFFFu;
    if (p + bsz > end) return false;
    if (stored) {
      out.insert(out.end(), p, p + bsz);
    } else {
      // each frame block decompresses independently against the data
      // already in `out` (blocks may reference prior blocks' output when
      // the frame is block-linked; passing base=0 allows both modes)
      if (!lz4_block(p, p + bsz, out, 0)) return false;
    }
    p += bsz;
    if (block_checksum) p += 4;
  }
  return false;  // ran out of input before EndMark
}

const char* codec_name(int codec) {
  switch (codec) {
    case 1: return "gzip";
    case 2: return "snappy";
    case 3: return "lz4";
    case 4: return "zstd";
    default: return "unknown";
  }
}

// parse one records stream (inline or decompressed) into the client's
// arenas; returns false (with c->error set) on corrupt record data
bool parse_records_stream(Client* c, Reader rr, int32_t nrec,
                          int64_t base_offset, int64_t first_ts,
                          int64_t fetch_offset) {
  for (int32_t i = 0; i < nrec && !rr.fail; i++) {
    int64_t rec_len = rr.varint();
    const uint8_t* rec_end = rr.p + rec_len;
    rr.i8();  // attributes
    int64_t ts_delta = rr.varint();
    int64_t off_delta = rr.varint();
    int64_t klen = rr.varint();
    if (klen > 0) rr.skip((size_t)klen);
    int64_t vlen = rr.varint();
    int64_t abs_off = base_offset + off_delta;
    if (abs_off >= fetch_offset && vlen >= 0 && rr.need((size_t)vlen)) {
      c->rec_bytes.insert(c->rec_bytes.end(), rr.p, rr.p + vlen);
      c->rec_offsets.push_back(c->rec_bytes.size());
      c->rec_ts.push_back(first_ts + ts_delta);
      c->rec_kafka_offsets.push_back(abs_off);
    }
    // the cursor advances past EVERY record >= fetch_offset — including
    // tombstones (vlen == -1) and pre-filter duplicates — or the consumer
    // would refetch the same batch forever
    if (abs_off >= fetch_offset && abs_off + 1 > c->next_offset)
      c->next_offset = abs_off + 1;
    if (vlen > 0) rr.skip((size_t)vlen);
    // headers
    int64_t nh = rr.varint();
    for (int64_t h = 0; h < nh && !rr.fail; h++) {
      int64_t kl = rr.varint();
      rr.skip((size_t)kl);
      int64_t vl = rr.varint();
      if (vl > 0) rr.skip((size_t)vl);
    }
    // rec_end comes from an untrusted rec_len (possibly decompressed from
    // an external codec): never let the cursor move past the buffer, or
    // Reader::need's (end - p) would underflow and every later bounds
    // check would pass on out-of-bounds memory
    if (rr.p > rec_end || rec_end > rr.end) rr.fail = true;
    else rr.p = rec_end;
  }
  if (rr.fail) {
    // same error-loudly policy as the codec branches: a record stream
    // that goes bad mid-batch (truncated/garbled after a successful
    // decompress — nothing validates content checksums) must not
    // silently drop its remaining records and advance past them.
    c->error = "corrupt record data in batch at offset " +
               std::to_string(base_offset);
    return false;
  }
  return true;
}

// parse magic-2 record batches out of a Fetch "records" blob
bool parse_record_sets(Client* c, Reader& r, int32_t total_len,
                       int64_t fetch_offset) {
  const uint8_t* blob_end = r.p + total_len;
  while (r.p + 61 <= blob_end) {  // minimal batch header size
    int64_t base_offset = r.i64();
    int32_t batch_len = r.i32();
    if (r.fail || batch_len <= 0 || r.p + batch_len > blob_end) break;
    const uint8_t* batch_end = r.p + batch_len;
    r.i32();              // partitionLeaderEpoch
    int8_t magic = r.i8();
    if (magic != 2) {
      // legacy v0/v1 message sets: error loudly — silently skipping them
      // would be silent data loss against an old producer
      c->error = "legacy message format magic=" + std::to_string(magic) +
                 " at offset " + std::to_string(base_offset) +
                 " (only magic-2 record batches are supported)";
      return false;
    }
    r.u32();              // crc (trusted; transport is TCP)
    int16_t attrs = r.i16();
    int codec = attrs & 0x7;
    std::vector<uint8_t> inflated;  // keeps decompressed records alive
    if (codec > 3 && !((c->ext_codec_mask >> codec) & 1)) {
      // zstd (or future codec) with no external decompressor registered:
      // no silent skip — surface the codec by name so the operator can
      // reconfigure the producer or the topic (the reference gets all
      // codecs from librdkafka, Cargo.toml:58)
      c->error = std::string("unsupported compression codec ") +
                 codec_name(codec) + " (" + std::to_string(codec) +
                 ") in batch at offset " + std::to_string(base_offset);
      return false;
    }
    int32_t last_offset_delta = r.i32();
    int64_t first_ts = r.i64();
    r.i64();              // maxTimestamp
    r.skip(8 + 2 + 4);    // producerId/Epoch/baseSequence
    int32_t nrec = r.i32();
    if (codec > 3) {
      // externally-decompressed codec: stash the compressed records
      // section; the caller decompresses (e.g. Python zstandard) and
      // re-ingests through kc_ingest_decompressed BEFORE reading the
      // fetch arena
      Client::Pending pend;
      pend.base_offset = base_offset;
      pend.first_ts = first_ts;
      pend.fetch_offset = fetch_offset;
      pend.nrec = nrec;
      pend.last_offset_delta = last_offset_delta;
      pend.codec = codec;
      pend.data.assign(r.p, batch_end);
      c->pending.push_back(std::move(pend));
      r.p = batch_end;
      continue;
    }
    if (!c->pending.empty()) {
      // an inline batch AFTER a stashed one would be parsed into the arena
      // BEFORE the stashed batch's records are ingested, scrambling
      // partition-offset order.  Stop the fetch here; these batches
      // refetch next round (next_offset has not advanced past them).
      r.p = blob_end;
      return true;
    }
    Reader rr = r;  // records section (inline, or decompressed)
    if (codec != 0) {
      bool ok = false;
      size_t comp_len = (size_t)(batch_end - r.p);
      if (codec == 1) ok = gunzip(r.p, comp_len, inflated);
      else if (codec == 2) ok = snappy_decompress(r.p, comp_len, inflated);
      else ok = lz4f_decompress(r.p, comp_len, inflated);
      if (!ok) {
        // corrupt compressed section: error (a skip would silently drop
        // up to last_offset_delta+1 records)
        c->error = std::string(codec_name(codec)) +
                   " decompression failed for batch at offset " +
                   std::to_string(base_offset);
        return false;
      }
      rr = Reader{inflated.data(), inflated.data() + inflated.size()};
    }
    if (!parse_records_stream(c, rr, nrec, base_offset, first_ts,
                              fetch_offset))
      return false;
    // safety net for empty/odd batches: never stall behind a consumed batch
    int64_t past = base_offset + last_offset_delta + 1;
    if (past > c->next_offset && past > fetch_offset) c->next_offset = past;
    r.p = batch_end;
  }
  r.p = blob_end;
  return true;
}


}  // namespace

extern "C" {

void* kc_connect(const char* host, int port, char* errbuf, int errlen) {
  addrinfo hints{};
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  char portstr[16];
  snprintf(portstr, sizeof portstr, "%d", port);
  int rc = getaddrinfo(host, portstr, &hints, &res);
  if (rc != 0) {
    snprintf(errbuf, errlen, "resolve %s: %s", host, gai_strerror(rc));
    return nullptr;
  }
  int fd = -1;
  for (addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    // bounded connect/recv: a blackholed peer must not freeze the reader
    // thread for the kernel's multi-minute SYN retry cycle
    timeval conn_to{5, 0};
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &conn_to, sizeof conn_to);
    if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) {
      timeval io_to{30, 0};
      setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &io_to, sizeof io_to);
      break;
    }
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) {
    snprintf(errbuf, errlen, "connect %s:%d failed", host, port);
    return nullptr;
  }
  Client* c = new Client();
  c->fd = fd;
  return c;
}

void kc_close(void* h) {
  Client* c = static_cast<Client*>(h);
  TlsApi* api = c->ssl ? tls_api() : nullptr;
  if (api) {
    api->SSL_shutdown(c->ssl);  // best-effort close_notify
    api->SSL_free(c->ssl);
    if (c->ssl_ctx) api->SSL_CTX_free(c->ssl_ctx);
  }
  if (c->fd >= 0) close(c->fd);
  delete c;
}

// Upgrade the connected socket to TLS (librdkafka security.protocol=SSL
// analog).  ca_path: PEM bundle (null → system default paths); verify:
// nonzero enforces certificate chain + host identity (host_for_verify
// handles both DNS names and IP-literal SANs); SNI is sent for DNS names.
// Returns 0 on success; on failure the connection is unusable.
int kc_tls_init(void* h, const char* ca_path, int verify,
                const char* host_for_verify, char* errbuf, int errlen) {
  Client* c = static_cast<Client*>(h);
  TlsApi* api = tls_api();
  if (!api) {
    snprintf(errbuf, errlen,
             "TLS unavailable: libssl/libcrypto not loadable in this "
             "environment");
    return -1;
  }
  void* ctx = api->SSL_CTX_new(api->TLS_client_method());
  if (!ctx) {
    snprintf(errbuf, errlen, "%s", tls_err(api, "SSL_CTX_new").c_str());
    return -1;
  }
  if (ca_path && *ca_path) {
    if (api->SSL_CTX_load_verify_locations(ctx, ca_path, nullptr) != 1) {
      snprintf(errbuf, errlen, "%s",
               tls_err(api, "load ssl.ca.location").c_str());
      api->SSL_CTX_free(ctx);
      return -1;
    }
  } else {
    api->SSL_CTX_set_default_verify_paths(ctx);
  }
  if (verify) api->SSL_CTX_set_verify(ctx, 1 /*SSL_VERIFY_PEER*/, nullptr);
  void* ssl = api->SSL_new(ctx);
  if (!ssl) {
    snprintf(errbuf, errlen, "%s", tls_err(api, "SSL_new").c_str());
    api->SSL_CTX_free(ctx);
    return -1;
  }
  api->SSL_set_fd(ssl, c->fd);
  bool is_ip = false;
  if (host_for_verify && *host_for_verify) {
    unsigned char tmp[16];
    is_ip = inet_pton(AF_INET, host_for_verify, tmp) == 1 ||
            inet_pton(AF_INET6, host_for_verify, tmp) == 1;
    if (!is_ip) {
      // SNI (RFC 6066 forbids IP literals in the extension)
      api->SSL_ctrl(ssl, 55 /*SSL_CTRL_SET_TLSEXT_HOSTNAME*/,
                    0 /*TLSEXT_NAMETYPE_host_name*/,
                    (void*)host_for_verify);
    }
    if (verify) {
      int hv;
      if (is_ip)
        hv = api->X509_VERIFY_PARAM_set1_ip_asc(api->SSL_get0_param(ssl),
                                                host_for_verify);
      else
        hv = api->SSL_set1_host(ssl, host_for_verify);
      if (hv != 1) {
        snprintf(errbuf, errlen, "%s",
                 tls_err(api, "set verify host").c_str());
        api->SSL_free(ssl);
        api->SSL_CTX_free(ctx);
        return -1;
      }
    }
  }
  if (api->SSL_connect(ssl) != 1) {
    snprintf(errbuf, errlen, "%s", tls_err(api, "tls handshake").c_str());
    api->SSL_free(ssl);
    api->SSL_CTX_free(ctx);
    return -1;
  }
  c->ssl = ssl;
  c->ssl_ctx = ctx;
  return 0;
}

// SASL/PLAIN (RFC 4616) over the Kafka SaslHandshake v1 + SaslAuthenticate
// v0 exchange — the librdkafka sasl.mechanism=PLAIN analog.  Runs over
// whatever transport is active (call after kc_tls_init for SASL_SSL).
int kc_sasl_plain(void* h, const char* user, const char* pass, char* errbuf,
                  int errlen) {
  Client* c = static_cast<Client*>(h);
  {
    Writer body;
    body.str("PLAIN");
    std::vector<uint8_t> resp;
    if (!c->rpc(17 /*SaslHandshake*/, 1, body, resp)) {
      snprintf(errbuf, errlen, "sasl handshake: %s", c->error.c_str());
      return -1;
    }
    Reader r{resp.data(), resp.data() + resp.size()};
    int16_t err = r.i16();
    if (err != 0) {
      // collect the broker's advertised mechanisms for the error
      std::string mechs;
      int32_t n = r.i32();
      for (int32_t i = 0; i < n && !r.fail; i++) {
        if (i) mechs += ",";
        mechs += r.str();
      }
      snprintf(errbuf, errlen,
               "broker rejected SASL mechanism PLAIN (error %d; broker "
               "supports: %s)",
               (int)err, mechs.c_str());
      return -1;
    }
  }
  {
    std::vector<uint8_t> token;
    token.push_back(0);  // authzid (empty)
    token.insert(token.end(), user, user + strlen(user));
    token.push_back(0);
    token.insert(token.end(), pass, pass + strlen(pass));
    Writer body;
    body.bytes(token);
    std::vector<uint8_t> resp;
    if (!c->rpc(36 /*SaslAuthenticate*/, 0, body, resp)) {
      snprintf(errbuf, errlen, "sasl authenticate: %s", c->error.c_str());
      return -1;
    }
    Reader r{resp.data(), resp.data() + resp.size()};
    int16_t err = r.i16();
    if (err != 0) {
      int16_t mlen = r.i16();
      std::string msg;
      if (mlen > 0 && r.need((size_t)mlen)) {
        msg.assign((const char*)r.p, (size_t)mlen);
      }
      snprintf(errbuf, errlen, "sasl authentication failed (error %d%s%s)",
               (int)err, msg.empty() ? "" : ": ", msg.c_str());
      return -1;
    }
  }
  return 0;
}

const char* kc_error(void* h) {
  return static_cast<Client*>(h)->error.c_str();
}

// Metadata v1 → partition count for topic (-1 on error)
int kc_partition_count(void* h, const char* topic) {
  Client* c = static_cast<Client*>(h);
  Writer body;
  body.i32(1);  // one topic
  body.str(topic);
  std::vector<uint8_t> resp;
  if (!c->rpc(3, 1, body, resp)) return -1;
  Reader r{resp.data(), resp.data() + resp.size()};
  int32_t nbrokers = r.i32();
  for (int32_t i = 0; i < nbrokers; i++) {
    r.i32();
    r.str();
    r.i32();
    r.str();  // rack (nullable)
  }
  r.i32();  // controller id
  int32_t ntopics = r.i32();
  for (int32_t t = 0; t < ntopics; t++) {
    int16_t terr = r.i16();
    std::string name = r.str();
    r.i8();  // is_internal
    int32_t nparts = r.i32();
    if (name == topic) {
      if (terr != 0) {
        c->error = "metadata error code " + std::to_string(terr);
        return -1;
      }
      return nparts;
    }
    for (int32_t pi = 0; pi < nparts; pi++) {
      r.i16();
      r.i32();
      r.i32();
      int32_t nr = r.i32();
      for (int32_t x = 0; x < nr; x++) r.i32();
      int32_t ni = r.i32();
      for (int32_t x = 0; x < ni; x++) r.i32();
    }
  }
  c->error = "topic not in metadata";
  return -1;
}

// ListOffsets v1: ts -1=latest, -2=earliest
int64_t kc_list_offset(void* h, const char* topic, int partition, int64_t ts) {
  Client* c = static_cast<Client*>(h);
  Writer body;
  body.i32(-1);  // replica
  body.i32(1);   // topics
  body.str(topic);
  body.i32(1);  // partitions
  body.i32(partition);
  body.i64(ts);
  std::vector<uint8_t> resp;
  if (!c->rpc(2, 1, body, resp)) return -1;
  Reader r{resp.data(), resp.data() + resp.size()};
  int32_t ntopics = r.i32();
  for (int32_t t = 0; t < ntopics; t++) {
    r.str();
    int32_t nparts = r.i32();
    for (int32_t p = 0; p < nparts; p++) {
      r.i32();  // partition
      int16_t err = r.i16();
      r.i64();  // timestamp
      int64_t off = r.i64();
      if (err != 0) {
        c->error = "list_offsets error " + std::to_string(err);
        return -1;
      }
      return off;
    }
  }
  c->error = "empty list_offsets response";
  return -1;
}

// Produce v3, acks=1
int kc_produce(void* h, const char* topic, int partition, const uint8_t* data,
               const uint64_t* offs, int n, int64_t now_ms) {
  Client* c = static_cast<Client*>(h);
  Writer body;
  body.nullable_str();  // transactional_id
  body.i16(1);          // acks
  body.i32(10000);      // timeout
  body.i32(1);          // topics
  body.str(topic);
  body.i32(1);  // partitions
  body.i32(partition);
  build_record_batch(body, data, offs, n, now_ms);
  std::vector<uint8_t> resp;
  if (!c->rpc(0, 3, body, resp)) return -1;
  Reader r{resp.data(), resp.data() + resp.size()};
  int32_t ntopics = r.i32();
  for (int32_t t = 0; t < ntopics; t++) {
    r.str();
    int32_t nparts = r.i32();
    for (int32_t p = 0; p < nparts; p++) {
      r.i32();
      int16_t err = r.i16();
      r.i64();  // base offset
      r.i64();  // log append time
      if (err != 0) {
        c->error = "produce error " + std::to_string(err);
        return -1;
      }
    }
  }
  return 0;
}

// Fetch v4 from offset; returns record count, -1 error
int kc_fetch(void* h, const char* topic, int partition, int64_t offset,
             int max_bytes, int max_wait_ms) {
  Client* c = static_cast<Client*>(h);
  c->rec_bytes.clear();
  c->rec_offsets.assign(1, 0);
  c->rec_ts.clear();
  c->rec_kafka_offsets.clear();
  c->pending.clear();
  c->next_offset = offset;
  Writer body;
  body.i32(-1);           // replica
  body.i32(max_wait_ms);  // max wait
  body.i32(1);            // min bytes
  body.i32(max_bytes);    // max bytes
  body.i8(0);             // isolation: read_uncommitted
  body.i32(1);            // topics
  body.str(topic);
  body.i32(1);  // partitions
  body.i32(partition);
  body.i64(offset);
  body.i32(max_bytes);
  std::vector<uint8_t> resp;
  if (!c->rpc(1, 4, body, resp)) return -1;
  Reader r{resp.data(), resp.data() + resp.size()};
  r.i32();  // throttle
  int32_t ntopics = r.i32();
  for (int32_t t = 0; t < ntopics; t++) {
    r.str();
    int32_t nparts = r.i32();
    for (int32_t p = 0; p < nparts; p++) {
      r.i32();  // partition
      int16_t err = r.i16();
      c->high_watermark = r.i64();
      r.i64();  // last stable offset
      int32_t naborted = r.i32();
      for (int32_t a = 0; a < naborted; a++) {
        r.i64();
        r.i64();
      }
      int32_t blob_len = r.i32();
      if (err != 0) {
        c->error = "fetch error " + std::to_string(err);
        return -1;
      }
      if (blob_len > 0 && !parse_record_sets(c, r, blob_len, offset))
        return -1;
    }
  }
  if (r.fail) {
    c->error = "malformed fetch response";
    return -1;
  }
  return (int)c->rec_ts.size();
}

// register codecs the CALLER can decompress (bit n = Kafka codec id n)
void kc_set_external_codecs(void* h, uint32_t mask) {
  static_cast<Client*>(h)->ext_codec_mask = mask;
}

int kc_pending_count(void* h) {
  return (int)static_cast<Client*>(h)->pending.size();
}

int kc_pending_codec(void* h, int i) {
  return static_cast<Client*>(h)->pending[i].codec;
}

const uint8_t* kc_pending_data(void* h, int i, uint64_t* len) {
  Client::Pending& p = static_cast<Client*>(h)->pending[i];
  *len = p.data.size();
  return p.data.data();
}

// ingest a decompressed records section for pending batch i; returns the
// new total record count, or -1 (error set) on corrupt data
int kc_ingest_decompressed(void* h, int i, const uint8_t* data,
                           uint64_t len) {
  Client* c = static_cast<Client*>(h);
  Client::Pending& p = c->pending[i];
  Reader rr{data, data + len};
  if (!parse_records_stream(c, rr, p.nrec, p.base_offset, p.first_ts,
                            p.fetch_offset))
    return -1;
  int64_t past = p.base_offset + p.last_offset_delta + 1;
  if (past > c->next_offset && past > p.fetch_offset) c->next_offset = past;
  return (int)c->rec_ts.size();
}

const uint8_t* kc_rec_bytes(void* h, uint64_t* nbytes) {
  Client* c = static_cast<Client*>(h);
  *nbytes = c->rec_bytes.size();
  return c->rec_bytes.data();
}
const uint64_t* kc_rec_offsets(void* h) {
  return static_cast<Client*>(h)->rec_offsets.data();
}
const int64_t* kc_rec_timestamps(void* h) {
  return static_cast<Client*>(h)->rec_ts.data();
}
// absolute Kafka offset of each fetched record — exact slice-boundary
// offsets for readers that split a large fetch into bounded batches
// (gaps from compaction/control records make base+index arithmetic wrong)
const int64_t* kc_rec_kafka_offsets(void* h) {
  return static_cast<Client*>(h)->rec_kafka_offsets.data();
}
int64_t kc_next_offset(void* h) {
  return static_cast<Client*>(h)->next_offset;
}
int64_t kc_high_watermark(void* h) {
  return static_cast<Client*>(h)->high_watermark;
}

}  // extern "C"
