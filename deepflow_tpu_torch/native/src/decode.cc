// Document protobuf → struct-of-arrays decoder — the ingester's DecodePB
// hot loop (server/libs/app/codec.go:28,
// flow_metrics/unmarshaller/unmarshaller.go:220) as native code.
//
// Wire format: metric.proto Document{timestamp=1, tag=2, meter=3, flags=4}
// (see deepflow_tpu_torch/ingest/codec.py, the Python implementation
// this must match byte-for-byte; conformance is pinned by
// tests/test_torch_native.py).
//
// Schema-agnostic by construction: the caller passes
//   * tag_col[slot]   — semantic slot → output tag column (-1 = absent)
//   * meter maps      — (submsg<<5 | field) → meter column, per meter id
//   * a code→code_id table
// so the C++ never hardcodes the Python TAG_SCHEMA layout.
//
// Corrupt input decodes as the Python decoder decodes it, row for row:
//   * a LEN or fixed field that runs past the end of its buffer is cut at
//     the end and ends the loop (Python's slices), it does not fail;
//   * field number 0 is a field like any other;
//   * varints keep the bits above 2^64 (the tenth byte's top six bits),
//     so an oversized meter_id or code matches nothing and a meter value
//     is the exact integer rounded to double, then to float;
//   * a field whose Python use needs the other wire type (bytes where an
//     int is read, an int where bytes are parsed) fails the row, and a
//     LEN meter value is read as Python's float() reads bytes;
//   * the three strings report the order of their first occurrence, in
//     which the Python decoder interns them.
// The endpoint hash is over the raw bytes; the bindings recompute it for
// the rare endpoint that is not valid UTF-8 (Python hashes the decoded,
// replaced string).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

// Semantic tag slots — ABI shared with deepflow_tpu_torch/native/__init__.py
// (order must match _SLOT_NAMES there).
enum Slot {
  S_CODE_ID = 0,
  S_METER_ID,
  S_GLOBAL_THREAD_ID,
  S_AGENT_ID,
  S_IS_IPV6,
  S_IP0_W0,
  S_IP0_W1,
  S_IP0_W2,
  S_IP0_W3,
  S_IP1_W0,
  S_IP1_W1,
  S_IP1_W2,
  S_IP1_W3,
  S_L3_EPC_ID,
  S_L3_EPC_ID1,
  S_MAC0_HI,
  S_MAC0_LO,
  S_MAC1_HI,
  S_MAC1_LO,
  S_DIRECTION,
  S_TAP_SIDE,
  S_PROTOCOL,
  S_ACL_GID,
  S_SERVER_PORT,
  S_TAP_PORT,
  S_TAP_TYPE,
  S_L7_PROTOCOL,
  S_GPID0,
  S_GPID1,
  S_ENDPOINT_HASH,
  S_BIZ_TYPE,
  S_SIGNAL_SOURCE,
  S_POD_ID,
  NUM_SLOTS,
};

// One decoded field: number (UINT64_MAX when it does not fit 64 bits —
// it matches nothing), wire type, and the value: an integer (`value` with
// the bits above 2^64 in `hi`) or, for LEN, the bytes in `sub`.
struct Field;

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool fail = false;

  uint64_t varint(uint64_t* hi) {
    uint64_t out = 0;
    int shift = 0;
    *hi = 0;
    while (p < end) {
      uint8_t b = *p++;
      uint64_t bits = b & 0x7F;
      out |= bits << shift;
      if (shift == 63) *hi = bits >> 1;
      if (!(b & 0x80)) return out;
      shift += 7;
      if (shift >= 70) break;
    }
    fail = true;
    return 0;
  }

  // The next field into *f; false at the end or on failure (`fail`).
  bool next(Field* f);
};

struct Field {
  uint64_t num = 0;
  uint32_t wire = 0;
  uint64_t value = 0;
  uint64_t hi = 0;
  Cursor sub{nullptr, nullptr};
};

bool Cursor::next(Field* f) {
  if (p >= end || fail) return false;
  uint64_t khi;
  uint64_t key = varint(&khi);
  if (fail) return false;
  f->num = khi ? UINT64_MAX : key >> 3;
  f->wire = static_cast<uint32_t>(key & 7);
  f->value = 0;
  f->hi = 0;
  switch (f->wire) {
    case 0:
      f->value = varint(&f->hi);
      if (fail) return false;
      break;
    case 2: {
      uint64_t lhi;
      uint64_t len = varint(&lhi);
      if (fail) return false;
      uint64_t avail = static_cast<uint64_t>(end - p);
      uint64_t take = (lhi || len > avail) ? avail : len;
      f->sub = Cursor{p, p + take};
      p += take;
      break;
    }
    case 5:
    case 1: {
      uint64_t want = f->wire == 5 ? 4 : 8;
      uint64_t avail = static_cast<uint64_t>(end - p);
      uint64_t take = want < avail ? want : avail;
      memcpy(&f->value, p, take);  // little-endian, zero padded
      p += take;
      break;
    }
    default:
      fail = true;
      return false;
  }
  return true;
}

inline bool is_space(uint8_t c) { return c == ' ' || (c >= 0x09 && c <= 0x0D); }
inline bool is_digit(uint8_t c) { return c >= '0' && c <= '9'; }

bool ieq(const char* a, size_t n, const char* word) {
  if (strlen(word) != n) return false;
  for (size_t i = 0; i < n; i++) {
    char c = a[i];
    if (c >= 'A' && c <= 'Z') c = static_cast<char>(c - 'A' + 'a');
    if (c != word[i]) return false;
  }
  return true;
}

// Python's float(bytes): underscores only between digits, surrounding
// whitespace, then a decimal literal or inf / infinity / nan (any case,
// optional sign), nothing else.
bool py_float_from_bytes(const uint8_t* s, size_t n, double* out) {
  std::string t;
  uint8_t prev = 0;
  for (size_t i = 0; i < n; i++) {
    uint8_t c = s[i];
    if (c == '_') {
      if (!is_digit(prev)) return false;
    } else {
      if (prev == '_' && !is_digit(c)) return false;
      t.push_back(static_cast<char>(c));
    }
    prev = c;
  }
  if (prev == '_') return false;
  size_t a = 0, b = t.size();
  while (a < b && is_space(t[a])) a++;
  while (b > a && is_space(t[b - 1])) b--;
  const char* x = t.data() + a;
  size_t m = b - a;
  size_t i = 0;
  bool neg = false;
  if (i < m && (x[i] == '+' || x[i] == '-')) neg = x[i++] == '-';
  if (ieq(x + i, m - i, "inf") || ieq(x + i, m - i, "infinity")) {
    *out = neg ? -HUGE_VAL : HUGE_VAL;
    return true;
  }
  if (ieq(x + i, m - i, "nan")) {
    *out = neg ? -NAN : NAN;
    return true;
  }
  size_t int_digits = 0, frac_digits = 0;
  while (i < m && is_digit(x[i])) { i++; int_digits++; }
  if (i < m && x[i] == '.') {
    i++;
    while (i < m && is_digit(x[i])) { i++; frac_digits++; }
  }
  if (int_digits + frac_digits == 0) return false;
  if (i < m && (x[i] == 'e' || x[i] == 'E')) {
    i++;
    if (i < m && (x[i] == '+' || x[i] == '-')) i++;
    size_t exp_digits = 0;
    while (i < m && is_digit(x[i])) { i++; exp_digits++; }
    if (exp_digits == 0) return false;
  }
  if (i != m) return false;
  std::string lit(x, m);  // NUL-terminated, validated: strtod reads it all
  *out = strtod(lit.c_str(), nullptr);
  return true;
}

// A meter value as numpy stores a Python value into a float32 column:
// an integer through double, bytes through float(); false where Python
// raises.
bool meter_value(const Field& f, float* out) {
  double d;
  if (f.wire == 2) {
    if (!py_float_from_bytes(f.sub.p, static_cast<size_t>(f.sub.end - f.sub.p), &d))
      return false;
  } else {
    unsigned __int128 x = (static_cast<unsigned __int128>(f.hi) << 64) | f.value;
    d = static_cast<double>(x);
  }
  *out = static_cast<float>(d);
  return true;
}

inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6B;
  h ^= h >> 13;
  h *= 0xC2B2AE35;
  h ^= h >> 16;
  return h;
}

// Identical to deepflow_tpu_torch/ops/hashing._fold_np(cols, SEED_HI) over the
// little-endian u32 words of the zero-padded string.
uint32_t hash_string(const uint8_t* s, uint32_t len) {
  if (len == 0) return 0;
  uint32_t n_words = (len + 3) / 4;
  uint32_t h = 0x9747B28C;  // SEED_HI
  for (uint32_t i = 0; i < n_words; i++) {
    uint32_t w = 0;
    uint32_t take = len - i * 4 < 4 ? len - i * 4 : 4;
    memcpy(&w, s + i * 4, take);  // little-endian load, zero padded
    uint32_t k = w * 0xCC9E2D51u;
    k = rotl32(k, 15);
    k = k * 0x1B873593u;
    h ^= k;
    h = rotl32(h, 13);
    h = h * 5 + 0xE6546B64u;
  }
  h ^= n_words * 4;
  return fmix32(h);
}

struct DecodeCtx {
  const int32_t* tag_col;
  uint32_t t_cols;
  const int32_t* meter_maps[8];  // by meter_id; (sub<<5|fid) → col
  int32_t meter_sub_field[8];    // Meter.{flow=2,usage=3,app=4}; -1 unknown
  bool meter_flat[8];            // UsageMeter has flat fields
  const uint64_t* codes;
  const uint32_t* code_ids;
  uint32_t n_codes;
};

inline void set_tag(uint32_t* row, const DecodeCtx& ctx, int slot, uint32_t v) {
  int32_t col = ctx.tag_col[slot];
  if (col >= 0) row[col] = v;
}

void decode_ip(uint32_t* row, const DecodeCtx& ctx, Cursor ip, int base_slot) {
  size_t len = ip.end - ip.p;
  if (len == 4) {
    uint32_t v = (uint32_t(ip.p[0]) << 24) | (uint32_t(ip.p[1]) << 16) |
                 (uint32_t(ip.p[2]) << 8) | uint32_t(ip.p[3]);
    set_tag(row, ctx, base_slot + 3, v);
  } else if (len == 16) {
    for (int w = 0; w < 4; w++) {
      const uint8_t* q = ip.p + w * 4;
      uint32_t v = (uint32_t(q[0]) << 24) | (uint32_t(q[1]) << 16) |
                   (uint32_t(q[2]) << 8) | uint32_t(q[3]);
      set_tag(row, ctx, base_slot + w, v);
    }
  }
}

// status codes
enum { OK = 0, ERR_DECODE = 1, ERR_METER = 2 };

int decode_one(const uint8_t* msg, uint32_t len, const DecodeCtx& ctx,
               uint32_t* tag_row, float* meter_row, uint32_t* ts,
               uint32_t* flags, uint8_t* meter_id_out, uint64_t* str_offs,
               uint32_t* str_lens, uint8_t* str_order, const uint8_t* base) {
  Cursor doc{msg, msg + len};
  Cursor minitag{nullptr, nullptr}, meter_buf{nullptr, nullptr};
  bool minitag_int = false, meter_int = false;
  Field f;
  while (doc.next(&f)) {
    const bool is_len = f.wire == 2;
    switch (f.num) {
      case 1:
      case 4:
        if (is_len) return ERR_DECODE;
        *(f.num == 1 ? ts : flags) = static_cast<uint32_t>(f.value);
        break;
      case 2:
        minitag_int = !is_len;
        if (is_len) minitag = f.sub;
        break;
      case 3:
        meter_int = !is_len;
        if (is_len) meter_buf = f.sub;
        break;
      default: break;
    }
  }
  if (doc.fail || minitag_int || meter_int) return ERR_DECODE;

  // ---- MiniTag{field=1, code=2} ----
  uint64_t code = 0;
  bool code_known = true;  // false: bytes or an integer past 2^64
  Cursor minifield{nullptr, nullptr};
  bool minifield_int = false;
  while (minitag.next(&f)) {
    if (f.num == 1) {
      minifield_int = f.wire != 2;
      if (!minifield_int) minifield = f.sub;
    } else if (f.num == 2) {
      code = f.value;
      code_known = f.wire != 2 && f.hi == 0;
    }
  }
  if (minitag.fail || minifield_int) return ERR_DECODE;

  uint8_t n_strs = 0;
  while (minifield.next(&f)) {
    const bool is_len = f.wire == 2;
    const uint64_t v = f.value;
    switch (f.num) {
      case 1:
      case 2:
        if (!is_len) return ERR_DECODE;
        decode_ip(tag_row, ctx, f.sub, f.num == 1 ? S_IP0_W0 : S_IP1_W0);
        break;
      case 23:
      case 24:
      case 25: {
        if (!is_len) return ERR_DECODE;
        int idx = static_cast<int>(f.num) - 23;
        str_offs[idx] = f.sub.p - base;
        str_lens[idx] = static_cast<uint32_t>(f.sub.end - f.sub.p);
        if (!str_order[idx]) str_order[idx] = ++n_strs;
        if (f.num == 25)
          set_tag(tag_row, ctx, S_ENDPOINT_HASH,
                  hash_string(f.sub.p, str_lens[idx]));
        break;
      }
      case 3: case 4: case 5: case 6: case 7: case 8: case 9: case 10:
      case 11: case 12: case 13: case 14: case 15: case 16: case 17:
      case 20: case 21: case 22: case 27: case 28:
        if (is_len) return ERR_DECODE;
        switch (f.num) {
          case 3: set_tag(tag_row, ctx, S_GLOBAL_THREAD_ID, v); break;
          case 4: set_tag(tag_row, ctx, S_IS_IPV6, v); break;
          case 5:
          case 6:
            set_tag(tag_row, ctx, f.num == 5 ? S_L3_EPC_ID : S_L3_EPC_ID1,
                    static_cast<uint32_t>(v & 0xFFFF));
            break;
          case 7:
            set_tag(tag_row, ctx, S_MAC0_HI, v >> 32);
            set_tag(tag_row, ctx, S_MAC0_LO, v & 0xFFFFFFFF);
            break;
          case 8:
            set_tag(tag_row, ctx, S_MAC1_HI, v >> 32);
            set_tag(tag_row, ctx, S_MAC1_LO, v & 0xFFFFFFFF);
            break;
          case 9: set_tag(tag_row, ctx, S_DIRECTION, v); break;
          case 10: set_tag(tag_row, ctx, S_TAP_SIDE, v); break;
          case 11: set_tag(tag_row, ctx, S_PROTOCOL, v); break;
          case 12: set_tag(tag_row, ctx, S_ACL_GID, v); break;
          case 13: set_tag(tag_row, ctx, S_SERVER_PORT, v); break;
          case 14: set_tag(tag_row, ctx, S_AGENT_ID, v); break;
          case 15: set_tag(tag_row, ctx, S_TAP_PORT, v); break;
          case 16: set_tag(tag_row, ctx, S_TAP_TYPE, v); break;
          case 17: set_tag(tag_row, ctx, S_L7_PROTOCOL, v); break;
          case 20: set_tag(tag_row, ctx, S_GPID0, v); break;
          case 21: set_tag(tag_row, ctx, S_GPID1, v); break;
          case 22: set_tag(tag_row, ctx, S_SIGNAL_SOURCE, v); break;
          case 27: set_tag(tag_row, ctx, S_POD_ID, v); break;
          case 28: set_tag(tag_row, ctx, S_BIZ_TYPE, v); break;
        }
        break;
      default: break;
    }
  }
  if (minifield.fail) return ERR_DECODE;

  // code → dense code_id (linear scan; the table has ~10 entries)
  uint32_t code_id = 0;
  for (uint32_t i = 0; code_known && i < ctx.n_codes; i++) {
    if (ctx.codes[i] == code) {
      code_id = ctx.code_ids[i];
      break;
    }
  }
  set_tag(tag_row, ctx, S_CODE_ID, code_id);

  // ---- Meter{meter_id=1, flow=2, usage=3, app=4} ----
  // Mirror the Python decoder: pick the submessage matching the declared
  // meter_id; a missing submessage means an all-zero meter, submessages
  // of other meter kinds are ignored.
  uint64_t meter_id = 0;
  bool meter_id_known = true;
  Cursor sub_bufs[8] = {};
  while (meter_buf.next(&f)) {
    if (f.num == 1) {
      meter_id = f.value;
      meter_id_known = f.wire != 2 && f.hi == 0;
    } else if (f.wire == 2 && f.num < 8) {
      sub_bufs[f.num] = f.sub;
    }
  }
  if (meter_buf.fail) return ERR_DECODE;
  if (!meter_id_known || meter_id >= 8 || ctx.meter_maps[meter_id] == nullptr)
    return ERR_METER;
  Cursor inner = sub_bufs[ctx.meter_sub_field[meter_id]];
  set_tag(tag_row, ctx, S_METER_ID, static_cast<uint32_t>(meter_id));
  *meter_id_out = static_cast<uint8_t>(meter_id);

  const int32_t* mmap = ctx.meter_maps[meter_id];
  float x;
  if (ctx.meter_flat[meter_id]) {
    while (inner.next(&f)) {
      if (f.num >= 32) continue;
      int32_t col = mmap[f.num];  // sub 0 → plain fid index
      if (col < 0) continue;
      if (!meter_value(f, &x)) return ERR_DECODE;
      meter_row[col] = x;
    }
    if (inner.fail) return ERR_DECODE;
  } else {
    Field g;
    while (inner.next(&f)) {
      if (f.wire != 2) continue;
      Cursor subm = f.sub;
      while (subm.next(&g)) {
        if (f.num >= 8 || g.num >= 32) continue;
        int32_t col = mmap[(f.num << 5) | g.num];
        if (col < 0) continue;
        if (!meter_value(g, &x)) return ERR_DECODE;
        meter_row[col] = x;
      }
      if (subm.fail) return ERR_DECODE;
    }
    if (inner.fail) return ERR_DECODE;
  }
  return OK;
}

}  // namespace

extern "C" {

// Split a frame body into [len u32 LE][msg] messages; writes offsets (into
// body) and lengths. Returns message count, or -1 on malformed body.
int32_t df_split_messages(const uint8_t* body, uint32_t len, uint64_t* offs,
                          uint32_t* lens, uint32_t max_msgs) {
  uint32_t off = 0;
  uint32_t n = 0;
  while (off + 4 <= len && n < max_msgs) {
    uint32_t size;
    memcpy(&size, body + off, 4);
    off += 4;
    if (off + size > len) return -1;
    offs[n] = off;
    lens[n] = size;
    off += size;
    n++;
  }
  if (off != len) return -1;
  return static_cast<int32_t>(n);
}

// Decode n Documents (concatenated in `buf` at offs/lens) into SoA outputs.
// All outputs are preallocated by the caller with n rows. Returns the
// number of OK rows (status[i]==0).
int32_t df_decode_documents(
    const uint8_t* buf, const uint64_t* offs, const uint32_t* lens, uint32_t n,
    const int32_t* tag_col, uint32_t t_cols,
    const int32_t* flow_map, const int32_t* usage_map, const int32_t* app_map,
    const uint64_t* codes, const uint32_t* code_ids, uint32_t n_codes,
    uint32_t m_cols,  // meters row stride (max over meter schemas)
    uint32_t* tags, float* meters, uint32_t* timestamps, uint32_t* flags,
    uint8_t* meter_ids, uint64_t* str_offs, uint32_t* str_lens,
    uint8_t* str_order, uint8_t* status) {
  DecodeCtx ctx{};
  ctx.tag_col = tag_col;
  ctx.t_cols = t_cols;
  for (int i = 0; i < 8; i++) {
    ctx.meter_maps[i] = nullptr;
    ctx.meter_sub_field[i] = -1;
    ctx.meter_flat[i] = false;
  }
  // MeterId::{FLOW=1, USAGE=4, APP=5} → Meter.{flow=2, usage=3, app=4}
  ctx.meter_maps[1] = flow_map;
  ctx.meter_sub_field[1] = 2;
  ctx.meter_maps[4] = usage_map;
  ctx.meter_sub_field[4] = 3;
  ctx.meter_flat[4] = true;
  ctx.meter_maps[5] = app_map;
  ctx.meter_sub_field[5] = 4;
  ctx.codes = codes;
  ctx.code_ids = code_ids;
  ctx.n_codes = n_codes;

  int32_t ok = 0;
  for (uint32_t i = 0; i < n; i++) {
    uint32_t* tag_row = tags + static_cast<size_t>(i) * t_cols;
    float* meter_row = meters + static_cast<size_t>(i) * m_cols;
    int st = decode_one(buf + offs[i], lens[i], ctx, tag_row, meter_row,
                        timestamps + i, flags + i, meter_ids + i,
                        str_offs + static_cast<size_t>(i) * 3,
                        str_lens + static_cast<size_t>(i) * 3,
                        str_order + static_cast<size_t>(i) * 3, buf);
    status[i] = static_cast<uint8_t>(st);
    if (st == OK) ok++;
  }
  return ok;
}

}  // extern "C"
