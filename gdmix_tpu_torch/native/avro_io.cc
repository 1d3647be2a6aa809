// Native Avro OCF decoder for flat primitive records (score files).
//
// The file-mode pipeline reads large score avros (uid / predictionScore /
// label / weight / predictionScorePerCoordinate) between every coordinate;
// this decoder replaces the pure-Python datum reader for that hot path. The
// Python side parses the writer schema and hands down a per-field code string;
// anything fancier (nested records, arrays, maps) falls back to Python.
//
// Field codes: L=long, I=int, F=float, D=double, B=boolean,
//              U=union["null","<primitive>"] (null → present flag 0),
//              S=string/bytes (skipped, not returned).
// Codecs: null and deflate (raw zlib inflate).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 avro_io.cc -o libgdmix_avro.so -lz

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  int64_t zigzag() {
    uint64_t acc = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      acc |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80))
        return static_cast<int64_t>((acc >> 1) ^ (~(acc & 1) + 1));
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }

  void skip_bytes(int64_t n) {
    // negative lengths (corrupt varints) must fail, not rewind the cursor
    if (n < 0 || end - p < n) {
      ok = false;
      return;
    }
    p += n;
  }

  float f32() {
    float f = 0;
    if (p + 4 <= end) {
      std::memcpy(&f, p, 4);
      p += 4;
    } else {
      ok = false;
    }
    return f;
  }

  double f64() {
    double d = 0;
    if (p + 8 <= end) {
      std::memcpy(&d, p, 8);
      p += 8;
    } else {
      ok = false;
    }
    return d;
  }
};

struct Handle {
  std::string codes;              // per returned column: L/I/F/D/B/U-subtype
  std::vector<char> union_sub;    // for U columns: the non-null branch code
  std::vector<std::vector<double>> fcols;
  std::vector<std::vector<int64_t>> icols;
  std::vector<std::vector<uint8_t>> present;
  std::vector<int> col_of_field;  // schema field → output column (-1 skipped)
  int64_t num_records = 0;
};

bool decode_block(Reader& r, int64_t count, Handle* h) {
  const std::string& codes = h->codes;
  for (int64_t rec = 0; rec < count; ++rec) {
    for (size_t f = 0; f < codes.size(); ++f) {
      char c = codes[f];
      int col = h->col_of_field[f];
      bool null_val = false;
      if (c == 'U') {
        int64_t branch = r.zigzag();
        if (branch == 0) {
          null_val = true;
          c = h->union_sub[f];  // type it WOULD have been
        } else {
          c = h->union_sub[f];
        }
      }
      double dv = 0;
      int64_t iv = 0;
      if (!null_val) {
        switch (c) {
          case 'L': case 'I': iv = r.zigzag(); dv = static_cast<double>(iv); break;
          case 'F': dv = r.f32(); break;
          case 'D': dv = r.f64(); break;
          case 'B': iv = (r.p < r.end) ? *r.p++ : 0; dv = iv; break;
          case 'S': { int64_t n = r.zigzag(); r.skip_bytes(n); break; }
          default: r.ok = false;
        }
      }
      if (!r.ok) return false;
      if (col >= 0) {
        h->fcols[col].push_back(dv);
        h->icols[col].push_back(iv);
        h->present[col].push_back(null_val ? 0 : 1);
      }
    }
    h->num_records++;
  }
  return r.ok;
}

// Walks an OCF container: header, codec, per-block inflate; calls
// decode(block_reader, record_count) for each data block. Returns false on
// malformed input or unsupported codec.
template <typename Fn>
bool walk_container(const uint8_t* data, int64_t len, Fn&& decode) {
  Reader r{data, data + len};
  if (len < 4 || std::memcmp(data, "Obj\x01", 4) != 0) return false;
  r.p += 4;
  std::string codec = "null";
  while (r.ok) {
    int64_t n = r.zigzag();
    if (n == 0) break;
    if (n < 0) { n = -n; r.zigzag(); }
    for (int64_t i = 0; i < n && r.ok; ++i) {
      int64_t klen = r.zigzag();
      if (!r.ok || klen < 0 || r.end - r.p < klen) return false;
      std::string key(reinterpret_cast<const char*>(r.p), klen);
      r.skip_bytes(klen);
      int64_t vlen = r.zigzag();
      if (!r.ok || vlen < 0 || r.end - r.p < vlen) return false;
      if (key == "avro.codec")
        codec.assign(reinterpret_cast<const char*>(r.p), vlen);
      r.skip_bytes(vlen);
    }
  }
  if (!r.ok) return false;
  const uint8_t* sync = r.p;
  r.skip_bytes(16);
  if (!r.ok) return false;

  std::vector<uint8_t> scratch;
  while (r.ok && r.p < r.end) {
    int64_t count = r.zigzag();
    int64_t size = r.zigzag();
    if (!r.ok || size < 0 || r.end - r.p < 16 || r.end - r.p - 16 < size)
      return false;
    const uint8_t* payload = r.p;
    int64_t payload_len = size;
    if (codec == "deflate") {
      scratch.clear();
      scratch.resize(std::max<int64_t>(size * 8, 1 << 16));
      z_stream zs{};
      inflateInit2(&zs, -15);
      zs.next_in = const_cast<uint8_t*>(payload);
      zs.avail_in = static_cast<uInt>(size);
      size_t out_len = 0;
      int ret = Z_OK;
      while (ret != Z_STREAM_END) {
        if (out_len == scratch.size()) scratch.resize(scratch.size() * 2);
        zs.next_out = scratch.data() + out_len;
        zs.avail_out = static_cast<uInt>(scratch.size() - out_len);
        ret = inflate(&zs, Z_NO_FLUSH);
        out_len = scratch.size() - zs.avail_out;
        if (ret != Z_OK && ret != Z_STREAM_END) break;
      }
      inflateEnd(&zs);
      if (ret != Z_STREAM_END) return false;
      payload = scratch.data();
      payload_len = static_cast<int64_t>(out_len);
    } else if (codec != "null") {
      return false;  // snappy etc. → python fallback
    }
    Reader br{payload, payload + payload_len};
    if (!decode(br, count)) return false;
    r.skip_bytes(size);
    if (std::memcmp(r.p, sync, 16) != 0) return false;
    r.skip_bytes(16);
  }
  return r.ok;
}

}  // namespace

extern "C" {

// field_codes: one char per schema field, 'U' fields followed in union_subs by
// their non-null branch code (same length as field_codes; '-' for non-unions).
// skip mask: 'S' fields and any '-' code are parsed but not returned.
void* gdx_avro_parse(const uint8_t* data, int64_t len, const char* field_codes,
                     const char* union_subs) {
  auto* h = new Handle();
  h->codes = field_codes;
  h->union_sub.assign(union_subs, union_subs + std::strlen(union_subs));
  int col = 0;
  for (char c : h->codes) {
    if (c == 'S' || c == '-') {
      h->col_of_field.push_back(-1);
    } else {
      h->col_of_field.push_back(col++);
    }
  }
  h->fcols.resize(col);
  h->icols.resize(col);
  h->present.resize(col);

  if (!walk_container(data, len, [&](Reader& br, int64_t count) {
        return decode_block(br, count, h);
      })) {
    delete h;
    return nullptr;
  }
  return h;
}

int64_t gdx_avro_num_records(void* handle) {
  return static_cast<Handle*>(handle)->num_records;
}

void gdx_avro_fill_f64(void* handle, int32_t col, double* out, uint8_t* present) {
  auto* h = static_cast<Handle*>(handle);
  std::memcpy(out, h->fcols[col].data(), h->fcols[col].size() * sizeof(double));
  std::memcpy(present, h->present[col].data(), h->present[col].size());
}

void gdx_avro_fill_i64(void* handle, int32_t col, int64_t* out, uint8_t* present) {
  auto* h = static_cast<Handle*>(handle);
  std::memcpy(out, h->icols[col].data(), h->icols[col].size() * sizeof(int64_t));
  std::memcpy(present, h->present[col].data(), h->present[col].size());
}

void gdx_avro_free(void* handle) { delete static_cast<Handle*>(handle); }

// ---------------------------------------------------------------------------
// Columnar encoder: rows [start, start+count) of parallel column arrays →
// concatenated Avro record datums (one block payload). The Python side owns
// the OCF container framing (header/codec/sync); this is only the per-record
// encoding loop that dominates score writing (io_utils.py:299-334 in the
// reference writes these files via fastavro's per-record datum writer).
//
// codes[i]: 'L'/'I' (int64 col, varint zigzag), 'D' (double), 'F' (double col
//           cast to float32), 'B' (int64 col, 1 byte).
// nullable[i]: field is union ["null", <prim>] → a branch index is written;
//              present[i] (uint8 per row, may be NULL = all present) picks it.
// Returns bytes written, or -1 if `cap` is too small (caller sizes cap from
// the per-type maxima, so this only fires on a caller bug).
int64_t gdx_avro_encode(const char* codes, const uint8_t* nullable,
                        int32_t ncols, const int64_t** icols,
                        const double** dcols, const uint8_t** present,
                        int64_t start, int64_t count, uint8_t* out,
                        int64_t cap) {
  uint8_t* p = out;
  uint8_t* end = out + cap;
  for (int64_t row = start; row < start + count; ++row) {
    if (end - p < 16 * ncols) return -1;  // 16 ≥ max field footprint
    for (int32_t f = 0; f < ncols; ++f) {
      bool is_present = !present[f] || present[f][row];
      if (nullable[f]) {
        *p++ = is_present ? 0x02 : 0x00;  // zigzag(1)=2 / zigzag(0)=0
        if (!is_present) continue;
      }
      switch (codes[f]) {
        case 'L':
        case 'I': {
          uint64_t z = static_cast<uint64_t>(icols[f][row]);
          z = (z << 1) ^ static_cast<uint64_t>(icols[f][row] >> 63);
          while (z >= 0x80) {
            *p++ = static_cast<uint8_t>(z) | 0x80;
            z >>= 7;
          }
          *p++ = static_cast<uint8_t>(z);
          break;
        }
        case 'D': {
          std::memcpy(p, &dcols[f][row], 8);
          p += 8;
          break;
        }
        case 'F': {
          float v = static_cast<float>(dcols[f][row]);
          std::memcpy(p, &v, 4);
          p += 4;
          break;
        }
        case 'B': {
          *p++ = icols[f][row] ? 1 : 0;
          break;
        }
        default:
          return -1;
      }
    }
  }
  return p - out;
}

// ---------------------------------------------------------------------------
// photon-ml BayesianLinearModelAvro codec (schemas.py / io_utils.py:45-213 in
// the reference). Encoder: models [e_start, e_start+e_count) → one block
// payload. Columnar inputs; (name, term) string pairs are pre-encoded once by
// the Python side into `table` blocks (varint len+name, varint len+term), so
// the per-coefficient work is a memcpy + 8-byte double.
// ---------------------------------------------------------------------------

namespace {

inline uint8_t* put_varint(uint8_t* p, int64_t v) {
  uint64_t z = (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63);
  while (z >= 0x80) {
    *p++ = static_cast<uint8_t>(z) | 0x80;
    z >>= 7;
  }
  *p++ = static_cast<uint8_t>(z);
  return p;
}

}  // namespace

// coef_ids: global feature index per coefficient row (indexes `table`);
// model_offs: [E+1] ranges into the coef arrays; icpt_vals/icpt_vars: [E]
// intercept mean/variance or NULL; coef_vars: variances aligned with
// coef_vals or NULL. mclass_blob/loss_blob: fully-encoded union field bytes
// (constant across records). Keeps |v| > threshold plus the intercept,
// mirroring gen_one_avro_model. Returns bytes written or -1 on overflow.
int64_t gdx_model_encode(
    const uint8_t* id_bytes, const int64_t* id_offs, const uint8_t* table,
    const int64_t* table_offs, const uint8_t* icpt_blob, int64_t icpt_len,
    const uint8_t* mclass_blob, int64_t mclass_len, const uint8_t* loss_blob,
    int64_t loss_len, const int64_t* coef_ids, const double* coef_vals,
    const double* coef_vars, const int64_t* model_offs,
    const double* icpt_vals, const double* icpt_vars, double threshold,
    int64_t e_start, int64_t e_count, uint8_t* out, int64_t cap) {
  uint8_t* p = out;
  uint8_t* end = out + cap;
  for (int64_t e = e_start; e < e_start + e_count; ++e) {
    const int64_t id_len = id_offs[e + 1] - id_offs[e];
    const int64_t lo = model_offs ? model_offs[e] : 0;
    const int64_t hi = model_offs ? model_offs[e + 1] : 0;
    int64_t kept = 0;
    int64_t bytes = 0;
    for (int64_t j = lo; j < hi; ++j) {
      double v = coef_vals[j];
      if (v > threshold || v < -threshold) {
        ++kept;
        bytes += table_offs[coef_ids[j] + 1] - table_offs[coef_ids[j]] + 8;
      }
    }
    const bool has_icpt = icpt_vals != nullptr;
    const bool has_var = coef_vars != nullptr || icpt_vars != nullptr;
    const int64_t cnt = kept + (has_icpt ? 1 : 0);
    // worst case: id + class + 2 arrays (count+items+terminator) + loss
    const int64_t need = 11 + id_len + mclass_len + loss_len +
                         2 * (11 + (icpt_len + 9) + bytes + 1) + 11;
    if (end - p < need) return -1;

    p = put_varint(p, id_len);
    std::memcpy(p, id_bytes + id_offs[e], id_len);
    p += id_len;
    std::memcpy(p, mclass_blob, mclass_len);
    p += mclass_len;
    // means
    if (cnt) p = put_varint(p, cnt);
    if (has_icpt) {
      std::memcpy(p, icpt_blob, icpt_len);
      p += icpt_len;
      std::memcpy(p, &icpt_vals[e], 8);
      p += 8;
    }
    for (int64_t j = lo; j < hi; ++j) {
      double v = coef_vals[j];
      if (v > threshold || v < -threshold) {
        int64_t b0 = table_offs[coef_ids[j]];
        int64_t blen = table_offs[coef_ids[j] + 1] - b0;
        std::memcpy(p, table + b0, blen);
        p += blen;
        std::memcpy(p, &v, 8);
        p += 8;
      }
    }
    *p++ = 0;  // array terminator
    // variances union
    if (!has_var) {
      *p++ = 0;  // null branch
    } else {
      *p++ = 2;  // array branch
      if (cnt) p = put_varint(p, cnt);
      if (has_icpt) {
        std::memcpy(p, icpt_blob, icpt_len);
        p += icpt_len;
        double iv = icpt_vars ? icpt_vars[e] : 0.0;
        std::memcpy(p, &iv, 8);
        p += 8;
      }
      for (int64_t j = lo; j < hi; ++j) {
        double v = coef_vals[j];
        if (v > threshold || v < -threshold) {
          int64_t b0 = table_offs[coef_ids[j]];
          int64_t blen = table_offs[coef_ids[j] + 1] - b0;
          std::memcpy(p, table + b0, blen);
          p += blen;
          double var = coef_vars ? coef_vars[j] : 0.0;
          std::memcpy(p, &var, 8);
          p += 8;
        }
      }
      *p++ = 0;
    }
    std::memcpy(p, loss_blob, loss_len);
    p += loss_len;
  }
  return p - out;
}

namespace {

struct ModelHandle {
  std::vector<uint8_t> id_bytes;
  std::vector<int64_t> id_offs{0};
  std::vector<int64_t> mean_ids;   // table index; -1 intercept; -2 unknown
  std::vector<double> mean_vals;
  std::vector<double> var_vals;    // aligned with mean_vals (0 if absent)
  std::vector<uint8_t> var_present;
  std::vector<int64_t> mean_offs{0};
  int64_t num_models = 0;
  bool vars_align = true;  // every variance NTV matched its mean NTV in order
};

}  // namespace

// table/table_offs: the same pre-encoded (name, term) blocks the encoder
// uses; lookups are byte-exact, so the parser never re-hashes Python strings.
// icpt_blob: the encoded ("(INTERCEPT)", "") pair. Returns NULL on malformed
// input, unsupported codec, or misaligned variance arrays (→ python path).
void* gdx_model_parse(const uint8_t* data, int64_t len, const uint8_t* table,
                      const int64_t* table_offs, int64_t nfeat,
                      const uint8_t* icpt_blob, int64_t icpt_len) {
  std::unordered_map<std::string, int64_t> lut;
  lut.reserve(static_cast<size_t>(nfeat) * 2 + 2);
  for (int64_t i = 0; i < nfeat; ++i) {
    lut.emplace(std::string(reinterpret_cast<const char*>(table) + table_offs[i],
                            table_offs[i + 1] - table_offs[i]),
                i);
  }
  lut.emplace(std::string(reinterpret_cast<const char*>(icpt_blob), icpt_len), -1);

  auto* h = new ModelHandle();
  auto read_ntv = [&](Reader& r, int64_t* id, double* val) -> bool {
    const uint8_t* start = r.p;
    int64_t nlen = r.zigzag();
    r.skip_bytes(nlen);
    int64_t tlen = r.zigzag();
    r.skip_bytes(tlen);
    if (!r.ok) return false;
    auto it = lut.find(std::string(reinterpret_cast<const char*>(start),
                                   r.p - start));
    *id = (it == lut.end()) ? -2 : it->second;
    *val = r.f64();
    return r.ok;
  };
  auto decode = [&](Reader& r, int64_t count) -> bool {
    for (int64_t rec = 0; rec < count; ++rec) {
      // modelId
      int64_t id_len = r.zigzag();
      if (!r.ok || id_len < 0 || r.end - r.p < id_len) return false;
      h->id_bytes.insert(h->id_bytes.end(), r.p, r.p + id_len);
      r.skip_bytes(id_len);
      h->id_offs.push_back(static_cast<int64_t>(h->id_bytes.size()));
      // modelClass union
      if (r.zigzag() != 0) {
        int64_t n = r.zigzag();
        r.skip_bytes(n);
      }
      // means array (handle negative block counts per spec)
      const int64_t mean_base = static_cast<int64_t>(h->mean_vals.size());
      for (;;) {
        int64_t n = r.zigzag();
        if (n == 0) break;
        if (n < 0) { n = -n; r.zigzag(); }
        for (int64_t i = 0; i < n; ++i) {
          int64_t id;
          double val;
          if (!read_ntv(r, &id, &val)) return false;
          h->mean_ids.push_back(id);
          h->mean_vals.push_back(val);
          h->var_vals.push_back(0.0);
        }
        if (!r.ok) return false;
      }
      h->mean_offs.push_back(static_cast<int64_t>(h->mean_vals.size()));
      // variances union
      int64_t branch = r.zigzag();
      uint8_t present = 0;
      if (branch != 0) {
        present = 1;
        int64_t vi = mean_base;
        for (;;) {
          int64_t n = r.zigzag();
          if (n == 0) break;
          if (n < 0) { n = -n; r.zigzag(); }
          for (int64_t i = 0; i < n; ++i) {
            int64_t id;
            double val;
            if (!read_ntv(r, &id, &val)) return false;
            if (vi >= static_cast<int64_t>(h->mean_vals.size()) ||
                h->mean_ids[vi] != id) {
              h->vars_align = false;
            } else {
              h->var_vals[vi] = val;
            }
            ++vi;
          }
          if (!r.ok) return false;
        }
        if (vi != static_cast<int64_t>(h->mean_vals.size()))
          h->vars_align = false;
      }
      h->var_present.push_back(present);
      // lossFunction union
      if (r.zigzag() != 0) {
        int64_t n = r.zigzag();
        r.skip_bytes(n);
      }
      if (!r.ok) return false;
      h->num_models++;
    }
    return true;
  };
  if (!walk_container(data, len, decode) || !h->vars_align) {
    delete h;
    return nullptr;
  }
  return h;
}

int64_t gdx_model_num(void* handle) {
  return static_cast<ModelHandle*>(handle)->num_models;
}

int64_t gdx_model_total_means(void* handle) {
  return static_cast<int64_t>(static_cast<ModelHandle*>(handle)->mean_vals.size());
}

int64_t gdx_model_id_bytes_len(void* handle) {
  return static_cast<int64_t>(static_cast<ModelHandle*>(handle)->id_bytes.size());
}

void gdx_model_fill(void* handle, uint8_t* id_bytes, int64_t* id_offs,
                    int64_t* mean_offs, int64_t* mean_ids, double* mean_vals,
                    double* var_vals, uint8_t* var_present) {
  auto* h = static_cast<ModelHandle*>(handle);
  std::memcpy(id_bytes, h->id_bytes.data(), h->id_bytes.size());
  std::memcpy(id_offs, h->id_offs.data(), h->id_offs.size() * 8);
  std::memcpy(mean_offs, h->mean_offs.data(), h->mean_offs.size() * 8);
  std::memcpy(mean_ids, h->mean_ids.data(), h->mean_ids.size() * 8);
  std::memcpy(mean_vals, h->mean_vals.data(), h->mean_vals.size() * 8);
  std::memcpy(var_vals, h->var_vals.data(), h->var_vals.size() * 8);
  std::memcpy(var_present, h->var_present.data(), h->var_present.size());
}

void gdx_model_free(void* handle) { delete static_cast<ModelHandle*>(handle); }

}  // extern "C"
