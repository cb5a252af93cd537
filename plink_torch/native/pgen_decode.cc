// Native .pgen record decoder: the hot host-side path of the reader.
//
// Mirrors the role of the reference's pgenlib_read.cc inner loops
// (ParseAndApplyDifflist / Plink1 translation / LD-diff application,
// 2.0/include/pgenlib_read.cc) for hardcall decoding of record types 0-7
// per pgen_spec.tex:345-466.  Exposed via ctypes;
// plink_tpu/io/pgen_read.py falls back to its vectorized-numpy
// implementation when this library is unavailable.
//
// Build: g++ -O3 -shared -fPIC -o libpgen_decode.so pgen_decode.cc

#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int sample_id_width(int64_t sample_ct) {
  if (sample_ct <= (1LL << 8)) return 1;
  if (sample_ct <= (1LL << 16)) return 2;
  if (sample_ct <= (1LL << 24)) return 3;
  return 4;
}

inline uint64_t decode_varint(const uint8_t* buf, int64_t* off) {
  uint64_t val = 0;
  int shift = 0;
  for (;;) {
    uint8_t b = buf[(*off)++];
    val |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) return val;
    shift += 7;
  }
}

inline void set_code(uint8_t* row, uint32_t sid, uint8_t val) {
  const uint32_t byte = sid >> 2;
  const uint32_t shift = (sid & 3) * 2;
  row[byte] = static_cast<uint8_t>(
      (row[byte] & ~(3u << shift)) | (static_cast<uint32_t>(val) << shift));
}

// Decode one difflist starting at *off, applying genotype patches to row
// (if row != nullptr).  Returns 0 on success.
int apply_difflist(const uint8_t* buf, int64_t* off, int64_t sample_ct,
                   uint8_t* row) {
  const uint64_t len = decode_varint(buf, off);
  if (len == 0) return 0;
  const int64_t group_ct = static_cast<int64_t>((len + 63) / 64);
  const int width = sample_id_width(sample_ct);
  const int64_t leaders_off = *off;
  *off += group_ct * width;
  *off += group_ct - 1;  // per-group byte sizes (sequential decode skips)
  const int64_t geno_off = *off;
  *off += static_cast<int64_t>((len + 3) / 4);
  // delta varints follow; walk groups
  uint64_t idx_in_list = 0;
  for (int64_t g = 0; g < group_ct; ++g) {
    // group leader
    uint64_t sid = 0;
    const uint8_t* lp = buf + leaders_off + g * width;
    for (int k = 0; k < width; ++k) sid |= static_cast<uint64_t>(lp[k]) << (8 * k);
    const uint64_t group_end =
        (g + 1 < group_ct) ? (g + 1) * 64ULL : len;
    for (uint64_t j = g * 64ULL; j < group_end; ++j) {
      if (j != static_cast<uint64_t>(g) * 64ULL) {
        sid += decode_varint(buf, off);
      }
      const uint8_t gval =
          (buf[geno_off + (j >> 2)] >> ((j & 3) * 2)) & 3;
      if (row) set_code(row, static_cast<uint32_t>(sid), gval);
      (void)idx_in_list;
    }
  }
  return 0;
}

// category swap 0<->2 for LD-inverted records (keeps 1 and 3)
void build_invert_table(uint8_t* table) {
  for (int b = 0; b < 256; ++b) {
    int out = 0;
    for (int s = 0; s < 8; s += 2) {
      int c = (b >> s) & 3;
      if (c == 0) c = 2;
      else if (c == 2) c = 0;
      out |= c << s;
    }
    table[b] = static_cast<uint8_t>(out);
  }
}

}  // namespace

extern "C" {

// Decode hardcalls for a batch of variable-width records.
//  buf        raw record bytes (records [0, vct) concatenated)
//  rel        int64[vct+1] record offsets into buf
//  vrtypes    uint8[vct]
//  sample_ct  N
//  ld_base    uint8[nb] in/out: rolling last-non-LD decoded row
//  ld_valid   int64* in/out: 1 if ld_base is valid on entry/exit
//  out        uint8[vct*nb]
// Returns 0 on success, negative error code otherwise.
int pgen_decode_block(const uint8_t* buf, const int64_t* rel,
                      const uint8_t* vrtypes, int64_t vct, int64_t sample_ct,
                      uint8_t* ld_base, int64_t* ld_valid, uint8_t* out) {
  const int64_t nb = (sample_ct + 3) / 4;
  // C++11 magic static: thread-safe one-time init (callers include the
  // multithreaded pgen_decode_block_mt workers).
  static const std::array<uint8_t, 256> invert_table = [] {
    std::array<uint8_t, 256> t{};
    build_invert_table(t.data());
    return t;
  }();
  const uint8_t tail_keep =
      (sample_ct & 3) ? static_cast<uint8_t>((1u << (2 * (sample_ct & 3))) - 1)
                      : 0xFF;
  for (int64_t i = 0; i < vct; ++i) {
    uint8_t* row = out + i * nb;
    int64_t off = rel[i];
    const int main = vrtypes[i] & 7;
    switch (main) {
      case 0: {
        std::memcpy(row, buf + off, nb);
        break;
      }
      case 1: {
        const uint8_t pair_code = buf[off++];
        uint8_t low, high;
        switch (pair_code) {
          case 1: low = 0; high = 1; break;
          case 2: low = 0; high = 2; break;
          case 3: low = 0; high = 3; break;
          case 5: low = 1; high = 2; break;
          case 6: low = 1; high = 3; break;
          case 9: low = 2; high = 3; break;
          default: return -2;
        }
        // expand 1 bit -> 2 bits; 4 genotypes per output byte
        const uint8_t* bits = buf + off;
        off += (sample_ct + 7) / 8;
        // two-entry nibble lookup: each input nibble (4 samples) -> 1 byte
        uint8_t lut[16];
        for (int v = 0; v < 16; ++v) {
          int o = 0;
          for (int s = 0; s < 4; ++s) {
            o |= ((v >> s) & 1 ? high : low) << (2 * s);
          }
          lut[v] = static_cast<uint8_t>(o);
        }
        for (int64_t b = 0; b < nb; ++b) {
          const uint8_t in = bits[b >> 1];
          row[b] = lut[(b & 1) ? (in >> 4) : (in & 0x0F)];
        }
        row[nb - 1] &= tail_keep;  // padding genotypes decode to 0
        if (apply_difflist(buf, &off, sample_ct, row)) return -3;
        break;
      }
      case 2:
      case 3: {
        if (!*ld_valid) return -4;
        std::memcpy(row, ld_base, nb);
        if (apply_difflist(buf, &off, sample_ct, row)) return -3;
        if (main == 3) {
          for (int64_t b = 0; b < nb; ++b) row[b] = invert_table[row[b]];
        }
        break;
      }
      case 4:
      case 6:
      case 7: {
        const uint8_t fill = (main == 4) ? 0x00 : (main == 6 ? 0xAA : 0xFF);
        std::memset(row, fill, nb);
        row[nb - 1] &= tail_keep;
        if (apply_difflist(buf, &off, sample_ct, row)) return -3;
        break;
      }
      default:
        return -5;
    }
    if (main != 2 && main != 3) {
      std::memcpy(ld_base, row, nb);
      *ld_valid = 1;
    }
  }
  return 0;
}

// Translate PLINK1 .bed bytes to pgen encoding in place-copy form.
void bed_to_pgen_bytes(const uint8_t* in, int64_t n, uint8_t* out) {
  static const std::array<uint8_t, 256> table = [] {
    std::array<uint8_t, 256> t{};
    const uint8_t map2[4] = {2, 3, 1, 0};
    for (int b = 0; b < 256; ++b) {
      int o = 0;
      for (int s = 0; s < 8; s += 2) o |= map2[(b >> s) & 3] << s;
      t[b] = static_cast<uint8_t>(o);
    }
    return t;
  }();
  for (int64_t i = 0; i < n; ++i) out[i] = table[in[i]];
}

}  // extern "C"


// Multithreaded block decode: partitions the variant range at LD-chain
// starts (records with main type not in {2,3}) so each worker owns whole
// chains and needs no cross-thread ld_base.  Segment 0 uses the caller's
// rolling ld_base for chains continuing from the previous block.
extern "C" int pgen_decode_block_mt(const uint8_t* buf, const int64_t* rel,
                                    const uint8_t* vrtypes, int64_t vct,
                                    int64_t sample_ct, uint8_t* ld_base,
                                    int64_t* ld_valid, uint8_t* out,
                                    int nthreads) {
  const int64_t nb = (sample_ct + 3) / 4;
  if (nthreads <= 1 || vct < 64) {
    return pgen_decode_block(buf, rel, vrtypes, vct, sample_ct, ld_base,
                             ld_valid, out);
  }
  // collect chain starts
  std::vector<int64_t> starts;
  starts.reserve(1024);
  for (int64_t i = 0; i < vct; ++i) {
    const int m = vrtypes[i] & 7;
    if (m != 2 && m != 3) starts.push_back(i);
  }
  if (starts.size() < 2) {
    return pgen_decode_block(buf, rel, vrtypes, vct, sample_ct, ld_base,
                             ld_valid, out);
  }
  int T = nthreads;
  if (static_cast<int64_t>(starts.size()) < T) T = static_cast<int>(starts.size());
  std::vector<int64_t> seg(T + 1);
  seg[0] = 0;
  for (int t = 1; t < T; ++t) {
    seg[t] = starts[(starts.size() * t) / T];
  }
  seg[T] = vct;
  std::vector<int> rcs(T, 0);
  std::vector<std::vector<uint8_t>> bases(T);
  std::vector<int64_t> valids(T, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < T; ++t) {
    threads.emplace_back([&, t]() {
      bases[t].resize(nb);
      int64_t lv = 0;
      uint8_t* lb = bases[t].data();
      if (t == 0) {
        std::memcpy(lb, ld_base, nb);
        lv = *ld_valid;
      }
      rcs[t] = pgen_decode_block(buf, rel + seg[t], vrtypes + seg[t],
                                 seg[t + 1] - seg[t], sample_ct, lb, &lv,
                                 out + seg[t] * nb);
      valids[t] = lv;
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < T; ++t) {
    if (rcs[t]) return rcs[t];
  }
  for (int t = T - 1; t >= 0; --t) {
    if (valids[t]) {
      std::memcpy(ld_base, bases[t].data(), nb);
      *ld_valid = 1;
      break;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// VCF GT-region parser: the import hot loop.
//
// Mirrors the role of the reference's VcfGenoToPgenThread GT scanner
// (2.0/plink2_import.cc:1712+): biallelic hardcall GT fields -> pgen codes
// 0/1/2 (ALT-allele count) and 3 (missing), with the VcfHalfCall modes.
// One call parses a batch of rows; rows the fast scanner cannot commit to
// (multi-digit corner cases are handled inline; genuinely odd rows get
// status=1) are re-parsed by the Python fallback.
// ---------------------------------------------------------------------------

namespace {

// parse one sample field starting at p (exclusive end at lim); the field
// ends at '\t' or lim; subfields after ':' are skipped.
// returns the pgen code; sets *bad on malformed content; *phased/*swap
// report biallelic phased-het state ("0|1" / "1|0", the only hardcall
// phase the pgen track stores).
inline uint8_t parse_gt_field(const char*& p, const char* lim, int halfcall,
                              bool* bad, bool* err_halfcall, uint8_t* phased,
                              uint8_t* swap) {
  int alleles[4];
  int n_alleles = 0;
  int n_slots = 0;
  bool half = false;
  char sep = 0;
  *phased = 0;
  *swap = 0;
  for (;;) {
    // one allele slot
    if (p >= lim || *p == '\t') {
      // empty trailing slot ("0/")
      ++n_slots;
      half = true;
      break;
    }
    char c = *p;
    if (c == '.') {
      ++n_slots;
      half = true;
      ++p;
    } else if (c >= '0' && c <= '9') {
      int v = 0;
      while (p < lim && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        ++p;
      }
      ++n_slots;
      if (n_alleles < 4) alleles[n_alleles++] = v;
    } else {
      *bad = true;
      // skip to field end
      while (p < lim && *p != '\t') ++p;
      if (p < lim) ++p;
      return 3;
    }
    if (p < lim && (*p == '/' || *p == '|')) {
      if (!sep) sep = *p;
      ++p;
      continue;
    }
    break;
  }
  // skip subfields to field end
  while (p < lim && *p != '\t') ++p;
  if (p < lim) ++p;

  // phased biallelic het: "0|1" / "1|0" (io/vcf.py phase block semantics)
  if (sep == '|' && n_slots == 2 && n_alleles == 2 && !half &&
      alleles[0] <= 1 && alleles[1] <= 1 && alleles[0] != alleles[1]) {
    *phased = 1;
    *swap = alleles[0] == 1;
  }

  // decision tree identical to io/vcf.py _parse_gt
  if (half && n_alleles > 0 && n_slots > 1) {
    for (int i = 0; i < n_alleles; ++i) {
      if (alleles[i] > 1) return 3;
    }
    if (halfcall == 3) {
      *err_halfcall = true;
      return 3;
    }
    if (halfcall == 2) return 3;
    return static_cast<uint8_t>(alleles[0] << halfcall);
  }
  if (n_alleles == 0) return 3;
  for (int i = 0; i < n_alleles; ++i) {
    if (alleles[i] > 1) return 3;
  }
  if (n_alleles == 1) return alleles[0] == 1 ? 2 : 0;
  return static_cast<uint8_t>(alleles[0] + alleles[1]);
}

int parse_gt_rows_range(const char* buf, const int64_t* offs, int64_t r0,
                        int64_t r1, int64_t n_samples, int halfcall,
                        uint8_t* out, uint8_t* status, uint8_t* phased,
                        uint8_t* swap) {
  for (int64_t r = r0; r < r1; ++r) {
    const char* p = buf + offs[r];
    const char* lim = buf + offs[r + 1];
    // rows are '\n'-terminated in the batch buffer
    if (lim > p && lim[-1] == '\n') --lim;
    uint8_t* row = out + r * n_samples;
    uint8_t* prow = phased ? phased + r * n_samples : nullptr;
    uint8_t* srow = swap ? swap + r * n_samples : nullptr;
    bool bad = false;
    bool err_half = false;
    uint8_t ph, sw;
    int64_t s = 0;
    for (; s < n_samples && p <= lim; ++s) {
      row[s] = parse_gt_field(p, lim, halfcall, &bad, &err_half, &ph, &sw);
      if (prow) {
        prow[s] = ph;
        srow[s] = sw;
      }
    }
    if (bad || err_half || s != n_samples || p < lim) {
      status[r] = err_half ? 2 : 1;
    } else {
      status[r] = 0;
    }
  }
  return 0;
}

}  // namespace

extern "C" int vcf_parse_gt_rows(const char* buf, const int64_t* offs,
                                 int64_t n_rows, int64_t n_samples,
                                 int halfcall, uint8_t* out, uint8_t* status,
                                 uint8_t* phased, uint8_t* swap,
                                 int nthreads) {
  if (nthreads <= 1 || n_rows < 64) {
    return parse_gt_rows_range(buf, offs, 0, n_rows, n_samples, halfcall,
                               out, status, phased, swap);
  }
  int T = nthreads;
  std::vector<std::thread> threads;
  for (int t = 0; t < T; ++t) {
    int64_t r0 = n_rows * t / T;
    int64_t r1 = n_rows * (t + 1) / T;
    threads.emplace_back(parse_gt_rows_range, buf, offs, r0, r1, n_samples,
                         halfcall, out, status, phased, swap);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// ---------------------------------------------------------------------------
// pgen hardcall row encoder: native mirror of io/pgen_write.py _append_one.
//
// Byte-for-byte identical to the Python writer (which is differential-tested
// against plink2): same candidate order (dense, difflist 4/6/7, 1-bit,
// LD type 2), same cost heuristics, same difflist layout
// (pgen_spec.tex:354-421).  The Python writer remains the reference
// implementation / fallback.
// ---------------------------------------------------------------------------

namespace {

inline int varint_len(uint64_t v) {
  int n = 1;
  while (v >= 0x80) {
    v >>= 7;
    ++n;
  }
  return n;
}

inline void put_varint(std::vector<uint8_t>& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back(static_cast<uint8_t>(v) | 0x80);
    v >>= 7;
  }
  out.push_back(static_cast<uint8_t>(v));
}

inline int64_t difflist_cost(int64_t n_entries, int64_t sample_ct) {
  if (n_entries == 0) return 1;
  int64_t G = (n_entries + 63) / 64;
  int64_t width = sample_ct <= 256 ? 1
                  : sample_ct <= 65536 ? 2
                  : sample_ct <= (1LL << 24) ? 3 : 4;
  return 3 + G * width + (G - 1) + (n_entries + 3) / 4 + 2 * (n_entries - G);
}

// encode a difflist over the given sample ids (with genotype values) into
// out; ids must be ascending.
void encode_difflist_cc(const uint32_t* ids, const uint8_t* vals, int64_t L,
                        int64_t sample_ct, std::vector<uint8_t>& out) {
  put_varint(out, static_cast<uint64_t>(L));
  if (L == 0) return;
  int64_t G = (L + 63) / 64;
  int width = sample_id_width(sample_ct);
  // leaders
  for (int64_t g = 0; g < G; ++g) {
    uint32_t v = ids[g * 64];
    for (int k = 0; k < width; ++k) out.push_back((v >> (8 * k)) & 0xFF);
  }
  // per-group payload sizes (G-1 bytes, minus-63 biased)
  if (G > 1) {
    for (int64_t g = 0; g + 1 < G; ++g) {
      int64_t bytes = 0;
      for (int64_t i = g * 64 + 1; i < (g + 1) * 64; ++i) {
        bytes += varint_len(ids[i] - ids[i - 1]);
      }
      out.push_back(static_cast<uint8_t>(bytes - 63));
    }
  }
  // packed genotype values
  if (vals) {
    int64_t gbytes = (L + 3) / 4;
    size_t base = out.size();
    out.resize(base + gbytes, 0);
    for (int64_t i = 0; i < L; ++i) {
      out[base + (i >> 2)] |= static_cast<uint8_t>(vals[i] << ((i & 3) * 2));
    }
  }
  // delta varints (non-leader positions)
  for (int64_t i = 1; i < L; ++i) {
    if (i % 64 == 0) continue;
    put_varint(out, ids[i] - ids[i - 1]);
  }
}

// encode one row; appends the chosen body to out and returns the vrtype.
// Decision rule is a faithful port of PwcAppendBiallelicGenovecMain
// (2.0/include/pgenlib_write.cc:915): difflist viability via the
// sample_ct/8 threshold, LD considered first with the difflist_len -
// sample_ct/64 threshold (inverted LD preferred on strictly fewer
// diffs), then 1-bit when the two rare categories sum below N/16,
// then plain difflist, else dense.  The genocount prescreen before the
// brute-force LD diff is a sound lower bound upstream, so skipping it
// cannot change any decision.
int encode_row_cc(const uint8_t* row, int64_t N, const uint8_t* ld_base,
                  int use_ld, int at_block_start,
                  std::vector<uint8_t>& scratch_ids,
                  std::vector<uint8_t>& out_body) {
  int64_t counts[4] = {0, 0, 0, 0};
  for (int64_t i = 0; i < N; ++i) ++counts[row[i]];
  int most = counts[1] > counts[0] ? 1 : 0;
  int second = 1 - most;
  int64_t largest = counts[most], second_largest = counts[second];
  for (int g = 2; g < 4; ++g) {
    if (counts[g] > second_largest) {
      if (counts[g] > largest) {
        second_largest = largest;
        second = most;
        largest = counts[g];
        most = g;
      } else {
        second_largest = counts[g];
        second = g;
      }
    }
  }
  const int64_t difflist_len = N - largest;
  const int64_t rare2 = difflist_len - second_largest;
  const int64_t d8 = N / 8, d64 = N / 64;
  int64_t max_dl = d8 - 2 * d64 + rare2;
  if (max_dl > d8) max_dl = d8;
  const int viable = (most != 1) && (difflist_len <= max_dl);

  std::vector<uint32_t> ids;
  std::vector<uint8_t> vals;
  ids.reserve(256);
  vals.reserve(256);
  out_body.clear();

  if (use_ld && ld_base && !at_block_start && difflist_len > d64) {
    const int64_t thr = viable ? (difflist_len - d64) : max_dl;
    int64_t ld_diff = 0, ld_inv = 0;
    for (int64_t i = 0; i < N; ++i) {
      const uint8_t b = ld_base[i];
      const uint8_t v = row[i];
      const uint8_t vi = v == 0 ? 2 : (v == 2 ? 0 : v);
      ld_diff += v != b;
      ld_inv += vi != b;
    }
    if (ld_diff < thr || ld_inv < thr) {
      const int inv = ld_inv < ld_diff;
      for (int64_t i = 0; i < N; ++i) {
        const uint8_t v = row[i];
        const uint8_t cur = inv ? (v == 0 ? 2 : (v == 2 ? 0 : v)) : v;
        if (cur != ld_base[i]) {
          ids.push_back(static_cast<uint32_t>(i));
          vals.push_back(cur);
        }
      }
      encode_difflist_cc(ids.data(), vals.data(),
                         static_cast<int64_t>(ids.size()), N, out_body);
      (void)scratch_ids;
      return 2 + inv;
    }
  }
  if (!viable && rare2 < N / 16) {
    const int a = most < second ? most : second;
    const int b = most < second ? second : most;
    static const int code_map[4][4] = {
        {0, 1, 2, 3}, {0, 0, 5, 6}, {0, 0, 0, 9}, {0, 0, 0, 0}};
    out_body.push_back(static_cast<uint8_t>(code_map[a][b]));
    const int64_t bitbytes = (N + 7) / 8;
    const size_t base = out_body.size();
    out_body.resize(base + bitbytes, 0);
    for (int64_t i = 0; i < N; ++i) {
      const uint8_t v = row[i];
      if (v == b) {
        out_body[base + (i >> 3)] |= static_cast<uint8_t>(1u << (i & 7));
      } else if (v != a) {
        ids.push_back(static_cast<uint32_t>(i));
        vals.push_back(v);
      }
    }
    encode_difflist_cc(ids.data(), vals.data(),
                       static_cast<int64_t>(ids.size()), N, out_body);
    return 1;
  }
  if (viable) {
    for (int64_t i = 0; i < N; ++i) {
      if (row[i] != most) {
        ids.push_back(static_cast<uint32_t>(i));
        vals.push_back(row[i]);
      }
    }
    encode_difflist_cc(ids.data(), vals.data(),
                       static_cast<int64_t>(ids.size()), N, out_body);
    return 4 + most;
  }
  const int64_t nb = (N + 3) / 4;
  out_body.assign(nb, 0);
  for (int64_t i = 0; i < N; ++i) {
    out_body[i >> 2] |= static_cast<uint8_t>(row[i] << ((i & 3) * 2));
  }
  return 0;
}

}  // namespace

// Encode a batch of rows (LD chain handled internally).
// rows: [n_rows, N]; written0: global index of the first row (block-start
// detection); ld_base: in/out [N] with ld_valid in/out flag.
// out: byte buffer of capacity out_cap; offs[n_rows+1] body offsets;
// vrtypes[n_rows].  Returns bytes written, or -1 if out_cap is too small.
extern "C" int64_t pgen_encode_rows(const uint8_t* rows, int64_t n_rows,
                                    int64_t N, int64_t written0, int use_ld,
                                    uint8_t* ld_base, int64_t* ld_valid,
                                    uint8_t* out, int64_t out_cap,
                                    int64_t* offs, uint8_t* vrtypes) {
  std::vector<uint8_t> scratch;
  std::vector<uint8_t> body;
  int64_t pos = 0;
  offs[0] = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    const uint8_t* row = rows + r * N;
    int at_start = ((written0 + r) & 0xFFFF) == 0;
    int vt = encode_row_cc(row, N, *ld_valid ? ld_base : nullptr, use_ld,
                           at_start, scratch, body);
    if (pos + static_cast<int64_t>(body.size()) > out_cap) return -1;
    std::memcpy(out + pos, body.data(), body.size());
    pos += static_cast<int64_t>(body.size());
    offs[r + 1] = pos;
    vrtypes[r] = static_cast<uint8_t>(vt);
    if (vt != 2 && vt != 3) {
      std::memcpy(ld_base, row, N);
      *ld_valid = 1;
    }
  }
  return pos;
}

// ---------------------------------------------------------------------------
// --lasso coordinate-descent inner loop (one lambda): faithful mirror of the
// reference's per-lambda solve (1.9/plink_lasso.c:295-362 lasso_bigmem main
// loop) including the active-set removal, the error criterion
// (lambda*sum|xhat| + rss, relative delta < 1e-4), and f64 operation order.
// X is column-standardized [C, n] row-major (one column of the design per
// row here); unpen_ct = leading unpenalized covariate count.
// ---------------------------------------------------------------------------

extern "C" int64_t lasso_cd_lambda(const double* X, int64_t C, int64_t n,
                                   double lambda, int64_t unpen_ct,
                                   const double* y, double* xhat,
                                   double* residuals) {
  // residuals = y - X^T xhat
  std::memcpy(residuals, y, n * sizeof(double));
  for (int64_t j = 0; j < C; ++j) {
    const double w = -xhat[j];
    if (w == 0.0) continue;
    const double* xj = X + j * n;
    for (int64_t i = 0; i < n; ++i) residuals[i] += xj[i] * w;
  }
  std::vector<uint8_t> active(C, 1);
  int64_t nz = C;
  int64_t iter = 0;
  double err_last = 0.0, err_cur = 0.0;
  for (;;) {
    for (int64_t j = 0; j < C; ++j) {
      if (!active[j]) continue;
      const double* xj = X + j * n;
      const double xjold = xhat[j];
      double v = xjold;
      for (int64_t i = 0; i < n; ++i) v += xj[i] * residuals[i];
      if (j >= unpen_ct) {
        if (v > 0.0) {
          v = v - lambda > 0.0 ? v - lambda : 0.0;
        } else {
          v = v + lambda < 0.0 ? v + lambda : 0.0;
        }
      }
      xhat[j] = v;
      if (v == 0.0) {
        active[j] = 0;
        --nz;
      }
      const double d = v - xjold;
      if (d != 0.0) {
        for (int64_t i = 0; i < n; ++i) residuals[i] -= xj[i] * d;
      }
    }
    err_last = err_cur;
    err_cur = 0.0;
    for (int64_t j = 0; j < C; ++j) {
      if (active[j]) err_cur += std::fabs(xhat[j]);
    }
    err_cur *= lambda;
    for (int64_t i = 0; i < n; ++i) err_cur += residuals[i] * residuals[i];
    if (iter++) {
      const double lo = err_last < err_cur ? err_last : err_cur;
      const double hi = err_last < err_cur ? err_cur : err_last;
      if ((1.0 - lo / hi) < 0.0001 || err_cur != err_cur) {
        return iter;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// --indep-pairwise greedy window walk (ref: IndepPairwiseThread,
// 2.0/plink2_ld.cc:801-1116).  The banded r^2-vs-threshold DECISIONS are
// precomputed on the TPU (ops/ld.py::_ld_band_bits_scan); this walk
// consumes the bit band.  exceeds layout: [n][width+1] uint8, entry [i][d]
// for pair (i, i+d).  Semantics mirror commands/ld.py::_prune_subcontig
// exactly (reverse second scan, removed seconds still prune earlier
// partners, (1+2^-44) major-frequency tie-break, LdPruneNextWindow advance
// in both ct and kb modes).
extern "C" void ld_prune_walk(
    const uint8_t* exceeds, const uint8_t* mono, const double* majf,
    const int64_t* bps, int64_t n, int64_t width, int64_t ws, int is_kb,
    int64_t step, double eps, uint8_t* removed) {
  const int64_t W = width + 1;
  std::vector<int64_t> window;
  std::vector<uint8_t> cur_removed;
  window.reserve(2 * (size_t)ws + 4);
  cur_removed.reserve(2 * (size_t)ws + 4);
  int64_t winpos_split = 0;
  int64_t start = 0;
  int64_t next_end;
  if (is_kb) {
    int64_t end_bp_thresh = bps[0] + ws;
    int64_t first_len = 1;
    while (first_len < n && bps[first_len] <= end_bp_thresh) ++first_len;
    next_end = first_len;
  } else {
    next_end = ws < n ? ws : n;
  }
  int64_t cur = 0;
  while (cur < n) {
    int64_t i = cur;
    if (mono[i]) {
      cur_removed.push_back(1);
      removed[i] = 1;
    } else {
      cur_removed.push_back(0);
    }
    window.push_back(i);
    ++cur;
    if (cur != next_end) continue;
    // ---- process window pairs (default reverse-scan order) ----
    const int64_t stop = winpos_split ? winpos_split : 1;
    const int64_t wlen = (int64_t)window.size();
    for (int64_t second = wlen - 1; second >= stop; --second) {
      // the reference does NOT skip a removed 'second' here
      // (plink2_ld.cc:1043-1049): it still prunes earlier partners
      const int64_t s_loc = window[second];
      for (int64_t fp = second - 1; fp >= 0; --fp) {
        if (cur_removed[fp]) continue;
        const int64_t f_loc = window[fp];
        if (!exceeds[f_loc * W + (s_loc - f_loc)]) continue;
        if (majf[f_loc] <= majf[s_loc] * eps) {
          cur_removed[second] = 1;
          removed[s_loc] = 1;
          break;
        }
        cur_removed[fp] = 1;
        removed[f_loc] = 1;
      }
    }
    // ---- advance window (ref LdPruneNextWindow) ----
    if (next_end == n) break;
    int64_t new_start;
    if (is_kb) {
      new_start = start;
      const int64_t min_bp = bps[next_end] - ws;
      for (;;) {
        ++new_start;
        if (bps[new_start] >= min_bp) break;
      }
      const int64_t end_thresh = bps[new_start] + ws;
      int64_t ne = next_end;
      while (ne < n && bps[ne] <= end_thresh) ++ne;
      next_end = ne;
    } else {
      new_start = start + step;
      next_end = new_start + ws < n ? new_start + ws : n;
    }
    size_t out = 0;
    for (size_t wp = 0; wp < window.size(); ++wp) {
      if (cur_removed[wp] || window[wp] < new_start) continue;
      window[out] = window[wp];
      cur_removed[out] = 0;
      ++out;
    }
    window.resize(out);
    cur_removed.resize(out);
    winpos_split = (int64_t)out;
    start = new_start;
  }
}

// ---------------------------------------------------------------------------
// Deterministic synthetic-panel generators (bench harness).
//
// Role model: plink2's --dummy generator (GenerateDummy,
// 2.0/plink2_import.cc:16326) and the structured-panel maker in
// plink_tpu/testgen.py.  Unlike those, these use a STATELESS counter-based
// RNG (splitmix64 finalizer per cell) so that (a) output is byte-identical
// regardless of thread count, and (b) the pure-numpy fallback in
// plink_tpu/bench_gen.py reproduces the exact same bytes (only IEEE
// add/mul/compare in the cell path -- no transcendentals anywhere).
//
// Output: mode-0x02 .pgen (fixed-width 2-bit records; pgen_spec.tex storage
// mode 2): magic 6C 1B, 0x02, u32 variant_ct, u32 sample_ct, 0x40, rows.
// ---------------------------------------------------------------------------

#include <cstdio>
#include <unistd.h>

namespace {

constexpr uint64_t kGold = 0x9E3779B97F4A7C15ULL;

inline uint64_t mix64(uint64_t z) {
  z ^= z >> 30;
  z *= 0xBF58476D1CE4E5B9ULL;
  z ^= z >> 27;
  z *= 0x94D049BB133111EBULL;
  z ^= z >> 31;
  return z;
}

inline double u64_to_unit(uint64_t r) {
  return static_cast<double>(r >> 11) * (1.0 / 9007199254740992.0);
}

// Irwin-Hall(12) - 6: approximately standard normal, built from adds only
// so the numpy fallback is bit-identical.
inline double gauss12(uint64_t key) {
  double acc = 0.0;
  for (uint64_t i = 0; i < 12; ++i) {
    acc += u64_to_unit(mix64(key + i * kGold));
  }
  return acc - 6.0;
}

struct PanelWriter {
  FILE* f;
  uint32_t nb;  // bytes per row
  int ok;
};

// Generate rows [v0, v1) of an iid panel into buf (nb bytes per row).
void iid_rows(uint64_t seed, uint32_t sample_ct, uint32_t v0, uint32_t v1,
              uint32_t miss21, uint8_t* buf, uint32_t nb) {
  for (uint32_t v = v0; v < v1; ++v) {
    const uint64_t rowkey = mix64(seed ^ ((static_cast<uint64_t>(v) + 1) * kGold));
    const double p = u64_to_unit(mix64(rowkey ^ 0xA5A5A5A5A5A5A5A5ULL));
    const uint32_t p21 = static_cast<uint32_t>(p * 2097152.0);
    uint8_t* row = buf + static_cast<size_t>(v - v0) * nb;
    memset(row, 0, nb);
    for (uint32_t s = 0; s < sample_ct; ++s) {
      const uint64_t r = mix64(rowkey + (static_cast<uint64_t>(s) + 1) * kGold);
      uint32_t code = (static_cast<uint32_t>(r & 0x1FFFFF) < p21)
                    + (static_cast<uint32_t>((r >> 21) & 0x1FFFFF) < p21);
      if (static_cast<uint32_t>((r >> 42) & 0x1FFFFF) < miss21) code = 3;
      row[s >> 2] |= static_cast<uint8_t>(code << ((s & 3) * 2));
    }
  }
}

// Generate rows [v0, v1) of a structured panel: per-sample latent scores
// u[s][j] (k axes), per-variant loadings scaled by scale_top*decay^j,
// p(s) = clip(base_v + sum_j wl_j u_sj, 0.01, 0.99).
void structured_rows(uint64_t seed, uint32_t sample_ct, uint32_t k,
                     const double* u, const double* scales, uint32_t v0,
                     uint32_t v1, uint32_t miss21, uint8_t* buf, uint32_t nb,
                     double* pbuf) {
  for (uint32_t v = v0; v < v1; ++v) {
    const uint64_t rowkey = mix64(seed ^ ((static_cast<uint64_t>(v) + 1) * kGold));
    const double base =
        0.1 + 0.4 * u64_to_unit(mix64(rowkey ^ 0xA5A5A5A5A5A5A5A5ULL));
    double wl[64];
    for (uint32_t j = 0; j < k; ++j) {
      wl[j] = gauss12(mix64(rowkey ^ 0x5151515151515151ULL) + j * 977ULL * kGold)
              * scales[j];
    }
    // p per sample: explicit j-major accumulation (numpy fallback adds in
    // the same order, keeping the floats bit-identical)
    for (uint32_t s = 0; s < sample_ct; ++s) pbuf[s] = base;
    for (uint32_t j = 0; j < k; ++j) {
      const double wlj = wl[j];
      const double* uj = u + static_cast<size_t>(j) * sample_ct;
      for (uint32_t s = 0; s < sample_ct; ++s) pbuf[s] += wlj * uj[s];
    }
    uint8_t* row = buf + static_cast<size_t>(v - v0) * nb;
    memset(row, 0, nb);
    for (uint32_t s = 0; s < sample_ct; ++s) {
      double p = pbuf[s];
      if (p < 0.01) p = 0.01;
      if (p > 0.99) p = 0.99;
      const uint32_t p21 = static_cast<uint32_t>(p * 2097152.0);
      const uint64_t r = mix64(rowkey + (static_cast<uint64_t>(s) + 1) * kGold);
      uint32_t code = (static_cast<uint32_t>(r & 0x1FFFFF) < p21)
                    + (static_cast<uint32_t>((r >> 21) & 0x1FFFFF) < p21);
      if (miss21 && static_cast<uint32_t>((r >> 42) & 0x1FFFFF) < miss21)
        code = 3;
      row[s >> 2] |= static_cast<uint8_t>(code << ((s & 3) * 2));
    }
  }
}

int panelgen_write(const char* path, uint64_t seed, uint32_t sample_ct,
                   uint32_t variant_ct, double miss_rate, int nthreads,
                   uint32_t k, double scale_top, double decay) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  const uint32_t nb = (sample_ct + 3) / 4;
  uint8_t header[12];
  header[0] = 0x6C;
  header[1] = 0x1B;
  header[2] = 0x02;
  memcpy(header + 3, &variant_ct, 4);
  memcpy(header + 7, &sample_ct, 4);
  header[11] = 0x40;
  if (fwrite(header, 1, 12, f) != 12) { fclose(f); return 1; }
  // preallocate by writing the last byte
  const uint64_t total = 12 + static_cast<uint64_t>(variant_ct) * nb;
  if (fseeko(f, static_cast<off_t>(total - 1), SEEK_SET) != 0 ||
      fwrite("", 1, 1, f) != 1) { fclose(f); return 1; }
  fflush(f);
  const int fd = fileno(f);

  const uint32_t miss21 = static_cast<uint32_t>(miss_rate * 2097152.0);
  std::vector<double> u;
  std::vector<double> scales;
  if (k) {
    // per-sample latent scores, j-major [k][sample_ct]
    u.resize(static_cast<size_t>(k) * sample_ct);
    scales.resize(k);
    for (uint32_t j = 0; j < k; ++j) scales[j] = scale_top;
    for (uint32_t j = 1; j < k; ++j) scales[j] = scales[j - 1] * decay;
    const uint64_t ukey = mix64(seed ^ 0x3C3C3C3C3C3C3C3CULL);
    for (uint32_t j = 0; j < k; ++j) {
      double* uj = &u[static_cast<size_t>(j) * sample_ct];
      for (uint32_t s = 0; s < sample_ct; ++s) {
        uj[s] = gauss12(ukey + (static_cast<uint64_t>(s) * 64 + j) * 131ULL * kGold);
      }
    }
  }

  if (nthreads < 1) nthreads = 1;
  const uint32_t chunk = 256;
  std::vector<std::thread> threads;
  std::vector<int> errs(nthreads, 0);
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([&, t]() {
      std::vector<uint8_t> buf(static_cast<size_t>(chunk) * nb);
      std::vector<double> pbuf(k ? sample_ct : 0);
      for (uint64_t c0 = static_cast<uint64_t>(t) * chunk; c0 < variant_ct;
           c0 += static_cast<uint64_t>(nthreads) * chunk) {
        const uint32_t v0 = static_cast<uint32_t>(c0);
        const uint32_t v1 = v0 + chunk < variant_ct ? v0 + chunk : variant_ct;
        if (k) {
          structured_rows(seed, sample_ct, k, u.data(), scales.data(), v0, v1,
                          miss21, buf.data(), nb, pbuf.data());
        } else {
          iid_rows(seed, sample_ct, v0, v1, miss21, buf.data(), nb);
        }
        const uint64_t off = 12 + static_cast<uint64_t>(v0) * nb;
        const size_t len = static_cast<size_t>(v1 - v0) * nb;
        size_t done = 0;
        while (done < len) {
          ssize_t w = pwrite(fd, buf.data() + done, len - done,
                             static_cast<off_t>(off + done));
          if (w <= 0) { errs[t] = 1; return; }
          done += static_cast<size_t>(w);
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  fclose(f);
  for (int t = 0; t < nthreads; ++t) {
    if (errs[t]) return 1;
  }
  return 0;
}

}  // namespace

extern "C" int panelgen_iid(const char* path, uint64_t seed,
                            uint32_t sample_ct, uint32_t variant_ct,
                            double miss_rate, int nthreads) {
  return panelgen_write(path, seed, sample_ct, variant_ct, miss_rate,
                        nthreads, 0, 0.0, 0.0);
}

extern "C" int panelgen_structured(const char* path, uint64_t seed,
                                   uint32_t sample_ct, uint32_t variant_ct,
                                   uint32_t k, double scale_top, double decay,
                                   double miss_rate, int nthreads) {
  if (k > 64) return 2;
  return panelgen_write(path, seed, sample_ct, variant_ct, miss_rate,
                        nthreads, k, scale_top, decay);
}

// ---------------------------------------------------------------------------
// C FFI API for external bindings (R pgenlibr, Julia, ...).
//
// Role model: the reference's pgenlib FFI layer (pgenlib_ffi_support.cc and
// 2.0/pgenlibr/src/pgenlibr.cpp) -- an opened-file handle plus per-variant
// hardcall readers.  This implementation is self-contained C++ (no Python):
// it parses the .pgen header (storage modes 0x01/0x02/0x03/0x04/0x10/0x11
// per pgen_spec.tex) and decodes hardcall records through the same
// pgen_decode_block() used by the Python reader.  Biallelic hardcalls only
// in v1 (multiallelic patches / dosage / phase tracks are skipped -- they
// live AFTER the hardcall track in each record, so decoding stays correct).
//
// Tested from Python via ctypes (tests/test_capi.py) against the
// differential-tested Python reader; the R package under bindings/pgenlibr
// wraps exactly these entry points.
// ---------------------------------------------------------------------------

#include <cstdio>

namespace {

struct PgenCHandle {
  std::vector<uint8_t> file;
  uint32_t mode = 0;
  uint32_t variant_ct = 0;
  uint32_t sample_ct = 0;
  std::vector<uint8_t> vrtypes;
  std::vector<uint64_t> offsets;  // variant_ct + 1 absolute offsets
};

int parse_pgen_header(PgenCHandle* h, uint32_t sample_ct_hint) {
  const std::vector<uint8_t>& f = h->file;
  if (f.size() < 3 || f[0] != 0x6C || f[1] != 0x1B) return 1;
  const uint32_t mode = f[2];
  h->mode = mode;
  if (mode == 0x01) {  // PLINK1 .bed, variant-major
    if (!sample_ct_hint) return 2;
    h->sample_ct = sample_ct_hint;
    const uint64_t nb = (sample_ct_hint + 3) / 4;
    h->variant_ct = static_cast<uint32_t>((f.size() - 3) / nb);
    // decode as dense 2-bit copies (vrtype 0); pgen_capi_read_codes then
    // applies the .bed -> pgen code translation
    h->vrtypes.assign(h->variant_ct, 0);
    h->offsets.resize(h->variant_ct + 1);
    for (uint64_t v = 0; v <= h->variant_ct; ++v)
      h->offsets[v] = 3 + v * nb;
    return 0;
  }
  if (mode != 0x02 && mode != 0x03 && mode != 0x04 && mode != 0x10 &&
      mode != 0x11)
    return 3;
  if (f.size() < 12) return 1;
  uint32_t variant_ct, sample_ct;
  memcpy(&variant_ct, &f[3], 4);
  memcpy(&sample_ct, &f[7], 4);
  h->variant_ct = variant_ct;
  h->sample_ct = sample_ct;
  const uint8_t fmt = f[11];
  size_t pos = 12;
  if (mode == 0x02 || mode == 0x03 || mode == 0x04) {
    const uint8_t vrtype_val = (mode == 0x02) ? 0 : (mode == 0x03 ? 0x40 : 0xC0);
    const uint64_t nb = (sample_ct + 3) / 4;
    const uint64_t rec_len =
        nb + (mode == 0x03 ? 2ull * sample_ct
                           : (mode == 0x04 ? 4ull * sample_ct : 0));
    const uint32_t prv_code = (fmt >> 6) & 3;
    if (prv_code == 3) pos += (variant_ct + 7) / 8;
    h->vrtypes.assign(variant_ct, vrtype_val);
    h->offsets.resize(variant_ct + 1ull);
    for (uint64_t v = 0; v <= variant_ct; ++v)
      h->offsets[v] = pos + v * rec_len;
    return 0;
  }
  // modes 0x10/0x11: variable-width records
  const uint32_t vrtype_len_code = fmt & 0x0F;
  if (vrtype_len_code > 7) return 4;
  const bool vrtype_8bit = vrtype_len_code >= 4;
  const uint32_t len_bytes = (vrtype_len_code & 3) + 1;
  const uint32_t ac_bytes = (fmt >> 4) & 3;
  const uint32_t prv_code = (fmt >> 6) & 3;
  const uint64_t n_blocks = (static_cast<uint64_t>(variant_ct) + 65535) >> 16;
  std::vector<uint64_t> block_offsets(n_blocks);
  if (pos + 8 * n_blocks > f.size()) return 1;
  memcpy(block_offsets.data(), &f[pos], 8 * n_blocks);
  pos += 8 * n_blocks;
  h->vrtypes.resize(variant_ct);
  std::vector<uint64_t> rec_lens(variant_ct);
  for (uint64_t b = 0; b < n_blocks; ++b) {
    const uint64_t vstart = b << 16;
    const uint64_t vct = std::min<uint64_t>(65536, variant_ct - vstart);
    if (vrtype_8bit) {
      if (pos + vct > f.size()) return 1;
      memcpy(&h->vrtypes[vstart], &f[pos], vct);
      pos += vct;
    } else {
      const uint64_t nbytes = (vct + 1) / 2;
      if (pos + nbytes > f.size()) return 1;
      for (uint64_t i = 0; i < vct; ++i) {
        const uint8_t raw = f[pos + i / 2];
        h->vrtypes[vstart + i] = (i & 1) ? (raw >> 4) : (raw & 0x0F);
      }
      pos += nbytes;
    }
    if (pos + len_bytes * vct > f.size()) return 1;
    for (uint64_t i = 0; i < vct; ++i) {
      uint64_t lv = 0;
      for (uint32_t k = 0; k < len_bytes; ++k)
        lv |= static_cast<uint64_t>(f[pos + i * len_bytes + k]) << (8 * k);
      rec_lens[vstart + i] = lv;
    }
    pos += len_bytes * vct;
    pos += static_cast<uint64_t>(ac_bytes) * vct;  // allele counts (skipped)
    if (prv_code == 3) pos += (vct + 7) / 8;       // provisional-ref bits
  }
  h->offsets.resize(variant_ct + 1ull);
  for (uint64_t b = 0; b < n_blocks; ++b) {
    const uint64_t vstart = b << 16;
    const uint64_t vct = std::min<uint64_t>(65536, variant_ct - vstart);
    uint64_t acc = block_offsets[b];
    h->offsets[vstart] = acc;
    for (uint64_t i = 0; i < vct; ++i) {
      acc += rec_lens[vstart + i];
      h->offsets[vstart + i + 1] = acc;
    }
  }
  return 0;
}

// Decode variants [v0, v1) into packed rows, honoring LD-chain rewind.
int capi_decode_range(PgenCHandle* h, uint32_t v0, uint32_t v1,
                      uint8_t* packed_out, int nthreads) {
  // rewind to the LD chain start (vrtype&7 in {2,3} diffs vs the previous
  // non-LD record)
  uint32_t start = v0;
  while (start > 0) {
    const int m = h->vrtypes[start] & 7;
    if (h->mode < 0x10 || (m != 2 && m != 3)) break;
    --start;
  }
  const uint64_t nb = (h->sample_ct + 3) / 4;
  const uint64_t vct = v1 - start;
  std::vector<int64_t> rel(vct + 1);
  for (uint64_t i = 0; i <= vct; ++i)
    rel[i] = static_cast<int64_t>(h->offsets[start + i] - h->offsets[start]);
  std::vector<uint8_t> tmp;
  uint8_t* out = packed_out;
  if (start != v0) {
    tmp.resize(vct * nb);
    out = tmp.data();
  }
  std::vector<uint8_t> ld_base(nb);
  int64_t ld_valid = 0;
  const int rc = pgen_decode_block_mt(
      &h->file[h->offsets[start]], rel.data(), &h->vrtypes[start],
      static_cast<int64_t>(vct), h->sample_ct, ld_base.data(), &ld_valid,
      out, nthreads);
  if (rc) return rc;
  if (start != v0)
    memcpy(packed_out, &tmp[(v0 - start) * nb], (v1 - v0) * nb);
  return 0;
}

}  // namespace

extern "C" void* pgen_capi_open(const char* path, uint32_t sample_ct_hint,
                                int* err) {
  PgenCHandle* h = new PgenCHandle();
  FILE* fp = fopen(path, "rb");
  if (!fp) {
    *err = -1;
    delete h;
    return nullptr;
  }
  fseeko(fp, 0, SEEK_END);
  const off_t sz = ftello(fp);
  fseeko(fp, 0, SEEK_SET);
  h->file.resize(static_cast<size_t>(sz));
  if (sz && fread(h->file.data(), 1, static_cast<size_t>(sz), fp) !=
                static_cast<size_t>(sz)) {
    *err = -2;
    fclose(fp);
    delete h;
    return nullptr;
  }
  fclose(fp);
  const int rc = parse_pgen_header(h, sample_ct_hint);
  if (rc) {
    *err = rc;
    delete h;
    return nullptr;
  }
  *err = 0;
  return h;
}

extern "C" void pgen_capi_close(void* hv) {
  delete static_cast<PgenCHandle*>(hv);
}

extern "C" uint32_t pgen_capi_variant_ct(void* hv) {
  return static_cast<PgenCHandle*>(hv)->variant_ct;
}

extern "C" uint32_t pgen_capi_sample_ct(void* hv) {
  return static_cast<PgenCHandle*>(hv)->sample_ct;
}

// Unpacked 2-bit codes (0 homref / 1 het / 2 homalt / 3 missing), one byte
// per sample, for variants [v0, v0+vct).  out is [vct, sample_ct].
extern "C" int pgen_capi_read_codes(void* hv, uint32_t v0, uint32_t vct,
                                    uint8_t* out, int nthreads) {
  PgenCHandle* h = static_cast<PgenCHandle*>(hv);
  if (v0 + vct > h->variant_ct) return 5;
  const uint64_t nb = (h->sample_ct + 3) / 4;
  std::vector<uint8_t> packed(static_cast<uint64_t>(vct) * nb);
  const int rc = capi_decode_range(h, v0, v0 + vct, packed.data(), nthreads);
  if (rc) return rc;
  for (uint64_t v = 0; v < vct; ++v) {
    const uint8_t* row = &packed[v * nb];
    uint8_t* orow = &out[v * h->sample_ct];
    for (uint32_t s = 0; s < h->sample_ct; ++s)
      orow[s] = (row[s >> 2] >> ((s & 3) * 2)) & 3;
  }
  // PLINK1 .bed code semantics differ; translate to pgen codes
  if (h->mode == 0x01) {
    // bed: 0=hom A1, 1=missing, 2=het, 3=hom A2 -> pgen ALT-count codes
    static const uint8_t map[4] = {2, 3, 1, 0};
    const uint64_t total = static_cast<uint64_t>(vct) * h->sample_ct;
    for (uint64_t i = 0; i < total; ++i) out[i] = map[out[i]];
  }
  return 0;
}
