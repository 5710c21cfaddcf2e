// Native streaming FASTA/FASTQ reader + batch encoder (kseq equivalent,
// /root/reference/include/kseq.h) for the device query pipeline: parses plain or
// gzip files with zlib, normalizes bytes, and writes right-aligned int32 code
// batches (pad -1) ready for the device — the host data-loader stage.
//
// Layout contract matches rowbowt_tpu.engine.batch.encode_batch: lane q's
// codes occupy out_codes[q*L + (L-len) .. q*L + L-1]; with_rc interleaves each
// read's forward and reverse-complement as adjacent lanes.

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {
using i64 = int64_t;

struct Reader {
  gzFile f = nullptr;
  std::string pending;  // pushed-back header line
  bool eof = false;
  std::string err;

  bool getline(std::string& out) {
    out.clear();
    if (!pending.empty()) {
      out.swap(pending);
      return true;
    }
    char buf[65536];
    bool got = false;
    while (true) {
      if (gzgets(f, buf, sizeof buf) == nullptr) {
        eof = true;
        return got;
      }
      got = true;
      size_t len = std::strlen(buf);
      bool nl = len && buf[len - 1] == '\n';
      if (nl) --len;
      if (len && buf[len - 1] == '\r') --len;
      out.append(buf, len);
      if (nl) return true;
    }
  }
};

// reverse-complement over normalized bytes (A<->T, C<->G, N->N); everything
// else maps to itself like the reference comp_tab's non-nucleotide rows
const uint8_t* comp_table() {
  static uint8_t t[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) t[i] = (uint8_t)i;
    t['A'] = 'T'; t['T'] = 'A'; t['C'] = 'G'; t['G'] = 'C';
    t['a'] = 't'; t['t'] = 'a'; t['c'] = 'g'; t['g'] = 'c';
    t['U'] = 'A'; t['u'] = 'a';
    init = true;
  }
  return t;
}

void encode_lane(const uint8_t* seq, i64 len, const int16_t* enc, i64 L,
                 int32_t* row) {
  i64 m = len < L ? len : L;
  for (i64 j = 0; j < L - m; ++j) row[j] = -1;
  for (i64 j = 0; j < m; ++j) row[L - m + j] = enc[seq[j]];
}
}  // namespace

extern "C" {

void* rbt_fq_open(const char* path) {
  auto* r = new Reader();
  r->f = gzopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  return r;
}

void rbt_fq_close(void* h) {
  auto* r = (Reader*)h;
  if (r->f) gzclose(r->f);
  delete r;
}

// Read up to max_reads records.  Returns the number of READS consumed
// (lanes written = reads * (with_rc ? 2 : 1)), 0 at EOF, -1 on parse error.
//   enc_tab256:  int16[256] byte -> code (-1 absent)
//   norm_tab256: uint8[256] byte -> byte normalization applied first
//                (pass identity to disable), e.g. the rb_markers ntoa table
//   out_codes:   int32[lanes, L] right-aligned
//   out_lens:    int32[lanes]
//   name_buf:    packed NUL-terminated names (cap nb_cap bytes)
//   name_off:    i64[max_reads] offset of each name in name_buf (-1 if full)
i64 rbt_fq_next_batch(void* h, i64 max_reads, i64 L, const int16_t* enc_tab256,
                      const uint8_t* norm_tab256, int with_rc,
                      int32_t* out_codes, int32_t* out_lens, char* name_buf,
                      i64 nb_cap, i64* name_off) {
  auto* r = (Reader*)h;
  const uint8_t* comp = comp_table();
  i64 nread = 0;
  i64 nb_used = 0;
  std::string line, seq;
  std::vector<uint8_t> norm, rc;
  while (nread < max_reads && r->getline(line)) {
    if (line.empty()) continue;
    char tag = line[0];
    if (tag != '>' && tag != '@') {
      r->err = "unexpected line";
      return -1;
    }
    size_t sp = line.find_first_of(" \t");
    std::string name = line.substr(1, sp == std::string::npos ? sp : sp - 1);
    seq.clear();
    if (tag == '>') {  // FASTA: sequence until next header
      while (r->getline(line)) {
        if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
          r->pending = line;
          break;
        }
        seq += line;
      }
    } else {  // FASTQ: one sequence line, '+', one quality line
      if (!r->getline(seq)) return -1;
      if (!r->getline(line) || line.empty() || line[0] != '+') return -1;
      if (!r->getline(line) || line.size() != seq.size()) return -1;  // kseq -2
    }
    i64 len = (i64)seq.size();
    norm.resize(len);
    for (i64 j = 0; j < len; ++j)
      norm[j] = norm_tab256[(uint8_t)seq[(size_t)j]];
    i64 lane = nread * (with_rc ? 2 : 1);
    encode_lane(norm.data(), len, enc_tab256, L, out_codes + lane * L);
    out_lens[lane] = (int32_t)(len < L ? len : L);
    if (with_rc) {
      rc.resize(len);
      for (i64 j = 0; j < len; ++j) rc[(size_t)j] = comp[norm[len - 1 - j]];
      encode_lane(rc.data(), len, enc_tab256, L, out_codes + (lane + 1) * L);
      out_lens[lane + 1] = (int32_t)(len < L ? len : L);
    }
    if ((i64)name.size() + 1 <= nb_cap - nb_used) {
      std::memcpy(name_buf + nb_used, name.c_str(), name.size() + 1);
      name_off[nread] = nb_used;
      nb_used += (i64)name.size() + 1;
    } else {
      name_off[nread] = -1;
    }
    ++nread;
  }
  return nread;
}
}
