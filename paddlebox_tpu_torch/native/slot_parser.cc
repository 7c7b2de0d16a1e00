// Native MultiSlot text parser — the port's copy of the host-side ingest
// path (paddlebox_tpu_torch/native/slot_parser.py binds it with ctypes).
//
// Host parse throughput bounds the whole pass pipeline, so the text is
// parsed in C++ worker threads behind a plain C ABI. The port builds this
// file with g++ into paddlebox_tpu_torch/_build/ at first use
// (native/build.py), with the flags of the host key index.
//
// Protocol (paddlebox_tpu_torch/data/parser.py): one example per line;
// optional "<ins_id>\t" prefix; then for each slot in schema order
// "<len> v_1 ... v_len". uint64 slots carry feature signs (stored as int64
// bit patterns), float slots carry floats padded/truncated to the slot
// width.
//
// Threading: the input buffer is split at newline boundaries into one chunk
// per worker; each worker parses into private columnar buffers; the copy-out
// functions stitch chunks in order, so results are byte-identical to a
// single-threaded parse.

#include <atomic>
#include <cctype>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;

// Must match paddlebox_tpu_torch/utils/hashing.hash64 (FNV-1a 64).
uint64_t fnv1a64(const char* s, size_t n) {
  uint64_t h = kFnvOffset;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= kFnvPrime;
  }
  return h;
}

struct SlotMeta {
  int32_t type;   // 0 = uint64 (sparse), 1 = float
  int32_t used;   // parse but drop when 0 (Slot.is_used)
  int32_t width;  // float slots: fixed width (max_len)
};

// Columnar output of one worker's chunk.
struct Chunk {
  int64_t num = 0;  // examples parsed
  // per sparse slot (used only)
  std::vector<std::vector<int64_t>> sparse_values;
  std::vector<std::vector<int64_t>> sparse_lens;
  // per float slot (used only): num * width flat
  std::vector<std::vector<float>> float_values;
  std::vector<uint64_t> ins_ids;
  std::string error;  // non-empty => chunk failed
};

struct SPResult {
  std::vector<Chunk> chunks;
  int32_t n_sparse_used = 0;
  int32_t n_float_used = 0;
};

const char* skip_space(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

bool parse_u64(const char*& p, const char* end, uint64_t* out) {
  p = skip_space(p, end);
  auto [np, ec] = std::from_chars(p, end, *out);
  if (ec != std::errc() || np == p) return false;
  p = np;
  return true;
}

bool parse_f32(const char*& p, const char* end, float* out) {
  p = skip_space(p, end);
  auto [np, ec] = std::from_chars(p, end, *out);
  if (ec != std::errc() || np == p) return false;
  p = np;
  return true;
}

// line_base: file-global line number of this chunk's first line, so error
// messages point the operator at the right place regardless of threading.
void set_error(Chunk* out, const char* what, size_t slot, int64_t line_no,
               const char* line, const char* line_end) {
  char buf[320];
  int n = static_cast<int>(line_end - line);
  if (n > 100) n = 100;
  snprintf(buf, sizeof(buf),
           "malformed MultiSlot line (%s at slot %zu, line %lld): '%.*s'",
           what, slot, static_cast<long long>(line_no), n, line);
  out->error = buf;
}

void parse_chunk(const char* data, const char* end,
                 const std::vector<SlotMeta>& slots, bool with_ins_id,
                 int64_t line_base, Chunk* out) {
  const char* p = data;
  int64_t example = 0;
  int64_t line_no = line_base;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (line_end == nullptr) line_end = end;
    const char* line_start = p;
    ++line_no;
    const char* q = skip_space(p, line_end);
    if (q == line_end) {  // blank line
      p = line_end + 1;
      continue;
    }
    if (with_ins_id) {
      const char* tab = static_cast<const char*>(
          memchr(q, '\t', static_cast<size_t>(line_end - q)));
      if (tab == nullptr) {
        set_error(out, "missing ins_id tab", 0, line_no, line_start,
                  line_end);
        return;
      }
      out->ins_ids.push_back(fnv1a64(q, static_cast<size_t>(tab - q)));
      q = tab + 1;
    }
    int32_t si = 0, fi = 0;
    for (size_t s = 0; s < slots.size(); ++s) {
      const SlotMeta& m = slots[s];
      uint64_t ln = 0;
      if (!parse_u64(q, line_end, &ln)) {
        set_error(out, "ran out of tokens", s, line_no, line_start,
                  line_end);
        return;
      }
      if (m.type == 0) {  // sparse uint64
        std::vector<int64_t>* vals =
            m.used ? &out->sparse_values[si] : nullptr;
        for (uint64_t j = 0; j < ln; ++j) {
          uint64_t v = 0;
          if (!parse_u64(q, line_end, &v)) {
            set_error(out, "declared values missing", s, line_no,
                      line_start, line_end);
            return;
          }
          if (vals) vals->push_back(static_cast<int64_t>(v));
        }
        if (m.used) {
          out->sparse_lens[si].push_back(static_cast<int64_t>(ln));
          ++si;
        }
      } else {  // float
        std::vector<float>* vals = m.used ? &out->float_values[fi] : nullptr;
        const int64_t w = m.width;
        int64_t taken = 0;
        for (uint64_t j = 0; j < ln; ++j) {
          float v = 0.f;
          if (!parse_f32(q, line_end, &v)) {
            set_error(out, "declared values missing", s, line_no,
                      line_start, line_end);
            return;
          }
          if (vals && taken < w) {
            vals->push_back(v);
            ++taken;
          }
        }
        if (vals) {
          for (; taken < w; ++taken) vals->push_back(0.f);
          ++fi;
        }
      }
    }
    ++example;
    p = line_end + 1;
  }
  out->num = example;
}

}  // namespace

extern "C" {

// Parse `size` bytes of MultiSlot text. Returns nullptr on error with a
// message in errbuf. slot metadata arrays have length n_slots.
SPResult* sp_parse(const char* data, int64_t size, int32_t n_slots,
                   const int32_t* types, const int32_t* used,
                   const int32_t* widths, int32_t with_ins_id,
                   int32_t n_threads, char* errbuf, int64_t errcap) {
  std::vector<SlotMeta> slots(static_cast<size_t>(n_slots));
  int32_t n_sparse_used = 0, n_float_used = 0;
  for (int32_t i = 0; i < n_slots; ++i) {
    slots[i] = SlotMeta{types[i], used[i], widths[i]};
    if (used[i]) {
      if (types[i] == 0) ++n_sparse_used;
      else ++n_float_used;
    }
  }
  if (n_threads < 1) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? static_cast<int32_t>(hw) : 1;
  }
  // Split at newline boundaries.
  std::vector<std::pair<const char*, const char*>> ranges;
  const char* end = data + size;
  const char* p = data;
  int64_t target = size / n_threads + 1;
  while (p < end) {
    const char* q = p + target;
    if (q >= end) {
      q = end;
    } else {
      q = static_cast<const char*>(
          memchr(q, '\n', static_cast<size_t>(end - q)));
      q = q ? q + 1 : end;
    }
    ranges.emplace_back(p, q);
    p = q;
  }
  auto* res = new SPResult();
  res->n_sparse_used = n_sparse_used;
  res->n_float_used = n_float_used;
  res->chunks.resize(ranges.size());
  for (auto& c : res->chunks) {
    c.sparse_values.resize(static_cast<size_t>(n_sparse_used));
    c.sparse_lens.resize(static_cast<size_t>(n_sparse_used));
    c.float_values.resize(static_cast<size_t>(n_float_used));
  }
  // File-global starting line number per chunk (for error messages).
  std::vector<int64_t> line_base(ranges.size(), 0);
  for (size_t i = 1; i < ranges.size(); ++i) {
    int64_t lines = 0;
    const char* a = ranges[i - 1].first;
    const char* b = ranges[i - 1].second;
    while (a < b) {
      const char* nl = static_cast<const char*>(
          memchr(a, '\n', static_cast<size_t>(b - a)));
      if (!nl) break;
      ++lines;
      a = nl + 1;
    }
    line_base[i] = line_base[i - 1] + lines;
  }
  if (ranges.size() <= 1) {
    if (!ranges.empty()) {
      parse_chunk(ranges[0].first, ranges[0].second, slots,
                  with_ins_id != 0, 0, &res->chunks[0]);
    }
  } else {
    std::vector<std::thread> workers;
    workers.reserve(ranges.size());
    for (size_t i = 0; i < ranges.size(); ++i) {
      workers.emplace_back([&, i] {
        parse_chunk(ranges[i].first, ranges[i].second, slots,
                    with_ins_id != 0, line_base[i], &res->chunks[i]);
      });
    }
    for (auto& w : workers) w.join();
  }
  for (const auto& c : res->chunks) {
    if (!c.error.empty()) {
      snprintf(errbuf, static_cast<size_t>(errcap), "%s", c.error.c_str());
      delete res;
      return nullptr;
    }
  }
  return res;
}

int64_t sp_num_examples(const SPResult* r) {
  int64_t n = 0;
  for (const auto& c : r->chunks) n += c.num;
  return n;
}

int64_t sp_sparse_nnz(const SPResult* r, int32_t s) {
  int64_t n = 0;
  for (const auto& c : r->chunks)
    n += static_cast<int64_t>(c.sparse_values[static_cast<size_t>(s)].size());
  return n;
}

void sp_copy_sparse_values(const SPResult* r, int32_t s, int64_t* out) {
  for (const auto& c : r->chunks) {
    const auto& v = c.sparse_values[static_cast<size_t>(s)];
    memcpy(out, v.data(), v.size() * sizeof(int64_t));
    out += v.size();
  }
}

// out has num_examples+1 entries; out[0] must be pre-set by the caller (0).
void sp_copy_sparse_offsets(const SPResult* r, int32_t s, int64_t* out) {
  int64_t acc = 0;
  int64_t i = 1;
  out[0] = 0;
  for (const auto& c : r->chunks) {
    for (int64_t ln : c.sparse_lens[static_cast<size_t>(s)]) {
      acc += ln;
      out[i++] = acc;
    }
  }
}

void sp_copy_floats(const SPResult* r, int32_t f, float* out) {
  for (const auto& c : r->chunks) {
    const auto& v = c.float_values[static_cast<size_t>(f)];
    memcpy(out, v.data(), v.size() * sizeof(float));
    out += v.size();
  }
}

void sp_copy_ins_ids(const SPResult* r, uint64_t* out) {
  for (const auto& c : r->chunks) {
    memcpy(out, c.ins_ids.data(), c.ins_ids.size() * sizeof(uint64_t));
    out += c.ins_ids.size();
  }
}

void sp_free(SPResult* r) { delete r; }

uint64_t sp_hash64(const char* s, int64_t n) {
  return fnv1a64(s, static_cast<size_t>(n));
}

}  // extern "C"
