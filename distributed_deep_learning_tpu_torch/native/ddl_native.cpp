// Native host-side data kernels for the port's input pipeline: the port's
// own copy of distributed_deep_learning_tpu/native/ddl_native.cpp, built
// into build/torch_native/ (never into or from the JAX package).
//
// The reference delegates its data hot path to native code it doesn't own:
// pandas' C CSV engine, PIL/torchvision image ops, and libxml2
// (reference CNN/dataset.py:32-40,99-107; MLP/dataset.py:28).  This library
// is the first-party equivalent for the operations that sit on the
// per-step critical path of the host loader:
//
//   * ddl_gather_rows      — batched row gather (ArrayDataset.batch)
//   * ddl_window_gather    — sliding-window gather (PdM LSTM windows)
//   * ddl_csv_dims/parse   — float CSV reader (MQTT / PdM datasets)
//   * ddl_crop_resize_bilinear — bbox crop + bilinear resize (PCB images)
//
// All entry points use a C ABI (loaded via ctypes; no pybind11 in the
// image) and operate on caller-allocated buffers so NumPy owns all memory.
// Parallelism: std::thread over contiguous output chunks — every routine
// is embarrassingly parallel over rows.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

int64_t worker_count(int64_t items, int64_t min_per_thread) {
  int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 4;
  int64_t by_items = items / min_per_thread;
  return std::max<int64_t>(1, std::min(hw, by_items));
}

// Run fn(begin, end) over [0, n) in parallel chunks.
template <typename Fn>
void parallel_for(int64_t n, int64_t min_per_thread, Fn fn) {
  int64_t workers = worker_count(n, min_per_thread);
  if (workers <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + workers - 1) / workers;
  for (int64_t w = 0; w < workers; ++w) {
    int64_t begin = w * chunk;
    int64_t end = std::min(n, begin + chunk);
    if (begin >= end) break;
    threads.emplace_back([=] { fn(begin, end); });
  }
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// out[i, :] = data[idx[i], :]; data is (n_rows, d) row-major.
void ddl_gather_rows(const float* data, int64_t d, const int64_t* idx,
                     int64_t b, float* out) {
  parallel_for(b, 1024, [=](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      std::memcpy(out + i * d, data + idx[i] * d, sizeof(float) * d);
    }
  });
}

// out[i] = data[pos[i]-history+1 .. pos[i]+1, :]  →  (b, history, d).
// pos[i] is the window END row (the reference's idx2pos convention,
// LSTM/dataset.py:36-39).
void ddl_window_gather(const float* data, int64_t d, const int64_t* pos,
                       int64_t b, int64_t history, float* out) {
  const int64_t window = history * d;
  parallel_for(b, 256, [=](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      const float* src = data + (pos[i] - history + 1) * d;
      std::memcpy(out + i * window, src, sizeof(float) * window);
    }
  });
}

namespace {

// Read a whole file; returns empty on failure.
std::string read_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return {};
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  buf.resize(got);
  return buf;
}

int64_t count_cols(const char* line, const char* end) {
  int64_t cols = 1;
  for (const char* p = line; p < end && *p != '\n'; ++p)
    if (*p == ',') ++cols;
  return cols;
}

// A line is blank when it holds no non-whitespace character.  Blank lines
// are not rows: the NumPy fallback (np.genfromtxt) skips them, and counting
// them here would shift every subsequent row.
bool is_blank_line(const char* p, const char* end) {
  for (; p < end && *p != '\n'; ++p)
    if (*p != ' ' && *p != '\t' && *p != '\r') return false;
  return true;
}

}  // namespace

// First pass: number of data rows and columns.  skip_header skips line 1.
// Returns 0 on success, nonzero on I/O failure.
int64_t ddl_csv_dims(const char* path, int32_t skip_header, int64_t* rows,
                     int64_t* cols) {
  std::string buf = read_file(path);
  if (buf.empty()) return 1;
  const char* p = buf.data();
  const char* end = p + buf.size();
  if (skip_header) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  if (p >= end) return 2;
  // column count comes from the first NON-BLANK data line (a leading blank
  // line would report cols=1 and silently mangle the whole file)
  const char* first = p;
  while (first < end && is_blank_line(first, end)) {
    while (first < end && *first != '\n') ++first;
    if (first < end) ++first;
  }
  if (first >= end) return 2;
  *cols = count_cols(first, end);
  int64_t n = 0;
  while (p < end) {
    if (!is_blank_line(p, end)) ++n;
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  *rows = n;
  return 0;
}

// Second pass: parse into out (rows × keep_cols) where keep_cols =
// cols - drop_first_col.  Parallel across row ranges (each thread scans to
// its starting newline).  Returns number of rows parsed.
int64_t ddl_csv_parse(const char* path, int32_t skip_header,
                      int32_t drop_first_col, float* out, int64_t rows,
                      int64_t cols) {
  std::string buf = read_file(path);
  if (buf.empty()) return -1;
  const char* base = buf.data();
  const char* end = base + buf.size();
  const char* data_start = base;
  if (skip_header) {
    while (data_start < end && *data_start != '\n') ++data_start;
    if (data_start < end) ++data_start;
  }
  const int64_t keep = cols - (drop_first_col ? 1 : 0);

  // newline index so threads can jump to row boundaries (blank lines are
  // skipped — genfromtxt parity; see is_blank_line)
  std::vector<const char*> line_starts;
  line_starts.reserve(static_cast<size_t>(rows));
  for (const char* p = data_start; p < end;) {
    if (!is_blank_line(p, end)) line_starts.push_back(p);
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  const int64_t n = std::min<int64_t>(rows, line_starts.size());

  parallel_for(n, 4096, [&](int64_t begin, int64_t endrow) {
    for (int64_t r = begin; r < endrow; ++r) {
      const char* p = line_starts[static_cast<size_t>(r)];
      const char* line_end = p;
      while (line_end < end && *line_end != '\n') ++line_end;
      for (int64_t c = 0; c < cols; ++c) {
        // newline-bounded field parse: strtof skips leading whitespace
        // INCLUDING '\n', so an empty/short field at end of line would
        // otherwise read the next row's first value (row shift)
        float v = 0.0f;
        if (p < line_end && *p != ',') {
          char* next = nullptr;
          v = std::strtof(p, &next);
          if (next == p || next > line_end) v = 0.0f;  // garbage / ran past
        }
        if (std::isnan(v)) v = 0.0f;  // fallback parity (nan_to_num)
        while (p < line_end && *p != ',') ++p;
        if (p < line_end && *p == ',') ++p;
        int64_t cc = c - (drop_first_col ? 1 : 0);
        if (cc >= 0 && cc < keep) out[r * keep + cc] = v;
      }
    }
  });
  return n;
}

// Crop (top, left, h, w) from an (H, W, C) float image and bilinearly
// resize to (out_h, out_w) — torchvision resized_crop semantics
// (align_corners=False), the PCB dataset's per-item op
// (reference CNN/dataset.py:100).
void ddl_crop_resize_bilinear(const float* img, int64_t H, int64_t W,
                              int64_t C, int64_t top, int64_t left, int64_t h,
                              int64_t w, int64_t out_h, int64_t out_w,
                              float* out) {
  const float sy = static_cast<float>(h) / static_cast<float>(out_h);
  const float sx = static_cast<float>(w) / static_cast<float>(out_w);
  parallel_for(out_h, 64, [=](int64_t begin, int64_t end_row) {
    for (int64_t oy = begin; oy < end_row; ++oy) {
      float fy = (static_cast<float>(oy) + 0.5f) * sy - 0.5f;
      fy = std::max(0.0f, std::min(fy, static_cast<float>(h - 1)));
      int64_t y0 = static_cast<int64_t>(fy);
      int64_t y1 = std::min(y0 + 1, h - 1);
      float wy = fy - static_cast<float>(y0);
      for (int64_t ox = 0; ox < out_w; ++ox) {
        float fx = (static_cast<float>(ox) + 0.5f) * sx - 0.5f;
        fx = std::max(0.0f, std::min(fx, static_cast<float>(w - 1)));
        int64_t x0 = static_cast<int64_t>(fx);
        int64_t x1 = std::min(x0 + 1, w - 1);
        float wx = fx - static_cast<float>(x0);
        for (int64_t c = 0; c < C; ++c) {
          auto at = [&](int64_t y, int64_t x) {
            return img[((top + y) * W + (left + x)) * C + c];
          };
          float v0 = at(y0, x0) * (1.0f - wx) + at(y0, x1) * wx;
          float v1 = at(y1, x0) * (1.0f - wx) + at(y1, x1) * wx;
          out[(oy * out_w + ox) * C + c] = v0 * (1.0f - wy) + v1 * wy;
        }
      }
    }
  });
}

}  // extern "C"
