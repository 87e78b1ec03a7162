// Buffered BBox CSV emitter — the native half of
// cvsd_tpu_torch/data/bbox_schema.py (the port's copy of the JAX package's
// native/csv_writer.cpp).
//
// The Python writer appends CSV rows through csv + dataclass machinery one
// row at a time. This writer batches whole videos of rows through a 1 MiB stdio buffer with shortest-round-trip float
// formatting (std::to_chars) that matches Python's repr() byte-for-byte
// (including the trailing ".0" Python prints for integral floats), so native
// and Python paths produce identical files.

#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

struct Writer {
  FILE* f;
  char* buf;
};

// Format a double exactly like Python's repr(): shortest round-trip, with
// ".0" appended when the result has no fractional/exponent marker.
int format_double(char* out, double v) {
  auto res = std::to_chars(out, out + 64, v);
  int n = static_cast<int>(res.ptr - out);
  bool has_dot = false;
  for (int i = 0; i < n; ++i) {
    if (out[i] == '.' || out[i] == 'e' || out[i] == 'n' || out[i] == 'i') {
      has_dot = true;
      break;
    }
  }
  if (!has_dot) {
    out[n++] = '.';
    out[n++] = '0';
  }
  return n;
}

}  // namespace

extern "C" {

void* csvw_open(const char* path) {
  FILE* f = std::fopen(path, "ab");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  w->buf = static_cast<char*>(std::malloc(1 << 20));
  std::setvbuf(f, w->buf, _IOFBF, 1 << 20);
  return w;
}

// Append n rows sharing (clip, name, is_anomaly, anomaly) — one video's frame
// batch. person: track ids; frame: 1-based frame numbers; ltwh: n*4 doubles
// (normalized cx, cy, w, h). Returns rows written.
int csvw_write_bboxes(void* handle, int n, int clip, const char* name,
                      const int* frame, const double* person,
                      const double* ltwh, int is_anomaly, const char* anomaly) {
  if (!handle) return -1;
  auto* w = static_cast<Writer*>(handle);
  char num[80];
  for (int i = 0; i < n; ++i) {
    std::fprintf(w->f, "%d,%s,%d,", clip, name, frame[i]);
    int m = format_double(num, person[i]);
    std::fwrite(num, 1, m, w->f);
    for (int c = 0; c < 4; ++c) {
      std::fputc(',', w->f);
      m = format_double(num, ltwh[i * 4 + c]);
      std::fwrite(num, 1, m, w->f);
    }
    // csv.writer's default lineterminator is \r\n — match it byte-for-byte
    std::fprintf(w->f, ",%s,%s\r\n", is_anomaly ? "True" : "False", anomaly);
  }
  return n;
}

void csvw_flush(void* handle) {
  if (handle) std::fflush(static_cast<Writer*>(handle)->f);
}

void csvw_close(void* handle) {
  if (!handle) return;
  auto* w = static_cast<Writer*>(handle);
  std::fclose(w->f);
  std::free(w->buf);
  delete w;
}

}  // extern "C"
