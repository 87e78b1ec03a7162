// Multi-stream batched video decoder: decode + resize/letterbox + BGR->RGB
// fused in C++, one call per detector batch.
//
// The port's copy of the JAX package's native/video_decode.cpp. The Python
// readers decode one frame per loop iteration (cv2.VideoCapture.read). The
// streaming/preprocess pipelines multiplex many videos into shared
// detector batches; this decoder moves the whole per-frame host loop
// (read -> resize -> color convert -> batch-slot copy) into native code so
// one ctypes call fills a batch — the Python interpreter overhead
// (a fraction of a millisecond per frame) disappears and the call releases
// the GIL for its entire duration, overlapping cleanly with GIL-bound
// tracking/windowing in the main thread.
//
// Round-robin semantics mirror pipeline/streaming.py::RoundRobinReader: one frame
// per live stream per rotation; on EOF the stream is released and the next
// queued path opens. Slots report (stream index, 1-based frame number,
// CAP_PROP_POS_MSEC timestamp).
//
// Output modes (out buffer is (B, out_h, out_w, 3) uint8 RGB):
//   0 raw      — source-size frames, color-converted only
//   1 content  — resized to (nw, nh) = content rows of the letterbox
//                (device adds the constant padding)
//   2 canvas   — resized + padded to the square canvas at (px, py), pad 114

#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>

#include <cstring>
#include <deque>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Stream {
  cv::VideoCapture cap;
  int idx = -1;       // index into the original path list
  int frame_no = 0;   // 1-based after first read
};

struct MSDecoder {
  std::vector<std::string> paths;
  size_t next_path = 0;
  int max_streams = 8;
  int out_w = 0, out_h = 0;  // batch slot dims
  int nw = 0, nh = 0;        // resized content dims (modes 1/2)
  int px = 0, py = 0;        // content offset inside the canvas (mode 2)
  int mode = 0;
  int stride = 1;  // return every Nth source frame (1, 1+N, ...); skipped
  //                 frames are grab()'d (decoded to advance inter-frame
  //                 codecs, but no color-convert/copy)
  std::deque<std::unique_ptr<Stream>> active;

  bool open_next() {
    while (next_path < paths.size()) {
      auto st = std::make_unique<Stream>();
      st->idx = static_cast<int>(next_path);
      st->cap.open(paths[next_path]);
      ++next_path;
      if (st->cap.isOpened()) {
        active.push_back(std::move(st));
        return true;
      }
    }
    return false;
  }
};

}  // namespace

extern "C" {

// Bumped whenever an exported signature changes (round 4: msd_open gained
// `stride`). The ctypes binding refuses to load a mismatched .so — a stale
// build would otherwise silently drop trailing arguments on most ABIs.
int msd_abi_version() { return 2; }

void* msd_open(const char** paths, int n_paths, int max_streams, int out_w,
               int out_h, int nw, int nh, int px, int py, int mode,
               int stride) {
  if (stride < 1) return nullptr;
  if (mode == 1 && (nw != out_w || nh != out_h)) {
    // CONTENT mode writes cvtColor output into a Mat wrapping the caller's
    // (out_h, out_w) buffer; a mismatched (nh, nw) would make Mat::create
    // silently reallocate and leave the caller's buffer uninitialized.
    return nullptr;
  }
  auto* d = new MSDecoder();
  d->paths.reserve(n_paths);
  for (int i = 0; i < n_paths; ++i) d->paths.emplace_back(paths[i]);
  d->max_streams = max_streams;
  d->out_w = out_w;
  d->out_h = out_h;
  d->nw = nw;
  d->nh = nh;
  d->px = px;
  d->py = py;
  d->mode = mode;
  d->stride = stride;
  while (static_cast<int>(d->active.size()) < max_streams && d->open_next()) {
  }
  return d;
}

// Fill up to B slots; returns the number filled (0 = all streams exhausted).
int msd_next(void* h, int B, unsigned char* out, int* stream_idx,
             int* frame_no, double* stamp_ms) {
  auto* d = static_cast<MSDecoder*>(h);
  const size_t slot = static_cast<size_t>(d->out_h) * d->out_w * 3;
  if (d->mode == 2) std::memset(out, 114, slot * B);
  int k = 0;
  cv::Mat frame, resized;
  while (k < B && !d->active.empty()) {
    std::unique_ptr<Stream> st = std::move(d->active.front());
    d->active.pop_front();
    bool ok = true;
    if (st->frame_no > 0) {  // first returned frame is always source frame 1
      for (int s = 1; s < d->stride && ok; ++s) ok = st->cap.grab();
    }
    if (!ok || !st->cap.read(frame)) {
      st->cap.release();
      d->open_next();
      continue;  // st destroyed
    }
    st->frame_no = st->frame_no == 0 ? 1 : st->frame_no + d->stride;
    unsigned char* base = out + slot * k;
    cv::Mat dst(d->out_h, d->out_w, CV_8UC3, base);
    if (d->mode == 0) {
      if (frame.cols != d->out_w || frame.rows != d->out_h) {
        // some codecs lie about container dims (same fallback as the cv2
        // producer, data/video.py): resize to the declared geometry
        cv::resize(frame, resized, cv::Size(d->out_w, d->out_h), 0, 0,
                   cv::INTER_LINEAR);
        cv::cvtColor(resized, dst, cv::COLOR_BGR2RGB);
      } else {
        cv::cvtColor(frame, dst, cv::COLOR_BGR2RGB);
      }
    } else {
      cv::resize(frame, resized, cv::Size(d->nw, d->nh), 0, 0,
                 cv::INTER_LINEAR);
      if (d->mode == 1) {
        cv::cvtColor(resized, dst, cv::COLOR_BGR2RGB);
      } else {
        cv::Mat roi = dst(cv::Rect(d->px, d->py, d->nw, d->nh));
        cv::cvtColor(resized, roi, cv::COLOR_BGR2RGB);
      }
    }
    stream_idx[k] = st->idx;
    frame_no[k] = st->frame_no;
    stamp_ms[k] = st->cap.get(cv::CAP_PROP_POS_MSEC);
    d->active.push_back(std::move(st));
    ++k;
  }
  return k;
}

int msd_active(void* h) {
  auto* d = static_cast<MSDecoder*>(h);
  return static_cast<int>(d->active.size());
}

void msd_close(void* h) {
  auto* d = static_cast<MSDecoder*>(h);
  for (auto& st : d->active) st->cap.release();
  delete d;
}

}  // extern "C"
