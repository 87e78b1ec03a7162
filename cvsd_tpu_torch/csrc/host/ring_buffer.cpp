// Fixed-slot frame ring buffer — the native staging buffer between the video
// decoder (producer) and the device feed (consumer); the port's copy of the
// JAX package's native/ring_buffer.cpp.
//
// Decoded frame batches land in preallocated slots that the consumer copies
// out and hands to the detector, so decode and device compute overlap
// (double/triple buffering). Classic bounded-buffer with
// mutex + condvars; slots are returned by index so Python can wrap each slot
// as a zero-copy numpy array.

#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <vector>

namespace {

struct RingBuffer {
  long slot_bytes;
  int slots;
  char* data;
  std::mutex mu;
  std::condition_variable cv_free;
  std::condition_variable cv_ready;
  std::queue<int> free_q;
  std::queue<int> ready_q;
  bool closed = false;
};

}  // namespace

extern "C" {

void* rb_create(int slots, long slot_bytes) {
  auto* rb = new RingBuffer();
  rb->slots = slots;
  rb->slot_bytes = slot_bytes;
  rb->data = static_cast<char*>(std::aligned_alloc(64, static_cast<size_t>(slots) * slot_bytes));
  for (int i = 0; i < slots; ++i) rb->free_q.push(i);
  return rb;
}

char* rb_slot_ptr(void* h, int slot) {
  auto* rb = static_cast<RingBuffer*>(h);
  return rb->data + static_cast<size_t>(slot) * rb->slot_bytes;
}

// Producer: block until a free slot is available; -1 if closed.
int rb_acquire_write(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  std::unique_lock<std::mutex> lk(rb->mu);
  rb->cv_free.wait(lk, [&] { return !rb->free_q.empty() || rb->closed; });
  if (rb->free_q.empty()) return -1;
  int s = rb->free_q.front();
  rb->free_q.pop();
  return s;
}

void rb_commit_write(void* h, int slot) {
  auto* rb = static_cast<RingBuffer*>(h);
  {
    std::lock_guard<std::mutex> lk(rb->mu);
    rb->ready_q.push(slot);
  }
  rb->cv_ready.notify_one();
}

// Consumer: block until a committed slot is ready; -1 when closed and drained.
int rb_acquire_read(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  std::unique_lock<std::mutex> lk(rb->mu);
  rb->cv_ready.wait(lk, [&] { return !rb->ready_q.empty() || rb->closed; });
  if (rb->ready_q.empty()) return -1;
  int s = rb->ready_q.front();
  rb->ready_q.pop();
  return s;
}

void rb_release_read(void* h, int slot) {
  auto* rb = static_cast<RingBuffer*>(h);
  {
    std::lock_guard<std::mutex> lk(rb->mu);
    rb->free_q.push(slot);
  }
  rb->cv_free.notify_one();
}

void rb_close(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  {
    std::lock_guard<std::mutex> lk(rb->mu);
    rb->closed = true;
  }
  rb->cv_ready.notify_all();
  rb->cv_free.notify_all();
}

void rb_destroy(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  std::free(rb->data);
  delete rb;
}

}  // extern "C"
