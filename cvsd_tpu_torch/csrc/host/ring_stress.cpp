// Standalone stress/race harness for the ring buffer — built with
// -fsanitize=thread (utils/host_build.py::build_ring_stress_tsan) and run by
// tests/test_torch_native.py. A producer and a consumer hammer the buffer with
// small slots; ThreadSanitizer flags any data race in the synchronization.
// Exit code 0 = clean run (TSAN aborts non-zero on a detected race).

#include <cstdio>
#include <cstring>
#include <thread>

extern "C" {
void* rb_create(int slots, long slot_bytes);
char* rb_slot_ptr(void* h, int slot);
int rb_acquire_write(void* h);
void rb_commit_write(void* h, int slot);
int rb_acquire_read(void* h);
void rb_release_read(void* h, int slot);
void rb_close(void* h);
void rb_destroy(void* h);
}

int main() {
  const int N = 20000;
  const long SLOT = 256;
  void* rb = rb_create(4, SLOT);

  std::thread producer([&] {
    for (int i = 0; i < N; ++i) {
      int s = rb_acquire_write(rb);
      if (s < 0) return;
      std::memset(rb_slot_ptr(rb, s), i & 0xff, SLOT);
      rb_commit_write(rb, s);
    }
    rb_close(rb);
  });

  long long sum = 0;
  int count = 0;
  while (true) {
    int s = rb_acquire_read(rb);
    if (s < 0) break;
    sum += static_cast<unsigned char>(rb_slot_ptr(rb, s)[0]);
    ++count;
    rb_release_read(rb, s);
  }
  producer.join();
  rb_destroy(rb);
  if (count != N) {
    std::fprintf(stderr, "lost items: got %d of %d\n", count, N);
    return 1;
  }
  std::printf("ring stress OK: %d items, checksum %lld\n", count, sum);
  return 0;
}
