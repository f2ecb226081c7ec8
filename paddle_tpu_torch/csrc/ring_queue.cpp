// Single-producer single-consumer byte ring over a shared-memory region:
// the DataLoader's worker processes hand batches to the trainer through
// it without pipe writes (the role of Paddle's shared-memory DataLoader
// queue). paddle_tpu_torch's own copy of the reference's
// paddle_tpu/csrc/ring_queue.cpp, built with g++ at first use
// (core/native.py).
//
// Layout in the region: [head u64][tail u64][capacity u64][data ...]
// head/tail are monotonically increasing byte cursors; std::atomic<uint64_t>
// is address-free, so the same region works across processes.
#include <atomic>
#include <cstdint>
#include <cstring>

namespace {

struct RingHdr {
  std::atomic<uint64_t> head;  // read cursor (consumer-owned)
  std::atomic<uint64_t> tail;  // write cursor (producer-owned)
  uint64_t capacity;
};

inline char* data_of(void* mem) {
  return static_cast<char*>(mem) + sizeof(RingHdr);
}

void copy_in(void* mem, uint64_t pos, const char* src, uint64_t n) {
  auto* h = static_cast<RingHdr*>(mem);
  char* d = data_of(mem);
  uint64_t off = pos % h->capacity;
  uint64_t first = (n < h->capacity - off) ? n : h->capacity - off;
  memcpy(d + off, src, first);
  if (n > first) memcpy(d, src + first, n - first);
}

void copy_out(void* mem, uint64_t pos, char* dst, uint64_t n) {
  auto* h = static_cast<RingHdr*>(mem);
  char* d = data_of(mem);
  uint64_t off = pos % h->capacity;
  uint64_t first = (n < h->capacity - off) ? n : h->capacity - off;
  memcpy(dst, d + off, first);
  if (n > first) memcpy(dst + first, d, n - first);
}

}  // namespace

extern "C" {

uint64_t ring_header_bytes() { return sizeof(RingHdr); }

void ring_init(void* mem, uint64_t total_bytes) {
  auto* h = static_cast<RingHdr*>(mem);
  h->head.store(0, std::memory_order_relaxed);
  h->tail.store(0, std::memory_order_relaxed);
  h->capacity = total_bytes - sizeof(RingHdr);
}

// Push one length-prefixed frame. 0 on success, -1 = not enough space,
// -2 = frame can never fit (larger than the whole ring).
int ring_push(void* mem, const char* buf, uint64_t n) {
  auto* h = static_cast<RingHdr*>(mem);
  if (n + 8 > h->capacity) return -2;
  uint64_t head = h->head.load(std::memory_order_acquire);
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  if (h->capacity - (tail - head) < n + 8) return -1;
  copy_in(mem, tail, reinterpret_cast<const char*>(&n), 8);
  copy_in(mem, tail + 8, buf, n);
  h->tail.store(tail + 8 + n, std::memory_order_release);
  return 0;
}

// Size of the next frame, or -1 if the ring is empty.
long long ring_next_size(void* mem) {
  auto* h = static_cast<RingHdr*>(mem);
  uint64_t head = h->head.load(std::memory_order_relaxed);
  uint64_t tail = h->tail.load(std::memory_order_acquire);
  if (tail == head) return -1;
  uint64_t n;
  copy_out(mem, head, reinterpret_cast<char*>(&n), 8);
  return static_cast<long long>(n);
}

// Pop the next frame into out. Returns its size, -1 if empty, -2 if the
// caller's buffer (maxn) is too small (frame left in place).
long long ring_pop(void* mem, char* out, uint64_t maxn) {
  auto* h = static_cast<RingHdr*>(mem);
  uint64_t head = h->head.load(std::memory_order_relaxed);
  uint64_t tail = h->tail.load(std::memory_order_acquire);
  if (tail == head) return -1;
  uint64_t n;
  copy_out(mem, head, reinterpret_cast<char*>(&n), 8);
  if (n > maxn) return -2;
  copy_out(mem, head + 8, out, n);
  h->head.store(head + 8 + n, std::memory_order_release);
  return static_cast<long long>(n);
}

}  // extern "C"
