// OverwriteQueue — bounded MPMC byte-blob ring that sheds OLDEST data on
// overflow, with blocking batched reads.
//
// Semantics mirror the reference ingester's queue
// (server/libs/queue/queue.go:43-260): fixed power-of-two
// capacity; Put overwrites the oldest unread item when full (the
// backpressure stance of a telemetry pipeline: drop history, keep now);
// Gets blocks until at least one item is ready, then drains up to `max`.
// Overwritten items are counted (queue.go:139 releases + counter).
//
// The C ABI below is consumed by ctypes (deepflow_tpu_torch/native/__init__.py).
// Items are owned copies: Put memcpys in, Get hands out a malloc'd blob
// the caller frees via dfq_free_blob.

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Blob {
  uint8_t* data = nullptr;
  uint32_t len = 0;
};

struct Queue {
  std::vector<Blob> ring;
  size_t head = 0;  // next read
  size_t tail = 0;  // next write
  size_t count = 0;
  uint64_t overwritten = 0;
  uint64_t total_in = 0;
  bool closed = false;
  std::mutex mu;
  std::condition_variable cv;

  explicit Queue(size_t cap) : ring(cap) {}
};

}  // namespace

extern "C" {

void* dfq_new(uint32_t capacity) {
  if (capacity == 0) capacity = 1;
  return new Queue(capacity);
}

void dfq_destroy(void* q_) {
  Queue* q = static_cast<Queue*>(q_);
  for (auto& b : q->ring) free(b.data);
  delete q;
}

// Copy `len` bytes in. Overwrites the oldest unread item when full.
void dfq_put(void* q_, const uint8_t* data, uint32_t len) {
  Queue* q = static_cast<Queue*>(q_);
  uint8_t* copy = static_cast<uint8_t*>(malloc(len ? len : 1));
  memcpy(copy, data, len);
  {
    std::lock_guard<std::mutex> lock(q->mu);
    Blob& slot = q->ring[q->tail];
    if (q->count == q->ring.size()) {
      // full: advance head over the oldest (it lives in `slot`)
      free(slot.data);
      q->head = (q->head + 1) % q->ring.size();
      q->count--;
      q->overwritten++;
    }
    slot.data = copy;
    slot.len = len;
    q->tail = (q->tail + 1) % q->ring.size();
    q->count++;
    q->total_in++;
  }
  q->cv.notify_one();
}

// Blocking batched read: waits up to timeout_ms for >=1 item, then drains
// up to `max`. Returns number of items written to out_data/out_len.
// Caller must dfq_free_blob each returned pointer.
uint32_t dfq_gets(void* q_, uint8_t** out_data, uint32_t* out_len, uint32_t max,
                  int32_t timeout_ms) {
  Queue* q = static_cast<Queue*>(q_);
  std::unique_lock<std::mutex> lock(q->mu);
  if (q->count == 0 && !q->closed) {
    if (timeout_ms < 0) {
      q->cv.wait(lock, [&] { return q->count > 0 || q->closed; });
    } else {
      q->cv.wait_for(lock, std::chrono::milliseconds(timeout_ms),
                     [&] { return q->count > 0 || q->closed; });
    }
  }
  uint32_t n = 0;
  while (n < max && q->count > 0) {
    Blob& slot = q->ring[q->head];
    out_data[n] = slot.data;
    out_len[n] = slot.len;
    slot.data = nullptr;
    slot.len = 0;
    q->head = (q->head + 1) % q->ring.size();
    q->count--;
    n++;
  }
  return n;
}

void dfq_free_blob(uint8_t* data) { free(data); }

void dfq_close(void* q_) {
  Queue* q = static_cast<Queue*>(q_);
  {
    std::lock_guard<std::mutex> lock(q->mu);
    q->closed = true;
  }
  q->cv.notify_all();
}

uint64_t dfq_overwritten(void* q_) {
  Queue* q = static_cast<Queue*>(q_);
  std::lock_guard<std::mutex> lock(q->mu);
  return q->overwritten;
}

uint32_t dfq_len(void* q_) {
  Queue* q = static_cast<Queue*>(q_);
  std::lock_guard<std::mutex> lock(q->mu);
  return static_cast<uint32_t>(q->count);
}

}  // extern "C"
