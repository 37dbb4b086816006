// Shared-memory MPSC ring buffer for host data loading (the port's copy of
// sd3_tpu/native/ringbuffer.cpp, the same protocol and layout).
//
// The reference hides preprocessing latency with dedicated loader GPUs
// streaming batches over NCCL p2p, with per-consumer sender processes giving
// backpressure (reference src/helpers/VAE_T5_CLIP.py:65-84,399-478). Here
// the stream is host->device, so the equivalent runtime piece is a
// producer/consumer channel between loader *processes* (decode/collate,
// CPython parallelism without the GIL) and the trainer process, with the same
// blocking backpressure semantics.
//
// Design: one POSIX shared-memory segment = header + S fixed-size slots.
// MULTI-producer / single-consumer, lock-free via per-slot sequence numbers
// (Vyukov bounded-queue protocol): a producer claims a slot with a CAS on
// `head`, copies its payload, then publishes by bumping the slot's `seq`;
// the consumer waits on the slot's `seq` so a claimed-but-unpublished slot
// is never read. Variable-length records (< slot payload) carry their byte
// length. Blocking push/pop with sched_yield spinning + a microsleep
// fallback; a `closed` flag unblocks both sides at shutdown.
//
// Built as a plain C ABI .so with g++ at first use, into sd3_torch/_build/,
// and driven from Python via ctypes (sd3_torch/data/ringbuffer.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>

#include <fcntl.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  uint64_t magic;
  uint64_t slot_size;   // payload bytes per slot
  uint64_t num_slots;
  std::atomic<uint64_t> head;   // next slot to claim (producers, CAS)
  std::atomic<uint64_t> tail;   // next slot to read (single consumer)
  std::atomic<uint32_t> closed;
  uint32_t pad;
};

constexpr uint64_t kMagic = 0x5344335F52494E32ULL;  // "SD3_RIN2" (v2: MPSC)

struct Slot {
  // Vyukov sequence: == index       -> empty, claimable by a producer
  //                  == index + 1   -> full, readable by the consumer
  // consumer resets to index + num_slots after reading (next lap's "empty").
  std::atomic<uint64_t> seq;
  uint64_t len;
  // payload follows
};

inline Slot* slot_at(Header* h, uint64_t idx) {
  char* base = reinterpret_cast<char*>(h) + sizeof(Header);
  uint64_t stride = sizeof(Slot) + h->slot_size;
  return reinterpret_cast<Slot*>(base + (idx % h->num_slots) * stride);
}

inline void backoff(int iter) {
  if (iter < 64) {
    sched_yield();
  } else {
    timespec ts{0, 200000};  // 200us
    nanosleep(&ts, nullptr);
  }
}

}  // namespace

extern "C" {

// Create (consumer side) or open (producer side) a ring. Returns the mapped
// header pointer, or null on failure.
void* ring_create(const char* name, uint64_t slot_size, uint64_t num_slots) {
  uint64_t bytes = sizeof(Header) + num_slots * (sizeof(Slot) + slot_size);
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(bytes)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* h = new (mem) Header();
  h->magic = kMagic;
  h->slot_size = slot_size;
  h->num_slots = num_slots;
  h->head.store(0);
  h->tail.store(0);
  h->closed.store(0);
  for (uint64_t i = 0; i < num_slots; ++i) {
    slot_at(h, i)->seq.store(i, std::memory_order_relaxed);
  }
  return mem;
}

void* ring_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* h = reinterpret_cast<Header*>(mem);
  if (h->magic != kMagic) return nullptr;
  return mem;
}

uint64_t ring_slot_size(void* ring) {
  return reinterpret_cast<Header*>(ring)->slot_size;
}

// Blocking push; safe from any number of producer processes concurrently.
// Returns 0 on success, -1 if closed, -2 if len > slot_size.
int ring_push(void* ring, const void* data, uint64_t len) {
  auto* h = reinterpret_cast<Header*>(ring);
  if (len > h->slot_size) return -2;
  int iter = 0;
  uint64_t pos = h->head.load(std::memory_order_relaxed);
  for (;;) {
    if (h->closed.load(std::memory_order_acquire)) return -1;
    Slot* s = slot_at(h, pos);
    uint64_t seq = s->seq.load(std::memory_order_acquire);
    int64_t dif = static_cast<int64_t>(seq) - static_cast<int64_t>(pos);
    if (dif == 0) {
      // Slot is empty for this lap; try to claim it.
      if (h->head.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed)) {
        s->len = len;
        std::memcpy(reinterpret_cast<char*>(s) + sizeof(Slot), data, len);
        s->seq.store(pos + 1, std::memory_order_release);  // publish
        return 0;
      }
      // CAS failed: pos was reloaded with the current head; retry.
    } else if (dif < 0) {
      // Slot still holds last lap's record: ring full -> backpressure.
      backoff(iter++);
      pos = h->head.load(std::memory_order_relaxed);
    } else {
      // Another producer claimed this position; chase the head.
      pos = h->head.load(std::memory_order_relaxed);
    }
  }
}

// Non-blocking size query of the next record: >=0 its length, -1 empty.
int64_t ring_peek(void* ring) {
  auto* h = reinterpret_cast<Header*>(ring);
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  Slot* s = slot_at(h, tail);
  if (s->seq.load(std::memory_order_acquire) != tail + 1) return -1;
  return static_cast<int64_t>(s->len);
}

// Blocking pop into out (cap bytes); single consumer. Returns record length,
// -1 if closed and drained, -2 if cap too small (record left in place).
int64_t ring_pop(void* ring, void* out, uint64_t cap) {
  auto* h = reinterpret_cast<Header*>(ring);
  int iter = 0;
  for (;;) {
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    Slot* s = slot_at(h, tail);
    if (s->seq.load(std::memory_order_acquire) == tail + 1) {
      if (s->len > cap) return -2;
      std::memcpy(out, reinterpret_cast<char*>(s) + sizeof(Slot), s->len);
      uint64_t len = s->len;
      h->tail.store(tail + 1, std::memory_order_release);
      // Hand the slot back to producers for the next lap.
      s->seq.store(tail + h->num_slots, std::memory_order_release);
      return static_cast<int64_t>(len);
    }
    if (h->closed.load(std::memory_order_acquire)) return -1;
    backoff(iter++);
  }
}

uint64_t ring_size(void* ring) {
  auto* h = reinterpret_cast<Header*>(ring);
  return h->head.load(std::memory_order_acquire) -
         h->tail.load(std::memory_order_acquire);
}

void ring_close(void* ring) {
  reinterpret_cast<Header*>(ring)->closed.store(1, std::memory_order_release);
}

void ring_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
