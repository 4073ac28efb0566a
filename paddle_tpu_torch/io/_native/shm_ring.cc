// Shared-memory ring queue for DataLoader worker -> parent batch transfer:
// the port's own copy of paddle_tpu/io/_native/shm_ring.cc.
//
// The reference moves sample batches from worker subprocesses through
// shared memory (mmap_allocator.cc backing
// core._array_to_share_memory_tensor) into a C++ blocking queue
// (lod_tensor_blocking_queue.h) consumed by buffered_reader.cc.  This file
// is the native equivalent of that pair: a fixed-slot MPSC ring
// living inside one anonymous MAP_SHARED mapping created by the parent
// BEFORE fork (so no shm_open names, no cleanup races), with process-shared
// pthread mutex/condvars for blocking put/get and scatter-gather writes so
// workers copy numpy buffers straight into the ring — no pickling of array
// payloads, no socket/pipe transfer.
//
// Layout: [Header | len[slots] | slot data (slots * slot_bytes)]
// API is C, consumed via ctypes (no pybind11 in the image).

#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <time.h>

#include <cerrno>

extern "C" {

struct Header {
  pthread_mutex_t mutex;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
  uint64_t slots;
  uint64_t slot_bytes;
  uint64_t head;  // next slot to read
  uint64_t tail;  // next slot to write
  uint64_t count;
  uint64_t closed;
};

struct Iovec {
  const void* base;
  uint64_t len;
};

static inline uint64_t* lens(Header* h) {
  return reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(h) +
                                     sizeof(Header));
}

static inline char* slot_ptr(Header* h, uint64_t i) {
  return reinterpret_cast<char*>(h) + sizeof(Header) +
         h->slots * sizeof(uint64_t) + i * h->slot_bytes;
}

// Total mapping size needed for (slots, slot_bytes).
uint64_t srq_size(uint64_t slots, uint64_t slot_bytes) {
  return sizeof(Header) + slots * sizeof(uint64_t) + slots * slot_bytes;
}

// Initialize a ring inside caller-provided shared memory.
int srq_init(void* mem, uint64_t slots, uint64_t slot_bytes) {
  Header* h = reinterpret_cast<Header*>(mem);
  memset(h, 0, sizeof(Header));
  h->slots = slots;
  h->slot_bytes = slot_bytes;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  // robust: a worker terminated mid-put must not wedge the parent's lock
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  if (pthread_mutex_init(&h->mutex, &ma) != 0) return -1;
  pthread_mutexattr_destroy(&ma);

  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);
  if (pthread_cond_init(&h->not_full, &ca) != 0) return -1;
  if (pthread_cond_init(&h->not_empty, &ca) != 0) return -1;
  pthread_condattr_destroy(&ca);
  return 0;
}

// Lock handling EOWNERDEAD: mark consistent and treat the ring as closed —
// a dead owner may have left a half-written slot, so draining is over.
static int robust_lock(Header* h) {
  int rc = pthread_mutex_lock(&h->mutex);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mutex);
    h->closed = 1;
    pthread_cond_broadcast(&h->not_empty);
    pthread_cond_broadcast(&h->not_full);
  }
  return 0;
}

static void deadline_after(struct timespec* ts, double seconds) {
  clock_gettime(CLOCK_MONOTONIC, ts);
  time_t sec = static_cast<time_t>(seconds);
  long nsec = static_cast<long>((seconds - sec) * 1e9);
  ts->tv_sec += sec;
  ts->tv_nsec += nsec;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

// Gathered write of n iovecs as ONE message. Returns 0 ok, -1 timeout,
// -2 message too large, -3 closed.
int srq_put(void* mem, const Iovec* iov, uint64_t n, double timeout) {
  Header* h = reinterpret_cast<Header*>(mem);
  uint64_t total = 0;
  for (uint64_t i = 0; i < n; ++i) total += iov[i].len;
  if (total > h->slot_bytes) return -2;

  struct timespec ts;
  deadline_after(&ts, timeout);
  robust_lock(h);
  while (h->count == h->slots && !h->closed) {
    if (pthread_cond_timedwait(&h->not_full, &h->mutex, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mutex);
      return -1;
    }
  }
  if (h->closed) {
    pthread_mutex_unlock(&h->mutex);
    return -3;
  }
  uint64_t i = h->tail;
  h->tail = (h->tail + 1) % h->slots;
  h->count += 1;
  // copy OUTSIDE would be ideal (slot reserved), but simplicity wins: the
  // copy is memcpy-bound and parent-side contention is on whole batches
  char* dst = slot_ptr(h, i);
  uint64_t off = 0;
  for (uint64_t k = 0; k < n; ++k) {
    memcpy(dst + off, iov[k].base, iov[k].len);
    off += iov[k].len;
  }
  lens(h)[i] = total;
  pthread_cond_signal(&h->not_empty);
  pthread_mutex_unlock(&h->mutex);
  return 0;
}

// Blocking read into out (cap bytes). Returns message length, -1 timeout,
// -2 out too small, -3 closed-and-empty.
int64_t srq_get(void* mem, void* out, uint64_t cap, double timeout) {
  Header* h = reinterpret_cast<Header*>(mem);
  struct timespec ts;
  deadline_after(&ts, timeout);
  robust_lock(h);
  while (h->count == 0) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mutex);
      return -3;
    }
    if (pthread_cond_timedwait(&h->not_empty, &h->mutex, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mutex);
      return -1;
    }
  }
  uint64_t i = h->head;
  uint64_t len = lens(h)[i];
  if (len > cap) {
    pthread_mutex_unlock(&h->mutex);
    return -2;
  }
  memcpy(out, slot_ptr(h, i), len);
  h->head = (h->head + 1) % h->slots;
  h->count -= 1;
  pthread_cond_signal(&h->not_full);
  pthread_mutex_unlock(&h->mutex);
  return static_cast<int64_t>(len);
}

// Wake every waiter; subsequent puts fail, gets drain then return -3.
void srq_close(void* mem) {
  Header* h = reinterpret_cast<Header*>(mem);
  robust_lock(h);
  h->closed = 1;
  pthread_cond_broadcast(&h->not_empty);
  pthread_cond_broadcast(&h->not_full);
  pthread_mutex_unlock(&h->mutex);
}

uint64_t srq_count(void* mem) {
  Header* h = reinterpret_cast<Header*>(mem);
  robust_lock(h);
  uint64_t c = h->count;
  pthread_mutex_unlock(&h->mutex);
  return c;
}

}  // extern "C"
