// Shared-memory SPSC ring channel: the zero-copy mutable-object channel
// plane.
//
// Reference parity: the experimental mutable-object channels backing
// compiled-graph execution (src/ray/core_worker/
// experimental_mutable_object_manager.h:49 — writer/reader semaphore
// protocol over shared memory; python shared_memory_channel.py).
// Redesign: a lock-free single-producer/single-consumer byte ring with
// atomic positions — no semaphores to leak on crash; a reader/writer
// that dies leaves the ring intact for inspection, and `closed` makes
// shutdown explicit. Messages are length-prefixed; a wrap marker keeps
// every payload contiguous so readers can hand out zero-copy views.
//
// Layout: [Header][ring bytes ...]

#include <atomic>
#include <cstdint>
#include <cstring>

extern "C" {

static const uint64_t kChanMagic = 0x52435748414e4eULL;  // "RCWHANN"
static const uint64_t kWrapMarker = ~0ULL;               // len sentinel
static const uint64_t kHdrLen = 8;                       // length prefix

struct ChanHeader {
  uint64_t magic;
  uint64_t capacity;                // ring data bytes
  std::atomic<uint64_t> write_pos;  // monotonically increasing
  std::atomic<uint64_t> read_pos;   // monotonically increasing
  std::atomic<uint32_t> closed;
  uint32_t pad;
};

static inline ChanHeader* CH(void* base) {
  return reinterpret_cast<ChanHeader*>(base);
}
static inline char* ring(void* base) {
  return reinterpret_cast<char*>(base) + sizeof(ChanHeader);
}

int chan_init(void* base, uint64_t total_size) {
  if (total_size <= sizeof(ChanHeader) + 64) return -1;
  ChanHeader* h = CH(base);
  std::memset(base, 0, sizeof(ChanHeader));
  h->magic = kChanMagic;
  h->capacity = total_size - sizeof(ChanHeader);
  h->write_pos.store(0);
  h->read_pos.store(0);
  h->closed.store(0);
  return 0;
}

int chan_attached_ok(void* base) {
  return CH(base)->magic == kChanMagic ? 0 : -1;
}

void chan_close(void* base) { CH(base)->closed.store(1); }
int chan_is_closed(void* base) { return (int)CH(base)->closed.load(); }

// 0 ok; -1 not enough space (try later); -2 message too big; -3 closed
int chan_write(void* base, const uint8_t* data, uint64_t len) {
  ChanHeader* h = CH(base);
  if (h->closed.load(std::memory_order_acquire)) return -3;
  uint64_t cap = h->capacity;
  if (len + kHdrLen > cap / 2) return -2;  // keep ring usable
  uint64_t w = h->write_pos.load(std::memory_order_relaxed);
  uint64_t r = h->read_pos.load(std::memory_order_acquire);
  uint64_t off = w % cap;
  uint64_t contiguous = cap - off;
  uint64_t need = kHdrLen + len;
  uint64_t consume = need;
  bool wrap = false;
  if (contiguous < need) {
    // can't fit contiguously: burn the tail with a wrap marker
    consume = contiguous + need;
    wrap = true;
  }
  if (w - r + consume > cap) return -1;  // full
  char* rg = ring(base);
  if (wrap) {
    if (contiguous >= kHdrLen) {
      uint64_t marker = kWrapMarker;
      std::memcpy(rg + off, &marker, kHdrLen);
    }
    // (a tail shorter than the 8-byte header is detected by the reader
    // via position arithmetic: it skips to the next ring boundary)
    off = 0;
  }
  std::memcpy(rg + off, &len, kHdrLen);
  std::memcpy(rg + off + kHdrLen, data, len);
  h->write_pos.store(w + consume, std::memory_order_release);
  return 0;
}

// returns payload length and fills offset_out with the ring offset of the
// payload (for zero-copy reads); -1 empty; -3 closed-and-drained.
// The message is NOT consumed until chan_pop.
int64_t chan_peek(void* base, uint64_t* offset_out, uint64_t* advance_out) {
  ChanHeader* h = CH(base);
  uint64_t cap = h->capacity;
  uint64_t r = h->read_pos.load(std::memory_order_relaxed);
  uint64_t w = h->write_pos.load(std::memory_order_acquire);
  if (r == w) {
    return h->closed.load(std::memory_order_acquire) ? -3 : -1;
  }
  char* rg = ring(base);
  uint64_t off = r % cap;
  uint64_t contiguous = cap - off;
  uint64_t skipped = 0;
  if (contiguous < kHdrLen) {
    // unreadable sliver at the tail: writer skipped it
    skipped = contiguous;
    off = 0;
  } else {
    uint64_t len;
    std::memcpy(&len, rg + off, kHdrLen);
    if (len == kWrapMarker) {
      skipped = contiguous;
      off = 0;
    }
  }
  uint64_t len;
  std::memcpy(&len, rg + off, kHdrLen);
  *offset_out = sizeof(ChanHeader) + off + kHdrLen;
  *advance_out = skipped + kHdrLen + len;
  return (int64_t)len;
}

void chan_pop(void* base, uint64_t advance) {
  ChanHeader* h = CH(base);
  h->read_pos.fetch_add(advance, std::memory_order_release);
}

}  // extern "C"
