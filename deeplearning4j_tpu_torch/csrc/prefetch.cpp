// Native prefetch ring buffer.
//
// Reference role: the JVM side of deeplearning4j's AsyncDataSetIterator —
// org.nd4j.linalg.dataset.AsyncDataSetIterator and its
// workspace-backed bounded queue — which keeps the accelerator from ever
// waiting on host-side ETL. Here the bounded handoff is native: fixed
// preallocated byte slots, mutex+condvar backpressure, memcpy in/out while
// the Python caller has dropped the GIL (ctypes releases it for the call),
// so producer (ETL thread) and consumer (device-feed loop) overlap fully.
//
// Protocol: slots carry opaque byte payloads (the Python side packs
// DataSet arrays). push blocks while full, pop blocks while empty;
// close() wakes everyone, after which pops drain the remaining items and
// then return PF_CLOSED. reopen() resets an emptied ring for the next
// epoch without reallocating slots.

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Ring {
    std::vector<std::vector<uint8_t>> slots;
    std::vector<size_t> sizes;
    size_t cap;
    size_t head = 0;   // next pop index
    size_t tail = 0;   // next push index
    size_t count = 0;
    bool closed = false;
    std::mutex mu;
    std::condition_variable not_full;
    std::condition_variable not_empty;

    Ring(size_t capacity, size_t slot_bytes)
        : slots(capacity), sizes(capacity, 0), cap(capacity) {
        for (auto& s : slots) s.resize(slot_bytes);
    }
};

constexpr long PF_OK = 0;
constexpr long PF_TIMEOUT = -1;
constexpr long PF_CLOSED = -2;
constexpr long PF_TOO_BIG = -3;

}  // namespace

extern "C" {

void* pf_create(size_t capacity, size_t slot_bytes) {
    if (capacity == 0 || slot_bytes == 0) return nullptr;
    return new Ring(capacity, slot_bytes);
}

void pf_destroy(void* h) { delete static_cast<Ring*>(h); }

size_t pf_capacity(void* h) { return static_cast<Ring*>(h)->cap; }

size_t pf_slot_bytes(void* h) { return static_cast<Ring*>(h)->slots[0].size(); }

size_t pf_count(void* h) {
    Ring* r = static_cast<Ring*>(h);
    std::lock_guard<std::mutex> lk(r->mu);
    return r->count;
}

// Blocking push. timeout_ms < 0 means wait forever.
long pf_push(void* h, const uint8_t* data, size_t n, long timeout_ms) {
    Ring* r = static_cast<Ring*>(h);
    if (n > r->slots[0].size()) return PF_TOO_BIG;
    std::unique_lock<std::mutex> lk(r->mu);
    auto ready = [&] { return r->count < r->cap || r->closed; };
    if (timeout_ms < 0) {
        r->not_full.wait(lk, ready);
    } else if (!r->not_full.wait_for(lk, std::chrono::milliseconds(timeout_ms), ready)) {
        return PF_TIMEOUT;
    }
    if (r->closed) return PF_CLOSED;
    std::memcpy(r->slots[r->tail].data(), data, n);
    r->sizes[r->tail] = n;
    r->tail = (r->tail + 1) % r->cap;
    ++r->count;
    r->not_empty.notify_one();
    return PF_OK;
}

// Blocking pop; returns payload size (>= 0) or a PF_* error.
long pf_pop(void* h, uint8_t* out, size_t out_cap, long timeout_ms) {
    Ring* r = static_cast<Ring*>(h);
    std::unique_lock<std::mutex> lk(r->mu);
    auto ready = [&] { return r->count > 0 || r->closed; };
    if (timeout_ms < 0) {
        r->not_empty.wait(lk, ready);
    } else if (!r->not_empty.wait_for(lk, std::chrono::milliseconds(timeout_ms), ready)) {
        return PF_TIMEOUT;
    }
    if (r->count == 0) return PF_CLOSED;  // closed and drained
    size_t n = r->sizes[r->head];
    if (n > out_cap) return PF_TOO_BIG;
    std::memcpy(out, r->slots[r->head].data(), n);
    r->head = (r->head + 1) % r->cap;
    --r->count;
    r->not_full.notify_one();
    return static_cast<long>(n);
}

void pf_close(void* h) {
    Ring* r = static_cast<Ring*>(h);
    {
        std::lock_guard<std::mutex> lk(r->mu);
        r->closed = true;
    }
    r->not_full.notify_all();
    r->not_empty.notify_all();
}

void pf_reopen(void* h) {
    Ring* r = static_cast<Ring*>(h);
    std::lock_guard<std::mutex> lk(r->mu);
    r->closed = false;
    r->head = r->tail = r->count = 0;
}

}  // extern "C"
