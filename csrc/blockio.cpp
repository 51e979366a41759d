// tpu-audio native runtime: lock-free audio block transport + RT clock +
// MIDI framing.
//
// Capability equivalent of the reference's C++ host runtime: the JACK
// client's real-time block delivery (reference src/jackclient.cu:4-55), the
// ALSA rawmidi byte framer with running status (reference src/midi.cu:3-59),
// and the launch scripts' real-time pacing concerns (reference
// run_x64_86.sh, scripts/floorit). JACK/ALSA themselves are not assumed to
// exist in a data-center serving environment; instead this provides the
// primitives
// a block transport needs:
//
//   - ta_ring_*: single-producer/single-consumer lock-free float ring
//     buffer, shared-memory mappable (two processes can stream audio blocks
//     through /dev/shm with no locks on the RT path);
//   - ta_clock_*: absolute-deadline block clock (clock_nanosleep on
//     CLOCK_MONOTONIC with TIMER_ABSTIME) with missed-deadline accounting —
//     drift-free pacing for the real-time host loop;
//   - ta_midi_*: incremental MIDI byte-stream framer (running status,
//     SysEx, realtime-byte transparency) matching tpu_audio.io.midi's
//     Python framer bit-for-bit (cross-checked in tests/test_native.py).
//
// Built as a plain C ABI shared library; Python binds via ctypes
// (tpu_audio/runtime/native.py).

// The ABI header is included so any signature drift between this
// implementation and the hand-maintained mirror consumed by
// jackbridge.cpp/ctypes fails the BUILD (extern "C" would otherwise
// link a mismatched signature cleanly and corrupt at runtime).
#include "blockio.h"

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <ctime>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- ring buffer

struct ta_ring_header {
    std::atomic<uint64_t> write_pos;
    std::atomic<uint64_t> read_pos;
    uint64_t capacity;  // floats
    uint32_t magic;
};

struct ta_ring {
    ta_ring_header* hdr;
    float* data;
    int fd;        // -1 if heap-allocated
    size_t bytes;  // total mapping size
};

static const uint32_t TA_RING_MAGIC = 0x74617262;  // "tarb"

static size_t ring_bytes(uint64_t capacity) {
    return sizeof(ta_ring_header) + capacity * sizeof(float);
}

ta_ring* ta_ring_create(uint64_t capacity, const char* shm_name) {
    ta_ring* r = (ta_ring*)calloc(1, sizeof(ta_ring));
    if (!r) return nullptr;
    r->bytes = ring_bytes(capacity);
    r->fd = -1;
    void* mem = nullptr;
    if (shm_name && shm_name[0]) {
        int fd = shm_open(shm_name, O_CREAT | O_RDWR, 0600);
        if (fd < 0) { free(r); return nullptr; }
        if (ftruncate(fd, (off_t)r->bytes) != 0) { close(fd); free(r); return nullptr; }
        mem = mmap(nullptr, r->bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
        if (mem == MAP_FAILED) { close(fd); free(r); return nullptr; }
        r->fd = fd;
    } else {
        mem = calloc(1, r->bytes);
        if (!mem) { free(r); return nullptr; }
    }
    r->hdr = (ta_ring_header*)mem;
    r->data = (float*)((char*)mem + sizeof(ta_ring_header));
    r->hdr->write_pos.store(0, std::memory_order_relaxed);
    r->hdr->read_pos.store(0, std::memory_order_relaxed);
    r->hdr->capacity = capacity;
    r->hdr->magic = TA_RING_MAGIC;
    return r;
}

ta_ring* ta_ring_open(const char* shm_name) {
    int fd = shm_open(shm_name, O_RDWR, 0600);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(ta_ring_header)) {
        close(fd);
        return nullptr;
    }
    void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
    if (mem == MAP_FAILED) { close(fd); return nullptr; }
    ta_ring_header* hdr = (ta_ring_header*)mem;
    if (hdr->magic != TA_RING_MAGIC) { munmap(mem, st.st_size); close(fd); return nullptr; }
    ta_ring* r = (ta_ring*)calloc(1, sizeof(ta_ring));
    r->hdr = hdr;
    r->data = (float*)((char*)mem + sizeof(ta_ring_header));
    r->fd = fd;
    r->bytes = (size_t)st.st_size;
    return r;
}

void ta_ring_destroy(ta_ring* r, const char* unlink_name) {
    if (!r) return;
    if (r->fd >= 0) {
        munmap((void*)r->hdr, r->bytes);
        close(r->fd);
        if (unlink_name && unlink_name[0]) shm_unlink(unlink_name);
    } else {
        free((void*)r->hdr);
    }
    free(r);
}

uint64_t ta_ring_capacity(const ta_ring* r) { return r->hdr->capacity; }

uint64_t ta_ring_readable(const ta_ring* r) {
    uint64_t w = r->hdr->write_pos.load(std::memory_order_acquire);
    uint64_t rd = r->hdr->read_pos.load(std::memory_order_relaxed);
    return w - rd;
}

uint64_t ta_ring_writable(const ta_ring* r) {
    uint64_t w = r->hdr->write_pos.load(std::memory_order_relaxed);
    uint64_t rd = r->hdr->read_pos.load(std::memory_order_acquire);
    return r->hdr->capacity - (w - rd);
}

// write n floats; returns n on success, 0 if insufficient space (all-or-none)
uint64_t ta_ring_write(ta_ring* r, const float* src, uint64_t n) {
    if (ta_ring_writable(r) < n) return 0;
    uint64_t cap = r->hdr->capacity;
    uint64_t w = r->hdr->write_pos.load(std::memory_order_relaxed);
    uint64_t idx = w % cap;
    uint64_t first = (idx + n <= cap) ? n : cap - idx;
    memcpy(r->data + idx, src, first * sizeof(float));
    if (first < n) memcpy(r->data, src + first, (n - first) * sizeof(float));
    r->hdr->write_pos.store(w + n, std::memory_order_release);
    return n;
}

// read n floats; returns n on success, 0 if insufficient data (all-or-none)
uint64_t ta_ring_read(ta_ring* r, float* dst, uint64_t n) {
    if (ta_ring_readable(r) < n) return 0;
    uint64_t cap = r->hdr->capacity;
    uint64_t rd = r->hdr->read_pos.load(std::memory_order_relaxed);
    uint64_t idx = rd % cap;
    uint64_t first = (idx + n <= cap) ? n : cap - idx;
    memcpy(dst, r->data + idx, first * sizeof(float));
    if (first < n) memcpy(dst + first, r->data, (n - first) * sizeof(float));
    r->hdr->read_pos.store(rd + n, std::memory_order_release);
    return n;
}

// ---------------------------------------------------------------- block clock

struct ta_clock {
    struct timespec next;
    uint64_t period_ns;
    uint64_t ticks;
    uint64_t missed;
};

static void ts_add(struct timespec* t, uint64_t ns) {
    t->tv_nsec += (long)(ns % 1000000000ull);
    t->tv_sec += (time_t)(ns / 1000000000ull);
    if (t->tv_nsec >= 1000000000L) {
        t->tv_nsec -= 1000000000L;
        t->tv_sec += 1;
    }
}

static int64_t ts_diff_ns(const struct timespec* a, const struct timespec* b) {
    return (int64_t)(a->tv_sec - b->tv_sec) * 1000000000ll
         + (int64_t)(a->tv_nsec - b->tv_nsec);
}

ta_clock* ta_clock_create(uint64_t period_ns) {
    ta_clock* c = (ta_clock*)calloc(1, sizeof(ta_clock));
    if (!c) return nullptr;
    c->period_ns = period_ns;
    clock_gettime(CLOCK_MONOTONIC, &c->next);
    ts_add(&c->next, period_ns);
    return c;
}

// sleep until the next absolute block deadline; returns lateness in ns
// (<= 0: on time). Missed deadlines are skipped, not accumulated, so the
// stream re-synchronises instead of racing to catch up.
int64_t ta_clock_wait(ta_clock* c) {
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    int64_t late = ts_diff_ns(&now, &c->next);
    if (late <= 0) {
        while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &c->next, nullptr) != 0) {}
        ts_add(&c->next, c->period_ns);
    } else {
        c->missed++;
        // re-anchor: schedule the next deadline one period from now
        c->next = now;
        ts_add(&c->next, c->period_ns);
    }
    c->ticks++;
    return late;
}

uint64_t ta_clock_missed(const ta_clock* c) { return c->missed; }
uint64_t ta_clock_ticks(const ta_clock* c) { return c->ticks; }
void ta_clock_destroy(ta_clock* c) { free(c); }

// ---------------------------------------------------------------- midi framer

struct ta_midi {
    uint8_t buf[1024];
    uint32_t len;
    uint8_t running_status;
};

ta_midi* ta_midi_create() { return (ta_midi*)calloc(1, sizeof(ta_midi)); }
void ta_midi_destroy(ta_midi* m) { free(m); }

static int midi_is_complete(const uint8_t* b, uint32_t len) {
    if (!len) return 0;
    uint8_t hi = b[0] & 0xF0;
    switch (hi) {
        case 0x80: case 0x90: case 0xA0: case 0xB0: case 0xE0:
            return len == 3;
        case 0xC0: case 0xD0:
            return len == 2;
        case 0xF0:
            // SysEx runs to its 0xF7 terminator; system COMMON messages
            // have fixed lengths (F1 MTC quarter-frame 2, F2 song position
            // 3, F3 song select 2; F4/F5 undefined and F6 tune request /
            // stray F7 are single bytes). Framing them all as SysEx made
            // one DAW MTC quarter-frame swallow every following
            // running-status data byte.
            if (b[0] == 0xF0) return b[len - 1] == 0xF7;
            if (b[0] == 0xF2) return len == 3;
            if (b[0] == 0xF1 || b[0] == 0xF3) return len == 2;
            return len == 1;
        default:
            return 0;
    }
}

// Feed `n` raw bytes; complete messages are appended to `out` as
// [len_byte, data...] records. Returns bytes written to `out`.
// Semantics mirror tpu_audio.io.midi.MidiFramer (running status per the
// reference src/midi.cu:53-55; realtime bytes 0xF8+ pass through
// transparently).
// SIZING CONTRACT: a completed message on out overflow is DROPPED, so the
// caller must provide out_cap >= 3*n + 260 — the worst case is 3 out
// bytes per input byte (1-data-byte running status: len byte + status +
// data) plus one sub-256-byte message buffered from a previous feed.
// runtime/native.py sizes its buffer to this bound.
uint32_t ta_midi_feed(ta_midi* m, const uint8_t* data, uint32_t n,
                      uint8_t* out, uint32_t out_cap) {
    uint32_t written = 0;
    for (uint32_t i = 0; i < n; i++) {
        uint8_t byte = data[i];
        if (byte >= 0xF8) {  // system realtime: transparent single-byte
            if (written + 2 <= out_cap) {
                out[written++] = 1;
                out[written++] = byte;
            }
            continue;
        }
        if (byte & 0x80) {
            uint8_t hi = byte & 0xF0;
            // SysEx and system common CLEAR running status (MIDI spec);
            // only channel voice statuses set it. (Capturing 0xF0 as
            // running status let a later stray data byte open a phantom
            // SysEx that swallowed the stream.)
            if (hi != 0xF0) m->running_status = byte;
            else m->running_status = 0;
            if (m->len && byte == 0xF7 && m->buf[0] == 0xF0) {
                if (m->len < sizeof(m->buf)) m->buf[m->len++] = byte;
            } else {
                m->len = 0;
                m->buf[m->len++] = byte;
            }
        } else {
            if (!m->len) {
                if (!m->running_status) continue;  // stray data byte
                m->buf[m->len++] = m->running_status;
            }
            if (m->len < sizeof(m->buf)) m->buf[m->len++] = byte;
        }
        if (midi_is_complete(m->buf, m->len)) {
            if (written + 1 + m->len <= out_cap && m->len <= 255) {
                out[written++] = (uint8_t)m->len;
                memcpy(out + written, m->buf, m->len);
                written += m->len;
            }
            m->len = 0;
        }
    }
    return written;
}

}  // extern "C"
