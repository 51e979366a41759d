// tpu-audio native JACK bridge: jackd <-> shm-ring block transport, all C.
//
// The production-hardened sibling of tpu_audio/runtime/jack_bridge.py: the
// Python bridge's ctypes process callback re-enters the interpreter and
// takes the GIL on JACK's real-time thread; this executable keeps the RT
// path pure C — two memcpys and one lock-free ring op per period, no
// allocation, no locks, no interpreter. Topology is identical (reference
// src/jackclient.cu:4-55 inverted onto the shm rings of blockio.cpp):
//
//   jackd RT thread --process_cb--> input ring  --> StreamSession
//   StreamSession   --> output ring --process_cb--> jackd RT thread
//
// libjack is dlopen'd at startup (never a link-time dependency — GPU
// serving hosts usually have no JACK). The library path can be overridden
// with TPU_AUDIO_LIBJACK, which is also how tests drive the full binary
// against a deterministic stub jackd (csrc/jackstub.cpp,
// tests/test_native.py).
//
// Underrun/overrun policy matches the Python bridge: a dry output ring
// plays silence (the engine's reverb tail resumes when it catches up); a
// full input ring drops the NEWEST capture period whole (SPSC all-or-none
// write; the producer must never consume to make room) and counts it.
//
// Usage:
//   tpuaudio_jackbridge --in-ring NAME --out-ring NAME [--name tpu_audio]
//       [--expect-block N] [--expect-rate HZ]
//       [--connect-in PORT --connect-in PORT]
//       [--connect-out PORT --connect-out PORT] [--no-connect]
//       [--max-seconds S]
// Port defaults mirror the reference wiring (system capture/playback,
// src/main.cu:86-89); the Python launcher (jack_bridge.py --native)
// resolves conv[n].input/output from settings and passes them here.

#include <atomic>
#include <cinttypes>
#include <csignal>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <dlfcn.h>
#include <unistd.h>

#include "blockio.h"

// ---- minimal libjack surface (stable C ABI; resolved via dlsym) -----------

typedef struct _jack_client jack_client_t;
typedef struct _jack_port jack_port_t;
typedef uint32_t jack_nframes_t;
typedef int (*JackProcessCallback)(jack_nframes_t, void*);

static const char* JACK_DEFAULT_AUDIO_TYPE = "32 bit float mono audio";
enum { JackPortIsInput = 0x1, JackPortIsOutput = 0x2 };
enum { JackNoStartServer = 0x01 };

struct jack_api {
    jack_client_t* (*client_open)(const char*, int, void*);
    char* (*get_client_name)(jack_client_t*);
    uint32_t (*get_sample_rate)(jack_client_t*);
    jack_nframes_t (*get_buffer_size)(jack_client_t*);
    jack_port_t* (*port_register)(jack_client_t*, const char*, const char*,
                                  unsigned long, unsigned long);
    void* (*port_get_buffer)(jack_port_t*, jack_nframes_t);
    int (*set_process_callback)(jack_client_t*, JackProcessCallback, void*);
    int (*activate)(jack_client_t*);
    int (*deactivate)(jack_client_t*);
    int (*client_close)(jack_client_t*);
    int (*connect)(jack_client_t*, const char*, const char*);
};

static int load_jack(jack_api* j) {
    const char* override_path = getenv("TPU_AUDIO_LIBJACK");
    const char* candidates[] = {override_path, "libjack.so.0", "libjack.so"};
    void* h = nullptr;
    for (const char* c : candidates) {
        if (c && c[0] && (h = dlopen(c, RTLD_NOW | RTLD_LOCAL))) break;
    }
    if (!h) return -1;
#define RESOLVE(field, sym)                                       \
    do {                                                          \
        *(void**)(&j->field) = dlsym(h, sym);                     \
        if (!j->field) { fprintf(stderr, "jackbridge: missing symbol %s\n", \
                                 sym); return -1; }               \
    } while (0)
    RESOLVE(client_open, "jack_client_open");
    RESOLVE(get_client_name, "jack_get_client_name");
    RESOLVE(get_sample_rate, "jack_get_sample_rate");
    RESOLVE(get_buffer_size, "jack_get_buffer_size");
    RESOLVE(port_register, "jack_port_register");
    RESOLVE(port_get_buffer, "jack_port_get_buffer");
    RESOLVE(set_process_callback, "jack_set_process_callback");
    RESOLVE(activate, "jack_activate");
    RESOLVE(deactivate, "jack_deactivate");
    RESOLVE(client_close, "jack_client_close");
    RESOLVE(connect, "jack_connect");
#undef RESOLVE
    return 0;
}

// ---- bridge state ----------------------------------------------------------

// staging bound: one stereo period, planar [L..., R...]. 8192 frames is
// far above any sane jackd period (-p); checked against the server.
static const jack_nframes_t MAX_FRAMES = 8192;

struct bridge {
    jack_api jack;
    jack_client_t* client = nullptr;
    jack_port_t* ports_in[2] = {nullptr, nullptr};
    jack_port_t* ports_out[2] = {nullptr, nullptr};
    ta_ring* in_ring = nullptr;   // capture -> engine
    ta_ring* out_ring = nullptr;  // engine -> playback
    float stage_in[2 * MAX_FRAMES];
    float stage_out[2 * MAX_FRAMES];
    std::atomic<uint64_t> periods{0};
    std::atomic<uint64_t> underruns{0};
    std::atomic<uint64_t> overruns{0};
};

// JACK RT thread: pure C, no allocation, no locks beyond the SPSC atomics.
static int process_cb(jack_nframes_t nframes, void* arg) {
    bridge* b = (bridge*)arg;
    if (nframes > MAX_FRAMES) return 1;
    const uint64_t n = 2ull * nframes;
    // capture -> input ring, planar [L..., R...] (one all-or-none write)
    for (int i = 0; i < 2; i++) {
        const float* src =
            (const float*)b->jack.port_get_buffer(b->ports_in[i], nframes);
        memcpy(b->stage_in + (uint64_t)i * nframes, src,
               nframes * sizeof(float));
    }
    if (!ta_ring_write(b->in_ring, b->stage_in, n))
        b->overruns.fetch_add(1, std::memory_order_relaxed);
    // output ring -> playback (silence on underrun)
    if (!ta_ring_read(b->out_ring, b->stage_out, n)) {
        memset(b->stage_out, 0, n * sizeof(float));
        b->underruns.fetch_add(1, std::memory_order_relaxed);
    }
    for (int i = 0; i < 2; i++) {
        float* dst = (float*)b->jack.port_get_buffer(b->ports_out[i], nframes);
        memcpy(dst, b->stage_out + (uint64_t)i * nframes,
               nframes * sizeof(float));
    }
    b->periods.fetch_add(1, std::memory_order_relaxed);
    return 0;
}

static volatile sig_atomic_t g_stop = 0;
static void on_signal(int) { g_stop = 1; }

static double monotonic_s() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

int main(int argc, char** argv) {
    const char* in_ring_name = nullptr;
    const char* out_ring_name = nullptr;
    const char* name = "tpu_audio";
    long expect_block = 0;
    long expect_rate = 0;
    double max_seconds = 0.0;
    int do_connect = 1;
    const char* connect_in[2] = {"system:capture_1", "system:capture_2"};
    const char* connect_out[2] = {"system:playback_1", "system:playback_2"};
    int n_in = 0, n_out = 0;
    for (int i = 1; i < argc; i++) {
        auto want = [&](const char* flag) {
            if (strcmp(argv[i], flag) != 0) return false;
            if (i + 1 >= argc) {
                fprintf(stderr, "jackbridge: %s needs a value\n", flag);
                exit(2);
            }
            return true;
        };
        if (want("--in-ring")) in_ring_name = argv[++i];
        else if (want("--out-ring")) out_ring_name = argv[++i];
        else if (want("--name")) name = argv[++i];
        else if (want("--expect-block")) expect_block = atol(argv[++i]);
        else if (want("--expect-rate")) expect_rate = atol(argv[++i]);
        else if (want("--max-seconds")) max_seconds = atof(argv[++i]);
        else if (want("--connect-in")) {
            // count EVERY occurrence so a third one trips the stereo
            // check below instead of being silently dropped (the Python
            // launcher hard-errors on the same input)
            if (n_in < 2) connect_in[n_in] = argv[i + 1];
            ++n_in; ++i;
        } else if (want("--connect-out")) {
            if (n_out < 2) connect_out[n_out] = argv[i + 1];
            ++n_out; ++i;
        } else if (strcmp(argv[i], "--no-connect") == 0) do_connect = 0;
        else {
            fprintf(stderr, "jackbridge: unknown arg %s\n", argv[i]);
            return 2;
        }
    }
    if ((n_in && n_in != 2) || (n_out && n_out != 2)) {
        fprintf(stderr,
                "jackbridge: --connect-in/--connect-out must be given "
                "exactly twice (stereo)\n");
        return 2;
    }
    if (!in_ring_name || !out_ring_name) {
        fprintf(stderr,
                "usage: tpuaudio_jackbridge --in-ring NAME --out-ring NAME "
                "[--name N] [--expect-block B] [--expect-rate HZ] "
                "[--connect-in P x2] "
                "[--connect-out P x2] [--no-connect] [--max-seconds S]\n");
        return 2;
    }

    static bridge b;  // static: stage buffers off the stack
    if (load_jack(&b.jack) != 0) {
        fprintf(stderr, "jackbridge: libjack not found (set "
                        "TPU_AUDIO_LIBJACK to override)\n");
        return 3;
    }
    b.in_ring = ta_ring_open(in_ring_name);
    if (!b.in_ring) {
        fprintf(stderr, "jackbridge: cannot open shm ring %s\n", in_ring_name);
        return 4;
    }
    b.out_ring = ta_ring_open(out_ring_name);
    if (!b.out_ring) {
        fprintf(stderr, "jackbridge: cannot open shm ring %s\n",
                out_ring_name);
        return 4;
    }
    b.client = b.jack.client_open(name, JackNoStartServer, nullptr);
    if (!b.client) {
        fprintf(stderr, "jackbridge: jack_client_open failed (is jackd "
                        "running?)\n");
        return 5;
    }
    // the server may rename the client on collision: all port strings must
    // use the ASSIGNED name or jack_connect wires to nothing
    const char* assigned = b.jack.get_client_name(b.client);
    uint32_t rate = b.jack.get_sample_rate(b.client);
    jack_nframes_t block = b.jack.get_buffer_size(b.client);
    if (expect_block && (long)block != expect_block) {
        fprintf(stderr,
                "jackbridge: jackd runs %u frames/period but the session "
                "expects %ld: the shm rings carry unframed f32 and a "
                "mismatch garbles channels — restart jackd with -p%ld\n",
                block, expect_block, expect_block);
        b.jack.client_close(b.client);
        return 6;
    }
    // rate mismatch streams pitch-shifted audio with no other symptom
    // (the reference at least reports the server's rate, jackclient.cu:39
    // — enforce it like the block check; a wrong rate is never intended)
    if (expect_rate && (long)rate != expect_rate) {
        fprintf(stderr,
                "jackbridge: jackd runs %u Hz but the session expects %ld: "
                "audio would stream pitch-shifted — restart jackd with "
                "-r%ld (or the session at %u Hz)\n",
                rate, expect_rate, expect_rate, rate);
        b.jack.client_close(b.client);
        return 6;
    }
    char pname[64];
    for (int i = 0; i < 2; i++) {
        snprintf(pname, sizeof(pname), "in_%d", i);
        b.ports_in[i] = b.jack.port_register(
            b.client, pname, JACK_DEFAULT_AUDIO_TYPE, JackPortIsInput, 0);
        snprintf(pname, sizeof(pname), "out_%d", i);
        b.ports_out[i] = b.jack.port_register(
            b.client, pname, JACK_DEFAULT_AUDIO_TYPE, JackPortIsOutput, 0);
        if (!b.ports_in[i] || !b.ports_out[i]) {
            fprintf(stderr, "jackbridge: port_register failed\n");
            b.jack.client_close(b.client);
            return 5;
        }
    }
    b.jack.set_process_callback(b.client, process_cb, &b);
    signal(SIGINT, on_signal);
    signal(SIGTERM, on_signal);
    if (b.jack.activate(b.client)) {
        fprintf(stderr, "jackbridge: jack_activate failed\n");
        b.jack.client_close(b.client);
        return 5;
    }
    if (do_connect) {
        // reference wiring, conv[n].input/output (src/main.cu:86-89);
        // failures are non-fatal like the reference's unchecked calls
        char port[192];
        for (int i = 0; i < 2; i++) {
            snprintf(port, sizeof(port), "%s:in_%d", assigned, i);
            b.jack.connect(b.client, connect_in[i], port);
            snprintf(port, sizeof(port), "%s:out_%d", assigned, i);
            b.jack.connect(b.client, port, connect_out[i]);
        }
    }
    fprintf(stderr, "jackbridge: client '%s': %u Hz, %u frames/period\n",
            assigned, rate, block);

    double t0 = monotonic_s();
    while (!g_stop) {
        if (max_seconds > 0 && monotonic_s() - t0 >= max_seconds) break;
        usleep(10000);
    }

    b.jack.deactivate(b.client);
    b.jack.client_close(b.client);
    printf("jackbridge: periods=%" PRIu64 " underruns=%" PRIu64
           " overruns=%" PRIu64 "\n",
           b.periods.load(), b.underruns.load(), b.overruns.load());
    fflush(stdout);
    ta_ring_destroy(b.in_ring, nullptr);
    ta_ring_destroy(b.out_ring, nullptr);
    return 0;
}
