"""ctypes bindings to the C++ native runtime (csrc/blockio.cpp).

Provides the host-side real-time primitives the reference implements in
C++ (JACK block delivery src/jackclient.cu, ALSA MIDI framing src/midi.cu,
clock pinning scripts/floorit):

  - NativeRing: lock-free SPSC float ring buffer, optionally shared-memory
    backed so another process (an audio server, a capture daemon) can
    exchange blocks with the engine with no locks on the RT path;
  - NativeBlockClock: drift-free absolute-deadline pacing with
    missed-deadline accounting;
  - NativeMidiFramer: C implementation of the MIDI framer, bit-compatible
    with tpu_audio.io.midi.MidiFramer;
  - RingSource / RingSink: BlockSource/BlockSink adapters over NativeRing.

The library is compiled on demand with g++ (cached next to the sources).
Everything here degrades gracefully: ``native_available()`` is False when no
toolchain exists and callers fall back to the pure-Python implementations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from tpu_audio.runtime.backends import BlockSink, BlockSource
from tpu_audio.utils.log import Log

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc")
_LIB_PATH = os.path.join(_CSRC, "libblockio.so")
_STAMP_PATH = _LIB_PATH + ".src.sha256"
_lib = None
_lib_lock = threading.Lock()


def _src_hash() -> str | None:
    src = os.path.join(_CSRC, "blockio.cpp")
    if not os.path.exists(src):
        return None
    with open(src, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _atomic_compile(cmd_for, out_path: str, stamp_path: str,
                    src_hash: str, what: str) -> bool:
    """Compile to a pid-unique tmp file and os.replace() into place —
    concurrent launches (two --native processes after a source edit)
    never exec/dlopen a half-written binary, the same tmp+rename
    convention utils/diskcache.py uses. ``cmd_for(tmp)`` returns the
    compiler argv targeting ``tmp``. Stamps are written the same way,
    AFTER the binary is in place."""
    tmp = f"{out_path}.tmp.{os.getpid()}"
    try:
        subprocess.run(cmd_for(tmp), check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, out_path)
    except (subprocess.SubprocessError, FileNotFoundError, OSError) as exc:
        Log.warn("native", "%s build failed: %s", what, exc)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    stamp_tmp = f"{stamp_path}.tmp.{os.getpid()}"
    with open(stamp_tmp, "w") as fh:
        fh.write(src_hash)
    os.replace(stamp_tmp, stamp_path)
    return True


def _build(src_hash: str) -> bool:
    src = os.path.join(_CSRC, "blockio.cpp")
    return _atomic_compile(
        lambda tmp: ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", src,
                     "-o", tmp, "-lrt"],
        _LIB_PATH, _STAMP_PATH, src_hash, "native library")


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        # the library is only ever loaded when it was built locally from the
        # current blockio.cpp: the build stamps the source's content hash,
        # and any mismatch (or missing stamp — e.g. a binary that arrived by
        # other means) forces a rebuild. Binaries are never version-controlled.
        src_hash = _src_hash()
        if src_hash is None:
            return None
        stamp = None
        if os.path.exists(_STAMP_PATH) and os.path.exists(_LIB_PATH):
            with open(_STAMP_PATH) as fh:
                stamp = fh.read().strip()
        if stamp != src_hash and not _build(src_hash):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as exc:
            Log.warn("native", "cannot load %s: %s", _LIB_PATH, exc)
            return None
        u64, i64, u32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_uint32
        p = ctypes.c_void_p
        lib.ta_ring_create.restype = p
        lib.ta_ring_create.argtypes = [u64, ctypes.c_char_p]
        lib.ta_ring_open.restype = p
        lib.ta_ring_open.argtypes = [ctypes.c_char_p]
        lib.ta_ring_destroy.argtypes = [p, ctypes.c_char_p]
        lib.ta_ring_capacity.restype = u64
        lib.ta_ring_capacity.argtypes = [p]
        lib.ta_ring_readable.restype = u64
        lib.ta_ring_readable.argtypes = [p]
        lib.ta_ring_writable.restype = u64
        lib.ta_ring_writable.argtypes = [p]
        lib.ta_ring_write.restype = u64
        lib.ta_ring_write.argtypes = [p, ctypes.POINTER(ctypes.c_float), u64]
        lib.ta_ring_read.restype = u64
        lib.ta_ring_read.argtypes = [p, ctypes.POINTER(ctypes.c_float), u64]
        lib.ta_clock_create.restype = p
        lib.ta_clock_create.argtypes = [u64]
        lib.ta_clock_wait.restype = i64
        lib.ta_clock_wait.argtypes = [p]
        lib.ta_clock_missed.restype = u64
        lib.ta_clock_missed.argtypes = [p]
        lib.ta_clock_ticks.restype = u64
        lib.ta_clock_ticks.argtypes = [p]
        lib.ta_clock_destroy.argtypes = [p]
        lib.ta_midi_create.restype = p
        lib.ta_midi_destroy.argtypes = [p]
        lib.ta_midi_feed.restype = u32
        lib.ta_midi_feed.argtypes = [p, ctypes.POINTER(ctypes.c_uint8), u32,
                                     ctypes.POINTER(ctypes.c_uint8), u32]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


_BRIDGE_PATH = os.path.join(_CSRC, "tpuaudio_jackbridge")
_BRIDGE_STAMP = _BRIDGE_PATH + ".src.sha256"
_BRIDGE_SOURCES = ("jackbridge.cpp", "blockio.cpp", "blockio.h")


def bridge_path() -> str | None:
    """Build (content-hash cached, like the .so) and return the native
    JACK bridge executable (csrc/jackbridge.cpp) — the no-GIL RT sibling
    of runtime/jack_bridge.py. None when the toolchain is unavailable."""
    h = hashlib.sha256()
    for fname in _BRIDGE_SOURCES:
        src = os.path.join(_CSRC, fname)
        if not os.path.exists(src):
            return None
        with open(src, "rb") as fh:
            h.update(fh.read())
    src_hash = h.hexdigest()
    stamp = None
    if os.path.exists(_BRIDGE_STAMP) and os.path.exists(_BRIDGE_PATH):
        with open(_BRIDGE_STAMP) as fh:
            stamp = fh.read().strip()
    if stamp == src_hash:
        return _BRIDGE_PATH
    if not _atomic_compile(
            lambda tmp: ["g++", "-O2", "-std=c++17",
                         os.path.join(_CSRC, "jackbridge.cpp"),
                         os.path.join(_CSRC, "blockio.cpp"),
                         "-o", tmp, "-ldl", "-lrt", "-lpthread"],
            _BRIDGE_PATH, _BRIDGE_STAMP, src_hash, "jack bridge"):
        return None
    return _BRIDGE_PATH


class NativeRing:
    """SPSC float ring buffer; shared-memory backed when `shm_name` given."""

    def __init__(self, capacity: int, shm_name: str | None = None,
                 _handle=None, _owns: bool = True):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.shm_name = shm_name
        self._owns = _owns
        if _handle is not None:
            self._h = _handle
        else:
            self._h = self._lib.ta_ring_create(
                capacity, shm_name.encode() if shm_name else None)
            if not self._h:
                raise RuntimeError("ta_ring_create failed")

    @classmethod
    def open(cls, shm_name: str) -> "NativeRing":
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        h = lib.ta_ring_open(shm_name.encode())
        if not h:
            raise RuntimeError(f"cannot open shm ring {shm_name}")
        return cls(0, shm_name, _handle=h, _owns=False)

    @property
    def capacity(self) -> int:
        return self._lib.ta_ring_capacity(self._h)

    @property
    def readable(self) -> int:
        return self._lib.ta_ring_readable(self._h)

    @property
    def writable(self) -> int:
        return self._lib.ta_ring_writable(self._h)

    def write(self, data: np.ndarray) -> bool:
        data = np.ascontiguousarray(data, dtype=np.float32)
        ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return bool(self._lib.ta_ring_write(self._h, ptr, data.size))

    def read(self, n: int) -> np.ndarray | None:
        out = np.empty(n, np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if not self._lib.ta_ring_read(self._h, ptr, n):
            return None
        return out

    def close(self, unlink: bool = False) -> None:
        if self._h:
            name = self.shm_name if (unlink and self._owns) else None
            self._lib.ta_ring_destroy(self._h, name.encode() if name else None)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeBlockClock:
    """Absolute-deadline block pacing (drift-free clock_nanosleep)."""

    def __init__(self, period_s: float):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.ta_clock_create(int(period_s * 1e9))

    def wait(self) -> float:
        """Sleep to the next deadline; returns lateness in seconds (<=0 on
        time). Late blocks re-anchor instead of racing to catch up."""
        return self._lib.ta_clock_wait(self._h) / 1e9

    @property
    def missed(self) -> int:
        return self._lib.ta_clock_missed(self._h)

    @property
    def ticks(self) -> int:
        return self._lib.ta_clock_ticks(self._h)

    def close(self):
        if self._h:
            self._lib.ta_clock_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeMidiFramer:
    """C MIDI framer; same semantics as tpu_audio.io.midi.MidiFramer."""

    def __init__(self):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.ta_midi_create()
        self._out = np.empty(4096, np.uint8)

    def feed(self, data: bytes) -> list[bytes]:
        arr = np.frombuffer(data, dtype=np.uint8)
        # ta_midi_feed DROPS completed messages on out overflow; the
        # provable bound is 3 out bytes per input byte (1-data-byte
        # running status emits len+status+data) plus one buffered
        # sub-256-byte message — an undersized fixed 4096 buffer lost
        # half the messages of a 4096-byte running-status CC flood
        need = 3 * arr.size + 260
        if self._out.size < need:
            self._out = np.empty(need, np.uint8)
        in_ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        out_ptr = self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        n = self._lib.ta_midi_feed(self._h, in_ptr, arr.size, out_ptr,
                                   self._out.size)
        messages = []
        i = 0
        while i < n:
            # int() is load-bearing: numpy-2 promotion makes
            # `int + uint8` a uint8, so `i` would wrap at 256 and loop
            # forever once a feed returns more than 255 framed bytes
            length = int(self._out[i])
            messages.append(bytes(self._out[i + 1:i + 1 + length]))
            i += 1 + length
        return messages

    def close(self):
        if self._h:
            self._lib.ta_midi_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RingSource(BlockSource):
    """BlockSource over a NativeRing: frames arrive from another process."""

    def __init__(self, ring: NativeRing, num_voices: int, block: int,
                 blocking: bool = False, max_empty_reads: int = 1000):
        self.ring = ring
        self.shape = (num_voices, 2, block)
        self.n = num_voices * 2 * block
        self.blocking = blocking
        self.max_empty_reads = max_empty_reads

    def read(self) -> np.ndarray | None:
        import time
        empty = 0
        while True:
            data = self.ring.read(self.n)
            if data is not None:
                return data.reshape(self.shape)
            if not self.blocking:
                return None
            empty += 1
            if empty > self.max_empty_reads:
                return None
            time.sleep(0.0005)


class RingSink(BlockSink):
    def __init__(self, ring: NativeRing):
        self.ring = ring
        self.dropped = 0

    def write(self, block: np.ndarray) -> None:
        if not self.ring.write(block):
            self.dropped += 1
