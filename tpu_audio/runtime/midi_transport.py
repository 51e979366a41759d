"""Live MIDI byte transports.

The reference reads raw MIDI bytes from an ALSA device on a dedicated
thread (reference src/midi.cu:22-59). A data-center serving host usually
has no ALSA; control bytes arrive over a FIFO, socket, or file instead. These
transports poll a byte stream non-blockingly between audio blocks and push
framed messages into the ControlPlane — same role, same cadence (the
reference's thread also just interleaves with the audio callback).

Usage with StreamSession: pass ``live_midi=MidiByteStream(...)`` — events
are applied at block boundaries exactly like a MidiSchedule.
"""

from __future__ import annotations

import os

from tpu_audio.io.midi import MidiFramer
from tpu_audio.utils.log import Log


class MidiByteStream:
    """Non-blocking framed reader over a fd / FIFO / file path.

    Uses the C framer when the native library is available, else the
    Python framer (identical semantics, tests/test_native.py).
    """

    def __init__(self, path_or_fd, device: str = "", use_native: bool = True):
        if isinstance(path_or_fd, int):
            self.fd = path_or_fd
            self._owns = False
        else:
            # O_NONBLOCK so an idle FIFO never stalls the audio loop
            self.fd = os.open(os.fspath(path_or_fd),
                              os.O_RDONLY | os.O_NONBLOCK)
            self._owns = True
        os.set_blocking(self.fd, False)
        self.device = device
        self.framer = None
        if use_native:
            try:
                from tpu_audio.runtime.native import (
                    NativeMidiFramer, native_available,
                )
                if native_available():
                    self.framer = NativeMidiFramer()
            except Exception:  # pragma: no cover - toolchain-dependent
                self.framer = None
        if self.framer is None:
            self.framer = MidiFramer()

    def poll(self) -> list[tuple[str, bytes]]:
        """Drain available bytes; return framed (device, message) events."""
        events: list[tuple[str, bytes]] = []
        while True:
            try:
                chunk = os.read(self.fd, 4096)
            except BlockingIOError:
                break
            except OSError as exc:
                Log.warn("midi", "transport read error: %s", exc)
                break
            if not chunk:
                break
            for message in self.framer.feed(chunk):
                events.append((self.device, message))
            if len(chunk) < 4096:
                break
        return events

    def close(self) -> None:
        if self._owns and self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


class MultiMidiStream:
    """Aggregates several MidiByteStreams (one per device) into one
    poll() source — the reference's one-reader-thread-per-ALSA-device
    fan-in (src/main.cu:47-48, src/midi.cu:61-108): each stream's events
    carry its device id, and the ControlPlane routes them to the channels
    whose CCMapping.device matches."""

    def __init__(self, streams: list[MidiByteStream]):
        self.streams = list(streams)

    def poll(self) -> list[tuple[str, bytes]]:
        events: list[tuple[str, bytes]] = []
        for stream in self.streams:
            events.extend(stream.poll())
        return events

    def close(self) -> None:
        for stream in self.streams:
            stream.close()


# -- ALSA rawmidi convenience -------------------------------------------------
#
# The reference opens ALSA rawmidi devices by id ("hw:2,0") through
# libasound (reference src/midi.cu:61-86). On Linux those devices are
# plain character files (/dev/snd/midiC<card>D<dev>) that MidiByteStream
# already reads non-blockingly — no libasound needed for READING, which is
# all the reference ever does (its send() is declared but unimplemented,
# src/midi.h:35).

def alsa_rawmidi_path(device_id: str) -> str:
    """'hw:2,0' (reference settings convention, src/main.cu:47) ->
    '/dev/snd/midiC2D0'. Accepts 'hw:C' (device 0) and passes through
    paths that already point at a device file."""
    if device_id.startswith("/"):
        return device_id
    if not device_id.startswith("hw:"):
        raise ValueError(f"not an ALSA rawmidi id: {device_id!r}")
    parts = device_id[3:].split(",")
    card = int(parts[0])
    dev = int(parts[1]) if len(parts) > 1 else 0
    return f"/dev/snd/midiC{card}D{dev}"


def list_alsa_rawmidi(dev_dir: str = "/dev/snd") -> list[str]:
    """Rawmidi device ids present on this host ('hw:C,D' form)."""
    import re

    ids = []
    try:
        names = sorted(os.listdir(dev_dir))
    except OSError:
        return []
    for name in names:
        m = re.fullmatch(r"midiC(\d+)D(\d+)", name)
        if m:
            ids.append(f"hw:{m.group(1)},{m.group(2)}")
    return ids


def open_alsa_rawmidi(device_id: str, **kwargs) -> MidiByteStream:
    """A MidiByteStream over a real ALSA rawmidi device ('hw:2,0'). The
    returned stream plugs into StreamSession(live_midi=...) and frames
    with running status exactly like the reference's reader thread."""
    return MidiByteStream(alsa_rawmidi_path(device_id),
                          device=device_id, **kwargs)
