"""utils/xplane — schema-free profiler-trace reader. Round-trip against
hand-encoded protobuf bytes (we control the wire format exactly) plus
malformed-input behavior: the p99_block bench leg must degrade to a
clean 'skipped'/error row on any trace the parser cannot read, never
hang or misattribute."""

import struct

import pytest

from tpu_audio.utils import xplane


def varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def field(num: int, wire: int, payload) -> bytes:
    tag = varint((num << 3) | wire)
    if wire == 0:
        return tag + varint(payload)
    if wire == 2:
        return tag + varint(len(payload)) + payload
    if wire == 5:
        return tag + struct.pack("<I", payload)
    if wire == 1:
        return tag + struct.pack("<Q", payload)
    raise ValueError(wire)


def encode_space():
    """XSpace with one device plane: metadata {7: 'jit_step'}, one line
    with three jit_step events (durations 1,2,3 ms in ps)."""
    meta = field(1, 0, 7) + field(2, 2, b"jit_step")
    entry = field(1, 0, 7) + field(2, 2, meta)        # map key + value
    events = b"".join(
        field(4, 2, field(1, 0, 7) + field(2, 0, 50) + field(3, 0, d))
        for d in (1_000_000_000, 2_000_000_000, 3_000_000_000))
    line = field(2, 2, b"XLA Modules") + events
    plane = (field(2, 2, b"/device:GPU:0") + field(3, 2, line)
             + field(4, 2, entry))
    # plus a host plane that must be excluded by name
    hline = field(4, 2, field(1, 0, 7) + field(3, 0, 9_000_000_000))
    hplane = (field(2, 2, b"/host:CPU") + field(3, 2, hline)
              + field(4, 2, entry))
    return field(1, 2, plane) + field(1, 2, hplane)


def test_parse_hand_encoded_space(tmp_path):
    p = tmp_path / "t.xplane.pb"
    p.write_bytes(encode_space())
    planes = xplane.plane_events(str(p))
    assert set(planes) == {"/device:GPU:0", "/host:CPU"}
    durs = planes["/device:GPU:0"]["jit_step"]
    assert durs == [1_000_000_000, 2_000_000_000, 3_000_000_000]
    ms = xplane.device_step_durations_ms(str(tmp_path), "jit_step")
    assert ms == {"jit_step": [1.0, 2.0, 3.0]}   # host plane excluded


def test_unknown_fields_and_fixed_width_skipped(tmp_path):
    """Extra fields of every wire type must be skipped structurally."""
    extra = (field(9, 0, 12345) + field(10, 5, 7) + field(11, 1, 8)
             + field(12, 2, b"opaque"))
    plane = field(2, 2, b"/device:GPU:0") + extra
    p = tmp_path / "t.xplane.pb"
    p.write_bytes(field(1, 2, plane) + extra)
    assert "/device:GPU:0" in xplane.plane_events(str(p))


def test_truncated_and_garbage_raise_cleanly(tmp_path):
    good = encode_space()
    for name, payload in (("trunc", good[: len(good) // 2]),
                          ("garbage", b"\x07\x03not a proto at all")):
        p = tmp_path / f"{name}.xplane.pb"
        p.write_bytes(payload)
        with pytest.raises((ValueError, IndexError)):
            xplane.plane_events(str(p))


def test_newest_trace_empty_dir(tmp_path):
    assert xplane.newest_trace(str(tmp_path)) is None
    assert xplane.device_step_durations_ms(str(tmp_path), "x") == {}
