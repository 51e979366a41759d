"""On-device IR preparation: time-domain PCM crosses the host link,
spectra and packed MAC tensors are computed in-jit on the device.

Reference parity: ``Convolution::prepare`` computes every IR spectrum ON
THE GPU (cufftExecC2C + Hermitian unpack, reference src/conv.cu:207-253);
the only H2D traffic is the WAV's PCM samples (src/wav.cu:100). Host prep
(engine.prepare_bank) instead builds spectra and packed MAC tensors in
numpy and uploads them as planar f32 — the 152-IR cascade bank is ~2.1 GB,
and the host-side prep of 152 4 s IRs costs minutes of strided numpy
copies. This module keeps the reference's architecture:

  - the host uploads ONE [K, O, L] float32 (or exact int16, see
    ``encode_pcm16_exact``) tensor — ~215 MB (f32) / ~107 MB (pcm16)
    for the 152-IR 4 s bank, 10-20x fewer bytes than the packed tensors;
  - partition FFTs run through ops/fft.py (``backend="auto"``);
  - the double+reverse and plane packs are jnp gathers/transposes (the
    reverse is a modular GATHER by a host-precomputed index);
  - complex values exist only inside the jit.

Exactness: the device FFT agrees with the host pocketfft reference to
f32 rounding; the packs themselves are bit-exact axis moves + one
negation. Equivalence vs host prep is tested at the FFT backend's
tolerance (tests/test_device_prep.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpu_audio.utils.jitcache import instance_cached

# the exact 16-bit WAV scaling read_wav applies (reference src/wav.cu
# /65536 headroom convention): x = q / 65536 with q an int16. 1/65536 is
# a power of two, so the decode multiply below is EXACT in f32.
_PCM16_SCALE = 65536.0

# module-level jit: a per-call jax.jit(lambda ...) wrapper re-traces and
# re-loads its executable on every upload (the exact pattern
# utils/jitcache.instance_cached exists to kill); one shared wrapper
# retraces only per input shape
_decode_pcm16 = jax.jit(lambda a: a.astype(jnp.float32)
                        * jnp.float32(1.0 / _PCM16_SCALE))


def bank_time_domain(bank) -> np.ndarray:
    """IRBank -> [K, O, Lmax] float32, IRs zero-padded to the bank's
    longest entry (zero tail partitions transform to zero spectra — the
    same padding prepare_bank's gather layout already relies on)."""
    k = len(bank)
    l_max = bank.max_length
    out = np.zeros((k, 2, l_max), np.float32)
    for i in range(k):
        ir = bank.ir(i)
        out[i, :, : ir.shape[-1]] = ir
    return out


def encode_pcm16_exact(td: np.ndarray) -> np.ndarray | None:
    """int16 wire encoding when EXACT, else None. Exact iff every sample
    is q/65536 with q in int16 range — true for any IR loaded from a
    16-bit WAV (read_wav's /65536 scaling), including tiled/truncated
    copies, but not for normalized or 24-bit/float sources."""
    q = td * _PCM16_SCALE
    r = np.rint(q)
    if (np.abs(q - r) > 0).any() or r.min() < -32768 or r.max() > 32767:
        return None
    return r.astype(np.int16)


def upload_bank_td(td: np.ndarray, wire: str = "auto"):
    """Host [K, O, L] f32 -> device f32, over the smallest exact wire.

    wire='auto': int16 when ``encode_pcm16_exact`` holds (halves the
    upload), else f32. The decode multiply is exact (power-of-two
    scale). Returns (device_array_f32, wire_used)."""
    if wire not in ("auto", "f32", "pcm16"):
        raise ValueError(f"unknown td wire {wire!r}")
    if wire != "f32":
        q = encode_pcm16_exact(td)
        if q is not None:
            return _decode_pcm16(jnp.asarray(q)), "pcm16"
        if wire == "pcm16":
            raise ValueError("pcm16 td wire requested but the bank is not "
                             "on the 16-bit grid (normalized or >16-bit "
                             "source); use wire='f32'")
    return jnp.asarray(td), "f32"


# -- in-graph building blocks ---------------------------------------------------


def partition_fd(td, block: int, parts: int, offset: int, xf):
    """In-graph ``ops.partition.partition_spectra``: [..., L] time-domain
    -> [..., parts, F] complex partition spectra (each partition `block`
    samples zero-padded to 2*block, overlap-save layout). Samples past
    offset + parts*block are EXCLUDED (the host version truncates the
    same way via max_partitions)."""
    lead = td.shape[:-1]
    length = td.shape[-1]
    keep = max(min(length - offset, parts * block), 0)
    # clamp the slice START too: offset > length is legal input (e.g. a
    # working-set compact sub-bank whose resident IRs are all shorter
    # than the cascade head, 2*ratio*block — the host prepare_bank
    # zero-pads the same case) but slice_in_dim requires start <= length
    start = min(offset, length)
    x = jax.lax.slice_in_dim(td, start, start + keep, axis=td.ndim - 1)
    x = jnp.pad(x, [(0, 0)] * len(lead) + [(0, parts * block - keep)])
    x = x.reshape(lead + (parts, block))
    x = jnp.pad(x, [(0, 0)] * (len(lead) + 1) + [(0, block)])
    return xf.rfft(x)


def pad_parts(spec, pp: int):
    """Zero-pad the partition axis (-2) to pp (fmajor._pad_p on spectra;
    a zero partition has a zero spectrum, so padding commutes with the
    FFT and is done here, after it — cheaper)."""
    pad = pp - spec.shape[-2]
    if pad == 0:
        return spec
    widths = [(0, 0)] * (spec.ndim - 2) + [(0, pad), (0, 0)]
    return jnp.pad(spec, widths)


def double_reversed_j(spec, axis: int):
    """In-graph ``fmajor.double_reversed``: out[j] = spec[(-j) mod P],
    tiled twice along `axis` — a modular GATHER by a host constant
    index."""
    p = spec.shape[axis]
    idx = (p - np.arange(2 * p)) % p
    return jnp.take(spec, jnp.asarray(idx), axis=axis)


def pack_mac_rhs_j(spec):
    """In-graph ``fmajor.pack_mac_rhs`` on an already partition-padded
    [K, O, P, F] complex spectra: -> [F, 2, P, K*O*2] f32 plane-major
    MAC rhs (plane 0 = (br, bi), plane 1 = (-bi, br))."""
    k, o, p, f = spec.shape
    br = jnp.transpose(jnp.real(spec), (3, 2, 0, 1))       # [F, P, K, O]
    bi = jnp.transpose(jnp.imag(spec), (3, 2, 0, 1))
    p0 = jnp.stack([br, bi], axis=-1)                      # [F, P, K, O, 2]
    p1 = jnp.stack([-bi, br], axis=-1)
    return jnp.stack([p0, p1], axis=1).reshape(f, 2, p, k * o * 2)


def pack_rev2_j(dbl):
    """In-graph ``fmajor.pack_spectra_rev2`` taking the already
    doubled+reversed [K, O, 2Pp, F] complex: -> [K, F, O, 2, 2Pp] f32."""
    re = jnp.transpose(jnp.real(dbl), (0, 3, 1, 2))        # [K, F, O, 2Pp]
    im = jnp.transpose(jnp.imag(dbl), (0, 3, 1, 2))
    return jnp.stack([re, im], axis=3)                     # [K, F, O, 2, 2Pp]


def pack_planar_j(spec):
    """In-graph ``fmajor.pack_planar_spectra`` on partition-padded
    [K, O, Pp, F] complex: -> [K, O, Pp, F, 2] f32."""
    return jnp.stack([jnp.real(spec), jnp.imag(spec)], axis=-1)


def pack_tail_fminor_j(tail_dbl):
    """In-graph cascade tail pack (cascade._pack_bank_host's F-minor
    branch) on doubled [K, O, 2Pp2, F2] complex: -> [2, 2Pp2, K*O*2, F2]
    f32, built directly frequency-minor."""
    k, o, p2, f = tail_dbl.shape
    br = jnp.transpose(jnp.real(tail_dbl), (2, 0, 1, 3))   # [2Pp2, K, O, F]
    bi = jnp.transpose(jnp.imag(tail_dbl), (2, 0, 1, 3))
    p0 = jnp.stack([br, bi], axis=3)                       # [2Pp2, K, O, 2, F]
    p1 = jnp.stack([-bi, br], axis=3)
    return jnp.stack([p0, p1], axis=0).reshape(2, p2, k * o * 2, f)


# -- per-engine bank builders ----------------------------------------------------


def _fmajor_graph(engine, td):
    """td [K, O, L] f32 -> FMajorBank leaf tuple (mac_rhs, planar,
    rev2-or-rhs2 pieces) mirroring FMajorPartitionedConvolution.
    _pack_bank_host + prepare_bank's leaf placement."""
    from tpu_audio.engine.fmajor import FMajorBank

    dt = engine.mac_dtype
    spec = pad_parts(
        partition_fd(td, engine.block, engine.partitions, 0, engine.xf),
        engine.pp)                                         # [K, O, Pp, F]
    zero4 = jnp.zeros((1, 1, 1, 1), dt)
    zero5f = jnp.zeros((1, 1, 1, 1, 1), jnp.float32)
    zero5 = jnp.zeros((1, 1, 1, 1, 1), dt)
    if engine.ring_mode:
        dbl = double_reversed_j(spec, axis=2)              # [K, O, 2Pp, F]
        rhs2 = (pack_mac_rhs_j(dbl).astype(dt)
                if engine.mac_strategy == "allk" else zero4)
        return FMajorBank(mac_rhs=zero4, rhs2=rhs2, spectra=zero5f,
                          spectra_rev2=pack_rev2_j(dbl).astype(dt))
    mac_rhs = (pack_mac_rhs_j(spec).astype(dt)
               if engine.mac_strategy == "allk" else zero4)
    return FMajorBank(mac_rhs=mac_rhs, rhs2=zero4,
                      spectra=pack_planar_j(spec), spectra_rev2=zero5)


def _cascade_graph(engine, td):
    """td [K, O, L] f32 -> CascadeBank (head_rhs2, tail_rhs2) mirroring
    CascadeConvolution._pack_bank_host."""
    from tpu_audio.engine.cascade import CascadeBank

    dt = engine.mac_dtype
    head = pad_parts(
        partition_fd(td, engine.block, engine.head_parts, 0, engine.xf1),
        engine.pp1)
    head_rhs2 = pack_mac_rhs_j(double_reversed_j(head, axis=2))
    tail = pad_parts(
        partition_fd(td, engine.b2, engine.tail_parts, 2 * engine.b2,
                     engine.xf2),
        engine.pp2)
    tail_rhs2 = pack_tail_fminor_j(double_reversed_j(tail, axis=2))
    return CascadeBank(head_rhs2=head_rhs2.astype(dt),
                       tail_rhs2=tail_rhs2.astype(dt))


def _prep_fn(engine, kind: str, td_shape):
    """The memoized jitted bank builder for one (engine geometry, input
    shape). td is an EXPLICIT argument: closure-captured device arrays
    would inline into the HLO as constants (a 215 MB program text)."""
    graph = _fmajor_graph if kind == "fmajor" else _cascade_graph
    return instance_cached(
        engine, ("device_prep", kind, td_shape),
        lambda: jax.jit(partial(graph, engine)))


def _prepare_device(engine, kind, td, wire):
    td = td if isinstance(td, np.ndarray) else bank_time_domain(td)
    if engine.num_irs is not None and td.shape[0] != engine.num_irs:
        raise ValueError(f"bank has {td.shape[0]} IRs, engine was built "
                         f"for num_irs={engine.num_irs}")
    engine.num_irs = td.shape[0]
    dev, _w = upload_bank_td(td, wire)
    return _prep_fn(engine, kind, dev.shape)(dev)


def prepare_fmajor_bank_device(engine, td, wire: str = "auto"):
    """[K, O, L] host f32 (or IRBank) -> device FMajorBank, spectra +
    packs computed on the device. Mirrors engine.prepare_bank(spectra) to
    the device FFT's tolerance."""
    return _prepare_device(engine, "fmajor", td, wire)


def prepare_cascade_bank_device(engine, td, wire: str = "auto"):
    """[K, O, L] host f32 (or IRBank) -> device CascadeBank, computed on
    the device (a PCM upload instead of the packed tensors)."""
    return _prepare_device(engine, "cascade", td, wire)
