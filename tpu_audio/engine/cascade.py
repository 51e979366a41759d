"""Two-stage non-uniform partitioned convolution (Gardner-style cascade).

The uniform f-major engine's voice ceiling is a memory-bandwidth roofline:
the steady MAC streams the whole frequency-domain delay line (2.86 MB/voice
at 4 s f32) every block. Classic real-time convolvers
(Gardner 1995) break that wall with NON-UNIFORM partitions: small blocks
for the IR head (low latency), large blocks for the tail (amortized cost).
This engine is the batched, fixed-shape form of that idea:

  - **head stage**: the IR's first ``2*ratio`` block-sized partitions run
    the exact f-major allk ring MAC every block (same math as
    engine/fmajor.py, span-provenance crossfades included);
  - **tail stage**: the rest of the IR is partitioned at ``B2 = ratio *
    block`` samples. A tail chunk is one rfft(2*B2) + partition MAC +
    irfft, needed only once per ``ratio`` blocks per voice;
  - **voice staggering**: voice ``i`` belongs to group ``i % ratio`` and
    group ``t mod ratio`` processes its tail chunk at block ``t`` — every
    block does the SAME work (head MAC for all voices + one group's tail),
    so p99 equals the mean; there is no spike block to miss a deadline on.
    The STRIDED assignment makes the schedule invariant under contiguous
    voice sharding (each shard's local voices contain every group in the
    same phase), so the shard_map data-parallel step
    (parallel/mesh.py:shard_cascade_step) is exactly equal to the
    single-device engine, fades included.

Per-block HBM traffic drops from O(P) to O(2*ratio + P/ratio) delay-line
partitions — ~8x fewer bytes at 4 s IRs with ratio 16 — which is what
lifts the real-time voice ceiling (see README).

Tail scheduling: a chunk completing at input sample E covers output
samples [E - B2 + H, E + H) where H = 2*B2 is the head length, i.e. its
earliest contribution lands ratio+1 output blocks after the chunk's final
input block — the tail result is scattered into the SAME predelay
block-slot wet ring the head uses (slots ratio+1 ... 2*ratio+1 plus the
predelay offset) and every output block emits head+tail together before
the clamp, exactly like the reference's single overlap-add accumulator
(src/conv.cu:411-415).

Crossfades ride the span representation exclusively (the snapshot is
always sum_k base_g[k]*bank[k]; see fmajor.py) — there is no materialized
snapshot, so ``swap_snapshot`` is effectively False: StreamSession defers
live bank swaps until fades decay. Because a tail chunk's output spans the
next ``ratio`` blocks, its crossfade weights are PROJECTED at compute time
(the coefficient recursion is deterministic given vsteps): fades remain
per-block smooth on the whole output, but a parameter event (re-select,
wet/pan/level/predelay change) reaches the tail portion of the sound up to
``2*ratio+1`` blocks (~one tail window) later than the head portion — the
head (early reflections) responds per-block as always. The reference
itself phases parameter changes in gradually through its spectral slew
(src/conv.cu:15-32); here the tail's extra quantization is bounded and
equivalence-tested (tests/test_cascade.py).

Steady-state output is EXACT vs the uniform engines (golden-tested against
fmajor and scipy.fftconvolve).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

import jax
import jax.numpy as jnp

from tpu_audio.engine.params import VoiceParams
from tpu_audio.ops.fft import SpectralTransform
from tpu_audio.ops.mix import add_dry, pan_gains, wet_scale

# Contraction precisions of the f32 engine, held to the same gates as
# fmajor.py's (PERF.md has the measured error and cost of each choice).
#   MAC_PRECISION: head and tail delay-line MACs. HIGHEST: TF32 (HIGH)
#     misses the golden gate; HIGHEST costs +2.3% over it at 1024 voices.
#   MIX_PRECISION: coefficient mixes and one-hot ring scatters. HIGHEST:
#     at HIGH the bounce-vs-stream diff is 7.4e-3, past the 1e-4 gate.
MAC_PRECISION = jax.lax.Precision.HIGHEST
MIX_PRECISION = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclass
class CascadeBank:
    """Device bank: doubled+time-reversed MAC tensors for both stages.

    The tail tensors are FREQUENCY-MINOR (F2 last): with only ~48 tail
    partitions, the partition axis is too short to be the minor (vector)
    axis, so frequency is — a frequency-major boundary layout would make
    the compiler re-lay the 200 MB fdl2 with full-buffer copies each
    block. The head keeps the f-major layout (its MAC rides the same
    lowering as fmajor's). Which copy and transpose fusions remain on
    the GPU is in PERF.md."""

    head_rhs2: jax.Array  # [F1, 2, 2*P1p, K*O*2]
    tail_rhs2: jax.Array  # [2, 2*P2p, K*O*2, F2]  (frequency-minor)

    @property
    def num_irs(self) -> int:
        return self.head_rhs2.shape[-1] // 4


@jax.tree_util.register_dataclass
@dataclass
class CascadeState:
    """Tail-stage leaves carry the stagger group as an EXPLICIT axis
    (voice i lives at [i // ratio, i % ratio]): group g's chunk is then a
    direct dynamic_slice/update on a leaf axis, which XLA aliases in place
    for donated buffers. Routing the same update through reshape ->
    update -> reshape copies the whole leaf every block (~200 MB for fdl2
    at 64 voices x 4 s)."""

    t: jax.Array          # i32 [] block counter (drives ring slots + groups)
    fdl1: jax.Array       # [F1, VI, 2, P1p] head freq delay line
    prev_in: jax.Array    # f32 [V, 2, B]
    inbuf2: jax.Array     # f32 [M, Vg, 2, 4*ratio, B] doubled input ring
    fdl2: jax.Array       # [M, Vg, I, d, P2p, F2] tail freq delay line
                          # (frequency-minor, see CascadeBank; the stagger
                          # group is the MAJOR axis so group g's chunk is
                          # a contiguous region — sliced and updated with
                          # no copy, which middle-axis slices cost)
    wet_ring: jax.Array   # f32 [V, NBH, 2, B] head block-slot ring (NBH =
                          # maxpd/B + 2, half the tail ring's span)
                          # (slot-major-of-channel, so the per-voice emit
                          # reads one contiguous [2, B] slot)
    tail_ring: jax.Array  # f32 [M, Vg, I, O, NB, B] tail accumulator,
                          # input-channel-resolved so collapse_pure can
                          # rescale in-flight fade-out content per (v, ch)
    coef_a: jax.Array     # f32 [V, 2]
    coef_c: jax.Array     # f32 [V, 2]
    base_g: jax.Array     # f32 [V, 2, K] span fade provenance (fmajor.py;
                          # 'selected': [V, 2, 1] placeholder — selected
                          # never re-enters the span)
    base_pure: jax.Array  # bool [V, 2] ('allk': always True — span-only;
                          # 'selected': True = zero snapshot, False after
                          # the first materializing collapse, fmajor.py)
    # 'selected' strategy only (placeholder-shaped under 'allk'): the
    # per-voice gathered MAC rhs (sel_*) and the materialized fade
    # snapshot rhs (base_*) — the MAC is LINEAR in its rhs weights, so
    # the affine crossfade a*base + c*sel rides materialized rhs tensors
    # exactly like fmajor's materialized spectra (fmajor.py:634-642)
    sel_head: jax.Array   # mac [F1, V, I, d, 2*P1p, OD]
    sel_tail: jax.Array   # mac [M, Vg, I, d, 2*P2p, OD, F2] (group-major)
    base_head: jax.Array  # mac [F1, V, I, d, 2*P1p, OD]
    base_tail: jax.Array  # mac [M, Vg, I, d, 2*P2p, OD, F2]
    pd_q: jax.Array       # i32 [V] previous block's block-granular
                          # predelay — predelay_side='read' detects edits
                          # (q != pd_q) and re-times the head FIFO so
                          # buffered wet keeps its absolute emit time
                          # (exact write-side semantics; see _head_stage).
                          # Carried (tiny) in write mode too, unused.
    pd_m: jax.Array       # i32 [V] live margin: highest buffered emit
                          # time minus current block (max(m-1, q) per
                          # block). Steady state m == q; after a predelay
                          # DECREASE m stays at the old q for delta
                          # blocks — the FIFO spill slot then holds LIVE
                          # re-timed wet and must be accumulated into,
                          # not cleared (see _head_stage).


class CascadeConvolution:
    """V stereo voices, two-stage non-uniform partitioned OLS."""

    variant = "coef"          # StreamSession coef-engine interface
    ring_mode = True
    collapse_takes_params = True  # in-flight tail rescale needs vsteps/predelay
    ALLK_MAX_COLUMNS = 64     # K <= 16 stereo IRs (fmajor.py threshold)
    TAIL_DOT_MIN_ROWS = 32    # tail_mac='auto' threshold on Vg*I (PERF.md)

    def __init__(self, num_voices: int, block: int, partitions: int,
                 ratio: int = 16, max_predelay: int = 8192,
                 backend: str = "auto", num_irs: int | None = None,
                 mac_dtype: str = "f32", predelay_side: str = "write",
                 tail_mac: str = "auto", mac_strategy: str = "allk"):
        if num_voices % ratio:
            raise ValueError(f"{num_voices} voices not divisible by the "
                             f"stagger ratio {ratio} (one voice group's "
                             f"tail chunk runs per block)")
        if partitions <= 2 * ratio:
            raise ValueError(f"IR has {partitions} block partitions <= head "
                             f"length 2*ratio={2 * ratio}; use the uniform "
                             f"fmajor engine for short IRs")
        self.num_voices = num_voices
        self.block = block
        self.partitions = partitions            # total, at block granularity
        self.ratio = ratio
        self.b2 = ratio * block                 # tail partition size
        self.head_parts = 2 * ratio             # head covers [0, 2*B2)
        self.tail_parts = -(-(partitions - self.head_parts) // ratio)
        self.pp1 = -(-self.head_parts // 8) * 8
        self.pp2 = -(-self.tail_parts // 8) * 8
        self.max_predelay = max_predelay
        self.num_irs = num_irs
        if mac_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown mac_dtype {mac_dtype!r}")
        # predelay_side="read" (opt-in, voice-scaling lever): the head wet
        # ring becomes a plain FIFO — each block writes its pre-delay wet
        # into TWO slots (small writes) and the emit gathers slot
        # (t - q) mod NH per voice, instead of the write-side one-hot
        # scatter whose add is a full ring read+WRITE pass every block
        # (~107 MB at 1536 voices). EXACTLY equal while predelay is
        # constant (tested); at a predelay CHANGE the semantics differ
        # from the reference's residual buffer (src/conv.cu:89-100):
        # write-side keeps already-scattered wet at its old delay (new
        # content gaps/overlaps), read-side re-times the buffered wet too
        # (a skip/repeat of up to maxPredelay). Both are click-bounded;
        # the default stays reference-faithful.
        if predelay_side not in ("write", "read"):
            raise ValueError(f"unknown predelay_side {predelay_side!r}")
        self.predelay_side = predelay_side
        self.mac_dtype = jnp.float32 if mac_dtype == "f32" else jnp.bfloat16
        self._mac_prec = (MAC_PRECISION if mac_dtype == "f32"
                          else jax.lax.Precision.DEFAULT)
        # tail MAC lowering: the (d, q) contraction runs either as a fused
        # broadcast-multiply + reduce ("reduce") or as a dot_general
        # batched over F2 ("dot", [Vg*I, d*q] @ [d*q, K4] per bin). "auto"
        # picks "dot" once Vg*I reaches TAIL_DOT_MIN_ROWS: on the H100 the
        # dot form won at every measured count, 256 voices (32 rows) to
        # 2048 (PERF.md, tail_mac A/B); below 32 rows it was not measured
        # and the reduce form stays. In bf16 the dot form
        # is also the more accurate one: it accumulates exact bf16
        # products in f32, while the reduce form rounds each product to
        # bf16 first.
        if tail_mac not in ("auto", "reduce", "dot"):
            raise ValueError(f"unknown tail_mac {tail_mac!r}")
        vg_rows = (num_voices // ratio) * 2
        # requested value kept for clones: 'auto' re-resolves at the
        # clone's own voice count (a 256-virtual-voice bounce engine
        # may resolve differently from its 64-voice base)
        self._tail_mac_requested = tail_mac
        self.tail_mac = (tail_mac if tail_mac != "auto"
                         else ("dot" if vg_rows >= self.TAIL_DOT_MIN_ROWS
                               else "reduce"))
        # MAC strategy (fmajor.py semantics): 'allk' computes every IR's
        # product and keeps fades in the bank's span (the production path
        # for small/working-set banks); 'selected' materializes each
        # voice's selected rhs in state (large banks, e.g. the reference's
        # 152-IR all.index served with MORE concurrently-selected IRs than
        # a working set can hold) — per-block cost is then K-independent:
        # the tail reads only the CURRENT GROUP's [Vg, ...] rhs slice,
        # ~1/ratio of the per-voice tensors fmajor's 'selected' touches
        # every block. Memory scales with V (~25 MB/voice tail rhs at 4 s
        # f32, x2 during fades): a moderate-voice/large-bank trade.
        if mac_strategy == "auto":
            if num_irs is None:
                raise ValueError("mac_strategy='auto' needs num_irs")
            mac_strategy = ("allk" if num_irs * 4 <= self.ALLK_MAX_COLUMNS
                            else "selected")
        if mac_strategy not in ("allk", "selected"):
            raise ValueError(f"unknown mac_strategy {mac_strategy!r}")
        self.mac_strategy = mac_strategy
        # 'selected' fades run against a materialized base rhs, so a live
        # bank swap mid-fade CAN keep the old bank's tail; 'allk' stays
        # span-only (swaps defer until fades decay)
        self.swap_snapshot = mac_strategy == "selected"
        # keep the REQUESTED backend (e.g. 'auto'), not a resolved one:
        # the two transforms may resolve differently per size
        # (ops/fft.AUTO_BACKENDS), so propagating xf1.backend to a clone
        # could force the tail onto another size's form — a 'matmul' head
        # would put dense [n, F] DFT matrices at n=8192, 4 x 134 MB
        # constants, into every offline-bounce step's HLO
        self.backend = backend
        self.xf1 = SpectralTransform(2 * block, backend=backend)
        self.xf2 = SpectralTransform(2 * self.b2, backend=backend)
        self.f1 = self.xf1.num_bins
        self.f2 = self.xf2.num_bins
        # tail chunk k's earliest output lands ratio+1 blocks after its
        # final input block; pieces span ratio+1 slots; + predelay offset
        self.tail_slot0 = ratio + 1
        self.ring_slots = max_predelay // block + 2 * ratio + 3
        # the head ring only spans the predelay (+1 spill +1 emit)
        self.head_slots = max_predelay // block + 2
        # wrap the block counter at the lcm of every modulus derived from
        # it, so rem-indices stay continuous across the wrap and an
        # unbounded live session never sees int32 overflow (rem on a
        # wrapped-negative counter returns negative slots = silent audio)
        import math

        self.t_modulus = math.lcm(self.pp1, ratio * self.pp2, 2 * ratio,
                                  self.ring_slots, self.head_slots)
        if self.t_modulus >= 2 ** 31:
            from tpu_audio.utils.log import Log
            Log.warn("cascade", "block-counter modulus %d overflows int32; "
                     "sessions longer than ~2^31 blocks will corrupt "
                     "ring indices", self.t_modulus)
            self.t_modulus = 0

    # -- offline / cloning interface ------------------------------------------------

    def with_voices(self, num_voices: int) -> "CascadeConvolution":
        """Same geometry/strategy at another voice count (must stay
        divisible by the stagger ratio). Device banks are voice-independent
        — the seam runtime/offline.py's time-parallel renderer builds on."""
        clone = CascadeConvolution(
            num_voices, self.block, self.partitions, ratio=self.ratio,
            max_predelay=self.max_predelay, backend=self.backend,
            num_irs=self.num_irs,
            mac_dtype="f32" if self.mac_dtype == jnp.float32 else "bf16",
            predelay_side=self.predelay_side,
            tail_mac=self._tail_mac_requested,
            mac_strategy=self.mac_strategy)
        # The backend=self.backend above is the actual HTTP-413 fix (the
        # REQUESTED backend re-resolves per transform size; the old code
        # propagated xf1's RESOLVED 'matmul' to the n=8192 tail). Sharing
        # the parent's transform objects on top just avoids rebuilding
        # twiddle tables per clone.
        clone.xf1, clone.xf2 = self.xf1, self.xf2
        return clone

    @property
    def history_blocks(self) -> int:
        """Trailing input blocks that fully determine the next output block
        at converged params: the tail delay line's span in blocks plus the
        stagger window, head coverage, and the deepest ring deferral (see
        fmajor.history_blocks for the offline-renderer contract)."""
        return ((self.tail_parts + 2) * self.ratio + self.head_parts
                + self.ring_slots + 2)

    # -- bank ---------------------------------------------------------------------

    def _pack_bank_host(self, head_spec: np.ndarray, tail_spec: np.ndarray):
        """Host complex partition spectra -> the numpy MAC tensors
        (head [F1, 2, 2Pp1, KOD] and frequency-minor tail
        [2, 2Pp2, KOD, F2]), doubling BEFORE packing (gather with F-sized
        chunks; see fmajor.double_reversed for the measured 50x).

        The tail tensor is built DIRECTLY in its F-minor layout: packing
        F-major first and transposing after (`pack_mac_rhs` + transpose)
        reads the 1.7 GB 152-IR tensor at an F-plane stride per element —
        measured minutes of host time on this 1-core box; the four
        write-contiguous plane assignments below share the F-contiguous
        minor axis with their source and take seconds."""
        from tpu_audio.engine.fmajor import (_pad_p, double_reversed,
                                             pack_mac_rhs)

        head_dbl = double_reversed(_pad_p(head_spec, 2, self.pp1), 2)
        head_rhs2 = pack_mac_rhs(head_dbl, 2 * self.pp1)

        tail_dbl = double_reversed(_pad_p(tail_spec, 2, self.pp2), 2)
        k, o, p2, f = tail_dbl.shape              # [K, O, 2Pp2, F2] complex
        br = np.transpose(tail_dbl.real.astype(np.float32), (2, 0, 1, 3))
        bi = np.transpose(tail_dbl.imag.astype(np.float32), (2, 0, 1, 3))
        rhs = np.empty((2, p2, k, o, 2, f), np.float32)
        rhs[0, ..., 0, :] = br                    # [2Pp2, K, O, F2]
        rhs[0, ..., 1, :] = bi
        rhs[1, ..., 0, :] = -bi
        rhs[1, ..., 1, :] = br
        return head_rhs2, rhs.reshape(2, p2, k * o * 2, f)

    def prepare_bank(self, bank, cache_dir=None,
                     device=True) -> CascadeBank:
        """IRBank (time-domain) -> device CascadeBank: the head takes the
        IRs' first 2*B2 samples at block granularity, the tail the rest at
        B2 granularity (reference `prepare` builds one monolithic spectrum,
        src/conv.cu:207-253; here two partition resolutions). cache_dir
        enables the bank's content-addressed spectra disk cache.

        device=False returns HOST (numpy) leaves instead of uploading."""
        # NOTE the tail spectra are computed at the bank's natural length
        # and truncated to tail_parts below — at the default geometry
        # (partitions == bank.max_partitions) nothing is wasted, and
        # passing max_partitions=self.tail_parts would change the spectra
        # cache key (invalidating every existing entry) to save host FFTs
        # only in the rare capped-partitions configuration
        if cache_dir:
            head_spec = bank.cached_partitioned_spectra(
                self.block, cache_dir, max_partitions=self.head_parts)
            tail_spec = bank.cached_partitioned_spectra(
                self.b2, cache_dir, offset=2 * self.b2)
        else:
            head_spec = bank.partitioned_spectra(
                self.block, max_partitions=self.head_parts)
            tail_spec = bank.partitioned_spectra(self.b2,
                                                 offset=2 * self.b2)
        if tail_spec.shape[2] < self.tail_parts:
            pad = self.tail_parts - tail_spec.shape[2]
            tail_spec = np.pad(tail_spec, ((0, 0), (0, 0), (0, pad), (0, 0)))
        tail_spec = tail_spec[:, :, : self.tail_parts]
        if self.num_irs is not None and head_spec.shape[0] != self.num_irs:
            raise ValueError(f"bank has {head_spec.shape[0]} IRs, engine "
                             f"was built for num_irs={self.num_irs}")
        self.num_irs = head_spec.shape[0]
        head_rhs2 = tail_rhs2 = None
        base = None
        if cache_dir:
            # raw .npy pair, NOT .npz (utils/diskcache.py: zipfile reads
            # multi-GB entries at ~5 MB/s on this 1-core box; mmap'd .npy
            # hands jnp.asarray the pages straight from the file cache)
            from tpu_audio.utils import diskcache
            from tpu_audio.utils.log import Log
            base = "cascpack_" + diskcache.content_key(
                "cascade-pack", (self.pp1, self.pp2, head_spec.shape,
                                 tail_spec.shape), head_spec, tail_spec)
            hit = diskcache.load(cache_dir, base, ("head", "tail"))
            if hit is not None:
                Log.info("cascade", "packed-bank cache hit: %s/%s*",
                         cache_dir, base)
                head_rhs2, tail_rhs2 = hit["head"], hit["tail"]
        if head_rhs2 is None:
            head_rhs2, tail_rhs2 = self._pack_bank_host(head_spec, tail_spec)
            if base is not None:
                from tpu_audio.utils import diskcache
                diskcache.store(cache_dir, base,
                                {"head": head_rhs2, "tail": tail_rhs2})
        if not device:
            # numpy .astype: jnp.bfloat16 is ml_dtypes-backed, so host
            # leaves can carry the MAC dtype exactly. copy=False keeps
            # the mmap-backed disk-cache arrays zero-copy when the dtype
            # already matches (the ~2 GB sel152 bank would otherwise be
            # materialized in RAM just to be re-read once for upload)
            return CascadeBank(
                head_rhs2=np.asarray(head_rhs2).astype(self.mac_dtype,
                                                       copy=False),
                tail_rhs2=np.asarray(tail_rhs2).astype(self.mac_dtype,
                                                       copy=False))
        return CascadeBank(
            head_rhs2=jnp.asarray(head_rhs2, self.mac_dtype),
            tail_rhs2=jnp.asarray(tail_rhs2, self.mac_dtype))

    def update_bank_slot(self, bank: CascadeBank, slot, ir) -> CascadeBank:
        """Replace ONE IR slot of a device bank (working-set residency,
        runtime/working_set.py): the time-domain IR [O, L] is partitioned
        at both stage resolutions exactly like prepare_bank and written
        into the slot's columns with dynamic-update-slices (one jit, slot
        index traced)."""
        if self.mac_strategy != "allk":
            raise ValueError("working-set residency pairs with the 'allk' "
                             "strategy (the 'selected' MAC reads per-voice "
                             "materialized rhs, not bank slots)")
        from tpu_audio.ops.partition import partition_spectra

        ir = np.asarray(ir, np.float32)

        def spec(offset, block, parts):
            sp = partition_spectra(ir[..., offset:] if offset else ir,
                                   block, max_partitions=parts)
            out = np.zeros((1, ir.shape[0], parts, block + 1), np.complex64)
            out[0, :, : sp.shape[1]] = sp
            return out

        head_rhs2, tail_rhs2 = self._pack_bank_host(
            spec(0, self.block, self.head_parts),
            spec(2 * self.b2, self.b2, self.tail_parts))
        from tpu_audio.utils.jitcache import instance_cached

        def upd(bank, head_p, tail_p, k):
            return replace(
                bank,
                head_rhs2=jax.lax.dynamic_update_slice(
                    bank.head_rhs2, head_p, (0, 0, 0, k * 4)),
                tail_rhs2=jax.lax.dynamic_update_slice(
                    bank.tail_rhs2, tail_p, (0, 0, k * 4, 0)))

        fn = instance_cached(self, "update_bank_slot", lambda: jax.jit(upd))
        return fn(bank, jnp.asarray(head_rhs2, self.mac_dtype),
                  jnp.asarray(tail_rhs2, self.mac_dtype), jnp.int32(slot))

    # -- state ---------------------------------------------------------------------

    def _sel_shapes(self):
        """(head, tail) shapes of the 'selected' strategy's per-voice rhs
        leaves; size-1 placeholders under 'allk'."""
        if self.mac_strategy != "selected":
            return (1,) * 6, (1,) * 7
        v, m = self.num_voices, self.ratio
        return ((self.f1, v, 2, 2, 2 * self.pp1, 4),
                (m, v // m, 2, 2, 2 * self.pp2, 4, self.f2))

    def init_state(self) -> CascadeState:
        if self.num_irs is None:
            raise ValueError("pass num_irs= or call prepare_bank before "
                             "init_state (base_g is bank-sized)")
        from tpu_audio.utils.jitcache import instance_cached

        v, b, m = self.num_voices, self.block, self.ratio
        vg = v // m
        kg = self.num_irs if self.mac_strategy == "allk" else 1
        hsh, tsh = self._sel_shapes()
        return instance_cached(self, "init_state", lambda: jax.jit(
            lambda: CascadeState(
            t=jnp.zeros((), jnp.int32),
            fdl1=jnp.zeros((self.f1, v * 2, 2, self.pp1), self.mac_dtype),
            prev_in=jnp.zeros((v, 2, b), jnp.float32),
            inbuf2=jnp.zeros((m, vg, 2, 4 * m, b), jnp.float32),
            fdl2=jnp.zeros((m, vg, 2, 2, self.pp2, self.f2), self.mac_dtype),
            wet_ring=jnp.zeros((v, self.head_slots, 2, b), jnp.float32),
            tail_ring=jnp.zeros((m, vg, 2, 2, self.ring_slots, b),
                                jnp.float32),
            coef_a=jnp.zeros((v, 2), jnp.float32),
            coef_c=jnp.zeros((v, 2), jnp.float32),
            base_g=jnp.zeros((v, 2, kg), jnp.float32),
            base_pure=jnp.ones((v, 2), jnp.bool_),
            sel_head=jnp.zeros(hsh, self.mac_dtype),
            sel_tail=jnp.zeros(tsh, self.mac_dtype),
            base_head=jnp.zeros(hsh, self.mac_dtype),
            base_tail=jnp.zeros(tsh, self.mac_dtype),
            # pd_q=pd_m=0 is safe even when params.predelay != 0: the
            # first step's retime then rolls an all-zero ring (a numeric
            # no-op) and the margin converges to q in one block
            pd_q=jnp.zeros((v,), jnp.int32),
            pd_m=jnp.zeros((v,), jnp.int32),
        )))()

    def init_converged(self, bank: CascadeBank, params: VoiceParams
                       ) -> CascadeState:
        from tpu_audio.utils.jitcache import instance_cached

        state = self.init_state()
        coefc = instance_cached(self, "init_coefc", lambda: jax.jit(
            lambda w: w.astype(jnp.float32) + 0.0))
        state = replace(state, coef_c=coefc(params.wet))
        if self.mac_strategy == "selected":
            gh = instance_cached(self, "init_gather_head",
                                 lambda: jax.jit(self._gather_head))
            gt = instance_cached(self, "init_gather_tail",
                                 lambda: jax.jit(self._gather_tail))
            state = replace(state, sel_head=gh(bank, params.select),
                            sel_tail=gt(bank, params.select))
        return state

    def _gather_head(self, bank: CascadeBank, select: jax.Array) -> jax.Array:
        """Per-voice head rhs [F1, V, I, d, 2*P1p, OD] gathered from the
        all-K tensor by each (voice, channel)'s selection."""
        k = bank.num_irs
        r = bank.head_rhs2.reshape(self.f1, 2, 2 * self.pp1, k, 4)
        g = jnp.take(r, select, axis=3)       # [F1, d, 2P1p, V, I, OD]
        return jnp.transpose(g, (0, 3, 4, 1, 2, 5)).astype(self.mac_dtype)

    def _gather_tail(self, bank: CascadeBank, select: jax.Array) -> jax.Array:
        """Per-voice tail rhs [M, Vg, I, d, 2*P2p, OD, F2] (group-major:
        voice j*ratio + g lives at [g, j], matching the state leaves)."""
        k = bank.num_irs
        m = self.ratio
        vg = self.num_voices // m
        r = bank.tail_rhs2.reshape(2, 2 * self.pp2, k, 4, self.f2)
        g = jnp.take(r, select, axis=2)       # [d, 2P2p, V, I, OD, F2]
        g = jnp.transpose(g, (2, 3, 0, 1, 4, 5))  # [V, I, d, 2P2p, OD, F2]
        g = g.reshape((vg, m) + g.shape[1:])
        return jnp.swapaxes(g, 0, 1).astype(self.mac_dtype)

    # -- shared pieces ---------------------------------------------------------------

    def _wet_scale(self, params: VoiceParams) -> jax.Array:
        return wet_scale(params)                          # [V, I, O]

    def _allk_mac(self, fdl, rhs2, w, f, pp, nrows):
        """Windowed doubled-reversed ring MAC (fmajor.py allk):
        [F, rows, d, Pp] x [F, d, Pp, KOD] -> [F, rows/2, I, K, O, d].

        The (d, q) pair stays two separate contracting dims of ONE
        dot_general — reshaping fdl to [F, rows, 2Pp] first materializes
        the whole delay line as a fusion output at large voice counts
        (134 MB/block extra at 1024v, found via memory_analysis)."""
        rhs = jax.lax.dynamic_slice_in_dim(rhs2, pp - w, pp, axis=2)
        m = jnp.einsum("fvdq,fdqk->fvk", fdl, rhs,
                       precision=self._mac_prec,
                       preferred_element_type=jnp.float32)
        k = rhs2.shape[-1] // 4
        return m.reshape(f, nrows // 2, 2, k, 2, 2)      # [F,V,I,K,O,d]

    def _project_coefs(self, a, c, params, steps):
        """Trajectories a_n, c_n for n = 0..steps-1 future blocks, from the
        CURRENT (already-updated) coefficients — the slew recursion
        (reference src/conv.cu:15-32, two scalars) is deterministic given
        vsteps, so a tail chunk can carry per-output-block fade weights."""
        wet = params.wet.astype(jnp.float32)

        def body(carry, n):
            av, cv = carry
            r = 1.0 / (jnp.maximum(
                params.vsteps.astype(jnp.float32) - n, 0.0) + 5.0)
            av2 = av * (1.0 - r)
            cv2 = cv * (1.0 - r) + wet * r
            return (av2, cv2), (av, cv)

        (_, _), (a_traj, c_traj) = jax.lax.scan(
            body, (a, c), jnp.arange(1, steps + 1, dtype=jnp.float32))
        return (jnp.moveaxis(a_traj, 0, -1),            # [V, 2, steps]
                jnp.moveaxis(c_traj, 0, -1))

    # -- the step -------------------------------------------------------------------

    def _step(self, state: CascadeState, bank: CascadeBank,
              params: VoiceParams, x: jax.Array, with_base: bool,
              stages: tuple = ("head", "tail")):
        """One block. `stages` is a DIAGNOSTIC trace-time filter (perf
        triage only — examples/probe_cascade_hv.py --stages): dropping
        "head" or "tail" skips that stage's compute and carries its state
        through unchanged, so stage costs can be timed in isolation on
        the real code path. Production callers never pass it."""
        b, v, m = self.block, self.num_voices, self.ratio
        vg = v // m
        t = state.t
        pd = params.predelay[:, 0]          # channel-0 quirk (conv.cu:411)
        q = pd // b
        r_pd = pd % b

        # coefficient slew (this block)
        r = 1.0 / (params.vsteps.astype(jnp.float32) + 5.0)
        a = state.coef_a * (1.0 - r)
        c = state.coef_c * (1.0 - r) + params.wet * r
        scale = self._wet_scale(params)                   # [V, I, O]

        # MODULAR rings: slot for content due at block t+D is (t+D) mod NB.
        # No per-block shift pass — the emit slot is read then zeroed in
        # the same fused expression (the concat-shift form lowered to
        # multiple full-ring pad/slice/copy passes at large voice counts)
        nb = self.ring_slots
        nh = self.head_slots
        emit = jax.lax.rem(t, jnp.int32(nb))
        emit_h = jax.lax.rem(t, jnp.int32(nh))
        slots = jnp.arange(nb)[None, :]
        slots_h = jnp.arange(nh)[None, :]

        # ---- head stage: exact fmajor allk ring block ----
        fdl1, ring, head_now = self._head_stage(
            state, bank, params, x, with_base, t, a, c, scale, q, r_pd,
            nh, emit_h, slots_h) if "head" in stages else (
            state.fdl1, state.wet_ring, jnp.zeros((v, 2, b), jnp.float32))

        # ---- tail stage: one voice group's chunk ----
        if "tail" not in stages:                          # diagnostics only
            out = add_dry(jnp.clip(head_now, -1.0, 1.0), x, params)
            t_next = (jax.lax.rem(t + 1, jnp.int32(self.t_modulus))
                      if self.t_modulus else t + 1)
            return replace(state, t=t_next, fdl1=fdl1, prev_in=x,
                           wet_ring=ring, coef_a=a, coef_c=c, pd_q=q,
                           pd_m=jnp.maximum(state.pd_m - 1, q)), out
        return self._tail_stage(state, bank, params, x, with_base, t, a, c,
                                scale, q, r_pd, nb, emit, slots, fdl1, ring,
                                head_now)

    def _head_stage(self, state, bank, params, x, with_base, t, a, c,
                    scale, q, r_pd, nh, emit_h, slots_h):
        b, v = self.block, self.num_voices
        seg = jnp.concatenate([state.prev_in, x], axis=-1)
        spec1 = self.xf1.rfft(seg)                        # [V, 2, F1]
        xn1 = jnp.stack([jnp.real(spec1), jnp.imag(spec1)], axis=-1)
        xn1 = jnp.transpose(xn1.reshape(v * 2, self.f1, 2),
                            (1, 0, 2))[..., None].astype(self.mac_dtype)
        w1 = jax.lax.rem(t, jnp.int32(self.pp1))
        fdl1 = jax.lax.dynamic_update_slice(state.fdl1, xn1, (0, 0, 0, w1))
        if self.mac_strategy == "selected":
            # per-voice MAC against the materialized selected rhs (and the
            # materialized base rhs during fades) — K-independent cost
            fb = fdl1.reshape(self.f1, v, 2, 2, self.pp1)

            def pv_head(rhs2v):                   # [F1, V, I, d, 2P1p, OD]
                wv = jax.lax.dynamic_slice_in_dim(
                    rhs2v, self.pp1 - w1, self.pp1, axis=4)
                mv = jnp.sum(
                    fb[..., None] * wv.astype(self.mac_dtype),
                    axis=(3, 4), dtype=jnp.float32)        # [F1, V, I, OD]
                return mv.reshape(self.f1, v, 2, 2, 2)     # [F1,V,I,O,d]

            y = jnp.einsum("fviod,vio->fvod", pv_head(state.sel_head),
                           c[..., None] * scale, precision=MIX_PRECISION)
            if with_base:
                y = y + jnp.einsum("fviod,vio->fvod",
                                   pv_head(state.base_head),
                                   a[..., None] * scale, precision=MIX_PRECISION)
        else:
            m1 = self._allk_mac(fdl1, bank.head_rhs2, w1, self.f1, self.pp1,
                                v * 2)                    # [F1,V,I,K,O,d]
            sel = params.select[None, :, :, None, None, None]
            y = jnp.einsum("fviod,vio->fvod",
                           jnp.take_along_axis(m1, sel, axis=3)[:, :, :, 0],
                           c[..., None] * scale, precision=MIX_PRECISION)
            if with_base:
                y = y + jnp.einsum("fvikod,vik,vio->fvod", m1, state.base_g,
                                   a[..., None] * scale, precision=MIX_PRECISION)

        # head predelay: sub-block part as a spectral phase ramp, block
        # part as a one-hot slot scatter (fmajor.py _finish)
        n1 = 2 * b
        ang = (2.0 * jnp.pi / n1) * (
            jnp.arange(self.f1, dtype=jnp.float32)[:, None]
            * r_pd.astype(jnp.float32)[None, :])          # [F1, V]
        cs, sn = jnp.cos(ang)[..., None], jnp.sin(ang)[..., None]
        spec = jax.lax.complex(y[..., 0] * cs + y[..., 1] * sn,
                               y[..., 1] * cs - y[..., 0] * sn)
        ys1 = self.xf1.irfft(jnp.transpose(spec, (1, 2, 0)))  # [V, O, 2B]
        offs = jnp.arange(b)[None, None, :]
        head_main = jnp.where(offs >= r_pd[:, None, None], ys1[..., b:], 0.0)
        head_tail = jnp.where(offs < r_pd[:, None, None], ys1[..., :b], 0.0)

        if self.predelay_side == "read":
            # FIFO: slot t holds tail_{t-1} + main_t (SMALL writes; slot
            # t+1 is cleared then re-accumulated, its pre-clear content
            # provably dead, NH = maxq + 2); the per-voice delay applies
            # at EMIT via a one-hot gather — no full-ring write pass.
            s0 = jax.lax.rem(t, jnp.int32(nh))
            s1 = jax.lax.rem(t + 1, jnp.int32(nh))
            # -- predelay-EDIT retime (exact write-side semantics) --------
            # Steady read-side is exact at constant predelay; an edit
            # q_prev -> q would re-time ALL buffered wet (the old
            # skip/repeat deviation). Fix: on the (rare) edit block, roll
            # each edited voice's ring FORWARD by delta = q_prev - q so
            # content written at time W keeps its absolute emit time
            # under the new read rule t - q — matching the reference's
            # residual buffer, where old wet keeps its old delay
            # (src/conv.cu:89-100). The roll is a full-ring gather, the
            # cost write-side pays EVERY block — paid here only on edit
            # blocks via lax.cond (the identity branch aliases the
            # donated ring). Liveness bookkeeping: content at slot s is
            # LIVE iff its offset within the current regime's window
            # origin t - q_prev is <= m, where m = pd_m is the live
            # MARGIN (highest buffered emit time minus t). In steady
            # state m == q; after a DECREASE m stays at the old q for
            # delta blocks, during which the live window extends into
            # FUTURE slots (up to t + delta) — the roll mask must keep
            # them (an age <= q_prev mask killed chained edits) and the
            # spill-slot write below must ACCUMULATE instead of clearing
            # while m > q (the old unconditional s1 clear destroyed
            # re-timed wet emitting at t+2.. — found via session drive,
            # 2026-08-20; the old tests were blind because MAXPD=64/B=32
            # makes q=2 reachable only at r_pd=0, whose spill is zero).
            delta = state.pd_q - q                        # [V]
            m_prev = state.pd_m

            def _retime(r):
                src = jax.lax.rem(
                    slots_h - delta[:, None] + jnp.int32(2 * nh),
                    jnp.int32(nh))                        # [V, NH]
                # reduce t mod nh BEFORE subtracting: t itself is only
                # bounded by t_modulus, so `src - (t - pd_q) + 4*nh` goes
                # negative once t > ~4*nh and lax.rem (truncating)
                # returns a NEGATIVE off that always satisfies the live
                # test — the mask collapsed to all-live and rolled stale
                # already-emitted wet into live slots for any edit after
                # ~0.8 s of session (review repro 2026-08-20, maxdiff
                # 0.31 at t=60; t=12 edits were bit-exact, which is why
                # the first round of tests passed). origin and src are
                # both in [0, nh), so off's argument stays positive.
                origin = jax.lax.rem(
                    t - state.pd_q[:, None] + jnp.int32(2 * nh),
                    jnp.int32(nh))
                off = jax.lax.rem(src - origin + jnp.int32(nh),
                                  jnp.int32(nh))
                live = (off <= m_prev[:, None])[:, :, None, None]
                rolled = jnp.take_along_axis(r, src[:, :, None, None],
                                             axis=1)
                return jnp.where(live, rolled, 0.0)

            ring0 = jax.lax.cond(jnp.any(delta != 0), _retime,
                                 lambda r: r, state.wet_ring)
            cur = jax.lax.dynamic_slice_in_dim(ring0, s0, 1, axis=1)[:, 0]
            # + nh keeps the argument non-negative (lax.rem truncates):
            # t - q >= -(nh - 2) at startup, and t_modulus % nh == 0 keeps
            # the index continuous across the counter wrap. The per-voice
            # emit is a masked reduce over the slot axis (an einsum
            # against the one-hot would lower to V tiny [1,NH]x[NH,2B]
            # matvecs). The reduce reads
            # the PRE-slot-write ring (at steady blocks the cond identity
            # aliases the donated argument, so no read-after-write hazard
            # with the slot writes below); the only slot whose
            # post-update content could differ is s0, read by q == 0
            # voices — corrected explicitly with this block's head_main.
            emit_slot = jax.lax.rem(t - q + jnp.int32(nh), jnp.int32(nh))
            mask = (slots_h == emit_slot[:, None])[:, :, None, None]
            head_now = jnp.sum(jnp.where(mask, ring0, 0.0), axis=1)
            head_now = head_now + jnp.where(
                (q == 0)[:, None, None], head_main, 0.0)
            ring = jax.lax.dynamic_update_slice(
                ring0, (cur + head_main)[:, None], (0, s0, 0, 0))
            # spill slot: OVERWRITE in steady state (m == q: slot t+1
            # holds provably-dead content, the clear that keeps the FIFO
            # from re-emitting stale wet) but ACCUMULATE while m > q
            # (slot t+1 then holds LIVE re-timed wet from a predelay
            # decrease, emitting at t+1+q)
            cur1 = jax.lax.dynamic_slice_in_dim(ring, s1, 1, axis=1)[:, 0]
            keep1 = (m_prev > q)[:, None, None]
            ring = jax.lax.dynamic_update_slice(
                ring, (jnp.where(keep1, cur1, 0.0) + head_tail)[:, None],
                (0, s1, 0, 0))
        else:
            oh_q = (slots_h == jax.lax.rem(t + q, jnp.int32(nh))[:, None]
                    ).astype(jnp.float32)
            oh_q1 = (slots_h == jax.lax.rem(t + q + 1, jnp.int32(nh))[:, None]
                     ).astype(jnp.float32)
            ring = (state.wet_ring
                    + jnp.einsum("vn,vob->vnob", oh_q, head_main,
                                 precision=MIX_PRECISION)
                    + jnp.einsum("vn,vob->vnob", oh_q1, head_tail,
                                 precision=MIX_PRECISION))
            head_now = jax.lax.dynamic_slice_in_dim(
                ring, emit_h, 1, axis=1)[:, 0]
            ring = ring * (jnp.arange(nh) != emit_h
                           ).astype(jnp.float32)[None, :, None, None]
        return fdl1, ring, head_now

    def _tail_stage(self, state, bank, params, x, with_base, t, a, c,
                    scale, q, r_pd, nb, emit, slots, fdl1, ring, head_now):
        b, v, m = self.block, self.num_voices, self.ratio
        vg = v // m
        # STRIDED groups (voice i -> group i % m): slice group g as axis 1
        # of a [vg, m, ...] reshape; contiguous voice sharding then keeps
        # each shard's local schedule identical to the global one
        g = jax.lax.rem(t, jnp.int32(m))

        def group(arr):
            """[V, ...] -> group g's [vg, ...] via the strided reshape."""
            r = jax.lax.dynamic_slice(
                arr.reshape((vg, m) + arr.shape[1:]),
                (0, g) + (0,) * (arr.ndim - 1),
                (vg, 1) + arr.shape[1:])
            return r.reshape((vg,) + arr.shape[1:])

        s2 = jax.lax.rem(t, jnp.int32(2 * m))
        # voice i = j*m + g lives at [g, j]: swap the strided reshape
        xg = jnp.swapaxes(x.reshape(vg, m, 2, 1, b), 0, 1)
        inbuf2 = jax.lax.dynamic_update_slice(
            state.inbuf2, xg, (0, 0, 0, s2, 0))
        inbuf2 = jax.lax.dynamic_update_slice(
            inbuf2, xg, (0, 0, 0, s2 + jnp.int32(2 * m), 0))
        seg2 = jax.lax.dynamic_slice(
            inbuf2,
            (g, 0, 0, jax.lax.rem(t + 1, jnp.int32(2 * m)), 0),
            (1, vg, 2, 2 * m, b)).reshape(vg, 2, 2 * self.b2)
        spec2 = self.xf2.rfft(seg2)                       # [Vg, 2, F2]
        xn2 = jnp.stack([jnp.real(spec2), jnp.imag(spec2)],
                        axis=2).astype(self.mac_dtype)    # [Vg, I, d, F2]
        w2 = jax.lax.rem(t // jnp.int32(m), jnp.int32(self.pp2))
        # the group axis is explicit in the state leaf: slice/update land
        # in place on the donated buffer (see CascadeState docstring)
        xn2c = xn2.reshape(1, vg, 2, 2, 1, self.f2)
        fdl2 = jax.lax.dynamic_update_slice(state.fdl2, xn2c,
                                            (g, 0, 0, 0, w2, 0))
        # MAC from the PRE-update delay line plus an explicit correction
        # for the fresh column: reading the post-update buffer would put a
        # read-after-write hazard between the in-place slot write and the
        # group-wide reduce, which forces XLA to materialize the 200 MB
        # group slice; as a pure read of the donated parameter the slice
        # fuses straight into the reduce.
        old_g = jax.lax.dynamic_slice(
            state.fdl2, (g, 0, 0, 0, 0, 0), (1, vg, 2, 2, self.pp2, self.f2)
        ).reshape(vg, 2, 2, self.pp2, self.f2)
        old_col = jax.lax.dynamic_slice(
            state.fdl2, (g, 0, 0, 0, w2, 0), (1, vg, 2, 2, 1, self.f2)
        ).reshape(vg, 2, 2, 1, self.f2)
        delta = xn2c.reshape(vg, 2, 2, 1, self.f2) - old_col
        scale_g = group(scale)
        if self.mac_strategy == "selected":
            # per-voice MAC against the CURRENT GROUP's slice of the
            # materialized selected rhs (and base rhs during fades):
            # K-independent cost — the large bank is touched only at
            # gather time (collapse / re-select)
            def pv_tail(rhs_leaf):
                rv = jax.lax.dynamic_slice(
                    rhs_leaf, (g, 0, 0, 0, 0, 0, 0),
                    (1, vg, 2, 2, 2 * self.pp2, 4, self.f2)).reshape(
                    vg, 2, 2, 2 * self.pp2, 4, self.f2)
                wv = jax.lax.dynamic_slice_in_dim(
                    rv, self.pp2 - w2, self.pp2, axis=3)
                mm = jnp.sum(old_g[:, :, :, :, None, :] * wv,
                             axis=(2, 3), dtype=jnp.float32)  # [Vg,I,OD,F2]
                colv = rv[:, :, :, self.pp2: self.pp2 + 1]
                mm = mm + jnp.sum(delta[:, :, :, :, None, :] * colv,
                                  axis=(2, 3), dtype=jnp.float32)
                return mm.reshape(vg, 2, 2, 2, self.f2)       # [Vg,I,O,d,F2]

            tail_specs = [pv_tail(state.sel_tail) * scale_g[..., None, None]]
            if with_base:
                tail_specs.append(
                    pv_tail(state.base_tail) * scale_g[..., None, None])
        else:
            tail_specs = self._tail_mac_allk(
                state, bank, params, old_g, delta, w2, vg, group, scale_g,
                with_base)
        return self._tail_finish(
            state, params, x, with_base, t, a, c, q, r_pd, nb, emit, slots,
            fdl1, ring, head_now, group, inbuf2, fdl2, tail_specs)

    def _tail_mac_allk(self, state, bank, params, old_g, delta, w2, vg,
                       group, scale_g, with_base):
        # tail MAC: contract the small (d, q) axes, either as a fused
        # broadcast-multiply + reduce or as a dot_general batched over F2
        # — chosen by self.tail_mac (see __init__)
        rhs = jax.lax.dynamic_slice_in_dim(
            bank.tail_rhs2, self.pp2 - w2, self.pp2, axis=1)
        k4 = bank.tail_rhs2.shape[2]
        # window column w2 pairs the fresh slot with partition 0; in the
        # doubled-reversed tensor that's the STATIC index pp2
        rhs_col = bank.tail_rhs2[:, self.pp2: self.pp2 + 1]
        if self.tail_mac == "dot":
            # dot form (large Vg): batch F2, contract (d, q) as two dot
            # dims — [Vg,I,d,q,F2] x [d,q,K4,F2] -> [F2,Vg,I,K4], then
            # transpose back to the engine's frequency-minor layout.
            dn = (((2, 3), (0, 1)), ((4,), (3,)))
            m2 = jax.lax.dot_general(
                old_g, rhs, dn, precision=self._mac_prec,
                preferred_element_type=jnp.float32)       # [F2,Vg,I,K4]
            m2 = m2 + jax.lax.dot_general(
                delta, rhs_col, dn, precision=self._mac_prec,
                preferred_element_type=jnp.float32)
            m2 = jnp.transpose(m2, (1, 2, 3, 0))          # [Vg, I, K4, F2]
        else:
            # reduce form (small Vg): products in mac_dtype, accumulation
            # forced to f32 via the reduce dtype — explicit astype on the
            # 100+ MB operands materializes an upcast copy of the whole
            # group slice in the bf16 configuration
            m2 = jnp.sum(
                old_g[:, :, :, :, None, :]                # [Vg,I,d,q,1,F2]
                * rhs[None, None],                        # [1,1,d,q,K4,F2]
                axis=(2, 3), dtype=jnp.float32)           # [Vg, I, K4, F2]
            m2 = m2 + jnp.sum(
                delta[:, :, :, :, None, :] * rhs_col[None, None],
                axis=(2, 3), dtype=jnp.float32)
        m2 = m2.reshape(vg, 2, k4 // 4, 2, 2, self.f2)    # [Vg,I,K,O,d,F2]

        sel_g = group(params.select)
        y2s = jnp.take_along_axis(
            m2, sel_g[:, :, None, None, None, None], axis=2)[:, :, 0]
        tail_specs = [y2s * scale_g[..., None, None]]     # [Vg,I,O,d,F2]
        if with_base:
            bg_g = group(state.base_g)
            tail_specs.append(
                jnp.sum(m2 * bg_g[:, :, :, None, None, None], axis=2)
                * scale_g[..., None, None])
        return tail_specs

    def _tail_finish(self, state, params, x, with_base, t, a, c, q, r_pd,
                     nb, emit, slots, fdl1, ring, head_now, group, inbuf2,
                     fdl2, tail_specs):
        b, v, m = self.block, self.num_voices, self.ratio
        vg = v // m
        g = jax.lax.rem(t, jnp.int32(m))
        # tail predelay sub-block phase ramp (r_pd << B2 guard: safe)
        n2 = 2 * self.b2
        rg = group(r_pd)
        ang2 = (2.0 * jnp.pi / n2) * (
            rg.astype(jnp.float32)[:, None]
            * jnp.arange(self.f2, dtype=jnp.float32)[None, :])  # [Vg, F2]
        cs2, sn2 = jnp.cos(ang2)[:, None, None], jnp.sin(ang2)[:, None, None]

        def tail_pieces(yt):
            """[Vg,I,O,d,F2] -> r-shifted pieces [Vg, I, O, ratio+1, B]."""
            sp = jax.lax.complex(yt[..., 0, :] * cs2 + yt[..., 1, :] * sn2,
                                 yt[..., 1, :] * cs2 - yt[..., 0, :] * sn2)
            ys2 = self.xf2.irfft(sp)
            # valid (shifted) window: main B2 samples + B-sample spill
            offs2 = jnp.arange(self.b2)[None, None, None, :]
            offsb = jnp.arange(b)[None, None, None, :]
            mainw = jnp.where(offs2 >= rg[:, None, None, None],
                              ys2[..., self.b2:], 0.0)
            spill = jnp.where(offsb < rg[:, None, None, None],
                              ys2[..., :b], 0.0)
            pieces = jnp.concatenate(
                [mainw.reshape(vg, 2, 2, m, b),
                 spill[..., None, :]], axis=3)            # [Vg,I,O,M+1,B]
            return pieces

        # fade weights at each piece's UNIFORM-ENGINE compute block
        # t + tail_slot0 + k (predelay-independent, like the head's
        # scatter, whose values also carry compute-time coefficients)
        a_proj, c_proj = self._project_coefs(a, c, params,
                                             self.tail_slot0 + m + 1)
        a_proj = a_proj[..., self.tail_slot0:]            # [V, 2, M+1]
        c_proj = c_proj[..., self.tail_slot0:]
        cg = group(c_proj)
        weighted = tail_pieces(tail_specs[0]) * cg[:, :, None, :, None]
        if with_base:
            ag = group(a_proj)
            weighted = (weighted
                        + tail_pieces(tail_specs[1]) * ag[:, :, None, :, None])

        # scatter into the group's tail-ring rows at MODULAR slot
        # (t + tail_slot0 + q + k) mod NB, keeping the input-channel axis
        # resolved; only group g's rows are ever written — the other
        # ratio-1 row groups are untouched this block
        qg = group(q)
        ks = jnp.arange(m + 1)[None, :, None]
        oh_qk = (slots[None] == jax.lax.rem(
            t + qg[:, None, None] + jnp.int32(self.tail_slot0) + ks,
            jnp.int32(nb))).astype(jnp.float32)           # [Vg, M+1, NB]

        # ---- emit slot (t mod NB): clamp wet (head + tail), add dry
        # (reference kernel order, src/conv.cu:411-427). The emit reads
        # the PRE-scatter ring: the scatter lands at offsets
        # tail_slot0 + q + k in [tail_slot0 + q, tail_slot0 + q + M],
        # all >= tail_slot0 >= ratio+1 > 0 and <= NB - 3 < NB, so it can
        # never alias slot t — reading the donated argument directly
        # keeps the whole chain hazard-free and in place. ----
        tail_now = jnp.swapaxes(
            jax.lax.dynamic_slice_in_dim(state.tail_ring, emit, 1, axis=4
                                         )[:, :, :, :, 0].sum(axis=2),
            0, 1).reshape(v, 2, b)
        tring_g = jax.lax.dynamic_slice(
            state.tail_ring, (g, 0, 0, 0, 0, 0), (1, vg, 2, 2, nb, b)
        ).reshape(vg, 2, 2, nb, b)
        tring_g = tring_g + jnp.einsum("vkn,viokb->vionb", oh_qk, weighted,
                                       precision=MIX_PRECISION)
        tring = jax.lax.dynamic_update_slice(
            state.tail_ring, tring_g.reshape(1, vg, 2, 2, nb, b),
            (g, 0, 0, 0, 0, 0))
        # zero the emitted slot (small in-place write) so it can
        # re-accumulate; ordered after the group write-back, which
        # rewrites group g's emit-slot row with its (unchanged) old value
        tring = jax.lax.dynamic_update_slice(
            tring, jnp.zeros((m, vg, 2, 2, 1, b), jnp.float32),
            (0, 0, 0, 0, emit, 0))
        out = jnp.clip(head_now + tail_now, -1.0, 1.0)
        out = add_dry(out, x, params)

        t_next = (jax.lax.rem(t + 1, jnp.int32(self.t_modulus))
                  if self.t_modulus else t + 1)
        # pd_q stores the SAME q the head-stage retime used this block
        # (threaded from _step) — re-deriving it here from params would
        # desynchronize the edit-detection basis if a caller ever passed
        # a transformed q
        return replace(state, t=t_next, fdl1=fdl1, prev_in=x, inbuf2=inbuf2,
                       fdl2=fdl2, wet_ring=ring, tail_ring=tring,
                       coef_a=a, coef_c=c, pd_q=q,
                       pd_m=jnp.maximum(state.pd_m - 1, q)), out

    # -- coef-engine interface (StreamSession) ---------------------------------------

    def step_coef(self, state, bank, params, x, with_base: bool = True,
                  indexed_base: bool = False):
        if with_base and not indexed_base and self.mac_strategy != "selected":
            raise ValueError(
                "the 'allk' cascade is span-only (no materialized fade "
                "snapshot); fades ride step_coef_indexed")
        return self._step(state, bank, params, x, with_base=with_base)

    def step_coef_steady(self, state, bank, params, x):
        return self._step(state, bank, params, x, with_base=False)

    def step_coef_indexed(self, state, bank, params, x):
        if self.mac_strategy != "allk":
            raise ValueError("indexed fade requires the 'allk' MAC strategy "
                             "('selected' fades read the materialized base "
                             "rhs via step_coef)")
        return self._step(state, bank, params, x, with_base=True)

    def step(self, state, bank, params, x):
        return self._step(state, bank, params, x, with_base=True)

    def collapse(self, state: CascadeState, bank: CascadeBank,
                 old_select: jax.Array, changed: jax.Array,
                 new_select: jax.Array | None = None,
                 params: VoiceParams | None = None) -> CascadeState:
        """'selected' strategy re-base (fmajor.collapse semantics): the MAC
        is linear in its rhs, so the affine snapshot materializes directly
        on the rhs tensors — base := a*base_eff + c*sel (the OLD selection's
        rhs is exactly state.sel_*), then sel_* re-gathers `new_select`
        for changed voices. base_eff honours purity (pure == the zero
        snapshot; after this every voice's base is a valid tensor, like
        fmajor.collapse). The in-flight tail-ring rescale (already-
        scattered old-selection content must follow the NEW fade-out
        trajectory) is identical to collapse_pure's and needs `params`
        (the post-change snapshot: vsteps + predelay). The 'allk' cascade
        stays span-only: collapse_pure."""
        if self.mac_strategy != "selected":
            raise ValueError("the 'allk' cascade is span-only: collapse in "
                             "the span (collapse_pure); bank swaps defer "
                             "until fades decay")
        if new_select is None:
            raise ValueError("'selected' strategy collapse needs new_select")
        if params is None:
            raise ValueError("cascade collapse needs params (the post-"
                             "change snapshot) for the in-flight tail "
                             "rescale")
        a, c = state.coef_a, state.coef_c
        bh, bt = self._bh, self._bt

        def mix(base, sel, brd):
            base_eff = jnp.where(brd(state.base_pure), 0.0,
                                 base.astype(jnp.float32))
            out = brd(a) * base_eff + brd(c) * sel.astype(jnp.float32)
            return jnp.where(brd(changed), out, base_eff).astype(base.dtype)

        new_head = self._gather_head(bank, new_select)
        new_tail = self._gather_tail(bank, new_select)
        return replace(
            state,
            base_head=mix(state.base_head, state.sel_head, bh),
            base_tail=mix(state.base_tail, state.sel_tail, bt),
            sel_head=jnp.where(bh(changed), new_head, state.sel_head),
            sel_tail=jnp.where(bt(changed), new_tail, state.sel_tail),
            tail_ring=self._rescale_inflight(state, changed, params),
            base_pure=jnp.zeros_like(state.base_pure),
            coef_a=jnp.where(changed, 1.0, state.coef_a),
            coef_c=jnp.where(changed, 0.0, state.coef_c),
        )

    def _bh(self, x2: jax.Array) -> jax.Array:
        """[V, 2] -> broadcast over the head rhs leaf [F1,V,I,d,2P1p,OD]."""
        return x2[None, :, :, None, None, None]

    def _bt(self, x2: jax.Array) -> jax.Array:
        """[V, 2] -> broadcast over the tail rhs leaf (group-major
        [M,Vg,I,d,2P2p,OD,F2]; voice j*ratio + g lives at [g, j])."""
        g2 = jnp.swapaxes(
            x2.reshape(self.num_voices // self.ratio, self.ratio, 2), 0, 1)
        return g2[:, :, :, None, None, None, None]

    def materialize_base(self, state: CascadeState, bank: CascadeBank
                         ) -> CascadeState:
        """Materialize purity WITHOUT any re-select (fmajor semantics):
        base_* := base_eff, purity cleared; selection, coefficients, and
        the tail ring untouched (nothing changed, so no in-flight rescale).
        The 'selected' strategy's purity only ever holds the ZERO snapshot
        (init state), so no bank read happens — unlike
        ``collapse(..., changed=all-False)``, which gathers the full bank
        for operands it then discards (1.9 GB at 152 IRs x 4 s)."""
        if self.mac_strategy != "selected":
            raise ValueError("the 'allk' cascade is span-only: snapshots "
                             "cannot materialize — defer bank swaps until "
                             "fades decay")

        def eff(base, brd):
            z = jnp.where(brd(state.base_pure), 0.0,
                          base.astype(jnp.float32))
            return z.astype(base.dtype)

        return replace(state,
                       base_head=eff(state.base_head, self._bh),
                       base_tail=eff(state.base_tail, self._bt),
                       base_pure=jnp.zeros_like(state.base_pure))

    def regather_selection(self, state: CascadeState, bank: CascadeBank,
                           select: jax.Array) -> CascadeState:
        """Re-point the materialized per-voice rhs at a (new) bank's
        content for the current selection — the live bank-swap path
        (StreamSession._apply_pending_bank)."""
        return replace(state,
                       sel_head=self._gather_head(bank, select),
                       sel_tail=self._gather_tail(bank, select))

    collapse_pure_takes_params = True

    def collapse_pure(self, state: CascadeState, old_select: jax.Array,
                      changed: jax.Array, params: VoiceParams
                      ) -> CascadeState:
        """Span collapse (fmajor.collapse_pure semantics — the snapshot
        provably stays in the bank's span) PLUS the in-flight fix: tail
        contributions already scattered for future blocks were weighted
        with pre-collapse coefficient projections, so a changed voice's
        old tail would hold its level for up to one tail window instead of
        fading. Rescale those in-flight slots by the post-collapse
        fade-out trajectory a'_d (exact for fades entered from steady
        state — the common case — and a smooth bounded approximation for
        re-interrupted mixtures). `params` carries the NEW fade's vsteps
        and the predelay that maps ring slots to compute blocks; in-flight
        content was scattered under the PRE-change predelay, so a single
        event that changes predelay AND re-selects mis-maps the rescale by
        the predelay delta — a bounded level transient on the old tail
        that drains within one tail window (tested:
        tests/test_cascade.py::test_simultaneous_predelay_and_reselect)."""
        if self.mac_strategy != "allk":
            raise ValueError("span collapse requires the 'allk' MAC "
                             "strategy ('selected' collapses materialize: "
                             "collapse)")
        k = state.base_g.shape[-1]
        oh = jax.nn.one_hot(old_select, k, dtype=jnp.float32)
        prev = jnp.where(state.base_pure[..., None], state.base_g, 0.0)
        g = state.coef_a[..., None] * prev + state.coef_c[..., None] * oh

        return replace(
            state,
            tail_ring=self._rescale_inflight(state, changed, params),
            base_g=jnp.where(changed[..., None], g, state.base_g),
            base_pure=jnp.where(changed, True, state.base_pure),
            coef_a=jnp.where(changed, 1.0, state.coef_a),
            coef_c=jnp.where(changed, 0.0, state.coef_c),
        )

    def _rescale_inflight(self, state: CascadeState, changed: jax.Array,
                          params: VoiceParams) -> jax.Array:
        """Rescale a changed voice's already-scattered tail-ring content by
        the post-collapse fade-out trajectory (see collapse_pure docstring:
        in-flight slots were weighted with pre-collapse projections).
        Strategy-independent — both collapse forms share it.

        Post-collapse fade-out factors: a'_d = prod_{m=0..d} (1 - r_m),
        slot n's compute block is d = n - q (entries with d < 0 were
        computed before the collapse and keep their weights, factor 1)."""
        nb = state.tail_ring.shape[4]
        msteps = jnp.arange(nb, dtype=jnp.float32)
        r = 1.0 / (jnp.maximum(
            params.vsteps.astype(jnp.float32)[..., None] - msteps, 0.0)
            + 5.0)                                        # [V, 2, NB]
        traj = jnp.concatenate(
            [jnp.ones(r.shape[:-1] + (1,), jnp.float32),
             jnp.cumprod(1.0 - r, axis=-1)], axis=-1)     # [V, 2, NB+1]
        q = (params.predelay[:, 0] // self.block)         # [V]
        idx = jnp.clip(jnp.arange(nb)[None, :] - q[:, None] + 1, 0, nb)
        factor = jnp.take_along_axis(
            traj, jnp.broadcast_to(idx[:, None, :], traj.shape[:-1] + (nb,)),
            axis=-1)                                      # [V, 2, NB]
        factor = jnp.where(changed[..., None], factor, 1.0)
        # the ring is MODULAR (slot s holds content due at the block u
        # with u mod NB == s): map the distance-indexed factors onto slots
        # by rolling by the current block counter
        factor = jnp.roll(factor, state.t, axis=-1)
        vg = self.num_voices // self.ratio
        return state.tail_ring * jnp.swapaxes(factor.reshape(
            vg, self.ratio, 2, nb), 0, 1)[:, :, :, None, :, None]
