"""Production engine: f-major planar partitioned overlap-save.

Numerically identical to PartitionedConvolution(variant="coef") —
equivalence-tested in tests/test_fmajor.py — with the delay line stored
f-major and crossfades in coefficient form:

  - the frequency-domain delay line is f-MAJOR planar f32:
    ``fdl [F, V*I, 2, Pp]`` (re/im plane pairs, contiguous view
    [F, V*I, 2*Pp]), so the partition MAC is one batched-per-frequency-bin
    real matmul with the partition axis contracted;
  - banks are stored as REAL tensors encoding complex multiplication as
    2x2 blocks (no complex leaves in the device bank);
  - crossfades use the affine-coefficient representation
    (active = a*base + c*bank[sel]; the reference's slew recursion,
    src/conv.cu:15-32, applied to two scalars; host collapse() on
    re-select; a steady step that skips the base term entirely).

Two MAC strategies (mac_strategy, equivalence-tested):

  - ``allk``: the MAC computes ALL K bank entries' contributions
    ([F, VI, 2Pp] x [F, 2Pp, K*O*2] batched matmul) and a [V,2]-indexed
    take picks each voice's selection — no gather, while K*O*2 <= ~64
    columns;
  - ``selected`` (large banks, e.g. the reference's 152-IR all.index):
    each voice's selected spectra stay materialized in state (f32, the fade
    snapshot's layout), refreshed only at collapse; the hot loop contracts
    the fdl against the stacked [selected, base] per-voice tensors in ONE
    einsum pass.

Two delay-line modes (ring default, equivalence-tested):

  - ``ring=True``: nothing ever shifts. The new block spectrum lands in
    ring slot w = t mod Pp (a 0.26 MB dynamic write) and slot s pairs with
    bank partition (w - s) mod Pp by slicing a dynamic window out of
    DOUBLED, time-REVERSED tensors (rhs2[j] = H[(-j) mod Pp] tiled twice;
    window [Pp-w, 2Pp-w)). The delay-line roll — a full read+write of the
    delay line every block — is gone from the hot loop. The fade ``base``
    snapshot is stored the same way in bfloat16: a transient whose weight
    coef_a decays to zero by construction, so reduced precision never
    reaches steady output.
  - ``ring=False``: classic shift-by-one-partition per block, everything
    naturally aligned, fade snapshot in f32 (bit-exact vs the coef engine).

Contraction precisions are the module constants below (PERF.md records
the error and cost of each on the GPU).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

import jax
import jax.numpy as jnp

from tpu_audio.engine.params import VoiceParams
from tpu_audio.ops.fft import SpectralTransform
from tpu_audio.ops.mix import add_dry, pan_gains, wet_scale

# Contraction precisions of the f32 engine (mac_dtype='bf16' runs its MAC
# at DEFAULT by design), read at trace time. Gates: golden vs float64
# < 2e-3 and offline bounce vs stream < 1e-4 (benchlib/legs.py equiv leg);
# PERF.md has the measured error and cost of each choice on the H100.
#   MAC_PRECISION: the delay-line MAC (all-K and per-voice forms). HIGH is
#     TF32 on the GPU and misses the equiv leg's golden check (3.9e-3 >
#     2e-3 on its loud signal); BF16_BF16_F32_X3 passes but costs more
#     than HIGHEST, which costs within noise of TF32 here.
#   MIX_PRECISION: value-carrying small einsums — coefficient mixes,
#     one-hot ring scatters, span expands. They carry the signal itself:
#     a TF32 one-hot scatter rounds it to 11 bits (the cascade's equiv
#     diff reads 7.4e-3 at HIGH, 4.3e-6 at HIGHEST).
MAC_PRECISION = jax.lax.Precision.HIGHEST
MIX_PRECISION = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclass
class FMajorBank:
    """Device-side bank in MAC-ready real layouts (host-precomputed)."""

    mac_rhs: jax.Array      # f32 [F, 2, Pp, KOD] plane-major MAC rhs (roll)
    rhs2: jax.Array         # f32 [F, 2, 2*Pp, KOD] doubled+reversed (ring)
    spectra: jax.Array      # f32 [K, O, Pp, F, 2] planar (init/collapse)
    spectra_rev2: jax.Array  # f32 [K, F, O, 2, 2*Pp] doubled+reversed planar

    @property
    def num_irs(self) -> int:
        # one of the planar leaves is a size-1 placeholder (spectra in
        # ring mode, spectra_rev2 in roll mode) — the real one is K-major
        return max(self.spectra.shape[0], self.spectra_rev2.shape[0])


@jax.tree_util.register_dataclass
@dataclass
class FMajorState:
    fdl: jax.Array       # f32 [F, VI, 2, Pp] planar freq delay line
                         # (contiguous view [F, VI, 2Pp] for the MAC)
    prev_in: jax.Array   # f32 [V, 2, B]
    wet_ring: jax.Array  # f32 [V, 2, NB, B] MODULAR block-slot output
                         # accumulator: slot (t + d) mod NB holds wet due
                         # d blocks from block t; the emit slot is read and
                         # zeroed in place (a concat-shift ring lowers to
                         # full-ring pad/slice/copy passes at high V — the
                         # cascade's lesson 3, ported back here)
    base: jax.Array      # fade snapshot: ring: bf16 [F,V,I,O,2,2Pp]
                         #                roll: f32  [F,V,I,O,2,Pp]
    coef_a: jax.Array    # f32 [V, 2]
    coef_c: jax.Array    # f32 [V, 2]
    wptr: jax.Array      # i32 [] block counter (mod t_modulus): drives the
                         # fdl ring slot (t mod Pp) and wet-ring slots
    sel_spectra: jax.Array  # 'selected' strategy only: f32, base's layout —
                            # the per-voice selected bank spectra (updated at
                            # collapse); placeholder [.,.,.,.,.,1] for 'allk'
    # fade-snapshot provenance: where base_pure, the EFFECTIVE snapshot is
    # sum_k base_g[v,i,k] * bank[k] and the `base` tensor may be stale.
    # Because collapse is affine (base := a*base + c*bank[sel]) and the
    # snapshot starts at zero, it stays in the bank's span through ANY
    # sequence of re-selects — interrupted fades included — so 'allk'
    # crossfades ride the all-K MAC the steady path already computes
    # (step_coef_indexed) and collapses cost a [V,2,K]-sized update
    # (collapse_pure). The span only breaks on a live bank swap mid-fade
    # (the tail must keep the OLD bank's sound), which materializes `base`
    # and clears base_pure. Carried in state (not host) so checkpoints and
    # sharding see it.
    base_g: jax.Array     # f32 [V, 2, K] ('allk'; [V, 2, 1] placeholder
                          # for 'selected', which never re-enters the span)
    base_pure: jax.Array  # bool [V, 2]


def _pad_p(arr: np.ndarray, axis: int, pp: int) -> np.ndarray:
    pad = pp - arr.shape[axis]
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


def pack_mac_rhs(spectra: np.ndarray, pp: int) -> np.ndarray:
    """[K, O, P, F] complex -> [F, 2, Pp, K*O*2] f32 plane-major MAC rhs.

    Plane c=0 carries columns (br, bi) per (k, o); plane c=1 carries
    (-bi, br), so summing the two plane-dots of the (ar, ai) fdl planes
    yields the complex product-sum  sum_p X_p * H_p.
    """
    k, o, p, f = spectra.shape
    br = np.transpose(spectra.real.astype(np.float32), (3, 2, 0, 1))  # [F,P,K,O]
    bi = np.transpose(spectra.imag.astype(np.float32), (3, 2, 0, 1))
    rhs = np.empty((f, 2, p, k, o, 2), np.float32)
    rhs[:, 0, :, :, :, 0] = br
    rhs[:, 0, :, :, :, 1] = bi
    rhs[:, 1, :, :, :, 0] = -bi
    rhs[:, 1, :, :, :, 1] = br
    return _pad_p(rhs.reshape(f, 2, p, k * o * 2), 2, pp)


def double_reversed(arr: np.ndarray, axis: int) -> np.ndarray:
    """out[j] = arr[(-j) mod P], tiled twice along `axis`.

    One gather instead of flip+concat chains. ORDER MATTERS for cost: call
    this while `axis`'s minor-side chunk is large (e.g. on [K, O, P, F]
    complex spectra, chunk = F), THEN pack/transpose — doubling the packed
    [F, 2, P, K*O*2] tensor instead costs ~50x more on a 1-core host
    (measured 15.7 s vs 0.3 s at a 16-IR 4 s bank)."""
    p = arr.shape[axis]
    idx = (p - np.arange(2 * p)) % p
    return np.take(arr, idx, axis=axis)


def pack_planar_spectra(spectra: np.ndarray, pp: int) -> np.ndarray:
    """[K, O, P, F] complex -> [K, O, Pp, F, 2] f32."""
    planar = np.stack([spectra.real, spectra.imag], axis=-1).astype(np.float32)
    return _pad_p(planar, 2, pp)


def pack_spectra_rev2(spectra: np.ndarray, pp: int) -> np.ndarray:
    """[K, O, P, F] complex -> f32 [K, F, O, 2, 2*Pp] doubled+reversed.

    Doubles on the partition axis BEFORE the transpose (cheap gather with
    F-sized chunks; see double_reversed)."""
    planar = _pad_p(
        np.stack([spectra.real, spectra.imag], axis=1).astype(np.float32),
        3, pp)                                       # [K, 2, O, Pp, F]
    dbl = double_reversed(planar, axis=3)            # [K, 2, O, 2Pp, F]
    return np.ascontiguousarray(np.transpose(dbl, (0, 4, 2, 1, 3)))


class FMajorPartitionedConvolution:
    """V stereo voices, f-major planar partitioned-OLS, coef crossfades."""

    variant = "coef"  # runtime-compatible with the coef engine interface

    # the all-K MAC computes every bank entry's K*O*2 columns; beyond this
    # width, per-voice selected spectra (updated only on re-select) cost
    # less than computing every bank entry's contribution
    ALLK_MAX_COLUMNS = 64  # K <= 16 stereo IRs

    def __init__(self, num_voices: int, block: int, partitions: int,
                 max_predelay: int = 8192, backend: str = "auto",
                 ring: bool = True, mac_strategy: str = "allk",
                 num_irs: int | None = None, mac_dtype: str = "f32",
                 swap_snapshot: bool = True, pv_mac: str = "dot",
                 fault_upload: str = "derived"):
        self.num_voices = num_voices
        self.block = block
        self.partitions = partitions
        # partition axis padded to a multiple of 8 (extra zero partitions
        # contribute nothing; whether the padding matters on the GPU is
        # not measured yet, ROADMAP.md)
        self.pp = -(-partitions // 8) * 8
        self.max_predelay = max_predelay
        self.ring_mode = ring
        if mac_strategy == "auto":
            if num_irs is None:
                raise ValueError("mac_strategy='auto' needs num_irs")
            mac_strategy = ("allk" if num_irs * 4 <= self.ALLK_MAX_COLUMNS
                            else "selected")
        if mac_strategy not in ("allk", "selected"):
            raise ValueError(f"unknown mac_strategy {mac_strategy!r}")
        self.mac_strategy = mac_strategy
        # mac_dtype="bf16": store the delay line + MAC tensors in bfloat16
        # and run the MAC at DEFAULT precision — half the delay-line bytes
        # of the f32 path, at a wet-path noise floor of ~-48 dB relative
        # (8-bit mantissa on the input spectra and IR spectra). The dry
        # path, mixing, crossfade coefficients, and transforms stay f32.
        # Opt-in; f32 is the default.
        if mac_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown mac_dtype {mac_dtype!r}")
        # bank size, needed to shape the span provenance base_g; recorded
        # here when given, else at prepare_bank (always called before
        # init_state in practice)
        self.num_irs = num_irs
        # swap_snapshot=False ('allk' only) drops the materialized fade
        # snapshot `base` — the largest state tensor (e.g. 732 MB at
        # 64v/4s) — because the span provenance serves every fade. The one
        # capability it costs: swap_bank mid-fade cannot materialize the
        # old bank's tail, so StreamSession defers the swap until in-flight
        # fades decay (bounded by the fade time itself).
        if not swap_snapshot and mac_strategy != "allk":
            raise ValueError("swap_snapshot=False requires the 'allk' MAC "
                             "strategy (the 'selected' MAC reads the "
                             "materialized snapshot during fades)")
        self.swap_snapshot = swap_snapshot
        # per-voice MAC lowering ('selected' steady/fade + the general fade
        # path): "dot" = batched per-(f,v,i) matvec (see per_voice_mac);
        # "merged" = batch (f,v) with the channel axis folded into BOTH
        # matmul dims and the i-cross terms discarded — 2x the FLOPs but
        # half the (M,N)-tiles per pass. Exactness-tested; which is faster
        # on the GPU is not measured yet.
        if pv_mac not in ("dot", "merged"):
            raise ValueError(f"unknown pv_mac {pv_mac!r}")
        self.pv_mac = pv_mac
        # working-set fault uploads ('allk'): "dual" ships both the MAC
        # column (rhs2 / mac_rhs) and the spectra slot (rev2 / planar) —
        # two layouts of the SAME IR data; "derived" ships only the
        # spectra slot and builds the MAC column on device (transposes +
        # one negation), halving the per-fault transfer (~6 -> ~3 MB f32
        # at 4 s) and the host pack. Works in ring mode (single device)
        # and roll mode (the multi-device serving layout). Bit-equal to
        # "dual" (tested). "td" goes one step further — the reference's
        # own architecture (prepare() FFTs on the GPU,
        # src/conv.cu:207-253): upload the TIME-DOMAIN IR (~1.4 MB f32 at
        # 4 s, vs ~3 MB spectra slot) and run partition FFT + pack in the
        # slot-update jit itself (engine/device_prep.py graph pieces). The
        # host pays only a pad — no per-fault FFT or strided pack at all.
        if fault_upload not in ("dual", "derived", "td"):
            raise ValueError(f"unknown fault_upload {fault_upload!r}")
        self.fault_upload = fault_upload
        self.mac_dtype = jnp.float32 if mac_dtype == "f32" else jnp.bfloat16
        self._mac_prec = (MAC_PRECISION if mac_dtype == "f32"
                          else jax.lax.Precision.DEFAULT)
        self.xf = SpectralTransform(2 * block, backend=backend)
        self.num_bins = self.xf.num_bins
        self.ring = max_predelay + block
        # block-slot accumulator: slots 0..maxPD//B (+1 for the sub-block
        # tail spill of the deepest predelay)
        self.ring_slots = max_predelay // block + 2
        # the block counter wraps at the lcm of every modulus derived from
        # it so rem-indices stay continuous across the wrap (see cascade)
        import math

        self.t_modulus = (math.lcm(self.pp, self.ring_slots)
                          if ring else self.ring_slots)

    # -- offline / cloning interface ------------------------------------------------

    def with_voices(self, num_voices: int,
                    swap_snapshot: bool | None = None
                    ) -> "FMajorPartitionedConvolution":
        """Same geometry and strategy at a different voice count. Device
        banks are voice-independent ([K, ...] tensors), so a bank prepared
        by this engine serves the clone directly — the seam the offline
        time-parallel renderer (runtime/offline.py) builds on.
        `swap_snapshot` optionally overrides the fade-snapshot capability
        (the renderer drops it: ~11 MB/voice of dead HBM in a fade-free
        bounce at 4 s IRs)."""
        if swap_snapshot is None:
            swap_snapshot = self.swap_snapshot
        return FMajorPartitionedConvolution(
            num_voices, self.block, self.partitions,
            max_predelay=self.max_predelay, backend=self.xf.backend,
            ring=self.ring_mode, mac_strategy=self.mac_strategy,
            num_irs=self.num_irs,
            mac_dtype="f32" if self.mac_dtype == jnp.float32 else "bf16",
            # 'selected' requires the snapshot (constructor invariant);
            # the override only applies to the allk strategy
            swap_snapshot=(swap_snapshot if self.mac_strategy == "allk"
                           else True),
            pv_mac=self.pv_mac, fault_upload=self.fault_upload)

    @property
    def history_blocks(self) -> int:
        """Number of trailing input blocks that fully determine the next
        output block at converged (static) params: the fdl depth plus the
        deepest wet-ring deferral, with margin. Priming a fresh converged
        state with this many input blocks reproduces the streamed output
        exactly — the contract runtime/offline.py's segment warm-up relies
        on."""
        return self.pp + self.ring_slots + 2

    @property
    def prime_blocks(self) -> int:
        """Streamed warm-up depth when the frequency delay line is primed
        directly (prime_fdl): only the wet ring still needs streaming —
        its deepest deferral plus the same margin history_blocks carries.
        Cuts the offline renderer's per-segment warm-up from
        pp + ring_slots + 2 (~730 steps at 4 s IRs) to ~36."""
        return self.ring_slots + 2

    def input_spectra_bulk(self, xb: jax.Array) -> jax.Array:
        """Planar input spectra for a whole shared-program block tensor
        [T, 2, B]: spec[t] carries exactly _input_spectrum's values for
        block t (rfft over the OLS pair [x_{t-1}, x_t]; x_{-1} = 0), as
        f32 [T, 2, F, 2] — one batched transform instead of T chained
        steps (the fdl is parameter-independent, so the offline renderer
        can rebuild any segment's delay line from these by gather)."""
        prev = jnp.concatenate([jnp.zeros_like(xb[:1]), xb[:-1]], axis=0)
        seg = jnp.concatenate([prev, xb], axis=-1)         # [T, 2, 2B]
        spec = self.xf.rfft(seg)                           # [T, 2, F]
        return jnp.stack([jnp.real(spec), jnp.imag(spec)], axis=-1)

    def prime_fdl(self, state: FMajorState, spec: jax.Array,
                  t0: jax.Array, voice_of: jax.Array | None = None
                  ) -> FMajorState:
        """Prime the frequency delay line as if blocks [t0-Pp, t0) had
        been streamed into a FRESH state (local wptr 0): the step at
        local time 0 then processes absolute block t0[v] with its full
        input history in place. `spec` is input_spectra_bulk's [T,2,F,2]
        (shared program material) or [T,Vb,2,F,2] with `voice_of` [V]
        mapping each voice onto a base-voice row; blocks before 0 prime
        to zero (the stream-from-silence state). prev_in (block t0-1's
        raw samples) is the caller's to set — the layout is trivial and
        the caller owns the input tensor."""
        pp, f, v = self.pp, self.num_bins, self.num_voices
        j = jnp.arange(pp)
        if self.ring_mode:
            # at wptr=0, MAC slot (0 - s) mod Pp pairs with bank partition
            # s, i.e. slot j must hold spec[t0 - Pp + j] (slot 0, the
            # s=Pp alias, is overwritten by the step-0 write before the
            # MAC reads it)
            blocks = t0[:, None] - pp + j[None, :]         # [V, Pp]
        else:
            # roll mode: position k holds spec[t - 1 - k] entering step t
            blocks = t0[:, None] - 1 - j[None, :]
        valid = blocks >= 0
        bc = jnp.clip(blocks, 0, spec.shape[0] - 1)
        if voice_of is None:
            g = jnp.take(spec, bc, axis=0)
        else:
            g = spec[bc, voice_of[:, None]]
        g = jnp.where(valid[..., None, None, None], g, 0.0)  # [V,Pp,I,F,d]
        fdl = jnp.transpose(g, (3, 0, 2, 4, 1)).reshape(
            f, v * 2, 2, pp).astype(self.mac_dtype)
        return replace(state, fdl=fdl)

    # -- bank ---------------------------------------------------------------------

    def _pack_bank_host(self, spectra: np.ndarray):
        """Host [K, O, P, F] complex -> the engine's numpy bank tensors
        (mac_rhs, rhs2, planar, rev2; None where the mode doesn't use one).

        All doubling/reversal happens BEFORE packing/transposing (gathers
        with F-sized chunks — see double_reversed): this keeps a 16-IR 4 s
        bank's host pack at ~3 s instead of ~50 s on a 1-core host. The
        device-side equivalent is engine/device_prep.py."""
        mac_rhs = rhs2 = rev2 = None
        if self.mac_strategy == "allk":
            if self.ring_mode:
                dbl = double_reversed(_pad_p(spectra, 2, self.pp), 2)
                rhs2 = pack_mac_rhs(dbl, 2 * self.pp)
            else:
                mac_rhs = pack_mac_rhs(spectra, self.pp)
        if self.ring_mode:
            rev2 = pack_spectra_rev2(spectra, self.pp)
        # ring mode never reads the planar spectra (FMajorBank keeps a
        # placeholder leaf): skip its pack entirely — ~700 MB of host
        # stack+pad work and cache bytes at the 152-IR 4 s scale
        planar = None if self.ring_mode else pack_planar_spectra(spectra,
                                                                 self.pp)
        return mac_rhs, rhs2, planar, rev2

    def prepare_bank(self, spectra: np.ndarray,
                     cache_dir: str | None = None) -> FMajorBank:
        """Host [K, 2, P, F] complex spectra -> device FMajorBank (f32/bf16
        transfers only; complex64 never crosses the host boundary).

        cache_dir: content-addressed disk cache for the PACKED tensors —
        on a slow host the pack of a large 4 s bank costs tens of seconds
        of strided numpy copies; a warm cache reduces it to one sequential
        read per tensor."""
        spectra = np.asarray(spectra)
        if spectra.shape[2] != self.partitions or spectra.shape[3] != self.num_bins:
            raise ValueError(f"bank geometry {spectra.shape} != engine "
                             f"(P={self.partitions}, F={self.num_bins})")
        if self.num_irs is not None and spectra.shape[0] != self.num_irs:
            raise ValueError(f"bank has {spectra.shape[0]} IRs, engine was "
                             f"built for num_irs={self.num_irs} (base_g "
                             f"state is K-shaped)")
        self.num_irs = spectra.shape[0]
        mac_rhs = rhs2 = planar = rev2 = None
        base = None
        loaded = False
        fields = ("mac_rhs", "rhs2", "planar", "rev2")
        if cache_dir is not None:
            import os

            from tpu_audio.utils import diskcache
            from tpu_audio.utils.log import Log
            base = "pack_" + diskcache.content_key(
                "fmajor-pack", (self.pp, self.ring_mode, self.mac_strategy,
                                spectra.shape), spectra)
            hit = diskcache.load(cache_dir, base, fields)
            if hit is not None:
                Log.info("fmajor", "packed-bank cache hit: %s/%s*",
                         cache_dir, base)
                mac_rhs, rhs2, planar, rev2 = (hit[f] for f in fields)
                loaded = True
            else:
                legacy = os.path.join(os.fspath(cache_dir), base + ".npz")
                if os.path.exists(legacy):
                    # one-time migration: .npz reads multi-GB entries at
                    # ~5 MB/s (see utils/diskcache.py) — re-store as raw
                    # .npy so every later run mmaps it
                    Log.info("fmajor", "packed-bank cache hit (legacy npz, "
                             "migrating to npy): %s", legacy)
                    with np.load(legacy) as data:
                        mac_rhs, rhs2, planar, rev2 = (
                            data[k] if k in data else None for k in fields)
                    diskcache.store(cache_dir, base,
                                    dict(zip(fields,
                                             (mac_rhs, rhs2, planar, rev2))))
                    loaded = True
        if not loaded:
            mac_rhs, rhs2, planar, rev2 = self._pack_bank_host(spectra)
            if base is not None:
                from tpu_audio.utils import diskcache
                diskcache.store(cache_dir, base,
                                dict(zip(fields,
                                         (mac_rhs, rhs2, planar, rev2))))
        dt = self.mac_dtype
        zero4 = jnp.zeros((1, 1, 1, 1), dt)
        # ring mode never reads the planar spectra (gather/span-expand use
        # spectra_rev2): keep the leaf a placeholder — at 152 IRs x 4 s the
        # planar tensor would be ~435 MB of dead device memory and upload
        return FMajorBank(
            mac_rhs=zero4 if mac_rhs is None else jnp.asarray(mac_rhs, dt),
            rhs2=zero4 if rhs2 is None else jnp.asarray(rhs2, dt),
            spectra=(jnp.zeros((1, 1, 1, 1, 1), jnp.float32)
                     if self.ring_mode else jnp.asarray(planar)),
            spectra_rev2=(jnp.zeros((1, 1, 1, 1, 1), dt) if rev2 is None
                          else jnp.asarray(rev2, dt)),
        )

    def update_bank_slot(self, bank: FMajorBank, slot, spectra_k) -> FMajorBank:
        """Replace ONE IR slot of a device bank (working-set residency,
        runtime/working_set.py): host [1, O, P, F] complex spectra for the
        incoming IR are packed exactly like prepare_bank (~0.2 s for one
        4 s IR with the gather-ordered pack) and written into the slot's
        columns/rows with dynamic-update-slices (one jit, slot index
        traced — no per-slot recompiles). 'allk' only: the 'selected'
        strategy materializes per-voice spectra in state, which a
        bank-slot write would silently miss."""
        if self.mac_strategy != "allk":
            raise ValueError("working-set slot updates require the 'allk' "
                             "MAC strategy (mac_strategy='selected' copies "
                             "spectra into state at collapse)")
        from tpu_audio.utils.jitcache import instance_cached

        dt = self.mac_dtype
        ring = self.ring_mode
        derived = self.fault_upload == "derived"
        td_mode = self.fault_upload == "td"
        if td_mode:
            # reference architecture (prepare() FFTs on-GPU,
            # src/conv.cu:207-253): the payload is the raw time-domain IR
            # [O, L]; partition FFT + double/reverse + packs all run in
            # the slot-update jit (device_prep graph pieces). Host cost:
            # one zero-pad to the engine's static partition grid.
            ir = np.asarray(spectra_k, np.float32)
            if ir.ndim != 2:
                raise ValueError(f"fault_upload='td' expects a time-domain "
                                 f"[O, L] IR payload, got {ir.shape}")
            lp = self.partitions * self.block
            pad = np.zeros((ir.shape[0], lp), np.float32)
            pad[:, : min(ir.shape[1], lp)] = ir[:, :lp]
            payloads = (jnp.zeros((1, 1, 1, 1), dt),
                        jnp.zeros((1, 1, 1, 1, 1), jnp.float32),
                        jnp.asarray(pad))
        elif derived and ring:
            # upload ONLY the rev2 slot; the rhs2 MAC column is the same
            # doubled+reversed data in another axis order — rebuilt on
            # device below (transposes + one negation, no reverse ops),
            # and the host skips the pack_mac_rhs work per fault too
            rev2 = pack_spectra_rev2(np.asarray(spectra_k), self.pp)
            payloads = (jnp.zeros((1, 1, 1, 1), dt),
                        jnp.zeros((1, 1, 1, 1, 1), jnp.float32),
                        jnp.asarray(rev2, dt))
        elif derived:
            # roll mode (the multichip serving layout): planar is the
            # read leaf; the mac_rhs column is the same data transposed —
            # rebuilt on device below
            planar = pack_planar_spectra(np.asarray(spectra_k), self.pp)
            payloads = (jnp.zeros((1, 1, 1, 1), dt),
                        jnp.asarray(planar),
                        jnp.zeros((1, 1, 1, 1, 1), dt))
        else:
            mac_rhs, rhs2, planar, rev2 = self._pack_bank_host(
                np.asarray(spectra_k))
            # ring mode: the planar leaf is a placeholder (never read) — no
            # planar payload crosses the host boundary per fault
            payloads = (jnp.asarray(rhs2 if ring else mac_rhs, dt),
                        (jnp.zeros((1, 1, 1, 1, 1), jnp.float32) if ring
                         else jnp.asarray(planar)),
                        (jnp.asarray(rev2, dt) if ring
                         else jnp.zeros((1, 1, 1, 1, 1), dt)))

        def build():
            def mac_planes(re_, im_, out_dtype):
                """(br, bi) as [F, q, O] -> the pack_mac_rhs column layout
                [F, c, q, O*d]: plane c=0 carries (br, bi), c=1 carries
                (-bi, br). The axis moves and the sign flip commute
                exactly with the bf16 cast."""
                f2, q = re_.shape[0], re_.shape[1]
                p0 = jnp.stack([re_, im_], axis=-1).reshape(f2, q, 4)
                p1 = jnp.stack([-im_, re_], axis=-1).reshape(f2, q, 4)
                return jnp.stack([p0, p1], axis=1).astype(out_dtype)

            def upd(bank, mac_p, planar_p, rev2_p, k):
                from dataclasses import replace as _replace
                col0 = k * 4
                if td_mode:
                    # rev2_p carries the padded time-domain IR [O, Lp]
                    from tpu_audio.engine import device_prep as _dp
                    spec = _dp.pad_parts(
                        _dp.partition_fd(rev2_p[None], self.block,
                                         self.partitions, 0, self.xf),
                        self.pp)                       # [1, O, Pp, F]
                    if ring:
                        dbl = _dp.double_reversed_j(spec, 2)
                        rev2_p = _dp.pack_rev2_j(dbl).astype(
                            bank.spectra_rev2.dtype)
                    else:
                        planar_p = _dp.pack_planar_j(spec)
                if ring:
                    if derived or td_mode:
                        # rev2_p[0]: [F, O, d, 2Pp], d = (br, bi)
                        r = rev2_p[0]
                        mac_p = mac_planes(
                            jnp.transpose(r[:, :, 0], (0, 2, 1)),
                            jnp.transpose(r[:, :, 1], (0, 2, 1)),
                            bank.rhs2.dtype)
                    rhs2 = jax.lax.dynamic_update_slice(
                        bank.rhs2, mac_p, (0, 0, 0, col0))
                    rev = jax.lax.dynamic_update_slice(
                        bank.spectra_rev2, rev2_p, (k, 0, 0, 0, 0))
                    return _replace(bank, rhs2=rhs2, spectra_rev2=rev)
                if derived or td_mode:
                    # planar_p[0]: [O, Pp, F, d] — natural partition order
                    pl = planar_p[0]
                    mac_p = mac_planes(
                        jnp.transpose(pl[..., 0], (2, 1, 0)),
                        jnp.transpose(pl[..., 1], (2, 1, 0)),
                        bank.mac_rhs.dtype)
                mac = jax.lax.dynamic_update_slice(
                    bank.mac_rhs, mac_p, (0, 0, 0, col0))
                return _replace(
                    bank, mac_rhs=mac,
                    spectra=jax.lax.dynamic_update_slice(
                        bank.spectra, planar_p, (k, 0, 0, 0, 0)))

            return jax.jit(upd)

        fn = instance_cached(self, "update_bank_slot", build)
        return fn(bank, *payloads, jnp.int32(slot))

    # -- state ---------------------------------------------------------------------

    def _base_shape(self):
        v, f, pp = self.num_voices, self.num_bins, self.pp
        if not self.swap_snapshot:
            return (1, 1, 1, 1, 1, 1), jnp.float32  # span-only: no snapshot
        if self.ring_mode:
            return (f, v, 2, 2, 2, 2 * pp), jnp.bfloat16
        return (f, v, 2, 2, 2, pp), jnp.float32

    def _sel_shape(self):
        v, f, pp = self.num_voices, self.num_bins, self.pp
        if self.mac_strategy != "selected":
            return (f, v, 2, 2, 2, 1), self.mac_dtype
        last = 2 * pp if self.ring_mode else pp
        return (f, v, 2, 2, 2, last), self.mac_dtype

    def _base_g_width(self) -> int:
        if self.mac_strategy != "allk":
            return 1  # 'selected' never re-enters the span; placeholder
        if self.num_irs is None:
            raise ValueError(
                "the 'allk' strategy's base_g provenance is bank-sized; "
                "pass num_irs= to the constructor or call prepare_bank "
                "before init_state")
        return self.num_irs

    def init_state(self) -> FMajorState:
        from tpu_audio.utils.jitcache import instance_cached

        v, b, pp, f = self.num_voices, self.block, self.pp, self.num_bins
        base_shape, base_dtype = self._base_shape()
        sel_shape, sel_dtype = self._sel_shape()
        kg = self._base_g_width()
        return instance_cached(self, "init_state", lambda: jax.jit(
            lambda: FMajorState(
            fdl=jnp.zeros((f, v * 2, 2, pp), self.mac_dtype),
            prev_in=jnp.zeros((v, 2, b), jnp.float32),
            wet_ring=jnp.zeros((v, 2, self.ring_slots, b), jnp.float32),
            base=jnp.zeros(base_shape, base_dtype),
            coef_a=jnp.zeros((v, 2), jnp.float32),
            coef_c=jnp.zeros((v, 2), jnp.float32),
            wptr=jnp.zeros((), jnp.int32),
            sel_spectra=jnp.zeros(sel_shape, sel_dtype),
            # the zero snapshot is the zero span vector
            base_g=jnp.zeros((v, 2, kg), jnp.float32),
            base_pure=jnp.ones((v, 2), jnp.bool_),
        )))()

    def init_converged(self, bank: FMajorBank, params: VoiceParams) -> FMajorState:
        from tpu_audio.utils.jitcache import instance_cached

        state = self.init_state()
        coefc = instance_cached(self, "init_coefc", lambda: jax.jit(
            lambda w: w.astype(jnp.float32) + 0.0))
        state = replace(state, coef_c=coefc(params.wet))
        if self.mac_strategy == "selected":
            gather = instance_cached(self, "init_gather_sel",
                                     lambda: jax.jit(self._gather_selection))
            state = replace(state, sel_spectra=gather(bank, params.select))
        return state

    def _gather_selection(self, bank: FMajorBank, select: jax.Array) -> jax.Array:
        """Per-voice selected spectra in base layout [F,V,I,O,2,(2)Pp],
        in the engine's MAC dtype (the sel_spectra state slot's dtype)."""
        if self.ring_mode:
            gathered = jnp.take(bank.spectra_rev2, select, axis=0)
            out = jnp.transpose(gathered, (2, 0, 1, 3, 4, 5))
        else:
            gathered = jnp.take(bank.spectra, select, axis=0)
            out = jnp.transpose(gathered, (4, 0, 1, 2, 5, 3))
        return out.astype(self.mac_dtype)

    def regather_selection(self, state: FMajorState, bank: FMajorBank,
                           select: jax.Array) -> FMajorState:
        """Re-point the materialized per-voice spectra at a (new) bank —
        the live bank-swap path (StreamSession._apply_pending_bank)."""
        return replace(state,
                       sel_spectra=self._gather_selection(bank, select))

    def _span_expand(self, bank: FMajorBank, g: jax.Array) -> jax.Array:
        """Materialize span-represented snapshots, sum_k g[v,i,k] * bank[k],
        into the base layout [F,V,I,O,2,(2)Pp], f32 (rare path: collapse
        and bank swaps only)."""
        if self.ring_mode:
            return jnp.einsum("kfoep,vik->fvioep",
                              bank.spectra_rev2.astype(jnp.float32), g,
                              precision=MIX_PRECISION)
        return jnp.einsum("kopfd,vik->fviodp",
                          bank.spectra.astype(jnp.float32), g,
                          precision=MIX_PRECISION)

    # -- hot step -------------------------------------------------------------------

    def _input_spectrum(self, state: FMajorState, x: jax.Array) -> jax.Array:
        """OLS segment rfft -> planar [F, VI, 2, 1] in the MAC dtype."""
        seg = jnp.concatenate([state.prev_in, x], axis=-1)        # [V, 2, 2B]
        spec = self.xf.rfft(seg)                                   # [V, 2, F]
        v = self.num_voices
        xn = jnp.stack([jnp.real(spec), jnp.imag(spec)], axis=-1)  # [V, 2, F, 2]
        return jnp.transpose(xn.reshape(v * 2, self.num_bins, 2),
                             (1, 0, 2))[..., None].astype(self.mac_dtype)

    def _wet_scale(self, params: VoiceParams) -> jax.Array:
        return wet_scale(params)                          # [V, I, O]

    def _finish(self, state, params, x, y, t, **updates):
        """y [F, V, O, 2] planar spectra -> predelayed wet -> ring -> mix.

        Per-voice predelay pd = q*B + r is applied with no per-voice dynamic
        memory ops: the sub-block part r rides the existing inverse
        transform as a spectral phase ramp (a circular shift of the length-2B
        segment, whose wrap region conveniently carries the split-off tail),
        and the block part q becomes a one-hot scatter-add into a
        [V, O, NB, B] MODULAR block-slot accumulator ring: slot (t + d) mod
        NB holds wet due d blocks after block t; the emit slot (t mod NB)
        is read then zeroed with a small in-place write (a concat-shift
        ring would rebuild the whole ring every block).
        """
        b, v = self.block, self.num_voices
        n2 = 2 * b
        pd = params.predelay[:, 0]                                # [V]
        q = pd // b
        r = pd % b

        # phase ramp e^{-i 2 pi f r / N}: planar rotation of y
        ang = (2.0 * jnp.pi / n2) * (jnp.arange(self.num_bins,
                                                dtype=jnp.float32)[:, None]
                                     * r.astype(jnp.float32)[None, :])  # [F,V]
        c, s = jnp.cos(ang)[..., None], jnp.sin(ang)[..., None]   # [F,V,1]
        yre, yim = y[..., 0], y[..., 1]
        spec = jax.lax.complex(yre * c + yim * s, yim * c - yre * s)
        spec = jnp.transpose(spec, (1, 2, 0))                     # [V, O, F]
        ys = self.xf.irfft(spec)                                  # [V, O, 2B]

        # circular shift semantics: ys[:, :, B:] offset j holds wet[j - r]
        # for j >= r; ys[:, :, :B] offset j < r holds the tail wet[B-r+j]
        offs = jnp.arange(b)[None, None, :]
        part_main = jnp.where(offs >= r[:, None, None], ys[..., b:], 0.0)
        part_tail = jnp.where(offs < r[:, None, None], ys[..., :b], 0.0)

        nb = state.wet_ring.shape[2]
        slots = jnp.arange(nb)[None, :]
        oh_q = (slots == jax.lax.rem(t + q[:, None], jnp.int32(nb))
                ).astype(jnp.float32)                             # [V, NB]
        oh_q1 = (slots == jax.lax.rem(t + q[:, None] + 1, jnp.int32(nb))
                 ).astype(jnp.float32)
        ring = (state.wet_ring
                + jnp.einsum("vn,vob->vonb", oh_q, part_main,
                             precision=MIX_PRECISION)
                + jnp.einsum("vn,vob->vonb", oh_q1, part_tail,
                             precision=MIX_PRECISION))
        emit = jax.lax.rem(t, jnp.int32(nb))
        wet_now = jax.lax.dynamic_slice_in_dim(ring, emit, 1, axis=2)[:, :, 0]
        ring = jax.lax.dynamic_update_slice(
            ring, jnp.zeros((v, 2, 1, b), jnp.float32), (0, 0, emit, 0))

        out = jnp.clip(wet_now, -1.0, 1.0)
        out = add_dry(out, x, params)
        return replace(state, prev_in=x, wet_ring=ring, **updates), out

    def step_coef(self, state: FMajorState, bank: FMajorBank,
                  params: VoiceParams, x: jax.Array, with_base: bool = True,
                  indexed_base: bool = False, stages=None):
        """Full step (fade-capable). Same semantics contract as
        PartitionedConvolution.step_coef, in f-major layout.

        ``indexed_base=True`` ('allk' strategy only) asserts that every
        voice whose fade still matters has a span snapshot, ``base ==
        sum_k base_g[k] * bank[k]`` — the base term is then a tiny
        K-contraction of the SAME all-K MAC instead of a separate
        per-voice contraction (see step_coef_indexed).

        ``stages`` (DIAGNOSTIC ONLY, like cascade._step's): None runs the
        production step; a subset of ("input", "mac", "finish") replaces
        the omitted stage's output with zeros so the remaining stages'
        device cost can be timed in isolation (delay-line traffic is kept:
        the fdl update always runs). Never used by sessions."""
        v, f, pp = self.num_voices, self.num_bins, self.pp
        k = bank.num_irs
        if (with_base and not indexed_base and not self.swap_snapshot):
            raise ValueError(
                "engine was built with swap_snapshot=False: there is no "
                "materialized fade snapshot to read — fades ride "
                "step_coef_indexed (span provenance)")
        if stages is not None and "input" not in stages:
            xn = jnp.zeros((f, v * 2, 2, 1), self.mac_dtype)
        else:
            xn = self._input_spectrum(state, x)

        t = state.wptr  # block counter (mod t_modulus)
        if self.ring_mode:
            w = jax.lax.rem(t, jnp.int32(self.pp))
            fdl = jax.lax.dynamic_update_slice(
                state.fdl, xn, (0, 0, 0, w))
        else:
            w = jnp.zeros((), jnp.int32)  # unused (natural order)
            fdl = jnp.concatenate([xn, state.fdl[..., :-1]], axis=-1)

        r = 1.0 / (params.vsteps.astype(jnp.float32) + 5.0)
        a = state.coef_a * (1.0 - r)
        c = state.coef_c * (1.0 - r) + params.wet * r
        scale = self._wet_scale(params)                           # [V, I, O]

        def window(arr, axis):
            """ring: slice [Pp-w, 2Pp-w) of a doubled+reversed tensor; roll:
            identity (natural order)."""
            if self.ring_mode:
                return jax.lax.dynamic_slice_in_dim(arr, self.pp - w, self.pp,
                                                    axis=axis)
            return arr

        def per_voice_mac(tensors):
            """ONE contraction of fdl against N stacked per-voice spectra
            tensors [F,V,I,O,2,Pp] -> [N, F,V,I,O,2] complex products.

            Each voice has its OWN rhs, so this is inherently a batched
            [2, Pp] x [Pp, 4] matvec — the pathology the reference flags on
            f_interpolate (src/conv.cu:337). The production fade path avoids this
            contraction entirely via step_coef_indexed; this general form
            only runs for interrupted fades ('allk') or large banks
            ('selected')."""
            if self.pv_mac == "merged":
                return per_voice_mac_merged(tensors)
            stacked = jnp.stack(tensors, axis=1)                  # [F,N,V,I,O,e,Pp]
            fb = fdl.reshape(f, v, 2, 2, pp)                      # [F,V,I,c,Pp]
            mb = jnp.einsum("fvicp,fnvioep->fnvicoe", fb, stacked,
                            precision=self._mac_prec,
                            preferred_element_type=jnp.float32)
            yre = mb[..., 0, :, 0] - mb[..., 1, :, 1]
            yim = mb[..., 0, :, 1] + mb[..., 1, :, 0]
            out = jnp.stack([yre, yim], axis=-1)                  # [F,N,V,I,O,d]
            return [out[:, n] for n in range(len(tensors))]

        def per_voice_mac_merged(tensors):
            """pv_mac='merged': batch (f, v) only, folding (i, c) into the
            matmul M axis and (n, i', o, e) into N, then keeping the i==i'
            diagonal — [4, Pp] x [Pp, 8N] per (f, v). Twice the FLOPs of
            the dot form but half its (M, N) tile count per K-pass."""
            n = len(tensors)
            stacked = jnp.stack(tensors, axis=2)                  # [F,V,N,I,O,e,Pp]
            lhs = fdl.reshape(f, v, 4, pp)                        # [F,V,ic,Pp]
            rhs = jnp.transpose(stacked, (0, 1, 6, 2, 3, 4, 5)).reshape(
                f, v, pp, n * 8)                                  # [F,V,Pp,nioe]
            prod = jnp.einsum("fvmp,fvpn->fvmn", lhs, rhs,
                              precision=self._mac_prec,
                              preferred_element_type=jnp.float32)
            prod = prod.reshape(f, v, 2, 2, n, 2, 2, 2)           # [F,V,i,c,n,i',o,e]
            diag = jnp.einsum("fvicnioe->fvnicoe", prod)          # i' == i
            yre = diag[..., 0, :, 0] - diag[..., 1, :, 1]
            yim = diag[..., 0, :, 1] + diag[..., 1, :, 0]
            out = jnp.stack([yre, yim], axis=-1)                  # [F,V,N,I,O,d]
            return [out[:, :, k2] for k2 in range(n)]

        coef_sel = (c[..., None] * scale)                         # [V, I, O]

        if stages is not None and "mac" not in stages:
            y = jnp.zeros((f, v, 2, 2), jnp.float32)
        elif self.mac_strategy == "selected":
            tensors = [window(state.sel_spectra, 5).astype(self.mac_dtype)]
            if with_base:
                tensors.append(window(state.base, 5).astype(self.mac_dtype))
            macs = per_voice_mac(tensors)
            y = jnp.einsum("fviod,vio->fvod", macs[0], coef_sel,
                           precision=MIX_PRECISION)
            if with_base:
                y = y + jnp.einsum("fviod,vio->fvod", macs[1],
                                   a[..., None] * scale, precision=MIX_PRECISION)
        else:
            # all-K MAC: [F, VI, 2Pp] x [F, 2Pp, KOD] -> [F, VI, KOD]
            if self.ring_mode:
                rhs = window(bank.rhs2, 2)
                rhs = rhs.reshape(f, 2 * pp, rhs.shape[-1])
                m = jnp.einsum("fvq,fqk->fvk",
                               fdl.reshape(f, v * 2, 2 * pp), rhs,
                               precision=self._mac_prec,
                               preferred_element_type=jnp.float32)
            else:
                # roll mode keeps the (plane, partition) axes unmerged so
                # the partition axis can shard over a device mesh: per-shard
                # partial complex sums + an XLA-inserted psum over 'part'
                # (a merged q=2*Pp axis cannot carry a partition sharding)
                m = jnp.einsum("fvcp,fcpk->fvk",
                               fdl.reshape(f, v * 2, 2, pp), bank.mac_rhs,
                               precision=self._mac_prec,
                               preferred_element_type=jnp.float32)
            m = m.reshape(f, v, 2, k, 2, 2)                       # [F,V,I,K,O,d]
            sel = params.select[None, :, :, None, None, None]
            y_sel = jnp.take_along_axis(m, sel, axis=3)[:, :, :, 0]
            y = jnp.einsum("fviod,vio->fvod", y_sel, coef_sel,
                           precision=MIX_PRECISION)
            if indexed_base:
                # span snapshot: base == sum_k base_g[k] * bank[k], so the
                # base term is linear in the SAME all-K products m — one
                # K-sized contraction, no extra HBM traffic
                y_base = jnp.einsum("fvikod,vik->fviod", m, state.base_g,
                                    precision=MIX_PRECISION)
                y = y + jnp.einsum("fviod,vio->fvod", y_base,
                                   a[..., None] * scale, precision=MIX_PRECISION)
            elif with_base:
                mb = per_voice_mac([window(state.base, 5).astype(self.mac_dtype)])
                y = y + jnp.einsum("fviod,vio->fvod", mb[0],
                                   a[..., None] * scale, precision=MIX_PRECISION)

        wptr_next = jax.lax.rem(t + 1, jnp.int32(self.t_modulus))
        if stages is not None and "finish" not in stages:
            # keep the MAC live under DCE: a full reduction of y rides the
            # first output sample (y[0] alone would let XLA slice the MAC
            # down to frequency bin 0 — every bin is independent)
            tap = jnp.sum(y, axis=(0, 3)).astype(jnp.float32)     # [V, O]
            out = jnp.zeros((v, 2, self.block),
                            jnp.float32).at[:, :, 0].set(tap)
            return (replace(state, prev_in=x, fdl=fdl, coef_a=a, coef_c=c,
                            wptr=wptr_next), out)
        return self._finish(state, params, x, y, t,
                            fdl=fdl, coef_a=a, coef_c=c, wptr=wptr_next)

    def step_coef_steady(self, state, bank, params, x):
        """Steady-state hot path: base term elided (coef_a ~ 0)."""
        return self.step_coef(state, bank, params, x, with_base=False)

    def step_coef_indexed(self, state, bank, params, x):
        """The production crossfading step: every fading voice's snapshot
        is span-represented, base == sum_k state.base_g[k] * bank[k].
        Because collapse is affine and the snapshot starts at zero, the
        span holds through ANY re-select sequence — converged AND
        interrupted fades alike (collapse_pure maintains the provenance in
        state); it only breaks on a live bank swap mid-fade, where
        StreamSession materializes `base` and falls back to step_coef. The
        base contribution is a K-sized contraction of the SAME all-K MAC
        the steady path already computes, so a mid-crossfade block costs
        the same as a steady block — finishing the job the reference
        started by flagging its fade kernel as the most expensive
        (src/conv.cu:337)."""
        if self.mac_strategy != "allk":
            raise ValueError("indexed fade requires the 'allk' MAC strategy")
        return self.step_coef(state, bank, params, x, with_base=False,
                              indexed_base=True)

    def step(self, state, bank, params, x):
        return self.step_coef(state, bank, params, x)

    # -- rare path ---------------------------------------------------------------------

    def collapse(self, state: FMajorState, bank: FMajorBank,
                 old_select: jax.Array, changed: jax.Array,
                 new_select: jax.Array | None = None) -> FMajorState:
        """Re-base the affine form after IR re-select (host-triggered),
        MATERIALIZING the snapshot: base := a*base_eff + c*bank[old] where
        the effective previous snapshot honours span provenance (a voice
        whose base was virtual — sum_k base_g[k]*bank[k], possibly with a
        stale `base` tensor — is materialized here, including non-changed
        voices, so the general fade step may read `base` for everyone
        afterwards). The 'allk' production path never needs this (its
        collapses stay in the span, collapse_pure); it exists for the
        'selected' strategy and for bank swaps mid-fade. The 'selected'
        strategy also re-gathers the per-voice selected spectra (pass
        `new_select`, the post-change selection)."""
        if not self.swap_snapshot:
            raise ValueError(
                "engine was built with swap_snapshot=False: snapshots "
                "cannot materialize — collapse in the span (collapse_pure) "
                "and defer bank swaps until fades decay")
        if self.mac_strategy == "selected":
            gathered = state.sel_spectra.astype(jnp.float32)
            # 'selected' span provenance only ever holds the zero snapshot
            # (base_g is a placeholder; pure is the init state)
            virtual = jnp.zeros(state.base.shape, jnp.float32)
        else:
            gathered = self._gather_selection(bank, old_select)
            virtual = self._span_expand(bank, state.base_g)
        pure = state.base_pure[None, :, :, None, None, None]
        base_eff = jnp.where(pure, virtual, state.base.astype(jnp.float32))
        a = state.coef_a[None, :, :, None, None, None]
        c = state.coef_c[None, :, :, None, None, None]
        collapsed = a * base_eff + c * gathered
        mask = changed[None, :, :, None, None, None]
        state = replace(
            state,
            base=jnp.where(mask, collapsed, base_eff).astype(state.base.dtype),
            base_pure=jnp.zeros_like(state.base_pure),
            coef_a=jnp.where(changed, 1.0, state.coef_a),
            coef_c=jnp.where(changed, 0.0, state.coef_c),
        )
        if self.mac_strategy == "selected":
            if new_select is None:
                raise ValueError("'selected' strategy collapse needs new_select")
            fresh = self._gather_selection(bank, new_select)
            state = replace(state, sel_spectra=jnp.where(
                mask, fresh, state.sel_spectra))
        return state

    def materialize_base(self, state: FMajorState, bank: FMajorBank
                         ) -> FMajorState:
        """Materialize virtual (span-provenance) snapshots WITHOUT any
        re-select: base := base_eff, purity cleared, coefficients and
        selection untouched. Semantically identical to
        ``collapse(..., changed=all-False)`` but statically free of the
        changed-gated work — a traced all-False `changed` cannot be
        dead-code-eliminated, so that form still gathers re-select
        operands from the full bank only to discard them (the session's
        bank-swap and resume paths, stream.py, are the callers)."""
        if not self.swap_snapshot:
            raise ValueError(
                "engine was built with swap_snapshot=False: snapshots "
                "cannot materialize — defer bank swaps until fades decay")
        if self.mac_strategy == "selected":
            virtual = jnp.zeros(state.base.shape, jnp.float32)
        else:
            virtual = self._span_expand(bank, state.base_g)
        pure = state.base_pure[None, :, :, None, None, None]
        base_eff = jnp.where(pure, virtual, state.base.astype(jnp.float32))
        return replace(state,
                       base=base_eff.astype(state.base.dtype),
                       base_pure=jnp.zeros_like(state.base_pure))

    def collapse_pure(self, state: FMajorState, old_select: jax.Array,
                      changed: jax.Array) -> FMajorState:
        """Span collapse ('allk' strategy): the affine re-base base :=
        a*base + c*bank[old] applied to the span coefficients, base_g :=
        a*base_g + c*onehot(old) — EXACT for any changed voice whose
        snapshot was span-represented (pure), converged or mid-fade alike,
        and a [V,2,K]-sized update instead of a full snapshot rewrite. A
        changed voice that was NOT pure must have converged (a ~ 0,
        host-checked): its stale base_g is dropped and the span restarts at
        c*onehot(old). Re-select blocks therefore cost the same as steady
        blocks end to end (the reference instead pays its full-spectrum
        f_interpolate for the entire fade, conv.cu:337)."""
        if self.mac_strategy != "allk":
            raise ValueError("span collapse requires the 'allk' MAC strategy")
        k = state.base_g.shape[-1]
        oh = jax.nn.one_hot(old_select, k, dtype=jnp.float32)   # [V, 2, K]
        prev = jnp.where(state.base_pure[..., None], state.base_g, 0.0)
        g = (state.coef_a[..., None] * prev
             + state.coef_c[..., None] * oh)
        return replace(
            state,
            base_g=jnp.where(changed[..., None], g, state.base_g),
            base_pure=jnp.where(changed, True, state.base_pure),
            coef_a=jnp.where(changed, 1.0, state.coef_a),
            coef_c=jnp.where(changed, 0.0, state.coef_c),
        )


def make_chunk_step(engine, steady: bool = False, indexed: bool = False):
    """Multi-block step: scan `engine.step_coef` over a [T, V, 2, B] chunk.

    One dispatch + one host transfer pair per T blocks instead of per block —
    the offline/bulk-processing path, and the live path on high-RTT host
    links. Within a chunk parameters are frozen except the crossfade
    countdown, which decrements per block in-graph exactly like the host
    does between blocks (MIDI events still apply at chunk boundaries).
    Works with any coef-interface engine (fmajor or partitioned-coef);
    ``indexed=True`` scans the span fade step (fmajor 'allk').
    """
    import jax as _jax

    if indexed:
        step = engine.step_coef_indexed
    else:
        step = engine.step_coef_steady if steady else engine.step_coef

    def chunk_step(state, bank, params, xs):
        def body(carry, x):
            st, i = carry
            p_i = replace(params,
                          vsteps=jnp.maximum(params.vsteps - i, 0))
            st, out = step(st, bank, p_i, x)
            return (st, i + 1), out

        (state, _), outs = _jax.lax.scan(body, (state, jnp.int32(0)), xs)
        return state, outs

    return chunk_step
