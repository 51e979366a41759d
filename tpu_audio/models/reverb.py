"""High-level reverb models: engine + bank + control plane bundles.

``ConvolutionReverb`` is the single-stereo-pair model matching the
reference's application wiring (reference src/main.cu:18-116: settings ->
IR bank -> Convolution instance -> control mapping -> stream).
``MultiVoiceReverbServer`` is the flagship: V concurrent stereo voices
batched into one partitioned engine, one shared HBM spectra bank, built for
the 64-voice / 4-second-IR / 256-frame real-time target (BASELINE.md), and
shardable over a device mesh via tpu_audio.parallel.
"""

from __future__ import annotations

import os

import jax.numpy as jnp

from tpu_audio.engine.bank import IRBank
from tpu_audio.engine.cascade import CascadeConvolution
from tpu_audio.engine.fmajor import FMajorPartitionedConvolution
from tpu_audio.engine.monolithic import MonolithicConvolution
from tpu_audio.engine.params import CCMapping, ControlPlane
from tpu_audio.engine.partitioned import PartitionedConvolution
from tpu_audio.io.settings import Settings
from tpu_audio.runtime.backends import BlockSink, BlockSource
from tpu_audio.runtime.stream import MidiSchedule, StreamSession
from tpu_audio.utils.log import Log
from tpu_audio.utils.transfer import device_put_maybe_complex


def _fit_cascade_ratio(requested: int, num_voices: int, partitions: int) -> int:
    """Largest valid stagger ratio <= requested: the cascade engine needs
    `num_voices % ratio == 0` (one voice group's tail chunk per block) and
    `partitions > 2*ratio` (the head must not swallow the whole IR)."""
    for ratio in range(min(requested, num_voices, (partitions - 1) // 2), 1, -1):
        if num_voices % ratio == 0:
            return ratio
    raise ValueError(
        f"no cascade stagger ratio >= 2 fits voices={num_voices}, "
        f"IR partitions={partitions}; use engine='fmajor' (short IRs or "
        f"awkward voice counts don't benefit from the cascade)")


def pair_geometry_keys(settings: Settings, root: str | None) -> list[tuple]:
    """One engine-geometry key per conv pair: (fftSize, maxPredelay,
    index0, index1). The reference builds count/2 independent instances,
    each with its own geometry (src/main.cu:31-39, paired fftSizes
    asserted equal at main.cu:36); homogeneous files (every key equal)
    serve through one batched ConvolutionReverb, heterogeneous ones need
    ReverbGroups (one batched engine per distinct key)."""
    count = settings.u32("conv.count", default=2)
    if count % 2:
        raise ValueError("conv.count must be a multiple of 2 (main.cu:26)")
    keys = []
    for n in range(count // 2):
        fft = settings.u32("conv[%d].fftSize", 2 * n, default=131072)
        fft2 = settings.u32("conv[%d].fftSize", 2 * n + 1, default=fft)
        if fft != fft2:
            raise ValueError(f"convolution pair {n} needs identical fft "
                             f"sizes (main.cu:36): {fft} != {fft2}")
        # every engine-constructor input must be part of the key — pairs
        # differing in maxPredelay must not merge (the CC scaling
        # value*maxpd//128 would silently use the other pair's range)
        max_pd = settings.u32("conv[%d].maxPredelay", 2 * n, default=8192)
        keys.append((fft, max_pd, _resolve_index(settings, 2 * n, root),
                     _resolve_index(settings, 2 * n + 1, root)))
    return keys


def _resolve_index(settings: Settings, idx_ch: int,
                   root: str | None) -> str:
    """conv[idx_ch].index resolved against `root` when not found as-is
    (reference indices list repo-root-relative paths, src/main.cu:72)."""
    index = settings.str("conv[%d].index", idx_ch, default="")
    if index and root and not os.path.exists(index):
        candidate = os.path.join(root, index)
        if os.path.exists(candidate):
            index = candidate
    return index


def _merged_bank(index0: str, index1: str, root, max_ir_seconds,
                 verbose, sample_rate: int = 44100) -> tuple:
    """Build a conv pair's bank + per-channel select windows (reference
    src/main.cu:72-81 loads both indexes into ONE shared map, letting
    channel 1 silently overwrite channel 0 — here differing indexes
    concatenate along the bank axis and each channel addresses its own
    window). Shared by ConvolutionReverb.from_settings and
    ReverbGroups.from_settings.

    sample_rate: the SESSION rate — IRs recorded at another rate are
    resampled on load (a 44.1 kHz IR served verbatim at 48 kHz plays
    ~8.8% short/bright; the reference has no rate handling at all,
    src/wav.cu)."""
    bank = (IRBank.from_index(index0, root=root, verbose=verbose,
                              max_seconds=max_ir_seconds,
                              sample_rate=sample_rate)
            if index0 else IRBank(sample_rate=sample_rate))
    windows = [(0, len(bank))]
    if index1 and index1 != index0:
        bank1 = IRBank.from_index(index1, root=root, verbose=verbose,
                                  max_seconds=max_ir_seconds,
                                  sample_rate=sample_rate)
        offset = bank.extend(bank1)
        windows = [(0, offset), (offset, len(bank1))]
    return bank, windows


class ConvolutionReverb:
    """V stereo voices of convolution reverb over one IR bank."""

    def __init__(self, bank: IRBank, num_voices: int = 1, block: int = 256,
                 sample_rate: int = 44100, engine: str = "fmajor",
                 variant: str = "coef", fft_size: int = 131072,
                 max_predelay: int = 8192, max_partitions: int | None = None,
                 backend: str = "auto", cache_dir: str | None = None,
                 mac_dtype: str = "f32", swap_snapshot: bool = True,
                 cascade_ratio: int = 16, bank_capacity: int | None = None,
                 async_paging: bool = False, predelay_side: str = "write",
                 mac_strategy: str = "auto",
                 fault_upload: str | None = None,
                 ws_exhausted: str = "defer",
                 bank_prep: str = "host"):
        self.bank = bank
        self.block = block
        self.sample_rate = sample_rate
        if getattr(bank, "sample_rate", sample_rate) != sample_rate:
            # from_settings/from_index resample on load; a directly-built
            # bank at another rate would convolve sample-for-sample and
            # play every IR detuned — loud, because it is always a mistake
            Log.warn("reverb", "bank sample rate %d != session rate %d: "
                     "IRs will play %.1f%% off — load the bank with "
                     "sample_rate=%d to resample",
                     bank.sample_rate, sample_rate,
                     abs(1 - bank.sample_rate / sample_rate) * 100,
                     sample_rate)
        self.control = ControlPlane(num_voices, len(bank), max_predelay)
        self.working_set = None
        # bank_prep='device': upload time-domain PCM and compute spectra +
        # MAC packs on-chip (engine/device_prep.py) — the reference's own
        # prepare() architecture (src/conv.cu:207-253: cufft on-GPU, only
        # WAV PCM crosses the bus). ~10-20x less wire than the packed
        # tensors (152-IR 4 s: ~2.1 GB -> 107-215 MB) and no host-side
        # FFT/pack at all. 'host' keeps the numpy prep (CPU test path,
        # and engines device_prep doesn't cover).
        if bank_prep not in ("host", "device"):
            raise ValueError(f"unknown bank_prep {bank_prep!r}")
        if bank_prep == "device" and engine not in ("fmajor", "cascade"):
            raise ValueError(f"bank_prep='device' covers the fmajor and "
                             f"cascade engines, not {engine!r}")
        self.bank_prep = bank_prep
        if fault_upload is None:
            # per-engine resolution: fmajor working-set faults default to
            # 'derived' (half the upload bytes of 'dual' and bit-equal by
            # test); with bank_prep='device' they go all the way to 'td'
            # (time-domain payload, FFT+pack in the slot-update jit — the
            # reference's prepare() architecture applied to faults, ~2x
            # fewer bytes again); other
            # engines have no derived path, so the sentinel resolves to
            # the inert 'dual' without tripping the explicit-flag guard
            if engine == "fmajor":
                fault_upload = "td" if bank_prep == "device" else "derived"
            else:
                fault_upload = "dual"
        if fault_upload != "dual" and engine != "fmajor":
            # never silently ignore: a user comparing fault latencies must
            # know the flag is inert here (cascade faults already upload
            # raw IR samples — the minimal payload — and other engines
            # have no working-set fault path)
            raise ValueError(
                f"fault_upload={fault_upload!r} applies to the fmajor "
                f"engine's working-set faults; engine {engine!r} has "
                f"nothing to derive (cascade faults upload raw samples "
                f"already)")
        if bank_capacity is not None:
            return self._init_working_set(
                bank, num_voices, block, engine, max_predelay,
                max_partitions, backend, cache_dir, mac_dtype,
                cascade_ratio, min(bank_capacity, len(bank)),
                swap_snapshot, sample_rate, async_paging, predelay_side,
                fault_upload, ws_exhausted, bank_prep)
        if engine == "cascade":
            partitions = max_partitions or bank.max_partitions(block)
            ratio = _fit_cascade_ratio(cascade_ratio, num_voices, partitions)
            if ratio != cascade_ratio:
                Log.warn("reverb", "cascade ratio %d adjusted to %d "
                         "(voices=%d must divide, IR partitions=%d must "
                         "exceed 2*ratio)", cascade_ratio, ratio,
                         num_voices, partitions)
            # 'auto' mirrors fmajor: large banks (K*4 > 64 columns) get the
            # 'selected' strategy (per-voice materialized rhs, K-independent
            # per-block cost) instead of the all-K MAC
            self.engine = CascadeConvolution(
                num_voices, block, partitions, ratio=ratio,
                max_predelay=max_predelay, backend=backend,
                num_irs=len(bank), mac_dtype=mac_dtype,
                predelay_side=predelay_side, mac_strategy=mac_strategy)
            if bank_prep == "device":
                from tpu_audio.engine import device_prep
                self.spectra = device_prep.prepare_cascade_bank_device(
                    self.engine, bank)
            else:
                self.spectra = self.engine.prepare_bank(bank,
                                                        cache_dir=cache_dir)
        elif engine == "fmajor":
            partitions = max_partitions or bank.max_partitions(block)
            # swap_snapshot=False only composes with the allk strategy;
            # the auto rule would silently pick 'selected' on big banks
            # (the engine resolves 'auto' itself — num_irs is given)
            strategy = mac_strategy
            if not swap_snapshot and strategy == "auto":
                strategy = "allk"
            self.engine = FMajorPartitionedConvolution(
                num_voices, block, partitions, max_predelay=max_predelay,
                backend=backend, mac_strategy=strategy, num_irs=len(bank),
                mac_dtype=mac_dtype, swap_snapshot=swap_snapshot,
                fault_upload=fault_upload)
            if bank_prep == "device":
                from tpu_audio.engine import device_prep
                self.spectra = device_prep.prepare_fmajor_bank_device(
                    self.engine, bank)
            else:
                if cache_dir:
                    spectra = bank.cached_partitioned_spectra(
                        block, cache_dir, max_partitions=partitions)
                else:
                    spectra = bank.partitioned_spectra(
                        block, max_partitions=partitions)
                # device bank is a pytree of MAC-ready real layouts
                self.spectra = self.engine.prepare_bank(
                    spectra, cache_dir=cache_dir)
        elif engine == "partitioned":
            partitions = max_partitions or bank.max_partitions(block)
            if cache_dir:
                spectra = bank.cached_partitioned_spectra(
                    block, cache_dir, max_partitions=partitions)
            else:
                spectra = bank.partitioned_spectra(
                    block, max_partitions=partitions)
            self.engine = PartitionedConvolution(
                num_voices, block, partitions,
                max_predelay=max_predelay, backend=backend,
                variant=variant)
        elif engine == "monolithic":
            self.engine = MonolithicConvolution(
                num_voices, fft_size, block, max_predelay=max_predelay,
                backend=backend)
            # reserve >= block keeps overlap-add exact; the reference fixes
            # reserve at 1024 regardless of geometry (conv.h:63), which at
            # small fftSize would truncate the whole IR away
            spectra = bank.monolithic_spectra(fft_size,
                                              reserve=max(block, min(
                                                  1024, fft_size // 8)))
        else:
            raise ValueError(f"unknown engine {engine!r}")
        if engine not in ("fmajor", "cascade"):
            self.spectra = device_put_maybe_complex(spectra)
        import jax
        nbytes = sum(leaf.size * leaf.dtype.itemsize
                     for leaf in jax.tree.leaves(self.spectra))
        Log.info("reverb", "%d voice(s), %d IRs, engine=%s, bank %.1f MB",
                 num_voices, len(bank), engine, nbytes / 1e6)

    def _init_working_set(self, bank, num_voices, block, engine,
                          max_predelay, max_partitions, backend, cache_dir,
                          mac_dtype, cascade_ratio, capacity,
                          swap_snapshot, sample_rate, async_paging=False,
                          predelay_side="write", fault_upload="dual",
                          ws_exhausted="defer", bank_prep="host"):
        """Large banks at small-bank speed: the engine runs the fast all-K
        path over `capacity` resident IR slots; the full bank stays on the
        host and select events page IRs in on demand
        (runtime/working_set.py). Engine geometry is sized by the FULL
        bank so any member IR fits its slot.

        bank_prep='device' + fault_upload='td' (the device default) keeps
        the ENTIRE spectra pipeline on-chip: residents upload as
        time-domain PCM and faults upload one [O, L] IR — the host never
        computes a single FFT (the 152-IR host prep alone used to blow
        the bench watchdog; reference src/conv.cu:207-253 semantics)."""
        from tpu_audio.runtime.working_set import WorkingSetBank

        partitions = max_partitions or bank.max_partitions(block)
        residents = list(range(capacity))
        if engine == "cascade":
            ratio = _fit_cascade_ratio(cascade_ratio, num_voices, partitions)
            self.engine = CascadeConvolution(
                num_voices, block, partitions, ratio=ratio,
                max_predelay=max_predelay, backend=backend,
                num_irs=capacity, mac_dtype=mac_dtype,
                predelay_side=predelay_side)
            # (mac_strategy is deliberately NOT forwarded: working-set
            # residency is defined over the all-K MAC's bank slots)
            compact = IRBank(sample_rate=bank.sample_rate)
            for k in residents:
                compact.append(bank.ir(k))
            if bank_prep == "device":
                from tpu_audio.engine import device_prep
                self.spectra = device_prep.prepare_cascade_bank_device(
                    self.engine, compact)
            else:
                # prepare_bank pads the compact sub-bank up to the
                # engine's (full-bank-sized) partition grid
                self.spectra = self.engine.prepare_bank(compact,
                                                        cache_dir=cache_dir)
            payload = bank.ir
        elif engine == "fmajor":
            self.engine = FMajorPartitionedConvolution(
                num_voices, block, partitions, max_predelay=max_predelay,
                backend=backend, mac_strategy="allk", num_irs=capacity,
                mac_dtype=mac_dtype, swap_snapshot=swap_snapshot,
                fault_upload=fault_upload)
            if bank_prep == "device":
                compact = IRBank(sample_rate=bank.sample_rate)
                for k in residents:
                    compact.append(bank.ir(k))
                from tpu_audio.engine import device_prep
                self.spectra = device_prep.prepare_fmajor_bank_device(
                    self.engine, compact)
            else:
                if cache_dir:
                    full_spectra = bank.cached_partitioned_spectra(
                        block, cache_dir, max_partitions=partitions)
                else:
                    full_spectra = bank.partitioned_spectra(
                        block, max_partitions=partitions)
                self.spectra = self.engine.prepare_bank(
                    full_spectra[residents], cache_dir=cache_dir)
            if fault_upload == "td":
                if bank_prep == "host":
                    # allowed (useful for A/B tests) but mixed FFT
                    # provenance: residents carry host-pocketfft spectra
                    # while faulted slots are rebuilt by the device
                    # matmul FFT (~1e-6 relative apart) — re-selecting a
                    # previously-resident IR after its eviction plays
                    # very slightly differently, and the working set's
                    # bit-equality to a full-bank engine becomes
                    # FFT-tolerance equality. Never silent.
                    Log.warn(
                        "reverb", "fault_upload='td' with "
                        "bank_prep='host' mixes host- and device-FFT "
                        "slots in one bank (~1e-6 relative); use "
                        "bank_prep='device' for uniform provenance")
                payload = bank.ir
            elif bank_prep == "device":
                # spectra fault payloads need the host FFT after all —
                # the full-bank prep this mode exists to avoid
                raise ValueError(
                    "bank_prep='device' working sets need "
                    "fault_upload='td' (time-domain fault payloads); "
                    f"{fault_upload!r} would re-run the host FFT over "
                    "the whole bank")
            else:
                payload = lambda k: full_spectra[k: k + 1]
        else:
            raise ValueError(f"bank_capacity (working-set residency) needs "
                             f"engine 'fmajor' or 'cascade', not {engine!r}")
        # the slowest CC-reachable crossfade (speed 127 -> vsteps 1016)
        # plus decay margin sets the eviction protection window: a slot
        # must never be reclaimed while a fade-out still references it
        from tpu_audio.engine.params import CC_MAX_SPEED

        self.working_set = WorkingSetBank(
            self.engine, self.control, payload, self.spectra, residents,
            min_age_blocks=CC_MAX_SPEED + 64, async_paging=async_paging,
            on_exhausted=ws_exhausted)
        self.working_set.on_update = self._publish_bank
        self._live_session = None
        Log.info("reverb", "%d voice(s), %d-IR bank with %d resident "
                 "slots, engine=%s", num_voices, len(bank), capacity, engine)

    def _publish_bank(self, new_bank) -> None:
        self.spectra = new_bank
        if getattr(self, "_live_session", None) is not None:
            # slot updates only touch fade-inert slots (min-age eviction),
            # so the swap is safe to apply directly between blocks
            self._live_session.bank = new_bank

    # -- reference-settings construction (src/main.cu:18-116) --------------------

    @classmethod
    def from_settings(cls, settings: Settings | str, engine: str = "partitioned",
                      root: str | None = None, num_voices: int | None = None,
                      max_ir_seconds: float | None = None,
                      normalize_bank: str | None = None,
                      verbose: bool = True, **kwargs) -> "ConvolutionReverb":
        """Build from a reference-format settings file.

        conv.count / 2 stereo voices (reference asserts count is even,
        src/main.cu:26); per-channel CC mappings + initial values
        (src/main.cu:54-70); IR banks from BOTH channels' index files
        (src/main.cu:72-81). The reference loads both indexes into one
        shared map so channel 1's bank silently overwrites channel 0's
        where they differ; here the capability is implemented correctly:
        differing index files are concatenated along the bank axis and each
        engine channel addresses its own window of the merged bank
        (ControlPlane.set_channel_banks).
        """
        if not isinstance(settings, Settings):
            settings = Settings().open(settings, verbose=verbose)
        count = settings.u32("conv.count", default=2)
        if count % 2:
            raise ValueError("conv.count must be a multiple of 2 (main.cu:26)")
        v = num_voices if num_voices is not None else count // 2
        # a single batched engine shares one geometry across its voices: a
        # heterogeneous file (pairs with different fftSize/maxPredelay/
        # banks) must not silently collapse to pair 0's — that is
        # ReverbGroups' job (one batched engine per distinct geometry)
        keys = pair_geometry_keys(settings, root)
        if len(set(keys)) > 1:
            raise ValueError(
                f"settings file has {len(set(keys))} distinct conv-pair "
                f"geometries (fftSize/maxPredelay/index); a single "
                f"ConvolutionReverb would silently serve them all with "
                f"pair 0's — build ReverbGroups.from_settings instead "
                f"(the CLI routes there automatically)")
        fft_size, max_pd, _, _ = keys[0]
        bank, windows = _merged_bank(
            _resolve_index(settings, 0, root),
            _resolve_index(settings, 1, root), root, max_ir_seconds, verbose,
            sample_rate=kwargs.get("sample_rate", 44100))
        if normalize_bank:
            bank.normalize(mode=normalize_bank)
        model = cls(bank, num_voices=v, engine=engine, fft_size=fft_size,
                    max_predelay=max_pd, **kwargs)
        model.control.set_channel_banks(windows)
        for voice in range(min(v, count // 2)):
            for ch in range(2):
                idx = voice * 2 + ch
                model.control.set_mapping(
                    voice, ch, CCMapping.from_settings(settings, idx))
                model.control.load_initial_values(settings, voice, ch, idx)
        # replicate voice 0's config across extra voices (server scale-out)
        for voice in range(count // 2, v):
            for ch in range(2):
                model.control.set_mapping(voice, ch,
                                          CCMapping.from_settings(settings, ch))
                model.control.load_initial_values(settings, voice, ch, ch)
        return model

    # -- running --------------------------------------------------------------------

    def init_state(self, converged: bool = True):
        if converged:
            import jax
            params = jax.tree.map(jnp.asarray, self.control.snapshot())
            return self.engine.init_converged(self.spectra, params)
        return self.engine.init_state()

    def session(self, source: BlockSource, sink: BlockSink,
                **kwargs) -> StreamSession:
        sess = StreamSession(self.engine, self.spectra, self.control,
                             source, sink, sample_rate=self.sample_rate,
                             **kwargs)
        if self.working_set is not None:
            self._live_session = sess

            def adopt(bank):
                # the session placed the bank on its mesh: future slot
                # updates must start from (and preserve) that placement
                self.spectra = bank
                self.working_set.bank = bank

            sess.on_bank_placed = adopt
            # pre-compile the fault path once placement is final, so the
            # first real bank miss never pays a jit compile mid-stream
            sess.pre_run_hooks.append(self.working_set.warmup)
        return sess

    def process(self, source: BlockSource, sink: BlockSink,
                midi: MidiSchedule | None = None,
                max_blocks: int | None = None, state=None,
                **session_kwargs):
        """Convenience: build a session, run to completion, return
        (final_state, summary dict)."""
        session = self.session(source, sink, **session_kwargs)
        state = state if state is not None else self.init_state()
        state = session.run(state, max_blocks=max_blocks, midi=midi)
        return state, session.summary()

    def render_offline(self, samples, **kwargs):
        """Time-parallel bounce: the time axis is segmented onto virtual
        voices, so throughput scales with the engine's voice ceiling
        instead of the per-block dispatch latency (see runtime/offline.py).
        Renders the control plane's current (converged) parameters, or a
        scripted MIDI timeline via ``schedule=MidiSchedule(...)`` — the
        automation replays in-graph and matches the live streaming session
        to float precision. Returns per-voice output [V, 2, T + tail]."""
        from tpu_audio.runtime.offline import render_offline

        return render_offline(self, samples, **kwargs)


class MultiVoiceReverbServer(ConvolutionReverb):
    """Flagship model: 64+ concurrent stereo voices on the production
    f-major engine (the CLI default and the benchmarked configuration)."""

    def __init__(self, bank: IRBank, num_voices: int = 64, block: int = 256,
                 **kwargs):
        kwargs.setdefault("engine", "fmajor")
        super().__init__(bank, num_voices=num_voices, block=block, **kwargs)


class ReverbGroups:
    """Heterogeneous engine groups from one settings file.

    The reference builds count/2 INDEPENDENT Convolution instances — each
    pair n with its own fftSize and per-channel index files (reference
    src/main.cu:31-39, paired fftSizes asserted equal at main.cu:36) — all
    fed the same stereo capture ports and mixed into the same playback
    ports by the JACK graph (main.cu:86-89, overlapping connections sum).
    ``ConvolutionReverb.from_settings`` covers the homogeneous case (every
    pair shares one geometry); this class covers the general one: pairs
    are grouped by (fftSize, index files), one batched engine per DISTINCT
    geometry (the batched form of N separate instances), and
    ``process`` streams every group over the same input and sums their
    outputs exactly like the reference's JACK wiring.
    """

    def __init__(self, models: list[ConvolutionReverb],
                 pair_ids: list[list[int]]):
        self.models = models
        self.pair_ids = pair_ids  # settings pair indices per group

    @classmethod
    def from_settings(cls, settings: Settings | str, engine: str = "fmajor",
                      root: str | None = None,
                      max_ir_seconds: float | None = None,
                      verbose: bool = True, **kwargs) -> "ReverbGroups":
        if not isinstance(settings, Settings):
            settings = Settings().open(settings, verbose=verbose)
        count = settings.u32("conv.count", default=2)
        groups: dict[tuple, list[int]] = {}
        for n, key in enumerate(pair_geometry_keys(settings, root)):
            groups.setdefault(key, []).append(n)

        models, pair_ids = [], []
        for (fft, max_pd, index0, index1), pairs in groups.items():
            bank, windows = _merged_bank(
                index0, index1, root, max_ir_seconds, verbose,
                sample_rate=kwargs.get("sample_rate", 44100))
            model = ConvolutionReverb(bank, num_voices=len(pairs),
                                      engine=engine, fft_size=fft,
                                      max_predelay=max_pd, **kwargs)
            model.control.set_channel_banks(windows)
            for voice, n in enumerate(pairs):
                for ch in range(2):
                    idx = 2 * n + ch
                    model.control.set_mapping(
                        voice, ch, CCMapping.from_settings(settings, idx))
                    model.control.load_initial_values(settings, voice,
                                                      ch, idx)
            models.append(model)
            pair_ids.append(list(pairs))
        Log.info("reverb", "%d conv pair(s) in %d engine group(s): %s",
                 count // 2, len(models),
                 [(m.engine.__class__.__name__, len(p))
                  for m, p in zip(models, pair_ids)])
        return cls(models, pair_ids)

    def process(self, x: "np.ndarray", midi: MidiSchedule | None = None,
                max_blocks: int | None = None, **session_kwargs):
        """Stream stereo input [2, T] through every group (same input to
        all pairs, like the reference's capture wiring) and return the
        SUMMED stereo output [2, T'] (the JACK playback mix) plus the
        per-group summaries."""
        import numpy as np

        from tpu_audio.runtime.backends import WavSink, WavSource

        total = None
        summaries = []
        for model, pairs in zip(self.models, self.pair_ids):
            source = WavSource(np.asarray(x), num_voices=len(pairs),
                               block=model.block)
            sink = WavSink("/dev/null", model.sample_rate, keep_data=True)
            midi_copy = (MidiSchedule(list(midi._events))
                         if midi is not None else None)
            _, summary = model.process(source, sink, midi=midi_copy,
                                       max_blocks=max_blocks,
                                       **session_kwargs)
            out = sink.data.sum(axis=0)  # sum this group's pairs [2, T']
            if total is None:
                total = out
            else:
                n = min(total.shape[-1], out.shape[-1])
                total = total[..., :n] + out[..., :n]
            summaries.append(summary)
        return total, summaries
