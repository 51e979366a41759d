"""Host streaming loop: the real-time driver around the jitted block step.

Capability equivalent of the reference's JACK process-callback runtime
(reference src/jackclient.cu:4-11 + src/conv.cu:287-466 + src/main.cu:82-95),
restructured for asynchronous device dispatch:

  - the whole block pipeline is ONE jitted function with static shapes and
    DONATED state buffers (no per-block allocation, no recompiles);
  - double buffering via JAX async dispatch: block t's step is dispatched
    before block t-1's output is synced back to the host, overlapping host
    I/O with device compute (the reference overlaps H2D/compute/D2H with 4
    CUDA streams, src/conv.cu:149-153);
  - per-block wall timing with warmup discard (reference _nruns = -10,
    src/conv.h:80), p50/p99, RTF, and a missed-deadline watchdog
    (SURVEY.md §5 failure-detection gap);
  - scripted/live MIDI events are applied between blocks through the
    ControlPlane (reference's per-device MIDI thread, src/midi.cu:22-59);
  - coefficient-engine management: host-side collapse on IR re-select and
    an analytic coef_a tracker that switches to the steady-state step
    (no base term) once every crossfade has decayed — the hot path then
    never touches the reference's "most time consuming" interpolation.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from tpu_audio.engine.params import ControlPlane
from tpu_audio.runtime.backends import BlockSink, BlockSource
from tpu_audio.utils.log import Log
from tpu_audio.utils.transfer import device_put_maybe_complex
from tpu_audio.utils.profiling import BlockTimer

STEADY_THRESHOLD = 1e-6  # coef_a below this ≈ crossfade fully decayed


class MidiSchedule:
    """Scripted MIDI event stream: (block_index, device, message_bytes)."""

    def __init__(self, events: list[tuple[int, str, bytes]] = ()):  # noqa: B006
        self._events = sorted(events, key=lambda e: e[0])
        self._next = 0

    @classmethod
    def parse(cls, text: str) -> "MidiSchedule":
        """One event per line: ``<block> [dev=<id>] <hex bytes...>``, e.g.
        ``100 B0 15 40`` or ``100 dev=hw:2,0 B0 15 40``. '#' comments.

        An explicit ``dev=`` prefix is unambiguous and preferred; a bare
        second token containing a non-hex character is still accepted as a
        device id for backward compatibility (note the legacy heuristic
        silently consumes all-hex device ids like ``a1`` as data bytes —
        use ``dev=`` for those)."""
        def is_hex(tok: str) -> bool:
            return all(c in "0123456789abcdefABCDEF" for c in tok) and len(tok) <= 2

        events = []
        for lineno, raw in enumerate(text.splitlines(), start=1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            tokens = line.split()
            rest = tokens[1:]
            device = ""
            if rest and rest[0].startswith("dev="):
                device, rest = rest[0][4:], rest[1:]
            elif rest and not is_hex(rest[0]):
                device, rest = rest[0], rest[1:]
            try:
                block = int(tokens[0])
                data = bytes(int(t, 16) for t in rest)
            except ValueError as exc:
                raise ValueError(
                    f"MIDI schedule line {lineno}: {exc} "
                    f"(line was: {raw.strip()!r}; format is "
                    f"'<block> [dev=<id>] <hex bytes 00-FF...>')") from exc
            events.append((block, device, data))
        return cls(events)

    def pop_due(self, block_index: int) -> list[tuple[str, bytes]]:
        due = []
        while (self._next < len(self._events)
               and self._events[self._next][0] <= block_index):
            _, device, data = self._events[self._next]
            due.append((device, data))
            self._next += 1
        return due

    def rewind_to(self, block_index: int) -> None:
        """Reposition so events at blocks >= block_index replay (crash
        recovery: events before the checkpoint are baked into the restored
        control plane; events after it must fire again)."""
        self._next = 0
        while (self._next < len(self._events)
               and self._events[self._next][0] < block_index):
            self._next += 1


class StreamSession:
    """Drives (source -> jitted engine step -> sink) to completion."""

    def __init__(self, engine, bank, control: ControlPlane,
                 source: BlockSource, sink: BlockSink,
                 sample_rate: int = 44100, warmup: int = 10,
                 donate: bool = True, realtime: bool = False,
                 on_missed_deadline=None, pipeline_depth: int = 1,
                 underrun_policy: str = "stop", chunk_blocks: int = 1,
                 max_consecutive_underruns: int | None = None,
                 clock: str = "sleep", fetch_batch: int = 1,
                 wire: str = "f32", mesh=None):
        self.engine = engine
        # mesh: serve over a jax.sharding.Mesh — the step/collapse functions
        # compile with the engine's mesh shardings (parallel/mesh.py), the
        # bank and state are placed once, and everything else (params
        # upload, MIDI, working-set faults, checkpoints — host gathers via
        # np.asarray) rides the same code path. One device = the degenerate
        # mesh. Per-block dispatch only (chunking scans on one device).
        self.mesh = mesh
        if mesh is not None and chunk_blocks > 1:
            raise ValueError("mesh serving uses per-block dispatch "
                             "(chunk_blocks must be 1)")
        # bank may be a raw (possibly complex) host array or an already-
        # device-resident pytree (e.g. FMajorBank)
        self.bank = jax.tree.map(
            lambda leaf: leaf if isinstance(leaf, jax.Array)
            else device_put_maybe_complex(leaf), bank)
        self.control = control
        self.source = source
        self.sink = sink
        self.sample_rate = sample_rate
        self.realtime = realtime
        # realtime pacing source: "sleep" = perf_counter + time.sleep;
        # "native" = the C++ absolute-deadline clock (clock_nanosleep,
        # drift-free, re-anchors after late blocks — the equivalent of
        # the reference riding the JACK server's period clock)
        if clock not in ("sleep", "native"):
            raise ValueError(f"unknown clock {clock!r}")
        self.clock = clock
        # how many blocks may be in flight between dispatch and sink
        # delivery: 1 = minimum latency (local hardware); raise it on
        # high-latency host links to hide transfer RTT
        self.pipeline_depth = max(1, pipeline_depth)
        # "stop": end the stream when the source runs dry (file processing);
        # "silence": substitute silent blocks and keep real time (live rings
        # whose producer hiccups — the reverb tail keeps flowing), bounded
        # only by max_consecutive_underruns (None = ride out any outage;
        # a blocking RingSource already converts each None into a timeout,
        # so the session survives producer restarts indefinitely)
        if underrun_policy not in ("stop", "silence"):
            raise ValueError(f"unknown underrun_policy {underrun_policy!r}")
        self.underrun_policy = underrun_policy
        self.max_consecutive_underruns = max_consecutive_underruns
        self.underruns = 0
        self._consecutive_underruns = 0
        # chunk_blocks > 1: scan N blocks per dispatch (one transfer pair per
        # chunk) — throughput mode for offline processing / high-RTT links;
        # MIDI and parameter changes then apply at chunk granularity
        self.chunk_blocks = max(1, chunk_blocks)
        # fetch_batch > 1: keep PER-BLOCK dispatch (the scan-based chunk
        # mode copies its carries instead of aliasing them) but
        # batch the device->host output fetches: every N outputs are
        # stacked in one dispatch and transferred together, amortising the
        # per-request round trip on high-RTT links. Adds N blocks of
        # delivery latency; per-block MIDI/params/steady-switching all keep
        # single-block granularity. pipeline_depth then counts batches.
        self.fetch_batch = max(1, fetch_batch)
        if self.fetch_batch > 1 and self.chunk_blocks > 1:
            raise ValueError("fetch_batch and chunk_blocks are exclusive")
        # wire="pcm16" (fetch_batch mode): encode batched outputs to 16-bit
        # PCM on-device before the transfer — half the bytes on the host
        # link, and zero net loss when the sink is 16-bit anyway (the
        # engine computes f32 throughout; this is the DAC wire format,
        # single-sourced in tpu_audio.utils.wire)
        if wire not in ("f32", "pcm16"):
            raise ValueError(f"unknown wire format {wire!r}")
        if wire != "f32" and self.fetch_batch == 1:
            raise ValueError("wire='pcm16' requires fetch_batch > 1 "
                             "(per-block delivery always transfers f32)")
        self.wire = wire
        self._pending_bank = None
        self._regather = None
        self._materialize = None
        self._swap_wait_logged = False
        # cooperative stop for unbounded live sessions (the reference parks
        # its main thread on stdin and quits on Enter, src/main.cu:95);
        # set from any thread, honoured at the next block boundary
        self._stop_requested = False
        self._stack = None
        self._batch_tprev = None
        self.block_period = engine.block / sample_rate
        # warmup is counted in blocks; in chunked mode the first dispatch
        # (which absorbs compilation) contributes chunk_blocks records, so
        # discard at least two whole chunks
        effective_warmup = (max(warmup, 2 * self.chunk_blocks)
                            if self.chunk_blocks > 1 else warmup)
        self.timer = BlockTimer(warmup=effective_warmup,
                                deadline_s=self.block_period)
        self.on_missed_deadline = on_missed_deadline
        self._missed_logged = 0
        # fired once per run(), AFTER mesh bank placement and before the
        # first block — the seam for warm-up work that must see the
        # serving-final bank placement (e.g. the working set pre-compiling
        # its fault path, models/reverb.py:session)
        self.pre_run_hooks: list = []

        donate_args = (0,) if donate else ()
        self._donate = donate
        self._is_coef = (getattr(engine, "variant", None) == "coef"
                         and hasattr(engine, "step_coef"))
        if mesh is not None:
            self._build_sharded(mesh, donate)
        elif self._is_coef:
            if self.chunk_blocks > 1:
                from tpu_audio.engine.fmajor import make_chunk_step
                full = make_chunk_step(engine, steady=False)
                steady = make_chunk_step(engine, steady=True)
            else:
                full, steady = engine.step_coef, engine.step_coef_steady
            self._step_full = jax.jit(full, donate_argnums=donate_args)
            self._step_steady = jax.jit(steady, donate_argnums=donate_args)
            self._collapse = jax.jit(engine.collapse, donate_argnums=donate_args)
            self._collapse_takes_new_select = (
                getattr(engine, "mac_strategy", None) == "selected")
            # the cascade's materializing collapse also rescales in-flight
            # tail slots, which needs the post-change vsteps/predelay
            self._collapse_takes_params = getattr(
                engine, "collapse_takes_params", False)
            # analytic host mirror of coef_a for the steady-state switch
            self._a_host = np.zeros((engine.num_voices, 2), np.float64)
            self._pending_old: dict[tuple[int, int], int] = {}
            control.on_select_change = self._note_select_change
            # indexed-fade path (allk fmajor): when every fading voice's
            # snapshot is span-represented (provenance carried in
            # FMajorState.base_g/base_pure), mid-fade blocks reuse the
            # steady all-K MAC (step_coef_indexed) and re-selects —
            # converged AND interrupted — collapse with a [V,2,K]-sized
            # collapse_pure instead of a snapshot rewrite. The span only
            # breaks on a bank swap mid-fade, which materializes `base` and
            # routes those fades through the general step. The host keeps a
            # purity mirror (_pure_host) for step selection only; the truth
            # is in state.
            self._step_indexed = None
            self._collapse_pure = None
            if (getattr(engine, "mac_strategy", None) == "allk"
                    and hasattr(engine, "step_coef_indexed")):
                if self.chunk_blocks > 1:
                    from tpu_audio.engine.fmajor import make_chunk_step
                    idx_fn = make_chunk_step(engine, indexed=True)
                else:
                    idx_fn = engine.step_coef_indexed
                self._step_indexed = jax.jit(idx_fn,
                                             donate_argnums=donate_args)
                self._collapse_pure = jax.jit(engine.collapse_pure,
                                              donate_argnums=donate_args)
                # the cascade engine rescales in-flight tail slots at
                # collapse, which needs the new fade's vsteps + predelay
                self._collapse_pure_params = getattr(
                    engine, "collapse_pure_takes_params", False)
            self._pure_host = np.zeros((engine.num_voices, 2), bool)
        else:
            self._step_full = jax.jit(engine.step, donate_argnums=donate_args)
            self._step_steady = None

    # -- mesh serving ---------------------------------------------------------------

    def _build_sharded(self, mesh, donate: bool) -> None:
        """Compile the session's step/collapse functions with the engine's
        mesh shardings and place the bank (SURVEY §5's distributed-comms
        requirement at the SERVING level, not just the function level):
        fmajor shards voices (and partitions in roll mode), the cascade
        runs a communication-free voice-DP shard_map. Checkpoint saves
        gather through np.asarray; restored host states are re-placed at
        run start."""
        if not self._is_coef:
            raise ValueError("mesh serving supports coef-interface engines "
                             "(fmajor, cascade, partitioned-coef)")
        from tpu_audio.engine.cascade import CascadeConvolution
        from tpu_audio.engine.fmajor import FMajorPartitionedConvolution
        from tpu_audio.parallel import mesh as pm

        engine = self.engine
        self._a_host = np.zeros((engine.num_voices, 2), np.float64)
        self._pending_old: dict[tuple[int, int], int] = {}
        self.control.on_select_change = self._note_select_change
        self._pure_host = np.zeros((engine.num_voices, 2), bool)
        self._step_indexed = None
        self._collapse_pure = None
        self._collapse = None
        self._collapse_takes_new_select = (
            getattr(engine, "mac_strategy", None) == "selected")
        self._collapse_takes_params = getattr(
            engine, "collapse_takes_params", False)
        self._collapse_pure_params = getattr(
            engine, "collapse_pure_takes_params", False)
        if isinstance(engine, CascadeConvolution):
            selected = getattr(engine, "mac_strategy", None) == "selected"
            self._step_steady = pm.shard_cascade_step(engine, mesh,
                                                      "steady", donate)
            if selected:
                # 'selected': fades run the general step over the
                # materialized per-voice rhs; re-selects run the
                # materializing collapse — both voice-local shard_maps
                self._step_full = pm.shard_cascade_step(engine, mesh,
                                                        "full", donate)
                self._collapse = pm.shard_cascade_collapse(engine, mesh,
                                                           donate)
            else:
                # span-only 'allk': no materializing path exists; the
                # indexed step serves every fade (purity always holds)
                indexed = pm.shard_cascade_step(engine, mesh, "indexed",
                                                donate)
                self._step_indexed = indexed
                self._step_full = indexed
                self._collapse_pure = pm.shard_cascade_collapse_pure(
                    engine, mesh, donate)
            self._place_state = lambda st: pm.place_cascade_state(
                st, mesh, selected)
            self._place_bank = lambda b: pm.place_cascade_bank(b, mesh)
        elif isinstance(engine, FMajorPartitionedConvolution):
            self._step_steady = pm.shard_fmajor_step(engine, mesh,
                                                     mode="steady",
                                                     donate=donate)
            self._step_full = pm.shard_fmajor_step(engine, mesh, mode="full",
                                                   donate=donate)
            if (getattr(engine, "mac_strategy", None) == "allk"
                    and hasattr(engine, "step_coef_indexed")):
                self._step_indexed = pm.shard_fmajor_step(
                    engine, mesh, mode="indexed", donate=donate)
                self._collapse_pure = pm.shard_fmajor_collapse_pure(
                    engine, mesh, donate)
            self._collapse = pm.shard_fmajor_collapse(engine, mesh, donate)
            state_sh, bank_sh, _, _ = pm.fmajor_shardings(mesh, engine)
            self._place_state = lambda st: jax.device_put(st, state_sh)
            self._place_bank = lambda b: jax.device_put(b, bank_sh)
        else:
            self._step_steady = pm.shard_partitioned_step(engine, mesh,
                                                          steady=True,
                                                          donate=donate)
            self._step_full = pm.shard_partitioned_step(engine, mesh,
                                                        donate=donate)
            self._collapse = pm.shard_collapse(engine, mesh, donate)
            state_sh, _, _, _ = pm.partitioned_shardings(mesh, engine)
            self._place_state = lambda st: jax.device_put(st, state_sh)
            self._place_bank = lambda b: pm.place_bank(b, mesh)
        # bank placement is deferred to run() start so bank-owning
        # subsystems (the working set's on_bank_placed adoption) — wired
        # by the model AFTER this constructor — see the placed bank
        self._mesh_bank_placed = False

    # -- coef-engine hooks ---------------------------------------------------------

    def _note_select_change(self, voice: int, ch: int, old: int, new: int) -> None:
        # keep the select the engine last stepped with (first change wins
        # between two steps)
        self._pending_old.setdefault((voice, ch), old)

    def _indexed_valid(self) -> bool:
        """True when every voice whose fade still matters (a >= threshold)
        has span provenance in state — the indexed step / collapse_pure
        precondition. Converged voices' base terms are < -120 dB, so stale
        provenance there never gates."""
        return bool((self._pure_host
                     | (self._a_host < STEADY_THRESHOLD)).all())

    def _maybe_collapse(self, state):
        if not self._pending_old:
            return state
        # collapse_pure (a [V,2,K]-sized span update — the re-select block
        # then costs the same as a steady block) is valid iff the pre-state
        # was indexed-valid: every changed voice is then either pure (the
        # affine re-base stays in the span EXACTLY, interrupted fades
        # included) or converged (its stale span restarts at c*onehot).
        # Only a bank swap mid-fade breaks purity and routes re-selects
        # through the materializing collapse below.
        use_pure = (self._collapse_pure is not None
                    and self._step_indexed is not None
                    and self._indexed_valid())
        new_sel = self.control.select.copy()
        old_sel = new_sel.copy()
        changed = np.zeros_like(old_sel, dtype=bool)
        for (v, ch), old in self._pending_old.items():
            old_sel[v, ch] = old
            changed[v, ch] = True
            self._a_host[v, ch] = 1.0
            self._pure_host[v, ch] = use_pure
        self._pending_old.clear()
        if use_pure:
            if getattr(self, "_collapse_pure_params", False):
                return self._collapse_pure(state, jnp.asarray(old_sel),
                                           jnp.asarray(changed),
                                           self.control.snapshot_device())
            return self._collapse_pure(state, jnp.asarray(old_sel),
                                       jnp.asarray(changed))
        # materializing collapse: every voice's base becomes a valid tensor
        # (virtual snapshots are materialized in-graph), so the general
        # fade step may read state.base for anyone afterwards
        self._pure_host[:] = False
        args = (state, self.bank, jnp.asarray(old_sel), jnp.asarray(changed))
        if self._collapse_takes_new_select:
            args += (jnp.asarray(new_sel),)
        if getattr(self, "_collapse_takes_params", False):
            args += (self.control.snapshot_device(),)
        return self._collapse(*args)

    def _materialize_base(self, state):
        """Materialize virtual fade snapshots with NO re-select (bank-swap
        and resume paths). Prefers the engine's static `materialize_base`
        — `collapse` with a traced all-False `changed` cannot dead-code-
        eliminate the re-select gathers, which read the entire bank at
        'selected' scale only to discard the result."""
        fn = getattr(self.engine, "materialize_base", None)
        if fn is not None:
            if self._materialize is None:
                self._materialize = jax.jit(fn)
            state = self._materialize(state, self.bank)
        else:
            no_change = jnp.zeros((self.engine.num_voices, 2), jnp.bool_)
            sel_now = jnp.asarray(self.control.select)
            args = (state, self.bank, sel_now, no_change)
            if self._collapse_takes_new_select:
                args += (sel_now,)
            if getattr(self, "_collapse_takes_params", False):
                args += (self.control.snapshot_device(),)
            state = self._collapse(*args)
        self._pure_host[:] = False
        return state

    def stop(self) -> None:
        """Request a clean end of run() at the next block boundary —
        callable from another thread (e.g. a stdin watcher, the
        reference's cin.get() park at src/main.cu:95)."""
        self._stop_requested = True

    def _underrun_stop(self) -> bool:
        """Account one silence-substituted underrun; True when the
        consecutive-underrun cap says the session should end instead."""
        self.underruns += 1
        self._consecutive_underruns += 1
        if (self.max_consecutive_underruns is not None
                and self._consecutive_underruns > self.max_consecutive_underruns):
            Log.warn("stream", "source dry for %d consecutive blocks; stopping",
                     self._consecutive_underruns - 1)
            return True
        return False

    # -- main loop ---------------------------------------------------------------------

    def swap_bank(self, bank) -> None:
        """Live IR-bank replacement (the reference's `prepare` reload path,
        src/conv.cu:206-253, made actually safe): the swap is applied
        between blocks (or at the next run start). Before switching, any
        VIRTUAL fade snapshot (deferred collapse: base == gain *
        old_bank[sel]) is materialized against the OLD bank, and the
        'selected' strategy's per-voice spectra are re-gathered from the
        new bank — so fade tails keep the old sound and the steady path
        plays the new bank from the swap block on. No recompile while the
        geometry [K, P, F] matches."""
        if self.mesh is not None:
            self._pending_bank = self._place_bank(bank)
            return
        self._pending_bank = jax.tree.map(
            lambda leaf: leaf if isinstance(leaf, jax.Array)
            else device_put_maybe_complex(leaf), bank)

    def _apply_pending_bank(self, state):
        if self._pending_bank is None:
            return state
        if (self._is_coef
                and not getattr(self.engine, "swap_snapshot", True)
                and bool((self._a_host >= STEADY_THRESHOLD).any())):
            # span-only engine (swap_snapshot=False): there is nothing to
            # materialize the old bank's fade tails into, so the swap
            # waits for in-flight crossfades to decay — bounded by the
            # fade time ONLY while no new fades start. Continuous MIDI
            # select churn resets coef_a to 1.0 on every re-select and can
            # defer a live swap indefinitely (a documented livelock: the
            # swap needs one full fade window of select silence); the
            # periodic re-log below keeps that visible instead of a single
            # line scrolling away.
            self._swap_deferred_blocks = getattr(
                self, "_swap_deferred_blocks", 0) + 1
            if not self._swap_wait_logged:
                self._swap_wait_logged = True
                Log.info("stream", "bank swap deferred until in-flight "
                         "crossfades decay (span-only engine)")
            elif self._swap_deferred_blocks % 500 == 0:
                Log.warn("stream", "bank swap still deferred after %d "
                         "blocks — continuous re-selects keep fades in "
                         "flight; pause select events for one fade window "
                         "to let the swap through",
                         self._swap_deferred_blocks)
            return state
        self._swap_deferred_blocks = 0
        self._swap_wait_logged = False
        new_bank = self._pending_bank
        self._pending_bank = None
        # keep the swapped-in bank in the serving placement: mesh sessions
        # would otherwise re-place it on every dispatch
        if self.mesh is not None and self._mesh_bank_placed:
            new_bank = self._place_bank(new_bank)
        if self._is_coef and hasattr(state, "base_pure"):
            if not getattr(self.engine, "swap_snapshot", True):
                # span-only engine: the deferral above guarantees every
                # fade has decayed, so the old-bank span coefficients are
                # inert (a < threshold) — zero them so no stale provenance
                # is reinterpreted against the new bank
                from dataclasses import replace as _replace
                state = _replace(state,
                                 base_g=jnp.zeros_like(state.base_g))
            elif bool(np.asarray(state.base_pure).any()):
                # materialize virtual snapshots against the OLD bank: the
                # fade-out tail must keep playing the old bank's sound
                state = self._materialize_base(state)
            if self._collapse_takes_new_select:
                # 'selected' strategy: the steady MAC reads materialized
                # per-voice spectra — re-gather them from the NEW bank
                # (engine-provided: fmajor re-points sel_spectra, the
                # cascade its sel_head/sel_tail rhs)
                if self._regather is None:
                    self._regather = jax.jit(self.engine.regather_selection)
                state = self._regather(state, new_bank,
                                       jnp.asarray(self.control.select))
        self.bank = new_bank
        return state

    def run(self, state, max_blocks: int | None = None,
            midi: MidiSchedule | None = None, live_midi=None,
            checkpoint_path=None, checkpoint_every: int | None = None,
            start_block: int = 0):
        """Stream until the source ends (or max_blocks). Returns final state.

        checkpoint_path + checkpoint_every: periodically persist the full
        engine state + control plane (runtime.checkpoint) so a poisoned
        device session can be rebuilt and resumed (see runtime.recovery).
        Each save forces a device->host sync of the state — size the
        interval accordingly. start_block offsets the reported block
        indices (resume bookkeeping).
        """
        import collections
        import time

        if self.mesh is not None:
            # (re-)place the state on the mesh: fresh inits and checkpoint-
            # restored host states alike land on the serving shardings
            state = self._place_state(state)
            if not self._mesh_bank_placed:
                self._mesh_bank_placed = True
                self.bank = self._place_bank(self.bank)
                if getattr(self, "on_bank_placed", None) is not None:
                    self.on_bank_placed(self.bank)
        for hook in self.pre_run_hooks:
            hook()
        if self._is_coef:
            # resync the analytic coef mirrors from the (possibly restored-
            # from-checkpoint) state so a mid-crossfade resume keeps using
            # the full step until the fade actually decays; snapshot
            # provenance is state-carried, so purity survives restores
            self._a_host = np.asarray(state.coef_a, np.float64)
            if hasattr(state, "base_pure"):
                self._pure_host = np.asarray(state.base_pure).copy()
                if (self._step_indexed is None
                        and bool((self._pure_host
                                  & (self._a_host >= STEADY_THRESHOLD)).any())):
                    # a span-collapsed fade is in flight but this session
                    # cannot run the indexed step (chunked mode):
                    # materialize the virtual snapshots once so the general
                    # fade reads a valid base tensor
                    state = self._materialize_base(state)
            else:
                self._pure_host = np.zeros_like(self._pure_host)

        pending = collections.deque()
        batch_acc = []
        self._batch_tprev = None
        block_index = 0
        chunk = self.chunk_blocks
        next_deadline = time.perf_counter() + chunk * self.block_period
        native_clock = None
        if self.realtime and self.clock == "native":
            from tpu_audio.runtime.native import native_available, NativeBlockClock
            if native_available():
                native_clock = NativeBlockClock(chunk * self.block_period)
            else:
                Log.warn("stream", "native clock unavailable; using sleep")

        while max_blocks is None or block_index < max_blocks:
            if self._stop_requested:
                # consume the request (a stop may arrive before the loop
                # even starts, e.g. Enter pressed during jit compile)
                self._stop_requested = False
                break
            if chunk == 1:
                x = self.source.read()
                if x is None:
                    if self.underrun_policy == "stop" or self._underrun_stop():
                        break
                    x = np.zeros((self.engine.num_voices, 2,
                                  self.engine.block), np.float32)
                else:
                    self._consecutive_underruns = 0
                n_valid = 1
            else:
                # gather a chunk; zero-pad a partial tail (trimmed on
                # write). Cap at the caller's max_blocks — a full-chunk
                # gather would render and DELIVER up to chunk-1 blocks the
                # caller never asked for.
                stop = False
                xs = []
                want = chunk if max_blocks is None else min(
                    chunk, max_blocks - block_index)
                while len(xs) < want:
                    blk = self.source.read()
                    if blk is None:
                        if (self.underrun_policy == "stop"
                                or self._underrun_stop()):
                            stop = True
                            break
                        blk = np.zeros((self.engine.num_voices, 2,
                                        self.engine.block), np.float32)
                    else:
                        self._consecutive_underruns = 0
                    xs.append(blk)
                if not xs:
                    break
                n_valid = len(xs)
                while len(xs) < chunk:
                    xs.append(np.zeros_like(xs[0]))
                x = np.stack(xs)

            if midi is not None:
                for device, message in midi.pop_due(start_block + block_index):
                    self.control.apply_midi_message(message, device)
            if live_midi is not None:
                for device, message in live_midi.poll():
                    self.control.apply_midi_message(message, device)

            self.timer.start()
            indexed = False
            state = self._apply_pending_bank(state)
            if self._is_coef:
                state = self._maybe_collapse(state)
                vsteps = self.control.vsteps.astype(np.float64)
                steady = bool((self._a_host < STEADY_THRESHOLD).all())
                if steady:
                    step = self._step_steady
                elif self._step_indexed is not None and self._indexed_valid():
                    step = self._step_indexed
                    indexed = True
                else:
                    step = self._step_full
                # advance the analytic coef_a mirror exactly like the
                # device recursion does (collapse_pure reads the TRUE gain
                # from device state.coef_c, so no c mirror is needed)
                for _ in range(chunk):
                    self._a_host *= 1.0 - 1.0 / (vsteps + 5.0)
                    vsteps = np.maximum(vsteps - 1.0, 0.0)
            else:
                step = self._step_full

            params = self.control.snapshot_device()
            if indexed:
                self.indexed_blocks = getattr(self, "indexed_blocks", 0) + 1
            state, out = step(state, self.bank, params, jnp.asarray(x))
            for _ in range(chunk):
                self.control.end_block()

            # pipelined delivery: start this block's device->host copy now,
            # deliver the block from `pipeline_depth` steps ago (depth 1 ==
            # classic double buffering). With fetch_batch > 1, outputs are
            # first stacked on-device in batches and fetched together.
            if self.fetch_batch > 1:
                batch_acc.append(out)
                if len(batch_acc) == self.fetch_batch:
                    self._enqueue_batch(batch_acc, pending)
                    batch_acc = []
            else:
                try:
                    out.copy_to_host_async()
                except Exception:
                    pass
                pending.append((out, n_valid))
            if len(pending) >= self.pipeline_depth + 1:
                self._deliver(*pending.popleft())

            if self.fetch_batch > 1:
                elapsed = 0.0  # recorded per batch at delivery time
            elif chunk == 1:
                elapsed = self.timer.stop()
            else:
                # record per-block equivalents of the chunk's wall time
                chunk_elapsed = time.perf_counter() - self.timer._t0
                elapsed = chunk_elapsed / n_valid
                for _ in range(n_valid):
                    self.timer.record(elapsed)
            if (self.timer.deadline_s is not None
                    and elapsed > self.timer.deadline_s
                    and self.timer.missed > self._missed_logged):
                self._missed_logged = self.timer.missed
                if self.on_missed_deadline is not None:
                    self.on_missed_deadline(block_index, elapsed)
                else:
                    Log.debug("stream", "missed deadline at block %d: %.2f ms",
                              block_index, elapsed * 1e3)

            if self.realtime:
                if native_clock is not None:
                    native_clock.wait()
                else:
                    now = time.perf_counter()
                    if now < next_deadline:
                        time.sleep(next_deadline - now)
                    next_deadline += chunk * self.block_period

            block_index += n_valid
            if (checkpoint_path is not None and checkpoint_every
                    and block_index % checkpoint_every < n_valid):
                # drain in-flight deliveries FIRST: a checkpoint must never
                # get ahead of the sink, or a crash between save and
                # delivery would lose the undelivered blocks on resume
                if batch_acc:
                    self._enqueue_batch(batch_acc, pending)
                    batch_acc = []
                while pending:
                    self._deliver(*pending.popleft())
                # let subsystems publish in-flight host-side work (async
                # working-set drain: pending uploads + deferred selects)
                # so the checkpoint captures a consistent world
                for hook in self.control.pre_checkpoint_hooks:
                    hook()
                from tpu_audio.runtime.checkpoint import save_checkpoint
                save_checkpoint(checkpoint_path, state, self.control,
                                meta={"block_index":
                                      start_block + block_index})
            if chunk > 1 and stop:
                break  # source ended (exhausted, or underrun cap) mid-chunk

        if batch_acc:
            self._enqueue_batch(batch_acc, pending)
        while pending:
            self._deliver(*pending.popleft())
        if native_clock is not None:
            native_clock.close()
        self.sink.close()
        self.blocks_streamed = getattr(self, "blocks_streamed", 0) + block_index
        return state

    def _enqueue_batch(self, outs: list, pending) -> None:
        """Stack N per-block outputs in one device dispatch and start their
        combined device->host transfer (fetch_batch mode)."""
        import jax as _jax
        import jax.numpy as _jnp

        if self._stack is None:
            if self.wire == "pcm16":
                from tpu_audio.utils.wire import encode_pcm16
                self._stack = _jax.jit(
                    lambda *o: encode_pcm16(_jnp.stack(o)))
            else:
                self._stack = _jax.jit(lambda *o: _jnp.stack(o))
        stacked = self._stack(*outs)
        try:
            stacked.copy_to_host_async()
        except Exception:
            pass
        pending.append((stacked, len(outs)))

    def _deliver(self, out, n_valid: int) -> None:
        """Write a step output to the sink: one block, or the valid prefix
        of a chunked/batched [T, V, 2, B] output."""
        host = np.asarray(out)
        if host.dtype == np.int16:  # pcm16 wire: decode after the transfer
            from tpu_audio.utils.wire import decode_pcm16
            host = decode_pcm16(host)
        if self.chunk_blocks == 1 and self.fetch_batch == 1:
            self.sink.write(host)
            return
        for t in range(n_valid):
            self.sink.write(host[t])
        if self.fetch_batch > 1:
            # sustained pace accounting: inter-batch wall time / blocks
            import time as _time
            now = _time.perf_counter()
            if self._batch_tprev is not None:
                per_block = (now - self._batch_tprev) / n_valid
                for _ in range(n_valid):
                    self.timer.record(per_block)
                # the per-iteration watchdog never sees batch times, so
                # fire the missed-deadline hook from here
                if (self.timer.deadline_s is not None
                        and per_block > self.timer.deadline_s
                        and self.timer.missed > self._missed_logged):
                    self._missed_logged = self.timer.missed
                    if self.on_missed_deadline is not None:
                        self.on_missed_deadline(self.timer.count, per_block)
                    else:
                        Log.debug("stream",
                                  "missed deadline near block %d: %.2f ms",
                                  self.timer.count, per_block * 1e3)
            self._batch_tprev = now

    # -- reporting ------------------------------------------------------------------------

    def summary(self) -> dict:
        s = self.timer.summary(self.block_period)
        s["sample_rate"] = self.sample_rate
        s["block"] = self.engine.block
        s["num_voices"] = self.engine.num_voices
        s["blocks_streamed"] = getattr(self, "blocks_streamed", 0)
        s["underruns"] = getattr(self, "underruns", 0)
        return s

    def log_summary(self) -> None:
        s = self.summary()
        Log.info("stream", "Average convolution runtime: %f ms "
                 "(rtf %.2f, p99 %.3f ms, %d/%d deadlines missed)",
                 s["avg_ms"], s.get("rtf", 0), s["p99_ms"],
                 s["missed_deadlines"], s["blocks"])
