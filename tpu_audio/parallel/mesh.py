"""Multi-device scaling: device mesh + shardings for the voice server.

The reference is strictly single-GPU (SURVEY.md §2: no NCCL/MPI/collectives
anywhere); its only scaling axes are CUDA streams and multiple engine
instances on one device. This framework scales over a device mesh (GPUs
joined by NVLink, or virtual CPU devices in tests) with two axes:

  - ``voice``: data parallelism over concurrent reverb voices. Voices are
    independent, so the hot loop is communication-free along this axis —
    the interconnect carries only input/output distribution.
  - ``part``: sequence parallelism over the IR partition axis (the moral
    equivalent of blockwise/ring attention over sequence length,
    SURVEY.md §5): the frequency-domain delay line, the IR bank, and the
    crossfade base spectra all shard over partitions, the per-chip MAC
    produces partial spectra, and XLA inserts the psum over ``part`` plus
    the one-slot boundary shift of the delay-line roll (a collective
    permute) automatically from the shardings.

Implementation: GSPMD via jit + NamedSharding — annotate every state leaf,
the bank, params, and I/O blocks with PartitionSpecs and let XLA place
collectives. A single device is the degenerate 1x1 mesh with zero
overhead, so the same step function serves laptop CPU tests, one GPU, and a
multi-GPU host (SURVEY.md §5 comms-layer requirement).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_audio.engine.params import VoiceParams
from tpu_audio.engine.partitioned import PartitionedConvolution, PartitionedState
from tpu_audio.utils.log import Log
from tpu_audio.utils.transfer import device_put_maybe_complex


def make_mesh(n_devices: int | None = None, part: int | None = None,
              devices=None) -> Mesh:
    """Build a ('voice', 'part') mesh over the first n devices.

    `part` defaults to 1 (pure voice-DP — communication-free hot loop).
    Set part > 1 to shard the IR partition axis (huge IRs / few voices).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    part = part or 1
    if n % part:
        raise ValueError(f"part axis {part} does not divide {n} devices")
    voice = n // part
    arr = np.asarray(devices).reshape(voice, part)
    mesh = Mesh(arr, axis_names=("voice", "part"))
    Log.info("mesh", "%d device(s): voice=%d x part=%d on %s",
             n, voice, part, devices[0].platform)
    return mesh


# -- sharding specs ------------------------------------------------------------------

_STATE_SPECS = dict(
    fdl=P("voice", None, "part", None),        # [V, 2, P, F]
    prev_in=P("voice", None, None),            # [V, 2, B]
    wet_ring=P("voice", None, None),           # [V, 2, D]
    base=P("voice", None, None, "part", None),  # [V, 2, 2, P, F]
    coef_a=P("voice", None),                   # [V, 2]
    coef_c=P("voice", None),                   # [V, 2]
    active=P("voice", None, None, "part", None),  # [V, 2, 2, P, F]
)

BANK_SPEC = P(None, None, "part", None)        # [K, 2, P, F]
PARAMS_SPEC = P("voice", None)                 # [V, 2] each leaf
BLOCK_SPEC = P("voice", None, None)            # [V, 2, B]


def partitioned_state_sharding(mesh: Mesh, engine: PartitionedConvolution
                               ) -> PartitionedState:
    """Pytree of NamedShardings matching PartitionedState's leaves.

    The unused representation's placeholder leaves ([V,2,2,1,1]) cannot
    shard over 'part'; they get voice-only sharding.
    """
    placeholder_base = engine.variant != "coef"
    placeholder_active = engine.variant != "materialized"
    specs = dict(_STATE_SPECS)
    if placeholder_base:
        specs["base"] = P("voice", None, None, None, None)
    if placeholder_active:
        specs["active"] = P("voice", None, None, None, None)
    return PartitionedState(
        **{k: NamedSharding(mesh, v) for k, v in specs.items()})


def partitioned_shardings(mesh: Mesh, engine: PartitionedConvolution):
    """(state, bank, params, x) shardings for the partitioned step."""
    state_sh = partitioned_state_sharding(mesh, engine)
    bank_sh = NamedSharding(mesh, BANK_SPEC)
    params_sh = VoiceParams(**{
        f: NamedSharding(mesh, PARAMS_SPEC)
        for f in ("select", "predelay", "vsteps", "dry", "wet", "pan_dry",
                  "pan_wet", "level")})
    x_sh = NamedSharding(mesh, BLOCK_SPEC)
    return state_sh, bank_sh, params_sh, x_sh


# -- sharded step factories -----------------------------------------------------------

def _validate(mesh: Mesh, engine: PartitionedConvolution) -> None:
    voice_n = mesh.shape["voice"]
    part_n = mesh.shape["part"]
    if engine.num_voices % voice_n:
        raise ValueError(f"{engine.num_voices} voices not divisible by "
                         f"voice axis {voice_n}")
    if engine.partitions % part_n:
        raise ValueError(f"{engine.partitions} partitions not divisible by "
                         f"part axis {part_n}")


def shard_partitioned_step(engine: PartitionedConvolution, mesh: Mesh,
                           steady: bool = False, donate: bool = True):
    """jit engine.step with mesh shardings. Returns the compiled step."""
    _validate(mesh, engine)
    state_sh, bank_sh, params_sh, x_sh = partitioned_shardings(mesh, engine)
    if engine.variant == "coef":
        fn = engine.step_coef_steady if steady else engine.step_coef
    else:
        fn = engine.step_materialized
    return jax.jit(
        fn,
        in_shardings=(state_sh, bank_sh, params_sh, x_sh),
        out_shardings=(state_sh, x_sh),
        donate_argnums=(0,) if donate else (),
    )


def shard_collapse(engine: PartitionedConvolution, mesh: Mesh,
                   donate: bool = True):
    """jit engine.collapse with mesh shardings (coef variant)."""
    _validate(mesh, engine)
    state_sh, bank_sh, _, _ = partitioned_shardings(mesh, engine)
    sel_sh = NamedSharding(mesh, PARAMS_SPEC)
    return jax.jit(
        engine.collapse,
        in_shardings=(state_sh, bank_sh, sel_sh, sel_sh),
        out_shardings=state_sh,
        donate_argnums=(0,) if donate else (),
    )


def place_state(state: PartitionedState, mesh: Mesh,
                engine: PartitionedConvolution) -> PartitionedState:
    """Device_put a host/state pytree onto the mesh shardings.

    Routed through the planar-transfer helper because PartitionedState
    carries complex64 leaves: a HOST-resident state (checkpoint gathers,
    hand-built fixtures) put raw would need a complex host->device
    transfer, which some backends lack (utils/transfer.py).
    Device-resident leaves pass through device_put untouched."""
    from tpu_audio.utils.transfer import tree_device_put_maybe_complex
    return tree_device_put_maybe_complex(
        state, partitioned_state_sharding(mesh, engine))


def place_bank(bank, mesh: Mesh):
    return device_put_maybe_complex(bank, NamedSharding(mesh, BANK_SPEC))


# -- f-major production engine shardings ------------------------------------------

def fmajor_shardings(mesh: Mesh, engine):
    """(state, bank, params, x) shardings for FMajorPartitionedConvolution.

    Voice data-parallelism (both delay-line modes): the delay line's V*I
    dim, all per-voice state, params, and I/O blocks shard over 'voice'.

    IR-partition (sequence) parallelism — mesh 'part' axis > 1 — is served
    by the engine's ROLL mode (ring=False): the frequency-domain delay line,
    the MAC rhs bank, and the fade-base spectra all shard over the partition
    axis; the per-shard MAC produces partial spectra and XLA inserts the
    psum over 'part' plus the one-slot boundary shift of the delay-line
    roll (a collective permute) automatically from these shardings. RING
    mode's doubled-rhs dynamic window would straddle partition shards, so
    ring engines are voice-DP only: single-device production uses ring (no
    roll traffic at all); multi-device sequence scaling uses roll, where
    the roll's shard-boundary column IS the inter-device exchange.
    """
    from tpu_audio.engine.fmajor import FMajorBank, FMajorState

    part_n = mesh.shape.get("part", 1)
    if part_n > 1 and engine.ring_mode:
        raise ValueError(
            "ring-mode fmajor cannot shard partitions (dynamic window "
            "straddles shards); build the engine with ring=False for a "
            "part-sharded mesh, or use part=1")
    part = "part" if part_n > 1 else None

    state_sh = FMajorState(
        fdl=NamedSharding(mesh, P(None, "voice", None, part)),
        prev_in=NamedSharding(mesh, P("voice", None, None)),
        wet_ring=NamedSharding(mesh, P("voice", None, None, None)),
        # swap_snapshot=False engines carry a [1]*6 placeholder, unshardable
        base=NamedSharding(mesh, P(None, "voice", None, None, None, part)
                           if getattr(engine, "swap_snapshot", True)
                           else P(None, None, None, None, None, None)),
        coef_a=NamedSharding(mesh, P("voice", None)),
        coef_c=NamedSharding(mesh, P("voice", None)),
        wptr=NamedSharding(mesh, P()),
        # 'allk' engines carry a [.., 1] placeholder here, unshardable
        sel_spectra=NamedSharding(mesh, P(
            None, "voice", None, None, None,
            part if getattr(engine, "mac_strategy", None) == "selected"
            else None)),
        base_g=NamedSharding(mesh, P("voice", None, None)),
        base_pure=NamedSharding(mesh, P("voice", None)),
    )
    repl = NamedSharding(mesh, P())
    if part is None:
        bank_sh = FMajorBank(mac_rhs=repl, rhs2=repl, spectra=repl,
                             spectra_rev2=repl)
    else:
        # the 'selected' strategy carries placeholder mac_rhs/rhs2 leaves
        # (shape [1,1,1,1]) that cannot shard; spectra is real either way
        allk = getattr(engine, "mac_strategy", None) == "allk"
        bank_sh = FMajorBank(
            mac_rhs=(NamedSharding(mesh, P(None, None, "part", None))
                     if allk else repl),
            rhs2=repl,            # roll mode: placeholder leaf
            spectra=NamedSharding(mesh, P(None, None, "part", None, None)),
            spectra_rev2=repl,    # roll mode: placeholder leaf
        )
    params_sh = VoiceParams(**{
        f: NamedSharding(mesh, PARAMS_SPEC)
        for f in ("select", "predelay", "vsteps", "dry", "wet", "pan_dry",
                  "pan_wet", "level")})
    x_sh = NamedSharding(mesh, BLOCK_SPEC)
    return state_sh, bank_sh, params_sh, x_sh


def shard_fmajor_step(engine, mesh: Mesh, steady: bool = False,
                      donate: bool = True, mode: str | None = None):
    """jit the f-major engine step with mesh shardings (voice DP, and
    partition/sequence sharding in roll mode when mesh part > 1).

    mode: "steady" | "full" | "indexed" (default: "steady" if `steady`
    else "full"). "indexed" is the production crossfade step ('allk'
    strategy; snapshot provenance rides the voice-sharded state leaves)."""
    voice_n = mesh.shape["voice"]
    if engine.num_voices % voice_n:
        raise ValueError(f"{engine.num_voices} voices not divisible by "
                         f"voice axis {voice_n}")
    part_n = mesh.shape.get("part", 1)
    if engine.pp % part_n:
        raise ValueError(f"padded partition axis {engine.pp} not divisible "
                         f"by part axis {part_n}")
    state_sh, bank_sh, params_sh, x_sh = fmajor_shardings(mesh, engine)
    mode = mode or ("steady" if steady else "full")
    fn = {"steady": engine.step_coef_steady,
          "full": engine.step_coef,
          "indexed": engine.step_coef_indexed}[mode]
    return jax.jit(
        fn,
        in_shardings=(state_sh, bank_sh, params_sh, x_sh),
        out_shardings=(state_sh, x_sh),
        donate_argnums=(0,) if donate else (),
    )


# -- cascade engine sharding ------------------------------------------------------

def _cascade_reject_part(mesh: Mesh) -> None:
    """Single guard shared by the GSPMD and shard_map cascade paths."""
    if mesh.shape.get("part", 1) > 1:
        raise ValueError(
            "the cascade engine shards voices only (both stages use the "
            "windowed doubled-rhs ring MAC, whose dynamic window straddles "
            "partition shards — same restriction as fmajor ring mode); "
            "use part=1, or fmajor roll mode for sequence sharding")


def _cascade_state_specs(selected: bool = False):
    """PartitionSpecs for CascadeState leaves.

    ``selected``: shard the 'selected' strategy's materialized per-voice
    rhs leaves over their voice axes (head [F1, V, ...] axis 1; tail
    [M, Vg, ...] axis 1 — a contiguous Vg split IS a contiguous voice
    split because voice v lives at [v % M, v // M] and each shard's local
    voice count is a multiple of the ratio, so local group membership
    u % M equals global v % M). Under 'allk' they are size-1 placeholders
    and replicate."""
    from tpu_audio.engine.cascade import CascadeState

    rhs = P(None, "voice") if selected else P()
    return CascadeState(
        t=P(),
        fdl1=P(None, "voice", None, None),
        prev_in=P("voice", None, None),
        inbuf2=P(None, "voice"),    # [M, Vg, ...]: Vg is the voice axis
        fdl2=P(None, "voice"),      # [M, Vg, I, d, Pp2, F2] (freq-minor)
        wet_ring=P("voice", None, None, None),
        tail_ring=P(None, "voice"),  # [M, Vg, I, O, NB, B]
        coef_a=P("voice", None),
        coef_c=P("voice", None),
        base_g=P("voice", None, None),
        base_pure=P("voice", None),
        sel_head=rhs,
        sel_tail=rhs,
        base_head=rhs,
        base_tail=rhs,
        pd_q=P("voice"),
        pd_m=P("voice"),
    )


def _cascade_local_engine(engine, mesh: Mesh):
    """A per-shard clone of the cascade engine: the voice-staggered tail
    schedule is voice-local arithmetic, so each device runs an INDEPENDENT
    cascade over its local voice slice (its own `ratio` stagger groups) —
    communication-free data parallelism, like running N single-chip
    engines in lockstep. Group membership is a function of the voice's
    position within its shard rather than its global index; the schedule
    is phase-invariant (any group assignment tiles the tail seamlessly —
    tests/test_parallel.py asserts sharded == unsharded exactly)."""
    from tpu_audio.engine.cascade import CascadeConvolution

    voice_n = mesh.shape["voice"]
    _cascade_reject_part(mesh)
    local_v = engine.num_voices // voice_n
    if engine.num_voices % voice_n or local_v % engine.ratio:
        raise ValueError(
            f"{engine.num_voices} voices over a voice={voice_n} mesh "
            f"leaves {local_v} per shard, which must be a positive "
            f"multiple of the stagger ratio {engine.ratio}")
    import jax.numpy as jnp

    # propagate EVERY behavior knob: predelay_side changes semantics at
    # predelay edits, and tail_mac changes bf16 rounding (the dot form
    # takes exact products) — either mismatch breaks the sharded ==
    # unsharded exactness the tests assert
    local = CascadeConvolution(
        local_v, engine.block, engine.partitions, ratio=engine.ratio,
        max_predelay=engine.max_predelay, num_irs=engine.num_irs,
        mac_dtype=("f32" if engine.mac_dtype == jnp.float32 else "bf16"),
        predelay_side=engine.predelay_side, tail_mac=engine.tail_mac,
        mac_strategy=engine.mac_strategy)
    local.xf1, local.xf2 = engine.xf1, engine.xf2
    return local


def shard_cascade_step(engine, mesh: Mesh, mode: str = "steady",
                       donate: bool = True):
    """jit the cascade step as a shard_map over the 'voice' axis.

    mode: "steady" | "indexed" ('allk': span fades, no materialized
    step) | "full" ('selected': the general fade step over the
    materialized per-voice rhs). The bank and the scalar block counter
    are replicated; every other leaf shards over voices."""
    local = _cascade_local_engine(engine, mesh)
    fn = {"steady": local.step_coef_steady,
          "indexed": local.step_coef_indexed,
          "full": local.step_coef}[mode]
    state_sp = _cascade_state_specs(engine.mac_strategy == "selected")
    mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(state_sp, _cascade_bank_specs(), _cascade_params_specs(),
                  P("voice", None, None)),
        out_specs=(state_sp, P("voice", None, None)))
    return jax.jit(mapped, donate_argnums=(0,) if donate else ())


def shard_cascade_collapse_pure(engine, mesh: Mesh, donate: bool = True):
    """jit the cascade span collapse (takes the new fade's params for the
    in-flight tail rescale) as a voice-axis shard_map."""
    local = _cascade_local_engine(engine, mesh)
    state_sp = _cascade_state_specs()
    sel_sp = P("voice", None)
    mapped = jax.shard_map(
        local.collapse_pure, mesh=mesh,
        in_specs=(state_sp, sel_sp, sel_sp, _cascade_params_specs()),
        out_specs=state_sp)
    return jax.jit(mapped, donate_argnums=(0,) if donate else ())


def shard_cascade_collapse(engine, mesh: Mesh, donate: bool = True):
    """jit the 'selected' strategy's materializing collapse (re-base of
    the per-voice rhs + re-gather of the new selection from the
    replicated bank + in-flight tail rescale) as a voice-axis shard_map —
    entirely voice-local arithmetic, communication-free like the step."""
    local = _cascade_local_engine(engine, mesh)
    state_sp = _cascade_state_specs(selected=True)
    sel_sp = P("voice", None)
    mapped = jax.shard_map(
        local.collapse, mesh=mesh,
        in_specs=(state_sp, _cascade_bank_specs(), sel_sp, sel_sp, sel_sp,
                  _cascade_params_specs()),
        out_specs=state_sp)
    return jax.jit(mapped, donate_argnums=(0,) if donate else ())


def cascade_shardings(mesh: Mesh, engine):
    """(state, bank, params, y) NamedShardings for a GSPMD-jitted cascade
    step — the offline bounce's seam (streaming serves the shard_map path
    above). Both stages' arithmetic is voice-local, so these shardings
    compile to communication-free voice data-parallelism: the stagger
    group axis (v % ratio) stays replicated-major and the Vg axis
    (v // ratio) shards, so a contiguous Vg split is a contiguous voice
    split holding whole stagger groups. The bank and the scalar block
    counter replicate, exactly like `_cascade_state_specs`."""
    _cascade_reject_part(mesh)
    selected = engine.mac_strategy == "selected"
    return (_named(_cascade_state_specs(selected), mesh),
            _named(_cascade_bank_specs(), mesh),
            _named(_cascade_params_specs(), mesh),
            NamedSharding(mesh, P("voice", None, None)))


def _cascade_bank_specs():
    from tpu_audio.engine.cascade import CascadeBank
    return CascadeBank(head_rhs2=P(), tail_rhs2=P())


def _cascade_params_specs():
    return VoiceParams(**{
        f: P("voice", None)
        for f in ("select", "predelay", "vsteps", "dry", "wet", "pan_dry",
                  "pan_wet", "level")})


def _named(specs, mesh: Mesh):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


def place_cascade_state(state, mesh: Mesh, selected: bool = False):
    return jax.device_put(state, _named(_cascade_state_specs(selected),
                                        mesh))


def place_cascade_bank(bank, mesh: Mesh):
    return jax.device_put(bank, _named(_cascade_bank_specs(), mesh))


def place_cascade(state, bank, mesh: Mesh, selected: bool = False):
    """Device_put cascade state/bank onto the mesh (bank replicated)."""
    return (place_cascade_state(state, mesh, selected),
            place_cascade_bank(bank, mesh))


def shard_fmajor_collapse_pure(engine, mesh: Mesh, donate: bool = True):
    """jit the span ([V,2,K]-sized) collapse with mesh shardings."""
    state_sh, _, _, _ = fmajor_shardings(mesh, engine)
    sel_sh = NamedSharding(mesh, PARAMS_SPEC)
    return jax.jit(
        engine.collapse_pure,
        in_shardings=(state_sh, sel_sh, sel_sh),
        out_shardings=state_sh,
        donate_argnums=(0,) if donate else (),
    )


def shard_fmajor_collapse(engine, mesh: Mesh, donate: bool = True):
    state_sh, bank_sh, _, _ = fmajor_shardings(mesh, engine)
    sel_sh = NamedSharding(mesh, PARAMS_SPEC)
    # the 'selected' MAC strategy re-gathers per-voice spectra at collapse
    # and therefore takes the post-change selection as a 5th argument
    # (mirrors StreamSession._collapse_takes_new_select)
    in_sh = (state_sh, bank_sh, sel_sh, sel_sh)
    if getattr(engine, "mac_strategy", None) == "selected":
        in_sh = in_sh + (sel_sh,)
    return jax.jit(
        engine.collapse,
        in_shardings=in_sh,
        out_shardings=state_sh,
        donate_argnums=(0,) if donate else (),
    )
