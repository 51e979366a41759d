"""Model construction + timing primitives shared by the headline
and every leg (split out of bench.py, round 5)."""

import collections
import time

import numpy as np

from benchlib.util import log


def make_bank(num_irs: int, ir_seconds: float, sample_rate: int):
    """Real reference IRs tiled/padded to the target length when available,
    else synthetic exponential-decay noise IRs (same spectra footprint)."""
    import glob
    import os

    from tpu_audio.engine import IRBank

    ir_len = int(ir_seconds * sample_rate)
    rng = np.random.default_rng(0)
    bank = IRBank(sample_rate=sample_rate)
    ref = sorted(glob.glob("/root/reference/ir/1/*.wav"))[:num_irs]
    for k in range(num_irs):
        if k < len(ref) and os.path.exists(ref[k]):
            from tpu_audio.io.wav import read_wav
            ir = read_wav(ref[k], verbose=False).stereo().T
            reps = -(-ir_len // ir.shape[1])
            ir = np.tile(ir, (1, reps))[:, :ir_len]
        else:
            t = np.arange(ir_len, dtype=np.float32)
            env = np.exp(-t / (0.4 * ir_len)).astype(np.float32)
            ir = rng.standard_normal((2, ir_len)).astype(np.float32) * env * 0.3
        bank.append(ir)
    return bank


def build(args):
    import jax
    import jax.numpy as jnp

    from tpu_audio.engine import ControlPlane, IRBank
    from tpu_audio.engine.fmajor import FMajorPartitionedConvolution

    sr = args.sample_rate
    bank = make_bank(args.num_irs, args.ir_seconds, sr)

    partitions = bank.max_partitions(args.block)
    capacity = args.bank_capacity
    if capacity is not None:
        capacity = min(capacity, args.num_irs)
    if args.engine == "cascade":
        from tpu_audio.engine.cascade import CascadeConvolution
        from tpu_audio.models.reverb import _fit_cascade_ratio

        ratio = _fit_cascade_ratio(args.cascade_ratio, args.voices, partitions)
        engine = CascadeConvolution(
            args.voices, args.block, partitions, ratio=ratio,
            max_predelay=8192, backend=args.fft_backend,
            num_irs=capacity or args.num_irs, mac_dtype=args.mac_dtype,
            predelay_side=getattr(args, "predelay_side", "write"),
            mac_strategy="allk" if capacity else args.mac_strategy)
        if capacity:
            # residency mode keeps the host spectra path (its fault
            # payload contract is spectra slices unless fault_upload=td)
            compact = IRBank(sample_rate=sr)
            for k in range(capacity):
                compact.append(bank.ir(k))
            spectra = engine.prepare_bank(
                compact, cache_dir=getattr(args, "pack_cache", None))
        else:
            # on-device prep (round 5): the packed bank never crosses
            # the wire — ~2.8 MB of pcm16 time-domain PCM replaces the
            # 25-69 MB packed upload EVERY child process pays, which on
            # congested evenings (0.5-8 MB/s bulk H2D) was 10-140 s of
            # each leg's budget
            from tpu_audio.engine import device_prep
            spectra = device_prep.prepare_cascade_bank_device(engine, bank)
    else:
        engine = FMajorPartitionedConvolution(
            args.voices, args.block, partitions,
            max_predelay=8192, backend=args.fft_backend,
            mac_dtype=args.mac_dtype, swap_snapshot=not args.no_swap_snapshot,
            mac_strategy="allk" if capacity else args.mac_strategy,
            num_irs=capacity or args.num_irs, pv_mac=args.pv_mac)
        if capacity:
            full_spectra = bank.partitioned_spectra(args.block)
            spectra = engine.prepare_bank(
                full_spectra[: capacity],
                cache_dir=getattr(args, "pack_cache", None))
        else:
            from tpu_audio.engine import device_prep
            spectra = device_prep.prepare_fmajor_bank_device(engine, bank)
    control = ControlPlane(args.voices, args.num_irs)
    control.wet[:] = 0.7
    control.dry[:] = 0.2
    control.predelay[:] = 1024
    params = jax.tree.map(jnp.asarray, control.snapshot())
    state = engine.init_converged(spectra, params)
    nbytes = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(spectra))
    log(f"bench: {args.voices} voices, block {args.block}, "
        f"{engine.partitions} partitions ({args.ir_seconds}s IR), "
        f"{args.num_irs} IRs, bank {nbytes / 1e6:.0f} MB, "
        f"platform {jax.devices()[0].platform} ({jax.devices()[0]})")
    return engine, spectra, control, params, state


def engine_true_ms(step, state, bank, params, make_block, n, extra=(),
                   reps=3, warmup_steps=1):
    """Chained-dispatch per-block cost: each step consumes the previous
    state (device executes back to back), ONE sync readback at the end
    (a readback cannot return before the device has finished).

    ``warmup_steps``: dispatches before the timed reps. One absorbs the
    compile; multi-GB configs need a real warm chain — executable load /
    first-touch memory placement bleeds across several dispatches."""
    st = state
    for w in range(max(warmup_steps, 1)):
        st, out = step(st, bank, params, *extra, make_block(w))
    # absorb compile + load + first-transfer latency, syncing through the
    # SAME tiny dependent slice the timed reps use — otherwise the slice
    # executable's own compile lands inside timed rep 1
    _ = np.asarray(out[0, 0, :4])
    best = float("inf")
    for _rep in range(reps):
        t0 = time.perf_counter()
        for t in range(n):
            st, out = step(st, bank, params, *extra, make_block(t))
        # force completion of the whole chain through a TINY dependent
        # slice (the established probe pattern): the final block's samples
        # depend on every prior step, and 16 bytes cost one round trip — a
        # FULL output readback would fold the output transfer into the
        # "engine-true" number (output delivery is the e2e serving
        # measurement's job, with every byte verified there)
        _ = np.asarray(out[0, 0, :4])
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e3, st


def e2e_throughput(step, state, bank, params, make_block, encode, decode,
                   n_chunks, chunk, deadline_s, extra=()):
    """Sustained serving throughput: per-block dispatch, outputs encoded to
    the wire format on-device in chunks of `chunk` blocks (one stack+encode
    dispatch), transfers pipelined two chunks deep, EVERY byte fetched to
    the host. Returns (per-block times by chunk, missed, last host chunk).
    """
    pending = collections.deque()
    times = []
    missed = 0
    last_host = None

    # warmup cycle: one full chunk through dispatch+encode+fetch
    outs = []
    st = state
    for t in range(chunk):
        st, out = step(st, bank, params, *extra, make_block(t))
        outs.append(out)
    batch = encode(*outs)
    _ = np.asarray(batch)

    tprev = None
    for c in range(n_chunks):
        outs = []
        for t in range(chunk):
            st, out = step(st, bank, params, *extra, make_block(c * chunk + t))
            outs.append(out)
        batch = encode(*outs)
        try:
            batch.copy_to_host_async()
        except Exception:
            pass
        pending.append(batch)
        if len(pending) > 2:
            last_host = np.asarray(pending.popleft())
            tnow = time.perf_counter()
            if tprev is None:
                # the first pop spans the 3-chunk pipeline fill — start the
                # steady-state clock here instead of recording it
                tprev = tnow
                continue
            per_block = (tnow - tprev) / chunk
            tprev = tnow
            times.append(per_block)
            if per_block > deadline_s:
                missed += chunk
    while pending:
        last_host = np.asarray(pending.popleft())
        tnow = time.perf_counter()
        if tprev is not None:
            per_block = (tnow - tprev) / chunk
            times.append(per_block)
            if per_block > deadline_s:   # drained chunks count too
                missed += chunk
        tprev = tnow

    # honesty check: the delivered wire data must be real, finite audio
    audio = decode(last_host)
    if not np.isfinite(audio).all():
        raise RuntimeError("benchmark delivered non-finite samples")
    if np.abs(audio).max() == 0.0:
        raise RuntimeError("benchmark delivered silent output")
    return np.asarray(times), missed, st


