"""Failure detection and recovery: rebuild a poisoned device session.

The reference's only failure policy is assert() -> process abort (SURVEY.md
§5; reference src/jackclient.cu:13-18 registers a shutdown hook that does
nothing). For a long-running server the risk is real and operational: a
failed transfer or a lost device can leave the process's device session
unusable, and a remote device can drop mid-stream.
Errors surface at READBACK, not dispatch — block_until_ready can lie — so
the recovery unit is the streaming loop itself: any exception escaping
StreamSession.run is treated as a dead device session.

``run_resilient`` wraps the loop with checkpoint/rebuild/resume:

  - the session checkpoints engine state + control plane every N blocks
    (StreamSession.run checkpoint hooks);
  - on failure, a FRESH model is built via the caller's factory (new device
    arrays: bank re-upload, re-jit against the new backend session), the
    last checkpoint is restored, and a seekable source is rewound to the
    checkpoint block so the regenerated stream is EXACT;
  - a dedup sink wrapper drops regenerated blocks that were already
    delivered, so the sink sees a gap-free, duplicate-free stream;
  - live (unseekable) sources just continue — input during the outage is
    lost, which is the honest semantics of live audio.
"""

from __future__ import annotations

import os

import numpy as np

from tpu_audio.runtime.backends import BlockSink
from tpu_audio.runtime.checkpoint import load_checkpoint
from tpu_audio.utils.log import Log


class _DedupSink(BlockSink):
    """Drops blocks already delivered before a crash-and-replay."""

    def __init__(self, sink: BlockSink):
        self.sink = sink
        self.delivered = 0
        self._skip = 0

    def rewind_to(self, block_index: int) -> None:
        self._skip = max(self.delivered - block_index, 0)

    def write(self, block: np.ndarray) -> None:
        if self._skip > 0:
            self._skip -= 1
            return
        self.sink.write(block)
        self.delivered += 1

    def close(self) -> None:
        pass  # closed once by run_resilient


def run_resilient(build_model, source, sink: BlockSink, checkpoint_path,
                  max_blocks: int | None = None, midi=None, live_midi=None,
                  checkpoint_every: int = 256, max_restarts: int = 3,
                  recoverable: tuple = (Exception,),
                  session_kwargs: dict | None = None):
    """Stream source->engine->sink with automatic crash recovery.

    build_model: zero-arg callable returning a fresh ConvolutionReverb
    (fresh device arrays + jit sessions — a poisoned backend session must
    not be reused). Returns (model, summary) of the final session.
    """
    checkpoint_path = os.fspath(checkpoint_path)
    session_kwargs = dict(session_kwargs or {})
    deduped = _DedupSink(sink)
    restarts = 0
    resume_block = 0
    model = build_model()
    state = model.init_state()

    while True:
        session = model.session(source, deduped, **session_kwargs)
        try:
            remaining = (None if max_blocks is None
                         else max_blocks - resume_block)
            state = session.run(state, max_blocks=remaining, midi=midi,
                                live_midi=live_midi,
                                checkpoint_path=checkpoint_path,
                                checkpoint_every=checkpoint_every,
                                start_block=resume_block)
            break
        except recoverable as exc:  # noqa: PERF203 - the recovery path
            restarts += 1
            if restarts > max_restarts:
                Log.error("recover", "giving up after %d restarts", max_restarts)
                raise
            Log.warn("recover", "device session failed at ~block %d (%s: %s); "
                     "rebuilding", deduped.delivered, type(exc).__name__, exc)
            model = build_model()  # fresh device arrays + compiled steps
            if os.path.exists(checkpoint_path):
                state, meta = load_checkpoint(
                    checkpoint_path, model.engine.init_state(), model.control)
                resume_block = int(meta.get("block_index", 0))
            else:
                state = model.init_state()
                resume_block = 0
            # events at blocks >= the checkpoint must replay: the restored
            # control plane only carries state up to the checkpoint block.
            # In chunked mode pop_due runs at chunk STARTS, so a checkpoint
            # at block C has only events <= C - chunk baked in — rewind a
            # chunk further back (replays land at the same chunk boundary
            # the uncrashed run would have applied them at).
            if midi is not None and hasattr(midi, "rewind_to"):
                chunk = int(session_kwargs.get("chunk_blocks") or 1)
                midi.rewind_to(resume_block - max(chunk - 1, 0))
            if hasattr(source, "seek"):
                source.seek(resume_block)
                deduped.rewind_to(resume_block)
                Log.info("recover", "resumed exactly from checkpoint block %d",
                         resume_block)
            else:
                # live source: blocks during the outage are gone; the
                # restored engine state keeps the reverb tail consistent
                deduped.rewind_to(deduped.delivered)
                Log.info("recover", "live source: resuming from block %d "
                         "with restored state (outage gap dropped)",
                         deduped.delivered)

    sink.close()
    summary = session.summary()
    summary["restarts"] = restarts
    summary["blocks_delivered"] = deduped.delivered
    return state, summary
