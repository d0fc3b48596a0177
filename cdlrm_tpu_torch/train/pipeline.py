"""Background batch-assembly pipeline: overlap the host probe + H2D staging
of upcoming batches with device execution of the current step.

The reference hides prefetch work in separate processes but probes on the
GPU inside forward (model_no_ddp.py:149-212); our probe is host-side
(DESIGN.md D1), so without overlap it serializes with the device step. This
thread stages up to ``depth`` future batches.

Safety invariant: the probe reads the occupancy tables that ``plan_insert``
mutates at refill. A batch belonging to lookahead-window k is only probed
after refill k has been applied. The main loop pops every window-k batch
before triggering refill k+1, and the pipeline waits for the refill counter
before probing window k+1 — so probe and insert never run concurrently.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

_SENTINEL = None

# queue marker: the next batches start a new lookahead window — the consumer
# must apply the refill and call notify_refill_applied() before the pipeline
# will probe them
WINDOW_BOUNDARY = object()

# resume marker (mid-window data cursor): the next batches belong to a window
# whose refill was ALREADY applied before the checkpoint — the consumer must
# pop the (re-produced) window from the prefetcher WITHOUT re-applying the
# insert plan (occupancy and controller RNG already reflect it), rebuild the
# multi-host window store if needed, then notify_refill_applied()
WINDOW_REPLAY = object()


class AssemblyPipeline(threading.Thread):
    def __init__(
        self,
        trainer,
        nepochs: int,
        lookahead: int,
        depth: int = 2,
        start_epoch: int = 0,
        start_j: int = 0,
    ):
        """(start_epoch, start_j): the data cursor — resume the stream at
        batch ``start_j`` of epoch ``start_epoch`` (trainer checkpoint
        contract). A mid-window cursor (start_j % lookahead != 0) makes the
        first emitted marker WINDOW_REPLAY instead of WINDOW_BOUNDARY."""
        super().__init__(daemon=True, name="assembly-pipeline")
        self.trainer = trainer
        self.nepochs = nepochs
        self.lookahead = max(1, lookahead)
        self.start_epoch = start_epoch
        self.start_j = start_j
        self.out: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self.error: Optional[BaseException] = None
        self._stop_event = threading.Event()
        self._refill_cv = threading.Condition()
        self._refills_applied = 0

    # -- main-thread API -----------------------------------------------------
    def notify_refill_applied(self) -> None:
        with self._refill_cv:
            self._refills_applied += 1
            self._refill_cv.notify_all()

    def get(self):
        """Pop (batch, device_inputs); None = stream exhausted."""
        item = self.out.get()
        if item is _SENTINEL:
            if self.error is not None:
                raise self.error
            return None
        return item

    def stop(self) -> None:
        self._stop_event.set()
        with self._refill_cv:
            self._refill_cv.notify_all()
        try:
            while True:
                self.out.get_nowait()
        except queue.Empty:
            pass

    # -- worker ---------------------------------------------------------------
    def _wait_for_window(self, window: int) -> bool:
        with self._refill_cv:
            while self._refills_applied <= window and not self._stop_event.is_set():
                self._refill_cv.wait(timeout=0.1)
        return not self._stop_event.is_set()

    def _put(self, item) -> bool:
        while not self._stop_event.is_set():
            try:
                self.out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run(self) -> None:
        tr = self.trainer
        b = tr.cfg.mini_batch_size
        b_loc = tr.cfg.local_batch_size
        try:
            # this thread copies each batch to the device: the current CUDA
            # device is a per-thread setting
            tr.use_device()
            win = -1
            replay = self.start_j % self.lookahead != 0
            for epoch in range(self.start_epoch, self.nepochs):
                # refill windows are per-epoch (reference j resets)
                j = self.start_j if epoch == self.start_epoch else 0
                skip = j
                for batch in _batches_from(tr.dataset, skip,
                                           full_size=b, epoch=epoch):
                    if self._stop_event.is_set():
                        return
                    if batch.x.shape[0] != b:
                        continue  # identical drop-last rule as the main loop
                    if replay:
                        # resumed mid-window: the current window's refill is
                        # already in the checkpointed occupancy
                        win += 1
                        if not self._put(WINDOW_REPLAY):
                            return
                        replay = False
                    elif j % self.lookahead == 0:
                        win += 1
                        if not self._put(WINDOW_BOUNDARY):
                            return
                    if not self._wait_for_window(win):
                        return
                    # the wire-format flag rides with the item: auto-dedup
                    # flips tr._dedup only at window boundaries (strictly
                    # before this thread probes the new window's batches),
                    # and the consumer picks the matching compiled step per
                    # block from the flag
                    inputs, stats, dedup, binfo = tr._assemble(batch, b_loc)
                    if not self._put(
                        ((epoch, j), batch, inputs, stats, dedup, binfo)
                    ):
                        return
                    j += 1
                if replay:
                    # the resumed epoch had NO remaining full batches (the
                    # checkpoint landed exactly on its end, mid-window): the
                    # prefetcher still re-produces the cursor's window, so it
                    # must be consumed (without re-applying its insert plan)
                    # or every later window would be off by one
                    win += 1
                    if not self._put(WINDOW_REPLAY):
                        return
                    if not self._wait_for_window(win):
                        return
                    replay = False
        except BaseException as e:
            self.error = e
        finally:
            self._put(_SENTINEL)


def _batches_from(dataset, skip: int, full_size: Optional[int] = None,
                  epoch: int = 0):
    """dataset.batches(skip=n) when supported, else iterate-and-drop.
    ``skip`` counts FULL batches — the data cursor's unit (the consumer
    drops partial batches before counting) — so the fallback must count
    only batches of ``full_size`` rows; skipping raw batches would shift a
    resumed stream by one whenever a partial precedes the cursor.

    ``epoch`` reaches only datasets that declare ``epoch_seeded_shuffle``
    (the per-epoch-permutation protocol, data/criteo.py CriteoBinDataset) —
    every other stream is epoch-invariant by design (reference parity:
    RandomDataset regenerates identically; the in-memory dataset shuffles
    once at construction)."""
    kw = (
        {"epoch": epoch}
        if getattr(dataset, "epoch_seeded_shuffle", False) else {}
    )
    if skip == 0 and not kw:
        return dataset.batches()
    try:
        return dataset.batches(skip=skip, **kw)
    except TypeError:
        def gen():
            it = dataset.batches()
            dropped = 0
            for bt in it:
                if full_size is None or bt.x.shape[0] == full_size:
                    dropped += 1
                    if dropped >= skip:
                        break
            yield from it
        return gen()
