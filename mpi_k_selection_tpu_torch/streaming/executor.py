"""The per-chunk consumers of a streamed pass and their scheduler
(counterpart of ``mpi_k_selection_tpu/streaming/executor.py``).

Every staged chunk goes through ONE launch of the sweep kernel
(ops/cuda/sweep_ingest.py) per consumer: its CUDA kernel for a chunk on
the card, its plain version for a chunk on the CPU. There are three
consumers, one per part set a streamed pass uses:

- :class:`FusedIngestConsumer`: the descent's histograms (one per
  distinct surviving prefix), the survivor collect and the spill tee
  (the survivors of a spec union, appended to the next spill
  generation), from one read;
- :class:`CountLessLeqConsumer`: the rank certificate's pair;
- :class:`SketchFoldConsumer`: a RadixSketch's deepest level and key
  extremes (``RadixSketch.update_stream`` and the monitor).

Beside them, :class:`DigitTeeConsumer` tees a pass-0 or sketch pass to a
format-v2 generation (``pack_spill="auto"``): the chunk's keys are grouped
by their top digit and cut to their low bytes on the chunk's device
(torch operations, no kernel of the JAX package's), and come back packed.

:class:`StreamExecutor` dispatches each chunk's work when it arrives and
finishes it (the host-side folds) in chunk order through an
:class:`~mpi_k_selection_tpu_torch.streaming.pipeline.InflightWindow` of
one bundle per ingest slot, then releases the chunk's staging slot:
exactly when the last result depending on it is on the host. Histograms
fold into int64 host counters, so counts are exact for any stream length,
and the folds follow chunk order whatever card a chunk ran on.

Every launch reports to the ledger (obs/ledger.py) under its kind:
``ingest.histogram``, ``ingest.fused`` (a histogram with the spill tee),
``ingest.collect``, ``ingest.certificate`` and ``ingest.sketch``; with an
``obs``, each counts its read of the chunk (obs/wiring.py:``bucket_read``).
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_k_selection_tpu_torch.obs import wiring as _wr
from mpi_k_selection_tpu_torch.obs.ledger import ledger_dispatch
from mpi_k_selection_tpu_torch.ops.cuda.sweep_ingest import sweep_ingest
from mpi_k_selection_tpu_torch.streaming import spill as _sp
from mpi_k_selection_tpu_torch.streaming.pipeline import InflightWindow, StagedKeys
from mpi_k_selection_tpu_torch.utils import dtypes as _dt

_NP_UNSIGNED = {4: np.uint32, 8: np.uint64}


def materialize_compacted(part) -> np.ndarray:
    """One ``(buffer, count)`` collect pair on the host: the count first,
    then a device-to-host copy of the survivors ``buffer[:count]`` only, as
    unsigned keys of the buffer's width."""
    buf, count = part
    cnt = int(count)
    return buf[:cnt].to("cpu", copy=True).numpy().view(_NP_UNSIGNED[buf.element_size()])


def _launch_key(keys: StagedKeys) -> tuple:
    """A sweep launch's ledger key: the key word's width (PyTorch compiles
    nothing per shape; the kernel's instantiation is per width)."""
    return (keys.data.element_size() * 8,)


def finish_chunk_histograms(hist, prefixes, pad: int) -> dict:
    """``{prefix: int64 histogram}`` from one chunk's ``(K, 2^rb)`` counts,
    with the exact pad correction: pads are key 0, so they land in digit 0
    and only under the prefix 0 (or no prefix, ``None``)."""
    hk = hist.cpu().numpy().astype(np.int64)
    out = {p: hk[i] for i, p in enumerate(prefixes)}
    if pad:
        for p, h in out.items():
            if p is None or int(p) == 0:
                h[0] -= pad
    return out


class FusedIngestConsumer:
    """One pass's histograms, survivor collect and spill tee, from one
    kernel launch per chunk. ``hist`` is ``(shift, radix_bits, prefixes)``
    (``[None]``: the first pass, no prefix filter) or None;
    ``collect_specs`` is a list of ``(resolved_bits, prefix)`` specs, whose
    keys (the top ``resolved_bits`` bits equal ``prefix``) are gathered per
    spec in chunk order. ``tee_specs`` is such a list too, with ``writer``
    (a streaming/spill.py ``SpillWriter``) and ``orig_dtype`` (the stream's
    NumPy dtype): the keys matching any of them, in chunk order, are
    appended to the writer as one record a chunk at finish (chunks with
    none are skipped), so the records follow chunk order, as the JAX
    package's ``SpillTeeConsumer`` writes them, each naming the chunk's
    ``device_slot``. ``obs`` counts each launch's read."""

    def __init__(self, *, total_bits: int, hist=None, collect_specs=(), tee_specs=(), writer=None, orig_dtype=None,
                 obs=None):
        if hist is None and not collect_specs and not tee_specs:
            raise ValueError("FusedIngestConsumer needs at least one part")
        self._obs = obs
        # the launch kind: its ledger site and its bucket_read phase
        self._kind = "fused" if tee_specs else "histogram" if hist is not None else "collect"
        self._bits = total_bits
        self._hist = hist
        self.hists = {} if hist is None else {p: np.zeros(1 << hist[1], np.int64) for p in hist[2]}
        self.specs = list(collect_specs)
        self.out = {s: [] for s in self.specs}
        self._tee_specs = [(self._bits - r, p) for r, p in tee_specs]
        self._writer = writer
        self._orig_dtype = orig_dtype
        self._kdt = np.dtype(f"uint{total_bits}")

    def dispatch(self, keys: StagedKeys):
        kw = {}
        if self._hist is not None:
            shift, radix_bits, prefixes = self._hist
            kw = dict(shift=shift, radix_bits=radix_bits, hist_prefixes=[p or 0 for p in prefixes])
        _wr.bucket_read(self._obs, self._kind, keys)
        with ledger_dispatch(f"ingest.{self._kind}", _launch_key(keys), self._obs):
            hist, collect, tee, _, _ = sweep_ingest(
                keys.data, keys.n_valid, key_op=keys.key_op, key_xor=keys.key_xor,
                collect=[(self._bits - r, p) for r, p in self.specs], tee=self._tee_specs, **kw,
            )
        return keys.pad, keys.device_slot, hist, collect, tee

    def finish(self, handle) -> None:
        pad, slot, hist, collect, tee = handle
        if tee is not None:
            surv = materialize_compacted(tee)
            if surv.size:  # sub-32-bit keys sit in the low bits of 32-bit words
                self._writer.append(surv.astype(self._kdt, copy=False), self._orig_dtype, device_slot=slot)
        if hist is not None:
            for p, h in finish_chunk_histograms(hist, self._hist[2], pad).items():
                self.hists[p] += h
        for spec, part in zip(self.specs, collect):
            surv = materialize_compacted(part)
            if surv.size:
                self.out[spec].append(surv)

    def collected(self, kdt) -> dict:
        """``{spec: host key array}`` after the drain."""
        return {
            s: np.concatenate(parts) if parts else np.empty((0,), kdt) for s, parts in self.out.items()
        }


class CountLessLeqConsumer:
    """The rank certificate's ``(#keys < v, #keys <= v)`` folds for the key
    ``vkey``: the kernel masks pads, so no correction."""

    def __init__(self, vkey: int, obs=None):
        self.less = 0
        self.leq = 0
        self._vkey = int(vkey)
        self._obs = obs

    def dispatch(self, keys: StagedKeys):
        _wr.bucket_read(self._obs, "certificate", keys)
        with ledger_dispatch("ingest.certificate", _launch_key(keys), self._obs):
            _, _, _, cert, _ = sweep_ingest(
                keys.data, keys.n_valid, key_op=keys.key_op, key_xor=keys.key_xor, vkey=self._vkey
            )
        return cert

    def finish(self, handle) -> None:
        lt, le = handle
        self.less += int(lt)
        self.leq += int(le)


class SketchFoldConsumer:
    """Folds each chunk into ``sketch`` (a
    :class:`~mpi_k_selection_tpu_torch.streaming.sketch.RadixSketch`, read
    at dispatch, so a chunk folds into the sketch that was current when it
    was dispatched): one launch per chunk gives the deepest level's int32
    counts and the extremes in key space; the finish folds the counts into
    the host int64 pyramid in chunk order, less the pads (key 0, bucket 0).

    The kernel's sketch part counts the top ``resolution_bits`` of the key
    word. Sub-32-bit keys are widened into the low bits of 32-bit words,
    so for them the deep level comes from the prefix-free histogram part
    of the same launch (the digit of ``resolution_bits`` at ``total_bits -
    resolution_bits``), and only the extremes from a one-bit sketch part.
    ``obs`` counts each launch's read under ``phase`` (``sketch`` or
    ``monitor``)."""

    def __init__(self, sketch, obs=None, phase: str = "sketch"):
        self.sketch = sketch
        self._obs = obs
        self._phase = phase

    def dispatch(self, keys: StagedKeys):
        sk = self.sketch
        res, total = sk.resolution_bits, sk.total_bits
        kw = dict(key_op=keys.key_op, key_xor=keys.key_xor)
        _wr.bucket_read(self._obs, self._phase, keys)
        with ledger_dispatch("ingest.sketch", _launch_key(keys), self._obs):
            if total < 32:
                hist, _, _, _, (_, kmin, kmax) = sweep_ingest(
                    keys.data, keys.n_valid, shift=total - res, radix_bits=res, hist_prefixes=[0], sketch_bits=1, **kw
                )
                deep = hist[0]
            else:
                _, _, _, _, (deep, kmin, kmax) = sweep_ingest(keys.data, keys.n_valid, sketch_bits=res, **kw)
        return sk, keys.pad, keys.n_valid, deep, torch.stack([kmin, kmax])

    def finish(self, handle) -> None:
        sk, pad, n_valid, deep, ext = handle
        h = deep.cpu().numpy().astype(np.int64)
        if pad:
            h[0] -= pad
        width = ext.element_size() * 8
        kmin, kmax = (int(v) & ((1 << width) - 1) for v in ext.cpu().tolist())
        sk._fold_counts(h, kmin, kmax, n_valid)


class DigitTeeConsumer:
    """Appends each chunk's keys to ``writer`` (a digit-segmenting
    streaming/spill.py ``SpillWriter``) as one record, in chunk order: the
    keys of ``total_bits`` bits of the stream dtype ``orig_dtype`` are
    grouped and cut on the chunk's device (:func:`spill.pack_digits`) when
    the width below the digit is whole bytes, else on the host; the
    finish checksums the segments and writes the record (format v1 where
    packing would not shrink it). Records name the chunk's ``tee_slot``."""

    def __init__(self, writer, total_bits: int, orig_dtype):
        self._writer = writer
        self._bits = total_bits
        self._digit = writer.digit_bits(total_bits)
        self._orig_dtype = orig_dtype
        self._kdt = np.dtype(f"uint{total_bits}")

    def dispatch(self, keys: StagedKeys):
        k = _dt.keys_from_raw(keys.data[: keys.n_valid], keys.key_op, keys.key_xor)
        slot = keys.tee_slot
        if (self._bits - self._digit) % 8:
            return k, slot, None
        return k, slot, _sp.pack_digits(k, self._digit, self._bits)

    def _host_keys(self, k) -> np.ndarray:
        return k.cpu().numpy().view(_NP_UNSIGNED[k.element_size()]).astype(self._kdt, copy=False)

    def finish(self, handle) -> None:
        k, slot, packed = handle
        w = self._writer
        if packed is None:
            w.append(self._host_keys(k), self._orig_dtype, device_slot=slot)
            return
        with _sp.HOST_TIMES["prepare"].timing():
            counts, payload = (t.cpu().numpy() for t in packed)
            segments = _sp.digit_segments_from(counts, payload, self._digit, self._bits)
            prep = _sp.prepared_record(lambda: self._host_keys(k), int(k.numel()), self._kdt, self._orig_dtype,
                                       segments)
        w.append_prepared(prep, device_slot=slot)


#: Per-card streams the host reads of a finished bundle run on, so they do
#: not queue behind the later bundles' launches on the compute stream.
_READBACK: dict = {}


def _readback_stream(device: torch.device):
    s = _READBACK.get(device)
    if s is None:
        s = _READBACK[device] = torch.cuda.Stream(device=device)
    return s


class StreamExecutor:
    """Dispatches every consumer's work for a chunk at :meth:`push`, and
    finishes the bundles in chunk order through a FIFO window of
    ``window`` in flight (one a slot of a pass staged over several): a
    bundle on a card first waits for the CUDA event recorded after its
    launches on that card's stream, then its consumers fold on the host
    (their reads on a readback stream of the card: the bundle's own work
    is done, and the later bundles' launches stay queued), then its
    staging slot is released. ``occupancy`` (obs/wiring.py:
    ``window_occupancy``) samples the window at every push."""

    def __init__(self, consumers, *, window: int = 1, occupancy=None):
        self.consumers = list(consumers)
        self._win = InflightWindow(window, self._finish_bundle, occupancy)

    def push(self, keys: StagedKeys) -> None:
        handles = [c.dispatch(keys) for c in self.consumers]
        done = None
        if keys.data.is_cuda:
            done = torch.cuda.Event(blocking=True)  # a host wait sleeps, not spins
            done.record(torch.cuda.current_stream(keys.data.device))
        self._win.push((keys, handles, done))

    def _finish_bundle(self, bundle) -> None:
        keys, handles, done = bundle
        if done is None:
            for c, h in zip(self.consumers, handles):
                c.finish(h)
        else:
            done.synchronize()
            with torch.cuda.stream(_readback_stream(keys.data.device)):
                for c, h in zip(self.consumers, handles):
                    c.finish(h)
        keys.release()

    def drain(self) -> None:
        """Finish every pending bundle, oldest first (end of stream)."""
        self._win.drain()

    def abort(self) -> None:
        """Drop every pending bundle unfinished, releasing its chunk (a
        raise mid-pass must not hold staging slots) once the device has
        finished reading it."""
        for keys, _, done in self._win.clear_pending():
            if done is not None:
                done.synchronize()
            keys.release()


def release_staged(keys) -> None:
    """Idempotently release the chunk in hand when a pass unwinds: it sits
    in neither the pipeline queue nor the window at that instant."""
    if isinstance(keys, StagedKeys):
        keys.release()
