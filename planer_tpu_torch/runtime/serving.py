"""Serving: continuous request batching with fixed shape buckets — the
port's counterpart of ``planer_tpu/runtime/serving.py``.

``ServingEngine`` runs a dispatcher thread: requests accumulate until the
largest bucket fills or ``max_delay_ms`` expires, the batch is padded to
the bucket size, executed, and the results are split back to per-request
futures.  ``stats()`` reports occupancy, latency, padding and the fused
stages' fall-offs.

The program compiles an entry per input shape (on the card: a warm run
and a CUDA graph capture, ``runtime/program.py``), the stage64 and stagen
kernels fold their tables per program, and a shape off the kernels'
geometry falls back to the decomposed chain.  Batch buckets and spatial
buckets keep the set of shapes the net sees small and known in advance,
and ``warmup`` compiles (and so captures) each of them before the first
request.

Threads: the dispatcher thread runs the net, so the compiled entries are
replayed from that thread.  The engine must be the net's only caller while
it runs (warm-up runs in ``__init__``, before the dispatcher starts).
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from ..ops import kernels as _kernels

__all__ = ["ServingEngine", "ServingStats"]


@dataclass
class ServingStats:
    """Bounded: percentile windows keep the last N samples so a long-lived
    server neither grows without bound nor pays O(uptime) per stats() call.

    ``latencies_ms`` holds one sample per answered request: its submit to
    the moment its future is resolved (the batch's wait, the net, the split,
    the crop, and the first padded batch's spatial probe included; the
    requests of a batch resolve one after another), so
    ``p50_ms`` / ``p99_ms`` are what a client waits.  ``occupancy`` holds
    one sample per batch."""

    requests: int = 0
    batches: int = 0
    padded: int = 0                      # padding rows executed
    recompiles: int = 0                  # net calls with a never-seen shape
    window: int = 4096
    latencies_ms: collections.deque = None
    occupancy: collections.deque = None
    shapes_seen: set = field(default_factory=set)

    def __post_init__(self):
        if self.latencies_ms is None:
            self.latencies_ms = collections.deque(maxlen=self.window)
        if self.occupancy is None:
            self.occupancy = collections.deque(maxlen=self.window)

    def summary(self) -> dict:
        lat = sorted(self.latencies_ms)
        n = len(lat)
        occ = list(self.occupancy)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "avg_occupancy": float(np.mean(occ)) if occ else 0.0,
            "pad_fraction": (self.padded / max(1, self.requests + self.padded)),
            "p50_ms": lat[n // 2] if n else 0.0,
            "p99_ms": lat[min(n - 1, int(n * 0.99))] if n else 0.0,
            "recompiles": self.recompiles,
            "distinct_shapes": len(self.shapes_seen),
        }


class ServingEngine:
    """Continuous-batching front end over a Net (or any callable of a
    batched NCHW array)."""

    def __init__(self, net, buckets=(1, 2, 4, 8, 16, 32),
                 max_delay_ms: float = 5.0, warmup: bool = False,
                 example_shape=None, hw_buckets=None, pad_mode: str = "edge",
                 crop_outputs: bool = True):
        """``hw_buckets``: optional spatial shape buckets — each ``int`` or
        ``(H, W)`` entry is a padded size class.  A request whose trailing
        H x W fits a bucket is padded up to it (``pad_mode``: numpy pad
        mode; "edge" perturbs border convs least), so a new image size never
        reaches the net as a new shape.  Spatially mapped outputs are
        cropped back to the request's scale when ``crop_outputs``
        (segmentation); classification heads (no spatial dims) and the
        outputs of a host tail are not.  ``stats()['recompiles']`` counts
        never-seen batch shapes reaching the net (warm-up batches not
        counted), so a shape that escapes the buckets is observable.

        ``warmup`` with ``example_shape`` runs one zero batch of every
        bucket, at ``example_shape`` and at each spatial bucket's H x W,
        through the net in ``__init__``, in the caller's thread: every
        entry the buckets can reach compiles (on the card: captures) and
        the kernels build before the first request.  With ``hw_buckets`` it
        first derives each spatial bucket's crop signature there, so the
        first padded batch does not wait for the probe."""
        self.net = net
        self.buckets = tuple(sorted(buckets))
        self.hw_buckets = None
        if hw_buckets is not None:
            self.hw_buckets = tuple(sorted(
                (b, b) if np.isscalar(b) else (int(b[0]), int(b[1]))
                for b in hw_buckets))
        self.pad_mode = pad_mode
        self.crop_outputs = crop_outputs
        self._sig_cache: dict = {}   # example shape -> per-output (ky, kx)
        self.max_delay = max_delay_ms / 1e3
        self.stats_data = ServingStats()
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        if warmup and example_shape is not None:
            shapes = [tuple(example_shape)]
            if self.hw_buckets is not None and len(example_shape) >= 2:
                for bh, bw in self.hw_buckets:
                    shp = tuple(example_shape[:-2]) + (bh, bw)
                    if crop_outputs:
                        self._spatial_signature(shp)
                    if shp not in shapes:
                        shapes.append(shp)
            for shp in shapes:
                for b in self.buckets:
                    self.net(np.zeros((b,) + shp, np.float32))
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ API
    def submit(self, x: np.ndarray, retries: int = 0) -> Future:
        """Enqueue one request (single example, no batch dim).

        ``retries``: request-level retry on execution failure (the
        failure-detection story at serving scope — a transient device error
        re-enqueues the request instead of failing the client)."""
        fut: Future = Future()
        self._q.put((np.asarray(x), fut, time.perf_counter(), retries))
        return fut

    def infer(self, x: np.ndarray, retries: int = 0):
        return self.submit(x, retries=retries).result()

    def stats(self) -> dict:
        """The serving summary, plus ``fused_stage_falloff`` when a fused
        stage fell back to its decomposed chain anywhere in the process
        (the kernels' ``FALLOFF`` counters): a serve shape that drops the
        kernel is visible here."""
        s = self.stats_data.summary()
        falloff = _kernels.falloff()
        if falloff:
            s["fused_stage_falloff"] = falloff
        return s

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        # fail, not strand, anything still queued (futures must resolve)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            item[1].set_exception(RuntimeError("serving engine closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- internal
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _dispatch(self):
        max_bucket = self.buckets[-1]
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_delay
            while len(batch) < max_bucket:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            # group by PADDED example shape/dtype (mixed requests must not
            # kill the dispatcher or each other); with hw_buckets, different
            # image sizes that pad to the same bucket share one batch
            groups: dict = {}
            for item in batch:
                key = (self._target_shape(item[0].shape), str(item[0].dtype))
                groups.setdefault(key, []).append(item)
            for g in groups.values():
                try:
                    self._run_batch(g)
                except Exception as e:  # fail the batch, never the thread
                    for item in g:
                        if not item[1].done():
                            item[1].set_exception(e)

    def _target_shape(self, shape) -> tuple:
        """Example shape after spatial pad-to-bucket (identity when
        hw_buckets is unset, the example has no spatial dims, or it exceeds
        every bucket — oversize requests keep exact-shape semantics)."""
        if self.hw_buckets is None or len(shape) < 2:
            return tuple(shape)
        h, w = shape[-2], shape[-1]
        for bh, bw in self.hw_buckets:
            if bh >= h and bw >= w:
                return tuple(shape[:-2]) + (bh, bw)
        return tuple(shape)

    def _pad_example(self, x: np.ndarray, target: tuple) -> np.ndarray:
        if tuple(x.shape) == target:
            return x
        cfg = [(0, t - s) for s, t in zip(x.shape, target)]
        if self.pad_mode == "constant":
            return np.pad(x, cfg, mode="constant")
        return np.pad(x, cfg, mode=self.pad_mode)

    def _spatial_signature(self, example_shape: tuple):
        """Positive which-outputs-are-spatial signal.

        For a Net, the program's float32 executor (the program's weights,
        dequantized; plain torch ops, so no kernel launches and no
        ``FALLOFF`` or ``LAUNCHES`` count moves) runs one zero image at the
        serve H x W and one at H+64 x W+64 on the net's device; an output
        whose trailing dims scale exactly with the input is spatially mapped
        with that factor.  Outputs of a host tail (data-dependent, e.g. box
        lists after NMS) are never spatial planes, never cropped.  Returns
        a list of (ky, kx)|None per output, or None when no signature can
        be derived (a bare callable, or the walk failed): then the crop
        falls back to the shape-ratio heuristic."""
        if example_shape in self._sig_cache:
            return self._sig_cache[example_shape]
        sig = None
        prog = getattr(self.net, "program", None)
        try:
            if prog is not None and len(example_shape) >= 2:
                if prog.plan.cut < len(prog.graph.flow):
                    sig = "host_tail"      # outputs come from the host tail
                else:
                    import torch
                    ex = prog._executor()
                    h, w = example_shape[-2], example_shape[-1]

                    def shapes(hh, ww):
                        x = torch.zeros((1,) + tuple(example_shape[:-2])
                                        + (hh, ww), device=ex.device)
                        outs = ex.run(x)
                        outs = outs if isinstance(outs, tuple) else (outs,)
                        return [tuple(o.shape) for o in outs]

                    s1 = shapes(h, w)
                    s2 = shapes(h + 64, w + 64)
                    sig = []
                    for a, b in zip(s1, s2):
                        if (len(a) >= 2 and len(b) == len(a)
                                and a[-2] * (h + 64) == b[-2] * h
                                and a[-1] * (w + 64) == b[-1] * w
                                and a[-2] > 0 and a[-1] > 0):
                            sig.append((a[-2] / h, a[-1] / w))
                        else:
                            sig.append(None)
        except Exception:  # noqa: BLE001 -- crop by the heuristic instead
            sig = None
        self._sig_cache[example_shape] = sig
        return sig

    def _crop_output(self, o: np.ndarray, orig_hw, padded_hw, sig_i="auto"):
        """Crop a spatially-mapped output back to the request's scale."""
        if (not self.crop_outputs or o.ndim < 2 or orig_hw == padded_hw):
            return o
        if sig_i != "auto":
            if sig_i is None:              # positively known non-spatial
                return o
            ky, kx = sig_i
        else:
            # no signature available (bare callable): shape-ratio heuristic
            ky = o.shape[-2] / padded_hw[0]
            kx = o.shape[-1] / padded_hw[1]
            if not (0 < ky <= 1 and 0 < kx <= 1) \
                    or o.shape[-2] < orig_hw[0] * ky:
                return o
        return o[..., : max(1, int(round(orig_hw[0] * ky))),
                 : max(1, int(round(orig_hw[1] * kx)))]

    def _run_batch(self, batch):
        futs = [b[1] for b in batch]
        n = len(batch)
        target = self._target_shape(batch[0][0].shape)
        orig_hws = [(b[0].shape[-2], b[0].shape[-1])
                    if b[0].ndim >= 2 else None for b in batch]
        xs = [self._pad_example(b[0], target) for b in batch]
        bucket = self._bucket_for(n)
        x = np.stack(xs, axis=0)
        if bucket > n:
            pad = np.zeros((bucket - n,) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad], axis=0)
        if x.shape not in self.stats_data.shapes_seen:
            self.stats_data.shapes_seen.add(x.shape)
            self.stats_data.recompiles += 1
        try:
            out = self.net(x)
        except Exception as e:
            # request-level retry: re-enqueue items with budget left,
            # fail the rest (serving-scope failure handling)
            for xi, f, t0, r in batch:
                if r > 0:
                    self._q.put((xi, f, t0, r - 1))
                else:
                    f.set_exception(e)
            return
        st = self.stats_data
        st.requests += n
        st.batches += 1
        st.padded += bucket - n
        st.occupancy.append(n / bucket)
        outs = out if isinstance(out, tuple) else (out,)
        padded_hw = (target[-2], target[-1]) if len(target) >= 2 else None
        any_padded = any(hw is not None and hw != padded_hw
                         for hw in orig_hws)
        sig = (self._spatial_signature(target) if self.crop_outputs
               and padded_hw is not None and any_padded else None)
        if sig == "host_tail":
            sig = [None] * len(outs)       # tail outputs: never crop
        for i, f in enumerate(futs):
            per = tuple(np.asarray(o)[i] for o in outs)
            if padded_hw is not None and orig_hws[i] is not None:
                per = tuple(self._crop_output(
                    o, orig_hws[i], padded_hw,
                    sig[j] if sig is not None and j < len(sig) else "auto")
                    for j, o in enumerate(per))
            # recorded before the future resolves, so a client that reads
            # stats() after its answer sees its own sample
            st.latencies_ms.append((time.perf_counter() - batch[i][2]) * 1e3)
            f.set_result(per[0] if len(per) == 1 else per)
