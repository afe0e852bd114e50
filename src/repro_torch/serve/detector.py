"""Population-aware detector serving: continuous batching over chip
committees.

Serving the IRC detector means answering each request with a calibrated
uncertainty drawn from a committee of sampled virtual dies, not from one
chip's lucky draw:

  submit / result        bounded async request queue with admission control
                         (`ServeQueueFull` once `max_queue` requests wait);
                         requests may arrive from any thread
  wave scheduler         pending images form waves of up to `batch_slots`
                         requests; a wave is one `committee_wave_forward`
                         on the device, and wave k+1 is enqueued before the
                         host decodes wave k (a double buffer)
  DetectionResponse      boxes decoded from the committee-MEAN prediction,
                         and the population mean/std/quantiles of the
                         per-chip top detection score

Key discipline: the engine holds only a root key; request `rid`'s committee
is keyed by the stateless coordinate `fold_in(root, rid)`, never by a split
chain held in engine state.  A request's draws therefore do not depend on
which requests came before it or share its wave, and are bit-identical to
`run_mc_detector(fold_in(root, rid), ...)` at the same chip ids.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import nonideal as ni
from repro_torch.mc.detector_mc import (_ToHost, committee_wave_forward,
                                        detector_planes)
from repro_torch.mc.stats import DEFAULT_QUANTILES, StreamingMoments
from repro_torch.obs import (LatencyTracker, PhaseTimer, RunLog, as_runlog,
                             spans)
from repro_torch.train.det_loss import decode_detections

# The reference pads short waves with lanes of this reserved request id;
# the port runs live lanes only, and keeps the id reserved so that both
# engines accept the same ids: `submit` rejects ids at or above it.
PAD_REQUEST_ID = 0x7FFFFFFF


class ServeQueueFull(RuntimeError):
    """Admission control: the bounded request queue is at capacity."""


@dataclasses.dataclass(frozen=True)
class Detection:
    """One decoded box: (cx, cy, w, h) as image fractions, committee-mean
    confidence `score`, and the predicted class index."""
    box: Tuple[float, float, float, float]
    score: float
    cls: int


@dataclasses.dataclass
class DetectionResponse:
    """One request's answer from its chip committee.

    detections  boxes decoded (confidence threshold and per-class NMS) from
                the committee-MEAN head prediction
    confidence  population statistics of the per-chip top detection score:
                {count, mean, std, q05..q95}; the spread says how much this
                request's answer depends on the die it lands on
    queue_s     submit-to-response wall time (queue wait and the wave)
    committee   raw per-chip head predictions [chips, gh, gw, ho], kept only
                when the engine was built with `keep_committee=True`
    """
    request_id: int
    detections: List[Detection]
    confidence: Dict[str, float]
    wave: int
    queue_s: float
    committee: Optional[np.ndarray] = None


@dataclasses.dataclass
class _Pending:
    """Queue entry: the request's image and its completion handshake."""
    request_id: int
    image: np.ndarray
    t_submit: float
    done: threading.Event
    response: Optional[DetectionResponse] = None


@dataclasses.dataclass
class _Wave:
    """A wave as it formed: its requests, its number (1, 2, ... in the
    order waves form, which is the order they are answered) and the
    queue's depth then, its own requests included."""
    lanes: List[_Pending]
    number: int
    depth: int


class DetectorServeEngine:
    """Continuously batched committee inference over a fixed serving fleet.

    The fleet is the first `committee` chips of the MC key stream; the
    per-layer group planes are hoisted once at construction
    (`detector_planes`), so a wave carries only images and request keys.
    Everything runs on the device that `params` live on.  Drive it
    synchronously (`serve_batch`, or `submit` + `process_pending` +
    `result`) or start the background scheduler thread (`start`/`stop`)
    and submit from anywhere.

    `use_kernel` and `kernel_impl` are `run_mc_detector`'s: `use_kernel`
    routes each group conv (None: the autotuner's table for this card;
    True: the fused IRC MVM; False: the plain batched route), and on the
    kernel route `kernel_impl` "kernel" runs the fused IRC MVM (its plain
    version on the CPU), "ref" its plain version.  `device` is the device model (None: analytic).
    `params` should carry calibrated stem-BN running stats
    (`det.calibrate_bn`).

    While a profiler trace runs (`repro_torch.obs.spans`), the engine
    records per request a `submit` span on the caller's thread, a
    `serve_queue` span from submit until its wave is dispatched and a
    `serve_respond` span inside its wave's decode (each with `request`);
    per wave a `serve_wave` span (`wave`, `lanes`, `depth`: the queue
    when the wave formed; on the card `device_ms`, timing events from
    just before the wave's first launch to its copy's landing) and its
    `serve_enqueue`, `serve_copy_wait` and `serve_host` (the decode;
    `next_in_flight`: whether the next wave ran on the card meanwhile)
    spans; and a `serve_idle` span while the scheduler waits on an empty
    queue with nothing in flight.  The scheduler thread, started before
    the profiler, is not recorded by it: `spans.trace_events` places its
    spans on the trace's clock by the `submit` spans.
    """

    def __init__(self, det, params, *, committee: int = 4,
                 batch_slots: int = 4, max_queue: int = 64,
                 cfg_ni: ni.NonidealConfig = ni.NonidealConfig.all(),
                 sa_extra: float = 0.0, seed: int = 0,
                 conf_thresh: float = 0.1, nms_thresh: float = 0.45,
                 quantiles: Tuple[float, ...] = DEFAULT_QUANTILES,
                 use_kernel: Optional[bool] = None,
                 kernel_impl: str = "kernel",
                 keep_committee: bool = False,
                 obs: Optional[RunLog] = None,
                 device=None):
        self.det = det
        self.params = params
        self.committee = committee
        self.slots = batch_slots
        self.max_queue = max_queue
        self.cfg_ni = cfg_ni
        self.sa_extra = sa_extra
        self.conf_thresh = conf_thresh
        self.nms_thresh = nms_thresh
        self.quantiles = quantiles
        self.use_kernel = use_kernel
        self.kernel_impl = kernel_impl
        self.device = device
        self.keep_committee = keep_committee
        self._dev = params["head"].device
        # the root key only: request keys are the stable coordinates
        # fold_in(root, request_id), never a split chain in engine state
        self._root_key = prng.PRNGKey(seed, device=self._dev)
        self._chip_ids = torch.arange(committee, dtype=torch.int64,
                                      device=self._dev)
        self._planes, self._meta = detector_planes(det, params)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._pending: Dict[int, _Pending] = {}
        self._next_id = 0
        self._waves = 0
        self._stop_flag = False
        self._thread: Optional[threading.Thread] = None
        self.obs = as_runlog(obs)
        self.wave_timer = PhaseTimer("serve_wave", unit="requests")
        self.enq_timer = PhaseTimer("serve_enqueue", unit="requests")
        self.dev_timer = PhaseTimer("serve_copy_wait", unit="requests")
        self.host_timer = PhaseTimer("serve_host", unit="requests")
        self.queue_latency = LatencyTracker()

    # ------------------------------------------------------------ requests

    def submit(self, image, request_id: Optional[int] = None) -> int:
        """Enqueue one [H, W, 3] image; returns its request id.

        Raises `ServeQueueFull` when `max_queue` requests are already
        waiting (the caller sheds load or retries), and `ValueError` on ids
        outside [0, PAD_REQUEST_ID) or already in flight.  Thread-safe."""
        img = np.asarray(image, np.float32)
        with spans.span("submit") as sp, self._work:
            if len(self._queue) >= self.max_queue:
                raise ServeQueueFull(
                    f"queue at capacity ({self.max_queue} pending)")
            rid = self._next_id if request_id is None else int(request_id)
            if not 0 <= rid < PAD_REQUEST_ID:
                raise ValueError(f"request_id {rid} outside "
                                 f"[0, {PAD_REQUEST_ID})")
            if rid in self._pending:
                raise ValueError(f"request_id {rid} already in flight")
            self._next_id = max(self._next_id, rid + 1)
            p = _Pending(request_id=rid, image=img,
                         t_submit=time.perf_counter(),
                         done=threading.Event())
            self._queue.append(p)
            self._pending[rid] = p
            self._work.notify()
            sp.set(request=rid)
        return rid

    def result(self, request_id: int,
               timeout: Optional[float] = None) -> DetectionResponse:
        """Block until `request_id`'s response is ready and return it;
        TimeoutError after `timeout` seconds."""
        with self._lock:
            p = self._pending[request_id]
        if not p.done.wait(timeout):
            raise TimeoutError(f"request {request_id} not served within "
                               f"{timeout}s")
        with self._lock:
            self._pending.pop(request_id, None)
        assert p.response is not None
        return p.response

    def serve_batch(self, images) -> List[DetectionResponse]:
        """Submit a batch and drain it in this thread; responses in order."""
        rids = [self.submit(img) for img in images]
        self.process_pending()
        return [self.result(rid) for rid in rids]

    # ------------------------------------------------------------ scheduler

    def start(self) -> None:
        """Start the background scheduler thread: a wave forms whenever
        requests are pending."""
        if self._thread is not None:
            return
        self._stop_flag = False
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the scheduler thread after its current drain and join it."""
        with self._work:
            self._stop_flag = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def process_pending(self) -> int:
        """Drain the queue in the caller's thread; returns requests served."""
        return self._drain(block=False)

    def _serve_loop(self) -> None:
        while not self._stop_flag:
            self._drain(block=True)

    def _collect_wave(self, block: bool) -> Optional[_Wave]:
        """The next wave, None where the queue is empty; with `block`,
        waits for a request first (a `serve_idle` span)."""
        with self._work:
            if block and not self._queue and not self._stop_flag:
                with spans.span("serve_idle"):
                    while not self._queue and not self._stop_flag:
                        self._work.wait()
            if not self._queue:
                return None
            depth = len(self._queue)
            self._waves += 1
            return _Wave([self._queue.popleft()
                          for _ in range(min(self.slots, depth))],
                         self._waves, depth)

    def _drain(self, *, block: bool) -> int:
        """Serve waves until the queue is empty, double-buffered as the MC
        sweep is: wave k+1 is enqueued before wave k's host decode, so the
        device computes the next committee while the host builds
        responses.  The copy-wait lap is the host's wait on wave k's copy
        to the host."""
        wave = self._collect_wave(block)
        inflight = None
        served = 0
        while wave is not None:
            n = len(wave.lanes)
            enq_before = self.enq_timer.total_s
            with self.wave_timer.lap(items=n, wave=wave.number, lanes=n,
                                     depth=wave.depth) as lap:
                if inflight is None:
                    inflight = self._dispatch(wave)
                with self.dev_timer.lap(items=n, wave=wave.number):
                    preds = inflight.wait()
                device_ms = inflight.device_ms()
                if device_ms is not None:
                    lap.span.set(device_ms=device_ms)
                nxt = self._collect_wave(block=False)
                inflight = self._dispatch(nxt) if nxt is not None else None
                with self.host_timer.lap(items=n, wave=wave.number,
                                         next_in_flight=inflight is not None):
                    responses = self._complete(wave, preds)
            self._log_wave(wave.number, responses,
                           self.enq_timer.total_s - enq_before)
            served += n
            wave = nxt
        return served

    # ------------------------------------------------------------ wave body

    def _dispatch(self, wave: _Wave) -> _ToHost:
        """Enqueue one wave's committees and their copy to the host."""
        if spans.spans_on():
            for p in wave.lanes:
                spans.close_span("serve_queue", round(p.t_submit * 1e9),
                                 request=p.request_id, wave=wave.number)
        with self.enq_timer.lap(items=len(wave.lanes), wave=wave.number,
                                lanes=len(wave.lanes)):
            start = spans.device_mark(self._dev)
            images = torch.from_numpy(
                np.stack([p.image for p in wave.lanes])).to(self._dev)
            keys = torch.stack([prng.fold_in(self._root_key, p.request_id)
                                for p in wave.lanes])
            return _ToHost(committee_wave_forward(
                self.params, images, keys, self._chip_ids, self._planes,
                det_cfg=self.det.cfg, spec=self.det.spec, cfg_ni=self.cfg_ni,
                sa_extra=self.sa_extra, meta=self._meta,
                use_kernel=self.use_kernel, kernel_impl=self.kernel_impl,
                device=self.device), start)

    def _complete(self, wave: _Wave,
                  preds: np.ndarray) -> List[DetectionResponse]:
        """Decode each lane's committee into its response."""
        cfg = self.det.cfg
        responses = []
        for i, p in enumerate(wave.lanes):
            with spans.span("serve_respond", request=p.request_id,
                            wave=wave.number):
                committee = preds[i]                  # [chips, gh, gw, ho]
                boxes, scores, classes = decode_detections(
                    committee.mean(axis=0), cfg.n_anchors, cfg.n_classes,
                    self.conf_thresh, self.nms_thresh)
                per_chip = np.array([self._top_score(chip)
                                     for chip in committee], np.float32)
                moments = StreamingMoments(self.quantiles)
                moments.update(per_chip)
                queue_s = time.perf_counter() - p.t_submit
                p.response = DetectionResponse(
                    request_id=p.request_id,
                    detections=[Detection(box=tuple(float(v) for v in b),
                                          score=float(s), cls=int(c))
                                for b, s, c in zip(boxes, scores, classes)],
                    confidence=moments.summary(), wave=wave.number,
                    queue_s=queue_s,
                    committee=(committee.copy() if self.keep_committee
                               else None))
                self.queue_latency.add(queue_s)
                responses.append(p.response)
                p.done.set()
        return responses

    def _top_score(self, chip_pred: np.ndarray) -> float:
        """One chip's vote: its top decoded detection score (0.0 when the
        chip detects nothing above the confidence threshold)."""
        cfg = self.det.cfg
        _, scores, _ = decode_detections(chip_pred, cfg.n_anchors,
                                         cfg.n_classes, self.conf_thresh,
                                         self.nms_thresh)
        return float(scores[0]) if scores.size else 0.0

    def _log_wave(self, number: int, responses: List[DetectionResponse],
                  enqueue_s: float) -> None:
        """One `serve_wave` event: the wave's wall lap (`wall_s`); the
        host's wait on its copy (`device_s`, the reference's name: not the
        device's time, which the wave's span gives as `device_ms` while a
        profiler trace runs); its decode (`host_s`); the enqueue laps in
        it (`enqueue_s`, the next wave's included); each request's
        submit-to-response time (`queue_s`)."""
        self.obs.log_event(
            "serve_wave", wave=number, requests=len(responses),
            committee=self.committee, wall_s=self.wave_timer.last_s,
            device_s=self.dev_timer.last_s, host_s=self.host_timer.last_s,
            enqueue_s=enqueue_s, queue_s=[r.queue_s for r in responses],
            requests_per_sec=len(responses) / max(self.wave_timer.last_s,
                                                  1e-9))

    # ------------------------------------------------------------ telemetry

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Phase summaries (the first wave split from steady-state
        requests/s) and queue-latency percentiles."""
        return {"wave": self.wave_timer.summary(),
                "enqueue": self.enq_timer.summary(),
                "device": self.dev_timer.summary(),
                "host": self.host_timer.summary(),
                "queue_latency": self.queue_latency.summary()}

    def log_stats(self) -> None:
        """Emit the phase and latency summaries as RunLog events."""
        for timer in (self.wave_timer, self.enq_timer, self.dev_timer,
                      self.host_timer):
            timer.log_to(self.obs, waves=self._waves)
        self.obs.log_event("serve_latency", **self.queue_latency.summary())
