"""Estimator fit loop (counterpart of
`mxnet_tpu/gluon/contrib/estimator.py`; reference:
`python/mxnet/gluon/contrib/estimator/estimator.py` + event_handler.py).

The Estimator wraps net, loss, metrics and a gluon Trainer into `fit()`,
with composable EventHandlers firing at train/epoch/batch boundaries.
The step itself is the eager autograd loop (`autograd.record()`,
`loss.backward()`, `Trainer.step`), so handler logic can observe it. A
gluon DataLoader handed to `fit` is wrapped in
`dataflow.prefetch_to_mesh` at the `device_prefetch_depth` knob's depth
(0: the plain iterator), so each batch is copied to the card while the
one before it trains. With a checkpoint directory, every completed
epoch writes `resilience.save_estimator`'s checkpoint, and `resume`
restores it (`resilience.restore_estimator`).
"""
from __future__ import annotations

import time

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler", "TelemetryHandler", "DiagnosticsHandler"]


class TrainBegin:
    def train_begin(self, estimator):
        pass


class TrainEnd:
    def train_end(self, estimator):
        pass


class EpochBegin:
    def epoch_begin(self, estimator):
        pass


class EpochEnd:
    def epoch_end(self, estimator):
        pass


class BatchBegin:
    def batch_begin(self, estimator):
        pass


class BatchEnd:
    def batch_end(self, estimator):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop on max_epoch/max_batch (reference StoppingHandler)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch

    def train_begin(self, est):
        est.max_epoch = self.max_epoch
        est.max_batch = self.max_batch

    def batch_end(self, est):
        if self.max_batch is not None and est.num_batch >= self.max_batch:
            est.stop_training = True

    def epoch_end(self, est):
        if self.max_epoch is not None and est.num_epoch >= self.max_epoch:
            est.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Reset train metrics each epoch, update per batch."""

    def __init__(self, metrics):
        self.metrics = list(metrics)

    def epoch_begin(self, est):
        for m in self.metrics:
            m.reset()

    def batch_end(self, est):
        from ... import metric as _metric
        for m in self.metrics:
            if isinstance(m, _metric.Loss):
                # loss metrics average the loss VALUE (reference
                # MetricHandler special-cases these)
                m.update(None, [est.last_loss])
            else:
                m.update(est.last_labels, est.last_outputs)


class ValidationHandler(EpochEnd):
    """Run evaluation on val_data every `epoch_period` epochs."""

    def __init__(self, val_data, eval_fn, epoch_period=1):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period

    def epoch_end(self, est):
        if est.num_epoch % self.epoch_period == 0:
            self.eval_fn(self.val_data)


class LoggingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Epoch summaries through the estimator's logger (print-based; the
    reference wires `logging`)."""

    def __init__(self, log_fn=print):
        self.log = log_fn
        self._t0 = None

    def train_begin(self, est):
        self._t0 = time.time()
        self.log(f"Training begin: epochs={est.max_epoch}")

    def epoch_end(self, est):
        vals = ", ".join(f"{m.get()[0]}={m.get()[1]:.4f}"
                         for m in est.train_metrics)
        if getattr(est, "samples_per_sec", None):
            # published by TelemetryHandler when telemetry is on
            vals += f", {est.samples_per_sec:.1f} samples/s"
            if getattr(est, "tokens_per_sec", None):
                vals += f", {est.tokens_per_sec:.0f} tokens/s"
        self.log(f"[epoch {est.num_epoch}] {vals} "
                 f"({time.time() - self._t0:.1f}s elapsed)")

    def train_end(self, est):
        self.log(f"Training end: {est.num_epoch} epochs, "
                 f"{est.num_batch} batches, "
                 f"{time.time() - self._t0:.1f}s")


class TelemetryHandler(TrainBegin, BatchBegin, BatchEnd, TrainEnd):
    """Wire the fit loop into mx.telemetry: per-batch step events + the
    step-latency histogram, and samples/s / tokens/s gauges (also published
    on the estimator as `samples_per_sec` / `tokens_per_sec`, which
    LoggingHandler picks up).

    tokens_per_sample: multiply samples/s into tokens/s for sequence
    workloads (e.g. the padded sequence length). `enable=True` (default)
    turns telemetry collection on for the run; pass False to only observe
    when something else enabled it."""

    def __init__(self, tokens_per_sample=None, enable=True):
        from ... import telemetry
        self.telemetry = telemetry
        self.tokens_per_sample = tokens_per_sample
        self.enable = enable
        self._t0 = None
        # full fwd+bwd+update batch latency; the optimizer-apply slice of it
        # lands in trainer_step_seconds via Trainer.step
        self._m_step = telemetry.histogram(
            "fit_batch_seconds", "full fit-loop batch wall time (batches "
            "that ran at a new signature are excluded — they land in "
            "compile_seconds)")
        self._m_sps = telemetry.gauge(
            "samples_per_sec", "training throughput from the last batch")
        self._m_tps = telemetry.gauge(
            "tokens_per_sec", "samples/s x tokens_per_sample")
        self._m_compiles = telemetry.counter("compile_total")
        self._c0 = 0.0

    def train_begin(self, est):
        if self.enable:
            self.telemetry.enable()

    def batch_begin(self, est):
        self._t0 = time.perf_counter()
        self._c0 = self._m_compiles.value

    def batch_end(self, est):
        if self._t0 is None or not self.telemetry.enabled():
            return
        if self._m_compiles.value > self._c0:
            # this batch paid a trace+compile (first batch, or shape
            # churn): a seconds-long dur_s here would poison the step
            # p50/p99 and the throughput gauges
            return
        dt = time.perf_counter() - self._t0
        self._m_step.observe(dt)
        self.telemetry.event("step", dur_s=round(dt, 6), step=est.num_batch)
        n = est.last_outputs[0].shape[0] if est.last_outputs else 0
        if dt > 0 and n:
            est.samples_per_sec = n / dt
            self._m_sps.set(est.samples_per_sec)
            if self.tokens_per_sample:
                est.tokens_per_sec = est.samples_per_sec * self.tokens_per_sample
                self._m_tps.set(est.tokens_per_sec)

    def train_end(self, est):
        path = self.telemetry.config.get("telemetry_jsonl_path")
        if path:
            try:
                self.telemetry.flush(path)
            except OSError as e:
                # same policy as autoflush: a bad sink must not fail fit()
                # or starve the remaining train_end handlers
                import warnings
                warnings.warn(f"telemetry flush to {path!r} failed: {e}")


class DiagnosticsHandler(TrainBegin, BatchEnd, TrainEnd):
    """Wire the fit loop into mx.diagnostics: arm the post-mortem writer
    for the run, record one flight-recorder entry per batch (step id,
    mean loss, lr), feed the hang watchdog, and — when the nan_sentinel
    knob (or `nan_sentinel=True` here) is on — finiteness-check the loss,
    dumping a post-mortem and raising NonFiniteError on NaN/Inf.

    `watchdog_deadline_s=None` defers to the config knob (0 = no
    watchdog). `install=True` (default) chains the crash hooks so an
    unhandled exception anywhere in fit() leaves a postmortem.json; pass
    False to only record while something else owns the hooks."""

    def __init__(self, diagnostics_dir=None, watchdog_deadline_s=None,
                 nan_sentinel=None, install=True):
        from ... import config, diagnostics
        self.diagnostics = diagnostics
        self.config = config
        self.diagnostics_dir = diagnostics_dir
        self.watchdog_deadline_s = watchdog_deadline_s
        self.nan_sentinel = nan_sentinel
        self.install = install
        self._armed_watchdog = False

    def train_begin(self, est):
        if self.install:
            self.diagnostics.install(diagnostics_dir=self.diagnostics_dir)
        else:
            self.diagnostics.enable()
        deadline = self.watchdog_deadline_s
        if deadline is None:
            deadline = self.config.get("watchdog_deadline_s")
        # a process-lifetime watchdog (e.g. armed by install() at import)
        # is respected: this handler only arms — and later disarms — its
        # own, so fit() can't silently strip the user's watchdog
        if deadline and deadline > 0 and self.diagnostics._watchdog is None:
            self.diagnostics.arm_watchdog(deadline)
            self._armed_watchdog = True

    def batch_end(self, est):
        check = self.nan_sentinel if self.nan_sentinel is not None \
            else self.config.get("nan_sentinel")
        if not (self.diagnostics.enabled() or check):
            return
        loss_val = None
        if getattr(est, "last_loss", None) is not None:
            # the eager fit loop already materialized the loss for the
            # metric handlers, so this host read costs nothing extra
            try:
                loss_val = self.diagnostics._scalar(est.last_loss)
            except Exception:
                loss_val = None
        if loss_val is None:
            return  # Trainer.step already recorded this step
        # Trainer.step already appended this step's record (grad-norm,
        # lr); fold the loss into it rather than halving ring coverage
        # with a near-duplicate entry. Recorded BEFORE the sentinel check
        # so a NaN loss is the ring's last entry in the post-mortem.
        if not self.diagnostics.annotate_step(est.num_batch, loss=loss_val):
            self.diagnostics.record_step(
                est.num_batch, loss=loss_val,
                lr=est.trainer.learning_rate, trainer="Estimator")
        if check:
            self.diagnostics.sentinel_check(loss_val, "loss", est.num_batch)

    def train_end(self, est):
        if self._armed_watchdog:
            self.diagnostics.disarm_watchdog()
            self._armed_watchdog = False


class CheckpointHandler(EpochEnd):
    """Save params every `epoch_period` epochs (reference
    CheckpointHandler; `save_best` keeps the best by `monitor`)."""

    def __init__(self, model_dir, model_prefix="model", epoch_period=1,
                 monitor=None, mode="min", save_best=False):
        import os
        self.dir = model_dir
        os.makedirs(model_dir, exist_ok=True)
        self.prefix = model_prefix
        self.epoch_period = epoch_period
        self.monitor = monitor
        self.sign = 1.0 if mode == "min" else -1.0
        self.save_best = save_best
        self.best = None

    def epoch_end(self, est):
        import os
        if est.num_epoch % self.epoch_period:
            return
        path = os.path.join(self.dir,
                            f"{self.prefix}-epoch{est.num_epoch}.params")
        est.net.save_parameters(path)
        if self.save_best and self.monitor is not None:
            val = self.sign * self.monitor.get()[1]
            if self.best is None or val < self.best:
                self.best = val
                est.net.save_parameters(
                    os.path.join(self.dir, f"{self.prefix}-best.params"))


class EarlyStoppingHandler(EpochEnd):
    """Stop when `monitor` hasn't improved for `patience` epochs."""

    def __init__(self, monitor, mode="min", patience=3, min_delta=0.0):
        self.monitor = monitor
        self.sign = 1.0 if mode == "min" else -1.0
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.bad = 0

    def epoch_end(self, est):
        val = self.sign * self.monitor.get()[1]
        if self.best is None or val < self.best - self.min_delta:
            self.best = val
            self.bad = 0
        else:
            self.bad += 1
            if self.bad >= self.patience:
                est.stop_training = True


class Estimator:
    """The fit() loop (reference Estimator). net: gluon Block; loss: gluon
    Loss; train_metrics: list of mx.metric.EvalMetric; trainer: gluon
    Trainer (built from `optimizer`/`optimizer_params` when omitted)."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 optimizer="adam", optimizer_params=None):
        from ... import metric as _metric
        from .. import Trainer
        self.net = net
        self.loss = loss
        self.train_metrics = list(train_metrics or [_metric.Loss("loss")])
        self.trainer = trainer or Trainer(
            net.collect_params(), optimizer,
            optimizer_params or {"learning_rate": 1e-3})
        self.stop_training = False
        self.num_epoch = 0
        self.num_batch = 0
        self.max_epoch = None
        self.max_batch = None
        self.last_outputs = []
        self.last_labels = []

    def evaluate(self, val_data, val_metrics):
        for m in val_metrics:
            m.reset()
        for data, label in val_data:
            out = self.net(data)
            for m in val_metrics:
                m.update([label], [out])
        return val_metrics

    def _epoch_iter(self, train_data):
        """One epoch's batch iterator. A gluon DataLoader is wrapped in
        dataflow.prefetch_to_mesh (depth: the device_prefetch_depth knob,
        0 disables) so batches are staged onto the device while the
        current batch trains — H2D transfer overlaps compute. Returns
        (iterator, closer); the closer shuts the prefetch thread down
        even when the epoch ends early (StoppingHandler, exception)."""
        from ... import config, dataflow
        from ..data.dataloader import DataLoader
        depth = config.get("device_prefetch_depth")
        if depth and isinstance(train_data, DataLoader):
            pf = dataflow.prefetch_to_mesh(iter(train_data), None,
                                           depth=depth)
            return pf, pf.close
        return train_data, lambda: None

    def _handlers(self, event_handlers, epochs):
        hs = list(event_handlers or [])
        if not any(isinstance(h, StoppingHandler) for h in hs):
            hs.insert(0, StoppingHandler(max_epoch=epochs))
        if not any(isinstance(h, MetricHandler) for h in hs):
            hs.insert(1, MetricHandler(self.train_metrics))
        return hs

    def _resilience_setup(self, resume, checkpoint_dir):
        """Resolve the fit loop's checkpoint/resume behavior. Explicit
        `resume`/`checkpoint_dir` arguments are their own opt-in; the
        config knobs additionally require mx.resilience to be enabled, so
        the disabled default path stays a single module-bool check with
        no manifest hashing."""
        from ... import config, resilience
        cd = checkpoint_dir
        if cd is None and (resilience._enabled or resume):
            cd = config.get("checkpoint_dir") or None
        pol = resume
        if pol is None and resilience._enabled:
            pol = config.get("resume") or None
        if pol and not cd:
            raise ValueError(
                "fit(resume=...) needs a checkpoint directory: pass "
                "checkpoint_dir= or set the checkpoint_dir config knob")
        restored = None
        if pol and cd:
            restored = resilience.restore_estimator(self, cd, pol)
        return resilience, cd, restored

    def fit(self, train_data, epochs=1, event_handlers=None, resume=None,
            checkpoint_dir=None):
        """Run the fit loop. `resume="auto"` (with `checkpoint_dir` here
        or the config knob) restores the newest VERIFIED fit checkpoint —
        net params, optimizer state, RNG, epoch/batch counters — and
        skips the already-consumed epochs; an explicit `resume=<path>`
        restores that checkpoint. When a checkpoint directory is
        configured, every completed epoch writes an atomic manifest'd
        checkpoint (keep-last-N per the checkpoint_keep knob), and a
        SIGTERM handled by mx.resilience saves state and exits
        EXIT_PREEMPTED at the next batch boundary."""
        from .. import utils as _gutils
        from ... import autograd

        _res, ckpt_dir, _restored = self._resilience_setup(
            resume, checkpoint_dir)
        handlers = self._handlers(event_handlers, epochs)

        def fire(kind):
            for h in handlers:
                getattr(h, kind)(self) if hasattr(h, kind) else None

        self.stop_training = False
        fire("train_begin")
        if self.max_epoch is not None and self.num_epoch >= self.max_epoch:
            self.stop_training = True   # resumed past the last epoch
        while not self.stop_training:
            fire("epoch_begin")
            epoch_iter, close_iter = self._epoch_iter(train_data)
            try:
                for data, label in epoch_iter:
                    if self.stop_training:
                        break
                    fire("batch_begin")
                    with autograd.record():
                        out = self.net(data)
                        loss = self.loss(out, label)
                    loss.backward()
                    self.trainer.step(data.shape[0])
                    self.last_outputs = [out]
                    self.last_labels = [label]
                    self.last_loss = loss
                    self.num_batch += 1
                    fire("batch_end")
                    if _res._enabled and _res.preempted():
                        # NO mid-epoch save: fit checkpoints are epoch-
                        # granular, and the resumed run replays the
                        # interrupted epoch from its start — saving the
                        # mid-epoch params here would overwrite the clean
                        # end-of-epoch checkpoint and double-apply this
                        # epoch's partial updates on replay. The retained
                        # boundary checkpoint IS the resume point.
                        _res.note_preemption(
                            step=self.num_epoch,
                            path=_res.list_checkpoints(ckpt_dir)[-1][1]
                            if ckpt_dir and _res.list_checkpoints(ckpt_dir)
                            else None)
                        raise _res.PreemptedExit(
                            f"preempted during epoch {self.num_epoch}")
            finally:
                close_iter()
            self.num_epoch += 1
            fire("epoch_end")
            if ckpt_dir:
                _res.save_estimator(self, ckpt_dir)
            if self.max_epoch is not None \
                    and self.num_epoch >= self.max_epoch:
                self.stop_training = True
        fire("train_end")
        return self
