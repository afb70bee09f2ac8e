"""Training callbacks (counterpart of `mxnet_tpu/callback.py`, copied;
reference: `python/mxnet/callback.py`)."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric", "ProgressBar",
           "module_checkpoint", "LogValidationMetricsCallback"]


class Speedometer:
    """Log samples/sec every `frequent` batches (reference: Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / (time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s" % (
                        param.epoch, count, speed,
                        "\t".join(f"{n}={v:.6f}" for n, v in name_value))
                else:
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec" % (
                        param.epoch, count, speed)
                logging.info(msg)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint callback (reference: mx.callback.do_checkpoint)."""

    def _callback(iter_no, sym=None, arg=None, aux=None, module=None):
        if (iter_no + 1) % period == 0 and module is not None:
            module.save_checkpoint(prefix, iter_no + 1)
    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


module_checkpoint = do_checkpoint


class ProgressBar:
    def __init__(self, total, length=80):
        self.total = total
        self.length = length

    def __call__(self, param):
        count = param.nbatch
        filled = int(round(self.length * count / float(self.total)))
        bar = "=" * filled + "-" * (self.length - filled)
        print(f"[{bar}] {count}/{self.total}", end="\r")


class LogValidationMetricsCallback:
    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name, value)
