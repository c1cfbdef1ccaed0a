"""The training CLI's metric logger: a chain of sinks with per-metric
frequency throttling.

Counterpart of ``ml_mdm_tpu/utils/simple_logger.py``. ``Logger`` passes a
scalar on to the sinks behind it at most once every ``logging_freq``
batches per metric name; ``TensorboardLogger`` is such a sink where
``torch.utils.tensorboard`` imports (the CLI adds it inside a ``try``).
"""
from __future__ import annotations

import os


class LoggerBase:
    def __init__(self, output_dir, logging_freq):
        self._batch_num = 0
        self._output_dir = output_dir
        self._logging_freq = logging_freq
        self.next_logger = None
        self.call_backs = []
        self._last_step_batch_num = {}

    @property
    def batch_num(self):
        return self._batch_num

    @batch_num.setter
    def batch_num(self, value):
        self._batch_num = value

    def add_figure(self, name, fig):
        raise NotImplementedError

    def add_scalar(self, name, value):
        raise NotImplementedError

    def add_scalars(self, name, value):
        raise NotImplementedError

    def add_callback(self, callback):
        self.call_backs.append(callback)


class Logger(LoggerBase):
    def add_tensorboard_logger(self):
        tb_logger = TensorboardLogger(self._output_dir, self._logging_freq)
        tb_logger.batch_num = self.batch_num
        tb_logger.next_logger = self.next_logger
        self.next_logger = tb_logger

    @property
    def batch_num(self):
        return self._batch_num

    @batch_num.setter
    def batch_num(self, value):
        self._batch_num = value
        nxt = self.next_logger
        while nxt is not None:
            nxt.batch_num = value
            nxt = nxt.next_logger

    def needs_update(self, name):
        if name in self._last_step_batch_num and self._batch_num < (
            self._last_step_batch_num[name] + self._logging_freq
        ):
            return False
        self._last_step_batch_num[name] = self._batch_num
        return True

    def _fanout(self, method, name, value):
        if not self.needs_update(name):
            return
        nxt = self.next_logger
        while nxt is not None:
            getattr(nxt, method)(name, value)
            nxt = nxt.next_logger

    def add_scalar(self, name, value):
        self._fanout("add_scalar", name, value)

    def add_figure(self, name, value):
        self._fanout("add_figure", name, value)

    def add_scalars(self, name, value):
        self._fanout("add_scalars", name, value)

    def execute_callbacks(self):
        for callback in self.call_backs:
            callback(self)


class TensorboardLogger(LoggerBase):
    def __init__(self, output_dir, logging_freq):
        super().__init__(output_dir, logging_freq)
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(output_dir, exist_ok=True)
        self.tb_writer = SummaryWriter(log_dir=output_dir)

    def add_scalar(self, name, value):
        self.tb_writer.add_scalar(name, float(value), self.batch_num)

    def add_figure(self, name, value):
        self.tb_writer.add_figure(name, value, self.batch_num)

    def add_scalars(self, name, value):
        self.tb_writer.add_scalars(name, value, self.batch_num)
