"""On-device episode statistics and the TensorBoard writer; port of
``EpisodeStatistics`` (reference: cleanrl/ppo_atari_envpool_xla_jax.py:158-164)
and ``MetricsWriter`` in ``mmtrl_tpu/core/metrics.py``.

``MetricsWriter`` writes the event file itself (``EventFileWriter``):
``torch.utils.tensorboard`` imports the ``tensorboard`` package, which the
port does not need.  TensorBoard reads the files as it reads the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import socket
import struct
import time
from typing import Any, Mapping, Optional

import torch


@dataclasses.dataclass
class EpisodeStatistics:
    """Per-env running episode accumulators, all fixed-shape tensors."""

    episode_returns: torch.Tensor  # (num_envs,) running sum of raw rewards
    episode_lengths: torch.Tensor  # (num_envs,) running step count
    returned_episode_returns: torch.Tensor  # (num_envs,) last completed return
    returned_episode_lengths: torch.Tensor  # (num_envs,) last completed length
    episode_count: torch.Tensor  # () int32 total completed episodes
    sum_returns: torch.Tensor  # () sum of ALL completed episode returns
    sum_lengths: torch.Tensor  # () sum of ALL completed episode lengths

    @classmethod
    def create(cls, num_envs: int, device: torch.device) -> "EpisodeStatistics":
        z = torch.zeros(num_envs, dtype=torch.float32, device=device)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return cls(
            episode_returns=z,
            episode_lengths=z,
            returned_episode_returns=z,
            returned_episode_lengths=z,
            episode_count=torch.zeros((), dtype=torch.int32, device=device),
            sum_returns=zero,
            sum_lengths=zero,
        )

    @property
    def mean_return(self) -> torch.Tensor:
        """Mean over ALL completed episodes (not just each env's last)."""
        return self.sum_returns / self.episode_count.clamp(min=1)

    @property
    def mean_length(self) -> torch.Tensor:
        return self.sum_lengths / self.episode_count.clamp(min=1)

    def update(self, reward: torch.Tensor, done: torch.Tensor) -> "EpisodeStatistics":
        """Accumulate one batched env step (raw rewards)."""
        done_f = done.float()
        new_returns = self.episode_returns + reward
        new_lengths = self.episode_lengths + 1.0
        return EpisodeStatistics(
            episode_returns=new_returns * (1.0 - done_f),
            episode_lengths=new_lengths * (1.0 - done_f),
            returned_episode_returns=torch.where(done, new_returns, self.returned_episode_returns),
            returned_episode_lengths=torch.where(done, new_lengths, self.returned_episode_lengths),
            episode_count=self.episode_count + done.int().sum(dtype=torch.int32),
            sum_returns=self.sum_returns + torch.where(done, new_returns, 0.0).sum(),
            sum_lengths=self.sum_lengths + torch.where(done, new_lengths, 0.0).sum(),
        )


# ---- TensorBoard event files, written without the tensorboard package -------
# A record is: u64 length, masked CRC-32C of those 8 bytes, the serialized
# ``Event`` proto, masked CRC-32C of it (TFRecord framing).  Only the fields
# used here are encoded: Event{wall_time=1 double, step=2 int64,
# file_version=3 string, summary=5}, Summary{value=1},
# Summary.Value{tag=1, simple_value=2 float, tensor=8, metadata=9}.

def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def _masked_crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _bytes_field(number: int, payload: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, summary: bytes = b"", file_version: str = "") -> bytes:
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time) + _varint(2 << 3) + _varint(step)
    if file_version:
        out += _bytes_field(3, file_version.encode())
    if summary:
        out += _bytes_field(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    return _bytes_field(1, _bytes_field(1, tag.encode())
                        + _varint(2 << 3 | 5) + struct.pack("<f", value))


def _text_value(tag: str, text: str) -> bytes:
    """A ``text``-plugin summary as ``SummaryWriter.add_text`` writes it: a
    DT_STRING tensor of shape (1,) under ``<tag>/text_summary``."""
    plugin = _bytes_field(1, b"text") + _bytes_field(2, b"")  # PluginData{name, content}
    metadata = _bytes_field(1, plugin)  # SummaryMetadata{plugin_data}
    shape = _bytes_field(2, _varint(1 << 3) + _varint(1))  # TensorShapeProto{dim{size 1}}
    tensor = _varint(1 << 3) + _varint(7) + _bytes_field(2, shape) + _bytes_field(8, text.encode())
    return _bytes_field(1, _bytes_field(1, f"{tag}/text_summary".encode())
                        + _bytes_field(8, tensor) + _bytes_field(9, metadata))


_writer_ids = itertools.count()


class EventFileWriter:
    """Appends events to ``<logdir>/events.out.tfevents.<time>.<host>.<pid>.<n>``;
    the process id and a per-process count, as TensorBoard's own writer
    names its files, keep two writers of one run (a training run's and its
    evaluation's) from truncating each other within a second."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}"
                f".{os.getpid()}.{next(_writer_ids)}")
        self.path = os.path.join(logdir, name)
        self._file = open(self.path, "wb")
        self._write(_event(time.time(), 0, file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._file.write(header + struct.pack("<I", _masked_crc32c(header))
                         + event + struct.pack("<I", _masked_crc32c(event)))
        self._file.flush()  # a few records an update: TensorBoard sees a live run

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step, _scalar_value(tag, value)))

    def add_text(self, tag: str, text: str, step: int = 0) -> None:
        self._write(_event(time.time(), step, _text_value(tag, text)))

    def close(self) -> None:
        self._file.close()


class MetricsWriter:
    """TensorBoard sink with the reference's standardized scalar names
    (``charts/*``, ``losses/*``, ``charts/SPS``, ``charts/SPS_cumulative``)
    and the hyperparameter table, under ``$MMTRL_RUN_ROOT`` (default
    ``runs``)/<run_name>.  Port of the JAX ``MetricsWriter`` without its
    ``--track`` mirror (wandb_local is not ported)."""

    def __init__(self, run_name: str, config: Optional[Any] = None, root: str = "runs"):
        self.run_name = run_name
        root = os.environ.get("MMTRL_RUN_ROOT", root)
        self.writer = EventFileWriter(f"{root}/{run_name}")
        self.start_time = time.time()
        self._last_step, self._last_time = 0, self.start_time
        if config is not None:
            items = (dataclasses.asdict(config).items() if dataclasses.is_dataclass(config)
                     else vars(config).items())
            table = "|param|value|\n|-|-|\n" + "\n".join(f"|{k}|{v}|" for k, v in items)
            self.writer.add_text("hyperparameters", table)

    def scalar(self, tag: str, value: Any, step: int) -> None:
        self.writer.add_scalar(tag, float(value), step)

    def scalars(self, values: Mapping[str, Any], step: int) -> None:
        for tag, value in values.items():
            self.scalar(tag, value, step)

    def sps(self, global_step: int) -> float:
        """Windowed steps/sec since the previous call (the cumulative average
        buries start-up time); also logs the cumulative value."""
        now = time.time()
        window = (global_step - self._last_step) / max(now - self._last_time, 1e-9)
        self._last_step, self._last_time = global_step, now
        self.scalar("charts/SPS", window, global_step)
        self.scalar("charts/SPS_cumulative",
                    global_step / max(now - self.start_time, 1e-9), global_step)
        return window

    def close(self) -> None:
        self.writer.close()
