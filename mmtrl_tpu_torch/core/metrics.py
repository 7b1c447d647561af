"""On-device episode statistics and the TensorBoard writer; port of
``EpisodeStatistics`` (reference: cleanrl/ppo_atari_envpool_xla_jax.py:158-164)
and ``MetricsWriter`` in ``mmtrl_tpu/core/metrics.py``.

``MetricsWriter`` writes the event file itself (``EventFileWriter``):
``torch.utils.tensorboard`` imports the ``tensorboard`` package, which the
port does not need.  TensorBoard reads the files as it reads the JAX
package's.  ``read_scalars`` reads them back, and the files of torch's
``SummaryWriter``, without TensorBoard: the plot and tuner tools
(``utils/plot.py``, ``plot_individual.py``, ``tuner.py``) read through it
where the JAX package's use TensorBoard's ``EventAccumulator``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import socket
import struct
import sys
import time
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from mmtrl_tpu_torch.utils import wandb_local


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


# ---- reading them back ------------------------------------------------------

def _varint_at(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, pos


def _proto_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """(field number, wire type, value) of a serialized message: an int for
    a varint, the raw bytes otherwise."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint_at(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint_at(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint_at(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire} in an event")
        yield number, wire, value


def read_records(path: str) -> Iterator[bytes]:
    """The serialized events of one event file, in order.  A record cut
    short at the end of the file (a run still writing, or killed) ends the
    file, as TensorBoard's loader ends it; a whole record whose masked
    CRC-32C does not match raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (header_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if header_crc != _masked_crc32c(header):
            raise ValueError(f"{path}: corrupt record length at byte {pos}")
        end = pos + 12 + length + 4
        if end > len(data):
            return
        event = data[pos + 12:pos + 12 + length]
        if struct.unpack("<I", data[end - 4:end])[0] != _masked_crc32c(event):
            raise ValueError(f"{path}: corrupt record at byte {pos}")
        yield event
        pos = end


def read_scalars(run_dir: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{tag: (steps int64, values float64)} of every ``simple_value`` summary
    in the event files of ``run_dir``, the files in name order and each in
    file order: what ``EventAccumulator(run_dir).Scalars(tag)`` gives up to
    its 10,000-point reservoir per tag, past which TensorBoard samples and
    this keeps every point.  Tensor summaries (the hyperparameter text) are
    not scalars there either."""
    series: Dict[str, Tuple[list, list]] = {}
    names = sorted(n for n in os.listdir(run_dir) if "tfevents" in n)
    for name in names:
        for event in read_records(os.path.join(run_dir, name)):
            step, summary = 0, b""
            for number, _, value in _proto_fields(event):
                if number == 2:
                    step = value - (1 << 64) if value >= 1 << 63 else value
                elif number == 5:
                    summary = value
            for number, _, value in _proto_fields(summary):
                if number != 1:
                    continue
                tag, simple = None, None
                for vnumber, wire, v in _proto_fields(value):
                    if vnumber == 1:
                        tag = v.decode()
                    elif vnumber == 2 and wire == 5:
                        (simple,) = struct.unpack("<f", v)
                if tag is not None and simple is not None:
                    steps, values = series.setdefault(tag, ([], []))
                    steps.append(step)
                    values.append(simple)
    return {tag: (np.array(s, dtype=np.int64), np.array(v, dtype=np.float64))
            for tag, (s, v) in series.items()}


class MetricsWriter:
    """TensorBoard sink with the reference's standardized scalar names
    (``charts/*``, ``losses/*``, ``charts/SPS``, ``charts/SPS_cumulative``)
    and the hyperparameter table, under ``$MMTRL_RUN_ROOT`` (default
    ``runs``)/<run_name>.  With ``config.track`` every scalar is mirrored to
    the wandb-compatible local journal, ``wandb_local/<project>/<run_name>``
    (``utils/wandb_local.py``; the project is ``config.wandb_project_name``),
    as the JAX writer mirrors it (the reference mirrors TensorBoard to
    wandb, src/train.py:75-83); ``close`` marks that run finished."""

    def __init__(self, run_name: str, config: Optional[Any] = None, root: str = "runs"):
        self.run_name = run_name
        root = os.environ.get("MMTRL_RUN_ROOT", root)
        self.writer = EventFileWriter(f"{root}/{run_name}")
        self.start_time = time.time()
        self._last_step, self._last_time = 0, self.start_time
        self.track_run = None
        if config is not None and getattr(config, "track", False):
            project = getattr(config, "wandb_project_name", None) or "mmtrl"
            self.track_run = wandb_local.init(project, run_name, config=config, argv=sys.argv)
        if config is not None:
            items = (dataclasses.asdict(config).items() if dataclasses.is_dataclass(config)
                     else vars(config).items())
            table = "|param|value|\n|-|-|\n" + "\n".join(f"|{k}|{v}|" for k, v in items)
            self.writer.add_text("hyperparameters", table)

    def scalar(self, tag: str, value: Any, step: int) -> None:
        self.writer.add_scalar(tag, float(value), step)
        if self.track_run is not None:
            self.track_run.log({tag: float(value)}, step)

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
        if self.track_run is not None:
            self.track_run.finish()
