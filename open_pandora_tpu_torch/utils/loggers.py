"""Training metrics: JSONL always, plus TensorBoard, CSV or wandb.

Counterpart of open_pandora_tpu/utils/loggers.py (the reference's
TensorBoard, wandb and CSV loggers, utils/utils_train.py:90-121) with the
same files and bytes: `MetricsLogger` writes {"step": n, **metrics} to
metrics.jsonl and to each backend named in its comma list. The TensorBoard
backend writes `events.out.tfevents.*` itself (the Event and Summary
protobufs, TFRecord framing with masked CRC-32C), with the stdlib only;
wandb is imported when its backend is asked for.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Dict, List, Optional


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """The TFRecord framing's masked CRC-32C."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _encode_summary(values: Dict[str, float]) -> bytes:
    # Summary { repeated Value value = 1 };
    # Value { string tag = 1; float simple_value = 2 }
    out = bytearray()
    for tag, v in values.items():
        val = (_field_bytes(1, tag.encode("utf-8"))
               + bytes([(2 << 3) | 5]) + struct.pack("<f", float(v)))
        out += _field_bytes(1, val)
    return bytes(out)


def _encode_event(wall_time: float, step: int = 0,
                  summary: Optional[bytes] = None,
                  file_version: Optional[str] = None) -> bytes:
    # Event { double wall_time = 1; int64 step = 2; string file_version = 3;
    #         Summary summary = 5 }
    out = bytearray(struct.pack("<Bd", 0x09, wall_time))
    if step:
        out += bytes([0x10]) + _varint(step)
    if file_version is not None:
        out += _field_bytes(3, file_version.encode("utf-8"))
    if summary is not None:
        out += _field_bytes(5, summary)
    return bytes(out)


class TensorBoardWriter:
    """Scalar event files any TensorBoard reads."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(os.path.join(logdir, name), "ab")
        self._write_record(_encode_event(time.time(),
                                         file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header + struct.pack("<I", masked_crc(header)) + data
                      + struct.pack("<I", masked_crc(data)))
        self._f.flush()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self._write_record(_encode_event(time.time(), step,
                                         summary=_encode_summary(metrics)))

    def close(self) -> None:
        self._f.close()


class CSVWriter:
    """metrics.csv: a step column and the first logged record's keys,
    sorted; the header is written only into an empty file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, "metrics.csv")
        self._keys: List[str] = []
        self._f = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if self._f is None:
            self._keys = sorted(metrics)
            self._f = open(self._path, "a")
            if self._f.tell() == 0:
                self._f.write(",".join(["step"] + self._keys) + "\n")
        row = [str(step)] + [repr(float(metrics[k])) if k in metrics else ""
                             for k in self._keys]
        self._f.write(",".join(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()


class JSONLWriter:
    """One JSON line per logged step, flushed after each."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self._f.write(json.dumps({"step": step, **metrics}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class WandbWriter:  # pragma: no cover - wandb is not installed
    def __init__(self, logdir: str, name: str = "open-pandora-tpu"):
        import wandb

        self._run = wandb.init(project=name, dir=logdir)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self._run.log(metrics, step=step)

    def close(self) -> None:
        self._run.finish()


_BACKENDS = {"tensorboard": TensorBoardWriter, "csv": CSVWriter,
             "wandb": WandbWriter}


class MetricsLogger:
    """metrics.jsonl in `loginfo_dir`, plus each backend of the comma list
    `backends` ("none" or "" for none): TensorBoard under loginfo_dir/tb,
    CSV and wandb in loginfo_dir."""

    def __init__(self, loginfo_dir: str, backends: str = "tensorboard"):
        self._writers: List = [
            JSONLWriter(os.path.join(loginfo_dir, "metrics.jsonl"))]
        for b in [x for x in backends.split(",") if x and x != "none"]:
            if b not in _BACKENDS:
                raise ValueError(f"unknown logger backend {b!r}; "
                                 f"choose from {sorted(_BACKENDS)}")
            self._writers.append(_BACKENDS[b](
                os.path.join(loginfo_dir, "tb") if b == "tensorboard"
                else loginfo_dir))

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        clean = {k: float(v) for k, v in metrics.items()}
        for w in self._writers:
            w.log(step, clean)

    def close(self) -> None:
        for w in self._writers:
            w.close()
