"""TensorBoard event-file writer, dependency-free.

The port's own copy of the JAX package's ``obs/tbevents.py`` (stdlib only;
its event files are byte-equal to the JAX copy's).  The reference's PVNet half logs through tensorboardX (``Recorder``,
lib/utils/net_utils.py:152-239: ``add_scalar`` per loss/metric into
``logdir/<model>_<time>``); a user pointing a TensorBoard dashboard at a
run directory expects ``events.out.tfevents.*`` files.  The TSV/JSONL
channels (obs/logger.py) cover the *capability*; this module covers the
*file format* — scalar summaries serialized with a hand-rolled protobuf
encoder and the TFRecord framing (length + masked-crc32c records), so no
tensorflow/tensorboardX dependency is needed.

Wire format (both fixed by TensorFlow's public .proto files):

* TFRecord framing: ``uint64 len | uint32 masked_crc(len) | data |
  uint32 masked_crc(data)``, crc32c (Castagnoli) with TF's rotate+add
  mask.
* ``Event`` proto: field 1 ``wall_time`` (double), field 2 ``step``
  (int64), field 3 ``file_version`` (string, first record only), field 5
  ``summary`` (``Summary`` message: repeated ``Value`` with field 1
  ``tag`` string / field 2 ``simple_value`` float).

:class:`read_scalars` parses the same format back (used by the tests and
handy for offline analysis without TB installed).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# -- crc32c (Castagnoli), table-driven --------------------------------------

_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TF's masked crc: rotate right 15 and add a constant."""
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding ----------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f64(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack('<d', v)


def _f32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack('<f', v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(wall_time: float, step: int,
                  scalars: dict[str, float]) -> bytes:
    summary = b''.join(
        _bytes_field(1, _bytes_field(1, tag.encode()) + _f32(2, float(val)))
        for tag, val in scalars.items())
    return _f64(1, wall_time) + _int64(2, step) + _bytes_field(5, summary)


def _version_event(wall_time: float) -> bytes:
    return _f64(1, wall_time) + _bytes_field(3, b'brain.Event:2')


class TbWriter:
    """Append scalar events to one ``events.out.tfevents`` file.

    >>> tb = TbWriter(logdir)
    >>> tb.scalars(step, {'train/loss': 0.01, 'train/lr': 1e-4})
    >>> tb.close()
    """

    def __init__(self, logdir: str, filename_suffix: str = ''):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or 'local'
        self.path = os.path.join(
            logdir,
            f'events.out.tfevents.{int(time.time())}.{host}'
            f'{filename_suffix}')
        self._file = open(self.path, 'ab')
        self._write(_version_event(time.time()))

    def _write(self, event: bytes) -> None:
        header = struct.pack('<Q', len(event))
        self._file.write(header)
        self._file.write(struct.pack('<I', _masked_crc(header)))
        self._file.write(event)
        self._file.write(struct.pack('<I', _masked_crc(event)))
        self._file.flush()

    def scalar(self, step: int, tag: str, value: float,
               wall_time: float | None = None) -> None:
        self.scalars(step, {tag: value}, wall_time)

    def scalars(self, step: int, values: dict[str, float],
                wall_time: float | None = None) -> None:
        """One Event carrying every (tag, simple_value) pair."""
        self._write(_scalar_event(
            time.time() if wall_time is None else wall_time, step, values))

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- reader (tests / offline analysis) ---------------------------------------

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _parse_fields(buf: bytes):
    """Yield (field_number, wire_type, value) from one message."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:  # pragma: no cover — groups unused in Event
            raise ValueError(f'unsupported wire type {wire}')
        yield field, wire, v


def read_scalars(path: str, check_crc: bool = True
                 ) -> list[tuple[int, str, float]]:
    """Parse an event file back into [(step, tag, simple_value), ...]."""
    out = []
    with open(path, 'rb') as f:
        data = f.read()
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack('<Q', header)
        if check_crc:
            (crc,) = struct.unpack('<I', data[i + 8:i + 12])
            if crc != _masked_crc(header):
                raise ValueError(f'{path}: corrupt length crc')
        event = data[i + 12:i + 12 + n]
        if check_crc:
            (crc,) = struct.unpack('<I', data[i + 12 + n:i + 16 + n])
            if crc != _masked_crc(event):
                raise ValueError(f'{path}: corrupt payload crc')
        i += 16 + n
        step = 0
        values = []
        for field, _, v in _parse_fields(event):
            if field == 2:
                step = v
            elif field == 5:
                for f2, _, val_msg in _parse_fields(v):
                    if f2 != 1:
                        continue
                    tag, simple = '', None
                    for f3, _, vv in _parse_fields(val_msg):
                        if f3 == 1:
                            tag = vv.decode()
                        elif f3 == 2:
                            (simple,) = struct.unpack('<f', vv)
                    if simple is not None:
                        values.append((tag, simple))
        out.extend((step, tag, val) for tag, val in values)
    return out
