"""The protobuf wire format of the per-query overlap records, in plain Python.

Reads and writes the three proto3 messages of ``query_overlap.proto``
(:data:`.query_overlap_pb2.SERIALIZED_FILE`) that the overlap records use,
without the protobuf runtime::

    QueryOverlapIndices    { uint32 query_idx = 1;
                             repeated QueryPosOverlapIndices qp_overlap_indices = 2; }
    QueryPosOverlapIndices { uint32 positive_idx = 2;
                             repeated Uint32Pair overlap_indices = 3;
                             repeated Uint32Pair inv_overlap_indices = 4; }
    Uint32Pair             { uint32 idx1 = 1; repeated uint32 near_indices2 = 2;
                             repeated uint32 far_indices2 = 3;
                             repeated uint32 bad_far_indices2 = 4; }

:func:`encode_query_overlap` writes what protobuf's ``SerializeToString``
writes: fields in field-number order, a scalar equal to 0 and an empty
repeated ``uint32`` left out, repeated ``uint32`` packed (one
length-delimited run of varints), every element of a repeated message
written (an empty one as its tag and a zero length).
:func:`decode_query_overlap` reads that and what any conforming writer may
write: repeated ``uint32`` packed or unpacked, or both, fields in any
order, a repeated scalar's last value winning, a varint of more than 32
bits cut to its low 32 (as protobuf does), and every field it does not
use skipped: ``inv_overlap_indices`` and unknown fields of any wire type.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

# wire types
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5
_UINT32_MAX = 2**32 - 1

# (idx1, near_indices2, far_indices2, bad_far_indices2)
Pair = Tuple[int, List[int], List[int], List[int]]


# ------------------------------------------------------------------ writing
def _varint(value: int) -> bytes:
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _uint32(value, what: str) -> int:
    v = int(value)
    if not 0 <= v <= _UINT32_MAX:
        raise ValueError(f"{what} = {v} does not fit a uint32")
    return v


def _encode_varints(values: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """The varints of uint32 ``values`` back to back, and the byte offset
    at which each value's varint starts (with the total at the end)."""
    v = values.astype(np.uint64)
    width = np.ones(v.size, np.int64)
    for j in range(1, 5):
        width += v >= np.uint64(1 << (7 * j))
    offsets = np.concatenate([[0], np.cumsum(width)])
    out = np.zeros(int(offsets[-1]), np.uint8)
    for j in range(5):
        has = width > j
        byte = (v[has] >> np.uint64(7 * j)) & np.uint64(0x7F)
        more = (width[has] > j + 1).astype(np.uint64) << np.uint64(7)
        out[offsets[:-1][has] + j] = (byte | more).astype(np.uint8)
    return out.tobytes(), offsets


def _field_uint32(number: int, value: int, what: str) -> bytes:
    v = _uint32(value, what)
    return _varint(number << 3 | _VARINT) + _varint(v) if v else b""


def _field_len(number: int, payload: bytes) -> bytes:
    return _varint(number << 3 | _LEN) + _varint(len(payload)) + payload


def encode_query_overlap(query_idx: int, per_positive: Iterable[Tuple[int, Iterable[Pair]]]) -> bytes:
    """One ``QueryOverlapIndices`` message: ``query_idx`` and, in the order
    given, each positive's index and its ``(idx1, near, far, bad_far)``
    ``Uint32Pair`` entries. A value outside uint32 raises ``ValueError``.
    The repeated fields' varints are encoded in one vectorised pass."""
    positives = [(pos_idx, list(pairs)) for pos_idx, pairs in per_positive]
    lists = [pair[1 + f] for _, pairs in positives for pair in pairs for f in range(3)]
    flat = np.array([int(x) for seq in lists for x in seq], dtype=object)
    if flat.size and not (flat.min() >= 0 and flat.max() <= _UINT32_MAX):
        bad = next(x for x in flat if not 0 <= x <= _UINT32_MAX)
        raise ValueError(f"a repeated index = {bad} does not fit a uint32")
    payload, offsets = _encode_varints(flat.astype(np.int64))
    ends = offsets[np.cumsum([0] + [len(seq) for seq in lists])].tolist()

    out = [_field_uint32(1, query_idx, "query_idx")]
    k = 0
    for pos_idx, pairs in positives:
        qp = [_field_uint32(2, pos_idx, "positive_idx")]
        for pair in pairs:
            msg = [_field_uint32(1, pair[0], "idx1")]
            for f in range(3):
                if ends[k + 1] > ends[k]:
                    msg.append(_field_len(2 + f, payload[ends[k]:ends[k + 1]]))
                k += 1
            qp.append(_field_len(3, b"".join(msg)))
        out.append(_field_len(2, b"".join(qp)))
    return b"".join(out)


# ------------------------------------------------------------------ reading
def _read_varint(buf: bytes, pos: int, end: int) -> Tuple[int, int]:
    value, shift = 0, 0
    while True:
        if pos >= end:
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes")


def _fields(buf: bytes, pos: int, end: int):
    """``(field number, wire type, value)`` of each field of the message in
    ``buf[pos:end]``: an int for a varint, the ``(start, end)`` of its
    payload for a length-delimited field, None for a field skipped
    (fixed-width, group)."""
    while pos < end:
        key, pos = _read_varint(buf, pos, end)
        number, wire = key >> 3, key & 7
        if number == 0:
            raise ValueError("field number 0")
        if wire == _VARINT:
            value, pos = _read_varint(buf, pos, end)
        elif wire == _LEN:
            size, pos = _read_varint(buf, pos, end)
            value, pos = (pos, pos + size), pos + size
        elif wire == _I64:
            value, pos = None, pos + 8
        elif wire == _I32:
            value, pos = None, pos + 4
        elif wire == _SGROUP:
            value, pos = None, _skip_group(buf, pos, end, number)
        else:
            raise ValueError(f"unexpected wire type {wire}")
        if pos > end:
            raise ValueError("truncated field")
        yield number, wire, value


def _skip_group(buf: bytes, pos: int, end: int, number: int) -> int:
    """The position just past the end-group tag of group ``number``."""
    while True:
        key, pos = _read_varint(buf, pos, end)
        wire = key & 7
        if wire == _EGROUP:
            if key >> 3 != number:
                raise ValueError("mismatched end of group")
            return pos
        if wire == _SGROUP:
            pos = _skip_group(buf, pos, end, key >> 3)
        elif wire == _VARINT:
            _, pos = _read_varint(buf, pos, end)
        elif wire == _LEN:
            size, pos = _read_varint(buf, pos, end)
            pos += size
        elif wire in (_I64, _I32):
            pos += 8 if wire == _I64 else 4
        else:
            raise ValueError(f"unexpected wire type {wire}")


def _decode_spans(buf: bytes, spans: List[Tuple[int, int]]) -> List[List[int]]:
    """The uint32 values of each packed run of varints ``buf[s:e]``, all
    runs decoded in one vectorised pass."""
    if not spans:
        return []
    starts = np.array([s for s, _ in spans], np.int64)
    lengths = np.array([e - s for s, e in spans], np.int64)
    first = np.concatenate([[0], np.cumsum(lengths)])
    b = np.frombuffer(buf, np.uint8)[np.repeat(starts - first[:-1], lengths) + np.arange(first[-1])]
    last = b < 0x80
    tail = first[1:][lengths > 0] - 1
    if not last[tail].all():
        raise ValueError("truncated packed varint")
    which = np.concatenate([[0], np.cumsum(last)[:-1]])            # the varint each byte belongs to
    begin = np.flatnonzero(np.concatenate([[True], last[:-1]]))
    shift = 7 * (np.arange(b.size) - begin[which])
    if b.size and shift.max() >= 70:
        raise ValueError("varint longer than 10 bytes")
    # a byte at bit 35 or past it sets only bits that the cut to 32 drops
    part = (b & 0x7F).astype(np.uint64) << np.minimum(shift, 35).astype(np.uint64)
    part[shift >= 35] = 0
    values = np.zeros(int(last.sum()), np.uint64)
    np.add.at(values, which, part)
    values = (values & np.uint64(_UINT32_MAX)).astype(np.int64)
    ends = np.concatenate([[0], np.cumsum(last)])[first]
    return [values[ends[i]:ends[i + 1]].tolist() for i in range(len(spans))]


def decode_query_overlap(buf: bytes) -> Tuple[int, List[Tuple[int, List[Pair]]]]:
    """One ``QueryOverlapIndices`` message: ``(query_idx, [(positive_idx,
    [(idx1, near, far, bad_far), ...]), ...])`` in the order the positives
    were written. Malformed input raises ``ValueError``. The packed
    fields' varints are decoded in one vectorised pass."""
    buf = bytes(buf)
    spans: List[Tuple[int, int]] = []
    query_idx, positives = 0, []
    # each pair's lists as pieces: an int names a packed span, a list holds
    # unpacked values
    for number, wire, value in _fields(buf, 0, len(buf)):
        if number == 1 and wire == _VARINT:
            query_idx = value & _UINT32_MAX
        elif number == 2 and wire == _LEN:
            pos_idx, pairs = 0, []
            for n, w, v in _fields(buf, *value):
                if n == 2 and w == _VARINT:
                    pos_idx = v & _UINT32_MAX
                elif n == 3 and w == _LEN:
                    idx1, pieces = 0, ([], [], [])
                    for f, fw, fv in _fields(buf, *v):
                        if f == 1 and fw == _VARINT:
                            idx1 = fv & _UINT32_MAX
                        elif 2 <= f <= 4 and fw == _LEN:
                            pieces[f - 2].append(len(spans))
                            spans.append(fv)
                        elif 2 <= f <= 4 and fw == _VARINT:
                            pieces[f - 2].append([fv & _UINT32_MAX])
                    pairs.append((idx1, pieces))
            positives.append((pos_idx, pairs))
    decoded = _decode_spans(buf, spans)

    def values(pieces) -> List[int]:
        if len(pieces) == 1 and isinstance(pieces[0], int):
            return decoded[pieces[0]]
        out: List[int] = []
        for p in pieces:
            out.extend(decoded[p] if isinstance(p, int) else p)
        return out

    return query_idx, [(pos_idx, [(idx1, *(values(p) for p in pieces)) for idx1, pieces in pairs])
                       for pos_idx, pairs in positives]
