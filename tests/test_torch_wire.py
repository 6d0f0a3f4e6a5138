"""The port's protobuf-free codec of the .pb overlap records, on the CPU.

``patchaugnet_tpu_torch.data.wire`` against protobuf's runtime and the JAX
package's ``load_overlap_pb`` / ``save_overlap_pb`` (which use protobuf):
the port writes the same bytes as ``SerializeToString`` for seeded
entries (empty lists, index 0, ``2**32 - 1``, several positives), reads
what the JAX package writes, and reads the forms a conforming writer may
also produce: repeated ``uint32`` unpacked, ``inv_overlap_indices``
(field 4), unknown fields of every wire type, varints past 32 bits.
Everything compared is exactly equal.
"""
import numpy as np
import pytest

from patchaugnet_tpu.data import overlap as joverlap

from patchaugnet_tpu_torch.data import OverlapEntry, load_overlap_pb, query_overlap_pb2, save_overlap_pb, wire
from patchaugnet_tpu_torch.data import overlap as poverlap

TOP = 2**32 - 1


def _entry_sets():
    rng = np.random.RandomState(0)

    def draw(n):
        return [int(v) for v in rng.choice([0, 1, 127, 128, 16383, 16384, 2**21, 2**28, TOP, 5000], n)]

    several = {int(p): [OverlapEntry(int(rng.randint(0, 4096)), draw(rng.randint(0, 9)), draw(rng.randint(0, 5)),
                                     draw(rng.randint(0, 5))) for _ in range(rng.randint(1, 6))]
               for p in (3, 0, 17, TOP, 12)}
    return {
        "no positives": {},
        "a positive without entries": {4: []},
        "empty lists": {0: [OverlapEntry(0, [], [], [])], 2: [OverlapEntry(7, [], [1], [])]},
        "index 0 and 2**32 - 1": {TOP: [OverlapEntry(TOP, [0, TOP], [TOP, 0, 0], [TOP])],
                                  0: [OverlapEntry(0, [0], [0], [0])]},
        "several positives": several,
    }


CASES = _entry_sets()


def _as_tuples(per_positive):
    return {p: [(e.idx1, list(e.near_indices2), list(e.far_indices2), list(e.bad_far_indices2)) for e in entries]
            for p, entries in per_positive.items()}


def _message(per_positive, query_idx=0, inverse=False):
    """The protobuf message of the same records (``inverse``: each
    positive also carries an ``inv_overlap_indices`` entry)."""
    msg = query_overlap_pb2.messages()["QueryOverlapIndices"]()
    msg.query_idx = query_idx
    for p, entries in per_positive.items():
        qp = msg.qp_overlap_indices.add()
        qp.positive_idx = p
        for e in entries:
            u = qp.overlap_indices.add()
            u.idx1 = e.idx1
            u.near_indices2.extend(e.near_indices2)
            u.far_indices2.extend(e.far_indices2)
            u.bad_far_indices2.extend(e.bad_far_indices2)
        if inverse:
            u = qp.inv_overlap_indices.add()
            u.idx1 = 99
            u.near_indices2.extend([1, TOP])
    return msg


@pytest.mark.parametrize("query_idx", [0, 5, TOP])
@pytest.mark.parametrize("case", list(CASES))
def test_writes_the_bytes_of_the_jax_package(tmp_path, case, query_idx):
    entries = CASES[case]
    poverlap.save_overlap_pb(str(tmp_path / "port.pb"), entries, query_idx=query_idx)
    joverlap.save_overlap_pb(str(tmp_path / "jax.pb"), entries, query_idx=query_idx)
    got = (tmp_path / "port.pb").read_bytes()
    assert got == (tmp_path / "jax.pb").read_bytes()
    assert got == _message(entries, query_idx).SerializeToString()


@pytest.mark.parametrize("case", list(CASES))
def test_reads_what_the_jax_package_writes(tmp_path, case):
    entries = CASES[case]
    joverlap.save_overlap_pb(str(tmp_path / "jax.pb"), entries, query_idx=9)
    got = load_overlap_pb(str(tmp_path / "jax.pb"))
    assert _as_tuples(got) == _as_tuples(joverlap.load_overlap_pb(str(tmp_path / "jax.pb"))) == _as_tuples(entries)
    assert wire.decode_query_overlap((tmp_path / "jax.pb").read_bytes())[0] == 9


def _field(number, wire_type, payload):
    return wire._varint(number << 3 | wire_type) + payload


def _unpacked_pair(idx1, near, far, bad):
    """A ``Uint32Pair`` whose near list is unpacked, far list split into a
    packed run, two unpacked values and another packed run, bad list packed."""
    out = _field(1, 0, wire._varint(idx1)) if idx1 else b""
    out += b"".join(_field(2, 0, wire._varint(v)) for v in near)
    half = len(far) // 2
    out += _field(3, 2, wire._varint(len(p := b"".join(wire._varint(v) for v in far[:half]))) + p)
    out += b"".join(_field(3, 0, wire._varint(v)) for v in far[half:half + 2])
    out += _field(3, 2, wire._varint(len(p := b"".join(wire._varint(v) for v in far[half + 2:]))) + p)
    out += _field(4, 2, wire._varint(len(p := b"".join(wire._varint(v) for v in bad))) + p)
    return out


def _len(number, payload):
    return _field(number, 2, wire._varint(len(payload)) + payload)


UNKNOWN = (_field(9, 0, wire._varint(300)) + _field(10, 1, bytes(range(8))) + _field(11, 5, b"\x01\x02\x03\x04")
           + _len(12, b"anything") + _field(13, 3, _field(1, 0, b"\x05") + _len(2, b"xy")) + _field(13, 4, b""))


def test_reads_unpacked_fields_and_skips_field_4_and_unknown_fields(tmp_path):
    """Repeated uint32 written unpacked (and mixed with packed runs), an
    ``inv_overlap_indices`` entry, unknown fields of every wire type (a
    group among them) at each level, and a positive's fields out of order:
    the port's reader and protobuf's agree."""
    pairs = [(5, [1, 2, TOP], [10, 11, 12, 13, 14, 15], [20]), (0, [7], [0, 0, 0], []), (TOP, [], [3, 4], [9])]
    qp = UNKNOWN + b"".join(_len(3, _unpacked_pair(*p) + UNKNOWN) for p in pairs)
    qp += _len(4, _unpacked_pair(8, [1], [2, 3], [4])) + _field(2, 0, wire._varint(41))
    data = UNKNOWN + _len(2, qp) + _field(1, 0, wire._varint(6)) + _len(2, _field(2, 0, wire._varint(42)))
    (tmp_path / "mixed.pb").write_bytes(data)
    got = load_overlap_pb(str(tmp_path / "mixed.pb"))
    want = joverlap.load_overlap_pb(str(tmp_path / "mixed.pb"))
    assert _as_tuples(got) == _as_tuples(want)
    assert _as_tuples(got) == {41: [(5, [1, 2, TOP], [10, 11, 12, 13, 14, 15], [20]), (0, [7], [0, 0, 0], []),
                                    (TOP, [], [3, 4], [9])], 42: []}
    assert wire.decode_query_overlap(data)[0] == 6


def test_skips_inv_overlap_indices_written_by_protobuf(tmp_path):
    entries = CASES["several positives"]
    (tmp_path / "inv.pb").write_bytes(_message(entries, 3, inverse=True).SerializeToString())
    got = load_overlap_pb(str(tmp_path / "inv.pb"))
    assert _as_tuples(got) == _as_tuples(joverlap.load_overlap_pb(str(tmp_path / "inv.pb"))) == _as_tuples(entries)


def test_varints_past_32_bits_keep_their_low_32(tmp_path):
    """A uint32 field read from a varint of up to 10 bytes keeps its low 32
    bits, as protobuf does (5 bytes is the longest a uint32 writer makes)."""
    big = [2**32 + 7, 2**40 + 2**31, 2**64 - 1, TOP]
    pair = (_field(1, 0, wire._varint(2**35 + 9)) + _len(2, b"".join(wire._varint(v) for v in big))
            + b"".join(_field(3, 0, wire._varint(v)) for v in big))
    data = _field(1, 0, wire._varint(2**33 + 1)) + _len(2, _field(2, 0, wire._varint(2**36 + 4)) + _len(3, pair))
    (tmp_path / "big.pb").write_bytes(data)
    got = load_overlap_pb(str(tmp_path / "big.pb"))
    assert _as_tuples(got) == _as_tuples(joverlap.load_overlap_pb(str(tmp_path / "big.pb")))
    low = [v & TOP for v in big]
    assert _as_tuples(got) == {4: [(9, low, low, [])]}
    assert wire.decode_query_overlap(data)[0] == 1


@pytest.mark.parametrize("bad", [
    ("idx1", {0: [OverlapEntry(0, [], [], [])]}, 0, lambda e: setattr(e[0][0], "idx1", 2**32)),
    ("near", {0: [OverlapEntry(1, [-1], [], [])]}, 0, None),
    ("far", {0: [OverlapEntry(1, [], [2**32], [])]}, 0, None),
    ("positive", {-3: []}, 0, None),
    ("query", {}, 2**32, None),
], ids=lambda b: b[0])
def test_values_outside_uint32_raise_and_write_nothing(tmp_path, bad):
    """Protobuf refuses them (``ValueError``): so does the port, before the
    file is opened."""
    _, entries, query_idx, tweak = bad
    if tweak:
        tweak(entries)
    path = tmp_path / "out.pb"
    with pytest.raises(ValueError, match="uint32"):
        save_overlap_pb(str(path), entries, query_idx=query_idx)
    assert not path.exists()
    with pytest.raises(ValueError):
        _message(entries, query_idx)


@pytest.mark.parametrize("data", [b"\x12\x05\x10", b"\x12\x03\x1a\x01\x12", b"\x08\x80",
                                  b"\x12\x03\x1a\x03\x12\x01\x80", b"\x0b\x08\x01", b"\x00\x01", b"\x0f"],
                         ids=["truncated message", "truncated list", "truncated varint", "truncated packed varint",
                              "unterminated group", "field number 0", "wire type 7"])
def test_malformed_input_raises(data):
    with pytest.raises(ValueError):
        wire.decode_query_overlap(data)


def test_synthetic_entries_round_trip(tmp_path):
    """Entries of ``synthetic_overlaps`` over several positives, written and
    read back by the port, and read by the JAX package."""
    rng = np.random.RandomState(4)
    q = rng.rand(300, 3).astype(np.float32)
    per = {p: poverlap.synthetic_overlaps(q, q + rng.randn(300, 3).astype(np.float32) * 0.02, n_entries=40,
                                          rng=np.random.RandomState(p))
           for p in (11, 2, 30)}
    save_overlap_pb(str(tmp_path / "s.pb"), per, query_idx=1)
    assert _as_tuples(load_overlap_pb(str(tmp_path / "s.pb"))) == _as_tuples(per)
    assert _as_tuples(joverlap.load_overlap_pb(str(tmp_path / "s.pb"))) == _as_tuples(per)
    assert sum(len(e) for e in per.values()) > 60
