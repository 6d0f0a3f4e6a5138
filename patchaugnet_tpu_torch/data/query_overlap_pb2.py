"""Wire format of the reference's per-query overlap records.

A copy of the serialized ``query_overlap.proto`` that protoc compiled
into ``patchaugnet_tpu/data/query_overlap_pb2.py`` (package
``p2m.base_type``: ``Uint32Pair``, ``QueryPosOverlapIndices``,
``QueryOverlapIndices`` and the dataset messages). The port reads and
writes the overlap records with :mod:`.wire`, without protobuf; the
message classes serve the tests that hold that codec against protobuf.
They are built on the first call of :func:`messages`, which imports the
protobuf runtime then: importing this module needs no protobuf.
"""
from __future__ import annotations

import functools
from typing import Dict

SERIALIZED_FILE = (
    b'\n\x13query_overlap.proto\x12\rp2m.base_type\"0\n\nDataRecord\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\t\n\x01x\x18\x02 \x01(\x01\x12\t\n\x01y\x18\x03 \x01(\x01\"9\n\x0b\x44\x61taRecords\x12*\n\x07records\x18\x01 \x03(\x0b\x32\x19.p2m.base_type.DataRecord\"a\n\nUint32Pair\x12\x0c\n\x04idx1\x18\x01 \x01(\r\x12\x15\n\rnear_indices2\x18\x02 \x03(\r\x12\x14\n\x0c\x66\x61r_indices2\x18\x03 \x03(\r\x12\x18\n\x10\x62\x61\x64_far_indices2\x18\x04 \x03(\r\"\x9a\x01\n\x16QueryPosOverlapIndices\x12\x14\n\x0cpositive_idx\x18\x02 \x01(\r\x12\x32\n\x0foverlap_indices\x18\x03 \x03(\x0b\x32\x19.p2m.base_type.Uint32Pair\x12\x36\n\x13inv_overlap_indices\x18\x04 \x03(\x0b\x32\x19.p2m.base_type.Uint32Pair\"k\n\x13QueryOverlapIndices\x12\x11\n\tquery_idx\x18\x01 \x01(\r\x12\x41\n\x12qp_overlap_indices\x18\x02 \x03(\x0b\x32%.p2m.base_type.QueryPosOverlapIndices\"F\n\x10QueryPosNegTuple\x12\x18\n\x10positive_indices\x18\x01 \x03(\r\x12\x18\n\x10negative_indices\x18\x02 \x03(\r\"\xe8\x01\n\x07\x44\x61taSet\x12\x12\n\ntrip_names\x18\x01 \x03(\t\x12*\n\x07records\x18\x02 \x03(\x0b\x32\x19.p2m.base_type.DataRecord\x12\x19\n\x11records_size_list\x18\x03 \x03(\r\x12\x32\n\x06tuples\x18\x04 \x03(\x0b\x32\".p2m.base_type.DataSet.TuplesEntry\x1aN\n\x0bTuplesEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12.\n\x05value\x18\x02 \x01(\x0b\x32\x1f.p2m.base_type.QueryPosNegTuple:\x02\x38\x01\x62\x06proto3'
)


@functools.lru_cache(maxsize=None)
def messages() -> Dict[str, type]:
    """The top-level message classes by name, in a descriptor pool of their
    own (so that the JAX package's generated module can share the process)."""
    try:
        from google.protobuf import descriptor_pool, message_factory
    except ImportError:
        raise ImportError("reading or writing .pb overlap records needs the protobuf runtime "
                          "(the 'protobuf' package), which is not installed") from None
    pool = descriptor_pool.DescriptorPool()
    file_desc = pool.AddSerializedFile(SERIALIZED_FILE)
    return {name: message_factory.GetMessageClass(desc)
            for name, desc in file_desc.message_types_by_name.items()}
