"""The HDF5 files of MVSEC's per-frame event tables, read and written with
numpy alone (the card's machine has no ``h5py``).

The layout is the one the JAX encoder writes through h5py's defaults
(``eemflow_tpu/events/io.py:47-54``): a group ``myDataset`` holding the
one-dimensional float64 datasets ``ts``, ``x``, ``y`` and ``p``.  This
module covers only what h5py writes by default for it: superblock version
0 with 8-byte offsets and lengths, groups as symbol tables (a version-1
B-tree of symbol nodes and a local heap), object headers of version 1, and
contiguous little-endian IEEE float64 datasets without filters.  Anything
else (a later superblock, compact or chunked storage, filters, another
type, link messages instead of a symbol table) raises ``ValueError``
naming the file.  The writer lays a file out as h5py does for that
layout, so h5py and the reader here read it.

Format reference: the HDF5 File Format Specification, version 2.0
(superblock §II.A, B-trees §III.A.1, symbol nodes §III.B, local heaps
§III.D, object headers §IV.A, messages §IV.A.2).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
# group B-tree K values (h5py's defaults): a symbol node holds 2·LEAF_K
# entries, a B-tree node 2·NODE_K children
LEAF_K = 4
NODE_K = 16
# object header message types
MSG_DATASPACE, MSG_DATATYPE, MSG_FILL, MSG_LAYOUT = 0x1, 0x3, 0x5, 0x8
MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xB, 0x10, 0x11
# the datatype message body of a little-endian IEEE float64 (class 1,
# version 1; sign at bit 63, exponent 52+11 with bias 1023, mantissa 0+52)
F64_LE = bytes([0x11, 0x20, 0x3F, 0x00]) + struct.pack("<I", 8) + struct.pack("<HHBBBBI", 0, 64, 52, 11, 0, 52, 1023)


class _Reader:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = f.read()

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what} (this reader takes only h5py's default layout of "
                         "contiguous float64 datasets in symbol-table groups)")

    def u(self, off: int, n: int) -> int:
        if off + n > len(self.buf):
            self.fail(f"a read at byte {off} runs past the end of the file")
        return int.from_bytes(self.buf[off: off + n], "little")

    def root(self) -> int:
        if self.buf[:8] != SIGNATURE:
            self.fail("no HDF5 signature")
        if self.buf[8] != 0:
            self.fail(f"superblock version {self.buf[8]}")
        if self.buf[13] != 8 or self.buf[14] != 8:
            self.fail("offsets or lengths that are not 8 bytes")
        if self.u(24, 8) != 0:
            self.fail("a base address other than 0")
        return self.u(64, 8)  # the root symbol table entry's object header

    def messages(self, addr: int) -> List[Tuple[int, int, int]]:
        """(type, body offset, body size) of each message of the version-1
        object header at ``addr``, continuation blocks followed."""
        if self.u(addr, 1) != 1:
            self.fail(f"object header version {self.u(addr, 1)} at byte {addr}")
        n_msgs = self.u(addr + 2, 2)
        blocks = [(addr + 16, self.u(addr + 8, 4))]
        out = []
        while blocks and len(out) < n_msgs:
            off, size = blocks.pop(0)
            end = off + size
            while off + 8 <= end and len(out) < n_msgs:
                mtype, msize = self.u(off, 2), self.u(off + 2, 2)
                body = off + 8
                if mtype == MSG_CONTINUATION:
                    blocks.append((self.u(body, 8), self.u(body + 8, 8)))
                out.append((mtype, body, msize))
                off = body + msize
        return out

    def group(self, addr: int) -> Dict[str, int]:
        """Name → object header address of each member of the group whose
        object header is at ``addr``."""
        tables = [(b, s) for t, b, s in self.messages(addr) if t == MSG_SYMBOL_TABLE]
        if not tables:
            self.fail(f"the object at byte {addr} is not a symbol-table group")
        btree, heap = self.u(tables[0][0], 8), self.u(tables[0][0] + 8, 8)
        if self.buf[heap: heap + 4] != b"HEAP":
            self.fail(f"no local heap at byte {heap}")
        names_at = self.u(heap + 24, 8)
        members = {}
        for node in self._leaves(btree):
            if self.buf[node: node + 4] != b"SNOD":
                self.fail(f"no symbol node at byte {node}")
            for i in range(self.u(node + 6, 2)):
                entry = node + 8 + 40 * i
                start = names_at + self.u(entry, 8)
                name = self.buf[start: self.buf.index(b"\0", start)].decode()
                members[name] = self.u(entry + 8, 8)
        return members

    def _leaves(self, node: int) -> List[int]:
        if self.buf[node: node + 4] != b"TREE" or self.buf[node + 4] != 0:
            self.fail(f"no group B-tree node at byte {node}")
        level, used = self.buf[node + 5], self.u(node + 6, 2)
        # keys and children interleave after the 24-byte header: key0,
        # child0, key1, child1, ..., key_used
        children = [self.u(node + 24 + 8 + 16 * i, 8) for i in range(used)]
        if level == 0:
            return children
        return [leaf for c in children for leaf in self._leaves(c)]

    def dataset(self, addr: int) -> np.ndarray:
        msgs = {t: (b, s) for t, b, s in self.messages(addr)}
        if MSG_FILTERS in msgs:
            self.fail("a filter pipeline")
        if MSG_DATASPACE not in msgs or MSG_DATATYPE not in msgs or MSG_LAYOUT not in msgs:
            self.fail(f"the object at byte {addr} is not a dataset")
        b, _ = msgs[MSG_DATASPACE]
        version, rank = self.buf[b], self.buf[b + 1]
        dims_at = b + (8 if version == 1 else 4)
        if version not in (1, 2):
            self.fail(f"dataspace message version {version}")
        shape = tuple(self.u(dims_at + 8 * i, 8) for i in range(rank))
        b, _ = msgs[MSG_DATATYPE]
        if self.buf[b: b + len(F64_LE)] != F64_LE:
            self.fail("a datatype other than little-endian IEEE float64")
        b, _ = msgs[MSG_LAYOUT]
        if self.buf[b] != 3 or self.buf[b + 1] != 1:
            self.fail(f"layout message version {self.buf[b]} class {self.buf[b + 1]} (not contiguous, version 3)")
        data_at, size = self.u(b + 2, 8), self.u(b + 10, 8)
        n = int(np.prod(shape, dtype=np.int64))
        if n == 0:
            return np.zeros(shape, np.float64)
        if data_at == UNDEF or size != 8 * n or data_at + size > len(self.buf):
            self.fail(f"contiguous storage of {size} bytes at {data_at} for shape {shape}")
        return np.frombuffer(self.buf, "<f8", n, data_at).reshape(shape).copy()


def read_datasets(path: str, group: str = "myDataset") -> Dict[str, np.ndarray]:
    """Every float64 dataset of ``group`` (or of the root group when the file
    has no such group) in the file at ``path``, by name."""
    r = _Reader(path)
    members = r.group(r.root())
    if group in members:
        members = r.group(members[group])
    return {name: r.dataset(addr) for name, addr in members.items()}


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, body: bytes) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _object_header(messages: List[bytes]) -> bytes:
    size = sum(len(m) for m in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, size) + b"".join(messages)


BTREE_SIZE = 24 + 8 * (2 * NODE_K + 1) + 8 * (2 * NODE_K)
SNOD_SIZE = 8 + 40 * 2 * LEAF_K
GROUP_HEADER_SIZE = 16 + 8 + 16
DATASET_HEADER_SIZE = 16 + (8 + 24) + (8 + 24) + (8 + 8) + (8 + 24)


def _heap_data(names: List[str]) -> Tuple[bytes, Dict[str, int]]:
    data, offsets = b"\0" * 8, {}
    for name in names:
        offsets[name] = len(data)
        data += _pad8(name.encode() + b"\0")
    return data, offsets


def _group_blocks(at: int, members: Dict[str, Tuple[int, Tuple[int, int] | None]]) -> Tuple[List, int]:
    """The blocks of a symbol-table group laid out from byte ``at``: its
    B-tree (one leaf), local heap and symbol node.  ``members`` maps each
    name to (object header address, (B-tree, heap) of a member group or
    None).  Returns ([(address, bytes), ...], the end)."""
    if len(members) > 2 * LEAF_K:
        raise ValueError(f"write_datasets: at most {2 * LEAF_K} members a group")
    names = sorted(members)
    data, offsets = _heap_data(names)
    btree, heap = at, at + BTREE_SIZE
    snod = heap + 32 + len(data)
    entries = b""
    for name in names:
        addr, scratch = members[name]
        cache = 0 if scratch is None else 1
        entries += struct.pack("<QQI4x", offsets[name], addr, cache) + struct.pack("<QQ", *(scratch or (0, 0)))
    # key 0 is the empty name, key 1 the leaf's last name
    node = b"TREE" + struct.pack("<BBHQQQQQ", 0, 0, 1, UNDEF, UNDEF, 0, snod, offsets[names[-1]])
    blocks = [
        (btree, node.ljust(BTREE_SIZE, b"\0")),
        # an empty free list: its head is H5HL_FREE_NULL (1)
        (heap, b"HEAP" + bytes(4) + struct.pack("<QQQ", len(data), 1, heap + 32) + data),
        (snod, (b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + entries).ljust(SNOD_SIZE, b"\0")),
    ]
    return blocks, snod + SNOD_SIZE


def _group_header(btree_heap: Tuple[int, int]) -> bytes:
    return _object_header([_message(MSG_SYMBOL_TABLE, struct.pack("<QQ", *btree_heap))])


def _dataset_header(n: int, data_at: int) -> bytes:
    space = struct.pack("<BBBx4xQQ", 1, 1, 1, n, n)  # version 1, rank 1, max dims given
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)  # version 2: late allocation, no fill value
    layout = struct.pack("<BBQQ", 3, 1, data_at, 8 * n)  # version 3, contiguous
    return _object_header([_message(MSG_DATASPACE, space), _message(MSG_DATATYPE, F64_LE),
                           _message(MSG_FILL, fill), _message(MSG_LAYOUT, layout)])


def write_datasets(path: str, datasets: Dict[str, np.ndarray], group: str = "myDataset") -> None:
    """Write one-dimensional ``datasets`` as float64 under ``group`` in a new
    file at ``path``, laid out as h5py lays out ``create_group`` and
    ``create_dataset(name, data=...)`` with its defaults: superblock, root
    group, the group, the datasets' headers, then their data."""
    arrays = {}
    for name, a in datasets.items():
        arrays[name] = np.ascontiguousarray(a, dtype="<f8")
        if arrays[name].ndim != 1:
            raise ValueError(f"write_datasets: {name} must be one-dimensional")
    root_header = 96
    root_at = root_header + GROUP_HEADER_SIZE
    root_end = root_at + BTREE_SIZE + 32 + len(_heap_data([group])[0]) + SNOD_SIZE
    group_header = root_end
    group_at = group_header + GROUP_HEADER_SIZE
    group_btree_heap = (group_at, group_at + BTREE_SIZE)
    root_blocks, end = _group_blocks(root_at, {group: (group_header, group_btree_heap)})
    assert end == root_end
    names = sorted(arrays)
    group_end = group_at + BTREE_SIZE + 32 + len(_heap_data(names)[0]) + SNOD_SIZE
    headers = {name: group_end + i * DATASET_HEADER_SIZE for i, name in enumerate(names)}
    group_blocks, end = _group_blocks(group_at, {name: (headers[name], None) for name in names})
    assert end == group_end
    blocks = root_blocks + group_blocks
    blocks += [(root_header, _group_header((root_at, root_at + BTREE_SIZE))),
               (group_header, _group_header(group_btree_heap))]
    data_at = group_end + len(names) * DATASET_HEADER_SIZE
    for name in names:
        a = arrays[name]
        blocks.append((headers[name], _dataset_header(len(a), data_at if len(a) else UNDEF)))
        blocks.append((data_at, a.tobytes()))
        data_at += a.nbytes
    eof = data_at
    superblock = SIGNATURE + struct.pack(
        "<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, NODE_K, 0
    ) + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
    # the root's symbol table entry: name offset 0, its header, cached (B-tree, heap)
    superblock += struct.pack("<QQI4xQQ", 0, root_header, 1, root_at, root_at + BTREE_SIZE)
    out = bytearray(eof)
    for addr, data in [(0, superblock)] + blocks:
        out[addr: addr + len(data)] = data
    with open(path, "wb") as f:
        f.write(bytes(out))
